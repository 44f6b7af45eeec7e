"""UART wire-frame codec for the hub -> companion link.

Two frame types share one byte stream (tof_esp32.ino:192-216, 131-138;
parsed byte-wise with resync at uav_local_nav.c:1386-1427):

  SCAN  518 B:  0xA5 | u32le t_ms | 4*64 u16le mm (F,R,B,L) | xor8
  CTRL    7 B:  0xA6 | u8 cmd (0=DISARM,1=ARM) | u32le seq | xor8

Dead-sensor cells are 0xFFFF (tof_esp32.ino:204).  The checksum is xor over
all preceding bytes.  `decode_stream` reproduces the reference's exact
byte-wise resync semantics (interleaved CTRL parser wins a byte when it is
mid-frame; SCAN parser skips non-0xA5 bytes when idle), so replaying a raw
UART capture yields the same accepted frames as the C parser.

The port's copy of micro_quad_slam_tpu/formats/scanframe.py (the port imports
nothing of the JAX package); tests/test_torch_formats.py
holds what it writes and parses equal to the original's.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple, Union

import numpy as np

SCAN_HEADER = 0xA5
CTRL_HEADER = 0xA6
NUM_SENSORS = 4
GRID_CELLS = 64
SCAN_BYTES = 1 + 4 + NUM_SENSORS * GRID_CELLS * 2 + 1  # 518
CTRL_BYTES = 7

CMD_DISARM = 0
CMD_ARM = 1


def xor8(buf: Union[bytes, np.ndarray]) -> int:
    """8-bit xor checksum (uav_local_nav.c:1303-1307)."""
    a = np.frombuffer(bytes(buf), dtype=np.uint8)
    return int(np.bitwise_xor.reduce(a)) if a.size else 0


def encode_scan_frame(t_ms: int, grid_mm: np.ndarray) -> bytes:
    """Serialize one 518-byte SCAN frame (tof_esp32.ino:192-214).

    grid_mm: u16 [4, 8, 8] in physical order FRONT, RIGHT, BACK, LEFT,
    already orientation-normalized (the hub mirrors columns before packing,
    tof_esp32.ino:98-101).
    """
    grid = np.ascontiguousarray(grid_mm, dtype="<u2")
    if grid.size != NUM_SENSORS * GRID_CELLS:
        raise ValueError(f"grid must have {NUM_SENSORS * GRID_CELLS} cells")
    buf = bytearray(SCAN_BYTES)
    buf[0] = SCAN_HEADER
    buf[1:5] = int(t_ms & 0xFFFFFFFF).to_bytes(4, "little")
    buf[5:5 + 512] = grid.tobytes()
    buf[-1] = xor8(bytes(buf[:-1]))
    return bytes(buf)


def encode_ctrl_frame(cmd: int, seq: int) -> bytes:
    """Serialize one 7-byte CTRL frame (tof_esp32.ino:131-138)."""
    buf = bytearray(CTRL_BYTES)
    buf[0] = CTRL_HEADER
    buf[1] = cmd & 0xFF
    buf[2:6] = int(seq & 0xFFFFFFFF).to_bytes(4, "little")
    buf[6] = xor8(bytes(buf[:-1]))
    return bytes(buf)


class StreamParser:
    """Stateful byte-wise parser of a shared SCAN/CTRL UART stream.

    Reproduces pump_tof_uart (uav_local_nav.c:1386-1427): a 0xA6 byte seen
    while the SCAN parser is idle starts a CTRL frame which consumes the
    next 6 bytes; otherwise bytes feed the SCAN parser which resyncs on
    0xA5.  Frames failing the xor8 check are dropped silently, exactly
    like the reference.  Frames may be split across feed() calls, exactly
    like a real UART read loop."""

    def __init__(self):
        self._scan = bytearray()
        self._ctrl = bytearray()

    def feed(self, data) -> List[Tuple[str, dict]]:
        """Parse a chunk; returns completed ("scan"/"ctrl", fields)."""
        out: List[Tuple[str, dict]] = []
        scan_buf = self._scan
        ctrl_buf = self._ctrl
        for b in np.frombuffer(bytes(data), dtype=np.uint8):
            b = int(b)
            # CTRL parser has priority when mid-frame or on its header
            # byte while idle (uav_local_nav.c:1394-1410).
            if not ctrl_buf:
                if b == CTRL_HEADER:
                    ctrl_buf.append(b)
                    continue
            else:
                ctrl_buf.append(b)
                if len(ctrl_buf) == CTRL_BYTES:
                    if xor8(bytes(ctrl_buf[:-1])) == ctrl_buf[-1]:
                        out.append((
                            "ctrl",
                            {
                                "cmd": ctrl_buf[1],
                                "seq": int.from_bytes(ctrl_buf[2:6],
                                                      "little"),
                            },
                        ))
                    ctrl_buf.clear()
                continue

            # SCAN parser (uav_local_nav.c:1412-1425).
            if not scan_buf and b != SCAN_HEADER:
                continue
            scan_buf.append(b)
            if len(scan_buf) == SCAN_BYTES:
                if xor8(bytes(scan_buf[:-1])) == scan_buf[-1]:
                    grid = (
                        np.frombuffer(bytes(scan_buf[5:5 + 512]),
                                      dtype="<u2")
                        .reshape(NUM_SENSORS, 8, 8)
                        .copy()
                    )
                    out.append((
                        "scan",
                        {
                            "t_ms": int.from_bytes(scan_buf[1:5], "little"),
                            "grid_mm": grid,
                        },
                    ))
                scan_buf.clear()
        return out


def decode_stream(
    data: Union[bytes, bytearray, np.ndarray],
) -> Iterator[Tuple[str, dict]]:
    """One-shot wrapper over StreamParser (see its docstring).

    Yields ("scan", {"t_ms", "grid_mm"}) and ("ctrl", {"cmd", "seq"}).
    """
    yield from StreamParser().feed(data)


def decode_stream_arrays(data) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int]]]:
    """Convenience: decode a stream into (t_ms [T], grid_mm [T,4,8,8], ctrls)."""
    ts, grids, ctrls = [], [], []
    for kind, payload in decode_stream(data):
        if kind == "scan":
            ts.append(payload["t_ms"])
            grids.append(payload["grid_mm"])
        else:
            ctrls.append((payload["cmd"], payload["seq"]))
    t = np.asarray(ts, dtype=np.uint32)
    g = (
        np.stack(grids).astype(np.uint16)
        if grids
        else np.zeros((0, 4, 8, 8), np.uint16)
    )
    return t, g, ctrls


class CtrlDebouncer:
    """Clean-revision DISARM debounce at the CTRL intake
    (clean_uav_fc_tof_nav.c:1605-1654): a DISARM only takes effect after
    CTRL_DISARM_MIN_STREAK frames with identical-or-consecutive sequence
    numbers inside a CTRL_DISARM_CONFIRM_MS window — spurious 0xA6 headers
    inside the ToF byte stream forge plausible-looking CTRL frames, and
    this rejects them.  ARM frames pass through immediately.

    feed(cmd, seq, t_ms) -> True/False/None for ARM / confirmed DISARM /
    still pending.
    """

    def __init__(self, confirm_ms: int = 500, min_streak: int = 2):
        self.confirm_ms = confirm_ms
        self.min_streak = min_streak
        self._last_seq = 0
        self._streak = 0
        self._first_ms = 0

    def feed(self, cmd: int, seq: int, t_ms: int):
        if cmd == CMD_ARM:
            self._streak = 0
            self._first_ms = 0
            return True
        if cmd != CMD_DISARM:
            return None
        seq_ok = seq in (self._last_seq, (self._last_seq + 1) & 0xFFFFFFFF)
        new_window = (self._first_ms == 0
                      or (t_ms - self._first_ms) > self.confirm_ms
                      or (not seq_ok and self._streak > 0))
        if new_window:
            self._first_ms = t_ms
            self._streak = 1
            self._last_seq = seq
            return None
        self._streak += 1
        self._last_seq = seq
        if self._streak < self.min_streak:
            return None
        self._streak = 0
        self._first_ms = 0
        return False
