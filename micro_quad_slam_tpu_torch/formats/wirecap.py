"""Time-multiplexed dual-UART capture container ("wirecap").

The reference companion's live inputs are two serial streams polled in
one loop (uav_local_nav.c:2359-2371): the hub UART carrying SCAN/CTRL
frames and the FC UART carrying MAVLink telemetry.  A wirecap file
records both with arrival timestamps so the whole live topology can be
replayed offline (replay/livestream.py):

    header  b"WCAP1\\n"
    record  u8 channel (0 = hub UART, 1 = FC UART) | u32le t_ms |
            u16le len | payload bytes

Payload chunking is arbitrary for the hub channel (the SCAN/CTRL parser
is byte-wise, formats/scanframe.StreamParser); FC-channel chunks should
not split MAVLink frames (the reference reads whole messages per poll
too, and the telemetry decoder is per-chunk).

The port's copy of micro_quad_slam_tpu/formats/wirecap.py (the port imports
nothing of the JAX package); tests/test_torch_formats.py
holds what it writes and parses equal to the original's.
"""

from __future__ import annotations

import struct
from typing import Iterable, List, Tuple

WIRECAP_MAGIC = b"WCAP1\n"
CH_HUB = 0
CH_FC = 1

_REC_HDR = struct.Struct("<BIH")


def write_wirecap(path: str,
                  records: Iterable[Tuple[int, int, bytes]]) -> int:
    """Write (channel, t_ms, payload) records; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        f.write(WIRECAP_MAGIC)
        for ch, t_ms, payload in records:
            f.write(_REC_HDR.pack(ch & 0xFF, int(t_ms) & 0xFFFFFFFF,
                                  len(payload)))
            f.write(payload)
            n += 1
    return n


def read_wirecap(path: str) -> List[Tuple[int, int, bytes]]:
    """Read a wirecap file -> list of (channel, t_ms, payload)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(WIRECAP_MAGIC):
        raise ValueError(f"{path}: not a wirecap file (bad magic)")
    off = len(WIRECAP_MAGIC)
    out: List[Tuple[int, int, bytes]] = []
    while off < len(data):
        if off + _REC_HDR.size > len(data):
            break  # truncated tail record: drop, like a torn capture
        ch, t_ms, ln = _REC_HDR.unpack_from(data, off)
        off += _REC_HDR.size
        if off + ln > len(data):
            break
        out.append((ch, t_ms, data[off:off + ln]))
        off += ln
    return out
