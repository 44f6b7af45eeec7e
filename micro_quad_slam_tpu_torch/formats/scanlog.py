"""Reader of the reference's scanlog.bin, the replay input (numpy only).

The reference logs one packed 569-byte record per accepted ToF scan
(`scanrec_t`, uav_local_nav.c:1522-1547) after a one-time 7-byte file
header "SCLOG2\\n" (uav_local_nav.c:1505).  This is the reader half of
the JAX package's formats/scanlog.py, byte layout and all: it returns the
fields that the replay reads (replay/mapping.py::scanlog_to_arrays), with
the same dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Union

import numpy as np

SCANLOG_FILE_HEADER = b"SCLOG2\n"
SCANREC_MAGIC = 0x324E4353  # 'SCN2' little-endian (uav_local_nav.c:1555)
SCANREC_BYTES = 569

SCANREC_DTYPE = np.dtype([
    ("magic", "<u4"), ("host_ms", "<u4"), ("scan_ms", "<u4"),
    ("x_m", "<f4"), ("y_m", "<f4"), ("yaw_deg", "<f4"), ("alt_m", "<f4"),
    ("roll_rad", "<f4"), ("pitch_rad", "<f4"), ("rf_m", "<f4"),
    ("of_rate_x", "<f4"), ("of_rate_y", "<f4"),
    ("of_q", "u1"), ("state", "u1"), ("kf_flags", "u1"), ("_pad0", "<u2"),
    ("sys_health", "<u4"), ("grid_raw", "u1", (512,)),
])
assert SCANREC_DTYPE.itemsize == SCANREC_BYTES


@dataclasses.dataclass
class ScanLog:
    """The replay's fields of T records; `grid_mm` is the u16 ToF grid
    [T, 4, 8, 8] in sensor order F, R, B, L."""

    x_m: np.ndarray          # f32 [T]
    y_m: np.ndarray          # f32 [T]
    yaw_deg: np.ndarray      # f32 [T]
    of_rate_x: np.ndarray    # f32 [T]
    of_q: np.ndarray         # u8  [T]
    state: np.ndarray        # u8  [T]
    sys_health: np.ndarray   # u32 [T]
    grid_mm: np.ndarray      # u16 [T, 4, 8, 8]

    def __len__(self) -> int:
        return int(self.x_m.shape[0])


def read_scanlog(src: Union[str, bytes, BinaryIO],
                 strict: bool = True) -> ScanLog:
    """Read a scanlog.bin file, bytes or stream.  The header appears only
    at file start (uav_local_nav.c:1498-1508).  With strict=False a
    trailing partial record is dropped and records with a bad magic are
    skipped."""
    if isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    elif isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        data = src.read()
    if data[:len(SCANLOG_FILE_HEADER)] == SCANLOG_FILE_HEADER:
        data = data[len(SCANLOG_FILE_HEADER):]
    n_full = len(data) // SCANREC_BYTES
    if strict and len(data) % SCANREC_BYTES:
        raise ValueError(f"scanlog payload of {len(data)} bytes is not a "
                         f"multiple of {SCANREC_BYTES}-byte records")
    rec = np.frombuffer(data[:n_full * SCANREC_BYTES], dtype=SCANREC_DTYPE)
    bad = rec["magic"] != SCANREC_MAGIC
    if bad.any():
        if strict:
            raise ValueError(f"{int(bad.sum())}/{len(rec)} records have "
                             f"bad magic")
        rec = rec[~bad]
    field = lambda k: np.ascontiguousarray(rec[k])              # noqa: E731
    return ScanLog(
        x_m=field("x_m"), y_m=field("y_m"), yaw_deg=field("yaw_deg"),
        of_rate_x=field("of_rate_x"), of_q=field("of_q"),
        state=field("state"), sys_health=field("sys_health"),
        grid_mm=np.ascontiguousarray(
            rec["grid_raw"].view("<u2").reshape(-1, 4, 8, 8)))
