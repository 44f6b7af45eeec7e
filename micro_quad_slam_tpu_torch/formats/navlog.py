"""navlog.csv reader/writer — the 20 Hz CSV nav log (uav_local_nav.c:1482-1623).

Column set and formatting mirror the reference header
(uav_local_nav.c:1490-1493):

  t_ms,state,want_arm,armed,mode,yaw_deg,alt_m,alt_src,x_m,y_m,vx_mps,vy_mps,
  rf_m,of_q,of_rate_x,of_rate_y,tof_f,tof_r,tof_b,tof_l,batt_v,batt_cells

Missing values are literal "nan" (alt_src uses "?"), matching the reference's
fprintf fallbacks (uav_local_nav.c:1596-1622).

The port's copy of micro_quad_slam_tpu/formats/navlog.py (the port imports
nothing of the JAX package); tests/test_torch_formats.py
holds what it writes and parses equal to the original's.
"""

from __future__ import annotations

import io
from typing import BinaryIO, TextIO, Union

import numpy as np

NAVLOG_HEADER = (
    "t_ms,state,want_arm,armed,mode,yaw_deg,alt_m,alt_src,x_m,y_m,vx_mps,vy_mps,"
    "rf_m,of_q,of_rate_x,of_rate_y,"
    "tof_f,tof_r,tof_b,tof_l,batt_v,batt_cells"
)

STATE_NAMES = (
    "WAIT_LINK", "IDLE", "ARMING", "TAKEOFF", "LIFTOFF_ASSIST",
    "HOVER", "EXPLORE", "TURNING", "LANDING", "DISARMING",
)
ALT_SRC_NAMES = ("?", "LPOS", "RF", "GND")  # AltSrc enum (uav_local_nav.c:541-548)


def _fmt(v: float, prec: int) -> str:
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return "nan"
    return f"{v:.{prec}f}"


class NavlogWriter:
    """Streaming writer with the reference's once-only header behavior
    (header written only if the file is empty, uav_local_nav.c:1487-1494)."""

    def __init__(self, dst: Union[str, TextIO], append: bool = False):
        if isinstance(dst, str):
            self._own = True
            self._f = open(dst, "a" if append else "w")
        else:
            self._own = False
            self._f = dst
        at_start = True
        try:
            at_start = self._f.tell() == 0
        except (OSError, io.UnsupportedOperation):
            pass
        if at_start:
            self._f.write(NAVLOG_HEADER + "\n")

    def write_row(
        self,
        t_ms: int,
        state: int,
        want_arm: bool,
        armed: bool,
        mode: int,
        yaw_deg: float,
        alt_m: float,
        alt_src: int,
        x_m: float,
        y_m: float,
        vx_mps: float,
        vy_mps: float,
        rf_m: float,
        of_q: int,
        of_rate_x: float,
        of_rate_y: float,
        tof_f: float,
        tof_r: float,
        tof_b: float,
        tof_l: float,
        batt_v: float,
        batt_cells: int,
    ) -> None:
        cols = [
            str(int(t_ms)),
            STATE_NAMES[int(state)] if 0 <= int(state) < len(STATE_NAMES) else "?",
            "1" if want_arm else "0",
            "1" if armed else "0",
            str(int(mode)),
            _fmt(yaw_deg, 3),
            _fmt(alt_m, 3),
            ALT_SRC_NAMES[int(alt_src)] if 0 <= int(alt_src) < 4 else "?",
            _fmt(x_m, 3),
            _fmt(y_m, 3),
            _fmt(vx_mps, 3),
            _fmt(vy_mps, 3),
            _fmt(rf_m, 3),
            str(int(of_q)),
            _fmt(of_rate_x, 4),
            _fmt(of_rate_y, 4),
            _fmt(tof_f, 3),
            _fmt(tof_r, 3),
            _fmt(tof_b, 3),
            _fmt(tof_l, 3),
            _fmt(batt_v, 3),
            str(int(batt_cells)),
        ]
        self._f.write(",".join(cols) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_navlog(src: Union[str, TextIO, BinaryIO]) -> dict:
    """Parse navlog.csv into a dict of numpy columns.

    Tolerates the reference's append-mode artifacts (repeated headers after a
    process restart) and "nan"/"?" placeholders.
    """
    if isinstance(src, str):
        with open(src) as f:
            lines = f.read().splitlines()
    else:
        raw = src.read()
        if isinstance(raw, bytes):
            raw = raw.decode()
        lines = raw.splitlines()

    rows = [ln for ln in lines if ln and not ln.startswith("t_ms,")]
    n = len(rows)
    out = {
        "t_ms": np.zeros(n, np.uint64),
        "state": np.zeros(n, np.int32),
        "want_arm": np.zeros(n, np.int32),
        "armed": np.zeros(n, np.int32),
        "mode": np.zeros(n, np.uint32),
        "yaw_deg": np.full(n, np.nan, np.float32),
        "alt_m": np.full(n, np.nan, np.float32),
        "alt_src": np.zeros(n, np.int32),
        "x_m": np.full(n, np.nan, np.float32),
        "y_m": np.full(n, np.nan, np.float32),
        "vx_mps": np.full(n, np.nan, np.float32),
        "vy_mps": np.full(n, np.nan, np.float32),
        "rf_m": np.full(n, np.nan, np.float32),
        "of_q": np.zeros(n, np.int32),
        "of_rate_x": np.full(n, np.nan, np.float32),
        "of_rate_y": np.full(n, np.nan, np.float32),
        "tof_f": np.full(n, np.nan, np.float32),
        "tof_r": np.full(n, np.nan, np.float32),
        "tof_b": np.full(n, np.nan, np.float32),
        "tof_l": np.full(n, np.nan, np.float32),
        "batt_v": np.full(n, np.nan, np.float32),
        "batt_cells": np.zeros(n, np.int32),
    }
    fkeys = (
        "yaw_deg", "alt_m", "x_m", "y_m", "vx_mps", "vy_mps", "rf_m",
        "of_rate_x", "of_rate_y", "tof_f", "tof_r", "tof_b", "tof_l", "batt_v",
    )
    for i, ln in enumerate(rows):
        c = ln.split(",")
        if len(c) != 22:
            continue
        out["t_ms"][i] = int(c[0])
        out["state"][i] = STATE_NAMES.index(c[1]) if c[1] in STATE_NAMES else -1
        out["want_arm"][i] = int(c[2])
        out["armed"][i] = int(c[3])
        out["mode"][i] = int(c[4])
        vals = dict(
            zip(
                ("yaw_deg", "alt_m", "alt_src", "x_m", "y_m", "vx_mps", "vy_mps",
                 "rf_m", "of_q", "of_rate_x", "of_rate_y",
                 "tof_f", "tof_r", "tof_b", "tof_l", "batt_v", "batt_cells"),
                c[5:],
            )
        )
        for k in fkeys:
            try:
                out[k][i] = float(vals[k])
            except ValueError:
                pass
        out["alt_src"][i] = (
            ALT_SRC_NAMES.index(vals["alt_src"]) if vals["alt_src"] in ALT_SRC_NAMES else 0
        )
        out["of_q"][i] = int(vals["of_q"])
        out["batt_cells"][i] = int(vals["batt_cells"])
    return out
