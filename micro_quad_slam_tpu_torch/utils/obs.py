"""Observability: the reference's logging subsystems re-expressed for the
batched replay world (SURVEY.md §2E / §5.5).

  E1 navlog.csv        -> formats/navlog.py writer + replay glue here
  E2 scanlog.bin       -> formats/scanlog.py writer + sim glue here
  E3 keyframe flags    -> carried in replay/sim outputs
  E4 console status    -> format_status_line (the reference's 2 Hz
                          mega-line, uav_local_nav.c:1885-1975)
  E5 printf tee        -> TeeLogger (clean:451-475)
  E6 snapshot ring     -> SnapshotRing with dump-on-failure
                          (clean:288-323, 2186-2336)
  E7 flight_data.csv   -> FlightDataWriter (clean:141-146, 2645-2659)

Plus the port's tracer: stage spans and counters inside the replays.

  span(name, device)
                  a stage of a replay.  It records only while a torch
                  profiler is recording in the process; then it is a
                  record_function range (a user_annotation event on the
                  profiler's clock), synchronises its device at its exit
                  so that its end is the end of its device work, and is
                  kept in memory with its id, its parent's id, its root's
                  id and its start and end (time.perf_counter_ns).  A
                  span without a device takes its parent's; a CUDA device
                  is synchronised itself, anything else is the current
                  CUDA device (if CUDA is initialised).
                  Otherwise it is one flag check and a shared no-op.
  count(name, n)  a counter: a host integer is always counted; a device
                  tensor only while spans record, summed on the card and
                  read once when the root span exits.  n may be a callable
                  that returns the tensor: it is called only while spans
                  record, so an untraced run issues no operation for it.
  counters()      the counter table; take() returns the spans and the
                  counters and clears them.
  profile_trace   the operator's exporter: trace.json and spans.json
                  (each span name's calls, total and self seconds and
                  share of its root, the counters, the card).

The rest is the port's copy of micro_quad_slam_tpu/utils/obs.py (numpy
only); tests/test_torch_obs.py holds every function's output equal to the
original's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from collections import deque
from typing import NamedTuple, Optional, TextIO

import numpy as np
import torch
from torch.autograd import profiler as _profiler

STATE_NAMES_UL = (
    "WAIT_LINK", "IDLE", "ARMING", "TAKEOFF", "LIFTOFF_ASSIST",
    "HOVER", "EXPLORE", "TURNING", "LANDING", "DISARMING",
)
STATE_NAMES_CL = (
    "WAIT_LINK", "IDLE", "ARMING", "TAKEOFF", "LIFTOFF_ASSIST",
    "HOVER", "LANDING", "DISARMING",
)
ALT_SRC_NAMES = ("?", "LPOS", "RF", "GND")


def _f(v, fmt="%.2f", none="?"):
    try:
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return none
        return fmt % v
    except TypeError:
        return none


def format_status_line(
    state: int, want_arm: bool, have_hb: bool, mode: int, armed: bool,
    alt_m: float, alt_src: int, ceiling: bool, landed: Optional[int],
    z_ok, xy_ok, gyr_ok, mot_ok, xy_stable: bool, lpos_alt: float,
    rf_m: float, yaw_deg: float, yaw_target: Optional[float],
    tof_frbl, of_q: Optional[int], batt_v: float, batt_cells: int,
    mot_avg: Optional[float], map_inited: bool,
    names=STATE_NAMES_UL,
) -> str:
    """The reference's status mega-line (uav_local_nav.c:1885-1975)."""
    parts = [
        f"st={names[state] if 0 <= state < len(names) else '?'}",
        f"want={int(want_arm)} HB={int(have_hb)} mode={mode} armed={int(armed)}",
        f"alt={_f(alt_m)}({ALT_SRC_NAMES[alt_src] if 0 <= alt_src < 4 else '?'})",
        f"CEIL={int(ceiling)}",
        f"landed={'?' if landed is None else landed}",
        ("sys=?" if z_ok is None else
         f"sys=Z={int(z_ok)} XY={int(xy_ok)} GYR={int(gyr_ok)} MOT={int(mot_ok)}"),
        f"xyOK={int(xy_stable)}",
        f"lpos={_f(lpos_alt)}",
        f"rf={_f(rf_m)}",
        f"yaw={_f(yaw_deg, '%.1f')}" + (
            f"->{yaw_target:.1f}" if yaw_target is not None else ""),
        "tof(F/R/B/L)=" + "/".join(_f(v, none="nan") for v in tof_frbl),
        f"of={'?' if of_q is None else 'q=%d' % of_q}",
    ]
    if batt_v is not None and not np.isnan(batt_v) and batt_cells:
        parts.append(f"V={batt_v:.2f} ({batt_cells}c) "
                     f"Vpc={batt_v / batt_cells:.2f}")
    if mot_avg is not None:
        parts.append(f"mot_avg={mot_avg:.1f}")
    parts.append("map=ON(500x500@0.10m)" if map_inited else "map=OFF")
    return " ".join(parts)


class TeeLogger:
    """printf tee: every line goes to the console AND a timestamped
    log.txt (clean_uav_fc_tof_nav.c:451-475)."""

    def __init__(self, path: str, console: Optional[TextIO] = None,
                 t0: Optional[float] = None):
        self._f = open(path, "a")
        self._console = console
        self._t0 = time.monotonic() if t0 is None else t0

    def log(self, msg: str) -> None:
        stamp = time.monotonic() - self._t0
        line = f"[{stamp:.3f}] {msg}"
        self._f.write(line + "\n")
        if self._console is not None:
            self._console.write(msg + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


@dataclasses.dataclass
class Snapshot:
    """One black-box record (snapshot_t, clean:291-317)."""

    t_ms: int = 0
    state: int = 0
    mode: int = 0
    armed: bool = False
    landed: int = 255
    roll: float = np.nan
    pitch: float = np.nan
    yaw: float = np.nan
    x: float = np.nan
    y: float = np.nan
    z: float = np.nan
    vx: float = np.nan
    vy: float = np.nan
    vz: float = np.nan
    alt_est: float = np.nan
    alt_src: int = 0
    rf_m: float = np.nan
    of_q: int = 0
    of_rx: float = np.nan
    of_ry: float = np.nan
    xy_ok: bool = False
    z_ok: bool = False
    gyr_ok: bool = False
    mot_ok: bool = False
    batt_v: float = np.nan
    batt_c: int = 0
    batt_vpc: float = np.nan
    mot: tuple = (0, 0, 0, 0)
    rc: tuple = (0, 0, 0, 0)
    rssi: int = 0

    def line(self, names=STATE_NAMES_CL) -> str:
        nm = names[self.state] if 0 <= self.state < len(names) else "?"
        return (f"[{self.t_ms}] {nm} m={self.mode} a={int(self.armed)} "
                f"alt={_f(self.alt_est)} xyz=({_f(self.x)},{_f(self.y)},"
                f"{_f(self.z)}) rf={_f(self.rf_m)} q={self.of_q} "
                f"vpc={_f(self.batt_vpc)} mot={self.mot}")


class SnapshotRing:
    """32-deep black box, dumped in full on failure transitions
    (clean:288-323, 2022-2028, 2350-2357)."""

    def __init__(self, depth: int = 32, sink=None):
        self._ring = deque(maxlen=depth)
        self._sink = sink or (lambda s: None)

    def add(self, snap: Snapshot) -> None:
        self._ring.append(snap)

    def dump(self, reason: str = "") -> list:
        out = list(self._ring)
        self._sink(f"--- snapshot ring dump ({reason}): "
                   f"{len(out)} records ---")
        for s in out:
            self._sink(s.line())
        return out


class FlightDataWriter:
    """flight_data.csv: per-tick vibration/clipping, motor PWM, ESC RPM
    (clean:141-146, 2645-2659)."""

    HEADER = ("t_ms,state,alt_m,roll_deg,pitch_deg,yaw_deg,"
              "m1,m2,m3,m4,vib_x,vib_y,vib_z,rpm1,rpm2,rpm3,rpm4")

    def __init__(self, path: str, flush_every: int = 50):
        self._f = open(path, "w")
        self._f.write(self.HEADER + "\n")
        self._n = 0
        self._flush_every = flush_every

    def write_row(self, t_ms, state_name, alt_m, roll_deg, pitch_deg,
                  yaw_deg, motors, vib, rpm) -> None:
        self._f.write(
            f"{int(t_ms)},{state_name},{alt_m:.2f},{roll_deg:.2f},"
            f"{pitch_deg:.2f},{yaw_deg:.2f},"
            + ",".join(str(int(m)) for m in motors) + ","
            + ",".join(f"{v:.2f}" for v in vib) + ","
            + ",".join(str(int(r)) for r in rpm) + "\n")
        self._n += 1
        if self._n % self._flush_every == 0:
            self._f.flush()

    def close(self) -> None:
        self._f.close()


class Span(NamedTuple):
    """One recorded span.  Ids count up from 1 in order of opening; a
    root span's parent is 0 and its root is itself.  start_ns and end_ns
    are time.perf_counter_ns() readings."""

    name: str
    id: int
    parent: int
    root: int
    start_ns: int
    end_ns: int


class _NoSpan:
    """The span while no profiler records: a shared no-op context."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    """A span while a profiler records (Tracer.span)."""

    __slots__ = ("_tr", "_name", "_device", "_id", "_parent", "_root",
                 "_start", "_rf")

    def __init__(self, tracer: "Tracer", name: str, device):
        self._tr, self._name, self._device = tracer, name, device

    def __enter__(self):
        tr = self._tr
        tr._last_id += 1
        self._id = tr._last_id
        if tr._open:
            up = tr._open[-1]
            self._parent, self._root = up._id, up._root
            if self._device is None:
                self._device = up._device
        else:
            self._parent, self._root = 0, self._id
        tr._open.append(self)
        self._rf = _profiler.record_function(self._name)
        self._rf.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self._tr
        try:
            if exc_type is None:
                if not self._parent:
                    tr._read_device()
                # the span ends when its device work has ended
                dev = self._device
                if dev is not None and torch.device(dev).type == "cuda":
                    torch.cuda.synchronize(dev)
                elif torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                tr.spans.append(Span(self._name, self._id, self._parent,
                                     self._root, self._start,
                                     time.perf_counter_ns()))
        finally:
            tr._open.pop()
            self._rf.__exit__(exc_type, exc, tb)
        return False


class Tracer:
    """The spans and counters of the replays in one process; the module's
    span, count, counters and take use one shared instance."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}
        self._device: dict = {}     # counters of device values, not read yet
        self._open: list = []       # the open spans, innermost last
        self._last_id = 0

    def span(self, name: str, device=None):
        """A context that records the stage `name` of work on `device`
        while a torch profiler records, and does nothing else otherwise
        (module docstring)."""
        if not _profiler._is_profiler_enabled:
            return _NO_SPAN
        return _OpenSpan(self, name, device)

    def count(self, name: str, n=1) -> None:
        """Add n to the counter `name`: a host integer always; a device
        tensor (summed over its elements) only while spans record, on the
        card until the root span exits or the table is read.  A callable
        n is called for the tensor only while spans record."""
        if callable(n):
            if not _profiler._is_profiler_enabled:
                return
            n = n()
        if not isinstance(n, torch.Tensor):
            self.counts[name] = self.counts.get(name, 0) + int(n)
        elif _profiler._is_profiler_enabled:
            prev = self._device.get(name)
            n = n.sum()
            self._device[name] = n if prev is None else prev + n

    def _read_device(self) -> None:
        """The device counters into the table, in one copy."""
        if not self._device:
            return
        dev = next(iter(self._device.values())).device
        vals = torch.stack([v.to(dev, torch.int64)
                            for v in self._device.values()]).tolist()
        for name, v in zip(self._device, vals):
            self.counts[name] = self.counts.get(name, 0) + v
        self._device.clear()

    def counters(self) -> dict:
        """A copy of the counter table."""
        self._read_device()
        return dict(self.counts)

    def take(self) -> tuple:
        """(spans in order of opening, counters); both are cleared."""
        self._read_device()
        spans = sorted(self.spans, key=lambda s: s.id)
        counts = self.counts
        self.spans, self.counts = [], {}
        return spans, counts


_TRACER = Tracer()
span = _TRACER.span
count = _TRACER.count
counters = _TRACER.counters
take = _TRACER.take


def span_table(spans) -> dict:
    """Per span name, in order of first opening: calls, total seconds,
    self seconds (less the time of the spans it opened) and the share of
    its roots' seconds in percent (None without its roots)."""
    dur = {s.id: s.end_ns - s.start_ns for s in spans}
    inner = {}
    for s in spans:
        if s.parent:
            inner[s.parent] = inner.get(s.parent, 0) + dur[s.id]
    acc = {}
    for s in sorted(spans, key=lambda s: s.id):
        a = acc.setdefault(s.name, [0, 0, 0, set()])
        a[0] += 1
        a[1] += dur[s.id]
        a[2] += dur[s.id] - inner.get(s.id, 0)
        a[3].add(s.root)
    out = {}
    for name, (calls, total, own, roots) in acc.items():
        root_ns = sum(dur.get(r, 0) for r in roots)
        out[name] = {"calls": calls, "total_s": total * 1e-9,
                     "self_s": own * 1e-9,
                     "share_pct": 100.0 * total / root_ns if root_ns else None}
    return out


def summary_line(summary: dict) -> str:
    """profile_trace's summary as one line: each root span's calls and
    seconds with its stages' shares, then the counters."""
    table = summary.get("spans", {})
    parts = []
    for name, r in table.items():
        if "." not in name:
            stages = ", ".join(
                f"{k} {v['share_pct']:.1f}%" for k, v in table.items()
                if k.startswith(name + ".") and v["share_pct"] is not None)
            parts.append(f"{name} {r['calls']}x {r['total_s']:.4f} s"
                         + (f" ({stages})" if stages else ""))
    counts = " ".join(f"{k}={v}" for k, v in summary.get("counters",
                                                          {}).items())
    return (f"trace {summary.get('logdir')} on {summary.get('card')}: "
            + ("; ".join(parts) or "no spans")
            + (f"; counters {counts}" if counts else ""))


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler trace context (no-op when logdir is None): the host
    and, where a CUDA device is present, the device activity of the block,
    with the spans recorded in it.  The store is cleared on entry; on
    exit logdir/trace.json holds the Chrome trace and logdir/spans.json
    the summary: per span name its calls, total and self seconds and
    share of its root (span_table), the counters and the card.  Yields
    that summary as a dict, filled on exit."""
    summary: dict = {}
    if logdir is None:
        yield summary
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    take()
    with profile(activities=activities) as prof:
        yield summary
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    summary.update(
        logdir=logdir,
        card=(torch.cuda.get_device_name() if torch.cuda.is_initialized()
              else "cpu"),
        spans=span_table(_TRACER.spans), counters=counters())
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(summary, f, indent=1)


def map_divergence(grid_a, grid_b, occ_thresh: int = 10,
                   free_thresh: int = -10) -> dict:
    """Quantify how two log-odds maps of the same flight differ — used to
    put a measured fidelity cost on the cone production path vs the
    bit-exact reference-semantics path (ops/conemode.py is bit-exact vs
    the XLA cone mode, NOT vs the reference's 32-ray update).

    Returns occupied/free-cell IoU (same >10 / <-10 classification the
    reference's frontier scorer uses, uav_local_nav.c:366-381), the
    signed per-cell difference histogram over cells either map touched,
    and summary stats."""
    import numpy as np

    a = np.asarray(grid_a, np.int32)
    b = np.asarray(grid_b, np.int32)
    occ_a, occ_b = a > occ_thresh, b > occ_thresh
    free_a, free_b = a < free_thresh, b < free_thresh

    def iou(x, y):
        union = (x | y).sum()
        return float((x & y).sum() / union) if union else 1.0

    def dilate(x):
        out = x.copy()
        out[1:] |= x[:-1]
        out[:-1] |= x[1:]
        out[:, 1:] |= x[:, :-1]
        out[:, :-1] |= x[:, 1:]
        return out

    def iou_tol(x, y):
        """Tolerant IoU: a cell counts as agreeing if the other map has
        the class within 1 cell (walls are 1 cell thick, so pure
        quantization offsets shouldn't read as total disagreement)."""
        union = (x | y).sum()
        if not union:
            return 1.0
        hits = (x & dilate(y)).sum() + (y & dilate(x)).sum()
        return float(min(hits / 2 / union, 1.0))

    touched = (a != 0) | (b != 0)
    diff = (a - b)[touched]
    hist_vals, hist_counts = np.unique(diff, return_counts=True)
    return {
        "iou_occupied": iou(occ_a, occ_b),
        "iou_occupied_tol1": iou_tol(occ_a, occ_b),
        "iou_free": iou(free_a, free_b),
        "touched_cells": int(touched.sum()),
        "equal_cells_frac": float((diff == 0).mean()) if diff.size else 1.0,
        "diff_hist": {int(v): int(c) for v, c in
                      zip(hist_vals, hist_counts)},
        "mean_abs_diff": float(np.abs(diff).mean()) if diff.size else 0.0,
    }


def map_iou_vs_walls(grid, origin_x: float, origin_y: float, room,
                     obstacles=(), res_m: float = 0.10,
                     occ_thresh: int = 10, tol_cells: int = 1) -> float:
    """Map-fidelity score against the simulator's ground-truth walls:
    IoU between the map's occupied cells (> occ_thresh, the reference's
    frontier classification) and the true wall cells of the synthetic
    room/obstacle rectangles, with a tol_cells dilation on each side so
    pure half-cell quantization offsets don't read as disagreement.

    grid: logical [H, W] int8 ([y, x]); origin at the grid center
    (uav_local_nav.c:205-214)."""
    import numpy as np

    g = np.asarray(grid)
    h, w = g.shape
    xs = origin_x + (np.arange(w) - w // 2) * res_m
    ys = origin_y + (np.arange(h) - h // 2) * res_m
    X, Y = np.meshgrid(xs, ys)

    def seg_dist(px, py, ax, ay, bx, by):
        abx, aby = bx - ax, by - ay
        ln2 = abx * abx + aby * aby
        t = np.clip(((px - ax) * abx + (py - ay) * aby)
                    / (ln2 if ln2 else 1.0), 0.0, 1.0)
        return np.hypot(px - (ax + t * abx), py - (ay + t * aby))

    def rect_segs(x0, y0, x1, y1):
        return [(x0, y0, x1, y0), (x1, y0, x1, y1),
                (x1, y1, x0, y1), (x0, y1, x0, y0)]

    segs = rect_segs(*room)
    for ob in obstacles:
        segs += rect_segs(*ob)
    dmin = np.full_like(X, np.inf)
    for sgm in segs:
        dmin = np.minimum(dmin, seg_dist(X, Y, *sgm))
    truth = dmin <= res_m * 0.5 + 1e-6

    pred = g > occ_thresh

    def dilate(x, n):
        out = x.copy()
        for _ in range(n):
            nx = out.copy()
            nx[1:] |= out[:-1]
            nx[:-1] |= out[1:]
            nx[:, 1:] |= out[:, :-1]
            nx[:, :-1] |= out[:, 1:]
            out = nx
        return out

    union = (pred | truth).sum()
    if not union:
        return 1.0
    hits = ((pred & dilate(truth, tol_cells)).sum()
            + (truth & dilate(pred, tol_cells)).sum())
    return float(min(hits / 2 / union, 1.0))


def save_map_pgm(path: str, grid, occ_thresh: int = 10,
                 free_thresh: int = -10, trinary: bool = True) -> str:
    """Write a log-odds occupancy grid as a binary PGM (P5) image.

    The reference's deliverable is the post-flight 2D map rebuilt from
    scanlog.bin (uav_local_nav.c:94, "offline mapping"); this renders it
    in the de-facto occupancy-map image convention (ROS map_saver):
    occupied -> 0 (black), free -> 254 (white), unknown -> 205 (gray),
    using the reference frontier scorer's own cell classification
    thresholds (uav_local_nav.c:366-381).  trinary=False instead maps
    the raw clamped log-odds value linearly (127 - v) so cell evidence
    strength survives into the image.

    Rows are written north-up (grid row 0 at the bottom of the image)
    so +x is right and +y is up, matching the world frame.  Pure
    stdlib + numpy — no image dependencies.
    """
    g = np.asarray(grid)
    if g.ndim != 2:
        raise ValueError(f"expected a 2-D grid, got shape {g.shape}")
    v = g.astype(np.int16)
    if trinary:
        img = np.full(v.shape, 205, np.uint8)
        img[v > occ_thresh] = 0
        img[v < free_thresh] = 254
    else:
        img = np.clip(127 - v, 0, 255).astype(np.uint8)
    img = img[::-1]  # row 0 (south) at the bottom of the image
    with open(path, "wb") as f:
        f.write(b"P5\n# micro-quad-slam occupancy map\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())
    return path
