"""Mapping replay engine in PyTorch: scanlog stream -> occupancy grids
(counterpart of micro_quad_slam_tpu/replay/mapping.py).

Replay policy, identical to the JAX package and to golden_replay_mapping:

  * map init at the first record with finite (x, y) and an airborne state
    (HOVER..LANDING; the reference inits at hover XY lock,
    uav_local_nav.c:2187-2194); origin = that record's pose; the init
    frame itself is mapped.
  * per record: recenter-if-needed when (x, y) finite
    (uav_local_nav.c:1629-1631), then update iff pose_good_for_mapping
    (uav_local_nav.c:1633-1635, :935-947).
  * ToF EMA filter state advances every record (uav_local_nav.c:1430-1438).

Every function takes tensors with a leading flight dimension [B] and runs
on the device those tensors live on; the functions that make tensors
(frames_to_torch, mapping_init, mapping_state_from_numpy) put them on the
CUDA device unless the caller passes another.  KERNELS maps every kernel
name a replay takes to its mode (exact, cone or hybrid) and to its route:
frame by frame (mapping_step) or the whole replay (replay_whole).  A whole
replay runs the carry over T (`carry`: one launch of csrc/carry.cuh's
kernel on a CUDA device), the mode's schedule words (MODES:
ops/residentx.py for the exact mode, ops/conex.py for cone and hybrid)
and the mode's Hopper kernel, which takes the CPU path on CPU tensors.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.utils import obs
from micro_quad_slam_tpu_torch.utils.config import PipelineConfig, UL_PROFILE
from micro_quad_slam_tpu_torch.utils.device import as_device
from micro_quad_slam_tpu_torch.ops import _build, conemode
from micro_quad_slam_tpu_torch.ops import conex as cx
from micro_quad_slam_tpu_torch.ops import residentx as rx
from micro_quad_slam_tpu_torch.ops.beams import (
    extract_beams,
    tof_filter_update,
    tof_filter_weights,
)
from micro_quad_slam_tpu_torch.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    apply_rays_,
    make_rays,
    recenter_apply,
    recenter_constants,
    recenter_decide,
    shift_origin,
)

_F32 = np.float32

# MAV_SYS_STATUS sensor bits (MAVLink common enum values)
SENSOR_3D_GYRO = 0x01
SENSOR_Z_ALTITUDE_CONTROL = 0x2000
SENSOR_XY_POSITION_CONTROL = 0x4000
SENSOR_MOTOR_OUTPUTS = 0x400000

# Behavior states with the map active (uav_local_nav.c:484-496)
ST_HOVER, ST_LANDING = 5, 8

# Keyframe flag bit for recentering (uav_local_nav.c:225)
KF_MAP_RECENTER = 1 << 5


class Route(NamedTuple):
    """Where a kernel name sends a replay."""

    mode: str      # the grid update: "exact", "cone" or "hybrid"
    whole: bool    # the whole replay at once (replay_whole), else per frame


# Every kernel name a replay takes.  The exact update: "xla" per frame in
# plain torch, "pallas" and "pallas_db" (the JAX package's per-frame window
# kernels) per frame through the exact kernel's map-step entry, "residentx"
# whole; "resident", "mxu" and "mxu2" are the JAX package's other
# whole-replay formulations of the same update, bit-identical.  The dense
# production modes: "cone" and "hybrid" per frame in plain torch, "conex"
# (and "resident_cone", the JAX package's v1 cone kernel) and "hybridx"
# whole.
KERNELS = {
    "xla": Route("exact", False), "pallas": Route("exact", False),
    "pallas_db": Route("exact", False), "cone": Route("cone", False),
    "hybrid": Route("hybrid", False), "residentx": Route("exact", True),
    "resident": Route("exact", True), "mxu": Route("exact", True),
    "mxu2": Route("exact", True), "conex": Route("cone", True),
    "resident_cone": Route("cone", True), "hybridx": Route("hybrid", True),
}


class Mode(NamedTuple):
    """A whole-replay mode: the kernel library that exports its replay
    kernel and the carry kernel; its schedule words, (frames, beams, the
    carry's sequence, cfg, geom) -> sched int32 [B, T, words]; its kernel
    call, (grids, sched, cfg, geom=) -> grids, in place."""

    library: str
    words: Callable
    apply: Callable


MODES = {
    "exact": Mode("replay_exact", rx.sched_words, rx.replay_exact),
    "cone": Mode("replay_cone", partial(cx.sched_words, hybrid=False),
                 partial(cx.replay_cone, hybrid=False)),
    "hybrid": Mode("replay_cone", partial(cx.sched_words, hybrid=True),
                   partial(cx.replay_cone, hybrid=True)),
}


class MappingState(NamedTuple):
    """Per-quad mapper state; every field carries a leading batch dim [B]
    (B == () for the single-flight wrappers)."""

    grid: torch.Tensor       # int8 [B, prows, pcols] padded occupancy grid
    origin_x: torch.Tensor   # f32 [B] map origin (world NED at grid center)
    origin_y: torch.Tensor
    inited: torch.Tensor     # bool [B]
    filt: torch.Tensor       # f32 [B, 4] EMA'd per-direction ToF minima


def mapping_init(batch: int = 1, geom: GridGeom = DEFAULT_GEOM,
                 device=None) -> MappingState:
    device = as_device(device)
    nan = lambda *s: torch.full(s, float("nan"), dtype=torch.float32,  # noqa: E731
                                device=device)
    return MappingState(
        grid=torch.zeros((batch, geom.prows, geom.pcols), dtype=torch.int8,
                         device=device),
        origin_x=nan(batch),
        origin_y=nan(batch),
        inited=torch.zeros((batch,), dtype=torch.bool, device=device),
        filt=nan(batch, 4),
    )


def mapping_state_from_numpy(d, device=None) -> MappingState:
    """A mapper state held as numpy arrays -> the port's MappingState on
    `device`.  `d` is the JAX package's MappingState after
    `jax.tree.map(np.asarray, st)`, a utils/checkpoint restore, or any
    mapping with the same field names and layouts."""
    device = as_device(device)
    d = d._asdict() if hasattr(d, "_asdict") else dict(d)
    dtypes = {"grid": np.int8, "origin_x": np.float32, "origin_y": np.float32,
              "inited": np.bool_, "filt": np.float32}
    return MappingState(**{
        k: torch.from_numpy(np.array(d[k], dtype=dt)).to(device)
        for k, dt in dtypes.items()})


def mapping_state_to_numpy(state: MappingState) -> dict:
    """The port's MappingState -> dict of numpy arrays with the JAX
    package's field names and layouts (`MappingState(**d)` there)."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def _sys_bit_ok(sys_health, bit):
    """sys_health == 0 means 'no SYS_STATUS recorded' => healthy (the
    scanrec writer stores 0 then, uav_local_nav.c:1576; matches the
    reference's stale-SYS fallback, :904-907)."""
    return (sys_health == 0) | ((sys_health & bit) != 0)


def pose_good_for_mapping(x_m, yaw_deg, of_q, of_rate_x, sys_health,
                          of_min_quality: int):
    """Replay-time pose_good_for_mapping (uav_local_nav.c:935-947):
    lpos-fresh <=> x finite, have_att <=> yaw finite, XY/Z health from the
    recorded bits, flow-fresh <=> recorded rate finite."""
    ok = torch.isfinite(x_m) & torch.isfinite(yaw_deg)
    ok &= _sys_bit_ok(sys_health, SENSOR_XY_POSITION_CONTROL)
    ok &= _sys_bit_ok(sys_health, SENSOR_Z_ALTITUDE_CONTROL)
    of_fresh = torch.isfinite(of_rate_x)
    ok &= ~of_fresh | (of_q >= of_min_quality)
    return ok


def airborne_state(state, cfg: PipelineConfig):
    """The state byte uses the writing binary's enum: UL has HOVER..LANDING
    = 5..8 (uav_local_nav.c:484-496); CL (no EXPLORE/TURNING) has HOVER,
    LANDING = 5, 6 (clean:325-335)."""
    st = state.to(torch.int32)
    st_lo, st_hi = airborne_bounds(cfg)
    return (st >= st_lo) & (st <= st_hi)


def airborne_bounds(cfg: PipelineConfig) -> tuple:
    """The first and last state byte with the map active (airborne_state)."""
    return ST_HOVER, ST_LANDING if cfg.behavior.explore_enabled else 6


def init_and_recenter(origin_x, origin_y, inited, x, y, state,
                      cfg: PipelineConfig):
    """The scalar part of one mapper step for a [B] batch: map init, then
    the recenter decision and the origin shift.  Returns (origin_x,
    origin_y, inited, sx, sy, do)."""
    pose_finite = torch.isfinite(x) & torch.isfinite(y)
    do_init = ~inited & pose_finite & airborne_state(state, cfg)
    origin_x = torch.where(do_init, x, origin_x)
    origin_y = torch.where(do_init, y, origin_y)
    inited = inited | do_init
    sx, sy, do = recenter_decide(origin_x, origin_y, x, y,
                                 pose_finite & inited, cfg.map)
    res = _F32(cfg.map.res_m)
    return (shift_origin(origin_x, sx, res), shift_origin(origin_y, sy, res),
            inited, sx, sy, do)


def kf_flags_of(do):
    return torch.where(do, KF_MAP_RECENTER, 0).to(torch.uint8)


def carry(frames: dict, cfg: PipelineConfig, state0=None, *, library: str):
    """The sequential part of a whole replay, shared by every mode: the
    ToF filter, map init, recenter decision and origin shift
    (init_and_recenter), carried over T for the whole [B] batch, then the
    enable gates.  On a CUDA device it is one launch of the carry kernel
    (`carry_kernel`) from `library`, the mode's (MODES); on any other it
    is the plain torch loop (`carry_plain`).

    Returns (beams f32 [B, T, 4, 8], seq {ox, oy, sx, sy, do, enabled}
    of [B, T], outs {used, kf_flags, filt} [B, T, ...], final (origin_x,
    origin_y, inited, filt))."""
    beams, minima, seq, c0 = carry_operands(frames, cfg, state0)
    if seq["x_m"].device.type == "cuda":
        so, final = carry_kernel(library, minima, seq, c0, cfg)
    else:
        so, final = carry_plain(minima, seq, c0, cfg)
    outs = {"used": so["enabled"], "kf_flags": so.pop("kf_flags"),
            "filt": so.pop("filt")}
    return beams, so, outs, final


# the per-frame inputs of the carry besides the ToF minima
CARRY_KEYS = ("x_m", "y_m", "yaw_deg", "of_rate_x", "state", "of_q",
              "sys_health")


def carry_operands(frames: dict, cfg: PipelineConfig, state0=None) -> tuple:
    """What the carry takes from frames [B, T, ...] and a resume state:
    (beams f32 [B, T, 4, 8], minima f32 [B, T, 4], seq the CARRY_KEYS
    tensors [B, T] (contiguous; state and of_q int32), c0 the carry at
    the first frame: state0's (origin_x, origin_y, inited, filt), or a
    fresh mapper's (NaN origins and filter, not inited))."""
    x = frames["x_m"]
    B, dev = x.shape[0], x.device
    beams, minima = extract_beams(frames["grid_mm"], cfg.tof)
    seq = {k: frames[k].contiguous() for k in CARRY_KEYS}
    seq["state"] = seq["state"].to(torch.int32)
    seq["of_q"] = seq["of_q"].to(torch.int32)
    if state0 is not None:
        c0 = tuple(v.to(dev).contiguous() for v in (
            state0.origin_x, state0.origin_y, state0.inited, state0.filt))
    else:
        nan = torch.full((B,), math.nan, dtype=torch.float32, device=dev)
        c0 = (nan, nan, torch.zeros((B,), dtype=torch.bool, device=dev),
              torch.full((B, 4), math.nan, dtype=torch.float32, device=dev))
    return beams, minima, seq, c0


def carry_plain(minima: torch.Tensor, seq: dict, c0: tuple,
                cfg: PipelineConfig):
    """Plain torch version of the carry kernel, on any device: a Python
    loop over T of [B]-wide ops (tof_filter_update, init_and_recenter),
    then the enable gates.  minima, seq and c0 as carry_operands gives
    them.

    Returns ({ox, oy, sx, sy, do, enabled, kf_flags} [B, T] and filt
    [B, T, 4], final (origin_x, origin_y, inited, filt))."""
    x, y, state = seq["x_m"], seq["y_m"], seq["state"]
    ox, oy, inited, filt = c0
    steps = {k: [] for k in ("ox", "oy", "inited", "sx", "sy", "do", "filt")}
    for t in range(x.shape[1]):
        filt = tof_filter_update(filt, minima[:, t], cfg.tof.filt_alpha)
        ox, oy, inited, sx, sy, do = init_and_recenter(
            ox, oy, inited, x[:, t], y[:, t], state[:, t], cfg)
        for k, v in zip(steps, (ox, oy, inited, sx, sy, do, filt)):
            steps[k].append(v)
    so = {k: torch.stack(v, dim=1) for k, v in steps.items()}
    so["enabled"] = so.pop("inited") & pose_good_for_mapping(
        x, seq["yaw_deg"], seq["of_q"], seq["of_rate_x"], seq["sys_health"],
        cfg.gates.of_min_quality)
    so["kf_flags"] = kf_flags_of(so["do"])
    return so, (ox, oy, inited, filt)


def check_carry_operands(minima: torch.Tensor, seq: dict, c0: tuple) -> None:
    """Raise on operands the carry kernel does not take: every tensor
    contiguous on x_m's device, with carry_plain's shapes and minima,
    poses, yaw and flow rate float32, state and flow quality int32, the
    health word int32 or int64, and c0 (origin_x, origin_y float32 [B],
    inited bool [B], filt float32 [B, 4])."""
    x = seq["x_m"]
    if x.dim() != 2:
        raise ValueError(f"x_m must be [B, T], got {tuple(x.shape)}")
    B, T = x.shape
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    ops = [("minima", minima, (B, T, 4), (f32,))]
    ops += [(k, seq[k], (B, T), (f32,))
            for k in ("x_m", "y_m", "yaw_deg", "of_rate_x")]
    ops += [("state", seq["state"], (B, T), (i32,)),
            ("of_q", seq["of_q"], (B, T), (i32,)),
            ("sys_health", seq["sys_health"], (B, T), (i32, i64))]
    ops += [(k, v, shape, (dt,)) for k, v, shape, dt in zip(
        ("origin_x", "origin_y", "inited", "filt"), c0,
        ((B,), (B,), (B,), (B, 4)), (f32, f32, torch.bool, f32))]
    for name, v, shape, dtypes in ops:
        if v.dtype not in dtypes:
            raise TypeError(f"carry kernel: {name} must be "
                            f"{' or '.join(map(str, dtypes))}, got {v.dtype}")
        if tuple(v.shape) != shape:
            raise ValueError(f"carry kernel: {name} must be of shape "
                             f"{shape}, got {tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"carry kernel: {name} on {v.device}, x_m on "
                             f"{x.device}")
        if not v.is_contiguous():
            raise ValueError(f"carry kernel: {name} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"no carry kernel for device {x.device} "
                         f"(carry_plain runs anywhere)")


def carry_kernel(library: str, minima: torch.Tensor, seq: dict, c0: tuple,
                 cfg: PipelineConfig):
    """carry_plain's outputs from one launch of the carry kernel
    (csrc/carry.cuh) in the replay library `library` (one of
    ops/_build.py::ENTRIES["mqs_carry"].libraries), on CUDA tensors;
    bit-equal to carry_plain on the card.  Raises on operands it does not
    take (check_carry_operands) and on a failed launch.  Each launch
    counts in launches.carry (utils/obs.py)."""
    check_carry_operands(minima, seq, c0)
    x = seq["x_m"]
    B, T = x.shape
    dev = x.device
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    so = {"ox": empty((B, T), torch.float32),
          "oy": empty((B, T), torch.float32),
          "sx": empty((B, T), torch.int32), "sy": empty((B, T), torch.int32),
          "do": empty((B, T), torch.bool),
          "enabled": empty((B, T), torch.bool),
          "kf_flags": empty((B, T), torch.uint8),
          "filt": empty((B, T, 4), torch.float32)}
    final = (empty((B,), torch.float32), empty((B,), torch.float32),
             empty((B,), torch.bool), empty((B, 4), torch.float32))
    if B == 0:
        return so, final
    keep, a = tof_filter_weights(cfg.tof.filt_alpha)
    thresh, res, max_shift = recenter_constants(cfg.map)
    st_lo, st_hi = airborne_bounds(cfg)
    health = seq["sys_health"]
    ins = [minima] + [seq[k] for k in ("x_m", "y_m", "yaw_deg", "of_rate_x",
                                       "state", "of_q")]
    outs = [so[k] for k in ("ox", "oy", "sx", "sy", "do", "enabled",
                            "kf_flags", "filt")]
    _build.launch(library, "mqs_carry", dev, *ins, health,
                  int(health.dtype == torch.int64), *c0, *outs, *final,
                  B, T, keep, a, thresh, res, 1.0 / res, max_shift, st_lo,
                  st_hi,
                  SENSOR_XY_POSITION_CONTROL | SENSOR_Z_ALTITUDE_CONTROL,
                  cfg.gates.of_min_quality, KF_MAP_RECENTER)
    return so, final


def mapping_step(
    state: MappingState,
    frame: dict,
    cfg: PipelineConfig = UL_PROFILE,
    geom: GridGeom = DEFAULT_GEOM,
    kernel: str = "xla",
):
    """One scanrec (for the whole [B] batch) through the mapper: the exact
    update in plain torch ("xla") or through ops/residentx.map_step
    ("pallas", "pallas_db": the map-step kernel on a CUDA device, its
    plain version on the CPU; bit-equal to "xla"), or the dense "cone" or
    "hybrid" one (ops/conemode.py).  Returns (new state, outs); the input
    state is not modified.

    `frame` holds [B]-leading tensors: either raw `grid_mm` int [B,4,8,8]
    or precomputed `beams`/`minima` (the replay loop extracts beams for
    all frames up front)."""
    route = KERNELS.get(kernel)
    if route is None or route.whole:
        raise ValueError(f"unknown per-frame kernel {kernel!r}; one of "
                         f"{[k for k, r in KERNELS.items() if not r.whole]}")
    if "beams" in frame:
        beams, minima = frame["beams"], frame["minima"]
    else:
        beams, minima = extract_beams(frame["grid_mm"], cfg.tof)

    filt = tof_filter_update(state.filt, minima, cfg.tof.filt_alpha)
    x, y, yaw = frame["x_m"], frame["y_m"], frame["yaw_deg"]
    origin_x, origin_y, inited, sx, sy, do_rc = init_and_recenter(
        state.origin_x, state.origin_y, state.inited, x, y, frame["state"],
        cfg)
    # the full-grid shift only when ANY quad recenters (a host sync)
    if bool(do_rc.any()):
        grid = recenter_apply(state.grid, sx, sy, cfg.map, geom)
    else:
        grid = state.grid.clone()

    enabled = inited & pose_good_for_mapping(
        x, yaw, frame["of_q"].to(torch.int32), frame["of_rate_x"],
        frame["sys_health"], cfg.gates.of_min_quality)
    if kernel == "xla":
        rays = make_rays(beams, x, y, yaw, origin_x, origin_y, enabled,
                         cfg.map, cfg.tof)
        apply_rays_(grid, rays, cfg.map, geom)
    elif route.mode == "exact":
        rx.map_step(grid, beams, x, y, yaw, origin_x, origin_y, enabled, cfg,
                    geom)
    else:
        inp = conemode.scan_inputs(beams, x, y, yaw, origin_x, origin_y,
                                   enabled, cfg.map, cfg.tof, geom,
                                   hybrid=route.mode == "hybrid")
        conemode.apply_scans_(grid, inp, cfg.map, cfg.tof, geom)

    new_state = MappingState(grid, origin_x, origin_y, inited, filt)
    out = {"used": enabled, "kf_flags": kf_flags_of(do_rc), "filt": filt}
    return new_state, out


def scanlog_to_arrays(scanlog) -> dict:
    """Host-side: ScanLog -> dict of [T] numpy arrays."""
    return {
        "grid_mm": np.ascontiguousarray(scanlog.grid_mm),
        "x_m": np.ascontiguousarray(scanlog.x_m),
        "y_m": np.ascontiguousarray(scanlog.y_m),
        "yaw_deg": np.ascontiguousarray(scanlog.yaw_deg),
        "of_q": np.ascontiguousarray(scanlog.of_q),
        "of_rate_x": np.ascontiguousarray(scanlog.of_rate_x),
        "sys_health": np.ascontiguousarray(scanlog.sys_health),
        "state": np.ascontiguousarray(scanlog.state),
    }


def frames_to_torch(frames: dict, device=None) -> dict:
    """dict of numpy arrays -> dict of tensors on `device` (default the
    CUDA device).  Integers narrower than 32 bits (the u16 ToF
    millimetres, u8 state/quality) widen to int32 and u32/64-bit ones to
    int64, since torch's unsigned types support few ops; floats stay
    float32."""
    device = as_device(device)
    out = {}
    for k, v in frames.items():
        a = np.asarray(v)
        if a.dtype.kind in "ui":
            a = a.astype(np.int32 if a.dtype.itemsize < 4
                         or a.dtype == np.int32 else np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


_SEQ_KEYS = ("x_m", "y_m", "yaw_deg", "of_q", "of_rate_x", "sys_health", "state")


def check_replay_inputs(frames: dict, state0) -> None:
    """Validate a replay's frames and its resume state."""
    if frames["x_m"].dim() != 2 or frames["x_m"].shape[1] == 0:
        raise ValueError(f"frames must be [B, T, ...] with T >= 1, got x_m "
                         f"of shape {tuple(frames['x_m'].shape)}")
    if state0 is not None and \
            state0.origin_x.shape[0] != frames["x_m"].shape[0]:
        raise ValueError(
            f"batch mismatch: state0 holds {state0.origin_x.shape[0]} "
            f"flights but frames hold {frames['x_m'].shape[0]} (resume "
            f"must continue the same batch)")


def schedule(frames: dict, cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM,
             state0=None, mode: str = "exact"):
    """Grid-free replay of frames [B, T, ...] in a whole-replay mode
    (MODES): the carry, which reproduces mapping_step's filter / init /
    recenter / enable sequence, in the span replay.carry, then the mode's
    schedule words in the span replay.rays.

    Returns (sched int32 [B, T, words], outs {used, kf_flags, filt}
    [B, T, ...], final (origin_x, origin_y, inited, filt))."""
    m = MODES[mode]
    with obs.span("replay.carry"):
        beams, so, outs, final = carry(frames, cfg, state0,
                                       library=m.library)
    # everything below is carry-free: vectorized over [B, T]
    with obs.span("replay.rays"):
        sched = m.words(frames, beams, so, cfg, geom)
    return sched, outs, final


def replay_whole(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                 geom: GridGeom = DEFAULT_GEOM, state0=None,
                 mode: str = "exact"):
    """Whole replay in a mode of MODES: frames dict of [B, T, ...] tensors
    (one device).  Returns (MappingState [B], outs [B, T]), bit-identical
    to the mode's per-frame replay (and, exact, to the golden C model),
    recenters and resume included.  state0 resumes a prior replay's
    MappingState.  The schedule, then one call of the mode's kernel on
    fresh or resumed grids.  While a torch profiler records it records the
    spans replay, replay.carry, replay.rays and replay.kernel
    (utils/obs.py); it counts replay.frames and replay.recenters
    (count_replay)."""
    check_replay_inputs(frames, state0)
    dev = frames["x_m"].device
    B, T = frames["x_m"].shape
    with obs.span("replay", dev):
        sched, outs, (ox, oy, inited, filt) = schedule(frames, cfg, geom,
                                                       state0, mode)
        if state0 is not None:
            grids = state0.grid.to(dev).clone(
                memory_format=torch.contiguous_format)
        else:
            grids = torch.zeros((B, geom.prows, geom.pcols),
                                dtype=torch.int8, device=dev)
        with obs.span("replay.kernel"):
            MODES[mode].apply(grids, sched, cfg, geom=geom)
        count_replay(sched, B * T)
    return MappingState(grids, ox, oy, inited, filt), outs


def count_replay(sched: torch.Tensor, frames: int) -> None:
    """A whole replay's counters: its flight-frames, and (while spans
    record) the flight-frames whose recenter flag (0 or 1) is set."""
    obs.count("replay.frames", frames)
    obs.count("replay.recenters", sched[..., rx.H_DO])


def replay_mapping_batched(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                           geom: GridGeom = DEFAULT_GEOM,
                           kernel: str = "xla", state0=None):
    """Batched replay: frames dict of [B, T, ...] tensors (see
    frames_to_torch), all on one device -> (MappingState [B], outs [B, T]).
    `kernel` is a name of KERNELS.  Every exact name gives grids bit-equal
    to the reference; each whole-replay name (replay_whole) is bit-equal
    to its mode's per-frame path.

    state0 resumes a previous replay: pass the MappingState from an
    earlier call (or one carried over from the JAX package with
    mapping_state_from_numpy) and the continuation is bit-identical to
    replaying the concatenated frames in one call."""
    route = KERNELS.get(kernel)
    if route is None:
        raise ValueError(f"unknown kernel {kernel!r}")
    if route.whole:
        return replay_whole(frames, cfg, geom, state0, route.mode)

    check_replay_inputs(frames, state0)
    B, T = frames["x_m"].shape
    # beams for every (flight, frame) at once, outside the time loop
    beams, minima = extract_beams(frames["grid_mm"], cfg.tof)
    state = state0 if state0 is not None else mapping_init(
        B, geom, frames["x_m"].device)
    outs = []
    for t in range(T):
        fr = {k: frames[k][:, t] for k in _SEQ_KEYS}
        fr["beams"], fr["minima"] = beams[:, t], minima[:, t]
        state, out = mapping_step(state, fr, cfg, geom, kernel)
        outs.append(out)
    outs = {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}
    return state, outs


def replay_mapping(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                   geom: GridGeom = DEFAULT_GEOM):
    """Replay one flight: frames dict of [T, ...] tensors.

    Returns (MappingState without the batch dim, outs of [T, ...])."""
    frames_b = {k: v[None] for k, v in frames.items()}
    state, outs = replay_mapping_batched(frames_b, cfg, geom)
    state = MappingState(*(v[0] for v in state))
    outs = {k: v[0] for k, v in outs.items()}
    return state, outs
