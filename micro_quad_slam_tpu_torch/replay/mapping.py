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
CUDA device unless the caller passes another.  `kernel="xla"` is the
per-frame plain torch path of the exact mode, "pallas" and "pallas_db"
its per-frame path through the exact kernel's map-step entry
(ops/residentx.map_step), "cone" and "hybrid" the per-frame paths of the
dense production modes (ops/conemode.py).  The exact whole-replay names
go to ops/residentx.replay_residentx, the cone and hybrid ones to
ops/conex.replay_conex; each launches its Hopper kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.utils.config import PipelineConfig, UL_PROFILE
from micro_quad_slam_tpu_torch.ops import conemode
from micro_quad_slam_tpu_torch.ops.beams import extract_beams, tof_filter_update
from micro_quad_slam_tpu_torch.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    apply_rays_,
    make_rays,
    recenter_apply,
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

# kernel names with reference-exact semantics that go to the whole-replay
# exact kernel (the JAX package's whole-replay and matmul formulations of
# the same update give bit-identical grids)
EXACT_KERNELS = ("residentx", "resident", "mxu", "mxu2")
# the per-frame paths: the exact update in plain torch ("xla") and through
# the exact kernel's map-step entry ("pallas", "pallas_db": the JAX
# package's per-frame window kernels), and the dense production modes
PER_FRAME_KERNELS = ("xla", "pallas", "pallas_db", "cone", "hybrid")
# these names run the whole replay through the cone kernel (name ->
# hybrid?; "resident_cone" is the JAX package's v1 cone kernel, the same
# cone semantics)
CONEX_KERNELS = {"conex": False, "resident_cone": False, "hybridx": True}


class MappingState(NamedTuple):
    """Per-quad mapper state; every field carries a leading batch dim [B]
    (B == () for the single-flight wrappers)."""

    grid: torch.Tensor       # int8 [B, prows, pcols] padded occupancy grid
    origin_x: torch.Tensor   # f32 [B] map origin (world NED at grid center)
    origin_y: torch.Tensor
    inited: torch.Tensor     # bool [B]
    filt: torch.Tensor       # f32 [B, 4] EMA'd per-direction ToF minima


def as_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on: CUDA unless the
    caller names another.  Raises when CUDA is asked for and absent,
    instead of landing on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain torch path on the CPU")
    return device


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
    st_hi = ST_LANDING if cfg.behavior.explore_enabled else 6
    return (st >= ST_HOVER) & (st <= st_hi)


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
    if kernel not in PER_FRAME_KERNELS:
        raise ValueError(f"unknown per-frame kernel {kernel!r}; one of "
                         f"{PER_FRAME_KERNELS}")
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
    elif kernel in ("pallas", "pallas_db"):
        from micro_quad_slam_tpu_torch.ops.residentx import map_step
        map_step(grid, beams, x, y, yaw, origin_x, origin_y, enabled, cfg,
                 geom)
    else:
        inp = conemode.scan_inputs(beams, x, y, yaw, origin_x, origin_y,
                                   enabled, cfg.map, cfg.tof, geom,
                                   hybrid=kernel == "hybrid")
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


def replay_mapping_batched(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                           geom: GridGeom = DEFAULT_GEOM,
                           kernel: str = "xla", state0=None):
    """Batched replay: frames dict of [B, T, ...] tensors (see
    frames_to_torch), all on one device -> (MappingState [B], outs [B, T]).
    Every exact kernel name gives grids bit-equal to the reference;
    "residentx" (and its aliases) runs the whole replay through the exact
    Hopper kernel on a CUDA device, "pallas" and "pallas_db" go frame by
    frame through its map-step entry.  "cone" and "hybrid" are the dense
    production modes, per frame in plain torch; "conex" and
    "resident_cone" (cone) and "hybridx" (hybrid) run the whole replay
    through the cone Hopper kernel, bit-equal to the per-frame path.

    state0 resumes a previous replay: pass the MappingState from an
    earlier call (or one carried over from the JAX package with
    mapping_state_from_numpy) and the continuation is bit-identical to
    replaying the concatenated frames in one call."""
    if kernel in EXACT_KERNELS:
        from micro_quad_slam_tpu_torch.ops.residentx import replay_residentx
        return replay_residentx(frames, cfg, geom, state0=state0)
    if kernel in CONEX_KERNELS:
        from micro_quad_slam_tpu_torch.ops.conex import replay_conex
        return replay_conex(frames, cfg, geom, state0=state0,
                            hybrid=CONEX_KERNELS[kernel])
    if kernel not in PER_FRAME_KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")

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
