"""Closed-loop swarm simulator in PyTorch: N virtual quads flying the full
autonomy stack on one device (counterpart of
micro_quad_slam_tpu/models/simulator.py).

Each sim step composes the whole framework, for the [B] batch at once:

  world raytrace -> ToF scan synth                     [scan ticks]
  FC model       -> telemetry                          [every step]
  EKF            -> pose estimate (ops/ekf.py)         [every step]
  mapper         -> occupancy grid (ops/residentx.map_step)  [scan ticks]
  frontier       -> exploration queries (ops/raycast.py)      [scan ticks]
  behavior       -> commands (models/behavior.py)      [every step]
  dynamics       -> pose/velocity integration          [every step]

The swarm flies one of two machines, chosen by the machine state it
carries (sim_init(machine=)): the UL machine (BehaviorState,
uav_local_nav.c: mapping, frontier exploration, turning) or the clean
revision's hover machine (BehaviorClState, models/behavior_cl.py,
clean_uav_fc_tof_nav.c).  The clean revision has no mapper: its tick
scans the ToF (whose minima feed its ToF filter) but makes no map step
and no frontier query, and its state holds no map grids (`mapper` is
None).  Its telemetry reports the enabled sensor bits as the health bits,
and its rangefinder and flow quality at every height (its prearm gate
reads both on the ground, clean:999-1036); the FC model takes its
Z+yaw setpoint (CMD_Z_YAW) as an altitude hold at the commanded z, a
climb of (z - alt) clamped to +/-0.3 m/s as the position setpoint's z,
with the XY velocity setpoint at zero and the yaw held.

Under a torch profiler (utils/obs.py) sim_run is the span `sim` and each
tick's stages are its spans sim.scan (the scan branch: world raytrace,
scan synth, beams, map step), sim.frontier (scan ticks), sim.flow (and,
on a vision-flow frame, inside it sim.flow.render, the camera frames,
and sim.flow.lk, the pyramidal LK and the rate conversion), sim.ekf,
sim.behavior (the machine and the map init it asks for) and sim.fc
(twice a tick: the telemetry, then the FC applying the outputs and the
dynamics); the host counters sim.ticks and sim.scan_ticks count every
tick, sim.cl_ticks the clean machine's ticks and sim.flow_frames the
quad-frames the vision flow flowed, and the device counters sim.turning
the quad-ticks spent in TURNING (UL), sim.cl_locked those with the clean
machine's hover locked and sim.flow_low_q the vision flow's quad-frames
whose quality is under gates.of_min_quality.  Untraced, the spans are
no-ops and the device counters are not computed.

The time is a host integer, so whether a tick scans is decided on the
host: the scan branch and the frontier refresh run only on scan ticks, by
a Python `if`, where the JAX module selects with lax.cond.  A scan tick's
map update is ops/residentx.map_step: the map-step kernel on a CUDA
device, its plain version on the CPU.  Every UL tick's behaviour step is
models/behavior.py::behavior_step: one launch of the machine's kernel
(csrc/behavior.cuh) on a CUDA device, its plain torch path on the CPU; a
clean tick's is models/behavior_cl.py::behavior_step_cl: one launch of
the clean machine's kernel (csrc/behavior_cl.cuh) on a CUDA device, its
plain torch path (behavior_step_cl_plain) on the CPU.

Randomness.  The JAX module draws from jax.random; this one from an
explicit CPU torch.Generator that the state carries in place of the key
(`SimState.gen`).  A scan tick draws its standard-normal noise and its
uniform dropout draws, each [B, 4, 8, 8], on that generator and copies
them to the state's device, so a run on the card and a run on the CPU
draw the same numbers.  `sim_step(draws=...)` and `sim_run(draws=...)`
take the draws from the caller instead: that is how a test hands the port
the JAX package's own draws.

Floats are eager torch operations (no product and sum is contracted into
an fma, where XLA-CPU contracts some) and trig is the correctly rounded
float32 value (ops/raycast.py::_cos_f32), so the port's float path
differs from the JAX package's in the last bits; integer outputs (states,
commands kinds, frontier scores, grids) are equal on the test runs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.models.behavior import (
    ALT_RF,
    CMD_POS_YAW,
    CMD_VEL_BODY,
    CMD_VEL_NED,
    MODE_GUIDED,
    MODE_LAND,
    ST_EXPLORE,
    ST_TURNING,
    BehaviorState,
    behavior_init,
    behavior_state_from_numpy,
    behavior_state_to_numpy,
    behavior_step,
)
from micro_quad_slam_tpu_torch.models.behavior_cl import (
    CL_HOVER,
    CMD_Z_YAW,
    BehaviorClState,
    behavior_cl_init,
    behavior_step_cl,
)
from micro_quad_slam_tpu_torch.ops.beams import extract_beams
from micro_quad_slam_tpu_torch.ops.ekf import EkfState, ekf_init, ekf_step
from micro_quad_slam_tpu_torch.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    _cos_f32,
    _sin_f32,
    frontier_scores,
)
from micro_quad_slam_tpu_torch.ops.residentx import map_step
from micro_quad_slam_tpu_torch.replay.mapping import (
    MappingState,
    mapping_init,
    mapping_state_from_numpy,
    mapping_state_to_numpy,
)
from micro_quad_slam_tpu_torch.utils import obs
from micro_quad_slam_tpu_torch.utils.config import (
    CL_PROFILE,
    UL_PROFILE,
    PipelineConfig,
)
from micro_quad_slam_tpu_torch.utils.device import as_device

_F32 = np.float32
HEALTH_ALL = 0x01 | 0x2000 | 0x4000 | 0x400000
FLOW_Q = 85                                # the oracle flow sensor's quality
MACHINES = ("ul", "cl")
_DEG2RAD = float(_F32(np.pi / 180.0))      # jnp.deg2rad's float32 constant
FRONTIER_OFFSETS = (0.0, 90.0, -90.0, 180.0)


def _f(x) -> float:
    return float(_F32(x))


class World(NamedTuple):
    """Axis-aligned rooms with rectangular obstacles, per quad.

    room: f32 [B, 4] (xmin, ymin, xmax, ymax)
    obstacles: f32 [B, K, 4]; obstacle_mask: bool [B, K]
    """

    room: torch.Tensor
    obstacles: torch.Tensor
    obstacle_mask: torch.Tensor


def make_world(batch: int, room=(-4.0, -4.0, 4.0, 4.0), obstacles=(),
               max_obstacles: int = 4, device=None) -> World:
    """The same room and obstacles for every quad, on `device` (the CUDA
    device unless told otherwise)."""
    device = as_device(device)
    K = max(max_obstacles, len(obstacles))
    obs = np.zeros((batch, K, 4), np.float32)
    msk = np.zeros((batch, K), bool)
    for i, ob in enumerate(obstacles):
        obs[:, i] = ob
        msk[:, i] = True
    room = np.broadcast_to(np.asarray(room, np.float32), (batch, 4))
    return World(room=torch.from_numpy(room.copy()).to(device),
                 obstacles=torch.from_numpy(obs).to(device),
                 obstacle_mask=torch.from_numpy(msk).to(device))


def world_from_boxes(room, boxes) -> World:
    """Per-quad rooms [B, 4] and boxes [B, K, 4] (xmin, ymin, xmax, ymax;
    tensors) -> a World on the rooms' device.  A box row holding a NaN is
    absent: zeros under a false mask, as make_world leaves its unused
    slots, so the world of make_world's rooms and boxes (NaN where its
    mask is false) is make_world's own."""
    room = torch.as_tensor(room, dtype=torch.float32)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=room.device)
    mask = ~torch.isnan(boxes).any(dim=-1)
    return World(room=room,
                 obstacles=torch.where(mask[..., None], boxes, 0.0),
                 obstacle_mask=mask)


def ray_distances(world: World, x, y, ang_rad) -> torch.Tensor:
    """Exact distance to the nearest wall along angles [B, R] from inside
    the room (vectorized twin of sim/synthio.room_tof_distance)."""
    c = _cos_f32(ang_rad)
    s = _sin_f32(ang_rad)
    big = _f(1e9)
    eps = _f(1e-12)
    W = torch.where

    def exit_dist(lo, hi, o, d):
        t_hi = W(d > eps, (hi - o) / d, big)
        t_lo = W(d < -eps, (lo - o) / d, big)
        return torch.minimum(W(t_hi > 0, t_hi, big), W(t_lo > 0, t_lo, big))

    rx0, ry0, rx1, ry1 = (world.room[..., i, None] for i in range(4))
    d_room = torch.minimum(exit_dist(rx0, rx1, x[..., None], c),
                           exit_dist(ry0, ry1, y[..., None], s))

    # [B, K, R] entry distance into the obstacle boxes from outside
    bx0, by0, bx1, by1 = (world.obstacles[..., i, None] for i in range(4))
    cc = c[..., None, :]
    ss = s[..., None, :]
    ox = x[..., None, None]
    oy = y[..., None, None]

    def axis(lo, hi, o, d):
        par = d.abs() < eps
        safe = W(par, eps, d)
        t0 = (lo - o) / safe
        t1 = (hi - o) / safe
        tmin = torch.minimum(t0, t1)
        tmax = torch.maximum(t0, t1)
        inside = (o >= lo) & (o <= hi)
        tmin = W(par, W(inside, -big, big), tmin)
        tmax = W(par, W(inside, big, -big), tmax)
        return tmin, tmax

    txm, txM = axis(bx0, bx1, ox, cc)
    tym, tyM = axis(by0, by1, oy, ss)
    tmin = torch.clamp(torch.maximum(txm, tym), min=0.0)
    tmax = torch.minimum(txM, tyM)
    hit = (tmin <= tmax) & (tmin > 0) & world.obstacle_mask[..., None]
    enter = W(hit, tmin, big).amin(dim=-2)
    return torch.minimum(d_room, enter)


def synth_scan_mm(world: World, x, y, yaw_deg, normal, uniform,
                  noise_mm: float, dropout_p: float,
                  cfg: PipelineConfig) -> torch.Tensor:
    """Synthesize the [B, 4, 8, 8] ToF grid in mm (the sensor's u16 values,
    held as int32) from the world (hub analog, tof_esp32.ino:183-209): all
    8 rows of a column see the column's fan distance, plus noise and
    dropouts to exercise the second-min beam logic.  normal and uniform
    are the [B, 4, 8, 8] standard-normal and uniform draws (unused when
    noise_mm or dropout_p is 0)."""
    tof = cfg.tof
    dev = x.device
    half_fov = _F32(tof.half_fov_deg)
    u = (np.arange(8, dtype=np.float32) - _F32(3.5)) / _F32(3.5)
    fan = (np.asarray(tof.dir_center_deg, np.float32)[:, None]
           + u[None, :] * half_fov).reshape(-1)                      # [32]
    ang = (yaw_deg[..., None] + torch.from_numpy(fan).to(dev)) * _DEG2RAD
    dist = ray_distances(world, x, y, ang)                            # [B, 32]
    mm = dist.reshape(dist.shape[:-1] + (4, 1, 8)) * 1000.0
    mm = mm.expand(mm.shape[:-3] + (4, 8, 8))
    if noise_mm > 0:
        mm = mm + normal.to(dev) * _f(noise_mm)
    cells = torch.clamp(torch.round(mm), 1, 65000).to(torch.int32)
    cells = torch.where(mm > 60000.0, 0xFFFF, cells)
    if dropout_p > 0:
        cells = torch.where(uniform.to(dev) < _f(dropout_p), 0xFFFF, cells)
    return cells


class FcSim(NamedTuple):
    """Observable flight-controller model state (per quad)."""

    armed: torch.Tensor
    mode: torch.Tensor
    motor: torch.Tensor
    takeoff_active: torch.Tensor
    takeoff_target: torch.Tensor
    have_ack: torch.Tensor
    ack_res: torch.Tensor
    ack_ms: torch.Tensor
    accept_ms: torch.Tensor
    batt_v: torch.Tensor
    climb_cmd: torch.Tensor      # +up, from CMD_VEL_NED
    vset_bx: torch.Tensor        # body-frame velocity setpoint
    vset_by: torch.Tensor
    yaw_rate_cmd: torch.Tensor   # deg/s
    pos_cmd: torch.Tensor        # [B, 3] x, y, z_down from CMD_POS_YAW
    pos_cmd_yaw: torch.Tensor
    pos_hold: torch.Tensor       # bool: position setpoint active


_FC_DTYPES = {"armed": torch.bool, "mode": torch.int32,
              "takeoff_active": torch.bool, "have_ack": torch.bool,
              "ack_res": torch.int32, "ack_ms": torch.int32,
              "accept_ms": torch.int32, "pos_hold": torch.bool}


def fc_init(batch: int, batt_v0: float = 8.2, device=None) -> FcSim:
    device = as_device(device)
    vals = {}
    for k in FcSim._fields:
        shape = (batch, 3) if k == "pos_cmd" else (batch,)
        vals[k] = torch.zeros(shape, dtype=_FC_DTYPES.get(k, torch.float32),
                              device=device)
    vals["motor"] = torch.full((batch,), 1000.0, device=device)
    vals["batt_v"] = torch.full((batch,), _f(batt_v0), device=device)
    return FcSim(**vals)


CAM_SIZE = 32       # downward camera resolution (vision-flow mode)
CAM_FOCAL = 60.0    # focal length in pixels


def _camera_frame(x, y, alt, yaw_rad) -> torch.Tensor:
    """The downward camera's frames [B, CAM, CAM] at poses [B] (the
    height floored at 0.05 m)."""
    from micro_quad_slam_tpu_torch.ops.flow import render_camera_frame

    return render_camera_frame(x, y, torch.clamp(alt, min=0.05), yaw_rad,
                               CAM_SIZE, CAM_FOCAL)


class SimState(NamedTuple):
    t_ms: int                   # host int
    gen: torch.Generator        # CPU generator of the scan ticks' draws
    x: torch.Tensor             # true pose [B]
    y: torch.Tensor
    yaw: torch.Tensor           # deg, wrapped
    vx: torch.Tensor            # true world velocity
    vy: torch.Tensor
    alt: torch.Tensor
    fc: FcSim
    beh: BehaviorState | BehaviorClState   # the machine the swarm flies
    mapper: MappingState | None            # None: the clean machine's
    ekf: EkfState
    tof_min: torch.Tensor       # [B, 4] latest per-dir minima
    scan_count: int             # host int
    cam_prev: torch.Tensor      # [B, CAM, CAM] previous camera frame
    cam_valid: bool             # cam_prev holds a real frame
    vis_rate_x: torch.Tensor    # [B] latched vision flow rates (rad/s)
    vis_rate_y: torch.Tensor
    vis_q: torch.Tensor         # [B] vision flow quality 0..255
    frontier: torch.Tensor      # i32 [B, 4] latest frontier scores (scan ticks)


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float):
    """n float32 draws in [lo, hi) on the CPU generator."""
    return torch.rand(n, generator=gen) * _f(hi - lo) + _f(lo)


def sim_init(batch: int, seed: int = 0, geom: GridGeom = DEFAULT_GEOM,
             spread_m: float = 1.0, airborne: bool = False,
             hover_alt_m: float | None = None, device=None, start=None,
             t0_ms: int = 0, machine: str = "ul",
             xy_stamp_ms: int = 1, camera_streaming: bool = False) -> SimState:
    """The swarm's start state on `device` (the CUDA device unless told
    otherwise): quads spread uniformly over +/-spread_m with random
    headings, drawn on a CPU generator seeded with `seed`, which the state
    keeps for its scan ticks.  `start` = (x, y, yaw_deg), each [B], gives
    every quad its own start pose in place of the draws; the draws are
    made all the same, so the generator's scan draws do not depend on it.

    `machine` is the flight machine the swarm flies: "ul" (BehaviorState)
    or "cl", the clean revision's (BehaviorClState; no map grids).

    airborne=True starts the fleet mid-mission, armed in GUIDED at
    hover_alt_m (None: 0.5 m for "ul", CL_PROFILE's hover target, 0.45 m,
    for "cl").  UL: behaviour in EXPLORE with captured hover targets, and
    the mapper inited at the start pose, so that every scan tick from t=0
    runs a real map update.  CL: in CL_HOVER as enter_state leaves it after
    the takeoff (clean:1957-2031), the hover targets not locked, the
    prelock captured at the start pose, the yaw target at the start
    heading, alt_max and alt_est at the altitude from the rangefinder.
    t0_ms is the mission clock at the start; the XY hold is stamped at
    xy_stamp_ms (UL: the frontier timer at 0), so from a clock past the
    stamp plus gates.xy_stable_hold_ms (UL: and behavior.frontier_eval_ms)
    an airborne UL quad explores from its first tick, flying forward or
    turning from what its first scan and frontier queries show, and a CL
    quad locks its hover.

    camera_streaming=True starts the downward camera mid-stream: cam_prev
    is the frame rendered at the start pose (as sim_step renders it) and
    cam_valid is True, so the first vision-flow frame flows as every later
    one does, where a camera that starts with the run reports no rate on
    its first frame."""
    if machine not in MACHINES:
        raise ValueError(f"machine {machine!r}: one of {MACHINES}")
    cl = machine == "cl"
    if hover_alt_m is None:
        hover_alt_m = CL_PROFILE.behavior.hover_target_m if cl else 0.5
    device = as_device(device)
    gen = torch.Generator().manual_seed(seed)
    drawn = (_uniform(gen, batch, -spread_m, spread_m),
             _uniform(gen, batch, -spread_m, spread_m),
             _uniform(gen, batch, -180.0, 180.0))
    x0, y0, yaw0 = (torch.as_tensor(v, dtype=torch.float32, device=device)
                    for v in (drawn if start is None else start))
    fc = fc_init(batch, device=device)
    beh = behavior_cl_init(batch, device) if cl else behavior_init(batch,
                                                                   device)
    mapper = None if cl else mapping_init(batch, geom, device)
    ekf = ekf_init((batch,), device=device)
    alt = torch.zeros((batch,), device=device)
    if airborne:
        alt = torch.full((batch,), _f(hover_alt_m), device=device)
        fc = fc._replace(
            armed=torch.ones((batch,), dtype=torch.bool, device=device),
            mode=torch.full((batch,), MODE_GUIDED, dtype=torch.int32,
                            device=device),
            motor=torch.full((batch,), 1500.0, device=device))
        yes = torch.ones((batch,), dtype=torch.bool, device=device)
        i32 = lambda v: torch.full((batch,), v, dtype=torch.int32,  # noqa: E731
                                   device=device)
        if cl:
            beh = beh._replace(
                st=i32(CL_HOVER), yaw_tv=yes, yaw_t=yaw0, alt_max=alt,
                alt_est=alt, alt_src=i32(ALT_RF), hv_pre_valid=yes,
                hv_pre_x=x0, hv_pre_y=y0, to_sent=yes, to_started=yes,
                armed_prev=yes, xy_since=i32(xy_stamp_ms))
        else:
            beh = beh._replace(
                st=i32(ST_EXPLORE), yaw_tv=yes, yaw_t=yaw0,
                hover_valid=yes, hover_x=x0, hover_y=y0,
                hover_z=-alt, hover_yaw=yaw0,
                alt_est=alt, alt_src=i32(ALT_RF),
                to_sent=yes, to_started=yes, armed_prev=yes,
                xy_since=i32(xy_stamp_ms))
            mapper = mapper._replace(inited=yes, origin_x=x0, origin_y=y0)
        ekf = ekf_init((batch,), x0=x0, y0=y0, z0=alt,
                       yaw0=yaw0 * _DEG2RAD, device=device)
    nan = lambda *s: torch.full(s, float("nan"), device=device)       # noqa: E731
    cam = torch.zeros((batch, CAM_SIZE, CAM_SIZE), device=device)
    if camera_streaming:
        cam = _camera_frame(x0, y0, alt, yaw0 * _DEG2RAD)
    return SimState(
        t_ms=t0_ms, gen=gen, x=x0, y=y0, yaw=yaw0,
        vx=torch.zeros((batch,), device=device),
        vy=torch.zeros((batch,), device=device),
        alt=alt, fc=fc, beh=beh, mapper=mapper, ekf=ekf,
        tof_min=nan(batch, 4), scan_count=0,
        cam_prev=cam, cam_valid=camera_streaming,
        vis_rate_x=nan(batch), vis_rate_y=nan(batch),
        vis_q=torch.zeros((batch,), dtype=torch.int32, device=device),
        frontier=torch.zeros((batch, 4), dtype=torch.int32, device=device))


_SIM_DTYPES = {"x": np.float32, "y": np.float32, "yaw": np.float32,
               "vx": np.float32, "vy": np.float32, "alt": np.float32,
               "tof_min": np.float32, "cam_prev": np.float32,
               "vis_rate_x": np.float32, "vis_rate_y": np.float32,
               "vis_q": np.int32, "frontier": np.int32}


def sim_state_from_numpy(d, device=None, seed: int = 0) -> SimState:
    """A simulator state held as numpy arrays -> the port's SimState on
    `device`.  `d` is the JAX package's SimState after
    `jax.tree.map(np.asarray, st)` (or sim_state_to_numpy's dict): the
    JAX field names, with fc, beh, mapper and ekf nested.  A JAX `key`
    has no torch counterpart: the port's state draws on a new CPU
    generator seeded with `seed`.  A `gen` entry (the generator's state as
    uint8, which a port checkpoint holds) restores the generator instead,
    so a resumed run draws what the unbroken one would.  A port state of
    the clean machine (sim_state_to_numpy's `machine` "cl") comes back as
    one: its BehaviorClState and no mapper."""
    device = as_device(device)
    d = d._asdict() if hasattr(d, "_asdict") else dict(d)
    gen = torch.Generator().manual_seed(seed)
    if "gen" in d:
        gen.set_state(torch.from_numpy(np.array(d["gen"], dtype=np.uint8)))
    nested = lambda v: v._asdict() if hasattr(v, "_asdict") else dict(v)  # noqa: E731
    ten = lambda a, dt: torch.from_numpy(np.array(a, dtype=dt)).to(device)  # noqa: E731
    fc = nested(d["fc"])
    np_dtype = {torch.bool: np.bool_, torch.int32: np.int32}
    fc = FcSim(**{k: ten(fc[k], np_dtype[_FC_DTYPES[k]] if k in _FC_DTYPES
                         else np.float32) for k in FcSim._fields})
    ekf = nested(d["ekf"])
    cl = str(d.get("machine", "ul")) == "cl"
    if cl:
        beh = nested(d["beh"])
        beh = BehaviorClState(**{k: torch.from_numpy(np.array(beh[k])).to(
            device) for k in BehaviorClState._fields})
    else:
        beh = behavior_state_from_numpy(d["beh"], device)
    return SimState(
        t_ms=int(d["t_ms"]), gen=gen, fc=fc, beh=beh,
        mapper=None if cl else mapping_state_from_numpy(d["mapper"], device),
        ekf=EkfState(ten(ekf["mean"], np.float32), ten(ekf["cov"], np.float32)),
        scan_count=int(d["scan_count"]), cam_valid=bool(d["cam_valid"]),
        **{k: ten(d[k], dt) for k, dt in _SIM_DTYPES.items()})


def sim_state_to_numpy(state: SimState) -> dict:
    """The port's SimState -> nested dict of numpy arrays with the JAX
    package's field names and layouts, every field but `key` (the port
    holds a torch generator there).  A state of the clean machine, which
    the JAX package's swarm does not fly, adds `machine` "cl" and has its
    BehaviorClState's fields under `beh` and no `mapper`."""
    cpu = lambda v: v.detach().cpu().numpy()                          # noqa: E731
    out = {k: cpu(getattr(state, k)) for k in _SIM_DTYPES}
    machine = ({"machine": "cl"} if state.mapper is None
               else {"mapper": mapping_state_to_numpy(state.mapper)})
    out.update(
        t_ms=np.int32(state.t_ms), scan_count=np.int32(state.scan_count),
        cam_valid=np.bool_(state.cam_valid),
        fc={k: cpu(v) for k, v in state.fc._asdict().items()},
        beh=behavior_state_to_numpy(state.beh), **machine,
        ekf={"mean": cpu(state.ekf.mean), "cov": cpu(state.ekf.cov)})
    return out


def _wrap(d):
    return torch.remainder(d + 180.0, 360.0) - 180.0


def scan_draws(gen: torch.Generator, batch: int):
    """One scan tick's (standard normal, uniform) draws [B, 4, 8, 8] on the
    CPU generator, in that order; advances gen."""
    shape = (batch, 4, 8, 8)
    return (torch.randn(shape, generator=gen),
            torch.rand(shape, generator=gen))


def fork_generator(gen: torch.Generator) -> torch.Generator:
    """A new CPU generator in gen's state: drawing on it leaves gen as it
    is, as a JAX key stays valid after a split."""
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


def sim_step(state: SimState, world: World, cfg: PipelineConfig = UL_PROFILE,
             geom: GridGeom = DEFAULT_GEOM, dt_ms: int = 20,
             scan_period_ms: int = 100, noise_mm: float = 5.0,
             dropout_p: float = 0.02, want_arm=True, record: bool = False,
             vision_flow: bool = False, flow_period_ms: int = 100,
             draws=None):
    """One closed-loop control tick for the whole swarm.  On a scan tick
    the ToF noise and dropout draws come from `draws` ((normal, uniform),
    each [B, 4, 8, 8], on any device) when given, else from a fork of
    state.gen that the new state carries on (scan_draws).
    With record=True the per-step diagnostics include the raw scan cells
    (zeros between scan ticks) so a run can be converted to
    reference-format scanlogs.  The input state is not modified.  Returns
    (state, diag); a clean machine's diag adds `locked`, its hover lock
    after the tick."""
    B = state.x.shape[0]
    if B != world.room.shape[0]:
        raise ValueError(
            f"batch mismatch: SimState has {B} quads but World has "
            f"{world.room.shape[0]} (sim_init(batch) and make_world(batch) "
            f"must use the same batch)")
    W = torch.where
    dev = state.x.device
    t = state.t_ms + dt_ms
    dt = _F32(dt_ms * 1e-3)
    fdt = float(dt)
    fc = state.fc
    mapper = state.mapper
    tof_min = state.tof_min
    cl = isinstance(state.beh, BehaviorClState)

    # ---- scan tick: synth ToF + map update from the EKF pose estimate
    # (self-localized mapping), a host decision ----
    scan_due = is_scan_tick(t, scan_period_ms)
    scan_cells = None
    gen = state.gen
    obs.count("sim.ticks")
    obs.count("sim.scan_ticks", int(scan_due))
    if cl:
        obs.count("sim.cl_ticks")
    if scan_due:
        with obs.span("sim.scan"):
            if draws is None:
                gen = fork_generator(gen)
                draws = scan_draws(gen, B)
            normal, uniform = draws
            scan_cells = synth_scan_mm(world, state.x, state.y, state.yaw,
                                       normal, uniform, noise_mm, dropout_p,
                                       cfg)
            beams, tof_min = extract_beams(scan_cells, cfg.tof)
            if not cl:
                grid = mapper.grid.clone()
                map_step(grid, beams, state.ekf.mean[..., 0],
                         state.ekf.mean[..., 1], state.yaw, mapper.origin_x,
                         mapper.origin_y, mapper.inited, cfg, geom)
                mapper = mapper._replace(grid=grid)

    # ---- flow: oracle sensor model, or pyramidal LK on rendered
    # downward-camera frames ----
    with obs.span("sim.flow"):
        yaw_rad = state.yaw * _DEG2RAD
        ground = torch.clamp(state.alt, min=0.0)
        airborne = state.alt > 0.05
        cam_prev, cam_valid = state.cam_prev, state.cam_valid
        vis_rx, vis_ry, vis_q = state.vis_rate_x, state.vis_rate_y, state.vis_q
        if vision_flow:
            from micro_quad_slam_tpu_torch.ops.flow import (
                flow_to_rates, lk_flow_batched)

            if flow_period_ms % dt_ms:
                raise ValueError("flow_period_ms must be a multiple of "
                                 "dt_ms (the rate conversion divides by "
                                 "the true inter-frame time)")
            if is_flow_tick(t, flow_period_ms):
                obs.count("sim.flow_frames", B)
                with obs.span("sim.flow.render"):
                    cur = _camera_frame(state.x, state.y, state.alt, yaw_rad)
                with obs.span("sim.flow.lk"):
                    res = lk_flow_batched(cam_prev, cur)
                    # camera x = body x at yaw 0 by construction of the
                    # renderer
                    rx, ry = flow_to_rates(res.dx_px, res.dy_px,
                                           _F32(flow_period_ms * 1e-3),
                                           CAM_FOCAL)
                    q = torch.clamp(res.quality, 0, 255).to(torch.int32)
                    nan = float("nan")
                    vis_rx = rx if cam_valid else torch.full_like(rx, nan)
                    vis_ry = ry if cam_valid else torch.full_like(ry, nan)
                    vis_q = q if cam_valid else torch.zeros_like(q)
                cam_prev, cam_valid = cur, True
            of_rate_x = W(airborne, vis_rx, float("nan"))
            of_rate_y = W(airborne, vis_ry, float("nan"))
            of_q = W(airborne, vis_q, 0).to(torch.int32)
        else:
            c, s = _cos_f32(yaw_rad), _sin_f32(yaw_rad)
            vbx = c * state.vx + s * state.vy
            vby = -s * state.vx + c * state.vy
            gnd = torch.clamp(ground, min=0.05)
            of_rate_x = W(ground > 0.05, vbx / gnd, float("nan"))
            of_rate_y = W(ground > 0.05, vby / gnd, float("nan"))
            if cl:
                of_q = torch.full((B,), FLOW_Q, dtype=torch.int32, device=dev)
            else:
                of_q = W(airborne, FLOW_Q, 0).to(torch.int32)
    with obs.span("sim.ekf"):
        ekf, _ = ekf_step(state.ekf, torch.full((B,), fdt, device=dev),
                          of_rate_x, of_rate_y, of_q, ground, yaw_rad,
                          cfg.ekf)
        # seed the EKF position while on the ground (perfect initial fix)
        on_gnd = ~airborne
        mean = ekf.mean.clone()
        mean[..., 0] = W(on_gnd, state.x, mean[..., 0])
        mean[..., 1] = W(on_gnd, state.y, mean[..., 1])
        ekf = EkfState(mean, ekf.cov)

    # ---- frontier queries from the mapper grid, refreshed on scan ticks
    # only: the grid only changes then ----
    fr = state.frontier
    if scan_due and not cl:
        with obs.span("sim.frontier"):
            fr = frontier_scores(mapper.grid, mean[..., 0], mean[..., 1],
                                 state.yaw, FRONTIER_OFFSETS,
                                 mapper.origin_x, mapper.origin_y,
                                 mapper.inited, cfg.map, geom)

    # ---- telemetry assembly (the FC/L1 interface) ----
    with obs.span("sim.fc"):
        bt = torch.full((B,), t, dtype=torch.int32, device=dev)
        yes = torch.ones((B,), dtype=torch.bool, device=dev)
        half_v = fc.batt_v * 0.5
        tm = {
            "t_ms": bt,
            "have_fc": yes,
            "fc_armed": fc.armed,
            "hb_custom_mode": fc.mode,
            "have_ext": yes,
            "landed_state": W(airborne, 2, 1).to(torch.int32),
            "have_sys": yes,
            "sys_last_ms": bt,
            "sys_health": torch.full((B,), HEALTH_ALL, dtype=torch.int32,
                                     device=dev),
            "have_servo": yes,
            "servo_last_ms": bt,
            "motor_avg": fc.motor,
            "batt_vpc": half_v,
            "batt_cells": torch.full((B,), 2, dtype=torch.int32, device=dev),
            "batt_last_ms": bt,
            # intake latch as handle_battery_status would set it for a 2-cell
            # reading (clean:1286-1294)
            "batt_valid": ((fc.batt_v >= 3.0) & (fc.batt_v <= 30.0)
                           & (half_v >= 2.5) & (half_v <= _f(4.8))),
            "have_lpos": yes,
            "lpos_last_ms": bt,
            "lpos_x": mean[..., 0],
            "lpos_y": mean[..., 1],
            "lpos_alt_filt": state.alt,
            "have_att": yes,
            "yaw_deg": state.yaw,
            "have_of": yes,
            "of_last_ms": bt,
            "of_q": of_q,
            "have_rf": yes if cl else airborne,
            "rf_last_ms": bt if cl else W(airborne, bt,
                                          torch.clamp(bt - 1000, min=0)),
            "rf_m": state.alt if cl else W(airborne, state.alt,
                                           float("nan")),
            "want_arm": torch.as_tensor(want_arm, device=dev).expand(B),
            "have_takeoff_ack": fc.have_ack,
            "takeoff_ack_res": fc.ack_res,
            "takeoff_ack_ms": fc.ack_ms,
            "takeoff_accept_ms": fc.accept_ms,
            "tof_min": tof_min,
        }
        if cl:
            tm["sys_enabled"] = tm["sys_health"]
        else:
            tm.update(map_inited=mapper.inited, frontier_f=fr[..., 0],
                      frontier_r=fr[..., 1], frontier_l=fr[..., 2],
                      frontier_b=fr[..., 3])

    # ---- behavior tick ----
    with obs.span("sim.behavior"):
        if cl:
            beh, out = behavior_step_cl(state.beh, tm, cfg)
        else:
            beh, out = behavior_step(state.beh, tm, cfg)

            # ---- map init on hover lock (uav_local_nav.c:2187-2194) ----
            minit = out["map_init"] & ~mapper.inited
            mapper = mapper._replace(
                origin_x=W(minit, out["map_origin_x"], mapper.origin_x),
                origin_y=W(minit, out["map_origin_y"], mapper.origin_y),
                inited=mapper.inited | minit,
            )

    with obs.span("sim.fc"):
        # ---- FC applies outputs ----
        fc = fc._replace(mode=W(out["req_mode"] >= 0, out["req_mode"],
                                fc.mode))
        fc = fc._replace(armed=W(out["req_arm"] == 1, True,
                                 W(out["req_arm"] == 0, False, fc.armed)))
        to_req = torch.isfinite(out["req_takeoff"])
        fc = fc._replace(
            have_ack=fc.have_ack | to_req,
            ack_res=W(to_req, 0, fc.ack_res),
            ack_ms=W(to_req, bt, fc.ack_ms),
            accept_ms=W(to_req, bt, fc.accept_ms),
            takeoff_active=fc.takeoff_active | to_req,
            takeoff_target=W(to_req, out["req_takeoff"], fc.takeoff_target),
        )
        clear = out["clear_takeoff_ack"]
        fc = fc._replace(
            have_ack=W(clear, False, fc.have_ack),
            ack_ms=W(clear, 0, fc.ack_ms),
            accept_ms=W(clear, 0, fc.accept_ms),
        )
        kind = out["cmd_kind"]
        cmd = out["cmd"]
        body = kind == CMD_VEL_BODY
        pos = kind == CMD_POS_YAW
        fc = fc._replace(
            vset_bx=W(body, cmd[..., 0], 0.0),
            vset_by=W(body, cmd[..., 1], 0.0),
            yaw_rate_cmd=W(body, cmd[..., 3], 0.0),
            climb_cmd=W(kind == CMD_VEL_NED, -cmd[..., 2], 0.0),
            pos_hold=pos,
            pos_cmd=W(pos[..., None], cmd[..., :3], fc.pos_cmd),
            pos_cmd_yaw=W(pos, cmd[..., 3], fc.pos_cmd_yaw),
        )
        if cl:
            # Z+yaw: an altitude hold at the commanded z (NED, down)
            fc = fc._replace(climb_cmd=W(
                kind == CMD_Z_YAW,
                torch.clamp((-cmd[..., 0]) - state.alt, _f(-0.3), _f(0.3)),
                fc.climb_cmd))

        # ---- dynamics ----
        spool = fc.armed & (fc.takeoff_active | airborne)
        spun = torch.clamp(fc.motor + float(_F32(900.0) * dt), max=1600.0)
        motor = W(fc.armed, W(spool, spun, fc.motor), 1000.0)
        lifted = fc.armed & (motor > 1150.0)

        # vertical
        climb = torch.zeros((B,), device=dev)
        climb = W(fc.takeoff_active & (state.alt < fc.takeoff_target),
                  _f(0.45), climb)
        climb = W(fc.mode == MODE_LAND, _f(-0.35), climb)
        climb = W(fc.climb_cmd != 0, fc.climb_cmd, climb)
        climb = W(fc.pos_hold, torch.clamp((-fc.pos_cmd[..., 2]) - state.alt,
                                           _f(-0.3), _f(0.3)), climb)
        alt = W(lifted, torch.clamp(state.alt + climb * fdt, min=0.0),
                torch.clamp(state.alt - fdt, min=0.0))
        fc = fc._replace(takeoff_active=fc.takeoff_active
                         & ~(alt >= fc.takeoff_target), motor=motor)

        # horizontal: body velocity setpoint or position P-control
        c, s = _cos_f32(yaw_rad), _sin_f32(yaw_rad)
        vwx_set = c * fc.vset_bx - s * fc.vset_by
        vwy_set = s * fc.vset_bx + c * fc.vset_by
        px = torch.clamp(fc.pos_cmd[..., 0] - mean[..., 0], _f(-0.5), _f(0.5))
        py = torch.clamp(fc.pos_cmd[..., 1] - mean[..., 1], _f(-0.5), _f(0.5))
        vwx_set = W(fc.pos_hold, px, vwx_set)
        vwy_set = W(fc.pos_hold, py, vwy_set)
        act = lifted & airborne
        gain = float(min(dt / _F32(0.4), _F32(1.0)))
        vx = W(act, state.vx + (vwx_set - state.vx) * gain, 0.0)
        vy = W(act, state.vy + (vwy_set - state.vy) * gain, 0.0)
        x = state.x + vx * fdt
        y = state.y + vy * fdt
        # stay inside the room (walls are solid)
        margin = _f(0.15)
        x = torch.clamp(x, world.room[..., 0] + margin,
                        world.room[..., 2] - margin)
        y = torch.clamp(y, world.room[..., 1] + margin,
                        world.room[..., 3] - margin)
        yaw = _wrap(state.yaw + W(act, fc.yaw_rate_cmd, 0.0) * fdt)

    new_state = SimState(
        t_ms=t, gen=gen, x=x, y=y, yaw=yaw, vx=vx, vy=vy,
        alt=alt, fc=fc, beh=beh, mapper=mapper, ekf=ekf, tof_min=tof_min,
        scan_count=state.scan_count + int(scan_due),
        cam_prev=cam_prev, cam_valid=cam_valid, vis_rate_x=vis_rx,
        vis_rate_y=vis_ry, vis_q=vis_q, frontier=fr,
    )
    diag = {
        "state": out["state"],
        "alt": alt,
        "pose_err": torch.hypot(mean[..., 0] - x, mean[..., 1] - y),
    }
    if cl:
        diag["locked"] = beh.hv_locked
    if record:
        # everything a scanrec needs (uav_local_nav.c:1549-1581), sampled
        # at this tick; the host-side conversion keeps the scan ticks
        if scan_cells is None:
            scan_cells = torch.zeros((B, 4, 8, 8), dtype=torch.int32,
                                     device=dev)
        diag.update({
            "scan_due": torch.full((B,), scan_due, dtype=torch.bool,
                                   device=dev),
            "t_ms": bt,
            "cells": scan_cells,
            "est_x": mean[..., 0],
            "est_y": mean[..., 1],
            "yaw": yaw,
            "alt_est": out["alt_est"],
            "rf": W(airborne, alt, float("nan")),
            "of_rate_x": of_rate_x,
            "of_rate_y": of_rate_y,
            "of_q": of_q,
            "kf_flags": out["kf_flags"],
            "cmd_kind": out["cmd_kind"],
            "cmd": out["cmd"],
            "req_mode": out["req_mode"],
            "req_arm": out["req_arm"],
            "req_takeoff": out["req_takeoff"],
            "rc_release": out["rc_release"],
        })
    return new_state, diag


def is_scan_tick(t_ms: int, scan_period_ms: int) -> bool:
    """Whether the tick that ends at t_ms takes a ToF scan (and its
    draws)."""
    return t_ms % scan_period_ms == 0


def is_flow_tick(t_ms: int, flow_period_ms: int) -> bool:
    """Whether the tick that ends at t_ms takes a vision-flow frame."""
    return t_ms % flow_period_ms == 0


def scan_tick_count(t_ms: int, n_steps: int, dt_ms: int,
                    scan_period_ms: int) -> int:
    """The scan ticks of a run of n_steps ticks from t_ms: the draws
    sim_run takes."""
    return sum(is_scan_tick(t_ms + k * dt_ms, scan_period_ms)
               for k in range(1, n_steps + 1))


def sim_run(state: SimState, world: World, n_steps: int,
            cfg: PipelineConfig = UL_PROFILE, geom: GridGeom = DEFAULT_GEOM,
            dt_ms: int = 20, scan_period_ms: int = 100,
            record: bool = False, vision_flow: bool = False, draws=None,
            noise_mm: float = 5.0, dropout_p: float = 0.02,
            flow_period_ms: int = 100):
    """Run n_steps closed-loop ticks; returns the final state and the
    diagnostics stacked over the steps ([T, B, ...] tensors; with raw
    scans when record=True).  draws, when given, holds one (normal,
    uniform) pair per scan tick of the run, in order (see sim_step);
    otherwise the state's generator draws them.  vision_flow replaces the
    oracle flow sensor with pyramidal LK on rendered downward-camera
    frames, one every flow_period_ms.  noise_mm and dropout_p are the ToF
    model's (sim_step)."""
    with obs.span("sim", state.x.device):
        diags = []
        flow_q = []         # the vision flow's qualities, frame by frame
        k = 0
        for _ in range(n_steps):
            due = is_scan_tick(state.t_ms + dt_ms, scan_period_ms)
            d = draws[k] if (due and draws is not None) else None
            k += int(due)
            flows = vision_flow and is_flow_tick(state.t_ms + dt_ms,
                                                 flow_period_ms)
            state, diag = sim_step(state, world, cfg, geom, dt_ms,
                                   scan_period_ms, noise_mm, dropout_p,
                                   record=record, vision_flow=vision_flow,
                                   flow_period_ms=flow_period_ms, draws=d)
            diags.append(diag)
            if flows:
                flow_q.append(state.vis_q)
        if not diags:
            return state, {}
        diag = {key: torch.stack([dg[key] for dg in diags])
                for key in diags[0]}
        if "locked" in diag:
            obs.count("sim.cl_locked", lambda: diag["locked"])
        else:
            obs.count("sim.turning", lambda: diag["state"] == ST_TURNING)
        if flow_q:
            obs.count("sim.flow_low_q", lambda: torch.stack(flow_q)
                      < cfg.gates.of_min_quality)
    return state, diag


def select_lanes(tree, lanes):
    """The quads `lanes` (a list or index tensor) of a SimState or World:
    every tensor's leading dimension indexed, host fields and the
    generator kept.  Quads are independent, so a run of some lanes, with
    those lanes of the draws, gives those lanes of the whole run."""
    if torch.is_tensor(tree):
        return tree[torch.as_tensor(lanes, device=tree.device)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(select_lanes(f, lanes) for f in tree))
    return tree


def sim_diag_to_mavlink(diag: dict, quad: int = 0, tgt_sys: int = 1,
                        tgt_comp: int = 1) -> bytes:
    """Render one quad's recorded command outputs (a sim_run(record=True)
    diag of [T, B, ...] tensors or numpy arrays) as the MAVLink byte stream
    the reference would have written to its FC UART (heartbeat at 1 Hz like
    send_own_heartbeat_tick, uav_local_nav.c:682); the same bytes as the
    JAX package's sim_diag_to_mavlink on the same diag."""
    from micro_quad_slam_tpu_torch.formats.mavlink import (
        MavEncoder, encode_command_stream)

    keys = ("t_ms", "req_mode", "req_arm", "req_takeoff", "cmd_kind", "cmd",
            "rc_release")
    host = {k: (diag[k].detach().cpu().numpy() if torch.is_tensor(diag[k])
                else np.asarray(diag[k]))[:, quad] for k in keys}
    enc = MavEncoder()
    buf = b""
    last_hb = -10 ** 9
    for k in range(host["t_ms"].shape[0]):
        t = int(host["t_ms"][k])
        hb_due = t - last_hb >= 1000
        if hb_due:
            last_hb = t
        out = {
            "req_mode": int(host["req_mode"][k]),
            "req_arm": int(host["req_arm"][k]),
            "req_takeoff": float(host["req_takeoff"][k]),
            "cmd_kind": int(host["cmd_kind"][k]),
            "cmd": host["cmd"][k],
            "rc_release": bool(host["rc_release"][k]),
        }
        buf += encode_command_stream(enc, t, out, tgt_sys, tgt_comp, hb_due)
    return buf


def sim_diag_to_scanlogs(diag: dict) -> list:
    """Convert a recorded sim run's diagnostics (tensors or numpy arrays of
    [T, B, ...]) to one reference-format ScanLog per quad (the sim twin of
    the reference's scanlog writer, uav_local_nav.c:1549-1581).  Keyframe
    flags accumulated between scans are drained into the next record, like
    the reference."""
    from micro_quad_slam_tpu_torch.formats.scanlog import ScanLog

    host = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in diag.items()}
    scan_due = host["scan_due"]                      # [T, B]
    T, B = scan_due.shape
    logs = []
    for b in range(B):
        idx = np.nonzero(scan_due[:, b])[0]
        n = len(idx)

        def g(key, dtype, i=idx, b=b):
            return np.ascontiguousarray(host[key][i, b].astype(dtype))

        # drain kf flags: OR of flags since the previous scan tick
        kf_all = host["kf_flags"][:, b]
        kf = np.zeros(n, np.uint8)
        prev = 0
        prev_flags = 0
        for k, i in enumerate(idx):
            acc = 0
            for j in range(prev, i + 1):
                acc |= int(kf_all[j])
            kf[k] = acc & ~prev_flags
            prev_flags = acc
            prev = i + 1
        t_ms = g("t_ms", np.uint32)
        logs.append(ScanLog(
            host_ms=t_ms, scan_ms=t_ms.copy(),
            x_m=g("est_x", np.float32), y_m=g("est_y", np.float32),
            yaw_deg=g("yaw", np.float32), alt_m=g("alt_est", np.float32),
            roll_rad=np.zeros(n, np.float32),
            pitch_rad=np.zeros(n, np.float32),
            rf_m=g("rf", np.float32),
            of_rate_x=g("of_rate_x", np.float32),
            of_rate_y=g("of_rate_y", np.float32),
            of_q=g("of_q", np.uint8), state=g("state", np.uint8),
            kf_flags=kf, sys_health=np.zeros(n, np.uint32),
            grid_mm=host["cells"][idx, b].astype(np.uint16),
        ))
    return logs
