"""The exact whole-replay path: a grid-free schedule in torch, then one
hand-written Hopper kernel that applies it to every quad's grid
(counterpart of micro_quad_slam_tpu/ops/pallas_residentx.py and of the
"exact2" part of pallas_resident.py::_schedule).

Everything except the grid depends only on the logged frames: origins,
the recenter schedule, the ray endpoints and the enable gates.  So
`schedule` runs the sequential [B]-wide carry over T (`carry`: ToF
filter, map init, recenter decision, origin shift; ops/conex.py shares
it) and then makes every ray of every (quad, frame) at once.  It packs
them into one int32 tensor [B, T, WORDS]:

    word  0..7    header: pose row, pose col (padded-grid cells), do,
                  recenter rows sy, recenter cols sx, any-valid-ray, 0, 0
    word  8+4r..  ray r (reference order F0..F7, R0..R7, B0..B7, L0..L7):
                  ex, ey (endpoint relative to the pose cell), end_delta,
                  valid

`replay_exact` applies a schedule to the grids in place: on a CUDA tensor
it launches csrc/replay_exact.cu, on a CPU tensor it runs the plain
version (`replay_exact_plain`, the same frame loop in torch ops), and on
any other device it raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from micro_quad_slam_tpu_torch.utils.config import PipelineConfig
from micro_quad_slam_tpu_torch.ops import _build
from micro_quad_slam_tpu_torch.ops.beams import extract_beams, tof_filter_update
from micro_quad_slam_tpu_torch.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    apply_rays_,
    make_rays,
    recenter_apply,
)

HDR = 8
H_PCY, H_PCX, H_DO, H_RSY, H_RSX, H_ANY = range(6)
RAY_WORDS = 4
WORDS = HDR + 32 * RAY_WORDS


def check_supported(cfg: PipelineConfig, geom: GridGeom) -> None:
    """Raise ValueError for a MapConfig / GridGeom the replay kernels
    (replay_exact, replay_cone) do not take, instead of corrupting grids
    silently."""
    m = cfg.map
    bad = []
    if not -128 <= m.lo_min <= 0 <= m.lo_max <= 127:
        bad.append(f"lo_min={m.lo_min}, lo_max={m.lo_max} must satisfy "
                   f"-128 <= lo_min <= 0 <= lo_max <= 127 (int8 grid "
                   f"starting at 0)")
    for name in ("lo_free_dec", "lo_occ_inc", "lo_miss_end_dec"):
        v = getattr(m, name)
        if not 0 <= v <= 127:
            bad.append(f"{name}={v} must lie in [0, 127] (an int8 "
                       f"per-ray delta)")
    if (geom.width, geom.height) != (m.width, m.height):
        bad.append(f"geometry {geom.width}x{geom.height} does not match "
                   f"the map's {m.width}x{m.height}")
    reach = math.ceil(cfg.tof.max_range_m / m.res_m) + 1
    if reach > geom.win_r:
        bad.append(f"rays reach {reach} cells but the window radius is "
                   f"{geom.win_r}")
    if (geom.pad < geom.win_r
            or geom.pad + m.height - 1 - geom.win_r + geom.win_rows > geom.prows
            or geom.pad + m.width - 1 - geom.win_r + geom.win_cols > geom.pcols):
        bad.append("the scan window does not fit the padded grid")
    if geom.pcols % 16:
        bad.append(f"pcols={geom.pcols} must be a multiple of 16")
    if bad:
        raise ValueError("replay kernels: unsupported configuration: "
                         + "; ".join(bad))


def carry(frames: dict, cfg: PipelineConfig, state0=None):
    """The sequential part of a whole replay, shared by every schedule
    (the exact one here, the cone and hybrid one in ops/conex.py): the
    ToF filter, map init, recenter decision and origin shift, carried
    over T for the whole [B] batch, then the enable gates.

    Returns (beams f32 [B, T, 4, 8], seq {ox, oy, sx, sy, do, enabled}
    of [B, T], outs {used, kf_flags, filt} [B, T, ...], final (origin_x,
    origin_y, inited, filt))."""
    from micro_quad_slam_tpu_torch.replay.mapping import (
        init_and_recenter, kf_flags_of, pose_good_for_mapping)

    x, y = frames["x_m"], frames["y_m"]
    B, T = x.shape
    dev = x.device
    beams, minima = extract_beams(frames["grid_mm"], cfg.tof)
    if state0 is not None:
        c = (state0.origin_x, state0.origin_y, state0.inited, state0.filt)
        c = tuple(v.to(dev) for v in c)
    else:
        nan = torch.full((B,), math.nan, dtype=torch.float32, device=dev)
        c = (nan, nan, torch.zeros((B,), dtype=torch.bool, device=dev),
             torch.full((B, 4), math.nan, dtype=torch.float32, device=dev))

    # the sequential carry: [B]-wide, T steps
    ox, oy, inited, filt = c
    seq = {k: [] for k in ("ox", "oy", "inited", "sx", "sy", "do", "filt")}
    for t in range(T):
        filt = tof_filter_update(filt, minima[:, t], cfg.tof.filt_alpha)
        ox, oy, inited, sx, sy, do = init_and_recenter(
            ox, oy, inited, x[:, t], y[:, t], frames["state"][:, t], cfg)
        for k, v in zip(seq, (ox, oy, inited, sx, sy, do, filt)):
            seq[k].append(v)
    final = (ox, oy, inited, filt)
    so = {k: torch.stack(v, dim=1) for k, v in seq.items()}
    so["enabled"] = so.pop("inited") & pose_good_for_mapping(
        x, frames["yaw_deg"], frames["of_q"].to(torch.int32),
        frames["of_rate_x"], frames["sys_health"], cfg.gates.of_min_quality)
    outs = {"used": so["enabled"], "kf_flags": kf_flags_of(so["do"]),
            "filt": so.pop("filt")}
    return beams, so, outs, final


def schedule(frames: dict, cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM,
             state0=None):
    """Grid-free replay of frames [B, T, ...]: reproduces mapping_step's
    filter / init / recenter / enable sequence (`carry`) and makes every
    ray.

    Returns (sched int32 [B, T, WORDS], outs {used, kf_flags, filt}
    [B, T, ...], final (origin_x, origin_y, inited, filt))."""
    beams, so, outs, final = carry(frames, cfg, state0)
    x, y = frames["x_m"], frames["y_m"]
    B, T = x.shape
    # everything below is carry-free: vectorized over [B, T]
    rays = make_rays(beams, x, y, frames["yaw_deg"], so["ox"], so["oy"],
                     so["enabled"], cfg.map, cfg.tof)
    valid = rays["valid"]
    zero = torch.zeros_like(rays["pcx"])
    header = torch.stack([
        rays["pcy"] + geom.pad, rays["pcx"] + geom.pad,
        so["do"].to(torch.int32), so["sy"], so["sx"],
        valid.any(dim=-1).to(torch.int32), zero, zero], dim=-1)
    ray_words = torch.stack([rays["ex"], rays["ey"], rays["end_delta"],
                             valid.to(torch.int32)], dim=-1)
    sched = torch.cat([header, ray_words.reshape(B, T, 32 * RAY_WORDS)],
                      dim=-1).contiguous()
    return sched, outs, final


def _frame_rays(w: torch.Tensor, geom: GridGeom) -> dict:
    """One frame's schedule words [B, WORDS] -> make_rays' dict."""
    r = w[:, HDR:].reshape(-1, 32, RAY_WORDS)
    return {"ex": r[..., 0], "ey": r[..., 1], "end_delta": r[..., 2],
            "valid": r[..., 3] != 0,
            "pcx": w[:, H_PCX] - geom.pad, "pcy": w[:, H_PCY] - geom.pad}


def replay_exact_plain(grids: torch.Tensor, sched: torch.Tensor,
                       cfg: PipelineConfig,
                       geom: GridGeom = DEFAULT_GEOM) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: per frame, the
    recenter (recenter_apply) then the window update (window_scan_update)
    for the whole [B] batch.  Updates grids in place and returns them."""
    T = sched.shape[1]
    do_any = sched[..., H_DO].any(dim=0).tolist()      # one host sync
    live = sched[..., H_ANY].any(dim=0).tolist()
    for t in range(T):
        w = sched[:, t]
        if do_any[t]:
            grids.copy_(recenter_apply(grids, w[:, H_RSX], w[:, H_RSY],
                                       cfg.map, geom))
        if live[t]:
            apply_rays_(grids, _frame_rays(w, geom), cfg.map, geom)
    return grids


def check_operands(grids: torch.Tensor, sched: torch.Tensor,
                   geom: GridGeom, words: int = WORDS) -> None:
    """Raise on grids / schedule a replay kernel does not take."""
    if grids.dtype != torch.int8 or sched.dtype != torch.int32:
        raise TypeError(f"grids must be int8 and sched int32, got "
                        f"{grids.dtype} and {sched.dtype}")
    if grids.device != sched.device:
        raise ValueError(f"grids on {grids.device} but sched on "
                         f"{sched.device}")
    B = grids.shape[0]
    if tuple(grids.shape) != (B, geom.prows, geom.pcols) or \
            sched.dim() != 3 or tuple(sched.shape[::2]) != (B, words):
        raise ValueError(f"shapes: grids {tuple(grids.shape)} and sched "
                         f"{tuple(sched.shape)} do not fit [B, {geom.prows}, "
                         f"{geom.pcols}] and [B, T, {words}]")
    if not (grids.is_contiguous() and sched.is_contiguous()):
        raise ValueError("grids and sched must be contiguous")


def replay_exact(grids: torch.Tensor, sched: torch.Tensor,
                 cfg: PipelineConfig,
                 geom: GridGeom = DEFAULT_GEOM) -> torch.Tensor:
    """Apply a schedule to grids int8 [B, PR, PC] in place and return
    them.  A CUDA tensor goes to the Hopper kernel (csrc/replay_exact.cu);
    a CPU tensor to replay_exact_plain; any other device raises.
    `replay_exact.launches` counts the kernel launches."""
    check_supported(cfg, geom)
    check_operands(grids, sched, geom)
    if grids.device.type == "cpu":
        return replay_exact_plain(grids, sched, cfg, geom)
    if grids.device.type != "cuda":
        raise ValueError(f"no exact replay kernel for device {grids.device}")
    B, T = sched.shape[:2]
    if B == 0 or T == 0:
        return grids
    fn = _build.load_library("replay_exact").mqs_replay_exact
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # recenter staging, one grid per quad; most replays never recenter
    # (the kernel reads it only on a recentering frame), so it costs a
    # host sync to spare another copy of the grids
    scratch = (torch.empty_like(grids) if bool(sched[..., H_DO].any())
               else None)
    m = cfg.map
    with torch.cuda.device(grids.device):
        stream = torch.cuda.current_stream(grids.device).cuda_stream
        err = fn(
            grids.data_ptr(), sched.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, T, WORDS, geom.prows, geom.pcols, geom.pad, geom.width,
            geom.height, m.lo_min, m.lo_max, m.lo_free_dec, stream)
    if err != 0:
        raise RuntimeError(f"replay_exact kernel launch failed: CUDA error "
                           f"{err}")
    replay_exact.launches += 1
    return grids


replay_exact.launches = 0


def replay_residentx(frames: dict, cfg: PipelineConfig,
                     geom: GridGeom = DEFAULT_GEOM, state0=None):
    """Whole exact replay: frames dict of [B, T, ...] tensors (one
    device).  Returns (MappingState [B], outs [B, T]), bit-identical to
    the per-frame replay and the golden C model, recenters and resume
    included.  state0 resumes a prior replay's MappingState."""
    from micro_quad_slam_tpu_torch.replay.mapping import (
        MappingState, check_replay_inputs)

    check_replay_inputs(frames, state0)
    dev = frames["x_m"].device
    B = frames["x_m"].shape[0]
    sched, outs, (ox, oy, inited, filt) = schedule(frames, cfg, geom, state0)
    if state0 is not None:
        grids = state0.grid.to(dev).clone(memory_format=torch.contiguous_format)
    else:
        grids = torch.zeros((B, geom.prows, geom.pcols), dtype=torch.int8,
                            device=dev)
    replay_exact(grids, sched, cfg, geom)
    return MappingState(grids, ox, oy, inited, filt), outs
