"""Full SLAM replay in PyTorch (counterpart of
micro_quad_slam_tpu/slam/pipeline.py): EKF odometry, correlative scan
matching, an SE(2) pose graph with loop closures, and the re-raster of the
map from the corrected track, for a [B] batch of flights.

  pass 0  EKF odometry and the grid's origin/recenter schedule in one
          [B]-wide loop over T (the fusion replay with a hook).
  pass 1  the feedback-free match map (the default): the keyframe scans
          land on each flight's grid at fixed pose estimates through one
          launch of the exact kernel's snapshot entry, which also copies
          every keyframe chunk's start-of-chunk map slab; every keyframe
          then matches its slab in one flat batch (one lattice-kernel
          launch).  SlamConfig.match_iters rounds of (rebuild, re-match).
          With SlamConfig.match_feedback (or match_map_kf_only=False) the
          matches land on the map instead: chunk by chunk, a chunk's
          keyframes match the chunk-start grid (one lattice-kernel launch)
          and its scans land at the matched poses (one launch of the exact
          kernel).
  loop    proximity-gated keyframe-to-keyframe revisit matches against
          endpoint fields rastered from each candidate's scan alone, all
          in one lattice-kernel launch; the best by quality become edges.
  GN      odometry edges + match anchors + loop edges, batched dense
          Gauss-Newton with Huber IRLS on the loop edges.
  pass 3  the re-raster of every frame from the corrected track, one
          launch of the exact kernel.

This follows the JAX package's kernel branch (the one its tests hold
bit-equal to its XLA branch); the device of the tensors picks the kernel
(CUDA) or its plain version (CPU).  SlamConfig.slam_outer global rounds
rebuild the match map at the solved track.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.ops.beams import extract_beams
from micro_quad_slam_tpu_torch.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    _f,
    div_f32,
    make_rays,
    recenter_apply,
    recenter_decide,
    shift_origin,
    sqrt_f32,
    world_to_cell,
)
from micro_quad_slam_tpu_torch.ops.residentx import (
    _snap_align,
    map_chunk_sched,
    map_snap,
)
from micro_quad_slam_tpu_torch.ops.scanmatch import (
    match_slabs,
    match_window,
    window_origin,
)
from micro_quad_slam_tpu_torch.replay.fusion import (
    DEG2RAD,
    RAD2DEG,
    _ekf_replay_batched,
)
from micro_quad_slam_tpu_torch.slam.posegraph import (
    add_edges,
    chain_odometry_graph,
    gauss_newton,
    se2_compose,
    se2_relative,
)
from micro_quad_slam_tpu_torch.utils.config import PipelineConfig, UL_PROFILE

_F32 = np.float32


class SlamResult(NamedTuple):
    grid: torch.Tensor       # drift-corrected map int8 [B, prows, pcols]
    track: torch.Tensor      # corrected poses [B, T, 3] (rad)
    odo_track: torch.Tensor  # raw EKF odometry [B, T, 3]
    kf_idx: torch.Tensor     # keyframe frame indices [K]
    kf_nodes: torch.Tensor   # optimized keyframe poses [B, K, 3]
    gn_costs: torch.Tensor   # GN cost per iteration [B, iters]
    origin: tuple            # final (origin_x [B], origin_y [B])


def _ekf_track(frames, cfg):
    """EKF odometry [B, T, 3]: x, y from the fusion filter, theta from the
    logged attitude (the fusion replay's track, bit for bit)."""
    _, track = _ekf_replay_batched(frames, cfg)
    return torch.stack([track["x"], track["y"],
                        frames["yaw_deg"] * DEG2RAD], dim=-1)


def _odo_and_schedule(frames, cfg, origin0=None):
    """EKF odometry and the origin/recenter schedule in one loop over T
    (the fusion replay's, through its extra hook).  Returns (odo
    [B, T, 3], sched {ox, oy, do, rsy, rsx} of [B, T]); equal to
    _ekf_track + _origin_schedule."""
    if not cfg.slam.recenter:
        odo = _ekf_track(frames, cfg)
        return odo, _origin_schedule(odo, cfg, origin0)
    B = frames["x_m"].shape[0]
    res = _F32(cfg.map.res_m)
    if origin0 is None:
        nan = torch.full((B,), float("nan"), dtype=torch.float32,
                         device=frames["x_m"].device)
        origin0 = (nan, nan)

    def sched_step(carry, mean, _frame):
        ox, oy = carry
        x, y = mean[..., 0], mean[..., 1]
        # the first step adopts the first posterior as the origin
        ox = torch.where(torch.isnan(ox), x, ox)
        oy = torch.where(torch.isnan(oy), y, oy)
        ok = torch.isfinite(x) & torch.isfinite(y)
        sx, sy, do = recenter_decide(ox, oy, x, y, ok, cfg.map)
        ox, oy = shift_origin(ox, sx, res), shift_origin(oy, sy, res)
        return (ox, oy), {"ox": ox, "oy": oy, "do": do.to(torch.int32),
                          "rsy": sy, "rsx": sx}

    _, track = _ekf_replay_batched(frames, cfg, extra=(origin0, sched_step))
    odo = torch.stack([track["x"], track["y"], frames["yaw_deg"] * DEG2RAD],
                      dim=-1)
    return odo, {k: track[k] for k in ("ox", "oy", "do", "rsy", "rsx")}


def _origin_schedule(odo, cfg, origin0=None):
    """Grid-free recenter schedule of a pose track odo [B, T, 3]: the
    mapping replay's decide/shift sequence (uav_local_nav.c:324-343).
    Returns {ox, oy (the origin after frame t's recenter), do, rsy, rsx}
    of [B, T]."""
    B, T = odo.shape[:2]
    ox, oy = (odo[:, 0, 0], odo[:, 0, 1]) if origin0 is None else origin0
    if not cfg.slam.recenter:
        z = torch.zeros((B, T), dtype=torch.int32, device=odo.device)
        return {"ox": ox[:, None].expand(B, T), "oy": oy[:, None].expand(B, T),
                "do": z, "rsy": z, "rsx": z}
    res = _F32(cfg.map.res_m)
    out = {k: [] for k in ("ox", "oy", "do", "rsy", "rsx")}
    for t in range(T):
        x, y = odo[:, t, 0], odo[:, t, 1]
        ok = torch.isfinite(x) & torch.isfinite(y)
        sx, sy, do = recenter_decide(ox, oy, x, y, ok, cfg.map)
        ox, oy = shift_origin(ox, sx, res), shift_origin(oy, sy, res)
        for k, v in zip(out, (ox, oy, do.to(torch.int32), sy, sx)):
            out[k].append(v)
    return {k: torch.stack(v, dim=1) for k, v in out.items()}


def _recenter_grids(grids, do, rsy, rsx, cfg, geom):
    """Apply per-flight recenters to a [B] grid batch (only where do != 0;
    nothing runs when no flight recenters)."""
    do = do != 0
    if not bool(do.any()):
        return grids
    moved = recenter_apply(grids, rsx, rsy, cfg.map, geom)
    return torch.where(do[:, None, None], moved, grids)


def _compose_kf_sched(sch, B: int, nc: int, kf_every: int, n_kf: int):
    """The per-frame recenter schedule composed over keyframe intervals:
    slot j covers frames (T_{j-1}, T_j], so rolling once per slot reaches
    the grid that rolling every frame does (zero-fill shifts compose).
    Returns (comp {rsy, rsx, do} [B, K_p], tail {..} [B]: the remainder
    after the last keyframe)."""
    K_p = nc * n_kf
    comp, tail = {}, {}
    for k in ("rsy", "rsx", "do"):
        a = sch[k]
        seg = torch.nn.functional.pad(a[:, 1:], (0, 1)).reshape(
            B, K_p, kf_every).sum(-1)
        comp[k] = torch.cat([a[:, :1], seg[:, :-1]], dim=1).to(torch.int32)
        tail[k] = seg[:, -1].to(torch.int32)
    comp["do"] = (comp["do"] != 0).to(torch.int32)
    tail["do"] = (tail["do"] != 0).to(torch.int32)
    return comp, tail


def _pad_t(a, padn: int, value):
    """Pad [B, T, ...] with padn frames of `value` at the end of T."""
    if not padn:
        return a
    pad = torch.full((a.shape[0], padn) + a.shape[2:], value, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=1)


def _pad_chunk_inputs(beams, sched, B: int, T: int, C: int, nc: int):
    """Pad [B, T] chunk-pass inputs to nc*C frames with inert frames: NaN
    beams make every ray invalid; padded origins repeat the last frame's
    so the rays stay finite."""
    padn = nc * C - T
    sch = {k: _pad_t(v, padn, 0) for k, v in sched.items()}
    for k in ("ox", "oy"):
        sch[k] = torch.cat([sched[k], sched[k][:, -1:].expand(B, padn)], 1)
    return _pad_t(beams, padn, float("nan")), sch


class _Slots(NamedTuple):
    """Pass 1's keyframe slots, the same in every round: every kf_every-th
    frame of the track padded to nc chunks of C frames, n_kf slots (K_p =
    nc * n_kf in all) per chunk."""
    C: int
    nc: int
    n_kf: int
    beams: torch.Tensor      # the slots' scans [B, K_p, 4, 8]
    ox: torch.Tensor         # their origins [B, K_p]
    oy: torch.Tensor
    sox: torch.Tensor        # their chunk-start origins [B, K_p]
    soy: torch.Tensor
    comp: dict               # _compose_kf_sched: per slot, and the tail
    tail: dict


def _kf_slots(beams, sched, kf_every: int, cfg) -> _Slots:
    """The slots of beams [B, T, 4, 8] and the recenter schedule sched."""
    B, T = sched["ox"].shape
    C = kf_every * max(int(cfg.slam.match_chunk_intervals), 1)
    nc = -(-T // C)
    beams_p, sch = _pad_chunk_inputs(beams, sched, B, T, C, nc)
    n_kf = len(range(0, C, kf_every))
    comp, tail = _compose_kf_sched(sch, B, nc, kf_every, n_kf)
    ox, oy = sch["ox"][:, ::kf_every], sch["oy"][:, ::kf_every]
    # every slot of a chunk matches the chunk-start snapshot, so its cells
    # are looked up in the chunk-start origin's frame
    sox = ox[:, ::n_kf].repeat_interleave(n_kf, dim=1)
    soy = oy[:, ::n_kf].repeat_interleave(n_kf, dim=1)
    return _Slots(C, nc, n_kf, beams_p[:, ::kf_every], ox, oy, sox, soy,
                  comp, tail)


def _round_operands(sl: _Slots, est, kf_every: int, cfg, geom):
    """A pass-1 round's operands at the pose estimates est [B, T, 3]:
    (map_snap's from beams to wx0 [B, K_p], match_slabs' from r0s to
    origin_y, flat over B * K_p).  Each slot's match window is centred on
    its pose in the chunk-start origin's frame."""
    kf_pose = _pad_t(est, sl.nc * sl.C - est.shape[1], 0.0)[:, ::kf_every]
    x, y, yaw = kf_pose[..., 0], kf_pose[..., 1], kf_pose[..., 2] * RAD2DEG
    pcx, pcy = world_to_cell(x, y, sl.sox, sl.soy, cfg.map.res_m,
                             cfg.map.width // 2, cfg.map.height // 2)
    wy0, wx0 = window_origin(pcx, pcy, geom)
    snap = [sl.beams, x, y, yaw, sl.ox, sl.oy, sl.comp["do"], sl.comp["rsy"],
            sl.comp["rsx"], wy0, wx0]
    match = [a.reshape((-1,) + a.shape[2:])
             for a in (*_snap_align(wy0, wx0, geom), sl.beams, x, y, yaw,
                       sl.sox, sl.soy)]
    return snap, match


def _map_pass_nofb(beams, poses, cfg, geom, kf_every: int, sched,
                   grid0=None, n_iters: int | None = None):
    """Feedback-free pass 1 (SlamConfig.match_feedback=False): within a
    round the match map takes the keyframe scans at fixed pose estimates
    (round 1: odometry; later rounds: the previous round's matches).  One
    launch of the exact kernel's snapshot entry (ops/residentx.map_snap)
    builds the map over all keyframe slots and copies the chunk-start slab
    around every slot's match window; one lattice-kernel launch matches
    every keyframe against its slab.  Snapshot slabs hold every in-grid
    candidate cell, so slab scoring equals matching against the whole
    chunk-start grid.  Returns (final grids, matched poses [B, T, 3])."""
    B, T = poses.shape[:2]
    grids0 = (torch.zeros((B, geom.prows, geom.pcols), dtype=torch.int8,
                          device=poses.device) if grid0 is None else grid0)
    sl = _kf_slots(beams, sched, kf_every, cfg)
    K_p = sl.nc * sl.n_kf
    K = len(range(0, T, kf_every))
    s = cfg.slam
    matched = poses
    if n_iters is None:
        n_iters = int(s.match_iters)
    for _ in range(max(n_iters, 1)):
        snap, match = _round_operands(sl, matched, kf_every, cfg, geom)
        grids, snaps = map_snap(grids0, *snap, sl.n_kf, cfg, geom)
        grids = _recenter_grids(grids, sl.tail["do"], sl.tail["rsy"],
                                sl.tail["rsx"], cfg, geom)
        res = match_slabs(snaps.reshape((B * K_p,) + snaps.shape[2:]),
                          *match, cfg.map, cfg.tof, geom, s.match_n_xy,
                          s.match_n_yaw, s.match_xy_step_m,
                          s.match_yaw_step_deg)
        ok = (res.quality > _f(s.match_min_quality)).reshape(B, K_p)
        pick = lambda a, b: torch.where(ok, a.reshape(B, K_p), b)  # noqa: E731
        kf_x, kf_y, kf_yaw = snap[1:4]
        mk = torch.stack([pick(res.x, kf_x), pick(res.y, kf_y),
                          pick(res.yaw_deg, kf_yaw) * DEG2RAD], dim=-1)
        # the corrections land on the keyframe slots (stride kf_every)
        matched = matched.clone()
        matched[:, ::kf_every] = mk[:, :K]
    return grids, matched


def _match_chunk(grids, beams, x, y, yaw_deg, ox0, oy0, cfg, geom):
    """ops/scanmatch.py::match_scan of a chunk's keyframes [B, n] (beams
    [B, n, 4, 8]) against their flight's grid, grids [B, PR, PC], with
    every keyframe's cells in the chunk-start origin (ox0, oy0) [B]: one
    flat batch of B * n matches, one lattice-kernel launch.  A match
    whose quality clears match_min_quality replaces its guess (the JAX
    package's _match_kf).  Returns the poses (x, y, yaw_deg) [B, n]."""
    s = cfg.slam
    B, n = x.shape
    dev = x.device
    ox, oy = ox0[:, None].expand(B, n), oy0[:, None].expand(B, n)
    pcx, pcy = world_to_cell(x, y, ox, oy, cfg.map.res_m, cfg.map.width // 2,
                             cfg.map.height // 2)
    wy0, wx0 = window_origin(pcx, pcy, geom)
    rr = wy0.long()[..., None] + torch.arange(geom.win_rows, device=dev)
    cc = wx0.long()[..., None] + torch.arange(geom.win_cols, device=dev)
    bb = torch.arange(B, device=dev)[:, None, None, None]
    win = grids[bb, rr[..., :, None], cc[..., None, :]]       # [B, n, R, C]
    fl = lambda a: a.reshape((B * n,) + a.shape[2:])               # noqa: E731
    res = match_window(fl(win).contiguous(), fl(wy0), fl(wx0), fl(beams),
                       fl(x), fl(y), fl(yaw_deg), fl(ox), fl(oy), cfg.map,
                       cfg.tof, geom, s.match_n_xy, s.match_n_yaw,
                       s.match_xy_step_m, s.match_yaw_step_deg)
    ok = (res.quality > _f(s.match_min_quality)).reshape(B, n)
    pick = lambda a, b: torch.where(ok, a.reshape(B, n), b)        # noqa: E731
    return pick(res.x, x), pick(res.y, y), pick(res.yaw_deg, yaw_deg)


def _map_pass_fb(beams, poses, cfg, geom, kf_every: int, sched,
                 grid0=None):
    """Pass 1 with match feedback (SlamConfig.match_feedback, or
    match_map_kf_only=False): each keyframe's correction lands on the map
    that later keyframes match.  The counterpart of the JAX package's
    chunked pass (_map_pass_chunked) and bit-equal to its sequential pass
    (_map_pass with match=True, snapshots every chunk).  Chunk by chunk of
    match_chunk_intervals keyframe intervals:

      - the chunk-start recenter rolls the grid (outside the kernel: the
        matches see the rolled grid);
      - every keyframe of the chunk matches that grid in the chunk-start
        origin, all in one lattice-kernel launch (_match_chunk);
      - the chunk lands on the grid in one launch of the exact kernel
        (map_chunk_sched), its in-chunk recenters rolled in the kernel.

    With match_map_kf_only only the keyframe scans land, at their matched
    poses, and the recenter schedule is composed per keyframe interval
    (_compose_kf_sched: zero-fill shifts compose exactly for same-sign
    pairs; the recenters after the last keyframe roll once at the end).
    Otherwise every frame lands, a keyframe at its matched pose and any
    other frame at its estimate.  Frames past T are inert padding.
    Returns (final grids, poses [B, T, 3]: matched at the keyframes, the
    estimates elsewhere, yaw through degrees and back as the reference's
    pass returns it)."""
    B, T = poses.shape[:2]
    grids = (torch.zeros((B, geom.prows, geom.pcols), dtype=torch.int8,
                         device=poses.device) if grid0 is None else grid0)
    C = kf_every * max(int(cfg.slam.match_chunk_intervals), 1)
    nc = -(-T // C)
    beams_p, sch = _pad_chunk_inputs(beams, sched, B, T, C, nc)
    poses_p = _pad_t(poses, nc * C - T, 0.0)
    n_kf = len(range(0, C, kf_every))
    kf_only = bool(cfg.slam.match_map_kf_only)
    if kf_only:
        # the kernel's slots: one per keyframe, the schedule composed
        comp, tail = _compose_kf_sched(sch, B, nc, kf_every, n_kf)
        slots = {"beams": beams_p[:, ::kf_every],
                 "ox": sch["ox"][:, ::kf_every],
                 "oy": sch["oy"][:, ::kf_every], **comp}
        per = n_kf
    else:
        slots = {"beams": beams_p, **sch}
        per = C
    x, y = poses_p[..., 0].clone(), poses_p[..., 1].clone()
    yaw = poses_p[..., 2] * RAD2DEG
    for c in range(nc):
        s0 = c * per
        sl = slice(s0, s0 + per)
        kf = slice(c * C, (c + 1) * C, kf_every)
        grids = _recenter_grids(grids, slots["do"][:, s0],
                                slots["rsy"][:, s0], slots["rsx"][:, s0],
                                cfg, geom)
        do = slots["do"][:, sl].clone()
        do[:, 0] = 0                       # rolled above
        x[:, kf], y[:, kf], yaw[:, kf] = _match_chunk(
            grids, beams_p[:, kf], x[:, kf], y[:, kf], yaw[:, kf],
            slots["ox"][:, s0], slots["oy"][:, s0], cfg, geom)
        land = kf if kf_only else slice(c * C, (c + 1) * C)
        grids = map_chunk_sched(grids, slots["beams"][:, sl], x[:, land],
                                y[:, land], yaw[:, land], slots["ox"][:, sl],
                                slots["oy"][:, sl], do, slots["rsy"][:, sl],
                                slots["rsx"][:, sl], cfg, geom)
    if kf_only:
        grids = _recenter_grids(grids, tail["do"], tail["rsy"], tail["rsx"],
                                cfg, geom)
    matched = torch.stack([x, y, yaw * DEG2RAD], dim=-1)[:, :T]
    return grids, matched


def _raster_windows(kfp, kf_beams, kf_ox, kf_oy, cfg, geom):
    """Each keyframe's scan alone as an endpoint field in its own
    [win_rows, win_cols] window: the endpoint deltas of its valid rays
    summed per cell (an exact integer scatter) and clipped to
    [0, lo_max].  kfp [B, K, 3].  Returns (windows int8 [B, K, WR, WC],
    window origins wy0, wx0 [B, K] in padded-grid cells)."""
    B, K = kfp.shape[:2]
    WR, WC = geom.win_rows, geom.win_cols
    rays = make_rays(kf_beams, kfp[..., 0], kfp[..., 1],
                     kfp[..., 2] * RAD2DEG, kf_ox, kf_oy,
                     torch.ones_like(kf_ox, dtype=torch.bool), cfg.map,
                     cfg.tof)
    ey = rays["ey"] + geom.win_r
    ex = rays["ex"] + geom.win_r
    d = torch.where(rays["valid"], rays["end_delta"],
                    torch.zeros_like(rays["end_delta"]))
    win = torch.zeros((B * K, WR * WC), dtype=torch.int32, device=kfp.device)
    win.scatter_add_(1, (ey * WC + ex).reshape(B * K, 32).long(),
                     d.reshape(B * K, 32))
    win = win.clamp(0, cfg.map.lo_max).to(torch.int8).reshape(B, K, WR, WC)
    return (win, rays["pcy"] + geom.pad - geom.win_r,
            rays["pcx"] + geom.pad - geom.win_r)


def _cand_indices(kfp, cfg, n_cand: int):
    """The n_cand nearest keyframes at least loop_min_gap keyframes older
    than each keyframe j, with their proximity gate.  kfp [B, K, 3] ->
    (ic int64 [B, n_cand, K], near bool [B, n_cand, K])."""
    s = cfg.slam
    B, K = kfp.shape[:2]
    dev = kfp.device
    pos = kfp[..., :2]
    d2 = ((pos[:, None, :, :] - pos[:, :, None, :]) ** 2).sum(-1)  # [B, i, j]
    iidx = torch.arange(K, device=dev)
    gap_ok = (iidx[None, :] - iidx[:, None]) >= s.loop_min_gap
    cand = torch.where(gap_ok, d2, torch.full_like(d2, float("inf")))
    r2 = _f(_F32(s.loop_r_max_m) ** 2)
    ics, nears = [], []
    for _ in range(n_cand):
        i_best = torch.argmin(cand, dim=1)                         # [B, K]
        best = torch.gather(cand, 1, i_best[:, None, :])[:, 0]
        nears.append(best < r2)
        cand = torch.where(iidx[None, :, None] == i_best[:, None, :],
                           torch.full_like(cand, float("inf")), cand)
        ics.append(i_best)
    return torch.stack(ics, dim=1), torch.stack(nears, dim=1)


def _select_edges(ic, zc, qc, n_edges: int):
    """The n_edges best candidates of every keyframe by match quality.
    ic [B, n_cand, K]; zc [B, n_cand, K, 3]; qc [B, n_cand, K] (-inf =
    gated).  Returns (ij [B, E, 2], z [B, E, 3], ok [B, E], q [B, E]) with
    E = n_edges * K."""
    B, n_cand, K = qc.shape
    dev = qc.device
    iidx = torch.arange(K, device=dev).expand(B, K)
    carange = torch.arange(n_cand, device=dev)[None, :, None]
    ninf = torch.full_like(qc, float("-inf"))
    ijs, zs, oks, qs = [], [], [], []
    for _ in range(n_edges):
        sel = torch.argmax(qc, dim=1)                              # [B, K]
        pick = carange == sel[:, None, :]
        ijs.append(torch.stack([torch.where(pick, ic, 0).sum(1), iidx], -1))
        zs.append(torch.where(pick[..., None], zc, 0.0).sum(1))
        qbest = torch.where(pick, qc, ninf).amax(1)
        ok = torch.isfinite(qbest)
        oks.append(ok)
        qs.append(torch.where(ok, qbest, torch.zeros_like(qbest)))
        qc = torch.where(pick, ninf, qc)
    return (torch.cat(ijs, 1), torch.cat(zs, 1), torch.cat(oks, 1),
            torch.cat(qs, 1))


def _loop_candidates(kfp, kf_beams, kf_ox, kf_oy, cfg, geom):
    """The loop stage's candidate matches: for each keyframe j, its
    loop_cand nearest older keyframes i (_cand_indices); j's scan is
    matched against i's endpoint field, both in i's origin frame.  kfp
    [B, K, 3]; kf_beams [B, K, 4, 8]; kf_ox/kf_oy [B, K].  Returns (ic,
    near [B, n_cand, K], pi [B, n_cand * K, 3] the candidates' poses,
    match_slabs' operands from slabs to origin_y, flat over
    B * n_cand * K)."""
    s = cfg.slam
    B, K = kfp.shape[:2]
    n_cand = max(int(s.loop_cand), int(s.loop_edges), 1)
    wins, wy0s, wx0s = _raster_windows(kfp, kf_beams, kf_ox, kf_oy, cfg, geom)
    ic, near = _cand_indices(kfp, cfg, n_cand)
    NC = n_cand * K
    icf = ic.reshape(B, NC)
    gat = lambda a: torch.gather(a, 1, icf)                        # noqa: E731
    win_g = wins[torch.arange(B, device=kfp.device)[:, None], icf]
    pi = torch.gather(kfp, 1, icf[..., None].expand(B, NC, 3))
    pj = kfp[:, None].expand(B, n_cand, K, 3).reshape(B, NC, 3)
    beams_j = kf_beams[:, None].expand((B, n_cand) + kf_beams.shape[1:])
    fl = lambda a: a.reshape((B * NC,) + a.shape[2:])              # noqa: E731
    args = [fl(win_g).contiguous(), fl(gat(wy0s)), fl(gat(wx0s)),
            fl(beams_j.reshape((B, NC) + kf_beams.shape[2:])),
            fl(pj[..., 0]), fl(pj[..., 1]), fl(pj[..., 2]) * RAD2DEG,
            fl(gat(kf_ox)), fl(gat(kf_oy))]
    return ic, near, pi, args


def _loop_stage(kfp, kf_beams, kf_ox, kf_oy, cfg, geom):
    """Proximity-gated keyframe-to-keyframe loop edges: every candidate
    match of _loop_candidates within loop_r_max_m runs in one
    lattice-kernel launch, and the loop_edges best by quality become
    edges with measured relative transforms.  Returns (ij [B, E, 2],
    z [B, E, 3], ok [B, E], quality [B, E]), E = loop_edges * K."""
    s = cfg.slam
    B, K = kfp.shape[:2]
    ic, near, pi, args = _loop_candidates(kfp, kf_beams, kf_ox, kf_oy, cfg,
                                          geom)
    n_cand = ic.shape[1]
    res = match_slabs(*args, cfg.map, cfg.tof, geom, s.loop_n_xy,
                      s.loop_n_yaw, s.match_xy_step_m, s.match_yaw_step_deg)
    pj_corr = torch.stack([res.x, res.y, res.yaw_deg * DEG2RAD],
                          dim=-1).reshape(B, n_cand * K, 3)
    zc = se2_relative(pi, pj_corr).reshape(B, n_cand, K, 3)
    q = res.quality.reshape(B, n_cand, K)
    ok = near & (q > _f(s.loop_min_quality))
    qc = torch.where(ok, q, torch.full_like(q, float("-inf")))
    return _select_edges(ic, zc, qc, max(int(s.loop_edges), 1))


def _build_and_solve(odo, matched, kf_idx, lij, lz, lok, lq, sc, cfg,
                     iters: int, nodes0=None):
    """The pose graph of every flight: odometry edges (translations scaled
    by the fitted odometry scale sc [B]), match anchors to node 0 and the
    loop edges (quality-scaled information, Huber), solved by
    Gauss-Newton.  Returns (nodes [B, K, 3], costs [B, iters])."""
    s = cfg.slam
    B = odo.shape[0]
    K = kf_idx.shape[0]
    dev = odo.device
    g = chain_odometry_graph(odo, kf_idx, s.odo_w)
    one = torch.ones_like(sc)
    g = g._replace(edges_z=g.edges_z * torch.stack([sc, sc, one],
                                                   -1)[:, None, :])
    mk = matched[:, kf_idx]
    anchors = se2_relative(mk[:, :1].expand(B, K - 1, 3), mk[:, 1:])
    ar = torch.arange(1, K, device=dev)
    ij = torch.stack([torch.zeros_like(ar), ar], -1).expand(B, K - 1, 2)
    g = add_edges(g, ij, anchors, [_f(v) for v in s.anchor_w])
    qsc = div_f32(lq, _f(s.loop_q_ref)).clamp(_f(s.loop_q_min),
                                              _f(s.loop_q_max))
    w = torch.tensor([_f(v) for v in s.loop_w], dtype=torch.float32,
                     device=dev)[None, None, :] * qsc[..., None]
    g = add_edges(g, lij, lz, w, mask=lok, huber=_f(s.loop_huber))
    if nodes0 is not None:
        g = g._replace(nodes=nodes0)
    else:
        g = g._replace(nodes=torch.cat([mk[:, :1], g.nodes[:, 1:]], dim=1))
    g, costs = gauss_newton(g, iters=iters)
    return g.nodes, costs


def _norm2(v):
    """Euclidean norm over the last axis of 2: sqrt(x*x + y*y)."""
    return sqrt_f32(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _check_frames(frames: dict, cfg: PipelineConfig, kf_every: int,
                  gn_iters: int) -> None:
    x = frames["x_m"]
    if x.dim() != 2 or x.shape[1] == 0 or kf_every < 1:
        raise ValueError(f"frames must be [B, T] with T >= 1 and kf_every "
                         f">= 1, got x_m of shape {tuple(x.shape)} and "
                         f"kf_every={kf_every}")
    s = cfg.slam
    if int(s.gn_refine_iters) > gn_iters:
        raise ValueError(f"gn_refine_iters={s.gn_refine_iters} exceeds "
                         f"gn_iters={gn_iters}")


def _slam_impl(frames: dict, cfg: PipelineConfig, geom: GridGeom,
               kf_every: int | None, gn_iters: int | None, state0=None,
               upto: int = 99):
    """slam_replay's body.  upto stops after a stage and returns its
    output: 0 = (odo, sched), 1 = matched poses of the last round's pass 1,
    2 = (matched, loop ij, z, ok), 3 = (kf_nodes, gn_costs), 4 = track."""
    s = cfg.slam
    kf_every = s.kf_every if kf_every is None else kf_every
    gn_iters = s.gn_iters if gn_iters is None else gn_iters
    _check_frames(frames, cfg, kf_every, gn_iters)
    B, T = frames["x_m"].shape
    dev = frames["x_m"].device
    beams, _ = extract_beams(frames["grid_mm"], cfg.tof)
    kf_idx = torch.arange(0, T, kf_every, device=dev)
    K = kf_idx.shape[0]

    grid0 = origin0 = None
    if state0 is not None:
        grid0 = state0[0].to(dev)
        origin0 = (state0[1].to(dev), state0[2].to(dev))

    # pass 0: EKF odometry and the recenter schedule, decided grid-free
    # from the odometry track
    odo, sched = _odo_and_schedule(frames, cfg, origin0)
    if upto == 0:
        return odo, sched

    kf_beams = beams[:, kf_idx]
    kf_ox, kf_oy = sched["ox"][:, kf_idx], sched["oy"][:, kf_idx]

    def run_loop(kfp):
        return _loop_stage(kfp, kf_beams, kf_ox, kf_oy, cfg, geom)

    owner = (torch.arange(T, device=dev) // kf_every).clamp(0, K - 1)
    rel = se2_relative(odo[:, kf_idx][:, owner], odo)             # [B, T, 3]
    odo_kf_d = _norm2(torch.diff(odo[:, kf_idx, :2], dim=1))      # [B, K-1]
    est = odo
    sc = torch.ones((B,), dtype=torch.float32, device=dev)
    n_outer = max(int(s.slam_outer), 1)
    it_later = int(s.match_iters_later) if int(s.match_iters_later) > 0 \
        else None
    gn_ref = int(s.gn_refine_iters) if int(s.gn_refine_iters) > 0 else None
    for rnd in range(n_outer):
        last = rnd == n_outer - 1
        if s.match_map_kf_only and not s.match_feedback:
            _, matched = _map_pass_nofb(
                beams, est, cfg, geom, kf_every, sched, grid0=grid0,
                n_iters=None if rnd == 0 else it_later)
        else:
            _, matched = _map_pass_fb(beams, est, cfg, geom, kf_every, sched,
                                      grid0=grid0)
        if last and upto == 1:
            return matched
        loop = run_loop(matched[:, kf_idx])
        if last and upto == 2:
            return (matched,) + loop[:3]
        kf_nodes, gn_costs = _build_and_solve(odo, matched, kf_idx, *loop, sc,
                                              cfg, gn_iters)
        # refine rounds: re-run the loop stage at the solved nodes and
        # re-solve (warm-started with gn_refine_iters when that is set)
        n_ref = max(int(s.loop_refine if last else (
            s.loop_refine_early if int(s.loop_refine_early) >= 0
            else s.loop_refine)), 0)
        for _ in range(n_ref):
            loop = run_loop(kf_nodes)
            nodes, costs = _build_and_solve(
                odo, matched, kf_idx, *loop, sc, cfg,
                gn_iters if gn_ref is None else gn_ref,
                nodes0=None if gn_ref is None else kf_nodes)
            # gn_costs describes the solve that gave the returned nodes; a
            # shorter warm solve pads its trace with NaN
            if costs.shape[1] < gn_costs.shape[1]:
                costs = torch.nn.functional.pad(
                    costs, (0, gn_costs.shape[1] - costs.shape[1]),
                    value=float("nan"))
            kf_nodes, gn_costs = nodes, costs
        if last and upto == 3:
            return kf_nodes, gn_costs

        # the per-flight odometry scale, refitted from the solved keyframe
        # steps, and every frame corrected rigidly from its keyframe
        sol_kf_d = _norm2(torch.diff(kf_nodes[..., :2], dim=1))
        # the sums in float64, rounded once: the same bits on every device
        sc = ((odo_kf_d * sol_kf_d).double().sum(1).float()
              / (odo_kf_d * odo_kf_d).double().sum(1).float().clamp_min(
                  _f(1e-9))).clamp(_f(s.odo_scale_min), _f(s.odo_scale_max))
        rel_sc = rel * torch.stack([sc, sc, torch.ones_like(sc)],
                                   -1)[:, None, :]
        track = se2_compose(kf_nodes[:, owner], rel_sc)
        est = track
    if upto == 4:
        return track

    # pass 3: re-raster every frame from the corrected track, one launch
    grids0 = (torch.zeros((B, geom.prows, geom.pcols), dtype=torch.int8,
                          device=dev) if grid0 is None else grid0)
    grid = map_chunk_sched(grids0, beams, track[..., 0], track[..., 1],
                           track[..., 2] * RAD2DEG, sched["ox"], sched["oy"],
                           sched["do"], sched["rsy"], sched["rsx"], cfg, geom)
    origin = (sched["ox"][:, -1], sched["oy"][:, -1])
    return SlamResult(grid, track, odo, kf_idx, kf_nodes, gn_costs, origin)


def slam_replay(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                geom: GridGeom = DEFAULT_GEOM, kf_every: int | None = None,
                gn_iters: int | None = None, state0=None) -> SlamResult:
    """Drift-corrected map and track of a [B] batch of flights.  frames:
    dict of [B, T] tensors, the union of scanlog_to_arrays and
    fusion_arrays (frames_to_torch puts them on the CUDA device unless
    told otherwise).  kf_every / gn_iters override cfg.slam.  state0: a
    previous segment's (grid [B, prows, pcols], origin_x [B], origin_y
    [B]): its map and origins seed the matching pass and the re-raster, so
    a flight split across logs continues in the same frame."""
    return _slam_impl(frames, cfg, geom, kf_every, gn_iters, state0)
