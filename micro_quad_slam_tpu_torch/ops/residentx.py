"""The exact whole-replay path: a grid-free schedule in torch, then one
hand-written Hopper kernel that applies it to every quad's grid
(counterpart of micro_quad_slam_tpu/ops/pallas_residentx.py and of the
"exact2" part of pallas_resident.py::_schedule).

Everything except the grid depends only on the logged frames: origins,
the recenter schedule, the ray endpoints and the enable gates.  The
sequential [B]-wide carry over T (ToF filter, map init, recenter
decision, origin shift) is replay/mapping.py::carry, shared with the cone
and hybrid modes; from its outputs `sched_words` makes every ray of
every (quad, frame) at once and packs them into one int32 tensor
[B, T, WORDS]:

    word  0..7    header: pose row, pose col (padded-grid cells), do,
                  recenter rows sy, recenter cols sx, any-valid-ray, and
                  (SLAM snapshots only, else 0) the snapshot slab's origin
                  row and column
    word  8+4r..  ray r (reference order F0..F7, R0..R7, B0..B7, L0..L7):
                  ex, ey (endpoint relative to the pose cell), end_delta,
                  valid

`replay_exact` applies a schedule to the grids in place: on a CUDA tensor
it launches csrc/replay_exact.cu, on a CPU tensor it runs the plain
version (`replay_exact_plain`, the same frame loop in torch ops), and on
any other device it raises.  replay/mapping.py::replay_whole runs the
carry, the words and this kernel as one whole replay.

The SLAM pipeline's entries (counterparts of pallas_residentx.py's
pallas_map_chunk_sched, pallas_map_snap, pallas_map_chunk and
pallas_map_track_x, and of pallas_resident.py's pallas_map_track) build
their schedule from given poses and origins with every frame enabled
(`track_schedule`).  `map_chunk_sched` applies it with `replay_exact`;
`map_snap` with `replay_exact_snap`, the kernel's snapshot entry, which
also copies each keyframe chunk's start-of-chunk map slabs for the
matcher.

`map_step` (counterpart of pallas_residentx.py's pallas_map_step, the
closed-loop simulator's scan tick) applies ONE frame of words per quad,
with no recenter, through the kernel's map-step entry (mqs_map_step); it
needs no host sync.  The replay's per-frame kernel names "pallas" and
"pallas_db" (pallas_raycast.py's window kernels) run through it too.
"""

from __future__ import annotations

import math

import torch

from micro_quad_slam_tpu_torch.utils.config import PipelineConfig
from micro_quad_slam_tpu_torch.ops import _build
from micro_quad_slam_tpu_torch.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    apply_rays_,
    cut_windows,
    make_rays,
    recenter_apply,
)

HDR = 8
H_PCY, H_PCX, H_DO, H_RSY, H_RSX, H_ANY, H_R0S, H_C0S = range(8)
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


def sched_words(frames: dict, beams: torch.Tensor, so: dict,
                cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM):
    """The exact schedule of frames [B, T, ...] from the replay's carry
    (replay/mapping.py::carry: its beams and the sequence `so`): every
    ray of every (quad, frame) at once, packed.  Returns sched int32
    [B, T, WORDS]."""
    rays = make_rays(beams, frames["x_m"], frames["y_m"], frames["yaw_deg"],
                     so["ox"], so["oy"], so["enabled"], cfg.map, cfg.tof)
    return _pack(rays, so["do"], so["sy"], so["sx"], geom)


def _pack(rays: dict, do, sy, sx, geom: GridGeom, r0s=None, c0s=None):
    """make_rays' output for [B, T] frames plus their recenter flags and
    shifts (and the snapshot slab origins, if any) -> sched int32
    [B, T, WORDS]."""
    valid = rays["valid"]
    B, T = valid.shape[:2]
    zero = torch.zeros_like(rays["pcx"])
    header = torch.stack([
        rays["pcy"] + geom.pad, rays["pcx"] + geom.pad,
        do.to(torch.int32), sy.to(torch.int32), sx.to(torch.int32),
        valid.any(dim=-1).to(torch.int32),
        zero if r0s is None else r0s.to(torch.int32),
        zero if c0s is None else c0s.to(torch.int32)], dim=-1)
    ray_words = torch.stack([rays["ex"], rays["ey"], rays["end_delta"],
                             valid.to(torch.int32)], dim=-1)
    return torch.cat([header, ray_words.reshape(B, T, 32 * RAY_WORDS)],
                     dim=-1).contiguous()


def _frame_rays(w: torch.Tensor, geom: GridGeom) -> dict:
    """One frame's schedule words [B, WORDS] -> make_rays' dict."""
    r = w[:, HDR:].reshape(-1, 32, RAY_WORDS)
    return {"ex": r[..., 0], "ey": r[..., 1], "end_delta": r[..., 2],
            "valid": r[..., 3] != 0,
            "pcx": w[:, H_PCX] - geom.pad, "pcy": w[:, H_PCY] - geom.pad}


def replay_exact_plain(grids: torch.Tensor, sched: torch.Tensor,
                       cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM,
                       snaps: torch.Tensor | None = None,
                       n_kf: int = 1) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: per frame, the
    recenter (recenter_apply, on the quads whose do is set) then the
    window update (window_scan_update) for the whole [B] batch.  With
    `snaps` [B, T, rows, cols] it is the plain version of the snapshot
    entry as well: at every n_kf-th frame, after its recenter and before
    its rays, the slab at header words (H_R0S, H_C0S) of each of the next
    n_kf frames is copied to snaps[:, frame].  Updates grids (and snaps)
    in place and returns grids."""
    T = sched.shape[1]
    do_any = sched[..., H_DO].any(dim=0).tolist()      # one host sync
    live = sched[..., H_ANY].any(dim=0).tolist()
    for t in range(T):
        w = sched[:, t]
        if do_any[t]:
            moved = recenter_apply(grids, w[:, H_RSX], w[:, H_RSY], cfg.map,
                                   geom)
            grids.copy_(torch.where(w[:, H_DO, None, None] != 0, moved,
                                    grids))
        if snaps is not None and t % n_kf == 0:
            for f in range(t, min(t + n_kf, T)):
                snaps[:, f] = cut_windows(grids, sched[:, f, H_R0S],
                                          sched[:, f, H_C0S],
                                          snaps.shape[2], snaps.shape[3])
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


def recenter_scratch(grids: torch.Tensor, sched: torch.Tensor):
    """A replay kernel's recenter staging, one grid per quad, or None when
    no frame of sched [B, T, words] recenters (header word H_DO; the
    kernels read it only on a recentering frame).  Most replays never
    recenter, so it costs a host sync to spare another copy of the
    grids."""
    return torch.empty_like(grids) if bool(sched[..., H_DO].any()) else None


def replay_exact(grids: torch.Tensor, sched: torch.Tensor,
                 cfg: PipelineConfig,
                 geom: GridGeom = DEFAULT_GEOM) -> torch.Tensor:
    """Apply a schedule to grids int8 [B, PR, PC] in place and return
    them.  A CUDA tensor goes to the Hopper kernel (csrc/replay_exact.cu);
    a CPU tensor to replay_exact_plain; any other device raises.  Each
    launch counts in the counter launches.replay_exact (utils/obs.py)."""
    check_supported(cfg, geom)
    check_operands(grids, sched, geom)
    if grids.device.type == "cpu":
        return replay_exact_plain(grids, sched, cfg, geom)
    if grids.device.type != "cuda":
        raise ValueError(f"no exact replay kernel for device {grids.device}")
    B, T = sched.shape[:2]
    if B == 0 or T == 0:
        return grids
    m = cfg.map
    _build.launch(None, "mqs_replay_exact", grids.device, grids,
                  sched, recenter_scratch(grids, sched), B, T, WORDS,
                  geom.prows, geom.pcols, geom.pad, geom.width, geom.height,
                  geom.win_r, m.lo_min, m.lo_max, m.lo_free_dec)
    return grids


def replay_exact_snap(grids: torch.Tensor, sched: torch.Tensor,
                      snaps: torch.Tensor, n_kf: int, cfg: PipelineConfig,
                      geom: GridGeom = DEFAULT_GEOM) -> torch.Tensor:
    """replay_exact plus the chunk-start snapshots (see replay_exact_plain):
    grids int8 [B, PR, PC] and snaps int8 [B, T, rows, cols] are updated in
    place.  A CUDA tensor goes to the kernel's snapshot entry
    (csrc/replay_exact.cu, mqs_replay_exact_snap), a CPU tensor to
    replay_exact_plain; any other device raises.  Every slab must lie in
    the padded grid with its column a multiple of 16.  Each launch counts
    in launches.replay_exact_snap."""
    check_supported(cfg, geom)
    check_operands(grids, sched, geom)
    B, T = sched.shape[:2]
    if snaps.dtype != torch.int8 or snaps.dim() != 4 or \
            tuple(snaps.shape[:2]) != (B, T) or not snaps.is_contiguous() \
            or snaps.device != grids.device:
        raise ValueError(f"snaps must be contiguous int8 [B, T, rows, cols] "
                         f"on {grids.device}, got {tuple(snaps.shape)} "
                         f"{snaps.dtype} on {snaps.device}")
    rows, cols = snaps.shape[2:]
    r0, c0 = sched[..., H_R0S], sched[..., H_C0S]
    if cols % 16 or not bool(((r0 >= 0) & (r0 + rows <= geom.prows)
                              & (c0 >= 0) & (c0 + cols <= geom.pcols)
                              & (c0 % 16 == 0)).all()):
        raise ValueError("snapshot slabs must lie inside the padded grid "
                         "with columns a multiple of 16")
    if grids.device.type == "cpu":
        return replay_exact_plain(grids, sched, cfg, geom, snaps, n_kf)
    if grids.device.type != "cuda":
        raise ValueError(f"no exact replay kernel for device {grids.device}")
    if B == 0 or T == 0:
        return grids
    m = cfg.map
    _build.launch(None, "mqs_replay_exact_snap", grids.device,
                  grids, sched, recenter_scratch(grids, sched), snaps, B, T,
                  WORDS, geom.prows, geom.pcols, geom.pad, geom.width,
                  geom.height, geom.win_r, m.lo_min, m.lo_max,
                  m.lo_free_dec, n_kf, rows, cols)
    return grids


def _step_words(beams, x, y, yaw_deg, origin_x, origin_y, enabled,
                cfg: PipelineConfig, geom: GridGeom) -> torch.Tensor:
    """One scan per quad (beams [B, 4, 8], the rest [B]) -> its frame of
    schedule words int32 [B, WORDS], with do = 0."""
    lead = lambda a: a[:, None]                                       # noqa: E731
    rays = make_rays(lead(beams), lead(x), lead(y), lead(yaw_deg),
                     lead(origin_x), lead(origin_y), lead(enabled), cfg.map,
                     cfg.tof)
    zero = torch.zeros_like(rays["pcx"])
    return _pack(rays, zero, zero, zero, geom)[:, 0].contiguous()


def map_step_plain(grids, beams, x, y, yaw_deg, origin_x, origin_y, enabled,
                   cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM):
    """Plain torch version of map_step, on any device: the same words,
    then window_scan_update on every quad's window (a quad with no valid
    ray gets its window back unchanged).  Updates grids in place and
    returns them."""
    check_supported(cfg, geom)
    words = _step_words(beams, x, y, yaw_deg, origin_x, origin_y, enabled,
                        cfg, geom)
    check_operands(grids, words[:, None], geom)
    return apply_rays_(grids, _frame_rays(words, geom), cfg.map, geom)


def map_step(grids, beams, x, y, yaw_deg, origin_x, origin_y, enabled,
             cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM):
    """ONE exact scan update per quad on its padded int8 grid [B, PR, PC],
    in place (counterpart of pallas_residentx.py::pallas_map_step, the
    closed-loop simulator's scan tick): beams [B, 4, 8], poses, origins
    and enabled [B].  A disabled quad, or one whose pose make_rays gates
    out, keeps its grid untouched.  A CUDA tensor goes to the kernel's
    map-step entry (csrc/replay_exact.cu, mqs_map_step), a CPU tensor to
    map_step_plain; any other device raises.  Returns grids; each launch
    counts in launches.map_step."""
    if grids.device.type == "cpu":
        return map_step_plain(grids, beams, x, y, yaw_deg, origin_x,
                              origin_y, enabled, cfg, geom)
    if grids.device.type != "cuda":
        raise ValueError(f"no map step kernel for device {grids.device}")
    check_supported(cfg, geom)
    words = _step_words(beams, x, y, yaw_deg, origin_x, origin_y, enabled,
                        cfg, geom)
    check_operands(grids, words[:, None], geom)
    B = grids.shape[0]
    if B == 0:
        return grids
    m = cfg.map
    _build.launch(None, "mqs_map_step", grids.device, grids, words,
                  B, WORDS, geom.prows, geom.pcols, geom.win_r, m.lo_min,
                  m.lo_max, m.lo_free_dec)
    return grids


def track_schedule(beams, x, y, yaw_deg, ox, oy, do, rsy, rsx,
                   cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM,
                   r0s=None, c0s=None) -> torch.Tensor:
    """The schedule of a pose track with every frame enabled: beams
    [B, T, 4, 8], poses, per-frame origins, recenter flags and shifts
    [B, T] (a frame with do = 0 does not move the grid, whatever its
    shifts), and optionally the snapshot slab origins [B, T].  Frames with
    NaN beams are inert."""
    rays = make_rays(beams, x, y, yaw_deg, ox, oy,
                     torch.ones_like(x, dtype=torch.bool), cfg.map, cfg.tof)
    do = do != 0
    zero = torch.zeros_like(rays["pcx"])
    return _pack(rays, do, torch.where(do, rsy.to(zero.dtype), zero),
                 torch.where(do, rsx.to(zero.dtype), zero), geom, r0s, c0s)


def _fresh_grids(x: torch.Tensor, geom: GridGeom) -> torch.Tensor:
    return torch.zeros((x.shape[0], geom.prows, geom.pcols),
                       dtype=torch.int8, device=x.device)


def map_chunk_sched(grids, beams, x, y, yaw_deg, ox, oy, do, rsy, rsx,
                    cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM):
    """Apply [B, C] scans to grids [B, PR, PC] with per-frame origins and a
    recenter schedule (the grid moves by (rsy, rsx) cells before frame c's
    rays when do != 0), every frame enabled: the SLAM re-raster.  Returns
    new grids; `grids` is left as it was."""
    sched = track_schedule(beams, x, y, yaw_deg, ox, oy, do, rsy, rsx, cfg,
                           geom)
    return replay_exact(grids.clone(memory_format=torch.contiguous_format),
                        sched, cfg, geom)


def map_chunk(grids, beams, x, y, yaw_deg, origin_x, origin_y,
              cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM):
    """map_chunk_sched with one fixed origin per flight (origin_x/y [B]) and
    no recentering."""
    z = torch.zeros_like(x, dtype=torch.int32)
    return map_chunk_sched(grids, beams, x, y, yaw_deg,
                           origin_x[:, None].expand_as(x),
                           origin_y[:, None].expand_as(x), z, z, z, cfg, geom)


def map_track(beams, x, y, yaw_deg, origin_x, origin_y,
              cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM):
    """Raster a [B, T] pose track into fresh grids: map_chunk from zero
    grids."""
    return map_chunk(_fresh_grids(x, geom), beams, x, y, yaw_deg, origin_x,
                     origin_y, cfg, geom)


def _snap_dims(geom: GridGeom) -> tuple:
    """Snapshot slab shape [win_rows + 8, 2*win_cols]: the 8 extra rows and
    the doubled width cover the 8/128 alignment of the slab's origin below
    the match window's (see _snap_align)."""
    return geom.win_rows + 8, 2 * geom.win_cols


def _snap_align(wy0, wx0, geom: GridGeom):
    """Aligned slab origin for a match window at (wy0, wx0): 8/128-aligned,
    clipped so that the slab stays inside the padded grid.  The window
    sits at (wy0 - r0s, wx0 - c0s) in [0, 8] x [0, 128] inside it."""
    sr, sc = _snap_dims(geom)
    r0s = (torch.div(wy0, 8, rounding_mode="floor") * 8).clamp(
        0, geom.prows - sr)
    c0s = (torch.div(wx0, 128, rounding_mode="floor") * 128).clamp(
        0, geom.pcols - sc)
    return r0s, c0s


def _snap_operands(grids, beams, x, y, yaw_deg, ox, oy, do, rsy, rsx, wy0,
                   wx0, n_kf: int, cfg: PipelineConfig, geom: GridGeom):
    """map_snap's schedule (with the slab origins), zero snapshot slabs and
    a copy of the grids: (grids, sched, snaps)."""
    B, K = x.shape
    if K % n_kf:
        raise ValueError(f"{K} slots are not whole chunks of {n_kf}")
    r0s, c0s = _snap_align(wy0, wx0, geom)
    sched = track_schedule(beams, x, y, yaw_deg, ox, oy, do, rsy, rsx, cfg,
                           geom, r0s, c0s)
    snaps = torch.zeros((B, K) + _snap_dims(geom), dtype=torch.int8,
                        device=x.device)
    return grids.clone(memory_format=torch.contiguous_format), sched, snaps


def map_snap(grids, beams, x, y, yaw_deg, ox, oy, do, rsy, rsx, wy0, wx0,
             n_kf: int, cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM):
    """map_chunk_sched over K keyframe slots [B, K] (K a multiple of n_kf)
    that also snapshots, at the start of every chunk of n_kf slots (after
    its recenter, before its rays), the slab around each of the chunk's
    match windows (wy0, wx0) [B, K], given in the chunk-start origin's
    frame.  Returns (new grids, snaps int8 [B, K, win_rows+8, 2*win_cols]);
    the match window sits at (wy0 - r0s, wx0 - c0s) in its slab
    (_snap_align)."""
    g, sched, snaps = _snap_operands(grids, beams, x, y, yaw_deg, ox, oy, do,
                                     rsy, rsx, wy0, wx0, n_kf, cfg, geom)
    return replay_exact_snap(g, sched, snaps, n_kf, cfg, geom), snaps


def map_snap_plain(grids, beams, x, y, yaw_deg, ox, oy, do, rsy, rsx, wy0,
                   wx0, n_kf: int, cfg: PipelineConfig,
                   geom: GridGeom = DEFAULT_GEOM):
    """map_snap through replay_exact_plain on any device (the kernel's
    plain twin, for the checks)."""
    g, sched, snaps = _snap_operands(grids, beams, x, y, yaw_deg, ox, oy, do,
                                     rsy, rsx, wy0, wx0, n_kf, cfg, geom)
    return replay_exact_plain(g, sched, cfg, geom, snaps, n_kf), snaps
