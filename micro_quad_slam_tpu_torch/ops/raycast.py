"""Scan -> log-odds grid update in PyTorch: the plain tensor version of the
exact mapping update (counterpart of micro_quad_slam_tpu/ops/raycast.py).

The semantics are the reference's (raycast_update / map_update_from_beams,
uav_local_nav.c:241-306), re-derived as dense window work exactly as the
JAX module does:

1.  A ray is cast only when both its pose cell and its endpoint cell lie
    in the logical grid, so a Bresenham walk never leaves the grid and
    validity is one predicate per ray.
2.  All 32 rays of a scan live in a [win_rows, win_cols] window centred
    on the pose cell; the grid is padded so the window is never clipped.
3.  The err = dx+dy Bresenham visits one cell per dominant-axis step, at
    minor offset m(k) = (2*k*dmin + dmaj) // (2*dmaj), so membership of a
    window cell in a ray is one integer compare.
4.  The per-step clamp is applied after every ray, in ray order, over
    the whole window.  The JAX module instead recovers it from the prefix
    extrema of the delta sum with int8 carries (Skorokhod form), which is
    exact only while a cell's swing within one scan stays inside the clamp
    range.  Beams just over 5 cm can end up to 32 rays in the pose cell
    (+192); there the JAX grid differs from the reference C (ROADMAP.md
    section C).  Clamping per ray costs the same and is the reference's
    semantics for every input, as the CUDA kernel's per-ray walk is.

Functions take a leading batch dimension [N] where the JAX module uses
`vmap`.  Integer casts of rounded floats saturate and send NaN to 0, as
XLA's conversion does, so out-of-grid poses give the same cell indices on
every device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from micro_quad_slam_tpu_torch.utils.config import MapConfig, TofConfig
from micro_quad_slam_tpu_torch.utils.device import as_device

_F32 = np.float32
_DEG2RAD = _F32(np.pi) / _F32(180.0)
_I32_MAX = 2147483647


@dataclass(frozen=True)
class GridGeom:
    """Static padded-grid geometry derived from a MapConfig (field for
    field the JAX package's GridGeom, ops/raycast.py:59-83)."""

    width: int = 500           # logical cells (x)
    height: int = 500          # logical cells (y)
    pad: int = 48              # logical origin offset inside padded array
    win_r: int = 44            # window radius in cells (>= max ray + rounding)
    win_rows: int = 96         # padded window rows (y), multiple of 8
    win_cols: int = 128        # padded window cols (x), multiple of 128
    prows: int = 608           # padded grid rows
    pcols: int = 640           # padded grid cols

    @classmethod
    def from_map(cls, cfg: MapConfig) -> "GridGeom":
        r = cfg.max_ray_cells + 4
        win_rows = -(-(2 * r + 1) // 8) * 8
        win_cols = -(-(2 * r + 1) // 128) * 128
        pad = r + 4
        prows = -(-(cfg.height + pad + (win_rows - r)) // 32) * 32
        pcols = -(-(cfg.width + pad + (win_cols - r)) // 128) * 128
        return cls(cfg.width, cfg.height, pad, r, win_rows, win_cols, prows, pcols)


DEFAULT_GEOM = GridGeom()


def _f(x) -> float:
    """A Python float holding exactly the float32 value of x, so that torch
    casts it to float32 without a second rounding."""
    return float(_F32(x))


def new_padded_grid(geom: GridGeom = DEFAULT_GEOM, batch: tuple = (),
                    device=None) -> torch.Tensor:
    """Zero padded grids [*batch, PR, PC] on `device` (the CUDA device
    unless told otherwise, utils/device.py::as_device)."""
    return torch.zeros(batch + (geom.prows, geom.pcols), dtype=torch.int8,
                       device=as_device(device))


def logical_grid(padded: torch.Tensor, geom: GridGeom = DEFAULT_GEOM) -> torch.Tensor:
    """Slice the logical HxW grid out of the padded array."""
    return padded[..., geom.pad: geom.pad + geom.height,
                  geom.pad: geom.pad + geom.width]


def _round_to_i32(v: torch.Tensor) -> torch.Tensor:
    """round-half-even to int32 with XLA's conversion rules: NaN -> 0,
    out-of-range values saturate."""
    r = torch.round(v)
    hi = r >= 2147483648.0
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    i = r.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(hi, torch.full_like(i, _I32_MAX), i)


def _cos_f32(ang: torch.Tensor) -> torch.Tensor:
    """cos of a float32 angle, correctly rounded to float32 (what a C cosf
    gives), by way of float64.  torch's float32 CPU cos/sin are not
    reproducible in the last bit: the first call in a process sometimes
    differs from later calls on the same input, which moved a ray's
    endpoint cell in about one process in four.  The float64 route gives
    the same bits on every call, and the same as on the card."""
    return torch.cos(ang.double()).float()


def _sin_f32(ang: torch.Tensor) -> torch.Tensor:
    """sin counterpart of _cos_f32."""
    return torch.sin(ang.double()).float()


def div_f32(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d rounded once, on every device.  CUDA turns a division by a
    Python scalar into a product with its reciprocal, which rounds apart
    from the quotient the CPU (and C) gives; a divisor on a's own device
    does not."""
    return a / a.new_full((), d)


def sqrt_f32(a: torch.Tensor) -> torch.Tensor:
    """sqrt of float32, correctly rounded to float32 on every device by
    way of float64: torch's float32 sqrt is not correctly rounded on the
    CPU (AVX-512: 0.6% of random inputs a last bit off) nor on the card,
    and the two differ."""
    return torch.sqrt(a.double()).float()


def world_to_cell(x, y, origin_x, origin_y, res: float,
                  half_w: int = 250, half_h: int = 250):
    """Cell indices with lrintf (round-half-even) semantics; the map origin
    sits at the grid center (uav_local_nav.c:205-214).  Returns (cx, cy)
    int32, unbounded."""
    res = _f(res)
    cx = _round_to_i32(div_f32(x - origin_x, res)) + half_w
    cy = _round_to_i32(div_f32(y - origin_y, res)) + half_h
    return cx, cy


def make_rays(
    beams: torch.Tensor,
    x_m: torch.Tensor,
    y_m: torch.Tensor,
    yaw_deg: torch.Tensor,
    origin_x: torch.Tensor,
    origin_y: torch.Tensor,
    enabled: torch.Tensor,
    cfg: MapConfig = MapConfig(),
    tof: TofConfig = TofConfig(),
):
    """Project scans' beams [..., 4, 8] to window-relative ray endpoints.

    Mirrors map_update_from_beams (uav_local_nav.c:280-306) in float32:
    skip NaN and <=0.05 m beams, hit iff dist < max_range-0.05, clamp to
    max_range, fan angle = yaw + dir_center + ((c-3.5)/3.5)*half_fov.
    The pose tensors have the beams' leading shape [...].

    Returns a dict of [..., 32] tensors (ray order F0..F7, R0..R7, B0..B7,
    L0..L7):
      ex, ey    int32 window-relative endpoint cells
      end_delta int32 endpoint log-odds delta (+occ_inc hit / -miss_dec)
      valid     bool
    plus [...] pose cells pcx, pcy (int32, clamped into the logical grid;
    rays are invalid when the true pose cell is out of the grid).
    """
    dev = beams.device
    half_fov = _F32(tof.fov_deg) * _F32(0.5)
    u = (np.arange(8, dtype=np.float32) - _F32(3.5)) / _F32(3.5)
    col_off = torch.from_numpy(u * half_fov).to(dev)                  # f32 [8]
    centers = torch.from_numpy(
        np.asarray(tof.dir_center_deg, np.float32)).to(dev)           # f32 [4]

    lead = beams.shape[:-2]
    dist = beams.reshape(lead + (4, 8))
    ray_ok = ~torch.isnan(dist) & (dist > _f(tof.map_skip_below_m))
    hit = dist < _f(_F32(tof.max_range_m) - _F32(tof.hit_margin_m))
    d = torch.where(ray_ok, dist, torch.zeros_like(dist)).clamp_max(
        _f(tof.max_range_m))

    e2 = lambda a: a[..., None, None]                                   # noqa: E731
    ang_deg = (e2(yaw_deg) + centers[:, None]) + col_off[None, :]
    ang = ang_deg * _f(_DEG2RAD)
    ex_w = e2(x_m) + d * _cos_f32(ang)
    ey_w = e2(y_m) + d * _sin_f32(ang)

    hw, hh = cfg.width // 2, cfg.height // 2
    pcx, pcy = world_to_cell(x_m, y_m, origin_x, origin_y, cfg.res_m, hw, hh)
    ecx, ecy = world_to_cell(ex_w, ey_w, e2(origin_x), e2(origin_y),
                             cfg.res_m, hw, hh)

    pose_in = (pcx >= 0) & (pcx < cfg.width) & (pcy >= 0) & (pcy < cfg.height)
    end_in = (ecx >= 0) & (ecx < cfg.width) & (ecy >= 0) & (ecy < cfg.height)
    valid = ray_ok & end_in & e2(pose_in) & e2(enabled)

    pcx_safe = pcx.clamp(0, cfg.width - 1)
    pcy_safe = pcy.clamp(0, cfg.height - 1)

    zero = torch.zeros_like(ecx)
    ex = torch.where(valid, ecx - e2(pcx_safe), zero)
    ey = torch.where(valid, ecy - e2(pcy_safe), zero)
    end_delta = torch.where(hit, cfg.lo_occ_inc, -cfg.lo_miss_end_dec)
    flat = lambda a: a.reshape(lead + (32,))                            # noqa: E731
    return {
        "ex": flat(ex),
        "ey": flat(ey),
        "end_delta": flat(end_delta.to(torch.int32)),
        "valid": flat(valid),
        "pcx": pcx_safe,
        "pcy": pcy_safe,
    }


def window_scan_update(
    window: torch.Tensor, rays: dict, cfg: MapConfig = MapConfig(),
    geom: GridGeom = DEFAULT_GEOM,
) -> torch.Tensor:
    """Apply each scan's 32 rays to its [win_rows, win_cols] int8 window
    centered at (win_r, win_r), with the reference's sequential clamp:
    every cell of ray r becomes clamp(v + d, lo_min, lo_max), rays in
    order F0..L7, cells off the ray untouched.

    window: int8 [N, win_rows, win_cols]; rays: ex/ey/end_delta/valid
    [N, 32].  Returns the updated windows."""
    dev = window.device
    R = geom.win_r
    rows = (torch.arange(geom.win_rows, dtype=torch.int32, device=dev) - R)[:, None]
    colr = (torch.arange(geom.win_cols, dtype=torch.int32, device=dev) - R)[None, :]

    free = torch.tensor(-cfg.lo_free_dec, dtype=torch.int16, device=dev)
    sent = torch.tensor(127, dtype=torch.int32, device=dev)  # masks non-membership
    one = torch.ones((), dtype=torch.int32, device=dev)

    N = window.shape[0]
    v = window.to(torch.int16)
    col = lambda a, r: a[:, r].reshape(N, 1, 1)                          # noqa: E731
    for r in range(32):
        ex, ey = col(rays["ex"], r), col(rays["ey"], r)
        ed = col(rays["end_delta"], r).to(torch.int16)
        val = col(rays["valid"], r)
        dx, dy = ex.abs(), ey.abs()
        sx = torch.where(ex > 0, one, -one)
        sy = torch.where(ey > 0, one, -one)
        kx = colr * sx            # [N, 1, C]
        ky = rows * sy            # [N, R, 1]
        xmaj = dx >= dy
        # minor-axis offset along the dominant axis (closed-form
        # Bresenham), sentinel-masked outside the ray extent / when the
        # ray is invalid or the other axis is dominant
        mX = torch.div(2 * kx * dy + dx, torch.clamp_min(2 * dx, 1),
                       rounding_mode="floor")
        mY = torch.div(2 * ky * dx + dy, torch.clamp_min(2 * dy, 1),
                       rounding_mode="floor")
        okX = (kx >= 0) & (kx <= dx) & xmaj & val
        okY = (ky >= 0) & (ky <= dy) & ~xmaj & val
        mX = torch.where(okX, mX, sent)
        mY = torch.where(okY, mY, sent)
        member = (ky == mX) | (kx == mY)                                # [N, R, C]
        is_end = (colr == ex) & (rows == ey)
        stepped = (v + torch.where(is_end, ed, free)).clamp(cfg.lo_min, cfg.lo_max)
        v = torch.where(member, stepped, v)
    return v.to(torch.int8)


def _window_index(pcx, pcy, geom: GridGeom):
    """Advanced-index triple selecting each scan's window in [N, PR, PC]."""
    dev = pcx.device
    r0 = pcy.long() + (geom.pad - geom.win_r)
    c0 = pcx.long() + (geom.pad - geom.win_r)
    rr = r0[:, None] + torch.arange(geom.win_rows, device=dev)
    cc = c0[:, None] + torch.arange(geom.win_cols, device=dev)
    n = torch.arange(pcx.shape[0], device=dev)
    return n[:, None, None], rr[:, :, None], cc[:, None, :]


def cut_windows(padded_grids, wy0, wx0, rows: int, cols: int):
    """[N, rows, cols] slices of padded grids [N, PR, PC] at (wy0, wx0)."""
    dev = padded_grids.device
    rr = wy0.long()[:, None] + torch.arange(rows, device=dev)
    cc = wx0.long()[:, None] + torch.arange(cols, device=dev)
    n = torch.arange(padded_grids.shape[0], device=dev)
    return padded_grids[n[:, None, None], rr[:, :, None], cc[:, None, :]]


def apply_rays_(padded_grid: torch.Tensor, rays: dict,
                cfg: MapConfig = MapConfig(),
                geom: GridGeom = DEFAULT_GEOM) -> torch.Tensor:
    """Window read -> window_scan_update -> write back, for a batch of
    scans whose rays are already made.  Updates padded_grid [N, PR, PC]
    IN PLACE (the replay loops own their grid; a copy per frame would
    stream the whole batch of grids once more) and returns it."""
    idx = _window_index(rays["pcx"], rays["pcy"], geom)
    padded_grid[idx] = window_scan_update(padded_grid[idx], rays, cfg, geom)
    return padded_grid


def apply_scan_to_grid(
    padded_grid: torch.Tensor,
    beams: torch.Tensor,
    x_m, y_m, yaw_deg,
    origin_x, origin_y,
    enabled,
    cfg: MapConfig = MapConfig(),
    tof: TofConfig = TofConfig(),
    geom: GridGeom = DEFAULT_GEOM,
) -> torch.Tensor:
    """One fused scan update per quad: beams -> rays -> window
    read-modify-write.  padded_grid int8 [N, PR, PC], beams f32 [N, 4, 8],
    the rest [N].  Returns a new grid."""
    rays = make_rays(beams, x_m, y_m, yaw_deg, origin_x, origin_y,
                     enabled, cfg, tof)
    return apply_rays_(padded_grid.clone(), rays, cfg, geom)


def recenter_constants(cfg: MapConfig) -> tuple:
    """recenter_decide's constants: the float32 threshold (m) and cell
    size (m) as Python floats, and the shift clamp (cells)."""
    half = _F32(cfg.size_m) * _F32(0.5)
    return (_f(half * _F32(cfg.recenter_frac)), _f(cfg.res_m),
            cfg.recenter_max_shift_cells)


def recenter_decide(
    origin_x, origin_y, x_m, y_m, pose_ok, cfg: MapConfig = MapConfig(),
):
    """Cheap scalar part of map recentering (uav_local_nav.c:324-343):
    shift cells (sx, sy) clamped to +/-recenter_max_shift_cells, and the
    `do` flag.  Zero shift when not recentering."""
    thresh, res, mx = recenter_constants(cfg)
    dx = x_m - origin_x
    dy = y_m - origin_y
    need = pose_ok & ((dx.abs() >= thresh) | (dy.abs() >= thresh))

    sx = _round_to_i32(div_f32(dx, res)).clamp(-mx, mx)
    sy = _round_to_i32(div_f32(dy, res)).clamp(-mx, mx)
    do = need & ((sx != 0) | (sy != 0))
    zero = torch.zeros_like(sx)
    return torch.where(do, sx, zero), torch.where(do, sy, zero), do


def shift_origin(origin, s_cells, res):
    """origin + s_cells * res with the product pinned to its own f32
    rounding step.  The select is value-identity (origin is NaN only
    before map init, where NaN + anything = NaN anyway) but keeps a fusing
    compiler from contracting the mul+add into an fma, which would skew
    the origins by an ulp against the reference."""
    prod = torch.where(origin == origin, s_cells.to(torch.float32) * _f(res),
                       origin)
    return origin + prod


def recenter_apply(
    padded_grid: torch.Tensor, sx, sy,
    cfg: MapConfig = MapConfig(), geom: GridGeom = DEFAULT_GEOM,
) -> torch.Tensor:
    """Expensive part: whole-cell grid shift new[y, x] = old[y+sy, x+sx]
    (uav_local_nav.c:308-322) per quad, zero where the source falls outside
    the logical region; margins stay zero.  padded_grid int8 [N, PR, PC],
    sx/sy int [N]; (sx, sy) == (0, 0) is an exact no-op.  Returns a new
    grid.  Callers branch around this: recentering is rare, and it
    touches every grid of the batch."""
    dev = padded_grid.device
    N, PR, PC = padded_grid.shape
    sx = sx.long().reshape(N)
    sy = sy.long().reshape(N)
    r_ids = torch.arange(PR, device=dev)
    c_ids = torch.arange(PC, device=dev)
    # jnp.roll(g, -s) reads g[(i + s) mod n]: two gathers with broadcast
    # (not materialized) index tensors
    ri = (r_ids[None, :] + sy[:, None]) % PR                            # [N, PR]
    ci = (c_ids[None, :] + sx[:, None]) % PC                            # [N, PC]
    rolled = torch.gather(padded_grid, 1, ri[:, :, None].expand(N, PR, PC))
    rolled = torch.gather(rolled, 2, ci[:, None, :].expand(N, PR, PC))

    def inside(ids, lo, n):
        return (ids >= lo) & (ids < lo + n)

    rs = r_ids[None, :] + sy[:, None]
    cs = c_ids[None, :] + sx[:, None]
    row_ok = inside(r_ids, geom.pad, geom.height)[None, :] & inside(
        rs, geom.pad, geom.height)                                      # [N, PR]
    col_ok = inside(c_ids, geom.pad, geom.width)[None, :] & inside(
        cs, geom.pad, geom.width)                                       # [N, PC]
    keep = row_ok[:, :, None] & col_ok[:, None, :]
    return torch.where(keep, rolled, torch.zeros((), dtype=torch.int8, device=dev))


def recenter_grid(
    padded_grid: torch.Tensor,
    origin_x, origin_y,
    x_m, y_m,
    pose_ok,
    cfg: MapConfig = MapConfig(),
    geom: GridGeom = DEFAULT_GEOM,
):
    """Conditional whole-cell grid shift (uav_local_nav.c:324-353) of a
    batch: recenter_decide, then recenter_apply on the quads that
    recenter.  padded_grid [N, PR, PC], the rest [N].  Returns (grid,
    origin_x, origin_y, recentered flag); the inputs are left as they
    were."""
    sx, sy, do = recenter_decide(origin_x, origin_y, x_m, y_m, pose_ok, cfg)
    shifted = recenter_apply(padded_grid, sx, sy, cfg, geom)
    grid = torch.where(do[:, None, None], shifted, padded_grid)
    res = _f(cfg.res_m)
    origin_x = torch.where(do, origin_x + sx.to(torch.float32) * res, origin_x)
    origin_y = torch.where(do, origin_y + sy.to(torch.float32) * res, origin_y)
    return grid, origin_x, origin_y, do


def _frontier_step_dists(cfg: MapConfig) -> np.ndarray:
    """Reproduce the C loop `for (d = step; d <= max_range; d += step)` with
    float32 accumulation: the step count is float-sensitive
    (uav_local_nav.c:370).  Host numpy, as the JAX module does it."""
    step = _F32(cfg.res_m) * _F32(cfg.frontier_step_cells)
    out = []
    d = step
    while d <= _F32(cfg.frontier_range_m):
        out.append(d)
        d = _F32(d + step)
    return np.asarray(out, np.float32)


def frontier_scores(
    padded_grid: torch.Tensor,
    x_m, y_m, yaw_deg,
    offsets_deg,
    origin_x, origin_y,
    inited,
    cfg: MapConfig = MapConfig(),
    geom: GridGeom = DEFAULT_GEOM,
) -> torch.Tensor:
    """frontier_score_dir (uav_local_nav.c:356-385) for several query
    directions of a batch of quads at once.

    padded_grid int8 [N, PR, PC]; poses, origins and inited [N];
    offsets_deg a static sequence of D query offsets (e.g. (0, 90, -90,
    180)).  Each direction casts cfg.frontier_ray_offsets_deg's 3 rays of
    S steps; the [N, D, 3, S] cells are read with one gather.  A ray
    stepping out of the logical grid stops contributing from that step on
    (lines are monotone, so the C `break` equals masking every step out of
    the grid).  Returns int32 [N, D] scores."""
    dev = padded_grid.device
    offs = torch.from_numpy(np.asarray(offsets_deg, np.float32)).to(dev)
    rays = torch.from_numpy(
        np.asarray(cfg.frontier_ray_offsets_deg, np.float32)).to(dev)
    dists = torch.from_numpy(_frontier_step_dists(cfg)).to(dev)      # [S]

    e = lambda a: a[:, None, None, None]                              # noqa: E731
    ang = ((yaw_deg[:, None] + offs[None, :])[:, :, None]
           + rays[None, None, :]) * _f(_DEG2RAD)                       # [N, D, 3]
    ca, sa = _cos_f32(ang), _sin_f32(ang)
    px = e(x_m) + dists * ca[..., None]                               # [N, D, 3, S]
    py = e(y_m) + dists * sa[..., None]
    cx, cy = world_to_cell(px, py, e(origin_x), e(origin_y), cfg.res_m,
                           cfg.width // 2, cfg.height // 2)
    inb = (cx >= 0) & (cx < cfg.width) & (cy >= 0) & (cy < cfg.height)
    cxs = cx.clamp(0, cfg.width - 1).long() + geom.pad
    cys = cy.clamp(0, cfg.height - 1).long() + geom.pad
    n = torch.arange(padded_grid.shape[0], device=dev)
    v = padded_grid[e(n), cys, cxs].to(torch.int32)                   # [N, D, 3, S]
    m = inb & e(inited)
    band = cfg.frontier_unknown_band
    unknown = (m & (v >= -band) & (v <= band)).sum(dim=(-1, -2))
    occ = (m & (v > cfg.frontier_occ_thresh)).sum(dim=(-1, -2))
    free = (m & (v < cfg.frontier_free_thresh)).sum(dim=(-1, -2))
    return (unknown * cfg.frontier_w_unknown + free * cfg.frontier_w_free
            - occ * cfg.frontier_w_occ).to(torch.int32)
