"""Correlative scan matching in PyTorch (counterpart of
micro_quad_slam_tpu/ops/scanmatch.py): refine a pose guess against an
occupancy grid by scoring a static lattice of candidate poses
(translations x rotations around the guess) in one shot.  Every candidate
sums the int8 log-odds under its 32 beam endpoints; the argmax wins and a
per-axis quadratic fit gives sub-cell resolution.

The lattice is separable: the world offsets shift x and y independently,
so a beam's endpoint column depends on (yaw, beam, tx) and its row on
(yaw, beam, ty).  `_lattice_cells` computes those cells once, the one
index definition every scorer shares.  Scoring is a masked gather and a
sum over the beams (ops/matchlattice.py): the TPU's one-hot matmuls are
not needed on the GPU.  Every summand is an int8 value and a score sums
at most 32 of them, so the float32 score is exact in any order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.ops.matchlattice import match_lattice
from micro_quad_slam_tpu_torch.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    _cos_f32,
    _f,
    _sin_f32,
    cut_windows,
    world_to_cell,
)
from micro_quad_slam_tpu_torch.utils.config import MapConfig, TofConfig

_F32 = np.float32
_DEG2RAD = _f(np.pi / 180.0)


def _assert_window_fits(cfg: MapConfig, geom: GridGeom, n_xy: int,
                        xy_step_m: float) -> None:
    """Every reachable candidate endpoint cell must fall inside the
    [win_rows, win_cols] window centred on the pose cell: beam reach +
    translation-search radius + rounding must fit the half-window
    margins, or the out-of-window cells would silently score 0."""
    search_cells = int(np.ceil((n_xy - 1) / 2 * xy_step_m / cfg.res_m))
    reach = cfg.max_ray_cells + search_cells + 1   # +1 lrintf rounding
    if reach > min(geom.win_rows // 2, geom.win_cols // 2 - 1):
        raise ValueError(
            f"scan-match window too small: beam reach {cfg.max_ray_cells} "
            f"+ search {search_cells} cells exceeds the "
            f"[{geom.win_rows}, {geom.win_cols}] window margins; enlarge "
            f"GridGeom.win_rows/win_cols for this MapConfig")


class MatchResult(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    yaw_deg: torch.Tensor
    score: torch.Tensor      # best lattice score (sum of endpoint log-odds)
    quality: torch.Tensor    # peak minus mean score per hit beam


def _endpoints_world(beams, x, y, yaw_deg, tof: TofConfig):
    """Hit endpoints (ex, ey) [..., 32] and the hit mask [..., 32] of
    scans beams [..., 4, 8] at poses [...] (the mapper's fan geometry,
    uav_local_nav.c:280-301)."""
    dev = beams.device
    half_fov = _F32(tof.half_fov_deg)
    u = (np.arange(8, dtype=np.float32) - _F32(3.5)) / _F32(3.5)
    col = torch.from_numpy(u * half_fov).to(dev)
    centers = torch.from_numpy(
        np.asarray(tof.dir_center_deg, np.float32)).to(dev)
    lead = beams.shape[:-2]
    dist = beams.reshape(lead + (4, 8))
    hit = (~torch.isnan(dist) & (dist > _f(tof.map_skip_below_m))
           & (dist < _f(_F32(tof.max_range_m) - _F32(tof.hit_margin_m))))
    d = torch.where(hit, dist, torch.zeros_like(dist))
    e2 = lambda a: a[..., None, None]                                # noqa: E731
    ang = ((e2(yaw_deg) + centers[:, None]) + col[None, :]) * _DEG2RAD
    ex = e2(x) + d * _cos_f32(ang)
    ey = e2(y) + d * _sin_f32(ang)
    flat = lambda a: a.reshape(lead + (32,))                         # noqa: E731
    return flat(ex), flat(ey), flat(hit)


def lattice_offsets(n: int, step: float, device=None) -> torch.Tensor:
    """(arange(n) - (n - 1) / 2) * step in float32, as numpy computes it."""
    o = (np.arange(n, dtype=np.float32) - (n - 1) / 2) * _F32(step)
    return torch.from_numpy(o.astype(np.float32)).to(device)


def _lattice_cells(beams, x_guess, y_guess, yaw_guess_deg, origin_x,
                   origin_y, cfg: MapConfig, tof: TofConfig, n_xy: int,
                   n_yaw: int, xy_step_m: float, yaw_step_deg: float):
    """Candidate endpoint cells of the (n_yaw, n_xy, n_xy) lattice for N
    scans: beams [N, 4, 8], the rest [N].  Returns (cy [N, Y, 32, Ty],
    cx [N, Y, 32, Tx], iny, inx (in the logical grid), hit [N, Y, 32])."""
    dev = beams.device
    offs_xy = lattice_offsets(n_xy, xy_step_m, dev)
    offs_yaw = lattice_offsets(n_yaw, yaw_step_deg, dev)
    yaw = yaw_guess_deg[:, None] + offs_yaw                      # [N, Y]
    bY = beams[:, None].expand(-1, n_yaw, -1, -1)
    ex, ey, hit = _endpoints_world(bY, x_guess[:, None].expand_as(yaw),
                                   y_guess[:, None].expand_as(yaw), yaw, tof)
    ex = ex[..., None] + offs_xy                                 # [N, Y, 32, T]
    ey = ey[..., None] + offs_xy
    o = lambda a: a[:, None, None, None]                         # noqa: E731
    cx, cy = world_to_cell(ex, ey, o(origin_x), o(origin_y), cfg.res_m,
                           cfg.width // 2, cfg.height // 2)
    iny = (cy >= 0) & (cy < cfg.height)
    inx = (cx >= 0) & (cx < cfg.width)
    return cy, cx, iny, inx, hit


def window_origin(pcx, pcy, geom: GridGeom = DEFAULT_GEOM):
    """Padded-grid top-left cell (wy0, wx0) of the [win_rows, win_cols]
    match window centred on pose cell (pcx, pcy)."""
    wy0 = (pcy + geom.pad - geom.win_rows // 2).clamp(
        0, geom.prows - geom.win_rows)
    wx0 = (pcx + geom.pad - geom.win_cols // 2).clamp(
        0, geom.pcols - geom.win_cols)
    return wy0, wx0


def lattice_indices(cells, r0s, c0s, geom: GridGeom):
    """_lattice_cells' output -> the slab-relative row and column indices
    the lattice kernel takes: ry, rx int32 [N, Y*T, 32] with rows ordered
    (yaw, candidate), -1 where the endpoint is off the logical grid or
    (rows) the beam did not hit."""
    cy, cx, iny, inx, hit = cells
    N = cy.shape[0]
    m1 = torch.full_like(cy, -1)
    ry = torch.where(iny & hit[..., None],
                     cy + geom.pad - r0s[:, None, None, None], m1)
    rx = torch.where(inx, cx + geom.pad - c0s[:, None, None, None], m1)
    pk = lambda a: a.transpose(2, 3).reshape(N, -1, 32).to(torch.int32)  # noqa: E731
    return pk(ry).contiguous(), pk(rx).contiguous()


def match_slabs(slabs, r0s, c0s, beams, x_guess, y_guess, yaw_guess_deg,
                origin_x, origin_y, cfg: MapConfig = MapConfig(),
                tof: TofConfig = TofConfig(), geom: GridGeom = DEFAULT_GEOM,
                n_xy: int = 7, n_yaw: int = 7, xy_step_m: float = 0.05,
                yaw_step_deg: float = 1.0) -> MatchResult:
    """Flat batch of N matches against slabs int8 [N, SR, SC] whose top-left
    padded-grid cells are (r0s, c0s) int [N]; every other argument is [N]
    (beams [N, 4, 8]).  The scores come from one lattice-kernel launch
    (ops/matchlattice.py::match_lattice) on a CUDA tensor.  Equal to
    match_window over the windows the slabs cover: every in-grid candidate
    cell falls inside the match window (`_assert_window_fits`)."""
    _assert_window_fits(cfg, geom, n_xy, xy_step_m)
    cells = _lattice_cells(beams, x_guess, y_guess, yaw_guess_deg, origin_x,
                           origin_y, cfg, tof, n_xy, n_yaw, xy_step_m,
                           yaw_step_deg)
    ry, rx = lattice_indices(cells, r0s, c0s, geom)
    scores = match_lattice(slabs, ry, rx, n_yaw)              # [N, Y, Ty, Tx]
    return _peak_result(scores.transpose(2, 3), cells[4], x_guess, y_guess,
                        yaw_guess_deg, xy_step_m, yaw_step_deg)


def match_window(window, wy0, wx0, beams, x_guess, y_guess, yaw_guess_deg,
                 origin_x, origin_y, cfg: MapConfig = MapConfig(),
                 tof: TofConfig = TofConfig(), geom: GridGeom = DEFAULT_GEOM,
                 n_xy: int = 7, n_yaw: int = 7, xy_step_m: float = 0.05,
                 yaw_step_deg: float = 1.0) -> MatchResult:
    """match_scan against windows [N, win_rows, win_cols] whose top-left
    padded-grid cells are (wy0, wx0): cells outside a window read as 0
    (unknown), the semantics the loop-closure stage needs when it matches
    against one keyframe's local map."""
    return match_slabs(window, wy0, wx0, beams, x_guess, y_guess,
                       yaw_guess_deg, origin_x, origin_y, cfg, tof, geom,
                       n_xy, n_yaw, xy_step_m, yaw_step_deg)


def match_scan(padded_grid, beams, x_guess, y_guess, yaw_guess_deg,
               origin_x, origin_y, cfg: MapConfig = MapConfig(),
               tof: TofConfig = TofConfig(), geom: GridGeom = DEFAULT_GEOM,
               n_xy: int = 7, n_yaw: int = 7, xy_step_m: float = 0.05,
               yaw_step_deg: float = 1.0) -> MatchResult:
    """Score the (n_yaw * n_xy^2) candidate poses of N scans against padded
    grids [N, PR, PC] and return the refined poses."""
    pcx, pcy = world_to_cell(x_guess, y_guess, origin_x, origin_y,
                             cfg.res_m, cfg.width // 2, cfg.height // 2)
    wy0, wx0 = window_origin(pcx, pcy, geom)
    window = cut_windows(padded_grid, wy0, wx0, geom.win_rows, geom.win_cols)
    return match_window(window.contiguous(), wy0, wx0, beams, x_guess,
                        y_guess, yaw_guess_deg, origin_x, origin_y, cfg, tof,
                        geom, n_xy, n_yaw, xy_step_m, yaw_step_deg)


def _subcell(arr, idx, step: float):
    """Quadratic peak interpolation along one lattice axis, clamped at the
    edges: arr [N, n], idx [N] -> offset [N] (world units)."""
    n = arr.shape[1]
    i0 = idx.clamp(1, n - 2)
    at = lambda i: arr.gather(1, i[:, None])[:, 0]                # noqa: E731
    ym, y0, yp = at(i0 - 1), at(i0), at(i0 + 1)
    denom = ym - 2 * y0 + yp
    d = torch.where(denom.abs() > _f(1e-6), 0.5 * (ym - yp) / denom,
                    torch.zeros_like(denom))
    d = d.clamp(-1.0, 1.0)
    interior = (idx >= 1) & (idx <= n - 2)
    return ((idx.to(torch.float32) + torch.where(interior, d,
                                                 torch.zeros_like(d))
             - (n - 1) / 2) * _f(step))


def _peak_result(scores, hit, x_guess, y_guess, yaw_guess_deg,
                 xy_step_m: float, yaw_step_deg: float) -> MatchResult:
    """scores [N, Y, Tx, Ty], hit [N, Y, 32] -> MatchResult [N]: the first
    argmax of the flat [Y, Tx, Ty] order, a per-axis quadratic sub-cell
    refinement, and the peak-minus-mean quality per hit beam."""
    N, Y, TX, TY = scores.shape
    flat = scores.reshape(N, -1)
    best = torch.argmax(flat, dim=1)
    iy = torch.div(best, TX * TY, rounding_mode="floor")
    ix = torch.div(best, TY, rounding_mode="floor") % TX
    it = best % TY
    n = torch.arange(N, device=scores.device)
    dyaw = _subcell(scores[n, :, ix, it], iy, yaw_step_deg)
    dx = _subcell(scores[n, iy, :, it], ix, xy_step_m)
    dy = _subcell(scores[n, iy, ix, :], it, xy_step_m)
    nhit = hit.sum(-1)[n, iy].to(torch.float32).clamp_min(1.0)
    peak = flat[n, best]
    # the mean as sum / count: CUDA's mean multiplies by 1 / count
    mean = flat.sum(dim=1) / flat.new_full((), flat.shape[1])
    quality = (peak - mean) / nhit
    return MatchResult(x=x_guess + dx, y=y_guess + dy,
                       yaw_deg=yaw_guess_deg + dyaw, score=peak,
                       quality=quality)
