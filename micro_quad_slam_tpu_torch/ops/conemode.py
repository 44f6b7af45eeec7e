"""Dense inverse-sensor-model map update ("cone mode") and its hybrid
variant, in PyTorch (counterpart of micro_quad_slam_tpu/ops/conemode.py).

Cone mode classifies EVERY cell of the scan window against the scan: free
inside a sensor's 63-degree fan closer than that bearing's measured
distance, occupied in a band at the measured distance of a hitting beam.
Hybrid mode keeps the dense free carve (with the returns eroded by a
min-of-3 over neighbouring columns) and takes its occupied evidence from
the exact path's ray endpoints instead (make_rays, uav_local_nav.c:
286-304).

The classifier is transcendental-free: the bearing sector comes from sign
tests against per-scan fan-boundary unit vectors (`fan_bounds`) and all
range tests compare squared distances in cell units.  Every sign test is
a comparison of two single-rounded products (`p*q > r*t`), and no float
product feeds an add that a compiler could contract into an fma, except
the squared radius `ax*ax + ay*ay`, whose operands are exact integers
whenever the pose sits on a cell centre (the geometry where angular ties
happen).  A 1-ulp difference flips boundary cells there, so the CUDA
kernel (csrc/replay_cone.cu) rounds every product and sum on its own, as
these eager torch ops do.

Functions take a leading batch dimension [N] where the JAX module uses
`vmap`.  `scan_inputs` makes everything a scan contributes from its beams
and pose; `window_update` applies it to the scan windows.  The per-frame
replay (replay/mapping.py) and the whole-replay schedule (ops/conex.py)
share both, so the two paths are bit-identical by construction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from micro_quad_slam_tpu_torch.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    _cos_f32,
    _sin_f32,
    _window_index,
    make_rays,
    world_to_cell,
)
from micro_quad_slam_tpu_torch.utils.config import MapConfig, TofConfig

_F32 = np.float32
_DEG2RAD = _F32(math.pi / 180.0)


def _f(x) -> float:
    """A Python float holding exactly the float32 value of x."""
    return float(_F32(x))


@dataclass(frozen=True)
class ConeConfig:
    """Inverse-model parameters (field for field the JAX package's
    ConeConfig); the log-odds deltas match the reference's per-ray
    constants, so maps are comparable."""

    free_dec: int = 1
    occ_inc: int = 6
    hit_band_m: float = 0.10      # occupied band around the return
    free_margin_m: float = 0.05   # stop free-marking this short of the hit
    # > 0: free-mark only cells within this transverse width (cell units)
    # of their sector's beam-centre line.  The replay modes use the dense
    # default 0; only the per-scan functions here take other values.
    ray_match_w_cells: float = 0.0


def cone_constants(res: float, tof: TofConfig, cone: ConeConfig) -> dict:
    """The classifier's float32 constants, as Python floats holding their
    exact float32 values (the same derivation as the JAX module's)."""
    inv_res = _F32(1.0 / float(res))
    maxr_c = _F32(float(np.float32(tof.max_range_m) * inv_res))
    return {"inv_res": float(inv_res),
            "maxr2": float(_F32(float(maxr_c * maxr_c))),
            "skip": _f(tof.map_skip_below_m),
            "free_margin": _f(cone.free_margin_m),
            "hit_band": _f(cone.hit_band_m)}


def pack_beams(beams32: torch.Tensor, tof: TofConfig) -> torch.Tensor:
    """[..., 32] f32 beam distances -> packed returns: |p| = the clamped
    distance, sign = hit flag, 0.0 = no usable return."""
    d = beams32
    nan = torch.isnan(d)
    hit = (~nan & (d > _f(tof.map_skip_below_m))
           & (d < _f(_F32(tof.max_range_m) - _F32(tof.hit_margin_m))))
    d = torch.where(nan, torch.zeros_like(d), d.clamp_max(_f(tof.max_range_m)))
    return torch.where(hit, d, -d)


def smooth_carve_returns(packed32: torch.Tensor, tof: TofConfig) -> torch.Tensor:
    """Hybrid mode's angular erosion of the carve limit: each column's
    carve distance becomes the min of its own and its two in-fan
    neighbours' valid return distances (fan edges clamp); 0 where the
    column itself has no usable return.  Shape-preserving on [..., 32]."""
    a4 = packed32.abs().reshape(packed32.shape[:-1] + (4, 8))
    valid = a4 > _f(tof.map_skip_below_m)
    big = torch.where(valid, a4, torch.full_like(a4, _f(1e9)))
    left = torch.cat([big[..., :1], big[..., :-1]], dim=-1)
    right = torch.cat([big[..., 1:], big[..., -1:]], dim=-1)
    m = torch.minimum(torch.minimum(left, big), right)
    out = torch.where(valid, m, torch.zeros_like(m))
    return out.reshape(packed32.shape)


def _unit_vectors(yaw_deg: torch.Tensor, offsets) -> torch.Tensor:
    """[..., 2K]: (cos, sin) of (yaw + off_k) * deg2rad for each float32
    offset, each a chain of single-rounded ops; the trig is the correctly
    rounded float32 value (ops/raycast.py::_cos_f32)."""
    out = []
    for off in offsets:
        a = (yaw_deg + _f(off)) * _f(_DEG2RAD)
        out += [_cos_f32(a), _sin_f32(a)]
    return torch.stack(out, dim=-1)


def fan_bounds(yaw_deg: torch.Tensor, tof: TofConfig) -> torch.Tensor:
    """[..., 18] (b0x, b0y, ..., b8x, b8y): unit vectors of the FRONT
    fan's 9 column boundaries, boundary k at bearing yaw - half_fov +
    k * fov/8.  The R/B/L fans need none: the classifier rotates the
    cell vector by exact negate/swap instead."""
    step = float(tof.fov_deg) / 8.0
    return _unit_vectors(yaw_deg, [_F32(-float(tof.half_fov_deg) + step * k)
                                   for k in range(9)])


def fan_centers(yaw_deg: torch.Tensor, tof: TofConfig) -> torch.Tensor:
    """[..., 16] (c0x, c0y, ..., c7x, c7y): unit vectors of the FRONT
    fan's 8 beam directions, u_k = (k - 3.5)/3.5 of the half-FOV
    (uav_local_nav.c:286-289), for the ray-matched carve."""
    return _unit_vectors(yaw_deg, [
        _F32(float(tof.half_fov_deg) * (k - 3.5) / 3.5) for k in range(8)])


def cone_cell_delta(rowsf, colsf, oxc, oyc, res: float, bounds, packed,
                    tof: TofConfig, cone: ConeConfig,
                    with_occ_band: bool = True, centers=None):
    """Per-cell log-odds delta int32 [N, R, C] of N scans, before bounds
    and enable gating.

    rowsf/colsf: f32 [R, 1] / [1, C] window-local cell indices; oxc/oyc:
    f32 [N], so that the pose->cell vector in cell units is (colsf + oxc,
    rowsf + oyc); bounds: f32 [N, 18] (fan_bounds); packed: f32 [N, 32]
    (pack_beams order F0..7, R0..7, B0..7, L0..7); centers: f32 [N, 16]
    (fan_centers) for the ray-matched carve, or None.

    Conventions (as the JAX module): quadrant boundaries go to the higher
    quadrant, column boundaries to the lower column, and the fan end
    (phi == fov) is in the fan."""
    N = oxc.shape[0]
    e = lambda v: v.reshape(N, 1, 1)                                  # noqa: E731
    ax = colsf[None] + e(oxc)                                         # [N, 1, C]
    ay = rowsf[None] + e(oyc)                                         # [N, R, 1]
    b = [e(bounds[:, i]) for i in range(18)]
    ux, uy = b[0], b[1]

    # quadrant of the bearing relative to the fan start: exact signs of
    # the dot and cross products given the rounded products
    pxx, pyy, pxy, pyx = ux * ax, uy * ay, ux * ay, uy * ax
    m0 = (pxx > -pyy) & (pxy >= pyx)
    m1 = ~m0 & (pxy > pyx)
    m2 = ~m0 & ~m1 & (pxx < -pyy)
    d1 = ~m0 & ~m1                        # quadrant in {2, 3}
    d0 = m1 | (d1 & ~m2)                  # quadrant in {1, 3}

    # the cell vector rotated into the quadrant frame (exact negate/swap)
    axq = torch.where(d0, torch.where(d1, -ay, ay), torch.where(d1, -ax, ax))
    ayq = torch.where(d0, torch.where(d1, ax, -ax), torch.where(d1, -ay, ay))

    # 3-level binary search for the fan column: phi > boundary k <=>
    # bx_k * ayq > by_k * axq
    def above(bx, by):
        return bx * ayq > by * axq

    def pick(m, hi, lo):
        return torch.where(m, hi, lo)

    b2 = above(b[8], b[9])
    b1 = above(pick(b2, b[12], b[4]), pick(b2, b[13], b[5]))
    b0 = above(pick(b2, pick(b1, b[14], b[10]), pick(b1, b[6], b[2])),
               pick(b2, pick(b1, b[15], b[11]), pick(b1, b[7], b[3])))
    in_fan = ~above(b[16], b[17])

    # the sector's packed return: the JAX module's 5-level select tree
    # over (d1, d0, b2, b1, b0) is this index
    sector = (16 * d1.long() + 8 * d0.long() + 4 * b2.long() + 2 * b1.long()
              + b0.long())
    sec_p = torch.gather(packed, 1, sector.reshape(N, -1)).reshape(sector.shape)
    sec_d = sec_p.abs()
    sec_hit = sec_p > 0.0
    k = cone_constants(res, tof, cone)
    sec_valid = sec_d > k["skip"]

    rng2 = ax * ax + ay * ay
    dfree = (sec_d - k["free_margin"]).clamp_min(0.0) * k["inv_res"]
    free = (in_fan & sec_valid & (rng2 > 0.0) & (rng2 < dfree * dfree)
            & (rng2 <= k["maxr2"]))
    if centers is not None:
        # ray-matched carve: the squared perpendicular distance to the
        # sector's beam-centre line, gathered through the column tree
        col = (4 * b2.long() + 2 * b1.long() + b0.long()).reshape(N, -1)
        cx = torch.gather(centers[:, 0::2], 1, col).reshape(sector.shape)
        cy = torch.gather(centers[:, 1::2], 1, col).reshape(sector.shape)
        t = cx * ayq - cy * axq
        w = _F32(cone.ray_match_w_cells)
        free = free & (t * t <= float(w * w))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=ax.device)  # noqa: E731
    free_d = torch.where(free, i32(-cone.free_dec), i32(0))
    if not with_occ_band:
        return free_d
    olo = (sec_d - k["hit_band"]).clamp_min(0.0) * k["inv_res"]
    ohi = (sec_d + k["hit_band"]) * k["inv_res"]
    occ = (in_fan & sec_valid & sec_hit & (rng2 >= olo * olo)
           & (rng2 <= ohi * ohi))
    return torch.where(occ, i32(cone.occ_inc), free_d)


def scan_inputs(beams, x_m, y_m, yaw_deg, origin_x, origin_y, enabled,
                cfg: MapConfig = MapConfig(), tof: TofConfig = TofConfig(),
                geom: GridGeom = DEFAULT_GEOM, hybrid: bool = False) -> dict:
    """What N scans contribute, from their beams f32 [N, 4, 8] and poses
    [N]: the pose cell pcx, pcy (int32, clamped into the logical grid;
    the window's corner is that minus win_r), `en` (enabled and the pose
    in the grid), the pose->window-corner offsets oxc, oyc (f32, sub-cell
    fraction included), the fan bounds [N, 18] and packed returns [N, 32]
    (hybrid: smoothed), and for hybrid the exact endpoints ex, ey and
    their deltas ed (int32 [N, 32], 0 for invalid rays)."""
    hw, hh = cfg.width // 2, cfg.height // 2
    pcx, pcy = world_to_cell(x_m, y_m, origin_x, origin_y, cfg.res_m, hw, hh)
    pose_in = (pcx >= 0) & (pcx < cfg.width) & (pcy >= 0) & (pcy < cfg.height)
    en = enabled & pose_in
    pcx = pcx.clamp(0, cfg.width - 1)
    pcy = pcy.clamp(0, cfg.height - 1)
    R = geom.win_r
    res = _f(cfg.res_m)
    fx = (x_m - origin_x) / res + _f(hw)
    fy = (y_m - origin_y) / res + _f(hh)
    packed = pack_beams(beams.reshape(beams.shape[:-2] + (32,)), tof)
    out = {"pcx": pcx, "pcy": pcy, "en": en,
           "oxc": (pcx - R).to(torch.float32) - fx,
           "oyc": (pcy - R).to(torch.float32) - fy,
           "bounds": fan_bounds(yaw_deg, tof)}
    if not hybrid:
        return {**out, "packed": packed}
    rays = make_rays(beams, x_m, y_m, yaw_deg, origin_x, origin_y, en, cfg,
                     tof)
    return {**out, "packed": smooth_carve_returns(packed, tof),
            "ex": rays["ex"], "ey": rays["ey"],
            "ed": torch.where(rays["valid"], rays["end_delta"],
                              torch.zeros_like(rays["end_delta"]))}


def window_update(win: torch.Tensor, inp: dict, cfg: MapConfig = MapConfig(),
                  tof: TofConfig = TofConfig(), geom: GridGeom = DEFAULT_GEOM,
                  cone: ConeConfig = ConeConfig(), centers=None) -> torch.Tensor:
    """Apply N scans (scan_inputs' dict) to their int8 windows [N, WR, WC]
    (corner at the pose cell minus win_r) and return the new windows.
    Every window cell becomes clip(v + d); d is gated by the logical grid
    and `en`.  With endpoints in `inp` (hybrid) the update is two
    clipped stages, v1 = clip(v0 + free carve), then clip(v1 + the sum
    of the endpoint deltas of the rays that end in the cell)."""
    dev = win.device
    R = geom.win_r
    WR, WC = geom.win_rows, geom.win_cols
    rows = torch.arange(WR, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(WC, dtype=torch.int32, device=dev)[None, :]
    hybrid = "ed" in inp
    delta = cone_cell_delta(rows.to(torch.float32), cols.to(torch.float32),
                            inp["oxc"], inp["oyc"], cfg.res_m, inp["bounds"],
                            inp["packed"], tof, cone, with_occ_band=not hybrid,
                            centers=centers)
    e = lambda v: v.reshape(-1, 1, 1)                                 # noqa: E731
    gy = rows + e(inp["pcy"] - R)
    gx = cols + e(inp["pcx"] - R)
    inb = (gy >= 0) & (gy < cfg.height) & (gx >= 0) & (gx < cfg.width)
    delta = torch.where(inb & e(inp["en"]), delta, torch.zeros_like(delta))
    v = (win.to(torch.int32) + delta).clamp(cfg.lo_min, cfg.lo_max)
    if hybrid:
        # endpoints are in the grid (make_rays' validity) and in the
        # window (|ex|, |ey| <= win_r); several rays may share a cell
        idx = ((inp["ey"] + R) * WC + (inp["ex"] + R)).long()
        dend = torch.zeros((v.shape[0], WR * WC), dtype=torch.int32,
                           device=dev).scatter_add_(1, idx, inp["ed"])
        v = (v + dend.reshape(v.shape)).clamp(cfg.lo_min, cfg.lo_max)
    return v.to(torch.int8)


def apply_scans_(padded_grid: torch.Tensor, inp: dict,
                 cfg: MapConfig = MapConfig(), tof: TofConfig = TofConfig(),
                 geom: GridGeom = DEFAULT_GEOM, cone: ConeConfig = ConeConfig(),
                 centers=None) -> torch.Tensor:
    """Window read -> window_update -> write back, IN PLACE on
    padded_grid int8 [N, PR, PC] (the replay loops own their grids)."""
    idx = _window_index(inp["pcx"], inp["pcy"], geom)
    padded_grid[idx] = window_update(padded_grid[idx], inp, cfg, tof, geom,
                                     cone, centers)
    return padded_grid


def _scan_update(padded_grid, beams, x_m, y_m, yaw_deg, origin_x, origin_y,
                 enabled, cfg, tof, geom, cone, hybrid):
    inp = scan_inputs(beams, x_m, y_m, yaw_deg, origin_x, origin_y, enabled,
                      cfg, tof, geom, hybrid)
    centers = (fan_centers(yaw_deg, tof)
               if float(cone.ray_match_w_cells) > 0 else None)
    return apply_scans_(padded_grid.clone(), inp, cfg, tof, geom, cone,
                        centers)


def cone_scan_update(padded_grid, beams, x_m, y_m, yaw_deg, origin_x,
                     origin_y, enabled, cfg: MapConfig = MapConfig(),
                     tof: TofConfig = TofConfig(),
                     geom: GridGeom = DEFAULT_GEOM,
                     cone: ConeConfig = ConeConfig()) -> torch.Tensor:
    """One dense scan update per quad: padded_grid int8 [N, PR, PC],
    beams f32 [N, 4, 8], the rest [N].  Returns a new grid."""
    return _scan_update(padded_grid, beams, x_m, y_m, yaw_deg, origin_x,
                        origin_y, enabled, cfg, tof, geom, cone, False)


def hybrid_scan_update(padded_grid, beams, x_m, y_m, yaw_deg, origin_x,
                       origin_y, enabled, cfg: MapConfig = MapConfig(),
                       tof: TofConfig = TofConfig(),
                       geom: GridGeom = DEFAULT_GEOM,
                       cone: ConeConfig = ConeConfig()) -> torch.Tensor:
    """One HYBRID scan update per quad (the dense free carve, then the
    exact path's endpoint increments), shapes as cone_scan_update.
    Returns a new grid."""
    return _scan_update(padded_grid, beams, x_m, y_m, yaw_deg, origin_x,
                        origin_y, enabled, cfg, tof, geom, cone, True)
