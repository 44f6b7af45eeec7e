"""The mapper's float32 geometry in plain torch: beam extraction, the ToF
filter, world-to-cell rounding, the 32 rays of a scan, the recenter rule
and the whole-grid shift (uav_local_nav.c:205-353, 1320-1438).

Every float operation rounds as the C code's float32 does: trig by way of
float64 rounded once, divisions by a divisor tensor (a CUDA division by a
Python scalar multiplies by its reciprocal), no product contracted into
an fma.  `lowp`, where a function takes it, rounds the poses and
distances to bfloat16 first: the precision control of the checks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.config import GridGeom, MapConfig, TofConfig

F32 = np.float32
DEG2RAD = float(F32(np.pi) / F32(180.0))
I32_MAX = 2147483647


def f32(x) -> float:
    """A Python float holding exactly the float32 value of x."""
    return float(F32(x))


def lowp_round(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to bfloat16 and back."""
    return t.to(torch.bfloat16).to(torch.float32)


def round_to_i32(v: torch.Tensor) -> torch.Tensor:
    """Round half to even into int32; NaN -> 0; out of range saturates."""
    r = torch.round(v)
    hi = r >= 2147483648.0
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    i = r.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(hi, torch.full_like(i, I32_MAX), i)


def cos_f32(a: torch.Tensor) -> torch.Tensor:
    return torch.cos(a.double()).float()


def sin_f32(a: torch.Tensor) -> torch.Tensor:
    return torch.sin(a.double()).float()


def div_f32(a: torch.Tensor, d: float) -> torch.Tensor:
    return a / a.new_full((), d)


def sqrt_f32(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(a.double()).float()


def world_to_cell(x, y, ox, oy, res: float, half_w: int, half_h: int):
    """lrintf((p - origin) / res) + half, per axis: int32 cells."""
    res = f32(res)
    return (round_to_i32(div_f32(x - ox, res)) + half_w,
            round_to_i32(div_f32(y - oy, res)) + half_h)


def extract_beams(grid_mm: torch.Tensor, tof: TofConfig):
    """ToF frames int [..., 4, 8, 8] (mm) -> (beams f32 [..., 4, 8]: per
    column the second-smallest valid row, or the only one; minima f32
    [..., 4]) (uav_local_nav.c:1320-1359)."""
    mm = grid_mm.to(torch.int32)
    m = mm.to(torch.float32) * f32(0.001)
    valid = (mm != 0) & (mm != 0xFFFF) & (m > f32(tof.min_valid_m))
    m = torch.where(valid, m.clamp_max(f32(tof.max_range_m)),
                    torch.full_like(m, math.inf))
    srt = torch.sort(m, dim=-2).values
    count = valid.sum(dim=-2)
    beams = torch.where(count >= 2, srt[..., 1, :],
                        torch.where(count == 1, srt[..., 0, :],
                                    torch.full_like(srt[..., 0, :], math.nan)))
    mins = torch.where(torch.isnan(beams), torch.full_like(beams, math.inf),
                       beams).amin(dim=-1)
    mins = torch.where(torch.isinf(mins), torch.full_like(mins, math.nan), mins)
    return beams, mins


def tof_filter_update(filt, minima, alpha: float):
    """NaN-aware EMA of the per-direction minima (uav_local_nav.c:1430-1438):
    (1 - a) * filt + a * v, the first sample adopted, NaN samples skipped."""
    a = F32(alpha)
    blended = f32(F32(1.0) - a) * filt + f32(a) * minima
    upd = torch.where(torch.isnan(filt), minima, blended)
    return torch.where(torch.isnan(minima), filt, upd)


def make_rays(beams, x, y, yaw_deg, ox, oy, enabled, m: MapConfig,
              tof: TofConfig, lowp: bool = False) -> dict:
    """The 32 rays of scans beams [..., 4, 8] at poses [...] in the map of
    origin (ox, oy) (uav_local_nav.c:280-306): skip NaN and <= 5 cm beams,
    hit iff d < range - margin, d clamped to the range.  Returns [..., 32]
    tensors (order F0..7, R0..7, B0..7, L0..7) of the endpoint cell
    relative to the pose cell (ex, ey), its delta and validity, and the
    pose cell (pcx, pcy) [...] clamped into the map."""
    if lowp:
        beams, x, y, yaw_deg = (lowp_round(a) for a in (beams, x, y, yaw_deg))
    dev = beams.device
    half_fov = F32(tof.fov_deg) * F32(0.5)
    u = (np.arange(8, dtype=np.float32) - F32(3.5)) / F32(3.5)
    col_off = torch.from_numpy(u * half_fov).to(dev)
    centers = torch.tensor(tof.dir_center_deg, dtype=torch.float32, device=dev)
    ok = ~torch.isnan(beams) & (beams > f32(tof.map_skip_below_m))
    hit = beams < f32(F32(tof.max_range_m) - F32(tof.hit_margin_m))
    d = torch.where(ok, beams, torch.zeros_like(beams)).clamp_max(
        f32(tof.max_range_m))
    e2 = lambda a: a[..., None, None]                                 # noqa: E731
    ang = ((e2(yaw_deg) + centers[:, None]) + col_off[None, :]) * DEG2RAD
    if lowp:
        ang = lowp_round(ang)
    wx = e2(x) + d * cos_f32(ang)
    wy = e2(y) + d * sin_f32(ang)
    hw, hh = m.width // 2, m.height // 2
    pcx, pcy = world_to_cell(x, y, ox, oy, m.res_m, hw, hh)
    ecx, ecy = world_to_cell(wx, wy, e2(ox), e2(oy), m.res_m, hw, hh)
    pose_in = (pcx >= 0) & (pcx < m.width) & (pcy >= 0) & (pcy < m.height)
    end_in = (ecx >= 0) & (ecx < m.width) & (ecy >= 0) & (ecy < m.height)
    valid = ok & end_in & e2(pose_in) & e2(enabled)
    pcx = pcx.clamp(0, m.width - 1)
    pcy = pcy.clamp(0, m.height - 1)
    zero = torch.zeros_like(ecx)
    flat = lambda a: a.reshape(a.shape[:-2] + (32,))                  # noqa: E731
    return {"ex": flat(torch.where(valid, ecx - e2(pcx), zero)),
            "ey": flat(torch.where(valid, ecy - e2(pcy), zero)),
            "delta": flat(torch.where(hit, m.lo_occ_inc,
                                      -m.lo_miss_end_dec).to(torch.int32)),
            "valid": flat(valid), "hit": flat(hit & ok), "pcx": pcx, "pcy": pcy}


def recenter_decide(ox, oy, x, y, pose_ok, m: MapConfig):
    """The recenter rule (uav_local_nav.c:324-343): when the pose is
    recenter_frac of the half-map from the origin on an axis, shift by the
    rounded offset in cells, clamped.  Returns (sx, sy, do)."""
    half = F32(m.size_m) * F32(0.5)
    thresh = f32(half * F32(m.recenter_frac))
    dx, dy = x - ox, y - oy
    need = pose_ok & ((dx.abs() >= thresh) | (dy.abs() >= thresh))
    mx = m.recenter_max_shift_cells
    sx = round_to_i32(div_f32(dx, f32(m.res_m))).clamp(-mx, mx)
    sy = round_to_i32(div_f32(dy, f32(m.res_m))).clamp(-mx, mx)
    do = need & ((sx != 0) | (sy != 0))
    zero = torch.zeros_like(sx)
    return torch.where(do, sx, zero), torch.where(do, sy, zero), do


def shift_origin(origin, s, res: float):
    """origin + s * res, the product rounded on its own."""
    prod = s.to(torch.float32) * f32(res)
    return origin + torch.where(origin == origin, prod, origin)


def shift_grids(grids, sx, sy, geom: GridGeom):
    """new[y, x] = old[y + sy, x + sx] inside the logical map, zero where
    the source lies outside it (uav_local_nav.c:308-322), per flight:
    grids int8 [N, PR, PC], sx/sy int [N].  Returns new grids."""
    N, PR, PC = grids.shape
    dev = grids.device
    r = torch.arange(PR, device=dev)
    c = torch.arange(PC, device=dev)
    src_r = r[None, :] + sy.long()[:, None]                        # [N, PR]
    src_c = c[None, :] + sx.long()[:, None]                        # [N, PC]
    ok_r = ((r >= geom.pad) & (r < geom.pad + geom.height))[None] & \
        (src_r >= geom.pad) & (src_r < geom.pad + geom.height)
    ok_c = ((c >= geom.pad) & (c < geom.pad + geom.width))[None] & \
        (src_c >= geom.pad) & (src_c < geom.pad + geom.width)
    n = torch.arange(N, device=dev)[:, None, None]
    out = grids[n, src_r.clamp(0, PR - 1)[:, :, None],
                src_c.clamp(0, PC - 1)[:, None, :]]
    keep = ok_r[:, :, None] & ok_c[:, None, :]
    return torch.where(keep, out, torch.zeros((), dtype=grids.dtype,
                                              device=dev))


def cut_windows(grids, r0, c0, rows: int, cols: int):
    """[N, rows, cols] slices of grids [N, PR, PC] at (r0, c0) [N]."""
    dev = grids.device
    rr = r0.long()[:, None] + torch.arange(rows, device=dev)
    cc = c0.long()[:, None] + torch.arange(cols, device=dev)
    n = torch.arange(grids.shape[0], device=dev)
    return grids[n[:, None, None], rr[:, :, None], cc[:, None, :]]
