"""Plain reference of the mapping replay: the exact update
(uav_local_nav.c:241-353) and the hybrid production update (the dense
free carve of the fans plus the exact endpoints), frame by frame.

The exact update walks each ray's Bresenham cells: for a ray to the cell
(ex, ey) off the pose cell, with n = max(|ex|, |ey|), step k = 0..n
moves k along the major axis and round((k * minor + n / 2) / n) down
along the minor one; the last cell is the endpoint.  Every cell of ray r
becomes clamp(v + d, lo_min, lo_max) (d = -free_dec, or the endpoint's
delta), rays in order F0..L7.  The cells of one ray are distinct, so a
ray is one gather and one scatter over the batch.

Replay policy (uav_local_nav.c:1629-1635, 2187-2194): the map starts at
the first finite airborne pose; every frame first recenters (when the
pose is far enough from the origin), then maps iff the pose is good for
mapping; the ToF filter advances every frame.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.config import Config
from portbench.reference.grid import (
    F32, cos_f32, extract_beams, f32, make_rays, recenter_decide,
    shift_grids, shift_origin, sin_f32, tof_filter_update, world_to_cell)

ST_HOVER, ST_LANDING = 5, 8        # the UL binary's airborne states
XY_BIT, Z_BIT = 0x4000, 0x2000     # MAV_SYS_STATUS position / altitude
KF_MAP_RECENTER = 1 << 5


def _health_ok(sys_health, bit):
    return (sys_health == 0) | ((sys_health & bit) != 0)


def carry(frames: dict, cfg: Config):
    """The sequential part of a replay for a [B] batch over T: the ToF
    filter, map init, the recenter decision and origin shift, then the
    enable gates.  Returns ({ox, oy, sx, sy, do, enabled, filt} of
    [B, T, ...], beams [B, T, 4, 8])."""
    m = cfg.map
    x, y = frames["x_m"], frames["y_m"]
    B, T = x.shape
    dev = x.device
    beams, minima = extract_beams(frames["grid_mm"], cfg.tof)
    ox = torch.full((B,), math.nan, dtype=torch.float32, device=dev)
    oy = ox.clone()
    inited = torch.zeros((B,), dtype=torch.bool, device=dev)
    filt = torch.full((B, 4), math.nan, dtype=torch.float32, device=dev)
    st = frames["state"].to(torch.int32)
    airborne = (st >= ST_HOVER) & (st <= ST_LANDING)
    out = {k: [] for k in ("ox", "oy", "sx", "sy", "do", "inited", "filt")}
    for t in range(T):
        filt = tof_filter_update(filt, minima[:, t], cfg.tof.filt_alpha)
        xt, yt = x[:, t], y[:, t]
        fin = torch.isfinite(xt) & torch.isfinite(yt)
        init = ~inited & fin & airborne[:, t]
        ox = torch.where(init, xt, ox)
        oy = torch.where(init, yt, oy)
        inited = inited | init
        sx, sy, do = recenter_decide(ox, oy, xt, yt, fin & inited, m)
        ox, oy = shift_origin(ox, sx, m.res_m), shift_origin(oy, sy, m.res_m)
        for k, v in zip(out, (ox, oy, sx, sy, do, inited, filt)):
            out[k].append(v)
    seq = {k: torch.stack(v, dim=1) for k, v in out.items()}
    good = torch.isfinite(x) & torch.isfinite(frames["yaw_deg"])
    good &= _health_ok(frames["sys_health"], XY_BIT)
    good &= _health_ok(frames["sys_health"], Z_BIT)
    fresh = torch.isfinite(frames["of_rate_x"])
    good &= ~fresh | (frames["of_q"].to(torch.int32)
                      >= cfg.gates.of_min_quality)
    seq["enabled"] = seq.pop("inited") & good
    return seq, beams


def ray_cells(rays: dict, K: int):
    """The Bresenham cells of rays [N, 32]: (drow, dcol, live, is_end),
    each [N, 32, K], offsets from the pose cell; live marks the cells
    the ray visits (k <= n of a valid ray)."""
    ex, ey = rays["ex"], rays["ey"]
    dx, dy = ex.abs(), ey.abs()
    sx = torch.where(ex > 0, 1, -1).to(torch.int32)
    sy = torch.where(ey > 0, 1, -1).to(torch.int32)
    xmaj = dx >= dy
    n = torch.maximum(dx, dy)
    k = torch.arange(K, dtype=torch.int32, device=ex.device)
    e = lambda a: a[..., None]                                        # noqa: E731
    minor_x = torch.div(2 * k * e(dy) + e(dx), e(2 * dx).clamp_min(1),
                        rounding_mode="floor")
    minor_y = torch.div(2 * k * e(dx) + e(dy), e(2 * dy).clamp_min(1),
                        rounding_mode="floor")
    drow = torch.where(e(xmaj), e(sy) * minor_x, e(sy) * k)
    dcol = torch.where(e(xmaj), e(sx) * k, e(sx) * minor_y)
    live = e(rays["valid"]) & (k <= e(n))
    return drow, dcol, live, k == e(n)


def apply_rays_exact(flat: torch.Tensor, rays: dict, cfg: Config) -> None:
    """One scan per flight (rays [B, 32]) onto the flights' grids, held
    as flat = [B * PR * PC] int8 cells and one spare cell, in place, ray
    after ray."""
    m, g = cfg.map, cfg.geom
    B = rays["ex"].shape[0]
    PR, PC = g.prows, g.pcols
    drow, dcol, live, is_end = ray_cells(rays, g.win_r + 1)
    base = (torch.arange(B, device=flat.device) * (PR * PC))[:, None, None]
    idx = (base + (rays["pcy"][:, None, None] + g.pad + drow).long() * PC
           + (rays["pcx"][:, None, None] + g.pad + dcol).long())
    idx = torch.where(live, idx, torch.full_like(idx, flat.numel() - 1))
    delta = torch.where(is_end, rays["delta"][..., None],
                        torch.full_like(is_end, -m.lo_free_dec,
                                        dtype=torch.int32)).to(torch.int16)
    for r in range(32):
        i = idx[:, r].reshape(-1)
        v = (flat[i].to(torch.int16) + delta[:, r].reshape(-1)).clamp(
            m.lo_min, m.lo_max)
        flat[i] = v.to(torch.int8)


def new_flat_grids(B: int, cfg: Config, device):
    """Zero grids as flat int8 cells with one spare cell at the end, and
    the [B, PR, PC] view of the grids."""
    g = cfg.geom
    flat = torch.zeros(B * g.prows * g.pcols + 1, dtype=torch.int8,
                       device=device)
    return flat, flat[:-1].view(B, g.prows, g.pcols)


def recenter_(grids, do, sx, sy, cfg: Config) -> None:
    """Shift, in place, the grids [B, PR, PC] of the flights whose do is
    set by their (sx, sy) cells."""
    moved = shift_grids(grids, sx, sy, cfg.geom)
    grids.copy_(torch.where(do[:, None, None], moved, grids))


def replay_exact(frames: dict, cfg: Config, lowp: bool = False):
    """The exact replay of a [B] batch.  Returns (grid int8 [B, PR, PC],
    origin_x, origin_y [B], used bool [B, T], kf_flags uint8 [B, T])."""
    seq, beams = carry(frames, cfg)
    rays = make_rays(beams, frames["x_m"], frames["y_m"], frames["yaw_deg"],
                     seq["ox"], seq["oy"], seq["enabled"], cfg.map, cfg.tof,
                     lowp)
    B, T = frames["x_m"].shape
    flat, grids = new_flat_grids(B, cfg, beams.device)
    do_any = seq["do"].any(dim=0).tolist()
    for t in range(T):
        if do_any[t]:
            recenter_(grids, seq["do"][:, t], seq["sx"][:, t],
                      seq["sy"][:, t], cfg)
        apply_rays_exact(flat, {k: v[:, t] for k, v in rays.items()}, cfg)
    return _result(grids, seq)


def _result(grids, seq):
    return {"grid": grids, "origin_x": seq["ox"][:, -1],
            "origin_y": seq["oy"][:, -1], "used": seq["enabled"],
            "kf_flags": torch.where(seq["do"], KF_MAP_RECENTER, 0).to(
                torch.uint8)}


# ------------------------------------------------------------ hybrid

FREE_MARGIN_M = 0.05    # the carve stops this short of the return


def _pack_returns(beams32, tof):
    """|p| = the clamped distance, sign = hit, 0 = no usable return."""
    nan = torch.isnan(beams32)
    hit = (~nan & (beams32 > f32(tof.map_skip_below_m))
           & (beams32 < f32(F32(tof.max_range_m) - F32(tof.hit_margin_m))))
    d = torch.where(nan, torch.zeros_like(beams32),
                    beams32.clamp_max(f32(tof.max_range_m)))
    return torch.where(hit, d, -d)


def _eroded_returns(packed32, tof):
    """Each column's carve distance: the min over it and its two in-fan
    neighbours' usable returns (fan edges clamp); 0 without a return."""
    a4 = packed32.abs().reshape(packed32.shape[:-1] + (4, 8))
    valid = a4 > f32(tof.map_skip_below_m)
    big = torch.where(valid, a4, torch.full_like(a4, f32(1e9)))
    left = torch.cat([big[..., :1], big[..., :-1]], dim=-1)
    right = torch.cat([big[..., 1:], big[..., -1:]], dim=-1)
    mn = torch.minimum(torch.minimum(left, big), right)
    return torch.where(valid, mn, torch.zeros_like(mn)).reshape(
        packed32.shape)


def _fan_bounds(yaw_deg, tof):
    """[N, 18]: (cos, sin) of the front fan's 9 column boundaries."""
    step = float(tof.fov_deg) / 8.0
    out = []
    for k in range(9):
        a = (yaw_deg + f32(F32(-float(tof.fov_deg) * 0.5 + step * k))) \
            * f32(F32(math.pi / 180.0))
        out += [cos_f32(a), sin_f32(a)]
    return torch.stack(out, dim=-1)


def _carve(rowsf, colsf, oxc, oyc, res, bounds, packed, tof):
    """The free-carve delta int32 [N, R, C] of every window cell: -1
    inside a fan, closer than its sector's eroded return less the margin,
    and within the range.  The sector comes from sign tests of the cell
    vector against the fan boundaries, each a comparison of two products
    rounded on their own."""
    N = oxc.shape[0]
    e = lambda v: v.reshape(N, 1, 1)                                  # noqa: E731
    ax = colsf[None] + e(oxc)
    ay = rowsf[None] + e(oyc)
    b = [e(bounds[:, i]) for i in range(18)]
    ux, uy = b[0], b[1]
    pxx, pyy, pxy, pyx = ux * ax, uy * ay, ux * ay, uy * ax
    m0 = (pxx > -pyy) & (pxy >= pyx)
    m1 = ~m0 & (pxy > pyx)
    m2 = ~m0 & ~m1 & (pxx < -pyy)
    d1 = ~m0 & ~m1
    d0 = m1 | (d1 & ~m2)
    axq = torch.where(d0, torch.where(d1, -ay, ay), torch.where(d1, -ax, ax))
    ayq = torch.where(d0, torch.where(d1, ax, -ax), torch.where(d1, -ay, ay))

    def above(bx, by):
        return bx * ayq > by * axq

    def pick(c, hi, lo):
        return torch.where(c, hi, lo)

    b2 = above(b[8], b[9])
    b1 = above(pick(b2, b[12], b[4]), pick(b2, b[13], b[5]))
    b0 = above(pick(b2, pick(b1, b[14], b[10]), pick(b1, b[6], b[2])),
               pick(b2, pick(b1, b[15], b[11]), pick(b1, b[7], b[3])))
    in_fan = ~above(b[16], b[17])
    sector = (16 * d1.long() + 8 * d0.long() + 4 * b2.long() + 2 * b1.long()
              + b0.long())
    sec_d = torch.gather(packed, 1, sector.reshape(N, -1)).reshape(
        sector.shape).abs()
    inv_res = F32(1.0 / float(res))
    maxr_c = F32(float(F32(tof.max_range_m) * inv_res))
    rng2 = ax * ax + ay * ay
    dfree = (sec_d - f32(FREE_MARGIN_M)).clamp_min(0.0) * float(inv_res)
    free = (in_fan & (sec_d > f32(tof.map_skip_below_m)) & (rng2 > 0.0)
            & (rng2 < dfree * dfree) & (rng2 <= float(F32(maxr_c * maxr_c))))
    one = torch.ones((), dtype=torch.int32, device=ax.device)
    return torch.where(free, -one, 0 * one)


def apply_scans_hybrid(grids, beams, x, y, yaw_deg, ox, oy, enabled,
                       cfg: Config, lowp: bool = False) -> None:
    """One hybrid scan per flight onto grids [B, PR, PC], in place: each
    window cell becomes v1 = clamp(v + carve), then clamp(v1 + the sum of
    the endpoint deltas of the rays that end in it)."""
    m, tof, g = cfg.map, cfg.tof, cfg.geom
    if lowp:
        from portbench.reference.grid import lowp_round
        beams, x, y, yaw_deg = (lowp_round(a) for a in (beams, x, y, yaw_deg))
    hw, hh = m.width // 2, m.height // 2
    pcx, pcy = world_to_cell(x, y, ox, oy, m.res_m, hw, hh)
    en = enabled & (pcx >= 0) & (pcx < m.width) & (pcy >= 0) & (pcy < m.height)
    pcx, pcy = pcx.clamp(0, m.width - 1), pcy.clamp(0, m.height - 1)
    R = g.win_r
    res = f32(m.res_m)
    fx = (x - ox) / res + f32(hw)
    fy = (y - oy) / res + f32(hh)
    oxc = (pcx - R).to(torch.float32) - fx
    oyc = (pcy - R).to(torch.float32) - fy
    packed = _eroded_returns(_pack_returns(beams.reshape(-1, 32), tof), tof)
    rays = make_rays(beams, x, y, yaw_deg, ox, oy, en, m, tof)
    dev = grids.device
    WR, WC = g.win_rows, g.win_cols
    rows = torch.arange(WR, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(WC, dtype=torch.int32, device=dev)[None, :]
    delta = _carve(rows.float(), cols.float(), oxc, oyc, m.res_m,
                   _fan_bounds(yaw_deg, tof), packed, tof)
    e = lambda v: v.reshape(-1, 1, 1)                                 # noqa: E731
    gy = rows + e(pcy - R)
    gx = cols + e(pcx - R)
    inb = (gy >= 0) & (gy < m.height) & (gx >= 0) & (gx < m.width)
    delta = torch.where(inb & e(en), delta, torch.zeros_like(delta))
    B = grids.shape[0]
    bi = torch.arange(B, device=dev)[:, None, None]
    ri = (gy + g.pad).long()
    ci = (gx + g.pad).long()
    v = (grids[bi, ri, ci].to(torch.int32) + delta).clamp(m.lo_min, m.lo_max)
    ed = torch.where(rays["valid"], rays["delta"],
                     torch.zeros_like(rays["delta"]))
    idx = ((rays["ey"] + R) * WC + (rays["ex"] + R)).long()
    dend = torch.zeros((B, WR * WC), dtype=torch.int32, device=dev)
    dend.scatter_add_(1, idx, ed)
    v = (v + dend.reshape(v.shape)).clamp(m.lo_min, m.lo_max)
    grids[bi, ri, ci] = v.to(torch.int8)


def replay_hybrid(frames: dict, cfg: Config, lowp: bool = False):
    """The hybrid replay of a [B] batch; returns as replay_exact."""
    seq, beams = carry(frames, cfg)
    g = cfg.geom
    B, T = frames["x_m"].shape
    grids = torch.zeros((B, g.prows, g.pcols), dtype=torch.int8,
                        device=beams.device)
    do_any = seq["do"].any(dim=0).tolist()
    for t in range(T):
        if do_any[t]:
            recenter_(grids, seq["do"][:, t], seq["sx"][:, t],
                      seq["sy"][:, t], cfg)
        apply_scans_hybrid(grids, beams[:, t], frames["x_m"][:, t],
                           frames["y_m"][:, t], frames["yaw_deg"][:, t],
                           seq["ox"][:, t], seq["oy"][:, t],
                           seq["enabled"][:, t], cfg, lowp)
    return _result(grids, seq)


REPLAYS = {"exact": replay_exact, "hybrid": replay_hybrid}
