"""Plain reference of the three-pass SLAM replay of a [B] batch of
flights: EKF odometry with the map's recenter schedule (pass 0),
correlative scan matching of the keyframes against the map built from
them (pass 1, feedback-free, SlamConfig.match_iters rounds), proximity-
gated loop matches, an SE(2) pose graph solved by Gauss-Newton with
Huber-weighted loop edges, SlamConfig.slam_outer global rounds, and the
exact re-raster of every frame from the corrected track (pass 3).

The stages follow the JAX package's SLAM formulation (the repository's
reference system); every float stage rounds as that formulation does on
the CPU: trig by way of float64, divisions by tensors, float64 sums
rounded once, the normal equations as a chain of fused multiply-adds in
float64 rounded per row.  Scores are integer sums, so they are exact.
The rasters use the exact update of reference/mapping.py.

`lowp` is the precision control: it rounds what each stage hands on
(odometry, matched poses, solved nodes, the corrected track) to bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.config import Config
from portbench.reference.grid import (
    F32, cos_f32, cut_windows, div_f32, extract_beams, f32, lowp_round,
    make_rays, recenter_decide, shift_origin, sin_f32, sqrt_f32,
    world_to_cell)
from portbench.reference.mapping import (
    apply_rays_exact, new_flat_grids, recenter_)

DEG2RAD = f32(np.pi / 180.0)
RAD2DEG = f32(180.0 / np.pi)
PI = f32(np.pi)
TWO_PI = f32(2 * np.pi)

# ------------------------------------------------------------------ EKF
# state (x, y, vx, vy, z, vz, yaw, wz)
N_ST = 8
IX, IY, IVX, IVY, IZ, IVZ, IYAW, IWZ = range(N_ST)
COUPLED = (IX, IY, IZ, IYAW)
VEL = (IVX, IVY, IVZ, IWZ)


class Ekf(NamedTuple):
    mean: torch.Tensor
    cov: torch.Tensor


def ekf_init(B: int, device) -> Ekf:
    mean = torch.zeros((B, N_ST), dtype=torch.float32, device=device)
    cov = torch.zeros((B, N_ST, N_ST), dtype=torch.float32, device=device)
    for i in (IX, IY, IZ):
        cov[:, i, i] = f32(1e-4)
    for i in (IVX, IVY, IVZ, IWZ):
        cov[:, i, i] = f32(1e-2)
    cov[:, IYAW, IYAW] = f32(1e-2)
    return Ekf(mean, cov)


def predict_consts(device) -> tuple:
    """The predict's index, mask and identity tensors, made once."""
    rowmap = list(range(N_ST))
    for p, v in zip(COUPLED, VEL):
        rowmap[p] = v
    sel = torch.zeros(N_ST, dtype=torch.float32)
    sel[list(COUPLED)] = 1.0
    return tuple(t.to(device) for t in (
        torch.tensor(COUPLED), torch.tensor(VEL), torch.tensor(rowmap), sel,
        torch.eye(N_ST, dtype=torch.float32)))


def ekf_predict(st: Ekf, dt, e, consts) -> Ekf:
    """Constant velocity and yaw rate: F P F^T with F = I + dt E, E the
    (pos, vel) couplings; process noise scaled by dt."""
    coupled, vel, rowmap, sel, eye = consts
    d = dt[:, None]
    mean = st.mean.index_add(-1, coupled, st.mean.index_select(-1, vel) * d)
    P = st.cov
    EP = P.index_select(-2, rowmap) * sel[:, None]
    EPEt = EP.index_select(-1, rowmap) * sel
    dt2 = d[..., None]
    cov = P + dt2 * (EP + EP.transpose(-1, -2)) + dt2 * dt2 * EPEt
    q = torch.stack([f32(v) * dt for v in (e.q_pos, e.q_pos, e.q_vel, e.q_vel,
                                           e.q_pos, e.q_vz, e.q_yaw, e.q_wz)],
                    dim=-1)
    return Ekf(mean, cov + q[..., None] * eye)


def _update_scalar(st: Ekf, idx: int, innov, valid, r) -> Ekf:
    mean, cov = st.mean, st.cov
    S = cov[..., idx, idx] + f32(r)
    K = cov[..., :, idx] / S[..., None]
    new_mean = mean + K * innov[..., None]
    Kc, Kr = K[..., :, None], K[..., None, :]
    new_cov = (cov - Kc * cov[..., idx:idx + 1, :] - cov[..., :, idx:idx + 1]
               * Kr + S[..., None, None] * (Kc * Kr))
    return Ekf(torch.where(valid[..., None], new_mean, mean),
               torch.where(valid[..., None, None], new_cov, cov))


def wrap_pi(a):
    return a - TWO_PI * torch.floor(div_f32(a + PI, TWO_PI))


def ekf_update_velocity(st: Ekf, z_body, valid, r_vel) -> Ekf:
    """The flow's body velocity, H over (vx, vy, yaw), the 2x2 innovation
    covariance inverted in closed form, the covariance update expanded."""
    mean, cov = st.mean, st.cov
    r_vel = f32(r_vel)
    c, s = cos_f32(mean[..., IYAW]), sin_f32(mean[..., IYAW])
    vx, vy = mean[..., IVX], mean[..., IVY]
    innov = z_body - torch.stack([c * vx + s * vy, -s * vx + c * vy], dim=-1)
    h0y = -s * vx + c * vy
    h1y = -c * vx - s * vy
    Pvx, Pvy, Pyw = cov[..., :, IVX], cov[..., :, IVY], cov[..., :, IYAW]
    un = lambda a: a[..., None]                                       # noqa: E731
    PHt0 = un(c) * Pvx + un(s) * Pvy + un(h0y) * Pyw
    PHt1 = un(-s) * Pvx + un(c) * Pvy + un(h1y) * Pyw
    dot0 = lambda p: c * p[..., IVX] + s * p[..., IVY] + h0y * p[..., IYAW]  # noqa: E731
    dot1 = lambda p: -s * p[..., IVX] + c * p[..., IVY] + h1y * p[..., IYAW]  # noqa: E731
    a = dot0(PHt0) + r_vel
    b = dot0(PHt1)
    c2 = dot1(PHt0)
    d = dot1(PHt1) + r_vel
    det = a * d - b * c2
    i00, i01, i10, i11 = d / det, -b / det, -c2 / det, a / det
    K0 = PHt0 * un(i00) + PHt1 * un(i10)
    K1 = PHt0 * un(i01) + PHt1 * un(i11)
    new_mean = mean + K0 * un(innov[..., 0]) + K1 * un(innov[..., 1])
    Mvx = un(c) * K0 + un(-s) * K1
    Mvy = un(s) * K0 + un(c) * K1
    Myw = un(h0y) * K0 + un(h1y) * K1
    row = lambda i: cov[..., i, :]                                    # noqa: E731
    MP = (Mvx[..., :, None] * row(IVX)[..., None, :]
          + Mvy[..., :, None] * row(IVY)[..., None, :]
          + Myw[..., :, None] * row(IYAW)[..., None, :])
    MPM = (MP[..., :, IVX, None] * Mvx[..., None, :]
           + MP[..., :, IVY, None] * Mvy[..., None, :]
           + MP[..., :, IYAW, None] * Myw[..., None, :])
    KK = K0[..., :, None] * K0[..., None, :] + K1[..., :, None] * K1[..., None, :]
    new_cov = cov - MP - MP.transpose(-1, -2) + MPM + r_vel * KK
    return Ekf(torch.where(valid[..., None], new_mean, mean),
               torch.where(valid[..., None, None], new_cov, cov))


def ekf_step(st: Ekf, dt, rx, ry, q, ground, yaw, e, consts) -> Ekf:
    """Predict, then the yaw, rangefinder and flow updates, then the
    trapezoidal position refinement and one symmetrisation."""
    v_prev = st.mean[..., IVX:IVY + 1]
    st = ekf_predict(st, dt, e, consts)
    yaw_ok = torch.isfinite(yaw)
    z = torch.where(yaw_ok, yaw, torch.zeros_like(yaw))
    st = _update_scalar(st, IYAW, wrap_pi(z - st.mean[..., IYAW]), yaw_ok,
                        e.r_yaw)
    rf_ok = (torch.isfinite(ground) & (ground > f32(e.min_ground_m))
             & (ground < 10.0))
    innov = torch.where(rf_ok, ground, torch.zeros_like(ground)) \
        - st.mean[..., IZ]
    st = _update_scalar(st, IZ, innov, rf_ok, e.r_rf)
    valid = (torch.isfinite(rx) & torch.isfinite(ry) & (q >= e.min_flow_quality)
             & torch.isfinite(ground) & (ground > f32(e.min_ground_m)))
    zero = torch.zeros_like(rx)
    zb = torch.stack([torch.where(valid, rx * ground, zero),
                      torch.where(valid, ry * ground, zero)], dim=-1)
    st = ekf_update_velocity(st, zb, valid, e.r_flow_vel)
    corr = 0.5 * (st.mean[..., IVX:IVY + 1] - v_prev) * dt[..., None]
    mean = torch.cat([st.mean[..., :IY + 1] + corr, st.mean[..., IY + 1:]], -1)
    return Ekf(mean, 0.5 * (st.cov + st.cov.transpose(-1, -2)))


def _nan0(a):
    return torch.where(torch.isnan(a), torch.zeros_like(a), a)


def odometry_and_schedule(frames: dict, cfg: Config):
    """Pass 0: the EKF track from flow, rangefinder and attitude, and the
    map's origin/recenter schedule decided from it.  Returns (odo
    [B, T, 3], sched {ox, oy, do, rsy, rsx} [B, T])."""
    m, e = cfg.map, cfg.ekf
    rx = frames["of_rate_x"]
    B, T = rx.shape
    dev = rx.device
    ms = frames["scan_ms"]
    dt = (torch.diff(ms, dim=1, prepend=ms[:, :1]).to(torch.float32)
          * f32(1e-3)).clamp(0.0, 1.0)
    yaw = frames["yaw_deg"] * DEG2RAD
    st = ekf_init(B, dev)
    mean = st.mean.clone()
    mean[:, IX] = _nan0(frames["x_m"][:, 0])
    mean[:, IY] = _nan0(frames["y_m"][:, 0])
    mean[:, IZ] = _nan0(frames["rf_m"][:, 0])
    mean[:, IYAW] = _nan0(yaw[:, 0])
    st = Ekf(mean, st.cov)
    consts = predict_consts(dev)
    ox = torch.full((B,), float("nan"), dtype=torch.float32, device=dev)
    oy = ox.clone()
    xs, ys = [], []
    sch = {k: [] for k in ("ox", "oy", "do", "rsy", "rsx")}
    for t in range(T):
        st = ekf_step(st, dt[:, t], rx[:, t], frames["of_rate_y"][:, t],
                      frames["of_q"][:, t], frames["rf_m"][:, t], yaw[:, t], e,
                      consts)
        x, y = st.mean[:, IX], st.mean[:, IY]
        xs.append(x)
        ys.append(y)
        ox = torch.where(torch.isnan(ox), x, ox)
        oy = torch.where(torch.isnan(oy), y, oy)
        ok = torch.isfinite(x) & torch.isfinite(y)
        sx, sy, do = recenter_decide(ox, oy, x, y, ok, m)
        ox, oy = shift_origin(ox, sx, m.res_m), shift_origin(oy, sy, m.res_m)
        for k, v in zip(sch, (ox, oy, do.to(torch.int32), sy, sx)):
            sch[k].append(v)
    odo = torch.stack([torch.stack(xs, 1), torch.stack(ys, 1), yaw], -1)
    return odo, {k: torch.stack(v, dim=1) for k, v in sch.items()}


# ----------------------------------------------------------- rasters

def raster(grids0, beams, x, y, yaw_deg, ox, oy, do, rsy, rsx, cfg: Config,
           snap_at=None, n_kf: int = 1, lowp: bool = False):
    """Scans [B, K] (beams [B, K, 4, 8]) onto copies of grids0 [B, PR, PC],
    in order, every scan enabled, each in its own origin (ox, oy); before
    scan k the grids move by (rsy, rsx) where do != 0.  With snap_at =
    (r0s, c0s) [B, K], at every n_kf-th scan (after its recenter, before
    its rays) the slab at (r0s, c0s) of each of that chunk's scans is
    copied out.  Returns (grids, snaps [B, K, SR, SC] or None)."""
    g = cfg.geom
    B, K = x.shape
    flat, grids = new_flat_grids(B, cfg, x.device)
    grids.copy_(grids0)
    rays = make_rays(beams, x, y, yaw_deg, ox, oy,
                     torch.ones_like(x, dtype=torch.bool), cfg.map, cfg.tof,
                     lowp)
    do = do != 0
    do_any = do.any(dim=0).tolist()
    zero = torch.zeros_like(rsx)
    snaps = None
    if snap_at is not None:
        SR, SC = g.win_rows + 8, 2 * g.win_cols
        snaps = torch.zeros((B, K, SR, SC), dtype=torch.int8, device=x.device)
    for k in range(K):
        if do_any[k]:
            recenter_(grids, do[:, k], torch.where(do[:, k], rsx[:, k], zero[:, k]),
                      torch.where(do[:, k], rsy[:, k], zero[:, k]), cfg)
        if snaps is not None and k % n_kf == 0:
            for f in range(k, min(k + n_kf, K)):
                snaps[:, f] = cut_windows(grids, snap_at[0][:, f],
                                          snap_at[1][:, f], SR, SC)
        apply_rays_exact(flat, {n: v[:, k] for n, v in rays.items()}, cfg)
    return grids.clone(), snaps


# ------------------------------------------------------- scan matching

class Match(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    yaw_deg: torch.Tensor
    quality: torch.Tensor


def _endpoints(beams, x, y, yaw_deg, tof):
    """Hit endpoints (wx, wy) [..., 32] and the hit mask of scans at
    poses [...]."""
    dev = beams.device
    u = (np.arange(8, dtype=np.float32) - F32(3.5)) / F32(3.5)
    col = torch.from_numpy(u * F32(tof.fov_deg * 0.5)).to(dev)
    centers = torch.tensor(tof.dir_center_deg, dtype=torch.float32, device=dev)
    hit = (~torch.isnan(beams) & (beams > f32(tof.map_skip_below_m))
           & (beams < f32(F32(tof.max_range_m) - F32(tof.hit_margin_m))))
    d = torch.where(hit, beams, torch.zeros_like(beams))
    e2 = lambda a: a[..., None, None]                                 # noqa: E731
    ang = ((e2(yaw_deg) + centers[:, None]) + col[None, :]) * DEG2RAD
    flat = lambda a: a.reshape(a.shape[:-2] + (32,))                  # noqa: E731
    return (flat(e2(x) + d * cos_f32(ang)), flat(e2(y) + d * sin_f32(ang)),
            flat(hit))


def lattice_offsets(n: int, step: float, device):
    o = (np.arange(n, dtype=np.float32) - (n - 1) / 2) * F32(step)
    return torch.from_numpy(o.astype(np.float32)).to(device)


def lattice_cells(beams, x, y, yaw_deg, ox, oy, cfg: Config, n_xy, n_yaw,
                  xy_step, yaw_step):
    """Candidate endpoint cells of the (n_yaw, n_xy, n_xy) lattice of N
    scans: (cy [N, Y, 32, Tc], cx [N, Y, 32, Tc], in-map masks, hit
    [N, Y, 32])."""
    m = cfg.map
    dev = beams.device
    oxy = lattice_offsets(n_xy, xy_step, dev)
    yaw = yaw_deg[:, None] + lattice_offsets(n_yaw, yaw_step, dev)
    bY = beams[:, None].expand(-1, n_yaw, -1, -1)
    wx, wy, hit = _endpoints(bY, x[:, None].expand_as(yaw),
                             y[:, None].expand_as(yaw), yaw, cfg.tof)
    o = lambda a: a[:, None, None, None]                              # noqa: E731
    cx, cy = world_to_cell(wx[..., None] + oxy, wy[..., None] + oxy, o(ox),
                           o(oy), m.res_m, m.width // 2, m.height // 2)
    return (cy, cx, (cy >= 0) & (cy < m.height), (cx >= 0) & (cx < m.width),
            hit)


def _subcell(arr, idx, step: float):
    n = arr.shape[1]
    i0 = idx.clamp(1, n - 2)
    at = lambda i: arr.gather(1, i[:, None])[:, 0]                    # noqa: E731
    ym, y0, yp = at(i0 - 1), at(i0), at(i0 + 1)
    den = ym - 2 * y0 + yp
    d = torch.where(den.abs() > f32(1e-6), 0.5 * (ym - yp) / den,
                    torch.zeros_like(den)).clamp(-1.0, 1.0)
    interior = (idx >= 1) & (idx <= n - 2)
    return ((idx.to(torch.float32) + torch.where(interior, d,
                                                 torch.zeros_like(d))
             - (n - 1) / 2) * f32(step))


def match(slabs, r0s, c0s, beams, x, y, yaw_deg, ox, oy, cfg: Config, n_xy,
          n_yaw) -> Match:
    """Correlative matching of N scans, each against its own int8 slab
    [N, SR, SC] whose top-left padded-grid cell is (r0s, c0s): every
    lattice candidate scores the sum of the slab cells under its hit
    endpoints (cells off the map or off the slab score 0); the first best
    candidate, a quadratic sub-cell refinement per axis, and the quality
    (peak - mean) per hit beam."""
    s, g = cfg.slam, cfg.geom
    cy, cx, iny, inx, hit = lattice_cells(beams, x, y, yaw_deg, ox, oy, cfg,
                                          n_xy, n_yaw, s.match_xy_step_m,
                                          s.match_yaw_step_deg)
    N, SR, SC = slabs.shape
    ry = torch.where(iny & hit[..., None], cy + g.pad - r0s[:, None, None, None],
                     -1).long()                                  # [N, Y, 32, T]
    rx = torch.where(inx, cx + g.pad - c0s[:, None, None, None], -1).long()
    ryv = ry.permute(0, 1, 3, 2)[:, :, :, None, :]               # [N, Y, Ty, 1, 32]
    rxv = rx.permute(0, 1, 3, 2)[:, :, None, :, :]               # [N, Y, 1, Tx, 32]
    ok = (ryv >= 0) & (ryv < SR) & (rxv >= 0) & (rxv < SC)
    cell = ryv.clamp(0, SR - 1) * SC + rxv.clamp(0, SC - 1)
    vals = torch.gather(slabs.reshape(N, -1), 1, cell.reshape(N, -1)).reshape(
        cell.shape).to(torch.float32)
    scores = torch.where(ok, vals, torch.zeros_like(vals)).sum(-1)  # [N,Y,Ty,Tx]
    sc = scores.transpose(2, 3)                                  # [N, Y, Tx, Ty]
    _, Y, TX, TY = sc.shape
    flat = sc.reshape(N, -1)
    best = torch.argmax(flat, dim=1)
    iy = torch.div(best, TX * TY, rounding_mode="floor")
    ix = torch.div(best, TY, rounding_mode="floor") % TX
    it = best % TY
    n = torch.arange(N, device=slabs.device)
    dyaw = _subcell(sc[n, :, ix, it], iy, s.match_yaw_step_deg)
    dx = _subcell(sc[n, iy, :, it], ix, s.match_xy_step_m)
    dy = _subcell(sc[n, iy, ix, :], it, s.match_xy_step_m)
    nhit = hit.sum(-1)[n, iy].to(torch.float32).clamp_min(1.0)
    mean = flat.sum(dim=1) / flat.new_full((), flat.shape[1])
    return Match(x + dx, y + dy, yaw_deg + dyaw, (flat[n, best] - mean) / nhit)


def window_origin(pcx, pcy, g):
    return ((pcy + g.pad - g.win_rows // 2).clamp(0, g.prows - g.win_rows),
            (pcx + g.pad - g.win_cols // 2).clamp(0, g.pcols - g.win_cols))


def snap_align(wy0, wx0, g):
    """The slab around a match window: 8/128-aligned, inside the grid."""
    SR, SC = g.win_rows + 8, 2 * g.win_cols
    return ((torch.div(wy0, 8, rounding_mode="floor") * 8).clamp(0, g.prows - SR),
            (torch.div(wx0, 128, rounding_mode="floor") * 128).clamp(
                0, g.pcols - SC))


# ---------------------------------------------------------- pose graph

def _mod(a, m: float):
    r = torch.fmod(a, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def wrap(a):
    return _mod(a + PI, TWO_PI) - PI


def se2_compose(a, b):
    c, s = cos_f32(a[..., 2]), sin_f32(a[..., 2])
    return torch.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                        a[..., 1] + s * b[..., 0] + c * b[..., 1],
                        wrap(a[..., 2] + b[..., 2])], dim=-1)


def se2_relative(a, b):
    c, s = cos_f32(a[..., 2]), sin_f32(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy,
                        wrap(b[..., 2] - a[..., 2])], dim=-1)


class Graph(NamedTuple):
    nodes: torch.Tensor      # [B, K, 3]
    ij: torch.Tensor         # int64 [B, E, 2]
    z: torch.Tensor          # [B, E, 3]
    w: torch.Tensor          # [B, E, 3]
    mask: torch.Tensor       # bool [B, E]
    huber: torch.Tensor      # [B, E]


def add_edges(gr: Graph, ij, z, w, mask=None, huber=0.0) -> Graph:
    B, E2 = ij.shape[:2]
    dev = gr.nodes.device
    w = torch.as_tensor(w, dtype=torch.float32, device=dev).expand(B, E2, 3)
    m = torch.ones((B, E2), dtype=torch.bool, device=dev) if mask is None \
        else mask
    h = torch.as_tensor(f32(huber), dtype=torch.float32,
                        device=dev).expand(B, E2)
    return Graph(gr.nodes, torch.cat([gr.ij, ij.to(torch.int64)], 1),
                 torch.cat([gr.z, z], 1), torch.cat([gr.w, w], 1),
                 torch.cat([gr.mask, m], 1), torch.cat([gr.huber, h], 1))


def _residuals(nodes, gr: Graph):
    gat = lambda idx: torch.gather(nodes, 1, idx[..., None].expand(*idx.shape, 3))  # noqa: E731
    pi, pj = gat(gr.ij[..., 0]), gat(gr.ij[..., 1])
    c, s = cos_f32(pi[..., 2]), sin_f32(pi[..., 2])
    dx, dy = pj[..., 0] - pi[..., 0], pj[..., 1] - pi[..., 1]
    rt = torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)
    r = torch.cat([rt - gr.z[..., :2],
                   wrap(pj[..., 2] - pi[..., 2] - gr.z[..., 2])[..., None]], -1)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    Ji = torch.stack([torch.stack([-c, -s, -s * dx + c * dy], -1),
                      torch.stack([s, -c, -c * dx - s * dy], -1),
                      torch.stack([zero, zero, -one], -1)], -2)
    Jj = torch.stack([torch.stack([c, s, zero], -1),
                      torch.stack([-s, c, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return r, Ji, Jj


def _incidence_order(ij, K: int):
    """Where each edge's products sum into the normal equations: edge e
    = (i, j) has the incidences 4e..4e+3 on the blocks (i, i), (j, j),
    (i, j), (j, i).  Returns idx int64 [B, K*K, L]: for every block with
    both nodes >= 1 (node 0 is pinned), its incidences in edge order,
    padded with 4E (none)."""
    B, E = ij.shape[:2]
    dev = ij.device
    i, j = ij[..., 0], ij[..., 1]
    tgt = torch.stack([i * K + i, j * K + j, i * K + j, j * K + i],
                      -1).reshape(B, 4 * E)
    live = torch.stack([i > 0, j > 0, (i > 0) & (j > 0), (i > 0) & (j > 0)],
                       -1).reshape(B, 4 * E)
    earlier = torch.ones((4 * E, 4 * E), dtype=torch.bool, device=dev).tril(-1)
    rank = ((tgt[:, :, None] == tgt[:, None, :]) & earlier).sum(-1)
    L = int(torch.where(live, rank, 0).max()) + 1 if 4 * E else 1
    trash = K * K * L
    pos = torch.where(live, tgt * L + rank, torch.full_like(tgt, trash))
    idx = torch.full((B, trash + 1), 4 * E, dtype=torch.int64, device=dev)
    idx.scatter_(1, pos, torch.arange(4 * E, device=dev).expand(B, 4 * E))
    return idx[:, :trash].reshape(B, K * K, L)


def _normal_equations(r, Ji, Jj, wm, idx):
    """H = (W A)^T A [B, 3K, 3K] and b = (W A)^T r [B, 3K] of the dense
    Jacobian A = Si (x) Ji + Sj (x) Jj.  Each entry sums its products in
    edge order as a chain of fused multiply-adds (the order of the CPU's
    float32 matmul), held in float64 and rounded to float32 after every
    row."""
    B, E = r.shape[:2]
    K = int(round(idx.shape[1] ** 0.5))
    Awi = (Ji * wm[..., None]).double()
    Awj = (Jj * wm[..., None]).double()
    rhs = r.double()[..., None]

    def prod(aw, jac):
        return aw[..., :, None] * torch.cat([jac.double(), rhs],
                                            -1)[..., None, :]

    M = torch.stack([prod(Awi, Ji), prod(Awj, Jj), prod(Awi, Jj),
                     prod(Awj, Ji)], 2).reshape(B, 4 * E, 3, 3, 4)
    M = torch.cat([M, M.new_zeros((B, 1, 3, 3, 4))], 1)
    bi = torch.arange(B, device=r.device)[:, None]
    acc = M.new_zeros((B, K * K, 3, 4))
    for s in range(idx.shape[2]):
        Ms = M[bi, idx[..., s]]
        for c in range(3):
            acc = (acc + Ms[:, :, c]).float().double()
    acc = acc.reshape(B, K, K, 3, 4)
    H = acc[..., :3].permute(0, 1, 3, 2, 4).reshape(B, 3 * K, 3 * K)
    b = torch.diagonal(acc[..., 3], dim1=1, dim2=2)
    return H, b.transpose(1, 2).reshape(B, 3 * K)


def gauss_newton(gr: Graph, iters: int, damping: float = 1e-6):
    """Damped Gauss-Newton with node 0 pinned and IRLS-Huber on the robust
    edges; the factorisation in float64.  Returns (nodes, costs [B,
    iters])."""
    nodes = gr.nodes
    B, K = nodes.shape[:2]
    dev = nodes.device
    wbase = gr.w * gr.mask[..., None].to(torch.float32)
    idx = _incidence_order(gr.ij, K)
    pin = (torch.arange(3 * K, device=dev) >= 3).to(torch.float64)
    eye = torch.eye(3 * K, dtype=torch.float64, device=dev)
    costs = []
    for _ in range(iters):
        r, Ji, Jj = _residuals(nodes, gr)
        wr2 = wbase * r * r
        chi = sqrt_f32(torch.clamp_min(wr2[..., 0] + wr2[..., 1] + wr2[..., 2],
                                       f32(1e-12)))
        scale = torch.where((gr.huber > 0) & (chi > gr.huber), gr.huber / chi,
                            torch.ones_like(chi))
        wm = wbase * scale[..., None]
        H, b = _normal_equations(r, Ji, Jj, wm, idx)
        H = H * pin[:, None] * pin[None, :] + torch.diag(1.0 - pin)
        H = H + f32(damping) * eye
        L = torch.linalg.cholesky(H)
        yv = torch.linalg.solve_triangular(L, -(b * pin)[..., None], upper=False)
        dx = torch.linalg.solve_triangular(L.transpose(1, 2), yv,
                                           upper=True)[..., 0].float()
        nodes = nodes + dx.reshape(B, K, 3)
        nodes = torch.cat([nodes[..., :2], wrap(nodes[..., 2:])], dim=-1)
        costs.append((r * wm * r).double().sum(dim=(1, 2)).float())
    return nodes, torch.stack(costs, dim=1)


# ------------------------------------------------------------ pipeline

def _pad_t(a, padn: int, value):
    if not padn:
        return a
    pad = torch.full((a.shape[0], padn) + a.shape[2:], value, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=1)


def _kf_slots(beams, sched, kf_every: int, cfg: Config):
    """Pass 1's keyframe slots: every kf_every-th frame, padded to whole
    chunks of match_chunk_intervals keyframes, with the recenter schedule
    composed over each keyframe interval (zero-fill shifts compose) and
    each chunk's start origin."""
    B, T = sched["ox"].shape
    C = kf_every * max(int(cfg.slam.match_chunk_intervals), 1)
    nc = -(-T // C)
    padn = nc * C - T
    sch = {k: _pad_t(v, padn, 0) for k, v in sched.items()}
    for k in ("ox", "oy"):
        sch[k] = torch.cat([sched[k], sched[k][:, -1:].expand(B, padn)], 1)
    beams_p = _pad_t(beams, padn, float("nan"))
    n_kf = len(range(0, C, kf_every))
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
    ox, oy = sch["ox"][:, ::kf_every], sch["oy"][:, ::kf_every]
    return {"C": C, "nc": nc, "n_kf": n_kf, "beams": beams_p[:, ::kf_every],
            "ox": ox, "oy": oy,
            "sox": ox[:, ::n_kf].repeat_interleave(n_kf, dim=1),
            "soy": oy[:, ::n_kf].repeat_interleave(n_kf, dim=1),
            "comp": comp, "tail": tail}


def _map_pass(beams, poses, cfg: Config, kf_every: int, sched, n_iters: int,
              lowp: bool):
    """Feedback-free pass 1: per round, the keyframe scans land at the
    current estimates on a map whose chunk-start slabs each keyframe then
    matches; a match whose quality clears match_min_quality replaces its
    keyframe's estimate.  Returns the matched poses [B, T, 3]."""
    s, g = cfg.slam, cfg.geom
    B, T = poses.shape[:2]
    sl = _kf_slots(beams, sched, kf_every, cfg)
    K_p = sl["nc"] * sl["n_kf"]
    K = len(range(0, T, kf_every))
    zero_grids = torch.zeros((B, g.prows, g.pcols), dtype=torch.int8,
                             device=poses.device)
    matched = poses
    for _ in range(max(n_iters, 1)):
        kp = _pad_t(matched, sl["nc"] * sl["C"] - T, 0.0)[:, ::kf_every]
        x, y, yaw = kp[..., 0], kp[..., 1], kp[..., 2] * RAD2DEG
        pcx, pcy = world_to_cell(x, y, sl["sox"], sl["soy"], cfg.map.res_m,
                                 cfg.map.width // 2, cfg.map.height // 2)
        wy0, wx0 = window_origin(pcx, pcy, g)
        r0s, c0s = snap_align(wy0, wx0, g)
        c = sl["comp"]
        _, snaps = raster(zero_grids, sl["beams"], x, y, yaw, sl["ox"],
                          sl["oy"], c["do"], c["rsy"], c["rsx"], cfg,
                          snap_at=(r0s, c0s), n_kf=sl["n_kf"], lowp=lowp)
        fl = lambda a: a.reshape((B * K_p,) + a.shape[2:])           # noqa: E731
        res = match(fl(snaps), fl(r0s), fl(c0s), fl(sl["beams"]), fl(x),
                    fl(y), fl(yaw), fl(sl["sox"]), fl(sl["soy"]), cfg,
                    s.match_n_xy, s.match_n_yaw)
        ok = (res.quality > f32(s.match_min_quality)).reshape(B, K_p)
        pick = lambda a, b: torch.where(ok, a.reshape(B, K_p), b)    # noqa: E731
        mk = torch.stack([pick(res.x, x), pick(res.y, y),
                          pick(res.yaw_deg, yaw) * DEG2RAD], dim=-1)
        matched = matched.clone()
        matched[:, ::kf_every] = mk[:, :K]
        if lowp:
            matched = lowp_round(matched)
    return matched


def _loop_stage(kfp, kf_beams, kf_ox, kf_oy, cfg: Config):
    """Loop edges: each keyframe j matched against each of its loop_cand
    nearest keyframes i at least loop_min_gap older (i's endpoint field,
    rastered from its scan alone, in i's origin); proximity-gated and
    quality-gated, the loop_edges best by quality per keyframe.  Returns
    ((ij [B, E, 2], z [B, E, 3], ok [B, E], quality [B, E]), the
    candidates inside the proximity gate [B, n_cand, K])."""
    s, g, m = cfg.slam, cfg.geom, cfg.map
    B, K = kfp.shape[:2]
    dev = kfp.device
    WR, WC = g.win_rows, g.win_cols
    rays = make_rays(kf_beams, kfp[..., 0], kfp[..., 1], kfp[..., 2] * RAD2DEG,
                     kf_ox, kf_oy, torch.ones_like(kf_ox, dtype=torch.bool),
                     m, cfg.tof)
    d = torch.where(rays["valid"], rays["delta"], torch.zeros_like(rays["delta"]))
    win = torch.zeros((B * K, WR * WC), dtype=torch.int32, device=dev)
    win.scatter_add_(1, ((rays["ey"] + g.win_r) * WC
                         + rays["ex"] + g.win_r).reshape(B * K, 32).long(),
                     d.reshape(B * K, 32))
    wins = win.clamp(0, m.lo_max).to(torch.int8).reshape(B, K, WR, WC)
    wy0s = rays["pcy"] + g.pad - g.win_r
    wx0s = rays["pcx"] + g.pad - g.win_r
    n_cand = max(int(s.loop_cand), int(s.loop_edges), 1)
    pos = kfp[..., :2]
    d2 = ((pos[:, None, :, :] - pos[:, :, None, :]) ** 2).sum(-1)   # [B, i, j]
    iidx = torch.arange(K, device=dev)
    cand = torch.where((iidx[None, :] - iidx[:, None]) >= s.loop_min_gap, d2,
                       torch.full_like(d2, float("inf")))
    r2 = f32(F32(s.loop_r_max_m) ** 2)
    ics, nears = [], []
    for _ in range(n_cand):
        i_best = torch.argmin(cand, dim=1)
        nears.append(torch.gather(cand, 1, i_best[:, None, :])[:, 0] < r2)
        cand = torch.where(iidx[None, :, None] == i_best[:, None, :],
                           torch.full_like(cand, float("inf")), cand)
        ics.append(i_best)
    ic, near = torch.stack(ics, 1), torch.stack(nears, 1)   # [B, n_cand, K]
    NC = n_cand * K
    icf = ic.reshape(B, NC)
    gat = lambda a: torch.gather(a, 1, icf)                           # noqa: E731
    win_g = wins[torch.arange(B, device=dev)[:, None], icf]
    pi = torch.gather(kfp, 1, icf[..., None].expand(B, NC, 3))
    pj = kfp[:, None].expand(B, n_cand, K, 3).reshape(B, NC, 3)
    bj = kf_beams[:, None].expand((B, n_cand) + kf_beams.shape[1:]).reshape(
        (B, NC) + kf_beams.shape[2:])
    fl = lambda a: a.reshape((B * NC,) + a.shape[2:])                 # noqa: E731
    res = match(fl(win_g).contiguous(), fl(gat(wy0s)), fl(gat(wx0s)), fl(bj),
                fl(pj[..., 0]), fl(pj[..., 1]), fl(pj[..., 2]) * RAD2DEG,
                fl(gat(kf_ox)), fl(gat(kf_oy)), cfg, s.loop_n_xy, s.loop_n_yaw)
    pj_corr = torch.stack([res.x, res.y, res.yaw_deg * DEG2RAD],
                          -1).reshape(B, NC, 3)
    zc = se2_relative(pi, pj_corr).reshape(B, n_cand, K, 3)
    q = res.quality.reshape(B, n_cand, K)
    qc = torch.where(near & (q > f32(s.loop_min_quality)), q,
                     torch.full_like(q, float("-inf")))
    carange = torch.arange(n_cand, device=dev)[None, :, None]
    ninf = torch.full_like(qc, float("-inf"))
    ijs, zs, oks, qs = [], [], [], []
    for _ in range(max(int(s.loop_edges), 1)):
        sel = torch.argmax(qc, dim=1)
        pk = carange == sel[:, None, :]
        ijs.append(torch.stack([torch.where(pk, ic, 0).sum(1),
                                iidx.expand(B, K)], -1))
        zs.append(torch.where(pk[..., None], zc, 0.0).sum(1))
        qb = torch.where(pk, qc, ninf).amax(1)
        okb = torch.isfinite(qb)
        oks.append(okb)
        qs.append(torch.where(okb, qb, torch.zeros_like(qb)))
        qc = torch.where(pk, ninf, qc)
    return (torch.cat(ijs, 1), torch.cat(zs, 1), torch.cat(oks, 1),
            torch.cat(qs, 1)), near


def _solve(odo, matched, kf_idx, loop, sc, cfg: Config, iters: int,
           nodes0=None):
    """The pose graph: odometry edges scaled by sc [B], match anchors to
    node 0, the loop edges; solved by Gauss-Newton."""
    s = cfg.slam
    lij, lz, lok, lq = loop
    B, K = odo.shape[0], kf_idx.shape[0]
    dev = odo.device
    kf = odo[:, kf_idx]
    one = torch.ones_like(sc)
    z = se2_relative(kf[:, :-1], kf[:, 1:]) * torch.stack([sc, sc, one],
                                                          -1)[:, None, :]
    ar = torch.arange(K - 1, device=dev)
    gr = Graph(kf, torch.stack([ar, ar + 1], -1).expand(B, K - 1, 2), z,
               torch.tensor([f32(v) for v in s.odo_w], dtype=torch.float32,
                            device=dev).expand(B, K - 1, 3),
               torch.ones((B, K - 1), dtype=torch.bool, device=dev),
               torch.zeros((B, K - 1), dtype=torch.float32, device=dev))
    mk = matched[:, kf_idx]
    anchors = se2_relative(mk[:, :1].expand(B, K - 1, 3), mk[:, 1:])
    ar1 = torch.arange(1, K, device=dev)
    gr = add_edges(gr, torch.stack([torch.zeros_like(ar1), ar1],
                                   -1).expand(B, K - 1, 2), anchors,
                   [f32(v) for v in s.anchor_w])
    qsc = div_f32(lq, f32(s.loop_q_ref)).clamp(f32(s.loop_q_min),
                                               f32(s.loop_q_max))
    w = torch.tensor([f32(v) for v in s.loop_w], dtype=torch.float32,
                     device=dev)[None, None, :] * qsc[..., None]
    gr = add_edges(gr, lij, lz, w, mask=lok, huber=s.loop_huber)
    nodes = nodes0 if nodes0 is not None else torch.cat(
        [mk[:, :1], gr.nodes[:, 1:]], dim=1)
    return gauss_newton(gr._replace(nodes=nodes), iters)


def _norm2(v):
    return sqrt_f32(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def slam_replay(frames: dict, cfg: Config, lowp: bool = False) -> dict:
    """The SLAM replay of a [B] batch.  Returns {grid, track [B, T, 3],
    odo, kf_nodes [B, K, 3], origin_x, origin_y, and the last loop
    stage's accepted edges loop_ok [B, E] and gated candidates loop_near
    [B, n_cand, K]}."""
    s, g = cfg.slam, cfg.geom
    if s.match_feedback or not s.match_map_kf_only:
        raise ValueError("the reference holds the feedback-free pass 1 only")
    q = lowp_round if lowp else (lambda a: a)
    kf_every, gn_iters = s.kf_every, s.gn_iters
    B, T = frames["x_m"].shape
    dev = frames["x_m"].device
    beams, _ = extract_beams(frames["grid_mm"], cfg.tof)
    kf_idx = torch.arange(0, T, kf_every, device=dev)
    K = kf_idx.shape[0]
    odo, sched = odometry_and_schedule(frames, cfg)
    odo = q(odo)
    kf_beams = beams[:, kf_idx]
    kf_ox, kf_oy = sched["ox"][:, kf_idx], sched["oy"][:, kf_idx]
    owner = (torch.arange(T, device=dev) // kf_every).clamp(0, K - 1)
    rel = se2_relative(odo[:, kf_idx][:, owner], odo)
    odo_kf_d = _norm2(torch.diff(odo[:, kf_idx, :2], dim=1))
    est = odo
    sc = torch.ones((B,), dtype=torch.float32, device=dev)
    n_outer = max(int(s.slam_outer), 1)
    it_later = int(s.match_iters_later) if int(s.match_iters_later) > 0 \
        else int(s.match_iters)
    gn_ref = int(s.gn_refine_iters) if int(s.gn_refine_iters) > 0 else None
    for rnd in range(n_outer):
        last = rnd == n_outer - 1
        matched = _map_pass(beams, est, cfg, kf_every, sched,
                            int(s.match_iters) if rnd == 0 else it_later, lowp)
        loop, near = _loop_stage(matched[:, kf_idx], kf_beams, kf_ox, kf_oy,
                                 cfg)
        kf_nodes, _ = _solve(odo, matched, kf_idx, loop, sc, cfg, gn_iters)
        n_ref = max(int(s.loop_refine if last else (
            s.loop_refine_early if int(s.loop_refine_early) >= 0
            else s.loop_refine)), 0)
        for _ in range(n_ref):
            loop, near = _loop_stage(kf_nodes, kf_beams, kf_ox, kf_oy, cfg)
            kf_nodes, _ = _solve(odo, matched, kf_idx, loop, sc, cfg,
                                 gn_iters if gn_ref is None else gn_ref,
                                 nodes0=None if gn_ref is None else kf_nodes)
        kf_nodes = q(kf_nodes)
        sol_kf_d = _norm2(torch.diff(kf_nodes[..., :2], dim=1))
        sc = ((odo_kf_d * sol_kf_d).double().sum(1).float()
              / (odo_kf_d * odo_kf_d).double().sum(1).float().clamp_min(
                  f32(1e-9))).clamp(f32(s.odo_scale_min), f32(s.odo_scale_max))
        rel_sc = rel * torch.stack([sc, sc, torch.ones_like(sc)],
                                   -1)[:, None, :]
        est = q(se2_compose(kf_nodes[:, owner], rel_sc))
    track = est
    zero = torch.zeros((B, g.prows, g.pcols), dtype=torch.int8, device=dev)
    grid, _ = raster(zero, beams, track[..., 0], track[..., 1],
                     track[..., 2] * RAD2DEG, sched["ox"], sched["oy"],
                     sched["do"], sched["rsy"], sched["rsx"], cfg)
    return {"grid": grid, "track": track, "odo": odo, "kf_nodes": kf_nodes,
            "origin_x": sched["ox"][:, -1], "origin_y": sched["oy"][:, -1],
            "loop_ok": loop[2], "loop_near": near}
