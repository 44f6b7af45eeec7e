"""Explicit full-pose EKF in PyTorch: optical flow + rangefinder + attitude
fusion (counterpart of micro_quad_slam_tpu/ops/ekf.py).

Model (per quad, float32, batched over any leading dims):

  state   s = [x, y, vx, vy, z, vz, yaw, wz]
  predict constant-velocity / constant-yaw-rate; P' = F P F^T + Q(dt)
  updates (each gated on its own, Joseph-form covariance):
    yaw   <- logged attitude yaw, wrap-aware innovation
    z     <- rangefinder distance
    v_xy  <- flow-derived body-frame velocity z_b = flow_rate * ground with
             the full Jacobian h(s) = R(-yaw) [vx, vy]^T (d/dyaw included)

The covariance algebra is the JAX module's expanded form (row and column
shifts, rank-1 and rank-2 outer products) term for term, in the same
order, so the two packages round alike: a batched 8x8 matmul would sum in
another order.  Trig is the correctly rounded float32 value
(ops/raycast.py::_cos_f32); XLA-CPU's differs by an ulp on some angles,
so the two packages agree to a tolerance, not bit for bit.  Everything
stays in eager torch ops: no compiler may contract a product and a sum.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.ops.raycast import (
    _cos_f32, _f, _sin_f32, div_f32)
from micro_quad_slam_tpu_torch.utils.config import EkfConfig

_F32 = np.float32
_N = 8
_IX, _IY, _IVX, _IVY, _IZ, _IVZ, _IYAW, _IWZ = range(_N)
# the (pos, vel) pairs F couples: pos += vel * dt
_COUPLED = (_IX, _IY, _IZ, _IYAW)
_VEL = (_IVX, _IVY, _IVZ, _IWZ)


class EkfState(NamedTuple):
    mean: torch.Tensor   # f32 [..., 8]  (x, y, vx, vy, z, vz, yaw, wz)
    cov: torch.Tensor    # f32 [..., 8, 8]


def ekf_init(batch: tuple = (), x0=0.0, y0=0.0, pos_var=1e-4, vel_var=1e-2,
             z0=0.0, yaw0=0.0, yaw_var=1e-2, device=None) -> EkfState:
    """The initial state of a batch of filters on `device` (the CUDA device
    unless told otherwise, replay/mapping.py::as_device); x0, y0, z0 and
    yaw0 are floats or tensors of shape `batch`."""
    from micro_quad_slam_tpu_torch.replay.mapping import as_device

    device = as_device(device)
    mean = torch.zeros(batch + (_N,), dtype=torch.float32, device=device)
    for i, v in ((_IX, x0), (_IY, y0), (_IZ, z0), (_IYAW, yaw0)):
        mean[..., i] = _f(v) if isinstance(v, float) else v
    cov = torch.zeros(batch + (_N, _N), dtype=torch.float32, device=device)
    for i in (_IX, _IY, _IZ):
        cov[..., i, i] = _f(pos_var)
    for i in (_IVX, _IVY, _IVZ):
        cov[..., i, i] = _f(vel_var)
    cov[..., _IYAW, _IYAW] = _f(yaw_var)
    cov[..., _IWZ, _IWZ] = _f(1e-2)
    return EkfState(mean, cov)


_consts: dict = {}     # device -> the predict's index and mask tensors


def _predict_consts(device):
    """The predict's static tensors, made once per device: a tensor made
    from host data inside the replay loop would copy host to device (and
    wait for the card) at every step."""
    if device not in _consts:
        # (E P)[pos, :] = P[vel, :] for the coupled rows, else 0
        rowmap = list(range(_N))
        for pos, v in zip(_COUPLED, _VEL):
            rowmap[pos] = v
        sel = torch.zeros(_N, dtype=torch.float32)
        sel[list(_COUPLED)] = 1.0
        _consts[device] = tuple(t.to(device) for t in (
            torch.tensor(_COUPLED), torch.tensor(_VEL), torch.tensor(rowmap),
            sel, torch.eye(_N, dtype=torch.float32)))
    return _consts[device]


def ekf_predict(state: EkfState, dt, cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Constant-velocity / constant-yaw-rate predict, dt-scaled noise:
    F P F^T = P + dt*(E P + (E P)^T) + dt^2 * E P E^T with E the four
    (pos, vel) couplings, as static row/column gathers."""
    mean, P = state.mean, state.cov
    coupled, vel, rowmap, sel, eye = _predict_consts(mean.device)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=mean.device)
    d = dt[..., None]
    mean = mean.index_add(-1, coupled, mean.index_select(-1, vel) * d)

    EP = P.index_select(-2, rowmap) * sel[:, None]
    EPEt = EP.index_select(-1, rowmap) * sel
    dt2 = d[..., None]
    cov = P + dt2 * (EP + EP.transpose(-1, -2)) + dt2 * dt2 * EPEt

    qdiag = [cfg.q_pos, cfg.q_pos, cfg.q_vel, cfg.q_vel,
             cfg.q_pos, cfg.q_vz, cfg.q_yaw, cfg.q_wz]
    q = torch.stack([_f(v) * dt for v in qdiag], dim=-1)
    return EkfState(mean, cov + q[..., None] * eye)


def flow_world_velocity(of_rate_x, of_rate_y, ground_m, yaw_rad):
    """Flow rates (rad/s) + ground distance -> world-frame velocity [..., 2]."""
    vbx = of_rate_x * ground_m
    vby = of_rate_y * ground_m
    c, s = _cos_f32(yaw_rad), _sin_f32(yaw_rad)
    return torch.stack([c * vbx - s * vby, s * vbx + c * vby], dim=-1)


def _update_scalar(state: EkfState, idx: int, innov, valid, r) -> EkfState:
    """Scalar measurement on state component idx (H = e_idx^T), Joseph form
    expanded: P - K (x) P[idx, :] - P[:, idx] (x) K + (P[idx, idx] + r) K (x) K."""
    mean, cov = state.mean, state.cov
    S = cov[..., idx, idx] + _f(r)
    K = cov[..., :, idx] / S[..., None]
    new_mean = mean + K * innov[..., None]
    Kc, Kr = K[..., :, None], K[..., None, :]
    prow = cov[..., idx:idx + 1, :]
    pcol = cov[..., :, idx:idx + 1]
    new_cov = cov - Kc * prow - pcol * Kr + S[..., None, None] * (Kc * Kr)
    return EkfState(torch.where(valid[..., None], new_mean, mean),
                    torch.where(valid[..., None, None], new_cov, cov))


def wrap_pi(a):
    """Wrap radians to [-pi, pi)."""
    two_pi = _f(2.0 * np.pi)
    return a - two_pi * torch.floor(div_f32(a + _f(np.pi), two_pi))


def ekf_update_yaw(state: EkfState, yaw_meas, valid, r_yaw) -> EkfState:
    """Attitude yaw as a direct measurement, wrap-aware innovation."""
    z = torch.where(valid, yaw_meas, torch.zeros_like(yaw_meas))
    innov = wrap_pi(z - state.mean[..., _IYAW])
    return _update_scalar(state, _IYAW, innov, valid, r_yaw)


def ekf_update_rangefinder(state: EkfState, rf_m, valid, r_rf) -> EkfState:
    """Rangefinder distance as a direct altitude measurement."""
    innov = torch.where(valid, rf_m, torch.zeros_like(rf_m)) - state.mean[..., _IZ]
    return _update_scalar(state, _IZ, innov, valid, r_rf)


def ekf_update_velocity(state: EkfState, z_body, valid, r_vel) -> tuple:
    """Flow body-velocity update with the full EKF Jacobian; H has nonzero
    columns at (vx, vy, yaw).  Returns (state, world-frame innovation
    [..., 2])."""
    mean, cov = state.mean, state.cov
    r_vel = _f(r_vel)
    c = _cos_f32(mean[..., _IYAW])
    s = _sin_f32(mean[..., _IYAW])
    vx, vy = mean[..., _IVX], mean[..., _IVY]
    hb = torch.stack([c * vx + s * vy, -s * vx + c * vy], dim=-1)
    innov_b = z_body - hb

    h0y = -s * vx + c * vy
    h1y = -c * vx - s * vy
    Pvx, Pvy, Pyw = cov[..., :, _IVX], cov[..., :, _IVY], cov[..., :, _IYAW]
    un = lambda a_: a_[..., None]                                    # noqa: E731
    PHt0 = un(c) * Pvx + un(s) * Pvy + un(h0y) * Pyw
    PHt1 = un(-s) * Pvx + un(c) * Pvy + un(h1y) * Pyw
    dotH0 = lambda p: c * p[..., _IVX] + s * p[..., _IVY] + h0y * p[..., _IYAW]  # noqa: E731
    dotH1 = lambda p: -s * p[..., _IVX] + c * p[..., _IVY] + h1y * p[..., _IYAW]  # noqa: E731
    a = dotH0(PHt0) + r_vel
    b = dotH0(PHt1)
    c2 = dotH1(PHt0)
    d = dotH1(PHt1) + r_vel
    det = a * d - b * c2
    i00, i01 = d / det, -b / det
    i10, i11 = -c2 / det, a / det
    K0 = PHt0 * un(i00) + PHt1 * un(i10)
    K1 = PHt0 * un(i01) + PHt1 * un(i11)

    new_mean = mean + K0 * un(innov_b[..., 0]) + K1 * un(innov_b[..., 1])

    Mvx = un(c) * K0 + un(-s) * K1
    Mvy = un(s) * K0 + un(c) * K1
    Myw = un(h0y) * K0 + un(h1y) * K1
    row = lambda i: cov[..., i, :]                                   # noqa: E731
    MP = (Mvx[..., :, None] * row(_IVX)[..., None, :]
          + Mvy[..., :, None] * row(_IVY)[..., None, :]
          + Myw[..., :, None] * row(_IYAW)[..., None, :])
    MPM = (MP[..., :, _IVX, None] * Mvx[..., None, :]
           + MP[..., :, _IVY, None] * Mvy[..., None, :]
           + MP[..., :, _IYAW, None] * Myw[..., None, :])
    KK = (K0[..., :, None] * K0[..., None, :]
          + K1[..., :, None] * K1[..., None, :])
    new_cov = cov - MP - MP.transpose(-1, -2) + MPM + r_vel * KK

    v = valid[..., None]
    mean = torch.where(v, new_mean, mean)
    cov = torch.where(valid[..., None, None], new_cov, cov)
    innov_w = torch.stack([c * innov_b[..., 0] - s * innov_b[..., 1],
                           s * innov_b[..., 0] + c * innov_b[..., 1]], dim=-1)
    return EkfState(mean, cov), torch.where(v, innov_w, torch.zeros_like(innov_w))


def ekf_step(state: EkfState, dt, of_rate_x, of_rate_y, of_q, ground_m,
             yaw_rad, cfg: EkfConfig = EkfConfig()):
    """One predict + (yaw, rangefinder, flow) update cycle from raw scanrec
    sensor fields.  Flow fuses when its rates are finite, quality >=
    cfg.min_flow_quality and the ground distance is finite and above
    cfg.min_ground_m; the rangefinder under the same distance gate (and
    < 10 m); the yaw whenever finite.  Returns (state, diag dict)."""
    v_prev = state.mean[..., _IVX:_IVY + 1]
    state = ekf_predict(state, dt, cfg)

    state = ekf_update_yaw(state, yaw_rad, torch.isfinite(yaw_rad), cfg.r_yaw)

    rf_ok = (torch.isfinite(ground_m) & (ground_m > _f(cfg.min_ground_m))
             & (ground_m < 10.0))
    state = ekf_update_rangefinder(state, ground_m, rf_ok, cfg.r_rf)

    valid = (torch.isfinite(of_rate_x) & torch.isfinite(of_rate_y)
             & (of_q >= cfg.min_flow_quality)
             & torch.isfinite(ground_m) & (ground_m > _f(cfg.min_ground_m)))
    zero = torch.zeros_like(of_rate_x)
    z_body = torch.stack([torch.where(valid, of_rate_x * ground_m, zero),
                          torch.where(valid, of_rate_y * ground_m, zero)],
                         dim=-1)
    state, innov = ekf_update_velocity(state, z_body, valid, cfg.r_flow_vel)
    # trapezoidal position refinement 0.5*(v_new - v_prev)*dt (a no-op when
    # the flow update was gated off)
    v_new = state.mean[..., _IVX:_IVY + 1]
    dt_arr = torch.as_tensor(dt, dtype=torch.float32,
                             device=v_new.device)[..., None]
    corr = 0.5 * (v_new - v_prev) * dt_arr
    mean = torch.cat([state.mean[..., :_IY + 1] + corr,
                      state.mean[..., _IY + 1:]], dim=-1)
    # one symmetrization per step: the expanded updates read P by rows and
    # by columns, so float32 asymmetry would otherwise compound
    cov = 0.5 * (state.cov + state.cov.transpose(-1, -2))
    return EkfState(mean, cov), {"flow_used": valid, "innovation": innov}
