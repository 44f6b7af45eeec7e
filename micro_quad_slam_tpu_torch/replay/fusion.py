"""Fusion replay in PyTorch: recompute the pose track with the explicit EKF
(counterpart of micro_quad_slam_tpu/replay/fusion.py).

The reference logged ArduPilot EKF3's LOCAL_POSITION_NED beside the raw
flow and rangefinder streams in each scanrec (uav_local_nav.c:1168-1195).
This module replays those streams through ops/ekf.py for a [B] batch of
flights and measures the recomputed track against the logged one (north
star: pose RMSE <= 1 cm).  On a CUDA device the whole replay is one
launch of csrc/ekf.cuh's kernel (`ekf_replay_kernel`), which can also
decide the SLAM pipeline's recenter schedule from each posterior; on the
CPU it is the plain loop of [B]-wide ekf_step calls over T
(`ekf_replay_plain`), the kernel's twin in the card tests.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from micro_quad_slam_tpu_torch.ops import _build
from micro_quad_slam_tpu_torch.ops.ekf import EkfState, ekf_init, ekf_step
from micro_quad_slam_tpu_torch.ops.raycast import (
    _f,
    recenter_constants,
    recenter_decide,
    shift_origin,
)
from micro_quad_slam_tpu_torch.utils.config import PipelineConfig, UL_PROFILE

_F32 = np.float32
DEG2RAD = _f(np.pi / 180.0)     # jnp.deg2rad's float32 constant
RAD2DEG = _f(180.0 / np.pi)     # jnp.rad2deg's


def fusion_arrays(scanlog) -> dict:
    """Host-side: ScanLog -> EKF replay inputs [T] (numpy)."""
    return {
        "scan_ms": np.ascontiguousarray(scanlog.scan_ms).astype(np.int64),
        "of_rate_x": np.ascontiguousarray(scanlog.of_rate_x),
        "of_rate_y": np.ascontiguousarray(scanlog.of_rate_y),
        "of_q": np.ascontiguousarray(scanlog.of_q).astype(np.int32),
        "rf_m": np.ascontiguousarray(scanlog.rf_m),
        "yaw_deg": np.ascontiguousarray(scanlog.yaw_deg),
        "x_m": np.ascontiguousarray(scanlog.x_m),
        "y_m": np.ascontiguousarray(scanlog.y_m),
    }


def _nan_to_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(a), torch.zeros_like(a), a)


# the recenter schedule's outputs, [B, T] each
SCHED_KEYS = ("ox", "oy", "do", "rsy", "rsx")


def replay_operands(frames: dict) -> tuple:
    """What the EKF replay takes from frames [B, T]: (seq {dt, yaw, rx, ry,
    q, rf} of [B, T], contiguous, q int32; the seeded initial EkfState
    [B])."""
    rx = frames["of_rate_x"]
    if rx.dim() != 2 or rx.shape[1] == 0:
        raise ValueError(f"frames must be [B, T] with T >= 1, got "
                         f"of_rate_x of shape {tuple(rx.shape)}")
    B = rx.shape[0]
    # dt from the sensor-side clock (uav_local_nav.c:1362-1364); the first
    # frame gets dt = 0, and clock glitches clip to [0, 1] s
    ms = frames["scan_ms"]
    dt = torch.diff(ms, dim=1, prepend=ms[:, :1]).to(torch.float32) * _f(1e-3)
    dt = dt.clamp(0.0, 1.0)
    yaw = frames["yaw_deg"] * DEG2RAD

    # seed the position from the first logged pose, yaw and z from the
    # first attitude and rangefinder samples
    st = ekf_init((B,), device=rx.device)
    mean = st.mean.clone()
    mean[:, 0] = _nan_to_zero(frames["x_m"][:, 0])
    mean[:, 1] = _nan_to_zero(frames["y_m"][:, 0])
    mean[:, 4] = _nan_to_zero(frames["rf_m"][:, 0])
    mean[:, 6] = _nan_to_zero(yaw[:, 0])
    seq = {"dt": dt, "yaw": yaw, "rx": rx, "ry": frames["of_rate_y"],
           "q": frames["of_q"].to(torch.int32), "rf": frames["rf_m"]}
    return ({k: v.contiguous() for k, v in seq.items()},
            EkfState(mean, st.cov))


def _recenter_step(ox, oy, mean, cfg: PipelineConfig):
    """One frame of the SLAM recenter schedule from the posterior mean
    [B, 8]: a NaN origin adopts the posterior position, then
    recenter_decide and shift_origin.  Returns {SCHED_KEYS} of [B]: the
    origins after the shift, the recenter flag, the shifts."""
    x, y = mean[..., 0], mean[..., 1]
    ox = torch.where(torch.isnan(ox), x, ox)
    oy = torch.where(torch.isnan(oy), y, oy)
    ok = torch.isfinite(x) & torch.isfinite(y)
    sx, sy, do = recenter_decide(ox, oy, x, y, ok, cfg.map)
    res = _F32(cfg.map.res_m)
    ox, oy = shift_origin(ox, sx, res), shift_origin(oy, sy, res)
    return dict(zip(SCHED_KEYS, (ox, oy, do.to(torch.int32), sy, sx)))


def ekf_replay_plain(seq: dict, st0: EkfState, cfg: PipelineConfig,
                     origin0=None):
    """Plain torch version of the EKF replay kernel, on any device: a
    Python loop over T of [B]-wide ekf_step calls, and with origin0 =
    (ox, oy) [B] also the recenter schedule from those origins.  seq and
    st0 as replay_operands gives them.

    Returns (final EkfState [B], means [B, T, 8], flow_used [B, T], the
    schedule {SCHED_KEYS} of [B, T] or None)."""
    st = st0
    means, flow_used = [], []
    steps = None if origin0 is None else {k: [] for k in SCHED_KEYS}
    ox, oy = (None, None) if origin0 is None else origin0
    for t in range(seq["dt"].shape[1]):
        st, diag = ekf_step(st, seq["dt"][:, t], seq["rx"][:, t],
                            seq["ry"][:, t], seq["q"][:, t], seq["rf"][:, t],
                            seq["yaw"][:, t], cfg.ekf)
        means.append(st.mean)
        flow_used.append(diag["flow_used"])
        if steps is not None:
            out = _recenter_step(ox, oy, st.mean, cfg)
            ox, oy = out["ox"], out["oy"]
            for k in SCHED_KEYS:
                steps[k].append(out[k])
    sched = None if steps is None else {
        k: torch.stack(v, dim=1) for k, v in steps.items()}
    return (st, torch.stack(means, dim=1), torch.stack(flow_used, dim=1),
            sched)


def check_ekf_operands(seq: dict, st0: EkfState, origin0) -> None:
    """Raise on operands the EKF replay kernel does not take: seq's
    tensors contiguous [B, T] on one CUDA device (q int32, the rest
    float32), st0 float32 [B, 8] and [B, 8, 8], origin0 None or two
    float32 [B]."""
    dt = seq["dt"]
    if dt.dim() != 2:
        raise ValueError(f"dt must be [B, T], got {tuple(dt.shape)}")
    B, T = dt.shape
    f32 = torch.float32
    ops = [(k, seq[k], (B, T), torch.int32 if k == "q" else f32)
           for k in ("dt", "yaw", "rx", "ry", "q", "rf")]
    ops += [("mean0", st0.mean, (B, 8), f32), ("cov0", st0.cov, (B, 8, 8), f32)]
    if origin0 is not None:
        ops += [(k, v, (B,), f32) for k, v in zip(("ox0", "oy0"), origin0)]
    for name, v, shape, dtype in ops:
        if v.dtype != dtype:
            raise TypeError(f"ekf replay kernel: {name} must be {dtype}, "
                            f"got {v.dtype}")
        if tuple(v.shape) != shape:
            raise ValueError(f"ekf replay kernel: {name} must be of shape "
                             f"{shape}, got {tuple(v.shape)}")
        if v.device != dt.device:
            raise ValueError(f"ekf replay kernel: {name} on {v.device}, dt "
                             f"on {dt.device}")
        if not v.is_contiguous():
            raise ValueError(f"ekf replay kernel: {name} must be contiguous")
    if dt.device.type != "cuda":
        raise ValueError(f"no EKF replay kernel for device {dt.device} "
                         f"(ekf_replay_plain runs anywhere)")


def ekf_replay_kernel(seq: dict, st0: EkfState, cfg: PipelineConfig,
                      origin0=None):
    """ekf_replay_plain's outputs from one launch of the EKF replay kernel
    (csrc/ekf.cuh; ops/_build.py::ENTRIES names its library), on CUDA
    tensors; bit-equal to ekf_replay_plain on the card.  Raises on
    operands it does not take (check_ekf_operands) and on a failed
    launch.  Each launch counts in launches.ekf_replay (utils/obs.py)."""
    check_ekf_operands(seq, st0, origin0)
    B, T = seq["dt"].shape
    dev = seq["dt"].device
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    means = empty((B, T, 8), torch.float32)
    flow = empty((B, T), torch.bool)
    final = EkfState(empty((B, 8), torch.float32),
                     empty((B, 8, 8), torch.float32))
    sched = None if origin0 is None else {
        "ox": empty((B, T), torch.float32), "oy": empty((B, T), torch.float32),
        **{k: empty((B, T), torch.int32) for k in ("do", "rsy", "rsx")}}
    if B == 0:
        return final, means, flow, sched
    e = cfg.ekf
    qdiag = (ctypes.c_float * 8)(*(_f(v) for v in (
        e.q_pos, e.q_pos, e.q_vel, e.q_vel, e.q_pos, e.q_vz, e.q_yaw,
        e.q_wz)))
    thresh, res, max_shift = recenter_constants(cfg.map)
    ins = [seq[k] for k in ("dt", "yaw", "rx", "ry", "rf", "q")]
    ins += [st0.mean, st0.cov]
    ins += [None, None] if origin0 is None else list(origin0)
    outs = [means, flow]
    outs += ([None] * 5 if sched is None
             else [sched[k] for k in ("ox", "oy", "do", "rsy", "rsx")])
    outs += [final.mean, final.cov]
    _build.launch(None, "mqs_ekf_replay", dev, *ins, *outs, B, T,
                  int(origin0 is not None), qdiag, _f(e.r_yaw), _f(e.r_rf),
                  _f(e.r_flow_vel), _f(e.min_ground_m), 10.0,
                  e.min_flow_quality, _f(np.pi), _f(2.0 * np.pi), thresh,
                  res, 1.0 / res, max_shift)
    return final, means, flow, sched


def _ekf_replay_batched(frames: dict, cfg: PipelineConfig,
                        schedule: bool = False, origin0=None):
    """frames: dict of [B, T] tensors -> (final EkfState [B], track dict of
    [B, T] tensors: x, y, vx, vy, z, vz, yaw, flow_used).

    schedule: also decide the SLAM pipeline's recenter schedule from each
    step's posterior mean, from the origins origin0 = (ox, oy) [B] (None:
    each flight adopts its first posterior position); its outputs
    {SCHED_KEYS} join the track.  On a CUDA device it is one launch of the
    EKF replay kernel (ekf_replay_kernel), anywhere else the plain loop
    over T (ekf_replay_plain)."""
    seq, st0 = replay_operands(frames)
    if schedule and origin0 is None:
        nan = torch.full((st0.mean.shape[0],), float("nan"),
                         dtype=torch.float32, device=st0.mean.device)
        origin0 = (nan, nan)
    origin0 = tuple(o.contiguous() for o in origin0) if schedule else None
    run = (ekf_replay_kernel if seq["dt"].device.type == "cuda"
           else ekf_replay_plain)
    st, m, flow_used, sched = run(seq, st0, cfg, origin0)
    track = {k: m[..., i] for i, k in enumerate(
        ("x", "y", "vx", "vy", "z", "vz", "yaw"))}
    track["flow_used"] = flow_used
    track.update(sched or {})
    return st, track


def replay_fusion_batched(frames: dict, cfg: PipelineConfig = UL_PROFILE):
    """EKF replay of a [B] batch: frames dict of [B, T] tensors (see
    replay/mapping.py::frames_to_torch, which puts them on the CUDA device
    unless told otherwise) -> (final EkfState [B], track of [B, T])."""
    return _ekf_replay_batched(frames, cfg)


def replay_fusion(frames: dict, cfg: PipelineConfig = UL_PROFILE):
    """Single flight: frames dict of [T] tensors."""
    state, track = _ekf_replay_batched({k: v[None] for k, v in frames.items()},
                                       cfg)
    return (EkfState(state.mean[0], state.cov[0]),
            {k: v[0] for k, v in track.items()})


def pose_rmse(track: dict, frames: dict) -> float:
    """RMSE (m) of the recomputed track against the logged pose, over the
    frames where the logged pose is finite."""
    as_np = lambda a: (a.detach().cpu().numpy() if torch.is_tensor(a)  # noqa: E731
                       else np.asarray(a)).astype(np.float64)
    x, y = as_np(frames["x_m"]), as_np(frames["y_m"])
    ok = np.isfinite(x) & np.isfinite(y)
    if not ok.any():
        return float("nan")
    ex, ey = as_np(track["x"]) - x, as_np(track["y"]) - y
    return float(np.sqrt(np.mean(ex[ok] ** 2 + ey[ok] ** 2)))
