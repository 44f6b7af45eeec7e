"""Fusion replay in PyTorch: recompute the pose track with the explicit EKF
(counterpart of micro_quad_slam_tpu/replay/fusion.py).

The reference logged ArduPilot EKF3's LOCAL_POSITION_NED beside the raw
flow and rangefinder streams in each scanrec (uav_local_nav.c:1168-1195).
This module replays those streams through ops/ekf.py for a [B] batch of
flights, one [B]-wide EKF step per frame, and measures the recomputed
track against the logged one (north star: pose RMSE <= 1 cm).
"""

from __future__ import annotations

import numpy as np
import torch

from micro_quad_slam_tpu_torch.ops.ekf import EkfState, ekf_init, ekf_step
from micro_quad_slam_tpu_torch.ops.raycast import _f
from micro_quad_slam_tpu_torch.utils.config import PipelineConfig, UL_PROFILE

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


def _ekf_replay_batched(frames: dict, cfg: PipelineConfig, extra=None):
    """frames: dict of [B, T] tensors -> (final EkfState [B], track dict of
    [B, T] tensors: x, y, vx, vy, z, vz, yaw, flow_used).

    extra: optional (init_carry, step_fn) run inside the same loop over T;
    step_fn(carry, mean, frame) -> (carry, out_dict) sees each step's
    posterior mean, and its outputs join the track.  The SLAM pipeline
    decides its recenter schedule this way, so the EKF is defined once."""
    rx = frames["of_rate_x"]
    B, T = rx.shape
    dev = rx.device
    # dt from the sensor-side clock (uav_local_nav.c:1362-1364); the first
    # frame gets dt = 0, and clock glitches clip to [0, 1] s
    ms = frames["scan_ms"]
    dt = torch.diff(ms, dim=1, prepend=ms[:, :1]).to(torch.float32) * _f(1e-3)
    dt = dt.clamp(0.0, 1.0)
    yaw = frames["yaw_deg"] * DEG2RAD

    # seed the position from the first logged pose, yaw and z from the
    # first attitude and rangefinder samples
    st = ekf_init((B,), device=dev)
    mean = st.mean.clone()
    mean[:, 0] = _nan_to_zero(frames["x_m"][:, 0])
    mean[:, 1] = _nan_to_zero(frames["y_m"][:, 0])
    mean[:, 4] = _nan_to_zero(frames["rf_m"][:, 0])
    mean[:, 6] = _nan_to_zero(yaw[:, 0])
    st = EkfState(mean, st.cov)

    xc = None if extra is None else extra[0]
    means, flow_used, xouts = [], [], []
    for t in range(T):
        f = {"dt": dt[:, t], "rx": rx[:, t], "ry": frames["of_rate_y"][:, t],
             "q": frames["of_q"][:, t], "rf": frames["rf_m"][:, t],
             "yaw": yaw[:, t]}
        st, diag = ekf_step(st, f["dt"], f["rx"], f["ry"], f["q"], f["rf"],
                            f["yaw"], cfg.ekf)
        means.append(st.mean)
        flow_used.append(diag["flow_used"])
        if extra is not None:
            xc, xout = extra[1](xc, st.mean, f)
            xouts.append(xout)
    m = torch.stack(means, dim=1)                       # [B, T, 8]
    track = {k: m[..., i] for i, k in enumerate(
        ("x", "y", "vx", "vy", "z", "vz", "yaw"))}
    track["flow_used"] = torch.stack(flow_used, dim=1)
    for k in (xouts[0] if xouts else {}):
        track[k] = torch.stack([o[k] for o in xouts], dim=1)
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
