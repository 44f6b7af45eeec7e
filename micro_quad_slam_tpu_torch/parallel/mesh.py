"""Batch-level metrics of a replay (counterpart of
micro_quad_slam_tpu/parallel/mesh.py::batch_metrics).  Splitting flights
across several CUDA devices is ported later (ROADMAP.md A12)."""

from __future__ import annotations

import torch


def batch_metrics(outs: dict) -> dict:
    """Aggregate per-frame outputs [B, T] to scalar int64 tensors on the
    outputs' device."""
    used = outs["used"]
    return {
        "frames_total": torch.tensor(used.numel(), device=used.device),
        "frames_used": used.sum(),
        "recenters": (outs["kf_flags"] != 0).sum(),
    }
