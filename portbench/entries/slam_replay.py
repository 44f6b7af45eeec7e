"""Entry slam_replay: the port's SLAM replay,
slam/pipeline.py::slam_replay(frames, cfg, geom), one job a call, judged
by reference/slam.py.

Compared, over every flight of a compared job: the re-rastered int8 grid
cell for cell, the corrected track (every frame), the pose-graph nodes,
their positions in metres and their headings in radians (wrapped).
"""

import math

import torch

from portbench.entries.replay_mapping import wall_iou
from portbench.reference import slam as RS

FRAME_KEYS = ("grid_mm", "x_m", "y_m", "yaw_deg", "of_q", "of_rate_x",
              "of_rate_y", "sys_health", "state", "scan_ms", "rf_m")


def run(frames, prog, args):
    from micro_quad_slam_tpu_torch.slam.pipeline import slam_replay

    return slam_replay(frames, prog.cfg, prog.geom)


def outputs(res) -> dict:
    return {"grid": res.grid, "track": res.track, "kf_nodes": res.kf_nodes,
            "origin_x": res.origin[0], "origin_y": res.origin[1]}


def reference(frames, rcfg, args, lowp: bool = False) -> dict:
    return RS.slam_replay(frames, rcfg, lowp)


def _pose_err(a, b):
    """(max position error (m), max heading error (rad)) of poses [..., 3];
    a NaN anywhere reads as infinite."""
    dxy = (a[..., :2] - b[..., :2]).abs().double()
    dyaw = torch.remainder(a[..., 2].double() - b[..., 2].double() + math.pi,
                           2 * math.pi) - math.pi
    bad = torch.isnan(dxy).any() or torch.isnan(dyaw).any()
    if bad:
        return math.inf, math.inf
    return float(dxy.max()), float(dyaw.abs().max())


def compare(out: dict, ref: dict) -> dict:
    t_xy, t_yaw = _pose_err(out["track"], ref["track"])
    n_xy, n_yaw = _pose_err(out["kf_nodes"], ref["kf_nodes"])
    return {"grid_cells_off": int((out["grid"] != ref["grid"]).sum()),
            "track_err_m": t_xy, "nodes_err_m": n_xy,
            "yaw_err_rad": max(t_yaw, n_yaw)}


def notes(frames, out, ref, rcfg, walls) -> str:
    """Loop closures, and how far the corrected track and the odometry
    end from the logged pose (the last 20 frames)."""
    truth = torch.stack([frames["x_m"], frames["y_m"]], -1)
    tail = lambda tr: float((tr[:, -20:, :2] - truth[:, -20:]).norm(  # noqa: E731
        dim=-1).mean())
    return (f"loop edges accepted {int(ref['loop_ok'].sum())} of "
            f"{int(ref['loop_near'].sum())} gated candidates (last loop "
            f"stage); tail error corrected {tail(ref['track']):.4f} m, "
            f"odometry {tail(ref['odo']):.4f} m; wall IoU of the corrected "
            f"maps (first 16 flights) {wall_iou(out, rcfg, walls):.4f}")
