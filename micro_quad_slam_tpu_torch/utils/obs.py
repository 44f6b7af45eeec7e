"""Map-quality measures and state names of the port (counterpart of
micro_quad_slam_tpu/utils/obs.py; numpy only)."""

from __future__ import annotations

import numpy as np

# the UL behaviour machine's state names (uav_local_nav.c:484-496)
STATE_NAMES_UL = (
    "WAIT_LINK", "IDLE", "ARMING", "TAKEOFF", "LIFTOFF_ASSIST",
    "HOVER", "EXPLORE", "TURNING", "LANDING", "DISARMING",
)


def map_iou_vs_walls(grid, origin_x: float, origin_y: float, room,
                     obstacles=(), res_m: float = 0.10,
                     occ_thresh: int = 10, tol_cells: int = 1) -> float:
    """Map-fidelity score against the simulator's ground-truth walls:
    IoU between the map's occupied cells (> occ_thresh, the reference's
    frontier classification) and the true wall cells of the synthetic
    room/obstacle rectangles, with a tol_cells dilation on each side so
    pure half-cell quantization offsets don't read as disagreement.

    grid: logical [H, W] int8 ([y, x]); origin at the grid center
    (uav_local_nav.c:205-214)."""
    g = np.asarray(grid)
    h, w = g.shape
    xs = origin_x + (np.arange(w) - w // 2) * res_m
    ys = origin_y + (np.arange(h) - h // 2) * res_m
    X, Y = np.meshgrid(xs, ys)

    def seg_dist(px, py, ax, ay, bx, by):
        abx, aby = bx - ax, by - ay
        ln2 = abx * abx + aby * aby
        t = np.clip(((px - ax) * abx + (py - ay) * aby)
                    / (ln2 if ln2 else 1.0), 0.0, 1.0)
        return np.hypot(px - (ax + t * abx), py - (ay + t * aby))

    def rect_segs(x0, y0, x1, y1):
        return [(x0, y0, x1, y0), (x1, y0, x1, y1),
                (x1, y1, x0, y1), (x0, y1, x0, y0)]

    segs = rect_segs(*room)
    for ob in obstacles:
        segs += rect_segs(*ob)
    dmin = np.full_like(X, np.inf)
    for sgm in segs:
        dmin = np.minimum(dmin, seg_dist(X, Y, *sgm))
    truth = dmin <= res_m * 0.5 + 1e-6

    pred = g > occ_thresh

    def dilate(x, n):
        out = x.copy()
        for _ in range(n):
            nx = out.copy()
            nx[1:] |= out[:-1]
            nx[:-1] |= out[1:]
            nx[:, 1:] |= out[:, :-1]
            nx[:, :-1] |= out[:, 1:]
            out = nx
        return out

    union = (pred | truth).sum()
    if not union:
        return 1.0
    hits = ((pred & dilate(truth, tol_cells)).sum()
            + (truth & dilate(pred, tol_cells)).sum())
    return float(min(hits / 2 / union, 1.0))
