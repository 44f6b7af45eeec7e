"""Map accuracy against the generator's true walls: the IoU of a map's
occupied cells with the cells the walls pass through (the port's
utils/obs.py::map_iou_vs_walls, with the walls as segments so that a
rotated room is measured too)."""

from __future__ import annotations

import numpy as np


def rect_segments(box, x0: float, y0: float, rot_deg: float, dx: float,
                  dy: float) -> list:
    """The 4 sides of an axis-aligned box (x0, y0, x1, y1) as segments,
    rotated by rot_deg about (x0, y0) and moved by (dx, dy): a job's
    rigid jitter of the flight that starts at (x0, y0)."""
    c, s = np.cos(np.radians(rot_deg)), np.sin(np.radians(rot_deg))
    pts = [(box[0], box[1]), (box[2], box[1]), (box[2], box[3]),
           (box[0], box[3])]
    pts = [(x0 + c * (px - x0) - s * (py - y0) + dx,
            y0 + s * (px - x0) + c * (py - y0) + dy) for px, py in pts]
    return [(*pts[i], *pts[(i + 1) % 4]) for i in range(4)]


def map_iou_vs_walls(grid, origin_x: float, origin_y: float, segs,
                     res_m: float = 0.10, occ_thresh: int = 10,
                     tol_cells: int = 1) -> float:
    """IoU of the logical grid's occupied cells [H, W] (> occ_thresh)
    with the cells within half a cell of a wall segment, each side
    dilated by tol_cells; the origin sits at the grid's centre."""
    g = np.asarray(grid)
    h, w = g.shape
    X, Y = np.meshgrid(origin_x + (np.arange(w) - w // 2) * res_m,
                       origin_y + (np.arange(h) - h // 2) * res_m)
    dmin = np.full_like(X, np.inf)
    for ax, ay, bx, by in segs:
        abx, aby = bx - ax, by - ay
        ln2 = abx * abx + aby * aby
        t = np.clip(((X - ax) * abx + (Y - ay) * aby) / (ln2 or 1.0), 0, 1)
        dmin = np.minimum(dmin, np.hypot(X - (ax + t * abx),
                                         Y - (ay + t * aby)))
    truth = dmin <= res_m * 0.5 + 1e-6
    pred = g > occ_thresh

    def dilate(x, n):
        for _ in range(n):
            y = x.copy()
            y[1:] |= x[:-1]
            y[:-1] |= x[1:]
            y[:, 1:] |= x[:, :-1]
            y[:, :-1] |= x[:, 1:]
            x = y
        return x

    union = (pred | truth).sum()
    if not union:
        return 1.0
    hits = ((pred & dilate(truth, tol_cells)).sum()
            + (truth & dilate(pred, tol_cells)).sum())
    return float(min(hits / 2 / union, 1.0))
