"""The work a job's inputs require of each kernel's layer, counted by the
benchmark's own reference from the job's frames, whatever kernel does
it: operations (int32 and float32) and bytes.  The per-cell and
per-lookup operation counts are declared here, once.

  exact    every valid ray's Bresenham cells and its endpoint; bytes:
           the logged frames read once, and every 32-byte grid sector the
           rays touch read once and written once (recenter moves not
           counted).
  hybrid   the cells of every column's carve fan inside its eroded range
           (the area of the fan sector, from geometry) and every valid
           ray's endpoint; bytes as exact.
  lattice  every candidate pose of every match times its hit endpoints;
           bytes: the map sectors those lookups touch, read once per
           match.

Each function returns {"int_ops", "fp_ops", "bytes"} for one job batch;
`least_seconds` turns that into the shortest time the card's published
peaks allow.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from portbench.reference import grid as G
from portbench.reference import mapping as RM
from portbench.reference import slam as RS

# int32 operations per cell a ray walks: the Bresenham step (error
# update, compare, two conditional increments) and the update (add the
# delta, clamp below and above) and the cell's address
EXACT_CELL_INT_OPS = 8
# int32 operations per ray outside its cells: |dx|, |dy|, signs, the
# major axis, the error's start, the endpoint test
EXACT_RAY_INT_OPS = 8
# a carved cell: its update (add, clamp twice) in int32, and the float
# tests that place it: squared range (2 mul, 1 add), the two fan sides
# (2 mul, 2 compares) and the range compare
CARVE_CELL_INT_OPS = 3
CARVE_CELL_FP_OPS = 8
# a lattice lookup: the cell's address, the load's bounds test, the add
LOOKUP_INT_OPS = 3
# a logged frame as the scanlog stores it: 4 x 8 x 8 u16 millimetres and
# the pose (x, y, yaw) in float32
FRAME_BYTES = 4 * 8 * 8 * 2 + 3 * 4
SECTOR = 32

PEAKS = json.loads((Path(__file__).resolve().parents[1]
                    / "peaks.json").read_text())


def least_seconds(w: dict) -> float:
    """The larger of the compute bound (int32 and float32 pipes side by
    side) and the memory bound, at the published peaks."""
    return max(w["int_ops"] / PEAKS["int32_ops_per_s"],
               w["fp_ops"] / PEAKS["fp32_flops_per_s"],
               w["bytes"] / PEAKS["hbm_bytes_per_s"])


def _ray_sectors(rays: dict, cfg, chunk: int = 16) -> tuple:
    """(cells walked, sectors touched) of rays [B, T, 32]: cells summed
    over all rays, sectors counted once per flight."""
    g = cfg.geom
    B, T = rays["ex"].shape[:2]
    dev = rays["ex"].device
    nsc = -(-g.pcols // SECTOR)
    seen = torch.zeros((B, g.prows * nsc), dtype=torch.bool, device=dev)
    cells = 0
    bi = torch.arange(B, device=dev)[:, None, None, None]
    for t0 in range(0, T, chunk):
        r = {k: v[:, t0:t0 + chunk] for k, v in rays.items()}
        drow, dcol, live, _ = RM.ray_cells(r, g.win_r + 1)
        cells += int(live.sum())
        row = r["pcy"][..., None, None] + g.pad + drow
        col = r["pcx"][..., None, None] + g.pad + dcol
        sec = (row * nsc + torch.div(col, SECTOR, rounding_mode="floor")).long()
        sec = torch.where(live, sec, torch.zeros_like(sec))
        seen[bi.expand_as(sec)[live], sec[live]] = True
    return cells, int(seen.sum())


def _rays(frames: dict, cfg):
    seq, beams = RM.carry(frames, cfg)
    return G.make_rays(beams, frames["x_m"], frames["y_m"], frames["yaw_deg"],
                       seq["ox"], seq["oy"], seq["enabled"], cfg.map,
                       cfg.tof), seq, beams


def exact(frames: dict, cfg) -> dict:
    rays, _, _ = _rays(frames, cfg)
    n_rays = int(rays["valid"].sum())
    cells, sectors = _ray_sectors(rays, cfg)
    B, T = frames["x_m"].shape
    return {"int_ops": cells * EXACT_CELL_INT_OPS + n_rays * EXACT_RAY_INT_OPS,
            "fp_ops": 0,
            "bytes": B * T * FRAME_BYTES + 2 * SECTOR * sectors,
            "cells": cells, "rays": n_rays}


def hybrid(frames: dict, cfg) -> dict:
    rays, seq, beams = _rays(frames, cfg)
    tof, m = cfg.tof, cfg.map
    packed = RM._eroded_returns(RM._pack_returns(
        beams.reshape(beams.shape[:2] + (32,)), tof), tof)
    r = ((packed - G.f32(RM.FREE_MARGIN_M)).clamp_min(0.0) / m.res_m).clamp_max(
        tof.max_range_m / m.res_m)
    theta = math.radians(tof.fov_deg / 8.0)
    en = seq["enabled"][..., None] & (packed > tof.map_skip_below_m)
    carve = float((0.5 * theta * r.double() ** 2 * en).sum())
    n_end = int(rays["valid"].sum())
    _, sectors = _ray_sectors(rays, cfg)
    B, T = frames["x_m"].shape
    return {"int_ops": carve * CARVE_CELL_INT_OPS + n_end * EXACT_CELL_INT_OPS,
            "fp_ops": carve * CARVE_CELL_FP_OPS,
            "bytes": B * T * FRAME_BYTES + 2 * SECTOR * sectors,
            "cells": carve, "rays": n_end}


def _match_work(beams, x, y, yaw_deg, ox, oy, cfg, n_xy: int, n_yaw: int,
                chunk: int = 2048) -> tuple:
    """(lookups, sectors) of N matches [N] of scans beams [N, 4, 8] on the
    (n_yaw, n_xy, n_xy) lattice around (x, y, yaw_deg), in the map of
    origin (ox, oy)."""
    s, g = cfg.slam, cfg.geom
    nsc = -(-g.pcols // SECTOR)
    lookups = sectors = 0
    for i in range(0, beams.shape[0], chunk):
        sl = slice(i, i + chunk)
        cy, cx, iny, inx, hit = RS.lattice_cells(
            beams[sl], x[sl], y[sl], yaw_deg[sl], ox[sl], oy[sl], cfg, n_xy,
            n_yaw, s.match_xy_step_m, s.match_yaw_step_deg)
        # every (yaw, tx, ty) candidate looks up each hit endpoint once
        lookups += int(hit.sum()) * n_xy * n_xy
        n = cy.shape[0]
        cyv = cy[:, :, :, :, None]                        # [n, Y, 32, Ty, 1]
        cxv = cx[:, :, :, None, :]                        # [n, Y, 32, 1, Tx]
        live = (hit[..., None, None] & iny[..., :, None] & inx[..., None, :])
        sec = ((cyv + g.pad) * nsc
               + torch.div(cxv + g.pad, SECTOR, rounding_mode="floor")).long()
        sec = torch.where(live, sec, torch.full_like(sec, -1)).reshape(n, -1)
        srt = torch.sort(sec, dim=1).values
        new = torch.ones_like(srt, dtype=torch.bool)
        new[:, 1:] = srt[:, 1:] != srt[:, :-1]
        sectors += int((new & (srt >= 0)).sum())
    return lookups, sectors


def lattice(frames: dict, cfg) -> dict:
    """Per SLAM replay: SlamConfig's pass-1 rounds, each matching every
    keyframe slot (7 x 7 x 7 lattice), and its loop stages, each matching
    every keyframe against its loop_cand candidates (5 x 5 x 5).  Poses
    are the logged ones in the map of the first logged pose, which places
    the lookups as the replay's estimates do up to a few cells."""
    s = cfg.slam
    B, T = frames["x_m"].shape
    beams, _ = G.extract_beams(frames["grid_mm"], cfg.tof)
    kf = torch.arange(0, T, s.kf_every, device=beams.device)
    K = kf.shape[0]
    kb = beams[:, kf].reshape(B * K, 4, 8)
    fl = lambda a: a[:, kf].reshape(-1)                               # noqa: E731
    x, y, yaw = fl(frames["x_m"]), fl(frames["y_m"]), fl(frames["yaw_deg"])
    ox = frames["x_m"][:, :1].expand(B, K).reshape(-1)
    oy = frames["y_m"][:, :1].expand(B, K).reshape(-1)
    p_look, p_sec = _match_work(kb, x, y, yaw, ox, oy, cfg, s.match_n_xy,
                                s.match_n_yaw)
    n_cand = max(int(s.loop_cand), int(s.loop_edges), 1)
    l_look, l_sec = _match_work(kb, x, y, yaw, ox, oy, cfg, s.loop_n_xy,
                                s.loop_n_yaw)
    n_pass1 = int(s.match_iters) + (int(s.slam_outer) - 1) * (
        int(s.match_iters_later) if int(s.match_iters_later) > 0
        else int(s.match_iters))
    early = int(s.loop_refine_early) if int(s.loop_refine_early) >= 0 \
        else int(s.loop_refine)
    n_loop = int(s.slam_outer) + (int(s.slam_outer) - 1) * early \
        + int(s.loop_refine)
    look = n_pass1 * p_look + n_loop * n_cand * l_look
    sec = n_pass1 * p_sec + n_loop * n_cand * l_sec
    return {"int_ops": look * LOOKUP_INT_OPS, "fp_ops": 0,
            "bytes": SECTOR * sec, "lookups": look,
            "launches": n_pass1 + n_loop}


KINDS = {"exact": exact, "hybrid": hybrid, "lattice": lattice}
