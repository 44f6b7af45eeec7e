"""Entry replay_mapping: the port's batched mapping replay,
replay/mapping.py::replay_mapping_batched(frames, cfg, geom, kernel), one
job a call.  The workload file's `kernel` picks the path; its
`reference` names the plain replay that judges it (reference/mapping.py:
"exact" or "hybrid").

Compared, over every flight of a compared job: the int8 grid cell for
cell, the final map origin (so recenters count), and per frame the
enable gate and the recenter flag; the number compared counts every one
of them that differs (limit 0), and the note line splits it.
"""

import torch

from portbench.reference import mapping as RM
from portbench.reference.grid import extract_beams

FRAME_KEYS = ("grid_mm", "x_m", "y_m", "yaw_deg", "of_q", "of_rate_x",
              "sys_health", "state")


def run(frames, prog, args):
    from micro_quad_slam_tpu_torch.replay.mapping import replay_mapping_batched

    return replay_mapping_batched(frames, prog.cfg, prog.geom,
                                  kernel=args["kernel"])


def outputs(res) -> dict:
    state, outs = res
    return {"grid": state.grid, "origin_x": state.origin_x,
            "origin_y": state.origin_y, "used": outs["used"],
            "kf_flags": outs["kf_flags"]}


def reference(frames, rcfg, args, lowp: bool = False) -> dict:
    return RM.REPLAYS[args["reference"]](frames, rcfg, lowp)


def _bits_differ(a, b):
    """Per element: the float32 values differ (NaN equals NaN)."""
    return (a != b) & ~(torch.isnan(a) & torch.isnan(b))


def _off(out: dict, ref: dict) -> dict:
    """Grid cells, flights' origins and frames' flags that differ."""
    return {
        "cells": int((out["grid"] != ref["grid"]).sum()),
        "origins": int((_bits_differ(out["origin_x"], ref["origin_x"])
                        | _bits_differ(out["origin_y"], ref["origin_y"])).sum()),
        "flags": int((out["used"] != ref["used"]).sum()
                     + (out["kf_flags"].to(torch.uint8) != ref["kf_flags"]).sum()),
    }


def compare(out: dict, ref: dict) -> dict:
    """One exact number: every answer of the job that differs from the
    reference's (grid cells, origins, flags)."""
    return {"answers_off": sum(_off(out, ref).values())}


def notes(frames, out, ref, rcfg, walls) -> str:
    """What the job's traffic exercised: beams that hit, recenters."""
    beams, _ = extract_beams(frames["grid_mm"], rcfg.tof)
    hit = (beams > rcfg.tof.map_skip_below_m) & (
        beams < rcfg.tof.max_range_m - rcfg.tof.hit_margin_m)
    rec = ref["kf_flags"] != 0
    off = _off(out, ref)
    return (f"off: {off['cells']} cells, {off['origins']} origins, "
            f"{off['flags']} flags; beams hit {float(hit.float().mean()):.4f} of "
            f"{beams.numel()}; recenters {int(rec.sum())} in "
            f"{int(rec.any(dim=1).sum())} flights; cells set "
            f"{int((ref['grid'] != 0).sum())}, occupied (>10) "
            f"{int((ref['grid'] > 10).sum())}; wall IoU of the maps (first "
            f"16 flights) {wall_iou(out, rcfg, walls):.4f}")


def wall_iou(out, rcfg, walls, n: int = 16) -> float:
    """The mean wall IoU (reference/accuracy.py) of the first n flights'
    maps."""
    from portbench.reference.accuracy import map_iou_vs_walls

    g, m = rcfg.geom, rcfg.map
    ious = []
    for f in range(min(n, out["grid"].shape[0])):
        grid = out["grid"][f, g.pad:g.pad + m.height,
                           g.pad:g.pad + m.width].cpu().numpy()
        ious.append(map_iou_vs_walls(grid, float(out["origin_x"][f]),
                                     float(out["origin_y"][f]), walls(f),
                                     m.res_m))
    return float(sum(ious) / len(ious))
