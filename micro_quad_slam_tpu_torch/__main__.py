"""python -m micro_quad_slam_tpu_torch: command line of the PyTorch port.

  python -m micro_quad_slam_tpu_torch replay --log scanlog.bin [more.bin ...]
      [--kernel xla|residentx] [--profile ul|cl] [--device cuda] [--out map.npy]

The counterpart of `mqs replay` (micro_quad_slam_tpu/cli.py) for scanlog
input; it prints the same per-flight summary line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _profile(name: str):
    from micro_quad_slam_tpu.utils.config import CL_PROFILE, UL_PROFILE
    return CL_PROFILE if name == "cl" else UL_PROFILE


def _stack_logs(paths):
    """Load N scanlogs and stack them into one [B, T, ...] numpy batch.

    Mixed lengths pad to the longest log with frames the mapper provably
    skips: a NaN pose fails both map init and the pose_good gate, and an
    all-zero ToF grid has no valid beams, so each flight's map is
    bit-identical to its solo replay.  Returns (frames, true lengths)."""
    from micro_quad_slam_tpu.formats.scanlog import read_scanlog
    from micro_quad_slam_tpu_torch.replay.mapping import scanlog_to_arrays

    arrs = [scanlog_to_arrays(read_scanlog(p)) for p in paths]
    lens = [a["x_m"].shape[0] for a in arrs]
    T = max(lens)
    nan_keys = ("x_m", "y_m", "yaw_deg", "of_rate_x")

    def pad(a, key):
        fill = np.nan if key in nan_keys else 0
        tail = np.full((T - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, tail])

    frames = {k: np.stack([pad(a[k], k) for a in arrs]) for k in arrs[0]}
    return frames, lens


def _indexed_path(path: str, i: int, n: int) -> str:
    if n == 1:
        return path
    stem, dot, ext = path.rpartition(".")
    return f"{stem}_{i}{dot}{ext}" if dot else f"{path}_{i}"


def cmd_replay(args) -> int:
    from micro_quad_slam_tpu_torch.ops.raycast import logical_grid
    from micro_quad_slam_tpu_torch.replay.mapping import (
        frames_to_torch, replay_mapping_batched)

    frames, lens = _stack_logs(args.log)
    state, outs = replay_mapping_batched(
        frames_to_torch(frames, torch.device(args.device)),
        _profile(args.profile), kernel=args.kernel)
    B = len(lens)
    grids = logical_grid(state.grid).cpu().numpy()
    used = outs["used"].cpu().numpy()
    ox, oy = state.origin_x.cpu().numpy(), state.origin_y.cpu().numpy()
    for i in range(B):
        grid = grids[i]
        tag = f"[{i}] " if B > 1 else ""
        print(f"{tag}replayed {lens[i]} frames ({int(used[i, :lens[i]].sum())} "
              f"mapped); occupied={int((grid > 10).sum())} "
              f"free={int((grid < -10).sum())} "
              f"origin=({float(ox[i]):.2f},{float(oy[i]):.2f})")
        if args.out:
            p = _indexed_path(args.out, i, B)
            np.save(p, grid)
            print(f"{tag}map -> {p}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m micro_quad_slam_tpu_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("replay", help="scanlog -> occupancy map")
    pr.add_argument("--log", nargs="+", required=True,
                    help="one or more scanlog.bin files; several logs replay "
                         "as one batch (mixed lengths pad with gated-out "
                         "frames, bit-identical per log to a solo replay)")
    pr.add_argument("--out", help="write each flight's logical grid as .npy")
    pr.add_argument("--profile", default="ul", choices=("ul", "cl"))
    pr.add_argument("--kernel", default="xla", choices=("xla", "residentx"),
                    help="xla: per-frame plain torch path; residentx: the "
                         "whole replay through the exact CUDA kernel on a "
                         "CUDA device (plain torch on the CPU); both are "
                         "bit-exact reference semantics")
    pr.add_argument("--device",
                    default="cuda" if torch.cuda.is_available() else "cpu",
                    help="torch device (default: cuda when available)")
    pr.set_defaults(fn=cmd_replay)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
