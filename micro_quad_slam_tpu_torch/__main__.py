"""python -m micro_quad_slam_tpu_torch: command line of the PyTorch port.

  python -m micro_quad_slam_tpu_torch replay --log scanlog.bin [more.bin ...]
      [--kernel xla|residentx|cone|hybrid|conex|hybridx|resident_cone|...]
      [--profile ul|cl] [--device cuda|cpu] [--out map.npy]

The counterpart of `mqs replay` (micro_quad_slam_tpu/cli.py) for scanlog
input; it prints the same per-flight summary line.  It runs on the CUDA
device; without one it exits with status 2 unless given --device cpu.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from micro_quad_slam_tpu_torch.replay.mapping import (
    CONEX_KERNELS, EXACT_KERNELS, PER_FRAME_KERNELS)

KERNELS = PER_FRAME_KERNELS + EXACT_KERNELS + tuple(CONEX_KERNELS)


def _profile(name: str):
    from micro_quad_slam_tpu_torch.utils.config import CL_PROFILE, UL_PROFILE
    return CL_PROFILE if name == "cl" else UL_PROFILE


def _stack_logs(paths):
    """Load N scanlogs and stack them into one [B, T, ...] numpy batch.

    Mixed lengths pad to the longest log with frames the mapper provably
    skips: a NaN pose fails both map init and the pose_good gate, and an
    all-zero ToF grid has no valid beams, so each flight's map is
    bit-identical to its solo replay.  Returns (frames, true lengths)."""
    from micro_quad_slam_tpu_torch.formats.scanlog import read_scanlog
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

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device found; pass --device cpu to replay on "
              "the CPU", file=sys.stderr)
        return 2
    frames, lens = _stack_logs(args.log)
    state, outs = replay_mapping_batched(
        frames_to_torch(frames, device),
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
    pr.add_argument("--kernel", default="xla", choices=KERNELS,
                    help="xla: per-frame plain torch path; residentx (and "
                         "its aliases resident, pallas, pallas_db, mxu, "
                         "mxu2): the whole replay through the exact CUDA "
                         "kernel (both bit-exact reference semantics); "
                         "cone/hybrid: the "
                         "dense production modes, per frame in plain torch; "
                         "conex/resident_cone (cone) and hybridx (hybrid): "
                         "the whole replay through the cone CUDA kernel.  "
                         "On --device cpu every kernel runs its plain torch "
                         "version")
    pr.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; without a CUDA "
                         "device pass --device cpu)")
    pr.set_defaults(fn=cmd_replay)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
