"""python -m micro_quad_slam_tpu_torch: command line of the PyTorch port.

  python -m micro_quad_slam_tpu_torch replay --log scanlog.bin [more.bin ...]
      [--kernel xla|residentx|cone|hybrid|conex|hybridx|resident_cone|...]
      [--profile ul|cl] [--device cuda|cpu] [--out map.npy]
  python -m micro_quad_slam_tpu_torch fusion --log scanlog.bin [more.bin ...]
      [--profile ul|cl] [--device cuda|cpu] [--out track.csv]
  python -m micro_quad_slam_tpu_torch slam --log scanlog.bin [more.bin ...]
      [--profile ul|cl|ul-rt] [--kf-every N] [--gn-iters N]
      [--track track.csv] [--out map.npy] [--device cuda|cpu]
  python -m micro_quad_slam_tpu_torch sim [--quads N] [--seconds S]
      [--dt-ms MS] [--seed N] [--profile ul|cl] [--vision-flow]
      [--out-prefix PREFIX] [--device cuda|cpu]

The counterparts of `mqs replay`, `mqs fusion`, `mqs slam` and `mqs sim`
(micro_quad_slam_tpu/cli.py); they print the same summary lines.  They
run on the CUDA device; without one they exit with status 2 unless given
--device cpu.
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
    from micro_quad_slam_tpu_torch.utils import config
    return {"ul": config.UL_PROFILE, "cl": config.CL_PROFILE,
            "ul-rt": config.UL_RT_PROFILE}[name]


def _device(name: str, what: str):
    """The torch device, or None (after an error line) when CUDA is asked
    for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: no CUDA device found; pass --device cpu to {what} on "
              f"the CPU", file=sys.stderr)
        return None
    return device


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

    device = _device(args.device, "replay")
    if device is None:
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


def _equal_length_logs(paths):
    """Scanlogs of equal length -> (frames dict of [B, T] numpy arrays with
    the EKF inputs, the logs), or (None, lengths) when they differ: padded
    frames would enter the EKF and the keyframe graph."""
    from micro_quad_slam_tpu_torch.formats.scanlog import read_scanlog
    from micro_quad_slam_tpu_torch.replay.fusion import fusion_arrays
    from micro_quad_slam_tpu_torch.replay.mapping import scanlog_to_arrays

    logs = [read_scanlog(p) for p in paths]
    if len({len(lg) for lg in logs}) > 1:
        return None, [len(lg) for lg in logs]
    dicts = [{**scanlog_to_arrays(lg), **fusion_arrays(lg)} for lg in logs]
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}, logs


def cmd_fusion(args) -> int:
    from micro_quad_slam_tpu_torch.replay.fusion import (
        pose_rmse, replay_fusion_batched)
    from micro_quad_slam_tpu_torch.replay.mapping import frames_to_torch

    device = _device(args.device, "run the EKF")
    if device is None:
        return 2
    frames, logs = _equal_length_logs(args.log)
    if frames is None:
        print(f"fusion with several logs needs equal frame counts, got "
              f"{logs}", file=sys.stderr)
        return 2
    _, track = replay_fusion_batched(frames_to_torch(frames, device),
                                     _profile(args.profile))
    track = {k: v.cpu().numpy() for k, v in track.items()}
    B, T = frames["x_m"].shape
    for b in range(B):
        tag = f"[{b}] " if B > 1 else ""
        rmse = pose_rmse({k: v[b] for k, v in track.items()},
                         {k: v[b] for k, v in frames.items()})
        used = int(track["flow_used"][b].sum())
        print(f"{tag}EKF replay: {T} frames, flow fused on {used}; pose RMSE "
              f"vs logged track: "
              f"{'n/a' if np.isnan(rmse) else f'{rmse * 100:.2f} cm'}")
        if args.out:
            p = _indexed_path(args.out, b, B)
            with open(p, "w") as f:
                f.write("t_ms,x,y,z,vx,vy,vz,yaw_rad,flow_used\n")
                for i in range(T):
                    f.write(f"{int(frames['scan_ms'][b, i])}," + ",".join(
                        f"{float(track[k][b, i]):.4f}"
                        for k in ("x", "y", "z", "vx", "vy", "vz", "yaw"))
                        + f",{int(track['flow_used'][b, i])}\n")
            print(f"{tag}track -> {p}")
    return 0


def cmd_slam(args) -> int:
    from micro_quad_slam_tpu_torch.ops.raycast import logical_grid
    from micro_quad_slam_tpu_torch.replay.mapping import frames_to_torch
    from micro_quad_slam_tpu_torch.slam.pipeline import slam_replay

    device = _device(args.device, "run SLAM")
    if device is None:
        return 2
    frames, logs = _equal_length_logs(args.log)
    if frames is None:
        print(f"slam with several logs needs equal frame counts, got {logs}",
              file=sys.stderr)
        return 2
    res = slam_replay(frames_to_torch(frames, device), _profile(args.profile),
                      kf_every=args.kf_every, gn_iters=args.gn_iters)
    grids = logical_grid(res.grid).cpu().numpy()
    track, odo = res.track.cpu().numpy(), res.odo_track.cpu().numpy()
    B, T = frames["x_m"].shape
    n_kf = int(res.kf_idx.shape[0])
    for b in range(B):
        tag = f"[{b}] " if B > 1 else ""
        msg = (f"{tag}SLAM: {T} frames, {n_kf} keyframes; "
               f"occupied={int((grids[b] > 10).sum())}")
        truth = np.stack([frames["x_m"][b], frames["y_m"][b]], -1)
        if np.isfinite(truth).all():
            oe = np.hypot(*(odo[b, :, :2] - truth).T).mean()
            se = np.hypot(*(track[b, :, :2] - truth).T).mean()
            msg += (f"; mean err vs logged track: odom {oe * 100:.1f} cm -> "
                    f"slam {se * 100:.1f} cm")
        print(msg)
        if args.out:
            p = _indexed_path(args.out, b, B)
            np.save(p, grids[b])
            print(f"{tag}corrected map -> {p}")
        if args.track:
            p = _indexed_path(args.track, b, B)
            with open(p, "w") as f:
                f.write("t_ms,x,y,yaw_rad,odo_x,odo_y,odo_yaw_rad\n")
                for i in range(T):
                    t, o = track[b, i], odo[b, i]
                    f.write(f"{int(frames['scan_ms'][b, i])},{t[0]:.4f},"
                            f"{t[1]:.4f},{t[2]:.4f},{o[0]:.4f},{o[1]:.4f},"
                            f"{o[2]:.4f}\n")
            print(f"{tag}corrected track -> {p}")
    return 0


def cmd_sim(args) -> int:
    from collections import Counter

    from micro_quad_slam_tpu_torch.formats.scanlog import write_scanlog
    from micro_quad_slam_tpu_torch.models.simulator import (
        make_world, sim_diag_to_scanlogs, sim_init, sim_run)
    from micro_quad_slam_tpu_torch.ops.raycast import logical_grid
    from micro_quad_slam_tpu_torch.utils.obs import STATE_NAMES_UL

    device = _device(args.device, "simulate")
    if device is None:
        return 2
    B = args.quads
    world = make_world(B, room=(-3.5, -3.5, 3.5, 3.5),
                       obstacles=[(1.5, -0.5, 2.5, 0.5)], device=device)
    st = sim_init(B, args.seed, spread_m=0.5, device=device)
    steps = int(args.seconds * 1000 / args.dt_ms)
    record = bool(args.out_prefix)
    st, diag = sim_run(st, world, steps, _profile(args.profile),
                       dt_ms=args.dt_ms, record=record,
                       vision_flow=args.vision_flow)
    states = diag["state"][-1].cpu().numpy()
    mix = Counter(STATE_NAMES_UL[s] for s in states)
    grids = logical_grid(st.mapper.grid).cpu().numpy()
    occ = (grids > 10).reshape(B, -1).sum(1)
    pose_err = float(diag["pose_err"][-1].max())
    print(f"swarm {B} quads x {args.seconds}s: final states {dict(mix)}; "
          f"occupied cells/quad median={int(np.median(occ))}; "
          f"pose err max={pose_err:.3f} m")
    if args.out_prefix:
        np.save(f"{args.out_prefix}_grids.npy", grids)
        print(f"grids -> {args.out_prefix}_grids.npy")
        logs = sim_diag_to_scanlogs(diag)
        for b, lg in enumerate(logs[:4]):
            write_scanlog(f"{args.out_prefix}_q{b}.bin", lg)
        print(f"scanlogs -> {args.out_prefix}_q*.bin "
              f"(first {min(4, len(logs))} quads)")
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
                    help="xla: per-frame plain torch path; pallas and "
                         "pallas_db: per frame through the exact CUDA "
                         "kernel's map-step entry; residentx (and its "
                         "aliases resident, mxu, mxu2): the whole replay "
                         "through the exact CUDA kernel (all bit-exact "
                         "reference semantics); "
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

    device_help = "torch device (default: cuda; without a CUDA device pass " \
                  "--device cpu)"
    pf = sub.add_parser("fusion", help="scanlog -> EKF pose track")
    pf.add_argument("--log", nargs="+", required=True,
                    help="one or more scanlog.bin files of equal length, "
                         "replayed as one batch")
    pf.add_argument("--out", help="write each flight's track as CSV")
    pf.add_argument("--profile", default="ul", choices=("ul", "cl", "ul-rt"))
    pf.add_argument("--device", default="cuda", help=device_help)
    pf.set_defaults(fn=cmd_fusion)

    ps = sub.add_parser(
        "slam", help="scanlog -> drift-corrected map and track",
        epilog="--save-state / --resume (the JAX CLI's map checkpoints) wait "
               "for the port's checkpoint module and are not offered yet.")
    ps.add_argument("--log", nargs="+", required=True,
                    help="one or more scanlog.bin files of equal length, "
                         "one batch")
    ps.add_argument("--out", help="write each flight's corrected logical "
                                  "grid as .npy")
    ps.add_argument("--profile", default="ul", choices=("ul", "cl", "ul-rt"))
    ps.add_argument("--kf-every", type=int, default=10)
    ps.add_argument("--gn-iters", type=int, default=8)
    ps.add_argument("--track", help="write the corrected and odometry pose "
                                    "tracks as CSV")
    ps.add_argument("--device", default="cuda", help=device_help)
    ps.set_defaults(fn=cmd_slam)

    pm = sub.add_parser(
        "sim", help="closed-loop swarm simulation",
        epilog="--emit-mavlink, --save-state and --resume (the JAX CLI's "
               "MAVLink stream and checkpoints) wait for the port's mavlink "
               "and checkpoint modules and are not offered yet.")
    pm.add_argument("--quads", type=int, default=16)
    pm.add_argument("--seconds", type=float, default=20.0)
    pm.add_argument("--dt-ms", type=int, default=20)
    pm.add_argument("--seed", type=int, default=0,
                    help="seed of the start poses and the scan noise (a "
                         "torch generator: not the JAX CLI's draws)")
    pm.add_argument("--profile", default="ul", choices=("ul", "cl"))
    pm.add_argument("--out-prefix",
                    help="write the logical grids (.npy) and the first 4 "
                         "quads' scanlogs (PREFIX_q<b>.bin)")
    pm.add_argument("--vision-flow", action="store_true",
                    help="localize with pyramidal LK optical flow on "
                         "rendered downward-camera frames instead of the "
                         "oracle flow sensor")
    pm.add_argument("--device", default="cuda", help=device_help)
    pm.set_defaults(fn=cmd_sim)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
