"""python -m micro_quad_slam_tpu_torch: command line of the PyTorch port.

  python -m micro_quad_slam_tpu_torch replay --log scanlog.bin [more.bin ...]
      | --wirecap cap.bin  [--kernel xla|residentx|hybridx|...] [--sharded]
      [--profile ul|cl] [--save-state CK] [--resume CK] [--out map.npy]
      [--pgm map.pgm [--pgm-raw]] [--ascii] [--navlog navlog.csv]
  python -m micro_quad_slam_tpu_torch fusion --log scanlog.bin [...]
      | --wirecap cap.bin  [--profile ul|cl|ul-rt] [--out track.csv]
  python -m micro_quad_slam_tpu_torch slam --log scanlog.bin [...]
      | --wirecap cap.bin  [--profile ul|cl|ul-rt] [--kf-every N]
      [--gn-iters N] [--slam-set KEY=VALUE ...] [--track track.csv]
      [--out map.npy] [--pgm map.pgm [--pgm-raw]] [--ascii]
      [--save-state CK] [--resume CK]
  python -m micro_quad_slam_tpu_torch sim [--quads N] [--seconds S]
      [--dt-ms MS] [--seed N] [--profile ul|cl] [--vision-flow]
      [--out-prefix PREFIX] [--emit-mavlink cmds.bin] [--save-state CK]
      [--resume CK]
  python -m micro_quad_slam_tpu_torch synth --out scanlog.bin [--frames N]
      [--path circle|hover|line|fig8] [--emit-wirecap cap.bin [--mav2]]
  python -m micro_quad_slam_tpu_torch bench [replay|slam|ekf|swarm]
  python -m micro_quad_slam_tpu_torch info

The counterparts of the JAX package's `mqs` subcommands
(micro_quad_slam_tpu/cli.py), with the same options, printed lines and
written files.  Scanlogs are read by the native reader
(io/native.py) where g++ can build it, else by the Python codec.
replay, fusion, slam, sim and bench run on the CUDA device; without one
they exit with status 2 unless given --device cpu.  replay --sharded
splits the logs over every visible CUDA device (parallel/mesh.py; with
--device cpu, over the CPU once).  synth and info need no device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from micro_quad_slam_tpu_torch.replay.mapping import (
    CONEX_KERNELS, EXACT_KERNELS, PER_FRAME_KERNELS)

KERNELS = PER_FRAME_KERNELS + EXACT_KERNELS + tuple(CONEX_KERNELS)
DEVICE_HELP = ("torch device (default: cuda; without a CUDA device pass "
               "--device cpu)")


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


def _one_input(args) -> bool:
    """One of --log / --wirecap (an error line otherwise); --wirecap wins
    when both are given, as in the JAX CLI."""
    if not args.log and not args.wirecap:
        print("one of --log / --wirecap is required", file=sys.stderr)
        return False
    return True


def _wirecap_frames(path: str) -> dict:
    """A dual-UART capture -> frames dict of [1, T] numpy arrays (replay,
    fusion and SLAM inputs)."""
    from micro_quad_slam_tpu_torch.formats.wirecap import read_wirecap
    from micro_quad_slam_tpu_torch.replay.livestream import wirecap_to_frames

    return {k: v[None] for k, v in wirecap_to_frames(
        read_wirecap(path)).items()}


def _stack_logs(paths):
    """Load N scanlogs and stack them into one [B, T, ...] numpy batch.

    Mixed lengths pad to the longest log with frames the mapper provably
    skips: a NaN pose fails both map init and the pose_good gate, and an
    all-zero ToF grid has no valid beams, so each flight's map is
    bit-identical to its solo replay.  Returns (logs, frames, true
    lengths)."""
    from micro_quad_slam_tpu_torch.io.native import read_scanlog_native
    from micro_quad_slam_tpu_torch.replay.mapping import scanlog_to_arrays

    logs = [read_scanlog_native(p) for p in paths]
    arrs = [scanlog_to_arrays(lg) for lg in logs]
    lens = [a["x_m"].shape[0] for a in arrs]
    T = max(lens)
    nan_keys = ("x_m", "y_m", "yaw_deg", "of_rate_x")

    def pad(a, key):
        fill = np.nan if key in nan_keys else 0
        tail = np.full((T - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, tail])

    frames = {k: np.stack([pad(a[k], k) for a in arrs]) for k in arrs[0]}
    return logs, frames, lens


def _indexed_path(path: str, i: int, n: int) -> str:
    if n == 1:
        return path
    stem, dot, ext = path.rpartition(".")
    return f"{stem}_{i}{dot}{ext}" if dot else f"{path}_{i}"


def _ascii_map(grid: np.ndarray, half: int = 40, step: int = 2) -> str:
    h, w = grid.shape
    cy, cx = h // 2, w // 2
    rows = []
    for r in range(cy - half, cy + half + 1, step):
        rows.append("".join(
            "#" if grid[r, c] > 10 else ("." if grid[r, c] < -10 else " ")
            for c in range(cx - half, cx + half + 1)))
    return "\n".join(rows)


def _restore(path_or_dir: str):
    """(restored checkpoint, its path): the newest step in a directory, or
    the file itself."""
    from micro_quad_slam_tpu_torch.utils.checkpoint import (
        latest_checkpoint, restore_checkpoint)

    path = latest_checkpoint(path_or_dir) or path_or_dir
    return restore_checkpoint(path), path


def _write_navlog(path: str, log, filt: np.ndarray) -> None:
    from micro_quad_slam_tpu_torch.formats.navlog import NavlogWriter

    with NavlogWriter(path) as w:
        for i in range(len(log)):
            w.write_row(
                int(log.host_ms[i]), int(log.state[i]), True, True, 4,
                float(log.yaw_deg[i]), float(log.alt_m[i]), 2,
                float(log.x_m[i]), float(log.y_m[i]),
                float("nan"), float("nan"), float(log.rf_m[i]),
                int(log.of_q[i]), float(log.of_rate_x[i]),
                float(log.of_rate_y[i]), float(filt[i, 0]),
                float(filt[i, 1]), float(filt[i, 2]), float(filt[i, 3]),
                float("nan"), 0)


def cmd_replay(args) -> int:
    from micro_quad_slam_tpu_torch.ops.raycast import logical_grid
    from micro_quad_slam_tpu_torch.replay.mapping import (
        frames_to_torch, mapping_state_from_numpy, mapping_state_to_numpy,
        replay_mapping_batched)
    from micro_quad_slam_tpu_torch.utils.obs import save_map_pgm

    if not _one_input(args):
        return 2
    if args.navlog and (args.wirecap or len(args.log) != 1):
        print("--navlog requires a single scanlog input (--log)",
              file=sys.stderr)
        return 2
    device = _device(args.device, "replay")
    if device is None:
        return 2
    if args.wirecap:
        frames = _wirecap_frames(args.wirecap)
        log, lens = None, [frames["x_m"].shape[1]]
    else:
        logs, frames, lens = _stack_logs(args.log)
        log = logs[0] if len(logs) == 1 else None
    B = len(lens)
    state0 = None
    if args.resume:
        if args.sharded:
            print("--resume is not supported with --sharded",
                  file=sys.stderr)
            return 2
        ck, path = _restore(args.resume)
        state0 = mapping_state_from_numpy(ck, device)
        print(f"resuming from {path}")
    if args.sharded:
        from micro_quad_slam_tpu_torch.parallel import mesh

        devices = mesh.make_mesh(device=device)
        if B % len(devices):
            print(f"--sharded needs the log count ({B}) to be a multiple "
                  f"of the device count ({len(devices)})", file=sys.stderr)
            return 2
        state, outs, metrics = mesh.replay_mapping_sharded(
            frames, _profile(args.profile), devices, kernel=args.kernel)
        print(f"sharded over {len(devices)} devices: "
              f"{int(metrics['frames_used'])} of "
              f"{int(metrics['frames_total'])} frames mapped")
    else:
        state, outs = replay_mapping_batched(
            frames_to_torch(frames, device), _profile(args.profile),
            kernel=args.kernel, state0=state0)
    if args.save_state:
        from micro_quad_slam_tpu_torch.utils.checkpoint import save_checkpoint
        p = save_checkpoint(args.save_state, mapping_state_to_numpy(state),
                            step=max(lens))
        print(f"mapper state -> {p}")
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
        if args.pgm:
            p = save_map_pgm(_indexed_path(args.pgm, i, B), grid,
                             trinary=not args.pgm_raw)
            print(f"{tag}map image -> {p}")
        if args.ascii and B > 1:
            print(_ascii_map(grid))
    if args.navlog:
        _write_navlog(args.navlog, log, outs["filt"][0].cpu().numpy())
        print(f"navlog -> {args.navlog}")
    if args.ascii and B == 1:
        print(_ascii_map(grids[0]))
    return 0


def _equal_length_logs(paths):
    """Scanlogs of equal length -> (frames dict of [B, T] numpy arrays with
    the EKF inputs, the logs), or (None, lengths) when they differ: padded
    frames would enter the EKF and the keyframe graph."""
    from micro_quad_slam_tpu_torch.io.native import read_scanlog_native
    from micro_quad_slam_tpu_torch.replay.fusion import fusion_arrays
    from micro_quad_slam_tpu_torch.replay.mapping import scanlog_to_arrays

    logs = [read_scanlog_native(p) for p in paths]
    if len({len(lg) for lg in logs}) > 1:
        return None, [len(lg) for lg in logs]
    dicts = [{**scanlog_to_arrays(lg), **fusion_arrays(lg)} for lg in logs]
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}, logs


def _inputs(args, what: str):
    """The frames of --wirecap or of the equal-length --log files, or None
    after an error line."""
    if args.wirecap:
        return _wirecap_frames(args.wirecap)
    frames, logs = _equal_length_logs(args.log)
    if frames is None:
        print(f"{what} with several logs needs equal frame counts, got "
              f"{logs}", file=sys.stderr)
    return frames


def cmd_fusion(args) -> int:
    from micro_quad_slam_tpu_torch.replay.fusion import (
        pose_rmse, replay_fusion_batched)
    from micro_quad_slam_tpu_torch.replay.mapping import frames_to_torch

    if not _one_input(args):
        return 2
    device = _device(args.device, "run the EKF")
    if device is None:
        return 2
    frames = _inputs(args, "fusion")
    if frames is None:
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


def _override_slam(slam_cfg, pairs):
    """Apply repeatable --slam-set key=value overrides to a SlamConfig,
    coercing each value to the field's declared type (bool accepts
    true/false/1/0), as the JAX CLI does (cli.py:225-257)."""
    import dataclasses

    fields = {f.name: f.type for f in dataclasses.fields(slam_cfg)}
    upd = {}
    for pair in pairs:
        key, _, val = pair.partition("=")
        if key not in fields or not _:
            valid = ", ".join(sorted(fields))
            raise SystemExit(
                f"--slam-set {pair!r}: expected key=value with key one of "
                f"{valid}")
        cur = getattr(slam_cfg, key)
        if isinstance(cur, bool):
            if val.lower() not in ("true", "false", "1", "0"):
                raise SystemExit(f"--slam-set {key}: boolean, got {val!r}")
            upd[key] = val.lower() in ("true", "1")
        elif isinstance(cur, int):
            upd[key] = int(val)
        elif isinstance(cur, tuple):    # edge weights: x,y,yaw triple
            parts = tuple(float(v) for v in val.split(","))
            if len(parts) != len(cur):
                raise SystemExit(
                    f"--slam-set {key}: expected {len(cur)} "
                    f"comma-separated floats, got {val!r}")
            upd[key] = parts
        else:
            upd[key] = float(val)
    return dataclasses.replace(slam_cfg, **upd)


def cmd_slam(args) -> int:
    from micro_quad_slam_tpu_torch.ops.raycast import logical_grid
    from micro_quad_slam_tpu_torch.replay.mapping import frames_to_torch
    from micro_quad_slam_tpu_torch.slam.pipeline import slam_replay
    from micro_quad_slam_tpu_torch.utils.obs import save_map_pgm

    if not _one_input(args):
        return 2
    cfg = _profile(args.profile)
    if args.slam_set:
        cfg = cfg.replace(slam=_override_slam(cfg.slam, args.slam_set))
    device = _device(args.device, "run SLAM")
    if device is None:
        return 2
    frames = _inputs(args, "slam")
    if frames is None:
        return 2
    B, T = frames["x_m"].shape
    state0 = None
    if args.resume:
        ck, path = _restore(args.resume)
        state0 = tuple(torch.from_numpy(np.asarray(v)).to(device)
                       for v in ck)
        print(f"resuming SLAM map from {path}")
    res = slam_replay(frames_to_torch(frames, device), cfg,
                      kf_every=args.kf_every, gn_iters=args.gn_iters,
                      state0=state0)
    if args.save_state:
        from micro_quad_slam_tpu_torch.utils.checkpoint import save_checkpoint
        p = save_checkpoint(args.save_state,
                            (res.grid, res.origin[0], res.origin[1]), step=T)
        print(f"slam map state -> {p}")
    grids = logical_grid(res.grid).cpu().numpy()
    track, odo = res.track.cpu().numpy(), res.odo_track.cpu().numpy()
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
        if args.pgm:
            p = save_map_pgm(_indexed_path(args.pgm, b, B), grids[b],
                             trinary=not args.pgm_raw)
            print(f"{tag}corrected map image -> {p}")
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
        if args.ascii:
            print(_ascii_map(grids[b]))
    return 0


def cmd_sim(args) -> int:
    from collections import Counter

    from micro_quad_slam_tpu_torch.formats.scanlog import write_scanlog
    from micro_quad_slam_tpu_torch.models.simulator import (
        make_world, sim_diag_to_mavlink, sim_diag_to_scanlogs, sim_init,
        sim_run, sim_state_from_numpy, sim_state_to_numpy)
    from micro_quad_slam_tpu_torch.ops.raycast import logical_grid
    from micro_quad_slam_tpu_torch.utils.obs import STATE_NAMES_UL

    device = _device(args.device, "simulate")
    if device is None:
        return 2
    B = args.quads
    world = make_world(B, room=(-3.5, -3.5, 3.5, 3.5),
                       obstacles=[(1.5, -0.5, 2.5, 0.5)], device=device)
    if args.resume:
        ck, path = _restore(args.resume)
        st = sim_state_from_numpy(ck, device, seed=args.seed)
        print(f"resuming sim from {path}")
    else:
        st = sim_init(B, args.seed, spread_m=0.5, device=device)
    steps = int(args.seconds * 1000 / args.dt_ms)
    record = bool(args.out_prefix) or bool(args.emit_mavlink)
    st, diag = sim_run(st, world, steps, _profile(args.profile),
                       dt_ms=args.dt_ms, record=record,
                       vision_flow=args.vision_flow)
    if args.save_state:
        from micro_quad_slam_tpu_torch.utils.checkpoint import save_checkpoint
        p = save_checkpoint(args.save_state, {
            **sim_state_to_numpy(st), "gen": st.gen.get_state().numpy()},
            step=steps)
        print(f"sim state -> {p}")
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
    if args.emit_mavlink:
        buf = sim_diag_to_mavlink(diag, quad=0)
        with open(args.emit_mavlink, "wb") as f:
            f.write(buf)
        print(f"quad 0 FC command stream ({len(buf)} bytes) -> "
              f"{args.emit_mavlink}")
    return 0


def cmd_synth(args) -> int:
    from micro_quad_slam_tpu_torch.formats.scanlog import write_scanlog
    from micro_quad_slam_tpu_torch.sim.synthio import synth_room_scanlog

    log = synth_room_scanlog(
        n_frames=args.frames, path=args.path, path_radius_m=args.radius,
        room=tuple(args.room), with_flow=True, noise_mm=args.noise_mm,
        dropout_p=args.dropout, seed=args.seed)
    write_scanlog(args.out, log)
    print(f"synthetic flight ({args.frames} frames, {args.path}) -> {args.out}")
    if args.emit_wirecap:
        from micro_quad_slam_tpu_torch.formats.wirecap import write_wirecap
        from micro_quad_slam_tpu_torch.replay.livestream import (
            scanlog_to_wirecap)
        ver = 2 if args.mav2 else 1
        n = write_wirecap(args.emit_wirecap,
                          scanlog_to_wirecap(log, mav_version=ver))
        print(f"dual-UART capture ({n} records, MAVLink v{ver}) -> "
              f"{args.emit_wirecap}")
    return 0


def cmd_bench(args) -> int:
    import os

    from micro_quad_slam_tpu_torch import bench

    if args.mode:
        os.environ["MQS_BENCH_MODE"] = args.mode
    return bench.main(["--device", args.device])


def cmd_info(args) -> int:
    import micro_quad_slam_tpu_torch as port
    from micro_quad_slam_tpu_torch.io.native import native_available

    cuda = torch.cuda.is_available()
    devices = ([str(torch.device("cuda", i))
                for i in range(torch.cuda.device_count())] if cuda
               else ["cpu"])
    print(json.dumps({
        "version": port.__version__,
        "backend": "cuda" if cuda else "cpu",
        "devices": devices,
        "native_io": native_available(),
        "profiles": ["ul", "cl", "ul-rt"],
    }, indent=2))
    return 0


def _add_input(sub, log_help: str, wirecap_help: str) -> None:
    sub.add_argument("--log", nargs="+", help=log_help)
    sub.add_argument("--wirecap", help=wirecap_help)


def _add_map_images(sub, what: str) -> None:
    sub.add_argument("--ascii", action="store_true")
    sub.add_argument("--pgm", help=f"write the {what} as a PGM image "
                                   f"(occupied=black/free=white/unknown=gray)")
    sub.add_argument("--pgm-raw", action="store_true",
                     help="grayscale log-odds PGM instead of trinary")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m micro_quad_slam_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("replay", help="scanlog -> occupancy map")
    _add_input(pr, "one or more scanlog.bin files; several logs replay as "
                   "one batch (mixed lengths pad with gated-out frames, "
                   "bit-identical per log to a solo replay)",
               "replay a raw dual-UART capture (hub SCAN/CTRL + FC MAVLink, "
               "formats/wirecap.py) instead of a scanlog")
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
    _add_map_images(pr, "map")
    pr.add_argument("--navlog", help="write a reference-format navlog.csv "
                                     "of the replay (a single --log)")
    pr.add_argument("--sharded", action="store_true",
                    help="split the logs over every visible CUDA device "
                         "(parallel/mesh.py; the log count must be a "
                         "multiple of the device count); not with --resume")
    pr.add_argument("--save-state", help="checkpoint the final mapper state "
                                         "(resume a later log with --resume)")
    pr.add_argument("--resume", help="checkpoint dir/path to resume from "
                                     "(bit-identical to an unbroken replay; "
                                     "the JAX CLI's checkpoints too)")
    pr.add_argument("--device", default="cuda", help=DEVICE_HELP)
    pr.set_defaults(fn=cmd_replay)

    pf = sub.add_parser("fusion", help="scanlog -> EKF pose track")
    _add_input(pf, "one or more scanlog.bin files of equal length, replayed "
                   "as one batch",
               "EKF replay from a raw dual-UART capture")
    pf.add_argument("--out", help="write each flight's track as CSV")
    pf.add_argument("--profile", default="ul", choices=("ul", "cl", "ul-rt"))
    pf.add_argument("--device", default="cuda", help=DEVICE_HELP)
    pf.set_defaults(fn=cmd_fusion)

    ps = sub.add_parser("slam", help="scanlog -> drift-corrected map and "
                                     "track")
    _add_input(ps, "one or more scanlog.bin files of equal length, one batch",
               "SLAM from a raw dual-UART capture")
    ps.add_argument("--out", help="write each flight's corrected logical "
                                  "grid as .npy")
    ps.add_argument("--profile", default="ul", choices=("ul", "cl", "ul-rt"))
    ps.add_argument("--kf-every", type=int, default=10)
    ps.add_argument("--gn-iters", type=int, default=8)
    ps.add_argument("--slam-set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override any SlamConfig field (repeatable), e.g. "
                         "--slam-set match_iters=3 or match_feedback=true")
    _add_map_images(ps, "corrected map")
    ps.add_argument("--track", help="write the corrected and odometry pose "
                                    "tracks as CSV")
    ps.add_argument("--save-state", help="checkpoint the corrected map + "
                                         "origins (continue a later segment "
                                         "with --resume)")
    ps.add_argument("--resume", help="checkpoint dir/path of a previous slam "
                                     "segment's map to continue in the same "
                                     "frame")
    ps.add_argument("--device", default="cuda", help=DEVICE_HELP)
    ps.set_defaults(fn=cmd_slam)

    pm = sub.add_parser("sim", help="closed-loop swarm simulation")
    pm.add_argument("--quads", type=int, default=16)
    pm.add_argument("--seconds", type=float, default=20.0)
    pm.add_argument("--dt-ms", type=int, default=20)
    pm.add_argument("--seed", type=int, default=0,
                    help="seed of the start poses and the scan noise (a "
                         "torch generator: not the JAX CLI's draws); on a "
                         "resume from a JAX checkpoint, the seed of the "
                         "generator that replaces its key")
    pm.add_argument("--profile", default="ul", choices=("ul", "cl"))
    pm.add_argument("--out-prefix",
                    help="write the logical grids (.npy) and the first 4 "
                         "quads' scanlogs (PREFIX_q<b>.bin)")
    pm.add_argument("--emit-mavlink",
                    help="write quad 0's MAVLink command stream to a file")
    pm.add_argument("--save-state", help="checkpoint the final sim state, "
                                         "its generator included (continue "
                                         "with --resume)")
    pm.add_argument("--resume", help="checkpoint dir/path of a previous sim "
                                     "run to continue from")
    pm.add_argument("--vision-flow", action="store_true",
                    help="localize with pyramidal LK optical flow on "
                         "rendered downward-camera frames instead of the "
                         "oracle flow sensor")
    pm.add_argument("--device", default="cuda", help=DEVICE_HELP)
    pm.set_defaults(fn=cmd_sim)

    py = sub.add_parser("synth", help="generate a synthetic scanlog")
    py.add_argument("--out", required=True)
    py.add_argument("--frames", type=int, default=200)
    py.add_argument("--path", default="circle",
                    choices=("circle", "hover", "line", "fig8"))
    py.add_argument("--radius", type=float, default=1.0)
    py.add_argument("--room", type=float, nargs=4,
                    default=(-3.0, -3.0, 3.0, 3.0))
    py.add_argument("--noise-mm", type=float, default=5.0)
    py.add_argument("--dropout", type=float, default=0.02)
    py.add_argument("--seed", type=int, default=0)
    py.add_argument("--emit-wirecap", help="also write the flight as a raw "
                                           "dual-UART capture")
    py.add_argument("--mav2", action="store_true",
                    help="emit the wirecap FC channel as MAVLink v2 (0xFD "
                         "framing, like a real ArduPilot FC)")
    py.set_defaults(fn=cmd_synth)

    pb = sub.add_parser("bench", help="run the throughput benchmark "
                                      "(micro_quad_slam_tpu_torch.bench)")
    pb.add_argument("mode", nargs="?", choices=("replay", "slam", "ekf",
                                                "swarm"))
    pb.add_argument("--device", default="cuda", help=DEVICE_HELP)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="environment / version info")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
