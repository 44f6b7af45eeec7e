"""A dry run of every sharded entry on tiny shapes (counterpart of the
JAX package's __graft_entry__.py::dryrun_multichip).

    python -m micro_quad_slam_tpu_torch.parallel.dryrun [N] [--device cpu]

shards over the first N visible CUDA devices (default all), or over the
CPU N times.  Each sharded run is held equal, bit for bit, to the
unsharded run on devices[0]: the mapping replay on the per-frame path
and on the whole-replay kernels, the recentering case (half the flights
drift 34 m, so the kernels' recenters run inside the shards), the EKF
fusion, the SLAM pipeline and the closed-loop swarm.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from micro_quad_slam_tpu_torch.parallel.mesh import (
    make_mesh,
    replay_fusion_sharded,
    replay_mapping_sharded,
    sim_run_sharded,
    slam_replay_sharded,
)
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE


def _tiny_logs(batch: int, T: int, seed: int = 0) -> list:
    from micro_quad_slam_tpu_torch.sim.synthio import synth_room_scanlog

    return [synth_room_scanlog(n_frames=T, seed=seed + i, path="hover",
                               yaw_rate_dps=15.0 + seed + i, noise_mm=5.0)
            for i in range(batch)]


def _stack(dicts: list) -> dict:
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def tiny_frames(batch: int, T: int, seed: int = 0) -> dict:
    """A small synthetic batch of hover flights in the replay layout
    (__graft_entry__.py::_tiny_frames)."""
    from micro_quad_slam_tpu_torch.replay.mapping import scanlog_to_arrays

    return _stack([scanlog_to_arrays(lg) for lg in _tiny_logs(batch, T,
                                                                seed)])


def recentering_frames(T: int = 16) -> dict:
    """__graft_entry__.py:93-108's case: 16 hover flights, the odd ones
    dragged 34 m along (1, -0.62) over the run so that they recenter."""
    frames = tiny_frames(16, T)
    drift = np.linspace(0.0, 34.0, T, dtype=np.float32)
    frames["x_m"][1::2] = frames["x_m"][1::2] + drift
    frames["y_m"][1::2] = frames["y_m"][1::2] - drift * np.float32(0.62)
    return frames


def _equal(a, b, what: str) -> None:
    """Bit-equality of two tensor trees (NaN equal to NaN)."""
    if torch.is_tensor(a):
        same = (a.shape == b.shape and a.dtype == b.dtype
                and bool(((a == b) | (a != a) & (b != b)).all()))
        if not same:
            raise AssertionError(f"{what}: the sharded run differs")
        return
    if isinstance(a, dict):
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
        return
    if isinstance(a, (tuple, list)):
        names = getattr(a, "_fields", range(len(a)))
        for k, x, y in zip(names, a, b):
            _equal(x, y, f"{what}.{k}")
        return
    if a != b:
        raise AssertionError(f"{what}: the sharded run differs")


def recentering_case(devices, kernels=("residentx", "hybridx")) -> dict:
    """The recentering case through each whole-replay kernel, sharded
    against unsharded on devices[0]; returns the recenters per kernel."""
    from micro_quad_slam_tpu_torch.replay.mapping import (
        frames_to_torch, replay_mapping_batched)

    frames = recentering_frames()
    out = {}
    for kernel in kernels:
        st_sh, outs_sh, metrics = replay_mapping_sharded(
            frames, UL_PROFILE, devices, kernel=kernel)
        st_un, outs_un = replay_mapping_batched(
            frames_to_torch(frames, devices[0]), UL_PROFILE, kernel=kernel)
        out[kernel] = int((outs_sh["kf_flags"] != 0).sum())
        if out[kernel] < 1:
            raise AssertionError(f"{kernel}: no flight recentered")
        _equal(st_sh, st_un, f"recentering {kernel} state")
        _equal(outs_sh, outs_un, f"recentering {kernel} outs")
        if int(metrics["recenters"]) != out[kernel]:
            raise AssertionError(f"{kernel}: the summed metrics")
    return out


def dryrun_multichip(devices) -> dict:
    """Every sharded entry on tiny shapes over `devices`, each held equal
    to the unsharded run on devices[0].  Returns a summary and prints it
    as one line."""
    from micro_quad_slam_tpu_torch.models.simulator import (
        make_world, sim_init, sim_run)
    from micro_quad_slam_tpu_torch.replay.fusion import (
        fusion_arrays, replay_fusion_batched)
    from micro_quad_slam_tpu_torch.replay.mapping import (
        KERNELS, frames_to_torch, replay_mapping_batched, scanlog_to_arrays)
    from micro_quad_slam_tpu_torch.slam.pipeline import slam_replay

    devices = [torch.device(d) for d in devices]
    n = len(devices)
    dev0 = devices[0]
    frames = tiny_frames(2 * n, 3)
    state, outs, metrics = replay_mapping_sharded(frames, UL_PROFILE,
                                                  devices)
    if state.grid.shape[0] != 2 * n or int(metrics["frames_total"]) != 6 * n:
        raise AssertionError("sharded replay shapes")
    for kernel in ["xla"] + [k for k, r in KERNELS.items() if r.whole]:
        st, _, _ = replay_mapping_sharded(frames, UL_PROFILE, devices,
                                          kernel=kernel)
        st_un, _ = replay_mapping_batched(frames_to_torch(frames, dev0),
                                          UL_PROFILE, kernel=kernel)
        _equal(st, st_un, f"replay {kernel}")
    recenters = recentering_case(devices)

    logs = _tiny_logs(n, 4)
    fus = _stack([fusion_arrays(lg) for lg in logs])
    ek_state, ek_track = replay_fusion_sharded(fus, UL_PROFILE, devices)
    _equal((ek_state, ek_track),
           replay_fusion_batched(frames_to_torch(fus, dev0), UL_PROFILE),
           "fusion")

    slam_fr = _stack([{**scanlog_to_arrays(lg), **fusion_arrays(lg)}
                      for lg in logs])
    res = slam_replay_sharded(slam_fr, UL_PROFILE, devices, kf_every=2,
                              gn_iters=2)
    _equal(res, slam_replay(frames_to_torch(slam_fr, dev0), UL_PROFILE,
                            kf_every=2, gn_iters=2), "slam")

    B = 2 * n
    world = make_world(B, room=(-3.0, -3.0, 3.0, 3.0), device=dev0)
    st0 = sim_init(B, 0, spread_m=0.5, device=dev0)
    sim_st, sim_diag = sim_run_sharded(st0, world, 3, UL_PROFILE, devices)
    want = sim_run(st0, world, 3, UL_PROFILE)
    _equal((sim_st._replace(gen=None), sim_diag),
           (want[0]._replace(gen=None), want[1]), "swarm")
    if not torch.equal(sim_st.gen.get_state(), want[0].gen.get_state()):
        raise AssertionError("swarm: the generator's state")

    summary = {"devices": [str(d) for d in devices],
               "grids": list(state.grid.shape),
               "used": int(metrics["frames_used"]),
               "recenters": recenters,
               "fusion": list(ek_state.mean.shape),
               "slam": list(res.grid.shape), "sim": list(sim_st.x.shape)}
    print(f"dryrun_multichip ok: {summary}", flush=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "micro_quad_slam_tpu_torch.parallel.dryrun")
    p.add_argument("n_devices", nargs="?", type=int)
    p.add_argument("--device", default="cuda",
                   help="cuda (the visible cards) or cpu (repeated)")
    args = p.parse_args(argv)
    dryrun_multichip(make_mesh(args.n_devices, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
