"""Sharding over devices: scale-out over flight logs and quads
(counterpart of micro_quad_slam_tpu/parallel/mesh.py).

The system's parallelism is pure data parallelism over independent
replays, one flight (or one simulated quad) per batch lane.  Where the
JAX package shards the batch over a 1-D ('logs',) device mesh, the port
splits it over a list of torch devices: B splits into equal contiguous
shards, shard i runs the unsharded entry on devices[i], and the results
come back concatenated on devices[0].  Nothing crosses lanes but the
aggregate metrics, which are summed, and no lane's arithmetic depends on
the batch size (the pose graph's solve included, slam/posegraph.py).  So
every sharded result equals the unsharded one bit for bit.

The shards run one after another from the host; each device queues its
work asynchronously, so distinct cards overlap where a path does not wait
on its card.  A device may repeat in the list: that is how one card (or
a CPU) shows the split, ["cuda:0", "cuda:0"] or ["cpu", "cpu"], though a
repeated device is not a second card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from micro_quad_slam_tpu_torch.ops.raycast import DEFAULT_GEOM, GridGeom
from micro_quad_slam_tpu_torch.utils.config import PipelineConfig, UL_PROFILE


def batch_metrics(outs: dict) -> dict:
    """Aggregate per-frame outputs [B, T] to scalar int64 tensors on the
    outputs' device."""
    used = outs["used"]
    return {
        "frames_total": torch.tensor(used.numel(), device=used.device),
        "frames_used": used.sum(),
        "recenters": (outs["kf_flags"] != 0).sum(),
    }


def make_mesh(n_devices: Optional[int] = None, device=None) -> list:
    """The devices to shard over: the visible CUDA devices (the first
    n_devices of them), or with device="cpu" the CPU n_devices times
    (default once).  Raises where fewer devices are visible than asked
    for, or no CUDA device at all."""
    kind = torch.device(device if device is not None else "cuda").type
    if kind == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device found: shard over a list of "
                           "devices, e.g. make_mesh(2, 'cpu')")
    if n_devices is not None and n_devices > n:
        raise RuntimeError(f"need {n_devices} CUDA devices, have {n}")
    return [torch.device("cuda", i) for i in range(n_devices or n)]


def _devices(devices) -> list:
    return [torch.device(d) for d in (devices or make_mesh())]


def shard_bounds(batch: int, devices: Sequence) -> list:
    """The contiguous lane ranges [(start, stop)] of a batch of `batch`
    over the devices.  The batch must split evenly."""
    n = len(devices)
    if n == 0 or batch % n:
        raise ValueError(f"the batch ({batch}) must be a multiple of the "
                         f"device count ({n})")
    per = batch // n
    return [(i * per, (i + 1) * per) for i in range(n)]


def to_device(tree, device):
    """Every tensor of a tensor tree (NamedTuples, dicts, tuples, lists)
    moved to `device`; host values (ints, a generator) kept."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(f, device) for f in tree))
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def concat_shards(trees: list, device, dim: int = 0):
    """The shards' results joined on `device`: tensors concatenated along
    `dim` (the batch dimension), host values taken from the first shard."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.cat([t.to(device) for t in trees], dim=dim)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(concat_shards(list(f), device, dim)
                             for f in zip(*trees)))
    if isinstance(first, dict):
        return {k: concat_shards([t[k] for t in trees], device, dim)
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(concat_shards(list(f), device, dim)
                           for f in zip(*trees))
    return first


def shard_batch(frames: dict, devices) -> list:
    """A frames dict of [B, ...] arrays or tensors -> one dict per device
    holding its contiguous lanes, on that device."""
    from micro_quad_slam_tpu_torch.replay.mapping import frames_to_torch

    devices = _devices(devices)
    B = frames["x_m"].shape[0]
    return [frames_to_torch({k: v[a:b] for k, v in frames.items()}, dev)
            for (a, b), dev in zip(shard_bounds(B, devices), devices)]


def replay_mapping_sharded(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                           devices=None, geom: GridGeom = DEFAULT_GEOM,
                           kernel: str = "xla"):
    """replay_mapping_batched with the batch split over the devices (every
    kernel name it takes).  Returns (MappingState [B], outs [B, T],
    batch_metrics summed over the shards), all on devices[0]."""
    from micro_quad_slam_tpu_torch.replay.mapping import replay_mapping_batched

    devices = _devices(devices)
    runs = [replay_mapping_batched(f, cfg, geom, kernel)
            for f in shard_batch(frames, devices)]
    state = concat_shards([r[0] for r in runs], devices[0])
    outs = concat_shards([r[1] for r in runs], devices[0])
    metrics = {k: sum(batch_metrics(r[1])[k].to(devices[0]) for r in runs)
               for k in ("frames_total", "frames_used", "recenters")}
    return state, outs, metrics


def replay_fusion_sharded(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                          devices=None):
    """replay_fusion_batched with the batch split over the devices.
    Returns (EkfState [B], track of [B, T]) on devices[0]."""
    from micro_quad_slam_tpu_torch.replay.fusion import replay_fusion_batched

    devices = _devices(devices)
    runs = [replay_fusion_batched(f, cfg)
            for f in shard_batch(frames, devices)]
    return concat_shards(runs, devices[0])


def slam_replay_sharded(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                        devices=None, geom: GridGeom = DEFAULT_GEOM,
                        kf_every: int | None = None,
                        gn_iters: int | None = None):
    """slam_replay with the flights split over the devices (kf_every and
    gn_iters override cfg.slam, as there).  Returns a SlamResult on
    devices[0]; kf_idx, the same for every shard, is the first shard's."""
    from micro_quad_slam_tpu_torch.slam.pipeline import slam_replay

    devices = _devices(devices)
    runs = [slam_replay(f, cfg, geom, kf_every, gn_iters)
            for f in shard_batch(frames, devices)]
    res = concat_shards(runs, devices[0])
    return res._replace(kf_idx=runs[0].kf_idx.to(devices[0]))


def sim_run_sharded(state, world, n_steps: int,
                    cfg: PipelineConfig = UL_PROFILE, devices=None,
                    geom: GridGeom = DEFAULT_GEOM, dt_ms: int = 20,
                    scan_period_ms: int = 100, record: bool = False,
                    vision_flow: bool = False):
    """sim_run with the quads split over the devices.  The swarm draws its
    scan noise on one CPU generator (SimState.gen): every scan tick's
    draws are made here at the global width [B, 4, 8, 8], in sim_run's
    order, on a fork of the state's generator, and each shard gets its
    lanes of them (select_lanes; sim_run(draws=)).  So every quad flies
    as in the unsharded run and the returned state's generator ends where
    the unsharded run's does.  Returns (SimState [B], diagnostics
    [T, B, ...]) on devices[0]."""
    from micro_quad_slam_tpu_torch.models.simulator import (
        fork_generator, scan_draws, scan_tick_count, select_lanes, sim_run)

    devices = _devices(devices)
    B = state.x.shape[0]
    gen = fork_generator(state.gen)
    draws = [scan_draws(gen, B) for _ in range(
        scan_tick_count(state.t_ms, n_steps, dt_ms, scan_period_ms))]
    runs = []
    for (a, b), dev in zip(shard_bounds(B, devices), devices):
        lanes = torch.arange(a, b)
        runs.append(sim_run(
            to_device(select_lanes(state, lanes), dev),
            to_device(select_lanes(world, lanes), dev), n_steps, cfg, geom,
            dt_ms, scan_period_ms, record, vision_flow,
            draws=[(n[a:b], u[a:b]) for n, u in draws]))
    final = concat_shards([r[0] for r in runs], devices[0])
    diag = concat_shards([r[1] for r in runs], devices[0], dim=1)
    return final._replace(gen=gen), diag
