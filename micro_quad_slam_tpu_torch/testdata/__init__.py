"""Committed test flights of the port, as numpy arrays.

Each `<name>.npz` holds one batch of flights in the layout of
replay/mapping.py::scanlog_to_arrays with a leading flight dimension
(grid_mm [B, T, 4, 8, 8], x_m [B, T], ...; slam_bench_flights also holds
the EKF inputs of replay/fusion.py::fusion_arrays).  The golden ones also
hold the golden C model's result for every flight under `golden_*` keys: `grid`
(the logical int8 grid [B, H, W]), `used` [B, T], `recentered` [B] and
`origin_x` [B].

    random_flights        8 x 64 noisy flights; flight 1 is dragged 40 m so
                          that it recenters, flight 7 never takes off
    golden_hover          a 32-frame hover (tests/test_replay.py:26-32)
    golden_line_recenter  a 40-frame 18 m line that recenters
                          (tests/test_replay.py:53-64)
    golden_short_beams    3 frames with every zone at 51 mm (flight 0) or
                          53 mm (flight 1): most rays end in the pose cell
    bench_flight          bench.py's base flight, 256 frames
    slam_bench_flights    the 4 distinct circle flights (flow on, 6 mm
                          noise) of sim/synthio.py::slam_bench_frames at
                          256 frames, with the EKF inputs of
                          replay/fusion.py::fusion_arrays as well

Beside the flights, reference results of the JAX package's replay
(`reference(name)`):

    hybrid_random_flights  `grid`: the logical grids [8, 500, 500] of its
                           kernel="hybrid" replay of random_flights
    hybrid_bench_sums      `sums` and `weighted` (grid_sums) [1024] of
                           each flight's grid after its kernel="hybrid"
                           replay of bench_frames(1024), bench.py's
                           hybridx workload
    slam_bench_ref         its slam_replay of slam_bench_flights, under
                           `ul_` (UL_PROFILE) and `rt_` (UL_RT_PROFILE):
                           track, odo_track [4, 256, 3], kf_nodes
                           [4, 26, 3], and the grids' sums and weighted
                           sums [4]; `ekf_x`, its fusion replay's x track
    slam_stages            `_slam_impl` of a small batch (2 copies of a
                           60-frame drifting circle, the second 5 m east;
                           inputs under `in_`) with the trimmed profile of
                           tests/test_slam.py::test_slam_small_end_to_end,
                           kf_every 10, gn_iters 4, stage by stage
    swarm_small_jax        its closed-loop simulator on bench.py's swarm
                           configuration (bench.py:45-81) cut to B=8:
                           the start state sim_init(8, PRNGKey(0),
                           spread_m=0.5, airborne=True) under `start.`
                           (nested fields joined by dots, no key), its 10
                           scan ticks' draws `normal` and `uniform`
                           [10, 8, 4, 8, 8], and the results of
                           sim_run(T=1000, dt_ms=1, record=True): the
                           behaviour-state and cmd_kind traces [1000, 8],
                           the final padded grids, frontier scores, true
                           poses x, y, yaw and EKF means

and one result of the port itself:

    swarm_bench_ref        the port's CPU run of the B=1024 bench swarm
                           (swarm_bench: sim_init(1024, seed 0,
                           airborne) with its own generator's draws):
                           `checksum` and per-quad grid `sums` [1024];
                           torch's generator draws other numbers than
                           jax.random, so it is not the TPU record

tests/test_torch_testdata.py holds every file bit-equal to what the JAX
package's flight simulator, golden model and replay give now (re-deriving
a few bench flights), and rewrites them all when run as a script:

    JAX_PLATFORMS=cpu python tests/test_torch_testdata.py
"""

from __future__ import annotations

import os

import numpy as np

NAMES = ("random_flights", "golden_hover", "golden_line_recenter",
         "golden_short_beams", "bench_flight", "slam_bench_flights")
REFERENCES = ("hybrid_random_flights", "hybrid_bench_sums", "slam_bench_ref",
              "slam_stages", "swarm_small_jax", "swarm_bench_ref")

# bench.py's swarm workload (bench.py:45-81): world, start and run
SWARM_WORLD = {"room": (-3.5, -3.5, 3.5, 3.5),
               "obstacles": ((1.5, -0.5, 2.5, 0.5),)}
SWARM_RUN = {"dt_ms": 1, "scan_period_ms": 100}
SWARM_T, SWARM_B = 1000, 1024


def path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.npz")


def load(name: str):
    """-> (frames dict of [B, T, ...] arrays, golden dict; empty when the
    file holds no golden result)."""
    with np.load(path(name)) as z:
        frames = {k: z[k] for k in z.files if not k.startswith("golden_")}
        golden = {k[len("golden_"):]: z[k] for k in z.files
                  if k.startswith("golden_")}
    return frames, golden


def reference(name: str) -> dict:
    """A stored reference result: dict of numpy arrays."""
    if name not in REFERENCES:
        raise ValueError(f"unknown reference {name!r}; one of {REFERENCES}")
    with np.load(path(name)) as z:
        return {k: z[k] for k in z.files}


def grid_sums(grids: np.ndarray) -> dict:
    """Per-flight int64 digests of int8 grids [B, ...]: `sums`, the plain
    sum (bench.py's checksum is their int32 total), and `weighted`, the
    sum of each cell's value times its flat index mod 65521, which also
    moves when a value moves to another cell."""
    g = np.asarray(grids).reshape(len(grids), -1).astype(np.int64)
    w = np.arange(g.shape[1], dtype=np.int64) % 65521
    return {"sums": g.sum(axis=1), "weighted": g @ w}


def bench_frames(B: int = 1024) -> dict:
    """bench.py's replay workload (bench.py:191-202): its base flight
    replicated B times with per-flight pose jitter from rng seed 1."""
    base, _ = load("bench_flight")
    rng = np.random.default_rng(1)
    frames = {k: np.broadcast_to(v[0], (B,) + v.shape[1:]).copy()
              for k, v in base.items()}
    frames["x_m"] = frames["x_m"] + rng.normal(0, 0.3, (B, 1)).astype(np.float32)
    frames["y_m"] = frames["y_m"] + rng.normal(0, 0.3, (B, 1)).astype(np.float32)
    frames["yaw_deg"] = np.mod(
        frames["yaw_deg"] + rng.uniform(-180, 180, (B, 1)).astype(np.float32)
        + 180.0, 360.0) - 180.0
    return frames


def slam_bench_frames(B: int, T: int = 256, device=None) -> dict:
    """bench.py's SLAM and EKF workload (sim/synthio.py::slam_bench_frames):
    the 4 distinct slam_bench_flights replicated to B flights, as tensors
    on `device` (replay/mapping.py::frames_to_torch: the CUDA device unless
    told otherwise).  Only their committed length, T=256, is available."""
    from micro_quad_slam_tpu_torch.replay.mapping import frames_to_torch

    base, _ = load("slam_bench_flights")
    if T != base["x_m"].shape[1]:
        raise ValueError(f"the SLAM bench flights hold {base['x_m'].shape[1]} "
                         f"frames, not {T}")
    nrep = -(-B // 4)
    return frames_to_torch({k: np.concatenate([v] * nrep)[:B]
                            for k, v in base.items()}, device)


def _unflatten(flat: dict) -> dict:
    """{"a.b": v} -> {"a": {"b": v}}."""
    out: dict = {}
    for key, v in flat.items():
        *head, last = key.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def swarm_small(device=None):
    """The committed JAX small swarm (swarm_small_jax) as the port's
    inputs: (world, start state, the 10 scan ticks' draws, the reference
    dict), on `device` (the CUDA device unless told otherwise)."""
    import torch

    from micro_quad_slam_tpu_torch.models.simulator import (
        make_world, sim_state_from_numpy)

    ref = reference("swarm_small_jax")
    start = _unflatten({k[len("start."):]: v for k, v in ref.items()
                        if k.startswith("start.")})
    st = sim_state_from_numpy(start, device)
    draws = [(torch.from_numpy(n), torch.from_numpy(u))
             for n, u in zip(ref["normal"], ref["uniform"])]
    world = make_world(st.x.shape[0], **SWARM_WORLD, device=st.x.device)
    return world, st, draws, ref


def swarm_bench(lanes=None, device=None):
    """The port's bench swarm: (world, start state, draws) of B=1024 quads
    from sim_init(1024, seed 0, spread_m=0.5, airborne=True), on `device`
    (the CUDA device unless told otherwise).  With `lanes`, only those
    quads, and draws holds their part of the 10 scan ticks' draws on the
    start state's generator (the whole swarm's run draws them itself:
    draws is None)."""
    from micro_quad_slam_tpu_torch.models.simulator import (
        fork_generator, make_world, scan_draws, select_lanes, sim_init)

    B = SWARM_B
    st = sim_init(B, 0, spread_m=0.5, airborne=True, device=device)
    world = make_world(B, **SWARM_WORLD, device=st.x.device)
    if lanes is None:
        return world, st, None
    gen = fork_generator(st.gen)
    n_scans = SWARM_T * SWARM_RUN["dt_ms"] // SWARM_RUN["scan_period_ms"]
    draws = [tuple(d[list(lanes)] for d in scan_draws(gen, B))
             for _ in range(n_scans)]
    return select_lanes(world, lanes), select_lanes(st, lanes), draws


def int32_total(sums) -> int:
    """The int32 (wrapping) total of per-quad sums: bench.py's checksum."""
    return (int(np.sum(np.asarray(sums, np.int64))) + 2 ** 31) % 2 ** 32 \
        - 2 ** 31


def swarm_bench_result(device=None) -> dict:
    """swarm_bench_ref's content, computed now by the port on `device`:
    the whole bench swarm's run (B=1024, T=1000) and its grids' checksum
    and per-quad sums.  On the CPU it takes minutes and ~1 GB."""
    from micro_quad_slam_tpu_torch.models.simulator import sim_run
    from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE

    world, st, _ = swarm_bench(device=device)
    fin, _ = sim_run(st, world, SWARM_T, UL_PROFILE, **SWARM_RUN)
    sums = grid_sums(fin.mapper.grid.cpu().numpy())["sums"]
    return {"checksum": np.int64(int32_total(sums)), "sums": sums}
