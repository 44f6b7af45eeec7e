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
              "slam_stages")


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
