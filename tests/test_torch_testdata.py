"""The port's committed test data (micro_quad_slam_tpu_torch/testdata),
which chip_smoke.py uses on the card without the JAX package: every flight
must equal, bit for bit, what the JAX package's flight simulator and
golden C model give today, the bench workload built from them must equal
bench.py's, and the stored hybrid replay results must equal the JAX
package's kernel="hybrid" replay (a few bench flights re-derived).

This file is also the generator of that data.  From the repository root:

    JAX_PLATFORMS=cpu python tests/test_torch_testdata.py

rewrites every file (the B=1024 hybrid bench sums run on the CPU in
chunks of 64 flights).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from micro_quad_slam_tpu.golden import golden_replay_mapping  # noqa: E402
from micro_quad_slam_tpu.replay import mapping as jm  # noqa: E402
from micro_quad_slam_tpu.sim import synth_room_scanlog  # noqa: E402
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL  # noqa: E402
import micro_quad_slam_tpu_torch as port  # noqa: E402
from micro_quad_slam_tpu_torch import testdata  # noqa: E402

torch.set_num_threads(2)


# ------------------------------------------------------------- generator

def _stack(logs) -> dict:
    arrs = [jm.scanlog_to_arrays(lg) for lg in logs]
    return {k: np.stack([a[k] for a in arrs]) for k in arrs[0]}


class _FramesLog:
    """One flight of a frames dict, seen as a scanlog by the golden model."""

    def __init__(self, frames: dict, b: int):
        for k, v in frames.items():
            setattr(self, k, v[b])

    def __len__(self):
        return self.x_m.shape[0]


def _with_golden(frames: dict) -> dict:
    runs = [golden_replay_mapping(_FramesLog(frames, b))
            for b in range(frames["x_m"].shape[0])]
    return {**frames,
            "golden_grid": np.stack([m.grid for m, _ in runs]),
            "golden_used": np.stack([u for _, u in runs]),
            "golden_recentered": np.array([m.recentered for m, _ in runs]),
            "golden_origin_x": np.array([m.origin_x for m, _ in runs],
                                        np.float32)}


def random_flights(B: int = 8, T: int = 64) -> dict:
    logs = [synth_room_scanlog(n_frames=T, seed=s, noise_mm=5.0,
                               dropout_p=0.05, path=("circle", "hover")[s % 2])
            for s in range(B - 1)]
    logs.append(synth_room_scanlog(n_frames=T, seed=99, state=1))
    f = _stack(logs)
    f["x_m"][1] = np.linspace(0.0, 34.0, T, dtype=np.float32)
    f["y_m"][1] = np.linspace(0.0, -21.0, T, dtype=np.float32)
    return f


def golden_hover() -> dict:
    return _with_golden(_stack([synth_room_scanlog(
        n_frames=32, room=(-2.0, -2.0, 2.0, 2.0), path="hover",
        yaw_rate_dps=20.0, noise_mm=6.0, dropout_p=0.05, seed=11)]))


def golden_line_recenter() -> dict:
    return _with_golden(_stack([synth_room_scanlog(
        n_frames=40, room=(-3.0, -3.0, 40.0, 3.0), path="line",
        path_radius_m=18.0, seed=13, noise_mm=4.0)]))


def golden_short_beams() -> dict:
    B, T = 2, 3
    grid_mm = np.full((B, T, 4, 8, 8), 51, np.uint16)
    grid_mm[1] = 53
    return _with_golden({
        "grid_mm": grid_mm,
        "x_m": np.zeros((B, T), np.float32),
        "y_m": np.zeros((B, T), np.float32),
        "yaw_deg": np.full((B, T), 45.0, np.float32),
        "of_q": np.full((B, T), 200, np.int32),
        "of_rate_x": np.zeros((B, T), np.float32),
        "sys_health": np.zeros((B, T), np.int64),
        "state": np.full((B, T), 5, np.uint8)})


def bench_flight() -> dict:
    """bench.py:191-194's base flight."""
    return _stack([synth_room_scanlog(n_frames=256, seed=0, path="hover",
                                      yaw_rate_dps=20.0, noise_mm=5.0)])


def _jax_hybrid_grids(frames: dict) -> np.ndarray:
    """The JAX package's kernel="hybrid" replay: padded grids [B, PR, PC]."""
    st, _ = jm.replay_mapping_batched(frames, JAX_UL, kernel="hybrid")
    return np.asarray(st.grid)


def hybrid_random_flights() -> dict:
    frames, _ = testdata.load("random_flights")
    grids = torch.from_numpy(_jax_hybrid_grids(frames).copy())
    return {"grid": port.logical_grid(grids).contiguous().numpy()}


def _bench_sums(flights, chunk: int = 64) -> dict:
    """testdata.grid_sums of the JAX hybrid replay of the listed bench
    flights, `chunk` flights per call."""
    frames = testdata.bench_frames(1024)
    flights = np.asarray(flights)
    parts = [testdata.grid_sums(_jax_hybrid_grids(
        {k: v[flights[i:i + chunk]] for k, v in frames.items()}))
        for i in range(0, len(flights), chunk)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def hybrid_bench_sums() -> dict:
    return _bench_sums(np.arange(1024))


def build(name: str) -> dict:
    if name not in testdata.NAMES + testdata.REFERENCES:
        raise ValueError(f"unknown test data {name!r}")
    return globals()[name]()


def main() -> int:
    for name in testdata.NAMES + testdata.REFERENCES:
        np.savez_compressed(testdata.path(name), **build(name))
        print(testdata.path(name), flush=True)
    return 0


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("name", testdata.NAMES)
def test_committed_flight_equals_its_source(name):
    frames, golden = testdata.load(name)
    with np.load(testdata.path(name)) as z:
        assert set(z.files) == set(frames) | {f"golden_{k}" for k in golden}
    want = build(name)
    assert set(want) == set(frames) | {f"golden_{k}" for k in golden}
    got = {**frames, **{f"golden_{k}": v for k, v in golden.items()}}
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_bench_frames_equal_bench_py():
    """bench.py:184-202 at B=16 (the jitter draws depend on B)."""
    B, T = 16, 256
    base = jm.scanlog_to_arrays(synth_room_scanlog(
        n_frames=T, seed=0, path="hover", yaw_rate_dps=20.0, noise_mm=5.0))
    rng = np.random.default_rng(1)
    want = {k: np.broadcast_to(v, (B,) + v.shape).copy()
            for k, v in base.items()}
    want["x_m"] = want["x_m"] + rng.normal(0, 0.3, (B, 1)).astype(np.float32)
    want["y_m"] = want["y_m"] + rng.normal(0, 0.3, (B, 1)).astype(np.float32)
    want["yaw_deg"] = np.mod(
        want["yaw_deg"] + rng.uniform(-180, 180, (B, 1)).astype(np.float32)
        + 180.0, 360.0) - 180.0
    got = testdata.bench_frames(B)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["golden_hover", "golden_line_recenter",
                                  "golden_short_beams"])
def test_exact_replay_equals_committed_golden(name):
    """The port's exact path on the CPU against the stored golden result,
    as chip_smoke.py's golden phase checks it on the card."""
    frames, golden = testdata.load(name)
    st, outs = port.replay_mapping_batched(
        port.frames_to_torch(frames, "cpu"), port.UL_PROFILE,
        kernel="residentx")
    np.testing.assert_array_equal(port.logical_grid(st.grid).numpy(),
                                  golden["grid"])
    np.testing.assert_array_equal(outs["used"].numpy(), golden["used"])
    np.testing.assert_array_equal(st.origin_x.numpy(), golden["origin_x"])
    np.testing.assert_array_equal(outs["kf_flags"].numpy().any(axis=1),
                                  golden["recentered"])


def test_hybrid_random_flights_equals_jax_now():
    want = build("hybrid_random_flights")["grid"]
    got = testdata.reference("hybrid_random_flights")["grid"]
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert (got > 10).sum() > 300 and (got < -10).sum() > 3000


@pytest.mark.parametrize("flight", [0, 511, 1023])
def test_hybrid_bench_sum_equals_jax_now(flight):
    """One bench flight at full T through the JAX hybrid replay, against
    its stored sum."""
    ref = testdata.reference("hybrid_bench_sums")
    assert set(ref) == {"sums", "weighted"}
    got = _bench_sums([flight])
    for k, v in ref.items():
        assert v.shape == (1024,) and v.dtype == np.int64, k
        assert int(got[k][0]) == int(v[flight]), k


def test_hybrid_references_equal_the_port_on_the_cpu():
    """The port's hybridx path (its kernel's plain version on the CPU)
    gives the stored JAX results: the small flights' grids and the sums
    of the three re-derived bench flights."""
    frames, _ = testdata.load("random_flights")
    st, _ = port.replay_mapping_batched(port.frames_to_torch(frames, "cpu"),
                                        port.UL_PROFILE, kernel="hybridx")
    np.testing.assert_array_equal(
        port.logical_grid(st.grid).numpy(),
        testdata.reference("hybrid_random_flights")["grid"])
    sel = [0, 511, 1023]
    bench = {k: v[sel] for k, v in testdata.bench_frames(1024).items()}
    st, _ = port.replay_mapping_batched(port.frames_to_torch(bench, "cpu"),
                                        port.UL_PROFILE, kernel="hybridx")
    got = testdata.grid_sums(st.grid.numpy())
    for k, v in testdata.reference("hybrid_bench_sums").items():
        np.testing.assert_array_equal(got[k], v[sel], err_msg=k)


if __name__ == "__main__":
    sys.exit(main())
