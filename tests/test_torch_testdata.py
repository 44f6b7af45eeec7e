"""The port's committed test flights (micro_quad_slam_tpu_torch/testdata),
which chip_smoke.py replays on the card without the JAX package: every
file must equal, bit for bit, what the JAX package's flight simulator and
golden C model give today, and the bench workload built from them must
equal bench.py's."""

import numpy as np
import pytest
import torch

from micro_quad_slam_tpu.replay.mapping import scanlog_to_arrays
from micro_quad_slam_tpu.sim import synth_room_scanlog
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.testdata import make

torch.set_num_threads(2)


@pytest.mark.parametrize("name", testdata.NAMES)
def test_committed_flight_equals_its_source(name):
    frames, golden = testdata.load(name)
    with np.load(testdata.path(name)) as z:
        assert set(z.files) == set(frames) | {f"golden_{k}" for k in golden}
    want = make.build(name)
    assert set(want) == set(frames) | {f"golden_{k}" for k in golden}
    got = {**frames, **{f"golden_{k}": v for k, v in golden.items()}}
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_bench_frames_equal_bench_py():
    """bench.py:184-202 at B=16 (the jitter draws depend on B)."""
    B, T = 16, 256
    base = scanlog_to_arrays(synth_room_scanlog(
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
