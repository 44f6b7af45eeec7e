"""PyTorch port, sim/synthio.py: the synthetic flight generator against the
JAX package's.  The same arguments must give the same scanlog, byte for
byte (both packages' writers), and the same exact wall distances."""

import math

import numpy as np
import pytest
import torch

from micro_quad_slam_tpu.formats.scanlog import write_scanlog as jwrite
from micro_quad_slam_tpu.sim import synthio as jsyn
from micro_quad_slam_tpu.utils.config import TofConfig as JTof
from micro_quad_slam_tpu_torch.formats.scanlog import write_scanlog as twrite
from micro_quad_slam_tpu_torch.sim import synthio as tsyn
from micro_quad_slam_tpu_torch.utils.config import TofConfig as TTof

CASES = {
    "circle_default": {},
    "hover_noise_dropout": dict(path="hover", yaw_rate_dps=20.0,
                                noise_mm=5.0, dropout_p=0.05, seed=11),
    "line_obstacles": dict(path="line", path_radius_m=3.0, seed=2,
                           room=(-3.0, -3.0, 6.0, 3.0),
                           obstacles=[(1.0, -0.4, 1.6, 0.4),
                                      (2.5, 1.0, 3.0, 2.8)]),
    "fig8_flow": dict(path="fig8", with_flow=True, noise_mm=6.0, seed=4,
                      dt_ms=50),
    "circle_flow_state": dict(with_flow=True, state=1, noise_mm=8.0,
                              dropout_p=0.2, seed=9, path_radius_m=2.5),
    "far_walls_saturate": dict(room=(-80.0, -1.0, 80.0, 1.0), path="hover",
                               noise_mm=3.0, seed=5),
}


def _bytes(write, log, tmp_path, name: str) -> bytes:
    p = tmp_path / name
    write(str(p), log)
    return p.read_bytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_synth_room_scanlog_byte_for_byte(tmp_path, case):
    kw = {"n_frames": 40, **CASES[case]}
    got, want = tsyn.synth_room_scanlog(**kw), jsyn.synth_room_scanlog(**kw)
    for f in ("grid_mm", "x_m", "yaw_deg", "of_rate_x", "of_q", "state"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert _bytes(twrite, got, tmp_path, "t.bin") == _bytes(
        jwrite, want, tmp_path, "j.bin")
    if case == "far_walls_saturate":
        assert (got.grid_mm == 0xFFFF).any()


def test_synth_with_a_tof_config_and_a_generator():
    """Another ToF fan (the port's TofConfig copy against the JAX one) and
    a caller's generator, which both draw from in the same order."""
    tof = dict(fov_deg=50.0, dir_center_deg=(5.0, -85.0, 175.0, 95.0))
    got = tsyn.synth_room_scanlog(n_frames=12, noise_mm=4.0, tof=TTof(**tof),
                                  rng=np.random.default_rng(3))
    want = jsyn.synth_room_scanlog(n_frames=12, noise_mm=4.0, tof=JTof(**tof),
                                   rng=np.random.default_rng(3))
    np.testing.assert_array_equal(got.grid_mm, want.grid_mm)
    with pytest.raises(ValueError, match="unknown path"):
        tsyn.synth_room_scanlog(path="spiral")


def test_room_tof_distance_equals_jax():
    rng = np.random.default_rng(0)
    room = (-4.0, -3.0, 5.0, 2.0)
    obstacles = [(0.5, 0.5, 1.5, 1.0), (-2.0, -2.5, -1.0, -1.5)]
    angles = list(rng.uniform(-math.pi, math.pi, 300)) + [
        0.0, math.pi / 2, math.pi, -math.pi / 2]
    for ang in angles:
        x, y = rng.uniform(-3.5, 4.5), rng.uniform(-2.5, 1.5)
        assert tsyn.room_tof_distance(x, y, ang, room, obstacles) == \
            jsyn.room_tof_distance(x, y, ang, room, obstacles)
    assert tsyn.room_tof_distance(0.0, 0.0, 0.0, room) == 5.0


def test_slam_bench_frames_equal_jax():
    """The SLAM and EKF bench workload at B=6, T=40 (one partial
    replication), as numpy and as CPU tensors."""
    want = jsyn.slam_bench_frames(6, 40, device_put=False)
    got = tsyn.slam_bench_frames(6, 40, device_put=False)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    t = tsyn.slam_bench_frames(6, 40, device="cpu")
    assert t["scan_ms"].dtype == torch.int64
    np.testing.assert_array_equal(t["x_m"].numpy(), want["x_m"])
