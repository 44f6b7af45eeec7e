"""The traffic generator: a seed repeats its pool and its job batches
exactly, another seed changes them, every batch holds each pool flight
the same number of times, and the path kinds are the same for every
seed."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench.gen import flights

PKG = Path(__file__).resolve().parents[1]
TOF = {"fov_deg": 63.0}


def _traffic(name, pool):
    t = json.loads((PKG / "traffic" / f"{name}.json").read_text())
    t["pool"] = pool
    return t


@pytest.mark.parametrize("name", ["rooms", "loops"])
def test_pool_repeats_for_a_seed_and_differs_between_seeds(name):
    t = _traffic(name, 8)
    a = flights.make_pool(t, 24, TOF, 2 ** 31 + 5)
    b = flights.make_pool(t, 24, TOF, 2 ** 31 + 5)
    c = flights.make_pool(t, 24, TOF, 2 ** 31 + 6)
    for k in ("grid_mm", "x_m", "y_m", "yaw_deg", "of_rate_x"):
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["grid_mm"], c["grid_mm"])
    assert sorted(a["kind"]) == sorted(c["kind"])


@pytest.mark.parametrize("name", ["rooms", "loops"])
def test_jobs_repeat_and_hold_each_flight_equally(name):
    t = _traffic(name, 8)
    pool = flights.make_pool(t, 16, TOF, 99)
    j1 = flights.make_jobs(pool, t, 32, 3, 99)
    j2 = flights.make_jobs(pool, t, 32, 3, 99)
    for a, b in zip(j1, j2):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert (np.bincount(a["idx"], minlength=8) == 4).all()
    assert not np.array_equal(j1[0]["idx"], j1[1]["idx"])
    with pytest.raises(ValueError):
        flights.make_jobs(pool, t, 30, 1, 99)


def test_rooms_kinds_and_recentering_lines():
    """rooms: one flight in eight is a corridor line long enough to pass
    the recenter threshold (15 m from the start); every ToF value is a
    millimetre count or the no-target code."""
    t = _traffic("rooms", 16)
    pool = flights.make_pool(t, 64, TOF, 3)
    kinds = list(pool["kind"])
    assert kinds.count("line") == 2
    for i, k in enumerate(kinds):
        if k == "line":
            assert pool["x_m"][i, -1] - pool["x_m"][i, 0] > 15.0
    g = pool["grid_mm"]
    assert g.dtype == np.uint16 and (g > 0).all()
    assert np.isnan(pool["of_rate_x"]).all()


def test_loops_flow_carries_the_drawn_drift():
    t = _traffic("loops", 4)
    pool = flights.make_pool(t, 32, TOF, 8)
    assert ((pool["_drift"] >= 1.0) & (pool["_drift"] <= 1.12)).all()
    assert np.isfinite(pool["of_rate_x"]).all()
    assert (pool["of_q"] == 90).all()


def test_tof_distance_to_walls_and_boxes():
    room = (-2.0, -1.0, 3.0, 4.0)
    d = flights.tof_distance(np.array([0.0]), np.array([0.0]),
                             np.array([0.0, np.pi / 2, np.pi, -np.pi / 2]),
                             room, [])
    np.testing.assert_allclose(d, [3.0, 4.0, 2.0, 1.0])
    d = flights.tof_distance(np.array([0.0]), np.array([0.0]),
                             np.array([0.0]), room, [(1.0, -0.5, 1.5, 0.5)])
    np.testing.assert_allclose(d, [1.0])


def test_rigid_jitter_keeps_the_start_and_distances():
    x = np.array([[0.0, 1.0, 2.0]], np.float32)
    y = np.zeros((1, 3), np.float32)
    yaw = np.zeros((1, 3), np.float32)
    job = {"dx": np.array([0.5], np.float32), "dy": np.array([-1.0], np.float32),
           "rot": np.array([90.0], np.float32)}
    nx, ny, nyaw = flights.jitter_poses(x, y, yaw, job)
    np.testing.assert_allclose(nx[0], [0.5, 0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(ny[0], [-1.0, 0.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(nyaw[0], [90.0] * 3)
