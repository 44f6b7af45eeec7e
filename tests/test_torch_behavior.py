"""PyTorch port, models/behavior.py: the UL flight state machine against
the numpy golden model (micro_quad_slam_tpu/golden/behavior.py) and the
JAX machine, tick for tick, on tests/fc_mock.py's scenarios (the default
ones of tests/test_behavior.py: seeds 11, 14, 15, 21).

Integer and boolean outputs are held equal; `cmd` within 2e-5, the JAX
test's tolerance against the golden model (float32 ramp and yaw-rate
arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fc_mock import Scenario, run_scenario
from micro_quad_slam_tpu.models import behavior as jb
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
from micro_quad_slam_tpu_torch.models import behavior as tb
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE
from test_behavior import telems_to_arrays

torch.set_num_threads(2)

SEEDS = {11: Scenario(seed=11),
         14: Scenario(seed=14, no_spool=True, ramp_works=False),
         15: Scenario(seed=15, no_spool=True, ramp_works=True),
         21: Scenario(seed=21, alt_overshoot_m=0.25,
                      overshoot_until_ms=9000)}
N_TICKS = 1100
INT_KEYS = ("state", "cmd_kind", "req_mode", "req_arm", "rc_release",
            "kf_flags", "map_init", "ceiling", "alt_src")
CMD_ATOL = 2e-5


def _seq(telems) -> dict:
    """Telemetry list -> {field: [T, 1(, 4)] tensor}; the uint32 health
    bits widen to int64."""
    arrs = telems_to_arrays(telems)
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                else v)[:, None] for k, v in arrs.items()}


def _port_trace(seq: dict, batch: int = 1) -> dict:
    """The port's machine over [T, B] telemetry: outputs stacked [T, B]."""
    state = tb.behavior_init(batch, "cpu")
    outs = []
    for i in range(seq["t_ms"].shape[0]):
        state, o = tb.behavior_step(state, {k: v[i] for k, v in seq.items()},
                                    UL_PROFILE)
        outs.append(o)
    return {k: torch.stack([o[k] for o in outs]).numpy() for k in outs[0]}


@pytest.fixture(scope="module")
def runs():
    """Each scenario's golden run, and the JAX machine's trace of the four
    scenarios' telemetry as one B=4 batch (one compile)."""
    golden = {s: run_scenario(sc, n_ticks=N_TICKS) for s, sc in SEEDS.items()}
    arrs = [telems_to_arrays(golden[s][0]) for s in SEEDS]
    batched = {k: np.stack([a[k] for a in arrs], axis=1) for k in arrs[0]}
    _, jouts = jax.jit(lambda s0, sq: jax.lax.scan(
        lambda st, fr: jb.behavior_step(st, fr, JAX_UL), s0, sq))(
        jb.behavior_init(len(SEEDS)),
        {k: jnp.asarray(v) for k, v in batched.items()})
    jax_lanes = {s: {k: np.asarray(v)[:, b] for k, v in jouts.items()}
                 for b, s in enumerate(SEEDS)}
    seq = {k: torch.cat([_seq(golden[s][0])[k] for s in SEEDS], dim=1)
           for k in _seq(golden[11][0])}
    return golden, jax_lanes, _port_trace(seq, len(SEEDS))


def _golden_arrays(gouts) -> dict:
    g = {k: np.asarray([getattr(o, k) for o in gouts]) for k in INT_KEYS}
    g["cmd"] = np.asarray([o.cmd for o in gouts], np.float32)
    g["req_takeoff"] = np.asarray([o.req_takeoff for o in gouts], np.float32)
    return g


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_port_machine_equals_golden_and_jax_tick_for_tick(runs, seed):
    golden, jax_lanes, batched = runs
    telems, gouts = golden[seed]
    got = _port_trace(_seq(telems))
    got = {k: v[:, 0] for k, v in got.items()}
    for name, want in (("golden", _golden_arrays(gouts)),
                       ("jax", jax_lanes[seed])):
        for k in INT_KEYS:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=f"{name} {k}")
        np.testing.assert_allclose(got["cmd"], want["cmd"], rtol=0,
                                   atol=CMD_ATOL, err_msg=name)
        np.testing.assert_array_equal(np.isnan(got["req_takeoff"]),
                                      np.isnan(want["req_takeoff"]),
                                      err_msg=name)
    # the scenario's lane of the B=4 batch equals its single-lane run
    lane = list(SEEDS).index(seed)
    for k, v in batched.items():
        np.testing.assert_array_equal(v[:, lane], got[k], err_msg=k)
    assert len(set(got["state"].tolist())) >= 4       # a real mission


def test_wrap_deg_equals_jax():
    d = np.array([-539.5, -180.0, -180.00002, -0.0, 179.99998, 180.0, 359.0,
                  539.0], np.float32)
    np.testing.assert_array_equal(
        tb._wrap_deg(torch.from_numpy(d)).numpy(),
        np.asarray(jb._wrap_deg(jnp.asarray(d))))


def test_behavior_state_numpy_round_trip_and_init_equal_jax():
    want = jax.tree_util.tree_map(np.asarray, jb.behavior_init(3))
    got = tb.behavior_state_to_numpy(tb.behavior_init(3, "cpu"))
    assert list(got) == list(want._fields)
    for k, v in want._asdict().items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = tb.behavior_state_to_numpy(
        tb.behavior_state_from_numpy(want, "cpu"))
    for k, v in want._asdict().items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_drain_kf_clears_and_returns_flags():
    st = tb.behavior_init(2, "cpu")._replace(
        kf=torch.tensor([5, 0], dtype=torch.int32))
    st2, flags = tb.drain_kf(st)
    assert flags.tolist() == [5, 0] and st2.kf.tolist() == [0, 0]
