"""PyTorch port, models/behavior_cl.py: the CL flight state machine against
the numpy golden model (micro_quad_slam_tpu/golden/behavior_cl.py) and the
JAX machine, tick for tick, on tests/test_behavior_cl.py's scenarios
(the golden ones, :37-85, and CL_SCENARIOS, :101-113) and its fuzzed
schedules (:160).

Every scenario runs 2500 ticks (as long as the longest golden test), all
in one B=15 batch through the port and through the JAX machine; the fuzz
runs fc_mock.random_scenario's schedules for 700 ticks as one batch.
State, command kind, mode, arm, keyframe flags, altitude source, ceiling
and the map outputs are held equal; `cmd` within 2e-5, as
tests/test_torch_behavior.py holds the UL machine (float32 ramp
arithmetic, which XLA-CPU contracts into fmas)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fc_mock import Scenario, random_scenario, run_scenario
from micro_quad_slam_tpu.golden.behavior_cl import GoldenBehaviorCL
from micro_quad_slam_tpu.models import behavior_cl as jcl
from micro_quad_slam_tpu.utils.config import CL_PROFILE as JAX_CL
from micro_quad_slam_tpu_torch.models import behavior_cl as tcl
from micro_quad_slam_tpu_torch.utils.config import CL_PROFILE
from test_behavior import telems_to_arrays
from test_behavior_cl import CL_SCENARIOS

torch.set_num_threads(2)

GOLDEN_SCENARIOS = [
    Scenario(seed=31),
    Scenario(seed=32, rf_dropout_ms=(0, 30000)),
    Scenario(seed=33, no_spool=True, ramp_works=False),
    Scenario(seed=34, batt_v0=7.8, batt_sag=0.08),
    Scenario(seed=35, lpos_dropout_ms=(12000, 20000)),
    Scenario(seed=36, disarm_at_ms=15000),
]
SCENARIOS = GOLDEN_SCENARIOS + CL_SCENARIOS
N_TICKS = 2500
FUZZ_TICKS = 700
FUZZ_FAST = 64            # fuzz seeds in the default run; all 256 are slow
INT_KEYS = ("state", "cmd_kind", "req_mode", "req_arm", "kf_flags",
            "alt_src", "ceiling", "rc_release", "map_init")
CMD_ATOL = 2e-5


def _batch(telem_lists) -> dict:
    arrs = [telems_to_arrays(t) for t in telem_lists]
    return {k: np.stack([a[k] for a in arrs], axis=1) for k in arrs[0]}


def _port_trace(batched: dict, device="cpu") -> dict:
    """The port's machine over [T, B] telemetry: outputs stacked [T, B];
    the uint32 health bits widen to int64."""
    seq = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                               else v).to(device)
           for k, v in batched.items()}
    state = tcl.behavior_cl_init(seq["t_ms"].shape[1], device)
    outs = []
    for i in range(seq["t_ms"].shape[0]):
        state, o = tcl.behavior_step_cl(state, {k: v[i] for k, v in
                                                seq.items()}, CL_PROFILE)
        outs.append(o)
    return {k: torch.stack([o[k] for o in outs]).cpu().numpy()
            for k in outs[0]}


def _jax_trace(batched: dict) -> dict:
    _, outs = jax.jit(lambda s0, sq: jax.lax.scan(
        lambda st, fr: jcl.behavior_step_cl(st, fr, JAX_CL), s0, sq))(
        jcl.behavior_cl_init(batched["t_ms"].shape[1]),
        {k: jnp.asarray(v) for k, v in batched.items()})
    return {k: np.asarray(v) for k, v in outs.items()}


def _golden_arrays(gouts) -> dict:
    g = {k: np.asarray([getattr(o, k) for o in gouts])
         for k in INT_KEYS if k != "kf_flags"}
    g["kf_flags"] = np.asarray([o.kf_flags for o in gouts])
    g["cmd"] = np.asarray([o.cmd for o in gouts], np.float32)
    g["req_takeoff"] = np.asarray([o.req_takeoff for o in gouts], np.float32)
    g["alt_est"] = np.asarray([o.alt_est for o in gouts], np.float32)
    return g


def _check_lane(got: dict, want: dict, lane: int, name: str) -> None:
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k][:, lane], want[k],
                                      err_msg=f"{name} {k}")
    np.testing.assert_allclose(got["cmd"][:, lane], want["cmd"], rtol=0,
                               atol=CMD_ATOL, err_msg=f"{name} cmd")
    for k in ("req_takeoff", "alt_est"):
        np.testing.assert_array_equal(np.isnan(got[k][:, lane]),
                                      np.isnan(want[k]),
                                      err_msg=f"{name} {k}")


def _runs(scenarios, n_ticks):
    golden = [run_scenario(sc, n_ticks=n_ticks, machine=GoldenBehaviorCL())
              for sc in scenarios]
    batched = _batch([g[0] for g in golden])
    return golden, _jax_trace(batched), _port_trace(batched)


@pytest.fixture(scope="module")
def scenario_runs():
    return _runs(SCENARIOS, N_TICKS)


@pytest.mark.parametrize("lane", range(len(SCENARIOS)),
                         ids=[f"seed{sc.seed}" for sc in SCENARIOS])
def test_cl_machine_equals_golden_and_jax_tick_for_tick(scenario_runs, lane):
    golden, jouts, got = scenario_runs
    _check_lane(got, _golden_arrays(golden[lane][1]), lane, "golden")
    _check_lane(got, {k: v[:, lane] for k, v in jouts.items()}, lane, "jax")
    assert len(set(got["state"][:, lane].tolist())) >= 2


def test_cl_scenarios_reach_their_states(scenario_runs):
    """The port's traces show what tests/test_behavior_cl.py asserts of
    the golden ones: hover reached and kept, Z-only then position hold,
    the ramp and assist, the battery flag without a landing, the stale
    landing and the immediate force-disarm."""
    _, _, got = scenario_runs
    st, kind = got["state"], got["cmd_kind"]
    lane = {sc.seed: i for i, sc in enumerate(SCENARIOS)}
    s31 = st[:, lane[31]].tolist()
    k = s31.index(tcl.CL_HOVER)
    assert all(s == tcl.CL_HOVER for s in s31[k + 50:])
    assert {tcl.CMD_Z_YAW, 3} <= set(kind[:, lane[31]].tolist())
    assert tcl.CL_ARMING not in st[:1000, lane[32]].tolist()
    assert tcl.CL_LIFTOFF_ASSIST in st[:1500, lane[33]].tolist()
    assert tcl.CL_LANDING not in st[:, lane[34]].tolist()
    assert (got["kf_flags"][:, lane[34]] & tcl.CL_KF_BATT_LAND).any()
    assert tcl.CL_LANDING in st[:1500, lane[35]].tolist()
    assert got["req_arm"][750, lane[36]] == 0
    assert st[750, lane[36]] == tcl.CL_DISARMING


def _fuzz(n_seeds: int):
    golden, jouts, got = _runs([random_scenario(10_000 + s)
                                for s in range(n_seeds)], FUZZ_TICKS)
    for b, (_, gouts) in enumerate(golden):
        _check_lane(got, _golden_arrays(gouts), b, f"fuzz seed {b} golden")
        _check_lane(got, {k: v[:, b] for k, v in jouts.items()}, b,
                    f"fuzz seed {b} jax")


def test_cl_machine_equals_golden_and_jax_on_fuzzed_schedules():
    _fuzz(FUZZ_FAST)


@pytest.mark.slow
def test_cl_machine_equals_golden_and_jax_on_all_256_fuzzed_schedules():
    _fuzz(256)


def test_cl_state_fields_and_init_equal_jax():
    want = jax.tree_util.tree_map(np.asarray, jcl.behavior_cl_init(3))
    got = tcl.behavior_cl_init(3, "cpu")
    assert tcl.BehaviorClState._fields == jcl.BehaviorClState._fields
    for k, v in want._asdict().items():
        g = getattr(got, k).numpy()
        assert g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    for name in ("CL_WAIT_LINK", "CL_HOVER", "CL_DISARMING", "CMD_Z_YAW",
                 "CL_KF_BATT_EMERG"):
        assert getattr(tcl, name) == getattr(jcl, name), name


def test_cl_init_asks_for_cuda():
    if torch.cuda.is_available():
        assert tcl.behavior_cl_init(2).st.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcl.behavior_cl_init(2)
