"""PyTorch port, models/behavior.py: the UL flight state machine against
the numpy golden model (micro_quad_slam_tpu/golden/behavior.py) and the
JAX machine, tick for tick, on tests/fc_mock.py's scenarios (the default
ones of tests/test_behavior.py: seeds 11, 14, 15, 21).

Integer and boolean outputs are held equal; `cmd` within 2e-5, the JAX
test's tolerance against the golden model (float32 ramp and yaw-rate
arithmetic)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fc_mock import Scenario, run_scenario
from micro_quad_slam_tpu.models import behavior as jb
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.models import behavior as tb
from micro_quad_slam_tpu_torch.models import behavior_cl as bcl
from micro_quad_slam_tpu_torch.utils import obs
from micro_quad_slam_tpu_torch.utils.config import CL_PROFILE, UL_PROFILE
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


def _flags_off(cfg):
    return dataclasses.replace(
        cfg, behavior=dataclasses.replace(cfg.behavior,
                                          explore_enabled=False),
        battery=dataclasses.replace(cfg.battery, land_actions_enabled=False))


def _hover_only(cfg):
    return dataclasses.replace(cfg, behavior=dataclasses.replace(
        cfg.behavior, hover_test_only=True))


@pytest.mark.parametrize("make", [lambda: UL_PROFILE, lambda: CL_PROFILE,
                                  lambda: _flags_off(UL_PROFILE),
                                  lambda: _hover_only(UL_PROFILE)],
                         ids=["ul", "cl", "flags_off", "hover_test_only"])
def test_kernel_config_packs_each_value_as_plain_rounds_it(make):
    """The machine kernel's configuration (behavior.kernel_config): each
    float the `_f` of its field, the two derived thresholds rounded as the
    plain path subtracts them in float32, the ints as they are, and the
    plain path's two Python branches as flags."""
    cfg = make()
    bh, bt, g = cfg.behavior, cfg.battery, cfg.gates
    floats, ints = tb.kernel_config(cfg)
    derived = {
        "ceil_release_m": tb._f(np.float32(g.ceil_m)
                                - np.float32(g.ceil_release_margin_m)),
        "filt_alpha": tb._f(cfg.tof.filt_alpha),
        "filt_keep": tb._f(np.float32(1.0) - np.float32(cfg.tof.filt_alpha)),
        "takeoff_at_alt_m": tb._f(np.float32(bh.takeoff_target_m)
                                  - np.float32(bh.takeoff_exit_margin_m))}
    for name, v in floats.items():
        if name in derived:
            want = derived[name]
        else:
            group = next(x for x in (bh, bt, g) if hasattr(x, name))
            want = tb._f(getattr(group, name))
        assert v == want and np.float32(v) == v, name
    flags = {"land_actions_enabled": int(bt.land_actions_enabled),
             "explore_gate": int(bh.explore_enabled
                                 and not bh.hover_test_only)}
    for name, v in ints.items():
        group = next((x for x in (bh, bt, g) if hasattr(x, name)), None)
        want = flags[name] if name in flags else getattr(group, name)
        assert v == want and isinstance(v, int), name
    assert len(floats) == 32 and len(ints) == 19


@pytest.mark.parametrize("make", [lambda: CL_PROFILE, lambda: UL_PROFILE],
                         ids=["cl", "ul"])
def test_kernel_config_cl_packs_each_value_as_plain_rounds_it(make):
    """The clean machine kernel's configuration
    (behavior_cl.kernel_config_cl): each float the `_f` of its field, the
    derived ones rounded as behavior_step_cl_plain computes them in
    float32 (the hover target's NED z, the takeoff inference's motor
    threshold, the two thresholds it subtracts), the ints as they are."""
    cfg = make()
    bh, bt, g = cfg.behavior, cfg.battery, cfg.gates
    f32 = np.float32
    ceil = f32(g.ceil_m)
    floats, ints = bcl.kernel_config_cl(cfg)
    derived = {
        "ceil_release_m": tb._f(ceil - f32(g.ceil_release_margin_m)),
        "filt_alpha": tb._f(cfg.tof.filt_alpha),
        "filt_keep": tb._f(f32(1.0) - f32(cfg.tof.filt_alpha)),
        "hover_z": tb._f(-np.minimum(f32(bh.hover_target_m),
                                     np.maximum(ceil - f32(0.05),
                                                f32(0.10)))),
        "takeoff_inferred_us": tb._f(f32(bh.takeoff_mot_start_us)
                                     + f32(150)),
        "takeoff_at_alt_m": tb._f(f32(bh.takeoff_target_m)
                                  - f32(bh.takeoff_exit_margin_m))}
    for name, v in floats.items():
        if name in derived:
            want = derived[name]
        else:
            group = next(x for x in (bh, bt, g) if hasattr(x, name))
            want = tb._f(getattr(group, name))
        assert v == want and np.float32(v) == v, name
    for name, v in ints.items():
        group = next(x for x in (bh, bt, g) if hasattr(x, name))
        assert v == getattr(group, name) and isinstance(v, int), name
    assert len(floats) == 23 and len(ints) == 10


def test_behavior_step_cl_on_cpu_tensors_runs_the_plain_path():
    """On CPU tensors behavior_step_cl is behavior_step_cl_plain: no launch
    of the clean machine's kernel and the same state and outputs, tick for
    tick, over the first 200 ticks of the committed scenarios (arming,
    the ramp, Z+yaw and the position hold), whose Z+yaw and hold commands
    carry the kernel configuration's hover_z."""
    seq = testdata.cl_scenarios(15, "cpu")
    hover_z = bcl.kernel_config_cl(CL_PROFILE)[0]["hover_z"]
    got = want = bcl.behavior_cl_init(15, "cpu")
    before = obs.counters().get("launches.behavior_step_cl", 0)
    kinds = set()
    for i in range(200):
        tel = {k: v[i] for k, v in seq.items()}
        got, out = bcl.behavior_step_cl(got, tel, CL_PROFILE)
        want, ref = bcl.behavior_step_cl_plain(want, tel, CL_PROFILE)
        for a, b in zip(list(got) + list(out.values()),
                        list(want) + list(ref.values())):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        assert list(out) == list(ref)
        kind = out["cmd_kind"]
        kinds |= set(kind.tolist())
        assert (out["cmd"][kind == bcl.CMD_Z_YAW, 0] == hover_z).all()
        assert (out["cmd"][kind == tb.CMD_POS_YAW, 2] == hover_z).all()
    assert obs.counters().get("launches.behavior_step_cl", 0) == before
    assert {bcl.CMD_Z_YAW, tb.CMD_POS_YAW, tb.CMD_ATT_THRUST} <= kinds


def _cl_operands(fault: str):
    """A clean tick's operands on the CPU (the committed scenarios' first
    tick, 3 quads) with one fault: none ("cpu"), an int64 clock, a
    rangefinder of the wrong length, a [B] tof_min, a float32 state."""
    tel = {k: v[0] for k, v in testdata.cl_scenarios(3, "cpu").items()}
    state = bcl.behavior_cl_init(3, "cpu")
    if fault == "dtype":
        tel["t_ms"] = tel["t_ms"].to(torch.int64)
    elif fault == "shape":
        tel["rf_m"] = torch.zeros(4)
    elif fault == "tof_min":
        tel["tof_min"] = tel["tof_min"][:, 0]
    elif fault == "state_dtype":
        state = state._replace(st=state.st.float())
    return state, tel


@pytest.mark.parametrize("fault, match", [
    ("cpu", "CUDA device"), ("dtype", "t_ms must be torch.int32"),
    ("shape", r"rf_m must have shape \(3,\)"),
    ("tof_min", r"tof_min must have shape \(3, 4\)"),
    ("state_dtype", "st must be torch.int32")])
def test_behavior_step_cl_kernel_refuses_what_it_does_not_take(fault, match):
    """The clean machine's kernel wrapper raises ValueError, before it
    launches anything, on CPU tensors and on an operand of another dtype
    or shape; the health bit fields may be int64 (the committed
    telemetry's are)."""
    state, tel = _cl_operands(fault)
    assert tel["sys_enabled"].dtype == torch.int64
    before = obs.counters().get("launches.behavior_step_cl", 0)
    with pytest.raises(ValueError, match=match):
        bcl.behavior_step_cl_kernel(state, tel, CL_PROFILE)
    assert obs.counters().get("launches.behavior_step_cl", 0) == before


def test_behavior_step_on_cpu_tensors_runs_the_plain_path(runs):
    """On CPU tensors behavior_step is behavior_step_plain: no launch of
    the machine kernel, the same outputs; the kernel's wrapper refuses CPU
    operands before it launches anything."""
    golden, _, _ = runs
    seq = _seq(golden[15][0])
    tel = {k: v[400] for k, v in seq.items()}
    state = tb.behavior_init(1, "cpu")
    before = obs.counters().get("launches.behavior_step", 0)
    got = tb.behavior_step(state, tel, UL_PROFILE)
    want = tb.behavior_step_plain(state, tel, UL_PROFILE)
    assert obs.counters().get("launches.behavior_step", 0) == before

    def same(a, b):
        if a.is_floating_point():
            a, b = a.nan_to_num(7.0), b.nan_to_num(7.0)
        return a.dtype == b.dtype and torch.equal(a, b)

    assert all(same(a, b) for a, b in zip(got[0], want[0]))
    assert list(got[1]) == list(want[1])
    assert all(same(got[1][k], want[1][k]) for k in want[1])
    with pytest.raises(ValueError, match="CUDA"):
        tb.behavior_step_kernel(state, tel, UL_PROFILE)
