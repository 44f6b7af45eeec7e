"""The JAX package's long reference suites run on the port (all `slow`:
Tier-1 runs -m 'not slow'; `python -m pytest --runslow
tests/test_torch_reference_suites.py` runs them).

1. The vision-flow mission (tests/test_simulator.py:145-161): B=4 x
   1,250 ticks with pyramidal LK flow, from the JAX package's start state
   and scan draws (PRNGKey 13 and 5).  States, commands and grids equal,
   the vision quality's minimum equal; poses within VISION_TOL = 1e-3:
   over 1,250 ticks of vision flow the two packages' float paths drift
   apart by up to ~2.3e-4 m (XLA-CPU's fmas and trig; FLOAT_TOL = 1e-4 of
   tests/test_torch_simulator.py was set on 400-tick runs).
2. The UL machine's full suite (tests/test_behavior.py:181-194, 259-299):
   all 11 scripted scenarios and the 256-seed fuzz against the golden
   model, tick for tick, cmd within 2e-5.
3. The swarm under CL_PROFILE (the CLI's `sim --profile cl`): B=4 x 400
   ticks from the JAX start and draws (airborne PRNGKey 7, ground
   PRNGKey 3), under tests/test_torch_simulator.py's tolerances.
4. SLAM pass 1's feedback accuracy A/B (tests/test_slam.py:680-703): both
   formulations beat the odometry's tail error by 30% on the drifty
   circle.
5. The multi-seed SLAM accuracy suite: 5 seeds x 2 paths (fig-8, circle)
   x 2 rooms at 6% flow drift through both packages' slam_replay: each
   package's solved tail error under 0.7x the odometry's on average, and
   the port's per-flight tail error within 1 cm of the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fc_mock import random_scenario, run_scenario
from micro_quad_slam_tpu.models import simulator as JS
from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM as JAX_GEOM
from micro_quad_slam_tpu.replay import fusion as jfusion
from micro_quad_slam_tpu.replay import mapping as jm
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.slam.pipeline import slam_replay as jax_slam
from micro_quad_slam_tpu.utils.config import CL_PROFILE as JAX_CL
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch.models import simulator as S
from micro_quad_slam_tpu_torch.slam import pipeline as sp
from micro_quad_slam_tpu_torch.utils.config import CL_PROFILE, UL_PROFILE
from test_behavior import SCENARIOS as UL_SCENARIOS
from test_slam import _drifty_frames
from test_torch_behavior import INT_KEYS as UL_INT_KEYS
from test_torch_behavior import _golden_arrays, _port_trace, _seq
from test_torch_simulator import ROOM, _assert_run_equal, _np
from test_torch_testdata import FB_FORMS, _formulation, jax_scan_draws

torch.set_num_threads(2)

GEOM = port.DEFAULT_GEOM
VISION_TOL = 1e-3
CMD_ATOL = 2e-5


def _draws(key, n_steps, dt_ms, B):
    return [(torch.from_numpy(n.copy()), torch.from_numpy(u.copy()))
            for n, u in jax_scan_draws(key, n_steps, dt_ms, 100, B)]


# ------------------------------------------------ 1. vision-flow mission

@pytest.mark.slow
@pytest.mark.parametrize("key", [13, 5])
def test_vision_flow_mission_equals_jax(key):
    B, T = 4, 1250
    jworld = JS.make_world(B, room=(-3.0, -3.0, 3.0, 3.0))
    jst = JS.sim_init(B, jax.random.PRNGKey(key), spread_m=0.3)
    jfin, jdiag = _np(jax.jit(lambda st: JS.sim_run(
        st, jworld, T, JAX_UL, vision_flow=True, record=True))(jst))
    st = S.sim_state_from_numpy(_np(jst), "cpu")
    world = S.make_world(B, room=(-3.0, -3.0, 3.0, 3.0), device="cpu")
    fin, diag = S.sim_run(st, world, T, UL_PROFILE, vision_flow=True,
                          record=True, draws=_draws(jst.key, T, 20, B))
    for k in ("state", "cmd_kind", "req_mode", "req_arm", "kf_flags"):
        np.testing.assert_array_equal(diag[k].numpy(), jdiag[k].astype(
            diag[k].numpy().dtype), err_msg=k)
    np.testing.assert_array_equal(fin.mapper.grid.numpy(), jfin.mapper.grid)
    assert int(fin.vis_q.min()) == int(jfin.vis_q.min()) > 100
    for k in ("x", "y", "yaw", "alt"):
        np.testing.assert_allclose(getattr(fin, k).numpy(), getattr(jfin, k),
                                   rtol=0, atol=VISION_TOL, err_msg=k)
    np.testing.assert_allclose(diag["pose_err"].numpy(), jdiag["pose_err"],
                               rtol=0, atol=VISION_TOL)
    states = set(np.unique(jdiag["state"]).tolist())
    assert {5, 6} <= states                       # HOVER and EXPLORE flown


# ----------------------------------------------------- 2. the UL machine

def _check_ul(got: dict, gouts, lane: int, name: str) -> None:
    want = _golden_arrays(gouts)
    for k in UL_INT_KEYS:
        np.testing.assert_array_equal(got[k][:, lane], want[k],
                                      err_msg=f"{name} {k}")
    np.testing.assert_allclose(got["cmd"][:, lane], want["cmd"], rtol=0,
                               atol=CMD_ATOL, err_msg=name)
    np.testing.assert_array_equal(np.isnan(got["req_takeoff"][:, lane]),
                                  np.isnan(want["req_takeoff"]),
                                  err_msg=name)


def _ul_batch(runs) -> dict:
    seqs = [_seq(telems) for telems, _ in runs]
    return _port_trace({k: torch.cat([s[k] for s in seqs], dim=1)
                        for k in seqs[0]}, len(runs))


@pytest.mark.slow
def test_ul_machine_all_scenarios_equal_golden():
    runs = [run_scenario(sc, n_ticks=1100) for sc in UL_SCENARIOS]
    got = _ul_batch(runs)
    for lane, (sc, (_, gouts)) in enumerate(zip(UL_SCENARIOS, runs)):
        _check_ul(got, gouts, lane, f"seed {sc.seed}")


@pytest.mark.slow
def test_ul_machine_256_fuzzed_schedules_equal_golden():
    runs = [run_scenario(random_scenario(s), n_ticks=700)
            for s in range(256)]
    got = _ul_batch(runs)
    for lane, (_, gouts) in enumerate(runs):
        _check_ul(got, gouts, lane, f"fuzz seed {lane}")


# ----------------------------------------------- 3. the swarm, CL profile

@pytest.mark.slow
@pytest.mark.parametrize("key,airborne", [(7, True), (3, False)])
def test_swarm_under_cl_profile_equals_jax(key, airborne):
    B, T, DT = 4, 400, 20
    jworld = JS.make_world(B, **ROOM)
    jst = JS.sim_init(B, jax.random.PRNGKey(key), spread_m=0.5,
                      airborne=airborne)
    jfin, jdiag = _np(jax.jit(lambda st: JS.sim_run(
        st, jworld, T, JAX_CL, dt_ms=DT, record=True))(jst))
    st = S.sim_state_from_numpy(_np(jst), "cpu")
    world = S.make_world(B, **ROOM, device="cpu")
    fin, diag = S.sim_run(st, world, T, CL_PROFILE, dt_ms=DT, record=True,
                          draws=_draws(jst.key, T, DT, B))
    _assert_run_equal(fin, diag, jfin, jdiag)


# ------------------------------------------- 4. feedback accuracy A/B

@pytest.mark.slow
@pytest.mark.parametrize("form", [None] + sorted(FB_FORMS))
def test_slam_feedback_ab_holds_accuracy(form):
    frames, log = _drifty_frames()
    cfg = UL_PROFILE if form is None else _formulation(UL_PROFILE, form)
    res = sp.slam_replay(port.frames_to_torch(frames, "cpu"), cfg, GEOM, 10,
                         8)
    truth = np.stack([log.x_m, log.y_m], -1)
    odo_err = np.hypot(*(res.odo_track[0, :, :2].numpy() - truth).T)
    slam_err = np.hypot(*(res.track[0, :, :2].numpy() - truth).T)
    assert slam_err[-20:].mean() < odo_err[-20:].mean() * 0.7, (
        form, odo_err[-20:].mean(), slam_err[-20:].mean())


# -------------------------------------- 5. multi-seed accuracy suite

ROOMS = {"square": (-2.5, -2.5, 2.5, 2.5), "wide": (-3.0, -2.0, 3.0, 2.0)}
SEEDS = range(5)


def _flights(path: str, room) -> tuple:
    logs = []
    for seed in SEEDS:
        log = synth_room_scanlog(n_frames=160, path=path, path_radius_m=1.4
                                 if path == "fig8" else 1.0, room=room,
                                 with_flow=True, seed=seed)
        log.of_rate_x[:] *= 1.06
        log.of_rate_y[:] *= 1.06
        logs.append(log)
    f = [{**jm.scanlog_to_arrays(lg), **jfusion.fusion_arrays(lg)}
         for lg in logs]
    return {k: np.stack([d[k] for d in f]) for k in f[0]}, logs


def _tail(track, logs) -> np.ndarray:
    """Mean position error of each flight's last 20 frames."""
    truth = np.stack([np.stack([lg.x_m, lg.y_m], -1) for lg in logs])
    d = np.asarray(track)[..., :2] - truth                    # [B, T, 2]
    return np.hypot(d[..., 0], d[..., 1])[:, -20:].mean(1)


@pytest.mark.slow
@pytest.mark.parametrize("room", sorted(ROOMS))
@pytest.mark.parametrize("path", ["fig8", "circle"])
def test_multi_seed_accuracy_both_packages(path, room):
    frames, logs = _flights(path, ROOMS[room])
    jres = jax_slam({k: jnp.asarray(v) for k, v in frames.items()}, JAX_UL,
                    JAX_GEOM, 10, 8)
    res = sp.slam_replay(port.frames_to_torch(frames, "cpu"), UL_PROFILE,
                         GEOM, 10, 8)
    odo = _tail(res.odo_track.numpy(), logs)
    np.testing.assert_allclose(odo, _tail(jres.odo_track, logs), rtol=0,
                               atol=1e-4)
    tail_port = _tail(res.track.numpy(), logs)
    tail_jax = _tail(jres.track, logs)
    for name, tail in (("port", tail_port), ("jax", tail_jax)):
        assert tail.mean() < 0.7 * odo.mean(), (name, tail, odo)
    assert np.abs(tail_port - tail_jax).max() < 0.01, (tail_port, tail_jax)
