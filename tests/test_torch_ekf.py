"""The port's EKF (ops/ekf.py) and fusion replay (replay/fusion.py) against
the JAX package's, on the same seeded numpy inputs, on the CPU.

Tolerance: 1e-5 on states and covariances.  The two packages run the same
float32 operations in the same order, but XLA-CPU contracts a product and
a sum into one fma (a jitted a * b + c equals the fma on every input) and
its float32 sin/cos are not correctly rounded, while the port rounds every
operation on its own and takes the correctly rounded trig; the tracks
differ by about an ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from micro_quad_slam_tpu.ops import ekf as jekf
from micro_quad_slam_tpu.replay import fusion as jfusion
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch.ops import ekf as tekf
from micro_quad_slam_tpu_torch.replay import fusion as tfusion

torch.set_num_threads(2)

ATOL = 1e-5
CFG = JAX_UL.ekf


def _state(B=16, seed=0):
    """A random EKF state: means, and SPD covariances."""
    rng = np.random.default_rng(seed)
    mean = rng.normal(0, 1, (B, 8)).astype(np.float32)
    mean[:, 6] = rng.uniform(-np.pi, np.pi, B)
    a = rng.normal(0, 0.1, (B, 8, 8)).astype(np.float32)
    cov = (a @ a.transpose(0, 2, 1) + 1e-3 * np.eye(8)).astype(np.float32)
    return mean, cov


def _both(mean, cov):
    return (jekf.EkfState(jnp.asarray(mean), jnp.asarray(cov)),
            tekf.EkfState(torch.from_numpy(mean), torch.from_numpy(cov)))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def test_ekf_init_equals_jax():
    j = jekf.ekf_init((3,), 1.5, -2.0, z0=0.4, yaw0=0.3)
    t = tekf.ekf_init((3,), 1.5, -2.0, z0=0.4, yaw0=0.3, device="cpu")
    np.testing.assert_array_equal(t.mean.numpy(), np.asarray(j.mean))
    np.testing.assert_array_equal(t.cov.numpy(), np.asarray(j.cov))


def test_predict_equals_jax():
    mean, cov = _state()
    dt = np.linspace(0.0, 0.2, 16).astype(np.float32)
    sj, st = _both(mean, cov)
    j = jax.jit(lambda s, d: jekf.ekf_predict(s, d, CFG))(sj, jnp.asarray(dt))
    t = tekf.ekf_predict(st, torch.from_numpy(dt), CFG)
    _close(j.mean, t.mean)
    _close(j.cov, t.cov)


@pytest.mark.parametrize("which", ["yaw", "rangefinder", "velocity"])
def test_updates_equal_jax(which):
    mean, cov = _state(seed=1)
    rng = np.random.default_rng(2)
    valid = rng.random(16) < 0.7
    sj, st = _both(mean, cov)
    if which == "velocity":
        z = rng.normal(0, 1, (16, 2)).astype(np.float32)
        j, ji = jax.jit(lambda s, z, v: jekf.ekf_update_velocity(
            s, z, v, np.float32(CFG.r_flow_vel)))(sj, jnp.asarray(z),
                                                   jnp.asarray(valid))
        t, ti = tekf.ekf_update_velocity(st, torch.from_numpy(z),
                                         torch.from_numpy(valid),
                                         CFG.r_flow_vel)
        _close(ji, ti)
    else:
        z = rng.uniform(-4, 4, 16).astype(np.float32)
        fj = {"yaw": jekf.ekf_update_yaw,
              "rangefinder": jekf.ekf_update_rangefinder}[which]
        ft = {"yaw": tekf.ekf_update_yaw,
              "rangefinder": tekf.ekf_update_rangefinder}[which]
        r = CFG.r_yaw if which == "yaw" else CFG.r_rf
        j = jax.jit(lambda s, z, v: fj(s, z, v, np.float32(r)))(
            sj, jnp.asarray(z), jnp.asarray(valid))
        t = ft(st, torch.from_numpy(z), torch.from_numpy(valid), r)
    _close(j.mean, t.mean)
    _close(j.cov, t.cov)
    # gated-off rows are untouched, bit for bit
    np.testing.assert_array_equal(t.mean.numpy()[~valid], mean[~valid])


def test_wrap_pi_equals_jax_within_an_ulp_of_the_input():
    """a - 2 pi floor((a + pi) / 2 pi): XLA-CPU fuses the product and the
    difference into one fma, the port rounds the product first, so they
    differ by up to an ulp of the product (of a)."""
    a = np.concatenate([np.linspace(-20, 20, 4001),
                        [np.pi, -np.pi, 3 * np.pi, 0.0]]).astype(np.float32)
    got = tekf.wrap_pi(torch.from_numpy(a)).numpy()
    want = np.asarray(jax.jit(jekf.wrap_pi)(jnp.asarray(a)))
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(a)))


def test_step_equals_jax_and_gates():
    mean, cov = _state(seed=3)
    rng = np.random.default_rng(4)
    B = 16
    args = [np.full(B, 0.1, np.float32),
            rng.normal(0, 1, B).astype(np.float32),
            rng.normal(0, 1, B).astype(np.float32),
            rng.integers(0, 120, B).astype(np.int32),
            rng.uniform(-0.2, 1.5, B).astype(np.float32),
            rng.uniform(-3, 3, B).astype(np.float32)]
    args[1][:3] = np.nan
    args[4][3:5] = np.nan
    sj, st = _both(mean, cov)
    j, dj = jax.jit(lambda s, *a: jekf.ekf_step(s, *a, CFG))(
        sj, *map(jnp.asarray, args))
    t, dt = tekf.ekf_step(st, *map(torch.from_numpy, args), CFG)
    _close(j.mean, t.mean)
    _close(j.cov, t.cov)
    np.testing.assert_array_equal(dt["flow_used"].numpy(),
                                  np.asarray(dj["flow_used"]))
    assert 0 < int(dt["flow_used"].sum()) < B


def _flights(B=4, T=64):
    logs = [synth_room_scanlog(n_frames=T, seed=s, path="circle",
                               noise_mm=6.0, with_flow=True)
            for s in range(B)]
    fr = [jfusion.fusion_arrays(lg) for lg in logs]
    f = {k: np.stack([a[k] for a in fr]) for k in fr[0]}
    if B > 2:
        f["of_q"][1, 20:30] = 10              # gated-off flow
        f["rf_m"][2, 5] = np.nan
    return f


def _sched_hook_jax():
    def step(c, mean, _f):
        return c + mean[..., 0], {"acc": c + mean[..., 0]}
    return (jnp.zeros(4, jnp.float32), step)


def _sched_hook_torch():
    def step(c, mean, _f):
        return c + mean[..., 0], {"acc": c + mean[..., 0]}
    return (torch.zeros(4), step)


@pytest.mark.parametrize("extra", [False, True])
def test_ekf_replay_batched_equals_jax(extra):
    f = _flights()
    j_st, j_tr = jax.jit(lambda f: jfusion._ekf_replay_batched(
        f, JAX_UL, _sched_hook_jax() if extra else None))(f)
    t_st, t_tr = tfusion._ekf_replay_batched(
        port.frames_to_torch(f, "cpu"), port.UL_PROFILE,
        _sched_hook_torch() if extra else None)
    assert set(t_tr) == set(j_tr)
    for k in t_tr:
        if t_tr[k].dtype == torch.bool:
            np.testing.assert_array_equal(t_tr[k].numpy(), np.asarray(j_tr[k]))
        else:
            _close(j_tr[k], t_tr[k], atol=1e-4 if k == "acc" else ATOL)
    _close(j_st.mean, t_st.mean)
    _close(j_st.cov, t_st.cov)
    assert not t_tr["flow_used"][1, 20:30].any()


def test_fusion_replay_tracks_circle_within_1cm():
    """tests/test_ekf.py's north-star bar on the port: exact flow from the
    simulator, the recomputed track within 1 cm RMSE of the logged path."""
    log = synth_room_scanlog(n_frames=200, path="circle", path_radius_m=1.0,
                             with_flow=True, seed=3)
    frames = tfusion.fusion_arrays(log)
    _, track = tfusion.replay_fusion(port.frames_to_torch(frames, "cpu"),
                                     port.UL_PROFILE)
    rmse = tfusion.pose_rmse(track, frames)
    assert rmse < 0.01, f"pose RMSE {rmse * 100:.2f} cm"
    assert track["flow_used"][1:].all()
    jrmse = jfusion.pose_rmse(jfusion.replay_fusion(frames, JAX_UL)[1], frames)
    assert abs(rmse - jrmse) < 1e-6


def test_fusion_arrays_equal_jax(tmp_path):
    """From the simulator's log, and from the port's scanlog reader against
    the JAX package's."""
    from micro_quad_slam_tpu.formats import scanlog as jscanlog
    from micro_quad_slam_tpu_torch.formats import scanlog as tscanlog

    log = synth_room_scanlog(n_frames=12, path="circle", with_flow=True,
                             seed=1)
    p = str(tmp_path / "f.bin")
    jscanlog.write_scanlog(p, log)
    pairs = [(tfusion.fusion_arrays(log), jfusion.fusion_arrays(log)),
             (tfusion.fusion_arrays(tscanlog.read_scanlog(p)),
              jfusion.fusion_arrays(jscanlog.read_scanlog(p)))]
    for a, b in pairs:
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_replay_fusion_batched_asks_for_cuda():
    """Its inputs come from frames_to_torch, which puts them on the CUDA
    device by default and raises without one."""
    f = _flights(B=1, T=4)
    if torch.cuda.is_available():
        t = port.frames_to_torch(f)
        _, tr = tfusion.replay_fusion_batched(t, port.UL_PROFILE)
        assert tr["x"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.frames_to_torch(f)
