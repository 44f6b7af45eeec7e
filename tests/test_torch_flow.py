"""PyTorch port, ops/flow.py: pyramidal LK optical flow, the camera
renderer and the rate conversions against the JAX package on
tests/test_flow.py's cases, and the shift-recovery properties.

Tolerances: the JAX module warps with one-hot banded matmuls at HIGHEST
precision, the port with a two-tap gather (the same taps and weights);
its sums over the frame run in another order.  The recovered shifts agree
within SHIFT_TOL = 1e-3 px and the quality within 0.5 of 255.  The
analytic ground uses the correctly rounded float32 trig where XLA-CPU's
is off by an ulp on some angles: rendered pixels (values ~100 +/- 60)
agree within 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_quad_slam_tpu.models import simulator as JS
from micro_quad_slam_tpu.ops import flow as jf
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
from micro_quad_slam_tpu_torch.models import behavior as tb
from micro_quad_slam_tpu_torch.models import simulator as S
from micro_quad_slam_tpu_torch.ops import flow as tf
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE

torch.set_num_threads(2)

SHIFT_TOL = 1e-3
Q_TOL = 0.5


def _texture(seed=0, n=256):
    """tests/test_flow.py's smooth random texture."""
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 1, (n, n))
    k = np.ones((5, 5)) / 25.0
    from numpy.lib.stride_tricks import sliding_window_view
    for _ in range(2):
        pad = np.pad(t, 2, mode="reflect")
        t = (sliding_window_view(pad, (5, 5)) * k).sum(axis=(-1, -2))
    return (100.0 + 40.0 * t).astype(np.float32)


def _patches(tex, shifts, cx=128.0, cy=128.0):
    """(prev, curr) [N, 64, 64] numpy frames from both renderers, checked
    equal to each other."""
    tj, tt = jnp.asarray(tex), torch.from_numpy(tex)
    prev, curr = [], []
    for dx, dy in shifts:
        for out, c in ((prev, (cx, cy)), (curr, (cx + dx, cy + dy))):
            want = np.asarray(jf.render_ground_patch(tj, c[0], c[1], 64))
            got = tf.render_ground_patch(tt, c[0], c[1], 64).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
            out.append(want)
    return np.stack(prev), np.stack(curr)


def _check_flow(got, want):
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=SHIFT_TOL)
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]),
                               rtol=0, atol=Q_TOL)


@pytest.mark.parametrize("shift", [(0.0, 0.0), (0.6, -0.4), (2.3, 1.1),
                                   (-5.7, 3.9)])
def test_lk_recovers_shift_like_jax(shift):
    prev, curr = _patches(_texture(), [shift])
    got = tf.lk_flow(torch.from_numpy(prev[0]), torch.from_numpy(curr[0]))
    assert abs(float(got.dx_px) - shift[0]) < 0.1, float(got.dx_px)
    assert abs(float(got.dy_px) - shift[1]) < 0.1, float(got.dy_px)
    assert float(got.quality) > 100
    _check_flow([v.numpy() for v in got],
                jax.jit(jf.lk_flow)(prev[0], curr[0]))


def test_lk_batched_like_jax():
    shifts = [(1.5, -0.5), (-2.0, 2.0), (0.0, 4.0)]
    prev, curr = _patches(_texture(1), shifts)
    got = tf.lk_flow_batched(torch.from_numpy(prev), torch.from_numpy(curr))
    for i, s in enumerate(shifts):
        assert abs(float(got.dx_px[i]) - s[0]) < 0.12
        assert abs(float(got.dy_px[i]) - s[1]) < 0.12
    _check_flow([v.numpy() for v in got],
                jax.jit(jf.lk_flow_batched)(prev, curr))
    # each lane of the batch is its own single-pair flow
    one = tf.lk_flow(torch.from_numpy(prev[1]), torch.from_numpy(curr[1]))
    assert float(one.dx_px) == float(got.dx_px[1])


def test_lk_textureless_low_quality():
    a = torch.full((64, 64), 50.0)
    res = tf.lk_flow(a, a.clone())
    assert float(res.quality) < 10
    assert float(res.dx_px) == 0.0 and float(res.dy_px) == 0.0


def test_flow_velocity_chain_like_jax():
    v, h, f, dt = 0.35, 0.5, 120.0, 1.0 / 30.0
    px = v / h * f * dt
    rx, ry = tf.flow_to_rates(torch.tensor(px), torch.tensor(0.0), dt, f)
    vx, vy = tf.rates_to_velocity(rx, ry, torch.tensor(h))
    assert abs(float(vx) - v) < 1e-5 and abs(float(vy)) < 1e-6
    jrx, jry = jf.flow_to_rates(jnp.float32(px), jnp.float32(0.0), dt, f)
    assert float(rx) == float(jrx) and float(ry) == float(jry)


def test_lk_end_to_end_velocity():
    tex = _texture(2)
    h, f, dt = 0.5, 100.0, 0.05
    v_true = (0.3, -0.2)
    px = (v_true[0] / h * f * dt, v_true[1] / h * f * dt)
    prev, curr = _patches(tex, [px], 100.0, 140.0)
    res = tf.lk_flow(torch.from_numpy(prev[0]), torch.from_numpy(curr[0]))
    rx, ry = tf.flow_to_rates(res.dx_px, res.dy_px, dt, f)
    vx, vy = tf.rates_to_velocity(rx, ry, torch.tensor(h))
    assert abs(float(vx) - v_true[0]) < 0.02
    assert abs(float(vy) - v_true[1]) < 0.02


def test_render_camera_frame_like_jax():
    rng = np.random.default_rng(6)
    n = 6
    x, y = (rng.uniform(-3, 3, n).astype(np.float32) for _ in range(2))
    alt = rng.uniform(0.05, 1.5, n).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    want = jax.jit(jax.vmap(lambda *a: jf.render_camera_frame(
        *a, S.CAM_SIZE, S.CAM_FOCAL)))(x, y, alt, yaw)
    got = tf.render_camera_frame(*map(torch.from_numpy, (x, y, alt, yaw)),
                                 S.CAM_SIZE, S.CAM_FOCAL)
    assert got.shape == (n, S.CAM_SIZE, S.CAM_SIZE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)
    assert float(got.std()) > 10


def test_vision_flow_sim_step_like_jax():
    """sim_step's vision-flow branch: 3 flow frames (at 100 ms) of a
    moving airborne swarm, from the same JAX state, give the JAX
    package's vision rates and qualities within the tolerances above."""
    B, dt = 2, 20
    world = JS.make_world(B, room=(-3.5, -3.5, 3.5, 3.5))
    st = JS.sim_init(B, jax.random.PRNGKey(1), spread_m=0.5, airborne=True)
    st = st._replace(vx=jnp.float32([0.3, -0.2]), vy=jnp.float32([0.1, 0.2]))
    jst = st
    tst = S.sim_state_from_numpy(jax.tree_util.tree_map(np.asarray, st),
                                 "cpu")
    tworld = S.make_world(B, room=(-3.5, -3.5, 3.5, 3.5), device="cpu")
    step = jax.jit(lambda s: JS.sim_step(s, world, JAX_UL, dt_ms=dt,
                                         noise_mm=0.0, dropout_p=0.0,
                                         vision_flow=True))
    for _ in range(15):
        jst, _ = step(jst)
        tst, _ = S.sim_step(tst, tworld, UL_PROFILE, dt_ms=dt, noise_mm=0.0,
                            dropout_p=0.0, vision_flow=True)
    assert tst.cam_valid and bool(jst.cam_valid)
    np.testing.assert_allclose(tst.cam_prev.numpy(), np.asarray(jst.cam_prev),
                               rtol=0, atol=1e-2)
    for k, tol in (("vis_rate_x", 0.01), ("vis_rate_y", 0.01),
                   ("vis_q", 1)):
        np.testing.assert_allclose(getattr(tst, k).numpy(),
                                   np.asarray(getattr(jst, k)), rtol=0,
                                   atol=tol, err_msg=k)
    assert int(tst.vis_q.min()) > 100
    assert (tst.beh.st == tb.ST_EXPLORE).all()
