"""The port's SE(2) pose graph (slam/posegraph.py) against the JAX
package's, on the same seeded numpy inputs, on the CPU, and against the
bars of tests/test_slam.py's Gauss-Newton cases.

Tolerance: 1e-4 m and rad on solved nodes, 1e-5 on SE(2) compositions.
The port batches flights where the JAX package vmaps; its normal
equations are the (W A)^T A product in float32, summed as the CPU's
float32 matmul sums it, and it factors them in float64 where XLA factors
in float32.  Its solve gives the same bits at every batch size (and on
the card, tests/test_torch_kernel.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from micro_quad_slam_tpu.slam import posegraph as jpg
from micro_quad_slam_tpu_torch.slam import posegraph as tpg

torch.set_num_threads(2)

F32 = np.float32


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-5, 5, (n, 3)).astype(F32)
    p[:, 2] = rng.uniform(-7, 7, n)
    return p


@pytest.mark.parametrize("fn", ["se2_compose", "se2_relative"])
def test_se2_equals_jax(fn):
    a, b = _poses(500, 0), _poses(500, 1)
    want = np.asarray(jax.jit(getattr(jpg, fn))(jnp.asarray(a),
                                                jnp.asarray(b)))
    got = getattr(tpg, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_se2_roundtrip():
    a = torch.tensor([1.0, 2.0, 0.7])
    b = torch.tensor([-0.5, 3.0, -1.2])
    np.testing.assert_allclose(tpg.se2_compose(a, tpg.se2_relative(a, b)),
                               b, atol=1e-5)


def test_wrap_equals_jax_bit_for_bit():
    a = np.concatenate([np.linspace(-30, 30, 6001),
                        [np.pi, -np.pi, 2 * np.pi, 0.0, -0.0]]).astype(F32)
    np.testing.assert_array_equal(
        tpg._wrap(torch.from_numpy(a)).numpy(),
        np.asarray(jax.jit(jpg._wrap)(jnp.asarray(a))))


def _chain(K, seed, noise=0.15):
    """tests/test_slam.py:35-62: a square-ish loop, exact odometry, noisy
    initial nodes."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((K, 3), F32)
    step = np.asarray([0.5, 0.0, np.pi / 6], F32)
    for k in range(1, K):
        truth[k] = np.asarray(jpg.se2_compose(jnp.asarray(truth[k - 1]),
                                              jnp.asarray(step)))
    noisy = truth + rng.normal(0, noise, truth.shape).astype(F32)
    noisy[:, 2] += rng.normal(0, 0.1, K).astype(F32)
    noisy[0] = truth[0]
    z = np.asarray(jpg.se2_relative(jnp.asarray(truth[:-1]),
                                    jnp.asarray(truth[1:])))
    return truth, noisy, z


def _graphs(nodes, ij, z, w, mask, huber):
    """The same graph for both packages (the port's with a batch of 1)."""
    j = jpg.PoseGraph(jnp.asarray(nodes), jnp.asarray(ij, jnp.int32),
                      jnp.asarray(z), jnp.asarray(w), jnp.asarray(mask),
                      jnp.asarray(huber))
    t = tpg.PoseGraph(*(torch.from_numpy(np.array(a))[None] for a in
                        (nodes, np.asarray(ij, np.int64), z, w, mask, huber)))
    return j, t


def _solve_both(j, t, iters):
    gj, cj = jax.jit(lambda g: jpg.gauss_newton(g, iters=iters))(j)
    gt, ct = tpg.gauss_newton(t, iters=iters)
    return np.asarray(gj.nodes), np.asarray(cj), gt.nodes[0].numpy(), \
        ct[0].numpy()


def test_gauss_newton_recovers_noisy_chain_as_jax():
    K = 12
    truth, noisy, z = _chain(K, 0)
    ij = np.stack([np.arange(K - 1), np.arange(1, K)], -1)
    j, t = _graphs(noisy, ij, z, np.full((K - 1, 3), 10.0, F32),
                   np.ones(K - 1, bool), np.zeros(K - 1, F32))
    nj, cj, nt, ct = _solve_both(j, t, 10)
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct, cj, rtol=1e-3, atol=1e-6)
    # tests/test_slam.py's bars, on the port
    assert np.abs(nt[:, :2] - truth[:, :2]).max() < 1e-3
    assert ct[-1] < ct[0] * 1e-4


@pytest.mark.parametrize("huber", [0.0, 1.0])
def test_gauss_newton_loop_closure_as_jax(huber):
    """tests/test_slam.py:65-87: drifting odometry and one loop-closure
    edge; with huber > 0 a wrong second closure is down-weighted by IRLS."""
    K = 10
    truth = np.zeros((K, 3), F32)
    truth[:, 0] = np.arange(K) * 0.5
    noisy = truth.copy()
    noisy[:, 1] += np.cumsum(np.full(K, 0.04), 0).astype(F32)
    z = np.asarray(jpg.se2_relative(jnp.asarray(noisy[:-1]),
                                    jnp.asarray(noisy[1:])))
    lc = np.asarray(jpg.se2_relative(jnp.asarray(truth[0]),
                                     jnp.asarray(truth[K - 1])))
    bad = lc + np.asarray([0.0, 0.8, 0.2], F32)      # an outlier closure
    ij = np.concatenate([np.stack([np.arange(K - 1), np.arange(1, K)], -1),
                         [[0, K - 1], [0, K - 1], [2, 5]]])
    zz = np.concatenate([z, lc[None], bad[None], z[2:3]])
    w = np.concatenate([np.full((K - 1, 3), 10.0, F32),
                        np.tile(np.asarray([200, 200, 800], F32), (2, 1)),
                        np.full((1, 3), 10.0, F32)])
    mask = np.ones(K + 2, bool)
    mask[-1] = False                                  # a padded edge
    hub = np.zeros(K + 2, F32)
    hub[K - 1:K + 1] = huber
    j, t = _graphs(noisy, ij, zz, w, mask, hub)
    nj, cj, nt, ct = _solve_both(j, t, 10)
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct, cj, rtol=1e-3, atol=1e-5)
    assert np.array_equal(nt[0], noisy[0])            # node 0 pinned


def test_chain_and_add_edges_equal_jax():
    poses = _poses(40, 3)
    kf = np.arange(0, 40, 10)
    gj = jpg.chain_odometry_graph(jnp.asarray(poses), jnp.asarray(kf))
    gj = jpg.add_edges(gj, [[0, 2], [1, 3]], np.ones((2, 3), F32), 5.0,
                       mask=jnp.asarray([True, False]), huber=0.5)
    gt = tpg.chain_odometry_graph(torch.from_numpy(poses)[None],
                                  torch.from_numpy(kf))
    gt = tpg.add_edges(gt, torch.tensor([[[0, 2], [1, 3]]]),
                       torch.ones((1, 2, 3)), 5.0,
                       mask=torch.tensor([[True, False]]), huber=0.5)
    for name in jpg.PoseGraph._fields:
        a, b = np.asarray(getattr(gj, name)), getattr(gt, name)[0].numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=name)


def test_gauss_newton_refuses_tf32():
    """The solve once refused reduced-precision float32 matmuls; it now
    runs in float64, so the setting cannot reach it: the same bits under
    'high' as under 'highest'."""
    _, noisy, z = _chain(4, 1)
    _, t = _graphs(noisy, np.stack([np.arange(3), np.arange(1, 4)], -1), z,
                   np.ones((3, 3), F32), np.ones(3, bool), np.zeros(3, F32))
    want = tpg.gauss_newton(t, iters=3)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = tpg.gauss_newton(t, iters=3)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got[0].nodes, want[0].nodes)
    assert torch.equal(got[1], want[1])


def _random_graphs(B, K, n_loop, seed):
    """B flights of K nodes: an odometry chain, anchors to node 0 and
    n_loop random edges; a fifth of the edges padded (every self-edge
    among them), half of them Huber."""
    rng = np.random.default_rng(seed)
    truth = np.cumsum(rng.normal(0, 0.5, (B, K, 3)), 1).astype(F32)
    nodes = truth + rng.normal(0, 0.1, truth.shape).astype(F32)
    ar = np.arange(1, K)
    ij = np.concatenate([
        np.broadcast_to(np.stack([ar - 1, ar], -1), (B, K - 1, 2)),
        np.broadcast_to(np.stack([0 * ar, ar], -1), (B, K - 1, 2)),
        rng.integers(0, K, (B, n_loop, 2))], 1)
    E = ij.shape[1]
    gi = np.take_along_axis(truth, ij[..., :1], 1)
    gj = np.take_along_axis(truth, ij[..., 1:], 1)
    z = np.asarray(jpg.se2_relative(jnp.asarray(gi), jnp.asarray(gj)))
    z = z + rng.normal(0, 0.02, z.shape).astype(F32)
    mask = (rng.random((B, E)) > 0.2) & (ij[..., 0] != ij[..., 1])
    return tpg.PoseGraph(
        torch.from_numpy(nodes), torch.from_numpy(ij.astype(np.int64)),
        torch.from_numpy(z), torch.from_numpy(
            rng.uniform(1, 400, (B, E, 3)).astype(F32)),
        torch.from_numpy(mask), torch.from_numpy(
            np.where(rng.random((B, E)) > 0.5, 0.5, 0.0).astype(F32)))


@pytest.mark.parametrize("K,n_loop,seed", [(5, 4, 0), (12, 20, 1),
                                           (26, 52, 2)])
def test_normal_equations_sum_as_the_cpu_matmul(K, n_loop, seed):
    """The chained normal equations equal torch's float32 CPU matmul of
    the dense Jacobian, (W A)^T A and (W A)^T r, bit for bit on every
    entry of the unpinned nodes."""
    g = _random_graphs(3, K, n_loop, seed)
    r, Ji, Jj = tpg._residuals_and_jacobians(g.nodes, g)
    wmask = g.edges_w * g.edge_mask[..., None].to(torch.float32)
    H, b = tpg._normal_equations(r, Ji, Jj, wmask,
                                 tpg._incidence_order(g.edges_ij, K))
    B, E = r.shape[:2]
    ks = torch.arange(K)
    Si = (g.edges_ij[..., 0, None] == ks).to(torch.float32)
    Sj = (g.edges_ij[..., 1, None] == ks).to(torch.float32)
    A = (Si[:, :, None, :, None] * Ji[:, :, :, None, :]
         + Sj[:, :, None, :, None] * Jj[:, :, :, None, :]
         ).reshape(B, E * 3, K * 3)
    AwT = (A * wmask.reshape(B, E * 3)[..., None]).transpose(1, 2)
    live = torch.arange(3 * K) >= 3
    assert torch.equal(H.float()[:, live][:, :, live],
                       torch.matmul(AwT, A)[:, live][:, :, live])
    assert torch.equal(b.float()[:, live],
                       torch.matmul(AwT, r.reshape(B, E * 3, 1))[:, live, 0])


def test_gauss_newton_does_not_depend_on_batch_size():
    """Six flights solved together, and each alone: the same bits."""
    g = _random_graphs(6, 12, 20, 3)
    nodes, costs = tpg.gauss_newton(g, iters=5)
    for f in range(6):
        one, c1 = tpg.gauss_newton(tpg.PoseGraph(*(a[f:f + 1] for a in g)),
                                   iters=5)
        assert torch.equal(one.nodes[0], nodes.nodes[f]), f
        assert torch.equal(c1[0], costs[f]), f
