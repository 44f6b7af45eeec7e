"""SE(2) pose-graph optimization by Gauss-Newton in PyTorch (counterpart of
micro_quad_slam_tpu/slam/posegraph.py), batched over flights.

Graph: K keyframe nodes (x, y, theta), E relative-pose edges (odometry
between consecutive keyframes, scan-match anchors, loop closures).  The
residual of edge (i -> j) with measurement z is

    r = [R(th_i)^T (t_j - t_i) - z_t,  wrap(th_j - th_i - z_th)]

Gauss-Newton pins node 0, builds the dense [3K, 3K] normal equations from
the block-sparse Jacobian as the JAX module does (H = (W A)^T A), and
solves them by Cholesky: K is tens of keyframes, so every flight's solve
is one small batched matmul and factorization.

The solve gives the same float32 bits on the CPU and the card, at any
batch size: the normal equations, the factorization and the step run in
float64 and the step is rounded to float32 (the float32 products sum
exactly there, and LAPACK's and cuSOLVER's float64 results round to the
same float32), and the few float32 sums add in a fixed order.

Every function takes a leading flight dimension [B] where the JAX module
uses vmap (PoseGraph fields [B, K, 3], [B, E, 2], ...).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.ops.raycast import (
    _cos_f32, _f, _sin_f32, sqrt_f32)

_PI = _f(np.pi)
_TWO_PI = _f(2 * np.pi)


class PoseGraph(NamedTuple):
    nodes: torch.Tensor      # f32 [B, K, 3] (x, y, theta)
    edges_ij: torch.Tensor   # int64 [B, E, 2] node indices
    edges_z: torch.Tensor    # f32 [B, E, 3] relative measurements
    edges_w: torch.Tensor    # f32 [B, E, 3] per-component information
    edge_mask: torch.Tensor  # bool [B, E]
    # Huber scale per edge (0 = plain quadratic), applied by IRLS on the
    # information-weighted residual norm in every iteration
    edges_huber: torch.Tensor  # f32 [B, E]


def _mod(a: torch.Tensor, m: float) -> torch.Tensor:
    """jnp.mod for a positive float divisor: the exact fmod, moved into
    [0, m)."""
    r = torch.fmod(a, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def _wrap(a):
    return _mod(a + _PI, _TWO_PI) - _PI


def se2_compose(a, b):
    """a (+) b: apply relative pose b in a's frame."""
    c, s = _cos_f32(a[..., 2]), _sin_f32(a[..., 2])
    return torch.stack([
        a[..., 0] + c * b[..., 0] - s * b[..., 1],
        a[..., 1] + s * b[..., 0] + c * b[..., 1],
        _wrap(a[..., 2] + b[..., 2]),
    ], dim=-1)


def se2_relative(a, b):
    """(-)a (+) b: pose of b expressed in a's frame."""
    c, s = _cos_f32(a[..., 2]), _sin_f32(a[..., 2])
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy,
                        _wrap(b[..., 2] - a[..., 2])], dim=-1)


def _gather_nodes(nodes, idx):
    """nodes [B, K, 3], idx [B, E] -> [B, E, 3]."""
    return torch.gather(nodes, 1, idx[..., None].expand(*idx.shape, 3))


def _residuals_and_jacobians(nodes, graph: PoseGraph):
    pi = _gather_nodes(nodes, graph.edges_ij[..., 0])
    pj = _gather_nodes(nodes, graph.edges_ij[..., 1])
    c, s = _cos_f32(pi[..., 2]), _sin_f32(pi[..., 2])
    dx = pj[..., 0] - pi[..., 0]
    dy = pj[..., 1] - pi[..., 1]
    rt = torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)
    r = torch.cat([rt - graph.edges_z[..., :2],
                   _wrap(pj[..., 2] - pi[..., 2]
                         - graph.edges_z[..., 2])[..., None]], dim=-1)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    Ji = torch.stack([
        torch.stack([-c, -s, -s * dx + c * dy], dim=-1),
        torch.stack([s, -c, -c * dx - s * dy], dim=-1),
        torch.stack([zero, zero, -one], dim=-1),
    ], dim=-2)
    Jj = torch.stack([
        torch.stack([c, s, zero], dim=-1),
        torch.stack([-s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return r, Ji, Jj


def _incidence_order(ij, K: int):
    """Where each edge's products sum into the normal equations.  Every
    edge e = (i, j) has 4 incidences, its blocks (i, i), (j, j), (i, j)
    and (j, i) of H, numbered 4e..4e+3.  Returns idx int64 [B, K*K, L]:
    for every block (a, a') of H with a, a' >= 1 (node 0 is pinned), the
    incidences that sum into it in edge order, padded with 4E (no
    incidence)."""
    B, E = ij.shape[:2]
    dev = ij.device
    i, j = ij[..., 0], ij[..., 1]
    tgt = torch.stack([i * K + i, j * K + j, i * K + j, j * K + i],
                      -1).reshape(B, 4 * E)
    live = torch.stack([i > 0, j > 0, (i > 0) & (j > 0), (i > 0) & (j > 0)],
                       -1).reshape(B, 4 * E)
    earlier = torch.ones((4 * E, 4 * E), dtype=torch.bool,
                         device=dev).tril(-1)
    rank = ((tgt[:, :, None] == tgt[:, None, :]) & earlier).sum(-1)
    L = int(torch.where(live, rank, 0).max()) + 1 if 4 * E else 1
    trash = K * K * L
    pos = torch.where(live, tgt * L + rank, torch.full_like(tgt, trash))
    idx = torch.full((B, trash + 1), 4 * E, dtype=torch.int64, device=dev)
    idx.scatter_(1, pos, torch.arange(4 * E, device=dev).expand(B, 4 * E))
    return idx[:, :trash].reshape(B, K * K, L)


def _normal_equations(r, Ji, Jj, wmask, idx):
    """H = (W A)^T A [B, 3K, 3K] and b = (W A)^T r [B, 3K] of the dense
    Jacobian A [3E, 3K] = Si (x) Ji + Sj (x) Jj, in float32 (held in
    float64).  Each entry is summed as a chain of fused multiply-adds over
    A's rows in order, skipping the rows where its product is zero: the
    sum the CPU's float32 matmul makes of these operands
    (tests/test_torch_posegraph.py).  The chain runs here in float64,
    rounded to float32 after every row (the products of float32 are exact
    there), so it gives the same bits on every device and at every batch
    size; a library matmul on the card sums in another order."""
    B, E = r.shape[:2]
    K = int(round(idx.shape[1] ** 0.5))
    Awi = (Ji * wmask[..., None]).double()
    Awj = (Jj * wmask[..., None]).double()
    rhs = r.double()[..., None]

    def prod(aw, jac):
        """Per row c of each edge, the products [B, E, 3 (c), 3 (u), 4 (v)]
        of its Aw row with its A row, the 4th column with r (the right-hand
        side, read from the diagonal blocks)."""
        return aw[..., :, None] * torch.cat([jac.double(), rhs],
                                            -1)[..., None, :]

    M = torch.stack([prod(Awi, Ji), prod(Awj, Jj), prod(Awi, Jj),
                     prod(Awj, Ji)], 2).reshape(B, 4 * E, 3, 3, 4)
    M = torch.cat([M, M.new_zeros((B, 1, 3, 3, 4))], 1)
    bi = torch.arange(B, device=r.device)[:, None]
    acc = M.new_zeros((B, K * K, 3, 4))
    for s in range(idx.shape[2]):
        Ms = M[bi, idx[..., s]]                              # [B, K*K, 3, 3, 4]
        for c in range(3):
            acc = (acc + Ms[:, :, c]).float().double()
    acc = acc.reshape(B, K, K, 3, 4)
    H = acc[..., :3].permute(0, 1, 3, 2, 4).reshape(B, 3 * K, 3 * K)
    b = torch.diagonal(acc[..., 3], dim1=1, dim2=2)          # [B, 3, K]
    return H, b.transpose(1, 2).reshape(B, 3 * K)


def gauss_newton(graph: PoseGraph, iters: int = 10, damping: float = 1e-6):
    """Damped Gauss-Newton with node 0 pinned, the same number of
    iterations for every flight.  Returns (graph with the solved nodes,
    costs f32 [B, iters])."""
    nodes = graph.nodes
    B, K = nodes.shape[:2]
    dev = nodes.device
    wbase = graph.edges_w * graph.edge_mask[..., None].to(torch.float32)
    delta = graph.edges_huber
    idx = _incidence_order(graph.edges_ij, K)
    pin = (torch.arange(3 * K, device=dev) >= 3).to(torch.float64)
    eye = torch.eye(3 * K, dtype=torch.float64, device=dev)
    costs = []
    for _ in range(iters):
        r, Ji, Jj = _residuals_and_jacobians(nodes, graph)
        # IRLS-Huber: a robust edge keeps min(1, delta / ||r||_W) of its
        # information
        wr2 = wbase * r * r
        chi = sqrt_f32(torch.clamp_min(wr2[..., 0] + wr2[..., 1] + wr2[..., 2],
                                       _f(1e-12)))
        scale = torch.where((delta > 0) & (chi > delta), delta / chi,
                            torch.ones_like(chi))
        wmask = wbase * scale[..., None]
        H, b = _normal_equations(r, Ji, Jj, wmask, idx)
        H = H * pin[:, None] * pin[None, :] + torch.diag(1.0 - pin)
        b = b * pin
        H = H + _f(damping) * eye
        L = torch.linalg.cholesky(H)
        y = torch.linalg.solve_triangular(L, -b[..., None], upper=False)
        dx = torch.linalg.solve_triangular(L.transpose(1, 2), y,
                                           upper=True)[..., 0].float()
        nodes = nodes + dx.reshape(B, K, 3)
        nodes = torch.cat([nodes[..., :2], _wrap(nodes[..., 2:])], dim=-1)
        costs.append((r * wmask * r).double().sum(dim=(1, 2)).float())
    return graph._replace(nodes=nodes), torch.stack(costs, dim=1)


def chain_odometry_graph(poses, kf_idx, odo_weight=(100.0, 100.0, 400.0)):
    """Consecutive-keyframe odometry edges from pose tracks [B, T, 3] at
    the keyframe frame indices kf_idx [K]."""
    kf = poses[:, kf_idx]
    B, K = kf.shape[:2]
    dev = poses.device
    z = se2_relative(kf[:, :-1], kf[:, 1:])
    ar = torch.arange(K - 1, device=dev)
    ij = torch.stack([ar, ar + 1], dim=-1).expand(B, K - 1, 2)
    w = torch.tensor([_f(v) for v in odo_weight], dtype=torch.float32,
                     device=dev).expand(B, K - 1, 3)
    return PoseGraph(nodes=kf, edges_ij=ij, edges_z=z, edges_w=w,
                     edge_mask=torch.ones((B, K - 1), dtype=torch.bool,
                                          device=dev),
                     edges_huber=torch.zeros((B, K - 1), dtype=torch.float32,
                                             device=dev))


def add_edges(graph: PoseGraph, ij, z, w, mask=None,
              huber=0.0) -> PoseGraph:
    """Append edges ij [B, E', 2], z [B, E', 3] with information w
    (broadcast to [B, E', 3]), mask [B, E'] (None = all) and Huber delta
    (scalar or [B, E']; 0 = quadratic)."""
    B, E2 = ij.shape[:2]
    dev = graph.nodes.device
    w = torch.as_tensor(w, dtype=torch.float32, device=dev).expand(B, E2, 3)
    m = (torch.ones((B, E2), dtype=torch.bool, device=dev) if mask is None
         else mask)
    h = torch.as_tensor(_f(huber) if isinstance(huber, float) else huber,
                        dtype=torch.float32, device=dev).expand(B, E2)
    return graph._replace(
        edges_ij=torch.cat([graph.edges_ij, ij.to(torch.int64)], dim=1),
        edges_z=torch.cat([graph.edges_z, z], dim=1),
        edges_w=torch.cat([graph.edges_w, w], dim=1),
        edge_mask=torch.cat([graph.edge_mask, m], dim=1),
        edges_huber=torch.cat([graph.edges_huber, h], dim=1))
