"""SE(2) pose-graph optimization by Gauss-Newton in PyTorch (counterpart of
micro_quad_slam_tpu/slam/posegraph.py), batched over flights.

Graph: K keyframe nodes (x, y, theta), E relative-pose edges (odometry
between consecutive keyframes, scan-match anchors, loop closures).  The
residual of edge (i -> j) with measurement z is

    r = [R(th_i)^T (t_j - t_i) - z_t,  wrap(th_j - th_i - z_th)]

Gauss-Newton pins node 0, builds the dense [3K, 3K] normal equations from
the block-sparse Jacobian as the JAX module does (H = (W A)^T A), and
solves them by Cholesky: K is tens of keyframes, so every flight's solve
is one small batched matmul and factorization.  The matmuls run in full
float32 (TF32 off, checked by `check_float32_matmul`).

Every function takes a leading flight dimension [B] where the JAX module
uses vmap (PoseGraph fields [B, K, 3], [B, E, 2], ...).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.ops.raycast import _cos_f32, _f, _sin_f32

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


def check_float32_matmul() -> None:
    """Raise unless float32 matmuls run in full float32 (no TF32): the
    normal equations sum hundreds of products whose low bits decide the
    solve."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the pose graph needs full float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


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


def gauss_newton(graph: PoseGraph, iters: int = 10, damping: float = 1e-6):
    """Damped Gauss-Newton with node 0 pinned, the same number of
    iterations for every flight.  Returns (graph with the solved nodes,
    costs f32 [B, iters])."""
    check_float32_matmul()
    nodes = graph.nodes
    B, K = nodes.shape[:2]
    E = graph.edges_ij.shape[1]
    dev = nodes.device
    wbase = graph.edges_w * graph.edge_mask[..., None].to(torch.float32)
    delta = graph.edges_huber
    ks = torch.arange(K, device=dev)
    Si = (graph.edges_ij[..., 0, None] == ks).to(torch.float32)   # [B, E, K]
    Sj = (graph.edges_ij[..., 1, None] == ks).to(torch.float32)
    pin = (torch.arange(3 * K, device=dev) >= 3).to(torch.float32)
    eye = torch.eye(3 * K, dtype=torch.float32, device=dev)
    costs = []
    for _ in range(iters):
        r, Ji, Jj = _residuals_and_jacobians(nodes, graph)
        # IRLS-Huber: a robust edge keeps min(1, delta / ||r||_W) of its
        # information
        chi = torch.sqrt(torch.clamp_min((wbase * r * r).sum(-1), _f(1e-12)))
        scale = torch.where((delta > 0) & (chi > delta), delta / chi,
                            torch.ones_like(chi))
        wmask = wbase * scale[..., None]
        rw = r * wmask
        # the dense Jacobian A [3E, 3K] = Si (x) Ji + Sj (x) Jj
        A = (Si[:, :, None, :, None] * Ji[:, :, :, None, :]
             + Sj[:, :, None, :, None] * Jj[:, :, :, None, :])
        A = A.reshape(B, E * 3, K * 3)
        Aw = A * wmask.reshape(B, E * 3)[..., None]
        AwT = Aw.transpose(1, 2)
        H = torch.matmul(AwT, A)                                   # [B, 3K, 3K]
        b = torch.matmul(AwT, r.reshape(B, E * 3, 1))[..., 0]      # [B, 3K]
        H = H * pin[:, None] * pin[None, :] + torch.diag(1.0 - pin)
        b = b * pin
        H = H + _f(damping) * eye
        L = torch.linalg.cholesky(H)
        y = torch.linalg.solve_triangular(L, -b[..., None], upper=False)
        dx = torch.linalg.solve_triangular(L.transpose(1, 2), y,
                                           upper=True)[..., 0]
        nodes = nodes + dx.reshape(B, K, 3)
        nodes = torch.cat([nodes[..., :2], _wrap(nodes[..., 2:])], dim=-1)
        costs.append((rw * r).sum(dim=(1, 2)))
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
