"""Pyramidal Lucas-Kanade optical flow on downward-camera frames in
PyTorch (counterpart of micro_quad_slam_tpu/ops/flow.py): the simulator's
vision-flow sensor, batched over quads.

Estimates the single global image shift of a downward-looking camera: coarse
to fine over an L-level mean-pool pyramid; at each level a few Gauss-Newton
iterations solve the 2x2 LK normal equations over the whole frame with a
bilinear warp.  The frames carry a leading batch dimension [B, H, W] where
the JAX module uses vmap.

The JAX module warps with two one-hot banded matmuls, a formulation for
the TPU's matrix unit.  Here the warp is the direct two-tap gather along
each axis, which computes the same weighted sum of the same two pixels;
floats can differ from XLA's contracted dot in the last bits, and sums are
taken in another order, so the two packages agree within a tolerance.

Conversions follow the reference's convention: flow_rate [rad/s] =
pixel_shift / focal_px / dt, and velocity = rate * ground_distance
(uav_local_nav.c:1150-1165).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.ops.raycast import _cos_f32, _sin_f32

_F32 = np.float32


def _pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool (pyramid downsample) of [..., H, W]."""
    H, W = img.shape[-2:]
    x = img.reshape(img.shape[:-2] + (H // 2, 2, W // 2, 2))
    return x.mean(dim=(-1, -3))


def _bilinear_shift(img: torch.Tensor, dx: torch.Tensor,
                    dy: torch.Tensor) -> torch.Tensor:
    """Sample img [B, H, W] at (x + dx, y + dy), dx and dy [B], with
    bilinear interpolation and clamped (zero-gradient) borders: the two
    taps of each output column, then of each output row."""
    B, H, W = img.shape
    dev = img.device
    x0 = torch.floor(dx)
    y0 = torch.floor(dy)
    ax = (dx - x0)[:, None, None]
    ay = (dy - y0)[:, None, None]
    ix = x0.to(torch.int64)[:, None]
    iy = y0.to(torch.int64)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    rows = torch.arange(H, device=dev)[None, :]

    def taps(a, i0, n, dim):
        idx0 = (i0 + (cols if dim == -1 else rows)).clamp(0, n - 1)
        idx1 = (i0 + 1 + (cols if dim == -1 else rows)).clamp(0, n - 1)
        shape = (B, 1, W) if dim == -1 else (B, H, 1)
        g0 = torch.gather(a, dim, idx0.reshape(shape).expand(B, H, W))
        g1 = torch.gather(a, dim, idx1.reshape(shape).expand(B, H, W))
        return g0, g1

    c0, c1 = taps(img, ix, W, -1)
    mixed = c0 * (1 - ax) + c1 * ax
    r0, r1 = taps(mixed, iy, H, -2)
    return r0 * (1 - ay) + r1 * ay


def _lk_level(prev, curr, dx, dy, iters: int, eps: float = 1e-6):
    """Refine (dx, dy) [B] at one pyramid level with GN iterations.
    Border pixels are excluded from the normal equations (warp clamping
    pollutes them)."""
    H, W = prev.shape[-2:]
    gy, gx = torch.gradient(prev, dim=(-2, -1))
    m = torch.zeros((H, W), dtype=torch.float32, device=prev.device)
    m[2:-2, 2:-2] = 1.0
    red = lambda a: a.sum(dim=(-2, -1))                               # noqa: E731
    gxx = red(gx * gx * m)
    gxy = red(gx * gy * m)
    gyy = red(gy * gy * m)
    det = gxx * gyy - gxy * gxy
    ok = det > eps
    for _ in range(iters):
        warped = _bilinear_shift(curr, dx, dy)
        it = (warped - prev) * m
        bx = red(gx * it)
        by = red(gy * it)
        sx = torch.where(ok, (gyy * bx - gxy * by) / (det + eps), 0.0)
        sy = torch.where(ok, (gxx * by - gxy * bx) / (det + eps), 0.0)
        dx, dy = dx - sx, dy - sy
    return dx, dy


class FlowResult(NamedTuple):
    dx_px: torch.Tensor     # image shift (pixels, +x right)
    dy_px: torch.Tensor
    quality: torch.Tensor   # 0-255 confidence from residual + texture


def lk_flow_batched(prev: torch.Tensor, curr: torch.Tensor, levels: int = 3,
                    iters: int = 4) -> FlowResult:
    """Global pyramidal LK shift between two batches of [B, H, W] float
    frames; H and W divisible by 2**(levels-1).  Returns [B] fields."""
    prev = prev.to(torch.float32)
    curr = curr.to(torch.float32)
    pyr = [(prev, curr)]
    for _ in range(levels - 1):
        p, c = pyr[-1]
        pyr.append((_pool2(p), _pool2(c)))

    zero = torch.zeros(prev.shape[0], dtype=torch.float32, device=prev.device)
    dx, dy = zero, zero
    for p, c in reversed(pyr):
        dx, dy = _lk_level(p, c, dx * 2.0, dy * 2.0, iters)

    # confidence: normalized residual after alignment + texture strength
    warped = _bilinear_shift(curr, dx, dy)
    inner = lambda a: a[:, 2:-2, 2:-2].mean(dim=(-2, -1))             # noqa: E731
    resid = inner((warped - prev).abs())
    contrast = inner((prev - prev.mean(dim=(-2, -1), keepdim=True)).abs())
    q = torch.clamp(255.0 * (1.0 - resid / (contrast + 1e-3)), 0.0, 255.0)
    q = torch.where(contrast < 1e-3, 0.0, q)
    # the GN solves for the warp aligning curr to prev (= -scene shift);
    # negate to report CAMERA motion in pixels, the PX4FLOW convention.
    return FlowResult(-dx, -dy, q)


def lk_flow(prev: torch.Tensor, curr: torch.Tensor, levels: int = 3,
            iters: int = 4) -> FlowResult:
    """lk_flow_batched for one pair of [H, W] frames: 0-d fields."""
    res = lk_flow_batched(prev[None], curr[None], levels, iters)
    return FlowResult(*(v[0] for v in res))


def flow_to_rates(dx_px, dy_px, dt_s, focal_px: float):
    """Pixel shift -> angular rates [rad/s] (small-angle model, the same
    quantity OPTICAL_FLOW_RAD integrates, uav_local_nav.c:1150-1157)."""
    den = float(_F32(focal_px) * _F32(dt_s))
    return dx_px / den, dy_px / den


def rates_to_velocity(rate_x, rate_y, ground_m):
    """Angular rates + ground distance -> body-frame velocity [m/s]
    (reference displacement convention, uav_local_nav.c:1159-1165)."""
    return rate_x * ground_m, rate_y * ground_m


# ----------------------------- test support -------------------------------

def render_ground_patch(texture: torch.Tensor, cx, cy, size: int,
                        scale: float = 1.0) -> torch.Tensor:
    """Render a size x size camera view of a big ground texture [H, W]
    centred at (cx, cy) texture pixels (bilinear)."""
    dev = texture.device
    half = (size - 1) / 2.0
    steps = (torch.arange(size, dtype=torch.float32, device=dev)
             - float(half)) * float(scale)
    ys = float(cy) + steps
    xs = float(cx) + steps
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    ay = (ys - y0)[:, None]
    ax = (xs - x0)[None, :]
    H, W = texture.shape

    def take(oy, ox):
        yy = (y0 + oy).clamp(0, H - 1)
        xx = (x0 + ox).clamp(0, W - 1)
        return texture[yy[:, None], xx[None, :]]

    return ((1 - ay) * (1 - ax) * take(0, 0) + (1 - ay) * ax * take(0, 1)
            + ay * (1 - ax) * take(1, 0) + ay * ax * take(1, 1))


def analytic_ground(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Procedural ground texture: a fixed sum of sinusoids evaluated at
    world-plane coordinates (meters), elementwise, so the simulator can
    render downward-camera frames for the whole swarm.  Trig is the
    correctly rounded float32 value (ops/raycast.py::_cos_f32)."""
    f = lambda v: float(_F32(v))                                      # noqa: E731
    v = (_sin_f32(px * f(9.1)) * _cos_f32(py * f(7.3))
         + f(0.7) * _sin_f32(px * f(23.7) + py * f(31.1))
         + f(0.5) * _cos_f32(px * f(41.3) - py * f(17.9))
         + f(0.3) * _sin_f32(px * f(73.0) + 2.0) * _sin_f32(py * f(61.0)))
    return 100.0 + 30.0 * v


def render_camera_frame(x_m, y_m, alt_m, yaw_rad, size: int,
                        focal_px: float) -> torch.Tensor:
    """Downward camera views [B, size, size] of the analytic ground from
    poses x, y, alt, yaw [B]: pixel (r, c) sees the ground at
    pos + R(yaw) @ (u, v) * alt / focal."""
    half = (size - 1) / 2.0
    u = (torch.arange(size, dtype=torch.float32, device=x_m.device)
         - float(_F32(half)))                                        # cam x (cols)
    e = lambda a: a[:, None, None]                                    # noqa: E731
    scale = e(alt_m / float(_F32(focal_px)))
    cu = u[None, None, :] * scale
    cv = u[None, :, None] * scale
    c, s = e(_cos_f32(yaw_rad)), e(_sin_f32(yaw_rad))
    px = e(x_m) + c * cu - s * cv
    py = e(y_m) + s * cu + c * cv
    return analytic_ground(px, py)
