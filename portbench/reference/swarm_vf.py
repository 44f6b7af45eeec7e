"""Plain reference of the closed-loop swarm flying on its vision
front-end: reference/swarm.py's swarm (the world, the map, the EKF, the
frontier queries, the UL machine, the FC model and the dynamics, imported
and not changed) with its flow sensor replaced by a downward camera and
pyramidal Lucas-Kanade optical flow, as BASELINE.json's configuration 3
states it ("pyramidal Lucas-Kanade optical flow on downward-camera frames
-> velocity estimates").

  camera  a size x size px pinhole looking straight down, focal_px, at the
          quad's true pose and height (floored at 0.05 m): pixel (r, c)
          sees the ground at (x, y) + R(yaw) (u_c, u_r) h / f, u = i -
          (size - 1) / 2; the ground is a fixed sum of sinusoids of the
          world coordinates, 100 + 30 v
  LK      the global shift between the previous frame and this one: a
          `levels`-level pyramid of 2 x 2 means, coarse to fine; at each
          level the central-difference gradients of the previous frame,
          the 2 x 2 normal equations masked to the pixels 2 or more from
          the border, and `iters` Gauss-Newton steps, each warping the
          new frame by the current shift (bilinear, borders clamped)
  quality 255 (1 - mean |residual| / mean |contrast|) over the masked
          pixels after the last warp, 0 where the frame has no contrast
  rates   camera motion = minus the aligning shift; rate [rad/s] = shift
          [px] / focal_px / frame interval (uav_local_nav.c:1150-1157)

A frame is taken every flow_period_ms of the mission clock.  The camera
streams from before the first tick: the previous frame of the first flow
tick is the frame at the start pose.  The rates and quality latch between
frames; the EKF reads them, and the machine the quality, where the quad is
above 0.05 m (NaN rates and quality 0 below), as it reads the oracle
sensor's.

Every value is float32 and rounds as the program's eager torch does: the
trig by way of float64 rounded once, no product contracted into an fma.
Departures from the JAX package's module (micro_quad_slam_tpu/ops/flow.py),
each shared with the program:
  - the warp is the direct two-tap gather along each axis, where the JAX
    module multiplies by one-hot banded matrices (the TPU's matrix unit):
    the same two pixels with the same weights, so only rounding differs;
  - the sums over a frame are torch's reductions over the whole masked
    [B, H, W] block (and the quality's means over the inner block), not
    XLA's order.

`lowp` is the precision control: besides reference/swarm.py's (the true
pose and the EKF mean that each tick hands on in bfloat16) each camera
frame is rounded to bfloat16.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import swarm as RW
from portbench.reference.config import Config
from portbench.reference.grid import (
    F32, cos_f32, extract_beams, f32, lowp_round, make_rays, sin_f32)
from portbench.reference.mapping import apply_rays_exact, new_flat_grids
from portbench.reference.slam import Ekf, ekf_init, ekf_step, predict_consts

MASK_BORDER = 2
EPS_DET = 1e-6
EPS_CONTRAST = 1e-3


# ------------------------------------------------------------- the camera

def ground(px, py):
    """The ground's brightness at world points (metres), elementwise:
    100 + 30 (sin 9.1x cos 7.3y + 0.7 sin(23.7x + 31.1y)
    + 0.5 cos(41.3x - 17.9y) + 0.3 sin(73x + 2) sin 61y)."""
    v = (sin_f32(px * f32(9.1)) * cos_f32(py * f32(7.3))
         + f32(0.7) * sin_f32(px * f32(23.7) + py * f32(31.1))
         + f32(0.5) * cos_f32(px * f32(41.3) - py * f32(17.9))
         + f32(0.3) * sin_f32(px * f32(73.0) + 2.0)
         * sin_f32(py * f32(61.0)))
    return 100.0 + 30.0 * v


def camera(x, y, h, yaw_rad, size: int, focal_px: float):
    """Frames [B, size, size] seen from poses [B] at heights h [B]."""
    u = torch.arange(size, dtype=torch.float32, device=x.device) \
        - f32((size - 1) / 2.0)
    m = (h / f32(focal_px))[:, None, None]          # metres a pixel
    right = u[None, None, :] * m                    # along a row (c)
    down = u[None, :, None] * m                     # along a column (r)
    c = cos_f32(yaw_rad)[:, None, None]
    s = sin_f32(yaw_rad)[:, None, None]
    gx = x[:, None, None] + c * right - s * down
    gy = y[:, None, None] + s * right + c * down
    return ground(gx, gy)


# --------------------------------------------------------------------- LK

def pool(img):
    """One pyramid level down: the mean of each 2 x 2 block."""
    B, H, W = img.shape
    return img.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))


def central_diff(a, dim: int):
    """d a / d index along dim: (a[i+1] - a[i-1]) / 2 inside, one-sided
    at both ends."""
    n = a.shape[dim]
    inner = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) / 2
    first = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    last = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def inner_mask(H: int, W: int, device):
    """1 on the pixels MASK_BORDER or more from the border, else 0."""
    m = torch.zeros((H, W), dtype=torch.float32, device=device)
    b = MASK_BORDER
    m[b:H - b, b:W - b] = 1.0
    return m


def warp(img, dx, dy):
    """img [B, H, W] sampled at (c + dx, r + dy), dx and dy [B]: bilinear,
    the border pixels repeated outside; first along the rows, then along
    the columns."""
    B, H, W = img.shape
    fx, fy = torch.floor(dx), torch.floor(dy)
    ax, ay = (dx - fx)[:, None, None], (dy - fy)[:, None, None]
    cols = torch.arange(W, device=img.device)
    rows = torch.arange(H, device=img.device)
    c0 = fx.to(torch.int64)[:, None] + cols          # [B, W]
    r0 = fy.to(torch.int64)[:, None] + rows          # [B, H]

    def at_cols(a, c):
        return torch.take_along_dim(a, c.clamp(0, W - 1)[:, None, :], dim=2)

    def at_rows(a, r):
        return torch.take_along_dim(a, r.clamp(0, H - 1)[:, :, None], dim=1)

    across = at_cols(img, c0) * (1 - ax) + at_cols(img, c0 + 1) * ax
    return at_rows(across, r0) * (1 - ay) + at_rows(across, r0 + 1) * ay


def level(prev, curr, dx, dy, iters: int):
    """`iters` Gauss-Newton steps of the shift (dx, dy) [B] aligning curr
    to prev at one pyramid level."""
    H, W = prev.shape[-2:]
    gy, gx = central_diff(prev, 1), central_diff(prev, 2)
    m = inner_mask(H, W, prev.device)

    def total(a):
        return a.sum(dim=(-2, -1))

    sxx, sxy, syy = total(gx * gx * m), total(gx * gy * m), total(gy * gy * m)
    det = sxx * syy - sxy * sxy
    solvable = det > EPS_DET
    for _ in range(iters):
        err = (warp(curr, dx, dy) - prev) * m
        bx, by = total(gx * err), total(gy * err)
        step_x = (syy * bx - sxy * by) / (det + EPS_DET)
        step_y = (sxx * by - sxy * bx) / (det + EPS_DET)
        dx = dx - torch.where(solvable, step_x, 0.0)
        dy = dy - torch.where(solvable, step_y, 0.0)
    return dx, dy


def lk(prev, curr, levels: int, iters: int):
    """The camera's shift (dx, dy) [B] in pixels between frames prev and
    curr [B, H, W] and its quality [B] in 0..255 (float)."""
    pyramid = [(prev, curr)]
    for _ in range(levels - 1):
        pyramid.append(tuple(pool(a) for a in pyramid[-1]))
    dx = dy = torch.zeros(prev.shape[0], dtype=torch.float32,
                          device=prev.device)
    for p, c in pyramid[::-1]:
        dx, dy = level(p, c, dx * 2.0, dy * 2.0, iters)
    b = MASK_BORDER

    def inner(a):
        return a[:, b:-b, b:-b].mean(dim=(-2, -1))

    resid = inner((warp(curr, dx, dy) - prev).abs())
    contrast = inner((prev - prev.mean(dim=(-2, -1), keepdim=True)).abs())
    q = torch.clamp(255.0 * (1.0 - resid / (contrast + EPS_CONTRAST)),
                    0.0, 255.0)
    q = torch.where(contrast < EPS_CONTRAST, 0.0, q)
    return -dx, -dy, q


def rates(dx, dy, period_ms: int, focal_px: float):
    """Pixel shifts over one frame interval -> angular rates [rad/s]."""
    per = float(F32(focal_px) * F32(period_ms * 1e-3))
    return dx / per, dy / per


# ---------------------------------------------------------------- the loop

def swarm_run(room, boxes, x0, y0, yaw0, seed: int, n_ticks: int,
              cfg: Config, bh, bt, vision: dict, dt_ms: int,
              scan_period_ms: int, noise_mm: float, dropout_p: float,
              lowp: bool = False, t0_ms: int = 0) -> dict:
    """reference/swarm.py's swarm_run from an airborne start (mid-mission,
    exploring) with the vision front-end `vision` ({camera_px, focal_px,
    levels, iters, flow_period_ms}) in place of the flow sensor.  Returns
    its results and per tick the rates and quality the EKF and the
    machine read, of_rate_x, of_rate_y and of_q [T, B]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, focal = int(vision["camera_px"]), float(vision["focal_px"])
    period = int(vision["flow_period_ms"])
    if period % dt_ms:
        raise ValueError("flow_period_ms must be a multiple of dt_ms")
    dev = x0.device
    B = x0.shape[0]
    live = ~torch.isnan(boxes).any(dim=-1)
    boxes = torch.where(live[..., None], boxes, 0.0)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(3):                      # the start poses' draws
        torch.rand(B, generator=gen)
    q = RW._start(x0, y0, yaw0, True)
    M = RW.machine_init(B, dev)
    yes = torch.ones(B, dtype=torch.bool, device=dev)
    M.update(st=torch.full((B,), RW.EXPLORE, dtype=torch.int32, device=dev),
             yaw_tv=yes, yaw_t=yaw0, hover_valid=yes, hover_x=x0,
             hover_y=y0, hover_z=-q.alt, hover_yaw=yaw0, alt=q.alt,
             alt_src=torch.full((B,), RW.ALT_RF, dtype=torch.int32,
                                device=dev),
             to_sent=yes, to_started=yes, armed_prev=yes,
             xy_since=torch.ones((B,), dtype=torch.int32, device=dev))
    ekf = ekf_init(B, dev)
    mean = ekf.mean.clone()
    mean[:, 0], mean[:, 1], mean[:, 4] = x0, y0, q.alt
    mean[:, 6] = yaw0 * RW.DEG2RAD
    ekf = Ekf(mean, ekf.cov)
    inited = yes.clone()
    ox, oy = x0, y0
    flat, grids = new_flat_grids(B, cfg, dev)
    tof_min = torch.full((B, 4), math.nan, device=dev)
    scores = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    consts = predict_consts(dev)
    dt = F32(dt_ms * 1e-3)
    dts = torch.full((B,), float(dt), device=dev)
    rnd = lowp_round if lowp else (lambda a: a)

    def frame(q):
        h = torch.clamp(q.alt, min=0.05)
        return rnd(camera(q.x, q.y, h, q.yaw * RW.DEG2RAD, size, focal))

    prev = frame(q)                         # the camera streams already
    vis_rx = vis_ry = torch.full((B,), math.nan, device=dev)
    vis_q = torch.zeros((B,), dtype=torch.int32, device=dev)
    rec = {k: [] for k in ("state", "cmd_kind", "cmd_x", "est_x", "est_y",
                           "yaw", "of_rate_x", "of_rate_y", "of_q")}
    t = t0_ms
    for _ in range(n_ticks):
        t += dt_ms
        if t % scan_period_ms == 0:
            shape = (B, 4, 8, 8)
            normal = torch.randn(shape, generator=gen)
            uniform = torch.rand(shape, generator=gen)
            cells = RW.tof_frame(room, boxes, live, q.x, q.y, q.yaw, normal,
                                 uniform, noise_mm, dropout_p, cfg.tof)
            beams, tof_min = extract_beams(cells, cfg.tof)
            rays = make_rays(beams, ekf.mean[:, 0], ekf.mean[:, 1], q.yaw,
                             ox, oy, inited, cfg.map, cfg.tof)
            apply_rays_exact(flat, rays, cfg)
        # the vision front-end
        yr = q.yaw * RW.DEG2RAD
        h = torch.clamp(q.alt, min=0.0)
        up = q.alt > 0.05
        if t % period == 0:
            cur = frame(q)
            dx, dy, quality = lk(prev, cur, int(vision["levels"]),
                                 int(vision["iters"]))
            vis_rx, vis_ry = rates(rnd(dx), rnd(dy), period, focal)
            vis_q = torch.clamp(quality, 0, 255).to(torch.int32)
            prev = cur
        rx = torch.where(up, vis_rx, math.nan)
        ry = torch.where(up, vis_ry, math.nan)
        of_q = torch.where(up, vis_q, 0).to(torch.int32)
        ekf = ekf_step(ekf, dts, rx, ry, of_q, h, yr, cfg.ekf, consts)
        mean = ekf.mean.clone()
        mean[:, 0] = torch.where(up, mean[:, 0], q.x)
        mean[:, 1] = torch.where(up, mean[:, 1], q.y)
        ekf = Ekf(rnd(mean), ekf.cov)
        ex, ey = ekf.mean[:, 0], ekf.mean[:, 1]
        if t % scan_period_ms == 0:
            scores = RW.frontier(grids, ex, ey, q.yaw, ox, oy, inited, cfg)
        tm = RW._telemetry(q, t, ex, ey, of_q, tof_min, inited, scores)
        out = RW.control_tick(M, tm, bh, bt, cfg)
        first = out["map_init"] & ~inited
        ox = torch.where(first, out["map_ox"], ox)
        oy = torch.where(first, out["map_oy"], oy)
        inited = inited | first
        q = RW._fly(q, out, t, dt_ms * 1e-3, ex, ey, room)
        if lowp:
            q = q._replace(x=rnd(q.x), y=rnd(q.y), yaw=rnd(q.yaw))
        for k_, v in (("state", out["state"]), ("cmd_kind", out["cmd_kind"]),
                      ("cmd_x", out["cmd"][:, 0]), ("est_x", ex),
                      ("est_y", ey), ("yaw", q.yaw), ("of_rate_x", rx),
                      ("of_rate_y", ry), ("of_q", of_q)):
            rec[k_].append(v)
    res = {k: torch.stack(v) for k, v in rec.items()}
    res.update(grid=grids, x=q.x, y=q.y, yaw_final=q.yaw,
               ekf_mean=ekf.mean, frontier=scores)
    return res
