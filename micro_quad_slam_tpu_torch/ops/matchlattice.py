"""The correlative lattice scorer: a hand-written Hopper kernel
(csrc/match_lattice.cu) and its plain torch version (counterpart of
micro_quad_slam_tpu/ops/pallas_scanmatch.py).

    score[n, y, ty, tx] = sum_b W_n[ry[n, y*T + ty, b], rx[n, y*T + tx, b]]

over the 32 beams b, for N matches, each against its own int8 slab W_n
[SR, SC].  An index of -1 (an endpoint off the logical grid, or a beam
that did not hit) contributes 0, as does any index outside the slab.
Every summand is an int8 value and a score sums at most 32 of them, so
the float32 score is the same integer in any order of summation: the
kernel is bit-equal to `match_lattice_plain`.

`match_lattice` launches the kernel on a CUDA tensor, runs
`match_lattice_plain` on a CPU tensor, and raises on any other device.
`match_lattice.launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from micro_quad_slam_tpu_torch.ops import _build


def _check(slabs, ry, rx, n_yaw: int) -> int:
    """Validate the operands; returns T (candidates per lattice axis)."""
    if slabs.dtype != torch.int8 or ry.dtype != torch.int32 \
            or rx.dtype != torch.int32:
        raise TypeError(f"slabs must be int8 and ry/rx int32, got "
                        f"{slabs.dtype}, {ry.dtype}, {rx.dtype}")
    if not (slabs.device == ry.device == rx.device):
        raise ValueError("slabs, ry and rx must be on one device")
    N = slabs.shape[0]
    if slabs.dim() != 3 or ry.dim() != 3 or ry.shape != rx.shape \
            or ry.shape[0] != N or ry.shape[1] % n_yaw:
        raise ValueError(f"shapes: slabs {tuple(slabs.shape)}, ry "
                         f"{tuple(ry.shape)}, rx {tuple(rx.shape)} do not "
                         f"fit [N, SR, SC] and [N, {n_yaw}*T, NB]")
    if not (slabs.is_contiguous() and ry.is_contiguous()
            and rx.is_contiguous()):
        raise ValueError("slabs, ry and rx must be contiguous")
    return ry.shape[1] // n_yaw


def match_lattice_plain(slabs, ry, rx, n_yaw: int) -> torch.Tensor:
    """Plain torch version: a masked gather of every (candidate, beam) cell
    and a sum over the beams.  slabs int8 [N, SR, SC]; ry, rx int32
    [N, n_yaw*T, NB].  Returns float32 [N, n_yaw, T, T] ([.., ty, tx])."""
    T = _check(slabs, ry, rx, n_yaw)
    N, SR, SC = slabs.shape
    NB = ry.shape[2]
    ryv = ry.reshape(N, n_yaw, T, 1, NB).long()
    rxv = rx.reshape(N, n_yaw, 1, T, NB).long()
    ok = (ryv >= 0) & (ryv < SR) & (rxv >= 0) & (rxv < SC)
    flat = (ryv.clamp(0, SR - 1) * SC + rxv.clamp(0, SC - 1))
    vals = torch.gather(slabs.reshape(N, SR * SC), 1, flat.reshape(N, -1))
    vals = vals.reshape(N, n_yaw, T, T, NB).to(torch.float32)
    return torch.where(ok, vals, torch.zeros_like(vals)).sum(-1)


def match_lattice(slabs, ry, rx, n_yaw: int) -> torch.Tensor:
    """Lattice scores float32 [N, n_yaw, T, T]; see the module docstring.
    A CUDA tensor goes to csrc/match_lattice.cu, a CPU tensor to
    match_lattice_plain; any other device raises."""
    T = _check(slabs, ry, rx, n_yaw)
    if slabs.device.type == "cpu":
        return match_lattice_plain(slabs, ry, rx, n_yaw)
    if slabs.device.type != "cuda":
        raise ValueError(f"no lattice kernel for device {slabs.device}")
    N, SR, SC = slabs.shape
    out = torch.empty((N, n_yaw, T, T), dtype=torch.float32,
                      device=slabs.device)
    if N == 0:
        return out
    fn = _build.load_library("match_lattice").mqs_match_lattice
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(slabs.device):
        stream = torch.cuda.current_stream(slabs.device).cuda_stream
        err = fn(slabs.data_ptr(), ry.data_ptr(), rx.data_ptr(),
                 out.data_ptr(), N, SR, SC, n_yaw, T, ry.shape[2], stream)
    if err != 0:
        raise RuntimeError(f"match_lattice kernel launch failed: CUDA error "
                           f"{err}")
    match_lattice.launches += 1
    return out


match_lattice.launches = 0
