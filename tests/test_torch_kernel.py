"""The port's CUDA kernels (csrc/replay_exact.cu, csrc/replay_cone.cu)
against their plain torch versions, on the card.  Every test here needs a
CUDA device and skips without one.  The file imports nothing of jax or
the JAX package (its flights are the port's committed test data), so it
also runs where only the port is installed; from the repository root on a
CUDA machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py

(--noconftest: tests/conftest.py imports jax for the JAX package's tests).
"""

import pytest
import torch

import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.ops import conex as cx
from micro_quad_slam_tpu_torch.ops import residentx as rx
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _flights(device):
    """4 of the committed random flights at their full 64 frames; flight 1
    flies 0 -> 34 m in x and recenters at frames 28 and 51."""
    f, _ = testdata.load("random_flights")
    return port.frames_to_torch({k: v[:4] for k, v in f.items()}, device)


def _random_grids(device, B=4):
    """Grids of random values inside the clamp range, margins zero."""
    geom = port.DEFAULT_GEOM
    g = torch.randint(-80, 81, (B, geom.prows, geom.pcols), dtype=torch.int8,
                      device=device)
    lo, r_hi, c_hi = geom.pad, geom.pad + geom.height, geom.pad + geom.width
    g[:, :lo] = 0
    g[:, r_hi:] = 0
    g[:, :, :lo] = 0
    g[:, :, c_hi:] = 0
    return g


def test_kernel_bit_equals_plain_on_the_card(cuda):
    sched, outs, _ = rx.schedule(_flights(cuda), UL_PROFILE)
    assert outs["kf_flags"].any()
    g0 = _random_grids(cuda)
    before = rx.replay_exact.launches
    got = rx.replay_exact(g0.clone(), sched, UL_PROFILE)
    torch.cuda.synchronize()
    assert rx.replay_exact.launches == before + 1
    want = rx.replay_exact_plain(g0.clone(), sched, UL_PROFILE)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hybrid", [False, True])
def test_cone_kernel_bit_equals_plain_on_the_card(cuda, hybrid):
    sched, outs, _ = cx.schedule(_flights(cuda), UL_PROFILE, hybrid=hybrid)
    assert outs["kf_flags"].any()
    g0 = _random_grids(cuda)
    before = cx.replay_cone.launches
    got = cx.replay_cone(g0.clone(), sched, UL_PROFILE, hybrid)
    torch.cuda.synchronize()
    assert cx.replay_cone.launches == before + 1
    want = cx.replay_cone_plain(g0.clone(), sched, UL_PROFILE, hybrid)
    assert torch.equal(got, want)


def _assert_same(a, b):
    (st_k, outs_k), (st_p, outs_p) = a, b
    pairs = [(f, getattr(st_k, f), getattr(st_p, f)) for f in st_k._fields]
    pairs += [(k, outs_k[k], outs_p[k]) for k in outs_k]
    for name, x, y in pairs:
        if x.is_floating_point():       # NaN origins/filt before map init
            x, y = x.nan_to_num(7.0), y.nan_to_num(7.0)
        assert torch.equal(x, y), name


@pytest.mark.parametrize("kernel, plain", [("residentx", "xla"),
                                           ("conex", "cone"),
                                           ("hybridx", "hybrid")])
def test_replay_through_kernel_equals_per_frame_path(cuda, kernel, plain):
    frames = _flights(cuda)
    _assert_same(port.replay_mapping_batched(frames, UL_PROFILE, kernel=kernel),
                 port.replay_mapping_batched(frames, UL_PROFILE, kernel=plain))
