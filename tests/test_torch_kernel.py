"""The exact replay CUDA kernel (csrc/replay_exact.cu) against its plain
torch version, on the card.  Every test here needs a CUDA device and skips
without one.  The file imports no jax, so it also runs where only the
port is installed; from the repository root on a CUDA machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py

(--noconftest: tests/conftest.py imports jax for the JAX package's tests).
"""

import numpy as np
import pytest
import torch

import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import UL_PROFILE
from micro_quad_slam_tpu_torch.ops import residentx as rx

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _flights(B=4, T=24):
    logs = [synth_room_scanlog(n_frames=T, seed=s, noise_mm=5.0,
                               dropout_p=0.05) for s in range(B)]
    arrs = [port.scanlog_to_arrays(lg) for lg in logs]
    f = {k: np.stack([a[k] for a in arrs]) for k in arrs[0]}
    f["x_m"][1] = np.linspace(0.0, 34.0, T, dtype=np.float32)   # recenters
    return f


def test_kernel_bit_equals_plain_on_the_card(cuda):
    frames = port.frames_to_torch(_flights(), cuda)
    sched, outs, _ = rx.schedule(frames, UL_PROFILE)
    assert outs["kf_flags"].any()
    g0 = torch.randint(-80, 81, (4, 608, 640), dtype=torch.int8, device=cuda)
    g0[:, :48] = 0
    g0[:, 548:] = 0
    g0[:, :, :48] = 0
    g0[:, :, 548:] = 0
    before = rx.replay_exact.launches
    got = rx.replay_exact(g0.clone(), sched, UL_PROFILE)
    torch.cuda.synchronize()
    assert rx.replay_exact.launches == before + 1
    want = rx.replay_exact_plain(g0.clone(), sched, UL_PROFILE)
    assert torch.equal(got, want)


def test_replay_through_kernel_equals_per_frame_path(cuda):
    frames = port.frames_to_torch(_flights(), cuda)
    st_k, outs_k = port.replay_mapping_batched(frames, UL_PROFILE,
                                               kernel="residentx")
    st_p, outs_p = port.replay_mapping_batched(frames, UL_PROFILE,
                                               kernel="xla")
    pairs = [(f, getattr(st_k, f), getattr(st_p, f)) for f in st_k._fields]
    pairs += [(k, outs_k[k], outs_p[k]) for k in outs_k]
    for name, a, b in pairs:
        if a.is_floating_point():       # NaN origins/filt before map init
            a, b = a.nan_to_num(7.0), b.nan_to_num(7.0)
        assert torch.equal(a, b), name
