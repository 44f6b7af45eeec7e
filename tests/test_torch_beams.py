"""PyTorch port, ops/beams.py: beam extraction and the ToF EMA filter,
held bit-equal to the JAX package on the same seeded numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from micro_quad_slam_tpu.ops import beams as jb
from micro_quad_slam_tpu_torch.ops import beams as tb

torch.set_num_threads(2)


def _assert_bits(a, b):
    """Bit-equality of float arrays, NaNs in the same places (tolerance 0:
    every op is a correctly rounded float32 op on both sides)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _grid_mm(seed, shape=(3, 5, 4, 8, 8)):
    """u16 ToF grids mixing normal returns with every special value: 0 and
    0xFFFF (no return), 19 mm (dropped), 20 mm (kept: 20 * 0.001f rounds
    above 0.02f), > 4 m (clamped) and columns with duplicated minima."""
    rng = np.random.default_rng(seed)
    g = rng.integers(30, 4500, shape).astype(np.uint16)
    pick = rng.random(shape)
    g[pick < 0.10] = 0
    g[(pick >= 0.10) & (pick < 0.20)] = 0xFFFF
    g[(pick >= 0.20) & (pick < 0.25)] = 19
    g[(pick >= 0.25) & (pick < 0.28)] = 20
    dup = rng.random(shape[:-2] + (1, shape[-1])) < 0.3
    g = np.where(dup & (np.arange(8)[:, None] < 2), np.uint16(777), g)
    return g


@pytest.mark.parametrize("seed", range(3))
def test_extract_beams_matches_jax(seed):
    g = _grid_mm(seed)
    bj, mj = jb.extract_beams(jnp.asarray(g))
    bt, mt = tb.extract_beams(torch.from_numpy(g.astype(np.int32)))
    _assert_bits(bj, bt.numpy())
    _assert_bits(mj, mt.numpy())


def test_extract_beams_duplicate_minima_and_empty_columns():
    g = np.full((4, 8, 8), 0xFFFF, np.uint16)
    g[0, :, 0] = [900, 500, 500, 0, 0, 0, 0, 0]      # duplicate minimum
    g[0, :, 1] = [0, 0, 0, 0, 0, 0, 0, 650]          # single valid return
    g[0, :, 2] = [19, 15, 0, 0xFFFF, 0, 0, 0, 0]     # nothing valid
    g[0, :, 3] = [20, 0, 0, 0, 0, 0, 0, 0]           # 20 mm is kept
    g[1] = 0                                         # a whole sensor empty
    bt, mt = tb.extract_beams(torch.from_numpy(g.astype(np.int32)))
    bj, mj = jb.extract_beams(jnp.asarray(g))
    _assert_bits(bj, bt.numpy())
    _assert_bits(mj, mt.numpy())
    assert bt[0, 0] == np.float32(500 * np.float32(0.001))   # second == first
    assert bt[0, 1] == np.float32(650 * np.float32(0.001))
    assert torch.isnan(bt[0, 2]) and torch.isnan(bt[1]).all()
    assert bt[0, 3] == np.float32(20 * np.float32(0.001))
    assert torch.isnan(mt[1])


def test_tof_filter_update_chain_matches_jax():
    """40 EMA steps from an all-NaN filter, with NaN samples mixed in."""
    rng = np.random.default_rng(4)
    minima = rng.uniform(0.05, 4.0, (40, 6, 4)).astype(np.float32)
    minima[rng.random(minima.shape) < 0.2] = np.nan
    fj = jnp.full((6, 4), jnp.nan, jnp.float32)
    ft = torch.full((6, 4), float("nan"))
    for t in range(40):
        fj = jb.tof_filter_update(fj, jnp.asarray(minima[t]), 0.20)
        ft = tb.tof_filter_update(ft, torch.from_numpy(minima[t]), 0.20)
        _assert_bits(fj, ft.numpy())
    assert not torch.isnan(ft).any()
