"""The port's scan matcher (ops/scanmatch.py) and lattice scorer
(ops/matchlattice.py) against the JAX package's, on the same seeded numpy
inputs, on the CPU.

- The lattice scorer is held bit-equal to the Pallas kernel
  (pallas_match_lattice in interpret mode) on identical slabs and
  indices, at both slab shapes of the SLAM path.
- Candidate cells: equal except where the float32 endpoint math differs
  (XLA-CPU fuses x + d*cos into an fma and its cos/sin are not correctly
  rounded); those cells are counted and bounded.
- _peak_result on identical scores: the argmax cells, score and quality
  bit-equal; the refined pose within an ulp (XLA fuses x + dx*step).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from micro_quad_slam_tpu.golden import compute_beams_and_minima
from micro_quad_slam_tpu.golden.model import GoldenMapper
from micro_quad_slam_tpu.ops import scanmatch as jsm
from micro_quad_slam_tpu.ops.pallas_scanmatch import pallas_match_lattice
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
from micro_quad_slam_tpu_torch.ops import matchlattice as ml
from micro_quad_slam_tpu_torch.ops import residentx as rx
from micro_quad_slam_tpu_torch.ops import scanmatch as tsm
from micro_quad_slam_tpu_torch.ops.raycast import DEFAULT_GEOM as GEOM
from micro_quad_slam_tpu_torch.ops.raycast import world_to_cell
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE

torch.set_num_threads(2)

F32 = np.float32
CFG, TOF = UL_PROFILE.map, UL_PROFILE.tof


def _scans(N, seed, edge=0):
    """N random scans and pose guesses; the last `edge` sit near the grid
    edge so that out-of-grid masking fires."""
    rng = np.random.default_rng(seed)
    beams = rng.uniform(0.1, 4.2, (N, 4, 8)).astype(F32)
    beams[rng.random((N, 4, 8)) < 0.15] = np.nan
    x = rng.uniform(-8, 8, N).astype(F32)
    y = rng.uniform(-8, 8, N).astype(F32)
    if edge:
        x[-edge:] = rng.uniform(21.0, 24.5, edge)
        y[-edge // 2:] = rng.uniform(-24.5, -21.0, edge // 2)
    yaw = rng.uniform(-180, 180, N).astype(F32)
    ox = rng.uniform(-1, 1, N).astype(F32)
    oy = rng.uniform(-1, 1, N).astype(F32)
    return beams, x, y, yaw, ox, oy


@pytest.mark.parametrize("n_xy, n_yaw", [(7, 7), (5, 5)])
def test_lattice_cells_equal_jax_but_for_counted_float_flips(n_xy, n_yaw):
    N = 96
    args = _scans(N, 5, edge=12)
    want = jax.jit(jax.vmap(lambda *a: jsm._lattice_cells(
        *a, CFG, TOF, n_xy, n_yaw, 0.05, 1.0)))(*map(jnp.asarray, args))
    got = tsm._lattice_cells(*map(torch.from_numpy, args), CFG, TOF, n_xy,
                             n_yaw, 0.05, 1.0)
    names = ("cy", "cx", "iny", "inx", "hit")
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    total = flipped = 0
    for name, a, b in zip(names[:4], got[:4], want[:4]):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        diff = a != b
        total += a.size
        flipped += int(diff.sum())
        if name in ("cy", "cx"):                 # off by one cell at most
            assert np.abs(a.astype(np.int64) - b)[diff].max(initial=0) <= 1
    # a flip needs an endpoint within ~1e-6 m of a cell boundary
    assert flipped <= total * 1e-4, (flipped, total)


@pytest.mark.parametrize("shape, n_xy, n_yaw", [((104, 256), 7, 7),
                                                ((96, 128), 5, 5)])
def test_match_lattice_plain_bit_equals_pallas(shape, n_xy, n_yaw):
    """Identical slabs and indices (-1 masks, every slab row and column
    reached): the plain version equals the Pallas kernel bit for bit."""
    rng = np.random.default_rng(7)
    N, (SR, SC) = 10, shape
    slabs = rng.integers(-128, 128, (N, SR, SC)).astype(np.int8)
    ry = rng.integers(0, SR, (N, n_yaw * n_xy, 32)).astype(np.int32)
    rx_ = rng.integers(0, SC, (N, n_yaw * n_xy, 32)).astype(np.int32)
    ry[rng.random(ry.shape) < 0.2] = -1
    rx_[rng.random(rx_.shape) < 0.1] = -1
    want = np.asarray(pallas_match_lattice(jnp.asarray(slabs),
                                           jnp.asarray(ry), jnp.asarray(rx_),
                                           n_yaw, True))
    got = ml.match_lattice_plain(torch.from_numpy(slabs),
                                 torch.from_numpy(ry), torch.from_numpy(rx_),
                                 n_yaw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper runs the plain version on the CPU, and launches nothing
    before = ml.match_lattice.launches
    np.testing.assert_array_equal(
        ml.match_lattice(torch.from_numpy(slabs), torch.from_numpy(ry),
                         torch.from_numpy(rx_), n_yaw).numpy(), want)
    assert ml.match_lattice.launches == before


def test_match_lattice_checks_operands_and_devices():
    slabs = torch.zeros((2, 8, 16), dtype=torch.int8)
    idx = torch.zeros((2, 6, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        ml.match_lattice(slabs, idx.long(), idx, 3)
    with pytest.raises(ValueError, match="shapes"):
        ml.match_lattice(slabs, idx, idx, 4)
    with pytest.raises(ValueError, match="no lattice kernel"):
        ml.match_lattice(slabs.to("meta"), idx.to("meta"), idx.to("meta"), 3)


def _grids_and_windows(N, seed):
    rng = np.random.default_rng(seed)
    padded = rng.integers(-80, 81, (N, GEOM.prows, GEOM.pcols)).astype(
        np.int8)
    return rng, padded


def test_match_slabs_bit_equals_match_window():
    """tests/test_slam.py:193-247 within the port: slab scoring equals
    window scoring, every field bit for bit, poses near the grid edge
    included."""
    N = 24
    _, padded = _grids_and_windows(N, 23)
    beams, x, y, yaw, ox, oy = map(torch.from_numpy, _scans(N, 23, edge=6))
    pcx, pcy = world_to_cell(x, y, ox, oy, CFG.res_m, 250, 250)
    wy0, wx0 = tsm.window_origin(pcx, pcy, GEOM)
    r0s, c0s = rx._snap_align(wy0, wx0, GEOM)
    g = torch.from_numpy(padded)
    slabs = tsm.cut_windows(g, r0s, c0s, *rx._snap_dims(GEOM)).contiguous()
    wins = tsm.cut_windows(g, wy0, wx0, GEOM.win_rows,
                           GEOM.win_cols).contiguous()
    got = tsm.match_slabs(slabs, r0s, c0s, beams, x, y, yaw, ox, oy, CFG,
                          TOF, GEOM)
    want = tsm.match_window(wins, wy0, wx0, beams, x, y, yaw, ox, oy, CFG,
                            TOF, GEOM)
    scan = tsm.match_scan(g, beams, x, y, yaw, ox, oy, CFG, TOF, GEOM)
    for name, a, b, c in zip(got._fields, got, want, scan):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        np.testing.assert_array_equal(a.numpy(), c.numpy(), err_msg=name)


def test_peak_result_equals_jax_on_identical_scores():
    """Integer scores with many ties: the first maximum of the flat
    [Y, Tx, Ty] order wins in both packages."""
    rng = np.random.default_rng(3)
    N, Y, T = 64, 7, 7
    scores = rng.integers(-4, 5, (N, Y, T, T)).astype(F32)
    scores[:8] = 0.0                               # all tied
    scores[8:16, 3, 3, 3] = 50.0                   # a clear centre peak
    hit = rng.random((N, Y, 32)) < 0.7
    xg = rng.uniform(-3, 3, N).astype(F32)
    yg = rng.uniform(-3, 3, N).astype(F32)
    wg = rng.uniform(-180, 180, N).astype(F32)
    want = jax.jit(jax.vmap(lambda s, h, a, b, c: jsm._peak_result(
        s, h, a, b, c, 0.05, 1.0)))(*map(jnp.asarray,
                                         (scores, hit, xg, yg, wg)))
    got = tsm._peak_result(*map(torch.from_numpy, (scores, hit, xg, yg, wg)),
                           0.05, 1.0)
    for name in ("score", "quality"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # guess + offset*step: XLA-CPU fuses it into an fma, so the two differ
    # by at most an ulp of the guess plus the largest offset (4 steps)
    for name, guess, step in (("x", xg, 0.05), ("y", yg, 0.05),
                              ("yaw_deg", wg, 1.0)):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.all(np.abs(a - b) <= np.spacing(np.abs(guess) + 4 * step)), name


def test_match_slabs_equals_jax_on_identical_slabs():
    """The whole flat matcher against the JAX package's match_slabs (its
    Pallas scorer in interpret mode) on the same snapshot slabs."""
    N = 16
    _, padded = _grids_and_windows(N, 29)
    args = _scans(N, 29, edge=4)
    beams, x, y, yaw, ox, oy = map(torch.from_numpy, args)
    pcx, pcy = world_to_cell(x, y, ox, oy, CFG.res_m, 250, 250)
    wy0, wx0 = tsm.window_origin(pcx, pcy, GEOM)
    r0s, c0s = rx._snap_align(wy0, wx0, GEOM)
    slabs = tsm.cut_windows(torch.from_numpy(padded), r0s, c0s,
                            *rx._snap_dims(GEOM)).contiguous()
    got = tsm.match_slabs(slabs, r0s, c0s, beams, x, y, yaw, ox, oy, CFG,
                          TOF, GEOM)
    want = jax.jit(lambda *a: jsm.match_slabs(*a, JAX_UL.map, JAX_UL.tof,
                                              interpret=True))(
        jnp.asarray(slabs.numpy()), jnp.asarray(r0s.numpy()),
        jnp.asarray(c0s.numpy()), *map(jnp.asarray, args))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(want.score))
    np.testing.assert_allclose(got.quality.numpy(), np.asarray(want.quality),
                               rtol=0, atol=1e-5)
    for name in ("x", "y", "yaw_deg"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=2e-5, err_msg=name)


def _wall_grid_and_beams(offset):
    """tests/test_slam.py:92-112: a map from a full yaw sweep (the golden
    model), and a scan taken at pose + offset."""
    sweep = synth_room_scanlog(n_frames=60, room=(-2.0, -2.0, 2.0, 2.0),
                               path="hover", yaw_rate_dps=60.0)
    gm = GoldenMapper()
    gm.init_map(0.0, 0.0)
    for _ in range(6):
        for t in range(len(sweep)):
            b, _ = compute_beams_and_minima(sweep.grid_mm[t])
            gm.map_update_from_beams(b, 0.0, 0.0, float(sweep.yaw_deg[t]))
    padded = np.zeros((GEOM.prows, GEOM.pcols), np.int8)
    padded[GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500] = gm.grid
    log2 = synth_room_scanlog(n_frames=1, path="hover",
                              room=(-2.0 - offset[0], -2.0 - offset[1],
                                    2.0 - offset[0], 2.0 - offset[1]))
    b1, _ = compute_beams_and_minima(log2.grid_mm[0])
    return torch.from_numpy(padded)[None], torch.from_numpy(
        np.asarray(b1, F32))[None]


def test_scanmatch_recovers_translation():
    offset = (0.12, -0.08)
    padded, beams = _wall_grid_and_beams(offset)
    z = torch.zeros(1)
    res = tsm.match_scan(padded, beams, z, z, z, z, z, CFG, TOF, GEOM)
    assert abs(float(res.x) - offset[0]) < 0.04
    assert abs(float(res.y) - offset[1]) < 0.04
    assert abs(float(res.yaw_deg)) < 1.5
    assert float(res.quality) > 3.0


def test_window_fit_check_refuses_a_short_window():
    from micro_quad_slam_tpu_torch.ops.raycast import GridGeom
    small = GridGeom(win_rows=64, win_cols=128)
    with pytest.raises(ValueError, match="window too small"):
        tsm._assert_window_fits(CFG, small, 7, 0.05)
