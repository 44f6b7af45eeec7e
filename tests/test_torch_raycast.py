"""PyTorch port, ops/raycast.py: ray projection, the exact window update,
recentering and the frontier queries, and ops/residentx.py's map step
with the per-frame "pallas" routes, held bit-equal to the JAX package on
the same seeded numpy inputs (integer and int8 outputs: tolerance 0)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from micro_quad_slam_tpu.ops import raycast as jr
from micro_quad_slam_tpu.utils.config import MapConfig as JaxMapConfig
from micro_quad_slam_tpu_torch.ops import raycast as tr
from micro_quad_slam_tpu_torch.utils.config import MapConfig, TofConfig

torch.set_num_threads(2)

GEOM = tr.DEFAULT_GEOM
CFG, JCFG = MapConfig(), JaxMapConfig()
T_ = torch.from_numpy


def _poses(seed, n):
    """Poses across the grid, a few outside it, and a few non-finite."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-26, 26, n).astype(np.float32)
    y = rng.uniform(-26, 26, n).astype(np.float32)
    yaw = rng.uniform(-180, 180, n).astype(np.float32)
    ox = rng.uniform(-2, 2, n).astype(np.float32)
    oy = rng.uniform(-2, 2, n).astype(np.float32)
    x[:3] = [np.nan, np.inf, 3e10]
    yaw[3] = np.nan
    ox[4] = np.nan
    beams = rng.uniform(0.0, 4.3, (n, 4, 8)).astype(np.float32)
    beams[rng.random(beams.shape) < 0.1] = np.nan
    en = rng.random(n) > 0.15
    return beams, x, y, yaw, ox, oy, en


@pytest.mark.parametrize("seed", range(2))
def test_make_rays_matches_jax(seed):
    beams, x, y, yaw, ox, oy, en = _poses(seed, 96)
    want = jax.jit(jax.vmap(lambda *a: jr.make_rays(*a, JCFG)))(
        beams, x, y, yaw, ox, oy, en)
    got = tr.make_rays(T_(beams), T_(x), T_(y), T_(yaw), T_(ox), T_(oy),
                       T_(en), CFG)
    assert np.asarray(want["valid"]).sum() > 1000
    for k in ("ex", "ey", "end_delta", "valid", "pcx", "pcy"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_world_to_cell_rounds_half_even_and_saturates_like_xla():
    v = np.array([0.25, 0.35, -0.25, -0.05, 0.05, np.nan, np.inf, -np.inf,
                  3e10, -3e10], np.float32)
    z = np.zeros_like(v)
    cj = jr.world_to_cell(jnp.asarray(v), jnp.asarray(v), z, z, 0.1)
    ct = tr.world_to_cell(T_(v), T_(v), T_(z), T_(z), 0.1)
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert ct[0][0] == 252 and ct[0][2] == 248   # 2.5 -> 2, -2.5 -> -2


def _random_case(seed, B=3):
    """test_pallas.py's random window case: full-range grids, beams up to
    4.2 m with NaNs, poses anywhere in +/-20 m, some quads disabled."""
    rng = np.random.default_rng(seed)
    padded = np.zeros((B, GEOM.prows, GEOM.pcols), np.int8)
    padded[:, GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500] = (
        rng.integers(-80, 81, size=(B, 500, 500)).astype(np.int8))
    beams = rng.uniform(0.03, 4.2, size=(B, 4, 8)).astype(np.float32)
    beams[rng.random((B, 4, 8)) < 0.1] = np.nan
    xs = rng.uniform(-20, 20, B).astype(np.float32)
    ys = rng.uniform(-20, 20, B).astype(np.float32)
    yaws = rng.uniform(-180, 180, B).astype(np.float32)
    en = rng.random(B) > 0.2
    return padded, beams, xs, ys, yaws, en


def _near_saturation_case():
    """test_pallas.py's ordering case: cells at the clamp bounds, short
    beams, so the per-step clamp order decides the result."""
    rng = np.random.default_rng(9)
    B = 2
    padded = np.zeros((B, GEOM.prows, GEOM.pcols), np.int8)
    padded[:, GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500] = rng.choice(
        np.array([-80, -79, 78, 79, 80], np.int8), size=(B, 500, 500))
    beams = rng.uniform(0.1, 1.2, size=(B, 4, 8)).astype(np.float32)
    z = np.zeros(B, np.float32)
    return padded, beams, z, z, z, np.ones(B, bool)


# one jitted JAX function for every case (jit only wraps here; it traces
# at the first call)
_jax_apply_scan = jax.jit(jax.vmap(
    lambda g, b, x, y, w, e: jr.apply_scan_to_grid(
        g, b, x, y, w, np.float32(0), np.float32(0), e, JCFG)))


@pytest.mark.parametrize("case", ["random0", "random1", "random2",
                                  "near_saturation"])
def test_apply_scan_to_grid_matches_jax(case):
    if case == "near_saturation":
        padded, beams, xs, ys, yaws, en = _near_saturation_case()
    else:
        padded, beams, xs, ys, yaws, en = _random_case(int(case[-1]))
    z = np.zeros(len(xs), np.float32)
    want = _jax_apply_scan(padded, beams, xs, ys, yaws, en)
    got = tr.apply_scan_to_grid(T_(padded), T_(beams), T_(xs), T_(ys),
                                T_(yaws), T_(z), T_(z), T_(en), CFG)
    want = np.asarray(want)
    assert (want != padded).sum() > 100            # the scans did land
    np.testing.assert_array_equal(got.numpy(), want)


def test_recenter_decide_and_shift_origin_match_jax():
    rng = np.random.default_rng(5)
    n = 64
    ox = rng.uniform(-30, 30, n).astype(np.float32)
    oy = rng.uniform(-30, 30, n).astype(np.float32)
    x = ox + rng.uniform(-40, 40, n).astype(np.float32)
    y = oy + rng.uniform(-20, 20, n).astype(np.float32)
    ok = rng.random(n) > 0.2
    ox[0] = np.nan                                  # before map init
    sj = jr.recenter_decide(jnp.asarray(ox), jnp.asarray(oy), jnp.asarray(x),
                            jnp.asarray(y), jnp.asarray(ok), JCFG)
    st = tr.recenter_decide(T_(ox), T_(oy), T_(x), T_(y), T_(ok), CFG)
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert st[2].sum() > 10 and st[0].abs().max() == 125   # clamped shifts
    res = np.float32(CFG.res_m)
    oj = jr.shift_origin(jnp.asarray(ox), sj[0], res)
    ot = tr.shift_origin(T_(ox), st[0], res)
    np.testing.assert_array_equal(ot.numpy().view(np.uint32),
                                  np.asarray(oj).view(np.uint32))


def test_recenter_apply_matches_jax():
    rng = np.random.default_rng(6)
    B = 5
    g = np.zeros((B, GEOM.prows, GEOM.pcols), np.int8)
    g[:, GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500] = rng.integers(
        -80, 81, (B, 500, 500)).astype(np.int8)
    sx = np.array([0, 3, -125, 125, -7], np.int32)
    sy = np.array([0, -2, 40, -125, 499], np.int32)
    want = jax.jit(jax.vmap(lambda a, b, c: jr.recenter_apply(a, b, c, JCFG)))(
        g, sx, sy)
    got = tr.recenter_apply(T_(g), T_(sx), T_(sy), CFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), g[0])     # (0, 0) no-op


def test_logical_and_new_padded_grid():
    g = tr.new_padded_grid(GEOM, (2,), "cpu")
    assert g.shape == (2, GEOM.prows, GEOM.pcols) and g.dtype == torch.int8
    assert tr.logical_grid(g).shape == (2, 500, 500)
    assert tr.GridGeom.from_map(CFG) == GEOM
    assert TofConfig().max_range_m / CFG.res_m < GEOM.win_r


def _frontier_case(seed, B=12):
    """Random grids holding unknown, free and occupied cells; poses across
    the grid and within 2 m of its edge (rays leave it), origins off zero,
    two quads not inited."""
    rng = np.random.default_rng(seed)
    g = np.zeros((B, GEOM.prows, GEOM.pcols), np.int8)
    g[:, GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500] = rng.choice(
        np.array([-40, -11, -10, -1, 0, 1, 2, 10, 11, 60], np.int8),
        size=(B, 500, 500))
    ox = rng.uniform(-3, 3, B).astype(np.float32)
    oy = rng.uniform(-3, 3, B).astype(np.float32)
    x = ox + rng.uniform(-20, 20, B).astype(np.float32)
    y = oy + rng.uniform(-20, 20, B).astype(np.float32)
    x[:4] = ox[:4] + np.float32(24.0) * np.float32([1, -1, 1, -1])
    y[2:6] = oy[2:6] + np.float32([-23.5, 24.5, 23.9, -24.8])
    yaw = rng.uniform(-180, 180, B).astype(np.float32)
    inited = np.ones(B, bool)
    inited[[1, 7]] = False
    return g, x, y, yaw, ox, oy, inited


@pytest.mark.parametrize("seed", range(2))
def test_frontier_scores_match_jax(seed):
    g, x, y, yaw, ox, oy, inited = _frontier_case(seed)
    offs = (0.0, 90.0, -90.0, 180.0)
    want = jax.jit(jax.vmap(lambda *a: jr.frontier_scores(
        a[0], a[1], a[2], a[3], offs, a[4], a[5], a[6], JCFG)))(
        g, x, y, yaw, ox, oy, inited)
    got = tr.frontier_scores(T_(g), T_(x), T_(y), T_(yaw), offs, T_(ox),
                             T_(oy), T_(inited), CFG)
    assert got.dtype == torch.int32 and got.shape == (len(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[[1, 7]] == 0).all() and (got != 0).sum() > 30
    np.testing.assert_array_equal(tr._frontier_step_dists(CFG),
                                  jr._frontier_step_dists(JCFG))


def test_recenter_grid_matches_jax():
    rng = np.random.default_rng(8)
    B = 4
    g = np.zeros((B, GEOM.prows, GEOM.pcols), np.int8)
    g[:, GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500] = rng.integers(
        -80, 81, (B, 500, 500)).astype(np.int8)
    ox = np.float32([0.0, 1.5, -2.0, 0.3])
    oy = np.float32([0.0, -0.5, 3.0, 0.1])
    x = ox + np.float32([20.0, -19.0, 3.0, 31.0])
    y = oy + np.float32([2.0, 18.0, -25.0, 0.0])
    ok = np.array([True, True, True, False])
    want = jax.vmap(lambda *a: jr.recenter_grid(*a, JCFG))(
        g, ox, oy, x, y, ok)
    got = tr.recenter_grid(T_(g), T_(ox), T_(oy), T_(x), T_(y), T_(ok), CFG)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[3].tolist() == [True, True, True, False]


def _map_step_case():
    """tests/test_pallas.py:421-451's inputs: random grids in [-80, 80],
    beams up to 4.2 m with 15% NaN, the last two poses over the grid edge,
    quad 3 disabled."""
    rng = np.random.default_rng(3)
    B = 8
    grids = rng.integers(-80, 81, (B, GEOM.prows, GEOM.pcols)).astype(np.int8)
    beams = rng.uniform(0.1, 4.2, (B, 4, 8)).astype(np.float32)
    beams[rng.random((B, 4, 8)) < 0.15] = np.nan
    x = rng.uniform(-20, 20, B).astype(np.float32)
    y = rng.uniform(-20, 20, B).astype(np.float32)
    x[-2:] = rng.uniform(24.0, 26.0, 2)
    yaw = rng.uniform(-180, 180, B).astype(np.float32)
    z = np.zeros(B, np.float32)
    en = np.ones(B, bool)
    en[3] = False
    return grids, [beams, x, y, yaw, z, z, en]


def test_map_step_plain_matches_pallas_map_step_and_xla():
    """map_step_plain (and map_step, which takes it for CPU tensors) ==
    the JAX package's pallas_map_step in interpret mode == its vmapped
    apply_scan_to_grid, on the TPU kernel's own test inputs."""
    from micro_quad_slam_tpu.ops.pallas_residentx import pallas_map_step
    from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
    from micro_quad_slam_tpu_torch.ops import residentx as rx
    from micro_quad_slam_tpu_torch.utils import obs
    from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE

    grids, args = _map_step_case()
    want = np.asarray(jax.jit(lambda *a: pallas_map_step(
        *a, JAX_UL, jr.DEFAULT_GEOM, interpret=True))(grids, *args))
    xla = np.asarray(jax.jit(jax.vmap(lambda g, b, x, y, w, ox, oy, e:
                                      jr.apply_scan_to_grid(
                                          g, b, x, y, w, ox, oy, e, JCFG)))(
        grids, *args))
    np.testing.assert_array_equal(want, xla)
    targs = [T_(a) for a in args]
    got = rx.map_step_plain(T_(grids.copy()), *targs, UL_PROFILE)
    np.testing.assert_array_equal(got.numpy(), want)
    before = obs.counters().get("launches.map_step", 0)
    np.testing.assert_array_equal(
        rx.map_step(T_(grids.copy()), *targs, UL_PROFILE).numpy(), want)
    # the CPU path launches none
    assert obs.counters().get("launches.map_step", 0) == before
    np.testing.assert_array_equal(want[3], grids[3])        # disabled
    np.testing.assert_array_equal(want[-2:], grids[-2:])    # over the edge
    assert (want != grids).sum() > 500
    meta = torch.zeros((8, GEOM.prows, GEOM.pcols), dtype=torch.int8,
                       device="meta")
    with pytest.raises(ValueError, match="no map step kernel"):
        rx.map_step(meta, *[a.to("meta") for a in targs], UL_PROFILE)


@pytest.mark.parametrize("kernel", ["pallas", "pallas_db"])
def test_mapping_step_pallas_routes_equal_xla(kernel):
    """mapping_step with the JAX package's per-frame kernel names goes
    through map_step (its plain version on the CPU) and equals "xla" step
    by step, recenters and gated frames included."""
    import micro_quad_slam_tpu_torch as port
    from micro_quad_slam_tpu_torch import testdata
    from micro_quad_slam_tpu_torch.replay.mapping import mapping_step

    f, _ = testdata.load("random_flights")
    frames = port.frames_to_torch({k: v[:3, :40] for k, v in f.items()},
                                  "cpu")
    sa = sb = port.mapping_init(3, device="cpu")
    recentered = 0
    for t in range(40):
        fr = {k: v[:, t] for k, v in frames.items()}
        sa, oa = mapping_step(sa, fr, kernel=kernel)
        sb, ob = mapping_step(sb, fr, kernel="xla")
        for x, y in zip(sa, sb):
            assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0))
        assert all(torch.equal(oa[k], ob[k]) for k in oa)
        recentered += int(oa["kf_flags"].ne(0).sum())
    assert recentered >= 1 and int(sa.grid.ne(0).sum()) > 1000


def test_sqrt_and_div_f32_round_once_as_numpy():
    """sqrt_f32 and div_f32 give the correctly rounded float32 result (as
    numpy's float32 sqrt and division do): the rounding the card's and the
    CPU's float32 sqrt, and CUDA's product by a reciprocal, can each miss
    by a last bit."""
    rng = np.random.default_rng(0)
    a = (rng.random(200_000) * rng.choice([1e-6, 1.0, 1e4], 200_000)
         ).astype(np.float32)
    np.testing.assert_array_equal(tr.sqrt_f32(torch.from_numpy(a)).numpy(),
                                  np.sqrt(a))
    x = rng.normal(0, 10, 200_000).astype(np.float32)
    for d in (0.05, 3.0, 1000.0, 2 * np.pi):
        np.testing.assert_array_equal(
            tr.div_f32(torch.from_numpy(x), float(np.float32(d))).numpy(),
            x / np.float32(d))
