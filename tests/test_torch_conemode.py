"""PyTorch port, ops/conemode.py: the dense inverse sensor model (cone
mode) and the hybrid update, held against the JAX package's
micro_quad_slam_tpu/ops/conemode.py on the same seeded numpy inputs, and
against the floors of tests/test_conemode.py.

Tolerances: packed returns, classifier deltas and grids are compared bit
for bit.  The fan vectors are allowed 1 ulp: the port's trig is the
correctly rounded float32 cos/sin (via float64), XLA-CPU's float32 cos/sin
are not correctly rounded (test_fan_vectors_match_jax_within_one_ulp).
The scan updates, which use each package's own fan vectors, are still
bit-equal on every input here, the tie-prone poses on an exact cell
centre at yaw 0, 45 and 90 degrees included."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from micro_quad_slam_tpu.golden import compute_beams_and_minima
from micro_quad_slam_tpu.ops import conemode as jc
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import MapConfig as JaxMapConfig
from micro_quad_slam_tpu.utils.config import TofConfig as JaxTofConfig
from micro_quad_slam_tpu_torch.ops import conemode as tc
from micro_quad_slam_tpu_torch.ops import raycast as tr
from micro_quad_slam_tpu_torch.utils.config import MapConfig, TofConfig

torch.set_num_threads(2)

CFG, TOF = MapConfig(), TofConfig()
JCFG, JTOF = JaxMapConfig(), JaxTofConfig()
GEOM = tr.DEFAULT_GEOM
T_ = torch.from_numpy
F32 = np.float32


def _assert_bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                  err_msg=what)


def _beams(seed, n):
    """Beams across the whole range: no return (NaN), <= 5 cm, hits,
    misses at and beyond max range."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(0.0, 4.4, (n, 4, 8)).astype(np.float32)
    pick = rng.random(b.shape)
    b[pick < 0.08] = np.nan
    b[(pick >= 0.08) & (pick < 0.12)] = F32(0.05)
    b[(pick >= 0.12) & (pick < 0.16)] = F32(3.95)
    b[(pick >= 0.16) & (pick < 0.20)] = F32(4.0)
    return b


def _yaws(seed, n):
    rng = np.random.default_rng(seed)
    y = rng.uniform(-180, 180, n).astype(np.float32)
    special = [0.0, 45.0, 90.0, -90.0, 180.0, -180.0, 31.5, -135.0]
    y[:len(special)] = special[:n]
    return y


@pytest.mark.parametrize("seed", range(2))
def test_pack_and_smooth_match_jax(seed):
    b32 = _beams(seed, 64).reshape(64, 32)
    jp = jax.vmap(lambda b: jc.pack_beams(b, JTOF))(jnp.asarray(b32))
    tp = tc.pack_beams(T_(b32), TOF)
    _assert_bits(tp.numpy(), jp, "pack_beams")
    js = jax.vmap(lambda p: jc.smooth_carve_returns(p, JTOF))(jp)
    _assert_bits(tc.smooth_carve_returns(tp, TOF).numpy(), js, "smooth")


@pytest.mark.parametrize("fn", ["fan_bounds", "fan_centers"])
def test_fan_vectors_match_jax_within_one_ulp(fn):
    """The port's fan vectors are the correctly rounded float32 cos/sin
    (float64, rounded), the same on the CPU and the card.  XLA-CPU's
    float32 cos/sin are not correctly rounded: on ~1.4% of these angles
    they differ by 1 ulp, never more.  So 1 ulp is allowed here; the
    scan updates and replays below, which use each package's own
    vectors, are still bit-equal on every test input."""
    yaw = _yaws(3, 512)
    j = np.asarray(jax.vmap(lambda y: jnp.stack(getattr(jc, fn)(y, JTOF)))(
        jnp.asarray(yaw)))
    t = getattr(tc, fn)(T_(yaw), TOF).numpy()
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
    ulps = np.abs(t.view(np.int32).astype(np.int64)
                  - j.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert (ulps == 0).mean() > 0.95
    # yaw 0 and 90 degrees bit-equal; at yaw 45 the fan's middle boundary
    # lies on the diagonal, where a 1-ulp cos/sin skew would flip cells
    _assert_bits(t[[0, 2]], j[[0, 2]], fn)
    if fn == "fan_bounds":
        _assert_bits(t[1, 8:10], j[1, 8:10], fn)


def _cell_inputs(seed, n, hybrid=False):
    """Per-scan classifier inputs: offsets with a sub-cell fraction, a
    quarter of them on an exact cell centre (fraction 0) at yaw 0/45/90;
    the fan bounds, centres and packed returns come from the JAX
    functions so that only the classifier is compared."""
    rng = np.random.default_rng(seed)
    frac = rng.uniform(-0.5, 0.5, (2, n)).astype(np.float32)
    frac[:, : n // 4] = 0.0
    yaw = _yaws(seed, n)
    yaw[: n // 4] = np.resize(np.array([0.0, 45.0, 90.0], np.float32), n // 4)
    R = F32(GEOM.win_r)
    oxc, oyc = -R - frac[0], -R - frac[1]
    bounds = np.array(jax.vmap(
        lambda y: jnp.stack(jc.fan_bounds(y, JTOF)))(jnp.asarray(yaw)))
    centers = np.array(jax.vmap(
        lambda y: jnp.stack(jc.fan_centers(y, JTOF)))(jnp.asarray(yaw)))
    packed = jax.vmap(lambda b: jc.pack_beams(b, JTOF))(
        jnp.asarray(_beams(seed + 10, n).reshape(n, 32)))
    if hybrid:
        packed = jax.vmap(lambda p: jc.smooth_carve_returns(p, JTOF))(packed)
    return oxc, oyc, bounds, centers, np.array(packed)


@pytest.mark.parametrize("occ_band", [True, False])
@pytest.mark.parametrize("ray_matched", [False, True])
def test_cone_cell_delta_matches_jax(occ_band, ray_matched):
    n = 24
    oxc, oyc, bounds, centers, packed = _cell_inputs(7, n, not occ_band)
    cone = tc.ConeConfig(ray_match_w_cells=0.7 if ray_matched else 0.0)
    jcone = jc.ConeConfig(ray_match_w_cells=0.7 if ray_matched else 0.0)
    rowsf = np.arange(GEOM.win_rows, dtype=np.float32)[:, None]
    colsf = np.arange(GEOM.win_cols, dtype=np.float32)[None, :]

    def one(ox, oy, b, p, c):
        return jc.cone_cell_delta(
            jnp.asarray(rowsf), jnp.asarray(colsf), ox, oy, JCFG.res_m,
            tuple(b[i] for i in range(18)), [p[i] for i in range(32)], JTOF,
            jcone, with_occ_band=occ_band,
            centers=c if ray_matched else None)

    want = np.asarray(jax.vmap(one)(*map(jnp.asarray, (oxc, oyc, bounds,
                                                       packed, centers))))
    got = tc.cone_cell_delta(T_(rowsf), T_(colsf), T_(oxc), T_(oyc),
                             CFG.res_m, T_(bounds), T_(packed), TOF, cone,
                             with_occ_band=occ_band,
                             centers=T_(centers) if ray_matched else None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).sum() > 1000
    assert (want == 6).sum() > (50 if occ_band else -1)


def _scan_case(seed, n):
    """Poses over the grid (some outside it, some disabled), a quarter of
    them on an exact cell centre at yaw 0/45/90, and a random grid."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-26, 26, n).astype(np.float32)
    y = rng.uniform(-26, 26, n).astype(np.float32)
    ox = rng.uniform(-2, 2, n).astype(np.float32)
    oy = rng.uniform(-2, 2, n).astype(np.float32)
    q = n // 4
    x[:q] = np.round(rng.uniform(-20, 20, q)).astype(np.float32)
    y[:q] = np.round(rng.uniform(-20, 20, q)).astype(np.float32)
    ox[:q] = 0.0
    oy[:q] = 0.0
    yaw = _yaws(seed, n)
    yaw[:q] = np.resize(np.array([0.0, 45.0, 90.0], np.float32), q)
    en = rng.random(n) > 0.1
    grid = rng.integers(-80, 81, (n, GEOM.prows, GEOM.pcols)).astype(np.int8)
    grid[:, :GEOM.pad] = 0
    grid[:, GEOM.pad + CFG.height:] = 0
    grid[:, :, :GEOM.pad] = 0
    grid[:, :, GEOM.pad + CFG.width:] = 0
    return grid, _beams(seed + 20, n), x, y, yaw, ox, oy, en


@pytest.mark.parametrize("mode", ["cone", "hybrid"])
@pytest.mark.parametrize("seed", range(2))
def test_scan_update_matches_jax(mode, seed):
    args = _scan_case(seed, 12)
    jfn = {"cone": jc.cone_scan_update, "hybrid": jc.hybrid_scan_update}[mode]
    want = jax.vmap(lambda g, b, x, y, yaw, ox, oy, en: jfn(
        g, b, x, y, yaw, ox, oy, en, JCFG, JTOF))(*map(jnp.asarray, args))
    tfn = {"cone": tc.cone_scan_update, "hybrid": tc.hybrid_scan_update}[mode]
    got = tfn(*map(T_, args), CFG, TOF)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.equal(got, T_(args[0]))


def test_hybrid_pose_cell_piles_up_endpoints():
    """Every zone at 51 mm, pose on a cell centre at yaw 45: most of the 32
    rays end in the pose cell, whose endpoint sum (+192) saturates in one
    scan, exactly as in the JAX package."""
    args = list(_scan_case(5, 2))
    args[1] = np.full((2, 4, 8), F32(0.051), np.float32)
    for i in (2, 3, 5, 6):
        args[i] = np.zeros(2, np.float32)
    args[4] = np.full(2, 45.0, np.float32)
    args[7] = np.ones(2, bool)
    args[0][:] = 0
    want = jax.vmap(lambda g, b, x, y, yaw, ox, oy, en: jc.hybrid_scan_update(
        g, b, x, y, yaw, ox, oy, en, JCFG, JTOF))(*map(jnp.asarray, args))
    got = tc.hybrid_scan_update(*map(T_, args), CFG, TOF)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = GEOM.pad + CFG.width // 2
    assert int(got[0, c, c]) == CFG.lo_max


# ---- the floors of tests/test_conemode.py, on the port

def _room_beams(room=(-2.0, -2.0, 2.0, 2.0)):
    log = synth_room_scanlog(n_frames=1, room=room, path="hover")
    beams, _ = compute_beams_and_minima(log.grid_mm[0])
    return T_(np.asarray(beams, np.float32))[None]


def _cone(padded, beams, yaw=0.0, x=0.0, enabled=True):
    z = torch.zeros(1, dtype=torch.float32)
    return tc.cone_scan_update(padded, beams, z + x, z, z + yaw, z, z,
                               torch.tensor([enabled]), CFG, TOF)


def _grid():
    return tr.new_padded_grid(batch=(1,), device="cpu")


def _logical(padded):
    return tr.logical_grid(padded[0]).numpy()


def test_cone_marks_walls_and_carves_free():
    g = _logical(_cone(_grid(), _room_beams()))
    occ, free = np.argwhere(g > 0), np.argwhere(g < 0)
    assert len(occ) > 30 and len(free) > 800
    d = np.abs(occ - 250).max(axis=1)
    assert d.min() >= 18 and d.max() <= 22
    assert np.abs(free - 250).max(axis=1).max() <= 21


def test_cone_denser_than_bresenham():
    beams = _room_beams(room=(-3.5, -3.5, 3.5, 3.5))
    cone_g = _logical(_cone(_grid(), beams))
    z = torch.zeros(1, dtype=torch.float32)
    bres = tr.apply_scan_to_grid(_grid(), beams, z, z,
                                 z, z, z, torch.tensor([True]), CFG, TOF)
    assert (cone_g != 0).sum() > 2.5 * (_logical(bres) != 0).sum()


def test_cone_respects_gating_and_pose_bounds():
    beams = _room_beams()
    assert not _logical(_cone(_grid(), beams,
                              enabled=False)).any()
    assert not _logical(_cone(_grid(), beams,
                              x=60.0)).any()


def test_cone_yaw_rotates_the_fans():
    beams = torch.full((1, 4, 8), float("nan"))
    beams[0, 0] = 1.5
    occ0 = np.argwhere(_logical(_cone(_grid(),
                                      beams)) > 0)
    occ90 = np.argwhere(_logical(_cone(_grid(), beams,
                                       yaw=90.0)) > 0)
    assert (occ0[:, 1] > 250).all() and (occ90[:, 0] > 250).all()


def test_cone_accumulates_and_clamps():
    beams = _room_beams()
    padded = _grid()
    for _ in range(20):
        padded = _cone(padded, beams)
    g = _logical(padded)
    assert g.max() == 80 and g.min() == -20   # 20 scans x (-1) free
    assert g.min() >= CFG.lo_min and g.max() <= CFG.lo_max


def test_hybrid_occupied_matches_exact_reference():
    """Hybrid replay against the exact one on three moving flights: the
    occupied set agrees at zero cell tolerance (occ-IoU >= 0.95), free
    IoU >= 0.60 (the dense carve marks more free cells than 32 one-cell
    rays).  map_divergence is the JAX package's (numpy)."""
    import micro_quad_slam_tpu_torch as port
    from micro_quad_slam_tpu.utils.obs import map_divergence

    logs = [synth_room_scanlog(n_frames=120, seed=s, path=p, noise_mm=5.0,
                               dropout_p=0.02)
            for s, p in ((0, "circle"), (1, "hover"), (2, "line"))]
    fr = [port.scanlog_to_arrays(lg) for lg in logs]
    frames = port.frames_to_torch(
        {k: np.stack([f[k] for f in fr]) for k in fr[0]}, "cpu")
    st_exact, _ = port.replay_mapping_batched(frames, port.UL_PROFILE,
                                              kernel="residentx")
    st_h, _ = port.replay_mapping_batched(frames, port.UL_PROFILE,
                                          kernel="hybridx")
    ge = tr.logical_grid(st_exact.grid).numpy()
    gh = tr.logical_grid(st_h.grid).numpy()
    for b in range(len(logs)):
        div = map_divergence(ge[b], gh[b])
        assert div["iou_occupied"] >= 0.95, (b, div)
        assert div["iou_free"] >= 0.60, (b, div)
        assert div["touched_cells"] > 500
