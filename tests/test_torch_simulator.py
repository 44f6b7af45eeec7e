"""PyTorch port, models/simulator.py: the closed-loop swarm simulator
against the JAX package's, from the same start state with the same scan
draws (the JAX key chain replayed, tests/test_torch_testdata.py::
jax_scan_draws), and the port's own mission properties.

Tolerances: integer outputs (behaviour states, cmd_kind, frontier scores,
scan counts, grids) are held equal.  Floats (true poses, EKF means,
altitudes) within FLOAT_TOL = 1e-4: XLA-CPU contracts products and sums
into fmas (the dynamics' x + vx*dt, the EKF) and its float32 trig is off
by an ulp on some angles, the port does neither; over the runs here they
drift apart by a few ulps (~1e-6 m at most).  The raw ToF cells are
within 1 mm, on at most CELL_SHARE of them: a wall distance an ulp apart
now and then rounds, with its noise, to the next millimetre; no such
millimetre moved a beam's cell on these runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_quad_slam_tpu.formats import scanlog as jscanlog
from micro_quad_slam_tpu.models import simulator as JS
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.formats import scanlog as tscanlog
from micro_quad_slam_tpu_torch.models import behavior as tb
from micro_quad_slam_tpu_torch.models import simulator as S
from micro_quad_slam_tpu_torch.ops.raycast import logical_grid
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE
from test_torch_testdata import flatten_state, jax_scan_draws

torch.set_num_threads(2)

FLOAT_TOL = 1e-4
CELL_SHARE = 1e-4
ROOM = dict(room=(-3.5, -3.5, 3.5, 3.5), obstacles=[(1.5, -0.5, 2.5, 0.5)])
B, T, DT = 4, 400, 20
T_ = torch.from_numpy


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_draws(key, n_steps):
    return [(T_(n.copy()), T_(u.copy()))
            for n, u in jax_scan_draws(key, n_steps, DT, 100, B)]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX simulator, B=4 x 400 ticks at 50 Hz, recorded: an airborne
    start (PRNGKey(7)), a ground start (PRNGKey(3)), and the airborne
    run continued 400 more ticks from its end state (one compile)."""
    world = JS.make_world(B, **ROOM)
    run = jax.jit(lambda st: JS.sim_run(st, world, T, JAX_UL, dt_ms=DT,
                                        record=True))
    out = {}
    for name, key, air in (("airborne", 7, True), ("ground", 3, False)):
        st = JS.sim_init(B, jax.random.PRNGKey(key), spread_m=0.5,
                         airborne=air)
        fin, diag = run(st)
        out[name] = (st, _np(fin), _np(diag))
    fin = out["airborne"][1]
    st = jax.tree_util.tree_map(jnp.asarray, fin)
    fin2, diag2 = run(st)
    out["resumed"] = (st, _np(fin2), _np(diag2))
    return out


def _port_run(jax_start, record=True):
    st = S.sim_state_from_numpy(_np(jax_start), "cpu")
    world = S.make_world(B, **ROOM, device="cpu")
    return S.sim_run(st, world, T, UL_PROFILE, dt_ms=DT, record=record,
                     draws=_torch_draws(jax_start.key, T))


def _assert_run_equal(fin, diag, jfin, jdiag):
    for k in ("state", "cmd_kind", "req_mode", "req_arm", "kf_flags",
              "scan_due"):
        np.testing.assert_array_equal(diag[k].numpy(), jdiag[k].astype(
            diag[k].numpy().dtype), err_msg=k)
    cells = np.abs(diag["cells"].numpy() - jdiag["cells"].astype(np.int32))
    assert cells.max() <= 1 and (cells != 0).mean() <= CELL_SHARE
    np.testing.assert_array_equal(fin.mapper.grid.numpy(), jfin.mapper.grid)
    np.testing.assert_array_equal(fin.frontier.numpy(), jfin.frontier)
    np.testing.assert_array_equal(fin.mapper.inited.numpy(),
                                  jfin.mapper.inited)
    assert fin.scan_count == int(jfin.scan_count)
    assert fin.t_ms == int(jfin.t_ms)
    for k in ("x", "y", "yaw", "alt", "vx", "vy"):
        np.testing.assert_allclose(getattr(fin, k).numpy(), getattr(jfin, k),
                                   rtol=0, atol=FLOAT_TOL, err_msg=k)
    np.testing.assert_allclose(fin.ekf.mean.numpy(), jfin.ekf.mean, rtol=0,
                               atol=FLOAT_TOL)
    for k in ("alt", "pose_err", "est_x", "est_y", "cmd"):
        np.testing.assert_allclose(diag[k].numpy(), jdiag[k], rtol=0,
                                   atol=FLOAT_TOL, err_msg=k)


@pytest.mark.parametrize("start", ["airborne", "ground", "resumed"])
def test_closed_loop_equals_jax(jax_runs, start):
    """From the JAX start state with the JAX draws ("resumed": a JAX end
    state continued in the port)."""
    jst, jfin, jdiag = jax_runs[start]
    fin, diag = _port_run(jst)
    _assert_run_equal(fin, diag, jfin, jdiag)
    assert fin.scan_count - int(jst.scan_count) == T * DT // 100
    states = set(np.unique(jdiag["state"]).tolist())
    if start == "ground":
        assert {tb.ST_TAKEOFF, tb.ST_HOVER, tb.ST_EXPLORE} <= states
    assert int((fin.mapper.grid < -10).sum()) > 300


def test_recorded_run_converts_to_scanlogs_like_jax(jax_runs, tmp_path):
    """sim_diag_to_scanlogs on the JAX run's diagnostics equals the JAX
    conversion field for field, and the port's writer gives the JAX
    writer's bytes; the port's own recorded run converts to the same
    integer fields (its raw cells are held within 1 mm by
    test_closed_loop_equals_jax)."""
    _, _, jdiag = jax_runs["ground"]
    want = JS.sim_diag_to_scanlogs(jdiag)
    got = S.sim_diag_to_scanlogs(jdiag)
    assert len(got) == len(want) == B
    for g, w in zip(got, want):
        assert len(g) == len(w) == T * DT // 100
        for k in w.__dataclass_fields__:
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    pj, pt = tmp_path / "j.bin", tmp_path / "t.bin"
    jscanlog.write_scanlog(str(pj), want[1])
    tscanlog.write_scanlog(str(pt), got[1])
    assert pt.read_bytes() == pj.read_bytes()
    back = tscanlog.read_scanlog(str(pt))
    np.testing.assert_array_equal(back.grid_mm, want[1].grid_mm)
    own = S.sim_diag_to_scanlogs(_port_run(jax_runs["ground"][0])[1])
    for g, w in zip(own, want):
        for k in ("host_ms", "state", "kf_flags", "of_q"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k),
                                          err_msg=k)
        assert g.kf_flags.any()


def test_committed_small_swarm_reproduced_on_the_cpu():
    """swarm_small_jax: bench.py's swarm at B=8, T=1000, dt 1 ms, its start
    state and draws, run by the port."""
    world, st, draws, ref = testdata.swarm_small("cpu")
    fin, diag = S.sim_run(st, world, testdata.SWARM_T, UL_PROFILE,
                          record=True, draws=draws, **testdata.SWARM_RUN)
    np.testing.assert_array_equal(diag["state"].numpy(), ref["state"])
    np.testing.assert_array_equal(diag["cmd_kind"].numpy(), ref["cmd_kind"])
    np.testing.assert_array_equal(fin.mapper.grid.numpy(), ref["grid"])
    np.testing.assert_array_equal(fin.frontier.numpy(), ref["frontier"])
    assert fin.scan_count == int(ref["scan_count"]) == 10
    for k in ("x", "y", "yaw"):
        np.testing.assert_allclose(getattr(fin, k).numpy(), ref[k], rtol=0,
                                   atol=FLOAT_TOL, err_msg=k)
    np.testing.assert_allclose(fin.ekf.mean.numpy(), ref["ekf_mean"], rtol=0,
                               atol=FLOAT_TOL)
    assert int((fin.mapper.grid < -10).sum()) > 8 * 20


def test_ray_distances_equal_jax():
    """tests/test_simulator.py:27-42's rooms, then random poses and
    angles with an obstacle: within 1e-5 m (an ulp of trig)."""
    w = S.make_world(1, room=(-2.0, -3.0, 2.0, 3.0), device="cpu")
    z = torch.zeros(1)
    d = S.ray_distances(w, z, z, torch.tensor([[0.0, np.pi / 2, np.pi,
                                                -np.pi / 2]]))
    np.testing.assert_allclose(d[0].numpy(), [2.0, 3.0, 2.0, 3.0], atol=1e-5)
    w = S.make_world(1, room=(-4.0, -4.0, 4.0, 4.0),
                     obstacles=[(1.0, -0.5, 2.0, 0.5)], device="cpu")
    d = S.ray_distances(w, z, z, torch.tensor([[0.0, np.pi]]))
    np.testing.assert_allclose(d[0].numpy(), [1.0, 4.0], atol=1e-5)

    rng = np.random.default_rng(4)
    n = 64
    x, y = (rng.uniform(-3.3, 3.3, n).astype(np.float32) for _ in range(2))
    ang = rng.uniform(-4, 4, (n, 32)).astype(np.float32)
    ang[0, :4] = [0.0, np.pi / 2, np.pi, -np.pi / 2]
    want = jax.jit(JS.ray_distances)(JS.make_world(n, **ROOM), x, y, ang)
    got = S.ray_distances(S.make_world(n, **ROOM, device="cpu"), T_(x),
                          T_(y), T_(ang))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_synth_scan_equals_jax():
    """Noiseless cells equal (tests/test_simulator.py:45-51's case, plus
    random poses); with the JAX package's noise and dropout draws handed
    in, within 1 mm on at most 0.1% of the zones: XLA-CPU's trig can
    differ by an ulp, and a noisy value then rounds to the next mm."""
    w = S.make_world(2, room=(-3.0, -3.0, 3.0, 3.0), device="cpu")
    z = torch.zeros(2)
    c = S.synth_scan_mm(w, z, z, z, None, None, 0.0, 0.0, UL_PROFILE)
    assert c.shape == (2, 4, 8, 8)
    assert abs(int(c[0, 0, 0, 3]) - 3000 / np.cos(np.radians(4.5))) < 2

    rng = np.random.default_rng(5)
    n = 128
    x, y = (rng.uniform(-3.3, 3.3, n).astype(np.float32) for _ in range(2))
    yaw = rng.uniform(-180, 180, n).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jw, tw = JS.make_world(n, **ROOM), S.make_world(n, **ROOM, device="cpu")
    (normal, uniform), = jax_scan_draws(key, 1, 100, 100, n)
    k_scan = jax.random.split(key)[1]
    for noise, drop in ((0.0, 0.0), (5.0, 0.02)):
        want = np.asarray(jax.jit(lambda *a: JS.synth_scan_mm(
            jw, *a, k_scan, noise, drop, JAX_UL))(x, y, yaw)).astype(np.int32)
        got = S.synth_scan_mm(tw, T_(x), T_(y), T_(yaw), T_(normal.copy()),
                              T_(uniform.copy()), noise, drop,
                              UL_PROFILE).numpy()
        diff = np.abs(got - want)
        if noise == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
            assert (got == 0xFFFF).mean() > 0.01       # dropouts landed


def test_sim_init_airborne_equals_jax_field_for_field():
    """Every field, dtype and shape of the port's sim_init(airborne=True)
    is the JAX package's; the values that come from the random start
    poses follow them as in the JAX package, the rest are equal.  And the
    JAX state passes through sim_state_from_numpy / _to_numpy intact."""
    jst = _np(JS.sim_init(B, jax.random.PRNGKey(0), spread_m=0.5,
                          airborne=True))
    want = flatten_state(jst)
    got = flatten_state(_NT(S.sim_state_to_numpy(
        S.sim_init(B, 0, spread_m=0.5, airborne=True, device="cpu"))))
    assert set(got) == set(want)
    drawn = {"x", "y", "yaw", "beh.yaw_t", "beh.hover_x", "beh.hover_y",
             "beh.hover_yaw", "mapper.origin_x", "mapper.origin_y",
             "ekf.mean"}
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k not in drawn:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    for s in (got, want):
        for k in ("beh.hover_x", "mapper.origin_x"):
            np.testing.assert_array_equal(s[k], s["x"])
        for k in ("beh.hover_y", "mapper.origin_y"):
            np.testing.assert_array_equal(s[k], s["y"])
        np.testing.assert_array_equal(s["beh.yaw_t"], s["yaw"])
        np.testing.assert_array_equal(s["ekf.mean"][:, :2],
                                      np.stack([s["x"], s["y"]], -1))
        np.testing.assert_allclose(s["ekf.mean"][:, 6], np.deg2rad(s["yaw"]),
                                   rtol=1e-6)
        assert (np.abs(s["x"]) <= 0.5).all()
    back = flatten_state(_NT(S.sim_state_to_numpy(
        S.sim_state_from_numpy(jst, "cpu"))))
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


class _NT:
    """A nested dict seen as nested NamedTuples (for flatten_state)."""

    def __init__(self, d):
        self._d = d

    def _asdict(self):
        return {k: _NT(v) if isinstance(v, dict) else v
                for k, v in self._d.items()}


def test_lanes_of_a_run_equal_the_run_of_those_lanes():
    """Quads are independent: lanes 1 and 3 of a B=4 run on the state's
    own generator equal a B=2 run of those lanes with their part of the
    draws (how tests/test_torch_testdata.py checks swarm_bench_ref)."""
    world = S.make_world(4, **ROOM, device="cpu")
    st = S.sim_init(4, 5, spread_m=0.5, airborne=True, device="cpu")
    gen = S.fork_generator(st.gen)
    n_steps = 200
    draws = [tuple(d[[1, 3]] for d in S.scan_draws(gen, 4))
             for _ in range(n_steps * DT // 100)]
    fin, diag = S.sim_run(st, world, n_steps, UL_PROFILE, dt_ms=DT)
    sub, sdiag = S.sim_run(S.select_lanes(st, [1, 3]),
                           S.select_lanes(world, [1, 3]), n_steps,
                           UL_PROFILE, dt_ms=DT, draws=draws)
    assert torch.equal(sub.mapper.grid, fin.mapper.grid[[1, 3]])
    assert torch.equal(sdiag["state"], diag["state"][:, [1, 3]])
    assert torch.equal(sub.x, fin.x[[1, 3]])
    # the run left its start state (and its generator) as they were
    again, _ = S.sim_run(st, world, n_steps, UL_PROFILE, dt_ms=DT)
    assert torch.equal(again.mapper.grid, fin.mapper.grid)


def test_swarm_mission_builds_maps():
    """tests/test_simulator.py:54-74 on the port: a ground start flies the
    mission (30 s at 50 Hz), maps from self-localized poses, and keeps
    its EKF pose within 5 cm."""
    n = 8
    world = S.make_world(n, **ROOM, device="cpu")
    st = S.sim_init(n, 7, spread_m=0.5, device="cpu")
    st, diag = S.sim_run(st, world, 1500, UL_PROFILE)
    states = diag["state"].numpy()
    for s in (tb.ST_TAKEOFF, tb.ST_HOVER, tb.ST_EXPLORE):
        assert (states == s).any(), f"state {s} never reached"
    assert bool(st.mapper.inited.all())
    grids = logical_grid(st.mapper.grid).numpy()
    occ = (grids > 10).reshape(n, -1).sum(axis=1)
    free = (grids < -10).reshape(n, -1).sum(axis=1)
    assert (occ > 10).all(), occ
    assert (free > 300).all(), free
    pe = diag["pose_err"][-1].numpy()
    assert (pe < 0.05).all(), pe
    assert st.scan_count == 1500 * 20 // 100


def test_airborne_start_maps_from_first_scan():
    """tests/test_simulator.py:77-95 on the port."""
    world = S.make_world(B, room=(-3.5, -3.5, 3.5, 3.5), device="cpu")
    st = S.sim_init(B, 3, spread_m=0.5, airborne=True, device="cpu")
    assert bool(st.fc.armed.all()) and bool(st.mapper.inited.all())
    st, diag = S.sim_run(st, world, 300, UL_PROFILE, dt_ms=20,
                         scan_period_ms=100)
    assert (diag["state"].numpy() >= tb.ST_HOVER).all()
    free = (logical_grid(st.mapper.grid) < -10).reshape(B, -1).sum(1)
    assert (free > 100).all(), free


def test_batch_mismatch_raises():
    st = S.sim_init(4, device="cpu")
    world = S.make_world(8, device="cpu")
    with pytest.raises(ValueError, match="batch mismatch"):
        S.sim_step(st, world)


def test_cli_sim_on_the_cpu(tmp_path, capsys):
    from micro_quad_slam_tpu_torch.__main__ import main

    prefix = str(tmp_path / "rec")
    assert main(["sim", "--quads", "2", "--seconds", "2", "--device", "cpu",
                 "--out-prefix", prefix]) == 0
    out = capsys.readouterr().out
    assert "swarm 2 quads x 2.0s" in out
    log = jscanlog.read_scanlog(prefix + "_q0.bin")
    assert len(log) == 2000 // 100
    assert np.load(prefix + "_grids.npy").shape == (2, 500, 500)
    if not torch.cuda.is_available():
        assert main(["sim", "--quads", "2", "--seconds", "1"]) == 2
        assert "--device cpu" in capsys.readouterr().err
