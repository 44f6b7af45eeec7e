"""The port's CUDA kernels (csrc/replay_exact.cu with its snapshot and
map-step entries, csrc/replay_cone.cu, csrc/match_lattice.cu) against
their plain torch versions, on the card, and the simulator's card run
against the committed JAX small swarm.  Every test here needs a
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
from micro_quad_slam_tpu_torch.ops import matchlattice as ml
from micro_quad_slam_tpu_torch.ops import residentx as rx
from micro_quad_slam_tpu_torch.ops.beams import extract_beams
from micro_quad_slam_tpu_torch.ops.raycast import world_to_cell
from micro_quad_slam_tpu_torch.ops.scanmatch import window_origin
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


@pytest.mark.parametrize("shape, n_yaw, T", [((104, 256), 7, 7),
                                             ((96, 128), 5, 5)])
def test_match_kernel_bit_equals_plain_on_the_card(cuda, shape, n_yaw, T):
    """Random slabs and indices with -1 masks and out-of-slab indices."""
    g = torch.Generator(device="cpu").manual_seed(5)
    N, (SR, SC) = 300, shape
    slabs = torch.randint(-128, 128, (N, SR, SC), generator=g,
                          dtype=torch.int8)
    ry = torch.randint(-1, SR + 2, (N, n_yaw * T, 32), generator=g,
                       dtype=torch.int32)
    rx_ = torch.randint(-1, SC + 2, (N, n_yaw * T, 32), generator=g,
                        dtype=torch.int32)
    args = [a.to(cuda) for a in (slabs, ry, rx_)]
    before = ml.match_lattice.launches
    got = ml.match_lattice(*args, n_yaw)
    torch.cuda.synchronize()
    assert ml.match_lattice.launches == before + 1
    assert torch.equal(got, ml.match_lattice_plain(*args, n_yaw))


def _slots(device, K=8):
    """4 random flights' every 8th frame as keyframe slots, with a
    chunk-start recenter (flight 0, slot 4) and a mid-chunk one (flight 1,
    slot 2)."""
    t = _flights(device)
    B = t["x_m"].shape[0]
    beams, _ = extract_beams(t["grid_mm"], UL_PROFILE.tof)
    sel = slice(0, 8 * K, 8)
    x, y, yaw = t["x_m"][:, sel], t["y_m"][:, sel], t["yaw_deg"][:, sel]
    ox, oy = x[:, :1].expand(B, K).clone(), y[:, :1].expand(B, K).clone()
    do = torch.zeros((B, K), dtype=torch.int32, device=device)
    rsy, rsx = do.clone(), do.clone()
    do[0, 4], rsy[0, 4], rsx[0, 4] = 1, 5, -3
    do[1, 2], rsy[1, 2], rsx[1, 2] = 1, -4, 7
    return [beams[:, sel].contiguous(), x, y, yaw, ox, oy, do, rsy, rsx]


def test_snapshot_entry_bit_equals_plain_on_the_card(cuda):
    args = _slots(cuda)
    pcx, pcy = world_to_cell(args[1], args[2], args[4], args[5], 0.1, 250,
                             250)
    wy0, wx0 = window_origin(pcx, pcy, port.DEFAULT_GEOM)
    g0 = _random_grids(cuda)
    before = rx.replay_exact_snap.launches
    got = rx.map_snap(g0, *args, wy0, wx0, 4, UL_PROFILE)
    torch.cuda.synchronize()
    assert rx.replay_exact_snap.launches == before + 1
    want = rx.map_snap_plain(g0, *args, wy0, wx0, 4, UL_PROFILE)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[1][0, 4], got[1][0, 3])


def test_map_chunk_sched_kernel_equals_plain_on_the_card(cuda):
    args = _slots(cuda)
    g0 = _random_grids(cuda)
    before = rx.replay_exact.launches
    got = rx.map_chunk_sched(g0, *args, UL_PROFILE)
    assert rx.replay_exact.launches == before + 1
    sched = rx.track_schedule(*args, UL_PROFILE)
    want = rx.replay_exact_plain(g0.clone(), sched, UL_PROFILE)
    assert torch.equal(got, want)


def test_map_step_bit_equals_plain_on_the_card(cuda):
    """tests/test_pallas.py:421-451's case: random grids, NaN beams, a
    disabled quad (3), poses at or over the grid edge."""
    g = torch.Generator(device="cpu").manual_seed(3)
    B = 8
    beams = torch.rand((B, 4, 8), generator=g) * 4.1 + 0.1
    beams[torch.rand((B, 4, 8), generator=g) < 0.15] = float("nan")
    x = torch.rand(B, generator=g) * 40 - 20
    x[-2:] = torch.tensor([24.9, 25.3])
    y = torch.rand(B, generator=g) * 40 - 20
    yaw = torch.rand(B, generator=g) * 360 - 180
    z = torch.zeros(B)
    en = torch.ones(B, dtype=torch.bool)
    en[3] = False
    args = [a.to(cuda) for a in (beams, x, y, yaw, z, z, en)]
    g0 = _random_grids(cuda, B)
    before = rx.map_step.launches
    got = rx.map_step(g0.clone(), *args, UL_PROFILE)
    torch.cuda.synchronize()
    assert rx.map_step.launches == before + 1
    assert torch.equal(got, rx.map_step_plain(g0.clone(), *args, UL_PROFILE))
    assert torch.equal(got[3], g0[3]) and not torch.equal(got, g0)


@pytest.mark.parametrize("kernel", ["pallas", "pallas_db"])
def test_per_frame_pallas_routes_equal_xla_on_the_card(cuda, kernel):
    frames = _flights(cuda)
    before = rx.map_step.launches
    got = port.replay_mapping_batched(frames, UL_PROFILE, kernel=kernel)
    assert rx.map_step.launches == before + frames["x_m"].shape[1]
    _assert_same(got, port.replay_mapping_batched(frames, UL_PROFILE,
                                                  kernel="xla"))


def test_swarm_small_equals_jax_on_the_card(cuda):
    """The committed JAX small swarm (bench.py's swarm at B=8, T=1000):
    states, cmd_kind, grids and frontier scores equal; poses and EKF
    means within 1e-4, tests/test_torch_simulator.py's tolerance."""
    from micro_quad_slam_tpu_torch.models.simulator import sim_run

    world, st, draws, ref = testdata.swarm_small(cuda)
    before = rx.map_step.launches
    fin, diag = sim_run(st, world, testdata.SWARM_T, UL_PROFILE, record=True,
                        draws=draws, **testdata.SWARM_RUN)
    assert rx.map_step.launches == before + 10
    assert torch.equal(diag["state"].cpu(), torch.from_numpy(ref["state"]))
    assert torch.equal(diag["cmd_kind"].cpu(),
                       torch.from_numpy(ref["cmd_kind"]))
    assert torch.equal(fin.mapper.grid.cpu(), torch.from_numpy(ref["grid"]))
    assert torch.equal(fin.frontier.cpu(), torch.from_numpy(ref["frontier"]))
    for k in ("x", "y", "yaw"):
        assert float((getattr(fin, k).cpu() - torch.from_numpy(ref[k]))
                     .abs().max()) <= 1e-4, k
    assert float((fin.ekf.mean.cpu() - torch.from_numpy(ref["ekf_mean"]))
                 .abs().max()) <= 1e-4
