"""The port's CUDA kernels (csrc/replay_exact.cu with its snapshot and
map-step entries, csrc/replay_cone.cu, csrc/match_lattice.cu) against
their plain torch versions, on the card, the simulator's card run
against the committed JAX small swarm, and the SLAM's card run against
its CPU run.  Every test here needs a
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


def _lattice(N, shape, n_yaw, seed, kind):
    """Seeded lattice operands on the CPU: "random" (every index in
    [-1, SR + 2): every beam live, lookups all over the slab), "mixed"
    (-1 masks, out-of-slab and extreme int32 indices among in-slab ones),
    "all_valid", "all_minus_one"."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    SR, SC = shape
    size = (N, n_yaw * n_yaw, 32)
    slabs = torch.randint(-128, 128, (N, SR, SC), generator=g,
                          dtype=torch.int8)
    if kind == "random":
        return (slabs, torch.randint(-1, SR + 2, size, generator=g,
                                     dtype=torch.int32),
                torch.randint(-1, SC + 2, size, generator=g,
                              dtype=torch.int32))
    ry = torch.randint(0, SR, size, generator=g, dtype=torch.int32)
    rx_ = torch.randint(0, SC, size, generator=g, dtype=torch.int32)
    if kind == "all_minus_one":
        ry.fill_(-1)
        rx_.fill_(-1)
    elif kind == "mixed":
        odd = torch.tensor([-1, -2, SR, SR + 1, SC, 2 ** 31 - 1, -2 ** 31,
                            1 << 30, -(1 << 30)], dtype=torch.int32)
        for a in (ry, rx_):
            u = torch.rand(size, generator=g)
            pick = odd[torch.randint(0, len(odd), size, generator=g)]
            a.copy_(torch.where(u < 0.2, -1, torch.where(u < 0.3, pick, a)))
    return slabs, ry, rx_


@pytest.mark.parametrize("shape, n_yaw", [((104, 256), 7), ((96, 128), 5)])
@pytest.mark.parametrize("N, kind, unaligned", [
    (1, "mixed", False), (3, "mixed", False), (3, "all_valid", False),
    (2, "all_minus_one", False), (700, "random", False),
    (5, "mixed", True)])
def test_match_kernel_edge_cases_on_the_card(cuda, shape, n_yaw, N, kind,
                                             unaligned):
    """N = 1, N = 3, all -1, all valid, out-of-slab and extreme indices,
    every beam live (random), and tables 4 bytes off a 16-byte boundary
    (the kernel's word-by-word staging)."""
    args = [a.to(cuda) for a in _lattice(N, shape, n_yaw, N + n_yaw, kind)]
    if unaligned:
        for i in (1, 2):
            buf = torch.empty(args[i].numel() + 1, dtype=torch.int32,
                              device=cuda)
            args[i] = buf[1:].view(args[i].shape)
            args[i].copy_(_lattice(N, shape, n_yaw, N + n_yaw, kind)[i])
            assert args[i].data_ptr() % 16
    before = ml.match_lattice.launches
    got = ml.match_lattice(*args, n_yaw)
    torch.cuda.synchronize()
    assert ml.match_lattice.launches == before + 1
    assert torch.equal(got, ml.match_lattice_plain(*args, n_yaw))


@pytest.mark.parametrize("stage", ["pass1", "loop"])
def test_match_kernel_on_bench_operands_on_the_card(cuda, stage):
    """The 4 SLAM bench flights' real first pass-1 round and loop stage
    (most beams miss, so most warps skip most beams)."""
    _, ops = testdata.slam_kernel_operands(
        testdata.slam_bench_frames(4, device=cuda), UL_PROFILE)
    got = ml.match_lattice(*ops[stage])
    torch.cuda.synchronize()
    assert torch.equal(got, ml.match_lattice_plain(*ops[stage]))


@pytest.mark.parametrize("N, SR, SC, n_yaw, T, NB", [
    (2, 8, 16, 3, 3, 16),               # NB != 32: lane = beam
    (1, 8, 16, 21, 7, 32),              # over 1,024 candidates: one block
    (1, 32768, 32769, 3, 3, 32),        # 2^30 cells: row offsets r*SC
    (1, 8, 16, 1024, 1, 32)])           # tables past the shared memory
def test_match_lattice_refuses_lattices_the_kernel_does_not_take(
        cuda, N, SR, SC, n_yaw, T, NB):
    """The C entry refuses them (-1), the wrapper raises, and nothing is
    launched; the plain version takes them all."""
    slabs = torch.zeros((N, SR, SC), dtype=torch.int8, device=cuda)
    idx = torch.zeros((N, n_yaw * T, NB), dtype=torch.int32, device=cuda)
    before = ml.match_lattice.launches
    with pytest.raises(ValueError, match="does not take"):
        ml.match_lattice(slabs, idx, idx, n_yaw)
    assert ml.match_lattice.launches == before
    assert not ml.match_lattice_plain(slabs, idx, idx, n_yaw).any()


def _slots(device, K=8, jump=False):
    """4 random flights' every 8th frame as keyframe slots, with a
    chunk-start recenter (flight 0, slot 4) and a mid-chunk one (flight 1,
    slot 2).  With jump, the slots' poses jump 4.8 m east and back, so
    that every slot reloads the exact kernel's resident tile and every
    chunk starts right after a reload."""
    t = _flights(device)
    B = t["x_m"].shape[0]
    beams, _ = extract_beams(t["grid_mm"], UL_PROFILE.tof)
    sel = slice(0, 8 * K, 8)
    x, y, yaw = t["x_m"][:, sel], t["y_m"][:, sel], t["yaw_deg"][:, sel]
    if jump:
        x = x + torch.where(torch.arange(K, device=device) % 2 == 0, -2.4,
                            2.4)
    ox, oy = x[:, :1].expand(B, K).clone(), y[:, :1].expand(B, K).clone()
    do = torch.zeros((B, K), dtype=torch.int32, device=device)
    rsy, rsx = do.clone(), do.clone()
    do[0, 4], rsy[0, 4], rsx[0, 4] = 1, 5, -3
    do[1, 2], rsy[1, 2], rsx[1, 2] = 1, -4, 7
    return [beams[:, sel].contiguous(), x, y, yaw, ox, oy, do, rsy, rsx]


def _check_snapshot_entry(cuda, jump):
    args = _slots(cuda, jump=jump)
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


def test_snapshot_entry_bit_equals_plain_on_the_card(cuda):
    _check_snapshot_entry(cuda, jump=False)


def test_snapshot_chunks_after_tile_reloads_bit_equal_plain_on_the_card(cuda):
    """Every slot's pose jumps, so the exact kernel reloads its tile at
    every slot and each chunk's snapshot follows a reload."""
    _check_snapshot_entry(cuda, jump=True)


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


def test_map_step_rays_to_the_grid_edge_bit_equal_plain_on_the_card(cuda):
    """Scans whose rays end on the logical grid's border rows and
    columns (testdata.edge_scans): the entry stages each quad's ray box,
    16-byte aligned, next to the padding."""
    beams, x, y, yaw = testdata.edge_scans()
    z = torch.zeros(len(x))
    args = [torch.from_numpy(a).to(cuda) for a in (beams, x, y, yaw)]
    args += [z.to(cuda), z.to(cuda),
             torch.ones(len(x), dtype=torch.bool, device=cuda)]
    g0 = _random_grids(cuda, len(x))
    got = rx.map_step(g0.clone(), *args, UL_PROFILE)
    torch.cuda.synchronize()
    assert torch.equal(got, rx.map_step_plain(g0.clone(), *args, UL_PROFILE))
    assert not torch.equal(got, g0)


@pytest.mark.parametrize("kernel, plain", [("residentx", "xla"),
                                           ("conex", "cone"),
                                           ("hybridx", "hybrid")])
@pytest.mark.parametrize("case", ["tile_every_frame",
                                  "recenter_after_reload"])
def test_tile_cases_bit_equal_plain_on_the_card(cuda, case, kernel, plain):
    """testdata.tile_flights: the exact kernel reloads its resident tile
    on every frame, and recenters right after reloads; the cone kernel's
    window jumps as far."""
    frames = port.frames_to_torch(testdata.tile_flights()[case], cuda)
    _assert_same(port.replay_mapping_batched(frames, UL_PROFILE, kernel=kernel),
                 port.replay_mapping_batched(frames, UL_PROFILE, kernel=plain))


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


@pytest.mark.parametrize("form", [{}, {"match_feedback": True},
                                  {"match_map_kf_only": False}],
                         ids=["default", "fb", "all"])
def test_slam_on_the_card_equals_the_cpu_run_bit_for_bit(cuda, form):
    """slam_replay of the 4 SLAM bench flights in each pass-1
    formulation, on the card and on the CPU: every output the same bits.
    The feedback formulations carry an ulp into the map that later
    keyframes match, so this needs every float step of the path to round
    as the CPU's does (division by a tensor, the pose graph's chained
    normal equations and float64 factorization, correctly rounded sqrt)."""
    import dataclasses

    from micro_quad_slam_tpu_torch.slam import pipeline as sp

    cfg = dataclasses.replace(UL_PROFILE, slam=dataclasses.replace(
        UL_PROFILE.slam, **form))
    card = sp.slam_replay(testdata.slam_bench_frames(4, device=cuda), cfg)
    cpu = sp.slam_replay(testdata.slam_bench_frames(4, device="cpu"), cfg)
    for name in ("grid", "track", "odo_track", "kf_nodes", "gn_costs"):
        # gn_costs pads a shorter refine solve's trace with NaN
        a, b = getattr(card, name).cpu(), getattr(cpu, name)
        assert torch.equal(a, b) or torch.equal(a.nan_to_num(7.0),
                                                b.nan_to_num(7.0)), name
