"""The port's CUDA kernels (csrc/replay_exact.cu with its snapshot and
map-step entries, csrc/replay_cone.cu, csrc/match_lattice.cu, the carry
kernel of csrc/carry.cuh in both replay libraries, the EKF replay kernel
of csrc/ekf.cuh, the flight state machines of csrc/behavior.cuh and
csrc/behavior_cl.cuh) against their plain torch versions, on the card,
the simulator's card run against the committed JAX small swarm, and the
SLAM's card run against its CPU run.  Every test here needs a CUDA
device and skips without one.  The file imports nothing of jax or
the JAX package (its flights are the port's committed test data), so it
also runs where only the port is installed; from the repository root on a
CUDA machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py

(--noconftest: tests/conftest.py imports jax for the JAX package's tests).
"""

import numpy as np
import pytest
import torch

import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.ops import _build
from micro_quad_slam_tpu_torch.ops import conex as cx
from micro_quad_slam_tpu_torch.ops import matchlattice as ml
from micro_quad_slam_tpu_torch.ops import residentx as rx
from micro_quad_slam_tpu_torch.replay import mapping as tm
from micro_quad_slam_tpu_torch.ops.beams import extract_beams
from micro_quad_slam_tpu_torch.ops.raycast import world_to_cell
from micro_quad_slam_tpu_torch.ops.scanmatch import window_origin
from micro_quad_slam_tpu_torch.utils import obs
from micro_quad_slam_tpu_torch.utils.config import CL_PROFILE, UL_PROFILE

pytestmark = pytest.mark.cuda


def _launches(kernel: str) -> int:
    return obs.counters().get(f"launches.{kernel}", 0)


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
    sched, outs, _ = tm.schedule(_flights(cuda), UL_PROFILE)
    assert outs["kf_flags"].any()
    g0 = _random_grids(cuda)
    before = _launches("replay_exact")
    got = rx.replay_exact(g0.clone(), sched, UL_PROFILE)
    torch.cuda.synchronize()
    assert _launches("replay_exact") == before + 1
    want = rx.replay_exact_plain(g0.clone(), sched, UL_PROFILE)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hybrid", [False, True])
def test_cone_kernel_bit_equals_plain_on_the_card(cuda, hybrid):
    sched, outs, _ = tm.schedule(_flights(cuda), UL_PROFILE,
                                 mode="hybrid" if hybrid else "cone")
    assert outs["kf_flags"].any()
    g0 = _random_grids(cuda)
    before = _launches("replay_cone")
    got = cx.replay_cone(g0.clone(), sched, UL_PROFILE, hybrid)
    torch.cuda.synchronize()
    assert _launches("replay_cone") == before + 1
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


def _carry_frames(case, device):
    """The carry kernel's card cases, from the 4 random flights of
    _flights: as they are (flight 1 recenters at frames 28 and 51); 37
    flights, the 4 repeated under rigid offsets (a block and 5 flights);
    61 frames (a chunk and 29 frames) and 1; NaN poses, yaws and flow
    rates, dropped ToF sensors (NaN minima), a late take-off, ground
    states and health words with one bit, both or none."""
    f = {k: v[:4].copy() for k, v in testdata.load("random_flights")[0]
         .items()}
    if case == "batch_37":
        idx = np.arange(37) % 4
        f = {k: v[idx] for k, v in f.items()}
        k = np.arange(37, dtype=np.float32)[:, None]
        f["x_m"] = f["x_m"] + np.float32(0.37) * k
        f["y_m"] = f["y_m"] - np.float32(1.13) * k
        f["yaw_deg"] = f["yaw_deg"] + np.float32(9.5) * k
    elif case in ("T_61", "T_1"):
        T = int(case[2:])
        f = {k: v[:, :T] for k, v in f.items()}
    elif case == "nan_and_dropouts":
        nan = np.float32("nan")
        f["x_m"][0, 5:9] = nan
        f["y_m"][1, 10] = nan
        f["yaw_deg"][2, 3:6] = nan
        f["of_rate_x"][3, ::3] = nan
        f["of_q"][3, 1::3] = 10
        f["grid_mm"][0, 12:20, 1] = 0
        f["grid_mm"][2, :, 0] = 0xFFFF
        f["grid_mm"][1, 30:40] = 0
        f["state"][3, :7] = 2
        f["state"][2, 40:44] = 9
        f["sys_health"][0, ::2] = 0x4000
        f["sys_health"][1, ::5] = 0x6000
        f["sys_health"][2, 1::4] = 0x01
    return port.frames_to_torch(f, device)


def _bits(v):
    """A tensor's values as integers, float32 by its bits, every NaN as
    one value."""
    if not v.is_floating_point():
        return v.to(torch.int64)
    return torch.where(torch.isnan(v), -1, v.view(torch.int32).to(
        torch.int64))


def _assert_carry_same(a, b):
    (so_a, fin_a), (so_b, fin_b) = a, b
    assert sorted(so_a) == sorted(so_b)
    pairs = [(k, so_a[k], so_b[k]) for k in so_a]
    pairs += [(k, x, y) for k, x, y in zip(
        ("origin_x", "origin_y", "inited", "filt"), fin_a, fin_b)]
    for name, x, y in pairs:
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(_bits(x), _bits(y)), name


def _carry_operands(frames):
    return tm.carry_operands(frames, UL_PROFILE)[1:]


@pytest.mark.parametrize("library", _build.ENTRIES["mqs_carry"].libraries)
@pytest.mark.parametrize("case", ["random_flights", "batch_37", "T_61",
                                  "T_1", "nan_and_dropouts"])
def test_carry_kernel_bit_equals_plain_on_the_card(cuda, case, library):
    frames = _carry_frames(case, cuda)
    minima, seq, c0 = _carry_operands(frames)
    before = _launches("carry")
    got = tm.carry_kernel(library, minima, seq, c0, UL_PROFILE)
    torch.cuda.synchronize()
    assert _launches("carry") == before + 1
    want = tm.carry_plain(minima, seq, c0, UL_PROFILE)
    _assert_carry_same(got, want)
    so = want[0]
    if case == "random_flights":
        assert so["kf_flags"][1].nonzero().flatten().tolist() == [28, 51]
    if case == "nan_and_dropouts":
        assert torch.isnan(minima[0, 12:20, 1]).all()
        assert not so["enabled"][0, 5:9].any()
        assert so["enabled"].any() and not so["enabled"].all()


def test_carry_kernel_resumed_at_frame_30_equals_the_whole_run(cuda):
    frames = _carry_frames("random_flights", cuda)
    minima, seq, c0 = _carry_operands(frames)
    lib = tm.MODES["exact"].library
    whole = tm.carry_kernel(lib, minima, seq, c0, UL_PROFILE)
    cut = lambda a, s: a[:, s].contiguous()                            # noqa: E731
    head = tm.carry_kernel(lib, cut(minima, slice(0, 30)),
                           {k: cut(v, slice(0, 30)) for k, v in seq.items()},
                           c0, UL_PROFILE)
    tail = tm.carry_kernel(lib, cut(minima, slice(30, None)),
                           {k: cut(v, slice(30, None)) for k, v in
                            seq.items()}, head[1], UL_PROFILE)
    joined = {k: torch.cat([head[0][k], tail[0][k]], dim=1)
              for k in whole[0]}
    _assert_carry_same((joined, tail[1]), whole)
    _assert_carry_same(whole, tm.carry_plain(minima, seq, c0, UL_PROFILE))


@pytest.mark.parametrize("kernel", ["residentx", "conex", "hybridx"])
def test_one_carry_launch_per_mapping_replay_on_the_card(cuda, kernel):
    frames = _flights(cuda)
    before = _launches("carry")
    port.replay_mapping_batched(frames, UL_PROFILE, kernel=kernel)
    torch.cuda.synchronize()
    assert _launches("carry") == before + 1


def _ekf_frames(case, device):
    """The EKF replay kernel's card cases, from the 4 SLAM bench flights
    (T = 256): as they are; with NaN yaw, rangefinder and flow samples,
    flow quality under the gate, ranges under the floor and over 10 m, the
    clock stepping back and jumping over 1 s (dt clipped to 0 and 1), and
    flights 2-3 drifting at 6 and -9 m/s, which recenter (the schedule
    clamps some shifts); 37 flights (a block and 5) under rigid offsets;
    one flight; 61 frames (3 chunks and 13 frames) and 1."""
    base, _ = testdata.load("slam_bench_flights")
    f = {k: v[:4].copy() for k, v in base.items()}
    if case == "gates_and_glitches":
        nan = np.float32("nan")
        f["yaw_deg"][0, 10:20] = nan
        f["rf_m"][1, ::7] = nan
        f["rf_m"][0, 30:36] = np.float32(0.02)
        f["rf_m"][3, 40:44] = np.float32(12.0)
        f["of_rate_x"][2, 5:50:3] = nan
        f["of_rate_y"][0, 70:75] = nan
        f["of_q"][3, 100:140] = 10
        f["scan_ms"][1, 60:] -= 400
        f["scan_ms"][2, 90:] += 5000
        f["of_rate_x"][2] += np.float32(6.0)
        f["of_rate_y"][3] -= np.float32(9.0)
    elif case == "batch_37":
        idx = np.arange(37) % 4
        f = {k: v[idx] for k, v in f.items()}
        k = np.arange(37, dtype=np.float32)[:, None]
        f["x_m"] = f["x_m"] + np.float32(0.37) * k
        f["y_m"] = f["y_m"] - np.float32(1.13) * k
        f["yaw_deg"] = f["yaw_deg"] + np.float32(9.5) * k
    elif case == "B_1":
        f = {k: v[1:2] for k, v in f.items()}
    elif case in ("T_61", "T_1"):
        T = int(case[2:])
        f = {k: v[:, :T] for k, v in f.items()}
    return port.frames_to_torch(f, device)


@pytest.mark.parametrize("recenter", [False, True], ids=["ekf", "schedule"])
@pytest.mark.parametrize("case", ["bench", "gates_and_glitches", "batch_37",
                                  "B_1", "T_61", "T_1", "origins"])
def test_ekf_replay_kernel_bit_equals_plain_on_the_card(cuda, case,
                                                        recenter):
    """The EKF replay kernel against the torch loop on the card: every
    output and the final state the same bits, with the recenter schedule
    off and on (from NaN origins, or for "origins" from given ones 40 m
    and -31 m away, so the first shifts clamp)."""
    from micro_quad_slam_tpu_torch.replay import fusion as fu

    frames = _ekf_frames("bench" if case == "origins" else case, cuda)
    seq, st0 = fu.replay_operands(frames)
    B = st0.mean.shape[0]
    origin0 = None
    if recenter:
        nan = torch.full((B,), float("nan"), device=cuda)
        origin0 = (nan, nan.clone())
        if case == "origins":
            origin0 = ((st0.mean[:, 0] + 40.0).contiguous(),
                       (st0.mean[:, 1] - 31.0).contiguous())
    before = _launches("ekf_replay")
    got = fu.ekf_replay_kernel(seq, st0, UL_PROFILE, origin0)
    torch.cuda.synchronize()
    assert _launches("ekf_replay") == before + 1
    want = fu.ekf_replay_plain(seq, st0, UL_PROFILE, origin0)
    for name, a, b in (("mean", got[0].mean, want[0].mean),
                       ("cov", got[0].cov, want[0].cov),
                       ("means", got[1], want[1]),
                       ("flow_used", got[2], want[2])):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
    assert (got[3] is None) == (not recenter)
    if recenter:
        assert sorted(got[3]) == sorted(want[3])
        for k in want[3]:
            a, b = got[3][k], want[3][k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(_bits(a), _bits(b)), k
    if case == "gates_and_glitches":
        assert not want[2][3, 100:140].any() and want[2].any()
        assert float(seq["dt"].min()) == 0.0 and float(seq["dt"].max()) == 1.0
        if recenter:
            do = want[3]["do"]
            assert do[2].sum() >= 2 and do[3].sum() >= 2 and not do[:2].any()
    if case == "origins" and recenter:
        shift = UL_PROFILE.map.recenter_max_shift_cells
        assert bool((want[3]["rsx"][:, 0] == -shift).all())
        assert bool((want[3]["rsy"][:, 0] == shift).all())


@pytest.mark.parametrize("recenter", [False, True])
def test_one_ekf_replay_launch_per_slam_replay_on_the_card(cuda, recenter):
    """SLAM pass 0 is one launch of the EKF replay kernel, the schedule's
    on (the default) or off; so is the fusion replay."""
    import dataclasses

    from micro_quad_slam_tpu_torch.replay import fusion as fu
    from micro_quad_slam_tpu_torch.slam import pipeline as sp

    cfg = dataclasses.replace(UL_PROFILE, slam=dataclasses.replace(
        UL_PROFILE.slam, recenter=recenter))
    frames = testdata.slam_bench_frames(4, device=cuda)
    before = _launches("ekf_replay")
    sp.slam_replay(frames, cfg)
    torch.cuda.synchronize()
    assert _launches("ekf_replay") == before + 1
    fu.replay_fusion_batched(frames, cfg)
    assert _launches("ekf_replay") == before + 2


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
    before = _launches("match_lattice")
    got = ml.match_lattice(*args, n_yaw)
    torch.cuda.synchronize()
    assert _launches("match_lattice") == before + 1
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
    before = _launches("match_lattice")
    got = ml.match_lattice(*args, n_yaw)
    torch.cuda.synchronize()
    assert _launches("match_lattice") == before + 1
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
    before = _launches("match_lattice")
    with pytest.raises(ValueError, match="does not take"):
        ml.match_lattice(slabs, idx, idx, n_yaw)
    assert _launches("match_lattice") == before
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
    before = _launches("replay_exact_snap")
    got = rx.map_snap(g0, *args, wy0, wx0, 4, UL_PROFILE)
    torch.cuda.synchronize()
    assert _launches("replay_exact_snap") == before + 1
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
    before = _launches("replay_exact")
    got = rx.map_chunk_sched(g0, *args, UL_PROFILE)
    assert _launches("replay_exact") == before + 1
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
    before = _launches("map_step")
    got = rx.map_step(g0.clone(), *args, UL_PROFILE)
    torch.cuda.synchronize()
    assert _launches("map_step") == before + 1
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
    before = _launches("map_step")
    got = port.replay_mapping_batched(frames, UL_PROFILE, kernel=kernel)
    assert _launches("map_step") == before + frames["x_m"].shape[1]
    _assert_same(got, port.replay_mapping_batched(frames, UL_PROFILE,
                                                  kernel="xla"))


def test_swarm_small_equals_jax_on_the_card(cuda):
    """The committed JAX small swarm (bench.py's swarm at B=8, T=1000):
    states, cmd_kind, grids and frontier scores equal; poses and EKF
    means within 1e-4, tests/test_torch_simulator.py's tolerance."""
    from micro_quad_slam_tpu_torch.models.simulator import sim_run

    world, st, draws, ref = testdata.swarm_small(cuda)
    before = _launches("map_step")
    fin, diag = sim_run(st, world, testdata.SWARM_T, UL_PROFILE, record=True,
                        draws=draws, **testdata.SWARM_RUN)
    assert _launches("map_step") == before + 10
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


# ------------------------------------------------ the flight state machines

def _random_telemetry(B: int, T: int, seed: int) -> dict:
    """T ticks of seeded random telemetry for B quads, [T, B] numpy arrays
    (tof_min [T, B, 4]) at 20 ms a tick: stale and missing streams,
    rejected and accepted takeoff acks, NaN rf_m, yaw_deg, motor_avg,
    batt_vpc, lpos_alt_filt and tof_min entries, and batteries held below
    the land and emergency thresholds long enough to trip the failsafes
    (a quad's level is drawn once, 3.2 to 4.2 V a cell); the clean
    machine's enabled bits and battery validity last."""
    rng = np.random.default_rng(seed)
    t = (rng.integers(0, 5000, B)[None] + 20 * np.arange(T)[:, None]
         ).astype(np.int32)
    shape = (T, B)

    def p(q):
        return rng.random(shape) < q

    def ago(hi):
        return (t - rng.integers(0, hi, shape)).astype(np.int32)

    def sticky(q, flip):
        return (rng.random(B) < q) ^ (np.cumsum(p(flip), axis=0) % 2 == 1)

    def nan(v, q):
        return np.where(p(q), np.nan, v).astype(np.float32)

    bits = np.array([0x01, 0x2000, 0x4000, 0x400000])
    health = (rng.random(shape + (4,)) < 0.9) @ bits
    level = rng.uniform(3.2, 4.2, B)
    return {
        "t_ms": t, "have_fc": p(0.97), "fc_armed": sticky(0.6, 0.02),
        "hb_custom_mode": rng.choice([0, 4, 9], shape, p=[0.2, 0.7, 0.1]
                                     ).astype(np.int32),
        "have_ext": p(0.8),
        "landed_state": rng.choice([0, 1, 2], shape, p=[0.1, 0.3, 0.6]
                                   ).astype(np.int32),
        "have_sys": p(0.9), "sys_last_ms": ago(1500),
        "sys_health": health.astype(np.int32),
        "have_servo": p(0.9), "servo_last_ms": ago(300),
        "motor_avg": nan(rng.uniform(1000, 1700, shape), 0.05),
        "batt_vpc": nan(level + rng.normal(0, 0.02, shape), 0.05),
        "batt_cells": rng.choice([0, 2, 3], shape, p=[0.05, 0.9, 0.05]
                                 ).astype(np.int32),
        "batt_last_ms": np.where(p(0.05), 0, ago(2500)).astype(np.int32),
        "have_lpos": p(0.9), "lpos_last_ms": ago(500),
        "lpos_x": rng.uniform(-3, 3, shape).astype(np.float32),
        "lpos_y": rng.uniform(-3, 3, shape).astype(np.float32),
        "lpos_alt_filt": nan(rng.uniform(-0.1, 1.2, shape), 0.05),
        "have_att": p(0.95),
        "yaw_deg": nan(rng.uniform(-180, 180, shape), 0.05),
        "have_of": p(0.9), "of_last_ms": ago(600),
        "of_q": rng.integers(0, 256, shape).astype(np.int32),
        "have_rf": p(0.8), "rf_last_ms": ago(600),
        "rf_m": nan(rng.uniform(-0.1, 1.5, shape), 0.1),
        "want_arm": sticky(0.8, 0.01), "have_takeoff_ack": p(0.5),
        "takeoff_ack_res": rng.choice([0, 1, 2], shape, p=[0.7, 0.15, 0.15]
                                      ).astype(np.int32),
        "takeoff_ack_ms": np.where(p(0.1), 0, ago(4000)).astype(np.int32),
        "takeoff_accept_ms": np.where(p(0.5), 0, ago(4000)).astype(np.int32),
        "tof_min": np.where(rng.random(shape + (4,)) < 0.1, np.nan,
                            rng.uniform(0.1, 3.0, shape + (4,))
                            ).astype(np.float32),
        "map_inited": p(0.7),
        **{f"frontier_{d}": rng.integers(0, 300, shape).astype(np.int32)
           for d in "frlb"},
        "sys_enabled": ((rng.random(shape + (4,)) < 0.9) @ bits
                        ).astype(np.int32),
        "batt_valid": p(0.9),
    }


def _machine(name: str) -> dict:
    """The UL machine ("ul") or the clean one ("cl"): its kernel and plain
    steps, launch counter, start state, profile and state table."""
    from micro_quad_slam_tpu_torch.models import behavior as tb
    from micro_quad_slam_tpu_torch.models import behavior_cl as bcl

    if name == "ul":
        return {"kernel": tb.behavior_step_kernel,
                "plain": tb.behavior_step_plain, "launches": "behavior_step",
                "init": tb.behavior_init, "cfg": UL_PROFILE,
                "fields": tb._STATE_FIELDS, "state": tb.BehaviorState}
    return {"kernel": bcl.behavior_step_cl_kernel,
            "plain": bcl.behavior_step_cl_plain,
            "launches": "behavior_step_cl", "init": bcl.behavior_cl_init,
            "cfg": CL_PROFILE, "fields": bcl._STATE_FIELDS,
            "state": bcl.BehaviorClState}


def _random_state(machine: str, B: int, t0: np.ndarray, seed: int, device):
    """A seeded random machine state for B quads at the clock t0 [B]: every
    state, random flags, timers up to 5 s old or 0, NaN floats; the clean
    machine's stale counters around their limit."""
    m = _machine(machine)
    rng = np.random.default_rng(seed)
    d = {}
    for name, dt, _ in m["fields"]:
        if dt == torch.bool:
            d[name] = rng.random(B) < 0.5
        elif dt == torch.float32:
            d[name] = np.where(rng.random(B) < 0.1, np.nan,
                               rng.uniform(-180, 180, B)).astype(np.float32)
        else:
            d[name] = np.where(rng.random(B) < 0.3, 0, t0 - rng.integers(
                0, 5000, B)).astype(np.int32)
    cl = machine == "cl"
    d["st"] = rng.integers(0, 8 if cl else 10, B).astype(np.int32)
    if not cl:
        d["turn_dir"] = rng.integers(0, 4, B).astype(np.int32)
        d["forced_dir"] = rng.integers(0, 4, B).astype(np.int32)
    d["alt_src"] = rng.integers(0, 4, B).astype(np.int32)
    d["kf"] = rng.integers(0, 32 if cl else 256, B).astype(np.int32)
    alts = ("alt_est", "alt_max", "to_alt0") if cl else ("alt_est",)
    for name in alts:
        d[name] = np.where(rng.random(B) < 0.1, np.nan, rng.uniform(
            -0.1, 1.2, B)).astype(np.float32)
    if cl:
        for name in ("lpos_stale", "rf_stale", "alt_stale"):
            d[name] = rng.integers(0, 45, B).astype(np.int32)
    d["tof_filt"] = np.where(rng.random((B, 4)) < 0.1, np.nan, rng.uniform(
        0.1, 3.0, (B, 4))).astype(np.float32)
    return m["state"](**{k: torch.from_numpy(v).to(device)
                         for k, v in d.items()})


def _machine_runs(machine: str, state, seq: dict, cfg):
    """The machine over [T, B] telemetry tensors from `state`, through the
    kernel and through the plain path: per path, every tick's (state,
    outputs)."""
    m = _machine(machine)
    runs = []
    for step in (m["kernel"], m["plain"]):
        st, ticks = state, []
        for i in range(seq["t_ms"].shape[0]):
            st, out = step(st, {k: v[i] for k, v in seq.items()}, cfg)
            ticks.append((st, out))
        runs.append(ticks)
    return runs


def _assert_machine_same(kernel_ticks, plain_ticks):
    for i, ((ks, ko), (ps, po)) in enumerate(zip(kernel_ticks,
                                                 plain_ticks)):
        assert list(ko) == list(po)
        for name, x, y in ([(f"state.{k}", getattr(ks, k), getattr(ps, k))
                            for k in ks._fields]
                           + [(k, ko[k], po[k]) for k in ko]):
            assert x.dtype == y.dtype and x.shape == y.shape, (i, name)
            assert torch.equal(_bits(x), _bits(y)), (i, name)
    assert len(kernel_ticks) == len(plain_ticks)


# the committed schedules: (machine, [T, B] telemetry, the states reached)
SCHEDULES = {
    "ul_scenarios": ("ul", testdata.ul_scenarios, {1, 2, 3, 4, 5, 6, 7, 9}),
    "cl_scenarios": ("cl", testdata.cl_scenarios, {1, 2, 3, 4, 5, 6, 7}),
    "cl_fuzz": ("cl", testdata.cl_fuzz, {0, 1, 2, 3, 4, 5, 6, 7})}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_machine_kernel_on_the_scenarios_bit_equals_plain_on_the_card(
        cuda, schedule):
    """The committed fc_mock schedules tiled to B = 1,000 quads (not a
    multiple of the kernels' block): test_torch_behavior.py's four UL
    scenarios (1,100 ticks: idle, arming, takeoff, ramp, liftoff assist,
    hover, explore, turning, disarming; landing is the random cases'),
    test_torch_behavior_cl.py's 15 clean ones (1,100 ticks, to the hover
    lock, landing and disarming) and the 32 clean fuzzed schedules (700
    ticks).  The kernel's new state and every output equal the plain
    path's, tick for tick, one launch a tick."""
    machine, load, reached = SCHEDULES[schedule]
    m = _machine(machine)
    seq = load(1000, cuda)
    T = seq["t_ms"].shape[0]
    before = _launches(m["launches"])
    kernel, plain = _machine_runs(machine, m["init"](1000, cuda), seq,
                                  m["cfg"])
    torch.cuda.synchronize()
    assert _launches(m["launches"]) == before + T
    _assert_machine_same(kernel, plain)
    states = torch.stack([o["state"] for _, o in kernel]).unique().tolist()
    assert set(states) >= reached, states
    if machine == "cl":
        assert bool(kernel[-1][0].hv_locked.any())


# the random cases: each one's machine and changes to its profile's groups
MACHINE_CASES = {
    "random": ("ul", {}), "int64_health": ("ul", {}), "one_quad": ("ul", {}),
    "no_explore": ("ul", {"behavior": {"explore_enabled": False}}),
    "hover_test_only": ("ul", {"behavior": {"hover_test_only": True}}),
    "no_land_actions": ("ul", {"battery": {"land_actions_enabled": False}}),
    "cl_random": ("cl", {}), "cl_int64_health": ("cl", {}),
    "cl_one_quad": ("cl", {})}


@pytest.mark.parametrize("case", list(MACHINE_CASES))
def test_machine_kernel_on_random_telemetry_bit_equals_plain_on_the_card(
        cuda, case):
    """Random states under random telemetry (NaN rf_m, yaw_deg, motor_avg,
    batt_vpc and tof_min entries; batteries that trip the low and
    emergency failsafes), 300 ticks: the kernel equals the plain path tick
    for tick, for each machine; with int64 health bits, at B = 1, and (UL)
    with explore_enabled off, hover_test_only on, land_actions_enabled
    off."""
    import dataclasses

    machine, changes = MACHINE_CASES[case]
    base = _machine(machine)["cfg"]
    cfg = dataclasses.replace(base, **{
        group: dataclasses.replace(getattr(base, group), **fields)
        for group, fields in changes.items()})
    B = 1 if case.endswith("one_quad") else 777
    seed = 1800 + list(MACHINE_CASES).index(case)
    tel = _random_telemetry(B, 300, seed)
    if case.endswith("int64_health"):
        for k in ("sys_health", "sys_enabled"):
            tel[k] = tel[k].astype(np.int64)
    seq = {k: torch.from_numpy(v).to(cuda) for k, v in tel.items()}
    state = _random_state(machine, B, tel["t_ms"][0], seed, cuda)
    kernel, plain = _machine_runs(machine, state, seq, cfg)
    _assert_machine_same(kernel, plain)
    if B > 1:     # some quads' batteries tripped (the land, emerg bits)
        land, emerg = (8, 16) if machine == "cl" else (64, 128)
        gained = plain[-1][1]["kf_flags"] & ~state.kf
        assert bool(((gained & land) != 0).any() and ((gained & emerg) != 0)
                    .any())


def test_one_machine_launch_per_sim_step_on_the_card(cuda, monkeypatch):
    """200 ticks of the bench swarm's start: one behavior_step launch a
    sim_step, and every diagnostic and the final state bit-equal to the
    same run through the plain machine."""
    from micro_quad_slam_tpu_torch.models import behavior as tb
    from micro_quad_slam_tpu_torch.models import simulator as sim

    world, st0, _ = testdata.swarm_bench(device=cuda)
    before = _launches("behavior_step")
    fin, diag = sim.sim_run(st0, world, 200, UL_PROFILE, record=True,
                            **testdata.SWARM_RUN)
    torch.cuda.synchronize()
    assert _launches("behavior_step") == before + 200
    monkeypatch.setattr(sim, "behavior_step", tb.behavior_step_plain)
    fin_p, diag_p = sim.sim_run(st0, world, 200, UL_PROFILE, record=True,
                                **testdata.SWARM_RUN)
    assert _launches("behavior_step") == before + 200
    assert sorted(diag) == sorted(diag_p)
    for k in diag:
        assert torch.equal(_bits(diag[k]), _bits(diag_p[k])), k
    for k in fin.beh._fields:
        assert torch.equal(_bits(getattr(fin.beh, k)),
                           _bits(getattr(fin_p.beh, k))), k
    assert torch.equal(fin.mapper.grid, fin_p.mapper.grid)


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
