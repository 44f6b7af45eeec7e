"""PyTorch port, csrc/match_lattice.cu: the CUDA kernel's work split,
re-derived here in torch, held score for score equal to
ops/matchlattice.py::match_lattice_plain and to the Pallas kernel
(pallas_match_lattice in interpret mode).

The kernel cannot run on the CPU.  This is the CPU guard on the steps its
design rests on:
  * one block per match, one thread per (yaw, ty, tx) candidate, the
    block 32 * ceil(Y*T*T / 32) threads (kernel_shape, with the
    constants read from the CUDA source);
  * the index tables staged beam-major, word y*S + b*T + t with the yaw
    stride S = 32*T + 8, a row as its slab offset r*SC, a column as c and
    any index outside the slab as -2^30: a lookup is in the slab iff the
    int32 sum of its two words is >= 0, and the sum never overflows;
  * per yaw, the mask of beams with an in-slab row and an in-slab column;
    each warp visits the OR of its lanes' yaws' masks, 4 beams at a time,
    every live beam once;
  * in a lookup step the lanes' table words are conflict-free (one word a
    bank, or one word read by several lanes).
Every score is an int32 sum converted to float32 once: the comparisons
are exact (assert_array_equal), on both SLAM slab shapes (104 x 256 with
Y = T = 7, 96 x 128 with Y = T = 5), N = 1 and N = 3, all -1, all valid,
out-of-slab and extreme int32 indices, and the SLAM bench flights' real
pass-1 and loop operands."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu.ops.pallas_scanmatch import pallas_match_lattice
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.ops import matchlattice as ml

torch.set_num_threads(2)

CU = Path(ml.__file__).parents[1] / "csrc" / "match_lattice.cu"


def _cu_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         CU.read_text()).group(1))


NB = _cu_constant("kBeams")
YAW_PAD = _cu_constant("kYawPad")
OFF = -(1 << 30)
PAD_WORD = 12345      # the staged tables' padding: never read
STAGES = {"pass1": ((104, 256), 7), "loop": ((96, 128), 5)}


def kernel_shape(n_yaw: int, T: int) -> tuple:
    """The kernel's launch for an (n_yaw, T, T) lattice (threads_for,
    yaw_stride and shared_bytes in the CUDA source): threads per block,
    the tables' yaw stride in words, dynamic shared bytes."""
    stride = NB * T + YAW_PAD
    return (-(-n_yaw * T * T // 32) * 32, stride,
            4 * (2 * n_yaw * stride + n_yaw))


def _next_beams(mask: int) -> list:
    """The kernel's visit of a warp's beam mask: groups of 4 beams from the
    lowest set bit up, -1 where the mask ran out (next_beam)."""
    groups = []
    while mask:
        group = []
        for _ in range(4):
            group.append((mask & -mask).bit_length() - 1)
            mask &= mask - 1
        groups.append(group)
    return groups


def staged_tables(slabs, ry, rx, n_yaw):
    """Step 1: the block's shared-memory tables [N, Y*S] int32."""
    N, SR, SC = slabs.shape
    T = ry.shape[1] // n_yaw
    _, S, _ = kernel_shape(n_yaw, T)
    r = ry.view(N, n_yaw, T, NB).long()
    c = rx.view(N, n_yaw, T, NB).long()
    row = torch.where((r >= 0) & (r < SR), r * SC, OFF)
    col = torch.where((c >= 0) & (c < SC), c, OFF)

    def beam_major(a):
        out = torch.full((N, n_yaw, S), PAD_WORD, dtype=torch.int64)
        out[:, :, :NB * T] = a.transpose(2, 3).reshape(N, n_yaw, NB * T)
        return out.reshape(N, n_yaw * S).to(torch.int32)

    return beam_major(row), beam_major(col)


def live_masks(srow, scol, n_yaw, T):
    """Step 2: per match and yaw, bit b set where beam b has an in-slab row
    and an in-slab column (warp y's ballot, lane = beam)."""
    N = srow.shape[0]
    _, S, _ = kernel_shape(n_yaw, T)
    words = (torch.arange(n_yaw)[:, None, None] * S
             + torch.arange(NB)[None, :, None] * T
             + torch.arange(T)[None, None, :]).reshape(-1)
    any_r = (srow[:, words] >= 0).view(N, n_yaw, NB, T).any(-1)
    any_c = (scol[:, words] >= 0).view(N, n_yaw, NB, T).any(-1)
    return any_r & any_c                                  # [N, Y, NB]


def lanes(n_yaw, T):
    """Each thread's candidate (y, ty, tx) and warp; threads past the
    lattice take the last candidate, as the kernel's do."""
    threads, _, _ = kernel_shape(n_yaw, T)
    k = torch.arange(threads).clamp_max(n_yaw * T * T - 1)
    return k // (T * T), (k // T) % T, k % T, torch.arange(threads) // 32


def factored_scores(slabs, ry, rx, n_yaw):
    """The kernel's scores float32 [N, Y, T, T], step by step."""
    N, SR, SC = slabs.shape
    T = ry.shape[1] // n_yaw
    threads, S, _ = kernel_shape(n_yaw, T)
    srow, scol = staged_tables(slabs, ry, rx, n_yaw)
    live = live_masks(srow, scol, n_yaw, T)
    y, ty, tx, warp = lanes(n_yaw, T)
    # the warp's mask: the OR of its lanes' yaws' masks
    nw = threads // 32
    wmask = torch.zeros((N, nw, NB), dtype=torch.bool)
    for w in range(nw):
        for yy in torch.unique(y[warp == w]).tolist():
            wmask[:, w] |= live[:, yy]
    bits = (wmask.long() << torch.arange(NB)).sum(-1)     # [N, nw]
    for m in torch.unique(bits).tolist():
        visited = [b for g in _next_beams(m) for b in g if b >= 0]
        assert visited == [b for b in range(NB) if m >> b & 1]
    # every lookup of a visited beam: word y*S + b*T + ty (rows), + tx
    b = torch.arange(NB)
    at_r = (y * S + ty)[:, None] + b[None] * T            # [threads, NB]
    at_c = (y * S + tx)[:, None] + b[None] * T
    addr = srow[:, at_r].long() + scol[:, at_c].long()    # [N, threads, NB]
    assert int(addr.min()) >= -2 ** 31 and int(addr.max()) < 2 ** 31
    ok = (addr >= 0) & wmask[:, warp]
    # an in-slab lookup is never skipped by the beam mask
    assert not ((addr >= 0) & ~wmask[:, warp]).any()
    vals = slabs.reshape(N, -1).long().gather(
        1, addr.clamp_min(0).reshape(N, -1)).view(addr.shape)
    acc = torch.where(ok, vals, 0).sum(-1).to(torch.int32)
    cand = n_yaw * T * T
    return acc[:, :cand].to(torch.float32).view(N, n_yaw, T, T)


def _random(N, shape, n_yaw, seed, kind):
    """Seeded operands: "mixed" (-1 masks, out-of-slab and extreme int32
    indices among in-slab ones), "all_valid", "all_minus_one" and "random"
    (chip_smoke.py's _random_lattice: every index in [-1, SR + 2))."""
    rng = np.random.default_rng(seed)
    SR, SC = shape
    slabs = rng.integers(-128, 128, (N, SR, SC)).astype(np.int8)
    size = (N, n_yaw * n_yaw, NB)
    ry = rng.integers(0, SR, size).astype(np.int32)
    rx = rng.integers(0, SC, size).astype(np.int32)
    if kind == "mixed":
        odd = [-1, -2, SR, SR + 1, SC, 2 ** 31 - 1, -2 ** 31, 1 << 30,
               -(1 << 30)]
        for a in (ry, rx):
            u = rng.random(size)
            a[u < 0.2] = -1
            pick = (u >= 0.2) & (u < 0.3)
            a[pick] = rng.choice(odd, int(pick.sum()))
    elif kind == "all_minus_one":
        ry[:], rx[:] = -1, -1
    elif kind == "random":
        ry = rng.integers(-1, SR + 2, size).astype(np.int32)
        rx = rng.integers(-1, SC + 2, size).astype(np.int32)
    return slabs, ry, rx


def _assert_all_equal(slabs, ry, rx, n_yaw, pallas=True):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (slabs, ry, rx)]
    got = factored_scores(*t, n_yaw)
    want = ml.match_lattice_plain(*t, n_yaw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if pallas:
        jx = np.asarray(pallas_match_lattice(
            jnp.asarray(slabs), jnp.asarray(ry), jnp.asarray(rx), n_yaw,
            True))
        np.testing.assert_array_equal(got.numpy(), jx)
    return got


def test_kernel_shape_fits_the_lattices():
    """11 warps for 7 x 7 x 7, 4 for 5 x 5 x 5; the tables' bytes."""
    assert kernel_shape(7, 7) == (352, 232, 13020)
    assert kernel_shape(5, 5) == (128, 168, 6740)
    assert _next_beams(0) == []
    assert _next_beams(0b1011) == [[0, 1, 3, -1]]
    assert _next_beams(0xffffffff)[-1] == [28, 29, 30, 31]


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("N, kind", [(1, "mixed"), (3, "mixed"),
                                     (3, "all_valid"), (2, "all_minus_one"),
                                     (3, "random")])
def test_factored_equals_plain_and_pallas(stage, N, kind):
    shape, n_yaw = STAGES[stage]
    got = _assert_all_equal(*_random(N, shape, n_yaw, 11 * N, kind), n_yaw)
    if kind == "all_minus_one":
        assert not got.any()
    if kind == "all_valid":
        assert got.abs().max() > 0


@pytest.mark.parametrize("stage", list(STAGES))
def test_table_reads_are_conflict_free(stage):
    """In every lookup step the 32 lanes' words of one table fall in 32
    distinct banks, or are one word read by several lanes."""
    _, n_yaw = STAGES[stage]
    T = n_yaw
    _, S, _ = kernel_shape(n_yaw, T)
    y, ty, tx, warp = lanes(n_yaw, T)
    for b in range(NB):
        for w in range(int(warp.max()) + 1):
            for t in (ty, tx):
                words = torch.unique((y * S + b * T + t)[warp == w])
                banks = words % 32
                assert len(torch.unique(banks)) == len(words), (b, w)


@pytest.fixture(scope="module")
def bench_operands():
    """The 4 SLAM bench flights' first pass-1 round and loop stage under
    UL_PROFILE (testdata.slam_kernel_operands), as chip_smoke.py times
    them at B=128."""
    frames = testdata.slam_bench_frames(4, device="cpu")
    return testdata.slam_kernel_operands(frames, port.UL_PROFILE)[1]


@pytest.mark.parametrize("stage", list(STAGES))
def test_factored_equals_plain_on_bench_operands(bench_operands, stage):
    """The real operands: most beams miss (their rows are -1), so most
    warps skip most beams; the first 16 matches also against the Pallas
    kernel."""
    slabs, ry, rx, n_yaw = bench_operands[stage]
    assert (n_yaw, tuple(slabs.shape[1:])) == (STAGES[stage][1],
                                               STAGES[stage][0])
    T = ry.shape[1] // n_yaw
    live = live_masks(*staged_tables(slabs, ry, rx, n_yaw), n_yaw, T)
    assert 0.1 < float(live.float().mean()) < 0.9
    _assert_all_equal(slabs.numpy(), ry.numpy(), rx.numpy(), n_yaw,
                      pallas=False)
    _assert_all_equal(slabs[:16].numpy(), ry[:16].numpy(), rx[:16].numpy(),
                      n_yaw)
