"""PyTorch port, csrc/replay_cone.cu: the CUDA kernel's factored cone
classification, re-derived here in torch, held cell for cell equal to
ops/conemode.py::cone_cell_delta (gated as window_update gates it).

The kernel cannot run on the CPU.  This is the CPU guard on the
identities its redesign rests on:
  * every product is a fan scalar times the cell's column offset ax or
    row offset ay, so per-frame tables of b[i] * ax and b[i] * ay hold
    them all, and the rotation into the quadrant frame becomes a sign flip
    of a table entry: RN(b * -a) == -RN(b * a) for round-to-nearest;
  * the sector's squared thresholds (dfree^2, olo^2, ohi^2) are made once
    per sector, with validity and the hit flag folded in;
  * the column search of a fan stops where the rest of it cannot change
    the thresholds: at once where the fan's 8 sectors hold the same ones,
    after the first test where each half does, after the second where each
    pair does (the skipped tests read as 0);
  * a cell whose squared range exceeds the frame's largest threshold (the
    max of dfree^2 and, in cone mode, of the hits' ohi^2) has delta 0; so
    does a cell outside every fan (the fan-end test), one off the logical
    grid (its table square is +inf) and every cell of a frame that is not
    enabled (threshold -1).
Everything is compared bit for bit; the deltas are integers."""

import numpy as np
import pytest
import torch

import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.ops import conemode as tc
from micro_quad_slam_tpu_torch.ops import conex as cx
from micro_quad_slam_tpu_torch.ops import raycast as tr
from micro_quad_slam_tpu_torch.replay import mapping as tm

torch.set_num_threads(2)

CFG, TOF = port.UL_PROFILE.map, port.UL_PROFILE.tof
GEOM = tr.DEFAULT_GEOM
CONE = tc.ConeConfig()
K = tc.cone_constants(CFG.res_m, TOF, CONE)
CHUNK = 16           # frames per classification, to bound the memory


def _flip(v, neg):
    """-v where neg: an exact flip of the sign bit."""
    return torch.where(neg, -v, v)


def factored_delta(inp: dict, hybrid: bool):
    """The kernel's classification of N frames' [WR, WC] windows (inputs
    as scan_inputs gives them): (gated delta int32 [N, WR, WC], the cells'
    classes {beyond_reach, outside_fans, classified} bool [N, WR, WC])."""
    WR, WC, R = GEOM.win_rows, GEOM.win_cols, GEOM.win_r
    inf = torch.tensor(float("inf"))
    ay = torch.arange(WR, dtype=torch.float32)[None] + inp["oyc"][:, None]
    ax = torch.arange(WC, dtype=torch.float32)[None] + inp["oxc"][:, None]
    # the row and column product tables, one rounding each
    b = inp["bounds"]
    row = b[:, :, None, None] * ay[:, None, :, None]      # [N, 18, WR, 1]
    col = b[:, :, None, None] * ax[:, None, None, :]      # [N, 18, 1, WC]
    gy = torch.arange(WR)[None] + (inp["pcy"] - R)[:, None]
    gx = torch.arange(WC)[None] + (inp["pcx"] - R)[:, None]
    ayy = torch.where((gy >= 0) & (gy < CFG.height), ay * ay, inf)
    axx = torch.where((gx >= 0) & (gx < CFG.width), ax * ax, inf)
    # the sector thresholds and the frame's reach
    p = inp["packed"]
    d = p.abs()
    valid = d > K["skip"]
    dfree = (d - K["free_margin"]).clamp_min(0.0) * K["inv_res"]
    olo = (d - K["hit_band"]).clamp_min(0.0) * K["inv_res"]
    ohi = (d + K["hit_band"]) * K["inv_res"]
    dfree2 = torch.where(valid, dfree * dfree, 0.0)
    olo2 = olo * olo
    ohi2 = torch.where(valid & (p > 0.0) & (not hybrid), ohi * ohi, -1.0)
    reach2 = torch.where(inp["en"], torch.maximum(dfree2, ohi2).amax(1), -1.0)

    rng2 = axx[:, None, :] + ayy[:, :, None]               # [N, WR, WC]
    near = rng2 <= reach2[:, None, None]
    pxx, pyx, pxy, pyy = col[:, 0], col[:, 1], row[:, 0], row[:, 1]
    m0 = (pxx > -pyy) & (pxy >= pyx)
    m1 = ~m0 & (pxy > pyx)
    m2 = ~m0 & ~m1 & (pxx < -pyy)
    d1 = ~m0 & ~m1
    d0 = m1 | (d1 & ~m2)
    # b * ayq = +-(d0 ? col : row), negative when d0 != d1; b * axq =
    # +-(d0 ? row : col), negative when d1
    shape = (row.shape[0], 18, WR, WC)
    py = torch.where(d0[:, None], col.expand(shape), row.expand(shape))
    px = torch.where(d0[:, None], row.expand(shape), col.expand(shape))
    negy, negx = d0 != d1, d1

    def above(k):
        k = torch.as_tensor(k).expand(d0.shape)[:, None]
        return (_flip(py.gather(1, 2 * k)[:, 0], negy)
                > _flip(px.gather(1, 2 * k + 1)[:, 0], negx))

    in_fan = ~above(8)
    # each fan's column-test depth (a skipped test reads as 0): 0 where its
    # 8 sectors hold the same thresholds, 1 where each half does, 2 where
    # each pair does, else 3
    thr = torch.stack([dfree2] if hybrid else [dfree2, olo2, ohi2], -1)
    fans = thr.view(-1, 4, 8, thr.shape[-1])

    def uniform(n):
        groups = fans.view(fans.shape[0], 4, 8 // n, n, -1)
        return (groups == groups[:, :, :, :1]).flatten(2).all(-1)

    depth = torch.where(uniform(8), 0, torch.where(
        uniform(4), 1, torch.where(uniform(2), 2, 3)))          # [N, 4]
    fan = 2 * d1.long() + d0.long()
    n = depth.gather(1, fan.flatten(1)).view(fan.shape)
    b2 = (above(4) & (n > 0)).long()
    b1 = (above(2 + 4 * b2) & (n > 1)).long()
    b0 = (above(1 + 4 * b2 + 2 * b1) & (n > 2)).long()
    sector = 8 * fan + 4 * b2 + 2 * b1 + b0
    at = lambda t: t.gather(1, sector.flatten(1)).view(sector.shape)  # noqa: E731
    free = (rng2 > 0.0) & (rng2 < at(dfree2)) & (rng2 <= K["maxr2"])
    delta = torch.where(free, -CONE.free_dec, 0)
    if not hybrid:
        occ = (rng2 >= at(olo2)) & (rng2 <= at(ohi2))
        delta = torch.where(occ, CONE.occ_inc, delta)
    delta = torch.where(near & in_fan, delta, 0).to(torch.int32)
    classified = near & in_fan
    return delta, {"beyond_reach": ~near, "outside_fans": near & ~in_fan,
                   "classified": classified, "rng2": rng2,
                   **{f"depth{k}": classified & (n == k) for k in range(4)}}


def reference_delta(inp: dict, hybrid: bool) -> torch.Tensor:
    """conemode.cone_cell_delta, gated by the logical grid and `en` as
    conemode.window_update gates it."""
    WR, WC, R = GEOM.win_rows, GEOM.win_cols, GEOM.win_r
    rows = torch.arange(WR, dtype=torch.int32)[:, None]
    cols = torch.arange(WC, dtype=torch.int32)[None, :]
    delta = tc.cone_cell_delta(rows.float(), cols.float(), inp["oxc"],
                               inp["oyc"], CFG.res_m, inp["bounds"],
                               inp["packed"], TOF, CONE,
                               with_occ_band=not hybrid)
    gy = rows + (inp["pcy"] - R).view(-1, 1, 1)
    gx = cols + (inp["pcx"] - R).view(-1, 1, 1)
    inb = (gy >= 0) & (gy < CFG.height) & (gx >= 0) & (gx < CFG.width)
    return torch.where(inb & inp["en"].view(-1, 1, 1), delta, 0)


def _bench_inputs(hybrid: bool) -> dict:
    """Every window of the committed bench flight, through the replay's
    own schedule (replay/mapping.py::schedule, ops/conex.py's words)."""
    frames = port.frames_to_torch(testdata.bench_frames(1), "cpu")
    sched, _, _ = tm.schedule(frames, port.UL_PROFILE,
                              mode="hybrid" if hybrid else "cone")
    return cx._frame_inputs(sched[0], GEOM, hybrid)


def _scan_inputs(beams, x, y, yaw, hybrid, en=None):
    n = len(x)
    z = np.zeros(n, np.float32)
    en = np.ones(n, bool) if en is None else en
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))           # noqa: E731
    return tc.scan_inputs(t(beams), t(x), t(y), t(yaw), t(z), t(z), t(en),
                          CFG, TOF, GEOM, hybrid)


def _random_inputs(hybrid: bool) -> dict:
    """64 seeded frames: beams across the whole range (no return, at the
    skip distance, hits, misses at and past max range), poses over and
    past the grid, random yaw, a tenth of the frames disabled."""
    rng = np.random.default_rng(11)
    n = 64
    beams = rng.uniform(0.0, 4.4, (n, 4, 8)).astype(np.float32)
    pick = rng.random(beams.shape)
    beams[pick < 0.08] = np.nan
    beams[(pick >= 0.08) & (pick < 0.12)] = np.float32(0.05)
    beams[(pick >= 0.12) & (pick < 0.16)] = np.float32(3.95)
    beams[(pick >= 0.16) & (pick < 0.20)] = np.float32(4.0)
    x = rng.uniform(-26, 26, n).astype(np.float32)
    y = rng.uniform(-26, 26, n).astype(np.float32)
    yaw = rng.uniform(-180, 180, n).astype(np.float32)
    return _scan_inputs(beams, x, y, yaw, hybrid, rng.random(n) > 0.1)


def _cell_centre_inputs(hybrid: bool) -> dict:
    """Poses on exact cell centres at yaw 0, 45 and 90 degrees (the
    geometry of angular ties), as test_torch_conemode.py places them."""
    rng = np.random.default_rng(12)
    n = 24
    beams = rng.uniform(0.1, 4.2, (n, 4, 8)).astype(np.float32)
    x = np.round(rng.uniform(-20, 20, n)).astype(np.float32)
    y = np.round(rng.uniform(-20, 20, n)).astype(np.float32)
    yaw = np.resize(np.array([0.0, 45.0, 90.0], np.float32), n)
    return _scan_inputs(beams, x, y, yaw, hybrid)


def _band_edge_inputs(hybrid: bool) -> dict:
    """Hits just short of 3.95 m (the hit limit, max range less the hit
    margin): their occupied band reaches (3.949 + 0.10) / 0.10 = 40.49
    cells, so ohi^2 > maxr2 = 1,600."""
    n = 6
    beams = np.full((n, 4, 8), np.float32(3.949), np.float32)
    beams[1::2, :, 1::2] = np.float32(2.5)
    x = np.array([0.0, 0.03, -1.0, 2.47, 0.0, -0.51], np.float32)
    y = np.array([0.0, -0.02, 1.0, 0.33, 0.0, 0.26], np.float32)
    yaw = np.array([0.0, 45.0, 90.0, 17.0, -135.0, 180.0], np.float32)
    return _scan_inputs(beams, x, y, yaw, hybrid)


CASES = {"bench_flight": _bench_inputs, "random_frames": _random_inputs,
         "cell_centres": _cell_centre_inputs,
         "band_edge_hits": _band_edge_inputs}


def _chunks(inp: dict):
    n = inp["oxc"].shape[0]
    for i in range(0, n, CHUNK):
        yield {k: v[i:i + CHUNK] for k, v in inp.items()}


@pytest.mark.parametrize("hybrid", [False, True], ids=["cone", "hybrid"])
@pytest.mark.parametrize("case", list(CASES))
def test_factored_classification_equals_cone_cell_delta(case, hybrid):
    inp = CASES[case](hybrid)
    counts = dict.fromkeys(("beyond_reach", "outside_fans", "classified"), 0)
    depths = [0] * 4
    moved = 0
    for part in _chunks(inp):
        got, cls = factored_delta(part, hybrid)
        want = reference_delta(part, hybrid)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want), (case, int((got != want).sum()))
        for k in counts:
            counts[k] += int(cls[k].sum())
        for k in range(4):
            depths[k] += int(cls[f"depth{k}"].sum())
        moved += int((want != 0).sum())
    assert moved > 0
    # the early exits take cells on every input set, and never all
    assert counts["classified"] > 0 and counts["beyond_reach"] > 0
    if case != "random_frames":
        assert counts["outside_fans"] > 0
    # the bench flight's misses leave every fan uniform; varied returns
    # need the whole column search (hybrid mode's min-of-3 smoothing
    # evens out the band-edge frames' alternating returns)
    if case == "bench_flight":
        assert depths[0] > 0
    elif case != "band_edge_hits" or not hybrid:
        assert depths[3] > 0
    assert sum(depths) == counts["classified"]


@pytest.mark.parametrize("hybrid", [False, True], ids=["cone", "hybrid"])
def test_reach_threshold_keeps_the_occupied_band_past_maxr2(hybrid):
    """In cone mode a hit's occupied band reaches past maxr2, so the
    frame's reach threshold has to be the max of the hits' ohi^2 and the
    free thresholds: an exit on maxr2 alone would drop these cells.  In
    hybrid mode the carve alone sets the reach, inside maxr2."""
    inp = _band_edge_inputs(hybrid)
    got, cls = factored_delta(inp, hybrid)
    past = cls["rng2"] > K["maxr2"]
    if hybrid:
        assert not (got != 0)[past].any()
    else:
        assert int((got == CONE.occ_inc)[past].sum()) > 0
        assert torch.equal(got, reference_delta(inp, hybrid))
