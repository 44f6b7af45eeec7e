"""The port's pass 1 with match feedback (slam/pipeline.py::_map_pass_fb:
SlamConfig.match_feedback=True, or match_map_kf_only=False) against the
JAX package on the CPU.

- On the recentering flight of tests/test_slam.py:593-628 (B=4, T=64,
  kf_every 8, a -20 flow excursion on flight 3), fed the JAX package's
  odometry and recenter schedule, the port's chunked pass equals the JAX
  package's sequential pass (_map_pass with match=True, a snapshot every
  chunk, the keyframe update mask in kf-only mode): grids bit-equal,
  matched poses within POSE_TOL (the sub-cell refinement's float
  arithmetic, which XLA-CPU contracts into fmas and the port does not).
  The accept gate is lowered to 0.05 (tests/test_slam.py:648-653) so that
  live corrections land on the map.
- slam_replay whole, in both formulations, against the JAX package's
  slam_replay on the CPU (testdata slam_fb_ref; tests/test_torch_testdata
  makes it): odometry within 1e-5, nodes and track within 1e-4, grid sums
  and weighted sums equal, as tests/test_torch_slam.py holds the default
  formulation, on all 4 flights.
- The kernel calls of the path, counted on the CPU: one lattice batch and
  one map_chunk_sched per chunk.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_quad_slam_tpu.ops import scanmatch as jsm
from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM as JAX_GEOM
from micro_quad_slam_tpu.slam import pipeline as jp
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.ops import residentx as rx
from micro_quad_slam_tpu_torch.ops import scanmatch as sm
from micro_quad_slam_tpu_torch.ops.beams import extract_beams
from micro_quad_slam_tpu_torch.slam import pipeline as sp
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE
from test_torch_testdata import (
    FB_FORMS,
    FB_KF_EVERY,
    _formulation,
    _jax_sequential_pass,
    recentering_flight,
)

torch.set_num_threads(2)

GEOM = port.DEFAULT_GEOM
POSE_TOL = 1e-6       # matched poses of the pass (m, rad): ~4 ulp at 3 m
BENCH_TOL = {"odo_track": 1e-5, "kf_nodes": 1e-4, "track": 1e-4}


def _close(got, want, atol, name):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                               err_msg=name)


# -------------------------------------------- pass 1, recentering flight

@pytest.fixture(scope="module")
def rc_jax():
    """The JAX package's sequential pass of both formulations, now."""
    return {form: _jax_sequential_pass(recentering_flight(), form)
            for form in FB_FORMS}


def _port_pass(form: str, seq: dict):
    frames = port.frames_to_torch(recentering_flight(), "cpu")
    cfg = _formulation(UL_PROFILE, form, match_min_quality=0.05)
    beams, _ = extract_beams(frames["grid_mm"], cfg.tof)
    sched = {k[6:]: torch.tensor(v) for k, v in seq.items()
             if k.startswith("sched_")}
    return sp._map_pass_fb(beams, torch.tensor(seq["odo"]), cfg, GEOM,
                           FB_KF_EVERY, sched)


@pytest.mark.parametrize("form", sorted(FB_FORMS))
def test_feedback_pass_equals_jax_sequential_pass(rc_jax, form):
    seq = rc_jax[form]
    assert int(seq["sched_do"].sum()) >= 1                # recenters fired
    grid, matched = _port_pass(form, seq)
    np.testing.assert_array_equal(grid.numpy(), seq["grid"])
    _close(matched, seq["matched"], POSE_TOL, "matched")
    # live corrections: some keyframe moved off its odometry pose
    kf = slice(0, None, FB_KF_EVERY)
    moved = np.abs(seq["matched"][:, kf, :2] - seq["odo"][:, kf, :2]) > 1e-4
    assert moved.any(-1).sum() >= 2
    # the committed reference is this pass
    ref = testdata.reference("slam_fb_ref")
    np.testing.assert_array_equal(ref[f"rc_{form}_grid"], seq["grid"])
    np.testing.assert_array_equal(ref[f"rc_{form}_matched"], seq["matched"])


def test_feedback_pass_leaves_grid0_and_ends_at_the_tail_recenter(rc_jax):
    """A non-empty grid0 lands under the pass and is left as it was; in
    kf-only mode the recenters after the last keyframe still roll."""
    seq = rc_jax["fb"]
    frames = port.frames_to_torch(recentering_flight(), "cpu")
    cfg = _formulation(UL_PROFILE, "fb", match_min_quality=0.05)
    beams, _ = extract_beams(frames["grid_mm"], cfg.tof)
    sched = {k[6:]: torch.tensor(v) for k, v in seq.items()
             if k.startswith("sched_")}
    odo = torch.tensor(seq["odo"])
    grid0 = torch.tensor(seq["grid"])
    g, _ = sp._map_pass_fb(beams, odo, cfg, GEOM, FB_KF_EVERY, sched,
                           grid0=grid0)
    assert torch.equal(grid0, torch.tensor(seq["grid"]))
    assert not torch.equal(g, grid0)
    # a schedule whose only recenter comes after the last keyframe
    T = seq["odo"].shape[1]
    late = {k: torch.zeros_like(v) if k in ("do", "rsy", "rsx") else v
            for k, v in sched.items()}
    late["do"][0, T - 1], late["rsy"][0, T - 1] = 1, 3
    g_late, _ = sp._map_pass_fb(beams, odo, cfg, GEOM, FB_KF_EVERY, late)
    g_none, _ = sp._map_pass_fb(beams, odo, cfg, GEOM, FB_KF_EVERY,
                                {**late, "do": torch.zeros_like(late["do"])})
    assert torch.equal(g_late[1:], g_none[1:])
    assert torch.equal(g_late[0, :-3], g_none[0, 3:])


@pytest.mark.parametrize("form", sorted(FB_FORMS))
def test_feedback_pass_on_bench_flights_equals_jax(form):
    """slam_replay's first pass 1 on the 4 SLAM bench flights (T=256, UL
    profile), fed the JAX package's odometry and schedule (slam_fb_ref
    pass1_*): grids equal, matched poses within POSE_TOL.  chip_smoke.py
    repeats it on the card at B=128."""
    ref = testdata.reference("slam_fb_ref")
    frames = testdata.slam_bench_frames(4, device="cpu")
    cfg = _formulation(UL_PROFILE, form)
    beams, _ = extract_beams(frames["grid_mm"], cfg.tof)
    sched = {k[12:]: torch.tensor(v) for k, v in ref.items()
             if k.startswith("pass1_sched_")}
    grid, matched = sp._map_pass_fb(beams, torch.tensor(ref["pass1_odo"]),
                                    cfg, GEOM, cfg.slam.kf_every, sched)
    np.testing.assert_array_equal(grid.numpy(), ref[f"pass1_{form}_grid"])
    _close(matched, ref[f"pass1_{form}_matched"], POSE_TOL, "matched")


# --------------------------------------------- slam_replay, bench flights

@pytest.fixture(scope="module")
def bench_runs():
    """The port's slam_replay of the 4 SLAM bench flights in both
    formulations, with the input of the last loop stage of each run."""
    frames = testdata.slam_bench_frames(4, device="cpu")
    runs = {}
    for form in FB_FORMS:
        seen = []
        real = sp._loop_stage

        def spy(kfp, *args):
            seen.append(kfp.clone())
            return real(kfp, *args)

        sp._loop_stage = spy
        try:
            res = sp.slam_replay(frames, _formulation(UL_PROFILE, form))
        finally:
            sp._loop_stage = real
        runs[form] = (res, seen[-1])
    return frames, runs


@pytest.mark.parametrize("form", sorted(FB_FORMS))
def test_slam_replay_formulation_matches_jax_on_bench_flights(bench_runs,
                                                              form):
    """Every flight within tests/test_torch_slam.py's tolerances, grid
    sums equal."""
    _, runs = bench_runs
    res, _ = runs[form]
    ref = testdata.reference("slam_fb_ref")
    for k, tol in BENCH_TOL.items():
        np.testing.assert_allclose(getattr(res, k).numpy(), ref[f"{form}_{k}"],
                                   rtol=0, atol=tol, err_msg=k)
    sums = testdata.grid_sums(res.grid.numpy())
    for k in ("sums", "weighted"):
        np.testing.assert_array_equal(sums[k], ref[f"{form}_{k}"],
                                      err_msg=k)


def test_all_frames_last_loop_stage_equals_both_jax_branches(bench_runs):
    """The match_map_kf_only=False bench run's last loop stage, fed the
    port's own keyframe poses, against the JAX package's _loop_stage on
    the same inputs through both of its branches: the kernel branch (the
    Pallas lattice matcher in interpret mode; the branch the TPU runs and
    the port follows) and the XLA branch (the CPU default that made the
    reference).  Edges and gates equal, measurements and qualities within
    1e-5, and every candidate match's lattice cells equal to the JAX
    package's: the float endpoint arithmetic that can put a lattice cell
    apart (ROADMAP section C) puts none apart here."""
    frames, runs = bench_runs
    _, kfp = runs["all"]
    cfg = _formulation(UL_PROFILE, "all")
    jcfg = _formulation(JAX_UL, "all")
    beams, _ = extract_beams(frames["grid_mm"], cfg.tof)
    _, sched = sp._odo_and_schedule(frames, cfg)
    kf = torch.arange(0, frames["x_m"].shape[1], cfg.slam.kf_every)
    ops = (kfp, beams[:, kf], sched["ox"][:, kf], sched["oy"][:, kf])
    got = [o.numpy() for o in sp._loop_stage(*ops, cfg, GEOM)]
    jops = [jnp.asarray(o.numpy()) for o in ops]
    for use_kernel in (True, False):
        want = [np.asarray(o) for o in jp._loop_stage(
            *jops, jcfg, JAX_GEOM, use_kernel=use_kernel)]
        np.testing.assert_array_equal(got[0], want[0])        # ij
        np.testing.assert_array_equal(got[2], want[2])        # ok
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)
    s = cfg.slam
    _, _, _, args = sp._loop_candidates(*ops, cfg, GEOM)
    cells = sm._lattice_cells(*args[3:], cfg.map, cfg.tof, s.loop_n_xy,
                              s.loop_n_yaw, s.match_xy_step_m,
                              s.match_yaw_step_deg)
    jcells = jax.jit(jax.vmap(lambda *a: jsm._lattice_cells(
        *a, jcfg.map, jcfg.tof, s.loop_n_xy, s.loop_n_yaw,
        s.match_xy_step_m, s.match_yaw_step_deg)))(
            *[jnp.asarray(a.numpy()) for a in args[3:]])
    assert len(cells) == len(jcells)
    for a, b in zip(cells, jcells):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_feedback_path_calls_one_match_and_one_map_chunk_per_chunk(
        monkeypatch):
    """The UL bench SLAM's kernel calls, counted on the CPU at B=1 (the
    counts do not depend on B): T=256, kf_every 10 and 4 intervals a chunk
    give 7 chunks a round, 3 rounds: match_lattice 21 (pass 1) + 8 (the
    loop stage: 1 + 1 early refine, 1, 1 + 3 refines) = 29; replay_exact
    21 (pass 1) + 1 (pass 3) = 22; the snapshot entry never."""
    calls = {"match_lattice": 0, "replay_exact": 0, "replay_exact_snap": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(sm, "match_lattice",
                        counted("match_lattice", sm.match_lattice))
    monkeypatch.setattr(rx, "replay_exact",
                        counted("replay_exact", rx.replay_exact))
    monkeypatch.setattr(rx, "replay_exact_snap",
                        counted("replay_exact_snap", rx.replay_exact_snap))
    frames = {k: v[:1] for k, v in
              testdata.slam_bench_frames(4, device="cpu").items()}
    sp.slam_replay(frames, _formulation(UL_PROFILE, "fb"))
    assert calls == {"match_lattice": 29, "replay_exact": 22,
                     "replay_exact_snap": 0}
