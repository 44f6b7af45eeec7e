"""The port's committed test data (micro_quad_slam_tpu_torch/testdata),
which chip_smoke.py uses on the card without the JAX package: every flight
must equal, bit for bit, what the JAX package's flight simulator and
golden C model give today, the bench workload built from them must equal
bench.py's, and the stored hybrid replay results must equal the JAX
package's kernel="hybrid" replay (a few bench flights re-derived).

This file is also the generator of that data.  From the repository root:

    JAX_PLATFORMS=cpu python tests/test_torch_testdata.py [name ...]

rewrites every file, or the named ones (the B=1024 hybrid bench sums run
on the CPU in chunks of 64 flights; the SLAM references compile the JAX
package's SLAM pipeline once per profile and stage, several minutes;
swarm_bench_ref is the port's own CPU run of the whole B=1024 bench
swarm, minutes and ~1 GB: testdata.swarm_bench_result("cpu") computes it
without JAX, on any machine with torch).
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from micro_quad_slam_tpu.golden import golden_replay_mapping  # noqa: E402
from micro_quad_slam_tpu.replay import fusion as jfusion  # noqa: E402
from micro_quad_slam_tpu.replay import mapping as jm  # noqa: E402
from micro_quad_slam_tpu.sim import slam_bench_frames as jax_slam_bench_frames  # noqa: E402
from micro_quad_slam_tpu.sim import synth_room_scanlog  # noqa: E402
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL  # noqa: E402
from micro_quad_slam_tpu.utils.config import UL_RT_PROFILE as JAX_UL_RT  # noqa: E402
import micro_quad_slam_tpu_torch as port  # noqa: E402
from micro_quad_slam_tpu_torch import testdata  # noqa: E402

torch.set_num_threads(2)


# ------------------------------------------------------------- generator

def _stack(logs) -> dict:
    arrs = [jm.scanlog_to_arrays(lg) for lg in logs]
    return {k: np.stack([a[k] for a in arrs]) for k in arrs[0]}


class _FramesLog:
    """One flight of a frames dict, seen as a scanlog by the golden model."""

    def __init__(self, frames: dict, b: int):
        for k, v in frames.items():
            setattr(self, k, v[b])

    def __len__(self):
        return self.x_m.shape[0]


def _with_golden(frames: dict) -> dict:
    runs = [golden_replay_mapping(_FramesLog(frames, b))
            for b in range(frames["x_m"].shape[0])]
    return {**frames,
            "golden_grid": np.stack([m.grid for m, _ in runs]),
            "golden_used": np.stack([u for _, u in runs]),
            "golden_recentered": np.array([m.recentered for m, _ in runs]),
            "golden_origin_x": np.array([m.origin_x for m, _ in runs],
                                        np.float32)}


def random_flights(B: int = 8, T: int = 64) -> dict:
    logs = [synth_room_scanlog(n_frames=T, seed=s, noise_mm=5.0,
                               dropout_p=0.05, path=("circle", "hover")[s % 2])
            for s in range(B - 1)]
    logs.append(synth_room_scanlog(n_frames=T, seed=99, state=1))
    f = _stack(logs)
    f["x_m"][1] = np.linspace(0.0, 34.0, T, dtype=np.float32)
    f["y_m"][1] = np.linspace(0.0, -21.0, T, dtype=np.float32)
    return f


def golden_hover() -> dict:
    return _with_golden(_stack([synth_room_scanlog(
        n_frames=32, room=(-2.0, -2.0, 2.0, 2.0), path="hover",
        yaw_rate_dps=20.0, noise_mm=6.0, dropout_p=0.05, seed=11)]))


def golden_line_recenter() -> dict:
    return _with_golden(_stack([synth_room_scanlog(
        n_frames=40, room=(-3.0, -3.0, 40.0, 3.0), path="line",
        path_radius_m=18.0, seed=13, noise_mm=4.0)]))


def golden_short_beams() -> dict:
    B, T = 2, 3
    grid_mm = np.full((B, T, 4, 8, 8), 51, np.uint16)
    grid_mm[1] = 53
    return _with_golden({
        "grid_mm": grid_mm,
        "x_m": np.zeros((B, T), np.float32),
        "y_m": np.zeros((B, T), np.float32),
        "yaw_deg": np.full((B, T), 45.0, np.float32),
        "of_q": np.full((B, T), 200, np.int32),
        "of_rate_x": np.zeros((B, T), np.float32),
        "sys_health": np.zeros((B, T), np.int64),
        "state": np.full((B, T), 5, np.uint8)})


def bench_flight() -> dict:
    """bench.py:191-194's base flight."""
    return _stack([synth_room_scanlog(n_frames=256, seed=0, path="hover",
                                      yaw_rate_dps=20.0, noise_mm=5.0)])


def _jax_hybrid_grids(frames: dict) -> np.ndarray:
    """The JAX package's kernel="hybrid" replay: padded grids [B, PR, PC]."""
    st, _ = jm.replay_mapping_batched(frames, JAX_UL, kernel="hybrid")
    return np.asarray(st.grid)


def hybrid_random_flights() -> dict:
    frames, _ = testdata.load("random_flights")
    grids = torch.from_numpy(_jax_hybrid_grids(frames).copy())
    return {"grid": port.logical_grid(grids).contiguous().numpy()}


def _bench_sums(flights, chunk: int = 64) -> dict:
    """testdata.grid_sums of the JAX hybrid replay of the listed bench
    flights, `chunk` flights per call."""
    frames = testdata.bench_frames(1024)
    flights = np.asarray(flights)
    parts = [testdata.grid_sums(_jax_hybrid_grids(
        {k: v[flights[i:i + chunk]] for k, v in frames.items()}))
        for i in range(0, len(flights), chunk)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def hybrid_bench_sums() -> dict:
    return _bench_sums(np.arange(1024))


def slam_bench_flights() -> dict:
    """sim/synthio.py::slam_bench_frames' 4 distinct flights at T=256."""
    return jax_slam_bench_frames(4, 256, device_put=False)


def _jax_slam(frames: dict, profile, upto: int = 99):
    from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM
    from micro_quad_slam_tpu.slam.pipeline import _slam_impl

    out = _slam_impl(frames, profile, DEFAULT_GEOM, None, None, None, upto)
    return jax.tree_util.tree_map(np.asarray, out)


def slam_bench_ref() -> dict:
    frames = testdata.load("slam_bench_flights")[0]
    out = {}
    for tag, profile in (("ul", JAX_UL), ("rt", JAX_UL_RT)):
        res = _jax_slam(frames, profile)
        sums = testdata.grid_sums(res.grid)
        out.update({f"{tag}_track": res.track, f"{tag}_odo_track": res.odo_track,
                    f"{tag}_kf_nodes": res.kf_nodes,
                    f"{tag}_sums": sums["sums"],
                    f"{tag}_weighted": sums["weighted"]})
    _, track = jfusion.replay_fusion_batched(frames, JAX_UL)
    out["ekf_x"] = np.asarray(track["x"])
    return out


def slam_stage_inputs() -> dict:
    """tests/test_slam.py::test_slam_small_end_to_end's batch: a 60-frame
    circle with a 6% flow-scale drift, and its copy 5 m east."""
    log = synth_room_scanlog(n_frames=60, path="circle", path_radius_m=1.0,
                             room=(-2.5, -2.5, 2.5, 2.5), with_flow=True,
                             seed=3)
    log.of_rate_x[:] *= 1.06
    log.of_rate_y[:] *= 1.06
    f = {**jm.scanlog_to_arrays(log), **jfusion.fusion_arrays(log)}
    east = {**f, "x_m": f["x_m"] + np.float32(5.0)}
    return {k: np.stack([f[k], east[k]]) for k in f}


def slam_stage_profile(cfg):
    """test_slam_small_end_to_end's trimmed profile of `cfg` (either
    package's PipelineConfig): 2 outer rounds, 1 refine."""
    return dataclasses.replace(cfg, slam=dataclasses.replace(
        cfg.slam, slam_outer=2, loop_refine=1, loop_refine_early=1,
        gn_refine_iters=2, match_iters_later=1))


def _stage_outputs(upto: int, out) -> dict:
    """One stage's outputs under their reference keys."""
    if upto == 0:
        odo, sched = out
        return {"s0_odo": odo, **{f"s0_{k}": v for k, v in sched.items()}}
    if upto == 1:
        return {"s1_matched": out}
    if upto == 2:
        return dict(zip(("s2_matched", "s2_ij", "s2_z", "s2_ok"), out))
    if upto == 3:
        return {"s3_kf_nodes": out[0], "s3_gn_costs": out[1]}
    return {"s4_track": out.track, "grid": out.grid,
            "origin_x": out.origin[0], "origin_y": out.origin[1]}


def _jax_slam_stage(frames: dict, upto: int) -> dict:
    from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM
    from micro_quad_slam_tpu.slam.pipeline import _slam_impl

    out = _slam_impl(frames, slam_stage_profile(JAX_UL), DEFAULT_GEOM, 10, 4,
                     None, upto)
    return _stage_outputs(upto, jax.tree_util.tree_map(np.asarray, out))


def slam_stages() -> dict:
    frames = slam_stage_inputs()
    out = {f"in_{k}": v for k, v in frames.items()}
    for upto in (0, 1, 2, 3, 99):
        out.update(_jax_slam_stage(frames, upto))
    return out


FB_FORMS = {"fb": {"match_feedback": True},
            "all": {"match_map_kf_only": False}}
FB_KF_EVERY = 8        # the recentering flight's keyframe interval


def _formulation(cfg, form: str, **extra):
    """`cfg` (either package's PipelineConfig) with pass 1's formulation
    `form` of FB_FORMS and any other SlamConfig overrides."""
    return dataclasses.replace(cfg, slam=dataclasses.replace(
        cfg.slam, **FB_FORMS[form], **extra))


def recentering_flight() -> dict:
    """tests/test_slam.py:593-628's batch: two 64-frame circles (flow on,
    6 mm noise), each twice, with a -20 flow excursion on flight 3 that
    drags its odometry far enough to recenter."""
    logs = [synth_room_scanlog(n_frames=64, seed=s, path="circle",
                               noise_mm=6.0, with_flow=True)
            for s in range(2)]
    frs = [{**jm.scanlog_to_arrays(lg), **jfusion.fusion_arrays(lg)}
           for lg in logs]
    b4 = {k: np.stack([f[k] for f in frs] * 2) for k in frs[0]}
    b4["of_rate_x"][3] = b4["of_rate_x"][3] + np.float32(-20.0)
    return b4


def _jax_sequential_pass(frames: dict, form: str, bench: bool = False
                         ) -> dict:
    """The JAX package's sequential feedback pass 1 (_map_pass with
    match=True, a snapshot every chunk, the keyframe update mask in
    kf-only mode) on the odometry and schedule of `frames`: on the
    recentering flight with kf_every FB_KF_EVERY and the lowered accept
    gate of tests/test_slam.py:648-653, so that live corrections land;
    with bench=True, as slam_replay's first round runs it (UL profile,
    the fused odometry and schedule)."""
    import jax.numpy as jnp
    from micro_quad_slam_tpu.ops.beams import extract_beams
    from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM
    from micro_quad_slam_tpu.slam.pipeline import (
        _ekf_track, _map_pass, _odo_and_schedule, _origin_schedule)

    bj = {k: jnp.asarray(v) for k, v in frames.items()}
    T = frames["x_m"].shape[1]
    if bench:
        cfg = _formulation(JAX_UL, form)
        kf_every = cfg.slam.kf_every
        odo, sched = _odo_and_schedule(bj, cfg)
    else:
        cfg = _formulation(JAX_UL, form, match_min_quality=0.05)
        kf_every = FB_KF_EVERY
        odo = _ekf_track(bj, cfg)
        sched = _origin_schedule(odo, cfg)
    beams, _ = extract_beams(bj["grid_mm"], cfg.tof)
    kf_mask = (jnp.arange(T) % kf_every) == 0
    snap = (jnp.arange(T) % (kf_every * cfg.slam.match_chunk_intervals)) == 0
    grid, matched = _map_pass(
        beams, odo, cfg, DEFAULT_GEOM, True, kf_mask, sched,
        snap_mask_t=snap,
        update_mask_t=kf_mask if cfg.slam.match_map_kf_only else None)
    out = {"odo": odo, "grid": grid, "matched": matched,
           **{f"sched_{k}": v for k, v in sched.items()}}
    return {k: np.asarray(v) for k, v in out.items()}


def _slam_fb_runs(frames: dict, stage: dict) -> dict:
    """slam_fb_ref's slam_replay results of both formulations on the
    bench flights and the stage batch."""
    from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM
    from micro_quad_slam_tpu.slam.pipeline import _slam_impl

    out = {}
    for form in FB_FORMS:
        res = _jax_slam(frames, _formulation(JAX_UL, form))
        sums = testdata.grid_sums(res.grid)
        out.update({f"{form}_track": res.track,
                    f"{form}_odo_track": res.odo_track,
                    f"{form}_kf_nodes": res.kf_nodes,
                    f"{form}_sums": sums["sums"],
                    f"{form}_weighted": sums["weighted"]})
        res = jax.tree_util.tree_map(np.asarray, _slam_impl(
            stage, _formulation(slam_stage_profile(JAX_UL), form),
            DEFAULT_GEOM, 10, 4, None, 99))
        sums = testdata.grid_sums(res.grid)
        out.update({f"stage_{form}_track": res.track,
                    f"stage_{form}_kf_nodes": res.kf_nodes,
                    f"stage_{form}_sums": sums["sums"],
                    f"stage_{form}_weighted": sums["weighted"]})
    return out


def slam_fb_ref() -> dict:
    """The feedback formulations of pass 1 in the JAX package, on the CPU:
    its slam_replay of slam_bench_flights and of the stage batch (trimmed
    profile, kf_every 10, gn_iters 4) with match_feedback=True (`fb_`) and
    with match_map_kf_only=False (`all_`), and its sequential pass 1 on
    the recentering flight (`rc_`) and, as slam_replay's first round
    runs it, on the bench flights (`pass1_`)."""
    out = _slam_fb_runs(testdata.load("slam_bench_flights")[0],
                        slam_stage_inputs())
    rc = recentering_flight()
    out.update({f"rc_in_{k}": v for k, v in rc.items()})
    for form in FB_FORMS:
        seq = _jax_sequential_pass(rc, form)
        out.update({f"rc_{form}_grid": seq["grid"],
                    f"rc_{form}_matched": seq["matched"]})
    out.update({f"rc_{k}": v for k, v in seq.items()
                if k == "odo" or k.startswith("sched_")})
    bench = testdata.load("slam_bench_flights")[0]
    for form in FB_FORMS:
        seq = _jax_sequential_pass(bench, form, bench=True)
        out.update({f"pass1_{form}_grid": seq["grid"],
                    f"pass1_{form}_matched": seq["matched"]})
    out.update({f"pass1_{k}": v for k, v in seq.items()
                if k == "odo" or k.startswith("sched_")})
    return out


def cl_fuzz_telemetry() -> dict:
    """tests/test_behavior_cl.py:160's fuzzed schedules (fc_mock's
    random_scenario, seeds 10000 on) as the golden CL machine's telemetry,
    the first CL_FUZZ_SEEDS of them for CL_FUZZ_TICKS ticks: each field
    [T, seeds]."""
    from fc_mock import random_scenario, run_scenario
    from micro_quad_slam_tpu.golden.behavior_cl import GoldenBehaviorCL
    from test_behavior import telems_to_arrays

    arrs = [telems_to_arrays(run_scenario(
        random_scenario(10_000 + s), n_ticks=testdata.CL_FUZZ_TICKS,
        machine=GoldenBehaviorCL())[0])
        for s in range(testdata.CL_FUZZ_SEEDS)]
    return {k: np.stack([a[k] for a in arrs], axis=1) for k in arrs[0]}


def jax_scan_draws(key, n_steps: int, dt_ms: int, scan_period_ms: int,
                   B: int) -> list:
    """The JAX simulator's scan-tick draws for a run from a state holding
    `key`: models/simulator.py::sim_step splits the key every tick
    (key, k_scan) and, on a scan tick, k_scan into (k1, k2) for the
    standard normal and the uniform draws [B, 4, 8, 8].  Returns one
    (normal, uniform) pair of numpy arrays per scan tick."""
    import jax.numpy as jnp

    draws, t = [], 0
    for _ in range(n_steps):
        key, k_scan = jax.random.split(key)
        t += dt_ms
        if t % scan_period_ms == 0:
            k1, k2 = jax.random.split(k_scan)
            shape = (B, 4, 8, 8)
            draws.append((np.asarray(jax.random.normal(k1, shape,
                                                       jnp.float32)),
                          np.asarray(jax.random.uniform(k2, shape))))
    return draws


def flatten_state(tree, prefix: str = "") -> dict:
    """A JAX simulator state (nested NamedTuples) -> {"a.b": numpy array},
    without the key."""
    out = {}
    for k, v in tree._asdict().items():
        if k == "key":
            continue
        if hasattr(v, "_asdict"):
            out.update(flatten_state(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def swarm_small_start():
    """bench.py's swarm start (bench.py:57) at B=8, with its world."""
    from micro_quad_slam_tpu.models.simulator import make_world, sim_init

    W = testdata.SWARM_WORLD
    return (sim_init(8, jax.random.PRNGKey(0), spread_m=0.5, airborne=True),
            make_world(8, room=W["room"], obstacles=list(W["obstacles"])))


def swarm_small_jax() -> dict:
    from micro_quad_slam_tpu.models.simulator import sim_run

    st, world = swarm_small_start()
    run = testdata.SWARM_RUN
    fin, diag = sim_run(st, world, testdata.SWARM_T, JAX_UL,
                        dt_ms=run["dt_ms"],
                        scan_period_ms=run["scan_period_ms"], record=True)
    draws = jax_scan_draws(st.key, testdata.SWARM_T, run["dt_ms"],
                           run["scan_period_ms"], 8)
    return {**{f"start.{k}": v for k, v in flatten_state(st).items()},
            "normal": np.stack([n for n, _ in draws]),
            "uniform": np.stack([u for _, u in draws]),
            "state": np.asarray(diag["state"]),
            "cmd_kind": np.asarray(diag["cmd_kind"]),
            "grid": np.asarray(fin.mapper.grid),
            "frontier": np.asarray(fin.frontier),
            "scan_count": np.asarray(fin.scan_count),
            "x": np.asarray(fin.x), "y": np.asarray(fin.y),
            "yaw": np.asarray(fin.yaw),
            "ekf_mean": np.asarray(fin.ekf.mean)}


def wire_ref() -> dict:
    """The JAX package's live-topology replay and SLAM of the committed
    wire capture (testdata.wire_capture), on the CPU."""
    from micro_quad_slam_tpu.replay.livestream import (replay_wirecap,
                                                       wirecap_to_frames)

    cap = testdata.wire_capture()
    out = {}
    for kernel, key in (("xla", "exact_grid"), ("hybrid", "hybrid_grid")):
        st, _, _ = replay_wirecap(cap, JAX_UL, kernel=kernel)
        grid = torch.from_numpy(np.asarray(st.grid).copy())
        out[key] = port.logical_grid(grid).contiguous().numpy()
    frames = {k: v[None] for k, v in wirecap_to_frames(cap).items()}
    res = _jax_slam(frames, JAX_UL)
    sums = testdata.grid_sums(res.grid)
    out.update(slam_track=res.track, slam_odo_track=res.odo_track,
               slam_kf_nodes=res.kf_nodes, slam_sums=sums["sums"],
               slam_weighted=sums["weighted"])
    return out


def swarm_bench_ref() -> dict:
    """The port's own CPU run of the whole bench swarm (minutes, ~1 GB)."""
    return testdata.swarm_bench_result("cpu")


def build(name: str) -> dict:
    if name not in testdata.NAMES + testdata.REFERENCES:
        raise ValueError(f"unknown test data {name!r}")
    return globals()[name]()


def main(names=None) -> int:
    for name in names or testdata.NAMES + testdata.REFERENCES:
        np.savez_compressed(testdata.path(name), **build(name))
        print(testdata.path(name), flush=True)
    return 0


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("name", testdata.NAMES)
def test_committed_flight_equals_its_source(name):
    frames, golden = testdata.load(name)
    with np.load(testdata.path(name)) as z:
        assert set(z.files) == set(frames) | {f"golden_{k}" for k in golden}
    want = build(name)
    assert set(want) == set(frames) | {f"golden_{k}" for k in golden}
    got = {**frames, **{f"golden_{k}": v for k, v in golden.items()}}
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_bench_frames_equal_bench_py():
    """bench.py:184-202 at B=16 (the jitter draws depend on B)."""
    B, T = 16, 256
    base = jm.scanlog_to_arrays(synth_room_scanlog(
        n_frames=T, seed=0, path="hover", yaw_rate_dps=20.0, noise_mm=5.0))
    rng = np.random.default_rng(1)
    want = {k: np.broadcast_to(v, (B,) + v.shape).copy()
            for k, v in base.items()}
    want["x_m"] = want["x_m"] + rng.normal(0, 0.3, (B, 1)).astype(np.float32)
    want["y_m"] = want["y_m"] + rng.normal(0, 0.3, (B, 1)).astype(np.float32)
    want["yaw_deg"] = np.mod(
        want["yaw_deg"] + rng.uniform(-180, 180, (B, 1)).astype(np.float32)
        + 180.0, 360.0) - 180.0
    got = testdata.bench_frames(B)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["golden_hover", "golden_line_recenter",
                                  "golden_short_beams"])
def test_exact_replay_equals_committed_golden(name):
    """The port's exact path on the CPU against the stored golden result,
    as chip_smoke.py's golden phase checks it on the card."""
    frames, golden = testdata.load(name)
    st, outs = port.replay_mapping_batched(
        port.frames_to_torch(frames, "cpu"), port.UL_PROFILE,
        kernel="residentx")
    np.testing.assert_array_equal(port.logical_grid(st.grid).numpy(),
                                  golden["grid"])
    np.testing.assert_array_equal(outs["used"].numpy(), golden["used"])
    np.testing.assert_array_equal(st.origin_x.numpy(), golden["origin_x"])
    np.testing.assert_array_equal(outs["kf_flags"].numpy().any(axis=1),
                                  golden["recentered"])


def test_hybrid_random_flights_equals_jax_now():
    want = build("hybrid_random_flights")["grid"]
    got = testdata.reference("hybrid_random_flights")["grid"]
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert (got > 10).sum() > 300 and (got < -10).sum() > 3000


@pytest.mark.parametrize("flight", [0, 511, 1023])
def test_hybrid_bench_sum_equals_jax_now(flight):
    """One bench flight at full T through the JAX hybrid replay, against
    its stored sum."""
    ref = testdata.reference("hybrid_bench_sums")
    assert set(ref) == {"sums", "weighted"}
    got = _bench_sums([flight])
    for k, v in ref.items():
        assert v.shape == (1024,) and v.dtype == np.int64, k
        assert int(got[k][0]) == int(v[flight]), k


def test_hybrid_references_equal_the_port_on_the_cpu():
    """The port's hybridx path (its kernel's plain version on the CPU)
    gives the stored JAX results: the small flights' grids and the sums
    of the three re-derived bench flights."""
    frames, _ = testdata.load("random_flights")
    st, _ = port.replay_mapping_batched(port.frames_to_torch(frames, "cpu"),
                                        port.UL_PROFILE, kernel="hybridx")
    np.testing.assert_array_equal(
        port.logical_grid(st.grid).numpy(),
        testdata.reference("hybrid_random_flights")["grid"])
    sel = [0, 511, 1023]
    bench = {k: v[sel] for k, v in testdata.bench_frames(1024).items()}
    st, _ = port.replay_mapping_batched(port.frames_to_torch(bench, "cpu"),
                                        port.UL_PROFILE, kernel="hybridx")
    got = testdata.grid_sums(st.grid.numpy())
    for k, v in testdata.reference("hybrid_bench_sums").items():
        np.testing.assert_array_equal(got[k], v[sel], err_msg=k)


def test_slam_bench_frames_equal_sim():
    """testdata.slam_bench_frames against sim/synthio.py::slam_bench_frames
    at B=10 (two full replications and a partial one): the committed
    flights at T=256, and the port's synthio at another T."""
    for B, T in ((10, 256), (6, 40)):
        want = jax_slam_bench_frames(B, T, device_put=False)
        got = testdata.slam_bench_frames(B, T, device="cpu")
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_slam_stage_inputs_and_odometry_equal_jax_now():
    """The stored stage inputs and the cheap first stage (pass 0) against
    the JAX package now; the later stages' compiles take minutes, so they
    are re-derived by the slow test below."""
    ref = testdata.reference("slam_stages")
    inputs = slam_stage_inputs()
    for k, v in inputs.items():
        np.testing.assert_array_equal(ref[f"in_{k}"], v, err_msg=k)
    for k, v in _jax_slam_stage(inputs, 0).items():
        np.testing.assert_array_equal(ref[k], v, err_msg=k)


def test_swarm_small_start_and_draws_equal_jax_now():
    """The stored JAX start state and scan draws against the JAX package
    now (its run's results are re-derived by the slow test below)."""
    ref = testdata.reference("swarm_small_jax")
    st, _ = swarm_small_start()
    for k, v in flatten_state(st).items():
        assert ref[f"start.{k}"].dtype == v.dtype, k
        np.testing.assert_array_equal(ref[f"start.{k}"], v, err_msg=k)
    run = testdata.SWARM_RUN
    draws = jax_scan_draws(st.key, testdata.SWARM_T, run["dt_ms"],
                           run["scan_period_ms"], 8)
    assert len(draws) == 10
    np.testing.assert_array_equal(ref["normal"], np.stack([n for n, _ in draws]))
    np.testing.assert_array_equal(ref["uniform"],
                                  np.stack([u for _, u in draws]))


@pytest.mark.parametrize("lanes", [[0, 511, 1023]])
def test_swarm_bench_ref_equals_the_port_now(lanes):
    """Three quads of the bench swarm, run by the port on the CPU with
    their part of the swarm's draws (quads are independent), give the
    stored per-quad sums; the stored checksum is their int32 total."""
    from micro_quad_slam_tpu_torch.models.simulator import sim_run

    ref = testdata.reference("swarm_bench_ref")
    assert ref["sums"].shape == (testdata.SWARM_B,)
    assert int(ref["checksum"]) == testdata.int32_total(ref["sums"])
    world, st, draws = testdata.swarm_bench(lanes, device="cpu")
    fin, _ = sim_run(st, world, testdata.SWARM_T, port.UL_PROFILE,
                     draws=draws, **testdata.SWARM_RUN)
    got = testdata.grid_sums(fin.mapper.grid.numpy())["sums"]
    np.testing.assert_array_equal(got, ref["sums"][lanes])


def test_wire_ref_grids_equal_jax_and_the_port_now():
    """The stored wire replay grids against the JAX package's replay of
    the capture now, and the port's (its kernels' plain versions on the
    CPU); the capture's flight is the first SLAM bench flight.  The SLAM
    part is re-derived by the slow test below."""
    from micro_quad_slam_tpu.replay.livestream import replay_wirecap
    from micro_quad_slam_tpu_torch.replay import livestream as tls

    ref = testdata.reference("wire_ref")
    flight = {**port.scanlog_to_arrays(testdata.wire_flight())}
    committed, _ = testdata.load("slam_bench_flights")
    for k, v in flight.items():
        np.testing.assert_array_equal(v, committed[k][0], err_msg=k)
    cap = testdata.wire_capture()
    for jkernel, kernel, key in (("xla", "residentx", "exact_grid"),
                                 ("hybrid", "hybridx", "hybrid_grid")):
        st, _, n = replay_wirecap(cap, JAX_UL, kernel=jkernel)
        want = port.logical_grid(torch.from_numpy(np.asarray(st.grid).copy()))
        np.testing.assert_array_equal(ref[key], want.numpy(), err_msg=key)
        tst, _, tn = tls.replay_wirecap(cap, port.UL_PROFILE, kernel=kernel,
                                        device="cpu")
        assert n == tn == 256
        np.testing.assert_array_equal(port.logical_grid(tst.grid).numpy(),
                                      ref[key], err_msg=kernel)
    assert (ref["exact_grid"] > 10).sum() > 100


def test_cl_fuzz_telemetry_equals_the_mock_now():
    want = cl_fuzz_telemetry()
    got = testdata.reference("cl_fuzz_telemetry")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    tiled = testdata.cl_fuzz(3 * testdata.CL_FUZZ_SEEDS, device="cpu")
    assert tiled["t_ms"].shape == (testdata.CL_FUZZ_TICKS,
                                   3 * testdata.CL_FUZZ_SEEDS)
    assert tiled["sys_health"].dtype == torch.int64
    np.testing.assert_array_equal(
        tiled["rf_m"][:, testdata.CL_FUZZ_SEEDS:].numpy(),
        np.concatenate([want["rf_m"]] * 2, axis=1))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["slam_stages", "slam_bench_ref",
                                  "wire_ref", "slam_fb_ref"])
def test_slam_references_equal_jax_now(name):
    want = build(name)
    got = testdata.reference(name)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.slow
def test_swarm_small_jax_equals_jax_now():
    """The whole stored JAX small swarm, its run included (a JAX sim_run
    compile of T=1000 ticks)."""
    want = build("swarm_small_jax")
    got = testdata.reference("swarm_small_jax")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
