"""The port's SLAM replay (slam/pipeline.py) and its map entries
(ops/residentx.py: map_snap, map_chunk_sched, map_chunk, map_track)
against the JAX package, on the CPU.

- The map entries are held bit-equal to their Pallas kernels in interpret
  mode (pallas_map_snap, pallas_map_chunk_sched, pallas_map_chunk,
  pallas_map_track_x and the v1 pallas_map_track), recenters included.
- `_slam_impl` stage by stage and `slam_replay` whole against committed
  results of the JAX package on the CPU (micro_quad_slam_tpu_torch/
  testdata: slam_stages, slam_bench_ref; tests/test_torch_testdata.py
  makes them).  Integer outputs (recenter schedule, loop edges, gates,
  grids) are equal; float outputs agree within the stated tolerances: the
  EKF differs by an ulp (XLA-CPU fuses products into fmas, and its
  float32 trig is not correctly rounded), and the pose graph's matmul and
  Cholesky sum in another order.
- The accuracy bars of tests/test_slam.py on the port, and its CLI.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from micro_quad_slam_tpu.formats import scanlog as jscanlog
from micro_quad_slam_tpu.ops.pallas_resident import pallas_map_track
from micro_quad_slam_tpu.ops.pallas_residentx import (
    pallas_map_chunk,
    pallas_map_chunk_sched,
    pallas_map_snap,
    pallas_map_track_x,
)
from micro_quad_slam_tpu.replay import fusion as jfusion
from micro_quad_slam_tpu.replay import mapping as jm
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
from micro_quad_slam_tpu.utils.obs import map_iou_vs_walls as jax_iou
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.ops import residentx as rx
from micro_quad_slam_tpu_torch.ops.beams import extract_beams
from micro_quad_slam_tpu_torch.ops.raycast import world_to_cell
from micro_quad_slam_tpu_torch.ops.scanmatch import window_origin
from micro_quad_slam_tpu_torch.replay.fusion import RAD2DEG
from micro_quad_slam_tpu_torch.slam import pipeline as sp
from micro_quad_slam_tpu_torch.utils import obs
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE, UL_RT_PROFILE
from micro_quad_slam_tpu_torch.utils.obs import map_iou_vs_walls

torch.set_num_threads(2)

GEOM = port.DEFAULT_GEOM


# ------------------------------------------------------------ map entries

def _slots(B=2, K=8):
    """K keyframe slots of 2 committed random flights (every 8th frame),
    with a chunk-start recenter (flight 0, slot 4) and a mid-chunk one
    (flight 1, slot 2), on grids holding random log-odds."""
    f, _ = testdata.load("random_flights")
    t = port.frames_to_torch({k: v[:B] for k, v in f.items()}, "cpu")
    beams, _ = extract_beams(t["grid_mm"], UL_PROFILE.tof)
    sel = slice(0, 8 * K, 8)
    s = {"beams": beams[:, sel].contiguous(), "x": t["x_m"][:, sel],
         "y": t["y_m"][:, sel], "yaw": t["yaw_deg"][:, sel]}
    s["ox"] = s["x"][:, :1].expand(B, K).clone()
    s["oy"] = s["y"][:, :1].expand(B, K).clone()
    do = torch.zeros((B, K), dtype=torch.int32)
    rsy, rsx = do.clone(), do.clone()
    do[0, 4], rsy[0, 4], rsx[0, 4] = 1, 5, -3
    do[1, 2], rsy[1, 2], rsx[1, 2] = 1, -4, 7
    s.update(do=do, rsy=rsy, rsx=rsx)
    rng = np.random.default_rng(0)
    g = np.zeros((B, GEOM.prows, GEOM.pcols), np.int8)
    g[:, GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500] = rng.integers(
        -60, 60, (B, 500, 500))
    return s, g


_ORDER = ("beams", "x", "y", "yaw", "ox", "oy", "do", "rsy", "rsx")


def _j(s, keys=_ORDER):
    return [jnp.asarray(s[k].numpy()) for k in keys]


def test_map_snap_bit_equals_pallas_map_snap():
    """The snapshot entry's plain version against the TPU kernel's
    (interpret mode): grids and every chunk-start slab, with a recenter at
    a chunk start (taken before the snapshot) and one mid-chunk (after)."""
    s, g = _slots()
    pcx, pcy = world_to_cell(s["x"], s["y"], s["ox"], s["oy"], 0.1, 250, 250)
    wy0, wx0 = window_origin(pcx, pcy, GEOM)
    jg, js = pallas_map_snap(jnp.asarray(g), *_j(s), jnp.asarray(wy0.numpy()),
                             jnp.asarray(wx0.numpy()), 4, JAX_UL,
                             interpret=True)
    args = [s[k] for k in _ORDER] + [wy0, wx0, 4, UL_PROFILE]
    tg, ts = rx.map_snap_plain(torch.from_numpy(g), *args)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the wrapper takes the plain version on the CPU, launching nothing
    before = obs.counters().get("launches.replay_exact_snap", 0)
    wg, ws = rx.map_snap(torch.from_numpy(g), *args)
    assert obs.counters().get("launches.replay_exact_snap", 0) == before
    assert torch.equal(wg, tg) and torch.equal(ws, ts)
    # the chunk-start slab of flight 0's second chunk is the rolled grid
    assert not torch.equal(ts[0, 4], ts[0, 3])


def test_map_chunk_sched_bit_equals_pallas():
    s, g = _slots()
    want = pallas_map_chunk_sched(jnp.asarray(g), *_j(s), JAX_UL,
                                  interpret=True)
    got = rx.map_chunk_sched(torch.from_numpy(g), *[s[k] for k in _ORDER],
                             UL_PROFILE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("entry", ["map_track", "map_track_x", "map_chunk"])
def test_map_track_and_chunk_bit_equal_pallas(entry):
    """pallas_map_track (v1 kernel #9), pallas_map_track_x and
    pallas_map_chunk route to the exact kernel's port."""
    s, g = _slots()
    keys = ("beams", "x", "y", "yaw")
    o = [jnp.asarray(s["ox"][:, 0].numpy()), jnp.asarray(s["oy"][:, 0].numpy())]
    targs = [s[k] for k in keys] + [s["ox"][:, 0], s["oy"][:, 0], UL_PROFILE]
    if entry == "map_chunk":
        want = pallas_map_chunk(jnp.asarray(g), *_j(s, keys), *o, JAX_UL,
                                interpret=True)
        got = rx.map_chunk(torch.from_numpy(g), *targs)
    else:
        fn = pallas_map_track if entry == "map_track" else pallas_map_track_x
        want = fn(*_j(s, keys), *o, JAX_UL, interpret=True)
        got = rx.map_track(*targs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got != 0).sum()) > 1000


# ---------------------------------------------------------- SLAM, staged

def _stage_frames():
    ref = testdata.reference("slam_stages")
    frames = {k[3:]: v for k, v in ref.items() if k.startswith("in_")}
    return port.frames_to_torch(frames, "cpu"), ref


def _stage_profile():
    import dataclasses
    return dataclasses.replace(UL_PROFILE, slam=dataclasses.replace(
        UL_PROFILE.slam, slam_outer=2, loop_refine=1, loop_refine_early=1,
        gn_refine_iters=2, match_iters_later=1))


def _close(got, want, atol, name):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("upto", [0, 1, 2, 3, 4])
def test_slam_impl_stage_matches_jax(upto):
    """tests/test_slam.py::test_slam_small_end_to_end's batch (B=2, T=60,
    trimmed profile), each stage against the JAX package's: float poses
    within 1e-5 (odometry, matches), 1e-4 (solved nodes, track); integer
    schedule, loop edges and gates equal; GN costs within 1e-3 relative."""
    frames, ref = _stage_frames()
    out = sp._slam_impl(frames, _stage_profile(), GEOM, 10, 4, None,
                        upto if upto < 4 else 99)
    if upto == 0:
        odo, sched = out
        _close(odo, ref["s0_odo"], 1e-5, "odo")
        for k in ("ox", "oy", "do", "rsy", "rsx"):
            np.testing.assert_array_equal(sched[k].numpy(), ref[f"s0_{k}"],
                                          err_msg=k)
    elif upto == 1:
        _close(out, ref["s1_matched"], 1e-5, "matched")
    elif upto == 2:
        matched, ij, z, ok = out
        _close(matched, ref["s2_matched"], 1e-5, "matched")
        np.testing.assert_array_equal(ij.numpy(), ref["s2_ij"])
        np.testing.assert_array_equal(ok.numpy(), ref["s2_ok"])
        _close(z, ref["s2_z"], 1e-5, "z")
    elif upto == 3:
        nodes, costs = out
        _close(nodes, ref["s3_kf_nodes"], 1e-4, "kf_nodes")
        np.testing.assert_allclose(costs.numpy(), ref["s3_gn_costs"],
                                   rtol=1e-3, atol=1e-6)
    else:
        _close(out.track, ref["s4_track"], 1e-4, "track")
        np.testing.assert_array_equal(out.grid.numpy(), ref["grid"])
        np.testing.assert_array_equal(out.origin[0].numpy(), ref["origin_x"])
        np.testing.assert_array_equal(out.origin[1].numpy(), ref["origin_y"])
        # the copy 5 m east has the same map and a track 5 m apart
        assert torch.equal(out.grid[0], out.grid[1])
        np.testing.assert_allclose(out.track[1, :, 0] - out.track[0, :, 0],
                                   5.0, atol=1e-3)


def test_odo_and_schedule_equals_ekf_track_then_schedule():
    frames, _ = _stage_frames()
    odo, sched = sp._odo_and_schedule(frames, UL_PROFILE)
    want = sp._origin_schedule(sp._ekf_track(frames, UL_PROFILE), UL_PROFILE)
    np.testing.assert_array_equal(odo.numpy(),
                                  sp._ekf_track(frames, UL_PROFILE).numpy())
    # the fused loop adopts the first posterior, as _origin_schedule does
    for k in want:
        np.testing.assert_array_equal(sched[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    # the odometry track is the fusion replay's, bit for bit
    _, track = port.replay.fusion.replay_fusion_batched(frames, UL_PROFILE)
    np.testing.assert_array_equal(odo[..., 0].numpy(), track["x"].numpy())


def test_recenter_schedule_matches_mapping_replay():
    """tests/test_slam.py:522-543: on the logged poses of a 26 m corridor
    flight, the grid-free schedule recenters at the mapping replay's
    frames, with the 125-cell clamped shift."""
    log = synth_room_scanlog(n_frames=110, path="line", path_radius_m=26.0,
                             room=(-1.5, -1.5, 28.0, 1.5), with_flow=True,
                             seed=11)
    f = port.frames_to_torch({k: v[None] for k, v in
                              port.scanlog_to_arrays(log).items()}, "cpu")
    _, outs = port.replay_mapping_batched(f, UL_PROFILE, kernel="residentx")
    golden_rc = outs["kf_flags"][0].numpy() != 0
    poses = torch.from_numpy(np.stack([log.x_m, log.y_m,
                                       np.deg2rad(log.yaw_deg)], -1)[None])
    sched = sp._origin_schedule(poses.float(), UL_PROFILE)
    np.testing.assert_array_equal(sched["do"][0].numpy() != 0, golden_rc)
    assert golden_rc.sum() >= 1
    assert int(sched["rsx"][0, int(np.argmax(golden_rc))]) == 125


def test_resume_from_state0_continues_the_map():
    """state0 = (zero grids, the first odometry pose as origin) gives the
    unresumed result; a non-empty grid0 lands under the re-raster."""
    frames, _ = _stage_frames()
    prof = _stage_profile()
    res = sp.slam_replay(frames, prof, GEOM, 10, 4)
    zero = torch.zeros_like(res.grid)
    ox, oy = res.odo_track[:, 0, 0], res.odo_track[:, 0, 1]
    again = sp.slam_replay(frames, prof, GEOM, 10, 4, (zero, ox, oy))
    for name in ("grid", "track", "kf_nodes", "gn_costs"):
        a, b = getattr(again, name), getattr(res, name)
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)), name
    grid0 = res.grid.clone()
    cont = sp.slam_replay(frames, prof, GEOM, 10, 4, (grid0, ox, oy))
    assert not torch.equal(cont.grid, res.grid)
    assert torch.equal(res.grid, grid0)              # state0 left as it was


def test_slam_refuses_the_formulations_not_ported():
    """The formulations once refused (match_feedback=True,
    match_map_kf_only=False) run on the stage batch and agree with the
    JAX package's slam_replay of it (testdata slam_fb_ref): nodes and track
    within 1e-4, grid sums equal."""
    from test_torch_testdata import FB_FORMS, _formulation

    frames, _ = _stage_frames()
    ref = testdata.reference("slam_fb_ref")
    for form in sorted(FB_FORMS):
        res = sp.slam_replay(frames, _formulation(_stage_profile(), form),
                             GEOM, 10, 4)
        _close(res.kf_nodes, ref[f"stage_{form}_kf_nodes"], 1e-4, form)
        _close(res.track, ref[f"stage_{form}_track"], 1e-4, form)
        got = testdata.grid_sums(res.grid.numpy())
        for k in ("sums", "weighted"):
            np.testing.assert_array_equal(got[k],
                                          ref[f"stage_{form}_{k}"],
                                          err_msg=f"{form} {k}")


# ------------------------------------------------------ SLAM, bench flights

@pytest.mark.parametrize("profile", ["ul", "rt"])
def test_slam_replay_on_bench_flights_matches_jax(profile):
    """The 4 distinct bench flights at T=256 against the JAX package's
    slam_replay on the CPU: odometry within 1e-5, tracks and keyframe nodes
    within 1e-4 m and rad, and every flight's grid sums (plain and
    position-weighted) equal."""
    cfg = UL_PROFILE if profile == "ul" else UL_RT_PROFILE
    frames = testdata.slam_bench_frames(4, device="cpu")
    res = sp.slam_replay(frames, cfg)
    ref = testdata.reference("slam_bench_ref")
    _close(res.odo_track, ref[f"{profile}_odo_track"], 1e-5, "odo_track")
    _close(res.kf_nodes, ref[f"{profile}_kf_nodes"], 1e-4, "kf_nodes")
    _close(res.track, ref[f"{profile}_track"], 1e-4, "track")
    got = testdata.grid_sums(res.grid.numpy())
    for k in ("sums", "weighted"):
        np.testing.assert_array_equal(got[k], ref[f"{profile}_{k}"],
                                      err_msg=k)


def test_slam_bench_frames_ask_for_cuda():
    if torch.cuda.is_available():
        assert testdata.slam_bench_frames(4)["x_m"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            testdata.slam_bench_frames(4)


# -------------------------------------------------------- accuracy bars

def _fig8(T, drift, seed=5):
    room = (-2.5, -2.5, 2.5, 2.5)
    log = synth_room_scanlog(n_frames=T, path="fig8", path_radius_m=1.4,
                             room=room, with_flow=True, seed=seed)
    log.of_rate_x[:] *= drift
    log.of_rate_y[:] *= drift
    f = {**jm.scanlog_to_arrays(log), **jfusion.fusion_arrays(log)}
    return port.frames_to_torch({k: v[None] for k, v in f.items()}, "cpu"), \
        log, room


def _errors_and_ious(frames, log, room):
    res = sp.slam_replay(frames, UL_PROFILE, GEOM, 10, 8)
    truth = np.stack([log.x_m, log.y_m], -1)
    odo_err = np.hypot(*(res.odo_track[0, :, :2].numpy() - truth).T)
    slam_err = np.hypot(*(res.track[0, :, :2].numpy() - truth).T)
    beams, _ = extract_beams(frames["grid_mm"], UL_PROFILE.tof)
    odo = res.odo_track
    odo_grid = rx.map_track(beams, odo[..., 0], odo[..., 1],
                            odo[..., 2] * RAD2DEG, odo[:, 0, 0], odo[:, 0, 1],
                            UL_PROFILE, GEOM)
    lg = lambda g: port.logical_grid(g)[0].numpy()            # noqa: E731
    iou_slam = map_iou_vs_walls(lg(res.grid), float(res.origin[0][0]),
                                float(res.origin[1][0]), room)
    iou_odo = map_iou_vs_walls(lg(odo_grid), float(res.odo_track[0, 0, 0]),
                               float(res.odo_track[0, 0, 1]), room)
    return res, odo_err, slam_err, iou_slam, iou_odo


def test_fig8_high_drift_absolute_accuracy():
    """tests/test_slam.py:449-491 on the port: at a 12% flow-scale drift
    the solved track's tail error <= 5 cm and its map's wall IoU >= 0.85,
    better than the odometry map's."""
    frames, log, room = _fig8(160, 1.12)
    _, _, slam_err, iou_slam, iou_odo = _errors_and_ious(frames, log, room)
    assert slam_err[-20:].mean() <= 0.05, slam_err[-20:].mean()
    assert iou_slam >= 0.85, iou_slam
    assert iou_slam > iou_odo, (iou_slam, iou_odo)


def test_fig8_loop_closure_fires_and_corrects():
    """tests/test_slam.py:398-446 on the port at 6% drift: loop edges are
    accepted, and the corrected track and map beat the odometry's."""
    frames, log, room = _fig8(160, 1.06)
    _, odo_err, slam_err, iou_slam, iou_odo = _errors_and_ious(frames, log,
                                                               room)
    assert slam_err[-20:].mean() < odo_err[-20:].mean() * 0.7
    assert iou_slam > iou_odo and iou_slam >= 0.9, (iou_slam, iou_odo)
    _, _, _, lok = sp._slam_impl(frames, UL_PROFILE, GEOM, 10, 8, upto=2)
    assert int(lok.sum()) >= 1


def test_map_iou_vs_walls_equals_jax():
    rng = np.random.default_rng(1)
    g = rng.integers(-30, 30, (500, 500)).astype(np.int8)
    g[200:203, :] = 100
    room = (-2.5, -2.5, 2.5, 2.5)
    assert map_iou_vs_walls(g, 0.3, -0.2, room) == jax_iou(g, 0.3, -0.2, room)


# ------------------------------------------------------------------ CLI

def _write_log(tmp_path, name, seed, T=40):
    log = synth_room_scanlog(n_frames=T, path="circle", path_radius_m=1.0,
                             noise_mm=4.0, with_flow=True, seed=seed)
    p = tmp_path / name
    jscanlog.write_scanlog(str(p), log)
    return str(p)


def test_cli_slam_and_fusion(tmp_path, capsys):
    """`slam` and `fusion` on synthetic logs with --device cpu: summary
    lines, the track CSVs and maps; without a card the default device
    exits 2; logs of unequal length are refused."""
    from micro_quad_slam_tpu_torch.__main__ import main

    p = _write_log(tmp_path, "s.bin", 3)
    track, out = tmp_path / "trk.csv", tmp_path / "m.npy"
    assert main(["slam", "--log", p, p, "--kf-every", "10", "--gn-iters",
                 "4", "--track", str(track), "--out", str(out),
                 "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "[1] SLAM: 40 frames, 4 keyframes" in said
    rows = (tmp_path / "trk_0.csv").read_text().strip().split("\n")
    assert rows[0] == "t_ms,x,y,yaw_rad,odo_x,odo_y,odo_yaw_rad"
    assert len(rows) == 41
    assert (tmp_path / "trk_0.csv").read_text() == \
        (tmp_path / "trk_1.csv").read_text()
    assert np.load(tmp_path / "m_0.npy").shape == (500, 500)

    fus = tmp_path / "f.csv"
    assert main(["fusion", "--log", p, "--out", str(fus),
                 "--device", "cpu"]) == 0
    assert "EKF replay: 40 frames" in capsys.readouterr().out
    assert fus.read_text().startswith("t_ms,x,y,z,vx,vy,vz,yaw_rad,flow_used")

    short = _write_log(tmp_path, "short.bin", 4, T=30)
    assert main(["slam", "--log", p, short, "--device", "cpu"]) == 2
    for cmd in ("slam", "fusion"):
        rc = main([cmd, "--log", p])
        if torch.cuda.is_available():
            assert rc == 0
        else:
            assert rc == 2 and "--device cpu" in capsys.readouterr().err
