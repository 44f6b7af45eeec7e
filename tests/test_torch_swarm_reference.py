"""PyTorch port, models/simulator.py: the closed-loop swarm against the
benchmark's plain reference (portbench/reference/swarm.py), through the
benchmark's own entry (portbench/entries/swarm_run.py), on rooms and
starts from the benchmark's traffic generator; the per-quad starts and
worlds against the old path; the swarm's spans and counters.

Every compared answer is held equal: grids, states and command kinds per
quad-tick, frontier scores, and the float poses bit for bit (both sides
are the same float32 operations in the same order on the CPU, and the
cell's float limits, 1e-4 m and 1e-3 deg, leave room only for a
reordered sum or a contracted product on the card)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fc_mock import random_scenario, run_scenario
from micro_quad_slam_tpu_torch.models import behavior as tb
from micro_quad_slam_tpu_torch.models import simulator as S
from micro_quad_slam_tpu_torch.utils import obs
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE
from portbench import harness
from portbench.gen import flights
from portbench.reference import config as rconf
from portbench.reference import swarm as RW
from test_behavior import telems_to_arrays

torch.set_num_threads(2)

CELL = harness.cell("ul_swarm.rooms")
ENTRY = harness.load_module(harness.PKG / "entries" / "swarm_run.py")
PROG = harness.program_config(CELL.conf)
RCFG = rconf.load(CELL.conf)
SIM_SPANS = {"sim", "sim.scan", "sim.frontier", "sim.flow", "sim.ekf",
             "sim.behavior", "sim.fc"}


def _job(B: int, T: int, seed: int) -> dict:
    """B quads of the cell's traffic (a pool of B flights of T frames):
    the entry's frames on the CPU."""
    t = dict(CELL.traffic, pool=B)
    pool = flights.make_pool(t, T, CELL.conf["tof"], seed)
    job = flights.make_jobs(pool, t, B, 1, seed)[0]
    i = job["idx"]
    x, y, yaw = flights.jitter_poses(pool["x_m"][i], pool["y_m"][i],
                                     pool["yaw_deg"][i], job)
    return harness.to_device({"x_m": x, "y_m": y, "yaw_deg": yaw,
                              "_room": pool["_room"][i],
                              "_obstacles": pool["_obstacles"][i]},
                             ENTRY.FRAME_KEYS, "cpu")


# B, ticks, dt_ms, airborne, seed
RUNS = {"cell_1khz": (16, 100, 1, True, 2),
        "mission_50hz": (8, 150, 20, True, 3),
        "ground_start": (8, 500, 20, False, 2)}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_program_equals_reference(name):
    """The cell's flight (100 ticks at 1 kHz, one scan, from mid-mission:
    quads fly forward from the first tick, and those that face a wall or a
    box close by turn), 3 s of flight at 50 Hz, and a ground start through
    arming, takeoff and hover into exploring: every compared answer
    equal."""
    B, T, dt, air, seed = RUNS[name]
    frames = _job(B, T, seed)
    args = dict(CELL.work, dt_ms=dt, airborne=air)
    out = ENTRY.outputs(ENTRY.run(frames, PROG, args))
    ref = ENTRY.reference(frames, RCFG, args)
    got = ENTRY.compare(out, ref)
    assert got == dict.fromkeys(got, 0), got
    states = set(ref["state"].reshape(-1).tolist())
    if air:
        fwd = (ref["cmd_kind"] == RW.CMD_VEL_BODY) & (ref["cmd_x"] > 0)
        assert fwd[0].any() and tb.ST_TURNING in states
    if name == "ground_start":
        assert {tb.ST_ARMING, tb.ST_TAKEOFF, tb.ST_HOVER,
                tb.ST_EXPLORE} <= states
    assert int((out["grid"] != 0).sum()) > 0


def test_control_reference_differs():
    """The reference with its poses in bfloat16 is not the program."""
    B, T, dt, air, seed = RUNS["cell_1khz"]
    frames = _job(B, T, seed)
    args = dict(CELL.work, dt_ms=dt, airborne=air)
    out = ENTRY.outputs(ENTRY.run(frames, PROG, args))
    got = ENTRY.compare(out, ENTRY.reference(frames, RCFG, args, lowp=True))
    assert got["pose_err_m"] > 10 * CELL.work["limits"]["pose_err_m"]
    assert got["yaw_err_deg"] > 10 * CELL.work["limits"]["yaw_err_deg"]


def _bits(t):
    """A tensor's values, floats as their bits."""
    return (t.view(torch.int32) if t.is_floating_point() else t).numpy()


@pytest.mark.parametrize("seeds", [(1, 2, 3, 4), (5, 6, 7, 8)])
def test_reference_machine_equals_program_machine(seeds):
    """The reference's control_tick and the program's behavior_step on the
    telemetry of tests/fc_mock.py's random anomaly schedules (takeoff
    rejections, spool failures, battery sag, dropouts, glitches, link
    loss, kills, ceiling overshoots), four quads a batch, tick for tick:
    every output equal (the command's floats bit for bit)."""
    arrs = [telems_to_arrays(run_scenario(random_scenario(s), 900)[0])
            for s in seeds]
    seq = {k: torch.from_numpy(np.stack([a[k] for a in arrs], 1).astype(
        np.int64 if arrs[0][k].dtype == np.uint32 else arrs[0][k].dtype))
        for k in arrs[0]}
    B = len(seeds)
    state = tb.behavior_init(B, "cpu")
    M = RW.machine_init(B, "cpu")
    bh, bt = RW.behavior_config(CELL.conf)
    pairs = {"state": "state", "cmd_kind": "cmd_kind", "cmd": "cmd",
             "req_mode": "req_mode", "req_arm": "req_arm",
             "req_takeoff": "req_takeoff", "rc_release": "rc_release",
             "clear_takeoff_ack": "clear_ack", "map_init": "map_init",
             "map_origin_x": "map_ox", "map_origin_y": "map_oy",
             "kf_flags": "kf_flags", "alt_est": "alt_est"}
    seen = set()
    for i in range(seq["t_ms"].shape[0]):
        tm = {k: v[i] for k, v in seq.items()}
        state, o = tb.behavior_step(state, tm, UL_PROFILE)
        r = RW.control_tick(M, tm, bh, bt, RCFG)
        for pk, rk in pairs.items():
            np.testing.assert_array_equal(_bits(o[pk]), _bits(r[rk]),
                                          err_msg=f"tick {i}: {pk}")
        seen |= set(o["state"].tolist())
    assert {tb.ST_TAKEOFF, tb.ST_HOVER, tb.ST_EXPLORE} <= seen


def test_per_quad_start_and_world_equal_the_old_path():
    """sim_init given the starts it would draw, and world_from_boxes given
    make_world's rooms and boxes (NaN where the mask is false), are the
    old path's state and world, and the runs from them are bit-equal."""
    B = 4
    old = S.sim_init(B, 5, spread_m=0.5, airborne=True, device="cpu")
    new = S.sim_init(B, 5, spread_m=0.5, airborne=True, device="cpu",
                     start=(old.x.clone(), old.y.clone(), old.yaw.clone()))
    w_old = S.make_world(B, room=(-3.5, -3.5, 3.5, 3.5),
                         obstacles=[(1.5, -0.5, 2.5, 0.5)], device="cpu")
    boxes = torch.where(w_old.obstacle_mask[..., None], w_old.obstacles,
                        float("nan"))
    w_new = S.world_from_boxes(w_old.room, boxes)
    for a, b in zip(w_old, w_new):
        assert torch.equal(a, b)
    fa, da = S.sim_run(old, w_old, 120, UL_PROFILE, dt_ms=20, record=True)
    fb, db = S.sim_run(new, w_new, 120, UL_PROFILE, dt_ms=20, record=True)
    for a, b in zip(S.sim_state_to_numpy(fa).values(),
                    S.sim_state_to_numpy(fb).values()):
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)
    for k in da:
        np.testing.assert_array_equal(da[k].numpy(), db[k].numpy(),
                                      err_msg=k)


class _Ops(TorchDispatchMode):
    """The aten operations issued, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not str(func).startswith("profiler."):
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _swarm_job():
    frames = _job(8, 150, 3)
    args = dict(CELL.work, dt_ms=20)
    return lambda: ENTRY.run(frames, PROG, args)


def test_spans_and_counters_only_under_a_profiler(tmp_path):
    """Untraced: no span, the host counters, no device counter, and the
    operations of a traced run but for the counter's at its end.  Traced:
    the seven sim spans nested under one root per run, sim.turning equal
    to the quad-ticks in TURNING, and every output bit-equal."""
    job = _swarm_job()
    obs.take()
    with _Ops() as off_ops:
        off = job()
    off = ENTRY.outputs(off)
    spans, counts = obs.take()
    assert spans == []
    assert counts == {"sim.ticks": 150, "sim.scan_ticks": 30}
    with obs.profile_trace(str(tmp_path)) as summary:
        with _Ops() as on_ops:
            on = job()
    on = ENTRY.outputs(on)
    spans, counts = obs.take()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    assert on_ops.ops[:len(off_ops.ops)] == off_ops.ops
    assert len(on_ops.ops) - len(off_ops.ops) <= 8
    turning = int((on["state"] == tb.ST_TURNING).sum())
    assert turning > 0
    assert counts == {"sim.ticks": 150, "sim.scan_ticks": 30,
                      "sim.turning": turning}
    assert {s.name for s in spans} == SIM_SPANS
    root = [s for s in spans if s.parent == 0]
    assert [s.name for s in root] == ["sim"]
    assert all(s.root == root[0].id for s in spans)
    calls = {k: v["calls"] for k, v in summary["spans"].items()}
    assert calls == {"sim": 1, "sim.scan": 30, "sim.frontier": 30,
                     "sim.flow": 150, "sim.ekf": 150, "sim.behavior": 150,
                     "sim.fc": 300}
    saved = json.loads((Path(tmp_path) / "spans.json").read_text())
    assert set(saved["spans"]) == SIM_SPANS
    assert saved["counters"]["sim.turning"] == turning


def test_cli_sim_writes_the_sim_spans(tmp_path, capsys):
    from micro_quad_slam_tpu_torch.__main__ import main

    d = tmp_path / "trace"
    assert main(["sim", "--quads", "2", "--seconds", "1", "--device", "cpu",
                 "--trace-dir", str(d)]) == 0
    assert "trace " in capsys.readouterr().err
    saved = json.loads((d / "spans.json").read_text())
    assert set(saved["spans"]) == SIM_SPANS
    assert saved["counters"]["sim.ticks"] == 50
    assert saved["counters"]["sim.scan_ticks"] == 10
    assert saved["counters"]["sim.turning"] == 0
