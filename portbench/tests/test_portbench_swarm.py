"""The swarm cell ul_swarm.rooms on the CPU at a small size: the program
agrees with the reference through the harness; the control (the
reference's poses in bfloat16) and each planted fault come out not
correct; the traffic's starts lie in their rooms and clear of their
boxes; the configuration's behaviour and battery groups are the
program's profile.  The `cuda` test repeats the control at the cell's
own size on the card."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.gen import flights

CELL = "ul_swarm.rooms"
SMALL = {"batch": 64, "frames": 100, "jobs": 2}
# outputs whose quads lie on their second axis ([T, B])
PER_TICK = ("state", "cmd_kind", "cmd_x", "est_x", "est_y", "yaw")


def _run(seed=2 ** 31 + 17, run_job=None, control=False):
    return harness.run_cell(CELL, seed, 0.0, False, "cpu", time.perf_counter(),
                            sizes=SMALL, run_job=run_job, control=control)


def test_program_agrees_with_reference():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"grid_cells_off", "state_ticks_off",
                                "cmd_off", "frontier_off", "pose_err_m",
                                "yaw_err_deg"}
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())


@pytest.mark.parametrize("seed", [101, 2 ** 31 + 5])
def test_control_is_not_correct(seed):
    r = _run(seed, control=True)
    assert not r["correct"], r["checks"]


# faults planted in the flight machine's settings: the front stop 0.2 m
# farther (more quads turn), the forward speed 0.05 m/s lower
MACHINE = {"front_stop": ("front_stop_m", 0.2, "state_ticks_off"),
           "forward_speed": ("fwd_vel_mps", -0.05, "cmd_off")}


def _broken(fault):
    """The cell's program call with `fault` planted in what it returns, or
    in the machine it flies."""
    c = harness.cell(CELL)
    entry = harness.load_module(harness.PKG / "entries" / "swarm_run.py")
    prog = harness.program_config(c.conf)
    wl = c.work
    if fault in MACHINE:
        key, d, _ = MACHINE[fault]
        bh = prog.cfg.behavior
        bh = dataclasses.replace(bh, **{key: getattr(bh, key) + d})
        prog = harness.Program(prog.cfg.replace(behavior=bh), prog.geom)

    def job(frames):
        res = entry.run(frames, prog, wl)
        out = entry.outputs(res)
        if fault == "half":
            # half of the swarm left out: the first half flown alone, the
            # rest of the answers empty
            B = frames["x_m"].shape[0]
            part = entry.outputs(entry.run(
                {k: v[: B // 2] for k, v in frames.items()}, prog, wl))
            for k, v in out.items():
                w = v.transpose(0, 1) if k in PER_TICK else v
                w[B // 2:] = 0
                w[: B // 2] = (part[k].transpose(0, 1) if k in PER_TICK
                               else part[k])
        elif fault == "unchanged":
            # the run hands back the maps it was given: empty grids
            out["grid"].zero_()
        elif fault == "altered":
            # one answer altered where it is produced: one cell of one map
            g = out["grid"]
            g[1, g.shape[1] // 2, g.shape[2] // 2] += 1
        return res

    return job


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   *MACHINE])
def test_fault_is_not_correct(fault):
    r = _run(run_job=_broken(fault))
    assert not r["correct"], (fault, r["checks"])
    if fault in MACHINE:
        assert r["checks"][MACHINE[fault][2]]["value"] > 0, r["checks"]


@pytest.mark.parametrize("seed", [2 ** 31 + 17, 7, 4_000_000_007])
def test_starts_in_their_rooms_and_clear_of_boxes(seed):
    """At the cell's size (3 batches of 1,024): every start strictly inside
    its room and at least 0.2 m from each of its boxes."""
    c = harness.cell(CELL)
    pool = flights.make_pool(c.traffic, c.conf["frames"], c.conf["tof"], seed)
    for job in flights.make_jobs(pool, c.traffic, c.conf["batch"],
                                 c.work["jobs"], seed):
        i = job["idx"]
        x, y, _ = flights.jitter_poses(pool["x_m"][i], pool["y_m"][i],
                                       pool["yaw_deg"][i], job)
        x0, y0 = x[:, 0].astype(np.float64), y[:, 0].astype(np.float64)
        room = pool["_room"][i]
        assert ((x0 > room[:, 0]) & (x0 < room[:, 2]) & (y0 > room[:, 1])
                & (y0 < room[:, 3])).all()
        for box in np.moveaxis(pool["_obstacles"][i], 1, 0):
            dx = np.maximum(np.maximum(box[:, 0] - x0, x0 - box[:, 2]), 0.0)
            dy = np.maximum(np.maximum(box[:, 1] - y0, y0 - box[:, 3]), 0.0)
            d = np.hypot(dx, dy)
            assert (d[np.isfinite(d)] >= 0.2).all()


def test_traffic_and_workload_are_the_swarm_deployment():
    """1,024 quads, 100 ticks at 1 ms with a scan every 100 ms, airborne
    mid-mission (the first tick a scan tick, past the 1 s XY hold and the
    1.2 s frontier period), the rooms mix, 0.1 m and +/-180 deg start
    jitter, 5 mm noise and 2% dropout, read by the entry from the cell's
    own traffic, no flow, 3 batches."""
    c = harness.cell(CELL)
    entry = harness.load_module(harness.PKG / "entries" / "swarm_run.py")
    man = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in man["workloads"]}
    rooms = json.loads((harness.PKG / "traffic" / "rooms.json").read_text())
    t, w = c.traffic, c.work
    for k in ("pool", "paths", "room_side_m", "obstacles", "obstacle_side_m",
              "wall_margin_m", "line_length_m"):
        assert t[k] == rooms[k], k
    assert t["jitter"] == {"xy_m": 0.1, "rot_deg": 180.0}
    assert (t["noise_mm"], t["dropout_p"], t["flow"]) == (5.0, 0.02, False)
    assert w["traffic"] == cells[CELL]["traffic"]
    assert entry.sensor(w) == (5.0, 0.02)
    assert (c.conf["batch"], c.conf["frames"]) == (1024, 100)
    assert (w["dt_ms"], w["scan_period_ms"], w["airborne"], w["jobs"]) == \
        (1, 100, True, 3)
    assert w["mission_ms"] % w["scan_period_ms"] == 0
    cfg = harness.program_config(c.conf).cfg
    assert entry.start_ms(w) > max(cfg.gates.xy_stable_hold_ms,
                                   cfg.behavior.frontier_eval_ms)
    assert w["config"] == "ul_swarm" and c.chips == 1


def test_behavior_and_battery_groups_are_the_profile():
    from micro_quad_slam_tpu_torch.utils import config as pc

    conf = harness.cell(CELL).conf
    prof = getattr(pc, conf["profile"])
    for g in ("behavior", "battery"):
        want = dataclasses.asdict(getattr(prof, g))
        assert conf[g] == want, g
    assert "slam" not in conf and "map_kind" not in conf


@pytest.mark.cuda
def test_control_fails_at_cell_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (101, 102, 103):
        r = harness.run_cell(CELL, seed, 0.0, False, "cuda",
                             time.perf_counter(), control=True)
        assert not r["correct"], json.dumps(r["checks"])
