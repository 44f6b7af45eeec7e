"""The swarm cell cl_swarm.rooms (the clean revision's hover machine) on
the CPU at a small size: the program agrees with the reference through
the harness; the control (the reference's poses in bfloat16) and each
planted fault come out not correct; the configuration's groups are the
program's CL_PROFILE; the workload is the deployment's; the reference
imports neither the program nor JAX.  The `cuda` test repeats the control
at the cell's own size on the card."""

import ast
import dataclasses
import json
import time

import pytest
import torch

from portbench import harness

CELL = "cl_swarm.rooms"
SMALL = {"batch": 64, "frames": 100, "jobs": 2}
PER_TICK = ("state", "cmd_kind", "cmd_x", "locked", "est_x", "est_y", "yaw")


def _run(seed=2 ** 31 + 17, run_job=None, control=False):
    return harness.run_cell(CELL, seed, 0.0, False, "cpu", time.perf_counter(),
                            sizes=SMALL, run_job=run_job, control=control)


def test_program_agrees_with_reference():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"state_ticks_off", "cmd_off", "locked_off",
                                "pose_err_m", "yaw_err_deg"}
    assert all(v["value"] == 0 for v in r["checks"].values()), r["checks"]


@pytest.mark.parametrize("seed", [101, 2 ** 31 + 5])
def test_control_is_not_correct(seed):
    r = _run(seed, control=True)
    assert not r["correct"], r["checks"]
    assert r["checks"]["pose_err_m"]["value"] > 10 * 1e-4


# faults planted in the machine's settings: the XY hold before the lock
# 50 ms longer, the hover target 0.05 m higher
MACHINE = {"lock_hold": ("gates", "xy_stable_hold_ms", 50, "cmd_off"),
           "hover_target": ("behavior", "hover_target_m", 0.05, "cmd_off")}


def _broken(fault):
    """The cell's program call with `fault` planted in the machine it
    flies, or in what it returns."""
    c = harness.cell(CELL)
    entry = harness.load_module(harness.PKG / "entries" / "swarm_cl_run.py")
    prog = harness.program_config(c.conf)
    if fault in MACHINE:
        group, key, d, _ = MACHINE[fault]
        g = getattr(prog.cfg, group)
        g = dataclasses.replace(g, **{key: getattr(g, key) + d})
        prog = harness.Program(prog.cfg.replace(**{group: g}), prog.geom)

    def job(frames):
        res = entry.run(frames, prog, c.work)
        if fault == "unlocked":
            # one quad's lock flag dropped at its last tick
            res[1]["locked"][-1, 3] = False
        return res

    return job


@pytest.mark.parametrize("fault", [*MACHINE, "unlocked"])
def test_fault_is_not_correct(fault):
    r = _run(run_job=_broken(fault))
    assert not r["correct"], (fault, r["checks"])
    key = MACHINE[fault][3] if fault in MACHINE else "locked_off"
    assert r["checks"][key]["value"] > 0, r["checks"]


def test_groups_are_the_profile():
    """map, tof, gates and ekf as far as the file states them, and
    clean_gates, behavior and battery whole, equal CL_PROFILE's."""
    from micro_quad_slam_tpu_torch.utils import config as pc

    conf = harness.cell(CELL).conf
    assert conf["profile"] == "CL_PROFILE"
    prof = pc.CL_PROFILE
    asdict = lambda g: {k: list(v) if isinstance(v, tuple) else v  # noqa: E731
                        for k, v in dataclasses.asdict(g).items()}
    for g in ("map", "tof", "gates", "ekf"):
        want = asdict(getattr(prof, g))
        assert conf[g] == {k: want[k] for k in conf[g]}, g
    assert conf["clean_gates"] == asdict(prof.gates)
    for g in ("behavior", "battery"):
        assert conf[g] == asdict(getattr(prof, g)), g
    assert "slam" not in conf and "map_kind" not in conf
    man = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in man["configs"] if c["name"] == "cl_swarm")
    assert entry["reduced"] == [] and entry["source"] == conf["source"]


def test_workload_is_the_deployment():
    """1,024 quads, 100 ticks at 1 ms, a scan every 100 ms with the first
    tick a scan tick, the XY hold ending at the 51st tick (50 ticks of
    Z+yaw, 50 locked), the swarm's rooms and sensor, 3 batches, no
    hand-written kernel, one card."""
    c = harness.cell(CELL)
    entry = harness.load_module(harness.PKG / "entries" / "swarm_cl_run.py")
    w = c.work
    cfg = harness.program_config(c.conf).cfg
    assert (c.conf["batch"], c.conf["frames"]) == (1024, 100)
    assert (w["dt_ms"], w["scan_period_ms"], w["jobs"], w["kernels"]) == \
        (1, 100, 3, [])
    assert w["mission_ms"] % w["scan_period_ms"] == 0
    lock_ms = w["xy_stamp_ms"] + cfg.gates.xy_stable_hold_ms
    assert (lock_ms - w["mission_ms"]) // w["dt_ms"] + 1 == 51
    assert w["config"] == "cl_swarm" and w["traffic"] == "swarm_rooms"
    assert entry.sensor(w) == (5.0, 0.02) and c.chips == 1
    assert c.per_layer == ["cl_sim.launches_per_tick",
                           "cl_sim.busy_us_per_tick"]


def test_reference_imports_neither_the_program_nor_jax():
    """reference/swarm_cl.py's imports: torch, the standard library and
    the benchmark's own reference modules."""
    src = (harness.PKG / "reference" / "swarm_cl.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "types", "torch", "portbench"}
    assert not names & set(harness.FORBIDDEN)


@pytest.mark.cuda
def test_control_fails_at_cell_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (101, 102, 103):
        r = harness.run_cell(CELL, seed, 0.0, False, "cuda",
                             time.perf_counter(), control=True)
        assert not r["correct"], json.dumps(r["checks"])
