"""The swarm cell ul_swarm_vf.rooms (the UL swarm on its vision
front-end) on the CPU at a small size: the program agrees with the
reference through the harness, every number 0; the control (the
reference's poses and camera frames in bfloat16) and each planted fault
in the front-end come out not correct; the configuration is ul_swarm's
with the vision group, which is the program's camera; the workload is the
deployment's; the reference imports neither the program nor JAX.  The
`cuda` test repeats the control at the cell's own size on the card."""

import ast
import inspect
import json
import time

import pytest
import torch

from portbench import harness

CELL = "ul_swarm_vf.rooms"
SMALL = {"batch": 64, "frames": 20, "jobs": 2}
VISION = ("flow_rate_err", "flow_q_off")


def _run(seed=2 ** 31 + 17, run_job=None, control=False):
    return harness.run_cell(CELL, seed, 0.0, False, "cpu", time.perf_counter(),
                            sizes=SMALL, run_job=run_job, control=control)


def _entry():
    return harness.load_module(harness.PKG / "entries" / "swarm_vf_run.py")


def test_program_agrees_with_reference():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"grid_cells_off", "state_ticks_off",
                                "cmd_off", "frontier_off", "pose_err_m",
                                "yaw_err_deg", *VISION}
    assert all(v["value"] == 0 for v in r["checks"].values()), r["checks"]


@pytest.mark.parametrize("seed", [101, 2 ** 31 + 5])
def test_control_is_not_correct(seed):
    r = _run(seed, control=True)
    assert not r["correct"], r["checks"]
    assert r["checks"]["flow_rate_err"]["value"] > \
        100 * r["checks"]["flow_rate_err"]["limit"]


def _split_run(frames, prog, wl, drop_at=None):
    """The entry's program call run as three sim_runs, ticks [0, 10),
    [10, 11) and the rest; with drop_at, the camera frame taken at tick
    11 is lost, so the next flow spans two frame intervals as if one."""
    from micro_quad_slam_tpu_torch.models import simulator as S

    e = _entry()
    B, T = frames["x_m"].shape
    world = S.world_from_boxes(frames["_room"], frames["_obstacles"])
    st = S.sim_init(B, e.job_seed(frames), prog.geom, airborne=True,
                    device=frames["x_m"].device, start=e.starts(frames),
                    t0_ms=e.start_ms(wl), camera_streaming=True)
    noise_mm, dropout_p = e.sensor(wl)
    kw = dict(dt_ms=wl["dt_ms"], scan_period_ms=wl["scan_period_ms"],
              record=True, noise_mm=noise_mm, dropout_p=dropout_p,
              vision_flow=True,
              flow_period_ms=e.vision(wl)["flow_period_ms"])
    parts = []
    for n in (10, 1, T - 11):
        before = st
        st, d = S.sim_run(st, world, n, prog.cfg, prog.geom, **kw)
        if drop_at and n == 1:
            st = st._replace(cam_prev=before.cam_prev)
        parts.append(d)
    return st, {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _broken(fault):
    """The cell's program call with `fault` planted in its front-end."""
    c = harness.cell(CELL)
    e = _entry()
    prog = harness.program_config(c.conf)
    wl = c.work

    def job(frames):
        if fault in ("split", "dropped_frame"):
            return _split_run(frames, prog, wl, fault == "dropped_frame")
        res = e.run(frames, prog, wl)
        d = res[1]
        if fault == "rates":
            # the rates reported 1% high: a focal length 1% short
            d["of_rate_x"] *= 1.01
            d["of_rate_y"] *= 1.01
        elif fault == "quality":
            # one quad's quality 40 low at every tick
            d["of_q"][:, 3] -= 40
        return res

    return job


def test_split_run_is_the_run():
    """The fault's harness: the job split in three sim_runs is the job."""
    r = _run(run_job=_broken("split"))
    assert all(v["value"] == 0 for v in r["checks"].values()), r["checks"]


@pytest.mark.parametrize("fault,check", [("rates", "flow_rate_err"),
                                         ("quality", "flow_q_off"),
                                         ("dropped_frame", "flow_rate_err")])
def test_fault_is_not_correct(fault, check):
    r = _run(run_job=_broken(fault))
    assert not r["correct"], (fault, r["checks"])
    assert r["checks"][check]["value"] > r["checks"][check]["limit"], \
        r["checks"]


def test_config_is_ul_swarm_with_the_program_camera():
    """Every key and value of ul_swarm.json but the name, source,
    deployment and assumptions, and a vision group that is the program's
    camera (CAM_SIZE, CAM_FOCAL), lk_flow_batched's levels and iterations
    and a frame every 1 ms tick; nothing cut."""
    from micro_quad_slam_tpu_torch.models import simulator as S
    from micro_quad_slam_tpu_torch.ops import flow as F

    conf = harness.cell(CELL).conf
    base = json.loads((harness.PKG / "configs" / "ul_swarm.json")
                      .read_text())
    own = {"name", "source", "deployment", "assumed", "vision"}
    assert set(conf) - own == set(base) - own
    for k in set(base) - own:
        assert conf[k] == base[k], k
    lk = inspect.signature(F.lk_flow_batched).parameters
    assert conf["vision"] == {
        "camera_px": S.CAM_SIZE, "focal_px": S.CAM_FOCAL,
        "levels": lk["levels"].default, "iters": lk["iters"].default,
        "flow_period_ms": 1}
    assert set(base["assumed"]) <= set(conf["assumed"])
    assert "camera_interval" in conf["assumed"]
    man = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in man["configs"] if c["name"] == "ul_swarm_vf")
    assert entry["reduced"] == [] and entry["source"] == conf["source"]


def test_workload_is_the_deployment():
    """ul_swarm.rooms' workload (1,024 quads, 100 ticks at 1 ms, the first
    a scan tick past the XY hold and the frontier period, the swarm's
    rooms and sensor, 3 batches, the map-step kernel), its limits and the
    two vision checks, each limit with its reason; one card; the vision
    metrics."""
    c = harness.cell(CELL)
    base = json.loads((harness.PKG / "workloads" / "ul_swarm.rooms.json")
                      .read_text())
    w = c.work
    for k, v in base.items():
        if k not in ("entry", "config", "limits"):
            assert w[k] == v, k
    assert (w["entry"], w["config"], c.chips) == ("swarm_vf_run",
                                                  "ul_swarm_vf", 1)
    assert {k: w["limits"][k] for k in base["limits"]} == base["limits"]
    assert set(w["limits"]) == set(base["limits"]) | set(VISION)
    assert set(w["notes"]) == set(w["limits"])
    assert all(len(v) > 20 for v in w["notes"].values())
    assert (c.conf["batch"], c.conf["frames"]) == (1024, 100)
    assert c.per_layer == ["vf_sim.launches_per_tick",
                           "vf_sim.busy_us_per_tick"]


def test_reference_imports_neither_the_program_nor_jax():
    """reference/swarm_vf.py's imports: torch, the standard library and
    the benchmark's own reference modules."""
    src = (harness.PKG / "reference" / "swarm_vf.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "torch", "portbench"}
    assert not names & set(harness.FORBIDDEN)


@pytest.mark.cuda
def test_control_fails_at_cell_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (101, 102, 103):
        r = harness.run_cell(CELL, seed, 0.0, False, "cuda",
                             time.perf_counter(), control=True)
        assert not r["correct"], json.dumps(r["checks"])
