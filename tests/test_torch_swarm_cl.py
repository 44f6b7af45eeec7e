"""PyTorch port, models/simulator.py: the closed-loop swarm flying the
clean revision's hover machine (sim_init(machine="cl"),
models/behavior_cl.py) against the benchmark's plain reference
(portbench/reference/swarm_cl.py) through the cell's entry
(portbench/entries/swarm_cl_run.py); the ground start; the machine inside
sim_step against the machine alone; the UL swarm left as it was; the CLI;
the card's run against the CPU's (`cuda`)."""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.models import behavior_cl as bcl
from micro_quad_slam_tpu_torch.models import simulator as S
from micro_quad_slam_tpu_torch.utils import obs
from micro_quad_slam_tpu_torch.utils.config import CL_PROFILE, UL_PROFILE
from portbench import harness
from portbench.gen import flights
from portbench.reference import config as rconf
from portbench.reference import swarm_cl as RC

torch.set_num_threads(2)

CELL = harness.cell("cl_swarm.rooms")
ENTRY = harness.load_module(harness.PKG / "entries" / "swarm_cl_run.py")
PROG = harness.program_config(CELL.conf)
RCFG = rconf.load(CELL.conf)


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


def test_cell_start_equals_reference():
    """B = 64 over the cell's 100 ticks from its mid-hover start: every
    quad streams Z+yaw for 50 ticks, locks at its 51st and holds its
    position; states, commands and locks equal, poses bit-equal."""
    frames = _job(64, 100, 11)
    out = ENTRY.outputs(ENTRY.run(frames, PROG, CELL.work))
    ref = ENTRY.reference(frames, RCFG, CELL.work)
    got = ENTRY.compare(out, ref)
    assert got == dict.fromkeys(got, 0), got
    assert (out["state"] == bcl.CL_HOVER).all()
    assert (out["cmd_kind"][:50] == bcl.CMD_Z_YAW).all()
    assert (out["cmd_kind"][50:] == bcl.CMD_POS_YAW).all()
    assert not out["locked"][:50].any() and out["locked"][50:].all()
    z = np.float32(-CL_PROFILE.behavior.hover_target_m)
    assert (out["cmd_x"][:50] == torch.tensor(z)).all()
    assert torch.equal(out["cmd_x"][50:], frames["x_m"][:, 0].expand(50, -1))


def test_ground_start_reaches_hover_and_locks():
    """B = 16 on the ground at dt 20 ms: IDLE, ARMING and TAKEOFF (its
    liftoff assist first: the clean TAKEOFF hands a quad that has not
    left the ground to it at once), HOVER, and every quad locks; the
    program equal to the reference tick for tick."""
    frames = _job(16, 250, 5)
    args = dict(CELL.work, dt_ms=20)
    world = S.world_from_boxes(frames["_room"], frames["_obstacles"])
    st = S.sim_init(16, ENTRY.job_seed(frames), PROG.geom, device="cpu",
                    start=ENTRY.starts(frames), machine="cl")
    fin, d = S.sim_run(st, world, 250, PROG.cfg, PROG.geom, dt_ms=20,
                       record=True, noise_mm=5.0, dropout_p=0.02)
    seq = [k for k, _ in _runs(d["state"][:, 0].tolist())]
    assert seq[:3] == [bcl.CL_IDLE, bcl.CL_ARMING, bcl.CL_TAKEOFF]
    assert seq[-1] == bcl.CL_HOVER and bcl.CL_LIFTOFF_ASSIST in seq
    assert (d["state"][-1] == bcl.CL_HOVER).all() and d["locked"][-1].all()
    assert fin.fc.armed.all() and (fin.alt > 0.4).all()
    bh, bt, gt = RC.clean_config(CELL.conf)
    x0, y0, yaw0 = ENTRY.starts(frames)
    ref = RC.swarm_run(frames["_room"], frames["_obstacles"], x0, y0, yaw0,
                       ENTRY.job_seed(frames), 250, RCFG, bh, bt, gt, 20,
                       args["scan_period_ms"], 5.0, 0.02, airborne=False)
    out = {"state": d["state"], "cmd_kind": d["cmd_kind"],
           "cmd_x": d["cmd"][..., 0], "locked": d["locked"], "x": fin.x,
           "y": fin.y, "yaw_final": fin.yaw, "ekf_mean": fin.ekf.mean,
           "est_x": d["est_x"], "est_y": d["est_y"], "yaw": d["yaw"]}
    got = ENTRY.compare(out, ref)
    assert got == dict.fromkeys(got, 0), got


def _runs(seq):
    """Runs of equal values: [(value, length)]."""
    out = []
    for v in seq:
        if out and out[-1][0] == v:
            out[-1] = (v, out[-1][1] + 1)
        else:
            out.append((v, 1))
    return out


def test_machine_in_sim_step_equals_the_machine_alone(monkeypatch):
    """The telemetry sim_step hands behavior_step_cl (the enabled bits the
    health bits, the rangefinder and flow quality at every height), fed to
    the machine alone, gives the outputs and state the swarm carries on."""
    seen = []

    def spy(state, tm, cfg):
        got = bcl.behavior_step_cl(state, tm, cfg)
        seen.append((state, dict(tm), got))
        return got

    monkeypatch.setattr(S, "behavior_step_cl", spy)
    B = 8
    world = S.make_world(B, device="cpu")
    st = S.sim_init(B, 3, spread_m=0.5, device="cpu", machine="cl")
    for _ in range(60):
        st, d = S.sim_step(st, world, CL_PROFILE, dt_ms=20, record=True)
        state, tm, (beh, out) = seen[-1]
        assert torch.equal(tm["sys_enabled"], tm["sys_health"])
        assert (tm["sys_health"] == S.HEALTH_ALL).all()
        assert tm["have_rf"].all() and (tm["of_q"] == S.FLOW_Q).all()
        assert torch.equal(tm["rf_m"], tm["lpos_alt_filt"])
        alone, want = bcl.behavior_step_cl(state, tm, CL_PROFILE)
        for a, b in zip(alone, st.beh):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        for k in ("state", "cmd_kind", "cmd", "req_mode", "req_arm",
                  "req_takeoff", "kf_flags", "alt_est"):
            np.testing.assert_array_equal(want[k].numpy(), d[k].numpy(),
                                          err_msg=k)
        assert torch.equal(d["locked"], alone.hv_locked)
    assert len(seen) == 60


def test_sim_step_hands_the_kernel_operands_it_takes(monkeypatch):
    """The clean tick's telemetry as sim_step assembles it (strided EKF
    views, the broadcast want_arm, the aliased health bits) and the
    machine's state pass the kernel wrapper's operand checks at every
    tick: on the CPU it refuses them only for their device."""
    seen = []

    def spy(state, tm, cfg):
        seen.append((state, tm))
        return bcl.behavior_step_cl_plain(state, tm, cfg)

    monkeypatch.setattr(S, "behavior_step_cl", spy)
    world = S.make_world(4, device="cpu")
    st = S.sim_init(4, 5, spread_m=0.5, device="cpu", machine="cl")
    for _ in range(3):
        st, _ = S.sim_step(st, world, CL_PROFILE, dt_ms=20)
    assert len(seen) == 3
    for state, tm in seen:
        assert tm["want_arm"].stride(0) == 0
        assert tm["lpos_x"].stride(0) > 1
        with pytest.raises(ValueError, match="must be on a CUDA device"):
            bcl.behavior_step_cl_kernel(state, tm, CL_PROFILE)


class _Ops(TorchDispatchMode):
    """The aten operations issued, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


VIEWS = {"view", "select", "slice", "expand", "unsqueeze", "t", "transpose",
         "permute", "alias", "squeeze", "_unsafe_view", "as_strided",
         "detach"}


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "no_scan"])
def test_ul_swarm_unchanged(scan):
    """The UL swarm flies as before: machine="ul" is the default state, a
    tick issues the operations it issued before the clean machine came
    (3,739 on a scan tick, 1,880 on another, views left out, on the CPU
    after a first tick has built the cached constants), its diag has no
    lock, and its run is bit-equal to the default's."""
    B = 8
    world = S.make_world(B, device="cpu")
    a = S.sim_init(B, 3, airborne=True, device="cpu", t0_ms=9999)
    b = S.sim_init(B, 3, airborne=True, device="cpu", t0_ms=9999,
                   machine="ul", hover_alt_m=0.5, xy_stamp_ms=1)
    for x, y in zip(S.sim_state_to_numpy(a).values(),
                    S.sim_state_to_numpy(b).values()):
        if isinstance(x, dict):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        else:
            np.testing.assert_array_equal(x, y)
    st = a._replace(t_ms=9999 if scan else 10000)
    S.sim_step(st, world, UL_PROFILE, dt_ms=1, record=True)
    with _Ops() as ops:
        fin, d = S.sim_step(st, world, UL_PROFILE, dt_ms=1, record=True)
    n = sum(1 for o in ops.ops if o.split(".")[1] not in VIEWS)
    assert n == (3739 if scan else 1880)
    assert "locked" not in d and fin.mapper is not None
    fa, da = S.sim_run(a, world, 30, UL_PROFILE, dt_ms=20, record=True)
    fb, db = S.sim_run(b, world, 30, UL_PROFILE, dt_ms=20, record=True)
    for k in da:
        np.testing.assert_array_equal(da[k].numpy(), db[k].numpy(),
                                      err_msg=k)


def test_cl_state_has_no_map_and_counts_its_ticks_and_locks(tmp_path):
    """A clean state holds no map grids; a traced run counts sim.cl_ticks
    and sim.cl_locked (the locked quad-ticks) and no sim.turning, and an
    untraced one only the host counters."""
    B = 8
    world = S.make_world(B, device="cpu")
    st = S.sim_init(B, 3, airborne=True, device="cpu", t0_ms=999,
                    machine="cl", xy_stamp_ms=50)
    assert st.mapper is None and isinstance(st.beh, bcl.BehaviorClState)
    assert (st.alt == np.float32(CL_PROFILE.behavior.hover_target_m)).all()
    obs.take()
    S.sim_run(st, world, 100, CL_PROFILE, dt_ms=1)
    assert obs.take()[1] == {"sim.ticks": 100, "sim.scan_ticks": 1,
                             "sim.cl_ticks": 100}
    with obs.profile_trace(str(tmp_path)):
        _, d = S.sim_run(st, world, 100, CL_PROFILE, dt_ms=1)
    spans, counts = obs.take()
    assert counts == {"sim.ticks": 100, "sim.scan_ticks": 1,
                      "sim.cl_ticks": 100, "sim.cl_locked": 50 * B}
    assert int(d["locked"].sum()) == 50 * B
    assert {s.name for s in spans} == {"sim", "sim.scan", "sim.flow",
                                       "sim.ekf", "sim.behavior", "sim.fc"}
    with pytest.raises(ValueError, match="machine"):
        S.sim_init(B, 3, device="cpu", machine="explore")


def test_cl_state_round_trips_through_numpy():
    """sim_state_to_numpy / sim_state_from_numpy keep a clean swarm: the
    resumed run equals the unbroken one."""
    B = 6
    world = S.make_world(B, device="cpu")
    st = S.sim_init(B, 4, spread_m=0.5, device="cpu", machine="cl")
    mid, _ = S.sim_run(st, world, 80, CL_PROFILE, dt_ms=20)
    d = S.sim_state_to_numpy(mid)
    assert d["machine"] == "cl" and "mapper" not in d
    d["gen"] = mid.gen.get_state().numpy()
    back = S.sim_state_from_numpy(d, "cpu")
    fa, da = S.sim_run(mid, world, 80, CL_PROFILE, dt_ms=20, record=True)
    fb, db = S.sim_run(back, world, 80, CL_PROFILE, dt_ms=20, record=True)
    for k in da:
        np.testing.assert_array_equal(da[k].numpy(), db[k].numpy(),
                                      err_msg=k)


def test_cli_sim_flies_the_clean_machine(tmp_path, capsys):
    """`sim --profile cl` flies the clean machine (the CL state names, the
    hover locks, no grid figures), and --save-state / --resume continue it;
    a UL resume of its checkpoint is refused."""
    from micro_quad_slam_tpu_torch.__main__ import main

    ck = tmp_path / "ck"
    assert main(["sim", "--profile", "cl", "--quads", "4", "--seconds", "3",
                 "--device", "cpu", "--save-state", str(ck),
                 "--out-prefix", str(tmp_path / "p")]) == 0
    text = capsys.readouterr().out
    assert "final states {'HOVER': 4}; hover locked 4/4" in text
    assert "occupied" not in text and "grids ->" not in text
    assert not (tmp_path / "p_grids.npy").exists()
    assert (tmp_path / "p_q0.bin").exists()
    assert main(["sim", "--profile", "cl", "--quads", "4", "--seconds", "1",
                 "--device", "cpu", "--resume", str(ck)]) == 0
    assert "hover locked 4/4" in capsys.readouterr().out
    assert main(["sim", "--quads", "4", "--seconds", "1", "--device", "cpu",
                 "--resume", str(ck)]) == 2
    assert "--profile cl" in capsys.readouterr().err


@pytest.mark.cuda
@pytest.mark.parametrize("airborne", [True, False], ids=["hover", "ground"])
def test_cl_swarm_on_the_card_equals_the_cpu(airborne):
    """testdata.cl_swarm on the card equals its CPU run at B = 64: state,
    command and lock of every quad-tick, the poses within the cell's
    1e-4 m; the card run launches the clean machine's kernel once a
    tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    T = 100 if airborne else 200
    before = obs.counters().get("launches.behavior_step_cl", 0)
    got = testdata.cl_swarm("cuda", 64, T, airborne)
    assert obs.counters().get("launches.behavior_step_cl", 0) == before + T
    want = testdata.cl_swarm("cpu", 64, T, airborne)
    for k in ("state", "cmd_kind", "cmd", "locked"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("est_x", "est_y", "x", "y"):
        assert np.abs(got[k] - want[k]).max() <= 1e-4, k
    assert got["locked"][-1].all(), json.dumps(got["state"][-1].tolist())
