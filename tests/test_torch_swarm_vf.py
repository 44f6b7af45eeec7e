"""PyTorch port, models/simulator.py: the closed-loop swarm flying on its
vision front-end (pyramidal LK on rendered downward-camera frames,
ops/flow.py) as the ul_swarm_vf.rooms cell flies it: a flow frame every
1 ms tick, the camera streaming from the start.

Held here: sim_run's flow_period_ms (100 is the run it gave before; the
oracle path's operations do not depend on it), the streaming-camera
start, the benchmark's plain reference (portbench/reference/swarm_vf.py)
against ops/flow.py and against the program through the cell's entry
(bit for bit on the CPU, where both are the same float32 operations in
the same order), and the vision branch's spans and counters.  The `cuda`
test holds the card's run to the CPU's."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.models import simulator as S
from micro_quad_slam_tpu_torch.ops import flow as F
from micro_quad_slam_tpu_torch.utils import obs
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE
from portbench import harness
from portbench.gen import flights
from portbench.reference import config as rconf
from portbench.reference import swarm_vf as RV

torch.set_num_threads(2)

CELL = harness.cell("ul_swarm_vf.rooms")
ENTRY = harness.load_module(harness.PKG / "entries" / "swarm_vf_run.py")
PROG = harness.program_config(CELL.conf)
RCFG = rconf.load(CELL.conf)
ROOM = dict(room=(-3.5, -3.5, 3.5, 3.5), obstacles=[(1.5, -0.5, 2.5, 0.5)])


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


def _start(B: int = 4, seed: int = 5, **kw):
    world = S.make_world(B, device="cpu", **ROOM)
    st = S.sim_init(B, seed, spread_m=0.5, airborne=True, device="cpu", **kw)
    return world, st._replace(vx=torch.linspace(-0.3, 0.3, B),
                              vy=torch.linspace(0.2, -0.2, B))


def _assert_runs_equal(a, b):
    (fa, da), (fb, db) = a, b
    for x, y in zip(S.sim_state_to_numpy(fa).values(),
                    S.sim_state_to_numpy(fb).values()):
        if isinstance(x, dict):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        else:
            np.testing.assert_array_equal(x, y)
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(da[k].numpy(), db[k].numpy(),
                                      err_msg=k)


def test_flow_period_100_is_the_run_it_gave_before():
    """sim_run(vision_flow=True, flow_period_ms=100) is the run of sim_step
    at its default flow period, tick by tick, bit for bit (sim_run held
    every run there before it took the period); another period flies
    another run."""
    world, st = _start()
    got = S.sim_run(st, world, 15, UL_PROFILE, dt_ms=20, record=True,
                    vision_flow=True, flow_period_ms=100)
    s, diags = st, []
    for _ in range(15):
        s, d = S.sim_step(s, world, UL_PROFILE, dt_ms=20, record=True,
                          vision_flow=True)
        diags.append(d)
    want = (s, {k: torch.stack([d[k] for d in diags]) for k in diags[0]})
    _assert_runs_equal(got, want)
    _assert_runs_equal(S.sim_run(st, world, 15, UL_PROFILE, dt_ms=20,
                                 record=True, vision_flow=True), want)
    other = S.sim_run(st, world, 15, UL_PROFILE, dt_ms=20, record=True,
                      vision_flow=True, flow_period_ms=20)
    assert not torch.equal(other[1]["of_rate_x"], want[1]["of_rate_x"])


class _Ops(TorchDispatchMode):
    """The aten operations issued, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_oracle_tick_does_the_same_work_at_any_flow_period():
    """With the oracle flow sensor the flow period is never read: the same
    operations in the same order, the same outputs, no flow counter."""
    world, st = _start()
    runs = []
    obs.take()
    for period in (100, 1):
        with _Ops() as ops:
            out = S.sim_run(st, world, 12, UL_PROFILE, dt_ms=1, record=True,
                            flow_period_ms=period)
        runs.append((ops.ops, out))
    assert runs[0][0] == runs[1][0]
    _assert_runs_equal(runs[0][1], runs[1][1])
    assert "sim.flow_frames" not in obs.take()[1]


def test_streaming_camera_start_flows_on_the_first_tick():
    """sim_init(camera_streaming=True): the previous frame is the start
    pose's frame, so the first flow tick gives finite rates of good
    quality (zero: sim_init starts the quads at rest, and a tick's frame
    is taken at the pose the tick starts from), and the next tick the
    body velocity over the height; a camera that starts with the run
    reports NaN and quality 0 on its first tick."""
    world, st = _start(8, camera_streaming=True)
    assert st.cam_valid
    want = F.render_camera_frame(st.x, st.y, torch.clamp(st.alt, min=0.05),
                                 st.yaw * S._DEG2RAD, S.CAM_SIZE,
                                 S.CAM_FOCAL)
    assert torch.equal(st.cam_prev, want)
    kw = dict(dt_ms=1, record=True, vision_flow=True, flow_period_ms=1)
    s1, d1 = S.sim_step(st, world, UL_PROFILE, **kw)
    for k in ("of_rate_x", "of_rate_y"):
        assert torch.isfinite(d1[k]).all() and float(d1[k].abs().max()) < 1e-3
    assert int(d1["of_q"].min()) > 200
    _, d2 = S.sim_step(s1, world, UL_PROFILE, **kw)
    yaw = s1.yaw * S._DEG2RAD
    c, s = torch.cos(yaw), torch.sin(yaw)
    vbx = (c * s1.vx + s * s1.vy) / s1.alt
    vby = (-s * s1.vx + c * s1.vy) / s1.alt
    assert float((d2["of_rate_x"] - vbx).abs().max()) < 0.03
    assert float((d2["of_rate_y"] - vby).abs().max()) < 0.03
    cold = _start(8)[1]
    assert not cold.cam_valid
    _, d0 = S.sim_step(cold, world, UL_PROFILE, **kw)
    assert torch.isnan(d0["of_rate_x"]).all() and (d0["of_q"] == 0).all()


@pytest.mark.parametrize("period_ms", [1, 100])
@pytest.mark.parametrize("speed", [0.3, 1.0])
def test_reference_front_end_equals_ops_flow(period_ms, speed):
    """The reference's renderer, LK and rate conversion against
    ops/flow.py on seeded poses moving at `speed` m/s over one frame
    interval at 0.5 m: bit for bit.  At 1 ms the rates give the speed
    within 3% (median; 6% at most) at quality 240 or more; at 100 ms and
    1 m/s the ~13 px shift is beyond what 3 levels on 32 px recover, the
    speed reads low and some frames fail the quality gate (the cell's
    1 ms interval, PERF.md)."""
    g = torch.Generator().manual_seed(period_ms + int(10 * speed))
    B = 128
    x, y = (torch.rand(B, generator=g) * 4 - 2 for _ in range(2))
    h = torch.full((B,), 0.5)
    yaw = torch.rand(B, generator=g) * 6 - 3
    head = torch.rand(B, generator=g) * 6.3
    dt = period_ms * 1e-3
    x1, y1 = x + speed * dt * torch.cos(head), y + speed * dt * torch.sin(head)
    frames = []
    for px, py in ((x, y), (x1, y1)):
        ref = RV.camera(px, py, h, yaw, S.CAM_SIZE, S.CAM_FOCAL)
        assert torch.equal(ref, F.render_camera_frame(
            px, py, h, yaw, S.CAM_SIZE, S.CAM_FOCAL))
        frames.append(ref)
    dx, dy, q = RV.lk(*frames, 3, 4)
    got = F.lk_flow_batched(*frames)
    for a, b in zip((dx, dy, q), got):
        assert torch.equal(a, b)
    rx, ry = RV.rates(dx, dy, period_ms, S.CAM_FOCAL)
    want = F.flow_to_rates(got.dx_px, got.dy_px, np.float32(dt), S.CAM_FOCAL)
    assert torch.equal(rx, want[0]) and torch.equal(ry, want[1])
    est = torch.hypot(rx, ry) * h / speed
    err = (est - 1).abs()
    if period_ms == 1:
        assert float(err.median()) < 0.03 and float(err.max()) < 0.06
        assert float(q.min()) > 240
    elif speed == 1.0:
        assert float(est.median()) < 0.9
        assert float(q.min()) < UL_PROFILE.gates.of_min_quality


def test_program_equals_reference_through_the_entry():
    """The cell's job (100 ticks would do; 20 here) at B = 16 on rooms of
    the cell's traffic: every compared answer equal, the vision rates and
    qualities of every quad-tick bit for bit."""
    frames = _job(16, 20, 3)
    out = ENTRY.outputs(ENTRY.run(frames, PROG, CELL.work))
    ref = ENTRY.reference(frames, RCFG, CELL.work)
    got = ENTRY.compare(out, ref)
    assert got == dict.fromkeys(got, 0), got
    for k in ("of_rate_x", "of_rate_y", "of_q"):
        assert torch.equal(out[k], ref[k]), k
    assert int(ref["of_q"].min()) > 200


def test_flow_spans_and_counters(tmp_path):
    """sim.flow_frames counts B a flow tick, traced or not; under a
    profiler sim.flow.render and sim.flow.lk open once a flow tick inside
    sim.flow and sim.flow_low_q counts the frames under the quality gate;
    the outputs are bit-equal either way."""
    world, st = _start(4, camera_streaming=True)
    run = lambda: S.sim_run(st, world, 10, UL_PROFILE, dt_ms=20,  # noqa: E731
                            record=True, vision_flow=True,
                            flow_period_ms=40)
    obs.take()
    off = run()
    spans, counts = obs.take()
    assert spans == []
    assert counts["sim.flow_frames"] == 4 * 5
    assert "sim.flow_low_q" not in counts
    with obs.profile_trace(str(tmp_path)) as summary:
        on = run()
    spans, counts = obs.take()
    _assert_runs_equal(off, on)
    calls = {k: v["calls"] for k, v in summary["spans"].items()}
    assert calls["sim.flow"] == 10
    assert calls["sim.flow.render"] == calls["sim.flow.lk"] == 5
    parent = {s.id: s.name for s in spans}
    assert {parent[s.parent] for s in spans
            if s.name.startswith("sim.flow.")} == {"sim.flow"}
    assert counts["sim.flow_frames"] == 20
    q = on[1]["of_q"][1::2]         # the flow ticks' qualities
    assert counts["sim.flow_low_q"] == int(
        (q < UL_PROFILE.gates.of_min_quality).sum())


@pytest.mark.cuda
def test_vf_swarm_on_the_card_equals_the_cpu():
    """testdata.vf_swarm on the card against its CPU run, B = 64 over 100
    ticks of 1 ms (100 LK calls): states and command kinds equal, the
    command values, the EKF positions and the final poses within 1e-4 (m,
    m/s), the vision rates within 1e-3 rad/s and the qualities within 1:
    the card sums each frame in another order, which moves a rate by
    ~1e-5 rad/s and the EKF by less, and may turn a truncated quality by
    one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = testdata.vf_swarm("cuda", 64, 100)
    want = testdata.vf_swarm("cpu", 64, 100)
    for k in ("state", "cmd_kind"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, tol in (("cmd", 1e-4), ("est_x", 1e-4), ("est_y", 1e-4),
                   ("x", 1e-4), ("y", 1e-4), ("of_rate_x", 1e-3),
                   ("of_rate_y", 1e-3), ("of_q", 1)):
        assert np.abs(got[k].astype(np.float64)
                      - want[k].astype(np.float64)).max() <= tol, k
    assert np.isfinite(got["of_rate_x"]).all() and got["of_q"].min() > 200
