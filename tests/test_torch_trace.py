"""PyTorch port, utils/obs.py: the stage spans and counters of the map and
SLAM replays.  Spans record only while a torch profiler records; then they
nest under one root per entry-point call, lie on the profiler's clock
around their stages' ops, synchronise their device at their ends, and leave
every output bit for bit as it is without them.  The counters equal
values computed independently, and the benchmark's trace reader gives
the same device time and launches with the spans' events as without."""

import collections
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.__main__ import main as cli_main
from micro_quad_slam_tpu_torch.ops import residentx as rx
from micro_quad_slam_tpu_torch.replay import mapping as tm
from micro_quad_slam_tpu_torch.ops.raycast import DEFAULT_GEOM, make_rays
from micro_quad_slam_tpu_torch.slam import pipeline as sp
from micro_quad_slam_tpu_torch.utils import obs
from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE
from portbench import devtrace

torch.set_num_threads(2)

# the whole replay's modes, under the names of their kernels
MODES = {"residentx": "exact", "hybridx": "hybrid"}
REPLAYS = {k: (lambda f, m=m: tm.replay_whole(f, UL_PROFILE, mode=m))
           for k, m in MODES.items()}
MAP_SPANS = ["replay", "replay.carry", "replay.rays", "replay.kernel"]
# UL_PROFILE: 3 outer rounds, the loop stage 1 + loop_refine_early (1)
# times in the first two and 1 + loop_refine (3) times in the last, each
# followed by a Gauss-Newton solve
SLAM_SPANS = (["slam", "slam.pass0"]
              + ["slam.pass1"] + ["slam.loop", "slam.gn"] * 2 + ["slam.track"]
              + ["slam.pass1"] + ["slam.loop", "slam.gn"] * 2 + ["slam.track"]
              + ["slam.pass1"] + ["slam.loop", "slam.gn"] * 4 + ["slam.track"]
              + ["slam.pass3"])


def _map_frames():
    """4 committed random flights x 64 frames; flight 1 recenters twice."""
    f, _ = testdata.load("random_flights")
    return port.frames_to_torch({k: v[:4] for k, v in f.items()}, "cpu")


def _slam_frames():
    return testdata.slam_bench_frames(1, 64, device="cpu")


def _traced(fn, logdir):
    """fn() with spans off, then under profile_trace(logdir): (output off,
    output on, spans, counters, profile_trace's summary)."""
    obs.take()
    off = fn()
    assert obs.take()[0] == []
    with obs.profile_trace(str(logdir)) as summary:
        on = fn()
    spans, counts = obs.take()
    return {"off": off, "on": on, "spans": spans, "counts": counts,
            "summary": summary, "dir": logdir}


@pytest.fixture(scope="module")
def map_runs(tmp_path_factory):
    frames = _map_frames()
    return {k: _traced(lambda: fn(frames),
                       tmp_path_factory.mktemp(f"trace_{k}"))
            for k, fn in REPLAYS.items()}


@pytest.fixture(scope="module")
def slam_run(tmp_path_factory):
    frames = _slam_frames()
    return _traced(lambda: sp.slam_replay(frames, UL_PROFILE),
                   tmp_path_factory.mktemp("trace_slam"))


def _fake_card(monkeypatch) -> list:
    """torch.cuda reports an initialised card whose synchronize is
    recorded: the list of calls."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    return calls


def test_without_a_profiler_no_span_no_sync_and_host_counters_count(
        monkeypatch):
    frames, sframes = _map_frames(), _slam_frames()
    calls = _fake_card(monkeypatch)
    obs.take()
    for fn in REPLAYS.values():
        fn(frames)
    sp.slam_replay(sframes, UL_PROFILE)
    obs.count("launches.replay_exact")
    spans, counts = obs.take()
    assert spans == [] and calls == []
    B, T = frames["x_m"].shape
    K = len(range(0, 64, UL_PROFILE.slam.kf_every))
    assert counts == {"replay.frames": 2 * B * T, "slam.frames": 64,
                      "slam.loop.matches": 8 * UL_PROFILE.slam.loop_cand * K,
                      "launches.replay_exact": 1}


def test_spans_synchronise_the_card_at_their_ends(monkeypatch):
    frames = _map_frames()
    calls = _fake_card(monkeypatch)
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        REPLAYS["hybridx"](frames)
    spans, counts = obs.take()
    assert [s.name for s in spans] == MAP_SPANS
    assert len(calls) == len(spans)
    assert counts["replay.recenters"] == 2


def test_spans_synchronise_the_device_they_name(monkeypatch):
    """A root span on a CUDA device waits for that device, and its
    children for their parent's, as each shard's spans do under replay
    --sharded; a root span with no device waits for the current one."""
    calls = _fake_card(monkeypatch)
    obs.take()
    card1 = torch.device("cuda", 1)
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("replay", card1):
            with obs.span("replay.kernel"):
                pass
        with obs.span("slam"):
            pass
    spans, _ = obs.take()
    assert [s.name for s in spans] == ["replay", "replay.kernel", "slam"]
    assert calls == [(card1,), (card1,), ()]


@pytest.mark.parametrize("kernel", list(REPLAYS))
def test_replay_spans_nest_under_one_root(map_runs, kernel):
    spans = map_runs[kernel]["spans"]
    assert [s.name for s in spans] == MAP_SPANS
    root = spans[0]
    assert root.parent == 0 and root.root == root.id
    by_id = {s.id: s for s in spans}
    for s in spans[1:]:
        assert s.root == root.id and s.parent == root.id
        up = by_id[s.parent]
        assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    for a, b in zip(spans[1:], spans[2:]):
        assert a.end_ns <= b.start_ns
    table = map_runs[kernel]["summary"]["spans"]
    assert list(table) == MAP_SPANS
    assert all(r["self_s"] >= 0 and r["calls"] == 1 for r in table.values())


def test_slam_replay_gives_its_25_spans_in_order(slam_run):
    spans = slam_run["spans"]
    assert [s.name for s in spans] == SLAM_SPANS and len(spans) == 25
    root = spans[0]
    by_id = {s.id: s for s in spans}
    for s in spans[1:]:
        assert s.root == root.id and s.parent == root.id
        assert by_id[s.parent].start_ns <= s.start_ns <= s.end_ns \
            <= by_id[s.parent].end_ns
    assert all(r["self_s"] >= 0
               for r in slam_run["summary"]["spans"].values())


@pytest.mark.parametrize("what", ["residentx", "hybridx", "slam"])
def test_outputs_bit_identical_with_spans_on_and_off(map_runs, slam_run,
                                                     what):
    run = slam_run if what == "slam" else map_runs[what]
    if what == "slam":
        pairs = [(getattr(run["off"], k), getattr(run["on"], k))
                 for k in run["off"]._fields if k != "origin"]
        pairs += list(zip(run["off"].origin, run["on"].origin))
    else:
        (so, oo), (sn, on) = run["off"], run["on"]
        pairs = [(getattr(so, k), getattr(sn, k)) for k in so._fields]
        pairs += [(oo[k], on[k]) for k in oo]
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.contiguous().numpy().tobytes() == \
            b.contiguous().numpy().tobytes()


@pytest.mark.parametrize("kernel", list(REPLAYS))
def test_replay_counters_equal_the_schedule(map_runs, kernel):
    frames = _map_frames()
    sched = tm.schedule(frames, UL_PROFILE, mode=MODES[kernel])[0]
    do = int(sched[..., rx.H_DO].sum())
    _, outs = map_runs[kernel]["off"]
    assert do == int((outs["kf_flags"] != 0).sum()) == 2
    assert map_runs[kernel]["counts"] == {
        "replay.frames": frames["x_m"].numel(), "replay.recenters": do}


def test_loop_counters_equal_the_loop_stage():
    """One outer round at kf_every 4, stopped after the loop stage: its
    edges are _slam_impl's ok, its near candidates _cand_indices' gate."""
    cfg = UL_PROFILE.replace(slam=dataclasses.replace(UL_PROFILE.slam,
                                                      slam_outer=1))
    frames = testdata.slam_bench_frames(2, 64, device="cpu")
    obs.take()
    with profile(activities=[ProfilerActivity.CPU]):
        matched, _, _, ok = sp._slam_impl(frames, cfg, DEFAULT_GEOM, 4, None,
                                          upto=2)
    spans, counts = obs.take()
    assert [s.name for s in spans] == ["slam.pass0", "slam.pass1",
                                       "slam.loop"]
    kfp = matched[:, ::4]
    n_cand = cfg.slam.loop_cand
    _, near = sp._cand_indices(kfp, cfg, n_cand)
    assert counts == {"slam.loop.matches": 2 * n_cand * kfp.shape[1],
                      "slam.loop.near": int(near.sum()),
                      "slam.loop.edges": int(ok.sum())}
    assert 0 < counts["slam.loop.edges"] <= counts["slam.loop.near"]


def _events(logdir) -> list:
    with open(logdir / "trace.json") as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _top_ops(events, lo=float("-inf"), hi=float("inf")) -> collections.Counter:
    """The aten ops inside [lo, hi] (trace microseconds) that no other
    aten op encloses, by name."""
    ops = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") == "cpu_op"
                  and e["name"].startswith("aten::")
                  and lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"])
                  <= hi), key=lambda o: (o[0], -o[1]))
    out, end = collections.Counter(), float("-inf")
    for s, e, name in ops:
        if s >= end:
            out[name] += 1
            end = e
    return out


def _ops_of(fn, tmp_path) -> collections.Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "alone.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return _top_ops([e for e in json.load(f)["traceEvents"]
                         if e.get("ph") == "X"])


def test_trace_json_holds_the_spans_around_their_stages_ops(map_runs,
                                                            tmp_path):
    """The exact replay's trace: one user_annotation per span, nested as
    the spans are, and each stage's annotation encloses exactly the aten
    ops of that stage run alone."""
    events = _events(map_runs["residentx"]["dir"])
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"
           and e["name"] in MAP_SPANS}
    assert sorted(ann) == sorted(MAP_SPANS)
    iv = {k: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
          for k, e in ann.items()}
    for k in MAP_SPANS[1:]:
        assert iv["replay"][0] <= iv[k][0] <= iv[k][1] <= iv["replay"][1]
    frames = _map_frames()
    library = tm.MODES["exact"].library
    beams, so, _, _ = tm.carry(frames, UL_PROFILE, library=library)
    sched = tm.schedule(frames, UL_PROFILE)[0]

    def rays():
        r = make_rays(beams, frames["x_m"], frames["y_m"], frames["yaw_deg"],
                      so["ox"], so["oy"], so["enabled"], UL_PROFILE.map,
                      UL_PROFILE.tof)
        rx._pack(r, so["do"], so["sy"], so["sx"], DEFAULT_GEOM)

    grids = rx._fresh_grids(frames["x_m"], DEFAULT_GEOM)
    alone = {"replay.carry": lambda: tm.carry(frames, UL_PROFILE,
                                              library=library),
             "replay.rays": rays,
             "replay.kernel": lambda: rx.replay_exact(grids, sched,
                                                      UL_PROFILE)}
    for k, fn in alone.items():
        want = _ops_of(fn, tmp_path)
        assert sum(want.values()) > 0
        assert _top_ops(events, *iv[k]) == want, k


@pytest.mark.parametrize("what", ["residentx", "hybridx", "slam"])
def test_spans_json_shares(map_runs, slam_run, what):
    run = slam_run if what == "slam" else map_runs[what]
    with open(run["dir"] / "spans.json") as f:
        table = json.load(f)
    assert table["card"] == "cpu" and table["counters"] == run["counts"]
    rows = table["spans"]
    root = "slam" if what == "slam" else "replay"
    assert rows[root]["share_pct"] == 100.0
    assert all(0 < r["share_pct"] <= 100.0 for r in rows.values())
    stages = sum(r["total_s"] for k, r in rows.items() if k != root)
    assert stages <= rows[root]["total_s"]
    assert rows[root]["self_s"] == pytest.approx(rows[root]["total_s"]
                                                 - stages, abs=1e-6)


def test_devtrace_summary_ignores_the_span_events():
    """portbench's reader gives the same numbers on a trace with and
    without the spans' user_annotation and gpu_user_annotation events."""
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    base = [x("aten::add", "cpu_op", 0, 30), x("cudaLaunchKernel",
                                               "cuda_runtime", 5, 10),
            x("add_kernel", "kernel", 20, 15), x("aten::where", "cpu_op",
                                                 60, 40),
            x("cuLaunchKernel", "cuda_driver", 70, 5),
            x("replay_exact_kernel", "kernel", 110, 50),
            x("cudaDeviceSynchronize", "cuda_runtime", 100, 70),
            x("Memcpy DtoH", "gpu_memcpy", 175, 3)]
    spans = [x("replay", "user_annotation", 0, 180),
             x("replay.carry", "user_annotation", 0, 100),
             x("replay.kernel", "user_annotation", 100, 75),
             x("replay", "gpu_user_annotation", 20, 158),
             x("replay.kernel", "gpu_user_annotation", 110, 50)]
    a = devtrace.summarize(base, 1.0)
    b = devtrace.summarize(base + spans, 1.0)
    for k in ("busy_s", "launches", "kernel_s"):
        assert a[k] == b[k], k
    assert a["launches"] == 2


def test_cli_trace_dir_writes_the_trace_and_one_line(tmp_path, capsys):
    log = tmp_path / "f.bin"
    assert cli_main(["synth", "--out", str(log), "--frames", "24"]) == 0
    out = tmp_path / "tr"
    assert cli_main(["replay", "--log", str(log), "--kernel", "hybridx",
                     "--device", "cpu", "--trace-dir", str(out)]) == 0
    err = capsys.readouterr().err.strip().splitlines()
    line = [ln for ln in err if ln.startswith("trace ")]
    assert len(line) == 1 and "replay 1x" in line[0] \
        and "replay.kernel" in line[0] and "replay.frames=24" in line[0]
    table = json.loads((out / "spans.json").read_text())
    assert list(table["spans"]) == MAP_SPANS
    assert any(e.get("name") == "replay.carry" for e in _events(out))
