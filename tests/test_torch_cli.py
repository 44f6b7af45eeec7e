"""PyTorch port, the CLI (python -m micro_quad_slam_tpu_torch) against the
JAX package's `mqs` (micro_quad_slam_tpu/cli.py::main) on the CPU: the
same files byte for byte where both write them from equal results
(synth's scanlog and wirecap, replay's grid, navlog and PGM), the slam
track within the SLAM tests' tolerance, sim's checkpoint resume equal to
an unbroken run, info, and the bench entry's checksums equal to the JAX
package's replay of the same frames."""

import json
import sys

import numpy as np
import pytest
import torch

from micro_quad_slam_tpu import cli as jcli
from micro_quad_slam_tpu.replay import fusion as jfusion
from micro_quad_slam_tpu.replay import mapping as jm
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
from micro_quad_slam_tpu_torch import __main__ as tcli
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.formats.wirecap import write_wirecap

torch.set_num_threads(2)


def _run(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("mav2", [False, True])
def test_synth_with_wirecap_writes_the_jax_clis_bytes(tmp_path, capsys,
                                                      mav2):
    args = ["synth", "--frames", "30", "--path", "fig8", "--seed", "3",
            "--dropout", "0.05"] + (["--mav2"] if mav2 else [])
    outs = {}
    for tag, main in (("t", tcli.main), ("j", jcli.main)):
        outs[tag] = _run(main, args + [
            "--out", str(tmp_path / f"{tag}.bin"),
            "--emit-wirecap", str(tmp_path / f"{tag}.cap")], capsys)
    for ext in ("bin", "cap"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes(), ext
    assert outs["t"].replace("t.", "j.") == outs["j"]
    assert f"MAVLink v{2 if mav2 else 1}" in outs["t"]


@pytest.fixture(scope="module")
def flight(tmp_path_factory):
    """A 30-frame synthetic flight as a scanlog and as a capture, written
    by the JAX CLI."""
    d = tmp_path_factory.mktemp("flight")
    log, cap = str(d / "f.bin"), str(d / "f.cap")
    assert jcli.main(["synth", "--out", log, "--frames", "30", "--path",
                      "circle", "--seed", "5", "--emit-wirecap", cap]) == 0
    return log, cap


def test_replay_wirecap_writes_the_jax_clis_grid(tmp_path, capsys, flight):
    _, cap = flight
    jout = _run(jcli.main, ["replay", "--wirecap", cap, "--out",
                            str(tmp_path / "j.npy")], capsys)
    for kernel in ("xla", "residentx"):
        tout = _run(tcli.main, ["replay", "--wirecap", cap, "--kernel",
                                kernel, "--device", "cpu", "--out",
                                str(tmp_path / "t.npy")], capsys)
        assert tout.replace("t.npy", "j.npy") == jout
        np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                      np.load(tmp_path / "j.npy"))


def test_replay_navlog_pgm_and_ascii_write_the_jax_clis_bytes(
        tmp_path, capsys, flight):
    log, _ = flight
    outs = {}
    for tag, main, extra in (("t", tcli.main, ["--device", "cpu"]),
                             ("j", jcli.main, [])):
        outs[tag] = _run(main, ["replay", "--log", log, "--ascii",
                                "--navlog", str(tmp_path / f"{tag}.csv"),
                                "--pgm", str(tmp_path / f"{tag}.pgm")]
                         + extra, capsys)
        _run(main, ["replay", "--log", log, "--pgm-raw", "--pgm",
                    str(tmp_path / f"{tag}_raw.pgm")] + extra, capsys)
    for name in ("{}.csv", "{}.pgm", "{}_raw.pgm"):
        assert (tmp_path / name.format("t")).read_bytes() == \
            (tmp_path / name.format("j")).read_bytes(), name
    assert outs["t"].replace("t.", "j.") == outs["j"]
    assert "#" in outs["t"]                            # the ASCII map
    assert tcli.main(["replay", "--log", log, log, "--navlog",
                      str(tmp_path / "x.csv"), "--device", "cpu"]) == 2
    assert tcli.main(["replay", "--device", "cpu"]) == 2


def test_slam_wirecap_track_within_the_slam_tolerance(tmp_path, capsys):
    """slam --wirecap --track on the committed capture against the JAX
    package's SLAM of it (testdata wire_ref, at UL_PROFILE's own gn_iters
    of 5, not the CLI's default 8) as its CLI writes the track: t_ms
    equal, poses within 1e-4 (tests/test_torch_slam.py's track tolerance)
    plus the CSV's 1e-4 rounding step."""
    cap = str(tmp_path / "w.cap")
    write_wirecap(cap, testdata.wire_capture())
    out = _run(tcli.main, ["slam", "--wirecap", cap, "--device", "cpu",
                           "--gn-iters", "5",
                           "--track", str(tmp_path / "t.csv"), "--pgm",
                           str(tmp_path / "t.pgm")], capsys)
    assert "SLAM: 256 frames, 26 keyframes" in out
    ref = testdata.reference("wire_ref")
    rows = (tmp_path / "t.csv").read_text().strip().split("\n")
    assert rows[0] == "t_ms,x,y,yaw_rad,odo_x,odo_y,odo_yaw_rad"
    got = np.array([[float(v) for v in r.split(",")] for r in rows[1:]])
    scan_ms = testdata.wire_flight().scan_ms
    np.testing.assert_array_equal(got[:, 0], scan_ms)
    want = np.concatenate([ref["slam_track"][0], ref["slam_odo_track"][0]],
                          axis=1)
    assert np.abs(got[:, 1:] - want).max() <= 1e-4 + 1e-4
    assert (tmp_path / "t.pgm").read_bytes().startswith(b"P5\n")


def test_slam_set_refusal_exits_2(tmp_path, capsys, flight):
    """--slam-set match_feedback=true runs (exit 0); an unknown key still
    exits with an error; the overrides parse as the JAX CLI's do."""
    log, _ = flight
    assert tcli.main(["slam", "--log", log, "--device", "cpu", "--slam-set",
                      "match_feedback=true"]) == 0
    assert "SLAM:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tcli.main(["slam", "--log", log, "--device", "cpu", "--slam-set",
                   "bogus=1"])
    port_cfg = tcli._override_slam(tcli._profile("ul").slam, [
        "match_iters=3", "loop_w=50,50,200", "match_xy_step_m=0.04"])
    jax_cfg = jcli._override_slam(JAX_UL.slam, [
        "match_iters=3", "loop_w=50,50,200", "match_xy_step_m=0.04"])
    assert (port_cfg.match_iters, port_cfg.loop_w, port_cfg.match_xy_step_m) \
        == (jax_cfg.match_iters, jax_cfg.loop_w, jax_cfg.match_xy_step_m)


def test_sim_save_state_then_resume_equals_an_unbroken_run(tmp_path,
                                                           capsys):
    base = ["sim", "--quads", "2", "--dt-ms", "20", "--seed", "2",
            "--device", "cpu"]
    ck = str(tmp_path / "ck")
    out = _run(tcli.main, base + ["--seconds", "0.3", "--save-state", ck],
               capsys)
    assert "sim state -> " in out and "step_15.pkl" in out
    out = _run(tcli.main, base + ["--seconds", "0.3", "--resume", ck,
                                  "--out-prefix", str(tmp_path / "a"),
                                  "--emit-mavlink", str(tmp_path / "a.mav")],
               capsys)
    assert "resuming sim from" in out and "FC command stream" in out
    _run(tcli.main, base + ["--seconds", "0.6", "--out-prefix",
                            str(tmp_path / "b")], capsys)
    np.testing.assert_array_equal(np.load(tmp_path / "a_grids.npy"),
                                  np.load(tmp_path / "b_grids.npy"))
    assert (tmp_path / "a.mav").stat().st_size > 0


def test_info_runs_with_the_jax_clis_keys(capsys):
    jcli.main(["info"])
    jkeys = set(json.loads(capsys.readouterr().out))
    info = json.loads(_run(tcli.main, ["info"], capsys))
    assert set(info) == jkeys
    assert info["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    from micro_quad_slam_tpu_torch.io.native import native_available
    assert info["native_io"] is native_available()
    assert "ul" in info["profiles"]


@pytest.fixture
def bench_env(monkeypatch):
    for k, v in {"MQS_BENCH_B": "4", "MQS_BENCH_T": "32",
                 "MQS_BENCH_FULL": "0", "MQS_BENCH_REPS": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MQS_BENCH_MODE", raising=False)
    monkeypatch.delenv("MQS_BENCH_KERNEL", raising=False)


def _lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_bench_checksums_equal_the_jax_replay(capsys, bench_env,
                                              monkeypatch):
    """bench at B=4, T=32: the residentx and hybridx lines' checksums equal
    the JAX package's xla and hybrid replays of bench.py's frames at that
    size; the ekf mode's equals its fusion replay's."""
    lines = _lines(_run(tcli.main, ["bench", "--device", "cpu"], capsys))
    assert [ln["metric"] for ln in lines] == [
        "fused_sensor_frames_per_sec_per_chip",
        "fused_sensor_frames_per_sec_per_chip_hybridx"]
    frames = testdata.bench_frames(4, 32)
    for line, jkernel in zip(lines, ("xla", "hybrid")):
        st, _ = jm.replay_mapping_batched(frames, JAX_UL, kernel=jkernel)
        want = int(np.asarray(st.grid).astype(np.int32).sum(dtype=np.int32))
        assert line["checksum"] == want
        assert {"value", "unit", "vs_baseline", "device",
                "rep_seconds"} <= set(line) and line["device"] == "cpu"
    monkeypatch.setenv("MQS_BENCH_MODE", "ekf")
    line, = _lines(_run(tcli.main, ["bench", "--device", "cpu"], capsys))
    fr = {k: v.numpy() for k, v in
          testdata.slam_bench_frames(4, 32, device="cpu").items()}
    _, track = jfusion.replay_fusion_batched(fr, JAX_UL)
    x = np.asarray(track["x"]).astype(np.int32)
    assert line["checksum"] == int(x.sum(dtype=np.int32))
    if not torch.cuda.is_available():
        assert tcli.main(["bench"]) == 2


def test_bench_frames_at_the_committed_size_equal_bench_py():
    """The bench entry's replay frames (testdata.bench_frames) at T=256 are
    the committed ones; at another T the port's synthio builds bench.py's
    flight, whose first frames are the same flight's."""
    full = testdata.bench_frames(3, 256)
    short = testdata.bench_frames(3, 32)
    for k in full:
        np.testing.assert_array_equal(short[k], full[k][:, :32], err_msg=k)


def test_fusion_wirecap_track_equals_the_jax_clis(tmp_path, capsys, flight):
    """fusion --wirecap: the same summary line and track CSV as the JAX
    CLI, t_ms equal and the EKF states within 1e-5 (tests/test_torch_ekf.py)
    plus the CSV's 1e-4 rounding step."""
    _, cap = flight
    out = {}
    for tag, main, extra in (("t", tcli.main, ["--device", "cpu"]),
                             ("j", jcli.main, [])):
        out[tag] = _run(main, ["fusion", "--wirecap", cap, "--out",
                               str(tmp_path / f"{tag}.csv")] + extra, capsys)
    assert out["t"].replace("t.csv", "j.csv") == out["j"]
    rows = [[np.array([float(v) for v in r.split(",")])
             for r in (tmp_path / f"{tag}.csv").read_text().split("\n")[1:]
             if r] for tag in ("t", "j")]
    got, want = np.stack(rows[0]), np.stack(rows[1])
    np.testing.assert_array_equal(got[:, [0, 8]], want[:, [0, 8]])
    assert np.abs(got - want).max() <= 1e-5 + 1e-4


def test_replay_resumes_a_jax_cli_checkpoint(tmp_path, capsys, monkeypatch):
    """The JAX CLI replays the first half of a flight with --save-state
    (its pickle format: orbax hidden); the port's CLI resumes it on the
    second half and writes the grid of the unbroken replay; the port's
    own --save-state/--resume gives it too, as does slam's."""
    from micro_quad_slam_tpu.formats.scanlog import write_scanlog
    from micro_quad_slam_tpu.sim import synth_room_scanlog

    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)   # pickles
    log = synth_room_scanlog(n_frames=24, seed=8, noise_mm=4.0,
                             with_flow=True)
    halves = {}
    for name, sl in (("a", slice(0, 12)), ("b", slice(12, 24)),
                     ("full", slice(0, 24))):
        part = type(log)(**{k: v[sl] for k, v in vars(log).items()})
        halves[name] = str(tmp_path / f"{name}.bin")
        write_scanlog(halves[name], part)
    dev = ["--device", "cpu"]
    jck, tck = str(tmp_path / "jck"), str(tmp_path / "tck")
    assert "mapper state -> " in _run(jcli.main, [
        "replay", "--log", halves["a"], "--save-state", jck], capsys)
    _run(tcli.main, ["replay", "--log", halves["a"], "--save-state", tck,
                     "--kernel", "residentx"] + dev, capsys)
    _run(tcli.main, ["replay", "--log", halves["full"], "--out",
                     str(tmp_path / "full.npy")] + dev, capsys)
    full = np.load(tmp_path / "full.npy")
    for ck in (jck, tck):
        out = _run(tcli.main, ["replay", "--log", halves["b"], "--resume", ck,
                               "--out", str(tmp_path / "r.npy")] + dev,
                   capsys)
        assert "resuming from" in out and "step_12.pkl" in out
        np.testing.assert_array_equal(np.load(tmp_path / "r.npy"), full)
    sck = str(tmp_path / "sck")
    _run(tcli.main, ["slam", "--log", halves["a"], "--kf-every", "4",
                     "--save-state", sck] + dev, capsys)
    out = _run(tcli.main, ["slam", "--log", halves["b"], "--kf-every", "4",
                           "--resume", sck] + dev, capsys)
    assert "resuming SLAM map from" in out and "SLAM: 12 frames" in out
