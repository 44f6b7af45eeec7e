"""The port's sharded entry points (parallel/mesh.py, parallel/dryrun.py,
`replay --sharded`) against the unsharded ones, on the CPU.

One CPU (like one card) can show the split only with a repeated device:
every test shards over ["cpu", "cpu"], so each shard's work runs on the
same device one after the other.  What that shows is the split itself:
contiguous lanes, the unsharded entry on each shard, results joined in
order, metrics summed, the swarm's draws made at the global width.  It
cannot show two cards running at once.  Every sharded result is held
bit-equal to the unsharded run."""

import numpy as np
import pytest
import torch

import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import __main__ as tcli
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.formats.scanlog import write_scanlog
from micro_quad_slam_tpu_torch.models.simulator import (
    make_world, sim_init, sim_run)
from micro_quad_slam_tpu_torch.parallel import dryrun, mesh
from micro_quad_slam_tpu_torch.replay.fusion import replay_fusion_batched
from micro_quad_slam_tpu_torch.sim.synthio import synth_room_scanlog
from micro_quad_slam_tpu_torch.slam.pipeline import slam_replay

torch.set_num_threads(2)

CPU2 = [torch.device("cpu")] * 2


def test_make_mesh_lists_devices():
    assert mesh.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert mesh.make_mesh(device="cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()
    assert mesh.shard_bounds(6, CPU2) == [(0, 3), (3, 6)]


@pytest.mark.parametrize("kernel", ["residentx", "hybridx"])
def test_replay_sharded_equals_unsharded(kernel):
    """The committed random flights (flight 1 recenters) through the
    whole-replay kernel's plain version, and the dry run's recentering
    case (half the flights drift 34 m)."""
    frames, _ = testdata.load("random_flights")
    st, outs, metrics = mesh.replay_mapping_sharded(frames, port.UL_PROFILE,
                                                    CPU2, kernel=kernel)
    st_un, outs_un = port.replay_mapping_batched(
        port.frames_to_torch(frames, "cpu"), port.UL_PROFILE, kernel=kernel)
    dryrun._equal(st, st_un, "state")
    dryrun._equal(outs, outs_un, "outs")
    want = port.batch_metrics(outs_un)
    for k, v in metrics.items():
        assert int(v) == int(want[k]), k
    assert int(metrics["recenters"]) >= 1
    assert dryrun.recentering_case(CPU2, (kernel,))[kernel] >= 1


def test_fusion_sharded_equals_unsharded():
    frames = testdata.slam_bench_frames(4, 64, device="cpu")
    got = mesh.replay_fusion_sharded(frames, port.UL_PROFILE, CPU2)
    dryrun._equal(got, replay_fusion_batched(frames, port.UL_PROFILE),
                  "fusion")


def test_slam_sharded_equals_unsharded():
    """The 4 SLAM bench flights cut to 64 frames (B=4, 2 a shard)."""
    frames = {k: v[:, :64] for k, v in
              testdata.slam_bench_frames(4, device="cpu").items()}
    got = mesh.slam_replay_sharded(frames, port.UL_PROFILE, CPU2)
    want = slam_replay(frames, port.UL_PROFILE)
    dryrun._equal(got, want, "slam")
    assert got.kf_idx.shape == (7,)


def test_swarm_sharded_equals_unsharded_generator_included():
    """B=4 quads for 50 ticks at 20 ms (10 scan ticks): every state field,
    every diagnostic and the generator's final state."""
    world = make_world(4, room=(-3.5, -3.5, 3.5, 3.5),
                       obstacles=[(1.5, -0.5, 2.5, 0.5)], device="cpu")
    st0 = sim_init(4, 3, spread_m=0.5, airborne=True, device="cpu")
    gen0 = st0.gen.get_state()
    got, diag = mesh.sim_run_sharded(st0, world, 50, port.UL_PROFILE, CPU2)
    want, wdiag = sim_run(st0, world, 50, port.UL_PROFILE)
    dryrun._equal(got._replace(gen=None), want._replace(gen=None), "state")
    dryrun._equal(diag, wdiag, "diag")
    assert torch.equal(got.gen.get_state(), want.gen.get_state())
    assert not torch.equal(got.gen.get_state(), gen0)
    assert torch.equal(st0.gen.get_state(), gen0)      # the input untouched
    assert got.scan_count == want.scan_count == 10


def test_dryrun_multichip_on_repeated_cpu():
    out = dryrun.dryrun_multichip(CPU2)
    assert out["grids"] == [4, 608, 640] and out["sim"] == [4]
    assert min(out["recenters"].values()) >= 1


def test_sharded_refuses_a_batch_that_does_not_split():
    frames, _ = testdata.load("random_flights")
    three = {k: v[:3] for k, v in frames.items()}
    with pytest.raises(ValueError, match="multiple of the device count"):
        mesh.replay_mapping_sharded(three, port.UL_PROFILE, CPU2)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("logs")
    paths = []
    for s in range(3):
        p = str(d / f"f{s}.bin")
        write_scanlog(p, synth_room_scanlog(n_frames=24, seed=s,
                                            path="circle", noise_mm=5.0))
        paths.append(p)
    return paths


def test_cli_replay_sharded(monkeypatch, tmp_path, capsys, logs):
    """`replay --sharded` over two repeated CPU devices writes the grids
    of the unsharded replay; a log count that does not split over the
    devices, and --resume, exit 2."""
    monkeypatch.setattr(mesh, "make_mesh", lambda *a, **k: CPU2)
    base = ["replay", "--kernel", "residentx", "--device", "cpu"]
    assert tcli.main(base + ["--log", *logs[:2], "--sharded", "--out",
                             str(tmp_path / "s.npy")]) == 0
    out = capsys.readouterr().out
    assert "sharded over 2 devices: " in out
    assert tcli.main(base + ["--log", *logs[:2], "--out",
                             str(tmp_path / "u.npy")]) == 0
    for i in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"s_{i}.npy"),
                                      np.load(tmp_path / f"u_{i}.npy"))
    capsys.readouterr()
    assert tcli.main(base + ["--log", *logs, "--sharded"]) == 2
    assert "multiple of the device count (2)" in capsys.readouterr().err
    assert tcli.main(base + ["--log", *logs[:2], "--sharded", "--resume",
                             str(tmp_path)]) == 2
    assert "--resume" in capsys.readouterr().err
