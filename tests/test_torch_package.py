"""PyTorch port, package level: the re-declared GridGeom and configuration,
that the port imports neither jax nor the JAX package, that its entry
points ask for the CUDA device by default, its scanlog reader, and the
configuration and operand checks of its kernels' wrappers."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from micro_quad_slam_tpu.formats import scanlog as jscanlog
from micro_quad_slam_tpu.ops import raycast as jr
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils import config as jconfig
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch.formats import scanlog as tscanlog
from micro_quad_slam_tpu_torch.ops import conex as cx
from micro_quad_slam_tpu_torch.ops import raycast as tr
from micro_quad_slam_tpu_torch.ops import residentx as rx
from micro_quad_slam_tpu_torch.utils import config as tconfig
from micro_quad_slam_tpu_torch.utils.config import (MapConfig, TofConfig,
                                                    UL_PROFILE)

torch.set_num_threads(2)

PORT_DIR = pathlib.Path(port.__file__).resolve().parent


@pytest.mark.parametrize("which", ["default", "from_map_default",
                                   "from_map_fine_rect"])
def test_grid_geom_equals_jax_field_for_field(which):
    make = {"default": lambda m, c: m.DEFAULT_GEOM,
            "from_map_default": lambda m, c: m.GridGeom.from_map(c.MapConfig()),
            "from_map_fine_rect": lambda m, c: m.GridGeom.from_map(
                c.MapConfig(res_m=0.05, width=800, height=600))}[which]
    j, t = make(jr, jconfig), make(tr, tconfig)
    names = [f.name for f in dataclasses.fields(jr.GridGeom)]
    assert names == [f.name for f in dataclasses.fields(tr.GridGeom)]
    assert dataclasses.astuple(j) == dataclasses.astuple(t)


def _fields(cfg):
    """A configuration as nested (class name, field, value) tuples."""
    return (type(cfg).__name__,) + tuple(
        (f.name, _fields(getattr(cfg, f.name))
         if dataclasses.is_dataclass(getattr(cfg, f.name))
         else getattr(cfg, f.name)) for f in dataclasses.fields(cfg))


@pytest.mark.parametrize("profile", ["UL_PROFILE", "CL_PROFILE",
                                     "UL_RT_PROFILE"])
def test_config_equals_jax_field_for_field(profile):
    """The port's copy of utils/config.py: the same classes, fields,
    defaults and profiles as the JAX package's."""
    assert (_fields(getattr(tconfig, profile))
            == _fields(getattr(jconfig, profile)))
    assert getattr(port, profile) is getattr(tconfig, profile)
    t = tconfig.PipelineConfig()
    assert t.map.max_ray_cells == jconfig.MapConfig().max_ray_cells
    assert t.tof.half_fov_deg == jconfig.TofConfig().half_fov_deg


def _imports(path: pathlib.Path):
    """Every module name a Python file imports (absolute imports)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


NEW_MODULES = ("bench.py", "utils/checkpoint.py", "formats/mavlink.py",
               "formats/scanframe.py", "formats/wirecap.py",
               "formats/navlog.py", "formats/armlink.py",
               "replay/telemetry.py", "replay/livestream.py",
               "sim/synthio.py", "utils/obs.py", "__main__.py",
               "parallel/mesh.py", "parallel/dryrun.py",
               "models/behavior_cl.py", "io/native.py")


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = sorted(PORT_DIR.rglob("*.py"))
    assert len(files) >= 15
    scanned = {str(f.relative_to(PORT_DIR)) for f in files}
    assert set(NEW_MODULES) <= scanned
    bad = [(str(f.relative_to(PORT_DIR)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "micro_quad_slam_tpu")]
    assert not bad


def test_port_imports_and_replays_without_jax(tmp_path):
    """In a fresh interpreter (this process already holds jax: conftest
    imports it), the port imports and replays committed flights on the
    CPU in the exact and the hybrid whole-replay modes, runs the EKF and
    SLAM replays and a few simulator ticks with vision flow, and imports
    neither jax nor the JAX package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import micro_quad_slam_tpu_torch as port
        from micro_quad_slam_tpu_torch import testdata
        from micro_quad_slam_tpu_torch.replay.fusion import (
            replay_fusion_batched)
        from micro_quad_slam_tpu_torch.slam import slam_replay
        f, _ = testdata.load("random_flights")
        f = port.frames_to_torch({k: v[:2, :8] for k, v in f.items()}, "cpu")
        for kernel in ("residentx", "hybridx"):
            st, outs = port.replay_mapping_batched(f, port.UL_PROFILE,
                                                   kernel=kernel)
            assert bool(outs["used"].all()), kernel
            assert int(st.grid.ne(0).sum()) > 100, kernel
        s, _ = testdata.load("slam_bench_flights")
        s = port.frames_to_torch({k: v[:1, :24] for k, v in s.items()},
                                 "cpu")
        _, track = replay_fusion_batched(s, port.UL_RT_PROFILE)
        res = slam_replay(s, port.UL_RT_PROFILE, kf_every=8, gn_iters=2)
        assert res.track.shape == (1, 24, 3) and track["x"].shape == (1, 24)
        assert int(res.grid.ne(0).sum()) > 100
        from micro_quad_slam_tpu_torch.models import simulator as sim
        w = sim.make_world(2, device="cpu")
        st = sim.sim_init(2, airborne=True, device="cpu")
        st, _ = sim.sim_run(st, w, 10, port.UL_PROFILE, vision_flow=True)
        assert st.scan_count == 2 and int(st.mapper.grid.ne(0).sum()) > 50
        from micro_quad_slam_tpu_torch import bench, formats
        from micro_quad_slam_tpu_torch.__main__ import main
        from micro_quad_slam_tpu_torch.formats import armlink, mavlink
        from micro_quad_slam_tpu_torch.replay import livestream
        from micro_quad_slam_tpu_torch.sim import synth_room_scanlog
        from micro_quad_slam_tpu_torch.utils import checkpoint, obs
        log = synth_room_scanlog(n_frames=6, seed=1, with_flow=True)
        cap = livestream.scanlog_to_wirecap(log, mav_version=2)
        st, _, n = livestream.replay_wirecap(cap, kernel="residentx",
                                             device="cpu")
        assert n == 6 and int(st.grid.ne(0).sum()) > 10
        assert list(mavlink.decode_mavlink_stream(cap[0][2]))
        assert armlink.decode_arm_msg(armlink.encode_arm_msg(1, 2, 3))
        p = checkpoint.save_checkpoint(
            "ck", port.mapping_state_to_numpy(port.mapping_init(1, device="cpu")))
        assert set(checkpoint.restore_checkpoint(p)) >= {"grid", "filt"}
        assert obs.map_divergence(st.grid, st.grid)["iou_free"] == 1.0
        import contextlib, io, json
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(["info"]) == 0
        assert json.loads(out.getvalue())["backend"] in ("cuda", "cpu")
        assert formats.NavlogWriter and bench.run
        from micro_quad_slam_tpu_torch.io import native
        from micro_quad_slam_tpu_torch.models import behavior_cl
        from micro_quad_slam_tpu_torch.parallel import mesh
        from micro_quad_slam_tpu_torch.slam import pipeline
        st, _, m = mesh.replay_mapping_sharded(
            {k: v[:2, :8] for k, v in testdata.load("random_flights")[0].items()},
            port.UL_PROFILE, ["cpu", "cpu"], kernel="residentx")
        assert int(m["frames_total"]) == 16 and st.grid.shape[0] == 2
        formats.write_scanlog("l.bin", log)
        assert np.array_equal(native.read_scanlog_native("l.bin").grid_mm,
                              formats.read_scanlog("l.bin").grid_mm)
        cl = behavior_cl.behavior_cl_init(2, "cpu")
        assert cl._fields[0] == "st"
        import dataclasses
        fb = dataclasses.replace(port.UL_RT_PROFILE, slam=dataclasses.replace(
            port.UL_RT_PROFILE.slam, match_feedback=True))
        res = pipeline.slam_replay(s, fb, kf_every=8, gn_iters=2)
        assert res.track.shape == (1, 24, 3)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "micro_quad_slam_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": ":".join(sys.path)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_restoring_a_jax_checkpoint_imports_no_jax(tmp_path, monkeypatch):
    """A JAX MappingState and SimState pickle restored by the port in a
    fresh interpreter: the unpickler maps the JAX classes to field dicts
    and imports neither jax nor the JAX package."""
    import jax

    from micro_quad_slam_tpu.models import simulator as jsim
    from micro_quad_slam_tpu.replay import mapping as jm
    from micro_quad_slam_tpu.utils import checkpoint as jck

    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)   # pickles
    jck.save_checkpoint(str(tmp_path / "map"), jm.mapping_init(2), step=3)
    jck.save_checkpoint(str(tmp_path / "sim"), jsim.sim_init(
        2, jax.random.PRNGKey(1), airborne=True), step=4)
    code = textwrap.dedent("""
        import sys
        from micro_quad_slam_tpu_torch.utils.checkpoint import (
            latest_checkpoint, restore_checkpoint)
        from micro_quad_slam_tpu_torch.models.simulator import (
            sim_state_from_numpy)
        import micro_quad_slam_tpu_torch as port
        m = restore_checkpoint(latest_checkpoint("map"))
        st = port.mapping_state_from_numpy(m, "cpu")
        assert st.grid.shape == (2, 608, 640)
        s = restore_checkpoint(latest_checkpoint("sim"))
        assert sorted(s["mapper"]) == sorted(port.MappingState._fields)
        sim = sim_state_from_numpy(s, "cpu", seed=3)
        assert bool(sim.mapper.inited.all()) and sim.t_ms == 0
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib",
                                               "micro_quad_slam_tpu"))
        assert not loaded, loaded
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": ":".join(sys.path)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _np_frames():
    log = synth_room_scanlog(n_frames=3, seed=0)
    return {k: v[None] for k, v in port.scanlog_to_arrays(log).items()}


@pytest.mark.parametrize("entry", ["frames_to_torch", "mapping_init",
                                   "mapping_state_from_numpy", "ekf_init",
                                   "new_padded_grid", "make_world",
                                   "sim_init"])
def test_entry_points_ask_for_cuda_by_default(entry):
    """Without a device argument the port's tensors go to the CUDA
    device; without one they raise instead of landing on the CPU."""
    from micro_quad_slam_tpu_torch.models import simulator as sim
    from micro_quad_slam_tpu_torch.ops import ekf

    call = {"frames_to_torch": lambda: port.frames_to_torch(_np_frames()),
            "mapping_init": lambda: port.mapping_init(2),
            "mapping_state_from_numpy": lambda: port.mapping_state_from_numpy(
                port.mapping_state_to_numpy(port.mapping_init(2, device="cpu"))),
            "ekf_init": lambda: ekf.ekf_init((2,)),
            "new_padded_grid": lambda: tr.new_padded_grid(batch=(2,)),
            "make_world": lambda: sim.make_world(2),
            "sim_init": lambda: sim.sim_init(2, airborne=True),
            }[entry]
    if torch.cuda.is_available():
        out = call()
        t = {"frames_to_torch": lambda o: o["x_m"],
             "ekf_init": lambda o: o.mean, "new_padded_grid": lambda o: o,
             "make_world": lambda o: o.room,
             "sim_init": lambda o: o.mapper.grid}.get(entry,
                                                      lambda o: o.grid)(out)
        assert t.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cli_without_cuda_needs_device_cpu(tmp_path, capsys):
    from micro_quad_slam_tpu_torch.__main__ import main

    p = tmp_path / "f.bin"
    jscanlog.write_scanlog(str(p), synth_room_scanlog(n_frames=4, seed=1))
    rc = main(["replay", "--log", str(p), "--kernel", "hybridx"])
    if torch.cuda.is_available():
        assert rc == 0                     # the default: the CUDA device
    else:
        assert rc == 2 and "--device cpu" in capsys.readouterr().err
    assert main(["replay", "--log", str(p), "--kernel", "hybridx",
                 "--device", "cpu"]) == 0
    assert "replayed 4 frames" in capsys.readouterr().out


@pytest.mark.parametrize("strict", [True, False])
def test_scanlog_reader_equals_jax(tmp_path, strict):
    log = synth_room_scanlog(n_frames=7, seed=5, noise_mm=5.0)
    p = tmp_path / "f.bin"
    jscanlog.write_scanlog(str(p), log)
    data = p.read_bytes()
    if not strict:
        data += b"\0" * 100                   # a trailing partial record
    want = jscanlog.read_scanlog(data, strict=strict)
    got = tscanlog.read_scanlog(data, strict=strict)
    assert len(got) == len(want) == 7
    a, b = port.scanlog_to_arrays(got), port.scanlog_to_arrays(want)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _frames(**synth):
    """One synthetic flight as a [1, T] batch of CPU tensors."""
    log = synth_room_scanlog(**synth)
    return port.frames_to_torch(
        {k: v[None] for k, v in port.scanlog_to_arrays(log).items()}, "cpu")


UNSUPPORTED = {
    "lo_min_above_zero": (MapConfig(lo_min=5), None),
    "lo_max_beyond_int8": (MapConfig(lo_max=200), None),
    "free_dec_beyond_int8": (MapConfig(lo_free_dec=200), None),
    "negative_occ_inc": (MapConfig(lo_occ_inc=-3), None),
    "geometry_of_another_map": (MapConfig(width=400, height=400), None),
    "rays_longer_than_window": (None, TofConfig(max_range_m=6.0)),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_exact_kernel_refuses_unsupported_config(case):
    m, tof = UNSUPPORTED[case]
    cfg = UL_PROFILE.replace(**({"map": m} if m else {}),
                             **({"tof": tof} if tof else {}))
    grids = torch.zeros((1, 608, 640), dtype=torch.int8)
    sched = torch.zeros((1, 2, rx.WORDS), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported configuration"):
        rx.replay_exact(grids, sched, cfg)
    frames = _frames(n_frames=2, seed=0)
    with pytest.raises(ValueError, match="unsupported configuration"):
        port.replay_mapping_batched(frames, cfg, kernel="residentx")


def test_exact_kernel_checks_operands_and_devices():
    sched = torch.zeros((2, 3, rx.WORDS), dtype=torch.int32)
    with pytest.raises(TypeError):
        rx.replay_exact(torch.zeros((2, 608, 640), dtype=torch.int16), sched,
                        UL_PROFILE)
    with pytest.raises(ValueError, match="shapes"):
        rx.replay_exact(torch.zeros((3, 608, 640), dtype=torch.int8), sched,
                        UL_PROFILE)
    with pytest.raises(ValueError, match="contiguous"):
        rx.replay_exact(torch.zeros((2, 640, 608), dtype=torch.int8).mT,
                        sched, UL_PROFILE)
    # neither CPU nor CUDA: no kernel and no plain fallback
    meta = torch.zeros((2, 608, 640), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no exact replay kernel"):
        rx.replay_exact(meta, sched.to("meta"), UL_PROFILE)
    before = rx.replay_exact.launches
    rx.replay_exact(torch.zeros((2, 608, 640), dtype=torch.int8), sched,
                    UL_PROFILE)
    assert rx.replay_exact.launches == before      # the CPU path launches none


@pytest.mark.parametrize("case", ["lo_min_above_zero",
                                  "geometry_of_another_map",
                                  "rays_longer_than_window"])
def test_cone_kernel_refuses_unsupported_config(case):
    m, tof = UNSUPPORTED[case]
    cfg = UL_PROFILE.replace(**({"map": m} if m else {}),
                             **({"tof": tof} if tof else {}))
    grids = torch.zeros((1, 608, 640), dtype=torch.int8)
    sched = torch.zeros((1, 2, cx.HYBRID_WORDS), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported configuration"):
        cx.replay_cone(grids, sched, cfg, hybrid=True)
    with pytest.raises(ValueError, match="unsupported configuration"):
        port.replay_mapping_batched(_frames(n_frames=2, seed=0), cfg,
                                    kernel="hybridx")


def test_cone_kernel_checks_operands_and_devices():
    grids = torch.zeros((2, 608, 640), dtype=torch.int8)
    sched = torch.zeros((2, 3, cx.CONE_WORDS), dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes"):
        cx.replay_cone(grids, sched, UL_PROFILE, hybrid=True)
    with pytest.raises(TypeError):
        cx.replay_cone(grids, sched.float(), UL_PROFILE)
    meta = torch.zeros((2, 608, 640), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no cone replay kernel"):
        cx.replay_cone(meta, sched.to("meta"), UL_PROFILE)
    before = cx.replay_cone.launches
    cx.replay_cone(grids, sched, UL_PROFILE)
    assert cx.replay_cone.launches == before       # the CPU path launches none


@pytest.mark.parametrize("kernel", ["resident", "pallas", "pallas_db", "mxu",
                                    "mxu2"])
def test_exact_kernel_aliases_run_the_exact_replay(kernel):
    """Every exact kernel name gives the per-frame plain path's grids: the
    whole-replay names through replay_exact, "pallas" and "pallas_db"
    frame by frame through map_step (their plain versions on the CPU)."""
    frames = _frames(n_frames=4, seed=2)
    want, _ = port.replay_mapping_batched(frames, UL_PROFILE, kernel="xla")
    got, _ = port.replay_mapping_batched(frames, UL_PROFILE, kernel=kernel)
    assert torch.equal(got.grid, want.grid)
    with pytest.raises(ValueError, match="unknown kernel"):
        port.replay_mapping_batched(frames, UL_PROFILE, kernel="nope")
