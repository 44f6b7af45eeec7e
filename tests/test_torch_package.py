"""PyTorch port, package level: the re-declared GridGeom, the jax-free
import, configuration checks of the exact kernel, and the kernel names
that are not ported yet."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from micro_quad_slam_tpu.ops import raycast as jr
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import MapConfig, TofConfig, UL_PROFILE
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch.ops import raycast as tr
from micro_quad_slam_tpu_torch.ops import residentx as rx

torch.set_num_threads(2)


@pytest.mark.parametrize("which", ["default", "from_map_default",
                                   "from_map_fine_rect"])
def test_grid_geom_equals_jax_field_for_field(which):
    cfg = MapConfig(res_m=0.05, width=800, height=600)
    make = {"default": lambda m: m.DEFAULT_GEOM,
            "from_map_default": lambda m: m.GridGeom.from_map(MapConfig()),
            "from_map_fine_rect": lambda m: m.GridGeom.from_map(cfg)}[which]
    j, t = make(jr), make(tr)
    names = [f.name for f in dataclasses.fields(jr.GridGeom)]
    assert names == [f.name for f in dataclasses.fields(tr.GridGeom)]
    assert dataclasses.astuple(j) == dataclasses.astuple(t)


def test_port_imports_and_replays_without_jax(tmp_path):
    """In a fresh interpreter (this process already holds jax: conftest
    imports it), the port imports and replays a short flight on the CPU
    and never imports jax."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import micro_quad_slam_tpu_torch as port
        from micro_quad_slam_tpu.sim import synth_room_scanlog
        from micro_quad_slam_tpu.utils.config import UL_PROFILE
        log = synth_room_scanlog(n_frames=6, seed=1)
        f = {k: v[None] for k, v in port.scanlog_to_arrays(log).items()}
        st, outs = port.replay_mapping_batched(
            port.frames_to_torch(f, "cpu"), UL_PROFILE, kernel="residentx")
        assert bool(outs["used"].all()) and int(st.grid.ne(0).sum()) > 100
        assert "jax" not in sys.modules, sorted(m for m in sys.modules
                                                if m.startswith("jax"))
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": ":".join(sys.path)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


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


@pytest.mark.parametrize("kernel", ["cone", "conex", "hybrid", "hybridx",
                                    "resident_cone"])
def test_cone_kernels_are_not_ported_yet(kernel):
    frames = _frames(n_frames=2, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        port.replay_mapping_batched(frames, UL_PROFILE, kernel=kernel)


@pytest.mark.parametrize("kernel", ["resident", "pallas", "pallas_db", "mxu",
                                    "mxu2"])
def test_exact_kernel_aliases_run_the_exact_replay(kernel):
    frames = _frames(n_frames=4, seed=2)
    want, _ = port.replay_mapping_batched(frames, UL_PROFILE, kernel="xla")
    got, _ = port.replay_mapping_batched(frames, UL_PROFILE, kernel=kernel)
    assert torch.equal(got.grid, want.grid)
    with pytest.raises(ValueError, match="unknown kernel"):
        port.replay_mapping_batched(frames, UL_PROFILE, kernel="nope")
