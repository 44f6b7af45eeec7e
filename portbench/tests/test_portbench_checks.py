"""The comparison that decides `correct`, driven through the harness on
the CPU at a small size (the test hook `run_cell(device="cpu",
sizes=...)`, which skips the look for a card): the program agrees with
the reference; the control (the reference in bfloat16) and each fault a
cell can have come out not correct; no run loads JAX or the JAX
package; the reference imports nothing of the program; without a card
the command refuses to run.  The `cuda` tests repeat the control at the
cells' own sizes on the card."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
SMALL = {"ul_map.exact.rooms": {"batch": 64, "frames": 40, "jobs": 2},
         "ul_map.hybrid.rooms": {"batch": 64, "frames": 40, "jobs": 2},
         "ul_slam.loops": {"batch": 32, "frames": 48, "jobs": 2}}
CELLS = sorted(SMALL)


def _run(cell, seed=2 ** 31 + 17, run_job=None, control=False):
    return harness.run_cell(cell, seed, 0.0, False, "cpu", time.perf_counter(),
                            sizes=SMALL[cell], run_job=run_job,
                            control=control)


def _entry(cell):
    wl = harness.cell(cell).work
    return harness.load_module(PKG / "entries" / f"{wl['entry']}.py"), wl


def _program(cell):
    c = harness.cell(cell)
    return harness.program_config(c.conf)


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_reference(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = _run(cell, control=True)
    assert not r["correct"], r["checks"]


def _broken(cell, fault):
    """The cell's program call with `fault` planted in what it returns."""
    entry, wl = _entry(cell)
    prog = _program(cell)

    def job(frames):
        B = frames["x_m"].shape[0]
        if fault == "half":
            # half of the batch left out: the rest replayed alone
            half = {k: v[: B // 2] for k, v in frames.items()}
            res = entry.run(half, prog, wl)
            full = entry.run(frames, prog, wl)
            out = entry.outputs(full)
            part = entry.outputs(res)
            for k, v in out.items():
                v[B // 2:] = 0 if v.dtype != torch.bool else False
                v[: B // 2] = part[k]
            return full
        res = entry.run(frames, prog, wl)
        out = entry.outputs(res)
        if fault == "unchanged":
            # the step hands back the state it was given: empty maps
            out["grid"].zero_()
        elif fault == "altered":
            # one answer altered where it is produced: one cell of one map
            g = out["grid"]
            g[1, g.shape[1] // 2, g.shape[2] // 2] += 1
        return res

    return job


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    """A one-card cell has no exchange between chips to leave out; each
    other fault of the list is planted under the timed path."""
    r = _run(cell, run_job=_broken(cell, fault))
    assert not r["correct"], (fault, r["checks"])


def test_no_jax_after_a_job():
    """A tiny ul_map.exact.rooms job on the CPU through the test hook, in
    a fresh process: afterwards no module whose top-level name is jax,
    jaxlib, flax or micro_quad_slam_tpu is loaded."""
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "r = harness.run_cell('ul_map.exact.rooms', 5, 0.0, False, 'cpu',"
            " time.perf_counter(), sizes={'batch': 64, 'frames': 8, 'jobs': 2})\n"
            "print(r['correct'], harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={**os.environ,
                                                      "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module:
            yield n.module


def test_reference_and_yardstick_import_nothing_of_the_program():
    """The reference, the generator, the work counts and the trace reading
    import neither the program nor JAX nor the JAX package (top-level
    names compared whole)."""
    bad = {"jax", "jaxlib", "flax", "micro_quad_slam_tpu",
           "micro_quad_slam_tpu_torch"}
    files = [*(PKG / "reference").glob("*.py"), *(PKG / "gen").glob("*.py"),
             *(PKG / "metrics").glob("*.py"), *(PKG / "e2e").glob("*.py"),
             PKG / "devtrace.py"]
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in bad, (f.name, mod)


def test_no_program_imports_jax_either():
    """Nothing the harness itself imports names JAX."""
    bad = {"jax", "jaxlib", "flax", "micro_quad_slam_tpu"}
    for f in PKG.rglob("*.py"):
        if "tests" in f.parts:
            continue
        for mod in _imports(f):
            assert mod.split(".")[0] not in bad, (f.name, mod)


def test_command_refuses_without_a_card(tmp_path):
    """No CUDA device: exit code other than 0 and no result line; the same
    in a directory holding only BENCHMARK.json and portbench/."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command runs")
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "ul_map.exact.rooms", "--seed", "1", "--seconds", "1", "--trace",
           "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (101, 102, 103):
        r = harness.run_cell(cell, seed, 0.0, False, "cuda",
                             time.perf_counter(), control=True)
        assert not r["correct"], json.dumps(r["checks"])
