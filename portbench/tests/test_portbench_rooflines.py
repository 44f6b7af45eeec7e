"""The per-layer metrics' arithmetic on inputs counted by hand: the work
counts of the three rooflines on a 2-flight job, and the trace reading
(busy time, idle share, launches, idle time by host activity) on a
synthetic trace."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import devtrace
from portbench.metrics import work
from portbench.reference import config as RC

PKG = Path(__file__).resolve().parents[1]
NO_TARGET = 0xFFFF


def _job():
    """2 flights, 1 frame each, pose (0, 0), yaw 0, the map's origin there.
    Flight 0: the front sensor's columns 3 and 4 at 1.000 m (rays to cells
    (+10, -1) and (+10, +1): 11 cells each, rows 297..299 of one column
    sector).  Flight 1: the right sensor's column 0 at 2.000 m (bearing
    58.5 deg, a ray to (+10, +17): 18 cells, 18 rows of one sector).
    Every other zone reads no target."""
    g = np.full((2, 1, 4, 8, 8), NO_TARGET, np.int32)
    g[0, 0, 0, :, 3] = 1000
    g[0, 0, 0, :, 4] = 1000
    g[1, 0, 1, :, 0] = 2000
    z = lambda v, dt: torch.full((2, 1), v, dtype=dt)                 # noqa: E731
    return {"grid_mm": torch.from_numpy(g), "x_m": z(0.0, torch.float32),
            "y_m": z(0.0, torch.float32), "yaw_deg": z(0.0, torch.float32),
            "of_q": z(0, torch.int32), "of_rate_x": z(math.nan, torch.float32),
            "of_rate_y": z(math.nan, torch.float32),
            "sys_health": z(0, torch.int64), "state": z(5, torch.int32),
            "scan_ms": z(0, torch.int64), "rf_m": z(0.5, torch.float32)}


CFG = RC.load({"slam": {"loop_refine_early": 1, "gn_refine_iters": 2,
                        "match_iters_later": 1}})


def test_exact_count_by_hand():
    w = work.exact(_job(), CFG)
    assert (w["cells"], w["rays"]) == (40, 3)
    assert w["int_ops"] == 40 * work.EXACT_CELL_INT_OPS \
        + 3 * work.EXACT_RAY_INT_OPS
    # 2 logged frames, 3 + 18 sectors each read and written once
    assert w["bytes"] == 2 * (4 * 8 * 8 * 2 + 12) + 2 * 32 * 21


def test_hybrid_count_by_hand():
    """The carve: each column with a return carves the fan sector of
    63/8 degrees to its eroded range less 5 cm, in cells: columns 3 and 4
    of flight 0 to 9.5 cells, column 0 of flight 1 to 19.5 cells."""
    w = work.hybrid(_job(), CFG)
    theta = math.radians(63.0 / 8)
    carve = 0.5 * theta * (2 * 9.5 ** 2 + 19.5 ** 2)
    assert w["cells"] == pytest.approx(carve, rel=1e-6)
    assert w["rays"] == 3
    assert w["int_ops"] == pytest.approx(
        carve * work.CARVE_CELL_INT_OPS + 3 * work.EXACT_CELL_INT_OPS)
    assert w["fp_ops"] == pytest.approx(carve * work.CARVE_CELL_FP_OPS)


def test_lattice_count_by_hand():
    """UL_PROFILE's SLAM matches each keyframe in 4 pass-1 rounds on the
    7 x 7 x 7 lattice and in 8 loop stages against 3 candidates on the
    5 x 5 x 5 one; the job's 2 keyframes hit with 2 and 1 beams."""
    w = work.lattice(_job(), CFG)
    look = 4 * 3 * 343 + 8 * 3 * 3 * 125
    assert w["lookups"] == look and w["launches"] == 12
    assert w["int_ops"] == look * work.LOOKUP_INT_OPS
    assert w["bytes"] > 0


def test_least_seconds_takes_the_larger_bound():
    p = work.PEAKS
    assert work.least_seconds({"int_ops": p["int32_ops_per_s"], "fp_ops": 0,
                               "bytes": 0}) == pytest.approx(1.0)
    assert work.least_seconds({"int_ops": 0, "fp_ops": 0,
                               "bytes": 2 * p["hbm_bytes_per_s"]}) \
        == pytest.approx(2.0)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "m", PKG / "metrics" / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_trace_summary_on_a_synthetic_trace():
    """Kernels on [0, 10], [5, 20] and [30, 40] us and a copy on [60, 70]
    us: 40 us busy of a 100 us window.  The host: an op over [15, 35] and
    launches inside it; the gap [20, 30] is the op's, [40, 60] and
    [70, 100] nobody's."""
    evs = [_ev("kernel", "k_a", 0, 10), _ev("kernel", "k_a", 5, 15),
           _ev("kernel", "k_b", 30, 10), _ev("gpu_memcpy", "Memcpy HtoD", 60, 10),
           _ev("cpu_op", "aten::foo", 15, 20),
           _ev("cuda_runtime", "cudaLaunchKernel", 16, 2),
           _ev("cuda_runtime", "cuLaunchKernel", 19, 1),
           _ev("cuda_runtime", "cudaMemcpyAsync", 32, 1),
           _ev("cpu_op", "aten::bar", 99, 1)]
    s = devtrace.summarize(evs, 100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["launches"] == 2
    assert devtrace.kernel_seconds(s, "k_a") == pytest.approx(25e-6)
    idle = dict(s["idle_gaps"])
    assert idle["aten::foo"] == pytest.approx(10e-6)
    assert idle["(host between ops)"] == pytest.approx(50e-6)

    class Ctx:
        trace = s
        frames = 4

    assert _load("device.idle_share").read(Ctx) == pytest.approx(60.0)
    assert _load("host.launches_per_frame").read(Ctx) == pytest.approx(0.5)
    # a kernel absent from the trace reads nothing, never 0
    Ctx.work = staticmethod(lambda kind: {"int_ops": 1, "fp_ops": 0,
                                          "bytes": 0})
    assert _load("replay_exact_roofline").read(Ctx) is None


def test_roofline_reader_divides_least_time_by_kernel_time():
    evs = [_ev("kernel", "void replay_exact_kernel<false>(int)", 0, 100)]
    s = devtrace.summarize(evs, 200e-6)

    class Ctx:
        trace = s
        frames = 1

        @staticmethod
        def work(kind):
            return {"int_ops": 25e-6 * work.PEAKS["int32_ops_per_s"],
                    "fp_ops": 0, "bytes": 0}

    assert _load("replay_exact_roofline").read(Ctx) == pytest.approx(25.0)
