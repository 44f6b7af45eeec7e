"""PyTorch port, utils/obs.py: the observability helpers against the JAX
package's on the same seeded inputs: status lines, snapshot lines and
dumps, flight_data.csv and PGM bytes, map divergence and wall IoU dicts;
profile_trace on torch.profiler."""

import io
import json
import re

import numpy as np
import pytest
import torch

from micro_quad_slam_tpu.utils import obs as jobs
from micro_quad_slam_tpu_torch.utils import obs as tobs

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["STATE_NAMES_UL", "STATE_NAMES_CL",
                                  "ALT_SRC_NAMES"])
def test_names_equal(name):
    assert getattr(tobs, name) == getattr(jobs, name)


def _status_args(rng, missing: bool) -> dict:
    f = lambda s: float("nan") if missing else float(np.float32(  # noqa: E731
        rng.normal(0, s)))
    return dict(
        state=int(rng.integers(-1, 11)), want_arm=bool(rng.integers(0, 2)),
        have_hb=bool(rng.integers(0, 2)), mode=int(rng.integers(0, 10)),
        armed=bool(rng.integers(0, 2)), alt_m=f(1),
        alt_src=int(rng.integers(-1, 5)), ceiling=bool(rng.integers(0, 2)),
        landed=None if missing else int(rng.integers(0, 5)),
        z_ok=None if missing else bool(rng.integers(0, 2)),
        xy_ok=True, gyr_ok=False, mot_ok=True,
        xy_stable=bool(rng.integers(0, 2)), lpos_alt=f(1), rf_m=f(1),
        yaw_deg=f(90), yaw_target=None if missing else f(90),
        tof_frbl=tuple(f(2) for _ in range(4)),
        of_q=None if missing else int(rng.integers(0, 256)),
        batt_v=f(8), batt_cells=int(rng.integers(0, 5)),
        mot_avg=None if missing else f(1500),
        map_inited=bool(rng.integers(0, 2)))


@pytest.mark.parametrize("missing", [False, True])
def test_format_status_line_equals_jax(missing):
    rng = np.random.default_rng(int(missing))
    for _ in range(200):
        kw = _status_args(rng, missing)
        names = (jobs.STATE_NAMES_UL, jobs.STATE_NAMES_CL)[int(
            rng.integers(0, 2))]
        assert tobs.format_status_line(**kw, names=names) == \
            jobs.format_status_line(**kw, names=names)


def test_snapshot_lines_and_ring_dump_equal_jax():
    rng = np.random.default_rng(2)
    sinks = {"t": [], "j": []}
    rings = {"t": tobs.SnapshotRing(depth=5, sink=sinks["t"].append),
             "j": jobs.SnapshotRing(depth=5, sink=sinks["j"].append)}
    for i in range(12):
        kw = dict(t_ms=100 * i, state=int(rng.integers(-1, 9)),
                  mode=int(rng.integers(0, 10)), armed=bool(i % 2),
                  alt_est=float(np.float32(rng.normal())),
                  x=float(np.float32(rng.normal())), rf_m=float("nan"),
                  of_q=int(rng.integers(0, 256)), batt_vpc=3.91,
                  mot=(1400 + i, 1401, 1402, 1403))
        t, j = tobs.Snapshot(**kw), jobs.Snapshot(**kw)
        assert t.line() == j.line()
        assert t.line(tobs.STATE_NAMES_UL) == j.line(jobs.STATE_NAMES_UL)
        rings["t"].add(t)
        rings["j"].add(j)
    assert len(rings["t"].dump("test")) == len(rings["j"].dump("test")) == 5
    assert sinks["t"] == sinks["j"]


def test_tee_logger_lines_as_jax(tmp_path):
    out = {}
    for tag, mod in (("t", tobs), ("j", jobs)):
        console = io.StringIO()
        tee = mod.TeeLogger(str(tmp_path / f"{tag}.txt"), console=console,
                            t0=0.0)
        tee.log("hello")
        tee.log("world 2")
        tee.flush()
        tee.close()
        out[tag] = ((tmp_path / f"{tag}.txt").read_text(), console.getvalue())
    assert out["t"][1] == out["j"][1] == "hello\nworld 2\n"
    stamp = r"\[\d+\.\d{3}\] "
    for tag in out:
        assert re.fullmatch(f"{stamp}hello\n{stamp}world 2\n", out[tag][0])


def test_flight_data_writer_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    rows = [(int(rng.integers(0, 10 ** 6)), "HOVER",
             *(float(np.float32(v)) for v in rng.normal(0, 20, 4)),
             tuple(int(v) for v in rng.integers(900, 2100, 4)),
             tuple(float(np.float32(v)) for v in rng.uniform(0, 3, 3)),
             tuple(int(v) for v in rng.integers(0, 9000, 4)))
            for _ in range(120)]
    for tag, mod in (("t", tobs), ("j", jobs)):
        w = mod.FlightDataWriter(str(tmp_path / f"{tag}.csv"), flush_every=7)
        for r in rows:
            w.write_row(*r)
        w.close()
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert tobs.FlightDataWriter.HEADER == jobs.FlightDataWriter.HEADER


def _grids(seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (60, 50)).astype(np.int8)
    a[rng.random(a.shape) < 0.5] = 0
    b = a.copy()
    flip = rng.random(a.shape) < 0.1
    b[flip] = rng.integers(-127, 128, int(flip.sum())).astype(np.int8)
    return a, b


@pytest.mark.parametrize("seed", [4, 5])
def test_map_divergence_equals_jax(seed):
    a, b = _grids(seed)
    for x, y in ((a, b), (a, a), (np.zeros_like(a), np.zeros_like(a))):
        assert tobs.map_divergence(x, y) == jobs.map_divergence(x, y)
    assert tobs.map_divergence(a, b, occ_thresh=40, free_thresh=-40) == \
        jobs.map_divergence(a, b, occ_thresh=40, free_thresh=-40)


def test_map_iou_vs_walls_equals_jax():
    a, _ = _grids(6)
    g = np.zeros((120, 100), np.int8)
    g[10:110, 10] = 50
    g[10, 10:90] = 50
    g[30:50, 20:70] = a[:20, :50]
    for args in ((g, 0.0, 0.0, (-4.0, -5.0, 4.0, 5.0)),
                 (g, 0.3, -0.2, (-4.5, -5.5, 4.0, 5.0), [(1.0, 1.0, 2.0,
                                                          2.0)])):
        assert tobs.map_iou_vs_walls(*args) == jobs.map_iou_vs_walls(*args)


@pytest.mark.parametrize("trinary", [True, False])
def test_save_map_pgm_bytes_equal_jax(tmp_path, trinary):
    a, _ = _grids(7)
    pt, pj = str(tmp_path / "t.pgm"), str(tmp_path / "j.pgm")
    assert tobs.save_map_pgm(pt, a, trinary=trinary) == pt
    jobs.save_map_pgm(pj, a, trinary=trinary)
    data = open(pt, "rb").read()
    assert data == open(pj, "rb").read()
    assert data.startswith(b"P5\n") and len(data) > 60 * 50
    with pytest.raises(ValueError, match="2-D"):
        tobs.save_map_pgm(pt, a[None])


def test_profile_trace_on_torch_profiler(tmp_path):
    with tobs.profile_trace(None):
        pass
    with tobs.profile_trace(str(tmp_path / "prof")):
        torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])
