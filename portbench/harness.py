"""The port's benchmark: one run of one cell.

A cell (BENCHMARK.json `workloads`) names a configuration (its file under
configs/), a traffic mix (traffic/) and its workload file (workloads/),
which names the entry (entries/) that calls the program, the program's
path, the number of distinct job batches, how many jobs are compared and
the limit of each compared number.  End-to-end metrics are read by
e2e/<name>.py, per-layer metrics by metrics/<name>.py, each found by its
name in BENCHMARK.json.

A run:
  1. set-up (setup_s): torch, the program's kernels built or loaded
     (ops/_build.py, cached in build/ inside the checkout), the traffic
     made from --seed (gen/flights.py) and put on the card, one warm-up
     job;
  2. the window: one caller runs jobs back to back for --seconds, each a
     call of the cell's entry on the next job batch (the batches cycle,
     so no batch runs twice in a row), each ended by a synchronize; with
     --trace 1 the window is the workload's `trace_jobs` jobs under
     torch.profiler instead;
  3. the comparison: the jobs at positions drawn from the seed are
     replayed by the plain reference (reference/) once the window has
     closed, the peak memory has been read and the program's other state
     is freed; each compared number is printed beside its limit.
The last line of standard output is the result as one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "micro_quad_slam_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark found by file name (names may hold
    dots, so not by import)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: dict          # the configuration file
    traffic: dict       # the traffic file
    work: dict          # the workload file
    e2e: list           # end-to-end metric names
    per_layer: list     # per-layer metric names


def cell(name: str, manifest: Path = ROOT / "BENCHMARK.json") -> Cell:
    man = load_json(manifest)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"error: no cell {name!r} in {manifest.name}; "
                         f"cells: {sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in man["configs"]}
    e2e = [m["name"] for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = set(e2e)
    per_layer = [m["name"] for m in man["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    return Cell(name, int(w["chips"]), load_json(ROOT / confs[w["config"]]["file"]),
                load_json(PKG / "traffic" / f"{w['traffic']}.json"),
                load_json(PKG / "workloads" / f"{name}.json"), e2e, per_layer)


@dataclasses.dataclass
class Program:
    cfg: object
    geom: object


def program_config(conf: dict) -> Program:
    """The program's PipelineConfig and GridGeom as the configuration
    file states them: its profile with every group the file gives
    replaced key by key."""
    from micro_quad_slam_tpu_torch.ops.raycast import GridGeom
    from micro_quad_slam_tpu_torch.utils import config as pc

    base = getattr(pc, conf["profile"])
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v  # noqa: E731
                     for k, v in d.items()}
    cfg = base.replace(**{g: dataclasses.replace(getattr(base, g),
                                                 **tup(conf[g]))
                          for g in ("map", "tof", "gates", "ekf", "slam")
                          if g in conf})
    return Program(cfg, GridGeom(**conf["geom"]))


def to_device(arrays: dict, keys, device) -> dict:
    """numpy arrays -> tensors as the port takes them: integers narrower
    than 32 bits and int32 as int32, wider ones as int64, floats as
    float32."""
    import torch

    out = {}
    for k in keys:
        a = np.asarray(arrays[k])
        if a.dtype.kind in "ui":
            a = a.astype(np.int32 if a.dtype.itemsize < 4 or a.dtype == np.int32
                         else np.int64)
        elif a.dtype.kind == "f":
            a = a.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def make_batches(c: Cell, seed: int, device, entry, B: int, T: int, J: int):
    """The cell's J job batches on `device` (every pool flight B / P
    times in each, under its own pose jitter), and for each batch the
    true walls of its flight f, walls[j](f) (segments)."""
    import torch

    from portbench.gen import flights

    pool = flights.make_pool(c.traffic, T, c.conf["tof"], seed)
    jobs = flights.make_jobs(pool, c.traffic, B, J, seed)
    poses = ("x_m", "y_m", "yaw_deg")
    pool_t = to_device(pool, [k for k in entry.FRAME_KEYS if k not in poses],
                       device)
    batches = []
    for j in jobs:
        idx = torch.from_numpy(j["idx"]).to(device)
        b = {k: v[idx] for k, v in pool_t.items()}
        x, y, yaw = flights.jitter_poses(pool["x_m"][j["idx"]],
                                         pool["y_m"][j["idx"]],
                                         pool["yaw_deg"][j["idx"]], j)
        b.update(to_device({"x_m": x, "y_m": y, "yaw_deg": yaw}, poses,
                           device))
        batches.append(b)
    walls = [lambda f, j=j: flights.walls(pool, j, f) for j in jobs]
    return batches, walls


@dataclasses.dataclass
class Window:
    frames_done: int = 0
    window_s: float = 0.0
    job_seconds: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    setup_s: float = 0.0


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _card_line() -> str:
    """The card's name, power limit and clocks, from nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class TraceCtx:
    """What a per-layer metric reads: the trace's summary, the frames the
    traced window replayed, and the work its jobs' inputs require."""

    def __init__(self, trace, batches, positions, rcfg, B, T):
        self.trace = trace
        self.frames = len(positions) * B * T
        self._batches, self._pos, self._rcfg = batches, positions, rcfg
        self._cache = {}

    def work(self, kind: str) -> dict:
        if kind not in self._cache:
            from portbench.metrics import work

            per = {}
            tot = {"int_ops": 0, "fp_ops": 0, "bytes": 0}
            for p in self._pos:
                j = p % len(self._batches)
                if j not in per:
                    per[j] = work.KINDS[kind](self._batches[j], self._rcfg)
                for k in tot:
                    tot[k] += per[j][k]
            self._cache[kind] = tot
        return self._cache[kind]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, sizes: dict | None = None, run_job=None,
             control: bool = False) -> dict:
    """One run of a cell; returns the result object.  `sizes` ({batch,
    frames, jobs}) and `run_job` (in place of the entry's program call)
    are for the tests; `control` puts the reference at the precision
    below the configuration's in the program's place (no timing)."""
    import torch

    from portbench.reference import config as rconf

    c = cell(name)
    wl = c.work
    entry = load_module(PKG / "entries" / f"{wl['entry']}.py")
    sizes = sizes or {}
    B = int(sizes.get("batch", c.conf["batch"]))
    T = int(sizes.get("frames", c.conf["frames"]))
    J = int(sizes.get("jobs", wl["jobs"]))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prog = program_config(c.conf)
    rcfg = rconf.load(c.conf)
    if dev.type == "cuda":
        from micro_quad_slam_tpu_torch.ops import _build

        built = _build.build_all(wl["kernels"])
        _log("# build " + ", ".join(f"{k} {v['seconds']:.2f} s"
                                    for k, v in built.items()))
    batches, walls = make_batches(c, seed, dev, entry, B, T, J)
    job = run_job or (lambda fr: entry.run(fr, prog, wl))
    if control:
        job = lambda fr: entry.reference(fr, rcfg, wl, lowp=True)  # noqa: E731
    rng = np.random.default_rng([seed, 0x636D70])
    slots = min(J, int(wl["trace_jobs"])) if trace else J
    keep = set(int(p) for p in rng.choice(slots, int(wl["compare_jobs"]),
                                          replace=False))
    kept = {}
    if not control:
        job(batches[-1])            # warm-up: every shape of the window
        _sync(dev)
    win = Window(setup_s=time.perf_counter() - t_start)

    def window():
        i, t0 = 0, time.perf_counter()
        end = t0 + seconds
        while True:
            a = time.perf_counter()
            res = job(batches[i % J])
            _sync(dev)
            b = time.perf_counter()
            win.job_seconds.append(b - a)
            if i in keep:
                kept[i] = entry.outputs(res) if not control else res
            del res
            i += 1
            if i <= max(keep):
                continue
            if (trace and i >= int(wl["trace_jobs"])) or \
                    (not trace and b >= end) or control:
                break
        win.window_s = b - t0
        win.frames_done = i * B * T

    tr = None
    if trace:
        from portbench.devtrace import profile_window

        tr = profile_window(window, time.perf_counter)
    else:
        window()
    n_jobs = len(win.job_seconds)
    if dev.type == "cuda":
        win.peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        _log("# card " + _card_line())

    metrics = {}
    if trace:
        ctx = TraceCtx(tr, batches, list(range(n_jobs)), rcfg, B, T)
        for m in c.per_layer:
            v = load_module(PKG / "metrics" / f"{m}.py").read(ctx)
            if v is not None:
                metrics[m] = float(v)
    else:
        for m in c.e2e:
            metrics[m] = float(load_module(PKG / "e2e" / f"{m}.py").read(win))

    # the comparison, after the window: the reference judges each kept job
    checks = {}
    wrong = 0
    t_ref = time.perf_counter()
    for p in sorted(kept):
        fr = batches[p % J]
        ref = entry.reference(fr, rcfg, wl)
        got = entry.compare(kept[p], ref)
        _log(f"# job {p} (batch {p % J}): "
             + entry.notes(fr, kept[p], ref, rcfg, walls[p % J]))
        wrong += any(v > wl["limits"][k] for k, v in got.items())
        for k, v in got.items():
            checks[k] = max(checks.get(k, v), v)
        del ref
    correct = bool(kept) and wrong == 0
    _log("# job seconds " + " ".join(f"{v:.3f}" for v in win.job_seconds))
    q = np.percentile(win.job_seconds, [0, 50, 90, 100])
    _log(f"# window {win.window_s:.3f} s, {n_jobs} jobs (s: min {q[0]:.4f} "
         f"median {q[1]:.4f} p90 {q[2]:.4f} max {q[3]:.4f}); reference "
         f"{time.perf_counter() - t_ref:.3f} s for {len(kept)} jobs")
    units = load_json(ROOT / "BENCHMARK.json")
    unit = {m["name"]: m["unit"] for m in units["end_to_end"] + units["per_layer"]}
    result = {
        "correct": correct,
        "attempted": n_jobs,
        "failed": wrong,
        "metrics": {k: {"value": v, "unit": unit[k]} for k, v in metrics.items()},
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(0)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(win.peak_bytes)},
    }
    if trace:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
        _log(f"# trace: launches {tr['launches']}, frames {n_jobs * B * T}, "
             f"device events {tr['n_device_events']}")
    result["checks"] = {k: {"value": v, "limit": wl["limits"][k]}
                        for k, v in checks.items()}
    return result


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(prog="python3 portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch

    chips = cell(a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"error: the cell needs {chips} CUDA device(s), found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             f"; the benchmark measures the card and never falls back to "
             f"the CPU")
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                      t_start)
    bad = forbidden_modules()
    if bad:
        _log(f"error: modules of {bad} are loaded in the benchmark's "
             f"process; the benchmark runs the port alone")
        return 3
    _log(f"correct = {result['correct']}")
    for k, v in result["checks"].items():
        _log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
