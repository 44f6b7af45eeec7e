"""Reading a torch.profiler trace of the traced window: device busy time
(the union of kernel, copy and set intervals), device time by kernel
name, kernel launches counted on the host, and the device's idle time
by what the host was doing.

`summarize(events, window_s)` takes the chrome trace's event list;
`profile_window(run)` records one and returns its summary.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "runtime", "driver"}
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel")


def _intervals(evs):
    """[(start, end)] in microseconds of 'X' events, sorted by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                  for e in evs)


def union(iv):
    """Merged disjoint intervals of sorted intervals."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_by_host(busy, host_evs, lo: float, hi: float):
    """Seconds of device idle time inside [lo, hi], each gap put to the
    innermost host event that spans the gap's middle (the one of those
    that started last), or to "(host between ops)"."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    hs = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                  e["name"]) for e in host_evs), key=lambda h: h[0])
    starts = np.array([h[0] for h in hs]) if hs else np.zeros(0)
    out = defaultdict(float)
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        name = "(host between ops)"
        k = int(np.searchsorted(starts, mid, side="right")) - 1
        for j in range(k, max(k - 64, -1), -1):
            if hs[j][1] >= mid:
                name = hs[j][2]
                break
        out[name] += (g1 - g0) * 1e-6
    return out


def summarize(events: list, window_s: float) -> dict:
    """The traced window's numbers: busy_s, window_s, launches, kernel
    device seconds by name (`kernel_s`), the device ops and the idle
    time by host activity, each the 10 largest as [name, seconds]."""
    dev = [e for e in events if e.get("ph") == "X"
           and str(e.get("cat", "")).lower() in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in HOST_CATS]
    busy = union(_intervals(dev))
    busy_s = sum(e - s for s, e in busy) * 1e-6
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e.get("dur", 0.0)) * 1e-6
    launches = sum(1 for e in host if e["name"].startswith(LAUNCH_NAMES))
    span = _intervals(dev + host)
    lo = span[0][0] if span else 0.0
    hi = max((e for _, e in span), default=0.0)
    idle = idle_by_host(busy, host, lo, hi)
    top = lambda d: [[k[:160], v] for k, v in sorted(                # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_s, "window_s": window_s, "launches": launches,
            "kernel_s": dict(by_name), "device_ops": top(by_name),
            "idle_gaps": top(idle), "n_device_events": len(dev)}


def kernel_seconds(summary: dict, fragment: str) -> float:
    """Device seconds of every kernel whose name holds `fragment`."""
    return sum(v for k, v in summary["kernel_s"].items() if fragment in k)


def profile_window(run, clock) -> dict:
    """Run `run()` under torch.profiler (CPU and CUDA activity) and return
    the summary of its trace; the trace file lives in the temporary
    directory until it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, record_shapes=False, with_stack=False) as prof:
        t0 = clock()
        run()
        torch.cuda.synchronize()
        window_s = clock() - t0
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    del prof
    return summarize(events, window_s)
