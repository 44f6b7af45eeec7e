"""The benchmark's one traffic generator: indoor room flights as logged
scanrecs, made from a traffic file's parameters and a seed.

A frozen, vectorised numpy rendition of the port's
`sim/synthio.py::synth_room_scanlog` (the same room geometry, fan angles,
millimetre quantisation, saturation and flow model) with what a fleet's
logs add to it: room sizes, obstacles, paths, radii and yaw rates drawn
from the seed, `line` flights down a corridor long enough to recenter the
map, and a flow-scale drift per flight as the SLAM tests apply it
(`tests/test_torch_slam.py::_fig8`).  It draws from its own generator in
its own order, so its logs are not synthio's byte for byte.

`make_pool` makes the pool of distinct flights.  `make_jobs` makes the
job batches from it: every batch holds each pool flight B / P times, in a
seeded order, each copy moved by its own rigid pose jitter (a rotation
about the start and a translation: the frames stay consistent with the
pose, unlike bench.py's yaw-only jitter).  So every seed replays the
same mix of path kinds, and only the order, the rooms and the jitters
change with it.
"""

from __future__ import annotations

import math

import numpy as np

ST_HOVER = 5          # the hover state byte (uav_local_nav.c:484-496)
NO_TARGET = 0xFFFF    # the sensor's no-target code
DIR_CENTER_DEG = (0.0, 90.0, 180.0, -90.0)


def _kinds(traffic: dict, n: int) -> list:
    """The path kind of each pool flight: the traffic's weights turned into
    whole counts (largest remainders), the same for every seed."""
    names = sorted(traffic["paths"])
    w = np.array([traffic["paths"][k] for k in names], np.float64)
    raw = w / w.sum() * n
    cnt = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - cnt), kind="stable")[: n - cnt.sum()]:
        cnt[i] += 1
    return [k for k, c in zip(names, cnt) for _ in range(c)]


def _uniform(rng, lohi, size=None):
    lo, hi = lohi
    return rng.uniform(lo, hi, size)


def _path(kind: str, T: int, p: dict):
    """Poses (x, y, yaw_deg) float32 [T] of one flight of `kind`."""
    if kind == "circle":
        phi = np.linspace(0.0, 2 * math.pi * p["turns"], T)
        xs = p["radius"] * np.cos(phi)
        ys = p["radius"] * np.sin(phi)
        yaws = np.degrees(phi) + 90.0
    elif kind == "fig8":
        phi = np.linspace(0.0, 2 * math.pi * p["turns"], T)
        xs = p["radius"] * np.sin(phi)
        ys = 0.6 * p["radius"] * np.sin(2 * phi)
        yaws = np.degrees(np.arctan2(np.gradient(ys), np.gradient(xs)))
    elif kind == "hover":
        xs = np.zeros(T)
        ys = np.zeros(T)
        yaws = np.arange(T) * p["yaw_rate_dps"] * p["dt_s"]
    elif kind == "line":
        xs = np.linspace(0.0, p["length"], T)
        ys = np.zeros(T)
        yaws = np.zeros(T)
    else:
        raise ValueError(f"unknown path {kind!r}")
    yaws = (yaws + 180.0) % 360.0 - 180.0
    return xs.astype(np.float32), ys.astype(np.float32), yaws.astype(np.float32)


def _room_and_obstacles(kind: str, xs, ys, p: dict, rng, traffic: dict):
    """An axis-aligned room around the path (a corridor for `line`) and
    0..n box obstacles clear of the path by a margin."""
    margin = traffic["wall_margin_m"]
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    if kind == "line":
        w = p["side"]
        room = (x0 - 2.0, -w / 2, x1 + 2.0, w / 2)
    else:
        side = max(p["side"], x1 - x0 + 2 * margin, y1 - y0 + 2 * margin)
        cx = _uniform(rng, (x1 - side / 2 + margin, x0 + side / 2 - margin))
        cy = _uniform(rng, (y1 - side / 2 + margin, y0 + side / 2 - margin))
        room = (cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2)
    obstacles = []
    lo, hi = traffic["obstacles"]
    for _ in range(int(rng.integers(lo, hi + 1))):
        for _try in range(20):
            bw, bh = _uniform(rng, traffic["obstacle_side_m"], 2)
            bx = _uniform(rng, (room[0] + 0.2, room[2] - 0.2 - bw))
            by = _uniform(rng, (room[1] + 0.2, room[3] - 0.2 - bh))
            box = (bx, by, bx + bw, by + bh)
            clear = np.hypot(np.clip(xs, box[0], box[2]) - xs,
                             np.clip(ys, box[1], box[3]) - ys).min()
            if clear > margin:
                obstacles.append(box)
                break
    return room, obstacles


def tof_distance(x, y, ang, room, obstacles):
    """Exact distance from (x, y) along ang (radians) to the nearest wall
    of the room or face of an obstacle; x, y broadcast against ang."""
    c, s = np.cos(ang), np.sin(ang)
    big = np.inf
    with np.errstate(divide="ignore", invalid="ignore"):
        tx = np.where(c > 1e-12, (room[2] - x) / c,
                      np.where(c < -1e-12, (room[0] - x) / c, big))
        ty = np.where(s > 1e-12, (room[3] - y) / s,
                      np.where(s < -1e-12, (room[1] - y) / s, big))
        best = np.minimum(np.where(tx > 0, tx, big), np.where(ty > 0, ty, big))
        for bx0, by0, bx1, by1 in obstacles:
            tmin = np.zeros_like(best)
            tmax = np.full_like(best, big)
            miss = np.zeros(best.shape, bool)
            for lo, hi, o, d in ((bx0, bx1, x, c), (by0, by1, y, s)):
                flat = np.abs(d) < 1e-12
                miss |= flat & ((o < lo) | (o > hi))
                t0 = np.where(flat, -big, (lo - o) / np.where(flat, 1, d))
                t1 = np.where(flat, big, (hi - o) / np.where(flat, 1, d))
                tmin = np.maximum(tmin, np.minimum(t0, t1))
                tmax = np.minimum(tmax, np.maximum(t0, t1))
            hit = ~miss & (tmin <= tmax) & (tmin > 0)
            best = np.minimum(best, np.where(hit, tmin, big))
    return best


def make_flight(kind: str, T: int, rng, traffic: dict, tof: dict) -> dict:
    """One logged flight: the scanlog's fields (and the fusion replay's,
    with flow) as numpy arrays [T, ...]."""
    dt_ms = int(traffic["dt_ms"])
    p = {"turns": _uniform(rng, traffic["turns"]),
         "radius": _uniform(rng, traffic["radius_m"]),
         "yaw_rate_dps": _uniform(rng, traffic["yaw_rate_dps"]),
         "length": _uniform(rng, traffic["line_length_m"]),
         "side": _uniform(rng, traffic["room_side_m"]),
         "dt_s": dt_ms * 1e-3}
    xs, ys, yaws = _path(kind, T, p)
    room, obstacles = _room_and_obstacles(kind, xs, ys, p, rng, traffic)

    half_fov = tof["fov_deg"] * 0.5
    u = (np.arange(8) - 3.5) / 3.5
    ang = np.radians(yaws.astype(np.float64)[:, None, None]
                     + np.asarray(DIR_CENTER_DEG)[None, :, None]
                     + (u * half_fov)[None, None, :])            # [T, 4, 8]
    dist = tof_distance(xs.astype(np.float64)[:, None, None],
                        ys.astype(np.float64)[:, None, None], ang, room,
                        obstacles)
    mm = np.broadcast_to((dist * 1000.0)[:, :, None, :], (T, 4, 8, 8))
    if traffic["noise_mm"] > 0:
        mm = mm + rng.normal(0.0, traffic["noise_mm"], mm.shape)
    grid = np.where(mm > 60000, NO_TARGET,
                    np.maximum(1, np.round(np.minimum(mm, 60000)))
                    ).astype(np.uint16)
    if traffic["dropout_p"] > 0:
        grid[rng.random(grid.shape) < traffic["dropout_p"]] = NO_TARGET

    alt = np.float32(0.5)
    if traffic["flow"]:
        drift = 1.0 + _uniform(rng, traffic["flow_drift"])
        vx = np.gradient(xs.astype(np.float64), p["dt_s"])
        vy = np.gradient(ys.astype(np.float64), p["dt_s"])
        yr = np.radians(yaws.astype(np.float64))
        of_rx = ((np.cos(yr) * vx + np.sin(yr) * vy) / alt * drift)
        of_ry = ((-np.sin(yr) * vx + np.cos(yr) * vy) / alt * drift)
        of_rx, of_ry = of_rx.astype(np.float32), of_ry.astype(np.float32)
        of_q = np.full(T, 90, np.uint8)
    else:
        drift = 1.0
        of_rx = np.full(T, np.nan, np.float32)
        of_ry = np.full(T, np.nan, np.float32)
        of_q = np.zeros(T, np.uint8)
    t_ms = (np.arange(T, dtype=np.int64) * dt_ms)
    return {"grid_mm": grid, "x_m": xs, "y_m": ys, "yaw_deg": yaws,
            "of_q": of_q, "of_rate_x": of_rx, "of_rate_y": of_ry,
            "sys_health": np.zeros(T, np.uint32),
            "state": np.full(T, ST_HOVER, np.uint8),
            "scan_ms": t_ms, "rf_m": np.full(T, alt, np.float32),
            "_room": np.asarray(room, np.float64),
            "_obstacles": np.asarray(
                obstacles + [(np.nan,) * 4] * (traffic["obstacles"][1]
                                               - len(obstacles)),
                np.float64).reshape(-1, 4),
            "_drift": drift}


def make_pool(traffic: dict, T: int, tof: dict, seed: int) -> dict:
    """The traffic's pool of distinct flights: dict of [P, T, ...] arrays,
    plus `kind` [P], the rooms `_room` [P, 4], the obstacles
    `_obstacles` [P, n, 4] (NaN rows: none) and the drifts `_drift`."""
    rng = np.random.default_rng([seed, 0x706F6F6C])
    kinds = _kinds(traffic, int(traffic["pool"]))
    order = rng.permutation(len(kinds))
    flights = [make_flight(kinds[i], T, rng, traffic, tof) for i in order]
    pool = {k: np.stack([f[k] for f in flights]) for k in flights[0]}
    pool["kind"] = np.array([kinds[i] for i in order])
    return pool


def make_jobs(pool: dict, traffic: dict, B: int, J: int, seed: int) -> list:
    """J job batches of B flights: each pool flight B / P times per batch
    in a seeded order, each copy under its own rigid pose jitter.  Returns
    a list of J dicts {"idx": pool index [B], "dx", "dy" [B] (m), "rot"
    [B] (deg)}; `jitter_poses` applies one to the pool's poses."""
    P = len(pool["kind"])
    if B % P:
        raise ValueError(f"a batch of {B} does not hold the pool of {P} "
                         f"flights a whole number of times")
    rng = np.random.default_rng([seed, 0x6A6F6273])
    jit = traffic["jitter"]
    jobs = []
    for _ in range(J):
        idx = rng.permutation(np.repeat(np.arange(P), B // P))
        jobs.append({"idx": idx,
                     "dx": rng.normal(0.0, jit["xy_m"], B).astype(np.float32),
                     "dy": rng.normal(0.0, jit["xy_m"], B).astype(np.float32),
                     "rot": rng.uniform(-jit["rot_deg"], jit["rot_deg"],
                                        B).astype(np.float32)})
    return jobs


def jitter_poses(x, y, yaw_deg, job: dict):
    """A job's rigid jitter on poses [B, T] (float32): rotate by rot about
    the flight's first pose, then translate by (dx, dy)."""
    r = np.radians(job["rot"].astype(np.float64))[:, None]
    x0, y0 = x[:, :1].astype(np.float64), y[:, :1].astype(np.float64)
    ux, uy = x - x0, y - y0
    nx = x0 + np.cos(r) * ux - np.sin(r) * uy + job["dx"][:, None]
    ny = y0 + np.sin(r) * ux + np.cos(r) * uy + job["dy"][:, None]
    nyaw = (yaw_deg + job["rot"][:, None] + 180.0) % 360.0 - 180.0
    return (nx.astype(np.float32), ny.astype(np.float32),
            nyaw.astype(np.float32))


def walls(pool: dict, job: dict, b: int) -> list:
    """The true walls of flight b of a job batch, in the job's jittered
    frame: the room's and the obstacles' sides as segments."""
    from portbench.reference.accuracy import rect_segments

    i = job["idx"][b]
    x0, y0 = float(pool["x_m"][i, 0]), float(pool["y_m"][i, 0])
    boxes = [pool["_room"][i]] + [o for o in pool["_obstacles"][i]
                                  if np.isfinite(o).all()]
    return [sg for box in boxes for sg in rect_segments(
        box, x0, y0, float(job["rot"][b]), float(job["dx"][b]),
        float(job["dy"][b]))]
