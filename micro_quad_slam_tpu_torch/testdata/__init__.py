"""Committed test flights of the port, as numpy arrays.

Each `<name>.npz` holds one batch of flights in the layout of
replay/mapping.py::scanlog_to_arrays with a leading flight dimension
(grid_mm [B, T, 4, 8, 8], x_m [B, T], ...; slam_bench_flights also holds
the EKF inputs of replay/fusion.py::fusion_arrays).  The golden ones also
hold the golden C model's result for every flight under `golden_*` keys: `grid`
(the logical int8 grid [B, H, W]), `used` [B, T], `recentered` [B] and
`origin_x` [B].

    random_flights        8 x 64 noisy flights; flight 1 is dragged 40 m so
                          that it recenters, flight 7 never takes off
    golden_hover          a 32-frame hover (tests/test_replay.py:26-32)
    golden_line_recenter  a 40-frame 18 m line that recenters
                          (tests/test_replay.py:53-64)
    golden_short_beams    3 frames with every zone at 51 mm (flight 0) or
                          53 mm (flight 1): most rays end in the pose cell
    bench_flight          bench.py's base flight, 256 frames
    slam_bench_flights    the 4 distinct circle flights (flow on, 6 mm
                          noise) of sim/synthio.py::slam_bench_frames at
                          256 frames, with the EKF inputs of
                          replay/fusion.py::fusion_arrays as well

Beside the flights, reference results of the JAX package's replay
(`reference(name)`):

    hybrid_random_flights  `grid`: the logical grids [8, 500, 500] of its
                           kernel="hybrid" replay of random_flights
    hybrid_bench_sums      `sums` and `weighted` (grid_sums) [1024] of
                           each flight's grid after its kernel="hybrid"
                           replay of bench_frames(1024), bench.py's
                           hybridx workload
    slam_bench_ref         its slam_replay of slam_bench_flights, under
                           `ul_` (UL_PROFILE) and `rt_` (UL_RT_PROFILE):
                           track, odo_track [4, 256, 3], kf_nodes
                           [4, 26, 3], and the grids' sums and weighted
                           sums [4]; `ekf_x`, its fusion replay's x track
    slam_stages            `_slam_impl` of a small batch (2 copies of a
                           60-frame drifting circle, the second 5 m east;
                           inputs under `in_`) with the trimmed profile of
                           tests/test_slam.py::test_slam_small_end_to_end,
                           kf_every 10, gn_iters 4, stage by stage
    wire_ref               its live-topology replay of wire_capture()
                           (the first SLAM bench flight as a dual-UART
                           capture): the logical grids [500, 500] of
                           replay_wirecap with kernel="xla" (`exact_grid`)
                           and "hybrid" (`hybrid_grid`), and its UL
                           slam_replay of the capture's frames [1, 256]:
                           `slam_track`, `slam_odo_track`, `slam_kf_nodes`
                           and the grid's `slam_sums`, `slam_weighted`
    slam_fb_ref            pass 1's feedback formulations: its
                           slam_replay with match_feedback=True (`fb_`)
                           and with match_map_kf_only=False (`all_`) of
                           slam_bench_flights (keys as slam_bench_ref's)
                           and of the slam_stages batch (`stage_fb_`,
                           `stage_all_`: track, kf_nodes, sums,
                           weighted); and its sequential pass 1 (_map_pass,
                           match=True, gate 0.05, kf_every 8) on the
                           recentering flight of tests/test_slam.py:593
                           (4 x 64 frames, inputs under `rc_in_`): the
                           odometry `rc_odo` and schedule `rc_sched_*` it
                           was fed, and `rc_{fb,all}_grid` (padded
                           [4, PR, PC]) and `rc_{fb,all}_matched`
                           [4, 64, 3]; and the same pass as
                           slam_replay's first round runs it on
                           slam_bench_flights (UL profile): `pass1_odo`,
                           `pass1_sched_*`, `pass1_{fb,all}_grid`,
                           `pass1_{fb,all}_matched` [4, 256, 3]
    cl_fuzz_telemetry      the telemetry of the golden CL machine's runs
                           on tests/test_behavior_cl.py:160's fuzzed
                           schedules (fc_mock.random_scenario, seeds
                           10000-10031, 700 ticks): each Telemetry field
                           [700, 32] (telems_to_arrays' dtypes)
    swarm_small_jax        its closed-loop simulator on bench.py's swarm
                           configuration (bench.py:45-81) cut to B=8:
                           the start state sim_init(8, PRNGKey(0),
                           spread_m=0.5, airborne=True) under `start.`
                           (nested fields joined by dots, no key), its 10
                           scan ticks' draws `normal` and `uniform`
                           [10, 8, 4, 8, 8], and the results of
                           sim_run(T=1000, dt_ms=1, record=True): the
                           behaviour-state and cmd_kind traces [1000, 8],
                           the final padded grids, frontier scores, true
                           poses x, y, yaw and EKF means

and one result of the port itself:

    swarm_bench_ref        the port's CPU run of the B=1024 bench swarm
                           (swarm_bench: sim_init(1024, seed 0,
                           airborne) with its own generator's draws):
                           `checksum` and per-quad grid `sums` [1024];
                           torch's generator draws other numbers than
                           jax.random, so it is not the TPU record

tests/test_torch_testdata.py holds every file bit-equal to what the JAX
package's flight simulator, golden model and replay give now (re-deriving
a few bench flights), and rewrites them all when run as a script:

    JAX_PLATFORMS=cpu python tests/test_torch_testdata.py
"""

from __future__ import annotations

import os

import numpy as np

NAMES = ("random_flights", "golden_hover", "golden_line_recenter",
         "golden_short_beams", "bench_flight", "slam_bench_flights")
REFERENCES = ("hybrid_random_flights", "hybrid_bench_sums", "slam_bench_ref",
              "slam_stages", "swarm_small_jax", "swarm_bench_ref",
              "wire_ref", "slam_fb_ref", "cl_fuzz_telemetry")

# bench.py's swarm workload (bench.py:45-81): world, start and run
SWARM_WORLD = {"room": (-3.5, -3.5, 3.5, 3.5),
               "obstacles": ((1.5, -0.5, 2.5, 0.5),)}
SWARM_RUN = {"dt_ms": 1, "scan_period_ms": 100}
SWARM_T, SWARM_B = 1000, 1024
# the CL machine's fuzzed schedules kept in cl_fuzz_telemetry
CL_FUZZ_SEEDS, CL_FUZZ_TICKS = 32, 700


def path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.npz")


def load(name: str):
    """-> (frames dict of [B, T, ...] arrays, golden dict; empty when the
    file holds no golden result)."""
    with np.load(path(name)) as z:
        frames = {k: z[k] for k in z.files if not k.startswith("golden_")}
        golden = {k[len("golden_"):]: z[k] for k in z.files
                  if k.startswith("golden_")}
    return frames, golden


def reference(name: str) -> dict:
    """A stored reference result: dict of numpy arrays."""
    if name not in REFERENCES:
        raise ValueError(f"unknown reference {name!r}; one of {REFERENCES}")
    with np.load(path(name)) as z:
        return {k: z[k] for k in z.files}


def grid_sums(grids: np.ndarray) -> dict:
    """Per-flight int64 digests of int8 grids [B, ...]: `sums`, the plain
    sum (bench.py's checksum is their int32 total), and `weighted`, the
    sum of each cell's value times its flat index mod 65521, which also
    moves when a value moves to another cell."""
    g = np.asarray(grids).reshape(len(grids), -1).astype(np.int64)
    w = np.arange(g.shape[1], dtype=np.int64) % 65521
    return {"sums": g.sum(axis=1), "weighted": g @ w}


def bench_frames(B: int = 1024, T: int = 256) -> dict:
    """bench.py's replay workload (bench.py:184-202): its hover flight
    replicated B times with per-flight pose jitter from rng seed 1.  The
    committed bench_flight at T=256; at another T the port's synthio
    builds the same flight (bench.py's arguments), whose first frames are
    the committed one's."""
    base, _ = load("bench_flight")
    if T == base["x_m"].shape[1]:
        base = {k: v[0] for k, v in base.items()}
    else:
        from micro_quad_slam_tpu_torch.replay.mapping import scanlog_to_arrays
        from micro_quad_slam_tpu_torch.sim.synthio import synth_room_scanlog

        base = scanlog_to_arrays(synth_room_scanlog(
            n_frames=T, seed=0, path="hover", yaw_rate_dps=20.0,
            noise_mm=5.0))
    rng = np.random.default_rng(1)
    frames = {k: np.broadcast_to(v, (B,) + v.shape).copy()
              for k, v in base.items()}
    frames["x_m"] = frames["x_m"] + rng.normal(0, 0.3, (B, 1)).astype(np.float32)
    frames["y_m"] = frames["y_m"] + rng.normal(0, 0.3, (B, 1)).astype(np.float32)
    frames["yaw_deg"] = np.mod(
        frames["yaw_deg"] + rng.uniform(-180, 180, (B, 1)).astype(np.float32)
        + 180.0, 360.0) - 180.0
    return frames


def slam_bench_frames(B: int, T: int = 256, device=None) -> dict:
    """bench.py's SLAM and EKF workload (sim/synthio.py::slam_bench_frames):
    the 4 distinct circle flights replicated to B flights, as tensors on
    `device` (replay/mapping.py::frames_to_torch: the CUDA device unless
    told otherwise).  The committed slam_bench_flights at T=256; at
    another T the port's synthio builds them."""
    from micro_quad_slam_tpu_torch.replay.mapping import frames_to_torch

    base, _ = load("slam_bench_flights")
    if T != base["x_m"].shape[1]:
        from micro_quad_slam_tpu_torch.sim.synthio import (
            slam_bench_frames as synth_slam_bench_frames)

        return synth_slam_bench_frames(B, T, device=device)
    nrep = -(-B // 4)
    return frames_to_torch({k: np.concatenate([v] * nrep)[:B]
                            for k, v in base.items()}, device)


def wire_flight():
    """The first SLAM bench flight (slam_bench_flights' flight 0: a circle
    with flow, 6 mm noise, seed 0, T=256) as a ScanLog, made by the port's
    synthio (byte-equal to the JAX package's)."""
    from micro_quad_slam_tpu_torch.sim.synthio import synth_room_scanlog

    return synth_room_scanlog(n_frames=256, seed=0, path="circle",
                              noise_mm=6.0, with_flow=True)


def wire_capture() -> list:
    """wire_flight() as the dual-UART capture that would have produced it
    (replay/livestream.py::scanlog_to_wirecap, MAVLink v1): (channel, t_ms,
    payload) records, the wire_ref reference's input."""
    from micro_quad_slam_tpu_torch.replay.livestream import scanlog_to_wirecap

    return scanlog_to_wirecap(wire_flight())


def _unflatten(flat: dict) -> dict:
    """{"a.b": v} -> {"a": {"b": v}}."""
    out: dict = {}
    for key, v in flat.items():
        *head, last = key.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def swarm_small(device=None):
    """The committed JAX small swarm (swarm_small_jax) as the port's
    inputs: (world, start state, the 10 scan ticks' draws, the reference
    dict), on `device` (the CUDA device unless told otherwise)."""
    import torch

    from micro_quad_slam_tpu_torch.models.simulator import (
        make_world, sim_state_from_numpy)

    ref = reference("swarm_small_jax")
    start = _unflatten({k[len("start."):]: v for k, v in ref.items()
                        if k.startswith("start.")})
    st = sim_state_from_numpy(start, device)
    draws = [(torch.from_numpy(n), torch.from_numpy(u))
             for n, u in zip(ref["normal"], ref["uniform"])]
    world = make_world(st.x.shape[0], **SWARM_WORLD, device=st.x.device)
    return world, st, draws, ref


def swarm_bench(lanes=None, device=None, B: int = SWARM_B):
    """The port's bench swarm: (world, start state, draws) of B=1024 quads
    (or `B`) from sim_init(B, seed 0, spread_m=0.5, airborne=True), on
    `device` (the CUDA device unless told otherwise).  With `lanes`, only
    those quads, and draws holds their part of the 10 scan ticks' draws on
    the start state's generator (the whole swarm's run draws them itself:
    draws is None)."""
    from micro_quad_slam_tpu_torch.models.simulator import (
        fork_generator, make_world, scan_draws, select_lanes, sim_init)

    st = sim_init(B, 0, spread_m=0.5, airborne=True, device=device)
    world = make_world(B, **SWARM_WORLD, device=st.x.device)
    if lanes is None:
        return world, st, None
    gen = fork_generator(st.gen)
    n_scans = SWARM_T * SWARM_RUN["dt_ms"] // SWARM_RUN["scan_period_ms"]
    draws = [tuple(d[list(lanes)] for d in scan_draws(gen, B))
             for _ in range(n_scans)]
    return select_lanes(world, lanes), select_lanes(st, lanes), draws


def _jump_frames(x, y, seed: int) -> dict:
    """Flights along the poses x, y [B, T] (yaw turning 37 degrees a frame),
    every frame enabled, with seeded ToF zones: hits from 0.3 to 4.2 m and
    a tenth of the zones without a return."""
    rng = np.random.default_rng(seed)
    B, T = x.shape
    grid_mm = rng.integers(300, 4200, (B, T, 4, 8, 8)).astype(np.uint16)
    grid_mm[rng.random(grid_mm.shape) < 0.1] = 0xFFFF
    return {"grid_mm": grid_mm, "x_m": x.astype(np.float32),
            "y_m": y.astype(np.float32),
            "yaw_deg": (np.mod(37.0 * np.arange(T) + 180.0, 360.0)
                        - 180.0).astype(np.float32)[None].repeat(B, 0),
            "of_q": np.full((B, T), 200, np.int32),
            "of_rate_x": np.zeros((B, T), np.float32),
            "sys_health": np.zeros((B, T), np.int64),
            "state": np.full((B, T), 5, np.uint8)}


def tile_flights() -> dict:
    """The exact kernel's resident-tile cases (csrc/replay_exact.cu keeps a
    128 x 128 tile of the grid around the pose in shared memory and
    reloads it when a frame's rays leave it), as flights [2, T, ...]:

        tile_every_frame       the pose jumps 8 m east and back (quad 0)
                               or 8 m in x and in y and back (quad 1)
                               every frame, 80 cells, past the tile's
                               reach of 71 cells from the pose, so every
                               frame's rays leave the tile
        recenter_after_reload  8 m a frame east (quad 0) or 6 m a frame
                               in x and in y south-west (quad 1): every
                               frame reloads the tile, and the map
                               recenters every second frame or so, each
                               time right after a reload"""
    T = 24
    sign = np.where(np.arange(T) % 2 == 0, -4.0, 4.0)
    jump_x = np.stack([sign, sign])
    jump_y = np.stack([np.zeros(T), sign])
    T = 40
    step = np.arange(T, dtype=np.float64)
    line_x = np.stack([8.0 * step, -6.0 * step])
    line_y = np.stack([np.zeros(T), -6.0 * step])
    return {"tile_every_frame": _jump_frames(jump_x, jump_y, 21),
            "recenter_after_reload": _jump_frames(line_x, line_y, 22)}


def edge_scans(B: int = 64):
    """One scan per quad with its rays reaching the logical grid's edge:
    poses within 0.3 m of the border of the 50 x 50 m map (origin 0), yaw
    all round, beams from 0.06 to 0.7 m (a tenth of them NaN).  Returns
    numpy (beams [B, 4, 8], x, y, yaw [B])."""
    rng = np.random.default_rng(23)
    along = rng.uniform(-24.9, 24.9, B)
    inset = rng.uniform(24.65, 24.95, B)
    side = np.arange(B) % 4
    x = np.where(side == 0, inset, np.where(side == 1, -inset, along))
    y = np.where(side == 2, inset, np.where(side == 3, -inset, along))
    beams = rng.uniform(0.06, 0.7, (B, 4, 8))
    beams[rng.random(beams.shape) < 0.1] = np.nan
    yaw = rng.uniform(-180, 180, B)
    return (beams.astype(np.float32), x.astype(np.float32),
            y.astype(np.float32), yaw.astype(np.float32))


def int32_total(sums) -> int:
    """The int32 (wrapping) total of per-quad sums: bench.py's checksum."""
    return (int(np.sum(np.asarray(sums, np.int64))) + 2 ** 31) % 2 ** 32 \
        - 2 ** 31


def swarm_bench_result(device=None) -> dict:
    """swarm_bench_ref's content, computed now by the port on `device`:
    the whole bench swarm's run (B=1024, T=1000) and its grids' checksum
    and per-quad sums.  On the CPU it takes minutes and ~1 GB."""
    from micro_quad_slam_tpu_torch.models.simulator import sim_run
    from micro_quad_slam_tpu_torch.utils.config import UL_PROFILE

    world, st, _ = swarm_bench(device=device)
    fin, _ = sim_run(st, world, SWARM_T, UL_PROFILE, **SWARM_RUN)
    sums = grid_sums(fin.mapper.grid.cpu().numpy())["sums"]
    return {"checksum": np.int64(int32_total(sums)), "sums": sums}


def slam_kernel_operands(frames: dict, cfg) -> tuple:
    """The SLAM kernels' operands on the flights `frames` under profile
    `cfg`, made by the pipeline's own functions: the snapshot entry's
    (grids, sched, snaps, n_kf), and the lattice kernel's (slabs, ry, rx,
    n_yaw) of the first pass-1 round (at the odometry) under "pass1" and
    of the last round's first loop stage (at its matched keyframes) under
    "loop"."""
    import torch

    from micro_quad_slam_tpu_torch.ops import residentx as rx
    from micro_quad_slam_tpu_torch.ops import scanmatch as sm
    from micro_quad_slam_tpu_torch.ops.beams import extract_beams
    from micro_quad_slam_tpu_torch.ops.raycast import DEFAULT_GEOM as geom
    from micro_quad_slam_tpu_torch.slam import pipeline as sp

    s = cfg.slam

    def lattice(args, n_xy: int, n_yaw: int):
        slabs, r0s, c0s, *scan = args
        cells = sm._lattice_cells(*scan, cfg.map, cfg.tof, n_xy, n_yaw,
                                  s.match_xy_step_m, s.match_yaw_step_deg)
        ry, rxi = sm.lattice_indices(cells, r0s, c0s, geom)
        return slabs, ry, rxi, n_yaw

    B, T = frames["x_m"].shape
    odo, sched = sp._slam_impl(frames, cfg, geom, None, None, upto=0)
    beams, _ = extract_beams(frames["grid_mm"], cfg.tof)
    sl = sp._kf_slots(beams, sched, s.kf_every, cfg)
    snap, match = sp._round_operands(sl, odo, s.kf_every, cfg, geom)
    zeros = torch.zeros((B, geom.prows, geom.pcols), dtype=torch.int8,
                        device=odo.device)
    snap_ops = rx._snap_operands(zeros, *snap, sl.n_kf, cfg, geom) + (
        sl.n_kf,)
    _, slabs = rx.map_snap(zeros, *snap, sl.n_kf, cfg, geom)
    pass1 = lattice([slabs.reshape((-1,) + slabs.shape[2:])] + match,
                    s.match_n_xy, s.match_n_yaw)
    kf = torch.arange(0, T, s.kf_every, device=odo.device)
    matched = sp._slam_impl(frames, cfg, geom, None, None, upto=1)
    *_, args = sp._loop_candidates(matched[:, kf], beams[:, kf],
                                   sched["ox"][:, kf], sched["oy"][:, kf],
                                   cfg, geom)
    return snap_ops, {"pass1": pass1,
                      "loop": lattice(args, s.loop_n_xy, s.loop_n_yaw)}


def cl_fuzz(B: int, device=None) -> dict:
    """cl_fuzz_telemetry's schedules tiled to B quads, as [T, B] tensors
    on `device` (the CUDA device unless told otherwise) for the CL
    machine's step: the uint32 health bits widen to int64."""
    import torch

    from micro_quad_slam_tpu_torch.replay.mapping import as_device

    device = as_device(device)
    ref = reference("cl_fuzz_telemetry")
    reps = -(-B // CL_FUZZ_SEEDS)
    return {k: torch.from_numpy(np.concatenate(
        [v.astype(np.int64) if v.dtype == np.uint32 else v] * reps,
        axis=1)[:, :B]).to(device) for k, v in ref.items()}
