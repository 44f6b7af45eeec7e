"""Entry swarm_cl_run: the port's closed-loop swarm flying the clean
revision's hover machine, models/simulator.py::sim_run(state, world, T,
cfg, geom, dt_ms, scan_period_ms, record=True) from
sim_init(machine="cl"), one job a call, judged by reference/swarm_cl.py.

A job is B quads, quad b in flight b's room (the traffic's `_room` and
`_obstacles`), started mid-hover at the flight's jittered first pose
(armed in GUIDED at the hover target, in HOVER, the hover not locked yet,
the prelock at the start pose), flying T ticks (the flights' frame count)
of dt_ms with a ToF scan every scan_period_ms and the traffic's ToF noise
and dropout.  The mission clock reads the workload's mission_ms at the
first tick, a scan tick, and the XY hold is stamped at the workload's
xy_stamp_ms: a quad whose sensors pass streams Z+yaw until the hold ends
inside the job, then locks and holds its position.  The start poses and
the scan draws' seed are swarm_run's (entries/swarm_run.py).

Compared, over every quad of a compared job and every quad-tick: the
machine's state (state_ticks_off), its command's kind and first value (z
for Z+yaw, x for position and yaw; cmd_off), the hover lock (locked_off),
all limit 0; the true pose and the EKF position at every tick and the
final EKF position (pose_err_m, metres) and the true and EKF headings
(yaw_err_deg), each the largest difference.
"""

from collections import Counter

import torch

from portbench.entries import swarm_run as SW
from portbench.reference import swarm_cl as RC

starts, job_seed, sensor, start_ms = (SW.starts, SW.job_seed, SW.sensor,
                                      SW.start_ms)
FRAME_KEYS = SW.FRAME_KEYS
STATES = ("WAIT_LINK", "IDLE", "ARMING", "TAKEOFF", "LIFTOFF_ASSIST",
          "HOVER", "LANDING", "DISARMING")


def run(frames, prog, args):
    from micro_quad_slam_tpu_torch.models.simulator import (
        sim_init, sim_run, world_from_boxes)

    B, T = frames["x_m"].shape
    world = world_from_boxes(frames["_room"], frames["_obstacles"])
    st = sim_init(B, job_seed(frames), prog.geom, airborne=True,
                  hover_alt_m=prog.cfg.behavior.hover_target_m,
                  device=frames["x_m"].device, start=starts(frames),
                  t0_ms=start_ms(args), machine="cl",
                  xy_stamp_ms=args["xy_stamp_ms"])
    noise_mm, dropout_p = sensor(args)
    return sim_run(st, world, T, prog.cfg, prog.geom, dt_ms=args["dt_ms"],
                   scan_period_ms=args["scan_period_ms"], record=True,
                   noise_mm=noise_mm, dropout_p=dropout_p)


def outputs(res) -> dict:
    fin, diag = res
    return {"state": diag["state"], "cmd_kind": diag["cmd_kind"],
            "cmd_x": diag["cmd"][..., 0], "locked": diag["locked"],
            "x": fin.x, "y": fin.y, "yaw_final": fin.yaw,
            "ekf_mean": fin.ekf.mean, "est_x": diag["est_x"],
            "est_y": diag["est_y"], "yaw": diag["yaw"]}


def reference(frames, rcfg, args, lowp: bool = False) -> dict:
    bh, bt, gt = RC.clean_config(SW._load("configs", args["config"]))
    x0, y0, yaw0 = starts(frames)
    return RC.swarm_run(frames["_room"], frames["_obstacles"], x0, y0, yaw0,
                        job_seed(frames), frames["x_m"].shape[1], rcfg, bh,
                        bt, gt, args["dt_ms"], args["scan_period_ms"],
                        *sensor(args), True, lowp, start_ms(args),
                        args["xy_stamp_ms"])


def compare(out: dict, ref: dict) -> dict:
    """swarm_run's comparison of states, commands, poses and headings (no
    map here), and the hover lock at every quad-tick."""
    none = {"grid": torch.zeros(0), "frontier": torch.zeros(0)}
    got = SW.compare({**out, **none}, {**ref, **none})
    del got["grid_cells_off"], got["frontier_off"]
    got["locked_off"] = int((out["locked"] != ref["locked"]).sum())
    return got


def notes(frames, out, ref, rcfg, walls) -> str:
    """What the job exercised: quad-ticks by state and by command kind,
    the quads locked by the last tick and the first tick of a lock."""
    mix = Counter(int(s) for s in ref["state"].reshape(-1).tolist())
    kinds = Counter(int(s) for s in ref["cmd_kind"].reshape(-1).tolist())
    locked = ref["locked"]
    B = locked.shape[1]
    first = torch.nonzero(locked.any(dim=1))
    return (f"quad-ticks by state "
            f"{ {STATES[k]: v for k, v in sorted(mix.items())} }; by command "
            f"kind {dict(sorted(kinds.items()))}; quads locked by the last "
            f"tick {int(locked[-1].sum())} of {B}; first locked tick "
            f"{int(first[0]) + 1 if len(first) else None}")
