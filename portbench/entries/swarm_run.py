"""Entry swarm_run: the port's closed-loop swarm,
models/simulator.py::sim_run(state, world, T, cfg, geom, dt_ms,
scan_period_ms, record=True), one job a call, judged by
reference/swarm.py.

A job is B quads, quad b in flight b's room (the traffic's `_room` and
`_obstacles`, models/simulator.py::world_from_boxes), started as the
workload says (airborne: mid-mission) at the flight's jittered first
pose, flying T ticks (the flights' frame count) of dt_ms with a ToF scan
every scan_period_ms, the traffic's ToF noise and dropout and the
flow-sensor model.  The mission clock reads the workload's mission_ms at
the first tick, a scan tick: the quads' XY hold and frontier timer have
run out, so from that scan they fly forward or turn.  The scan draws come
from a CPU generator seeded from the job's own start poses (job_seed), so
the program and the reference draw the same numbers and another --seed
draws others.

Compared, over every quad of a compared job: the int8 grid cell for cell
(grid_cells_off), the machine's state and its command (the kind and the
first value: the forward speed of a body-velocity command) at every
quad-tick (state_ticks_off, cmd_off), the last frontier scores
(frontier_off), all limit 0; the true pose and the EKF position at every
tick (pose_err_m, metres) and the true and EKF headings (yaw_err_deg),
each the largest difference.
"""

import json
import math
from collections import Counter
from pathlib import Path

import torch

from portbench.reference import swarm as RW

FRAME_KEYS = ("x_m", "y_m", "yaw_deg", "_room", "_obstacles")
STATES = ("WAIT_LINK", "IDLE", "ARMING", "TAKEOFF", "LIFTOFF_ASSIST",
          "HOVER", "EXPLORE", "TURNING", "LANDING", "DISARMING")


def starts(frames) -> tuple:
    """The quads' start poses (x, y, yaw_deg) [B]: each flight's first."""
    return tuple(frames[k][:, 0].contiguous()
                 for k in ("x_m", "y_m", "yaw_deg"))


def job_seed(frames) -> int:
    """The scan draws' seed: a hash of the start poses' float32 bits."""
    bits = torch.stack(starts(frames)).view(torch.int32).to(torch.int64)
    w = torch.arange(1, bits.numel() + 1, device=bits.device).view(
        bits.shape)
    return int((bits * w).sum()) % (2 ** 31 - 1)


def _load(kind: str, name: str) -> dict:
    return json.loads((Path(__file__).resolve().parents[1] / kind
                       / f"{name}.json").read_text())


def sensor(args) -> tuple:
    """The ToF model's noise (mm) and dropout share: the traffic's."""
    t = _load("traffic", args["traffic"])
    return t["noise_mm"], t["dropout_p"]


def start_ms(args) -> int:
    """The mission clock before the first tick."""
    return args["mission_ms"] - args["dt_ms"]


def run(frames, prog, args):
    from micro_quad_slam_tpu_torch.models.simulator import (
        sim_init, sim_run, world_from_boxes)

    B, T = frames["x_m"].shape
    world = world_from_boxes(frames["_room"], frames["_obstacles"])
    st = sim_init(B, job_seed(frames), prog.geom, airborne=args["airborne"],
                  device=frames["x_m"].device, start=starts(frames),
                  t0_ms=start_ms(args))
    noise_mm, dropout_p = sensor(args)
    return sim_run(st, world, T, prog.cfg, prog.geom, dt_ms=args["dt_ms"],
                   scan_period_ms=args["scan_period_ms"], record=True,
                   noise_mm=noise_mm, dropout_p=dropout_p)


def outputs(res) -> dict:
    fin, diag = res
    return {"grid": fin.mapper.grid, "state": diag["state"],
            "cmd_kind": diag["cmd_kind"], "cmd_x": diag["cmd"][..., 0],
            "frontier": fin.frontier, "x": fin.x, "y": fin.y,
            "yaw_final": fin.yaw, "ekf_mean": fin.ekf.mean,
            "est_x": diag["est_x"], "est_y": diag["est_y"],
            "yaw": diag["yaw"]}


def reference(frames, rcfg, args, lowp: bool = False) -> dict:
    bh, bt = RW.behavior_config(_load("configs", args["config"]))
    x0, y0, yaw0 = starts(frames)
    return RW.swarm_run(frames["_room"], frames["_obstacles"], x0, y0, yaw0,
                        job_seed(frames), frames["x_m"].shape[1], rcfg, bh,
                        bt, args["dt_ms"], args["scan_period_ms"],
                        *sensor(args), args["airborne"], lowp,
                        start_ms(args))


def _largest(diffs) -> float:
    """The largest absolute difference; a NaN anywhere reads as infinite."""
    d = torch.cat([v.reshape(-1).double().abs() for v in diffs])
    if torch.isnan(d).any():
        return math.inf
    return float(d.max())


def _deg(a):
    """Headings [deg] wrapped to [-180, 180)."""
    return torch.remainder(a + 180.0, 360.0) - 180.0


def compare(out: dict, ref: dict) -> dict:
    rad = 180.0 / math.pi
    return {
        "grid_cells_off": int((out["grid"] != ref["grid"]).sum()),
        "state_ticks_off": int((out["state"] != ref["state"]).sum()),
        "cmd_off": int(((out["cmd_kind"] != ref["cmd_kind"])
                        | (out["cmd_x"] != ref["cmd_x"])).sum()),
        "frontier_off": int((out["frontier"] != ref["frontier"]).sum()),
        "pose_err_m": _largest([
            out[k].double() - ref[k].double()
            for k in ("x", "y", "est_x", "est_y")]
            + [out["ekf_mean"][:, :2].double()
               - ref["ekf_mean"][:, :2].double()]),
        "yaw_err_deg": _largest([
            _deg(out["yaw"].double() - ref["yaw"].double()),
            _deg(out["yaw_final"].double() - ref["yaw_final"].double()),
            _deg((out["ekf_mean"][:, 6].double()
                  - ref["ekf_mean"][:, 6].double()) * rad)]),
    }


def notes(frames, out, ref, rcfg, walls) -> str:
    """What the job exercised: quad-ticks by state, command kinds and
    forward commands, quads that turned, the scans' mapped cells."""
    mix = Counter(int(s) for s in ref["state"].reshape(-1).tolist())
    kinds = Counter(int(s) for s in ref["cmd_kind"].reshape(-1).tolist())
    fwd = (ref["cmd_kind"] == RW.CMD_VEL_BODY) & (ref["cmd_x"] > 0)
    turned = (ref["state"] == STATES.index("TURNING")).any(dim=0)
    g = ref["grid"]
    return (f"quad-ticks by state "
            f"{ {STATES[k]: v for k, v in sorted(mix.items())} }; by command "
            f"kind {dict(sorted(kinds.items()))}, forward {int(fwd.sum())}; "
            f"quads that turned {int(turned.sum())}; cells set "
            f"{int((g != 0).sum())}, occupied (>10) {int((g > 10).sum())}; "
            f"frontier score mean {float(ref['frontier'].float().mean()):.2f}")
