"""Entry swarm_vf_run: the port's closed-loop swarm flying on its vision
front-end, models/simulator.py::sim_run(state, world, T, cfg, geom, dt_ms,
scan_period_ms, record=True, vision_flow=True, flow_period_ms) from
sim_init(camera_streaming=True), one job a call, judged by
reference/swarm_vf.py.

A job is swarm_run's (entries/swarm_run.py: B quads, one room each,
airborne mid-mission at the flights' jittered first poses, T ticks of
dt_ms with a ToF scan every scan_period_ms, the mission clock at
mission_ms on the first tick, the start poses and the scan draws' seed),
with the flow sensor replaced by a downward camera of the configuration's
`vision` group: a frame rendered and flowed by pyramidal LK every
flow_period_ms, the camera streaming from before the first tick.

Compared, over every quad of a compared job: swarm_run's numbers (grid,
states, commands, frontier scores, poses, headings) and, at every
quad-tick, the vision rates the EKF read (flow_rate_err, rad/s, the
largest difference; a NaN on one side only reads as infinite) and the
quality (flow_q_off, the quad-ticks whose quality differs).
"""

import torch

from portbench.entries import swarm_run as SW
from portbench.reference import swarm as RW
from portbench.reference import swarm_vf as RV

starts, job_seed, sensor, start_ms = (SW.starts, SW.job_seed, SW.sensor,
                                      SW.start_ms)
FRAME_KEYS = SW.FRAME_KEYS
STATES = SW.STATES


def vision(args) -> dict:
    """The configuration's vision group."""
    return SW._load("configs", args["config"])["vision"]


def run(frames, prog, args):
    from micro_quad_slam_tpu_torch.models import simulator as S

    v = vision(args)
    if (v["camera_px"], v["focal_px"]) != (S.CAM_SIZE, S.CAM_FOCAL):
        raise ValueError(f"the program's camera is {S.CAM_SIZE} px at "
                         f"{S.CAM_FOCAL} px focal, the configuration's "
                         f"{v['camera_px']} at {v['focal_px']}")
    B, T = frames["x_m"].shape
    world = S.world_from_boxes(frames["_room"], frames["_obstacles"])
    st = S.sim_init(B, job_seed(frames), prog.geom, airborne=True,
                    device=frames["x_m"].device, start=starts(frames),
                    t0_ms=start_ms(args), camera_streaming=True)
    noise_mm, dropout_p = sensor(args)
    return S.sim_run(st, world, T, prog.cfg, prog.geom, dt_ms=args["dt_ms"],
                     scan_period_ms=args["scan_period_ms"], record=True,
                     noise_mm=noise_mm, dropout_p=dropout_p,
                     vision_flow=True, flow_period_ms=v["flow_period_ms"])


def outputs(res) -> dict:
    fin, diag = res
    out = SW.outputs(res)
    out.update({k: diag[k] for k in ("of_rate_x", "of_rate_y", "of_q")})
    return out


def reference(frames, rcfg, args, lowp: bool = False) -> dict:
    bh, bt = RW.behavior_config(SW._load("configs", args["config"]))
    x0, y0, yaw0 = starts(frames)
    return RV.swarm_run(frames["_room"], frames["_obstacles"], x0, y0, yaw0,
                        job_seed(frames), frames["x_m"].shape[1], rcfg, bh,
                        bt, vision(args), args["dt_ms"],
                        args["scan_period_ms"], *sensor(args), lowp,
                        start_ms(args))


def _rate_err(a, b) -> float:
    """The largest |a - b| of rates [T, B]; NaN on both sides agrees, on
    one side only reads as infinite."""
    a, b = a.double(), b.double()
    one = torch.isnan(a) != torch.isnan(b)
    if one.any():
        return float("inf")
    d = torch.where(torch.isnan(a), 0.0, (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def compare(out: dict, ref: dict) -> dict:
    got = SW.compare(out, ref)
    got["flow_rate_err"] = max(_rate_err(out["of_rate_x"], ref["of_rate_x"]),
                               _rate_err(out["of_rate_y"], ref["of_rate_y"]))
    got["flow_q_off"] = int((out["of_q"] != ref["of_q"]).sum())
    return got


def notes(frames, out, ref, rcfg, walls) -> str:
    """swarm_run's notes, and the vision front-end's: the quality's
    spread, the quad-ticks under the quality gate, and the rates' size."""
    q = ref["of_q"].float()
    lo, mid = torch.quantile(q, torch.tensor([0.0, 0.5], device=q.device))
    low = int((ref["of_q"] < rcfg.gates.of_min_quality).sum())
    speed = torch.hypot(ref["of_rate_x"], ref["of_rate_y"])
    top = float(torch.nan_to_num(speed, nan=0.0).max())
    return (SW.notes(frames, out, ref, rcfg, walls)
            + f"; vision: quality min {float(lo):.0f} median {float(mid):.0f},"
            f" quad-ticks under the gate {low} of {q.numel()}, largest rate "
            f"{top:.4f} rad/s")
