"""The cone and hybrid whole-replay path: a grid-free schedule in torch,
then one hand-written Hopper kernel that applies it to every quad's grid
(counterpart of micro_quad_slam_tpu/ops/pallas_residentx.py::
pallas_replay_conex and of the "cone2"/"hybrid2" modes of
pallas_resident.py::_schedule).

From the sequential [B]-wide carry over T that every mode runs
(replay/mapping.py::carry; on a CUDA tensor its kernel from this mode's
own library, replay_cone), `sched_words` makes what every (quad, frame)
contributes at once (ops/conemode.py::scan_inputs) and packs it into one
int32 tensor [B, T, words]; float words hold their float32 bits:

    word  0..7     header: pose row, pose col (padded-grid cells), do,
                   recenter rows sy, recenter cols sx, en (enabled and
                   the pose in the grid), window corner row, col
    word  8, 9     oxc, oyc: the pose->window-corner offsets (f32)
    word 10..41    the 32 packed returns (f32; hybrid: smoothed)
    word 42..59    the 18 fan-boundary scalars (f32)
    word 60..63    0
    hybrid only:
    word 64..95    ray endpoints ex, relative to the pose cell
    word 96..127   ray endpoints ey
    word 128..159  endpoint deltas (0 for invalid rays)

`replay_cone` applies a schedule to the grids in place: on a CUDA tensor
it launches csrc/replay_cone.cu, on a CPU tensor it runs the plain
version (`replay_cone_plain`, the same frame loop in torch ops), and on
any other device it raises.  replay/mapping.py::replay_whole runs the
carry, the words and this kernel as one whole replay.
"""

from __future__ import annotations

import torch

from micro_quad_slam_tpu_torch.ops import _build
from micro_quad_slam_tpu_torch.ops import conemode
from micro_quad_slam_tpu_torch.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    recenter_apply,
)
from micro_quad_slam_tpu_torch.ops.residentx import (
    H_DO,
    H_PCX,
    H_PCY,
    H_RSX,
    H_RSY,
    HDR,
    check_operands,
    check_supported,
    recenter_scratch,
)
from micro_quad_slam_tpu_torch.utils.config import PipelineConfig

H_EN, H_R0, H_C0 = 5, 6, 7
W_OXC, W_OYC, W_PACKED, W_BOUNDS = 8, 9, 10, 42
CONE_WORDS = 64
W_EX, W_EY, W_ED = 64, 96, 128
HYBRID_WORDS = 160
# the window shape csrc/replay_cone.cu is compiled for (GridGeom's default)
KERNEL_WINDOW = (96, 128)


def words_of(hybrid: bool) -> int:
    return HYBRID_WORDS if hybrid else CONE_WORDS


def sched_words(frames: dict, beams: torch.Tensor, so: dict,
                cfg: PipelineConfig, geom: GridGeom = DEFAULT_GEOM,
                hybrid: bool = False):
    """The cone (or hybrid) schedule of frames [B, T, ...] from the
    replay's carry (replay/mapping.py::carry: its beams and the sequence
    `so`).  Returns sched int32 [B, T, words_of(hybrid)]."""
    B, T = frames["x_m"].shape
    flat = lambda a: a.reshape((B * T,) + a.shape[2:])               # noqa: E731
    inp = conemode.scan_inputs(
        flat(beams), flat(frames["x_m"]), flat(frames["y_m"]),
        flat(frames["yaw_deg"]), flat(so["ox"]), flat(so["oy"]),
        flat(so["enabled"]), cfg.map, cfg.tof, geom, hybrid)
    pcy, pcx = inp["pcy"] + geom.pad, inp["pcx"] + geom.pad
    header = torch.stack([
        pcy, pcx, flat(so["do"]).to(torch.int32), flat(so["sy"]),
        flat(so["sx"]), inp["en"].to(torch.int32), pcy - geom.win_r,
        pcx - geom.win_r], dim=-1)
    floats = torch.cat([inp["oxc"][:, None], inp["oyc"][:, None],
                        inp["packed"], inp["bounds"],
                        torch.zeros((B * T, CONE_WORDS - W_BOUNDS - 18),
                                    dtype=torch.float32,
                                    device=pcx.device)], dim=-1)
    parts = [header, floats.view(torch.int32)]
    if hybrid:
        parts += [inp["ex"], inp["ey"], inp["ed"]]
    return torch.cat(parts, dim=-1).reshape(B, T, -1).contiguous()


def _frame_inputs(w: torch.Tensor, geom: GridGeom, hybrid: bool) -> dict:
    """One frame's schedule words [B, words] -> scan_inputs' dict."""
    f = w[:, HDR:CONE_WORDS].contiguous().view(torch.float32)
    at = lambda i, n=1: f[:, i - HDR:i - HDR + n]                     # noqa: E731
    inp = {"pcx": w[:, H_PCX] - geom.pad, "pcy": w[:, H_PCY] - geom.pad,
           "en": w[:, H_EN] != 0, "oxc": at(W_OXC)[:, 0],
           "oyc": at(W_OYC)[:, 0], "packed": at(W_PACKED, 32),
           "bounds": at(W_BOUNDS, 18)}
    if hybrid:
        inp.update(ex=w[:, W_EX:W_EX + 32], ey=w[:, W_EY:W_EY + 32],
                   ed=w[:, W_ED:W_ED + 32])
    return inp


def replay_cone_plain(grids: torch.Tensor, sched: torch.Tensor,
                      cfg: PipelineConfig, hybrid: bool = False,
                      geom: GridGeom = DEFAULT_GEOM) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: per frame, the
    recenter (recenter_apply) then the window update
    (conemode.window_update) for the whole [B] batch.  Updates grids in
    place and returns them."""
    T = sched.shape[1]
    do_any = sched[..., H_DO].any(dim=0).tolist()      # one host sync
    for t in range(T):
        w = sched[:, t]
        if do_any[t]:
            grids.copy_(recenter_apply(grids, w[:, H_RSX], w[:, H_RSY],
                                       cfg.map, geom))
        conemode.apply_scans_(grids, _frame_inputs(w, geom, hybrid),
                              cfg.map, cfg.tof, geom)
    return grids


def replay_cone(grids: torch.Tensor, sched: torch.Tensor,
                cfg: PipelineConfig, hybrid: bool = False,
                geom: GridGeom = DEFAULT_GEOM) -> torch.Tensor:
    """Apply a cone (or hybrid) schedule to grids int8 [B, PR, PC] in
    place and return them.  A CUDA tensor goes to the Hopper kernel
    (csrc/replay_cone.cu); a CPU tensor to replay_cone_plain; any other
    device raises.  Each launch counts in the counter launches.replay_cone
    (utils/obs.py)."""
    check_supported(cfg, geom)
    check_operands(grids, sched, geom, words_of(hybrid))
    if grids.device.type == "cpu":
        return replay_cone_plain(grids, sched, cfg, hybrid, geom)
    if grids.device.type != "cuda":
        raise ValueError(f"no cone replay kernel for device {grids.device}")
    if (geom.win_rows, geom.win_cols) != KERNEL_WINDOW:
        raise ValueError(f"the cone kernel is built for a {KERNEL_WINDOW} "
                         f"window, not ({geom.win_rows}, {geom.win_cols})")
    B, T = sched.shape[:2]
    if B == 0 or T == 0:
        return grids
    m, cone = cfg.map, conemode.ConeConfig()
    k = conemode.cone_constants(m.res_m, cfg.tof, cone)
    _build.launch(None, "mqs_replay_cone", grids.device, grids, sched,
                  recenter_scratch(grids, sched), B, T, sched.shape[2],
                  int(hybrid), geom.prows, geom.pcols, geom.pad, geom.width,
                  geom.height, geom.win_rows, geom.win_cols, m.lo_min,
                  m.lo_max, cone.free_dec, cone.occ_inc, k["skip"],
                  k["inv_res"], k["maxr2"], k["free_margin"], k["hit_band"])
    return grids
