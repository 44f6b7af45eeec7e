"""Plain reference of the closed-loop swarm: B simulated quads, each in its
own room, flying the companion's whole loop tick by tick
(exie1122/micro-quad-SLAM, `uav_local_nav.c`):

  world   the ToF fans traced against the quad's room and boxes, the
          sensor's millimetres with noise and dropouts     [scan ticks]
  map     beams (:1320-1359) and the exact ray walk of the
          500 x 500 map from the EKF pose (:241-306)       [scan ticks]
  flow    the flow sensor: body velocity over the ground, quality 85
  EKF     predict and the yaw, rangefinder and flow updates
  front.  frontier_score_dir for four directions (:356-385) [scan ticks]
  machine control_tick (:1866-2333) on the telemetry of the FC model
  FC      the flight controller applying the machine's requests and
          commands, and the dynamics

Every tick is a closed loop over the [B] batch in eager float32 torch:
each value rounds as the C float code does (trig by way of float64
rounded once, divisions by tensors, no product contracted into an fma).
Beams, the ray walk and the EKF are the benchmark's own
(reference/grid.py, reference/mapping.py, reference/slam.py).

Departures from the C, all the simulated swarm's:
  - the sensors and the flight controller are models: the ToF grid's 8
    rows of a column see the column's fan distance; the flow sensor
    reads the true body velocity over the true height; the FC spools its
    motors at 900 us/s, lifts above 1150 us, climbs at 0.45 m/s to its
    takeoff target, follows body-velocity setpoints with a 0.4 s lag and
    position setpoints by a clamped P-law, and keeps the quad 0.15 m off
    the walls; boxes stop the ToF but not the quad;
  - the telemetry is always fresh and healthy (SYS_STATUS all bits, a
    2-cell 8.2 V battery that does not drain), so the machine's health,
    battery and freshness branches never trip, though they are here;
  - the map is inited at the quad's start pose when it starts airborne
    and never recenters (a room is far smaller than the map);
  - the heartbeat and status print are left out but for the print's
    observable vel_xy_stable call (:1886-1889).

The scan ticks' draws are the program's (models/simulator.py::scan_draws):
a CPU torch generator seeded with the job's seed makes 3 x B uniform draws
for the start poses, then per scan tick a standard normal and a uniform
draw of [B, 4, 8, 8].

`lowp` is the precision control: it rounds the true pose and the EKF
mean that each tick hands on to bfloat16.
"""

from __future__ import annotations

import math
import types
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.config import Config
from portbench.reference.grid import (
    F32, cos_f32, div_f32, extract_beams, f32, lowp_round, make_rays,
    sin_f32, tof_filter_update, world_to_cell)
from portbench.reference.mapping import apply_rays_exact, new_flat_grids
from portbench.reference.slam import Ekf, ekf_init, ekf_step, predict_consts

DEG2RAD = f32(np.pi / 180.0)       # the simulator's degrees-to-radians
NO_TARGET = 0xFFFF

# states (:484-496), directions, commands, modes, keyframe flags
(WAIT_LINK, IDLE, ARMING, TAKEOFF, LIFTOFF_ASSIST, HOVER, EXPLORE, TURNING,
 LANDING, DISARMING) = range(10)
FRONT, RIGHT, BACK, LEFT = range(4)
CMD_NONE, CMD_VEL_BODY, CMD_VEL_NED, CMD_POS_YAW, CMD_ATT, CMD_RC = range(6)
MODE_STABILIZE, MODE_GUIDED, MODE_LAND = 0, 4, 9
KF_TAKEOFF, KF_TURN_START, KF_TURN_END, KF_LAND_START = 1, 2, 4, 8
KF_LIFTOFF, KF_BATT_LAND, KF_BATT_EMERG = 16, 64, 128
ACK_ACCEPTED, ACK_TEMP_REJECTED, ACK_DENIED = 0, 1, 2
ON_GROUND = 1
GYRO, Z_CTRL, XY_CTRL, MOTORS = 0x01, 0x2000, 0x4000, 0x400000
ALT_NONE, ALT_LPOS, ALT_RF, ALT_GND = 0, 1, 2, 3

# gates of uav_local_nav.c beyond the configuration's `gates` group
SYS_FRESH_MS, OF_FRESH_MS, LPOS_FRESH_MS, RF_FRESH_MS = 1000, 400, 400, 400
BATT_FRESH_MS = 2000
XY_MIN_ALT_M, XY_STABLE_HOLD_MS = 0.12, 1000          # :956, :971
CEIL_M, CEIL_RELEASE_M = 0.70, 0.10                   # :114, :1469

# frontier_score_dir (:356-385)
FR_RANGE_M, FR_STEP_CELLS = 2.5, 2.0
FR_RAYS_DEG = (0.0, 15.0, -15.0)
FR_QUERIES_DEG = (0.0, 90.0, -90.0, 180.0)            # F, R, L, B
FR_UNKNOWN_BAND, FR_OCC, FR_FREE = 1, 10, -10
FR_W_UNKNOWN, FR_W_FREE, FR_W_OCC = 3, 1, 4

# the flight-controller model
BATT_V, BATT_CELLS = 8.2, 2
HEALTH_ALL = GYRO | Z_CTRL | XY_CTRL | MOTORS
FLOW_Q = 85
HOVER_ALT_M = 0.5


def behavior_config(conf: dict):
    """The configuration file's `behavior` and `battery` groups as
    attribute namespaces (the file is what both sides run)."""
    return (types.SimpleNamespace(**conf["behavior"]),
            types.SimpleNamespace(**conf["battery"]))


# ------------------------------------------------------------- world

def fan_degrees(tof) -> torch.Tensor:
    """The 32 beam angles off the heading (F0..7, R0..7, B0..7, L0..7),
    float32 as the sensor model computes them."""
    u = (np.arange(8, dtype=np.float32) - F32(3.5)) / F32(3.5)
    half = F32(tof.fov_deg * 0.5)
    fan = np.asarray(tof.dir_center_deg, np.float32)[:, None] + u * half
    return torch.from_numpy(fan.reshape(-1).astype(np.float32))


def trace_rays(room, boxes, live, x, y, ang):
    """Distance from (x, y) [B] along ang [B, R] (radians) to the first
    wall of the room [B, 4] or face of a live box [B, K, 4] (slabs)."""
    c, s = cos_f32(ang), sin_f32(ang)
    far = f32(1e9)
    tiny = f32(1e-12)
    col = lambda a: a[:, None]                                     # noqa: E731

    def leave(lo, hi, o, d):
        up = torch.where(d > tiny, (hi - o) / d, far)
        down = torch.where(d < -tiny, (lo - o) / d, far)
        return torch.minimum(torch.where(up > 0, up, far),
                             torch.where(down > 0, down, far))

    wall = torch.minimum(leave(col(room[:, 0]), col(room[:, 2]), col(x), c),
                         leave(col(room[:, 1]), col(room[:, 3]), col(y), s))
    best = wall
    for k in range(boxes.shape[1]):
        b = boxes[:, k]
        spans = []
        for lo, hi, o, d in ((b[:, 0], b[:, 2], x, c),
                             (b[:, 1], b[:, 3], y, s)):
            lo, hi, o = col(lo), col(hi), col(o)
            flat = d.abs() < tiny
            safe = torch.where(flat, tiny, d)
            ta, tb = (lo - o) / safe, (hi - o) / safe
            inside = (o >= lo) & (o <= hi)
            near = torch.where(flat, torch.where(inside, -far, far),
                               torch.minimum(ta, tb))
            farther = torch.where(flat, torch.where(inside, far, -far),
                                  torch.maximum(ta, tb))
            spans.append((near, farther))
        t_in = torch.clamp(torch.maximum(spans[0][0], spans[1][0]), min=0.0)
        t_out = torch.minimum(spans[0][1], spans[1][1])
        hit = (t_in <= t_out) & (t_in > 0) & col(live[:, k])
        best = torch.minimum(best, torch.where(hit, t_in, far))
    return best


def tof_frame(room, boxes, live, x, y, yaw_deg, normal, uniform,
              noise_mm: float, dropout_p: float, tof) -> torch.Tensor:
    """The four sensors' 8 x 8 zones in mm as int32 [B, 4, 8, 8]: the
    column's distance in every row, plus noise, rounded, saturated
    (> 60 m: no target), with dropouts."""
    B = x.shape[0]
    ang = (yaw_deg[:, None] + fan_degrees(tof).to(x.device)) * DEG2RAD
    d = trace_rays(room, boxes, live, x, y, ang)
    mm = (d.reshape(B, 4, 1, 8) * 1000.0).expand(B, 4, 8, 8)
    if noise_mm > 0:
        mm = mm + normal.to(x.device) * f32(noise_mm)
    cells = torch.clamp(torch.round(mm), 1, 65000).to(torch.int32)
    cells = torch.where(mm > 60000.0, NO_TARGET, cells)
    if dropout_p > 0:
        cells = torch.where(uniform.to(x.device) < f32(dropout_p), NO_TARGET,
                            cells)
    return cells


# ---------------------------------------------------------- frontier

def frontier_steps(m) -> np.ndarray:
    """The C loop's distances: d = step; d <= range; d += step, summed in
    float32."""
    step = F32(m.res_m) * F32(FR_STEP_CELLS)
    out, d = [], step
    while d <= F32(FR_RANGE_M):
        out.append(d)
        d = F32(d + step)
    return np.asarray(out, np.float32)


def frontier(grids, x, y, yaw_deg, ox, oy, inited, cfg: Config):
    """Scores int32 [B, 4] of the F, R, L, B query directions: three rays
    each, unknown cells x3 + free x1 - occupied x4 over the cells the
    rays step on inside the map."""
    m, g = cfg.map, cfg.geom
    dev = grids.device
    dists = torch.from_numpy(frontier_steps(m)).to(dev)
    q = torch.tensor(FR_QUERIES_DEG, dtype=torch.float32, device=dev)
    r = torch.tensor(FR_RAYS_DEG, dtype=torch.float32, device=dev)
    ang = ((yaw_deg[:, None] + q)[:, :, None] + r) * DEG2RAD       # [B, 4, 3]
    px = x[:, None, None, None] + dists * cos_f32(ang)[..., None]
    py = y[:, None, None, None] + dists * sin_f32(ang)[..., None]
    e = lambda a: a[:, None, None, None]                           # noqa: E731
    cx, cy = world_to_cell(px, py, e(ox), e(oy), m.res_m, m.width // 2,
                           m.height // 2)
    inside = (cx >= 0) & (cx < m.width) & (cy >= 0) & (cy < m.height)
    rows = cy.clamp(0, m.height - 1).long() + g.pad
    cols = cx.clamp(0, m.width - 1).long() + g.pad
    b = torch.arange(grids.shape[0], device=dev)
    v = grids[e(b), rows, cols].to(torch.int32)
    use = inside & e(inited)
    n_unknown = (use & (v.abs() <= FR_UNKNOWN_BAND)).sum(dim=(-1, -2))
    n_occ = (use & (v > FR_OCC)).sum(dim=(-1, -2))
    n_free = (use & (v < FR_FREE)).sum(dim=(-1, -2))
    return (n_unknown * FR_W_UNKNOWN + n_free * FR_W_FREE
            - n_occ * FR_W_OCC).to(torch.int32)


# -------------------------------------------------------- the machine

MACHINE_FIELDS = {
    # name: (dtype, value at power-up)
    "st": (torch.int32, WAIT_LINK), "yaw_tv": (torch.bool, False),
    "yaw_t": (torch.float32, 0.0), "hover_valid": (torch.bool, False),
    "hover_x": (torch.float32, math.nan), "hover_y": (torch.float32, math.nan),
    "hover_z": (torch.float32, math.nan),
    "hover_yaw": (torch.float32, math.nan), "hover_enter": (torch.int32, 0),
    "turn_init": (torch.bool, False), "turn_dir": (torch.int32, RIGHT),
    "turn_target": (torch.float32, 0.0), "turn_start": (torch.int32, 0),
    "turn_forced": (torch.bool, False), "forced_dir": (torch.int32, RIGHT),
    "ceiling": (torch.bool, False), "alt": (torch.float32, math.nan),
    "alt_src": (torch.int32, ALT_NONE), "to_sent": (torch.bool, False),
    "to_sent_ms": (torch.int32, 0), "to_no_vel_until": (torch.int32, 0),
    "to_started": (torch.bool, False), "to_started_ms": (torch.int32, 0),
    "to_nsp": (torch.bool, False), "ramp_on": (torch.bool, False),
    "ramp_start": (torch.int32, 0), "ramp_last": (torch.int32, 0),
    "as_start": (torch.int32, 0), "as_last": (torch.int32, 0),
    "as_base": (torch.bool, False), "as_mot0": (torch.float32, math.nan),
    "as_warned": (torch.bool, False), "land_sent": (torch.bool, False),
    "land_sent_ms": (torch.int32, 0), "b_low": (torch.int32, 0),
    "b_emerg": (torch.int32, 0), "b_warn": (torch.int32, 0),
    "xy_since": (torch.int32, 0), "lim_arm": (torch.int32, 0),
    "lim_mode": (torch.int32, 0), "lim_disarm": (torch.int32, 0),
    "fr_eval": (torch.int32, 0), "ex_pause": (torch.int32, 0),
    "armed_prev": (torch.bool, False), "kf": (torch.int32, 0),
    "print_last": (torch.int32, 0),
}


def machine_init(B: int, device) -> dict:
    m = {k: torch.full((B,), v, dtype=dt, device=device)
         for k, (dt, v) in MACHINE_FIELDS.items()}
    m["tof_filt"] = torch.full((B, 4), math.nan, dtype=torch.float32,
                               device=device)
    return m


def wrap180(d):
    """[-180, 180) in float32 (:585-589) for |d| < 540."""
    for _ in range(2):
        d = torch.where(d >= 180.0, d - 360.0, d)
    for _ in range(2):
        d = torch.where(d < -180.0, d + 360.0, d)
    return d


class Tick:
    """One control_tick of the batch: the machine's fields M (updated in
    place), the telemetry tm, and the outputs it builds."""

    def __init__(self, M: dict, tm: dict, bh, of_min_q: int):
        self.M, self.tm, self.bh = M, tm, bh
        self.of_min_q = of_min_q
        t = tm["t_ms"]
        self.t = t
        B, dev = t.shape, t.device
        self.B, self.dev = B, dev
        self.out = {
            "cmd_kind": torch.zeros(B, dtype=torch.int32, device=dev),
            "cmd": torch.zeros(B + (4,), dtype=torch.float32, device=dev),
            "req_mode": torch.full(B, -1, dtype=torch.int32, device=dev),
            "req_arm": torch.full(B, -1, dtype=torch.int32, device=dev),
            "req_takeoff": torch.full(B, math.nan, dtype=torch.float32,
                                      device=dev),
            "rc_release": torch.zeros(B, dtype=torch.bool, device=dev),
            "clear_ack": torch.zeros(B, dtype=torch.bool, device=dev),
            "map_init": torch.zeros(B, dtype=torch.bool, device=dev),
            "map_ox": torch.full(B, math.nan, dtype=torch.float32, device=dev),
            "map_oy": torch.full(B, math.nan, dtype=torch.float32, device=dev),
        }
        age = lambda k: t - tm[k]                                  # noqa: E731
        self.sys_fresh = tm["have_sys"] & (age("sys_last_ms") < SYS_FRESH_MS)
        self.of_fresh = tm["have_of"] & (age("of_last_ms") < OF_FRESH_MS)
        self.lpos_fresh = tm["have_lpos"] & (age("lpos_last_ms")
                                             < LPOS_FRESH_MS)
        self.rf_fresh = tm["have_rf"] & (age("rf_last_ms") < RF_FRESH_MS)
        self.batt_fresh = ((tm["batt_last_ms"] != 0)
                           & (age("batt_last_ms") < BATT_FRESH_MS)
                           & torch.isfinite(tm["batt_vpc"])
                           & (tm["batt_cells"] > 0))
        self.servo_250 = tm["have_servo"] & (age("servo_last_ms") < 250)
        self.servo_200 = tm["have_servo"] & (age("servo_last_ms") < 200)

    # -- helpers of uav_local_nav.c --
    def set(self, key, cond, val):
        self.M[key] = torch.where(cond, val, self.M[key])

    def health(self, bit):
        """sys_bit_ok: a stale SYS_STATUS passes."""
        return ~self.sys_fresh | ((self.tm["sys_health"] & bit) != 0)

    def enter_state(self, ns: int, cond):
        """enter_state (:1642-1698), for the quads where cond holds and the
        state is another."""
        M, t = self.M, self.t
        go = cond & (M["st"] != ns)
        self.out["rc_release"] |= go & (M["st"] == LIFTOFF_ASSIST)
        if ns == TAKEOFF:
            for k in ("to_sent", "to_started", "to_nsp", "ramp_on"):
                self.set(k, go, False)
            for k in ("to_sent_ms", "to_no_vel_until", "to_started_ms",
                      "ramp_start", "ramp_last"):
                self.set(k, go, 0)
            self.out["clear_ack"] |= go
            self.set("kf", go, M["kf"] | KF_TAKEOFF)
        elif ns == LIFTOFF_ASSIST:
            self.set("as_start", go, t)
            self.set("as_last", go, 0)
            self.set("as_base", go, False)
            self.set("as_mot0", go, math.nan)
            self.set("as_warned", go, False)
            self.set("kf", go, M["kf"] | KF_LIFTOFF)
        elif ns == HOVER:
            self.set("hover_enter", go, t)
            self.set("hover_valid", go, False)
        elif ns == LANDING:
            self.set("land_sent", go, False)
            self.set("land_sent_ms", go, 0)
            self.set("kf", go, M["kf"] | KF_LAND_START)
        left_turn = go & (M["st"] == TURNING)
        self.set("turn_init", left_turn, False)
        self.set("kf", left_turn, M["kf"] | KF_TURN_END)
        self.set("ex_pause", left_turn, t + self.bh.post_turn_pause_ms)
        if ns == TURNING:
            self.set("kf", go, M["kf"] | KF_TURN_START)
        self.set("st", go, ns)

    def _limited(self, lim: str, cond):
        """A command rate-limited to one per 800 ms by its own timer."""
        ok = cond & self.tm["have_fc"] & (self.t - self.M[lim] >= 800)
        self.set(lim, ok, self.t)
        return ok

    def send_mode(self, mode: int, cond):
        ok = self._limited("lim_mode", cond)
        self.out["req_mode"] = torch.where(ok, mode, self.out["req_mode"])

    def send_arm(self, cond):
        ok = self._limited("lim_arm", cond)
        self.out["req_arm"] = torch.where(ok, 1, self.out["req_arm"])

    def send_disarm(self, cond):
        ok = self._limited("lim_disarm", cond)
        self.out["req_arm"] = torch.where(ok, 0, self.out["req_arm"])

    def command(self, cond, kind: int, *vals):
        v = torch.stack([a.to(torch.float32).expand(self.B)
                         if torch.is_tensor(a)
                         else torch.full(self.B, f32(a), device=self.dev)
                         for a in vals], dim=-1)
        self.out["cmd_kind"] = torch.where(cond, kind, self.out["cmd_kind"])
        self.out["cmd"] = torch.where(cond[:, None], v, self.out["cmd"])

    def xy_allowed(self):
        tm, alt = self.tm, self.M["alt"]
        return (self.health(XY_CTRL) & tm["have_att"] & self.lpos_fresh
                & ~(self.of_fresh & (tm["of_q"] < self.of_min_q))
                & ~(torch.isfinite(alt) & (alt < f32(XY_MIN_ALT_M))))

    def xy_stable(self, called):
        """vel_xy_stable (:952-986): a hold timer that starts when the XY
        gates pass and resets when they fail, for the quads that call."""
        ok = self.xy_allowed()
        self.set("xy_since", called & ok & (self.M["xy_since"] == 0), self.t)
        self.set("xy_since", called & ~ok, 0)
        return (ok & (self.M["xy_since"] != 0)
                & (self.t - self.M["xy_since"] >= XY_STABLE_HOLD_MS))

    def yaw_hold(self):
        """The yaw-rate command that holds the yaw target (:860-870)."""
        err = wrap180(self.M["yaw_t"] - self.tm["yaw_deg"])
        lim = f32(self.bh.yaw_rate_dps)
        rate = torch.clamp(err * f32(self.bh.yaw_hold_gain), -lim, lim)
        return torch.where(self.M["yaw_tv"] & self.tm["have_att"], rate, 0.0)


def control_tick(M: dict, tm: dict, bh, bt, cfg: Config) -> dict:
    """control_tick (:1866-2333) for the batch: M updated in place, the
    outputs returned (with the state and keyframe flags after the tick)."""
    k = Tick(M, tm, bh, cfg.gates.of_min_quality)
    t, out = k.t, k.out
    W = torch.where

    # update_alt_estimate (:1440-1470): ground, then LPOS, then RF
    alt = M["alt"]
    src = torch.full(k.B, ALT_NONE, dtype=torch.int32, device=k.dev)
    grounded = tm["have_ext"] & (tm["landed_state"] == ON_GROUND)
    alt, src = W(grounded, 0.0, alt), W(grounded, ALT_GND, src)
    alt = W(k.lpos_fresh, torch.clamp(tm["lpos_alt_filt"], 0.0, 10.0), alt)
    src = W(k.lpos_fresh, ALT_LPOS, src)
    rf_ok = k.rf_fresh & torch.isfinite(tm["rf_m"])
    alt = W(rf_ok, torch.clamp(tm["rf_m"], 0.0, 10.0), alt)
    src = W(rf_ok, ALT_RF, src)
    M["alt"], M["alt_src"] = alt, src
    known = torch.isfinite(alt)
    k.set("ceiling", known & (alt >= f32(CEIL_M)), True)
    k.set("ceiling", known & (alt <= f32(F32(CEIL_M) - F32(CEIL_RELEASE_M))),
          False)

    # the ToF filter (:1430-1438)
    M["tof_filt"] = tof_filter_update(M["tof_filt"], tm["tof_min"],
                                      cfg.tof.filt_alpha)

    # battery_failsafe_tick (:1797-1837)
    vpc = tm["batt_vpc"]
    landed = k.batt_fresh & ~tm["fc_armed"]
    k.set("b_warn", landed & tm["want_arm"] & (vpc < f32(bt.arm_min_vpc))
          & (t - M["b_warn"] > bt.low_hold_ms), t)
    k.set("b_low", landed, 0)
    k.set("b_emerg", landed, 0)
    flying = k.batt_fresh & tm["fc_armed"]
    for lim, stamp, flag in ((bt.emerg_vpc, "b_emerg", KF_BATT_EMERG),
                             (bt.land_vpc, "b_low", KF_BATT_LAND)):
        low = flying & (vpc < f32(lim))
        k.set(stamp, low & (M[stamp] == 0), t)
        trip = low & (M[stamp] != 0) & (t - M[stamp] > bt.low_hold_ms)
        k.set("kf", trip, M["kf"] | flag)
        if bt.land_actions_enabled:
            k.enter_state(LANDING, trip & (M["st"] != LANDING)
                          & (M["st"] != DISARMING))
        k.set(stamp, flying & ~low, 0)

    # the 2 Hz status print calls vel_xy_stable (:1886-1889)
    due = t - M["print_last"] >= 500
    k.set("print_last", due, t)
    k.xy_stable(due)

    # guards before the switch
    no_link = ~tm["have_fc"]
    k.enter_state(WAIT_LINK, no_link)
    nogo = ~no_link & k.sys_fresh & (~k.health(GYRO) | ~k.health(MOTORS))
    k.enter_state(DISARMING, nogo & tm["fc_armed"])
    k.enter_state(IDLE, nogo & ~tm["fc_armed"])
    live = ~no_link & ~nogo
    k.enter_state(IDLE, live & M["armed_prev"] & ~tm["fc_armed"]
                  & tm["want_arm"] & (M["st"] != LANDING)
                  & (M["st"] != DISARMING) & (M["st"] != IDLE))
    k.set("armed_prev", live, tm["fc_armed"])
    k.enter_state(DISARMING, live & ~tm["want_arm"] & tm["fc_armed"])
    ceiling = live & M["ceiling"] & tm["fc_armed"]
    k.command(ceiling, CMD_VEL_NED, 0.0, 0.0, bh.ceiling_descend_mps, 0.0)
    live = live & ~ceiling

    st = M["st"].clone()
    in_state = lambda s: live & (st == s)                          # noqa: E731
    k.enter_state(IDLE, in_state(WAIT_LINK))
    arm_ok = ~k.batt_fresh | (vpc >= f32(bt.arm_min_vpc))

    # IDLE (:2035-2042)
    idle = in_state(IDLE) & ~(tm["want_arm"] & ~arm_ok)
    k.enter_state(ARMING, idle & tm["want_arm"] & ~tm["fc_armed"])
    k.enter_state(DISARMING, idle & ~tm["want_arm"] & tm["fc_armed"])
    k.enter_state(TAKEOFF, idle & tm["want_arm"] & tm["fc_armed"])

    # ARMING (:2044-2055)
    arming = in_state(ARMING)
    k.enter_state(IDLE, arming & ~arm_ok)
    ask = arming & arm_ok & ~tm["fc_armed"]
    k.send_mode(MODE_GUIDED, ask)
    k.send_arm(ask)
    k.enter_state(TAKEOFF, arming & arm_ok & tm["fc_armed"])

    _takeoff(k, in_state(TAKEOFF))
    _liftoff_assist(k, in_state(LIFTOFF_ASSIST))

    # HOVER (:2175-2202)
    hov = in_state(HOVER)
    grab = hov & ~M["yaw_tv"] & tm["have_att"]
    k.set("yaw_tv", grab, True)
    k.set("yaw_t", grab, tm["yaw_deg"])
    steady = k.xy_stable(hov)
    lock = (hov & steady & ~M["hover_valid"] & k.lpos_fresh & tm["have_att"]
            & torch.isfinite(M["alt"]))
    k.set("hover_x", lock, tm["lpos_x"])
    k.set("hover_y", lock, tm["lpos_y"])
    k.set("hover_z", lock, -M["alt"])
    k.set("hover_yaw", lock, W(M["yaw_tv"], M["yaw_t"], tm["yaw_deg"]))
    k.set("hover_valid", lock, True)
    hold = hov & steady & M["hover_valid"] & k.lpos_fresh & tm["have_att"]
    k.command(hold, CMD_POS_YAW, M["hover_x"], M["hover_y"], M["hover_z"],
              M["hover_yaw"])
    k.command(hov & ~hold, CMD_VEL_BODY, 0.0, 0.0, 0.0, k.yaw_hold())
    first_map = hov & ~tm["map_inited"] & steady & M["hover_valid"]
    out["map_init"] |= first_map
    out["map_ox"] = W(first_map, M["hover_x"], out["map_ox"])
    out["map_oy"] = W(first_map, M["hover_y"], out["map_oy"])
    if bh.explore_enabled and not bh.hover_test_only:
        k.enter_state(EXPLORE, hov & steady & (t - M["hover_enter"]
                                               > bh.hover_explore_delay_ms))

    _explore(k, in_state(EXPLORE))
    _turning(k, in_state(TURNING))

    # LANDING (:2298-2317)
    lnd = in_state(LANDING)
    first = lnd & ~M["land_sent"]
    k.send_mode(MODE_LAND, first)
    k.set("land_sent", first, True)
    k.set("land_sent_ms", first, t)
    again = lnd & ~first & (t - M["land_sent_ms"] > 2000)
    k.send_mode(MODE_LAND, again)
    k.set("land_sent_ms", again, t)
    k.command(lnd, CMD_VEL_NED, 0.0, 0.0, bh.landing_descent_mps, 0.0)
    down = ((torch.isfinite(M["alt"])
             & (M["alt"] < f32(bh.landing_near_ground_m)))
            | (tm["have_ext"] & (tm["landed_state"] == ON_GROUND)))
    k.enter_state(DISARMING, lnd & down)

    # DISARMING (:2319-2327)
    dis = in_state(DISARMING)
    k.send_disarm(dis & tm["fc_armed"])
    k.enter_state(IDLE, dis & ~tm["fc_armed"])

    out["state"], out["kf_flags"] = M["st"], M["kf"]
    out["alt_est"] = M["alt"]
    return out


def _takeoff(k: Tick, tko):
    """TAKEOFF (:2057-2169): NAV_TAKEOFF with retries, the attitude ramp
    when the motors do not start, the stall exits to the liftoff assist,
    and HOVER at the target altitude."""
    M, tm, bh, t, out = k.M, k.tm, k.bh, k.t, k.out
    W = torch.where
    k.send_mode(MODE_GUIDED, tko & (tm["hb_custom_mode"] != MODE_GUIDED))
    refused = (tko & tm["have_takeoff_ack"] & (t - tm["takeoff_ack_ms"] < 2000)
               & ((tm["takeoff_ack_res"] == ACK_DENIED)
                  | (tm["takeoff_ack_res"] == ACK_TEMP_REJECTED)))
    k.enter_state(LIFTOFF_ASSIST, refused)
    tko = tko & ~refused
    target = f32(bh.takeoff_target_m)
    first = tko & ~M["to_sent"]
    out["req_takeoff"] = W(first, target, out["req_takeoff"])
    k.set("to_sent", first, True)
    k.set("to_sent_ms", first, t)
    k.set("to_no_vel_until", first, t + bh.takeoff_no_vel_ms)
    resend = (tko & ~first & ~M["to_started"]
              & (t - M["to_sent_ms"] > bh.takeoff_retry_ms))
    out["req_takeoff"] = W(resend, target, out["req_takeoff"])
    k.set("to_sent_ms", resend, t)
    k.set("to_no_vel_until", resend, t + bh.takeoff_no_vel_ms)

    spin = f32(bh.takeoff_mot_start_us)
    exit_m = f32(bh.ramp_exit_m)
    mot = W(k.servo_250, tm["motor_avg"], math.nan)
    spinning = k.servo_250 & (mot > spin)
    airborne = ((tm["have_ext"] & (tm["landed_state"] != ON_GROUND))
                | (k.rf_fresh & torch.isfinite(tm["rf_m"])
                   & (tm["rf_m"] > exit_m))
                | (torch.isfinite(M["alt"]) & (M["alt"] > exit_m)))
    started = tko & ~M["to_started"] & (spinning | airborne)
    k.set("to_started", started, True)
    k.set("to_started_ms", started, t)

    acked = W(tm["takeoff_accept_ms"] != 0, tm["takeoff_accept_ms"],
              tm["takeoff_ack_ms"])
    ramp = (tko & ~M["to_started"] & tm["have_takeoff_ack"]
            & (tm["takeoff_ack_res"] == ACK_ACCEPTED) & ~M["ramp_on"]
            & ~M["to_nsp"] & (acked != 0)
            & (t - acked >= bh.takeoff_start_check_ms)
            & k.servo_250 & (mot <= spin))
    k.set("to_nsp", ramp, True)
    k.set("ramp_on", ramp, True)
    k.set("ramp_start", ramp, t)
    k.set("ramp_last", ramp, 0)

    ramping = tko & M["ramp_on"]
    grab = ramping & ~M["yaw_tv"] & tm["have_att"]
    k.set("yaw_tv", grab, True)
    k.set("yaw_t", grab, tm["yaw_deg"])
    k.set("ramp_start", ramping & (M["ramp_start"] == 0), t)
    send = ramping & (t - M["ramp_last"] >= bh.ramp_send_ms)
    k.set("ramp_last", send, t)
    el = (t - M["ramp_start"]).to(torch.float32)
    u = torch.clamp(W(el >= bh.ramp_total_ms, 1.0,
                      div_f32(el, f32(float(bh.ramp_total_ms)))), 0.0, 1.0)
    thrust = (1.0 - u) * f32(bh.ramp_thr_min) + u * f32(bh.ramp_thr_max)
    yaw = W(M["yaw_tv"], M["yaw_t"], W(tm["have_att"], tm["yaw_deg"], 0.0))
    k.command(send, CMD_ATT,
              torch.clamp(thrust, min=0.0).clamp(max=f32(bh.thrust_clamp)),
              yaw, 0.0, 0.0)
    lifted = ramping & (airborne | (k.servo_250 & (mot > spin)))
    k.set("ramp_on", lifted, False)
    k.set("to_started", lifted, True)
    k.set("to_started_ms", lifted, t)
    out["req_takeoff"] = W(lifted, target, out["req_takeoff"])
    k.set("to_no_vel_until", lifted, t + bh.takeoff_no_vel_ms)
    give_up = ramping & ~lifted & (t - M["ramp_start"] > bh.ramp_abort_ms)
    k.set("ramp_on", give_up, False)
    k.enter_state(LIFTOFF_ASSIST, give_up)
    tko = tko & ~ramping

    stuck = (tko & ~k.health(Z_CTRL) & ~M["to_started"]
             & torch.isfinite(M["alt"]) & (M["alt"] < f32(0.10))
             & (t - M["to_sent_ms"] > 1200))
    k.enter_state(LIFTOFF_ASSIST, stuck)
    tko = tko & ~stuck
    stalled = tko & ~M["to_started"] & (t - M["to_sent_ms"]
                                        > bh.takeoff_stall_ms)
    k.enter_state(LIFTOFF_ASSIST, stalled)
    tko = tko & ~stalled
    there = (tko & torch.isfinite(M["alt"])
             & (M["alt"] >= f32(F32(bh.takeoff_target_m)
                                - F32(bh.takeoff_exit_margin_m))))
    k.set("yaw_tv", there, tm["have_att"])
    k.set("yaw_t", there, W(tm["have_att"], tm["yaw_deg"], 0.0))
    k.enter_state(HOVER, there)


def _liftoff_assist(k: Tick, ast):
    """LIFTOFF_ASSIST (:1738-1789): STABILIZE and an RC throttle ramp
    until the quad is off the ground, then GUIDED and TAKEOFF again."""
    M, tm, bh, t, out = k.M, k.tm, k.bh, k.t, k.out
    W = torch.where
    k.send_mode(MODE_STABILIZE, ast & (t - M["as_start"] < 150))
    base = ast & ~M["as_base"] & k.servo_200
    k.set("as_mot0", base, tm["motor_avg"])
    k.set("as_base", base, True)
    send = ast & (t - M["as_last"] >= bh.assist_send_period_ms)
    k.set("as_last", send, t)
    el = (t - M["as_start"]).to(torch.float32)
    u = torch.clamp(W(el >= bh.assist_total_ms, 1.0,
                      div_f32(el, f32(float(bh.assist_total_ms)))), 0.0, 1.0)
    thr = torch.round((1.0 - u) * f32(float(bh.assist_thr_us_min))
                      + u * f32(float(bh.assist_thr_us_max)))
    k.command(send, CMD_RC, 1500.0, 1500.0, thr, 1500.0)
    weak = (ast & ~M["as_warned"] & M["as_base"]
            & (t - M["as_start"] > bh.assist_override_effect_ms)
            & k.servo_200 & torch.isfinite(M["as_mot0"])
            & (tm["motor_avg"] - M["as_mot0"]
               < f32(bh.assist_motor_delta_min)))
    k.set("as_warned", weak, True)
    up = ast & torch.isfinite(M["alt"]) & (M["alt"]
                                           > f32(bh.assist_exit_alt_m))
    out["rc_release"] |= up
    k.send_mode(MODE_GUIDED, up)
    out["req_takeoff"] = W(up, f32(bh.takeoff_target_m), out["req_takeoff"])
    k.enter_state(TAKEOFF, up)
    give_up = ast & ~up & (t - M["as_start"] > bh.assist_abort_ms)
    out["rc_release"] |= give_up
    k.enter_state(DISARMING, give_up)


def _explore(k: Tick, exp):
    """EXPLORE (:2204-2257): fly forward holding the yaw; turn when the
    front is close, or towards a side whose frontier score beats the
    front's by the margin."""
    M, tm, bh, t = k.M, k.tm, k.bh, k.t
    W = torch.where
    steady = k.xy_stable(exp)
    wait = exp & (~steady | (t < M["ex_pause"]))
    k.command(wait, CMD_VEL_BODY, 0.0, 0.0, 0.0, k.yaw_hold())
    go = exp & ~wait
    front = M["tof_filt"][:, FRONT]
    close = go & torch.isfinite(front) & (front < f32(bh.front_stop_m))
    k.set("turn_forced", close, False)
    k.enter_state(TURNING, close)
    go = go & ~close
    due = (go & tm["map_inited"] & k.lpos_fresh & tm["have_att"]
           & (t - M["fr_eval"] > bh.frontier_eval_ms))
    k.set("fr_eval", due, t)
    sf, sr, sl, sb = (tm[n] for n in ("frontier_f", "frontier_r",
                                      "frontier_l", "frontier_b"))
    fr = torch.maximum(sf, sr)
    frl = torch.maximum(fr, sl)
    best = torch.maximum(frl, sb)
    side = torch.full(k.B, FRONT, dtype=torch.int32, device=k.dev)
    side = W(sr > sf, RIGHT, side)
    side = W(sl > fr, LEFT, side)
    side = W(sb > frl, BACK, side)
    room = M["tof_filt"].gather(1, side[:, None].long())[:, 0]
    turn = (due & (side != FRONT) & (best > sf + bh.frontier_side_margin)
            & torch.isfinite(room) & (room > f32(bh.side_safe_m)))
    k.set("turn_forced", turn, True)
    k.set("forced_dir", turn, side)
    k.enter_state(TURNING, turn)
    k.command(go & ~turn, CMD_VEL_BODY, bh.fwd_vel_mps, 0.0, 0.0,
              k.yaw_hold())


def _turning(k: Tick, trn):
    """TURNING (:2259-2296): pick a direction once (the forced one, else
    choose_turn_dir_frontier :1715-1736 with the open-side fallback
    :1700-1713), then yaw 90 or 180 degrees and go back to EXPLORE."""
    M, tm, bh, t = k.M, k.tm, k.bh, k.t
    W = torch.where
    start = trn & ~M["turn_init"]
    filt = M["tof_filt"]
    bias = f32(bh.frontier_tof_bias)
    scored = [tm[n] + (W(torch.isnan(filt[:, d]), 0.0, filt[:, d]) * bias
                       ).to(torch.int32)
              for n, d in (("frontier_r", RIGHT), ("frontier_l", LEFT),
                           ("frontier_b", BACK))]
    by_map = torch.full(k.B, RIGHT, dtype=torch.int32, device=k.dev)
    by_map = W(scored[1] > scored[0], LEFT, by_map)
    by_map = W(scored[2] > torch.maximum(scored[0], scored[1]), BACK, by_map)
    widest = torch.full(k.B, -1.0, device=k.dev)
    by_tof = torch.full(k.B, RIGHT, dtype=torch.int32, device=k.dev)
    for d in (RIGHT, LEFT, BACK):
        wider = torch.isfinite(filt[:, d]) & (filt[:, d] > widest)
        widest = W(wider, filt[:, d], widest)
        by_tof = W(wider, d, by_tof)
    mapped = tm["map_inited"] & k.lpos_fresh & tm["have_att"]
    pick = W(M["turn_forced"], M["forced_dir"], W(mapped, by_map, by_tof))
    k.set("turn_dir", start, pick)
    k.set("turn_forced", start & M["turn_forced"], False)
    yaw = W(tm["have_att"], tm["yaw_deg"], 0.0)
    by = W(M["turn_dir"] == RIGHT, 90.0, W(M["turn_dir"] == LEFT, -90.0,
                                            180.0))
    k.set("turn_target", start, wrap180(yaw + by))
    k.set("turn_start", start, t)
    k.set("turn_init", start, True)
    err = wrap180(M["turn_target"] - yaw)
    lim = f32(bh.yaw_rate_dps)
    k.command(trn, CMD_VEL_BODY, 0.0, 0.0, 0.0,
              torch.clamp(err * f32(bh.turn_gain), -lim, lim))
    done = trn & ((err.abs() < f32(bh.turn_exit_err_deg))
                  | (t - M["turn_start"] > bh.turn_timeout_ms))
    k.set("yaw_tv", done, True)
    k.set("yaw_t", done, M["turn_target"])
    k.set("turn_init", done, False)
    k.enter_state(EXPLORE, done)


# ---------------------------------------------------------- the swarm

class Quads(NamedTuple):
    """The true state and what the FC model keeps between ticks (all
    [B])."""

    x: torch.Tensor
    y: torch.Tensor
    yaw: torch.Tensor           # deg
    vx: torch.Tensor
    vy: torch.Tensor
    alt: torch.Tensor
    armed: torch.Tensor
    mode: torch.Tensor
    motor: torch.Tensor
    to_active: torch.Tensor
    to_target: torch.Tensor
    have_ack: torch.Tensor
    ack_res: torch.Tensor
    ack_ms: torch.Tensor
    accept_ms: torch.Tensor
    pos_cmd: torch.Tensor       # [B, 3] the last position setpoint


def _start(x0, y0, yaw0, airborne: bool):
    """The quads at their start poses: on the ground, disarmed; or
    airborne mid-mission at the hover altitude, armed in GUIDED with the
    motors at 1500."""
    z = lambda dt=torch.float32: torch.zeros_like(x0, dtype=dt)    # noqa: E731
    return Quads(
        x=x0, y=y0, yaw=yaw0, vx=z(), vy=z(),
        alt=torch.full_like(x0, f32(HOVER_ALT_M)) if airborne else z(),
        armed=torch.full_like(x0, airborne, dtype=torch.bool),
        mode=torch.full_like(x0, MODE_GUIDED if airborne else 0,
                             dtype=torch.int32),
        motor=torch.full_like(x0, 1500.0 if airborne else 1000.0),
        to_active=z(torch.bool), to_target=z(), have_ack=z(torch.bool),
        ack_res=z(torch.int32), ack_ms=z(torch.int32),
        accept_ms=z(torch.int32),
        pos_cmd=torch.zeros(x0.shape + (3,), device=x0.device))


def _telemetry(q: Quads, t, est_x, est_y, of_q, tof_min, inited, scores):
    """What the FC link and the sensors report to the companion."""
    B, dev = q.x.shape, q.x.device
    yes = torch.ones(B, dtype=torch.bool, device=dev)
    now = torch.full(B, t, dtype=torch.int32, device=dev)
    up = q.alt > 0.05
    return {
        "t_ms": now, "have_fc": yes, "fc_armed": q.armed,
        "hb_custom_mode": q.mode, "have_ext": yes,
        "landed_state": torch.where(up, 2, ON_GROUND).to(torch.int32),
        "have_sys": yes, "sys_last_ms": now,
        "sys_health": torch.full(B, HEALTH_ALL, dtype=torch.int32,
                                 device=dev),
        "have_servo": yes, "servo_last_ms": now, "motor_avg": q.motor,
        "batt_vpc": q.motor.new_full(B, f32(BATT_V)) * 0.5,
        "batt_cells": torch.full(B, BATT_CELLS, dtype=torch.int32,
                                 device=dev),
        "batt_last_ms": now, "have_lpos": yes, "lpos_last_ms": now,
        "lpos_x": est_x, "lpos_y": est_y, "lpos_alt_filt": q.alt,
        "have_att": yes, "yaw_deg": q.yaw, "have_of": yes, "of_last_ms": now,
        "of_q": of_q, "have_rf": up,
        "rf_last_ms": torch.where(up, now, torch.clamp(now - 1000, min=0)),
        "rf_m": torch.where(up, q.alt, math.nan), "want_arm": yes,
        "have_takeoff_ack": q.have_ack, "takeoff_ack_res": q.ack_res,
        "takeoff_ack_ms": q.ack_ms, "takeoff_accept_ms": q.accept_ms,
        "tof_min": tof_min, "map_inited": inited,
        "frontier_f": scores[:, 0], "frontier_r": scores[:, 1],
        "frontier_l": scores[:, 2], "frontier_b": scores[:, 3],
    }


def _fly(q: Quads, out: dict, t: int, dt: float, est_x, est_y, room):
    """The FC applies the machine's requests and command; the dynamics
    advance the quads by dt."""
    W = torch.where
    now = torch.full_like(q.ack_ms, t)
    mode = W(out["req_mode"] >= 0, out["req_mode"], q.mode)
    armed = W(out["req_arm"] == 1, True, W(out["req_arm"] == 0, False,
                                           q.armed))
    asked = torch.isfinite(out["req_takeoff"])
    clear = out["clear_ack"]
    have_ack = W(clear, False, q.have_ack | asked)
    ack_res = W(asked, 0, q.ack_res)
    ack_ms = W(clear, 0, W(asked, now, q.ack_ms))
    accept_ms = W(clear, 0, W(asked, now, q.accept_ms))
    to_active = q.to_active | asked
    to_target = W(asked, out["req_takeoff"], q.to_target)
    kind, cmd = out["cmd_kind"], out["cmd"]
    body, pos = kind == CMD_VEL_BODY, kind == CMD_POS_YAW
    vset_bx = W(body, cmd[:, 0], 0.0)
    vset_by = W(body, cmd[:, 1], 0.0)
    yaw_rate = W(body, cmd[:, 3], 0.0)
    climb_cmd = W(kind == CMD_VEL_NED, -cmd[:, 2], 0.0)
    pos_cmd = W(pos[:, None], cmd[:, :3], q.pos_cmd)

    dtf = F32(dt)
    up = q.alt > 0.05
    spool = armed & (to_active | up)
    motor = W(armed, W(spool, torch.clamp(q.motor + f32(F32(900.0) * dtf),
                                          max=1600.0), q.motor), 1000.0)
    lifted = armed & (motor > 1150.0)
    climb = torch.zeros_like(q.alt)
    climb = W(to_active & (q.alt < to_target), f32(0.45), climb)
    climb = W(mode == MODE_LAND, f32(-0.35), climb)
    climb = W(climb_cmd != 0, climb_cmd, climb)
    climb = W(pos, torch.clamp((-pos_cmd[:, 2]) - q.alt, f32(-0.3), f32(0.3)),
              climb)
    alt = W(lifted, torch.clamp(q.alt + climb * float(dtf), min=0.0),
            torch.clamp(q.alt - float(dtf), min=0.0))
    to_active = to_active & ~(alt >= to_target)

    yr = q.yaw * DEG2RAD
    c, s = cos_f32(yr), sin_f32(yr)
    gx = c * vset_bx - s * vset_by
    gy = s * vset_bx + c * vset_by
    gx = W(pos, torch.clamp(pos_cmd[:, 0] - est_x, f32(-0.5), f32(0.5)), gx)
    gy = W(pos, torch.clamp(pos_cmd[:, 1] - est_y, f32(-0.5), f32(0.5)), gy)
    moving = lifted & up
    lag = float(min(dtf / F32(0.4), F32(1.0)))
    vx = W(moving, q.vx + (gx - q.vx) * lag, 0.0)
    vy = W(moving, q.vy + (gy - q.vy) * lag, 0.0)
    wall = f32(0.15)
    x = torch.clamp(q.x + vx * float(dtf), room[:, 0] + wall,
                    room[:, 2] - wall)
    y = torch.clamp(q.y + vy * float(dtf), room[:, 1] + wall,
                    room[:, 3] - wall)
    yaw = torch.remainder(q.yaw + W(moving, yaw_rate, 0.0) * float(dtf)
                          + 180.0, 360.0) - 180.0
    return Quads(x, y, yaw, vx, vy, alt, armed, mode, motor, to_active,
                 to_target, have_ack, ack_res, ack_ms, accept_ms, pos_cmd)


def swarm_run(room, boxes, x0, y0, yaw0, seed: int, n_ticks: int,
              cfg: Config, bh, bt, dt_ms: int, scan_period_ms: int,
              noise_mm: float, dropout_p: float, airborne: bool = True,
              lowp: bool = False, t0_ms: int = 0) -> dict:
    """B quads in rooms [B, 4] with boxes [B, K, 4] (NaN rows: none) from
    start poses [B], n_ticks ticks of dt_ms from the mission clock t0_ms,
    a scan every scan_period_ms.  Returns the final grids, poses, EKF mean
    and frontier scores, and per tick the state, command kind, the
    command's first value, EKF position and true yaw [T, B].

    An airborne quad is one mid-mission: in EXPLORE, its XY hold stamped
    at 1 ms and its frontier timer at 0, so that from a clock past their
    periods (1 s, 1.2 s) it explores from its first tick."""
    dev = x0.device
    B = x0.shape[0]
    live = ~torch.isnan(boxes).any(dim=-1)
    boxes = torch.where(live[..., None], boxes, 0.0)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(3):                      # the start poses' draws
        torch.rand(B, generator=gen)
    q = _start(x0, y0, yaw0, airborne)
    M = machine_init(B, dev)
    ekf = ekf_init(B, dev)
    if airborne:
        yes = torch.ones(B, dtype=torch.bool, device=dev)
        M.update(st=torch.full((B,), EXPLORE, dtype=torch.int32, device=dev),
                 yaw_tv=yes, yaw_t=yaw0, hover_valid=yes, hover_x=x0,
                 hover_y=y0, hover_z=-q.alt, hover_yaw=yaw0, alt=q.alt,
                 alt_src=torch.full((B,), ALT_RF, dtype=torch.int32,
                                    device=dev),
                 to_sent=yes, to_started=yes, armed_prev=yes,
                 xy_since=torch.ones((B,), dtype=torch.int32, device=dev))
        mean = ekf.mean.clone()
        mean[:, 0], mean[:, 1], mean[:, 4] = x0, y0, q.alt
        mean[:, 6] = yaw0 * DEG2RAD
        ekf = Ekf(mean, ekf.cov)
    inited = torch.full((B,), airborne, dtype=torch.bool, device=dev)
    ox = x0 if airborne else torch.full_like(x0, math.nan)
    oy = y0 if airborne else torch.full_like(y0, math.nan)
    flat, grids = new_flat_grids(B, cfg, dev)
    tof_min = torch.full((B, 4), math.nan, device=dev)
    scores = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    consts = predict_consts(dev)
    dt = F32(dt_ms * 1e-3)
    dts = torch.full((B,), float(dt), device=dev)
    rec = {k: [] for k in ("state", "cmd_kind", "cmd_x", "est_x", "est_y",
                           "yaw")}
    rnd = lowp_round if lowp else (lambda a: a)
    t = t0_ms
    for _ in range(n_ticks):
        t += dt_ms
        scan = t % scan_period_ms == 0
        if scan:
            shape = (B, 4, 8, 8)
            normal = torch.randn(shape, generator=gen)
            uniform = torch.rand(shape, generator=gen)
            cells = tof_frame(room, boxes, live, q.x, q.y, q.yaw, normal,
                              uniform, noise_mm, dropout_p, cfg.tof)
            beams, tof_min = extract_beams(cells, cfg.tof)
            rays = make_rays(beams, ekf.mean[:, 0], ekf.mean[:, 1], q.yaw,
                             ox, oy, inited, cfg.map, cfg.tof)
            apply_rays_exact(flat, rays, cfg)
        # the flow sensor
        yr = q.yaw * DEG2RAD
        h = torch.clamp(q.alt, min=0.0)
        up = q.alt > 0.05
        c, s = cos_f32(yr), sin_f32(yr)
        over = torch.clamp(h, min=0.05)
        rx = torch.where(h > 0.05, (c * q.vx + s * q.vy) / over, math.nan)
        ry = torch.where(h > 0.05, (-s * q.vx + c * q.vy) / over, math.nan)
        of_q = torch.where(up, FLOW_Q, 0).to(torch.int32)
        ekf = ekf_step(ekf, dts, rx, ry, of_q, h, yr, cfg.ekf, consts)
        mean = ekf.mean.clone()
        mean[:, 0] = torch.where(up, mean[:, 0], q.x)
        mean[:, 1] = torch.where(up, mean[:, 1], q.y)
        ekf = Ekf(rnd(mean), ekf.cov)
        ex, ey = ekf.mean[:, 0], ekf.mean[:, 1]
        if scan:
            scores = frontier(grids, ex, ey, q.yaw, ox, oy, inited, cfg)
        tm = _telemetry(q, t, ex, ey, of_q, tof_min, inited, scores)
        out = control_tick(M, tm, bh, bt, cfg)
        first = out["map_init"] & ~inited
        ox = torch.where(first, out["map_ox"], ox)
        oy = torch.where(first, out["map_oy"], oy)
        inited = inited | first
        q = _fly(q, out, t, dt_ms * 1e-3, ex, ey, room)
        if lowp:
            q = q._replace(x=rnd(q.x), y=rnd(q.y), yaw=rnd(q.yaw))
        for k_, v in (("state", out["state"]), ("cmd_kind", out["cmd_kind"]),
                      ("cmd_x", out["cmd"][:, 0]), ("est_x", ex),
                      ("est_y", ey), ("yaw", q.yaw)):
            rec[k_].append(v)
    res = {k: torch.stack(v) for k, v in rec.items()}
    res.update(grid=grids, x=q.x, y=q.y, yaw_final=q.yaw,
               ekf_mean=ekf.mean, frontier=scores)
    return res
