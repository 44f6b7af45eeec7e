"""Plain reference of the closed-loop swarm flying the clean revision's
hover machine (exie1122/micro-quad-SLAM, `clean_uav_fc_tof_nav.c`): B
simulated quads, each in its own room, tick by tick.

  world   the ToF fans traced against the quad's room and boxes, the
          sensor's millimetres with noise and dropouts     [scan ticks]
  beams   the per-direction minima that feed the ToF filter [scan ticks]
  flow    the flow sensor: body velocity over the ground, quality 85
  EKF     predict and the yaw, rangefinder and flow updates
  machine the clean control tick (:2339-2660) on the FC model's telemetry
  FC      the flight controller applying the machine's requests and
          setpoints, and the dynamics

The world, the beams, the EKF and the FC model and dynamics are
reference/swarm.py's (the UL swarm's reference), imported and not
changed; this module adds the clean tick, the FC model's reading of its
Z+yaw setpoint and the loop.  Floats round as the C float code does
(reference/swarm.py's module docstring).

The clean tick follows the C's sequence: the own-heartbeat timer, the
defensive altitude estimate (:1710-1782), the ToF filter, the battery
failsafe that only logs (:2127-2175), the 10 Hz snapshot timer
(:2350-2357), the guards (link, the enabled-bit-aware hard no-go
:906-933, the unexpected disarm, the user abort's immediate force disarm
:2395-2401, the ceiling override :2403-2419), the hover stale-sensor
hysteresis (:2421-2442) and the switch over the 8 states: IDLE and
ARMING behind the prearm readiness hold (:999-1036, :2449-2489), TAKEOFF
with its delayed attitude ramp and liftoff inference (:2491-2593,
:2098-2119), LIFTOFF_ASSIST (:2038-2095), HOVER's prelock and lock
(hover_hold_tick :1065-1103), LANDING and DISARMING (:2609-2638).  A C
`return` out of the tick is a mask: the quads it covers skip the rest.

Departures from the C, all the simulated swarm's (besides those of
reference/swarm.py's FC model and sensors):
  - the telemetry is fresh and healthy: SYS_STATUS reports every sensor
    enabled and healthy, the 2-cell battery holds 8.2 V and its intake
    latch is valid, so the health, battery and freshness branches never
    trip, though they are here;
  - the rangefinder reports the height at every height and the flow
    sensor quality 85 on the ground too (the clean prearm gate reads
    both before takeoff; the UL swarm's sensors report neither there);
  - the FC model holds the Z+yaw setpoint's altitude: a climb of
    (z - alt) clamped to +/-0.3 m/s, the law of the position setpoint's
    z, with the XY velocity setpoint at zero and the yaw held, and takes
    the attitude-thrust setpoint as it takes the UL ramp's (not at all);
  - the status prints, the snapshot ring's dumps and the flight-data log
    are left out; their timers are kept.

`lowp` is the precision control: it rounds the true pose and the EKF
mean that each tick hands on to bfloat16.
"""

from __future__ import annotations

import math
import types

import torch

from portbench.reference import swarm as RW
from portbench.reference.config import Config
from portbench.reference.grid import (
    F32, div_f32, extract_beams, f32, lowp_round, sqrt_f32,
    tof_filter_update)
from portbench.reference.slam import Ekf, ekf_init, ekf_step, predict_consts

# states (:325-335), setpoints, keyframe flags (:162-169)
(WAIT_LINK, IDLE, ARMING, TAKEOFF, LIFTOFF_ASSIST, HOVER, LANDING,
 DISARMING) = range(8)
CMD_Z_YAW = 6                                  # send_z_yaw_ned (:747-779)
KF_TAKEOFF, KF_LAND_START, KF_LIFTOFF, KF_BATT_LAND, KF_BATT_EMERG = (
    1, 2, 4, 8, 16)
ON_GROUND = RW.ON_GROUND
GYRO, Z_CTRL, XY_CTRL, MOTORS = RW.GYRO, RW.Z_CTRL, RW.XY_CTRL, RW.MOTORS
ALT_NONE, ALT_LPOS, ALT_RF, ALT_GND = range(4)
MODE_GUIDED, MODE_LAND = RW.MODE_GUIDED, RW.MODE_LAND
RAMP_SEND_MS, RAMP_TRIGGER_MS, RAMP_GIVE_UP_MS = 40, 700, 1400   # :2098-2119
INFERRED_MOTOR_US = 150.0          # above the start threshold (:2544-2564)


def clean_config(conf: dict):
    """The configuration file's `behavior`, `battery` and `clean_gates`
    groups as attribute namespaces (the file is what both sides run)."""
    bh, bt = RW.behavior_config(conf)
    return bh, bt, types.SimpleNamespace(**conf["clean_gates"])


# -------------------------------------------------------- the machine

FIELDS = {
    # name: (dtype, value at power-up)
    "st": (torch.int32, WAIT_LINK), "yaw_tv": (torch.bool, False),
    "yaw_t": (torch.float32, 0.0), "alt_max": (torch.float32, math.nan),
    "alt": (torch.float32, math.nan), "alt_src": (torch.int32, ALT_NONE),
    "ceiling": (torch.bool, False), "locked": (torch.bool, False),
    "pre_valid": (torch.bool, False), "pre_x": (torch.float32, 0.0),
    "pre_y": (torch.float32, 0.0), "lock_x": (torch.float32, 0.0),
    "lock_y": (torch.float32, 0.0), "prearm_since": (torch.int32, 0),
    "to_sent": (torch.bool, False), "to_sent_ms": (torch.int32, 0),
    "to_started": (torch.bool, False), "to_started_ms": (torch.int32, 0),
    "to_alt0": (torch.float32, math.nan), "ramp_on": (torch.bool, False),
    "ramp_start": (torch.int32, 0), "ramp_last": (torch.int32, 0),
    "as_start": (torch.int32, 0), "as_last": (torch.int32, 0),
    "as_base": (torch.bool, False), "as_mot0": (torch.float32, math.nan),
    "as_warned": (torch.bool, False), "land_sent": (torch.bool, False),
    "land_sent_ms": (torch.int32, 0), "b_low": (torch.int32, 0),
    "b_emerg": (torch.int32, 0), "b_warn": (torch.int32, 0),
    "xy_since": (torch.int32, 0), "lim_arm": (torch.int32, 0),
    "lim_mode": (torch.int32, 0), "lim_disarm": (torch.int32, 0),
    "lpos_stale": (torch.int32, 0), "rf_stale": (torch.int32, 0),
    "alt_stale": (torch.int32, 0), "armed_prev": (torch.bool, False),
    "kf": (torch.int32, 0), "hb_last": (torch.int32, 0),
    "snap_last": (torch.int32, 0),
}


def machine_init(B: int, device) -> dict:
    m = {k: torch.full((B,), v, dtype=dt, device=device)
         for k, (dt, v) in FIELDS.items()}
    m["tof_filt"] = torch.full((B, 4), math.nan, dtype=torch.float32,
                               device=device)
    return m


class Tick(RW.Tick):
    """One clean control tick of the batch: the machine's fields M
    (updated in place), the telemetry tm, the settings, the outputs.  The
    UL tick's helpers that the clean binary shares are inherited: set,
    health (sys_bit_ok), the 800 ms rate limit, the arm and disarm
    requests, command."""

    def __init__(self, M: dict, tm: dict, bh, bt, gt):
        self.M, self.tm, self.bh, self.bt, self.gt = M, tm, bh, bt, gt
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
            "clear_ack": torch.zeros(B, dtype=torch.bool, device=dev),
        }
        age = lambda k: t - tm[k]                                  # noqa: E731
        self.sys_fresh = tm["have_sys"] & (age("sys_last_ms")
                                           < gt.sys_fresh_ms)
        self.of_fresh = tm["have_of"] & (age("of_last_ms") < gt.of_fresh_ms)
        self.lpos_fresh = tm["have_lpos"] & (age("lpos_last_ms")
                                             < gt.lpos_fresh_ms)
        self.rf_fresh = tm["have_rf"] & (age("rf_last_ms") < gt.rf_fresh_ms)
        self.rf_ok = self.rf_fresh & torch.isfinite(tm["rf_m"])
        self.servo_250 = tm["have_servo"] & (age("servo_last_ms") < 250)
        self.servo_200 = tm["have_servo"] & (age("servo_last_ms") < 200)

    def health_if_enabled(self, bit):
        """The enabled-bit-aware gate (:906-933): a sensor not enabled
        passes."""
        off = (self.tm["sys_enabled"] & bit) == 0
        return ~self.sys_fresh | off | self.health(bit)

    def enter_state(self, ns: int, cond):
        """enter_state (:1957-2031), for the quads where cond holds and the
        state is another."""
        M, t = self.M, self.t
        go = cond & (M["st"] != ns)
        hover = go & ((M["st"] == HOVER) | (ns == HOVER))
        for k in ("locked", "pre_valid"):
            self.set(k, hover, False)
        for k in ("pre_x", "pre_y", "lock_x", "lock_y"):
            self.set(k, hover, 0.0)
        if ns == TAKEOFF:
            for k in ("to_sent", "to_started", "ramp_on"):
                self.set(k, go, False)
            for k in ("to_sent_ms", "to_started_ms", "ramp_start"):
                self.set(k, go, 0)
            self.out["clear_ack"] |= go
            self.set("to_alt0", go, M["alt_max"])
            self.set("kf", go, M["kf"] | KF_TAKEOFF)
        elif ns == LIFTOFF_ASSIST:
            self.set("as_start", go, t)
            self.set("as_last", go, 0)
            self.set("as_base", go, False)
            self.set("as_mot0", go, math.nan)
            self.set("as_warned", go, False)
            self.set("kf", go, M["kf"] | KF_LIFTOFF)
        elif ns == LANDING:
            self.set("land_sent", go, False)
            self.set("land_sent_ms", go, 0)
            self.set("kf", go, M["kf"] | KF_LAND_START)
        self.set("st", go, ns)

    def send_mode(self, mode: int, cond):
        """set_mode_custom (:606-629): a request for the mode the FC
        reports is dropped before the 800 ms rate limit."""
        ok = (cond & self.tm["have_fc"] & (self.tm["hb_custom_mode"] != mode)
              & (self.t - self.M["lim_mode"] >= 800))
        self.set("lim_mode", ok, self.t)
        self.out["req_mode"] = torch.where(ok, mode, self.out["req_mode"])

    def grab_yaw(self, cond):
        """The yaw target from the attitude, where it is not held yet."""
        go = cond & ~self.M["yaw_tv"] & self.tm["have_att"]
        self.set("yaw_tv", go, True)
        self.set("yaw_t", go, self.tm["yaw_deg"])

    def target_yaw(self):
        tm = self.tm
        return torch.where(self.M["yaw_tv"], self.M["yaw_t"],
                           torch.where(tm["have_att"], tm["yaw_deg"], 0.0))

    def hover_z(self):
        """The hover target, NED z (:1038-1046): the hover altitude under
        the ceiling less 5 cm, at least 0.10 m."""
        top = max(F32(self.gt.ceil_m) - F32(0.05), F32(0.10))
        return f32(-min(F32(self.bh.hover_target_m), top))

    def off_ground(self):
        """takeoff_off_ground (:2178-2184)."""
        tm, M = self.tm, self.M
        return ((tm["have_ext"] & (tm["landed_state"] != ON_GROUND))
                | (self.rf_ok & (tm["rf_m"] > f32(0.05)))
                | (torch.isfinite(M["alt_max"]) & (M["alt_max"] > f32(0.05))))

    def ready_stable(self, called, ready):
        """hover_ready_stable (:1025-1036) for the quads that call: the
        prearm readiness held for prearm_stable_ms."""
        since = self.M["prearm_since"]
        self.set("prearm_since", called & ready & (since == 0), self.t)
        self.set("prearm_since", called & ~ready, 0)
        return ready & (self.t - self.M["prearm_since"]
                        >= self.bh.prearm_stable_ms)

    def init_targets(self, cond):
        """init_hover_targets_on_ground (:1048-1063)."""
        for k in ("locked", "pre_valid"):
            self.set(k, cond, False)
        for k in ("pre_x", "pre_y", "lock_x", "lock_y"):
            self.set(k, cond, 0.0)
        go = cond & self.tm["have_att"]
        self.set("yaw_tv", go, True)
        self.set("yaw_t", go, self.tm["yaw_deg"])

    def prelock(self, cond):
        """The prelock XY snapshot, once airborne above the capture
        altitude (:1054-1063)."""
        tm, M = self.tm, self.M
        cap = (cond & ~M["pre_valid"] & self.lpos_fresh
               & torch.isfinite(tm["lpos_x"]) & torch.isfinite(tm["lpos_y"])
               & torch.isfinite(M["alt_max"])
               & (M["alt_max"] > f32(self.bh.hover_capture_min_alt_m)))
        self.set("pre_x", cap, tm["lpos_x"])
        self.set("pre_y", cap, tm["lpos_y"])
        self.set("pre_valid", cap, True)

    def xy_stable(self, called):
        """vel_xy_stable (:972-996) for the quads that call: the XY gates
        held for xy_stable_hold_ms."""
        tm, M, gt = self.tm, self.M, self.gt
        ok = (self.health_if_enabled(XY_CTRL) & tm["have_att"]
              & self.lpos_fresh
              & ~(self.of_fresh & (tm["of_q"] < gt.of_min_quality))
              & ~(torch.isfinite(M["alt_max"])
                  & (M["alt_max"] < f32(gt.xy_min_alt_m))))
        self.set("xy_since", called & ok & (M["xy_since"] == 0), self.t)
        self.set("xy_since", called & ~ok, 0)
        return ok & (self.t - M["xy_since"] >= gt.xy_stable_hold_ms)


def control_tick(M: dict, tm: dict, bh, bt, gt, tof_alpha: float) -> dict:
    """The clean control tick (:2339-2660) for the batch: M updated in
    place, the outputs returned (with the state, the keyframe flags and
    the hover lock after the tick)."""
    k = Tick(M, tm, bh, bt, gt)
    t, out = k.t, k.out
    W = torch.where

    k.set("hb_last", t - M["hb_last"] >= 1000, t)

    # update_alt_estimate (:1710-1782): alt_max the highest source, alt
    # the sane rangefinder, else LPOS, else the ground
    grounded = tm["have_ext"] & (tm["landed_state"] == ON_GROUND)
    lpos_ok = k.lpos_fresh & torch.isfinite(tm["lpos_alt_filt"])
    lpos_alt = torch.clamp(tm["lpos_alt_filt"], f32(gt.lpos_clamp_lo_m),
                           f32(gt.lpos_clamp_hi_m))
    rf = torch.clamp(tm["rf_m"], 0.0, 10.0)
    top = torch.full(k.B, math.nan, device=k.dev)
    top = W(lpos_ok, lpos_alt, top)
    top = W(k.rf_ok, W(torch.isnan(top), rf, torch.maximum(top, rf)), top)
    top = W(grounded, W(torch.isnan(top), 0.0, torch.clamp(top, min=0.0)),
            top)
    M["alt_max"] = top
    hinted = ((tm["have_ext"] & (tm["landed_state"] != ON_GROUND))
              | (lpos_ok & (tm["lpos_alt_filt"]
                            > f32(gt.rf_airborne_lpos_m))))
    sane = (k.rf_ok & ~(hinted & (rf < f32(gt.rf_sanity_min_m)))
            & ~(lpos_ok & ((rf - tm["lpos_alt_filt"]).abs()
                           > f32(gt.rf_sanity_lpos_delta_m))))
    alt = W(sane, rf, W(lpos_ok, lpos_alt, W(grounded, 0.0, math.nan)))
    src = W(sane, ALT_RF, W(lpos_ok, ALT_LPOS, W(grounded, ALT_GND,
                                                  ALT_NONE)))
    M["alt"], M["alt_src"] = alt, src.to(torch.int32)
    known = torch.isfinite(top)
    k.set("ceiling", known & (top >= f32(gt.ceil_m)), True)
    k.set("ceiling", known & (top <= f32(F32(gt.ceil_m)
                                        - F32(gt.ceil_release_margin_m))),
          False)

    M["tof_filt"] = tof_filter_update(M["tof_filt"], tm["tof_min"],
                                      tof_alpha)

    # battery_failsafe_tick (:2127-2175): flags only, on a valid latch
    vpc, valid = tm["batt_vpc"], tm["batt_valid"]
    landed = valid & ~tm["fc_armed"]
    k.set("b_warn", landed & tm["want_arm"] & (vpc < f32(bt.arm_min_vpc))
          & (t - M["b_warn"] > bt.low_hold_ms), t)
    k.set("b_low", landed, 0)
    k.set("b_emerg", landed, 0)
    flying = valid & tm["fc_armed"]
    for lim, stamp, flag in ((bt.emerg_vpc, "b_emerg", KF_BATT_EMERG),
                             (bt.land_vpc, "b_low", KF_BATT_LAND)):
        low = flying & (vpc < f32(lim))
        k.set(stamp, low & (M[stamp] == 0), t)
        k.set("kf", low & (t - M[stamp] > bt.low_hold_ms), M["kf"] | flag)
        k.set(stamp, flying & ~low, 0)

    k.set("snap_last", t - M["snap_last"] >= 100, t)

    # guards (:2361-2419); each `return` ends the tick for its quads
    no_link = ~tm["have_fc"]
    k.enter_state(WAIT_LINK, no_link)
    live = ~no_link
    nogo = live & k.sys_fresh & (
        ~k.health(GYRO)
        | (((tm["sys_enabled"] & MOTORS) != 0) & ~k.health(MOTORS)))
    k.enter_state(DISARMING, nogo & tm["fc_armed"])
    k.enter_state(IDLE, nogo & ~tm["fc_armed"])
    live = live & ~nogo
    k.enter_state(IDLE, live & M["armed_prev"] & ~tm["fc_armed"]
                  & tm["want_arm"] & (M["st"] != LANDING)
                  & (M["st"] != DISARMING) & (M["st"] != IDLE))
    k.set("armed_prev", live, tm["fc_armed"])
    abort = live & ~tm["want_arm"] & tm["fc_armed"]
    k.set("lim_disarm", abort, 0)
    k.send_disarm(abort)
    k.enter_state(DISARMING, abort)
    live = live & ~abort
    z = k.hover_z()
    ceiling = live & M["ceiling"] & tm["fc_armed"]
    k.grab_yaw(ceiling)
    yaw = k.target_yaw()
    held = ceiling & M["locked"] & tm["have_att"]
    k.command(held, RW.CMD_POS_YAW, M["lock_x"], M["lock_y"], z, yaw)
    k.command(ceiling & ~held, CMD_Z_YAW, z, yaw, 0.0, 0.0)
    live = live & ~ceiling

    # hover stale-sensor hysteresis (:2421-2442)
    hov_armed = live & tm["fc_armed"] & (M["st"] == HOVER)
    for name, ok in (("lpos_stale", k.lpos_fresh),
                     ("alt_stale", torch.isfinite(M["alt_max"])),
                     ("rf_stale", k.rf_ok)):
        k.set(name, hov_armed, W(ok, 0, M[name] + 1))
        k.set(name, live & ~hov_armed, 0)
    k.enter_state(LANDING, hov_armed & (
        (M["lpos_stale"] > bh.stale_fail_ticks)
        | (M["alt_stale"] > bh.stale_fail_ticks)
        | (M["rf_stale"] > bh.stale_fail_ticks)))

    st = M["st"].clone()
    in_state = lambda s: live & (st == s)                          # noqa: E731
    k.enter_state(IDLE, in_state(WAIT_LINK))
    arm_ok = ~tm["batt_valid"] | (vpc >= f32(bt.arm_min_vpc))
    of_ok = k.of_fresh & (tm["of_q"] >= gt.of_min_quality)
    ready = (tm["have_att"] & k.lpos_fresh & k.health_if_enabled(XY_CTRL)
             & k.health_if_enabled(Z_CTRL) & k.rf_ok
             & (of_ok | ~tm["fc_armed"]) & torch.isfinite(M["alt_max"]))

    # IDLE (:2449-2468)
    idle = in_state(IDLE) & ~(tm["want_arm"] & ~arm_ok)
    ask = idle & tm["want_arm"] & ~tm["fc_armed"]
    steady = k.ready_stable(ask, ready)
    k.send_mode(MODE_GUIDED, ask & ~steady)
    k.grab_yaw(ask & steady)
    k.init_targets(ask & steady)
    k.enter_state(ARMING, ask & steady)
    k.enter_state(DISARMING, idle & ~tm["want_arm"] & tm["fc_armed"])
    k.enter_state(TAKEOFF, idle & tm["want_arm"] & tm["fc_armed"])

    # ARMING (:2470-2489)
    arming = in_state(ARMING)
    k.enter_state(IDLE, arming & ~arm_ok)
    arming = arming & arm_ok
    steady = k.ready_stable(arming, ready)
    k.send_mode(MODE_GUIDED, arming & ~steady)
    go = arming & steady
    k.init_targets(go)
    k.send_mode(MODE_GUIDED, go & ~tm["fc_armed"])
    k.send_arm(go & ~tm["fc_armed"])
    k.enter_state(TAKEOFF, go & tm["fc_armed"])

    _takeoff(k, in_state(TAKEOFF), z)
    _liftoff_assist(k, in_state(LIFTOFF_ASSIST))

    # HOVER (:2599-2607, hover_hold_tick :1065-1103)
    hov = in_state(HOVER)
    k.grab_yaw(hov)
    hov = hov & tm["have_att"]
    k.prelock(hov)
    # a locked hover does not call vel_xy_stable (:1081)
    lock = hov & ~M["locked"] & k.xy_stable(hov & ~M["locked"])
    k.set("lock_x", lock & M["pre_valid"], M["pre_x"])
    k.set("lock_y", lock & M["pre_valid"], M["pre_y"])
    here = (lock & ~M["pre_valid"] & k.lpos_fresh
            & torch.isfinite(tm["lpos_x"]) & torch.isfinite(tm["lpos_y"]))
    k.set("lock_x", here, tm["lpos_x"])
    k.set("lock_y", here, tm["lpos_y"])
    k.set("locked", lock, True)
    yaw = W(M["yaw_tv"], M["yaw_t"], tm["yaw_deg"])
    hold = hov & M["locked"] & k.lpos_fresh
    k.command(hold, RW.CMD_POS_YAW, M["lock_x"], M["lock_y"], z, yaw)
    k.command(hov & ~hold, CMD_Z_YAW, z, yaw, 0.0, 0.0)

    # LANDING (:2609-2628)
    lnd = in_state(LANDING)
    first = lnd & ~M["land_sent"]
    k.send_mode(MODE_LAND, first)
    k.set("land_sent", first, True)
    k.set("land_sent_ms", first, t)
    again = lnd & ~first & (t - M["land_sent_ms"] > 2000)
    k.send_mode(MODE_LAND, again)
    k.set("land_sent_ms", again, t)
    k.command(lnd, RW.CMD_VEL_NED, 0.0, 0.0, bh.landing_descent_mps, 0.0)
    down = ((torch.isfinite(M["alt_max"])
             & (M["alt_max"] < f32(bh.landing_near_ground_m)))
            | (tm["have_ext"] & (tm["landed_state"] == ON_GROUND)))
    k.enter_state(DISARMING, lnd & down)

    # DISARMING (:2630-2638)
    dis = in_state(DISARMING)
    k.send_disarm(dis & tm["fc_armed"])
    k.enter_state(IDLE, dis & ~tm["fc_armed"])

    out.update(state=M["st"], kf_flags=M["kf"], locked=M["locked"],
               alt_est=M["alt"])
    return out


def _takeoff(k: Tick, tko, z: float):
    """TAKEOFF (:2491-2593): one NAV_TAKEOFF, the setpoint stream after
    the no-velocity window, the delayed attitude ramp when nothing moves,
    the liftoff inference and the stall exit to the assist, HOVER at the
    target altitude less the margin."""
    M, tm, bh, t, out = k.M, k.tm, k.bh, k.t, k.out
    W = torch.where
    k.send_mode(MODE_GUIDED, tko & (tm["hb_custom_mode"] != MODE_GUIDED))
    k.prelock(tko)
    first = tko & ~M["to_sent"]
    out["req_takeoff"] = W(first, f32(bh.takeoff_target_m),
                           out["req_takeoff"])
    k.set("to_sent", first, True)
    k.set("to_sent_ms", first, t)
    k.set("to_alt0", first & torch.isnan(M["to_alt0"]),
          W(torch.isfinite(M["alt_max"]), M["alt_max"], M["alt"]))

    spin = f32(bh.takeoff_mot_start_us)
    mot = W(k.servo_250, tm["motor_avg"], math.nan)
    spinning = k.servo_250 & (mot > spin)
    off = k.off_ground()
    rising = (torch.isfinite(M["to_alt0"]) & torch.isfinite(M["alt_max"])
              & (M["alt_max"] - M["to_alt0"] > f32(0.05)))
    trigger = (tko & ~M["to_started"] & ~M["ramp_on"] & M["to_sent"]
               & (t - M["to_sent_ms"] > RAMP_TRIGGER_MS) & ~spinning
               & ~rising & ~off)
    k.set("ramp_on", trigger, True)
    k.set("ramp_start", trigger, t)

    stream = (tko & M["to_sent"] & (t - M["to_sent_ms"]
                                    >= bh.takeoff_no_vel_ms) & ~M["ramp_on"])
    yaw = k.target_yaw()
    k.command(stream & M["locked"], RW.CMD_POS_YAW, M["lock_x"], M["lock_y"],
              z, yaw)
    k.command(stream & ~M["locked"], CMD_Z_YAW, z, yaw, 0.0, 0.0)

    # the attitude-thrust ramp (:2098-2119)
    ramping = tko & M["ramp_on"]
    k.set("ramp_start", ramping & (M["ramp_start"] == 0), t)
    send = ramping & (t - M["ramp_last"] >= RAMP_SEND_MS)
    k.set("ramp_last", send, t)
    el = (t - M["ramp_start"]).to(torch.float32)
    u = torch.clamp(W(el >= bh.ramp_total_ms, 1.0,
                      div_f32(el, f32(float(bh.ramp_total_ms)))), min=0.0)
    thrust = (1.0 - u) * f32(bh.ramp_thr_min) + u * f32(bh.ramp_thr_max)
    k.command(send, RW.CMD_ATT,
              torch.clamp(thrust, 0.0, f32(bh.thrust_clamp)), yaw, 0.0, 0.0)
    k.set("ramp_on", ramping & (off | (t - M["ramp_start"]
                                       > RAMP_GIVE_UP_MS)), False)

    # no ramp running and not started: inferred airborne, else the assist
    idle = tko & ~M["to_started"] & ~M["ramp_on"]
    inferred = ((tm["have_ext"] & (tm["landed_state"] != ON_GROUND))
                | (torch.isfinite(M["alt_max"])
                   & (M["alt_max"] > f32(0.05)))
                | (k.servo_250 & (mot > f32(F32(bh.takeoff_mot_start_us)
                                            + F32(INFERRED_MOTOR_US)))))
    started = idle & inferred
    k.set("to_started", started, True)
    k.set("to_started_ms", started, t)
    k.set("yaw_tv", started & tm["have_att"], True)
    k.set("yaw_t", started & tm["have_att"], tm["yaw_deg"])
    k.enter_state(LIFTOFF_ASSIST, idle & ~inferred)
    tko = tko & ~(idle & ~inferred)

    moved = tko & ~M["to_started"] & (spinning | off)
    k.set("to_started", moved, True)
    k.set("to_started_ms", moved, t)
    k.set("yaw_tv", moved & tm["have_att"], True)
    k.set("yaw_t", moved & tm["have_att"], tm["yaw_deg"])

    stalled = tko & ~M["to_started"] & (t - M["to_sent_ms"]
                                        > bh.takeoff_stall_ms)
    k.enter_state(LIFTOFF_ASSIST, stalled)
    tko = tko & ~stalled
    there = (tko & torch.isfinite(M["alt_max"])
             & (M["alt_max"] >= f32(F32(bh.takeoff_target_m)
                                    - F32(bh.takeoff_exit_margin_m))))
    k.grab_yaw(there)
    k.enter_state(HOVER, there)


def _liftoff_assist(k: Tick, ast):
    """LIFTOFF_ASSIST (:2038-2095): GUIDED attitude and thrust, eased out
    by the square root, until the quad is off the ground, then TAKEOFF
    again; DISARMING after the abort time."""
    M, tm, bh, t, out = k.M, k.tm, k.bh, k.t, k.out
    W = torch.where
    k.send_mode(MODE_GUIDED, ast & (t - M["as_start"] < 150))
    base = ast & ~M["as_base"] & k.servo_200
    k.set("as_mot0", base, tm["motor_avg"])
    k.set("as_base", base, True)
    send = ast & (t - M["as_last"] >= bh.assist_send_period_ms)
    k.set("as_last", send, t)
    el = (t - M["as_start"]).to(torch.float32)
    u = torch.clamp(W(el >= bh.assist_total_ms, 1.0,
                      div_f32(el, f32(float(bh.assist_total_ms)))), 0.0, 1.0)
    ue = sqrt_f32(u)
    thr = ((1.0 - ue) * f32(float(bh.assist_thr_us_min))
           + ue * f32(float(bh.assist_thr_us_max)))
    norm = torch.clamp(div_f32(thr - 1000.0, 1000.0), 0.0, 1.0)
    k.command(send, RW.CMD_ATT, torch.clamp(norm, max=f32(bh.thrust_clamp)),
              W(tm["have_att"], tm["yaw_deg"], 0.0), 0.0, 0.0)
    weak = (ast & ~M["as_warned"] & M["as_base"]
            & (t - M["as_start"] > bh.assist_override_effect_ms)
            & k.servo_200 & torch.isfinite(M["as_mot0"])
            & (tm["motor_avg"] - M["as_mot0"]
               < f32(bh.assist_motor_delta_min)))
    k.set("as_warned", weak, True)
    up = ast & k.off_ground()
    k.send_mode(MODE_GUIDED, up)
    out["req_takeoff"] = W(up, f32(bh.takeoff_target_m), out["req_takeoff"])
    k.enter_state(TAKEOFF, up)
    k.enter_state(DISARMING, ast & ~up & (t - M["as_start"]
                                          > bh.assist_abort_ms))


# ---------------------------------------------------------- the swarm

def fc_setpoint(out: dict, alt) -> dict:
    """The FC model's reading of the clean machine's setpoints: Z+yaw is
    an altitude hold at z, a climb of (z - alt) clamped to +/-0.3 m/s,
    with the XY velocity setpoint at zero and the yaw held, which the UL
    swarm's FC model (reference/swarm.py::_fly) takes as the NED
    velocity setpoint it is."""
    zy = out["cmd_kind"] == CMD_Z_YAW
    climb = torch.clamp((-out["cmd"][:, 0]) - alt, f32(-0.3), f32(0.3))
    ned = torch.stack([torch.zeros_like(climb), torch.zeros_like(climb),
                       -climb, torch.zeros_like(climb)], dim=-1)
    return {**out, "cmd_kind": torch.where(zy, RW.CMD_VEL_NED,
                                           out["cmd_kind"]),
            "cmd": torch.where(zy[:, None], ned, out["cmd"])}


def swarm_run(room, boxes, x0, y0, yaw0, seed: int, n_ticks: int,
              cfg: Config, bh, bt, gt, dt_ms: int, scan_period_ms: int,
              noise_mm: float, dropout_p: float, airborne: bool = True,
              lowp: bool = False, t0_ms: int = 0,
              xy_stamp_ms: int = 1) -> dict:
    """B quads in rooms [B, 4] with boxes [B, K, 4] (NaN rows: none) from
    start poses [B], n_ticks ticks of dt_ms from the mission clock t0_ms,
    a ToF scan every scan_period_ms.  Returns the final poses and EKF mean
    and per tick the state, the command's kind and first value, the hover
    lock, the EKF position and the true yaw [T, B].

    An airborne quad starts mid-hover: armed in GUIDED at the hover
    target, in HOVER as enter_state leaves it after the takeoff, the
    prelock at its start pose, the yaw target its start heading, its XY
    hold stamped at xy_stamp_ms.  Otherwise it starts on the ground,
    disarmed, the machine at power-up."""
    dev = x0.device
    B = x0.shape[0]
    live = ~torch.isnan(boxes).any(dim=-1)
    boxes = torch.where(live[..., None], boxes, 0.0)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(3):                      # the start poses' draws
        torch.rand(B, generator=gen)
    q = RW._start(x0, y0, yaw0, airborne)
    M = machine_init(B, dev)
    ekf = ekf_init(B, dev)
    if airborne:
        q = q._replace(alt=torch.full_like(x0, f32(bh.hover_target_m)))
        yes = torch.ones(B, dtype=torch.bool, device=dev)
        i32 = lambda v: torch.full((B,), v, dtype=torch.int32,  # noqa: E731
                                   device=dev)
        M.update(st=i32(HOVER), yaw_tv=yes, yaw_t=yaw0, alt_max=q.alt,
                 alt=q.alt, alt_src=i32(ALT_RF), pre_valid=yes, pre_x=x0,
                 pre_y=y0, to_sent=yes, to_started=yes, armed_prev=yes,
                 xy_since=i32(xy_stamp_ms))
        mean = ekf.mean.clone()
        mean[:, 0], mean[:, 1], mean[:, 4] = x0, y0, q.alt
        mean[:, 6] = yaw0 * RW.DEG2RAD
        ekf = Ekf(mean, ekf.cov)
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    scores = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    tof_min = torch.full((B, 4), math.nan, device=dev)
    consts = predict_consts(dev)
    dt = F32(dt_ms * 1e-3)
    dts = torch.full((B,), float(dt), device=dev)
    of_q = torch.full((B,), RW.FLOW_Q, dtype=torch.int32, device=dev)
    batt = torch.full((B,), f32(RW.BATT_V), device=dev)
    half = batt * 0.5
    batt_valid = ((batt >= 3.0) & (batt <= 30.0) & (half >= 2.5)
                  & (half <= f32(4.8)))
    rec = {k: [] for k in ("state", "cmd_kind", "cmd_x", "locked", "est_x",
                           "est_y", "yaw")}
    rnd = lowp_round if lowp else (lambda a: a)
    t = t0_ms
    for _ in range(n_ticks):
        t += dt_ms
        if t % scan_period_ms == 0:
            shape = (B, 4, 8, 8)
            normal = torch.randn(shape, generator=gen)
            uniform = torch.rand(shape, generator=gen)
            cells = RW.tof_frame(room, boxes, live, q.x, q.y, q.yaw, normal,
                                 uniform, noise_mm, dropout_p, cfg.tof)
            _, tof_min = extract_beams(cells, cfg.tof)
        # the flow sensor, as reference/swarm.py's, quality 85 everywhere
        yr = q.yaw * RW.DEG2RAD
        h = torch.clamp(q.alt, min=0.0)
        up = q.alt > 0.05
        c, s = RW.cos_f32(yr), RW.sin_f32(yr)
        over = torch.clamp(h, min=0.05)
        rx = torch.where(h > 0.05, (c * q.vx + s * q.vy) / over, math.nan)
        ry = torch.where(h > 0.05, (-s * q.vx + c * q.vy) / over, math.nan)
        ekf = ekf_step(ekf, dts, rx, ry, of_q, h, yr, cfg.ekf, consts)
        mean = ekf.mean.clone()
        mean[:, 0] = torch.where(up, mean[:, 0], q.x)
        mean[:, 1] = torch.where(up, mean[:, 1], q.y)
        ekf = Ekf(rnd(mean), ekf.cov)
        ex, ey = ekf.mean[:, 0], ekf.mean[:, 1]
        tm = RW._telemetry(q, t, ex, ey, of_q, tof_min, no, scores)
        tm.update(have_rf=~no, rf_last_ms=tm["t_ms"], rf_m=q.alt,
                  sys_enabled=tm["sys_health"], batt_valid=batt_valid)
        out = control_tick(M, tm, bh, bt, gt, cfg.tof.filt_alpha)
        q = RW._fly(q, fc_setpoint(out, q.alt), t, dt_ms * 1e-3, ex, ey,
                    room)
        if lowp:
            q = q._replace(x=rnd(q.x), y=rnd(q.y), yaw=rnd(q.yaw))
        for k_, v in (("state", out["state"]), ("cmd_kind", out["cmd_kind"]),
                      ("cmd_x", out["cmd"][:, 0]), ("locked", out["locked"]),
                      ("est_x", ex), ("est_y", ey), ("yaw", q.yaw)):
            rec[k_].append(v)
    res = {k: torch.stack(v) for k, v in rec.items()}
    res.update(x=q.x, y=q.y, yaw_final=q.yaw, ekf_mean=ekf.mean)
    return res
