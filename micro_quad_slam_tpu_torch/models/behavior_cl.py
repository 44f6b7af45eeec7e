"""Branchless CLEAN-revision flight state machine in PyTorch
(clean_uav_fc_tof_nav.c): the 8-state hover-only twin of the UL machine
(models/behavior.py), a step function over a batch of quads
(counterpart of micro_quad_slam_tpu/models/behavior_cl.py).

Its differences from the UL machine (micro_quad_slam_tpu/golden/
behavior_cl.py): defensive altitude estimation with alt_max,
enabled-bit-aware health gates, prelock/lock hover with Z-only streaming,
prearm readiness gating, a delayed attitude-thrust takeoff ramp, an
immediate force-disarm on user abort, stale-sensor hysteresis in hover,
and a battery failsafe that only logs.  The sequencing is the JAX
module's, in the same SSA order; every conditional is a `torch.where`
over the [B] batch, every timer an int32 ms tensor.  Its float
arithmetic rounds as the golden model's does, on the CPU and the card
alike (ops/raycast.py::div_f32).

The swarm flies it from sim_init(machine="cl") (models/simulator.py).
Telemetry is a dict of [B] tensors with the golden model's Telemetry
field names (tof_min [B, 4]); `sys_health` and `sys_enabled` are integer
tensors (int32 or int64).

On a CUDA device the tick is one launch of csrc/behavior_cl.cuh's kernel
(`behavior_step_cl_kernel`: one thread per quad); anywhere else it is the
plain torch path (`behavior_step_cl_plain`), the kernel's twin in the
card tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.models.behavior import (
    ALT_GND,
    ALT_LPOS,
    ALT_NONE,
    ALT_RF,
    CMD_ATT_THRUST,
    CMD_POS_YAW,
    CMD_VEL_NED,
    LANDED_ON_GROUND,
    MODE_GUIDED,
    MODE_LAND,
    SENSOR_3D_GYRO,
    SENSOR_MOTOR_OUTPUTS,
    SENSOR_XY_POSITION_CONTROL,
    SENSOR_Z_ALTITUDE_CONTROL,
    _BOOL,
    _FLT,
    _I32,
    _f,
    launch_machine,
    machine_kernel,
)
from micro_quad_slam_tpu_torch.ops.raycast import div_f32
from micro_quad_slam_tpu_torch.utils.config import CL_PROFILE, PipelineConfig

_F32 = np.float32

CL_WAIT_LINK, CL_IDLE, CL_ARMING, CL_TAKEOFF = 0, 1, 2, 3
CL_LIFTOFF_ASSIST, CL_HOVER, CL_LANDING, CL_DISARMING = 4, 5, 6, 7
CMD_Z_YAW = 6
CL_KF_TAKEOFF, CL_KF_LAND_START, CL_KF_LIFTOFF_AST = 1, 2, 4
CL_KF_BATT_LAND, CL_KF_BATT_EMERG = 8, 16

_STATE_FIELDS = [
    ("st", _I32, 0), ("yaw_tv", _BOOL, False), ("yaw_t", _FLT, 0.0),
    ("alt_max", _FLT, np.nan), ("alt_est", _FLT, np.nan),
    ("alt_src", _I32, ALT_NONE), ("ceiling", _BOOL, False),
    ("hv_locked", _BOOL, False), ("hv_pre_valid", _BOOL, False),
    ("hv_pre_x", _FLT, 0.0), ("hv_pre_y", _FLT, 0.0),
    ("hv_lock_x", _FLT, 0.0), ("hv_lock_y", _FLT, 0.0),
    ("prearm_since", _I32, 0),
    ("to_sent", _BOOL, False), ("to_sent_ms", _I32, 0),
    ("to_started", _BOOL, False), ("to_started_ms", _I32, 0),
    ("to_alt0", _FLT, np.nan),
    ("ramp_active", _BOOL, False), ("ramp_start", _I32, 0),
    ("ramp_last", _I32, 0),
    ("as_start", _I32, 0), ("as_last", _I32, 0),
    ("as_base", _BOOL, False), ("as_mot0", _FLT, np.nan),
    ("as_warned", _BOOL, False),
    ("land_sent", _BOOL, False), ("land_sent_ms", _I32, 0),
    ("b_low", _I32, 0), ("b_emerg", _I32, 0), ("b_warn", _I32, 0),
    ("xy_since", _I32, 0),
    ("lim_arm", _I32, 0), ("lim_mode", _I32, 0), ("lim_disarm", _I32, 0),
    ("lpos_stale", _I32, 0), ("rf_stale", _I32, 0), ("alt_stale", _I32, 0),
    ("armed_prev", _BOOL, False), ("kf", _I32, 0),
    ("hb_last", _I32, 0), ("snap_last", _I32, 0),
]


class BehaviorClState(NamedTuple):
    st: torch.Tensor
    yaw_tv: torch.Tensor
    yaw_t: torch.Tensor
    alt_max: torch.Tensor
    alt_est: torch.Tensor
    alt_src: torch.Tensor
    ceiling: torch.Tensor
    hv_locked: torch.Tensor
    hv_pre_valid: torch.Tensor
    hv_pre_x: torch.Tensor
    hv_pre_y: torch.Tensor
    hv_lock_x: torch.Tensor
    hv_lock_y: torch.Tensor
    prearm_since: torch.Tensor
    to_sent: torch.Tensor
    to_sent_ms: torch.Tensor
    to_started: torch.Tensor
    to_started_ms: torch.Tensor
    to_alt0: torch.Tensor
    ramp_active: torch.Tensor
    ramp_start: torch.Tensor
    ramp_last: torch.Tensor
    as_start: torch.Tensor
    as_last: torch.Tensor
    as_base: torch.Tensor
    as_mot0: torch.Tensor
    as_warned: torch.Tensor
    land_sent: torch.Tensor
    land_sent_ms: torch.Tensor
    b_low: torch.Tensor
    b_emerg: torch.Tensor
    b_warn: torch.Tensor
    xy_since: torch.Tensor
    lim_arm: torch.Tensor
    lim_mode: torch.Tensor
    lim_disarm: torch.Tensor
    lpos_stale: torch.Tensor
    rf_stale: torch.Tensor
    alt_stale: torch.Tensor
    armed_prev: torch.Tensor
    kf: torch.Tensor
    hb_last: torch.Tensor
    snap_last: torch.Tensor
    tof_filt: torch.Tensor


def behavior_cl_init(batch: int = 1, device=None) -> BehaviorClState:
    """The CL machine's start state for `batch` quads on `device` (the
    CUDA device unless told otherwise, utils/device.py::as_device)."""
    from micro_quad_slam_tpu_torch.utils.device import as_device

    device = as_device(device)
    vals = {name: torch.full((batch,), dv, dtype=dt, device=device)
            for name, dt, dv in _STATE_FIELDS}
    vals["tof_filt"] = torch.full((batch, 4), float("nan"),
                                  dtype=torch.float32, device=device)
    return BehaviorClState(**vals)


def behavior_step_cl(state: BehaviorClState, tm: dict,
                     cfg: PipelineConfig = CL_PROFILE):
    """One CL control tick for the whole batch.  tm: dict of [B] tensors
    with the golden Telemetry fields (tof_min [B, 4]).  Returns
    (BehaviorClState, outputs dict).  On a CUDA device one launch of the
    machine's kernel (behavior_step_cl_kernel), anywhere else the plain
    torch path (behavior_step_cl_plain)."""
    run = (behavior_step_cl_kernel if state.st.is_cuda
           else behavior_step_cl_plain)
    return run(state, tm, cfg)


def behavior_step_cl_plain(state: BehaviorClState, tm: dict,
                           cfg: PipelineConfig = CL_PROFILE):
    """behavior_step_cl as [B]-wide torch ops, on any device: the kernel's
    twin on the card."""
    bh = cfg.behavior
    bt = cfg.battery
    W = torch.where
    S = dict(state._asdict())
    t = tm["t_ms"].to(torch.int32)
    dev = t.device
    B = tuple(t.shape)
    full = lambda v, dt: torch.full(B, v, dtype=dt, device=dev)       # noqa: E731
    nan = float("nan")

    O = {
        "cmd_kind": full(0, _I32),
        "cmd": torch.zeros(B + (4,), dtype=_FLT, device=dev),
        "req_mode": full(-1, _I32),
        "req_arm": full(-1, _I32),
        "req_takeoff": full(nan, _FLT),
        "rc_release": full(False, _BOOL),
        "clear_takeoff_ack": full(False, _BOOL),
        "map_init": full(False, _BOOL),
        "map_origin_x": full(nan, _FLT),
        "map_origin_y": full(nan, _FLT),
    }

    sys_fresh = tm["have_sys"] & (t - tm["sys_last_ms"] < 1000)

    def bit_ok(bit):
        return (~sys_fresh) | ((tm["sys_health"] & bit) != 0)

    def bit_ok_enabled(bit):
        en = (tm["sys_enabled"] & bit) != 0
        return (~sys_fresh) | (~en) | bit_ok(bit)

    hard_nogo = sys_fresh & (
        ~bit_ok(SENSOR_3D_GYRO)
        | (((tm["sys_enabled"] & SENSOR_MOTOR_OUTPUTS) != 0)
           & ~bit_ok(SENSOR_MOTOR_OUTPUTS)))
    z_ok = bit_ok_enabled(SENSOR_Z_ALTITUDE_CONTROL)
    xy_ok = bit_ok_enabled(SENSOR_XY_POSITION_CONTROL)
    of_fresh = tm["have_of"] & (t - tm["of_last_ms"] < 400)
    lpos_fresh = tm["have_lpos"] & (t - tm["lpos_last_ms"] < 400)
    rf_fresh = tm["have_rf"] & (t - tm["rf_last_ms"] < 400)
    # the intake validity latch (clean:158,1291-1294), kept by the
    # telemetry adapter: the CL tick gates on the flag alone
    batt_valid = tm["batt_valid"]
    servo_fresh_250 = tm["have_servo"] & (t - tm["servo_last_ms"] < 250)
    servo_fresh_200 = tm["have_servo"] & (t - tm["servo_last_ms"] < 200)

    def enter(ns, cond):
        """enter_state (clean:1957-2031) under a predicate."""
        c = cond & (S["st"] != ns)
        hv_reset = c & ((S["st"] == CL_HOVER) | (ns == CL_HOVER))
        for k in ("hv_locked", "hv_pre_valid"):
            S[k] = W(hv_reset, False, S[k])
        for k in ("hv_pre_x", "hv_pre_y", "hv_lock_x", "hv_lock_y"):
            S[k] = W(hv_reset, 0.0, S[k])
        if ns == CL_TAKEOFF:
            for k, v in (("to_sent", False), ("to_sent_ms", 0),
                         ("to_started", False), ("to_started_ms", 0),
                         ("ramp_active", False), ("ramp_start", 0)):
                S[k] = W(c, v, S[k])
            O["clear_takeoff_ack"] = O["clear_takeoff_ack"] | c
            S["to_alt0"] = W(c, S["alt_max"], S["to_alt0"])
            S["kf"] = W(c, S["kf"] | CL_KF_TAKEOFF, S["kf"])
        if ns == CL_LIFTOFF_ASSIST:
            S["as_start"] = W(c, t, S["as_start"])
            S["as_last"] = W(c, 0, S["as_last"])
            S["as_base"] = W(c, False, S["as_base"])
            S["as_mot0"] = W(c, nan, S["as_mot0"])
            S["as_warned"] = W(c, False, S["as_warned"])
            S["kf"] = W(c, S["kf"] | CL_KF_LIFTOFF_AST, S["kf"])
        if ns == CL_LANDING:
            S["land_sent"] = W(c, False, S["land_sent"])
            S["land_sent_ms"] = W(c, 0, S["land_sent_ms"])
            S["kf"] = W(c, S["kf"] | CL_KF_LAND_START, S["kf"])
        S["st"] = W(c, ns, S["st"])

    def emit_mode(mode, cond):
        # set_mode_custom: same-mode suppression before the rate limit
        # (clean:607-608); the UL machine lacks it
        can = (cond & tm["have_fc"] & (tm["hb_custom_mode"] != mode)
               & (t - S["lim_mode"] >= 800))
        S["lim_mode"] = W(can, t, S["lim_mode"])
        O["req_mode"] = W(can, mode, O["req_mode"])

    def emit_arm(cond):
        can = cond & tm["have_fc"] & (t - S["lim_arm"] >= 800)
        S["lim_arm"] = W(can, t, S["lim_arm"])
        O["req_arm"] = W(can, 1, O["req_arm"])

    def emit_disarm_force(cond, bypass=None):
        if bypass is not None:
            S["lim_disarm"] = W(bypass, 0, S["lim_disarm"])
        can = cond & tm["have_fc"] & (t - S["lim_disarm"] >= 800)
        S["lim_disarm"] = W(can, t, S["lim_disarm"])
        O["req_arm"] = W(can, 0, O["req_arm"])

    def set_cmd(cond, kind, a=0.0, b=0.0, c_=0.0, d=0.0):
        O["cmd_kind"] = W(cond, kind, O["cmd_kind"])
        vec = torch.stack([
            v.to(_FLT).expand(B) if torch.is_tensor(v) else full(_f(v), _FLT)
            for v in (a, b, c_, d)], dim=-1)
        O["cmd"] = W(cond[..., None], vec, O["cmd"])

    def capture_yaw(cond):
        S["yaw_tv"] = W(cond, True, S["yaw_tv"])
        S["yaw_t"] = W(cond, tm["yaw_deg"], S["yaw_t"])

    def vel_xy_stable(callc):
        allowed = xy_ok & tm["have_att"] & lpos_fresh
        allowed = allowed & ~(of_fresh
                              & (tm["of_q"] < cfg.gates.of_min_quality))
        allowed = allowed & ~(torch.isfinite(S["alt_max"])
                              & (S["alt_max"] < _f(cfg.gates.xy_min_alt_m)))
        set0 = callc & allowed & (S["xy_since"] == 0)
        S["xy_since"] = W(set0, t, S["xy_since"])
        S["xy_since"] = W(callc & ~allowed, 0, S["xy_since"])
        return (allowed & (S["xy_since"] != 0)
                & (t - S["xy_since"] >= cfg.gates.xy_stable_hold_ms))

    # ---------------- tick body (golden CL step order) ----------------
    hb_due = t - S["hb_last"] >= 1000
    S["hb_last"] = W(hb_due, t, S["hb_last"])

    # defensive altitude estimation (clean:1710-1782)
    near_ground = tm["have_ext"] & (tm["landed_state"] == LANDED_ON_GROUND)
    lp_ok = lpos_fresh & torch.isfinite(tm["lpos_alt_filt"])
    a_lp = torch.clamp(tm["lpos_alt_filt"], -1.0, 50.0)
    rf_ok0 = rf_fresh & torch.isfinite(tm["rf_m"])
    a_rf = torch.clamp(tm["rf_m"], 0.0, 10.0)
    mx_ = full(nan, _FLT)
    mx_ = W(lp_ok, a_lp, mx_)
    mx_ = W(rf_ok0, W(torch.isnan(mx_), a_rf, torch.maximum(mx_, a_rf)), mx_)
    mx_ = W(near_ground, W(torch.isnan(mx_), 0.0, torch.clamp(mx_, min=0.0)),
            mx_)
    S["alt_max"] = mx_

    airborne_hint = ((tm["have_ext"]
                      & (tm["landed_state"] != LANDED_ON_GROUND))
                     | (lp_ok & (tm["lpos_alt_filt"] > _f(0.20))))
    rf_sane = (rf_ok0 & ~(airborne_hint & (a_rf < _f(0.05)))
               & ~(lp_ok & ((a_rf - tm["lpos_alt_filt"]).abs() > _f(0.80))))
    alt = full(nan, _FLT)
    src = full(ALT_NONE, _I32)
    alt = W(near_ground, 0.0, alt)
    src = W(near_ground, ALT_GND, src)
    alt = W(lp_ok, a_lp, alt)
    src = W(lp_ok, ALT_LPOS, src)
    alt = W(rf_sane, a_rf, alt)
    src = W(rf_sane, ALT_RF, src)
    S["alt_est"] = alt
    S["alt_src"] = src
    ceilv = _F32(cfg.gates.ceil_m)
    S["ceiling"] = W(torch.isfinite(mx_) & (mx_ >= float(ceilv)), True,
                     S["ceiling"])
    S["ceiling"] = W(
        torch.isfinite(mx_)
        & (mx_ <= _f(ceilv - _F32(cfg.gates.ceil_release_margin_m))),
        False, S["ceiling"])

    # tof EMA filter
    mins = tm["tof_min"]
    a_ = _F32(cfg.tof.filt_alpha)
    blended = _f(_F32(1.0) - a_) * S["tof_filt"] + float(a_) * mins
    upd = W(torch.isnan(S["tof_filt"]), mins, blended)
    S["tof_filt"] = W(torch.isnan(mins), S["tof_filt"], upd)

    # battery failsafe, flags only (clean:2127-2175)
    vpc = tm["batt_vpc"]
    on_gnd = batt_valid & ~tm["fc_armed"]
    warn = (on_gnd & tm["want_arm"] & (vpc < _f(bt.arm_min_vpc))
            & (t - S["b_warn"] > bt.low_hold_ms))
    S["b_warn"] = W(warn, t, S["b_warn"])
    S["b_low"] = W(on_gnd, 0, S["b_low"])
    S["b_emerg"] = W(on_gnd, 0, S["b_emerg"])
    in_air_b = batt_valid & tm["fc_armed"]
    emergv = in_air_b & (vpc < _f(bt.emerg_vpc))
    S["b_emerg"] = W(emergv & (S["b_emerg"] == 0), t, S["b_emerg"])
    S["kf"] = W(emergv & (S["b_emerg"] != 0)
                & (t - S["b_emerg"] > bt.low_hold_ms),
                S["kf"] | CL_KF_BATT_EMERG, S["kf"])
    S["b_emerg"] = W(in_air_b & ~emergv, 0, S["b_emerg"])
    lowv = in_air_b & (vpc < _f(bt.land_vpc))
    S["b_low"] = W(lowv & (S["b_low"] == 0), t, S["b_low"])
    S["kf"] = W(lowv & (S["b_low"] != 0) & (t - S["b_low"] > bt.low_hold_ms),
                S["kf"] | CL_KF_BATT_LAND, S["kf"])
    S["b_low"] = W(in_air_b & ~lowv, 0, S["b_low"])

    # 10 Hz snapshot timer (kept for parity)
    snap_due = t - S["snap_last"] >= 100
    S["snap_last"] = W(snap_due, t, S["snap_last"])

    # ---- guards; `done` short-circuits the rest of the tick ----
    no_fc = ~tm["have_fc"]
    enter(CL_WAIT_LINK, no_fc)
    done = no_fc

    ng = ~done & hard_nogo
    enter(CL_DISARMING, ng & tm["fc_armed"])
    enter(CL_IDLE, ng & ~tm["fc_armed"])
    done = done | ng
    live = ~done

    unexp = (live & S["armed_prev"] & ~tm["fc_armed"] & tm["want_arm"]
             & (S["st"] != CL_LANDING) & (S["st"] != CL_DISARMING)
             & (S["st"] != CL_IDLE))
    enter(CL_IDLE, unexp)
    S["armed_prev"] = W(live, tm["fc_armed"], S["armed_prev"])

    # user abort: force disarm now, past the rate limit, and return
    abort = live & ~tm["want_arm"] & tm["fc_armed"]
    emit_disarm_force(abort, bypass=abort)
    enter(CL_DISARMING, abort)
    done = done | abort
    live = ~done

    # the hover target, NED z (down): a constant of the profile
    hover_z = _f(-np.minimum(_F32(bh.hover_target_m),
                             np.maximum(ceilv - _F32(0.05), _F32(0.10))))

    # ceiling override (clean:2403-2419)
    ceil_ov = live & S["ceiling"] & tm["fc_armed"]
    capture_yaw(ceil_ov & ~S["yaw_tv"] & tm["have_att"])
    cyaw = W(S["yaw_tv"], S["yaw_t"], W(tm["have_att"], tm["yaw_deg"], 0.0))
    ceil_pos = ceil_ov & S["hv_locked"] & tm["have_att"]
    set_cmd(ceil_pos, CMD_POS_YAW, S["hv_lock_x"], S["hv_lock_y"], hover_z,
            cyaw)
    set_cmd(ceil_ov & ~ceil_pos, CMD_Z_YAW, hover_z, cyaw, 0.0, 0.0)
    done = done | ceil_ov
    live = ~done

    # hover stale-sensor hysteresis (clean:2421-2442)
    in_hover = live & tm["fc_armed"] & (S["st"] == CL_HOVER)
    rf_ok_h = rf_fresh & torch.isfinite(tm["rf_m"])
    for k, ok in (("lpos_stale", lpos_fresh),
                  ("alt_stale", torch.isfinite(S["alt_max"])),
                  ("rf_stale", rf_ok_h)):
        S[k] = W(in_hover, W(ok, 0, S[k] + 1), 0)
    stale_fail = in_hover & ((S["lpos_stale"] > bh.stale_fail_ticks)
                             | (S["alt_stale"] > bh.stale_fail_ticks)
                             | (S["rf_stale"] > bh.stale_fail_ticks))
    enter(CL_LANDING, stale_fail)

    # prearm readiness (clean:999-1036)
    of_ok30 = of_fresh & (tm["of_q"] >= cfg.gates.of_min_quality)
    ready_now = (tm["have_att"] & lpos_fresh & xy_ok & z_ok
                 & (rf_fresh & torch.isfinite(tm["rf_m"]))
                 & (of_ok30 | ~tm["fc_armed"])
                 & torch.isfinite(S["alt_max"]))
    # the timer moves only where IDLE or ARMING consults it
    st0 = S["st"]

    def hover_ready_stable(callc):
        set0 = callc & ready_now & (S["prearm_since"] == 0)
        S["prearm_since"] = W(set0, t, S["prearm_since"])
        S["prearm_since"] = W(callc & ~ready_now, 0, S["prearm_since"])
        return (ready_now & (S["prearm_since"] != 0)
                & (t - S["prearm_since"] >= bh.prearm_stable_ms))

    def init_hover_targets(cond):
        for k in ("hv_locked", "hv_pre_valid"):
            S[k] = W(cond, False, S[k])
        for k in ("hv_pre_x", "hv_pre_y", "hv_lock_x", "hv_lock_y"):
            S[k] = W(cond, 0.0, S[k])
        capture_yaw(cond & tm["have_att"])

    enter(CL_IDLE, live & (st0 == CL_WAIT_LINK))

    batt_ok_arm = (~batt_valid) | (vpc >= _f(bt.arm_min_vpc))

    # IDLE (clean:2449-2468)
    idle = live & (st0 == CL_IDLE)
    idle_go = idle & ~(tm["want_arm"] & ~batt_ok_arm)
    want_arm_idle = idle_go & tm["want_arm"] & ~tm["fc_armed"]
    ready_idle = hover_ready_stable(want_arm_idle)
    emit_mode(MODE_GUIDED, want_arm_idle & ~ready_idle)
    go_arm = want_arm_idle & ready_idle
    capture_yaw(go_arm & ~S["yaw_tv"] & tm["have_att"])
    init_hover_targets(go_arm)
    enter(CL_ARMING, go_arm)
    enter(CL_DISARMING, idle_go & ~tm["want_arm"] & tm["fc_armed"])
    enter(CL_TAKEOFF, idle_go & tm["want_arm"] & tm["fc_armed"])

    # ARMING (clean:2470-2489)
    arming = live & (st0 == CL_ARMING)
    enter(CL_IDLE, arming & ~batt_ok_arm)
    arming2 = arming & batt_ok_arm
    ready_arm = hover_ready_stable(arming2)
    emit_mode(MODE_GUIDED, arming2 & ~ready_arm)
    arming3 = arming2 & ready_arm
    init_hover_targets(arming3)
    arm_do = arming3 & ~tm["fc_armed"]
    emit_mode(MODE_GUIDED, arm_do)
    emit_arm(arm_do)
    enter(CL_TAKEOFF, arming3 & tm["fc_armed"])

    # TAKEOFF (clean:2491-2593)
    tko = live & (st0 == CL_TAKEOFF)
    emit_mode(MODE_GUIDED, tko & (tm["hb_custom_mode"] != MODE_GUIDED))

    def prelock_capture(cond):
        cap = (cond & ~S["hv_pre_valid"] & lpos_fresh
               & torch.isfinite(tm["lpos_x"]) & torch.isfinite(tm["lpos_y"])
               & torch.isfinite(S["alt_max"])
               & (S["alt_max"] > _f(bh.hover_capture_min_alt_m)))
        S["hv_pre_x"] = W(cap, tm["lpos_x"], S["hv_pre_x"])
        S["hv_pre_y"] = W(cap, tm["lpos_y"], S["hv_pre_y"])
        S["hv_pre_valid"] = S["hv_pre_valid"] | cap

    prelock_capture(tko)

    first_send = tko & ~S["to_sent"]
    O["req_takeoff"] = W(first_send, _f(bh.takeoff_target_m),
                         O["req_takeoff"])
    S["to_sent"] = W(first_send, True, S["to_sent"])
    S["to_sent_ms"] = W(first_send, t, S["to_sent_ms"])
    S["to_alt0"] = W(first_send & torch.isnan(S["to_alt0"]),
                     W(torch.isfinite(S["alt_max"]), S["alt_max"],
                       S["alt_est"]), S["to_alt0"])

    mot_start = _f(bh.takeoff_mot_start_us)
    mot_avg = W(servo_fresh_250, tm["motor_avg"], nan)
    mot_started = servo_fresh_250 & (mot_avg > mot_start)
    alt_up = torch.isfinite(S["alt_max"]) & (S["alt_max"] > _f(0.05))
    off_ground = (
        (tm["have_ext"] & (tm["landed_state"] != LANDED_ON_GROUND))
        | (rf_fresh & torch.isfinite(tm["rf_m"]) & (tm["rf_m"] > _f(0.05)))
        | alt_up)
    alt_rising = (torch.isfinite(S["to_alt0"]) & torch.isfinite(S["alt_max"])
                  & (S["alt_max"] - S["to_alt0"] > _f(0.05)))

    ramp_trig = (tko & ~S["to_started"] & ~S["ramp_active"] & S["to_sent"]
                 & (t - S["to_sent_ms"] > 700)
                 & ~mot_started & ~alt_rising & ~off_ground)
    S["ramp_active"] = W(ramp_trig, True, S["ramp_active"])
    S["ramp_start"] = W(ramp_trig, t, S["ramp_start"])

    allow_stream = (tko & S["to_sent"]
                    & (t - S["to_sent_ms"] >= bh.takeoff_no_vel_ms)
                    & ~S["ramp_active"])
    tyaw = W(S["yaw_tv"], S["yaw_t"], W(tm["have_att"], tm["yaw_deg"], 0.0))
    stream_pos = allow_stream & S["hv_locked"]
    set_cmd(stream_pos, CMD_POS_YAW, S["hv_lock_x"], S["hv_lock_y"], hover_z,
            tyaw)
    set_cmd(allow_stream & ~S["hv_locked"], CMD_Z_YAW, hover_z, tyaw, 0.0,
            0.0)

    # attitude thrust ramp tick (clean:2098-2119)
    ramping = tko & S["ramp_active"]
    S["ramp_start"] = W(ramping & (S["ramp_start"] == 0), t, S["ramp_start"])
    ramp_send = ramping & (t - S["ramp_last"] >= 40)
    S["ramp_last"] = W(ramp_send, t, S["ramp_last"])
    rdt = (t - S["ramp_start"]).to(_FLT)
    u = torch.clamp(W(rdt >= bh.ramp_total_ms, 1.0,
                      div_f32(rdt, _f(float(bh.ramp_total_ms)))), min=0.0)
    thr = (1.0 - u) * _f(bh.ramp_thr_min) + u * _f(bh.ramp_thr_max)
    set_cmd(ramp_send, CMD_ATT_THRUST,
            torch.clamp(thr, 0.0, _f(bh.thrust_clamp)), tyaw, 0.0, 0.0)
    ramp_end = ramping & (off_ground | ((t - S["ramp_start"]) > 1400))
    S["ramp_active"] = W(ramp_end, False, S["ramp_active"])

    # post-ramp inference (clean:2544-2564)
    post = tko & ~S["to_started"] & ~S["ramp_active"]
    inferred_air = (
        (tm["have_ext"] & (tm["landed_state"] != LANDED_ON_GROUND))
        | alt_up
        | (servo_fresh_250
           & (mot_avg > _f(_F32(bh.takeoff_mot_start_us) + _F32(150)))))
    started_inf = post & inferred_air
    S["to_started"] = W(started_inf, True, S["to_started"])
    S["to_started_ms"] = W(started_inf, t, S["to_started_ms"])
    capture_yaw(started_inf & tm["have_att"])
    ramp_fail = post & ~inferred_air
    enter(CL_LIFTOFF_ASSIST, ramp_fail)
    tko = tko & ~ramp_fail

    start2 = tko & ~S["to_started"] & (mot_started | off_ground)
    S["to_started"] = W(start2, True, S["to_started"])
    S["to_started_ms"] = W(start2, t, S["to_started_ms"])
    capture_yaw(start2 & tm["have_att"])

    stall = tko & ~S["to_started"] & (t - S["to_sent_ms"]
                                      > bh.takeoff_stall_ms)
    enter(CL_LIFTOFF_ASSIST, stall)
    tko = tko & ~stall

    at_alt = (tko & torch.isfinite(S["alt_max"])
              & (S["alt_max"] >= _f(_F32(bh.takeoff_target_m)
                                    - _F32(bh.takeoff_exit_margin_m))))
    capture_yaw(at_alt & ~S["yaw_tv"] & tm["have_att"])
    enter(CL_HOVER, at_alt)

    # LIFTOFF_ASSIST (clean:2038-2095)
    ast = live & (st0 == CL_LIFTOFF_ASSIST)
    emit_mode(MODE_GUIDED, ast & (t - S["as_start"] < 150))
    base_now = ast & ~S["as_base"] & servo_fresh_200
    S["as_mot0"] = W(base_now, tm["motor_avg"], S["as_mot0"])
    S["as_base"] = W(base_now, True, S["as_base"])
    as_send = ast & (t - S["as_last"] >= bh.assist_send_period_ms)
    S["as_last"] = W(as_send, t, S["as_last"])
    adt = (t - S["as_start"]).to(_FLT)
    au = torch.clamp(W(adt >= bh.assist_total_ms, 1.0,
                       div_f32(adt, _f(float(bh.assist_total_ms)))), 0.0, 1.0)
    ue = torch.sqrt(au)
    athr = ((1.0 - ue) * _f(float(bh.assist_thr_us_min))
            + ue * _f(float(bh.assist_thr_us_max)))
    thr_norm = torch.clamp(div_f32(athr - 1000.0, 1000.0), 0.0, 1.0)
    ayaw = W(tm["have_att"], tm["yaw_deg"], 0.0)
    set_cmd(as_send, CMD_ATT_THRUST,
            torch.clamp(thr_norm, max=_f(bh.thrust_clamp)), ayaw, 0.0, 0.0)
    warn_now = (ast & ~S["as_warned"] & S["as_base"]
                & (t - S["as_start"] > bh.assist_override_effect_ms)
                & servo_fresh_200 & torch.isfinite(S["as_mot0"])
                & (tm["motor_avg"] - S["as_mot0"]
                   < _f(bh.assist_motor_delta_min)))
    S["as_warned"] = W(warn_now, True, S["as_warned"])
    as_exit = ast & off_ground
    emit_mode(MODE_GUIDED, as_exit)
    O["req_takeoff"] = W(as_exit, _f(bh.takeoff_target_m), O["req_takeoff"])
    enter(CL_TAKEOFF, as_exit)
    as_abort = ast & ~as_exit & (t - S["as_start"] > bh.assist_abort_ms)
    enter(CL_DISARMING, as_abort)

    # HOVER (clean:2599-2607 + hover_hold_tick 1065-1103)
    hov = live & (st0 == CL_HOVER)
    capture_yaw(hov & ~S["yaw_tv"] & tm["have_att"])
    hov_att = hov & tm["have_att"]
    prelock_capture(hov_att)
    # the C short-circuit (clean:1081): once locked, vel_xy_stable is not
    # called again, so its timer freezes through sensor dropouts
    xy_stable_h = vel_xy_stable(hov_att & ~S["hv_locked"])
    lock_now = hov_att & ~S["hv_locked"] & xy_stable_h
    use_pre = lock_now & S["hv_pre_valid"]
    use_cur = (lock_now & ~S["hv_pre_valid"] & lpos_fresh
               & torch.isfinite(tm["lpos_x"]) & torch.isfinite(tm["lpos_y"]))
    S["hv_lock_x"] = W(use_pre, S["hv_pre_x"],
                       W(use_cur, tm["lpos_x"], S["hv_lock_x"]))
    S["hv_lock_y"] = W(use_pre, S["hv_pre_y"],
                       W(use_cur, tm["lpos_y"], S["hv_lock_y"]))
    S["hv_locked"] = S["hv_locked"] | lock_now
    hyaw = W(S["yaw_tv"], S["yaw_t"], tm["yaw_deg"])
    pos_hold = hov_att & S["hv_locked"] & lpos_fresh
    set_cmd(pos_hold, CMD_POS_YAW, S["hv_lock_x"], S["hv_lock_y"], hover_z,
            hyaw)
    set_cmd(hov_att & ~pos_hold, CMD_Z_YAW, hover_z, hyaw, 0.0, 0.0)

    # LANDING (clean:2609-2628)
    lnd = live & (st0 == CL_LANDING)
    first_land = lnd & ~S["land_sent"]
    emit_mode(MODE_LAND, first_land)
    S["land_sent"] = W(first_land, True, S["land_sent"])
    S["land_sent_ms"] = W(first_land, t, S["land_sent_ms"])
    re_land = lnd & ~first_land & (t - S["land_sent_ms"] > 2000)
    emit_mode(MODE_LAND, re_land)
    S["land_sent_ms"] = W(re_land, t, S["land_sent_ms"])
    set_cmd(lnd, CMD_VEL_NED, 0.0, 0.0, bh.landing_descent_mps, 0.0)
    near_gnd = torch.isfinite(S["alt_max"]) & (S["alt_max"] < _f(0.10))
    enter(CL_DISARMING, lnd & (near_gnd | (
        tm["have_ext"] & (tm["landed_state"] == LANDED_ON_GROUND))))

    # DISARMING (clean:2630-2638)
    dis = live & (st0 == CL_DISARMING)
    emit_disarm_force(dis & tm["fc_armed"])
    enter(CL_IDLE, dis & ~tm["fc_armed"])

    new_state = BehaviorClState(**S)
    O["state"] = S["st"]
    O["kf_flags"] = S["kf"]
    for k in ("alt_est", "alt_max", "alt_src", "ceiling"):
        O[k] = S[k]
    return new_state, O


# The telemetry fields the tick reads, in csrc/behavior_cl.cuh's BehTm
# order, with the dtype the kernel takes (sys_health and sys_enabled also
# int64); tof_min [B, 4] last.
_TM_FIELDS = (
    ("t_ms", _I32), ("have_fc", _BOOL), ("fc_armed", _BOOL),
    ("hb_custom_mode", _I32), ("have_ext", _BOOL), ("landed_state", _I32),
    ("have_sys", _BOOL), ("sys_last_ms", _I32), ("sys_health", _I32),
    ("sys_enabled", _I32), ("have_servo", _BOOL), ("servo_last_ms", _I32),
    ("motor_avg", _FLT), ("batt_vpc", _FLT), ("batt_valid", _BOOL),
    ("have_lpos", _BOOL), ("lpos_last_ms", _I32), ("lpos_x", _FLT),
    ("lpos_y", _FLT), ("lpos_alt_filt", _FLT), ("have_att", _BOOL),
    ("yaw_deg", _FLT), ("have_of", _BOOL), ("of_last_ms", _I32),
    ("of_q", _I32), ("have_rf", _BOOL), ("rf_last_ms", _I32),
    ("rf_m", _FLT), ("want_arm", _BOOL), ("tof_min", _FLT))


def kernel_config_cl(cfg: PipelineConfig) -> tuple:
    """The configuration the clean tick reads, as its kernel takes it:
    ({name: float} in csrc/behavior_cl.cuh's BehCfgFloat order, each
    rounded to float32 as behavior_step_cl_plain rounds it, the derived
    ones in its float32 arithmetic; {name: int} in BehCfgInt's order)."""
    bh, bt, g = cfg.behavior, cfg.battery, cfg.gates
    ceil = _F32(g.ceil_m)
    floats = {
        "xy_min_alt_m": _f(g.xy_min_alt_m),
        "ceil_m": _f(ceil),
        "ceil_release_m": _f(ceil - _F32(g.ceil_release_margin_m)),
        "filt_alpha": _f(cfg.tof.filt_alpha),
        "filt_keep": _f(_F32(1.0) - _F32(cfg.tof.filt_alpha)),
        "arm_min_vpc": _f(bt.arm_min_vpc),
        "emerg_vpc": _f(bt.emerg_vpc),
        "land_vpc": _f(bt.land_vpc),
        "hover_z": _f(-np.minimum(_F32(bh.hover_target_m),
                                  np.maximum(ceil - _F32(0.05),
                                             _F32(0.10)))),
        "hover_capture_min_alt_m": _f(bh.hover_capture_min_alt_m),
        "takeoff_target_m": _f(bh.takeoff_target_m),
        "takeoff_mot_start_us": _f(bh.takeoff_mot_start_us),
        "takeoff_inferred_us": _f(_F32(bh.takeoff_mot_start_us)
                                  + _F32(150)),
        **{k: _f(float(getattr(bh, k))) for k in (
            "ramp_total_ms", "ramp_thr_min", "ramp_thr_max",
            "thrust_clamp")},
        "takeoff_at_alt_m": _f(_F32(bh.takeoff_target_m)
                               - _F32(bh.takeoff_exit_margin_m)),
        **{k: _f(float(getattr(bh, k))) for k in (
            "assist_total_ms", "assist_thr_us_min", "assist_thr_us_max",
            "assist_motor_delta_min", "landing_descent_mps")},
    }
    ints = {
        "of_min_quality": g.of_min_quality,
        "xy_stable_hold_ms": g.xy_stable_hold_ms,
        "low_hold_ms": bt.low_hold_ms,
        **{k: getattr(bh, k) for k in (
            "prearm_stable_ms", "stale_fail_ticks", "takeoff_no_vel_ms",
            "takeoff_stall_ms", "assist_send_period_ms",
            "assist_override_effect_ms", "assist_abort_ms")},
    }
    return floats, ints


# The clean machine's kernel.  Its kept blocks: `st` and the hover lock,
# which sim_step's diagnostics keep every tick (`state`, `locked`); the
# rest of what sim_step(record=True) keeps of a tick.  A kept tick so pins
# the bytes the plain path's separate tensors did, and not the whole
# state's block.
CL_KERNEL = machine_kernel(
    "mqs_behavior_step_cl", BehaviorClState, _STATE_FIELDS, _TM_FIELDS,
    kept=(("st", "hv_locked"),
          ("kf", "cmd_kind", "req_mode", "req_arm", "alt_est",
           "req_takeoff", "cmd", "rc_release")),
    outputs=(("state", "st"), ("kf_flags", "kf"), ("alt_est", "alt_est"),
             ("alt_max", "alt_max"), ("alt_src", "alt_src"),
             ("ceiling", "ceiling")),
    config=kernel_config_cl)


def behavior_step_cl_kernel(state: BehaviorClState, tm: dict,
                            cfg: PipelineConfig = CL_PROFILE):
    """behavior_step_cl_plain's (state, outputs) from one launch of the
    clean machine's kernel (csrc/behavior_cl.cuh; ops/_build.py::ENTRIES
    names its library), on CUDA tensors; bit-equal to
    behavior_step_cl_plain on the card (models/behavior.py::
    launch_machine with CL_KERNEL: ValueError on operands it does not
    take, counted in launches.behavior_step_cl)."""
    return launch_machine(CL_KERNEL, state, tm, cfg)
