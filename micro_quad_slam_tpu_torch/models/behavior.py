"""Branchless flight state machine in PyTorch: the reference's 50 Hz
control_tick (uav_local_nav.c:1866-2333) as a step function over a batch
of quads (counterpart of micro_quad_slam_tpu/models/behavior.py, the UL
machine).

Ten states (WAIT_LINK..DISARMING, uav_local_nav.c:484-496), all timers in
int32 ms, every conditional a `torch.where` over the [B] batch.  The
sequencing is the JAX module's, in the same SSA order: enter_state side
effects (uav_local_nav.c:1642-1698), command rate limiters consumed in C
call order (an earlier SET_MODE in the same tick suppresses a later one,
:699-715), the battery failsafe running before the guards (:1875), the
2 Hz status print's observable vel_xy_stable call (:1886-1889), and the
switch dispatching on the post-guard state.

Telemetry is a dict of [B] tensors with the golden model's Telemetry
field names (micro_quad_slam_tpu/golden/behavior.py); `sys_health` is an
integer tensor (int32 or int64: torch's uint32 supports few operations).
The float arithmetic is eager torch, one rounding per operation as in the
golden model: no product and sum is contracted into an fma.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from micro_quad_slam_tpu_torch.ops.raycast import div_f32
from micro_quad_slam_tpu_torch.utils.config import PipelineConfig, UL_PROFILE

_F32 = np.float32

# states
ST_WAIT_LINK, ST_IDLE, ST_ARMING, ST_TAKEOFF, ST_LIFTOFF_ASSIST = 0, 1, 2, 3, 4
ST_HOVER, ST_EXPLORE, ST_TURNING, ST_LANDING, ST_DISARMING = 5, 6, 7, 8, 9
D_FRONT, D_RIGHT, D_BACK, D_LEFT = 0, 1, 2, 3
LANDED_ON_GROUND = 1
RES_ACCEPTED, RES_TEMP_REJECTED, RES_DENIED = 0, 1, 2
SENSOR_3D_GYRO = 0x01
SENSOR_Z_ALTITUDE_CONTROL = 0x2000
SENSOR_XY_POSITION_CONTROL = 0x4000
SENSOR_MOTOR_OUTPUTS = 0x400000
ALT_NONE, ALT_LPOS, ALT_RF, ALT_GND = 0, 1, 2, 3
CMD_NONE, CMD_VEL_BODY, CMD_VEL_NED, CMD_POS_YAW, CMD_ATT_THRUST, CMD_RC_OVERRIDE = (
    0, 1, 2, 3, 4, 5,
)
MODE_STABILIZE, MODE_GUIDED, MODE_LAND = 0, 4, 9
KF_TAKEOFF, KF_TURN_START, KF_TURN_END, KF_LAND_START = 1, 2, 4, 8
KF_LIFTOFF_AST, KF_MAP_RECENTER, KF_BATT_LAND, KF_BATT_EMERG = 16, 32, 64, 128

_I32, _BOOL, _FLT = torch.int32, torch.bool, torch.float32
_STATE_FIELDS = [
    ("st", _I32, 0),
    ("yaw_tv", _BOOL, False),
    ("yaw_t", _FLT, 0.0),
    ("hover_valid", _BOOL, False),
    ("hover_x", _FLT, np.nan),
    ("hover_y", _FLT, np.nan),
    ("hover_z", _FLT, np.nan),
    ("hover_yaw", _FLT, np.nan),
    ("hover_enter", _I32, 0),
    ("turn_init", _BOOL, False),
    ("turn_dir", _I32, D_RIGHT),
    ("turn_target", _FLT, 0.0),
    ("turn_start", _I32, 0),
    ("turn_forced", _BOOL, False),
    ("forced_dir", _I32, D_RIGHT),
    ("ceiling", _BOOL, False),
    ("alt_est", _FLT, np.nan),
    ("alt_src", _I32, ALT_NONE),
    ("to_sent", _BOOL, False),
    ("to_sent_ms", _I32, 0),
    ("to_no_vel_until", _I32, 0),
    ("to_started", _BOOL, False),
    ("to_started_ms", _I32, 0),
    ("to_nsp", _BOOL, False),
    ("ramp_active", _BOOL, False),
    ("ramp_start", _I32, 0),
    ("ramp_last", _I32, 0),
    ("as_start", _I32, 0),
    ("as_last", _I32, 0),
    ("as_base", _BOOL, False),
    ("as_mot0", _FLT, np.nan),
    ("as_warned", _BOOL, False),
    ("land_sent", _BOOL, False),
    ("land_sent_ms", _I32, 0),
    ("b_low", _I32, 0),
    ("b_emerg", _I32, 0),
    ("b_warn", _I32, 0),
    ("xy_since", _I32, 0),
    ("lim_arm", _I32, 0),
    ("lim_mode", _I32, 0),
    ("lim_disarm", _I32, 0),
    ("fr_eval", _I32, 0),
    ("ex_pause", _I32, 0),
    ("armed_prev", _BOOL, False),
    ("kf", _I32, 0),
    ("hb_last", _I32, 0),
    ("print_last", _I32, 0),
]
_NP_DTYPES = {_I32: np.int32, _BOOL: np.bool_, _FLT: np.float32}


class BehaviorState(NamedTuple):
    st: torch.Tensor
    yaw_tv: torch.Tensor
    yaw_t: torch.Tensor
    hover_valid: torch.Tensor
    hover_x: torch.Tensor
    hover_y: torch.Tensor
    hover_z: torch.Tensor
    hover_yaw: torch.Tensor
    hover_enter: torch.Tensor
    turn_init: torch.Tensor
    turn_dir: torch.Tensor
    turn_target: torch.Tensor
    turn_start: torch.Tensor
    turn_forced: torch.Tensor
    forced_dir: torch.Tensor
    ceiling: torch.Tensor
    alt_est: torch.Tensor
    alt_src: torch.Tensor
    to_sent: torch.Tensor
    to_sent_ms: torch.Tensor
    to_no_vel_until: torch.Tensor
    to_started: torch.Tensor
    to_started_ms: torch.Tensor
    to_nsp: torch.Tensor
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
    fr_eval: torch.Tensor
    ex_pause: torch.Tensor
    armed_prev: torch.Tensor
    kf: torch.Tensor
    hb_last: torch.Tensor
    print_last: torch.Tensor
    tof_filt: torch.Tensor


def behavior_init(batch: int = 1, device=None) -> BehaviorState:
    """The machine's start state for `batch` quads on `device` (the CUDA
    device unless told otherwise, replay/mapping.py::as_device)."""
    from micro_quad_slam_tpu_torch.replay.mapping import as_device

    device = as_device(device)
    vals = {name: torch.full((batch,), dv, dtype=dt, device=device)
            for name, dt, dv in _STATE_FIELDS}
    vals["tof_filt"] = torch.full((batch, 4), float("nan"),
                                  dtype=torch.float32, device=device)
    return BehaviorState(**vals)


def behavior_state_from_numpy(d, device=None) -> BehaviorState:
    """A behaviour state held as numpy arrays (the JAX package's
    BehaviorState after `jax.tree.map(np.asarray, st)`, or any mapping with
    its field names) -> the port's BehaviorState on `device`."""
    from micro_quad_slam_tpu_torch.replay.mapping import as_device

    device = as_device(device)
    d = d._asdict() if hasattr(d, "_asdict") else dict(d)
    dtypes = {name: _NP_DTYPES[dt] for name, dt, _ in _STATE_FIELDS}
    dtypes["tof_filt"] = np.float32
    return BehaviorState(**{
        k: torch.from_numpy(np.array(d[k], dtype=dt)).to(device)
        for k, dt in dtypes.items()})


def behavior_state_to_numpy(state: BehaviorState) -> dict:
    """The port's BehaviorState -> dict of numpy arrays with the JAX
    package's field names and dtypes (`BehaviorState(**d)` there)."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def _f(x) -> float:
    return float(_F32(x))


def _wrap_deg(d):
    """Wrap to [-180, 180) in float32 (uav_local_nav.c:585-589).  The C
    loops; two conditional folds cover any |d| < 540, which all call sites
    satisfy (wrapped headings plus +/-90/180 offsets)."""
    d = torch.where(d >= 180.0, d - 360.0, d)
    d = torch.where(d >= 180.0, d - 360.0, d)
    d = torch.where(d < -180.0, d + 360.0, d)
    d = torch.where(d < -180.0, d + 360.0, d)
    return d


def behavior_step(state: BehaviorState, tm: dict,
                  cfg: PipelineConfig = UL_PROFILE):
    """One control tick for the whole batch.  tm: dict of [B] tensors with
    the golden Telemetry fields (tof_min [B, 4]).  Returns
    (BehaviorState, outputs dict)."""
    bh = cfg.behavior
    W = torch.where
    S = dict(state._asdict())
    t = tm["t_ms"].to(torch.int32)
    dev = t.device
    B = tuple(t.shape)
    full = lambda v, dt: torch.full(B, v, dtype=dt, device=dev)       # noqa: E731

    O = {
        "cmd_kind": full(0, _I32),
        "cmd": torch.zeros(B + (4,), dtype=_FLT, device=dev),
        "req_mode": full(-1, _I32),
        "req_arm": full(-1, _I32),
        "req_takeoff": full(float("nan"), _FLT),
        "rc_release": full(False, _BOOL),
        "clear_takeoff_ack": full(False, _BOOL),
        "map_init": full(False, _BOOL),
        "map_origin_x": full(float("nan"), _FLT),
        "map_origin_y": full(float("nan"), _FLT),
    }

    # ---- pure telemetry predicates ----
    sys_fresh = tm["have_sys"] & (t - tm["sys_last_ms"] < 1000)

    def bit_ok(bit):
        return (~sys_fresh) | ((tm["sys_health"] & bit) != 0)

    hard_nogo = sys_fresh & (~bit_ok(SENSOR_3D_GYRO) | ~bit_ok(SENSOR_MOTOR_OUTPUTS))
    z_ok = bit_ok(SENSOR_Z_ALTITUDE_CONTROL)
    xy_ok = bit_ok(SENSOR_XY_POSITION_CONTROL)
    of_fresh = tm["have_of"] & (t - tm["of_last_ms"] < 400)
    lpos_fresh = tm["have_lpos"] & (t - tm["lpos_last_ms"] < 400)
    rf_fresh = tm["have_rf"] & (t - tm["rf_last_ms"] < 400)
    batt_fresh = ((tm["batt_last_ms"] != 0) & (t - tm["batt_last_ms"] < 2000)
                  & torch.isfinite(tm["batt_vpc"]) & (tm["batt_cells"] > 0))
    servo_fresh_250 = tm["have_servo"] & (t - tm["servo_last_ms"] < 250)
    servo_fresh_200 = tm["have_servo"] & (t - tm["servo_last_ms"] < 200)

    # ---- small state machines shared across call sites ----
    def enter(ns, cond):
        """enter_state (uav_local_nav.c:1642-1698) under a predicate."""
        c = cond & (S["st"] != ns)
        leave_assist = c & (S["st"] == ST_LIFTOFF_ASSIST)
        O["rc_release"] = O["rc_release"] | leave_assist
        if ns == ST_TAKEOFF:
            for k, v in (("to_sent", False), ("to_sent_ms", 0),
                         ("to_no_vel_until", 0), ("to_started", False),
                         ("to_started_ms", 0), ("to_nsp", False),
                         ("ramp_active", False), ("ramp_start", 0),
                         ("ramp_last", 0)):
                S[k] = W(c, v, S[k])
            O["clear_takeoff_ack"] = O["clear_takeoff_ack"] | c
            S["kf"] = W(c, S["kf"] | KF_TAKEOFF, S["kf"])
        if ns == ST_LIFTOFF_ASSIST:
            S["as_start"] = W(c, t, S["as_start"])
            S["as_last"] = W(c, 0, S["as_last"])
            S["as_base"] = W(c, False, S["as_base"])
            S["as_mot0"] = W(c, float("nan"), S["as_mot0"])
            S["as_warned"] = W(c, False, S["as_warned"])
            S["kf"] = W(c, S["kf"] | KF_LIFTOFF_AST, S["kf"])
        if ns == ST_HOVER:
            S["hover_enter"] = W(c, t, S["hover_enter"])
            S["hover_valid"] = W(c, False, S["hover_valid"])
        if ns == ST_LANDING:
            S["land_sent"] = W(c, False, S["land_sent"])
            S["land_sent_ms"] = W(c, 0, S["land_sent_ms"])
            S["kf"] = W(c, S["kf"] | KF_LAND_START, S["kf"])
        leave_turning = c & (S["st"] == ST_TURNING)
        S["turn_init"] = W(leave_turning, False, S["turn_init"])
        S["kf"] = W(leave_turning, S["kf"] | KF_TURN_END, S["kf"])
        S["ex_pause"] = W(leave_turning, t + bh.post_turn_pause_ms, S["ex_pause"])
        if ns == ST_TURNING:
            S["kf"] = W(c, S["kf"] | KF_TURN_START, S["kf"])
        S["st"] = W(c, ns, S["st"])

    def emit_mode(mode, cond):
        can = cond & tm["have_fc"] & (t - S["lim_mode"] >= 800)
        S["lim_mode"] = W(can, t, S["lim_mode"])
        O["req_mode"] = W(can, mode, O["req_mode"])

    def emit_arm(cond):
        can = cond & tm["have_fc"] & (t - S["lim_arm"] >= 800)
        S["lim_arm"] = W(can, t, S["lim_arm"])
        O["req_arm"] = W(can, 1, O["req_arm"])

    def emit_disarm_force(cond):
        can = cond & tm["have_fc"] & (t - S["lim_disarm"] >= 800)
        S["lim_disarm"] = W(can, t, S["lim_disarm"])
        O["req_arm"] = W(can, 0, O["req_arm"])

    def set_cmd(cond, kind, a=0.0, b=0.0, c_=0.0, d=0.0):
        O["cmd_kind"] = W(cond, kind, O["cmd_kind"])
        vec = torch.stack([
            v.to(_FLT).expand(B) if torch.is_tensor(v) else full(_f(v), _FLT)
            for v in (a, b, c_, d)], dim=-1)
        O["cmd"] = W(cond[..., None], vec, O["cmd"])

    def vel_xy_allowed():
        ok = xy_ok & tm["have_att"] & lpos_fresh
        ok = ok & ~(of_fresh & (tm["of_q"] < cfg.gates.of_min_quality))
        ok = ok & ~(torch.isfinite(S["alt_est"])
                    & (S["alt_est"] < _f(cfg.gates.xy_min_alt_m)))
        return ok

    def vel_xy_stable(callc):
        allowed = vel_xy_allowed()
        set0 = callc & allowed & (S["xy_since"] == 0)
        S["xy_since"] = W(set0, t, S["xy_since"])
        reset = callc & ~allowed
        S["xy_since"] = W(reset, 0, S["xy_since"])
        return (allowed & (S["xy_since"] != 0)
                & (t - S["xy_since"] >= cfg.gates.xy_stable_hold_ms))

    def yaw_hold_rate():
        err = _wrap_deg(S["yaw_t"] - tm["yaw_deg"])
        rate = _f(bh.yaw_rate_dps)
        yr = torch.clamp(err * _f(bh.yaw_hold_gain), -rate, rate)
        return W(S["yaw_tv"] & tm["have_att"], yr, 0.0)

    # ---------------- tick body (golden.step order) ----------------
    hb_due = t - S["hb_last"] >= 1000
    S["hb_last"] = W(hb_due, t, S["hb_last"])

    # update_alt_estimate (uav_local_nav.c:1440-1470)
    near_ground = tm["have_ext"] & (tm["landed_state"] == LANDED_ON_GROUND)
    rf_usable = rf_fresh & torch.isfinite(tm["rf_m"])
    a_rf = torch.clamp(tm["rf_m"], 0.0, 10.0)
    a_lp = torch.clamp(tm["lpos_alt_filt"], 0.0, 10.0)
    alt = S["alt_est"]
    src = full(ALT_NONE, _I32)
    alt = W(near_ground, 0.0, alt)
    src = W(near_ground, ALT_GND, src)
    alt = W(lpos_fresh, a_lp, alt)
    src = W(lpos_fresh, ALT_LPOS, src)
    alt = W(rf_usable, a_rf, alt)
    src = W(rf_usable, ALT_RF, src)
    S["alt_est"] = alt
    S["alt_src"] = src
    ceilv = _F32(cfg.gates.ceil_m)
    S["ceiling"] = W(torch.isfinite(alt) & (alt >= float(ceilv)), True,
                     S["ceiling"])
    S["ceiling"] = W(
        torch.isfinite(alt)
        & (alt <= _f(ceilv - _F32(cfg.gates.ceil_release_margin_m))),
        False, S["ceiling"])

    # tof EMA filter (uav_local_nav.c:1430-1438)
    mins = tm["tof_min"]
    a_ = _F32(cfg.tof.filt_alpha)
    blended = _f(_F32(1.0) - a_) * S["tof_filt"] + float(a_) * mins
    upd = W(torch.isnan(S["tof_filt"]), mins, blended)
    S["tof_filt"] = W(torch.isnan(mins), S["tof_filt"], upd)

    # battery_failsafe_tick (uav_local_nav.c:1797-1837)
    bt = cfg.battery
    on_gnd = batt_fresh & ~tm["fc_armed"]
    warn = (on_gnd & tm["want_arm"] & (tm["batt_vpc"] < _f(bt.arm_min_vpc))
            & (t - S["b_warn"] > bt.low_hold_ms))
    S["b_warn"] = W(warn, t, S["b_warn"])
    S["b_low"] = W(on_gnd, 0, S["b_low"])
    S["b_emerg"] = W(on_gnd, 0, S["b_emerg"])
    in_air_b = batt_fresh & tm["fc_armed"]
    emergv = in_air_b & (tm["batt_vpc"] < _f(bt.emerg_vpc))
    S["b_emerg"] = W(emergv & (S["b_emerg"] == 0), t, S["b_emerg"])
    emerg_trip = emergv & (S["b_emerg"] != 0) & (t - S["b_emerg"] > bt.low_hold_ms)
    S["kf"] = W(emerg_trip, S["kf"] | KF_BATT_EMERG, S["kf"])
    if bt.land_actions_enabled:
        enter(ST_LANDING, emerg_trip & (S["st"] != ST_LANDING)
              & (S["st"] != ST_DISARMING))
    S["b_emerg"] = W(in_air_b & ~emergv, 0, S["b_emerg"])
    lowv = in_air_b & (tm["batt_vpc"] < _f(bt.land_vpc))
    S["b_low"] = W(lowv & (S["b_low"] == 0), t, S["b_low"])
    low_trip = lowv & (S["b_low"] != 0) & (t - S["b_low"] > bt.low_hold_ms)
    S["kf"] = W(low_trip, S["kf"] | KF_BATT_LAND, S["kf"])
    if bt.land_actions_enabled:
        enter(ST_LANDING, low_trip & (S["st"] != ST_LANDING)
              & (S["st"] != ST_DISARMING))
    S["b_low"] = W(in_air_b & ~lowv, 0, S["b_low"])

    # 2 Hz status print's vel_xy_stable call (uav_local_nav.c:1886-1889)
    print_due = t - S["print_last"] >= 500
    S["print_last"] = W(print_due, t, S["print_last"])
    vel_xy_stable(print_due)

    # ---- guards; `done` short-circuits the rest of the tick ----
    no_fc = ~tm["have_fc"]
    enter(ST_WAIT_LINK, no_fc)
    done = no_fc

    ng = ~done & hard_nogo
    enter(ST_DISARMING, ng & tm["fc_armed"])
    enter(ST_IDLE, ng & ~tm["fc_armed"])
    done = done | ng

    live = ~done
    unexp = (live & S["armed_prev"] & ~tm["fc_armed"] & tm["want_arm"]
             & (S["st"] != ST_LANDING) & (S["st"] != ST_DISARMING)
             & (S["st"] != ST_IDLE))
    enter(ST_IDLE, unexp)
    S["armed_prev"] = W(live, tm["fc_armed"], S["armed_prev"])

    enter(ST_DISARMING, live & ~tm["want_arm"] & tm["fc_armed"])

    ceil_override = live & S["ceiling"] & tm["fc_armed"]
    set_cmd(ceil_override, CMD_VEL_NED, 0.0, 0.0, bh.ceiling_descend_mps, 0.0)
    done = done | ceil_override
    live = ~done

    # ---- switch on the post-guard state ----
    st0 = S["st"]

    enter(ST_IDLE, live & (st0 == ST_WAIT_LINK))

    # IDLE (uav_local_nav.c:2035-2042)
    idle = live & (st0 == ST_IDLE)
    batt_ok_arm = (~batt_fresh) | (tm["batt_vpc"] >= _f(bt.arm_min_vpc))
    idle_go = idle & ~(tm["want_arm"] & ~batt_ok_arm)
    enter(ST_ARMING, idle_go & tm["want_arm"] & ~tm["fc_armed"])
    enter(ST_DISARMING, idle_go & ~tm["want_arm"] & tm["fc_armed"])
    enter(ST_TAKEOFF, idle_go & tm["want_arm"] & tm["fc_armed"])

    # ARMING (uav_local_nav.c:2044-2055)
    arming = live & (st0 == ST_ARMING)
    enter(ST_IDLE, arming & ~batt_ok_arm)
    arming_do = arming & batt_ok_arm & ~tm["fc_armed"]
    emit_mode(MODE_GUIDED, arming_do)
    emit_arm(arming_do)
    enter(ST_TAKEOFF, arming & batt_ok_arm & tm["fc_armed"])

    # TAKEOFF (uav_local_nav.c:2057-2169)
    tko = live & (st0 == ST_TAKEOFF)
    emit_mode(MODE_GUIDED, tko & (tm["hb_custom_mode"] != MODE_GUIDED))

    ack_rej = (tko & tm["have_takeoff_ack"] & (t - tm["takeoff_ack_ms"] < 2000)
               & ((tm["takeoff_ack_res"] == RES_DENIED)
                  | (tm["takeoff_ack_res"] == RES_TEMP_REJECTED)))
    enter(ST_LIFTOFF_ASSIST, ack_rej)
    tko = tko & ~ack_rej

    to_m = _f(bh.takeoff_target_m)
    first_send = tko & ~S["to_sent"]
    O["req_takeoff"] = W(first_send, to_m, O["req_takeoff"])
    S["to_sent"] = W(first_send, True, S["to_sent"])
    S["to_sent_ms"] = W(first_send, t, S["to_sent_ms"])
    S["to_no_vel_until"] = W(first_send, t + bh.takeoff_no_vel_ms,
                             S["to_no_vel_until"])
    retry = (tko & ~first_send & ~S["to_started"]
             & (t - S["to_sent_ms"] > bh.takeoff_retry_ms))
    O["req_takeoff"] = W(retry, to_m, O["req_takeoff"])
    S["to_sent_ms"] = W(retry, t, S["to_sent_ms"])
    S["to_no_vel_until"] = W(retry, t + bh.takeoff_no_vel_ms,
                             S["to_no_vel_until"])

    mot_start = _f(bh.takeoff_mot_start_us)
    ramp_exit_m = _f(bh.ramp_exit_m)
    mot_avg = W(servo_fresh_250, tm["motor_avg"], float("nan"))
    mot_started = servo_fresh_250 & (mot_avg > mot_start)
    off_ground = (
        (tm["have_ext"] & (tm["landed_state"] != LANDED_ON_GROUND))
        | (rf_fresh & torch.isfinite(tm["rf_m"]) & (tm["rf_m"] > ramp_exit_m))
        | (torch.isfinite(S["alt_est"]) & (S["alt_est"] > ramp_exit_m))
    )
    start_now = tko & ~S["to_started"] & (mot_started | off_ground)
    S["to_started"] = W(start_now, True, S["to_started"])
    S["to_started_ms"] = W(start_now, t, S["to_started_ms"])

    ref = W(tm["takeoff_accept_ms"] != 0, tm["takeoff_accept_ms"],
            tm["takeoff_ack_ms"])
    ramp_trig = (tko & ~S["to_started"] & tm["have_takeoff_ack"]
                 & (tm["takeoff_ack_res"] == RES_ACCEPTED)
                 & ~S["ramp_active"] & ~S["to_nsp"] & (ref != 0)
                 & (t - ref >= bh.takeoff_start_check_ms)
                 & servo_fresh_250 & (mot_avg <= mot_start))
    S["to_nsp"] = W(ramp_trig, True, S["to_nsp"])
    S["ramp_active"] = W(ramp_trig, True, S["ramp_active"])
    S["ramp_start"] = W(ramp_trig, t, S["ramp_start"])
    S["ramp_last"] = W(ramp_trig, 0, S["ramp_last"])

    ramping = tko & S["ramp_active"]
    cap_yaw = ramping & ~S["yaw_tv"] & tm["have_att"]
    S["yaw_tv"] = W(cap_yaw, True, S["yaw_tv"])
    S["yaw_t"] = W(cap_yaw, tm["yaw_deg"], S["yaw_t"])
    S["ramp_start"] = W(ramping & (S["ramp_start"] == 0), t, S["ramp_start"])
    ramp_send = ramping & (t - S["ramp_last"] >= bh.ramp_send_ms)
    S["ramp_last"] = W(ramp_send, t, S["ramp_last"])
    rdt = (t - S["ramp_start"]).to(_FLT)
    u = torch.clamp(W(rdt >= bh.ramp_total_ms, 1.0,
                      div_f32(rdt, _f(float(bh.ramp_total_ms)))), 0.0, 1.0)
    thr = (1.0 - u) * _f(bh.ramp_thr_min) + u * _f(bh.ramp_thr_max)
    ryaw = W(S["yaw_tv"], S["yaw_t"], W(tm["have_att"], tm["yaw_deg"], 0.0))
    set_cmd(ramp_send, CMD_ATT_THRUST,
            torch.clamp(thr, min=0.0).clamp(max=_f(bh.thrust_clamp)),
            ryaw, 0.0, 0.0)
    ramp_exit = ramping & (off_ground | (servo_fresh_250
                                         & (mot_avg > mot_start)))
    S["ramp_active"] = W(ramp_exit, False, S["ramp_active"])
    S["to_started"] = W(ramp_exit, True, S["to_started"])
    S["to_started_ms"] = W(ramp_exit, t, S["to_started_ms"])
    O["req_takeoff"] = W(ramp_exit, to_m, O["req_takeoff"])
    S["to_no_vel_until"] = W(ramp_exit, t + bh.takeoff_no_vel_ms,
                             S["to_no_vel_until"])
    ramp_abort = (ramping & ~ramp_exit
                  & (t - S["ramp_start"] > bh.ramp_abort_ms))
    S["ramp_active"] = W(ramp_abort, False, S["ramp_active"])
    enter(ST_LIFTOFF_ASSIST, ramp_abort)
    tko = tko & ~ramping  # ramp branch breaks out of the TAKEOFF case

    z_stall = (tko & ~z_ok & ~S["to_started"]
               & torch.isfinite(S["alt_est"]) & (S["alt_est"] < _f(0.10))
               & (t - S["to_sent_ms"] > 1200))
    enter(ST_LIFTOFF_ASSIST, z_stall)
    tko = tko & ~z_stall

    stall = tko & ~S["to_started"] & (t - S["to_sent_ms"] > bh.takeoff_stall_ms)
    enter(ST_LIFTOFF_ASSIST, stall)
    tko = tko & ~stall

    at_alt = (tko & torch.isfinite(S["alt_est"])
              & (S["alt_est"] >= _f(_F32(bh.takeoff_target_m)
                                    - _F32(bh.takeoff_exit_margin_m))))
    S["yaw_tv"] = W(at_alt, tm["have_att"], S["yaw_tv"])
    S["yaw_t"] = W(at_alt, W(tm["have_att"], tm["yaw_deg"], 0.0), S["yaw_t"])
    enter(ST_HOVER, at_alt)

    # LIFTOFF_ASSIST (uav_local_nav.c:1738-1789)
    ast = live & (st0 == ST_LIFTOFF_ASSIST)
    emit_mode(MODE_STABILIZE, ast & (t - S["as_start"] < 150))
    base_now = ast & ~S["as_base"] & servo_fresh_200
    S["as_mot0"] = W(base_now, tm["motor_avg"], S["as_mot0"])
    S["as_base"] = W(base_now, True, S["as_base"])
    as_send = ast & (t - S["as_last"] >= bh.assist_send_period_ms)
    S["as_last"] = W(as_send, t, S["as_last"])
    adt = (t - S["as_start"]).to(_FLT)
    au = torch.clamp(W(adt >= bh.assist_total_ms, 1.0,
                       div_f32(adt, _f(float(bh.assist_total_ms)))), 0.0,
                       1.0)
    athr = torch.round((1.0 - au) * _f(float(bh.assist_thr_us_min))
                       + au * _f(float(bh.assist_thr_us_max)))
    set_cmd(as_send, CMD_RC_OVERRIDE, 1500.0, 1500.0, athr, 1500.0)
    warn_now = (ast & ~S["as_warned"] & S["as_base"]
                & (t - S["as_start"] > bh.assist_override_effect_ms)
                & servo_fresh_200 & torch.isfinite(S["as_mot0"])
                & (tm["motor_avg"] - S["as_mot0"]
                   < _f(bh.assist_motor_delta_min)))
    S["as_warned"] = W(warn_now, True, S["as_warned"])
    as_exit = (ast & torch.isfinite(S["alt_est"])
               & (S["alt_est"] > _f(bh.assist_exit_alt_m)))
    O["rc_release"] = O["rc_release"] | as_exit
    emit_mode(MODE_GUIDED, as_exit)
    O["req_takeoff"] = W(as_exit, to_m, O["req_takeoff"])
    enter(ST_TAKEOFF, as_exit)
    as_abort = ast & ~as_exit & (t - S["as_start"] > bh.assist_abort_ms)
    O["rc_release"] = O["rc_release"] | as_abort
    enter(ST_DISARMING, as_abort)

    # HOVER (uav_local_nav.c:2175-2202)
    hov = live & (st0 == ST_HOVER)
    cap = hov & ~S["yaw_tv"] & tm["have_att"]
    S["yaw_tv"] = W(cap, True, S["yaw_tv"])
    S["yaw_t"] = W(cap, tm["yaw_deg"], S["yaw_t"])
    xy_stable_h = vel_xy_stable(hov)
    hold_cap = (hov & xy_stable_h & ~S["hover_valid"] & lpos_fresh
                & tm["have_att"] & torch.isfinite(S["alt_est"]))
    S["hover_x"] = W(hold_cap, tm["lpos_x"], S["hover_x"])
    S["hover_y"] = W(hold_cap, tm["lpos_y"], S["hover_y"])
    S["hover_z"] = W(hold_cap, -S["alt_est"], S["hover_z"])
    S["hover_yaw"] = W(hold_cap, W(S["yaw_tv"], S["yaw_t"], tm["yaw_deg"]),
                       S["hover_yaw"])
    S["hover_valid"] = W(hold_cap, True, S["hover_valid"])
    pos_hold = hov & xy_stable_h & S["hover_valid"] & lpos_fresh & tm["have_att"]
    set_cmd(pos_hold, CMD_POS_YAW, S["hover_x"], S["hover_y"], S["hover_z"],
            S["hover_yaw"])
    zero_hold = hov & ~pos_hold
    set_cmd(zero_hold, CMD_VEL_BODY, 0.0, 0.0, 0.0, yaw_hold_rate())
    minit = hov & ~tm["map_inited"] & xy_stable_h & S["hover_valid"]
    O["map_init"] = O["map_init"] | minit
    O["map_origin_x"] = W(minit, S["hover_x"], O["map_origin_x"])
    O["map_origin_y"] = W(minit, S["hover_y"], O["map_origin_y"])
    if bh.explore_enabled and not bh.hover_test_only:
        # HOVER_TEST_ONLY `break` lands before this gate
        # (uav_local_nav.c:2196-2199)
        enter(ST_EXPLORE, hov & xy_stable_h
              & (t - S["hover_enter"] > bh.hover_explore_delay_ms))

    # EXPLORE (uav_local_nav.c:2204-2257)
    exp = live & (st0 == ST_EXPLORE)
    xy_stable_e = vel_xy_stable(exp)
    exp_hold = exp & (~xy_stable_e | (t < S["ex_pause"]))
    set_cmd(exp_hold, CMD_VEL_BODY, 0.0, 0.0, 0.0, yaw_hold_rate())
    exp_go = exp & ~exp_hold
    ffilt = S["tof_filt"][..., D_FRONT]
    front_close = (exp_go & torch.isfinite(ffilt)
                   & (ffilt < _f(bh.front_stop_m)))
    S["turn_forced"] = W(front_close, False, S["turn_forced"])
    enter(ST_TURNING, front_close)
    exp_go = exp_go & ~front_close
    fr_due = (exp_go & tm["map_inited"] & lpos_fresh & tm["have_att"]
              & (t - S["fr_eval"] > bh.frontier_eval_ms))
    S["fr_eval"] = W(fr_due, t, S["fr_eval"])
    sF, sR = tm["frontier_f"], tm["frontier_r"]
    sL, sB = tm["frontier_l"], tm["frontier_b"]
    best = torch.maximum(torch.maximum(sF, sR), torch.maximum(sL, sB))
    best_dir = full(D_FRONT, _I32)
    best_dir = W(sR > sF, D_RIGHT, best_dir)
    best_dir = W(sL > torch.maximum(sF, sR), D_LEFT, best_dir)
    best_dir = W(sB > torch.maximum(torch.maximum(sF, sR), sL), D_BACK, best_dir)
    side_dist = torch.gather(S["tof_filt"], -1,
                             best_dir[..., None].long())[..., 0]
    fr_turn = (fr_due & (best_dir != D_FRONT)
               & (best > sF + bh.frontier_side_margin)
               & torch.isfinite(side_dist) & (side_dist > _f(bh.side_safe_m)))
    S["turn_forced"] = W(fr_turn, True, S["turn_forced"])
    S["forced_dir"] = W(fr_turn, best_dir, S["forced_dir"])
    enter(ST_TURNING, fr_turn)
    exp_go = exp_go & ~fr_turn
    set_cmd(exp_go, CMD_VEL_BODY, bh.fwd_vel_mps, 0.0, 0.0, yaw_hold_rate())

    # TURNING (uav_local_nav.c:2259-2296)
    trn = live & (st0 == ST_TURNING)
    init_now = trn & ~S["turn_init"]
    # choose_turn_dir_frontier (uav_local_nav.c:1715-1736)
    tf = S["tof_filt"]
    bias = _f(bh.frontier_tof_bias)
    side = lambda d: W(torch.isnan(tf[..., d]), 0.0, tf[..., d])      # noqa: E731
    fsR = tm["frontier_r"] + (side(D_RIGHT) * bias).to(_I32)
    fsL = tm["frontier_l"] + (side(D_LEFT) * bias).to(_I32)
    fsB = tm["frontier_b"] + (side(D_BACK) * bias).to(_I32)
    fdir = full(D_RIGHT, _I32)
    fdir = W(fsL > fsR, D_LEFT, fdir)
    fdir = W(fsB > torch.maximum(fsR, fsL), D_BACK, fdir)
    # open_side_dir fallback (uav_local_nav.c:1700-1713)
    ob, od = full(-1.0, _FLT), full(D_RIGHT, _I32)
    for dd in (D_RIGHT, D_LEFT, D_BACK):
        val = tf[..., dd]
        better = torch.isfinite(val) & (val > ob)
        ob = W(better, val, ob)
        od = W(better, dd, od)
    use_frontier = tm["map_inited"] & lpos_fresh & tm["have_att"]
    chosen = W(use_frontier, fdir, od)
    new_dir = W(S["turn_forced"], S["forced_dir"], chosen)
    S["turn_dir"] = W(init_now, new_dir, S["turn_dir"])
    S["turn_forced"] = W(init_now & S["turn_forced"], False, S["turn_forced"])
    cur = W(tm["have_att"], tm["yaw_deg"], 0.0)
    delta = W(S["turn_dir"] == D_RIGHT, 90.0,
              W(S["turn_dir"] == D_LEFT, -90.0, 180.0))
    S["turn_target"] = W(init_now, _wrap_deg(cur + delta), S["turn_target"])
    S["turn_start"] = W(init_now, t, S["turn_start"])
    S["turn_init"] = W(init_now, True, S["turn_init"])
    err = _wrap_deg(S["turn_target"] - cur)
    rate = _f(bh.yaw_rate_dps)
    yr = torch.clamp(err * _f(bh.turn_gain), -rate, rate)
    set_cmd(trn, CMD_VEL_BODY, 0.0, 0.0, 0.0, yr)
    turn_done = trn & ((err.abs() < _f(bh.turn_exit_err_deg))
                       | (t - S["turn_start"] > bh.turn_timeout_ms))
    S["yaw_tv"] = W(turn_done, True, S["yaw_tv"])
    S["yaw_t"] = W(turn_done, S["turn_target"], S["yaw_t"])
    S["turn_init"] = W(turn_done, False, S["turn_init"])
    enter(ST_EXPLORE, turn_done)

    # LANDING (uav_local_nav.c:2298-2317)
    lnd = live & (st0 == ST_LANDING)
    first_land = lnd & ~S["land_sent"]
    emit_mode(MODE_LAND, first_land)
    S["land_sent"] = W(first_land, True, S["land_sent"])
    S["land_sent_ms"] = W(first_land, t, S["land_sent_ms"])
    re_land = lnd & ~first_land & (t - S["land_sent_ms"] > 2000)
    emit_mode(MODE_LAND, re_land)
    S["land_sent_ms"] = W(re_land, t, S["land_sent_ms"])
    set_cmd(lnd, CMD_VEL_NED, 0.0, 0.0, bh.landing_descent_mps, 0.0)
    near_gnd = (torch.isfinite(S["alt_est"])
                & (S["alt_est"] < _f(bh.landing_near_ground_m)))
    enter(ST_DISARMING, lnd & (near_gnd | (tm["have_ext"]
                                           & (tm["landed_state"] == LANDED_ON_GROUND))))

    # DISARMING (uav_local_nav.c:2319-2327)
    dis = live & (st0 == ST_DISARMING)
    emit_disarm_force(dis & tm["fc_armed"])
    enter(ST_IDLE, dis & ~tm["fc_armed"])

    new_state = BehaviorState(**S)
    O["state"] = S["st"]
    O["kf_flags"] = S["kf"]
    O["alt_est"] = S["alt_est"]
    O["alt_src"] = S["alt_src"]
    O["ceiling"] = S["ceiling"]
    return new_state, O


def drain_kf(state: BehaviorState):
    """Keyframe flags are drained into the next scanrec
    (uav_local_nav.c:1573); returns (state, flags)."""
    return state._replace(kf=torch.zeros_like(state.kf)), state.kf
