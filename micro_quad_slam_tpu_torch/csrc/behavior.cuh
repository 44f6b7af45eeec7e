// The UL flight state machine's control tick for a batch of quads, for
// NVIDIA Hopper (sm_90a).  replay_exact.cu includes this header once and so
// exports mqs_behavior_step; models/behavior.py::behavior_step_kernel calls
// it, once a tick of the closed-loop simulator (models/simulator.py).
//
// It replaces no Pallas kernel: it is the counterpart of the JAX machine
// micro_quad_slam_tpu/models/behavior.py::behavior_step (jnp.where code over
// the batch) and of its plain torch twin models/behavior.py::
// behavior_step_plain, the reference's 50 Hz control_tick
// (uav_local_nav.c:1866-2333).  Per quad, in behavior_step_plain's order:
// the telemetry predicates, the heartbeat, update_alt_estimate and the
// ceiling latch, the ToF EMA, the battery failsafe, the 2 Hz vel_xy_stable
// call, the guards with their `done` short-circuit, and the switch on the
// post-guard state st0.  enter() keeps its side effects (rc_release,
// clear_takeoff_ack, the keyframe bits, ex_pause on leaving TURNING) and the
// command rate limiters are consumed in C call order.
//
// Rounding.  The outputs are the torch path's bits on this card, so every
// float operation is spelled with an _rn intrinsic (the build passes
// -fmad=false) in the order the torch code evaluates it: (1 - a)*filt and
// a*min, then their sum; (1 - u)*lo + u*hi likewise.  div_f32's quotients
// are __fdiv_rn; torch.round is rintf (half to even); .to(int32) truncates
// (__float2int_rz, which saturates as torch's cast does on the card);
// torch.clamp returns a NaN operand as it is and otherwise takes
// fmaxf then fminf, as its CUDA kernel does; _wrap_deg is its two
// conditional folds each way.  int32 sums and differences wrap, as torch's
// do, through unsigned arithmetic.  A NaN the torch code writes from a
// Python float is 0x7fc00000 here too.
//
// What bounds it on this card: neither bytes (~510 a quad: its telemetry,
// its state read and written, its outputs) nor arithmetic (a few hundred
// operations a quad), but the launch itself.  In torch the tick was ~1,470
// launches of [B]-wide elementwise ops, each ~1 us of work on the card and
// ~12 us of the host's time.  So one thread per quad loads its state and
// telemetry once into registers, runs the tick as straight-line C, and
// writes the new state and the outputs once.  The telemetry arrives as the
// simulator assembles it, some fields strided views (`mean[..., 0]`,
// `fr[..., k]`) or a stride-0 broadcast (`want_arm`): each field is read
// through its own byte stride, so nothing is copied.  The pointers,
// strides and configuration travel as the kernel's parameters, so nothing
// but the kernel's own launch is added.  Each output field is written
// through a pointer of its own, so the wrapper lays them out in blocks by
// how long they live (models/behavior.py::_OUT_BLOCKS).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBehThreads = 128;   // quads of a block, one thread each

// Telemetry fields, in models/behavior.py::_TM_FIELDS' order; tof_min
// [B, 4] last.  (tests/test_torch_seam.py holds the enumerator names to the
// Python tables.)
enum BehTm {
  TM_t_ms, TM_have_fc, TM_fc_armed, TM_hb_custom_mode, TM_have_ext,
  TM_landed_state, TM_have_sys, TM_sys_last_ms, TM_sys_health,
  TM_have_servo, TM_servo_last_ms, TM_motor_avg, TM_batt_vpc, TM_batt_cells,
  TM_batt_last_ms, TM_have_lpos, TM_lpos_last_ms, TM_lpos_x, TM_lpos_y,
  TM_lpos_alt_filt, TM_have_att, TM_yaw_deg, TM_have_of, TM_of_last_ms,
  TM_of_q, TM_have_rf, TM_rf_last_ms, TM_rf_m, TM_want_arm,
  TM_have_takeoff_ack, TM_takeoff_ack_res, TM_takeoff_ack_ms,
  TM_takeoff_accept_ms, TM_map_inited, TM_frontier_f, TM_frontier_r,
  TM_frontier_l, TM_frontier_b, TM_tof_min, kBehTm
};

// The state's fields, in BehaviorState's order; tof_filt [B, 4] last.
enum BehSt {
  BS_st, BS_yaw_tv, BS_yaw_t, BS_hover_valid, BS_hover_x, BS_hover_y,
  BS_hover_z, BS_hover_yaw, BS_hover_enter, BS_turn_init, BS_turn_dir,
  BS_turn_target, BS_turn_start, BS_turn_forced, BS_forced_dir, BS_ceiling,
  BS_alt_est, BS_alt_src, BS_to_sent, BS_to_sent_ms, BS_to_no_vel_until,
  BS_to_started, BS_to_started_ms, BS_to_nsp, BS_ramp_active,
  BS_ramp_start, BS_ramp_last, BS_as_start, BS_as_last, BS_as_base,
  BS_as_mot0, BS_as_warned, BS_land_sent, BS_land_sent_ms, BS_b_low,
  BS_b_emerg, BS_b_warn, BS_xy_since, BS_lim_arm, BS_lim_mode,
  BS_lim_disarm, BS_fr_eval, BS_ex_pause, BS_armed_prev, BS_kf, BS_hb_last,
  BS_print_last, BS_tof_filt, kBehSt
};

// The 32-bit output fields [B]: the state's int32 fields, then its
// float32 fields, each in BehaviorState's order, then the outputs.
enum BehWordRow {
  WR_st, WR_hover_enter, WR_turn_dir, WR_turn_start, WR_forced_dir,
  WR_alt_src, WR_to_sent_ms, WR_to_no_vel_until, WR_to_started_ms,
  WR_ramp_start, WR_ramp_last, WR_as_start, WR_as_last, WR_land_sent_ms,
  WR_b_low, WR_b_emerg, WR_b_warn, WR_xy_since, WR_lim_arm, WR_lim_mode,
  WR_lim_disarm, WR_fr_eval, WR_ex_pause, WR_kf, WR_hb_last, WR_print_last,
  WR_yaw_t, WR_hover_x, WR_hover_y, WR_hover_z, WR_hover_yaw,
  WR_turn_target, WR_alt_est, WR_as_mot0, WR_cmd_kind, WR_req_mode,
  WR_req_arm, WR_req_takeoff, WR_map_origin_x, WR_map_origin_y, kBehWordRows
};

// The bool output fields [B]: the state's bool fields in BehaviorState's
// order, then the outputs.
enum BehFlagRow {
  FR_yaw_tv, FR_hover_valid, FR_turn_init, FR_turn_forced, FR_ceiling,
  FR_to_sent, FR_to_started, FR_to_nsp, FR_ramp_active, FR_as_base,
  FR_as_warned, FR_land_sent, FR_armed_prev, FR_rc_release,
  FR_clear_takeoff_ack, FR_map_init, kBehFlagRows
};

// The configuration's floats (each rounded to float32 by the wrapper,
// models/behavior.py::kernel_config) and ints, in its order.
enum BehCfgFloat {
  CF_xy_min_alt_m, CF_ceil_m, CF_ceil_release_m, CF_filt_alpha,
  CF_filt_keep, CF_arm_min_vpc, CF_emerg_vpc, CF_land_vpc, CF_yaw_rate_dps,
  CF_yaw_hold_gain, CF_ceiling_descend_mps, CF_takeoff_target_m,
  CF_takeoff_mot_start_us, CF_ramp_exit_m, CF_ramp_total_ms,
  CF_ramp_thr_min, CF_ramp_thr_max, CF_thrust_clamp, CF_takeoff_at_alt_m,
  CF_assist_total_ms, CF_assist_thr_us_min, CF_assist_thr_us_max,
  CF_assist_motor_delta_min, CF_assist_exit_alt_m, CF_front_stop_m,
  CF_side_safe_m, CF_fwd_vel_mps, CF_frontier_tof_bias, CF_turn_gain,
  CF_turn_exit_err_deg, CF_landing_descent_mps, CF_landing_near_ground_m,
  kBehCfgFloats
};
enum BehCfgInt {
  CI_of_min_quality, CI_xy_stable_hold_ms, CI_low_hold_ms,
  CI_land_actions_enabled, CI_post_turn_pause_ms, CI_takeoff_no_vel_ms,
  CI_takeoff_retry_ms, CI_takeoff_start_check_ms, CI_ramp_send_ms,
  CI_ramp_abort_ms, CI_takeoff_stall_ms, CI_assist_send_period_ms,
  CI_assist_override_effect_ms, CI_assist_abort_ms,
  CI_hover_explore_delay_ms, CI_explore_gate, CI_frontier_eval_ms,
  CI_frontier_side_margin, CI_turn_timeout_ms, kBehCfgInts
};

// states, directions and the rest of behavior.py's constants
constexpr int32_t kWaitLink = 0, kIdle = 1, kArming = 2, kTakeoff = 3,
                  kLiftoffAssist = 4, kHover = 5, kExplore = 6, kTurning = 7,
                  kLanding = 8, kDisarming = 9;
constexpr int32_t kFront = 0, kRight = 1, kBack = 2, kLeft = 3;
constexpr int32_t kLandedOnGround = 1;
constexpr int32_t kResAccepted = 0, kResTempRejected = 1, kResDenied = 2;
constexpr int32_t kGyro = 0x01, kZAlt = 0x2000, kXyPos = 0x4000,
                  kMotors = 0x400000;
constexpr int32_t kAltNone = 0, kAltLpos = 1, kAltRf = 2, kAltGnd = 3;
constexpr int32_t kCmdVelBody = 1, kCmdVelNed = 2, kCmdPosYaw = 3,
                  kCmdAttThrust = 4, kCmdRcOverride = 5;
constexpr int32_t kModeStabilize = 0, kModeGuided = 4, kModeLand = 9;
constexpr int32_t kKfTakeoff = 1, kKfTurnStart = 2, kKfTurnEnd = 4,
                  kKfLandStart = 8, kKfLiftoffAst = 16, kKfBattLand = 64,
                  kKfBattEmerg = 128;

// the output pointers: the 32-bit fields, the bool fields, then tof_filt
// and cmd [B, 4], each contiguous
constexpr int kBehOutTofFilt = kBehWordRows + kBehFlagRows;
constexpr int kBehOutCmd = kBehOutTofFilt + 1;
constexpr int kBehOuts = kBehOutCmd + 1;

struct BehArgs {
  const void* in[kBehTm + kBehSt];   // telemetry, then the state
  // byte strides: each field's (the row stride of tof_min and tof_filt),
  // then tof_min's and tof_filt's column strides
  int stride[kBehTm + kBehSt + 2];
  void* out[kBehOuts];
  float f[kBehCfgFloats];
  int i[kBehCfgInts];
};

struct BehTelemetry {
  int32_t t_ms, hb_custom_mode, landed_state, sys_last_ms, sys_health,
      servo_last_ms, batt_cells, batt_last_ms, lpos_last_ms, of_last_ms, of_q,
      rf_last_ms, takeoff_ack_res, takeoff_ack_ms, takeoff_accept_ms,
      frontier_f, frontier_r, frontier_l, frontier_b;
  bool have_fc, fc_armed, have_ext, have_sys, have_servo, have_lpos,
      have_att, have_of, have_rf, want_arm, have_takeoff_ack, map_inited;
  float motor_avg, batt_vpc, lpos_x, lpos_y, lpos_alt_filt, yaw_deg, rf_m,
      tof_min[4];
};

struct BehState {
  int32_t st, hover_enter, turn_dir, turn_start, forced_dir, alt_src,
      to_sent_ms, to_no_vel_until, to_started_ms, ramp_start, ramp_last,
      as_start, as_last, land_sent_ms, b_low, b_emerg, b_warn, xy_since,
      lim_arm, lim_mode, lim_disarm, fr_eval, ex_pause, kf, hb_last,
      print_last;
  float yaw_t, hover_x, hover_y, hover_z, hover_yaw, turn_target, alt_est,
      as_mot0, tof_filt[4];
  bool yaw_tv, hover_valid, turn_init, turn_forced, ceiling, to_sent,
      to_started, to_nsp, ramp_active, as_base, as_warned, land_sent,
      armed_prev;
};

struct BehOutputs {
  int32_t cmd_kind, req_mode, req_arm;
  float cmd[4], req_takeoff, map_origin_x, map_origin_y;
  bool rc_release, clear_takeoff_ack, map_init;
};

template <typename T>
__device__ __forceinline__ T beh_ld(const BehArgs& a, int slot, int b,
                                    int extra = 0) {
  const char* p = static_cast<const char*>(a.in[slot]) +
                  static_cast<long long>(b) * a.stride[slot] + extra;
  return *reinterpret_cast<const T*>(p);
}

__device__ __forceinline__ bool beh_flag(const BehArgs& a, int slot, int b) {
  return beh_ld<uint8_t>(a, slot, b) != 0;
}

// int32 arithmetic that wraps, as torch's does
__device__ __forceinline__ int32_t beh_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t beh_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// torch.clamp's CUDA kernels: a NaN operand comes back as it is
__device__ __forceinline__ float beh_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float beh_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float beh_clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// models/behavior.py::_wrap_deg: two conditional folds each way
__device__ __forceinline__ float beh_wrap_deg(float d) {
  if (d >= 180.0f) d = __fsub_rn(d, 360.0f);
  if (d >= 180.0f) d = __fsub_rn(d, 360.0f);
  if (d < -180.0f) d = __fadd_rn(d, 360.0f);
  if (d < -180.0f) d = __fadd_rn(d, 360.0f);
  return d;
}

// the NaN torch writes for a Python float("nan")
__device__ __forceinline__ float beh_nan() { return __int_as_float(0x7fc00000); }

// One tick of one quad: behavior_step_plain's body, lane by lane.
struct BehTick {
  const BehTelemetry& tm;
  const BehArgs& a;
  BehState& s;
  BehOutputs& o;
  int32_t t;
  bool sys_fresh = false, of_fresh = false, lpos_fresh = false,
       rf_fresh = false, batt_fresh = false, servo_fresh_250 = false,
       servo_fresh_200 = false, z_ok = false, xy_ok = false;

  __device__ float cf(int k) const { return a.f[k]; }
  __device__ int ci(int k) const { return a.i[k]; }

  __device__ bool bit_ok(int32_t bit) const {
    return !sys_fresh || (tm.sys_health & bit) != 0;
  }

  // enter_state (uav_local_nav.c:1642-1698) under a predicate
  __device__ void enter(int32_t ns, bool cond) {
    const bool c = cond && s.st != ns;
    if (!c) return;
    if (s.st == kLiftoffAssist) o.rc_release = true;
    if (ns == kTakeoff) {
      s.to_sent = false;
      s.to_sent_ms = 0;
      s.to_no_vel_until = 0;
      s.to_started = false;
      s.to_started_ms = 0;
      s.to_nsp = false;
      s.ramp_active = false;
      s.ramp_start = 0;
      s.ramp_last = 0;
      o.clear_takeoff_ack = true;
      s.kf |= kKfTakeoff;
    }
    if (ns == kLiftoffAssist) {
      s.as_start = t;
      s.as_last = 0;
      s.as_base = false;
      s.as_mot0 = beh_nan();
      s.as_warned = false;
      s.kf |= kKfLiftoffAst;
    }
    if (ns == kHover) {
      s.hover_enter = t;
      s.hover_valid = false;
    }
    if (ns == kLanding) {
      s.land_sent = false;
      s.land_sent_ms = 0;
      s.kf |= kKfLandStart;
    }
    if (s.st == kTurning) {
      s.turn_init = false;
      s.kf |= kKfTurnEnd;
      s.ex_pause = beh_add(t, ci(CI_post_turn_pause_ms));
    }
    if (ns == kTurning) s.kf |= kKfTurnStart;
    s.st = ns;
  }

  __device__ void emit_mode(int32_t mode, bool cond) {
    if (cond && tm.have_fc && beh_sub(t, s.lim_mode) >= 800) {
      s.lim_mode = t;
      o.req_mode = mode;
    }
  }
  __device__ void emit_arm(bool cond) {
    if (cond && tm.have_fc && beh_sub(t, s.lim_arm) >= 800) {
      s.lim_arm = t;
      o.req_arm = 1;
    }
  }
  __device__ void emit_disarm_force(bool cond) {
    if (cond && tm.have_fc && beh_sub(t, s.lim_disarm) >= 800) {
      s.lim_disarm = t;
      o.req_arm = 0;
    }
  }

  __device__ void set_cmd(bool cond, int32_t kind, float c0, float c1,
                          float c2, float c3) {
    if (!cond) return;
    o.cmd_kind = kind;
    o.cmd[0] = c0;
    o.cmd[1] = c1;
    o.cmd[2] = c2;
    o.cmd[3] = c3;
  }

  __device__ bool vel_xy_allowed() const {
    return xy_ok && tm.have_att && lpos_fresh &&
           !(of_fresh && tm.of_q < ci(CI_of_min_quality)) &&
           !(isfinite(s.alt_est) && s.alt_est < cf(CF_xy_min_alt_m));
  }

  __device__ bool vel_xy_stable(bool callc) {
    const bool allowed = vel_xy_allowed();
    if (callc && allowed && s.xy_since == 0) s.xy_since = t;
    if (callc && !allowed) s.xy_since = 0;
    return allowed && s.xy_since != 0 &&
           beh_sub(t, s.xy_since) >= ci(CI_xy_stable_hold_ms);
  }

  __device__ float yaw_hold_rate() const {
    const float err = beh_wrap_deg(__fsub_rn(s.yaw_t, tm.yaw_deg));
    const float rate = cf(CF_yaw_rate_dps);
    const float yr = beh_clamp(__fmul_rn(err, cf(CF_yaw_hold_gain)), -rate,
                               rate);
    return (s.yaw_tv && tm.have_att) ? yr : 0.0f;
  }

  // (1 - u) * lo + u * hi, with u = clamp(dt >= total ? 1 : dt / total)
  __device__ float ramp(int32_t since, float total, float lo, float hi) const {
    const float dt = __int2float_rn(beh_sub(t, since));
    const float u =
        beh_clamp(dt >= total ? 1.0f : __fdiv_rn(dt, total), 0.0f, 1.0f);
    return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), lo), __fmul_rn(u, hi));
  }

  __device__ void takeoff() {
    // TAKEOFF (uav_local_nav.c:2057-2169)
    emit_mode(kModeGuided, tm.hb_custom_mode != kModeGuided);
    const bool ack_rej =
        tm.have_takeoff_ack && beh_sub(t, tm.takeoff_ack_ms) < 2000 &&
        (tm.takeoff_ack_res == kResDenied ||
         tm.takeoff_ack_res == kResTempRejected);
    enter(kLiftoffAssist, ack_rej);
    if (ack_rej) return;

    const float to_m = cf(CF_takeoff_target_m);
    const bool first_send = !s.to_sent;
    if (first_send) {
      o.req_takeoff = to_m;
      s.to_sent = true;
      s.to_sent_ms = t;
      s.to_no_vel_until = beh_add(t, ci(CI_takeoff_no_vel_ms));
    }
    const bool retry = !first_send && !s.to_started &&
                       beh_sub(t, s.to_sent_ms) > ci(CI_takeoff_retry_ms);
    if (retry) {
      o.req_takeoff = to_m;
      s.to_sent_ms = t;
      s.to_no_vel_until = beh_add(t, ci(CI_takeoff_no_vel_ms));
    }

    const float mot_start = cf(CF_takeoff_mot_start_us);
    const float ramp_exit_m = cf(CF_ramp_exit_m);
    const float mot_avg = servo_fresh_250 ? tm.motor_avg : beh_nan();
    const bool mot_started = servo_fresh_250 && mot_avg > mot_start;
    const bool off_ground =
        (tm.have_ext && tm.landed_state != kLandedOnGround) ||
        (rf_fresh && isfinite(tm.rf_m) && tm.rf_m > ramp_exit_m) ||
        (isfinite(s.alt_est) && s.alt_est > ramp_exit_m);
    if (!s.to_started && (mot_started || off_ground)) {
      s.to_started = true;
      s.to_started_ms = t;
    }

    const int32_t ref =
        tm.takeoff_accept_ms != 0 ? tm.takeoff_accept_ms : tm.takeoff_ack_ms;
    const bool ramp_trig =
        !s.to_started && tm.have_takeoff_ack &&
        tm.takeoff_ack_res == kResAccepted && !s.ramp_active && !s.to_nsp &&
        ref != 0 && beh_sub(t, ref) >= ci(CI_takeoff_start_check_ms) &&
        servo_fresh_250 && mot_avg <= mot_start;
    if (ramp_trig) {
      s.to_nsp = true;
      s.ramp_active = true;
      s.ramp_start = t;
      s.ramp_last = 0;
    }

    if (s.ramp_active) {   // the ramp branch breaks out of the case
      if (!s.yaw_tv && tm.have_att) {
        s.yaw_tv = true;
        s.yaw_t = tm.yaw_deg;
      }
      if (s.ramp_start == 0) s.ramp_start = t;
      const bool ramp_send = beh_sub(t, s.ramp_last) >= ci(CI_ramp_send_ms);
      if (ramp_send) {
        s.ramp_last = t;
        const float thr = ramp(s.ramp_start, cf(CF_ramp_total_ms),
                               cf(CF_ramp_thr_min), cf(CF_ramp_thr_max));
        const float ryaw =
            s.yaw_tv ? s.yaw_t : (tm.have_att ? tm.yaw_deg : 0.0f);
        set_cmd(true, kCmdAttThrust,
                beh_clamp_max(beh_clamp_min(thr, 0.0f),
                              cf(CF_thrust_clamp)),
                ryaw, 0.0f, 0.0f);
      }
      const bool ramp_exit =
          off_ground || (servo_fresh_250 && mot_avg > mot_start);
      if (ramp_exit) {
        s.ramp_active = false;
        s.to_started = true;
        s.to_started_ms = t;
        o.req_takeoff = to_m;
        s.to_no_vel_until = beh_add(t, ci(CI_takeoff_no_vel_ms));
      }
      const bool ramp_abort =
          !ramp_exit && beh_sub(t, s.ramp_start) > ci(CI_ramp_abort_ms);
      if (ramp_abort) s.ramp_active = false;
      enter(kLiftoffAssist, ramp_abort);
      return;
    }

    const bool z_stall = !z_ok && !s.to_started && isfinite(s.alt_est) &&
                         s.alt_est < 0.10f && beh_sub(t, s.to_sent_ms) > 1200;
    enter(kLiftoffAssist, z_stall);
    if (z_stall) return;

    const bool stall =
        !s.to_started && beh_sub(t, s.to_sent_ms) > ci(CI_takeoff_stall_ms);
    enter(kLiftoffAssist, stall);
    if (stall) return;

    const bool at_alt =
        isfinite(s.alt_est) && s.alt_est >= cf(CF_takeoff_at_alt_m);
    if (at_alt) {
      s.yaw_tv = tm.have_att;
      s.yaw_t = tm.have_att ? tm.yaw_deg : 0.0f;
    }
    enter(kHover, at_alt);
  }

  __device__ void liftoff_assist() {
    // LIFTOFF_ASSIST (uav_local_nav.c:1738-1789)
    emit_mode(kModeStabilize, beh_sub(t, s.as_start) < 150);
    if (!s.as_base && servo_fresh_200) {
      s.as_mot0 = tm.motor_avg;
      s.as_base = true;
    }
    if (beh_sub(t, s.as_last) >= ci(CI_assist_send_period_ms)) {
      s.as_last = t;
      const float athr =
          rintf(ramp(s.as_start, cf(CF_assist_total_ms),
                     cf(CF_assist_thr_us_min), cf(CF_assist_thr_us_max)));
      set_cmd(true, kCmdRcOverride, 1500.0f, 1500.0f, athr, 1500.0f);
    }
    if (!s.as_warned && s.as_base &&
        beh_sub(t, s.as_start) > ci(CI_assist_override_effect_ms) &&
        servo_fresh_200 && isfinite(s.as_mot0) &&
        __fsub_rn(tm.motor_avg, s.as_mot0) < cf(CF_assist_motor_delta_min))
      s.as_warned = true;
    const bool as_exit =
        isfinite(s.alt_est) && s.alt_est > cf(CF_assist_exit_alt_m);
    if (as_exit) {
      o.rc_release = true;
      emit_mode(kModeGuided, true);
      o.req_takeoff = cf(CF_takeoff_target_m);
    }
    enter(kTakeoff, as_exit);
    const bool as_abort =
        !as_exit && beh_sub(t, s.as_start) > ci(CI_assist_abort_ms);
    if (as_abort) o.rc_release = true;
    enter(kDisarming, as_abort);
  }

  __device__ void hover() {
    // HOVER (uav_local_nav.c:2175-2202)
    if (!s.yaw_tv && tm.have_att) {
      s.yaw_tv = true;
      s.yaw_t = tm.yaw_deg;
    }
    const bool xy_stable = vel_xy_stable(true);
    if (xy_stable && !s.hover_valid && lpos_fresh && tm.have_att &&
        isfinite(s.alt_est)) {
      s.hover_x = tm.lpos_x;
      s.hover_y = tm.lpos_y;
      s.hover_z = -s.alt_est;
      s.hover_yaw = s.yaw_tv ? s.yaw_t : tm.yaw_deg;
      s.hover_valid = true;
    }
    const bool pos_hold =
        xy_stable && s.hover_valid && lpos_fresh && tm.have_att;
    if (pos_hold)
      set_cmd(true, kCmdPosYaw, s.hover_x, s.hover_y, s.hover_z,
              s.hover_yaw);
    else
      set_cmd(true, kCmdVelBody, 0.0f, 0.0f, 0.0f, yaw_hold_rate());
    if (!tm.map_inited && xy_stable && s.hover_valid) {
      o.map_init = true;
      o.map_origin_x = s.hover_x;
      o.map_origin_y = s.hover_y;
    }
    // HOVER_TEST_ONLY `break` lands before this gate
    // (uav_local_nav.c:2196-2199)
    if (ci(CI_explore_gate))
      enter(kExplore, xy_stable && beh_sub(t, s.hover_enter) >
                                       ci(CI_hover_explore_delay_ms));
  }

  __device__ void explore() {
    // EXPLORE (uav_local_nav.c:2204-2257)
    const bool xy_stable = vel_xy_stable(true);
    if (!xy_stable || t < s.ex_pause) {
      set_cmd(true, kCmdVelBody, 0.0f, 0.0f, 0.0f, yaw_hold_rate());
      return;
    }
    const float ffilt = s.tof_filt[kFront];
    if (isfinite(ffilt) && ffilt < cf(CF_front_stop_m)) {
      s.turn_forced = false;
      enter(kTurning, true);
      return;
    }
    const bool fr_due = tm.map_inited && lpos_fresh && tm.have_att &&
                        beh_sub(t, s.fr_eval) > ci(CI_frontier_eval_ms);
    if (fr_due) {
      s.fr_eval = t;
      const int32_t sF = tm.frontier_f, sR = tm.frontier_r,
                    sL = tm.frontier_l, sB = tm.frontier_b;
      const int32_t best = max(max(sF, sR), max(sL, sB));
      int32_t best_dir = kFront;
      if (sR > sF) best_dir = kRight;
      if (sL > max(sF, sR)) best_dir = kLeft;
      if (sB > max(max(sF, sR), sL)) best_dir = kBack;
      const float side_dist = s.tof_filt[best_dir];
      const bool fr_turn =
          best_dir != kFront &&
          best > beh_add(sF, ci(CI_frontier_side_margin)) &&
          isfinite(side_dist) && side_dist > cf(CF_side_safe_m);
      if (fr_turn) {
        s.turn_forced = true;
        s.forced_dir = best_dir;
        enter(kTurning, true);
        return;
      }
    }
    set_cmd(true, kCmdVelBody, cf(CF_fwd_vel_mps), 0.0f, 0.0f,
            yaw_hold_rate());
  }

  __device__ void turning() {
    // TURNING (uav_local_nav.c:2259-2296)
    const float cur = tm.have_att ? tm.yaw_deg : 0.0f;
    if (!s.turn_init) {
      // choose_turn_dir_frontier (uav_local_nav.c:1715-1736)
      const float bias = cf(CF_frontier_tof_bias);
      int32_t fs[4];
      for (int d = kRight; d <= kLeft; ++d) {
        const float v = isnan(s.tof_filt[d]) ? 0.0f : s.tof_filt[d];
        fs[d] = __float2int_rz(__fmul_rn(v, bias));
      }
      const int32_t fsR = beh_add(tm.frontier_r, fs[kRight]);
      const int32_t fsL = beh_add(tm.frontier_l, fs[kLeft]);
      const int32_t fsB = beh_add(tm.frontier_b, fs[kBack]);
      int32_t fdir = kRight;
      if (fsL > fsR) fdir = kLeft;
      if (fsB > max(fsR, fsL)) fdir = kBack;
      // open_side_dir fallback (uav_local_nav.c:1700-1713)
      float ob = -1.0f;
      int32_t od = kRight;
      const int32_t order[3] = {kRight, kLeft, kBack};
      for (int k = 0; k < 3; ++k) {
        const float v = s.tof_filt[order[k]];
        if (isfinite(v) && v > ob) {
          ob = v;
          od = order[k];
        }
      }
      const bool use_frontier = tm.map_inited && lpos_fresh && tm.have_att;
      const int32_t chosen = use_frontier ? fdir : od;
      s.turn_dir = s.turn_forced ? s.forced_dir : chosen;
      s.turn_forced = false;
      const float delta = s.turn_dir == kRight  ? 90.0f
                          : s.turn_dir == kLeft ? -90.0f
                                                : 180.0f;
      s.turn_target = beh_wrap_deg(__fadd_rn(cur, delta));
      s.turn_start = t;
      s.turn_init = true;
    }
    const float err = beh_wrap_deg(__fsub_rn(s.turn_target, cur));
    const float rate = cf(CF_yaw_rate_dps);
    const float yr =
        beh_clamp(__fmul_rn(err, cf(CF_turn_gain)), -rate, rate);
    set_cmd(true, kCmdVelBody, 0.0f, 0.0f, 0.0f, yr);
    const bool turn_done = fabsf(err) < cf(CF_turn_exit_err_deg) ||
                           beh_sub(t, s.turn_start) > ci(CI_turn_timeout_ms);
    if (turn_done) {
      s.yaw_tv = true;
      s.yaw_t = s.turn_target;
      s.turn_init = false;
    }
    enter(kExplore, turn_done);
  }

  __device__ void landing() {
    // LANDING (uav_local_nav.c:2298-2317)
    const bool first_land = !s.land_sent;
    emit_mode(kModeLand, first_land);
    if (first_land) {
      s.land_sent = true;
      s.land_sent_ms = t;
    }
    const bool re_land = !first_land && beh_sub(t, s.land_sent_ms) > 2000;
    emit_mode(kModeLand, re_land);
    if (re_land) s.land_sent_ms = t;
    set_cmd(true, kCmdVelNed, 0.0f, 0.0f, cf(CF_landing_descent_mps), 0.0f);
    const bool near_gnd =
        isfinite(s.alt_est) && s.alt_est < cf(CF_landing_near_ground_m);
    enter(kDisarming,
          near_gnd || (tm.have_ext && tm.landed_state == kLandedOnGround));
  }

  __device__ void run() {
    // ---- pure telemetry predicates ----
    sys_fresh = tm.have_sys && beh_sub(t, tm.sys_last_ms) < 1000;
    const bool hard_nogo = sys_fresh && (!bit_ok(kGyro) || !bit_ok(kMotors));
    z_ok = bit_ok(kZAlt);
    xy_ok = bit_ok(kXyPos);
    of_fresh = tm.have_of && beh_sub(t, tm.of_last_ms) < 400;
    lpos_fresh = tm.have_lpos && beh_sub(t, tm.lpos_last_ms) < 400;
    rf_fresh = tm.have_rf && beh_sub(t, tm.rf_last_ms) < 400;
    batt_fresh = tm.batt_last_ms != 0 && beh_sub(t, tm.batt_last_ms) < 2000 &&
                 isfinite(tm.batt_vpc) && tm.batt_cells > 0;
    servo_fresh_250 = tm.have_servo && beh_sub(t, tm.servo_last_ms) < 250;
    servo_fresh_200 = tm.have_servo && beh_sub(t, tm.servo_last_ms) < 200;

    // ---- tick body (golden.step order) ----
    if (beh_sub(t, s.hb_last) >= 1000) s.hb_last = t;

    // update_alt_estimate (uav_local_nav.c:1440-1470)
    const bool near_ground =
        tm.have_ext && tm.landed_state == kLandedOnGround;
    const bool rf_usable = rf_fresh && isfinite(tm.rf_m);
    float alt = s.alt_est;
    int32_t src = kAltNone;
    if (near_ground) {
      alt = 0.0f;
      src = kAltGnd;
    }
    if (lpos_fresh) {
      alt = beh_clamp(tm.lpos_alt_filt, 0.0f, 10.0f);
      src = kAltLpos;
    }
    if (rf_usable) {
      alt = beh_clamp(tm.rf_m, 0.0f, 10.0f);
      src = kAltRf;
    }
    s.alt_est = alt;
    s.alt_src = src;
    if (isfinite(alt) && alt >= cf(CF_ceil_m)) s.ceiling = true;
    if (isfinite(alt) && alt <= cf(CF_ceil_release_m)) s.ceiling = false;

    // tof EMA filter (uav_local_nav.c:1430-1438)
    for (int d = 0; d < 4; ++d) {
      const float f = s.tof_filt[d], m = tm.tof_min[d];
      const float blended = __fadd_rn(__fmul_rn(cf(CF_filt_keep), f),
                                      __fmul_rn(cf(CF_filt_alpha), m));
      const float upd = isnan(f) ? m : blended;
      s.tof_filt[d] = isnan(m) ? f : upd;
    }

    // battery_failsafe_tick (uav_local_nav.c:1797-1837)
    const int32_t low_hold = ci(CI_low_hold_ms);
    const bool land_actions = ci(CI_land_actions_enabled) != 0;
    const bool on_gnd = batt_fresh && !tm.fc_armed;
    if (on_gnd && tm.want_arm && tm.batt_vpc < cf(CF_arm_min_vpc) &&
        beh_sub(t, s.b_warn) > low_hold)
      s.b_warn = t;
    if (on_gnd) {
      s.b_low = 0;
      s.b_emerg = 0;
    }
    const bool in_air_b = batt_fresh && tm.fc_armed;
    const bool emergv = in_air_b && tm.batt_vpc < cf(CF_emerg_vpc);
    if (emergv && s.b_emerg == 0) s.b_emerg = t;
    const bool emerg_trip =
        emergv && s.b_emerg != 0 && beh_sub(t, s.b_emerg) > low_hold;
    if (emerg_trip) s.kf |= kKfBattEmerg;
    if (land_actions)
      enter(kLanding,
            emerg_trip && s.st != kLanding && s.st != kDisarming);
    if (in_air_b && !emergv) s.b_emerg = 0;
    const bool lowv = in_air_b && tm.batt_vpc < cf(CF_land_vpc);
    if (lowv && s.b_low == 0) s.b_low = t;
    const bool low_trip =
        lowv && s.b_low != 0 && beh_sub(t, s.b_low) > low_hold;
    if (low_trip) s.kf |= kKfBattLand;
    if (land_actions)
      enter(kLanding, low_trip && s.st != kLanding && s.st != kDisarming);
    if (in_air_b && !lowv) s.b_low = 0;

    // 2 Hz status print's vel_xy_stable call (uav_local_nav.c:1886-1889)
    const bool print_due = beh_sub(t, s.print_last) >= 500;
    if (print_due) s.print_last = t;
    vel_xy_stable(print_due);

    // ---- guards; `done` short-circuits the rest of the tick ----
    if (!tm.have_fc) {
      enter(kWaitLink, true);
      return;
    }
    if (hard_nogo) {
      enter(kDisarming, tm.fc_armed);
      enter(kIdle, !tm.fc_armed);
      return;
    }
    enter(kIdle, s.armed_prev && !tm.fc_armed && tm.want_arm &&
                     s.st != kLanding && s.st != kDisarming &&
                     s.st != kIdle);
    s.armed_prev = tm.fc_armed;
    enter(kDisarming, !tm.want_arm && tm.fc_armed);
    if (s.ceiling && tm.fc_armed) {
      set_cmd(true, kCmdVelNed, 0.0f, 0.0f, cf(CF_ceiling_descend_mps), 0.0f);
      return;
    }

    // ---- switch on the post-guard state ----
    const bool batt_ok_arm = !batt_fresh || tm.batt_vpc >= cf(CF_arm_min_vpc);
    switch (s.st) {
      case kWaitLink:
        enter(kIdle, true);
        break;
      case kIdle: {
        // IDLE (uav_local_nav.c:2035-2042)
        const bool go = !(tm.want_arm && !batt_ok_arm);
        enter(kArming, go && tm.want_arm && !tm.fc_armed);
        enter(kDisarming, go && !tm.want_arm && tm.fc_armed);
        enter(kTakeoff, go && tm.want_arm && tm.fc_armed);
        break;
      }
      case kArming: {
        // ARMING (uav_local_nav.c:2044-2055)
        enter(kIdle, !batt_ok_arm);
        const bool arming_do = batt_ok_arm && !tm.fc_armed;
        emit_mode(kModeGuided, arming_do);
        emit_arm(arming_do);
        enter(kTakeoff, batt_ok_arm && tm.fc_armed);
        break;
      }
      case kTakeoff:
        takeoff();
        break;
      case kLiftoffAssist:
        liftoff_assist();
        break;
      case kHover:
        hover();
        break;
      case kExplore:
        explore();
        break;
      case kTurning:
        turning();
        break;
      case kLanding:
        landing();
        break;
      case kDisarming:
        // DISARMING (uav_local_nav.c:2319-2327)
        emit_disarm_force(tm.fc_armed);
        enter(kIdle, !tm.fc_armed);
        break;
      default:
        break;
    }
  }
};

__device__ __forceinline__ BehTelemetry beh_load_telemetry(const BehArgs& a,
                                                           int b) {
  BehTelemetry tm;
  tm.t_ms = beh_ld<int32_t>(a, TM_t_ms, b);
  tm.have_fc = beh_flag(a, TM_have_fc, b);
  tm.fc_armed = beh_flag(a, TM_fc_armed, b);
  tm.hb_custom_mode = beh_ld<int32_t>(a, TM_hb_custom_mode, b);
  tm.have_ext = beh_flag(a, TM_have_ext, b);
  tm.landed_state = beh_ld<int32_t>(a, TM_landed_state, b);
  tm.have_sys = beh_flag(a, TM_have_sys, b);
  tm.sys_last_ms = beh_ld<int32_t>(a, TM_sys_last_ms, b);
  // int32 or int64 (little-endian): the tested bits lie in the low word
  tm.sys_health = beh_ld<int32_t>(a, TM_sys_health, b);
  tm.have_servo = beh_flag(a, TM_have_servo, b);
  tm.servo_last_ms = beh_ld<int32_t>(a, TM_servo_last_ms, b);
  tm.motor_avg = beh_ld<float>(a, TM_motor_avg, b);
  tm.batt_vpc = beh_ld<float>(a, TM_batt_vpc, b);
  tm.batt_cells = beh_ld<int32_t>(a, TM_batt_cells, b);
  tm.batt_last_ms = beh_ld<int32_t>(a, TM_batt_last_ms, b);
  tm.have_lpos = beh_flag(a, TM_have_lpos, b);
  tm.lpos_last_ms = beh_ld<int32_t>(a, TM_lpos_last_ms, b);
  tm.lpos_x = beh_ld<float>(a, TM_lpos_x, b);
  tm.lpos_y = beh_ld<float>(a, TM_lpos_y, b);
  tm.lpos_alt_filt = beh_ld<float>(a, TM_lpos_alt_filt, b);
  tm.have_att = beh_flag(a, TM_have_att, b);
  tm.yaw_deg = beh_ld<float>(a, TM_yaw_deg, b);
  tm.have_of = beh_flag(a, TM_have_of, b);
  tm.of_last_ms = beh_ld<int32_t>(a, TM_of_last_ms, b);
  tm.of_q = beh_ld<int32_t>(a, TM_of_q, b);
  tm.have_rf = beh_flag(a, TM_have_rf, b);
  tm.rf_last_ms = beh_ld<int32_t>(a, TM_rf_last_ms, b);
  tm.rf_m = beh_ld<float>(a, TM_rf_m, b);
  tm.want_arm = beh_flag(a, TM_want_arm, b);
  tm.have_takeoff_ack = beh_flag(a, TM_have_takeoff_ack, b);
  tm.takeoff_ack_res = beh_ld<int32_t>(a, TM_takeoff_ack_res, b);
  tm.takeoff_ack_ms = beh_ld<int32_t>(a, TM_takeoff_ack_ms, b);
  tm.takeoff_accept_ms = beh_ld<int32_t>(a, TM_takeoff_accept_ms, b);
  tm.map_inited = beh_flag(a, TM_map_inited, b);
  tm.frontier_f = beh_ld<int32_t>(a, TM_frontier_f, b);
  tm.frontier_r = beh_ld<int32_t>(a, TM_frontier_r, b);
  tm.frontier_l = beh_ld<int32_t>(a, TM_frontier_l, b);
  tm.frontier_b = beh_ld<int32_t>(a, TM_frontier_b, b);
  const int col = a.stride[kBehTm + kBehSt];
  for (int d = 0; d < 4; ++d)
    tm.tof_min[d] = beh_ld<float>(a, TM_tof_min, b, d * col);
  return tm;
}

__device__ __forceinline__ BehState beh_load_state(const BehArgs& a, int b) {
  BehState s;
#define BEH_LD(name, T) s.name = beh_ld<T>(a, kBehTm + BS_##name, b)
#define BEH_LDB(name) s.name = beh_flag(a, kBehTm + BS_##name, b)
  BEH_LD(st, int32_t);
  BEH_LDB(yaw_tv);
  BEH_LD(yaw_t, float);
  BEH_LDB(hover_valid);
  BEH_LD(hover_x, float);
  BEH_LD(hover_y, float);
  BEH_LD(hover_z, float);
  BEH_LD(hover_yaw, float);
  BEH_LD(hover_enter, int32_t);
  BEH_LDB(turn_init);
  BEH_LD(turn_dir, int32_t);
  BEH_LD(turn_target, float);
  BEH_LD(turn_start, int32_t);
  BEH_LDB(turn_forced);
  BEH_LD(forced_dir, int32_t);
  BEH_LDB(ceiling);
  BEH_LD(alt_est, float);
  BEH_LD(alt_src, int32_t);
  BEH_LDB(to_sent);
  BEH_LD(to_sent_ms, int32_t);
  BEH_LD(to_no_vel_until, int32_t);
  BEH_LDB(to_started);
  BEH_LD(to_started_ms, int32_t);
  BEH_LDB(to_nsp);
  BEH_LDB(ramp_active);
  BEH_LD(ramp_start, int32_t);
  BEH_LD(ramp_last, int32_t);
  BEH_LD(as_start, int32_t);
  BEH_LD(as_last, int32_t);
  BEH_LDB(as_base);
  BEH_LD(as_mot0, float);
  BEH_LDB(as_warned);
  BEH_LDB(land_sent);
  BEH_LD(land_sent_ms, int32_t);
  BEH_LD(b_low, int32_t);
  BEH_LD(b_emerg, int32_t);
  BEH_LD(b_warn, int32_t);
  BEH_LD(xy_since, int32_t);
  BEH_LD(lim_arm, int32_t);
  BEH_LD(lim_mode, int32_t);
  BEH_LD(lim_disarm, int32_t);
  BEH_LD(fr_eval, int32_t);
  BEH_LD(ex_pause, int32_t);
  BEH_LDB(armed_prev);
  BEH_LD(kf, int32_t);
  BEH_LD(hb_last, int32_t);
  BEH_LD(print_last, int32_t);
#undef BEH_LD
#undef BEH_LDB
  const int col = a.stride[kBehTm + kBehSt + 1];
  for (int d = 0; d < 4; ++d)
    s.tof_filt[d] = beh_ld<float>(a, kBehTm + BS_tof_filt, b, d * col);
  return s;
}

__device__ __forceinline__ void beh_store(const BehArgs& a, int b,
                                          const BehState& s,
                                          const BehOutputs& o) {
#define BEH_W(row, v) static_cast<int32_t*>(a.out[WR_##row])[b] = (v)
#define BEH_F(row, v) static_cast<float*>(a.out[WR_##row])[b] = (v)
#define BEH_G(row, v) static_cast<bool*>(a.out[kBehWordRows + FR_##row])[b] = (v)
  BEH_W(st, s.st);
  BEH_W(hover_enter, s.hover_enter);
  BEH_W(turn_dir, s.turn_dir);
  BEH_W(turn_start, s.turn_start);
  BEH_W(forced_dir, s.forced_dir);
  BEH_W(alt_src, s.alt_src);
  BEH_W(to_sent_ms, s.to_sent_ms);
  BEH_W(to_no_vel_until, s.to_no_vel_until);
  BEH_W(to_started_ms, s.to_started_ms);
  BEH_W(ramp_start, s.ramp_start);
  BEH_W(ramp_last, s.ramp_last);
  BEH_W(as_start, s.as_start);
  BEH_W(as_last, s.as_last);
  BEH_W(land_sent_ms, s.land_sent_ms);
  BEH_W(b_low, s.b_low);
  BEH_W(b_emerg, s.b_emerg);
  BEH_W(b_warn, s.b_warn);
  BEH_W(xy_since, s.xy_since);
  BEH_W(lim_arm, s.lim_arm);
  BEH_W(lim_mode, s.lim_mode);
  BEH_W(lim_disarm, s.lim_disarm);
  BEH_W(fr_eval, s.fr_eval);
  BEH_W(ex_pause, s.ex_pause);
  BEH_W(kf, s.kf);
  BEH_W(hb_last, s.hb_last);
  BEH_W(print_last, s.print_last);
  BEH_F(yaw_t, s.yaw_t);
  BEH_F(hover_x, s.hover_x);
  BEH_F(hover_y, s.hover_y);
  BEH_F(hover_z, s.hover_z);
  BEH_F(hover_yaw, s.hover_yaw);
  BEH_F(turn_target, s.turn_target);
  BEH_F(alt_est, s.alt_est);
  BEH_F(as_mot0, s.as_mot0);
  BEH_W(cmd_kind, o.cmd_kind);
  BEH_W(req_mode, o.req_mode);
  BEH_W(req_arm, o.req_arm);
  BEH_F(req_takeoff, o.req_takeoff);
  BEH_F(map_origin_x, o.map_origin_x);
  BEH_F(map_origin_y, o.map_origin_y);
  BEH_G(yaw_tv, s.yaw_tv);
  BEH_G(hover_valid, s.hover_valid);
  BEH_G(turn_init, s.turn_init);
  BEH_G(turn_forced, s.turn_forced);
  BEH_G(ceiling, s.ceiling);
  BEH_G(to_sent, s.to_sent);
  BEH_G(to_started, s.to_started);
  BEH_G(to_nsp, s.to_nsp);
  BEH_G(ramp_active, s.ramp_active);
  BEH_G(as_base, s.as_base);
  BEH_G(as_warned, s.as_warned);
  BEH_G(land_sent, s.land_sent);
  BEH_G(armed_prev, s.armed_prev);
  BEH_G(rc_release, o.rc_release);
  BEH_G(clear_takeoff_ack, o.clear_takeoff_ack);
  BEH_G(map_init, o.map_init);
#undef BEH_W
#undef BEH_F
#undef BEH_G
  float* tof = static_cast<float*>(a.out[kBehOutTofFilt]) + 4 * b;
  float* cmd = static_cast<float*>(a.out[kBehOutCmd]) + 4 * b;
  for (int d = 0; d < 4; ++d) {
    tof[d] = s.tof_filt[d];
    cmd[d] = o.cmd[d];
  }
}

__global__ void __launch_bounds__(kBehThreads)
    behavior_step_kernel(const __grid_constant__ BehArgs a, int B) {
  const int b = blockIdx.x * kBehThreads + threadIdx.x;
  if (b >= B) return;
  const BehTelemetry tm = beh_load_telemetry(a, b);
  BehState s = beh_load_state(a, b);
  BehOutputs o;
  o.cmd_kind = 0;
  o.req_mode = -1;
  o.req_arm = -1;
  for (int d = 0; d < 4; ++d) o.cmd[d] = 0.0f;
  o.req_takeoff = beh_nan();
  o.map_origin_x = beh_nan();
  o.map_origin_y = beh_nan();
  o.rc_release = false;
  o.clear_takeoff_ack = false;
  o.map_init = false;
  BehTick tick{tm, a, s, o, tm.t_ms};
  tick.run();
  beh_store(a, b, s, o);
}

}  // namespace

// One control tick of the UL machine for B quads
// (models/behavior.py::behavior_step_kernel): in[kBehTm + kBehSt] the
// telemetry fields' and the state fields' device pointers, strides their
// byte strides with tof_min's and tof_filt's column strides last,
// out[kBehOuts] the output fields' device pointers (each contiguous),
// fcfg[kBehCfgFloats] and icfg[kBehCfgInts] the configuration.  The host
// arrays are copied into the kernel's parameters.  Launches on `stream`
// and returns cudaGetLastError(); it does not synchronise.
extern "C" int mqs_behavior_step(const void* const* in, const int* strides,
                                 void* const* out, int B, const float* fcfg,
                                 const int* icfg, void* stream) {
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  BehArgs a;
  for (int k = 0; k < kBehTm + kBehSt; ++k) a.in[k] = in[k];
  for (int k = 0; k < kBehTm + kBehSt + 2; ++k) a.stride[k] = strides[k];
  for (int k = 0; k < kBehOuts; ++k) a.out[k] = out[k];
  for (int k = 0; k < kBehCfgFloats; ++k) a.f[k] = fcfg[k];
  for (int k = 0; k < kBehCfgInts; ++k) a.i[k] = icfg[k];
  behavior_step_kernel<<<(B + kBehThreads - 1) / kBehThreads, kBehThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, B);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of behavior_step_kernel that one SM holds at once, from the
// occupancy calculator, into *blocks.  Returns the CUDA error code.
extern "C" int mqs_behavior_step_blocks_per_sm(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, behavior_step_kernel, kBehThreads, 0));
}
