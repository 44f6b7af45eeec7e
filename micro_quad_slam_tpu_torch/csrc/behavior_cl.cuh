// The clean revision's hover machine (clean_uav_fc_tof_nav.c) for a batch
// of quads, one control tick a launch, for NVIDIA Hopper (sm_90a).
// replay_exact.cu includes this header once, beside behavior.cuh, and so
// exports mqs_behavior_step_cl; models/behavior_cl.py::
// behavior_step_cl_kernel calls it, once a tick of the closed-loop
// simulator flying the clean machine (models/simulator.py).
//
// It replaces no Pallas kernel: it is the counterpart of the JAX machine
// micro_quad_slam_tpu/models/behavior_cl.py::behavior_step_cl (jnp.where
// code over the batch) and of its plain torch twin models/behavior_cl.py::
// behavior_step_cl_plain.  Per quad, in behavior_step_cl_plain's order: the
// telemetry predicates with the enabled-bit gates, the heartbeat, the
// defensive altitude estimate (alt_max, the sanity-checked rangefinder)
// and the ceiling latch, the ToF EMA, the battery failsafe (flags only),
// the snapshot timer, the guards with their `done` short-circuit (no link,
// no-go, the unexpected disarm, the user's abort as an immediate forced
// disarm, the ceiling override), the hover stale-sensor hysteresis, and
// the switch on st0 over the 8 states: prearm readiness in IDLE and
// ARMING, the delayed attitude-thrust ramp and the post-ramp inference in
// TAKEOFF, the liftoff assist, the prelock and lock hover (vel_xy_stable
// is not called once locked), LANDING's re-sends and DISARMING.  enter()
// keeps its side effects (the hover targets' reset, clear_takeoff_ack, the
// keyframe bits) and the rate limiters are consumed in the torch order.
//
// Rounding: as behavior.cuh's (the torch path's bits on this card, every
// float operation an _rn intrinsic under -fmad=false, in the torch
// evaluation order; torch.clamp and torch.maximum pass a NaN operand
// through; int32 sums and differences wrap; a NaN written from a Python
// float is 0x7fc00000).  The liftoff assist's torch.sqrt(au), on float32
// in [0, 1], is __fsqrt_rn.
//
// What bounds it on this card: the launch, as for behavior.cuh.  In torch
// the clean tick's machine was ~1,328 launches of [B]-wide elementwise
// ops, each ~1 us of work on the card and ~15 us of the host's time.  So
// one thread per quad loads its state and telemetry once into registers,
// runs the tick as straight-line C, and writes the new state and the
// outputs once, each field through its own pointer and byte stride
// (`want_arm` arrives as a stride-0 broadcast, `lpos_x` and `lpos_y` as
// strided views of the EKF mean): nothing is copied, and the wrapper lays
// the outputs out in blocks by how long they live
// (models/behavior_cl.py::CL_KERNEL).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "behavior.cuh"

namespace {
namespace cl {

constexpr int kBehThreads = 128;   // quads of a block, one thread each

// Telemetry fields, in models/behavior_cl.py::_TM_FIELDS' order; tof_min
// [B, 4] last.  (tests/test_torch_seam.py holds the enumerator names to the
// Python tables.)
enum BehTm {
  TM_t_ms, TM_have_fc, TM_fc_armed, TM_hb_custom_mode, TM_have_ext,
  TM_landed_state, TM_have_sys, TM_sys_last_ms, TM_sys_health,
  TM_sys_enabled, TM_have_servo, TM_servo_last_ms, TM_motor_avg,
  TM_batt_vpc, TM_batt_valid, TM_have_lpos, TM_lpos_last_ms, TM_lpos_x,
  TM_lpos_y, TM_lpos_alt_filt, TM_have_att, TM_yaw_deg, TM_have_of,
  TM_of_last_ms, TM_of_q, TM_have_rf, TM_rf_last_ms, TM_rf_m, TM_want_arm,
  TM_tof_min, kBehTm
};

// The state's fields, in BehaviorClState's order; tof_filt [B, 4] last.
enum BehSt {
  BS_st, BS_yaw_tv, BS_yaw_t, BS_alt_max, BS_alt_est, BS_alt_src,
  BS_ceiling, BS_hv_locked, BS_hv_pre_valid, BS_hv_pre_x, BS_hv_pre_y,
  BS_hv_lock_x, BS_hv_lock_y, BS_prearm_since, BS_to_sent, BS_to_sent_ms,
  BS_to_started, BS_to_started_ms, BS_to_alt0, BS_ramp_active,
  BS_ramp_start, BS_ramp_last, BS_as_start, BS_as_last, BS_as_base,
  BS_as_mot0, BS_as_warned, BS_land_sent, BS_land_sent_ms, BS_b_low,
  BS_b_emerg, BS_b_warn, BS_xy_since, BS_lim_arm, BS_lim_mode,
  BS_lim_disarm, BS_lpos_stale, BS_rf_stale, BS_alt_stale, BS_armed_prev,
  BS_kf, BS_hb_last, BS_snap_last, BS_tof_filt, kBehSt
};

// The 32-bit output fields [B]: the state's int32 fields, then its
// float32 fields, each in BehaviorClState's order, then the outputs.
enum BehWordRow {
  WR_st, WR_alt_src, WR_prearm_since, WR_to_sent_ms, WR_to_started_ms,
  WR_ramp_start, WR_ramp_last, WR_as_start, WR_as_last, WR_land_sent_ms,
  WR_b_low, WR_b_emerg, WR_b_warn, WR_xy_since, WR_lim_arm, WR_lim_mode,
  WR_lim_disarm, WR_lpos_stale, WR_rf_stale, WR_alt_stale, WR_kf,
  WR_hb_last, WR_snap_last, WR_yaw_t, WR_alt_max, WR_alt_est, WR_hv_pre_x,
  WR_hv_pre_y, WR_hv_lock_x, WR_hv_lock_y, WR_to_alt0, WR_as_mot0,
  WR_cmd_kind, WR_req_mode, WR_req_arm, WR_req_takeoff, WR_map_origin_x,
  WR_map_origin_y, kBehWordRows
};

// The bool output fields [B]: the state's bool fields in BehaviorClState's
// order, then the outputs.
enum BehFlagRow {
  FR_yaw_tv, FR_ceiling, FR_hv_locked, FR_hv_pre_valid, FR_to_sent,
  FR_to_started, FR_ramp_active, FR_as_base, FR_as_warned, FR_land_sent,
  FR_armed_prev, FR_rc_release, FR_clear_takeoff_ack, FR_map_init,
  kBehFlagRows
};

// The configuration's floats (each rounded to float32 by the wrapper,
// models/behavior_cl.py::kernel_config_cl) and ints, in its order.
enum BehCfgFloat {
  CF_xy_min_alt_m, CF_ceil_m, CF_ceil_release_m, CF_filt_alpha,
  CF_filt_keep, CF_arm_min_vpc, CF_emerg_vpc, CF_land_vpc, CF_hover_z,
  CF_hover_capture_min_alt_m, CF_takeoff_target_m, CF_takeoff_mot_start_us,
  CF_takeoff_inferred_us, CF_ramp_total_ms, CF_ramp_thr_min,
  CF_ramp_thr_max, CF_thrust_clamp, CF_takeoff_at_alt_m,
  CF_assist_total_ms, CF_assist_thr_us_min, CF_assist_thr_us_max,
  CF_assist_motor_delta_min, CF_landing_descent_mps, kBehCfgFloats
};
enum BehCfgInt {
  CI_of_min_quality, CI_xy_stable_hold_ms, CI_low_hold_ms,
  CI_prearm_stable_ms, CI_stale_fail_ticks, CI_takeoff_no_vel_ms,
  CI_takeoff_stall_ms, CI_assist_send_period_ms,
  CI_assist_override_effect_ms, CI_assist_abort_ms, kBehCfgInts
};

// the clean machine's states and keyframe bits (behavior_cl.py's); the
// sensor bits, altitude sources, command kinds and modes are behavior.cuh's
constexpr int32_t kWaitLink = 0, kIdle = 1, kArming = 2, kTakeoff = 3,
                  kLiftoffAssist = 4, kHover = 5, kLanding = 6,
                  kDisarming = 7;
constexpr int32_t kCmdZYaw = 6;
constexpr int32_t kKfTakeoff = 1, kKfLandStart = 2, kKfLiftoffAst = 4,
                  kKfBattLand = 8, kKfBattEmerg = 16;

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
      sys_enabled, servo_last_ms, lpos_last_ms, of_last_ms, of_q, rf_last_ms;
  bool have_fc, fc_armed, have_ext, have_sys, have_servo, batt_valid,
      have_lpos, have_att, have_of, have_rf, want_arm;
  float motor_avg, batt_vpc, lpos_x, lpos_y, lpos_alt_filt, yaw_deg, rf_m,
      tof_min[4];
};

struct BehState {
  int32_t st, alt_src, prearm_since, to_sent_ms, to_started_ms, ramp_start,
      ramp_last, as_start, as_last, land_sent_ms, b_low, b_emerg, b_warn,
      xy_since, lim_arm, lim_mode, lim_disarm, lpos_stale, rf_stale,
      alt_stale, kf, hb_last, snap_last;
  float yaw_t, alt_max, alt_est, hv_pre_x, hv_pre_y, hv_lock_x, hv_lock_y,
      to_alt0, as_mot0, tof_filt[4];
  bool yaw_tv, ceiling, hv_locked, hv_pre_valid, to_sent, to_started,
      ramp_active, as_base, as_warned, land_sent, armed_prev;
};

struct BehOutputs {
  int32_t cmd_kind, req_mode, req_arm;
  float cmd[4], req_takeoff, map_origin_x, map_origin_y;
  bool rc_release, clear_takeoff_ack, map_init;
};

template <typename T>
__device__ __forceinline__ T ld(const BehArgs& a, int slot, int b,
                                int extra = 0) {
  const char* p = static_cast<const char*>(a.in[slot]) +
                  static_cast<long long>(b) * a.stride[slot] + extra;
  return *reinterpret_cast<const T*>(p);
}

__device__ __forceinline__ bool flag(const BehArgs& a, int slot, int b) {
  return ld<uint8_t>(a, slot, b) != 0;
}

// One tick of one quad: behavior_step_cl_plain's body, lane by lane.
struct BehTick {
  const BehTelemetry& tm;
  const BehArgs& a;
  BehState& s;
  BehOutputs& o;
  int32_t t;
  bool sys_fresh = false, of_fresh = false, lpos_fresh = false,
       rf_fresh = false, servo_fresh_250 = false, servo_fresh_200 = false,
       z_ok = false, xy_ok = false, ready_now = false, off_ground = false;

  __device__ float cf(int k) const { return a.f[k]; }
  __device__ int ci(int k) const { return a.i[k]; }

  __device__ bool bit_ok(int32_t bit) const {
    return !sys_fresh || (tm.sys_health & bit) != 0;
  }
  __device__ bool bit_ok_enabled(int32_t bit) const {
    return !sys_fresh || (tm.sys_enabled & bit) == 0 || bit_ok(bit);
  }

  // enter_state (clean:1957-2031) under a predicate
  __device__ void enter(int32_t ns, bool cond) {
    if (!cond || s.st == ns) return;
    if (s.st == kHover || ns == kHover) {
      s.hv_locked = false;
      s.hv_pre_valid = false;
      s.hv_pre_x = 0.0f;
      s.hv_pre_y = 0.0f;
      s.hv_lock_x = 0.0f;
      s.hv_lock_y = 0.0f;
    }
    if (ns == kTakeoff) {
      s.to_sent = false;
      s.to_sent_ms = 0;
      s.to_started = false;
      s.to_started_ms = 0;
      s.ramp_active = false;
      s.ramp_start = 0;
      o.clear_takeoff_ack = true;
      s.to_alt0 = s.alt_max;
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
    if (ns == kLanding) {
      s.land_sent = false;
      s.land_sent_ms = 0;
      s.kf |= kKfLandStart;
    }
    s.st = ns;
  }

  // set_mode_custom: same-mode suppression before the rate limit
  // (clean:607-608)
  __device__ void emit_mode(int32_t mode, bool cond) {
    if (cond && tm.have_fc && tm.hb_custom_mode != mode &&
        beh_sub(t, s.lim_mode) >= 800) {
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

  __device__ void set_cmd(int32_t kind, float c0, float c1, float c2,
                          float c3) {
    o.cmd_kind = kind;
    o.cmd[0] = c0;
    o.cmd[1] = c1;
    o.cmd[2] = c2;
    o.cmd[3] = c3;
  }

  __device__ void capture_yaw(bool cond) {
    if (cond) {
      s.yaw_tv = true;
      s.yaw_t = tm.yaw_deg;
    }
  }

  // the yaw a command holds: the captured one, else the attitude's, else 0
  __device__ float held_yaw() const {
    return s.yaw_tv ? s.yaw_t : (tm.have_att ? tm.yaw_deg : 0.0f);
  }

  __device__ bool vel_xy_stable() {
    const bool allowed =
        xy_ok && tm.have_att && lpos_fresh &&
        !(of_fresh && tm.of_q < ci(CI_of_min_quality)) &&
        !(isfinite(s.alt_max) && s.alt_max < cf(CF_xy_min_alt_m));
    if (allowed && s.xy_since == 0) s.xy_since = t;
    if (!allowed) s.xy_since = 0;
    return allowed && s.xy_since != 0 &&
           beh_sub(t, s.xy_since) >= ci(CI_xy_stable_hold_ms);
  }

  // hover_ready_stable (clean:999-1036), called where IDLE or ARMING
  // consults the prearm timer
  __device__ bool hover_ready_stable() {
    if (ready_now && s.prearm_since == 0) s.prearm_since = t;
    if (!ready_now) s.prearm_since = 0;
    return ready_now && s.prearm_since != 0 &&
           beh_sub(t, s.prearm_since) >= ci(CI_prearm_stable_ms);
  }

  __device__ void init_hover_targets() {
    s.hv_locked = false;
    s.hv_pre_valid = false;
    s.hv_pre_x = 0.0f;
    s.hv_pre_y = 0.0f;
    s.hv_lock_x = 0.0f;
    s.hv_lock_y = 0.0f;
    capture_yaw(tm.have_att);
  }

  __device__ void prelock_capture() {
    if (!s.hv_pre_valid && lpos_fresh && isfinite(tm.lpos_x) &&
        isfinite(tm.lpos_y) && isfinite(s.alt_max) &&
        s.alt_max > cf(CF_hover_capture_min_alt_m)) {
      s.hv_pre_x = tm.lpos_x;
      s.hv_pre_y = tm.lpos_y;
      s.hv_pre_valid = true;
    }
  }

  // (1 - u) * lo + u * hi, with u = (dt >= total ? 1 : dt / total) clamped
  // from below (the takeoff ramp) or to [0, 1] and square-rooted (the
  // assist)
  __device__ float dt_since(int32_t since) const {
    return __int2float_rn(beh_sub(t, since));
  }
  __device__ static float blend(float u, float lo, float hi) {
    return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), lo), __fmul_rn(u, hi));
  }

  __device__ void idle() {
    // IDLE (clean:2449-2468)
    const bool batt_ok_arm =
        !tm.batt_valid || tm.batt_vpc >= cf(CF_arm_min_vpc);
    if (tm.want_arm && !batt_ok_arm) return;
    if (tm.want_arm && !tm.fc_armed) {
      const bool ready = hover_ready_stable();
      emit_mode(kModeGuided, !ready);
      if (ready) {
        capture_yaw(!s.yaw_tv && tm.have_att);
        init_hover_targets();
        enter(kArming, true);
      }
    }
    enter(kDisarming, !tm.want_arm && tm.fc_armed);
    enter(kTakeoff, tm.want_arm && tm.fc_armed);
  }

  __device__ void arming() {
    // ARMING (clean:2470-2489)
    const bool batt_ok_arm =
        !tm.batt_valid || tm.batt_vpc >= cf(CF_arm_min_vpc);
    enter(kIdle, !batt_ok_arm);
    if (!batt_ok_arm) return;
    const bool ready = hover_ready_stable();
    emit_mode(kModeGuided, !ready);
    if (!ready) return;
    init_hover_targets();
    emit_mode(kModeGuided, !tm.fc_armed);
    emit_arm(!tm.fc_armed);
    enter(kTakeoff, tm.fc_armed);
  }

  __device__ void takeoff() {
    // TAKEOFF (clean:2491-2593)
    emit_mode(kModeGuided, tm.hb_custom_mode != kModeGuided);
    prelock_capture();
    if (!s.to_sent) {
      o.req_takeoff = cf(CF_takeoff_target_m);
      s.to_sent = true;
      s.to_sent_ms = t;
      if (isnan(s.to_alt0))
        s.to_alt0 = isfinite(s.alt_max) ? s.alt_max : s.alt_est;
    }
    const float mot_start = cf(CF_takeoff_mot_start_us);
    const float mot_avg = servo_fresh_250 ? tm.motor_avg : beh_nan();
    const bool mot_started = servo_fresh_250 && mot_avg > mot_start;
    const bool alt_up = isfinite(s.alt_max) && s.alt_max > 0.05f;
    const bool alt_rising = isfinite(s.to_alt0) && isfinite(s.alt_max) &&
                            __fsub_rn(s.alt_max, s.to_alt0) > 0.05f;
    if (!s.to_started && !s.ramp_active && s.to_sent &&
        beh_sub(t, s.to_sent_ms) > 700 && !mot_started && !alt_rising &&
        !off_ground) {
      s.ramp_active = true;
      s.ramp_start = t;
    }

    const float tyaw = held_yaw();
    if (s.to_sent && beh_sub(t, s.to_sent_ms) >= ci(CI_takeoff_no_vel_ms) &&
        !s.ramp_active) {
      if (s.hv_locked)
        set_cmd(kCmdPosYaw, s.hv_lock_x, s.hv_lock_y, cf(CF_hover_z), tyaw);
      else
        set_cmd(kCmdZYaw, cf(CF_hover_z), tyaw, 0.0f, 0.0f);
    }

    // attitude thrust ramp tick (clean:2098-2119)
    if (s.ramp_active) {
      if (s.ramp_start == 0) s.ramp_start = t;
      if (beh_sub(t, s.ramp_last) >= 40) {
        s.ramp_last = t;
        const float rdt = dt_since(s.ramp_start);
        const float total = cf(CF_ramp_total_ms);
        const float u =
            beh_clamp_min(rdt >= total ? 1.0f : __fdiv_rn(rdt, total), 0.0f);
        const float thr = blend(u, cf(CF_ramp_thr_min), cf(CF_ramp_thr_max));
        set_cmd(kCmdAttThrust, beh_clamp(thr, 0.0f, cf(CF_thrust_clamp)),
                tyaw, 0.0f, 0.0f);
      }
      if (off_ground || beh_sub(t, s.ramp_start) > 1400)
        s.ramp_active = false;
    }

    // post-ramp inference (clean:2544-2564)
    if (!s.to_started && !s.ramp_active) {
      const bool inferred_air =
          (tm.have_ext && tm.landed_state != kLandedOnGround) || alt_up ||
          (servo_fresh_250 && mot_avg > cf(CF_takeoff_inferred_us));
      if (!inferred_air) {
        enter(kLiftoffAssist, true);
        return;
      }
      s.to_started = true;
      s.to_started_ms = t;
      capture_yaw(tm.have_att);
    }

    if (!s.to_started && (mot_started || off_ground)) {
      s.to_started = true;
      s.to_started_ms = t;
      capture_yaw(tm.have_att);
    }

    if (!s.to_started &&
        beh_sub(t, s.to_sent_ms) > ci(CI_takeoff_stall_ms)) {
      enter(kLiftoffAssist, true);
      return;
    }

    if (isfinite(s.alt_max) && s.alt_max >= cf(CF_takeoff_at_alt_m)) {
      capture_yaw(!s.yaw_tv && tm.have_att);
      enter(kHover, true);
    }
  }

  __device__ void liftoff_assist() {
    // LIFTOFF_ASSIST (clean:2038-2095)
    emit_mode(kModeGuided, beh_sub(t, s.as_start) < 150);
    if (!s.as_base && servo_fresh_200) {
      s.as_mot0 = tm.motor_avg;
      s.as_base = true;
    }
    if (beh_sub(t, s.as_last) >= ci(CI_assist_send_period_ms)) {
      s.as_last = t;
      const float adt = dt_since(s.as_start);
      const float total = cf(CF_assist_total_ms);
      const float au = beh_clamp(adt >= total ? 1.0f : __fdiv_rn(adt, total),
                                 0.0f, 1.0f);
      const float athr = blend(__fsqrt_rn(au), cf(CF_assist_thr_us_min),
                               cf(CF_assist_thr_us_max));
      const float thr_norm = beh_clamp(
          __fdiv_rn(__fsub_rn(athr, 1000.0f), 1000.0f), 0.0f, 1.0f);
      set_cmd(kCmdAttThrust, beh_clamp_max(thr_norm, cf(CF_thrust_clamp)),
              tm.have_att ? tm.yaw_deg : 0.0f, 0.0f, 0.0f);
    }
    if (!s.as_warned && s.as_base &&
        beh_sub(t, s.as_start) > ci(CI_assist_override_effect_ms) &&
        servo_fresh_200 && isfinite(s.as_mot0) &&
        __fsub_rn(tm.motor_avg, s.as_mot0) < cf(CF_assist_motor_delta_min))
      s.as_warned = true;
    if (off_ground) {
      emit_mode(kModeGuided, true);
      o.req_takeoff = cf(CF_takeoff_target_m);
      enter(kTakeoff, true);
    } else {
      enter(kDisarming, beh_sub(t, s.as_start) > ci(CI_assist_abort_ms));
    }
  }

  __device__ void hover() {
    // HOVER (clean:2599-2607 + hover_hold_tick 1065-1103)
    capture_yaw(!s.yaw_tv && tm.have_att);
    if (!tm.have_att) return;
    prelock_capture();
    // the C short-circuit (clean:1081): once locked, vel_xy_stable is not
    // called again, so its timer freezes through sensor dropouts
    if (!s.hv_locked && vel_xy_stable()) {
      if (s.hv_pre_valid) {
        s.hv_lock_x = s.hv_pre_x;
        s.hv_lock_y = s.hv_pre_y;
      } else if (lpos_fresh && isfinite(tm.lpos_x) && isfinite(tm.lpos_y)) {
        s.hv_lock_x = tm.lpos_x;
        s.hv_lock_y = tm.lpos_y;
      }
      s.hv_locked = true;
    }
    const float hyaw = s.yaw_tv ? s.yaw_t : tm.yaw_deg;
    if (s.hv_locked && lpos_fresh)
      set_cmd(kCmdPosYaw, s.hv_lock_x, s.hv_lock_y, cf(CF_hover_z), hyaw);
    else
      set_cmd(kCmdZYaw, cf(CF_hover_z), hyaw, 0.0f, 0.0f);
  }

  __device__ void landing() {
    // LANDING (clean:2609-2628)
    const bool first_land = !s.land_sent;
    emit_mode(kModeLand, first_land);
    if (first_land) {
      s.land_sent = true;
      s.land_sent_ms = t;
    }
    const bool re_land = !first_land && beh_sub(t, s.land_sent_ms) > 2000;
    emit_mode(kModeLand, re_land);
    if (re_land) s.land_sent_ms = t;
    set_cmd(kCmdVelNed, 0.0f, 0.0f, cf(CF_landing_descent_mps), 0.0f);
    const bool near_gnd = isfinite(s.alt_max) && s.alt_max < 0.10f;
    enter(kDisarming,
          near_gnd || (tm.have_ext && tm.landed_state == kLandedOnGround));
  }

  // The guards end the tick for a quad they take (`done`): such a quad's
  // hover stale counters are zeroed, as the torch path's in_hover gate
  // zeroes them.
  __device__ void done() {
    s.lpos_stale = 0;
    s.alt_stale = 0;
    s.rf_stale = 0;
  }

  __device__ void run() {
    // ---- pure telemetry predicates ----
    sys_fresh = tm.have_sys && beh_sub(t, tm.sys_last_ms) < 1000;
    const bool hard_nogo =
        sys_fresh && (!bit_ok(kGyro) ||
                      ((tm.sys_enabled & kMotors) != 0 && !bit_ok(kMotors)));
    z_ok = bit_ok_enabled(kZAlt);
    xy_ok = bit_ok_enabled(kXyPos);
    of_fresh = tm.have_of && beh_sub(t, tm.of_last_ms) < 400;
    lpos_fresh = tm.have_lpos && beh_sub(t, tm.lpos_last_ms) < 400;
    rf_fresh = tm.have_rf && beh_sub(t, tm.rf_last_ms) < 400;
    servo_fresh_250 = tm.have_servo && beh_sub(t, tm.servo_last_ms) < 250;
    servo_fresh_200 = tm.have_servo && beh_sub(t, tm.servo_last_ms) < 200;

    // ---- tick body (golden CL step order) ----
    if (beh_sub(t, s.hb_last) >= 1000) s.hb_last = t;

    // defensive altitude estimation (clean:1710-1782)
    const bool near_ground =
        tm.have_ext && tm.landed_state == kLandedOnGround;
    const bool lp_ok = lpos_fresh && isfinite(tm.lpos_alt_filt);
    const float a_lp = beh_clamp(tm.lpos_alt_filt, -1.0f, 50.0f);
    const bool rf_ok = rf_fresh && isfinite(tm.rf_m);
    const float a_rf = beh_clamp(tm.rf_m, 0.0f, 10.0f);
    float mx = beh_nan();
    if (lp_ok) mx = a_lp;
    if (rf_ok) mx = isnan(mx) ? a_rf : fmaxf(mx, a_rf);
    if (near_ground) mx = isnan(mx) ? 0.0f : beh_clamp_min(mx, 0.0f);
    s.alt_max = mx;

    const bool airborne_hint =
        (tm.have_ext && tm.landed_state != kLandedOnGround) ||
        (lp_ok && tm.lpos_alt_filt > 0.20f);
    const bool rf_sane =
        rf_ok && !(airborne_hint && a_rf < 0.05f) &&
        !(lp_ok && fabsf(__fsub_rn(a_rf, tm.lpos_alt_filt)) > 0.80f);
    float alt = beh_nan();
    int32_t src = kAltNone;
    if (near_ground) {
      alt = 0.0f;
      src = kAltGnd;
    }
    if (lp_ok) {
      alt = a_lp;
      src = kAltLpos;
    }
    if (rf_sane) {
      alt = a_rf;
      src = kAltRf;
    }
    s.alt_est = alt;
    s.alt_src = src;
    if (isfinite(mx) && mx >= cf(CF_ceil_m)) s.ceiling = true;
    if (isfinite(mx) && mx <= cf(CF_ceil_release_m)) s.ceiling = false;

    // tof EMA filter
    for (int d = 0; d < 4; ++d) {
      const float f = s.tof_filt[d], m = tm.tof_min[d];
      const float blended = __fadd_rn(__fmul_rn(cf(CF_filt_keep), f),
                                      __fmul_rn(cf(CF_filt_alpha), m));
      const float upd = isnan(f) ? m : blended;
      s.tof_filt[d] = isnan(m) ? f : upd;
    }

    // battery failsafe, flags only (clean:2127-2175)
    const int32_t low_hold = ci(CI_low_hold_ms);
    const bool on_gnd = tm.batt_valid && !tm.fc_armed;
    if (on_gnd && tm.want_arm && tm.batt_vpc < cf(CF_arm_min_vpc) &&
        beh_sub(t, s.b_warn) > low_hold)
      s.b_warn = t;
    if (on_gnd) {
      s.b_low = 0;
      s.b_emerg = 0;
    }
    const bool in_air_b = tm.batt_valid && tm.fc_armed;
    const bool emergv = in_air_b && tm.batt_vpc < cf(CF_emerg_vpc);
    if (emergv && s.b_emerg == 0) s.b_emerg = t;
    if (emergv && s.b_emerg != 0 && beh_sub(t, s.b_emerg) > low_hold)
      s.kf |= kKfBattEmerg;
    if (in_air_b && !emergv) s.b_emerg = 0;
    const bool lowv = in_air_b && tm.batt_vpc < cf(CF_land_vpc);
    if (lowv && s.b_low == 0) s.b_low = t;
    if (lowv && s.b_low != 0 && beh_sub(t, s.b_low) > low_hold)
      s.kf |= kKfBattLand;
    if (in_air_b && !lowv) s.b_low = 0;

    // 10 Hz snapshot timer (kept for parity)
    if (beh_sub(t, s.snap_last) >= 100) s.snap_last = t;

    // ---- guards; `done` short-circuits the rest of the tick ----
    if (!tm.have_fc) {
      enter(kWaitLink, true);
      return done();
    }
    if (hard_nogo) {
      enter(kDisarming, tm.fc_armed);
      enter(kIdle, !tm.fc_armed);
      return done();
    }
    enter(kIdle, s.armed_prev && !tm.fc_armed && tm.want_arm &&
                     s.st != kLanding && s.st != kDisarming &&
                     s.st != kIdle);
    s.armed_prev = tm.fc_armed;
    // user abort: force disarm now, past the rate limit, and return
    if (!tm.want_arm && tm.fc_armed) {
      s.lim_disarm = 0;
      emit_disarm_force(true);
      enter(kDisarming, true);
      return done();
    }

    // ceiling override (clean:2403-2419)
    if (s.ceiling && tm.fc_armed) {
      capture_yaw(!s.yaw_tv && tm.have_att);
      const float cyaw = held_yaw();
      if (s.hv_locked && tm.have_att)
        set_cmd(kCmdPosYaw, s.hv_lock_x, s.hv_lock_y, cf(CF_hover_z), cyaw);
      else
        set_cmd(kCmdZYaw, cf(CF_hover_z), cyaw, 0.0f, 0.0f);
      return done();
    }

    // hover stale-sensor hysteresis (clean:2421-2442)
    if (tm.fc_armed && s.st == kHover) {
      s.lpos_stale = lpos_fresh ? 0 : beh_add(s.lpos_stale, 1);
      s.alt_stale = isfinite(s.alt_max) ? 0 : beh_add(s.alt_stale, 1);
      s.rf_stale = rf_ok ? 0 : beh_add(s.rf_stale, 1);
      const int32_t fail = ci(CI_stale_fail_ticks);
      enter(kLanding, s.lpos_stale > fail || s.alt_stale > fail ||
                          s.rf_stale > fail);
    } else {
      done();
    }

    // prearm readiness (clean:999-1036)
    const bool of_ok30 = of_fresh && tm.of_q >= ci(CI_of_min_quality);
    ready_now = tm.have_att && lpos_fresh && xy_ok && z_ok && rf_ok &&
                (of_ok30 || !tm.fc_armed) && isfinite(s.alt_max);
    off_ground = (tm.have_ext && tm.landed_state != kLandedOnGround) ||
                 (rf_ok && tm.rf_m > 0.05f) ||
                 (isfinite(s.alt_max) && s.alt_max > 0.05f);

    // ---- switch on the post-guard state ----
    switch (s.st) {
      case kWaitLink:
        enter(kIdle, true);
        break;
      case kIdle:
        idle();
        break;
      case kArming:
        arming();
        break;
      case kTakeoff:
        takeoff();
        break;
      case kLiftoffAssist:
        liftoff_assist();
        break;
      case kHover:
        hover();
        break;
      case kLanding:
        landing();
        break;
      case kDisarming:
        // DISARMING (clean:2630-2638)
        emit_disarm_force(tm.fc_armed);
        enter(kIdle, !tm.fc_armed);
        break;
      default:
        break;
    }
  }
};

__device__ __forceinline__ BehTelemetry load_telemetry(const BehArgs& a,
                                                       int b) {
  BehTelemetry tm;
  tm.t_ms = ld<int32_t>(a, TM_t_ms, b);
  tm.have_fc = flag(a, TM_have_fc, b);
  tm.fc_armed = flag(a, TM_fc_armed, b);
  tm.hb_custom_mode = ld<int32_t>(a, TM_hb_custom_mode, b);
  tm.have_ext = flag(a, TM_have_ext, b);
  tm.landed_state = ld<int32_t>(a, TM_landed_state, b);
  tm.have_sys = flag(a, TM_have_sys, b);
  tm.sys_last_ms = ld<int32_t>(a, TM_sys_last_ms, b);
  // int32 or int64 (little-endian): the tested bits lie in the low word
  tm.sys_health = ld<int32_t>(a, TM_sys_health, b);
  tm.sys_enabled = ld<int32_t>(a, TM_sys_enabled, b);
  tm.have_servo = flag(a, TM_have_servo, b);
  tm.servo_last_ms = ld<int32_t>(a, TM_servo_last_ms, b);
  tm.motor_avg = ld<float>(a, TM_motor_avg, b);
  tm.batt_vpc = ld<float>(a, TM_batt_vpc, b);
  tm.batt_valid = flag(a, TM_batt_valid, b);
  tm.have_lpos = flag(a, TM_have_lpos, b);
  tm.lpos_last_ms = ld<int32_t>(a, TM_lpos_last_ms, b);
  tm.lpos_x = ld<float>(a, TM_lpos_x, b);
  tm.lpos_y = ld<float>(a, TM_lpos_y, b);
  tm.lpos_alt_filt = ld<float>(a, TM_lpos_alt_filt, b);
  tm.have_att = flag(a, TM_have_att, b);
  tm.yaw_deg = ld<float>(a, TM_yaw_deg, b);
  tm.have_of = flag(a, TM_have_of, b);
  tm.of_last_ms = ld<int32_t>(a, TM_of_last_ms, b);
  tm.of_q = ld<int32_t>(a, TM_of_q, b);
  tm.have_rf = flag(a, TM_have_rf, b);
  tm.rf_last_ms = ld<int32_t>(a, TM_rf_last_ms, b);
  tm.rf_m = ld<float>(a, TM_rf_m, b);
  tm.want_arm = flag(a, TM_want_arm, b);
  const int col = a.stride[kBehTm + kBehSt];
  for (int d = 0; d < 4; ++d)
    tm.tof_min[d] = ld<float>(a, TM_tof_min, b, d * col);
  return tm;
}

__device__ __forceinline__ BehState load_state(const BehArgs& a, int b) {
  BehState s;
#define CL_LD(name, T) s.name = ld<T>(a, kBehTm + BS_##name, b)
#define CL_LDB(name) s.name = flag(a, kBehTm + BS_##name, b)
  CL_LD(st, int32_t);
  CL_LDB(yaw_tv);
  CL_LD(yaw_t, float);
  CL_LD(alt_max, float);
  CL_LD(alt_est, float);
  CL_LD(alt_src, int32_t);
  CL_LDB(ceiling);
  CL_LDB(hv_locked);
  CL_LDB(hv_pre_valid);
  CL_LD(hv_pre_x, float);
  CL_LD(hv_pre_y, float);
  CL_LD(hv_lock_x, float);
  CL_LD(hv_lock_y, float);
  CL_LD(prearm_since, int32_t);
  CL_LDB(to_sent);
  CL_LD(to_sent_ms, int32_t);
  CL_LDB(to_started);
  CL_LD(to_started_ms, int32_t);
  CL_LD(to_alt0, float);
  CL_LDB(ramp_active);
  CL_LD(ramp_start, int32_t);
  CL_LD(ramp_last, int32_t);
  CL_LD(as_start, int32_t);
  CL_LD(as_last, int32_t);
  CL_LDB(as_base);
  CL_LD(as_mot0, float);
  CL_LDB(as_warned);
  CL_LDB(land_sent);
  CL_LD(land_sent_ms, int32_t);
  CL_LD(b_low, int32_t);
  CL_LD(b_emerg, int32_t);
  CL_LD(b_warn, int32_t);
  CL_LD(xy_since, int32_t);
  CL_LD(lim_arm, int32_t);
  CL_LD(lim_mode, int32_t);
  CL_LD(lim_disarm, int32_t);
  CL_LD(lpos_stale, int32_t);
  CL_LD(rf_stale, int32_t);
  CL_LD(alt_stale, int32_t);
  CL_LDB(armed_prev);
  CL_LD(kf, int32_t);
  CL_LD(hb_last, int32_t);
  CL_LD(snap_last, int32_t);
#undef CL_LD
#undef CL_LDB
  const int col = a.stride[kBehTm + kBehSt + 1];
  for (int d = 0; d < 4; ++d)
    s.tof_filt[d] = ld<float>(a, kBehTm + BS_tof_filt, b, d * col);
  return s;
}

__device__ __forceinline__ void store(const BehArgs& a, int b,
                                      const BehState& s,
                                      const BehOutputs& o) {
#define CL_W(row, v) static_cast<int32_t*>(a.out[WR_##row])[b] = (v)
#define CL_F(row, v) static_cast<float*>(a.out[WR_##row])[b] = (v)
#define CL_G(row, v) static_cast<bool*>(a.out[kBehWordRows + FR_##row])[b] = (v)
  CL_W(st, s.st);
  CL_W(alt_src, s.alt_src);
  CL_W(prearm_since, s.prearm_since);
  CL_W(to_sent_ms, s.to_sent_ms);
  CL_W(to_started_ms, s.to_started_ms);
  CL_W(ramp_start, s.ramp_start);
  CL_W(ramp_last, s.ramp_last);
  CL_W(as_start, s.as_start);
  CL_W(as_last, s.as_last);
  CL_W(land_sent_ms, s.land_sent_ms);
  CL_W(b_low, s.b_low);
  CL_W(b_emerg, s.b_emerg);
  CL_W(b_warn, s.b_warn);
  CL_W(xy_since, s.xy_since);
  CL_W(lim_arm, s.lim_arm);
  CL_W(lim_mode, s.lim_mode);
  CL_W(lim_disarm, s.lim_disarm);
  CL_W(lpos_stale, s.lpos_stale);
  CL_W(rf_stale, s.rf_stale);
  CL_W(alt_stale, s.alt_stale);
  CL_W(kf, s.kf);
  CL_W(hb_last, s.hb_last);
  CL_W(snap_last, s.snap_last);
  CL_F(yaw_t, s.yaw_t);
  CL_F(alt_max, s.alt_max);
  CL_F(alt_est, s.alt_est);
  CL_F(hv_pre_x, s.hv_pre_x);
  CL_F(hv_pre_y, s.hv_pre_y);
  CL_F(hv_lock_x, s.hv_lock_x);
  CL_F(hv_lock_y, s.hv_lock_y);
  CL_F(to_alt0, s.to_alt0);
  CL_F(as_mot0, s.as_mot0);
  CL_W(cmd_kind, o.cmd_kind);
  CL_W(req_mode, o.req_mode);
  CL_W(req_arm, o.req_arm);
  CL_F(req_takeoff, o.req_takeoff);
  CL_F(map_origin_x, o.map_origin_x);
  CL_F(map_origin_y, o.map_origin_y);
  CL_G(yaw_tv, s.yaw_tv);
  CL_G(ceiling, s.ceiling);
  CL_G(hv_locked, s.hv_locked);
  CL_G(hv_pre_valid, s.hv_pre_valid);
  CL_G(to_sent, s.to_sent);
  CL_G(to_started, s.to_started);
  CL_G(ramp_active, s.ramp_active);
  CL_G(as_base, s.as_base);
  CL_G(as_warned, s.as_warned);
  CL_G(land_sent, s.land_sent);
  CL_G(armed_prev, s.armed_prev);
  CL_G(rc_release, o.rc_release);
  CL_G(clear_takeoff_ack, o.clear_takeoff_ack);
  CL_G(map_init, o.map_init);
#undef CL_W
#undef CL_F
#undef CL_G
  float* tof = static_cast<float*>(a.out[kBehOutTofFilt]) + 4 * b;
  float* cmd = static_cast<float*>(a.out[kBehOutCmd]) + 4 * b;
  for (int d = 0; d < 4; ++d) {
    tof[d] = s.tof_filt[d];
    cmd[d] = o.cmd[d];
  }
}

__global__ void __launch_bounds__(kBehThreads)
    behavior_step_cl_kernel(const __grid_constant__ BehArgs a, int B) {
  const int b = blockIdx.x * kBehThreads + threadIdx.x;
  if (b >= B) return;
  const BehTelemetry tm = load_telemetry(a, b);
  BehState s = load_state(a, b);
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
  store(a, b, s, o);
}

// mqs_behavior_step_cl's launch, inside the namespace whose names it uses
int launch(const void* const* in, const int* strides, void* const* out,
           int B, const float* fcfg, const int* icfg, void* stream) {
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  BehArgs a;
  for (int k = 0; k < kBehTm + kBehSt; ++k) a.in[k] = in[k];
  for (int k = 0; k < kBehTm + kBehSt + 2; ++k) a.stride[k] = strides[k];
  for (int k = 0; k < kBehOuts; ++k) a.out[k] = out[k];
  for (int k = 0; k < kBehCfgFloats; ++k) a.f[k] = fcfg[k];
  for (int k = 0; k < kBehCfgInts; ++k) a.i[k] = icfg[k];
  behavior_step_cl_kernel<<<(B + kBehThreads - 1) / kBehThreads,
                            kBehThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cl
}  // namespace

// One control tick of the clean machine for B quads
// (models/behavior_cl.py::behavior_step_cl_kernel): in[kBehTm + kBehSt]
// the telemetry fields' and the state fields' device pointers, strides
// their byte strides with tof_min's and tof_filt's column strides last,
// out[kBehOuts] the output fields' device pointers (each contiguous),
// fcfg[kBehCfgFloats] and icfg[kBehCfgInts] the configuration (the cl::
// enums).  The host arrays are copied into the kernel's parameters.
// Launches on `stream` and returns cudaGetLastError(); it does not
// synchronise.
extern "C" int mqs_behavior_step_cl(const void* const* in,
                                    const int* strides, void* const* out,
                                    int B, const float* fcfg,
                                    const int* icfg, void* stream) {
  return cl::launch(in, strides, out, B, fcfg, icfg, stream);
}

// The blocks of behavior_step_cl_kernel that one SM holds at once, from
// the occupancy calculator, into *blocks.  Returns the CUDA error code.
extern "C" int mqs_behavior_step_cl_blocks_per_sm(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, cl::behavior_step_cl_kernel, cl::kBehThreads, 0));
}
