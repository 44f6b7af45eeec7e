"""Frozen configuration of the port: the JAX package's
micro_quad_slam_tpu/utils/config.py, field for field and default for
default (tests/test_torch_package.py holds the two equal), kept here so
that the port imports nothing of the JAX package.

All defaults reproduce the reference constants.  Two profiles mirror the
two revisions of the reference companion binary:

  * UL_PROFILE — full system (`uav_local_nav.c`): mapping + frontier
    exploration + autonomous turning; UL_RT_PROFILE is its SLAM
    throughput operating point.
  * CL_PROFILE — stability/demo revision (`clean_uav_fc_tof_nav.c`):
    hover-only, extra diagnostics, defensive altitude estimation.

The dataclasses are frozen, so a configuration is hashable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MapConfig:
    """Log-odds occupancy grid parameters (uav_local_nav.c:182-197)."""

    res_m: float = 0.10          # MAP_RES_M (uav_local_nav.c:182)
    size_m: float = 50.0         # MAP_SIZE_M (uav_local_nav.c:183)
    width: int = 500             # MAP_W (uav_local_nav.c:185)
    height: int = 500            # MAP_H (uav_local_nav.c:186)
    lo_free_dec: int = 1         # LO_FREE_DEC (uav_local_nav.c:194)
    lo_occ_inc: int = 6          # LO_OCC_INC (uav_local_nav.c:195)
    lo_min: int = -80            # LO_MIN (uav_local_nav.c:196)
    lo_max: int = 80             # LO_MAX (uav_local_nav.c:197)
    lo_miss_end_dec: int = 0
    recenter_frac: float = 0.60
    recenter_max_shift_frac: float = 0.50
    frontier_range_m: float = 2.5
    frontier_step_cells: float = 2.0       # step = MAP_RES_M * 2
    frontier_ray_offsets_deg: tuple = (0.0, 15.0, -15.0)
    frontier_unknown_band: int = 1         # |v| <= 1 -> unknown
    frontier_occ_thresh: int = 10          # v > 10   -> occupied
    frontier_free_thresh: int = -10        # v < -10  -> free
    frontier_w_unknown: int = 3
    frontier_w_free: int = 1
    frontier_w_occ: int = 4

    @property
    def half_m(self) -> float:
        return self.size_m * 0.5

    @property
    def recenter_thresh_m(self) -> float:
        return self.half_m * self.recenter_frac

    @property
    def recenter_max_shift_cells(self) -> int:
        return int(self.half_m / self.res_m * self.recenter_max_shift_frac)

    @property
    def max_ray_cells(self) -> int:
        return int(round(4.0 / self.res_m))


@dataclass(frozen=True)
class TofConfig:
    """ToF sensor geometry & beam extraction (uav_local_nav.c:104-129,1320-1359)."""

    num_dirs: int = 4
    rows: int = 8
    cols: int = 8
    max_range_m: float = 4.00      # TOF_MAX_RANGE_M (uav_local_nav.c:117)
    fov_deg: float = 63.0          # TOF_FOV_DEG (uav_local_nav.c:118)
    min_valid_m: float = 0.02      # drop returns <= 2 cm (uav_local_nav.c:1329)
    map_skip_below_m: float = 0.05 # mapping skips dist <= 5 cm (uav_local_nav.c:290)
    hit_margin_m: float = 0.05
    filt_alpha: float = 0.20       # EMA on per-dir minima (uav_local_nav.c:1431)
    dir_center_deg: tuple = (0.0, 90.0, 180.0, -90.0)

    @property
    def half_fov_deg(self) -> float:
        return self.fov_deg * 0.5


@dataclass(frozen=True)
class GateConfig:
    """Freshness / health / stability gating (uav_local_nav.c:900-986)."""

    lpos_fresh_ms: int = 400       # (uav_local_nav.c:936,964)
    of_fresh_ms: int = 400         # (uav_local_nav.c:927)
    rf_fresh_ms: int = 400         # (uav_local_nav.c:1443)
    sys_fresh_ms: int = 1000       # (uav_local_nav.c:901)
    of_min_quality: int = 50       # mapping & XY gates (uav_local_nav.c:943,968);
    xy_min_alt_m: float = 0.12     # (uav_local_nav.c:971)
    xy_stable_hold_ms: int = 1000  # XY_STABLE_HOLD_MS (uav_local_nav.c:956)
    lpos_alt_filt_alpha: float = 0.18  # (uav_local_nav.c:1192)
    alt_clamp_lo_m: float = 0.0    # UL clamps alt to [0, 10] (uav_local_nav.c:1451-1458)
    alt_clamp_hi_m: float = 10.0
    ceil_m: float = 0.70           # CEIL_M (uav_local_nav.c:114); clean 0.90 (clean:104)
    ceil_release_margin_m: float = 0.10  # release at CEIL-0.10 (uav_local_nav.c:1469)
    rf_sanity: bool = False        # reject RF<0.05 while airborne-hinted or |RF-LPOS|>0.8
    rf_sanity_min_m: float = 0.05
    rf_sanity_lpos_delta_m: float = 0.80
    rf_airborne_lpos_m: float = 0.20
    use_alt_max_for_ceiling: bool = False  # clean:1779-1781
    lpos_clamp_lo_m: float = 0.0
    lpos_clamp_hi_m: float = 10.0


@dataclass(frozen=True)
class BatteryConfig:
    """2S LiHV battery failsafe (uav_local_nav.c:170-179,1791-1837)."""

    arm_min_vpc: float = 3.70
    land_vpc: float = 3.55
    emerg_vpc: float = 3.35
    low_hold_ms: int = 1200
    fresh_ms: int = 2000
    land_actions_enabled: bool = True


@dataclass(frozen=True)
class BehaviorConfig:
    """Flight state machine / exploration parameters (uav_local_nav.c)."""

    takeoff_target_m: float = 0.50     # (uav_local_nav.c:113); clean 0.35 (clean:103)
    hover_target_m: float = 0.45       # clean-only explicit hover target (clean:102)
    front_stop_m: float = 0.60         # FRONT_STOP_M (uav_local_nav.c:121)
    side_safe_m: float = 0.80          # SIDE_SAFE_M (uav_local_nav.c:122)
    fwd_vel_mps: float = 0.35          # FWD_VEL (uav_local_nav.c:125)
    yaw_rate_dps: float = 20.0         # YAW_RATE_DPS (uav_local_nav.c:129)
    yaw_hold_gain: float = 1.2         # (uav_local_nav.c:864)
    turn_gain: float = 0.8             # (uav_local_nav.c:2283)
    turn_exit_err_deg: float = 6.0     # (uav_local_nav.c:2290)
    turn_timeout_ms: int = 6000        # (uav_local_nav.c:2290)
    frontier_eval_ms: int = 1200       # FRONTIER_EVAL_MS (uav_local_nav.c:232)
    frontier_side_margin: int = 35     # side beats front by >35 (uav_local_nav.c:2239)
    frontier_tof_bias: float = 5.0     # score += dist*5 (uav_local_nav.c:1726-1728)
    post_turn_pause_ms: int = 450      # POST_TURN_PAUSE_MS (uav_local_nav.c:238)
    hover_explore_delay_ms: int = 1200 # (uav_local_nav.c:2199)
    takeoff_no_vel_ms: int = 2000      # (uav_local_nav.c:150); clean 900 (clean:132)
    takeoff_mot_start_us: float = 1150.0
    takeoff_start_check_ms: int = 1500
    takeoff_stall_ms: int = 4500       # (uav_local_nav.c:2156); clean 8000 (clean:135)
    takeoff_retry_ms: int = 3000       # re-issue NAV_TAKEOFF (uav_local_nav.c:2077)
    ramp_send_ms: int = 50             # 20 Hz attitude target (uav_local_nav.c:154)
    ramp_total_ms: int = 1800          # (uav_local_nav.c:155); clean 700
    ramp_abort_ms: int = 2600          # (uav_local_nav.c:156)
    ramp_thr_min: float = 0.15         # (uav_local_nav.c:157); clean 0.50
    ramp_thr_max: float = 0.60         # (uav_local_nav.c:158); clean 0.95
    ramp_exit_m: float = 0.15          # TO_RAMP_EXIT_M (uav_local_nav.c:159)
    assist_thr_us_min: int = 1300      # (uav_local_nav.c:138); clean 1550
    assist_thr_us_max: int = 1600      # (uav_local_nav.c:139); clean 1850
    assist_send_period_ms: int = 50    # (uav_local_nav.c:140); clean 40
    assist_total_ms: int = 1800        # (uav_local_nav.c:141); clean 800
    assist_exit_alt_m: float = 0.28    # (uav_local_nav.c:142)
    assist_abort_ms: int = 2600        # (uav_local_nav.c:143); clean 2000
    assist_override_effect_ms: int = 400
    assist_motor_delta_min: float = 40.0
    landing_descent_mps: float = 0.15  # (uav_local_nav.c:2311)
    landing_near_ground_m: float = 0.10
    ceiling_descend_mps: float = 0.30  # (uav_local_nav.c:2026)
    explore_enabled: bool = True       # clean drops EXPLORE/TURNING
    hover_test_only: bool = False
    takeoff_exit_margin_m: float = 0.05  # hover at target-0.05 (uav_local_nav.c:2164)
    hover_capture_min_alt_m: float = 0.15  # clean prelock gate (clean:106)
    prearm_stable_ms: int = 400        # clean:107
    stale_fail_ticks: int = 40         # clean hover sensor-stale hysteresis (clean:416)
    disarm_force_code: float = 21196.0 # (uav_local_nav.c:762)
    thrust_clamp: float = 0.75         # (uav_local_nav.c:824); clean 0.90
    attitude_ramp_sqrt: bool = False   # clean eases thrust with sqrt(u) (clean:2107)


@dataclass(frozen=True)
class SlamConfig:
    """Scan-match + pose-graph SLAM back-end (new capability; slam/).

    The reference dead-reckons on the FC EKF; these tunables govern the
    rebuild's drift-correction stack."""

    kf_every: int = 10             # keyframe cadence (frames)
    gn_iters: int = 5
    match_n_xy: int = 7
    match_n_yaw: int = 7
    match_xy_step_m: float = 0.05
    match_yaw_step_deg: float = 1.0
    match_min_quality: float = 3.0  # accept gate: peak-minus-mean per hit
    match_chunk_intervals: int = 4
    match_map_kf_only: bool = True
    match_feedback: bool = False
    match_iters: int = 2
    loop_min_gap: int = 3          # candidate must be >= this many kf older
    loop_r_max_m: float = 1.0      # proximity gate on keyframe distance
    loop_n_xy: int = 5
    loop_n_yaw: int = 5
    loop_min_quality: float = 0.5
    loop_edges: int = 2
    loop_cand: int = 3
    loop_huber: float = 1.0
    loop_q_ref: float = 1.5
    loop_q_min: float = 1.0
    loop_q_max: float = 1.0
    loop_refine: int = 3
    loop_refine_early: int = -1
    gn_refine_iters: int = 0
    match_iters_later: int = 0
    slam_outer: int = 3
    odo_scale_min: float = 0.8
    odo_scale_max: float = 1.25
    odo_w: tuple = (100.0, 100.0, 400.0)
    anchor_w: tuple = (10.0, 10.0, 40.0)
    loop_w: tuple = (120.0, 120.0, 480.0)
    recenter: bool = True


@dataclass(frozen=True)
class EkfConfig:
    """Explicit EKF replacing ArduPilot EKF3 (new capability; the reference
    consumed LOCAL_POSITION_NED, uav_local_nav.c:1168-1195)."""

    q_pos: float = 1e-4       # process noise on position (m^2 / step)
    q_vel: float = 0.4        # process noise on velocity
    q_vz: float = 0.4         # process noise on vertical velocity
    q_yaw: float = 1e-4       # process noise on yaw (rad^2 / s)
    q_wz: float = 0.5         # process noise on yaw rate
    r_flow_vel: float = 1e-2  # flow-derived velocity measurement noise
    r_zero_vel: float = 1.0   # weak zero-velocity prior when flow is bad
    r_rf: float = 4e-4        # rangefinder variance (~2 cm sigma)
    r_yaw: float = 3e-4       # attitude-yaw variance (~1 deg sigma)
    min_flow_quality: int = 50
    min_ground_m: float = 0.05


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle (hashable)."""

    map: MapConfig = MapConfig()
    tof: TofConfig = TofConfig()
    gates: GateConfig = GateConfig()
    battery: BatteryConfig = BatteryConfig()
    behavior: BehaviorConfig = BehaviorConfig()
    ekf: EkfConfig = EkfConfig()
    slam: SlamConfig = SlamConfig()
    name: str = "ul"

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


UL_PROFILE = PipelineConfig(name="ul", slam=SlamConfig(
    loop_refine_early=1, gn_refine_iters=2, match_iters_later=1))

UL_RT_PROFILE = UL_PROFILE.replace(
    name="ul-rt", slam=SlamConfig(slam_outer=1, loop_refine=0,
                                  match_iters=1, loop_cand=2))

CL_PROFILE = PipelineConfig(
    name="cl",
    gates=GateConfig(
        of_min_quality=30,            # clean:980,1003
        ceil_m=0.90,                  # clean:104
        rf_sanity=True,               # clean:1743-1755
        use_alt_max_for_ceiling=True, # clean:1779-1781
        lpos_clamp_lo_m=-1.0,         # clean:1723-1725
        lpos_clamp_hi_m=50.0,
    ),
    battery=BatteryConfig(land_actions_enabled=False),  # clean:2127-2175
    behavior=BehaviorConfig(
        takeoff_target_m=0.35,        # clean:103
        takeoff_no_vel_ms=900,        # clean:132
        takeoff_stall_ms=8000,        # clean:135
        ramp_total_ms=700,            # clean:2098-2119
        ramp_thr_min=0.50,
        ramp_thr_max=0.95,
        assist_thr_us_min=1550,       # clean:121
        assist_thr_us_max=1850,
        assist_send_period_ms=40,
        assist_total_ms=800,
        assist_abort_ms=2000,
        assist_override_effect_ms=250,
        assist_motor_delta_min=15.0,
        explore_enabled=False,
        thrust_clamp=0.90,
        attitude_ramp_sqrt=True,
    ),
)
