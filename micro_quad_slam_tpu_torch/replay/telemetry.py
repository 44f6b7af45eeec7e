"""Telemetry adapter: raw inbound FC MAVLink stream -> per-tick Telemetry
snapshots (the input pipeline, SURVEY.md §3.5 / §2C C1).

The reference keeps one global per decoded field with a last-update
timestamp; every control tick reads whatever is latched
(uav_local_nav.c:1037-1300).  This adapter replays that exactly: feed it
timestamped MAVLink bytes, then sample Telemetry snapshots at tick times
— so a control-loop replay can run from a captured FC byte stream instead
of a scanlog.  Message-rate semantics (the LOCAL_POSITION_NED altitude
EMA at message rate, ack latching, the OPTICAL_FLOW_RAD rate derivation,
battery cell counting) live HERE, matching the C handlers cited inline.

The port's copy of micro_quad_slam_tpu/replay/telemetry.py.  It keeps its own copy of
the golden model's Telemetry dataclass (micro_quad_slam_tpu/golden/behavior.py),
field for field (tests/test_torch_livestream.py holds the fields and
every snapshot equal to the JAX package's).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from micro_quad_slam_tpu_torch.formats.mavlink import decode_mavlink_stream

F32 = np.float32
ORIENT_DOWNWARD = 25  # (uav_local_nav.c:64)


@dataclass
class Telemetry:
    """Per-tick snapshot of the C globals a control_tick observes."""

    t_ms: int = 0
    have_fc: bool = False
    fc_armed: bool = False
    hb_custom_mode: int = 0
    have_ext: bool = False
    landed_state: int = 0  # MAV_LANDED_STATE_UNDEFINED
    have_sys: bool = False
    sys_last_ms: int = 0
    sys_health: int = 0
    sys_enabled: int = 0xFFFFFFFF  # CL gates are enabled-bit aware (clean:906-933)
    have_servo: bool = False
    servo_last_ms: int = 0
    motor_avg: float = 0.0
    batt_vpc: float = float("nan")
    batt_cells: int = 0
    batt_last_ms: int = 0
    # clean-only: the intake validity LATCH (clean:158,1291-1294) — the
    # CL battery tick gates on this flag, not on a per-tick freshness
    # re-check; maintained by the telemetry adapter / mock
    batt_valid: bool = False
    have_lpos: bool = False
    lpos_last_ms: int = 0
    lpos_x: float = float("nan")
    lpos_y: float = float("nan")
    lpos_alt_filt: float = float("nan")   # EMA'd at message rate by the adapter
    have_att: bool = False
    yaw_deg: float = float("nan")         # wrapped heading
    have_of: bool = False
    of_last_ms: int = 0
    of_q: int = 0
    have_rf: bool = False
    rf_last_ms: int = 0
    rf_m: float = float("nan")
    want_arm: bool = False
    have_takeoff_ack: bool = False
    takeoff_ack_res: int = 0
    takeoff_ack_ms: int = 0
    takeoff_accept_ms: int = 0            # set when ack ACCEPTED (handler)
    tof_min: tuple = (float("nan"),) * 4  # per-dir minima from latest scan
    # map queries (computed by the mapping layer from its grid)
    map_inited: bool = False
    frontier_f: int = 0
    frontier_r: int = 0
    frontier_l: int = 0
    frontier_b: int = 0


@dataclass
class TelemetryAdapter:
    """Stateful twin of the reference's decode handlers + globals."""

    clean_battery: bool = False   # clean's cell inference (clean:1247-1301)

    have_fc: bool = False
    fc_sysid: int = 0
    fc_compid: int = 0
    last_hb_ms: int = 0
    hb_custom_mode: int = 0
    fc_armed: bool = False
    have_ext: bool = False
    landed_state: int = 0
    have_sys: bool = False
    sys_present: int = 0
    sys_enabled: int = 0
    sys_health: int = 0
    sys_last_ms: int = 0
    have_servo: bool = False
    servo_raw: tuple = (0,) * 8
    servo_last_ms: int = 0
    batt_v_total: float = float("nan")
    batt_vpc: float = float("nan")
    batt_cells: int = 0
    batt_last_ms: int = 0
    # clean-only battery intake state (clean:154-220): the validity LATCH
    # (not re-derived per tick — an invalid reading leaves it false until
    # the next valid one), the SYS_STATUS voltage sideband, and the
    # 1 Hz battery-log timer the sideband's invalidation is gated on
    batt_valid: bool = False
    batt_v_total_sys: float = float("nan")
    batt_sys_last_ms: int = 0
    last_batt_log_ms: int = 0
    have_lpos: bool = False
    lpos_x: float = float("nan")
    lpos_y: float = float("nan")
    lpos_vx: float = float("nan")
    lpos_vy: float = float("nan")
    lpos_alt: float = float("nan")
    lpos_alt_filt: float = float("nan")
    lpos_last_ms: int = 0
    have_att: bool = False
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    have_of: bool = False
    of_q: int = 0
    of_rate_x: float = float("nan")
    of_rate_y: float = float("nan")
    of_ground: float = float("nan")
    of_last_ms: int = 0
    have_rf: bool = False
    rf_m: float = float("nan")
    rf_last_ms: int = 0
    have_ack: bool = False
    last_ack_cmd: int = 0
    last_ack_res: int = 0
    have_takeoff_ack: bool = False
    takeoff_ack_res: int = 0
    takeoff_ack_ms: int = 0
    takeoff_accept_ms: int = 0
    last_statustext: str = ""
    last_statustext_sev: int = 0
    last_statustext_ms: int = 0
    rcmap: dict = field(default_factory=lambda: {
        "RCMAP_ROLL": 1, "RCMAP_PITCH": 2, "RCMAP_THROTTLE": 3,
        "RCMAP_YAW": 4})
    rcin: tuple = (0,) * 18
    rcin_rssi: int = 0
    rcin_last_ms: int = 0
    vibration: tuple = (0.0, 0.0, 0.0)
    clipping: tuple = (0, 0, 0)
    esc_rpm: tuple = (0, 0, 0, 0)

    def feed(self, data: bytes, t_ms: int) -> int:
        """Parse a chunk received at host time t_ms.  Returns the number
        of messages handled."""
        n = 0
        for name, f in decode_mavlink_stream(data):
            self._handle(name, f, t_ms)
            n += 1
        return n

    def _handle(self, name: str, f: dict, t: int) -> None:
        if name == "HEARTBEAT":
            if not self.have_fc:
                self.have_fc = True
                self.fc_sysid = f["_sysid"]
                self.fc_compid = f["_compid"]
            self.last_hb_ms = t
            self.hb_custom_mode = f["custom_mode"]
            self.fc_armed = bool(f["base_mode"] & 0x80)  # SAFETY_ARMED
        elif name == "COMMAND_ACK":
            self.have_ack = True
            self.last_ack_cmd = f["command"]
            self.last_ack_res = f["result"]
            if f["command"] == 22:  # NAV_TAKEOFF (uav_local_nav.c:1053)
                self.have_takeoff_ack = True
                self.takeoff_ack_res = f["result"]
                self.takeoff_ack_ms = t
                if f["result"] == 0:  # ACCEPTED
                    self.takeoff_accept_ms = t
        elif name == "EXTENDED_SYS_STATE":
            self.landed_state = f["landed_state"]
            self.have_ext = True
        elif name == "SYS_STATUS":
            self.sys_present = f["onboard_control_sensors_present"]
            self.sys_enabled = f["onboard_control_sensors_enabled"]
            self.sys_health = f["onboard_control_sensors_health"]
            self.sys_last_ms = t
            # clean battery sideband (clean:1177-1203): capture the pack
            # voltage, and — only on the shared 1 Hz battery-log cadence,
            # with BATTERY_STATUS stale >2 s — an insane sys voltage
            # invalidates the battery latch.  The log-cadence coupling is
            # reproduced because it gates a semantic write (compiled-C
            # fuzz-diffed in tests/test_golden_vs_c_cl.py).
            if self.clean_battery:
                do_log = (t - self.last_batt_log_ms) > 1000
                if do_log:
                    self.last_batt_log_ms = t
                vb = f["voltage_battery"]
                if 0 < vb < 60000:
                    self.batt_v_total_sys = float(
                        F32(vb) * F32(0.001))
                    self.batt_sys_last_ms = t
                    if do_log and (t - self.batt_last_ms) > 2000:
                        if (F32(self.batt_v_total_sys) < F32(3.0)
                                or F32(self.batt_v_total_sys) > F32(30.0)):
                            self.batt_valid = False
            self.have_sys = True
        elif name == "SERVO_OUTPUT_RAW":
            self.servo_raw = tuple(f[f"servo{i}_raw"] for i in range(1, 9))
            self.servo_last_ms = t
            self.have_servo = True
        elif name == "BATTERY_STATUS":
            # per-cell f32 sum (uav_local_nav.c:1100-1113); clean adds
            # lrintf(pack/4) cell inference clamped to [2, 6] when a
            # single reading > 6 V, plus the three-gate validity latch
            # (clean:1265-1299) — fuzz-diffed against the compiled C in
            # tests/test_golden_vs_c_cl.py
            if self.clean_battery:
                # the 1 Hz battery-log timer advances at handler ENTRY
                # (clean:1256-1258), before the voltage filter — even a
                # zero-valid-cell frame consumes the log slot, which the
                # SYS_STATUS sideband's invalidation is gated on
                if (t - self.last_batt_log_ms) > 1000:
                    self.last_batt_log_ms = t
            sum_v = F32(0.0)
            n = 0
            for i in range(10):
                v = f[f"voltage{i}"]
                if 0 < v < 20000:
                    sum_v = F32(sum_v + F32(v) * F32(0.001))
                    n += 1
            if n and not self.clean_battery:
                self.batt_v_total = float(sum_v)
                self.batt_cells = n
                self.batt_vpc = float(F32(sum_v / F32(n)))
                self.batt_last_ms = t
            elif n:
                cells_used = n
                if n == 1 and sum_v > F32(6.0):
                    inferred = int(np.rint(sum_v / F32(4.0)))  # lrintf
                    cells_used = min(max(inferred, 2), 6)
                new_vpc = F32(sum_v / F32(cells_used))
                v_ok = F32(3.0) <= sum_v <= F32(30.0)
                c_ok = 0 < cells_used <= 8
                vpc_ok = F32(2.5) <= new_vpc <= F32(4.8)
                if v_ok and c_ok and vpc_ok:
                    self.batt_v_total = float(sum_v)
                    self.batt_cells = cells_used
                    self.batt_vpc = float(new_vpc)
                    self.batt_last_ms = t
                    self.batt_valid = True
                else:
                    self.batt_valid = False
        elif name == "ATTITUDE":
            self.roll = f["roll"]
            self.pitch = f["pitch"]
            self.yaw = f["yaw"]
            self.have_att = True
        elif name == "OPTICAL_FLOW":
            self.have_of = True
            self.of_q = f["quality"]
            self.of_ground = f["ground_distance"]
            self.of_last_ms = t
            # the common dialect's extension flow_rate fields are absent
            # in v1 frames; the reference falls back the same way
        elif name == "OPTICAL_FLOW_RAD":
            self.have_of = True
            self.of_q = f["quality"]
            self.of_last_ms = t
            self.of_ground = (f["distance"] if f["distance"] >= 0.0
                              else float("nan"))
            dt = f["integration_time_us"] * 1e-6
            if dt > 1e-6:  # (uav_local_nav.c:1150-1157)
                self.of_rate_x = f["integrated_x"] / dt
                self.of_rate_y = f["integrated_y"] / dt
            else:
                self.of_rate_x = float("nan")
                self.of_rate_y = float("nan")
        elif name == "LOCAL_POSITION_NED":
            alt = -f["z"]
            if not (-5.0 < alt < 50.0):  # (uav_local_nav.c:1172-1173)
                return
            self.have_lpos = True
            self.lpos_x = f["x"]
            self.lpos_y = f["y"]
            self.lpos_vx = f["vx"]
            self.lpos_vy = f["vy"]
            self.lpos_alt = alt
            if math.isnan(self.lpos_alt_filt):
                self.lpos_alt_filt = alt
            else:
                # EMA at MESSAGE rate, alpha 0.18 (uav_local_nav.c:1192)
                a = F32(0.18)
                self.lpos_alt_filt = float(
                    (F32(1.0) - a) * F32(self.lpos_alt_filt) + a * F32(alt))
            self.lpos_last_ms = t
        elif name == "DISTANCE_SENSOR":
            if (0 < f["current_distance"] < 60000
                    and f["orientation"] == ORIENT_DOWNWARD):
                self.rf_m = f["current_distance"] * 0.01
                self.rf_last_ms = t
                self.have_rf = True
        elif name == "RANGEFINDER":
            d = f["distance"]
            if not math.isnan(d) and 0.0 < d < 60.0:
                self.rf_m = d
                self.rf_last_ms = t
                self.have_rf = True
        elif name == "STATUSTEXT":
            self.last_statustext = f["text"].rstrip(b"\x00").decode(
                errors="replace")
            self.last_statustext_sev = f["severity"]
            self.last_statustext_ms = t
        elif name == "PARAM_VALUE":
            pid = f["param_id"].rstrip(b"\x00").decode(errors="replace")
            if pid in self.rcmap:
                self.rcmap[pid] = int(f["param_value"])
        elif name == "RC_CHANNELS":
            self.rcin = tuple(f[f"chan{i}_raw"] for i in range(1, 19))
            self.rcin_rssi = f["rssi"]
            self.rcin_last_ms = t
        elif name == "VIBRATION":
            self.vibration = (f["vibration_x"], f["vibration_y"],
                              f["vibration_z"])
            self.clipping = (f["clipping_0"], f["clipping_1"],
                             f["clipping_2"])
        elif name == "ESC_STATUS":
            # clean's 18th handler (clean:1238-1245): latch rpm[4] for
            # the flight_data.csv rpm columns (clean:2645-2659)
            self.esc_rpm = tuple(f[f"rpm{i}"] for i in range(4))

    def snapshot(self, t_ms: int, want_arm: bool, tof_min=(float("nan"),) * 4,
                 map_inited: bool = False, frontier=(0, 0, 0, 0)) -> Telemetry:
        """Sample a control-tick Telemetry view of the latched state."""
        yaw_deg = (math.degrees(self.yaw) if self.have_att else float("nan"))
        while yaw_deg >= 180.0:
            yaw_deg -= 360.0
        while yaw_deg < -180.0:
            yaw_deg += 360.0
        return Telemetry(
            t_ms=t_ms, have_fc=self.have_fc, fc_armed=self.fc_armed,
            hb_custom_mode=self.hb_custom_mode, have_ext=self.have_ext,
            landed_state=self.landed_state, have_sys=self.have_sys,
            sys_last_ms=self.sys_last_ms, sys_health=self.sys_health,
            sys_enabled=self.sys_enabled or 0xFFFFFFFF,
            have_servo=self.have_servo, servo_last_ms=self.servo_last_ms,
            motor_avg=sum(self.servo_raw[:4]) * 0.25,
            batt_vpc=self.batt_vpc, batt_cells=self.batt_cells,
            batt_last_ms=self.batt_last_ms, batt_valid=self.batt_valid,
            have_lpos=self.have_lpos,
            lpos_last_ms=self.lpos_last_ms, lpos_x=self.lpos_x,
            lpos_y=self.lpos_y, lpos_alt_filt=self.lpos_alt_filt,
            have_att=self.have_att, yaw_deg=yaw_deg, have_of=self.have_of,
            of_last_ms=self.of_last_ms, of_q=self.of_q, have_rf=self.have_rf,
            rf_last_ms=self.rf_last_ms, rf_m=self.rf_m, want_arm=want_arm,
            have_takeoff_ack=self.have_takeoff_ack,
            takeoff_ack_res=self.takeoff_ack_res,
            takeoff_ack_ms=self.takeoff_ack_ms,
            takeoff_accept_ms=self.takeoff_accept_ms, tof_min=tof_min,
            map_inited=map_inited, frontier_f=frontier[0],
            frontier_r=frontier[1], frontier_l=frontier[2],
            frontier_b=frontier[3],
        )
