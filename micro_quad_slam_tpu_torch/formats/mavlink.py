"""Minimal MAVLink v1+v2 wire codec for the vehicle-interface layer
(SURVEY.md §2D): the exact message set the reference companion sends to
and negotiates with the flight controller (uav_local_nav.c:647-892,
1016-1034; clean RCMAP discovery clean:544-586).

This is the L1 boundary of the rebuild: the behavior machines emit
abstract commands (models/behavior*.py outputs); `encode_command_stream`
turns one tick's outputs into the same byte stream the reference would
have written to /dev/ttyS2 — HEARTBEAT, SET_MODE + DO_SET_MODE,
COMPONENT_ARM_DISARM (force 21196), NAV_TAKEOFF, velocity / position /
Z-only SET_POSITION_TARGET_LOCAL_NED masks, SET_ATTITUDE_TARGET
quaternion-yaw+thrust, RC_CHANNELS_OVERRIDE (+ UINT16_MAX release), the
SET_MESSAGE_INTERVAL stream negotiation, and PARAM_REQUEST_READ for
RCMAP_*.  A decoder for the same set supports loopback tests and replay
of captured command streams.

Wire formats (the reference's mavlink_parse_char accepts both,
uav_local_nav.c:48, 1263-1297; real ArduPilot FCs emit v2 by default):

  v1: 0xFE len seq sys comp msgid payload crc16(X.25 over len..payload
      + per-message CRC_EXTRA)
  v2: 0xFD len incompat compat seq sys comp msgid[3 LE] payload crc16
      (same CRC recipe over len..payload + CRC_EXTRA); trailing zero
      payload bytes are truncated on the wire and zero-extended on
      decode; a 13-byte signature follows the CRC when incompat bit 0
      is set (accepted and skipped here — signing is not validated).

Payload fields are serialized in type-size-descending order, as
generated MAVLink dialects do.

The port's copy of micro_quad_slam_tpu/formats/mavlink.py (the port imports
nothing of the JAX package); tests/test_torch_mavlink.py
holds what it writes and parses equal to the original's.
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

STX = 0xFE        # MAVLink v1 magic
STX2 = 0xFD       # MAVLink v2 magic
_IFLAG_SIGNED = 0x01
_SIG_LEN = 13

# (msgid, crc_extra, struct format, field names) — fields in wire order
_MSGS = {
    "HEARTBEAT": (0, 50, "<IBBBBB",
                  ("custom_mode", "type", "autopilot", "base_mode",
                   "system_status", "mavlink_version")),
    "SET_MODE": (11, 89, "<IBB",
                 ("custom_mode", "target_system", "base_mode")),
    "PARAM_REQUEST_READ": (20, 214, "<hBB16s",
                           ("param_index", "target_system",
                            "target_component", "param_id")),
    "REQUEST_DATA_STREAM": (66, 148, "<HBBBB",
                            ("req_message_rate", "target_system",
                             "target_component", "req_stream_id",
                             "start_stop")),
    "RC_CHANNELS_OVERRIDE": (70, 124, "<8HBB",
                             ("chan1_raw", "chan2_raw", "chan3_raw",
                              "chan4_raw", "chan5_raw", "chan6_raw",
                              "chan7_raw", "chan8_raw", "target_system",
                              "target_component")),
    "COMMAND_LONG": (76, 152, "<7fHBBB",
                     ("param1", "param2", "param3", "param4", "param5",
                      "param6", "param7", "command", "target_system",
                      "target_component", "confirmation")),
    "SET_ATTITUDE_TARGET": (82, 49, "<I4f4fBBB",
                            ("time_boot_ms", "q0", "q1", "q2", "q3",
                             "body_roll_rate", "body_pitch_rate",
                             "body_yaw_rate", "thrust", "target_system",
                             "target_component", "type_mask")),
    "SET_POSITION_TARGET_LOCAL_NED": (
        84, 143, "<I11fHBBB",
        ("time_boot_ms", "x", "y", "z", "vx", "vy", "vz", "afx", "afy",
         "afz", "yaw", "yaw_rate", "type_mask", "target_system",
         "target_component", "coordinate_frame")),
    # ---- inbound FC telemetry (the 14-18 handlers of SURVEY §2C C1) ----
    "SYS_STATUS": (1, 124, "<IIIHHhHHHHHHb",
                   ("onboard_control_sensors_present",
                    "onboard_control_sensors_enabled",
                    "onboard_control_sensors_health", "load",
                    "voltage_battery", "current_battery",
                    "drop_rate_comm", "errors_comm", "errors_count1",
                    "errors_count2", "errors_count3", "errors_count4",
                    "battery_remaining")),
    "PARAM_VALUE": (22, 220, "<fHH16sB",
                    ("param_value", "param_count", "param_index",
                     "param_id", "param_type")),
    "ATTITUDE": (30, 39, "<I6f",
                 ("time_boot_ms", "roll", "pitch", "yaw", "rollspeed",
                  "pitchspeed", "yawspeed")),
    "LOCAL_POSITION_NED": (32, 185, "<I6f",
                           ("time_boot_ms", "x", "y", "z", "vx", "vy",
                            "vz")),
    "SERVO_OUTPUT_RAW": (36, 222, "<I8HB",
                         ("time_usec", "servo1_raw", "servo2_raw",
                          "servo3_raw", "servo4_raw", "servo5_raw",
                          "servo6_raw", "servo7_raw", "servo8_raw",
                          "port")),
    "RC_CHANNELS": (65, 118, "<I18HBB",
                    ("time_boot_ms",) + tuple(f"chan{i}_raw" for i in
                                              range(1, 19))
                    + ("chancount", "rssi")),
    "COMMAND_ACK": (77, 143, "<HB", ("command", "result")),
    "OPTICAL_FLOW": (100, 175, "<Q3fhhBB",
                     ("time_usec", "flow_comp_m_x", "flow_comp_m_y",
                      "ground_distance", "flow_x", "flow_y", "sensor_id",
                      "quality")),
    "OPTICAL_FLOW_RAD": (106, 138, "<QI5fIfhBB",
                         ("time_usec", "integration_time_us",
                          "integrated_x", "integrated_y",
                          "integrated_xgyro", "integrated_ygyro",
                          "integrated_zgyro", "time_delta_distance_us",
                          "distance", "temperature", "sensor_id",
                          "quality")),
    "DISTANCE_SENSOR": (132, 85, "<IHHHBBBB",
                        ("time_boot_ms", "min_distance", "max_distance",
                         "current_distance", "type", "id", "orientation",
                         "covariance")),
    "BATTERY_STATUS": (147, 154, "<iih10HhBBBb",
                       ("current_consumed", "energy_consumed",
                        "temperature") + tuple(f"voltage{i}" for i in
                                               range(10))
                       + ("current_battery", "id", "battery_function",
                          "type", "battery_remaining")),
    "RANGEFINDER": (173, 83, "<ff", ("distance", "voltage")),
    "VIBRATION": (241, 90, "<Q3f3I",
                  ("time_usec", "vibration_x", "vibration_y",
                   "vibration_z", "clipping_0", "clipping_1",
                   "clipping_2")),
    # clean's 18th handler (clean_uav_fc_tof_nav.c:1525, 1238-1245):
    # esc_rpm[4] feeds the flight_data.csv rpm columns (:2645-2659).
    # CRC_EXTRA 10 recomputed from the dialect recipe and cross-checked
    # against three known messages (tests/test_mavlink.py).
    "ESC_STATUS": (291, 10, "<Q4i4f4fB",
                   ("time_usec",)
                   + tuple(f"rpm{i}" for i in range(4))
                   + tuple(f"voltage{i}" for i in range(4))
                   + tuple(f"current{i}" for i in range(4))
                   + ("index",)),
    "EXTENDED_SYS_STATE": (245, 130, "<BB",
                           ("vtol_state", "landed_state")),
    "STATUSTEXT": (253, 83, "<B50s", ("severity", "text")),
}
_BY_ID = {v[0]: (k, v[1], v[2], v[3]) for k, v in _MSGS.items()}

# MAV_CMD
CMD_COMPONENT_ARM_DISARM = 400
CMD_NAV_TAKEOFF = 22
CMD_DO_SET_MODE = 176
CMD_SET_MESSAGE_INTERVAL = 511

# setpoint type masks (uav_local_nav.c:775-778, 799-802; clean:747-779)
MASK_VELOCITY = (1 << 0) | (1 << 1) | (1 << 2) | (1 << 6) | (1 << 7) | (1 << 8) | (1 << 10)
MASK_POSITION = (1 << 3) | (1 << 4) | (1 << 5) | (1 << 6) | (1 << 7) | (1 << 8) | (1 << 11)
MASK_Z_ONLY = ((1 << 0) | (1 << 1) | (1 << 3) | (1 << 4) | (1 << 5)
               | (1 << 6) | (1 << 7) | (1 << 8) | (1 << 11))

FRAME_LOCAL_NED = 1
FRAME_BODY_NED = 8
FRAME_BODY_OFFSET_NED = 9


def x25_crc(data: bytes, seed: int = 0xFFFF) -> int:
    """MAVLink's CRC accumulate (CRC-16/MCRF4XX: X.25 without the final
    xor/reflection; check value 0x6F91 for '123456789')."""
    crc = seed
    for b in data:
        tmp = (b ^ (crc & 0xFF)) & 0xFF
        tmp = (tmp ^ (tmp << 4)) & 0xFF
        crc = ((crc >> 8) ^ (tmp << 8) ^ (tmp << 3) ^ (tmp >> 4)) & 0xFFFF
    return crc


class MavEncoder:
    """Stateful encoder (per-link sequence counter).  version=1 emits the
    classic 0xFE framing; version=2 emits 0xFD framing with trailing-zero
    payload truncation, like an ArduPilot FC."""

    def __init__(self, sysid: int = 255, compid: int = 191,
                 version: int = 1):
        # MAV_COMP_ID_ONBOARD_COMPUTER = 191 (uav_local_nav.c:393)
        if version not in (1, 2):
            raise ValueError(f"MAVLink version must be 1 or 2: {version}")
        self.sysid = sysid
        self.compid = compid
        self.version = version
        self.seq = 0

    def pack(self, name: str, **fields) -> bytes:
        msgid, crc_extra, fmt, names = _MSGS[name]
        vals = []
        for n in names:
            v = fields.get(n, 0)
            if isinstance(v, str):
                v = v.encode()
            vals.append(v)
        payload = struct.pack(fmt, *vals)
        seq = self.seq & 0xFF
        self.seq = (self.seq + 1) & 0xFF
        if self.version == 2:
            trimmed = payload.rstrip(b"\x00") or b"\x00"
            hdr = bytes([len(trimmed), 0, 0, seq, self.sysid, self.compid,
                         msgid & 0xFF, (msgid >> 8) & 0xFF,
                         (msgid >> 16) & 0xFF])
            crc = x25_crc(hdr + trimmed + bytes([crc_extra]))
            return bytes([STX2]) + hdr + trimmed + struct.pack("<H", crc)
        if msgid > 0xFF:
            raise ValueError(
                f"{name} (msgid {msgid}) needs MAVLink v2 framing; "
                f"construct MavEncoder(version=2)")
        hdr = bytes([len(payload), seq, self.sysid, self.compid, msgid])
        crc = x25_crc(hdr + payload + bytes([crc_extra]))
        return bytes([STX]) + hdr + payload + struct.pack("<H", crc)

    # ---- the reference's senders (uav_local_nav.c:647-892) ----
    def heartbeat(self) -> bytes:
        # MAV_TYPE_ONBOARD_CONTROLLER=18, MAV_AUTOPILOT_INVALID=8,
        # MAV_STATE_ACTIVE=4 (uav_local_nav.c:682-696)
        return self.pack("HEARTBEAT", type=18, autopilot=8, base_mode=0,
                         custom_mode=0, system_status=4, mavlink_version=3)

    def command_long(self, tgt_sys, tgt_comp, command, *params) -> bytes:
        p = list(params) + [0.0] * (7 - len(params))
        return self.pack("COMMAND_LONG", target_system=tgt_sys,
                         target_component=tgt_comp, command=command,
                         confirmation=0,
                         **{f"param{i+1}": float(p[i]) for i in range(7)})

    def set_mode(self, tgt_sys, custom_mode) -> bytes:
        # dual-path SET_MODE + DO_SET_MODE (uav_local_nav.c:699-715)
        return (self.pack("SET_MODE", target_system=tgt_sys, base_mode=1,
                          custom_mode=custom_mode)
                + self.command_long(tgt_sys, 0, CMD_DO_SET_MODE, 1.0,
                                    float(custom_mode)))

    def arm(self, tgt_sys, tgt_comp) -> bytes:
        return self.command_long(tgt_sys, tgt_comp,
                                 CMD_COMPONENT_ARM_DISARM, 1.0)

    def disarm_force(self, tgt_sys, tgt_comp) -> bytes:
        # force magic 21196 (uav_local_nav.c:754-763)
        return self.command_long(tgt_sys, tgt_comp,
                                 CMD_COMPONENT_ARM_DISARM, 0.0, 21196.0)

    def takeoff(self, tgt_sys, tgt_comp, alt_m) -> bytes:
        return self.command_long(tgt_sys, tgt_comp, CMD_NAV_TAKEOFF,
                                 0, 0, 0, 0, 0, 0, float(alt_m))

    def _sp(self, t_ms, tgt_sys, tgt_comp, frame, mask, **kw) -> bytes:
        base = dict(x=0.0, y=0.0, z=0.0, vx=0.0, vy=0.0, vz=0.0,
                    afx=0.0, afy=0.0, afz=0.0, yaw=0.0, yaw_rate=0.0)
        base.update(kw)
        return self.pack("SET_POSITION_TARGET_LOCAL_NED",
                         time_boot_ms=t_ms & 0xFFFFFFFF,
                         target_system=tgt_sys, target_component=tgt_comp,
                         coordinate_frame=frame, type_mask=mask, **base)

    def velocity_setpoint(self, t_ms, tgt_sys, tgt_comp, vx, vy, vz,
                          yaw_rate_rad, frame=FRAME_BODY_OFFSET_NED) -> bytes:
        return self._sp(t_ms, tgt_sys, tgt_comp, frame, MASK_VELOCITY,
                        vx=vx, vy=vy, vz=vz, yaw_rate=yaw_rate_rad)

    def position_setpoint(self, t_ms, tgt_sys, tgt_comp, x, y, z_down,
                          yaw_rad) -> bytes:
        return self._sp(t_ms, tgt_sys, tgt_comp, FRAME_LOCAL_NED,
                        MASK_POSITION, x=x, y=y, z=z_down, yaw=yaw_rad)

    def z_setpoint(self, t_ms, tgt_sys, tgt_comp, z_down, yaw_rad) -> bytes:
        # clean's Z-only mask (clean:747-779)
        return self._sp(t_ms, tgt_sys, tgt_comp, FRAME_LOCAL_NED,
                        MASK_Z_ONLY, z=z_down, yaw=yaw_rad)

    def attitude_thrust(self, t_ms, tgt_sys, tgt_comp, thrust,
                        yaw_rad) -> bytes:
        import math
        # yaw-only quaternion + thrust, ignore body rates
        # (uav_local_nav.c:820-858)
        return self.pack("SET_ATTITUDE_TARGET",
                         time_boot_ms=t_ms & 0xFFFFFFFF,
                         target_system=tgt_sys, target_component=tgt_comp,
                         type_mask=(1 << 0) | (1 << 1) | (1 << 2),
                         q0=math.cos(yaw_rad * 0.5), q1=0.0, q2=0.0,
                         q3=math.sin(yaw_rad * 0.5), body_roll_rate=0.0,
                         body_pitch_rate=0.0, body_yaw_rate=0.0,
                         thrust=float(thrust))

    def rc_override(self, tgt_sys, tgt_comp, ch1, ch2, ch3, ch4) -> bytes:
        # unset channels ride 0xFFFF like the memset in the reference
        # (uav_local_nav.c:871-888)
        return self.pack("RC_CHANNELS_OVERRIDE", target_system=tgt_sys,
                         target_component=tgt_comp, chan1_raw=ch1,
                         chan2_raw=ch2, chan3_raw=ch3, chan4_raw=ch4,
                         chan5_raw=0xFFFF, chan6_raw=0xFFFF,
                         chan7_raw=0xFFFF, chan8_raw=0xFFFF)

    def rc_release(self, tgt_sys, tgt_comp) -> bytes:
        return self.rc_override(tgt_sys, tgt_comp, 0xFFFF, 0xFFFF,
                                0xFFFF, 0xFFFF)

    def stream_negotiation(self, tgt_sys, profile: str = "ul") -> bytes:
        """The reference's first-heartbeat SET_MESSAGE_INTERVAL burst.

        profile "ul": 10 intervals + REQUEST_DATA_STREAM EXTRA3
        (uav_local_nav.c:1016-1034).  profile "cl": clean's 11-interval
        burst — RC_CHANNELS @5 Hz third in the list, and NO
        REQUEST_DATA_STREAM (clean_uav_fc_tof_nav.c:1106-1124)."""
        cl = profile == "cl"
        if profile not in ("ul", "cl"):
            raise ValueError(f"unknown stream profile: {profile!r}")
        intervals = [  # (msgid, interval_us), in the reference's order
            (1, 200000),    # SYS_STATUS
            (36, 50000),    # SERVO_OUTPUT_RAW
            *([(65, 200000)] if cl else []),  # RC_CHANNELS (clean:1113)
            (147, 200000),  # BATTERY_STATUS
            (132, 100000),  # DISTANCE_SENSOR
            (245, 200000),  # EXTENDED_SYS_STATE
            (30, 50000),    # ATTITUDE
            (32, 50000),    # LOCAL_POSITION_NED
            (100, 50000),   # OPTICAL_FLOW
            (106, 50000),   # OPTICAL_FLOW_RAD
            (173, 100000),  # RANGEFINDER
        ]
        out = b"".join(
            self.command_long(tgt_sys, 0, CMD_SET_MESSAGE_INTERVAL,
                              float(mid), float(us))
            for mid, us in intervals)
        if not cl:
            out += self.pack("REQUEST_DATA_STREAM", target_system=tgt_sys,
                             target_component=0, req_stream_id=3,  # EXTRA3
                             req_message_rate=20, start_stop=1)
        return out

    def rcmap_requests(self, tgt_sys, tgt_comp) -> bytes:
        """RCMAP_* discovery (clean:544-586)."""
        return b"".join(
            self.pack("PARAM_REQUEST_READ", target_system=tgt_sys,
                      target_component=tgt_comp, param_index=-1,
                      param_id=name)
            for name in ("RCMAP_ROLL", "RCMAP_PITCH", "RCMAP_THROTTLE",
                         "RCMAP_YAW"))


def decode_mavlink_stream(data: bytes) -> Iterator[Tuple[str, dict]]:
    """Parse a mixed v1/v2 byte stream (the reference's parse loop
    accepts both, uav_local_nav.c:1263-1297); yields (msg_name, fields)
    for known messages; unknown msgids and CRC failures resync
    byte-wise.  v2 truncated payloads are zero-extended; signed v2
    frames are accepted with the signature skipped."""
    i = 0
    n = len(data)
    while i < n:
        magic = data[i]
        if magic == STX:
            if i + 6 > n:
                break
            plen = data[i + 1]
            end = i + 6 + plen + 2
            if end > n:
                break
            msgid = data[i + 5]
            body = data[i + 1:i + 6 + plen]
            sysid, compid, seq = data[i + 3], data[i + 4], data[i + 2]
            sig_len = 0
        elif magic == STX2:
            if i + 10 > n:
                break
            plen = data[i + 1]
            end = i + 10 + plen + 2
            if end > n:
                break
            msgid = (data[i + 7] | (data[i + 8] << 8)
                     | (data[i + 9] << 16))
            body = data[i + 1:i + 10 + plen]
            sysid, compid, seq = data[i + 5], data[i + 6], data[i + 4]
            sig_len = _SIG_LEN if data[i + 2] & _IFLAG_SIGNED else 0
            if end + sig_len > n:
                break
        else:
            i += 1
            continue
        crc_rx = struct.unpack("<H", data[end - 2:end])[0]
        known = _BY_ID.get(msgid)
        if known is None:
            i += 1  # unknown crc_extra: resync byte-wise
            continue
        name, crc_extra, fmt, names = known
        if x25_crc(body + bytes([crc_extra])) != crc_rx:
            i += 1
            continue
        hdr_len = 5 if magic == STX else 9
        payload = bytes(body[hdr_len:])
        full = struct.calcsize(fmt)
        if magic == STX2 and len(payload) < full:
            payload = payload + b"\x00" * (full - len(payload))
        if len(payload) != full:
            i += 1
            continue
        vals = struct.unpack(fmt, payload)
        fields = dict(zip(names, vals))
        fields["_sysid"] = sysid
        fields["_compid"] = compid
        fields["_seq"] = seq
        yield name, fields
        i = end + sig_len


def encode_command_stream(enc: MavEncoder, t_ms: int, out: dict,
                          tgt_sys: int = 1, tgt_comp: int = 1,
                          heartbeat_due: bool = False) -> bytes:
    """One behavior tick's outputs -> the wire bytes the reference would
    send that tick (models/behavior*.py output dict, single-quad values).
    Command kinds: see golden/behavior.py CMD_*."""
    import math

    buf = b""
    if heartbeat_due:
        buf += enc.heartbeat()
    if out.get("req_mode", -1) is not None and int(out.get("req_mode", -1)) >= 0:
        buf += enc.set_mode(tgt_sys, int(out["req_mode"]))
    ra = int(out.get("req_arm", -1))
    if ra == 1:
        buf += enc.arm(tgt_sys, tgt_comp)
    elif ra == 0:
        buf += enc.disarm_force(tgt_sys, tgt_comp)
    rt = out.get("req_takeoff", float("nan"))
    if rt == rt:  # not NaN
        buf += enc.takeoff(tgt_sys, tgt_comp, float(rt))
    kind = int(out.get("cmd_kind", 0))
    cmd = [float(v) for v in out.get("cmd", (0, 0, 0, 0))]
    if kind == 1:    # CMD_VEL_BODY
        buf += enc.velocity_setpoint(t_ms, tgt_sys, tgt_comp, cmd[0],
                                     cmd[1], cmd[2],
                                     math.radians(cmd[3]))
    elif kind == 2:  # CMD_VEL_NED
        buf += enc.velocity_setpoint(t_ms, tgt_sys, tgt_comp, cmd[0],
                                     cmd[1], cmd[2],
                                     math.radians(cmd[3]),
                                     frame=FRAME_LOCAL_NED)
    elif kind == 3:  # CMD_POS_YAW
        buf += enc.position_setpoint(t_ms, tgt_sys, tgt_comp, cmd[0],
                                     cmd[1], cmd[2],
                                     math.radians(cmd[3]))
    elif kind == 4:  # CMD_ATT_THRUST
        buf += enc.attitude_thrust(t_ms, tgt_sys, tgt_comp, cmd[0],
                                   math.radians(cmd[1]))
    elif kind == 5:  # CMD_RC_OVERRIDE
        buf += enc.rc_override(tgt_sys, tgt_comp, int(cmd[0]), int(cmd[1]),
                               int(cmd[2]), int(cmd[3]))
    elif kind == 6:  # CMD_Z_YAW (clean)
        buf += enc.z_setpoint(t_ms, tgt_sys, tgt_comp, cmd[0],
                              math.radians(cmd[1]))
    if out.get("rc_release", False):
        buf += enc.rc_release(tgt_sys, tgt_comp)
    return buf
