"""Live-topology replay: the companion's raw dual-UART inputs -> map.

The reference companion's ONLY inputs are two byte streams polled in one
loop (uav_local_nav.c:2359-2371): hub UART (SCAN 0xA5 / CTRL 0xA6
frames) and FC UART (MAVLink telemetry).  This module replays a
time-multiplexed capture of both (formats/wirecap.py) through the same
stack the reference ran live:

  hub bytes -> formats/scanframe.StreamParser (byte-wise resync,
               0xA6-hijack semantics)
  FC bytes  -> replay/telemetry.TelemetryAdapter (the 14-18 message
               handlers, flow-rate derivation, health bits)
  each completed SCAN frame latches the current telemetry into one
  replay frame, exactly like the reference latches globals at scan
  accept (uav_local_nav.c:1361-1369) and maps on the next tick.

Mapping init needs an "airborne" signal; a live capture has no recorded
behavior-state byte, so landed_state == 2 (IN_AIR, EXTENDED_SYS_STATE —
the same FC signal the reference's own state machine keys off) maps to
the HOVER state byte.  Everything else (pose gates, health bits, flow
quality) flows from the telemetry exactly as in scanlog replay.

The port's copy of micro_quad_slam_tpu/replay/livestream.py: the frames are numpy
arrays equal to the JAX package's, array for array; replay_wirecap puts
them on a torch device (the CUDA device unless told otherwise) and replays
them through the port's replay_mapping_batched, whose `kernel` reaches the
exact and cone Hopper kernels.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from micro_quad_slam_tpu_torch.formats.scanframe import StreamParser
from micro_quad_slam_tpu_torch.formats.wirecap import (CH_FC, CH_HUB,
                                                       read_wirecap)
from micro_quad_slam_tpu_torch.replay.telemetry import TelemetryAdapter
from micro_quad_slam_tpu_torch.utils.config import PipelineConfig, UL_PROFILE

ST_IDLE, ST_HOVER = 1, 5

_F32 = np.float32


def wirecap_to_frames(records: Sequence[Tuple[int, int, bytes]]) -> dict:
    """(channel, t_ms, payload) records -> replay frames dict of [T, ...]
    arrays (scanlog_to_arrays layout), one row per accepted SCAN frame."""
    parser = StreamParser()
    tel = TelemetryAdapter()
    rows: List[dict] = []
    for ch, t_ms, payload in records:
        if ch == CH_FC:
            tel.feed(payload, int(t_ms))
            continue
        if ch != CH_HUB:
            continue
        for kind, f in parser.feed(payload):
            if kind != "scan":
                continue  # CTRL frames steer arming, not mapping
            airborne = tel.landed_state == 2
            rows.append({
                "grid_mm": f["grid_mm"],
                "x_m": _F32(tel.lpos_x if tel.have_lpos else np.nan),
                "y_m": _F32(tel.lpos_y if tel.have_lpos else np.nan),
                "yaw_deg": _F32(np.degrees(tel.yaw) if tel.have_att
                                else np.nan),
                "of_q": np.uint8(tel.of_q),
                "of_rate_x": _F32(tel.of_rate_x),
                "sys_health": np.uint32(tel.sys_health),
                "state": np.uint8(ST_HOVER if airborne else ST_IDLE),
                # fusion/SLAM keys (replay/fusion.fusion_arrays layout)
                "scan_ms": np.int64(f["t_ms"]),
                "of_rate_y": _F32(tel.of_rate_y),
                "rf_m": _F32(tel.rf_m if tel.have_rf else np.nan),
            })
    if not rows:
        raise ValueError("capture contains no valid SCAN frames")
    out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    out["of_q"] = out["of_q"].astype(np.int32)  # fusion expects int32
    return out


def replay_wirecap(path_or_records, cfg: PipelineConfig = UL_PROFILE,
                   kernel: str = "xla", device=None):
    """Replay a wirecap file (or record list) end to end on `device` (the
    CUDA device unless told otherwise); returns (MappingState, outs,
    n_frames) as replay_mapping plus the frame count."""
    from micro_quad_slam_tpu_torch.replay.mapping import (
        frames_to_torch, replay_mapping_batched)

    records = (read_wirecap(path_or_records)
               if isinstance(path_or_records, str) else path_or_records)
    frames = wirecap_to_frames(records)
    batched = frames_to_torch({k: v[None] for k, v in frames.items()},
                              device)
    state, outs = replay_mapping_batched(batched, cfg, kernel=kernel)
    state = type(state)(*(v[0] for v in state))
    outs = {k: v[0] for k, v in outs.items()}
    return state, outs, frames["x_m"].shape[0]


def wirecap_flight_data(path_or_records, out_path: str,
                        cfg: PipelineConfig = UL_PROFILE) -> int:
    """Extract flight_data.csv (E7, clean:2645-2659) from a dual-UART
    capture: one row per accepted SCAN frame (the replay's control-tick
    proxy) with the telemetry latched at that moment — vibration /
    clipping from VIBRATION (clean:1227-1236), motor PWM from
    SERVO_OUTPUT_RAW, ESC rpm from ESC_STATUS (clean:1238-1245).
    Returns the number of rows written."""
    import math

    from micro_quad_slam_tpu_torch.utils.obs import (
        FlightDataWriter, STATE_NAMES_CL, STATE_NAMES_UL)

    names = (STATE_NAMES_UL if cfg.behavior.explore_enabled
             else STATE_NAMES_CL)
    records = (read_wirecap(path_or_records)
               if isinstance(path_or_records, str) else path_or_records)
    parser = StreamParser()
    tel = TelemetryAdapter()
    w = FlightDataWriter(out_path)
    n = 0
    try:
        for ch, t_ms, payload in records:
            if ch == CH_FC:
                tel.feed(payload, int(t_ms))
                continue
            if ch != CH_HUB:
                continue
            for kind, _f in parser.feed(payload):
                if kind != "scan":
                    continue
                airborne = tel.landed_state == 2
                st = ST_HOVER if airborne else ST_IDLE
                alt = tel.lpos_alt_filt
                w.write_row(
                    t_ms, names[st],
                    0.0 if math.isnan(alt) else alt,
                    math.degrees(tel.roll), math.degrees(tel.pitch),
                    math.degrees(tel.yaw), tel.servo_raw[:4],
                    tel.vibration, tel.esc_rpm)
                n += 1
    finally:
        w.close()
    return n


def wire_mm(grid_mm) -> np.ndarray:
    """The ToF millimetres a capture made by scanlog_to_wirecap carries: a
    copy of `grid_mm` (uint16) with the values whose LE bytes contain 0xA6
    nudged.  The reference parser lets the CTRL parser steal that byte
    mid-SCAN-frame (a faithful quirk), so such frames would drop.  The
    low-byte nudge is +1 mm; the high-byte nudge (42496-42751 mm) only
    moves between beyond-max-range values, which the beam extractor treats
    identically.  Real hub hardware has no such luxury and real captures
    do lose those frames."""
    mm = np.array(grid_mm, dtype=np.uint16, copy=True)
    mm[(mm & 0xFF) == 0xA6] += 1
    mm[((mm >> 8) & 0xFF) == 0xA6] += 256
    return mm


def scanlog_to_wirecap(log, mav_version: int = 1) -> List[Tuple[int, int, bytes]]:
    """Render a scanlog as the dual-UART capture that would have
    produced it: per scan, one FC-channel record with the telemetry the
    scanrec latched (HEARTBEAT at ~1 Hz, then ATTITUDE /
    LOCAL_POSITION_NED / SYS_STATUS / EXTENDED_SYS_STATE /
    OPTICAL_FLOW_RAD / RANGEFINDER) followed by the hub-channel SCAN
    frame.  OPTICAL_FLOW_RAD uses a 1 s integration window so the
    rate -> integrated -> rate roundtrip is exact in f32."""
    from micro_quad_slam_tpu_torch.formats.mavlink import MavEncoder
    from micro_quad_slam_tpu_torch.formats.scanframe import encode_scan_frame

    enc = MavEncoder(sysid=1, compid=1, version=mav_version)  # FC's ids
    records: List[Tuple[int, int, bytes]] = []
    last_hb = -10 ** 9
    n = len(log)
    grid_mm = wire_mm(log.grid_mm)
    for i in range(n):
        t = int(log.host_ms[i])
        buf = b""
        if t - last_hb >= 1000:
            buf += enc.pack("HEARTBEAT", type=2, autopilot=3,
                            base_mode=0x80, custom_mode=4,
                            system_status=4)
            last_hb = t
        yaw = float(log.yaw_deg[i])
        buf += enc.pack("ATTITUDE", time_boot_ms=t,
                        roll=float(log.roll_rad[i]),
                        pitch=float(log.pitch_rad[i]),
                        yaw=float(np.radians(np.float32(yaw))))
        if np.isfinite(log.x_m[i]):
            buf += enc.pack("LOCAL_POSITION_NED", time_boot_ms=t,
                            x=float(log.x_m[i]), y=float(log.y_m[i]),
                            z=-float(np.nan_to_num(log.alt_m[i])))
        health = int(log.sys_health[i])
        if health == 0:
            health = 0xFFFFFFFF  # "no SYS_STATUS recorded" => all healthy
        buf += enc.pack("SYS_STATUS",
                        onboard_control_sensors_present=health,
                        onboard_control_sensors_enabled=health,
                        onboard_control_sensors_health=health,
                        voltage_battery=8200)
        airborne = 5 <= int(log.state[i]) <= 8
        buf += enc.pack("EXTENDED_SYS_STATE", vtol_state=0,
                        landed_state=2 if airborne else 1)
        if np.isfinite(log.of_rate_x[i]):
            buf += enc.pack("OPTICAL_FLOW_RAD", time_usec=t * 1000,
                            integration_time_us=1_000_000,
                            integrated_x=float(log.of_rate_x[i]),
                            integrated_y=float(log.of_rate_y[i]),
                            quality=int(log.of_q[i]),
                            distance=float(np.nan_to_num(log.rf_m[i])))
        if np.isfinite(log.rf_m[i]):
            buf += enc.pack("RANGEFINDER", distance=float(log.rf_m[i]),
                            voltage=0.0)
        records.append((CH_FC, t, buf))
        records.append((CH_HUB, t, encode_scan_frame(
            int(log.scan_ms[i]), grid_mm[i])))
    return records
