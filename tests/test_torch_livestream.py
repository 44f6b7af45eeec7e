"""PyTorch port, replay/telemetry.py and replay/livestream.py: the
telemetry adapter and the live-topology replay against the JAX package's.

The adapter is fed the same seeded MAVLink messages one by one and its
fields and its Telemetry snapshot are compared after every message (NaN
equal to NaN).  wirecap_to_frames is compared array for array, dtypes
included; replay_wirecap's grids (the exact kernel's plain version on the
CPU) bit for bit with the JAX package's replay of the same capture."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from micro_quad_slam_tpu.formats import mavlink as jmav
from micro_quad_slam_tpu.golden import behavior as jgolden
from micro_quad_slam_tpu.replay import livestream as jls
from micro_quad_slam_tpu.replay import telemetry as jtel
from micro_quad_slam_tpu.replay.mapping import scanlog_to_arrays
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch.formats.wirecap import CH_FC, CH_HUB
from micro_quad_slam_tpu_torch.replay import livestream as tls
from micro_quad_slam_tpu_torch.replay import telemetry as ttel

torch.set_num_threads(2)


def _same(a, b) -> bool:
    """Equality with NaN == NaN, through tuples and dicts."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def test_telemetry_dataclass_equals_the_golden_one():
    """The port's copy of golden/behavior.py's Telemetry: the same fields
    in the same order with the same defaults."""
    t = [(f.name, f.default) for f in dataclasses.fields(ttel.Telemetry)]
    j = [(f.name, f.default) for f in dataclasses.fields(jgolden.Telemetry)]
    assert len(t) == len(j)
    assert all(a[0] == b[0] and _same(a[1], b[1]) for a, b in zip(t, j))
    assert _same(dataclasses.astuple(ttel.Telemetry()),
                 dataclasses.astuple(jgolden.Telemetry()))


def _message(rng, enc):
    """One random inbound FC message with values that reach every branch
    of the adapter's handlers."""
    pick = int(rng.integers(0, 17))
    u = lambda lo, hi: float(np.float32(rng.uniform(lo, hi)))   # noqa: E731
    if pick == 0:
        return enc.pack("HEARTBEAT", custom_mode=int(rng.integers(0, 10)),
                        type=2, autopilot=3, system_status=4,
                        base_mode=int(rng.choice([0, 0x80, 0x81])))
    if pick == 1:
        return enc.pack("COMMAND_ACK", command=int(rng.choice([22, 400,
                                                               176])),
                        result=int(rng.integers(0, 3)))
    if pick == 2:
        return enc.pack("EXTENDED_SYS_STATE", vtol_state=0,
                        landed_state=int(rng.integers(0, 5)))
    if pick == 3:
        h = int(rng.integers(0, 2 ** 32))
        return enc.pack("SYS_STATUS", onboard_control_sensors_present=h,
                        onboard_control_sensors_enabled=h,
                        onboard_control_sensors_health=h,
                        voltage_battery=int(rng.choice([0, 2500, 8200,
                                                        40000, 61000])))
    if pick == 4:
        return enc.pack("SERVO_OUTPUT_RAW", time_usec=1, port=0,
                        **{f"servo{i}_raw": int(rng.integers(900, 2100))
                           for i in range(1, 9)})
    if pick == 5:
        n = int(rng.integers(0, 5))
        volts = [int(rng.choice([3700, 4100, 7800, 25000, 0]))
                 for _ in range(n)] + [0] * (10 - n)
        return enc.pack("BATTERY_STATUS", battery_remaining=50,
                        **{f"voltage{i}": v for i, v in enumerate(volts)})
    if pick == 6:
        return enc.pack("ATTITUDE", time_boot_ms=1, roll=u(-0.3, 0.3),
                        pitch=u(-0.3, 0.3), yaw=u(-4, 4))
    if pick == 7:
        return enc.pack("OPTICAL_FLOW", time_usec=1,
                        quality=int(rng.integers(0, 256)),
                        ground_distance=u(0, 2))
    if pick == 8:
        return enc.pack("OPTICAL_FLOW_RAD", time_usec=1,
                        integration_time_us=int(rng.choice([0, 1, 50000])),
                        integrated_x=u(-1, 1), integrated_y=u(-1, 1),
                        distance=u(-1, 3), quality=int(rng.integers(0, 256)))
    if pick == 9:
        return enc.pack("LOCAL_POSITION_NED", time_boot_ms=1, x=u(-5, 5),
                        y=u(-5, 5), z=u(-60, 10), vx=u(-1, 1), vy=u(-1, 1))
    if pick == 10:
        return enc.pack("DISTANCE_SENSOR", time_boot_ms=1,
                        current_distance=int(rng.choice([0, 45, 300,
                                                         60001])),
                        orientation=int(rng.choice([25, 0])))
    if pick == 11:
        return enc.pack("RANGEFINDER", distance=float(rng.choice(
            [float("nan"), 0.0, 0.8, 70.0])), voltage=0.0)
    if pick == 12:
        return enc.pack("STATUSTEXT", severity=int(rng.integers(0, 8)),
                        text=b"PreArm: \xffcheck " + bytes([65 + pick]))
    if pick == 13:
        return enc.pack("PARAM_VALUE", param_value=float(rng.integers(1, 9)),
                        param_count=4, param_index=0, param_type=9,
                        param_id=str(rng.choice(["RCMAP_ROLL", "RCMAP_YAW",
                                                 "OTHER"])))
    if pick == 14:
        return enc.pack("RC_CHANNELS", time_boot_ms=1, chancount=8,
                        rssi=int(rng.integers(0, 256)),
                        **{f"chan{i}_raw": int(rng.integers(900, 2100))
                           for i in range(1, 19)})
    if pick == 15:
        return enc.pack("VIBRATION", time_usec=1, vibration_x=u(0, 2),
                        vibration_y=u(0, 2), vibration_z=u(0, 2),
                        clipping_0=int(rng.integers(0, 5)))
    if enc.version == 1:                       # a v2-only message id
        enc = jmav.MavEncoder(sysid=1, compid=1, version=2)
    return enc.pack("ESC_STATUS", time_usec=1, index=0,
                    **{f"rpm{i}": int(rng.integers(0, 9000))
                       for i in range(4)})


@pytest.mark.parametrize("clean", [False, True])
@pytest.mark.parametrize("version", [1, 2])
def test_adapter_fields_and_snapshot_after_every_message(clean, version):
    rng = np.random.default_rng(10 * version + clean)
    enc = jmav.MavEncoder(sysid=1, compid=1, version=version)
    t, j = ttel.TelemetryAdapter(clean), jtel.TelemetryAdapter(clean)
    now = 0
    for k in range(600):
        now += int(rng.integers(1, 700))
        msg = _message(rng, enc)
        assert t.feed(msg, now) == j.feed(msg, now) == 1
        assert _same(dataclasses.asdict(t), dataclasses.asdict(j)), k
        if k % 7 == 0:
            tof = tuple(float(v) for v in rng.uniform(0, 4, 4))
            a = t.snapshot(now + 5, bool(k % 2), tof, bool(k % 3),
                           (1, 2, 3, 4))
            b = j.snapshot(now + 5, bool(k % 2), tof, bool(k % 3),
                           (1, 2, 3, 4))
            assert _same(dataclasses.astuple(a), dataclasses.astuple(b)), k


def _log(**kw):
    return synth_room_scanlog(**{"n_frames": 24, "seed": 5, "noise_mm": 4.0,
                                 **kw})


@pytest.mark.parametrize("version", [1, 2])
def test_scanlog_to_wirecap_records_equal_jax(version):
    log = _log(yaw_rate_dps=25.0, with_flow=True, n_frames=30)
    log.sys_health[::3] = 0x6001
    log.x_m[4] = np.nan                       # no LOCAL_POSITION_NED
    log.of_rate_x[6] = np.nan                 # no flow
    log.rf_m[7] = np.nan
    log.grid_mm[2, 0, 0, :4] = (0xA6, 0xA600, 0xA6A6, 0x01A6)
    assert tls.scanlog_to_wirecap(log, version) == jls.scanlog_to_wirecap(
        log, version)


def test_wire_mm_is_what_the_jax_capture_carries():
    """wire_mm gives the millimetres that the JAX package's capture of a
    log carries after its parse, 0xA6 bytes and all, and leaves its input
    as it was."""
    log = _log(n_frames=12)
    rng = np.random.default_rng(3)
    log.grid_mm[:] = rng.integers(0, 1 << 16, log.grid_mm.shape,
                                  dtype=np.uint16)
    log.grid_mm[0, 0, 0, :4] = (0xA6, 0xA600, 0xA6A6, 0x01A6)
    before = log.grid_mm.copy()
    got = tls.wire_mm(log.grid_mm)
    np.testing.assert_array_equal(log.grid_mm, before)
    assert (got != before).sum() > 10 and got.dtype == np.uint16
    want = jls.wirecap_to_frames(jls.scanlog_to_wirecap(log))["grid_mm"]
    np.testing.assert_array_equal(got, want)


def _shred(recs, step: int):
    out = []
    for ch, t, payload in recs:
        if ch == CH_HUB:
            out += [(ch, t, payload[i:i + step])
                    for i in range(0, len(payload), step)]
        else:
            out.append((ch, t, payload))
    return out


@pytest.mark.parametrize("case", ["hover_v1", "rotating_flow_v2",
                                  "shredded_hub", "telemetry_gaps"])
def test_wirecap_to_frames_equals_jax_array_for_array(case):
    log = _log(yaw_rate_dps=0.0 if case == "hover_v1" else 25.0,
               with_flow=case != "hover_v1")
    if case == "telemetry_gaps":
        log.x_m[:5] = np.nan                  # x_m, y_m NaN until telemetry
        log.rf_m[:3] = np.nan
        log.state[10:] = 1                    # landed
    recs = jls.scanlog_to_wirecap(log, 2 if case == "rotating_flow_v2" else 1)
    if case == "shredded_hub":
        recs = _shred(recs, 77)
    got, want = tls.wirecap_to_frames(recs), jls.wirecap_to_frames(recs)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["of_q"].dtype == np.int32 and got["scan_ms"].dtype == np.int64
    if case == "telemetry_gaps":
        assert np.isnan(got["x_m"][:5]).all() and np.isnan(got["rf_m"][:3]).all()
    # frames_to_torch carries them unchanged: int32 flow quality, int64
    # scan clock, NaN poses
    t = port.frames_to_torch({k: v[None] for k, v in got.items()}, "cpu")
    assert t["of_q"].dtype == torch.int32 and t["scan_ms"].dtype == torch.int64
    for k, v in got.items():
        np.testing.assert_array_equal(t[k][0].numpy(), v, err_msg=k)
    with pytest.raises(ValueError, match="no valid SCAN"):
        tls.wirecap_to_frames([(CH_FC, 0, b"\xfe")])


@pytest.mark.parametrize("kernel,jkernel", [("residentx", "xla"),
                                            ("hybridx", "hybrid")])
def test_replay_wirecap_equals_jax_and_the_scanlog_replay(kernel, jkernel):
    """A capture of a hovering flight replays to the JAX package's grid,
    and (its telemetry round trip being exact) to the port's scanlog
    replay of the same log; a v2 FC channel replays identically."""
    log = _log(yaw_rate_dps=0.0, with_flow=True)
    cap = tls.scanlog_to_wirecap(log)
    st, outs, n = tls.replay_wirecap(cap, port.UL_PROFILE, kernel=kernel,
                                     device="cpu")
    jst, jouts, jn = jls.replay_wirecap(cap, JAX_UL, kernel=jkernel)
    assert n == jn == 24
    np.testing.assert_array_equal(st.grid.numpy(), np.asarray(jst.grid))
    np.testing.assert_array_equal(outs["used"].numpy(),
                                  np.asarray(jouts["used"]))
    ref, _ = port.replay_mapping_batched(port.frames_to_torch(
        {k: v[None] for k, v in scanlog_to_arrays(log).items()}, "cpu"),
        port.UL_PROFILE, kernel=kernel)
    assert torch.equal(st.grid, ref.grid[0])
    st2, _, _ = tls.replay_wirecap(tls.scanlog_to_wirecap(log, 2),
                                   port.UL_PROFILE, kernel=kernel,
                                   device="cpu")
    assert torch.equal(st2.grid, st.grid)


def test_replay_wirecap_reads_a_file_and_asks_for_cuda(tmp_path):
    from micro_quad_slam_tpu_torch.formats.wirecap import write_wirecap

    p = str(tmp_path / "cap.bin")
    write_wirecap(p, tls.scanlog_to_wirecap(_log(n_frames=6)))
    st, _, n = tls.replay_wirecap(p, device="cpu")
    assert n == 6 and st.grid.dim() == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tls.replay_wirecap(p)


@pytest.mark.parametrize("profile", ["UL_PROFILE", "CL_PROFILE"])
def test_wirecap_flight_data_bytes_equal_jax(tmp_path, profile):
    """flight_data.csv from a capture with ESC_STATUS, VIBRATION and
    SERVO_OUTPUT_RAW injected (tests/test_livestream.py:122's case)."""
    from micro_quad_slam_tpu.utils import config as jconfig
    from micro_quad_slam_tpu_torch.utils import config as tconfig

    recs = jls.scanlog_to_wirecap(_log(n_frames=6))
    enc = jmav.MavEncoder(sysid=1, compid=1, version=2)
    extra = enc.pack("ESC_STATUS", time_usec=1000, index=0, rpm0=8100,
                     rpm1=8200, rpm2=8300, rpm3=8400)
    extra += enc.pack("VIBRATION", time_usec=1000, vibration_x=1.25,
                      vibration_y=0.5, vibration_z=0.75, clipping_0=1)
    extra += enc.pack("SERVO_OUTPUT_RAW", time_usec=1000, port=0,
                      **{f"servo{i}_raw": 1400 + i for i in range(1, 9)})
    idx = [i for i, r in enumerate(recs) if r[0] == CH_HUB][1]
    recs.insert(idx, (CH_FC, recs[idx][1], extra))
    pt, pj = tmp_path / "t.csv", tmp_path / "j.csv"
    assert tls.wirecap_flight_data(recs, str(pt), getattr(
        tconfig, profile)) == jls.wirecap_flight_data(
            recs, str(pj), getattr(jconfig, profile)) == 6
    assert pt.read_bytes() == pj.read_bytes()
