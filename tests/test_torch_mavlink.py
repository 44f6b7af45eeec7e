"""PyTorch port, formats/mavlink.py and models/simulator.py::
sim_diag_to_mavlink: the port's MAVLink codec against the JAX package's on
seeded random messages (v1 and v2 framing, CRC_EXTRA per message id, v2
truncation and signatures), random byte streams, behaviour-tick command
streams, and one recorded port swarm run rendered by both packages'
sim_diag_to_mavlink from the same numpy diag."""

import math
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from micro_quad_slam_tpu.formats import mavlink as jmav
from micro_quad_slam_tpu.models.simulator import (
    sim_diag_to_mavlink as jax_sim_diag_to_mavlink)
from micro_quad_slam_tpu_torch.formats import mavlink as tmav
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch.models import simulator as tsim

torch.set_num_threads(2)

SETTINGS = settings(max_examples=40, deadline=None, derandomize=True)
NAMES = sorted(jmav._MSGS)


def _random_fields(rng, name: str) -> dict:
    """Random values for every field of message `name`, by its struct
    format (zeros sprinkled in, so that v2 truncates trailing bytes)."""
    _, _, fmt, names = jmav._MSGS[name]
    codes = [c for c in struct.Struct(fmt).format.lstrip("<")]
    out, i = {}, 0
    spec = []
    while i < len(codes):            # expand counts ("11f", "16s")
        n = ""
        while codes[i].isdigit():
            n += codes[i]
            i += 1
        c = codes[i]
        spec += [c + n] if c == "s" else [c] * int(n or 1)
        i += 1
    lim = {"B": (0, 2 ** 8), "b": (-2 ** 7, 2 ** 7), "H": (0, 2 ** 16),
           "h": (-2 ** 15, 2 ** 15), "I": (0, 2 ** 32),
           "i": (-2 ** 31, 2 ** 31), "Q": (0, 2 ** 63)}
    for field, c in zip(names, spec):
        if rng.random() < 0.3:
            out[field] = b"" if c[0] == "s" else 0
        elif c[0] == "s":
            out[field] = bytes(rng.integers(65, 91, int(rng.integers(
                1, int(c[1:]) + 1))).astype(np.uint8))
        elif c == "f":
            out[field] = float(np.float32(rng.normal(0, 100)))
        else:
            lo, hi = lim[c]
            out[field] = int(rng.integers(lo, hi, dtype=np.int64)
                             if hi <= 2 ** 62 else rng.integers(0, 2 ** 62))
    return out


@pytest.mark.parametrize("name", ["MSGS", "MASK_VELOCITY", "MASK_POSITION",
                                  "MASK_Z_ONLY", "CMD_COMPONENT_ARM_DISARM",
                                  "CMD_NAV_TAKEOFF", "CMD_DO_SET_MODE",
                                  "CMD_SET_MESSAGE_INTERVAL", "STX", "STX2"])
def test_mavlink_tables_equal_jax(name):
    """Message ids, CRC_EXTRA, formats and field order, and the constants."""
    key = "_MSGS" if name == "MSGS" else name
    assert getattr(tmav, key) == getattr(jmav, key)


@SETTINGS
@given(data=hst.binary(max_size=400), seed=hst.integers(0, 0xFFFF))
def test_x25_crc_equals_jax(data, seed):
    assert tmav.x25_crc(data, seed) == jmav.x25_crc(data, seed)
    assert tmav.x25_crc(b"123456789") == 0x6F91


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_every_message_packs_and_decodes_as_jax(version, seed):
    """Every message of the set with random fields: the same bytes (msg
    ids over 255 need v2, and v1 refuses them in both), and the same
    decode."""
    rng = np.random.default_rng(seed)
    te = tmav.MavEncoder(sysid=int(rng.integers(0, 256)), compid=7,
                         version=version)
    je = jmav.MavEncoder(sysid=te.sysid, compid=7, version=version)
    stream = b""
    for name in NAMES * 3:
        f = _random_fields(rng, name)
        if version == 1 and jmav._MSGS[name][0] > 0xFF:
            with pytest.raises(ValueError, match="v2"):
                te.pack(name, **f)
            with pytest.raises(ValueError, match="v2"):
                je.pack(name, **f)
            continue
        got, want = te.pack(name, **f), je.pack(name, **f)
        assert got == want, name
        assert got[0] == (0xFE if version == 1 else 0xFD)
        stream += got
    assert list(tmav.decode_mavlink_stream(stream)) == list(
        jmav.decode_mavlink_stream(stream))
    with pytest.raises(ValueError):
        tmav.MavEncoder(version=3)


def _frames(seed: int) -> bytes:
    """A mixed v1/v2 stream of random messages, with corrupt bytes, torn
    frames, unknown ids and signed v2 frames."""
    rng = np.random.default_rng(seed)
    enc = {1: jmav.MavEncoder(sysid=1, compid=1, version=1),
           2: jmav.MavEncoder(sysid=1, compid=1, version=2)}
    parts = []
    for _ in range(40):
        name = NAMES[int(rng.integers(0, len(NAMES)))]
        v = 2 if jmav._MSGS[name][0] > 0xFF else int(rng.integers(1, 3))
        f = bytearray(enc[v].pack(name, **_random_fields(rng, name)))
        r = rng.random()
        if r < 0.1:
            f[int(rng.integers(1, len(f)))] ^= 0x41          # bad CRC
        elif r < 0.15:
            f = f[:int(rng.integers(1, len(f)))]               # torn
        elif r < 0.2 and v == 2:
            f[2] |= 0x01                                       # signed
            f += rng.integers(0, 256, 13).astype(np.uint8).tobytes()
        elif r < 0.25:
            f[5 if v == 1 else 7] = 0xEE                       # unknown id
        parts.append(bytes(f))
        if rng.random() < 0.3:
            parts.append(rng.integers(0, 256, int(rng.integers(1, 30)))
                         .astype(np.uint8).tobytes())
    return b"".join(parts)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_decoder_equals_jax_on_mixed_streams(seed):
    data = _frames(seed)
    want = list(jmav.decode_mavlink_stream(data))
    assert len(want) > 20
    assert list(tmav.decode_mavlink_stream(data)) == want


@SETTINGS
@given(data=hst.binary(max_size=2000))
def test_decoder_equals_jax_on_random_bytes(data):
    assert list(tmav.decode_mavlink_stream(data)) == list(
        jmav.decode_mavlink_stream(data))


@pytest.mark.parametrize("version", [1, 2])
def test_senders_equal_jax(version):
    """The reference's senders (heartbeat, modes, arm, takeoff, setpoints,
    RC override and release, stream negotiation, RCMAP requests)."""
    t = tmav.MavEncoder(version=version)
    j = jmav.MavEncoder(version=version)
    for enc in (t, j):
        enc.out = (enc.heartbeat() + enc.set_mode(1, 4) + enc.arm(1, 1)
                   + enc.disarm_force(1, 1) + enc.takeoff(1, 1, 0.5)
                   + enc.velocity_setpoint(1234, 1, 1, 0.35, -0.1, 0.0, 0.2)
                   + enc.position_setpoint(99, 1, 1, 1.0, 2.0, -0.5, 1.2)
                   + enc.z_setpoint(5, 1, 1, -0.4, -2.0)
                   + enc.attitude_thrust(7, 1, 1, 0.45, 0.3)
                   + enc.rc_override(1, 1, 1500, 1500, 1100, 1500)
                   + enc.rc_release(1, 1) + enc.stream_negotiation(1, "ul")
                   + enc.stream_negotiation(1, "cl")
                   + enc.rcmap_requests(1, 1))
    assert t.out == j.out and t.seq == j.seq
    with pytest.raises(ValueError, match="profile"):
        t.stream_negotiation(1, "xx")


def _tick_outputs(rng) -> dict:
    kind = int(rng.integers(0, 8))
    out = {"cmd_kind": kind,
           "cmd": rng.normal(0, 1, 4).astype(np.float32)}
    if kind == 5:
        out["cmd"] = rng.integers(1000, 2000, 4).astype(np.float32)
    if rng.random() < 0.3:
        out["req_mode"] = int(rng.integers(-1, 10))
    if rng.random() < 0.3:
        out["req_arm"] = int(rng.integers(-1, 2))
    if rng.random() < 0.2:
        out["req_takeoff"] = float(np.float32(rng.uniform(0.3, 1.0)))
    if rng.random() < 0.2:
        out["req_takeoff"] = float("nan")
    if rng.random() < 0.2:
        out["rc_release"] = bool(rng.integers(0, 2))
    return out


@pytest.mark.parametrize("version", [1, 2])
def test_encode_command_stream_equals_jax(version):
    rng = np.random.default_rng(5 + version)
    t = tmav.MavEncoder(version=version)
    j = jmav.MavEncoder(version=version)
    for k in range(300):
        out = _tick_outputs(rng)
        hb = k % 50 == 0
        assert tmav.encode_command_stream(t, 20 * k, out, 1, 1, hb) == \
            jmav.encode_command_stream(j, 20 * k, out, 1, 1, hb), (k, out)


@pytest.fixture(scope="module")
def recorded_diag():
    """A recorded port swarm run: 2 quads from the ground (arming, mode
    changes, takeoff, setpoints), 150 ticks at 20 ms, on the CPU."""
    world = tsim.make_world(2, room=(-3.5, -3.5, 3.5, 3.5),
                            obstacles=[(1.5, -0.5, 2.5, 0.5)], device="cpu")
    st = tsim.sim_init(2, 3, spread_m=0.5, device="cpu")
    _, diag = tsim.sim_run(st, world, 150, port.UL_PROFILE, dt_ms=20,
                           record=True)
    return diag


@pytest.mark.parametrize("quad", [0, 1])
def test_sim_diag_to_mavlink_equals_jax(recorded_diag, quad):
    """The same numpy diag through both packages' function: equal bytes;
    the port's function also takes the tensors themselves."""
    np_diag = {k: v.numpy() for k, v in recorded_diag.items()}
    want = jax_sim_diag_to_mavlink(np_diag, quad=quad)
    kinds = {n for n, _ in jmav.decode_mavlink_stream(want)}
    assert {"HEARTBEAT", "COMMAND_LONG", "SET_MODE"} <= kinds
    assert tsim.sim_diag_to_mavlink(np_diag, quad=quad) == want
    assert tsim.sim_diag_to_mavlink(recorded_diag, quad=quad) == want


def test_attitude_thrust_quaternion_as_jax():
    """attitude_thrust's yaw-only quaternion goes through math.cos/sin of
    a float64 half angle in both packages."""
    for yaw in (0.0, math.pi / 3, -2.5):
        t = tmav.MavEncoder().attitude_thrust(1, 1, 1, 0.5, yaw)
        assert t == jmav.MavEncoder().attitude_thrust(1, 1, 1, 0.5, yaw)
