"""PyTorch port, formats/scanframe.py, wirecap.py, navlog.py and armlink.py:
the port's copies against the JAX package's modules on the same seeded
inputs.  Encoders are held to the same bytes, parsers to the same output
on random byte streams (0xA6 hijacks and arbitrary chunking included),
the navlog writer to the same file bytes."""

import io

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from micro_quad_slam_tpu import formats as jformats
from micro_quad_slam_tpu.formats import armlink as jarm
from micro_quad_slam_tpu.formats import navlog as jnav
from micro_quad_slam_tpu.formats import scanframe as jsf
from micro_quad_slam_tpu.formats import wirecap as jwc
from micro_quad_slam_tpu_torch import formats as tformats
from micro_quad_slam_tpu_torch.formats import armlink as tarm
from micro_quad_slam_tpu_torch.formats import navlog as tnav
from micro_quad_slam_tpu_torch.formats import scanframe as tsf
from micro_quad_slam_tpu_torch.formats import wirecap as twc

SETTINGS = settings(max_examples=40, deadline=None, derandomize=True)


def test_formats_package_exports_what_the_jax_one_does():
    names = [n for n in dir(jformats) if not n.startswith("_")
             and n not in ("annotations",)]
    for n in names:
        assert hasattr(tformats, n), n
        j, t = getattr(jformats, n), getattr(tformats, n)
        if isinstance(j, (int, bytes, str)):
            assert j == t, n
    assert tformats.SCANREC_DTYPE == jformats.SCANREC_DTYPE


@pytest.mark.parametrize("name", ["SCAN_HEADER", "CTRL_HEADER", "SCAN_BYTES",
                                  "CTRL_BYTES", "CMD_ARM", "CMD_DISARM"])
def test_scanframe_constants_equal(name):
    assert getattr(tsf, name) == getattr(jsf, name)


def _scan_grids(rng, n):
    g = rng.integers(0, 0x10000, (n, 4, 8, 8)).astype(np.uint16)
    g[rng.random(g.shape) < 0.05] = 0xFFFF
    g[rng.random(g.shape) < 0.02] = 0xA6A6      # the hijack byte, twice
    return g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_and_ctrl_frame_bytes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for g, t in zip(_scan_grids(rng, 8), rng.integers(0, 2 ** 32, 8)):
        assert tsf.encode_scan_frame(int(t), g) == jsf.encode_scan_frame(
            int(t), g)
    for cmd, seq in zip(rng.integers(0, 256, 16), rng.integers(0, 2 ** 32,
                                                               16)):
        assert tsf.encode_ctrl_frame(int(cmd), int(seq)) == \
            jsf.encode_ctrl_frame(int(cmd), int(seq))
    buf = rng.integers(0, 256, 1000).astype(np.uint8).tobytes()
    assert tsf.xor8(buf) == jsf.xor8(buf) and tsf.xor8(b"") == 0
    with pytest.raises(ValueError):
        tsf.encode_scan_frame(0, np.zeros(10, np.uint16))


def _stream(rng, n_frames: int) -> bytes:
    """Frames of both kinds interleaved with garbage, some with a broken
    checksum, some SCAN frames carrying 0xA6 bytes."""
    parts = []
    for g, t in zip(_scan_grids(rng, n_frames), rng.integers(0, 2 ** 32,
                                                             n_frames)):
        f = bytearray(jsf.encode_scan_frame(int(t), g))
        if rng.random() < 0.15:
            f[-1] ^= 0x5A
        parts.append(bytes(f))
        if rng.random() < 0.5:
            parts.append(jsf.encode_ctrl_frame(int(rng.integers(0, 3)),
                                               int(rng.integers(0, 9))))
        if rng.random() < 0.5:
            parts.append(rng.integers(0, 256, int(rng.integers(1, 40)))
                         .astype(np.uint8).tobytes())
    return b"".join(parts)


def _parse(mod, data: bytes, cuts) -> list:
    parser = mod.StreamParser()
    out, last = [], 0
    for c in list(cuts) + [len(data)]:
        out += parser.feed(data[last:c])
        last = c
    return [(k, {n: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for n, v in f.items()}) for k, f in out]


@SETTINGS
@given(seed=hst.integers(0, 2 ** 31 - 1), n=hst.integers(1, 12),
       chunks=hst.lists(hst.integers(0, 8000), max_size=30))
def test_stream_parser_equals_jax_on_random_streams(seed, n, chunks):
    """Random interleaved streams, fed in arbitrary chunks: the same
    frames in the same order as the JAX parser (which drops a SCAN frame
    whose bytes hold 0xA6, as the reference does)."""
    data = _stream(np.random.default_rng(seed), n)
    cuts = sorted(c for c in chunks if c < len(data))
    want = _parse(jsf, data, cuts)
    assert _parse(tsf, data, cuts) == want
    assert _parse(tsf, data, []) == want        # chunking changes nothing


@SETTINGS
@given(data=hst.binary(max_size=3000))
def test_stream_parser_equals_jax_on_random_bytes(data):
    assert _parse(tsf, data, []) == _parse(jsf, data, [])


def test_ctrl_header_hijacks_mid_scan_as_in_jax():
    """tests/test_formats.py:106's case: a 0xA6 byte inside a SCAN frame
    starts a CTRL frame that swallows 6 bytes, and the SCAN frame drops
    (the frame after it too: the SCAN parser is out of step)."""
    g = np.full((4, 8, 8), 1000, np.uint16)
    g[0, 0, 0] = 0xA6
    data = jsf.encode_scan_frame(5, g) + jsf.encode_scan_frame(
        6, np.full((4, 8, 8), 1000, np.uint16))
    want = _parse(jsf, data, [])
    assert _parse(tsf, data, []) == want
    assert _parse(tsf, data[:518], []) == [] == _parse(jsf, data[:518], [])
    assert 5 not in [f["t_ms"] for k, f in want if k == "scan"]


@pytest.mark.parametrize("seed", [3, 4])
def test_decode_stream_and_arrays_equal_jax(seed):
    data = _stream(np.random.default_rng(seed), 10)
    assert len(list(tsf.decode_stream(data))) == len(list(
        jsf.decode_stream(data)))
    got, want = tsf.decode_stream_arrays(data), jsf.decode_stream_arrays(data)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]
    empty = tsf.decode_stream_arrays(b"")
    assert empty[1].shape == (0, 4, 8, 8) and empty[2] == []


@pytest.mark.parametrize("seed", [5, 6])
def test_ctrl_debouncer_equals_jax(seed):
    rng = np.random.default_rng(seed)
    t, d = tsf.CtrlDebouncer(), jsf.CtrlDebouncer()
    now = 0
    for _ in range(300):
        now += int(rng.integers(1, 400))
        cmd, seq = int(rng.integers(0, 3)), int(rng.integers(0, 6))
        assert t.feed(cmd, seq, now) == d.feed(cmd, seq, now)


def test_wirecap_bytes_and_reader_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    recs = [(int(rng.integers(0, 3)), int(rng.integers(0, 2 ** 32)),
             rng.integers(0, 256, int(rng.integers(0, 600)))
             .astype(np.uint8).tobytes()) for _ in range(50)]
    pt, pj = tmp_path / "t.bin", tmp_path / "j.bin"
    assert twc.write_wirecap(str(pt), recs) == jwc.write_wirecap(str(pj),
                                                                 recs)
    assert pt.read_bytes() == pj.read_bytes()
    assert twc.read_wirecap(str(pt)) == jwc.read_wirecap(str(pj)) == recs
    torn = tmp_path / "torn.bin"
    torn.write_bytes(pt.read_bytes()[:-3])           # a torn last record
    assert twc.read_wirecap(str(torn)) == jwc.read_wirecap(str(torn))
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"nope")
    with pytest.raises(ValueError, match="magic"):
        twc.read_wirecap(str(bad))
    assert (twc.WIRECAP_MAGIC, twc.CH_HUB, twc.CH_FC) == (
        jwc.WIRECAP_MAGIC, jwc.CH_HUB, jwc.CH_FC)


def _navlog_rows(rng, n: int) -> list:
    """Rows of write_row's arguments: float32 values (as the replay hands
    them), NaNs, out-of-range state and alt_src codes."""
    def f32(scale):
        v = float(np.float32(rng.normal(0, scale)))
        return float("nan") if rng.random() < 0.1 else v
    return [(int(rng.integers(0, 2 ** 32)), int(rng.integers(-1, 12)),
             bool(rng.integers(0, 2)), bool(rng.integers(0, 2)),
             int(rng.integers(0, 10)), f32(90), f32(1), int(rng.integers(-1,
                                                                       5)),
             f32(5), f32(5), f32(1), f32(1), f32(1), int(rng.integers(0,
                                                                      256)),
             f32(2), f32(2), f32(3), f32(3), f32(3), f32(3), f32(8),
             int(rng.integers(0, 7))) for _ in range(n)]


@pytest.mark.parametrize("seed", [8, 9])
def test_navlog_bytes_and_reader_equal_jax(tmp_path, seed):
    rows = _navlog_rows(np.random.default_rng(seed), 60)
    pt, pj = tmp_path / "t.csv", tmp_path / "j.csv"
    for mod, p in ((tnav, pt), (jnav, pj)):
        with mod.NavlogWriter(str(p)) as w:
            for r in rows:
                w.write_row(*r)
        with mod.NavlogWriter(str(p), append=True) as w:   # header once
            w.write_row(*rows[0])
    assert pt.read_bytes() == pj.read_bytes()
    got, want = tnav.read_navlog(str(pt)), jnav.read_navlog(str(pj))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    text = pt.read_text() + "t_ms,state\n1,IDLE,short\n"   # a restart's header
    np.testing.assert_array_equal(tnav.read_navlog(io.StringIO(text))["x_m"],
                                  jnav.read_navlog(io.StringIO(text))["x_m"])
    assert tnav.NAVLOG_HEADER == jnav.NAVLOG_HEADER


def test_navlog_to_a_stream_equals_jax():
    rows = _navlog_rows(np.random.default_rng(10), 5)
    out = []
    for mod in (tnav, jnav):
        buf = io.StringIO()
        w = mod.NavlogWriter(buf)
        for r in rows:
            w.write_row(*r)
        w.flush()
        w.close()
        out.append(buf.getvalue())
    assert out[0] == out[1]


def test_armlink_bytes_and_remote_equal_jax():
    rng = np.random.default_rng(11)
    for cmd, seq, t in zip(rng.integers(0, 3, 20), rng.integers(0, 2 ** 32,
                                                                20),
                           rng.integers(0, 2 ** 32, 20)):
        msg = tarm.encode_arm_msg(int(cmd), int(seq), int(t))
        assert msg == jarm.encode_arm_msg(int(cmd), int(seq), int(t))
        assert tarm.decode_arm_msg(msg) == jarm.decode_arm_msg(msg)
    for junk in (b"", b"\xc3" * 9, b"\x00" * 10,
                 bytes([0xC3, 7]) + b"\x00" * 8):
        assert tarm.decode_arm_msg(junk) == jarm.decode_arm_msg(junk)
    rt, rj = tarm.ArmRemote(), jarm.ArmRemote()
    now = 0
    for _ in range(200):
        now += int(rng.integers(1, 500))
        op = ("press", "tick", "release")[int(rng.integers(0, 3))]
        assert getattr(rt, op)(now) == getattr(rj, op)(now)
        assert (rt.armed, rt.seq) == (rj.armed, rj.seq)
