"""The port's native scanlog and stream reader (micro_quad_slam_tpu_torch/
io/native.py over its copy of csrc/mqs_io.cpp) against the port's Python
codecs and the JAX package's native reader: the counterparts of
tests/test_native_io.py.  The copy of the C++ source is held byte-equal
to the JAX package's.  The native tests skip only where no g++ is
found."""

import dataclasses
import io
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from micro_quad_slam_tpu.io import native as jnative
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu_torch.formats import (
    ScanLog,
    encode_ctrl_frame,
    encode_scan_frame,
    read_scanlog,
    write_scanlog,
)
from micro_quad_slam_tpu_torch.formats.scanframe import decode_stream_arrays
from micro_quad_slam_tpu_torch.io import native

REPO = Path(__file__).resolve().parents[1]
FIELDS = [f.name for f in dataclasses.fields(ScanLog)]
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ toolchain")


def test_port_copy_of_the_source_is_byte_equal():
    assert native.SOURCE.read_bytes() == (REPO / "csrc" / "mqs_io.cpp"
                                          ).read_bytes()
    assert native.GXX_FLAGS == ("-O3", "-shared", "-fPIC", "-std=c++17")


def _equal(a, b):
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@needs_gxx
def test_native_scanlog_matches_python(tmp_path):
    assert native.native_available()
    log = synth_room_scanlog(n_frames=40, seed=5, noise_mm=6.0,
                             dropout_p=0.04, with_flow=True)
    p = str(tmp_path / "scanlog.bin")
    write_scanlog(p, ScanLog(**{k: getattr(log, k) for k in FIELDS}))
    got = native.read_scanlog_native(p)
    assert isinstance(got, ScanLog)
    _equal(got, read_scanlog(p))
    _equal(got, jnative.read_scanlog_native(p))
    _equal(native.read_scanlog_native(Path(p).read_bytes()), got)


@needs_gxx
def test_native_scanlog_skips_bad_magic():
    log = synth_room_scanlog(n_frames=4)
    buf = io.BytesIO()
    write_scanlog(buf, ScanLog(**{k: getattr(log, k) for k in FIELDS}))
    raw = bytearray(buf.getvalue())
    raw[7 + 569] ^= 0xFF  # corrupt record 1's magic
    out = native.read_scanlog_native(bytes(raw))
    assert len(out) == 3
    np.testing.assert_array_equal(out.host_ms,
                                  np.asarray(log.host_ms)[[0, 2, 3]])
    _equal(out, read_scanlog(bytes(raw), strict=False))


def _stream() -> bytes:
    rng = np.random.default_rng(0)
    parts = [bytes(rng.integers(0, 256, 200, dtype=np.uint8).tobytes())]
    for i in range(5):
        grid = (rng.integers(0, 160, (4, 8, 8)).astype(np.uint16) + 1000)
        parts.append(encode_scan_frame(100 + i, grid))
        parts.append(encode_ctrl_frame(i % 2, i))
        parts.append(bytes([0xA6, 0x01]))  # torn ctrl: eats 5 bytes
        parts.append(b"\x00\x42" * 7)
    return b"".join(parts)


@needs_gxx
def test_native_stream_matches_python():
    stream = _stream()
    t_p, g_p, c_p = decode_stream_arrays(stream)
    t_n, g_n, c_n = native.decode_stream_native(stream)
    np.testing.assert_array_equal(t_p, t_n)
    np.testing.assert_array_equal(g_p, g_n)
    assert c_p == c_n and len(t_n) >= 1
    t_j, g_j, c_j = jnative.decode_stream_native(stream)
    np.testing.assert_array_equal(t_j, t_n)
    np.testing.assert_array_equal(g_j, g_n)
    assert c_j == c_n


@needs_gxx
def test_native_decode_is_fast(tmp_path):
    log = synth_room_scanlog(n_frames=600, seed=1)
    p = str(tmp_path / "big.bin")
    write_scanlog(p, ScanLog(**{k: getattr(log, k) for k in FIELDS}))
    native.read_scanlog_native(p)            # build and load first
    t0 = time.perf_counter()
    out = native.read_scanlog_native(p)
    dt = time.perf_counter() - t0
    assert len(out) == 600
    # 600 records (340 KB) must decode in well under 50 ms natively
    assert dt < 0.05, f"native decode took {dt * 1e3:.1f} ms"


def test_without_a_toolchain_the_python_codecs_read(monkeypatch, tmp_path):
    """No g++ and no built library: every entry point reads with the
    Python codecs, and native_available() says so."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    assert not native.native_available()
    log = synth_room_scanlog(n_frames=6, seed=2)
    buf = io.BytesIO()
    write_scanlog(buf, ScanLog(**{k: getattr(log, k) for k in FIELDS}))
    _equal(native.read_scanlog_native(buf.getvalue()),
           read_scanlog(buf.getvalue()))
    t, g, c = native.decode_stream_native(_stream())
    t_p, g_p, c_p = decode_stream_arrays(_stream())
    np.testing.assert_array_equal(t, t_p)
    np.testing.assert_array_equal(g, g_p)
    assert c == c_p
