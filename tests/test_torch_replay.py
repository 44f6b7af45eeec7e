"""PyTorch port, replay/mapping.py and ops/residentx.py: the batched exact
replay against the JAX package, the golden C model, itself (resume) and
across the two packages (a replay started in one resumes in the other).

On the CPU the "residentx" path runs the schedule plus the kernel's plain
torch version (replay_exact_plain); the CUDA kernel itself is checked on
the card by tests/test_torch_kernel.py and chip_smoke.py.

Tolerances: grids, origins, inited, used and kf_flags are compared bit for
bit.  filt is compared at atol 1e-6, because XLA may contract the JAX
package's EMA into an fma (tests/test_replay.py:36-39)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from micro_quad_slam_tpu.golden import golden_replay_mapping
from micro_quad_slam_tpu.replay import mapping as jm
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import CL_PROFILE as JAX_CL
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch.utils.config import CL_PROFILE, UL_PROFILE
from micro_quad_slam_tpu_torch.replay import mapping as tm

torch.set_num_threads(2)

KERNELS = ("xla", "residentx")


def _two_flights():
    """tests/test_pallas.py:84-92: two noisy flights, the second dragged
    40 m so that it recenters mid-flight."""
    logs = [synth_room_scanlog(n_frames=16, seed=3, noise_mm=5.0,
                               dropout_p=0.05),
            synth_room_scanlog(n_frames=16, seed=7, noise_mm=4.0)]
    arrs = [jm.scanlog_to_arrays(lg) for lg in logs]
    b = {k: np.stack([a[k] for a in arrs]) for k in arrs[0]}
    T = b["x_m"].shape[1]
    b["x_m"][1] = np.linspace(0.0, 34.0, T, dtype=np.float32)
    b["y_m"][1] = np.linspace(0.0, -21.0, T, dtype=np.float32)
    return b


def _port(frames, kernel, cfg=UL_PROFILE, state0=None):
    return port.replay_mapping_batched(port.frames_to_torch(frames, "cpu"),
                                       cfg, kernel=kernel, state0=state0)


def _assert_state(jstate, tstate, jouts=None, touts=None):
    """jstate/jouts: the JAX package's (arrays); tstate/touts: the port's."""
    for f in ("grid", "origin_x", "origin_y", "inited"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tstate.filt.numpy(), np.asarray(jstate.filt),
                               rtol=0, atol=1e-6)
    for k in (jouts or {}):
        want, got = np.asarray(jouts[k]), touts[k].numpy()
        if k == "filt":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.fixture(scope="module")
def two_flights_jax():
    frames = _two_flights()
    st, outs = jm.replay_mapping_batched(frames, JAX_UL)
    assert (np.asarray(outs["kf_flags"]) != 0).sum() >= 1   # recentered
    return frames, st, outs


@pytest.mark.parametrize("kernel", KERNELS)
def test_replay_matches_jax(two_flights_jax, kernel):
    frames, st, outs = two_flights_jax
    tst, touts = _port(frames, kernel)
    _assert_state(st, tst, outs, touts)


def test_residentx_matches_jax_pallas_interpret(two_flights_jax):
    """The port's residentx path against the TPU kernel itself, run in
    interpret mode (the JAX package's own CPU check of it)."""
    from micro_quad_slam_tpu.ops.pallas_residentx import (
        pallas_replay_residentx)
    frames, _, _ = two_flights_jax
    st, outs = pallas_replay_residentx(frames, JAX_UL, interpret=True)
    tst, touts = _port(frames, "residentx")
    _assert_state(st, tst, outs, touts)


def _golden_flights():
    """tests/test_replay.py:27-66: a hover and an 18 m line that recenters."""
    return {
        "hover": synth_room_scanlog(n_frames=32, room=(-2.0, -2.0, 2.0, 2.0),
                                    path="hover", yaw_rate_dps=20.0,
                                    noise_mm=6.0, dropout_p=0.05, seed=11),
        "line_recenter": synth_room_scanlog(
            n_frames=40, room=(-3.0, -3.0, 40.0, 3.0), path="line",
            path_radius_m=18.0, seed=13, noise_mm=4.0),
    }


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("flight", ["hover", "line_recenter"])
def test_replay_bit_matches_golden(flight, kernel):
    log = _golden_flights()[flight]
    frames = {k: v[None] for k, v in tm.scanlog_to_arrays(log).items()}
    st, outs = _port(frames, kernel)
    mapper, used = golden_replay_mapping(log)
    np.testing.assert_array_equal(port.logical_grid(st.grid[0]).numpy(),
                                  mapper.grid)
    np.testing.assert_array_equal(outs["used"][0].numpy(), used)
    assert st.origin_x[0].item() == mapper.origin_x
    if flight == "line_recenter":
        assert mapper.recentered and outs["kf_flags"].any()


class _FramesLog:
    """A one-flight frames dict seen as a scanlog by golden_replay_mapping."""

    def __init__(self, frames):
        for k, v in frames.items():
            setattr(self, k, v[0])

    def __len__(self):
        return self.x_m.shape[0]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mm", [51, 53])
def test_short_beams_at_the_pose_cell_match_golden(mm, kernel):
    """Every zone at 51-53 mm: most of the 32 rays of a scan end in the
    pose cell (+6 each), so the cell swings past the whole clamp range in
    one scan.  The per-ray clamp matches the golden C model; the JAX
    package's prefix-extrema form with int8 carries does not here
    (ROADMAP.md section C)."""
    T = 3
    frames = {"grid_mm": np.full((1, T, 4, 8, 8), mm, np.uint16),
              "x_m": np.zeros((1, T), np.float32),
              "y_m": np.zeros((1, T), np.float32),
              "yaw_deg": np.full((1, T), 45.0, np.float32),
              "of_q": np.full((1, T), 200, np.int32),
              "of_rate_x": np.zeros((1, T), np.float32),
              "sys_health": np.zeros((1, T), np.int64),
              "state": np.full((1, T), 5, np.uint8)}
    st, _ = _port(frames, kernel)
    mapper, _ = golden_replay_mapping(_FramesLog(frames))
    grid = port.logical_grid(st.grid[0]).numpy()
    assert mapper.grid[250, 250] >= 70             # the pose cell saturates
    np.testing.assert_array_equal(grid, mapper.grid)


@pytest.mark.parametrize("kernel", KERNELS)
def test_replay_gates_respected(kernel):
    """Bad flow quality, an unhealthy XY bit and a stale pose skip frames
    exactly as the golden model does (tests/test_replay.py:69-82)."""
    log = synth_room_scanlog(n_frames=16, seed=17)
    log.of_rate_x[4:8] = 0.5
    log.of_q[4:8] = 10
    log.sys_health[10] = 0x01
    log.x_m[12] = np.nan
    frames = {k: v[None] for k, v in tm.scanlog_to_arrays(log).items()}
    st, outs = _port(frames, kernel)
    mapper, used_g = golden_replay_mapping(log)
    used = outs["used"][0].numpy()
    np.testing.assert_array_equal(used, used_g)
    assert not used[4:8].any() and not used[10] and not used[12]
    np.testing.assert_array_equal(port.logical_grid(st.grid[0]).numpy(),
                                  mapper.grid)


@pytest.mark.parametrize("kernel", KERNELS)
def test_resume_split_at_half_is_bit_exact(kernel):
    frames = _two_flights()
    T = frames["x_m"].shape[1]
    full, fouts = _port(frames, kernel)
    head, _ = _port({k: v[:, :T // 2] for k, v in frames.items()}, kernel)
    tail, touts = _port({k: v[:, T // 2:] for k, v in frames.items()}, kernel,
                        state0=head)
    for f in full._fields:
        np.testing.assert_array_equal(getattr(tail, f).numpy(),
                                      getattr(full, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(touts["used"].numpy(),
                                  fouts["used"][:, T // 2:].numpy())


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages(two_flights_jax, first):
    """The first half replays in one package, the state crosses over as
    numpy arrays, the second half replays in the other; the result equals
    the JAX package's unbroken replay."""
    frames, full, _ = two_flights_jax
    T = frames["x_m"].shape[1]
    head = {k: v[:, :T // 2] for k, v in frames.items()}
    tail = {k: v[:, T // 2:] for k, v in frames.items()}
    if first == "jax":
        st0, _ = jm.replay_mapping_batched(head, JAX_UL)
        state0 = tm.mapping_state_from_numpy(jax.tree.map(np.asarray, st0),
                                             "cpu")
        end, _ = _port(tail, "residentx", state0=state0)
    else:
        st0, _ = _port(head, "residentx")
        d = tm.mapping_state_to_numpy(st0)
        state0 = jm.MappingState(**{k: jnp.asarray(v) for k, v in d.items()})
        jend, _ = jm.replay_mapping_batched(tail, JAX_UL, state0=state0)
        end = tm.mapping_state_from_numpy(jax.tree.map(np.asarray, jend),
                                          "cpu")
    _assert_state(full, end)


@pytest.mark.parametrize("kernel", KERNELS)
def test_state0_batch_mismatch_raises(kernel):
    frames = _two_flights()
    state0 = port.mapping_init(3, device="cpu")
    with pytest.raises(ValueError, match="batch mismatch"):
        _port(frames, kernel, state0=state0)


@pytest.mark.parametrize("kernel", KERNELS)
def test_cl_profile_uses_cl_state_enum(kernel):
    """CL logs number LANDING=6: a CL replay maps them, and CL DISARMING
    (7) never inits (tests/test_replay.py:126-140)."""
    log = synth_room_scanlog(n_frames=8, seed=29)
    log.state[:] = 6
    frames = {k: v[None] for k, v in tm.scanlog_to_arrays(log).items()}
    jst, jouts = jm.replay_mapping_batched(frames, JAX_CL)
    st, outs = _port(frames, kernel, CL_PROFILE)
    assert bool(st.inited[0]) and outs["used"].any()
    _assert_state(jst, st, jouts, outs)
    frames["state"][:] = 7
    st, outs = _port(frames, kernel, CL_PROFILE)
    assert not st.inited.any() and not outs["used"].any()
    assert int(st.grid.abs().sum()) == 0


def test_replay_mapping_single_flight_and_batch_metrics():
    frames = _two_flights()
    one = {k: v[0] for k, v in port.frames_to_torch(frames, "cpu").items()}
    st, outs = port.replay_mapping(one, UL_PROFILE)
    bst, bouts = _port(frames, "xla")
    assert st.grid.shape == bst.grid.shape[1:]
    np.testing.assert_array_equal(st.grid.numpy(), bst.grid[0].numpy())
    np.testing.assert_array_equal(outs["used"].numpy(),
                                  bouts["used"][0].numpy())
    m = port.batch_metrics(bouts)
    assert int(m["frames_total"]) == 32
    assert int(m["frames_used"]) == int(bouts["used"].sum())
    assert int(m["recenters"]) == int((bouts["kf_flags"] != 0).sum()) >= 1


def test_cli_replay_mixed_lengths(tmp_path, capsys):
    """python -m micro_quad_slam_tpu_torch replay on two logs of different
    lengths: one padded batch, each map equal to that log's solo replay."""
    from micro_quad_slam_tpu.formats.scanlog import write_scanlog
    from micro_quad_slam_tpu_torch.__main__ import main

    paths, logs = [], []
    for i, n in enumerate((20, 13)):
        log = synth_room_scanlog(n_frames=n, seed=40 + i, noise_mm=5.0,
                                 path=("circle", "hover")[i])
        p = tmp_path / f"l{i}.bin"
        write_scanlog(str(p), log)
        paths.append(str(p))
        logs.append(log)
    out = tmp_path / "m.npy"
    assert main(["replay", "--log", *paths, "--out", str(out),
                 "--kernel", "residentx", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "[0] replayed 20 frames" in text and "[1] replayed 13 frames" in text
    for i, log in enumerate(logs):
        solo = {k: v[None] for k, v in tm.scanlog_to_arrays(log).items()}
        st, _ = _port(solo, "xla")
        np.testing.assert_array_equal(np.load(tmp_path / f"m_{i}.npy"),
                                      port.logical_grid(st.grid[0]).numpy())
