"""PyTorch port, the cone and hybrid replay modes (replay/mapping.py,
ops/conex.py): every kernel name of the dense production modes against
the JAX package's kernel="cone" / "hybrid" replay, itself (resume) and
across the two packages (a replay started in one resumes in the other).

On the CPU, "cone" and "hybrid" run per frame in plain torch, and
"conex", "resident_cone" and "hybridx" run the schedule plus the cone
kernel's plain torch version (replay_cone_plain); the CUDA kernel itself
is checked on the card by tests/test_torch_kernel.py and chip_smoke.py.

Tolerances: grids, origins, inited, used and kf_flags are compared bit for
bit.  filt is compared at atol 1e-6, because XLA may contract the JAX
package's EMA into an fma (tests/test_replay.py:36-39)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from micro_quad_slam_tpu.replay import mapping as jm
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import CL_PROFILE as JAX_CL
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch.ops import conex as cx
from micro_quad_slam_tpu_torch.replay import mapping as tm
from micro_quad_slam_tpu_torch.utils import obs

torch.set_num_threads(2)

# port kernel name -> the JAX package's XLA replay mode it must equal
KERNELS = {"cone": "cone", "conex": "cone", "resident_cone": "cone",
           "hybrid": "hybrid", "hybridx": "hybrid"}


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


def _port(frames, kernel, cfg=port.UL_PROFILE, state0=None):
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
    """The JAX package's cone and hybrid replays of _two_flights."""
    frames = _two_flights()
    runs = {}
    for mode in ("cone", "hybrid"):
        st, outs = jm.replay_mapping_batched(frames, JAX_UL, kernel=mode)
        assert (np.asarray(outs["kf_flags"]) != 0).sum() >= 1  # recentered
        runs[mode] = (st, outs)
    return frames, runs


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_replay_matches_jax(two_flights_jax, kernel):
    frames, runs = two_flights_jax
    st, outs = runs[KERNELS[kernel]]
    tst, touts = _port(frames, kernel)
    _assert_state(st, tst, outs, touts)
    assert int((tst.grid < 0).sum()) > 1000 and int((tst.grid > 0).sum()) > 20


@pytest.mark.parametrize("kernel", sorted(KERNELS))
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
    for k in ("used", "kf_flags"):
        np.testing.assert_array_equal(touts[k].numpy(),
                                      fouts[k][:, T // 2:].numpy())


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_resume_across_packages(two_flights_jax, kernel, first):
    """The first half replays in one package, the state crosses over as
    numpy arrays, the second half replays in the other; the result equals
    the JAX package's unbroken replay."""
    frames, runs = two_flights_jax
    mode = KERNELS[kernel]
    full = runs[mode][0]
    T = frames["x_m"].shape[1]
    head = {k: v[:, :T // 2] for k, v in frames.items()}
    tail = {k: v[:, T // 2:] for k, v in frames.items()}
    if first == "jax":
        st0, _ = jm.replay_mapping_batched(head, JAX_UL, kernel=mode)
        state0 = tm.mapping_state_from_numpy(jax.tree.map(np.asarray, st0),
                                             "cpu")
        end, _ = _port(tail, kernel, state0=state0)
    else:
        st0, _ = _port(head, kernel)
        d = tm.mapping_state_to_numpy(st0)
        state0 = jm.MappingState(**{k: jnp.asarray(v) for k, v in d.items()})
        jend, _ = jm.replay_mapping_batched(tail, JAX_UL, kernel=mode,
                                            state0=state0)
        end = tm.mapping_state_from_numpy(jax.tree.map(np.asarray, jend),
                                          "cpu")
    _assert_state(full, end)


@pytest.mark.parametrize("kernel", ["conex", "hybridx"])
def test_cl_profile_gates(kernel):
    """CL logs number LANDING=6: a CL replay maps them, like the JAX
    package's (tests/test_replay.py:126-140)."""
    log = synth_room_scanlog(n_frames=8, seed=29)
    log.state[:] = 6
    frames = {k: v[None] for k, v in tm.scanlog_to_arrays(log).items()}
    jst, jouts = jm.replay_mapping_batched(frames, JAX_CL,
                                           kernel=KERNELS[kernel])
    st, outs = _port(frames, kernel, port.CL_PROFILE)
    assert bool(st.inited[0]) and outs["used"].any()
    _assert_state(jst, st, jouts, outs)


@pytest.mark.parametrize("hybrid", [False, True])
def test_schedule_words(hybrid):
    """The schedule's layout: header, float words round-tripped through
    int32, and (hybrid) the endpoints; replay_cone on the CPU is its
    plain version and launches nothing."""
    frames = port.frames_to_torch(_two_flights(), "cpu")
    sched, outs, _ = tm.schedule(frames, port.UL_PROFILE,
                                 mode="hybrid" if hybrid else "cone")
    B, T = frames["x_m"].shape
    assert sched.dtype == torch.int32
    assert tuple(sched.shape) == (B, T, cx.words_of(hybrid))
    geom = port.DEFAULT_GEOM
    np.testing.assert_array_equal(sched[..., cx.H_R0],
                                  sched[..., cx.H_PCY] - geom.win_r)
    np.testing.assert_array_equal(sched[..., cx.H_EN] != 0, outs["used"])
    bounds = sched[..., cx.W_BOUNDS:cx.W_BOUNDS + 18].contiguous().view(
        torch.float32)
    norm = bounds[..., 0::2] ** 2 + bounds[..., 1::2] ** 2
    assert torch.allclose(norm, torch.ones_like(norm), atol=1e-6)
    if hybrid:
        ed = sched[..., cx.W_ED:cx.W_ED + 32]
        assert int((ed == port.UL_PROFILE.map.lo_occ_inc).sum()) > 100
    before = obs.counters().get("launches.replay_cone", 0)
    grids = torch.zeros((B, geom.prows, geom.pcols), dtype=torch.int8)
    cx.replay_cone(grids, sched, port.UL_PROFILE, hybrid)
    assert obs.counters().get("launches.replay_cone", 0) == before
    want, _ = _port(_two_flights(), "hybrid" if hybrid else "cone")
    assert torch.equal(grids, want.grid)
