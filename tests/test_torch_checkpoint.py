"""PyTorch port, utils/checkpoint.py: checkpoints across the two packages.

The JAX package pickles host numpy trees (`step_N.pkl`) where orbax is
absent; these tests make it do so by hiding orbax from its import.  The
port reads those pickles, whose NamedTuples (MappingState, SimState,
FcSim, BehaviorState, EkfState) become field dicts by the port's own
field lists, pinned here to the JAX classes' `_fields`; the JAX package
reads the port's files.  Resumes are bit-equal to unbroken runs: a port
replay resumed from a JAX checkpoint, a JAX replay resumed from a port
checkpoint, and a port swarm resumed from a port checkpoint (its
generator included)."""

import io
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from micro_quad_slam_tpu.models import behavior as jbeh
from micro_quad_slam_tpu.models import simulator as jsim
from micro_quad_slam_tpu.ops import ekf as jekf
from micro_quad_slam_tpu.replay import mapping as jm
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils import checkpoint as jck
from micro_quad_slam_tpu.utils.config import UL_PROFILE as JAX_UL
import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch.models import behavior as tbeh
from micro_quad_slam_tpu_torch.models import simulator as tsim
from micro_quad_slam_tpu_torch.ops import ekf as tekf
from micro_quad_slam_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)


@pytest.fixture
def jax_pickles(monkeypatch):
    """The JAX package's save_checkpoint writes its pickle format."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


JAX_CLASSES = {"MappingState": jm.MappingState, "EkfState": jekf.EkfState,
               "FcSim": jsim.FcSim, "SimState": jsim.SimState,
               "BehaviorState": jbeh.BehaviorState}


@pytest.mark.parametrize("name", sorted(JAX_CLASSES))
def test_field_lists_equal_the_jax_classes(name):
    """NEWOBJ hands a class its fields by position: the port's lists must
    be the JAX classes' _fields, nested classes included, and the port's
    own NamedTuples keep the same names (SimState's key is its gen)."""
    cls = JAX_CLASSES[name]
    (key, fields), = [(k, v) for k, v in tck.JAX_RECORDS.items()
                      if k[1] == name]
    fields = fields() if callable(fields) else fields
    assert key == (cls.__module__, cls.__qualname__)
    assert tuple(fields) == cls._fields
    mine = {"MappingState": port.MappingState, "EkfState": tekf.EkfState,
            "FcSim": tsim.FcSim, "SimState": tsim.SimState,
            "BehaviorState": tbeh.BehaviorState}[name]
    want = tuple("gen" if f == "key" else f for f in cls._fields)
    assert mine._fields == want


@pytest.mark.parametrize("layout", ["mixed", "pickles_only", "empty",
                                    "missing"])
def test_latest_checkpoint_picks_the_jax_packages_file(tmp_path, layout):
    d = tmp_path / "ck"
    if layout != "missing":
        d.mkdir()
    names = {"mixed": ["step_1.pkl", "step_10.pkl", "step_5", "step_10",
                       "step_x.pkl", "other.pkl", "step_9.pkl"],
             "pickles_only": ["step_2.pkl", "step_12.pkl", "step_7.pkl"],
             "empty": [], "missing": []}[layout]
    for n in names:
        if n.endswith(".pkl"):
            (d / n).write_bytes(b"")
        else:
            (d / n).mkdir()
    assert tck.latest_checkpoint(str(d)) == jck.latest_checkpoint(str(d))


def _two_flights():
    logs = [synth_room_scanlog(n_frames=20, seed=s, noise_mm=4.0)
            for s in (3, 9)]
    arrs = [jm.scanlog_to_arrays(lg) for lg in logs]
    f = {k: np.stack([a[k] for a in arrs]) for k in arrs[0]}
    f["x_m"][1] = np.linspace(0.0, 30.0, 20, dtype=np.float32)   # recenters
    return f


def _halves(f, at: int = 10):
    return ({k: v[:, :at] for k, v in f.items()},
            {k: v[:, at:] for k, v in f.items()})


@pytest.mark.parametrize("kernel", ["xla", "residentx"])
def test_port_replay_resumed_from_a_jax_checkpoint(tmp_path, jax_pickles,
                                                   kernel):
    """JAX replays the first half and saves; the port restores it (as a
    field dict) and replays the second half: bit-equal to the JAX
    package's unbroken replay."""
    full = _two_flights()
    h1, h2 = _halves(full)
    jfull, _ = jm.replay_mapping_batched(full, JAX_UL, kernel="xla")
    jst1, _ = jm.replay_mapping_batched(h1, JAX_UL, kernel="xla")
    path = jck.save_checkpoint(str(tmp_path / "ck"), jst1, step=10)
    assert path.endswith("step_10.pkl")
    d = tck.restore_checkpoint(tck.latest_checkpoint(str(tmp_path / "ck")))
    assert isinstance(d, dict) and tuple(d) == jm.MappingState._fields
    st, _ = port.replay_mapping_batched(
        port.frames_to_torch(h2, "cpu"), port.UL_PROFILE, kernel=kernel,
        state0=port.mapping_state_from_numpy(d, "cpu"))
    for f in ("grid", "origin_x", "origin_y", "inited"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jfull, f)),
                                      err_msg=f)
    np.testing.assert_allclose(st.filt.numpy(), np.asarray(jfull.filt),
                               rtol=0, atol=1e-6)


def test_jax_replay_resumed_from_a_port_checkpoint(tmp_path):
    """The other way round: the JAX restore_checkpoint reads the port's
    mapping_state_to_numpy dict, and JAX resumes bit-equal."""
    full = _two_flights()
    h1, h2 = _halves(full)
    st1, _ = port.replay_mapping_batched(port.frames_to_torch(h1, "cpu"),
                                         port.UL_PROFILE, kernel="residentx")
    path = tck.save_checkpoint(str(tmp_path / "ck"),
                               port.mapping_state_to_numpy(st1), step=10)
    d = jck.restore_checkpoint(path)
    jst, _ = jm.replay_mapping_batched(h2, JAX_UL, kernel="xla",
                                       state0=jm.MappingState(**d))
    jfull, _ = jm.replay_mapping_batched(full, JAX_UL, kernel="xla")
    np.testing.assert_array_equal(np.asarray(jst.grid),
                                  np.asarray(jfull.grid))
    np.testing.assert_array_equal(np.asarray(jst.origin_x),
                                  np.asarray(jfull.origin_x))


def test_slam_tuple_checkpoints_cross_both_ways(tmp_path, jax_pickles):
    """The SLAM map checkpoint is the JAX CLI's plain tuple (grid,
    origin_x, origin_y) in both packages."""
    rng = np.random.default_rng(0)
    jt = (rng.integers(-127, 128, (2, 608, 640)).astype(np.int8),
          rng.normal(0, 3, 2).astype(np.float32),
          rng.normal(0, 3, 2).astype(np.float32))
    pj = jck.save_checkpoint(str(tmp_path / "j"), jt, step=40)
    got = tck.restore_checkpoint(pj)
    assert isinstance(got, tuple) and len(got) == 3
    for a, b in zip(got, jt):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    pt = tck.save_checkpoint(str(tmp_path / "t"), tuple(
        torch.from_numpy(v) for v in jt), step=40)
    back = jck.restore_checkpoint(pt)
    assert isinstance(back, tuple)
    for a, b in zip(back, jt):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_sim_state():
    """The JAX swarm's airborne start (random poses, armed, mapper inited)
    at t_ms 240 after 2 scans, as a mid-run checkpoint would hold it."""
    st = jsim.sim_init(2, jax.random.PRNGKey(7), spread_m=0.5,
                       airborne=True)
    return st._replace(t_ms=jax.numpy.int32(240),
                       scan_count=jax.numpy.int32(2))


def _flat(tree, prefix=""):
    """A nested NamedTuple or dict -> {"a.b": numpy array}."""
    items = tree._asdict().items() if hasattr(tree, "_asdict") else \
        tree.items()
    out = {}
    for k, v in items:
        if hasattr(v, "_asdict") or isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_restore_a_jax_sim_state_and_resume_it_in_the_port(
        tmp_path, jax_pickles, jax_sim_state):
    """A JAX SimState checkpoint becomes nested field dicts equal to the
    JAX state, leaf for leaf; the port resumes it on its own generator
    seeded by the caller (a jax.random key has no torch counterpart)."""
    path = jck.save_checkpoint(str(tmp_path / "ck"), jax_sim_state, step=12)
    d = tck.restore_checkpoint(path)
    assert isinstance(d["fc"], dict) and isinstance(d["beh"], dict)
    want = _flat(jax_sim_state)
    got = _flat(d)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    st = tsim.sim_state_from_numpy(d, "cpu", seed=5)
    assert st.t_ms == 240 and st.scan_count == 2
    assert torch.equal(st.gen.get_state(),
                       torch.Generator().manual_seed(5).get_state())
    world = tsim.make_world(2, room=(-3.5, -3.5, 3.5, 3.5), device="cpu")
    st, _ = tsim.sim_run(st, world, 10, port.UL_PROFILE, dt_ms=20)
    assert st.t_ms == 440 and st.scan_count == 4


def test_port_sim_resume_is_bit_equal_to_an_unbroken_run(tmp_path):
    """15 + save/restore + 15 ticks (6 scan ticks in all, each drawing on
    the generator the checkpoint carries) == 30 unbroken ticks, every
    field of the state and the generator's state."""
    world = tsim.make_world(2, room=(-3.5, -3.5, 3.5, 3.5),
                            obstacles=[(1.5, -0.5, 2.5, 0.5)], device="cpu")
    st0 = tsim.sim_init(2, 4, spread_m=0.5, airborne=True, device="cpu")
    full, _ = tsim.sim_run(st0, world, 30, port.UL_PROFILE, dt_ms=20)
    half, _ = tsim.sim_run(st0, world, 15, port.UL_PROFILE, dt_ms=20)
    path = tck.save_checkpoint(str(tmp_path / "ck"), {
        **tsim.sim_state_to_numpy(half), "gen": half.gen.get_state().numpy()},
        step=15)
    back = tsim.sim_state_from_numpy(tck.restore_checkpoint(path), "cpu",
                                     seed=99)
    resumed, _ = tsim.sim_run(back, world, 15, port.UL_PROFILE, dt_ms=20)
    assert resumed.scan_count == full.scan_count == 6
    a, b = _flat(tsim.sim_state_to_numpy(resumed)), _flat(
        tsim.sim_state_to_numpy(full))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert torch.equal(resumed.gen.get_state(), full.gen.get_state())
    assert jck.restore_checkpoint(path)["gen"].dtype == np.uint8


def test_the_unpickler_refuses_other_globals(tmp_path):
    """Only the JAX records and numpy's array reconstructors load; any
    other global (here os.system and a class) is refused, and an orbax
    directory is not read."""
    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    for obj in (Evil(), {"a": io.BytesIO(b"x")}):
        p = tmp_path / "step_1.pkl"
        p.write_bytes(pickle.dumps(obj))
        with pytest.raises(pickle.UnpicklingError, match="does not hold"):
            tck.restore_checkpoint(str(p))
    (tmp_path / "step_2").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        tck.restore_checkpoint(str(tmp_path / "step_2"))
    with pytest.raises(TypeError, match="mapping_state_to_numpy"):
        tck.save_checkpoint(str(tmp_path / "x"), port.mapping_init(1, device="cpu"))


@pytest.mark.parametrize("value", [np.int32(7), np.bool_(True),
                                   np.float32(2.5), np.arange(6).reshape(2, 3),
                                   np.zeros(0, np.float64)])
def test_numpy_scalars_and_arrays_round_trip(tmp_path, value):
    p = tck.save_checkpoint(str(tmp_path), {"v": value, "t": (1, 2.0)},
                            step=3)
    back = tck.restore_checkpoint(p)
    assert back["t"] == (1, 2.0)
    assert back["v"].dtype == np.asarray(value).dtype
    np.testing.assert_array_equal(back["v"], value)
