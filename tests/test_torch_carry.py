"""PyTorch port, replay/mapping.py::carry on the CPU: the plain torch loop
(carry_plain) against a chain of per-frame mapping_step calls, no launch
of the carry kernel, and the kernel wrapper's operand checks, which raise
before anything is launched.  The kernel itself is held bit-equal to
carry_plain on the card by tests/test_torch_kernel.py."""

import numpy as np
import pytest
import torch

import micro_quad_slam_tpu_torch as port
from micro_quad_slam_tpu_torch import testdata
from micro_quad_slam_tpu_torch.replay import mapping as tm
from micro_quad_slam_tpu_torch.utils import obs
from micro_quad_slam_tpu_torch.utils.config import CL_PROFILE, UL_PROFILE

torch.set_num_threads(2)

EXACT = tm.MODES["exact"].library


def _flights():
    """The 8 committed random flights, 64 frames each; flight 1 recenters
    at frames 28 and 51, the last one never leaves the ground."""
    return port.frames_to_torch(testdata.load("random_flights")[0], "cpu")


@pytest.mark.parametrize("cfg", [UL_PROFILE, CL_PROFILE],
                         ids=["ul", "cl"])
def test_carry_on_the_cpu_equals_a_chain_of_mapping_steps(cfg):
    frames = _flights()
    B, T = frames["x_m"].shape
    _, so, outs, final = tm.carry(frames, cfg, library=EXACT)
    st = tm.mapping_init(B, device="cpu")
    for t in range(T):
        st, o = tm.mapping_step(st, {k: v[:, t] for k, v in frames.items()},
                                cfg)
        for name, got, want in (("ox", so["ox"][:, t], st.origin_x),
                                ("oy", so["oy"][:, t], st.origin_y),
                                ("used", outs["used"][:, t], o["used"]),
                                ("kf_flags", outs["kf_flags"][:, t],
                                 o["kf_flags"]),
                                ("filt", outs["filt"][:, t], o["filt"])):
            assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0)), \
                f"{name} at frame {t}"
    for got, want in zip(final, (st.origin_x, st.origin_y, st.inited,
                                 st.filt)):
        assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    if cfg is UL_PROFILE:
        assert outs["kf_flags"][1].nonzero().flatten().tolist() == [28, 51]
        assert outs["used"].any() and not outs["used"][-1].any()


def test_carry_on_the_cpu_launches_no_kernel():
    frames = _flights()
    before = obs.counters().get("launches.carry", 0)
    tm.carry(frames, UL_PROFILE, library=EXACT)
    port.replay_mapping_batched(frames, UL_PROFILE, kernel="residentx")
    assert obs.counters().get("launches.carry", 0) == before


def _quotient_operands(res: np.float32, n: int = 1 << 20):
    """Floats d for d / res: random bit patterns over every binade, and
    the numbers next to each k * res and (k + 1/2) * res, |k| <= 300,
    where the shift's rounding turns."""
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    d = bits.view(np.float32)
    k = np.arange(-600, 601, dtype=np.float32) * np.float32(0.5)
    near = k * res
    near = np.concatenate([near, np.nextafter(near, np.float32(np.inf)),
                           np.nextafter(near, np.float32(-np.inf))])
    d = np.concatenate([d, near, np.float32([0.0, -0.0, 1e-45, -1e-45,
                                             3.4e38, -3.4e38])])
    return d[np.isfinite(d)]


@pytest.mark.parametrize("res", [0.1, 0.05, 0.2, 0.25, 0.3])
def test_double_product_gives_the_float_quotient(res):
    """The carry kernel takes d / res as float(double(d) * (1 / res
    rounded to double)), csrc/carry.cuh::carry_shift; here the same
    arithmetic in numpy (IEEE double product, rounded to float) against
    the float32 division, bit for bit, and the shift it gives against
    recenter_decide's own (div_f32, _round_to_i32, the clamp)."""
    from micro_quad_slam_tpu_torch.ops.raycast import (_round_to_i32,
                                                       div_f32)
    r = np.float32(res)
    d = _quotient_operands(r)
    with np.errstate(over="ignore"):
        want = d / r
        got = (d.astype(np.float64) * (1.0 / float(r))).astype(np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    mx = np.float32(125)
    shift = np.where(np.isnan(got), 0,
                     np.clip(np.rint(got), -mx, mx)).astype(np.int32)
    ref = _round_to_i32(div_f32(torch.from_numpy(d), float(r))).clamp(
        -125, 125)
    assert np.array_equal(shift, ref.numpy())


def _operands(B=3, T=5):
    """Valid CPU operands of carry_kernel: (minima, seq, c0)."""
    frames = {k: v[:B, :T] for k, v in _flights().items()}
    return tm.carry_operands(frames, UL_PROFILE)[1:]


def _break(case, minima, seq, c0):
    c0 = list(c0)
    if case == "x_float64":
        seq["x_m"] = seq["x_m"].double()
    elif case == "state_int64":
        seq["state"] = seq["state"].long()
    elif case == "health_int16":
        seq["sys_health"] = seq["sys_health"].short()
    elif case == "inited_uint8":
        c0[2] = c0[2].to(torch.uint8)
    elif case == "minima_3_lanes":
        minima = minima[..., :3].contiguous()
    elif case == "yaw_short":
        seq["yaw_deg"] = seq["yaw_deg"][:, :-1].contiguous()
    elif case == "filt_flat":
        c0[3] = c0[3][:, 0].contiguous()
    elif case == "x_not_contiguous":
        seq["x_m"] = seq["x_m"].t().contiguous().t()
    elif case == "of_q_on_meta":
        seq["of_q"] = torch.empty_like(seq["of_q"], device="meta")
    return minima, seq, tuple(c0)


@pytest.mark.parametrize("case, error", [
    ("x_float64", TypeError), ("state_int64", TypeError),
    ("health_int16", TypeError), ("inited_uint8", TypeError),
    ("minima_3_lanes", ValueError), ("yaw_short", ValueError),
    ("filt_flat", ValueError), ("x_not_contiguous", ValueError),
    ("of_q_on_meta", ValueError), ("cpu", ValueError)])
def test_carry_kernel_refuses_operands_it_does_not_take(case, error):
    """Each raises before a library is built or loaded, so no nvcc is
    needed; valid operands on the CPU raise too: the kernel takes CUDA
    tensors only, and carry sends CPU tensors to carry_plain."""
    minima, seq, c0 = _break(case, *_operands())
    with pytest.raises(error, match="carry kernel"):
        tm.carry_kernel(EXACT, minima, seq, c0, UL_PROFILE)
