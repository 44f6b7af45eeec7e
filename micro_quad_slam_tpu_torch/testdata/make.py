"""Write the port's committed test flights (testdata/*.npz) from the JAX
package's numpy-only flight simulator and golden C model:

    python -m micro_quad_slam_tpu_torch.testdata.make

No jax is imported.  tests/test_torch_testdata.py rebuilds every flight
with `build` and holds it bit-equal to the committed file.
"""

from __future__ import annotations

import sys

import numpy as np

from micro_quad_slam_tpu.golden import golden_replay_mapping
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu_torch.replay.mapping import scanlog_to_arrays
from micro_quad_slam_tpu_torch.testdata import NAMES, path


def _stack(logs) -> dict:
    arrs = [scanlog_to_arrays(lg) for lg in logs]
    return {k: np.stack([a[k] for a in arrs]) for k in arrs[0]}


class _FramesLog:
    """One flight of a frames dict, seen as a scanlog by the golden model."""

    def __init__(self, frames: dict, b: int):
        for k, v in frames.items():
            setattr(self, k, v[b])

    def __len__(self):
        return self.x_m.shape[0]


def _with_golden(frames: dict) -> dict:
    runs = [golden_replay_mapping(_FramesLog(frames, b))
            for b in range(frames["x_m"].shape[0])]
    return {**frames,
            "golden_grid": np.stack([m.grid for m, _ in runs]),
            "golden_used": np.stack([u for _, u in runs]),
            "golden_recentered": np.array([m.recentered for m, _ in runs]),
            "golden_origin_x": np.array([m.origin_x for m, _ in runs],
                                        np.float32)}


def random_flights(B: int = 8, T: int = 64) -> dict:
    logs = [synth_room_scanlog(n_frames=T, seed=s, noise_mm=5.0,
                               dropout_p=0.05, path=("circle", "hover")[s % 2])
            for s in range(B - 1)]
    logs.append(synth_room_scanlog(n_frames=T, seed=99, state=1))
    f = _stack(logs)
    f["x_m"][1] = np.linspace(0.0, 34.0, T, dtype=np.float32)
    f["y_m"][1] = np.linspace(0.0, -21.0, T, dtype=np.float32)
    return f


def golden_hover() -> dict:
    return _with_golden(_stack([synth_room_scanlog(
        n_frames=32, room=(-2.0, -2.0, 2.0, 2.0), path="hover",
        yaw_rate_dps=20.0, noise_mm=6.0, dropout_p=0.05, seed=11)]))


def golden_line_recenter() -> dict:
    return _with_golden(_stack([synth_room_scanlog(
        n_frames=40, room=(-3.0, -3.0, 40.0, 3.0), path="line",
        path_radius_m=18.0, seed=13, noise_mm=4.0)]))


def golden_short_beams() -> dict:
    B, T = 2, 3
    grid_mm = np.full((B, T, 4, 8, 8), 51, np.uint16)
    grid_mm[1] = 53
    return _with_golden({
        "grid_mm": grid_mm,
        "x_m": np.zeros((B, T), np.float32),
        "y_m": np.zeros((B, T), np.float32),
        "yaw_deg": np.full((B, T), 45.0, np.float32),
        "of_q": np.full((B, T), 200, np.int32),
        "of_rate_x": np.zeros((B, T), np.float32),
        "sys_health": np.zeros((B, T), np.int64),
        "state": np.full((B, T), 5, np.uint8)})


def bench_flight() -> dict:
    """bench.py:191-194's base flight."""
    return _stack([synth_room_scanlog(n_frames=256, seed=0, path="hover",
                                      yaw_rate_dps=20.0, noise_mm=5.0)])


def build(name: str) -> dict:
    if name not in NAMES:
        raise ValueError(f"unknown test flight {name!r}; one of {NAMES}")
    return globals()[name]()


def main() -> int:
    for name in NAMES:
        np.savez_compressed(path(name), **build(name))
        print(path(name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
