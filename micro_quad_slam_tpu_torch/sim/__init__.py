"""Synthetic flights of the port (the counterpart of micro_quad_slam_tpu/sim/)."""

from micro_quad_slam_tpu_torch.sim.synthio import (  # noqa: F401
    room_tof_distance, slam_bench_frames, synth_room_scanlog)
