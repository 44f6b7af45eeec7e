from micro_quad_slam_tpu_torch.replay.mapping import (  # noqa: F401
    MappingState,
    frames_to_torch,
    mapping_init,
    mapping_state_from_numpy,
    mapping_state_to_numpy,
    mapping_step,
    replay_mapping,
    replay_mapping_batched,
    scanlog_to_arrays,
)
