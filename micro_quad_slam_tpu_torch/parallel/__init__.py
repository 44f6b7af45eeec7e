from micro_quad_slam_tpu_torch.parallel.mesh import batch_metrics  # noqa: F401
