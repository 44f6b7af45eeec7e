"""SLAM back end of the port: SE(2) pose graph and the three-pass SLAM
replay (counterparts of micro_quad_slam_tpu/slam/)."""

from micro_quad_slam_tpu_torch.slam.pipeline import SlamResult, slam_replay  # noqa: F401
from micro_quad_slam_tpu_torch.slam.posegraph import (  # noqa: F401
    PoseGraph,
    add_edges,
    chain_odometry_graph,
    gauss_newton,
    se2_compose,
    se2_relative,
)
