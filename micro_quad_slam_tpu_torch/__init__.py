"""micro_quad_slam_tpu_torch: the PyTorch / CUDA port of micro_quad_slam_tpu.

The JAX package stays the reference; this package re-implements its parts
in PyTorch for one NVIDIA Hopper GPU, module by module under the same
names, and never imports jax.  Each TPU kernel of a ported path becomes a
hand-written CUDA kernel (csrc/), with the plain torch version beside it
as its CPU path and its twin in the on-card checks.

Ported so far: the batched bit-exact mapping replay (replay/mapping.py),
with beam extraction and the ToF filter (ops/beams.py), the exact scan
update and recentering (ops/raycast.py), and the whole-replay schedule and
Hopper kernel (ops/residentx.py, csrc/replay_exact.cu).

Framework-free modules of the JAX package (utils.config, formats, golden,
sim) are imported from it, not copied.
"""

__version__ = "0.1.0"

from micro_quad_slam_tpu.utils.config import (  # noqa: F401
    CL_PROFILE,
    MapConfig,
    PipelineConfig,
    TofConfig,
    UL_PROFILE,
)
from micro_quad_slam_tpu_torch.ops.raycast import (  # noqa: F401
    DEFAULT_GEOM,
    GridGeom,
    logical_grid,
)
from micro_quad_slam_tpu_torch.parallel.mesh import batch_metrics  # noqa: F401
from micro_quad_slam_tpu_torch.replay.mapping import (  # noqa: F401
    MappingState,
    frames_to_torch,
    mapping_init,
    mapping_state_from_numpy,
    mapping_state_to_numpy,
    replay_mapping,
    replay_mapping_batched,
    scanlog_to_arrays,
)
