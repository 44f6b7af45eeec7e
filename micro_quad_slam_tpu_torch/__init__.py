"""micro_quad_slam_tpu_torch: the PyTorch / CUDA port of micro_quad_slam_tpu.

The JAX package stays the reference; this package re-implements its parts
in PyTorch for one NVIDIA Hopper GPU, module by module under the same
names, and never imports jax.  Each TPU kernel of a ported path becomes a
hand-written CUDA kernel (csrc/), with the plain torch version beside it
as its CPU path and its twin in the on-card checks.

Ported so far: the batched mapping replay (replay/mapping.py) in its
bit-exact mode, with beam extraction and the ToF filter (ops/beams.py),
the exact scan update and recentering (ops/raycast.py) and the
whole-replay schedule and Hopper kernel (ops/residentx.py,
csrc/replay_exact.cu); and in its cone and hybrid production modes, with
the dense inverse sensor model (ops/conemode.py) and their schedule and
Hopper kernel (ops/conex.py, csrc/replay_cone.cu).

The port imports nothing of the JAX package, not even its modules that
do not import jax: it keeps its own copy of the configuration
(utils/config.py) and of the scanlog reader (formats/scanlog.py).
Entry points run on the CUDA device unless the caller passes "cpu".
"""

__version__ = "0.1.0"

from micro_quad_slam_tpu_torch.utils.config import (  # noqa: F401
    CL_PROFILE,
    MapConfig,
    PipelineConfig,
    TofConfig,
    UL_PROFILE,
    UL_RT_PROFILE,
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
