"""micro_quad_slam_tpu_torch: the PyTorch / CUDA port of micro_quad_slam_tpu.

The JAX package stays the reference; this package re-implements its parts
in PyTorch for one NVIDIA Hopper GPU, module by module under the same
names, and never imports jax.  Each TPU kernel of a ported path becomes a
hand-written CUDA kernel (csrc/), with the plain torch version beside it
as its CPU path and its twin in the on-card checks.

Ported: the batched mapping replay (replay/mapping.py) in its
bit-exact mode, with beam extraction and the ToF filter (ops/beams.py),
the exact scan update and recentering (ops/raycast.py) and the
whole-replay schedule and Hopper kernel (ops/residentx.py,
csrc/replay_exact.cu); in its cone and hybrid production modes, with
the dense inverse sensor model (ops/conemode.py) and their schedule and
Hopper kernel (ops/conex.py, csrc/replay_cone.cu); the EKF fusion replay
(ops/ekf.py, replay/fusion.py); and the SLAM replay (slam/pipeline.py)
with its pose graph (slam/posegraph.py), scan matcher (ops/scanmatch.py)
and lattice kernel (ops/matchlattice.py, csrc/match_lattice.cu), and the
exact kernel's snapshot and scheduled-chunk entries (ops/residentx.py);
and the closed-loop swarm simulator (models/simulator.py) with the UL
behaviour machine (models/behavior.py), the frontier queries
(ops/raycast.py), the LK vision flow (ops/flow.py) and the exact
kernel's map-step entry (ops/residentx.py::map_step), which the mapping
replay's per-frame "pallas" and "pallas_db" names also take; the
live-topology path (formats/scanframe.py, wirecap.py, mavlink.py,
replay/telemetry.py, replay/livestream.py: raw dual-UART captures in),
checkpoints (utils/checkpoint.py), the navlog, PGM and MAVLink writers,
the synthetic flight generator (sim/synthio.py), the command line
(__main__.py) and the bench entry (bench.py); SLAM pass 1 with match
feedback (slam/pipeline.py), the batch split over several devices
(parallel/mesh.py, parallel/dryrun.py), the CL behaviour machine
(models/behavior_cl.py) and the native scanlog reader (io/native.py).
With these the port does all that the JAX package does.

The port imports nothing of the JAX package, not even its modules that
do not import jax: it keeps its own copy of the configuration
(utils/config.py), of the file formats (formats/) and of the flight
generator (sim/synthio.py).
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
