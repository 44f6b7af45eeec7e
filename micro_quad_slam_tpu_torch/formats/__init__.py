"""File formats of the PyTorch port: the scanlog reader."""

from micro_quad_slam_tpu_torch.formats.scanlog import (  # noqa: F401
    ScanLog,
    read_scanlog,
)
