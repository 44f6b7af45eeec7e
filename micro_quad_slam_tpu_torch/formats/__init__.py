"""File formats of the PyTorch port: the scanlog, the hub's SCAN/CTRL
wire frames, the navlog CSV (and, as submodules, the dual-UART wirecap,
MAVLink and the ESP-NOW arm link), each the port's copy of the JAX
package's module; this package exports what the JAX one does."""

from micro_quad_slam_tpu_torch.formats.scanlog import (  # noqa: F401
    SCANREC_DTYPE,
    SCANREC_MAGIC,
    SCANLOG_FILE_HEADER,
    ScanLog,
    read_scanlog,
    write_scanlog,
)
from micro_quad_slam_tpu_torch.formats.scanframe import (  # noqa: F401
    SCAN_HEADER,
    CTRL_HEADER,
    SCAN_BYTES,
    CTRL_BYTES,
    xor8,
    encode_scan_frame,
    encode_ctrl_frame,
    decode_stream,
)
from micro_quad_slam_tpu_torch.formats.navlog import (  # noqa: F401
    NAVLOG_HEADER,
    NavlogWriter,
    read_navlog,
)
