"""Host input paths of the port: the native scanlog and stream reader."""

from micro_quad_slam_tpu_torch.io.native import (  # noqa: F401
    decode_stream_native,
    native_available,
    read_scanlog_native,
)
