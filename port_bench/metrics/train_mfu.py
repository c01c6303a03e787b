"""train_mfu: the supervised step's matmul FLOPs over the window, a share of the
H100's bf16 peak."""
from port_bench.readers import mfu as read  # noqa: F401
