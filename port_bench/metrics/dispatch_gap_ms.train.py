"""dispatch_gap_ms.train: the device's idle ms between back-to-back graph dispatches,
from the program's end event and the next dispatch's first phase mark."""
from port_bench.span_readers import dispatch_gap_ms as read  # noqa: F401
