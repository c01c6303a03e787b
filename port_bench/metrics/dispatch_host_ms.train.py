"""dispatch_host_ms.train: host ms a dispatch spends preparing its step tape (seed draw, step
scalars, tape fill), from the program's dispatch.prepare span."""
from port_bench.span_readers import dispatch_host_ms as read  # noqa: F401
