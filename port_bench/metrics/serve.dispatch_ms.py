"""serve.dispatch_ms: mean host time of a served dispatch (pad, copy, z-norm, forward, sigmoid)."""
from port_bench.readers import dispatch_ms as read  # noqa: F401
