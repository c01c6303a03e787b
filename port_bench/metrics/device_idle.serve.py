"""device_idle.serve: share of the traced slice with no device op, serving cell."""
from port_bench.readers import device_idle as read  # noqa: F401
