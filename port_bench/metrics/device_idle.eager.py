"""device_idle.eager: share of the traced slice with no device op, eager supervised cell."""
from port_bench.readers import device_idle as read  # noqa: F401
