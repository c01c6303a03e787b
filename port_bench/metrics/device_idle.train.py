"""device_idle.train: share of the traced slice with no device op, graph-route supervised cell."""
from port_bench.readers import device_idle as read  # noqa: F401
