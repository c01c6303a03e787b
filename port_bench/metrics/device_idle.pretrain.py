"""device_idle.pretrain: share of the traced slice with no device op, MAE cell."""
from port_bench.readers import device_idle as read  # noqa: F401
