"""launch_calls_per_step.pretrain: host kernel and graph launch calls per MAE step."""
from port_bench.readers import launch_calls_per_step as read  # noqa: F401
