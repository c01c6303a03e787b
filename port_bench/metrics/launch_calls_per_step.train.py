"""launch_calls_per_step.train: host kernel and graph launch calls per supervised step."""
from port_bench.readers import launch_calls_per_step as read  # noqa: F401
