"""launch_calls_per_step.eager: host kernel and graph launch calls per eager supervised step."""
from port_bench.readers import launch_calls_per_step as read  # noqa: F401
