"""adamw_roofline.eager: kernel #5 (norm + update) against its byte bound, in the eager
supervised cell."""
from port_bench.readers import adamw_roofline as read  # noqa: F401
