"""allreduce_ms.dp: the data-parallel step's gradient all-reduce, device ms a step, rank 0's marks."""
from port_bench.moe_readers import allreduce_ms as read  # noqa: F401
