"""moe_route_ms.moe: routing, the permutation by expert and the combine, device ms a step, from the MoE layer's region marks."""
from port_bench.moe_readers import route_ms as read  # noqa: F401
