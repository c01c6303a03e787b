"""moe_experts_ms.moe: the held experts' forward (grouped GEMMs, SwiGLU), device ms a step, from the MoE layer's region marks."""
from port_bench.moe_readers import experts_ms as read  # noqa: F401
