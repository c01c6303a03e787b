"""moe_load_max.moe: the busiest held expert's rows over the held experts' mean, per MoE layer and step."""
from port_bench.moe_readers import load_max as read  # noqa: F401
