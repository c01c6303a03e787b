"""moe_gemm_roofline.moe: the held experts' grouped GEMMs against the bf16 peak, FLOPs from the held-row counter."""
from port_bench.moe_readers import gemm_roofline as read  # noqa: F401
