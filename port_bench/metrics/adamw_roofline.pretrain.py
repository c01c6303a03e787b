"""adamw_roofline.pretrain: kernel #5 (norm + update) against its byte bound, in the MAE cell."""
from port_bench.readers import adamw_roofline as read  # noqa: F401
