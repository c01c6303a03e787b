"""input_wait_share.pretrain: share of the MAE window spent waiting on the batch iterator."""
from port_bench.readers import input_wait_share as read  # noqa: F401
