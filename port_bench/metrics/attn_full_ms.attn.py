"""attn_full_ms.attn: the attention cores of the full (global) layers, device ms a step summed
over layers and microbatches, from the 'attn.full' region marks."""
from port_bench.moe_readers import _region_ms


def read(r):
    return _region_ms('attn.full')
