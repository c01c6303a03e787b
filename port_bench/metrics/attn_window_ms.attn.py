"""attn_window_ms.attn: the attention cores of the sliding-window layers (flash #2-#4 forward
from q, k, v to the output, before the gate), device ms a step summed over layers and
microbatches, from the 'attn.window' region marks."""
from port_bench.moe_readers import _region_ms


def read(r):
    return _region_ms('attn.window')
