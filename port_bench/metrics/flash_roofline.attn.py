"""flash_roofline.attn: the FLOPs attention's mathematics needs in the traced slice (visible
(query, key) pairs x D x 12, ``yardstick_attn``) over the device time of flash kernels #1-#4
there, a share (%) of the card's bf16 peak."""
from port_bench import yardstick_attn


def read(r):
    per = r.window.get('attn_flops_per_sample')
    samples = r.window.get('trace_samples')
    t = r.tr.kernel_s(*yardstick_attn.FLASH_KERNELS) if r.tr else 0.0
    if not per or not samples or not t:
        return None
    return 100.0 * per * samples / t / yardstick_attn.H100_BF16_FLOPS
