"""Device ops of the port: ``pad`` (time_end_pad, pad_to_multiple),
``attention`` (the dispatcher, the flash kernels in
``csrc/flash_fwd.cu``/``flash_bwd.cu``, their plain versions and the op
``ecg_tpu_torch::flash_fwd``), ``adamw``, ``dropout``, ``augment``, and the
denoise chain: ``filter``, ``loess``, ``nlm``, ``nlm_fused`` (``csrc/nlm.cu``),
``resample``, ``preprocess``.  The package re-exports the padding functions,
as the JAX package does; it re-exports no function that has a module's name
(``attention``, ``nlm``), so every module stays importable as
``ops.<module>``."""
from .pad import pad_to_multiple, time_end_pad

__all__ = ['pad_to_multiple', 'time_end_pad']
