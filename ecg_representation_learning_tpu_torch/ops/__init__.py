"""Device ops of the port: ``pad`` (time_end_pad), ``attention`` (the
dispatcher, the flash kernels in ``csrc/flash_fwd.cu``/``flash_bwd.cu`` and
their plain versions), ``adamw``, ``dropout``, ``augment``, and the denoise
chain: ``filter``, ``loess``, ``nlm``, ``nlm_fused`` (``csrc/nlm.cu``),
``resample``, ``preprocess``.  Import the modules; the package re-exports
nothing, so no module is shadowed by a function of its name."""
