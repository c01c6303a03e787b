"""ecg_representation_learning_tpu_torch -- the PyTorch/CUDA port for NVIDIA Hopper.

A second package beside the JAX reference ``ecg_representation_learning_tpu``.
It imports torch, numpy, scipy (host filter designs) and the standard library
-- nothing of JAX and nothing of the JAX package -- and keeps its own copies of
what it needs.  The
tests under ``tests/test_torch_*.py`` hold each module against its JAX
counterpart on the same numpy inputs.

Ported so far (serving, training and the denoise chain):

- ``registry``  -- PTB-XL code tables, train-split stats, Zheng denoise constants
- ``configs``   -- ``VitConfig`` (with the size ladder), ``TrainConfig``,
                   ``PreprocessConfig``
- ``runtime``   -- device selection (CUDA, or the CPU only when asked for)
- ``ops``       -- attention (flash forward/backward kernels), AdamW, dropout,
                   the DSP chain (filter, loess, nlm, resample, preprocess) and
                   the fused NLM kernel; sources in ``ops/csrc``, built with
                   nvcc at first use
- ``models``    -- the 1-D ViT and the flax <-> torch weight mapping
- ``train``     -- ``Trainer`` (train, evaluate, predict), optimizer, metrics
- ``data``      -- PTB-XL splits, the synthetic corpus, ``export_denoised``
- ``serving``   -- micro-batching HTTP inference server
- ``tools``     -- ``nlm_sol_probe`` (the NLM kernel's cost attribution)
- ``cli``       -- ``train``, ``evaluate``, ``serve``, ``denoise``
"""

__version__ = '0.1.0'
