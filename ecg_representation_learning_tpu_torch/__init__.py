"""ecg_representation_learning_tpu_torch -- the PyTorch/CUDA port for NVIDIA Hopper.

A second package beside the JAX reference ``ecg_representation_learning_tpu``.
It imports torch, numpy and the standard library only -- nothing of JAX and
nothing of the JAX package -- and keeps its own copies of what it needs.  The
tests under ``tests/test_torch_*.py`` hold each module against its JAX
counterpart on the same numpy inputs.

Ported so far (the serving path):

- ``registry``  -- PTB-XL code tables and train-split normalization stats
- ``configs``   -- ``VitConfig`` (with the size ladder) and ``TrainConfig``
- ``runtime``   -- device selection (CUDA, or the CPU only when asked for)
- ``ops``       -- ``time_end_pad`` and attention with the flash forward kernel
                   (``ops/csrc/flash_fwd.cu``, built with nvcc at first use)
- ``models``    -- the 1-D ViT and the flax <-> torch weight mapping
- ``train``     -- the inference half of ``Trainer`` (predict, predict_long)
- ``serving``   -- micro-batching HTTP inference server
- ``cli``       -- ``serve``
"""

__version__ = '0.1.0'
