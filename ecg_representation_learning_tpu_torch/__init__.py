"""ecg_representation_learning_tpu_torch -- the PyTorch/CUDA port for NVIDIA Hopper.

A second package beside the JAX reference ``ecg_representation_learning_tpu``.
It imports torch, numpy, scipy (host filter designs) and the standard library
-- nothing of JAX and nothing of the JAX package -- and keeps its own copies of
what it needs.  The
tests under ``tests/test_torch_*.py`` hold each module against its JAX
counterpart on the same numpy inputs.

Ported so far (serving, training, the denoise chain, pretraining, the disk
corpus, and raw-corpus ingest with streaming pretraining):

- ``registry``  -- PTB-XL code tables, the corpus table, train-split stats, Zheng
                   denoise constants
- ``configs``   -- ``VitConfig`` (with the size ladder), ``TrainConfig``,
                   ``PreprocessConfig``, ``MaeConfig``, ``ContrastiveConfig``
- ``runtime``   -- device selection (CUDA, or the CPU only when asked for)
- ``ops``       -- attention (flash forward/backward kernels), AdamW, dropout,
                   the DSP chain (filter, loess, nlm, resample, preprocess) and
                   the fused NLM kernel; sources in ``ops/csrc``, built with
                   nvcc at first use
- ``models``    -- the 1-D ViT, MAE and contrastive models, the flax <-> torch
                   weight mapping and the reference's vit-pytorch checkpoints,
                   weight-only int8
- ``train``     -- ``Trainer`` (train, evaluate, predict, int8 inference),
                   the pretrainers, optimizer, metrics, checkpoints
- ``data``      -- the combined HDF5 and label index (h5py when used), PTB-XL
                   splits, the synthetic corpora (host and device), the WFDB/CSV/
                   bulk readers and the native decoder (``data/csrc``, built with
                   the host compiler), the export jobs, the sharded and mixed
                   streams with device prefetch, the torch ``Dataset`` adapter
- ``serving``   -- micro-batching HTTP inference server
- ``utils``     -- logging, argument checks, ``tracing`` (spans and the train
                   step's phase marks, ``StepTimer``, ``device_trace``)
- ``tools``     -- ``nlm_sol_probe`` (the NLM kernel's cost attribution)
- ``cli``       -- ``synth``, ``train``, ``pretrain`` (and ``--stream``),
                   ``evaluate``, ``infer``, ``serve``, ``port``, ``denoise``,
                   ``export``, ``export-shards``
"""

__version__ = '0.1.0'
