#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--phases kernels serving training pretrain denoise corpus stream
                                    scale artifacts parallel pipeline dispatch examples]
                          [--flash-other ROOT]

Builds every CUDA kernel of the port from ``ops/csrc`` with nvcc, one
process per source started together (into ``build/torch_kernels/``), then:

1. kernel phase, TF32 off: each kernel against its plain PyTorch version on
   the card, with its time beside the plain version's, a library call's
   (which the port never calls) and the least time the card could take --
   the flash forward (#1) and its lse variant (#2) against
   ``scaled_dot_product_attention``, the blocked backward dQ (#3) and dK/dV
   (#4) against SDPA's backward, at the serving shape, the pretraining
   shapes and longer sequences (ragged T and D, one row, exact tiles, rows
   of a size that takes the kernel's scalar-load branch), f32 and bf16,
   dropout 0 and 0.1,
   then #1-#4 with a band (causal, a left window) and grouped KV heads at the
   Trinity cell's attention and ViT-base's long records against their plain
   versions, their launches and device ms (``tools/flash_band_probe.py``;
   with ``--flash-other ROOT`` the default calls bit for bit against another
   checkout's kernels),
   and the dropout masks of #1 to #4 checked entry by entry against
   ``keep_full``, and each launch again with the seed read from device
   memory (``seed_dev``, as a step tape passes it) for the same bits; #3 and
   #4 also as one backward (with the delta reduction)
   beside SDPA's backward and the plain recompute, in device time; #5's
   FusedAdamW tail (``adamw.cu``: the norm launch with the clip and
   non-finite scalars and the counter, then the update) over every ViT-base
   leaf with f32 and bf16 mu and over the Switch-MoE ViT-base tree, three
   steps (no clip, clip engaged, non-finite): the norm within 1e-6 of
   ``global_norm`` and the same bits twice, the scalars and counter equal to
   the plain version's from the same norm, the update bit for bit; device ms,
   ms per call and host us per call beside
   ``torch.optim.AdamW(fused=True)``'s, the norm launch against its bound;
   the NLM kernel (#6)
   on the denoise chain's rows of 64 records at full and bounded search (in
   device time too, with the cluster size the kernel chose, and twice for
   the same bits), of 16 records, with QRS-sized spikes, on ragged rows with
   a zero row and on rows longer than the register branch stages and than
   shared memory holds, each against the plain version and against the
   plain version evaluated in f64; its five attribution variants (#7), then
   the probe
   ``tools/nlm_sol_probe.py`` of the port; the dropout site kernels
   (``dropout_sites.cu``, port-only) at the supervised cell's shapes, each way
   against the plain chain (``dropout_add`` bit for bit, ``gelu_dropout``
   within one ulp), their device ms beside the byte bound and the chain's;
   the MoE glue kernels (``moe_glue.cu``, port-only) at the
   ``moonlight_ep8_cls_k4`` cell's shapes, each of the six entries against
   its plain version (the permute, the SwiGLU and the combine's row
   gradients equal, the sums within their f32 bounds), its device ms beside
   its byte bound and the plain version's; then the launches on the main
   path: two eager ``Trainer.train_step``s of the deepseek block at the
   preset's size and the cell's batch (512 records in two microbatches),
   one launch of each entry each way per MoE layer and microbatch;
2. serving phase: ViT-base (f32, 12 layers of attention at 41 tokens, all
   through the kernel: ``flash_min_seq=0``) behind ``serving.serve`` answers
   16 concurrent HTTP requests; every client's rows must equal
   ``predict_long`` of its own input and a forward through plain attention,
   and the kernel's launch count must show the requests went through it;
   then the bs-64 predict throughput with the kernel and with plain
   attention, a profile of that predict, and the check once more with bf16
   Linear layers;
3. training phase: ViT-base with ``flash_min_seq=0`` and a blocked-backward
   threshold of 0, so every step runs 12 lse forwards, 12 dQ, 12 dK/dV and
   #5's two launches (norm, update): three f32 steps against a plain twin
   (plain attention, the plain AdamW tail) from one init, then
   ``Trainer.train()`` in bf16 with dropout 0.1 and TimeOut over 2 epochs of
   the hard synthetic corpus (each step 12 ``gelu_dropout`` and 24
   ``dropout_add`` launches each way), with its train samples/s, eval macro-AUROC,
   #5's block-table rebuilds, a profile of one step and one of its update
   tail alone (at most 2 launches and 1 copy);
4. pretrain phase: the same for self-supervised pretraining, MAE (default
   ``MaeConfig``: each step 14 lse forwards, dQ and dK/dV -- 12 encoder
   layers at 10 visible tokens, 2 decoder layers at 40 tokens over 4 heads
   -- and #5's two launches) then contrastive (12 layers at 2B = 128 rows):
   three f32 steps of each against a plain twin fed the same mask noise or views,
   ``train()`` in bf16 with dropout 0.1 for one epoch with eval, a profile of
   one step, then the handoff: ``load_any_encoder`` of the final checkpoint
   into a fresh ViT-base (the trunk's bits checked) and one epoch of the
   linear probe (the trunk's bits unchanged, the head moved);
5. denoise phase: ``export_denoised``'s per-chunk body (``denoise_chunk``)
   on synthetic 12 x 2500 records at 250 Hz: two chunks of 64 at full search
   (the CLI default) and one at search 128, one NLM launch each; records/s,
   the device time of each chain step and a profile; the output against a
   twin whose NLM step is the plain version and against the chain on the
   CPU; an all-zero lead comes out all zeros;
6. corpus phase (the disk-corpus slice's array paths; the card's machine has
   no h5py): ``synth_ptbxl_device`` at PTB-XL scale (21,837 x 12 x 2500) on
   the card, twice for the same bits, its std against the host generator's;
   the official splits gathered on the card, then 20 ViT-base bf16 steps
   with the train split resident in f32, f16 and bf16 (f16's eval loss
   within 2e-2 of f32's); a seeded reference-layout ViT-base written as a
   vit-pytorch 0.33.2 ``.pt`` and read back through ``--port-checkpoint``'s
   loader bit for bit; int8 inference (compression, bs-64 predict against a
   plain twin with the same int8 weights and against f32); ``cli infer``'s
   body on 20 s records, against the plain twin;
7. stream phase (raw-corpus ingest and streaming pretraining): a synthetic
   PTB-XL-shaped WFDB fmt-16 tree of 256 records (12 x 5000 at 500 Hz) read
   through ``_batch_reader`` by the native library (built from
   ``data/csrc`` with the host compiler) and by the numpy path, bit-equal,
   records/s of each; ``export_combined``'s body (FFT resample 500 -> 250 Hz)
   on the card against the CPU; the stream step's wire decode and fused
   preprocess alone on a bs-64 batch of each corpus (records/s);
   ``MixedRecordStream`` over the tree and a CODE-TEST-shaped bulk
   (400 Hz x 4096) as in-memory int16 shards ->
   ``prefetch_to_device`` (pinned host batches, a side stream) ->
   ``MaeTrainer.train_stream`` at ViT-base, bs 64, 30 steps in f32 and in
   bf16 (steps/s, samples/s, the input fraction, H2D bytes per step, a
   profiled step, launches of #2-#5 per step, the mixture's counts against
   a numpy replay); 6 steps with a checkpoint every 3 against 3 steps and a
   resume to 6, bit for bit; 4 contrastive stream steps (2B = 128 rows);
8. scale phase (the one-card model options): ViT-base with Switch-MoE blocks (4 experts on
   every second block, capacity factor 1.25: 820 slots per expert at bs 64), three f32
   steps against a plain twin, samples/s in f32 and bf16, the aux loss and the share of
   tokens past capacity, a profiled bf16 step; one bf16 MAE and one contrastive step on the
   MoE trunk; the ViT-base forward with ``scan_blocks`` on stacked copies of an unrolled
   model's weights against the unrolled logits; ViT-large f32 training with dropout, three
   steps with and without ``remat`` from one init (parameters, peak device memory,
   samples/s); the step loop's stall in a sync and an async save of the full ViT-base
   state, each restored bit for bit;
9. artifacts phase (the one-card tools): ``export_model`` of a seeded ViT-base
   (``flash_min_seq=0``) on the card at the 10 s wire length, loaded back
   through ``ExportedModel.load``: one ``ecg_tpu_torch::flash_fwd`` node per
   layer and 12 launches of #1 per exported bs-64 forward; the f32
   probabilities against ``Trainer.predict``, a plain-attention twin, the
   program moved to the CPU and a program traced on the CPU and moved to the
   card; bf16 and int8 artifacts (int8 bytes against f32's); the artifact's
   batch-1 ms and bs-64 samples/s beside ``Trainer.predict``'s; the op
   against the direct binding at the serving shape; the served model's
   ``return_attention`` maps and their rollout, card vs CPU;
   ``EcgTokenizer.fit`` at PTB-XL scale (21,837 x 12 x 2500, k 8, 'shift':
   82,019,772 segments; 256 clusters, 16 iterations) twice for the same bits,
   ``nearest_centroid`` over every segment, card vs CPU ids on a 1M-segment
   sample (only near-ties may differ) and the encode/decode round trip;
10. parallel phase (the ('data', 'model') mesh, ``parallel/``): (a) a one-rank NCCL group
   on cuda:0 (a ``FileStore`` in a temp dir), ViT-base f32 with hashed dropout 0.1 and
   TimeOut at bs 64: the one-card ``Trainer`` against ``mesh 1 x 1`` with DDP, with FSDP2 and
   with the Megatron plan on a model axis of 1, three steps each (losses and parameters equal,
   ||a - b|| / ||b|| <= 1e-6), their launches (12/12/12/1/1 of #2/#3/#4/#5 update/#5 norm a
   step, #1 in the mesh evaluation); one Switch-MoE step with expert parallelism, one MAE step
   with ``grad_accum=2`` and an EMA under FSDP, one contrastive step (2B = 128), each against
   its one-card step; bf16 samples/s and peak memory of each wrapper beside the one-card
   step's (at one rank: the wrappers' cost, not scaling); the norm's all-reduce in device ms;
   (b) two gloo ranks sharing the card with DDP, 32 of each 64 rows, three steps within 2e-5
   of the one-card steps: the kernels' masks with a non-zero ``bh_offset``; (c)
   ``parallel_int8``: ViT-base f32 served in int8 by ``enable_int8_inference`` on the two
   ranks as DP 2, TP 2 and FSDP 2 (replicated: one unsharded int8 model per rank), bs-64
   ``predict`` and ``evaluate`` on 128 records against the one-card int8 ``Trainer`` within
   ``SERVING_TOL``, 12 launches of #1 per forward per rank, the int8 bytes a rank holds and
   bs-64 int8 samples/s beside one card's;
11. pipeline phase (ring context parallelism and GPipe, f32, TF32 off): ``ring_attention``
   at world 1 (one NCCL rank) and on two gloo ranks sharing the card (1,024 + 1,024 tokens)
   against plain attention on (2, 12, 2048, 64), forward and dQ/dK/dV within 1e-5
   (||a - b|| / ||b||); ``RingPretrainer`` at ViT-base widths on 2,048-token records
   (131,072 samples), bs 2, the clip engaged, three steps on the two ranks against
   ``EcgMim`` on one card (the flash kernels) on the same masks, losses, the first step's
   summed gradients (their scale, which Adam and the clip hide) and parameters within 1e-5,
   #5 once a step, with tokens/s, peak memory and the ppermute share; the GPipe ViT-base (``scan_blocks``, 2
   stages x 6 layers, 4 microbatches of bs 64 at 41 tokens, the clip engaged) three steps
   against the one-card ``Trainer`` within 1e-5 with 30/30/30/1/1 launches of #2/#3/#4/#5
   update/#5 norm per rank and step, hashed dropout 0.1 twice for the same bits, the merged
   parameters through ``Trainer.predict`` (#1) against a plain twin, and bf16 samples/s and
   peak memory per rank (ranks sharing one card: a price, not scaling);
12. dispatch phase (``steps_per_dispatch`` and ``epoch_scan`` as CUDA graphs,
   ``train/dispatch.py``): ViT-base bf16 at bs 64 (every layer through #2-#4),
   flax dropout 0.1, TimeOut and an EMA, 2 epochs of 9 steps from one init: the
   per-step loop, K = 4 (two graph dispatches and a leftover step an epoch),
   epoch_scan (one cursor step replayed 9 times) and K = 4 with the optax chain
   against its own per-step loop -- params, EMA, moments, generator states and
   counts bit-equal (rtol 5e-4 only if cuBLAS picks other kernels under capture,
   which the row then names), each graph holding K steps' launches of every
   kernel (#2-#5, and #8's 12 ``gelu_dropout`` and 24 ``dropout_add`` each way)
   and the run's counters every step's; 2 layers of Switch-MoE with remat and
   grad_accum 2, flax and hashed dropout, bit-equal too; samples/s, profiles
   (wall, device ms, busy share, the host's launch calls per step), capture
   seconds and the memory each graph's pool reserved;
13. examples phase (``examples/torch/``, as a user runs them): the quickstart's stages
   on the card ('tiny', 256 synthetic records, 2 epochs, ``flash_min_seq=0`` so every
   layer runs #1-#5; MAE pretraining and the encoder transfer; the tokenizer) up to the
   rollout arrays, which a CPU rerun matches within 1e-5 (the figure needs matplotlib,
   which the CPU test draws); the serving demo with 16 clients in f32 and with int8, every
   client's row equal to ``predict`` of its own record and, at ``SERVING_TOL``, to a
   twin's with plain attention on the same weights; each stage's wall seconds and
   launches.  The kernel phase holds #1-#4 to their plain versions at both examples'
   shapes (``EXAMPLE_SHAPES``).

The kernel phase's dropout-mask checks run at ``bh_offset`` 0 and at a rank's offset.
Every phase raises on a failed check.  Prints one JSON object per line; the
line before the last lists the kernels, the last is the result (printed only
when every phase ran).  Exits non-zero, printing no result, when no GPU is
visible.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from ecg_representation_learning_tpu_torch.configs import (ContrastiveConfig, MaeConfig,
                                                           PreprocessConfig, TrainConfig,
                                                           VitConfig)
from ecg_representation_learning_tpu_torch import cli as ecg_cli
from ecg_representation_learning_tpu_torch.data import (get_ptbxl_splits, synth_ecg,
                                                        synth_ptbxl, synth_ptbxl_device)
from ecg_representation_learning_tpu_torch.data import export as data_export
from ecg_representation_learning_tpu_torch.data import native
from ecg_representation_learning_tpu_torch.data.export import denoise_chunk
from ecg_representation_learning_tpu_torch.data.pipeline import (MixedRecordStream,
                                                                 ShardedRecordStream,
                                                                 prefetch_to_device)
from ecg_representation_learning_tpu_torch.models.export_artifact import (ExportedModel,
                                                                          export_model)
from ecg_representation_learning_tpu_torch.models.moe import (MoeMlp, deepseek_layers,
                                                              moe_layer, sort_pairs)
from ecg_representation_learning_tpu_torch.models.moe import capacity as moe_capacity
from ecg_representation_learning_tpu_torch.models.port import (
    export_vit_pytorch_state_dict, reference_vit_config)
from ecg_representation_learning_tpu_torch.models.tokenizer import (EcgTokenizer,
                                                                    nearest_centroid)
from ecg_representation_learning_tpu_torch.models.vit import (Dense, EcgVit,
                                                             stack_unrolled_state_dict)
from ecg_representation_learning_tpu_torch.ops import _build, adamw, dropout, moe_glue, nlm_fused
from ecg_representation_learning_tpu_torch.ops import attention as attn
from ecg_representation_learning_tpu_torch.ops.filter import butterworth_low_pass
from ecg_representation_learning_tpu_torch.ops.loess import rloess
from ecg_representation_learning_tpu_torch.ops.pad import pad_to_multiple
from ecg_representation_learning_tpu_torch.ops.preprocess import (fused_train_path,
                                                                  zheng_denoise, zheng_detrend)
from ecg_representation_learning_tpu_torch.registry import PTBXL_TRAIN_STATS
from ecg_representation_learning_tpu_torch.serving import serve
from ecg_representation_learning_tpu_torch.tools import adamw_probe
from ecg_representation_learning_tpu_torch.tools import nlm_sol_probe as probe
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer, checkpoint
from ecg_representation_learning_tpu_torch.train.dispatch import Dispatcher
from ecg_representation_learning_tpu_torch.train.contrastive import (ContrastiveTrainer,
                                                                     load_any_encoder)
from ecg_representation_learning_tpu_torch.train.checkpoint import wait_for_checkpoints
from ecg_representation_learning_tpu_torch.train.pretrain import MaeTrainer
from ecg_representation_learning_tpu_torch.train.trainer import (RESIDENT_DTYPES, _prep_batch,
                                                                 flax_init_)
from ecg_representation_learning_tpu_torch.utils.rollout import attention_rollout

# H100 SXM data sheet: HBM rate, and the dense peak for each input type
# (f32 on the CUDA cores, bf16 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# kernel vs plain version, max abs error: f32 differs only in summation
# order; bf16 also in where p is rounded (before vs after normalization)
LIMITS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SERVING_SHAPE = (64, 12, 41, 64)     # ViT-base at bs 64: B, H, T = 40 patches + cls, D
# the pretraining path at bs 64 (default MaeConfig and ContrastiveConfig):
# the MAE encoder sees round(40 * 0.25) = 10 visible tokens, its decoder 40
# tokens over 4 heads of hidden 256, the contrastive trunk 2B = 128 rows
PRETRAIN_SHAPES = {'mae_encoder': (64, 12, 10, 64), 'mae_decoder': (64, 4, 40, 64),
                   'contrastive_trunk': (128, 12, 41, 64)}
# the examples phase: the quickstart's 'tiny' at its training batch of 32
# and the serving demo's 'debug' at 320 samples (6 tokens, head dim 16: f32
# rows of 64 bytes, the cp.async branch that zero-fills the columns past D),
# padded to its eval batch of 32; both f32
EXAMPLE_SHAPES = {'quickstart_tiny': (32, 4, 41, 64), 'serving_demo_debug': (32, 4, 6, 16)}
# the serving shape, long sequences, ragged T with D = 80 and 128 (the
# kernels' 128-column tiles), one row, exact tiles, about a bs-64 batch's
# tokens at T = 256, rows of 40 and 132 bytes (the scalar-load branch), the
# pretraining shapes (T = 10 fills a sixth of a 64-row tile) and the
# examples' shapes
KERNEL_CASES = [(SERVING_SHAPE, torch.float32), (SERVING_SHAPE, torch.bfloat16),
                ((2, 12, 1024, 64), torch.bfloat16), ((1, 4, 2049, 64), torch.float32),
                ((3, 5, 200, 80), torch.bfloat16), ((2, 4, 130, 128), torch.float32),
                ((1, 1, 1, 64), torch.float32), ((8, 12, 128, 64), torch.bfloat16),
                ((10, 12, 256, 64), torch.bfloat16), ((2, 3, 100, 20), torch.bfloat16),
                ((2, 3, 77, 33), torch.float32)] + [
                    (shape, dtype) for shape in PRETRAIN_SHAPES.values()
                    for dtype in (torch.float32, torch.bfloat16)] + [
                    (shape, torch.float32) for shape in EXAMPLE_SHAPES.values()]
# the dropout mask check: sequence lengths, (B, H), rate
MASK_TS, MASK_BH, MASK_RATE = (41, 256), (2, 6), 0.1
MASK_BH_OFFSETS = (0, 3 * 2 * 6)      # and the bh_offset of rank 3 with 2 rows of 6 heads
# backward kernels vs plain version, max abs error over max(1, max |plain|):
# f32 sums in another order (the CPU tests hold the plain version to JAX at
# 2e-5 the same way); bf16 rounds ds and the outputs to 8 significant bits
BWD_LIMITS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_LIMIT = 1e-5                     # row log-sum-exp, f32 in both dtypes
ADAMW_LIMIT = 0.0                    # the kernel repeats the plain version's
                                     # IEEE operations in order: bit for bit
# #5's three steps (clip_norm, finite gradients): no clip, the clip engaged
# (||g|| ~ 9e3 at ViT-base), a NaN gradient; the norm launch against
# global_norm, relative: the kernel sums squares in f64, the plain version in
# f32 per leaf (tests/test_torch_optim.py's bar against optax)
ADAMW_STEPS = [(None, True), (1.0, True), (1.0, False)]
NORM_RTOL = 1e-6
SERVING_TOL = 1e-4                   # probabilities, kernel vs plain attention, f32
BF16_TOL = 2e-2                      # the same in bf16: 8 significant bits
N_CLIENTS = 16
PARITY_STEPS = 3
LOSS_RTOL = 1e-4                     # per-step loss, kernels vs plain twin, f32
# parameters after PARITY_STEPS steps, kernels vs plain twin: an Adam step
# moves a weight by lr * (|mu_hat| / sqrt(nu_hat) + wd * |p|), about lr, so a
# gradient element at rounding level whose sign differs between the twins
# can end 2 * lr apart per step; every other element agrees to ~1e-6
PARAM_TOL = 2 * PARITY_STEPS * 3e-4 * 1.1
TRAIN_N = 832                        # hard corpus: 644 train rows, 10 steps/epoch at bs 64
# NLM kernel vs plain version, max abs error over max |x|: the JAX package's
# bar between its kernel and the scan form (tests/test_nlm_pallas.py:22);
# the box sums and accumulations are taken in another order
NLM_LIMIT = 2e-6
# operations per weight the NLM needs, from the TPU kernel's body for one
# (row, position, s): SSD 3 (sub, square, mask), box sum 6 (a log tree of
# adds), scale 2, exp 1, masks 3, accumulations 2 x 3 (+s and -s terms)
NLM_OPS = 21
DENOISE_CHUNK = 64                   # export_denoised's --batch default: 768 rows
DENOISE_FQS, DENOISE_LEN = 250, 2500  # the combined export's grid: 10 s records
# kernel #6's other cases (rows, L, search, pw): ragged rows with an all-zero
# row (pw 7: the generic branch), rows longer than the register branch's
# 4096 positions, which the generic branch cuts into segments
NLM_RAGGED = (77, 1999, 64, 7)
NLM_LONG = (24, 9000, 5000, 10)
NLM_LONGER = (2, 70000, 64, 10)       # a row longer than shared memory holds
DEV = 'cuda'
# chain on the card vs on the CPU, over max |x|: the LOESS solve and the
# noise estimate's medians see f32 sums in another order on each device
DENOISE_CPU_LIMIT = 1e-4
# the corpus phase: the device corpus at PTB-XL scale; its std against the
# host generator's at n = 512 (tests/test_synth_device.py:27); bf16 steps
# per storage dtype and the eval rows behind the f16 gate
# (tests/test_train.py:425); the int8 gate against f32
# (tests/test_quantize.py:57); the 20 s records `cli infer` scores
CORPUS_N, CORPUS_STD_N, CORPUS_STD_RTOL = 21837, 512, 0.3
RESIDENT_STEPS, RESIDENT_EVAL_N, RESIDENT_RTOL = 20, 512, 2e-2
INT8_TOL = 0.05
INFER_N = 64
# the stream phase: a PTB-XL-shaped WFDB fmt-16 tree (tests/test_raw_tree_
# integration.py's layout, gain 200) and a CODE-TEST-shaped bulk, as int16
# shards at their native rates; the mixture's weights and seed; ViT-base
# steps of the MAE stream in f32 and bf16, the resume check, and the
# contrastive stream steps; the export's resample tolerance (over max |x|,
# tests/test_torch_denoise_ops.py::test_resample_to_matches_jax)
STREAM_TREE = (256, 5000, 500)        # records, samples, Hz
STREAM_BULK = (256, 4096, 400)
STREAM_WIRE_SCALE, STREAM_GAIN = 1000.0, 200.0
STREAM_WEIGHTS, STREAM_SEED = (0.5, 0.5), 77
STREAM_BS, STREAM_STEPS, RESUME_STEPS, RESUME_EVERY, CON_STREAM_STEPS = 64, 30, 6, 3, 4
EXPORT_LIMIT = 1e-5
# the scale phase: ViT-base with 4 experts on every second block at the JAX
# defaults (cf 1.25: ceil(1.25 * 64 * 41 / 4) = 820 slots per expert at bs
# 64); the scanned forward against the unrolled one, f32, over the largest
# logit (the same operations on slices of a stack)
SCALE_MOE = dict(moe_num_experts=4, moe_every=2, moe_capacity_factor=1.25)
SCAN_RTOL = 1e-5
# the artifacts phase: ViT-base exported at the 10 s wire length (2500
# samples, which the program pads to the 2560 input); the artifact against
# Trainer.predict (f32: the same operations, so the bits or 1e-6), against the
# plain twin and across devices (SERVING_TOL); the int8 artifact's bytes
# against f32's (the JAX case's 0.55, tests/test_export_artifact.py:107) and
# its distance from f32 (INT8_TOL); the tokenizer at PTB-XL scale at the CLI
# defaults (k 8, 'shift', 256 clusters) but 16 of the 64 Lloyd iterations: a
# 64-iteration fit took 29.4 s on an H100 80GB HBM3 at 700 W, and the phase
# fits twice; card vs CPU ids on a 1M-segment sample, where only near-ties
# (two distances within TIE_RTOL in f64) may differ; return_attention maps and
# their rollout, card vs CPU
ARTIFACT_LEN, EXPORT_F32_TOL, INT8_BYTES_RATIO = 2500, 1e-6, 0.55
TOKENIZE_N, TOKENIZE_K, TOKENIZE_CLUSTERS, TOKENIZE_ITERS = 21837, 8, 256, 16
TIE_SAMPLE, TIE_RTOL, ROLLOUT_TOL = 1 << 20, 1e-5, 1e-5
ARTIFACT_DIR = 'runs/chip_smoke_artifacts'
# (name in the kernels line, source under ops/csrc, the TPU kernel it replaces)
KERNELS = [
    ('flash_fwd', 'flash_fwd', 'ecg_representation_learning_tpu/ops/attention.py:87'),
    ('flash_fwd_lse', 'flash_fwd', 'ecg_representation_learning_tpu/ops/attention.py:142'),
    ('flash_bwd_dq', 'flash_bwd', 'ecg_representation_learning_tpu/ops/attention.py:235'),
    ('flash_bwd_dkv', 'flash_bwd', 'ecg_representation_learning_tpu/ops/attention.py:277'),
    ('adamw', 'adamw', 'ecg_representation_learning_tpu/ops/adamw_pallas.py:41'),
    ('adamw_norm', 'adamw', 'ecg_representation_learning_tpu/ops/adamw_pallas.py:41'),
    ('nlm_rows', 'nlm', 'ecg_representation_learning_tpu/ops/nlm_pallas.py:48'),
    ('nlm_variant', 'nlm', 'tools/nlm_sol_probe.py:36'),
    ('gelu_dropout', 'dropout_sites', 'none: port-only, XLA fuses the chain in JAX'),
    ('dropout_add', 'dropout_sites', 'none: port-only, XLA fuses the chain in JAX'),
    ('moe_glue', 'moe_glue', 'none: port-only, the JAX package has no dropless MoE layer'),
]
# the dropout sites of a ViT-base block in the supervised cell (bs 64, 41
# tokens, bf16, dropout 0.1): the MLP hidden, and the attention and MLP outputs
SITE_RATE = 0.1
SITE_SHAPES = {'gelu_dropout': (64, 41, 3072), 'dropout_add': (64, 41, 768)}
# the MoE glue at the moonlight_ep8_cls_k4 cell's shapes: a microbatch of 256
# records of 41 tokens, d 2,048, top 6 of 64 experts with experts 0-7 held,
# SwiGLU 1,408 wide, bf16 rows; a held expert drawn with weight 0.76 against
# the others' 1, which holds ~10 % of the pairs, as the cell's router does
# over its measured window (the bias update evens the load); sums held within
# 2**-22 of their terms' magnitudes, the gates' dot products within 1e-5
# (tests/test_torch_moe_glue_card.py)
GLUE = dict(tokens=256 * 41, d=2048, f=1408, experts=64, k=6, held=8, held_weight=0.76)
GLUE_SETS = 4   # input sets a timing cycles through: each call moves >= 30 MB
GLUE_SUM_ULPS, GLUE_DOT_RTOL = 2.0 ** -22, 1e-5
GLUE_STEPS, GLUE_BATCH, GLUE_ACCUM = 2, 512, 2   # the main path's count: the cell's step


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events; inputs stay in L2 when they fit)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# cycles of the spin kernel that device_ms queues calls behind: ~50 ms at
# the H100's 1.98 GHz boost clock, longer than queueing 50 calls of any
# version timed here
SPIN_CYCLES = 100_000_000


def device_ms(fn, reps: int = 50, warmup: int = 5):
    """Device time of ``fn`` per call with the host's launch rate out of the
    way: the calls are queued behind a spin kernel, so the device runs them
    back to back (CUDA events).  None if queueing them outlasted the spin."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    events[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    events[2].record()
    events[2].synchronize()
    if queued_ms >= events[0].elapsed_time(events[1]):
        return None
    return events[1].elapsed_time(events[2]) / reps


def time_calls(row, calls) -> None:
    """``row[f'{name}_ms']`` (per call, back to back) and
    ``row[f'{name}_device_ms']`` for each of ``calls`` {name: fn}; the plain
    version gets 20 reps, the rest 50."""
    for name, fn in calls.items():
        reps = 20 if name == 'plain' else 50
        row[f'{name}_ms'] = time_ms(fn, reps=reps)
        row[f'{name}_device_ms'] = device_ms(fn, reps=reps)


def bound(n_bytes, n_ops, dtype):
    """Least time for ``n_bytes`` moved at the HBM rate and ``n_ops`` at the
    peak rate for ``dtype``: (ms, 'bytes' | 'operations')."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')


def flash_bound(shape, dtype, lse=False):
    """Least time for one flash forward: q, k, v read once and o (and with
    ``lse`` the f32 row lse) written once, against 4*B*H*T^2*D operations
    (two products)."""
    b, h, t, d = shape
    elem = torch.finfo(dtype).bits // 8
    return bound(4 * b * h * t * d * elem + (4 * b * h * t if lse else 0),
                 4 * b * h * t * t * d, dtype)


def flash_bwd_bound(shape, dtype, kernel):
    """Least time for a backward kernel: q, k, v, dO read once with the f32
    lse and delta, and dQ (``'dq'``: 6*B*H*T^2*D operations) or dK and dV
    (``'dkv'``: 8*B*H*T^2*D) written once."""
    b, h, t, d = shape
    elem = torch.finfo(dtype).bits // 8
    n_out, ops = (1, 6) if kernel == 'dq' else (2, 8)
    return bound((4 + n_out) * b * h * t * d * elem + 2 * 4 * b * h * t,
                 ops * b * h * t * t * d, dtype)


def kernel_phase():
    """Kernel against its plain version at every case; returns the serving
    shape's f32 row."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows, failures = [], []
    for shape, dtype in KERNEL_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device='cuda').to(dtype)
                   for _ in range(3))
        for rate, seed in ((0.0, 0), (0.1, 1234)):
            got = attn.flash_attention_forward(q, k, v, seed=seed, dropout_rate=rate)
            torch.cuda.synchronize()
            want = attn.flash_attention_forward_reference(q, k, v, seed=seed,
                                                          dropout_rate=rate)
            err = (got.float() - want.float()).abs().max().item()
            bound_ms, bound_by = flash_bound(shape, dtype)
            row = {'phase': 'kernel', 'shape': list(shape), 'dtype': str(dtype),
                   'dropout_rate': rate, 'max_abs_err': err,
                   'limit': LIMITS[dtype], 'finite': bool(torch.isfinite(got).all()),
                   'bound_ms': bound_ms, 'bound_by': bound_by}
            if rate == 0.0:
                time_calls(row, {
                    'kernel': lambda: attn.flash_attention_forward(q, k, v),
                    'plain': lambda: attn.flash_attention_forward_reference(q, k, v),
                    'library': lambda: F.scaled_dot_product_attention(q, k, v)})
            emit(row)
            rows.append(row)
            if not (row['finite'] and err <= LIMITS[dtype]):
                failures.append(row)
    if failures:
        raise AssertionError(f'flash kernel disagrees with its plain version: {failures}')
    return next(r for r in rows if r['shape'] == list(SERVING_SHAPE)
                and r['dtype'] == str(torch.float32) and r['dropout_rate'] == 0.0)


def dropout_mask_phase():
    """The dropout mask of kernels #1 and #2, exactly: with q = k = 0 every
    score is 0 and p = 1/T, and with v one-hot over a 64-key window
    (v[w + c, c] = 1) output column c is nonzero iff key w + c is kept.  The
    nonzero pattern must equal ``keep_full``'s at every (bh, query, key), so
    a wrong fragment -> (qpos, kpos) map cannot hide inside a tolerance; at
    ``bh_offset`` 0 and at a rank's offset into a larger batch.  Each launch
    is made again with the seed in device memory (``seed_dev``, as a step
    tape passes it): the same bits."""
    b, h = MASK_BH
    rows = []
    seed_dev = torch.tensor(4321, dtype=torch.int32, device='cuda')
    for t, off in [(t, o) for t in MASK_TS for o in MASK_BH_OFFSETS]:
        keep = attn.keep_full(4321, b, h, t, MASK_RATE, device='cuda', bh_offset=off)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.zeros((b, h, t, 64), device='cuda', dtype=dtype)
            mismatches = {'flash_fwd': 0, 'flash_fwd_lse': 0}
            same_dev = True
            for w in range(0, t, 64):
                n = min(64, t - w)
                v = torch.zeros_like(q)
                v[:, :, w + torch.arange(n, device='cuda'), torch.arange(n, device='cuda')] = 1
                want = torch.zeros((b, h, t, 64), dtype=torch.bool, device='cuda')
                want[..., :n] = keep[..., w:w + n]
                for name, lse in (('flash_fwd', False), ('flash_fwd_lse', True)):
                    got = attn.flash_attention_forward(q, q, v, 4321, None, MASK_RATE,
                                                       return_lse=lse, bh_offset=off)
                    # the seed read from device memory (a step tape's slot)
                    dev = attn.flash_attention_forward(q, q, v, seed_dev, None, MASK_RATE,
                                                       return_lse=lse, bh_offset=off)
                    same_dev &= all(torch.equal(x, y) for x, y in
                                    zip(got if lse else (got,), dev if lse else (dev,)))
                    got = got[0] if lse else got
                    mismatches[name] += int(((got != 0) != want).sum().item())
            row = {'phase': 'kernel_dropout_mask', 'shape': [b, h, t, 64],
                   'dtype': str(dtype), 'dropout_rate': MASK_RATE, 'bh_offset': off,
                   'kept_share': keep.float().mean().item(), 'mismatches': mismatches,
                   'seed_dev_same_bits': same_dev}
            emit(row)
            rows.append(row)
    if any(sum(r['mismatches'].values()) or not r['seed_dev_same_bits'] for r in rows):
        raise AssertionError(f'flash kernels drop other entries than keep_full, or differ '
                             f'with the seed in device memory: {rows}')


def _rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in f32."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def bwd_dropout_mask_phase():
    """The dropout mask of kernels #3 and #4, exactly.  lse = log T and
    delta = 0 passed in make p = 1/T wherever q.k = 0, and with v = dO = e0
    every dpv is 1, so ds is keep / (1 - rate) / T:
      dQ: q = 0, k one-hot over a 64-key window (k[w + c, c] = 1): dQ[i, c]
          is nonzero iff query i keeps key w + c;
      dK: k = 0, q one-hot over a window of queries: dK[j, c] is nonzero
          iff query w + c keeps key j;
      dV: q = k = v = 0, dO one-hot over a window of queries: dV[j, c] =
          p_eff[w + c, j], nonzero iff query w + c keeps key j.
    Each nonzero pattern must equal ``keep_full``'s, so a wrong fragment ->
    (qpos, kpos) map cannot hide inside a tolerance; at ``bh_offset`` 0 and at
    a rank's offset into a larger batch.  Each launch is made again with the
    seed in device memory (``seed_dev``): the same bits."""
    b, h = MASK_BH
    rows = []
    seed_dev = torch.tensor(4321, dtype=torch.int32, device=DEV)
    for t, off in [(t, o) for t in MASK_TS for o in MASK_BH_OFFSETS]:
        keep = attn.keep_full(4321, b, h, t, MASK_RATE, device=DEV, bh_offset=off)
        lse = torch.full((b, h, t), math.log(t), device=DEV)
        delta = torch.zeros((b, h, t), device=DEV)
        for dtype in (torch.float32, torch.bfloat16):
            zero = torch.zeros((b, h, t, 64), device=DEV, dtype=dtype)
            e0 = zero.clone()
            e0[..., 0] = 1
            mismatches = {'flash_bwd_dq': 0, 'flash_bwd_dk': 0, 'flash_bwd_dv': 0}
            same_dev = True
            for w in range(0, t, 64):
                n = min(64, t - w)
                idx = torch.arange(n, device=DEV)
                window = zero.clone()
                window[:, :, w + idx, idx] = 1

                def run(kernel, q, k, v, do, seed=4321):
                    return kernel(q, k, v, do, lse, delta, seed, 0.125, MASK_RATE, off)
                got = {'flash_bwd_dq': run(attn.flash_bwd_dq_kernel, zero, window, e0, e0),
                       'flash_bwd_dk': run(attn.flash_bwd_dkv_kernel, window, zero, e0, e0)[0],
                       'flash_bwd_dv': run(attn.flash_bwd_dkv_kernel, zero, zero, zero, window)[1]}
                dev = {'flash_bwd_dq': run(attn.flash_bwd_dq_kernel, zero, window, e0, e0,
                                           seed_dev),
                       'flash_bwd_dk': run(attn.flash_bwd_dkv_kernel, window, zero, e0, e0,
                                           seed_dev)[0],
                       'flash_bwd_dv': run(attn.flash_bwd_dkv_kernel, zero, zero, zero, window,
                                           seed_dev)[1]}
                same_dev &= all(torch.equal(got[k], dev[k]) for k in got)
                want_q = torch.zeros((b, h, t, 64), dtype=torch.bool, device=DEV)
                want_q[..., :n] = keep[..., w:w + n]
                want_kv = torch.zeros_like(want_q)
                want_kv[..., :n] = keep[:, :, w:w + n, :].transpose(-1, -2)
                for name, x in got.items():
                    want = want_q if name == 'flash_bwd_dq' else want_kv
                    mismatches[name] += int(((x != 0) != want).sum().item())
            row = {'phase': 'kernel_bwd_dropout_mask', 'shape': [b, h, t, 64],
                   'dtype': str(dtype), 'dropout_rate': MASK_RATE, 'bh_offset': off,
                   'kept_share': keep.float().mean().item(), 'mismatches': mismatches,
                   'seed_dev_same_bits': same_dev}
            emit(row)
            rows.append(row)
    if any(sum(r['mismatches'].values()) or not r['seed_dev_same_bits'] for r in rows):
        raise AssertionError(f'backward kernels drop other entries than keep_full, or differ '
                             f'with the seed in device memory: {rows}')


def sdpa_backward_device_ms(q, k, v, do):
    """Device ms of ``scaled_dot_product_attention``'s backward through
    autograd: forward + backward, minus the forward, each queued behind the
    spin (``device_ms``; the port never calls it).  None if either timing
    outlasted the spin."""
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg).backward(do)
    both = device_ms(fwd_bwd, reps=20)
    with torch.no_grad():
        fwd = device_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg), reps=20)
    return None if both is None or fwd is None else both - fwd


def bwd_pair_row(shape, dtype, q, k, v, do, out, lse, sdpa_ms) -> dict:
    """Kernels #3 and #4 as the gradient runs them (the delta reduction,
    then dQ and dK/dV: ``flash_attention_backward_blocked``) against SDPA's
    backward and the plain f32 recompute that the default path runs below
    ``BLOCKED_BWD_MIN_SEQ``, all in device time at dropout 0."""
    blocked = device_ms(lambda: attn.flash_attention_backward_blocked(q, k, v, out, lse, do))
    recompute = device_ms(lambda: attn.flash_backward_recompute(q, k, v, do), reps=20)
    return {'phase': 'kernel_bwd_pair', 'shape': list(shape), 'dtype': str(dtype),
            'blocked_device_ms': blocked, 'sdpa_backward_device_ms': sdpa_ms,
            'recompute_device_ms': recompute,
            'blocked_over_sdpa': (blocked / sdpa_ms if blocked and sdpa_ms else None)}


def flash_grad_phase():
    """Kernels #2-#4 against their plain versions at every case, rates 0 and
    0.1: the forward's (out, lse), then dQ and (dK, dV) from the same lse
    and delta.  Times at rate 0, and a row for #3 + #4 as one backward.
    Returns {kernel: serving-shape f32 row}."""
    gen = torch.Generator(device='cuda').manual_seed(1)
    rows, failures = {}, []
    for shape, dtype in KERNEL_CASES:
        q, k, v, do = (torch.randn(shape, generator=gen, device='cuda').to(dtype)
                       for _ in range(4))
        for rate, seed in ((0.0, 0), (0.1, 4321)):
            out, lse = attn.flash_attention_forward(q, k, v, seed, None, rate,
                                                    return_lse=True)
            torch.cuda.synchronize()
            out_p, lse_p = attn.flash_attention_forward_reference(
                q, k, v, seed, None, rate, return_lse=True)
            delta = (do.float() * out_p.float()).sum(-1)
            args = (q, k, v, do, lse_p, delta, seed, shape[-1] ** -0.5, rate)
            got = {'flash_fwd_lse': (out, lse),
                   'flash_bwd_dq': (attn.flash_bwd_dq_kernel(*args),),
                   'flash_bwd_dkv': attn.flash_bwd_dkv_kernel(*args)}
            torch.cuda.synchronize()
            want = {'flash_fwd_lse': (out_p, lse_p),
                    'flash_bwd_dq': (attn.flash_bwd_dq_reference(*args),),
                    'flash_bwd_dkv': attn.flash_bwd_dkv_reference(*args)}
            for name in got:
                if name == 'flash_fwd_lse':
                    errs = [(out.float() - out_p.float()).abs().max().item(),
                            (lse - lse_p).abs().max().item()]
                    ok = errs[0] <= LIMITS[dtype] and errs[1] <= LSE_LIMIT
                    b_ms, b_by = flash_bound(shape, dtype, lse=True)
                else:
                    rel = [_rel_err(g, w) for g, w in zip(got[name], want[name])]
                    errs = [(g.float() - w.float()).abs().max().item()
                            for g, w in zip(got[name], want[name])]
                    ok = max(rel) <= BWD_LIMITS[dtype]
                    b_ms, b_by = flash_bwd_bound(shape, dtype, name.split('_')[-1])
                finite = all(bool(torch.isfinite(x).all()) for x in got[name])
                row = {'phase': 'kernel', 'kernel': name, 'shape': list(shape),
                       'dtype': str(dtype), 'dropout_rate': rate,
                       'max_abs_err': max(errs), 'errs': errs, 'finite': finite,
                       'bound_ms': b_ms, 'bound_by': b_by}
                if name != 'flash_fwd_lse':
                    row.update(rel_errs=rel, rel_limit=BWD_LIMITS[dtype])
                if rate == 0.0:
                    if name == 'flash_fwd_lse':
                        time_calls(row, {
                            'kernel': lambda: attn.flash_attention_forward(
                                q, k, v, return_lse=True),
                            'plain': lambda: attn.flash_attention_forward_reference(
                                q, k, v, return_lse=True),
                            'library': lambda: F.scaled_dot_product_attention(q, k, v)})
                    else:
                        kern = getattr(attn, f'{name}_kernel')
                        ref = getattr(attn, f'{name}_reference')
                        time_calls(row, {'kernel': lambda: kern(*args),
                                         'plain': lambda: ref(*args)})
                        if name == 'flash_bwd_dq':    # after the kernel's own times
                            sdpa_ms = sdpa_backward_device_ms(q, k, v, do)
                        row['library_ms'] = sdpa_ms
                emit(row)
                if shape == SERVING_SHAPE and dtype == torch.float32 and rate == 0.0:
                    rows[name] = row
                if not (finite and ok):
                    failures.append(row)
            if rate == 0.0:
                emit(bwd_pair_row(shape, dtype, q, k, v, do, out, lse, sdpa_ms))
    if failures:
        raise AssertionError(f'flash lse/backward kernels disagree with their plain '
                             f'versions: {failures}')
    return rows


FLASH_BAND_CASES = [  # (B, H, H_kv, T, D, dtype, causal, window_left, dropout rate)
    (2, 32, 4, 8192, 128, torch.bfloat16, True, -1, 0.0),     # the Trinity cell, full layers
    (2, 32, 4, 8192, 128, torch.bfloat16, True, 2047, 0.0),   # ... and sliding layers
    (2, 12, 12, 2048, 64, torch.bfloat16, False, -1, 0.0),    # ViT-base long records
    (2, 8, 2, 300, 64, torch.float32, True, 100, 0.1)]
# bf16 band cases: |got - plain| / |plain| over the whole output and each
# gradient (at T = 8,192 an output element is ~0.03, so LIMITS' 2e-2 of abs
# alone would pass a wrong key)
BAND_REL_LIMIT = 6e-3


def flash_band_phase(other=None):
    """Kernels #1-#4 with a band and grouped KV heads
    (``tools/flash_band_probe.py``): against their plain versions at the
    Trinity cell's attention and ViT-base's long records (LIMITS, BWD_LIMITS,
    LSE_LIMIT, BAND_REL_LIMIT), the launches a banded call and its gradient
    count, and the device ms of #2-#4 against the band's FLOP bound; with
    ``other`` (the root of a checkout from before the band) the default
    calls' bits against that checkout's kernels at the kernel phase's
    shapes, and without it a row that says the check was skipped."""
    from ecg_representation_learning_tpu_torch.tools import flash_band_probe as probe
    failures = []
    for case in FLASH_BAND_CASES:
        err = probe.band_errors(case, torch.device('cuda', 0))
        dtype = case[5]
        ok = (err['fwd_is_lse_fwd'] and err['finite'] and err['out'] <= LIMITS[dtype]
              and err['lse'] <= LSE_LIMIT
              and max(err['dq'], err['dk'], err['dv']) <= BWD_LIMITS[dtype]
              and (dtype != torch.bfloat16 or max(
                  err[f'{n}_rel'] for n in ('out', 'dq', 'dk', 'dv')) <= BAND_REL_LIMIT))
        row = {'phase': 'kernel_band', 'case': [*case[:5], str(dtype), *case[6:]], **err,
               'ok': ok}
        emit(row)
        if not ok:
            failures.append(row)
    q = torch.randn((1, 8, 1024, 64), device='cuda', dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn((1, 2, 1024, 64), device='cuda', dtype=torch.bfloat16,
                        requires_grad=True) for _ in range(2))
    before = _build.launch_counts()
    attn.flash_attention(q, k, v, causal=True, window_left=255).sum().backward()
    moved = {n: c - before[n] for n, c in _build.launch_counts().items() if c != before[n]}
    emit({'phase': 'kernel_band_launches', 'launches': moved})
    if moved != {'flash_fwd_lse': 1, 'flash_bwd_dq': 1, 'flash_bwd_dkv': 1}:
        failures.append({'launches': moved})
    for row in probe.band_rows(torch.device('cuda', 0)):
        emit({'phase': 'kernel_band_time', **row})
    if other is None:
        emit({'phase': 'kernel_band_same_bits',
              'skipped': 'no --flash-other ROOT: the default calls were not held to '
                         'another checkout\'s bits'})
    else:
        from pathlib import Path
        for row in probe.same_bits_rows(Path(other), torch.device('cuda', 0)):
            emit({'phase': 'kernel_band_same_bits', **row})
            if not all(row['same'].values()):
                failures.append(row)
    if failures:
        raise AssertionError(f'banded flash kernels disagree: {failures}')


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units in the last place between two tensors
    of one float type (+0 and -0 coincide)."""
    int_type = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    bits = torch.iinfo(int_type).bits

    def ordered(t):
        i = t.contiguous().view(int_type).long()
        return torch.where(i < 0, -(i & ((1 << (bits - 1)) - 1)), i)
    return int((ordered(a) - ordered(b)).abs().max())


SITE_SETS = 8   # input sets a timing cycles through: 8 x >= 14 MB passes the 50 MB L2


def _site_inputs(kind: str, shape, gen) -> dict:
    """One set of a site's inputs as the cell has them: a bf16 branch, an
    f32 residual and gradient (bf16 for the hidden), the mask drawn as bool
    and as f32 (the chain's draw)."""
    keep_f32 = torch.empty(shape, device='cuda').bernoulli_(1 - SITE_RATE, generator=gen)
    g_type = torch.bfloat16 if kind == 'gelu_dropout' else torch.float32
    return {'keep_f32': keep_f32, 'keep': keep_f32.bool(),
            'branch': (2 * torch.randn(shape, generator=gen, device='cuda')).bfloat16(),
            'x': torch.randn(shape, generator=gen, device='cuda'),
            'g': torch.randn(shape, generator=gen, device='cuda').to(g_type)}


def _site_calls(kind: str, t: dict) -> dict:
    """{direction: (kernel call, plain call)} on the inputs ``t``: the plain
    version from the f32 mask, as the chain ran (its cast, scale, ``where``,
    and GELU or the add; the backward's mirror)."""
    inv, r = dropout.keep_scale(SITE_RATE), SITE_RATE
    br, keep, keep_f32, g = t['branch'], t['keep'], t['keep_f32'], t['g']
    launch = dropout._launch
    if kind == 'gelu_dropout':
        return {'forward': (lambda: launch('gelu_dropout_forward', kind, torch.empty_like(br),
                                           (br, keep), (1,), inv),
                            lambda: dropout.gelu_dropout_reference(br, keep_f32, r)),
                'backward': (lambda: launch('gelu_dropout_backward', f'{kind}_bwd',
                                            torch.empty_like(br), (g, keep, br), (1,), inv),
                             lambda: torch.ops.aten.gelu_backward(
                                 torch.where(keep_f32.bool(), g, 0.0) / (1 - r), br))}
    x = t['x']
    return {'forward': (lambda: launch('dropout_add_forward', kind, torch.empty_like(x),
                                       (br, keep, x), (1, 0), inv),
                        lambda: dropout.dropout_add_reference(x, br, keep_f32, r)),
            'backward': (lambda: launch('dropout_add_backward', f'{kind}_bwd',
                                        torch.empty_like(br), (g, keep), (0, 1), inv),
                         lambda: torch.where(keep_f32.bool(), g.bfloat16(), 0.0) / (1 - r))}


def _cycled(calls) -> callable:
    """One call a time from ``calls`` in turn."""
    state = [0]

    def run():
        state[0] += 1
        return calls[state[0] % len(calls)]()
    return run


def _site_row(kind: str, shape, gen) -> dict:
    """One dropout site kind at ``shape`` as the cell runs it: the kernel
    against the plain version each way, then each direction's device ms
    beside its byte bound (the mask as bool; also as f32) and the plain
    version's, each call on the next of ``SITE_SETS`` input sets, so that
    inputs come from HBM as the bound assumes (``*_warm``: one set, from
    L2 when it fits)."""
    n = math.prod(shape)
    sets = [_site_calls(kind, _site_inputs(kind, shape, gen)) for _ in range(SITE_SETS)]
    # bytes read and written besides the mask
    per_elem = ({'forward': (2, 2), 'backward': (2 + 2, 2)} if kind == 'gelu_dropout'
                else {'forward': (2 + 4, 4), 'backward': (4, 2)})
    row = {'phase': 'kernel', 'kernel': kind, 'shape': list(shape), 'dtype': 'bfloat16',
           'mask': 'bool', 'rate': SITE_RATE, 'input_sets': SITE_SETS}
    for direction in ('forward', 'backward'):
        kernel, plain = sets[0][direction]
        got, want = kernel(), plain()
        read, written = per_elem[direction]
        b_ms, b_by = bound(n * (read + 1 + written), 0, torch.float32)
        k_ms = device_ms(_cycled([s[direction][0] for s in sets]))
        row[direction] = {
            'ulps': _ulps(got, want),
            'max_abs_err': (got.float() - want.float()).abs().max().item(),
            'kernel_ms': time_ms(kernel), 'kernel_device_ms': k_ms,
            'kernel_device_ms_warm': device_ms(kernel),
            'bound_ms': b_ms, 'bound_by': b_by,
            'bound_ms_f32_mask': bound(n * (read + 4 + written), 0, torch.float32)[0],
            'bound_share': b_ms / k_ms if k_ms else None,
            'plain_ms': time_ms(plain, reps=20),
            'plain_device_ms': device_ms(_cycled([s[direction][1] for s in sets]), reps=20)}
    row['draw_f32_device_ms'] = device_ms(lambda: torch.empty(shape, device='cuda').bernoulli_(
        1 - SITE_RATE, generator=gen))
    row['draw_bool_device_ms'] = device_ms(lambda: torch.empty(
        shape, dtype=torch.bool, device='cuda').bernoulli_(1 - SITE_RATE, generator=gen))
    emit(row)
    limit = 0 if kind == 'dropout_add' else 1   # the sum is the chain's; erf, exp may round apart
    if max(row[d]['ulps'] for d in ('forward', 'backward')) > limit:
        raise AssertionError(f'{kind} kernel differs from its plain version: {row}')
    fwd = row['forward']
    return {**row, 'max_abs_err': fwd['max_abs_err'], 'kernel_ms': fwd['kernel_device_ms'],
            'plain_ms': fwd['plain_device_ms'], 'bound_ms': fwd['bound_ms'],
            'bound_by': fwd['bound_by'], 'library_ms': None}


def dropout_sites_phase() -> dict:
    """The dropout site kernels (``ops/csrc/dropout_sites.cu``) at the
    supervised cell's shapes (``_site_row``); returns their rows by name."""
    gen = torch.Generator(device='cuda').manual_seed(3)
    return {kind: _site_row(kind, shape, gen) for kind, shape in SITE_SHAPES.items()}


def _glue_set(order, pos, held, offs, rows, gen) -> dict:
    """One set of the glue's inputs at ``GLUE``'s shapes, rows past the held
    count NaN."""
    t, d, f, k = GLUE['tokens'], GLUE['d'], GLUE['f'], GLUE['k']
    n = int(offs[-1])

    def draw(shape, dtype=torch.bfloat16, poison=False):
        x = (2 * torch.randn(shape, generator=gen, device=DEV)).to(dtype)
        if poison:
            x[n:] = float('nan')
        return x
    return {'xs': draw((t, d), torch.float32), 'h': draw((rows, 2 * f), poison=True),
            'da': draw((rows, f), poison=True), 'y': draw((rows, d), poison=True),
            'g': draw((rows, d), poison=True), 'dout': draw((t, d), torch.float32),
            'gates': draw((t, k), torch.float32).abs(), 'order': order, 'pos': pos,
            'held': held, 'offs': offs, 'rows': rows}


def _glue_calls(z: dict) -> dict:
    """{entry: (kernel call, plain call)} on the inputs ``z``."""
    bf = torch.bfloat16
    args = {'permute_forward': (z['xs'], z['order'], z['offs'], z['rows'], bf),
            'permute_backward': (z['g'], z['pos'], z['held']),
            'swiglu_forward': (z['h'], z['offs']),
            'swiglu_backward': (z['h'], z['da'], z['offs']),
            'combine_forward': (z['y'], z['gates'], z['pos'], z['held'], z['offs']),
            'combine_backward': (z['y'], z['gates'], z['dout'], z['pos'], z['held'],
                                 z['order'], z['offs'])}
    return {name: ((lambda name=name, a=a: getattr(moe_glue, name)(*a)),
                   (lambda name=name, a=a: getattr(moe_glue, f'{name}_reference')(*a)))
            for name, a in args.items()}


def _glue_bytes(z: dict) -> dict:
    """The least bytes each entry moves at these inputs: each held row, each
    token's row and each index read or written once (2-byte rows, an f32 xs,
    out, gx and dout); dout's rows only for the tokens with a held choice."""
    t, d, f, k = GLUE['tokens'], GLUE['d'], GLUE['f'], GLUE['k']
    n = int(z['offs'][-1])
    t_held = int(z['held'].any(dim=1).sum())
    routing = t * k * (8 + 1 + 4)   # pos, held, gates
    return {'permute_forward': n * (d * (4 + 2) + 8),
            'permute_backward': n * d * 2 + t * k * 9 + t * d * 4,
            'swiglu_forward': n * f * (4 + 2),
            'swiglu_backward': n * f * (4 + 2 + 4),
            'combine_forward': n * d * 2 + routing + t * d * 4,
            'combine_backward': t_held * d * 4 + n * (d * 2 * 2 + 8) + routing + t * k * 4}


def _glue_check(name: str, got, want, z: dict) -> dict:
    """The kernel's output against the plain version's: values equal below
    the held count, or within the f32 bound of the sum (``GLUE_*``)."""
    n, t, k = int(z['offs'][-1]), GLUE['tokens'], GLUE['k']
    if name == 'combine_backward':
        (got, got_dg), (want, want_dg) = got, want
    token_rows = name in ('combine_forward', 'permute_backward')   # (T, d), else buffer rows
    got, want = (got, want) if token_rows else (got[:n], want[:n])
    err = {'finite': bool(torch.isfinite(got).all())}
    if token_rows:
        rows = z['y'] if name == 'combine_forward' else z['g']
        w = z['gates'] * z['held'] if name == 'combine_forward' else z['held'].float()
        terms = torch.nan_to_num(rows.float(), nan=0.0).index_select(0, z['pos'].reshape(-1))
        scale = (terms.reshape(t, k, -1).abs() * w[..., None]).sum(1)
        err['within'] = bool(((got - want).abs() <= GLUE_SUM_ULPS * scale).all())
        err['bits_equal'] = bool(torch.equal(got, want))
    else:
        err['within'] = bool(torch.equal(got, want))
    err['max_abs_err'] = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if name == 'combine_backward':
        ys = torch.nan_to_num(z['y'].float(), nan=0.0).index_select(0, z['pos'].reshape(-1))
        scale = (ys.reshape(t, k, -1).abs() * z['dout'].abs()[:, None]).sum(-1) * z['held']
        gap = (got_dg - want_dg).abs()
        err['dgates_max_abs_err'] = float(gap.max())
        err['within'] = (err['within'] and bool(torch.isfinite(got_dg).all())
                         and bool((gap <= GLUE_DOT_RTOL * scale).all()))
    return err


def _glue_main_path_launches() -> dict:
    """The glue's launches on the main path: ``GLUE_STEPS`` eager
    ``Trainer.train_step``s of the deepseek block at the preset's size (bf16,
    12 MoE layers) and the cell's batch, ``GLUE_BATCH`` records in
    ``GLUE_ACCUM`` microbatches.  Each entry must launch once each way per
    MoE layer and microbatch; no parameter is cast (``param_cast`` 0: every
    bf16 layer reads kernel #5's compute copies, whose count a step updates
    is reported)."""
    cfg = VitConfig.from_preset('moonlight-16b-a3b-ep8', dtype='bfloat16')
    rng = np.random.default_rng(4)
    n = GLUE_STEPS * GLUE_BATCH
    data = SplitData(signals=(0.2 * rng.standard_normal((n, 12, 2500))).astype(np.float32),
                     labels=(rng.uniform(size=(n, 71)) < 0.1).astype(np.float32))
    tr = Trainer(cfg, TrainConfig(train_batch_size=GLUE_BATCH, grad_accum=GLUE_ACCUM,
                                  log_to_console=False, save_final=False),
                 train_data=data, norm_stats=PTBXL_TRAIN_STATS['original'])
    tr.init_state()
    layers = len(deepseek_layers(tr.model))
    before = _build.launch_counts()
    for i in range(GLUE_STEPS):
        m = tr.train_step(data, np.arange(i * GLUE_BATCH, (i + 1) * GLUE_BATCH))
    loss = float(m['loss'])
    after = _build.launch_counts()
    made = {name: tuple(after[k] - before[k] for k in (f'moe_{name}', f'moe_{name}_bwd'))
            for name in ('permute', 'swiglu', 'combine')}
    want = GLUE_STEPS * GLUE_ACCUM * layers
    casts = after['param_cast'] - before['param_cast']
    copy_leaves = len(tr._copies.copies) if tr._copies else 0
    del tr, data, m
    gc.collect()
    torch.cuda.empty_cache()
    if (any(counts != (want, want) for counts in made.values()) or not math.isfinite(loss)
            or casts != 0 or copy_leaves == 0):
        raise AssertionError(f'moe_glue: {GLUE_STEPS} steps of {layers} MoE layers and '
                             f'{GLUE_ACCUM} microbatches made launches {made} (want {want} '
                             f'each way), {casts} parameter casts (want 0) over '
                             f'{copy_leaves} copied leaves, loss {loss}')
    total = sum(a + b for a, b in made.values())
    return {'moe_layers': layers, 'steps': GLUE_STEPS, 'microbatches': GLUE_ACCUM,
            'launches': made, 'launches_per_step': total / GLUE_STEPS, 'total': total,
            'param_cast': casts, 'copy_leaves_per_update': copy_leaves}


def moe_glue_phase():
    """The MoE glue kernels (``ops/csrc/moe_glue.cu``) at the
    ``moonlight_ep8_cls_k4`` cell's shapes: each entry against its plain
    version, its device ms (each call on the next of ``GLUE_SETS`` input
    sets) beside its byte bound and the plain version's; then the
    launches on the main path (``_glue_main_path_launches``).  Returns (the
    row, those launches)."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    t, e, k = GLUE['tokens'], GLUE['experts'], GLUE['k']
    w = torch.ones(e, device=DEV)
    w[:GLUE['held']] = GLUE['held_weight']
    idx = torch.multinomial(w.expand(t, e).contiguous(), k, replacement=False, generator=gen)
    rows = t * min(k, GLUE['held'])
    order, pos, held, _, offs = sort_pairs(idx, 0, GLUE['held'], rows)
    sets = [_glue_set(order, pos, held, offs, rows, gen) for _ in range(GLUE_SETS)]
    calls = [_glue_calls(z) for z in sets]
    n_bytes = _glue_bytes(sets[0])
    row = {'phase': 'kernel', 'kernel': 'moe_glue', 'tokens': t, 'rows': rows,
           'held_rows': int(offs[-1]), 'held_share': int(offs[-1]) / rows, 'dtype': 'bfloat16',
           'input_sets': GLUE_SETS}
    for name in n_bytes:
        kernel, plain = calls[0][name]
        entry = _glue_check(name, kernel(), plain(), sets[0])
        b_ms, b_by = bound(n_bytes[name], 0, torch.float32)
        k_ms = device_ms(_cycled([c[name][0] for c in calls]))
        entry.update(kernel_device_ms=k_ms, bound_ms=b_ms, bound_by=b_by,
                     bound_share=b_ms / k_ms if k_ms else None,
                     plain_device_ms=device_ms(_cycled([c[name][1] for c in calls]), reps=20))
        row[name] = entry
    del sets, calls
    torch.cuda.empty_cache()
    row['main_path'] = _glue_main_path_launches()
    launches = row['main_path']['total']
    emit(row)
    bad = [name for name in n_bytes if not (row[name]['finite'] and row[name]['within'])]
    if bad:
        raise AssertionError(f'moe_glue kernels differ from their plain versions: {bad}: {row}')
    total = {key: sum(row[name][key] or 0.0 for name in n_bytes)
             for key in ('kernel_device_ms', 'bound_ms', 'plain_device_ms')}
    return {**row, 'max_abs_err': max(row[name]['max_abs_err'] for name in n_bytes),
            'kernel_ms': total['kernel_device_ms'], 'plain_ms': total['plain_device_ms'],
            'bound_ms': total['bound_ms'], 'bound_by': 'bytes', 'library_ms': None}, launches


def adamw_tree_row(tree: str, moe: bool, mu_dtype: torch.dtype) -> dict:
    """Kernel #5's tail on one tree over ADAMW_STEPS: launch 1 (norm, clip
    and non-finite scalars, counter) against the plain version from the
    same gradients -- the norm within NORM_RTOL of ``global_norm`` and the
    same bits on a second launch, the scalars and the counter equal to
    ``tail_scalars_reference`` from the kernel's norm -- then launch 2 (the
    update, with launch 1's scalars) bit for bit against the plain update;
    then the times of both beside the plain versions' and
    ``torch.optim.AdamW(fused=True)``'s on the same tensors.  Then the copy
    route (``copy_route``: bf16 gradient parts at accum 1 and 2, every
    leaf's compute copy written): one step bit for bit against the f32
    route fed the mean gradients (norm, counter, p, mu, nu, copies) and
    against the plain version given the kernel's norm, the norm within
    NORM_RTOL of ``global_norm``; and its time."""
    shapes = adamw_probe.tree_shapes(moe)
    n_params = sum(s.numel() for s in shapes)
    gen = torch.Generator(device='cuda').manual_seed(2)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
    kern = adamw.adamw_kernel

    def leaves(fn):
        return [fn(s) for s in shapes]
    params = leaves(lambda s: torch.randn(s, generator=gen, device='cuda'))
    mus = leaves(lambda s: torch.zeros(s, device='cuda', dtype=mu_dtype))
    nus = leaves(lambda s: torch.zeros(s, device='cuda'))
    twin = [[x.clone() for x in xs] for xs in (params, mus, nus)]
    count = torch.zeros((), dtype=torch.int32, device='cuda')
    errs, norm_errs, checks = [], [], []
    for step, (clip, finite) in enumerate(ADAMW_STEPS, start=1):
        grads = leaves(lambda s: torch.randn(s, generator=gen, device='cuda'))
        if not finite:
            grads[0].view(-1)[0] = float('nan')
        lr_bc = (3e-4, 1 - 0.9 ** step, 1 - 0.999 ** step)
        kw = dict(clip_norm=clip, zero_nonfinite=True)
        scal, norm, count_k = kern.norm_scalars(params, grads, mus, nus, lr_bc, count, **kw)
        scal2, norm2, _ = kern.norm_scalars(params, grads, mus, nus, lr_bc, count, **kw)
        want_norm = adamw.global_norm(grads)
        want_scal = adamw.tail_scalars_reference(norm, lr_bc, **kw)
        want_count = count + (~torch.isfinite(norm)).to(torch.int32)
        kern(params, grads, mus, nus, scal, **hyper)
        torch.cuda.synchronize()
        adamw.adamw_update_reference(*twin[:1], grads, *twin[1:], scal, **hyper)
        both_nan = bool(torch.isnan(norm)) and bool(torch.isnan(want_norm))
        norm_errs.append(0.0 if both_nan else abs(norm.item() - want_norm.item()))
        checks.append({'clip_norm': clip, 'finite_grads': bool(finite), 'norm': norm.item(),
                       'plain_norm': want_norm.item(),
                       'norm_rel_err': 0.0 if both_nan else
                       abs(norm.item() / want_norm.item() - 1),
                       'same_bits_twice': _same_bits(scal2, scal) and _same_bits(norm2, norm),
                       'scalars': scal.tolist(),
                       'scalars_equal_plain': _same_bits(scal, want_scal),
                       'count': int(count_k), 'count_equal_plain': int(count_k) == int(want_count)})
        errs.append(max((a.float() - b.float()).abs().max().item()
                        for xs, ys in zip((params, mus, nus), twin)
                        for a, b in zip(xs, ys)))
        count = count_k
    finite_ok = all(bool(torch.isfinite(p).all()) for p in params)
    mu_bytes = torch.finfo(mu_dtype).bits // 8
    b_ms, b_by = bound(n_params * (4 * 5 + 2 * mu_bytes), 15 * n_params, torch.float32)
    nb_ms, nb_by = bound(4 * n_params, 2 * n_params, torch.float32)
    scalars = adamw_probe.scalars_for(1, 0.5)
    call = lambda: adamw.adamw_update(params, grads, mus, nus, scalars, **hyper)
    norm_call = lambda: kern.norm_scalars(params, grads, mus, nus, (3e-4, 0.1, 0.001),
                                          clip_norm=1.0, zero_nonfinite=True)
    tail_call = lambda: adamw.adamw_tail(params, grads, mus, nus, (3e-4, 0.1, 0.001),
                                         clip_norm=1.0, zero_nonfinite=True, **hyper)
    row = {'phase': 'kernel', 'kernel': 'adamw', 'tree': tree, 'leaves': len(shapes),
           'params': n_params, 'mu_dtype': str(mu_dtype), 'max_abs_err': max(errs),
           'errs_per_step': errs, 'finite': finite_ok, 'steps': checks,
           'bound_ms': b_ms, 'bound_by': b_by, 'kernel_ms': time_ms(call, reps=20),
           'plain_ms': time_ms(lambda: adamw.adamw_update_reference(
               *twin[:1], grads, *twin[1:], scalars, **hyper), reps=5)}
    row['kernel_device_ms'], row['host_us_per_call'] = adamw_probe.device_and_host(call)
    row['bound_share'] = b_ms / row['kernel_device_ms'] if row['kernel_device_ms'] else None
    row['norm'] = {'max_abs_err': max(norm_errs), 'bound_ms': nb_ms, 'bound_by': nb_by,
                   'kernel_ms': time_ms(norm_call, reps=20),
                   'plain_ms': time_ms(lambda: adamw.global_norm(grads), reps=20),
                   'library_ms': None}
    row['norm']['kernel_device_ms'], row['norm']['host_us_per_call'] = \
        adamw_probe.device_and_host(norm_call)
    row['tail_ms'] = time_ms(tail_call, reps=20)
    row['tail_device_ms'], row['tail_host_us_per_call'] = adamw_probe.device_and_host(tail_call)
    del twin
    torch.cuda.empty_cache()
    # the copy route: every leaf's gradient as bf16 microbatch parts, every
    # leaf's compute copy written (a training step's tail on a bf16 model):
    # one step from the state above held to the f32 route fed the mean
    # gradients and to the plain version (given the kernel's norm), then timed
    row['copy_route'] = {}
    lr_bc = (3e-4, 0.1, 0.001)
    tail_kw = dict(clip_norm=1.0, zero_nonfinite=True, **hyper)
    for accum in (1, 2):
        parts = [tuple(torch.randn(s, generator=gen, device='cuda').to(torch.bfloat16)
                       for _ in range(accum)) for s in shapes]
        mean = adamw.mean_grads(parts, accum)
        sides = {}
        for side in ('copy', 'f32', 'plain'):
            state = [[x.clone() for x in xs] for xs in (params, mus, nus)]
            cps = [torch.zeros_like(p, dtype=torch.bfloat16) for p in params]
            if side == 'copy':
                out = adamw.adamw_tail(state[0], parts, *state[1:], lr_bc, count, accum=accum,
                                       copies=cps, **tail_kw)
            elif side == 'f32':
                out = adamw.adamw_tail(state[0], mean, *state[1:], lr_bc, count, **tail_kw)
                cps = [p.to(torch.bfloat16) for p in state[0]]
            else:
                out = adamw.adamw_tail_reference(state[0], parts, *state[1:], lr_bc, count,
                                                 accum=accum, copies=cps,
                                                 g_norm=sides['copy'][0], **tail_kw)
            torch.cuda.synchronize()
            sides[side] = (*out, state, cps)
        norm, got_count, state, cps = sides['copy']
        plain_norm = adamw.global_norm(mean).item()
        check = {'norm': norm.item(), 'plain_norm': plain_norm,
                 'norm_rel_err': abs(norm.item() / plain_norm - 1),
                 'norm_equal_f32_route': _same_bits(norm, sides['f32'][0]),
                 'count_equal': int(got_count) == int(sides['f32'][1]) == int(sides['plain'][1])}
        for side in ('f32', 'plain'):
            other = sides[side]
            check[f'state_equal_{side}'] = all(
                _same_bits(a.float(), b.float()) for xs, ys in zip(state, other[2])
                for a, b in zip(xs, ys))
            check[f'copies_equal_{side}'] = all(
                torch.equal(a.view(torch.int16), b.view(torch.int16))
                for a, b in zip(cps, other[3]))
        del sides, state, cps, mean
        torch.cuda.empty_cache()
        copies = [torch.empty_like(p, dtype=torch.bfloat16) for p in params]
        copy_call = lambda: adamw.adamw_tail(params, parts, mus, nus, lr_bc, accum=accum,
                                             copies=copies, **tail_kw)
        ms, host_us = adamw_probe.device_and_host(copy_call)
        row['copy_route'][f'accum{accum}'] = {
            **check, 'tail_device_ms': ms, 'host_us_per_call': host_us,
            'bytes_per_param': 4 * 3 + 4 + 2 * mu_bytes + 2 + 2 * 2 * accum}
        del parts, copies
        torch.cuda.empty_cache()
    lib = [torch.nn.Parameter(p) for p in params]
    for p, g in zip(lib, grads):
        p.grad = g
    opt = torch.optim.AdamW(lib, lr=3e-4, weight_decay=1e-2, fused=True)
    row['library_ms'] = time_ms(opt.step, reps=20)
    row['library_device_ms'], row['library_host_us_per_call'] = \
        adamw_probe.device_and_host(opt.step)
    del lib, opt, params, mus, nus, grads
    torch.cuda.empty_cache()
    emit(row)
    bad = [c for c in checks if not (c['norm_rel_err'] <= NORM_RTOL and c['same_bits_twice']
                                     and c['scalars_equal_plain'] and c['count_equal_plain'])]
    bad += [c for c in row['copy_route'].values()
            if not (c['norm_rel_err'] <= NORM_RTOL and all(
                c[k] for k in ('norm_equal_f32_route', 'count_equal', 'state_equal_f32',
                               'copies_equal_f32', 'state_equal_plain', 'copies_equal_plain')))]
    if not (finite_ok and max(errs) <= ADAMW_LIMIT and not bad and checks[-1]['count'] == 1):
        raise AssertionError(f'adamw kernels disagree with their plain versions: {row}')
    return row


def adamw_phase():
    """Kernel #5's tail (both launches of ``ops/csrc/adamw.cu``) on every
    ViT-base leaf with f32 and with bf16 mu, and on the Switch-MoE ViT-base
    tree (``SCALE_MOE``) with f32 mu (``adamw_tree_row``).  Returns the
    ViT-base f32-mu row and its norm launch's, for the kernels line."""
    rows = [adamw_tree_row('vit_base', False, torch.float32),
            adamw_tree_row('vit_base', False, torch.bfloat16),
            adamw_tree_row('vit_base_moe', True, torch.float32)]
    return rows[0], rows[0]['norm']


def nlm_bound(rows: int, n: int, sch: int, pw: int):
    """Least time for one NLM launch: x and 1/h read once, the output
    written once, against NLM_OPS operations per weight that the rows need
    (``nlm_fused.needed_weights``) at the f32 CUDA-core peak."""
    return bound(4 * (2 * rows * n + rows),
                 NLM_OPS * rows * nlm_fused.needed_weights(n, sch, pw), torch.float32)


def _events_ms(fn):
    """(result, device ms) of one call of ``fn``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _nlm_err(got, want, x, zero_rows=()):
    """max |got - want| over max |x|, off the all-zero rows, whose interior
    must be NaN in both (h = 0) and whose edges pass through."""
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    keep[list(zero_rows)] = False
    for r in zero_rows:
        for out in (got, want):
            if not (torch.isnan(out[r, 1:-1]).any() and (out[r, :1] == 0).all()):
                raise AssertionError(f'all-zero row {r} is not NaN inside: {out[r, :20]}')
    err = (got[keep] - want[keep]).abs().max() / x.abs().max()
    return err.item(), bool(torch.isfinite(got[keep]).all())


def chain_rows():
    """The denoise chain's NLM input for one chunk of synthetic records
    (low-pass and robust LOESS on the card): rows (768, 2500) and their
    bandwidths."""
    x = synth_ecg(np.random.default_rng(8), DENOISE_CHUNK, length=DENOISE_LEN,
                  fqs=DENOISE_FQS)
    y = zheng_detrend(torch.from_numpy(x).to(DEV), DENOISE_FQS)
    return y.reshape(-1, DENOISE_LEN), nlm_fused.nlm_bandwidth(y).reshape(-1)


def nlm_phase(y2, h2):
    """Kernel #6 against ``nlm_rows_reference``: the denoise chain's rows
    ``y2`` (768, 2500) with bandwidths ``h2`` at full search (the CLI
    default) and at search 128, the first 192 rows (a 16-record chunk) at
    full search, 64 of them with QRS-sized spikes added; ragged rows
    (77 x 1999, pw 7: the generic branch, search 64) with an all-zero row;
    rows longer than the register branch stages (24 x 9000, search 5000) and
    longer than shared memory holds (2 x 70000, search 64).  Every case also
    in device time, with the cluster size the kernel chose, and against the
    plain version evaluated in f64 (``max_abs_err_f64``: its f32 sums over
    thousands of shifts carry rounding of the limit's size, which
    ``plain_f32_vs_f64`` shows); two calls on the chain's rows must give the
    same bits.  Returns the full-search row."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    (r1, n1, s1, p1), (r2, n2, s2, p2), (r3, n3, s3, p3) = NLM_RAGGED, NLM_LONG, NLM_LONGER
    ragged = 10 * torch.randn((r1, n1), generator=gen, device=DEV)
    ragged[5] = 0.0
    long_rows = torch.randn((r2, n2), generator=gen, device=DEV)
    longer_rows = torch.randn((r3, n3), generator=gen, device=DEV)
    spiky, n0 = y2[:64].clone(), y2.shape[1]
    spiky[:, n0 // 4] += 50 * y2.abs().max()     # ~10^3 x the SSDs of the beats around it
    spiky[:, 3 * n0 // 4:3 * n0 // 4 + 3] -= 20 * y2.abs().max()
    cases = [('chain_full', y2, h2, y2.shape[1], 10, ()),
             ('chain_128', y2, h2, 128, 10, ()),
             ('chain_16_records', y2[:192], h2[:192], y2.shape[1], 10, ()),
             ('chain_spiky', spiky, nlm_fused.nlm_bandwidth(spiky, 1.5, 10), y2.shape[1], 10, ()),
             ('ragged_zero_row', ragged, nlm_fused.nlm_bandwidth(ragged, 1.5, p1), s1, p1, (5,)),
             ('long_rows', long_rows, nlm_fused.nlm_bandwidth(long_rows, 1.5, p2), s2, p2, ()),
             ('longer_than_smem', longer_rows, nlm_fused.nlm_bandwidth(longer_rows, 1.5, p3),
              s3, p3, ())]
    rows, failures = {}, []
    for name, x, h, sch, pw, zero_rows in cases:
        got = nlm_fused.nlm_rows(x, h, sch, pw)
        torch.cuda.synchronize()
        want, plain_once = _events_ms(lambda: nlm_fused.nlm_rows_reference(x, h, sch, pw))
        err, finite = _nlm_err(got, want, x, zero_rows)
        want64 = nlm_fused.nlm_rows_reference(x.double(), h.double(), sch, pw)
        err64, _ = _nlm_err(got.double(), want64, x, zero_rows)
        plain_err, _ = _nlm_err(want.double(), want64, x, zero_rows)
        del want64
        b_ms, b_by = nlm_bound(x.shape[0], x.shape[1], sch, pw)
        call = lambda: nlm_fused.nlm_rows(x, h, sch, pw)  # noqa: E731
        row = {'phase': 'kernel', 'kernel': 'nlm_rows', 'case': name,
               'shape': list(x.shape), 'sch_wd': sch, 'patch_wd': pw,
               'max_abs_err': err, 'max_abs_err_f64': err64, 'plain_f32_vs_f64': plain_err,
               'limit': NLM_LIMIT, 'finite': finite,
               'zero_rows_nan': list(zero_rows), 'bound_ms': b_ms, 'bound_by': b_by,
               'cluster': nlm_fused.cluster_size(x.shape[0], x.shape[1], sch, pw),
               'kernel_ms': time_ms(call, reps=5 if sch > 1000 else 20, warmup=1),
               'kernel_device_ms': device_ms(call, reps=10 if sch > 1000 else 50, warmup=1),
               'plain_ms': (plain_once if sch > 1000 else time_ms(
                   lambda: nlm_fused.nlm_rows_reference(x, h, sch, pw), reps=3, warmup=1)),
               'plain_timed': 'once' if sch > 1000 else 'mean of 3',
               'library_ms': None,
               'library': 'none: no single PyTorch call computes non-local means'}
        if name == 'chain_full':
            again = nlm_fused.nlm_rows(x, h, sch, pw)
            row['same_bits_twice'] = bool(torch.equal(got, again))
            if not row['same_bits_twice']:
                failures.append(row)
        emit(row)
        rows[name] = row
        if not (finite and err <= NLM_LIMIT and err64 <= NLM_LIMIT):
            failures.append(row)
    if failures:
        raise AssertionError(f'nlm kernel disagrees with its plain version: {failures}')
    return rows['chain_full']


def nlm_variant_phase():
    """Kernel #7: each attribution variant against its plain version at the
    probe's shape (768, 2500, search 128, pw 10, N(0, 1) rows, h = 1), then
    the probe's own timing run (its launches are this kernel's main path)
    and its attribution.  Returns the 'full' variant's row."""
    r, n, sch, pw = probe.SHAPE
    gen = torch.Generator(device=DEV).manual_seed(4)
    x = torch.randn((r, n), generator=gen, device=DEV)
    h = torch.ones(r, device=DEV)
    b_ms, b_by = nlm_bound(r, n, sch, pw)
    rows, failures = {}, []
    for name, flags in probe.VARIANTS:
        got = probe.run_variant(x, h, sch, pw, flags)
        torch.cuda.synchronize()
        want = probe.variant_reference(x, h, sch, pw, flags)
        err, finite = _nlm_err(got, want, x)
        row = {'phase': 'kernel', 'kernel': 'nlm_variant', 'variant': name,
               'shape': [r, n], 'sch_wd': sch, 'patch_wd': pw, 'max_abs_err': err,
               'limit': NLM_LIMIT, 'finite': finite, 'bound_ms': b_ms, 'bound_by': b_by,
               'kernel_ms': time_ms(lambda: probe.run_variant(x, h, sch, pw, flags),
                                    reps=20, warmup=1),
               'kernel_device_ms': device_ms(lambda: probe.run_variant(x, h, sch, pw, flags),
                                             warmup=1),
               'plain_ms': time_ms(lambda: probe.variant_reference(x, h, sch, pw, flags),
                                   reps=3, warmup=1),
               'library_ms': None}
        emit(row)
        rows[name] = row
        if not (finite and err <= NLM_LIMIT):
            failures.append(row)
    if failures:
        raise AssertionError(f'nlm variants disagree with their plain versions: {failures}')
    before = _build.launch_counts()['nlm_variant']
    times = probe.measure()
    launches = _build.launch_counts()['nlm_variant'] - before
    emit({'phase': 'nlm_sol_probe', 'shape': list(probe.SHAPE), 'ms': times,
          'attribution_ms': probe.attribution(times),
          'attribution_share': {k: v / times['full'] for k, v in
                                probe.attribution(times).items()},
          'launches': launches})
    full = dict(rows['full'], launches=launches,
                max_abs_err=max(row['max_abs_err'] for row in rows.values()))
    return full


def _chunk_split(x, cfg, emit_profiles):
    """Each chain step on one chunk, profiled alone after a warm-up call
    (see ``_profile``): low-pass, rloess (6 smooths, 10 medians), the noise
    estimate (2 medians) and the NLM kernel.  Returns {step: device ms, wall
    ms, device launches}; emits each step's profile if asked."""
    y1 = butterworth_low_pass(x, fs=DENOISE_FQS)
    y = (y1 - rloess(y1, n=DENOISE_FQS, robust_iters=cfg.loess_robust_iters)
         ).reshape(-1, x.shape[-1])
    h = nlm_fused.nlm_bandwidth(y, cfg.nlm_smooth_factor, cfg.nlm_patch_halfwidth)
    sch = cfg.nlm_search_width or x.shape[-1]
    steps = {'lowpass': lambda: butterworth_low_pass(x, fs=DENOISE_FQS),
             'rloess': lambda: rloess(y1, n=DENOISE_FQS, robust_iters=cfg.loess_robust_iters),
             'sigma': lambda: nlm_fused.nlm_bandwidth(y, cfg.nlm_smooth_factor,
                                                      cfg.nlm_patch_halfwidth),
             'nlm': lambda: nlm_fused.nlm_rows(y, h, sch, cfg.nlm_patch_halfwidth)}
    split = {}
    for name, step in steps.items():
        def run(step=step):
            step()
            torch.cuda.synchronize()
        run()
        # a profile that misses a launch of the port's kernels (their launch
        # counts say how many ran) is taken again, up to three times
        for attempt in range(1, 4):
            before = _build.launch_counts()['nlm_rows']
            prof = _profile(f'denoise step {name}, chunk of {DENOISE_CHUNK} records, '
                            f'search {sch}', 'call', 1, run)
            seen = sum(k['launches_per_call'] for k in prof['port_kernels'])
            if seen == _build.launch_counts()['nlm_rows'] - before:
                break
        split[name] = {'device_ms': prof['device_ms_per_call'],
                       'wall_ms': prof['wall_ms_per_call'],
                       'launches': prof['device_launches_per_call'],
                       'profile_attempts': attempt}
        if emit_profiles:
            emit(prof)
    return split


def denoise_phase():
    """``export_denoised``'s per-chunk body on the card at the CLI defaults:
    two chunks of 64 records at full search, one at search 128.  Returns
    the NLM kernel's launches in those three runs (one per chunk)."""
    rng = np.random.default_rng(7)
    x = synth_ecg(rng, 3 * DENOISE_CHUNK, length=DENOISE_LEN, fqs=DENOISE_FQS)
    zero_lead = (5, 4)                   # record 5 of the first chunk: lead 4 all zero
    x[zero_lead] = 0.0
    full, bounded = PreprocessConfig(), PreprocessConfig(nlm_search_width=128)
    denoise_chunk(x[:2, :, :500], DENOISE_FQS, bounded, DEV)  # warm-up: cuBLAS, library
    _build.reset_launches()
    runs, outs = [], []
    for i, cfg in enumerate((full, full, bounded)):
        chunk = x[i * DENOISE_CHUNK:(i + 1) * DENOISE_CHUNK]
        before = _build.launch_counts()['nlm_rows']
        t0 = time.perf_counter()
        outs.append(denoise_chunk(chunk, DENOISE_FQS, cfg, DEV))
        seconds = time.perf_counter() - t0
        runs.append({'chunk': i, 'records': len(chunk),
                     'nlm_search_width': cfg.nlm_search_width or DENOISE_LEN,
                     'seconds': seconds, 'records_per_s': len(chunk) / seconds,
                     'nlm_launches': _build.launch_counts()['nlm_rows'] - before})
    launches = _build.launch_counts()
    emit({'phase': 'denoise', 'runs': runs, 'launches': launches})
    if [r['nlm_launches'] for r in runs] != [1, 1, 1]:
        raise AssertionError(f'expected one NLM launch per chunk: {runs}')

    # the twin: the same chain with the plain NLM step, on the same rows
    first = torch.from_numpy(x[:DENOISE_CHUNK]).to(DEV)
    y = zheng_detrend(first, DENOISE_FQS, full)
    h = nlm_fused.nlm_bandwidth(y, full.nlm_smooth_factor, full.nlm_patch_halfwidth)
    y2 = y.reshape(-1, DENOISE_LEN)
    twin = nlm_fused.nlm_rows_reference(y2, h.reshape(-1), DENOISE_LEN,
                                        full.nlm_patch_halfwidth).reshape(first.shape)
    twin64 = nlm_fused.nlm_rows_reference(y2.double(), h.reshape(-1).double(), DENOISE_LEN,
                                          full.nlm_patch_halfwidth).reshape(first.shape)
    raw = zheng_denoise(first, DENOISE_FQS, full)
    ok = torch.ones(first.shape[:2], dtype=torch.bool, device=DEV)
    ok[zero_lead] = False
    twin_err = ((raw[ok] - twin[ok]).abs().max() / y[ok].abs().max()).item()
    twin64_err = ((raw[ok].double() - twin64[ok]).abs().max() / y[ok].abs().max()).item()
    chain_err = float(np.abs(outs[0] - np.nan_to_num(raw.cpu().numpy())).max()
                      / np.abs(x[:DENOISE_CHUNK]).max())

    # the chain on the CPU, two records at full search
    cpu = denoise_chunk(x[:2], DENOISE_FQS, full, device='cpu')
    cpu_err = float(np.abs(outs[0][:2] - cpu).max() / np.abs(x[:2]).max())
    zero_ok = bool((outs[0][zero_lead] == 0).all() and torch.isnan(raw[zero_lead]).any())
    finite = all(bool(np.isfinite(o).all()) for o in outs)
    summary = {'phase': 'denoise_check', 'records': int(x.shape[0]),
               'shape': list(x.shape[1:]), 'fqs': DENOISE_FQS,
               'max_abs_err_vs_plain_nlm_twin': twin_err,
               'max_abs_err_vs_plain_nlm_twin_f64': twin64_err, 'twin_limit': NLM_LIMIT,
               'max_abs_err_chunk_vs_chain': chain_err,
               'max_abs_err_vs_cpu_2_records': cpu_err, 'cpu_limit': DENOISE_CPU_LIMIT,
               'zero_lead_zero': zero_ok, 'finite': finite,
               'by_step_full': _chunk_split(first, full, emit_profiles=True),
               'by_step_128': _chunk_split(first, bounded, emit_profiles=False)}
    emit(summary)
    if not (twin_err <= NLM_LIMIT and twin64_err <= NLM_LIMIT and chain_err <= NLM_LIMIT
            and cpu_err <= DENOISE_CPU_LIMIT and zero_ok and finite):
        raise AssertionError(f'denoise chain check failed: {summary}')
    second = x[DENOISE_CHUNK:2 * DENOISE_CHUNK]
    for cfg, label in ((bounded, 'search 128'), (full, 'full search')):
        denoise_chunk(second, DENOISE_FQS, cfg, DEV)
        emit(_profile(f'denoise chunk of {DENOISE_CHUNK} records, {label}', 'chunk', 1,
                      lambda: denoise_chunk(second, DENOISE_FQS, cfg, DEV)))
    return {'nlm_rows': launches['nlm_rows']}


def _launched(counts: dict, expect: dict) -> bool:
    """Whether the registry's ``counts`` hold ``expect``'s launches, of the
    counters it names."""
    return all(counts[k] == v for k, v in expect.items())


def _steps_per_s(tr: Trainer, data: SplitData, n_steps: int) -> float:
    """Train samples per second over ``n_steps`` steps (host clock, the
    last loss fetched, so the device has finished)."""
    bs = tr.cfg.train_batch_size
    t0 = time.perf_counter()
    for i in range(n_steps):
        m = tr.train_step(data, np.arange(i * bs, (i + 1) * bs) % len(data))
    float(m['loss'])
    return n_steps * bs / (time.perf_counter() - t0)


def profile_train_step(tr, data: SplitData, steps: int = 3, kind: str = 'train') -> dict:
    """Where a ViT-base ``kind`` step spends its time (see ``_profile``)."""
    take = np.arange(tr.cfg.train_batch_size)
    float(tr.train_step(data, take)['loss'])

    def run():
        for _ in range(steps):
            m = tr.train_step(data, take)
        float(m['loss'])
    return _profile(f'ViT-base {tr.model_cfg.dtype} bs-{tr.cfg.train_batch_size} '
                    f'{kind} step, {steps} steps', 'step', steps, run)


def copy_route_parity(cfg: VitConfig, tcfg: TrainConfig, batch: SplitData, stats) -> None:
    """Kernel #5's copy route in training: ViT-base bf16, dropout off, two
    microbatches a step, so every bf16 Linear reads its compute copy and #5
    reads the copies' bf16 gradients, takes their mean and writes the
    copies; against a twin from the same init whose tail is the plain
    version (``adamw_tail_reference``: the mean, ``global_norm``, the
    update, the copies written).  Losses and parameters within LOSS_RTOL and
    PARAM_TOL, every copy equal to its parameter rounded to bf16 on both
    sides, and no parameter cast (``param_cast`` 0)."""
    cfg = dataclasses.replace(cfg, dtype='bfloat16')
    tcfg = dataclasses.replace(tcfg, grad_accum=2)
    tr = Trainer(cfg, tcfg, train_data=batch, norm_stats=stats)
    tr.init_state()
    twin = Trainer(cfg, tcfg, train_data=batch, norm_stats=stats)
    twin.set_params(tr.model.state_dict())
    twin.optimizer.tail = adamw.adamw_tail_reference
    losses, casts = [], []
    for k in range(PARITY_STEPS):
        take = np.arange(64 * k, 64 * (k + 1))
        before = _build.launch_counts()['param_cast']
        got = float(tr.train_step(batch, take)['loss'])
        want = float(twin.train_step(batch, take)['loss'])
        casts.append(_build.launch_counts()['param_cast'] - before)
        losses.append((got, want))
    param_err = max((a - b).abs().max().item() for a, b in
                    zip(tr.model.state_dict().values(), twin.model.state_dict().values()))
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    copies_current = all(
        t._copies is not None and all(torch.equal(c, t.model.get_parameter(n).detach().to(
            torch.bfloat16)) for n, c in t._copies.copies.items()) for t in (tr, twin))
    emit({'phase': 'train_parity', 'model': 'ecg-vit-base', 'dtype': 'bfloat16',
          'grad_accum': 2, 'steps': PARITY_STEPS, 'losses_kernel_plain': losses,
          'max_loss_rel_err': loss_err, 'loss_limit': LOSS_RTOL,
          'max_param_abs_err': param_err, 'param_limit': PARAM_TOL,
          'copy_leaves_per_update': len(tr._copies.copies) if tr._copies else 0,
          'copies_current': copies_current, 'param_cast_per_step': casts})
    if not (loss_err <= LOSS_RTOL and param_err <= PARAM_TOL and copies_current
            and casts == [0] * PARITY_STEPS):
        raise AssertionError(f'the copy route differs from the plain tail: losses {losses}, '
                             f'params {param_err}, copies current {copies_current}, '
                             f'parameter casts {casts}')
    del tr, twin
    torch.cuda.empty_cache()


def training_phase():
    """ViT-base training through kernels #2-#5 (``flash_min_seq=0`` and a
    blocked-backward threshold of 0, so every layer's forward is the lse
    kernel and its backward the dQ and dK/dV kernels).  Returns the kernel
    launches of the ``Trainer.train()`` run, the main path."""
    attn.BLOCKED_BWD_MIN_SEQ = 0
    stats = PTBXL_TRAIN_STATS['original']
    rng = np.random.default_rng(1)
    n = PARITY_STEPS * 64
    batch = SplitData(
        signals=(0.2 * rng.standard_normal((n, 12, 2500))).astype(np.float32),
        labels=(rng.uniform(size=(n, 71)) < 0.1).astype(np.float32))

    # 1. parity, f32, dropout off: kernels vs a plain twin from one init
    cfg = VitConfig.from_defined('base', flash_min_seq=0, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
    tcfg = TrainConfig(train_batch_size=64, log_to_console=False, save_final=False)
    tr = Trainer(cfg, tcfg, train_data=batch, norm_stats=stats)
    tr.init_state()
    twin = Trainer(dataclasses.replace(cfg, use_flash_attention=False), tcfg,
                   train_data=batch, norm_stats=stats)
    twin.set_params(tr.model.state_dict())
    twin.optimizer.tail = adamw.adamw_tail_reference
    per_step, losses = [], []
    for k in range(PARITY_STEPS):
        take = np.arange(64 * k, 64 * (k + 1))
        _build.reset_launches()
        got = float(tr.train_step(batch, take)['loss'])
        counts = _build.launch_counts()
        _build.reset_launches()
        want = float(twin.train_step(batch, take)['loss'])
        per_step.append(counts)
        losses.append((got, want))
    layers = cfg.num_hidden_layers
    expect = {'flash_fwd': 0, 'flash_fwd_lse': layers, 'flash_bwd_dq': layers,
              'flash_bwd_dkv': layers, 'adamw': 1, 'adamw_norm': 1, 'nlm_rows': 0,
              'nlm_variant': 0}
    param_err = max((a - b).abs().max().item() for a, b in
                    zip(tr.model.state_dict().values(), twin.model.state_dict().values()))
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    f32_rate = _steps_per_s(tr, batch, 5)
    emit({'phase': 'train_parity', 'model': 'ecg-vit-base', 'dtype': 'float32',
          'steps': PARITY_STEPS, 'losses_kernel_plain': losses,
          'max_loss_rel_err': loss_err, 'loss_limit': LOSS_RTOL,
          'max_param_abs_err': param_err, 'param_limit': PARAM_TOL,
          'launches_per_step': per_step, 'expected_per_step': expect,
          'train_samples_per_s_f32': f32_rate})
    if not all(_launched(c, expect) for c in per_step):
        raise AssertionError(f'train steps launched {per_step}, expected {expect} each')
    if not (loss_err <= LOSS_RTOL and param_err <= PARAM_TOL):
        raise AssertionError(f'kernel training differs from the plain twin: losses '
                             f'{losses}, params {param_err}')
    del tr, twin
    torch.cuda.empty_cache()
    copy_route_parity(cfg, tcfg, batch, stats)

    # 2. Trainer.train() on the hard corpus, bf16, dropout 0.1, TimeOut
    t0 = time.perf_counter()
    signals, labels, folds = synth_ptbxl(n=TRAIN_N, hard=True, n_marker_classes=16)
    synth_s = time.perf_counter() - t0
    splits = get_ptbxl_splits(signals, labels, folds)
    cfg16 = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16')
    out_dir = 'runs/chip_smoke_train'
    shutil.rmtree(out_dir, ignore_errors=True)
    tr = Trainer(cfg16, TrainConfig(num_train_epoch=2, train_batch_size=64,
                                    augment_timeout=True, log_to_console=False,
                                    save_final=False),
                 train_data=splits.train, eval_data=splits.eval, norm_stats=stats,
                 output_dir=out_dir)
    payloads = []
    log = tr._log
    tr._log = lambda payload: (payloads.append(payload), log(payload))
    _build.reset_launches()
    builds = adamw.adamw_kernel.table_builds
    t0 = time.perf_counter()
    result = tr.train()
    train_s = time.perf_counter() - t0
    launches = _build.launch_counts()     # the eval forwards add flash_fwd launches
    builds = adamw.adamw_kernel.table_builds - builds
    shutil.rmtree(out_dir, ignore_errors=True)
    train_losses = [p['train/loss'] for p in payloads if 'train/loss' in p]
    aucs = [h['macro_auc'] for h in result['history']]
    steps = tr.step
    summary = {'phase': 'train', 'model': 'ecg-vit-base', 'dtype': 'bfloat16',
               'corpus': f'synth_ptbxl(n={TRAIN_N}, hard=True, n_marker_classes=16)',
               'corpus_seconds': synth_s, 'train_rows': len(splits.train),
               'eval_rows': len(splits.eval), 'epochs': result['epochs'],
               'steps': steps, 'train_seconds': train_s, 'launches': launches,
               'copy_leaves_per_update': len(tr._copies.copies) if tr._copies else 0,
               'adamw_copy_leaves': adamw.adamw_kernel.copy_leaves,
               'adamw_table_builds': builds, 'train_losses': train_losses,
               'eval_losses': [h['loss'] for h in result['history']],
               'eval_macro_auc': aucs,
               'train_samples_per_s_bf16': _steps_per_s(tr, splits.train, 10)}
    emit(summary)
    want = {'flash_fwd_lse': layers * steps, 'flash_bwd_dq': layers * steps,
            'flash_bwd_dkv': layers * steps, 'adamw': steps, 'adamw_norm': steps,
            # every Bernoulli site of a block, once each way a step; eval draws none
            'gelu_dropout': layers * steps, 'gelu_dropout_bwd': layers * steps,
            'dropout_add': 2 * layers * steps, 'dropout_add_bwd': 2 * layers * steps,
            # every bf16 Linear reads its compute copy: no parameter cast
            'param_cast': 0}
    if not (len(train_losses) == steps == 2 * tr.steps_per_epoch
            and summary['copy_leaves_per_update'] == summary['adamw_copy_leaves']
            == 2 + 7 * layers
            and all(np.isfinite(train_losses)) and aucs[-1] is not None
            and np.isfinite(aucs[-1])
            and _launched(launches, want)):
        raise AssertionError(f'training run failed (launches expected {want}): {summary}')
    emit(profile_train_step(tr, splits.train))
    # the update tail of one step alone: FusedAdamW's norm and update
    # launches and the copy of [lr, bc1, bc2], nothing else
    tail = {'phase': 'train_tail', 'model': 'ecg-vit-base', 'dtype': 'bfloat16',
            **adamw_probe.tail_profile(tr, splits.train, np.arange(64)),
            'adamw_table_builds_in_train': builds}
    emit(tail)
    if not (1 <= tail['tail_kernel_launches'] <= 2 and tail['tail_copies'] <= 1):
        raise AssertionError(f'the update tail is more than 2 launches and 1 copy: {tail}')
    return {k: launches[k] for k in want}


def _pretrainer(objective: str, cfg: VitConfig, tcfg: TrainConfig, **kw):
    if objective == 'mae':
        return MaeTrainer(cfg, MaeConfig(), tcfg, **kw)
    return ContrastiveTrainer(cfg, ContrastiveConfig(), tcfg, **kw)


def _pretrain_expect(objective: str, cfg: VitConfig) -> dict:
    """Launches of one step: a forward (lse), dQ and dK/dV per attention
    layer -- the encoder's, and for MAE the decoder's -- and #5's norm and
    update launches."""
    layers = cfg.num_hidden_layers + (MaeConfig().decoder_num_layers
                                      if objective == 'mae' else 0)
    return {'flash_fwd': 0, 'flash_fwd_lse': layers, 'flash_bwd_dq': layers,
            'flash_bwd_dkv': layers, 'adamw': 1, 'adamw_norm': 1, 'nlm_rows': 0,
              'nlm_variant': 0}


def pretrain_parity(objective: str, stats) -> None:
    """Three f32 steps (TF32 off, dropout 0) of the pretrainer against a
    plain twin (plain attention, plain AdamW) from one init; both draw the
    same mask noise or views from generators in the same state, which each
    step checks.  Fails on a loss, a parameter or a launch count off."""
    rng = np.random.default_rng(2)
    n = PARITY_STEPS * 64
    batch = SplitData(signals=(0.2 * rng.standard_normal((n, 12, 2500))).astype(np.float32),
                      labels=np.zeros((n, 1), np.float32))
    cfg = VitConfig.from_defined('base', flash_min_seq=0, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
    tcfg = TrainConfig(train_batch_size=64, log_to_console=False, save_final=False)
    tr = _pretrainer(objective, cfg, tcfg, train_data=batch, norm_stats=stats)
    tr.init_state()
    twin = _pretrainer(objective, dataclasses.replace(cfg, use_flash_attention=False), tcfg,
                       train_data=batch, norm_stats=stats)
    twin.set_params(tr.model.state_dict())
    twin.optimizer.tail = adamw.adamw_tail_reference
    per_step, losses, same_draws = [], [], []
    for k in range(PARITY_STEPS):
        same_draws.append(bool(torch.equal(tr.rng.device.get_state(),
                                           twin.rng.device.get_state())))
        take = np.arange(64 * k, 64 * (k + 1))
        _build.reset_launches()
        got = tr.train_step(batch, take)
        got = {key: float(v) for key, v in got.items()}
        counts = _build.launch_counts()
        _build.reset_launches()
        want = {key: float(v) for key, v in twin.train_step(batch, take).items()}
        per_step.append(counts)
        losses.append((got['loss'], want['loss']))
    expect = _pretrain_expect(objective, cfg)
    param_err = max((a - b).abs().max().item() for a, b in
                    zip(tr.model.state_dict().values(), twin.model.state_dict().values()))
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    row = {'phase': 'pretrain_parity', 'objective': objective, 'model': 'ecg-vit-base',
           'dtype': 'float32', 'steps': PARITY_STEPS, 'losses_kernel_plain': losses,
           'max_loss_rel_err': loss_err, 'loss_limit': LOSS_RTOL,
           'max_param_abs_err': param_err, 'param_limit': PARAM_TOL,
           'same_draws_each_step': same_draws, 'launches_per_step': per_step,
           'expected_per_step': expect,
           'train_samples_per_s_f32': _steps_per_s(tr, batch, 5)}
    emit(row)
    if not all(_launched(c, expect) for c in per_step):
        raise AssertionError(f'{objective} steps launched {per_step}, expected {expect} each')
    if not (all(same_draws) and loss_err <= LOSS_RTOL and param_err <= PARAM_TOL):
        raise AssertionError(f'{objective} pretraining differs from the plain twin: {row}')


def _handoff(objective: str, ckpt: str, splits, stats) -> dict:
    """``load_any_encoder`` of the pretrain checkpoint into a fresh ViT-base:
    the trunk must equal the checkpoint's bit for bit (for MAE its position
    embeddings at rows 1..P); then one epoch of the linear probe, after which
    the trunk's bits are unchanged and the head has moved."""
    cfg16 = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16')
    out_dir = f'runs/chip_smoke_probe_{objective}'
    shutil.rmtree(out_dir, ignore_errors=True)
    vit = Trainer(cfg16, TrainConfig(num_train_epoch=1, train_batch_size=64, linear_probe=True,
                                     log_to_console=False, save_final=False),
                  train_data=splits.train, eval_data=splits.eval, norm_stats=stats,
                  output_dir=out_dir)
    fresh = vit.init_state()
    merged = load_any_encoder(ckpt, fresh)
    saved = checkpoint.restore_checkpoint(ckpt)['params']
    if objective == 'mae':
        names = {'encoder.patch_embed.': 'encoder_patch_embed.',
                 'encoder.blocks.': 'encoder_blocks.', 'encoder.final_norm.': 'encoder_norm.'}
        src = {k: next(v + k[len(p):] for p, v in names.items() if k.startswith(p))
               for k in merged if k.startswith(tuple(names))}
        pos = merged['encoder.pos_embed'].cpu()
        trunk_ok = (torch.equal(pos[:, 1:], saved['encoder_pos_embed'])
                    and torch.equal(pos[:, :1], fresh['encoder.pos_embed'][:, :1].cpu()))
    else:
        src = {k: k for k in merged if k.startswith('encoder.')}
        trunk_ok = True
    trunk_ok = trunk_ok and all(torch.equal(merged[k].cpu(), saved[v]) for k, v in src.items())
    vit.set_params(merged)
    before = {k: v.clone() for k, v in vit.model.state_dict().items()}
    _build.reset_launches()
    t0 = time.perf_counter()
    vit.train()
    probe_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    after = vit.model.state_dict()
    frozen = all(torch.equal(after[k], v) for k, v in before.items() if 'head' not in k)
    head_moved = all(not torch.equal(after[k], before[k]) for k in ('head.weight', 'head.bias'))
    test = vit.evaluate(splits.test)
    shutil.rmtree(out_dir, ignore_errors=True)
    row = {'phase': 'pretrain_handoff', 'objective': objective, 'checkpoint': ckpt,
           'trunk_tensors': len(src) + (objective == 'mae'), 'trunk_bits_equal': trunk_ok,
           'probe_steps': vit.step, 'probe_seconds': probe_s, 'probe_launches': launches,
           'trunk_frozen': frozen, 'head_moved': head_moved,
           'probe_test_macro_auc_smoke': test['macro_auc']}
    emit(row)
    if not (trunk_ok and frozen and head_moved and launches['flash_bwd_dq'] > 0
            and launches['adamw'] == launches['adamw_norm'] == 0
            and np.isfinite(test['loss'])):
        raise AssertionError(f'{objective} handoff failed: {row}')
    return launches


def pretrain_phase():
    """Self-supervised pretraining of ViT-base through kernels #1-#5, MAE
    then contrastive: parity against a plain twin in f32, then ``train()``
    in bf16 with dropout 0.1 for one epoch with eval on the hard corpus
    (launches per step checked, a profiled step), then the handoff of the
    final checkpoint into a linear probe.  Returns the kernel launches of
    the ``train()`` runs and the probes, the main path."""
    attn.BLOCKED_BWD_MIN_SEQ = 0
    stats = PTBXL_TRAIN_STATS['original']
    signals, labels, folds = synth_ptbxl(n=TRAIN_N, hard=True, n_marker_classes=16)
    splits = get_ptbxl_splits(signals, labels, folds)
    cfg16 = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16')
    total = {}
    for objective in ('mae', 'contrastive'):
        pretrain_parity(objective, stats)
        torch.cuda.empty_cache()
        out_dir = f'runs/chip_smoke_{objective}'
        shutil.rmtree(out_dir, ignore_errors=True)
        tr = _pretrainer(objective, cfg16, TrainConfig(num_train_epoch=1, train_batch_size=64,
                                                       log_to_console=False),
                         train_data=splits.train, eval_data=splits.eval, norm_stats=stats,
                         output_dir=out_dir)
        payloads = []
        log = tr._log
        tr._log = lambda payload: (payloads.append(payload), log(payload))
        _build.reset_launches()
        t0 = time.perf_counter()
        result = tr.train()
        train_s = time.perf_counter() - t0
        launches = _build.launch_counts()          # the eval forwards add flash_fwd launches
        steps = tr.step
        expect = {k: v * steps for k, v in _pretrain_expect(objective, cfg16).items()
                  if k != 'flash_fwd'}
        row = {'phase': 'pretrain', 'objective': objective, 'model': 'ecg-vit-base',
               'dtype': 'bfloat16', 'dropout': 0.1,
               'corpus': f'synth_ptbxl(n={TRAIN_N}, hard=True, n_marker_classes=16)',
               'train_rows': len(splits.train), 'eval_rows': len(splits.eval),
               'epochs': result['epochs'], 'steps': steps, 'train_seconds': train_s,
               'train_losses': [p['pretrain/loss'] for p in payloads if 'pretrain/loss' in p],
               'eval_loss': result['best_eval_loss'], 'launches': launches,
               'launches_per_step': {k: launches[k] / steps for k in expect},
               'train_samples_per_s_bf16': _steps_per_s(tr, splits.train, 10)}
        if objective == 'contrastive':
            sigs, idx = tr._sig_inputs(splits.eval, np.arange(min(64, len(splits.eval))))
            row['eval_contrast_acc'] = float(tr.eval_batch(
                sigs.index_select(0, idx), torch.Generator(device=DEV).manual_seed(0))[1])
            row['train_contrast_acc'] = [p['pretrain/contrast_acc'] for p in payloads
                                         if 'pretrain/contrast_acc' in p]
        emit(row)
        if not (steps == tr.steps_per_epoch and np.isfinite(row['eval_loss'])
                and all(np.isfinite(row['train_losses']))
                and _launched(launches, expect) and launches['flash_fwd'] > 0):
            raise AssertionError(f'{objective} pretraining run failed (launches expected '
                                 f'{expect}): {row}')
        emit(profile_train_step(tr, splits.train, kind=f'{objective} pretrain'))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        probe = _handoff(objective, result['checkpoint'], splits, stats)
        for k, v in probe.items():
            total[k] = total.get(k, 0) + v
        shutil.rmtree(out_dir, ignore_errors=True)
        del tr
        torch.cuda.empty_cache()
    return total


def _post(port: int, payload) -> dict:
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/predict', data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


PROFILE_MARGIN_S = 0.02   # idle seconds before and after a profiled run
# substrings of the port's kernel symbols, for the profiles' ``port_kernels``
PORT_KERNEL_SYMBOLS = ('flash_fwd_', 'bwd_dq_', 'bwd_dkv_', 'adamw_', 'nlm_')
# the host's runtime calls that launch kernels, or a whole CUDA graph
HOST_LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                     'cuLaunchKernelEx', 'cudaGraphLaunch')


def _profile(what: str, unit: str, n: int, run) -> dict:
    """Profile ``run()``, which does ``n`` units of work ending in a host
    fetch: wall time, summed device time, the device's busy share, the
    kernels that take the most device time, the port's own kernels, the
    host's kernel and graph launch calls (a CUDA graph's replay is one call
    for all its kernels), and the host operators that take the most CPU time
    of their own (the profiler adds to the latter)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # idle margins: the profile of a 2 ms step once came back without its
        # one kernel, and another without 37 of a step's 665 launches
        time.sleep(PROFILE_MARGIN_S)
        wall = _wall(run)
        time.sleep(PROFILE_MARGIN_S)
    events = prof.key_averages()
    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same device time again
    kernels = [(e.key, e.self_device_time_total, e.count) for e in events
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda k: -k[1])[:10]
    launch_calls = {e.key: e.count / n for e in events
                    if e.device_type == DeviceType.CPU and e.key in HOST_LAUNCH_CALLS}
    return {'phase': 'profile', 'what': what,
            f'wall_ms_per_{unit}': 1e3 * wall / n,
            f'device_ms_per_{unit}': device_us / 1e3 / n,
            'device_busy_share': device_us / 1e6 / wall,
            f'device_launches_per_{unit}': sum(c for _, _, c in kernels) / n,
            f'host_launch_calls_per_{unit}': launch_calls,
            'top_kernels': [{'name': k[:90], f'ms_per_{unit}': t / 1e3 / n,
                             f'launches_per_{unit}': c / n} for k, t, c in top],
            'port_kernels': [{'name': k[:90], f'ms_per_{unit}': t / 1e3 / n,
                              f'launches_per_{unit}': c / n} for k, t, c in kernels
                             if any(sym in k for sym in PORT_KERNEL_SYMBOLS)],
            'top_host_ops': [{'name': k[:60], f'self_cpu_ms_per_{unit}': t / 1e3 / n,
                              f'calls_per_{unit}': c / n} for k, t, c in host]}


def profile_predict(tr: Trainer, batch: np.ndarray, calls: int = 3) -> dict:
    """Where a bs-64 ``predict`` spends its time (see ``_profile``)."""
    tr.predict(batch)
    return _profile(f'bs-64 predict, {calls} calls', 'call', calls,
                    lambda: [tr.predict(batch) for _ in range(calls)])


def _twin(tr: Trainer, flash: bool) -> Trainer:
    """A trainer with ``tr``'s weights and inference settings, attention on
    the kernel (``flash``) or on the plain path."""
    cfg = dataclasses.replace(tr.model_cfg, use_flash_attention=flash)
    twin = Trainer(cfg, tr.cfg, norm_stats={'mean': tr.mean.tolist(), 'std': tr.std.tolist()})
    twin.set_params(tr.model.state_dict())
    return twin


def serving_phase():
    """ViT-base behind the HTTP server; returns (summary, kernel launches)."""
    cfg = VitConfig.from_defined('base', flash_min_seq=0)
    tr = Trainer(cfg, TrainConfig(), norm_stats=PTBXL_TRAIN_STATS['original'])
    tr.init_state()
    rng = np.random.default_rng(0)
    # batch-1 10 s records at 250 Hz, plus one 20 s record that predict_long
    # cuts into 4 windows; raw-scale amplitudes (~0.2 mV)
    inputs = [(0.2 * rng.standard_normal((1, 12, 2500))).astype(np.float32)
              for _ in range(N_CLIENTS - 1)]
    inputs.append((0.2 * rng.standard_normal((1, 12, 5000))).astype(np.float32))

    httpd = serve(tr, port=0)          # warms up with one request
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    got, latency, errors = [None] * N_CLIENTS, [None] * N_CLIENTS, []
    barrier = threading.Barrier(N_CLIENTS)

    def client(i):
        try:
            barrier.wait(timeout=60)
            t0 = time.perf_counter()
            out = _post(port, {'signals': inputs[i].tolist(), 'top_k': 5})
            latency[i] = (time.perf_counter() - t0) * 1e3
            got[i] = np.asarray(out['probs'], np.float32)
        except Exception as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)

    try:
        batcher = httpd.service.batcher
        d0, r0 = batcher.dispatches, batcher.requests
        before = _build.launch_counts()['flash_fwd']
        clients = [threading.Thread(target=client, args=(i,)) for i in range(N_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        launches = _build.launch_counts()['flash_fwd'] - before
        dispatches, requests = batcher.dispatches - d0, batcher.requests - r0
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()
        server.join(timeout=60)
    if errors or any(c.is_alive() for c in clients):
        raise RuntimeError(f'serving requests failed: {errors}')
    if requests != N_CLIENTS or launches < cfg.num_hidden_layers * dispatches or launches == 0:
        raise AssertionError(f'{requests} requests, {dispatches} dispatches, '
                             f'{launches} flash launches: the path skipped the kernel')

    plain = _twin(tr, flash=False)
    err_self = err_plain = 0.0
    for x, probs in zip(inputs, got):
        if probs.shape != (1, cfg.num_class) or not np.isfinite(probs).all():
            raise AssertionError(f'bad response rows: {probs.shape}')
        # the server rounds to 6 decimals; the batch around a row never
        # changes its value, so the row equals its own predict_long
        err_self = max(err_self, float(np.abs(probs - np.round(tr.predict_long(x), 6)).max()))
        err_plain = max(err_plain, float(np.abs(probs - plain.predict_long(x)).max()))
    if err_self > 2e-6 or err_plain > SERVING_TOL:
        raise AssertionError(f'serving rows differ: own input {err_self}, '
                             f'plain attention {err_plain}')

    batch = (0.2 * rng.standard_normal((64, 12, 2500))).astype(np.float32)
    seconds = {'kernel': 0.0, 'plain': 0.0}
    tr.predict(batch)
    plain.predict(batch)
    for name, t in (('kernel', tr), ('plain', plain), ('plain', plain), ('kernel', tr)):
        t0 = time.perf_counter()
        for _ in range(10):
            t.predict(batch)           # returns host arrays: synchronized
        seconds[name] += time.perf_counter() - t0
    rate = {name: 20 * 64 / s for name, s in seconds.items()}
    batch1_ms = 1e3 * min(_wall(lambda: tr.predict(inputs[0])) for _ in range(5))
    body = json.dumps({'signals': inputs[0].tolist()})
    decode_ms = 1e3 * min(_wall(lambda: np.asarray(json.loads(body)['signals'], np.float32))
                          for _ in range(5))

    summary = {'phase': 'serving', 'model': 'ecg-vit-base', 'dtype': 'float32',
               'requests': requests, 'dispatches': dispatches,
               'flash_launches': launches,
               'p50_latency_ms': float(np.median(latency)),
               'max_latency_ms': float(max(latency)),
               'max_abs_err_vs_own_predict_long': err_self,
               'max_abs_err_vs_plain_attention': err_plain, 'limit': SERVING_TOL,
               'bs64_predict_samples_per_s': rate['kernel'],
               'bs64_predict_samples_per_s_plain_attention': rate['plain'],
               'batch1_predict_ms': batch1_ms,
               'request_json_decode_ms': decode_ms}
    emit(summary)
    emit(profile_predict(tr, batch))

    # bf16 Linear layers (--bf16): the kernel against plain attention
    cfg16 = dataclasses.replace(cfg, dtype='bfloat16')
    tr16 = Trainer(cfg16, tr.cfg, norm_stats={'mean': tr.mean.tolist(),
                                              'std': tr.std.tolist()})
    tr16.set_params(tr.model.state_dict())
    want16 = _twin(tr16, flash=False).predict(batch[:8])
    err16 = float(np.abs(tr16.predict(batch[:8]) - want16).max())
    emit({'phase': 'serving_bf16', 'max_abs_err_vs_plain_attention': err16,
          'limit': BF16_TOL})
    if not err16 <= BF16_TOL:
        raise AssertionError(f'bf16 predict differs from plain attention by {err16}')
    return summary, launches


def _samples_per_s(fn, n_samples: int, reps: int = 5) -> float:
    """``n_samples`` per call of ``fn`` (which returns host arrays, so the
    device has finished) over ``reps`` calls after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return reps * n_samples / (time.perf_counter() - t0)


def _corpus_device(smi: str):
    """``synth_ptbxl_device`` at PTB-XL scale, twice (the same bits), and at
    n = 512 against the host generator's hard corpus."""
    small, _, _ = synth_ptbxl_device(n=CORPUS_STD_N, n_marker_classes=16)   # warm-up
    host, _, _ = synth_ptbxl(n=CORPUS_STD_N, hard=True, n_marker_classes=16)
    std_rel = abs(float(small.std()) - float(host.std())) / float(host.std())
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = synth_ptbxl_device(n=CORPUS_N, n_marker_classes=16)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, out))
    (s1, (signals, labels, folds)), (s2, (again, labels2, folds2)) = runs
    same = (bool(torch.equal(signals, again)) and labels == labels2
            and bool((folds == folds2).all()))
    del runs, again
    row = {'phase': 'corpus_device', 'nvidia_smi': smi, 'n': CORPUS_N,
           'shape': list(signals.shape), 'device': str(signals.device),
           'bytes': signals.numel() * signals.element_size(),
           'seconds': [s1, s2], 'records_per_s': [CORPUS_N / s1, CORPUS_N / s2],
           'finite': bool(torch.isfinite(signals).all()), 'std': float(signals.std()),
           'std_n512_device_host': [float(small.std()), float(host.std())],
           'std_rel_diff': std_rel, 'std_limit': CORPUS_STD_RTOL, 'same_bits_twice': same}
    emit(row)
    if not (row['finite'] and same and signals.device.type == DEV
            and std_rel < CORPUS_STD_RTOL):
        raise AssertionError(f'device corpus failed: {row}')
    return signals, labels, folds


def _corpus_resident(splits, cfg16: VitConfig, stats, smi: str) -> None:
    """``RESIDENT_STEPS`` bf16 steps from one seed with the resident split
    stored in f32, f16 and bf16; the f16 run's eval loss must stay within
    ``RESIDENT_RTOL`` of the f32 run's."""
    eval_data = SplitData(signals=splits.eval.signals[:RESIDENT_EVAL_N],
                          labels=splits.eval.labels[:RESIDENT_EVAL_N])
    take = np.random.default_rng(0).permutation(len(splits.train))
    rows = {}
    for dtype in (None, 'float16', 'bfloat16'):
        tr = Trainer(cfg16, TrainConfig(train_batch_size=64, log_to_console=False,
                                        save_final=False, resident_dtype=dtype),
                     train_data=splits.train, eval_data=eval_data, norm_stats=stats)
        tr.init_state()
        losses = [float(tr.train_step(splits.train, take[:64])['loss'])]
        t0 = time.perf_counter()
        for i in range(1, RESIDENT_STEPS):
            m = tr.train_step(splits.train, take[64 * i:64 * (i + 1)])
        losses.append(float(m['loss']))
        seconds = time.perf_counter() - t0
        sigs, labs = tr._split_arrays(splits.train)
        rows[str(dtype)] = row = {
            'storage_dtype': str(sigs.dtype), 'labels_dtype': str(labs.dtype),
            'resident_bytes': sigs.numel() * sigs.element_size()
            + labs.numel() * labs.element_size(),
            'train_samples_per_s_bf16': (RESIDENT_STEPS - 1) * 64 / seconds,
            'first_last_loss': losses, 'eval_loss': tr.evaluate(eval_data)['loss']}
        want = RESIDENT_DTYPES[dtype]
        if not (sigs.dtype == want and labs.dtype == torch.float32 and sigs.device.type == DEV
                and tr.step == RESIDENT_STEPS and np.isfinite(row['eval_loss'])):
            raise AssertionError(f'resident {dtype} run failed: {row}')
        del tr, sigs, labs
        torch.cuda.empty_cache()
    rel = abs(rows['float16']['eval_loss'] - rows['None']['eval_loss']) / rows['None']['eval_loss']
    emit({'phase': 'corpus_resident', 'nvidia_smi': smi, 'model': 'ecg-vit-base',
          'dtype': 'bfloat16', 'steps': RESIDENT_STEPS, 'train_rows': len(splits.train),
          'eval_rows': len(eval_data), 'runs': rows, 'f16_eval_loss_rel_diff': rel,
          'limit': RESIDENT_RTOL})
    if not rel <= RESIDENT_RTOL:
        raise AssertionError(f'f16 storage moved the eval loss by {rel} (limit {RESIDENT_RTOL})')


def _corpus_reference(stats) -> Trainer:
    """A seeded reference-layout ViT-base, written as a vit-pytorch 0.33.2
    ``.pt`` and read back through the CLI's ``_maybe_port``: every parameter
    must equal its source bit for bit.  Returns the ported trainer (f32)."""
    ref_cfg = reference_vit_config('base', flash_min_seq=0)
    src = Trainer(ref_cfg, TrainConfig(log_to_console=False), norm_stats=stats)
    src.init_state()
    out_dir = 'runs/chip_smoke_corpus'
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, 'reference.pt')
    sd = export_vit_pytorch_state_dict(src.model.state_dict(), ref_cfg)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    tr = Trainer(ref_cfg, TrainConfig(log_to_console=False), norm_stats=stats)
    tr.init_state(seed=1)
    t0 = time.perf_counter()
    ecg_cli._maybe_port(argparse.Namespace(port_checkpoint=path), tr)
    load_s = time.perf_counter() - t0
    shutil.rmtree(out_dir, ignore_errors=True)
    want = src.model.state_dict()
    got = tr.model.state_dict()
    equal = set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    row = {'phase': 'corpus_reference_weights', 'tensors': len(sd),
           'pt_bytes': sum(v.nbytes for v in sd.values()), 'load_seconds': load_s,
           'bits_equal': equal}
    emit(row)
    if not equal:
        raise AssertionError(f'the ported reference weights differ from the source: {row}')
    return tr


def _corpus_int8(tr: Trainer, test_x: np.ndarray, smi: str):
    """int8 inference of the ported ViT-base: compression, bs-64 predict on
    the kernel path against a plain twin with the same int8 weights and
    against f32, and the samples/s of each.  Returns the int8 trainers."""
    q8 = _twin(tr, flash=True)
    summary = q8.enable_int8_inference()
    plain8 = _twin(tr, flash=False)
    plain8.enable_int8_inference()
    same_int8 = all(torch.equal(q8._int8[part][k], plain8._int8[part][k])
                    for part in ('qweights', 'scales') for k in q8._int8[part])
    before = _build.launch_counts()['flash_fwd']
    p8 = q8.predict(test_x)
    launches = _build.launch_counts()['flash_fwd'] - before
    err_plain = float(np.abs(p8 - plain8.predict(test_x)).max())
    p32 = tr.predict(test_x)
    err_f32 = float(np.abs(p8 - p32).max())
    rate = {'f32': 0.0, 'int8': 0.0}
    for name, t in (('f32', tr), ('int8', q8), ('int8', q8), ('f32', tr)):
        rate[name] += _samples_per_s(lambda: t.predict(test_x), len(test_x)) / 2
    row = {'phase': 'corpus_int8', 'nvidia_smi': smi,
           'model': 'ecg-vit-base (reference layout)',
           'dtype': 'float32', **summary, 'quantized_leaves': len(q8._int8['qweights']),
           'twins_same_int8': same_int8, 'flash_launches': launches,
           'max_abs_err_vs_plain_attention': err_plain, 'limit': SERVING_TOL,
           'max_abs_err_vs_f32': err_f32, 'f32_limit': INT8_TOL,
           'top1_agreement_vs_f32': float((p8.argmax(1) == p32.argmax(1)).mean()),
           'bs64_predict_samples_per_s_int8': rate['int8'],
           'bs64_predict_samples_per_s_f32': rate['f32']}
    emit(row)
    if not (summary['compression'] > 2 and same_int8 and err_plain <= SERVING_TOL
            and err_f32 < INT8_TOL and launches == tr.model_cfg.num_hidden_layers
            and p8.shape == (len(test_x), tr.model_cfg.num_class)):
        raise AssertionError(f'int8 inference failed: {row}')
    return q8, plain8


def _corpus_infer(q8: Trainer, plain8: Trainer, smi: str) -> None:
    """``cli.infer_records`` (the body of ``cli infer``) on 20 s records,
    which ``predict_long`` cuts into windows, int8 on the kernel path and on
    the plain twin: the same codes in the same order, probabilities within
    ``SERVING_TOL``."""
    records, _, _ = synth_ptbxl_device(n=INFER_N, length=2 * DENOISE_LEN, seed=5,
                                       n_marker_classes=16)
    records = records.cpu().numpy()        # what `cli infer` reads from its HDF5
    got = ecg_cli.infer_records(q8, records, top_k=5)
    want = ecg_cli.infer_records(plain8, records, top_k=5)
    codes = [[c['code'] for c in r['top']] for r in got['records']]
    same_codes = codes == [[c['code'] for c in r['top']] for r in want['records']]
    err = max(abs(a['prob'] - b['prob']) for r, w in zip(got['records'], want['records'])
              for a, b in zip(r['top'], w['top']))
    rate = _samples_per_s(lambda: ecg_cli.infer_records(q8, records, top_k=5), INFER_N)
    row = {'phase': 'corpus_infer', 'nvidia_smi': smi, 'records': INFER_N,
           'record_shape': list(records.shape[1:]), 'int8': True, 'top_k': 5,
           'same_codes_same_order': same_codes, 'max_abs_prob_err': err,
           'limit': SERVING_TOL, 'records_per_s': rate, 'first_record': got['records'][0]}
    emit(row)
    if not (same_codes and err <= SERVING_TOL and got['n_records'] == INFER_N):
        raise AssertionError(f'infer differs between the kernel and plain paths: {row}')


def corpus_phase(smi: str):
    """The disk-corpus slice on the card (no h5py there, so its array
    paths): the device corpus at PTB-XL scale, ViT-base bf16 steps on it
    resident in f32, f16 and bf16, the reference weights through
    ``--port-checkpoint``'s loader, int8 inference, and ``cli infer``'s
    body.  Returns the kernel launches of the phase."""
    attn.BLOCKED_BWD_MIN_SEQ = 0
    stats = PTBXL_TRAIN_STATS['original']
    _build.reset_launches()
    signals, labels, folds = _corpus_device(smi)
    splits = get_ptbxl_splits(signals, labels, folds)
    del signals
    test_x = splits.test.signals[:64].cpu().numpy()
    cfg16 = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16')
    _corpus_resident(splits, cfg16, stats, smi)
    del splits
    torch.cuda.empty_cache()
    tr = _corpus_reference(stats)
    q8, plain8 = _corpus_int8(tr, test_x, smi)
    _corpus_infer(q8, plain8, smi)
    launches = _build.launch_counts()
    per_layer = 3 * RESIDENT_STEPS * cfg16.num_hidden_layers     # three storage dtypes
    expect = {'flash_fwd_lse': per_layer, 'flash_bwd_dq': per_layer,
              'flash_bwd_dkv': per_layer, 'adamw': 3 * RESIDENT_STEPS,
              'adamw_norm': 3 * RESIDENT_STEPS}
    emit({'phase': 'corpus', 'launches': launches, 'expected_training': expect})
    if not (_launched(launches, expect) and launches['flash_fwd'] > 0):
        raise AssertionError(f'corpus phase launched {launches}, expected {expect} and #1')
    del tr, q8, plain8
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ('flash_fwd', *expect)}


def _write_wfdb_record(rec_dir: str, ecg_id: int, sig_phys: np.ndarray) -> None:
    """One fmt-16 WFDB record in PTB-XL's naming (records500/..._hr.dat):
    the layout of tests/test_raw_tree_integration.py's writer."""
    name = f'{ecg_id:05d}_hr'
    c, length = sig_phys.shape
    dig = np.round(sig_phys * STREAM_GAIN).astype(np.int16)
    with open(os.path.join(rec_dir, f'{name}.dat'), 'wb') as f:
        f.write(dig.T.reshape(-1).astype('<i2').tobytes())
    lines = [f'{name} {c} {STREAM_TREE[2]} {length}']
    lines += [f'{name}.dat 16 {STREAM_GAIN:g}(0)/mV 16 0 0 0 0 lead{i}' for i in range(c)]
    with open(os.path.join(rec_dir, f'{name}.hea'), 'w') as f:
        f.write('\n'.join(lines) + '\n')


def _read_all(paths, use_native: bool):
    """Every record of ``paths`` through ``_batch_reader`` (the native batch
    reader, or the numpy path), stacked, and the seconds it took."""
    t0 = time.perf_counter()
    if use_native:
        n, read = data_export._batch_reader('PTB-XL', paths)
        batch = read(0, n)
    else:
        with native.disabled():
            n, read = data_export._batch_reader('PTB-XL', paths)
            batch = read(0, n)
    return np.stack(batch), time.perf_counter() - t0


def _stream_ingest(root: str, smi: str) -> np.ndarray:
    """The WFDB tree read through ``_batch_reader`` by the native library and
    by the numpy path (bit-equal), records/s of each, in turns."""
    n, length, fqs = STREAM_TREE
    rec_dir = os.path.join(root, 'PTB-XL', 'records500', '00000')
    os.makedirs(rec_dir)
    rng = np.random.default_rng(STREAM_SEED)
    for ecg_id in range(1, n + 1):
        _write_wfdb_record(rec_dir, ecg_id,
                           rng.normal(0, 0.4, (12, length)).astype(np.float32))
    paths = data_export.get_rec_paths('PTB-XL', root)
    t0 = time.perf_counter()
    available = native.native_available()      # builds the library
    build_s = time.perf_counter() - t0
    _read_all(paths, False)                    # warm the page cache
    seconds = {True: [], False: []}
    for use_native in (True, False, False, True):
        batch, sec = _read_all(paths, use_native)
        seconds[use_native].append(sec)
        if use_native:
            fast = batch
        else:
            slow = batch
    equal = fast.dtype == slow.dtype == np.float32 and fast.tobytes() == slow.tobytes()
    row = {'phase': 'stream_ingest', 'nvidia_smi': smi, 'records': n,
           'record_shape': [12, length], 'fqs': fqs, 'native_available': available,
           'native_build_s': build_s, 'native_equals_numpy_bits': equal,
           'native_seconds': seconds[True], 'numpy_seconds': seconds[False],
           'native_records_per_s': n / np.mean(seconds[True]),
           'numpy_records_per_s': n / np.mean(seconds[False])}
    emit(row)
    if not (available and equal and len(paths) == n):
        raise AssertionError(f'ingest failed (native against numpy): {row}')
    return fast


def _stream_export(records: np.ndarray, smi: str) -> None:
    """``export_combined``'s per-batch body (FFT resample 500 -> 250 Hz) on
    the card against the same body on the CPU; records/s on the card."""
    chunk = list(records)
    n, length, fqs = STREAM_TREE
    tgt = length * 250 // fqs
    want = data_export.resample_chunk(chunk, fqs, 250, tgt, device='cpu')
    got = data_export.resample_chunk(chunk, fqs, 250, tgt, device=DEV)   # warm-up
    t0 = time.perf_counter()
    for _ in range(3):
        got = data_export.resample_chunk(chunk, fqs, 250, tgt, device=DEV)
    sec = (time.perf_counter() - t0) / 3
    err = float(np.abs(got - want).max() / np.abs(want).max())
    row = {'phase': 'stream_export', 'nvidia_smi': smi, 'records': n,
           'in_shape': [n, 12, length], 'out_shape': list(got.shape),
           'max_abs_err_over_max_vs_cpu': err, 'limit': EXPORT_LIMIT,
           'seconds_per_batch': sec, 'records_per_s': n / sec}
    emit(row)
    if not (err <= EXPORT_LIMIT and got.shape == (n, 12, tgt) and np.isfinite(got).all()):
        raise AssertionError(f'export body on the card differs from the CPU: {row}')


class _ArrayShards(ShardedRecordStream):
    """Shards held in memory (the card's machine has no h5py): a path names
    an array of ``SHARDS``."""
    SHARDS = {}

    def _load_shard(self, path):
        return self.SHARDS[path]


class _ArrayMix(MixedRecordStream):
    stream_cls = _ArrayShards


def _stream_corpora(tree: np.ndarray):
    """Two corpora of two int16 shards each: the tree at 500 Hz, a
    CODE-TEST-shaped bulk at 400 Hz."""
    n, length, _ = STREAM_BULK
    bulk = np.random.default_rng(STREAM_SEED + 1).normal(0, 0.4, (n, 12, length))
    corpora = []
    for name, recs in (('ptbxl', tree), ('code-test', bulk.astype(np.float32))):
        wire = data_export.wire_chunk(list(recs), recs.shape[-1], 'int16', STREAM_WIRE_SCALE)
        half = len(wire) // 2
        _ArrayShards.SHARDS[f'{name}-0'], _ArrayShards.SHARDS[f'{name}-1'] = (
            wire[:half], wire[half:])
        corpora.append([f'{name}-0', f'{name}-1'])
    return corpora


def _mix_replay(steps: int):
    rng = np.random.default_rng(STREAM_SEED)
    draws = [int(rng.choice(2, p=np.asarray(STREAM_WEIGHTS) / sum(STREAM_WEIGHTS)))
             for _ in range(steps)]
    return {i: draws.count(i) for i in sorted(set(draws))}


def _stream_run(tr, corpora, steps: int, **kw):
    """``train_stream`` over the mixture behind ``prefetch_to_device``, as
    ``cli pretrain --stream`` drives it.  Returns (result, prefetcher, wall
    seconds to the last step's end)."""
    stream = _ArrayMix(corpora, batch_size=STREAM_BS, weights=STREAM_WEIGHTS, seed=STREAM_SEED)
    pf = prefetch_to_device(iter(stream), depth=2, device=tr.device)
    rates = [STREAM_TREE[2], STREAM_BULK[2]]
    t0 = time.perf_counter()
    res = tr.train_stream(pf, total_steps=steps, raw_fqs=rates,
                          wire_scale=[STREAM_WIRE_SCALE] * 2, log_every=10, **kw)
    torch.cuda.synchronize()
    return res, pf, time.perf_counter() - t0


def _stream_preprocess(stats, smi: str) -> None:
    """BASELINE.json's "records/sec preprocess" on the card: the stream
    step's wire decode and ``fused_train_path`` (resample, FIR low-pass,
    z-norm, pad) on one bs-``STREAM_BS`` int16 batch of each corpus, per
    call back to back and in device time."""
    mean = torch.tensor(stats['mean'], device=DEV)
    std = torch.tensor(stats['std'], device=DEV)
    scale = torch.tensor(STREAM_WIRE_SCALE, device=DEV)
    rows = {}
    for name, fqs in (('ptbxl', STREAM_TREE[2]), ('code-test', STREAM_BULK[2])):
        wire = torch.as_tensor(_ArrayShards.SHARDS[f'{name}-0'][:STREAM_BS], device=DEV)

        def prep():
            return fused_train_path(wire.float() / scale, mean, std, fqs=fqs, target_fqs=250,
                                    patch_size=64)
        out = prep()
        ms, dev_ms = time_ms(prep, reps=20), device_ms(prep, reps=20)
        rows[name] = {'fqs': fqs, 'in_shape': list(wire.shape), 'out_shape': list(out.shape),
                      'ms_per_batch': ms, 'device_ms_per_batch': dev_ms,
                      'records_per_s': STREAM_BS * 1e3 / ms,
                      'device_records_per_s': None if dev_ms is None else STREAM_BS * 1e3 / dev_ms}
        if not (bool(torch.isfinite(out).all()) and out.shape[-1] % 64 == 0):
            raise AssertionError(f'fused preprocess of {name} failed: {rows[name]}')
    emit({'phase': 'stream_preprocess', 'nvidia_smi': smi, 'batches': rows})


def _stream_expect(objective: str, cfg: VitConfig, steps: int) -> dict:
    return {k: v * steps for k, v in _pretrain_expect(objective, cfg).items()}


def _stream_mae(corpora, dtype: str, stats, smi: str) -> dict:
    """ViT-base MAE stream pretraining, ``STREAM_STEPS`` steps at bs 64:
    steps/s, samples/s, the timer's input fraction, H2D bytes per step (the
    int16 wire against f32) and the copy's device time, the launches per
    step, a profiled step's device-busy share; finite loss and parameters,
    the mixture's counts as replayed."""
    cfg = VitConfig.from_defined('base', flash_min_seq=0, dtype=dtype)
    tr = MaeTrainer(cfg, MaeConfig(), TrainConfig(num_train_epoch=STREAM_STEPS,
                                                  train_batch_size=STREAM_BS,
                                                  log_to_console=False, save_final=False),
                    norm_stats=stats)
    tr.init_state()
    for fqs, shard in ((STREAM_TREE[2], 'ptbxl-0'), (STREAM_BULK[2], 'code-test-0')):
        warm = torch.as_tensor(_ArrayShards.SHARDS[shard][:STREAM_BS], device=DEV)
        float(tr.build_stream_step(fqs, STREAM_WIRE_SCALE)(warm)['loss'])   # warm-up
    tr.init_state()
    _build.reset_launches()
    res, pf, wall = _stream_run(tr, corpora, STREAM_STEPS)
    launches = _build.launch_counts()
    expect = _stream_expect('mae', cfg, STREAM_STEPS)
    host16 = torch.from_numpy(_ArrayShards.SHARDS['ptbxl-0'][:STREAM_BS]).pin_memory()
    host32 = host16.float().pin_memory()
    step = tr.build_stream_step(STREAM_TREE[2], STREAM_WIRE_SCALE)
    sig = host16.to(DEV)
    prof = _profile(f'ViT-base {dtype} bs-{STREAM_BS} MAE stream step (500 Hz int16)', 'step', 3,
                    lambda: float([step(sig) for _ in range(3)][-1]['loss']))
    finite = all(bool(torch.isfinite(p).all()) for p in tr.model.parameters())
    row = {'phase': 'stream_pretrain', 'nvidia_smi': smi, 'objective': 'mae',
           'model': 'ecg-vit-base', 'dtype': dtype, 'batch': STREAM_BS, 'steps': res['steps'],
           'corpora': [list(STREAM_TREE), list(STREAM_BULK)], 'weights': STREAM_WEIGHTS,
           'loss': res['loss'], 'params_finite': finite, 'mix_counts': res['mix_counts'],
           'mix_counts_replayed': _mix_replay(STREAM_STEPS), 'wall_s': wall,
           'steps_per_s': STREAM_STEPS / wall, 'samples_per_s': STREAM_BS * STREAM_STEPS / wall,
           'timer_host_clock': res['timer'], 'h2d_batches': pf.batches,
           'h2d_bytes_per_step_int16': pf.h2d_bytes / pf.batches,
           'h2d_bytes_per_step_if_f32': 2 * pf.h2d_bytes / pf.batches,
           'host_batches_pinned': pf.all_pinned,
           'h2d_device_ms_int16_ptbxl_batch': time_ms(lambda: host16.to(DEV, non_blocking=True)),
           'h2d_device_ms_f32_ptbxl_batch': time_ms(lambda: host32.to(DEV, non_blocking=True)),
           'launches': launches, 'expected': expect,
           'launches_per_step': {k: launches[k] / STREAM_STEPS for k in launches},
           'profile_device_busy_share': prof['device_busy_share'],
           'profile_device_ms_per_step': prof['device_ms_per_step'],
           'profile_wall_ms_per_step': prof['wall_ms_per_step']}
    emit(row)
    emit(prof)
    if not (np.isfinite(res['loss']) and finite and res['steps'] == STREAM_STEPS
            and res['mix_counts'] == row['mix_counts_replayed'] and pf.all_pinned
            and _launched(launches, expect)):
        raise AssertionError(f'MAE stream pretraining ({dtype}) failed: {row}')
    del tr
    torch.cuda.empty_cache()
    return launches


def _stream_resume(corpora, stats, smi: str) -> dict:
    """``RESUME_STEPS`` bf16 steps with a checkpoint every ``RESUME_EVERY``,
    against ``RESUME_EVERY`` steps and a resume to ``RESUME_STEPS`` in a new
    trainer: the parameters bit for bit (#2-#5 use no atomics)."""
    cfg = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16')
    tcfg = TrainConfig(num_train_epoch=RESUME_STEPS, train_batch_size=STREAM_BS,
                       log_to_console=False, save_final=False)
    dirs = [f'runs/chip_smoke_stream_{k}' for k in ('full', 'resumed')]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    total = {}

    def run(out_dir, steps, resume=False):
        tr = MaeTrainer(cfg, MaeConfig(), tcfg, norm_stats=stats, output_dir=out_dir)
        _build.reset_launches()
        res, _, wall = _stream_run(tr, corpora, steps, ckpt_every=RESUME_EVERY, resume=resume)
        for k, v in _build.launch_counts().items():
            total[k] = total.get(k, 0) + v
        return tr, res, wall

    full, res_full, wall_full = run(dirs[0], RESUME_STEPS)
    _, res_first, _ = run(dirs[1], RESUME_EVERY)
    resumed, res_resumed, _ = run(dirs[1], RESUME_STEPS, resume=True)
    a, b = full.model.state_dict(), resumed.model.state_dict()
    equal = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    kept = sorted(os.path.basename(p) for p in checkpoint.committed_checkpoints(dirs[1]))
    row = {'phase': 'stream_resume', 'nvidia_smi': smi, 'model': 'ecg-vit-base',
           'dtype': 'bfloat16', 'steps': RESUME_STEPS, 'ckpt_every': RESUME_EVERY,
           'loss_full': res_full['loss'], 'loss_resumed': res_resumed['loss'],
           'tail_mix_counts': res_resumed['mix_counts'], 'params_bits_equal': equal,
           'checkpoints_kept': kept, 'wall_s_full_with_2_saves': wall_full,
           'launches': total}
    emit(row)
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    if not (equal and res_full['loss'] == res_resumed['loss'] and res_first['steps'] == RESUME_EVERY
            and sum(res_resumed['mix_counts'].values()) == RESUME_STEPS - RESUME_EVERY):
        raise AssertionError(f'the resumed stream differs from the uninterrupted one: {row}')
    del full, resumed
    torch.cuda.empty_cache()
    return total


def _stream_contrastive(corpora, stats, smi: str) -> dict:
    """``CON_STREAM_STEPS`` ViT-base contrastive stream steps in bf16 (two
    views of the decoded batch at its native rate: 2B = 128 rows)."""
    cfg = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16')
    tr = ContrastiveTrainer(cfg, ContrastiveConfig(), TrainConfig(
        num_train_epoch=CON_STREAM_STEPS, train_batch_size=STREAM_BS, log_to_console=False,
        save_final=False), norm_stats=stats)
    _build.reset_launches()
    res, _, wall = _stream_run(tr, corpora, CON_STREAM_STEPS)
    launches = _build.launch_counts()
    expect = _stream_expect('contrastive', cfg, CON_STREAM_STEPS)
    row = {'phase': 'stream_contrastive', 'nvidia_smi': smi, 'model': 'ecg-vit-base',
           'dtype': 'bfloat16', 'rows_per_step': 2 * STREAM_BS, 'steps': res['steps'],
           'loss': res['loss'], 'mix_counts': res['mix_counts'], 'wall_s': wall,
           'launches': launches, 'expected': expect}
    emit(row)
    if not (np.isfinite(res['loss']) and res['steps'] == CON_STREAM_STEPS
            and _launched(launches, expect)):
        raise AssertionError(f'contrastive stream pretraining failed: {row}')
    del tr
    torch.cuda.empty_cache()
    return launches


def stream_phase(smi: str) -> dict:
    """The ingest and streaming-pretraining slice: a synthetic WFDB tree read
    natively and by numpy (bit-equal), the export's resample body on the card
    against the CPU, then MAE stream pretraining of ViT-base over a two-corpus
    int16 mixture (500 and 400 Hz) in f32 and bf16, the resume check, and
    contrastive stream steps.  Returns the kernel launches of the phase."""
    attn.BLOCKED_BWD_MIN_SEQ = 0
    stats = PTBXL_TRAIN_STATS['original']
    root = 'runs/chip_smoke_stream_tree'
    shutil.rmtree(root, ignore_errors=True)
    try:
        tree = _stream_ingest(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _stream_export(tree, smi)
    corpora = _stream_corpora(tree)
    _stream_preprocess(stats, smi)
    total = {}
    for part in (_stream_mae(corpora, 'float32', stats, smi),
                 _stream_mae(corpora, 'bfloat16', stats, smi),
                 _stream_resume(corpora, stats, smi),
                 _stream_contrastive(corpora, stats, smi)):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    _ArrayShards.SHARDS.clear()
    emit({'phase': 'stream', 'launches': total})
    return total


def _parity_batch(seed: int, n: int, n_class: int = 71) -> SplitData:
    rng = np.random.default_rng(seed)
    return SplitData(signals=(0.2 * rng.standard_normal((n, 12, 2500))).astype(np.float32),
                     labels=(rng.uniform(size=(n, n_class)) < 0.1).astype(np.float32))


def _max_param_err(a: torch.nn.Module, b: torch.nn.Module) -> float:
    return max((x - y).abs().max().item()
               for x, y in zip(a.state_dict().values(), b.state_dict().values()))


def _moe_routing(model: torch.nn.Module, x: torch.Tensor) -> dict:
    """The MoE blocks' aux loss and the share of tokens past capacity, from
    one eval forward of ``x``."""
    blocks = [m for m in model.modules() if isinstance(m, MoeMlp)]
    dropped = []

    def hook(mod, args):
        slot = mod.route(args[0].reshape(-1, args[0].shape[-1]))[3]
        dropped.append((slot < 0).float().mean().item())
    handles = [m.register_forward_pre_hook(hook) for m in blocks]
    try:
        with torch.no_grad():
            out = model.eval()(x)
    finally:
        for h in handles:
            h.remove()
    return {'moe_blocks': len(blocks), 'aux_loss': out.aux_loss.item(),
            'dropped_share_per_block': dropped,
            'capacity_per_expert': moe_capacity(model.cfg.moe_capacity_factor,
                                                x.shape[0] * (model.cfg.num_patches + 1),
                                                model.cfg.moe_num_experts)}


def _scale_moe(stats, smi: str) -> dict:
    """ViT-base with Switch-MoE blocks: three f32 steps against a plain twin
    (plain attention, plain AdamW), then samples/s in f32 and bf16, the
    routing, and a profiled bf16 step.  Returns the launches of the kernel
    run's steps."""
    batch = _parity_batch(3, PARITY_STEPS * 64)
    cfg = VitConfig.from_defined('base', flash_min_seq=0, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0, **SCALE_MOE)
    tcfg = TrainConfig(train_batch_size=64, log_to_console=False, save_final=False)
    tr = Trainer(cfg, tcfg, train_data=batch, norm_stats=stats)
    tr.init_state()
    twin = Trainer(dataclasses.replace(cfg, use_flash_attention=False), tcfg,
                   train_data=batch, norm_stats=stats)
    twin.set_params(tr.model.state_dict())
    twin.optimizer.tail = adamw.adamw_tail_reference
    per_step, losses, total = [], [], {}
    for k in range(PARITY_STEPS):
        take = np.arange(64 * k, 64 * (k + 1))
        _build.reset_launches()
        got = float(tr.train_step(batch, take)['loss'])
        counts = _build.launch_counts()
        _build.reset_launches()
        want = float(twin.train_step(batch, take)['loss'])
        per_step.append(counts)
        losses.append((got, want))
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    layers = cfg.num_hidden_layers
    expect = {'flash_fwd': 0, 'flash_fwd_lse': layers, 'flash_bwd_dq': layers,
              'flash_bwd_dkv': layers, 'adamw': 1, 'adamw_norm': 1, 'nlm_rows': 0,
              'nlm_variant': 0}
    param_err = _max_param_err(tr.model, twin.model)
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    x = _prep_batch(torch.from_numpy(batch.signals[:64]).to(DEV), tr.mean, tr.std,
                    cfg.patch_size)
    routing = _moe_routing(tr.model, x)
    del twin
    f32_rate = _steps_per_s(tr, batch, 5)
    del tr
    torch.cuda.empty_cache()
    tr16 = Trainer(dataclasses.replace(cfg, dtype='bfloat16'), tcfg, train_data=batch,
                   norm_stats=stats)
    tr16.init_state()
    bf16_rate = _steps_per_s(tr16, batch, 10)
    profile = profile_train_step(tr16, batch, kind='Switch-MoE train')
    row = {'phase': 'scale_moe', 'model': 'ecg-vit-base', 'nvidia_smi': smi, **SCALE_MOE,
           'params': sum(p.numel() for p in tr16.model.parameters()), 'batch': 64,
           'steps': PARITY_STEPS, 'losses_kernel_plain': losses,
           'max_loss_rel_err': loss_err, 'loss_limit': LOSS_RTOL,
           'max_param_abs_err': param_err, 'param_limit': PARAM_TOL,
           'launches_per_step': per_step, 'expected_per_step': expect, **routing,
           'dropped_share': float(np.mean(routing['dropped_share_per_block'])),
           'train_samples_per_s_f32': f32_rate, 'train_samples_per_s_bf16': bf16_rate,
           'device_busy_share_bf16': profile['device_busy_share']}
    emit(row)
    emit(profile)
    if not all(_launched(c, expect) for c in per_step):
        raise AssertionError(f'MoE steps launched {per_step}, expected {expect} each')
    if not (loss_err <= LOSS_RTOL and param_err <= PARAM_TOL
            and routing['moe_blocks'] == cfg.num_hidden_layers // cfg.moe_every
            and np.isfinite(routing['aux_loss']) and routing['aux_loss'] > 0
            and routing['capacity_per_expert'] == 820):
        raise AssertionError(f'MoE training differs from the plain twin: {row}')
    return total


def _scale_moe_pretrain(stats, smi: str) -> dict:
    """One bf16 MAE step and one contrastive step on the ViT-base Switch-MoE
    trunk; the aux loss is read from the step's own objective."""
    batch = _parity_batch(4, 64, n_class=1)
    cfg16 = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16', **SCALE_MOE)
    total = {}
    for objective in ('mae', 'contrastive'):
        tr = _pretrainer(objective, cfg16, TrainConfig(train_batch_size=64,
                                                       log_to_console=False),
                         train_data=batch, norm_stats=stats)
        tr.init_state()
        auxes = []
        objective_fn = tr._objective
        tr._objective = lambda loss, aux: (auxes.append(aux.detach()),
                                           objective_fn(loss, aux))[1]
        _build.reset_launches()
        metrics = {k: float(v) for k, v in tr.train_step(batch, np.arange(64)).items()}
        counts = _build.launch_counts()
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        expect = _pretrain_expect(objective, cfg16)
        row = {'phase': 'scale_moe_pretrain', 'objective': objective, 'nvidia_smi': smi,
               'model': 'ecg-vit-base', 'dtype': 'bfloat16', **SCALE_MOE, **metrics,
               'aux_loss': float(auxes[-1]), 'launches': counts, 'expected': expect}
        emit(row)
        if not (_launched(counts, expect) and all(np.isfinite(v) for v in metrics.values())
                and np.isfinite(row['aux_loss']) and row['aux_loss'] > 0):
            raise AssertionError(f'MoE {objective} step failed: {row}')
        del tr
        torch.cuda.empty_cache()
    return total


def _scale_scan(stats, smi: str) -> dict:
    """The ViT-base forward with ``scan_blocks`` on stacked copies of an
    unrolled model's weights, against the unrolled logits."""
    cfg = VitConfig.from_defined('base', flash_min_seq=0)
    flat = EcgVit(cfg)
    flax_init_(flat, 5)
    scanned = EcgVit(dataclasses.replace(cfg, scan_blocks=True))
    scanned.load_state_dict(stack_unrolled_state_dict(flat.state_dict(),
                                                      cfg.num_hidden_layers))
    flat, scanned = flat.to(DEV).eval(), scanned.to(DEV).eval()
    mean, std = (torch.tensor(stats[k], device=DEV) for k in ('mean', 'std'))
    x = _prep_batch(torch.from_numpy(_parity_batch(5, 64).signals).to(DEV), mean, std,
                    cfg.patch_size)
    with torch.inference_mode():
        want = flat(x).logits
        _build.reset_launches()
        got = scanned(x).logits
        counts = _build.launch_counts()
        err = ((got - want).abs().max() / want.abs().max()).item()
        row = {'phase': 'scale_scan', 'model': 'ecg-vit-base', 'dtype': 'float32',
               'nvidia_smi': smi, 'batch': 64, 'max_rel_err': err, 'limit': SCAN_RTOL,
               'same_bits': bool(torch.equal(got, want)), 'launches': counts,
               'forward_ms_unrolled': time_ms(lambda: flat(x), reps=10, warmup=2),
               'forward_ms_scanned': time_ms(lambda: scanned(x), reps=10, warmup=2)}
    emit(row)
    if not (err <= SCAN_RTOL and counts['flash_fwd'] == cfg.num_hidden_layers):
        raise AssertionError(f'scanned forward differs from the unrolled one: {row}')
    return counts


def _scale_remat(stats, smi: str) -> dict:
    """ViT-large f32 training, dropout on, with and without remat from one
    init: three steps each, the parameters against each other, the peak
    device memory of each, and the samples/s of each."""
    batch = _parity_batch(6, PARITY_STEPS * 64)
    cfg = VitConfig.from_defined('large', flash_min_seq=0)
    tcfg = TrainConfig(train_batch_size=64, log_to_console=False, save_final=False)
    init, results, total = None, {}, {}
    for remat in (False, True):
        tr = Trainer(dataclasses.replace(cfg, remat=remat), tcfg, train_data=batch,
                     norm_stats=stats)
        if init is None:
            tr.init_state()
            init = {k: v.to('cpu', copy=True) for k, v in tr.model.state_dict().items()}
        else:
            tr.set_params(init)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses = [float(tr.train_step(batch, np.arange(64 * k, 64 * (k + 1)))['loss'])
                  for k in range(PARITY_STEPS)]
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        state = {k: v.to('cpu', copy=True) for k, v in tr.model.state_dict().items()}
        rate = _steps_per_s(tr, batch, 3)
        results[remat] = (losses, state, peak, rate, counts)
        if remat:
            total = counts
        del tr
        torch.cuda.empty_cache()
    (l0, s0, p0, r0, c0), (l1, s1, p1, r1, c1) = results[False], results[True]
    param_err = max((s0[k] - s1[k]).abs().max().item() for k in s0)
    row = {'phase': 'scale_remat', 'model': 'ecg-vit-large', 'dtype': 'float32',
           'nvidia_smi': smi, 'batch': 64, 'dropout': cfg.hidden_dropout_prob,
           'steps': PARITY_STEPS, 'losses': l0, 'losses_remat': l1,
           'max_param_abs_err': param_err, 'param_limit': PARAM_TOL,
           'same_bits': all(torch.equal(s0[k], s1[k]) for k in s0),
           'peak_bytes': p0, 'peak_bytes_remat': p1,
           'train_samples_per_s': r0, 'train_samples_per_s_remat': r1,
           'launches': c0, 'launches_remat': c1}
    emit(row)
    # remat recomputes each block's forward, its lse kernel included, in the
    # backward
    layers = cfg.num_hidden_layers * PARITY_STEPS
    expect = {'flash_fwd': 0, 'flash_fwd_lse': layers, 'flash_bwd_dq': layers,
              'flash_bwd_dkv': layers, 'adamw': PARITY_STEPS, 'adamw_norm': PARITY_STEPS,
              'nlm_rows': 0, 'nlm_variant': 0}
    if not (param_err <= PARAM_TOL and p1 < p0 and _launched(c0, expect)
            and _launched(c1, {**expect, 'flash_fwd_lse': 2 * layers})):
        raise AssertionError(f'remat run failed (launches expected {expect}, the lse '
                             f'forward twice with remat): {row}')
    return total


def _scale_async_ckpt(stats, smi: str) -> dict:
    """ViT-base bf16 with an EMA: how long the step loop stalls in a sync
    save and in an async save of the full state (and how long three steps
    then take, and the wait after them), each checkpoint restored bit for
    bit after ``wait_for_checkpoints``; then an async save waited on at
    once, the writer's whole time."""
    batch = _parity_batch(7, 64)
    cfg16 = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16')
    out_dir = 'runs/chip_smoke_async'
    shutil.rmtree(out_dir, ignore_errors=True)
    row = {'phase': 'scale_async_ckpt', 'model': 'ecg-vit-base', 'dtype': 'bfloat16',
           'nvidia_smi': smi}
    total = {}
    for mode in ('sync', 'async'):
        tr = Trainer(cfg16, TrainConfig(train_batch_size=64, ema_decay=0.999,
                                        async_checkpoint=mode == 'async',
                                        log_to_console=False, save_final=False),
                     train_data=batch, norm_stats=stats, output_dir=out_dir)
        tr.init_state()
        _build.reset_launches()
        for _ in range(2):
            float(tr.train_step(batch, np.arange(64))['loss'])
        t0 = time.perf_counter()
        path = tr.save_checkpoint(tag=mode)
        row[f'{mode}_save_stall_s'] = time.perf_counter() - t0
        saved = {name: {k: v.to('cpu', copy=True) for k, v in tree.items()}
                 for name, tree in (('params', tr.model.state_dict()),
                                    ('mu', tr.opt_state.mu), ('ema', tr.ema))}
        t0 = time.perf_counter()
        for _ in range(3):
            m = tr.train_step(batch, np.arange(64))
        float(m['loss'])
        row[f'{mode}_steps_after_save_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wait_for_checkpoints()
        row[f'{mode}_wait_s'] = time.perf_counter() - t0
        for name, n in _build.launch_counts().items():
            total[name] = total.get(name, 0) + n
        raw = checkpoint.restore_checkpoint(path)
        row[f'{mode}_restored_bits_equal'] = (
            all(torch.equal(raw['params'][k], v) for k, v in saved['params'].items())
            and all(torch.equal(raw['opt_state']['mu'][k], v) for k, v in saved['mu'].items())
            and all(torch.equal(raw['ema_params'][k], v) for k, v in saved['ema'].items()))
        row['checkpoint_bytes'] = os.path.getsize(os.path.join(path, checkpoint.STATE_FILE))
        if mode == 'async':        # the writer alone: a save waited on at once
            t0 = time.perf_counter()
            tr.save_checkpoint(tag='async2')
            wait_for_checkpoints()
            row['async_save_to_commit_s'] = time.perf_counter() - t0
        del tr
        torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    emit(row)
    if not (row['sync_restored_bits_equal'] and row['async_restored_bits_equal']):
        raise AssertionError(f'async checkpoint restore failed: {row}')
    return total


def scale_phase(smi: str) -> dict:
    """The one-card model options on the port's kernels: Switch-MoE ViT-base
    training against a plain twin, MoE pretraining steps, the scanned stack,
    remat at ViT-large, and async checkpoints.  Returns the kernel launches."""
    attn.BLOCKED_BWD_MIN_SEQ = 0
    stats = PTBXL_TRAIN_STATS['original']
    total = {}
    for part in (_scale_moe, _scale_moe_pretrain, _scale_scan, _scale_remat,
                 _scale_async_ckpt):
        for name, n in part(stats, smi).items():
            total[name] = total.get(name, 0) + n
        torch.cuda.empty_cache()
    emit({'phase': 'scale', 'launches': total})
    return total


def _flash_nodes(program) -> int:
    return sum(str(n.target) == 'ecg_tpu_torch.flash_fwd.default' for n in program.graph.nodes)


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _export(tr: Trainer, name: str, **kw):
    """``export_model`` of ``tr`` at the wire length into ``ARTIFACT_DIR/name``:
    (metadata, seconds)."""
    t0 = time.perf_counter()
    meta = export_model(tr, os.path.join(ARTIFACT_DIR, name), signal_length=ARTIFACT_LEN, **kw)
    return meta, time.perf_counter() - t0


def _op_vs_binding(smi: str) -> dict:
    """The op ``ecg_tpu_torch::flash_fwd`` against the direct binding of #1 at
    the serving shape, per call back to back (the dispatcher's host cost)
    and in device time, in the order op, binding, binding, op."""
    gen = torch.Generator(device=DEV).manual_seed(9)
    q, k, v = (torch.randn(SERVING_SHAPE, generator=gen, device=DEV) for _ in range(3))
    scale = 1.0 / math.sqrt(SERVING_SHAPE[-1])
    calls = {'op': lambda: attn.flash_fwd_op(q, k, v, 0, scale, 0.0),
             'binding': lambda: attn.flash_fwd_kernel(q, k, v, 0, scale, 0.0)}
    row = {'phase': 'artifacts_op_vs_binding', 'nvidia_smi': smi,
           'shape': list(SERVING_SHAPE), 'dtype': 'float32',
           'same_bits': bool(torch.equal(calls['op'](), calls['binding']())),
           'op_ms': 0.0, 'binding_ms': 0.0, 'op_device_ms': 0.0, 'binding_device_ms': 0.0}
    for name in ('op', 'binding', 'binding', 'op'):
        row[f'{name}_ms'] += time_ms(calls[name]) / 2
        row[f'{name}_device_ms'] += (device_ms(calls[name]) or float('nan')) / 2
    row['dispatcher_us_per_call'] = 1e3 * (row['op_ms'] - row['binding_ms'])
    emit(row)
    if not row['same_bits']:
        raise AssertionError(f'the op and the binding differ: {row}')
    return row


def _artifacts_export(stats, smi: str):
    """``export_model`` of a seeded ViT-base (f32, bf16, int8) on the card,
    each artifact loaded back through ``ExportedModel.load``: the kernel's
    launches per exported bs-64 forward, the probabilities against
    ``Trainer.predict``, a plain-attention twin, the program on the CPU and a
    program traced on the CPU and moved to the card; the artifact's batch-1
    ms and bs-64 samples/s beside ``Trainer.predict``'s.  Returns (the f32
    trainer, #1's launches on the main path)."""
    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    cfg = VitConfig.from_defined('base', flash_min_seq=0)          # f32 (--no-bf16)
    tr = Trainer(cfg, TrainConfig(), norm_stats=stats)
    tr.init_state()
    x = (0.2 * np.random.default_rng(3).standard_normal((64, 12, ARTIFACT_LEN))
         ).astype(np.float32)
    meta, export_s = _export(tr, 'f32', platforms=['cuda', 'cpu'])
    t0 = time.perf_counter()
    art = ExportedModel.load(os.path.join(ARTIFACT_DIR, 'f32'))
    load_s = time.perf_counter() - t0
    art.predict(x[:2])                                              # warm-up
    before = _build.launch_counts()['flash_fwd']
    probs = art.predict(x)                                          # the main path
    launches = _build.launch_counts()['flash_fwd'] - before
    want = tr.predict(x)
    plain = _twin(tr, flash=False)
    on_cpu = ExportedModel.load(os.path.join(ARTIFACT_DIR, 'f32'), device='cpu')
    # the same weights exported on the CPU, then moved to the card at load
    tr_cpu = Trainer(cfg, TrainConfig(), norm_stats=stats, device='cpu')
    tr_cpu.set_params(tr.model.state_dict())
    _, export_cpu_s = _export(tr_cpu, 'f32-traced-on-cpu', platforms=['cpu', 'cuda'])
    moved = ExportedModel.load(os.path.join(ARTIFACT_DIR, 'f32-traced-on-cpu'))
    # bf16 Linear layers, and int8 weights
    tr16 = Trainer(dataclasses.replace(cfg, dtype='bfloat16'), TrainConfig(),
                   norm_stats=stats)
    tr16.set_params(tr.model.state_dict())
    _export(tr16, 'bf16')
    art16 = ExportedModel.load(os.path.join(ARTIFACT_DIR, 'bf16'))
    p16 = art16.predict(x)
    meta8, _ = _export(tr, 'int8', int8=True)
    art8 = ExportedModel.load(os.path.join(ARTIFACT_DIR, 'int8'))
    p8 = art8.predict(x)
    q8 = _twin(tr, flash=True)
    q8.enable_int8_inference()

    rate = {'artifact': 0.0, 'trainer': 0.0}
    for name, fn in (('artifact', art.predict), ('trainer', tr.predict),
                     ('trainer', tr.predict), ('artifact', art.predict)):
        rate[name] += _samples_per_s(lambda: fn(x), len(x)) / 2
    one = {name: 1e3 * min(_wall(lambda: fn(x[:1])) for _ in range(5))
           for name, fn in (('artifact', art.predict), ('trainer', tr.predict))}
    row = {'phase': 'artifacts_export', 'nvidia_smi': smi, 'model': 'ecg-vit-base',
           'wire': [12, ARTIFACT_LEN], 'flash_min_seq': 0,
           'export_s': export_s, 'export_traced_on_cpu_s': export_cpu_s, 'load_s': load_s,
           'bytes_f32': meta['bytes'], 'bytes_int8': meta8['bytes'],
           'int8_bytes_ratio': meta8['bytes'] / meta['bytes'],
           'int8_bytes_limit': INT8_BYTES_RATIO, 'platforms': meta['platforms'],
           'flash_nodes': _flash_nodes(art.program), 'flash_launches_bs64': launches,
           'f32_bits_equal_trainer': bool(np.array_equal(probs, want)),
           'f32_vs_trainer': _max_err(probs, want), 'f32_trainer_limit': EXPORT_F32_TOL,
           'f32_vs_plain_attention': _max_err(probs, plain.predict(x)),
           'f32_cpu_vs_card': _max_err(on_cpu.predict(x[:8]), probs[:8]),
           'f32_traced_on_cpu_vs_card': _max_err(moved.predict(x), probs),
           'limit': SERVING_TOL,
           'bf16_vs_trainer': _max_err(p16, tr16.predict(x)),
           'bf16_vs_plain_attention': _max_err(p16, _twin(tr16, flash=False).predict(x)),
           'bf16_limit': BF16_TOL,
           'int8_vs_trainer_int8': _max_err(p8, q8.predict(x)),
           'int8_vs_f32': _max_err(p8, probs), 'int8_f32_limit': INT8_TOL,
           'bs64_samples_per_s_artifact': rate['artifact'],
           'bs64_samples_per_s_trainer': rate['trainer'],
           'batch1_ms_artifact': one['artifact'], 'batch1_ms_trainer': one['trainer']}
    emit(row)
    layers = cfg.num_hidden_layers
    if not (probs.shape == (64, cfg.num_class) and np.isfinite(probs).all()
            and launches == layers and row['flash_nodes'] == layers
            and _flash_nodes(art8.program) == layers
            and row['f32_vs_trainer'] <= EXPORT_F32_TOL
            and max(row['f32_vs_plain_attention'], row['f32_cpu_vs_card'],
                    row['f32_traced_on_cpu_vs_card'], row['int8_vs_trainer_int8']) <= SERVING_TOL
            and max(row['bf16_vs_trainer'], row['bf16_vs_plain_attention']) <= BF16_TOL
            and row['int8_bytes_ratio'] < INT8_BYTES_RATIO and row['int8_vs_f32'] < INT8_TOL
            and meta['platforms'] == ['cuda', 'cpu']):
        raise AssertionError(f'the exported artifact failed: {row}')
    del plain, on_cpu, tr_cpu, moved, tr16, art16, art8, q8
    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    return tr, launches


def _artifacts_tokenize(smi: str) -> None:
    """``EcgTokenizer.fit`` at PTB-XL scale on the card, twice from one seed
    (the same bits), ``nearest_centroid`` over every segment, card vs CPU ids
    on a sample, and the encode/decode round trip."""
    signals, _, _ = synth_ptbxl_device(n=TOKENIZE_N)
    fits = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = EcgTokenizer(k=TOKENIZE_K, pad='shift').fit(
            signals, n_clusters=TOKENIZE_CLUSTERS, n_iter=TOKENIZE_ITERS, seed=77)
        fits.append((time.perf_counter() - t0, tok))
    (fit_s, tok), (fit2_s, tok2) = fits
    same = bool(np.array_equal(tok.centers, tok2.centers)
                and np.array_equal(tok.lens, tok2.lens))
    segs, _, _ = tok._segment(signals)
    centers = torch.as_tensor(tok.centers, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, _ = nearest_centroid(segs, centers)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    n_seg = segs.shape[0]
    # the card's ids against the CPU's on a sample, with the same centers
    sample = segs[:TIE_SAMPLE].cpu()
    on_card = ids[:TIE_SAMPLE].cpu()
    on_cpu, _ = nearest_centroid(sample, centers.cpu())
    diff = torch.nonzero(on_card != on_cpu).flatten()
    c64, x64 = centers.cpu().double(), sample[diff].double()
    d_card = ((x64 - c64[on_card[diff]]) ** 2).sum(1)
    d_cpu = ((x64 - c64[on_cpu[diff]]) ** 2).sum(1)
    near = (d_card - d_cpu).abs() <= TIE_RTOL * torch.maximum(d_card, d_cpu)
    # the encode/decode round trip on 4 records
    ids4, means4 = tok(signals[:4])
    dec = tok.decode(ids4, means=means4)
    padded = pad_to_multiple(signals[:4], TOKENIZE_K, 'shift').cpu().numpy()
    row = {'phase': 'artifacts_tokenize', 'nvidia_smi': smi, 'records': TOKENIZE_N,
           'segments': n_seg, 'segment_bytes': n_seg * TOKENIZE_K * 4,
           'k': TOKENIZE_K, 'pad': 'shift', 'clusters': TOKENIZE_CLUSTERS,
           'iterations': TOKENIZE_ITERS, 'fit_s': [fit_s, fit2_s],
           'fit_segments_per_s': n_seg / fit_s,
           'fit_segment_iterations_per_s': n_seg * TOKENIZE_ITERS / fit_s,
           'same_bits_twice': same, 'lens_sum': int(tok.lens.sum()),
           'largest_cluster': int(tok.lens[0]), 'smallest_cluster': int(tok.lens[-1]),
           'nearest_centroid_s': encode_s, 'nearest_centroid_segments_per_s': n_seg / encode_s,
           'cpu_sample': TIE_SAMPLE, 'ids_differ': int(diff.numel()),
           'near_ties': int(near.sum()), 'tie_rtol': TIE_RTOL,
           'roundtrip_shapes': [list(ids4.shape), list(dec.shape)],
           'roundtrip_mean_abs_err': float(np.abs(dec - padded).mean()),
           'padded_mean_abs': float(np.abs(padded).mean())}
    emit(row)
    if not (same and row['lens_sum'] == n_seg and bool(near.all())
            and ids4.shape == (4, 12, padded.shape[-1] // TOKENIZE_K)
            and dec.shape == padded.shape
            and row['roundtrip_mean_abs_err'] < row['padded_mean_abs']):
        raise AssertionError(f'the tokenizer failed: {row}')


def _artifacts_rollout(tr: Trainer, smi: str) -> None:
    """``return_attention`` maps of the served ViT-base on the card against
    the CPU, then ``attention_rollout`` of both (the math of ``cli
    visualize``; the figure needs matplotlib, which the card's machine lacks)."""
    model = tr.served_model()
    rec = (0.2 * np.random.default_rng(4).standard_normal((12, ARTIFACT_LEN))).astype(np.float32)
    mean, std = tr.mean.cpu().numpy()[:, None], tr.std.cpu().numpy()[:, None]
    sig = (rec - mean) / std
    patch = tr.model_cfg.patch_size
    sig = np.pad(sig, [(0, 0), (0, patch - sig.shape[-1] % patch)])
    sig = torch.from_numpy(sig[None, :, :tr.model_cfg.max_signal_length])
    with torch.no_grad():
        maps = model(sig.to(DEV), return_attention=True).attention.cpu()
        maps_cpu = model.cpu()(sig, return_attention=True).attention
    scores = attention_rollout(maps.numpy())
    row = {'phase': 'artifacts_rollout', 'nvidia_smi': smi, 'maps_shape': list(maps.shape),
           'maps_card_vs_cpu': _max_err(maps, maps_cpu),
           'rollout_card_vs_cpu': _max_err(scores, attention_rollout(maps_cpu.numpy())),
           'limit': ROLLOUT_TOL, 'rollout_shape': list(scores.shape)}
    emit(row)
    if not (max(row['maps_card_vs_cpu'], row['rollout_card_vs_cpu']) <= ROLLOUT_TOL
            and np.isfinite(scores).all()):
        raise AssertionError(f'attention maps differ between the card and the CPU: {row}')


def artifacts_phase(smi: str) -> dict:
    """The one-card tools: the exported serving artifact (kernel #1 through
    the op ``ecg_tpu_torch::flash_fwd``), the op against the binding, the
    tokenizer at PTB-XL scale and the rollout maps.  Returns #1's launches on
    the exported forward."""
    stats = PTBXL_TRAIN_STATS['original']
    tr, launches = _artifacts_export(stats, smi)
    _op_vs_binding(smi)
    _artifacts_rollout(tr, smi)
    del tr
    torch.cuda.empty_cache()
    _artifacts_tokenize(smi)
    torch.cuda.empty_cache()
    emit({'phase': 'artifacts', 'launches': {'flash_fwd': launches}})
    return {'flash_fwd': launches}



# --------------------------------------------------------------- parallel
PARALLEL_STEPS = 3
PARALLEL_RTOL = 1e-6      # a wrapper at world 1 against the one-card step
PARALLEL_DP2_RTOL = 2e-5  # two ranks on the one card against the one-card step
# a CPU rehearsal of the phase sets these (the ranks of part (b) read them too)
PARALLEL_DEVICE = os.environ.get('CHIP_SMOKE_PARALLEL_DEVICE', 'cuda:0')
PARALLEL_BACKEND = 'nccl' if PARALLEL_DEVICE.startswith('cuda') else 'gloo'
PARALLEL_SIZE = os.environ.get('CHIP_SMOKE_PARALLEL_SIZE', 'base')


def _parallel_setup(dtype: str = 'float32', **cfg_kw):
    """ViT-base at full width with dropout 0.1 (hashed), TimeOut on, bs 64,
    and the parity rows: the configuration of every run of the phase."""
    attn.BLOCKED_BWD_MIN_SEQ = 0
    cfg = VitConfig.from_defined(PARALLEL_SIZE, flash_min_seq=0, dtype=dtype, dropout_impl='hash',
                                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                 **cfg_kw)
    tcfg = TrainConfig(train_batch_size=64, eval_batch_size=64, augment_timeout=True,
                       log_to_console=False, save_final=False)
    return cfg, tcfg, _parity_batch(11, PARALLEL_STEPS * 64)


def _parallel_steps(tr, batch, steps: int = PARALLEL_STEPS):
    """(per-step global losses, per-step launch counts) of ``steps`` steps."""
    tr.init_state()
    losses, counts = [], []
    for k in range(steps):
        _build.reset_launches()
        losses.append(float(tr.train_step(batch, np.arange(64 * k, 64 * (k + 1)))['loss']))
        counts.append(_build.launch_counts())
    return losses, counts


def _rel(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every parameter (a few elements whose gradient
    is at rounding level and changes sign move by 2 lr under Adam; this
    weighs them by their share of the model)."""
    num = sum(float((a[k].cpu().double() - b[k].cpu().double()).square().sum()) for k in b)
    den = sum(float(b[k].cpu().double().square().sum()) for k in b)
    return math.sqrt(num / den)


def _max_abs(a: dict, b: dict) -> float:
    return max(float((a[k].cpu().float() - b[k].cpu().float()).abs().max()) for k in b)


def _parallel_rank(out_dir: str) -> dict:
    """Part (b) on one of two ranks sharing the card over gloo: DDP, each rank
    32 rows of every 64-row batch, dropout and TimeOut on, f32."""
    import torch.distributed as dist
    from ecg_representation_learning_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ['LOCAL_RANK'] = '0'     # both ranks on the one card
    if PARALLEL_DEVICE.startswith('cuda'):
        torch.cuda.set_device(0)
    cfg, tcfg, batch = _parallel_setup()
    tr = Trainer(cfg, tcfg, norm_stats=PTBXL_TRAIN_STATS['original'],
                 mesh=make_mesh(2, 1, device=PARALLEL_DEVICE))
    losses, counts = _parallel_steps(tr, batch)
    state = tr.state_dict()
    if dist.get_rank() == 0:
        torch.save(state, os.path.join(out_dir, 'params.pt'))
    return {'losses': losses, 'launches': counts,
            'local_rows': int(tr._local_take(np.arange(64)).size)}


# int8 serving on a mesh: ViT-base f32 at 41 tokens (every layer through #1),
# replicated int8 on two gloo ranks sharing the card, against one card's int8
INT8_LAYOUTS = {'dp2': (2, 1, False), 'tp2': (1, 2, False), 'fsdp2': (2, 1, True)}
INT8_EVAL_N = 128


def _int8_setup():
    """(config, train config, the bs-64 predict batch, the 128-record eval
    split) of ``parallel_int8``, the same in the parent and the ranks."""
    cfg = VitConfig.from_defined(PARALLEL_SIZE, flash_min_seq=0)
    tcfg = TrainConfig(eval_batch_size=64, log_to_console=False, save_final=False)
    return cfg, tcfg, _parity_batch(13, 64).signals, _parity_batch(17, INT8_EVAL_N)


def _int8_serve(tr: Trainer, x: np.ndarray, ev: SplitData) -> dict:
    """int8 on ``tr`` (its seeded init): the size summary, bs-64 ``predict``
    with #1's launches of that one forward, ``evaluate`` with its launches,
    and bs-64 int8 samples/s."""
    tr.init_state()
    summary = tr.enable_int8_inference()
    _build.reset_launches()
    probs = tr.predict(x)
    predict_counts = _build.launch_counts()
    _build.reset_launches()
    m = tr.evaluate(ev)
    eval_counts = _build.launch_counts()
    return {'summary': summary, 'probs': probs, 'predict_launches': predict_counts,
            'eval_loss': m['loss'], 'eval_macro_auc': m['macro_auc'],
            'eval_launches': eval_counts,
            'samples_per_s_bs64': _samples_per_s(lambda: tr.predict(x), len(x))}


def _parallel_int8_rank() -> dict:
    """``parallel_int8`` on one of two gloo ranks sharing the card: each
    layout of ``INT8_LAYOUTS`` from the seeded init, served in int8."""
    from ecg_representation_learning_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ['LOCAL_RANK'] = '0'     # both ranks on the one card
    if PARALLEL_DEVICE.startswith('cuda'):
        torch.cuda.set_device(0)
    cfg, tcfg, x, ev = _int8_setup()
    out = {}
    for name, (n_data, n_model, fsdp) in INT8_LAYOUTS.items():
        tr = Trainer(cfg, dataclasses.replace(tcfg, fsdp=fsdp),
                     norm_stats=PTBXL_TRAIN_STATS['original'],
                     mesh=make_mesh(n_data, n_model, device=PARALLEL_DEVICE))
        out[name] = _int8_serve(tr, x, ev)
        del tr
        torch.cuda.empty_cache()
    return out


def _parallel_int8(smi: str) -> dict:
    """int8 inference on a mesh: ViT-base f32 (``flash_min_seq=0``, 12
    layers of #1 per forward) served replicated by ``enable_int8_inference``
    on two gloo ranks sharing the card, as DP 2, TP 2 (model axis 2) and
    FSDP 2; each layout's bs-64 ``predict`` and ``evaluate`` on 128 records
    against the one-card int8 ``Trainer`` on the same seeded weights, at
    ``SERVING_TOL``, with #1's launches per forward per rank, the int8
    bytes a rank holds and bs-64 int8 samples/s beside one card's.  Returns
    the ranks' launches (the main path of the part)."""
    from ecg_representation_learning_tpu_torch.parallel import spawn_ranks
    t0 = time.perf_counter()
    cfg, tcfg, x, ev = _int8_setup()
    one = _int8_serve(Trainer(cfg, tcfg, norm_stats=PTBXL_TRAIN_STATS['original'],
                              device=PARALLEL_DEVICE), x, ev)
    torch.cuda.empty_cache()
    ranks = spawn_ranks(2, _parallel_int8_rank, timeout=600)
    main_path = {k: 0 for k in _build.launch_counts()}
    rows = {}
    for name, (n_data, n_model, fsdp) in INT8_LAYOUTS.items():
        got = ranks[0][name]
        for r in ranks:
            for counts in (r[name]['predict_launches'], r[name]['eval_launches']):
                for k, v in counts.items():
                    main_path[k] += v
        rows[name] = {
            'mesh': {'data': n_data, 'model': n_model}, 'fsdp': fsdp,
            'probs_max_abs_err': float(np.abs(got['probs'] - one['probs']).max()),
            'eval_loss': got['eval_loss'], 'one_card_eval_loss': one['eval_loss'],
            'eval_loss_rel_err': abs(got['eval_loss'] - one['eval_loss']) / one['eval_loss'],
            'eval_macro_auc': got['eval_macro_auc'],
            'one_card_eval_macro_auc': one['eval_macro_auc'],
            'flash_fwd_per_forward_per_rank': [r[name]['predict_launches']['flash_fwd']
                                               for r in ranks],
            'eval_flash_fwd_per_rank': [r[name]['eval_launches']['flash_fwd'] for r in ranks],
            'param_bytes_int8_per_rank': got['summary']['param_bytes_int8'],
            'compression': got['summary']['compression'],
            'samples_per_s_bs64_int8': got['samples_per_s_bs64'],
            'ranks_agree': all(np.array_equal(r[name]['probs'], got['probs']) for r in ranks)}
    row = {'phase': 'parallel_int8', 'nvidia_smi': smi, 'model': f'ecg-vit-{PARALLEL_SIZE}',
           'dtype': 'float32', 'ranks': 2, 'backend': 'gloo', 'batch': len(x),
           'eval_records': INT8_EVAL_N, 'layouts': rows,
           'one_card_samples_per_s_bs64_int8': one['samples_per_s_bs64'],
           'one_card_param_bytes_int8': one['summary']['param_bytes_int8'],
           'limit': SERVING_TOL, 'seconds': time.perf_counter() - t0}
    emit(row)
    layers = cfg.num_hidden_layers
    for name, r in rows.items():
        if not (r['probs_max_abs_err'] <= SERVING_TOL and r['eval_loss_rel_err'] <= SERVING_TOL
                and abs(r['eval_macro_auc'] - r['one_card_eval_macro_auc']) <= SERVING_TOL
                and r['ranks_agree']
                and r['flash_fwd_per_forward_per_rank'] == [layers, layers]
                and r['eval_flash_fwd_per_rank'] == [2 * layers, 2 * layers]
                and r['param_bytes_int8_per_rank'] == row['one_card_param_bytes_int8']):
            raise AssertionError(f'int8 on the {name} mesh differs from one card: {r}')
    return main_path


def parallel_phase(smi: str) -> dict:
    """The ('data', 'model') mesh on the card.  (a) One NCCL rank on cuda:0:
    the one-card ``Trainer`` against ``mesh 1 x 1`` with DDP, with
    ``fsdp=True`` (FSDP2) and with the Megatron plan on a model axis of 1
    (``tensor_parallel=True``), three f32 steps each from one init; one
    Switch-MoE step with expert parallelism, one MAE step with
    ``grad_accum=2`` and an EMA under FSDP, one contrastive step (2B = 128)
    with the all-gathered negatives, each against its one-card step; bf16
    samples/s and peak memory of every wrapper against the one-card step;
    the device time of the norm's all-reduce.  At world 1 these measure the
    wrappers' overhead, not scaling.  (b) Two ranks on the one card over gloo
    with DDP, 32 rows each: three steps against the one-card steps on the
    same 64 rows, so the kernels run with a non-zero ``bh_offset``.  Returns
    the launches of the mesh trainers' steps and evaluation (the main path
    of the phase)."""
    import tempfile
    import torch.distributed as dist
    from ecg_representation_learning_tpu_torch.parallel import (init_local_group, make_mesh,
                                                                spawn_ranks)
    t_phase = time.perf_counter()
    stats = PTBXL_TRAIN_STATS['original']
    store = tempfile.mkdtemp(prefix='chip-smoke-nccl-')
    dev = PARALLEL_DEVICE
    if dev.startswith('cuda'):
        torch.cuda.set_device(0)
    init_local_group(0, 1, store, backend=PARALLEL_BACKEND)
    try:
        cfg, tcfg, batch = _parallel_setup()
        one = Trainer(cfg, tcfg, norm_stats=stats, device=dev)
        ref_losses, ref_counts = _parallel_steps(one, batch)
        ref_state = {k: v.detach().clone() for k, v in one.model.state_dict().items()}
        del one
        wrappers = {'ddp': dict(fsdp=False), 'fsdp': dict(fsdp=True),
                    'tp': dict(fsdp=False, tensor_parallel=True)}
        main_path = {k: 0 for k in _build.launch_counts()}
        rows = {}
        for name, kw in wrappers.items():
            mesh = make_mesh(1, 1, device=dev, tensor_parallel=kw.get('tensor_parallel'))
            tr = Trainer(cfg, dataclasses.replace(tcfg, fsdp=kw['fsdp']), norm_stats=stats,
                         mesh=mesh)
            losses, counts = _parallel_steps(tr, batch)
            _build.reset_launches()
            ev = tr.evaluate(SplitData(batch.signals[:64], batch.labels[:64]))
            counts.append(_build.launch_counts())
            for c in counts:
                for k, v in c.items():
                    main_path[k] += v
            state = tr.state_dict()
            rows[name] = {'losses': losses,
                          'same_bits': losses == ref_losses and all(
                              torch.equal(state[k].cpu(), ref_state[k].cpu()) for k in state),
                          'loss_rel_err': max(abs(a - b) / abs(b)
                                              for a, b in zip(losses, ref_losses)),
                          'param_rel_err': _rel(state, ref_state),
                          'param_max_abs_err': _max_abs(state, ref_state),
                          'launches_per_step': counts[0], 'eval_loss': ev['loss']}
            del tr
            torch.cuda.empty_cache()
        layers = cfg.num_hidden_layers
        expect = {'flash_fwd': 0, 'flash_fwd_lse': layers, 'flash_bwd_dq': layers,
                  'flash_bwd_dkv': layers, 'adamw': 1, 'adamw_norm': 1, 'nlm_rows': 0,
                  'nlm_variant': 0}
        emit({'phase': 'parallel_world1', 'nvidia_smi': smi, 'model': 'ecg-vit-base',
              'dtype': 'float32', 'dropout': 0.1, 'dropout_impl': 'hash', 'timeout': True,
              'batch': 64, 'one_card_losses': ref_losses, 'wrappers': rows,
              'expected_per_step': expect, 'limit': PARALLEL_RTOL,
              'param_rel_err': '||a - b|| / ||b|| over all parameters',
              'reordered': 'the norm: each table row\'s f64 squares summed, then the rows '
                           '(the mesh tail)'})
        for name, row in rows.items():
            if not _launched(row['launches_per_step'], expect):
                raise AssertionError(f'{name}: a step launched {row["launches_per_step"]}, '
                                     f'expected {expect}')
            if not (row['loss_rel_err'] <= PARALLEL_RTOL
                    and row['param_rel_err'] <= PARALLEL_RTOL):
                raise AssertionError(f'{name} differs from the one-card steps: {row}')
        if main_path['flash_fwd'] == 0:
            raise AssertionError('the mesh evaluation launched no flash forward')

        # one step of each objective on its wrapper against its one-card step
        objectives = {}
        for name, build, kw in (
                ('moe_ep', lambda c, t, m: Trainer(c, t, norm_stats=stats, mesh=m, device=dev),
                 dict(cfg=dict(moe_num_experts=4, moe_every=2), tp=True, fsdp=False)),
                ('mae_accum_ema_fsdp', lambda c, t, m: MaeTrainer(
                    c, MaeConfig(), t, norm_stats=stats, mesh=m, device=dev),
                 dict(cfg={}, tp=False, fsdp=True, train=dict(grad_accum=2, ema_decay=0.9))),
                ('contrastive_ddp', lambda c, t, m: ContrastiveTrainer(
                    c, ContrastiveConfig(), t, norm_stats=stats, mesh=m, device=dev),
                 dict(cfg={}, tp=False, fsdp=False))):
            ocfg, otcfg, obatch = _parallel_setup(**kw['cfg'])
            otcfg = dataclasses.replace(otcfg, **kw.get('train', {}))
            want, _ = _parallel_steps(build(ocfg, otcfg, None), obatch, 1)
            mesh = make_mesh(1, 1, device=dev, tensor_parallel=kw['tp'])
            tr = build(ocfg, dataclasses.replace(otcfg, fsdp=kw['fsdp']), mesh)
            got, counts = _parallel_steps(tr, obatch, 1)
            for k, v in counts[0].items():
                main_path[k] += v
            objectives[name] = {'loss': got[0], 'one_card_loss': want[0],
                                'loss_rel_err': abs(got[0] - want[0]) / abs(want[0]),
                                'launches': counts[0]}
            if name == 'moe_ep':
                objectives[name]['experts_per_rank'] = int(
                    tr.params()['encoder.blocks.1.moe.w1'].shape[0])
            del tr
            torch.cuda.empty_cache()
        emit({'phase': 'parallel_objectives', 'nvidia_smi': smi, 'rows': objectives,
              'limit': PARALLEL_RTOL})
        for name, row in objectives.items():
            if not (row['loss_rel_err'] <= PARALLEL_RTOL and row['launches']['adamw'] == 1
                    and row['launches']['flash_bwd_dkv'] > 0):
                raise AssertionError(f'{name} on the mesh differs from one card: {row}')

        # bf16 throughput and peak memory of each wrapper at world 1
        cfg16, tcfg16, batch16 = _parallel_setup('bfloat16')
        rates = {}
        for name, kw in {'one_card': None, **wrappers}.items():
            torch.cuda.reset_peak_memory_stats()
            mesh = None if kw is None else make_mesh(
                1, 1, device=dev, tensor_parallel=kw.get('tensor_parallel'))
            tr = Trainer(cfg16, dataclasses.replace(tcfg16, fsdp=bool(kw and kw['fsdp'])),
                         norm_stats=stats, mesh=mesh, device=dev)
            tr.init_state()
            float(tr.train_step(batch16, np.arange(64))['loss'])
            rates[name] = {'train_samples_per_s_bf16': _steps_per_s(tr, batch16, 8),
                           'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9}
            del tr
            torch.cuda.empty_cache()
        total = torch.zeros((), dtype=torch.float64, device=dev)
        coll_ms = device_ms(lambda: dist.all_reduce(total), reps=50)
        emit({'phase': 'parallel_rates', 'nvidia_smi': smi, 'world': 1,
              'note': 'world 1: the wrappers\' overhead, not scaling', 'rows': rates,
              'norm_all_reduce_device_ms': coll_ms})
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # (b) two ranks on the one card over gloo, against the one-card steps
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix='chip-smoke-dp2-')
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(2, _parallel_rank, out_dir, timeout=300)
        dp2_s = time.perf_counter() - t0
        state = torch.load(os.path.join(out_dir, 'params.pt'), map_location='cpu',
                           weights_only=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = ranks[0]['losses']
    row = {'phase': 'parallel_dp2_one_card', 'nvidia_smi': smi, 'ranks': 2,
           'backend': 'gloo', 'rows_per_rank': ranks[0]['local_rows'], 'losses': losses,
           'one_card_losses': ref_losses,
           'loss_rel_err': max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
           'param_rel_err': _rel(state, {k: v.cpu() for k, v in ref_state.items()}),
           'param_max_abs_err': _max_abs(state, {k: v.cpu() for k, v in ref_state.items()}),
           'launches_per_step_rank0': ranks[0]['launches'][0], 'seconds': dp2_s,
           'limit': PARALLEL_DP2_RTOL, 'phase_seconds': time.perf_counter() - t_phase}
    emit(row)
    if not (row['loss_rel_err'] <= PARALLEL_DP2_RTOL
            and row['param_rel_err'] <= PARALLEL_DP2_RTOL
            and ranks[1]['losses'] == losses
            and all(_launched(c, expect) for r in ranks for c in r['launches'])):
        raise AssertionError(f'two ranks on the card differ from the one-card steps: {row}')

    # (c) int8 serving replicated on the two ranks, in three layouts
    torch.cuda.empty_cache()
    for k, v in _parallel_int8(smi).items():
        main_path[k] += v
    return main_path

# --------------------------------------------------------------- pipeline
# ring context parallelism and the GPipe pipeline; a CPU rehearsal (the
# CHIP_SMOKE_PARALLEL_* variables above) shrinks the ring's tokens
PIPE_RTOL = 1e-5
RING_TOKENS = 2048 if PARALLEL_SIZE == 'base' else 256   # 131,072 samples at patch 64
RING_STEPS = PIPE_STEPS = 3
RING_LR = 1e-4
PIPE_MICRO = 4
PIPE_CLIP = 1e-5        # far below the gradient norm: the clip and the staged norm decide the step
PIPE_BF16_STEPS = 5


def _ring_tensors():
    """q, k, v and the cotangent weights w of the ring checks, (2, 12, T, 64) f32."""
    rng = np.random.default_rng(31)
    return [torch.from_numpy(rng.standard_normal((2, 12, RING_TOKENS, 64)).astype(np.float32))
            for _ in range(4)]


def _ring_cfg(ring: bool) -> VitConfig:
    """ViT-base widths (12 x 768, 12 heads, 12 leads, patch 64) over
    ``RING_TOKENS`` patches, dropout off; with ``ring`` the sequence axis
    'data'."""
    return VitConfig.from_defined(PARALLEL_SIZE, num_channels=12, patch_size=64,
                                  max_signal_length=64 * RING_TOKENS, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0,
                                  ring_axis='data' if ring else None)


def _ring_train_cfg() -> TrainConfig:
    """The ring's TrainConfig, the clip engaged as in the pipeline's."""
    return TrainConfig(learning_rate=RING_LR, grad_clip_norm=PIPE_CLIP)


def _ring_batches():
    """(the RING_STEPS batches (2, 12, 64 T), the masks drawn for them)."""
    from ecg_representation_learning_tpu_torch.train.long_record import _exact_count_mask
    rng = np.random.default_rng(32)
    xs = [rng.standard_normal((2, 12, 64 * RING_TOKENS)).astype(np.float32)
          for _ in range(RING_STEPS)]
    gen = torch.Generator().manual_seed(33)
    masks = [_exact_count_mask(gen, 2, RING_TOKENS, RING_TOKENS // 2) for _ in range(RING_STEPS)]
    return xs, masks


def _pipe_cfg(dtype: str = 'float32', dropout: float = 0.0):
    """ViT-base with ``scan_blocks`` at 41 tokens, every layer through #2-#4,
    and the TrainConfig of the 2-stage pipeline (bs 64, 4 microbatches, the
    clip engaged)."""
    cfg = VitConfig.from_defined(PARALLEL_SIZE, flash_min_seq=0, scan_blocks=True, dtype=dtype,
                                 dropout_impl='hash', hidden_dropout_prob=dropout,
                                 attention_probs_dropout_prob=dropout)
    tcfg = TrainConfig(train_batch_size=64, eval_batch_size=64, mesh_stage=2, mesh_data=1,
                       grad_clip_norm=PIPE_CLIP, log_to_console=False, save_final=False)
    return cfg, tcfg


def _norm_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm())


def _plain_ring_reference(dev):
    """Plain attention of the ring tensors on the card: (out, dq, dk, dv) of
    sum(out * w), on the host."""
    q, k, v, w = (t.to(dev) for t in _ring_tensors())
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = attn.attention(q, k, v, use_flash=False)
    (out * w).sum().backward()
    return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]


def _mim_one_card(dev):
    """``EcgMim`` (ring_axis None: the flash kernels at T = RING_TOKENS) on
    one card, RING_STEPS steps on the ring's batches and masks from the
    ring's init: (losses, the first step's gradients and the final state,
    on the host)."""
    from ecg_representation_learning_tpu_torch.train.long_record import EcgMim
    from ecg_representation_learning_tpu_torch.train.optim import make_optimizer
    model = EcgMim(_ring_cfg(False))
    flax_init_(model, 0)
    model.to(dev).eval()
    opt, _ = make_optimizer(_ring_train_cfg(), RING_STEPS)
    leaves = {k: p.detach() for k, p in model.named_parameters()}
    state = opt.init(leaves)
    losses, first_grads = [], None
    for x, m in zip(*_ring_batches()):
        loss_sum, cnt = model(torch.from_numpy(x).to(dev), m.to(dev), 0)
        loss = loss_sum / torch.clamp(cnt, min=1.0)
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        if first_grads is None:
            first_grads = {k: g.detach().cpu() for k, g in grads.items()}
        state = opt.apply(grads, state, leaves)
        model.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    return losses, first_grads, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _pipeline_rank(out_dir: str) -> dict:
    """Both parts on one of two gloo ranks sharing the card: the ring
    attention check, ``RingPretrainer`` steps, the 2-stage GPipe steps with
    dropout off, twice with hashed dropout 0.1, and bf16 samples/s."""
    import torch.distributed as dist
    from ecg_representation_learning_tpu_torch.parallel import make_mesh, ring_attention, spmd
    from ecg_representation_learning_tpu_torch.train import PipelineVitTrainer, RingPretrainer
    hops = {'on': False, 'seconds': 0.0, 'count': 0, 'host_staged': 0}
    hop = spmd._hop

    def timed_hop(tensors, group, shift):
        """A ring hop, timed on the host with the device synced on both
        sides (compute queued ahead is not counted as transfer)."""
        if not hops['on']:
            return hop(tensors, group, shift)
        cuda_t = tensors[0].is_cuda
        if cuda_t:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = hop(tensors, group, shift)
        if cuda_t:
            torch.cuda.synchronize()
        hops['seconds'] += time.perf_counter() - t0
        hops['count'] += 1
        hops['host_staged'] += int(cuda_t and dist.get_backend(group) == 'gloo')
        return got
    spmd._hop = timed_hop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ['LOCAL_RANK'] = '0'     # both ranks on the one card
    cuda = PARALLEL_DEVICE.startswith('cuda')
    if cuda:
        torch.cuda.set_device(0)
    attn.BLOCKED_BWD_MIN_SEQ = 0
    dev, rank, out = PARALLEL_DEVICE, dist.get_rank(), {}

    # ring attention, 1,024 + 1,024 tokens
    mesh = make_mesh(2, 1, device=dev)
    q, k, v, w = (t.to(dev) for t in _ring_tensors())
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    part = slice(rank * RING_TOKENS // 2, (rank + 1) * RING_TOKENS // 2)
    o = ring_attention(q, k, v, mesh)
    (o * w[:, :, part]).sum().backward()
    out['ring_attention'] = [t.detach()[:, :, part].cpu() if i else t.detach().cpu()
                             for i, t in enumerate((o, q.grad, k.grad, v.grad))]
    del q, k, v, w, o

    # RingPretrainer at ViT-base widths, RING_TOKENS tokens, bs 2
    ring = RingPretrainer(_ring_cfg(True), _ring_train_cfg(), mesh, total_steps=RING_STEPS)
    ring.init(0)
    # the gradient scale, which Adam and the clip do not see: the summed
    # gradients of the first batch, held against one card's
    xs, masks = _ring_batches()
    first_grads = {k: g.cpu() for k, g in ring.loss_and_grads(xs[0], masks[0])[1].items()}
    if rank == 0:
        torch.save(first_grads, os.path.join(out_dir, 'ring_grads.pt'))
    del first_grads
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    hops['on'] = True
    losses, counts, step_s, hop_s = [], [], [], []
    for x, m in zip(xs, masks):
        _build.reset_launches()
        before, t0 = hops['seconds'], time.perf_counter()
        losses.append(float(ring.train_step(x, m)))
        step_s.append(time.perf_counter() - t0)
        hop_s.append(hops['seconds'] - before)
        counts.append(_build.launch_counts())
    hops['on'] = False
    if rank == 0:
        torch.save(ring.state_dict(), os.path.join(out_dir, 'ring.pt'))
    out['ring_train'] = {
        'losses': losses, 'launches': counts, 'step_s': step_s, 'ppermute_s': hop_s,
        'hops': hops['count'], 'host_staged_hops': hops['host_staged'],
        'tokens_per_s': 2 * RING_TOKENS * (RING_STEPS - 1) / sum(step_s[1:]),
        'ppermute_share': sum(hop_s[1:]) / sum(step_s[1:]),
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
    del ring

    # GPipe: 2 stages x 6 layers, 4 microbatches of 16 rows, dropout off
    stats = PTBXL_TRAIN_STATS['original']
    cfg, tcfg = _pipe_cfg()
    batch = _parity_batch(12, PIPE_STEPS * 64)
    pp_mesh = None

    def steps(tr, n, data=batch):
        losses, counts = [], []
        for i in range(n):
            _build.reset_launches()
            losses.append(float(tr.train_step(data, np.arange(64 * i, 64 * (i + 1)))))
            counts.append(_build.launch_counts())
        return losses, counts
    pp = PipelineVitTrainer(cfg, tcfg, norm_stats=stats, n_micro=PIPE_MICRO, device=dev)
    pp_mesh = pp.mesh
    pp.init_state()
    losses, counts = steps(pp, PIPE_STEPS)
    merged = pp.merged_params()
    if rank == 0:
        torch.save(merged, os.path.join(out_dir, 'pp.pt'))
    out['gpipe'] = {'losses': losses, 'launches': counts, 'stage': pp.stage,
                    'local_qkv': tuple(pp.model.get_parameter(
                        'encoder.blocks.attn.qkv.weight').shape),
                    'mu_qkv': tuple(pp.opt_state.mu['encoder.blocks.attn.qkv.weight'].shape)}
    del pp, merged

    # hashed dropout 0.1: twice from one seed
    dcfg, _ = _pipe_cfg(dropout=0.1)
    runs = []
    for _ in range(2):
        tr = PipelineVitTrainer(dcfg, tcfg, norm_stats=stats, n_micro=PIPE_MICRO, mesh=pp_mesh)
        tr.init_state()
        d_losses, d_counts = steps(tr, PIPE_STEPS)
        runs.append((d_losses, d_counts, tr.merged_params()))
        del tr
    out['gpipe_dropout'] = {
        'losses': runs[0][0], 'launches': runs[0][1] + runs[1][1],
        'same_bits': runs[0][0] == runs[1][0] and all(
            torch.equal(runs[0][2][k], runs[1][2][k]) for k in runs[0][2])}
    del runs

    # bf16 samples/s, dropout 0.1 and TimeOut on
    bcfg, _ = _pipe_cfg('bfloat16', dropout=0.1)
    tr = PipelineVitTrainer(bcfg, dataclasses.replace(tcfg, augment_timeout=True),
                            norm_stats=stats, n_micro=PIPE_MICRO, mesh=pp_mesh)
    tr.init_state()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    float(tr.train_step(batch, np.arange(64)))
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(PIPE_BF16_STEPS):
        loss = tr.train_step(batch, np.arange(64 * (i % PIPE_STEPS), 64 * (i % PIPE_STEPS + 1)))
    float(loss)
    out['gpipe_bf16'] = {
        'train_samples_per_s': 64 * PIPE_BF16_STEPS / (time.perf_counter() - t0),
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
    return out


def pipeline_phase(smi: str) -> dict:
    """Ring context parallelism and the GPipe pipeline on the card, f32 with
    TF32 off.  (a) Ring: one NCCL rank, ``ring_attention`` at world 1
    against plain attention on (2, 12, 2048, 64), forward and gradients;
    two gloo ranks sharing the card, the same tensors split 1,024 + 1,024;
    ``RingPretrainer`` at ViT-base widths on 2,048-token records (131,072
    samples, 8.7 min at 250 Hz), bs 2, the clip engaged, three steps on the
    two ranks against ``EcgMim`` on one card (the flash kernels) on the same
    masks, the first step's summed gradients held against one card's, with
    its tokens/s, peak memory and ppermute share.  (b) GPipe: ViT-base
    ``scan_blocks``, 2 stages x 6 layers on the two ranks, 4 microbatches of
    bs 64 at 41 tokens, dropout and TimeOut off, the clip engaged: three
    steps against the one-card ``Trainer`` on the same rows, with each
    rank's launches; hashed dropout 0.1 twice from one seed (the same bits);
    the merged parameters through the one-card ``Trainer.predict`` (#1)
    against a plain twin; bf16 samples/s and peak memory per rank (two
    ranks sharing one card: a price, not scaling).  Returns the launches of
    the ranks' steps and of the predict (the main path)."""
    import tempfile
    import torch.distributed as dist
    from ecg_representation_learning_tpu_torch.parallel import (init_local_group, make_mesh,
                                                                ring_attention, spawn_ranks)
    t_phase = time.perf_counter()
    dev = PARALLEL_DEVICE
    cuda = dev.startswith('cuda')
    if cuda:
        torch.cuda.set_device(0)
    attn.BLOCKED_BWD_MIN_SEQ = 0
    stats = PTBXL_TRAIN_STATS['original']
    main_path = {k: 0 for k in _build.launch_counts()}

    # (a) ring attention at world 1 (one NCCL rank) against plain attention
    plain = _plain_ring_reference(dev)
    store = tempfile.mkdtemp(prefix='chip-smoke-ring-')
    init_local_group(0, 1, store, backend=PARALLEL_BACKEND)
    try:
        q, k, v, w = (t.to(dev) for t in _ring_tensors())
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        o = ring_attention(q, k, v, make_mesh(1, 1, device=dev))
        (o * w).sum().backward()
        world1 = {n: _norm_rel_err(a, b) for n, a, b in zip(('out', 'dq', 'dk', 'dv'),
                                                       (o, q.grad, k.grad, v.grad), plain)}
        del q, k, v, w, o
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    emit({'phase': 'pipeline_ring_world1', 'nvidia_smi': smi, 'shape': [2, 12, RING_TOKENS, 64],
          'dtype': 'float32', 'rel_err': world1, 'limit': PIPE_RTOL,
          'rel_err_is': '||a - b|| / ||b|| against plain attention'})
    if not all(e <= PIPE_RTOL for e in world1.values()):
        raise AssertionError(f'ring attention at world 1 differs from plain attention: {world1}')

    # the one-card references: EcgMim at RING_TOKENS, the scanned ViT-base Trainer
    mim_losses, mim_grads, mim_state = _mim_one_card(dev)
    cfg, tcfg = _pipe_cfg()
    one = Trainer(cfg, dataclasses.replace(tcfg, mesh_stage=1, mesh_data=None), norm_stats=stats,
                  device=dev)
    one.init_state()
    batch = _parity_batch(12, PIPE_STEPS * 64)
    one_losses, one_counts = [], []
    for i in range(PIPE_STEPS):
        _build.reset_launches()
        one_losses.append(float(one.train_step(batch, np.arange(64 * i, 64 * (i + 1)))['loss']))
        one_counts.append(_build.launch_counts())
    one_state = {k: v.detach().cpu() for k, v in one.model.state_dict().items()}
    del one
    if cuda:
        torch.cuda.empty_cache()

    # (a) and (b) on two gloo ranks sharing the card
    out_dir = tempfile.mkdtemp(prefix='chip-smoke-pipeline-')
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(2, _pipeline_rank, out_dir, timeout=600)
        ranks_s = time.perf_counter() - t0
        ring_state = torch.load(os.path.join(out_dir, 'ring.pt'), map_location='cpu',
                                weights_only=True)
        ring_grads = torch.load(os.path.join(out_dir, 'ring_grads.pt'), map_location='cpu',
                                weights_only=True)
        merged = torch.load(os.path.join(out_dir, 'pp.pt'), map_location='cpu',
                            weights_only=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    two = {n: _norm_rel_err(torch.cat([r['ring_attention'][j] for r in ranks], dim=2),
                            plain[j])
           for j, n in enumerate(('out', 'dq', 'dk', 'dv'))}
    rt = [r['ring_train'] for r in ranks]
    ring_row = {
        'phase': 'pipeline_ring', 'nvidia_smi': smi, 'ranks': 2, 'backend': 'gloo',
        'sharing': 'two ranks on one card', 'attention_rel_err': two,
        'model': f'{PARALLEL_SIZE} widths, 12 leads, patch 64', 'tokens': RING_TOKENS,
        'samples': 64 * RING_TOKENS, 'batch': 2, 'losses': rt[0]['losses'],
        'one_card_losses': mim_losses,
        'loss_rel_err': max(abs(a - b) / abs(b) for a, b in zip(rt[0]['losses'], mim_losses)),
        'grad_rel_err': _rel(ring_grads, mim_grads), 'grad_clip_norm': PIPE_CLIP,
        'param_rel_err': _rel(ring_state, mim_state),
        'param_max_abs_err': _max_abs(ring_state, mim_state),
        'launches_per_step': [r['launches'] for r in rt],
        'tokens_per_s': [r['tokens_per_s'] for r in rt],
        'ppermute_share': [r['ppermute_share'] for r in rt],
        'ppermute_hops': rt[0]['hops'], 'host_staged_hops': rt[0]['host_staged_hops'],
        'step_s': [r['step_s'] for r in rt],
        'peak_memory_gb_per_rank': [r['peak_memory_gb'] for r in rt], 'limit': PIPE_RTOL,
        'ppermute_share_is': 'host seconds in ring hops (device synced around each) over the '
                             'step, steps 2-3'}
    emit(ring_row)
    ring_ok = (all(e <= PIPE_RTOL for e in two.values())
               and ring_row['loss_rel_err'] <= PIPE_RTOL
               and ring_row['grad_rel_err'] <= PIPE_RTOL
               and ring_row['param_rel_err'] <= PIPE_RTOL
               and rt[1]['losses'] == rt[0]['losses']
               and all(c['adamw'] == 1 and c['adamw_norm'] == 1
                       for r in rt for c in r['launches']))
    if not ring_ok:
        raise AssertionError(f'ring context parallelism differs from one card: {ring_row}')

    gp = [r['gpipe'] for r in ranks]
    layers = cfg.num_hidden_layers // 2
    per_rank = (PIPE_MICRO + 2 - 1) * layers
    expect = {'flash_fwd': 0, 'flash_fwd_lse': per_rank, 'flash_bwd_dq': per_rank,
              'flash_bwd_dkv': per_rank, 'adamw': 1, 'adamw_norm': 1, 'nlm_rows': 0,
              'nlm_variant': 0}
    drop = [r['gpipe_dropout'] for r in ranks]
    gp_row = {
        'phase': 'pipeline_gpipe', 'nvidia_smi': smi, 'ranks': 2, 'backend': 'gloo',
        'sharing': 'two ranks on one card', 'model': f'ecg-vit-{PARALLEL_SIZE} scan_blocks',
        'stages': 2, 'layers_per_stage': layers, 'n_micro': PIPE_MICRO, 'batch': 64,
        'grad_clip_norm': PIPE_CLIP, 'losses': gp[0]['losses'], 'one_card_losses': one_losses,
        'loss_rel_err': max(abs(a - b) / abs(b) for a, b in zip(gp[0]['losses'], one_losses)),
        'param_rel_err': _rel(merged, one_state), 'param_max_abs_err': _max_abs(merged, one_state),
        'launches_per_step_per_rank': [r['launches'] for r in gp],
        'one_card_launches_per_step': one_counts[0], 'expected_per_rank_step': expect,
        'stage_of_rank': [r['stage'] for r in gp],
        'local_qkv': [r['local_qkv'] for r in gp], 'mu_qkv': [r['mu_qkv'] for r in gp],
        'dropout_losses': drop[0]['losses'], 'dropout_same_bits': [r['same_bits'] for r in drop],
        'bf16_train_samples_per_s': [r['gpipe_bf16']['train_samples_per_s'] for r in ranks],
        'bf16_peak_memory_gb_per_rank': [r['gpipe_bf16']['peak_memory_gb'] for r in ranks],
        'limit': PIPE_RTOL}
    emit(gp_row)
    gp_ok = (gp_row['loss_rel_err'] <= PIPE_RTOL and gp_row['param_rel_err'] <= PIPE_RTOL
             and gp[1]['losses'] == gp[0]['losses']
             and all(_launched(c, expect) for r in gp for c in r['launches'])
             and all(_launched(c, expect) for r in drop for c in r['launches'])
             and all(math.isfinite(v) for v in drop[0]['losses'])
             and all(r['same_bits'] for r in drop)
             and [r['stage'] for r in gp] == [0, 1]
             and all(r['local_qkv'] == r['mu_qkv'] and r['local_qkv'][0] == layers for r in gp))
    if not gp_ok:
        raise AssertionError(f'the GPipe pipeline differs from one card: {gp_row}')
    for r in ranks:
        for c in (*r['ring_train']['launches'], *r['gpipe']['launches'],
                  *r['gpipe_dropout']['launches']):
            for k2, v2 in c.items():
                main_path[k2] += v2

    # the merged parameters on one device: Trainer.predict (#1) vs a plain twin
    ev = Trainer(cfg, TrainConfig(eval_batch_size=64, log_to_console=False), norm_stats=stats,
                 device=dev)
    ev.init_state()
    ev.set_params(merged)
    records = batch.signals[:64]
    _build.reset_launches()
    probs = ev.predict(records)
    predict_counts = _build.launch_counts()
    twin = _twin(ev, flash=False)
    want = twin.predict(records)
    pred_row = {'phase': 'pipeline_predict', 'nvidia_smi': smi, 'records': 64,
                'launches': predict_counts, 'max_abs_err_vs_plain_twin':
                    float(np.abs(probs - want).max()), 'limit': SERVING_TOL,
                'ranks_s': ranks_s, 'phase_seconds': time.perf_counter() - t_phase}
    emit(pred_row)
    if not (predict_counts['flash_fwd'] > 0
            and pred_row['max_abs_err_vs_plain_twin'] <= SERVING_TOL):
        raise AssertionError(f'the merged parameters serve other answers: {pred_row}')
    for k2, v2 in predict_counts.items():
        main_path[k2] += v2
    del ev, twin
    if cuda:
        torch.cuda.empty_cache()
    return main_path


# ---------------------------------------------------------------- dispatch
DISPATCH_ROWS = 600       # 9 steps an epoch at bs 64: two K = 4 dispatches and a leftover
DISPATCH_K = 4
DISPATCH_EPOCHS = 2
# used only when cuBLAS picks other kernels under capture than eagerly (printed
# then): the JAX package's own K-step tolerance (tests/test_train.py:420-423)
DISPATCH_RTOL, DISPATCH_ATOL = 5e-4, 1e-8
DISPATCH_SMALL = dict(num_hidden_layers=2, moe_num_experts=2, moe_every=1, remat=True)
DISPATCH_TIMED = 5        # K-step dispatches timed (epoch dispatches: 2)


def _dispatch_trainer(cfg: VitConfig, data: SplitData, init: dict, **tkw) -> Trainer:
    """A ViT trainer on ``data`` from the weights ``init``: bs 64, TimeOut,
    an EMA, ``DISPATCH_EPOCHS`` epochs without evaluation."""
    tcfg = TrainConfig(num_train_epoch=DISPATCH_EPOCHS, train_batch_size=64,
                       augment_timeout=True, log_to_console=False, save_final=False,
                       do_eval=False, ema_decay=0.999, **tkw)
    tr = Trainer(cfg, tcfg, train_data=data, norm_stats=PTBXL_TRAIN_STATS['original'],
                 output_dir='runs/chip_smoke_dispatch')
    tr.set_params(init)
    return tr


def _dispatch_train(tr: Trainer) -> dict:
    """``tr.train()``: its payloads, seconds and kernel launches."""
    payloads = []
    log = tr._log
    tr._log = lambda payload: (payloads.append(payload), log(payload))
    _build.reset_launches()
    t0 = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    return {'payloads': payloads, 'seconds': time.perf_counter() - t0,
            'launches': _build.launch_counts()}


def _same_state(a: Trainer, b: Trainer) -> dict:
    """Whether two trainers hold the same bits after the same steps: params,
    EMA, Adam moments, both generators, the step and count; and the params'
    largest |a - b| / (|b| + 1e-30)."""
    out = {}
    for name, get in (('params', lambda t: t.model.state_dict()), ('ema', lambda t: t.ema),
                      ('mu', lambda t: t.opt_state.mu), ('nu', lambda t: t.opt_state.nu)):
        x, y = get(a), get(b)
        out[name] = all(torch.equal(x[k], y[k]) for k in x)
    out['generators'] = all(torch.equal(g(a).get_state(), g(b).get_state())
                            for g in (lambda t: t.rng.host, lambda t: t.rng.device))
    out['counts'] = (a.step, a.opt_state.count) == (b.step, b.opt_state.count)
    pa, pb = a.model.state_dict(), b.model.state_dict()
    rel = max(((pa[k].float() - pb[k].float()).abs() / (pb[k].float().abs() + 1e-30))
              .max().item() for k in pa)
    close = all(torch.allclose(pa[k], pb[k], rtol=DISPATCH_RTOL, atol=DISPATCH_ATOL)
                for k in pa)
    return {'same_bits': out, 'max_param_rel_err': rel, 'within_limit': close}


def _kernel_names(run) -> set:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def _param_casts(tr: Trainer) -> int:
    """The parameter casts of one training forward of ``tr``'s model: a
    Switch-MoE block's four stacks, and where the trainer keeps no compute
    copies (the optax chain) every bf16 Linear's weight and bias."""
    n = 0
    for m in tr.model.modules():
        if isinstance(m, MoeMlp) and m.compute_dtype != torch.float32:
            n += 4
        elif tr._copies is None and isinstance(m, Dense) and m.compute_dtype != torch.float32:
            n += 1 + (m.bias is not None)
    return n


def _dispatch_check(name: str, tr: Trainer, ref: Trainer, run: dict, k: int) -> dict:
    """Hold a dispatch run against its eager twin and emit the row; a graph
    of ``k`` steps must hold k steps' launches of every kernel (a layer's
    #2, #3 and #4 per microbatch; one #5 update and norm with the fused
    optimizer; with flax dropout, #8's ``gelu_dropout`` for a dense block's
    MLP hidden and ``dropout_add`` for its attention and MLP outputs, a
    Switch-MoE block's attention output alone; the forwards, #2's and #8's,
    twice under remat; nothing else), its ``param_cast`` count the
    forwards' parameter casts (``_param_casts``: 0 for a dense model that
    reads kernel #5's compute copies), and the run's counters every step's
    launches."""
    info = tr.dispatch_info or {}
    steps, cfg = tr.step, tr.model_cfg
    accum = max(1, tr.cfg.grad_accum)
    micro = cfg.num_hidden_layers * accum
    fwd = 2 if cfg.remat else 1
    fused = int(tr.cfg.fused_optimizer)   # the optax chain is plain PyTorch
    sites = cfg.dropout_impl == 'flax' and cfg.hidden_dropout_prob > 0.0
    moe = sum(moe_layer(cfg, i) for i in range(cfg.num_hidden_layers)) * accum if sites else 0
    mlp = micro - moe if sites else 0
    out = 2 * mlp + moe
    per_step = {**dict.fromkeys(_build.COUNTERS, 0), 'flash_fwd_lse': micro * fwd,
                'flash_bwd_dq': micro, 'flash_bwd_dkv': micro, 'adamw': fused,
                'adamw_norm': fused, 'gelu_dropout': mlp * fwd, 'gelu_dropout_bwd': mlp,
                'dropout_add': out * fwd, 'dropout_add_bwd': out,
                'param_cast': _param_casts(tr) * accum * fwd}
    row = {'phase': 'dispatch_parity', 'run': name, 'model': tr.model_cfg.meta,
           **_same_state(tr, ref), 'route': info.get('route'),
           'replays': info.get('replays'), 'capture_s': info.get('capture_s'),
           'copy_leaves_per_update': len(tr._copies.copies) if tr._copies else 0,
           'graph_pool_bytes': info.get('pool_bytes'),
           'graph_launches': info.get('graph_launches'),
           'expected_graph_launches': {n: k * c for n, c in per_step.items()},
           'run_launches': {n: run['launches'][n] for n in per_step},
           'expected_run_launches': {n: steps * c for n, c in per_step.items()},
           'payload_steps': [p['step'] for p in run['payloads']],
           'train_seconds': run['seconds']}
    bits = all(row['same_bits'].values())
    if not bits:   # which kernels the capture changed (cuBLAS may pick others)
        d = Dispatcher(tr, k, scan=False)
        takes = np.arange(k * 64).reshape(k, 64) % len(tr.train_data)
        d.run(takes)
        row['graph_only_kernels'] = sorted(_kernel_names(lambda: d.run(takes))
                                           - _kernel_names(lambda: tr.train_step(
                                               tr.train_data, takes[0])))
    emit(row)
    if not ((bits or row['within_limit']) and row['route'] == 'graph'
            and row['graph_launches'] == row['expected_graph_launches']
            and row['run_launches'] == row['expected_run_launches']):
        raise AssertionError(f'dispatch run {name} differs from its eager twin: {row}')
    return row


def _dispatch_rates(eager: Trainer, k4: Trainer, scan: Trainer, data: SplitData,
                    smi: str) -> None:
    """Samples/s and a profile of the eager step, of K = 4 dispatches and of
    an epoch dispatch, after each route's first (eager) dispatch and
    capture."""
    rng = np.random.default_rng(3)
    d4 = Dispatcher(k4, DISPATCH_K, scan=False)
    takes4 = rng.permutation(len(data))[:DISPATCH_K * 64].reshape(DISPATCH_K, 64)
    d4.run(takes4)
    steps = scan.steps_per_epoch
    ds = Dispatcher(scan, steps, scan=True)
    takes_ep = rng.permutation(len(data))[:steps * 64].reshape(steps, 64)
    ds.run(takes_ep)

    def timed(d, takes, n):
        float(d.run(takes)[0][-1])
        t0 = time.perf_counter()
        for _ in range(n):
            losses = d.run(takes)[0]
        float(losses[-1])
        return n * len(takes) * 64 / (time.perf_counter() - t0)
    rates = {'phase': 'dispatch_rates', 'model': eager.model_cfg.meta, 'nvidia_smi': smi,
             'eager_samples_per_s': _steps_per_s(eager, data, 20),
             'k4_samples_per_s': timed(d4, takes4, DISPATCH_TIMED),
             'epoch_scan_samples_per_s': timed(ds, takes_ep, 2),
             'k4_capture_s': d4.info().get('capture_s'),
             'k4_graph_pool_bytes': d4.info().get('pool_bytes'),
             'epoch_scan_capture_s': ds.info().get('capture_s'),
             'epoch_scan_graph_pool_bytes': ds.info().get('pool_bytes')}
    emit(rates)

    def d4_run():
        for _ in range(2):
            losses = d4.run(takes4)[0]
        float(losses[-1])
    for prof in (profile_train_step(eager, data),
                 _profile(f'ViT-base bf16 bs-64, steps_per_dispatch={DISPATCH_K}, 2 dispatches',
                          'step', 2 * DISPATCH_K, d4_run),
                 _profile(f'ViT-base bf16 bs-64, epoch_scan, one epoch of {steps} steps', 'step',
                          steps, lambda: float(ds.run(takes_ep)[0][-1]))):
        emit({**prof, 'nvidia_smi': smi})


def dispatch_phase(smi: str) -> dict:
    """``steps_per_dispatch`` and ``epoch_scan`` on the card (train/dispatch.py):
    ViT-base bf16 at bs 64 (41 tokens, every layer through #2-#4: flash_min_seq
    0 and a blocked-backward threshold of 0), flax dropout 0.1 with the
    attention kernels' hashed masks, TimeOut and an EMA, trained from one init
    for 2 epochs of 9 steps four ways: the per-step loop; K = 4 (two graph
    dispatches and one leftover step an epoch); epoch_scan (one cursor step
    replayed 9 times); and K = 4 with ``fused_optimizer=False`` against its own
    per-step loop.  Params, EMA, moments, generators and counts bit-equal to
    the per-step loop; each graph holds K x (12 #2, 12 #3, 12 #4, 1 #5 update,
    1 #5 norm, 12 #8 gelu_dropout and 24 dropout_add each way); the run's
    counters every step's launches.  Then 2 layers of
    Switch-MoE (E = 2 on every block) with remat and grad_accum 2, flax and
    hashed dropout, K = 4 and epoch_scan against the per-step loop, bit for
    bit.  Samples/s and profiles of the eager step, the K = 4 dispatch and the
    epoch dispatch, the capture seconds and the memory each graph reserved.
    Returns the launches of the K = 4 and epoch_scan ``train()`` runs."""
    attn.BLOCKED_BWD_MIN_SEQ = 0
    data = _parity_batch(7, DISPATCH_ROWS)
    cfg = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16')
    init_tr = Trainer(cfg, TrainConfig(), norm_stats=PTBXL_TRAIN_STATS['original'])
    init = {k: v.clone() for k, v in init_tr.init_state().items()}
    del init_tr
    main = {}
    eager = _dispatch_trainer(cfg, data, init)
    _dispatch_train(eager)
    graphs = {}
    for name, kw, k in (('k4', dict(steps_per_dispatch=DISPATCH_K), DISPATCH_K),
                        ('epoch_scan', dict(epoch_scan=True), 1)):
        tr = _dispatch_trainer(cfg, data, init, **kw)
        run = _dispatch_train(tr)
        _dispatch_check(name, tr, eager, run, k)
        for n, c in run['launches'].items():
            main[n] = main.get(n, 0) + c
        graphs[name] = tr
    _dispatch_rates(eager, graphs['k4'], graphs['epoch_scan'], data, smi)
    del eager, graphs, tr
    torch.cuda.empty_cache()

    chain = dict(fused_optimizer=False)
    ref = _dispatch_trainer(cfg, data, init, **chain)
    _dispatch_train(ref)
    tr = _dispatch_trainer(cfg, data, init, steps_per_dispatch=DISPATCH_K, **chain)
    _dispatch_check('k4_fused_optimizer_false', tr, ref, _dispatch_train(tr), DISPATCH_K)
    del ref, tr
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, **DISPATCH_SMALL)
    init_tr = Trainer(small, TrainConfig(), norm_stats=PTBXL_TRAIN_STATS['original'])
    init = {k: v.clone() for k, v in init_tr.init_state().items()}
    del init_tr
    for impl in ('flax', 'hash'):
        cfg_i = dataclasses.replace(small, dropout_impl=impl)
        ref = _dispatch_trainer(cfg_i, data, init, grad_accum=2)
        _dispatch_train(ref)
        for name, kw, k in (('k4', dict(steps_per_dispatch=DISPATCH_K), DISPATCH_K),
                            ('epoch_scan', dict(epoch_scan=True), 1)):
            tr = _dispatch_trainer(cfg_i, data, init, grad_accum=2, **kw)
            _dispatch_check(f'{name}_moe_remat_accum2_{impl}', tr, ref, _dispatch_train(tr), k)
            del tr
        del ref
    torch.cuda.empty_cache()
    shutil.rmtree('runs/chip_smoke_dispatch', ignore_errors=True)
    return main


# --------------------------------------------------------------- examples
EXAMPLES_N, EXAMPLES_EPOCHS = 256, 2     # the quickstart's defaults
EXAMPLES_DIR = 'runs/chip_smoke_examples'


def _stage(stages: dict, name: str, fn, **row):
    """Run ``fn`` as the example stage ``name``: its wall seconds and the
    kernels' launches go into ``stages[name]`` (with ``row``); returns
    ``fn()``."""
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    stages[name] = {'seconds': time.perf_counter() - t0, 'launches': _build.launch_counts(), **row}
    return out


def _quickstart(smi: str, stages: dict) -> None:
    """``examples/torch/quickstart.py`` stage by stage on the card as written
    ('tiny', 256 synthetic records, 2 epochs), with ``flash_min_seq=0`` so
    its 41-token layers run #1-#4; the rollout arrays against a CPU rerun."""
    import copy
    from examples.torch import quickstart as qs
    splits = _stage(stages, 'quickstart_splits', lambda: qs.build_splits(EXAMPLES_N))
    model_cfg = VitConfig.from_defined('tiny', flash_min_seq=0)
    cfg = qs.train_config(EXAMPLES_EPOCHS)
    tr, result, test = _stage(stages, 'quickstart_supervised', lambda: qs.supervised(
        splits, model_cfg, cfg, out_dir=f'{EXAMPLES_DIR}/quickstart'))
    stages['quickstart_supervised'].update(best_eval_loss=result['best_eval_loss'],
                                           test_macro_auc=test['macro_auc'])
    mae, _ = _stage(stages, 'quickstart_mae_transfer', lambda: qs.mae_transfer(
        splits, model_cfg, cfg, out_dir=f'{EXAMPLES_DIR}/quickstart-mae'))
    stages['quickstart_mae_transfer']['pretrain_loss'] = mae['loss']
    tok, ids, rf = _stage(stages, 'quickstart_tokenize', lambda: qs.tokenize(splits))
    stages['quickstart_tokenize'].update(clusters=int(tok.centers.shape[0]),
                                         ids_shape=list(ids.shape),
                                         power_law_exponent=float(rf['exponent']))
    sig = qs.rollout_input(splits, model_cfg)
    model = tr.served_model()
    maps, scores = _stage(stages, 'quickstart_rollout_arrays',
                          lambda: qs.rollout_arrays(model, sig))
    maps_cpu, scores_cpu = qs.rollout_arrays(copy.deepcopy(model).cpu(), sig)
    stages['quickstart_rollout_arrays'].update(
        maps_shape=list(maps.shape), maps_card_vs_cpu=_max_err(maps, maps_cpu),
        rollout_card_vs_cpu=_max_err(scores, scores_cpu), limit=ROLLOUT_TOL)
    row = stages['quickstart_rollout_arrays']
    if not (max(row['maps_card_vs_cpu'], row['rollout_card_vs_cpu']) <= ROLLOUT_TOL
            and np.isfinite(scores).all()):
        raise AssertionError(f'the quickstart rollout differs between the card and the CPU: '
                             f'{row}')
    sup = stages['quickstart_supervised']['launches']
    if not (all(sup[k] > 0 for k in ('flash_fwd', 'flash_fwd_lse', 'flash_bwd_dq',
                                     'flash_bwd_dkv', 'adamw', 'adamw_norm'))
            and stages['quickstart_mae_transfer']['launches']['adamw'] > 0
            and np.isfinite(result['best_eval_loss']) and np.isfinite(mae['loss'])):
        raise AssertionError(f'the quickstart did not run #1-#5: {stages}')


def _serving_demo(smi: str, stages: dict) -> None:
    """``examples/torch/serving_demo.py`` on the card with 16 clients, f32
    and ``--int8`` ('debug' at 320 samples, ``flash_min_seq=0`` so its six
    tokens run #1): every client's row equals ``predict`` of its own record,
    and the rows equal a twin's with plain attention
    (``use_flash_attention=False``) on the same weights at ``SERVING_TOL``."""
    from examples.torch import serving_demo as sd
    for int8 in (False, True):
        name = 'serving_demo_int8' if int8 else 'serving_demo'
        cfg = VitConfig.from_defined('debug', max_signal_length=320, flash_min_seq=0)

        def run():
            tr = sd.build_trainer(int8=int8, model_cfg=cfg)
            return tr, sd.run_clients(tr, N_CLIENTS)
        tr, (got, want, health) = _stage(stages, name, run)
        ok = sum(bool(np.allclose(g, np.round(w, 6), atol=2e-6)) for g, w in zip(got, want))
        twin = sd.build_trainer(int8=int8, model_cfg=dataclasses.replace(
            cfg, use_flash_attention=False))
        same_weights = all(torch.equal(a, b) for a, b in
                           zip(tr.state_dict().values(), twin.state_dict().values()))
        err_plain = float(np.abs(np.stack(got) - twin.predict(sd.client_signals(N_CLIENTS)))
                          .max())
        stages[name].update(clients=N_CLIENTS, clients_ok=ok, requests=health['requests'],
                            dispatches=health['dispatches'], same_weights=same_weights,
                            max_abs_err_vs_plain_attention=err_plain, limit=SERVING_TOL)
        del tr, twin
        if not (ok == N_CLIENTS and same_weights and err_plain <= SERVING_TOL
                and stages[name]['launches']['flash_fwd'] > 0):
            raise AssertionError(f'{name}: {stages[name]}')


def examples_phase(smi: str) -> dict:
    """The port's examples as a user runs them, on the card: the
    quickstart's stages up to the rollout arrays (the figure needs
    matplotlib, which the card's machine lacks; the CPU test draws it) and
    the serving demo in f32 and int8.  Prints each stage's wall seconds and
    launches.  Returns the launches (the main path of the phase)."""
    attn.BLOCKED_BWD_MIN_SEQ = 0
    t0 = time.perf_counter()
    stages = {}
    try:
        _quickstart(smi, stages)
        torch.cuda.empty_cache()
        _serving_demo(smi, stages)
    finally:
        shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    main_path = {k: sum(st['launches'][k] for st in stages.values()) for k in _build.COUNTERS}
    emit({'phase': 'examples', 'nvidia_smi': smi, 'stages': stages, 'launches': main_path,
          'seconds': time.perf_counter() - t0})
    return main_path


PHASES = ('kernels', 'serving', 'training', 'pretrain', 'denoise', 'corpus', 'stream',
          'scale', 'artifacts', 'parallel', 'pipeline', 'dispatch', 'examples')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--phases', nargs='+', choices=PHASES, default=list(PHASES),
                    help='run only these phases (default: all; the result line '
                         'is printed only when all ran)')
    ap.add_argument('--flash-other', default=None, metavar='ROOT',
                    help='another checkout of the port (e.g. a git archive of an older '
                         'commit): hold the default calls of #1-#4 to its kernels\' bits')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = ['flash_fwd', 'flash_bwd', 'adamw', 'nlm', 'dropout_sites', 'moe_glue']
    _build.build(libs)
    build_s = time.perf_counter() - t0
    ptxas = {lib: [ln.strip() for ln in
                   open(f'{_build.library_path(lib)}.log').read().splitlines()
                   if 'Compiling entry' in ln or 'registers' in ln or 'spill' in ln]
             for lib in libs}
    emit({'phase': 'env', 'nvidia_smi': smi, 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'device': torch.cuda.get_device_name(0),
          'kernel_build_s': build_s, 'ptxas': ptxas})

    rows, launches = {}, {}
    if 'kernels' in args.phases:
        rows['flash_fwd'] = kernel_phase()
        dropout_mask_phase()
        bwd_dropout_mask_phase()
        rows.update(flash_grad_phase())
        flash_band_phase(args.flash_other)
        rows['adamw'], rows['adamw_norm'] = adamw_phase()
        rows['nlm_rows'] = nlm_phase(*chain_rows())
        rows['nlm_variant'] = nlm_variant_phase()
        launches['nlm_variant'] = rows['nlm_variant']['launches']
        rows.update(dropout_sites_phase())
        rows['moe_glue'], launches['moe_glue'] = moe_glue_phase()
    if 'serving' in args.phases:
        _, launches['flash_fwd'] = serving_phase()
    if 'training' in args.phases:
        launches.update(training_phase())
    if 'pretrain' in args.phases:
        for name, count in pretrain_phase().items():
            launches[name] = launches.get(name, 0) + count
    if 'denoise' in args.phases:
        launches.update(denoise_phase())
    if 'corpus' in args.phases:
        for name, count in corpus_phase(smi).items():
            launches[name] = launches.get(name, 0) + count
    if 'stream' in args.phases:
        for name, count in stream_phase(smi).items():
            launches[name] = launches.get(name, 0) + count
    if 'scale' in args.phases:
        for name, count in scale_phase(smi).items():
            launches[name] = launches.get(name, 0) + count
    if 'artifacts' in args.phases:
        for name, count in artifacts_phase(smi).items():
            launches[name] = launches.get(name, 0) + count
    if 'parallel' in args.phases:
        for name, count in parallel_phase(smi).items():
            launches[name] = launches.get(name, 0) + count
    if 'pipeline' in args.phases:
        for name, count in pipeline_phase(smi).items():
            launches[name] = launches.get(name, 0) + count
    if 'dispatch' in args.phases:
        for name, count in dispatch_phase(smi).items():
            launches[name] = launches.get(name, 0) + count
    if 'examples' in args.phases:
        for name, count in examples_phase(smi).items():
            launches[name] = launches.get(name, 0) + count
    if set(args.phases) != set(PHASES):
        return 0

    print(smi, flush=True)
    emit({'kernels': [{
        'name': name, 'route': 'cuda',
        'source': f'ecg_representation_learning_tpu_torch/ops/csrc/{src}.cu',
        'replaces': replaces, 'launches': launches[name],
        'max_abs_err': rows[name]['max_abs_err'], 'ms': rows[name]['kernel_ms'],
        'plain_ms': rows[name]['plain_ms'], 'bound_ms': rows[name]['bound_ms'],
        'bound_by': rows[name]['bound_by'], 'library_ms': rows[name]['library_ms']}
        for name, src, replaces in KERNELS]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
