#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. Device and build: the card's name and power limit (nvidia-smi), then
   every CUDA kernel of the port built from `incubator_mxnet_torch/csrc/`,
   one nvcc per source, all started together.
2. The short kernel (row 1) against its plain PyTorch version at the
   serving shape (BH = 128*12, T = 128, d = 64), bfloat16 and float32,
   causal on and off, kv_length random with 0 and T among them: max
   error, kernel time, plain-version time, one PyTorch library call's
   time and the card's bound for the same work; the kernel's share of
   its bound, the name and grid of its launch in the profiler's trace
   of one wrapper call, and the host time of one wrapper call.
3. The short kernel's training form (row 1b) at the training shape
   (BH = 60*12, T = 128, d = 64): o and p, and dq, dk, dv of
   `FlashShort` against torch autograd through the plain version; the
   kernel's, the plain version's and the backward's times, the bound,
   the share of it, the traced name and grid of one launch and the host
   time of one wrapper call.
4. The streaming FlashAttention-2 kernels (rows 2-4: `flash_fwd`,
   `flash_bwd_dq`, `flash_bwd_dkv`) against their plain versions at the
   long training shape (BH = 4*12, T = 2048, d = 64), bfloat16 and
   float32, causal on and off, plus cross attention (Tq = 1024,
   Tk = 2048) and T = 1152 (JAX blocks 384), kv_length random with 0 and
   T among them: o, lse (exactly -1e30 on fully masked rows), dq, dk,
   dv (each gradient's error also as a share of its largest value), and
   `Flash`'s gradients against torch autograd through the plain
   forward; then each kernel's time, its plain version's, the fastest
   SDPA backend's (the backward of one SDPA call for rows 3+4 together)
   and the bound, each kernel's causal time beside the causal bound
   (half the operations) and SDPA's causal time; each kernel's share of
   its bound, the name and grid of its launch in the profiler's trace of
   one wrapper call and the host time of one wrapper call; and row 2 at
   the T = 2048 serving forward's shape (BH = 16*12) beside its bounds
   and SDPA's forward.
5. The BTHD kernels (rows 5 and 6: `flash_short_bthd_fwd` in both forms,
   `flash_short_bthd_bwd`) on q, k, v cut as views from one seeded
   (B, T, 3E) buffer, as BERT's fused projection gives them: row 5 at the
   serving shape (B = 128) and its training form at B = 60, row 6 at
   B = 60, bfloat16 and float32, causal on and off, kv_length random with
   0 and T among them: o, p, dq, dk, dv against the plain versions, and
   `FlashShortBTHD`'s gradients against torch autograd through the plain
   forward; each kernel's time, its plain version's, the library call's
   (SDPA on the transposed views; for row 6 its backward less its
   forward), the bound and the share of it (row 5's two forms and row 6
   also the traced name and grid of one launch and the host time of one
   wrapper call), and
   `multi_head_attention`'s time on the default
   route (row 1 or 1b and `flash_short_bwd` with their layout copies) and
   on the BTHD route.
6. Serving at T = 128: BERT-base (bert_12_768_12) classifier in bfloat16
   with seeded Normal(0.02) weights on cuda:0, exported with
   `deploy.export_serving` (capacity 128 rows), served by
   `serving.ServingRuntime` over HTTP on 127.0.0.1, answering 12 POST
   /predict requests of 1-64 rows (8 of them concurrent).  Every answer
   is checked against a direct forward of the same rows with einsum
   attention on the card, and the short kernel must launch 12 times
   (one per encoder layer) for each served batch, no streaming kernel.
7. Serving at T = 2048 (`[serve-long]`): the same model with
   max_length 2048, capacity 16 rows, 6 requests of 1-16 rows; 12
   `flash_fwd` launches per batch and no short-kernel launch.
8. Serving at T = 128 on the BTHD route (`[serve-bthd]`,
   MXNET_FLASH_ATTENTION_BTHD=1 for the phase): as 6, with 12
   `flash_short_bthd_fwd` launches per batch and no other kernel.
9. Training at T = 128: BERT-base classifier, dropout 0, seeded
   Normal(0.02) weights cast to bfloat16, Adam at lr 2e-5, a seeded
   batch of 60 x 128 tokens on cuda:0 (`bench.py`'s `bench_bert`).  Step
   1's loss and the gradients of layer 0's and layer 11's qkv weight on
   the kernel route against `MXNET_FLASH_ATTENTION=0` (einsum
   attention); then `ParallelTrainer.step` 3 times and `run_steps(10)`
   (timed with CUDA events), a by-kernel profile of one step, and 2
   iterations of the imperative `autograd.record()` / `backward()` /
   `gluon.Trainer(..., "adam", lr 2e-5).step(60)` loop.  Losses must be
   finite and the training kernel must launch 12 times (one per layer)
   per step, no other kernel.
10. Training at T = 2048 (`[train-long]`, `bench_bert` with
   BENCH_SEQLEN=2048 BENCH_BATCH=4): the same checks with 3 steps,
   `run_steps(5)` and one imperative iteration; 12 launches of each of
   `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv` per step, no other.
11. Training at T = 128 on the BTHD route (`[train-bthd]`): as 9 with 3
   steps, `run_steps(5)` and one imperative iteration; 12 launches of
   each of `flash_short_bthd_fwd_train` and `flash_short_bthd_bwd` per
   step, no other kernel.
12. The bottleneck backward (row 8, `[bottleneck]`): both kernels
   (`bottleneck_bwd_reduce`, `bottleneck_bwd_apply`) against their plain
   versions and the pair against torch autograd of `bn_dot` at ResNet-50
   stage 1's 1x1 expand (M = 256*56*56, C = 64, K = 256), its reverse
   (C = 256, K = 64), a stage-2 shape (M = 256*28*28, 128 -> 512) and a
   ragged stage-4 M (256*7*7 = 12544, 512 -> 2048); the kernels', the
   plain versions' and autograd's times at stage 1 and its reverse, each
   kernel's share of its bound, and each pass's traced kernel name and
   grid and the host time of one wrapper call there; then
   the tool's own entry (`tools.bottleneck_bwd.main`): the isolated stage
   at its default shape and the 3-block stack (`--full-block`), whose
   fused form launches both kernels.
13. Training ResNet-50 v1b (`[train-resnet]`, `bench.py`'s
   `bench_resnet50`): Xavier weights cast to bfloat16, SGD (lr 0.1,
   momentum 0.9, wd 1e-4), a seeded batch of 256 x 3 x 224 x 224; 3
   steps, `run_steps(5)` timed with CUDA events, one profiled step and
   one imperative iteration.  Losses finite and falling; running stats
   moved; no hand kernel launches (ResNet has no Pallas kernel).
14. The predict-mode forward at 256 (`[infer-resnet]`): device time and
   images/s; running stats unchanged.
15. `[resnet-check]`: batch 8 at 224 x 224, bfloat16 against float32
   (TF32 off) from the same weights: logits, the step-1 loss, and the
   gradients of `features.0.weight`, `output.weight` and `features.1.gamma`.
16. Kernel row 7 (`[rtc]`, `incubator_mxnet_torch/rtc.py`): the user
   `CudaModule` of `softmax_rtc.py` (a float32 softmax forward that reads
   a row of up to 1024 columns once, into registers; SoftmaxOutput's
   backward p - onehot(label); a template `axpy<T>` reached through
   `exports`, float32 and bfloat16) built at
   first use, each kernel against its plain version at 1024 x 10 and
   8192 x 1000; a second module of the same source runs no nvcc; a
   syntax error raises with nvcc's message and a float64 argument before
   launch; at 8192 x 1000 each kernel's time, its plain version's, the
   bound, `torch.softmax`'s (forward) and `add_`'s (axpy) times, the
   host time of one launch and the first-use compile time; at 1024 x 10
   each kernel's time beside `torch.softmax`'s.
17. `[train-rtc]`: `MLP()` (784-128-64-10, Xavier) trained 20 steps on a
   seeded 1024 x 1 x 28 x 28 batch through `record()` /
   `nd.Custom(out, label, op_type="softmax_rtc")` / `backward()` /
   `gluon.Trainer(sgd lr 0.1 momentum 0.9).step(1024)`: one forward and
   one backward rtc launch a step, losses finite and falling, step 1's
   gradients those of `SoftmaxCrossEntropyLoss`.
18. `[train-lenet]`: `bench_lenet` (LeNet, Xavier, SGD lr 0.1 momentum
   0.9, batch 1024) through `ParallelTrainer.step` 3 times and
   `run_steps(10)` with the plain loss (timed with CUDA events), then 3
   imperative iterations with the softmax_rtc head.
19. `[rnn-check]`: the fused `RNN` op on cuda:0 against the same op on
   the CPU at T = 7, N = 3, I = 5, H = 6, 2 layers, every mode (lstm,
   gru, rnn_tanh, rnn_relu), uni- and bidirectional: out, hy, cy and the
   gradients of data, parameters and states, in float32 (TF32 off) and
   in bf16; bf16 against float32 on the card by cosine; the bf16 op's
   float32 cell state on the card against the CPU's; and the two bf16
   product routes (`torch.mm(..., out_dtype=torch.float32)`, the
   forward's, and the float32 product, the backward's) timed at
   `bench_lstm`'s recurrent and input shapes.
20. `[train-lstm]`: `bench_lstm` (`LSTMLanguageModel(10000, 650, 650, 2
   layers)`, Xavier, bf16, SoftmaxCrossEntropyLoss, SGD lr 1.0): first
   two steps on a 4 x 35 batch from one set of weights on the card and
   on the CPU, losses and weights compared; then a seeded batch of
   512 x 35 token ids through `ParallelTrainer.step` 3 times and
   `run_steps(10)` timed with CUDA events: step ms, tokens/s, one
   profiled step's device ms, idle share, top kernels and launching ops;
   losses finite and falling; no hand kernel.  Beside it, as a yardstick
   that nothing on the path calls, cuDNN's `torch.nn.LSTM(650, 650, 2)`
   in bf16 at (35, 512, 650), forward and forward + backward.
21. `[lstm-example]`: the word-LM example's loop (`example/gluon/
   word_language_model/train.py:97-157`): its first three batches at
   dropout 0 from one set of weights on the card and on the CPU in
   float32, losses, carried states and weights compared; then its
   defaults (emsize and nhid 200, 2 layers, batch 32, bptt 35, dropout
   0.2, SGD lr 1.0, `clip_gradient` 0.25) on its synthetic corpus of 500
   words from seed 0, TNC, the hidden state carried and detached, 4
   epochs, then one predict-mode pass over the validation split: train
   and validation perplexity below 450.
22. `[zoo-check]`: one model per vision-zoo family at full width and
   its own resolution (resnet50_v2, cifar_resnet20_v2 at 32, vgg16_bn,
   alexnet, squeezenet1.1, mobilenet1.0, mobilenetv2_1.0, densenet121 at
   224, inceptionv3 at 299), 1000 classes, seeded Xavier weights: the
   predict-mode forward at batch 2 on the card in float32 (TF32 off)
   against the port on the CPU from the same weights (rtol and atol 1e-4
   of the largest logit), and in bf16 against float32 on the card
   (cosine >= 0.99); each model's error as a share of its tolerance.
23. `[infer-zoo]`: each of those models' predict-mode forward at batch 64
   in bf16: ms a batch, images/s, the profiled device time, launches and
   idle share, the top kernels and launching ops, peak memory; output
   (64, 1000) and finite, running stats unchanged, no hand kernel.
24. `[train-zoo]`: MobileNetV2 1.0 on `bench_resnet50`'s recipe (Xavier,
   bf16, SoftmaxCrossEntropyLoss on float32 logits, SGD lr 0.1, momentum
   0.9, wd 1e-4): first 2 `ParallelTrainer` steps at 4 x 224² from one
   set of weights on the card, on the CPU and on the CPU without oneDNN
   in float32 (TF32 off): step 1's loss rtol 1e-4, then step 2's loss,
   the update and the running stats within 3 times the CPU's own spread
   (training is chaotic after one update; `MNV2_SPREAD_FACTOR`); then
   256 x 3 x 224 x 224 random images and labels from numpy
   seed 0 through 3 steps and `run_steps(10)` (CUDA events), a profiled
   step (device time, launches, idle share, top kernels and launching
   ops, the shares of `cudnn_convolution`, `convolution_backward`, the
   depthwise kernels and `nchwToNhwc`/`nhwcToNchw`) and 2 iterations of the
   imperative loop; peak memory; losses finite, every running stat
   moved, no hand kernel.
25. `[optim-check]`: every optimizer (SGD, NAG, Adam, AdaGrad, RMSProp
   plain and centered, AdaDelta, Ftrl, Signum, LAMB with and without
   bias correction, DCASGD at momentum 0 and 0.9), 3 updates of a bf16
   3072 x 768 weight by seeded float32 gradients on the card and on the
   CPU from the same values: weights within 1 bf16 ulp, float32 states
   within 1e-5 of their largest (DCASGD's bf16 ones within 1 ulp), and
   each update's time on the card; then the three lazy row updates
   (`sgd_update_rsp`, `sgd_mom_update_rsp`, `adam_update_rsp`) on a bf16
   30522 x 768 table with 7680 seeded ids: rows outside the ids bitwise
   unchanged, weights and states, touched rows within 1 ulp of the CPU.
26. `[loss-check]`: every Gluon loss block in float32 on the card
   against the CPU (CTC at T = 100, N = 32, C = 30, L = 20, with and
   without lengths): values and input gradients within 1e-5 of their
   largest; MXNet's sigmoid `autograd.Function` in a recorded graph on
   the card against torch autograd of the same expression.
27. `[train-lamb]`: the `[train]` model and batch through 3 imperative
   iterations of `gluon.Trainer(..., "lamb", lr 1e-3, wd 0.01)`: losses
   finite; for the word embedding, layer 0's qkv weight and the
   classifier weight, each update within 1 bf16 ulp of a float64
   recompute of LAMB's two phases from the step's saved weight,
   gradient and states, the trust ratio within 1e-3 relative, and the
   port's phases run again on the saved values giving the same bits;
   12 `flash_short_fwd_train` launches an iteration and no other hand
   kernel; iteration times (CUDA events) and a profiled iteration.
28. `[train-sparse]`: `bench_bert` with `sparse_embed=True` (Adam 2e-5):
   `ParallelTrainer` step 1 against a dense twin holding the same
   weights (the lazy update must run; touched rows within 1 bf16 ulp
   of the twin's, every other parameter bitwise equal), steps 2-3 and
   `run_steps(5)` (rows the batch lacks keep their weights and both
   Adam moments bitwise), both trainers' step times over `run_steps(5)`
   side by side, a profiled step, then 2 iterations of
   `gluon.Trainer(..., "adam")` whose word-embedding gradient must be a
   `RowSparseNDArray` of the batch's sorted unique ids; 12 launches a
   step.
29. `[checkpoint]`: that trainer's `param_bytes()` and
   `optimizer_state_bytes()` against the sums over its tensors, then
   `save_checkpoint` to a temporary directory, `load_checkpoint` into a
   model built from another seed, and one more step on each: losses and
   every weight bitwise equal; save and load times.
30. `[interleaved-attn]`: BERT-base self-attention at 60 x 128 bf16
   through the interleaved ops against `multi_head_attention` (the
   kernel route): the worst error of 12 layers' outputs and gradients,
   12 launches of rows 1 and 1b, each route's device and wall times.
31. `[ops-check]`: every registered op name but the quantized ones
   (`tools/op_cases.py`: the core names and those of `extended.py`,
   `contrib.py` and `linalg.py`) on the card against the CPU in float32
   with TF32 off, gradients where the op has them, within 1e-5 of the
   largest value, the sweeps' and matchings' kept sets equal, gelqf and
   syevd by their invariants (A = L·Q, Q·Qᵀ = I; Uᵀ·diag(Λ)·U = A) and
   rows equal up to sign, the bf16 forward finite; the samplers'
   moments at 10^6 draws; the NDArray repairs on the card; and
   `nd.sparse.dot` of a Criteo-sized CSR batch (8,192 x 2^20, 39
   entries a row) and a 2^20 x 64 weight, plain and `transpose_a`.
32. `[detect-check]`: SSD300's 8,732 anchors (`MultiBoxPrior` on six
   maps), `MultiBoxTarget` at batch 32 with 16 padded label rows,
   `MultiBoxDetection` on (32, 21, 8732), `box_nms` on (32, 8732, 6)
   and `ROIAlign` at Faster R-CNN R-50-C4's head (2 x 1024 x 38 x 50,
   512 RoIs an image, 14 x 14, ratio 2), the card against the CPU
   (8 images, 64 RoIs): targets, masks and kept sets equal but where
   an IoU or score lies within 1e-5 of its threshold (counted),
   continuous outputs within 1e-5 of their largest value; each op's
   device ms and peak memory; no hand kernel.
33. `[train-ssd]`: `example/ssd/train_ssd.py`'s TinySSD loop through
   the port at the example's defaults (batch 32, 150 batches, Adam
   2e-3): mean IoU on 64 images over the example's bar 0.3, recall@0.5,
   a step's wall and device time; no hand kernel.
34. `[io-check]`: the input path on the card against the CPU port, bit
   for bit: `NDArrayIter` (shuffled, `state()` mid-epoch and
   `restore()`), `PrefetchingIter` over two iterators, `CSVIter`,
   `LibSVMIter` on a generated file at Criteo's width (2^20 features,
   39 entries a row, batches of 8,192; its CSR batches through
   `nd.sparse.dot` with a 2^20 x 64 weight against the dense product),
   `DataLoader` with 0 workers, 4 thread workers and 4 process workers
   (pinned; no process worker initializes CUDA) and
   `DevicePrefetcher(threads=3)` over a shuffled loader, in the
   sampler's order; no hand kernel.
35. `[train-loader]`: `bench_resnet50`'s model and recipe fed by
   `DataLoader(SyntheticImageDataset(2048, 3 x 224 x 224), 256,
   shuffle=True, num_workers=min(8, cores), pin_memory=True)` through
   `DevicePrefetcher(trainer=tr, depth=2)` into `ParallelTrainer.step`
   for 8 steps (the float32 batch cast to bf16 on the card): the core
   count, the feed rate alone, the loader-fed step against
   `[train-resnet]`'s resident step (vs_synthetic), the consumer's
   stall, a profiled step's device time and idle share; losses finite
   and falling, the first batch equal to the CPU port's of its indices,
   no worker process with CUDA, no hand kernel.
36. `[estimator]`: `Estimator.fit` of `train_dist.py`'s net
   (resnet18_v1, thumbnail, 10 classes) for 3 epochs of
   `SyntheticImageDataset(2048, 3 x 32 x 32)` at batch 64 with
   RandomFlipLeftRight and Normalize, `LoggingHandler`,
   `CheckpointHandler` and `EarlyStoppingHandler`; held-out accuracy
   over `EST_MIN_ACC`; the last checkpoint loaded into a fresh net gives
   its outputs; then `train_dist.py`'s loop body on one card
   (`NDArrayIter`, `metric.Accuracy`, `callback.Speedometer` text and
   JSON records; the kvstore left out); no hand kernel.
37. `[image-check]`: the port's host library (JPEG codec, RecordIO,
   record pipeline) built by the host's `c++` (seconds, version line;
   `ldd` shows no CUDA library), `pack_img` -> `unpack_img` at 224^2 and
   375 x 500, q95 and q85, 4:2:0 (RGB and luma PSNR; the luma over
   30 dB), `imdecode`'s centre crops equal to the pipeline's pixels,
   `ImageRecordIter` on both engines (labels and pixels bit-equal), the
   1/8 and 1/4 decodes (1024^2 and 512^2 at resize 128) against the full
   decode and a box average, `ImageDetIter` with `CreateDetAugmenter`
   over a 300^2 VOC-shaped batch on the card equal to the CPU's, and a
   corrupt record counted as one decode failure; no hand kernel.
38. `[train-record]`: `bench_resnet50_input`: a 1024-image JPEG shard
   (256^2, q85, the port's `build_shard`), the native pipeline (shuffle,
   random crop and mirror, resize 256, uint8 NHWC, max(2, cores)
   threads, 4 page-locked slots) through `staging_ring(trainer=tr)`
   into `ParallelTrainer` SGD of `NormalizedResNet` (normalize on the
   card, resnet50_v1b in bf16): the feed alone, one slot's copy to the
   card, the pre-filled slots drained, 16 steady steps over endless
   epochs (images/s, vs_synthetic against `[train-resnet]`, the stall),
   a profiled step's device time and idle share; losses finite, decode
   failures 0, no hand kernel.
39. `[serve-buckets]`: BERT-base bf16 exported with batch buckets, at
   T = 128 (capacity 128, buckets 1-64) and T = 2048 (capacity 16,
   buckets 1-8): at each bucket's batch row 1 (T = 128) or row 2
   (T = 2048) against its plain version, with its time beside the
   bound; then requests sized to hit every bucket, one at a time,
   through a bucketed and a flat (`MXNET_SERVE_BUCKETS=0`) runtime:
   12 launches of the kernel a batch and no other, every bucketed row
   bit for bit a direct call at its pad target and the flat runtime's
   row, within `LOGIT_ATOL` of the einsum forward, per bucket the
   forward's ms back to back and its kernels' ms, and the p50 latency
   of a request of that size bucketed and flat, and the
   `serving_batch_pad_rows`
   histogram; at T = 128 also a reload to a corrupt artifact that
   leaves the outputs bit for bit and the allocated memory unchanged.
40. `[serve-chaos]`: `incubator_mxnet_torch.tools.serve_chaos` through
   `python -m incubator_mxnet_torch.serving --ctx gpu` on BERT-base bf16
   at T = 128, capacity 8 (a deadline 504, poison 500s tripping the
   breaker, its fast 503 and half-open probe, 400s, a 429 burst, a
   corrupt reload rolled back, a good reload to a second seed, a
   mid-flight SIGTERM, the fault counters in /metrics, the debugz pages
   on the serving port): the reload's seconds, the breaker-open 503's
   latency and the drain seconds.
41. `[fleet]`: `incubator_mxnet_torch.tools.fleet_chaos`: a router
   process over three replica processes, each serving BERT-base bf16 at
   T = 128, capacity 8 without buckets, under client load through a
   SIGKILL, a wedged replica and a rolling deploy: every answer a 200
   bit for bit the baseline's, or a shed with Retry-After; the router's
   requests/s, p50 and p99 and the deploy's seconds.
42. A JSON line describing each kernel, then the card line, then the
   final `{"ok": true, ...}` line.

Exits non-zero, printing no result, without CUDA or outside a checkout
of the repository.
"""
import contextlib
import http.client
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the SM clock's top rate (1.98 GHz): a sleep of this many cycles a second
# lasts at least that second at any clock the card runs
SLEEP_CYCLES_PER_S = 1.98e9

BH_BATCH, HEADS, T, D = 128, 12, 128, 64
TRAIN_BATCH, LAYERS = 60, 12
# the long paths: training 4 x 2048, serving capacity 16 x 2048
LONG_T, LONG_TRAIN_BATCH, LONG_CAPACITY = 2048, 4, 16
LONG_REQUEST_ROWS = (1, 16, 5, 3, 11, 16)
ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the saved p: float32 agrees to rounding; bfloat16 to one step below 1
P_ATOL = {torch.bfloat16: 2 ** -8, torch.float32: 1e-6}
# FlashShort's and Flash's gradients against torch autograd through the
# plain version, and the streaming backward kernels against their plain
# versions, relative to the largest reference gradient: the backward
# rounds p and ds to bfloat16 where autograd through the plain version
# keeps both in float32
GRAD_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Step 1 of BERT-base bf16 on the kernel route against einsum attention:
# the einsum route rounds the scores to bfloat16 before the softmax
# where the kernel keeps them in float32, and the difference goes
# through 12 layers forward and back.  Loss: 1e-2 absolute (1.4% of
# ln 2, the loss at this initialization); gradients: 5e-2 relative
# (Frobenius norm of the difference over the einsum route's norm).
# The streaming forward's lse on rows with kv_length > 0 (float32 on both
# sides, sums in another order); a fully masked row's lse is exactly
# -1e30 on both.
LSE_ATOL = 1e-4
STEP1_LOSS_ATOL = 1e-2
STEP1_GRAD_RTOL = 5e-2
# Served logits against a direct forward with plain attention: both in
# bfloat16 through 12 layers, in batches of different size (the server
# pads to 128 rows), so matmul tiling and rounding differ.
LOGIT_ATOL = 5e-2
REQUEST_ROWS = (1, 64, 5, 17, 32, 3, 48, 8, 2, 64, 11, 40)
N_SEQUENTIAL = 4        # the rest are sent concurrently


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` back-to-back calls.  A
    kernel can finish before the host has dispatched the next call (a
    wrapper's checks and launch take tens of microseconds), so the card
    first runs a sleep that outlasts the host's enqueue of all `iters`
    calls, which then run back to back; the sleep is lengthened and the
    reading retaken while the enqueue outlasts it (at most twice: a
    launch queue that fills makes the host wait whatever the sleep)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    sleep_s = 0.005
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enqueue_s < sleep_s:
            break
        sleep_s = 2 * enqueue_s
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=10):
    """Device time of fn() per call: its CUDA kernels' time summed by
    torch.profiler over `iters` calls, without the host's dispatch gaps
    that `time_ms` counts when fn() launches many small kernels."""
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / iters / 1e3


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def phase_build():
    from incubator_mxnet_torch import _kernels
    t0 = time.time()
    logs = _kernels.build_all()
    log(f"[build] {len(_kernels.SOURCES)} kernel source(s) in "
        f"{time.time() - t0:.1f} s (built now: {sorted(logs) or 'none'})")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                log(f"[build] {name}: {line.strip()}")


def host_us(fn, iters=50, repeats=5):
    """Host microseconds of one fn() call: the least over `repeats` of
    the mean of `iters` calls enqueued behind a device sleep, so that the
    launch queue never fills and the least-disturbed reading of a shared
    host is kept."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda._sleep(int(0.05 * SLEEP_CYCLES_PER_S))
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return best


def traced_launch(fn, kernel, attempts=8):
    """(name, grid) of the one launch of a kernel whose name holds
    `kernel` in a fn() call, as torch.profiler's trace of that call
    records it: the grid is the blocks along x, y and z.  A trace on the
    card has been seen to hold no kernel event of a call at all, at times
    for several calls in a row (the profiler's loss, not the kernel's:
    the launch counts and the checks against the plain versions show
    each launch), so a call whose trace holds no kernel event is traced
    again after a pause, the profiler recording the host beside the card
    on every other attempt and the later attempts tracing three calls
    in one session (a trace has also been seen to keep some of a
    session's kernel events and lose the rest, so a trace without a
    launch of `kernel` is taken as lost too); after `attempts` such
    traces the launch is reported as not traced, (None, None).  A trace
    with more launches of `kernel` than calls, or launches that differ
    in name or grid, fails."""
    from torch.profiler import profile, ProfilerActivity
    for i in range(attempts):
        activities = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if i % 2 else [])
        calls = 1 if i < attempts // 2 else 3
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = [e for e in events
                   if str(e.get("cat", "")).lower() == "kernel"]
        found = [(e["name"], e["args"]["grid"]) for e in kernels
                 if kernel in e.get("name", "")]
        if len(found) > calls or len(set((n, tuple(g))
                                         for n, g in found)) > 1:
            raise AssertionError(
                f"the trace of {calls} call(s) holds {len(found)} launches "
                f"of {kernel} among its {len(kernels)} kernel events")
        if found:
            name, grid = found[0]
            # the first identifier that holds `kernel`, namespaces,
            # template arguments and parameters left out
            return next(w for w in re.findall(r"[A-Za-z_]\w*", name)
                        if kernel in w), grid
        log(f"[trace] no launch of {kernel} among the {len(kernels)} "
            f"kernel events of the trace of {calls} call(s); tracing again")
        time.sleep(1.0)
    log(f"[trace] {kernel}: no launch in {attempts} traces; it is reported "
        f"as not traced")
    return None, None


def _launch_facts(fn, kernel="short_fwd_"):
    """The name and grid of the launch of the kernel whose name holds
    `kernel` (by default the short forward's), from the trace of one
    wrapper call fn(), and the host microseconds of one such call."""
    name, grid = traced_launch(fn, kernel)
    return {"kernel": name, "grid": grid, "host_us": host_us(fn)}


def _facts_text(facts):
    traced = ("grid not traced (the profiler recorded no kernel event)"
              if facts["grid"] is None
              else f"grid {facts['grid']} ({facts['kernel']}, traced)")
    return f"{traced}, host {facts['host_us']:.1f} us a call"


def phase_kernels():
    """Kernel vs plain version; returns the main-path config's record."""
    import torch.nn.functional as F
    from incubator_mxnet_torch.ops.flash_attention import (
        flash_short_fwd, flash_short_reference)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bh = BH_BATCH * HEADS
    per_row = torch.randint(0, T + 1, (BH_BATCH,), generator=gen,
                            device="cuda", dtype=torch.int32)
    per_row[0], per_row[1] = 0, T
    lengths = per_row.repeat_interleave(HEADS)
    scale = D ** -0.5
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(bh, T, D, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        for causal in (False, True):
            out = flash_short_fwd(q, k, v, lengths, scale, causal)
            ref = flash_short_reference(q, k, v, lengths, scale, causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= ATOL[dtype]:
                raise AssertionError(
                    f"kernel disagrees with its plain version: {dtype} "
                    f"causal={causal} max|err|={err} > {ATOL[dtype]}")
            if not torch.isfinite(out.float()).all():
                raise AssertionError("kernel output is not finite")
            # library yardstick: one SDPA call with the same masks as an
            # additive -1e30 mask (timed only; the port never calls it)
            add = _sdpa_mask(per_row, causal, dtype)
            q4, k4, v4 = (t.view(BH_BATCH, HEADS, T, D) for t in (q, k, v))
            ms = time_ms(lambda: flash_short_fwd(q, k, v, lengths, scale,
                                                 causal))
            plain_ms = time_ms(lambda: flash_short_reference(
                q, k, v, lengths, scale, causal))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=add, scale=scale))
            nbytes = 4 * q.numel() * q.element_size() + lengths.numel() * 4
            bound_ms, bound_by = _bound(nbytes, 4 * bh * T * T * D, dtype)
            facts = _launch_facts(lambda: flash_short_fwd(
                q, k, v, lengths, scale, causal))
            rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, **facts}
            records[(dtype, causal)] = rec
            log(f"[kernel] flash_short_fwd {str(dtype)[6:]} causal={causal} "
                f"BH={bh} T={T} d={D}: max|err|={err:.3e} "
                f"(atol {ATOL[dtype]}), kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({rec['bound_by']}), "
                f"{100 * bound_ms / ms:.1f}% of bound, {_facts_text(facts)}")
            del out, ref
    return records[(torch.bfloat16, False)]


def _bound(nbytes, ops, dtype):
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def phase_train_kernels():
    """Kernel row 1b (the training form) and FlashShort's backward
    against their plain versions; returns the training config's record."""
    from incubator_mxnet_torch.ops.flash_attention import (
        FlashShort, flash_short_bwd, flash_short_fwd_train,
        flash_short_reference)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bh = TRAIN_BATCH * HEADS
    per_row = torch.randint(0, T + 1, (TRAIN_BATCH,), generator=gen,
                            device="cuda", dtype=torch.int32)
    per_row[0], per_row[1] = 0, T
    lengths = per_row.repeat_interleave(HEADS)
    live = lengths > 0              # batch-heads with a key to attend to
    scale = D ** -0.5
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn(bh, T, D, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        for causal in (False, True):
            o, p = flash_short_fwd_train(q, k, v, lengths, scale, causal)
            ro, rp = flash_short_reference(q, k, v, lengths, scale, causal,
                                           save_p=True)
            torch.cuda.synchronize()
            o_err, p_err = _max_err(o, ro), _max_err(p, rp)
            if not (o_err <= ATOL[dtype] and p_err <= P_ATOL[dtype]):
                raise AssertionError(
                    f"training kernel disagrees with its plain version: "
                    f"{dtype} causal={causal} o {o_err} (atol {ATOL[dtype]})"
                    f", p {p_err} (atol {P_ATOL[dtype]})")
            # gradients: FlashShort (kernel forward + _bwd_short) against
            # torch autograd through the plain version on the batch-heads
            # with kv_length > 0; a fully masked batch-head's dq and dk
            # follow the JAX package (p = 1/T sends gradient into k), so
            # there they are held to _bwd_short on the plain version's
            # (o, p)
            a = [t.clone().requires_grad_() for t in (q, k, v)]
            b = [t.clone().requires_grad_() for t in (q, k, v)]
            FlashShort.apply(*a, lengths, scale, causal).backward(do)
            flash_short_reference(*b, lengths, scale, causal).backward(do)
            jax_rule = flash_short_bwd(q, k, v, ro, rp, do, scale)
            grad_errs = {}
            for name, x, y, z in zip(("dq", "dk", "dv"), a, b, jax_rule):
                ref = y.grad.float().abs().max().item()
                err = max(_max_err(x.grad[live], y.grad[live]),
                          _max_err(x.grad[~live], z[~live]))
                grad_errs[name] = err
                if not err <= GRAD_RTOL[dtype] * ref:
                    raise AssertionError(
                        f"FlashShort {name} disagrees: {dtype} "
                        f"causal={causal} max|err|={err} > "
                        f"{GRAD_RTOL[dtype]} x {ref}")
            if not all(torch.isfinite(t.float()).all() for t in (o, p)):
                raise AssertionError("training kernel output is not finite")
            ms = time_ms(lambda: flash_short_fwd_train(q, k, v, lengths,
                                                       scale, causal))
            plain_ms = time_ms(lambda: flash_short_reference(
                q, k, v, lengths, scale, causal, save_p=True))
            bwd_ms = time_ms(lambda: flash_short_bwd(q, k, v, o, p, do,
                                                     scale))
            nbytes = (4 * q.numel() + p.numel()) * q.element_size() + \
                lengths.numel() * 4
            bound_ms, bound_by = _bound(nbytes, 4 * bh * T * T * D, dtype)
            facts = _launch_facts(lambda: flash_short_fwd_train(
                q, k, v, lengths, scale, causal))
            rec = {"max_abs_err": max(o_err, p_err), "ms": ms,
                   "plain_ms": plain_ms, "bwd_ms": bwd_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, **facts}
            records[(dtype, causal)] = rec
            log(f"[kernel] flash_short_fwd_train {str(dtype)[6:]} "
                f"causal={causal} BH={bh} T={T} d={D}: o max|err|="
                f"{o_err:.3e} (atol {ATOL[dtype]}), p max|err|={p_err:.3e} "
                f"(atol {P_ATOL[dtype]:.3e}); FlashShort dq/dk/dv max|err| "
                f"{grad_errs['dq']:.3e}/{grad_errs['dk']:.3e}/"
                f"{grad_errs['dv']:.3e} (rtol {GRAD_RTOL[dtype]}); kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, backward "
                f"{bwd_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                f"{100 * bound_ms / ms:.1f}% of bound, {_facts_text(facts)}; "
                f"library: no single PyTorch call returns p")
            del o, p, ro, rp, a, b, jax_rule
    return records[(torch.bfloat16, False)]


def _stream_inputs(gen, batch, tq, tk, dtype):
    """q, k, v, do for `batch` x HEADS batch-heads, and kv_length random
    per batch element with 0 and Tk among them."""
    bh = batch * HEADS
    q, do = (torch.randn(bh, tq, D, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, tk, D, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    per_row = torch.randint(0, tk + 1, (batch,), generator=gen,
                            device="cuda", dtype=torch.int32)
    per_row[0], per_row[1] = 0, tk
    return q, k, v, do, per_row.repeat_interleave(HEADS)


def _check_stream_case(fa, dtype, causal, tq, tk, gen):
    """One case of rows 2-4 against their plain versions; returns the
    kernels' max errors {name: err}."""
    bq, bk = fa._fit_block(512, tq), fa._fit_block(1024, tk)
    q, k, v, do, lengths = _stream_inputs(gen, LONG_TRAIN_BATCH, tq, tk,
                                          dtype)
    live = lengths > 0
    scale = D ** -0.5
    what = (f"{str(dtype)[6:]} causal={causal} Tq={tq} Tk={tk} "
            f"blocks=({bq}, {bk})")
    o, lse = fa.flash_fwd(q, k, v, lengths, scale, causal, bq, bk)
    ro, rlse = fa.flash_fwd_reference(q, k, v, lengths, scale, causal, bq,
                                      bk)
    torch.cuda.synchronize()
    o_err = _max_err(o, ro)
    lse_err = _max_err(lse[live], rlse[live])
    if not (o_err <= ATOL[dtype] and lse_err <= LSE_ATOL
            and torch.all(lse[~live] == -1e30)
            and torch.isfinite(o.float()).all()):
        raise AssertionError(
            f"flash_fwd disagrees with its plain version: {what}: o "
            f"{o_err} (atol {ATOL[dtype]}), lse {lse_err} (atol {LSE_ATOL})"
            f", fully masked rows' lse {lse[~live].unique().tolist()}")
    delta = (do.float() * ro.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, rlse, delta, lengths, scale, causal, bq, bk)
    got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    plain = (fa.flash_bwd_dq_reference(*args),
             *fa.flash_bwd_dkv_reference(*args))
    torch.cuda.synchronize()
    errs = {"flash_fwd": o_err}
    grads = []           # each gradient's error, and as a share of its top
    for name, x, y in zip(("dq", "dk", "dv"), got, plain):
        err, top = _max_err(x, y), y.float().abs().max().item()
        if not err <= GRAD_RTOL[dtype] * top:
            raise AssertionError(f"flash_bwd {name} disagrees with its plain "
                                 f"version: {what}: {err} > "
                                 f"{GRAD_RTOL[dtype]} x {top}")
        key = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
        errs[key] = max(errs.get(key, 0.0), err)
        grads.append(f"{name} {err:.3e} ({err / top:.2e} of max|{name}|)")
    # Flash (kernel forward, delta, both backward kernels) against torch
    # autograd through the plain forward on the batch-heads with
    # kv_length > 0; a fully masked batch-head follows the JAX rule
    # (p = 1 on the visited keys), so there it is held to the plain
    # backward versions
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.Flash.apply(*a, lengths, scale, causal, bq, bk).backward(do)
    fa.flash_fwd_reference(*b, lengths, scale, causal, bq, bk)[0] \
        .backward(do)
    torch.cuda.synchronize()
    shown = []
    for name, x, y, z in zip("qkv", a, b, plain):
        for rows, ref in ((live, y.grad), (~live, z)):
            err = _max_err(x.grad[rows], ref[rows])
            top = ref[rows].float().abs().max().item()
            if not err <= GRAD_RTOL[dtype] * top:
                raise AssertionError(
                    f"Flash d{name} disagrees: {what}: {err} > "
                    f"{GRAD_RTOL[dtype]} x {top}")
        shown.append(f"{_max_err(x.grad[live], y.grad[live]):.2e}")
    log(f"[kernel] flash_fwd/flash_bwd_dq/flash_bwd_dkv {what} BH="
        f"{q.shape[0]} d={D}: o {o_err:.3e} (atol {ATOL[dtype]}), lse "
        f"{lse_err:.3e} (atol {LSE_ATOL}, -1e30 on kv_length 0), "
        f"{', '.join(grads)} (rtol {GRAD_RTOL[dtype]}); Flash dq/dk/dv vs "
        f"autograd {'/'.join(shown)}")
    return errs


def _sdpa_fastest(fn):
    """{backend name: ms} of fn() under each SDPA backend other than the
    math one that runs it on these inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend):
                fn()
                times[backend.name] = time_ms(fn)
        except RuntimeError:
            continue
    if not times:
        raise AssertionError("no SDPA backend ran")
    return times


def _sdpa_times(q4, k4, v4, do4, scale):
    """The fastest SDPA backend's forward, and the fastest one's backward
    (autograd's forward and backward less that backend's forward), on q4,
    k4, v4 (B, H, T, d), non-causal and causal: ({"flash_fwd": ms,
    "flash_bwd_dq": ms, "flash_bwd_dkv": ms, "backend": names}, the same
    keys causal)."""
    import torch.nn.functional as F
    leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
    out = []
    for causal in (False, True):
        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, scale=scale,
                                                  is_causal=causal)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(*leaves, scale=scale,
                                               is_causal=causal)
            return torch.autograd.grad(o, leaves, do4)
        fwd = _sdpa_fastest(sdpa)
        both = _sdpa_fastest(sdpa_fwd_bwd)
        bwd = {n: ms - fwd[n] for n, ms in both.items() if n in fwd}
        f_name, b_name = min(fwd, key=fwd.get), min(bwd, key=bwd.get)
        out.append({"flash_fwd": fwd[f_name], "flash_bwd_dq": bwd[b_name],
                    "flash_bwd_dkv": bwd[b_name],
                    "backend": f"forward {f_name}, backward {b_name}"})
    return out[0], out[1]


def _stream_facts(call, kernel):
    """A streaming kernel's name and grid, from the trace of one wrapper
    call() that launches it (`kernel` is part of its name), and the host
    microseconds of one such call."""
    name, grid = traced_launch(call, kernel)
    return {"kernel": name, "grid": grid, "host_us": host_us(call)}


def _stream_fwd_serving(fa, gen):
    """Row 2 in bf16 at the T = 2048 serving forward's shape (BH =
    LONG_CAPACITY x HEADS, every kv_length T), non-causal and causal,
    beside its bounds and the fastest SDPA backend's forward."""
    import torch.nn.functional as F
    batch, scale, blocks = LONG_CAPACITY, D ** -0.5, (512, 1024)
    bh = batch * HEADS
    q, k, v, _, _ = _stream_inputs(gen, batch, LONG_T, LONG_T, torch.bfloat16)
    full = torch.full((bh,), LONG_T, dtype=torch.int32, device="cuda")
    ms = time_ms(lambda: fa.flash_fwd(q, k, v, full, scale, False, *blocks))
    causal_ms = time_ms(lambda: fa.flash_fwd(q, k, v, full, scale, True,
                                             *blocks))
    q4, k4, v4 = (t.view(batch, HEADS, -1, D) for t in (q, k, v))
    lib = [_sdpa_fastest(lambda c=c: F.scaled_dot_product_attention(
        q4, k4, v4, scale=scale, is_causal=c)) for c in (False, True)]
    (lib_name, lib_ms), (lib_causal_name, lib_causal_ms) = (
        min(t.items(), key=lambda kv: kv[1]) for t in lib)
    nbytes = 4 * q.numel() * 2 + bh * LONG_T * 4 + bh * 4
    work = 4 * bh * LONG_T * LONG_T * D
    bound_ms, bound_by = _bound(nbytes, work, torch.bfloat16)
    causal_bound_ms = _bound(nbytes, work // 2, torch.bfloat16)[0]
    rec = {"bh": bh, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib_ms, "causal_ms": causal_ms,
           "causal_bound_ms": causal_bound_ms,
           "library_causal_ms": lib_causal_ms,
           "library_backend": f"{lib_name}, causal {lib_causal_name}"}
    log(f"[kernel] flash_fwd bfloat16 BH={bh} T={LONG_T} d={D} (the serving "
        f"forward's shape) every kv_length T: kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of "
        f"bound; causal {causal_ms:.4f} ms, bound {causal_bound_ms:.4f} ms, "
        f"{100 * causal_bound_ms / causal_ms:.1f}% of bound; sdpa "
        f"forward ({lib_name}) {lib_ms:.4f} ms, causal ({lib_causal_name}) "
        f"{lib_causal_ms:.4f} ms")
    return rec


def phase_stream_kernels():
    """Kernel rows 2-4 against their plain versions, then their times at
    the long training shape and row 2 at the serving forward's shape;
    returns {name: record}."""
    from incubator_mxnet_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(dtype, causal, LONG_T, LONG_T)
             for dtype in (torch.bfloat16, torch.float32)
             for causal in (False, True)]
    cases += [(torch.bfloat16, causal, tq, tk) for tq, tk in
              ((LONG_T // 2, LONG_T), (1152, 1152)) for causal in (False, True)]
    main_errs = None
    for dtype, causal, tq, tk in cases:
        errs = _check_stream_case(fa, dtype, causal, tq, tk, gen)
        if main_errs is None:
            main_errs = errs          # bf16, non-causal, 4 x 2048
        torch.cuda.empty_cache()

    # times at the path's shape: every kv_length T, non-causal
    bh, scale = LONG_TRAIN_BATCH * HEADS, D ** -0.5
    blocks = (512, 1024)
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, _ = _stream_inputs(gen, LONG_TRAIN_BATCH, LONG_T, LONG_T,
                                        dtype)
        full = torch.full((bh,), LONG_T, dtype=torch.int32, device="cuda")
        o, lse = fa.flash_fwd(q, k, v, full, scale, False, *blocks)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        args = (q, k, v, do, lse, delta, full, scale, False, *blocks)
        ms = {"flash_fwd": time_ms(lambda: fa.flash_fwd(
                  q, k, v, full, scale, False, *blocks)),
              "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(*args)),
              "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(*args))}
        # causal: the kernels skip the tiles above the diagonal
        co, clse = fa.flash_fwd(q, k, v, full, scale, True, *blocks)
        cdelta = (do.float() * co.float()).sum(-1, keepdim=True)
        cargs = (q, k, v, do, clse, cdelta, full, scale, True, *blocks)
        causal_ms = {"flash_fwd": time_ms(lambda: fa.flash_fwd(
                         q, k, v, full, scale, True, *blocks)),
                     "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(*cargs)),
                     "flash_bwd_dkv": time_ms(
                         lambda: fa.flash_bwd_dkv(*cargs))}
        plain_ms = {"flash_fwd": time_ms(lambda: fa.flash_fwd_reference(
                        q, k, v, full, scale, False, *blocks), 5, 1),
                    "flash_bwd_dq": time_ms(
                        lambda: fa.flash_bwd_dq_reference(*args), 5, 1),
                    "flash_bwd_dkv": time_ms(
                        lambda: fa.flash_bwd_dkv_reference(*args), 5, 1)}
        # library yardstick: one SDPA call, no mask (every kv_length is
        # T), and its backward through autograd less its forward (rows
        # 3 and 4 together), non-causal and causal, each by the fastest
        # backend; timed only, the port never calls it
        q4, k4, v4, do4 = (t.view(LONG_TRAIN_BATCH, HEADS, -1, D)
                           for t in (q, k, v, do))
        lib, lib_causal = _sdpa_times(q4, k4, v4, do4, scale)
        io = q.numel() * q.element_size()       # one (BH, T, d) tensor
        rows = bh * LONG_T * 4                  # one (BH, T) f32 vector
        work = bh * LONG_T * LONG_T * D
        moved = {"flash_fwd": 4 * io + rows + bh * 4,
                 "flash_bwd_dq": 5 * io + 2 * rows + bh * 4,
                 "flash_bwd_dkv": 6 * io + 2 * rows + bh * 4}
        ops = {"flash_fwd": 4 * work, "flash_bwd_dq": 6 * work,
               "flash_bwd_dkv": 8 * work}
        # causal: the products of the keys at or below the diagonal, half
        # of them
        bounds = {n: _bound(moved[n], ops[n], dtype) for n in ms}
        causal_bounds = {n: _bound(moved[n], ops[n] // 2, dtype)[0]
                         for n in ms}
        facts = {"flash_fwd": _stream_facts(lambda: fa.flash_fwd(
                     q, k, v, full, scale, False, *blocks), "fwd_"),
                 "flash_bwd_dq": _stream_facts(
                     lambda: fa.flash_bwd_dq(*args), "bwd_dq"),
                 "flash_bwd_dkv": _stream_facts(
                     lambda: fa.flash_bwd_dkv(*args), "bwd_dkv")}
        for kname in ms:
            bound_ms, bound_by = bounds[kname]
            rec = {"max_abs_err": main_errs[kname], "ms": ms[kname],
                   "plain_ms": plain_ms[kname], "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": lib[kname],
                   "causal_ms": causal_ms[kname],
                   "causal_bound_ms": causal_bounds[kname],
                   "library_causal_ms": lib_causal[kname],
                   "library_backend": lib["backend"],
                   "library_causal_backend": lib_causal["backend"],
                   **facts[kname]}
            fwd = kname == "flash_fwd"
            if dtype == torch.bfloat16:
                records[kname] = rec
            log(f"[kernel] {kname} {str(dtype)[6:]} BH={bh} T={LONG_T} d={D} "
                f"every kv_length T: kernel {ms[kname]:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), "
                f"{100 * bound_ms / ms[kname]:.1f}% of bound; causal "
                f"{causal_ms[kname]:.4f} ms, bound "
                f"{causal_bounds[kname]:.4f} ms, "
                f"{100 * causal_bounds[kname] / causal_ms[kname]:.1f}% of "
                f"bound; plain {plain_ms[kname]:.4f} ms; sdpa "
                f"({lib['backend']}) "
                f"{'forward' if fwd else 'backward (dq+dk+dv)'} "
                f"{lib[kname]:.4f} ms, causal {lib_causal[kname]:.4f} ms; "
                f"{_facts_text(facts[kname])}")
        del q, k, v, do, o, lse, delta, args, co, clse, cdelta, cargs
        del q4, k4, v4, do4
        torch.cuda.empty_cache()
    records["flash_fwd"]["serving_shape"] = _stream_fwd_serving(fa, gen)
    return records


def _bthd_inputs(gen, batch, dtype):
    """A seeded (batch, T, 3E) buffer in the fused projection's layout;
    q, k, v as (batch, T, H, d) views of its three column slices; do
    (batch, T, H, d); kv_length per batch element, random with 0 and T
    among them."""
    E = HEADS * D
    buf = torch.randn(batch, T, 3 * E, generator=gen, device="cuda") \
        .to(dtype)
    q, k, v = (buf[..., i * E:(i + 1) * E].view(batch, T, HEADS, D)
               for i in range(3))
    do = torch.randn(batch, T, HEADS, D, generator=gen, device="cuda") \
        .to(dtype)
    lengths = torch.randint(0, T + 1, (batch,), generator=gen, device="cuda",
                            dtype=torch.int32)
    lengths[0], lengths[1] = 0, T
    return buf, q, k, v, do, lengths


def _sdpa_mask(lengths, causal, dtype):
    """kv_length (and causal) as SDPA's additive -1e30 mask."""
    keep = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
    keep = keep[:, None, None, :]
    if causal:
        keep = keep & torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
    add = torch.zeros(keep.shape, dtype=dtype, device="cuda")
    return add.masked_fill_(~keep, -1e30)


def _check_bthd_case(fa, q, k, v, do, lengths, causal, dtype, train, what):
    """Rows 5 and 6 on one input against their plain versions, and
    FlashShortBTHD against autograd; returns {kernel: max |error|}."""
    scale = D ** -0.5
    if not train:
        o = fa.flash_short_bthd_fwd(q, k, v, lengths, scale, causal)
        ro = fa.flash_short_bthd_reference(q, k, v, lengths, scale, causal)
        torch.cuda.synchronize()
        err = _max_err(o, ro)
        if not (err <= ATOL[dtype] and torch.isfinite(o.float()).all()):
            raise AssertionError(f"flash_short_bthd_fwd disagrees with its "
                                 f"plain version: {what}: {err} > "
                                 f"{ATOL[dtype]}")
        log(f"[kernel] flash_short_bthd_fwd {what}: o max|err|={err:.3e} "
            f"(atol {ATOL[dtype]})")
        return {"flash_short_bthd_fwd": err}
    o, p = fa.flash_short_bthd_fwd_train(q, k, v, lengths, scale, causal)
    ro, rp = fa.flash_short_bthd_reference(q, k, v, lengths, scale, causal,
                                           save_p=True)
    torch.cuda.synchronize()
    o_err, p_err = _max_err(o, ro), _max_err(p, rp)
    if not (o_err <= ATOL[dtype] and p_err <= P_ATOL[dtype]
            and torch.isfinite(o.float()).all()):
        raise AssertionError(
            f"flash_short_bthd_fwd_train disagrees with its plain version: "
            f"{what}: o {o_err} (atol {ATOL[dtype]}), p {p_err} (atol "
            f"{P_ATOL[dtype]})")
    # row 6 from the plain forward's o and p
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_short_bthd_bwd(q, k, v, do, delta, rp, scale)
    ref = fa.flash_short_bthd_bwd_reference(q, k, v, do, delta, rp, scale)
    torch.cuda.synchronize()
    bwd_err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err, top = _max_err(a, b), b.float().abs().max().item()
        if not err <= GRAD_RTOL[dtype] * top:
            raise AssertionError(f"flash_short_bthd_bwd {name} disagrees "
                                 f"with its plain version: {what}: {err} > "
                                 f"{GRAD_RTOL[dtype]} x {top}")
        bwd_err = max(bwd_err, err)
    # FlashShortBTHD (row 5's training form, delta, row 6) against torch
    # autograd through the plain forward, gradients into the shared
    # buffer; a batch element with kv_length 0 follows the JAX rule (p =
    # 1/T sends gradient into k), so there it is held to the plain
    # backward on the plain forward's (o, p)
    B, E = q.shape[0], HEADS * D
    base = torch.cat([t.reshape(B, T, E) for t in (q, k, v)], -1)
    grads = []
    for fn in (fa.FlashShortBTHD.apply, fa.flash_short_bthd_reference):
        leaf = base.clone().requires_grad_()
        views = [leaf[..., i * E:(i + 1) * E].view(B, T, HEADS, D)
                 for i in range(3)]
        fn(*views, lengths, scale, causal).backward(do)
        grads.append(leaf.grad)
    jax_rule = torch.cat([g.reshape(B, T, E) for g in ref], -1)
    live = lengths > 0
    top = grads[1].float().abs().max().item()
    ref_top = max(b.float().abs().max().item() for b in ref)
    auto_err = _max_err(grads[0][live], grads[1][live])
    rule_err = _max_err(grads[0][~live], jax_rule[~live])
    if not max(auto_err, rule_err) <= GRAD_RTOL[dtype] * top:
        raise AssertionError(
            f"FlashShortBTHD gradients disagree: {what}: vs autograd "
            f"{auto_err}, fully masked vs the JAX rule {rule_err}, > "
            f"{GRAD_RTOL[dtype]} x {top}")
    log(f"[kernel] flash_short_bthd_fwd_train/flash_short_bthd_bwd {what}: "
        f"o max|err|={o_err:.3e} (atol {ATOL[dtype]}), p {p_err:.3e} (atol "
        f"{P_ATOL[dtype]:.3e}); dq/dk/dv {bwd_err:.3e} (rtol "
        f"{GRAD_RTOL[dtype]} of {ref_top:.3e}); "
        f"FlashShortBTHD vs autograd {auto_err:.3e}, kv_length-0 rows vs "
        f"the JAX rule {rule_err:.3e} (rtol {GRAD_RTOL[dtype]} of {top:.3e})")
    return {"flash_short_bthd_fwd_train": max(o_err, p_err),
            "flash_short_bthd_bwd": bwd_err}


def _with_bthd(fn):
    """fn() with MXNET_FLASH_ATTENTION_BTHD=1, the variable removed after."""
    os.environ["MXNET_FLASH_ATTENTION_BTHD"] = "1"
    try:
        return fn()
    finally:
        del os.environ["MXNET_FLASH_ATTENTION_BTHD"]


def phase_bthd_kernels():
    """Kernel rows 5 and 6 against their plain versions, then their times
    at the paths' shapes beside the plain versions', SDPA's, the bound
    and `multi_head_attention` on the default and BTHD routes; returns
    {kernel: record} of bfloat16, non-causal."""
    import torch.nn.functional as F
    from incubator_mxnet_torch.ops import flash_attention as fa
    from incubator_mxnet_torch.ops.attention import multi_head_attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    scale, E = D ** -0.5, HEADS * D
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for batch, train in ((BH_BATCH, False), (TRAIN_BATCH, True)):
            buf, q, k, v, do, lengths = _bthd_inputs(gen, batch, dtype)
            errs = {}
            for causal in (False, True):
                what = (f"{str(dtype)[6:]} causal={causal} B={batch} T={T} "
                        f"H={HEADS} d={D}, views of a (B, T, 3E) buffer")
                got = _check_bthd_case(fa, q, k, v, do, lengths, causal,
                                       dtype, train, what)
                if not causal:
                    errs = got
            # times at the path's shape, non-causal, these kv_lengths
            q4, k4, v4, do4 = (t.transpose(1, 2) for t in (q, k, v, do))
            mask = _sdpa_mask(lengths, False, dtype)
            qkv = [buf[..., i * E:(i + 1) * E] for i in range(3)]
            nbytes = q.numel() * q.element_size()   # one (B, T, H, d)
            work = batch * HEADS * T * T * D
            if not train:
                name = "flash_short_bthd_fwd"
                ms = time_ms(lambda: fa.flash_short_bthd_fwd(
                    q, k, v, lengths, scale, False))
                plain_ms = time_ms(lambda: fa.flash_short_bthd_reference(
                    q, k, v, lengths, scale, False))
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, scale=scale))
                bound = _bound(4 * nbytes + batch * 4, 4 * work, dtype)

                def route():
                    with torch.inference_mode():
                        return multi_head_attention(*qkv, None, lengths,
                                                    num_heads=HEADS)
                recs = {name: (ms, plain_ms, lib_ms, bound)}
                facts = {name: _launch_facts(lambda: fa.flash_short_bthd_fwd(
                    q, k, v, lengths, scale, False))}
                routes = "forward"
            else:
                o, p = fa.flash_short_bthd_fwd_train(q, k, v, lengths, scale,
                                                     False)
                delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
                    .contiguous()
                fwd_ms = time_ms(lambda: fa.flash_short_bthd_fwd_train(
                    q, k, v, lengths, scale, False))
                fwd_plain = time_ms(lambda: fa.flash_short_bthd_reference(
                    q, k, v, lengths, scale, False, save_p=True))
                bwd_ms = time_ms(lambda: fa.flash_short_bthd_bwd(
                    q, k, v, do, delta, p, scale))
                bwd_plain = time_ms(lambda: fa.flash_short_bthd_bwd_reference(
                    q, k, v, do, delta, p, scale))
                leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]

                def sdpa():
                    return F.scaled_dot_product_attention(
                        *leaves, attn_mask=mask, scale=scale)

                def sdpa_fwd_bwd():
                    return torch.autograd.grad(sdpa(), leaves, do4)
                lib_bwd = time_ms(sdpa_fwd_bwd) - time_ms(sdpa)
                pbytes = p.numel() * p.element_size()
                facts = {"flash_short_bthd_fwd_train": _launch_facts(
                    lambda: fa.flash_short_bthd_fwd_train(
                        q, k, v, lengths, scale, False))}
                if dtype == torch.bfloat16:
                    # one launch a call (float32 takes two FMA kernels)
                    facts["flash_short_bthd_bwd"] = _launch_facts(
                        lambda: fa.flash_short_bthd_bwd(
                            q, k, v, do, delta, p, scale), "bthd_bwd_")
                recs = {"flash_short_bthd_fwd_train": (
                            fwd_ms, fwd_plain, None,
                            _bound(4 * nbytes + pbytes + batch * 4,
                                   4 * work, dtype)),
                        "flash_short_bthd_bwd": (
                            bwd_ms, bwd_plain, lib_bwd,
                            _bound(7 * nbytes + pbytes + delta.numel() * 4,
                                   8 * work, dtype))}
                leaf = buf.detach().requires_grad_()
                grad_out = do.reshape(batch, T, E)

                def route():
                    out = multi_head_attention(
                        *[leaf[..., i * E:(i + 1) * E] for i in range(3)],
                        None, lengths, num_heads=HEADS)
                    return torch.autograd.grad(out, leaf, grad_out)
                routes = "forward + backward"
                del o, p, delta, leaves
            route_ms = {"default_route_ms": time_ms(route),
                        "bthd_route_ms": _with_bthd(lambda: time_ms(route)),
                        "default_route_device_ms": device_ms(route),
                        "bthd_route_device_ms": _with_bthd(
                            lambda: device_ms(route))}
            log(f"[kernel] multi_head_attention {routes} {str(dtype)[6:]} "
                f"B={batch} T={T} E={E} on the (B, T, 3E) views: default "
                f"route (short kernel, head split/merge copies) "
                f"{route_ms['default_route_ms']:.4f} ms, of which "
                f"{route_ms['default_route_device_ms']:.4f} ms device time; "
                f"BTHD route {route_ms['bthd_route_ms']:.4f} ms, of which "
                f"{route_ms['bthd_route_device_ms']:.4f} ms device time")
            for name, (ms, plain_ms, lib_ms, (bound_ms, bound_by)) in \
                    recs.items():
                lib = "none: no single PyTorch call returns p" \
                    if lib_ms is None else f"{lib_ms:.4f} ms"
                fact = facts.get(name, {})
                launch = f", {_facts_text(fact)}" if fact else ""
                log(f"[kernel] {name} {str(dtype)[6:]} B={batch} T={T} "
                    f"H={HEADS} d={D} non-causal: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound"
                    f"{launch}; library (SDPA"
                    f"{' backward' if name.endswith('bwd') else ''}) {lib}")
                if dtype == torch.bfloat16:
                    records[name] = {
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib_ms,
                        **fact, **route_ms}
            del buf, q, k, v, do, q4, k4, v4, do4, qkv
            torch.cuda.empty_cache()
    return records


def phase_train(card, rows, seqlen, run_k, iterations, per_step, tag):
    """A training path: BERT-base bf16 on `rows` x `seqlen` tokens; every
    step must launch each kernel of `per_step` once per layer and no
    other kernel.  Returns the launch counts of the path's run and the
    step time over `run_steps`."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import autograd, gluon, nd, parallel
    from incubator_mxnet_torch.models import get_model
    from incubator_mxnet_torch.ops import flash_attention as fa

    rng = np.random.RandomState(0)
    batch = [nd.array(a, ctx=mx.gpu(0)) for a in (
        rng.randint(0, 30522, (rows, seqlen)).astype(np.float32),
        np.zeros((rows, seqlen), np.float32),
        rng.randint(0, 2, rows).astype(np.float32))]
    t0 = time.time()
    mx.seed(0)
    net = get_model("bert_classifier", model_name="bert_12_768_12",
                    num_classes=2, dropout=0.0, vocab_size=30522,
                    max_length=seqlen)
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    net.cast("bfloat16")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_of(out, label):
        return loss_fn(out.astype("float32"), label)
    tr = parallel.ParallelTrainer(net, loss_of, optimizer="adam",
                                  optimizer_params={"learning_rate": 2e-5},
                                  mesh=parallel.default_mesh(1))
    counts = fa.launch_counts
    fa.reset_launch_counts()
    layers = len(net.bert.encoder.layers)

    # step 1 on the kernel route against einsum attention, same weights
    watched = [net.bert.encoder.layers[i].attention.qkv.weight.data().data
               for i in (0, layers - 1)]

    def step1():
        with autograd.record():
            lval = loss_of(net(*batch[:2]), batch[2]).data.float().mean()
        return lval.item(), torch.autograd.grad(lval, watched)
    k_loss, k_grads = step1()
    os.environ["MXNET_FLASH_ATTENTION"] = "0"
    try:
        e_loss, e_grads = step1()
    finally:
        del os.environ["MXNET_FLASH_ATTENTION"]
    grad_rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
                for a, b in zip(k_grads, e_grads)]
    log(f"{tag} BERT-base bf16 {rows}x{seqlen} built in "
        f"{time.time() - t0:.1f} s; step 1 kernel route vs einsum "
        f"attention: loss {k_loss:.6f} vs {e_loss:.6f} (atol "
        f"{STEP1_LOSS_ATOL}), qkv.weight grad rel. error layer 0 "
        f"{grad_rel[0]:.3e}, layer {layers - 1} {grad_rel[1]:.3e} (rtol "
        f"{STEP1_GRAD_RTOL})")
    if not (abs(k_loss - e_loss) <= STEP1_LOSS_ATOL
            and max(grad_rel) <= STEP1_GRAD_RTOL):
        raise AssertionError("step 1 on the kernel route disagrees with "
                             "einsum attention")
    del k_grads, e_grads
    torch.cuda.empty_cache()

    def checked(run, steps, what):
        before = dict(counts)
        lval = run()
        torch.cuda.synchronize()
        got = {n: counts[n] - before[n] for n in counts}
        want = {n: layers * steps if n in per_step else 0 for n in counts}
        if got != want:
            raise AssertionError(f"{what}: kernel launches {got} for {steps} "
                                 f"step(s) of {layers} layers, expected "
                                 f"{want}")
        if not np.isfinite(lval):
            raise AssertionError(f"{what}: loss {lval} is not finite")
        return lval

    losses = [checked(lambda: tr.step(*batch).asscalar(), 1,
                      f"step {i + 1}") for i in range(3)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    last = checked(lambda: tr.run_steps(run_k, *batch).asscalar(), run_k,
                   f"run_steps({run_k})")
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / run_k
    shown = ", ".join(f"{x:.4f}" for x in losses)
    log(f"{tag} ParallelTrainer adam: losses {shown} "
        f"after steps 1-3, {last:.4f} after run_steps({run_k}) (num_update "
        f"{tr.num_update}); {layers} launches of each of "
        f"{', '.join(per_step)} per step, no other kernel")
    log(f"{tag} step {step_ms:.2f} ms, "
        f"{rows * seqlen / step_ms * 1e3:.0f} tokens/s over "
        f"run_steps({run_k}) ({card})")
    log_profile(lambda: checked(lambda: tr.step(*batch).asscalar(), 1,
                                "profiled step"),
                f"one {rows}x{seqlen} training step", tag=tag)

    # the imperative loop on the same model
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 2e-5})
    for i in range(iterations):
        def iteration():
            with autograd.record():
                l = loss_of(net(*batch[:2]), batch[2])
            l.backward()
            trainer.step(rows)
            return float(l.asnumpy().mean())
        lval = checked(iteration, 1, f"imperative iteration {i + 1}")
        log(f"{tag} imperative record/backward/gluon.Trainer.step "
            f"iteration {i + 1}: mean loss {lval:.4f}")
    return dict(counts), step_ms


def _http(port, method, path, body=None):
    """(status, decoded JSON, seconds) of one request to the local server
    (http.client: no proxy from the environment can take it elsewhere)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        status, payload = r.status, json.loads(r.read())
    finally:
        conn.close()
    return status, payload, time.perf_counter() - t0


def _post(port, arrays):
    body = json.dumps({"inputs": [a.tolist() for a in arrays]})
    return _http(port, "POST", "/predict", body)


def log_profile(fn, what, tag="[profile]", top=12, shares=()):
    """Device time of fn(), attributed to each kernel and to the host op
    that launched it (torch.profiler self device time); for each name in
    `shares`, the share of the kernels and of the launching ops whose
    name holds it."""
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    ops = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    log(f"{tag} {what}: {total / 1e3:.2f} ms of device time in "
        f"{sum(e.count for e in kernels)} kernel launches")
    for title, rows in (("kernel", kernels), ("launching op", ops)):
        log(f"{tag} by {title}:")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
            log(f"{tag} {e.self_device_time_total / 1e3:8.3f} ms "
                f"{100 * e.self_device_time_total / total:5.1f}% "
                f"x{e.count:<4d} {e.key[:70]}")
    for name in shares:
        part = [sum(e.self_device_time_total for e in rows if name in e.key)
                for rows in (kernels, ops)]
        log(f"{tag} *{name}*: kernels {part[0] / 1e3:.3f} ms "
            f"({100 * part[0] / total:.1f}%), launching ops "
            f"{part[1] / 1e3:.3f} ms ({100 * part[1] / total:.1f}%)")
    return total / 1e3, sum(e.count for e in kernels)


def log_forward_profile(block, inputs, what):
    def fwd():
        with torch.inference_mode():
            block(*inputs)
    log_profile(fwd, f"one {what} forward")


def phase_serve(card, seqlen, capacity, request_rows, n_sequential, kernel,
                tag):
    """A serving path: BERT-base bf16 at `seqlen` tokens, batch capacity
    `capacity`; every served batch must launch `kernel` once per layer
    and no other kernel.  Returns the launch counts of the path's run and
    the device forward time of one full batch."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import deploy
    from incubator_mxnet_torch.models import get_model
    from incubator_mxnet_torch.ops import flash_attention as fa
    from incubator_mxnet_torch.serving import ServeConfig, ServingRuntime

    rng = np.random.RandomState(0)

    def rows(n):
        return _bert_rows(rng, n, seqlen)

    art = tempfile.mkdtemp(prefix="chip_smoke_artifact_")
    rt = None
    fa.reset_launch_counts()
    try:
        t0 = time.time()
        mx.seed(0)
        net = get_model("bert_classifier", model_name="bert_12_768_12",
                        num_classes=2, dropout=0.0, vocab_size=30522,
                        max_length=seqlen)
        net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
        net.cast("bfloat16")
        deploy.export_serving(net, rows(capacity), art)
        del net
        rt = ServingRuntime(art, config=ServeConfig(
            concurrency=2, queue_limit=64, batch_window_ms=5.0))
        port = rt.start(0, "127.0.0.1")
        log(f"{tag} BERT-base bf16 T={seqlen} built, exported and loaded in "
            f"{time.time() - t0:.1f} s; serving on 127.0.0.1:{port}")
        for path in ("/-/healthz", "/-/readyz"):
            status = _http(port, "GET", path)[0]
            if status != 200:
                raise AssertionError(f"{path} answered {status}")

        reqs = [rows(n) for n in request_rows]
        results = [None] * len(reqs)
        launches0 = dict(fa.launch_counts)
        calls0 = rt.model_calls
        t_req = time.perf_counter()
        for i in range(n_sequential):
            results[i] = _post(port, reqs[i])
        errors = []

        def send(i):
            try:
                results[i] = _post(port, reqs[i])
            except Exception as e:   # noqa: BLE001 — re-raised below
                errors.append(e)
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(n_sequential, len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t_req
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads) or None in results:
            raise AssertionError("a request did not complete")
        batches = rt.model_calls - calls0
        launched = {n: fa.launch_counts[n] - launches0[n]
                    for n in fa.launch_counts}
        block = rt._slot.model.block
        layers = len(block.bert.encoder.layers)     # one launch each
        log(f"{tag} {len(reqs)} requests ({sum(request_rows)} rows) in "
            f"{batches} batch(es); {kernel} launches {launched[kernel]} "
            f"({layers} encoder layers)")
        want = {n: layers * batches if n == kernel else 0 for n in launched}
        if batches < 1 or launched != want:
            raise AssertionError(
                f"expected {layers} {kernel} launches per batch and no other "
                f"kernel: {launched} for {batches} batches")

        # the same rows through the loaded block with einsum attention
        os.environ["MXNET_FLASH_ATTENTION"] = "0"
        try:
            worst = 0.0
            for req, (status, payload, _dt) in zip(reqs, results):
                if status != 200:
                    raise AssertionError(f"request answered {status}")
                got = np.asarray(payload["outputs"][0], np.float32)
                with torch.inference_mode():
                    ref = block(*[torch.from_numpy(a).cuda() for a in req])
                ref = ref.float().cpu().numpy()
                if got.shape != (req[0].shape[0], 2) or \
                        not np.isfinite(got).all():
                    raise AssertionError(f"bad output {got.shape}")
                worst = max(worst, float(np.abs(got - ref).max()))
        finally:
            del os.environ["MXNET_FLASH_ATTENTION"]
        if not worst <= LOGIT_ATOL:
            raise AssertionError(f"served logits differ from the direct "
                                 f"forward by {worst} > {LOGIT_ATOL}")
        lat = sorted(r[2] for r in results)
        p50 = lat[len(lat) // 2] * 1e3
        tok_s = sum(request_rows) * seqlen / wall
        log(f"{tag} served logits vs direct forward (einsum attention): "
            f"max|err|={worst:.3e} (atol {LOGIT_ATOL})")
        log(f"{tag} p50 request latency {p50:.1f} ms, {tok_s:.0f} "
            f"tokens/s over {wall:.2f} s ({card})")
        path_counts = dict(fa.launch_counts)
        others = {n: c for n, c in path_counts.items() if n != kernel and c}
        if others:
            raise AssertionError(f"{tag} launched other kernels: {others}")

        # where a request's time goes: one full batch through the loaded
        # model, on the device alone and through the numpy call
        full = rows(capacity)
        ts = [torch.from_numpy(a).cuda() for a in full]
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: block(*ts), iters=5, warmup=1)
            os.environ["MXNET_FLASH_ATTENTION"] = "0"
            try:
                plain_fwd_ms = time_ms(lambda: block(*ts), iters=5, warmup=1)
            finally:
                del os.environ["MXNET_FLASH_ATTENTION"]
        t0 = time.perf_counter()
        for _ in range(5):
            rt._slot.model(*full)
        call_ms = (time.perf_counter() - t0) / 5 * 1e3
        what = f"{capacity}x{seqlen}"
        log(f"{tag} {what} batch: forward {fwd_ms:.2f} ms on the device "
            f"({layers} x {kernel}), {plain_fwd_ms:.2f} ms with einsum "
            f"attention; numpy-in/numpy-out model call {call_ms:.2f} ms "
            f"({card})")
        log_forward_profile(block, ts, what)
    finally:
        if rt is not None:
            rt.close()
        shutil.rmtree(art, ignore_errors=True)
        torch.cuda.empty_cache()
    return path_counts, fwd_ms


# ---------------------------------------------------------------------
# row 8: the bottleneck backward, and ResNet-50 v1b
# ---------------------------------------------------------------------
# (M, C, K): ResNet-50 stage 1's 1x1 expand (the tool's default), its
# reverse (the reduce 1x1 of the next block), a stage-2 expand, and a
# stage-4 expand whose M = 256*7*7 is no multiple of the JAX tool's 512
BNB_SHAPES = {"stage 1": (256 * 56 * 56, 64, 256),
              "stage 1 reversed": (256 * 56 * 56, 256, 64),
              "stage 2": (256 * 28 * 28, 128, 512),
              "stage 4, ragged M": (256 * 7 * 7, 512, 2048)}
BNB_TIMED = ("stage 1", "stage 1 reversed")
# Kernels against their plain versions, mean |a - b| / mean |a| (the JAX
# tool's measure): f32 sums of the same bf16 products in another order,
# and dz, dx rounded to bf16 (a rounding that flips on a last-bit
# difference moves one element by one bf16 step).  Against torch autograd
# of bn_dot: the JAX test's 2e-2 (dz is rounded to bf16 before dx and dW).
BNB_RTOL = 1e-3
BNB_VJP_RTOL = 2e-2
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 256, 224, 1000
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# [resnet-check], bf16 against float32 from the same weights, batch 8:
# logits (predict mode) relative Frobenius error 2e-2 and the predict-mode
# loss 2e-2 absolute — bf16 through 53 convolutions, each rounding its
# output (a reduced-size CPU run measured 4.7e-3 and 1.7e-3).  The step-1
# loss in train mode, where BN normalizes by the batch's statistics of
# bf16 activations: 5e-2 relative — the JAX package's own bf16 and
# float32 losses differ by 3.6% on a reduced-size CPU run of this check
# (8.35 against 8.06), the port's by 2.0% on the card.
# Gradients: at initialization BN's backward removes the batch mean of
# the gradient, and what remains in the early layers is small beside the
# bf16 rounding: the JAX package's own bf16 and float32 gradients of
# features.0.weight and features.1.gamma differ by more than their norm
# on the same check (relative 1.36 and 1.31 on the CPU).  So the
# gradients are held by direction (cosine): output.weight in train mode,
# all three in predict mode (measured 0.96 and 0.95-0.998), >= 0.9.
CHECK_BATCH = 8
LOGIT_RTOL = 2e-2
LOSS_ATOL = 2e-2
TRAIN_LOSS_RTOL = 5e-2
GRAD_MIN_COS = 0.9


def _rel(ref, got):
    ref, got = ref.float(), got.float()
    return ((ref - got).abs().mean() / (ref.abs().mean() + 1e-9)).item()


def _bnb_inputs(gen, M, C, K):
    from incubator_mxnet_torch.tools.bottleneck_bwd import bn_dot
    x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(C, K, generator=gen, device="cuda") * 0.05).to(
        torch.bfloat16)
    gamma = torch.rand(K, generator=gen, device="cuda") + 0.5
    beta = torch.zeros(K, device="cuda")
    dy = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        _, (_z, m, inv) = bn_dot(x, w, gamma, beta)
    return x, w, gamma, beta, dy, m, inv


def phase_bottleneck(card):
    """Row 8's kernels against their plain versions and against torch
    autograd, their times, then the tool's main path.  Returns
    {kernel: record} and the tool path's launch counts."""
    from incubator_mxnet_torch.tools import bottleneck_bwd as bnb
    gen = torch.Generator(device="cuda").manual_seed(5)
    records = {}
    for what, (M, C, K) in BNB_SHAPES.items():
        x, w, gamma, beta, dy, m, inv = _bnb_inputs(gen, M, C, K)
        s = bnb.bottleneck_bwd_reduce(dy, x, w, m, inv)
        rs = bnb.bottleneck_reduce_reference(dy, x, w, m, inv)
        d = bnb.bottleneck_bwd_apply(dy, x, w, m, inv, gamma, *rs)
        rd = bnb.bottleneck_apply_reference(dy, x, w, m, inv, gamma, *rs)
        torch.cuda.synchronize()
        plain = {n: _rel(a, b) for n, a, b in
                 zip(("s1", "s2", "dx", "dw"), (*rs, *rd), (*s, *d))}
        abs_err = {"bottleneck_bwd_reduce": max(_max_err(a, b) for a, b in
                                                zip(rs, s)),
                   "bottleneck_bwd_apply": max(_max_err(a, b) for a, b in
                                               zip(rd, d))}
        leaves = [t.detach().requires_grad_() for t in (x, w, gamma, beta)]
        y = bnb.bn_dot(*leaves)[0]
        ref = torch.autograd.grad(y, leaves, dy, retain_graph=True)
        got = bnb.bottleneck_bwd(dy, x, w, m, inv, gamma)
        torch.cuda.synchronize()
        vjp = {n: _rel(a, b) for n, a, b in
               zip(("dx", "dw", "dgamma", "dbeta"), ref, got)}
        bad = [n for n, e in plain.items() if not e <= BNB_RTOL] + \
            [n for n, e in vjp.items() if not e <= BNB_VJP_RTOL]
        if bad or not all(torch.isfinite(t).all() for t in (*s, *d)):
            raise AssertionError(f"bottleneck kernels disagree at {what} "
                                 f"(M={M}, C={C}, K={K}): vs plain {plain}, "
                                 f"vs autograd {vjp}")
        log(f"[bottleneck] {what} M={M} C={C} K={K}: vs plain versions "
            + ", ".join(f"{n} {e:.2e}" for n, e in plain.items())
            + f" (rtol {BNB_RTOL}); vs autograd of bn_dot "
            + ", ".join(f"{n} {e:.2e}" for n, e in vjp.items())
            + f" (rtol {BNB_VJP_RTOL}); max|err| vs plain reduce "
            f"{abs_err['bottleneck_bwd_reduce']:.3e}, apply "
            f"{abs_err['bottleneck_bwd_apply']:.3e}")
        if what in BNB_TIMED:
            s1, s2 = rs
            ms = {"bottleneck_bwd_reduce": time_ms(
                      lambda: bnb.bottleneck_bwd_reduce(dy, x, w, m, inv)),
                  "bottleneck_bwd_apply": time_ms(
                      lambda: bnb.bottleneck_bwd_apply(dy, x, w, m, inv,
                                                       gamma, s1, s2))}
            plain_ms = {"bottleneck_bwd_reduce": time_ms(
                            lambda: bnb.bottleneck_reduce_reference(
                                dy, x, w, m, inv), 5, 1),
                        "bottleneck_bwd_apply": time_ms(
                            lambda: bnb.bottleneck_apply_reference(
                                dy, x, w, m, inv, gamma, s1, s2), 5, 1)}
            vjp_ms = time_ms(lambda: torch.autograd.grad(
                y, leaves, dy, retain_graph=True), 10, 2)
            # bytes each pass must move: dy and x in (and W, m, inv, and
            # gamma, s1, s2), s1, s2 out / dx and dW out; operations: z,
            # and for the apply pass dx and dW too
            io, vec = 2 * M * (C + K) + 2 * C * K, 4 * K
            bounds = {"bottleneck_bwd_reduce": _bound(
                          io + 4 * vec, 2 * M * C * K, torch.bfloat16),
                      "bottleneck_bwd_apply": _bound(
                          io + 5 * vec + 2 * M * C + 4 * C * K,
                          6 * M * C * K, torch.bfloat16)}
            # the persistent kernels of both passes: each one's traced
            # grid and the host time of one wrapper call
            facts = {"bottleneck_bwd_reduce": _launch_facts(
                         lambda: bnb.bottleneck_bwd_reduce(dy, x, w, m, inv),
                         "bnb_reduce"),
                     "bottleneck_bwd_apply": _launch_facts(
                         lambda: bnb.bottleneck_bwd_apply(dy, x, w, m, inv,
                                                          gamma, s1, s2),
                         "bnb_apply")}
            for name in ms:
                bound_ms, bound_by = bounds[name]
                fact = facts.get(name, {})
                log(f"[bottleneck] {name} {what} M={M} C={C} K={K}: kernel "
                    f"{ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by}), "
                    f"{100 * bound_ms / ms[name]:.1f}% of bound"
                    + (f", {_facts_text(fact)}" if fact else ""))
                if what == "stage 1":
                    records[name] = {
                        "max_abs_err": abs_err[name], "ms": ms[name],
                        "plain_ms": plain_ms[name], "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None,
                        "torch_vjp_ms": vjp_ms, **fact}
                else:
                    records[name]["reversed"] = {
                        "ms": ms[name], "plain_ms": plain_ms[name],
                        "bound_ms": bound_ms, "torch_vjp_ms": vjp_ms,
                        **fact}
            log(f"[bottleneck] {what}: both kernels "
                f"{sum(ms.values()):.4f} ms against torch autograd's "
                f"backward of bn_dot {vjp_ms:.4f} ms (cuBLAS and "
                f"elementwise passes; no single PyTorch call computes it) "
                f"({card})")
        del x, w, dy, m, inv, s, rs, d, rd, got, y, leaves, ref
        torch.cuda.empty_cache()

    # the tool's path: its entry point, the isolated stage at the default
    # shape and the 3-block stack
    bnb.reset_launch_counts()
    stage = bnb.main([])
    block = bnb.main(["--full-block"])
    torch.cuda.synchronize()
    counts = dict(bnb.launch_counts)
    if not all(counts.values()):
        raise AssertionError(f"the tool's path launched {counts}")
    log(f"[bottleneck] tool, default shape: kernels {stage['kernel_ms']:.4f}"
        f" ms vs torch autograd {stage['torch_vjp_ms']:.4f} ms "
        f"(x{stage['speedup']:.2f}), rel err {stage['rel_err']}")
    log(f"[bottleneck] tool, 3-block stack N=256 56x56 C=64 forward + "
        f"backward: plain {block['plain']:.3f} ms, fused (Conv1x1BN) "
        f"{block['fused']:.3f} ms (x{block['speedup']:.2f}), max mean "
        f"relative gradient difference {block['max_rel_err']:.3e} (the "
        f"plain form rounds z to bf16 before its statistics) ({card})")
    log(f"[bottleneck] launches on the tool's path: {counts}")
    return records, counts


def _image_bench(name, batch, size, dtype="bfloat16", ctx=None):
    """`bench_resnet50`'s set-up for zoo model `name` on `ctx` (the card
    by default): Xavier weights from seed 0 cast to `dtype`,
    SoftmaxCrossEntropyLoss on float32 logits, SGD (lr 0.1, momentum
    0.9, wd 1e-4) through ParallelTrainer, and `batch` random images of
    `size`² and labels from numpy seed 0."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import gluon, nd, parallel
    from incubator_mxnet_torch.gluon.model_zoo.vision import get_model
    ctx = ctx or mx.gpu(0)
    mx.random.seed(0)
    np.random.seed(0)
    net = get_model(name, classes=RESNET_CLASSES)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.cast(dtype)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss(out, y):
        return loss_fn(out.astype("float32"), y)
    tr = parallel.ParallelTrainer(net, loss, optimizer="sgd",
                                  optimizer_params=SGD,
                                  mesh=parallel.default_mesh(ctx=ctx))
    with ctx:
        x = nd.array(np.random.uniform(size=(batch, 3, size, size))
                     .astype(np.float32)).astype(dtype)
        y = nd.array(np.random.randint(0, RESNET_CLASSES, batch)
                     .astype(np.float32))
    return net, loss, tr, x, y


def _resnet50_bench():
    """`bench_resnet50`'s set-up: the model, loss, trainer and batch."""
    return _image_bench("resnet50_v1b", RESNET_BATCH, RESNET_SIZE)


def _all_counts():
    from incubator_mxnet_torch import rtc
    from incubator_mxnet_torch.ops import flash_attention as fa
    from incubator_mxnet_torch.tools import bottleneck_bwd as bnb
    return {**fa.launch_counts, **bnb.launch_counts, **rtc.launch_counts}


def _reset_all_counts():
    from incubator_mxnet_torch import rtc
    from incubator_mxnet_torch.ops import flash_attention as fa
    from incubator_mxnet_torch.tools import bottleneck_bwd as bnb
    fa.reset_launch_counts()
    bnb.reset_launch_counts()
    rtc.reset_launch_counts()


def _bn_states(net):
    return {k: p.data()._data.float().clone() for k, p in
            net._collect_params_with_prefix().items() if "running" in k}


def phase_train_resnet(card):
    """`bench_resnet50` at batch 256: returns the trained net and batch."""
    from incubator_mxnet_torch import autograd, gluon
    t0 = time.time()
    net, loss, tr, x, y = _resnet50_bench()
    _reset_all_counts()
    losses = [tr.step(x, y).asscalar() for _ in range(3)]
    log(f"[train-resnet] resnet50_v1b bf16 {RESNET_BATCH}x3x{RESNET_SIZE}x"
        f"{RESNET_SIZE}, SGD {SGD}: built and 3 steps in "
        f"{time.time() - t0:.1f} s; losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    k = 5
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    last = tr.run_steps(k, x, y).asscalar()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / k
    losses.append(last)
    log(f"[train-resnet] run_steps({k}): loss {last:.4f}, step "
        f"{step_ms:.2f} ms, {RESNET_BATCH / step_ms * 1e3:.1f} images/s "
        f"(CUDA events over the {k} steps; num_update {tr.num_update}) "
        f"({card})")
    dev_ms, launches = log_profile(
        lambda: losses.append(tr.step(x, y).asscalar()),
        f"one {RESNET_BATCH}x3x{RESNET_SIZE}x{RESNET_SIZE} training step",
        tag="[train-resnet]")
    # the profiler slows the host, so the idle share sets the profiled
    # step's device time against the unprofiled step time above
    log(f"[train-resnet] profiled step: {dev_ms:.2f} ms of device time in "
        f"{launches} launches; against the {step_ms:.2f} ms step of "
        f"run_steps({k}) the device is idle {1 - dev_ms / step_ms:.3f} of "
        f"the step")
    trainer = gluon.Trainer(net.collect_params(), "sgd", SGD)
    with autograd.record():
        lval = loss(net(x), y)
    lval.backward()
    trainer.step(RESNET_BATCH)
    losses.append(float(lval.asnumpy().mean()))
    torch.cuda.synchronize()
    log(f"[train-resnet] imperative record/backward/gluon.Trainer.step: "
        f"mean loss {losses[-1]:.4f}")
    counts = _all_counts()
    if any(counts.values()):
        raise AssertionError(f"[train-resnet] launched hand kernels {counts}"
                             f": ResNet has none on its path")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"[train-resnet] losses {losses} are not "
                             f"finite and falling")
    stats = _bn_states(net)
    moved = sum(not torch.equal(v, torch.zeros_like(v) if "mean" in k
                                else torch.ones_like(v))
                for k, v in stats.items())
    if moved != len(stats):
        raise AssertionError(f"[train-resnet] {len(stats) - moved} of "
                             f"{len(stats)} running stats never moved")
    log(f"[train-resnet] losses over {len(losses)} steps: "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; all {len(stats)} running stats moved from their initial "
        f"values (e.g. features.1.running_var[:3] "
        f"{stats['features.1.running_var'][:3].tolist()})")
    return net, x, step_ms


def phase_infer_resnet(card, net, x):
    """The predict-mode forward at batch 256 of the trained net."""
    before = _bn_states(net)
    xt = x._data
    _reset_all_counts()
    with torch.inference_mode():
        out = net(xt)
        fwd_ms = time_ms(lambda: net(xt), iters=5, warmup=1)
        dev_ms = device_ms(lambda: net(xt), iters=3)
    torch.cuda.synchronize()
    if out.shape != (RESNET_BATCH, RESNET_CLASSES) or \
            not torch.isfinite(out.float()).all():
        raise AssertionError(f"[infer-resnet] bad output {tuple(out.shape)}")
    after = _bn_states(net)
    if any(not torch.equal(before[k], after[k]) for k in before):
        raise AssertionError("[infer-resnet] predict mode moved running "
                             "stats")
    if any(_all_counts().values()):
        raise AssertionError("[infer-resnet] launched hand kernels")
    log(f"[infer-resnet] predict-mode forward {RESNET_BATCH}x3x{RESNET_SIZE}x"
        f"{RESNET_SIZE} bf16: {fwd_ms:.2f} ms (CUDA events), {dev_ms:.2f} ms "
        f"of device time (profiler), {RESNET_BATCH / fwd_ms * 1e3:.1f} "
        f"images/s; running stats unchanged ({card})")
    log_forward_profile(net, [xt], f"{RESNET_BATCH}x3x{RESNET_SIZE}x"
                        f"{RESNET_SIZE} resnet50_v1b")
    return fwd_ms


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def phase_resnet_check(card):
    """bf16 against float32 (TF32 off) from the same weights, batch 8."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import autograd, gluon, nd
    from incubator_mxnet_torch.models import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(1)
    xs = rng.uniform(size=(CHECK_BATCH, 3, RESNET_SIZE, RESNET_SIZE)) \
        .astype(np.float32)
    ys = rng.randint(0, RESNET_CLASSES, CHECK_BATCH).astype(np.float32)
    mx.random.seed(0)
    n32 = get_model("resnet50_v1b", classes=RESNET_CLASSES)
    n32.initialize(mx.init.Xavier())
    with autograd.predict_mode():
        n32(nd.array(xs))
    weights = {k: p.data()._data.clone()
               for k, p in n32._collect_params_with_prefix().items()}
    n16 = get_model("resnet50_v1b", classes=RESNET_CLASSES)
    n16.load_dict(weights, ctx=mx.gpu(0))
    n16.cast("bfloat16")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    watched = ("features.0.weight", "output.weight", "features.1.gamma")
    got = {}
    for tag, net in (("float32", n32), ("bfloat16", n16)):
        x = nd.array(xs).astype(tag)
        params = net._collect_params_with_prefix()
        leaves = [params[n].data()._data for n in watched]
        with autograd.predict_mode():
            logits = net(x)._data.float()
        res = {"logits": logits}
        for mode in ("train", "predict"):
            with autograd.record(train_mode=mode == "train"):
                lval = nd.mean(loss_fn(net(x).astype("float32"),
                                       nd.array(ys)))
            res[mode] = torch.autograd.grad(lval._data, leaves)
            res[mode + "_loss"] = lval.asscalar()
        got[tag] = res
    a, b = got["float32"], got["bfloat16"]
    logit_rel = ((a["logits"] - b["logits"]).norm()
                 / a["logits"].norm()).item()
    loss_err = abs(a["predict_loss"] - b["predict_loss"])
    train_loss_err = abs(a["train_loss"] - b["train_loss"]) / a["train_loss"]
    cos = {m: [_cos(u, v) for u, v in zip(a[m], b[m])]
           for m in ("train", "predict")}
    rel = {m: [((u.float() - v.float()).norm() / u.float().norm()).item()
               for u, v in zip(a[m], b[m])] for m in ("train", "predict")}
    log(f"[resnet-check] resnet50_v1b batch {CHECK_BATCH} at {RESNET_SIZE}, "
        f"bf16 vs float32 (TF32 off), same weights: logits rel. error "
        f"{logit_rel:.3e} (rtol {LOGIT_RTOL}); loss predict mode "
        f"{b['predict_loss']:.5f} vs {a['predict_loss']:.5f} (atol "
        f"{LOSS_ATOL}), step 1 (train mode) {b['train_loss']:.5f} vs "
        f"{a['train_loss']:.5f} (rtol {TRAIN_LOSS_RTOL})")
    for m in ("train", "predict"):
        log(f"[resnet-check] {m}-mode gradients of "
            + ", ".join(f"{n}: rel {r:.3e} cos {c:.4f}" for n, r, c in
                        zip(watched, rel[m], cos[m])))
    gated = [cos["train"][1]] + cos["predict"]
    if not (logit_rel <= LOGIT_RTOL and loss_err <= LOSS_ATOL
            and train_loss_err <= TRAIN_LOSS_RTOL
            and min(gated) >= GRAD_MIN_COS
            and all(torch.isfinite(t.float()).all()
                    for r in (a, b) for t in (*r["train"], *r["predict"]))):
        raise AssertionError("[resnet-check] bf16 and float32 disagree")


# ---------------------------------------------------------------------
# row 7: rtc, a user CudaModule, and the Custom softmax head that trains
# the MLP and LeNet
# ---------------------------------------------------------------------
# (rows, cols): the MLP's head at batch 1024, and an ImageNet-sized head
RTC_SHAPES = ((1024, 10), (8192, 1000))
RTC_TIMED = (8192, 1000)
# softmax forward and backward against their plain versions: expf and the
# row sums in another order, on values of at most 1; axpy: exact (a*x and
# the sum rounded apart on both sides, then once to the type)
RTC_ATOL = 1e-6
AXPY_A = 0.37
MNIST_BATCH = 1024
LENET_SGD = {"learning_rate": 0.1, "momentum": 0.9}      # bench_lenet's
MLP_STEPS = 20
# step 1's weight gradients with the softmax_rtc head against the same
# net with SoftmaxCrossEntropyLoss: the same maths (p - onehot summed over
# the batch), the softmax and the matmuls' sums in another order; relative
# to each parameter's largest gradient
HEAD_GRAD_RTOL = 1e-5


def _rtc_counts():
    from incubator_mxnet_torch import rtc
    return dict(rtc.launch_counts)


def _mnist_batch():
    """`bench_lenet`'s batch: uniform images and labels, numpy seed 0."""
    from incubator_mxnet_torch import nd
    rng = np.random.RandomState(0)
    x = nd.array(rng.uniform(size=(MNIST_BATCH, 1, 28, 28))
                 .astype(np.float32))
    y = nd.array(rng.randint(0, 10, MNIST_BATCH).astype(np.float32))
    return x, y


def phase_rtc(card):
    """Row 7: the softmax_rtc module's kernels through the user API,
    against their plain versions; the cache, a compile error and a
    dtype error; times at 8192 x 1000."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import rtc, softmax_rtc as srtc
    gen = torch.Generator(device="cuda").manual_seed(7)
    dev = torch.device("cuda", 0)
    x = torch.randn(1024, 10, generator=gen, device=dev)
    y = torch.empty_like(x)
    runs0 = sum(rtc.nvcc_runs.values())
    again = rtc.CudaModule(srtc.SOURCE, exports=srtc.EXPORTS)
    on_disk = os.path.exists(again.path)   # from an earlier run here
    t0 = time.perf_counter()
    srtc.softmax_fwd(x, y)           # first use: nvcc, load, launch
    torch.cuda.synchronize()
    compile_s = None if on_disk else time.perf_counter() - t0
    if sum(rtc.nvcc_runs.values()) != runs0 + (not on_disk):
        raise AssertionError("[rtc] the first launch did not build once")
    again.get_kernel("softmax_fwd", "const float *x, float *y, int rows, "
                     "int cols, int req").launch(
        [x, y, 1024, 10, 1], mx.gpu(0), (128, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    if sum(rtc.nvcc_runs.values()) != runs0 + (not on_disk):
        raise AssertionError("[rtc] a second CudaModule of the same source "
                             "ran nvcc")
    first = "found built on disk by an earlier run, so not timed" \
        if on_disk else f"{compile_s:.2f} s"
    log(f"[rtc] softmax_rtc module: first use (nvcc sm_90a, load, launch) "
        f"{first}; a second CudaModule of the same source ran no nvcc "
        f"({again.path})")
    try:
        rtc.CudaModule("__global__ void broken(float *x) { x[0] = 1 }") \
            .get_kernel("broken", "float *x").launch(
                [y], mx.gpu(0), (1,), (1,))
    except mx.MXNetError as e:
        if "error" not in str(e):
            raise AssertionError(f"[rtc] compile error without nvcc's "
                                 f"message: {e}") from None
        log("[rtc] a syntax error raises with nvcc's message: "
            + next(line.strip() for line in str(e).splitlines()
                   if "error" in line and "nvcc failed" not in line))
    else:
        raise AssertionError("[rtc] a syntax error compiled")
    n0 = _rtc_counts()
    try:
        srtc.softmax_fwd(x.double(), y)
    except mx.MXNetError as e:
        log(f"[rtc] a float64 argument raises before launch: {e}")
    else:
        raise AssertionError("[rtc] a float64 argument launched")
    if _rtc_counts() != n0:
        raise AssertionError("[rtc] the refused launch was counted")

    records = {}
    for rows, cols in RTC_SHAPES:
        x = torch.randn(rows, cols, generator=gen, device=dev) * 4
        label = torch.randint(0, cols, (rows,), generator=gen,
                              device=dev).float()
        y, dx, ry, rdx = (torch.empty_like(x) for _ in range(4))
        srtc.softmax_fwd(x, y)
        srtc.softmax_bwd(label, y, dx)
        srtc.softmax_fwd_plain(x, ry, rows, cols, 1)
        srtc.softmax_bwd_plain(label, y, rdx, rows, cols, 1)
        errs = {"softmax_fwd": _max_err(y, ry),
                "softmax_bwd": _max_err(dx, rdx)}
        ab = {}
        for dtype in (torch.float32, torch.bfloat16):
            a, b = (torch.randn(rows, cols, generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            want = b.clone()
            srtc.axpy_plain(a, want, AXPY_A, want.numel())
            srtc.axpy(a, b, AXPY_A)
            name = "axpy<float>" if dtype == torch.float32 else \
                "axpy<__nv_bfloat16>"
            errs[name] = _max_err(b, want)
            ab[name] = (a, b, dtype)
        torch.cuda.synchronize()
        bad = {k: v for k, v in errs.items() if not v <= RTC_ATOL}
        if bad:
            raise AssertionError(f"[rtc] {rows}x{cols}: kernels disagree "
                                 f"with their plain versions: {bad} (atol "
                                 f"{RTC_ATOL})")
        log(f"[rtc] {rows}x{cols}: max|err| vs plain "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" (atol {RTC_ATOL}; axpy exact)")
        if (rows, cols) != RTC_TIMED:
            small = {"softmax_fwd": time_ms(lambda: srtc.softmax_fwd(x, y)),
                     "torch.softmax": time_ms(
                         lambda: torch.softmax(x, dim=1)),
                     "softmax_bwd": time_ms(
                         lambda: srtc.softmax_bwd(label, y, dx))}
            for name, (a, b, _dt) in ab.items():
                small[name] = time_ms(lambda a=a, b=b: srtc.axpy(a, b, AXPY_A))
            log(f"[rtc] {rows}x{cols} kernel times: "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in small.items())
                + f" ({card})")
            path_shape = {"rows": rows, "cols": cols,
                          "ms": small["softmax_fwd"],
                          "library_ms": small["torch.softmax"]}
            continue
        n = rows * cols
        work = {"softmax_fwd": (8 * n, 5 * n, torch.float32),
                "softmax_bwd": (4 * rows + 8 * n, 2 * n, torch.float32),
                "axpy<float>": (12 * n, 2 * n, torch.float32),
                "axpy<__nv_bfloat16>": (6 * n, 2 * n, torch.float32)}
        runs = {"softmax_fwd": (lambda: srtc.softmax_fwd(x, y),
                                lambda: srtc.softmax_fwd_plain(
                                    x, ry, rows, cols, 1),
                                lambda: torch.softmax(x, dim=1)),
                "softmax_bwd": (lambda: srtc.softmax_bwd(label, y, dx),
                                lambda: srtc.softmax_bwd_plain(
                                    label, y, rdx, rows, cols, 1), None)}
        for name, (a, b, _dt) in ab.items():
            runs[name] = ((lambda a=a, b=b: srtc.axpy(a, b, AXPY_A)),
                          (lambda a=a, b=b: srtc.axpy_plain(a, b, AXPY_A,
                                                            b.numel())),
                          (lambda a=a, b=b: b.add_(a, alpha=AXPY_A)))
        for name, (kern, plain, lib) in runs.items():
            bound_ms, bound_by = _bound(*work[name])
            records[name] = {
                "max_abs_err": errs[name], "ms": time_ms(kern),
                "plain_ms": time_ms(plain), "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None if lib is None else time_ms(lib)}
            r = records[name]
            lib_text = "none (no single call)" if lib is None else \
                f"{r['library_ms']:.4f} ms"
            log(f"[rtc] {name} {rows}x{cols}: kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), library {lib_text} ({card})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            srtc.softmax_fwd(x, y)
        host_us = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        log(f"[rtc] host time of one softmax_fwd launch (checks, argument "
            f"packing, cudaLaunchKernel): {host_us:.2f} us over 1000 "
            f"launches")
        for rec in records.values():
            rec.update(host_us_per_launch=host_us,
                       first_use_compile_s=compile_s)
        records["softmax_fwd"]["path_shape"] = path_shape

    # the user API's own drive, counted: each kernel through its wrapper
    # at the MLP head's shape
    rtc.reset_launch_counts()
    x = torch.randn(1024, 10, generator=gen, device=dev)
    label = torch.randint(0, 10, (1024,), generator=gen, device=dev).float()
    y, dx = torch.empty_like(x), torch.empty_like(x)
    srtc.softmax_fwd(x, y)
    srtc.softmax_bwd(label, y, dx)
    srtc.axpy(x, dx, AXPY_A)
    srtc.axpy(x.bfloat16(), dx.bfloat16(), AXPY_A)
    torch.cuda.synchronize()
    drive = _rtc_counts()
    if set(drive) != set(records) or any(v != 1 for v in drive.values()):
        raise AssertionError(f"[rtc] the user API drive launched {drive}")
    log(f"[rtc] user API drive at 1024x10: launches {drive}")
    return records, drive


def phase_train_rtc(card):
    """MLP() at batch 1024 through the imperative loop with the
    softmax_rtc head: returns the path's rtc launch counts."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import autograd, gluon, nd
    from incubator_mxnet_torch.models import get_model
    from incubator_mxnet_torch import softmax_rtc  # noqa: F401 (registers)
    mx.random.seed(0)
    x, y = _mnist_batch()
    net = get_model("mlp")
    net.initialize(mx.init.Xavier())
    params = net._collect_params_with_prefix()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    grads = {}
    for head in ("loss", "rtc"):
        with autograd.record():
            out = net(x)
            lval = loss_fn(out, y) if head == "loss" else \
                nd.Custom(out, y, op_type="softmax_rtc")
        lval.backward()
        grads[head] = {k: p.grad()._data.clone() for k, p in params.items()}
    rel = {k: _max_err(grads["rtc"][k], grads["loss"][k])
           / grads["loss"][k].abs().max().item() for k in params}
    if not max(rel.values()) <= HEAD_GRAD_RTOL:
        raise AssertionError(f"[train-rtc] step-1 gradients of the rtc head "
                             f"differ from SoftmaxCrossEntropyLoss's: {rel}")
    log(f"[train-rtc] MLP 784-128-64-10 at {MNIST_BATCH}: step-1 gradients, "
        f"softmax_rtc head vs SoftmaxCrossEntropyLoss, max |diff| / max|g| "
        f"{max(rel.values()):.2e} (rtol {HEAD_GRAD_RTOL})")
    trainer = gluon.Trainer(net.collect_params(), "sgd", LENET_SGD)
    rows = torch.arange(MNIST_BATCH, device=x.data.device)
    labels = y.data.long()
    losses = []

    def step():
        with autograd.record():
            prob = nd.Custom(net(x), y, op_type="softmax_rtc")
        prob.backward()
        trainer.step(MNIST_BATCH)
        losses.append(-prob.data.detach()[rows, labels].log().mean())
    _reset_all_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(MLP_STEPS):
        step()
    end.record()
    torch.cuda.synchronize()
    counts = _all_counts()
    path_counts = _rtc_counts()
    step_ms = start.elapsed_time(end) / MLP_STEPS
    _check_head_counts(counts, MLP_STEPS, "[train-rtc]")
    log(f"[train-rtc] {MLP_STEPS} steps of record / nd.Custom(softmax_rtc) / "
        f"backward / gluon.Trainer(sgd {LENET_SGD}).step({MNIST_BATCH}): "
        f"{step_ms:.3f} ms a step (CUDA events); launches {path_counts} "
        f"({card})")
    dev_ms, launches = log_profile(step, "one MLP step with the rtc head",
                                   tag="[train-rtc]", top=6)
    log(f"[train-rtc] profiled step: {dev_ms:.3f} ms of device time in "
        f"{launches} launches; against the {step_ms:.3f} ms step the device "
        f"is idle {1 - dev_ms / step_ms:.3f} of the step")
    losses = [v.item() for v in losses]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"[train-rtc] losses {losses} are not finite "
                             f"and falling")
    log(f"[train-rtc] losses over {len(losses)} steps: {losses[0]:.4f} -> "
        f"{losses[MLP_STEPS - 1]:.4f} -> {losses[-1]:.4f}")
    return path_counts


def _check_head_counts(counts, steps, tag):
    """Exactly one softmax_rtc forward and backward a step, nothing else."""
    want = {"softmax_fwd": steps, "softmax_bwd": steps}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{tag} launches {got}, expected {want}")


def phase_train_lenet(card):
    """`bench_lenet`: LeNet at batch 1024 through ParallelTrainer with the
    plain loss, then 3 imperative iterations with the softmax_rtc head."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import autograd, gluon, nd, parallel
    from incubator_mxnet_torch.models import get_model
    from incubator_mxnet_torch import softmax_rtc  # noqa: F401 (registers)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mx.random.seed(0)
    net = get_model("lenet")
    net.initialize(mx.init.Xavier())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    tr = parallel.ParallelTrainer(net, lambda o, lab: loss_fn(o, lab),
                                  optimizer="sgd",
                                  optimizer_params=LENET_SGD,
                                  mesh=parallel.default_mesh(1))
    x, y = _mnist_batch()
    _reset_all_counts()
    losses = [tr.step(x, y).asscalar() for _ in range(3)]
    k = 10
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    losses.append(tr.run_steps(k, x, y).asscalar())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / k
    if any(_all_counts().values()):
        raise AssertionError(f"[train-lenet] the plain loss launched "
                             f"{_all_counts()}")
    log(f"[train-lenet] LeNet {MNIST_BATCH}x1x28x28 float32 (TF32 off), SGD "
        f"{LENET_SGD}: 3 steps then run_steps({k}): losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; step {step_ms:.3f} ms, {MNIST_BATCH / step_ms * 1e3:.1f} "
        f"images/s (CUDA events over run_steps) ({card})")
    dev_ms, launches = log_profile(
        lambda: losses.append(tr.step(x, y).asscalar()),
        "one LeNet ParallelTrainer step", tag="[train-lenet]", top=6)
    log(f"[train-lenet] profiled step: {dev_ms:.3f} ms of device time in "
        f"{launches} launches; against the {step_ms:.3f} ms step of "
        f"run_steps({k}) the device is idle {1 - dev_ms / step_ms:.3f} of "
        f"the step")
    trainer = gluon.Trainer(net.collect_params(), "sgd", LENET_SGD)
    labels = y.data.long()
    rows = torch.arange(MNIST_BATCH, device=labels.device)
    for _ in range(3):
        with autograd.record():
            prob = nd.Custom(net(x), y, op_type="softmax_rtc")
        prob.backward()
        trainer.step(MNIST_BATCH)
        losses.append(-prob.data.detach()[rows, labels].log().mean().item())
    torch.cuda.synchronize()
    _check_head_counts(_all_counts(), 3, "[train-lenet]")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"[train-lenet] losses {losses} are not "
                             f"finite and falling")
    log(f"[train-lenet] 3 imperative iterations with the softmax_rtc head: "
        f"losses " + ", ".join(f"{v:.4f}" for v in losses[-3:])
        + f"; launches {_rtc_counts()}")
    return _rtc_counts()


# ---------------------------------------------------------------------
# the PTB LSTM: the fused RNN op, bench_lstm, the word-LM example's loop
# ---------------------------------------------------------------------
RNN_MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
# [rnn-check] at T = 7, N = 3, I = 5, H = 6, 2 layers: the op on the card
# against the CPU in float32 (TF32 off: the same arithmetic, sums in
# another order), relative to each value's largest; in bf16 the card
# against the CPU, whose op tests/test_torch_rnn.py holds against the JAX
# package, at that test's bf16 gradient tolerance (rtol and atol 2^-7 of
# each value's largest: both devices run one formula, and a sum in
# another order can move a rounded h or gradient one bf16 step); bf16
# against float32 on the card by cosine; the bf16 op's float32 cell
# state on the card against the CPU's, whose products of bf16 values are
# exact in float32 (a product rounded to bf16 would move it ~1e-3)
RNN_RTOL = 1e-5
RNN_BF16_TOL = dict(rtol=2 ** -7, atol_of_max=2 ** -7)
RNN_MIN_COS = 0.999
RNN_GRAD_MIN_COS = 0.99
RNN_CY_ATOL = 1e-5
LSTM_VOCAB, LSTM_WIDTH, LSTM_LAYERS = 10000, 650, 2       # bench_lstm's
LSTM_BATCH, LSTM_SEQ = 512, 35
LSTM_SGD = {"learning_rate": 1.0}
# [train-lstm]'s parity check: bench_lstm's model at full width from one
# set of weights through two ParallelTrainer steps on a 4 x 35 batch on
# the card and on the CPU (held against the JAX package by
# tests/test_torch_lstm_lm.py), at that test's bf16 tolerances: losses
# rtol 1e-3, weights rtol and atol 2^-7 of each weight's largest
LSTM_CHECK_BATCH, LSTM_CHECK_STEPS = 4, 2
LSTM_LOSS_TOL = dict(rtol=1e-3, atol_of_max=0.0)
LSTM_WEIGHT_TOL = dict(rtol=2 ** -7, atol_of_max=2 ** -7)
# the word-LM example's defaults (example/gluon/word_language_model/
# train.py:97-111) on its synthetic corpus, four epochs (its default is
# two): at lr 1.0 SGD learns the corpus's unigram first, whose
# perplexity (423.6) the train perplexity nears by the fourth and holds
# (the JAX package's example runs the same course), so the perplexity
# gate (0.9 x the vocabulary) cannot tell a working recurrence; the
# parity check before it does: the loop's first three batches at
# dropout 0 from one set of weights on the card and on the CPU (held
# against the JAX package by tests/test_torch_lstm_lm.py), in float32
# with TF32 off, at that test's float32 tolerances: losses rtol 1e-5,
# carried states and weights rtol 1e-4 and atol 1e-5 of each one's
# largest
EX_VOCAB, EX_WIDTH, EX_LAYERS, EX_BATCH, EX_BPTT = 500, 200, 2, 32, 35
EX_DROPOUT, EX_LR, EX_CLIP, EX_EPOCHS = 0.2, 1.0, 0.25, 4
EX_MAX_PPL = 0.9 * EX_VOCAB
EX_CHECK_BATCHES = 3
EX_LOSS_TOL = dict(rtol=1e-5, atol_of_max=0.0)
EX_STATE_TOL = dict(rtol=1e-4, atol_of_max=1e-5)


def _tol_ratio(got, ref, rtol, atol_of_max):
    """The largest |got - ref| / (rtol |ref| + atol_of_max max |ref|) of
    two float arrays or tensors: at most 1 where they agree."""
    got, ref = (torch.as_tensor(np.asarray(t, np.float32))
                if not isinstance(t, torch.Tensor) else t.detach().float()
                .cpu() for t in (got, ref))
    bound = rtol * ref.abs() + atol_of_max * ref.abs().max()
    return ((got - ref).abs() / bound.clamp_min(1e-30)).max().item()


def _rnn_inputs(mode, bidirectional, seed):
    """Seeded float64 inputs of the RNN op at T = 7, N = 3, I = 5, H = 6,
    2 layers, and its attributes."""
    from incubator_mxnet_torch.ops import rnn as rnn_op
    T_, N_, I_, H_, L_ = 7, 3, 5, 6, 2
    D_ = 2 if bidirectional else 1
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(T_, N_, I_), rng.uniform(
        -0.4, 0.4, rnn_op.rnn_param_size(L_, I_, H_, bidirectional, mode)),
        0.5 * rng.randn(L_ * D_, N_, H_)]
    if mode == "lstm":
        arrays.append(0.5 * rng.randn(L_ * D_, N_, H_))
    kw = dict(state_size=H_, num_layers=L_, mode=mode,
              bidirectional=bidirectional)
    return arrays, kw


def _rnn_run(inputs, kw, seed=1):
    """The RNN op's outputs and the gradients of every input for seeded
    cotangents, all as float32 CPU tensors."""
    from incubator_mxnet_torch.ops import rnn as rnn_op
    outs = rnn_op.rnn(*inputs, **kw)
    gen = torch.Generator().manual_seed(seed)
    cots = [torch.randn(o.shape, generator=gen).to(o) for o in outs]
    grads = torch.autograd.grad(outs, inputs, cots)
    return [t.detach().float().cpu() for t in (*outs, *grads)]


def _rnn_route_ms(m, k, n):
    """The two routes of a bf16 (m, k) x (k, n) product with a float32
    result: cuBLAS's bf16 GEMM with float32 output (the forward's) and
    both operands taken to float32, TF32 off (the backward's products
    are such float32 GEMMs): device ms of each, the first's largest
    error against float64, and host µs of a call of the first, of the
    float32 GEMM and of the plain bf16 GEMM."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
    b = torch.randn(k, n, device="cuda", generator=gen).bfloat16()
    a32, b32 = a.float(), b.float()
    mixed = time_ms(lambda: torch.mm(a, b, out_dtype=torch.float32))
    upcast = time_ms(lambda: a.float() @ b.float())
    exact = (torch.mm(a, b, out_dtype=torch.float32)
             - a.double() @ b.double()).abs().max().item()
    host = [host_us(f) for f in (
        lambda: torch.mm(a, b, out_dtype=torch.float32),
        lambda: torch.mm(a32, b32), lambda: torch.mm(a, b))]
    return mixed, upcast, exact, host


def phase_rnn_check(card):
    """The RNN op on cuda:0 against the CPU in float32 and in bf16 for
    every mode, uni- and bidirectional; bf16 against float32 on the
    card; the product route's times at bench_lstm's shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {}
    for mode in RNN_MODES:
        for bi in (False, True):
            seed = RNN_MODES.index(mode) * 2 + bi
            res = {}
            arrays, kw = _rnn_inputs(mode, bi, seed)
            for dev, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                            ("cuda", torch.bfloat16),
                            ("cpu", torch.bfloat16)):
                # float64 -> float32 -> bf16 on both devices alike
                ts = [torch.tensor(a, dtype=torch.float32).to(dev, dt)
                      .requires_grad_() for a in arrays]
                res[dev, dt] = _rnn_run(ts, kw)
            n_out = 3 if mode == "lstm" else 2
            gpu32, cpu32 = res["cuda", torch.float32], res["cpu",
                                                           torch.float32]
            errs = [((g - c).abs().max() / c.abs().max()).item()
                    for g, c in zip(gpu32, cpu32)]
            gpu16, cpu16 = res["cuda", torch.bfloat16], res["cpu",
                                                            torch.bfloat16]
            bf16 = max(_tol_ratio(g, c, **RNN_BF16_TOL)
                       for g, c in zip(gpu16, cpu16))
            cos = [_cos(g, c) for g, c in zip(gpu16, gpu32)]
            cy_err = (gpu16[2] - cpu16[2]).abs().max().item() \
                if mode == "lstm" else 0.0
            tag = f"{mode}{' bidirectional' if bi else ''}"
            log(f"[rnn-check] {tag}: cuda vs cpu float32 rel. error "
                f"out/states {max(errs[:n_out]):.2e}, gradients "
                f"{max(errs[n_out:]):.2e} (rtol {RNN_RTOL}); cuda vs cpu "
                f"bf16, outputs and gradients, {bf16:.3f} of the tolerance "
                f"(rtol and atol 2^-7 of the largest); bf16 vs float32 on "
                f"the card cos out/states {min(cos[:n_out]):.5f}, "
                f"gradients {min(cos[n_out:]):.5f}"
                + (f"; bf16 cy cuda vs cpu {cy_err:.2e} (atol "
                   f"{RNN_CY_ATOL})" if mode == "lstm" else ""))
            worst[tag] = (max(errs), bf16, min(cos[:n_out]),
                          min(cos[n_out:]), cy_err)
            if not (max(errs) <= RNN_RTOL and bf16 <= 1
                    and min(cos[:n_out]) >= RNN_MIN_COS
                    and min(cos[n_out:]) >= RNN_GRAD_MIN_COS
                    and cy_err <= RNN_CY_ATOL
                    and all(torch.isfinite(t).all() for r in res.values()
                            for t in r)):
                raise AssertionError(f"[rnn-check] {tag} disagrees")
    tokens = LSTM_BATCH * LSTM_SEQ
    for what, m in (("recurrent", LSTM_BATCH), ("input projection", tokens)):
        mixed, upcast, exact, host = _rnn_route_ms(m, LSTM_WIDTH,
                                                   4 * LSTM_WIDTH)
        log(f"[rnn-check] bf16 product route at {what} {m}x{LSTM_WIDTH}x"
            f"{4 * LSTM_WIDTH}: torch.mm(out_dtype=float32) {mixed:.4f} ms "
            f"(the forward's; max |error| against float64 {exact:.2e}), "
            f"float32, TF32 off {upcast:.4f} ms (the backward's, twice a "
            f"product); host µs a call: out_dtype {host[0]:.1f}, float32 "
            f"{host[1]:.1f}, plain bf16 {host[2]:.1f} ({card})")
    return worst


def _lstm_net(ctx):
    """`bench_lstm`'s model on `ctx`: Xavier from seed 0, cast to bf16."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch.models import LSTMLanguageModel
    mx.random.seed(0)
    net = LSTMLanguageModel(LSTM_VOCAB, embed_dim=LSTM_WIDTH,
                            hidden=LSTM_WIDTH, layers=LSTM_LAYERS,
                            dropout=0.0)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.cast("bfloat16")
    return net


def _lstm_trainer(net, ctx):
    """`bench_lstm`'s ParallelTrainer: SoftmaxCrossEntropyLoss, SGD."""
    from incubator_mxnet_torch import gluon, parallel
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    return parallel.ParallelTrainer(net, lambda o, y: loss_fn(o, y),
                                    optimizer="sgd",
                                    optimizer_params=LSTM_SGD,
                                    mesh=parallel.default_mesh(ctx=ctx))


def _tokens(rng, batch):
    """Two (batch, LSTM_SEQ) arrays of token ids (data, labels)."""
    return [rng.randint(0, LSTM_VOCAB, (batch, LSTM_SEQ)).astype(np.float32)
            for _ in range(2)]


def _weights(block):
    return {k: v.data().asnumpy().astype(np.float32)
            for k, v in block._collect_params_with_prefix().items()}


def _lstm_parity():
    """bench_lstm's model at full width from one set of weights through
    LSTM_CHECK_STEPS ParallelTrainer steps on the card and on the CPU;
    the worst losses' and weights' share of their tolerances."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import nd
    from incubator_mxnet_torch.convert import params_from_jax
    arrays = _tokens(np.random.RandomState(1), LSTM_CHECK_BATCH)
    start, runs = None, []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = _lstm_net(ctx)
        if start is None:
            start = _weights(net)
        else:
            params_from_jax(net, start, ctx=ctx)
        tr = _lstm_trainer(net, ctx)
        with ctx:
            x, y = (nd.array(a) for a in arrays)
        runs.append(([tr.step(x, y).asscalar()
                      for _ in range(LSTM_CHECK_STEPS)], _weights(net)))
    (gl, gw), (cl, cw) = runs
    return (gl, cl, _tol_ratio(gl, cl, **LSTM_LOSS_TOL),
            max(_tol_ratio(gw[k], cw[k], **LSTM_WEIGHT_TOL) for k in cw))


def phase_train_lstm(card):
    """`bench_lstm` at full width: first held against the CPU on a small
    batch, then trained through ParallelTrainer, beside cuDNN's LSTM at
    the same shape (a yardstick: nothing on the path calls it)."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import nd
    gl, cl, loss_r, weight_r = _lstm_parity()
    log(f"[train-lstm] parity at full width, batch {LSTM_CHECK_BATCH}x"
        f"{LSTM_SEQ}, {LSTM_CHECK_STEPS} steps from one set of weights: "
        f"losses cuda " + ", ".join(f"{v:.5f}" for v in gl) + ", cpu "
        + ", ".join(f"{v:.5f}" for v in cl) + f" ({loss_r:.3f} of rtol "
        f"1e-3); weights {weight_r:.3f} of the tolerance (rtol and atol "
        f"2^-7 of the largest)")
    if not (loss_r <= 1 and weight_r <= 1):
        raise AssertionError("[train-lstm] the card disagrees with the CPU")
    t0 = time.time()
    net = _lstm_net(mx.gpu(0))
    tr = _lstm_trainer(net, mx.gpu(0))
    x, y = (nd.array(a) for a in _tokens(np.random.RandomState(0),
                                          LSTM_BATCH))
    tokens = LSTM_BATCH * LSTM_SEQ
    _reset_all_counts()
    losses = [tr.step(x, y).asscalar() for _ in range(3)]
    log(f"[train-lstm] LSTMLanguageModel({LSTM_VOCAB}, {LSTM_WIDTH}/"
        f"{LSTM_WIDTH}, {LSTM_LAYERS} layers) bf16, batch {LSTM_BATCH}x"
        f"{LSTM_SEQ}, SGD {LSTM_SGD}: built and 3 steps in "
        f"{time.time() - t0:.1f} s; losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    k = 10
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    losses.append(tr.run_steps(k, x, y).asscalar())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / k
    log(f"[train-lstm] run_steps({k}): loss {losses[-1]:.4f}, step "
        f"{step_ms:.2f} ms, {tokens / step_ms * 1e3:.0f} tokens/s (CUDA "
        f"events over the {k} steps) ({card})")
    dev_ms, launches = log_profile(
        lambda: losses.append(tr.step(x, y).asscalar()),
        f"one {LSTM_BATCH}x{LSTM_SEQ} training step", tag="[train-lstm]",
        top=15)
    log(f"[train-lstm] profiled step: {dev_ms:.2f} ms of device time in "
        f"{launches} launches; against the {step_ms:.2f} ms step of "
        f"run_steps({k}) the device is idle {1 - dev_ms / step_ms:.3f} of "
        f"the step")
    if any(_all_counts().values()):
        raise AssertionError(f"[train-lstm] launched hand kernels "
                             f"{_all_counts()}: the LSTM has none")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"[train-lstm] losses {losses} are not finite "
                             f"and falling")
    log(f"[train-lstm] losses over {len(losses)} steps: "
        + ", ".join(f"{v:.4f}" for v in losses))
    del net, tr
    cudnn = torch.nn.LSTM(LSTM_WIDTH, LSTM_WIDTH, LSTM_LAYERS).cuda() \
        .bfloat16()
    xs = torch.randn(LSTM_SEQ, LSTM_BATCH, LSTM_WIDTH, device="cuda",
                     dtype=torch.bfloat16, requires_grad=True)

    def fwd_bwd():
        out, _ = cudnn(xs)
        out.sum().backward()
    with torch.no_grad():
        fwd = time_ms(lambda: cudnn(xs), iters=10)
    both = time_ms(fwd_bwd, iters=10)
    log(f"[train-lstm] yardstick, cuDNN torch.nn.LSTM({LSTM_WIDTH}, "
        f"{LSTM_WIDTH}, {LSTM_LAYERS}) bf16 at ({LSTM_SEQ}, {LSTM_BATCH}, "
        f"{LSTM_WIDTH}): forward {fwd:.3f} ms, forward + backward "
        f"{both:.3f} ms ({card})")
    return step_ms


def _synthetic_corpus(vocab, n=60000, seed=0):
    """The example's Markov-chain corpus (`synthetic_corpus`)."""
    rng = np.random.RandomState(seed)
    trans = rng.randint(0, vocab, size=(vocab, 4))
    data = np.empty(n, np.int32)
    data[0] = 0
    for i in range(1, n):
        data[i] = trans[data[i - 1], rng.randint(0, 4)]
    return data


def _batchify(data, batch_size):
    nb = len(data) // batch_size
    return data[:nb * batch_size].reshape(batch_size, nb).T


def _get_batch(source, i, bptt):
    from incubator_mxnet_torch import nd
    seq_len = min(bptt, source.shape[0] - 1 - i)
    return (nd.array(source[i:i + seq_len].astype(np.float32)),
            nd.array(source[i + 1:i + 1 + seq_len].astype(np.float32)))


def _word_lm_model(dropout=EX_DROPOUT):
    """The example's `RNNModel` (train.py:25-48) written against the port."""
    from incubator_mxnet_torch import gluon
    from incubator_mxnet_torch.gluon import nn, rnn

    class RNNModel(gluon.Block):
        def __init__(self, vocab_size, num_embed, num_hidden, num_layers,
                     dropout=0.2, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(vocab_size, num_embed)
                self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                                    input_size=num_embed)
                self.decoder = nn.Dense(vocab_size, in_units=num_hidden,
                                        flatten=False)
                self.num_hidden = num_hidden

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            decoded = self.decoder(output)
            return decoded, hidden

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)
    return RNNModel(EX_VOCAB, EX_WIDTH, EX_WIDTH, EX_LAYERS, dropout)


def _example_batch(model, trainer, loss_fn, hidden, x, y):
    """One batch of the example's loop (train.py:135-145): the hidden
    state detached, forward, backward, `trainer.step(1)`.  Returns the
    batch's mean loss (an NDArray) and the new hidden state."""
    from incubator_mxnet_torch import autograd
    hidden = [h.detach() for h in hidden]
    with autograd.record():
        out, hidden = model(x, hidden)
        loss = loss_fn(out.reshape(-1, out.shape[-1]),
                       y.reshape(-1)).mean()
    loss.backward()
    trainer.step(1)
    return loss, hidden


def _example_trainer(model):
    from incubator_mxnet_torch import gluon
    return gluon.Trainer(model.collect_params(), "sgd",
                         {"learning_rate": EX_LR, "clip_gradient": EX_CLIP})


def _example_parity(train_data):
    """The example's loop over its first EX_CHECK_BATCHES batches at
    dropout 0, from one set of weights, on the card and on the CPU in
    float32: the worst losses', carried states' and weights' share of
    their tolerances."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import gluon, nd
    from incubator_mxnet_torch.convert import params_from_jax
    torch.backends.cuda.matmul.allow_tf32 = False
    start, runs = None, []
    for ctx in (mx.gpu(0), mx.cpu()):
        mx.random.seed(0)
        model = _word_lm_model(dropout=0.0)
        model.initialize(mx.init.Xavier(), ctx=ctx)
        if start is None:
            start = _weights(model)
        else:
            params_from_jax(model, start, ctx=ctx)
        trainer = _example_trainer(model)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        with ctx:
            hidden = model.begin_state(func=nd.zeros, batch_size=EX_BATCH,
                                       ctx=ctx)
            for i in range(0, EX_CHECK_BATCHES * EX_BPTT, EX_BPTT):
                x, y = _get_batch(train_data, i, EX_BPTT)
                loss, hidden = _example_batch(model, trainer, loss_fn,
                                              hidden, x, y)
                losses.append(loss.asscalar())
        runs.append((losses, [h.asnumpy() for h in hidden],
                     _weights(model)))
    (gl, gh, gw), (cl, ch, cw) = runs
    return (gl, cl, _tol_ratio(gl, cl, **EX_LOSS_TOL),
            max(_tol_ratio(g, c, **EX_STATE_TOL) for g, c in zip(gh, ch)),
            max(_tol_ratio(gw[k], cw[k], **EX_STATE_TOL) for k in cw))


def phase_lstm_example(card):
    """The word-LM example's loop (train.py:97-157): its first batches
    held against the CPU, then its defaults on its synthetic corpus:
    TNC, the hidden state carried and detached, gluon.Trainer SGD with
    clip_gradient; then one predict-mode pass over the validation
    split."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import autograd, gluon, nd
    corpus = _synthetic_corpus(EX_VOCAB)
    n = len(corpus)
    train_data = _batchify(corpus[:int(n * 0.9)], EX_BATCH)
    val_data = _batchify(corpus[int(n * 0.9):], EX_BATCH)
    gl, cl, loss_r, state_r, weight_r = _example_parity(train_data)
    log(f"[lstm-example] parity over the first {EX_CHECK_BATCHES} batches "
        f"at dropout 0 from one set of weights, float32: losses cuda "
        + ", ".join(f"{v:.6f}" for v in gl) + ", cpu "
        + ", ".join(f"{v:.6f}" for v in cl) + f" ({loss_r:.3f} of rtol "
        f"1e-5); carried states {state_r:.3f} and weights {weight_r:.3f} of "
        f"the tolerance (rtol 1e-4, atol 1e-5 of the largest)")
    if not (loss_r <= 1 and state_r <= 1 and weight_r <= 1):
        raise AssertionError("[lstm-example] the card disagrees with the "
                             "CPU")
    mx.random.seed(0)
    model = _word_lm_model()
    model.initialize(mx.init.Xavier())
    trainer = _example_trainer(model)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    _reset_all_counts()
    ppls = []
    for epoch in range(EX_EPOCHS):
        total_loss, total_n = 0.0, 0
        hidden = model.begin_state(func=nd.zeros, batch_size=EX_BATCH)
        torch.cuda.synchronize()
        tic = time.time()
        for i in range(0, train_data.shape[0] - 1, EX_BPTT):
            x, y = _get_batch(train_data, i, EX_BPTT)
            loss, hidden = _example_batch(model, trainer, loss_fn, hidden,
                                          x, y)
            total_loss += float(loss.asnumpy()) * y.size
            total_n += y.size
        wall = time.time() - tic
        ppls.append(math.exp(total_loss / total_n))
        log(f"[lstm-example] epoch {epoch}: train perplexity {ppls[-1]:.1f} "
            f"over {total_n} tokens, {total_n / wall:.0f} tokens/s (host "
            f"clock, the loss read back every batch) ({card})")
    total_loss, total_n = 0.0, 0
    hidden = model.begin_state(func=nd.zeros, batch_size=EX_BATCH)
    with autograd.predict_mode():
        for i in range(0, val_data.shape[0] - 1, EX_BPTT):
            x, y = _get_batch(val_data, i, EX_BPTT)
            out, hidden = model(x, hidden)
            loss = loss_fn(out.reshape(-1, out.shape[-1]), y.reshape(-1))
            total_loss += float(loss.sum().asnumpy())
            total_n += y.size
    val_ppl = math.exp(total_loss / total_n)
    freq = np.bincount(corpus[:int(n * 0.9)], minlength=EX_VOCAB) \
        / int(n * 0.9)
    freq = freq[freq > 0]
    log(f"[lstm-example] predict-mode pass over {total_n} validation "
        f"tokens: perplexity {val_ppl:.1f} (vocabulary {EX_VOCAB}, the "
        f"train split's unigram {math.exp(-(freq * np.log(freq)).sum()):.1f}"
        f"; gate {EX_MAX_PPL:.0f})")
    if any(_all_counts().values()):
        raise AssertionError(f"[lstm-example] launched hand kernels "
                             f"{_all_counts()}")
    if not (np.all(np.isfinite(ppls + [val_ppl])) and ppls[-1] < ppls[0]
            and ppls[-1] < EX_MAX_PPL and val_ppl < EX_MAX_PPL):
        raise AssertionError(f"[lstm-example] perplexities {ppls}, "
                             f"{val_ppl} do not fall below {EX_MAX_PPL}")
    return ppls, val_ppl


# ---------------------------------------------------------------------
# the vision zoo: one model per family at full width, no hand kernel
# ---------------------------------------------------------------------
# (zoo name, input size): each family at its own resolution, 1000 classes
ZOO = (("resnet50_v2", 224), ("cifar_resnet20_v2", 32), ("vgg16_bn", 224),
       ("alexnet", 224), ("squeezenet1.1", 224), ("mobilenet1.0", 224),
       ("mobilenetv2_1.0", 224), ("densenet121", 224), ("inceptionv3", 299))
ZOO_CHECK_BATCH = 2
ZOO_INFER_BATCH = 64
# [zoo-check]: float32 predict-mode logits on the card (TF32 off) against
# the port on the CPU, which the tests hold against the JAX package:
# rtol and atol 1e-4 of the largest value (cuDNN's and the CPU's sums in
# another order through up to 94 convolutions).  bf16 against float32 on
# the card by cosine, as [resnet-check] does in predict mode.
ZOO_LOGIT_TOL = 1e-4
ZOO_MIN_COS = 0.99
# [train-zoo]: bench_resnet50's recipe on MobileNetV2 1.0.  Parity of 2
# ParallelTrainer steps at 4 x 224² in float32 (TF32 off), card against
# CPU: step 1's loss (one train-mode forward) to rtol 1e-4.  After one
# update this net's training is chaotic in float32: its 52 train-mode
# BatchNorms over 4 images, each followed by a ReLU that flips on inputs
# within rounding of 0, spread any last-bit difference, and the CPU's
# own two convolution implementations (oneDNN and torch's native ones)
# end 3.4e-2 apart in step 2's loss and 0.31 apart in the update on an
# H100 host.  So step 2's loss, the update and the running stats (each as
# one relative error over all tensors) are held to 3 times the CPU's
# own spread, measured in the same run, never below 1e-4.
MNV2 = "mobilenetv2_1.0"
MNV2_BATCH, MNV2_CHECK_BATCH, MNV2_CHECK_STEPS = 256, 4, 2
MNV2_LOSS_RTOL = 1e-4
MNV2_SPREAD_FACTOR, MNV2_SPREAD_FLOOR = 3.0, 1e-4


def _zoo_net(name, ctx):
    """Zoo model `name` (1000 classes) with Xavier weights from seed 0 on
    `ctx`, its deferred shapes not yet fixed."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch.gluon.model_zoo.vision import get_model
    mx.random.seed(0)
    net = get_model(name, classes=RESNET_CLASSES)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def _zoo_input(batch, size, dtype=torch.float32, seed=1):
    x = np.random.RandomState(seed).uniform(size=(batch, 3, size, size))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def phase_zoo_check(card):
    """Each family at full width: the predict-mode forward at batch 2 on
    the card in float32 (TF32 off) against the port on the CPU from the
    same weights, and bf16 against float32 on the card by cosine."""
    import incubator_mxnet_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for name, size in ZOO:
        t0 = time.time()
        x = _zoo_input(ZOO_CHECK_BATCH, size)
        net = _zoo_net(name, mx.gpu(0))
        with torch.no_grad():
            got = net(x.cuda()).float().cpu()
        weights = {k: p.data()._data.cpu() for k, p in
                   net._collect_params_with_prefix().items()}
        cpu_net = _zoo_net(name, mx.cpu())
        cpu_net.load_dict(weights, ctx=mx.cpu())
        net.cast("bfloat16")
        with torch.no_grad():
            ref = cpu_net(x)
            b16 = net(x.cuda().bfloat16()).float().cpu()
        ratio = _tol_ratio(got, ref, ZOO_LOGIT_TOL, ZOO_LOGIT_TOL)
        cos = _cos(b16, got)
        worst = max(worst, ratio)
        log(f"[zoo-check] {name} {ZOO_CHECK_BATCH}x3x{size}x{size}: "
            f"{len(weights)} parameters, logits {tuple(got.shape)}, largest "
            f"{ref.abs().max().item():.4g}; float32 card vs CPU "
            f"{ratio:.3f} of the tolerance (rtol and atol {ZOO_LOGIT_TOL} "
            f"of the largest); bf16 vs float32 cosine {cos:.5f} (gate "
            f"{ZOO_MIN_COS}) [{time.time() - t0:.1f} s] ({card})")
        if tuple(got.shape) != tuple(ref.shape) or not (
                ratio <= 1 and cos >= ZOO_MIN_COS
                and torch.isfinite(b16).all()):
            raise AssertionError(f"[zoo-check] {name}: the card disagrees")
        del net, cpu_net
        torch.cuda.empty_cache()
    return worst


def phase_infer_zoo(card):
    """Each family's predict-mode forward at batch 64 in bf16: time,
    device time, idle share and peak memory."""
    import incubator_mxnet_torch as mx
    rows = {}
    for name, size in ZOO:
        net = _zoo_net(name, mx.gpu(0))
        net.cast("bfloat16")
        x = _zoo_input(ZOO_INFER_BATCH, size, torch.bfloat16).cuda()
        with torch.inference_mode():
            net(x)                          # fixes the deferred shapes
        before = _bn_states(net)
        _reset_all_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            out = net(x)
            fwd_ms = time_ms(lambda: net(x), iters=5, warmup=1)
            dev_ms, launches = log_profile(
                lambda: net(x), f"one {ZOO_INFER_BATCH}x3x{size}x{size} "
                f"{name} forward", tag="[infer-zoo]", top=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        after = _bn_states(net)
        if out.shape != (ZOO_INFER_BATCH, RESNET_CLASSES) or \
                not torch.isfinite(out.float()).all():
            raise AssertionError(f"[infer-zoo] {name}: bad output "
                                 f"{tuple(out.shape)}")
        if any(not torch.equal(before[k], after[k]) for k in before):
            raise AssertionError(f"[infer-zoo] {name}: predict mode moved "
                                 f"running stats")
        if any(_all_counts().values()):
            raise AssertionError(f"[infer-zoo] {name}: launched hand "
                                 f"kernels {_all_counts()}")
        rows[name] = fwd_ms
        log(f"[infer-zoo] {name} predict-mode forward {ZOO_INFER_BATCH}x3x"
            f"{size}x{size} bf16: {fwd_ms:.2f} ms (CUDA events), "
            f"{ZOO_INFER_BATCH / fwd_ms * 1e3:.1f} images/s; {dev_ms:.2f} "
            f"ms of device time in {launches} launches (profiler), idle "
            f"{1 - dev_ms / fwd_ms:.3f}; peak memory {peak:.2f} GiB; "
            f"{len(before)} running stats unchanged ({card})")
        del net, x, out
        torch.cuda.empty_cache()
    return rows


def _mnv2_run(ctx, start, flags=None):
    """MNV2_CHECK_STEPS float32 ParallelTrainer steps of MobileNetV2 1.0
    at MNV2_CHECK_BATCH x 224² on `ctx` from the weights `start` (None:
    its own Xavier weights, fixed by a first forward); returns the
    starting weights, the losses and the weights after."""
    from incubator_mxnet_torch.convert import params_from_jax
    with flags or contextlib.nullcontext():
        net, _loss, tr, x, y = _image_bench(MNV2, MNV2_CHECK_BATCH, 224,
                                            "float32", ctx)
        if start is None:
            with torch.no_grad():
                net(x._data)                # fixes the deferred shapes
            start = _weights(net)
        else:
            params_from_jax(net, start, ctx=ctx)
        losses = [tr.step(x, y).asscalar()
                  for _ in range(MNV2_CHECK_STEPS)]
    return start, losses, _weights(net)


def _mnv2_errors(run, ref, start):
    """(step 1's loss, step 2's loss, the update, the running stats), each
    as a relative error of `run` against `ref` over all tensors."""
    def rel(pairs):
        pairs = list(pairs)
        return math.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs)
                         / sum(np.sum(b ** 2) for _, b in pairs))
    (rl, rw), (fl, fw) = run, ref
    stats = [k for k in start if "running" in k]
    return (abs(rl[0] - fl[0]) / abs(fl[0]), abs(rl[1] - fl[1]) / abs(fl[1]),
            rel((rw[k] - start[k], fw[k] - start[k]) for k in start
                if k not in stats),
            rel((rw[k], fw[k]) for k in stats))


def _mnv2_parity():
    """MobileNetV2 1.0 at full width from one set of weights through
    MNV2_CHECK_STEPS steps on the card, on the CPU, and on the CPU with
    oneDNN off (the yardstick); the losses and the card's and the
    yardstick's errors against the CPU."""
    import incubator_mxnet_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start, gl, gw = _mnv2_run(mx.gpu(0), None)
    _, cl, cw = _mnv2_run(mx.cpu(), start)
    _, nl, nw = _mnv2_run(mx.cpu(), start,
                          torch.backends.mkldnn.flags(enabled=False))
    return (gl, cl, nl, _mnv2_errors((gl, gw), (cl, cw), start),
            _mnv2_errors((nl, nw), (cl, cw), start))


def phase_train_zoo(card):
    """MobileNetV2 1.0 at full width on bench_resnet50's recipe: parity
    with the CPU at batch 4, then batch 256 through ParallelTrainer and
    the imperative loop."""
    from incubator_mxnet_torch import autograd, gluon
    gl, cl, nl, card_err, spread = _mnv2_parity()
    names = ("step 1 loss", "step 2 loss", "update", "running stats")
    bounds = [MNV2_LOSS_RTOL] + [max(MNV2_SPREAD_FACTOR * s,
                                     MNV2_SPREAD_FLOOR) for s in spread[1:]]
    log(f"[train-zoo] parity at full width, {MNV2} float32 (TF32 off), "
        f"batch {MNV2_CHECK_BATCH}x3x224x224, {MNV2_CHECK_STEPS} SGD steps "
        f"from one set of weights: losses cuda "
        + ", ".join(f"{v:.6f}" for v in gl) + ", cpu "
        + ", ".join(f"{v:.6f}" for v in cl) + ", cpu without oneDNN "
        + ", ".join(f"{v:.6f}" for v in nl))
    log("[train-zoo] relative errors against the CPU: "
        + "; ".join(f"{n} card {c:.3e}, cpu without oneDNN {s:.3e}, bound "
                    f"{b:.3e}" for n, c, s, b in zip(names, card_err, spread,
                                                     bounds))
        + f" ({card})")
    if not all(c <= b for c, b in zip(card_err, bounds)):
        raise AssertionError("[train-zoo] the card disagrees with the CPU")
    t0 = time.time()
    net, loss, tr, x, y = _image_bench(MNV2, MNV2_BATCH, 224)
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    losses = [tr.step(x, y).asscalar() for _ in range(3)]
    log(f"[train-zoo] {MNV2} bf16 {MNV2_BATCH}x3x224x224, SGD {SGD}: "
        f"built and 3 steps in {time.time() - t0:.1f} s; losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    k = 10
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    losses.append(tr.run_steps(k, x, y).asscalar())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / k
    log(f"[train-zoo] run_steps({k}): loss {losses[-1]:.4f}, step "
        f"{step_ms:.2f} ms, {MNV2_BATCH / step_ms * 1e3:.1f} images/s (CUDA "
        f"events over the {k} steps; num_update {tr.num_update}) ({card})")
    dev_ms, launches = log_profile(
        lambda: losses.append(tr.step(x, y).asscalar()),
        f"one {MNV2_BATCH}x3x224x224 training step", tag="[train-zoo]",
        top=15, shares=("cudnn_convolution", "convolution_backward",
                        "conv_depthwise2d", "nchwToNhwc", "nhwcToNchw"))
    log(f"[train-zoo] profiled step: {dev_ms:.2f} ms of device time in "
        f"{launches} launches; against the {step_ms:.2f} ms step of "
        f"run_steps({k}) the device is idle {1 - dev_ms / step_ms:.3f} of "
        f"the step")
    trainer = gluon.Trainer(net.collect_params(), "sgd", SGD)
    for _ in range(2):
        with autograd.record():
            lval = loss(net(x), y)
        lval.backward()
        trainer.step(MNV2_BATCH)
        losses.append(float(lval.asnumpy().mean()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train-zoo] imperative record/backward/gluon.Trainer.step x2: "
        f"mean losses {losses[-2]:.4f}, {losses[-1]:.4f}; peak memory "
        f"{peak:.2f} GiB")
    if any(_all_counts().values()):
        raise AssertionError(f"[train-zoo] launched hand kernels "
                             f"{_all_counts()}: the zoo has none")
    stats = _bn_states(net)
    moved = sum(not torch.equal(v, torch.zeros_like(v) if "mean" in k
                                else torch.ones_like(v))
                for k, v in stats.items())
    if not (np.all(np.isfinite(losses)) and moved == len(stats)):
        raise AssertionError(f"[train-zoo] losses {losses} not finite, or "
                             f"{len(stats) - moved} of {len(stats)} running "
                             f"stats never moved")
    log(f"[train-zoo] losses over {len(losses)} steps: "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; all {len(stats)} running stats moved")
    return step_ms


# -- the rest of training: optimizers, losses, LAMB, sparse rows, checkpoints
OPTIM_SHAPE = (3072, 768)
OPTIM_STEPS = 3
OPTIM_CONFIGS = (
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 1e-3, "wd": 1e-4}),
    ("adagrad", {"learning_rate": 0.1}),
    ("rmsprop", {"learning_rate": 1e-3, "clip_weights": 2.0}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True}),
    ("adadelta", {"rho": 0.9, "wd": 1e-4}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.01}),
    ("signum", {"learning_rate": 1e-3, "wd": 1e-4}),
    ("lamb", {"learning_rate": 1e-3, "wd": 0.01}),
    ("lamb", {"learning_rate": 1e-3, "wd": 0.01, "bias_correction": False}),
    ("dcasgd", {"learning_rate": 0.1}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
)
# bench_bert's table and batch: 30522 x 768 rows, 60 x 128 ids
SPARSE_ROWS, SPARSE_IDS = 30522, TRAIN_BATCH * T
STATE_RTOL = 1e-5           # of the state's largest value, card vs CPU
LOSS_CHECK_RTOL = 1e-5      # of the largest value, card vs CPU
CTC_T, CTC_N, CTC_C, CTC_L = 100, 32, 30, 20
LAMB_PARAMS = {"learning_rate": 1e-3, "wd": 0.01}
LAMB_ITERATIONS = 3
TRUST_RTOL = 1e-3
SPARSE_ADAM = {"learning_rate": 2e-5}


def _bf16_ulps(got, ref):
    """The largest distance of `got` from `ref` in bf16 steps at ref."""
    got, ref = got.double(), ref.double()
    mag = ref.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got - ref).abs() / ulp).max().item()


def _update_ulps(new, ref, old):
    """The largest distance of a bf16 update `new` from its float64
    recompute `ref`, in units of one bf16 ulp at ref, or of float32's
    rounding of `old` (2^-23 |old|, twice) where the update cancels `old`
    to below what that rounding resolves."""
    ref, old = ref.double(), old.double()
    mag = ref.abs().clamp_min(torch.finfo(torch.float32).tiny)
    unit = torch.maximum(torch.exp2(torch.floor(torch.log2(mag)) - 7),
                         2.0 ** -22 * old.abs())
    return ((new.double() - ref).abs() / unit).max().item()


def _state_list(s):
    if s is None:
        return []
    if isinstance(s, tuple):
        return [x for v in s for x in _state_list(v)]
    return [s]


def _card():
    """The card's torch device (gpu(0)'s)."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch.context import as_device
    return as_device(mx.gpu(0))


def _copy_state(st, dev):
    from incubator_mxnet_torch import nd
    if st is None:
        return None
    if isinstance(st, tuple):
        return tuple(_copy_state(x, dev) for x in st)
    return nd.NDArray(st.data.to(dev, copy=True))


def _optim_steps(name, params, w0, grads, dev):
    """OPTIM_STEPS updates on the card; before each, the card's weight
    and states are copied to the CPU and the same update runs there from
    them.  Returns the card's final weight, the largest weight distance
    in bf16 ulps and the largest state errors, each with its bound."""
    from incubator_mxnet_torch import nd, optimizer
    o, o_host = optimizer.create(name, **params), \
        optimizer.create(name, **params)
    w = nd.NDArray(w0.to(dev, copy=True))
    st = o.create_state(0, w)
    ulps, errs = 0.0, []
    for g in grads:
        wh, sh = nd.NDArray(w.data.to("cpu", copy=True)), \
            _copy_state(st, "cpu")
        o_host._index_update_count = dict(o._index_update_count)
        o_host.num_update = o.num_update
        o.update(0, w, nd.NDArray(g.to(dev)), st)
        o_host.update(0, wh, nd.NDArray(g), sh)
        ulps = max(ulps, _bf16_ulps(w.data.cpu(), wh.data))
        step = _state_err([x.data for x in _state_list(st)],
                          [x.data for x in _state_list(sh)])
        errs = [max(a, b) for a, b in zip(errs, step)] if errs else step
    return w.data, ulps, errs


def _state_err(card_states, host_states):
    """The largest card-vs-CPU difference of the states: in bf16 ulps for
    bf16 states (DCASGD's), else as a share of the state's largest value,
    each beside its bound, as (error, bound) pairs."""
    out = []
    for a, b in zip(card_states, host_states):
        a = a.cpu()
        if b.dtype == torch.bfloat16:
            out.append((_bf16_ulps(a, b), 1.0))
        else:
            out.append((((a.double() - b.double()).abs().max()
                         / b.double().abs().max().clamp_min(1e-30)).item(),
                        STATE_RTOL))
    return out


def phase_optim_check(card):
    """Every optimizer on the card against the CPU, then the three lazy
    row updates on bench_bert's table."""
    from incubator_mxnet_torch import nd
    from incubator_mxnet_torch.ndarray import sparse
    gen = torch.Generator().manual_seed(0)
    w0 = (torch.randn(OPTIM_SHAPE, generator=gen) * 0.02).to(torch.bfloat16)
    grads = [torch.randn(OPTIM_SHAPE, generator=gen) * 0.01
             for _ in range(OPTIM_STEPS)]
    cuda, cpu = _card(), torch.device("cpu")
    for name, params in OPTIM_CONFIGS:
        wc, ulps, errs = _optim_steps(name, params, w0, grads, cuda)
        moved = (wc.cpu() != w0).float().mean().item()
        from incubator_mxnet_torch import optimizer
        o = optimizer.create(name, **params)
        w = nd.NDArray(w0.to(cuda, copy=True))
        st = o.create_state(0, w)
        g = nd.NDArray(grads[0].to(cuda))
        ms = time_ms(lambda: o.update(0, w, g, st), iters=10, warmup=1)
        log(f"[optim-check] {name} {params}: {OPTIM_STEPS} updates of bf16 "
            f"{OPTIM_SHAPE[0]}x{OPTIM_SHAPE[1]}, each also run on the CPU "
            f"from the card's values: weight {ulps:.0f} bf16 ulp (bound 1), "
            f"states "
            + (", ".join(f"{e:.2e} (bound {b:g})" for e, b in errs) or "none")
            + f" (bf16 states in ulps, float32 ones as a share of their "
            f"largest); {100 * moved:.1f}% of weights moved; {ms:.3f} ms an "
            f"update on the card ({card})")
        if not (ulps <= 1 and all(e <= b for e, b in errs)):
            raise AssertionError(f"[optim-check] {name} {params}: the card "
                                 f"disagrees with the CPU")
    log(f"[optim-check] (the float32 arithmetic of the two devices may "
        f"round a value across a bf16 boundary, so each update is held "
        f"from the same inputs, where one rounding allows 1 ulp)")
    # the lazy row updates on a bf16 30522 x 768 table, 7680 seeded ids
    ids = torch.randint(0, SPARSE_ROWS, (SPARSE_IDS,), generator=gen)
    uniq = torch.unique(ids)
    table = (torch.randn(SPARSE_ROWS, 768, generator=gen) * 0.02) \
        .to(torch.bfloat16)
    vals = torch.randn(uniq.numel(), 768, generator=gen) * 0.01
    others = torch.ones(SPARSE_ROWS, dtype=torch.bool)
    others[uniq] = False
    shape = (SPARSE_ROWS, 768)

    def update(kind, w, states, g):
        if kind == "sgd":
            sparse.sgd_update_rsp(w, g, 0.1, 1e-4, 1.0 / 60, -1.0)
        elif kind == "sgd_mom":
            sparse.sgd_mom_update_rsp(w, states[0], g, 0.1, 0.9, 1e-4,
                                      1.0 / 60, -1.0)
        else:
            sparse.adam_update_rsp(w, states[0], states[1], g, 2e-5, 0.9,
                                   0.999, 1e-8, 0.0, 1.0 / 60, -1.0)
    for kind in ("sgd", "sgd_mom", "adam"):
        w = nd.NDArray(table.to(cuda, copy=True))
        states = [nd.NDArray(torch.full(shape, 0.25, device=cuda))
                  for _ in range({"sgd": 0, "sgd_mom": 1, "adam": 2}[kind])]
        g = sparse.RowSparseNDArray(vals.to(cuda), (uniq.to(cuda),), shape)
        g_host = sparse.RowSparseNDArray(vals, (uniq,), shape)
        ulps, state_err = 0.0, 0.0
        for _ in range(OPTIM_STEPS):
            wh = nd.NDArray(w.data.to("cpu", copy=True))
            sh = [nd.NDArray(x.data.to("cpu", copy=True)) for x in states]
            update(kind, w, states, g)
            update(kind, wh, sh, g_host)
            ulps = max(ulps, _bf16_ulps(w.data.cpu()[~others],
                                        wh.data[~others]))
            state_err = max([state_err] + [e for e, _ in _state_err(
                [x.data for x in states], [x.data for x in sh])])
        wc, sc = w.data.cpu(), [x.data.cpu() for x in states]
        ms = time_ms(lambda: update(kind, w, states, g), iters=10, warmup=1)
        frozen = torch.equal(wc[others].view(torch.int16),
                             table[others].view(torch.int16)) and all(
            bool((s[others] == 0.25).all()) for s in sc)
        log(f"[optim-check] lazy {kind}_update_rsp: {uniq.numel()} unique of "
            f"{SPARSE_IDS} ids in a bf16 {SPARSE_ROWS}x768 table, "
            f"{OPTIM_STEPS} updates: rows outside the ids bitwise unchanged "
            f"(weights and states): {frozen}; touched rows, each update also "
            f"run on the CPU from the card's values: {ulps:.0f} bf16 ulp "
            f"(bound 1), states {state_err:.2e} (bound {STATE_RTOL:g}); "
            f"{ms:.3f} ms an "
            f"update on the card ({card})")
        if not (frozen and ulps <= 1 and state_err <= STATE_RTOL):
            raise AssertionError(f"[optim-check] lazy {kind} failed")


def _loss_cases(rng):
    """(name, block, inputs, how many take a gradient) of every loss."""
    from incubator_mxnet_torch.gluon import loss as L
    n, d = 64, 32
    r = lambda *s: rng.randn(*s).astype(np.float32)          # noqa: E731
    pm = np.where(rng.rand(n, d) > 0.5, 1.0, -1.0).astype(np.float32)
    prob = rng.dirichlet(np.ones(d), n).astype(np.float32)
    ctc_pred = r(CTC_N, CTC_T, CTC_C)
    ctc_label = rng.randint(0, CTC_C - 1, (CTC_N, CTC_L)).astype(np.float32)
    cut = rng.randint(1, CTC_L + 1, CTC_N)
    for i, c in enumerate(cut):
        ctc_label[i, c:] = -1
    plen = rng.randint(CTC_T // 2, CTC_T + 1, CTC_N).astype(np.float32)
    sw = rng.uniform(0.5, 2, (n, 1)).astype(np.float32)
    return [
        ("L2Loss", L.L2Loss(), [r(n, d), r(n, d), sw], 1),
        ("L1Loss", L.L1Loss(), [r(n, d), r(n, d)], 1),
        ("SoftmaxCrossEntropyLoss", L.SoftmaxCrossEntropyLoss(),
         [r(n, d), rng.randint(0, d, n).astype(np.float32)], 1),
        ("SigmoidBCELoss", L.SigmoidBCELoss(weight=0.5),
         [r(n, d), rng.rand(n, d).astype(np.float32), sw], 1),
        ("KLDivLoss", L.KLDivLoss(from_logits=False), [r(n, d), prob], 1),
        ("HuberLoss", L.HuberLoss(rho=0.7), [r(n, d), r(n, d)], 1),
        ("HingeLoss", L.HingeLoss(), [r(n, d), pm], 1),
        ("SquaredHingeLoss", L.SquaredHingeLoss(), [r(n, d), pm], 1),
        ("LogisticLoss", L.LogisticLoss(), [r(n, d), pm], 1),
        ("CosineEmbeddingLoss", L.CosineEmbeddingLoss(margin=0.2),
         [r(n, d), r(n, d), pm[:, 0].copy()], 2),
        ("TripletLoss", L.TripletLoss(), [r(n, d), r(n, d), r(n, d)], 3),
        ("CTCLoss", L.CTCLoss(), [ctc_pred, ctc_label], 1),
        ("CTCLoss with lengths", L.CTCLoss(),
         [ctc_pred, ctc_label, plen, cut.astype(np.float32)], 1),
        ("PoissonNLLLoss", L.PoissonNLLLoss(compute_full=True),
         [r(n, d), rng.poisson(2.0, (n, d)).astype(np.float32)], 1),
        ("SDMLLoss", L.SDMLLoss(), [r(n, d), r(n, d)], 2),
    ]


def _loss_run(block, inputs, n_grad, ctx):
    from incubator_mxnet_torch import autograd, nd
    xs = [nd.array(a, ctx=ctx) for a in inputs]
    for x in xs[:n_grad]:
        x.attach_grad()
    with autograd.record():
        out = block(*xs)
    out.backward()
    return [out.data] + [x.grad.data for x in xs[:n_grad]]


def phase_loss_check(card):
    """Every loss block, float32, card against CPU; a user
    autograd.Function against torch autograd on the card."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import autograd, nd
    worst = 0.0
    for name, block, inputs, n_grad in _loss_cases(np.random.RandomState(0)):
        card_out = _loss_run(block, inputs, n_grad, mx.gpu(0))
        torch.cuda.synchronize()
        host_out = _loss_run(block, inputs, n_grad, mx.cpu())
        errs = [((a.cpu() - b).abs().max() / b.abs().max().clamp_min(
            1e-30)).item() for a, b in zip(card_out, host_out)]
        finite = all(bool(torch.isfinite(a).all()) for a in card_out)
        worst = max(worst, max(errs))
        log(f"[loss-check] {name}: value {errs[0]:.2e}, input gradients "
            + ", ".join(f"{e:.2e}" for e in errs[1:])
            + f" of their largest (bound {LOSS_CHECK_RTOL:g}); output "
            f"{tuple(card_out[0].shape)}")
        if not (finite and max(errs) <= LOSS_CHECK_RTOL):
            raise AssertionError(f"[loss-check] {name}: the card disagrees "
                                 f"with the CPU")

    class Sigmoid(autograd.Function):
        def forward(self, x):
            y = 1 / (1 + nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)
    a = np.random.RandomState(1).randn(256, 1024).astype(np.float32)
    x = nd.array(a, ctx=mx.gpu(0))
    x.attach_grad()
    with autograd.record():
        out = (Sigmoid()(x) * nd.array(a, ctx=mx.gpu(0))).sum()
    out.backward()
    ref_x = torch.from_numpy(a).to(_card()).requires_grad_()
    (torch.sigmoid(ref_x) * torch.from_numpy(a).to(_card())).sum().backward()
    err = ((x.grad.data - ref_x.grad).abs().max()
           / ref_x.grad.abs().max()).item()
    log(f"[loss-check] autograd.Function (sigmoid) in a recorded graph on "
        f"the card: gradient against torch autograd {err:.2e} of its "
        f"largest (bound {LOSS_CHECK_RTOL:g}); every loss within "
        f"{worst:.2e} ({card})")
    if err > LOSS_CHECK_RTOL:
        raise AssertionError("[loss-check] autograd.Function's gradient "
                             "disagrees with torch autograd")


def _bench_bert(seed=0, sparse_embed=False):
    """bench_bert's classifier (bf16, seeded Normal(0.02), dropout 0) and
    its seeded 60 x 128 batch on cuda:0."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import nd
    from incubator_mxnet_torch.models import get_model
    rng = np.random.RandomState(0)
    batch = [nd.array(a, ctx=mx.gpu(0)) for a in (
        rng.randint(0, 30522, (TRAIN_BATCH, T)).astype(np.float32),
        np.zeros((TRAIN_BATCH, T), np.float32),
        rng.randint(0, 2, TRAIN_BATCH).astype(np.float32))]
    mx.seed(seed)
    net = get_model("bert_classifier", model_name="bert_12_768_12",
                    num_classes=2, dropout=0.0, vocab_size=30522,
                    max_length=T, sparse_embed=sparse_embed)
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    net.cast("bfloat16")
    from incubator_mxnet_torch import autograd
    with autograd.pause(), torch.no_grad():
        net(*batch[:2])                    # the classifier's deferred shape
    return net, batch


def _bert_loss():
    from incubator_mxnet_torch import gluon
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    return lambda out, label: loss_fn(out.astype("float32"), label)


def _checked_launches(run, steps, what, per_step=("flash_short_fwd_train",)):
    """run() with every hand kernel's count read around it: each kernel
    of `per_step` 12 times a step, no other."""
    before = _all_counts()
    out = run()
    torch.cuda.synchronize()
    after = _all_counts()
    got = {n: after[n] - before.get(n, 0) for n in after}
    want = {n: LAYERS * steps if n in per_step else 0 for n in after}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")
    return out


def _lamb_reference(w, g, m, v, t, rescale, o):
    """Phases 1 and 2 in float64 from a step's saved weight, gradient and
    states; ‖w‖ rounded to the weight's dtype, as the rule defines it."""
    w64, g64 = w.double(), g.double() * rescale
    m2 = o.beta1 * m.double() + (1 - o.beta1) * g64
    v2 = o.beta2 * v.double() + (1 - o.beta2) * g64 ** 2
    m_hat, v_hat = m2 / (1 - o.beta1 ** t), v2 / (1 - o.beta2 ** t)
    step = m_hat / (v_hat.sqrt() + o.epsilon) + o.wd * w64
    r1 = w64.norm().to(w.dtype).double()
    ratio = r1 / step.norm()
    return w64 - o.lr * ratio * step, ratio.item()


def phase_train_lamb(card):
    """BERT-base on LAMB through gluon.Trainer's per-key path."""
    from incubator_mxnet_torch import autograd, gluon
    from incubator_mxnet_torch.ops import optim as k
    from incubator_mxnet_torch.ops.math import norm
    t0 = time.time()
    net, batch = _bench_bert()
    loss_of = _bert_loss()
    trainer = gluon.Trainer(net.collect_params(), "lamb", dict(LAMB_PARAMS))
    o = trainer.optimizer
    watched = {"word_embed": net.bert.word_embed.weight,
               "layer0 qkv": net.bert.encoder.layers[0].attention.qkv.weight,
               "classifier": net.classifier[1].weight}
    index = {id(p): i for i, p in enumerate(trainer._params)}
    _reset_all_counts()
    losses, step_ms = [], []
    for it in range(LAMB_ITERATIONS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def iteration():
            start.record()
            with autograd.record():
                l = loss_of(net(*batch[:2]), batch[2])
            l.backward()
            saved = {}
            trainer._ensure_states()
            for name, p in watched.items():
                m, v = trainer._states[index[id(p)]]
                saved[name] = [p.data().data.clone(), p.grad().data.clone(),
                               m.data.clone(), v.data.clone()]
            trainer.step(TRAIN_BATCH)
            end.record()
            return l, saved
        l, saved = _checked_launches(iteration, 1, f"[train-lamb] "
                                     f"iteration {it + 1}")
        step_ms.append(start.elapsed_time(end))
        losses.append(float(l.asnumpy().mean()))
        t = it + 1
        for name, (w, g, m, v) in saved.items():
            new = watched[name].data().data
            ref, ratio64 = _lamb_reference(w, g, m, v, t, 1.0 / TRAIN_BATCH,
                                           o)
            step, _, _ = k.lamb_update_phase1(
                w, g, m, v, beta1=o.beta1, beta2=o.beta2, epsilon=o.epsilon,
                t=t, bias_correction=True, wd=o.wd,
                rescale_grad=1.0 / TRAIN_BATCH)
            r1, r2 = norm(w), norm(step)
            ratio = (r1.float() / r2).item()
            again = k.lamb_update_phase2(w, step, r1, r2, lr=o.lr)
            ulps = _update_ulps(new, ref, w)
            trust_err = abs(ratio - ratio64) / ratio64
            same = torch.equal(again.view(torch.int16),
                               new.view(torch.int16))
            log(f"[train-lamb] iteration {t} {name} {tuple(w.shape)}: trust "
                f"ratio {ratio:.6g} vs float64 {ratio64:.6g} ({trust_err:.1e},"
                f" bound {TRUST_RTOL:g}); update vs float64 recompute "
                f"{ulps:.2f} bf16 ulp (bound 1; where the update cancels "
                f"the weight, float32's rounding of it); phases 1 and 2 "
                f"again from "
                f"the saved values give the same bits: {same}")
            if not (trust_err <= TRUST_RTOL and ulps <= 1 and same):
                raise AssertionError(f"[train-lamb] {name}: the LAMB update "
                                     f"disagrees with its float64 recompute")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[train-lamb] losses {losses} not finite")
    log(f"[train-lamb] BERT-base bf16 {TRAIN_BATCH}x{T}, gluon.Trainer lamb "
        f"{LAMB_PARAMS}, built in {time.time() - t0:.1f} s: losses "
        + ", ".join(f"{v:.4f}" for v in losses) + "; iteration ms "
        + ", ".join(f"{v:.2f}" for v in step_ms) + f" (CUDA events, "
        f"record/backward/step); {LAYERS} flash_short_fwd_train launches an "
        f"iteration, no other hand kernel ({card})")

    def one():
        with autograd.record():
            l = loss_of(net(*batch[:2]), batch[2])
        l.backward()
        trainer.step(TRAIN_BATCH)
    dev_ms, launches = log_profile(
        lambda: _checked_launches(one, 1, "[train-lamb] profiled iteration"),
        "one LAMB iteration", tag="[train-lamb]", top=8)
    log(f"[train-lamb] profiled iteration: {dev_ms:.2f} ms of device time, "
        f"{launches} launches; idle share over the last timed iteration "
        f"{max(0.0, 1 - dev_ms / step_ms[-1]):.2f} ({card})")
    counts = _all_counts()
    del net, trainer
    torch.cuda.empty_cache()
    return counts["flash_short_fwd_train"], step_ms[-1]


def _copy_weights(src, dst):
    for k, p in dst._collect_params_with_prefix().items():
        p.set_data(src._collect_params_with_prefix()[k].data())


def _bits_equal(a, b):
    a, b = a.detach(), b.detach()
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def phase_train_sparse(card):
    """bench_bert with the sparse word embedding: ParallelTrainer's lazy
    row update against a dense twin, then gluon.Trainer's row-sparse
    gradient.  Returns the lazy trainer, its batch, the launches and the
    step times."""
    from incubator_mxnet_torch import autograd, gluon, parallel
    from incubator_mxnet_torch.ndarray.sparse import RowSparseNDArray
    t0 = time.time()
    net, batch = _bench_bert(sparse_embed=True)
    twin, _ = _bench_bert(sparse_embed=False)
    _copy_weights(net, twin)
    loss_of = _bert_loss()

    def trainer(block):
        return parallel.ParallelTrainer(block, loss_of, optimizer="adam",
                                        optimizer_params=dict(SPARSE_ADAM),
                                        mesh=parallel.default_mesh(1))
    tr, tr_twin = trainer(net), trainer(twin)
    emb = net.bert.word_embed.weight
    table0 = emb.data().data.clone()
    ids = torch.unique(batch[0].data.long())
    absent = torch.ones(table0.shape[0], dtype=torch.bool,
                        device=table0.device)
    absent[ids] = False
    _reset_all_counts()
    l1 = _checked_launches(lambda: tr.step(*batch).asscalar(), 1,
                           "[train-sparse] step 1")
    lt = _checked_launches(lambda: tr_twin.step(*batch).asscalar(), 1,
                           "[train-sparse] dense twin step 1")
    lazy = list(tr.lazy_params)
    log(f"[train-sparse] BERT-base bf16 {TRAIN_BATCH}x{T} sparse_embed=True, "
        f"ParallelTrainer adam {SPARSE_ADAM}, built in {time.time() - t0:.1f}"
        f" s; update of the word embedding: "
        f"{'lazy' if emb.name in lazy else 'dense'} ({ids.numel()} unique of "
        f"{batch[0].size} ids, {table0.shape[0]} rows); step-1 loss "
        f"{l1:.6f}, dense twin {lt:.6f}")
    if lazy != [emb.name]:
        raise AssertionError(f"[train-sparse] lazy tables {lazy}, expected "
                             f"[{emb.name}]")
    new, twin_new = emb.data().data, twin.bert.word_embed.weight.data().data
    ulps = _bf16_ulps(new[ids].float(), twin_new[ids].float())
    mine = dict(net._collect_params_with_prefix())
    others = [k for k, p in twin._collect_params_with_prefix().items()
              if p is not twin.bert.word_embed.weight
              and not _bits_equal(mine[k].data().data, p.data().data)]
    log(f"[train-sparse] after step 1: touched rows vs the dense twin "
        f"{ulps:.0f} bf16 ulp (bound 1); untouched rows equal too: "
        f"{_bits_equal(new[absent], twin_new[absent])}; other parameters "
        f"not bitwise equal to the twin's: {others or 'none'}")
    if ulps > 1 or others:
        raise AssertionError("[train-sparse] the lazy step disagrees with "
                             "the dense twin")
    losses = [l1] + [_checked_launches(lambda: tr.step(*batch).asscalar(), 1,
                                       f"[train-sparse] step {i}")
                     for i in (2, 3)]
    # run_steps(5) of each in the order lazy, twin, twin, lazy (the host
    # sets these walls and drifts), then each one's device time a step
    times = {"lazy": [], "dense twin": []}
    for name in ("lazy", "dense twin", "dense twin", "lazy"):
        t = tr if name == "lazy" else tr_twin
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        last = _checked_launches(lambda: t.run_steps(5, *batch).asscalar(),
                                 5, f"[train-sparse] {name} run_steps(5)")
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / 5)
        if name == "lazy" and len(times[name]) == 1:
            losses.append(last)
    dev = {name: _checked_launches(
        lambda: device_ms(lambda: t.step(*batch), iters=4), 5,
        f"[train-sparse] {name} device time")
        for name, t in (("lazy", tr), ("dense twin", tr_twin))}
    j = tr._wrt.index(tr.params.index(emb))
    m, v = tr._states[j]
    frozen = _bits_equal(emb.data().data[absent], table0[absent]) and \
        bool((m[absent] == 0).all()) and bool((v[absent] == 0).all())
    log(f"[train-sparse] after 3 steps and run_steps(5): losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f"; rows the batch lacks "
        f"kept weights and both Adam moments bitwise after "
        f"{tr.num_update} steps: {frozen}")
    if not (frozen and all(np.isfinite(losses))):
        raise AssertionError("[train-sparse] absent rows moved or a loss "
                             "is not finite")
    walls = {n: sum(v) / len(v) for n, v in times.items()}
    log(f"[train-sparse] step over run_steps(5), CUDA events, in the order "
        f"lazy, twin, twin, lazy: lazy "
        + ", ".join(f"{x:.2f}" for x in times["lazy"]) + " ms, dense twin "
        + ", ".join(f"{x:.2f}" for x in times["dense twin"])
        + f" ms; device time a step (profiler, 4 steps): lazy "
        f"{dev['lazy']:.3f} ms, dense twin {dev['dense twin']:.3f} ms "
        f"({dev['lazy'] - dev['dense twin']:+.3f} ms, "
        f"{100 * (dev['lazy'] / dev['dense twin'] - 1):+.2f}%) ({card})")
    dev_ms, launches = log_profile(
        lambda: _checked_launches(lambda: tr.step(*batch), 1,
                                  "[train-sparse] profiled step"),
        "one lazy step", tag="[train-sparse]", top=8)
    idle = max(0.0, 1 - dev_ms / walls["lazy"])
    log(f"[train-sparse] profiled step: {dev_ms:.2f} ms of device time, "
        f"{launches} launches; idle share against the mean lazy wall "
        f"{idle:.2f} ({card})")
    del tr_twin, twin
    torch.cuda.empty_cache()

    # the imperative loop: a row-sparse gradient of the batch's ids
    imp = gluon.Trainer(net.collect_params(), "adam", dict(SPARSE_ADAM))
    for i in range(2):
        def iteration():
            with autograd.record():
                l = loss_of(net(*batch[:2]), batch[2])
            l.backward()
            g = emb.grad()
            imp.step(TRAIN_BATCH)
            return float(l.asnumpy().mean()), g
        lval, g = _checked_launches(iteration, 1, f"[train-sparse] imperative "
                                    f"iteration {i + 1}")
        sparse_ok = isinstance(g, RowSparseNDArray) and torch.equal(
            g.indices.data, ids)
        log(f"[train-sparse] imperative gluon.Trainer adam iteration {i + 1}: "
            f"mean loss {lval:.4f}; word embedding gradient "
            f"{type(g).__name__} of {g.indices.size} rows, the batch's "
            f"sorted unique ids: {sparse_ok}")
        if not (sparse_ok and np.isfinite(lval)):
            raise AssertionError("[train-sparse] the imperative gradient is "
                                 "not the batch's row-sparse one")
    return tr, batch, _all_counts()["flash_short_fwd_train"], walls


def phase_checkpoint(card, tr, batch):
    """[train-sparse]'s trainer saved, restored into a model built from
    another seed, and one more step on each: the same bits."""
    from incubator_mxnet_torch import parallel
    _reset_all_counts()
    net2, _ = _bench_bert(seed=1, sparse_embed=True)
    tr2 = parallel.ParallelTrainer(net2, _bert_loss(), optimizer="adam",
                                   optimizer_params=dict(SPARSE_ADAM),
                                   mesh=parallel.default_mesh(1))
    pb, sb = tr.param_bytes(), tr.optimizer_state_bytes()
    n_params = sum(p.data().size for p in tr.params)
    want_p = sum(p.data().data.numel() * p.data().data.element_size()
                 for p in tr.params)
    want_s = sum(x.numel() * x.element_size() for s in tr._states for x in s)
    log(f"[checkpoint] param_bytes {pb}, optimizer_state_bytes {sb} for "
        f"{n_params} parameters (sums over the tensors: {want_p}, {want_s})")
    if pb != (want_p, want_p) or sb != (want_s, want_s) or \
            want_p != 2 * n_params or want_s != 8 * n_params:
        raise AssertionError("[checkpoint] byte reports disagree with the "
                             "tensors")
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        tr.save_checkpoint(directory)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(directory, f))
                   for f in os.listdir(directory))
        t0 = time.perf_counter()
        tr2.load_checkpoint(directory)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    la = _checked_launches(lambda: tr.step(*batch).asscalar(), 1,
                           "[checkpoint] step of the saved trainer")
    lb = _checked_launches(lambda: tr2.step(*batch).asscalar(), 1,
                           "[checkpoint] step of the restored trainer")
    same = la == lb and tr.num_update == tr2.num_update and all(
        _bits_equal(a.data().data, b.data().data)
        for a, b in zip(tr.params, tr2.params))
    log(f"[checkpoint] saved {size / 1e6:.1f} MB in {save_s:.2f} s, restored "
        f"into a model from another seed in {load_s:.2f} s; one more step on "
        f"each: losses {la:.6f} and {lb:.6f}, num_update {tr.num_update}; "
        f"losses and every weight bitwise equal: {same} ({card})")
    if not same:
        raise AssertionError("[checkpoint] the restored trainer's step "
                             "differs")
    return _all_counts()["flash_short_fwd_train"]



# ---------------------------------------------------------------------
# [interleaved-attn]: BERT-base self-attention through GluonNLP's ops
# ---------------------------------------------------------------------
IA_UNITS = HEADS * D            # 768
# bf16 tolerance of the interleaved route against the kernel route, as a
# share of the reference's largest value: the interleaved route rounds
# the scores and the probabilities to bf16 before the value product,
# the kernel keeps them in float32 (2^-8 relative each, over 128 keys)
IA_RTOL = 2e-2
IA_MIN_COS = 0.999


def _ia_inputs(dev):
    """A seeded hidden state (T, N, 768), per layer a seeded fused
    projection (2304, 768) and bias (Normal(0.02), bf16), valid lengths
    in [1, T] with 1 and T among them, and a cotangent per layer."""
    g = torch.Generator().manual_seed(0)

    def normal(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(torch.bfloat16) \
            .to(dev)
    h = normal(T, TRAIN_BATCH, IA_UNITS)
    ws = [normal(3 * IA_UNITS, IA_UNITS, std=0.02) for _ in range(LAYERS)]
    bs = [normal(3 * IA_UNITS, std=0.02) for _ in range(LAYERS)]
    valid = torch.randint(1, T + 1, (TRAIN_BATCH,), generator=g)
    valid[0], valid[1] = T, 1
    cots = [normal(T, TRAIN_BATCH, IA_UNITS) for _ in range(LAYERS)]
    return h, ws, bs, valid.to(torch.int32).to(dev), cots


def _ia_run(route, inputs, train):
    """The 12 layers' attention from one hidden state on `route`
    ("interleaved": qk, softmax with lengths, valatt; "mha":
    `multi_head_attention` on q, k, v cut from the same projection),
    outputs (T, N, 768) each; with `train`, inside `record()` and a
    backward of the cotangents: (outputs, [dh, dW_0.., db_0..])."""
    from incubator_mxnet_torch import autograd, nd
    from incubator_mxnet_torch.ndarray import NDArray
    h, ws, bs, valid, cots = inputs
    h, ws, bs = NDArray(h), [NDArray(w) for w in ws], [NDArray(b) for b in bs]
    leaves = [h] + ws + bs
    if train:
        for x in leaves:
            x.attach_grad()
    rows = NDArray(valid.repeat_interleave(HEADS).unsqueeze(1).expand(
        -1, T))
    kv = NDArray(valid)
    N, E = TRAIN_BATCH, IA_UNITS
    outs = []
    with autograd.record() if train else contextlib.nullcontext():
        for w, b in zip(ws, bs):
            qkv = nd.FullyConnected(h, w, b, num_hidden=3 * E, flatten=False)
            if route == "interleaved":
                att = nd.contrib.interleaved_matmul_selfatt_qk(qkv,
                                                              heads=HEADS)
                att = nd.softmax(att, rows, axis=-1, use_length=True)
                o = nd.contrib.interleaved_matmul_selfatt_valatt(
                    qkv, att, heads=HEADS)
            else:
                x = qkv.reshape((T, N, HEADS, 3, D))
                q, k, v = (x[:, :, :, i].transpose((1, 0, 2, 3))
                           .reshape((N, T, E)) for i in range(3))
                o = nd.multi_head_attention(q, k, v, kv_length=kv,
                                            num_heads=HEADS) \
                    .transpose((1, 0, 2))
            outs.append(o)
    if not train:
        return [o.data for o in outs], None
    autograd.backward(outs, [NDArray(c) for c in cots])
    return [o.data.detach() for o in outs], [x.grad.data for x in leaves]


def _rel_cos(got, ref):
    """(largest error as a share of ref's largest value, cosine)."""
    got, ref = got.double(), ref.double()
    rel = ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
    return rel, _cos(got, ref)


def phase_interleaved_attn(card):
    """BERT-base self-attention at 60 x 128, bf16, through the four-op
    interleaved route against `multi_head_attention` (rows 1 and 1b):
    outputs and gradients, each route's times.  Returns the kernel
    counts of the checked passes."""
    inputs = _ia_inputs(_card())
    _reset_all_counts()
    ref_fwd, _ = _ia_run("mha", inputs, False)
    fwd_counts = dict(_all_counts())
    ref_out, ref_grads = _ia_run("mha", inputs, True)
    counts = dict(_all_counts())
    torch.cuda.synchronize()
    got_fwd, _ = _ia_run("interleaved", inputs, False)
    got_out, got_grads = _ia_run("interleaved", inputs, True)
    after = _all_counts()
    train_counts = {k: counts[k] - fwd_counts[k] for k in counts}
    names = [f"layer {i} output" for i in range(LAYERS)] + \
        [f"layer {i} output (recorded)" for i in range(LAYERS)] + \
        ["dh"] + [f"dW layer {i}" for i in range(LAYERS)] + \
        [f"db layer {i}" for i in range(LAYERS)]
    errs = [_rel_cos(g, r) for g, r in zip(got_fwd + got_out + got_grads,
                                           ref_fwd + ref_out + ref_grads)]
    worst_rel = max(e[0] for e in errs)
    worst_cos = min(e[1] for e in errs)
    bad = [f"{n}: {e[0]:.2e} cos {e[1]:.6f}" for n, e in zip(names, errs)
           if e[0] > IA_RTOL or e[1] < IA_MIN_COS]
    log(f"[interleaved-attn] bert_12_768_12 self-attention, bf16, "
        f"(T, N, 3E) = ({T}, {TRAIN_BATCH}, {3 * IA_UNITS}), {LAYERS} "
        f"layers, valid lengths {int(inputs[3].min())}..{int(inputs[3].max())}"
        f": interleaved route against multi_head_attention, largest error "
        f"{worst_rel:.2e} of the largest value (bound {IA_RTOL:g}), least "
        f"cosine {worst_cos:.6f} (bound {IA_MIN_COS}) over {LAYERS} outputs,"
        f" {LAYERS} recorded outputs, dh and each layer's dW, db")
    log(f"[interleaved-attn] worst: " + "; ".join(
        f"{n} {e[0]:.2e}" for n, e in sorted(zip(names, errs),
                                               key=lambda t: -t[1][0])[:3]))
    if bad:
        raise AssertionError("[interleaved-attn] the routes disagree: "
                             + "; ".join(bad))
    want_fwd = {"flash_short_fwd": LAYERS}
    want_train = {"flash_short_fwd_train": LAYERS}
    for label, got, want in (("inference", fwd_counts, want_fwd),
                             ("training", train_counts, want_train)):
        extra = {k: v for k, v in got.items() if v != want.get(k, 0)}
        log(f"[interleaved-attn] multi_head_attention {label} pass: "
            f"launches {({k: v for k, v in got.items() if v})}")
        if extra:
            raise AssertionError(f"[interleaved-attn] {label} launches "
                                 f"{extra}, expected {want}")
    if any(after[k] != counts[k] for k in after):
        raise AssertionError("[interleaved-attn] the interleaved route "
                             "launched a hand kernel")
    _reset_all_counts()
    for route in ("mha", "interleaved"):
        fwd_ms = time_ms(lambda: _ia_run(route, inputs, False), iters=5,
                         warmup=1)
        fwd_dev = device_ms(lambda: _ia_run(route, inputs, False), iters=3)
        step_ms = time_ms(lambda: _ia_run(route, inputs, True), iters=3,
                          warmup=1)
        step_dev = device_ms(lambda: _ia_run(route, inputs, True), iters=2)
        log(f"[interleaved-attn] {route:11s} route, 12 layers with their "
            f"projections: forward {fwd_ms:.3f} ms (device {fwd_dev:.3f} "
            f"ms), forward + backward {step_ms:.3f} ms (device "
            f"{step_dev:.3f} ms) ({card})")
        log_profile(lambda: _ia_run(route, inputs, True),
                    f"{route} route, one forward + backward",
                    tag="[interleaved-attn]", top=6)
    _reset_all_counts()
    del inputs
    torch.cuda.empty_cache()
    return fwd_counts["flash_short_fwd"], \
        train_counts["flash_short_fwd_train"]


# ---------------------------------------------------------------------
# [ops-check]: the core op registry, card against CPU
# ---------------------------------------------------------------------
# float32 card against CPU, as a share of the reference's largest value:
# CUDA's and the CPU's libm differ by a few ulps on the transcendental
# ops and reductions sum in another order (TF32 off)
OPS_RTOL = 1e-5
RANDOM_DRAWS = 1_000_000
RANDOM_SIGMAS = 5.0


def _ops_run(name, arrays, attrs, dev, dtype=None, grad=False, seed=3):
    """Forward of op `name` on `dev` (float32 inputs cast to `dtype`),
    and with `grad` the gradients of its float inputs for seeded
    cotangents (None where no output takes one)."""
    from incubator_mxnet_torch import autograd
    from incubator_mxnet_torch.ndarray import NDArray
    from incubator_mxnet_torch.ops.registry import apply_op
    xs = []
    for a in arrays:
        t = torch.from_numpy(a).to(dev)
        if dtype is not None and t.dtype == torch.float32:
            t = t.to(dtype)
        xs.append(NDArray(t))
    floats = [x for x in xs if x.data.is_floating_point()]
    if grad:
        for x in floats:
            x.attach_grad()
    with autograd.record(train_mode=False) if grad \
            else contextlib.nullcontext():
        out = apply_op(name, *xs, **attrs)
    outs = list(out) if isinstance(out, tuple) else [out]
    if not grad:
        return [o.data for o in outs], None
    heads = [o for o in outs if o.data.requires_grad]
    if not heads:
        return [o.data for o in outs], None
    g = torch.Generator().manual_seed(seed)
    cots = [NDArray(torch.randn(o.shape, generator=g).to(o.data.dtype)
                    .to(dev)) for o in heads]
    autograd.backward(heads, cots)
    return [o.data.detach() for o in outs], [x.grad.data for x in floats]


def _ops_err(got, ref):
    got, ref = got.cpu(), ref.cpu()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return float("inf")
    if not ref.is_floating_point():
        return 0.0 if torch.equal(got, ref) else float("inf")
    got, ref = got.double(), ref.double()
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    scale = ref[fin].abs().max().item() if fin.any() else 0.0
    return (got[fin] - ref[fin]).abs().max().item() / max(scale, 1e-30) \
        if fin.any() else 0.0


# the outputs of the sweeps and matchings that must be equal card against
# CPU: the kept rows, the matches, the targets' masks and classes
EXACT_PARTS = {
    "_contrib_MultiBoxDetection": lambda o: [o[0][..., 0]],
    "box_nms": lambda o: [o[0][..., 1] < 0],
    "_contrib_bipartite_matching": lambda o: list(o),
    "_contrib_MultiBoxTarget": lambda o: [o[1], o[2]],
    "_contrib_boolean_mask": lambda o: list(o),
}
# factorizations, fixed up to the signs of Q's or U's rows: checked by
# their invariants, their gradients with the cotangents turned to the
# card's signs
DECOMPOSITIONS = ("linalg_gelqf", "linalg_syevd")


def _ops_names(card, dev, names, what):
    """Every op of `names` on the card against the CPU: forward and
    gradients in float32 (the sweeps' kept sets exactly), the
    factorizations by their invariants, and the bfloat16 forward
    finite (where the sweep runs the op in bfloat16)."""
    from incubator_mxnet_torch.tools import op_cases
    worst, bad, n_grad = {}, [], 0
    for name in names:
        canon = op_cases.canonical_name(name)
        arrays, attrs = op_cases.build_case(name)
        try:
            if canon in DECOMPOSITIONS:
                worst[name] = _ops_decomposition(name, arrays, dev)
                n_grad += 1
                continue
            host, host_g = _ops_run(name, arrays, attrs, "cpu", grad=True)
            got, got_g = _ops_run(name, arrays, attrs, dev, grad=True)
            low = [] if canon in op_cases.BF16_SKIP else \
                _ops_run(name, arrays, attrs, dev, torch.bfloat16)[0]
        except Exception as e:           # noqa: BLE001 - listed, then raised
            bad.append(f"{name}: {type(e).__name__}: {e}")
            continue
        errs = [_ops_err(g, h) for g, h in zip(got, host)]
        if host_g is not None:
            n_grad += 1
            errs += [_ops_err(g, h) for g, h in zip(got_g or [], host_g)]
        if canon in EXACT_PARTS:
            same = all(torch.equal(g.cpu(), h) for g, h in zip(
                EXACT_PARTS[canon](got), EXACT_PARTS[canon](host)))
            errs.append(0.0 if same else float("inf"))
        worst[name] = max(errs)
        finite = all(bool(torch.isfinite(o.float()).all()) for o in low
                     if o.is_floating_point())
        if worst[name] > OPS_RTOL or not finite:
            bad.append(f"{name}: error {worst[name]:.2e}, bf16 finite "
                       f"{finite}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    log(f"[ops-check] {len(names)} {what} op names on the card against "
        f"the CPU in float32 (TF32 off), {n_grad} with gradients: largest "
        f"error {max(worst.values(), default=0):.2e} of the largest value "
        f"(bound {OPS_RTOL:g}), worst "
        + ", ".join(f"{n} {e:.1e}" for n, e in top)
        + f"; bf16 forwards finite ({card})")
    return bad


def _ops_decomposition(name, arrays, dev):
    """gelqf's A = L·Q and Q·Qᵀ = I, or syevd's Uᵀ·diag(Λ)·U = A and
    U·Uᵀ = I, on the card; |⟨row_card, row_cpu⟩| = 1 for Q's or U's
    rows and L or Λ against the CPU; then the gradient of A for seeded
    cotangents turned by the rows' signs, against the CPU's.  The
    largest error as a share of its scale."""
    from incubator_mxnet_torch import autograd
    from incubator_mxnet_torch.ndarray import NDArray
    from incubator_mxnet_torch.ops.registry import apply_op
    a = torch.from_numpy(arrays[0])
    runs = {}
    for where in ("cpu", dev):
        x = NDArray(a.to(where))
        x.attach_grad()
        with autograd.record():
            out = apply_op(name, x)
        runs[where] = (x, out)
    (hx, (h0, h1)), (cx, (c0, c1)) = runs["cpu"], runs[dev]
    gel = "gelqf" in name
    rows = (h1 if gel else h0).data, (c1 if gel else c0).data.cpu()
    sign = torch.sign((rows[0] * rows[1]).sum(-1))                # (..., m)
    eye = torch.eye(rows[1].shape[-2], dtype=torch.float64)
    q = rows[1].double()
    scale = a.abs().max().item()
    if gel:
        L = c0.data.cpu().double()
        errs = [(L @ q - a.double()).abs().max().item() / scale,
                (L * sign[..., None, :] - h0.data.double()).abs().max()
                .item() / scale]
    else:
        lam = c1.data.cpu().double()
        rec = q.transpose(-1, -2) @ (lam[..., :, None] * q)
        errs = [(rec - a.double()).abs().max().item() / scale,
                (lam - h1.data.double()).abs().max().item() / scale]
    errs += [(q @ q.transpose(-1, -2) - eye).abs().max().item(),
             ((rows[0] * rows[1]).sum(-1).abs() - 1).abs().max().item()]
    g = torch.Generator().manual_seed(3)
    cts = [torch.randn(o.shape, generator=g) for o in (h0, h1)]
    autograd.backward([h0, h1], [NDArray(c) for c in cts])
    turned = ([cts[0] * sign[..., None, :], cts[1] * sign[..., :, None]]
              if gel else [cts[0] * sign[..., :, None], cts[1]])
    autograd.backward([c0, c1], [NDArray(c.to(dev)) for c in turned])
    errs.append(_ops_err(cx.grad.data, hx.grad.data))
    return max(errs)


# the Criteo display-ads CSR input: 13 numeric and 26 categorical fields
# a row, hashed into 2^20 features, times a 64-wide float32 weight
CSR_ROWS, CSR_FEATURES, CSR_NNZ_ROW, CSR_WIDTH = 8192, 1 << 20, 39, 64


def _ops_csr(card, dev):
    """`nd.sparse.dot` of a Criteo-sized CSR batch and a dense weight,
    with and without `transpose_a`, card against CPU, and its times."""
    from incubator_mxnet_torch import nd
    from incubator_mxnet_torch.context import Context
    rng = np.random.RandomState(11)
    cols = np.sort(rng.randint(0, CSR_FEATURES, (CSR_ROWS, CSR_NNZ_ROW)),
                   axis=1).reshape(-1)
    vals = np.ones((CSR_ROWS, CSR_NNZ_ROW), np.float32)
    vals[:, :13] = rng.lognormal(0.0, 1.0, (CSR_ROWS, 13))
    indptr = np.arange(0, CSR_ROWS * CSR_NNZ_ROW + 1, CSR_NNZ_ROW)
    w = rng.randn(CSR_FEATURES, CSR_WIDTH).astype(np.float32) * 0.01
    g = rng.randn(CSR_ROWS, CSR_WIDTH).astype(np.float32)
    shape = (CSR_ROWS, CSR_FEATURES)
    bad, lines = [], []
    for transpose_a, rhs in ((False, w), (True, g)):
        res = {}
        for where in ("cpu", dev):
            ctx = Context.from_device(torch.device(where))
            x = nd.sparse.csr_matrix((vals.reshape(-1), cols, indptr),
                                     shape=shape, ctx=ctx)
            r = nd.array(rhs, ctx=ctx)
            res[where] = (nd.sparse.dot(x, r, transpose_a=transpose_a),
                          x, r)
        err = _ops_err(res[dev][0].data, res["cpu"][0].data)
        x, r = res[dev][1], res[dev][2]
        ms = time_ms(lambda: nd.sparse.dot(x, r, transpose_a=transpose_a))
        lines.append(f"transpose_a={transpose_a}: error {err:.1e}, "
                     f"{ms:.3f} ms")
        if err > OPS_RTOL:
            bad.append(f"csr dot transpose_a={transpose_a}: error {err:.2e}")
    log(f"[ops-check] CSR dot at {CSR_ROWS} x {CSR_FEATURES} with "
        f"{CSR_NNZ_ROW} entries a row, times a {CSR_WIDTH}-wide float32 "
        f"weight, card against CPU: " + "; ".join(lines) + f" ({card})")
    return bad


def _ops_repairs16(dev):
    """The device-side cases of the nine port repairs, on the card: a
    scalar second operand, out-of-range reads and writes, saturating
    casts, integer % 0 and Embedding of integer weights."""
    from incubator_mxnet_torch import nd
    from incubator_mxnet_torch.context import Context
    ctx = Context.from_device(dev)
    bad = []
    x0 = np.array([[1, 5, 2], [7, 3, 9]], np.int32)
    x = nd.array(x0, ctx=ctx, dtype="int32")
    checks = {
        "maximum(x, 4)": np.array_equal(nd.maximum(x, 4).asnumpy(),
                                        np.maximum(x0, 4)),
        "x[5] reads the last row": np.array_equal(x[5].asnumpy(), x0[1]),
        "uint8 cast saturates": nd.array(
            np.array([300.0, -1.0, np.nan], np.float32), ctx=ctx)
        .astype("uint8").asnumpy().tolist() == [255, 0, 0],
        "int32 % 0 is 0": not (x % 0).asnumpy().any(),
        "int Embedding fills": nd.Embedding(
            nd.array(np.array([1, 9]), ctx=ctx, dtype="int32"), x,
            input_dim=2, output_dim=3).asnumpy()[1].tolist()
        == [np.iinfo(np.int32).min] * 3,
    }
    y = nd.array(x0, ctx=ctx, dtype="int32")
    y[[0, 7]] = 0
    checks["x[[0, 7]] = 0 drops row 7"] = np.array_equal(
        y.asnumpy(), np.stack([np.zeros(3, np.int32), x0[1]]))
    bad = [f"repair: {k}" for k, ok in checks.items() if not ok]
    log(f"[ops-check] the port repairs' device-side cases on the card: "
        f"{len(checks) - len(bad)} of {len(checks)} hold")
    return bad


def _ops_random(dev):
    """Each sampler's mean and variance at 10^6 draws within 5 standard
    errors of the distribution's; the same seed twice gives the same
    stream."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import nd
    from incubator_mxnet_torch.context import Context
    ctx = Context.from_device(dev)
    n = RANDOM_DRAWS
    p = np.array([0.1, 0.6, 0.3], np.float32)
    cases = {
        "uniform": (lambda: nd.random.uniform(-1.0, 3.0, shape=(n,),
                                              ctx=ctx), 1.0, 16 / 12),
        "normal": (lambda: nd.random.normal(0.5, 2.0, shape=(n,), ctx=ctx),
                   0.5, 4.0),
        "gamma": (lambda: nd.random.gamma(2.5, 1.5, shape=(n,), ctx=ctx),
                  3.75, 2.5 * 1.5 ** 2),
        "exponential": (lambda: nd.random.exponential(4.0, shape=(n,),
                                                      ctx=ctx),
                        0.25, 0.0625),
        "poisson": (lambda: nd.random.poisson(3.0, shape=(n,), ctx=ctx),
                    3.0, 3.0),
        "randint": (lambda: nd.random.randint(2, 9, shape=(n,), ctx=ctx),
                    5.0, 4.0),
        "bernoulli": (lambda: nd.random.bernoulli(0.3, shape=(n,), ctx=ctx),
                      0.3, 0.21),
        "multinomial": (lambda: nd.random.multinomial(
            nd.array(p, ctx=ctx), shape=(n,)), 1.2, 0.36),
    }
    bad, lines = [], []
    for name, (draw, mean, var) in cases.items():
        mx.random.seed(17)
        x = draw().data.double()
        mx.random.seed(17)
        again = draw().data.double()
        m = x.mean().item()
        c = x - m
        s2 = (c * c).mean().item()
        se_m = math.sqrt(var / n)
        se_v = math.sqrt(max((c ** 4).mean().item() - s2 * s2, 0.0) / n)
        zm, zv = abs(m - mean) / se_m, abs(s2 - var) / se_v
        same = torch.equal(x, again)
        lines.append(f"{name} {zm:.1f}/{zv:.1f}")
        if zm > RANDOM_SIGMAS or zv > RANDOM_SIGMAS or not same:
            bad.append(f"random {name}: mean {m:.5f} ({zm:.1f} se), "
                       f"variance {s2:.5f} ({zv:.1f} se), same stream "
                       f"{same}")
    mx.random.seed(5)
    rows = nd.random.shuffle(nd.arange(1000, ctx=ctx)).data.cpu()
    if not torch.equal(rows.sort().values, torch.arange(1000.0)) or \
            torch.equal(rows, torch.arange(1000.0)):
        bad.append("random shuffle: not a permutation, or the identity")
    log(f"[ops-check] random ops at {n} draws on the card, |mean - "
        f"expected| / se and |variance - expected| / se (bound "
        f"{RANDOM_SIGMAS:g}): " + ", ".join(lines) + "; each seed's "
        "stream repeats; shuffle is a permutation")
    return bad


def _ops_repairs(dev):
    """The slice's six NDArray repairs, on the card."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import autograd, nd
    from incubator_mxnet_torch.context import Context
    ctx = Context.from_device(dev)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    bad = []

    def check(what, ok):
        if not ok:
            bad.append(f"repair: {what}")
    a = nd.array(x, ctx=ctx)
    b = a[0]
    b[:] = 9
    c = a.reshape((3, 2))
    a += 1
    check("a view's write leaves its base, a base's write its view",
          np.array_equal(a.asnumpy(), x + 1)
          and np.array_equal(b.asnumpy(), np.full(3, 9))
          and np.array_equal(c.asnumpy(), x.reshape(3, 2)))
    try:
        with autograd.record():
            a[0] = 1
        check("setitem inside record() raises", False)
    except mx.MXNetError:
        pass
    i = nd.array(np.arange(3), ctx=ctx)
    check("nd.array of int64 is int32", i.dtype == np.int32)
    s = nd.softmax(i)
    e = np.exp(np.arange(3) - 2.0)
    check("softmax of int32 is float32", s.dtype == np.float32 and np.allclose(
        s.asnumpy(), e / e.sum(), rtol=1e-6))
    m = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4), ctx=ctx)
    ref = np.arange(12, dtype=np.float32).reshape(3, 4)
    rows, cols = np.array([2, 0]), np.array([1, 3])
    got = m[::-1, ::-2].asnumpy()
    pick = m[nd.array(rows, ctx=ctx), nd.array(cols, ctx=ctx)].asnumpy()
    m[::-1, 1] = 7
    ref2 = ref.copy()
    ref2[::-1, 1] = 7
    check("indexing: negative steps and index arrays, read and write",
          np.array_equal(got, ref[::-1, ::-2])
          and np.array_equal(pick, ref[rows, cols])
          and np.array_equal(m.asnumpy(), ref2))
    j = nd.array(np.arange(3, dtype=np.int32), ctx=ctx)
    k = j + 0.5
    j += 0.5
    check("a scalar keeps the dtype", k.dtype == np.int32
          and j.dtype == np.int32 and np.array_equal(k.asnumpy(), [0, 1, 2])
          and (j * 2.5).dtype == np.int32)
    log(f"[ops-check] the six NDArray repairs on the card: "
        f"{6 - len(bad)} of 6 hold")
    return bad


def phase_ops_check(card):
    """Every op name (core and the rest) on the card against the port on
    the CPU, the random ops by distribution and seed, the repairs, and
    the CSR dot at Criteo's size."""
    dev = _card()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    try:
        from incubator_mxnet_torch.tools import op_cases
        bad = (_ops_names(card, dev, op_cases.core_names(),
                          "core (math, reduce, shape, nn, attention)")
               + _ops_names(card, dev, op_cases.rest_names(),
                            "extended, contrib and linalg")
               + _ops_random(dev) + _ops_repairs(dev) + _ops_repairs16(dev)
               + _ops_csr(card, dev))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    log(f"[ops-check] done in {time.time() - t0:.1f} s")
    if bad:
        raise AssertionError("[ops-check] " + "; ".join(bad))



# ---------------------------------------------------------------------
# [detect-check]: the detection ops at SSD300's and Faster R-CNN's sizes
# ---------------------------------------------------------------------
# SSD300 (Liu et al., ECCV 2016) on VGG16-reduced, as upstream MXNet's
# example/ssd configures it at 300: (feature map side, the two sizes,
# the ratios); 8,732 anchors
SSD300_MAPS = ((38, (0.1, 0.141), (1.0, 2.0, 0.5)),
               (19, (0.2, 0.272), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
               (10, (0.37, 0.447), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
               (5, (0.54, 0.619), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
               (3, (0.71, 0.79), (1.0, 2.0, 0.5)),
               (1, (0.88, 0.961), (1.0, 2.0, 0.5)))
SSD_ANCHORS = 8732
SSD_BATCH, SSD_LABELS, VOC_CLASSES = 32, 16, 21
# images held against the CPU (each image's sweep is its own)
SSD_CHECK_IMAGES = 8
# Faster R-CNN R-50-C4: res4 features of 600 x 800 images at stride 16,
# 512 RoIs an image, 14 x 14 bins, 2 x 2 samples
RCNN_FEAT = (2, 1024, 38, 50)
RCNN_ROIS, RCNN_POOL, RCNN_SCALE, RCNN_SAMPLES = 512, 14, 1.0 / 16, 2
RCNN_CHECK_ROIS = 64
NEAR = 1e-5                # a disagreement counts only this near a threshold


def _ssd300_anchors(ctx):
    from incubator_mxnet_torch import nd
    parts = [nd.contrib.MultiBoxPrior(nd.zeros((1, 1, side, side), ctx=ctx),
                                      sizes=sizes, ratios=ratios)
             for side, sizes, ratios in SSD300_MAPS]
    return nd.concat(*parts, dim=1)


def _ssd_inputs(rng):
    """Labels (B, 16, 5) with 1-16 objects an image, padded with class
    -1; class scores (B, 21, A) and box offsets (B, A * 4)."""
    label = np.full((SSD_BATCH, SSD_LABELS, 5), -1.0, np.float32)
    for i in range(SSD_BATCH):
        n = rng.randint(1, SSD_LABELS + 1)
        xy = rng.uniform(0.0, 0.8, (n, 2))
        wh = rng.uniform(0.05, 0.6, (n, 2))
        label[i, :n, 0] = rng.randint(0, VOC_CLASSES - 1, n)
        label[i, :n, 1:] = np.concatenate([xy, np.minimum(xy + wh, 1.0)], 1)
    logits = rng.randn(SSD_BATCH, VOC_CLASSES, SSD_ANCHORS) \
        .astype(np.float32) * 2
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    loc = (rng.randn(SSD_BATCH, SSD_ANCHORS * 4) * 0.5).astype(np.float32)
    return label, prob, loc


def _timed(fn):
    """(result, device ms of one call, peak MiB of the call)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    return out, time_ms(fn, iters=5, warmup=1), peak


def _near_or_bad(mismatch, near_at):
    """(near-threshold count, other count) of the rows of mismatch mask
    (images, rows): `near_at(image, row)` says whether a row lies within
    `NEAR` of a threshold."""
    idx = torch.nonzero(mismatch).tolist()
    k = sum(1 for b, j in idx if near_at(b, j))
    return k, len(idx) - k


def _iou_near(boxes, b, j, thresh):
    """Whether box j of image b has an IoU within NEAR of `thresh` with
    any box of its image."""
    from incubator_mxnet_torch.ops.extended import box_iou_corner
    iou = box_iou_corner(boxes[b, j:j + 1], boxes[b])[0]
    return bool(((iou - thresh).abs() < NEAR).any())


def phase_detect_check(card):
    """MultiBoxPrior at SSD300's 8,732 anchors, MultiBoxTarget,
    MultiBoxDetection and box_nms at batch 32 and 21 classes, ROIAlign
    at R-50-C4's head: the card against the CPU from one seeded input
    (targets, masks and kept sets equal but where an IoU or score lies
    within 1e-5 of its threshold; continuous outputs within 1e-5 of
    their largest value), each op's device ms and peak memory."""
    from incubator_mxnet_torch import nd
    from incubator_mxnet_torch.context import Context
    from incubator_mxnet_torch.ops.extended import box_iou_corner
    dev = _card()
    ctx, host = Context.from_device(dev), Context.from_device(
        torch.device("cpu"))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    bad, lines = [], []
    _reset_all_counts()
    try:
        anchors, ms, mib = _timed(lambda: _ssd300_anchors(ctx))
        ref_anchors = _ssd300_anchors(host)
        err = _ops_err(anchors.data, ref_anchors.data)
        lines.append(f"MultiBoxPrior x6 {ms:.3f} ms {mib:.1f} MiB")
        if anchors.shape != (1, SSD_ANCHORS, 4) or err > NEAR:
            bad.append(f"anchors {anchors.shape}, error {err:.2e}")
        label, prob, loc = _ssd_inputs(np.random.RandomState(12))
        c = SSD_CHECK_IMAGES
        dl, dp, dloc = (nd.array(a, ctx=ctx) for a in (label, prob, loc))
        hl, hp, hloc = (nd.array(a[:c], ctx=host) for a in (label, prob, loc))

        # targets
        tgt, ms, mib = _timed(lambda: nd.contrib.MultiBoxTarget(
            anchors, dl, dp))
        ref = nd.contrib.MultiBoxTarget(ref_anchors, hl, hp)
        lines.append(f"MultiBoxTarget {ms:.3f} ms {mib:.1f} MiB")
        lab = torch.from_numpy(label[:c])
        iou = box_iou_corner(ref_anchors.data[0], lab[..., 1:])
        iou = torch.where(lab[:, None, :, 0] >= 0, iou, torch.tensor(-1.0))
        near = ((iou.amax(2) - 0.5).abs() < NEAR)               # (c, A)
        mism = (tgt[2].data[:c].cpu() != ref[2].data) | (
            tgt[1].data[:c].cpu().reshape(c, -1, 4)
            != ref[1].data.reshape(c, -1, 4)).any(-1)
        k, other = _near_or_bad(mism, lambda b, j: bool(near[b, j]))
        same = ~mism.repeat_interleave(4, dim=1)
        err = _ops_err(tgt[0].data[:c].cpu()[same], ref[0].data[same])
        lines.append(f"targets: {other} anchors differ, {k} near 0.5, "
                     f"box targets error {err:.1e}")
        if other or err > NEAR:
            bad.append(f"MultiBoxTarget: {other} anchors differ away from "
                       f"the threshold, box targets error {err:.2e}")

        # decoding and NMS
        det, ms, mib = _timed(lambda: nd.contrib.MultiBoxDetection(
            dp, dloc, anchors, threshold=0.01, nms_threshold=0.45))
        ref = nd.contrib.MultiBoxDetection(hp, hloc, ref_anchors,
                                           threshold=0.01,
                                           nms_threshold=0.45)
        got, want = det.data[:c].cpu(), ref.data
        kept_got, kept_want = got[..., 0] >= 0, want[..., 0] >= 0
        # every row in score order, none dropped: the scores and boxes
        # that a disagreement is checked against
        every = nd.contrib.MultiBoxDetection(hp, hloc, ref_anchors,
                                             threshold=-1.0,
                                             nms_threshold=2.0).data
        k, other = _near_or_bad(
            kept_got != kept_want,
            lambda b, j: abs(float(every[b, j, 1]) - 0.01) < NEAR
            or _iou_near(every[..., 2:], b, j, 0.45))
        both = kept_got & kept_want
        err = _ops_err(got[both], want[both])
        lines.append(f"MultiBoxDetection {ms:.3f} ms {mib:.1f} MiB, kept "
                     f"{int(kept_want.sum())} of {c * SSD_ANCHORS} rows on "
                     f"{c} images, {other} differ, {k} near a threshold, "
                     f"error {err:.1e}")
        if other or err > NEAR:
            bad.append(f"MultiBoxDetection: {other} rows differ away from "
                       f"a threshold, error {err:.2e}")

        rng = np.random.RandomState(13)
        rows = np.concatenate([
            rng.randint(0, VOC_CLASSES - 1, (SSD_BATCH, SSD_ANCHORS, 1)),
            rng.uniform(0, 1, (SSD_BATCH, SSD_ANCHORS, 1)),
            np.broadcast_to(ref_anchors.asnumpy(), (SSD_BATCH, SSD_ANCHORS,
                                                    4))
            + rng.randn(SSD_BATCH, SSD_ANCHORS, 4) * 0.01], -1) \
            .astype(np.float32)
        kw = dict(overlap_thresh=0.45, valid_thresh=0.01, id_index=0,
                  topk=400)
        drows = nd.array(rows, ctx=ctx)
        nms, ms, mib = _timed(lambda: nd.contrib.box_nms(drows, **kw))
        ref = nd.contrib.box_nms(nd.array(rows[:c], ctx=host), **kw)
        got, want = nms.data[:c].cpu(), ref.data
        boxes = torch.from_numpy(rows[:c, :, 2:])
        k, other = _near_or_bad(
            (got[..., 1] < 0) != (want[..., 1] < 0),
            lambda b, j: abs(float(rows[b, j, 1]) - 0.01) < NEAR
            or _iou_near(boxes, b, j, 0.45))
        lines.append(f"box_nms {ms:.3f} ms {mib:.1f} MiB, kept "
                     f"{int((want[..., 1] >= 0).sum())} rows, {other} "
                     f"differ, {k} near 0.45")
        if other:
            bad.append(f"box_nms: {other} rows differ away from 0.45")

        # RoIs
        rng = np.random.RandomState(14)
        feat = rng.randn(*RCNN_FEAT).astype(np.float32)
        xy = rng.uniform(-32, 760, (2 * RCNN_ROIS, 2))
        wh = rng.uniform(16, 400, (2 * RCNN_ROIS, 2))
        rois = np.concatenate([np.repeat([0, 1], RCNN_ROIS)[:, None], xy,
                               xy + wh], 1).astype(np.float32)
        df, dr = nd.array(feat, ctx=ctx), nd.array(rois, ctx=ctx)
        kw = dict(pooled_size=RCNN_POOL, spatial_scale=RCNN_SCALE,
                  sample_ratio=RCNN_SAMPLES)
        pooled, ms, mib = _timed(lambda: nd.contrib.ROIAlign(df, dr, **kw))
        pick = np.concatenate([np.arange(RCNN_CHECK_ROIS // 2),
                               RCNN_ROIS + np.arange(RCNN_CHECK_ROIS // 2)])
        ref = nd.contrib.ROIAlign(nd.array(feat, ctx=host),
                                  nd.array(rois[pick], ctx=host), **kw)
        err = _ops_err(pooled.data[torch.from_numpy(pick).to(dev)],
                       ref.data)
        lines.append(f"ROIAlign {tuple(pooled.shape)} {ms:.3f} ms "
                     f"{mib:.1f} MiB, error {err:.1e} on {len(pick)} RoIs")
        if err > NEAR:
            bad.append(f"ROIAlign: error {err:.2e}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    launched = {k: v for k, v in _all_counts().items() if v}
    if launched:
        bad.append(f"hand kernels launched: {launched}")
    for line in lines:
        log(f"[detect-check] {line} ({card})")
    log(f"[detect-check] done in {time.time() - t0:.1f} s; no hand kernel "
        f"launched")
    if bad:
        raise AssertionError("[detect-check] " + "; ".join(bad))


# ---------------------------------------------------------------------
# [train-ssd]: example/ssd/train_ssd.py's loop through the port
# ---------------------------------------------------------------------
SSD_IMG = 32
SSD_SIZES, SSD_RATIOS = (0.3, 0.45, 0.6), (1.0, 1.5)
SSD_TRAIN = dict(batch=32, batches=150, lr=2e-3, eval_batch=64)
SSD_MIN_MIOU = 0.3                    # the example's own bar


def _ssd_batch(batch, rng):
    """The example's synthetic images: one bright rectangle (class 0) on
    noise; labels (B, 1, 5) normalized."""
    X = rng.rand(batch, 1, SSD_IMG, SSD_IMG).astype(np.float32) * 0.3
    L = np.zeros((batch, 1, 5), np.float32)
    for i in range(batch):
        w, h = rng.randint(8, 17), rng.randint(8, 17)
        x1, y1 = rng.randint(0, SSD_IMG - w), rng.randint(0, SSD_IMG - h)
        X[i, 0, y1:y1 + h, x1:x1 + w] += 1.0
        L[i, 0] = [0, x1 / SSD_IMG, y1 / SSD_IMG, (x1 + w) / SSD_IMG,
                   (y1 + h) / SSD_IMG]
    return X, L


def _tiny_ssd(num_anchors):
    """The example's TinySSD: three conv-relu-pool stages (16, 32, 64
    channels), class and box heads."""
    from incubator_mxnet_torch import gluon

    class TinySSD(gluon.nn.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.backbone = gluon.nn.HybridSequential()
            for ch in (16, 32, 64):
                self.backbone.add(
                    gluon.nn.Conv2D(ch, 3, padding=1, activation="relu"),
                    gluon.nn.MaxPool2D(2))
            self.cls_head = gluon.nn.Conv2D(num_anchors * 2, 3, padding=1)
            self.box_head = gluon.nn.Conv2D(num_anchors * 4, 3, padding=1)

        def hybrid_forward(self, F, x):
            feat = self.backbone(x)
            cls = self.cls_head(feat)
            box = self.box_head(feat)
            cls = F.reshape(F.transpose(cls, axes=(0, 2, 3, 1)),
                            shape=(0, -1, 2))
            box = F.reshape(F.transpose(box, axes=(0, 2, 3, 1)),
                            shape=(0, -1))
            return feat, cls, box
    return TinySSD()


def _box_iou_np(a, b):
    tl = np.maximum(a[:, :2], b[:, :2])
    br = np.minimum(a[:, 2:], b[:, 2:])
    wh = np.maximum(br - tl, 0)
    inter = wh[:, 0] * wh[:, 1]
    ua = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
          + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter)
    return inter / np.maximum(ua, 1e-12)


def phase_train_ssd(card):
    """The SSD example's TinySSD trained on the card at its defaults
    (batch 32, 150 batches, Adam 2e-3, MultiBoxPrior / MultiBoxTarget /
    MultiBoxDetection, SoftmaxCrossEntropyLoss + HuberLoss), then its
    evaluation on 64 images: mean IoU over the example's bar 0.3,
    recall@0.5, a step's wall and device time; no hand kernel runs."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import autograd, gluon, nd
    from incubator_mxnet_torch.context import Context
    ctx = Context.from_device(_card())
    cfg = SSD_TRAIN
    rng = np.random.RandomState(0)
    mx.random.seed(0)
    num_anchors = len(SSD_SIZES) + len(SSD_RATIOS) - 1
    net = _tiny_ssd(num_anchors)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    cls_loss = gluon.loss.SoftmaxCrossEntropyLoss()
    box_loss = gluon.loss.HuberLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": cfg["lr"]})
    anchors, losses = None, []

    def step(X, L):
        with autograd.record():
            _, cls_pred, box_pred = net(X)
            bt, bm, ct = nd.contrib.MultiBoxTarget(
                anchors, L, nd.transpose(cls_pred, axes=(0, 2, 1)))
            loss = cls_loss(cls_pred, ct).mean() \
                + box_loss(box_pred * bm, bt * bm).mean()
        loss.backward()
        trainer.step(1)
        return loss

    _reset_all_counts()
    t0 = time.time()
    step_s = []
    for it in range(cfg["batches"]):
        X, L = (nd.array(a, ctx=ctx) for a in _ssd_batch(cfg["batch"], rng))
        if anchors is None:
            feat, _, _ = net(X)
            anchors = nd.contrib.MultiBoxPrior(feat, sizes=SSD_SIZES,
                                               ratios=SSD_RATIOS)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        loss = step(X, L)
        losses.append(float(loss.asnumpy()))
        step_s.append(time.perf_counter() - s0)
        if (it + 1) % 30 == 0:
            log(f"[train-ssd] batch {it + 1}: loss {losses[-1]:.4f}")
    train_s = time.time() - t0
    X, L = (nd.array(a, ctx=ctx) for a in _ssd_batch(cfg["batch"], rng))
    dev_ms = device_ms(lambda: step(X, L), iters=5)
    counts = _all_counts()
    Xe, Le = _ssd_batch(cfg["eval_batch"], rng)
    _, cls_pred, box_pred = net(nd.array(Xe, ctx=ctx))
    probs = nd.softmax(nd.transpose(cls_pred, axes=(0, 2, 1)), axis=1)
    det = nd.contrib.MultiBoxDetection(probs, box_pred, anchors,
                                       threshold=0.1,
                                       nms_threshold=0.45).asnumpy()
    gt = Le[:, 0, 1:]
    ious = []
    for i in range(det.shape[0]):
        rows = det[i][det[i, :, 0] >= 0]
        if not len(rows):
            ious.append(0.0)
            continue
        best = rows[rows[:, 1].argmax()]
        ious.append(float(_box_iou_np(best[None, 2:], gt[i][None])[0]))
    miou = float(np.mean(ious))
    recall = float(np.mean([v > 0.5 for v in ious]))
    steady = sorted(step_s[10:])
    log(f"[train-ssd] TinySSD {cfg['batches']} batches of {cfg['batch']} "
        f"in {train_s:.1f} s: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"step wall {1e3 * steady[len(steady) // 2]:.2f} ms (median), "
        f"device {dev_ms:.2f} ms; mean IoU {miou:.3f}, recall@0.5 "
        f"{recall:.3f} on {det.shape[0]} images ({card})")
    launched = {k: v for k, v in counts.items() if v}
    if launched:
        raise AssertionError(f"[train-ssd] hand kernels launched: {launched}")
    log("[train-ssd] no hand kernel launched")
    if not all(math.isfinite(v) for v in losses) or miou <= SSD_MIN_MIOU:
        raise AssertionError(f"[train-ssd] mean IoU {miou:.3f} (bar "
                             f"{SSD_MIN_MIOU}), losses finite "
                             f"{all(math.isfinite(v) for v in losses)}")


# -- the input pipeline and the training-loop helpers --------------------

LOADER_SAMPLES, LOADER_STEPS = 2048, 8          # one epoch of 256
LOADER_SEED = 5
IO_ROWS = 1000
IO_LIBSVM_ROWS = 2 * CSR_ROWS - 1000            # the second batch pads
IO_DOT_RTOL = 1e-5       # of the largest value: 39 products a row added
#                          in another order than the dense product's
EST_SAMPLES, EST_BATCH, EST_EPOCHS = 2048, 64, 3
EST_SGD = {"learning_rate": 0.05, "momentum": 0.9}   # train_dist.py's
EST_MIN_ACC = 0.9        # held-out accuracy after the 3 epochs
EST_OUT_RTOL = 1e-5      # a loaded checkpoint's outputs, of the largest
DIST_MIN_ACC = 0.8       # train_dist.py's loop: last epoch's accuracy


class LoaderProbe:
    """A dataset for the loader phases: item i of `dataset`, then i, then
    whether the process that made the item has initialized CUDA and its
    pid.  A DataLoader's process workers must never open the card."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        img, label = self.dataset[i]
        return img, label, i, int(torch.cuda.is_initialized()), os.getpid()


def _batch_arrays(batch):
    """The arrays of a DataBatch, a tuple or an NDArray, in order."""
    if hasattr(batch, "data") and hasattr(batch, "label"):
        return list(batch.data) + list(batch.label or [])
    return list(batch) if isinstance(batch, (tuple, list)) else [batch]


def _bit_equal(card_batches, cpu_batches, what, columns=None):
    """Each card batch's arrays on the card and equal in dtype and bits to
    the CPU port's; `columns` picks the arrays to compare."""
    card_batches, cpu_batches = list(card_batches), list(cpu_batches)
    if len(card_batches) != len(cpu_batches):
        raise AssertionError(f"[io-check] {what}: {len(card_batches)} card "
                             f"batches, {len(cpu_batches)} on the CPU")
    for k, (c, h) in enumerate(zip(card_batches, cpu_batches)):
        ca, ha = _batch_arrays(c), _batch_arrays(h)
        if columns is not None:
            ca, ha = [ca[i] for i in columns], [ha[i] for i in columns]
        if getattr(c, "pad", 0) != getattr(h, "pad", 0):
            raise AssertionError(f"[io-check] {what}: batch {k} pads "
                                 f"differ")
        for j, (a, b) in enumerate(zip(ca, ha)):
            if a.context.device_type != "gpu":
                raise AssertionError(f"[io-check] {what}: batch {k} array "
                                     f"{j} lies on {a.context}")
            if a.dtype != b.dtype or not np.array_equal(a.asnumpy(),
                                                        b.asnumpy()):
                raise AssertionError(f"[io-check] {what}: batch {k} array "
                                     f"{j} differs from the CPU port's")
    return len(card_batches)


def _check_probe(probes, what):
    """No item was made by a process that initialized CUDA: `probes` are
    the (CUDA flag, pid) columns of LoaderProbe batches; returns the pids
    that made the items."""
    pids = set()
    for flags, pid in probes:
        if flags.asnumpy().any():
            raise AssertionError(f"{what}: a DataLoader worker process "
                                 f"initialized CUDA")
        pids.update(pid.asnumpy().tolist())
    if os.getpid() in pids:
        raise AssertionError(f"{what}: items were made in the parent, not "
                             f"in the worker processes")
    return pids


def _io_iterators(dir_):
    """NDArrayIter (shuffled, state/restore mid-epoch), PrefetchingIter
    over two iterators and CSVIter: the card's batches against the CPU
    port's."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import io
    rng = np.random.RandomState(0)
    x = rng.randn(IO_ROWS, 3, 16, 16)                  # float64 -> float32
    y = rng.randint(0, 10, IO_ROWS)                    # int64 -> int32
    kw = dict(batch_size=64, shuffle=True, shuffle_seed=3)

    def epoch(make):
        it = make()
        first = [it.next() for _ in range(3)]
        token = it.state()
        rest = list(it)
        again = make()
        again.restore(token)
        return first + rest, list(again)
    card, card_again = epoch(lambda: io.NDArrayIter(x, y, **kw))
    with mx.cpu():
        host, host_again = epoch(lambda: io.NDArrayIter(x, y, **kw))
    n = _bit_equal(card, host, "NDArrayIter")
    _bit_equal(card_again, host_again, "NDArrayIter after restore")
    _bit_equal(card_again, card[3:], "NDArrayIter restored against its "
               "own run")
    lines = [f"NDArrayIter {n} batches (shuffled; state() after 3, "
             f"restore() replays {len(card_again)})"]

    def two():
        return io.PrefetchingIter([io.NDArrayIter(x, y, 100),
                                   io.NDArrayIter({"w": x[:, 0]}, None,
                                                  100)])
    card = list(two())
    with mx.cpu():
        host = list(two())
    lines.append(f"PrefetchingIter over 2 iterators "
                 f"{_bit_equal(card, host, 'PrefetchingIter')} batches")
    path = os.path.join(dir_, "io.csv")
    np.savetxt(path, rng.randn(333, 12), delimiter=",")
    card = list(io.CSVIter(path, (3, 4), batch_size=50))
    with mx.cpu():
        host = list(io.CSVIter(path, (3, 4), batch_size=50))
    lines.append(f"CSVIter {_bit_equal(card, host, 'CSVIter')} batches "
                 f"(last pad {card[-1].pad})")
    return lines


def _write_libsvm(path, rng):
    """Criteo's shape: 13 numeric fields (lognormal) and 26 categorical
    (1.0) a row, hashed into 2^20 columns."""
    cols = np.sort(rng.randint(0, CSR_FEATURES, (IO_LIBSVM_ROWS,
                                                 CSR_NNZ_ROW)), axis=1)
    vals = np.ones((IO_LIBSVM_ROWS, CSR_NNZ_ROW), np.float32)
    vals[:, :13] = rng.lognormal(0.0, 1.0, (IO_LIBSVM_ROWS, 13))
    labels = rng.randint(0, 2, IO_LIBSVM_ROWS)
    with open(path, "w") as f:
        for lab, c, v in zip(labels, cols, vals):
            f.write(f"{lab} " + " ".join(f"{i}:{x:.6g}" for i, x in
                                         zip(c.tolist(), v.tolist()))
                    + "\n")


def _dense_dot(vals, cols, indptr, w, rows=512):
    """The dense product of a CSR matrix (host members) and `w` on the
    card, `rows` densified rows at a time."""
    n = len(indptr) - 1
    out = torch.empty((n, w.shape[1]), dtype=w.dtype, device=w.device)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        s, e = int(indptr[r0]), int(indptr[r1])
        row = np.repeat(np.arange(r1 - r0), np.diff(indptr[r0:r1 + 1]))
        dense = torch.zeros((r1 - r0, w.shape[0]), dtype=w.dtype,
                            device=w.device)
        dense.index_put_((torch.from_numpy(row).to(w.device),
                          torch.from_numpy(cols[s:e].astype(np.int64))
                          .to(w.device)),
                         torch.from_numpy(vals[s:e]).to(w.device),
                         accumulate=True)
        out[r0:r1] = dense @ w
        del dense
    return out


def _io_libsvm(dir_, card):
    """LibSVMIter at Criteo's width: CSR batches on the card against the
    CPU port's, and their `nd.sparse.dot` with a 2^20 x 64 weight
    against the dense product."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import io, nd
    rng = np.random.RandomState(7)
    path = os.path.join(dir_, "criteo.libsvm")
    t0 = time.time()
    _write_libsvm(path, rng)
    kw = dict(data_libsvm=path, data_shape=(CSR_FEATURES,),
              batch_size=CSR_ROWS)
    t1 = time.time()
    card_batches = list(io.LibSVMIter(**kw))
    t2 = time.time()
    with mx.cpu():
        host_batches = list(io.LibSVMIter(**kw))
    w = nd.array(rng.randn(CSR_FEATURES, CSR_WIDTH).astype(np.float32)
                 * 0.01)
    errs = []
    for k, (c, h) in enumerate(zip(card_batches, host_batches)):
        csr, hcsr = c.data[0], h.data[0]
        if csr.stype != "csr" or csr.context.device_type != "gpu" or \
                c.pad != h.pad:
            raise AssertionError(f"[io-check] LibSVMIter batch {k}: "
                                 f"{csr.stype} on {csr.context}")
        members = [getattr(hcsr, m).asnumpy() for m in
                   ("data", "indices", "indptr")]
        for m, ref in zip(("data", "indices", "indptr"), members):
            got = getattr(csr, m)
            if got.dtype != ref.dtype or not np.array_equal(got.asnumpy(),
                                                            ref):
                raise AssertionError(f"[io-check] LibSVMIter batch {k}: "
                                     f"{m} differs from the CPU port's")
        if not np.array_equal(c.label[0].asnumpy(), h.label[0].asnumpy()):
            raise AssertionError(f"[io-check] LibSVMIter batch {k}: labels")
        got = nd.sparse.dot(csr, w).data
        ref = _dense_dot(*members, w.data)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        errs.append(err)
        if err > IO_DOT_RTOL:
            raise AssertionError(f"[io-check] LibSVMIter batch {k}: sparse "
                                 f"dot error {err:.2e} of the largest "
                                 f"value against the dense product")
    nnz = sum(int(b.data[0].indptr.asnumpy()[-1]) for b in card_batches)
    return (f"LibSVMIter {IO_LIBSVM_ROWS} rows x 2^20 features ({nnz} "
            f"entries; file written in {t1 - t0:.1f} s, parsed in "
            f"{t2 - t1:.1f} s), {len(card_batches)} CSR batches of "
            f"{CSR_ROWS} (last pad {card_batches[-1].pad}), members equal "
            f"to the CPU port's; nd.sparse.dot with a 2^20 x {CSR_WIDTH} "
            f"weight against the dense product: max error "
            f"{max(errs):.1e} of the largest value")


def _timed_list(loader):
    t0 = time.time()
    return list(loader), time.time() - t0


def _io_loaders(ds, procs, spawn, spawned):
    """DataLoader with 0 workers, 4 thread workers and 4 process workers
    (`procs`, whose first epoch `spawn` runs into `spawned`), all
    pinned, and DevicePrefetcher(threads=3) over a shuffled loader: the
    card's batches against the CPU port's, the prefetcher's order
    against the sampler's."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import io
    from incubator_mxnet_torch.gluon.data import DataLoader
    lines = []
    for workers, thread_pool in ((0, False), (4, True), (4, False)):
        if workers and not thread_pool:
            loader = procs
            spawn.join()
            if "error" in spawned:
                raise spawned["error"]
            card, secs = spawned["card"]
        else:
            loader = DataLoader(ds, 32, num_workers=workers,
                                thread_pool=thread_pool, pin_memory=True)
            card, secs = _timed_list(loader)
        with mx.cpu():
            host = list(loader)
        loader.close()
        n = _bit_equal(card, host, f"DataLoader({workers} workers)",
                       columns=(0, 1, 2))
        kind = "processes" if workers and not thread_pool else \
            "threads" if workers else "inline"
        if kind == "processes":
            pids = _check_probe([b[3:] for b in card + host],
                                "[io-check]")
            kind += f" ({len(pids)} pids, none initialized CUDA)"
        lines.append(f"DataLoader {workers} workers {kind}: {n} batches "
                     f"({secs:.2f} s for the card's epoch)")
    loader = DataLoader(ds, 32, shuffle=True, num_workers=4,
                        thread_pool=True, pin_memory=True)
    np.random.seed(LOADER_SEED)
    order = np.random.permutation(len(ds))
    np.random.seed(LOADER_SEED)
    pf = io.DevicePrefetcher(loader, ctx=mx.gpu(0), threads=3)
    card = list(pf)
    pf.close()
    np.random.seed(LOADER_SEED)
    with mx.cpu():
        host = list(loader)
    n = _bit_equal(card, host, "DevicePrefetcher(threads=3)",
                   columns=(0, 1, 2))
    got = np.concatenate([b[2].asnumpy() for b in card])
    if not np.array_equal(got, order):
        raise AssertionError("[io-check] DevicePrefetcher(threads=3) "
                             "changed the sampler's order")
    lines.append(f"DevicePrefetcher(threads=3) over a shuffled loader: "
                 f"{n} batches in the sampler's order")
    return lines


def phase_io_check(card):
    """Every iterator and loader of the input path on the card against
    the CPU port, bit for bit; no hand kernel runs."""
    from incubator_mxnet_torch.gluon.data import DataLoader
    from incubator_mxnet_torch.gluon.data.vision import SyntheticImageDataset
    t0 = time.time()
    _reset_all_counts()
    ds = LoaderProbe(SyntheticImageDataset(256, (3, 32, 32)))
    # the process workers' first epoch starts first, on a thread: their
    # spawn (each child imports torch) overlaps the other checks
    procs = DataLoader(ds, 32, num_workers=4, pin_memory=True)
    spawned = {}

    def first_epoch():
        try:
            spawned["card"] = _timed_list(procs)
        except Exception as e:      # noqa: BLE001 — raised after join
            spawned["error"] = e
    spawn = threading.Thread(target=first_epoch)
    spawn.start()
    with tempfile.TemporaryDirectory() as d:
        lines = _io_iterators(d) + [_io_libsvm(d, card)] + \
            _io_loaders(ds, procs, spawn, spawned)
    counts = _all_counts()
    if any(counts.values()):
        raise AssertionError(f"[io-check] launched hand kernels {counts}")
    for line in lines:
        log(f"[io-check] {line}")
    log(f"[io-check] card batches bit-equal to the CPU port's; no hand "
        f"kernel launched; {time.time() - t0:.1f} s ({card})")


def phase_train_loader(card, resident_step_ms):
    """`bench_resnet50`'s model and recipe fed by the input path:
    SyntheticImageDataset(2048, 3x224x224) through a shuffled, pinned
    DataLoader with process workers and DevicePrefetcher(trainer=tr,
    depth=2) into ParallelTrainer.step, 8 steps (one epoch); the feed
    rate alone, the loader-fed step against [train-resnet]'s
    resident-batch step, the consumer's stall, a profiled step."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import io
    from incubator_mxnet_torch.gluon.data import DataLoader
    from incubator_mxnet_torch.gluon.data.dataloader import \
        default_batchify_fn
    from incubator_mxnet_torch.gluon.data.vision import SyntheticImageDataset
    cores = os.cpu_count()
    workers = min(8, cores)
    t_start = time.time()
    net, loss, tr, _, _ = _resnet50_bench()
    ds = LoaderProbe(SyntheticImageDataset(LOADER_SAMPLES,
                                           (3, RESNET_SIZE, RESNET_SIZE)))
    loader = DataLoader(ds, RESNET_BATCH, shuffle=True, num_workers=workers,
                        pin_memory=True)
    nbytes = RESNET_BATCH * 3 * RESNET_SIZE ** 2 * 4
    log(f"[train-loader] os.cpu_count() = {cores}; {workers} worker "
        f"processes; a batch is {nbytes / 1e6:.1f} MB of float32, "
        f"depth 2")
    _reset_all_counts()
    np.random.seed(LOADER_SEED)
    pf = io.DevicePrefetcher(loader, trainer=tr, depth=2)
    losses, stalls, probes, first = [], [], [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(LOADER_STEPS):
        ts = time.perf_counter()
        x, y, idx, cuda_flag, pid = next(pf)
        stalls.append(time.perf_counter() - ts)
        if step == 0:
            first = (x.asnumpy(), y.asnumpy(), idx.asnumpy())
        probes.append((cuda_flag, pid))
        # the loader gives float32; the net is bfloat16, so the step's
        # input is cast on the card (ParallelTrainer places nothing)
        losses.append(tr.step(x.astype("bfloat16"), y))
        if step == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    losses = [v.asscalar() for v in losses]
    pf.close()
    step_ms = (t2 - t1) / (LOADER_STEPS - 1) * 1e3
    pids = _check_probe(probes, "[train-loader]")
    with mx.cpu():
        ref = default_batchify_fn([ds.dataset[int(i)] for i in first[2]])
    if not (np.array_equal(first[0], ref[0].asnumpy())
            and np.array_equal(first[1], ref[1].asnumpy())):
        raise AssertionError("[train-loader] the first batch differs from "
                             "the CPU port's batch of the same indices")
    np.random.seed(LOADER_SEED)
    if not np.array_equal(first[2], np.random.permutation(
            LOADER_SAMPLES)[:RESNET_BATCH]):
        raise AssertionError("[train-loader] the first batch is not the "
                             "sampler's")
    log(f"[train-loader] {LOADER_STEPS} steps, losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; first step (pool spawn, first batches) "
        f"{(t1 - t0) * 1e3:.0f} ms; items made by {len(pids)} worker "
        f"pids, none initialized CUDA; the first batch equals the CPU "
        f"port's batch of its indices")
    # the feed alone, the pool warm and no step running: the loader's
    # page-locked host batches, then the same through the prefetcher
    t0 = time.perf_counter()
    with mx.cpu():
        n = sum(b[0].shape[0] for b in loader)
    host_feed = n / (time.perf_counter() - t0)
    pf = io.DevicePrefetcher(loader, trainer=tr, depth=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for last in pf:
        n += last[0].shape[0]
    torch.cuda.synchronize()
    feed = n / (time.perf_counter() - t0)
    pf.close()
    loader.close()
    xb, yb = last[0].astype("bfloat16"), last[1]
    dev_ms, launches = log_profile(
        lambda: losses.append(tr.step(xb, yb).asscalar()),
        f"one loader-fed {RESNET_BATCH}x3x{RESNET_SIZE}x{RESNET_SIZE} "
        f"training step", tag="[train-loader]")
    counts = _all_counts()
    if any(counts.values()):
        raise AssertionError(f"[train-loader] launched hand kernels "
                             f"{counts}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"[train-loader] losses {losses} are not "
                             f"finite and falling")
    stall_ms = 1e3 * sum(stalls[1:]) / (LOADER_STEPS - 1)
    log(f"[train-loader] feed alone, no step: the loader's page-locked "
        f"host batches {host_feed:.1f} images/s; through DevicePrefetcher "
        f"onto the card {feed:.1f} images/s ({card})")
    log(f"[train-loader] loader-fed step {step_ms:.2f} ms "
        f"({RESNET_BATCH / step_ms * 1e3:.1f} images/s, steps 2-"
        f"{LOADER_STEPS}, host clock to a synchronize) against "
        f"[train-resnet]'s resident-batch step {resident_step_ms:.2f} ms: "
        f"vs_synthetic {resident_step_ms / step_ms:.3f} ({card})")
    log(f"[train-loader] consumer stall in next(): {stall_ms:.2f} ms a "
        f"step (steps 2-{LOADER_STEPS}), first step "
        f"{stalls[0] * 1e3:.0f} ms")
    log(f"[train-loader] profiled step: {dev_ms:.2f} ms of device time in "
        f"{launches} launches; against the {step_ms:.2f} ms loader-fed "
        f"step the device is idle {1 - dev_ms / step_ms:.3f} of the step; "
        f"no hand kernel launched; {time.time() - t_start:.1f} s")
    del net, tr
    torch.cuda.empty_cache()


class BatchEndParam:
    """What a batch-end callback reads (the Module fit loop's argument)."""

    def __init__(self, epoch, nbatch, eval_metric):
        self.epoch, self.nbatch, self.eval_metric = epoch, nbatch, \
            eval_metric


def _est_loaders():
    from incubator_mxnet_torch.gluon.data import DataLoader
    from incubator_mxnet_torch.gluon.data.vision import (
        SyntheticImageDataset, transforms as T)
    norm = T.Normalize(0.5, 0.25)
    train = SyntheticImageDataset(EST_SAMPLES, (3, 32, 32), seed=0) \
        .transform_first(T.Compose([T.RandomFlipLeftRight(), norm]))
    val = SyntheticImageDataset(EST_SAMPLES // 4, (3, 32, 32), seed=1) \
        .transform_first(norm)
    return (DataLoader(train, EST_BATCH, shuffle=True, num_workers=4,
                       thread_pool=True, pin_memory=True),
            DataLoader(val, EST_BATCH, num_workers=4, thread_pool=True))


def _resnet18(ctx):
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch.gluon.model_zoo.vision import get_model
    net = get_model("resnet18_v1", classes=10, thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def _train_dist_loop(ctx):
    """example/distributed_training/train_dist.py's loop body on one card
    (its data recipe, NDArrayIter, Accuracy, 2 epochs), with a
    Speedometer; the distributed kvstore is left out."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import autograd, callback, gluon, io, metric
    rng = np.random.RandomState(7)
    proto = rng.randn(10, 3, 32, 32).astype(np.float32)
    labels = rng.randint(0, 10, EST_SAMPLES)
    data = proto[labels] + 0.4 * rng.randn(EST_SAMPLES, 3, 32, 32) \
        .astype(np.float32)
    train = io.NDArrayIter(data, labels.astype(np.float32),
                           batch_size=EST_BATCH, shuffle=True)
    mx.random.seed(0)
    net = _resnet18(ctx)
    trainer = gluon.Trainer(net.collect_params(), "sgd", EST_SGD)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    speed = callback.Speedometer(EST_BATCH, frequent=16, auto_reset=False,
                                 emit_json=True)
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        for epoch in range(2):
            train.reset()
            acc.reset()
            for nbatch, batch in enumerate(train):
                x = batch.data[0].as_in_context(ctx)
                y = batch.label[0].as_in_context(ctx)
                with autograd.record():
                    out = net(x)
                    loss = loss_fn(out, y).mean()
                loss.backward()
                trainer.step(1)
                acc.update([y], [out])
                speed(BatchEndParam(epoch, nbatch, acc))
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    jsonl = [json.loads(m) for m in records if m.startswith("{")]
    keys = {"epoch", "batch", "samples_per_sec", "metrics", "time", "rank",
            "role", "host"}
    if not jsonl or any(set(r) != keys for r in jsonl):
        raise AssertionError(f"[estimator] Speedometer records {jsonl[:1]}")
    name, value = acc.get()
    if value < DIST_MIN_ACC:
        raise AssertionError(f"[estimator] train_dist loop: {name} "
                             f"{value:.3f} < {DIST_MIN_ACC}")
    texts = [m for m in records if m.startswith("Epoch[")]
    return (f"train_dist.py's loop (NDArrayIter, Accuracy, Speedometer) 2 "
            f"epochs: last epoch {name} {value:.4f}; Speedometer: "
            f"{len(texts)} lines and {len(jsonl)} JSON records, e.g. "
            f"{texts[-1]!r}")


def phase_estimator(card):
    """Estimator.fit of train_dist.py's net (resnet18_v1, thumbnail, 10
    classes) for 3 epochs from a DataLoader with RandomFlipLeftRight and
    Normalize, with LoggingHandler, CheckpointHandler and
    EarlyStoppingHandler; evaluate on held-out data (gate EST_MIN_ACC),
    a checkpoint loaded into a fresh net, then train_dist.py's loop."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import gluon
    from incubator_mxnet_torch.gluon.contrib import estimator as est
    t0 = time.time()
    ctx = mx.gpu(0)
    _reset_all_counts()
    mx.random.seed(0)
    np.random.seed(0)
    net = _resnet18(ctx)
    trainer = gluon.Trainer(net.collect_params(), "sgd", EST_SGD)
    e = est.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                      train_metrics="acc", trainer=trainer, context=ctx)
    train, val = _est_loaders()
    accs = []

    class Record(est.EpochEnd):
        def epoch_end(self, estimator):
            accs.append(estimator.train_metric.get()[1])
    with tempfile.TemporaryDirectory() as d:
        e.fit(train, epochs=EST_EPOCHS, event_handlers=[
            est.LoggingHandler(log_interval=16),
            est.CheckpointHandler(d, "resnet18"),
            est.EarlyStoppingHandler(patience=1), Record()])
        torch.cuda.synchronize()
        fit_s = time.time() - t0
        (name, value), = e.evaluate(val)
        files = sorted(os.listdir(d))
        fresh = _resnet18(ctx)
        fresh.load_parameters(os.path.join(
            d, f"resnet18-epoch{EST_EPOCHS - 1}.params"), ctx=ctx)
    x = next(iter(val))[0]
    with torch.no_grad():
        ref, got = net(x).data, fresh(x).data
    out_err = ((got - ref).abs().max() / ref.abs().max()).item()
    if files != [f"resnet18-epoch{i}.params" for i in range(EST_EPOCHS)]:
        raise AssertionError(f"[estimator] checkpoint files {files}")
    if out_err > EST_OUT_RTOL:
        raise AssertionError(f"[estimator] loaded checkpoint's outputs "
                             f"differ by {out_err:.2e}")
    if value < EST_MIN_ACC or len(accs) != EST_EPOCHS:
        raise AssertionError(f"[estimator] held-out {name} {value:.3f} "
                             f"(gate {EST_MIN_ACC}) after {len(accs)} "
                             f"epochs")
    log(f"[estimator] Estimator.fit resnet18_v1 (thumbnail, 10 classes) "
        f"{EST_EPOCHS} epochs of {EST_SAMPLES} 3x32x32 at batch "
        f"{EST_BATCH} (RandomFlipLeftRight, Normalize; 4 loader threads): "
        f"training accuracy by epoch "
        + ", ".join(f"{a:.4f}" for a in accs)
        + f"; held-out {name} {value:.4f} (gate {EST_MIN_ACC}); "
        f"{fit_s:.1f} s; checkpoints {files}; the last loaded into a "
        f"fresh net gives its outputs within {out_err:.1e}")
    log(f"[estimator] {_train_dist_loop(ctx)}")
    counts = _all_counts()
    if any(counts.values()):
        raise AssertionError(f"[estimator] launched hand kernels {counts}")
    log(f"[estimator] no hand kernel launched; {time.time() - t0:.1f} s "
        f"({card})")



# -- the image input path ------------------------------------------------------

IMG_SIZES = ((224, 224), (375, 500))     # (h, w): a crop's size, a VOC photo
IMG_QUALITIES = (95, 85)
IMG_MIN_LUMA_PSNR = 30.0                 # dB, 4:2:0 (see phase_image_check)
REDUCED_SIZES = ((1024, 8), (512, 4))    # (stored size, decode scale)
REDUCED_MAX_MEAN = 2.0                   # levels, against a box average
RECORD_IMAGES, RECORD_SIZE, RECORD_QUALITY = 1024, 256, 85
RECORD_STEPS = 16
RECORD_RESIZE = 256
MEAN_RGB = (123.68, 116.28, 103.53)
STD_RGB = (58.395, 57.12, 57.375)


def _shard_image(h, w, seed):
    """`build_shard`'s image: 8 x 8 blocks of color plus N(0, 12^2)."""
    from incubator_mxnet_torch.tools.io_bench import block_image
    return block_image(np.random.RandomState(seed), h, w)


def _psnr(err):
    return 10 * math.log10(255.0 ** 2 / max(float(np.mean(err ** 2)), 1e-12))


def _write_rec(path, images, labels=None, corrupt=()):
    from incubator_mxnet_torch import recordio
    w = recordio.MXRecordIO(path, "w")
    for i, img in enumerate(images):
        hdr = recordio.IRHeader(0, float(i if labels is None else labels[i]),
                                i, 0)
        w.write(recordio.pack(hdr, b"\xff\xd8corrupt" * 8) if i in corrupt
                else recordio.pack_img(hdr, img, quality=90))
    w.close()


def _host_library_links_no_cuda(path):
    out = subprocess.run(["ldd", path], capture_output=True, text=True,
                         timeout=60).stdout
    bad = [ln.strip() for ln in out.splitlines()
           if "cuda" in ln.lower() or "nvidia" in ln.lower()]
    if bad:
        raise AssertionError(f"the host library links CUDA: {bad}")
    return len(out.splitlines())


def phase_image_check(card):
    """The port's host codec and record pipeline on the card's host: the
    build, pack/unpack PSNR, imdecode against the pipeline, both
    ImageRecordIter engines, the reduced-size decodes, ImageDetIter over a
    VOC-shaped batch and the decode-failure count."""
    import random
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import _native, image, io, recordio
    from incubator_mxnet_torch.io.native_image import NativeImagePipeline
    from incubator_mxnet_torch.tools.io_bench import build_shard
    t_start = time.time()
    _reset_all_counts()
    info = _native.build()
    deps = _host_library_links_no_cuda(info["path"])
    log(f"[image-check] host library {os.path.basename(info['path'])}: "
        + (f"built in {info['seconds']:.1f} s" if info["built"]
           else "already built") + f" by {_native.compiler_version()}; "
        f"ldd lists {deps} libraries, none of CUDA")
    # pack_img -> unpack_img: 4:2:0 averages each channel's independent
    # noise away in the chroma, so the gate is on the luma's PSNR and the
    # RGB PSNR is logged beside it
    weights = np.array([0.299, 0.587, 0.114])
    for (h, w) in IMG_SIZES:
        img = _shard_image(h, w, seed=h)
        for q in IMG_QUALITIES:
            t0 = time.perf_counter()
            packed = recordio.pack_img(recordio.IRHeader(0, 1.0, 0, 0), img,
                                       quality=q)
            t1 = time.perf_counter()
            back = recordio.unpack_img(packed)[1].astype(np.float64)
            t2 = time.perf_counter()
            err = back - img
            luma = _psnr(err @ weights)
            log(f"[image-check] pack_img/unpack_img {h}x{w} q{q} 4:2:0: "
                f"{len(packed)} bytes, PSNR RGB {_psnr(err):.2f} dB, luma "
                f"{luma:.2f} dB; encode {(t1 - t0) * 1e3:.2f} ms, decode "
                f"{(t2 - t1) * 1e3:.2f} ms (one host thread)")
            if luma < IMG_MIN_LUMA_PSNR:
                raise AssertionError(f"[image-check] luma PSNR {luma:.2f} "
                                     f"dB under {IMG_MIN_LUMA_PSNR}")
    with tempfile.TemporaryDirectory() as d:
        # imdecode against the pipeline: no resize, centre crop, in order
        imgs = [_shard_image(h, w, seed=i) for i, (h, w) in
                enumerate(IMG_SIZES * 4)]
        rec = os.path.join(d, "mixed.rec")
        _write_rec(rec, imgs)
        pipe = NativeImagePipeline(rec, (3, 224, 224), len(imgs),
                                   preprocess_threads=4, out_uint8=True)
        data, label = pipe.next_arrays()
        reader = recordio.MXRecordIO(rec, "r")
        for i in range(len(imgs)):
            full = image.imdecode(recordio.unpack(reader.read())[1])
            y0, x0 = (full.shape[0] - 224) // 2, (full.shape[1] - 224) // 2
            if not (np.array_equal(data[i], full[y0:y0 + 224, x0:x0 + 224])
                    and label[i, 0] == i):
                raise AssertionError(f"[image-check] pipeline image {i} "
                                     f"differs from imdecode's crop")
        clean = [pipe.decode_failures]
        pipe.close()
        log(f"[image-check] imdecode's centre crops equal the pipeline's "
            f"pixels bit for bit ({len(imgs)} images, 224x224 and 375x500)")
        # both ImageRecordIter engines, crop only (images under twice the
        # crop: larger ones the native engine decodes at reduced size)
        rec = os.path.join(d, "small.rec")
        _write_rec(rec, [_shard_image(256, 256, seed=i) for i in range(32)])
        batches = {}
        for engine in ("1", "0"):
            os.environ["MXNET_NATIVE_IMAGE_PIPELINE"] = engine
            t0 = time.perf_counter()
            it = io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 224, 224),
                                    batch_size=8, preprocess_threads=4)
            got = [(b.data[0], b.label[0]) for b in it]
            batches[engine] = [(x.asnumpy(), y.asnumpy()) for x, y in got]
            log(f"[image-check] ImageRecordIter engine "
                f"{type(it).__name__}: {len(got)} batches of 8 on "
                f"{got[0][0].context} in "
                f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
        os.environ.pop("MXNET_NATIVE_IMAGE_PIPELINE")
        for (a, la), (b, lb) in zip(batches["1"], batches["0"]):
            if not (np.array_equal(la, lb) and np.array_equal(a, b)):
                raise AssertionError("[image-check] the two ImageRecordIter "
                                     "engines disagree")
        log("[image-check] both engines: labels equal, pixels bit-equal")
        # reduced-size decodes against the full decode and a box average
        for size, scale in REDUCED_SIZES:
            rec = os.path.join(d, f"r{size}.rec")
            build_shard(rec, 8, size, RECORD_QUALITY, seed=size)
            pipe = NativeImagePipeline(rec, (3, 128, 128), 8, resize=128,
                                       preprocess_threads=4, out_uint8=True)
            t0 = time.perf_counter()
            got = pipe.next_arrays()[0].copy()
            ms = (time.perf_counter() - t0) * 1e3
            clean.append(pipe.decode_failures)
            pipe.close()
            reader = recordio.MXRecordIO(rec, "r")
            diff = np.stack([np.abs(got[i].astype(int) - image.imresize(
                recordio.unpack_img(reader.read())[1], 128, 128, 3))
                for i in range(8)])
            log(f"[image-check] {size}x{size} at resize 128 (the 1/{scale} "
                f"decode): against the full decode and a box average to 128, "
                f"mean |diff| {diff.mean():.3f}, p99 "
                f"{np.percentile(diff, 99):.0f}, max {diff.max()} levels "
                f"(bound: mean {REDUCED_MAX_MEAN}); 8 images {ms:.1f} ms")
            if diff.mean() > REDUCED_MAX_MEAN:
                raise AssertionError(f"[image-check] the 1/{scale} decode is "
                                     f"off by {diff.mean():.3f} on average")
        # decode failures: none on a clean shard, one corrupt record counted
        rec = os.path.join(d, "bad.rec")
        _write_rec(rec, [_shard_image(64, 64, seed=i) for i in range(8)],
                   corrupt=(3,))
        pipe = NativeImagePipeline(rec, (3, 32, 32), 4, out_uint8=True)
        while pipe.next_arrays() is not None:
            pass
        failures = pipe.decode_failures
        pipe.close()
        if any(clean):
            raise AssertionError(f"[image-check] decode failures {clean} on "
                                 f"clean shards")
        if failures != 1:
            raise AssertionError(f"[image-check] {failures} decode failures "
                                 f"counted for 1 corrupt record")
    # ImageDetIter over a VOC-shaped batch: 375 x 500 JPEGs, 1-6 boxes
    rng = np.random.RandomState(0)
    items = []
    for i in range(8):
        img = image.imdecode(recordio.unpack(recordio.pack_img(
            recordio.IRHeader(0, 0.0, i, 0), _shard_image(375, 500, i),
            quality=90))[1])
        n = 1 + i % 6
        x1, y1 = rng.rand(n) * 0.5, rng.rand(n) * 0.5
        items.append((img, np.stack([rng.randint(0, 20, n), x1, y1,
                                     x1 + 0.1 + rng.rand(n) * 0.4,
                                     y1 + 0.1 + rng.rand(n) * 0.4],
                                    1).astype(np.float32)))
    out = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        mx.random.seed(1)
        random.seed(1)
        augs = image.CreateDetAugmenter((3, 300, 300), rand_crop=0.5,
                                        rand_mirror=True, mean=True, std=True)
        with ctx:
            t0 = time.perf_counter()
            b = next(iter(image.ImageDetIter(8, (3, 300, 300), imglist=items,
                                             augmenters=augs)))
            out[ctx.device_type] = (b.data[0], b.label[0].asnumpy(),
                                    (time.perf_counter() - t0) * 1e3)
    data, lab, ms = out["gpu"]
    if data.context.device_type != "gpu" or data.shape != (8, 3, 300, 300):
        raise AssertionError(f"[image-check] ImageDetIter gave {data.shape} "
                             f"on {data.context}")
    if not (np.isfinite(data.asnumpy()).all()
            and np.array_equal(data.asnumpy(), out["cpu"][0].asnumpy())
            and np.array_equal(lab, out["cpu"][1])):
        raise AssertionError("[image-check] ImageDetIter's card batch "
                             "differs from the CPU's")
    boxes = lab[lab[..., 0] >= 0]
    log(f"[image-check] ImageDetIter + CreateDetAugmenter: data "
        f"{tuple(data.shape)} on {data.context}, labels {lab.shape}, "
        f"{len(boxes)} boxes kept, all in [0, 1]: "
        f"{bool(((boxes[:, 1:5] >= -1e-6) & (boxes[:, 1:5] <= 1 + 1e-6)).all())}"
        f"; equal to the CPU's batch; {ms:.0f} ms")
    counts = _all_counts()
    if any(counts.values()):
        raise AssertionError(f"[image-check] launched hand kernels {counts}")
    log(f"[image-check] decode failures 0 on clean shards, 1 for the "
        f"corrupt record; no hand kernel launched; "
        f"{time.time() - t_start:.1f} s ({card})")


def _copy_ms(src):
    """Device time of one non-blocking copy of host tensor `src` to the
    card."""
    dst = torch.empty(src.shape, dtype=src.dtype, device="cuda")
    return time_ms(lambda: dst.copy_(src, non_blocking=True))


def _normalized_resnet(ctx):
    """`bench_resnet50_input`'s model: uint8 NHWC -> float32 NCHW ->
    (x - mean) / std -> bfloat16, made NCHW-contiguous -> resnet50_v1b,
    on the card."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import gluon, nd
    from incubator_mxnet_torch.gluon.model_zoo.vision import get_model
    from incubator_mxnet_torch.ndarray import NDArray

    class NormalizedResNet(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.net = get_model("resnet50_v1b", classes=RESNET_CLASSES)
            with ctx:
                self._mean = nd.array(np.array(MEAN_RGB, np.float32)
                                      .reshape(1, 3, 1, 1))
                self._std = nd.array(np.array(STD_RGB, np.float32)
                                     .reshape(1, 3, 1, 1))

        def hybrid_forward(self, F, x):
            x = x.astype("float32").transpose((0, 3, 1, 2))
            x = ((x - self._mean) / self._std).astype("bfloat16")
            # the transpose is a view with NHWC strides, and PyTorch keeps
            # a tensor's memory format through convolutions and
            # elementwise ops: without this copy every layer runs
            # channels-last (on an H100 at 700 W: 223.63 ms of device
            # time a step against the NCHW step's 161.65)
            return self.net(NDArray(x._data.contiguous()))

    mx.random.seed(0)
    np.random.seed(0)
    net = NormalizedResNet()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.net.cast("bfloat16")
    return net


def phase_train_record(card, resident_step_ms):
    """`bench_resnet50_input`: ResNet-50 v1b at 256 x 3 x 224^2 bf16
    trained from a 1024-image JPEG RecordIO shard (256^2, q85) through the
    native pipeline's page-locked slots and `staging_ring(trainer=tr)`."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import gluon, parallel
    from incubator_mxnet_torch.io.native_image import NativeImageRecordIter
    from incubator_mxnet_torch.tools.io_bench import build_shard
    t_start = time.time()
    cores = os.cpu_count() or 2
    threads = max(2, cores)
    with tempfile.TemporaryDirectory() as d:
        rec = os.path.join(d, "shard.rec")
        build_s = build_shard(rec, RECORD_IMAGES, RECORD_SIZE, RECORD_QUALITY)
        log(f"[train-record] shard: {RECORD_IMAGES} JPEGs {RECORD_SIZE}^2 "
            f"q{RECORD_QUALITY} built by the port's encoder in {build_s:.1f} s "
            f"({os.path.getsize(rec) / 1e6:.1f} MB)")
        it = NativeImageRecordIter(
            rec, (3, RESNET_SIZE, RESNET_SIZE), RESNET_BATCH, shuffle=True,
            rand_crop=True, rand_mirror=True, out_uint8=True,
            resize=RECORD_RESIZE, preprocess_threads=threads, prefetch=4)
        pipe = it._pipe
        if not pipe.next_tensors()[0].is_pinned():
            raise AssertionError("[train-record] the slots are not "
                                 "page-locked")
        net = _normalized_resnet(mx.gpu(0))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        tr = parallel.ParallelTrainer(
            net, lambda o, y: loss_fn(o.astype("float32"), y),
            optimizer="sgd", optimizer_params=SGD,
            mesh=parallel.default_mesh(ctx=mx.gpu(0)))
        # the feed alone: reset first, so no batch decoded while the model
        # was built counts
        pipe.reset()
        t0 = time.perf_counter()
        nb = 0
        while pipe.next_tensors() is not None:
            nb += 1
        feed = nb * RESNET_BATCH / (time.perf_counter() - t0)
        # the host-to-card copy of one page-locked slot
        pipe.reset()
        slot = pipe.next_tensors()[0]
        copy_ms = _copy_ms(slot)
        gbps = slot.numel() / copy_ms / 1e6
        log(f"[train-record] feed alone: {feed:.1f} images/s over one epoch "
            f"({nb} batches, {threads} decode threads, os.cpu_count() = "
            f"{cores}); one {slot.numel() / 1e6:.1f} MB uint8 slot to the "
            f"card {copy_ms:.3f} ms, {gbps:.1f} GB/s ({card})")
        _reset_all_counts()
        ring = it.staging_ring(trainer=tr, loop=True)
        x, y = next(ring)
        losses = [tr.step(x, y)]
        drain = RECORD_IMAGES // RESNET_BATCH + 2 + 2 * 1
        for _ in range(drain):
            x, y = next(ring)
            losses.append(tr.step(x, y))
        torch.cuda.synchronize()
        stalls = []
        t0 = time.perf_counter()
        for _ in range(RECORD_STEPS):
            ts = time.perf_counter()
            x, y = next(ring)
            stalls.append(time.perf_counter() - ts)
            losses.append(tr.step(x, y))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / RECORD_STEPS
        ring.close()
        failures = pipe.decode_failures
        dev_ms, launches = log_profile(
            lambda: losses.append(tr.step(x, y)),
            f"one record-fed {RESNET_BATCH}x{RESNET_SIZE}x{RESNET_SIZE}x3 "
            f"uint8 training step", tag="[train-record]")
        it.close()
    losses = [v.asscalar() for v in losses]
    counts = _all_counts()
    if any(counts.values()):
        raise AssertionError(f"[train-record] launched hand kernels {counts}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"[train-record] losses {losses} not finite")
    if failures:
        raise AssertionError(f"[train-record] {failures} decode failures")
    stall_ms = 1e3 * sum(stalls) / len(stalls)
    log(f"[train-record] {1 + drain} warm-up steps (the pre-filled slots "
        f"drained), then {RECORD_STEPS} steps over endless epochs; losses "
        + ", ".join(f"{v:.4f}" for v in losses[::4]))
    log(f"[train-record] record-fed step {step_ms:.2f} ms "
        f"({RESNET_BATCH / step_ms * 1e3:.1f} images/s, host clock to a "
        f"synchronize) against [train-resnet]'s resident-batch step "
        f"{resident_step_ms:.2f} ms: vs_synthetic "
        f"{resident_step_ms / step_ms:.3f}; consumer stall in next() "
        f"{stall_ms:.2f} ms a step ({card})")
    log(f"[train-record] profiled step: {dev_ms:.2f} ms of device time in "
        f"{launches} launches; against the {step_ms:.2f} ms record-fed step "
        f"the device is idle {1 - dev_ms / step_ms:.3f} of the step; decode "
        f"failures 0; the decode workers are C++ threads of a library that "
        f"links no CUDA; no hand kernel launched; "
        f"{time.time() - t_start:.1f} s")
    del net, tr
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------
# the rest of serving: batch buckets, the chaos gates, the fleet
# ---------------------------------------------------------------------
BUCKETS = {T: (1, 2, 4, 8, 16, 32, 64), LONG_T: (1, 2, 4, 8)}
BUCKET_CAPACITY = {T: BH_BATCH, LONG_T: LONG_CAPACITY}
BUCKET_KERNEL = {T: "flash_short_fwd", LONG_T: "flash_fwd"}
# request sizes, sent one at a time: each bucket and the capacity is the
# pad target of at least one
BUCKET_REQUESTS = {T: (1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128),
                   LONG_T: (1, 2, 3, 4, 5, 8, 9, 16)}
BUCKET_LATENCY_REPEATS = 5
CHAOS_CAPACITY = 8
SERVE_MODEL = "bert_12_768_12"


def _bert_rows(rng, n, seqlen, vocab=30522):
    tokens = rng.randint(0, vocab, (n, seqlen)).astype(np.int32)
    types = rng.randint(0, 2, (n, seqlen)).astype(np.int32)
    valid = rng.randint(0, seqlen + 1, (n,)).astype(np.int32)
    valid[0] = seqlen
    if n > 2:
        valid[1] = 0
    return [tokens, types, valid]


def _bert_artifact(out, seqlen, capacity, seed, buckets=None, net=None):
    """BERT-base bf16 with seeded Normal(0.02) weights built on the card
    (or `net` again) and exported at `capacity`; returns (dir, net)."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import deploy
    from incubator_mxnet_torch.models import get_model
    if net is None:
        mx.seed(seed)
        net = get_model("bert_classifier", model_name=SERVE_MODEL,
                        num_classes=2, dropout=0.0, vocab_size=30522,
                        max_length=seqlen)
        net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
        net.cast("bfloat16")
    rows = _bert_rows(np.random.RandomState(seed), capacity, seqlen)
    deploy.export_serving(net, rows, out, batch_buckets=buckets)
    return out, net


def _bucket_kernel_check(fa, seqlen, batch, gen):
    """Row 1 (T = 128) or row 2 (T = 2048) against its plain version at
    `batch` x 12 batch-heads, bf16, non-causal as BERT's encoder calls
    it, kv_length random per row (0 and T among them from batch 2 on);
    returns its record, its bound counting the keys each row keeps."""
    bh, scale = batch * HEADS, D ** -0.5
    q, k, v = (torch.randn(bh, seqlen, D, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    per_row = torch.randint(0, seqlen + 1, (batch,), generator=gen,
                            device="cuda", dtype=torch.int32)
    per_row[0] = seqlen
    if batch > 1:
        per_row[1] = 0
    lengths = per_row.repeat_interleave(HEADS)
    if seqlen <= fa.MAX_SHORT_LEN:
        call = lambda: fa.flash_short_fwd(q, k, v, lengths, scale, False)
        plain = lambda: fa.flash_short_reference(q, k, v, lengths, scale,
                                                 False)
        out, ref = call(), plain()
        err = _max_err(out, ref)
        extra = ""
    else:
        blocks = (fa._fit_block(512, seqlen), fa._fit_block(1024, seqlen))
        call = lambda: fa.flash_fwd(q, k, v, lengths, scale, False, *blocks)
        plain = lambda: fa.flash_fwd_reference(q, k, v, lengths, scale,
                                               False, *blocks)
        (out, lse), (ref, rlse) = call(), plain()
        live = lengths > 0
        err = _max_err(out, ref)
        lse_err = _max_err(lse[live], rlse[live])
        if not (lse_err <= LSE_ATOL and torch.all(lse[~live] == -1e30)):
            raise AssertionError(f"flash_fwd lse disagrees at BH={bh}: "
                                 f"{lse_err} (atol {LSE_ATOL})")
        extra = f", lse {lse_err:.3e} (atol {LSE_ATOL})"
    torch.cuda.synchronize()
    if not (err <= ATOL[torch.bfloat16]
            and torch.isfinite(out.float()).all()):
        raise AssertionError(
            f"{BUCKET_KERNEL[seqlen]} disagrees with its plain version at "
            f"BH={bh} T={seqlen}: max|err|={err} > {ATOL[torch.bfloat16]}")
    ms = time_ms(call, iters=10)
    plain_ms = time_ms(plain, iters=3, warmup=1)
    # the work this run's data needs: each row's queries against the
    # keys its kv_length keeps
    nbytes = 4 * q.numel() * 2 + bh * 4
    work = 4 * seqlen * D * int(lengths.sum().item())
    bound_ms, bound_by = _bound(nbytes, work, torch.bfloat16)
    log(f"[serve-buckets] {BUCKET_KERNEL[seqlen]} bf16 BH={bh} (batch "
        f"{batch}) T={seqlen}: max|err|={err:.3e} (atol "
        f"{ATOL[torch.bfloat16]}){extra}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.1f}% of bound")
    return {"batch": batch, "bh": bh, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _pad_rows(arrays, target):
    return [np.concatenate([a, np.zeros((target - a.shape[0],)
                                        + a.shape[1:], a.dtype)])
            if a.shape[0] < target else a for a in arrays]


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _pad_histogram():
    from incubator_mxnet_torch import telemetry
    snap = telemetry.snapshot().get("serving_batch_pad_rows")
    vals = (snap or {}).get("values") or [{}]
    return dict(vals[0].get("buckets") or {}), vals[0].get("count", 0)


def _serve_buckets_case(card, seqlen, check_reload):
    """One bucketed path; returns (launch counts, kernel records)."""
    from incubator_mxnet_torch.ops import flash_attention as fa
    from incubator_mxnet_torch.serving import ServeConfig, ServingRuntime
    cap, buckets = BUCKET_CAPACITY[seqlen], BUCKETS[seqlen]
    kernel = BUCKET_KERNEL[seqlen]
    tag = f"[serve-buckets] T={seqlen}"
    gen = torch.Generator(device="cuda").manual_seed(19)
    recs = [_bucket_kernel_check(fa, seqlen, b, gen)
            for b in buckets + (cap,)]
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_buckets_")
    rts = []
    try:
        t0 = time.time()
        art, net = _bert_artifact(os.path.join(tmp, "art"), seqlen, cap, 0,
                                  buckets=list(buckets))
        del net
        cfg = dict(concurrency=1, queue_limit=64, batch_window_ms=0.0)
        rt = ServingRuntime(art, config=ServeConfig(**cfg))
        flat = ServingRuntime(art, config=ServeConfig(batch_buckets=0,
                                                      **cfg))
        rts = [rt, flat]
        port, flat_port = rt.start(0), flat.start(0)
        log(f"{tag} BERT-base bf16 exported with buckets {list(buckets)} "
            f"(capacity {cap}) and loaded twice, bucketed and flat, in "
            f"{time.time() - t0:.1f} s")
        rng = np.random.RandomState(7)
        reqs = [_bert_rows(rng, n, seqlen) for n in BUCKET_REQUESTS[seqlen]]
        hist0, count0 = _pad_histogram()
        fa.reset_launch_counts()
        calls0 = rt.model_calls
        got = []
        for req in reqs:
            status, payload, _ = _post(port, req)
            if status != 200:
                raise AssertionError(f"{tag} a request answered {status}")
            got.append(np.asarray(payload["outputs"][0], np.float32))
        bucketed = dict(fa.launch_counts)
        batches = rt.model_calls - calls0
        hist1, count1 = _pad_histogram()
        layers = len(rt._slot.model.block.bert.encoder.layers)
        want = {n: layers * batches if n == kernel else 0 for n in bucketed}
        if batches != len(reqs) or bucketed != want:
            raise AssertionError(
                f"{tag} expected {layers} {kernel} launches a batch and no "
                f"other kernel: {bucketed} for {batches} batches")
        fa.reset_launch_counts()
        calls0 = flat.model_calls
        flat_got = []
        for req in reqs:
            status, payload, _ = _post(flat_port, req)
            if status != 200:
                raise AssertionError(f"{tag} a flat request answered "
                                     f"{status}")
            flat_got.append(np.asarray(payload["outputs"][0], np.float32))
        flat_counts = dict(fa.launch_counts)
        flat_batches = flat.model_calls - calls0
        if flat_counts != {n: layers * flat_batches if n == kernel else 0
                           for n in flat_counts}:
            raise AssertionError(f"{tag} flat runtime launched "
                                 f"{flat_counts} in {flat_batches} batches")
        counts = {n: bucketed[n] + flat_counts[n] for n in bucketed}
        log(f"{tag} {len(reqs)} requests ({sum(BUCKET_REQUESTS[seqlen])} "
            f"rows) one at a time: {batches} bucketed batches launched "
            f"{bucketed[kernel]} {kernel}, {flat_batches} flat batches "
            f"{flat_counts[kernel]} ({layers} encoder layers), no other "
            f"kernel")
        deltas = {k: hist1.get(k, 0) - hist0.get(k, 0) for k in hist1}
        log(f"{tag} serving_batch_pad_rows of the bucketed batches "
            f"(cumulative, le -> count): {deltas} over {count1 - count0} "
            f"batches")

        # every bucketed row: bit for bit a direct call at its pad
        # target, close to the flat runtime's row and to einsum attention
        model = rt._slot.model
        block = model.block
        worst_flat = worst_ref = 0.0
        bitwise_flat = True
        for req, a, b in zip(reqs, got, flat_got):
            n = req[0].shape[0]
            target = next((k for k in buckets if k >= n), cap)
            direct = model.buckets.get(target, model)(
                *_pad_rows(req, target))[0][:n]
            if a.shape != (n, 2) or not np.isfinite(a).all():
                raise AssertionError(f"{tag} bad output {a.shape}")
            if a.tobytes() != np.asarray(direct, np.float32).tobytes():
                raise AssertionError(
                    f"{tag} a {n}-row request's rows differ from a direct "
                    f"call at its pad target {target}")
            worst_flat = max(worst_flat, float(np.abs(a - b).max()))
            bitwise_flat &= a.tobytes() == b.tobytes()
        os.environ["MXNET_FLASH_ATTENTION"] = "0"
        try:
            for req, a in zip(reqs, got):
                with torch.inference_mode():
                    ref = block(*[torch.from_numpy(x).cuda() for x in req])
                worst_ref = max(worst_ref, float(np.abs(
                    a - ref.float().cpu().numpy()).max()))
        finally:
            del os.environ["MXNET_FLASH_ATTENTION"]
        # the card gives every row of a batch the same bits at every
        # batch size (measured on an H100 at every bucket, T = 128 and
        # 2048), so the bucketed rows are held to the flat runtime's bit
        # for bit
        if not (bitwise_flat and worst_ref <= LOGIT_ATOL):
            raise AssertionError(
                f"{tag} bucketed logits differ from the flat runtime by "
                f"{worst_flat} (bitwise required) and from einsum attention "
                f"by {worst_ref} (atol {LOGIT_ATOL})")
        log(f"{tag} bucketed rows bit for bit a direct call at their pad "
            f"target; vs the flat runtime max|diff|={worst_flat:.3e} "
            f"(bitwise 0: {bitwise_flat}), vs einsum attention "
            f"{worst_ref:.3e} (atol {LOGIT_ATOL})")

        # per bucket: the device forward, and a request of that size
        for b in buckets + (cap,):
            req = _bert_rows(rng, b, seqlen)
            ts = [torch.from_numpy(x).cuda() for x in req]
            with torch.inference_mode():
                fwd_ms = time_ms(lambda: block(*ts), iters=5, warmup=1)
                kern_ms = device_ms(lambda: block(*ts), iters=5)
            lat = {}
            for name, p in (("bucketed", port), ("flat", flat_port)):
                lat[name] = _p50([_post(p, req)[2] for _ in
                                  range(BUCKET_LATENCY_REPEATS)]) * 1e3
            log(f"{tag} bucket {b}: {b}x{seqlen} forward {fwd_ms:.2f} ms "
                f"back to back on the device ({kern_ms:.2f} ms of it in "
                f"kernels); p50 of a {b}-row request {lat['bucketed']:.1f} "
                f"ms bucketed, {lat['flat']:.1f} ms flat (pads to {cap}) "
                f"({card})")

        if check_reload:
            from incubator_mxnet_torch.tools.serve_chaos import \
                corrupt_copy
            bad = corrupt_copy(art)
            try:
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                res = rt.reload(bad)
                torch.cuda.synchronize()
                after = torch.cuda.memory_allocated()
            finally:
                shutil.rmtree(os.path.dirname(bad), ignore_errors=True)
            status, payload, _ = _post(port, reqs[3])
            again = np.asarray(payload["outputs"][0], np.float32)
            if res["ok"] or "params.npz" not in res["error"] or \
                    after != before or status != 200 or \
                    again.tobytes() != got[3].tobytes():
                raise AssertionError(
                    f"{tag} corrupt reload: {res}, allocated {before} -> "
                    f"{after} bytes, outputs unchanged "
                    f"{again.tobytes() == got[3].tobytes()}")
            log(f"{tag} reload to a corrupt artifact rolled back: "
                f"{res['error'][:80]}...; allocated memory {before} -> "
                f"{after} bytes, outputs bit for bit unchanged")
    finally:
        for r in rts:
            r.close()
        del rts
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return counts, recs


def phase_serve_buckets(card):
    """Both bucketed paths; returns ({kernel: launches}, {kernel:
    [record per batch]})."""
    counts, recs = {}, {}
    for seqlen in (T, LONG_T):
        c, r = _serve_buckets_case(card, seqlen, check_reload=seqlen == T)
        kernel = BUCKET_KERNEL[seqlen]
        counts[kernel], recs[kernel] = c[kernel], r
    return counts, recs


def _run_tool(module, args, tag, timeout):
    """Run a chaos tool, echo its lines under `tag`; returns the JSON
    object of its last line."""
    cmd = [sys.executable, "-m", module, "--ctx", "gpu(0)", *args]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONPATH=HERE))
    lines = []
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            lines.append(line)
            log(f"{tag} {line}")
            if time.time() - t0 > timeout:
                break
        proc.wait(timeout=max(1.0, timeout - (time.time() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"{tag} {module} exited {proc.returncode}")
    return json.loads(lines[-1]), time.time() - t0


def _chaos_phase(card, tool, tag, same_weights, describe):
    """Export BERT-base bf16 at T = 128, capacity `CHAOS_CAPACITY`, twice
    (the second time from seed 1, or the same weights again), run the
    port's chaos tool `tool` on the two and log `describe` of its
    readings; returns them."""
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{tool}_")
    try:
        art_a, net = _bert_artifact(os.path.join(tmp, "a"), T,
                                    CHAOS_CAPACITY, 0)
        art_b, net = _bert_artifact(
            os.path.join(tmp, "b"), T, CHAOS_CAPACITY,
            0 if same_weights else 1, net=net if same_weights else None)
        del net
        torch.cuda.empty_cache()
        out, secs = _run_tool(f"incubator_mxnet_torch.tools.{tool}",
                              ["--artifact", art_a, "--artifact-b", art_b],
                              tag, 600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r = out[tool]
    log(f"{tag} BERT-base bf16 T={T} capacity {CHAOS_CAPACITY}: "
        f"{describe(r)}; the gate took {secs:.1f} s ({card})")
    return r


def phase_serve_chaos(card):
    return _chaos_phase(
        card, "serve_chaos", "[serve-chaos]", False, lambda r: (
            f"reload load+warm {r['reload_seconds']:.3f} s, breaker-open "
            f"503 in {r['breaker_503_ms']:.2f} ms, mid-flight SIGTERM "
            f"drained and exited in {r['drain_seconds']:.3f} s"))


def phase_fleet(card):
    return _chaos_phase(
        card, "fleet_chaos", "[fleet]", True, lambda r: (
            f"router over 3 replicas, {r['requests']} requests "
            f"({r['ok']} 200s, {r['shed']} sheds) in "
            f"{r['load_seconds']:.1f} s, {r['requests_per_s']:.1f} "
            f"requests/s, p50 {r['p50_ms']:.1f} ms, p99 "
            f"{r['p99_ms']:.1f} ms; rolling deploy "
            f"{r['deploy_seconds']:.2f} s"))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import incubator_mxnet_torch  # noqa: F401 — fails outside a checkout
    t_start = time.time()
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}: {card}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    rec = phase_kernels()
    train_rec = phase_train_kernels()
    stream_recs = phase_stream_kernels()
    bthd_recs = phase_bthd_kernels()
    # each path runs with the counts set to 0 just before it and is read
    # just after it
    serve, serve_ms = phase_serve(card, T, BH_BATCH, REQUEST_ROWS,
                                  N_SEQUENTIAL, "flash_short_fwd", "[serve]")
    serve_long, _ = phase_serve(card, LONG_T, LONG_CAPACITY,
                                LONG_REQUEST_ROWS, 2, "flash_fwd",
                                "[serve-long]")
    serve_bthd, serve_bthd_ms = _with_bthd(lambda: phase_serve(
        card, T, BH_BATCH, REQUEST_ROWS, N_SEQUENTIAL,
        "flash_short_bthd_fwd", "[serve-bthd]"))
    log(f"[serve-bthd] {BH_BATCH}x{T} forward {serve_bthd_ms:.2f} ms on the "
        f"BTHD route, {serve_ms:.2f} ms on the default route ([serve]) "
        f"({card})")
    train, train_ms = phase_train(card, TRAIN_BATCH, T, 10, 2,
                                  ("flash_short_fwd_train",), "[train]")
    train_long, _ = phase_train(card, LONG_TRAIN_BATCH, LONG_T, 5, 1,
                                ("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv"), "[train-long]")
    train_bthd, train_bthd_ms = _with_bthd(lambda: phase_train(
        card, TRAIN_BATCH, T, 5, 1,
        ("flash_short_bthd_fwd_train", "flash_short_bthd_bwd"),
        "[train-bthd]"))
    log(f"[train-bthd] {TRAIN_BATCH}x{T} step {train_bthd_ms:.2f} ms on the "
        f"BTHD route, {train_ms:.2f} ms on the default route ([train]) "
        f"({card})")
    bnb_recs, bnb_counts = phase_bottleneck(card)
    net, x, resident_step_ms = phase_train_resnet(card)
    phase_infer_resnet(card, net, x)
    del net, x
    torch.cuda.empty_cache()
    phase_resnet_check(card)
    rtc_recs, rtc_drive = phase_rtc(card)
    mlp_counts = phase_train_rtc(card)
    lenet_counts = phase_train_lenet(card)
    phase_rnn_check(card)
    phase_train_lstm(card)
    phase_lstm_example(card)
    phase_zoo_check(card)
    phase_infer_zoo(card)
    phase_train_zoo(card)
    phase_optim_check(card)
    phase_loss_check(card)
    lamb_launches, _ = phase_train_lamb(card)
    sparse_tr, sparse_batch, sparse_launches, _ = phase_train_sparse(card)
    ckpt_launches = phase_checkpoint(card, sparse_tr, sparse_batch)
    del sparse_tr, sparse_batch
    torch.cuda.empty_cache()
    ia_fwd, ia_train = phase_interleaved_attn(card)
    phase_ops_check(card)
    phase_detect_check(card)
    phase_train_ssd(card)
    phase_io_check(card)
    phase_train_loader(card, resident_step_ms)
    phase_estimator(card)
    phase_image_check(card)
    phase_train_record(card, resident_step_ms)
    bucket_counts, bucket_recs = phase_serve_buckets(card)
    phase_serve_chaos(card)
    phase_fleet(card)
    train_launches = train["flash_short_fwd_train"]
    log(f"[done] flash_short_fwd: {serve['flash_short_fwd']} launches "
        f"[serve], {ia_fwd} [interleaved-attn], "
        f"{bucket_counts['flash_short_fwd']} [serve-buckets]")
    log(f"[done] flash_short_fwd_train: {train_launches} launches [train], "
        f"{lamb_launches} [train-lamb], {sparse_launches} [train-sparse], "
        f"{ckpt_launches} [checkpoint], {ia_train} [interleaved-attn]")
    fa_py = "incubator_mxnet_tpu/ops/flash_attention.py"
    csrc = "incubator_mxnet_torch/csrc"
    short = {"route": "cuda", "source": f"{csrc}/flash_short_fwd.cu",
             "replaces": f"{fa_py}:290"}
    kernels = [{"name": "flash_short_fwd", **short,
                "launches": serve["flash_short_fwd"] + ia_fwd
                + bucket_counts["flash_short_fwd"], **rec,
                "buckets": bucket_recs["flash_short_fwd"]},
               {"name": "flash_short_fwd_train", **short,
                "launches": train_launches + lamb_launches + sparse_launches
                + ckpt_launches + ia_train, **train_rec}]
    for name, src, line in (("flash_fwd", "flash_fwd.cu", 55),
                            ("flash_bwd_dq", "flash_bwd.cu", 140),
                            ("flash_bwd_dkv", "flash_bwd.cu", 176)):
        launches = serve_long[name] + train_long[name] + \
            bucket_counts.get(name, 0)
        log(f"[done] {name}: {serve_long[name]} launches serving at T="
            f"{LONG_T}, {train_long[name]} training at T={LONG_T}"
            + (f", {bucket_counts[name]} [serve-buckets]"
               if name in bucket_counts else ""))
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{csrc}/{src}",
                        "replaces": f"{fa_py}:{line}", "launches": launches,
                        **stream_recs[name]})
        if name in bucket_recs:
            kernels[-1]["buckets"] = bucket_recs[name]
    # row 5 is one kernel in two forms: its entry carries the inference
    # form's numbers (serving) and, under "save_p", the training form's
    fwd_launches = (serve_bthd["flash_short_bthd_fwd"]
                    + train_bthd["flash_short_bthd_fwd_train"])
    log(f"[done] flash_short_bthd_fwd: {serve_bthd['flash_short_bthd_fwd']} "
        f"launches serving, {train_bthd['flash_short_bthd_fwd_train']} "
        f"training (save_p); flash_short_bthd_bwd: "
        f"{train_bthd['flash_short_bthd_bwd']} launches training, at T={T}")
    kernels.append({"name": "flash_short_bthd_fwd", **short,
                    "replaces": f"{fa_py}:417", "launches": fwd_launches,
                    **bthd_recs["flash_short_bthd_fwd"],
                    "save_p": {"launches": train_bthd[
                        "flash_short_bthd_fwd_train"],
                        **bthd_recs["flash_short_bthd_fwd_train"]}})
    kernels.append({"name": "flash_short_bthd_bwd", "route": "cuda",
                    "source": f"{csrc}/flash_short_bthd_bwd.cu",
                    "replaces": f"{fa_py}:443",
                    "launches": train_bthd["flash_short_bthd_bwd"],
                    **bthd_recs["flash_short_bthd_bwd"]})
    bnb_src = "tools/pallas_bottleneck_bwd.py"
    for name, line in (("bottleneck_bwd_reduce", 83),
                       ("bottleneck_bwd_apply", 110)):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{csrc}/bottleneck_bwd.cu",
                        "replaces": f"{bnb_src}:{line}",
                        "launches": bnb_counts[name], **bnb_recs[name]})
    # row 7: the softmax head's kernels count their launches on the two
    # training paths; axpy, on neither, counts the [rtc] user API drive
    for name, rec in rtc_recs.items():
        head = name.startswith("softmax")
        launches = mlp_counts.get(name, 0) + lenet_counts.get(name, 0) \
            if head else rtc_drive[name]
        log(f"[done] {name}: {launches} launches "
            + (f"({mlp_counts.get(name, 0)} [train-rtc], "
               f"{lenet_counts.get(name, 0)} [train-lenet])" if head
               else "([rtc] user API drive)"))
        kernels.append({"name": name, "route": "cuda",
                        "source": "incubator_mxnet_torch/softmax_rtc.py",
                        "replaces": "incubator_mxnet_tpu/rtc.py:42",
                        "launches": launches, **rec})
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
