#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. Device and build: the card's name and power limit (nvidia-smi), then
   every CUDA kernel of the port built from `incubator_mxnet_torch/csrc/`,
   one nvcc per source, all started together.
2. Kernels against their plain PyTorch versions at the serving shape
   (BH = 128*12, T = 128, d = 64), bfloat16 and float32, causal on and
   off, kv_length random with 0 and T among them: max error, kernel time,
   plain-version time, one PyTorch library call's time and the card's
   bound for the same work.
3. The main path: BERT-base (bert_12_768_12, T = 128) classifier in
   bfloat16 with seeded Normal(0.02) weights on cuda:0, exported with
   `deploy.export_serving` (capacity 128 rows), served by
   `serving.ServingRuntime` over HTTP on 127.0.0.1, answering 12 POST
   /predict requests of 1-64 rows (8 of them concurrent).  Every answer
   is checked against a direct forward of the same rows with plain
   attention on the card, and the kernel's launch counter must have
   risen by 12 (one per encoder layer) for each served batch.
4. The training kernel (the short kernel's `save_p` form, kernel row
   1b) against its plain version at the training shape (BH = 60*12,
   T = 128, d = 64), bfloat16 and float32, causal on and off, kv_length
   random with 0 and T among them: o and p, and dq, dk, dv of
   `FlashShort` against torch autograd through the plain version; the
   kernel's, the plain version's and the backward's times and the bound.
5. The training path: BERT-base classifier, dropout 0, seeded
   Normal(0.02) weights cast to bfloat16, Adam at lr 2e-5, a seeded
   batch of 60 x 128 tokens on cuda:0 (`bench.py`'s `bench_bert`).  Step
   1's loss and the gradients of layer 0's and layer 11's qkv weight on
   the kernel route against `MXNET_FLASH_ATTENTION=0` (einsum
   attention); then `ParallelTrainer.step` 3 times and `run_steps(10)`
   (timed with CUDA events), a by-kernel profile of one step, and 2
   iterations of the imperative `autograd.record()` / `backward()` /
   `gluon.Trainer(..., "adam", lr 2e-5).step(60)` loop.  Losses must be finite and the
   training kernel must launch 12 times (one per layer) per step, the
   inference kernel never.
6. A JSON line describing each kernel, then the card line, then the
   final `{"ok": true, ...}` line.

Exits non-zero, printing no result, without CUDA or outside a checkout
of the repository.
"""
import http.client
import json
import os
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

BH_BATCH, HEADS, T, D = 128, 12, 128, 64
TRAIN_BATCH, LAYERS = 60, 12
ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the saved p: float32 agrees to rounding; bfloat16 to one step below 1
P_ATOL = {torch.bfloat16: 2 ** -8, torch.float32: 1e-6}
# FlashShort's gradients against torch autograd through the plain
# version, relative to the largest reference gradient: the backward
# reads the bfloat16 p and rounds ds to bfloat16 where autograd through
# the plain version keeps both in float32
GRAD_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Step 1 of BERT-base bf16 on the kernel route against einsum attention:
# the einsum route rounds the scores to bfloat16 before the softmax
# where the kernel keeps them in float32, and the difference goes
# through 12 layers forward and back.  Loss: 1e-2 absolute (1.4% of
# ln 2, the loss at this initialization); gradients: 5e-2 relative
# (Frobenius norm of the difference over the einsum route's norm).
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
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
            if "registers" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")


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
            keep = torch.arange(T, device="cuda")[None, :] < \
                per_row[:, None]
            keep = keep[:, None, None, :]
            if causal:
                keep = keep & torch.ones(T, T, dtype=torch.bool,
                                         device="cuda").tril()
            add = torch.zeros(keep.shape, dtype=dtype, device="cuda")
            add.masked_fill_(~keep, -1e30)
            q4, k4, v4 = (t.view(BH_BATCH, HEADS, T, D) for t in (q, k, v))
            ms = time_ms(lambda: flash_short_fwd(q, k, v, lengths, scale,
                                                 causal))
            plain_ms = time_ms(lambda: flash_short_reference(
                q, k, v, lengths, scale, causal))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=add, scale=scale))
            nbytes = 4 * q.numel() * q.element_size() + lengths.numel() * 4
            bound_ms, bound_by = _bound(nbytes, 4 * bh * T * T * D, dtype)
            rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            records[(dtype, causal)] = rec
            log(f"[kernel] flash_short_fwd {str(dtype)[6:]} causal={causal} "
                f"BH={bh} T={T} d={D}: max|err|={err:.3e} "
                f"(atol {ATOL[dtype]}), kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({rec['bound_by']})")
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
            rec = {"max_abs_err": max(o_err, p_err), "ms": ms,
                   "plain_ms": plain_ms, "bwd_ms": bwd_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
            records[(dtype, causal)] = rec
            log(f"[kernel] flash_short_fwd_train {str(dtype)[6:]} "
                f"causal={causal} BH={bh} T={T} d={D}: o max|err|="
                f"{o_err:.3e} (atol {ATOL[dtype]}), p max|err|={p_err:.3e} "
                f"(atol {P_ATOL[dtype]:.3e}); FlashShort dq/dk/dv max|err| "
                f"{grad_errs['dq']:.3e}/{grad_errs['dk']:.3e}/"
                f"{grad_errs['dv']:.3e} (rtol {GRAD_RTOL[dtype]}); kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, backward "
                f"{bwd_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                f"library: no single PyTorch call returns p")
            del o, p, ro, rp, a, b, jax_rule
    return records[(torch.bfloat16, False)]


def phase_train(card):
    """The training path; returns the training kernel's launches."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import autograd, gluon, nd, parallel
    from incubator_mxnet_torch.models import get_model
    from incubator_mxnet_torch.ops import flash_attention as fa

    rng = np.random.RandomState(0)
    batch = [nd.array(a, ctx=mx.gpu(0)) for a in (
        rng.randint(0, 30522, (TRAIN_BATCH, T)).astype(np.float32),
        np.zeros((TRAIN_BATCH, T), np.float32),
        rng.randint(0, 2, TRAIN_BATCH).astype(np.float32))]
    t0 = time.time()
    mx.seed(0)
    net = get_model("bert_classifier", model_name="bert_12_768_12",
                    num_classes=2, dropout=0.0, vocab_size=30522,
                    max_length=T)
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
    log(f"[train] BERT-base bf16 {TRAIN_BATCH}x{T} built in "
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

    def checked(run, steps, what):
        before = dict(counts)
        lval = run()
        torch.cuda.synchronize()
        got = counts["flash_short_fwd_train"] - \
            before["flash_short_fwd_train"]
        infer = counts["flash_short_fwd"] - before["flash_short_fwd"]
        if got != layers * steps or infer != 0:
            raise AssertionError(
                f"{what}: {got} training and {infer} inference kernel "
                f"launches for {steps} step(s) of {layers} layers")
        if not np.isfinite(lval):
            raise AssertionError(f"{what}: loss {lval} is not finite")
        return lval

    losses = [checked(lambda: tr.step(*batch).asscalar(), 1,
                      f"step {i + 1}") for i in range(3)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    last = checked(lambda: tr.run_steps(10, *batch).asscalar(), 10,
                   "run_steps(10)")
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 10
    shown = ", ".join(f"{x:.4f}" for x in losses)
    log(f"[train] ParallelTrainer adam: losses {shown} "
        f"after steps 1-3, {last:.4f} after run_steps(10) (num_update "
        f"{tr.num_update}); {layers} flash_short_fwd_train launches per "
        f"step, none of flash_short_fwd")
    log(f"[train] step {step_ms:.2f} ms, "
        f"{TRAIN_BATCH * T / step_ms * 1e3:.0f} tokens/s over "
        f"run_steps(10) ({card})")
    log_profile(lambda: checked(lambda: tr.step(*batch).asscalar(), 1,
                                "profiled step"),
                f"one {TRAIN_BATCH}x{T} training step", tag="[train]")

    # the imperative loop on the same model
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 2e-5})
    for i in range(2):
        def iteration():
            with autograd.record():
                l = loss_of(net(*batch[:2]), batch[2])
            l.backward()
            trainer.step(TRAIN_BATCH)
            return float(l.asnumpy().mean())
        lval = checked(iteration, 1, f"imperative iteration {i + 1}")
        log(f"[train] imperative record/backward/gluon.Trainer.step "
            f"iteration {i + 1}: mean loss {lval:.4f}")
    launches = counts["flash_short_fwd_train"]
    if counts["flash_short_fwd"] != 0:
        raise AssertionError("the training path launched the inference "
                             "kernel")
    return launches


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


def log_profile(fn, what, tag="[profile]", top=12):
    """Device time of fn(), attributed to each kernel and to the host op
    that launched it (torch.profiler self device time)."""
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


def log_forward_profile(block, inputs):
    def fwd():
        with torch.inference_mode():
            block(*inputs)
    log_profile(fwd, f"one 128x{T} forward")


def phase_serve(card):
    """The main path; returns the kernel launches it made."""
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import deploy
    from incubator_mxnet_torch.models import get_model
    from incubator_mxnet_torch.ops import flash_attention as fa
    from incubator_mxnet_torch.serving import ServeConfig, ServingRuntime

    rng = np.random.RandomState(0)

    def rows(n):
        tokens = rng.randint(0, 30522, (n, T)).astype(np.int32)
        types = rng.randint(0, 2, (n, T)).astype(np.int32)
        valid = rng.randint(0, T + 1, (n,)).astype(np.int32)
        valid[0] = T
        if n > 2:
            valid[1] = 0
        return [tokens, types, valid]

    art = tempfile.mkdtemp(prefix="chip_smoke_artifact_")
    rt = None
    fa.reset_launch_counts()
    try:
        t0 = time.time()
        mx.seed(0)
        net = get_model("bert_classifier", model_name="bert_12_768_12",
                        num_classes=2, dropout=0.0, vocab_size=30522,
                        max_length=T)
        net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
        net.cast("bfloat16")
        deploy.export_serving(net, rows(128), art)
        del net
        rt = ServingRuntime(art, config=ServeConfig(
            concurrency=2, queue_limit=64, batch_window_ms=5.0))
        port = rt.start(0, "127.0.0.1")
        log(f"[serve] BERT-base bf16 built, exported and loaded in "
            f"{time.time() - t0:.1f} s; serving on 127.0.0.1:{port}")
        for path in ("/-/healthz", "/-/readyz"):
            status = _http(port, "GET", path)[0]
            if status != 200:
                raise AssertionError(f"{path} answered {status}")

        reqs = [rows(n) for n in REQUEST_ROWS]
        results = [None] * len(reqs)
        launches0 = fa.launch_counts["flash_short_fwd"]
        calls0 = rt.model_calls
        t_req = time.perf_counter()
        for i in range(N_SEQUENTIAL):
            results[i] = _post(port, reqs[i])
        errors = []

        def send(i):
            try:
                results[i] = _post(port, reqs[i])
            except Exception as e:   # noqa: BLE001 — re-raised below
                errors.append(e)
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(N_SEQUENTIAL, len(reqs))]
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
        launched = fa.launch_counts["flash_short_fwd"] - launches0
        block = rt._slot.model.block
        layers = len(block.bert.encoder.layers)     # one launch each
        log(f"[serve] {len(reqs)} requests ({sum(REQUEST_ROWS)} rows) in "
            f"{batches} batch(es); flash_short_fwd launches {launched} "
            f"({layers} encoder layers)")
        if batches < 1 or launched != layers * batches:
            raise AssertionError(
                f"expected {layers} kernel launches per batch: "
                f"{launched} launches for {batches} batches")

        # the same rows through the loaded block with plain attention
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
        tok_s = sum(REQUEST_ROWS) * T / wall
        log(f"[serve] served logits vs direct forward (plain attention): "
            f"max|err|={worst:.3e} (atol {LOGIT_ATOL})")
        log(f"[serve] p50 request latency {p50:.1f} ms, {tok_s:.0f} "
            f"tokens/s over {wall:.2f} s ({card})")
        main_launches = fa.launch_counts["flash_short_fwd"]
        if fa.launch_counts["flash_short_fwd_train"] != 0:
            raise AssertionError("serving launched the training kernel")

        # where a request's time goes: one full 128-row batch through the
        # loaded model, on the device alone and through the numpy call
        full = rows(128)
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
        log(f"[serve] 128x{T} batch: forward {fwd_ms:.2f} ms on the device "
            f"({layers} x flash_short_fwd), {plain_fwd_ms:.2f} ms with "
            f"plain attention; numpy-in/numpy-out model call {call_ms:.2f} "
            f"ms ({card})")
        log_forward_profile(block, ts)
    finally:
        if rt is not None:
            rt.close()
        shutil.rmtree(art, ignore_errors=True)
    return main_launches


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
    launches = phase_serve(card)
    train_launches = phase_train(card)
    source = {"route": "cuda",
              "source": "incubator_mxnet_torch/csrc/flash_short_fwd.cu",
              "replaces": "incubator_mxnet_tpu/ops/flash_attention.py:290"}
    kernels = [{"name": "flash_short_fwd", **source, "launches": launches,
                **rec},
               {"name": "flash_short_fwd_train", **source,
                "launches": train_launches, **train_rec}]
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
