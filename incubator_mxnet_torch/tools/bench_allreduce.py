#!/usr/bin/env python
"""Gradient-exchange benchmark of the port's kvstore (counterpart of the
repository's `tools/bench_allreduce.py`).

Runs the exchange legs over real loopback kvstore servers (threads of
this process) on a BERT-shaped parameter set (~200 tensors, most tiny),
with `--workers` workers (threads, each its own `KVStoreDist`) whose
gradients live on `--ctx` (the card by default, so every push leaves
it through the page-locked staging copy):

- per-key: one blocking pushpull per parameter;
- bucketed: the gradients packed into MXNET_KV_BUCKET_KB flat buckets
  and moved by the pipelined multi-key ops (wire round trips from the
  ``kvstore_wire_messages`` counter, per worker);
- sequential and streamed overlap: a "backward" span producing the
  gradients with the exchange after it, then the `BucketStream` of
  ``MXNET_KV_OVERLAP=1`` posting each bucket inside the span; the
  overlap fraction is |wire ∩ backward| / |wire| from the trace;
- ZeRO over 2 servers: unsharded (ZERO=0, allreduce and a worker-side
  SGD update), ZeRO-1 (the same with byte-balanced placement), ZeRO-2
  (each bucket to its owner, the server updates, workers pull weights)
  and ZeRO-2 streamed; the weights of every leg are compared bit for
  bit, with owned-byte skew and gradient wire bytes per step.  The
  fleet-fold (live rebalancing) leg is ROADMAP item 10b: ``--fold``
  raises.

``--smoke`` fails unless bucketed moves >= 5x fewer round trips with
results identical to per-key, the streamed leg overlaps >= 0.5 with
results identical to the unstreamed one, the ZeRO legs are identical
with owned-byte skew <= 1.2, ZeRO-2 holds no worker-side optimizer
state and its gradient wire is <= 0.55x ZeRO-1's.  It scales the
shapes down unless ``--bert-base`` keeps BERT-base's.

Usage:
  python -m incubator_mxnet_torch.tools.bench_allreduce --smoke [--ctx cpu]
  python -m incubator_mxnet_torch.tools.bench_allreduce --smoke \\
      --bert-base --workers 2 --dtype bfloat16 --steps 1
"""
import argparse
import json
import os
import socket
import sys
import threading
import time

os.environ.setdefault("MXNET_TELEMETRY", "1")


def bert_param_shapes(hidden=768, layers=12, vocab=30522, seq=512,
                      intermediate=None):
    """The BERT-base parameter census: ~199 tensors, most of them small
    (biases and layernorm vectors)."""
    inter = intermediate or 4 * hidden
    shapes = [(vocab, hidden), (seq, hidden), (2, hidden),
              (hidden,), (hidden,)]
    for _ in range(layers):
        for _ in range(4):
            shapes += [(hidden, hidden), (hidden,)]
        shapes += [(hidden,), (hidden,)]
        shapes += [(inter, hidden), (inter,)]
        shapes += [(hidden, inter), (hidden,)]
        shapes += [(hidden,), (hidden,)]
    shapes += [(hidden, hidden), (hidden,)]
    return shapes


def _counter_total(name):
    from incubator_mxnet_torch import telemetry
    fam = telemetry.REGISTRY.get(name)
    if fam is None:
        return 0.0
    return sum(child.value for _, child in fam._collect())


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(fn, n):
    """fn(rank) on n threads; re-raises the first failure."""
    errs = []

    def wrap(r):
        try:
            fn(r)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=30522)
    ap.add_argument("--intermediate", type=int, default=None)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--bucket-kb", type=int, default=None,
                    help="override MXNET_KV_BUCKET_KB for the run")
    ap.add_argument("--inflight", type=int, default=None,
                    help="override MXNET_KV_INFLIGHT for the run")
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down shapes (unless --bert-base) and "
                         "the pass/fail gates")
    ap.add_argument("--bert-base", action="store_true",
                    help="keep BERT-base's shapes under --smoke")
    ap.add_argument("--fold", action="store_true",
                    help="the live fleet-fold leg (ROADMAP item 10b)")
    ap.add_argument("--grads", default=None,
                    help="a directory of grads-<rank>.pt files (lists of "
                         "tensors, one per worker): exchange these "
                         "instead of the BERT census's random ones")
    ap.add_argument("--json-out", default=None,
                    help="also write the report to this file")
    args = ap.parse_args(argv)
    if args.fold:
        from incubator_mxnet_torch.base import MXNetError
        raise MXNetError("bench_allreduce --fold: live ZeRO-2 fleet "
                         "rebalancing is ROADMAP item 10b, not ported yet")
    if args.smoke:
        if not args.bert_base:
            args.hidden, args.vocab, args.intermediate = 256, 8192, 1024
        args.steps = min(args.steps, 2)
    if args.bucket_kb is not None:
        os.environ["MXNET_KV_BUCKET_KB"] = str(args.bucket_kb)
    if args.inflight is not None:
        os.environ["MXNET_KV_INFLIGHT"] = str(args.inflight)
    report = run(args)
    print(json.dumps(report))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f)
    print(json.dumps({"metric": "allreduce_overlap_fraction",
                      "value": report["overlap_streamed"][
                          "overlap_fraction"]}))
    print(json.dumps({"metric": "allreduce_zero_skew",
                      "value": report["zero"]["zero2"]["owned_skew"]}))
    print(json.dumps({"metric": "allreduce_push_mb",
                      "value": report["zero"]["zero2"][
                          "grad_wire_mb_per_step"]}))
    if args.smoke:
        fails = smoke_failures(report)
        for f in fails:
            print(f"SMOKE FAIL: {f}", file=sys.stderr)
        if fails:
            return 1
        z = report["zero"]
        print(f"allreduce-smoke OK: {report['roundtrip_ratio']:.1f}x "
              f"fewer round-trips, bitwise identical, overlap fraction "
              f"{report['overlap']['overlap_fraction']:.3f} -> "
              f"{report['overlap_streamed']['overlap_fraction']:.3f} "
              f"streamed, zero skew {z['zero2']['owned_skew']:.3f}, grad "
              f"wire {z['zero1']['grad_wire_mb_per_step']:.1f} -> "
              f"{z['zero2']['grad_wire_mb_per_step']:.1f} MB/step")
    return 0


def smoke_failures(report):
    """The --smoke gates: a list of what failed (empty = pass)."""
    out = []
    z = report["zero"]
    if not report["bitwise_identical"]:
        out.append("bucketed result differs from per-key")
    if report["roundtrip_ratio"] < 5.0:
        out.append(f"round-trip ratio {report['roundtrip_ratio']:.1f} "
                   f"< 5x")
    if report["overlap"]["wire_seconds"] <= 0:
        out.append("traced leg recorded no wire spans")
    if not report["streamed_bitwise_identical"]:
        out.append("streamed (MXNET_KV_OVERLAP) result differs from the "
                   "non-overlapped leg")
    if report["overlap_streamed"]["overlap_fraction"] < 0.5:
        out.append(f"streamed overlap fraction "
                   f"{report['overlap_streamed']['overlap_fraction']:.3f}"
                   f" < 0.5")
    if not z["bitwise_identical_across_legs"]:
        out.append("the ZeRO legs are not bitwise identical")
    if z["zero2"]["owned_skew"] > 1.2:
        out.append(f"ZeRO owned-byte skew {z['zero2']['owned_skew']:.3f} "
                   f"> 1.2")
    if z["zero2"]["worker_state_bytes"] != 0:
        out.append("worker holds optimizer state on the ZeRO-2 path")
    if z["zero1"]["worker_state_bytes"] == 0:
        out.append("the ZeRO-1 leg reports no worker-side optimizer "
                   "state")
    gw1 = z["zero1"]["grad_wire_mb_per_step"]
    gw2 = z["zero2"]["grad_wire_mb_per_step"]
    if not gw1 or gw2 > 0.55 * gw1:
        out.append(f"ZeRO-2 gradient wire {gw2:.2f} MB/step > 0.55x "
                   f"ZeRO-1's ({gw1:.2f})")
    return out


def run(args):
    import torch
    from incubator_mxnet_torch import tracing
    from incubator_mxnet_torch import optimizer as mxopt
    from incubator_mxnet_torch.context import cpu, gpu, as_device
    from incubator_mxnet_torch.ndarray import NDArray
    from incubator_mxnet_torch.kvstore import zero as kvzero
    from incubator_mxnet_torch.kvstore.dist import KVStoreDist, _Server
    from incubator_mxnet_torch.kvstore.bucket import GradientBucketer

    dev = as_device(cpu() if args.ctx == "cpu" else gpu(0))
    dt = getattr(torch, args.dtype)
    nw = args.workers
    if args.grads:
        grads_host = [torch.load(os.path.join(args.grads,
                                              f"grads-{r}.pt"))
                      for r in range(nw)]
        dt = grads_host[0][0].dtype
        args.dtype = str(dt).replace("torch.", "")
        shapes = [tuple(g.shape) for g in grads_host[0]]
    else:
        shapes = bert_param_shapes(args.hidden, args.layers, args.vocab,
                                   intermediate=args.intermediate)
        gens = [torch.Generator().manual_seed(1000 + r)
                for r in range(nw)]
        grads_host = [[(torch.randn(sh, generator=gens[r]) * 1e-2).to(dt)
                       for sh in shapes] for r in range(nw)]
    items = [(i, sh, args.dtype) for i, sh in enumerate(shapes)]
    nbytes = sum(g.numel() * g.element_size() for g in grads_host[0])

    def on_dev(r):
        return [NDArray(g.to(dev)) for g in grads_host[r]]

    def fleet(servers=1):
        """Start `servers` servers for nw workers; returns them."""
        srvs = [_Server(_free_port(), num_workers=nw, sync=True)
                for _ in range(servers)]
        for s in srvs:
            threading.Thread(target=s.serve_forever, daemon=True).start()
        os.environ["DMLC_NUM_WORKER"] = str(nw)
        os.environ["DMLC_NUM_SERVER"] = str(servers)
        os.environ["MXNET_KVSTORE_SERVER_ADDRS"] = ",".join(
            f"127.0.0.1:{s.port}" for s in srvs)
        return srvs

    def kvs():
        out = []
        for r in range(nw):
            kv = KVStoreDist("dist_sync")
            kv._rank = r
            out.append(kv)
        return out

    def timed_steps(fn):
        """Warm-up step, then `steps` timed steps of fn(rank) on every
        worker; returns (round trips per worker-step, seconds a step)."""
        _run_workers(fn, nw)
        rt0, t0 = _counter_total("kvstore_wire_messages"), \
            time.perf_counter()
        for _ in range(args.steps):
            _run_workers(fn, nw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) / args.steps
        rts = (_counter_total("kvstore_wire_messages") - rt0) \
            / args.steps / nw
        return rts, wall

    def stop(srvs, stores):
        for kv in stores:
            kv.close()
        for s in srvs:
            s.stop()

    # -- per-key leg -------------------------------------------------------
    srvs = fleet()
    kv_pk = kvs()
    grads_pk = [on_dev(r) for r in range(nw)]

    def init_keys(r):
        for i, sh in enumerate(shapes):
            kv_pk[r].init(i, NDArray(torch.zeros(sh, dtype=dt)))

    _run_workers(init_keys, nw)

    def per_key(r):
        for i, g in enumerate(grads_pk[r]):
            kv_pk[r].pushpull(i, g, out=g)

    pk_rts, pk_wall = timed_steps(per_key)
    stop(srvs, kv_pk)

    # -- bucketed leg ------------------------------------------------------
    srvs = fleet()
    kv_bk = kvs()
    bk = [GradientBucketer(kv, items) for kv in kv_bk]
    grads_bk = [on_dev(r) for r in range(nw)]
    bk_rts, bk_wall = timed_steps(lambda r: bk[r].allreduce(grads_bk[r]))
    stop(srvs, kv_bk)

    # -- traced overlap legs -----------------------------------------------
    def measure_overlap(step):
        tracing.reset()
        tracing.set_enabled(True)
        for _ in range(max(1, args.steps)):
            _run_workers(step, nw)
        tracing.set_enabled(False)
        sps = tracing.spans()
        wire = [s for s in sps if s.name.startswith("wire.")
                and s.name != "wire.frame"]
        bwd = [s for s in sps if s.name == "backward"]
        out = {"wire_seconds": round(sum(s.duration for s in wire), 6),
               "backward_seconds": round(sum(s.duration for s in bwd), 6),
               "overlap_fraction": round(
                   tracing.overlap_fraction(wire, bwd), 4)}
        tracing.reset()
        return out

    def touch(g):
        """Stand-in for producing one gradient: a pass over it and a
        wait for it."""
        (g._data * 1.0).sum().item()

    srvs = fleet()
    kv_tr = kvs()
    bk_tr = [GradientBucketer(kv, items) for kv in kv_tr]
    grads_tr = [on_dev(r) for r in range(nw)]

    def sequential(r):
        with tracing.step_span():
            with tracing.span("backward"):
                for g in reversed(grads_tr[r]):
                    touch(g)
            bk_tr[r].allreduce(grads_tr[r])

    overlap = measure_overlap(sequential)
    stop(srvs, kv_tr)

    srvs = fleet()
    kv_ov = kvs()
    bk_ov = [GradientBucketer(kv, items) for kv in kv_ov]
    grads_ov = [on_dev(r) for r in range(nw)]
    _run_workers(lambda r: bk_ov[r].allreduce(grads_ov[r]), nw)

    def streamed(r):
        with tracing.step_span():
            stream = bk_ov[r].stream(lambda j: grads_ov[r][j])
            if stream is None:
                raise RuntimeError("kvstore offered no stream")
            stream.on_backward()
            with tracing.span("backward"):
                for j in reversed(range(len(shapes))):
                    touch(grads_ov[r][j])
                    stream.ready(j)
            stream.finish(grads_ov[r])

    overlap_streamed = measure_overlap(streamed)
    stop(srvs, kv_ov)
    # the streamed leg ran steps + 1 exchanges (warm-up included), the
    # bucketed leg steps + 1 too: identical inputs, identical counts
    streamed_identical = all(
        torch.equal(a._data.cpu(), b._data.cpu())
        for r in range(nw) for a, b in zip(grads_ov[r], grads_bk[r]))

    # -- ZeRO legs -----------------------------------------------------------
    ZLR, ZMOM = 0.05, 0.9

    def wire_mb():
        return (_counter_total("kvstore_push_bytes") / 1e6,
                _counter_total("kvstore_pull_bytes") / 1e6)

    def zero_leg(level, steps=2, streamed=False):
        os.environ["MXNET_KV_ZERO"] = str(level)
        srvs = fleet(2)
        stores = kvs()
        server_update = level >= 2
        if server_update:
            _run_workers(lambda r: stores[r].set_optimizer(
                mxopt.SGD(learning_rate=ZLR, momentum=ZMOM)), nw)
        updaters = [None if server_update else mxopt.get_updater(
            mxopt.SGD(learning_rate=ZLR, momentum=ZMOM))
            for _ in range(nw)]
        bks = [GradientBucketer(kv, items) for kv in stores]
        weights = [[NDArray(torch.zeros(sh, dtype=dt)) for sh in shapes]
                   for _ in range(nw)]
        if server_update:
            _run_workers(lambda r: bks[r].init(weights[r]), nw)
        grads = [on_dev(r) for r in range(nw)]
        push0, pull0 = wire_mb()
        gradpull = [0.0]

        def one(r):
            if server_update:
                if streamed:
                    stream = bks[r].stream(lambda j: grads[r][j])
                    stream.on_backward()
                    for j in reversed(range(len(shapes))):
                        stream.ready(j)
                    stream.finish(weights[r])
                else:
                    bks[r].push(grads[r])
                    bks[r].pull(weights[r])
            else:
                merged = [NDArray(g._data.clone()) for g in grads[r]]
                bks[r].allreduce(merged)
                if r == 0:
                    # the pull carried the reduced gradients back
                    gradpull[0] += nbytes / 1e6
                # the worker update runs on the host, as the server's
                for i, (g, w) in enumerate(zip(merged, weights[r])):
                    updaters[r](i, NDArray(g._data.cpu()), w)

        for _ in range(steps):
            _run_workers(one, nw)
        push_mb, pull_mb = wire_mb()
        push_mb = (push_mb - push0) / steps / nw
        pull_mb = (pull_mb - pull0) / steps / nw
        out = {
            "push_mb_per_step": round(push_mb, 2),
            "pull_mb_per_step": round(pull_mb, 2),
            "grad_wire_mb_per_step": round(
                push_mb + gradpull[0] / steps, 2),
            "owned_bytes": [s.owned_bytes() for s in srvs],
            "state_bytes": [s.state_bytes() for s in srvs],
            "owned_shards": [s._owned_shard_count for s in srvs],
            "worker_state_bytes": (updaters[0].state_nbytes()
                                   if updaters[0] is not None else 0),
        }
        out["owned_skew"] = round(kvzero.byte_skew(out["owned_bytes"]), 4)
        out["state_skew"] = round(kvzero.byte_skew(out["state_bytes"]), 4)
        final = [w._data.clone() for w in weights[0]]
        same = all(torch.equal(a._data, b._data) for r in range(1, nw)
                   for a, b in zip(weights[0], weights[r]))
        stop(srvs, stores)
        os.environ.pop("MXNET_KV_ZERO", None)
        return out, final, same

    z0, w0, s0 = zero_leg(0)
    z1, w1, s1 = zero_leg(1)
    z2, w2, s2 = zero_leg(2)
    z2s, w2s, s2s = zero_leg(2, streamed=True)
    zero_identical = s0 and s1 and s2 and s2s and all(
        torch.equal(w0[i], w1[i]) and torch.equal(w0[i], w2[i])
        and torch.equal(w0[i], w2s[i]) for i in range(len(w0)))

    identical = all(torch.equal(a._data.cpu(), b._data.cpu())
                    for r in range(nw)
                    for a, b in zip(grads_pk[r], grads_bk[r]))
    ratio = pk_rts / bk_rts if bk_rts else float("inf")
    return {
        "params": len(shapes), "workers": nw, "device": str(dev),
        "dtype": args.dtype,
        "payload_mb": round(nbytes / 1e6, 1),
        "buckets": len(bk[0].plan),
        "bucket_kb": int(os.environ.get("MXNET_KV_BUCKET_KB", "4096")),
        "inflight": int(os.environ.get("MXNET_KV_INFLIGHT", "8")),
        "per_key": {"roundtrips_per_step": pk_rts,
                    "step_seconds": round(pk_wall, 4)},
        "bucketed": {"roundtrips_per_step": bk_rts,
                     "step_seconds": round(bk_wall, 4)},
        "roundtrip_ratio": round(ratio, 1),
        "bitwise_identical": identical,
        "overlap": overlap,
        "overlap_streamed": overlap_streamed,
        "streamed_bitwise_identical": streamed_identical,
        "zero": {"servers": 2,
                 "bitwise_identical_across_legs": zero_identical,
                 "unsharded": z0, "zero1": z1, "zero2": z2,
                 "zero2_streamed": z2s},
    }


if __name__ == "__main__":
    sys.exit(main())
