"""Where the input path's time goes at ResNet-50's 224² batch, on the card's
host: the parts of `[train-loader]` (chip_smoke.py) timed one by one.

    python3 experiments/loader_feed.py [--workers N]

A measurement script, not part of the package.  It prints, beside the
card's name and power limit and `os.cpu_count()`:

- the wall seconds for 1 and for N fresh interpreters, started at once,
  to import torch and `incubator_mxnet_torch` (what a spawned DataLoader
  worker does before its first item);
- the wall seconds to spawn the DataLoader's pool of N workers and run
  a first one-item task on each, from this process before it has
  touched the card and again after (a CUDA context and page-locked
  memory in the parent), with the parent's virtual size each time;
- one `SyntheticImageDataset(2048, (3, 224, 224))` item in this process
  under `cpu()` with one torch thread, in ms, and its parts: the
  150,528 normals (float64), their float32 sum with the template, and
  the NDArray copy;
- one 256-item batch's `default_batchify_fn`, and the whole batch as a
  worker makes it (items, batchify, the write into POSIX shared
  memory), in ms;
- the parent's read of that segment into page-locked memory, first and
  later (the caching host allocator reuses the block), and into
  pageable memory, in ms;
- the page-locked batch's copy to the card, in ms (CUDA events);
- inside N spawned workers running at once (the DataLoader's own worker
  functions), each worker's mean ms an item and its whole 64-item
  batch.

Each figure is the median of its repeats.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SHAPE, BATCH = (3, 224, 224), 256


def _median_ms(fn, repeats=5):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _import_seconds(n):
    """Wall seconds for `n` fresh interpreters, started together, to
    import torch and the port."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=HERE)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import torch, incubator_mxnet_torch"],
                              env=env) for _ in range(n)]
    for p in procs:
        if p.wait(timeout=600) != 0:
            raise RuntimeError("an interpreter failed to import the port")
    return time.perf_counter() - t0


def _vm_gb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmSize:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def _spawn_pool(dl, ds, workers):
    """A DataLoader's spawned pool (its own `_get_pool`), and the wall
    seconds to make it and until every worker has run a one-item task."""
    loader = dl.DataLoader(ds, BATCH, num_workers=workers)
    t0 = time.perf_counter()
    pool = loader._get_pool()
    created = time.perf_counter() - t0
    pool.map(_worker_items, [[0]] * workers, chunksize=1)
    return loader, pool, created, time.perf_counter() - t0


def _worker_items(indices):
    """Runs in a spawned worker: mean ms an item, and the ms of the
    whole batch as a worker makes it (the items again, batchify, the
    shared-memory write)."""
    from incubator_mxnet_torch.gluon.data import dataloader as dl
    ds = dl._WORKER["dataset"]
    t0 = time.perf_counter()
    for i in indices:
        ds[i]
    t1 = time.perf_counter()
    result = dl._mp_worker_batch(indices)
    t2 = time.perf_counter()
    dl._discard_shm_batch(result)
    return (t1 - t0) * 1e3 / len(indices), (t2 - t1) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count()))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("loader_feed: CUDA is not available", file=sys.stderr)
        return 2
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import nd
    from incubator_mxnet_torch.gluon.data import dataloader as dl
    from incubator_mxnet_torch.gluon.data.vision import SyntheticImageDataset
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[feed] {card}; os.cpu_count() = {os.cpu_count()}; torch "
          f"{torch.__version__}", flush=True)
    print(f"[feed] import torch + the port: 1 interpreter "
          f"{_import_seconds(1):.2f} s, {args.workers} at once "
          f"{_import_seconds(args.workers):.2f} s", flush=True)

    ds = SyntheticImageDataset(2048, SHAPE)
    vm = _vm_gb()
    loader, _, created, ready = _spawn_pool(dl, ds, args.workers)
    loader.close()
    print(f"[feed] spawn {args.workers} workers before the card is "
          f"touched (parent {vm:.1f} GB virtual): Pool() {created:.2f} s, "
          f"every worker done with a first task {ready:.2f} s", flush=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    with mx.cpu():
        item = _median_ms(lambda: [ds[i] for i in range(32)]) / 32
        normals = _median_ms(lambda: rng.normal(0, 0.15, SHAPE))
        noise = rng.normal(0, 0.15, SHAPE)
        tsum = _median_ms(lambda: ds._templates[0] + noise.astype(np.float32))
        img = ds._templates[0] + noise.astype(np.float32)
        copy = _median_ms(lambda: nd.array(img))
        items = [ds[i] for i in range(BATCH)]
        batchify = _median_ms(lambda: dl.default_batchify_fn(items), 3)
    print(f"[feed] one 224^2 item in this process (1 torch thread): "
          f"{item:.2f} ms; its normals {normals:.2f} ms, float32 sum "
          f"{tsum:.2f} ms, NDArray copy {copy:.2f} ms; a {BATCH}-batch's "
          f"batchify {batchify:.1f} ms", flush=True)

    dl._WORKER["dataset"], dl._WORKER["batchify"] = ds, \
        dl.default_batchify_fn
    idx = list(range(BATCH))
    write, reads = [], {True: [], False: []}
    for k in range(4):
        with mx.cpu():
            t0 = time.perf_counter()
            result = dl._mp_worker_batch(idx)
            write.append((time.perf_counter() - t0) * 1e3)
        pin = k % 2 == 0
        t0 = time.perf_counter()
        batch = dl._read_shm_batch(result, pin)
        reads[pin].append((time.perf_counter() - t0) * 1e3)
        if pin:
            x = batch[0].data
    torch.set_num_threads(threads)
    dev = torch.device("cuda", 0)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    h2d = []
    for _ in range(5):
        start.record()
        x.to(dev, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        h2d.append(start.elapsed_time(end))
    nbytes = x.numel() * x.element_size()
    print(f"[feed] a {BATCH}-batch ({nbytes / 1e6:.1f} MB) as a worker "
          f"makes it (items, batchify, shared-memory write) "
          f"{statistics.median(write):.1f} ms (first {write[0]:.1f}); the "
          f"parent's read into page-locked "
          f"memory {reads[True][0]:.1f} ms first, "
          f"{reads[True][1]:.1f} ms again; into pageable memory "
          f"{statistics.median(reads[False]):.1f} ms; the page-locked "
          f"copy to the card {statistics.median(h2d):.2f} ms "
          f"({nbytes / statistics.median(h2d) / 1e6:.1f} GB/s)", flush=True)

    vm = _vm_gb()
    loader, pool, created, ready = _spawn_pool(dl, ds, args.workers)
    t0 = time.perf_counter()
    out = pool.map(_worker_items, [list(range(w * 64, w * 64 + 64))
                                   for w in range(args.workers)],
                   chunksize=1)
    wall = time.perf_counter() - t0
    loader.close()
    per_item = [o[0] for o in out]
    print(f"[feed] spawn {args.workers} workers after the card's copies "
          f"(parent {vm:.1f} GB virtual): Pool() {created:.2f} s, every "
          f"worker done with a first task {ready:.2f} s; then 64 items "
          f"and a 64-item batch each, "
          f"at once, in {wall:.2f} s: {statistics.median(per_item):.2f} ms "
          f"an item (range {min(per_item):.2f}-{max(per_item):.2f}), the "
          f"whole batch {statistics.median(o[1] for o in out):.1f} ms "
          f"({card})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
