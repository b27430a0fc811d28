#!/usr/bin/env python
"""Allreduce bandwidth over the device mesh (counterpart of the
repository's `tools/bandwidth.py`).

Times `parallel.collectives.allreduce` over the 'dp' axis of
`make_mesh()` across message sizes (the JAX tool's sizes by default)
and prints each size's time and algorithm bandwidth (payload bytes over
time; a ring allreduce moves 2(n-1)/n of that per link).  The world is
the process group this process joins: the DMLC_* contract under
`incubator_mxnet_torch.tools.launch`, else a world of one rank, whose
collective still goes through the backend (NCCL on the card, gloo with
``--ctx cpu``).

Usage:
  python -m incubator_mxnet_torch.tools.bandwidth [--sizes 1,4] [--iters 10]
  python -m incubator_mxnet_torch.tools.launch -n 2 -s 0 \\
      python -m incubator_mxnet_torch.tools.bandwidth --transport host
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import time


def measure(sizes_mb, iters=10, ctx=None):
    """[(size MB, ms, GB/s)] of one allreduce per size."""
    import torch
    from ..context import as_device
    from ..parallel import collectives as C
    from ..parallel.mesh import make_mesh
    mesh = make_mesh(ctx=ctx)
    dev = as_device(ctx)
    n = mesh.axis_size("dp")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    print(f"devices: {n} x {name}")
    rows = []
    for mb in sizes_mb:
        elems = max(int(mb * (1 << 20) // 4), 1)
        x = torch.zeros(elems, dtype=torch.float32, device=dev)
        r = C.allreduce(x, "dp", mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            r = C.allreduce(x, "dp", mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        float(r[0])
        dt = (time.perf_counter() - t0) / iters
        gbps = mb / 1024 / dt
        rows.append((mb, dt * 1e3, gbps))
        print(f"size {mb:8.2f} MB  time {dt * 1e3:8.3f} ms  "
              f"algbw {gbps:8.2f} GB/s")
    return rows


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sizes", default="0.25,1,4,16,64",
                    help="comma-separated message sizes in MB")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--transport", default=None,
                    choices=["nccl", "gloo", "host"],
                    help="process-group transport (default: nccl on the "
                         "card, gloo on the CPU)")
    args = ap.parse_args(argv)
    from ..context import cpu, gpu
    from ..parallel.mesh import init_distributed, shutdown
    ctx = cpu() if args.ctx == "cpu" else gpu(0)
    coord = None
    if int(os.environ.get("DMLC_NUM_WORKER", "1")) <= 1 and not \
            os.environ.get("MXNET_JAX_COORDINATOR"):
        coord = f"127.0.0.1:{_free_port()}"
    init_distributed(coordinator=coord, ctx=ctx, transport=args.transport)
    try:
        measure([float(s) for s in args.sizes.split(",")], args.iters,
                ctx)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
