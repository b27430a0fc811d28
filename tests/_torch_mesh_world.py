"""A world of ranks for the port's mesh tests: one gloo process group of
`n` spawned processes on the CPU, kept for a test file (a module
fixture), each case sent to every rank.

The children import torch, the port and `_torch_mesh_cases` only (no
JAX, no test module).  Every case has a deadline; a case that fails or
passes its deadline on any rank takes the world down (a rank left in a
collective would hang), and the next case starts a new one.
"""
import multiprocessing
import os
import socket
import sys
import time
import traceback


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(rank, n, port, conn):
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")
    import torch
    torch.set_num_threads(1)
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import parallel
    parallel.init_distributed(f"127.0.0.1:{port}", n, rank, ctx=mx.cpu(),
                              timeout=60)
    import _torch_mesh_cases as cases
    conn.send(("ready", rank))
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, args, kwargs = msg
        try:
            with mx.cpu():
                out = getattr(cases, name)(*args, **kwargs)
            conn.send(("ok", out))
        except Exception:           # noqa: BLE001 — sent to the parent
            conn.send(("err", traceback.format_exc()))


class World:
    def __init__(self, n=4):
        self.n = n
        self.procs = []
        self.conns = []

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        here = os.path.dirname(os.path.abspath(__file__))
        if here not in sys.path:
            sys.path.insert(0, here)
        for r in range(self.n):
            a, b = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(r, self.n, port, b),
                            daemon=True)
            p.start()
            self.procs.append(p)
            self.conns.append(a)
        self._collect("start", 120)

    def _collect(self, what, timeout):
        deadline = time.time() + timeout
        out = [None] * self.n
        for r, c in enumerate(self.conns):
            if not c.poll(max(0.0, deadline - time.time())):
                self.close()
                raise TimeoutError(f"{what}: rank {r} past its "
                                   f"{timeout} s deadline")
            try:
                status, val = c.recv()
            except EOFError:
                self.close()
                raise RuntimeError(f"{what}: rank {r} died")
            if status == "err":
                self.close()
                raise RuntimeError(f"{what} failed on rank {r}:\n{val}")
            out[r] = val
        return out

    def run(self, case, *args, timeout=90, **kwargs):
        """Every rank's result of `_torch_mesh_cases.<case>(*args)`."""
        if not self.procs:
            self._start()
        for c in self.conns:
            c.send((case, args, kwargs))
        return self._collect(case, timeout)

    def close(self):
        for c in self.conns:
            try:
                c.send(None)
            except (OSError, BrokenPipeError):
                pass
        for p in self.procs:
            p.join(timeout=0.5)
            if p.is_alive():
                p.kill()
                p.join()
        self.procs, self.conns = [], []
