"""Helpers of the port's kvstore tests (`tests/test_torch_kvstore*.py`):
free ports, server fleets of either package on threads of the test
process, the DMLC_* environment, and worker threads.  Workers of the
port run inside `with cpu():` (the context scope is per thread)."""
import socket
import threading

import incubator_mxnet_torch as tmx
from incubator_mxnet_torch.kvstore import dist as tdist
from incubator_mxnet_tpu.kvstore import dist as jdist

PKGS = {"torch": tdist, "jax": jdist}


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def free_port():
    return free_ports(1)[0]


def start_servers(monkeypatch, n=1, num_workers=1, sync=True, pkg="torch",
                  timeout=30, optimizer=None):
    """`n` servers of package `pkg` serving on threads, and the env of a
    fleet of `num_workers` workers; returns the servers."""
    mod = PKGS[pkg]
    monkeypatch.setenv("MXNET_KVSTORE_TIMEOUT", str(timeout))
    srvs = [mod._Server(p, num_workers, sync=sync) for p in free_ports(n)]
    for s in srvs:
        if optimizer is not None:
            s.set_optimizer(optimizer)
        threading.Thread(target=s.serve_forever, daemon=True).start()
    monkeypatch.setenv("DMLC_NUM_WORKER", str(num_workers))
    monkeypatch.setenv("DMLC_NUM_SERVER", str(n))
    monkeypatch.setenv("DMLC_WORKER_RANK", "0")
    monkeypatch.setenv("MXNET_KVSTORE_SERVER_ADDRS",
                       ",".join(f"127.0.0.1:{s.port}" for s in srvs))
    return srvs


def make_kv(rank=0, pkg="torch", name="dist_sync"):
    kv = PKGS[pkg].KVStoreDist(name)
    kv._rank = rank
    return kv


def stop(srvs=(), kvs=()):
    for kv in kvs:
        kv.close()
    for s in srvs:
        s.stop()


def run_workers(fns, timeout=60):
    """Run each fn on its own thread (the port's inside `cpu()`); the
    first failure is raised, and a hung thread fails."""
    errs = []

    def wrap(fn):
        try:
            with tmx.cpu():
                fn()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(f,)) for f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    if errs:
        raise errs[0]
    assert not any(t.is_alive() for t in ts), "worker threads hung"


def run_ranks(fn, n=2, timeout=60):
    """fn(rank) for rank in range(n), one thread each."""
    run_workers([lambda r=r: fn(r) for r in range(n)], timeout)
