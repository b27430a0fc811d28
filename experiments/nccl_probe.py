"""Probe what the installed torch offers the mesh on one card.

    python3 experiments/nccl_probe.py

1. Two NCCL ranks on cuda:0: each process joins a two-rank NCCL group
   over tcp://127.0.0.1 and all-reduces one tensor; the text of the
   error (or "accepted") is printed per rank.
2. One rank on NCCL (world size 1): the collectives the mesh uses.
3. A two-rank gloo group on the CPU: the same collectives, to see which
   of the tensor forms gloo takes in this torch.

Every child has a deadline of 90 s and is killed past it.
"""
import json
import os
import socket
import subprocess
import sys
import time


def _port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _collectives(dist, torch, device):
    out = {}
    t = torch.ones(8, device=device)
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(t.clone())),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(8 * dist.get_world_size(), device=device),
                t.clone())),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(8 // dist.get_world_size(), device=device),
                t.clone())),
            ("all_to_all_single", lambda: dist.all_to_all_single(
                torch.empty(8, device=device), t.clone())),
            ("batch_isend_irecv", lambda: [w.wait() for w in
                                           dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t.clone(),
                           (dist.get_rank() + 1) % dist.get_world_size()),
                dist.P2POp(dist.irecv, torch.empty(8, device=device),
                           (dist.get_rank() - 1) % dist.get_world_size())])])):
        try:
            fn()
            if device != "cpu":
                torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:      # noqa: BLE001 — the probe reports it
            out[name] = f"{type(e).__name__}: {str(e)[:300]}"
    return out


def child(mode, rank, world, port):
    import torch
    import torch.distributed as dist
    from datetime import timedelta
    backend = "gloo" if mode == "gloo" else "nccl"
    device = "cpu" if mode == "gloo" else "cuda:0"
    if device != "cpu":
        torch.cuda.set_device(0)
    res = {"mode": mode, "rank": rank}
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=60))
        if mode == "nccl2":
            t = torch.ones(4, device=device)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            res["all_reduce"] = f"accepted, sum {t[0].item()}"
        else:
            res.update(_collectives(dist, torch, device))
        dist.destroy_process_group()
    except Exception as e:          # noqa: BLE001 — the probe reports it
        res["error"] = f"{type(e).__name__}: {str(e)[:1500]}"
    print("PROBE " + json.dumps(res), flush=True)


def run(mode, world):
    port = _port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--child", mode, str(r), str(world),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True) for r in range(world)]
    deadline = time.time() + 90
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            out, _ = p.communicate()
            out += "\nkilled at the 90 s deadline"
        lines = [l for l in out.splitlines() if l.startswith("PROBE ")]
        print(f"[{mode} x{world}] rc={p.returncode}", flush=True)
        for l in lines:
            print("  " + l[6:], flush=True)
        if not lines:
            print("  " + out[-2000:].replace("\n", "\n  "), flush=True)


def main():
    import torch
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version())) if torch.cuda.is_available() else None}",
          flush=True)
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        run("nccl2", 2)
        run("nccl1", 1)
    run("gloo", 2)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
              int(sys.argv[5]))
    else:
        main()
