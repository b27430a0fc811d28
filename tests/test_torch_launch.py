"""The port's launcher (`incubator_mxnet_torch.tools.launch`) against
the JAX package's `tools/launch.py`.

Mirrors `tests/test_launch_ssh.py` and `tests/test_launch_mpi_slurm.py`
case for case, through their transport shims (a shell script stands in
for ssh, mpirun and srun: it logs the addressed host and runs the line
locally) and `--dry-run`, whose plans are compared with the JAX
launcher's line for line; adds the relay environment the port's
launcher gives each worker, and `example/distributed_training/
train_dist.py`, unchanged, through `python -m incubator_mxnet_torch.run
--ctx cpu` under the port's launcher: both ranks finish with equal
weights (their digests, `health.checksum`, compared exactly).
"""
import os
import socket
import stat
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the launcher runs as a script: it imports nothing of the package
LAUNCH = [sys.executable, os.path.join(REPO, "incubator_mxnet_torch",
                                       "tools", "launch.py")]
JAX_LAUNCH = [sys.executable, os.path.join(REPO, "tools", "launch.py")]

WORKER = """
import numpy as np
import incubator_mxnet_torch as mx
from incubator_mxnet_torch import nd

with mx.cpu():
    kv = mx.kv.create("dist_sync")
    assert kv.num_workers == 2
    base = np.arange(128, dtype=np.float32).reshape(8, 16)
    kv.init("w", nd.zeros((8, 16)))
    kv.push("w", nd.array(base))
    out = nd.zeros((8, 16))
    kv.barrier()
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), base * 2.0)
    print("WORKER_OK", kv.rank, flush=True)
"""


def _free_port_run(n):
    """A base port with n consecutive free ports."""
    for _ in range(50):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        socks = []
        try:
            for i in range(n):
                sk = socket.socket()
                sk.bind(("127.0.0.1", base + i))
                socks.append(sk)
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise RuntimeError("no consecutive free ports")


def _shim(tmp_path, kind):
    """The transport shim of `kind` (ssh, mpirun, srun) and its host
    log."""
    shim, log = tmp_path / f"fake_{kind}", tmp_path / "hosts.log"
    if kind == "ssh":
        body = ("while [ $# -gt 0 ]; do case \"$1\" in -*) shift;; *) "
                "break;; esac; done\n"
                f"echo \"$1\" >> {log}\n"
                "host=\"$1\"; shift\n"
                "exec /bin/sh -c \"$*\"\n")
    elif kind == "mpirun":
        body = ("while [ $# -gt 0 ]; do case \"$1\" in\n"
                f"  --host) echo \"$2\" >> {log}; shift 2;;\n"
                "  -np) shift 2;;\n  /bin/sh) break;;\n  *) shift;;\n"
                "esac; done\nexec \"$@\"\n")
    else:
        body = ("while [ $# -gt 0 ]; do case \"$1\" in\n"
                f"  --nodelist=*) echo \"${{1#--nodelist=}}\" >> {log};"
                " shift;;\n  /bin/sh) break;;\n  *) shift;;\n"
                "esac; done\nexec \"$@\"\n")
    shim.write_text("#!/bin/sh\n" + body)
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    return str(shim), str(log)


def _clean_env(**extra):
    env = dict(os.environ, MXNET_KVSTORE_TIMEOUT="30", PYTHONPATH=REPO)
    for k in ("DMLC_NUM_SERVER", "DMLC_NUM_WORKER", "DMLC_ROLE",
              "DMLC_WORKER_RANK", "DMLC_PS_ROOT_PORT",
              "MXNET_KVSTORE_SERVER_ADDRS", "SLURM_JOB_NODELIST",
              "SLURM_NODELIST", "MXNET_KV_HIERARCHY"):
        env.pop(k, None)
    env.update(extra)
    return env


def _end_to_end(tmp_path, launcher, shim_kind, hostfile=True, **env):
    shim, log = _shim(tmp_path, shim_kind)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    args = ["-n", "2", "-s", "2", "--launcher", launcher]
    if hostfile:
        hosts = tmp_path / "hosts"
        hosts.write_text("localhost slots=2\n# comment\n127.0.0.1\n")
        args += ["-H", str(hosts)]
    r = subprocess.run(
        LAUNCH + args + ["--ssh-cmd", shim, "--remote-python",
                         sys.executable, "--", sys.executable, str(script)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=_clean_env(DMLC_PS_ROOT_PORT=str(_free_port_run(2)), **env))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("WORKER_OK") == 2, r.stdout + r.stderr
    hosts = open(log).read().split()
    assert hosts.count("localhost") == 2      # server0 + worker0
    assert hosts.count("127.0.0.1") == 2      # server1 + worker1


def test_ssh_launcher_end_to_end_two_hosts(tmp_path):
    _end_to_end(tmp_path, "ssh", "ssh")


def test_mpi_launcher_end_to_end_two_hosts(tmp_path):
    _end_to_end(tmp_path, "mpi", "mpirun")


def test_slurm_launcher_end_to_end_from_allocation(tmp_path):
    _end_to_end(tmp_path, "slurm", "srun", hostfile=False,
                SLURM_JOB_NODELIST="localhost,127.0.0.1")


def _dry(tmp_path, launcher, n, s, hosts=None, **env):
    """The port's and the JAX launcher's --dry-run lines."""
    args = ["-n", str(n), "-s", str(s), "--launcher", launcher]
    if hosts:
        hf = tmp_path / "hosts"
        hf.write_text("\n".join(hosts) + "\n")
        args += ["-H", str(hf)]
    args += ["--dry-run", "--", "python3", "train.py", "--epochs", "1"]
    out = []
    for cmd in (LAUNCH, JAX_LAUNCH):
        r = subprocess.run(cmd + args, cwd=REPO, capture_output=True,
                           text=True, timeout=60, env=_clean_env(**env))
        assert r.returncode == 0, r.stdout + r.stderr
        out.append([ln for ln in r.stdout.splitlines() if ln.strip()])
    return out


def _same_plan(got, ref):
    """Line for line the JAX plan, but for the server module's name."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g == r.replace("incubator_mxnet_tpu.kvstore.server",
                              "incubator_mxnet_torch.kvstore.server")


def test_ssh_launcher_dry_run_prints_plan(tmp_path):
    got, ref = _dry(tmp_path, "ssh", 3, 2, ["hostA", "hostB"],
                    DMLC_PS_ROOT_PORT="9400")
    _same_plan(got, ref)
    assert len(got) == 5
    assert sum("incubator_mxnet_torch.kvstore.server" in ln
               for ln in got) == 2
    assert all("MXNET_KVSTORE_SERVER_ADDRS=hostA:9400,hostB:9401" in ln
               for ln in got if "train.py" in ln)
    assert any(ln.startswith("ssh hostA ") for ln in got)
    assert any(ln.startswith("ssh hostB ") for ln in got)
    assert all("MXNET_JAX_COORDINATOR=hostA:10400" in ln
               for ln in got if "train.py" in ln)


def test_mpi_dry_run_plan(tmp_path):
    got, ref = _dry(tmp_path, "mpi", 3, 2, ["nodeA", "nodeB"],
                    DMLC_PS_ROOT_PORT="9500")
    _same_plan(got, ref)
    assert all(ln.startswith("mpirun -np 1 --host ") for ln in got)
    assert all("MXNET_KVSTORE_SERVER_ADDRS=nodeA:9500,nodeB:9501" in ln
               for ln in got if "train.py" in ln)


def test_slurm_dry_run_plan_and_nodelist_expansion(tmp_path):
    got, ref = _dry(tmp_path, "slurm", 2, 1, DMLC_PS_ROOT_PORT="9600",
                    SLURM_JOB_NODELIST="gpu[01-02]")
    _same_plan(got, ref)
    assert len(got) == 3 and all(ln.startswith(
        "srun --nodes=1 --ntasks=1 --overlap --nodelist=gpu0")
        for ln in got)


@pytest.mark.parametrize("launcher,needle", [("ssh", "hostfile"),
                                             ("slurm",
                                              "SLURM_JOB_NODELIST")])
def test_launcher_without_hosts_errors(launcher, needle):
    """ssh without -H, and slurm without -H or an allocation, exit with
    the JAX launcher's message (test_ssh_launcher_requires_hostfile,
    test_slurm_without_allocation_or_hostfile_errors)."""
    r = subprocess.run(LAUNCH + ["-n", "2", "--launcher", launcher, "--",
                                 "true"], cwd=REPO, capture_output=True,
                       text=True, timeout=60, env=_clean_env())
    assert r.returncode != 0 and needle in r.stderr


def test_expand_nodelist_grammar():
    from incubator_mxnet_torch.tools.launch import _expand_nodelist
    assert _expand_nodelist("n[001-003,007],login1") == [
        "n001", "n002", "n003", "n007", "login1"]
    assert _expand_nodelist("a,b") == ["a", "b"]
    assert _expand_nodelist("node5") == ["node5"]
    assert _expand_nodelist("gpu[9-11]") == ["gpu9", "gpu10", "gpu11"]
    assert _expand_nodelist("cn[1-2]-ib") == ["cn1-ib", "cn2-ib"]
    assert _expand_nodelist("a[1-2]b[3-4]") == [
        "a1b3", "a1b4", "a2b3", "a2b4"]
    for bad in ("n[01", "n[1-x]"):
        with pytest.raises(SystemExit, match="malformed"):
            _expand_nodelist(bad)


def test_relay_env_groups_workers_by_host(tmp_path):
    """With MXNET_KV_HIERARCHY=1 each host's workers form one relay: the
    dry-run lines carry MXNET_KV_LOCAL_*, and one kvstore worker a
    host."""
    from incubator_mxnet_torch.tools import launch
    os.environ["MXNET_KV_HIERARCHY"] = "1"
    try:
        env = launch._relay_env(["a", "b", "a", "a"], 9000)
    finally:
        del os.environ["MXNET_KV_HIERARCHY"]
    assert [e["MXNET_KV_LOCAL_RANK"] for e in env] == ["0", "0", "1", "2"]
    assert [e["MXNET_KV_LOCAL_SIZE"] for e in env] == ["3", "1", "3", "3"]
    assert [e["DMLC_WORKER_RANK"] for e in env] == ["0", "1", "0", "0"]
    assert {e["DMLC_NUM_WORKER"] for e in env} == {"2"}
    assert {e["MXNET_KV_RELAY_PORT"] for e in env} == {"11000"}
    hf = tmp_path / "hosts"
    hf.write_text("hostA\n")
    r = subprocess.run(
        LAUNCH + ["-n", "2", "-s", "1", "--launcher", "ssh", "-H", str(hf),
                  "--dry-run", "--", "python3", "train.py"], cwd=REPO,
        capture_output=True, text=True, timeout=60,
        env=_clean_env(DMLC_PS_ROOT_PORT="9700", MXNET_KV_HIERARCHY="1"))
    lines = [ln for ln in r.stdout.splitlines() if "train.py" in ln]
    assert len(lines) == 2 and all("DMLC_NUM_WORKER=1" in ln
                                   for ln in lines)
    assert "MXNET_KV_LOCAL_RANK=1" in lines[1]


def test_local_launcher_stops_the_cluster_on_a_failed_worker(tmp_path):
    """One worker exits non-zero: the launcher stops the rest (the other
    worker would block in its round forever) and fails."""
    script = tmp_path / "w.py"
    script.write_text("import os, sys, time\n"
                      "if os.environ['DMLC_WORKER_RANK'] == '1':\n"
                      "    sys.exit(3)\n"
                      "time.sleep(60)\n")
    r = subprocess.run(LAUNCH + ["-n", "2", "-s", "1", sys.executable,
                                 str(script)], cwd=REPO,
                       capture_output=True, text=True, timeout=50,
                       env=_clean_env())
    assert r.returncode == 3 and "stopping the cluster" in r.stderr


WRAP = """
import runpy, sys
import mxnet as mx
from mxnet.gluon import trainer as T
made = []
_init = T.Trainer.__init__


def init(self, *a, **k):
    _init(self, *a, **k)
    made.append(self)


T.Trainer.__init__ = init
script = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(script, run_name="__main__")
from incubator_mxnet_torch import health
print("DIGEST", made[0]._kv.rank,
      health.checksum([p._data for p in made[0]._params]), flush=True)
"""


def test_train_dist_example_under_the_port_launcher(tmp_path):
    """train_dist.py unchanged, on the port (`run --ctx cpu`), two
    workers and a server from the port's launcher: both ranks finish
    and end with the same weights."""
    wrap = tmp_path / "wrap.py"
    wrap.write_text(WRAP)
    r = subprocess.run(
        LAUNCH + ["-n", "2", "-s", "1", sys.executable, "-m",
                  "incubator_mxnet_torch.run", "--ctx", "cpu", str(wrap),
                  os.path.join(REPO, "example", "distributed_training",
                               "train_dist.py"),
                  "--samples", "192", "--epochs", "1", "--batch-size",
                  "48"], cwd=REPO, capture_output=True, text=True,
        timeout=240, env=_clean_env(JAX_PLATFORMS="cpu",
                                    OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    finals = [ln for ln in r.stdout.splitlines() if " final " in ln]
    digests = {ln.split()[2] for ln in r.stdout.splitlines()
               if ln.startswith("DIGEST")}
    assert len(finals) == 2, r.stdout
    assert len(digests) == 1, r.stdout
