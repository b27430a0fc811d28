#!/usr/bin/env python
"""Multi-process training launcher of the port (counterpart of the
repository's `tools/launch.py`), under the DMLC_* contract.

The local launcher forks `-s` kvstore servers (``python -m
incubator_mxnet_torch.kvstore.server``, on the host) and `-n` workers
on this machine, polls them, and stops every process when one fails.
'ssh' runs the same plan across the hosts of -H/--hostfile with one
ssh client per remote process and the DMLC_* environment inlined in
the remote command line; 'mpi' and 'slurm' run the same plan with
mpirun / srun as the transport (one single-rank job per process, so
the launcher keeps the placement; slurm reads the host list from the
surrounding allocation when -H is omitted).  --dry-run prints the
remote command lines; --ssh-cmd substitutes the transport client.

With ``MXNET_KV_HIERARCHY=1`` the workers of each host form one relay
(`kvstore.hierarchy`): each gets ``MXNET_KV_LOCAL_SIZE``,
``MXNET_KV_LOCAL_RANK`` and ``MXNET_KV_RELAY_PORT``, the servers and
workers count one kvstore worker per host (``DMLC_NUM_WORKER`` = hosts,
``DMLC_WORKER_RANK`` = the host's index), and only each host's leader
talks to the servers.

Usage:
  python -m incubator_mxnet_torch.tools.launch -n 2 -s 1 python train.py
  python -m incubator_mxnet_torch.tools.launch -n 4 -s 2 \\
      --launcher ssh -H hosts python train.py
"""
import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _free_port_run(n):
    """A base port with n consecutive free ports (multi-server layout)."""
    for _ in range(50):
        base = _free_port()
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no run of {n} consecutive free ports found")


def _read_hostfile(path):
    """Hosts, one per line ('host' or 'host slots=N' — slots are
    accepted for mpirun-style files but process placement here is
    round-robin).  '#' comments and blanks skipped."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                hosts.append(line.split()[0])
    if not hosts:
        raise SystemExit(f"hostfile {path} lists no hosts")
    return hosts


def _propagated_env(extra):
    """Env inlined into remote command lines: the DMLC_*/MXNET_* state
    of this process plus PYTHONPATH, plus explicit --env overrides."""
    env = {}
    for k, v in os.environ.items():
        if k.startswith(("DMLC_", "MXNET_")) or k == "PYTHONPATH":
            env[k] = v
    # role-specific vars from the LAUNCHING shell must not reach spawned
    # processes of the other role: each spawn overrides only its own
    # role's keys, so a stale DMLC_WORKER_RANK would leak into servers
    # (and DMLC_SERVER_ID into workers).  The launcher assigns these
    # per-process; drop any inherited values.
    for k in ("DMLC_ROLE", "DMLC_WORKER_RANK", "DMLC_SERVER_ID"):
        env.pop(k, None)
    for kv in extra:
        if "=" not in kv:
            raise SystemExit(f"--env needs KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        env[k] = v
    return env


def _relay_env(worker_hosts, port):
    """Per-rank relay environment with MXNET_KV_HIERARCHY on (else
    None): the workers of each host form one relay, in rank order; the
    relay port of a host is `port` + 2000."""
    if os.environ.get("MXNET_KV_HIERARCHY", "").strip().lower() not in \
            ("1", "true", "yes", "on"):
        return None
    hosts = list(dict.fromkeys(worker_hosts))
    out = []
    for h in worker_hosts:
        members = [r for r, x in enumerate(worker_hosts) if x == h]
        local = members.index(len(out))
        out.append({"MXNET_KV_LOCAL_SIZE": str(len(members)),
                    "MXNET_KV_LOCAL_RANK": str(local),
                    "MXNET_KV_RELAY_PORT": str(port + 2000),
                    "DMLC_WORKER_RANK": str(hosts.index(h)),
                    "DMLC_NUM_WORKER": str(len(hosts))})
    return out


def _ssh_spawn(ssh_cmd, host, workdir, env, command, dry_run,
               launcher="ssh"):
    """One remote process via the selected transport.  The remote side
    always runs the same shell line 'cd dir && env K=V... cmd'; only
    the client argv differs:
      ssh:   ssh <host> '<line>'
      mpi:   mpirun -np 1 --host <host> /bin/sh -c '<line>'  (one
             single-rank job per process: rank→host placement stays
             OURS — servers on the first hosts, port arithmetic intact —
             instead of trusting mpirun's fill order)
      slurm: srun -N1 -n1 --nodelist=<host> /bin/sh -c '<line>'
             (inside an allocation; srun also forwards env, but the
             inlined line keeps all three transports identical)
    Each client gets its own process group so teardown can reach the
    whole local tree (a shim transport runs the 'remote' command as a
    grandchild; killing only the client would orphan it holding our
    stdio pipes).  Killing the client tears down the remote end on all
    three: ssh drops the connection, mpirun signals its ranks, srun
    cancels the step."""
    envs = " ".join(f"{k}={shlex.quote(v)}" for k, v in sorted(env.items()))
    remote = " ".join(shlex.quote(c) for c in command)
    line = f"cd {shlex.quote(workdir)} && env {envs} {remote}"
    if launcher == "mpi":
        argv = ssh_cmd + ["-np", "1", "--host", host,
                          "/bin/sh", "-c", line]
    elif launcher == "slurm":
        # --overlap: the plan runs servers+workers as CONCURRENT
        # single-task steps, which can exceed the allocation's task
        # slots (e.g. -n 8 -s 2 on 8 nodes = 10 steps); without it
        # slurm queues the excess steps and the started workers hang
        # waiting for peers that never launch
        argv = ssh_cmd + ["--nodes=1", "--ntasks=1", "--overlap",
                          f"--nodelist={host}", "/bin/sh", "-c", line]
    else:
        argv = ssh_cmd + [host, line]
    if dry_run:
        print(" ".join(shlex.quote(a) for a in argv))
        return None
    return subprocess.Popen(argv, start_new_session=True)


def _expand_nodelist(s):
    """Expand a SLURM nodelist ('n[001-003,007],login1', suffix forms
    like 'cn[1-2]-ib' included) without scontrol — ranges keep their
    zero padding; used as fallback when scontrol is absent.  Malformed
    input exits with the offending string instead of a bare
    traceback."""
    try:
        hosts, i, n = [], 0, len(s)
        while i < n:
            parts = [""]          # cross-product of literal + bracket runs
            while i < n and s[i] != ",":
                if s[i] == "[":
                    j = s.index("]", i)
                    nums = []
                    for part in s[i + 1:j].split(","):
                        if "-" in part:
                            lo, hi = part.split("-", 1)
                            nums += [f"{v:0{len(lo)}d}"
                                     for v in range(int(lo), int(hi) + 1)]
                        else:
                            nums.append(part)
                    parts = [p + x for p in parts for x in nums]
                    i = j + 1
                else:
                    k = i
                    while k < n and s[k] not in ",[":
                        k += 1
                    parts = [p + s[i:k] for p in parts]
                    i = k
            hosts += [p for p in parts if p]
            i += 1
        if not hosts:
            raise ValueError("empty")
        return hosts
    except ValueError:
        raise SystemExit(f"malformed SLURM nodelist: {s!r}")


def _slurm_hosts():
    """Host list from the surrounding SLURM allocation (scontrol when
    available, bracket-grammar fallback otherwise)."""
    nodelist = os.environ.get("SLURM_JOB_NODELIST") \
        or os.environ.get("SLURM_NODELIST")
    if not nodelist:
        raise SystemExit(
            "--launcher slurm needs -H/--hostfile or a surrounding "
            "allocation (SLURM_JOB_NODELIST unset — run under "
            "salloc/sbatch)")
    try:
        r = subprocess.run(["scontrol", "show", "hostnames", nodelist],
                           capture_output=True, text=True)
        if r.returncode == 0 and r.stdout.split():
            return r.stdout.split()
    except FileNotFoundError:
        pass
    return _expand_nodelist(nodelist)


def _stop(proc):
    """SIGTERM the client's whole process group, escalate to SIGKILL."""
    try:
        os.killpg(proc.pid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            proc.kill()


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=1,
                    help="number of kvstore server processes; keys are "
                         "hash-sharded and big arrays split across them")
    ap.add_argument("--launcher", default="local",
                    choices=["local", "ssh", "mpi", "slurm"])
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="dist_async server semantics")
    ap.add_argument("-H", "--hostfile", default=None)
    ap.add_argument("--ssh-cmd", default=None,
                    help="transport client (default: ssh / mpirun / "
                         "srun by --launcher; tests substitute a shim; "
                         "real clusters may add options, e.g. 'ssh -o "
                         "StrictHostKeyChecking=no')")
    ap.add_argument("--remote-workdir", default=None,
                    help="directory to cd into on each host "
                         "(default: this one)")
    ap.add_argument("--sync-dst-dir", default=None,
                    help="rsync the current directory to DIR on every "
                         "host before launching; implies the remote "
                         "workdir is DIR")
    ap.add_argument("--env", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="extra env to inline into remote commands "
                         "(repeatable)")
    ap.add_argument("--remote-python", default="python3",
                    help="python executable on the remote hosts (runs "
                         "the kvstore server module)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the remote command lines, launch "
                         "nothing")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]     # argparse REMAINDER keeps it
    if not args.command:
        ap.error("no command given")

    if args.launcher in ("ssh", "mpi", "slurm"):
        # no local port probing here — remote hosts can't see our
        # ephemeral ports anyway, and probing 64 consecutive local
        # ports for a purely remote plan could spuriously abort
        if args.hostfile:
            hosts = _read_hostfile(args.hostfile)
        elif args.launcher == "slurm":
            hosts = _slurm_hosts()     # the surrounding allocation
        else:
            ap.error(f"--launcher {args.launcher} requires "
                     "-H/--hostfile")
        ssh_cmd = shlex.split(
            args.ssh_cmd or {"ssh": "ssh", "mpi": "mpirun",
                             "slurm": "srun"}[args.launcher])
        workdir = args.sync_dst_dir or args.remote_workdir or os.getcwd()
        # remote hosts can't probe our ephemeral ports: the base port
        # must be a KNOWN constant of the plan (env override or the
        # reference's conventional 9091); each server binds
        # ROOT_PORT+DMLC_SERVER_ID so co-hosted servers stay
        # collision-free
        port = int(os.environ.get("DMLC_PS_ROOT_PORT", 0)) or 9091
        server_hosts = [hosts[s % len(hosts)]
                        for s in range(args.num_servers)]
        worker_hosts = [hosts[r % len(hosts)]
                        for r in range(args.num_workers)]
        if args.sync_dst_dir:
            src = os.getcwd().rstrip("/") + "/"
            # rsync always rides ssh — mpirun/srun are process
            # launchers, not file transports
            rsync_e = args.ssh_cmd if args.launcher == "ssh" \
                and args.ssh_cmd else "ssh"
            for host in sorted(set(hosts)):
                rs = ["rsync", "-az", "-e", rsync_e, src,
                      f"{host}:{args.sync_dst_dir}/"]
                if args.dry_run:
                    print(" ".join(map(shlex.quote, rs)))
                    continue
                r = subprocess.run(rs)
                if r.returncode != 0:
                    raise SystemExit(f"rsync to {host} failed")
        # servers may live on different hosts, so workers need the
        # explicit address list, not ROOT_URI+offset guessing
        addrs = ",".join(f"{server_hosts[s]}:{port + s}"
                         for s in range(args.num_servers))
        env = _propagated_env(args.env)
        relay = _relay_env(worker_hosts, port)
        env.update(DMLC_NUM_WORKER=str(args.num_workers if relay is None
                                       else relay[0]["DMLC_NUM_WORKER"]),
                   DMLC_NUM_SERVER=str(args.num_servers),
                   DMLC_PS_ROOT_URI=server_hosts[0],
                   DMLC_PS_ROOT_PORT=str(port))
        if args.async_mode:
            env["MXNET_KVSTORE_MODE"] = "dist_async"
        procs, servers = [], []
        rc = 0
        # everything after the first spawn sits inside try/finally:
        # a mid-spawn failure or a Ctrl-C (which the clients' own
        # sessions never see — start_new_session detaches them from
        # the terminal's SIGINT) must still tear down every client,
        # workers included, or remote processes leak
        try:
            for s in range(args.num_servers):
                p = _ssh_spawn(
                    ssh_cmd, server_hosts[s], workdir,
                    dict(env, DMLC_ROLE="server", DMLC_SERVER_ID=str(s)),
                    [args.remote_python,
                     "-m", "incubator_mxnet_torch.kvstore.server"],
                    args.dry_run, launcher=args.launcher)
                if p:
                    servers.append(p)
            for r in range(args.num_workers):
                # a process group's rendezvous (`parallel.
                # init_distributed`) is worker 0's host
                wenv = dict(env, DMLC_ROLE="worker",
                            DMLC_WORKER_RANK=str(r),
                            MXNET_KVSTORE_SERVER_ADDRS=addrs,
                            MXNET_JAX_COORDINATOR=(
                                f"{worker_hosts[0]}:{port + 1000}"))
                if relay is not None:
                    wenv.update(relay[r])
                p = _ssh_spawn(
                    ssh_cmd, worker_hosts[r], workdir, wenv,
                    args.command, args.dry_run, launcher=args.launcher)
                if p:
                    procs.append(p)
            # poll workers AND servers: one crashed process must tear
            # the cluster down immediately — its peers are blocked in
            # the next collective / kvstore round-trip and would
            # otherwise hang forever
            import time
            pending = list(procs)
            while pending:
                stop = False
                for w in list(pending):
                    code = w.poll()
                    if code is None:
                        continue
                    pending.remove(w)
                    rc = rc or code
                    if code != 0:
                        print(f"launch: a worker exited with {code}; "
                              "stopping the cluster", file=sys.stderr)
                        stop = True
                for p in servers:
                    code = p.poll()
                    if code is not None and pending:
                        # ANY server exit (clean or not) while workers
                        # still run leaves them blocked on a dead
                        # endpoint — tear down either way
                        print(f"launch: a server exited with {code} "
                              "while workers were running; stopping "
                              "the cluster", file=sys.stderr)
                        rc = rc or code or 1
                        stop = True
                if stop:
                    break
                if pending:
                    time.sleep(0.2)
        finally:
            # group-kill every client (workers first, then servers):
            # closing the ssh connections tears the remote side down,
            # and a local shim transport's grandchildren die with the
            # group
            for p in procs:
                if p.poll() is None:
                    _stop(p)
            for p in servers:
                _stop(p)
        return rc

    port = int(os.environ.get("DMLC_PS_ROOT_PORT", 0)) or \
        _free_port_run(args.num_servers)
    relay = _relay_env(["127.0.0.1"] * args.num_workers, _free_port() - 2000)
    nkv = args.num_workers if relay is None else 1
    base_env = dict(os.environ,
                    DMLC_PS_ROOT_URI="127.0.0.1",
                    DMLC_PS_ROOT_PORT=str(port),
                    MXNET_JAX_COORDINATOR=f"127.0.0.1:{_free_port()}",
                    DMLC_NUM_WORKER=str(nkv),
                    DMLC_NUM_SERVER=str(args.num_servers))
    for k in ("DMLC_ROLE", "DMLC_WORKER_RANK", "DMLC_SERVER_ID",
              "MXNET_KVSTORE_SERVER_ADDRS"):
        base_env.pop(k, None)
    # the children import this checkout's package
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base_env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in base_env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    if args.async_mode:
        base_env["MXNET_KVSTORE_MODE"] = "dist_async"
    procs = []
    try:
        servers = []
        for s in range(args.num_servers):
            servers.append(subprocess.Popen(
                [sys.executable, "-m", "incubator_mxnet_torch.kvstore.server"],
                env=dict(base_env, DMLC_ROLE="server",
                         DMLC_SERVER_ID=str(s))))
        procs += servers
        workers = []
        for r in range(args.num_workers):
            wenv = dict(base_env, DMLC_ROLE="worker",
                        DMLC_WORKER_RANK=str(r))
            if relay is not None:
                wenv.update(relay[r])
            workers.append(subprocess.Popen(args.command, env=wenv))
        procs += workers
        return _wait_local(workers, servers)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _wait_local(workers, servers):
    """Wait for the workers; the first failure (a worker exiting
    non-zero, or a server exiting while workers run) stops the rest."""
    import time
    rc, pending = 0, list(workers)
    while pending:
        for w in list(pending):
            code = w.poll()
            if code is None:
                continue
            pending.remove(w)
            rc = rc or code
            if code != 0:
                print(f"launch: a worker exited with {code}; stopping "
                      "the cluster", file=sys.stderr)
                return rc
        for s in servers:
            code = s.poll()
            if code is not None and pending:
                print(f"launch: a server exited with {code} while "
                      "workers were running; stopping the cluster",
                      file=sys.stderr)
                return code or 1
        if pending:
            time.sleep(0.05)
    return rc


if __name__ == "__main__":
    sys.exit(main())
