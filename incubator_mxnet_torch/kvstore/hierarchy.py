"""Hierarchical gradient reduction (counterpart of
`incubator_mxnet_tpu/kvstore/hierarchy.py`): ``MXNET_KV_HIERARCHY=1``.

**Several cards in one process.**  `reduce_flats` sums the per-device
flat buckets on the leading device (peer copies, then adds in device
order) before anything goes to the host; it returns None for one local
device, as the JAX package's mesh psum declines there, and the caller
keeps the host-side sum.  This form is unverified until a machine with
several cards runs it (ROADMAP).

**Several worker processes on one host** (``MXNET_KV_LOCAL_SIZE`` > 1):
local rank 0 is the leader.  Members hand it their packed buckets over
a loopback relay, the leader adds them to its own in local-rank order,
carries one kvstore flow for the whole host and sends the merged
buckets back.  The servers are launched with ``DMLC_NUM_WORKER`` equal
to the number of hosts, and only leaders connect to them.  Because the
sum is in local-rank order, a host's merged bucket has the bits a flat
sync server (which adds in rank order) gives for the same workers.

Launch contract (`tools/launch.py` sets it)::

    MXNET_KV_HIERARCHY=1
    MXNET_KV_LOCAL_SIZE=<worker processes on this host>   # default 1
    MXNET_KV_LOCAL_RANK=<0..LOCAL_SIZE-1>                 # 0 = leader
    MXNET_KV_RELAY_PORT=<loopback port of the leader's relay>
"""
from __future__ import annotations

import socket
import struct
import threading
import time

import torch

from ..base import MXNetError, get_env
from .dist import _recv_exact, _pack_array, _unpack_array
from .. import telemetry as _telemetry
from .. import tracing as _tracing

__all__ = ["enabled", "reduce_flats", "relay", "reset",
           "HostRelayLeader", "HostRelayMember"]

_RELAY_MAGIC = b"MXHR"
_RELAY_VERSION = 1

_tm_hier = _telemetry.counter(
    "kvstore_hierarchy_reductions_total",
    "Hierarchical reductions performed, by level (ici = on-device sum "
    "across local devices; host = leader-relay merge across the "
    "host's worker processes)", ("level",))
_tm_relay_bytes = _telemetry.counter(
    "kvstore_hierarchy_relay_bytes",
    "Bytes moved over the intra-host loopback relay, by direction",
    ("direction",))


def enabled():
    """Master switch (``MXNET_KV_HIERARCHY=1``)."""
    return get_env("MXNET_KV_HIERARCHY", False, bool)


def reduce_flats(flats):
    """Sum per-device flat buckets (NDArrays on distinct CUDA devices)
    into one on the first device, in device order.  None when they do
    not sit on several devices: the caller keeps the host-side sum."""
    from ..ndarray import NDArray
    devs = [f._data.device for f in flats]
    if len(flats) < 2 or len(set(devs)) != len(devs) \
            or any(d.type != "cuda" for d in devs):
        return None
    with torch.no_grad():
        lead = devs[0]
        out = flats[0]._data.clone()
        for f in flats[1:]:
            out += f._data.to(lead)
    if _telemetry.enabled():
        _tm_hier.labels("ici").inc()
    return NDArray(out)


def _local_size():
    return max(1, get_env("MXNET_KV_LOCAL_SIZE", 1, int))


def _local_rank():
    return get_env("MXNET_KV_LOCAL_RANK", 0, int)


def _relay_port():
    return get_env("MXNET_KV_RELAY_PORT", 0, int)


_relay = None       # cached endpoint (False = resolved to none)
_relay_lock = threading.Lock()


def relay():
    """This process's host-relay endpoint, or None when the host path
    is off (``MXNET_KV_HIERARCHY`` unset or one process on the host).
    Local rank 0 is the leader: the only process that talks to the
    kvstore servers."""
    global _relay
    if _relay is not None:
        return _relay or None
    with _relay_lock:
        if _relay is not None:
            return _relay or None
        if not enabled() or _local_size() <= 1:
            _relay = False
            return None
        port = _relay_port()
        if not port:
            raise MXNetError(
                "MXNET_KV_HIERARCHY with MXNET_KV_LOCAL_SIZE > 1 "
                "requires MXNET_KV_RELAY_PORT (the leader's loopback "
                "relay port)")
        if _local_rank() == 0:
            _relay = HostRelayLeader(port, _local_size())
        else:
            _relay = HostRelayMember(port, _local_rank())
    return _relay


def reset():
    """Drop the cached relay (tests change the environment)."""
    global _relay
    with _relay_lock:
        if _relay:
            _relay.close()
        _relay = None


def _timeout():
    return float(get_env("MXNET_KVSTORE_TIMEOUT", 600.0, float))


def _send_block(sock, xchg, blobs):
    """One relay frame: [xchg u32][count u32] + per entry
    [klen u16][key][blen u32][body]."""
    parts = [struct.pack("<II", xchg, len(blobs))]
    for key, body in blobs:
        kb = key.encode()
        parts.append(struct.pack("<H", len(kb)) + kb
                     + struct.pack("<I", len(body)))
        parts.append(body)
    payload = b"".join(parts)
    sock.sendall(payload)
    return len(payload)


def _recv_block(sock):
    xchg, count = struct.unpack("<II", _recv_exact(sock, 8))
    out = []
    for _ in range(count):
        (klen,) = struct.unpack("<H", _recv_exact(sock, 2))
        key = bytes(_recv_exact(sock, klen)).decode()
        (blen,) = struct.unpack("<I", _recv_exact(sock, 4))
        out.append((key, _recv_exact(sock, blen)))
    return xchg, out


def _pack_flats(bucketer, grads, scale):
    """{wire_key: host tensor} of every bucket, in plan order."""
    from .base import _sum
    flats = {}
    for b in bucketer.plan:
        flat = bucketer._pack(b, grads, scale)
        if isinstance(flat, (list, tuple)):
            reduced = reduce_flats(list(flat))
            t = reduced._data if reduced is not None else \
                _sum([f._data for f in flat])
        else:
            t = flat._data
        flats[b.wire_key] = t.detach().cpu()
    return flats


def _deliver(bucketer, merged, outs):
    """Unpack merged {wire_key: tensor} back into the per-item outs."""
    from .bucket import unpack_into
    for b in bucketer.plan:
        flat = merged.get(b.wire_key)
        if flat is None:
            raise MXNetError(f"relay reply missing bucket {b.wire_key!r}")
        unpack_into(b, flat, outs)


class HostRelayLeader:
    """Local rank 0: accepts the host's members, adds their packed
    buckets to its own (its own first, then members in local-rank
    order), carries one kvstore flow and sends the result back."""

    is_leader = True

    def __init__(self, port, local_size):
        self.local_size = local_size
        self._xchg = 0
        self._members = {}
        self._mlock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self._sock.listen(local_size + 2)
        self._sock.settimeout(0.5)
        self._stop = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="mx-kv-relay-accept")
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                conn.settimeout(_timeout())
                hdr = _recv_exact(conn, len(_RELAY_MAGIC) + 5)
                if bytes(hdr[:4]) != _RELAY_MAGIC \
                        or hdr[4] != _RELAY_VERSION:
                    conn.close()
                    continue
                (rank,) = struct.unpack("<I", hdr[5:9])
            except (ConnectionError, OSError):
                continue
            with self._mlock:
                self._members[rank] = conn

    def _wait_members(self, deadline):
        while True:
            with self._mlock:
                if len(self._members) >= self.local_size - 1:
                    return sorted(self._members.items())
            if time.monotonic() > deadline:
                with self._mlock:
                    n = len(self._members)
                raise MXNetError(
                    f"hierarchical relay: only {n}/"
                    f"{self.local_size - 1} host members connected "
                    f"within the timeout — are all local workers "
                    f"launched with MXNET_KV_RELAY_PORT set?")
            time.sleep(0.01)

    def allreduce(self, bucketer, grads, outs, scale=None):
        from .bucket import _PullShell
        from ..ndarray import NDArray
        bucketer._ensure_init()
        deadline = time.monotonic() + _timeout()
        xchg = self._xchg = self._xchg + 1
        with _tracing.span("hier.host_reduce", exchange=xchg):
            own = _pack_flats(bucketer, grads, scale)
            members = self._wait_members(deadline)
            with torch.no_grad():
                for rank, conn in members:
                    rx, blobs = _recv_block(conn)
                    if rx != xchg:
                        raise MXNetError(
                            f"relay exchange desync: member {rank} sent "
                            f"exchange {rx}, leader is at {xchg}")
                    for k, body in blobs:
                        own[k] = own[k] + _unpack_array(body)
                    if _telemetry.enabled():
                        _tm_relay_bytes.labels("in").inc(
                            sum(len(b) for _k, b in blobs))
        keys = [b.wire_key for b in bucketer.plan]
        vals = [NDArray(own[k]) for k in keys]
        shells = [_PullShell((b.size,), b.dtype) for b in bucketer.plan]
        bucketer.kv.pushpull_multi(keys, vals, shells)
        merged = {k: s._data for k, s in zip(keys, shells)}
        with _tracing.span("hier.host_scatter", exchange=xchg):
            reply = [(k, _pack_array(merged[k])) for k in keys]
            for rank, conn in members:
                sent = _send_block(conn, xchg, reply)
                if _telemetry.enabled():
                    _tm_relay_bytes.labels("out").inc(sent)
        if _telemetry.enabled():
            _tm_hier.labels("host").inc()
        _deliver(bucketer, merged, outs)

    def update_exchange(self, bucketer, grads, weights, scale=None):
        """ZeRO-2 through the relay: the same exchange, but what the
        servers send back is their updated packed weights, delivered
        into every member's parameters."""
        return self.allreduce(bucketer, grads, weights, scale)

    def close(self):
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._mlock:
            for conn in self._members.values():
                try:
                    conn.close()
                except OSError:
                    pass
            self._members.clear()


class HostRelayMember:
    """Local rank > 0: hands its packed buckets to the host leader and
    receives the merged result; never touches the kvstore wire."""

    is_leader = False

    def __init__(self, port, rank):
        self.port = port
        self.rank = rank
        self._xchg = 0
        self._sock = None

    def _conn(self):
        if self._sock is None:
            deadline = time.monotonic() + float(
                get_env("MXNET_KVSTORE_CONNECT_TIMEOUT", 30.0, float))
            last = None
            while time.monotonic() < deadline:
                try:
                    s = socket.create_connection(
                        ("127.0.0.1", self.port), timeout=60.0)
                    s.settimeout(_timeout())
                    s.sendall(_RELAY_MAGIC
                              + struct.pack("<BI", _RELAY_VERSION,
                                            self.rank))
                    self._sock = s
                    break
                except OSError as e:
                    last = e
                    time.sleep(0.05)
            if self._sock is None:
                raise MXNetError(
                    f"cannot reach the host relay leader on "
                    f"127.0.0.1:{self.port}: {last}")
        return self._sock

    def allreduce(self, bucketer, grads, outs, scale=None):
        xchg = self._xchg = self._xchg + 1
        sock = self._conn()
        with _tracing.span("hier.member_exchange", exchange=xchg):
            blobs = [(k, _pack_array(t)) for k, t in
                     _pack_flats(bucketer, grads, scale).items()]
            sent = _send_block(sock, xchg, blobs)
            if _telemetry.enabled():
                _tm_relay_bytes.labels("out").inc(sent)
            rx, reply = _recv_block(sock)
            if rx != xchg:
                raise MXNetError(
                    f"relay exchange desync: leader replied exchange "
                    f"{rx}, member is at {xchg}")
        _deliver(bucketer, {k: _unpack_array(body) for k, body in reply},
                 outs)
        if _telemetry.enabled():
            _tm_hier.labels("host").inc()

    def update_exchange(self, bucketer, grads, weights, scale=None):
        """Member half of the ZeRO-2 relay exchange: packed gradients
        up, updated weights back."""
        return self.allreduce(bucketer, grads, weights, scale)

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
