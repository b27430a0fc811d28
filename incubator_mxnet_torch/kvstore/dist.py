"""The distributed kvstore over TCP: worker and server, fixed fleet
(counterpart of `incubator_mxnet_tpu/kvstore/dist.py`).

N workers push gradients to the servers; a server merges each key's
round (sync: every worker's contribution, added in rank order; async:
each push applies as it comes), runs the optimizer when one was
shipped with `set_optimizer`, and serves pulls.  The fleet comes from
the DMLC_* environment that `tools/launch.py` sets:

  DMLC_ROLE=worker|server   DMLC_WORKER_RANK / DMLC_SERVER_ID
  DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT   (server s listens on port + s)
  DMLC_NUM_WORKER / DMLC_NUM_SERVER      (or MXNET_KVSTORE_SERVER_ADDRS)

The wire is the JAX package's, byte for byte, so a worker of either
package talks to a server of either: the v4 frame header
``[op|trace flag u8][seq u64][epoch u32][xid u32]([trace u64][parent
u64])[klen u32][key][plen u32][payload]``, the version-stable
handshake framing, `_pack_array`'s ``[dtype u8][ndim u8][shape
u32...][raw bytes]`` with the JAX dtype indices (bfloat16 is index 7,
sent as its raw 2-byte words), the multi-entry payloads, the 2-bit body
and the bucket wire keys.  A frame's membership epoch is 0 and its
exchange id counts the worker's exchanges, as the JAX fixed fleet sends
them.

Only the fixed fleet is here.  Elastic membership, reconnect and
replay, the fault plan, server snapshots, live ZeRO-2 rebalancing,
speculative backup steps, job checkpoints and the admin calls are
ROADMAP item 10b: their knobs raise (`check_fixed_fleet`), and a
transport error ends the step with one clean error.

Workers move tensors: a value leaves the card by one device-to-host
copy into a page-locked buffer kept per key, its bytes go on the wire
from there, and a pulled value comes back as one host tensor.  The
server keeps torch CPU tensors and never touches CUDA.
"""
from __future__ import annotations

import collections
import contextlib
import os
import pickle
import select
import socket
import struct
import threading
import time

import torch

from ..base import MXNetError, dtype_name
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from .. import introspect as _introspect
from .base import (KVStore, _as_list, _deliver, _key_value_pairs, _int_key,
                   _nbytes, _shard_of, _sum, _tm_push_bytes,
                   _tm_pull_bytes, _tm_allreduce)
from .bucket import BUCKET_KEY_PREFIX

__all__ = ["KVStoreDist", "run_server", "check_fixed_fleet"]

_OP_PUSH, _OP_PULL, _OP_BARRIER, _OP_STOP, _OP_PUSHPULL = 1, 2, 3, 4, 5
_OP_PUSH_CMP = 6    # 2-bit compressed push
_OP_ERROR = 7       # server -> worker failure report (payload = message)
# multi-key ops: payload [count u32] + per entry [flags u8][klen u16]
# [key][blen u32][body]; one reply per frame
_OP_PUSH_MULTI, _OP_PULL_MULTI = 8, 9
_OP_HELLO = 10      # handshake: [version u32][rank u32][workers u32]token
_OP_AUDIT = 18      # divergence-audit digests: [audit u64][digest u64]
#                     [rank u32] -> JSON of the last two rounds

# the JAX package's protocol version (its handshake rejects any other)
_PROTO_VERSION = 5

# op-byte flag: a [trace_id u64][parent_span_id u64] extension follows
# the fixed header
_TRACE_FLAG = 0x80

# ops whose effect is not idempotent: the server caches their replies
# per (worker session, seq)
_DEDUP_OPS = frozenset((_OP_PUSH, _OP_PUSH_CMP, _OP_PUSH_MULTI,
                        _OP_BARRIER))

_ENTRY_2BIT = 1     # entry flag: body is 2-bit compressed

# ceiling per multi-op frame (and, through 8-byte pull hints, per reply)
_MAX_FRAME_BYTES = 1 << 29

# a key longer than this is a framing desync, not a key
_MAX_KEY_BYTES = 1 << 16

_DTYPES = ["float32", "float64", "float16", "uint8", "int32", "int8",
           "int64", "bfloat16"]
_TORCH_DTYPES = [torch.float32, torch.float64, torch.float16, torch.uint8,
                 torch.int32, torch.int8, torch.int64, torch.bfloat16]

# the item-10b knobs: each raises when set
_ITEM_10B_KNOBS = ("MXNET_KV_ELASTIC", "MXNET_KV_SNAPSHOT_DIR",
                   "MXNET_KV_FAULT_PLAN", "MXNET_KV_STRAGGLER_MS",
                   "MXNET_CKPT_DIR", "MXNET_CKPT_EVERY_STEPS",
                   "MXNET_CONTROLLER")

_tm_wire = _telemetry.counter(
    "kvstore_wire_messages",
    "Worker-side request/reply wire message pairs, by operation",
    ("op",))
_tm_inflight = _telemetry.histogram(
    "kvstore_inflight_depth",
    "Multi-op frames in flight per server socket before any reply is "
    "collected (the MXNET_KV_INFLIGHT pipeline window)",
    ("op",), buckets=(1, 2, 4, 8, 16, 32, 64))
_tm_multi_secs = _telemetry.histogram(
    "kvstore_multi_seconds",
    "Wall time of one bulk multi-key push/pull across all servers",
    ("op",))
_tm_dup_frames = _telemetry.counter(
    "kvstore_duplicate_frames",
    "Server-side replayed frames deduplicated by the per-worker "
    "(session, seq) window instead of being re-applied", ("server",))
_tm_owned = _telemetry.gauge(
    "kvstore_server_bytes_owned",
    "Bytes of stored weights this server owns — the placement-skew "
    "signal: compare across servers; with MXNET_KV_ZERO the "
    "byte-balanced bucket partition keeps max/mean <= ~1.2",
    ("server",))
_tm_state_bytes = _telemetry.gauge(
    "kvstore_server_state_bytes",
    "Bytes of optimizer state resident on this server (ZeRO: each "
    "server holds only its owned shards' state, ~total/N)", ("server",))
_tm_owned_shards = _telemetry.gauge(
    "kvstore_owned_shards",
    "Gradient-bucket shards this server currently owns (ZeRO "
    "placement)", ("server",))
_tm_wire_bytes = _telemetry.counter(
    "kvstore_wire_bytes",
    "Request payload bytes a worker sent to the servers, by operation",
    ("op",))


def check_fixed_fleet():
    """Raise `MXNetError` when a knob of ROADMAP item 10b is set: this
    port runs the fixed fleet only, and no such knob is ignored."""
    for name in _ITEM_10B_KNOBS:
        raw = os.environ.get(name, "")
        if raw.strip() and raw.strip().lower() not in ("0", "false", "no",
                                                       "off"):
            raise MXNetError(
                f"{name}={raw!r}: elastic membership, reconnect and "
                f"replay, fault plans, snapshots, straggler rounds, job "
                f"checkpoints and the controller are ROADMAP item 10b, "
                f"not ported yet — this kvstore runs the fixed fleet; "
                f"unset {name}")


# ----------------------------------------------------------------------
# wire helpers
# ----------------------------------------------------------------------

def _frame_header(op, key=b"", payload=b"", seq=0, epoch=0, xid=0,
                  trace=None):
    """The v4 header serializer every sender goes through."""
    ext = b""
    if trace is not None and trace[0]:
        op |= _TRACE_FLAG
        ext = struct.pack("<QQ", trace[0], trace[1])
    return struct.pack("<BQII", op, seq, epoch, xid) + ext + struct.pack(
        "<I", len(key)) + key + struct.pack("<I", len(payload))


def _send_msg(sock, op, key=b"", payload=b"", seq=0, epoch=0, xid=0,
              trace=None):
    hdr = _frame_header(op, key, payload, seq, epoch, xid, trace)
    if len(payload) > (1 << 20):
        sock.sendall(hdr)
        sock.sendall(payload)
    else:
        sock.sendall(hdr + bytes(payload))


def _recv_exact(sock, n):
    """`n` bytes into one preallocated buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("socket closed")
        got += r
    return buf


def _recv_msg_ex(sock):
    """One v4 frame: (op, seq, epoch, xid, key, payload, trace)."""
    buf = _recv_exact(sock, 21)
    op, seq, epoch, xid = struct.unpack_from("<BQII", buf, 0)
    if op & _TRACE_FLAG:
        op &= ~_TRACE_FLAG
        rest = _recv_exact(sock, 16)
        trace = struct.unpack("<QQ", bytes(buf[17:21]) + bytes(rest[:12]))
        (klen,) = struct.unpack("<I", rest[12:16])
    else:
        trace = (0, 0)
        (klen,) = struct.unpack_from("<I", buf, 17)
    if klen > _MAX_KEY_BYTES:
        raise ConnectionError(
            f"framing desync: key length {klen} — peer speaks a "
            f"different wire protocol version?")
    key = _recv_exact(sock, klen) if klen else b""
    (plen,) = struct.unpack("<I", _recv_exact(sock, 4))
    payload = _recv_exact(sock, plen) if plen else b""
    return op, seq, epoch, xid, key.decode(), payload, trace


def _recv_msg(sock):
    op, seq, _epoch, _xid, key, payload, _trace = _recv_msg_ex(sock)
    return op, seq, key, payload


def _send_msg_hs(sock, op, key=b"", payload=b"", seq=0):
    """The version-stable framing of the handshake only (13-byte
    ``<BQI op seq klen>`` header), so a peer of any protocol version
    parses the hello far enough to answer a clean version error."""
    sock.sendall(struct.pack("<BQI", op, seq, len(key)) + key
                 + struct.pack("<I", len(payload)) + payload)


def _recv_msg_hs(sock):
    op, seq, klen = struct.unpack("<BQI", _recv_exact(sock, 13))
    if klen > _MAX_KEY_BYTES:
        raise ConnectionError(
            f"framing desync: key length {klen} — peer speaks a "
            f"different wire protocol version?")
    key = _recv_exact(sock, klen) if klen else b""
    (plen,) = struct.unpack("<I", _recv_exact(sock, 4))
    payload = _recv_exact(sock, plen) if plen else b""
    return op, seq, key.decode(), payload


def _raw_bytes(t):
    """The bytes of CPU tensor `t` in C order (a view, no copy)."""
    t = t.contiguous()
    if t.numel() == 0:
        return b""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _pack_array(a):
    """``[dtype u8][ndim u8][shape u32...][bytes]`` of a torch tensor (a
    CUDA one is copied to the host) or a numpy array.  A dtype outside
    `_DTYPES` is tagged 0, as the JAX package tags it."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        name, shape, raw = dtype_name(t.dtype), tuple(t.shape), _raw_bytes(t)
    else:
        import numpy as _np
        arr = _np.ascontiguousarray(a)
        name, shape = str(arr.dtype), arr.shape
        raw = memoryview(arr.reshape(-1).view(_np.uint8)) if arr.size \
            else b""
    dt = _DTYPES.index(name) if name in _DTYPES else 0
    hdr = struct.pack("<BB", dt, len(shape)) + struct.pack(
        f"<{len(shape)}I", *shape)
    return hdr + raw


def _unpack_array(b):
    """Inverse of `_pack_array`: a CPU tensor that owns its memory."""
    mv = memoryview(b)
    dt, ndim = struct.unpack_from("<BB", mv, 0)
    shape = struct.unpack_from(f"<{ndim}I", mv, 2)
    body = mv[2 + 4 * ndim:]
    tdt = _TORCH_DTYPES[dt]
    n = 1
    for s in shape:
        n *= s
    if n == 0:
        return torch.empty(shape, dtype=tdt)
    if body.readonly:
        t = torch.frombuffer(bytearray(body), dtype=tdt)
    else:
        t = torch.frombuffer(body, dtype=tdt).clone()
    return t.reshape(shape)


def _pack_entries(entries):
    """[(flags, wire_key, body)] -> one multi-op payload."""
    parts = [struct.pack("<I", len(entries))]
    for flags, key, body in entries:
        kb = key.encode()
        parts.append(struct.pack("<BH", flags, len(kb)) + kb
                     + struct.pack("<I", len(body)))
        parts.append(body)
    return b"".join(parts)


def _unpack_entries(payload):
    """[(flags, key, body memoryview)] of a multi-op payload (the bodies
    are views into the frame; the array decoders copy)."""
    view = memoryview(payload)
    (n,) = struct.unpack_from("<I", payload, 0)
    off = 4
    entries = []
    for _ in range(n):
        flags, klen = struct.unpack_from("<BH", payload, off)
        off += 3
        key = bytes(view[off:off + klen]).decode()
        off += klen
        (blen,) = struct.unpack_from("<I", payload, off)
        off += 4
        entries.append((flags, key, view[off:off + blen]))
        off += blen
    return entries


def _cmp_body(gc, wire_key, part):
    from .gradient_compression import wire_body
    return wire_body(gc, wire_key, part)


def _decode_cmp(body):
    from .gradient_compression import decode_wire
    return torch.from_numpy(decode_wire(bytes(body)))


class _StallError(RuntimeError):
    pass


class _ProtocolError(MXNetError):
    """Handshake rejected (version mismatch): permanent."""


_BARRIER_KEY = "__barrier__"


def _rank_of(wid):
    try:
        return int(str(wid).split(":", 1)[0])
    except ValueError:
        return 1 << 30


# ----------------------------------------------------------------------
# the server
# ----------------------------------------------------------------------

class _Server:
    """The reducer/optimizer server of a fixed fleet.

    A sync round of a key closes when every worker contributed; the
    contributions are added in rank order (then arrival order for a
    rank seen twice), whatever order they came in, so a round's sum
    has the same bits on every run.  A round that waits past
    ``MXNET_KVSTORE_TIMEOUT`` answers every waiter with a clean
    "stalled" error.  Replies of non-idempotent frames are cached per
    (worker session, seq) so a frame seen twice is answered, not
    applied twice."""

    def __init__(self, port, num_workers, sync=True):
        check_fixed_fleet()
        self.num_workers = num_workers
        self.sync = sync
        self.stall_timeout = float(os.environ.get(
            "MXNET_KVSTORE_TIMEOUT", "600"))
        from . import zero as _zero
        self.zero = _zero.mode()
        self._owned_bytes = {}
        self._owned_total = 0
        self._owned_shard_count = 0
        self._state_slots = -1
        self._state_total = 0
        self._audits = collections.OrderedDict()
        self.store = {}
        self.updater = None
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        # sync rounds: key -> [(rank, arrival, tensor)], round counters
        self.parts = {}
        self.done = {}
        self._round_open = {}       # key -> first-arrival time
        self._arrivals = 0
        self._stall_arrived = {}
        self._barrier_stall = {}
        self.barrier_count = 0
        self.barrier_gen = 0
        self.seen = {}
        self.dedup_window = int(os.environ.get(
            "MXNET_KV_DEDUP_WINDOW", "1024"))
        self._conns = set()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("0.0.0.0", port))
        self.sock.listen(num_workers + 8)
        self.port = self.sock.getsockname()[1]
        self._label = os.environ.get("DMLC_SERVER_ID", str(self.port))
        self._stop = False

    def set_optimizer(self, optimizer):
        from .. import optimizer as opt
        self.updater = opt.get_updater(optimizer)

    def _seen_of(self, wid):
        """Per-worker-session dedup state (caller holds the lock)."""
        ws = self.seen.get(wid)
        if ws is None:
            ws = self.seen[wid] = {
                "replies": collections.OrderedDict(), "merged": {}}
        return ws

    def _commit(self, wid, seq, rop, rpayload=b""):
        """Cache the reply of a completed non-idempotent frame."""
        if wid is None or not seq:
            return
        with self.lock:
            rep = self._seen_of(wid)["replies"]
            rep[seq] = (rop, bytes(rpayload))
            while len(rep) > self.dedup_window:
                rep.popitem(last=False)

    def _account_owned(self, key):
        """Refresh the owned/state byte gauges (caller holds the lock):
        incremental, once per applied round."""
        nb = _nbytes(self.store[key]) if key in self.store else 0
        old = self._owned_bytes.get(key, 0)
        if nb != old:
            if nb and not old and key.startswith(BUCKET_KEY_PREFIX):
                self._owned_shard_count += 1
            self._owned_bytes[key] = nb
            self._owned_total += nb - old
        if not _telemetry.enabled():
            return
        _tm_owned.labels(self._label).set(self._owned_total)
        _tm_owned_shards.labels(self._label).set(self._owned_shard_count)
        if self.updater is not None:
            if len(self.updater.states) != self._state_slots:
                self._state_slots = len(self.updater.states)
                self._state_total = self.updater.state_nbytes()
            _tm_state_bytes.labels(self._label).set(self._state_total)

    def owned_bytes(self):
        """Stored-weight bytes this server owns (placement skew)."""
        with self.lock:
            return self._owned_total

    def state_bytes(self):
        """Optimizer-state bytes resident on this server."""
        with self.lock:
            return self.updater.state_nbytes() \
                if self.updater is not None else 0

    def _apply(self, key, grad):
        """Apply a merged gradient (a CPU tensor) to the stored weight,
        or store it when no optimizer is installed."""
        from ..ndarray import NDArray
        if self.updater is not None:
            if key not in self.store:
                raise _StallError(
                    f"key {key!r} has no stored weight on this server")
            g = NDArray(grad)
            w = self.store[key]
            # identity = the key's integer (multipliers); state slot =
            # the wire key (one per chunk of a split tensor)
            if not (self.zero and key.startswith(BUCKET_KEY_PREFIX)
                    and self.updater.update_flat(
                        _int_key(key), g, w, state_key=key)):
                self.updater(_int_key(key), g, w, state_key=key)
        else:
            self.store[key] = NDArray(grad)
        self._account_owned(key)

    def _round_wait(self, key, my_round, deadline):
        """Block until round `my_round` of `key` applied; raises
        `_StallError` past the deadline."""
        while self.done.get(key, 0) <= my_round and not self._stop:
            if time.monotonic() > deadline:
                parts = self.parts.get(key)
                if parts:
                    arrived = len(parts)
                    self._stall_arrived[key] = arrived
                    self.parts.pop(key, None)
                    self._round_open.pop(key, None)
                else:
                    arrived = self._stall_arrived.get(key, 0)
                raise _StallError(
                    f"dist_sync stalled on key {key!r}: "
                    f"{arrived}/{self.num_workers} workers "
                    f"pushed within {self.stall_timeout:.0f}s — "
                    f"a worker likely died")
            self.cond.wait(timeout=min(
                5.0, max(0.1, deadline - time.monotonic())))

    def _handle_push(self, key, val, wid=None, seq=None):
        """One contribution.  Sync: block until the whole round applied.
        A contribution already merged (same worker session, seq at or
        below its marker) rejoins the wait for its round.  Returns True
        when freshly merged, False for a duplicate."""
        deadline = time.monotonic() + self.stall_timeout
        with self.cond:
            m = None
            if wid is not None and seq is not None:
                m = self._seen_of(wid)["merged"].get(key)
            if m is not None and seq <= m[0]:
                if self.sync and self.done.get(key, 0) <= m[1]:
                    self._round_wait(key, m[1], deadline)
                return False
            if not self.sync:
                self._apply(key, val)
                if wid is not None and seq is not None:
                    self._seen_of(wid)["merged"][key] = (seq, 0, 0)
                return True
            my_round = self.done.get(key, 0)
            self._arrivals += 1
            parts = self.parts.setdefault(key, [])
            if not parts:
                self._round_open[key] = time.monotonic()
            parts.append((_rank_of(wid), self._arrivals, val))
            if wid is not None and seq is not None:
                self._seen_of(wid)["merged"][key] = (seq, my_round, 0)
            if len(parts) >= self.num_workers:
                del self.parts[key]
                ro = self._round_open.pop(key, None)
                parts.sort(key=lambda p: (p[0], p[1]))
                with torch.no_grad():
                    merged = _sum([p[2] for p in parts]) if len(parts) > 1 \
                        else parts[0][2]
                self._apply(key, merged)
                self.done[key] = my_round + 1
                if ro is not None and _tracing.recording():
                    _tracing.record("server.round_close", ro,
                                    {"key": key, "round": my_round,
                                     "contributors": self.num_workers,
                                     "straggler": False})
                self.cond.notify_all()
            else:
                self._round_wait(key, my_round, deadline)
            return True

    def _handle_barrier(self, wid, seq):
        """One barrier arrival; returns a stall message or None."""
        deadline = time.monotonic() + self.stall_timeout
        with self.cond:
            merged = self._seen_of(wid)["merged"] \
                if wid is not None else {}
            m = merged.get(_BARRIER_KEY)
            if m is not None and seq is not None and seq <= m[0]:
                gen = m[1]
            else:
                gen = self.barrier_gen
                self.barrier_count += 1
                if wid is not None and seq is not None:
                    merged[_BARRIER_KEY] = (seq, gen)
            if self.barrier_count >= self.num_workers:
                self.barrier_count = 0
                self.barrier_gen += 1
                self.cond.notify_all()
            while self.barrier_gen <= gen and not self._stop:
                if time.monotonic() > deadline:
                    arrived = self._barrier_stall.setdefault(
                        gen, self.barrier_count)
                    self.barrier_count = max(0, self.barrier_count - 1)
                    return (f"dist_sync barrier stalled: "
                            f"{arrived}/{self.num_workers} workers "
                            f"arrived within {self.stall_timeout:.0f}s "
                            f"— a worker likely died")
                self.cond.wait(timeout=min(
                    5.0, max(0.1, deadline - time.monotonic())))
        return None

    def _finish(self, conn, wid, seq, rop, rpayload=b"", commit=False):
        if commit:
            self._commit(wid, seq, rop, rpayload)
        _send_msg(conn, rop, payload=rpayload, seq=seq)

    def _handshake(self, conn):
        """The first frame must be a version-matched hello; returns the
        worker session id ("rank:token"), or None after a clean error."""
        op, seq, _key, payload = _recv_msg_hs(conn)
        if op != _OP_HELLO or len(payload) < 12:
            _send_msg_hs(conn, _OP_ERROR, payload=(
                f"kvstore handshake required: this server speaks wire "
                f"protocol v{_PROTO_VERSION}; got op {op} first — is "
                f"the peer running an older build?").encode(), seq=seq)
            return None
        ver, rank, _nw = struct.unpack_from("<III", payload, 0)
        if ver != _PROTO_VERSION:
            _send_msg_hs(conn, _OP_ERROR, payload=(
                f"kvstore protocol version mismatch: worker speaks "
                f"v{ver}, server speaks v{_PROTO_VERSION} — upgrade "
                f"the older peer").encode(), seq=seq)
            return None
        token = bytes(payload[12:]).decode(errors="replace") or "-"
        _send_msg_hs(conn, _OP_HELLO, payload=struct.pack(
            "<III", _PROTO_VERSION, 0, self.num_workers), seq=seq)
        return f"{rank}:{token}"

    def _handle(self, conn):
        try:
            wid = self._handshake(conn)
            if wid is None:
                return
            while True:
                op, seq, _epoch, xid, key, payload, trace = \
                    _recv_msg_ex(conn)
                if op == _OP_STOP:
                    self._stop = True
                    _send_msg(conn, _OP_STOP, seq=seq)
                    break
                if op in _DEDUP_OPS:
                    with self.lock:
                        cached = self.seen.get(wid, {}).get(
                            "replies", {}).get(seq)
                    if cached is not None:
                        _tm_dup_frames.labels(self._label).inc()
                        _send_msg(conn, cached[0], payload=cached[1],
                                  seq=seq)
                        continue
                try:
                    with _tracing.attach(trace[0], trace[1]):
                        self._dispatch(conn, wid, op, seq, key, payload,
                                       xid)
                except (ConnectionError, OSError):
                    raise
                except Exception as e:  # noqa: BLE001 — reported below
                    # a processing failure becomes a clean reply
                    self._finish(conn, wid, seq, _OP_ERROR,
                                 (f"kvstore server failed processing "
                                  f"op {op}: {e!r}").encode(),
                                 commit=True)
        except (ConnectionError, OSError):
            pass
        finally:
            with self.lock:
                self._conns.discard(conn)
            conn.close()

    def _merge_one(self, key, arr, wid, seq, xid=0):
        """One push through the round; returns (fresh, stall message)."""
        t0 = time.monotonic() if _tracing.recording() else 0.0
        try:
            fresh = self._handle_push(key, arr, wid, seq)
        except _StallError as e:
            return None, str(e)
        if not fresh:
            _tm_dup_frames.labels(self._label).inc()
        elif t0:
            _tracing.record("server.merge", t0,
                            {"key": key, "worker": wid, "xid": xid})
        return fresh, None

    def _dispatch(self, conn, wid, op, seq, key, payload, xid=0):
        from ..ndarray import NDArray
        if op in (_OP_PUSH, _OP_PUSH_CMP):
            if op == _OP_PUSH and key == "__optimizer__":
                self.set_optimizer(pickle.loads(bytes(payload)))
                self._finish(conn, wid, seq, _OP_PUSH, commit=True)
                return
            if op == _OP_PUSH and key.startswith("__init__:"):
                k = key[len("__init__:"):]
                with self.lock:
                    if k not in self.store:
                        self.store[k] = NDArray(_unpack_array(payload))
                        self._account_owned(k)
                self._finish(conn, wid, seq, _OP_PUSH, commit=True)
                return
            arr = _decode_cmp(payload) if op == _OP_PUSH_CMP \
                else _unpack_array(payload)
            _fresh, stalled = self._merge_one(key, arr, wid, seq, xid)
            if stalled:
                self._finish(conn, wid, seq, _OP_ERROR, stalled.encode(),
                             commit=True)
            else:
                self._finish(conn, wid, seq, op, commit=True)
        elif op == _OP_PUSH_MULTI:
            # entries merge in order; every worker sends the same order
            # (the bucket plan is deterministic), so the per-key rounds
            # close in lockstep
            stalled = None
            for flags, k, body in _unpack_entries(payload):
                arr = _decode_cmp(body) if flags & _ENTRY_2BIT \
                    else _unpack_array(body)
                _fresh, stalled = self._merge_one(k, arr, wid, seq, xid)
                if stalled:
                    break
            if stalled:
                self._finish(conn, wid, seq, _OP_ERROR, stalled.encode(),
                             commit=True)
            else:
                self._finish(conn, wid, seq, _OP_PUSH_MULTI, commit=True)
        elif op == _OP_PULL_MULTI:
            # take the store's tensors under the lock, serialize outside
            with self.lock:
                snap = [(k, self.store.get(k))
                        for _f, k, _b in _unpack_entries(payload)]
            reply = [(0, k, _pack_array(v._data) if v is not None else b"")
                     for k, v in snap]
            _send_msg(conn, _OP_PULL_MULTI, payload=_pack_entries(reply),
                      seq=seq)
        elif op == _OP_PULL:
            with self.lock:
                v = self.store.get(key)
            _send_msg(conn, _OP_PULL, payload=(
                _pack_array(v._data) if v is not None else b""), seq=seq)
        elif op == _OP_AUDIT:
            import json
            aid, digest, rank = struct.unpack("<QQI", bytes(payload[:20]))
            with self.lock:
                self._audits.setdefault(int(aid), {})[int(rank)] = \
                    int(digest)
                while len(self._audits) > 8:
                    self._audits.popitem(last=False)
                recent = sorted(self._audits)[-2:]
                reply = {str(a): {str(r): d
                                  for r, d in self._audits[a].items()}
                         for a in recent}
            _send_msg(conn, _OP_AUDIT, payload=json.dumps(reply).encode(),
                      seq=seq)
        elif op == _OP_BARRIER:
            t0 = time.monotonic() if _tracing.recording() else 0.0
            stalled = self._handle_barrier(wid, seq)
            if stalled:
                self._finish(conn, wid, seq, _OP_ERROR, stalled.encode(),
                             commit=True)
            else:
                if t0:
                    _tracing.record("server.barrier", t0, {"worker": wid})
                self._finish(conn, wid, seq, _OP_BARRIER, commit=True)
        else:
            # an unknown op is reported, never dropped (a silent drop
            # desyncs the peer's reply stream)
            _send_msg(conn, _OP_ERROR, payload=(
                f"unknown kvstore op {op} (server protocol "
                f"v{_PROTO_VERSION}; elastic and admin ops are ROADMAP "
                f"item 10b)").encode(), seq=seq)

    def stop(self):
        """Stop serving: close the listener and every client socket."""
        self._stop = True
        with self.lock:
            conns = list(self._conns)
            self.cond.notify_all()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def serve_forever(self):
        self.sock.settimeout(1.0)
        threads = []
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self.lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True,
                                 name=f"mx-kv-handler-{len(threads)}")
            t.start()
            threads.append(t)
        self.stop()
        for t in threads:
            t.join(timeout=5.0)
        self.sock.close()


def run_server(port=None, num_workers=None, sync=True, optimizer=None,
               ready_event=None):
    """Serve one kvstore server until stopped.  The port defaults to
    DMLC_PS_ROOT_PORT + DMLC_SERVER_ID and the worker count to
    DMLC_NUM_WORKER."""
    if port is None:
        port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091")) \
            + int(os.environ.get("DMLC_SERVER_ID", "0"))
    num_workers = num_workers if num_workers is not None else int(
        os.environ.get("DMLC_NUM_WORKER", "1"))
    srv = _Server(port, num_workers, sync=sync)
    if optimizer is not None:
        srv.set_optimizer(optimizer)
    import weakref
    wref = weakref.ref(srv)
    _introspect.maybe_install_postmortem(role="server")
    _introspect.register_statusz(
        "kvstore_server",
        lambda: (_server_statusz(wref()) if wref() is not None
                 else {"gone": True}))
    _introspect.ensure_debugz(role="server")
    if ready_event is not None:
        ready_event.set()
    srv.serve_forever()
    return srv


def _server_statusz(srv):
    """The server's ``/-/statusz`` section (the JAX server's keys; a
    fixed fleet reports epoch 0 and every worker live)."""
    with srv.lock:
        return {
            "port": srv.port,
            "sync": srv.sync,
            "elastic": False,
            "num_workers": srv.num_workers,
            "epoch": 0,
            "live": srv.num_workers,
            "members": None,
            "fenced": None,
            "keys": len(srv.store),
            "rounds_done": sum(srv.done.values()),
            "barrier_generation": srv.barrier_gen,
            "snapshot_path": None,
            "zero": {"mode": srv.zero, "fleet_epoch": 0, "fleet": None,
                     "owned_shards": srv._owned_shard_count,
                     "moved_shards": 0},
            "bytes_owned": sum(srv._owned_bytes.values()),
            "state_bytes": (srv.updater.state_nbytes()
                            if srv.updater is not None else 0),
        }


# ----------------------------------------------------------------------
# the worker
# ----------------------------------------------------------------------

class KVStoreDist(KVStore):
    """Worker side of the distributed kvstore.

    Keys are spread over the DMLC_NUM_SERVER servers by crc32 (or by
    the ZeRO placement a bucketer registers); an array of at least
    MXNET_KVSTORE_BIGARRAY_BOUND elements that is no bucket is split
    into one contiguous chunk per server.  Bulk ops pipeline up to
    MXNET_KV_INFLIGHT frames per server before reading any reply.
    """

    def __init__(self, name="dist_sync"):
        super().__init__(name)
        check_fixed_fleet()
        self._rank = int(os.environ.get("DMLC_WORKER_RANK",
                                        os.environ.get("DMLC_RANK", "0")))
        self._num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        self._num_servers = max(1, int(os.environ.get("DMLC_NUM_SERVER",
                                                      "1")))
        addrs = os.environ.get("MXNET_KVSTORE_SERVER_ADDRS", "")
        if addrs:
            self._addrs = []
            for hp in addrs.split(","):
                host, p = hp.rsplit(":", 1)
                self._addrs.append((host, int(p)))
            self._num_servers = len(self._addrs)
        else:
            uri = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
            port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
            self._addrs = [(uri, port + i)
                           for i in range(self._num_servers)]
        self._bigarray_bound = int(os.environ.get(
            "MXNET_KVSTORE_BIGARRAY_BOUND", "1000000"))
        self._socks = {}
        self._shapes = {}
        self._gc = None
        self._plan_cache = {}
        self._inflight = max(1, int(os.environ.get(
            "MXNET_KV_INFLIGHT", "8")))
        self._token = os.urandom(8).hex()
        self._next_seq = {}
        self._pending = {}          # server -> deque of posted seqs
        self._xid = 0               # exchange id (the JAX worker's count)
        self._xid_scope = 0
        self._stage = {}            # key -> page-locked host buffer
        self.wire_bytes = 0         # request payload bytes sent
        self.reply_bytes = 0        # reply payload bytes received
        self._bucket_placement = {}
        self._placement_provider = None
        from . import zero as _zero
        self._perkey_placement = (
            _zero.IncrementalPlacement(self._num_servers)
            if _zero.enabled() and self._num_servers > 1 else None)

    def set_gradient_compression(self, compression_params):
        """Compress pushes on the wire (2-bit; dist only)."""
        super().set_gradient_compression(compression_params)
        params = dict(compression_params or {})
        if params:
            from .gradient_compression import GradientCompression
            self._gc = GradientCompression(
                type=params.get("type", "2bit"),
                threshold=float(params.get("threshold", 0.5)))
        else:
            self._gc = None

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers

    # -- connections ---------------------------------------------------
    def _handshake(self, sock):
        _send_msg_hs(sock, _OP_HELLO, payload=struct.pack(
            "<III", _PROTO_VERSION, self._rank, self._num_workers)
            + self._token.encode())
        op, _seq, _key, payload = _recv_msg_hs(sock)
        if op == _OP_ERROR:
            raise _ProtocolError("kvstore handshake rejected: "
                                 + bytes(payload).decode(errors="replace"))
        if op != _OP_HELLO or len(payload) < 4 or struct.unpack(
                "<I", bytes(payload[:4]))[0] != _PROTO_VERSION:
            raise _ProtocolError(
                f"kvstore protocol version mismatch: worker speaks "
                f"v{_PROTO_VERSION}, server replied op {op} — upgrade "
                f"the older peer")

    def _conn(self, s=0):
        if self._socks.get(s) is None:
            deadline = time.monotonic() + float(
                os.environ.get("MXNET_KVSTORE_CONNECT_TIMEOUT", "30"))
            last = None
            while time.monotonic() < deadline:
                sock = None
                try:
                    sock = socket.create_connection(self._addrs[s],
                                                    timeout=60.0)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    # outlast the server's stall timeout, so its clean
                    # error reply can arrive
                    stall = float(os.environ.get("MXNET_KVSTORE_TIMEOUT",
                                                 "600"))
                    sock.settimeout(stall + 60.0)
                    self._handshake(sock)
                    self._socks[s] = sock
                    break
                except _ProtocolError:
                    if sock is not None:
                        sock.close()
                    raise
                except OSError as e:
                    if sock is not None:
                        sock.close()
                    last = e
                    time.sleep(0.1)
            if self._socks.get(s) is None:
                raise MXNetError(f"cannot reach kvstore server "
                                 f"{s} at {self._addrs[s]}: {last}")
        return self._socks[s]

    def _post(self, s, op, key=b"", payload=b"", xid=0):
        """Sequence and send one request frame."""
        seq = self._next_seq.get(s, 1)
        self._next_seq[s] = seq + 1
        sock = self._conn(s)
        self._pending.setdefault(s, collections.deque()).append(seq)
        self.wire_bytes += len(payload)
        _send_msg(sock, op, key, payload, seq=seq, xid=xid,
                  trace=_tracing.wire_context())
        return seq

    def _reap(self, s):
        """Receive one reply (replies are FIFO per server)."""
        op, seq, key, payload = _recv_msg(self._conn(s))
        self.reply_bytes += len(payload)
        pending = self._pending.get(s)
        if pending and pending[0] == seq:
            pending.popleft()
        elif pending and seq:
            raise MXNetError(
                f"kvstore reply stream desync from server {s}: got "
                f"seq {seq}, expected {pending[0]}")
        return op, key, payload

    def _bump_xid(self):
        """A new exchange id, unless `exchange_scope` pinned one; the
        frames carry it as the JAX worker's do (a fixed-fleet server
        reads it only to tell a retried exchange, which this port never
        sends)."""
        if not self._xid_scope:
            self._xid = (self._xid + 1) & 0xFFFFFFFF or 1
        return self._xid

    def exchange_scope(self):
        """Pin one exchange id across every push inside the scope."""
        @contextlib.contextmanager
        def scope():
            self._xid_scope += 1
            if self._xid_scope == 1:
                self._xid = (self._xid + 1) & 0xFFFFFFFF or 1
            try:
                yield
            finally:
                self._xid_scope -= 1
        return scope()

    # -- key routing and big-array chunks ------------------------------
    def set_bucket_placement(self, placement):
        """Install a bucket -> server map (the ZeRO byte-balanced
        partition); memoized chunk plans are dropped."""
        self._bucket_placement.update(
            {str(k): int(s) for k, s in placement.items()})
        self._plan_cache.clear()

    def set_placement_provider(self, provider):
        """Register the fleet -> placement derivation and apply it to
        this fleet (every configured server)."""
        self._placement_provider = provider
        self.set_bucket_placement(provider(self.fleet()))

    def fleet(self):
        """The active server ids: ``MXNET_KV_FLEET`` or every server."""
        env = os.environ.get("MXNET_KV_FLEET", "").strip()
        if env:
            ids = sorted({int(x) for x in env.split(",") if x.strip()})
            return [i for i in ids if 0 <= i < self._num_servers]
        return list(range(self._num_servers))

    def rebalance_fleet(self, fleet):
        """Live ZeRO-2 rebalancing is ROADMAP item 10b."""
        raise MXNetError("rebalance_fleet (live ZeRO-2 shard rebalancing) "
                         "is ROADMAP item 10b, not ported yet")

    def _server_of(self, key):
        import zlib
        srv = self._bucket_placement.get(str(key))
        if srv is not None:
            return srv % self._num_servers
        return zlib.crc32(str(key).encode()) % self._num_servers

    def _chunk_plan(self, key, size):
        """Memoized `_compute_chunk_plan`."""
        ck = (str(key), int(size))
        plan = self._plan_cache.get(ck)
        if plan is None:
            plan = self._plan_cache[ck] = self._compute_chunk_plan(
                key, size)
        return plan

    def _compute_chunk_plan(self, key, size):
        """[(wire_key, server, (lo, hi) flat slice or None)]: a big
        array (no bucket) splits over every server, and any chunk stays
        under ~1 GiB at 8 bytes an element; chunk sizes differ by at
        most one element."""
        max_elems = (1 << 30) // 8
        nchunks = 1
        if self._num_servers > 1 and size >= self._bigarray_bound and \
                not str(key).startswith(BUCKET_KEY_PREFIX):
            nchunks = self._num_servers
        if size > nchunks * max_elems:
            nchunks = -(-size // max_elems)
        if nchunks <= 1:
            return [(str(key), self._server_of(key), None)]
        base = self._server_of(key)
        plan = []
        for j in range(nchunks):
            lo = j * size // nchunks
            hi = (j + 1) * size // nchunks
            if lo >= hi:
                continue
            plan.append((f"{key}@{j}", (base + j) % self._num_servers,
                         (lo, hi)))
        return plan

    def audit_exchange(self, audit_id, digest):
        """Post this worker's weight digest for one divergence-audit
        round and return the fleet's last two rounds as
        ``{audit_id: {rank: digest}}`` (they meet on server 0)."""
        import json
        payload = struct.pack(
            "<QQI", int(audit_id),
            int(digest) & 0xFFFFFFFFFFFFFFFF, int(self._rank))
        self._post(0, _OP_AUDIT, b"__audit__", payload)
        op, _, reply = self._reap(0)
        if op != _OP_AUDIT or not reply:
            return {}
        try:
            raw = json.loads(bytes(reply).decode())
        except ValueError:
            return {}
        return {int(a): {int(r): int(d) for r, d in m.items()}
                for a, m in raw.items()}

    # -- host staging --------------------------------------------------
    def _host(self, value, key):
        """`value`'s tensor on the host: a CUDA tensor by one copy into
        the page-locked buffer kept for `key`."""
        from ..ndarray.sparse import BaseSparseNDArray
        if isinstance(value, BaseSparseNDArray):
            value = value.tostype("default")
        t = value._data.detach()
        if t.device.type == "cpu":
            return t.contiguous()
        buf = self._stage.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._stage[key] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    def init(self, key, value):
        keys, values = _key_value_pairs(key, value)
        for k, v in zip(keys, values):
            v0 = _as_list(v)[0]
            self._shapes[str(k)] = tuple(v0.shape)
            self._route_perkey(k, v0)
            if self._rank == 0:
                arr = self._host(v0, ("init", str(k)))
                plan = self._chunk_plan(k, arr.numel())
                flat = arr.reshape(-1) if len(plan) > 1 else None
                for wk, srv, sl in plan:
                    part = arr if sl is None else flat[sl[0]:sl[1]]
                    self._post(srv, _OP_PUSH, f"__init__:{wk}".encode(),
                               _pack_array(part))
                    _tm_wire.labels("init").inc()
                    self._reap(srv)
                self._stage.pop(("init", str(k)), None)
        self.barrier()

    def _route_perkey(self, k, v0):
        """ZeRO's byte-balanced routing of a plain key at init time
        (least loaded server, in arrival order)."""
        if self._perkey_placement is None \
                or str(k).startswith(BUCKET_KEY_PREFIX):
            return
        size = 1
        for d in v0.shape:
            size *= int(d)
        if size >= self._bigarray_bound:
            return
        isz = v0._data.element_size() if hasattr(v0, "_data") and \
            v0._data is not None else 4
        key = str(k)
        fresh = key not in self._perkey_placement.placement
        srv = self._perkey_placement.assign(key, size * isz)
        if fresh and self._bucket_placement.get(key) != srv:
            self._bucket_placement[key] = srv
            self._plan_cache.clear()

    def _key_push_entries(self, k, v, tm):
        """One key's merged value as per-server wire entries
        [(server, (flags, wire_key, body))]."""
        vals = _as_list(v)
        merged = vals[0] if len(vals) == 1 else self._local_sum(vals)
        g = self._host(merged, str(k))
        nbytes = g.numel() * g.element_size()
        if tm:
            _tm_push_bytes.labels(_shard_of(k)).inc(nbytes)
        self._shapes.setdefault(str(k), tuple(g.shape))
        plan = self._chunk_plan(k, g.numel())
        flat = g.reshape(-1) if len(plan) > 1 else None
        entries = []
        for wk, srv, sl in plan:
            part = g if sl is None else flat[sl[0]:sl[1]]
            if self._gc is not None:
                entries.append((srv, (_ENTRY_2BIT, wk,
                                      _cmp_body(self._gc, wk, part))))
            else:
                entries.append((srv, (0, wk, _pack_array(part))))
        return entries

    def _key_pull_plan(self, k, olist):
        """(shape, chunk plan) of one pulled key."""
        shape = self._shapes.get(str(k))
        if shape is None and olist is not None:
            shape = tuple(_as_list(olist)[0].shape)
            self._shapes[str(k)] = shape
        size = 1
        for s in shape or ():
            size *= int(s)
        plan = self._chunk_plan(k, size) if shape is not None else \
            [(str(k), self._server_of(k), None)]
        return shape, plan

    def _deliver_pull(self, k, olist, shape, parts, tm):
        """Join chunk parts and write them into the out arrays."""
        if len(parts) == 1:
            val = parts[0]
        else:
            val = torch.cat([p.reshape(-1) for p in parts]).reshape(shape)
        if tm:
            _tm_pull_bytes.labels(_shard_of(k)).inc(
                val.numel() * val.element_size() * len(_as_list(olist)))
        for o in _as_list(olist):
            _deliver(o, val)

    def push(self, key, value, priority=0):
        keys, values = _key_value_pairs(key, value)
        xid = self._bump_xid()
        for k, vals in zip(keys, values):
            tm = _telemetry.enabled()
            t0 = time.perf_counter() if tm else 0.0
            with _tracing.span("wire.push", key=str(k), xid=xid):
                entries = self._key_push_entries(k, vals, tm)
                for srv, (flags, wk, body) in entries:
                    opc = _OP_PUSH_CMP if flags & _ENTRY_2BIT \
                        else _OP_PUSH
                    self._post(srv, opc, wk.encode(), body, xid=xid)
                    _tm_wire.labels("push").inc()
                errors = []
                for srv, _entry in entries:
                    op, _, payload = self._reap(srv)
                    if op == _OP_ERROR:
                        errors.append(bytes(payload).decode(
                            errors="replace"))
            if tm:
                _tm_allreduce.labels(_shard_of(k)).observe(
                    time.perf_counter() - t0)
            if errors:
                raise MXNetError(errors[0])

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = _key_value_pairs(key, out)
        for k, olist in zip(keys, outs):
            with _tracing.span("wire.pull", key=str(k)):
                shape, plan = self._key_pull_plan(k, olist)
                for wk, srv, sl in plan:
                    self._post(srv, _OP_PULL, wk.encode())
                    _tm_wire.labels("pull").inc()
                parts = []
                for wk, srv, sl in plan:
                    op, _, payload = self._reap(srv)
                    if not payload:
                        raise MXNetError(
                            f"key {k!r} not initialized on server")
                    parts.append(_unpack_array(payload))
                self._deliver_pull(k, olist, shape, parts,
                                   _telemetry.enabled())

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if self._type.startswith("dist_sync"):
            self.barrier()
        if out is not None:
            self.pull(key, out, priority)

    # -- multi-key bulk ops --------------------------------------------
    def _send_frames(self, op, per_server, xid=0):
        """Pipelined bulk send: each server's entries split into about
        MXNET_KV_INFLIGHT frames (none over `_MAX_FRAME_BYTES`, counting
        a pull's expected reply), every frame is sent round-robin across
        servers before any reply is read, then replies are read in send
        order.  Returns {server: [reply payload, ...]}; the first error
        reply closes the transport and raises."""
        frames = {}
        for srv, entries in per_server.items():
            target = -(-len(entries) // self._inflight)
            fl, cur, cur_bytes = [], [], 0
            for e in entries:
                if cur and (len(cur) >= target
                            or cur_bytes + e[3] > _MAX_FRAME_BYTES):
                    fl.append(cur)
                    cur, cur_bytes = [], 0
                cur.append(e)
                cur_bytes += e[3]
            if cur:
                fl.append(cur)
            frames[srv] = fl
        opname = "push_multi" if op == _OP_PUSH_MULTI else "pull_multi"
        depth = max(len(fl) for fl in frames.values())
        rec = _tracing.recording()
        post_ts = {}
        for i in range(depth):
            for srv, fl in frames.items():
                if i < len(fl):
                    if rec:
                        post_ts[(srv, i)] = time.monotonic()
                    payload = _pack_entries([e[:3] for e in fl[i]])
                    self._post(srv, op, payload=payload, xid=xid)
                    _tm_wire.labels(opname).inc()
                    if _telemetry.enabled():
                        _tm_wire_bytes.labels(opname).inc(len(payload))
        if _telemetry.enabled():
            for fl in frames.values():
                _tm_inflight.labels(opname).observe(len(fl))
        replies, error = {}, None
        for srv, fl in frames.items():
            out = []
            for i, _ in enumerate(fl):
                rop, _, payload = self._reap(srv)
                if rop == _OP_ERROR:
                    error = bytes(payload).decode(errors="replace")
                    break
                if rec and (srv, i) in post_ts:
                    _tracing.record("wire.frame", post_ts[(srv, i)],
                                    {"server": srv, "op": opname,
                                     "entries": len(fl[i])})
                out.append(payload)
            replies[srv] = out
            if error:
                break
        if error:
            # a stall means a dead peer: fail fast, drop unread replies
            self.close()
            raise MXNetError(error)
        return replies

    def push_multi(self, keys, values, priority=0):
        """Bulk push: every key's chunks in at most MXNET_KV_INFLIGHT
        pipelined frames per server."""
        keys = list(keys)
        if not keys:
            return
        tm = _telemetry.enabled()
        t0 = time.perf_counter() if tm else 0.0
        xid = self._bump_xid()
        with _tracing.span("wire.push_multi", keys=len(keys), xid=xid):
            per_server = {}
            for k, v in zip(keys, values):
                for srv, entry in self._key_push_entries(k, v, tm):
                    per_server.setdefault(srv, []).append(
                        entry + (len(entry[2]),))
            self._send_frames(_OP_PUSH_MULTI, per_server, xid=xid)
        if tm:
            _tm_multi_secs.labels("push").observe(time.perf_counter() - t0)

    def pull_multi(self, keys, outs, priority=0):
        """Bulk pull: the mirror of `push_multi` (requests carry empty
        bodies; replies echo each wire key with its value)."""
        keys = list(keys)
        outs = list(outs)
        if not keys:
            return
        tm = _telemetry.enabled()
        t0 = time.perf_counter() if tm else 0.0
        with _tracing.span("wire.pull_multi", keys=len(keys)):
            per_server, plans = {}, []
            for k, olist in zip(keys, outs):
                shape, plan = self._key_pull_plan(k, olist)
                plans.append((k, olist, shape, plan))
                size = 1
                for s in shape or ():
                    size *= int(s)
                for wk, srv, sl in plan:
                    elems = (sl[1] - sl[0]) if sl is not None else size
                    per_server.setdefault(srv, []).append(
                        (0, wk, b"", elems * 8 + 64))
            replies = self._send_frames(_OP_PULL_MULTI, per_server)
            got = {}
            for payloads in replies.values():
                for payload in payloads:
                    for _f, wk, body in _unpack_entries(payload):
                        got[wk] = body
            for k, olist, shape, plan in plans:
                parts = []
                for wk, srv, sl in plan:
                    body = got.get(wk, b"")
                    if not len(body):
                        raise MXNetError(
                            f"key {k!r} not initialized on server")
                    parts.append(_unpack_array(body))
                self._deliver_pull(k, olist, shape, parts, tm)
        if tm:
            _tm_multi_secs.labels("pull").observe(time.perf_counter() - t0)

    def pushpull_multi(self, keys, values, outs=None, priority=0):
        """Bulk allreduce: a sync push is answered only after its round
        applied, so the pull that follows reads the reduced value (no
        barrier between the phases)."""
        self.push_multi(keys, values, priority)
        if outs is not None:
            self.pull_multi(keys, outs, priority)

    def stream_exchange(self):
        """A `_StreamExchange` for the overlapped exchange."""
        return _StreamExchange(self)

    def barrier(self):
        """A barrier on every server in turn."""
        with _tracing.span("wire.barrier"):
            for s in range(self._num_servers):
                self._post(s, _OP_BARRIER)
                _tm_wire.labels("barrier").inc()
                op, _, payload = self._reap(s)
                if op == _OP_ERROR:
                    raise MXNetError(bytes(payload).decode(
                        errors="replace"))

    def set_optimizer(self, optimizer):
        """Ship the optimizer (pickled) to every server: rank 0 sends,
        everyone barriers.  A port server unpickles the port's
        optimizer only."""
        super().set_optimizer(optimizer)
        if self._rank == 0:
            blob = pickle.dumps(optimizer)
            for s in range(self._num_servers):
                self._post(s, _OP_PUSH, b"__optimizer__", blob)
                _tm_wire.labels("optimizer").inc()
                self._reap(s)
        self.barrier()

    def _local_sum(self, vals):
        from ..ndarray import NDArray
        with torch.no_grad():
            return NDArray(_sum([v._data for v in vals]))

    def membership(self):
        """A fixed fleet: epoch 0, every worker live."""
        from .base import MembershipInfo
        return MembershipInfo(elastic=False, epoch=0,
                              live=self._num_workers, rank=self._rank)

    def close(self):
        for sock in list(self._socks.values()):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        self._socks.clear()
        self._pending.clear()


class _StreamExchange:
    """One streamed bucketed exchange over a `KVStoreDist`
    (MXNET_KV_OVERLAP).

    A bucket's push is posted the moment it is ready (during backward),
    :meth:`drain` reads whatever replies already arrived without
    blocking, the bucket's pull is posted right behind its push on the
    same connection, and only :meth:`finish` blocks.  The sender is
    cooperative: while its own send would block it reads ready replies,
    so a server sending a big pull reply into a full receive buffer
    cannot deadlock against a big push.  A transport error is kept and
    every later call is a no-op until :meth:`finish` raises it.
    """

    def __init__(self, kv):
        self.kv = kv
        self._scope = kv.exchange_scope()
        self._scope.__enter__()
        self.xid = kv._bump_xid()
        self._order = {}        # srv -> deque[(kind, token)]
        self._push_left = {}
        self._acked = []
        self._consumed = 0
        self._got = {}
        self._plans = []
        self._err = None
        self._closed = False
        self.wire_seconds = 0.0
        self._ntok = 0

    @property
    def broken(self):
        return self._err is not None

    def _fail(self, e):
        self._err = e
        for q in self._order.values():
            q.clear()
        self.kv.close()

    def _srv_of_sock(self, sock):
        for s, sk in self.kv._socks.items():
            if sk is sock:
                return s
        return None

    def _send_coop(self, sock, frame):
        mv = memoryview(frame)
        off = 0
        while off < len(mv):
            rd = [sk for s, sk in self.kv._socks.items()
                  if sk is not None and self._order.get(s)]
            r, w, _x = select.select(rd, [sock], [], 120.0)
            progressed = False
            for rs in r:
                s = self._srv_of_sock(rs)
                if s is not None and self._order.get(s):
                    self._reap_one(s)
                    progressed = True
            if sock in w:
                n = sock.send(mv[off:off + (1 << 20)])
                if n == 0:
                    raise ConnectionError("socket closed")
                off += n
                progressed = True
            if not progressed:
                raise socket.timeout("streamed send stalled")

    def _post_frame(self, srv, op, payload, kind, tok, xid=0):
        kv = self.kv
        seq = kv._next_seq.get(srv, 1)
        kv._next_seq[srv] = seq + 1
        sock = kv._conn(srv)
        kv._pending.setdefault(srv, collections.deque()).append(seq)
        kv.wire_bytes += len(payload)
        self._order.setdefault(srv, collections.deque()).append(
            (kind, tok))
        frame = _frame_header(op, b"", payload, seq, 0, xid,
                              _tracing.wire_context()) + payload
        self._send_coop(sock, frame)

    def post_push(self, keys, values):
        """Serialize and post one ready bucket's push (no reply wait);
        returns a token, or None when the session is broken."""
        if self._err is not None:
            return None
        t0 = time.perf_counter()
        tok = self._ntok = self._ntok + 1
        tm = _telemetry.enabled()
        try:
            with _tracing.span("wire.push_multi", keys=len(list(keys)),
                               xid=self.xid, streamed=True):
                per_server = {}
                for k, v in zip(keys, values):
                    for srv, entry in self.kv._key_push_entries(k, v, tm):
                        per_server.setdefault(srv, []).append(entry)
                frames = [(srv, fr) for srv, entries
                          in per_server.items()
                          for fr in _frames_under_cap(entries)]
                self._push_left[tok] = len(frames)
                if not frames:
                    self._acked.append(tok)
                for srv, fr in frames:
                    self._post_frame(srv, _OP_PUSH_MULTI,
                                     _pack_entries(fr), "push", tok,
                                     xid=self.xid)
                    _tm_wire.labels("push_multi").inc()
        except (MXNetError, ConnectionError, OSError) as e:
            self._fail(e)
            return None
        finally:
            self.wire_seconds += time.perf_counter() - t0
        return tok

    def post_pull(self, keys, outs):
        """Post one bucket's pull; its reply is delivered at
        :meth:`finish`."""
        if self._err is not None:
            return
        t0 = time.perf_counter()
        try:
            with _tracing.span("wire.pull_multi", keys=len(list(keys)),
                               streamed=True):
                per_server = {}
                for k, olist in zip(keys, outs):
                    shape, plan = self.kv._key_pull_plan(k, olist)
                    self._plans.append((k, olist, shape, plan))
                    for wk, srv, sl in plan:
                        per_server.setdefault(srv, []).append(
                            (0, wk, b""))
                for srv, entries in per_server.items():
                    self._post_frame(srv, _OP_PULL_MULTI,
                                     _pack_entries(entries), "pull", None)
                    _tm_wire.labels("pull_multi").inc()
        except (MXNetError, ConnectionError, OSError) as e:
            self._fail(e)
        finally:
            self.wire_seconds += time.perf_counter() - t0

    def _reap_one(self, srv):
        kind, tok = self._order[srv][0]
        op, _key, payload = self.kv._reap(srv)
        self._order[srv].popleft()
        if op == _OP_ERROR:
            raise MXNetError(bytes(payload).decode(errors="replace"))
        if kind == "push":
            left = self._push_left[tok] = self._push_left[tok] - 1
            if left == 0:
                self._acked.append(tok)
        else:
            for _f, wk, body in _unpack_entries(payload):
                self._got[wk] = body

    def drain(self):
        """Read every reply already in a socket buffer (never blocks on
        a quiet socket); returns the push tokens newly acked."""
        if self._err is not None:
            return []
        t0 = time.perf_counter()
        try:
            for srv in list(self._order):
                while self._order.get(srv):
                    sock = self.kv._socks.get(srv)
                    if sock is None:
                        break
                    r, _w, _x = select.select([sock], [], [], 0)
                    if not r:
                        break
                    self._reap_one(srv)
        except (MXNetError, ConnectionError, OSError) as e:
            self._fail(e)
            return []
        finally:
            self.wire_seconds += time.perf_counter() - t0
        fresh = self._acked[self._consumed:]
        self._consumed = len(self._acked)
        return fresh

    def finish(self):
        """Block until every posted frame is answered, deliver the
        pulled values and raise any kept error.  Returns {wire_key:
        body}."""
        t0 = time.perf_counter()
        try:
            with _tracing.span("wire.flush", streamed=True):
                while self._err is None and any(
                        self._order.get(s) for s in list(self._order)):
                    for srv in list(self._order):
                        try:
                            while self._order.get(srv):
                                self._reap_one(srv)
                        except (MXNetError, ConnectionError,
                                OSError) as e:
                            self._fail(e)
                            break
        finally:
            self.wire_seconds += time.perf_counter() - t0
            self.close()
        if self._err is not None:
            raise self._err
        tm = _telemetry.enabled()
        for k, olist, shape, plan in self._plans:
            parts = []
            for wk, _srv, _sl in plan:
                body = self._got.get(wk, b"")
                if not len(body):
                    raise MXNetError(
                        f"key {k!r} not initialized on server")
                parts.append(_unpack_array(body))
            if olist is not None:
                self.kv._deliver_pull(k, olist, shape, parts, tm)
        return self._got

    def close(self):
        if not self._closed:
            self._closed = True
            self._scope.__exit__(None, None, None)
            if _telemetry.enabled():
                _tm_multi_secs.labels("stream").observe(self.wire_seconds)

    def abort(self):
        """Abandon the session; resets the transport when replies were
        still outstanding (unread, they would desync the next
        exchange)."""
        if self._err is None and any(self._order.values()):
            self.kv.close()
        for q in self._order.values():
            q.clear()
        self.close()


def _frames_under_cap(entries):
    """One bucket's entries split into frames under `_MAX_FRAME_BYTES`."""
    cur, cur_bytes = [], 0
    for e in entries:
        nb = len(e[2])
        if cur and cur_bytes + nb > _MAX_FRAME_BYTES:
            yield cur
            cur, cur_bytes = [], 0
        cur.append(e)
        cur_bytes += nb
    if cur:
        yield cur
