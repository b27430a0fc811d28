"""ZeRO sharding over the bucketed kvstore (counterpart of
`incubator_mxnet_tpu/kvstore/zero.py`).

``MXNET_KV_ZERO`` is the level: 1 places the gradient buckets on the
servers byte-balanced and keeps the optimizer state only there (each
server owns ~1/N of it and updates each owned bucket in one flat pass);
2 also makes the exchange a reduce-scatter (each bucket goes only to
its owner, workers pull updated weights back).  `ParallelTrainer` reads
the same level when no `zero=` is given.

The placement is a pure function of the bucket plan and the server
count, so every worker derives the same map with no coordination:
`balanced_assignment` is a greedy largest-first bin packing,
`placement_for_plan`/`placement_for_fleet` map a plan's wire keys onto
servers, `byte_skew` is the max/mean owned-byte balance, and
`IncrementalPlacement` routes per-key (unbucketed) keys to the least
loaded server in arrival order.
"""
from __future__ import annotations

from ..base import get_env

__all__ = ["enabled", "mode", "reduce_scatter", "balanced_assignment",
           "placement_for_plan", "placement_for_fleet", "byte_skew",
           "IncrementalPlacement"]


def mode():
    """The ``MXNET_KV_ZERO`` level: 0 (off), 1 (sharded optimizer
    state), 2 (and the gradients reduce-scattered).  Bare truthy values
    ("true", "yes", "on") parse as level 1."""
    raw = get_env("MXNET_KV_ZERO", "0", str).strip().lower()
    try:
        return max(0, int(raw))
    except ValueError:
        return 1 if raw in ("true", "yes", "on") else 0


def enabled():
    """Whether any ZeRO sharding (``MXNET_KV_ZERO`` >= 1) is on."""
    return mode() >= 1


def reduce_scatter():
    """Whether the ZeRO-2 reduce-scatter exchange is on."""
    return mode() >= 2


def balanced_assignment(sizes, num_servers):
    """Greedy largest-first partition: ``sizes[i]`` bytes → a server.

    Deterministic: items are visited largest-first (ties broken by
    position), each assigned to the currently least-loaded server
    (ties broken by server index).  Returns the per-item server list.
    This is the classic LPT bound — the heaviest bin is within 4/3 of
    the mean even adversarially, and for realistic bucket plans (many
    equal size-targeted buckets plus a few odd tails) it lands well
    under the 1.2 max/mean gate.
    """
    num_servers = max(1, int(num_servers))
    assign = [0] * len(sizes)
    if num_servers == 1:
        return assign
    loads = [0] * num_servers
    order = sorted(range(len(sizes)), key=lambda i: (-int(sizes[i]), i))
    for i in order:
        srv = min(range(num_servers), key=lambda s: (loads[s], s))
        assign[i] = srv
        loads[srv] += int(sizes[i])
    return assign


def placement_for_plan(plan, num_servers):
    """{wire_key: server} for a bucket plan (see
    `bucket.GradientBucketer`).  Pure in (plan, num_servers): the plan
    is itself a pure function of the ordered item list and the byte
    target, so every worker lands on the same map."""
    return placement_for_fleet(plan, range(int(num_servers)))


def placement_for_fleet(plan, fleet):
    """{wire_key: server_id} for a bucket plan over an explicit ACTIVE
    server-id list.  Pure in (plan, sorted(fleet)) — every worker AND
    server that knows the fleet derives the identical ownership map
    with no coordination beyond the fleet itself."""
    ids = sorted(set(int(s) for s in fleet))
    if not ids:
        ids = [0]
    assign = balanced_assignment([b.nbytes for b in plan], len(ids))
    return {b.wire_key: ids[bin_] for b, bin_ in zip(plan, assign)}


def byte_skew(bytes_by_server):
    """max/mean skew of a per-server byte distribution (1.0 = perfectly
    balanced; 0.0 when nothing is owned anywhere)."""
    vals = [max(0, int(v)) for v in bytes_by_server]
    total = sum(vals)
    if not vals or total == 0:
        return 0.0
    return max(vals) / (total / len(vals))


class IncrementalPlacement:
    """Arrival-order balanced placement for PLAIN (non-bucket) keys.

    The bucketed path can bin-pack largest-first because the whole
    plan is known up front; per-key `init` sees keys one at a time,
    and a largest-first repack would REASSIGN earlier keys as later
    ones arrive — different workers racing through init would then
    hold different maps.  Greedy-by-arrival is stable (a key's route
    never changes once assigned) and still bounds the skew far under
    what crc32 gives a census of mixed sizes, because every new key
    lands on the currently least-loaded server.  Keys big enough for
    the dist layer's chunked big-array split are left to it (the
    split already spreads them over every server)."""

    def __init__(self, num_servers):
        self.num_servers = max(1, int(num_servers))
        self.loads = [0] * self.num_servers
        self.placement = {}

    def assign(self, key, nbytes):
        """Route `key` (idempotent: a re-init keeps its server) and
        return the owning server index."""
        key = str(key)
        srv = self.placement.get(key)
        if srv is None:
            srv = min(range(self.num_servers),
                      key=lambda s: (self.loads[s], s))
            self.placement[key] = srv
            self.loads[srv] += max(0, int(nbytes))
        return srv

    def skew(self):
        return byte_skew(self.loads)
