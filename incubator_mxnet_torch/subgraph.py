"""Subgraph partitioning: backend-pluggable graph rewriting
(counterpart of `incubator_mxnet_tpu/subgraph.py`).

A backend (`SubgraphProperty`, registered by name and chosen by
argument or `MXNET_SUBGRAPH_BACKEND`) selects ops; maximal
single-consumer chains of them become one `_subgraph` node whose
attribute holds the inner Symbol, which the interpreter inlines, so a
partitioned graph computes what the original does.
`SubgraphProperty.rewrite` lets a backend replace the inner graph
wholesale, as the int8 backend (`contrib.quantization.
INT8SubgraphProperty`) does.
"""
from __future__ import annotations

from .base import MXNetError, get_env

__all__ = ["SubgraphProperty", "register_subgraph_property",
           "get_subgraph_property", "list_subgraph_backends",
           "partition_graph"]

_BACKENDS = {}


class SubgraphProperty:
    """Selection + rewrite policy for one backend."""

    name = "base"

    def select(self, node):
        """Whether `node` (a Symbol op node) may join a subgraph."""
        return False

    def rewrite(self, subgraph):
        """Hook: transform the carved-out Symbol before embedding
        (identity by default).  Return None to VETO the carve — the
        region stays in the outer graph untouched (e.g. the int8
        property vetoes regions with nothing quantizable, instead of
        littering the graph with wrapper nodes)."""
        return subgraph

    def min_size(self):
        """Smallest group worth carving out."""
        return 2


def register_subgraph_property(prop):
    inst = prop() if isinstance(prop, type) else prop
    _BACKENDS[inst.name] = inst
    return prop


def get_subgraph_property(name):
    try:
        return _BACKENDS[name]
    except KeyError:
        raise MXNetError(
            f"no subgraph backend {name!r}; have {sorted(_BACKENDS)}") \
            from None


def list_subgraph_backends():
    return sorted(_BACKENDS)


def _consumers(order):
    cons = {}
    for n in order:
        for inp in n._inputs:
            base = inp._base or inp
            cons.setdefault(id(base), []).append(n)
    return cons


def _chainable(prop, node, group_of):
    """A node may join a chain when selected, ungrouped, single-output
    (slot routing through a collapsed chain is undefined), and every
    input past the first (the dataflow edge) is a leaf var — the
    weight/bias pattern of Conv/FC nodes (ref: the MKLDNN property
    carved conv+weight subgraphs, not just elementwise chains [U])."""
    if node.is_var() or not prop.select(node) or id(node) in group_of \
            or len(node._inputs) < 1 \
            or getattr(node, "_num_outputs", 1) != 1:
        return False
    return all(i.is_var() for i in node._inputs[1:])


def partition_graph(symbol, backend=None):
    """Return a new Symbol with backend-selected chains collapsed into
    `_subgraph` nodes (ref: Symbol.get_backend_symbol / the
    BuildSubgraph pass [U]).  `backend` defaults to
    MXNET_SUBGRAPH_BACKEND; it may be a backend name or a
    SubgraphProperty instance (stateful backends — e.g. the int8
    property carrying arg_params — pass instances)."""
    from .symbol.symbol import Symbol

    backend = backend or get_env("MXNET_SUBGRAPH_BACKEND")
    if not backend:
        return symbol
    prop = backend if isinstance(backend, SubgraphProperty) \
        else get_subgraph_property(backend)

    order = symbol._topo()
    cons = _consumers(order)

    # maximal chains along the FIRST (dataflow) input: selected node ->
    # its single selected consumer; weight/bias var inputs ride along
    group_of = {}
    groups = []
    for n in order:
        if not _chainable(prop, n, group_of):
            continue
        chain = [n]
        group_of[id(n)] = len(groups)
        cur = n
        while True:
            cs = cons.get(id(cur), [])
            if len(cs) != 1:
                break
            nxt = cs[0]
            if not _chainable(prop, nxt, group_of) \
                    or (nxt._inputs[0]._base or nxt._inputs[0]) is not cur:
                break
            chain.append(nxt)
            group_of[id(nxt)] = len(groups)
            cur = nxt
        groups.append(chain)

    groups = [g for g in groups if len(g) >= prop.min_size()]

    # build + rewrite every inner graph UP FRONT: a rewrite returning
    # None vetoes its group (the region stays in the outer graph)
    def build_inner(chain):
        inner = Symbol.var("_sg_in0")
        for n in chain:
            inner = Symbol(op=n._op,
                           inputs=(inner,) + tuple(n._inputs[1:]),
                           attrs=dict(n._attrs), name=n._name)
        return prop.rewrite(inner)

    inners = [build_inner(g) for g in groups]
    keep = [i for i, inner in enumerate(inners) if inner is not None]
    groups = [groups[i] for i in keep]
    inners = [inners[i] for i in keep]
    grouped = {id(n): gi for gi, g in enumerate(groups) for n in g}

    # rebuild the graph bottom-up, splicing one _subgraph node per group
    new_of = {}

    def rebuild(node):
        base = node._base or node
        if id(base) in new_of:
            return new_of[id(base)]
        gi = grouped.get(id(base))
        if gi is not None and base is groups[gi][-1]:
            chain = groups[gi]
            head_in = chain[0]._inputs[0]
            outer_in = rebuild(head_in)
            if (head_in._base or head_in) is not head_in:
                # keep the selected slot of a multi-output producer
                outer_in = outer_in[head_in._out_index]
            # inner graph (built + rewritten up front): the dataflow
            # input is the _sg_in0 placeholder; weight/bias vars keep
            # their ORIGINAL names, so arg_params binding is untouched
            inner = inners[gi]
            # the rewrite may have introduced NEW free vars (e.g. int8
            # weights + ranges): the sg node's input list mirrors the
            # inner graph's free vars, in order, with matching names
            in_names, outer_inputs = [], []
            for v in inner._topo():
                if not v.is_var():
                    continue
                in_names.append(v._name)
                outer_inputs.append(outer_in if v._name == "_sg_in0"
                                    else Symbol.var(v._name))
            sg = Symbol(op="_subgraph", inputs=tuple(outer_inputs),
                        attrs={"__subgraph__": inner,
                               "__sg_inputs__": tuple(in_names),
                               "__backend__": prop.name},
                        name=f"{prop.name}_sg{gi}")
            new_of[id(base)] = sg
            return sg
        if gi is not None:
            # interior chain node reached directly (shouldn't happen:
            # single-consumer chains) — fall through to normal copy
            pass
        if base.is_var() or base._op == "_const":
            new_of[id(base)] = base
            return base
        new_inputs = []
        for inp in base._inputs:
            nb = rebuild(inp)
            if (inp._base or inp) is not inp:   # multi-output slot
                nb = nb[inp._out_index]
            new_inputs.append(nb)
        s = Symbol(op=base._op, inputs=tuple(new_inputs),
                   attrs=dict(base._attrs), name=base._name)
        s._num_outputs = base._num_outputs
        new_of[id(base)] = s
        return s

    return rebuild(symbol)
