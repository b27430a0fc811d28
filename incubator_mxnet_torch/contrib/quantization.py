"""Post-training int8 quantization (counterpart of
`incubator_mxnet_tpu/contrib/quantization.py`).

Two backends, as there:

- ``backend='native'`` (default): int8 compute.  `quantize_net` swaps
  Conv2D/Dense blocks for fused per-channel int8 layers
  (`_quantized_conv_pc` / `_quantized_dense_pc`, which on the card run
  this repo's `int8_quantize` and `int8_igemm` kernels);
  `quantize_model` rewrites a Symbol graph onto the per-tensor ops
  (quantize_v2 -> quantized_conv/fc -> dequantize).
- ``backend='fake'``: weights quantized and dequantized, the float
  compute path unchanged, for measuring the accuracy cost alone.

`quantize_weight`, `quantize_weight_per_channel` and `calib_threshold`
are the JAX package's numpy code on the host, so thresholds, int8
weights and scales are bit for bit the JAX package's from the same
float weights.  A net served after `quantize_net` should be calibrated:
with dynamic activation scales a row's int8 values depend on the
largest value of its whole batch, so a served answer would differ from
a lone forward of the same rows.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, numpy_dtype
from ..ndarray import NDArray, array
from ..subgraph import SubgraphProperty as _SubgraphProperty

__all__ = ["quantize_model", "quantize_net", "quantize_weight",
           "INT8SubgraphProperty",
           "quantize_weight_per_channel", "calib_threshold"]


def _numpy(a):
    """An array on the host as the JAX package's `asnumpy` gives it:
    bfloat16 as ml_dtypes' bfloat16 where that imports (the port's
    `asnumpy` widens it to float32), so numpy computes in the same
    types on both sides."""
    if isinstance(a, torch.Tensor):
        a = NDArray(a.detach())
    if not isinstance(a, NDArray):
        return _np.asarray(a)
    host = a.asnumpy()
    if a._data.dtype == torch.bfloat16:
        bf16 = numpy_dtype(torch.bfloat16)
        if isinstance(bf16, _np.dtype):
            host = host.astype(bf16)
    return host


def _to_nd(a, ctx):
    if a.dtype.name == "bfloat16":
        return array(a.astype(_np.float32), ctx=ctx, dtype="bfloat16")
    return array(a, ctx=ctx)


def _ctx_of(a):
    return a.context if isinstance(a, NDArray) else None


def quantize_weight(w, num_bits=8):
    """Symmetric per-tensor fake-quantization of one array; the result
    stays on the source array's device."""
    a = _numpy(w)
    amax = float(_np.abs(a).max()) or 1.0
    qmax = 2 ** (num_bits - 1) - 1
    scale = amax / qmax
    q = _np.clip(_np.round(a / scale), -qmax - 1, qmax)
    return _to_nd((q * scale).astype(a.dtype), _ctx_of(w)), scale


def quantize_weight_per_channel(w):
    """Symmetric per-output-channel int8 quantization: (q_int8, scales).
    Channel axis 0 (OIHW conv weights / (O, I) dense weights).  Results
    stay on the source array's device."""
    a = _numpy(w).astype(_np.float32)
    amax = _np.abs(a.reshape(a.shape[0], -1)).max(axis=1)
    scales = _np.maximum(amax, 1e-12) / 127.0
    q = _np.clip(_np.round(a / scales.reshape((-1,) + (1,) * (a.ndim - 1))),
                 -127, 127).astype(_np.int8)
    ctx = _ctx_of(w)
    return array(q, ctx=ctx), array(scales.astype(_np.float32), ctx=ctx)


def calib_threshold(samples, mode="naive", num_bins=2048):
    """Activation threshold from calibration data: 'naive' = minmax,
    'entropy' = the KL-divergence optimal clip.

    The KL is computed against the full-support reference distribution:
    candidate threshold i keeps bins [0, i) quantized to 128 levels and
    assigns only epsilon mass beyond, so clipping real tail mass costs
    log(p/eps), balancing clip distortion against in-range resolution."""
    a = _np.abs(_np.concatenate([_np.ravel(s) for s in samples]))
    if mode == "naive":
        return float(a.max())
    hist, edges = _np.histogram(a, bins=num_bins)
    total = float(hist.sum()) or 1.0
    p_full = hist.astype(_np.float64) / total
    nz = p_full > 0
    eps = 1e-9
    best_kl, best_t = _np.inf, float(a.max())
    for i in range(128, num_bins + 1, 8):
        clipped = hist[:i].astype(_np.float64)
        # 128-level quantization of the kept range: each level's mass is
        # spread uniformly over its (nonzero) bins
        q = _np.zeros(num_bins, _np.float64)
        for lvl in _np.array_split(_np.arange(i), 128):
            m = clipped[lvl].sum()
            live = lvl[clipped[lvl] > 0]
            if len(live):
                q[live] = m / len(live)
        q /= total
        kl = float((p_full[nz] *
                    _np.log(p_full[nz] / (q[nz] + eps))).sum())
        if kl < best_kl:
            best_kl, best_t = kl, float(edges[i] if i < num_bins
                                        else edges[-1])
    return best_t


# ===========================================================================
# symbolic path: quantize_model graph rewrite
# ===========================================================================

_QUANTIZABLE = {"Convolution": "_contrib_quantized_conv",
                "FullyConnected": "_contrib_quantized_fully_connected"}


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, calib_mode="none", calib_data=None,
                   num_calib_examples=None, quantized_dtype="int8",
                   excluded_sym_names=(), **kwargs):
    """Rewrite a Symbol graph onto int8 ops.

    Conv/FC nodes whose weights are in `arg_params` become quantize_v2
    -> quantized_conv/fc -> dequantize chains; their weights are
    replaced by int8 arrays (on the float weight's device) plus min/max
    range params.  Activation ranges are the runtime min/max.  Returns
    (quantized symbol, new arg_params, aux_params)."""
    from ..symbol.symbol import Symbol, Group
    from ..ops import registry as _reg

    if quantized_dtype not in ("int8",):
        raise MXNetError("quantize_model: only int8 is supported")
    excluded = set(excluded_sym_names)
    qargs = {k: v for k, v in arg_params.items()}

    heads = sym._head_list() if isinstance(sym, Group) else [sym]
    order = sym._topo()
    new_of = {}                        # id(old base) -> new Symbol (base)

    def new_input(inp):
        base = inp._base or inp
        nb = new_of[id(base)]
        return nb[inp._out_index] if len(nb) > 1 else nb

    for node in order:
        if node.is_var() or node._op == "_const":
            new_of[id(node)] = node
            continue
        inputs = [new_input(i) for i in node._inputs]
        opname = node._op
        qop = _QUANTIZABLE.get(opname)
        wsym = node._inputs[1] if len(node._inputs) > 1 else None
        wname = wsym._name if wsym is not None and wsym.is_var() else None
        if qop and node._name not in excluded and wname in arg_params \
                and not node._attrs.get("num_group", 1) > 1:
            attrs = {k: v for k, v in node._attrs.items()
                     if k not in ("__present__",)}
            no_bias = attrs.get("no_bias", opname == "Convolution" and
                                len(node._inputs) < 3)
            # int8 weight + range params (idempotent for shared weights)
            if wname + "_quantized" not in qargs:
                w = arg_params[wname]
                wa = _numpy(w)
                amax = float(_np.abs(wa).max()) or 1e-12
                qw = _np.clip(_np.round(wa.astype(_np.float32) /
                                        (amax / 127.0)), -127, 127) \
                    .astype(_np.int8)
                ctx = _ctx_of(w)
                qargs[wname + "_quantized"] = array(qw, ctx=ctx)
                qargs[wname + "_min"] = array(_np.float32(-amax), ctx=ctx)
                qargs[wname + "_max"] = array(_np.float32(amax), ctx=ctx)

            data_q = Symbol("_contrib_quantize_v2", [inputs[0]], {},
                            name=f"{node._name}_quantize", num_outputs=3)
            wvar = Symbol.var(wname + "_quantized")
            wmin = Symbol.var(wname + "_min")
            wmax = Symbol.var(wname + "_max")
            q_attrs = {k: v for k, v in attrs.items()
                       if k in _reg.get_opdef(qop).attr_names}
            q_attrs["no_bias"] = True
            qnode = Symbol(qop,
                           [data_q[0], wvar, data_q[1], data_q[2],
                            wmin, wmax],
                           dict(q_attrs, __present__=(
                               True, True, False, True, True, True, True,
                               False, False)),
                           name=f"{node._name}_quantized", num_outputs=3)
            deq = Symbol("_contrib_dequantize", [qnode[0], qnode[1],
                                                 qnode[2]], {},
                         name=f"{node._name}_dequantize")
            out = deq
            if not no_bias and len(node._inputs) > 2:
                bsym = inputs[2]
                if opname == "Convolution":
                    nd_sp = len(attrs.get("kernel", ()))
                    bshape = (1, -1) + (1,) * nd_sp
                    bsym = Symbol("reshape", [bsym], {"shape": bshape},
                                  name=f"{node._name}_bias_r")
                out = Symbol("broadcast_add", [deq, bsym], {},
                             name=f"{node._name}_biasadd")
            new_of[id(node)] = out
            continue
        # non-quantized node: clone with new inputs
        clone = Symbol(opname, inputs, dict(node._attrs), name=node._name,
                       num_outputs=node._num_outputs)
        new_of[id(node)] = clone

    new_heads = [new_input(h) for h in heads]
    qsym = new_heads[0] if len(new_heads) == 1 else Group(new_heads)
    # drop float weights the rewritten graph no longer references (a
    # weight shared with a non-quantized/excluded consumer stays)
    needed = set(qsym.list_arguments()) | set(qsym.list_auxiliary_states())
    qargs = {k: v for k, v in qargs.items() if k in needed}
    return qsym, qargs, dict(aux_params)


# ===========================================================================
# gluon path: quantize_net block rewrite
# ===========================================================================

def _quantized_block(blk, act_threshold, arrays=None):
    """The fused int8 twin of a Conv2D/Dense block.  Only the needed
    fields are taken, so no reference to the float block survives.  The
    bias is kept in float32, the type the fused op widens it to.
    `arrays` = (int8 weight, scales, bias or None) gives the int8 arrays
    instead of quantizing the block's weight (a served artifact's)."""
    from ..gluon import nn as _nn
    from ..gluon.block import HybridBlock

    if arrays is None:
        qw, scales = quantize_weight_per_channel(blk.weight.data())
        bias_p = getattr(blk, "bias", None)
        bias = bias_p.data().astype("float32") if bias_p is not None \
            else None
    else:
        qw, scales, bias = arrays
    relu = blk._activation == "relu"
    extra_act = None if blk._activation in (None, "relu") else blk._activation
    if isinstance(blk, _nn.Dense):
        op_name = "_quantized_dense_pc"
        op_kwargs = {"flatten": blk._flatten}
    else:
        kw = blk._kwargs
        op_name = "_quantized_conv_pc"
        op_kwargs = {"kernel": kw["kernel"], "stride": kw["stride"],
                     "dilate": kw["dilate"], "pad": kw["pad"],
                     "num_group": kw["num_group"]}
    prefix = blk.prefix

    class _QuantizedLayer(HybridBlock):
        def __init__(self):
            super().__init__(prefix=prefix)
            self._qw = qw
            self._wscale = scales
            self._bias = bias
            self.act_threshold = act_threshold

        def hybrid_forward(self, F, x):
            out = getattr(F, op_name)(
                x, self._qw, self._wscale, self._bias,
                act_threshold=self.act_threshold, relu=relu, **op_kwargs)
            if extra_act:
                out = F.Activation(out, act_type=extra_act)
            return out

    return _QuantizedLayer()


def _targets(network, exclude_layers=()):
    """The Conv2D/Dense children of `network` to quantize: the first
    (parent, name, path, child) of each block, and {id(child): every
    (parent, name) slot it fills} (a shared block fills several)."""
    from ..gluon import nn as _nn
    targets, locations, seen = [], {}, set()

    def walk(block, path="net"):
        for name, child in getattr(block, "_children", {}).items():
            p = f"{path}.{name}"
            if isinstance(child, (_nn.Conv2D, _nn.Dense)) \
                    and p not in exclude_layers \
                    and name not in exclude_layers:
                locations.setdefault(id(child), []).append((block, name))
                if id(child) not in seen:        # calibrate/swap once
                    seen.add(id(child))
                    targets.append((block, name, p, child))
            walk(child, p)

    walk(network)
    return targets, locations


def _swap(locations, blk, q):
    # a child's attribute name is its slot in `_children` (the torch
    # module table), so the swap is seen through the attribute too
    for parent, name in locations[id(blk)]:
        parent._children[name] = q


def int8_state(network):
    """The fused int8 layers of a `quantize_net`-ed net as arrays and a
    description: ({f"{path}:{part}": NDArray}, {path: {"act_threshold",
    "bias"}}), `path` as `quantize_net` walks the float net.  A serving
    artifact stores them (`deploy.export_serving`)."""
    arrays, layers = {}, {}

    def walk(block, path="net"):
        for name, child in getattr(block, "_children", {}).items():
            p = f"{path}.{name}"
            if type(child).__name__ == "_QuantizedLayer":
                if p not in layers and id(child) not in \
                        {v["id"] for v in layers.values()}:
                    layers[p] = {"id": id(child),
                                 "act_threshold": child.act_threshold,
                                 "bias": child._bias is not None}
                    arrays[f"{p}:weight"] = child._qw
                    arrays[f"{p}:scale"] = child._wscale
                    if child._bias is not None:
                        arrays[f"{p}:bias"] = child._bias
            walk(child, p)

    walk(network)
    for v in layers.values():
        del v["id"]
    return arrays, layers


def restore_int8(network, arrays, layers):
    """Put back into a freshly built float net the int8 layers that
    `int8_state` described: each listed Conv2D/Dense becomes its fused
    int8 twin from the stored arrays, in every slot it fills."""
    targets, locations = _targets(network)
    by_path = {p: blk for _, _, p, blk in targets}
    for p, info in layers.items():
        blk = by_path.get(p)
        if blk is None:
            raise MXNetError(f"restore_int8: no Conv2D/Dense at {p}")
        bias = arrays[f"{p}:bias"] if info["bias"] else None
        _swap(locations, blk, _quantized_block(
            blk, info["act_threshold"],
            (arrays[f"{p}:weight"], arrays[f"{p}:scale"], bias)))
    return network


def quantize_net(network, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=(),
                 num_calib_batches=10, backend="native"):
    """Quantize a Gluon net for int8 inference.

    ``backend='native'``: Conv2D/Dense children are replaced in place by
    fused int8 blocks (per-channel weight scales, int32 accumulation).
    Calibration data (a DataIter or an iterable of NDArray batches)
    fixes static activation thresholds ('naive' minmax | 'entropy' KL);
    without it, activation scales are computed at run time per batch.
    ``backend='fake'`` keeps the float compute path and only
    fake-quantizes weights.  Returns the net."""
    if quantized_dtype != "int8":
        raise MXNetError("quantize_net: only int8 (the reference's uint8 "
                         "mode is asymmetric-range — unimplemented, not "
                         "silently approximated)")
    if backend not in ("native", "fake"):
        raise MXNetError("backend must be native|fake")

    targets, locations = _targets(network, exclude_layers)

    # activation calibration: run batches, collect each target's input
    # (the tensor that gets quantized).  `hybridize` is a no-op in the
    # port (every forward is eager), so there is no cached graph to turn
    # off around the hooks, as the JAX package must.
    thresholds = {}
    if calib_data is not None:
        samples = {p: [] for _, _, p, _ in targets}
        hooks = []
        for _, _, p, blk in targets:
            orig = blk.forward

            def hooked(x, *a, _p=p, _orig=orig, **kw):
                samples[_p].append(_numpy(x))
                return _orig(x, *a, **kw)
            blk.forward = hooked
            hooks.append((blk, orig))
        try:
            n = 0
            for batch in calib_data:
                # a DataBatch's first array (an NDArray's `.data` is
                # its tensor, not a batch's list)
                data = batch if isinstance(batch, (NDArray, torch.Tensor)) \
                    else batch.data[0] if hasattr(batch, "data") else batch
                network(data)
                n += 1
                if n >= num_calib_batches:
                    break
        finally:
            for blk, orig in reversed(hooks):   # undo in reverse so a
                blk.forward = orig              # doubly-patched block
                                                # ends at its original
        for _, _, p, blk in targets:
            if samples[p]:
                thresholds[p] = calib_threshold(samples[p], mode=calib_mode)

    if backend == "fake":
        for _, _, p, blk in targets:
            w = getattr(blk, "weight", None)
            if w is not None and w._data is not None:
                qw, scale = quantize_weight(w.data())
                w.set_data(qw)
                blk.weight_scale = scale
            if p in thresholds:
                blk.act_threshold = thresholds[p]
        return network

    # native: swap each target for its fused int8 twin — all occurrences
    # of a shared block get the same wrapper (weight sharing preserved).
    # The port keeps no whole-graph cache to drop afterwards (its
    # `hybridize` is a no-op).
    for parent, name, p, blk in targets:
        if getattr(blk, "weight", None) is None or blk.weight._data is None:
            raise MXNetError(f"quantize_net: layer {p} is uninitialized")
        _swap(locations, blk,
              _quantized_block(blk, act_threshold=thresholds.get(p)))
    return network


class INT8SubgraphProperty(_SubgraphProperty):
    """int8 subgraph backend: the partition pass carves Conv/FC(+act)
    chains out of a Symbol graph and this property's `rewrite` lowers
    each carved region onto the quantized ops via `quantize_model` (the
    role of the reference's MKLDNN quantization SubgraphProperty).

    Stateful: carries `arg_params` (weights must be known to
    prequantize) and accumulates the int8 weights + ranges it creates
    in `new_args`; bind the partitioned symbol with the original args
    plus `new_args`.

        prop = INT8SubgraphProperty(arg_params)
        qsym = subgraph.partition_graph(sym, prop)
        out = qsym.eval_with({**inputs, **arg_params, **prop.new_args})
    """

    name = "INT8"
    _SELECT = {"Convolution", "FullyConnected", "Activation",
               "gelu_fused", "relu", "sigmoid", "tanh"}

    def __init__(self, arg_params, excluded_sym_names=()):
        self.arg_params = dict(arg_params)
        self.excluded = set(excluded_sym_names)
        self.new_args = {}

    def select(self, node):
        if node._op in ("Convolution", "FullyConnected"):
            return node._name not in self.excluded
        return node._op in self._SELECT

    def min_size(self):
        return 1          # a lone Conv/FC is worth quantizing

    def rewrite(self, subgraph):
        # veto regions without a quantizable node with known weights:
        # the partitioner then leaves them in the outer float graph
        if not any(n._op in _QUANTIZABLE and len(n._inputs) > 1
                   and (n._inputs[1]._base or n._inputs[1]).is_var()
                   and n._inputs[1]._name in self.arg_params
                   for n in subgraph._topo()):
            return None
        qsym, qargs, _aux = quantize_model(
            subgraph, self.arg_params, {},
            excluded_sym_names=self.excluded)
        for k, v in qargs.items():
            if k not in self.arg_params:
                self.new_args[k] = v
        return qsym
