"""The per-rank bodies of the port's mesh tests: each runs on every rank
of a `_torch_mesh_world.World` and returns numpy (or plain) values.
Torch and the port only: no JAX here."""
import os

import numpy as np
import torch

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import parallel as par
from incubator_mxnet_torch import nd, gluon
from incubator_mxnet_torch.parallel import collectives as C
from incubator_mxnet_torch.parallel.sharding import PartitionSpec as P

_MESHES = {}


def mesh(axes):
    """One mesh a layout for the world's life (its groups are made
    once)."""
    key = tuple(axes.items())
    if key not in _MESHES:
        _MESHES[key] = par.make_mesh(dict(axes))
    return _MESHES[key]


def _np(t):
    return t.detach().float().numpy().copy() \
        if isinstance(t, torch.Tensor) else np.asarray(t)


# -- meshes ---------------------------------------------------------------

def mesh_info(axes):
    m = mesh(axes)
    return {"axis_names": m.axis_names, "shape": dict(m.shape),
            "coords": m.coords, "devices": m.devices.tolist(),
            "default_dp": par.default_mesh().shape["dp"],
            "rank": m.rank, "size": m.size}


def mesh_from_env(shape_env, micro_env=None):
    os.environ["MXNET_MESH_SHAPE"] = shape_env
    try:
        m = par.mesh_from_shape()
        return {"axis_names": m.axis_names, "shape": dict(m.shape)}
    finally:
        del os.environ["MXNET_MESH_SHAPE"]


def mesh_too_big(axes):
    try:
        par.make_mesh(axes)
    except mx.MXNetError as e:
        return str(e)
    return None


# -- collectives ------------------------------------------------------------

def collective(kind, x, axes, spec):
    """shard_map of one collective over `spec`-cut `x`; returns the
    global output and the gradient of sum(out * w) for a fixed w."""
    m = mesh(axes)
    ax = [a for a in m.axis_names][0]
    xt = torch.tensor(x, requires_grad=True)
    n = m.axis_size(ax)

    def f(v):
        if kind == "allreduce":
            return C.allreduce(v, ax)
        if kind == "allmean":
            return C.allmean(v, ax)
        if kind == "allmax":
            return C.allmax(v, ax)
        if kind == "allgather":
            return C.allgather(v, ax, axis=0)
        if kind == "reduce_scatter":
            return C.reduce_scatter(v, ax, axis=0)
        if kind == "ppermute":
            return C.ppermute(v, ax, [(i, (i + 1) % n) for i in range(n)])
        if kind == "shift2":
            return C.shift(v, ax, 2)
        if kind == "alltoall":
            return C.alltoall(v, ax, split_axis=0, concat_axis=1)
        if kind == "axis_index":
            return v * 0 + C.axis_index(ax) + 10 * C.axis_size(ax)
        if kind == "smoke":
            total = C.allreduce(v, ax)
            gathered = C.allgather(v, ax)
            assert gathered.shape[0] == n * v.shape[0]
            shifted = C.shift(v, ax, 1)
            return total + 0 * shifted
        raise ValueError(kind)
    out_spec = P(*spec)
    if kind == "allgather":
        out_spec = P(None, *spec[1:])
    if kind == "reduce_scatter":
        out_spec = P(*spec)
    out = C.shard_map(f, m, P(*spec), out_spec)(xt)
    w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    (out * w).sum().backward()
    return _np(out), _np(xt.grad)


# -- ring attention, pipeline, MoE ------------------------------------------

def ring(q, k, v, axes, causal, grad=False):
    """ring_attention on global q, k, v over 'sp'; with `grad` the
    gradients of its sum."""
    m = mesh(axes)
    if m.coords is None:
        return None
    qt, kt, vt = (torch.tensor(a, requires_grad=grad) for a in (q, k, v))
    out = par.ring_attention(qt, kt, vt, m, seq_axis="sp", causal=causal)
    if not grad:
        return _np(out)
    out.sum().backward()
    return _np(out), _np(qt.grad), _np(kt.grad), _np(vt.grad)


def pipeline(ws, xs, axes, grad=False):
    m = mesh(axes)
    if m.coords is None:
        return None
    wt = torch.tensor(ws, requires_grad=grad)
    xt = torch.tensor(xs)
    out = par.pipeline_step(lambda w, x: torch.tanh(x @ w), wt, xt, m)
    if not grad:
        return _np(out)
    out.sum().backward()
    return _np(out), _np(wt.grad)


def moe(params, x, axes, capacity):
    """moe_apply with this rank's rows (the batch over ep and dp) and
    experts; returns the global out, aux and the gradients of
    sum(out^2) / tokens + aux, in the trainer's convention (each rank's
    share summed over its replicas)."""
    m = mesh(axes)
    ranks = [a for a in ("dp", "ep") if a in m.axis_names]
    n_rows = m.axis_size(tuple(ranks))
    i_rows = m.axis_index(tuple(ranks))
    layer = par.MoELayer(x.shape[2], params["w_in"].shape[2],
                         params["w_in"].shape[0], capacity=capacity)
    layer.params = {k: torch.tensor(v, requires_grad=True)
                    for k, v in params.items()}
    b = x.shape[0] // n_rows
    xt = torch.tensor(x[i_rows * b:(i_rows + 1) * b], requires_grad=True)
    w_in, w_out = layer.expert_block(m)
    out, aux = par.moe_apply(xt, layer.params["gate_w"], w_in, w_out,
                             capacity=capacity, mesh=m)
    tokens = x.shape[0] * x.shape[1]
    # aux is the same on every rank: its share is 1 / size
    (out.pow(2).sum() / tokens + aux / m.size).backward()
    g = {k: v.grad for k, v in layer.params.items()}
    # gate_w is replicated: summed over every rank; the experts over
    # the ranks that hold the same experts (dp)
    g["gate_w"] = C._all_reduce(m, m.axis_names, g["gate_w"])
    e = params["w_in"].shape[0] // m.axis_size("ep")
    ie = m.axis_index("ep")
    gin = g["w_in"][ie * e:(ie + 1) * e]
    gout = g["w_out"][ie * e:(ie + 1) * e]
    if "dp" in m.axis_names:
        gin = C._all_reduce(m, "dp", gin)
        gout = C._all_reduce(m, "dp", gout)
    return {"out": _np(out), "aux": float(aux), "rows": i_rows,
            "x_grad": _np(xt.grad), "gate_w": _np(g["gate_w"]),
            "w_in": _np(gin), "w_out": _np(gout), "experts": ie}


# -- trainers -----------------------------------------------------------------

def _mlp(hidden=32, classes=10):
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(hidden, activation="relu", prefix="ffn_1_"))
        net.add(gluon.nn.Dense(classes, prefix="ffn_2_"))
    return net


def _net(kind, weights, in_shape, **kw):
    if kind == "mlp":
        net = _mlp(**kw)
        net.initialize()
        net(nd.array(np.zeros(in_shape, np.float32)))
    elif kind == "pipe":
        net = mx.test_utils.pipeline_mlp(**kw)
    elif kind == "bert":
        from incubator_mxnet_torch.models.bert import (get_bert_model,
                                                       BERTClassifier)
        bert = get_bert_model(kw["model"], vocab_size=kw["vocab"],
                              max_length=kw["max_length"], dropout=0.0)
        net = BERTClassifier(bert, num_classes=2, dropout=0.0)
        net.initialize(mx.init.Normal(0.02))
        if kw.get("dtype"):
            net.cast(kw["dtype"])
    else:
        raise ValueError(kind)
    if weights is not None:
        from incubator_mxnet_torch.convert import params_from_jax
        params_from_jax(net, weights)
    return net


def _softmax_ce():
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    return lambda out, y: loss(out.astype("float32"), y)


def train(kind, weights, batch, steps, trainer_kw, net_kw=None,
          axes=None, run_steps=False, env=None, checkpoint=None,
          tracing_on=False, gather=True):
    """A ParallelTrainer over `axes` (or its own mesh resolution) trained
    `steps` times on the global `batch`; returns the losses, the global
    parameters and what the trainer reports."""
    for k, v in (env or {}).items():
        os.environ[k] = v
    try:
        from incubator_mxnet_torch import tracing, goodput
        net = _net(kind, weights, batch[0].shape, **(net_kw or {}))
        kw = dict(trainer_kw)
        if axes is not None:
            kw["mesh"] = mesh(axes)
        tr = par.ParallelTrainer(net, _softmax_ce(), **kw)
        arrays = [nd.array(a) for a in batch]
        prev = tracing.enabled()
        if tracing_on:
            tracing.set_enabled(True)
            tracing.reset()
        try:
            if run_steps:
                losses = [float(tr.run_steps(steps, *arrays).asnumpy())]
            else:
                losses = [float(tr.step(*arrays).asnumpy())
                          for _ in range(steps)]
            rec = goodput.last_record() if tracing_on else None
            stages = [sp.attrs for sp in tracing.spans()
                      if sp.name == "pp.stage"] if tracing_on else None
        finally:
            tracing.set_enabled(prev)
        out = {"losses": losses, "mesh": dict(tr.mesh.shape),
               "n_micro": tr.n_micro, "pp_active": tr._pp_active,
               "tp_axis": tr.tp_axis, "pp_axis": tr.pp_axis,
               "param_bytes": tr.param_bytes(),
               "state_bytes": tr.optimizer_state_bytes(),
               "report": tr.mesh_report(), "zero_level": tr.zero_level,
               "membership": tuple(tr.membership),
               "specs": {p.name.split("_", 1)[1]: (
                   tuple(p._shard.spec) if p._shard is not None else None,
                   tuple(p._data.shape)) for p in tr.params},
               "rec": rec and {"buckets": rec["buckets"],
                               "untraced": rec["untraced"]},
               "stages": stages}
        if gather:
            out["params"] = [_np(t) for t in tr.gather_params()]
        if tr._states is not None:
            out["state_shapes"] = [
                tuple(x.shape) for s in tr._states if s is not None
                for x in (s if isinstance(s, tuple) else (s,))]
        if checkpoint:
            tr.save_checkpoint(checkpoint)
        return out
    finally:
        for k in (env or {}):
            os.environ.pop(k, None)


def train_error(kind, weights, batch, trainer_kw, net_kw=None):
    try:
        train(kind, weights, batch, 1, trainer_kw, net_kw)
    except mx.MXNetError as e:
        return str(e)
    return None


def load_into(kind, weights, batch, trainer_kw, net_kw, directory, steps):
    """A trainer loads `directory`, then trains `steps` more; returns its
    global parameters before and after and the losses."""
    net = _net(kind, weights, batch[0].shape, **(net_kw or {}))
    kw = dict(trainer_kw)
    tr = par.ParallelTrainer(net, _softmax_ce(), **kw)
    arrays = [nd.array(a) for a in batch]
    tr._prepare(arrays)
    man = tr.load_checkpoint(directory)
    before = [_np(t) for t in tr.gather_params()]
    losses = [float(tr.step(*arrays).asnumpy()) for _ in range(steps)]
    return {"before": before, "losses": losses, "step": man["step"],
            "after": [_np(t) for t in tr.gather_params()]}


def mha_scope(q, axes):
    """multi_head_attention on this rank's (batch, sequence) block under
    sequence_parallel_scope, gathered; then the dense op after it."""
    from incubator_mxnet_torch.ops.attention import multi_head_attention
    from incubator_mxnet_torch import autograd
    m = mesh(axes)
    qt = torch.tensor(q)
    sh = par.named_sharding(m, "dp", "sp")
    loc = sh.local_block(qt)
    out = {}
    with par.sequence_parallel_scope(m, "sp", "dp"):
        o = multi_head_attention(loc, loc, loc, num_heads=4, causal=True)
        out["ring"] = _np(sh.gather(o, qt.shape))
        try:
            with autograd.record(train_mode=True):
                multi_head_attention(loc, loc, loc, num_heads=4,
                                     dropout=0.5)
        except mx.MXNetError as e:
            out["dropout_error"] = str(e)
        try:
            multi_head_attention(loc, loc, loc, None,
                                 torch.full((loc.shape[0],), 4),
                                 num_heads=4)
        except mx.MXNetError as e:
            out["mask_error"] = str(e)
    out["after"] = _np(multi_head_attention(qt, qt, qt, num_heads=4,
                                            causal=True))
    return out


def statusz(weights, batch):
    from incubator_mxnet_torch import introspect
    net = _net("pipe", weights, batch[0].shape)
    tr = par.ParallelTrainer(net, _softmax_ce(), optimizer="sgd",
                             mesh_shape=(1, 2, 2), n_micro=4)
    tr.step(*[nd.array(a) for a in batch])
    sec = introspect.statusz()["ptrainer"]
    if "trainers" in sec:
        sec = next(s for s in sec["trainers"]
                   if s.get("mesh") == {"dp": 1, "pp": 2, "tp": 2}
                   and s.get("steps") == 1)
    return sec


# -- sharded input --------------------------------------------------------------

def assemble_blocks(full, axes):
    """This rank's block assembled from 1, 2 and 4 shards."""
    from incubator_mxnet_torch import io
    m = mesh(axes)
    out = {}
    for ns in (1, 2, 4):
        per = full.shape[0] // ns
        shards = [full[i * per:(i + 1) * per] for i in range(ns)]
        g = io.assemble_from_shards(shards, m, "dp")
        out[ns] = (g.asnumpy(), g.global_shape)
    local = full[m.rank * 12:(m.rank + 1) * 12]
    g = io.assemble_global(local, m, "dp")
    assert g.asnumpy().tobytes() == local.tobytes()
    return out


def assemble_wrong_rank(local, axes):
    from incubator_mxnet_torch import io
    try:
        io.assemble_global(local, mesh(axes), "dp", rank=0, num_shards=4)
    except mx.MXNetError as e:
        return str(e)
    return None


def sharded_train(x, y, axes):
    """A dp trainer fed ShardedDataIter's blocks, and one fed the whole
    batch, from the same weights."""
    from incubator_mxnet_torch import io
    out = {}
    for how in ("sharded", "whole"):
        mx.seed(3)
        net = gluon.nn.Dense(3, in_units=6)
        net.initialize(mx.init.Xavier())
        tr = par.ParallelTrainer(net, _softmax_ce(), optimizer="sgd",
                                 optimizer_params={"learning_rate": 0.1},
                                 mesh=mesh(axes))
        losses = []
        it = io.ShardedDataIter(io.NDArrayIter(x, y, batch_size=32),
                                trainer=tr)
        for _ in range(3):
            it.reset()
            if how == "sharded":
                b = it.next_global()
                batch = (b.data[0], b.label[0])
            else:
                batch = (nd.array(x), nd.array(y))
            losses.append(float(tr.step(*batch).asnumpy()))
        out["losses_" + how] = losses
        out["params_" + how] = [_np(t) for t in tr.gather_params()]
        out["local_batch"], out["global_batch"] = it.batch_size, \
            it.global_batch
    return out


def replica_audit(axes):
    """health.replica_digests over a trainer's blocks: equal replicas
    give equal digests, a changed weight on one dp replica another; the
    trainer from mesh_scope; the ledger's device count."""
    from incubator_mxnet_torch import health
    m = mesh(axes)
    mx.seed(3)
    net = gluon.nn.Dense(8, in_units=6)
    net.initialize(mx.init.Xavier())
    with par.mesh_scope(m):
        tr = par.ParallelTrainer(net, _softmax_ce(), optimizer="sgd",
                                 rules=par.MEGATRON_RULES)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randint(0, 8, 8).astype(np.float32)
    tr.step(nd.array(x), nd.array(y))
    same = health.replica_digests([p._data for p in tr.params], m, "dp")
    if m.coords["dp"] == 1:
        with torch.no_grad():
            tr.params[0]._data.view(-1)[0] += 1.0
    diff = health.replica_digests([p._data for p in tr.params], m, "dp")
    one = health.replica_digests([p._data for p in tr.params], m, "tp") \
        if "tp" not in m.axis_names else None
    return {"same": same, "diff": diff, "none": one,
            "scoped": tr.mesh is m,
            "device_count": tr._ledger.device_count}
