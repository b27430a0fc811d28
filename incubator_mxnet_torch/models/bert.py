"""BERT / Transformer encoder model family (counterpart of
`incubator_mxnet_tpu/models/bert.py`).

The same classes, child names, prefixes and `_BERT_CONFIGS`, so the
structural parameter names match the JAX package's one for one and
weights carry across (`convert.params_from_jax`).  Attention goes
through the fused `multi_head_attention` op, which runs the short CUDA
kernel on the card.
"""
from __future__ import annotations

from ..gluon import nn, HybridBlock
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["BERTEncoderLayer", "BERTEncoder", "BERTModel", "BERTClassifier",
           "TransformerEncoder", "get_bert_model", "bert_12_768_12",
           "bert_24_1024_16", "bert_mini", "bert_classifier"]


def _shard_of(layer):
    """The sharding of a layer's weight a mesh trainer placed, or None
    (a quantized layer has no gluon weight)."""
    return getattr(getattr(layer, "weight", None), "_shard", None)


class SelfAttention(HybridBlock):
    """Fused QKV projection + multi-head attention + output projection."""

    def __init__(self, units, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads {num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._dropout = dropout
        with self.name_scope():
            self.qkv = nn.Dense(3 * units, flatten=False, prefix="qkv_",
                                in_units=units)
            self.proj = nn.Dense(units, flatten=False, prefix="proj_",
                                 in_units=units)

    def hybrid_forward(self, F, x, mask=None, kv_length=None):
        units, heads, tp = self._units, self._num_heads, None
        sh = _shard_of(self.qkv)
        if sh is not None:
            from ..parallel.tensor_parallel import cut_axis
            tp = cut_axis(sh, 0)
        if tp:
            # column-parallel qkv laid out head-aligned: this rank's
            # q ; k ; v of its own heads
            n = sh.mesh.axis_size(tp)
            if heads % n:
                raise MXNetError(f"{heads} heads do not split over {tp} "
                                 f"({n})")
            units, heads = units // n, heads // n
            self.qkv._tp_keep_local = True
        qkv = self.qkv(x)                                   # (N, T, 3E)
        q = F.slice_axis(qkv, axis=-1, begin=0, end=units)
        k = F.slice_axis(qkv, axis=-1, begin=units, end=2 * units)
        v = F.slice_axis(qkv, axis=-1, begin=2 * units, end=3 * units)
        out = F.multi_head_attention(q, k, v, mask, kv_length,
                                     num_heads=heads,
                                     dropout=self._dropout)
        if tp and _shard_of(self.proj) is None:
            from ..parallel import collectives
            out = NDArray(collectives.allgather(
                out.data, tp, axis=-1, mesh=sh.mesh))
        return self.proj(out)


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 **kwargs):
        super().__init__(**kwargs)
        self._activation = activation
        with self.name_scope():
            self.ffn_1 = nn.Dense(hidden_size, flatten=False, prefix="ffn_1_",
                                  in_units=units)
            self.ffn_2 = nn.Dense(units, flatten=False, prefix="ffn_2_",
                                  in_units=hidden_size)
            self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, x):
        sh1, sh2 = _shard_of(self.ffn_1), _shard_of(self.ffn_2)
        if sh1 is not None:
            # Megatron's pair: the first layer's columns feed the second
            # layer's rows without a gather
            from ..parallel.tensor_parallel import cut_axis
            col = cut_axis(sh1, 0)
            self.ffn_1._tp_keep_local = bool(col) and \
                cut_axis(sh2, 1) == col
        h = self.ffn_1(x)
        h = F.gelu_fused(h) if self._activation == "gelu" \
            else F.Activation(h, act_type=self._activation)
        return self.dropout(self.ffn_2(h))


class BERTEncoderLayer(HybridBlock):
    """Post-LN transformer encoder layer (BERT convention)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = SelfAttention(units, num_heads, dropout=dropout)
            self.ln1 = nn.LayerNorm(in_channels=units)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout)
            self.ln2 = nn.LayerNorm(in_channels=units)
            self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, x, mask=None, kv_length=None):
        h = self.ln1(x + self.dropout(self.attention(x, mask, kv_length)))
        return self.ln2(h + self.ffn(h))


class BERTEncoder(HybridBlock):
    """Stack of encoder layers."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        self._num_layers = num_layers
        with self.name_scope():
            self.layers = nn.HybridSequential()
            for i in range(num_layers):
                self.layers.add(BERTEncoderLayer(
                    units, hidden_size, num_heads, dropout=dropout,
                    prefix=f"layer{i}_"))

    def hybrid_forward(self, F, x, mask=None, kv_length=None):
        for layer in self.layers._children.values():
            x = layer(x, mask, kv_length)
        return x


TransformerEncoder = BERTEncoder


class BERTModel(HybridBlock):
    """Token + segment + position embeddings → encoder → (sequence output,
    pooled CLS output[, MLM logits])."""

    def __init__(self, vocab_size, units=768, hidden_size=3072, num_layers=12,
                 num_heads=12, max_length=512, token_types=2, dropout=0.1,
                 use_pooler=True, use_decoder=False, sparse_embed=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._units = units
        with self.name_scope():
            # sparse_embed gives the word embedding a row-sparse gradient:
            # ParallelTrainer then updates only the rows a step looks up
            # (their weights and moments; the others stay as they are),
            # and gluon.Trainer gets a RowSparseNDArray gradient
            self.word_embed = nn.Embedding(vocab_size, units,
                                           prefix="word_embedding_",
                                           sparse_grad=sparse_embed)
            self.token_type_embed = nn.Embedding(token_types, units,
                                                 prefix="type_embedding_")
            self.position_embed = self.params.get(
                "position_weight", shape=(max_length, units),
                init="normal")
            self.embed_ln = nn.LayerNorm(in_channels=units)
            self.embed_dropout = nn.Dropout(dropout)
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout=dropout,
                                       prefix="encoder_")
            if use_pooler:
                self.pooler = nn.Dense(units, activation="tanh",
                                       flatten=False, prefix="pooler_",
                                       in_units=units)
            if use_decoder:
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        prefix="decoder_", in_units=units)

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None,
                       position_embed=None):
        T = inputs.shape[1]
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        # under sequence_parallel_scope this rank holds chunk i of the
        # sequence: its positions start at i T
        from ..parallel.ring_attention import sequence_parallel_config
        sp = sequence_parallel_config()
        start = 0 if sp is None else \
            sp["mesh"].axis_index(sp["seq_axis"]) * T
        pos = position_embed.expand_dims(0).slice_axis(
            axis=1, begin=start, end=start + T)
        x = x + pos
        x = self.embed_dropout(self.embed_ln(x))
        # valid_length rides as kv_length so the kernel path stays
        # engaged for padded batches (mask=None).
        seq = self.encoder(x, None, valid_length)
        outs = [seq]
        if self._use_pooler:
            cls = F.slice_axis(seq, axis=1, begin=0, end=1)
            if sp is not None and \
                    not sp["mesh"].trivial(sp["seq_axis"]):
                # the first token lies in chunk 0
                from ..parallel import collectives
                cls = NDArray(collectives.allgather(
                    cls.data, sp["seq_axis"], axis=1,
                    mesh=sp["mesh"])[:, :1])
            cls = cls.reshape(0, self._units)
            outs.append(self.pooler(cls))
        if self._use_decoder:
            outs.append(self.decoder(seq))
        return tuple(outs) if len(outs) > 1 else outs[0]


class BERTClassifier(HybridBlock):
    """Pooled-output classification head."""

    def __init__(self, bert, num_classes=2, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self.bert = bert
        with self.name_scope():
            self.classifier = nn.HybridSequential(prefix="classifier_")
            self.classifier.add(nn.Dropout(dropout))
            self.classifier.add(nn.Dense(num_classes))

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None):
        out = self.bert(inputs, token_types, valid_length)
        pooled = out[1] if isinstance(out, tuple) else out
        return self.classifier(pooled)


_BERT_CONFIGS = {
    # name: (layers, units, hidden, heads)
    "bert_12_768_12": (12, 768, 3072, 12),
    "bert_24_1024_16": (24, 1024, 4096, 16),
    "bert_mini": (4, 256, 1024, 4),
    "bert_tiny": (2, 128, 512, 2),
}


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   max_length=512, dropout=0.1, use_pooler=True,
                   use_decoder=False, sparse_embed=False, **kwargs):
    if model_name not in _BERT_CONFIGS:
        raise MXNetError(f"unknown bert config {model_name!r}; "
                         f"have {sorted(_BERT_CONFIGS)}")
    L, U, H, A = _BERT_CONFIGS[model_name]
    return BERTModel(vocab_size, units=U, hidden_size=H, num_layers=L,
                     num_heads=A, max_length=max_length, dropout=dropout,
                     use_pooler=use_pooler, use_decoder=use_decoder,
                     sparse_embed=sparse_embed, **kwargs)


def bert_12_768_12(**kw):
    return get_bert_model("bert_12_768_12", **kw)


def bert_24_1024_16(**kw):
    return get_bert_model("bert_24_1024_16", **kw)


def bert_mini(**kw):
    return get_bert_model("bert_mini", **kw)


def bert_classifier(model_name="bert_12_768_12", num_classes=2, dropout=0.1,
                    vocab_size=30522, max_length=512, sparse_embed=False):
    """`BERTClassifier(get_bert_model(model_name, ...), num_classes)`: the
    fine-tune surface as one constructor, so a serving artifact can name
    it (`models.get_model("bert_classifier", ...)`)."""
    bert = get_bert_model(model_name, vocab_size=vocab_size,
                          max_length=max_length, dropout=dropout,
                          sparse_embed=sparse_embed)
    return BERTClassifier(bert, num_classes=num_classes, dropout=dropout)
