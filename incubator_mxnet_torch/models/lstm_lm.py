"""LSTM language model, the PTB word-LM benchmark network (counterpart
of `incubator_mxnet_tpu/models/lstm_lm.py`): embedding, dropout, a
fused multi-layer LSTM in NTC layout and a decoder over the vocabulary.
The hidden state starts at zero on every call; the word-LM example's
loop carries it instead, through `rnn.LSTM(x, [h, c])`."""
from __future__ import annotations

from ..gluon import nn, rnn
from ..gluon.block import HybridBlock

__all__ = ["LSTMLanguageModel"]


class LSTMLanguageModel(HybridBlock):
    def __init__(self, vocab_size, embed_dim=650, hidden=650, layers=2,
                 dropout=0.5, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.encoder = nn.Embedding(vocab_size, embed_dim)
            self.drop = nn.Dropout(dropout)
            self.rnn = rnn.LSTM(hidden, layers, layout="NTC",
                                dropout=dropout, input_size=embed_dim)
            self.decoder = nn.Dense(vocab_size, in_units=hidden,
                                    flatten=False)

    def hybrid_forward(self, F, x):
        emb = self.drop(self.encoder(x))
        out = self.rnn(emb)
        return self.decoder(self.drop(out))
