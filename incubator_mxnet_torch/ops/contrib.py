"""Contrib ops (counterpart of `incubator_mxnet_tpu/ops/contrib_ops.py`):
the CTC loss so far.

`CTCLoss` (aliases `ctc_loss`, `_contrib_CTCLoss`, `_contrib_ctc_loss`)
runs the JAX op's forward recursion in log space over the extended
label [blank, l0, blank, l1, ..., blank], one step of torch ops per
time step where the JAX op scans, so torch autograd gives its gradient.
Blank "first" is class 0 and pads labels with 0; blank "last" is class
C − 1 and pads with −1.  A length input counts only with its `use_*`
flag, and a length given without its flag raises, as in the JAX op.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["ctc_loss"]

_NEG = -1e30


def _shift(alpha, k, neg):
    """alpha shifted right by k along the label axis, NEG filled."""
    n, s = alpha.shape
    if k >= s:
        return neg.expand(n, s)
    return torch.cat([neg.expand(n, k), alpha[:, :s - k]], dim=1)


@register("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"))
def ctc_loss(data, label, data_lengths=None, label_lengths=None, *,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Negative log-likelihood (N,) float32 of each label sequence under
    `data` (T, N, C) unnormalized activations."""
    T, N, C = data.shape
    L = label.shape[1]
    dev = data.device
    logp = torch.log_softmax(data.to(torch.float32), dim=-1)
    raw = label.to(torch.int64)
    if blank_label == "first":
        blank, lab, pad_mask = 0, raw, raw == 0
    else:
        blank, pad_mask = C - 1, raw < 0
        lab = torch.where(pad_mask, torch.zeros_like(raw), raw)
    if use_data_lengths and data_lengths is None:
        raise MXNetError("ctc_loss: use_data_lengths=True needs "
                         "data_lengths")
    if use_label_lengths and label_lengths is None:
        raise MXNetError("ctc_loss: use_label_lengths=True needs "
                         "label_lengths")
    if data_lengths is not None and not use_data_lengths:
        raise MXNetError("ctc_loss: data_lengths given but "
                         "use_data_lengths=False; set the flag")
    if label_lengths is not None and not use_label_lengths:
        raise MXNetError("ctc_loss: label_lengths given but "
                         "use_label_lengths=False; set the flag")
    dlen = torch.full((N,), T, dtype=torch.int64, device=dev) \
        if data_lengths is None else data_lengths.to(torch.int64)
    llen = (~pad_mask).sum(dim=1) if label_lengths is None \
        else label_lengths.to(torch.int64)

    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    pos = torch.arange(S, device=dev).unsqueeze(0)
    valid = pos < (2 * llen.unsqueeze(1) + 1)
    ext_m2 = torch.cat([torch.full((N, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_m2)
    neg = torch.full((1, 1), _NEG, dtype=torch.float32, device=dev)

    first = logp[0].gather(1, ext[:, 1:2])[:, 0] if S > 1 else None
    alpha = torch.cat(
        [logp[0, :, blank:blank + 1]]
        + ([torch.where(llen > 0, first, neg[0]).unsqueeze(1)]
           if S > 1 else [])
        + ([neg.expand(N, S - 2)] if S > 2 else []), dim=1)
    alpha = torch.where(valid, alpha, neg)
    for t in range(1, T):
        a_m2 = torch.where(can_skip, _shift(alpha, 2, neg), neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1, neg)),
                                 a_m2)
        new = torch.where(valid, merged + logp[t].gather(1, ext), neg)
        # frozen once t reaches the data length: the final alpha is
        # read at dlen − 1
        alpha = torch.where((t < dlen).unsqueeze(1), new, alpha)
    last = alpha.gather(1, (2 * llen).clamp_max(S - 1).unsqueeze(1))[:, 0]
    prev = alpha.gather(1, (2 * llen - 1).clamp(0, S - 1).unsqueeze(1))[:, 0]
    return -torch.logaddexp(last, torch.where(llen > 0, prev, neg[0]))
