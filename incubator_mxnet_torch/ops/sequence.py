"""Sequence ops (counterpart of `incubator_mxnet_tpu/ops/sequence.py`):
SequenceMask, SequenceLast, SequenceReverse.  The data is time-major,
(T, N, ...), or batch-major (N, T, ...) with `axis=1`; without
`use_sequence_length` every sequence is T steps long."""
from __future__ import annotations

import torch

from .registry import register


def _steps_mask(data, sequence_length, axis=0):
    """Boolean mask, True at the valid steps: T along `axis`, N along the
    other leading axis, size 1 along the rest."""
    T = data.shape[axis]
    steps = torch.arange(T, device=data.device)
    lens = sequence_length.to(torch.int32)
    mask = steps[:, None] < lens[None, :]                      # (T, N)
    if axis == 1:
        mask = mask.T                                           # (N, T)
    return mask.reshape(mask.shape + (1,) * (data.ndim - 2))


@register("SequenceMask")
def sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                  value=0.0, axis=0):
    """`value` at every step past its sequence's length."""
    if not use_sequence_length or sequence_length is None:
        return data
    mask = _steps_mask(data, sequence_length, axis)
    return torch.where(mask, data,
                       torch.tensor(value, dtype=data.dtype,
                                    device=data.device))


@register("SequenceLast")
def sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step: (N, ...)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = sequence_length.to(torch.int64) - 1                 # (N,)
    moved = data.movedim(axis, 0)                               # (T, N, ...)
    idx = last.reshape((1, -1) + (1,) * (moved.ndim - 2))
    return moved.gather(0, idx.expand((1,) + moved.shape[1:])).squeeze(0)


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, *, use_sequence_length=False,
                     axis=0):
    """Each sequence's valid steps reversed in place; the padding after
    them stays where it is."""
    if not use_sequence_length or sequence_length is None:
        return data.flip(axis)
    moved = data.movedim(axis, 0)                               # (T, N, ...)
    T = moved.shape[0]
    lens = sequence_length.to(torch.int64)[None, :]             # (1, N)
    steps = torch.arange(T, device=data.device)[:, None]        # (T, 1)
    src = torch.where(steps < lens, lens - 1 - steps, steps)
    idx = src.reshape((T, -1) + (1,) * (moved.ndim - 2))
    return moved.gather(0, idx.expand(moved.shape)).movedim(0, axis)
