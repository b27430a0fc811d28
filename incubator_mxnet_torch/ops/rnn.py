"""The fused RNN op: multi-layer LSTM, GRU and Elman RNN, uni- or
bidirectional (counterpart of `incubator_mxnet_tpu/ops/rnn.py`).

One op runs the whole sequence for every layer, with the weights packed
in one flat vector in cuDNN's layout: every layer's and direction's W
(input) and R (recurrent) matrices first, then their biases bw and br.
Gate orders follow cuDNN: LSTM [i f g o], GRU [r z n].

The time loop is a Python loop of torch ops: the input projection of
all steps is one product, each step one recurrent product and the
gates' elementwise work.  bfloat16 data selects the mixed-precision
contract of the JAX op: the products take bfloat16 operands and give
float32 results that are never rounded, the gates and the LSTM cell
state stay in float32, and the carried h is rounded to bfloat16 each
step.  On the CPU both operands go to float32 for the product, where
the products of bfloat16 values are exact; on the card the product is
`torch.mm(..., out_dtype=torch.float32)`, cuBLAS's bfloat16 GEMM with
float32 output.  The backward is the same float32 formula on both
(`_MixedMatmul`).
"""
from __future__ import annotations

import torch

from .flash_attention import _exact_matmuls
from .registry import register
from .. import autograd
from ..base import MXNetError
from ..random import generator

__all__ = ["rnn", "rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode,
                   projection_size=None):
    """Total flat parameter count (cuDNN's packing)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        per_dir = g * state_size * (in_sz + state_size) + 2 * g * state_size
        size += per_dir * d
    return size


def _unpack(params, num_layers, input_size, state_size, bidirectional, mode):
    """[[(w, r, bw, br) per direction] per layer] as views of `params`:
    w (G*H, in), r (G*H, H), bw and br (G*H,)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    dims = [input_size if layer == 0 else h * d
            for layer in range(num_layers) for _dir in range(d)]
    off = 0
    mats = []
    for in_sz in dims:
        w = params[off:off + g * h * in_sz].reshape(g * h, in_sz)
        off += g * h * in_sz
        r = params[off:off + g * h * h].reshape(g * h, h)
        off += g * h * h
        mats.append((w, r))
    biases = []
    for _in_sz in dims:
        bw = params[off:off + g * h]
        off += g * h
        br = params[off:off + g * h]
        off += g * h
        biases.append((bw, br))
    return [[mats[li * d + di] + biases[li * d + di] for di in range(d)]
            for li in range(num_layers)]


class _MixedMatmul(torch.autograd.Function):
    """a (M, K) @ b (K, N) with a float32 result that is never rounded,
    for `a` in bfloat16 and `b` float32 holding bfloat16 values.  Only
    the forward differs by device: the card runs cuBLAS's bfloat16 GEMM
    with float32 output on `b16`, b's bfloat16 copy; the CPU takes both
    operands to float32, where the products of bfloat16 values are
    exact.  The backward is one formula on both, in full float32: a's
    gradient is the float32 cotangent times b, rounded to a's dtype;
    b's is a times the cotangent, kept in float32, so that it sums over
    the calls in float32."""

    @staticmethod
    def forward(ctx, a, b, b16):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.mm(a, b16, out_dtype=torch.float32)
        return a.to(torch.float32) @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _exact_matmuls():
            if ctx.needs_input_grad[0]:
                ga = (g @ b.t()).to(a.dtype)
            if ctx.needs_input_grad[1]:
                gb = a.to(torch.float32).t() @ g
        return ga, gb, None


def _projector(w, compute_dtype):
    """a -> a @ w.T in float32, for `a` in the compute dtype and `w`
    (G*H, K) float32 rounded to it.  float32 is a plain float32 product,
    bfloat16 `_MixedMatmul`; either way w's gradient sums over the calls
    in float32 and is rounded to the parameter's dtype once."""
    if compute_dtype == torch.float32:
        return lambda a: a @ w.t()
    wq = w.to(compute_dtype).to(torch.float32).t()
    w16 = w.detach().to(compute_dtype).t() if w.is_cuda else None
    return lambda a: _MixedMatmul.apply(a, wq, w16)


def _run_single_direction(x, w, r, bw, br, mode, h0, c0, compute_dtype):
    """x (T, N, I); w, r, bw, br float32; h0, c0 float32 (N, H).
    Returns (out (T, N, H) float32, hT float32, cT float32 or None)."""
    T, N, _ = x.shape
    cd = compute_dtype
    rec = _projector(r, cd)
    # the input projection of every step in one product, bw added once;
    # unbound into steps, whose gradients the backward stacks in one op
    # (indexing step t would zero-fill and add a (T, N, G*H) gradient
    # for every step)
    xg = (_projector(w, cd)(x.to(cd).reshape(T * N, -1))
          + bw).reshape(T, N, -1).unbind(0)
    h = h0.to(cd)
    outs = []
    if mode == "lstm":
        c = c0
        for t in range(T):
            gates = xg[t] + rec(h) + br
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c = f * c + i * torch.tanh(g)
            h2 = o * torch.tanh(c)
            outs.append(h2)
            h = h2.to(cd)
        return torch.stack(outs), h.to(torch.float32), c
    if mode == "gru":
        for t in range(T):
            rg = rec(h) + br
            xr, xz, xn = xg[t].chunk(3, dim=-1)
            hr, hz, hn = rg.chunk(3, dim=-1)
            rt = torch.sigmoid(xr + hr)
            zt = torch.sigmoid(xz + hz)
            nt = torch.tanh(xn + rt * hn)
            # z * h with the carried (rounded) h, as the JAX op has it
            h2 = (1 - zt) * nt + zt * h.to(torch.float32)
            outs.append(h2)
            h = h2.to(cd)
        return torch.stack(outs), h.to(torch.float32), None
    act = torch.tanh if mode == "rnn_tanh" else torch.relu
    for t in range(T):
        h2 = act(xg[t] + rec(h) + br)
        outs.append(h2)
        h = h2.to(cd)
    return torch.stack(outs), h.to(torch.float32), None


@register("RNN")
def rnn(data, parameters, state, state_cell=None, *, state_size, num_layers,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=True,
        projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        use_sequence_length=False):
    """data (T, N, I) time-major, parameters flat (`rnn_param_size`),
    state (and for LSTM state_cell) (L*D, N, H).  Returns (out, hy) or,
    for LSTM, (out, hy, cy).

    Dropout of rate `p` falls between layers, never after the top one,
    and only in train mode, with draws from the framework generator.
    As in the JAX op, `projection_size`, the `lstm_state_clip_*`
    arguments and `use_sequence_length` are taken and ignored, and the
    reverse direction reads the whole sequence backwards."""
    if mode not in _GATES:
        raise MXNetError(f"unknown RNN mode {mode}")
    T, N, I = data.shape
    D = 2 if bidirectional else 1
    H = state_size
    compute_dtype = (torch.bfloat16 if data.dtype == torch.bfloat16
                     else torch.float32)
    layers = _unpack(parameters.to(torch.float32), num_layers, I, H,
                     bidirectional, mode)
    x = data
    hy, cy = [], []
    for li, dirs in enumerate(layers):
        outs = []
        for di, (w, r, bw, br) in enumerate(dirs):
            idx = li * D + di
            h0 = state[idx].to(torch.float32)
            c0 = None if state_cell is None \
                else state_cell[idx].to(torch.float32)
            xin = x.flip(0) if di == 1 else x
            out, hT, cT = _run_single_direction(
                xin, w, r, bw, br, mode, h0, c0, compute_dtype)
            outs.append(out.flip(0) if di == 1 else out)
            hy.append(hT)
            if cT is not None:
                cy.append(cT)
        x = outs[0] if D == 1 else torch.cat(outs, dim=-1)
        if p > 0 and autograd.is_training() and li < num_layers - 1:
            keep = torch.rand(x.shape, generator=generator(x.device),
                              device=x.device) < 1 - p
            x = x * keep.to(x.dtype) / (1 - p)
    out = x.to(data.dtype)
    hy = torch.stack(hy).to(state.dtype)
    if mode == "lstm":
        return out, hy, torch.stack(cy).to(state.dtype)
    return out, hy
