"""Optimizer updates (counterpart of `incubator_mxnet_tpu/ops/optim.py`:
`sgd_update`, `sgd_mom_update`, `adam_update`).

The JAX package leaves these to XLA fusions; here they are torch code.
Each rule is written once, as a multi-tensor pass over lists of tensors
(`torch._foreach_*`): it updates the float32 optimizer states in place
and returns the new weights in float32, which the caller rounds into the
weights' own dtype.  The registered per-key ops run the same pass on
one-element lists, so the fused Trainer update and the per-key Updater
give the same bits.

Per element, as in the JAX package: g = grad·rescale, clipped to
[−clip, clip] when clip > 0, plus wd·w, all in float32 (the wd term is
left out when wd is 0); then

    sgd:      w − lr·g
    sgd_mom:  m = momentum·m − lr·g;  w + m
    adam:     m = β1·m + (1 − β1)·g;  v = β2·v + (1 − β2)·g²;
              w − lr·m / (√v + ε)

with lr per tensor (the Trainer folds lr_mult and Adam's bias
correction into it).
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "sgd_multi",
           "adam_multi"]

_F32 = torch.float32


def _f32(tensors):
    return [t.to(_F32) for t in tensors]


def _prep(grads, weights, rescale, clip, wds):
    """float32 g = grad·rescale, clipped, + wd·w; never aliases a grad."""
    if rescale == 1.0:
        g = [t.to(_F32, copy=True) for t in grads]
    else:
        g = list(torch._foreach_mul(_f32(grads), float(rescale)))
    if clip is not None and clip > 0:
        torch._foreach_clamp_min_(g, -float(clip))
        torch._foreach_clamp_max_(g, float(clip))
    if any(wd != 0.0 for wd in wds):
        torch._foreach_add_(g, torch._foreach_mul(_f32(weights),
                                                  [float(w) for w in wds]))
    return g


def _lists(x, n):
    return list(x) if isinstance(x, (list, tuple)) else [x] * n


def sgd_multi(weights, grads, moms, *, lrs, momentum=0.0, wds=0.0,
              rescale=1.0, clip=None):
    """SGD over lists; `moms` (float32, updated in place) is None without
    momentum.  Returns the new weights in float32."""
    n = len(weights)
    lrs, wds = [float(x) for x in _lists(lrs, n)], _lists(wds, n)
    g = _prep(grads, weights, rescale, clip, wds)
    step = torch._foreach_mul(g, lrs)
    if moms is None or momentum == 0.0:
        return torch._foreach_sub(_f32(weights), step)
    torch._foreach_mul_(moms, float(momentum))
    torch._foreach_sub_(moms, step)
    return torch._foreach_add(_f32(weights), moms)


def adam_multi(weights, grads, means, variances, *, lrs, beta1=0.9,
               beta2=0.999, epsilon=1e-8, wds=0.0, rescale=1.0, clip=None):
    """Adam over lists; `means` and `variances` (float32) are updated in
    place.  Returns the new weights in float32."""
    n = len(weights)
    lrs, wds = [float(x) for x in _lists(lrs, n)], _lists(wds, n)
    g = _prep(grads, weights, rescale, clip, wds)
    torch._foreach_mul_(means, float(beta1))
    torch._foreach_add_(means, torch._foreach_mul(g, 1.0 - beta1))
    torch._foreach_mul_(variances, float(beta2))
    torch._foreach_add_(variances, torch._foreach_mul(
        torch._foreach_mul(g, g), 1.0 - beta2))
    denom = torch._foreach_sqrt(variances)
    torch._foreach_add_(denom, float(epsilon))
    upd = torch._foreach_mul(means, lrs)
    torch._foreach_div_(upd, denom)
    return torch._foreach_sub(_f32(weights), upd)


@register("sgd_update")
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    with torch.no_grad():
        (w,) = sgd_multi([weight], [grad], None, lrs=lr, wds=wd,
                         rescale=rescale_grad, clip=clip_gradient)
    return w.to(weight.dtype)


@register("sgd_mom_update")
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    with torch.no_grad():
        mom = mom.to(_F32, copy=True)
        (w,) = sgd_multi([weight], [grad], [mom], lrs=lr, momentum=momentum,
                         wds=wd, rescale=rescale_grad, clip=clip_gradient)
    return w.to(weight.dtype), mom


@register("adam_update")
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    with torch.no_grad():
        mean, var = (t.to(_F32, copy=True) for t in (mean, var))
        (w,) = adam_multi([weight], [grad], [mean], [var], lrs=lr,
                          beta1=beta1, beta2=beta2, epsilon=epsilon,
                          wds=wd, rescale=rescale_grad, clip=clip_gradient)
    return w.to(weight.dtype), mean, var
