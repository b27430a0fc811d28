"""Optimizer updates (counterpart of `incubator_mxnet_tpu/ops/optim.py`:
`sgd_update`, `sgd_mom_update`, `adam_update`, `nag_mom_update`,
`rmsprop_update`, `rmspropalex_update`, `adagrad_update`,
`adadelta_update`, `ftrl_update`, `signsgd_update` and
`lamb_update_phase1`/`_phase2`).

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

The other rules are per tensor, in the JAX package's formulas and
order: each returns the new weight in the weight's dtype and the new
states in float32 (LAMB's phase 1 returns its float32 step and states;
phase 2 the weight).  `ftrl` takes no wd into g, `adadelta` takes no lr
and LAMB's phase 1 adds wd·w to the step, not to g.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "sgd_multi",
           "adam_multi", "nag_mom_update", "rmsprop_update",
           "rmspropalex_update", "adagrad_update", "adadelta_update",
           "ftrl_update", "signsgd_update", "lamb_update_phase1",
           "lamb_update_phase2"]

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


def _g(weight, grad, rescale, clip, wd):
    """float32 g = grad·rescale, clipped, + wd·w, for one tensor."""
    return _prep([grad], [weight], rescale, clip, [wd])[0]


def _g_no_wd(grad, rescale, clip):
    return _prep([grad], [grad], rescale, clip, [0.0])[0]


@register("nag_mom_update")
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    with torch.no_grad():
        g = _g(weight, grad, rescale_grad, clip_gradient, wd)
        new_mom = momentum * mom.to(_F32) + g
        w = weight.to(_F32) - lr * (g + momentum * new_mom)
    return w.to(weight.dtype), new_mom


@register("rmsprop_update")
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.9, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    with torch.no_grad():
        g = _g(weight, grad, rescale_grad, clip_gradient, wd)
        new_n = gamma1 * n.to(_F32) + (1 - gamma1) * g.square()
        w = weight.to(_F32) - lr * g / torch.sqrt(new_n + epsilon)
        if clip_weights is not None and clip_weights > 0:
            w = w.clamp(-clip_weights, clip_weights)
    return w.to(weight.dtype), new_n


@register("rmspropalex_update")
def rmspropalex_update(weight, grad, n, g_state, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp; `clip_weights` is taken and, as in the JAX op,
    not applied."""
    with torch.no_grad():
        g = _g(weight, grad, rescale_grad, clip_gradient, wd)
        new_n = gamma1 * n.to(_F32) + (1 - gamma1) * g.square()
        new_g = gamma1 * g_state.to(_F32) + (1 - gamma1) * g
        new_delta = gamma2 * delta.to(_F32) - lr * g / torch.sqrt(
            new_n - new_g.square() + epsilon)
        w = weight.to(_F32) + new_delta
    return w.to(weight.dtype), new_n, new_g, new_delta


@register("adagrad_update")
def adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    with torch.no_grad():
        g = _g(weight, grad, rescale_grad, clip_gradient, wd)
        new_hist = history.to(_F32) + g.square()
        w = weight.to(_F32) - lr * g / (torch.sqrt(new_hist) + epsilon)
    return w.to(weight.dtype), new_hist


@register("adadelta_update")
def adadelta_update(weight, grad, acc_g, acc_delta, *, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    with torch.no_grad():
        g = _g(weight, grad, rescale_grad, clip_gradient, wd)
        acc_delta = acc_delta.to(_F32)
        new_acc_g = rho * acc_g.to(_F32) + (1 - rho) * g.square()
        delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(
            new_acc_g + epsilon) * g
        new_acc_delta = rho * acc_delta + (1 - rho) * delta.square()
        w = weight.to(_F32) - delta
    return w.to(weight.dtype), new_acc_g, new_acc_delta


@register("ftrl_update")
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    with torch.no_grad():
        g = _g_no_wd(grad, rescale_grad, clip_gradient)
        n = n.to(_F32)
        new_n = n + g.square()
        sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
        new_z = z.to(_F32) + g - sigma * weight.to(_F32)
        w = torch.where(
            new_z.abs() <= lamda1, torch.zeros_like(new_z),
            -(new_z - torch.sign(new_z) * lamda1)
            / ((beta + torch.sqrt(new_n)) / lr + wd))
    return w.to(weight.dtype), new_z, new_n


@register("signsgd_update")
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    with torch.no_grad():
        g = _g(weight, grad, rescale_grad, clip_gradient, wd)
        w = weight.to(_F32) - lr * torch.sign(g)
    return w.to(weight.dtype)


@register("lamb_update_phase1")
def lamb_update_phase1(weight, grad, mean, var, *, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's raw step m̂ / (√v̂ + ε) + wd·w and the new moments."""
    with torch.no_grad():
        g = _g_no_wd(grad, rescale_grad, clip_gradient)
        new_mean = beta1 * mean.to(_F32) + (1 - beta1) * g
        new_var = beta2 * var.to(_F32) + (1 - beta2) * g.square()
        m_hat, v_hat = new_mean, new_var
        if bias_correction:
            m_hat = new_mean / (1 - beta1 ** t)
            v_hat = new_var / (1 - beta2 ** t)
        step = m_hat / (torch.sqrt(v_hat) + epsilon) \
            + wd * weight.to(_F32)
    return step, new_mean, new_var


@register("lamb_update_phase2")
def lamb_update_phase2(weight, g_step, r1, r2, *, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """w − lr·ratio·step with the trust ratio r1 / r2 (1 where either
    norm is 0), clamped to the bounds that are > 0.  r1 and r2 are 0-d
    tensors on the device: no host sync."""
    with torch.no_grad():
        r1, r2 = torch.as_tensor(r1), torch.as_tensor(r2)
        ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                            torch.ones((), dtype=_F32, device=r2.device))
        if lower_bound is not None and lower_bound > 0:
            ratio = ratio.clamp_min(lower_bound)
        if upper_bound is not None and upper_bound > 0:
            ratio = ratio.clamp_max(upper_bound)
        w = weight.to(_F32) - lr * ratio * g_step
    return w.to(weight.dtype)
