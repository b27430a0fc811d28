"""The BERT fine-tune recipe of the int8 accuracy gate (the port's own
copy of the repository's `tools/bert_task.py`, on the port only).

The task: margined token-share classification.  Class A sequences carry
90% low-id tokens, class B 10%, so the encoder must aggregate the whole
sequence into CLS (no single-position shortcut), the wide margin makes
training from random init robust across seeds, and the restricted
1000-id vocabulary makes the rule generalize (fresh test sequences reuse
trained embeddings).  `make_task` draws exactly what the JAX package's
draws from the same `RandomState`.
"""
import numpy as np

__all__ = ["make_task", "finetune"]


def make_task(rng, n, seqlen):
    y = rng.randint(0, 2, n).astype(np.float32)
    ratio = np.where(y > 0, 0.9, 0.1)
    low = rng.randint(0, 500, (n, seqlen))
    high = rng.randint(500, 1000, (n, seqlen))
    pick = rng.rand(n, seqlen) < ratio[:, None]
    return np.where(pick, low, high).astype(np.float32), y


def finetune(net, rng, seqlen, main_steps, batch=32, ctx=None,
             warmup_steps=60):
    """Two-phase Adam fine-tune (post-LN BERT from scratch needs a
    warmup): `warmup_steps` at lr 1e-5, then `main_steps` at 5e-5, one
    `ParallelTrainer` a phase, a fresh batch every 10 steps, on `ctx`
    (default: the current context, the card)."""
    from .. import nd, gluon, parallel as par

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    types = nd.array(np.zeros((batch, seqlen), np.float32), ctx=ctx)
    for lr, steps in [(1e-5, warmup_steps), (5e-5, main_steps)]:
        tr = par.ParallelTrainer(net, lambda o, yy: loss_fn(
            o.astype("float32"), yy), optimizer="adam",
            optimizer_params={"learning_rate": lr},
            mesh=par.default_mesh(1, ctx=ctx))
        xtr = ytr = None
        for step in range(steps):
            if step % 10 == 0:
                xtr, ytr = make_task(rng, batch, seqlen)
                xtr, ytr = nd.array(xtr, ctx=ctx), nd.array(ytr, ctx=ctx)
            tr.step(xtr, types, ytr)
    return net
