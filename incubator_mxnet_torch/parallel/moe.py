"""Mixture-of-Experts with expert parallelism over the 'ep' mesh axis
(counterpart of `incubator_mxnet_tpu/parallel/moe.py`).

The JAX package's GShard recipe: top-1 gating builds dispatch and
combine tensors, per-row expert buffers of `capacity` slots, the
load-balancing aux loss.  There GSPMD inserts the all-to-alls from the
experts' sharding; here they are explicit: each rank holds its rows of
the batch (cut over 'ep', and 'dp' if the mesh has it) and its E / ep
experts, sends each expert's slots to the rank that holds the expert
(`alltoall` over 'ep'), applies its experts to the slots of every rank,
and sends the results back.  The aux loss's means over rows are taken
over the whole batch (`allmean`).
"""
from __future__ import annotations

import torch

from . import collectives as C

__all__ = ["moe_apply", "MoELayer"]


def moe_apply(x, gate_w, w_in, w_out, capacity=None, mesh=None,
              ep_axis="ep", batch_axis="dp"):
    """Top-1 MoE feed-forward.

    x: [B, S, M] tokens (this rank's rows on a mesh with `ep_axis`)
    gate_w: [M, E]
    w_in: [E, M, F], w_out: [E, F, M] (this rank's E / ep experts on
        such a mesh)
    capacity: the slots of each expert for each batch row (default
        2 S / E).
    Returns (out [B, S, M], aux_loss)."""
    B, S, M = x.shape
    E = gate_w.shape[1]
    C_ = int(capacity if capacity is not None else max(1, 2 * S // E))
    ep = mesh is not None and ep_axis in mesh.axis_names
    logits = torch.einsum("bsm,me->bse", x, gate_w)
    probs = torch.softmax(logits, dim=-1)
    gate, expert = probs.max(dim=-1)
    mask = torch.nn.functional.one_hot(expert, E).to(x.dtype)   # [B,S,E]
    pos = torch.cumsum(mask, dim=1) * mask - mask                 # [B,S,E]
    keep = (pos < C_).to(x.dtype) * mask
    # a slot past the capacity is dropped (keep is 0 there)
    dispatch = keep[..., None] * torch.nn.functional.one_hot(
        pos.to(torch.int64).clamp(max=C_ - 1), C_).to(x.dtype)    # [B,S,E,C]
    combine = dispatch * gate[:, :, None, None]
    xe = torch.einsum("bsec,bsm->ebcm", dispatch, x)              # [E,B,C,M]
    if ep:
        # each expert's slots of every rank's rows to the expert's rank
        xe = C.alltoall(xe, ep_axis, split_axis=0, concat_axis=1,
                        mesh=mesh)                                # [E/n,nB,C,M]
    h = torch.relu(torch.einsum("ebcm,emf->ebcf", xe, w_in))
    ye = torch.einsum("ebcf,efm->ebcm", h, w_out)
    if ep:
        ye = C.alltoall(ye, ep_axis, split_axis=1, concat_axis=0,
                        mesh=mesh)                                # [E,B,C,M]
    out = torch.einsum("bsec,ebcm->bsm", combine, ye)
    density = mask.mean(dim=1)                                    # [B,E]
    gate_mean = probs.mean(dim=1)
    per_row = (density * gate_mean).sum(dim=-1)                   # [B]
    aux = per_row.mean()
    if ep:
        rows = (ep_axis,) + ((batch_axis,) if batch_axis in mesh.axis_names
                             else ())
        aux = C.allmean(aux, rows, mesh=mesh)
    return out, aux * E


class MoELayer:
    """Thin stateful wrapper (torch parameters from a seeded generator)
    for tests and the chip check; `params` may be replaced by the JAX
    layer's arrays."""

    def __init__(self, dim, hidden, num_experts, capacity=None, seed=0,
                 device=None):
        g = torch.Generator().manual_seed(int(seed))
        s = dim ** -0.5
        self.params = {
            "gate_w": torch.randn(dim, num_experts, generator=g) * s,
            "w_in": torch.randn(num_experts, dim, hidden, generator=g) * s,
            "w_out": torch.randn(num_experts, hidden, dim, generator=g)
            * hidden ** -0.5,
        }
        if device is not None:
            self.params = {k: v.to(device) for k, v in self.params.items()}
        self.capacity = capacity

    def expert_block(self, mesh, ep_axis="ep"):
        """This rank's experts of `w_in` and `w_out` on `mesh`."""
        n, i = mesh.axis_size(ep_axis), mesh.axis_index(ep_axis)
        e = self.params["w_in"].shape[0] // n
        return (self.params["w_in"][i * e:(i + 1) * e],
                self.params["w_out"][i * e:(i + 1) * e])

    def __call__(self, x, mesh=None):
        w_in, w_out = self.params["w_in"], self.params["w_out"]
        if mesh is not None and "ep" in mesh.axis_names:
            w_in, w_out = self.expert_block(mesh)
        return moe_apply(x, self.params["gate_w"], w_in, w_out,
                         capacity=self.capacity, mesh=mesh)
