"""Mixture-of-Experts layer with sort-based token dispatch (port of
``repro/models/moe.py`` for one device).

Each token picks its ``top_k`` experts from an fp32 softmax router; the
(token, expert) slots are sorted by expert (stable), each expert takes the
first ``C`` slots of its run (the capacity, static per token count) and
drops the rest, and the dispatched tokens [E, C, d] go through the three
expert contractions as grouped matmuls (``ops.grouped_matmul``: the CUDA
kernel on the card, its plain version on the CPU).  The combine gathers
each slot's expert output back and weights it by its gate in fp32.  The
order of every step follows the JAX function, so a dropped slot is the
same slot in both packages; ties in the router pick the lower expert
index first, as ``jax.lax.top_k`` does.

Training: the grouped matmuls are autograd Functions with a hand-written
backward kernel (``kernels/moe_gmm.py``).  The two gathers of the
dispatch and the combine are ``SlotGather`` where grad mode is on: the
backward of each is the inverse gather (a token's k slots summed in k
order), so a step's gradients are the same bits every time (PyTorch's own
backward of an index is a scatter-add, whose order on the card is not
fixed).

Tensor-parallel and expert-parallel MoE (``tp_axis``) are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn.spec import TensorSpec


def moe_spec(n_layers: int, d: int, n_experts: int, ff: int,
             shared_ff: int = 0):
    """Router, expert and (with ``shared_ff``) shared-expert weights,
    stacked over ``n_layers``."""
    p = {
        "router": TensorSpec((n_layers, d, n_experts),
                             ("layers", "embed", None), "normal",
                             scale=d ** -0.5),
        "w_gate": TensorSpec((n_layers, n_experts, d, ff),
                             ("layers", "experts", "embed", "mlp"), "normal",
                             scale=d ** -0.5),
        "w_up": TensorSpec((n_layers, n_experts, d, ff),
                           ("layers", "experts", "embed", "mlp"), "normal",
                           scale=d ** -0.5),
        "w_down": TensorSpec((n_layers, n_experts, ff, d),
                             ("layers", "experts", "mlp", "embed"), "normal",
                             scale=ff ** -0.5),
    }
    if shared_ff:
        p["shared_gate"] = TensorSpec((n_layers, d, shared_ff),
                                      ("layers", "embed", "mlp"), "normal",
                                      scale=d ** -0.5)
        p["shared_up"] = TensorSpec((n_layers, d, shared_ff),
                                    ("layers", "embed", "mlp"), "normal",
                                    scale=d ** -0.5)
        p["shared_down"] = TensorSpec((n_layers, shared_ff, d),
                                      ("layers", "mlp", "embed"), "normal",
                                      scale=shared_ff ** -0.5)
        p["shared_router"] = TensorSpec((n_layers, d, 1),
                                        ("layers", "embed", None), "normal",
                                        scale=d ** -0.5)
    return p


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float = 1.25, align: int = 8) -> int:
    """Slots per expert: ``n_tokens * top_k / n_experts * factor`` rounded
    up to ``align``, at least ``align``."""
    c = int(n_tokens * top_k / n_experts * capacity_factor)
    return max(align, -(-c // align) * align)


def _route(p, x, top_k: int, norm_topk: bool):
    """fp32 router softmax and its top-k: (gates [T, k] fp32, expert ids
    [T, k] int64), highest first; equal probabilities take the lower
    expert index first (a stable descending sort), as ``jax.lax.top_k``
    does."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :top_k], expert_ids[:, :top_k]
    if norm_topk:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
            min=1e-9)
    return probs, gate_vals, expert_ids


class SlotGather(torch.autograd.Function):
    """``where(mask, src[idx], 0)`` over rows of src [R, d], whose
    backward is the inverse gather: the output's gradient, flattened to
    rows, picked by ``back_idx`` [R * fold] where ``back_mask``, and summed
    over each row's ``fold`` picks in order (deterministic: no
    scatter-add)."""

    @staticmethod
    def forward(ctx, src, idx, mask, back_idx, back_mask, fold):
        ctx.save_for_backward(back_idx, back_mask)
        ctx.fold = fold
        return torch.where(mask[..., None], src[idx], 0)

    @staticmethod
    def backward(ctx, g):
        back_idx, back_mask = ctx.saved_tensors
        d = g.shape[-1]
        picked = torch.where(back_mask.reshape(-1, 1),
                             g.reshape(-1, d)[back_idx.reshape(-1)], 0)
        return (picked.reshape(-1, ctx.fold, d).sum(1), None, None, None,
                None, None)


def _gather(src, idx, mask, back_idx, back_mask, fold):
    """``where(mask, src[idx], 0)``; through ``SlotGather`` where grad mode
    is on and src requires grad."""
    if torch.is_grad_enabled() and src.requires_grad:
        return SlotGather.apply(src, idx, mask, back_idx, back_mask, fold)
    return torch.where(mask[..., None], src[idx], 0)


def _shared_expert(p, x, act):
    """The shared expert's MLP in x's type, times its fp32 sigmoid gate."""
    dt = x.dtype
    sgx = act(x @ p["shared_gate"].to(dt)) * (x @ p["shared_up"].to(dt))
    shared = sgx @ p["shared_down"].to(dt)
    gate = torch.sigmoid(x.float() @ p["shared_router"].float())
    return shared.float() * gate


def moe_apply(p, x, *, top_k: int, norm_topk: bool,
              capacity_factor: float = 1.25, act=F.silu, dispatch_axes=None,
              tp_axis: str = "", tp_shards=()):
    """x [T, d] -> [T, d].  ``p`` holds one layer's weights (no leading L
    dim).  ``dispatch_axes`` only aligns the capacity to 128, as the JAX
    function does before pinning it to mesh axes (one device here: no
    pin)."""
    if tp_axis:
        raise NotImplementedError(
            "tensor- and expert-parallel MoE is not ported to repro_torch "
            "yet (ROADMAP queue 1 item 12)")
    T, d = x.shape
    E = p["router"].shape[-1]
    C = capacity(T, E, top_k, capacity_factor,
                 align=128 if dispatch_axes else 8)
    dev = x.device
    _, gate_vals, expert_ids = _route(p, x, top_k, norm_topk)

    # ---- sort-based dispatch (gathers only, as in the JAX function)
    flat_expert = expert_ids.reshape(-1)  # [T*k]
    order = torch.sort(flat_expert, stable=True).indices
    se = flat_expert[order]
    experts = torch.arange(E, device=dev)
    first = torch.searchsorted(se, experts, side="left")  # [E]
    last = torch.searchsorted(se, experts, side="right")
    slots = torch.arange(C, device=dev)
    src = first[:, None] + slots[None, :]  # [E, C] sorted-slot index
    valid = slots[None, :] < (last - first)[:, None]
    slot_of = order[src.clamp(0, T * top_k - 1)]  # [E, C] flat slot
    tok = slot_of // top_k  # [E, C] token index
    inv = torch.empty_like(order)  # flat slot -> position in sorted order
    inv[order] = torch.arange(order.numel(), device=dev)
    c_of = inv - first[flat_expert]  # rank within the expert's run
    kept = c_of < C  # capacity drop
    rows = flat_expert * C + c_of.clamp(0, C - 1)  # [T*k] expert row
    xe = _gather(x, tok, valid, rows, kept, top_k)  # [E, C, d]

    # ---- the three grouped expert contractions (the CUDA kernel)
    dt = x.dtype
    g = ops.grouped_matmul(xe, p["w_gate"].to(dt))
    u = ops.grouped_matmul(xe, p["w_up"].to(dt))
    ye = ops.grouped_matmul(act(g) * u, p["w_down"].to(dt))

    # ---- combine: each (token, k) slot gathers its expert's output
    vals = _gather(ye.reshape(E * C, d), rows, kept, slot_of, valid,
                   1).reshape(T, top_k, d)
    y = torch.einsum("tkd,tk->td", vals.float(),
                     gate_vals * kept.reshape(T, top_k))
    if "shared_gate" in p:
        y = y + _shared_expert(p, x, act)
    return y.to(dt)


def moe_reference(p, x, *, top_k: int, norm_topk: bool, act=F.silu):
    """Dense all-experts oracle (tests only): every expert on every token,
    weighted by the top-k gates, no capacity drop."""
    probs, gate_vals, expert_ids = _route(p, x, top_k, norm_topk)
    weights = torch.zeros_like(probs).scatter_add_(1, expert_ids, gate_vals)
    dt = x.dtype
    g = torch.einsum("td,edf->tef", x, p["w_gate"].to(dt))
    u = torch.einsum("td,edf->tef", x, p["w_up"].to(dt))
    ye = torch.einsum("tef,efd->ted", act(g) * u, p["w_down"].to(dt))
    y = torch.einsum("ted,te->td", ye.float(), weights)
    if "shared_gate" in p:
        y = y + _shared_expert(p, x, act)
    return y.to(dt)
