"""Mixture-of-Experts layer with sort-based token dispatch (port of
``repro/models/moe.py``).

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

Tensor-parallel serving (``tp_axis``, ``distributed/tp.py``): the router
stays replicated and the full-E dispatch runs on every rank, so gating,
top-k and the sort are the same bits everywhere.  With ``"experts"`` in
``tp_shards`` a rank holds E/tp experts: it runs its experts' rows of the
dispatch buffer through the grouped matmul and an all-gather along E
rebuilds the [E, C, d] expert outputs (expert parallelism).  With
``"expert_ff"`` it holds 1/tp of every expert's ff columns and of the down
projection's d output columns: the ff activations are gathered, the down
projection runs over the full ff, and its output columns are gathered
(the shared expert likewise with ``"shared_ff"``).  Every gathered value
is one rank's full-contraction product, launched under the plan of the
global (E, N), so the layer computes the unsharded values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
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


def _shared_expert(p, x, act, tp_axis: str = ""):
    """The shared expert's MLP in x's type, times its fp32 sigmoid gate;
    with ``tp_axis`` its ff columns are sharded (gather, down projection
    over the full ff to 1/tp of the d columns, gather).  Its three
    products run the column-stable dense kernel
    (``kernels/dense_matmul.py``), a rank's under the global width's
    plan."""
    dt = x.dtype
    tp = coll.axis_size(tp_axis) if tp_axis else 1

    def dense(a, w):
        return ops.dense_matmul(a.contiguous(), w.to(dt),
                                plan_n=w.shape[-1] * tp if tp > 1 else None)

    sgx = act(dense(x, p["shared_gate"])) * dense(x, p["shared_up"])
    if tp_axis:
        shared = coll.all_gather(
            dense(coll.all_gather(sgx, tp_axis, 1), p["shared_down"]),
            tp_axis, 1)
    else:
        shared = dense(sgx, p["shared_down"])
    gate = torch.sigmoid(x.float() @ p["shared_router"].float())
    return shared.float() * gate


def moe_apply(p, x, *, top_k: int, norm_topk: bool,
              capacity_factor: float = 1.25, act=F.silu, dispatch_axes=None,
              tp_axis: str = "", tp_shards=()):
    """x [T, d] -> [T, d].  ``p`` holds one layer's weights (no leading L
    dim).  ``dispatch_axes`` only aligns the capacity to 128, as the JAX
    function does before pinning it to mesh axes (no pin here: the
    tensor-parallel modes of ``tp_axis``/``tp_shards`` place the experts,
    see the module's docstring)."""
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
    wg, wu, wd = (p[k].to(dt) for k in ("w_gate", "w_up", "w_down"))
    if tp_axis and "experts" in tp_shards:
        E_loc = wg.shape[0]  # this rank's experts, in rank order
        xe_loc = xe[coll.axis_index(tp_axis) * E_loc:][:E_loc]
        g = ops.grouped_matmul(xe_loc, wg, plan_shape=(E, wg.shape[2]))
        u = ops.grouped_matmul(xe_loc, wu, plan_shape=(E, wu.shape[2]))
        ye = coll.all_gather(
            ops.grouped_matmul(act(g) * u, wd, plan_shape=(E, d)),
            tp_axis, 0)
    elif tp_axis and "expert_ff" in tp_shards:
        tp = coll.axis_size(tp_axis)
        g = ops.grouped_matmul(xe, wg, plan_shape=(E, wg.shape[2] * tp))
        u = ops.grouped_matmul(xe, wu, plan_shape=(E, wu.shape[2] * tp))
        gu = coll.all_gather(act(g) * u, tp_axis, 2)
        ye = coll.all_gather(
            ops.grouped_matmul(gu, wd, plan_shape=(E, d)), tp_axis, 2)
    else:
        g = ops.grouped_matmul(xe, wg)
        u = ops.grouped_matmul(xe, wu)
        ye = ops.grouped_matmul(act(g) * u, wd)

    # ---- combine: each (token, k) slot gathers its expert's output
    vals = _gather(ye.reshape(E * C, d), rows, kept, slot_of, valid,
                   1).reshape(T, top_k, d)
    y = torch.einsum("tkd,tk->td", vals.float(),
                     gate_vals * kept.reshape(T, top_k))
    if "shared_gate" in p:
        y = y + _shared_expert(
            p, x, act, tp_axis if "shared_ff" in tp_shards else "")
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
