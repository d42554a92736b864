"""Top-k routed mixture-of-experts with capacity-based dispatch.

Port of ``src/repro/models/moe.py``: the GShard formulation, tokens grouped
and dispatched into per-expert capacity buffers with one-hot einsums, at
about k/E of the dense-all-experts FLOPs plus the dispatch. Tokens that
overflow an expert's capacity are dropped (GShard semantics; the capacity
factor sets the drop rate), exactly where the reference drops them: a
(token, choice)'s slot is the exclusive count of earlier (token, choice)
pairs routed to the same expert, in flattened (token, choice) order.

Aux losses: the Switch load-balance loss and the router z-loss.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import bmm_f32
from repro_torch.models.params import ParamDef

__all__ = ["moe_schema", "route", "SlotPlan", "plan", "expert_block", "aux_metrics",
           "moe_forward"]


def moe_schema(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, e), "normal", ("fsdp", None)),
        "w_gate": ParamDef((e, d, f), "normal", ("tp", "fsdp", None)),
        "w_up": ParamDef((e, d, f), "normal", ("tp", "fsdp", None)),
        "w_down": ParamDef((e, f, d), "scaled", ("tp", None, "fsdp")),
    }


def route(p: dict, x: torch.Tensor, cfg: ModelConfig, group_size: int = 1024):
    """The router of ``moe_forward`` on ``x [B, S, D]`` in groups of
    ``g = min(group_size, B·S)`` tokens (``B·S`` must be a multiple, as the
    reference asserts): (float32 logits ``[ng, g, E]``, probabilities,
    renormalised top-k gates ``[ng, g, k]``, expert indices ``[ng, g, k]``)."""
    b, s, d = x.shape
    tokens = b * s
    g = min(group_size, tokens)
    if tokens % g:
        raise ValueError(f"{tokens} tokens do not split into groups of {g}")
    xt = x.reshape(tokens // g, g, d)
    logits = (xt @ p["router"].to(xt.dtype)).float()  # [ng, g, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_vals, expert_idx


class SlotPlan(NamedTuple):
    """The routing of ``moe_forward``'s groups (``plan``): float32 router
    logits and probabilities ``[ng, g, E]``, renormalised top-k ``gates``
    ``[ng, g, k]`` (float32), their ``experts`` and ``slots`` ``[ng, g, k]``
    (int64), ``within`` (the slot lies inside ``capacity``) and the
    ``capacity`` of each (group, expert)."""

    logits: torch.Tensor
    probs: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    slots: torch.Tensor
    within: torch.Tensor
    capacity: int


def plan(p: dict, x: torch.Tensor, cfg: ModelConfig, group_size: int = 1024) -> SlotPlan:
    """``route`` and the slot of each (token, choice) in its expert's
    buffer: the exclusive count of earlier (token, choice) pairs routed to
    the same expert over the flattened (token, choice) order, exact in
    int64, so that the drops (slots past ``capacity``) are the reference's."""
    e = cfg.n_experts
    logits, probs, gates, experts = route(p, x, cfg, group_size)
    ng, g = logits.shape[:2]
    onehot = torch.nn.functional.one_hot(experts, e).long()  # [ng, g, k, E]
    flat = onehot.reshape(ng, g * cfg.experts_per_token, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(onehot.shape)
    slots = torch.gather(pos, -1, experts[..., None])[..., 0]  # [ng, g, k]
    capacity = max(1, int(cfg.moe_capacity_factor * g * cfg.experts_per_token / e))
    return SlotPlan(logits, probs, gates, experts, slots, slots < capacity, capacity)


def expert_block(w: dict, xt: torch.Tensor, gates: torch.Tensor, experts: torch.Tensor,
                 slots: torch.Tensor, capacity: int, e0: int, e1: int) -> torch.Tensor:
    """The experts ``[e0, e1)``' float32 contribution to ``y`` ``[ng, g, d]``
    for the tokens ``xt [ng, g, d]`` routed by ``gates``, ``experts`` and
    ``slots`` (``plan``'s). ``w`` holds that range's ``w_gate``, ``w_up``
    and ``w_down``. The block's dispatch and combine one-hots ``[ng, g,
    e1 - e0, C]`` hold the (token, choice) pairs routed to its experts
    within capacity; the combine's gates are rounded to ``xt``'s dtype,
    and its sum over the block's experts is float32
    (``layers.bmm_f32``), so that partial blocks add up before one rounding."""
    ng, g, d = xt.shape
    n = e1 - e0
    local = experts - e0
    mine = (local >= 0) & (local < n) & (slots < capacity)
    expert_of = torch.nn.functional.one_hot(local.clamp(0, n - 1), n).float()
    expert_of = expert_of * mine[..., None]  # other blocks' and dropped choices routed nowhere
    pos_onehot = (slots[..., None] == torch.arange(capacity, device=xt.device)).float()
    # dispatch[ng, g, n, C]: at most one (expert, slot) a (token, choice).
    dispatch = torch.einsum("gtke,gtkc->gtec", expert_of, pos_onehot)
    combine = torch.einsum("gtke,gtkc->gtec", expert_of * gates[..., None], pos_onehot)

    x_e = torch.einsum("gtec,gtd->gecd", dispatch.to(xt.dtype), xt)
    gate = torch.einsum("gecd,edf->gecf", x_e, w["w_gate"])
    h = gate * torch.sigmoid(gate) * torch.einsum("gecd,edf->gecf", x_e, w["w_up"])
    y_e = torch.einsum("gecf,efd->gecd", h, w["w_down"])
    return bmm_f32(combine.to(xt.dtype).reshape(ng, g, n * capacity),
                   y_e.reshape(ng, n * capacity, d))


def aux_metrics(pl: SlotPlan, cfg: ModelConfig) -> dict:
    """The router's aux metrics of a plan, float32 0-d tensors: the Switch
    load balance ``E * sum_e f_e * p_e`` (f: the fraction of choices routed
    to e before drops, p: the mean router probability), the z-loss and the
    dropped fraction."""
    e, g = cfg.n_experts, pl.logits.shape[1]
    f_e = torch.nn.functional.one_hot(pl.experts, e).float().sum(dim=(1, 2)) / g  # [ng, E]
    p_e = pl.probs.mean(dim=1)
    return {
        "moe_balance_loss": e * (f_e * p_e).sum(-1).mean(),
        "moe_z_loss": (torch.logsumexp(pl.logits, dim=-1) ** 2).mean(),
        "moe_dropped_frac": 1.0 - pl.within.float().mean(),
    }


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, group_size: int = 1024):
    """``x [B, S, D]`` -> (y [B, S, D], aux): ``moe_balance_loss``,
    ``moe_z_loss`` and ``moe_dropped_frac`` as float32 0-d tensors.

    Routed by ``plan`` in groups of ``g`` tokens, with a capacity of
    ``max(1, int(cf·g·k/E))`` a group and expert; ``y`` is ``expert_block``
    over every expert, cast once to ``x``'s dtype.
    """
    pl = plan(p, x, cfg, group_size)
    ng, g = pl.logits.shape[:2]
    xt = x.reshape(ng, g, x.shape[-1])
    y = expert_block(p, xt, pl.gates, pl.experts, pl.slots, pl.capacity, 0, cfg.n_experts)
    return y.to(x.dtype).reshape(x.shape), aux_metrics(pl, cfg)
