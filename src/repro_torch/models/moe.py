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

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

__all__ = ["moe_schema", "route", "moe_forward"]


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


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, group_size: int = 1024):
    """``x [B, S, D]`` -> (y [B, S, D], aux): ``moe_balance_loss``,
    ``moe_z_loss`` and ``moe_dropped_frac`` as float32 0-d tensors.

    Routed by ``route`` in groups of ``g`` tokens, with a capacity of
    ``max(1, int(cf·g·k/E))`` a group and expert.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    logits, probs, gate_vals, expert_idx = route(p, x, cfg, group_size)
    ng, g = logits.shape[:2]
    xt = x.reshape(ng, g, d)

    capacity = max(1, int(cfg.moe_capacity_factor * g * k / e))
    onehot = torch.nn.functional.one_hot(expert_idx, e).float()  # [ng, g, k, E]
    # Slot of each (token, choice) in its expert's buffer: the exclusive
    # count over the flattened (token, choice) order, exact in int64.
    flat = onehot.reshape(ng, g * k, e).long()
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(ng, g, k, e)
    pos = torch.gather(pos, -1, expert_idx[..., None])[..., 0]  # [ng, g, k]
    within = pos < capacity
    expert_of = onehot * within[..., None]  # dropped choices routed nowhere
    pos_onehot = (pos[..., None] == torch.arange(capacity, device=x.device)).float()
    # dispatch[ng, g, E, C]: at most one (E, C) slot a (token, choice).
    dispatch = torch.einsum("gtke,gtkc->gtec", expert_of, pos_onehot)
    combine = torch.einsum("gtke,gtkc->gtec", expert_of * gate_vals[..., None], pos_onehot)

    x_e = torch.einsum("gtec,gtd->gecd", dispatch.to(xt.dtype), xt)
    gate = torch.einsum("gecd,edf->gecf", x_e, p["w_gate"])
    h = gate * torch.sigmoid(gate) * torch.einsum("gecd,edf->gecf", x_e, p["w_up"])
    y_e = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    y = torch.einsum("gtec,gecd->gtd", combine.to(xt.dtype), y_e).reshape(b, s, d)

    # Switch load balance: E * sum_e f_e * p_e (f: the fraction of choices
    # routed to e before drops, p: the mean router probability); z-loss.
    f_e = onehot.sum(dim=(1, 2)) / g  # [ng, E]
    p_e = probs.mean(dim=1)
    aux = {
        "moe_balance_loss": e * (f_e * p_e).sum(-1).mean(),
        "moe_z_loss": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
        "moe_dropped_frac": 1.0 - within.float().mean(),
    }
    return y, aux
