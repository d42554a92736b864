"""Mamba2 / SSD (state-space duality) block — chunked dual-form scan.

Port of ``src/repro/models/ssm.py``. Recurrence (per head h, state N, head
channels P):

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T        y_t = C_t h_t + D x_t

The chunked dual form (arXiv:2405.21060) splits the sequence into chunks of
Q tokens: within a chunk the contribution is an attention-like quadratic
einsum; across chunks only the ``[H, N, P]`` states flow, here through a
Python loop over the chunks (the reference's ``lax.scan``).

``ssm_decode_heads`` is the recurrent step over blocks of heads (a state
placed on a mesh splits its heads and ``conv_x``'s head-major channels over
'model'): the projections, the B/C convolution (which every head needs
whole) and the gated norm (over all of ``d_inner``) run once, the conv of
``x`` and the state update once a block; ``ssm_decode`` is its one-block
case.

One difference from the reference that leaves the forward as it is: the
segment matrix ``exp(cs_i - cs_j)`` is masked *before* the ``exp``. Above
the diagonal the reference computes ``exp`` of a positive difference that
overflows to ``inf`` at full width (chunk 256, ``A`` down to -16) and
hides it with a ``where``; masking first gives the same values and keeps
the gradient finite.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamDef

__all__ = ["ssm_schema", "ssd_chunked", "ssm_forward", "ssm_decode", "ssm_decode_heads",
           "ssm_state_shapes"]


def ssm_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    h = cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    w = cfg.ssm_conv_width
    return {
        "in_z": ParamDef((d, di), "normal", ("fsdp", "tp")),
        "in_x": ParamDef((d, di), "normal", ("fsdp", "tp")),
        "in_b": ParamDef((d, gn), "normal", ("fsdp", None)),
        "in_c": ParamDef((d, gn), "normal", ("fsdp", None)),
        "in_dt": ParamDef((d, h), "normal", ("fsdp", "tp")),
        "conv_x": ParamDef((w, di), "normal", (None, "tp")),
        "conv_b": ParamDef((w, gn), "normal", (None, None)),
        "conv_c": ParamDef((w, gn), "normal", (None, None)),
        "a_log": ParamDef((h,), "a_log", ("tp",)),
        "d_skip": ParamDef((h,), "ones", ("tp",)),
        "dt_bias": ParamDef((h,), "dt_bias", ("tp",)),
        "gate_norm": ParamDef((di,), "ones", ("tp",)),
        "out": ParamDef((di, d), "scaled", ("tp", "fsdp")),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv. x: [B, L, C], w: [W, C]. Returns (y, new_state).

    ``state`` is the last W-1 inputs from the previous segment ([B, W-1, C]).
    A state of another dtype than ``x`` is promoted with it, as JAX's
    concatenate promotes (a bf16 cache state meeting a float32 activation
    gives a float32 new state).
    """
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    dtype = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dtype), x.to(dtype)], dim=1)
    length = x.shape[1]
    y = xp[:, 0:length, :] * w[0]
    for i in range(1, width):
        y = y + xp[:, i : i + length, :] * w[i]
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return _silu(y), new_state


def _project(p: dict, u: torch.Tensor, cfg: ModelConfig):
    """Shared by prefill/decode: projections + activation shaping."""
    b, length, _ = u.shape
    g, n = cfg.ssm_groups, cfg.ssm_state
    z = u @ p["in_z"]
    x = u @ p["in_x"]
    bb = u @ p["in_b"]
    cc = u @ p["in_c"]
    dt = torch.nn.functional.softplus((u @ p["in_dt"]).float() + p["dt_bias"].float())  # [B, L, H]
    return z, x, bb.reshape(b, length, g, n), cc.reshape(b, length, g, n), dt


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, init_state=None):
    """Chunked SSD on ``x [B, L, H, P]``, ``dt [B, L, H]`` (post-softplus,
    f32), ``a [H]`` (negative, f32), ``b_mat``/``c_mat [B, L, H, N]`` and an
    optional ``init_state [B, H, N, P]``. Returns (y [B, L, H, P] f32,
    final_state [B, H, N, P] f32)."""
    bsz, l_orig, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, l_orig)
    pad = (-l_orig) % q
    if pad:
        # Zero-pad the tail: dt=0 makes padded steps exact no-ops (decay=1,
        # no state update); the padded outputs are sliced away below.
        x, b_mat, c_mat = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (x, b_mat, c_mat))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    length = l_orig + pad
    nc = length // q

    xf = x.float().reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = b_mat.float().reshape(bsz, nc, q, h, n)
    cc = c_mat.float().reshape(bsz, nc, q, h, n)

    da = dtc * a  # [B, nc, q, H], negative
    cs = torch.cumsum(da, dim=2)  # inclusive
    # Intra-chunk quadratic term: seg[b,c,h,i,j] = exp(cs_i - cs_j), i >= j,
    # masked before the exp (module docstring).
    cb = torch.einsum("bcihn,bcjhn->bchij", cc, bc)
    cs_i = cs.transpose(2, 3)  # [B, nc, H, q]
    upper = torch.ones((q, q), dtype=torch.bool, device=x.device).triu(1)
    seg = torch.exp((cs_i[..., :, None] - cs_i[..., None, :]).masked_fill(upper, float("-inf")))
    scores = cb * seg * dtc.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores, xf)

    # Per-chunk outgoing state: decay_to_end[b,c,h,j] = exp(cs_last - cs_j).
    decay_to_end = torch.exp(cs_i[..., -1:] - cs_i)  # [B, nc, H, q]
    wgt = dtc * decay_to_end.transpose(2, 3)  # [B, nc, q, H]
    s_chunk = torch.einsum("bcjhn,bcjhp->bchnp", bc * wgt[..., None], xf)
    chunk_decay = torch.exp(cs_i[..., -1])  # [B, nc, H]

    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    entering = []  # the state entering each chunk
    for c in range(nc):
        entering.append(state)
        state = chunk_decay[:, c, :, None, None] * state + s_chunk[:, c]
    h_prev = torch.stack(entering, dim=1)  # [B, nc, H, N, P]
    y_inter = torch.einsum("bcihn,bchnp->bcihp", cc * torch.exp(cs)[..., None], h_prev)
    y = (y_intra + y_inter).reshape(bsz, length, h, p)[:, :l_orig]
    return y, state


def ssm_forward(p: dict, u: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Full-sequence Mamba2 block on ``u [B, L, D]``. Returns (out [B, L, D],
    new_state): the conv states in the activations' dtype, the SSM state
    float32."""
    bsz, length, _ = u.shape
    h, hp = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    z, x, bb, cc, dt = _project(p, u, cfg)
    x, ncx = _causal_conv(x, p["conv_x"], state["conv_x"] if state else None)
    bb, ncb = _causal_conv(bb.reshape(bsz, length, -1), p["conv_b"],
                           state["conv_b"] if state else None)
    cc, ncc = _causal_conv(cc.reshape(bsz, length, -1), p["conv_c"],
                           state["conv_c"] if state else None)
    rep = h // g
    b_h = torch.repeat_interleave(bb.reshape(bsz, length, g, n), rep, dim=2)  # [B, L, H, N]
    c_h = torch.repeat_interleave(cc.reshape(bsz, length, g, n), rep, dim=2)
    a = -torch.exp(p["a_log"].float())
    xh = x.reshape(bsz, length, h, hp)
    y, final = ssd_chunked(xh, dt, a, b_h, c_h, cfg.ssm_chunk, state["ssm"] if state else None)
    y = y + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.to(u.dtype).reshape(bsz, length, h * hp)
    # Gated RMSNorm (mamba2 norm-before-out with z gate).
    y = rmsnorm(y * _silu(z), p["gate_norm"], cfg.norm_eps)
    new_state = {"conv_x": ncx, "conv_b": ncb, "conv_c": ncc, "ssm": final}
    return y @ p["out"], new_state


def ssm_decode(p: dict, u: torch.Tensor, cfg: ModelConfig, state: dict):
    """Single-token recurrent step. u: [B, 1, D]; state from
    ``ssm_state_shapes`` (or a previous step). Returns (out, new_state)."""
    out, ncb, ncc, ((ncx, hnew),) = ssm_decode_heads(
        p, u, cfg, state["conv_b"], state["conv_c"],
        [(0, cfg.ssm_heads, state["conv_x"], state["ssm"])])
    return out, {"conv_x": ncx, "conv_b": ncb, "conv_c": ncc, "ssm": hnew}


def ssm_decode_heads(p: dict, u: torch.Tensor, cfg: ModelConfig, conv_b: torch.Tensor,
                     conv_c: torch.Tensor, blocks):
    """The recurrent step of ``u [B, 1, D]`` over head blocks: ``blocks`` is
    ``[(h0, h1, conv_x [B, w-1, (h1-h0)·Pd], ssm [B, h1-h0, N, Pd])]``, the
    states of heads ``h0 .. h1-1`` (together all heads, in order).
    Returns (out, new conv_b, new conv_c, [(new conv_x, new ssm)] a block)."""
    bsz = u.shape[0]
    h, hp = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    z, x, bb, cc, dt = _project(p, u, cfg)
    bb, ncb = _causal_conv(bb.reshape(bsz, 1, -1), p["conv_b"], conv_b)
    cc, ncc = _causal_conv(cc.reshape(bsz, 1, -1), p["conv_c"], conv_c)
    rep = h // g
    b_h = torch.repeat_interleave(bb.reshape(bsz, 1, g, n), rep, dim=2)[:, 0]  # [B, H, N]
    c_h = torch.repeat_interleave(cc.reshape(bsz, 1, g, n), rep, dim=2)[:, 0]
    a = -torch.exp(p["a_log"].float())
    dt0 = dt[:, 0]  # [B, H]
    ys, new = [], []
    for h0, h1, conv_x, state in blocks:
        c0, c1 = h0 * hp, h1 * hp
        xb, ncx = _causal_conv(x[..., c0:c1], p["conv_x"][:, c0:c1], conv_x)
        xh = xb.reshape(bsz, h1 - h0, hp).float()
        dtb = dt0[:, h0:h1]
        decay = torch.exp(dtb * a[h0:h1])  # [B, h]
        upd = torch.einsum("bhn,bhp->bhnp", dtb[..., None] * b_h[:, h0:h1].float(), xh)
        hnew = decay[..., None, None] * state + upd
        y = torch.einsum("bhn,bhnp->bhp", c_h[:, h0:h1].float(), hnew)
        ys.append(y + p["d_skip"][h0:h1].float()[None, :, None] * xh)
        new.append((ncx, hnew))
    y = torch.cat(ys, dim=1).reshape(bsz, 1, h * hp).to(u.dtype)
    y = rmsnorm(y * _silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out"], ncb, ncc, new


def ssm_state_shapes(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Zero-init decode state for one layer: bf16 conv states, f32 SSM state
    (the reference's dtypes)."""
    w = cfg.ssm_conv_width
    gn = cfg.ssm_groups * cfg.ssm_state

    def zeros(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "conv_x": zeros(batch, w - 1, cfg.d_inner),
        "conv_b": zeros(batch, w - 1, gn),
        "conv_c": zeros(batch, w - 1, gn),
        "ssm": zeros(batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, dtype=torch.float32),
    }
