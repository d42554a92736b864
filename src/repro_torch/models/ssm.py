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

A tensor-parallel model shard computes its part of a layer from its own
blocks (``models/model.py::_tp_mamba``): ``bc_block`` (its channels of B
and C: the conv is depthwise, so a channel needs only its own columns of
the replicated ``in_b``/``in_c``/``conv_b``/``conv_c`` and its own conv
state), ``heads_forward`` / ``heads_step`` (its heads' columns of
``in_z``/``in_x``/``in_dt``, channels of ``conv_x``, ``a_log``,
``dt_bias``, ``d_skip``; the SSD or the recurrent step over those heads
only, given the whole B and C), ``gate_sumsq`` (its share of the gated
norm's statistic) and ``gated_rows`` (its channels normed by the whole
statistic, through its rows of ``out`` in float32). ``ssm_forward`` is
``bc_block`` and ``heads_forward`` over every channel and head, with the
norm and ``out`` on one device.

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
from repro_torch.models.layers import matmul_f32, rmsnorm
from repro_torch.models.params import ParamDef

__all__ = ["ssm_schema", "ssd_chunked", "ssm_forward", "ssm_decode", "ssm_decode_heads",
           "ssm_state_shapes", "bc_block", "heads_forward", "heads_step", "gate_sumsq",
           "gated_rows"]


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
    return z, x, bb.reshape(b, length, g, n), cc.reshape(b, length, g, n), _dt(p, u)


def _dt(p: dict, u: torch.Tensor) -> torch.Tensor:
    """The heads' step sizes ``softplus(u @ in_dt + dt_bias)``, float32
    ``[B, L, heads]``."""
    return torch.nn.functional.softplus((u @ p["in_dt"]).float() + p["dt_bias"].float())


def _heads_bc(mat: torch.Tensor, cfg: ModelConfig, h0: int, h1: int) -> torch.Tensor:
    """``mat [B, L, G·N]`` (B or C) for heads ``h0 .. h1 - 1``: ``[B, L,
    h1 - h0, N]``, each head its group's row (only those heads' groups are
    repeated)."""
    bsz, length, _ = mat.shape
    g, n = cfg.ssm_groups, cfg.ssm_state
    rep = cfg.ssm_heads // g
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    out = torch.repeat_interleave(mat.reshape(bsz, length, g, n)[:, :, g0:g1], rep, dim=2)
    return out[:, :, h0 - g0 * rep:h1 - g0 * rep]


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


def bc_block(p: dict, u: torch.Tensor, c0: int, c1: int, conv_b: torch.Tensor | None = None,
             conv_c: torch.Tensor | None = None):
    """Channels ``c0 .. c1 - 1`` of B and C over ``u [B, L, D]`` after the
    causal conv, from those columns of ``in_b``/``in_c`` and
    ``conv_b``/``conv_c`` and the channels' conv states (``[B, w-1, c1 -
    c0]``; None: zeros). The conv is depthwise, so a block of channels needs
    nothing of the others. Returns (b, c ``[B, L, c1 - c0]``, new conv_b,
    new conv_c)."""
    b, ncb = _causal_conv(u @ p["in_b"][:, c0:c1], p["conv_b"][:, c0:c1], conv_b)
    c, ncc = _causal_conv(u @ p["in_c"][:, c0:c1], p["conv_c"][:, c0:c1], conv_c)
    return b, c, ncb, ncc


def heads_forward(p: dict, u: torch.Tensor, cfg: ModelConfig, h0: int, h1: int, bb: torch.Tensor,
                  cc: torch.Tensor, conv_x: torch.Tensor | None = None,
                  state: torch.Tensor | None = None):
    """The chunked SSD of heads ``h0 .. h1 - 1`` over ``u [B, L, D]``.
    ``p`` holds those heads' columns of ``in_z``/``in_x``/``in_dt``, their
    channels of ``conv_x`` and their ``a_log``/``dt_bias``/``d_skip`` (a
    model shard's blocks, or a whole layer for every head); ``bb``/``cc``
    are all of B and C after the conv (``[B, L, G·N]``); ``conv_x`` and
    ``state`` the heads' states (None: zeros). Returns (``y · silu(z)``
    ``[B, L, (h1 - h0)·P]`` in ``u``'s dtype, the input of the gated norm;
    new conv_x; the final state ``[B, h1 - h0, N, P]`` float32)."""
    bsz, length, _ = u.shape
    z = u @ p["in_z"]
    x, ncx = _causal_conv(u @ p["in_x"], p["conv_x"], conv_x)
    a = -torch.exp(p["a_log"].float())
    xh = x.reshape(bsz, length, h1 - h0, cfg.ssm_head_dim)
    y, final = ssd_chunked(xh, _dt(p, u), a, _heads_bc(bb, cfg, h0, h1),
                           _heads_bc(cc, cfg, h0, h1), cfg.ssm_chunk, state)
    y = y + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.to(u.dtype).reshape(bsz, length, -1)
    return y * _silu(z), ncx, final


def _recur(xh, dt, a, b_h, c_h, d_skip, state):
    """One recurrent step of heads: ``xh [B, h, P]`` f32, ``dt [B, h]``,
    ``a [h]``, ``b_h``/``c_h [B, h, N]``, ``state [B, h, N, P]`` f32.
    Returns (y ``[B, h, P]`` f32 with the skip, new state)."""
    decay = torch.exp(dt * a)  # [B, h]
    upd = torch.einsum("bhn,bhp->bhnp", dt[..., None] * b_h.float(), xh)
    hnew = decay[..., None, None] * state + upd
    y = torch.einsum("bhn,bhnp->bhp", c_h.float(), hnew)
    return y + d_skip.float()[None, :, None] * xh, hnew


def heads_step(p: dict, u: torch.Tensor, cfg: ModelConfig, h0: int, h1: int, bb: torch.Tensor,
               cc: torch.Tensor, conv_x: torch.Tensor, state: torch.Tensor):
    """``heads_forward``'s recurrent step on ``u [B, 1, D]`` (``bb``/``cc``
    ``[B, 1, G·N]``; the heads' conv_x and state given). Returns
    (``y · silu(z)`` ``[B, 1, (h1 - h0)·P]``, new conv_x, new state)."""
    bsz = u.shape[0]
    z = u @ p["in_z"]
    x, ncx = _causal_conv(u @ p["in_x"], p["conv_x"], conv_x)
    xh = x.reshape(bsz, h1 - h0, cfg.ssm_head_dim).float()
    y, hnew = _recur(xh, _dt(p, u)[:, 0], -torch.exp(p["a_log"].float()),
                     _heads_bc(bb, cfg, h0, h1)[:, 0], _heads_bc(cc, cfg, h0, h1)[:, 0],
                     p["d_skip"], state)
    return y.reshape(bsz, 1, -1).to(u.dtype) * _silu(z), ncx, hnew


def gate_sumsq(gz: torch.Tensor) -> torch.Tensor:
    """A block of channels' share of the gated norm's statistic: the float32
    sum of squares of ``gz [B, L, C]`` over its channels, ``[B, L, 1]``."""
    gf = gz.float()
    return torch.sum(gf * gf, dim=-1, keepdim=True)


def gated_rows(p: dict, gz: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    """A block of channels through the gated norm and its rows of ``out``:
    ``gz`` scaled by ``rstd`` (``rsqrt`` of the whole ``d_inner``'s mean
    square plus eps, ``[B, L, 1]`` float32) and its ``gate_norm``, rounded
    to ``gz``'s dtype as ``rmsnorm`` rounds, times its rows of ``out`` in
    float32: a row-parallel partial ``[B, L, D]``."""
    h = (gz.float() * rstd * p["gate_norm"].float()).to(gz.dtype)
    return matmul_f32(h, p["out"])


def ssm_forward(p: dict, u: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Full-sequence Mamba2 block on ``u [B, L, D]``. Returns (out [B, L, D],
    new_state): the conv states in the activations' dtype, the SSM state
    float32."""
    st = state or {}
    bb, cc, ncb, ncc = bc_block(p, u, 0, cfg.ssm_groups * cfg.ssm_state, st.get("conv_b"),
                                st.get("conv_c"))
    gz, ncx, final = heads_forward(p, u, cfg, 0, cfg.ssm_heads, bb, cc, st.get("conv_x"),
                                   st.get("ssm"))
    # Gated RMSNorm (mamba2 norm-before-out with z gate).
    y = rmsnorm(gz, p["gate_norm"], cfg.norm_eps)
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
        y, hnew = _recur(xb.reshape(bsz, h1 - h0, hp).float(), dt0[:, h0:h1], a[h0:h1],
                         b_h[:, h0:h1], c_h[:, h0:h1], p["d_skip"][h0:h1], state)
        ys.append(y)
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
