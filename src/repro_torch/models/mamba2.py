"""Mamba2 (SSD — state-space duality) block, chunked scan + single-step decode
(port of `repro.models.mamba2`).

Implements the SSD recurrence per head (state (N, P), head dim P):

    h_t = a_t * h_{t-1} + dt_t * B_t (x)  (outer product B_t x_t^T)
    y_t = C_t . h_t + D * x_t,            a_t = exp(dt_t * A),  A < 0

* Train/prefill use the chunked algorithm: an intra-chunk attention-like
  term (Q x Q per chunk) plus an inter-chunk state recurrence, a Python loop
  over chunks (the reference's `lax.scan`).
* Decode carries (conv_state (w-1 taps), ssm_state (H, N, P)): O(1) per
  token.  Decode is chosen by `cache is not None and T == 1`, so a
  one-token prefill takes the decode branch, as in the reference.
* Single B/C group (g = 1).
* Training takes autograd's gradients through the conv and the chunked SSD.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import tp
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import hints

Cache = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


class Mamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        d_inner, nheads, _, n = _dims(cfg)
        conv_dim = d_inner + 2 * n
        self.in_proj = L.he_init((cfg.d_model, 2 * d_inner + 2 * n + nheads), gen, device)
        self.conv_w = L.he_init((cfg.ssm_conv, conv_dim), gen, device, fan_in=cfg.ssm_conv)
        self.conv_b = L.const_init((conv_dim,), 0.0, device)
        self.a_log = L.const_init((nheads,), 0.0, device, torch.float32)
        self.d_skip = L.const_init((nheads,), 1.0, device, torch.float32)
        self.dt_bias = L.const_init((nheads,), 0.0, device, torch.float32)
        self.norm = L.RMSNorm(d_inner, device)
        self.out_proj = L.he_init((d_inner, cfg.d_model), gen, device, fan_in=d_inner)


def mamba2_make_cache(cfg: ModelConfig, batch: int, device) -> Cache:
    d_inner, nheads, p, n = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * n),
                                dtype=L.ACT_DTYPE, device=device),
            "ssm": torch.zeros((batch, nheads, n, p), dtype=torch.float32, device=device)}


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along time.  xbc: (B, T, C), w: (W, C)."""
    width, t = w.shape[0], xbc.shape[1]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2]))
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                      # (B, T+W-1, C)
    out = xp[:, 0:t] * w[0].to(xbc.dtype)
    for i in range(1, width):
        out = out + xp[:, i:i + t] * w[i].to(xbc.dtype)
    return L.silu(out + b.to(xbc.dtype))


def _ssd_chunked(x, dt, a_log, bmat, cmat, d_skip, chunk: int):
    """x: (B,T,H,P), dt: (B,T,H) (softplus applied), bmat/cmat: (B,T,N).

    Returns y: (B,T,H,P) and the final state (B,H,N,P) float32.
    """
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, t)
    t_orig = t
    if t % q:
        # Zero padding is exact for the recurrence: dt = 0 gives decay
        # exp(0*A) = 1 and input contribution 0; padded y is sliced off.
        pad = q - t % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        t = t + pad
    nc = t // q

    a = -torch.exp(a_log)                                  # (H,)
    la = dt * a                                            # log decay per step (B,T,H)
    xr = x.reshape(b, nc, q, h, p).float()
    dtr = dt.reshape(b, nc, q, h)
    br = bmat.reshape(b, nc, q, n)
    cr = cmat.reshape(b, nc, q, n)

    lcum = torch.cumsum(la.reshape(b, nc, q, h), dim=2)    # (B,NC,Q,H)
    ltot = lcum[:, :, -1:, :]                              # (B,NC,1,H)

    # --- intra-chunk (attention-like, causal): L[t,s] = exp(lcum_t - lcum_s), s <= t
    diff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]          # (B,NC,Q,Q,H)
    mask = torch.arange(q, device=x.device)[:, None] >= torch.arange(q, device=x.device)
    # exp of -inf above the diagonal gives the reference's zeros, and a zero
    # gradient there: exp(diff) itself overflows to inf at a long chunk, and
    # where()'s zero cotangent times inf is NaN.
    lmat = torch.exp(torch.where(mask[:, :, None], diff, float("-inf")))
    cb = torch.einsum('bcqn,bcsn->bcqs', cr, br)                       # (B,NC,Q,Q), x.dtype
    w_ = cb[..., None].float() * lmat * dtr[:, :, None, :, :]         # (B,NC,Q,Q,H)
    y_intra = torch.einsum('bcqsh,bcshp->bcqhp', w_, xr)

    # --- chunk summary states ---
    decay_to_end = torch.exp(ltot - lcum)                              # (B,NC,Q,H)
    s_chunk = torch.einsum('bcqn,bcqh,bcqhp->bchnp', br.float(), dtr * decay_to_end, xr)

    # --- inter-chunk recurrence (the state before each chunk) ---
    chunk_decay = torch.exp(ltot[:, :, 0, :])                          # (B,NC,H)
    hstate = x.new_zeros((b, h, n, p), dtype=torch.float32)
    h_prev = []
    for c in range(nc):
        h_prev.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_prev = torch.stack(h_prev, dim=1)                                # (B,NC,H,N,P)

    y_inter = torch.einsum('bcqn,bcqh,bchnp->bcqhp', cr.float(), torch.exp(lcum), h_prev)
    y = (y_intra + y_inter).reshape(b, t, h, p)
    y = y + d_skip[:, None] * x.float()
    return y[:, :t_orig].to(x.dtype), hstate


def mamba2_apply(params: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                 cache: Optional[Cache] = None, cache_pos: Optional[int] = None,
                 ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, T, d).  Decode when cache is given and T == 1; the cache's
    entries are replaced in place and the cache returned."""
    g = tp.group()
    if g is not None:
        return _mamba2_tp(params, x, cfg, cache, g)
    bsz, t, _ = x.shape
    d_inner, nheads, p, n = _dims(cfg)
    zxbcdt = x @ params.in_proj.to(x.dtype)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * n, nheads], dim=-1)
    dt = F.softplus(dt_raw.float() + params.dt_bias)                   # (B,T,H)

    if cache is not None and t == 1:
        new_conv = torch.cat([cache["conv"], xbc], dim=1)[:, 1:, :]
        xbc_c = _causal_conv(xbc, params.conv_w, params.conv_b, state=cache["conv"])
        xs, bmat, cmat = torch.split(xbc_c, [d_inner, n, n], dim=-1)
        xh = xs.reshape(bsz, nheads, p)                                 # (B,H,P)
        a = -torch.exp(params.a_log)                                    # (H,)
        dec = torch.exp(dt[:, 0, :] * a)                                # (B,H)
        h = cache["ssm"] * dec[:, :, None, None] + torch.einsum(
            'bn,bh,bhp->bhnp', bmat[:, 0].float(), dt[:, 0], xh.float())
        y = torch.einsum('bn,bhnp->bhp', cmat[:, 0].float(), h)
        y = y + params.d_skip[:, None] * xh.float()
        y = y.reshape(bsz, 1, d_inner).to(x.dtype)
        cache["conv"] = new_conv.to(cache["conv"].dtype)
        cache["ssm"] = h
    else:
        xbc_c = _causal_conv(xbc, params.conv_w, params.conv_b)
        xs, bmat, cmat = torch.split(xbc_c, [d_inner, n, n], dim=-1)
        y, final = _ssd_chunked(xs.reshape(bsz, t, nheads, p), dt, params.a_log, bmat, cmat,
                                params.d_skip, cfg.ssm_chunk)
        y = y.reshape(bsz, t, d_inner)
        if cache is not None:   # prefill: leave the last conv taps + the final state
            taps = cfg.ssm_conv - 1
            conv = torch.cat([xbc.new_zeros((bsz, taps, xbc.shape[2])), xbc], dim=1)
            cache["conv"] = conv[:, conv.shape[1] - taps:, :].to(cache["conv"].dtype)
            cache["ssm"] = final

    # gated RMSNorm (mamba2: norm(y * silu(z)))
    y = params.norm(y * L.silu(z), cfg.norm_eps)
    return y @ params.out_proj.to(x.dtype), cache


def _mamba2_tp(params: Mamba2, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Cache], g
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """`mamba2_apply` on a layout.  The rank takes its heads (all where the
    model axis does not divide them): z and dt for its heads, and the whole
    xBC (B and C are shared by every head, and the conv cache's channel
    block crosses the x | B | C boundaries), from in_proj, which the specs
    cut across z | xBC | dt and so is gathered whole; conv_w and conv_b
    likewise.  The conv runs on every channel: prefill leaves the rank's
    channel block of the last taps, decode gathers the conv cache's
    channels first.  The SSM runs the rank's heads against its head block
    of the ssm cache; the gated RMSNorm sums its squares over the axis
    (the norm is over the whole d_inner), and out_proj's rows are summed
    over the axis in float32."""
    bsz, t, _ = x.shape
    d_inner, nheads, p, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    h0, h1, split = tp.split(nheads, g)
    hl, dl = h1 - h0, (h1 - h0) * p
    dt0 = 2 * d_inner + 2 * n
    cols = [(h0 * p, h1 * p), (d_inner, dt0), (dt0 + h0, dt0 + h1)]
    zxbcdt = tp.column(g, x, tp.take(g, params.in_proj, 1, cols, dt0 + nheads, split), split)
    z, xbc, dt_raw = torch.split(zxbcdt, [dl, conv_dim, hl], dim=-1)
    heads = [(h0, h1)]
    dt = F.softplus(dt_raw.float() + tp.take(g, params.dt_bias, 0, heads, nheads, split))
    a_log = tp.take(g, params.a_log, 0, heads, nheads, split)
    d_skip = tp.take(g, params.d_skip, 0, heads, nheads, split)
    conv_w = tp.take(g, params.conv_w, 1, [(0, conv_dim)], conv_dim, split)
    conv_b = tp.take(g, params.conv_b, 0, [(0, conv_dim)], conv_dim, split)
    own = slice(h0 * p, h1 * p)

    if cache is not None and t == 1:
        state = tp.whole(g, cache["conv"], 2, conv_dim)
        new_conv = torch.cat([state, xbc], dim=1)[:, 1:, :]
        xbc_c = _causal_conv(xbc, conv_w, conv_b, state=state)
        xs, bmat, cmat = torch.split(xbc_c, [d_inner, n, n], dim=-1)
        xh = xs[..., own].reshape(bsz, hl, p)
        dec = torch.exp(dt[:, 0, :] * -torch.exp(a_log))
        h = cache["ssm"] * dec[:, :, None, None] + torch.einsum(
            'bn,bh,bhp->bhnp', bmat[:, 0].float(), dt[:, 0], xh.float())
        y = torch.einsum('bn,bhnp->bhp', cmat[:, 0].float(), h)
        y = y + d_skip[:, None] * xh.float()
        y = y.reshape(bsz, 1, dl).to(x.dtype)
        cache["conv"] = hints.model_block(new_conv, 2, conv_dim).to(cache["conv"].dtype)
        cache["ssm"] = h
    else:
        xbc_c = _causal_conv(xbc, conv_w, conv_b)
        xs, bmat, cmat = torch.split(xbc_c, [d_inner, n, n], dim=-1)
        y, final = _ssd_chunked(xs[..., own].reshape(bsz, t, hl, p), dt, a_log, bmat, cmat,
                                d_skip, cfg.ssm_chunk)
        y = y.reshape(bsz, t, dl)
        if cache is not None:
            taps = cfg.ssm_conv - 1
            conv = torch.cat([xbc.new_zeros((bsz, taps, conv_dim)), xbc], dim=1)
            conv = hints.model_block(conv[:, conv.shape[1] - taps:, :], 2, conv_dim)
            cache["conv"] = conv.to(cache["conv"].dtype)
            cache["ssm"] = final

    # gated RMSNorm over the whole d_inner: the squares summed over the axis
    yz = y * L.silu(z)
    yf = yz.float()
    sq = torch.sum(yf * yf, dim=-1, keepdim=True)
    if split:   # every rank normalises its own block with the sum: its gradient is a partial
        sq = tp.enter(g, tp.reduce(g, sq))
    scale = tp.take(g, params.norm.scale, 0, [(h0 * p, h1 * p)], d_inner, split)
    yn = (yf * torch.rsqrt(sq / d_inner + cfg.norm_eps) * scale.float()).to(yz.dtype)
    return tp.row(g, yn, params.out_proj, [(h0 * p, h1 * p)], d_inner, split), cache
