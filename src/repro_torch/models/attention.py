"""Attention: GQA (with qk-norm / qkv-bias variants) and MLA (DeepSeek)
(port of `repro.models.attention`).

Three entry modes share one code path:
  * train/prefill: full-sequence chunked-flash attention (a streaming
    softmax over (q_chunk, kv_chunk) blocks in plain PyTorch: O(chunk^2)
    live scores instead of O(S^2));
  * decode: one query position against a (B, S, ...) KV cache;
  * MLA decode uses the *absorbed* form (q projected into the compressed
    kv-lora space, attention performed against the cached c-vectors) — the
    cache stays (B, S, r + rope_dim) instead of (B, S, 2*H*hd).

Scores, softmax and the absorbed decode run in float32, as the reference's
`preferred_element_type=float32` products do: bf16 operands are widened,
so each product is exact and the sum is float32.  Masked scores are -1e30
(not -inf), so a fully masked row gives no NaN.

Caches are updated in place (prefill writes positions [0, T), decode writes
`cache_pos`) and returned.  Only the chunked flash attention has a backward
(training); decode and the absorbed MLA decode serve under inference mode.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.models import layers as L
from repro_torch.models import tp
from repro_torch.models.config import ModelConfig

Cache = Dict[str, torch.Tensor]
MASKED = -1e30


# ---------------------------------------------------------------------------
# Chunked flash attention
# ---------------------------------------------------------------------------

def _live(causal: bool, q_offset: int, qi: int, q_chunk: int, ki: int, kv_chunk: int) -> bool:
    """Whether kv block ki holds a key that some query of q block qi sees.
    A block that none sees adds exactly nothing, in the forward (p = 0 after
    block 0 has set every row's max) and in the backward (p = 0), so the
    loops skip it."""
    return not causal or ki * kv_chunk <= q_offset + (qi + 1) * q_chunk - 1


def _flash_fwd_core(q, k, v, causal: bool, q_offset: int, q_chunk: int, kv_chunk: int):
    """The reference's streaming-softmax forward: for each block of q_chunk
    queries, a running max m, sum l and output o over the kv_chunk blocks.
    Query i sits at position q_offset + i for the causal mask.  Returns
    (o (B,T,H,Dv) in q's dtype, lse (B,KV,G,T) float32)."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]                      # may differ from d (MLA)
    g = h // kv
    scale = d ** -0.5
    nq, nkv = t // q_chunk, s // kv_chunk
    dev = q.device
    acc = torch.promote_types(q.dtype, torch.float32)   # float64 only under gradcheck

    qr = q.reshape(b, nq, q_chunk, kv, g, d)
    kr = k.reshape(b, nkv, kv_chunk, kv, d)
    vr = v.reshape(b, nkv, kv_chunk, kv, dv)
    blocks, lses = [], []
    for qi in range(nq):
        qb = qr[:, qi].to(acc)                                   # (B, qc, KV, G, D)
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, kv, g, q_chunk), MASKED, dtype=acc, device=dev)
        l = torch.zeros((b, kv, g, q_chunk), dtype=acc, device=dev)
        o = torch.zeros((b, kv, g, q_chunk, dv), dtype=acc, device=dev)
        for ki in range(nkv):
            if not _live(causal, q_offset, qi, q_chunk, ki, kv_chunk):
                continue
            vb = vr[:, ki]
            sc = torch.einsum('bqkgd,bskd->bkgqs', qb, kr[:, ki].to(acc)) * scale
            if causal:
                k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
                sc = torch.where(q_pos[:, None] >= k_pos[None, :], sc, MASKED)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum('bkgqs,bskd->bkgqd', p.to(vb.dtype).to(acc), vb.to(acc))
            o = o * corr[..., None] + pv
            m = m_new
        o = o / torch.clamp_min(l, 1e-30)[..., None]
        lses.append(m + torch.log(torch.clamp_min(l, 1e-30)))   # (B, KV, G, qc)
        # (B, KV, G, qc, Dv) -> (B, qc, KV*G, Dv)
        blocks.append(o.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, dv))
    return torch.cat(blocks, dim=1).to(q.dtype), torch.cat(lses, dim=-1)


def _flash_bwd(q, k, v, o, lse, do, causal: bool, q_offset: int, q_chunk: int,
               kv_chunk: int):
    """The reference's `_flash_bwd`: D = rowsum(do * o); an outer loop over
    kv blocks and an inner one over q blocks; p recomputed as exp(s - lse)
    in float32 (not rounded to the value dtype, as the forward's is);
    ds = p (dp - D) scale; dq accumulated per q block in float32; dq, dk, dv
    cast back to the inputs' dtypes."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kv
    scale = d ** -0.5
    nq, nkv = t // q_chunk, s // kv_chunk
    dev = q.device
    acc = torch.promote_types(q.dtype, torch.float32)

    qr = q.reshape(b, nq, q_chunk, kv, g, d)
    kr = k.reshape(b, nkv, kv_chunk, kv, d)
    vr = v.reshape(b, nkv, kv_chunk, kv, dv)
    dor = do.reshape(b, nq, q_chunk, kv, g, dv)
    lser = lse.reshape(b, kv, g, nq, q_chunk)
    # D_i = rowsum(do * o): (B, KV, G, nq, qc)
    dsum = torch.einsum('bthd,bthd->bht', do.to(acc), o.to(acc)).reshape(b, kv, g, nq, q_chunk)

    dq = [torch.zeros((b, q_chunk, kv, g, d), dtype=acc, device=dev) for _ in range(nq)]
    dks, dvs = [], []
    for ki in range(nkv):
        kb, vb = kr[:, ki].to(acc), vr[:, ki].to(acc)
        k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
        dk_j = torch.zeros((b, kv_chunk, kv, d), dtype=acc, device=dev)
        dv_j = torch.zeros((b, kv_chunk, kv, dv), dtype=acc, device=dev)
        for qi in range(nq):
            if not _live(causal, q_offset, qi, q_chunk, ki, kv_chunk):
                continue
            qb, dob = qr[:, qi].to(acc), dor[:, qi].to(acc)
            sc = torch.einsum('bqkgd,bskd->bkgqs', qb, kb) * scale
            if causal:
                q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
                sc = torch.where(q_pos[:, None] >= k_pos[None, :], sc, MASKED)
            p = torch.exp(sc - lser[:, :, :, qi, :, None])             # (B,KV,G,qc,kc)
            dv_j = dv_j + torch.einsum('bkgqs,bqkgd->bskd', p, dob)
            dp = torch.einsum('bqkgd,bskd->bkgqs', dob, vb)
            ds = p * (dp - dsum[:, :, :, qi, :, None]) * scale
            dk_j = dk_j + torch.einsum('bkgqs,bqkgd->bskd', ds, qb)
            dq[qi] = dq[qi] + torch.einsum('bkgqs,bskd->bqkgd', ds, kb)
        dks.append(dk_j)
        dvs.append(dv_j)
    return (torch.cat(dq, dim=1).reshape(b, t, h, d).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype), torch.cat(dvs, dim=1).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The reference's custom VJP: the forward saves (q, k, v, o, lse) and
    nothing of size T x S; the backward recomputes each probability block."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, q_chunk, kv_chunk):
        o, lse = _flash_fwd_core(q, k, v, causal, q_offset, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, q_offset, q_chunk, kv_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with record_function("lm.attn_bwd"):
            return _flash_bwd(q, k, v, o, lse, do, *ctx.args) + (None,) * 4


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B,T,H,D), k: (B,S,KV,D), v: (B,S,KV,Dv), H % KV == 0 -> (B,T,H,Dv).

    Memory-lean attention with a flash-2-style backward: training keeps
    O(B*T*H) residuals (o and the log-sum-exp), not O(B*H*T*S)
    probabilities."""
    t, s = q.shape[1], k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, t), min(kv_chunk, s)
    if t % q_chunk or s % kv_chunk:
        raise ValueError(f"flash_attention: chunks ({q_chunk}, {kv_chunk}) do not divide "
                         f"the lengths ({t}, {s})")
    return _FlashAttention.apply(q, k, v, causal, q_offset, q_chunk, kv_chunk)


def softmax(sc: torch.Tensor) -> torch.Tensor:
    """softmax over the last dim as exp(s - max) / sum (the reference's
    `jax.nn.softmax` form): over one rank, `tp.seq_softmax` computes the
    same operations, so a one-rank layout's decode has one device's bits."""
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_pos: int) -> torch.Tensor:
    """q: (B, 1, H, D), caches: (B, S, KV, D); attend over positions
    <= cache_pos (inclusive — the new token was already written)."""
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(b, kv, h // kv, d)
    sc = torch.einsum('bkgd,bskd->bkgs', qr.float(), k_cache.float()) * d ** -0.5
    pos = torch.arange(s, device=q.device)
    sc = torch.where(pos <= cache_pos, sc, MASKED)
    w = softmax(sc)
    o = torch.einsum('bkgs,bskd->bkgd', w.to(v_cache.dtype).float(), v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def _positions(b: int, t: int, cache_pos: Optional[int], device) -> torch.Tensor:
    if cache_pos is not None:
        return torch.full((b, 1), cache_pos, dtype=torch.int32, device=device)
    return torch.arange(t, dtype=torch.int32, device=device).expand(b, t)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        hd = cfg.resolved_head_dim
        d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        self.wq = L.he_init((d, h * hd), gen, device)
        self.wk = L.he_init((d, kv * hd), gen, device)
        self.wv = L.he_init((d, kv * hd), gen, device)
        self.wo = L.he_init((h * hd, d), gen, device, fan_in=h * hd)
        if cfg.qkv_bias:
            self.bq = L.const_init((h * hd,), 0.0, device)
            self.bk = L.const_init((kv * hd,), 0.0, device)
            self.bv = L.const_init((kv * hd,), 0.0, device)
        if cfg.qk_norm:
            self.q_norm = L.RMSNorm(hd, device)
            self.k_norm = L.RMSNorm(hd, device)


def gqa_make_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> Cache:
    shp = (batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shp, dtype=L.ACT_DTYPE, device=device),
            "v": torch.zeros(shp, dtype=L.ACT_DTYPE, device=device)}


def _project_qkv(p: GQA, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(b, t, cfg.num_heads, hd)
    k = k.reshape(b, t, cfg.num_kv_heads, hd)
    v = v.reshape(b, t, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = p.q_norm(q, cfg.norm_eps)
        k = p.k_norm(k, cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _write(cache: Cache, name: str, value: torch.Tensor, cache_pos: Optional[int]) -> None:
    """Prefill (cache_pos None) writes positions [0, T); decode writes cache_pos."""
    start = 0 if cache_pos is None else cache_pos
    cache[name][:, start:start + value.shape[1]] = value.to(cache[name].dtype)


def gqa_apply(p: GQA, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Cache] = None,
              cache_pos: Optional[int] = None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Train (cache=None), prefill (cache given, x full-seq, cache_pos=None),
    decode (cache given, x is (B,1,d), cache_pos the position)."""
    g = tp.group()
    if g is not None:
        return _gqa_tp(p, x, cfg, cache, cache_pos, g)
    b, t, _ = x.shape
    decode = cache is not None and cache_pos is not None
    q, k, v = _project_qkv(p, x, cfg, _positions(b, t, cache_pos if decode else None,
                                                 x.device))
    if cache is not None:
        _write(cache, "k", k, cache_pos)
        _write(cache, "v", v, cache_pos)
    if decode:
        o = decode_attention(q, cache["k"], cache["v"], cache_pos)
    else:
        o = flash_attention(q, k, v, cfg.causal)
    return o.reshape(b, t, -1) @ p.wo.to(x.dtype), cache


def seq_decode_attention(g, q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         cache_pos: int, start: int) -> torch.Tensor:
    """`decode_attention` over a cache whose sequence is cut over the model
    axis (this rank: positions [start, start + S_l)), with every head's q:
    the two-level softmax, the weights cast to the cache's dtype as one
    device casts them, each rank's float32 partial w.v summed over the
    axis."""
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(b, kv, h // kv, d)
    sc = torch.einsum('bkgd,bskd->bkgs', qr.float(), k_cache.float()) * d ** -0.5
    sc = torch.where(tp.positions_of(start, s, q.device) <= cache_pos, sc, MASKED)
    w = tp.seq_softmax(g, sc)
    o = torch.einsum('bkgs,bskd->bkgd', w.to(v_cache.dtype).float(), v_cache.float())
    return tp.reduce(g, o).reshape(b, 1, h, d).to(q.dtype)


def _write_kv(g, cache: Cache, k: torch.Tensor, v: torch.Tensor, kv_split: bool,
              cache_pos: Optional[int]) -> None:
    """Put k and v (B, T, KV_l, hd: this rank's KV heads when kv_split, else
    all) into the rank's cache block (all KV heads, its positions).  Prefill
    with the sequence cut moves them from heads over model to sequence over
    model with one all-to-all (padded to the whole sequence, so every
    block's exchange is the same size); decode's new token, or a cache
    whole over the sequence, gathers the heads."""
    start, length, seq_cut = tp.seq_block(g, cache, "k")
    kv = torch.stack([k, v])                                   # (2, B, T, KV_l, hd)
    p0 = 0 if cache_pos is None else cache_pos
    if kv_split and seq_cut and cache_pos is None:
        t = kv.shape[2]
        pad = kv.new_zeros(kv.shape[:2] + (length * g.size - t,) + kv.shape[3:])
        parts = torch.cat([kv, pad], dim=2).unflatten(2, (g.size, length)).movedim(2, 0)
        got = tp.all_to_all(g, parts)                          # (ranks, 2, B, S_l, KV_l, hd)
        kv = got.permute(1, 2, 3, 0, 4, 5).flatten(3, 4)[:, :, :max(0, min(length, t - start))]
        p0 = start
    elif kv_split:
        kv = tp.gather(g, kv, 3)
    tp.write_seq(cache, "k", kv[0], p0, start)
    tp.write_seq(cache, "v", kv[1], p0, start)


def _gqa_tp(p: GQA, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Cache],
            cache_pos: Optional[int], g) -> Tuple[torch.Tensor, Optional[Cache]]:
    """`gqa_apply` on a layout: the rank's query heads (all where the model
    axis does not divide them), its KV heads where the axis divides both
    counts (else every KV head, replicated as Megatron does), wo's rows
    summed over the axis in float32.  Prefill attends over the whole prompt
    with the rank's heads; decode over the sequence-cut cache with every
    head's q (one gather), and keeps its heads' output."""
    b, t, _ = x.shape
    hd, heads, kv_heads = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    decode = cache is not None and cache_pos is not None
    h0, h1, split = tp.split(heads, g)
    kv_split = split and kv_heads % g.size == 0
    k0, k1 = (h0 * kv_heads // heads, h1 * kv_heads // heads) if kv_split else (0, kv_heads)
    q_cols, kv_cols = [(h0 * hd, h1 * hd)], [(k0 * hd, k1 * hd)]
    q = tp.column(g, x, tp.take(g, p.wq, 1, q_cols, heads * hd, split), split)
    k = tp.column(g, x, tp.take(g, p.wk, 1, kv_cols, kv_heads * hd, split), split)
    v = tp.column(g, x, tp.take(g, p.wv, 1, kv_cols, kv_heads * hd, split), split)
    if cfg.qkv_bias:
        q = q + tp.take(g, p.bq, 0, q_cols, heads * hd, split).to(x.dtype)
        k = k + tp.take(g, p.bk, 0, kv_cols, kv_heads * hd, split).to(x.dtype)
        v = v + tp.take(g, p.bv, 0, kv_cols, kv_heads * hd, split).to(x.dtype)
    q = q.reshape(b, t, h1 - h0, hd)
    k = k.reshape(b, t, k1 - k0, hd)
    v = v.reshape(b, t, k1 - k0, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, tp.take(g, p.q_norm.scale, 0, [(0, hd)], hd, split), cfg.norm_eps)
        k = L.rms_norm(k, tp.take(g, p.k_norm.scale, 0, [(0, hd)], hd, split), cfg.norm_eps)
    positions = _positions(b, t, cache_pos if decode else None, x.device)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        _write_kv(g, cache, k, v, kv_split, cache_pos)
    if decode:
        start, _, seq_cut = tp.seq_block(g, cache, "k")
        if seq_cut:
            q_all = tp.gather(g, q, 2) if split else q
            o = seq_decode_attention(g, q_all, cache["k"], cache["v"], cache_pos, start)
            o = o[:, :, h0:h1]
        else:
            o = decode_attention(q, tp.grouped_kv(cache["k"], h0, h1, heads, kv_heads),
                                 tp.grouped_kv(cache["v"], h0, h1, heads, kv_heads), cache_pos)
    else:
        o = flash_attention(q, tp.grouped_kv(k, h0, h1, heads, kv_heads, k0),
                            tp.grouped_kv(v, h0, h1, heads, kv_heads, k0), cfg.causal)
    return tp.row(g, o.reshape(b, t, -1), p.wo, q_cols, heads * hd, split), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed-KV attention
# ---------------------------------------------------------------------------

MLA_QK_NOPE = 128
MLA_V_DIM = 128


class MLA(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        h, r, rd = cfg.num_heads, cfg.kv_lora_rank, cfg.rope_head_dim
        self.wq = L.he_init((cfg.d_model, h * (MLA_QK_NOPE + rd)), gen, device)
        self.w_dkv = L.he_init((cfg.d_model, r), gen, device)
        self.w_kr = L.he_init((cfg.d_model, rd), gen, device)
        self.w_uk = L.he_init((r, h, MLA_QK_NOPE), gen, device, fan_in=r)
        self.w_uv = L.he_init((r, h, MLA_V_DIM), gen, device, fan_in=r)
        self.wo = L.he_init((h * MLA_V_DIM, cfg.d_model), gen, device, fan_in=h * MLA_V_DIM)
        self.c_norm = L.RMSNorm(r, device)


def mla_make_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> Cache:
    return {"c": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=L.ACT_DTYPE,
                             device=device),
            "kr": torch.zeros((batch, max_seq, cfg.rope_head_dim), dtype=L.ACT_DTYPE,
                              device=device)}


def mla_apply(p: MLA, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Cache] = None,
              cache_pos: Optional[int] = None) -> Tuple[torch.Tensor, Optional[Cache]]:
    g = tp.group()
    if g is not None:
        return _mla_tp(p, x, cfg, cache, cache_pos, g)
    b, t, _ = x.shape
    h, rd = cfg.num_heads, cfg.rope_head_dim
    decode = cache is not None and cache_pos is not None
    positions = _positions(b, t, cache_pos if decode else None, x.device)

    q = (x @ p.wq.to(x.dtype)).reshape(b, t, h, MLA_QK_NOPE + rd)
    q_nope = q[..., :MLA_QK_NOPE]
    q_rope = L.apply_rope(q[..., MLA_QK_NOPE:], positions, cfg.rope_theta)
    c = p.c_norm(x @ p.w_dkv.to(x.dtype), cfg.norm_eps)                 # (B,T,r)
    kr = L.apply_rope((x @ p.w_kr.to(x.dtype))[:, :, None, :], positions,
                      cfg.rope_theta)                                   # (B,T,1,rd)
    if cache is not None:
        _write(cache, "c", c, cache_pos)
        _write(cache, "kr", kr[:, :, 0, :], cache_pos)

    if decode:
        # Absorbed decode: q~ = q_nope @ w_uk lives in the c-space (float32).
        scale = (MLA_QK_NOPE + rd) ** -0.5
        cc, ck = cache["c"].float(), cache["kr"].float()
        q_c = torch.einsum('bohn,rhn->bohr', q_nope.float(), p.w_uk.float())   # (B,1,H,r)
        sc = (torch.einsum('bohr,bsr->bhs', q_c, cc)
              + torch.einsum('bohd,bsd->bhs', q_rope.float(), ck)) * scale
        pos = torch.arange(cc.shape[1], device=x.device)
        sc = torch.where(pos <= cache_pos, sc, MASKED)
        w = softmax(sc)
        o_c = torch.einsum('bhs,bsr->bhr', w, cc)
        o = torch.einsum('bhr,rhv->bhv', o_c, p.w_uv.float())
        o = o.reshape(b, 1, h * MLA_V_DIM).to(x.dtype)
    else:
        k_nope = torch.einsum('btr,rhn->bthn', c, p.w_uk.to(c.dtype))
        v = torch.einsum('btr,rhv->bthv', c, p.w_uv.to(c.dtype))
        qf = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, kr.expand(b, t, h, rd).to(k_nope.dtype)], dim=-1)
        o = flash_attention(qf, k, v, cfg.causal).reshape(b, t, h * MLA_V_DIM)
    return o @ p.wo.to(x.dtype), cache


def _mla_tp(p: MLA, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Cache],
            cache_pos: Optional[int], g) -> Tuple[torch.Tensor, Optional[Cache]]:
    """`mla_apply` on a layout.  wq, w_uk, w_uv and wo's rows: the rank's
    heads.  w_dkv's columns are cut over the model axis, so x @ w_dkv comes
    out cut along r: one gather makes c whole on every rank (c_norm
    normalises over all of r, and every head's up-projection reads all of
    it); w_kr (its cut falls across RoPE's halves) is gathered whole.  The
    cache's sequence blocks are then cut from c and kr with no collective.
    The absorbed decode gathers every head's [q~ | q_rope] (one gather),
    scores the rank's positions, takes the two-level softmax and sums the
    float32 partial w.c over the axis, then keeps its heads."""
    b, t, _ = x.shape
    heads, rd, r = cfg.num_heads, cfg.rope_head_dim, cfg.kv_lora_rank
    nq = MLA_QK_NOPE + rd
    decode = cache is not None and cache_pos is not None
    positions = _positions(b, t, cache_pos if decode else None, x.device)
    h0, h1, split = tp.split(heads, g)
    hl = h1 - h0

    q = tp.column(g, x, tp.take(g, p.wq, 1, [(h0 * nq, h1 * nq)], heads * nq, split), split)
    q = q.reshape(b, t, hl, nq)
    q_nope = q[..., :MLA_QK_NOPE]
    q_rope = L.apply_rope(q[..., MLA_QK_NOPE:], positions, cfg.rope_theta)
    cut = p.w_dkv.shape[1] != r          # x @ w_dkv comes out as the rank's block of r
    w_dkv = p.w_dkv if cut else tp.take(g, p.w_dkv, 1, [(0, r)], r, split)
    c = tp.whole(g, tp.column(g, x, w_dkv, split or cut), 2, r, split)
    c = L.rms_norm(c, tp.take(g, p.c_norm.scale, 0, [(0, r)], r, split), cfg.norm_eps)  # (B,T,r)
    kr = tp.column(g, x, tp.take(g, p.w_kr, 1, [(0, rd)], rd, split), split)
    kr = L.apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)          # (B,T,1,rd)
    w_uk = tp.take(g, p.w_uk, 1, [(h0, h1)], heads, split)
    w_uv = tp.take(g, p.w_uv, 1, [(h0, h1)], heads, split)
    if cache is not None:
        start = tp.seq_block(g, cache, "c")[0]
        p0 = 0 if cache_pos is None else cache_pos
        tp.write_seq(cache, "c", c, p0, start)
        tp.write_seq(cache, "kr", kr[:, :, 0, :], p0, start)

    if decode:
        scale = nq ** -0.5
        cc, ck = cache["c"].float(), cache["kr"].float()
        start, length, seq_cut = tp.seq_block(g, cache, "c")
        q_c = torch.einsum('bohn,rhn->bohr', q_nope.float(), w_uk.float())      # (B,1,hl,r)
        qa = torch.cat([q_c, q_rope.float()], dim=-1)
        every = seq_cut and split
        if every:
            qa = tp.gather(g, qa, 2)                                            # every head
        q_c, q_r = qa[..., :r].contiguous(), qa[..., r:].contiguous()
        sc = (torch.einsum('bohr,bsr->bhs', q_c, cc)
              + torch.einsum('bohd,bsd->bhs', q_r, ck)) * scale
        sc = torch.where(tp.positions_of(start, length, x.device) <= cache_pos, sc, MASKED)
        if seq_cut:
            o_c = tp.reduce(g, torch.einsum('bhs,bsr->bhr', tp.seq_softmax(g, sc), cc))
        else:
            o_c = torch.einsum('bhs,bsr->bhr', softmax(sc), cc)
        if every:
            o_c = o_c[:, h0:h1]
        o = torch.einsum('bhr,rhv->bhv', o_c, w_uv.float())
        o = o.reshape(b, 1, hl * MLA_V_DIM).to(x.dtype)
    else:
        k_nope = torch.einsum('btr,rhn->bthn', c, w_uk.to(c.dtype))
        v = torch.einsum('btr,rhv->bthv', c, w_uv.to(c.dtype))
        qf = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, kr.expand(b, t, hl, rd).to(k_nope.dtype)], dim=-1)
        o = flash_attention(qf, k, v, cfg.causal).reshape(b, t, hl * MLA_V_DIM)
    return tp.row(g, o, p.wo, [(h0 * MLA_V_DIM, h1 * MLA_V_DIM)], heads * MLA_V_DIM,
                  split), cache


# ---------------------------------------------------------------------------

def attention_init(cfg: ModelConfig, gen, device) -> nn.Module:
    return MLA(cfg, gen, device) if cfg.use_mla else GQA(cfg, gen, device)


def attention_apply(p, x, cfg, cache=None, cache_pos=None):
    with record_function("lm.attn"):
        fn = mla_apply if cfg.use_mla else gqa_apply
        return fn(p, x, cfg, cache, cache_pos)


def attention_make_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> Cache:
    return (mla_make_cache if cfg.use_mla else gqa_make_cache)(cfg, batch, max_seq, device)
