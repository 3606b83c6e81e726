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
    w = torch.softmax(sc, dim=-1)
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
        w = torch.softmax(sc, dim=-1)
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


# ---------------------------------------------------------------------------

def attention_init(cfg: ModelConfig, gen, device) -> nn.Module:
    return MLA(cfg, gen, device) if cfg.use_mla else GQA(cfg, gen, device)


def attention_apply(p, x, cfg, cache=None, cache_pos=None):
    with record_function("lm.attn"):
        fn = mla_apply if cfg.use_mla else gqa_apply
        return fn(p, x, cfg, cache, cache_pos)


def attention_make_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> Cache:
    return (mla_make_cache if cfg.use_mla else gqa_make_cache)(cfg, batch, max_seq, device)
