"""GQA/MQA attention and DeepSeek's multi-head latent attention (MLA),
over the full sequence or through a cache.

Score paths, chosen by shape:
  * the flash kernel (``kernels/ops.flash_attention`` through
    ``models/flash_xla.py``): attention with no query offset and no
    window, or a window that masks nothing (every row's keys within
    it) -- training, the embedder, the encoder, cross-attention and the
    prefill of a prompt at position 0; its plain version on the CPU,
    differentiable through the gradient kernel;
  * ``_einsum_attn``: exact scores for one query row or up to
    ``_EINSUM_MAX_S`` keys, with a query offset and a window;
  * ``_chunked_attn``: online softmax over ``CHUNK``-key blocks past
    that, so live memory is O(Sq * CHUNK).
The reference also picks by a ``use_kernel`` switch, and sends any
window to the plain paths; the port has no switch, and sends a window
that masks nothing to the kernel.

The KV cache of a block is ``{"k", "v"}``, each (B, Hkv, Smax, hd) in the
compute dtype; ``attention`` writes the new positions into it in place.
Decode (one token) merges the new token into the softmax as an explicit
extra term (``_decode_attn_delta``).  The cache products keep K/V in
their storage dtype and sum in float32 (``_f32_product``).  A
sliding-window block (``BlockKind.LOCAL_ATTN``) keeps the reference's
cache, full K/V of Smax positions with the window applied as a mask,
not a ring, so its cache carries across to and from the reference.

An MLA block caches the latent ``{"ckv": (B, Smax, kv_lora), "kpe": (B,
Smax, rope_dim)}`` instead (576 values a position at deepseek-v2-lite's
width, against 2 * H * hd): ``mla_attention`` expands it to per-head K
(nope + rope wide) and V (v_dim wide) for a prompt, and a one-token
decode scores and reads values in the latent space itself
(``_mla_absorbed_decode``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.flash_xla import flash_attention_xla
from repro_torch.models.layers import apply_rope, he_init_, param

CHUNK = 1024
_EINSUM_MAX_S = 2048
_MASKED = -1e30


# ---------------------------------------------------------------------------
# Score paths
# ---------------------------------------------------------------------------

def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, m, k) @ b (N, k, n) summed in float32, the operands in their
    own dtype (the reference's ``preferred_element_type=float32``): on
    the card a float32-output product of the bf16 operands, so no float32
    copy of a KV cache is made; float32 operands take the plain product;
    on the CPU, where PyTorch has no float32-output product, bf16
    operands are widened first (exact: a bf16 product fits float32).  On
    the meta device (the dry run) the card's route."""
    if a.dtype == b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda or a.is_meta:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _mask(rows, cols, causal: bool, window):
    """(len(rows), len(cols)) bool: the keys each query row may see."""
    mask = torch.ones((rows.shape[0], cols.shape[0]), dtype=torch.bool,
                      device=cols.device)
    if causal:
        mask &= rows[:, None] >= cols[None, :]
    if window is not None:
        mask &= rows[:, None] - cols[None, :] < window
    return mask


def _einsum_attn(q, k, v, causal: bool, window, q_offset):
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd) -- exact, materialises
    the scores.  q_offset (an int or a 0-d integer tensor) is the
    position of q's first row; the causal mask is rows >= cols.  K/V stay
    in their storage dtype, the sums in float32."""
    B, H, Sq, hd = q.shape
    Hkv, Sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // Hkv
    qg = (q.float() / math.sqrt(hd)).to(k.dtype).reshape(B * Hkv, g * Sq, hd)
    s = _f32_product(qg, k.reshape(B * Hkv, Sk, hd).transpose(1, 2))
    rows = q_offset + torch.arange(Sq, device=q.device)
    mask = _mask(rows, torch.arange(Sk, device=q.device), causal, window)
    s = s.view(B * Hkv, g, Sq, Sk).masked_fill(~mask, _MASKED)
    w = torch.softmax(s, dim=-1).to(v.dtype).view(B * Hkv, g * Sq, Sk)
    o = _f32_product(w, v.reshape(B * Hkv, Sk, dv))
    return o.view(B, H, Sq, dv).to(q.dtype)


def _chunked_attn(q, k, v, causal: bool, window, q_offset):
    """Online softmax over CHUNK-key blocks of k, v (the last one ragged),
    in float32; O(Sq * CHUNK) live."""
    B, H, Sq, hd = q.shape
    Hkv, Sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // Hkv
    qg = (q.float() * (1.0 / math.sqrt(hd))).view(B, Hkv, g * Sq, hd)
    rows = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, g, Sq, 1), _MASKED, device=q.device)
    l = torch.zeros((B, Hkv, g, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, dv), device=q.device)
    for c0 in range(0, Sk, CHUNK):
        kb, vb = k[:, :, c0:c0 + CHUNK].float(), v[:, :, c0:c0 + CHUNK].float()
        n = kb.shape[2]
        s = torch.matmul(qg, kb.transpose(-1, -2)).view(B, Hkv, g, Sq, n)
        cols = c0 + torch.arange(n, device=q.device)
        s = s.masked_fill(~_mask(rows, cols, causal, window), _MASKED)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = torch.matmul(p.view(B, Hkv, g * Sq, n), vb)
        acc = acc * corr + pv.view(B, Hkv, g, Sq, dv)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.view(B, H, Sq, dv).to(q.dtype)


def _decode_attn_delta(q, cache_k, cache_v, k_new, v_new, pos0, window):
    """One-token attention over the cache rows below pos0 plus the new
    (k, v), the new token merged into the softmax as an explicit extra
    term: exact.  q: (B, H, 1, hd); cache: (B, Hkv, Smax, hd); k_new,
    v_new: (B, Hkv, 1, hd); pos0 an int or a 0-d integer tensor."""
    B, H, _, hd = q.shape
    Hkv, Sk, dv = cache_k.shape[1], cache_k.shape[2], cache_v.shape[-1]
    g = H // Hkv
    cdt = cache_k.dtype
    qg = (q.float() / math.sqrt(hd)).to(cdt).reshape(B * Hkv, g, hd)
    s_c = _f32_product(qg, cache_k.reshape(B * Hkv, Sk, hd).transpose(1, 2))
    cols = torch.arange(Sk, device=q.device)
    mask = cols < pos0
    if window is not None:
        mask &= (pos0 - cols) < window
    s_c = s_c.masked_fill(~mask, _MASKED)                     # (B*Hkv, g, Sk)
    kn = k_new.to(cdt).float().reshape(B * Hkv, 1, hd)
    s_n = torch.sum(qg.float() * kn, dim=-1, keepdim=True)    # (B*Hkv, g, 1)
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_n)
    w_c = torch.exp(s_c - m)
    w_n = torch.exp(s_n - m)
    denom = w_c.sum(-1, keepdim=True) + w_n
    o = (_f32_product(w_c.to(cache_v.dtype),
                      cache_v.reshape(B * Hkv, Sk, dv))
         + w_n * v_new.float().reshape(B * Hkv, 1, dv))
    o = o / denom
    return o.view(B, H, 1, dv).to(q.dtype)


def _offset_is_zero(q_offset) -> bool:
    """True only for the int 0: a tensor offset is never read back on the
    host."""
    return isinstance(q_offset, int) and q_offset == 0


def sdpa(q, k, v, *, causal: bool = True, window=None, q_offset=0):
    """Scaled dot-product attention, q (B, H, Sq, hd) against k, v
    (B, Hkv, Sk, hd), q's first row at position ``q_offset`` (an int or a
    0-d integer tensor); key j is seen by row i where j <= i (``causal``)
    and i - j < ``window`` (None: no window).  The flash kernel where it
    computes the function (no offset, no window or one that masks
    nothing -- at offset 0 every i - j is at most Sq - 1 -- and Sq == Sk
    under the causal mask; differentiable in q, k and v), else the exact
    einsum for one query row or up to ``_EINSUM_MAX_S`` keys, else the
    chunked scan."""
    Sq, Sk = q.shape[2], k.shape[2]
    if _offset_is_zero(q_offset) and window is not None and Sq - 1 < window:
        window = None                     # the window masks nothing
    if window is None and _offset_is_zero(q_offset) and (
            Sq == Sk or not causal):
        return flash_attention_xla(q, k, v, causal)
    if Sq == 1 or Sk <= _EINSUM_MAX_S:
        return _einsum_attn(q, k, v, causal, window, q_offset)
    return _chunked_attn(q, k, v, causal, window, q_offset)


class Attention(nn.Module):
    """q/k/v projections, RoPE, attention and the output projection:
    causal or not (an encoder), over all keys or the last ``window``
    positions (a sliding-window block)."""

    def __init__(self, cfg: ModelConfig, device=None, *, window=None,
                 causal: bool = True):
        super().__init__()
        self.cfg, self.window, self.causal = cfg, window, causal
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = cfg.pdtype
        self.wq = param(d, H * hd, dtype=dt, device=device)
        self.wk = param(d, Hkv * hd, dtype=dt, device=device)
        self.wv = param(d, Hkv * hd, dtype=dt, device=device)
        self.wo = param(H * hd, d, dtype=dt, device=device)

    def reset_parameters(self, generator) -> None:
        """The reference's ``init_attention``: normal / sqrt(fan_in)."""
        for w in (self.wq, self.wk, self.wv, self.wo):
            he_init_(w, generator)

    def forward(self, x, *, pos0=0, cache=None):
        return attention(self, self.cfg, x, pos0=pos0, cache=cache,
                         window=self.window, causal=self.causal)


def attention(p, cfg: ModelConfig, x, *, pos0=0, cache=None, window=None,
              causal: bool = True):
    """x: (B, S, d) -> (B, S, d), x's rows at positions pos0 .. pos0 + S
    - 1 (pos0 an int or a 0-d integer tensor), each attending to the
    keys ``sdpa``'s ``causal`` and ``window`` let it see.

    cache: None (the full sequence from position 0), or a block's
    ``{"k", "v"}`` (B, Hkv, Smax, hd), read and written in place at
    positions [pos0, pos0 + S).  One token (decode) attends to the
    cache's rows below pos0 and to itself, then is written at pos0.  A
    prompt at pos0 = 0 attends to its own rows only -- the rows past it
    would be masked -- so it runs the flash kernel on its own q, k, v; a
    prompt at pos0 > 0 reads the whole cache through the offset paths.
    The kernel reads q, k and v through their strides, so v stays a view
    of its projection."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p.wq).view(B, S, H, hd).transpose(1, 2)
    k = (x @ p.wk).view(B, S, Hkv, hd).transpose(1, 2)
    v = (x @ p.wv).view(B, S, Hkv, hd).transpose(1, 2)
    pos = pos0 + torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if cache is None:
        out = sdpa(q, k, v, causal=causal, window=window)
    elif S == 1:
        out = _decode_attn_delta(q, cache["k"], cache["v"], k, v, pos0,
                                 window)
        _write(cache, k, v, pos)
    else:
        _write(cache, k, v, pos)
        out = (sdpa(q, k, v, causal=causal, window=window)
               if _offset_is_zero(pos0) else
               sdpa(q, cache["k"], cache["v"], causal=causal, window=window,
                    q_offset=pos0))
    return out.transpose(1, 2).reshape(B, S, H * hd) @ p.wo


def _write(cache, k, v, pos) -> None:
    """k, v (B, Hkv, S, hd) into the cache at positions pos (S,), in
    place (``index_copy_``: no host read of a tensor position)."""
    cache["k"].index_copy_(2, pos, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, pos, v.to(cache["v"].dtype))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """The reference's ``init_mla``: w_dkv (d, kv_lora), w_kpe (d,
    rope_dim), w_uk (kv_lora, H * nope_dim), w_uv (kv_lora, H * v_dim),
    wq (d, H * (nope_dim + rope_dim)), wo (H * v_dim, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        m, d, H, dt = cfg.mla, cfg.d_model, cfg.n_heads, cfg.pdtype
        self.w_dkv = param(d, m.kv_lora, dtype=dt, device=device)
        self.w_kpe = param(d, m.rope_dim, dtype=dt, device=device)
        self.w_uk = param(m.kv_lora, H * m.nope_dim, dtype=dt, device=device)
        self.w_uv = param(m.kv_lora, H * m.v_dim, dtype=dt, device=device)
        self.wq = param(d, H * (m.nope_dim + m.rope_dim), dtype=dt,
                        device=device)
        self.wo = param(H * m.v_dim, d, dtype=dt, device=device)

    def reset_parameters(self, generator) -> None:
        """normal / sqrt(fan_in), fan_in each weight's first dimension."""
        for w in (self.w_dkv, self.w_kpe, self.w_uk, self.w_uv, self.wq,
                  self.wo):
            he_init_(w, generator)

    def forward(self, x, *, pos0=0, cache=None):
        return mla_attention(self, self.cfg, x, pos0=pos0, cache=cache)


def mla_attention(p, cfg: ModelConfig, x, *, pos0=0, cache=None):
    """x: (B, S, d) -> (B, S, d), causal, x's rows at positions pos0 ..
    pos0 + S - 1 (pos0 an int or a 0-d integer tensor).

    cache: None (the full sequence from position 0), or a block's latent
    ``{"ckv", "kpe"}``, written in place at positions [pos0, pos0 + S).
    ``kpe`` is roped as one head shared by all, ``q_pe`` per head; the
    softmax scale is 1 / sqrt(nope_dim + rope_dim), q's width.  One
    token attends in the latent space (``_mla_absorbed_decode``); a
    prompt at pos0 = 0 expands only its own rows and runs the flash
    kernel (v narrower than q and k); a prompt at pos0 > 0 expands the
    whole cache and reads it through the offset paths."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    qd = m.nope_dim + m.rope_dim
    pos = pos0 + torch.arange(S, device=x.device)
    ckv = x @ p.w_dkv                                       # (B, S, lora)
    kpe = apply_rope((x @ p.w_kpe)[:, None], pos, cfg.rope_theta)[:, 0]
    q = (x @ p.wq).view(B, S, H, qd).transpose(1, 2)
    q_nope, q_pe = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_pe = apply_rope(q_pe, pos, cfg.rope_theta)
    if cache is not None and S == 1:
        out = _mla_absorbed_decode(p, cfg, q_nope, q_pe, cache["ckv"],
                                   cache["kpe"], ckv, kpe, pos0)
        _write_latent(cache, ckv, kpe, pos)
        return out @ p.wo
    if cache is not None:
        _write_latent(cache, ckv, kpe, pos)
        if not _offset_is_zero(pos0):
            ckv, kpe = cache["ckv"], cache["kpe"]
    Sk = ckv.shape[1]
    k_nope = (ckv @ p.w_uk).view(B, Sk, H, m.nope_dim)
    v = (ckv @ p.w_uv).view(B, Sk, H, m.v_dim).transpose(1, 2)
    k = torch.cat([k_nope, kpe[:, :, None].expand(B, Sk, H, m.rope_dim)],
                  dim=-1).transpose(1, 2)                   # (B, H, Sk, qd)
    out = sdpa(torch.cat([q_nope, q_pe], dim=-1), k, v, causal=True,
               q_offset=pos0 if cache is not None else 0)
    return out.transpose(1, 2).reshape(B, S, H * m.v_dim) @ p.wo


def _write_latent(cache, ckv, kpe, pos) -> None:
    """ckv (B, S, kv_lora), kpe (B, S, rope_dim) into the latent cache at
    positions pos (S,), in place (``index_copy_``)."""
    cache["ckv"].index_copy_(1, pos, ckv.to(cache["ckv"].dtype))
    cache["kpe"].index_copy_(1, pos, kpe.to(cache["kpe"].dtype))


def _mla_absorbed_decode(p, cfg: ModelConfig, q_nope, q_pe, ckv_cache,
                         kpe_cache, ckv_new, kpe_new, pos0):
    """One-token MLA decode with W_uk and W_uv absorbed into the query and
    the output: scores and value reads in the kv_lora latent space over
    the cache rows below pos0 (the cache is never expanded to per-head
    K/V), the new token an explicit extra softmax term.  The cache
    products read the latent cache in its own dtype and sum in float32.
    q_nope (B, H, 1, nope_dim), q_pe (B, H, 1, rope_dim); returns (B, 1,
    H * v_dim) in the cache's dtype."""
    m = cfg.mla
    B, H = q_nope.shape[0], cfg.n_heads
    scale = 1.0 / math.sqrt(m.nope_dim + m.rope_dim)
    cdt = ckv_cache.dtype
    w_uk = p.w_uk.view(m.kv_lora, H, m.nope_dim).float()
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope[:, :, 0].float(),
                         w_uk).to(cdt)                       # (B, H, lora)
    q_pe_c = q_pe[:, :, 0].to(cdt)                           # (B, H, rope)
    s = (_f32_product(q_lat, ckv_cache.transpose(1, 2))
         + _f32_product(q_pe_c, kpe_cache.transpose(1, 2))) * scale
    cols = torch.arange(ckv_cache.shape[1], device=q_nope.device)
    s = s.masked_fill(~(cols < pos0), _MASKED)               # (B, H, Smax)
    s_n = (torch.sum(q_lat.float() * ckv_new.to(cdt).float(), dim=-1,
                     keepdim=True)
           + torch.sum(q_pe_c.float() * kpe_new.to(cdt).float(), dim=-1,
                       keepdim=True)) * scale                # (B, H, 1)
    mx = torch.maximum(s.amax(-1, keepdim=True), s_n)
    w_c = torch.exp(s - mx)
    w_n = torch.exp(s_n - mx)
    denom = w_c.sum(-1, keepdim=True) + w_n
    o_lat = (_f32_product(w_c.to(cdt), ckv_cache)
             + w_n * ckv_new.float()) / denom                # (B, H, lora)
    w_uv = p.w_uv.view(m.kv_lora, H, m.v_dim).float()
    o = torch.einsum("bhl,lhv->bhv", o_lat, w_uv)
    return o.reshape(B, 1, H * m.v_dim).to(cdt)
