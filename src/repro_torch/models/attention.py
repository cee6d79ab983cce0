"""GQA/MQA attention, over the full sequence or through a KV cache.

Score paths, chosen by shape as the reference chooses them:
  * the flash kernel (``kernels/ops.flash_attention`` through
    ``models/flash_xla.py``): full-sequence attention with no window and
    no query offset -- training, the embedder, and the prefill of a
    prompt at position 0; its plain version on the CPU, differentiable
    through the gradient kernel;
  * ``_einsum_attn``: exact scores for one query row or up to
    ``_EINSUM_MAX_S`` keys, with a query offset and a window;
  * ``_chunked_attn``: online softmax over ``CHUNK``-key blocks past
    that, so live memory is O(Sq * CHUNK).
The reference also picks by a ``use_kernel`` switch; the port has none.

The KV cache of a block is ``{"k", "v"}``, each (B, Hkv, Smax, hd) in the
compute dtype; ``attention`` writes the new positions into it in place.
Decode (one token) merges the new token into the softmax as an explicit
extra term (``_decode_attn_delta``).  The cache products keep K/V in
their storage dtype and sum in float32 (``_f32_product``).  The window
argument serves the sliding-window blocks, which come with ROADMAP
Queue 1 item 11.4b.
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
    operands are widened first (exact: a bf16 product fits float32)."""
    if a.dtype == b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
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
    0-d integer tensor).  The flash kernel where it computes the function
    (no window, no offset, and Sq == Sk under the causal mask;
    differentiable in q, k and v), else the exact einsum for one query
    row or up to ``_EINSUM_MAX_S`` keys, else the chunked scan."""
    Sq, Sk = q.shape[2], k.shape[2]
    if window is None and _offset_is_zero(q_offset) and (
            Sq == Sk or not causal):
        return flash_attention_xla(q, k, v, causal)
    if Sq == 1 or Sk <= _EINSUM_MAX_S:
        return _einsum_attn(q, k, v, causal, window, q_offset)
    return _chunked_attn(q, k, v, causal, window, q_offset)


class Attention(nn.Module):
    """q/k/v projections, RoPE, attention and the output projection."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
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
        return attention(self, self.cfg, x, pos0=pos0, cache=cache)


def attention(p, cfg: ModelConfig, x, *, pos0=0, cache=None):
    """x: (B, S, d) -> (B, S, d), causal, x's rows at positions pos0 ..
    pos0 + S - 1 (pos0 an int or a 0-d integer tensor).

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
        out = sdpa(q, k, v, causal=True)
    elif S == 1:
        out = _decode_attn_delta(q, cache["k"], cache["v"], k, v, pos0,
                                 None)
        _write(cache, k, v, pos)
    else:
        _write(cache, k, v, pos)
        out = (sdpa(q, k, v, causal=True) if _offset_is_zero(pos0) else
               sdpa(q, cache["k"], cache["v"], causal=True, q_offset=pos0))
    return out.transpose(1, 2).reshape(B, S, H * hd) @ p.wo


def _write(cache, k, v, pos) -> None:
    """k, v (B, Hkv, S, hd) into the cache at positions pos (S,), in
    place (``index_copy_``: no host read of a tensor position)."""
    cache["k"].index_copy_(2, pos, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, pos, v.to(cache["v"].dtype))
