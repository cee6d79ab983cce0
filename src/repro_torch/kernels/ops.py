"""Dispatch around the kernels: the per-shard bucket scan, attention and
the SSD scan (each with its gradient) and the p-stable hash.

``bucket_search`` takes the typed ``QueryBatch``/``StoreView`` surface
(keyword-only, every tensor with a leading shard axis) and dispatches on
the store's layout.  A bucket-sorted store (``n_sorted > 0``) goes
through the CSR path: per-probe span lookup by binary search, probe
expansion sorted by span start, the gather kernel over each probe's own
bucket in the sorted region, plus a full scan of the unsorted insert
tail.  Anything else takes the full-scan kernel.  The CSR answers are
bitwise equal to the full scan's.

The reference's gather streams a fixed window of aligned store tiles per
row tile and falls back to the full scan (``lax.cond``) when a tile's
spans overflow the window.  The port's gather walks each probe's span
directly, so it has no window, no fallback and no host sync: the scan
stays on the device from the routed rows to the merged answers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bucket_search import (bucket_gather_cuda,
                                               bucket_search_cuda)
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.lsh_hash import lsh_hash_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.kernels.types import QueryBatch, StoreView

_M32 = 0xFFFFFFFF


def _slice(store: StoreView, lo: int, hi: int) -> StoreView:
    """Row slice [lo, hi) of a (S, N, ...) StoreView, as views.  The
    reference pads such a slice to whole tiles (a copy of the region on
    every query); the kernels here mask the ragged edge themselves and
    reach each shard through its stride, so nothing is copied."""
    sl = lambda a: a[:, lo:hi]
    return StoreView(points=sl(store.points), psq=sl(store.psq),
                     buckets=sl(store.buckets), gid=sl(store.gid),
                     valid=sl(store.valid), table=sl(store.table))


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def csr_probe_spans(query: QueryBatch, store: StoreView
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-probe CSR spans: (start, end) (S, R, L) int32 row ranges of
    each probed bucket inside the sorted region [0, n_sorted).

    A branchless lower-bound binary search over the store's lex (table,
    packed hi, packed lo) order -- the words compared as uint32, never as
    their int32 bit patterns -- locates ``start``; the end is read from
    the store's ``bucket_end`` column at ``start``.  Probes that are off,
    or whose bucket is absent, get the empty span start == end.
    """
    S, R, L = query.probe.shape
    ns = store.n_sorted
    dev = query.q.device
    if ns == 0:
        z = torch.zeros((S, R, L), dtype=torch.int32, device=dev)
        return z, z
    st = store.table[:, :ns].to(torch.int64)
    sh = _u32(store.buckets[:, :ns, 0])
    sl = _u32(store.buckets[:, :ns, 1])
    qb = query.buckets.reshape(S, R, L, 2)
    qh, ql = _u32(qb[..., 0]), _u32(qb[..., 1])
    qt = query.table.to(torch.int64)[:, :, None].expand(S, R, L)

    def at(col, idx):
        return torch.gather(col, 1, idx.reshape(S, -1)).reshape(S, R, L)

    lo = torch.zeros((S, R, L), dtype=torch.int64, device=dev)
    step = 1 << (ns - 1).bit_length()
    while step:
        cand = lo + step
        i = torch.clamp(cand - 1, 0, ns - 1)
        t, h, l = at(st, i), at(sh, i), at(sl, i)
        less = (t < qt) | ((t == qt) & ((h < qh) | ((h == qh) & (l < ql))))
        lo = torch.where((cand <= ns) & less, cand, lo)
        step //= 2
    i = torch.clamp(lo, 0, ns - 1)
    matched = ((lo < ns) & (at(st, i) == qt) & (at(sh, i) == qh)
               & (at(sl, i) == ql))
    end = torch.where(matched,
                      at(store.bucket_end[:, :ns].to(torch.int64), i), lo)
    on = query.probe > 0
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return (torch.where(on, lo, zero).to(torch.int32),
            torch.where(on, end, zero).to(torch.int32))


def _csr_search(query: QueryBatch, store: StoreView, cr2: float, *, L: int,
                k: int):
    """CSR path: span lookup -> probe expansion sorted by span start ->
    gather over the sorted region + full scan of the tail, exactly
    merged."""
    S, R, _ = query.q.shape
    ns, cap = store.n_sorted, store.points.shape[1]
    dev = query.q.device

    start, end = csr_probe_spans(query, store)
    # Duplicate probes of one row (two perturbations packing to the same
    # bucket) must count each store row once, as the full scan's OR-mask
    # does: identical non-empty spans are identical buckets, so blank
    # every repeat after the first.
    if L > 1:
        dup = torch.zeros((S, R, L), dtype=torch.bool, device=dev)
        for l in range(1, L):
            same = ((start[..., l:l + 1] == start[..., :l])
                    & (end[..., l:l + 1] == end[..., :l]))
            dup[..., l] = same.any(dim=-1)
        dup &= end > start
        start = torch.where(dup, 0, start)
        end = torch.where(dup, 0, end)
    # expanded (row, probe) pairs sorted by span start, dead probes last,
    # so neighbouring threads of the gather walk neighbouring buckets
    sflat, eflat = start.reshape(S, -1), end.reshape(S, -1)
    E = R * L
    live = eflat > sflat
    order = torch.argsort(torch.where(live, sflat, ns), dim=-1, stable=True)
    rowid = order // L
    eq = torch.gather(query.q, 1,
                      rowid[..., None].expand(S, E, query.q.shape[-1]))
    sv = _slice(store, 0, ns)
    gd, gg, gc = bucket_gather_cuda(
        eq, torch.gather(query.qsq, 1, rowid), torch.gather(sflat, 1, order),
        torch.gather(eflat, 1, order), sv.points, sv.psq, sv.gid, sv.valid,
        cr2, K=k)
    # unsort back to (row, probe) order; one row's probes cover disjoint
    # buckets, so an exact lex merge of their lists is the row's answer
    idx = order[..., None].expand(S, E, k)
    cand_d = torch.empty_like(gd).scatter_(1, idx, gd).reshape(S, R, L * k)
    cand_g = torch.empty_like(gg).scatter_(1, idx, gg).reshape(S, R, L * k)
    cnt = torch.empty_like(gc).scatter_(1, order, gc).reshape(
        S, R, L).sum(dim=-1, dtype=torch.int32)
    if cap > ns:                                       # unsorted insert tail
        td, tg, tc = bucket_search_cuda(query=query,
                                        store=_slice(store, ns, cap),
                                        cr2=cr2, L=L, K=k)
        cand_d = torch.cat([cand_d, td], dim=-1)
        cand_g = torch.cat([cand_g, tg], dim=-1)
        cnt = cnt + tc
    # the k best (dist^2, gid) pairs of each row in exact lex order
    top = ref.merge_lex_topk(ref.lex_key(cand_d, cand_g), k)
    return (*ref.lex_unkey(top), cnt)


def bucket_search(*, query: QueryBatch, store: StoreView, cr2: float,
                  L: int, k: int = 1, force_full_scan: bool = False):
    """Masked top-K NN scan over each shard's store.

    Tensors carry a leading shard axis (S, R, ...) / (S, N, ...); a
    single shard may also be passed without it.  Returns (topd (S, R, k),
    topg (S, R, k), cnt (S, R)) in (dist^2, gid) lex order, padded with
    (F32_MAX, IMAX) past the available hits.

    A bucket-sorted store (``n_sorted > 0``) takes the CSR path, bitwise
    equal to the full scan; ``force_full_scan=True`` pins the full-scan
    kernel (the comparison baseline).  On CUDA tensors the kernels run,
    on CPU tensors their plain versions.
    """
    if query.q.dim() == 2:
        one = lambda t: None if t is None else t.unsqueeze(0)
        q1 = QueryBatch(**{f: one(v) for f, v in vars(query).items()})
        s1 = StoreView(**{f: v if f == "n_sorted" else one(v)
                          for f, v in vars(store).items()})
        out = bucket_search(query=q1, store=s1, cr2=cr2, L=L, k=k,
                            force_full_scan=force_full_scan)
        return tuple(t[0] for t in out)
    if store.n_sorted > 0 and not force_full_scan:
        return _csr_search(query, store, cr2, L=L, k=k)
    return bucket_search_cuda(query=query, store=store, cr2=cr2, L=L, K=k)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """Attention with its gradient, the reference's custom VJP
    (``models/flash_xla.py``): the forward kernel with its log-sum-exp,
    saving (q, k, v, out, lse) and nothing score-sized, and the gradient
    kernel, which recomputes the scores blockwise (both plain versions
    on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, o, lse, do.to(q.dtype), causal=ctx.causal,
            scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q (B, H, Sq, dh) against k (B, Hkv, Sk, dh) and v (B, Hkv, Sk,
    dv), dv <= dh -> (B, H, Sq, dv): the flash kernel on CUDA tensors
    (v narrower than dh zero-padded for it), its plain version on CPU
    tensors.  The reference pads Sq and Sk to its 128-row tiles here; the
    kernel takes any length, so nothing is padded.  With a gradient required it runs
    as an autograd function whose backward is the gradient kernel (its
    plain version on the CPU)."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale)


class _SSDScan(torch.autograd.Function):
    """The scan with its gradient: ``ssd_scan_cuda`` forward and
    ``ssd_scan_bwd_cuda`` backward (the kernels on CUDA tensors, both
    plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, a_log, b, c, dt):
        ctx.save_for_backward(x, a_log, b, c, dt)
        return ssd_scan_cuda(x, a_log, b, c, dt)

    @staticmethod
    def backward(ctx, dy):
        x, a_log, b, c, dt = ctx.saved_tensors
        dx, db, dc, ddt, da_log = ssd_scan_bwd_cuda(x, a_log, b, c, dt,
                                                    dy.to(x.dtype))
        return dx, da_log, db, dc, ddt


def ssd_scan(x, a_log, b, c, dt):
    """Mamba-2 SSD scan, x (B, S, H, P), b, c (B, S, G, N), dt (B, S, H),
    a_log (H,) -> y (B, S, H, P): the kernel on CUDA tensors, its plain
    version on CPU tensors.  The reference repeats B and C to every head
    and pads S to its 128-step chunks here; the kernel reads each head's
    group and masks the last chunk, so nothing is copied.  With a gradient
    required it runs as an autograd function whose backward is the
    gradient kernel (its plain version on the CPU)."""
    if _needs_grad(x, a_log, b, c, dt):
        return _SSDScan.apply(x, a_log, b, c, dt)
    return ssd_scan_cuda(x, a_log, b, c, dt)


def lsh_hash(x, a, b, *, w: float):
    """floor((x @ a + b) / w) -> int32 (n, K) in hash_h's arithmetic
    (products rounded once, ``tree_sum``'s order, a division by w): the
    kernel on CUDA tensors, its plain version on CPU tensors.  The
    reference pads n to 128 rows and K to 128 lanes here; the kernel
    takes any n and K."""
    return lsh_hash_cuda(x, a, b, w=w)
