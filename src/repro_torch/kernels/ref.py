"""Plain PyTorch versions of the port's kernels.

Each function computes exactly what its CUDA kernel computes, with
ordinary tensor operations: the CPU tests run them, and on the card they
are the yardstick each kernel is held against.  The full scan walks the
point axis in chunks and the gather walks span offsets, each carrying a
running top-K, so both also run at the full store size on the card (the
unchunked (R, L, N) match tensor would need gigabytes per shard).  The
SSD scan's plain version is the reference's sequential recurrence, the
function the chunked kernel computes in another order of rounding; its
gradient's plain version is the reverse recurrence over the stored
states.

Top-K selection is exact in (dist^2, gid) lex order: a non-negative
float32 orders like its bit pattern, so ``bits(d2) << 32 | gid`` is one
int64 key whose order is the lex order, and ``topk`` on it is exact,
ties included.  Every tensor may carry leading batch (shard) dimensions.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.types import tree_sum

F32_MAX = float(torch.finfo(torch.float32).max)
IMAX = 2 ** 31 - 1
_M32 = 0xFFFFFFFF


def lex_key(d2: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """(dist^2 >= 0, gid >= 0) -> int64 keys ordered like (dist^2, gid)."""
    hi = d2.contiguous().view(torch.int32).to(torch.int64)
    return (hi << 32) | gid.to(torch.int64)


def lex_unkey(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    d2 = (key >> 32).to(torch.int32).view(torch.float32)
    return d2, (key & _M32).to(torch.int32)


def sentinel_key(device) -> torch.Tensor:
    return lex_key(torch.tensor(F32_MAX, device=device),
                   torch.tensor(IMAX, device=device))


def merge_lex_topk(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest keys of each row, ascending (sentinel-padded)."""
    if keys.shape[-1] < k:
        pad = sentinel_key(keys.device).expand(
            keys.shape[:-1] + (k - keys.shape[-1],))
        keys = torch.cat([keys, pad], dim=-1)
    return torch.topk(keys, k, dim=-1, largest=False, sorted=True).values


def pair_dots(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Dot of every row of q (..., R, d) with every point of p (..., N, d)
    -> (..., R, N), summed in ascending order over d, one rounded multiply
    and one rounded add per term.  ``row_dots`` gives the same value for
    the same pair, so the two plain versions agree bit for bit, on the
    CPU and on the card; a library matmul would pick its own order."""
    acc = q[..., :, None, 0] * p[..., None, :, 0]
    for k in range(1, q.shape[-1]):
        acc = acc + q[..., :, None, k] * p[..., None, :, k]
    return acc


def row_dots(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Dot of each row of q (..., E, d) with the same row of p, in the
    order of ``pair_dots``."""
    acc = q[..., 0] * p[..., 0]
    for k in range(1, q.shape[-1]):
        acc = acc + q[..., k] * p[..., k]
    return acc


def _chunk(n_rows: int, n_points: int) -> int:
    """Point chunk keeping each (rows, chunk) temporary near 2**25."""
    return max(128, min(n_points, (1 << 25) // max(n_rows, 1)))


def bucket_search_ref(*, query, store, cr2: float, L: int, K: int = 1):
    """Masked top-K full scan (plain version of ``bucket_search_cuda``).

    A (row, point) pair is a hit when the point's packed bucket equals
    one of the row's probed buckets, the point is valid and of the row's
    table, and dist^2 = |q|^2 + |p|^2 - 2 q.p (clamped at 0) <= cr2.
    Returns (topd (..., R, K) f32, topg (..., R, K) int32, cnt (..., R)
    int32): the K best hits in (dist^2, gid) lex order, padded with
    (F32_MAX, IMAX), and the number of hits.
    """
    q, p = query.q, store.points
    R, N = q.shape[-2], p.shape[-2]
    batch = q.shape[:-2]
    qb = query.buckets.reshape(batch + (R, L, 2))
    on = query.probe > 0
    best = sentinel_key(q.device).expand(batch + (R, K)).clone()
    cnt = torch.zeros(batch + (R,), dtype=torch.int32, device=q.device)
    step = _chunk(R * math.prod(batch), N)
    for c0 in range(0, N, step):
        c1 = min(N, c0 + step)
        pc = p[..., c0:c1, :]
        d2 = (query.qsq.unsqueeze(-1) + store.psq[..., None, c0:c1]
              - 2.0 * pair_dots(q, pc))
        d2 = torch.clamp_min(d2, 0.0)
        pb = store.buckets[..., c0:c1, :]
        match = torch.zeros(d2.shape, dtype=torch.bool, device=q.device)
        for l in range(L):
            match |= ((qb[..., l, 0, None] == pb[..., None, :, 0])
                      & (qb[..., l, 1, None] == pb[..., None, :, 1])
                      & on[..., l, None])
        match &= store.valid[..., None, c0:c1] > 0
        match &= query.table.unsqueeze(-1) == store.table[..., None, c0:c1]
        hit = match & (d2 <= cr2)
        cnt += hit.sum(dim=-1, dtype=torch.int32)
        keys = torch.where(hit, lex_key(d2, store.gid[..., None, c0:c1]),
                           sentinel_key(q.device))
        best = merge_lex_topk(torch.cat([best, keys], dim=-1), K)
    topd, topg = lex_unkey(best)
    return topd, topg, cnt


def bucket_gather_ref(q, qsq, start, end, p, psq, gid, pvalid,
                      cr2: float, *, K: int):
    """CSR gather (plain version of ``bucket_gather_cuda``).

    Expanded row e (one (query row, probe) pair) hits the points of the
    sorted region whose row index lies in its span [start[e], end[e]),
    that are valid and within dist^2 <= cr2.  q (..., E, d); p (..., N, d).
    Returns (topd, topg, cnt) as ``bucket_search_ref``.
    """
    E, d = q.shape[-2], q.shape[-1]
    batch = q.shape[:-2]
    best = sentinel_key(q.device).expand(batch + (E, K)).clone()
    cnt = torch.zeros(batch + (E,), dtype=torch.int32, device=q.device)
    span = (end - start).to(torch.int64)
    # host-sync: ref-gather-longest
    longest = int(span.max()) if span.numel() else 0
    for o in range(longest):
        inside = o < span
        c = torch.where(inside, start.to(torch.int64) + o, 0)
        pc = torch.gather(p, -2, c.unsqueeze(-1).expand(batch + (E, d)))
        take = lambda a: torch.gather(a, -1, c)
        d2 = qsq + take(psq) - 2.0 * row_dots(q, pc)
        d2 = torch.clamp_min(d2, 0.0)
        hit = inside & (take(pvalid) > 0) & (d2 <= cr2)
        cnt += hit.to(torch.int32)
        keys = torch.where(hit, lex_key(d2, take(gid)),
                           sentinel_key(q.device))
        best = merge_lex_topk(torch.cat([best, keys.unsqueeze(-1)], dim=-1),
                              K)
    topd, topg = lex_unkey(best)
    return topd, topg, cnt


def _scores(q, k, causal: bool, scale: float):
    """(q * scale in float32, k repeated to every query head in float32,
    the scores (q * scale) . k (B, H, Sq, Sk) masked to -1e30 at cols >
    rows (top-left) when causal)."""
    Sq = q.shape[2]
    qs = q.float() * scale
    kq = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.matmul(qs, kq.transpose(-1, -2))
    if causal:
        keep = torch.ones((Sq, k.shape[2]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    return qs, kq, s


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                  return_lse: bool = False):
    """Exact softmax attention (plain version of ``flash_attention_cuda``).

    q (B, H, Sq, dh), k (B, Hkv, Sk, dh), v (B, Hkv, Sk, dv), dv <= dh;
    query head h reads kv head h // (H // Hkv).  Scores (q * scale) . k
    in float32, the causal mask rows >= cols (top-left, as the kernel has
    it), float32 weights and sums; the output (B, H, Sq, dv) in q's
    dtype.  With ``return_lse`` also each row's
    log-sum-exp of its scores (B, H, Sq) float32, the reference's
    ``m + log(l)`` (``models/flash_xla.py`` ``_fwd``).
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    group = q.shape[1] // k.shape[1]
    _, _, s = _scores(q, k, causal, scale)
    vq = v.float().repeat_interleave(group, dim=1)
    o = torch.matmul(torch.softmax(s, dim=-1), vq).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def flash_attention_bwd_ref(q, k, v, o, lse, dout, *, causal: bool = True,
                            scale: float | None = None):
    """The gradient of attention (plain version of
    ``flash_attention_bwd_cuda``): the reference's ``_bwd_vjp``
    (``models/flash_xla.py``) in PyTorch, with its rounding points.

    delta = rowsum(dO O); P = exp(s - lse) rounded to v's dtype; dS = P
    (dP - delta) rounded to k's dtype; dq, dk and dv summed in float32,
    the scale on dq and inside q for dk, dk and dv summed over each kv
    head's group of query heads; the causal mask top-left.  Returns (dq,
    dk, dv) in the inputs' dtypes; v, o and dout may be narrower than q
    and k (dv <= dh).
    """
    B, H, _, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    qs, kq, s = _scores(q, k, causal, scale)
    vq = v.float().repeat_interleave(H // Hkv, dim=1)
    do = dout.float()
    delta = torch.sum(do * o.float(), dim=-1, keepdim=True)
    p = torch.exp(s - lse[..., None]).to(v.dtype).float()
    dp = torch.matmul(do, vq.transpose(-1, -2))
    ds = (p * (dp - delta)).to(k.dtype).float()
    per_group = lambda t: t.reshape(B, Hkv, H // Hkv, Sk,
                                    t.shape[-1]).sum(dim=2)
    dv = per_group(torch.matmul(p.transpose(-1, -2), do))
    dk = per_group(torch.matmul(ds.transpose(-1, -2), qs))
    dq = torch.matmul(ds, kq) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_blocked_ref(q, k, v, o, lse, dout, *,
                                    causal: bool = True,
                                    scale: float | None = None,
                                    key_rows: int = 64, query_tile: int = 64,
                                    dq_rows: int = 128,
                                    dq_key_tile: int | None = None):
    """The flash gradient in the tiling and summation order of the
    "tensor_core" design of ``csrc/flash_attention_bwd.cu``, in plain
    PyTorch (the same function as ``flash_attention_bwd_ref``; used by
    tests, not on the main path).

    dK, dV: per tile of ``key_rows`` keys of each kv head, a float32 sum
    over the group's query heads in order and, for each, over its tiles of
    ``query_tile`` queries in order (causal: from the tile holding the
    first key on) of P^T dO and dS^T q, S^T and dP^T recomputed for each
    pair of tiles; dk times the scale at the end.  dQ: per tile of
    ``dq_rows`` query rows, a sum over tiles of ``dq_key_tile`` keys in
    order (64 up to dh = 128, 32 above; causal: up to the tile's last
    row) of dS k, times the scale at the end.  P and dS are rounded to
    the inputs' dtype, as the plain version and the kernel round them
    (bf16 inputs: the kernel's rounding points).  Returns (dq, dk, dv) in
    the inputs' dtypes."""
    B, H, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if dq_key_tile is None:
        dq_key_tile = 64 if dh <= 128 else 32
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = torch.sum(dout.float() * o.float(), dim=-1)
    lse = lse.float()
    idx = lambda *a: torch.arange(*a, device=q.device)

    def grads(s, dp, live, lse_r, delta_r):
        """P and dS from the unscaled scores s and dP (0 where not
        live)."""
        p = torch.exp(s * scale - lse_r)
        if causal:
            p = torch.where(live, p, torch.zeros_like(p))
        p = p.to(v.dtype).float()
        return p, (p * (dp - delta_r)).to(k.dtype).float()

    dk = torch.zeros((B, Hkv, Sk, dh), device=q.device)
    dv = torch.zeros_like(dk)
    for kt0 in range(0, Sk, key_rows):
        keys = idx(kt0, min(Sk, kt0 + key_rows))
        ks, vs = kf[:, :, keys], vf[:, :, keys]
        acc_k = torch.zeros_like(ks)
        acc_v = torch.zeros_like(vs)
        q_first = kt0 // query_tile * query_tile if causal else 0
        for hi in range(group):
            heads = idx(Hkv) * group + hi   # kv head j's hi-th query head
            for qt0 in range(q_first, Sq, query_tile):
                qry = idx(qt0, min(Sq, qt0 + query_tile))
                qs = qf[:, heads][:, :, qry]
                dos = dof[:, heads][:, :, qry]
                # transposed: rows are keys, columns queries
                pt, dst = grads(ks @ qs.transpose(-1, -2),
                                vs @ dos.transpose(-1, -2),
                                keys[:, None] <= qry[None, :],
                                lse[:, heads][:, :, None, qry],
                                delta[:, heads][:, :, None, qry])
                acc_v = acc_v + pt @ dos
                acc_k = acc_k + dst @ qs
        dk[:, :, keys] = acc_k * scale
        dv[:, :, keys] = acc_v

    dq = torch.zeros((B, H, Sq, dh), device=q.device)
    kv_of = idx(H) // group
    for r0 in range(0, Sq, dq_rows):
        rows = idx(r0, min(Sq, r0 + dq_rows))
        qs, dos = qf[:, :, rows], dof[:, :, rows]
        acc = torch.zeros_like(qs)
        n_keys = min(Sk, r0 + dq_rows) if causal else Sk
        for kt0 in range(0, n_keys, dq_key_tile):
            cols = idx(kt0, min(Sk, kt0 + dq_key_tile))
            ks = kf[:, kv_of][:, :, cols]
            vs = vf[:, kv_of][:, :, cols]
            _, ds = grads(qs @ ks.transpose(-1, -2),
                          dos @ vs.transpose(-1, -2),
                          cols[None, :] <= rows[:, None],
                          lse[:, :, rows, None], delta[:, :, rows, None])
            acc = acc + ds @ ks
        dq[:, :, rows] = acc * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_scan_ref(x, a_log, b, c, dt):
    """Mamba-2 SSD scan, sequential (plain version of ``ssd_scan_cuda``).

    x (B, S, H, P); a_log (H,) float32, the log of the positive decay
    rate; b, c (B, S, G, N), head h reading group h // (H // G); dt
    (B, S, H) float32.  Step by step, in float32:
        state_t = exp(a dt_t) state_{t-1} + (x_t dt_t) b_t^T,  a = -exp(a_log)
        y_t     = state_t . c_t
    and y (B, S, H, P) in x's dtype.  The groups are broadcast one step
    at a time: the reference repeats B and C to every head up front.
    """
    B, S, H, P = x.shape
    rep = H // b.shape[2]
    a = -torch.exp(a_log.float())
    decay = torch.exp(a * dt.float())                     # (B, S, H)
    state = torch.zeros((B, H, P, b.shape[3]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(S):
        bt = b[:, t].float().repeat_interleave(rep, dim=1)  # (B, H, N)
        ct = c[:, t].float().repeat_interleave(rep, dim=1)
        xdt = x[:, t].float() * dt[:, t, :, None].float()   # (B, H, P)
        state = (state * decay[:, t, :, None, None]
                 + xdt[..., :, None] * bt[..., None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ct))
    if not ys:
        return torch.empty_like(x)
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_scan_bwd_ref(x, a_log, b, c, dt, dy):
    """Gradients of ``ssd_scan_ref`` (plain version of
    ``ssd_scan_bwd_cuda``): the forward states step by step, then the
    reverse recurrence, in float32, with a = -exp(a_log):
        dh_t  = dy_t c_t^T + exp(a dt_{t+1}) dh_{t+1}
        dx_t  = dt_t dh_t b_t
        db_t  = dt_t dh_t^T x_t,  dc_t = h_t^T dy_t   (summed over the
                                                      heads of a group)
        ddt_t = x_t . (dh_t b_t) + a exp(a dt_t) <dh_t, h_{t-1}>
        da_log = a sum_{batch, t} dt_t exp(a dt_t) <dh_t, h_{t-1}>
    Returns (dx, db, dc, ddt, da_log): dx, db, dc in x's dtype, ddt and
    da_log float32.  Keeps all S states: (B, H, P, N) floats a step."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    a = -torch.exp(a_log.float())
    dtf = dt.float()
    decay = torch.exp(a * dtf)                            # (B, S, H)
    xf, dyf = x.float(), dy.float()
    bq = b.float().repeat_interleave(rep, dim=2)          # (B, S, H, N)
    cq = c.float().repeat_interleave(rep, dim=2)
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    states = []
    for t in range(S):
        xdt = xf[:, t] * dtf[:, t, :, None]
        state = (state * decay[:, t, :, None, None]
                 + xdt[..., :, None] * bq[:, t, :, None, :])
        states.append(state)
    dx = torch.zeros((B, S, H, P), dtype=torch.float32, device=x.device)
    dbh = torch.zeros((B, S, H, N), dtype=torch.float32, device=x.device)
    dch = torch.zeros_like(dbh)
    ddt = torch.zeros((B, S, H), dtype=torch.float32, device=x.device)
    dlam = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    dh = torch.zeros_like(state)
    for t in reversed(range(S)):
        if t + 1 < S:
            dh = dh * decay[:, t + 1, :, None, None]
        dh = dh + dyf[:, t, :, :, None] * cq[:, t, :, None, :]
        u = torch.einsum("bhpn,bhn->bhp", dh, bq[:, t])
        dx[:, t] = dtf[:, t, :, None] * u
        dbh[:, t] = dtf[:, t, :, None] * torch.einsum("bhpn,bhp->bhn", dh,
                                                      xf[:, t])
        dch[:, t] = torch.einsum("bhpn,bhp->bhn", states[t], dyf[:, t])
        g = ((dh * states[t - 1]).sum(dim=(-2, -1)) if t > 0
             else torch.zeros_like(dlam))
        ddt[:, t] = (xf[:, t] * u).sum(-1) + a * decay[:, t] * g
        dlam = dlam + dtf[:, t] * decay[:, t] * g
    db = dbh.view(B, S, G, rep, N).sum(3)
    dc = dch.view(B, S, G, rep, N).sum(3)
    return (dx.to(x.dtype), db.to(b.dtype), dc.to(c.dtype), ddt,
            a * dlam.sum(0))


def ssd_scan_bwd_chunked_ref(x, a_log, b, c, dt, dy, *, chunk: int = 64,
                             bf16_operands: bool = False):
    """The SSD gradient in the chunked decomposition of the "tensor_core"
    design of ``csrc/ssd_scan_bwd.cu``, in plain PyTorch (the same function
    as ``ssd_scan_bwd_ref``; used by tests, not on the main path).

    Per (batch, head, chunk of Q steps), with lam_t = a dt_t, cum_t its
    running sum in the chunk, total = cum_{Q-1}, L_tj = exp(cum_t - cum_j)
    for j <= t (else 0) and eT_j = exp(total - cum_j):
      1. chunk states s = sum_t eT_t dt_t x_t b_t^T and r = sum_t
         exp(cum_t) dy_t c_t^T;
      2. state passing: h0 (the state entering each chunk) forward, h0' =
         exp(total) h0 + s; G (the gradient into the state leaving it)
         backward, G' = exp(total) G + r;
      3. per chunk, from the scores CB_tj = c_t . b_j and DX_tj = dy_t .
         x_j, M1 = CB L, M2 = DX L dt_j and T = CB L dt_j DX:
           u  = M1^T dy + eT (b G^T),       dx = dt u,  ddt = x . u + ...
           dc = exp(cum) (dy h0) + M2 b,    db = M2^T c + eT dt (x G)
         and dcum_t = rowsum(T)_t - colsum(T)_t + exp(cum_t) dy_t^T h0 c_t
         - v_t, v_t = eT_t dt_t x_t^T G b_t, with exp(total) <G, h0> +
         sum_t v_t added at t = Q - 1; dlam is its reverse running sum in
         the chunk, ddt = x . u + a dlam and da_log = a sum dt dlam;
      4. db and dc summed over a group's heads in head order.
    Steps past S are identity steps (dt = 0, zero inputs).
    ``bf16_operands`` rounds to bf16 where the kernel does: every float32
    product operand (w x and exp(cum) dy of step 1, h0, G, M1 and M2)
    enters as a hi + lo pair of bf16 (two products); x, b, c and dy are
    the model's bf16 already, and the scores, T and every sum stay
    float32.  Returns (dx, db, dc, ddt, da_log) as ``ssd_scan_bwd_ref``
    does."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep, Q = H // G, chunk
    nc = -(-S // Q)
    pad = nc * Q - S

    def rnd(t):
        return t.to(torch.bfloat16).float() if bf16_operands else t

    def split(t):
        hi = rnd(t)
        return (hi, rnd(t - hi)) if bf16_operands else (t, None)

    def two(eq, pair, other):     # the pair's products, hi then lo
        hi, lo = pair
        out = torch.einsum(eq, hi, other)
        return out if lo is None else out + torch.einsum(eq, lo, other)

    def chunks(t, heads):         # (B, S, X, W) -> (B, H, nc, Q, W)
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        t = t.view(B, nc, Q, t.shape[2], t.shape[3]).permute(0, 3, 1, 2, 4)
        return t.repeat_interleave(heads, dim=1)

    xq, dyq = chunks(x, 1), chunks(dy, 1)
    bq, cq = chunks(b, rep), chunks(c, rep)
    dtq = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    dtq = dtq.view(B, nc, Q, H).permute(0, 3, 1, 2)        # (B, H, nc, Q)
    a = -torch.exp(a_log.float())
    cum = torch.cumsum(a[:, None, None] * dtq, dim=-1)
    total = cum[..., -1]
    eT = torch.exp(torch.clamp(total[..., None] - cum, max=0.0))
    ecum = torch.exp(cum)

    # 1. chunk states
    s = two("bhctp,bhctn->bhcpn", split((eT * dtq)[..., None] * xq), bq)
    r = two("bhctp,bhctn->bhcpn", split(ecum[..., None] * dyq), cq)
    # 2. state passing, forward and backward over the chunks
    h0, gq = torch.empty_like(s), torch.empty_like(r)
    cur = torch.zeros_like(s[:, :, 0])
    for k in range(nc):
        h0[:, :, k] = cur
        cur = torch.exp(total[:, :, k])[..., None, None] * cur + s[:, :, k]
    cur = torch.zeros_like(cur)
    for k in reversed(range(nc)):
        gq[:, :, k] = cur
        cur = torch.exp(total[:, :, k])[..., None, None] * cur + r[:, :, k]
    # 3. the chunk's gradients
    idx = torch.arange(Q, device=x.device)
    low = idx[:, None] >= idx[None, :]
    gap = torch.clamp(cum[..., :, None] - cum[..., None, :], max=0.0)
    dec = torch.where(low, torch.exp(gap), torch.zeros_like(gap))
    cb = torch.einsum("bhctn,bhcjn->bhctj", cq, bq)
    dxs = torch.einsum("bhctp,bhcjp->bhctj", dyq, xq)
    m1 = cb * dec
    m2 = dxs * dec * dtq[..., None, :]
    pp = m1 * dxs                 # T without its dt_j: float32, no product
    tt = pp * dtq[..., None, :]
    m1, m2 = split(m1), split(m2)
    h0p, gp = split(h0), split(gq)
    dyh0 = two("bhcpn,bhctp->bhctn", h0p, dyq)
    dc1 = ecum * (dyh0 * cq).sum(-1)
    dch = ecum[..., None] * dyh0 + two("bhctj,bhcjn->bhctn", m2, bq)
    bgt = two("bhcpn,bhcjn->bhcjp", gp, bq)
    xbg = eT * (bgt * xq).sum(-1)
    v = dtq * xbg
    u = eT[..., None] * bgt + two("bhctj,bhctp->bhcjp", m1, dyq)
    xg = two("bhcpn,bhcjp->bhcjn", gp, xq)
    dbh = ((eT * dtq)[..., None] * xg
           + two("bhctj,bhctn->bhcjn", m2, cq))
    dcum = tt.sum(-1) - tt.sum(-2) + dc1 - v
    dcum[..., -1] += torch.exp(total) * (gq * h0).sum((-2, -1)) + v.sum(-1)
    dlam = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = pp.sum(-2) + xbg + a[:, None, None] * dlam
    da_log = a * (dtq * dlam).sum((0, 2, 3))

    def steps(t):                 # (B, H, nc, Q, ...) -> (B, S, H, ...)
        t = t.movedim(1, 3).reshape(B, nc * Q, H, *t.shape[4:])
        return t[:, :S]

    def per_group(t):             # head order within each group
        t = steps(t).view(B, S, G, rep, N)
        out = t[:, :, :, 0]
        for j in range(1, rep):
            out = out + t[:, :, :, j]
        return out

    dx = steps(dtq[..., None] * u)
    return (dx.to(x.dtype), per_group(dbh).to(b.dtype),
            per_group(dch).to(c.dtype), steps(ddt).contiguous(), da_log)


def tree_project(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x (..., n, c) times a (..., c, k) -> (..., n, k), float32: every
    product rounded once, then summed over c by ``tree_sum``'s pairwise
    order.  A library matmul picks its summation order by shape and
    device, and a flipped floor moves a point to another bucket: the
    insert, the query dispatch and the receive-side re-hash must agree
    exactly, on the CPU and on the card.  The (n, c, k) products are
    formed a slab of rows at a time."""
    n, c, k = x.shape[-2], x.shape[-1], a.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-2], a.shape[:-2])
    step = max(1, (1 << 24) // max(1, c * k * math.prod(batch)))
    parts = [tree_sum(x[..., i:i + step, :, None] * a[..., None, :, :], -2)
             for i in range(0, n, step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def lsh_hash_ref(x, a, b, *, w: float, table=None, floor: bool = True):
    """floor((x a + b) / w) as int32 (plain version of ``lsh_hash_cuda``,
    same shapes and table modes): x converted to float32 exactly, the
    projection by ``tree_project``, then ``+ b`` and an IEEE division by
    w rounded to float32; ``floor=False`` returns the quotient."""
    x = x.to(torch.float32)
    d, K = a.shape[-2:]
    lead = x.shape[:-1]
    if a.dim() == 2:
        proj = tree_project(x.reshape(-1, d), a) + b
    elif table is not None:
        t = table.to(torch.int64)
        proj = (tree_project(x.reshape(*t.shape, -1, d), a[t])
                + b[t].unsqueeze(-2))
    else:
        proj = (tree_project(x.reshape(a.shape[0], -1, d), a)
                + b.unsqueeze(-2))
    q = proj.reshape(*lead, K) / torch.tensor(w, dtype=torch.float32)
    return torch.floor(q).to(torch.int32) if floor else q
