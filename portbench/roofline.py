"""The yardstick of the kernels' rooflines: the H100's published peaks,
``bound_of``, and the work each kernel launch's problem needs.

Frozen copies, each rewritten to stand alone:

* the peaks and ``bound_of``: ``src/repro_torch/launch/hlo_analysis.py``
  (lines 37-41 and 92-97);
* the bucket kernels' work: ``chip_smoke.py:1747-1779``
  (``matched_pairs``), ``:1797-1816`` (the full scan) and ``:1850-1870``
  (the CSR gather).  The work is what the launch's inputs need -- the
  matched pairs' dots, each matched slot's row read once, the live rows,
  the outputs -- never the kernel's grid, so a redesigned kernel is held
  to the same count;
* the hash: a launch hashes ``rows`` rows of d values against K columns,
  2 d K operations a row, and reads its rows, its parameters and any
  table ids once and writes K int32 words a row.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM5, published peaks (per card)
PEAK_F32_FLOPS = 67e12       # float32, CUDA cores
HBM_BW = 3.35e12             # bytes/s, HBM3


def bound_of(flops: float, peak_flops: float, nbytes: float) -> float:
    """The least time in seconds the card could take: the larger of the
    operations over the peak rate and the bytes over the memory rate."""
    return max(flops / peak_flops, nbytes / HBM_BW)


def hash_bound(call: dict) -> float:
    """One ``lsh_hash_cuda`` launch: ``call`` holds rows, d, K, the
    element size of x, the parameters' bytes and whether rows carry table
    ids."""
    rows, d, K = call["rows"], call["d"], call["K"]
    nbytes = (rows * d * call["x_bytes"] + call["param_bytes"]
              + rows * K * 4 + (rows * 4 if call["table"] else 0))
    return bound_of(2.0 * rows * d * K, PEAK_F32_FLOPS, nbytes)


def gather_bound(call: dict) -> float:
    """One CSR gather launch over the sorted region: every expanded row's
    span, the live rows' queries and norms, every spanned slot's liveness
    and every valid one's point row, psq and gid (each once, however many
    rows span it), the outputs; the valid pairs' dots."""
    start, end, pvalid = call["start"], call["end"], call["pvalid"]
    S, E = start.shape
    d, K = call["d"], call["K"]
    span = (end - start).clamp_min(0).to(torch.int64)
    live_e = int((span > 0).sum())
    pairs = spanned = slots = 0
    for s in range(S):
        n = span[s]
        first = torch.repeat_interleave(start[s].to(torch.int64), n)
        off = torch.arange(int(n.sum()), device=n.device) \
            - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        ok = pvalid[s] > 0
        pairs += int(ok[first + off].sum())
        hit = torch.zeros_like(ok)
        hit[first + off] = True
        spanned += int(hit.sum())
        slots += int((hit & ok).sum())
    out_bytes = S * E * (K * 8 + 4)
    return bound_of(2.0 * pairs * d, PEAK_F32_FLOPS,
                    S * E * 8 + live_e * (d * 4 + 4) + spanned * 4
                    + slots * (d * 4 + 8) + out_bytes)


def _matched_pairs(call: dict):
    """(row, slot) pairs of a full scan's inputs that can hit -- the slot
    is valid and its (table, bucket) one the row probes (a row probing a
    bucket twice counts each slot once) -- and the distinct slots among
    them."""
    u32 = lambda t: t.to(torch.int64) & 0xFFFFFFFF
    probe, qbk, qtab = call["probe"], call["buckets"], call["table"]
    valid, stab, sbk = call["valid"], call["store_table"], \
        call["store_buckets"]
    S, R, L = probe.shape
    qb = qbk.reshape(S, R, L, 2)
    total = slots = 0
    for s in range(S):
        on = probe[s] > 0
        rows = torch.arange(R, device=on.device)[:, None].expand(R, L)[on]
        tab = qtab[s][:, None].expand(R, L)[on].to(torch.int64)
        keys = torch.unique(torch.stack(
            [tab, u32(qb[s, ..., 0])[on], u32(qb[s, ..., 1])[on], rows], 1),
            dim=0)[:, :3]
        ok = valid[s] > 0
        skeys = torch.stack([stab[s][ok].to(torch.int64),
                             u32(sbk[s, :, 0][ok]), u32(sbk[s, :, 1][ok])], 1)
        both = torch.cat([keys, skeys])
        if both.shape[0] == 0:
            continue
        _, inv = torch.unique(both, dim=0, return_inverse=True)
        n = int(inv.max()) + 1
        per_row = torch.zeros(n, dtype=torch.int64, device=inv.device)
        per_slot = torch.zeros_like(per_row)
        per_row.index_add_(0, inv[:len(keys)],
                           torch.ones_like(inv[:len(keys)]))
        per_slot.index_add_(0, inv[len(keys):],
                            torch.ones_like(inv[len(keys):]))
        total += int((per_row * per_slot).sum())
        slots += int(per_slot[per_row > 0].sum())
    return total, slots


def scan_bound(call: dict) -> float:
    """One full-scan launch over the unsorted tail: every scanned slot's
    liveness, every valid slot's table and bucket, every matched slot's
    point row, psq and gid (once), the live rows' queries and probes, the
    outputs; the matched pairs' dots."""
    probe, valid = call["probe"], call["valid"]
    S, R, L = probe.shape
    N = valid.shape[1]
    d, K = call["d"], call["K"]
    live_rows = int((probe > 0).any(dim=-1).sum())
    valid_pts = int((valid > 0).sum())
    pairs, slots = _matched_pairs(call)
    out_bytes = S * R * (K * 8 + 4)
    row_bytes = live_rows * (d * 4 + 4 + 8 * L + 4 * L + 4)
    return bound_of(2.0 * pairs * d, PEAK_F32_FLOPS,
                    S * N * 4 + valid_pts * 12 + slots * (d * 4 + 8)
                    + row_bytes + out_bytes)
