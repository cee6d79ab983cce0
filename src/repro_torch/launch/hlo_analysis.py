"""The roofline of one NVIDIA H100 and the model-zoo kernels' costs (the
reference's ``repro.launch.hlo_analysis``).

The peaks are the published ones of the H100 SXM5 (NVIDIA's data sheet;
the card ``chip_smoke.py`` runs on reads "NVIDIA H100 80GB HBM3, 700.00
W" from ``nvidia-smi --query-gpu=name,power.limit``): 989 TFLOP/s of
dense bf16 on the tensor cores, 67 TFLOP/s of float32 outside them and
3.35 TB/s of HBM3.  A card held below its 700 W limit runs slower under
load; these are the ceilings, not a measurement.

``roofline`` is the reference's record (compute, memory and collective
terms, the bottleneck, ``useful_ratio``, ``step_time_s``, ``mfu``) at
these peaks.  One card has no interconnect: the collective term stays in
the signature and the record, and a non-zero ``coll_bytes`` is refused.
The reference's ``collective_bytes(hlo_text)`` has no counterpart: there
is no HLO, and the index's exchanges are counted where they happen, by
the ``AllToAll`` shim of ``core/index.py``.

``active_params`` and ``model_flops`` are the reference's (6 N D for a
training step, 2 N D for inference, N the parameters with each expert
weight scaled by top_k / n_experts), over the port's ``param_tree`` of a
meta model, whose leaf paths are the reference's.  ``bound_of`` and the
four cost functions -- (FLOPs, bytes) of the flash forward and gradient
and the SSD scan and gradient at a call's shapes -- serve both the dry
run (``launch/op_cost.py``: the kernel wrappers report their launches on
meta tensors with them) and ``chip_smoke.py``'s bounds, so one formula
serves both.
"""
from __future__ import annotations

import dataclasses
import math
import re

from repro_torch.kernels import ssd_scan as _kssd
from repro_torch.tree import leaves_with_paths

# NVIDIA H100 SXM5, published peaks (per card)
PEAK_FLOPS = 989e12          # bf16, dense, tensor cores
PEAK_F32_FLOPS = 67e12       # float32, CUDA cores
HBM_BW = 3.35e12             # bytes/s, HBM3
# the H100 80GB's memory as the caching allocator can use it (79.2 GiB of
# the card's 80 GB; PERF.md section 7), for ``fits`` where no card is
# present to ask
USABLE_BYTES = int(79.2 * 2**30)


@dataclasses.dataclass
class Roofline:
    flops: float                # per-device flops
    hbm_bytes: float            # per-device bytes accessed
    coll_bytes: float           # per-device collective bytes (0: one card)
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float          # 6*N*D (active), GLOBAL
    useful_ratio: float         # model_flops / (flops * n_devices)
    step_time_s: float          # max of the three terms
    mfu: float                  # model_flops / (step_time * chips * peak)

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline(flops: float, hbm_bytes: float, coll_bytes: float,
             model_flops: float, n_devices: int) -> Roofline:
    """The reference's roofline at the H100's peaks; ``coll_bytes`` must
    be 0 (one card: nothing crosses an interconnect)."""
    if coll_bytes:
        raise ValueError(f"coll_bytes={coll_bytes}: one card has no "
                         f"interconnect to move collective bytes over")
    ct = flops / PEAK_FLOPS
    mt = hbm_bytes / HBM_BW
    lt = 0.0
    terms = {"compute": ct, "memory": mt, "collective": lt}
    bottleneck = max(terms, key=terms.get)
    step = max(ct, mt, lt)
    total_flops = flops * n_devices
    return Roofline(
        flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_bytes,
        compute_s=ct, memory_s=mt, collective_s=lt,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=model_flops / total_flops if total_flops else 0.0,
        step_time_s=step,
        mfu=(model_flops / (step * n_devices * PEAK_FLOPS))
        if step > 0 else 0.0,
    )


def bound_of(flops, peak_flops, nbytes):
    """(bound ms, what bounds it): the larger of the operations over the
    peak rate for their type and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# Analytic model FLOPs: 6 * N_active * tokens
# ---------------------------------------------------------------------------

def active_params(cfg) -> int:
    """Parameter count with MoE expert weights scaled by top_k/n_experts."""
    from repro_torch.models import Transformer, param_tree
    tree = param_tree(Transformer(cfg, device="meta"))
    total = 0
    for path, leaf in zip(*leaves_with_paths(tree)):
        pstr = re.sub(r"\['([^']*)'\]", r"\1", path)   # the reference's
        n = math.prod(leaf.shape)
        if re.search(r"moe/w_(gate|up|down)", pstr):
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        total += n
    return total


def model_flops(cfg, shape_name: str, n_tokens: int) -> float:
    """6*N_active*D for train (fwd+bwd), 2*N_active*D for inference."""
    n = active_params(cfg)
    mult = 6.0 if shape_name.startswith("train") else 2.0
    return mult * n * n_tokens


# ---------------------------------------------------------------------------
# The model-zoo kernels' (FLOPs, bytes) at a call's shapes: each input read
# once, each output written once; 2 FLOPs a multiply-add
# ---------------------------------------------------------------------------

def _pairs(B, H, Sq, Sk, causal):
    """(query, key) pairs a call scores: the causal half at Sq == Sk."""
    return B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)


def flash_fwd_cost(B, H, Hkv, Sq, Sk, dh, dv, *, causal, itemsize,
                   lse=False):
    """The flash forward: q.k over dh and p.v over v's width dv for every
    scored pair; reads q, k, v, writes o (and each row's float32 lse)."""
    flops = 2.0 * _pairs(B, H, Sq, Sk, causal) * (dh + dv)
    nbytes = (itemsize * (B * H * Sq * dh + B * Hkv * Sk * (dh + dv)
                          + B * H * Sq * dv)
              + (4 * B * H * Sq if lse else 0))
    return flops, nbytes


def flash_bwd_cost(B, H, Hkv, Sq, Sk, dh, dv, *, causal, itemsize):
    """The flash gradient: five products for every scored pair (q.k, dq
    and dk over dh; dO.v and dv over dv); reads q, k, v, o, dout and lse,
    writes dq, dk, dv."""
    flops = 2.0 * _pairs(B, H, Sq, Sk, causal) * (3 * dh + 2 * dv)
    q, kv = B * H * Sq, B * Hkv * Sk
    nbytes = (itemsize * (q * dh + kv * (dh + dv) + 2 * q * dv)
              + 4 * q
              + itemsize * (q * dh + kv * (dh + dv)))
    return flops, nbytes


def ssd_fwd_cost(B, S, H, P, G, N, *, itemsize):
    """The SSD scan, the chunked algorithm at the kernel's chunk Q:
    C.state and the state update (2 S N P each), C B^T and M x over the S
    (Q + 1) / 2 causal pairs of each chunk; reads x, b, c, dt and a_log,
    writes y."""
    Q = _kssd.CHUNK
    flops = float(B * H) * (4 * S * N * P + S * (Q + 1) * (N + P))
    nbytes = (2 * B * S * H * P * itemsize + 2 * B * S * G * N * itemsize
              + B * S * H * 4 + H * 4)
    return flops, nbytes


def ssd_bwd_cost(B, S, H, P, G, N, *, itemsize):
    """The SSD gradient, the chunked backward's products each once at the
    forward's chunk: per head the chunk states s and r and the
    inter-chunk products of dc, u and db (2 S P N each), the scores C B^T
    and dY X^T and the intra-chunk products of dc, u and db over the S (Q
    + 1) / 2 causal pairs of each chunk; reads x, dy, b, c, dt and a_log,
    writes dx, db, dc, ddt and da_log."""
    Q = _kssd.CHUNK
    flops = float(B * H) * (10 * S * P * N + S * (Q + 1) * (3 * N + 2 * P))
    nbytes = (3 * B * S * H * P * itemsize + 4 * B * S * G * N * itemsize
              + 2 * B * S * H * 4 + 2 * H * 4)
    return flops, nbytes
