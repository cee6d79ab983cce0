"""Time the flash-attention gradient kernel on the card, by kernel.

    python scripts/flash_bwd_profile.py [--root CHECKOUT] [--long]
                                        [--reps N] [--seed S]

``--root`` names the checkout whose ``src/`` is imported (default: this
one), so one call on one card can hold two trees side by side: unpack the
other with ``git archive`` into a git-ignored directory and run the script
once for each.  The inputs are one layer's of chip_smoke.py's train_dense
path: gemma-7b's attention at 2 x 1,024 tokens (B = 2, H = Hkv = 16, dh =
256, causal, bf16), q, k, v and dout as the strided views the attention
layer and autograd hand over, o and lse from the forward kernel.  It
prints ``flash_attention_bwd_cuda``'s mean ms over ``--reps`` launches
(CUDA events, after a warm-up), its device ms by kernel (torch.profiler,
one launch), the design ``bwd_plan`` picks, the largest error of each
output over its largest magnitude against the plain version,
``scaled_dot_product_attention``'s backward on the same inputs and the
bound (five causal products on bf16 tensor cores against the bytes read
and written once).  ``--long`` adds gemma-7b's published context, (1, 16,
8,192, 256), held against the plain version one head at a time.  Needs a
CUDA card; the last line is a JSON object of the numbers.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
H, DH = 16, 256


def events_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def inputs(B, S, seed):
    """q, k, v, dout as the training path's views, o and lse from the
    forward kernel."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda sc: (torch.randn((B, S, H, DH), generator=g, device="cuda")
                     * sc).bfloat16().transpose(1, 2)
    q, k, v, dout = mk(0.5), mk(0.5), mk(0.5), mk(1.0)
    o, lse = kfa.flash_attention_cuda(q, k, v, return_lse=True)
    return q, k, v, o, lse, dout


def bound_ms(a, got):
    q, k, v, o, lse, dout = a
    B, Hq, S, dh = q.shape
    nbytes = (sum(t.numel() * t.element_size() for t in (q, k, v, o, dout))
              + lse.numel() * 4
              + sum(t.numel() * t.element_size() for t in got))
    flops = 10.0 * B * Hq * S * (S + 1) // 2 * dh
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def rel_errors(got, want):
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        out[name] = float((g - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
    return out


def by_kernel(fn):
    """Device ms of one call, by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        name = re.search(r"fa_bwd_\w+", ev.key)
        if t > 0 and name:
            out[name[0]] = out.get(name[0], 0.0) + t / 1e3
    return out


def measure(B, S, reps, seed, per_head):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    a = inputs(B, S, seed)
    q, k, v, o, lse, dout = a
    strides = [s for t in (q, k, v, o, dout) for s in t.stride()[:3]]
    design = kfa.bwd_plan(q.dtype, DH, S, S, strides=strides).design
    ms, got = events_ms(lambda: kfa.flash_attention_bwd_cuda(*a), reps)
    again = kfa.flash_attention_bwd_cuda(*a)
    bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
    kernels = by_kernel(lambda: kfa.flash_attention_bwd_cuda(*a))
    if per_head:   # the plain version's scores of one head at a time
        errs = {}
        for h in range(H):
            sl = tuple(t[:, h:h + 1] for t in a)
            e = rel_errors(tuple(g[:, h:h + 1] for g in got),
                           ref.flash_attention_bwd_ref(*sl))
            errs = {n: max(errs.get(n, 0.0), x) for n, x in e.items()}
    else:
        errs = rel_errors(got, ref.flash_attention_bwd_ref(*a))
    qd, kd, vd = (t.detach().clone().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(qd, kd, vd, is_causal=True)
        library_ms, _ = events_ms(lambda: torch.autograd.grad(
            lib_out, (qd, kd, vd), dout, retain_graph=True), reps)
    del lib_out
    return {"shape": [B, H, S, DH], "design": design, "ms": ms,
            "ms_by_kernel": kernels, "library_ms": library_ms,
            "bound_ms": bound_ms(a, got), "max_rel_err": errs,
            "bitwise_repeat": bitwise}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; root {args.root}")
    result = {"card": card, "root": args.root,
              "train_dense": measure(2, 1024, args.reps, args.seed, False)}
    print(f"train_dense inputs: {result['train_dense']}")
    if args.long:
        torch.cuda.empty_cache()
        result["long"] = measure(1, 8192, args.reps, args.seed, True)
        print(f"(1, 16, 8192, 256): {result['long']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
