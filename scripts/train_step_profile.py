"""Time the SSD gradient kernel and a mamba2-130m training step on the card.

    python scripts/train_step_profile.py [--root CHECKOUT] [--kernel]
                                         [--steps N] [--seed S]

``--root`` names the checkout whose ``src/`` is imported (default: this
one), so one call on one card can hold two trees side by side: unpack the
other with ``git archive`` into a git-ignored directory and run the script
once for each.  The step is ``launch/train.py``'s ``make_step`` at
mamba2-130m's published width on 8 x 1,024 tokens from ``TokenPipeline``
(chip_smoke.py's train path), under ``train.deterministic()``: mean step
ms over ``--steps`` (CUDA events, after one warm-up), then one step under
``torch.profiler`` -- wall ms, device busy ms, kernel launches and device
ms by part (the SSD gradient, the SSD forward, products, the rest) and
the top kernels.  ``--kernel`` first times ``ssd_scan_bwd_cuda`` alone at
one layer's training inputs (x, b, c as strided views of one tensor, as
the SSM block passes them), with the design the checkout picks and,
where the checkout has both designs, the "cuda_core" one on the same bf16
inputs.  The allocator setting is whatever ``PYTORCH_CUDA_ALLOC_CONF``
says when the script starts (printed).  Needs a CUDA card; the last line
is a JSON object of the numbers.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ARCH, BATCH, SEQ = "mamba2-130m", 8, 1024


def _events_ms(fn, reps):
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


def kernel_times(seed):
    """ms of one ssd_scan_bwd launch at a training layer's inputs, by
    design."""
    import torch
    from repro_torch.kernels import ssd_scan as kssd
    B, S, H, G, P, N = BATCH, SEQ, 24, 1, 64, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn((B, S, H * P + 2 * G * N), generator=g,
                      device="cuda").mul_(0.5).bfloat16()
    x, b, c = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    x, b, c = x.view(B, S, H, P), b.view(B, S, G, N), c.view(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g,
                                                  device="cuda"))
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device="cuda"))
    dy = torch.randn((B, S, H, P), generator=g, device="cuda").mul_(
        0.01).bfloat16()
    args = (x, a_log, b, c, dt, dy)
    out = {}
    before = dict(getattr(kssd.ssd_scan_bwd_cuda, "launches_by_design",
                          {}))
    ms, _ = _events_ms(lambda: kssd.ssd_scan_bwd_cuda(*args), 20)
    after = getattr(kssd.ssd_scan_bwd_cuda, "launches_by_design", {})
    design = next((k for k in after if after[k] != before.get(k, 0)),
                  "cuda_core")
    out[design] = ms
    lib = kssd._bwd_lib()
    if design == "tensor_core":        # the step-at-a-time design, too
        plan = kssd.bwd_plan(torch.float32, B, S, H, P, N)
        work = torch.empty((plan.work_floats,), device="cuda")
        outs = (torch.empty_like(x.contiguous()),
                torch.empty((B, S, G, N), dtype=x.dtype, device="cuda"),
                torch.empty((B, S, G, N), dtype=x.dtype, device="cuda"),
                torch.empty((B, S, H), device="cuda"),
                torch.empty((H,), device="cuda"))
        stream = torch.cuda.current_stream().cuda_stream

        def cuda_core():
            err = lib.ssd_scan_bwd_launch(
                *(t.data_ptr() for t in (x, b, c, dt, a_log, dy, *outs,
                                         work)), 1, B, S, H, G, P, N,
                *x.stride(), *b.stride(), *c.stride(), *dt.stride(),
                *dy.stride(), stream)
            assert err == 0, err
        out["cuda_core"], _ = _events_ms(cuda_core, 5)
        del work
    for k, v in out.items():
        print(f"ssd_scan_bwd {k}: {v:.4f} ms at x {tuple(x.shape)} bf16")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kssd.ssd_scan_bwd_cuda(*args)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            print(f"  {e.self_device_time_total / 1e3:8.4f} ms {e.key[:80]}")
    return out


def step_profile(seed, steps):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import init_params, param_tree
    cfg = get_config(ARCH)
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    params = param_tree(model)
    pipe = TokenPipeline(cfg.vocab, BATCH, SEQ, seed=seed, device="cuda")
    batch = pipe._batch_at(0)
    step = train.make_step(model, optim.AdamWConfig(warmup_steps=10,
                                                    total_steps=40))
    out = {}
    with train.deterministic():
        state = (params, optim.init(params))
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ms, (state, _) = _events_ms(lambda: step(state, batch), steps)
        out["step_ms"] = ms
        out["tokens_s"] = BATCH * SEQ / (ms / 1e3)
        out["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
        step(state, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and e.device_type == DeviceType.CUDA]
    part = {"ssd_bwd": 0.0, "ssd_scan": 0.0, "gemm": 0.0, "other": 0.0}
    for e in rows:
        key = e.key.lower()
        name = ("ssd_bwd" if "ssd_bwd" in key else
                "ssd_scan" if "ssd_scan" in key else
                "gemm" if any(w in key for w in ("gemm", "xmma", "cutlass",
                                                 "nvjet")) else "other")
        part[name] += e.self_device_time_total / 1e3
    busy = sum(part.values())
    launches = sum(e.count for e in rows)
    print(f"step {ms:.2f} ms (CUDA events, mean of {steps}), "
          f"{out['tokens_s']:.0f} tokens/s, peak {out['peak_gib']:.2f} GiB; "
          f"traced: {wall:.2f} ms wall, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), {launches} kernel launches; by part "
          + ", ".join(f"{k} {v:.2f}" for k, v in part.items()))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:100]}")
    cpu = sorted((e for e in prof.key_averages()
                  if e.device_type != DeviceType.CUDA),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    print("host self time, top operators: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
        for e in cpu))
    out.update(wall_ms=wall, busy_ms=busy, launches=launches, parts=part)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kernel", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; root {args.root}; PYTORCH_CUDA_ALLOC_CONF="
          f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '')}")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    result = {"card": card, "root": args.root, "alloc_conf":
              os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")}
    if args.kernel:
        result["kernel_ms"] = kernel_times(args.seed)
    result.update(step_profile(args.seed, args.steps))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
