#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and check them.

Run from the root of the repository:  python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one nvcc per source, all started together) and drives these paths:

  index     -- the Layered-LSH index over 2**22 planted points (d = 64, 8
               shards, 2 tables: the configuration of
               ``benchmarks/bench_serving.py``): query buckets through
               ``ShardedLSHService`` on the unsorted store (full-scan
               kernel), again after ``compact()`` (CSR gather kernel; the
               answers must be bitwise equal), and again after a streaming
               insert of 2**16 points and a delete of 1024 (gather plus
               tail scan); every hash of it (build, each bucket's
               dispatch and receive side, the insert, each H and G)
               launches the hash kernel;
  hash      -- ``ops.lsh_hash``, the p-stable hash op, on the index's
               Map-phase inputs: its 2**22 stored points against the
               index's own projections of both tables side by side,
               bitwise what the build hashed;
  simulate  -- the analytic simulator, the brute-force oracle, Multi-Probe
               LSH and the datasets (``core/simulate.py``,
               ``ref_search.py``, ``multiprobe.py``, ``data/``) at the
               paper's Random scale, drawn on the card from --seed: the
               index path's first served bucket against
               ``lsh_topk_reference`` over its 2**22 points; Fig 4.1
               (1,000,000 x 100, 100,000 queries, 64 shards, SIMPLE and
               LAYERED at L = 4, 16, 64: Layered's f_q within its Theorem
               8 bound and below Simple's rows); recall and recall@10 of
               2,000 queries against all points, entropy and mplsh
               probes; the card equal to the CPU on a sample of 65,536
               points and the first 1,024 queries planted among them
               (``simulate``, at a W where recall is not zero too,
               ``simulate_stream``, ``nearest_neighbors``);
               ``dedup_embeddings`` on that sample with its queries,
               dropping rows, equal to the CPU's; Table 1 (the Wiki
               stand-in, 1024 shards, all four schemes); every H, G and
               Gamma of it through the hash kernel.  It runs after
               the retrieval paths, so that each of them follows the
               same work as before it was added;
  retrieval -- the retrieval service of ``repro_torch.launch.serve`` with
               gemma-7b at its published width (28 layers, d_model 3072,
               bf16, weights drawn on the card from --seed): embed 2,048
               documents of 128 tokens in batches of 64 (the flash kernel,
               28 launches a forward), build the index at d = 3072 with
               serve.py's LSH settings on 8 shards, answer 4 batches of 64
               exact-duplicate queries, insert 256 documents and answer
               one more batch; then the full scan at d = 3072 against the
               CSR gather, bitwise, before and after a ``compact()``;
  contracts -- on the index of the index path (after its writes): the
               staged stages of one served bucket under the contract
               gate's trace pass (``repro_torch.analysis``): exchanges 1,
               0 and 1, the host syncs of each exactly those its
               manifest names (torch's sync-debug "warn" mode), 32-bit
               payloads, ops and allocator peak printed; one insert of
               4,096 points, its store columns written in place, then
               deleted (4,096 tombstoned tail rows for the paths after);
               then ``python -m repro_torch.analysis.check --device
               cuda`` (which must pass: the check config at T = 1, 2, 4,
               the bucket library's shared memory equal to its plans')
               and with each of its four seeded violations (each must
               fail); each kernel's first call at each width held
               against its plain version, the hashes bitwise;
  serving   -- on the index of the index path (after its writes): the
               staged query (``query_staged``: bitwise ``query``, 1, 0 and
               1 exchanges a stage) and ``AsyncLSHService`` (bucket 64,
               pipeline depth 2) over 16 buckets, bitwise the sync
               service's answers, with the ms a bucket of both and the
               host syncs of one pipeline ``submit``;
  durable   -- snapshot of that index (seconds, bytes on disk), one insert
               and one delete through a WAL-attached service, then, with
               the live index freed, ``persist.restore`` (answers bitwise
               those before the writes) and ``persist.recover`` at S = 8
               (bitwise those after them), in a temporary directory;
  mamba2    -- the same service with mamba2-130m at its published width
               (24 SSD blocks, d_model 768, bf16) and documents of 1,024
               tokens, 8 of the TPU kernel's 128-step chunks (the SSD
               kernel, 24 launches a forward), the index at d = 768; this
               path builds through ``recover_or_build(snapshot_dir=...,
               pipelined=True)`` (boot snapshot + WAL, the async front)
               and ends with a warm restart from that directory, which
               must answer a served batch with the same gids;
  train     -- examples/train_lm_with_dedup_torch.py's flow, last:
               ``dedup_embeddings`` of its planted embeddings through the
               hash kernel (the planted duplicates removed), then
               mamba2-130m at its published width trained by
               ``launch/train.py``: 8 x 1,024 tokens a step from
               ``TokenPipeline``, 12 steps, a checkpoint every 3, the
               example's failure half way (step 6), and the same run
               uninterrupted; the two loss trajectories must be bitwise
               alike (PyTorch's deterministic algorithms on) and the
               loss must fall.  Each step launches the SSD kernel twice
               a layer (the forward and its rematerialisation) and the
               SSD gradient kernel once, every launch of both in its
               "tensor_core" design.  Then the step's ms (CUDA
               events), tokens/s and peak memory, a traced step, bf16
               gradients against a float32 step (at 2 blocks of the
               published width: at 24 the random-init gradient is chaotic
               in bf16 rounding; that error is printed, also through the
               CPU's plain versions at two seeds), the card's float32
               loss and gradients at 24 blocks against the CPU's plain
               versions on 96 tokens, and the reduced float32 config's
               loss, gradients and one AdamW step on the card against
               the CPU.  The SSD kernel and its gradient are held
               against their plain versions at one layer's inputs of a
               training step, the gradient also against its own second
               launch, bitwise;
  example   -- after it, ``examples/serve_retrieval_torch.py``
               (reduced gemma-7b, 2,048 documents, inserts of 128 and
               query batches of 64 from the reference's draws) twice on
               one snapshot directory with --pipelined: cold with 2
               steps, then a warm restart with 4 that must resume the
               stream at step 2 and serve steps 2 and 3, drops 0; ms a
               step; each kernel's first call held against its plain
               version (the flash forward's float32 "cuda_core" design
               within FLASH_F32_TOL, the hashes bitwise);
  train_dense -- after it, gemma-7b at its published width (d_model 3072,
               16 heads of 256, d_ff 24,576, vocab 256,000, tied head,
               softcap 30, bf16) cut to 6 of its 28 blocks (memory),
               trained by ``launch/train.py``: 2 x 1,024 tokens a step
               from ``TokenPipeline``, 8 steps, a checkpoint every 2, a
               failure at step 4, and the same run uninterrupted; the
               two loss trajectories must be bitwise alike and the loss
               must fall.  Each step launches the flash kernel twice a
               layer (the forward and its rematerialisation, with its
               log-sum-exp) and the flash gradient kernel once.  Then
               the step's ms (CUDA events), tokens/s and model TFLOP/s
               (6 x ``count_params`` x tokens), peak memory, a traced
               step's device time by part, and float32 at 2 blocks of
               the published width: the card's kernels against the
               CPU's plain versions on 96 tokens.  The flash gradient
               kernel is held against its plain version at one layer's
               inputs of a training step, and against its own second
               launch, bitwise; the flash forward's output bitwise the
               same with and without its log-sum-exp there.  Last, the
               flash gradient is timed once more at gemma-7b's published
               context, (1, 16, 8,192, 256), causal, beside
               ``scaled_dot_product_attention``'s backward and its bound,
               and held against its plain version head by head;
  decode    -- then, with the allocator's cache emptied first: gemma-7b at
               its published width and depth (28 blocks, bf16) and
               mamba2-130m at its own (24 SSD blocks), weights from
               --seed, ``models.init_cache`` / ``prefill`` /
               ``decode_step``: 8 prompts of 2,048 tokens (mamba2: 1,024)
               prefilled into a cache of 2,080 positions (1,056), then 32
               teacher-forced decode steps; prefill ms, decode ms a step
               (the median), tokens/s, cache bytes, peak memory, the
               launches of every kernel (gemma's prefill runs the flash
               kernel once a block, decode none; mamba2's recurrence in
               plain PyTorch) and a traced step; every cache row not
               written yet must stay zero.  The decoded logits against
               the forward's at the decoded positions (28 blocks in bf16:
               reported), in float32 within 2e-3 (gemma cut to 2 blocks,
               mamba2 at full depth) and in bf16 at 2 blocks within twice
               the bf16 forward's own distance to the float32 forward.
               The flash kernel is held against its plain version and
               timed beside ``scaled_dot_product_attention`` at the
               prefill's inputs (the record's ``prefill_*`` keys);
  moe       -- after it, each model freed before the next:
               granite-moe-1b-a400m at its published width and depth (24 blocks, d_model
               1,024, 16 heads of 64 with 8 KV heads, 32 experts top-8
               of width 512, tied head, bf16) trained by
               ``launch/train.py`` (8 x 1,024 tokens, 8 steps, a
               checkpoint every 2 in host memory, a failure at step 4,
               bitwise the uninterrupted run, the loss falling; the
               balance loss and the dropped choices of every step; step
               ms, tokens/s, model TFLOP/s on the active parameters and
               as run, peak memory, a traced step's device time by part;
               float32 at 2 blocks, the card against the CPU), then
               decoded as the decode path decodes (8 prompts of 2,048
               tokens, 32 steps, the drops at the published capacity
               factor); deepseek-v2-lite-16b (27 MLA blocks, d_model
               2,048, q/k 192 and v 128, a dense block then 26 MoE
               blocks of 64 experts top-6 with 2 shared experts) decoded
               the same way at its full depth (its latent cache
               517,570,560 bytes), then trained cut to 3 blocks (2 x
               1,024 tokens, the same run and checks).  Decode against
               the forward at 2 blocks with the capacity factor raised
               to E / K (no drops).  The flash forward at both prefills
               (deepseek's v zero-padded from 128 to 192: its ms and
               bytes) beside ``scaled_dot_product_attention``, and the
               flash gradient at one layer's training inputs of each,
               bitwise on a second launch (the records' ``moe`` keys);
  hybrid    -- after it, recurrentgemma-2b at its published width and
               depth (26 blocks: RG-LRU, RG-LRU, sliding-window attention
               of window 2,048, repeated; bf16): the blocks' forward over
               8 x 2,048 tokens (the window masks nothing: the flash
               kernel once a local block); 8 prompts of 4,096 tokens,
               twice the window (the plain windowed paths), prefilled and
               decoded 32 steps as the decode path does; the RG-LRU
               scan's and the windowed attention's device time in a
               traced forward, prefill, step and training step, and each
               alone at its prefill and decode inputs; decode against the
               forward at 3 blocks on prompts past the window (float32
               within 2e-3, bf16 within rounding's reach); then training
               by ``launch/train.py`` cut to 12 blocks (8 x 1,024 tokens,
               6 steps, a failure at step 3, bitwise the uninterrupted
               run, the loss falling; step ms, tokens/s, model TFLOP/s,
               peak, a traced step) and float32 at 3 blocks, the card
               against the CPU;
  frontends -- then, each model freed before the next: whisper-medium
               at 24 + 24 blocks (``encode`` of 8 x 1,500 stub frames, the
               flash kernel once an encoder block, non-causal; 8 prompts
               of 448 tokens prefilled with the cross cache filled and 32
               decode steps, the cross-attention through the flash kernel
               at every step; one timed ``value_and_grad`` step with the
               frames; float32 at 2 + 2 blocks, decode against the forward
               and the gradient against the CPU), then pixtral-12b at 40
               blocks (8 x (1,024 stub patches + 1,024 tokens) prefilled
               and decoded; float32 decode against the forward at 2
               blocks).  Then the flash forward at each new shape family
               (the local block, the encoder, the cross-attention at a
               prompt and at a decode step, pixtral's prefill) and its
               gradient at the hybrid's and whisper's training inputs,
               held against their plain versions and timed beside
               ``scaled_dot_product_attention`` (the records'
               ``new_families`` keys).
  steps     -- last: the reference's cells (``launch/steps.py``) built by
               ``steps.build_step`` and run on the card.  The dry run
               (``python -m repro_torch.launch.dryrun --all`` and the
               cut cells below, on the meta device) runs on the host
               beside the kernel builds; its 40 cells are printed in one
               line.  mamba2-130m decode_32k (B = 128, a cache of
               32,768) and long_500k (B = 1, 524,288) and
               recurrentgemma-2b long_500k as the reference has them,
               each against ``decode_step`` called directly; gemma-7b
               prefill_32k at 1 of its 32 sequences, in the decode path
               on its 28-block weights, against ``prefill``; mamba2-130m
               train_4k at one microbatch of the largest batch that the
               dry run fits beside what is held, against
               ``launch/train.make_step`` (loss, parameters, moments).
               Each cell bitwise its hand-built path, its device memory
               rise within STEPS_MEM_TOL of the dry run's prediction,
               its kernel launches the dry run's, its ms (CUDA events)
               beside the roofline's and its model TFLOP/s.

Each path runs with every launch count set to 0 just before it and read
just after; the flash and SSD wrappers (forward and gradient) also count
per design, and every launch of the model paths must go to their
"tensor_core" designs, whose SASS must hold tensor-core instructions:
HMMA (``mma.sync``) in the flash forward's and both SSD kernels', HGMMA
(``wgmma``) in each of the flash gradient's; the example path's float32
model takes the flash forward's "cuda_core" design, which it holds
against its plain version at FLASH_F32_TOL.  Each kernel is then
held against its plain PyTorch version on the inputs its path gave it
and timed with CUDA events (both gradient kernels also against their own
second launch, bitwise); the hash kernel BITWISE, at the first call
of every (phase, kind) of every path, and against the CPU on a sample
of 65,536 rows.  One serving bucket and one embedding forward are
traced with torch.profiler, and the script prints one JSON line of
kernel records and, last, ``{"ok": true, "device": {...}}``.  Any
failed check raises: the exit code is then non-zero and the last line is
not printed.  With no CUDA device it exits with code 2 before doing
anything.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import concurrent.futures
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the train path's deterministic cuBLAS workspace: PyTorch reads it once,
# at the first cuBLAS call, which an earlier path makes
# (repro_torch.launch.train.CUBLAS_WORKSPACE_CONFIG); and the allocator's
# expandable segments, which the train_dense path's AdamW step needs
# (repro_torch.launch.train.CUDA_ALLOC_CONF): both before torch loads
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
# the H100's peaks (float32 outside the tensor cores, bf16 on them,
# HBM3), bound_of and the model-zoo kernels' (FLOPs, bytes)
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
IMAX = 2 ** 31 - 1
BUCKETS = 4        # query buckets served per phase
REPS = 20          # timed kernel runs
# the retrieval paths: serve.py's corpus and LSH settings, with documents
# of 128 tokens for gemma-7b (serve.py's 32 would fill a quarter of one of
# the flash kernel's 128-row tiles) and of 1,024 for mamba2-130m (8 of the
# SSD kernel's 128-step chunks: long documents are what an SSM embedder is
# chosen for, and the state is carried at full width)
N_DOCS, N_NEW, QUERY_BATCHES, BATCH = 2048, 256, 4, 64
RETRIEVAL_ARCHS = {
    # arch: (published (layers, d_model), document tokens, kernel of the
    #        blocks (its name in a profiler trace too), the index's slack)
    "gemma-7b": ((28, 3072), 128, "flash_attention", 4.0),
    # with random weights, mean-pooled mamba2 embeddings of 1,024-token
    # documents lie close together, so Layered LSH routes most of them to
    # one or two shards (near points share a machine, by design): the
    # index gets the lossless slack of n_shards instead of the default 4
    "mamba2-130m": ((24, 768), 1024, "ssd_scan", 8.0),
}
RETRIEVAL_LSH = dict(r=0.2, c=2.0, k=8, W=0.5, L=16, n_tables=1,
                     k_neighbors=1)
BF16_TOL = 0.05    # the reference's bf16 attention tolerance
# the flash forward against its plain version, besides BF16_TOL: each
# output row within this fraction of the row's own largest |o| (a bf16
# step is at most 2**-7 of a value; o shrinks as a row's keys grow, to a
# typical |o| near BF16_TOL at 2,048 keys, where BF16_TOL alone would
# pass a dropped key tile)
FLASH_ROW_TOL = 1e-2
# the flash forward in float32 (its "cuda_core" design) against its plain
# version: the card tests' tolerance (tests/test_torch_cuda.py)
FLASH_F32_TOL = 2e-5
HASH_SAMPLE = 65536  # rows of each hash call checked against the CPU
# the simulate path: the paper's Random scale (d = 100, 1M points, 100K
# queries; the reference's benches cut it to 20,000 / 2,000), 64 shards
# for Fig 4.1 and recall, 1024 for Table 1; recall against all points
# for the first 2,000 queries (the candidate test is O(m n L)); the card
# against the CPU on a sample
SIM_N, SIM_M, SIM_SHARDS, SIM_L = 1_000_000, 100_000, 64, (4, 16, 64)
RECALL_M, SAMPLE_N, SAMPLE_M = 2000, 65536, 1024
# the sample's pairs at r = 0.3 share a bucket too rarely at W = 0.5 (k =
# 10 and 12: ~2e-3 and ~7e-4 a table) for recall or dedup to be anything
# but empty on 1,024 queries; these widths make both non-empty
SAMPLE_WIDE_W, DEDUP_W = 1.2, 2.0
# name: (d, W, k, r, c) -- benchmarks/paper_common.py:17-25
SIM_DATASETS = {"random": (100, 0.5, 10, 0.3, 2.0),
                "wiki": (256, 0.5, 12, 0.1, 2.0)}
# the train path: examples/train_lm_with_dedup_torch.py's flow with
# mamba2-130m at its published width (the reference trainer's default
# arch), 8 x 1,024 tokens a step from TokenPipeline, 12 steps, a
# checkpoint every 3 and the example's failure half way (step 6); 40
# steps and a checkpoint every 10 until the hybrid and frontends paths
# came, cut for the run's time limit
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "mamba2-130m", 8, 1024
TRAIN_STEPS, TRAIN_CKPT_EVERY, TIMED_STEPS = 12, 3, 5
# bf16 gradients against a float32 step on the same weights and tokens:
# relative L2 error of each leaf and of the whole gradient (a wrong
# gradient is off by ~1; bf16 rounds activations at every layer).  At
# random init the 24-block model's gradient is chaotic in that rounding,
# through the kernels and through the CPU's plain versions alike (the
# train path prints both), so the check runs at the published widths
# cut to GRAD_DEPTH blocks; the 24-block errors are printed, not checked
GRAD_LEAF_TOL, GRAD_ALL_TOL, GRAD_DEPTH = 0.1, 0.05, 2
# float32 at 24 blocks: the kernels' gradient within this many times the
# distance one ulp of every weight moves the CPU's gradient (rounding is
# amplified alike by both; a fault is off by ~1, thousands of times more)
F32_CHAOS = 10
# the train_dense path: gemma-7b at its published width (the retrieval
# embedder) cut to DENSE_LAYERS of its 28 blocks (all 28 with bf16 weights
# and gradients and float32 AdamW moments need 102 GB, past the card's 80:
# PERF.md section 4), 2 x 1,024 tokens a step from TokenPipeline at vocab
# 256,000, 8 steps, lr 3e-4, a checkpoint every 2 (in host memory:
# MemoryCheckpoints), a failure at step 4 (16 steps, every 4, at 8 until
# the hybrid and frontends paths came, cut for the run's time limit)
DENSE_ARCH, DENSE_LAYERS, DENSE_BATCH, DENSE_SEQ = "gemma-7b", 6, 2, 1024
DENSE_STEPS, DENSE_CKPT_EVERY, DENSE_FAIL_AT, DENSE_TIMED = 8, 2, 4, 3
# the gradient kernel against its plain version at one layer's inputs of a
# training step: each output within this fraction of its own largest
# magnitude (bf16 outputs: a step is 2**-8 of a value, and P and dS are
# rounded to bf16 on both sides), and bitwise its own second launch
FLASH_BWD_TOL = 1e-2
# the flash gradient once more at gemma-7b's published context
# (arXiv:2403.08295: 8,192 tokens), one sequence of 16 heads of 256, causal
LONG_BATCH, LONG_SEQ = 1, 8192
# the decode path: arch -> (batch, prompt tokens, teacher-forced decode
# steps), at the published widths and depths in bf16; the checks against
# the forward on DECODE_CHECK = (batch, prompt, steps), in float32 within
# the reference's own decode tolerance (tests/test_arch_smoke.py:85) and
# in bf16 at DECODE_CUT blocks against rounding's own reach
DECODE_RUNS = {"gemma-7b": (8, 2048, 32), "mamba2-130m": (8, 1024, 32)}
DECODE_CHECK, DECODE_CUT, DECODE_F32_TOL = (2, 256, 8), 2, 2e-3
# the moe path: the two MoE configs at their published widths in
# bf16 -- arch -> (layers, d_model, heads, kv heads, q/k head width, v
# width, experts, top-k) -- each decoded at its full depth as the decode
# path decodes (MOE_DECODE = (batch, prompt, steps)) and trained by
# launch/train.py (MOE_TRAIN: arch -> (blocks kept, batch, tokens a
# sequence); granite at its full 24, deepseek cut to its dense block and
# two MoE blocks: its 15.7 B parameters with bf16 gradients and float32
# AdamW moments need ~190 GB), MOE_STEPS steps with a failure at
# MOE_FAIL_AT and a checkpoint every MOE_CKPT_EVERY in host memory (16, 8
# and 4 until the hybrid and frontends paths came, cut for the run's
# time limit); the float32 card-vs-CPU checks at DECODE_CUT blocks on
# MOE_F32_TOKENS tokens
MOE_WIDTHS = {"granite-moe-1b-a400m": (24, 1024, 16, 8, 64, 64, 32, 8),
              "deepseek-v2-lite-16b": (27, 2048, 16, 16, 192, 128, 64, 6)}
MOE_TRAIN = {"granite-moe-1b-a400m": (None, 8, 1024),
             "deepseek-v2-lite-16b": (3, 2, 1024)}
MOE_STEPS, MOE_CKPT_EVERY, MOE_FAIL_AT, MOE_TIMED = 8, 2, 4, 3
MOE_DECODE, MOE_F32_TOKENS = (8, 2048, 32), 96
# the operators only a MoE layer runs in a training step (the router's
# softmax, the top-k and rank sorts, the dispatch scatter, the combine
# gather and their backward): the traced step's routing/dispatch/combine
MOE_OPS = ("sort", "searchsorted", "index_put", "index_select", "index_add",
           "gather", "scatter", "bincount", "softmax")
# the hybrid path: recurrentgemma-2b (arXiv:2402.19427) at its published
# width and depth in bf16: the blocks' forward over HYBRID_FORWARD = (batch,
# tokens), within its window of 2,048 (the flash kernel); a prefill of
# HYBRID_DECODE's prompts of twice the window (the reference's decode_32k
# cell cut to 4,096 of context) and teacher-forced steps; decode against
# the forward at HYBRID_CUT blocks (one RG-LRU, RG-LRU, local unit) on
# HYBRID_CHECK, prompts past the window; training cut to HYBRID_TRAIN =
# (blocks, batch, tokens), HYBRID_STEPS steps with a failure at
# HYBRID_FAIL_AT, a checkpoint every HYBRID_CKPT_EVERY in host memory (6
# steps: at 16 the smoke ran 1,015-1,210 s of its 1,200 s limit, most of
# the two runs the 3.6 s draws of a batch; 8 until the steps path came,
# whose ~15 s the two steps fewer a run take back)
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_FORWARD, HYBRID_DECODE = (8, 2048), (8, 4096, 32)
HYBRID_CUT, HYBRID_CHECK = 3, (2, 2100, 8)
HYBRID_TRAIN, HYBRID_STEPS, HYBRID_FAIL_AT = (12, 8, 1024), 6, 3
HYBRID_CKPT_EVERY, HYBRID_TIMED, HYBRID_F32_TOKENS = 2, 3, 96
# the frontends path: whisper-medium (arXiv:2212.04356; 24 + 24 blocks,
# 1,500 stub frames) prefilled with WHISPER_DECODE = (batch, prompt, steps)
# -- 448 tokens, its decoder's context -- and one gradient step on the
# prompts; pixtral-12b (hf mistralai/Pixtral-12B-2409; 40 blocks, 1,024
# stub patch rows) prefilled with PIXTRAL_DECODE's prompts after them
WHISPER_DECODE, WHISPER_F32_TOKENS = (8, 448, 32), 96
PIXTRAL_DECODE = (8, 1024, 32)
# the steps path: the reference's cells (src/repro/launch/steps.py:63-68)
# built by launch/steps.py's build_step and run on the card, each held to
# launch/dryrun.py's prediction for it (the dry run runs on the host,
# started beside the kernel builds): STEPS_CELLS -- (arch, shape) -- at
# the reference's shapes; STEPS_PREFILL = (arch, shape, sequences), cut
# from 32 sequences (a cache of ~480 GB) and run on the decode path's
# weights before they are freed; mamba2-130m's train_4k at one microbatch
# of the largest of STEPS_TRAIN_BATCHES sequences of 4,096 that the dry run
# fits beside what is held (the reference's 8 of 32).  mamba2-130m's
# prefill_32k is not run: its stateful prefill walks 32,768 steps a token
# at a time
STEPS_CELLS = (("mamba2-130m", "decode_32k"), ("mamba2-130m", "long_500k"),
               ("recurrentgemma-2b", "long_500k"))
STEPS_PREFILL = ("gemma-7b", "prefill_32k", 1)
STEPS_TRAIN_ARCH, STEPS_TRAIN_BATCHES = "mamba2-130m", (32, 16, 8, 4)
# the dry run's predicted rise of device memory within this fraction of
# the rise the card measures; a train batch is taken if its predicted peak
# fits the card's memory less what is held and this margin (the CUDA
# context, the allocator's segments)
STEPS_MEM_TOL, STEPS_MARGIN = 0.15, 4 * 2**30
# the contracts path: points of the insert whose store columns must stay
# in place; the example path: --steps of its cold run and of its warm
# restart, which resumes at the cold run's last step
CONTRACTS_INSERT = 4096
EXAMPLE_STEPS = (2, 4)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    """One nvcc per CUDA source, all started together; prints each
    kernel's registers, shared memory and spills (ptxas).  Returns the
    library paths by source name."""
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        outs = list(pool.map(
            lambda n: _build.compile_source(n, ["-Xptxas", "-v"]), names))
    for name, (path, log) in zip(names, outs):
        print(f"built {name}: {path.name}")
        for line in log.splitlines():
            if ("registers" in line or "smem" in line or "spill" in line
                    or "Compiling entry" in line):
                print("  " + line.strip())
    return {name: path for name, (path, _) in zip(names, outs)}


def hmma_counts(libs):
    """Tensor-core instructions in the SASS of each tensor-core kernel
    (``cuobjdump --dump-sass`` of the toolkit that built them), by source:
    HMMA (``mma.sync``) and HGMMA (``wgmma``) apart.  Each kernel of the
    flash forward and the SSD scan and its gradient must have HMMA; each
    of the flash gradient's (on ``wgmma`` since PR 22) HGMMA."""
    from repro_torch.kernels import _build
    tool = str(Path(_build.nvcc()).parent / "cuobjdump")
    counts = {}
    for name, kernels, op in (
            ("flash_attention", ("flash_attention_tc_kernel",), "HMMA"),
            ("flash_attention_bwd", ("fa_bwd_dkdv_tc_kernel",
                                     "fa_bwd_dq_tc_kernel"), "HGMMA"),
            ("ssd_scan", ("ssd_scan_tc_kernel",), "HMMA"),
            ("ssd_scan_bwd", ("ssd_bwd_tc_",), "HMMA")):
        sass = subprocess.run([tool, "--dump-sass", str(libs[name])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        per_fn, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                per_fn[fn] = {"HMMA": 0, "HGMMA": 0}
            elif fn is not None:
                for kind in ("HMMA", "HGMMA"):
                    if kind in line:
                        per_fn[fn][kind] += 1
        tc_fns = {f: n for f, n in per_fn.items()
                  if any(k in f for k in kernels)}
        check(tc_fns and all(n[op] > 0 for n in tc_fns.values()),
              f"{kernels}: no {op} instruction in its SASS ({tc_fns})")
        counts[name] = {kind: sum(n[kind] for n in tc_fns.values())
                        for kind in ("HMMA", "HGMMA")}
        elsewhere = (sum(n["HMMA"] + n["HGMMA"] for n in per_fn.values())
                     - sum(counts[name].values()))
        print(f"sass {name}: {counts[name]['HMMA']} HMMA and "
              f"{counts[name]['HGMMA']} HGMMA instructions over "
              f"{len(tc_fns)} {'/'.join(kernels)} kernels "
              f"{sorted(n[op] for n in tc_fns.values())} ({op}); "
              f"{elsewhere} elsewhere")
    return counts


def timed(fn, reps):
    """Mean device time of fn() in ms over reps runs (after one warm-up),
    with CUDA events."""
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


def compare(name, got, want):
    """Integers equal, distances within rtol = atol = 1e-5."""
    import torch
    gd, gg, gc = (t.cpu() for t in got)
    wd, wg, wc = (t.cpu() for t in want)
    check(torch.equal(gg, wg), f"{name}: gids differ from the plain version")
    check(torch.equal(gc, wc), f"{name}: counts differ from the plain version")
    check(torch.allclose(gd, wd, rtol=1e-5, atol=1e-5),
          f"{name}: distances differ from the plain version")
    return float((gd.double() - wd.double()).abs().max())


def serve(svc, queries):
    """Answer every query through the service; returns (gids, dist bits,
    counts) and the mean host time of one bucket (ends in a sync: the
    answers are on the host)."""
    import numpy as np
    t0, b0 = svc.stats.query_time_s, svc.stats.batches
    handles = svc.submit_batch(queries)
    svc.drain()
    check(all(h.done for h in handles), "unanswered queries")
    gids = np.stack([h.gids for h in handles])
    dists = np.stack([h.dists for h in handles]).astype(np.float32)
    emit = np.array([h.n_within_cr for h in handles])
    per_bucket = (svc.stats.query_time_s - t0) / (svc.stats.batches - b0)
    return gids, dists, emit, per_bucket * 1e3


def traced(fn, what, marks=None):
    """Trace one fn() call (after a warm one) with torch.profiler: its wall
    time, the device's busy share of it (kernel times summed, so overlap
    would count twice) and the kernels by device time.  Returns the
    kernel rows, the wall ms and the kernel launches.  ``marks`` (a dict)
    gets the device ms of each ``record_function`` range named
    "region::<tag>" (``Regions``), by tag."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()                                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if marks is not None:      # each range's kernels, on its CPU side
        for e in prof.events():
            if (e.name.startswith("region::")
                    and e.device_type == DeviceType.CPU):
                tag = e.name.split("::")[1]
                marks[tag] = marks.get(tag, 0.0) + e.device_time_total / 1e3
    # the ranges' spans on the device timeline are no kernels
    timed_rows = [e for e in prof.key_averages()
                  if e.self_device_time_total > 0
                  and not e.key.startswith("region::")]
    # kernels only: an operator's row repeats its kernels' device time
    rows = [e for e in timed_rows if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    both = sum(e.self_device_time_total for e in timed_rows) / 1e3
    launches = sum(e.count for e in rows)
    print(f"profile: {what} {wall:.2f} ms wall, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), {launches} kernel launches "
          f"(operator and kernel rows summed together: {both:.2f} ms)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")
    return rows, wall, launches


def profile_forward(model, tokens, kernel_key):
    """Trace one embedding forward of a 64-document batch and split its
    device time: the blocks' kernel (``kernel_key`` in its name), the
    matrix products, the rest."""
    from repro_torch.serving import embed_texts
    rows, _, _ = traced(lambda: embed_texts(model, tokens),
                        f"one {len(tokens)}-document forward")
    print("forward device ms by part: " + ", ".join(
        f"{k} {v:.2f}" for k, v in device_parts(rows, kernel_key).items()))


def device_parts(rows, kernel_key):
    """Device ms of traced kernel rows by part: the kernel whose name
    holds ``kernel_key``, the matrix products, the rest."""
    part = {kernel_key: 0.0, "gemm": 0.0, "other": 0.0}
    for e in rows:
        key = e.key.lower()
        name = (kernel_key if kernel_key in key else
                "gemm" if any(w in key for w in ("gemm", "xmma", "cutlass",
                                                 "nvjet")) else "other")
        part[name] += e.self_device_time_total / 1e3
    return part


def recorder(captured, name, fn):
    """fn, recording the arguments of its first call under name."""
    def wrapped(*a, **kw):
        captured.setdefault(name, (a, kw))
        return fn(*a, **kw)
    return wrapped


def keyed_recorder(captured, name, fn, key):
    """fn, recording the arguments of its first call at each key(*a,
    **kw) under f"{name} {key}"."""
    def wrapped(*a, **kw):
        captured.setdefault(f"{name} {key(*a, **kw)}", (a, kw))
        return fn(*a, **kw)
    return wrapped


def design_recorder(captured, name, fn):
    """fn (a wrapper counting ``launches_by_design``), recording the
    arguments of its first launch of each design under f"{name}
    {design}"."""
    def wrapped(*a, **kw):
        before = dict(fn.launches_by_design)
        out = fn(*a, **kw)
        for design, n in fn.launches_by_design.items():
            if n > before[design]:
                captured.setdefault(f"{name} {design}", (a, kw))
        return out
    return wrapped


class PathCalls:
    """While a path runs (``with PathCalls(name) as calls``): the first
    call of the bucket kernels at each width d, of the flash forward in
    each design, and (``calls.hash``, a HashCalls in phase ``name``) of
    each hash kind.  ``hold()`` then holds every recorded call against
    its plain version on the same inputs: the bucket kernels' gids and
    counts equal and distances within 1e-5 (``compare``), the flash
    forward within FLASH_F32_TOL in float32 (BF16_TOL and FLASH_ROW_TOL
    in bf16), the hashes bitwise (``hash_records``), each kernel also
    launched twice to the same bits."""

    def __init__(self, name):
        self.name, self.captured = name, {}

    def __enter__(self):
        from repro_torch.kernels import bucket_search as kbs
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import ops
        self.ops = ops
        self.saved = {k: getattr(ops, k) for k in (
            "bucket_search_cuda", "bucket_gather_cuda",
            "flash_attention_cuda")}
        ops.bucket_search_cuda = keyed_recorder(
            self.captured, "bucket_search", kbs.bucket_search_cuda,
            lambda **kw: f"d={kw['query'].q.shape[-1]}")
        ops.bucket_gather_cuda = keyed_recorder(
            self.captured, "bucket_gather", kbs.bucket_gather_cuda,
            lambda *a, **kw: f"d={a[0].shape[-1]}")
        ops.flash_attention_cuda = design_recorder(
            self.captured, "flash_attention", kfa.flash_attention_cuda)
        self.hash = HashCalls().__enter__()
        self.hash.phase = self.name
        return self

    def __exit__(self, *exc):
        self.hash.__exit__()
        for k, fn in self.saved.items():
            setattr(self.ops, k, fn)

    def hold(self, launches):
        """Every recorded call against its plain version; every kernel
        launched on the path must have one (flash: every design it
        launched).  Returns the hash shapes' records."""
        import torch
        from repro_torch.kernels import bucket_search as kbs
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import ref
        t0 = time.perf_counter()
        # the path's launches by design, before the comparisons launch
        by_design = {d: n for d, n in
                     kfa.flash_attention_cuda.launches_by_design.items() if n}
        held = collections.Counter()
        for key, (a, kw) in sorted(self.captured.items()):
            kname = key.split()[0]
            held[kname] += 1
            if kname == "flash_attention":
                one = lambda f: (lambda o: o if isinstance(o, tuple)
                                 else (o,))(f(*a, **kw))
                got = one(kfa.flash_attention_cuda)
                same_bits(key, got, one(kfa.flash_attention_cuda))
                want = one(ref.attention_ref)
                tol = (FLASH_F32_TOL if a[0].dtype == torch.float32
                       else BF16_TOL)
                err = max(float((x.float() - y.float()).abs().max())
                          for x, y in zip(got, want))
                check(all(torch.allclose(x.float(), y.float(), rtol=tol,
                                         atol=tol)
                          for x, y in zip(got, want)),
                      f"{self.name}: {key} differs from its plain version "
                      f"by {err} (tolerance {tol})")
                if a[0].dtype != torch.float32:
                    flash_rows(got[0], want[0], f"the {self.name} path")
                print(f"{self.name}: {key} at q {tuple(a[0].shape)} "
                      f"{a[0].dtype}: max |err| {err:.3g} against its plain "
                      f"version (tolerance {tol}), two launches bitwise")
                continue
            kern, plain = ((kbs.bucket_search_cuda, ref.bucket_search_ref)
                           if kname == "bucket_search" else
                           (kbs.bucket_gather_cuda, ref.bucket_gather_ref))
            got = kern(*a, **kw)
            same_bits(key, got, kern(*a, **kw))
            err = compare(f"{self.name}: {key}", got, plain(*a, **kw))
            print(f"{self.name}: {key}: gids and counts equal to its plain "
                  f"version, max |d2 err| {err:.3g}, two launches bitwise")
        check(sum(by_design.values()) == launches["flash_attention"],
              f"{self.name}: flash launches by design {by_design}")
        for design in by_design:
            check(f"flash_attention {design}" in self.captured,
                  f"{self.name}: no flash call of design {design} held")
        for kname in ("bucket_search", "bucket_gather"):
            check(not launches[kname] or held[kname],
                  f"{self.name}: no {kname} call held")
        check(launches["lsh_hash"] == sum(self.hash.count.values()),
              f"{self.name}: every hash must launch the hash kernel")
        shapes = hash_records(self.hash, None, None)
        print(f"{self.name}: flash launches by design {by_design}; lsh_hash "
              f"by kind {self.hash.count}; every kernel held in "
              f"{time.perf_counter() - t0:.1f} s")
        return shapes


class HashCalls:
    """Stands in for ``core.hashing``'s view of the hash kernel's module
    while a path runs (``with HashCalls() as calls``): every call goes to
    the real wrapper, whose launch counter counts it; the first call of
    each (phase, kind) is kept with its arguments, and all are counted.
    Kinds: "H" (float x), "G" (the int32 bucket vectors) or "Gamma" (the
    float quotient), with the tables side by side ("cols"; "probes"
    where x is (queries, probes, d), the simulator's offsets and probe
    buckets), on x's leading axis ("lead") or by per-row table ids
    ("table").  A phase whose name ends in " cpu" is a CPU reference of
    the card's phase before it: its calls run the plain version on CPU
    tensors, are tallied apart in ``cpu`` and fail on a card tensor; in
    every other phase a call on a CPU tensor is counted like any other,
    so that a count above the launches shows it."""

    def __init__(self):
        from repro_torch.kernels import lsh_hash as klh
        self.klh, self.DTYPES = klh, klh.DTYPES
        self.phase, self.first, self.count, self.cpu = "build", {}, {}, {}

    def lsh_hash_cuda(self, x, a, b, **kw):
        import torch
        if self.phase.endswith(" cpu"):
            check(not x.is_cuda, f"{self.phase}: a hash on the card")
            self.cpu[self.phase] = self.cpu.get(self.phase, 0) + 1
            return self.klh.lsh_hash_cuda(x, a, b, **kw)
        kind = ("Gamma " if not kw.get("floor", True) else
                "G " if x.dtype == torch.int32 else "H ") + (
            "table" if kw.get("table") is not None
            else "lead" if a.dim() == 3
            else "cols" if x.dim() <= 2 else "probes")
        key = f"{self.phase}: {kind}"
        self.count[key] = self.count.get(key, 0) + 1
        self.first.setdefault(key, (x, a, b, dict(kw)))
        return self.klh.lsh_hash_cuda(x, a, b, **kw)

    def __enter__(self):
        from repro_torch.core import hashing
        hashing.klh = self
        return self

    def __exit__(self, *exc):
        from repro_torch.core import hashing
        hashing.klh = self.klh


def index_path(args, captured):
    """The slice-1 path at 2**log_n points; returns its launch counts, the
    index and its stored points."""
    import numpy as np
    import torch
    from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme
    from repro_torch.kernels import bucket_search as kbs
    from repro_torch.kernels import lsh_hash as klh
    from repro_torch.kernels import ops
    from repro_torch.serving import ShardedLSHService

    # ---- data: planted points N(0, 1/d), queries = point + r/sqrt(d) noise
    cfg = LSHConfig(d=64, k=10, W=1.0, r=0.3, c=2.0, L=16, n_shards=8,
                    scheme=Scheme.LAYERED, seed=0, n_tables=2)
    K, bucket = 10, 64
    n, d, m = 1 << args.log_n, cfg.d, BUCKETS * bucket
    rng = np.random.default_rng(args.seed)
    data = rng.standard_normal((n, d), dtype=np.float32)
    data *= np.float32(1.0 / math.sqrt(d))
    planted = rng.integers(0, n, m)
    noise = rng.standard_normal((m, d), dtype=np.float32)
    queries = data[planted] + noise * np.float32(cfg.r / math.sqrt(d))
    extra = rng.standard_normal((1 << 16, d), dtype=np.float32)
    extra *= np.float32(1.0 / math.sqrt(d))
    victims = rng.choice(n, 1024, replace=False)

    ops.bucket_search_cuda = recorder(captured, "bucket_search",
                                      kbs.bucket_search_cuda)
    ops.bucket_gather_cuda = recorder(captured, "bucket_gather",
                                      kbs.bucket_gather_cuda)

    # ---- the path: counts to 0, drive, read ------------------------------
    kbs.bucket_search_cuda.launches = 0
    kbs.bucket_gather_cuda.launches = 0
    klh.lsh_hash_cuda.launches = 0
    hcalls = HashCalls().__enter__()
    t0 = time.perf_counter()
    idx = DistributedLSHIndex(cfg, k_neighbors=K)
    calls = idx.a2a.calls
    idx.build(data)
    torch.cuda.synchronize()
    check(idx.a2a.calls == calls + 1, "insert must exchange once")
    check(idx.build_result.drops == 0, "build dropped rows")
    print(f"phase build_index: {time.perf_counter() - t0:.1f} s, "
          f"capacity {idx.store.capacity}/shard, "
          f"load {idx.shard_load.tolist()}")

    svc = ShardedLSHService(idx, bucket_size=bucket,
                            max_latency_ms=float("inf"), k_neighbors=K)
    calls = idx.a2a.calls
    hcalls.phase = "bucket"
    g4, d4, e4, ms4 = serve(svc, queries)
    check(idx.a2a.calls == calls + 2 * BUCKETS,
          "a query must exchange twice")
    print(f"phase serve_unsorted: {BUCKETS} buckets, "
          f"{ms4:.2f} ms/bucket")

    t0 = time.perf_counter()
    idx.compact()
    torch.cuda.synchronize()
    print(f"phase compact: {time.perf_counter() - t0:.1f} s, "
          f"n_sorted {idx.store.n_sorted}, "
          f"max bucket {idx.layout['max_bucket']}")
    g5, d5, e5, ms5 = serve(svc, queries)
    check(np.array_equal(g4, g5) and np.array_equal(e4, e5)
          and np.array_equal(d4.view(np.uint32), d5.view(np.uint32)),
          "CSR answers are not bitwise equal to the full scan's")
    print(f"phase serve_sorted: bitwise equal, {ms5:.2f} ms/bucket")

    calls = idx.a2a.calls
    hcalls.phase = "insert"
    ins = svc.insert(extra, gids=np.arange(n, n + len(extra)))
    hcalls.phase = "bucket"
    check(idx.a2a.calls == calls + 1 and ins.drops == 0,
          "streaming insert: one exchange, no drops")
    dele = svc.delete(victims)
    check(idx.a2a.calls == calls + 1, "delete must not exchange")
    check(dele.n_points == len(victims), "delete missed live gids")
    g6, d6, e6, ms6 = serve(svc, queries)
    print(f"phase serve_tail: tail {idx.layout['tail_rows']} rows, "
          f"{ms6:.2f} ms/bucket")
    torch.cuda.synchronize()
    hcalls.__exit__()
    launches = {"bucket_search": kbs.bucket_search_cuda.launches,
                "bucket_gather": kbs.bucket_gather_cuda.launches,
                "lsh_hash": klh.lsh_hash_cuda.launches}
    print(f"launches on the index path: {launches}; lsh_hash by phase and "
          f"kind: {hcalls.count}")

    # ---- checks on the answers ------------------------------------------
    check(svc.stats.drops == 0, "capacity drops in serving")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the path never launched")
    check(launches["lsh_hash"] == sum(hcalls.count.values()),
          "every hash of the path must launch the hash kernel")
    for key in ("build: H cols", "build: G lead", "bucket: H lead",
                "bucket: G lead", "bucket: H table", "bucket: G table",
                "insert: H cols", "insert: G lead"):
        check(hcalls.count.get(key, 0) > 0, f"no hash launch for {key}")
    for g, dd in ((g4, d4), (g6, d6)):
        check(g.shape == (m, K) and dd.shape == (m, K), "answer shape")
        hit = g != IMAX
        check(np.all(np.isfinite(dd[hit])) and np.all(np.isinf(dd[~hit])),
              "distances must be finite exactly where a gid is")
        check(np.all(dd[hit] <= cfg.c * cfg.r * (1 + 1e-5)),
              "answers must lie within cr")
    check(not np.isin(g6, victims).any(), "a deleted gid was returned")
    # brute-force distances of the returned pairs (float64 on the host)
    rows, cols = np.nonzero(g4 != IMAX)
    true = np.linalg.norm(queries[rows].astype(np.float64)
                          - data[g4[rows, cols]].astype(np.float64), axis=1)
    check(np.allclose(d4[rows, cols], true, rtol=1e-4, atol=1e-4),
          "returned distances disagree with brute force")
    recall = float(np.mean((g4 == planted[:, None]).any(axis=1)))
    print(f"planted-neighbour recall@{K}: {recall:.4f} "
          f"(found in {float(np.mean(g4[:, 0] != IMAX)):.4f} of queries)")
    _, _, n_launch = traced(lambda: serve(svc, queries[:bucket]),
                            "one bucket")
    print(f"device launches of one served tail bucket: {n_launch} "
          f"(hash kernel: 4 of them)")
    return launches, idx, data, hcalls, dict(svc=svc, queries=queries,
                                             K=K, bucket=bucket,
                                             served=(d4[:bucket],
                                                     g4[:bucket]))


def _answers(idx, queries, bucket, K, staged=False):
    """Per bucket: (gids, distance bits, counts, fq, query load) of the
    fused query (or of the staged one)."""
    import numpy as np
    out = []
    for i in range(0, len(queries), bucket):
        q = queries[i:i + bucket]
        r = (idx.query_staged(q, k_neighbors=K) if staged
             else idx.query(q, k_neighbors=K))
        check(r.drops == 0, "query drops")
        out.append((r.topk_gid, r.topk_dist.view(np.uint32),
                    r.n_within_cr, r.fq, r.query_load))
    return out


def _same(a, b):
    import numpy as np
    return len(a) == len(b) and all(
        np.array_equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))


def _launch_counts():
    """Every kernel wrapper's launch count, by kernel."""
    from repro_torch.kernels import bucket_search as kbs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import lsh_hash as klh
    from repro_torch.kernels import ssd_scan as kssd
    return {"bucket_search": kbs.bucket_search_cuda.launches,
            "bucket_gather": kbs.bucket_gather_cuda.launches,
            "lsh_hash": klh.lsh_hash_cuda.launches,
            "flash_attention": kfa.flash_attention_cuda.launches,
            "flash_attention_bwd": kfa.flash_attention_bwd_cuda.launches,
            "ssd_scan": kssd.ssd_scan_cuda.launches,
            "ssd_scan_bwd": kssd.ssd_scan_bwd_cuda.launches}


def _reset_launches():
    """Every kernel wrapper's launch counts, total and by design, to 0."""
    from repro_torch.kernels import bucket_search as kbs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import lsh_hash as klh
    from repro_torch.kernels import ssd_scan as kssd
    kbs.bucket_search_cuda.launches = 0
    kbs.bucket_gather_cuda.launches = 0
    klh.lsh_hash_cuda.launches = 0
    kfa.reset_launches()
    kssd.reset_launches()


def syncs_of_one_submit(idx, rows, K):
    """Host syncs of one ``QueryPipeline.submit`` (after a warm one):
    the synchronizing CUDA calls torch reports in sync-debug "warn"
    mode (the gate's ``device_pass.SyncLog``, the allocator's peak left
    alone), with the lines that made them."""
    import torch
    from repro_torch.analysis import device_pass
    from repro_torch.serving import QueryPipeline
    pipe = QueryPipeline(idx, len(rows), k_neighbors=K, depth=2)
    handle = lambda: [type("H", (), {"t_submit": 0.0})() for _ in rows]
    pipe.submit(list(rows), handle())
    pipe.drain()
    torch.cuda.synchronize()
    with device_pass.SyncLog(peak=False) as log:
        pipe.submit(list(rows), handle())
    pipe.drain()
    return len(log.syncs), dict(collections.Counter(
        s["where"] for s in log.syncs))


def pipelined_stream(idx, stream, K, bucket):
    """``stream`` through a fresh AsyncLSHService (depth 2): wall ms a
    bucket from the first submit to the drained answers, the in-flight
    peak, and the answers."""
    import numpy as np
    from repro_torch.serving import AsyncLSHService
    asvc = AsyncLSHService(idx, bucket_size=bucket,
                           max_latency_ms=float("inf"), k_neighbors=K,
                           pipeline_depth=2)
    try:
        t0 = time.perf_counter()
        handles = asvc.submit_batch(stream)
        asvc.drain()
        ms = (time.perf_counter() - t0) / (len(stream) // bucket) * 1e3
        peak = asvc.stats.inflight_peak
    finally:
        asvc.close()
    check(all(h.done for h in handles), "unanswered async queries")
    return ms, peak, (np.stack([h.gids for h in handles]),
                      np.stack([h.dists for h in handles]).astype(
                          np.float32),
                      np.array([h.n_within_cr for h in handles]))


def serving_path(idx, svc, queries, K, bucket):
    """The staged query and the pipelined async service on the index as
    the index path left it; returns its launch counts."""
    import numpy as np
    import torch
    _reset_launches()
    # ---- serve_staged: bitwise query(), exchanges 1 / 0 / 1 ------------
    q = queries[:bucket]
    c0 = idx.a2a.calls
    disp = idx.query_dispatch(q)
    c1 = idx.a2a.calls
    scanned = idx.query_scan(disp, k_neighbors=K)
    c2 = idx.a2a.calls
    idx.query_return(scanned)
    c3 = idx.a2a.calls
    torch.cuda.synchronize()
    check((c1 - c0, c2 - c1, c3 - c2) == (1, 0, 1),
          f"staged exchanges {(c1 - c0, c2 - c1, c3 - c2)} != (1, 0, 1)")
    n_b = len(queries) // bucket
    t = {}
    for kind in ("fused", "staged", "staged", "fused"):
        t0 = time.perf_counter()
        got = _answers(idx, queries, bucket, K, staged=kind == "staged")
        t.setdefault(kind, []).append(
            (time.perf_counter() - t0) / n_b * 1e3)
        t.setdefault(kind + "_answers", got)
    check(_same(t["staged_answers"], t["fused_answers"]),
          "query_staged is not bitwise query()")
    print(f"phase serve_staged: {n_b} buckets bitwise equal to query(), "
          f"exchanges per stage (1, 0, 1); ms/bucket (host clock, answers "
          f"on the host) fused {t['fused'][0]:.2f} {t['fused'][1]:.2f}, "
          f"staged {t['staged'][0]:.2f} {t['staged'][1]:.2f}")

    # ---- serve_pipelined: the async service against the sync one -------
    # in turns sync, async, async, sync over one stream of 16 buckets
    stream = np.concatenate([queries] * 4)
    n_buckets = len(stream) // bucket
    want, ms, peak = None, {"sync": [], "async": []}, 0
    for kind in ("sync", "async", "async", "sync"):
        if kind == "sync":
            *got, m = serve(svc, stream)
            torch.cuda.synchronize()
        else:
            m, peak, got = pipelined_stream(idx, stream, K, bucket)
        ms[kind].append(m)
        want = want or got
        check(np.array_equal(got[0], want[0])
              and np.array_equal(got[2], want[2])
              and np.array_equal(got[1].view(np.uint32),
                                 want[1].view(np.uint32)),
              "the async service's answers are not bitwise the sync ones")
    n_sync, where = syncs_of_one_submit(idx, queries[:bucket], K)
    print(f"phase serve_pipelined: {n_buckets} buckets of {bucket}, depth "
          f"2, bitwise the sync service; sync "
          f"{', '.join(f'{m:.2f}' for m in ms['sync'])} ms/bucket, "
          f"pipelined {', '.join(f'{m:.2f}' for m in ms['async'])} "
          f"ms/bucket (wall, submit to drained), inflight peak {peak}; "
          f"host syncs in one submit: {n_sync} {where}")
    torch.cuda.synchronize()
    launches = _launch_counts()
    print(f"launches on the serving path: {launches}")
    check(launches["lsh_hash"] > 0 and launches["bucket_gather"] > 0,
          "a kernel of the serving path never launched")
    return launches


def contracts_path(idx, queries, K, bucket, seed):
    """The contract gate on the card.  On the index path's index (2**22
    points, T = 2): the staged stages of one served bucket under the
    trace pass -- exchanges 1, 0 and 1, host syncs each exactly the
    manifest's named allowance, their ops and allocator peak printed --
    and one insert of CONTRACTS_INSERT points, its store columns written
    in place, then deleted again (the serving and durable paths that
    follow see the index's live points as before, with 4,096 more
    tombstoned tail rows).  Then ``repro_torch.analysis.check`` at its
    check config (which must pass) and with each of its four seeded
    violations (each must fail, naming its contract).  Every kernel's
    first call at each width (PathCalls) is then held against its plain
    version.  Returns its launch counts and the hash shapes' records."""
    import numpy as np
    import torch
    from repro_torch.analysis import (check as gate, device_pass,
                                      load_contracts, trace_pass)
    contracts = load_contracts()
    T = idx.cfg.n_tables
    t_path = time.perf_counter()
    _reset_launches()
    calls = PathCalls("contracts").__enter__()
    q = torch.as_tensor(queries[:bucket], device="cuda")

    def phase(name, fn, exchanges):
        tr = trace_pass.trace(idx, fn, device_pass.SyncLog())
        check(tr.exchanges == exchanges,
              f"{name}: {tr.exchanges} exchanges, not {exchanges}")
        check(all(p["itemsize"] == 4 for p in tr.wire),
              f"{name}: a 64-bit payload on the wire")
        syncs = device_pass.sync_report(tr.syncs, name, T, contracts)
        check(not syncs["violations"], "; ".join(syncs["violations"]))
        where = collections.Counter(s["where"] for s in tr.syncs)
        top = tr.max_intermediate
        print(f"phase contracts {name}: exchanges {tr.exchanges}, host "
              f"syncs {len(tr.syncs)} {dict(where)}, {tr.ops} ops, "
              f"largest allocation {top['shape']} {top['dtype']} "
              f"({top['op']}), allocator peak above inputs and outputs "
              f"{tr.temp_bytes} bytes")
        return tr.out

    disp = phase("query_dispatch", lambda: idx.query_dispatch(q), 1)
    scanned = phase("query_scan", lambda: idx.query_scan(
        disp, k_neighbors=K), 0)
    phase("query_return", lambda: idx.query_return(scanned), 1)

    rng = np.random.default_rng(seed + 2)
    new = rng.standard_normal((CONTRACTS_INSERT, idx.cfg.d),
                              dtype=np.float32)
    new *= np.float32(1.0 / math.sqrt(idx.cfg.d))
    # on the card already, as the gate passes its inputs
    new = torch.as_tensor(new, device="cuda")
    cols = contracts["device"]["in_place"]["insert"]
    before = device_pass.column_storages(idx.store, cols)
    cap = idx.store.capacity
    res = phase("insert", lambda: idx.insert(new), 1)
    check(res.drops == 0 and res.n_inserted == CONTRACTS_INSERT,
          "contracts insert: drops")
    ip = device_pass.in_place_report(
        before, device_pass.column_storages(idx.store, cols), cap,
        idx.store.capacity, "insert", T, contracts)
    check(not ip["violations"], "; ".join(ip["violations"]))
    gone = idx.delete(np.arange(res.gid_start,
                                res.gid_start + CONTRACTS_INSERT))
    check(gone.n_points == CONTRACTS_INSERT, "contracts insert: delete")
    print(f"phase contracts insert: {CONTRACTS_INSERT} points, columns "
          f"{cols} in place at {cap} slots a shard; deleted again")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
        out = os.path.join(tmp, "report.json")
        t0 = time.perf_counter()
        check(gate.main(["--device", "cuda", "--json", out]) == 0,
              "the contract gate failed on the card")
        t_gate = time.perf_counter() - t0
        with open(out) as f:
            rep = json.load(f)
        sm = rep["smem"]
        check(sm["library_checked"] and sm["library_mismatches"] == 0,
              "the library's shared memory differs from the plans'")
        ph = rep["trace"]["phases"]
        print("phase contracts gate: "
              + "; ".join(
                  f"{p} ops {rep['trace']['flatness']['ops'][p]} syncs "
                  f"{ph[p]['2']['host_syncs']['count']} temp/shard "
                  f"{ph[p]['2'].get('memory', {}).get('temp_bytes_per_shard')}"
                  for p in ph)
              + f"; smem {sm['largest']}; {t_gate:.1f} s")
        needles = {"extra-collective": "all_to_all x3",
                   "broken-donation": "not written in place",
                   "jaxpr-growth": "not flat", "host-sync": "[host-sync]"}
        for seeded, needle in needles.items():
            rc = gate.main(["--device", "cuda", "--json", out,
                            "--seed-violation", seeded])
            with open(out) as f:
                rep = json.load(f)
            check(rc != 0 and any(needle in v for v in rep["violations"]),
                  f"the gate passed with a seeded {seeded}")
    torch.cuda.synchronize()
    calls.__exit__()
    launches = _launch_counts()
    print(f"launches on the contracts path: {launches}")
    check(launches["bucket_search"] > 0 and launches["lsh_hash"] > 0,
          "a kernel of the contracts path never launched")
    shapes = calls.hold(launches)
    print(f"phase contracts: {time.perf_counter() - t_path:.1f} s, the gate "
          f"passed and each of its 4 seeded violations failed")
    return launches, shapes


def example_path():
    """``examples/serve_retrieval_torch.py`` (reduced gemma-7b) twice on
    one snapshot directory with --pipelined: cold (--steps 2), then a
    warm restart (--steps 4) that must resume the stream at step 2 and
    answer steps 2 and 3, with drops 0 in both; ms a step.  Every
    kernel's first call (PathCalls: the flash forward in each design it
    launched, float32's "cuda_core" here) is then held against its plain
    version.  Frees what it allocates.  Returns its launch counts and
    the hash shapes' records."""
    import importlib.util
    import numpy as np
    import torch
    spec = importlib.util.spec_from_file_location(
        "serve_retrieval_torch", ROOT / "examples" / "serve_retrieval_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t_path = time.perf_counter()
    _reset_launches()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_example_") as snap, \
            PathCalls("example") as calls:
        for run, steps in zip(("cold", "warm"), EXAMPLE_STEPS):
            t0 = time.perf_counter()
            runs[run] = example.main(
                ["--snapshot-dir", snap, "--pipelined", "--steps",
                 str(steps)])
            runs[run]["s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    cold, warm = runs["cold"], runs["warm"]
    ex = example.parse([])
    check(cold["warm"] is None and cold["resumed_at"] == 0
          and len(cold["steps"]) == EXAMPLE_STEPS[0],
          "example: the cold run")
    check(warm["warm"] is not None and warm["resumed_at"] == EXAMPLE_STEPS[0]
          and warm["rows_at_start"] == ex.docs + EXAMPLE_STEPS[0]
          * ex.insert_size and len(warm["steps"])
          == EXAMPLE_STEPS[1] - EXAMPLE_STEPS[0],
          "example: the warm restart did not resume the stream")
    for run in runs.values():
        check(run["drops"] == 0, "example: drops")
        for st in run["steps"]:
            g, d = st["gids"], st["dists"]
            check(g.shape == (ex.batch_size, ex.k_neighbors)
                  and len(st["new_gids"]) == ex.insert_size,
                  "example: answer shapes")
            hit = g != IMAX
            check(np.all(np.isfinite(d[hit])) and np.all(np.isinf(d[~hit])),
                  "example: distances finite exactly where a gid is")
    ms = [1e3 * (st["insert_s"] + st["query_s"])
          for run in runs.values() for st in run["steps"]]
    launches = _launch_counts()
    print(f"phase example: cold {cold['s']:.1f} s, warm {warm['s']:.1f} s "
          f"(resumed at step {warm['resumed_at']}), ms a step (insert of "
          f"{ex.insert_size} documents and a query batch of "
          f"{ex.batch_size}) {', '.join(f'{m:.1f}' for m in ms)}; "
          f"self-retrieval {cold['hits']} + {warm['hits']}; launches "
          f"{launches}; {time.perf_counter() - t_path:.1f} s")
    check(launches["flash_attention"] > 0 and launches["lsh_hash"] > 0
          and launches["bucket_search"] > 0,
          "a kernel of the example path never launched")
    shapes = calls.hold(launches)
    del runs, cold, warm, calls
    torch.cuda.empty_cache()
    return launches, shapes


def durable_path(state, queries, K, bucket, seed):
    """Snapshot, restore and recover at S = 8 of the index in ``state``
    (its only holder: the live index is freed before the restore, so two
    stores never share the card); returns its launch counts."""
    import numpy as np
    import torch
    from repro_torch import persist
    idx, svc = state.pop("idx"), state.pop("svc")
    n, d = idx._next_gid, idx.cfg.d
    rng = np.random.default_rng(seed + 1)
    new = rng.standard_normal((4096, d), dtype=np.float32)
    new *= np.float32(1.0 / math.sqrt(d))
    victims = rng.choice(n, 512, replace=False)
    _reset_launches()
    before = _answers(idx, queries, bucket, K)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snap_") as tmp:
        wal = persist.WriteAheadLog(persist.wal_path(tmp))
        t0 = time.perf_counter()
        persist.snapshot(idx, tmp, wal=wal)
        t_snap = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(tmp) for f in fs)
        n_live = idx.n_live
        print(f"phase snapshot: {n_live} live rows, {t_snap:.2f} s, "
              f"{nbytes} bytes on disk")
        svc.wal = wal
        ins = svc.insert(new, gids=np.arange(n, n + len(new)))
        dele = svc.delete(victims)
        check(ins.drops == 0 and dele.n_points > 0, "WAL'd writes")
        check(wal.n_records == 2, "the WAL must hold the two writes")
        after = _answers(idx, queries, bucket, K)
        wal.close()
        svc.wal = None
        del idx, svc
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"device memory after freeing the live index "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")

        t0 = time.perf_counter()
        r = persist.restore(tmp)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        check(r.device.type == "cuda" and r.n_live == n_live,
              "restore: live rows")
        check(_same(_answers(r, queries, bucket, K), before),
              "restored answers are not bitwise the live index's")
        print(f"phase restore: S = {r.cfg.n_shards}, {t_restore:.2f} s, "
              f"answers bitwise those of the live index at the snapshot")
        del r
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        rr = persist.recover(tmp)
        torch.cuda.synchronize()
        t_recover = time.perf_counter() - t0
        check(rr.replayed_inserts == 1 and rr.replayed_deletes == 1
              and rr.replayed_points == len(new), "recover: replay")
        check(rr.index.cfg.n_shards == 8, "recover at S = 8")
        check(_same(_answers(rr.index, queries, bucket, K), after),
              "recovered answers are not bitwise the live index's after "
              "the same writes")
        rr.wal.close()
        print(f"phase recover: S = 8, {t_recover:.2f} s (restore + replay "
              f"of 1 insert of {len(new)} points and 1 delete of "
              f"{len(victims)} gids), answers bitwise those of the live "
              f"index after the same writes")
        del rr
    torch.cuda.synchronize()
    launches = _launch_counts()
    print(f"launches on the durable path: {launches}")
    check(launches["lsh_hash"] > 0, "no hash launch on the durable path")
    return launches


def lsh_hash_path(idx, data, hcalls):
    """The hash op's own entry point, ``ops.lsh_hash``, on the index's
    Map-phase inputs: every stored point against the projections of all
    its tables side by side, bitwise what the index's build computed;
    returns its launch count."""
    import torch
    from repro_torch.kernels import lsh_hash as klh
    from repro_torch.kernels import ops
    T = idx.cfg.n_tables
    x = torch.from_numpy(data).cuda()
    A = torch.cat([idx.stacked_params.table(t).A for t in range(T)], dim=1)
    b = torch.cat([idx.stacked_params.table(t).b for t in range(T)])
    klh.lsh_hash_cuda.launches = 0
    out = ops.lsh_hash(x, A, b, w=idx.cfg.W)
    torch.cuda.synchronize()
    launches = klh.lsh_hash_cuda.launches
    check(launches == 1 and out.shape == (len(data), A.shape[1]),
          "ops.lsh_hash must launch its kernel once")
    bx, ba, bb, bkw = hcalls.first["build: H cols"]
    check(torch.equal(out, klh.lsh_hash_cuda(bx, ba, bb, **bkw)),
          "ops.lsh_hash differs from the index's build hash")
    print(f"launches on the hash path: {{'lsh_hash': {launches}}}, "
          f"bitwise the index's build hash")
    return launches


def _hash_sample(x, a, b, kw, got, rows=HASH_SAMPLE):
    """Up to ``rows`` rows of a hash call and of its output, on the CPU:
    (x, a, b, kw, got) with every tensor moved there."""
    import torch
    g = torch.Generator().manual_seed(0)
    kw = dict(kw)
    table = kw.get("table")
    if table is not None:             # sample whole table entries
        per = x.numel() // x.shape[-1] // table.numel()
        e = torch.randperm(table.numel(), generator=g)[:max(1, rows // per)]
        x = x.reshape(table.numel(), per, x.shape[-1])[e.to(x.device)]
        got = got.reshape(table.numel(), per, -1)[e.to(got.device)]
        kw["table"] = table.reshape(-1)[e.to(table.device)].cpu()
    elif a.dim() == 3:                # rows of every table
        n = x.shape[1]
        e = torch.randperm(n, generator=g)[:rows].to(x.device)
        x, got = x[:, e], got[:, e]
    else:
        e = torch.randperm(x.shape[0], generator=g)[:rows].to(x.device)
        x, got = x[e], got[e]
    return x.cpu(), a.cpu(), b.cpu(), kw, got.cpu()


def hash_shape_record(key, args, calls, sp, W):
    """The hash kernel at one (phase, kind) of a path, on the first call's
    inputs: BITWISE its plain version on the card, and on a sample of
    HASH_SAMPLE rows the CPU's plain version (the function hash_h runs
    there) and, with the tables side by side, hash_h of each table of
    ``sp`` on the CPU (unless sp is None).  Times: the kernel, the plain version, the bound (bytes: every
    input read once, the output written once; operations: 2 d K a row at
    the float32 peak), the arithmetic floor without fused multiply-adds
    (2 d K instructions a row at half that peak), calls x (ms - bound)
    and, for the Map phase, torch.matmul plus the add, division and floor
    as a yardstick (not one call, not bitwise)."""
    import torch
    from repro_torch.core.hashing import hash_h
    from repro_torch.kernels import lsh_hash as klh
    from repro_torch.kernels import ref
    x, a, b, kw = args
    ms, got = timed(lambda: klh.lsh_hash_cuda(x, a, b, **kw), REPS)
    plain_ms, want = timed(lambda: ref.lsh_hash_ref(x, a, b, **kw), 1)
    check(torch.equal(got, want),
          f"lsh_hash {key}: kernel differs from its plain version on "
          f"{float((got != want).double().mean())} of the outputs")
    # rows holding a NaN are the receive buffer's empty slots, which
    # nothing reads: float -> int32 of NaN is 0 on the card and INT_MIN on
    # x86, so those rows are counted and left out of the CPU comparison
    xs, as_, bs, kws, gs = _hash_sample(x, a, b, kw, got)
    fin = torch.isfinite(xs.float()).all(dim=-1)
    check(torch.equal(gs[fin], klh.lsh_hash_cuda(xs, as_, bs, **kws)[fin]),
          f"lsh_hash {key}: kernel differs from the CPU's plain version")
    d, K = a.shape[-2:]
    if sp is not None and a.dim() == 2 and x.dtype == torch.float32:
        # H, the tables side by side
        k, cpu = sp.A.shape[-1], sp.to("cpu")
        for t in range(K // k):
            check(torch.equal(gs[fin][:, k * t:k * (t + 1)],
                              hash_h(cpu.table(t), xs[fin], W)),
                  f"lsh_hash {key}: table {t} differs from CPU hash_h")
    n = x.numel() // d
    table = kw.get("table")
    nbytes = (x.numel() * x.element_size() + a.numel() * 4 + b.numel() * 4
              + (table.numel() * 4 if table is not None else 0) + n * K * 4)
    flops = 2.0 * n * d * K
    bound, by = ha.bound_of(flops, ha.PEAK_F32_FLOPS, nbytes)
    nonfused = flops / (ha.PEAK_F32_FLOPS / 2) * 1e3
    chain_ms = None
    if a.dim() == 2:
        w = torch.tensor(kw["w"], dtype=torch.float32, device=x.device)
        chain_ms, _ = timed(lambda: torch.floor(
            (torch.matmul(x.float(), a) + b) / w).to(torch.int32), REPS)
    rec = {"shape": key, "x": list(x.shape), "dtype": str(x.dtype),
           "K": int(K), "tables": int(a.shape[0]) if a.dim() == 3 else 1,
           "calls": calls, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "bytes": nbytes,
           "nonfused_floor_ms": nonfused, "loss_ms": calls * (ms - bound),
           "matmul_chain_ms": chain_ms, "cpu_rows": int(fin.sum()),
           "nan_rows": int((~fin).sum()), "bitwise": True}
    print(f"lsh_hash {key}: x {tuple(x.shape)} {x.dtype} K={K} "
          f"tables {rec['tables']}, {calls} calls: {ms:.4f} ms (plain "
          f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}: "
          f"{nbytes / 1e9:.4f} GB; non-fused floor {nonfused:.4f} ms), "
          f"calls x (ms - bound) {rec['loss_ms']:.4f} ms"
          + (f", torch.matmul + add + div + floor {chain_ms:.4f} ms (not "
             f"one call, not bitwise)" if chain_ms is not None else "")
          + f"); bitwise equal to its plain version and, on "
          f"{rec['cpu_rows']} rows, to the CPU's ({rec['nan_rows']} empty "
          f"slots of NaN left out)")
    return rec


def hash_records(hcalls, sp, W):
    """hash_shape_record of every (phase, kind) a path called."""
    return [hash_shape_record(key, args, hcalls.count[key], sp, W)
            for key, args in hcalls.first.items()]


def lsh_hash_record(shapes, launches, own_launches):
    """The hash kernel's record: the Map phase's numbers (the index's
    build) as its ms, plain ms and bound; every other shape beside."""
    main = next(r for r in shapes if r["path"] == "index"
                and r["shape"] == "build: H cols")
    return {
        "name": "lsh_hash", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lsh_hash.cu",
        "replaces": "src/repro/kernels/lsh_hash.py:34",
        "launches": launches["index"], "max_abs_err": 0.0,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "nonfused_floor_ms": main["nonfused_floor_ms"],
        "matmul_chain_ms": main["matmul_chain_ms"],
        "loss_ms": {p: sum(r["loss_ms"] for r in shapes if r["path"] == p)
                    for p in launches},
        "launches_by_path": launches, "ops_lsh_hash_launches": own_launches,
        "shapes": shapes}


def topk_swaps(name, got, want, tol=1e-5):
    """Two (dist, gid) top-K answers (m, K): distances within rtol = atol =
    tol, gids equal except where two neighbours' distances agree within
    tol (the gid then sits in the other answer at such a distance, or
    ties that answer's last kept one).  Returns the swapped positions."""
    import numpy as np
    gd, gg = (np.asarray(a) for a in got)
    wd, wg = (np.asarray(a) for a in want)
    fin = np.isfinite(wd)
    check(np.array_equal(np.isfinite(gd), fin)
          and np.allclose(gd[fin], wd[fin], rtol=tol, atol=tol),
          f"{name}: distances differ beyond {tol}")
    swaps = 0
    for r, c in zip(*np.nonzero(gg != wg)):
        at = np.nonzero(wg[r] == gg[r, c])[0]
        ref_d = wd[r, at] if len(at) else wd[r, -1:]
        check(np.isclose(ref_d, gd[r, c], rtol=tol, atol=tol).any(),
              f"{name}: row {r} gid {gg[r, c]} at {gd[r, c]} is no tie")
        swaps += 1
    return swaps


def same_report(name, got, want):
    """Every field of two simulator reports equal (arrays elementwise)."""
    import dataclasses
    import numpy as np
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        check(np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b,
              f"{name}: {f.name} {a} on the card, {b} on the CPU")


def _timed_sim(fn):
    """fn() and its host seconds, ending in a device sync."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def simulate_path(args, oracle):
    """The analytic simulator, the brute-force oracle, Multi-Probe LSH and
    the datasets on the card at the paper's Random scale; returns the
    hash kernel's launches on the path and its HashCalls."""
    import numpy as np
    import torch
    from repro_torch.core import (LSHConfig, Scheme, lsh_topk_reference,
                                  nearest_neighbors, simulate,
                                  simulate_stream)
    from repro_torch.data import dedup_embeddings, planted_random, tfidf_like
    from repro_torch.kernels import lsh_hash as klh

    # ---- the path: counts to 0, drive, read ------------------------------
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    hcalls = HashCalls().__enter__()
    t_path = time.perf_counter()

    # ---- the index's served bucket against its single-machine oracle ----
    hcalls.phase = "oracle"
    cfg, data, queries, served = oracle
    (refd, refg), secs = _timed_sim(lambda: lsh_topk_reference(
        cfg, data, queries, served[1].shape[1], data_chunk=1 << 16))
    swaps = topk_swaps("index vs lsh_topk_reference", served, (refd, refg))
    print(f"phase oracle: lsh_topk_reference over {len(data)} points (T = "
          f"{cfg.n_tables}) for query ids 0-{len(queries) - 1}, {secs:.2f} "
          f"s: the index's served bucket equal ({swaps} tie swaps, "
          f"{int(np.isfinite(refd).sum())} neighbours)")

    # ---- Random at the paper's size, drawn on the card ------------------
    hcalls.phase = "fig41"
    d, W, k, r, c = SIM_DATASETS["random"]
    (data, queries, planted), secs = _timed_sim(lambda: planted_random(
        SIM_N, SIM_M, d=d, r=r, seed=args.seed))
    print(f"phase random: planted_random({SIM_N}, {SIM_M}, d={d}) on the "
          f"card, {secs:.2f} s")
    for L in SIM_L:
        rows = {}
        for scheme in (Scheme.SIMPLE, Scheme.LAYERED):
            rcfg = LSHConfig(d=d, k=k, W=W, r=r, c=c, L=L,
                             n_shards=SIM_SHARDS, scheme=scheme, seed=0)
            rep, secs = _timed_sim(lambda: simulate(rcfg, data, queries))
            check(rep.overflow_drops == 0, "simulate dropped rows")
            rows[scheme] = rep.query_rows
            print(f"fig41 L={L} {scheme.value}: query_rows {rep.query_rows} "
                  f"fq_mean {rep.fq_mean} fq_bound {rep.fq_bound} "
                  f"query load max {rep.query_load_max}, {secs:.2f} s")
            if scheme == Scheme.LAYERED:
                check(rep.fq_mean <= rep.fq_bound,
                      f"L={L}: layered fq {rep.fq_mean} above its "
                      f"Theorem 8 bound {rep.fq_bound}")
        check(rows[Scheme.LAYERED] < rows[Scheme.SIMPLE],
              f"L={L}: layered ships no fewer rows than simple")
        print(f"fig41 L={L}: SIMPLE / LAYERED rows "
              f"{rows[Scheme.SIMPLE] / rows[Scheme.LAYERED]}")

    # ---- recall against all points, entropy and Multi-Probe -------------
    hcalls.phase = "recall"
    for probes in ("entropy", "mplsh"):
        rcfg = LSHConfig(d=d, k=k, W=W, r=r, c=c, L=16, n_shards=SIM_SHARDS,
                         scheme=Scheme.LAYERED, seed=0, probes=probes)
        rep, secs = _timed_sim(lambda: simulate(
            rcfg, data, queries[:RECALL_M], compute_recall=True,
            k_neighbors=10, data_chunk=1 << 16))
        # each recalled query emitted at least one candidate within cr
        check(0 <= rep.recall <= 1 and 0 <= rep.recall_at_k <= 1
              and rep.results_emitted >= rep.recall * RECALL_M,
              f"recall {rep.recall}, recall@10 {rep.recall_at_k}, "
              f"emitted {rep.results_emitted}")
        print(f"recall {probes} L=16: recall {rep.recall} recall@10 "
              f"{rep.recall_at_k} emitted {rep.results_emitted} fq_mean "
              f"{rep.fq_mean} ({RECALL_M} queries against {SIM_N} points), "
              f"{secs:.2f} s")

    # ---- the card against the CPU on a sample ---------------------------
    # the first SAMPLE_N points and the first SAMPLE_M queries planted at
    # one of them, so that near pairs lie inside the sample
    sd = data[:SAMPLE_N]
    sq = queries[torch.nonzero(planted < SAMPLE_N)[:SAMPLE_M, 0]]
    check(len(sq) == SAMPLE_M, "too few queries planted in the sample")
    host = dict(data=sd.cpu(), queries=sq.cpu())
    card = dict(data=sd, queries=sq)

    def card_and_cpu(phase, fn):
        """fn(data, queries, device) on the card under phase, then on the
        CPU under phase + " cpu"."""
        hcalls.phase = phase
        got = fn(**card, device=None)
        hcalls.phase = phase + " cpu"
        return got, fn(**host, device="cpu")

    t0 = time.perf_counter()
    for scheme, probes, Ws in ((Scheme.LAYERED, "entropy", W),
                               (Scheme.SIMPLE, "entropy", W),
                               (Scheme.LAYERED, "mplsh", W),
                               (Scheme.LAYERED, "entropy", SAMPLE_WIDE_W)):
        rcfg = LSHConfig(d=d, k=k, W=Ws, r=r, c=c, L=16, n_shards=SIM_SHARDS,
                         scheme=scheme, seed=0, probes=probes)
        got, want = card_and_cpu("sample", lambda **kw: simulate(
            rcfg, compute_recall=True, k_neighbors=10, **kw))
        same_report(f"simulate {scheme.value} {probes} W={Ws}", got, want)
        print(f"sample {scheme.value} {probes} W={Ws}: recall {got.recall} "
              f"recall@10 {got.recall_at_k} query_rows {got.query_rows}")
    # at the wide W the sample's planted pairs meet: the recall fields
    # compared above are not all zero
    check(got.recall > 0 and got.recall_at_k > 0,
          f"W={SAMPLE_WIDE_W}: the sample recalls nothing")
    rcfg = LSHConfig(d=d, k=k, W=W, r=r, c=c, L=16, n_shards=SIM_SHARDS,
                     scheme=Scheme.LAYERED, seed=0, n_tables=2)
    same_report("simulate_stream", *card_and_cpu(
        "sample", lambda **kw: simulate_stream(
            rcfg, n_prefix=SAMPLE_N // 2, insert_batch=SAMPLE_N // 8,
            query_batch=256, **kw)))
    hcalls.phase = "sample"
    swaps = topk_swaps("nearest_neighbors", nearest_neighbors(sd, sq, 10),
                       nearest_neighbors(host["data"], host["queries"], 10,
                                         device="cpu"))
    print(f"phase sample: {SAMPLE_N} points, {SAMPLE_M} queries planted "
          f"among them: simulate (layered, simple, layered mplsh at W={W}; "
          f"layered at W={SAMPLE_WIDE_W}; recall@10), simulate_stream "
          f"(T = 2) equal on the card and the CPU in every field; "
          f"nearest_neighbors top-10 within 1e-5, {swaps} tie swaps; "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- dedup on the sample with its near-duplicate queries ------------
    t0 = time.perf_counter()
    keep, want = card_and_cpu("dedup", lambda data, queries, device:
                              dedup_embeddings(torch.cat([data, queries]),
                                               r=r, W=DEDUP_W, device=device))
    secs = time.perf_counter() - t0
    drops = int((~keep).sum())
    check(drops > 0, "dedup dropped no row: the comparison sees nothing")
    check(np.array_equal(keep, want),
          "dedup keep-masks differ between the card and the CPU")
    print(f"phase dedup: {len(keep)} rows (W={DEDUP_W}), {drops} dropped "
          f"({int((~keep[SAMPLE_N:]).sum())} of the {SAMPLE_M} planted "
          f"queries), the keep-mask equal on the card and the CPU, "
          f"{secs:.2f} s with the CPU's run")
    print(f"CPU reference hashes (no launch): {hcalls.cpu}")
    del data, queries, planted, sd, sq, card, host

    # ---- Table 1: the Wiki stand-in on 1024 shards ----------------------
    hcalls.phase = "table1"
    d, W, k, r, c = SIM_DATASETS["wiki"]
    (wiki, secs) = _timed_sim(lambda: [torch.from_numpy(a).cuda()
                                       for a in tfidf_like(SIM_N, SIM_M, d=d)])
    print(f"phase wiki: tfidf_like({SIM_N}, {SIM_M}, d={d}) on the host, "
          f"{secs:.2f} s")
    for scheme in Scheme:
        rcfg = LSHConfig(d=d, k=k, W=W, r=r, c=c, L=16, n_shards=1024,
                         scheme=scheme, seed=0)
        rep, secs = _timed_sim(lambda: simulate(rcfg, *wiki))
        print(f"table1 {scheme.value}: data load avg {rep.data_load_avg} "
              f"max {rep.data_load_max}, query load avg "
              f"{rep.query_load_avg} max {rep.query_load_max}, "
              f"query_rows {rep.query_rows}, {secs:.2f} s")
    del wiki
    torch.cuda.synchronize()
    hcalls.__exit__()
    launches = klh.lsh_hash_cuda.launches
    print(f"launches on the simulate path: {{'lsh_hash': {launches}}}; by "
          f"phase and kind: {hcalls.count}; "
          f"{time.perf_counter() - t_path:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check(launches > 0 and launches == sum(hcalls.count.values()),
          "every hash of the simulate path must launch the hash kernel")
    return launches, hcalls


def device_ms(fn, reps=5):
    """Device time of one fn() call in ms, its kernels' times summed
    (torch.profiler, mean of reps calls after a warm one): the card's
    share of the CUDA-event time, without the host's launch gaps.
    Returns it and the kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    parts = {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
             e.self_device_time_total / 1e3 / reps for e in rows}
    return sum(parts.values()), parts


def host_ms(fn, reps=REPS):
    """Host time of one fn() call in ms: the mean over reps calls issued
    back to back, without waiting for the device (a sync follows)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def same_bits(name, a, b):
    """Two launches on the same inputs must give the same bits."""
    import torch
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        check(torch.equal(x, y), f"{name}: two launches differ")


def matched_pairs(query, store, L):
    """(row, slot) pairs of the full scan's inputs that can hit -- the
    slot is valid and its (table, bucket) one the row probes (a row
    probing a bucket twice counts each slot once) -- and the distinct
    slots among them (a slot several rows match is one slot)."""
    import torch
    u32 = lambda t: t.to(torch.int64) & 0xFFFFFFFF
    S, R = query.probe.shape[:2]
    qb = query.buckets.reshape(S, R, L, 2)
    total = slots = 0
    for s in range(S):
        on = query.probe[s] > 0
        rows = torch.arange(R, device=on.device)[:, None].expand(R, L)[on]
        tab = query.table[s][:, None].expand(R, L)[on].to(torch.int64)
        keys = torch.unique(torch.stack(
            [tab, u32(qb[s, ..., 0])[on], u32(qb[s, ..., 1])[on], rows], 1),
            dim=0)[:, :3]
        ok = store.valid[s] > 0
        skeys = torch.stack([store.table[s][ok].to(torch.int64),
                             u32(store.buckets[s, :, 0][ok]),
                             u32(store.buckets[s, :, 1][ok])], 1)
        both = torch.cat([keys, skeys])
        if both.shape[0] == 0:
            continue
        _, inv = torch.unique(both, dim=0, return_inverse=True)
        n = int(inv.max()) + 1
        per_row = torch.zeros(n, dtype=torch.int64, device=inv.device)
        per_slot = torch.zeros_like(per_row)
        per_row.index_add_(0, inv[:len(keys)], torch.ones_like(
            inv[:len(keys)]))
        per_slot.index_add_(0, inv[len(keys):], torch.ones_like(
            inv[len(keys):]))
        total += int((per_row * per_slot).sum())
        slots += int(per_slot[per_row > 0].sum())
    return total, slots


def bucket_search_record(kw, launches):
    """The full-scan kernel against its plain version at the arguments
    kw of one of its calls, and launched twice to the same bits; returns
    its kernel record."""
    from repro_torch.kernels import bucket_search as kbs
    from repro_torch.kernels import ref
    query, store = kw["query"], kw["store"]
    d, K, L = query.q.shape[-1], kw["K"], kw["L"]
    ms, got = timed(lambda: kbs.bucket_search_cuda(**kw), REPS)
    same_bits("bucket_search", got, kbs.bucket_search_cuda(**kw))
    dev_ms, parts = device_ms(lambda: kbs.bucket_search_cuda(**kw))
    enq_ms = host_ms(lambda: kbs.bucket_search_cuda(**kw))
    plain_ms, want = timed(lambda: ref.bucket_search_ref(**kw), 1)
    err = compare("bucket_search", got, want)
    live_s = (query.probe > 0).any(dim=-1).sum(dim=-1)
    valid_s = (store.valid > 0).sum(dim=-1)
    live_rows, valid_pts = int(live_s.sum()), int(valid_s.sum())
    S, R, N = store.points.shape[0], query.q.shape[1], store.points.shape[1]
    (pairs, slots), hits = matched_pairs(query, store, L), int(got[2].sum())
    out_bytes = S * R * (K * 8 + 4)
    row_bytes = live_rows * (d * 4 + 4 + 8 * L + 4 * L + 4)
    # what these inputs need: every scanned slot's liveness, every valid
    # slot's table and bucket, every matched slot's point row, psq and
    # gid (once, however many rows match it), the live rows' queries and
    # probes, the outputs; the matched pairs' dots
    bound, by = ha.bound_of(2.0 * pairs * d, ha.PEAK_F32_FLOPS,
                         S * N * 4 + valid_pts * 12 + slots * (d * 4 + 8)
                         + row_bytes + out_bytes)
    # the dense design's count: every live row against every
    # valid point of its shard
    dense, _ = ha.bound_of(
        2.0 * float((live_s.double() * valid_s.double()).sum()) * d,
        ha.PEAK_F32_FLOPS, valid_pts * (d * 4 + 24) + row_bytes + out_bytes)
    print(f"bucket_search d={d} K={K}: S={S} R={R} live rows {live_rows} "
          f"{live_s.tolist()} N={N} valid {valid_pts} matched pairs {pairs} "
          f"on {slots} slots, hits {hits}: "
          f"{ms:.4f} ms (plain {plain_ms:.1f} ms, bound {bound:.4f} ms "
          f"({by}), dense-design bound {dense:.4f} ms), max |d2 err| "
          f"{err:.3g}, two launches bitwise equal; host {enq_ms:.4f} ms a "
          f"call, device {dev_ms:.4f} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    return {
        "name": "bucket_search", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bucket_search.cu",
        "replaces": "src/repro/kernels/bucket_search.py:168",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "dense_bound_ms": dense,
        "matched_pairs": pairs, "matched_slots": slots, "device_ms": dev_ms,
        "host_ms": enq_ms}


def bucket_gather_record(a, kw, launches):
    """The gather kernel against its plain version, and launched twice
    to the same bits; its kernel record."""
    import torch
    from repro_torch.kernels import bucket_search as kbs
    from repro_torch.kernels import ref
    ms, got = timed(lambda: kbs.bucket_gather_cuda(*a, **kw), REPS)
    same_bits("bucket_gather", got, kbs.bucket_gather_cuda(*a, **kw))
    dev_ms, _ = device_ms(lambda: kbs.bucket_gather_cuda(*a, **kw))
    enq_ms = host_ms(lambda: kbs.bucket_gather_cuda(*a, **kw))
    plain_ms, want = timed(lambda: ref.bucket_gather_ref(*a, **kw), 1)
    err = compare("bucket_gather", got, want)
    q, qsq, start, end, _, _, _, pvalid = a[:8]
    S, E, d = q.shape
    K = kw["K"]
    span = (end - start).clamp_min(0).to(torch.int64)
    touched = int(span.sum())
    live_e = int((span > 0).sum())
    # (expanded row, point) pairs of the spans whose point is valid, and
    # the distinct slots the spans cover (rows probing one bucket share
    # its span), valid or not
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
    # every expanded row's span, the live rows' queries and norms, every
    # spanned slot's liveness and every valid one's point row, psq and
    # gid (each once, however many rows span it), the outputs; the valid
    # pairs' dots
    bound, by = ha.bound_of(2.0 * pairs * d, ha.PEAK_F32_FLOPS,
                         S * E * 8 + live_e * (d * 4 + 4) + spanned * 4
                         + slots * (d * 4 + 8) + out_bytes)
    # every spanned slot's row and columns, valid or not
    dense, _ = ha.bound_of(2.0 * touched * d, ha.PEAK_F32_FLOPS,
                        touched * (d * 4 + 12) + live_e * (d * 4 + 12)
                        + out_bytes)
    print(f"bucket_gather: S={S} E={E} live {live_e} rows touched "
          f"{touched} valid pairs {pairs} on {slots} slots ({spanned} spanned), "
          f"hits {int(got[2].sum())}: "
          f"{ms:.4f} ms (plain {plain_ms:.1f} ms, bound {bound:.4f} ms "
          f"({by}), spanned-slot bound {dense:.4f} ms), two launches bitwise "
          f"equal; host {enq_ms:.4f} ms a call, device {dev_ms:.4f} ms")
    return {
        "name": "bucket_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bucket_search.cu",
        "replaces": "src/repro/kernels/bucket_search.py:269",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "dense_bound_ms": dense,
        "matched_pairs": pairs, "matched_slots": slots, "device_ms": dev_ms,
        "host_ms": enq_ms}


def warm_restart(svc, snap_dir, cfg, model, build_kw, tokens, answer):
    """Stop the durable pipelined service, warm-restart it from its
    snapshot directory (restore + WAL replay of the streamed insert) and
    answer ``tokens`` again: the same gids, bitwise the same distances.
    Returns the restarted (stopped) service; removes the directory."""
    import numpy as np
    import torch
    from repro_torch.serving import AsyncLSHService, RetrievalService
    svc.close()
    svc.service.wal.close()
    n_live = svc.index.n_live
    t0 = time.perf_counter()
    warm, rr = RetrievalService.recover_or_build(
        cfg, model, None, snapshot_dir=snap_dir.name, pipelined=True,
        **build_kw)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    try:
        check(rr is not None and isinstance(warm.service, AsyncLSHService),
              "warm restart through recover()")
        check(rr.replayed_inserts == 1 and rr.index.n_live == n_live,
              f"warm restart replayed {rr.replayed_inserts} inserts, "
              f"{rr.index.n_live} of {n_live} rows")
        g, dist, _ = warm.query(tokens)
        check(np.array_equal(g, answer[0])
              and np.array_equal(dist.view(np.uint32),
                                 answer[1].view(np.uint32)),
              "the warm-restarted service answers differently")
        print(f"phase warm_restart {cfg.name}: step {rr.step}, "
              f"{rr.index.n_live} rows, {rr.replayed_inserts} insert "
              f"replayed, {t_warm:.2f} s; the last batch answered with "
              f"the same gids and distances")
    finally:
        warm.close()
        rr.wal.close()
        snap_dir.cleanup()
    return warm


def retrieval_path(args, captured, arch, durable=False):
    """``arch`` at its published width behind the retrieval service;
    returns its launch counts, the service and the query tokens.
    ``durable`` builds through ``recover_or_build`` with a snapshot
    directory and the pipelined front, and ends with a warm restart."""
    import importlib

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import Scheme, prng
    from repro_torch.kernels import bucket_search as kbs
    from repro_torch.kernels import lsh_hash as klh
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import RetrievalService, embed_texts

    width, doc_len, kname, slack = RETRIEVAL_ARCHS[arch]
    kmod = importlib.import_module(f"repro_torch.kernels.{kname}")
    kernel = getattr(kmod, f"{kname}_cuda")
    cfg = get_config(arch)
    check((cfg.n_layers, cfg.d_model, cfg.cdtype) == (*width,
                                                      torch.bfloat16),
          f"{arch} must run at its published width")
    t0 = time.perf_counter()
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase init_model: {cfg.name}, {n_params / 1e9:.3f} B params, "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed)
    docs = rng.integers(0, cfg.vocab, (N_DOCS, doc_len))
    new = rng.integers(0, cfg.vocab, (N_NEW, doc_len))
    # the query draws of serve.py (PRNGKey(2) folded with the batch)
    srcs = [prng.randint(prng.fold_in(prng.PRNGKey(2), b), (BATCH,), 0,
                         N_DOCS if b < QUERY_BATCHES else N_NEW).numpy()
            for b in range(QUERY_BATCHES + 1)]
    setattr(ops, f"{kname}_cuda", recorder(captured, kname, kernel))
    ops.bucket_search_cuda = recorder(captured, f"bucket_search_{arch}",
                                      kbs.bucket_search_cuda)

    # ---- the path: counts to 0, drive, read ------------------------------
    kmod.reset_launches()
    kbs.bucket_search_cuda.launches = 0
    kbs.bucket_gather_cuda.launches = 0
    klh.lsh_hash_cuda.launches = 0
    hcalls = HashCalls().__enter__()
    t0 = time.perf_counter()
    build_kw = dict(n_shards=8, scheme=Scheme.LAYERED, seed=args.seed,
                    bucket_size=BATCH, max_latency_ms=float("inf"),
                    slack=slack, **RETRIEVAL_LSH)
    snap_dir = None
    if durable:
        # the durable pipelined service: boot snapshot + WAL, async front
        snap_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_warm_")
        svc, rr = RetrievalService.recover_or_build(
            cfg, model, docs, snapshot_dir=snap_dir.name, pipelined=True,
            **build_kw)
        check(rr is None and svc.service.wal is not None,
              "a cold durable build")
    else:
        svc = RetrievalService.build(cfg, model, docs, **build_kw)
    torch.cuda.synchronize()
    idx = svc.index
    check(idx.a2a.calls == 1, "build: one exchange")
    check(idx.build_result.drops == 0,
          f"build: {idx.build_result.drops} drops, load "
          f"{idx.shard_load.tolist()}")
    print(f"phase build_retrieval {arch}: {N_DOCS} docs of {doc_len} "
          f"tokens embedded and indexed in "
          f"{time.perf_counter() - t0:.1f} s, d={idx.cfg.d}, load "
          f"{idx.shard_load.tolist()}")
    hits, query_ms, answers = [], [], []
    hcalls.phase = "bucket"
    for b, src in enumerate(srcs):
        if b == QUERY_BATCHES:
            calls = idx.a2a.calls
            hcalls.phase = "insert"
            gids = svc.insert_docs(new)
            hcalls.phase = "bucket"
            check(idx.a2a.calls == calls + 1, "insert must exchange once")
            check(np.array_equal(gids, np.arange(N_DOCS, N_DOCS + N_NEW)),
                  "inserted gids")
        tokens = docs[src] if b < QUERY_BATCHES else new[src]
        want = src if b < QUERY_BATCHES else gids[src]
        calls = idx.a2a.calls
        t0 = time.perf_counter()
        g, dist, _ = svc.query(tokens)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        answers.append((g, dist))
        check(idx.a2a.calls == calls + 2, "a query must exchange twice")
        check(g.shape == (BATCH, 1), "answer shape")
        found = g[:, 0] != IMAX
        check(np.all(dist[found, 0] <= idx.cfg.c * idx.cfg.r * (1 + 1e-5))
              and np.all(np.isinf(dist[~found, 0])), "answers within cr")
        hits.append(g[:, 0] == want)
    torch.cuda.synchronize()
    hcalls.__exit__()
    launches = {kname: kernel.launches,
                "bucket_search": kbs.bucket_search_cuda.launches,
                "bucket_gather": kbs.bucket_gather_cuda.launches,
                "lsh_hash": klh.lsh_hash_cuda.launches}
    by_design = dict(kernel.launches_by_design)
    forwards = (N_DOCS + N_NEW) // BATCH + len(srcs)
    print(f"launches on the {arch} retrieval path: {launches} over "
          f"{forwards} forwards; {kname} by design {by_design}")
    check(launches[kname] == cfg.n_layers * forwards,
          f"the {kname} kernel must launch once per layer and forward")
    check(by_design["tensor_core"] == launches[kname],
          f"every {kname} launch of the path must take the tensor-core "
          f"design: {by_design}")
    check(launches["bucket_search"] > 0, "the full scan never launched")
    check(launches["lsh_hash"] == sum(hcalls.count.values())
          and hcalls.count.get("bucket: H table", 0) > 0
          and hcalls.count.get("build: H cols", 0) > 0,
          f"every hash of the path must launch the hash kernel: "
          f"{hcalls.count}")
    print(f"lsh_hash on the {arch} retrieval path by phase and kind: "
          f"{hcalls.count}")
    st = svc.service.stats
    check(st.drops == 0, "capacity drops in serving")
    share = float(np.mean(np.concatenate(hits)))
    print(f"retrieval {arch}: query ms per batch of {BATCH} (embed + serve) "
          f"{[round(t, 2) for t in query_ms]}, drops {st.drops}, "
          f"exchanges {idx.a2a.calls} (1 build + 1 insert + 2 x "
          f"{len(srcs)} queries), top-1 is the source document for "
          f"{share:.4f} of {len(srcs) * BATCH} exact duplicates")
    check(share > 0.0, "no query found its own document: a broken path")
    embed_ms, emb = timed(lambda: embed_texts(model, docs[srcs[0]]), 3)
    check(bool(torch.isfinite(emb).all()), "non-finite embeddings")
    cos = (emb @ emb.T)[~torch.eye(len(emb), dtype=torch.bool,
                                   device=emb.device)]
    print(f"retrieval {arch}: embed {embed_ms:.2f} ms per {BATCH}-document "
          f"batch of {doc_len} tokens (CUDA events, mean of 3), serve "
          f"{1e3 * st.query_time_s / st.batches:.2f} ms per bucket "
          f"({'async front: union of submit-to-retire intervals' if durable else 'sync service: flush time'}); "
          f"pairwise cosine of a batch's embeddings: mean "
          f"{float(cos.mean()):.4f}, min {float(cos.min()):.4f}")
    profile_forward(model, docs[srcs[0]], kname)
    if durable:
        svc = warm_restart(svc, snap_dir, cfg, model, build_kw,
                           new[srcs[-1]], answers[-1])
    return (launches, by_design, svc,
            [docs[s] for s in srcs[:-1]] + [new[srcs[-1]]], hcalls)


def wide_scan_checks(svc, query_tokens):
    """At d = 3072 the full scan's answers are bitwise equal to the CSR
    gather's, on the retrieval index as the path left it and after a
    compact()."""
    import numpy as np
    import torch
    from repro_torch.serving import embed_texts
    idx = svc.index
    qs = [embed_texts(svc.model, t) for t in query_tokens]

    def answers():
        out = []
        for q in qs:
            r = idx.query(q)
            out.append((r.topk_gid, r.topk_dist.view(np.uint32),
                        r.n_within_cr))
        return out
    for when in ("as served", "after compact()"):
        if when != "as served":
            idx.compact()
        idx.use_csr = True
        csr = answers()
        idx.use_csr = False
        full = answers()
        idx.use_csr = True
        check(all(np.array_equal(a, b) for x, y in zip(csr, full)
                  for a, b in zip(x, y)),
              f"d=3072 {when}: CSR answers differ from the full scan's")
        print(f"wide scan {when}: n_sorted {idx.store.n_sorted}, CSR "
              f"bitwise equal to the full scan")
    torch.cuda.synchronize()


def flash_rows(got, want, where):
    """The flash output against its plain version's row by row: each
    row's largest |error| over its largest |o|, checked within
    FLASH_ROW_TOL.  Returns that and the median |o|."""
    mag = want.float().abs()
    err = (got.float() - want.float()).abs().amax(-1)
    row_err = float((err / mag.amax(-1).clamp_min(1e-30)).max())
    check(row_err <= FLASH_ROW_TOL,
          f"flash_attention differs from its plain version by {row_err} of "
          f"a row's largest |o| at {where} (tolerance {FLASH_ROW_TOL})")
    return row_err, float(mag.median())


def flash_measure(q, k, v, causal, where):
    """The flash kernel at q, k, v: its design (which must be
    "tensor_core"), ms beside its plain version's and
    ``scaled_dot_product_attention``'s, its error against the plain
    version (within BF16_TOL, and each row within FLASH_ROW_TOL of its
    largest |o|) and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    design = kfa.plan(q.dtype, q.shape[-1], q.shape[2], strides=[
        s for t in (q, k, v, q) for s in t.stride()[:3]],
        aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v))).design
    check(design == "tensor_core", f"flash_attention plans {design}")
    ms, got = timed(lambda: kfa.flash_attention_cuda(q, k, v,
                                                     causal=causal), REPS)
    plain_ms, want = timed(lambda: ref.attention_ref(q, k, v,
                                                     causal=causal), 1)
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=BF16_TOL,
                         atol=BF16_TOL),
          f"flash_attention differs from its plain version by {err} at "
          f"{where}")
    row_err, median = flash_rows(got, want, where)
    del want
    library_ms, _ = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, **_gqa(q, k)), REPS)
    B, H, S, dh = q.shape
    flops, nbytes = ha.flash_fwd_cost(
        B, H, k.shape[1], S, k.shape[2], dh, v.shape[-1], causal=causal,
        itemsize=q.element_size())
    bound, by = ha.bound_of(flops, ha.PEAK_FLOPS, nbytes)
    print(f"flash_attention ({design}) at {where}: q {tuple(q.shape)} "
          f"{q.dtype}, v {tuple(v.shape)} strides {v.stride()}: {ms:.4f} ms "
          f"(plain {plain_ms:.3f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms, bound {bound:.4f} ms: {nbytes / 1e6:.1f} "
          f"MB, {flops / 1e9:.2f} GFLOP), max |err| {err:.3g}; by row, "
          f"{row_err:.3g} of the row's largest |o| (tolerance "
          f"{FLASH_ROW_TOL}); median |o| {median:.3g}")
    return {"design": design, "max_abs_err": err,
            "max_rel_err_by_row": row_err, "median_abs_out": median,
            "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms}


def _gqa(q, k):
    """``scaled_dot_product_attention``'s keyword for grouped kv heads,
    where q has more heads than k (granite's 16 against 8)."""
    return {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}


def flash_record(a, kw, launches, by_design, hmma):
    """The flash kernel against its plain version and PyTorch's fused
    attention at one layer's q, k, v of a 64-document batch."""
    q, k, v = a
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:74",
        "launches": launches,
        **flash_measure(q, k, v, kw.get("causal", True),
                        "the retrieval path's inputs"),
        "launches_by_design": by_design, "sass_hmma": hmma}


def ssd_record(a, kw, launches, by_design, hmma):
    """The SSD kernel against its plain version (the sequential scan) at
    one layer's inputs of a 64-document batch; no single PyTorch call
    computes the scan, so there is no library time."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    x, a_log, b, c, dt = a
    _, S, H, P = x.shape
    y_strides = (S * H * P, H * P, P, 1)       # the wrapper's output
    design = kssd.plan(x.dtype, P, b.shape[-1], strides=[
        *x.stride(), *b.stride(), *c.stride(), *y_strides],
        aligned=all(t.data_ptr() % 16 == 0 for t in (x, b, c))).design
    check(design == "tensor_core", f"ssd_scan plans {design}")
    ms, got = timed(lambda: kssd.ssd_scan_cuda(x, a_log, b, c, dt), REPS)
    plain_ms, want = timed(lambda: ref.ssd_scan_ref(x, a_log, b, c, dt), 1)
    check(bool(torch.isfinite(got.float()).all()),
          "ssd_scan gave a non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=BF16_TOL,
                         atol=BF16_TOL),
          f"ssd_scan differs from its plain version by {err}")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q = kssd.CHUNK
    flops, nbytes = ha.ssd_fwd_cost(B, S, H, P, G, N,
                                    itemsize=x.element_size())
    bound, by = ha.bound_of(flops, ha.PEAK_FLOPS, nbytes)
    print(f"ssd_scan ({design}, chunk {Q}): x {tuple(x.shape)} {x.dtype}, "
          f"B/C {tuple(b.shape)}: "
          f"{ms:.4f} ms (plain {plain_ms:.2f} ms, bound {bound:.4f} ms: "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP, which take "
          f"{flops / ha.PEAK_F32_FLOPS * 1e3:.3f} ms at the float32 CUDA-core "
          f"peak), max |err| {err:.3g}")
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:69",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "design": design,
        "launches_by_design": by_design, "sass_hmma": hmma}


def ssd_train_forward(a):
    """The SSD kernel against its plain version at the train path's inputs
    (one layer's x, b, c as the strided views the training forward hands
    it), at the forward record's tolerance: the train path's part of the
    ``ssd_scan`` record."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    x, a_log, b, c, dt = (t.detach() for t in a[:5])
    ms, got = timed(lambda: kssd.ssd_scan_cuda(x, a_log, b, c, dt), REPS)
    plain_ms, want = timed(lambda: ref.ssd_scan_ref(x, a_log, b, c, dt), 1)
    check(bool(torch.isfinite(got.float()).all()),
          "ssd_scan gave a non-finite output at the train path's inputs")
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=BF16_TOL,
                         atol=BF16_TOL),
          f"ssd_scan differs from its plain version by {err} at the train "
          f"path's inputs")
    print(f"ssd_scan at the train path's inputs: x {tuple(x.shape)} "
          f"{x.dtype} strides {x.stride()}, B/C {tuple(b.shape)} strides "
          f"{b.stride()}: {ms:.4f} ms (plain {plain_ms:.2f} ms), max |err| "
          f"{err:.3g} (tolerance {BF16_TOL})")
    return {"train_max_abs_err": err, "train_ms": ms,
            "train_plain_ms": plain_ms}


def _replayed(losses, fail_at, every):
    """The loss trajectory a run with failures at ``fail_at`` records,
    from an uninterrupted run's: the steps since the last checkpoint run
    again after each failure."""
    out, step, fails = [], 0, set(fail_at)
    while step < len(losses):
        if step in fails:
            fails.discard(step)
            step = step // every * every
            continue
        out.append(losses[step])
        step += 1
    return out


def _grad_errors(got, want):
    """{leaf path: relative L2 error} of two gradient trees, and that of
    the whole."""
    from repro_torch.tree import leaves_with_paths
    paths, g = leaves_with_paths(got)
    _, w = leaves_with_paths(want)
    errs, num, den = {}, 0.0, 0.0
    for p, a, b in zip(paths, g, w):
        a, b = a.double(), b.to(a.device).double()
        d2 = float((a - b).square().sum())
        n2 = float(b.square().sum())
        errs[p] = math.sqrt(d2 / max(n2, 1e-30))
        num, den = num + d2, den + n2
    return errs, math.sqrt(num / den)


def f32_card_vs_cpu(c32, m32, few, l32, g32, full_depth, stubs=None):
    """float32 at the published width on a short batch: the card's loss
    and gradients (the SSD kernels) against the CPU's plain versions'
    (``l32``, ``g32`` of the CPU model ``m32``).  Below full depth, at the
    CPU tests' tolerance (rtol = atol = 1e-4 a leaf, loss 1e-5).  At full
    depth float32 rounding alone moves the gradient further than that, so
    the yardstick is the CPU's own gradient after every weight moves one
    ulp (a random sign each): the kernels' gradient must be within
    F32_CHAOS times that distance of the CPU's, and of the card's with
    the plain SSD versions in place of the kernels (the same card
    products).  A wrong gradient is off by ~1, far outside it.
    ``stubs``: the stub frontends' inputs on the CPU, as ``l32`` and
    ``g32`` were taken with them (not at full depth)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import (Transformer, load_param_tree,
                                    param_tree, value_and_grad)
    from repro_torch.tree import tree_map
    depth = c32.n_layers
    k32 = Transformer(c32, "cuda")
    load_param_tree(k32, param_tree(m32))
    card_few = tuple(t.cuda() for t in few)
    lk, gk = value_and_grad(k32, *card_few, **{
        k: t.cuda() for k, t in (stubs or {}).items()})
    far = {p: float((a.cpu() - b).abs().max())
           for p, a, b in zip(*_flatten_pair(gk, g32))}
    errs, whole = _grad_errors(gk, g32)
    worst = max(errs, key=errs.get)
    loss_rel = abs(float(lk) - float(l32)) / abs(float(l32))
    print(f"train float32, {depth} blocks, 1 x {few[0].shape[1]} tokens: "
          f"loss card {float(lk):.7f} CPU {float(l32):.7f}; gradients "
          f"relative L2 error over all leaves {whole:.4g} (worst leaf "
          f"{worst} {errs[worst]:.4g}), max |card - CPU| "
          f"{max(far.values()):.3g}")
    check(loss_rel <= 1e-5, f"float32 at {depth} blocks: loss card "
          f"{float(lk)} vs CPU {float(l32)}")
    reading = {"loss_card": float(lk), "loss_cpu": float(l32),
               "rel_l2": whole, "max_abs": max(far.values())}
    if not full_depth:
        bad = {p: far[p] for p, a, b in zip(*_flatten_pair(gk, g32))
               if not torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4)}
        check(not bad, f"float32 at {depth} blocks: card gradients differ "
              f"from the CPU's (rtol = atol = 1e-4): {bad}")
        return reading
    gen = torch.Generator().manual_seed(1)
    nudged = Transformer(c32, "cpu")
    load_param_tree(nudged, tree_map(lambda p: torch.nextafter(
        p, torch.where(torch.rand(p.shape, generator=gen) < 0.5,
                       torch.inf, -torch.inf)), param_tree(m32)))
    _, gn = value_and_grad(nudged, *few)
    ulp, ulp_whole = _grad_errors(gn, g32)
    kernels = ops.ssd_scan_cuda, ops.ssd_scan_bwd_cuda
    ops.ssd_scan_cuda, ops.ssd_scan_bwd_cuda = (ref.ssd_scan_ref,
                                                ref.ssd_scan_bwd_ref)
    try:
        _, gq = value_and_grad(k32, *card_few)
    finally:
        ops.ssd_scan_cuda, ops.ssd_scan_bwd_cuda = kernels
    plain_cpu = _grad_errors(gq, g32)[1]
    kern_plain, kp_whole = _grad_errors(gk, gq)
    print(f"train float32, {depth} blocks: the CPU's gradient moved by "
          f"one ulp of every weight: relative L2 {ulp_whole:.4g} (worst "
          f"leaf {max(ulp.values()):.4g}); the card with the plain SSD "
          f"versions against the CPU {plain_cpu:.4g}; the card's kernels "
          f"against its plain SSD versions {kp_whole:.4g} (worst leaf "
          f"{max(kern_plain.values()):.4g}); tolerance {F32_CHAOS} x the "
          f"one-ulp distance, over all leaves")
    check(whole <= F32_CHAOS * ulp_whole and
          kp_whole <= F32_CHAOS * ulp_whole,
          f"float32 at {depth} blocks: the kernels' gradient is further "
          f"from the plain versions' ({whole}, {kp_whole}) than "
          f"{F32_CHAOS} x one ulp's reach ({ulp_whole})")
    reading.update(one_ulp_rel_l2=ulp_whole, card_plain_vs_cpu=plain_cpu,
                   kernels_vs_card_plain=kp_whole)
    return reading


def train_path(args, captured):
    """examples/train_lm_with_dedup_torch.py on the card: dedup through the
    hash kernel, then mamba2-130m at its published width trained through
    the SSD forward and backward kernels, with an injected failure whose
    replay must repeat an uninterrupted run bit for bit.  Returns the
    launch counts, the dedup's HashCalls and the step numbers."""
    import dataclasses

    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "examples"))
    import train_lm_with_dedup_torch as example
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import lsh_hash as klh
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import train
    from repro_torch.models import (Transformer, init_params,
                                    load_param_tree, param_tree,
                                    value_and_grad)

    # ---- stage 1: dedup through the hash kernel ---------------------------
    klh.lsh_hash_cuda.launches = 0
    hcalls = HashCalls().__enter__()
    hcalls.phase = "dedup"
    keep = example.dedup_stage("cuda")
    torch.cuda.synchronize()
    hcalls.__exit__()
    removed = int((~keep[example.N_BASE:]).sum())
    check(keep[:example.N_BASE].all() and removed > 0.9 * example.N_DUPS,
          f"dedup kept an original or missed planted duplicates: "
          f"{removed}/{example.N_DUPS} removed")
    hash_launches = klh.lsh_hash_cuda.launches
    check(hash_launches > 0 and hash_launches == sum(hcalls.count.values()),
          f"every hash of the dedup must launch the hash kernel: "
          f"{hcalls.count}")
    print(f"phase dedup: {removed}/{example.N_DUPS} planted duplicates "
          f"removed, {int(keep.sum())}/{len(keep)} kept; hash launches "
          f"{hcalls.count}")

    # ---- stage 2: training, failure injected, then uninterrupted ----------
    cfg = get_config(TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.ssm.d_state, cfg.cdtype) ==
          (24, 768, 128, torch.bfloat16),
          "mamba2-130m must train at its published width")
    ops.ssd_scan_cuda = kssd.ssd_scan_cuda     # the mamba2 path's recorder
    ops.ssd_scan_bwd_cuda = recorder(captured, "ssd_scan_bwd",
                                     kssd.ssd_scan_bwd_cuda)
    runs = {}
    for name, fail in ((f"failure at step {TRAIN_STEPS // 2}", True),
                       ("uninterrupted", False)):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as ck:
            argv = example.train_argv(
                TRAIN_ARCH, TRAIN_STEPS, True, ck, device="cuda",
                batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                ckpt_every=TRAIN_CKPT_EVERY, fail=fail)
            kssd.reset_launches()
            held = torch.cuda.memory_allocated()   # by the earlier paths
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            stats = train.main(argv + ["--seed", str(args.seed)])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = {"ssd_scan": kssd.ssd_scan_cuda.launches,
                    "ssd_scan_bwd": kssd.ssd_scan_bwd_cuda.launches}
        by_design = dict(kssd.ssd_scan_cuda.launches_by_design)
        bwd_design = dict(kssd.ssd_scan_bwd_cuda.launches_by_design)
        runs[name] = (stats, launches, bwd_design)
        print(f"phase train ({name}): {stats.steps_run} steps, "
              f"{stats.restarts} restarts, {secs:.1f} s with the token "
              f"draws and checkpoints; loss {stats.losses[0]:.4f} -> "
              f"{stats.losses[-1]:.4f}; launches {launches}, forward by "
              f"design {by_design}, gradient by design {bwd_design}; peak "
              f"device memory "
              f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} "
              f"GiB above the {held / 2**30:.2f} GiB held before the run")
        n = stats.steps_run
        check(launches["ssd_scan"] == 2 * cfg.n_layers * n,
              "each step launches the SSD kernel twice a layer (forward "
              "and the rematerialised forward)")
        check(launches["ssd_scan_bwd"] == cfg.n_layers * n,
              "each step launches the SSD gradient kernel once a layer")
        check(by_design["tensor_core"] == launches["ssd_scan"],
              f"every training forward must take the tensor-core design: "
              f"{by_design}")
        check(bwd_design["tensor_core"] == launches["ssd_scan_bwd"],
              f"every training gradient must take the tensor-core design: "
              f"{bwd_design}")
        check(all(math.isfinite(v) for v in stats.losses),
              "non-finite training loss")
        check(np.mean(stats.losses[-5:]) < np.mean(stats.losses[:5]),
              "the loss did not fall")
    (failed, launches, bwd_design), (clean, _, _) = (
        runs[f"failure at step {TRAIN_STEPS // 2}"], runs["uninterrupted"])
    want = _replayed(clean.losses, (TRAIN_STEPS // 2,), TRAIN_CKPT_EVERY)
    check(failed.restarts == 1 and failed.losses == want,
          "the run with a failure must repeat the uninterrupted run's loss "
          "trajectory bit for bit")
    print(f"train: the replayed trajectory equals the uninterrupted one "
          f"bitwise over {len(want)} losses; losses "
          f"{[round(v, 4) for v in clean.losses]}")

    # ---- step time, tokens/s, peak memory, where the time goes ------------
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    params = param_tree(model)
    opt_cfg = optim.AdamWConfig(warmup_steps=10, total_steps=TRAIN_STEPS)
    pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=args.seed,
                         device="cuda")
    draw_ms, batch = timed(lambda: pipe._batch_at(0), 3)
    step = train.make_step(model, opt_cfg)
    out = {}
    with train.deterministic():
        state = (params, optim.init(params))
        held = torch.cuda.memory_allocated()   # with the model and state
        torch.cuda.reset_peak_memory_stats()
        step_ms, (state, _) = timed(lambda: step(state, batch), TIMED_STEPS)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        tokens_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
        print(f"train step: {step_ms:.2f} ms (CUDA events, mean of "
              f"{TIMED_STEPS} after one warm-up; forward, backward and "
              f"AdamW), {tokens_s:.0f} tokens/s, peak device memory "
              f"{peak:.2f} GiB above the {held / 2**30:.2f} GiB allocated "
              f"before the steps (the model, its state, the batch and "
              f"what earlier paths hold); TokenPipeline draw "
              f"{draw_ms:.2f} ms a "
              f"batch of {TRAIN_BATCH} x {TRAIN_SEQ + 1} x {cfg.vocab}")
        rows, _, _ = traced(lambda: step(state, batch), "one training step")
        part = {"ssd_bwd": 0.0, "ssd_scan": 0.0, "gemm": 0.0, "other": 0.0}
        for e in rows:
            key = e.key.lower()
            name = ("ssd_bwd" if "ssd_bwd" in key else
                    "ssd_scan" if "ssd_scan" in key else
                    "gemm" if any(w in key for w in ("gemm", "xmma",
                                                     "cutlass", "nvjet"))
                    else "other")
            part[name] += e.self_device_time_total / 1e3
        print("train step device ms by part: "
              + ", ".join(f"{k} {v:.2f}" for k, v in part.items()))
        out.update(step_ms=step_ms, tokens_s=tokens_s, peak_gib=peak,
                   draw_ms=draw_ms, parts=part)

        # ---- bf16 gradients against a float32 step ------------------------
        tokens, labels = batch
        (seg,) = cfg.segments
        cut = dataclasses.replace(cfg, segments=(dataclasses.replace(
            seg, repeat=GRAD_DEPTH),))
        for depth, c, m16 in ((cfg.n_layers, cfg, model),
                              (GRAD_DEPTH, cut, init_params(
                                  cut, generator=torch.Generator(
                                      device="cuda").manual_seed(args.seed),
                                  device="cuda"))):
            loss16, g16 = value_and_grad(m16, tokens, labels)
            m32 = Transformer(dataclasses.replace(
                c, param_dtype="float32", compute_dtype="float32"), "cuda")
            load_param_tree(m32, param_tree(m16))
            loss32, g32 = value_and_grad(m32, tokens, labels)
            errs, whole = _grad_errors(g16, g32)
            worst = max(errs, key=errs.get)
            print(f"train grads bf16 vs float32 on the card, {depth} "
                  f"blocks: loss {float(loss16):.6f} vs {float(loss32):.6f};"
                  f" relative L2 error over all leaves {whole:.4g}, worst "
                  f"leaf {worst} {errs[worst]:.4g}"
                  + ("" if depth != GRAD_DEPTH else
                     f" (tolerance {GRAD_LEAF_TOL} a leaf, {GRAD_ALL_TOL} "
                     f"over all)"))
            del m32, g32, g16
        check(whole <= GRAD_ALL_TOL and errs[worst] <= GRAD_LEAF_TOL,
              f"bf16 gradients differ from float32 ones: {errs}")
        # the same comparison through the CPU's plain versions (no kernel):
        # how the error grows with depth, on the batch's first 96 tokens,
        # and at full depth again with other weights (seed + 1) on 256
        # tokens of another row.  At the first two, the card's float32
        # kernels are held to the CPU's float32 plain versions
        on_cpu, witness, t0 = {}, {}, time.perf_counter()
        for depth, seed, row, n in ((GRAD_DEPTH, args.seed, 0, 96),
                                    (cfg.n_layers, args.seed, 0, 96),
                                    (cfg.n_layers, args.seed + 1, 1, 256)):
            c = dataclasses.replace(cfg, segments=(dataclasses.replace(
                seg, repeat=depth),))
            m16 = init_params(c, generator=torch.Generator().manual_seed(
                seed), device="cpu")
            c32 = dataclasses.replace(c, param_dtype="float32",
                                      compute_dtype="float32")
            m32 = Transformer(c32, "cpu")
            load_param_tree(m32, param_tree(m16))
            few = (tokens[row:row + 1, :n].cpu(),
                   labels[row:row + 1, :n].cpu())
            l32, g32 = value_and_grad(m32, *few)
            on_cpu[f"{depth} blocks, seed {seed}, {n} tokens"] = \
                _grad_errors(value_and_grad(m16, *few)[1], g32)[1]
            if seed == args.seed:
                witness[depth] = f32_card_vs_cpu(c32, m32, few, l32, g32,
                                                 depth == cfg.n_layers)
        print(f"train grads bf16 vs float32 on the CPU's plain versions, "
              f"relative L2 error over all leaves: {on_cpu} "
              f"({time.perf_counter() - t0:.1f} s with the card's float32 "
              f"runs)")
        out.update(bf16_vs_f32_cpu=on_cpu, f32_card_vs_cpu=witness)

        # ---- the reduced float32 config: the card against the CPU --------
        rcfg = get_config(TRAIN_ARCH, reduced=True)
        cpu = init_params(rcfg, generator=torch.Generator().manual_seed(
            args.seed), device="cpu")
        card = Transformer(rcfg, "cuda")
        load_param_tree(card, param_tree(cpu))
        rpipe = TokenPipeline(rcfg.vocab, 4, 128, seed=args.seed,
                              device="cpu")
        rbatch = next(rpipe)
        lc, gc = value_and_grad(cpu, *rbatch)
        lg, gg = value_and_grad(card, *(t.cuda() for t in rbatch))
        errs = {}
        for p_, a, b in zip(*_flatten_pair(gg, gc)):
            a = a.cpu()
            errs[p_] = float((a - b).abs().max())
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-4),
                  f"reduced {p_}: card gradient differs from the CPU's")
        check(abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc)),
              f"reduced loss: card {float(lg)} vs CPU {float(lc)}")
        rstep = optim.AdamWConfig(warmup_steps=2, total_steps=4)
        sc = train.make_step(cpu, rstep)((param_tree(cpu), optim.init(
            param_tree(cpu))), rbatch)[0][0]
        sg = train.make_step(card, rstep)((param_tree(card), optim.init(
            param_tree(card))), tuple(t.cuda() for t in rbatch))[0][0]
        for p_, a, b in zip(*_flatten_pair(sg, sc)):
            check(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4),
                  f"reduced {p_}: the card's step differs from the CPU's")
        print(f"train reduced float32: loss card {float(lg):.7f} CPU "
              f"{float(lc):.7f}; gradients max |card - CPU| "
              f"{max(errs.values()):.3g} (rtol = atol = 1e-4), one AdamW "
              f"step's parameters within 1e-4")
    return launches, bwd_design, hash_launches, hcalls, out


def _flatten_pair(a, b):
    from repro_torch.tree import leaves_with_paths
    pa, va = leaves_with_paths(a)
    pb, vb = leaves_with_paths(b)
    check(pa == pb, "trees of different layout")
    return pa, va, vb


def ssd_bwd_record(a, kw, launches, by_design, hmma):
    """The SSD gradient kernel against its plain version (the reverse
    recurrence over stored states) at one layer's inputs of a training
    step, and against itself: two launches bitwise equal.  No PyTorch call
    computes it, so there is no library time."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    a = tuple(t.detach() for t in a)       # saved by autograd: no graph
    x, a_log, b, c, dt, dy = a
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    p = kssd.bwd_plan(x.dtype, B, S, H, P, N, strides=[
        *x.stride(), *b.stride(), *c.stride(), *dy.stride()],
        aligned=all(t.data_ptr() % 16 == 0 for t in (x, b, c, dy)))
    check(p.design == "tensor_core", f"ssd_scan_bwd plans {p.design}")
    ms, got = timed(lambda: kssd.ssd_scan_bwd_cuda(*a), REPS)
    again = kssd.ssd_scan_bwd_cuda(*a)
    bitwise = all(torch.equal(g, h) for g, h in zip(got, again))
    check(bitwise, "two launches of ssd_scan_bwd differ")
    plain_ms, want = timed(lambda: ref.ssd_scan_bwd_ref(*a), 1)
    # each output within a tolerance of its own largest magnitude (a
    # training step's gradients are small): the bf16 outputs 1e-2 (one
    # bf16 step is 2**-8 of a value), the float32 ddt and da_log 1e-3
    # (sums of bf16 inputs' products in another order)
    errs, rel = {}, {}
    for name, g, w in zip(("dx", "db", "dc", "ddt", "da_log"), got, want):
        check(bool(torch.isfinite(g.float()).all()),
              f"ssd_scan_bwd {name} is not finite")
        g, w = g.float(), w.float()
        errs[name] = float((g - w).abs().max())
        scale = float(w.abs().max())
        rel[name] = errs[name] / max(scale, 1e-30)
        tol = 1e-2 if name in ("dx", "db", "dc") else 1e-3
        check(torch.allclose(g, w, rtol=tol, atol=tol * scale),
              f"ssd_scan_bwd {name} differs from its plain version by "
              f"{errs[name]} (largest |value| {scale})")
    flops, nbytes = ha.ssd_bwd_cost(B, S, H, P, G, N,
                                    itemsize=x.element_size())
    bound, by = ha.bound_of(flops, ha.PEAK_FLOPS, nbytes)
    bytes_ms, flops_ms = nbytes / ha.HBM_BW * 1e3, flops / \
        ha.PEAK_FLOPS * 1e3
    print(f"ssd_scan_bwd ({p.design}, {p.blocks} chunk blocks): x "
          f"{tuple(x.shape)} {x.dtype}, B/C {tuple(b.shape)}, workspace "
          f"{p.work_floats * 4 / 1e6:.0f} MB: {ms:.4f} ms (plain "
          f"{plain_ms:.1f} ms, bound {bound:.4f} ms: {nbytes / 1e6:.1f} MB "
          f"take {bytes_ms:.4f} ms, {flops / 1e9:.2f} GFLOP "
          f"{flops_ms:.4f} ms), max |err| {errs}, over the largest "
          f"|value| {rel}, two launches bitwise equal; launches by design "
          f"{by_design}")
    return {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ref.py:79",
        "replaces_note": "no Pallas counterpart: the reference "
                         "differentiates ssd_scan_ref with JAX autodiff",
        "launches": launches, "max_abs_err": max(errs.values()),
        "max_abs_err_by_output": errs, "max_rel_err_by_output": rel,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "bound_bytes_ms": bytes_ms,
        "bound_operations_ms": flops_ms, "library_ms": None,
        "library": "none, no PyTorch call computes it",
        "design": p.design, "launches_by_design": by_design,
        "sass_hmma": hmma, "bitwise_repeat": bitwise,
        "workspace_bytes": p.work_floats * 4}


class MemoryCheckpoints:
    """Stands in for ``runtime.loop``'s checkpoint module while the
    train_dense path runs (``with MemoryCheckpoints() as ckpts``): the
    newest checkpoint of each directory is held in host memory, every
    tensor leaf copied to pinned host memory, instead of written to
    disk.  A
    checkpoint of gemma-7b at 6 blocks is 24.5 GB (bf16 weights, float32
    moments), and the card's machine allows 45 GiB of disk writes a run,
    deleted files included: the 8 saves of the path's two runs would
    write 196 GB.  The loop's own logic -- when to save, what to restore
    after a failure, the pipeline state in ``extra`` -- runs unchanged;
    the checkpoint format itself is the train path's (mamba2-130m, on
    disk) and the CPU tests' (dense configs, read both ways)."""

    def __init__(self):
        self.by_dir, self.saves, self.nbytes, self.seconds = {}, 0, 0, 0.0

    def save(self, ckpt_dir, step, tree, *, extra=None):
        import torch
        from repro_torch.tree import leaves_with_paths
        t0 = time.perf_counter()
        self.by_dir.pop(ckpt_dir, None)    # one kept: free the old first
        _, vals = leaves_with_paths(tree)
        host = []
        for v in vals:                     # pinned: ~10x the pageable rate
            if torch.is_tensor(v):
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host.append(h.copy_(v.detach(), non_blocking=True))
            else:
                host.append(copy.deepcopy(v))
        torch.cuda.synchronize()
        self.by_dir[ckpt_dir] = (step, host, copy.deepcopy(extra or {}))
        self.saves += 1
        self.nbytes = sum(h.numel() * h.element_size() for h in host
                          if torch.is_tensor(h))
        self.seconds += time.perf_counter() - t0

    def latest_step(self, ckpt_dir):
        entry = self.by_dir.get(ckpt_dir)
        return None if entry is None else entry[0]

    def prune_old(self, ckpt_dir, keep=3):
        pass                                # only the newest is held

    def restore(self, ckpt_dir, tree_like, *, step=None):
        import torch
        from repro_torch.tree import leaves_with_paths, unflatten
        t0 = time.perf_counter()
        saved, host, extra = self.by_dir[ckpt_dir]
        check(step in (None, saved), f"checkpoint {step} is not held")
        _, cur = leaves_with_paths(tree_like)
        out = [h.to(device=c.device, dtype=c.dtype, copy=True,
                    non_blocking=True)
               if torch.is_tensor(c) else copy.deepcopy(h)
               for h, c in zip(host, cur)]
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return unflatten(tree_like, out), saved, copy.deepcopy(extra)

    def __enter__(self):
        from repro_torch.runtime import loop
        self.real, loop.ckpt_lib = loop.ckpt_lib, self
        return self

    def __exit__(self, *exc):
        from repro_torch.runtime import loop
        loop.ckpt_lib = self.real
        self.by_dir.clear()


def _each_ms(fn, n):
    """Mean device time of fn() in ms over n calls (after one warm-up),
    with CUDA events around each; every call's result is freed before the
    next (two live training states of a dense model would not fit the
    card)."""
    import torch
    out = fn()
    del out
    total = 0.0
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
        del out
    return total / n


def train_dense_path(args, captured):
    """gemma-7b at its published width, cut to DENSE_LAYERS blocks, trained
    by ``launch/train.py`` through the flash forward and gradient kernels
    and AdamW in the fault-tolerant loop, with an injected failure whose
    replay must repeat an uninterrupted run bit for bit.  Returns the
    launch counts and the step numbers."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import (Transformer, count_params, init_params,
                                    layers, load_param_tree, param_tree,
                                    value_and_grad)

    cfg = train.cut_depth(get_config(DENSE_ARCH), DENSE_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff, cfg.vocab,
           cfg.tie_embeddings, cfg.logit_softcap, cfg.cdtype, cfg.n_layers)
          == (3072, 16, 256, 24576, 256000, True, 30.0, torch.bfloat16,
              DENSE_LAYERS), "gemma-7b must train at its published width")
    n_params = count_params(cfg)
    print(f"phase train_dense: {cfg.name} cut to {cfg.n_layers} of 28 "
          f"blocks, {n_params / 1e9:.3f} B parameters (count_params), "
          f"{DENSE_BATCH} x {DENSE_SEQ} tokens a step")
    ops.flash_attention_cuda = kfa.flash_attention_cuda
    ops.flash_attention_bwd_cuda = recorder(captured, "flash_attention_bwd",
                                            kfa.flash_attention_bwd_cuda)
    runs = {}
    for name, fail in ((f"failure at step {DENSE_FAIL_AT}", True),
                       ("uninterrupted", False)):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dense_") as ck:
            argv = ["--arch", DENSE_ARCH, "--layers", str(DENSE_LAYERS),
                    "--steps", str(DENSE_STEPS), "--batch", str(DENSE_BATCH),
                    "--seq", str(DENSE_SEQ), "--lr", "3e-4", "--ckpt-dir",
                    ck, "--ckpt-every", str(DENSE_CKPT_EVERY), "--device",
                    "cuda", "--seed", str(args.seed)]
            if fail:
                argv += ["--fail-at", str(DENSE_FAIL_AT)]
            _reset_launches()
            held = torch.cuda.memory_allocated()   # by the earlier paths
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with MemoryCheckpoints() as ckpts:
                stats = train.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = _launch_counts()
        by_design = {
            "flash_attention": dict(
                kfa.flash_attention_cuda.launches_by_design),
            "flash_attention_bwd": dict(
                kfa.flash_attention_bwd_cuda.launches_by_design)}
        runs[name] = (stats, launches)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        print(f"phase train_dense ({name}): {stats.steps_run} steps, "
              f"{stats.restarts} restarts, {secs:.1f} s with the token "
              f"draws and {ckpts.saves} checkpoints of "
              f"{ckpts.nbytes / 1e9:.2f} GB in host memory "
              f"({ckpts.seconds:.1f} s to save and restore); loss "
              f"{stats.losses[0]:.4f} -> "
              f"{stats.losses[-1]:.4f}; launches {launches}, by design "
              f"{by_design}; peak device memory {peak:.2f} GiB above the "
              f"{held / 2**30:.2f} GiB held before the run")
        n = stats.steps_run
        check(launches["flash_attention"] == 2 * cfg.n_layers * n,
              "each step launches the flash kernel twice a layer (forward "
              "and the rematerialised forward)")
        check(launches["flash_attention_bwd"] == cfg.n_layers * n,
              "each step launches the flash gradient kernel once a layer")
        for k, designs in by_design.items():
            check(designs["tensor_core"] == launches[k],
                  f"every training launch of {k} must take the tensor-core "
                  f"design: {by_design[k]}")
        check(all(math.isfinite(v) for v in stats.losses),
              "non-finite training loss")
        check(np.mean(stats.losses[-5:]) < np.mean(stats.losses[:5]),
              "the loss did not fall")
        torch.cuda.empty_cache()
    (failed, launches), (clean, _) = (
        runs[f"failure at step {DENSE_FAIL_AT}"], runs["uninterrupted"])
    want = _replayed(clean.losses, (DENSE_FAIL_AT,), DENSE_CKPT_EVERY)
    check(failed.restarts == 1 and failed.losses == want,
          "the run with a failure must repeat the uninterrupted run's loss "
          "trajectory bit for bit")
    print(f"train_dense: the replayed trajectory equals the uninterrupted "
          f"one bitwise over {len(want)} losses; losses "
          f"{[round(v, 4) for v in clean.losses]}")

    # ---- step time, tokens/s, model FLOP/s, peak memory, the trace -------
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    params = param_tree(model)
    pipe = TokenPipeline(cfg.vocab, DENSE_BATCH, DENSE_SEQ, seed=args.seed,
                         device="cuda")
    draw_ms, batch = timed(lambda: pipe._batch_at(0), 1)
    opt_cfg = optim.AdamWConfig(warmup_steps=10, total_steps=DENSE_STEPS)
    step = train.make_step(model, opt_cfg)
    out = {}
    with train.deterministic():
        state = (params, optim.init(params))
        del params
        held = torch.cuda.memory_allocated()   # with the model and state
        torch.cuda.reset_peak_memory_stats()
        step_ms = _each_ms(lambda: step(state, batch), DENSE_TIMED)
        peak = torch.cuda.max_memory_allocated()
        tokens = DENSE_BATCH * DENSE_SEQ
        tokens_s = tokens / (step_ms / 1e3)
        tflops = 6 * n_params * tokens / (step_ms / 1e3) / 1e12
        print(f"train_dense step: {step_ms:.2f} ms (CUDA events, mean of "
              f"{DENSE_TIMED} after one warm-up; forward, backward and "
              f"AdamW), {tokens_s:.0f} tokens/s, {tflops:.1f} model "
              f"TFLOP/s (6 x {n_params / 1e9:.3f} B parameters x {tokens} "
              f"tokens); peak device memory {peak / 2**30:.2f} GiB "
              f"({(peak - held) / 2**30:.2f} above the {held / 2**30:.2f} "
              f"GiB of the model, its state, the batch and earlier paths); "
              f"TokenPipeline draw {draw_ms:.1f} ms a batch of "
              f"{DENSE_BATCH} x {DENSE_SEQ + 1} x {cfg.vocab}")
        rows, _, _ = traced(lambda: step(state, batch),
                            "one dense training step")
        part = {"flash_bwd": 0.0, "flash_fwd": 0.0, "products": 0.0,
                "other": 0.0}
        for e in rows:
            key = e.key.lower()
            name = ("flash_bwd" if "fa_bwd" in key else
                    "flash_fwd" if "flash_attention" in key else
                    "products" if any(w in key for w in (
                        "gemm", "xmma", "cutlass", "nvjet")) else "other")
            part[name] += e.self_device_time_total / 1e3
        # the cross entropy and the softcap (the float32 logits) alone
        logits = torch.randn((DENSE_BATCH, DENSE_SEQ, cfg.vocab),
                             device="cuda", dtype=torch.bfloat16)
        logits.requires_grad_()

        def loss_part():
            lf = torch.tanh(logits.float() / cfg.logit_softcap) * \
                cfg.logit_softcap
            return torch.autograd.grad(layers.cross_entropy(lf, batch[1]),
                                       logits)
        part["cross_entropy"], _ = timed(loss_part, 3)
        del logits
        # and the AdamW update of the whole state, alone
        _, grads = value_and_grad(model, *batch)
        part["adamw"] = _each_ms(lambda: optim.update(
            opt_cfg, grads, state[1], state[0]), DENSE_TIMED)
        del grads
        part["float32_glue"] = (part["other"] - part["cross_entropy"]
                                - part["adamw"])
        print("train_dense step device ms by part: "
              + ", ".join(f"{k} {v:.2f}" for k, v in part.items())
              + " (cross_entropy: the softcap and cross entropy on the "
                "float32 logits, forward and backward, and adamw: the "
                "update of the whole state, each timed alone; "
                "float32_glue: the rest of other)")
        out.update(step_ms=step_ms, tokens_s=tokens_s, tflops=tflops,
                   peak_gib=peak / 2**30, draw_ms=draw_ms, parts=part)
    del state, step, model
    torch.cuda.empty_cache()

    # ---- float32 at 2 blocks of the published width: card against CPU ----
    tokens_few = (batch[0][:1, :96].cpu(), batch[1][:1, :96].cpu())
    c2 = dataclasses.replace(train.cut_depth(get_config(DENSE_ARCH), 2),
                             param_dtype="float32", compute_dtype="float32")
    m16 = init_params(train.cut_depth(get_config(DENSE_ARCH), 2),
                      generator=torch.Generator().manual_seed(args.seed),
                      device="cpu")
    m32 = Transformer(c2, "cpu")
    load_param_tree(m32, param_tree(m16))
    del m16
    l32, g32 = value_and_grad(m32, *tokens_few)
    out["f32_card_vs_cpu"] = f32_card_vs_cpu(c2, m32, tokens_few, l32, g32,
                                             False)
    del m32, g32
    return launches, by_design, out


def flash_train_forward(a):
    """The flash forward at the train path's inputs (one layer's q, k, v
    of a training step, the views the attention layer hands over): its
    output bitwise the same with and without the lse, the lse within
    rtol = atol = 1e-4 of the plain one, the output within the forward
    record's tolerance: the train path's part of the
    ``flash_attention`` record."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    q, k, v = (t.detach() for t in a[:3])
    ms, (o, lse) = timed(lambda: kfa.flash_attention_cuda(
        q, k, v, return_lse=True), REPS)
    plain = kfa.flash_attention_cuda(q, k, v)
    check(torch.equal(o, plain),
          "the flash forward's output changes with its lse output")
    want_o, want_lse = ref.attention_ref(q, k, v, return_lse=True)
    err = float((o.float() - want_o.float()).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    check(torch.allclose(o.float(), want_o.float(), rtol=BF16_TOL,
                         atol=BF16_TOL),
          f"flash_attention differs from its plain version by {err} at the "
          f"train path's inputs")
    row_err, median = flash_rows(o, want_o, "the train path's inputs")
    check(torch.allclose(lse, want_lse, rtol=1e-4, atol=1e-4),
          f"the flash forward's lse differs from the plain one by {lse_err}")
    print(f"flash_attention at the train path's inputs: q {tuple(q.shape)} "
          f"strides {q.stride()}: {ms:.4f} ms with the lse, output bitwise "
          f"the same without it, max |err| {err:.3g} (tolerance "
          f"{BF16_TOL}), by row {row_err:.3g} of the row's largest |o| "
          f"(tolerance {FLASH_ROW_TOL}), median |o| {median:.3g}, lse max "
          f"|err| {lse_err:.3g} (1e-4)")
    return {"train_max_abs_err": err, "train_max_rel_err_by_row": row_err,
            "train_median_abs_out": median, "train_lse_max_abs_err": lse_err,
            "train_ms": ms}


def flash_bwd_record(a, kw, launches, by_design, hmma):
    """The flash gradient kernel against its plain version at one layer's
    (q, k, v, o, lse, dout) of a training step, and against itself: two
    launches bitwise equal; PyTorch's fused attention's backward at the
    same inputs is the library time (measured only)."""
    got = flash_bwd_measure(a, kw, "the train_dense path's inputs")
    design = got.pop("design")
    return {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/flash_xla.py:96",
        "replaces_note": "no Pallas counterpart: the reference's custom "
                         "VJP runs its backward as an XLA lax.scan",
        "launches": launches, **got,
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   "backward (torch.autograd.grad)",
        "design": design, "launches_by_design": by_design,
        "sass_hmma": hmma}


def flash_bwd_measure(a, kw, where):
    """The flash gradient kernel at (q, k, v, o, lse, dout): its design
    (which must be "tensor_core"), ms beside its plain version's and
    ``scaled_dot_product_attention``'s backward, its error against the
    plain version (each output within FLASH_BWD_TOL of its largest
    magnitude), two launches bitwise equal, and its bound.  v, o and
    dout may be narrower than q and k (MLA): the wrapper pads them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    a = tuple(t.detach() for t in a)
    q, k, v, o, lse, dout = a
    causal = kw.get("causal", True)
    B, H, S, dh = q.shape
    dv = v.shape[-1]
    strides = [s for t in (q, k, v, o, dout) for s in t.stride()[:3]]
    design = kfa.bwd_plan(q.dtype, dh, S, k.shape[2], strides=strides,
                          aligned=all(t.data_ptr() % 16 == 0
                                      for t in a)).design
    check(design == "tensor_core", f"flash_attention_bwd plans {design} at "
          f"{where}")
    ms, got = timed(lambda: kfa.flash_attention_bwd_cuda(*a, **kw), REPS)
    again = kfa.flash_attention_bwd_cuda(*a, **kw)
    bitwise = all(torch.equal(g, h) for g, h in zip(got, again))
    check(bitwise, f"two launches of flash_attention_bwd differ at {where}")
    plain_ms, want = timed(lambda: ref.flash_attention_bwd_ref(*a, **kw), 1)
    errs, rel = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(g.float()).all()),
              f"flash_attention_bwd {name} is not finite at {where}")
        g, w = g.float(), w.float()
        errs[name] = float((g - w).abs().max())
        scale = float(w.abs().max())
        rel[name] = errs[name] / max(scale, 1e-30)
        check(torch.allclose(g, w, rtol=FLASH_BWD_TOL,
                             atol=FLASH_BWD_TOL * scale),
              f"flash_attention_bwd {name} differs from its plain version "
              f"by {errs[name]} (largest |value| {scale}) at {where}")
    del want
    qd, kd, vd = (t.clone().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(qd, kd, vd, is_causal=causal,
                                                 **_gqa(q, k))
        library_ms, _ = timed(lambda: torch.autograd.grad(
            lib_out, (qd, kd, vd), dout, retain_graph=True), REPS)
    del lib_out
    flops, nbytes = ha.flash_bwd_cost(
        B, H, k.shape[1], S, k.shape[2], dh, dv, causal=causal,
        itemsize=q.element_size())
    bound, by = ha.bound_of(flops, ha.PEAK_FLOPS, nbytes)
    print(f"flash_attention_bwd ({design}) at {where}: q {tuple(q.shape)} "
          f"{q.dtype} strides {q.stride()}, v {tuple(v.shape)}, dout strides "
          f"{dout.stride()}: {ms:.4f} ms (plain {plain_ms:.2f} ms, "
          f"scaled_dot_product_attention's backward {library_ms:.4f} ms, "
          f"bound {bound:.4f} ms: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
          f"GFLOP), max |err| {errs}, over the largest |value| {rel} "
          f"(tolerance {FLASH_BWD_TOL}), two launches bitwise equal")
    return {"max_abs_err": max(errs.values()),
            "max_abs_err_by_output": errs, "max_rel_err_by_output": rel,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, "design": design,
            "bitwise_repeat": bitwise}


def flash_bwd_long(seed):
    """The flash gradient kernel at gemma-7b's published context: (1, 16,
    8,192, 256), causal, bf16; q, k, v and dout from ``seed`` as the views
    the training path hands over, o and lse from the forward kernel.  Timed
    with CUDA events beside ``scaled_dot_product_attention``'s backward on
    the same inputs (the yardstick) and the bound of the same formula, and
    held against the plain version one head at a time (its scores of all
    16 heads would be 4.3 GB a float32 matrix).  Runs after the train_dense
    path has released its memory; returns the record's extra keys."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    torch.cuda.reset_peak_memory_stats()
    B, S, H, dh = LONG_BATCH, LONG_SEQ, 16, 256
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda sc: (torch.randn((B, S, H, dh), generator=g, device="cuda")
                     * sc).bfloat16().transpose(1, 2)
    q, k, v, dout = mk(0.5), mk(0.5), mk(0.5), mk(1.0)
    o, lse = kfa.flash_attention_cuda(q, k, v, return_lse=True)
    a = (q, k, v, o, lse, dout)
    strides = [s for t in (q, k, v, o, dout) for s in t.stride()[:3]]
    design = kfa.bwd_plan(q.dtype, dh, S, S, strides=strides).design
    check(design == "tensor_core",
          f"flash_attention_bwd plans {design} at (1, 16, {S}, {dh})")
    ms, got = timed(lambda: kfa.flash_attention_bwd_cuda(*a), REPS)
    errs = {}
    t0 = time.perf_counter()
    for h in range(H):
        want = ref.flash_attention_bwd_ref(*(t[:, h:h + 1] for t in a))
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            x, w = x[:, h:h + 1].float(), w.float()
            scale = float(w.abs().max())
            err = float((x - w).abs().max())
            check(bool(torch.isfinite(x).all()) and torch.allclose(
                      x, w, rtol=FLASH_BWD_TOL, atol=FLASH_BWD_TOL * scale),
                  f"flash_attention_bwd {name} of head {h} at (1, 16, {S}, "
                  f"{dh}) differs from its plain version by {err} (largest "
                  f"|value| {scale})")
            errs[name] = max(errs.get(name, 0.0), err / max(scale, 1e-30))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    qd, kd, vd = (t.detach().clone().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(qd, kd, vd, is_causal=True)
        library_ms, _ = timed(lambda: torch.autograd.grad(
            lib_out, (qd, kd, vd), dout, retain_graph=True), REPS)
    del lib_out
    flops, nbytes = ha.flash_bwd_cost(B, H, H, S, S, dh, dh, causal=True,
                                      itemsize=q.element_size())
    bound, by = ha.bound_of(flops, ha.PEAK_FLOPS, nbytes)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"flash_attention_bwd ({design}) at gemma-7b's context: q "
          f"{tuple(q.shape)} {q.dtype} strides {q.stride()}, causal: "
          f"{ms:.4f} ms (scaled_dot_product_attention's backward "
          f"{library_ms:.4f} ms, bound {bound:.4f} ms: {nbytes / 1e6:.1f} "
          f"MB, {flops / 1e9:.2f} GFLOP; plain, head by head, {plain_ms:.1f} "
          f"ms), over the largest |value| {errs} (tolerance {FLASH_BWD_TOL}),"
          f" peak device memory {peak:.2f} GiB")
    return {"long_shape": [B, H, S, dh], "long_ms": ms,
            "long_plain_ms": plain_ms, "long_library_ms": library_ms,
            "long_bound_ms": bound, "long_bound_by": by,
            "long_max_rel_err_by_output": errs, "long_peak_gib": peak}


def _teacher_forced(model, tokens, S, T, stubs=None):
    """Prefill tokens[:, :S] into a new cache of P + S + T positions,
    then decode tokens[:, S + t] at position P + S + t for each t < T (P
    the patch rows of ``stubs``' ``frontend_emb``; ``stubs`` the stub
    frontends' inputs of ``prefill``).  Returns the logits (B, T + 1,
    vocab) of the prefill's last position and of each step -- the
    forward's at tokens S - 1 .. S + T - 1 -- the cache, the prefill's ms
    and each step's (CUDA events).  Every cache row at a position not
    written yet must still be zero after the prefill and after each
    step."""
    import torch
    from repro_torch.models import decode_step, init_cache, prefill
    stubs = stubs or {}
    P = stubs["frontend_emb"].shape[1] if "frontend_emb" in stubs else 0
    cache = init_cache(model.cfg, tokens.shape[0], P + S + T,
                       device=tokens.device)
    # K/V (R, B, Hkv, Smax, hd) and MLA's latent (R, B, Smax, width): the
    # position axis is the one before the last
    kv = [t for seg in cache for blk in seg.values()
          for key, t in blk.items() if key in ("k", "v", "ckv", "kpe")]
    stray = torch.zeros((), dtype=torch.int64, device=tokens.device)
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(T + 1)]
    marks[0][0].record()
    last, cache = prefill(model, tokens[:, :S], cache, **stubs)
    marks[0][1].record()
    logits = [last]
    for t in range(T + 1):
        pos = P + S + t                   # rows >= pos not written yet
        for leaf in kv:
            stray += torch.count_nonzero(leaf[..., pos:, :])
        if t == T:
            break
        marks[t + 1][0].record()
        out, cache = decode_step(model, tokens[:, S + t:S + t + 1], cache,
                                 pos)
        marks[t + 1][1].record()
        logits.append(out)
    torch.cuda.synchronize()
    check(int(stray) == 0, f"{int(stray)} cache entries at positions not "
          f"written yet are not zero")
    ms = [a.elapsed_time(b) for a, b in marks]
    return torch.cat(logits, dim=1), cache, ms[0], ms[1:]


def _forward_rows(model, tokens, S, T, stubs=None):
    """The full-sequence forward's logits at tokens S - 1 .. S + T - 1
    only: the blocks over all S + T tokens (after the P patch rows of
    ``stubs``, where given), then the final norm and the head on those
    rows (gemma-7b's (8, 2,080, 256,000) float32 logits would be 17
    GB)."""
    from repro_torch.models import hidden_states
    from repro_torch.models.transformer import _logits
    stubs = stubs or {}
    P = stubs["frontend_emb"].shape[1] if "frontend_emb" in stubs else 0
    return _logits(model, hidden_states(model, tokens[:, :S + T], **stubs)[
        :, P + S - 1:P + S + T])


def start_dryrun(out_dir):
    """``python -m repro_torch.launch.dryrun --all`` and the steps path's
    cut cells: two host processes on the meta device, with no card
    (CUDA_VISIBLE_DEVICES empty: no CUDA context on the card), started
    beside the kernel builds at the lowest CPU priority (the builds and
    the paths go first); their JSONs and logs go to ``out_dir``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cut = [(*STEPS_PREFILL, None)] + [
        (STEPS_TRAIN_ARCH, "train_4k", b, 1) for b in STEPS_TRAIN_BATCHES]
    code = ("import sys\nfrom repro_torch.launch import dryrun\n"
            f"recs = [dryrun.run_cell(a, s, {out_dir!r}, True, batch=b, "
            f"microbatches=m) for a, s, b, m in {cut!r}]\n"
            "sys.exit(0 if all(r['ok'] for r in recs) else 1)\n")
    procs = []
    for name, cmd in (
            ("all", [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--all", "--force", "--out", out_dir]),
            ("cut", [sys.executable, "-c", code])):
        log = open(os.path.join(out_dir, f"dryrun_{name}.log"), "w")
        procs.append((name, log, subprocess.Popen(
            ["nice", "-n", "19", *cmd], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT)))
    return procs


def stop_dryrun(procs):
    """Stop any dry-run process still running."""
    for _, log, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def finish_dryrun(procs, out_dir):
    """Wait for the dry run (about a minute and a half on the card's host
    beside the builds); fails if a cell failed."""
    t0 = time.perf_counter()
    for name, log, proc in procs:
        rc = proc.wait(timeout=900)
        log.flush()
        text = Path(out_dir, f"dryrun_{name}.log").read_text()
        check(rc == 0, f"the dry run ({name}) exited {rc}:\n{text[-3000:]}")
    print(f"phase steps dryrun waited {time.perf_counter() - t0:.1f} s")


def dry_record(out_dir, arch, shape, batch=None, microbatches=None):
    from repro_torch.launch import dryrun
    name = dryrun.cell_name(arch, shape, batch, microbatches)
    rec = json.loads(Path(out_dir, name + ".json").read_text())
    check(rec["ok"], f"dry run of {name} failed: {rec.get('error')}")
    return rec


def dryrun_summary(out_dir):
    """One line for the dry run's 40 cells: fits one card or not, the
    predicted peak, FLOPs, roofline ms and bottleneck (or the reference's
    skip); every cell ran with no loop of unknown trip count and every
    kernel launch through its plan."""
    from repro_torch.configs import list_archs
    from repro_torch.launch import steps
    parts, n_fit, cap = [], 0, None
    for arch in list_archs():
        for shape in steps.SHAPES:
            r = dry_record(out_dir, arch, shape)
            name = f"{r['arch']} {shape}"
            if r.get("skipped"):
                parts.append(f"{name} skipped")
                continue
            m, rl = r["memory"], r["roofline"]
            check(r["cost"]["unknown_trip_loops"] == 0 and all(
                k["plan_ok"] for k in r["kernels"].values()),
                f"dry run of {name}: {r['cost']}, {r['kernels']}")
            n_fit += m["fits"]
            cap = m["capacity_of"]
            parts.append(
                f"{name} {'fits' if m['fits'] else 'does not fit'} "
                f"{m['peak_bytes'] / 2**30:.2f} GiB {r['cost']['flops']:.4g} "
                f"FLOP {rl['step_time_s'] * 1e3:.4g} ms {rl['bottleneck']}")
    print(f"phase steps dryrun: {len(parts)} cells, {n_fit} fit one card "
          f"({cap}): " + "; ".join(parts))
    return n_fit


def _same_tree(a, b):
    """Every tensor leaf of a and b bitwise equal and finite, compared in
    pieces of 2**28 elements (a cache leaf of gemma-7b at 32,768
    positions is 7.5 GB)."""
    import torch
    from repro_torch.tree import leaves
    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        for u, v in zip(x.reshape(-1).split(1 << 28),
                        y.reshape(-1).split(1 << 28)):
            if not (torch.equal(u, v) and bool(torch.isfinite(u).all())):
                return False
    return True


def steps_measure(name, fn, args, rec, reduced):
    """One built step on the card, after the hand-built path ran on the
    same inputs: the launch counts from 0, the rise of device memory over
    what is held (after ``reset_peak_memory_stats``), CUDA events; the
    launches must equal the dry run's, every one "tensor_core", and the
    dry run's predicted rise must be within STEPS_MEM_TOL of the measured.
    Returns (the step's outputs, the cell's record)."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ssd_scan as kssd
    torch.cuda.synchronize()
    _reset_launches()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    rise = torch.cuda.max_memory_allocated() - held
    launches = {k: v for k, v in _launch_counts().items() if v}
    designs = {k: {d: n for d, n in fn_.launches_by_design.items() if n}
               for k, fn_ in (("flash_attention", kfa.flash_attention_cuda),
                              ("flash_attention_bwd",
                               kfa.flash_attention_bwd_cuda),
                              ("ssd_scan", kssd.ssd_scan_cuda),
                              ("ssd_scan_bwd", kssd.ssd_scan_bwd_cuda))
               if k in launches}
    want = {k: v["launches"] for k, v in rec["kernels"].items()}
    check(launches == want, f"{name}: launches {launches}, the dry run "
          f"counted {want}")
    check(all(d == {"tensor_core": launches[k]} == rec["kernels"][k][
              "designs"] for k, d in designs.items()),
          f"{name}: launches by design {designs}, the dry run's "
          f"{ {k: v['designs'] for k, v in rec['kernels'].items()} }")
    pred = rec["memory"]["step_peak_bytes"]
    err = (pred - rise) / max(rise, 1)
    rl = rec["roofline"]
    tflops = rl["model_flops"] / (ms * 1e-3) / 1e12
    print(f"phase steps {name}: {ms:.3f} ms (CUDA events; the roofline "
          f"{rl['step_time_s'] * 1e3:.4f} ms, {rl['bottleneck']}), "
          f"{tflops:.2f} model TFLOP/s; device memory rise {rise} bytes "
          f"({rise / 2**30:.3f} GiB) above the {held / 2**30:.2f} GiB held, "
          f"the dry run's {pred} ({err:+.2%}); launches {launches} "
          f"{designs}, as the dry run's; reduced: {reduced or 'none'}")
    check(abs(pred - rise) <= STEPS_MEM_TOL * rise,
          f"{name}: the dry run predicted a rise of {pred} bytes, the card "
          f"rose {rise} ({err:+.2%}, tolerance {STEPS_MEM_TOL:.0%})")
    return out, {"ms": ms, "roofline_ms": rl["step_time_s"] * 1e3,
                 "bottleneck": rl["bottleneck"],
                 "model_flops": rl["model_flops"], "model_tflops": tflops,
                 "rise_bytes": rise, "predicted_rise_bytes": pred,
                 "rise_error": err, "held_bytes": held,
                 "predicted_peak_bytes": rec["memory"]["peak_bytes"],
                 "launches": launches, "launches_by_design": designs,
                 "reduced": reduced, "bitwise": None}


def steps_prefill_cell(model, dry_dir, seed):
    """STEPS_PREFILL on the decode path's gemma-7b (28 blocks, bf16): the
    built prefill step against ``prefill`` called directly on the same
    prompt and a cache of its own, bitwise (logits and every cache
    leaf)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import init_cache, prefill
    t0 = time.perf_counter()
    arch, shape, B = STEPS_PREFILL
    cfg, S = model.cfg, steps.SHAPES[shape]["seq"]
    check(cfg.name == arch, f"{cfg.name} is not {arch}")
    rec = dry_record(dry_dir, arch, shape, batch=B)
    built = steps.build_step(cfg, make_production_mesh(), shape, batch=B)
    tokens = _decode_tokens(cfg, seed, B, S).to(torch.int32)
    want = prefill(model, tokens, init_cache(cfg, B, S))
    out, cell = steps_measure(
        f"{arch} {shape}", built.fn, (model, init_cache(cfg, B, S), tokens),
        rec, [f"batch {steps.SHAPES[shape]['batch']} -> {B} (the cache at "
              f"32 sequences is ~480 GB)"])
    cell["bitwise"] = _same_tree(out, want)
    check(cell["bitwise"], f"{arch} {shape}: the built step differs from "
          f"prefill called directly")
    del out, want
    torch.cuda.empty_cache()
    cell["seconds"] = time.perf_counter() - t0
    print(f"phase steps {arch} {shape}: bitwise prefill's; "
          f"{cell['seconds']:.1f} s")
    return cell


def steps_path(args, dry_dir, prefill_cell):
    """The steps path: the dry run's 40 cells in one line, then
    STEPS_CELLS and the mamba2-130m training cell built by
    ``steps.build_step`` and run on the card, each against the hand-built
    path on the same inputs, bitwise: ``decode_step`` called directly, and
    ``launch/train.make_step`` under ``train.deterministic()`` (loss,
    parameters, moments).  ``prefill_cell`` is the decode path's gemma-7b
    cell.  Returns the path's record."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    param_tree)
    t0 = time.perf_counter()
    mesh = make_production_mesh()
    out = {"dryrun_cells_fit": dryrun_summary(dry_dir),
           " ".join(STEPS_PREFILL[:2]): prefill_cell}
    model = None
    for arch, shape in STEPS_CELLS:
        if model is None or model.cfg.name != arch:
            model = None
            torch.cuda.empty_cache()
            model = init_params(get_config(arch), generator=torch.Generator(
                device="cuda").manual_seed(args.seed), device="cuda")
        cfg = model.cfg
        s = steps.SHAPES[shape]
        B, S = s["batch"], s["seq"]
        rec = dry_record(dry_dir, arch, shape)
        built = steps.build_step(cfg, mesh, shape)
        token = _decode_tokens(cfg, args.seed, B, 1).to(torch.int32)
        pos = torch.tensor(S - 1, dtype=torch.int32, device="cuda")
        want = decode_step(model, token, init_cache(cfg, B, S), pos)
        got, cell = steps_measure(f"{arch} {shape}", built.fn,
                                  (model, init_cache(cfg, B, S), token, pos),
                                  rec, [])
        cell["bitwise"] = _same_tree(got, want)
        check(cell["bitwise"], f"{arch} {shape}: the built step differs "
              f"from decode_step called directly")
        out[f"{arch} {shape}"] = cell
        del got, want
    del model
    torch.cuda.empty_cache()

    cfg = get_config(STEPS_TRAIN_ARCH)
    room = (torch.cuda.get_device_properties(0).total_memory
            - torch.cuda.memory_allocated() - STEPS_MARGIN)
    fit = [b for b in STEPS_TRAIN_BATCHES if dry_record(
        dry_dir, STEPS_TRAIN_ARCH, "train_4k", b, 1)["memory"][
        "peak_bytes"] <= room]
    check(fit, f"no batch of {STEPS_TRAIN_BATCHES} fits {room} bytes")
    B, S = fit[0], steps.SHAPES["train_4k"]["seq"]
    rec = dry_record(dry_dir, STEPS_TRAIN_ARCH, "train_4k", B, 1)
    opt_cfg = optim.AdamWConfig()
    built = steps.build_step(cfg, mesh, "train_4k", batch=B, microbatches=1,
                             opt_cfg=opt_cfg)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    model = init_params(cfg, generator=g, device="cuda")
    params = param_tree(model)
    state = (params, optim.init(params))
    tokens, labels = (torch.randint(0, cfg.vocab, (B, S), generator=g,
                                    device="cuda", dtype=torch.int32)
                      for _ in range(2))
    with train.deterministic():
        (p1, o1), l1 = train.make_step(model, opt_cfg)(state,
                                                       (tokens, labels))
        got, cell = steps_measure(
            f"{STEPS_TRAIN_ARCH} train_4k", built.fn,
            (model, *state, tokens, labels), rec,
            [f"{steps.TRAIN_MICROBATCHES} microbatches of "
             f"{steps.SHAPES['train_4k']['batch'] // steps.TRAIN_MICROBATCHES}"
             f" sequences -> 1 of {B} (the largest of "
             f"{STEPS_TRAIN_BATCHES} the dry run fits beside what is held)"])
    cell["bitwise"] = _same_tree((p1, o1, l1), got[:3])
    check(cell["bitwise"], f"{STEPS_TRAIN_ARCH} train_4k: the built step's "
          f"loss, parameters or moments differ from make_step's")
    cell["batch"] = B
    out[f"{STEPS_TRAIN_ARCH} train_4k"] = cell
    del model, params, state, got, p1, o1
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    out["seconds"] = secs + prefill_cell["seconds"]
    print(f"phase steps: {secs:.1f} s here and {prefill_cell['seconds']:.1f}"
          f" s in the decode path; every cell bitwise the hand-built path, "
          f"within {STEPS_MEM_TOL:.0%} of the dry run's memory, its "
          f"launches the dry run's")
    return out


def _decode_tokens(cfg, seed, B, n):
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, n))).to("cuda")


def decode_checks(cfg, seed, cut=DECODE_CUT, shape=DECODE_CHECK,
                  stubs=None):
    """The decode path held to the full-sequence forward (``shape`` =
    (B, S, T) tokens, B x (S + T); ``stubs`` the stub frontends' inputs,
    as bf16 and float32 models take them) on every row: in float32 on
    the card within DECODE_F32_TOL (gemma-7b and the MoE configs cut to
    ``cut`` blocks, mamba2-130m at its full depth), and in bf16 at
    ``cut`` blocks within twice the bf16 forward's own distance to the
    float32 forward on the same weights.

    A MoE config runs both at the capacity factor E / K, where no token
    drops (C >= the tokens of a call): at the published factor a decode
    step of B tokens has far fewer slots an expert than the forward's
    one call over all B x (S + T) tokens, and drops by design what the
    forward keeps.  Float32 runs the published top-K, so a token that
    decode and the forward route apart fails it.  The bf16 check routes
    every token to all E experts (top-K = E, capacity factor 1): bf16
    rounding moves router inputs across the near-ties of a random
    router, which flips discrete choices and moves logits by far more
    than rounding's reach; with all E chosen there is no choice to
    flip."""
    import dataclasses

    import torch
    from repro_torch.launch.train import cut_depth
    from repro_torch.models import (Transformer, init_params,
                                    load_param_tree, param_tree)
    B, S, T = shape
    tokens = _decode_tokens(cfg, seed + 1, B, S + T)
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    st16 = {k: t.bfloat16() for k, t in (stubs or {}).items()}
    st32 = {k: t.float() for k, t in (stubs or {}).items()}
    gen = lambda: torch.Generator(device="cuda").manual_seed(seed)  # noqa
    moe16 = moe32 = {}
    note16 = note32 = ""
    if cfg.moe is not None:
        E, K = cfg.moe.n_experts, cfg.moe.top_k
        moe16 = dict(moe=dataclasses.replace(cfg.moe, top_k=E,
                                             capacity_factor=1.0))
        moe32 = dict(moe=dataclasses.replace(cfg.moe, capacity_factor=E / K))
        note16 = f", all {E} experts (no drops)"
        note32 = f", top-{K} at capacity factor {E / K:.4g} (no drops)"
    m16 = init_params(dataclasses.replace(cut_depth(cfg, cut), **moe16),
                      generator=gen(), device="cuda")
    m32 = Transformer(dataclasses.replace(m16.cfg, **f32), "cuda")
    load_param_tree(m32, param_tree(m16))
    dec16 = _teacher_forced(m16, tokens, S, T, st16)[0]
    fwd16 = _forward_rows(m16, tokens, S, T, st16)
    fwd32 = _forward_rows(m32, tokens, S, T, st32)
    gap = float((dec16 - fwd16).abs().max())
    reach = float((fwd16 - fwd32).abs().max())
    print(f"decode {cfg.name} bf16 at {m16.cfg.n_layers} blocks{note16}, {B} x "
          f"({S} + {T}) tokens: max |decode - forward| {gap:.4g}, the bf16 "
          f"forward's own max |bf16 - float32| {reach:.4g} (limit "
          f"{2 * reach:.4g})")
    check(bool(torch.isfinite(dec16).all()) and gap <= 2 * reach,
          f"{cfg.name}: bf16 decode is {gap} from the bf16 forward, past "
          f"twice rounding's reach {reach}")
    del m16, dec16, fwd16, fwd32
    if cfg.is_attention_free():      # mamba2: float32 at its full depth
        m32 = init_params(dataclasses.replace(cfg, **f32), generator=gen(),
                          device="cuda")
    elif moe32:                      # float32 at the published top-K
        routed = Transformer(dataclasses.replace(m32.cfg, **moe32), "cuda")
        load_param_tree(routed, param_tree(m32))
        m32 = routed
    dec32 = _teacher_forced(m32, tokens, S, T, st32)[0]
    fwd32 = _forward_rows(m32, tokens, S, T, st32)
    err = float((dec32 - fwd32).abs().max())
    print(f"decode {cfg.name} float32 at {m32.cfg.n_layers} blocks{note32}, "
          f"{B} x ({S} + {T}) tokens: max |decode - forward| {err:.3g} "
          f"(rtol = atol = {DECODE_F32_TOL})")
    check(torch.allclose(dec32, fwd32, rtol=DECODE_F32_TOL,
                         atol=DECODE_F32_TOL),
          f"{cfg.name}: float32 decode differs from the forward by {err}")
    return {"bf16_cut_max_abs_err": gap, "bf16_cut_rounding_reach": reach,
            "f32_max_abs_err": err}


def decode_path(args, captured, dry_dir):
    """gemma-7b and mamba2-130m at their published widths and depths
    (bf16, weights from --seed): a prompt of S tokens prefilled into a
    cache, then T teacher-forced decode steps, then the forward at the
    decoded positions (reported), and ``decode_checks``; on gemma-7b's
    weights, before they are freed, the steps path's prefill cell
    (``steps_prefill_cell``).  Returns the path's numbers by arch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params
    out = {}
    for arch, (B, S, T) in DECODE_RUNS.items():
        cfg = get_config(arch)
        width = RETRIEVAL_ARCHS[arch][0]
        check((cfg.n_layers, cfg.d_model, cfg.cdtype) == (*width,
                                                          torch.bfloat16),
              f"{arch} must decode at its published width and depth")
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(args.seed), device="cuda")
        tokens = _decode_tokens(cfg, args.seed, B, S + T)
        _teacher_forced(model, tokens, S, 1)                # warm
        # ---- the path: counts to 0, drive, read ------------------------
        ops.flash_attention_cuda = recorder(
            captured, "flash_attention_prefill", kfa.flash_attention_cuda)
        _reset_launches()
        dec, cache, prefill_ms, step_ms = _teacher_forced(model, tokens, S,
                                                          T)
        launches = _launch_counts()
        by_design = dict(kfa.flash_attention_cuda.launches_by_design)
        ops.flash_attention_cuda = kfa.flash_attention_cuda
        step = float(sorted(step_ms)[T // 2])
        cache_bytes = sum(t.nbytes for seg in cache for blk in seg.values()
                          for t in blk.values())
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        want = dict.fromkeys(launches, 0)
        if not cfg.is_attention_free():
            want["flash_attention"] = cfg.n_layers
        check(launches == want, f"{arch}: decode path launches {launches}, "
              f"expected {want} (the flash kernel once a dense block in "
              f"the prefill, nothing in decode)")
        check(by_design["tensor_core"] == want["flash_attention"],
              f"every prefill launch must take the tensor-core design: "
              f"{by_design}")
        print(f"phase decode {arch}: {cfg.n_layers} blocks, B = {B}, prompt "
              f"{S}, {T} steps, Smax {S + T}: prefill {prefill_ms:.2f} ms, "
              f"decode {step:.3f} ms a step (median; min {min(step_ms):.3f}"
              f", max {max(step_ms):.3f}), {B / step * 1e3:.1f} tokens/s; "
              f"cache {cache_bytes} bytes; peak device memory {peak:.2f} "
              f"GiB above the {held / 2**30:.2f} GiB held before; launches "
              f"{launches}")
        last = S + T - 1              # decoded again: the same row written
        rows, wall, n = traced(lambda: decode_step(
            model, tokens[:, last:last + 1], cache, last),
            f"one {arch} decode step")
        parts = device_parts(rows, "flash_attention")
        print(f"decode {arch} step device ms by part: " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()))
        del cache
        fwd = _forward_rows(model, tokens, S, T)
        check(bool(torch.isfinite(dec).all()) and bool(
              torch.isfinite(fwd).all()), f"{arch}: non-finite logits")
        err = float((dec - fwd).abs().max())
        top1 = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
        print(f"decode {arch} bf16 at {cfg.n_layers} blocks against the "
              f"forward at the {T + 1} decoded positions (reported, not "
              f"checked): max |logit difference| {err:.4g}, top-1 agreement "
              f"{top1:.4f}; {time.perf_counter() - t0:.1f} s")
        del dec, fwd
        peak_before = torch.cuda.max_memory_allocated()
        if arch == STEPS_PREFILL[0]:      # resets the peak statistics
            out["steps_prefill"] = steps_prefill_cell(model, dry_dir,
                                                      args.seed)
        del model
        torch.cuda.empty_cache()
        checks = decode_checks(cfg, args.seed)
        secs = time.perf_counter() - t0
        path_peak = max(peak_before,
                        torch.cuda.max_memory_allocated()) / 2**30
        print(f"phase decode {arch}: {secs:.1f} s with the checks, peak "
              f"device memory {path_peak:.2f} GiB (all held)")
        out[arch] = {"batch": B, "prompt": S, "steps": T, "seconds": secs,
                     "path_peak_gib": path_peak,
                     "prefill_ms": prefill_ms, "decode_step_ms": step,
                     "decode_step_ms_each": step_ms,
                     "tokens_per_s": B / step * 1e3,
                     "cache_bytes": cache_bytes, "peak_gib": peak,
                     "launches": launches, "bf16_max_abs_err": err,
                     "bf16_top1_agreement": top1,
                     "traced_step_wall_ms": wall,
                     "traced_step_launches": n,
                     "traced_step_device_ms": parts, **checks}
        torch.cuda.empty_cache()
    return out


def flash_prefill(a, launches):
    """The flash kernel at the decode path's prefill inputs (one layer's
    q, k, v of gemma-7b's prompt): the ``prefill_*`` keys of the
    ``flash_attention`` record."""
    (q, k, v), kw = a
    got = flash_measure(q, k, v, kw.get("causal", True),
                        "the decode path's prefill inputs")
    got.pop("design")
    return {"prefill_launches": launches, "prefill_shape": list(q.shape),
            **{f"prefill_{key}": val for key, val in got.items()}}


class MoEStats:
    """Stands in for ``models.moe``'s ``route`` and ``balance_loss``
    while a run goes (``with MoEStats() as st``): every call goes to the
    real function and its dropped choices and balance loss are kept as
    device tensors (``drops``, ``aux``), read after the run, in call
    order -- in a training step each MoE block's forward, then its
    rematerialisation in the backward."""

    def __init__(self):
        self.drops, self.aux = [], []

    def route(self, *a, **kw):
        r = self.real[0](*a, **kw)
        self.drops.append((~r.keep).sum())
        return r

    def balance_loss(self, *a, **kw):
        aux = self.real[1](*a, **kw)
        self.aux.append(aux.detach())
        return aux

    def __enter__(self):
        from repro_torch.models import moe
        self.real = moe.route, moe.balance_loss
        moe.route, moe.balance_loss = self.route, self.balance_loss
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route, moe.balance_loss = self.real

    def read(self):
        """(drops, aux) as host lists."""
        import torch
        if not self.drops:
            return [], []
        return (torch.stack(self.drops).tolist(),
                torch.stack(self.aux).tolist())


def _moe_blocks(cfg):
    return sum(len(s.kinds) * s.repeat for s in cfg.segments if s.moe)


def moe_params(cfg):
    """(all parameters, active parameters, expert-stack parameters): a
    token runs top_k of the n_experts experts of each MoE block, so the
    active count takes each block's stacks (3 E d f) at K / E:
    active = all - (1 - K / E) x experts."""
    from repro_torch.models import count_params
    m = cfg.moe
    experts = _moe_blocks(cfg) * 3 * m.n_experts * cfg.d_model * m.d_ff_expert
    n = count_params(cfg)
    return n, n - experts * (1 - m.top_k / m.n_experts), experts


def moe_expert_flops(cfg, tokens):
    """(the FLOPs a forward's expert products do as run -- every one of the
    E x C capacity-padded slots of each MoE block, C = ``moe.capacity``
    of the call's tokens -- and those of the tokens' own top-k choices),
    2 FLOPs a multiply-add, three products a slot."""
    from repro_torch.models import moe
    m = cfg.moe
    per_slot = 2 * 3 * cfg.d_model * m.d_ff_expert * _moe_blocks(cfg)
    return (per_slot * m.n_experts * moe.capacity(cfg, tokens),
            per_slot * tokens * m.top_k)


def moe_step_parts(fn, cfg, adamw_ms):
    """Trace one training step (after a warm one) and split its device
    time: the flash forward and gradient kernels by name; the expert
    products (the kernels of ``aten::bmm``, which in a training step only
    the MoE layers call, forward and backward); the other products
    (gemm kernels elsewhere: projections, the router, the head); the
    routing/dispatch/combine (the kernels of the operators in MOE_OPS,
    less the embedding's backward, an ``index_put`` into the table);
    AdamW (``adamw_ms``, the update timed alone); and the glue, the
    rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    part = dict.fromkeys(("flash_fwd", "flash_bwd", "expert_products",
                          "other_products", "routing_dispatch_combine",
                          "adamw", "glue"), 0.0)
    busy, launches, products, other = 0.0, 0, 0.0, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms, key = e.self_device_time_total / 1e3, e.key.lower()
        busy, launches = busy + ms, launches + e.count
        if "fa_bwd" in key:
            part["flash_bwd"] += ms
        elif "flash_attention" in key:
            part["flash_fwd"] += ms
        elif any(w in key for w in ("gemm", "xmma", "cutlass", "nvjet")):
            products += ms
        else:
            other += ms
    table = [cfg.vocab_padded, cfg.d_model]
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU or e.self_device_time_total <= 0:
            continue
        ms, key = e.self_device_time_total / 1e3, e.key
        shapes = getattr(e, "input_shapes", None) or [[]]
        if key == "aten::bmm":
            part["expert_products"] += ms
        elif (any(w in key for w in MOE_OPS)
              and not ("index_put" in key and list(shapes[0]) == table)):
            part["routing_dispatch_combine"] += ms
    part["other_products"] = products - part["expert_products"]
    part["adamw"] = adamw_ms
    part["glue"] = other - part["routing_dispatch_combine"] - adamw_ms
    print(f"profile: one {cfg.name} training step {wall:.2f} ms wall, device "
          f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%), {launches} kernel "
          f"launches; device ms by part: " + ", ".join(
              f"{k} {v:.2f}" for k, v in part.items())
          + " (adamw: the update of the whole state timed alone; glue: "
            "the rest)")
    return {"wall_ms": wall, "busy_ms": busy, "launches": launches, **part}


def moe_train(args, arch, captured):
    """``arch`` at its published width (cut as MOE_TRAIN says) trained by
    ``launch/train.py`` through the flash forward and gradient kernels
    and AdamW in the fault-tolerant loop, with an injected failure whose
    replay must repeat an uninterrupted run bit for bit; the balance loss
    and the dropped choices of every step; the step's ms, tokens/s, model
    TFLOP/s on the active parameters, peak memory and a traced step by
    part; float32 at DECODE_CUT blocks, the card against the CPU."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import (Transformer, init_params, load_param_tree,
                                    param_tree, value_and_grad)
    from repro_torch.models.moe import capacity
    layers, batch, seq = MOE_TRAIN[arch]
    cfg = train.cut_depth(get_config(arch), layers)
    n_params, active, experts = moe_params(cfg)
    n_moe = _moe_blocks(cfg)
    tokens = batch * seq
    padded, own = moe_expert_flops(cfg, tokens)
    C = capacity(cfg, tokens)
    print(f"phase moe train {arch}: {cfg.n_layers} of "
          f"{MOE_WIDTHS[arch][0]} blocks ({n_moe} MoE), {n_params / 1e9:.3f} "
          f"B parameters (count_params), {active / 1e9:.3f} B active "
          f"(all - (1 - K/E) x the {experts / 1e9:.3f} B of the expert "
          f"stacks), {batch} x {seq} tokens a step; a forward's expert "
          f"products do {padded / 1e12:.3f} TFLOP as run ({cfg.moe.n_experts}"
          f" x {C} capacity-padded slots a block) against {own / 1e12:.3f} "
          f"for the tokens' own top-{cfg.moe.top_k} choices")
    ops.flash_attention_cuda = kfa.flash_attention_cuda
    ops.flash_attention_bwd_cuda = recorder(
        captured, f"flash_attention_bwd {arch}", kfa.flash_attention_bwd_cuda)
    runs = {}
    for name, fail in ((f"failure at step {MOE_FAIL_AT}", True),
                       ("uninterrupted", False)):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as ck:
            argv = ["--arch", arch, "--steps", str(MOE_STEPS), "--batch",
                    str(batch), "--seq", str(seq), "--lr", "3e-4",
                    "--ckpt-dir", ck, "--ckpt-every", str(MOE_CKPT_EVERY),
                    "--device", "cuda", "--seed", str(args.seed)]
            argv += ["--layers", str(layers)] if layers else []
            argv += ["--fail-at", str(MOE_FAIL_AT)] if fail else []
            _reset_launches()
            held = torch.cuda.memory_allocated()   # by the earlier paths
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with MemoryCheckpoints() as ckpts, MoEStats() as st:
                stats = train.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = _launch_counts()
        by_design = {
            "flash_attention": dict(
                kfa.flash_attention_cuda.launches_by_design),
            "flash_attention_bwd": dict(
                kfa.flash_attention_bwd_cuda.launches_by_design)}
        runs[name] = (stats, st.read(), launches, by_design)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        print(f"phase moe train {arch} ({name}): {stats.steps_run} steps, "
              f"{stats.restarts} restarts, {secs:.1f} s with the token draws "
              f"and {ckpts.saves} checkpoints of {ckpts.nbytes / 1e9:.2f} GB "
              f"in host memory ({ckpts.seconds:.1f} s to save and restore); "
              f"loss {stats.losses[0]:.4f} -> {stats.losses[-1]:.4f}; "
              f"launches {launches}, by design {by_design}; peak device "
              f"memory {peak:.2f} GiB above the {held / 2**30:.2f} GiB held "
              f"before the run")
        n = stats.steps_run
        check(launches["flash_attention"] == 2 * cfg.n_layers * n,
              "each step launches the flash kernel twice a layer (forward "
              "and the rematerialised forward)")
        check(launches["flash_attention_bwd"] == cfg.n_layers * n,
              "each step launches the flash gradient kernel once a layer")
        for k, designs in by_design.items():
            check(designs["tensor_core"] == launches[k],
                  f"every training launch of {k} must take the tensor-core "
                  f"design: {by_design[k]}")
        check(all(math.isfinite(v) for v in stats.losses),
              "non-finite training loss")
        check(np.mean(stats.losses[-5:]) < np.mean(stats.losses[:5]),
              f"{arch}: the loss did not fall")
        torch.cuda.empty_cache()
    (failed, *_), (clean, (drops, aux), launches, by_design) = (
        runs[f"failure at step {MOE_FAIL_AT}"], runs["uninterrupted"])
    want = _replayed(clean.losses, (MOE_FAIL_AT,), MOE_CKPT_EVERY)
    check(failed.restarts == 1 and failed.losses == want,
          f"{arch}: the run with a failure must repeat the uninterrupted "
          f"run's loss trajectory bit for bit")
    # each step: every MoE block's forward, then its rematerialisation
    per = 2 * n_moe
    check(len(drops) == MOE_STEPS * per, f"{len(drops)} MoE calls in "
          f"{MOE_STEPS} steps of {n_moe} MoE blocks")
    step_aux = [sum(aux[i * per:i * per + n_moe]) for i in range(MOE_STEPS)]
    step_drops = [sum(drops[i * per:i * per + n_moe])
                  for i in range(MOE_STEPS)]
    check(all(math.isfinite(a) and a > 0 for a in step_aux),
          f"{arch}: a balance loss is not finite and positive")
    print(f"moe train {arch}: the replayed trajectory equals the "
          f"uninterrupted one bitwise over {len(want)} losses; losses "
          f"{[round(v, 4) for v in clean.losses]}; balance loss a step "
          f"(summed over the {n_moe} MoE blocks) "
          f"{[round(a, 4) for a in step_aux]}; dropped choices a step (of "
          f"{tokens * cfg.moe.top_k * n_moe}) {step_drops}")
    out = {"blocks": cfg.n_layers, "params": n_params,
           "launches": launches, "launches_by_design": by_design,
           "active_params": active, "batch": batch, "seq": seq,
           "losses": clean.losses, "balance_loss": step_aux,
           "dropped": step_drops, "capacity": C,
           "expert_tflop_as_run": padded / 1e12,
           "expert_tflop_own": own / 1e12}

    # ---- step time, tokens/s, model FLOP/s, peak memory, the trace -------
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    params = param_tree(model)
    pipe = TokenPipeline(cfg.vocab, batch, seq, seed=args.seed,
                         device="cuda")
    draw_ms, data = timed(lambda: pipe._batch_at(0), 1)
    opt_cfg = optim.AdamWConfig(warmup_steps=10, total_steps=MOE_STEPS)
    step = train.make_step(model, opt_cfg)
    with train.deterministic():
        state = (params, optim.init(params))
        del params
        held = torch.cuda.memory_allocated()   # with the model and state
        torch.cuda.reset_peak_memory_stats()
        step_ms = _each_ms(lambda: step(state, data), MOE_TIMED)
        peak = torch.cuda.max_memory_allocated()
        tokens_s = tokens / (step_ms / 1e3)
        tflops = 6 * active * tokens / (step_ms / 1e3) / 1e12
        run_tflops = (6 * (n_params - experts) * tokens + 4 * padded) / (
            step_ms / 1e3) / 1e12
        print(f"moe train {arch} step: {step_ms:.2f} ms (CUDA events, mean "
              f"of {MOE_TIMED} after one warm-up; forward, backward and "
              f"AdamW), {tokens_s:.0f} tokens/s, {tflops:.2f} model TFLOP/s "
              f"(6 x {active / 1e9:.3f} B active parameters x {tokens} "
              f"tokens), {run_tflops:.2f} TFLOP/s as run (6 x the "
              f"{(n_params - experts) / 1e9:.3f} B outside the expert stacks "
              f"x tokens + 4 x the expert products' {padded / 1e12:.3f} "
              f"TFLOP: forward, its rematerialisation, backward twice); "
              f"peak device memory {peak / 2**30:.2f} GiB "
              f"({(peak - held) / 2**30:.2f} above the {held / 2**30:.2f} GiB "
              f"of the model, its state, the batch and earlier paths); "
              f"TokenPipeline draw {draw_ms:.1f} ms a batch")
        _, grads = value_and_grad(model, *data)
        adamw_ms = _each_ms(lambda: optim.update(opt_cfg, grads, state[1],
                                                 state[0]), MOE_TIMED)
        del grads
        parts = moe_step_parts(lambda: step(state, data), cfg, adamw_ms)
    out.update(step_ms=step_ms, tokens_s=tokens_s, model_tflops=tflops,
               as_run_tflops=run_tflops, peak_gib=peak / 2**30,
               draw_ms=draw_ms, traced_step=parts)
    few = (data[0][:1, :MOE_F32_TOKENS].cpu(),
           data[1][:1, :MOE_F32_TOKENS].cpu())
    del state, step, model, data
    torch.cuda.empty_cache()

    # ---- float32 at DECODE_CUT blocks of the published width --------------
    c16 = train.cut_depth(get_config(arch), DECODE_CUT)
    c32 = dataclasses.replace(c16, param_dtype="float32",
                              compute_dtype="float32")
    m16 = init_params(c16, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    m32 = Transformer(c32, "cpu")
    load_param_tree(m32, param_tree(m16))
    del m16
    t0 = time.perf_counter()
    l32, g32 = value_and_grad(m32, *few)
    print(f"moe train {arch} float32 on the CPU: {time.perf_counter() - t0:.1f}"
          f" s")
    out["f32_card_vs_cpu"] = f32_card_vs_cpu(c32, m32, few, l32, g32, False)
    del m32, g32
    torch.cuda.empty_cache()
    return out


def moe_decode(args, arch, captured):
    """``arch`` at its published width and depth (bf16, weights from
    --seed): MOE_DECODE's prompts prefilled into a cache and teacher-forced
    decode steps, as the decode path runs them; the dropped choices at
    the published capacity factor (at the prefill and at decode, counted
    in the warm-up run); every cache row not written yet zero; the
    forward at the decoded positions (reported); ``decode_checks`` with
    the capacity factor raised to E / K."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params
    from repro_torch.models.moe import capacity
    B, S, T = MOE_DECODE
    cfg = get_config(arch)
    K = cfg.moe.top_k
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.hd if cfg.mla is None else cfg.mla.nope_dim + cfg.mla.rope_dim,
           cfg.hd if cfg.mla is None else cfg.mla.v_dim,
           cfg.moe.n_experts, cfg.moe.top_k)
    check(got == MOE_WIDTHS[arch] and cfg.cdtype == torch.bfloat16,
          f"{arch} must decode at its published width and depth: {got}")
    n_moe = _moe_blocks(cfg)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    tokens = _decode_tokens(cfg, args.seed, B, S + T)
    with MoEStats() as st:                    # the warm-up run
        _teacher_forced(model, tokens, S, 2)
    drops, _ = st.read()
    check(len(drops) == 3 * n_moe, f"{len(drops)} MoE calls")
    prefill_drops = sum(drops[:n_moe])
    decode_drops = [sum(drops[n_moe * i:n_moe * (i + 1)]) for i in (1, 2)]
    print(f"moe decode {arch}: dropped choices at capacity factor "
          f"{cfg.moe.capacity_factor}: prefill {prefill_drops} of "
          f"{B * S * K * n_moe} (C = {capacity(cfg, B * S)} an expert), "
          f"a decode step {decode_drops} of {B * K * n_moe} (C = "
          f"{capacity(cfg, B)})")
    # ---- the path: counts to 0, drive, read --------------------------------
    ops.flash_attention_cuda = recorder(
        captured, f"flash_attention_prefill {arch}", kfa.flash_attention_cuda)
    _reset_launches()
    dec, cache, prefill_ms, step_ms = _teacher_forced(model, tokens, S, T)
    launches = _launch_counts()
    by_design = dict(kfa.flash_attention_cuda.launches_by_design)
    ops.flash_attention_cuda = kfa.flash_attention_cuda
    step = float(sorted(step_ms)[T // 2])
    cache_bytes = sum(t.nbytes for seg in cache for blk in seg.values()
                      for t in blk.values())
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = cfg.n_layers
    check(launches == want, f"{arch}: decode launches {launches}, expected "
          f"{want} (the flash kernel once a block in the prefill)")
    check(by_design["tensor_core"] == cfg.n_layers,
          f"every prefill launch must take the tensor-core design: "
          f"{by_design}")
    if cfg.mla is not None:
        m = cfg.mla
        latent = (cfg.n_layers * B * (S + T) * (m.kv_lora + m.rope_dim)
                  * cache[0]["b0"]["ckv"].element_size())
        check(cache_bytes == latent, f"latent cache {cache_bytes} bytes, "
              f"expected {latent}")
    print(f"phase moe decode {arch}: {cfg.n_layers} blocks, B = {B}, prompt "
          f"{S}, {T} steps, Smax {S + T}: prefill {prefill_ms:.2f} ms, decode "
          f"{step:.3f} ms a step (median; min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}), {B / step * 1e3:.1f} tokens/s; cache "
          f"{cache_bytes} bytes; peak device memory {peak:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held before; launches {launches}, flash "
          f"by design {by_design}")
    last = S + T - 1
    rows, wall, n = traced(lambda: decode_step(
        model, tokens[:, last:last + 1], cache, last),
        f"one {arch} decode step")
    parts = device_parts(rows, "flash_attention")
    print(f"moe decode {arch} step device ms by part: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    del cache
    fwd = _forward_rows(model, tokens, S, T)
    check(bool(torch.isfinite(dec).all()) and bool(torch.isfinite(fwd).all()),
          f"{arch}: non-finite logits")
    err = float((dec - fwd).abs().max())
    top1 = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    print(f"moe decode {arch} bf16 at {cfg.n_layers} blocks against the "
          f"forward at the {T + 1} decoded positions (reported, not checked: "
          f"the forward routes all B x (S + T) tokens in one call, decode "
          f"B at a time, so their drops differ): max |logit difference| "
          f"{err:.4g}, top-1 agreement {top1:.4f}; "
          f"{time.perf_counter() - t0:.1f} s")
    del model, dec, fwd
    torch.cuda.empty_cache()
    checks = decode_checks(cfg, args.seed)
    return {"batch": B, "prompt": S, "steps": T,
            "prefill_ms": prefill_ms, "decode_step_ms": step,
            "decode_step_ms_each": step_ms, "tokens_per_s": B / step * 1e3,
            "cache_bytes": cache_bytes, "peak_gib": peak,
            "launches": launches, "prefill_dropped": prefill_drops,
            "decode_dropped": decode_drops, "bf16_max_abs_err": err,
            "bf16_top1_agreement": top1, "traced_step_wall_ms": wall,
            "traced_step_launches": n, "traced_step_device_ms": parts,
            **checks}


def flash_pad_cost(q, v):
    """The forward wrapper's zero-padding of a v narrower than q (MLA):
    its ms alone (CUDA events) and the bytes it adds -- v read and the
    padded v written by the pad, then the kernel's extra columns of v
    read and of O written."""
    from repro_torch.kernels import flash_attention as kfa
    dh, dv = q.shape[-1], v.shape[-1]
    ms, _ = timed(lambda: kfa._widen(v, dh), REPS)
    rows = v.numel() // dv
    extra = (rows * (dv + dh) + rows * (dh - dv)
             + q.numel() // dh * (dh - dv)) * v.element_size()
    return ms, extra


def moe_path(args, captured):
    """The two MoE configs in turn, each model freed before the next:
    granite-moe-1b-a400m trained and decoded, deepseek-v2-lite-16b
    decoded and trained; then the flash kernels at their prefill and
    training inputs.  Returns the path's numbers and the flash records'
    keys."""
    import torch
    out, fwd_keys, bwd_keys = {}, {}, {}
    t_path = time.perf_counter()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for arch, order in (("granite-moe-1b-a400m", ("train", "decode")),
                        ("deepseek-v2-lite-16b", ("decode", "train"))):
        out[arch] = {}
        for what in order:
            t0 = time.perf_counter()
            run = moe_train if what == "train" else moe_decode
            out[arch][what] = run(args, arch, captured)
            out[arch][what]["seconds"] = time.perf_counter() - t0
            print(f"phase moe {what} {arch}: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
        (q, k, v), kw = captured.pop(f"flash_attention_prefill {arch}")
        rec = flash_measure(q, k, v, kw.get("causal", True),
                            f"the moe path's {arch} prefill inputs")
        if v.shape[-1] != q.shape[-1]:
            rec["pad_ms"], rec["pad_bytes"] = flash_pad_cost(q, v)
            print(f"flash_attention at {arch}'s prefill: v zero-padded from "
                  f"{v.shape[-1]} to {q.shape[-1]} columns, {rec['pad_ms']:.4f}"
                  f" ms alone, {rec['pad_bytes'] / 1e6:.1f} MB more traffic")
        rec.update(shape=list(q.shape), v_width=v.shape[-1],
                   launches=out[arch]["decode"]["launches"]["flash_attention"])
        fwd_keys[arch] = rec
        del q, k, v
        a, kw = captured.pop(f"flash_attention_bwd {arch}")
        bwd_keys[arch] = flash_bwd_measure(
            a, kw, f"the moe path's {arch} training inputs")
        bwd_keys[arch].update(shape=list(a[0].shape), v_width=a[2].shape[-1])
        del a
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    secs = time.perf_counter() - t_path
    print(f"phase moe: {secs:.1f} s; peak device memory {peak:.2f} GiB with "
          f"the {held / 2**30:.2f} GiB earlier paths hold")
    out["seconds"], out["peak_gib"] = secs, peak
    return out, fwd_keys, bwd_keys


class Regions:
    """Marks the RG-LRU scan (``rglru.linear_scan``) and the plain
    attention score paths (``_einsum_attn``, ``_chunked_attn``,
    ``_decode_attn_delta``, which run the sliding window) as
    torch.profiler ranges while in use (``with Regions()``): a trace's
    ``key_averages()`` then gives each range's device time, the kernels
    launched inside it summed (``device_ms``)."""

    NAMES = {"linear_scan": "rglru_scan", "_einsum_attn": "window_attn",
             "_chunked_attn": "window_attn",
             "_decode_attn_delta": "window_attn"}

    def __enter__(self):
        import torch
        from repro_torch.models import attention, rglru
        self.real = []
        for mod in (rglru, attention):
            for fn, tag in self.NAMES.items():
                if not hasattr(mod, fn):
                    continue
                real = getattr(mod, fn)
                self.real.append((mod, fn, real))

                def marked(*a, real=real, tag=tag, **kw):
                    with torch.profiler.record_function(f"region::{tag}"):
                        return real(*a, **kw)
                setattr(mod, fn, marked)
        return self

    def __exit__(self, *exc):
        for mod, fn, real in self.real:
            setattr(mod, fn, real)

    @staticmethod
    def device_ms(fn, what):
        """Trace fn() (after a warm call) inside the ranges: (the traced
        kernel rows, wall ms, launches, {range: device ms})."""
        marks = dict.fromkeys(set(Regions.NAMES.values()), 0.0)
        with Regions():
            rows, wall, n = traced(fn, what, marks)
        print(f"{what}: device ms inside the marked ranges "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(marks.items())))
        return rows, wall, n, marks


def shape_recorder(captured, prefix, fn):
    """fn, recording the arguments of its first call at each (Sq, Sk,
    causal) under f"{prefix} {Sq}x{Sk}" (" causal" appended if causal)."""
    return keyed_recorder(
        captured, prefix, fn, lambda q, k, *a, **kw: f"{q.shape[2]}x"
        f"{k.shape[2]}" + (" causal" if kw.get("causal", True) else ""))


def _serve_run(model, tokens, S, T, what, stubs=None):
    """``_teacher_forced`` with every launch count set to 0 just before
    and read just after, the flash launches by design, the median step,
    cache bytes and peak memory above what was held; prints them."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    dec, cache, prefill_ms, step_ms = _teacher_forced(model, tokens, S, T,
                                                      stubs)
    launches = _launch_counts()
    by_design = dict(kfa.flash_attention_cuda.launches_by_design)
    step = float(sorted(step_ms)[T // 2])
    cache_bytes = sum(t.nbytes for seg in cache for blk in seg.values()
                      for t in blk.values())
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    B = tokens.shape[0]
    print(f"phase {what}: {model.cfg.n_layers} blocks, B = {B}, prompt {S}"
          f", {T} steps: prefill {prefill_ms:.2f} ms, decode {step:.3f} ms a "
          f"step (median; min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
          f"{B / step * 1e3:.1f} tokens/s; cache {cache_bytes} bytes; peak "
          f"device memory {peak:.2f} GiB above the {held / 2**30:.2f} GiB "
          f"held before; launches {launches}, flash by design {by_design}")
    check(by_design["tensor_core"] == launches["flash_attention"],
          f"{what}: every flash launch must take the tensor-core design: "
          f"{by_design}")
    return dec, cache, {"batch": B, "prompt": S, "steps": T,
                        "prefill_ms": prefill_ms, "decode_step_ms": step,
                        "decode_step_ms_each": step_ms,
                        "tokens_per_s": B / step * 1e3,
                        "cache_bytes": cache_bytes, "peak_gib": peak,
                        "launches": launches}


def _only(launches, **want):
    """``launches`` must be ``want`` for the kernels named and 0 for every
    other."""
    full = dict.fromkeys(launches, 0)
    full.update(want)
    return launches == full, full


def _timed_blocks(model, tokens, stubs=None):
    """The blocks' forward (``hidden_states``: the head is left out) with
    every launch count set to 0 just before and read just after: (ms by
    CUDA events, launches, the flash launches by design)."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import hidden_states
    hidden_states(model, tokens, **(stubs or {}))          # warm
    torch.cuda.synchronize()
    _reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    hidden_states(model, tokens, **(stubs or {}))
    stop.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(stop), _launch_counts(),
            dict(kfa.flash_attention_cuda.launches_by_design))


def _train_runs(arch, layers, batch, seq, seed, what):
    """``launch/train.py`` on ``arch`` cut to ``layers`` blocks:
    HYBRID_STEPS steps with a failure at HYBRID_FAIL_AT and the same run
    uninterrupted, checkpoints in host memory; each run with every launch
    count set to 0 just before and read just after.  Checks the flash
    launches a step, the tensor-core design, a falling loss and the
    replay bitwise.  Returns (the uninterrupted run's stats, its
    launches, by design)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import train
    cfg = train.cut_depth(get_config(arch), layers)
    attn = sum(k != "rglru" for s in cfg.segments for k in s.kinds
               for _ in range(s.repeat))
    runs = {}
    for name, fail in ((f"failure at step {HYBRID_FAIL_AT}", True),
                       ("uninterrupted", False)):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_hybrid_") as ck:
            argv = ["--arch", arch, "--steps", str(HYBRID_STEPS), "--batch",
                    str(batch), "--seq", str(seq), "--lr", "3e-4",
                    "--ckpt-dir", ck, "--ckpt-every", str(HYBRID_CKPT_EVERY),
                    "--device", "cuda", "--seed", str(seed), "--layers",
                    str(layers)]
            argv += ["--fail-at", str(HYBRID_FAIL_AT)] if fail else []
            _reset_launches()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with MemoryCheckpoints() as ckpts:
                stats = train.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = _launch_counts()
        by_design = {
            "flash_attention": dict(
                kfa.flash_attention_cuda.launches_by_design),
            "flash_attention_bwd": dict(
                kfa.flash_attention_bwd_cuda.launches_by_design)}
        runs[name] = (stats, launches, by_design)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        print(f"phase {what} ({name}): {stats.steps_run} steps, "
              f"{stats.restarts} restarts, {secs:.1f} s with the token draws "
              f"and {ckpts.saves} checkpoints of {ckpts.nbytes / 1e9:.2f} GB "
              f"in host memory ({ckpts.seconds:.1f} s to save and restore); "
              f"loss {stats.losses[0]:.4f} -> {stats.losses[-1]:.4f}; "
              f"launches {launches}, by design {by_design}; peak device "
              f"memory {peak:.2f} GiB above the {held / 2**30:.2f} GiB held "
              f"before the run")
        n = stats.steps_run
        ok, want = _only(launches, flash_attention=2 * attn * n,
                         flash_attention_bwd=attn * n)
        check(ok, f"{what}: launches {launches}, expected {want} (the flash "
              f"kernel twice an attention block a step, forward and its "
              f"rematerialisation, and its gradient once)")
        for k, designs in by_design.items():
            check(designs["tensor_core"] == launches[k],
                  f"every training launch of {k} must take the tensor-core "
                  f"design: {by_design[k]}")
        check(all(math.isfinite(v) for v in stats.losses),
              "non-finite training loss")
        check(np.mean(stats.losses[-5:]) < np.mean(stats.losses[:5]),
              f"{what}: the loss did not fall")
        torch.cuda.empty_cache()
    (failed, *_), (clean, launches, by_design) = (
        runs[f"failure at step {HYBRID_FAIL_AT}"], runs["uninterrupted"])
    want = _replayed(clean.losses, (HYBRID_FAIL_AT,), HYBRID_CKPT_EVERY)
    check(failed.restarts == 1 and failed.losses == want,
          f"{what}: the run with a failure must repeat the uninterrupted "
          f"run's loss trajectory bit for bit")
    print(f"{what}: the replayed trajectory equals the uninterrupted one "
          f"bitwise over {len(want)} losses; losses "
          f"{[round(v, 4) for v in clean.losses]}")
    return clean, launches, by_design


def _step_numbers(cfg, batch, seq, seed, what):
    """One training step of ``cfg`` (``launch/train.make_step``: forward,
    backward and AdamW) timed over HYBRID_TIMED after a warm one: ms,
    tokens/s, model TFLOP/s (6 x ``count_params`` x tokens), peak memory,
    the draw of a batch, a traced step."""
    import torch
    from repro_torch import optim
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import count_params, init_params, param_tree
    n_params = count_params(cfg)
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    params = param_tree(model)
    pipe = TokenPipeline(cfg.vocab, batch, seq, seed=seed, device="cuda")
    draw_ms, data = timed(lambda: pipe._batch_at(0), 1)
    opt_cfg = optim.AdamWConfig(warmup_steps=10, total_steps=HYBRID_STEPS)
    step = train.make_step(model, opt_cfg)
    with train.deterministic():
        state = (params, optim.init(params))
        del params
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_ms = _each_ms(lambda: step(state, data), HYBRID_TIMED)
        peak = torch.cuda.max_memory_allocated()
        tokens = batch * seq
        tokens_s = tokens / (step_ms / 1e3)
        tflops = 6 * n_params * tokens / (step_ms / 1e3) / 1e12
        print(f"{what} step: {step_ms:.2f} ms (CUDA events, mean of "
              f"{HYBRID_TIMED} after one warm-up; forward, backward and "
              f"AdamW), {tokens_s:.0f} tokens/s, {tflops:.2f} model TFLOP/s "
              f"(6 x {n_params / 1e9:.3f} B parameters x {tokens} tokens); "
              f"peak device memory {peak / 2**30:.2f} GiB "
              f"({(peak - held) / 2**30:.2f} above the {held / 2**30:.2f} GiB"
              f" of the model, its state, the batch and earlier paths); "
              f"TokenPipeline draw {draw_ms:.1f} ms a batch")
        rows, wall, n, regions = Regions.device_ms(
            lambda: step(state, data), f"one {what} step")
        parts = device_parts(rows, "flash_attention")
        parts["flash_attention_bwd"] = sum(
            e.self_device_time_total / 1e3 for e in rows
            if "fa_bwd" in e.key.lower())
        print(f"{what} step device ms by part: " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()))
    out = {"params": n_params, "batch": batch, "seq": seq,
           "step_ms": step_ms, "tokens_s": tokens_s, "model_tflops": tflops,
           "peak_gib": peak / 2**30, "draw_ms": draw_ms,
           "traced_step_wall_ms": wall, "traced_step_launches": n,
           "traced_step_device_ms": parts, "traced_step_regions_ms": regions}
    few = (data[0][:1, :HYBRID_F32_TOKENS].cpu(),
           data[1][:1, :HYBRID_F32_TOKENS].cpu())
    del state, step, model, data
    torch.cuda.empty_cache()
    return out, few


def _f32_grads(cfg, cut_cfg, seed, few, stubs=None):
    """float32 at ``cut_cfg`` (the published width, cut): the card's loss
    and gradient against the CPU's plain versions', with ``stubs`` (the
    stub frontends' inputs) where given."""
    import dataclasses

    import torch
    from repro_torch.models import (Transformer, init_params,
                                    load_param_tree, param_tree,
                                    value_and_grad)
    c32 = dataclasses.replace(cut_cfg, param_dtype="float32",
                              compute_dtype="float32")
    m16 = init_params(cut_cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    m32 = Transformer(c32, "cpu")
    load_param_tree(m32, param_tree(m16))
    del m16
    cpu_stubs = {k: t.float().cpu() for k, t in (stubs or {}).items()}
    t0 = time.perf_counter()
    l32, g32 = value_and_grad(m32, *few, **cpu_stubs)
    print(f"{cfg.name} float32 at {c32.n_layers} blocks on the CPU: "
          f"{time.perf_counter() - t0:.1f} s")
    out = f32_card_vs_cpu(c32, m32, few, l32, g32, False, cpu_stubs)
    del m32, g32
    torch.cuda.empty_cache()
    return out


def hybrid_path(args, captured):
    """recurrentgemma-2b at its published width and depth (26 blocks: 8
    units of two RG-LRU blocks and a sliding-window attention block of
    window 2,048, then two RG-LRU blocks; bf16, weights from --seed): the
    blocks' forward over HYBRID_FORWARD tokens (the window masks nothing:
    the flash kernel once a local block), a prefill of HYBRID_DECODE's
    prompts, twice the window (the plain windowed paths), and its
    teacher-forced decode steps (the window in the one-token path), the
    device time of the RG-LRU scan and of the windowed attention; decode
    against the forward at HYBRID_CUT blocks past the window (float32
    within DECODE_F32_TOL, bf16 within rounding's reach); then training
    by ``launch/train.py`` cut to HYBRID_TRAIN's blocks, a failure's
    replay bitwise, and float32 on the card against the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import (attention, decode_step, hidden_states,
                                    init_cache, init_params, prefill, rglru)
    t_path = time.perf_counter()
    held0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(HYBRID_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.window, cfg.cdtype) == (26, 2560, 10, 1, 256, 2048,
                                       torch.bfloat16),
          f"{HYBRID_ARCH} must run at its published width and depth")
    local = sum(k == "local" for s in cfg.segments for k in s.kinds
                for _ in range(s.repeat))
    out = {"local_blocks": local}
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    # ---- the blocks' forward: the window masks nothing ---------------------
    B, S = HYBRID_FORWARD
    tokens = _decode_tokens(cfg, args.seed, B, S)
    ops.flash_attention_cuda = shape_recorder(captured, "hybrid",
                                              kfa.flash_attention_cuda)
    ms, launches, by_design = _timed_blocks(model, tokens)
    ops.flash_attention_cuda = kfa.flash_attention_cuda
    ok, want = _only(launches, flash_attention=local)
    check(ok and by_design["tensor_core"] == local,
          f"{HYBRID_ARCH} forward: launches {launches}, expected {want}, all "
          f"tensor_core ({by_design}): the flash kernel once a local block")
    print(f"phase hybrid forward: {B} x {S} tokens through {cfg.n_layers} "
          f"blocks in {ms:.2f} ms ({B * S / ms * 1e3:.0f} tokens/s; the head "
          f"left out); launches {launches}")
    rows, wall, n, regions = Regions.device_ms(
        lambda: hidden_states(model, tokens), f"one {HYBRID_ARCH} forward")
    out["forward"] = {"batch": B, "seq": S, "ms": ms, "launches": launches,
                      "traced_device_ms": device_parts(rows,
                                                       "flash_attention"),
                      "traced_regions_ms": regions}
    # ---- prefill past the window, then decode --------------------------------
    B, S, T = HYBRID_DECODE
    tokens = _decode_tokens(cfg, args.seed, B, S + T)
    # the warm run: the first inputs of the scan (the prefill's) and of
    # the windowed attention at the prefill and at a decode step
    marked = [(mod, name, getattr(mod, name)) for mod, name in (
        (rglru, "linear_scan"), (attention, "_chunked_attn"),
        (attention, "_einsum_attn"), (attention, "_decode_attn_delta"))]
    for mod, name, real in marked:
        setattr(mod, name, recorder(captured, f"hybrid {name}", real))
    _teacher_forced(model, tokens, S, 1)
    for mod, name, real in marked:
        setattr(mod, name, real)
    dec, cache, rec = _serve_run(model, tokens, S, T, "hybrid decode")
    ok, want = _only(rec["launches"])
    check(ok, f"{HYBRID_ARCH} prefill of {S} tokens (past the window) and "
          f"decode: launches {rec['launches']}, expected {want} (the plain "
          f"windowed paths)")
    last = S + T - 1
    rows, wall, n, regions = Regions.device_ms(lambda: decode_step(
        model, tokens[:, last:last + 1], cache, last),
        f"one {HYBRID_ARCH} decode step")
    rec.update(traced_step_wall_ms=wall, traced_step_launches=n,
               traced_step_device_ms=device_parts(rows, "flash_attention"),
               traced_step_regions_ms=regions)
    del cache
    cache = init_cache(cfg, B, S + T, device="cuda")
    rows, wall, n, regions = Regions.device_ms(
        lambda: prefill(model, tokens[:, :S], cache),
        f"one {HYBRID_ARCH} prefill of {B} x {S}")
    rec.update(traced_prefill_wall_ms=wall, traced_prefill_launches=n,
               traced_prefill_device_ms=device_parts(rows, "flash_attention"),
               traced_prefill_regions_ms=regions)
    del cache
    fwd = _forward_rows(model, tokens, S, T)
    check(bool(torch.isfinite(dec).all()) and bool(torch.isfinite(fwd).all()),
          f"{HYBRID_ARCH}: non-finite logits")
    err = float((dec - fwd).abs().max())
    top1 = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    print(f"hybrid decode bf16 at {cfg.n_layers} blocks against the forward "
          f"at the {T + 1} decoded positions (reported, not checked): max "
          f"|logit difference| {err:.4g}, top-1 agreement {top1:.4f}")
    rec.update(bf16_max_abs_err=err, bf16_top1_agreement=top1)
    rec.update(hybrid_parts(captured, local, cfg.n_layers - local))
    out["decode"] = rec
    del model, dec, fwd, tokens
    torch.cuda.empty_cache()
    out["decode"].update(decode_checks(cfg, args.seed, HYBRID_CUT,
                                       HYBRID_CHECK))
    torch.cuda.empty_cache()
    # ---- training ----------------------------------------------------------------
    layers, batch, seq = HYBRID_TRAIN
    tcfg = train.cut_depth(cfg, layers)
    ops.flash_attention_bwd_cuda = recorder(
        captured, "flash_attention_bwd hybrid", kfa.flash_attention_bwd_cuda)
    clean, launches, by_design = _train_runs(HYBRID_ARCH, layers, batch, seq,
                                             args.seed, "hybrid train")
    ops.flash_attention_bwd_cuda = kfa.flash_attention_bwd_cuda
    tr = {"blocks": layers, "losses": clean.losses, "launches": launches,
          "launches_by_design": by_design}
    nums, few = _step_numbers(tcfg, batch, seq, args.seed, "hybrid train")
    tr.update(nums)
    tr["f32_card_vs_cpu"] = _f32_grads(cfg, train.cut_depth(cfg, HYBRID_CUT),
                                       args.seed, few)
    out["train"] = tr
    out["seconds"] = time.perf_counter() - t_path
    out["path_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase hybrid: {out['seconds']:.1f} s; peak device memory "
          f"{out['path_peak_gib']:.2f} GiB with the {held0 / 2**30:.2f} GiB "
          f"earlier paths hold")
    return out


def hybrid_parts(captured, n_local, n_rglru):
    """The RG-LRU scan and the windowed attention alone, at their first
    inputs of the hybrid's prefill (a scan over 4,096 steps, the chunked
    windowed path of 4,096 rows) and decode step (the one-token windowed
    path over the cache), CUDA events over REPS calls: ms a call and a
    prefill or step, beside the bound of the function each computes (the
    scan: a and b read, h written, float32; the windowed attention: the
    window's q.k and p.v products at the bf16 peak, the windowed flash
    kernel's, or its bytes)."""
    from repro_torch.models import attention, rglru
    out = {}
    (a, b), _ = captured.pop("hybrid linear_scan")
    ms, _ = timed(lambda: rglru.linear_scan(a, b), REPS)
    bound, by = ha.bound_of(0.0, ha.PEAK_F32_FLOPS,
                         3 * a.numel() * a.element_size())
    print(f"hybrid: the RG-LRU scan at a prefill's inputs {tuple(a.shape)} "
          f"float32: {ms:.4f} ms a call, {n_rglru} a prefill "
          f"({ms * n_rglru:.2f} ms); bound {bound:.4f} ms ({by})")
    out.update(scan_ms=ms, scan_bound_ms=bound, scan_shape=list(a.shape),
               scan_calls_a_prefill=n_rglru)
    del a, b
    path = next(p for p in ("_chunked_attn", "_einsum_attn")
                if f"hybrid {p}" in captured)
    (q, k, v, causal, window, off), _ = captured.pop(f"hybrid {path}")
    for p in ("_chunked_attn", "_einsum_attn"):
        captured.pop(f"hybrid {p}", None)
    fn = getattr(attention, path)
    ms, _ = timed(lambda: fn(q, k, v, causal, window, off), REPS)
    B, H, Sq, dh = q.shape
    seen = sum(min(i + 1, window) for i in range(Sq))
    flops = 2.0 * B * H * seen * 2 * dh
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    bound, by = ha.bound_of(flops, ha.PEAK_FLOPS, nbytes)
    print(f"hybrid: the windowed attention ({path}) at a prefill's inputs "
          f"q {tuple(q.shape)}, k {tuple(k.shape)}, window {window}: {ms:.3f}"
          f" ms a call, {n_local} a prefill ({ms * n_local:.1f} ms); a "
          f"windowed flash kernel's bound {bound:.4f} ms ({by}: "
          f"{flops / 1e9:.1f} GFLOP)")
    out.update(window_prefill_ms=ms, window_prefill_bound_ms=bound,
               window_prefill_bound_by=by, window_calls_a_prefill=n_local)
    del q, k, v
    args, _ = captured.pop("hybrid _decode_attn_delta")
    ms, _ = timed(lambda: attention._decode_attn_delta(*args), REPS)
    q, kc = args[0], args[1]
    window = args[6]
    nbytes = (q.numel() + 2 * q.shape[0] * kc.shape[1] * window
              * kc.shape[-1]) * kc.element_size()
    bound, by = ha.bound_of(0.0, ha.PEAK_FLOPS, nbytes)
    print(f"hybrid: the windowed one-token attention at a decode step's "
          f"inputs (cache {tuple(kc.shape)}, window {window}): {ms:.4f} ms a"
          f" call, {n_local} a step ({ms * n_local:.2f} ms); bound "
          f"{bound:.4f} ms ({by}: the window's K/V read once)")
    out.update(window_decode_ms=ms, window_decode_bound_ms=bound,
               window_calls_a_step=n_local)
    return out


def _stub(seed, B, n, d, dtype):
    """Stub frame or patch embeddings (B, n, d) drawn on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((B, n, d), generator=g, device="cuda").to(dtype)


def whisper_run(args, captured):
    """whisper-medium at its published width and depth (24 encoder and 24
    decoder blocks, bf16): ``encode`` of WHISPER_FRAMES stub frames (the
    flash kernel once an encoder block, non-causal), a prefill of
    WHISPER_DECODE's prompts with the cross cache filled and its
    teacher-forced decode steps (the cross-attention through the flash
    kernel at the prefill and at every step, Sq != Sk), one timed
    ``value_and_grad`` step with the frames, and float32 at 2 + 2
    blocks: decode against the forward and the gradient against the
    CPU's."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import (count_params, encode, init_params,
                                    value_and_grad)
    cfg = get_config("whisper-medium")
    L = cfg.encoder_layers
    check((L, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd,
           cfg.encoder_frames, cfg.cdtype) == (24, 24, 1024, 16, 64, 1500,
                                               torch.bfloat16),
          "whisper-medium must run at its published width and depth")
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    B, S, T = WHISPER_DECODE
    frames = _stub(args.seed + 2, B, cfg.encoder_frames, cfg.d_model,
                   cfg.cdtype)
    out = {}
    # ---- encode ----------------------------------------------------------------
    ops.flash_attention_cuda = shape_recorder(captured, "whisper",
                                              kfa.flash_attention_cuda)
    with torch.no_grad():
        encode(model, frames)
        torch.cuda.synchronize()
        _reset_launches()
        ms, _ = timed(lambda: encode(model, frames), 1)
    launches = _launch_counts()
    ok, want = _only(launches, flash_attention=2 * L)   # warm-up and timed
    check(ok, f"whisper encode: launches {launches}, expected {want} over "
          f"two calls (the flash kernel once an encoder block)")
    print(f"phase frontends whisper encode: {B} x {cfg.encoder_frames} "
          f"frames through {L} blocks in {ms:.2f} ms; launches {launches} "
          f"(two calls)")
    out["encode"] = {"batch": B, "frames": cfg.encoder_frames, "ms": ms,
                     "launches": launches["flash_attention"] // 2}
    # ---- prefill with the cross cache, then decode ---------------------------
    tokens = _decode_tokens(cfg, args.seed, B, S + T + 1)
    stubs = {"enc_frames": frames}
    _teacher_forced(model, tokens, S, 1, stubs)              # warm
    dec, cache, rec = _serve_run(model, tokens, S, T, "frontends whisper",
                                 stubs)
    ops.flash_attention_cuda = kfa.flash_attention_cuda
    ok, want = _only(rec["launches"], flash_attention=3 * L + T * L)
    check(ok, f"whisper prefill and decode: launches {rec['launches']}, "
          f"expected {want} (the prefill: the encoder, the self- and the "
          f"cross-attention once a block; a decode step: the "
          f"cross-attention once a block)")
    want_cross = 2 * L * B * cfg.n_kv_heads * cfg.encoder_frames * cfg.hd * \
        frames.element_size()
    rec["cross_cache_bytes"] = sum(
        t.nbytes for seg in cache for blk in seg.values()
        for key, t in blk.items() if key in ("xk", "xv"))
    check(rec["cross_cache_bytes"] == want_cross,
          f"cross cache {rec['cross_cache_bytes']} bytes, expected "
          f"{want_cross}")
    del cache
    fwd = _forward_rows(model, tokens, S, T, stubs)
    check(bool(torch.isfinite(dec).all()) and bool(torch.isfinite(fwd).all()),
          "whisper: non-finite logits")
    rec["bf16_max_abs_err"] = float((dec - fwd).abs().max())
    rec["bf16_top1_agreement"] = float(
        (dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    print(f"whisper decode bf16 at 24 + 24 blocks against the forward "
          f"(reported): max |logit difference| {rec['bf16_max_abs_err']:.4g}"
          f", top-1 agreement {rec['bf16_top1_agreement']:.4f}")
    out["decode"] = rec
    del dec, fwd
    # ---- one training step's gradient with the frames -------------------------
    n_params = count_params(cfg)
    toks, labels = tokens[:, :S], tokens[:, 1:S + 1]
    ops.flash_attention_bwd_cuda = recorder(
        captured, "flash_attention_bwd whisper", kfa.flash_attention_bwd_cuda)
    _reset_launches()
    value_and_grad(model, toks, labels, enc_frames=frames)
    launches = _launch_counts()
    ops.flash_attention_bwd_cuda = kfa.flash_attention_bwd_cuda
    by_design = {k: dict(f.launches_by_design) for k, f in (
        ("flash_attention", kfa.flash_attention_cuda),
        ("flash_attention_bwd", kfa.flash_attention_bwd_cuda))}
    ok, want = _only(launches, flash_attention=6 * L,
                     flash_attention_bwd=3 * L)
    check(ok and all(d["tensor_core"] == launches[k]
                     for k, d in by_design.items()),
          f"whisper value_and_grad: launches {launches}, expected {want}, "
          f"all tensor_core ({by_design}): the encoder, self- and "
          f"cross-attention forward twice and backward once a block")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _each_ms(lambda: value_and_grad(model, toks, labels,
                                              enc_frames=frames), 3)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    # the encoder and the cross-attention's K/V projections run over the
    # frames, every other parameter over the tokens
    over_frames = (sum(p.numel() for p in model.encoder.parameters())
                   + sum(b.cross.wk.numel() + b.cross.wv.numel()
                         for seg in model.segments for b in seg))
    work = 6 * (over_frames * B * cfg.encoder_frames
                + (n_params - over_frames) * B * S)
    tflops = work / (step_ms / 1e3) / 1e12
    print(f"frontends whisper value_and_grad: {B} x {S} tokens with {B} x "
          f"{cfg.encoder_frames} frames, {step_ms:.2f} ms (CUDA events, mean "
          f"of 3 after one warm-up; forward and backward), {tflops:.2f} "
          f"model TFLOP/s (6 x parameters x the rows each part runs), peak "
          f"{peak:.2f} GiB above the {held / 2**30:.2f} held; launches "
          f"{launches}")
    out["grad_step"] = {"batch": B, "seq": S, "ms": step_ms,
                        "model_tflops": tflops, "peak_gib": peak,
                        "launches": launches, "launches_by_design": by_design}
    del model, frames
    torch.cuda.empty_cache()
    # ---- float32 at 2 + 2 blocks --------------------------------------------------
    cut = dataclasses.replace(train.cut_depth(cfg, 2), encoder_layers=2)
    Bc, Sc, Tc = DECODE_CHECK
    small = _stub(args.seed + 3, Bc, cfg.encoder_frames, cfg.d_model,
                  torch.float32)
    out["decode"].update(decode_checks(cut, args.seed, 2, DECODE_CHECK,
                                       {"enc_frames": small}))
    few_toks = _decode_tokens(cfg, args.seed + 4, 1, WHISPER_F32_TOKENS + 1)
    few = (few_toks[:, :-1].cpu(), few_toks[:, 1:].cpu())
    out["f32_card_vs_cpu"] = _f32_grads(cfg, cut, args.seed, few,
                                        {"enc_frames": small[:1]})
    torch.cuda.empty_cache()
    return out


def pixtral_run(args, captured):
    """pixtral-12b at its published width and depth (40 blocks, bf16):
    a prefill of PIXTRAL_DECODE's prompts after their stub patch rows
    (the flash kernel once a block over patches and text) and its
    teacher-forced decode steps; float32 decode against the forward at 2
    blocks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    cfg = get_config("pixtral-12b")
    P = cfg.frontend_tokens
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           P, cfg.cdtype) == (40, 5120, 32, 8, 128, 1024, torch.bfloat16),
          "pixtral-12b must run at its published width and depth")
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    B, S, T = PIXTRAL_DECODE
    stubs = {"frontend_emb": _stub(args.seed + 5, B, P, cfg.d_model,
                                   cfg.cdtype)}
    tokens = _decode_tokens(cfg, args.seed, B, S + T)
    _teacher_forced(model, tokens, S, 1, stubs)              # warm
    ops.flash_attention_cuda = shape_recorder(captured, "pixtral",
                                              kfa.flash_attention_cuda)
    dec, cache, rec = _serve_run(model, tokens, S, T, "frontends pixtral",
                                 stubs)
    ops.flash_attention_cuda = kfa.flash_attention_cuda
    ok, want = _only(rec["launches"], flash_attention=cfg.n_layers)
    check(ok, f"pixtral prefill and decode: launches {rec['launches']}, "
          f"expected {want} (the flash kernel once a block at the prefill)")
    del cache
    fwd = _forward_rows(model, tokens, S, T, stubs)
    check(bool(torch.isfinite(dec).all()) and bool(torch.isfinite(fwd).all()),
          "pixtral: non-finite logits")
    rec["bf16_max_abs_err"] = float((dec - fwd).abs().max())
    rec["bf16_top1_agreement"] = float(
        (dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    print(f"pixtral decode bf16 at 40 blocks against the forward "
          f"(reported): max |logit difference| {rec['bf16_max_abs_err']:.4g}"
          f", top-1 agreement {rec['bf16_top1_agreement']:.4f}")
    del model, dec, fwd, stubs
    torch.cuda.empty_cache()
    Bc = DECODE_CHECK[0]
    rec.update(decode_checks(cfg, args.seed, DECODE_CUT, DECODE_CHECK, {
        "frontend_emb": _stub(args.seed + 6, Bc, P, cfg.d_model,
                              torch.float32)}))
    torch.cuda.empty_cache()
    return {"patches": P, "decode": rec}


def frontends_path(args, captured):
    """whisper-medium, then pixtral-12b, each model freed before the
    next."""
    import torch
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = {"whisper-medium": whisper_run(args, captured)}
    print(f"phase frontends whisper: {time.perf_counter() - t0:.1f} s")
    out["pixtral-12b"] = pixtral_run(args, captured)
    out["seconds"] = time.perf_counter() - t0
    out["path_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase frontends: {out['seconds']:.1f} s; peak device memory "
          f"{out['path_peak_gib']:.2f} GiB with the {held / 2**30:.2f} GiB "
          f"earlier paths hold")
    return out


def new_family_flash(captured):
    """The flash forward at each new path's first inputs of each shape
    family (held against its plain version, beside
    ``scaled_dot_product_attention`` and its bound) and the gradient at
    the training inputs: the records' ``hybrid`` and ``frontends``
    keys."""
    import torch
    fwd, bwd = {}, {}
    picks = {"recurrentgemma-2b local": "hybrid 2048x2048 causal",
             "whisper-medium encoder": "whisper 1500x1500",
             "whisper-medium cross": f"whisper {WHISPER_DECODE[1]}x1500",
             "whisper-medium cross decode": "whisper 1x1500",
             "pixtral-12b prefill": "pixtral 2048x2048 causal"}
    for name, key in picks.items():
        (q, k, v), kw = captured.pop(key)
        rec = flash_measure(q, k, v, kw.get("causal", True),
                            f"the {name} inputs")
        rec.update(shape=list(q.shape), kv_shape=list(k.shape),
                   causal=kw.get("causal", True))
        fwd[name] = rec
        del q, k, v
        torch.cuda.empty_cache()
    for k in [k for k in captured if k.split()[0] in ("hybrid", "whisper",
                                                      "pixtral")]:
        captured.pop(k)
    for name, key in (("recurrentgemma-2b train", "flash_attention_bwd hybrid"),
                      ("whisper-medium grad step",
                       "flash_attention_bwd whisper")):
        a, kw = captured.pop(key)
        bwd[name] = flash_bwd_measure(a, kw, f"the {name} inputs")
        bwd[name].update(shape=list(a[0].shape), kv_shape=list(a[1].shape),
                         causal=kw.get("causal", True))
        del a
        torch.cuda.empty_cache()
    return fwd, bwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-n", type=int, default=22,
                    help="log2 of the number of stored points of the "
                         "index path")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    dev_name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {dev_name} x{count}")

    # the dry run of every cell, on the host while the kernels build
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry = start_dryrun(dry_dir)
    atexit.register(shutil.rmtree, dry_dir, True)
    atexit.register(stop_dryrun, dry)
    t0 = time.perf_counter()
    libs = build_kernels()
    print(f"phase build_kernels: {time.perf_counter() - t0:.1f} s")
    hmma = hmma_counts(libs)

    # each kernel's first inputs on each path, for the comparisons
    captured = {}
    index_launches, idx, data, hcalls, ctx = index_path(args, captured)
    records = {
        "bucket_search": bucket_search_record(
            captured.pop("bucket_search")[1],
            index_launches["bucket_search"]),
        "bucket_gather": bucket_gather_record(
            *captured.pop("bucket_gather"), index_launches["bucket_gather"])}
    hash_shapes = [dict(r, path="index") for r in hash_records(
        hcalls, idx.stacked_params, idx.cfg.W)]
    hash_launches = {"index": index_launches["lsh_hash"]}
    own_launches = lsh_hash_path(idx, data, hcalls)
    print(f"index and hash paths peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del hcalls
    queries, K, bucket = ctx["queries"], ctx["K"], ctx["bucket"]
    # the index's stored points (on the host) and first served bucket, for
    # the simulate path's oracle; that path runs last, so that every
    # earlier path follows the same work as it did before it was added
    oracle = (idx.cfg, data, queries[:bucket], ctx.pop("served"))
    del data
    launches, shapes = contracts_path(idx, queries, K, bucket, args.seed)
    hash_launches["contracts"] = launches["lsh_hash"]
    hash_shapes += [dict(r, path="contracts") for r in shapes]
    # the gate's SyncLogs reset the allocator's peak: reset it after them
    torch.cuda.reset_peak_memory_stats()
    serving_path(idx, ctx["svc"], queries, K, bucket)
    state = {"idx": idx, "svc": ctx.pop("svc")}
    del idx
    durable_path(state, queries, K, bucket, args.seed)
    print(f"serving and durable paths peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    launches, by_design, svc, query_tokens, hcalls = retrieval_path(
        args, captured, "gemma-7b")
    hash_launches["gemma-7b"] = launches["lsh_hash"]
    hash_shapes += [dict(r, path="gemma-7b") for r in hash_records(
        hcalls, svc.index.stacked_params, svc.index.cfg.W)]
    del hcalls
    records["flash_attention"] = flash_record(
        *captured.pop("flash_attention"), launches["flash_attention"],
        by_design, hmma["flash_attention"])
    # the full scan at the embedder's width, against its plain version
    bucket_search_record(captured.pop("bucket_search_gemma-7b")[1],
                         launches["bucket_search"])
    wide_scan_checks(svc, query_tokens)
    print(f"gemma-7b retrieval path peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del svc, query_tokens
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    launches, by_design, svc, _, hcalls = retrieval_path(
        args, captured, "mamba2-130m", durable=True)
    hash_launches["mamba2-130m"] = launches["lsh_hash"]
    hash_shapes += [dict(r, path="mamba2-130m") for r in hash_records(
        hcalls, svc.index.stacked_params, svc.index.cfg.W)]
    del hcalls
    records["ssd_scan"] = ssd_record(*captured.pop("ssd_scan"),
                                     launches["ssd_scan"], by_design,
                                     hmma["ssd_scan"])
    bucket_search_record(captured.pop("bucket_search_mamba2-130m")[1],
                         launches["bucket_search"])
    print(f"mamba2-130m retrieval path peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del svc
    torch.cuda.empty_cache()

    hash_launches["simulate"], hcalls = simulate_path(args, oracle)
    hash_shapes += [dict(r, path="simulate")
                    for r in hash_records(hcalls, None, None)]
    del oracle, hcalls
    torch.cuda.empty_cache()

    launches, bwd_design, hash_launches["train"], hcalls, _ = train_path(
        args, captured)
    hash_shapes += [dict(r, path="train")
                    for r in hash_records(hcalls, None, None)]
    del hcalls
    bwd_args = captured.pop("ssd_scan_bwd")
    records["ssd_scan"]["train_launches"] = launches["ssd_scan"]
    records["ssd_scan"].update(ssd_train_forward(bwd_args[0]))
    records["ssd_scan_bwd"] = ssd_bwd_record(
        *bwd_args, launches["ssd_scan_bwd"], bwd_design,
        hmma["ssd_scan_bwd"])
    del bwd_args
    torch.cuda.empty_cache()
    launches, shapes = example_path()
    hash_launches["example"] = launches["lsh_hash"]
    hash_shapes += [dict(r, path="example") for r in shapes]
    del shapes

    launches, by_design, _ = train_dense_path(args, captured)
    fa_args, fa_kw = captured.pop("flash_attention_bwd")
    records["flash_attention"]["train_launches"] = launches["flash_attention"]
    records["flash_attention"].update(flash_train_forward(fa_args))
    records["flash_attention_bwd"] = flash_bwd_record(
        fa_args, fa_kw, launches["flash_attention_bwd"],
        by_design["flash_attention_bwd"], hmma["flash_attention_bwd"])
    del fa_args
    torch.cuda.empty_cache()
    records["flash_attention_bwd"].update(flash_bwd_long(args.seed))
    torch.cuda.empty_cache()
    finish_dryrun(dry, dry_dir)
    decode = decode_path(args, captured, dry_dir)
    prefill_cell = decode.pop("steps_prefill")
    records["flash_attention"].update(flash_prefill(
        captured.pop("flash_attention_prefill"),
        decode["gemma-7b"]["launches"]["flash_attention"]))
    print("decode: " + json.dumps(decode))
    torch.cuda.empty_cache()
    moe, fwd_keys, bwd_keys = moe_path(args, captured)
    records["flash_attention"]["moe"] = fwd_keys
    records["flash_attention_bwd"]["moe"] = bwd_keys
    for k in ("flash_attention", "flash_attention_bwd"):
        records[k]["moe_launches"] = {
            f"{arch} {what}": moe[arch][what]["launches"][k]
            for arch in MOE_WIDTHS for what in ("train", "decode")
            if moe[arch][what]["launches"][k]}
    print("moe: " + json.dumps(moe))
    hybrid = hybrid_path(args, captured)
    print("hybrid: " + json.dumps(hybrid))
    torch.cuda.empty_cache()
    frontends = frontends_path(args, captured)
    print("frontends: " + json.dumps(frontends))
    torch.cuda.empty_cache()
    fwd, bwd = new_family_flash(captured)
    w, px = frontends["whisper-medium"], frontends["pixtral-12b"]
    launches = {
        "flash_attention": {
            "recurrentgemma-2b forward":
                hybrid["forward"]["launches"]["flash_attention"],
            "whisper-medium encode": w["encode"]["launches"],
            "whisper-medium prefill and decode":
                w["decode"]["launches"]["flash_attention"],
            "pixtral-12b prefill":
                px["decode"]["launches"]["flash_attention"]},
        "flash_attention_bwd": {}}
    for k in launches:
        launches[k]["recurrentgemma-2b train"] = hybrid["train"]["launches"][k]
        launches[k]["whisper-medium grad step"] = w["grad_step"]["launches"][k]
    for k, got in (("flash_attention", fwd), ("flash_attention_bwd", bwd)):
        records[k]["new_families"] = got
        records[k]["new_family_launches"] = launches[k]
    print("steps: " + json.dumps(steps_path(args, dry_dir, prefill_cell)))
    torch.cuda.empty_cache()
    print(f"total {time.perf_counter() - t_start:.0f} s")
    records["lsh_hash"] = lsh_hash_record(hash_shapes, hash_launches,
                                          own_launches)

    print(card)
    order = ("bucket_search", "bucket_gather", "flash_attention",
             "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd", "lsh_hash")
    print(json.dumps({"kernels": [records[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
