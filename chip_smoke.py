#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with an NVIDIA GPU (an H100 for
the ``sm_90a`` kernels) and the CUDA toolkit::

    python3 chip_smoke.py [--out DIR]

It builds every kernel of the port from ``src/repro_torch/kernels/csrc`` with
nvcc (one process per source, all at once), then:

* kernel phases: holds each kernel against its plain PyTorch version on the
  card (f32 and bf16, C in {1, 3, 4, 32, 33, 200} x D in {1, 7, 4097, 58430},
  every compressor kind; the mesh round's two kernels also at C = 8), checks
  the bitwise contracts between them, and times each at its path shapes
  (the mesh kernels also at a large local block of 1,024 clients) beside
  that plain version, a library call where one computes the same function,
  and its bound (the one-launch kernels 2, 3, 4 and 6 on the unpadded
  (C, 58430) matrices the engine and the mesh round pass, by CUDA events,
  by the profiler's device time and as the whole ``ops`` call, beside the
  launch floor of ``torch.cuda._sleep(1)``, with their device launches per
  call from a profiler window around one call; kernel 2 beside three
  one-call library yardsticks, ``torch.einsum``, ``torch.linalg.vecdot`` and
  a batched ``torch.bmm``); flash attention over S x head dim x
  (window, prefix), the
  SSD scan over S x chunk x (P, N), and both at the serve paths' shapes
  (flash attention's library yardstick is PyTorch's fused flash backend);
  the tensor-core instructions in the SASS of flash attention's bf16
  instances, its strided (batch, S, heads, d) views bitwise equal to the
  copied (batch x heads, S, d) rows, and kernel 1 bitwise equal to kernel
  3's aggregate at the first slice's shape; the SSD scan's tensor-core
  instructions in its bf16 passes, its entry on the model's strided
  (batch, S, heads, P) and (batch, S, groups, N) views at one group and at
  a group per head (bitwise the per-row route on materialized per-head
  copies, and run to run), each pass's share of its time at the serve
  paths' shapes, its bound with and without the passes' scratch traffic,
  and the model's core through it against the eager chunked core;
* path phases, each with every kernel count set to 0 just before and read
  just after:

  - the main path of the second slice, ``femnist1-fedavg-aocs-scan`` with
    ``agg_backend="pallas"`` and the rand-k compressor of
    ``femnist1-fedavg-aocs-randk`` (both settings of the reference's own
    ``FLConfig``, built with ``Scenario.with_``): the single-pass scan engine
    at full width for 20 rounds, 4 cached groups through the fused
    norm+aggregate kernel and 4 spilled groups through the fused
    compress+norm+aggregate kernel every round;
  - ``femnist1-fedavg-aocs-randk`` with ``agg_backend="pallas"`` on the vmap
    engine (the compress kernel once per round at the cohort's width);
  - the first slice's ``femnist1-fedavg-aocs-pallas`` (the masked-aggregate
    kernel once per round);
  - the kernel-backed norms ``ops.tree_client_norms`` of full-width cohorts;
  - the mesh round at world size 1 on NCCL: ``femnist1-fedavg-aocs-shard-randk``
    (the sharded compress kernel once per round) and
    ``femnist1-fedavg-aocs-shard`` (the sharded aggregate kernel once per
    round), each also bitwise equal to its single-device counterpart (the
    vmap + rand-k + pallas path and the first slice's path);

  each path checks its launches per round, that the ledger is valid and the
  losses finite, that a second run reproduces masks, the ledger minus
  ``wall_ms`` and parameters bitwise, and that a reduced run on the card
  matches the same run on the CPU; these paths run the driver's ``'host'``
  mode, as they did before the pool existed;
* the main path again under the reference's default driver mode
  ``'prefetch'`` (the ``ClientPool`` on the card, round k+1's gather
  dispatched on a side stream before round k's step), with the same
  launches, bitwise equal to the host run; the charlm cell
  ``charlm-fedavg-aocs`` (the 2-layer GRU, D = 60,630) at full width in both
  modes, bitwise across the modes and across a second run, and with
  ``agg_backend="pallas"`` (kernel 1 once per round on its (32, 60,630)
  update matrix, which is also held against the plain version and timed);
  a server optimizer (sgd with momentum, adam) through the vmap and scan
  engines, which agree within atol 1e-5;
* the driver's ``'scan'`` mode (blocks of rounds; each round after the first
  one replay of a CUDA graph of the round body): the main path (blocks of 8,
  8 and 4) and the charlm cell (blocks of 3, and with its accuracy on the
  eval grid), each bitwise the host and prefetch runs (masks, the ledger
  minus timing, parameters, ``acc_rounds``), a second run and the CPU's
  reduced run; a scan run's device launches are its eager first round's
  plus its CUDA graph's kernel nodes (read from the graph's DOT dump) times
  its replays, read in that run (4 + 4 of kernels 3 and 4 per round on the
  main path, kernel 1 once on charlm with kernel 1); a child process
  (``--profile modes``) profiles the main path and the charlm cell in the
  three modes (and charlm with kernel 1 in scan mode): the idle share and
  the device ops per round, the runtime calls that wait for the device
  between two prefetch round dispatches and within and between scan blocks
  (must be 0), one ``cudaGraphLaunch`` per replayed round, and the kernels
  of a replayed round by name in the trace; then rounds/s and the median
  per-round ms of the three modes on both cells;
* ``femnist1-fedavg-aocs-shard-randk`` on 4 ranks sharing the one card (gloo,
  every rank on ``cuda:0``): each rank's launches, masks equal across ranks,
  the first round's mask equal to the world-size-1 run's and the parameters
  within 1e-5 of it; then the same ranks under prefetch from the sharded
  pool (each rank holding a quarter of its rows), bitwise their host run;
  its times are those of 4 ranks sharing one card, not of 4 GPUs;
* the serving path of the fourth slice, ``repro_torch.launch.serve.serve``,
  at full width with random weights from a seeded generator on the card:
  zamba2-2.7b (54 layers, d 2,560, bf16; batch 2, prompt 4,096, gen 32),
  whose prefill runs the flash-attention kernel 9 times and the SSD-scan
  kernel 45 times, and mamba2-130m (gen 16; 24 SSD-scan launches); each
  checks its launches (none in decode), that a second run gives the same
  tokens, the first Mamba2 block and the first shared-attention call against
  the same blocks with the eager cores (within bf16 rounding), the kernel
  prefill's last logits against the same prefill with the eager cores, and
  takes profiler passes (zamba2's prefill also with the earlier attention
  wiring, which copied q, k, v and out); then the reduced zamba2 in f32 at
  prompt 2,100 (both kernels, and the SSD's padding) against the CPU;
* a profiler pass (device ops per round among its numbers) of the main
  path, of the vmap + rand-k + pallas path, of the first slice's path and of
  the mesh round, and a per-layer breakdown of the main path, of the first
  slice's path and of the mesh round, which say where a round's time goes.

``--out DIR`` writes the full-width ledgers and the profiles there.  The last
two lines of its output are a JSON line of per-kernel numbers and
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without a result; so it does without a CUDA device, and when
it is not run from a checkout.  It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_CELL = "femnist1-fedavg-aocs-scan"       # + randk 0.1, agg_backend pallas
VMAP_CELL = "femnist1-fedavg-aocs-randk"      # + agg_backend pallas
SLICE1_CELL = "femnist1-fedavg-aocs-pallas"
SHARD_RANDK_CELL = "femnist1-fedavg-aocs-shard-randk"
SHARD_CELL = "femnist1-fedavg-aocs-shard"
CHARLM_CELL = "charlm-fedavg-aocs"            # the 2-layer GRU, D = 60,630
CHARLM_ROUNDS = 10
CHARLM_DIM = 60630
MAIN_DIM = 58430
SYNC_ROUNDS = 4              # profiled host/prefetch rounds; the window spans 3
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpyFromSymbol", "cudaMemcpyToSymbol")
SERVER_OPT_ROUNDS = 3        # the reference's test_engine_matrix_parity_server_opt
SERVER_OPT_ATOL = 1e-5
PATH_ROUNDS = 20
SCAN_BLOCK = 8               # the main path's rounds_per_scan: blocks of 8, 8 and 4
CHARLM_SCAN_BLOCK = 3        # charlm's: blocks end on the eval grid too
CHARLM_EVAL_EVERY = 5
SCAN_PROFILE_ROUNDS = 10     # profiled scan runs: blocks of 4, 4 and 2
SCAN_PROFILE_BLOCK = 4
TRACE_TAIL = 4096            # small kernels after a profiled run (and 1/16 before it)
SHARD_ROUNDS = 10            # = VMAP_ROUNDS = SLICE1_ROUNDS: compared bitwise
MESH4_RANKS = 4
MESH4_ROUNDS = 5
MESH4_TIMEOUT_S = 600
VMAP_ROUNDS = 10
SLICE1_ROUNDS = 10
NORM_COHORTS = 5
PROFILE_ROUNDS = 3
BREAKDOWN_ROUNDS = 6
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
TIMING_REPS = 100
PROFILE_REPS = 20             # flushed calls per shape in a profiler window
SPIN_CYCLES = 200_000         # ~100 us of device spin at H100 clocks
SWEEP_C = (1, 3, 4, 32, 33, 200)
SHARD_SWEEP_C = (1, 3, 4, 8, 32, 33, 200)    # 200 > the kernels' client block of 128
SWEEP_D = (1, 7, 4097, 58430)
# (kind, param) of every compressor the kernel phase checks; qsgd at a
# level count whose reciprocal is inexact too
COMPRESSORS = (("randk", 0.1), ("qsgd", 8.0), ("qsgd", 5.0), ("natural", 0.0))
RTOL, ATOL = 1e-5, 1e-6
# kernel 7 (flash attention), elementwise |err| <= atol + rtol |want|: f32
# inputs N(0, 1) at the reference's own atol; bf16 inputs N(0, 1/4), where the
# kernel and the plain version both accumulate in f32 and round the output
# once to bf16, so they differ by at most one bf16 unit in the last place,
# <= 2^-7 |want| < 1e-2 |want| (the outputs shrink as 1/sqrt(row) at long S,
# so a bound that does not scale with |want| would pass a kernel that dropped
# the late rows)
ATTN_SWEEP_S = (1, 7, 128, 200, 257, 2048)
ATTN_MASKS = ((None, 0), (48, 0), (None, 40))
ATTN_TOL = {"float32": (3e-5, 0.0), "bfloat16": (1e-5, 1e-2)}     # (atol, rtol)
ATTN_PATH = (64, 4096, 80)      # zamba2-2.7b prefill: (batch 2 x 32 heads, S, head dim)
ATTN_PATH_HEADS = 32            # the library yardstick takes (batch, heads, S, head dim)
# the yardstick's output against the kernel's, only to show that it computes
# the same function: its flash backend rounds the probabilities to bf16
# (2^-9 relative each) before the second product, an error of up to
# 2^-9 max |v| (~5e-3 at these inputs) on top of the output's own rounding
ATTN_LIBRARY_TOL = (1e-2, 1e-2)
ATTN_PATH_CHECK_ROWS = 8        # rows held against the (S, S) plain version
# kernel 8 (SSD scan): the sequential recurrence (or the eager chunked core)
# and the kernel reassociate sums of up to Q * N terms of f32 products
SSD_SWEEP_S = (32, 100, 128, 300)
SSD_SWEEP_CHUNK = (16, 64, 128)
SSD_SWEEP_PN = ((16, 8), (64, 64), (64, 128))
SSD_ATOL, SSD_RTOL = 1e-4, 1e-4
# (batch, heads, S, P, N) of the serve paths: zamba2-2.7b, mamba2-130m
SSD_PATHS = ((2, 80, 4096, 64, 64), (2, 24, 4096, 64, 128))
# (batch, S, heads, P, N) of the view entry's check at G = 1 and G = H
SSD_VIEW_CHECK = (2, 512, 6, 64, 64)
# the serve paths: full width, random weights from a seeded generator on the card
SERVE_BATCH, SERVE_PROMPT = 2, 4096
SERVE_PATHS = (               # (arch, generated tokens, launches per prefill)
    ("zamba2-2.7b", 32, {"flash_attention": 9, "ssd_scan": 45}),
    ("mamba2-130m", 16, {"ssd_scan": 24}),
)
# the first Mamba2 block and the first shared-attention call, kernel core
# against eager core on the same bf16 input: the cores' f32 sums differ only
# in order, so the blocks' bf16 outputs may differ by the roundings that this
# flips: max |diff| <= two bf16 units at the largest output (2^-6 max |out|),
# and rms(diff) <= the size of one bf16 rounding of every element
# (2^-8 rms(out))
SERVE_BLOCK_MAX, SERVE_BLOCK_RMS = 2.0 ** -6, 2.0 ** -8
# the kernel prefill's last-position logits against the same prefill with the
# eager cores, bf16: max |diff| <= this share of max |logit| (the blocks'
# rounding differences above travel through the later blocks)
SERVE_LOGIT_RTOL = 5e-2
REDUCED_ARCH, REDUCED_PROMPT, REDUCED_GEN = "zamba2-2.7b-reduced", 2100, 8
REDUCED_LOGIT_ATOL = 1e-4     # f32, TF32 off: the card against the CPU


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import masked_aggregate as ma
    from repro_torch.kernels import norm_aggregate as na
    from repro_torch.kernels import sharded_aggregate as sa
    from repro_torch.kernels import ssd_scan as ss

    return {
        "masked_scale_aggregate": ma.masked_scale_aggregate_cuda,
        "client_sqnorms": na.client_sqnorms_cuda,
        "norm_scale_aggregate": na.norm_scale_aggregate_cuda,
        "compress_norm_scale_aggregate": na.compress_norm_scale_aggregate_cuda,
        "sharded_masked_aggregate": sa.sharded_masked_aggregate_cuda,
        "sharded_compress_aggregate": sa.sharded_compress_aggregate_cuda,
        "flash_attention": fa.flash_attention_cuda,
        "ssd_scan": ss.ssd_scan_cuda,
    }


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def time_ms(fn, torch, flush=None, reps=TIMING_REPS) -> float:
    """Median device time of one call, by CUDA events around each call after
    a warm-up.  Before each call the device is kept busy — overwriting
    ``flush`` (a buffer larger than L2, so the inputs come from device
    memory), or else a spin of about 100 us (the inputs stay in L2) — so the
    events bracket the call's device work, not the host's launch overhead."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        else:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, flops: int, flops_per_s: float = F32_FLOPS_PER_S) -> tuple:
    """(bound ms, 'bytes' or 'operations') on an H100 SXM at its published
    rates: device memory 3.35 TB/s; float32 67 TFLOP/s, or the inputs' type's
    rate given (bf16: 989 TFLOP/s)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def check_close(name, got, want, u, s, rtol, atol) -> float:
    """``|got - want| <= atol + rtol * sum_i |s_i U_id|``: the two sum in
    different orders, and float32 summation error scales with the sum of the
    terms' magnitudes, not with the (possibly cancelled) result."""
    err = (got - want).abs()
    mag = (s.abs()[:, None] * u.float().abs()).sum(0)
    bad = err > atol + rtol * mag
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version at "
            f"{int(bad.sum())} of {bad.numel()} elements (max abs err "
            f"{float(err.max())}, rtol {rtol}, atol {atol})"
        )
    return float(err.max()) if err.numel() else 0.0


def check_sq(name, got, want, rtol) -> float:
    """Squared norms sum positive terms: ``|got - want| <= rtol * want``."""
    err = (got - want).abs()
    bad = err > rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: squared norms disagree with the plain version at "
            f"{int(bad.sum())} of {bad.numel()} clients (max abs err {float(err.max())})"
        )
    return float(err.max()) if err.numel() else 0.0


def kernel_phase(torch, dev, flush):
    """masked_scale_aggregate: kernel vs plain at every shape, then timings."""
    from repro_torch.kernels import masked_aggregate as ma
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cpu").manual_seed(0)

    def inputs(c, d, dtype):
        u = torch.randn((c, d), generator=gen).to(dev, dtype)
        s = torch.rand((c,), generator=gen).to(dev) * (torch.rand((c,), generator=gen) < 0.5).to(dev)
        return u, s

    for dtype in (torch.float32, torch.bfloat16):
        for c in SWEEP_C:
            for d in SWEEP_D:
                u, s = inputs(c, d, dtype)
                got = ops.masked_scale_aggregate(u, s)
                want = ma.masked_scale_aggregate_ref(u, s)
                torch.cuda.synchronize()
                if got.shape != (d,) or got.dtype != torch.float32:
                    raise AssertionError(f"bad output {tuple(got.shape)} {got.dtype}")
                check_close(f"masked_scale_aggregate C={c} D={d} {dtype}", got, want,
                            u, s, RTOL, ATOL)
    print(f"kernel check: masked_scale_aggregate matches its plain version at "
          f"C in {SWEEP_C} x D in {SWEEP_D}, f32 and bf16 (rtol {RTOL}, atol {ATOL})")

    # the first slice's path shape: 32 clients x 58,430 parameters, padded by
    # ops to the tile multiple — the matrix the wrapper receives each round
    c, d = 32, 58430
    u, s = inputs(c, d, torch.float32)
    upad = torch.nn.functional.pad(u, (0, (-d) % ma.TILE)).contiguous()
    got = ma.masked_scale_aggregate_cuda(upad, s)
    want = ma.masked_scale_aggregate_ref(upad, s)
    again = ma.masked_scale_aggregate_cuda(upad, s)
    torch.cuda.synchronize()
    max_err = check_close("masked_scale_aggregate main shape", got, want, upad, s,
                          RTOL, ATOL)
    if not torch.equal(got, again):
        raise AssertionError("masked_scale_aggregate is not deterministic run to run")
    try:
        ma.masked_scale_aggregate_cuda(upad.t().contiguous().t(), s)
    except ValueError:
        pass
    else:
        raise AssertionError("the wrapper took a non-contiguous matrix")
    _, agg3 = ops.norm_scale_aggregate(upad, s)
    torch.cuda.synchronize()
    if not torch.equal(got, agg3):
        raise AssertionError("masked_scale_aggregate differs from the aggregate half of "
                             "norm_scale_aggregate at the main shape")
    print(f"kernel main shape {tuple(upad.shape)} f32: max abs err {max_err}, "
          f"bitwise equal across launches and to norm_scale_aggregate's aggregate")

    kernel_ms = time_ms(lambda: ma.masked_scale_aggregate_cuda(upad, s), torch, flush)
    plain_ms = time_ms(lambda: ma.masked_scale_aggregate_ref(upad, s), torch, flush)
    library_ms = time_ms(lambda: torch.matmul(s, upad), torch, flush)
    kernel_hot_ms = time_ms(lambda: ma.masked_scale_aggregate_cuda(upad, s), torch)
    cp, dp = upad.shape
    nbytes = (cp * dp + cp + dp) * 4
    flops = 2 * cp * dp
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"kernel timing (median of {TIMING_REPS}, L2 flushed): kernel {kernel_ms} ms, "
          f"plain {plain_ms} ms, torch.matmul {library_ms} ms (kernel / library "
          f"{kernel_ms / library_ms}); kernel with L2-resident input {kernel_hot_ms} ms; "
          f"bound {bound_ms} ms ({nbytes} bytes at 3.35 TB/s; {flops} flops); {card_line()}")
    return {
        "name": "masked_scale_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_aggregate.cu",
        "replaces": "src/repro/kernels/masked_aggregate.py:39",
        "shape": [cp, dp],
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_l2_hot_ms": kernel_hot_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _special_values(torch):
    """Values at, just below and just above powers of two, zeros and
    subnormals: the inputs where natural compression's rounding turns."""
    import numpy as np

    pows = np.float32(2.0) ** np.arange(-20, 8, dtype=np.float32)
    vals = np.concatenate([
        pows, np.nextafter(pows, np.float32(0)), np.nextafter(pows, np.float32(np.inf)),
        np.float32([0.0, 1e-40, 5e-39, 2.0 ** -126, 1e-45]),
    ]).astype(np.float32)
    return torch.from_numpy(np.concatenate([vals, -vals]))


def norm_kernel_phase(torch, dev, flush):
    """The second slice's kernels: each against its plain version over the
    sweep and every compressor, the bitwise contracts between them, and
    their timings at the path shapes."""
    from repro_torch import rng
    from repro_torch.core.compression import apply_compression_flat, client_material
    from repro_torch.kernels import masked_aggregate as ma
    from repro_torch.kernels import norm_aggregate as na
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cpu").manual_seed(1)
    specials = _special_values(torch)
    failures = []

    def expect(ok, what):
        if not ok:
            failures.append(what)

    def inputs(c, d, dtype, special=True):
        u = torch.randn((c, d), generator=gen) * 1e-2
        k = min(d, specials.numel()) if special else 0
        u[0, :k] = specials[:k]
        s = torch.rand((c,), generator=gen) * (torch.rand((c,), generator=gen) < 0.6)
        return u.to(dev, dtype), s.to(dev)

    def material(u, kind, param, seed):
        keys = rng.split(rng.PRNGKey(seed, device=dev), u.shape[0])
        return tuple(m["u"] for m in client_material({"u": u}, keys, kind, param))

    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for c in SWEEP_C:
            for d in SWEEP_D:
                tag = f"C={c} D={d} {dtype}"
                u, s = inputs(c, d, dtype)
                sq2 = ops.client_sqnorms(u)
                sq2b = ops.client_sqnorms(u)
                sq3, agg3 = ops.norm_scale_aggregate(u, s)
                sq3b, agg3b = ops.norm_scale_aggregate(u, s)
                agg1 = ops.masked_scale_aggregate(u, s)
                sq4n, agg4n = ops.compress_norm_scale_aggregate(u, s, (), "none", 0.0)
                torch.cuda.synchronize()
                check_sq(f"client_sqnorms {tag}", sq2, na.client_sqnorms_ref(u), RTOL)
                check_sq(f"norm_scale_aggregate {tag}", sq3, na.client_sqnorms_ref(u), RTOL)
                check_close(f"norm_scale_aggregate {tag}", agg3,
                            ma.masked_scale_aggregate_ref(u, s), u, s, RTOL, ATOL)
                expect(torch.equal(sq2, sq2b) and torch.equal(sq3, sq3b)
                       and torch.equal(agg3, agg3b), f"relaunch differs {tag}")
                expect(torch.equal(sq3, sq2), f"norm_scale_aggregate norms != client_sqnorms {tag}")
                expect(torch.equal(agg3, agg1),
                       f"norm_scale_aggregate aggregate != masked_scale_aggregate {tag}")
                expect(torch.equal(sq4n, sq3) and torch.equal(agg4n, agg3),
                       f"compress kind=none != norm_scale_aggregate {tag}")
                for j, (kind, param) in enumerate(COMPRESSORS):
                    mats = material(u, kind, param, seed=c * 7919 + d + j)
                    sq4, agg4 = ops.compress_norm_scale_aggregate(u, s, mats, kind, param)
                    sq4b, agg4b = ops.compress_norm_scale_aggregate(u, s, mats, kind, param)
                    xc = apply_compression_flat(u, kind, param, *mats).to(dtype)
                    sq_m, agg_m = ops.norm_scale_aggregate(xc, s)
                    want_sq, want_agg = na.compress_norm_scale_aggregate_ref(u, s, mats, kind,
                                                                             param)
                    torch.cuda.synchronize()
                    ktag = f"{kind}({param}) {tag}"
                    check_sq(f"compress_norm_scale_aggregate {ktag}", sq4, want_sq, RTOL)
                    check_close(f"compress_norm_scale_aggregate {ktag}", agg4, want_agg,
                                xc, s, RTOL, ATOL)
                    expect(torch.equal(sq4, sq4b) and torch.equal(agg4, agg4b),
                           f"relaunch differs {ktag}")
                    expect(torch.equal(sq4, sq_m) and torch.equal(agg4, agg_m),
                           f"fused != eager C(U) then norm_scale_aggregate {ktag}")
                    n_checks += 1
    if failures:
        raise AssertionError(f"{len(failures)} bitwise contracts failed:\n  "
                             + "\n  ".join(failures))
    print(f"kernel check: client_sqnorms, norm_scale_aggregate and "
          f"compress_norm_scale_aggregate ({', '.join(f'{k}({p})' for k, p in COMPRESSORS)}) "
          f"match their plain versions at C in {SWEEP_C} x D in {SWEEP_D}, f32 and bf16 "
          f"(norms rtol {RTOL}; aggregates rtol {RTOL} x sum|s_i x_i| + atol {ATOL}); "
          f"{n_checks} compressed cases")
    print("kernel check: bitwise on the card at every shape — norm_scale_aggregate's norms "
          "== client_sqnorms, its aggregate == masked_scale_aggregate, compress kind=none "
          "== norm_scale_aggregate, compress == eager C(U) then norm_scale_aggregate, and "
          "every kernel launched twice gives equal results")

    zeros4 = torch.zeros(4, device=dev)
    for bad in (torch.zeros((512, 4), device=dev).t(),                  # not contiguous
                torch.zeros((4, 512), device=dev, dtype=torch.float16)):  # dtype
        for call in (lambda: na.client_sqnorms_cuda(bad),
                     lambda: na.norm_scale_aggregate_cuda(bad, zeros4)):
            try:
                call()
            except (ValueError, TypeError):
                pass
            else:
                raise AssertionError(f"a wrapper took {tuple(bad.shape)} {bad.dtype} "
                                     f"stride {bad.stride()}")
    # D % 4 != 0 and rows one element off: kernel 2 (and the fused pair)
    # take them, bitwise what kernel 2 gives on the zero-padded aligned matrix
    for odd in (inputs(4, 7, torch.float32)[0], shifted_copy(torch, inputs(4, 512,
                                                                          torch.float32)[0])):
        padded = torch.nn.functional.pad(odd, (0, (-odd.shape[1]) % ma.TILE)).contiguous()
        if not torch.equal(na.client_sqnorms_cuda(odd), na.client_sqnorms_cuda(padded)):
            raise AssertionError(f"client_sqnorms at {tuple(odd.shape)}, start "
                                 f"{odd.data_ptr() % 16} bytes off, is not its padded result")
        na.norm_scale_aggregate_cuda(odd, zeros4)
    print("kernel check: the wrappers reject a non-contiguous matrix and float16; "
          "client_sqnorms and the fused pair take D % 4 != 0 and rows one element off "
          "(client_sqnorms bitwise its zero-padded result)")

    # timings at the path shapes, on the unpadded matrices the engine passes
    d = 58430
    floor_ms = time_ms(lambda: torch.cuda._sleep(1), torch, flush)
    print(f"launch floor: torch.cuda._sleep(1) {floor_ms} ms by CUDA events (median of "
          f"{TIMING_REPS}, L2 flushed); {card_line()}")
    out = {}

    def timed(name, c, kind, fn, path, plain, library, nbytes, flops, err):
        bound_ms, bound_by = bound(nbytes, flops)
        k_ms = time_ms(fn, torch, flush)
        path_ms = time_ms(path, torch, flush)
        p_ms = time_ms(plain, torch, flush)
        l_ms = time_ms(library, torch, flush) if library is not None else None
        print(f"kernel timing {name}{'' if kind is None else ' ' + kind} at ({c}, {d}) f32 "
              f"(median of {TIMING_REPS}, L2 flushed): kernel {k_ms} ms by events, the ops "
              f"call {path_ms} ms; plain {p_ms} ms, library {l_ms} ms; bound {bound_ms} ms "
              f"({nbytes} bytes, {flops} flops, {bound_by}); launch floor {floor_ms} ms; max "
              f"abs err {err}")
        return {"ms": k_ms, "path_ms": path_ms, "plain_ms": p_ms, "library_ms": l_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "floor_ms": floor_ms}

    # kernel 2 on the unpadded (C, 58430) matrices tree_client_norms passes,
    # beside three one-call library yardsticks of the same function
    for c in (32, 4):
        uc = inputs(c, d, torch.float32, False)[0]
        sq = na.client_sqnorms_cuda(uc)
        err = check_sq("client_sqnorms path shape", sq, na.client_sqnorms_ref(uc), RTOL)
        padded = torch.nn.functional.pad(uc, (0, (-d) % ma.TILE)).contiguous()
        if not (torch.equal(na.client_sqnorms_cuda(shifted_copy(torch, uc)), sq)
                and torch.equal(na.client_sqnorms_cuda(padded), sq)):
            raise AssertionError(f"client_sqnorms at ({c}, {d}) differs shifted by one "
                                 f"element or zero-padded")
        libraries = {
            "torch.einsum": lambda uc=uc: torch.einsum("cd,cd->c", uc, uc),
            "torch.linalg.vecdot": lambda uc=uc: torch.linalg.vecdot(uc, uc, dim=1),
            "torch.bmm": lambda uc=uc: torch.bmm(uc[:, None, :], uc[:, :, None]),
        }
        lib_ms = {name: time_ms(fn, torch, flush) for name, fn in libraries.items()}
        fastest = min(lib_ms, key=lib_ms.get)
        res = timed("client_sqnorms", c, None, lambda uc=uc: na.client_sqnorms_cuda(uc),
                    lambda uc=uc: ops.client_sqnorms(uc),
                    lambda uc=uc: na.client_sqnorms_ref(uc), libraries[fastest],
                    (c * d + c) * 4, 2 * c * d, err)
        res.update({"library": fastest, "library_yardsticks_ms": lib_ms})
        print(f"kernel timing client_sqnorms at ({c}, {d}) f32: library yardsticks {lib_ms} "
              f"ms (fastest {fastest})")
        out[f"client_sqnorms@{c}"] = ((c, d), err, res)

    u4, s4 = inputs(4, d, torch.float32, False)
    sq, agg = na.norm_scale_aggregate_cuda(u4, s4)
    want_sq, want_agg = na.norm_scale_aggregate_ref(u4, s4)
    err = max(check_sq("norm_scale_aggregate path shape", sq, want_sq, RTOL),
              check_close("norm_scale_aggregate path shape", agg, want_agg, u4, s4, RTOL, ATOL))
    shifted = shifted_copy(torch, u4)
    sq_x, agg_x = na.norm_scale_aggregate_cuda(shifted, s4)
    if not (torch.equal(sq, ops.client_sqnorms(u4)) and torch.equal(sq_x, sq)
            and torch.equal(agg, ops.masked_scale_aggregate(u4, s4)) and torch.equal(agg_x, agg)):
        raise AssertionError("norm_scale_aggregate at the path shape is not bitwise kernel 2's "
                             "norms and kernel 1's aggregate, aligned and shifted")
    out["norm_scale_aggregate"] = ((4, d), err, timed(
        "norm_scale_aggregate", 4, None, lambda: na.norm_scale_aggregate_cuda(u4, s4),
        lambda: ops.norm_scale_aggregate(u4, s4),
        lambda: na.norm_scale_aggregate_ref(u4, s4), None,
        (4 * d + 4 + 4 + d) * 4, 4 * 4 * d, err))

    for c in (4, 32):
        uc, sc = inputs(c, d, torch.float32, False)
        # contiguous, as the engine's client matrices are
        mats = tuple(m.contiguous() for m in material(uc, "randk", 0.1, seed=c))
        sq, agg = na.compress_norm_scale_aggregate_cuda(uc, sc, mats, "randk", 0.1)
        want_sq, want_agg = na.compress_norm_scale_aggregate_ref(uc, sc, mats, "randk", 0.1)
        err = max(check_sq("compress_norm_scale_aggregate path shape", sq, want_sq, RTOL),
                  check_close("compress_norm_scale_aggregate path shape", agg, want_agg,
                              uc * mats[0], sc, RTOL, ATOL))
        sq_x, agg_x = na.compress_norm_scale_aggregate_cuda(
            shifted_copy(torch, uc), sc, tuple(shifted_copy(torch, m) for m in mats),
            "randk", 0.1)
        sq6, agg6 = ops.shard_compress_aggregate(uc, sc, mats, "randk", 0.1)
        if not (torch.equal(sq_x, sq) and torch.equal(agg_x, agg) and torch.equal(sq6, sq)
                and torch.equal(agg6, agg)):
            raise AssertionError(f"compress_norm_scale_aggregate at ({c}, {d}) is not bitwise "
                                 f"kernel 6's, or differs shifted by one element")
        out[f"compress_norm_scale_aggregate@{c}"] = ((c, d), err, timed(
            "compress_norm_scale_aggregate", c, "randk",
            lambda: na.compress_norm_scale_aggregate_cuda(uc, sc, mats, "randk", 0.1),
            lambda: ops.compress_norm_scale_aggregate(uc, sc, mats, "randk", 0.1),
            lambda: na.compress_norm_scale_aggregate_ref(uc, sc, mats, "randk", 0.1), None,
            (2 * c * d + c + c + d) * 4, 5 * c * d, err))
    print("kernel check: at the path shapes kernels 3 and 4 are bitwise kernel 2's norms, "
          "kernel 1's and kernel 6's aggregate, on aligned rows and shifted by one element")

    # the profiler's launches per call and device time, from a process of
    # its own (see norm_profile)
    merge_norm_profile(out, ("ops.client_sqnorms", "ops.norm_scale_aggregate",
                             "ops.compress_norm_scale_aggregate"))

    def entry(name, replaces, key):
        shape, err, res = out[key]
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/norm_aggregate.cu",
            "replaces": replaces, "shape": list(shape), "launches": None,
            "max_abs_err": err, **res,
        }

    vm = out["compress_norm_scale_aggregate@32"][2]
    k4 = entry("compress_norm_scale_aggregate", "src/repro/kernels/norm_aggregate.py:125",
               "compress_norm_scale_aggregate@4")
    k4.update({"vmap_shape": [32, d], "vmap_ms": vm["ms"], "vmap_device_ms": vm["device_ms"],
               "vmap_path_ms": vm["path_ms"], "vmap_plain_ms": vm["plain_ms"],
               "vmap_bound_ms": vm["bound_ms"]})
    k2 = entry("client_sqnorms", "src/repro/kernels/client_norm.py:34", "client_sqnorms@32")
    k2["at_4"] = {"shape": [4, d], **out["client_sqnorms@4"][2]}
    return [
        k2,
        entry("norm_scale_aggregate", "src/repro/kernels/norm_aggregate.py:62",
              "norm_scale_aggregate"),
        k4,
    ]


def shifted_copy(torch, x):
    """``x`` copied into a contiguous buffer one element past an aligned start."""
    buf = torch.empty((x.numel() + 1,), dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def norm_profile(torch, dev) -> dict:
    """The norm kernels under torch.profiler, in ONE window: each one-launch
    kernel's ops call (kernels 3, 4 and 6 at all four kinds, kernel 2; f32
    and bf16, at (32, 58430); kernel 6 rand-k also at 129 and 1,024 clients)
    called once alone, whose device kernels are its launches per call; then
    kernels 2, 3, 4 and 6 at the path shapes, each called once alone and
    PROFILE_REPS times after an L2 flush, for their device time.  Run in a
    process of its own (:func:`profile_in_child`)."""
    from repro_torch import rng
    from repro_torch.core.compression import client_material
    from repro_torch.kernels import norm_aggregate as na
    from repro_torch.kernels import ops
    from repro_torch.kernels import sharded_aggregate as sa

    d = 58430
    gen = torch.Generator(device="cpu").manual_seed(2)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)

    def inputs(c, kind, param, dtype):
        u = (torch.randn((c, d), generator=gen) * 1e-2).to(dev, dtype)
        s = torch.rand((c,), generator=gen).to(dev)
        keys = rng.split(rng.PRNGKey(c, device=dev), c)
        mats = tuple(m["u"].contiguous() for m in client_material({"u": u}, keys, kind, param))
        return u, s, mats

    def shard(u, s, mats, kind, param):
        return lambda: ops.shard_compress_aggregate(u, s, mats, kind, param)

    alone = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kind, param in (("none", 0.0), ("randk", 0.1), ("qsgd", 8.0), ("natural", 0.0)):
            u, s, mats = inputs(32, kind, param, dtype)
            name = str(dtype).split('.')[-1]
            tag = f"{kind} {name} (32, {d})"
            alone[f"ops.compress_norm_scale_aggregate {tag}"] = (
                lambda u=u, s=s, mats=mats, kind=kind, param=param:
                ops.compress_norm_scale_aggregate(u, s, mats, kind, param))
            alone[f"ops.shard_compress_aggregate {tag}"] = shard(u, s, mats, kind, param)
            if kind == "none":
                alone[f"ops.norm_scale_aggregate {tag}"] = (
                    lambda u=u, s=s: ops.norm_scale_aggregate(u, s))
                alone[f"ops.client_sqnorms {name} (32, {d})"] = (
                    lambda u=u: ops.client_sqnorms(u))
    big = {k: inputs(k, "randk", 0.1, torch.float32) for k in (129, 1024)}
    for k, (u, s, mats) in big.items():
        alone[f"ops.shard_compress_aggregate randk float32 ({k}, {d})"] = shard(
            u, s, mats, "randk", 0.1)
    u4, s4, _ = inputs(4, "none", 0.0, torch.float32)
    timed = {"norm_scale_aggregate": lambda: ops.norm_scale_aggregate(u4, s4)}
    for c in (32, 4):
        uc = inputs(c, "none", 0.0, torch.float32)[0]
        timed[f"client_sqnorms@{c}"] = lambda uc=uc: ops.client_sqnorms(uc)
    for c in (4, 32):
        uc, sc, mats = inputs(c, "randk", 0.1, torch.float32)
        timed[f"compress_norm_scale_aggregate@{c}"] = (
            lambda uc=uc, sc=sc, mats=mats:
            ops.compress_norm_scale_aggregate(uc, sc, mats, "randk", 0.1))
    for c in (32, 8):
        timed[f"shard_compress_aggregate@{c}"] = shard(*inputs(c, "randk", 0.1, torch.float32),
                                                       "randk", 0.1)
    timed["shard_compress_aggregate@1024"] = shard(*big[1024], "randk", 0.1)
    for kind, param in (("qsgd", 8.0), ("natural", 0.0)):
        timed[f"shard_compress_aggregate {kind}@32"] = shard(
            *inputs(32, kind, param, torch.float32), kind, param)
    wrappers = (na.client_sqnorms_cuda, na.norm_scale_aggregate_cuda,
                na.compress_norm_scale_aggregate_cuda, sa.sharded_compress_aggregate_cuda)
    counted = {}       # the wrappers' launch counts of one call
    for key, call in alone.items():
        before = sum(w.launches for w in wrappers)
        call()
        counted[key] = sum(w.launches for w in wrappers) - before
    segments = list(alone.values())
    for call in timed.values():
        segments += [call] + [lambda call=call: (flush.zero_(), call())] * PROFILE_REPS
    seen = profile_segments(torch, segments)
    out = {"launches": {key: [k[:60] for k, _ in seg] for key, seg in zip(alone, seen)},
           "counted": counted, "timing": {}}
    seen = seen[len(alone):]
    for n, key in enumerate(timed):
        block = seen[n * (PROFILE_REPS + 1):(n + 1) * (PROFILE_REPS + 1)]
        if any(sum("FillFunctor" in k for k, _ in r) != 1 for r in block[1:]):
            raise AssertionError(f"{key}: a timed call's window lacks its flush")
        out["timing"][key] = {
            "launches_per_call": len(block[0]),
            "device_ms": statistics.mean(
                sum(us for k, us in r if "FillFunctor" not in k) for r in block[1:]) / 1e3,
        }
    return out


def merge_norm_profile(out, prefixes) -> None:
    """Read :func:`norm_profile` (run once, in a child): fail unless every
    ops call whose name starts with one of ``prefixes`` ran one device
    kernel and counted one launch on its wrapper; merge the device times of
    the keys of ``out`` into it."""
    prof = profile_in_child("norm")
    for key, names in prof["launches"].items():
        if not key.startswith(tuple(f"{p} " for p in prefixes)):
            continue
        print(f"kernel launches per call of {key} (profiler window around one call): "
              f"{len(names)} ({names}); wrapper count {prof['counted'][key]}")
        if len(names) != 1 or prof["counted"][key] != 1:
            raise AssertionError(f"{key}: {len(names)} device kernels and "
                                 f"{prof['counted'][key]} counted launches per call, want 1")
    for key, res in prof["timing"].items():
        if key in out:
            out[key][2].update(res)
            print(f"kernel device time {key} (profiler, mean of {PROFILE_REPS}, L2 flushed): "
                  f"{res['device_ms']} ms; {res['launches_per_call']} launches per call")


def ssd_profile(torch, dev) -> dict:
    """{str((B, S, H, P, N)): {pass: device us per call}} of kernel 8 on the
    model's views at the serve paths' shapes (:func:`_ssd_pass_times`).
    Run in a process of its own (:func:`profile_in_child`)."""
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device="cpu").manual_seed(8)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    out = {}
    for bsz, h, s, p, n in SSD_PATHS:
        xs, b4, c4, dt, da = _ssd_views(torch, gen, bsz, s, h, p, n, 1, torch.bfloat16, dev)
        out[str((bsz, s, h, p, n))] = _ssd_pass_times(
            torch, lambda: ss.ssd_scan_heads_cuda(xs, b4, c4, dt, da, chunk=128), flush)
    return out


_PROFILES: dict = {}


def profile_in_child(name: str) -> dict:
    """The JSON of ``chip_smoke.py --profile NAME`` (:func:`norm_profile` or
    :func:`ssd_profile`), run once in a process of its own.  On the H100
    (torch 2.11) a torch.profiler window in a process that has run for a
    while can lose device events (some windows see none, some a part; a host
    sleep in the window does not help), while a young process's windows were
    whole in every run: so the windows whose counts and device times a phase
    reports run there."""
    if name not in _PROFILES:
        child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--profile", name],
                               capture_output=True, text=True, timeout=600, cwd=ROOT)
        if child.returncode:
            raise AssertionError(f"the {name} profiler pass failed:\n{child.stderr[-3000:]}")
        _PROFILES[name] = json.loads(child.stdout.strip().splitlines()[-1])
    return _PROFILES[name]


def profile_segments(torch, segments, tries=3) -> list:
    """[(kernel name, device us), ...] for each callable of ``segments``, run
    in order in one torch.profiler window, a marker kernel
    (``torch.cuda._sleep``) before each and one after the last: the window's
    device kernels, in stream order, split at the markers.  On the H100 a
    short window later in a process may lose device events (none, or a few
    at a time); a window that did not see every marker is run again, up to
    ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for seg in segments:
        seg()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for seg in segments:
                torch.cuda._sleep(1)
                seg()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                        key=lambda e: e.time_range.start)
        out = []
        for e in events:
            if "spin_kernel" in e.name:
                out.append([])
            elif out:
                out[-1].append((e.name, e.time_range.elapsed_us()))
        if len(out) == len(segments) + 1 and not out[-1]:
            return out[:-1]
    raise AssertionError(f"no profiler window of {tries} saw all {len(segments) + 1} markers")


def shard_kernel_phase(torch, dev, flush):
    """The mesh round's kernels: each against its plain version over the
    sweep and every compressor, their bitwise contracts with the
    single-device kernels, and their timings at the per-rank path shapes and
    at a large local block."""
    from repro_torch import rng
    from repro_torch.core.compression import apply_compression_flat, client_material
    from repro_torch.kernels import masked_aggregate as ma
    from repro_torch.kernels import ops
    from repro_torch.kernels import sharded_aggregate as sa

    gen = torch.Generator(device="cpu").manual_seed(2)
    specials = _special_values(torch)
    failures = []

    def expect(ok, what):
        if not ok:
            failures.append(what)

    def inputs(c, d, dtype, special=True):
        u = torch.randn((c, d), generator=gen) * 1e-2
        k = min(d, specials.numel()) if special else 0
        u[0, :k] = specials[:k]
        s = torch.rand((c,), generator=gen) * (torch.rand((c,), generator=gen) < 0.6)
        return u.to(dev, dtype), s.to(dev)

    def material(u, kind, param, seed):
        keys = rng.split(rng.PRNGKey(seed, device=dev), u.shape[0])
        return tuple(m["u"] for m in client_material({"u": u}, keys, kind, param))

    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for c in SHARD_SWEEP_C:
            for d in SWEEP_D:
                tag = f"C={c} D={d} {dtype}"
                one_block = c <= sa.BLOCK_CLIENTS
                u, s = inputs(c, d, dtype)
                agg5 = ops.shard_masked_aggregate(u, s)
                agg5b = ops.shard_masked_aggregate(u, s)
                sq6n, agg6n = ops.shard_compress_aggregate(u, s, (), "none", 0.0)
                agg1 = ops.masked_scale_aggregate(u, s)
                sq2 = ops.client_sqnorms(u)
                torch.cuda.synchronize()
                check_close(f"sharded_masked_aggregate {tag}", agg5,
                            sa.sharded_masked_aggregate_ref(u, s), u, s, RTOL, ATOL)
                expect(torch.equal(agg5, agg5b), f"relaunch differs {tag}")
                expect(torch.equal(agg6n, agg5),
                       f"sharded compress kind=none != sharded_masked_aggregate {tag}")
                expect(torch.equal(sq6n, sq2), f"sharded compress kind=none norms != "
                                               f"client_sqnorms {tag}")
                if one_block:
                    expect(torch.equal(agg5, agg1),
                           f"sharded_masked_aggregate != masked_scale_aggregate {tag}")
                for j, (kind, param) in enumerate(COMPRESSORS):
                    mats = material(u, kind, param, seed=c * 7919 + d + j)
                    sq6, agg6 = ops.shard_compress_aggregate(u, s, mats, kind, param)
                    sq6b, agg6b = ops.shard_compress_aggregate(u, s, mats, kind, param)
                    sq4, agg4 = ops.compress_norm_scale_aggregate(u, s, mats, kind, param)
                    want_sq, want_agg = sa.sharded_compress_aggregate_ref(u, s, mats, kind,
                                                                          param)
                    torch.cuda.synchronize()
                    ktag = f"{kind}({param}) {tag}"
                    check_sq(f"sharded_compress_aggregate {ktag}", sq6, want_sq, RTOL)
                    xc = apply_compression_flat(u, kind, param, *mats).to(dtype)
                    check_close(f"sharded_compress_aggregate {ktag}", agg6, want_agg,
                                xc, s, RTOL, ATOL)
                    expect(torch.equal(sq6, sq6b) and torch.equal(agg6, agg6b),
                           f"relaunch differs {ktag}")
                    expect(torch.equal(sq6, sq4),
                           f"sharded compress norms != compress_norm_scale_aggregate {ktag}")
                    if one_block:
                        expect(torch.equal(agg6, agg4), f"sharded compress aggregate != "
                                                        f"compress_norm_scale_aggregate {ktag}")
                    n_checks += 1
    if failures:
        raise AssertionError(f"{len(failures)} bitwise contracts failed:\n  "
                             + "\n  ".join(failures))
    print(f"kernel check: sharded_masked_aggregate and sharded_compress_aggregate "
          f"({', '.join(f'{k}({p})' for k, p in COMPRESSORS)}) match their plain versions "
          f"at C in {SHARD_SWEEP_C} x D in {SWEEP_D}, f32 and bf16 (norms rtol {RTOL}; "
          f"aggregates rtol {RTOL} x sum|s_i x_i| + atol {ATOL}); {n_checks} compressed cases")
    print(f"kernel check: bitwise on the card at every shape — at C <= {sa.BLOCK_CLIENTS} "
          f"sharded_masked_aggregate == masked_scale_aggregate and the sharded compress "
          f"aggregate == compress_norm_scale_aggregate's; at every C the sharded compress "
          f"norms == compress_norm_scale_aggregate's, kind=none == sharded_masked_aggregate "
          f"(its norms == client_sqnorms), and a relaunch gives equal results")

    for bad in (torch.zeros((512, 4), device=dev).t(),                  # not contiguous
                torch.zeros((4, 512), device=dev, dtype=torch.float16)):  # dtype
        s4 = torch.zeros(bad.shape[0], device=dev)
        for call in (lambda: sa.sharded_masked_aggregate_cuda(bad, s4),
                     lambda: sa.sharded_compress_aggregate_cuda(bad, s4, (), "none", 0.0)):
            try:
                call()
            except (ValueError, TypeError):
                pass
            else:
                raise AssertionError(f"a sharded wrapper took {tuple(bad.shape)} "
                                     f"{bad.dtype} stride {bad.stride()}")
    # D % 4 != 0 and rows one element off: kernel 5 rejects them (its ops
    # wrapper pads), kernel 6 takes them, bitwise its zero-padded result
    for odd in (inputs(4, 7, torch.float32)[0], shifted_copy(torch, inputs(4, 512,
                                                                          torch.float32)[0])):
        s4 = torch.rand(4, device=dev)
        mats = (torch.rand(odd.shape, device=dev),)
        pad = (-odd.shape[1]) % ma.TILE
        try:
            sa.sharded_masked_aggregate_cuda(odd, s4)
        except ValueError:
            pass
        else:
            raise AssertionError(f"sharded_masked_aggregate took {tuple(odd.shape)} at an "
                                 f"odd width or start")
        sq6, agg6 = sa.sharded_compress_aggregate_cuda(odd, s4, mats, "randk", 0.1)
        sq6p, agg6p = sa.sharded_compress_aggregate_cuda(
            torch.nn.functional.pad(odd, (0, pad)).contiguous(), s4,
            tuple(torch.nn.functional.pad(m, (0, pad)) for m in mats), "randk", 0.1)
        if not (torch.equal(sq6, sq6p) and torch.equal(agg6, agg6p[:odd.shape[1]])):
            raise AssertionError(f"sharded_compress_aggregate at {tuple(odd.shape)} is not "
                                 f"its zero-padded result")
    print("kernel check: the sharded wrappers reject a non-contiguous matrix and float16; "
          "sharded_masked_aggregate rejects D % 4 != 0 and rows one element off, which "
          "sharded_compress_aggregate takes (bitwise its zero-padded result)")

    d = 58430
    dp = d + (-d) % ma.TILE
    floor_ms = time_ms(lambda: torch.cuda._sleep(1), torch, flush)
    out5, out6 = {}, {}
    for c in (32, 8, 1024):
        # kernel 5 keeps its padded route (ops pads)
        u, s = inputs(c, d, torch.float32, False)
        up = torch.nn.functional.pad(u, (0, dp - d)).contiguous()
        got = sa.sharded_masked_aggregate_cuda(up, s)
        err5 = check_close("sharded_masked_aggregate path shape", got,
                           sa.sharded_masked_aggregate_ref(up, s), up, s, RTOL, ATOL)
        b5 = bound((c * dp + c + dp) * 4, 2 * c * dp)
        t5 = (time_ms(lambda: sa.sharded_masked_aggregate_cuda(up, s), torch, flush),
              time_ms(lambda: sa.sharded_masked_aggregate_ref(up, s), torch, flush),
              time_ms(lambda: torch.matmul(s, up), torch, flush))
        print(f"kernel timing sharded_masked_aggregate at ({c}, {dp}) f32 (median of "
              f"{TIMING_REPS}, L2 flushed): kernel {t5[0]} ms, plain {t5[1]} ms, "
              f"torch.matmul {t5[2]} ms, kernel / torch.matmul {t5[0] / t5[2]}; bound "
              f"{b5[0]} ms ({b5[1]}); max abs err {err5}; {card_line()}")
        out5[c] = {"shape": [c, dp], "max_abs_err": err5, "ms": t5[0], "plain_ms": t5[1],
                   "library_ms": t5[2], "bound_ms": b5[0], "bound_by": b5[1]}
        # kernel 6 on the unpadded (k, 58430) matrices the mesh round passes
        kinds = (("randk", 0.1), ("qsgd", 8.0), ("natural", 0.0)) if c == 32 else (("randk", 0.1),)
        for kind, param in kinds:
            mats = tuple(m.contiguous() for m in material(u, kind, param, seed=c))
            sq, agg = sa.sharded_compress_aggregate_cuda(u, s, mats, kind, param)
            want_sq, want_agg = sa.sharded_compress_aggregate_ref(u, s, mats, kind, param)
            xc = apply_compression_flat(u, kind, param, *mats)
            err6 = max(check_sq("sharded_compress_aggregate path shape", sq, want_sq, RTOL),
                       check_close("sharded_compress_aggregate path shape", agg, want_agg,
                                   xc, s, RTOL, ATOL))
            sq_x, agg_x = sa.sharded_compress_aggregate_cuda(
                shifted_copy(torch, u), s, tuple(shifted_copy(torch, m) for m in mats), kind,
                param)
            sq4, agg4 = ops.compress_norm_scale_aggregate(u, s, mats, kind, param)
            if not (torch.equal(sq_x, sq) and torch.equal(agg_x, agg) and torch.equal(sq4, sq)
                    and (c > sa.BLOCK_CLIENTS or torch.equal(agg4, agg))):
                raise AssertionError(f"sharded_compress_aggregate {kind} at ({c}, {d}) is not "
                                     f"bitwise kernel 4's, or differs shifted by one element")
            if kind == "randk":
                _, agg6n = ops.shard_compress_aggregate(u, s, (), "none", 0.0)
                if not torch.equal(agg6n, ops.shard_masked_aggregate(u, s)):
                    raise AssertionError(f"sharded_compress_aggregate none at ({c}, {d}) is "
                                         f"not bitwise kernel 5's aggregate")
            bound6 = bound(((1 + len(mats)) * c * d + c + c + d) * 4, 5 * c * d)
            k_ms = time_ms(lambda: sa.sharded_compress_aggregate_cuda(u, s, mats, kind, param),
                           torch, flush)
            path_ms = time_ms(lambda: ops.shard_compress_aggregate(u, s, mats, kind, param),
                              torch, flush)
            p_ms = time_ms(lambda: sa.sharded_compress_aggregate_ref(u, s, mats, kind, param),
                           torch, flush)
            print(f"kernel timing sharded_compress_aggregate {kind} at ({c}, {d}) f32 (median "
                  f"of {TIMING_REPS}, L2 flushed): kernel {k_ms} ms by events, the ops call "
                  f"{path_ms} ms; plain {p_ms} ms, library none; bound {bound6[0]} ms "
                  f"({bound6[1]}); launch floor {floor_ms} ms; max abs err {err6}")
            key = f"shard_compress_aggregate@{c}" if kind == "randk" else \
                f"shard_compress_aggregate {kind}@{c}"
            out6[key] = ((c, d), err6, {
                "ms": k_ms, "path_ms": path_ms, "plain_ms": p_ms, "library_ms": None,
                "bound_ms": bound6[0], "bound_by": bound6[1], "floor_ms": floor_ms})
    print(f"kernel check: at the path shapes sharded_compress_aggregate is bitwise kernel 4's "
          f"norms (and aggregate at k <= {sa.BLOCK_CLIENTS}), kernel 5's aggregate for kind "
          f"none, on aligned rows and shifted by one element")
    merge_norm_profile(out6, ("ops.shard_compress_aggregate",))

    source = "src/repro_torch/kernels/csrc/sharded_aggregate.cu"
    k5 = {"name": "sharded_masked_aggregate", "route": "cuda", "source": source,
          "replaces": "src/repro/kernels/sharded_aggregate.py:68", "launches": None,
          **{k: v for k, v in out5[32].items()},
          "max_abs_err": max(o["max_abs_err"] for o in out5.values()),
          **{f"at_{c}": out5[c] for c in (8, 1024)}}
    shape, _, res = out6["shard_compress_aggregate@32"]
    k6 = {"name": "sharded_compress_aggregate", "route": "cuda", "source": source,
          "replaces": "src/repro/kernels/sharded_aggregate.py:140", "shape": list(shape),
          "launches": None, "max_abs_err": max(err for _, err, _ in out6.values()), **res}
    for key, (shape, _, res) in out6.items():
        kind, c = key.removeprefix("shard_compress_aggregate").strip().split("@")
        if key != "shard_compress_aggregate@32":
            k6[f"{kind}_at_{c}" if kind else f"at_{c}"] = {"shape": list(shape), **res}
    return [k5, k6]


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def tensor_core_counts(source="flash_attention",
                       pattern=r"flash_attention_wgmma_kernelILi(\d+)E", key=int) -> dict:
    """{key: tensor-core instructions (HGMMA + HMMA)} of each function of the
    built ``source`` library whose name matches ``pattern`` (its first group
    is the key), by ``cuobjdump -sass``: by default the bf16 instances of
    flash attention, by head dim."""
    import re

    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        found = re.search(pattern, name)
        if found:
            counts[key(found.group(1))] = fn.count("HGMMA") + fn.count("HMMA")
    return counts


def copied_heads(q, k, v, *, window=None, prefix=0):
    """The earlier wiring of ``layers.flash_attention_heads``: (B, S, H, hd)
    copied to the kernel's (B*H, S, hd) rows, and the output's view back,
    which the block's reshape copies again.  For comparison only."""
    from repro_torch.kernels import ops

    b, s, h, hd = q.shape

    def rows(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s, hd)

    out = ops.flash_attention(rows(q), rows(k), rows(v), window=window, prefix=prefix)
    return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)


def attention_kernel_phase(torch, dev, flush):
    """flash_attention: the tensor-core instructions of its bf16 instances,
    kernel vs plain over the sweep, then at the hybrid model's prefill shape
    (the model's strided views bitwise equal to the copied rows), and
    timings there."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    tc = tensor_core_counts()
    if sorted(tc) != sorted(fa.HEAD_DIMS) or not all(tc.values()):
        raise AssertionError(f"flash_attention's bf16 instances lack tensor-core instructions "
                             f"in their SASS: {tc} (head dim: HGMMA + HMMA)")
    print(f"kernel sass: flash_attention bf16 instances, tensor-core instructions (HGMMA + "
          f"HMMA) by head dim: {tc}")
    gen = torch.Generator(device="cpu").manual_seed(7)

    def qkv(bh, s, d, dtype):
        scale = 1.0 if dtype == torch.float32 else 0.5
        return [(torch.randn((bh, s, d), generator=gen) * scale).to(dev, dtype)
                for _ in range(3)]

    def check(name, got, want, dtype, tol=None):
        atol, rtol = tol or ATTN_TOL[str(dtype).split(".")[1]]
        err = (got.float() - want.float()).abs()
        bad = err > atol + rtol * want.float().abs()
        if got.shape != want.shape or got.dtype != dtype or bool(bad.any()):
            raise AssertionError(
                f"flash_attention {name} {dtype}: {int(bad.sum())} elements beyond atol "
                f"{atol} + rtol {rtol} x |want| (max abs err {_max_err(got, want)}; output "
                f"{tuple(got.shape)} {got.dtype})")
        return _max_err(got, want)

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for s in ATTN_SWEEP_S:
            for d in fa.HEAD_DIMS:
                for window, prefix in ATTN_MASKS:
                    q, k, v = qkv(2, s, d, dtype)
                    got = ops.flash_attention(q, k, v, window=window, prefix=prefix)
                    want = fa.flash_attention_ref(q, k, v, window=window, prefix=prefix)
                    torch.cuda.synchronize()
                    err = check(f"S={s} d={d} window={window} prefix={prefix}", got, want,
                                dtype)
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
    print(f"kernel check: flash_attention matches its plain version at S in "
          f"{ATTN_SWEEP_S} x d in {fa.HEAD_DIMS} x (window, prefix) in {ATTN_MASKS}, "
          f"elementwise |err| <= atol + rtol |want|: f32 ((atol, rtol) "
          f"{ATTN_TOL['float32']}, max err {worst[torch.float32]}) and bf16 "
          f"({ATTN_TOL['bfloat16']}, max err {worst[torch.bfloat16]})")

    bh, s, d = ATTN_PATH
    q, k, v = qkv(bh, s, d, torch.bfloat16)
    got = fa.flash_attention_cuda(q, k, v)
    again = fa.flash_attention_cuda(q, k, v)
    r = ATTN_PATH_CHECK_ROWS
    want = fa.flash_attention_ref(q[:r], k[:r], v[:r])
    torch.cuda.synchronize()
    err = check(f"at {ATTN_PATH}", got[:r], want, torch.bfloat16)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention at {ATTN_PATH} bf16: output not finite")
    if not torch.equal(got, again):
        raise AssertionError("flash_attention is not deterministic run to run")
    mag = want.float().abs()
    print(f"kernel path shape flash_attention {ATTN_PATH} bf16: rows 0..{r - 1} against the "
          f"plain version, max abs err {err} (|want| median {float(mag.median())}, at the "
          f"last query {float(mag[:, -1].median())}, max {float(mag.max())}); bitwise equal "
          f"across launches")

    # the model's wiring: (batch, S, heads, d) strided views of one projection
    # buffer, read in place, bitwise the kernel on the copied (BH, S, d) rows
    heads = ATTN_PATH_HEADS
    nb = bh // heads
    buf = (torch.randn((nb, s, 3, heads, d), generator=gen) * 0.5).to(dev, torch.bfloat16)
    qs, ks, vs = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]

    def rows(t):
        return t.permute(0, 2, 1, 3).reshape(bh, s, d)

    strided = layers.flash_attention_heads(qs, ks, vs)
    copied = ops.flash_attention(rows(qs), rows(ks), rows(vs))
    torch.cuda.synchronize()
    if strided.shape != (nb, s, heads, d) or not torch.equal(rows(strided), copied):
        raise AssertionError(f"flash_attention_heads on strided ({nb}, {s}, {heads}, {d}) "
                             f"views differs from ops.flash_attention on the copied rows")
    strided_ms = time_ms(lambda: layers.flash_attention_heads(qs, ks, vs), torch, flush,
                         reps=20)
    copied_ms = time_ms(lambda: copied_heads(qs, ks, vs).reshape(nb, s, heads * d), torch,
                        flush, reps=20)
    print(f"kernel path shape flash_attention_heads on strided ({nb}, {s}, {heads}, {d}) bf16 "
          f"views (strides {qs.stride()}): bitwise equal to ops.flash_attention on the copied "
          f"({bh}, {s}, {d}) rows; timing (median, L2 flushed): in place {strided_ms} ms, the "
          f"earlier wiring with its q/k/v/out copies {copied_ms} ms; {card_line()}")

    # the library yardstick: PyTorch's fused flash backend on (batch, heads, S, d)
    # views of the same tensors; a fall-back to another backend raises
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.view(nb, heads, s, d) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib = sdpa(q4, k4, v4, is_causal=True).view(bh, s, d)
        torch.cuda.synchronize()
        lib_err = check(f"(the library's) at {ATTN_PATH}", lib, got, torch.bfloat16,
                        ATTN_LIBRARY_TOL)
        library_ms = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), torch, flush,
                             reps=20)
    kernel_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v), torch, flush, reps=20)
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v), torch, flush, reps=5)
    pairs = s * (s + 1) // 2                 # the (q, k) pairs the causal mask keeps
    flops = 4 * d * bh * pairs               # q.k and p.v, 2 flops per multiply-add each
    nbytes = 4 * bh * s * d * 2              # q, k, v read once, out written once
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    print(f"kernel timing flash_attention {ATTN_PATH} bf16 (median, L2 flushed): kernel "
          f"{kernel_ms} ms, plain {plain_ms} ms, scaled_dot_product_attention(is_causal) "
          f"on ({bh // heads}, {heads}, {s}, {d}) views under SDPBackend.FLASH_ATTENTION "
          f"{library_ms} ms (its output within (atol, rtol) {ATTN_LIBRARY_TOL} of the "
          f"kernel's, max abs diff {lib_err}); kernel / library {kernel_ms / library_ms}; bound "
          f"{bound_ms} ms ({bound_by}: {flops} flops at 989 TFLOP/s, {nbytes} bytes at 3.35 "
          f"TB/s); {card_line()}")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "shape": list(ATTN_PATH), "dtype": "bfloat16", "launches": None,
        "max_abs_err": max(err, *worst.values()), "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "strided_ms": strided_ms, "copied_wiring_ms": copied_ms,
        "tensor_core_instructions": tc,
    }


def _ssd_inputs(torch, gen, x_shape, bc_shape, dt_shape, dtype, dev):
    """The reference's own SSD test recipe: x, B, C ~ N(0, 1/4); dt =
    softplus(N(0, 1)) / 5; da = -dt exp(N(0, 1/100))."""
    x = (torch.randn(x_shape, generator=gen) * 0.5).to(dev, dtype)
    b = (torch.randn(bc_shape, generator=gen) * 0.5).to(dev, dtype)
    c = (torch.randn(bc_shape, generator=gen) * 0.5).to(dev, dtype)
    dt = torch.nn.functional.softplus(torch.randn(dt_shape, generator=gen)) * 0.2
    da = -dt * torch.exp(torch.randn(dt_shape, generator=gen) * 0.1)
    return x, b, c, dt.to(dev), da.to(dev)


def _check_ssd(torch, name, got, want) -> float:
    for g, w, what in zip(got, want, ("y", "state")):
        err = (g - w).abs()
        bad = err > SSD_ATOL + SSD_RTOL * w.abs()
        if g.shape != w.shape or g.dtype != torch.float32 or bool(bad.any()):
            raise AssertionError(f"{name} {what}: {int(bad.sum())} elements beyond atol "
                                 f"{SSD_ATOL} + rtol {SSD_RTOL} (max abs err "
                                 f"{float(err.max())}; shapes {tuple(g.shape)} {tuple(w.shape)})")
    return max(_max_err(g, w) for g, w in zip(got, want))


def _ssd_views(torch, gen, bsz, s, h, p, n, g, dtype, dev):
    """The model's layout: x (B,S,H,P) and B, C (B,S,G,N) as strided views of
    one (B, S, H*P + 2*G*N) projection buffer, as ``apply_mamba2`` cuts them
    (the reference's recipe: N(0, 1/4)); dt, da (B,S,H) f32 as in
    :func:`_ssd_inputs`."""
    buf = (torch.randn((bsz, s, h * p + 2 * g * n), generator=gen) * 0.5).to(dev, dtype)
    xs = buf[..., :h * p].reshape(bsz, s, h, p)
    b = buf[..., h * p:h * p + g * n].reshape(bsz, s, g, n)
    c = buf[..., h * p + g * n:].reshape(bsz, s, g, n)
    dt = torch.nn.functional.softplus(torch.randn((bsz, s, h), generator=gen)) * 0.2
    da = -dt * torch.exp(torch.randn((bsz, s, h), generator=gen) * 0.1)
    return xs, b, c, dt.to(dev), da.to(dev)


def _ssd_rows(xs, b, c, dt, da):
    """The per-row interface's inputs, materialized: per-head (B*H, S, P) and
    (B*H, S, N) copies and (B*H, S) dt, da (the earlier wiring)."""
    bsz, s, h, _ = xs.shape

    def rows(t):
        return t.expand(bsz, s, h, t.shape[-1]).permute(0, 2, 1, 3).reshape(
            bsz * h, s, -1).contiguous()

    def per_head(t):
        return t.permute(0, 2, 1).reshape(bsz * h, s).contiguous()

    return rows(xs), rows(b), rows(c), per_head(dt), per_head(da)


def _copied_ssd_wiring(xs, b, c, dt, da, chunk):
    """The earlier wiring of ``ssm.ssd_scan_heads``: per-head copies of x, B,
    C, dt, da, the per-row kernel, and y permuted back (which the block's
    ``y + D x`` then copied).  For comparison only."""
    from repro_torch.kernels import ssd_scan as ss

    bsz, s, h, p = xs.shape
    y, state = ss.ssd_scan_cuda(*_ssd_rows(xs, b, c, dt, da), chunk=chunk)
    return (y.reshape(bsz, h, s, p).permute(0, 2, 1, 3).contiguous(),
            state.reshape(bsz, h, p, state.shape[-1]))


SSD_PASSES = ("ssd_chunk_state_bf16", "ssd_state_pass", "ssd_chunk_out_bf16")


def _ssd_pass_times(torch, fn, flush, reps=5) -> dict:
    """{pass kernel: mean device us per call} of ``fn`` under the profiler, L2
    flushed before each call (one window, see :func:`profile_segments`)."""
    out = {}
    for seg in profile_segments(torch, [lambda: (flush.zero_(), fn())] * reps):
        for key, us in seg:
            for name in SSD_PASSES:
                if name + "(" in key or name + "<" in key:    # pass 2 is a template
                    out[name] = out.get(name, 0.0) + us / reps
    if sorted(out) != sorted(SSD_PASSES):
        raise AssertionError(f"the profiler saw the SSD passes {sorted(out)}, want {SSD_PASSES}")
    return out


def ssd_kernel_phase(torch, dev, flush):
    """ssd_scan: the tensor-core instructions of its bf16 passes; the kernel
    vs the sequential recurrence over the sweep (per-row interface); the
    model's strided views at G = 1 and G = H against the plain version and
    the eager chunked core, bitwise the per-row route on materialized
    copies and bitwise run to run; timings at the serve paths' shapes, with
    each pass's share and the bounds."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import ssm

    tc = tensor_core_counts("ssd_scan", r"(ssd_chunk_\w+?_bf16)", str)
    if sorted(tc) != sorted(SSD_PASSES[::2]) or not all(tc.values()):
        raise AssertionError(f"the SSD scan's bf16 passes lack tensor-core instructions in "
                             f"their SASS: {tc}")
    print(f"kernel sass: ssd_scan bf16 passes, tensor-core instructions (HMMA + HGMMA): {tc}")
    gen = torch.Generator(device="cpu").manual_seed(8)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for s in SSD_SWEEP_S:
            for chunk in SSD_SWEEP_CHUNK:
                for p, n in SSD_SWEEP_PN:
                    x, b, c, dt, da = _ssd_inputs(torch, gen, (3, s, p), (3, s, n), (3, s),
                                                  dtype, dev)
                    got = ops.ssd_scan(x, b, c, dt, da, chunk=chunk)
                    want = ss.ssd_scan_ref(x, b, c, dt, da)
                    torch.cuda.synchronize()
                    worst = max(worst, _check_ssd(
                        torch, f"ssd_scan S={s} chunk={chunk} P={p} N={n} {dtype}", got, want))
    print(f"kernel check: ssd_scan matches the sequential recurrence at S in {SSD_SWEEP_S} "
          f"x chunk in {SSD_SWEEP_CHUNK} x (P, N) in {SSD_SWEEP_PN}, f32 and bf16 (atol "
          f"{SSD_ATOL} + rtol {SSD_RTOL}; max abs err {worst})")

    # the view entry at G = 1 and G = H: the plain version, the per-row route
    # on materialized copies (bitwise), and run to run (bitwise)
    for dtype in (torch.float32, torch.bfloat16):
        for g in (1, SSD_VIEW_CHECK[2]):
            bsz, s, h, p, n = SSD_VIEW_CHECK
            xs, b, c, dt, da = _ssd_views(torch, gen, bsz, s, h, p, n, g, dtype, dev)
            got = ss.ssd_scan_heads_cuda(xs, b, c, dt, da, chunk=128)
            again = ss.ssd_scan_heads_cuda(xs, b, c, dt, da, chunk=128)
            rows = ss.ssd_scan_cuda(*_ssd_rows(xs, b, c, dt, da), chunk=128)
            want = ss.ssd_scan_heads_ref(xs, b, c, dt, da)
            torch.cuda.synchronize()
            worst = max(worst, _check_ssd(torch, f"ssd_scan_heads G={g} {dtype}", got, want))
            if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                raise AssertionError(f"ssd_scan_heads G={g} {dtype} is not bitwise run to run")
            if not (torch.equal(got[0].permute(0, 2, 1, 3).reshape(rows[0].shape), rows[0])
                    and torch.equal(got[1].reshape(rows[1].shape), rows[1])):
                raise AssertionError(f"ssd_scan_heads G={g} {dtype} on views differs from the "
                                     f"per-row route on materialized copies")
    print(f"kernel check: ssd_scan_heads on strided {SSD_VIEW_CHECK} views at G = 1 and G = H, "
          f"f32 and bf16: within atol {SSD_ATOL} + rtol {SSD_RTOL} of the sequential "
          f"recurrence, bitwise run to run, and bitwise the per-row route on materialized "
          f"per-head copies")

    times = []
    pass_times = profile_in_child("ssd")
    for bsz, h, s, p, n in SSD_PATHS:
        q, nc, rows_n = 128, s // 128, bsz * h
        xs, b4, c4, dt, da = _ssd_views(torch, gen, bsz, s, h, p, n, 1, torch.bfloat16, dev)
        b, c = b4[:, :, 0], c4[:, :, 0]                  # the model's (B, S, N) group
        got = ssm.ssd_chunked(xs, b, c, dt, da, q)
        again = ssm.ssd_chunked(xs, b, c, dt, da, q)
        want = ssm.ssd_chunked_eager(xs, b, c, dt, da, q)
        copied = _copied_ssd_wiring(xs, b4, c4, dt, da, q)
        torch.cuda.synchronize()
        tag = f"({bsz}, {s}, {h}, {p}) x ({bsz}, {s}, 1, {n})"
        err = _check_ssd(torch, f"ssd_chunked at {tag}", got, want)
        if not all(torch.equal(u, w) for u, w in zip(got, again)):
            raise AssertionError(f"ssd_chunked at {tag} is not bitwise run to run")
        if not all(torch.equal(u, w) for u, w in zip(got, copied)):
            raise AssertionError(f"ssd_chunked at {tag} on views differs from the per-row route "
                                 f"on materialized copies")

        def kernel():
            return ss.ssd_scan_heads_cuda(xs, b4, c4, dt, da, chunk=q)

        kernel_ms = time_ms(kernel, torch, flush, reps=20)
        wired_ms = time_ms(lambda: ssm.ssd_chunked(xs, b, c, dt, da, q), torch, flush, reps=20)
        copied_ms = time_ms(lambda: _copied_ssd_wiring(xs, b4, c4, dt, da, q), torch, flush,
                            reps=20)
        eager_ms = time_ms(lambda: ssm.ssd_chunked_eager(xs, b, c, dt, da, q), torch, flush,
                           reps=5)
        xr, br, cr, dtr, dar = _ssd_rows(xs, b4, c4, dt, da)
        plain_ms = time_ms(lambda: ss.ssd_scan_ref(xr, br, cr, dtr, dar), torch, flush, reps=3)
        passes = pass_times[str((bsz, s, h, p, n))]
        total = sum(passes.values())
        # the function on the model's views: x and y once, the one B/C group
        # once per batch, C B^T once per (batch, chunk)
        flops = bsz * nc * q * (q + 1) * n + rows_n * nc * (q * (q + 1) * p + 4 * q * n * p)
        nbytes = (rows_n * s * p * 2 + bsz * s * 2 * n * 2 + rows_n * s * 4 * 2
                  + rows_n * s * p * 4 + rows_n * p * n * 4)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        # the three passes' own traffic: the (B, NC, H, P, N) f32 scratch
        # written by pass 1, read and written by pass 2, read by pass 3 (and
        # a_tot), and x, dt, da and B read by both pass 1 and pass 3
        scratch = rows_n * nc * p * n * 4
        pass_bytes = (nbytes + 4 * scratch + 3 * rows_n * nc * 4 + rows_n * s * p * 2
                      + rows_n * s * 4 * 2 + bsz * s * n * 2)
        pass_bound_ms, pass_bound_by = bound(pass_bytes, flops, BF16_FLOPS_PER_S)
        # the per-row interface's function: B and C one row per head
        row_flops = rows_n * nc * (q * (q + 1) * (n + p) + 4 * q * n * p)
        row_bytes = (rows_n * s * (p + 2 * n) * 2 + rows_n * s * 4 * 2 + rows_n * s * p * 4
                     + rows_n * p * n * 4)
        row_bound_ms, _ = bound(row_bytes, row_flops, BF16_FLOPS_PER_S)
        share = {k: v / total for k, v in passes.items()}
        print(f"kernel path shape ssd_scan on the model's {tag} bf16 views, chunk {q}: "
              f"within atol {SSD_ATOL} + rtol {SSD_RTOL} of the eager chunked core (max abs err "
              f"{err}); bitwise run to run and bitwise the per-row route on materialized "
              f"copies; timing (median, L2 flushed): kernel {kernel_ms} ms (CUDA events around "
              f"the call, the wrapper's host work past the flush included), plain (sequential "
              f"recurrence on the rows) {plain_ms} ms, library none; device time by the "
              f"profiler {total / 1e3} ms, passes (us per call) {passes}, shares {share}; bound {bound_ms} ms ({bound_by}: {flops} flops "
              f"at 989 TFLOP/s, {nbytes} bytes at 3.35 TB/s), with the passes' scratch "
              f"traffic {pass_bound_ms} ms ({pass_bytes} bytes), the per-row interface's "
              f"{row_bound_ms} ms; the model's core: ssd_chunked (the kernel on the views) "
              f"{wired_ms} ms, the earlier wiring with its per-head copies {copied_ms} ms, "
              f"the eager chunked core {eager_ms} ms, eager / ssd_chunked "
              f"{eager_ms / wired_ms}; {card_line()}")
        times.append({"shape": [bsz, s, h, p, n], "ms": kernel_ms, "device_ms": total / 1e3,
                      "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "passes_bound_ms": pass_bound_ms, "rows_interface_bound_ms": row_bound_ms,
                      "pass_us": passes, "wired_ms": wired_ms, "copied_wiring_ms": copied_ms,
                      "eager_core_ms": eager_ms, "max_abs_err": err})
    first = times[0]
    return {
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:78", "shape": first["shape"],
        "dtype": "bfloat16", "launches": None,
        "max_abs_err": max(worst, *(t["max_abs_err"] for t in times)),
        "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"], "library_ms": None, "device_ms": first["device_ms"],
        "passes_bound_ms": first["passes_bound_ms"],
        "rows_interface_bound_ms": first["rows_interface_bound_ms"], "pass_us": first["pass_us"],
        "eager_core_ms": first["eager_core_ms"], "wired_ms": first["wired_ms"],
        "copied_wiring_ms": first["copied_wiring_ms"], "tensor_core_instructions": tc,
        "at_mamba2_130m": times[1],
    }


def _eager_cores():
    """A context in which the model's two kernel call sites run their eager
    forms on the card (``chunked_attention_eager``, ``ssd_chunked_eager``):
    the plain version of the whole prefill, for comparison only."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.models import layers, ssm

    stack = ExitStack()
    stack.enter_context(mock.patch.object(layers, "chunked_attention",
                                          layers.chunked_attention_eager))
    stack.enter_context(mock.patch.object(ssm, "ssd_chunked", ssm.ssd_chunked_eager))
    return stack


def _first_blocks(torch, cfg, params, tokens):
    """The first Mamba2 block and, in the hybrid, the first call of the shared
    attention block, each run through its kernel and through its eager core
    on the same input: [(name, kernel output, eager output)]."""
    from repro_torch.models import transformer as T
    from repro_torch.models.model import _attn_ctx, _positions

    stack = params["mamba"] if "mamba" in params else params["layers"]
    out = []
    with torch.inference_mode():
        h = T.embed_tokens(params["embed"], tokens, cfg)
        got, _ = T.mamba_block(T.layer(stack, 0), h, cfg)
        with _eager_cores():
            want, _ = T.mamba_block(T.layer(stack, 0), h, cfg)
        out.append(("mamba block 0", got, want))
        if "shared_attn" in params:
            with _eager_cores():
                for i in range(cfg.shared_attn_every - 1):
                    h, _ = T.mamba_block(T.layer(stack, i), h, cfg)
            bsz, seq, _ = h.shape
            mask, ci = _attn_ctx(cfg, seq, device=h.device)
            kw = {"positions": _positions(bsz, seq, h.device), "mask": mask,
                  "ff_kind": "mlp", "chunked_info": ci}
            got, _, _ = T.attn_block(params["shared_attn"], h, cfg, **kw)
            with _eager_cores():
                want, _, _ = T.attn_block(params["shared_attn"], h, cfg, **kw)
            out.append(("shared attention block, first call", got, want))
    return out


def _bf16_ulps(torch, got, want):
    """|got - want| in units of bf16's last place at |want|."""
    w = want.float().abs().clamp_min(2.0 ** -126)
    return (got.float() - want.float()).abs() / torch.exp2(torch.floor(torch.log2(w)) - 7)


def _profile_serve(torch, dev, cfg, params, gen):
    """(busy ms, wall ms, top device ops) of one serve call under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import serve

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t = serve(cfg, SERVE_BATCH, SERVE_PROMPT, gen, device=dev, params=params)
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), t["prefill_ms"] + t["decode_ms"], rows, prof


def serve_phase(torch, dev, arch, gen, per_prefill, out_dir):
    """One serve path at full width on the card: set-up, a measured run with
    the launch counts zeroed just before and read just after, a second run
    with the same tokens, the kernel prefill against the eager-core prefill,
    and profiler passes (prefill alone, then the whole call)."""
    from repro_torch.configs import get
    from repro_torch.kernels.ops import tree_leaves
    from repro_torch.launch.serve import prompt_tokens, serve
    from repro_torch.models import build_model

    cfg = get(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    toks0, _ = serve(cfg, SERVE_BATCH, SERVE_PROMPT, gen, device=dev, params=params)
    setup_ms = (time.perf_counter() - t0) * 1e3
    n_params = sum(t.numel() for t in tree_leaves(params))

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    toks, t = serve(cfg, SERVE_BATCH, SERVE_PROMPT, gen, device=dev, params=params)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = {name: per_prefill.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{arch} serve: launches {counts}, want {want} (one prefill, "
                             f"none in decode)")
    if toks.shape != (SERVE_BATCH, gen) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{arch} serve: bad tokens {toks.shape}")
    if not (toks == toks0).all():
        raise AssertionError(f"{arch} serve: a second run gave other tokens")
    steps = t["decode_steps"]
    tok_s = steps * SERVE_BATCH / (t["decode_ms"] / 1e3)
    print(f"path serve {arch}: full width ({cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.dtype}, {n_params} parameters; param_count() {cfg.param_count()} leaves out "
          f"the conv and MLP biases), batch {SERVE_BATCH}, prompt "
          f"{SERVE_PROMPT}, gen {gen}; launches in the run {counts}; a second run gave "
          f"the same tokens; first tokens {toks[0][:8].tolist()}")
    print(f"path serve {arch} timing: prefill {t['prefill_ms']} ms; decode {t['decode_ms']} "
          f"ms for {steps} steps = {t['decode_ms'] / steps} ms per step, {tok_s} generated "
          f"tokens/s; set-up (init + the first serve call) {setup_ms} ms; peak device "
          f"memory {peak_gb} GB")

    tokens = torch.as_tensor(prompt_tokens(cfg, SERVE_BATCH, SERVE_PROMPT), device=dev)
    blocks = {}
    for name, got, want in _first_blocks(torch, cfg, params, tokens):
        diff = (got.float() - want.float()).abs()
        ulps = _bf16_ulps(torch, got, want)
        d_max, d_rms = float(diff.max()), float(diff.square().mean().sqrt())
        w_max, w_rms = float(want.float().abs().max()), float(want.float().square().mean().sqrt())
        print(f"path serve {arch} {name}: kernel core against eager core, bf16 output "
              f"{tuple(got.shape)}: max abs diff {d_max} (bound {SERVE_BLOCK_MAX} x max |out| "
              f"{w_max}), rms diff {d_rms} (bound {SERVE_BLOCK_RMS} x rms(out) {w_rms}); "
              f"elements that differ {float((diff > 0).float().mean())}, by more than one "
              f"bf16 unit at their own value {float((ulps > 1).float().mean())}")
        if not (got.shape == want.shape and d_max <= SERVE_BLOCK_MAX * w_max
                and d_rms <= SERVE_BLOCK_RMS * w_rms):
            raise AssertionError(f"{arch} {name}: the kernel core's block output is not "
                                 f"within bf16 rounding of the eager core's")
        blocks[name] = {"max_abs_diff": d_max, "rms_diff": d_rms}
    with torch.inference_mode():
        got, _ = model.prefill(params, {"tokens": tokens}, SERVE_PROMPT + gen)
        reset_counts()
        with _eager_cores():
            want_logits, _ = model.prefill(params, {"tokens": tokens}, SERVE_PROMPT + gen)
        eager_counts = read_counts()
    got, want_logits = got.float(), want_logits.float()
    err = float((got - want_logits).abs().max())
    scale = float(want_logits.abs().max())
    agree = float((got[:, -1].argmax(-1) == want_logits[:, -1].argmax(-1)).float().mean())
    if any(eager_counts.values()):
        raise AssertionError(f"the eager-core prefill launched kernels: {eager_counts}")
    if not bool(torch.isfinite(got).all()) or not err <= SERVE_LOGIT_RTOL * scale:
        raise AssertionError(f"{arch}: kernel prefill logits differ from the eager cores' "
                             f"by {err} (max |logit| {scale}, rtol {SERVE_LOGIT_RTOL})")
    print(f"path serve {arch}: the kernel prefill's last-position logits against the "
          f"eager-core prefill: max abs diff {err}, max |logit| {scale} (bound "
          f"{SERVE_LOGIT_RTOL} x max |logit|), top-1 agreement {agree}")

    busy_p, wall_p, rows_p, _ = _profile_serve(torch, dev, cfg, params, 1)
    busy, wall, rows, prof = _profile_serve(torch, dev, cfg, params, gen)
    if busy_p and busy:
        idle_p, idle = 1 - busy_p / wall_p, 1 - busy / wall
        print(f"profile serve {arch}: prefill alone (gen 1): wall {wall_p} ms, device busy "
              f"{busy_p} ms, idle share {idle_p}; whole call (gen {gen}): wall {wall} ms, "
              f"device busy {busy} ms, idle share {idle}; decode (the difference): wall "
              f"{wall - wall_p} ms, busy {busy - busy_p} ms, idle share "
              f"{1 - (busy - busy_p) / (wall - wall_p)}")
    else:
        idle_p = idle = None
        print(f"profile serve {arch}: the profiler recorded no device time (not measured)")
    for label, top in (("prefill", rows_p), ("whole call", rows)):
        for key, ms, count in top[:8]:
            print(f"profile serve {arch} {label}: {ms:10.3f} ms {count:6d}x  {key[:80]}")
    copies = None
    if per_prefill.get("flash_attention"):
        # the prefill again with the earlier attention wiring (q, k, v copied
        # to (B*H, S, hd) rows and the output copied back), by kernel
        from unittest import mock

        from repro_torch.models import layers

        with mock.patch.object(layers, "flash_attention_heads", copied_heads):
            busy_c, wall_c, rows_c, _ = _profile_serve(torch, dev, cfg, params, 1)
        copies = {"prefill_wall_ms": wall_c, "prefill_busy_ms": busy_c}
        print(f"profile serve {arch} prefill alone (gen 1), {card_line()}: attention on strided "
              f"views, wall {wall_p} ms, device busy {busy_p} ms; with the earlier q/k/v/out "
              f"copies, wall {wall_c} ms, device busy {busy_c} ms")
        for label, top in (("in place", rows_p), ("with copies", rows_c)):
            for key, ms, count in top[:12]:
                print(f"profile serve {arch} prefill {label}: {ms:10.3f} ms {count:6d}x  "
                      f"{key[:80]}")
    if out_dir is not None:
        prof.export_chrome_trace(str(out_dir / f"chip_smoke_trace_serve_{arch}.json.gz"))
    return {"arch": arch, "counts": counts, "prefill_ms": t["prefill_ms"],
            "decode_ms_per_step": t["decode_ms"] / steps, "tokens_per_s": tok_s,
            "setup_ms": setup_ms, "peak_gb": peak_gb, "logit_max_abs_diff": err,
            "first_blocks": blocks, "prefill_busy_ms": busy_p, "with_copies": copies,
            "idle_share": idle, "prefill_idle_share": idle_p}


def serve_reduced_phase(torch, dev):
    """The reduced hybrid in f32 on the card against the same run on the CPU,
    at a prompt that runs both kernels (>= CHUNK_THRESHOLD) and pads the SSD
    (not a chunk multiple): prefill logits within 1e-4, greedy tokens equal."""
    from repro_torch.configs import get
    from repro_torch.kernels.ops import tree_map
    from repro_torch.launch.serve import prompt_tokens, serve
    from repro_torch.models import build_model
    from repro_torch.models.model import CHUNK_THRESHOLD

    cfg = get(REDUCED_ARCH)
    if REDUCED_PROMPT < CHUNK_THRESHOLD or REDUCED_PROMPT % cfg.ssm_chunk == 0:
        raise AssertionError("the reduced prompt must reach the chunked attention and pad the SSD")
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0), "cpu")
    gpu_params = tree_map(lambda t: t.to(dev), cpu_params)
    tokens = prompt_tokens(cfg, SERVE_BATCH, REDUCED_PROMPT)
    outs = {}
    for name, params, where in (("cpu", cpu_params, "cpu"), ("cuda", gpu_params, dev)):
        reset_counts()
        with torch.inference_mode():
            logits, _ = model.prefill(params, {"tokens": torch.as_tensor(tokens, device=where)},
                                      REDUCED_PROMPT + REDUCED_GEN)
        counts = read_counts()
        toks, _ = serve(cfg, SERVE_BATCH, REDUCED_PROMPT, REDUCED_GEN, device=where,
                        params=params)
        outs[name] = (logits.float().cpu(), toks, counts)
    n_attn = cfg.num_layers // cfg.shared_attn_every
    want = {k: 0 for k in outs["cuda"][2]}
    want.update(flash_attention=n_attn, ssd_scan=cfg.num_layers - n_attn)
    if outs["cuda"][2] != want or any(outs["cpu"][2].values()):
        raise AssertionError(f"reduced prefill launches: card {outs['cuda'][2]} (want {want}), "
                             f"CPU {outs['cpu'][2]} (want none)")
    err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    if not err <= REDUCED_LOGIT_ATOL or not (outs["cuda"][1] == outs["cpu"][1]).all():
        raise AssertionError(f"{REDUCED_ARCH}: the card's prefill logits differ from the "
                             f"CPU's by {err}, or the greedy tokens differ")
    print(f"path serve {REDUCED_ARCH} (f32, TF32 off, prompt {REDUCED_PROMPT}, gen "
          f"{REDUCED_GEN}): the card matches the CPU — prefill logits max abs diff {err} "
          f"(atol {REDUCED_LOGIT_ATOL}), greedy tokens equal; card launches {outs['cuda'][2]}")


def main_scenario():
    """The second slice's main path: the reference's scan cell with the
    reference's rand-k compressor and the pallas backend (both settings of
    its own FLConfig)."""
    from repro_torch.sim.scenarios import get_scenario

    sc = get_scenario(MAIN_CELL)
    fl = dataclasses.replace(sc.fl, agg_backend="pallas", compression="randk",
                             compression_param=0.1)
    return sc.with_(name=f"{MAIN_CELL}+randk+pallas", fl=fl)


def vmap_scenario():
    from repro_torch.sim.scenarios import get_scenario

    sc = get_scenario(VMAP_CELL)
    return sc.with_(name=f"{VMAP_CELL}+pallas",
                    fl=dataclasses.replace(sc.fl, agg_backend="pallas"))


def path_phase(torch, sc, rounds, per_round, out_dir, mode="host", dim=MAIN_DIM,
               rounds_per_scan=SCAN_BLOCK):
    """One path at full width in driver mode ``mode``: ``rounds`` rounds
    through the kernels (``per_round`` launches each), reproduced bitwise,
    and a reduced run on the card against the CPU.  A sharded cell runs the
    mesh round at world size 1 (NCCL on the card, gloo for the CPU run).
    In ``'scan'`` mode (blocks of ``rounds_per_scan``) a round is a CUDA-graph
    replay and the wrappers count their host calls (the eager first round's,
    and the capture's, which launch nothing): the run's device launches are
    its eager round's plus its graph's kernel nodes (:func:`scan_census`)
    times its replays, all read in this run; the child's trace of the same
    cell's replayed rounds (:func:`mode_profile_report`) must show
    ``per_round`` too.  Returns the device launches of the run, the
    parameters and the ledger."""
    from repro_torch.kernels.ops import tree_leaves
    from repro_torch.sim.driver import run_scenario, validate_ledger

    label = f"{sc.name} [{mode}]"
    kw = {"mode": mode, **({"rounds_per_scan": rounds_per_scan} if mode == "scan" else {})}
    census = []
    reset_counts()
    t0 = time.perf_counter()
    with scan_census(census, out_dir, sc.name) if mode == "scan" else contextlib.nullcontext():
        params, ledger = run_scenario(sc, rounds=rounds, **kw)
    counts = read_counts()
    if mode == "scan":
        counts = scan_launches(label, counts, census, rounds)
    want = {name: per_round.get(name, 0) * rounds for name in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, want {want}")
    doc = ledger.to_json(include_masks=True)
    validate_ledger(doc)
    if len(ledger.loss) != rounds or not all(map(_finite, ledger.loss)):
        raise AssertionError(f"bad loss series {ledger.loss}")
    if (ledger.workload["model_dim"] != dim or ledger.workload["backend_platform"] != "cuda"
            or ledger.workload.get("mesh_axis_size") != (1 if sc.sharded else None)
            or ledger.workload.get("rounds_per_scan") != kw.get("rounds_per_scan")
            or ("pool_bytes" in ledger.workload) != (mode != "host")):
        raise AssertionError(f"unexpected workload {ledger.workload}")
    for i, p in enumerate(tree_leaves(params)):
        if p.device.type != "cuda" or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"parameter leaf {i} is not finite on the card")
    walls = ledger.wall_ms[1:]
    print(f"path {label}: full width, {rounds} rounds on the card in "
          f"{time.perf_counter() - t0:.1f} s; launches per round "
          f"{ {k: v / rounds for k, v in counts.items() if v} }; loss {ledger.loss[0]} -> "
          f"{ledger.loss[-1]}; sent {ledger.sent}; uplink bits {ledger.uplink_bits[-1]}")
    cadence = {"prefetch": " (dispatch cadence: no sync per round)",
               "scan": f" (each its block's time over its span; blocks of {rounds_per_scan})",
               }.get(mode, "")
    first = "first round" if mode != "scan" else "first block"
    print(f"path {label} timing: {ledger.rounds_per_sec} rounds/s after the {first}; "
          f"per-round ms{cadence} median {statistics.median(walls)}, min {min(walls)}, "
          f"max {max(walls)}; set-up (first round) {ledger.wall_ms[0]} ms; run "
          f"{ledger.wall_s * 1e3} ms; pool bytes {ledger.workload.get('pool_bytes')}; "
          f"{card_line()}")

    same_run(torch, f"{label}, a second run", (params, ledger),
             run_scenario(sc, rounds=rounds, **kw))

    # a reference on a small input: the same reduced run on the CPU
    _, red_cpu = run_scenario(sc, reduced=True, rounds=3, device="cpu", **kw)
    _, red_gpu = run_scenario(sc, reduced=True, rounds=3, **kw)
    if not all(bool((a == b).all()) for a, b in zip(red_cpu.masks, red_gpu.masks)):
        raise AssertionError(f"{label} reduced: masks differ between the card and the CPU")
    for a, b in zip(red_cpu.loss, red_gpu.loss):
        if abs(a - b) > 1e-4 * abs(a):
            raise AssertionError(f"{label} reduced: losses differ {red_cpu.loss} "
                                 f"{red_gpu.loss}")
    print(f"path {label}: reduced run on the card matches the CPU (masks bitwise, loss "
          f"rtol 1e-4): {red_gpu.loss} vs {red_cpu.loss}")
    if out_dir is not None:
        suffix = "" if mode == "host" else f"_{mode}"
        (out_dir / f"chip_smoke_ledger_{sc.name}{suffix}.json").write_text(
            json.dumps(doc, indent=1))
    if mode == "scan":
        traced = mode_profile_report()["launches"].get(sc.name, {})
        print(f"path {label}: device launches per replayed round in the trace of the child's "
              f"scan run ({SCAN_PROFILE_ROUNDS} rounds in blocks of {SCAN_PROFILE_BLOCK}, not "
              f"this run) {traced}")
        if traced != {name: float(n) for name, n in per_round.items()}:
            raise AssertionError(f"{label}: the child's trace shows {traced} launches per "
                                 f"replayed round, want {per_round}")
    return counts, params, ledger


@contextlib.contextmanager
def scan_census(records: list, out_dir, cell: str):
    """Within the block, every scan run's ``_ScanRounds`` appends to
    ``records``: the wrappers' counts in its eager warm-up round
    (``eager``) and in its capture (``captured``), its graph's kernel nodes
    by :data:`TRACE_KERNELS` name and in all (``nodes``,
    ``kernel_nodes``, from the graph's DOT dump, written to ``out_dir`` when
    given) and, at the end, its ``replays``."""
    from repro_torch.sim import driver

    base = driver._ScanRounds

    class Counted(base):
        def step(self):
            if self.graph is None and self.stream is not None:
                self.census = {"start": read_counts()}
                records.append(self.census)
            super().step()
            if self.graph is not None:
                self.census["replays"] = self.replays

        def _capture(self):
            import torch

            before = read_counts()
            # kept past the capture, so that it can be dumped; instantiated
            # here, as the driver's graph is at the capture's end
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            graph.enable_debug_mode()
            with torch.cuda.graph(graph, stream=self.stream):
                self._body()
            graph.instantiate()
            after = read_counts()
            with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
                # torch announces every dump by a warning
                warnings.simplefilter("ignore", UserWarning)
                path = Path(tmp) / "round.dot"
                graph.debug_dump(str(path))
                dot = path.read_text()
            if out_dir is not None:
                (out_dir / f"chip_smoke_graph_{cell}.dot").write_text(dot)
            nodes = graph_kernel_nodes(dot)
            start = self.census.pop("start")
            self.census.update(
                eager={k: before[k] - start[k] for k in before},
                captured={k: after[k] - before[k] for k in after}, **nodes)
            return graph

    driver._ScanRounds = Counted
    try:
        yield records
    finally:
        driver._ScanRounds = base


def graph_kernel_nodes(dot: str) -> dict:
    """``{"nodes": {name: kernel nodes}, "kernel_nodes": n, "sample": text}``
    and ``"nodes_total"`` of a CUDA graph's DOT dump
    (``cudaGraphDebugDotPrint``, verbose): the text is cut at each node's
    definition and a kernel node counts once for the first
    :data:`TRACE_KERNELS` pattern its label matches (the labels escape
    ``<`` and ``>``; the escapes are dropped first)."""
    import re

    # a node's definition starts a line; an edge's target is followed by
    # " [" too, mid-line
    chunks = re.split(r'(?m)^(?="graph_\d+_node_\d+"\[)', dot.replace("\\", ""))[1:]
    kernels = [c for c in chunks if "KERNEL" in c]
    nodes = {name: 0 for name in TRACE_KERNELS}
    for c in kernels:
        for name, pat in TRACE_KERNELS.items():
            if re.search(pat, c):
                nodes[name] += 1
                break
    return {"nodes": nodes, "kernel_nodes": len(kernels), "nodes_total": len(chunks),
            "sample": next((c[:600] for c in kernels if "fused" in c or "masked" in c),
                           kernels[0][:600] if kernels else dot[:600])}


def scan_launches(label, counts, census, rounds) -> dict:
    """The device launches of a scan run from its census (one
    ``_ScanRounds``): each kernel's eager launches plus its graph nodes
    times the replays.  Fails unless the wrappers' counts are the eager
    round's and the capture's, each wrapper call in the capture is one node
    of its kernel, and every round after the first is a replay."""
    if len(census) != 1 or "nodes" not in census[0]:
        raise AssertionError(f"{label}: {len(census)} captured graphs in the run, want 1")
    c = census[0]
    print(f"path {label}: the graph: {c['nodes_total']} nodes, {c['kernel_nodes']} kernel "
          f"nodes, of them {c['nodes']}; replays {c['replays']}; the wrappers' calls in the "
          f"eager round { {k: v for k, v in c['eager'].items() if v} } and in the capture "
          f"{ {k: v for k, v in c['captured'].items() if v} }")
    for name, n in counts.items():
        if n != c["eager"][name] + c["captured"][name]:
            raise AssertionError(f"{label}: {name}: {n} wrapper calls, not the eager round's "
                                 f"and the capture's")
        nodes = c["nodes"].get(name)
        if nodes is None and c["captured"][name]:
            raise AssertionError(f"{label}: {name} was captured, and its nodes have no pattern")
        if nodes is not None and nodes != c["captured"][name]:
            raise AssertionError(f"{label}: {name}: {c['captured'][name]} wrapper calls in the "
                                 f"capture but {nodes} kernel nodes in the graph; a kernel "
                                 f"node of the dump: {c['sample']!r}")
    if c["replays"] != rounds - 1:
        raise AssertionError(f"{label}: {c['replays']} replays of {rounds} rounds, want "
                             f"{rounds - 1}")
    launches = {name: c["eager"][name] + c["nodes"].get(name, 0) * c["replays"]
                for name in counts}
    print(f"path {label}: device launches in this run (eager round + graph nodes x replays) "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def timing_free(doc: dict) -> dict:
    """A ledger document without its timing fields and its mode's own
    workload keys (``rounds_per_scan``, ``pool_bytes``)."""
    doc = json.loads(json.dumps(doc))
    doc["metrics"].pop("wall_ms")
    for key in ("mode", "wall_s", "rounds_per_sec"):
        doc.pop(key)
    for key in ("rounds_per_scan", "pool_bytes"):
        doc["workload"].pop(key, None)
    return doc


def same_run(torch, what, a, b) -> None:
    """Two runs' masks, every ledger series but ``wall_ms`` (losses, bits,
    alpha, gamma, the eval curve ...) and parameters, bitwise."""
    from repro_torch.kernels.ops import tree_leaves

    (pa, la), (pb, lb) = a, b
    ma, mb = (l.to_json()["metrics"] for l in (la, lb))
    differ = [k for k in ma if k != "wall_ms" and ma[k] != mb[k]]
    same = (not differ and len(la.masks) == len(lb.masks)
            and all(bool((x == y).all()) for x, y in zip(la.masks, lb.masks))
            and all(torch.equal(x, y) for x, y in zip(tree_leaves(pa), tree_leaves(pb))))
    if not same:
        raise AssertionError(f"{what}: the runs differ (ledger series {differ})")
    print(f"path {what}: masks, the ledger minus wall_ms and parameters bitwise equal over "
          f"{len(la.masks)} rounds")


def charlm_scenario(backend="jnp"):
    """The paper's Shakespeare cell at the registry's full width (pool 240,
    cohort 32, m = 2, R = 6, batch 8, sequence 5, hidden 64; D = 60,630),
    optionally with the Eq. 2 aggregate on kernel 1."""
    from repro_torch.sim.scenarios import get_scenario

    sc = get_scenario(CHARLM_CELL)
    if backend == "jnp":
        return sc
    return sc.with_(name=f"{CHARLM_CELL}+pallas",
                    fl=dataclasses.replace(sc.fl, agg_backend="pallas"))


def charlm_kernel_check(torch, dev, flush):
    """Kernel 1 on the charlm path's matrix: the (32, 60,630) client-major
    update matrix of a full-width cohort (60,630 is not a multiple of 4, so
    ``ops`` pads it to 60,632), against its plain version, and timed beside
    it.  Returns the keys added to kernel 1's entry of the kernel line."""
    import numpy as np

    from repro_torch import rng as trng
    from repro_torch.fl.engine import RoundEngine
    from repro_torch.kernels import masked_aggregate as ma
    from repro_torch.kernels import ops

    sc = charlm_scenario("pallas")
    ds = sc.build_dataset()
    init_fn, loss_fn, _ = sc.build_model(ds)
    engine = RoundEngine(loss_fn, sc.fl)
    params = init_fn(trng.fold_in(trng.PRNGKey(sc.seed, device=dev), 1))
    gen = np.random.default_rng(sc.seed)
    clients = gen.choice(ds.n_clients, size=sc.fl.n_clients, replace=False)
    batch = ds.sample_round_batches(gen, clients, sc.fl.local_steps, sc.batch_size)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    flat = ops.tree_to_client_matrix(engine._batched_update(params, batch)[0])
    c, d = flat.shape
    if (c, d) != (32, CHARLM_DIM):
        raise AssertionError(f"charlm update matrix {tuple(flat.shape)}, want (32, {CHARLM_DIM})")
    g = torch.Generator(device="cpu").manual_seed(19)
    s = (torch.rand((c,), generator=g) * (torch.rand((c,), generator=g) < 0.5)).to(dev)
    got = ops.masked_scale_aggregate(flat, s)
    want = ma.masked_scale_aggregate_ref(flat, s)
    torch.cuda.synchronize()
    max_err = check_close("masked_scale_aggregate charlm shape", got, want, flat, s, RTOL, ATOL)
    upad = torch.nn.functional.pad(flat, (0, (-d) % ma.TILE)).contiguous()
    ops_ms = time_ms(lambda: ops.masked_scale_aggregate(flat, s), torch, flush)
    kernel_ms = time_ms(lambda: ma.masked_scale_aggregate_cuda(upad, s), torch, flush)
    plain_ms = time_ms(lambda: ma.masked_scale_aggregate_ref(flat, s), torch, flush)
    library_ms = time_ms(lambda: torch.matmul(s, flat), torch, flush)
    nbytes = (c * d + c + d) * 4
    bound_ms, bound_by = bound(nbytes, 2 * c * d)
    print(f"kernel charlm shape ({c}, {d}) f32 (ops pads to {tuple(upad.shape)}): max abs err "
          f"{max_err} (rtol {RTOL}, atol {ATOL}); ops call {ops_ms} ms, kernel on the padded "
          f"matrix {kernel_ms} ms, plain {plain_ms} ms, torch.matmul {library_ms} ms, bound "
          f"{bound_ms} ms ({bound_by}); {card_line()}")
    return {"charlm_shape": [c, d], "charlm_max_abs_err": max_err, "charlm_ops_ms": ops_ms,
            "charlm_ms": kernel_ms, "charlm_plain_ms": plain_ms,
            "charlm_library_ms": library_ms, "charlm_bound_ms": bound_ms}


def server_opt_phase(torch, dev):
    """A server optimizer (sgd with momentum 0.9, and adam) through the vmap
    and scan engines on the card, on the workload of the reference's
    ``test_engine_matrix_parity_server_opt`` (8 clients, the optimal sampler,
    3 rounds): every engine x backend x cache regime ends at the first's
    parameters within atol 1e-5, with the same masks."""
    import numpy as np

    from repro_torch import rng as trng
    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.engine import RoundEngine
    from repro_torch.fl.round import client_weights
    from repro_torch.kernels.ops import tree_leaves
    from repro_torch.models.simple import mlp_classifier
    from repro_torch.optim import adam, sgd

    init, loss, _ = mlp_classifier(12, 3, hidden=8)
    gen = np.random.default_rng(1)
    batch = {"x": torch.as_tensor(gen.normal(size=(8, 2, 4, 12)).astype("float32"), device=dev),
             "y": torch.as_tensor(gen.integers(0, 3, (8, 2, 4)).astype("int32"), device=dev)}
    fl = FLConfig(n_clients=8, expected_clients=3, sampler="optimal", local_steps=2,
                  lr_local=0.1)
    combos = [("vmap", be, None) for be in ("jnp", "pallas")] + [
        ("scan", be, cg) for be in ("jnp", "pallas") for cg in (None, 0, 1)]
    w = client_weights(fl, device=dev)
    key = trng.PRNGKey(11, device=dev)
    for opt_name, make in (("sgd(0.5, momentum=0.9)", lambda: sgd(0.5, momentum=0.9)),
                           ("adam(0.01)", lambda: adam(0.01))):
        finals, masks, err = [], [], 0.0
        for mem, be, cg in combos:
            opt = make()
            step = RoundEngine(loss, fl, opt, memory=mem, backend=be, scan_group=2,
                               cache_groups=cg, device=dev).make_step()
            params = init(trng.PRNGKey(0, device=dev))
            state = opt.init(params)
            run_masks = []
            for k in range(SERVER_OPT_ROUNDS):
                params, state, m = step(params, state, batch, w, trng.fold_in(key, k))
                run_masks.append(m.mask.cpu())
            finals.append(tree_leaves(params))
            masks.append(run_masks)
        for combo, leaves, run_masks in zip(combos[1:], finals[1:], masks[1:]):
            if not all(torch.equal(a, b) for a, b in zip(run_masks, masks[0])):
                raise AssertionError(f"server optimizer {opt_name}: {combo} draws other masks")
            for a, b in zip(finals[0], leaves):
                if a.device != b.device or a.device.type != dev.type:
                    raise AssertionError(f"server optimizer {opt_name}: a leaf left {dev}")
                err = max(err, float((a - b).abs().max()))
        if err > SERVER_OPT_ATOL:
            raise AssertionError(f"server optimizer {opt_name}: finals differ by {err} "
                                 f"(atol {SERVER_OPT_ATOL})")
        print(f"server optimizer {opt_name}: vmap and scan x jnp and pallas x cache regimes "
              f"({len(combos)} engines, {SERVER_OPT_ROUNDS} rounds on the card): masks equal, "
              f"final parameters within {err} of vmap+jnp's (atol {SERVER_OPT_ATOL})")


# device kernels by name (the demangled templates of csrc/norm_aggregate.cu
# and csrc/masked_aggregate.cu, kind 0 is "none", 1 rand-k, as the profiler
# names them; and as a CUDA graph's DOT dump may, mangled)
TRACE_KERNELS = {
    "norm_scale_aggregate": r"fused_kernel(<float, 0,|IfLi0E)",
    "compress_norm_scale_aggregate": r"fused_kernel(<float, 1,|IfLi1E)",
    "masked_scale_aggregate": r"masked_scale_aggregate_kernel(<float>|IfE)",
}


def mode_profile(torch, dev) -> dict:
    """The main path and the charlm cell in the three driver modes (and
    charlm with kernel 1 on its aggregate in scan mode) under torch.profiler:
    host and prefetch ``SYNC_ROUNDS`` rounds, scan ``SCAN_PROFILE_ROUNDS`` in
    blocks of ``SCAN_PROFILE_BLOCK``.  A run's window opens at the end of
    its first sync (the first round, or the first block) and closes at its
    last: per round in it, the host's ``cudaGraphLaunch`` calls and the
    runtime calls that wait for the device (``SYNC_CALLS``) up to the last
    sync's start, and the device ops and the launches of kernels 1, 3 and 4
    by name between two marker kernels (``torch.cuda._sleep``), one where
    the window opens and one after each sync: the device's clock is not the
    host's, so the device side is cut by markers in stream order; the
    window's device busy time and idle share.  A window that lost a marker
    is run again (up to 3 times).  Then a few prefetch rounds under
    ``torch.cuda.set_sync_debug_mode('warn')``, whose warnings name the lines
    that synchronise.  Run in a process of its own."""
    import re

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.sim import driver

    sync = driver._sync
    torch.backends.cuda.matmul.allow_tf32 = False

    def window(ds, init_fn, loss_fn, sc, mode, rounds):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        state = {"on": False}

        def marked_sync(d):
            if not state["on"]:
                sync(d)
                prof.start()
                state["on"] = True
                pad = torch.empty((1,), device=d)
                for _ in range(TRACE_TAIL // 16):
                    pad.zero_()
            else:
                with record_function("chip_smoke.sync"):
                    sync(d)
            torch.cuda._sleep(1)

        driver._sync = marked_sync
        try:
            ledger = driver.run_simulation(
                ds, init_fn, loss_fn, sc.fl, rounds, mode=mode,
                rounds_per_scan=SCAN_PROFILE_BLOCK, batch_size=sc.batch_size, seed=sc.seed)[1]
            # a tail of small kernels: the profiler lost the last device
            # events of a window (the last round's, and the marker)
            pad = torch.empty((1,), device=dev)
            for _ in range(TRACE_TAIL):
                pad.zero_()
            torch.cuda.synchronize(dev)
        finally:
            driver._sync = sync
            if state["on"]:
                prof.stop()
        return prof.events(), ledger

    out = {}
    cells = ((main_scenario(), ("host", "prefetch", "scan")),
             (charlm_scenario(), ("host", "prefetch", "scan")),
             (charlm_scenario("pallas"), ("scan",)))
    for sc, modes in cells:
        ds = sc.build_dataset()
        init_fn, loss_fn, _ = sc.build_model(ds)
        for mode in modes:
            rounds = SCAN_PROFILE_ROUNDS if mode == "scan" else SYNC_ROUNDS
            first = min(SCAN_PROFILE_BLOCK, rounds) if mode == "scan" else 1
            # host mode syncs after every round, the others after the first
            # round (block) only; each run ends in a sync
            syncs = rounds - first + 1 if mode == "host" else 1
            for attempt in range(3):
                events, ledger = window(ds, init_fn, loss_fn, sc, mode, rounds)
                on_card = [str(e.device_type).endswith("CUDA") for e in events]
                marks = sorted(e.time_range.start for e, c in zip(events, on_card)
                               if c and "spin_kernel" in e.name)
                if len(marks) == 1 + syncs:
                    break
            else:
                raise AssertionError(f"{sc.name} [{mode}]: 3 traces held {len(marks)} of the "
                                     f"{1 + syncs} marker kernels: they lost device events")
            host = [e for e, c in zip(events, on_card) if not c]
            # the run's last sync: the host's dispatches end where it starts;
            # on the device the rounds' work lies between the first marker
            # and the last (the ledger's reads follow it)
            last = max(e.time_range.start for e in host if e.name == "chip_smoke.sync")
            inside = [e.name for e in host if e.time_range.start < last]
            t0, t1 = marks[0], marks[-1]
            device = [e for e, c in zip(events, on_card)
                      if c and not e.name.startswith("chip_smoke.") and "spin_kernel" not in e.name
                      and t0 < e.time_range.start < t1]
            n = rounds - first
            launches = {k: sum(bool(re.search(pat, e.name)) for e in device) / n
                        for k, pat in TRACE_KERNELS.items()}
            out[f"{sc.name} [{mode}]"] = {
                "window_rounds": n, "traces": attempt + 1,
                "busy_ms": sum(e.time_range.elapsed_us() for e in device) / 1e3,
                "wall_ms": (t1 - t0) / 1e3,
                "device_ops_per_round": len(device) / n,
                "graph_launches_per_round": inside.count("cudaGraphLaunch") / n,
                "sync_calls": {c: inside.count(c) for c in SYNC_CALLS},
                "memcpy_async_calls": inside.count("cudaMemcpyAsync"),
                "stream_wait_calls": inside.count("cudaStreamWaitEvent"),
                "launches": {k: v for k, v in launches.items() if v},
                "rounds_per_sec": ledger.rounds_per_sec,
            }
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sc = main_scenario()
            ds = sc.build_dataset()
            init_fn, loss_fn, _ = sc.build_model(ds)
            driver.run_simulation(ds, init_fn, loss_fn, sc.fl, 4, mode="prefetch",
                                  batch_size=sc.batch_size, seed=sc.seed)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["sync_debug_warnings"] = sorted({f"{Path(w.filename).name}:{w.lineno}: "
                                         f"{str(w.message)[:80]}" for w in caught})
    return out


def mode_profile_report() -> dict:
    """Print :func:`mode_profile` (run once, in a child) and fail unless no
    call waits for the device between two prefetch round dispatches or
    within and between scan blocks, and each replayed scan round is one
    ``cudaGraphLaunch``.  Returns ``{"launches": {cell: {kernel: device
    launches per replayed round in the child's scan run}}, "profile": the
    child's JSON}``."""
    if "modes_report" in _PROFILES:
        return _PROFILES["modes_report"]
    prof = profile_in_child("modes")
    launches = {}
    for name, res in prof.items():
        if name == "sync_debug_warnings":
            continue
        idle = 1 - res["busy_ms"] / res["wall_ms"] if res["wall_ms"] else float("nan")
        waits = sum(res["sync_calls"].values())
        print(f"profile {name}: {res['window_rounds']} rounds after the first sync (a young "
              f"process, trace {res['traces']} of 3): device ops per round "
              f"{res['device_ops_per_round']}; cudaGraphLaunch per round "
              f"{res['graph_launches_per_round']}; device busy {res['busy_ms']} ms of "
              f"{res['wall_ms']} ms, idle share {idle} (under the profiler); kernel launches "
              f"per round {res['launches']}; calls that wait for the device {res['sync_calls']} "
              f"(total {waits}); cudaMemcpyAsync {res['memcpy_async_calls']}, "
              f"cudaStreamWaitEvent {res['stream_wait_calls']}; {card_line()}")
        if name.endswith("[host]"):
            continue
        if res["device_ops_per_round"] == 0:
            raise AssertionError(f"{name}: the profiler saw no device op of the window's rounds")
        if waits:
            raise AssertionError(f"{name}: {waits} calls wait for the device between two round "
                                 f"dispatches: {res['sync_calls']}; set_sync_debug_mode "
                                 f"warnings: {prof['sync_debug_warnings']}")
        if not name.endswith("[scan]"):
            continue
        if res["graph_launches_per_round"] != 1:
            raise AssertionError(f"{name}: {res['graph_launches_per_round']} cudaGraphLaunch "
                                 f"per round, want 1")
        cell = name[:-len(" [scan]")]
        host = prof.get(f"{cell} [host]")
        if host is not None:
            print(f"profile {cell}: device ops per round, scan minus host "
                  f"{res['device_ops_per_round'] - host['device_ops_per_round']}")
        launches[cell] = res["launches"]
    print(f"profile: set_sync_debug_mode('warn') over 4 prefetch rounds of the main path "
          f"(the first round's sync, the run's last sync and the ledger's reads included): "
          f"{prof['sync_debug_warnings']}")
    _PROFILES["modes_report"] = {"launches": launches, "profile": prof}
    return _PROFILES["modes_report"]


def charlm_eval_phase(torch):
    """The charlm cell at full width with its accuracy on the eval grid
    (``eval_every=CHARLM_EVAL_EVERY``, a held-out charlm pool), under
    prefetch and under scan (blocks of ``CHARLM_SCAN_BLOCK``, shrunk to end
    on the grid): the same ``acc_rounds``, and the ledger (the eval curve
    included) minus timing and the parameters bitwise equal."""
    import numpy as np

    from repro_torch.data import charlm
    from repro_torch.sim.driver import run_simulation

    sc = charlm_scenario()
    ds = sc.build_dataset()
    init_fn, loss_fn, acc_fn = sc.build_model(ds)
    held = charlm(n_clients=8, seed=999)
    ev = {k: np.concatenate([c[k] for c in held.client_data])[:512]
          for k in held.client_data[0]}
    runs = {mode: run_simulation(ds, init_fn, loss_fn, sc.fl, CHARLM_ROUNDS, mode=mode,
                                 rounds_per_scan=CHARLM_SCAN_BLOCK, batch_size=sc.batch_size,
                                 seed=sc.seed, eval_fn=acc_fn, eval_batch=ev,
                                 eval_every=CHARLM_EVAL_EVERY)
            for mode in ("prefetch", "scan")}
    grid = [k for k in range(CHARLM_ROUNDS)
            if k % CHARLM_EVAL_EVERY == 0 or k == CHARLM_ROUNDS - 1]
    (_, lp), (_, ls) = runs["prefetch"], runs["scan"]
    if not lp.acc_rounds == ls.acc_rounds == grid:
        raise AssertionError(f"charlm eval grid: prefetch {lp.acc_rounds}, scan {ls.acc_rounds}, "
                             f"want {grid}")
    same_run(torch, f"{CHARLM_CELL} with eval: scan vs prefetch", runs["scan"], runs["prefetch"])
    print(f"path {CHARLM_CELL} with eval: acc at rounds {ls.acc_rounds}: {ls.acc}; scan "
          f"{ls.rounds_per_sec} vs prefetch {lp.rounds_per_sec} rounds/s")


def _mesh4_rank(mesh, rounds):
    """One of the ranks that share the card: the shard-randk cell at full
    width, with the shapes its sharded compress kernel receives."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sim.driver import run_scenario
    from repro_torch.sim.pool import ClientPool
    from repro_torch.sim.scenarios import get_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = []
    kernel = ops.sharded_compress_aggregate_cuda

    def recorded(u, *rest):
        shapes.append(tuple(u.shape))
        return kernel(u, *rest)

    ops.sharded_compress_aggregate_cuda = recorded
    reset_counts()
    params, ledger = run_scenario(SHARD_RANDK_CELL, rounds=rounds, mesh=mesh, mode="host")
    counts, host_shapes = read_counts(), list(shapes)
    # the prefetch leg: the sharded pool, each rank holding its rows
    reset_counts()
    pre_params, pre_ledger = run_scenario(SHARD_RANDK_CELL, rounds=rounds, mesh=mesh,
                                          mode="prefetch")
    pre_counts = read_counts()
    spool = ClientPool(get_scenario(SHARD_RANDK_CELL).build_dataset(), mesh=mesh)
    return {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device),
            "counts": counts, "shapes": host_shapes,
            "params": {k: v.cpu() for k, v in params.items()},
            "doc": ledger.to_json(include_masks=True),
            "prefetch_counts": pre_counts,
            "prefetch_params": {k: v.cpu() for k, v in pre_params.items()},
            "prefetch_doc": pre_ledger.to_json(include_masks=True),
            "pool_local_bytes": sum(b.numel() * b.element_size()
                                    for b in spool.buffers.values()),
            "pool_nbytes": spool.nbytes}


def mesh4_phase(torch, out_dir):
    """``femnist1-fedavg-aocs-shard-randk`` on MESH4_RANKS gloo ranks sharing
    the one card, against the world-size-1 run of the same rounds; then the
    same ranks under prefetch from the sharded pool (each rank a quarter of
    its rows), bitwise their host leg."""
    from repro_torch.fl.mesh import spawn_mesh
    from repro_torch.sim.driver import run_scenario, validate_ledger

    ref_params, ref_ledger = run_scenario(SHARD_RANDK_CELL, rounds=MESH4_ROUNDS, mode="host")
    t0 = time.perf_counter()
    ranks = spawn_mesh(_mesh4_rank, MESH4_RANKS, "gloo", MESH4_TIMEOUT_S, device="cuda:0",
                       args=(MESH4_ROUNDS,))
    secs = time.perf_counter() - t0
    k = 32 // MESH4_RANKS
    doc0 = ranks[0]["doc"]
    validate_ledger(doc0)
    for r in ranks:
        want = {name: 0 for name in r["counts"]}
        want["sharded_compress_aggregate"] = MESH4_ROUNDS
        if (r["counts"] != want or r["prefetch_counts"] != want or r["backend"] != "gloo"
                or r["device"] != "cuda:0"):
            raise AssertionError(f"rank {r['rank']}: launches {r['counts']} on {r['backend']} "
                                 f"{r['device']}, want {want} on gloo cuda:0")
        if len(r["shapes"]) != MESH4_ROUNDS or set(r["shapes"]) != {(k, 58430)}:
            raise AssertionError(f"rank {r['rank']}: kernel shapes {r['shapes']}, want the "
                                 f"unpadded ({k}, 58430)")
        if r["doc"] != doc0:
            raise AssertionError(f"rank {r['rank']}: its ledger differs from rank 0's")
        if timing_free(r["prefetch_doc"]) != timing_free(r["doc"]) or not all(
                torch.equal(p, r["params"][name]) for name, p in r["prefetch_params"].items()):
            raise AssertionError(f"rank {r['rank']}: the prefetch leg differs from the host leg")
        if (4 * r["pool_local_bytes"] != r["pool_nbytes"]
                or r["prefetch_doc"]["workload"]["pool_bytes"] != r["pool_nbytes"]):
            raise AssertionError(f"rank {r['rank']}: pool bytes {r['pool_local_bytes']} of "
                                 f"{r['pool_nbytes']}, want a quarter")
        for name, p in r["params"].items():
            if not torch.equal(p, ranks[0]["params"][name]):
                raise AssertionError(f"rank {r['rank']}: parameter {name} differs from rank 0's")
    if doc0["workload"]["mesh_axis_size"] != MESH4_RANKS:
        raise AssertionError(f"unexpected workload {doc0['workload']}")
    if not all(_finite(x) for x in doc0["metrics"]["loss"]):
        raise AssertionError(f"bad loss series {doc0['metrics']['loss']}")
    ref_masks = [[int(v) for v in m] for m in ref_ledger.masks]
    if doc0["masks"][0] != ref_masks[0]:
        raise AssertionError("4 ranks: the first round's mask differs from the world-size-1 run's")
    later = sum(a != b for a, b in zip(doc0["masks"][1:], ref_masks[1:]))
    err = max(float((ranks[0]["params"][n] - ref_params[n].cpu()).abs().max())
              for n in ref_params)
    print(f"mesh 4 ranks sharing one card (gloo, every rank on cuda:0): {SHARD_RANDK_CELL} "
          f"at full width, {MESH4_ROUNDS} rounds in {secs:.1f} s with the ranks' start; each "
          f"rank launched sharded_compress_aggregate once per round at {ranks[0]['shapes'][0]} "
          f"(unpadded); ledgers, masks and parameters equal across the ranks; the first "
          f"round's mask equals the world-size-1 run's; later rounds whose mask differs from "
          f"it: {later} of {MESH4_ROUNDS - 1}; max |param - world-size-1 param| after the last "
          f"round {err}")
    if err > 1e-5:
        raise AssertionError(f"4 ranks: parameters {err} from the world-size-1 run's (atol 1e-5)")
    walls = doc0["metrics"]["wall_ms"][1:]
    print(f"mesh 4 ranks sharing one card timing (not a multi-GPU figure): "
          f"{doc0['rounds_per_sec']} rounds/s after the first round; per-round ms (slowest "
          f"rank) median {statistics.median(walls)}, min {min(walls)}, max {max(walls)}; "
          f"set-up (first round) {doc0['metrics']['wall_ms'][0]} ms; world size 1 on the "
          f"same card: median {statistics.median(ref_ledger.wall_ms[1:])} ms")
    pre0 = ranks[0]["prefetch_doc"]
    print(f"mesh 4 ranks, prefetch from the sharded pool: every rank's ledger minus timing "
          f"and parameters bitwise its host leg's; each rank holds "
          f"{ranks[0]['pool_local_bytes']} of the pool's {ranks[0]['pool_nbytes']} bytes; "
          f"{pre0['rounds_per_sec']} rounds/s after the first round, median "
          f"{statistics.median(pre0['metrics']['wall_ms'][1:])} ms per round (slowest rank)")
    if out_dir is not None:
        (out_dir / f"chip_smoke_ledger_{SHARD_RANDK_CELL}_4ranks.json").write_text(
            json.dumps(doc0, indent=1))


def norms_phase(torch):
    """The kernel-backed norms ``ops.tree_client_norms`` (Alg. 1 line 3) of
    full-width cohorts' updates, against the eager ``ocs.client_norms``."""
    import numpy as np

    from repro_torch import rng as trng
    from repro_torch.core import ocs
    from repro_torch.fl.engine import RoundEngine
    from repro_torch.fl.round import client_weights
    from repro_torch.kernels import ops

    sc = main_scenario()
    ds = sc.build_dataset()
    init_fn, loss_fn, _ = sc.build_model(ds)
    engine = RoundEngine(loss_fn, sc.fl)
    dev = engine.device
    params = init_fn(trng.fold_in(trng.PRNGKey(sc.seed, device=dev), 1))
    weights = client_weights(sc.fl, device=dev)
    gen = np.random.default_rng(sc.seed)
    cohorts = []
    for _ in range(NORM_COHORTS):
        clients = gen.choice(ds.n_clients, size=sc.fl.n_clients, replace=False)
        batch = ds.sample_round_batches(gen, clients, sc.fl.local_steps, sc.batch_size)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        cohorts.append(engine._batched_update(params, batch)[0])
    reset_counts()
    got = [ops.tree_client_norms(upd, weights) for upd in cohorts]
    counts = read_counts()
    if counts != {**{k: 0 for k in counts}, "client_sqnorms": NORM_COHORTS}:
        raise AssertionError(f"tree_client_norms launches {counts}")
    for upd, u in zip(cohorts, got):
        want = ocs.client_norms(upd, weights)
        if not bool(((u - want).abs() <= RTOL * want.abs()).all()):
            raise AssertionError(f"tree_client_norms {u} vs client_norms {want}")
    print(f"norms: ops.tree_client_norms of {NORM_COHORTS} full-width cohorts "
          f"({sc.fl.n_clients} x 58430) matches ocs.client_norms (rtol {RTOL}); "
          f"{counts['client_sqnorms']} launches")
    return counts


def profile_phase(torch, sc, out_dir):
    """Where a full-width round's time goes: device busy time by kernel
    against the rounds' wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim.driver import build_client_mesh, run_simulation

    ds = sc.build_dataset()
    init_fn, loss_fn, _ = sc.build_model(ds)
    mesh = build_client_mesh(sc.fl) if sc.sharded else None

    def run(rounds):
        return run_simulation(ds, init_fn, loss_fn, sc.fl, rounds, mode="host",
                              batch_size=sc.batch_size, seed=sc.seed, mesh=mesh)[1]

    try:
        run(2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ledger = run(PROFILE_ROUNDS)
    finally:
        if mesh is not None:
            mesh.close()
    wall = sum(ledger.wall_ms)
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if not busy:
        print(f"profile {sc.name}: the profiler recorded no device time (not measured)")
        return
    n_ops = sum(r[2] for r in rows)
    print(f"profile {sc.name}: {PROFILE_ROUNDS} rounds under the profiler, rounds' wall "
          f"{wall} ms, device busy {busy} ms, idle share {1 - busy / wall}; {n_ops} device "
          f"ops ({n_ops / PROFILE_ROUNDS} per round)")
    for key, ms, count in rows[:12]:
        print(f"profile:   {ms:10.3f} ms  {count:6d}x  {key[:90]}")
    if out_dir is not None:
        prof.export_chrome_trace(str(out_dir / f"chip_smoke_trace_{sc.name}.json.gz"))


class Laps:
    """Host-clock ms per named layer, each lap ending in a device sync."""

    def __init__(self, torch):
        self.torch = torch
        self.rounds = []

    def new_round(self):
        self.rounds.append(defaultdict(float))
        self.t = time.perf_counter()

    def lap(self, name):
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        self.rounds[-1][name] += (t - self.t) * 1e3
        self.t = t

    def report(self, label):
        total = 0.0
        for name in self.rounds[-1]:
            med = statistics.median(r[name] for r in self.rounds[1:])
            total += med
            print(f"breakdown {label}: {med:9.3f} ms  {name}")
        print(f"breakdown {label}: {total:9.3f} ms  sum of medians over "
              f"{len(self.rounds) - 1} rounds")


def _round_inputs(ds, sc, gen, torch, dev, laps):
    clients = gen.choice(ds.n_clients, size=sc.fl.n_clients, replace=False)
    batch = ds.sample_round_batches(gen, clients, sc.fl.local_steps, sc.batch_size)
    laps.lap("data: numpy batch assembly")
    batch = {bk: torch.as_tensor(v, device=dev) for bk, v in batch.items()}
    laps.lap("data: upload (pageable copy)")
    return batch


def breakdown_phase(torch):
    """Host-clock ms of each layer of a first-slice full-width round, with a
    device sync after each, so every layer's time includes its device work
    (median over rounds after the first).  The layers are called as the round
    step calls them; the step itself does not sync between them, so the sum
    exceeds a round's wall time by the syncs."""
    import numpy as np

    from repro_torch import rng as trng
    from repro_torch.core import ocs
    from repro_torch.fl.engine import RoundEngine
    from repro_torch.fl.round import client_weights
    from repro_torch.sim.scenarios import get_scenario

    sc = get_scenario(SLICE1_CELL)
    fl = sc.fl
    ds = sc.build_dataset()
    init_fn, loss_fn, _ = sc.build_model(ds)
    engine = RoundEngine(loss_fn, fl)
    dev = engine.device
    key = trng.PRNGKey(sc.seed, device=dev)
    params = init_fn(trng.fold_in(key, 1))
    weights = client_weights(fl, device=dev)
    gen = np.random.default_rng(sc.seed)
    laps = Laps(torch)
    for k in range(BREAKDOWN_ROUNDS):
        laps.new_round()
        batch = _round_inputs(ds, sc, gen, torch, dev, laps)
        k_sample, _ = trng.split(trng.fold_in(key, 1000 + k))
        laps.lap("keys: fold_in + split")
        updates, losses = engine._batched_update(params, batch)
        laps.lap("local update (vmap of grad, R steps)")
        u = ocs.client_norms(updates, weights)
        laps.lap("norms")
        plan = engine._plan(u, weights, k_sample)
        laps.lap("plan: probabilities + mask + alpha/gamma")
        aggregate = ocs.aggregate_updates(updates, plan.scale, backend=engine.backend)
        laps.lap("aggregate (tree -> matrix, pad, kernel, split)")
        params, _ = engine._apply_server(params, (), aggregate)
        laps.lap("server step")
    laps.report(SLICE1_CELL)


def scan_breakdown_phase(torch):
    """The same for the main path's scan round: every group's local update,
    compression material, norms, the plan, and the post-plan aggregate of
    the cached groups (fused norm+aggregate kernel) and of the spilled ones
    (recompute, material, fused compress+norm+aggregate kernel)."""
    import numpy as np

    from repro_torch import rng as trng
    from repro_torch.core import ocs
    from repro_torch.fl.engine import (
        RoundEngine,
        client_apply_compression,
        client_compression_material,
    )
    from repro_torch.fl.round import client_weights
    from repro_torch.kernels import ops, update_cache

    sc = main_scenario()
    fl = sc.fl
    ds = sc.build_dataset()
    init_fn, loss_fn, _ = sc.build_model(ds)
    engine = RoundEngine(loss_fn, fl)
    dev = engine.device
    n, g = fl.n_clients, engine.scan_group
    n_groups = n // g
    n_cached = update_cache.num_slots(engine.cache_groups, n_groups)
    key = trng.PRNGKey(sc.seed, device=dev)
    params = init_fn(trng.fold_in(key, 1))
    weights = client_weights(fl, device=dev)
    gen = np.random.default_rng(sc.seed)
    laps = Laps(torch)
    for k in range(BREAKDOWN_ROUNDS):
        laps.new_round()
        batch = _round_inputs(ds, sc, gen, torch, dev, laps)
        k_sample, k_comp = trng.split(trng.fold_in(key, 1000 + k))
        comp_keys = trng.split(k_comp, n)
        laps.lap("keys: fold_in + split + per-client split")
        dim = sum(p.numel() for p in params.values())
        cache = torch.empty((n_cached, g, dim), device=dev)
        norms = []
        for j in range(n_groups):
            gb = {bk: v[j * g:(j + 1) * g] for bk, v in batch.items()}
            upd, _ = engine._batched_update(params, gb)
            laps.lap(f"pass 1: local update ({n_groups} groups)")
            mats = client_compression_material(upd, comp_keys[j * g:(j + 1) * g], fl)
            laps.lap("compress/material: threefry (pass 1)")
            upd = client_apply_compression(upd, mats, fl)
            laps.lap("compress/material: apply (pass 1)")
            norms.append(ocs.client_norms(upd, weights[j * g:(j + 1) * g]))
            laps.lap("norms (pass 1)")
            if j < n_cached:
                ops.tree_to_client_matrix(upd, out=cache[j])
                laps.lap("cache fill")
        plan = engine._plan(torch.cat(norms), weights, k_sample)
        laps.lap("plan: probabilities + mask + alpha/gamma")
        scale_g = plan.scale.reshape(n_groups, g)
        agg = torch.zeros((dim,), device=dev)
        for j in range(n_cached):
            agg = agg + update_cache.group_norm_aggregate(cache[j], scale_g[j], "pallas")[1]
        laps.lap("post-plan aggregate: cached groups (norm_scale_aggregate)")
        for j in range(n_cached, n_groups):
            gb = {bk: v[j * g:(j + 1) * g] for bk, v in batch.items()}
            upd, _ = engine._batched_update(params, gb)
            laps.lap("post-plan: spill recompute (local update)")
            mats = client_compression_material(upd, comp_keys[j * g:(j + 1) * g], fl)
            laps.lap("compress/material: threefry (spill)")
            flat = ops.tree_to_client_matrix(upd)
            mat_flats = tuple(ops.tree_to_client_matrix(m) for m in mats)
            laps.lap("post-plan aggregate: spill tree -> matrix")
            agg = agg + update_cache.group_compress_norm_aggregate(
                flat, scale_g[j], mat_flats, fl.compression, fl.compression_param,
                "pallas")[1]
            laps.lap("post-plan aggregate: spilled groups (compress_norm_scale_aggregate)")
        aggregate = ops.client_matrix_to_tree(agg, params, strip_client_axis=False)
        params, _ = engine._apply_server(params, (), aggregate)
        laps.lap("server step")
    laps.report(sc.name)


def shard_breakdown_phase(torch):
    """The same for the mesh round of ``femnist1-fedavg-aocs-shard-randk`` at
    world size 1 on NCCL: local update, material, norms, the all_gather, the
    plan, the sharded compress kernel, the all_reduce and the server step.
    The layers are those of ``fl/shard_round.py``'s round body, called one by
    one; the same rounds then run through the real round step
    (``make_engine(mesh=...)``) on the same batches and keys, and its
    parameters must equal the layered copy's bit for bit, so the copy cannot
    drift from the round it times."""
    import numpy as np
    from torch.func import vmap

    from repro_torch import rng as trng
    from repro_torch.core import ocs
    from repro_torch.fl.engine import (
        client_apply_compression,
        client_compression_material,
        make_engine,
        make_local_update,
    )
    from repro_torch.fl.round import client_weights
    from repro_torch.kernels import ops
    from repro_torch.sim.driver import build_client_mesh
    from repro_torch.sim.scenarios import get_scenario

    sc = get_scenario(SHARD_RANDK_CELL)
    fl = sc.fl
    ds = sc.build_dataset()
    init_fn, loss_fn, _ = sc.build_model(ds)
    mesh = build_client_mesh(fl)
    try:
        dev = mesh.device
        batched_update = vmap(make_local_update(loss_fn, fl), in_dims=(None, 0))
        key = trng.PRNGKey(sc.seed, device=dev)
        params0 = params = init_fn(trng.fold_in(key, 1))
        weights = client_weights(fl, device=dev)
        gen = np.random.default_rng(sc.seed)
        laps = Laps(torch)
        batches = []
        for k in range(BREAKDOWN_ROUNDS):
            laps.new_round()
            batch = _round_inputs(ds, sc, gen, torch, dev, laps)
            batches.append(batch)
            k_sample, k_comp = trng.split(trng.fold_in(key, 1000 + k))
            comp_keys = trng.split(k_comp, fl.n_clients)
            laps.lap("keys: fold_in + split + per-client split")
            updates, losses = batched_update(params, batch)
            laps.lap("local update (vmap of grad, R steps)")
            mats = client_compression_material(updates, comp_keys, fl)
            laps.lap("compress/material: threefry")
            sendables = client_apply_compression(updates, mats, fl)
            laps.lap("compress/material: apply")
            u = ocs.client_norms(sendables, weights)
            laps.lap("norms")
            u_all, w_all = mesh.all_gather(u), mesh.all_gather(weights)
            laps.lap("all_gather (norms, weights)")
            plan = ocs.sampling_plan(u_all, w_all, fl.cohort_target(), k_sample,
                                     sampler=fl.sampler, j_max=fl.j_max,
                                     availability=fl.availability)
            laps.lap("plan: probabilities + mask + alpha/gamma")
            flat = ops.tree_to_client_matrix(updates)
            mat_flats = tuple(ops.tree_to_client_matrix(m) for m in mats)
            laps.lap("aggregate: tree -> matrix")
            _, part = ops.shard_compress_aggregate(flat, plan.scale, mat_flats,
                                                   fl.compression, fl.compression_param)
            laps.lap("aggregate: kernel (sharded_compress_aggregate, one launch)")
            agg = mesh.all_reduce(part)
            laps.lap("all_reduce of the (D,) partial")
            aggregate = ops.client_matrix_to_tree(agg, params, strip_client_axis=False)
            params = {n: params[n] - fl.lr_global * aggregate[n].to(params[n].dtype)
                      for n in params}
            laps.lap("server step")
            mesh.pmean(torch.mean(losses))
            laps.lap("loss pmean")
        laps.report(f"{SHARD_RANDK_CELL} (world size 1, nccl)")
        round_step = make_engine(loss_fn, fl, mesh=mesh)
        real = params0
        for k, batch in enumerate(batches):
            real, _, _ = round_step(real, (), batch, weights, trng.fold_in(key, 1000 + k))
        for n in params:
            if not torch.equal(real[n], params[n]):
                raise AssertionError(
                    f"shard breakdown: the layered round's {n} differs from the "
                    f"round step's after {BREAKDOWN_ROUNDS} rounds")
        print(f"shard breakdown: the layered round's parameters equal the round "
              f"step's after {BREAKDOWN_ROUNDS} rounds (bitwise)")
    finally:
        mesh.close()


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the full-width ledgers and the profile traces")
    ap.add_argument("--profile", choices=("norm", "ssd", "modes"), default=None,
                    help="only print that profiler pass's JSON (the kernel phases run this)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.profile is not None:
        profile = {"norm": norm_profile, "ssd": ssd_profile,
                   "modes": mode_profile}[args.profile]
        print(json.dumps(profile(torch, dev)))
        return 0
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} visible")
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built) or 'nothing (cached)'}")
    for name, (secs, log) in built.items():
        print(f"build: {name}.cu in {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"build:   {line.strip()}")

    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    kernels = [kernel_phase(torch, dev, flush)] + norm_kernel_phase(torch, dev, flush)
    kernels += shard_kernel_phase(torch, dev, flush)
    kernels += [attention_kernel_phase(torch, dev, flush), ssd_kernel_phase(torch, dev, flush)]
    kernels[0].update(charlm_kernel_check(torch, dev, flush))
    del flush

    main_sc = main_scenario()
    print(f"path: the main path is the reference cell {MAIN_CELL} built with "
          f"Scenario.with_(fl=replace(fl, agg_backend='pallas', compression='randk', "
          f"compression_param=0.1)), the rand-k setting of {VMAP_CELL}: {main_sc.fl}")
    from repro_torch.fl.engine import RoundEngine

    engine = RoundEngine(main_sc.build_model(main_sc.build_dataset())[1], main_sc.fl)
    print(f"path {main_sc.name}: scan_group {engine.scan_group}, cache_groups "
          f"{engine.cache_groups}, local_update_evals {engine.local_update_evals} per round")
    main_per_round = {"norm_scale_aggregate": 4, "compress_norm_scale_aggregate": 4}
    counts, main_params, main_ledger = path_phase(torch, main_sc, PATH_ROUNDS, main_per_round,
                                                  args.out)
    # the reference's default driver mode on the same path: the pool on the
    # card, round k+1's gather dispatched before round k's step
    pre_counts, pre_params, pre_ledger = path_phase(torch, main_sc, PATH_ROUNDS,
                                                    main_per_round, args.out, mode="prefetch")
    same_run(torch, f"{main_sc.name}: prefetch vs host", (pre_params, pre_ledger),
             (main_params, main_ledger))
    print(f"path {main_sc.name}: host {main_ledger.rounds_per_sec} vs prefetch "
          f"{pre_ledger.rounds_per_sec} rounds/s after the first round; ClientPool.nbytes "
          f"{pre_ledger.workload['pool_bytes']}")
    # the scan-over-rounds mode: blocks of 8, 8 and 4, each round one replay
    # of a CUDA graph of the round body
    scan_counts, scan_params, scan_ledger = path_phase(
        torch, main_sc, PATH_ROUNDS, main_per_round, args.out, mode="scan")
    for other, (p_o, l_o) in (("host", (main_params, main_ledger)),
                              ("prefetch", (pre_params, pre_ledger))):
        same_run(torch, f"{main_sc.name}: scan vs {other}", (scan_params, scan_ledger), (p_o, l_o))
        if timing_free(scan_ledger.to_json(True)) != timing_free(l_o.to_json(True)):
            raise AssertionError(f"{main_sc.name}: the scan ledger differs from {other}'s")

    # the charlm cell at full width, the three modes, and with kernel 1 on its aggregate
    c_host = path_phase(torch, charlm_scenario(), CHARLM_ROUNDS, {}, args.out, dim=CHARLM_DIM)
    c_pre = path_phase(torch, charlm_scenario(), CHARLM_ROUNDS, {}, args.out,
                       mode="prefetch", dim=CHARLM_DIM)
    same_run(torch, f"{CHARLM_CELL}: prefetch vs host", c_pre[1:], c_host[1:])
    c_scan = path_phase(torch, charlm_scenario(), CHARLM_ROUNDS, {}, args.out, mode="scan",
                        dim=CHARLM_DIM, rounds_per_scan=CHARLM_SCAN_BLOCK)
    same_run(torch, f"{CHARLM_CELL}: scan vs prefetch", c_scan[1:], c_pre[1:])
    if timing_free(c_scan[2].to_json(True)) != timing_free(c_pre[2].to_json(True)):
        raise AssertionError(f"{CHARLM_CELL}: the scan ledger differs from prefetch's")
    charlm_eval_phase(torch)
    charlm_counts, _, _ = path_phase(torch, charlm_scenario("pallas"), CHARLM_ROUNDS,
                                     {"masked_scale_aggregate": 1}, args.out,
                                     mode="prefetch", dim=CHARLM_DIM)
    charlm_scan_counts, _, _ = path_phase(torch, charlm_scenario("pallas"), CHARLM_ROUNDS,
                                          {"masked_scale_aggregate": 1}, args.out, mode="scan",
                                          dim=CHARLM_DIM, rounds_per_scan=CHARLM_SCAN_BLOCK)
    for cell, runs in ((main_sc.name, ((main_ledger, "host"), (pre_ledger, "prefetch"),
                                       (scan_ledger, "scan"))),
                       (CHARLM_CELL, ((c_host[2], "host"), (c_pre[2], "prefetch"),
                                      (c_scan[2], "scan")))):
        print(f"modes {cell}: " + "; ".join(
            f"{mode} {led.rounds_per_sec} rounds/s, median {statistics.median(led.wall_ms[1:])} "
            f"ms per round" for led, mode in runs) + f"; {card_line()}")
    server_opt_phase(torch, dev)
    vmap_counts, vmap_params, vmap_ledger = path_phase(
        torch, vmap_scenario(), VMAP_ROUNDS, {"compress_norm_scale_aggregate": 1}, args.out)
    from repro_torch.sim.scenarios import get_scenario

    slice1_counts, slice1_params, slice1_ledger = path_phase(
        torch, get_scenario(SLICE1_CELL), SLICE1_ROUNDS, {"masked_scale_aggregate": 1},
        args.out)
    norm_counts = norms_phase(torch)
    srk_counts, srk_params, srk_ledger = path_phase(
        torch, get_scenario(SHARD_RANDK_CELL), SHARD_ROUNDS,
        {"sharded_compress_aggregate": 1}, args.out)
    same_run(torch, f"{SHARD_RANDK_CELL} (world size 1) vs {VMAP_CELL}+pallas",
             (srk_params, srk_ledger), (vmap_params, vmap_ledger))
    shard_counts, shard_params, shard_ledger = path_phase(
        torch, get_scenario(SHARD_CELL), SHARD_ROUNDS, {"sharded_masked_aggregate": 1},
        args.out)
    same_run(torch, f"{SHARD_CELL} (world size 1) vs {SLICE1_CELL}",
             (shard_params, shard_ledger), (slice1_params, slice1_ledger))
    mesh4_phase(torch, args.out)
    serves = {arch: serve_phase(torch, dev, arch, gen, per_prefill, args.out)
              for arch, gen, per_prefill in SERVE_PATHS}
    serve_reduced_phase(torch, dev)
    zamba, mamba = (f"{arch} serve" for arch, _, _ in SERVE_PATHS)
    launches = {
        "masked_scale_aggregate": (slice1_counts, SLICE1_CELL),
        "client_sqnorms": (norm_counts, "ops.tree_client_norms"),
        "norm_scale_aggregate": (counts, main_sc.name),
        "compress_norm_scale_aggregate": (counts, main_sc.name),
        "sharded_masked_aggregate": (shard_counts, SHARD_CELL),
        "sharded_compress_aggregate": (srk_counts, SHARD_RANDK_CELL),
        "flash_attention": (serves["zamba2-2.7b"]["counts"], zamba),
        "ssd_scan": (serves["zamba2-2.7b"]["counts"], zamba),
    }
    for k in kernels:
        run_counts, path = launches[k["name"]]
        k["launches"] = run_counts[k["name"]]
        k["path"] = path
    kernels[3]["vmap_path_launches"] = vmap_counts["compress_norm_scale_aggregate"]
    kernels[0]["charlm_launches"] = charlm_counts["masked_scale_aggregate"]
    kernels[0]["charlm_path"] = f"{CHARLM_CELL}+pallas [prefetch]"
    # device launches of the scan runs (the eager round's, and the graph's
    # nodes times its replays, read in that run); beside them the child's
    # trace of its own scan run, per replayed round
    child = mode_profile_report()["launches"]
    kernels[0]["charlm_scan_launches"] = charlm_scan_counts["masked_scale_aggregate"]
    kernels[0]["charlm_scan_child_trace_per_round"] = child[f"{CHARLM_CELL}+pallas"].get(
        "masked_scale_aggregate", 0)
    for k in (2, 3):
        kernels[k]["prefetch_launches"] = pre_counts[kernels[k]["name"]]
        kernels[k]["scan_launches"] = scan_counts[kernels[k]["name"]]
        kernels[k]["scan_path"] = f"{main_sc.name} [scan]"
        kernels[k]["scan_child_trace_per_round"] = child[main_sc.name].get(kernels[k]["name"], 0)
    kernels[7]["mamba2_130m_launches"] = serves["mamba2-130m"]["counts"]["ssd_scan"]
    kernels[7]["mamba2_130m_path"] = mamba

    profile_phase(torch, main_sc, args.out)
    profile_phase(torch, vmap_scenario(), args.out)
    profile_phase(torch, get_scenario(SLICE1_CELL), args.out)
    profile_phase(torch, get_scenario(SHARD_RANDK_CELL), args.out)
    scan_breakdown_phase(torch)
    breakdown_phase(torch)
    shard_breakdown_phase(torch)

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
