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
  and its bound; flash attention over S x head dim x (window, prefix), the
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
  losses finite, that a second run reproduces masks, losses and parameters
  bitwise, and that a reduced run on the card matches the same run on the
  CPU;
* ``femnist1-fedavg-aocs-shard-randk`` on 4 ranks sharing the one card (gloo,
  every rank on ``cuda:0``): each rank's launches, masks equal across ranks,
  the first round's mask equal to the world-size-1 run's and the parameters
  within 1e-5 of it; its times are those of 4 ranks sharing one card, not of
  4 GPUs;
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
* a profiler pass and a per-layer breakdown of the main path, of the first
  slice's path and of the mesh round, which say where a round's time goes.

``--out DIR`` writes the full-width ledgers and the profiles there.  The last
two lines of its output are a JSON line of per-kernel numbers and
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without a result; so it does without a CUDA device, and when
it is not run from a checkout.  It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_CELL = "femnist1-fedavg-aocs-scan"       # + randk 0.1, agg_backend pallas
VMAP_CELL = "femnist1-fedavg-aocs-randk"      # + agg_backend pallas
SLICE1_CELL = "femnist1-fedavg-aocs-pallas"
SHARD_RANDK_CELL = "femnist1-fedavg-aocs-shard-randk"
SHARD_CELL = "femnist1-fedavg-aocs-shard"
PATH_ROUNDS = 20
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

    for bad in (torch.zeros((512, 4), device=dev).t(),                  # not contiguous
                torch.zeros((4, 7), device=dev),                        # D not a multiple of 4
                torch.zeros((4, 512), device=dev, dtype=torch.float16)):  # dtype
        for call in (lambda: na.client_sqnorms_cuda(bad),
                     lambda: na.norm_scale_aggregate_cuda(bad, torch.zeros(bad.shape[0],
                                                                           device=dev))):
            try:
                call()
            except (ValueError, TypeError):
                pass
            else:
                raise AssertionError(f"a wrapper took {tuple(bad.shape)} {bad.dtype} "
                                     f"stride {bad.stride()}")
    print("kernel check: the wrappers reject a non-contiguous matrix, D % 4 != 0 and float16")

    # timings at the path shapes, as the wrappers receive them (D padded)
    d = 58430
    dp = d + (-d) % ma.TILE
    rows = []

    def timed(name, c, kind, fn, plain, library, nbytes, flops, err):
        bound_ms, bound_by = bound(nbytes, flops)
        k_ms = time_ms(fn, torch, flush)
        p_ms = time_ms(plain, torch, flush)
        l_ms = time_ms(library, torch, flush) if library is not None else None
        print(f"kernel timing {name}{'' if kind is None else ' ' + kind} at ({c}, {dp}) f32 "
              f"(median of {TIMING_REPS}, L2 flushed): kernel {k_ms} ms, plain {p_ms} ms, "
              f"library {l_ms} ms; bound {bound_ms} ms ({nbytes} bytes, {flops} flops, "
              f"{bound_by}); max abs err {err}")
        rows.append((name, c, kind, k_ms, p_ms, l_ms, bound_ms, bound_by, err))
        return k_ms, p_ms, l_ms, bound_ms, bound_by

    out = {}
    u32 = torch.nn.functional.pad(inputs(32, d, torch.float32, False)[0],
                                  (0, dp - d)).contiguous()
    err = check_sq("client_sqnorms path shape", na.client_sqnorms_cuda(u32),
                   na.client_sqnorms_ref(u32), RTOL)
    out["client_sqnorms"] = ((32, dp), err, timed(
        "client_sqnorms", 32, None, lambda: na.client_sqnorms_cuda(u32),
        lambda: na.client_sqnorms_ref(u32),
        lambda: torch.einsum("cd,cd->c", u32, u32),
        (32 * dp + 32) * 4, 2 * 32 * dp, err))

    u4, s4 = inputs(4, d, torch.float32, False)
    u4 = torch.nn.functional.pad(u4, (0, dp - d)).contiguous()
    sq, agg = na.norm_scale_aggregate_cuda(u4, s4)
    want_sq, want_agg = na.norm_scale_aggregate_ref(u4, s4)
    err = max(check_sq("norm_scale_aggregate path shape", sq, want_sq, RTOL),
              check_close("norm_scale_aggregate path shape", agg, want_agg, u4, s4, RTOL, ATOL))
    out["norm_scale_aggregate"] = ((4, dp), err, timed(
        "norm_scale_aggregate", 4, None, lambda: na.norm_scale_aggregate_cuda(u4, s4),
        lambda: na.norm_scale_aggregate_ref(u4, s4), None,
        (4 * dp + 4 + 4 + dp) * 4, 4 * 4 * dp, err))

    for c in (4, 32):
        uc, sc = inputs(c, d, torch.float32, False)
        uc = torch.nn.functional.pad(uc, (0, dp - d)).contiguous()
        mats = tuple(torch.nn.functional.pad(m, (0, dp - d)).contiguous()
                     for m in material(uc[:, :d], "randk", 0.1, seed=c))
        sq, agg = na.compress_norm_scale_aggregate_cuda(uc, sc, mats, "randk", 0.1)
        want_sq, want_agg = na.compress_norm_scale_aggregate_ref(uc, sc, mats, "randk", 0.1)
        err = max(check_sq("compress_norm_scale_aggregate path shape", sq, want_sq, RTOL),
                  check_close("compress_norm_scale_aggregate path shape", agg, want_agg,
                              uc * mats[0], sc, RTOL, ATOL))
        res = timed(
            "compress_norm_scale_aggregate", c, "randk",
            lambda: na.compress_norm_scale_aggregate_cuda(uc, sc, mats, "randk", 0.1),
            lambda: na.compress_norm_scale_aggregate_ref(uc, sc, mats, "randk", 0.1), None,
            (2 * c * dp + c + c + dp) * 4, 5 * c * dp, err)
        out[f"compress_norm_scale_aggregate@{c}"] = ((c, dp), err, res)

    def entry(name, replaces, key, launches=None):
        shape, err, (k_ms, p_ms, l_ms, b_ms, b_by) = out[key]
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/norm_aggregate.cu",
            "replaces": replaces, "shape": list(shape), "launches": launches,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms,
        }

    vm = out["compress_norm_scale_aggregate@32"][2]
    k4 = entry("compress_norm_scale_aggregate", "src/repro/kernels/norm_aggregate.py:125",
               "compress_norm_scale_aggregate@4")
    k4.update({"vmap_shape": [32, dp], "vmap_ms": vm[0], "vmap_plain_ms": vm[1],
               "vmap_bound_ms": vm[3]})
    return [
        entry("client_sqnorms", "src/repro/kernels/client_norm.py:34", "client_sqnorms"),
        entry("norm_scale_aggregate", "src/repro/kernels/norm_aggregate.py:62",
              "norm_scale_aggregate"),
        k4,
    ]


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
                torch.zeros((4, 7), device=dev),                        # D not a multiple of 4
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
    print("kernel check: the sharded wrappers reject a non-contiguous matrix, D % 4 != 0 "
          "and float16")

    d = 58430
    dp = d + (-d) % ma.TILE
    out = {}
    for c in (32, 8, 1024):
        u, s = inputs(c, d, torch.float32, False)
        u = torch.nn.functional.pad(u, (0, dp - d)).contiguous()
        got = sa.sharded_masked_aggregate_cuda(u, s)
        err5 = check_close("sharded_masked_aggregate path shape", got,
                           sa.sharded_masked_aggregate_ref(u, s), u, s, RTOL, ATOL)
        b5 = bound((c * dp + c + dp) * 4, 2 * c * dp)
        t5 = (time_ms(lambda: sa.sharded_masked_aggregate_cuda(u, s), torch, flush),
              time_ms(lambda: sa.sharded_masked_aggregate_ref(u, s), torch, flush),
              time_ms(lambda: torch.matmul(s, u), torch, flush))
        mats = tuple(torch.nn.functional.pad(m, (0, dp - d)).contiguous()
                     for m in material(u[:, :d], "randk", 0.1, seed=c))
        sq, agg = sa.sharded_compress_aggregate_cuda(u, s, mats, "randk", 0.1)
        want_sq, want_agg = sa.sharded_compress_aggregate_ref(u, s, mats, "randk", 0.1)
        err6 = max(check_sq("sharded_compress_aggregate path shape", sq, want_sq, RTOL),
                   check_close("sharded_compress_aggregate path shape", agg, want_agg,
                               u * mats[0], s, RTOL, ATOL))
        b6 = bound((2 * c * dp + c + c + dp) * 4, 5 * c * dp)
        t6 = (time_ms(lambda: sa.sharded_compress_aggregate_cuda(u, s, mats, "randk", 0.1),
                      torch, flush),
              time_ms(lambda: sa.sharded_compress_aggregate_ref(u, s, mats, "randk", 0.1),
                      torch, flush))
        print(f"kernel timing sharded_masked_aggregate at ({c}, {dp}) f32 (median of "
              f"{TIMING_REPS}, L2 flushed): kernel {t5[0]} ms, plain {t5[1]} ms, "
              f"torch.matmul {t5[2]} ms, kernel / torch.matmul {t5[0] / t5[2]}; bound "
              f"{b5[0]} ms ({b5[1]}); max abs err {err5}; {card_line()}")
        print(f"kernel timing sharded_compress_aggregate randk at ({c}, {dp}) f32 (median "
              f"of {TIMING_REPS}, L2 flushed): kernel {t6[0]} ms, plain {t6[1]} ms, "
              f"library none; bound {b6[0]} ms ({b6[1]}); max abs err {err6}")
        out[c] = (err5, t5, b5, err6, t6, b6)

    def entry(name, replaces, i):
        err, t, b = out[32][i:i + 3]
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sharded_aggregate.cu",
            "replaces": replaces, "shape": [32, dp], "launches": None,
            "max_abs_err": max(out[c][i] for c in out), "ms": t[0], "plain_ms": t[1],
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": t[2] if len(t) > 2 else None,
        }
        for c in (8, 1024):
            ec, tc, bc = out[c][i:i + 3]
            row[f"at_{c}"] = {"shape": [c, dp], "ms": tc[0], "plain_ms": tc[1],
                              "library_ms": tc[2] if len(tc) > 2 else None,
                              "bound_ms": bc[0], "bound_by": bc[1]}
        return row

    return [entry("sharded_masked_aggregate", "src/repro/kernels/sharded_aggregate.py:68", 0),
            entry("sharded_compress_aggregate", "src/repro/kernels/sharded_aggregate.py:140",
                  3)]


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
    flushed before each call (read as :func:`_profile_serve` reads kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        for name in SSD_PASSES:
            if name + "(" in ev.key or name + "<" in ev.key:    # pass 2 is a template
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
        passes = _ssd_pass_times(torch, kernel, flush)
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


def path_phase(torch, sc, rounds, per_round, out_dir):
    """One path at full width: ``rounds`` rounds through the kernels
    (``per_round`` launches each), reproduced bitwise, and a reduced run on
    the card against the CPU.  A sharded cell runs the mesh round at world
    size 1 (NCCL on the card, gloo for the CPU run).  Returns the counts,
    the parameters and the ledger of the run."""
    from repro_torch.sim.driver import run_scenario, validate_ledger

    reset_counts()
    t0 = time.perf_counter()
    params, ledger = run_scenario(sc, mode="host", rounds=rounds)
    counts = read_counts()
    want = {name: per_round.get(name, 0) * rounds for name in counts}
    if counts != want:
        raise AssertionError(f"{sc.name}: launches {counts}, want {want}")
    doc = ledger.to_json(include_masks=True)
    validate_ledger(doc)
    if len(ledger.loss) != rounds or not all(map(_finite, ledger.loss)):
        raise AssertionError(f"bad loss series {ledger.loss}")
    if (ledger.workload["model_dim"] != 58430 or ledger.workload["backend_platform"] != "cuda"
            or ledger.workload.get("mesh_axis_size") != (1 if sc.sharded else None)):
        raise AssertionError(f"unexpected workload {ledger.workload}")
    for name, p in params.items():
        if p.device.type != "cuda" or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"parameter {name} is not finite on the card")
    walls = ledger.wall_ms[1:]
    print(f"path {sc.name}: full width, {rounds} rounds on the card in "
          f"{time.perf_counter() - t0:.1f} s; launches per round "
          f"{ {k: v / rounds for k, v in counts.items() if v} }; loss {ledger.loss[0]} -> "
          f"{ledger.loss[-1]}; sent {ledger.sent}; uplink bits {ledger.uplink_bits[-1]}")
    print(f"path {sc.name} timing: {ledger.rounds_per_sec} rounds/s after the first round; "
          f"per-round ms median {statistics.median(walls)}, min {min(walls)}, "
          f"max {max(walls)}; set-up (first round) {ledger.wall_ms[0]} ms")

    params2, ledger2 = run_scenario(sc, mode="host", rounds=rounds)
    same_masks = all(bool((a == b).all()) for a, b in zip(ledger.masks, ledger2.masks))
    same_params = all(torch.equal(params[k], params2[k]) for k in params)
    if not (same_masks and same_params and ledger.loss == ledger2.loss):
        raise AssertionError(f"{sc.name}: a second run is not bitwise the first")
    print(f"path {sc.name}: a second run reproduces masks, losses and parameters bitwise")

    # a reference on a small input: the same reduced run on the CPU
    _, red_cpu = run_scenario(sc, reduced=True, rounds=3, device="cpu")
    _, red_gpu = run_scenario(sc, reduced=True, rounds=3)
    if not all(bool((a == b).all()) for a, b in zip(red_cpu.masks, red_gpu.masks)):
        raise AssertionError(f"{sc.name} reduced: masks differ between the card and the CPU")
    for a, b in zip(red_cpu.loss, red_gpu.loss):
        if abs(a - b) > 1e-4 * abs(a):
            raise AssertionError(f"{sc.name} reduced: losses differ {red_cpu.loss} "
                                 f"{red_gpu.loss}")
    print(f"path {sc.name}: reduced run on the card matches the CPU (masks bitwise, loss "
          f"rtol 1e-4): {red_gpu.loss} vs {red_cpu.loss}")
    if out_dir is not None:
        (out_dir / f"chip_smoke_ledger_{sc.name}.json").write_text(json.dumps(doc, indent=1))
    return counts, params, ledger


def same_run(torch, what, a, b) -> None:
    """Two runs' masks, losses and parameters, bitwise."""
    (pa, la), (pb, lb) = a, b
    same = (len(la.masks) == len(lb.masks)
            and all(bool((x == y).all()) for x, y in zip(la.masks, lb.masks))
            and la.loss == lb.loss and la.uplink_bits == lb.uplink_bits
            and all(torch.equal(pa[k], pb[k]) for k in pa))
    if not same:
        raise AssertionError(f"{what}: the runs differ")
    print(f"path {what}: masks, losses, uplink bits and parameters bitwise equal over "
          f"{len(la.masks)} rounds")


def _mesh4_rank(mesh, rounds):
    """One of the ranks that share the card: the shard-randk cell at full
    width, with the shapes its sharded compress kernel receives."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sim.driver import run_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = []
    kernel = ops.sharded_compress_aggregate_cuda

    def recorded(u, *rest):
        shapes.append(tuple(u.shape))
        return kernel(u, *rest)

    ops.sharded_compress_aggregate_cuda = recorded
    reset_counts()
    params, ledger = run_scenario(SHARD_RANDK_CELL, rounds=rounds, mesh=mesh)
    counts = read_counts()
    return {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device),
            "counts": counts, "shapes": shapes,
            "params": {k: v.cpu() for k, v in params.items()},
            "doc": ledger.to_json(include_masks=True)}


def mesh4_phase(torch, out_dir):
    """``femnist1-fedavg-aocs-shard-randk`` on MESH4_RANKS gloo ranks sharing
    the one card, against the world-size-1 run of the same rounds."""
    from repro_torch.fl.mesh import spawn_mesh
    from repro_torch.sim.driver import run_scenario, validate_ledger

    ref_params, ref_ledger = run_scenario(SHARD_RANDK_CELL, rounds=MESH4_ROUNDS)
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
        if r["counts"] != want or r["backend"] != "gloo" or r["device"] != "cuda:0":
            raise AssertionError(f"rank {r['rank']}: launches {r['counts']} on {r['backend']} "
                                 f"{r['device']}, want {want} on gloo cuda:0")
        if len(r["shapes"]) != MESH4_ROUNDS or {s[0] for s in r["shapes"]} != {k}:
            raise AssertionError(f"rank {r['rank']}: kernel shapes {r['shapes']}")
        if r["doc"] != doc0:
            raise AssertionError(f"rank {r['rank']}: its ledger differs from rank 0's")
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
          f"(D 58430 padded); ledgers, masks and parameters equal across the ranks; the first "
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
        return run_simulation(ds, init_fn, loss_fn, sc.fl, rounds,
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
            laps.lap("aggregate: pad + kernel (sharded_compress_aggregate)")
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
    del flush

    main_sc = main_scenario()
    print(f"path: the main path is the reference cell {MAIN_CELL} built with "
          f"Scenario.with_(fl=replace(fl, agg_backend='pallas', compression='randk', "
          f"compression_param=0.1)), the rand-k setting of {VMAP_CELL}: {main_sc.fl}")
    from repro_torch.fl.engine import RoundEngine

    engine = RoundEngine(main_sc.build_model(main_sc.build_dataset())[1], main_sc.fl)
    print(f"path {main_sc.name}: scan_group {engine.scan_group}, cache_groups "
          f"{engine.cache_groups}, local_update_evals {engine.local_update_evals} per round")
    counts, _, _ = path_phase(torch, main_sc, PATH_ROUNDS,
                              {"norm_scale_aggregate": 4, "compress_norm_scale_aggregate": 4},
                              args.out)
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
    kernels[7]["mamba2_130m_launches"] = serves["mamba2-130m"]["counts"]["ssd_scan"]
    kernels[7]["mamba2_130m_path"] = mamba

    profile_phase(torch, main_sc, args.out)
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
