#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with an NVIDIA GPU (an H100 for
the ``sm_90a`` kernels) and the CUDA toolkit::

    python3 chip_smoke.py [--out DIR]

It builds every kernel of the port's main path from ``src/repro_torch/
kernels/csrc`` with nvcc, holds each against its plain PyTorch version on
the card (main-path and odd shapes, f32 and bf16) and times it beside that
plain version, a library call and its memory bound; then drives the main
path — ``run_scenario("femnist1-fedavg-aocs-pallas", mode="host")`` at full
width for 20 rounds — checks that every round went through the kernel, that
the ledger is valid and the losses finite, that a second run reproduces the
masks and parameters bitwise, and that a reduced run on the card matches the
same run on the CPU.  A profiler pass over a few more rounds and a per-layer
breakdown of a round say where a round's time goes.  ``--out DIR`` writes the full-width ledger and the
profile there.

The last two lines of its output are a JSON line of per-kernel numbers and
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without a result; so it does without a CUDA device, and when
it is not run from a checkout.  It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_CELL = "femnist1-fedavg-aocs-pallas"
PATH_ROUNDS = 20
PROFILE_ROUNDS = 5
BREAKDOWN_ROUNDS = 11
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TIMING_REPS = 100
SPIN_CYCLES = 200_000         # ~100 us of device spin at H100 clocks


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def kernel_phase(torch, dev, flush):
    """masked_scale_aggregate: kernel vs plain at every shape, then timings."""
    from repro_torch.kernels import masked_aggregate as ma
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cpu").manual_seed(0)

    def inputs(c, d, dtype):
        u = torch.randn((c, d), generator=gen).to(dev, dtype)
        s = torch.rand((c,), generator=gen).to(dev) * (torch.rand((c,), generator=gen) < 0.5).to(dev)
        return u, s

    rtol, atol = 1e-5, 1e-6
    for dtype in (torch.float32, torch.bfloat16):
        for c in (1, 3, 32, 33, 200):
            for d in (1, 7, 4097, 58430):
                u, s = inputs(c, d, dtype)
                got = ops.masked_scale_aggregate(u, s)
                want = ma.masked_scale_aggregate_ref(u, s)
                torch.cuda.synchronize()
                if got.shape != (d,) or got.dtype != torch.float32:
                    raise AssertionError(f"bad output {tuple(got.shape)} {got.dtype}")
                check_close(f"masked_scale_aggregate C={c} D={d} {dtype}", got, want,
                            u, s, rtol, atol)
    print(f"kernel check: masked_scale_aggregate matches its plain version at "
          f"C in (1,3,32,33,200) x D in (1,7,4097,58430), f32 and bf16 "
          f"(rtol {rtol}, atol {atol})")

    # the main path's shape: 32 clients x 58,430 parameters, padded by ops to
    # the tile multiple — the matrix the wrapper receives each round
    c, d = 32, 58430
    u, s = inputs(c, d, torch.float32)
    upad = torch.nn.functional.pad(u, (0, (-d) % ma.TILE)).contiguous()
    got = ma.masked_scale_aggregate_cuda(upad, s)
    want = ma.masked_scale_aggregate_ref(upad, s)
    again = ma.masked_scale_aggregate_cuda(upad, s)
    torch.cuda.synchronize()
    max_err = check_close("masked_scale_aggregate main shape", got, want, upad, s,
                          rtol, atol)
    if not torch.equal(got, again):
        raise AssertionError("masked_scale_aggregate is not deterministic run to run")
    try:
        ma.masked_scale_aggregate_cuda(upad.t().contiguous().t(), s)
    except ValueError:
        pass
    else:
        raise AssertionError("the wrapper took a non-contiguous matrix")
    print(f"kernel main shape {tuple(upad.shape)} f32: max abs err {max_err}, "
          f"bitwise equal across launches")

    kernel_ms = time_ms(lambda: ma.masked_scale_aggregate_cuda(upad, s), torch, flush)
    plain_ms = time_ms(lambda: ma.masked_scale_aggregate_ref(upad, s), torch, flush)
    library_ms = time_ms(lambda: torch.matmul(s, upad), torch, flush)
    kernel_hot_ms = time_ms(lambda: ma.masked_scale_aggregate_cuda(upad, s), torch)
    cp, dp = upad.shape
    nbytes = (cp * dp + cp + dp) * 4
    flops = 2 * cp * dp
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"kernel timing (median of {TIMING_REPS}, L2 flushed): kernel {kernel_ms} ms, "
          f"plain {plain_ms} ms, torch.matmul {library_ms} ms; kernel with "
          f"L2-resident input {kernel_hot_ms} ms; bound {bound_ms} ms "
          f"({nbytes} bytes at 3.35 TB/s; {flops} flops = {ops_ms} ms)")
    return {
        "name": "masked_scale_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_aggregate.cu",
        "replaces": "src/repro/kernels/masked_aggregate.py:39",
        "shape": [cp, dp],
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "kernel_l2_hot_ms": kernel_hot_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def path_phase(torch, out_dir):
    """The main path at full width, through the kernel, reproduced bitwise."""
    from repro_torch.kernels.masked_aggregate import masked_scale_aggregate_cuda
    from repro_torch.sim.driver import run_scenario, validate_ledger

    masked_scale_aggregate_cuda.launches = 0
    params, ledger = run_scenario(MAIN_CELL, mode="host", rounds=PATH_ROUNDS)
    launches = masked_scale_aggregate_cuda.launches
    if launches != PATH_ROUNDS:
        raise AssertionError(
            f"the main path launched masked_scale_aggregate {launches} times "
            f"in {PATH_ROUNDS} rounds, want {PATH_ROUNDS}"
        )
    doc = ledger.to_json(include_masks=True)
    validate_ledger(doc)
    if len(ledger.loss) != PATH_ROUNDS or not all(map(_finite, ledger.loss)):
        raise AssertionError(f"bad loss series {ledger.loss}")
    if ledger.workload["model_dim"] != 58430 or ledger.workload["backend_platform"] != "cuda":
        raise AssertionError(f"unexpected workload {ledger.workload}")
    for name, p in params.items():
        if p.device.type != "cuda" or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"parameter {name} is not finite on the card")
    walls = ledger.wall_ms[1:]
    print(f"path: {MAIN_CELL} full width, {PATH_ROUNDS} rounds on the card, "
          f"{launches} kernel launches; loss {ledger.loss[0]} -> {ledger.loss[-1]}; "
          f"sent {ledger.sent}")
    print(f"path timing: {ledger.rounds_per_sec} rounds/s after the first round; "
          f"per-round ms median {statistics.median(walls)}, min {min(walls)}, "
          f"max {max(walls)}; first round {ledger.wall_ms[0]} ms")

    params2, ledger2 = run_scenario(MAIN_CELL, mode="host", rounds=PATH_ROUNDS)
    same_masks = all(bool((a == b).all()) for a, b in zip(ledger.masks, ledger2.masks))
    same_params = all(torch.equal(params[k], params2[k]) for k in params)
    if not (same_masks and same_params and ledger.loss == ledger2.loss):
        raise AssertionError("a second run of the main path is not bitwise the first")
    print("path: a second run reproduces masks, losses and parameters bitwise")

    # a reference on a small input: the same reduced run on the CPU
    _, red_cpu = run_scenario(MAIN_CELL, reduced=True, rounds=3, device="cpu")
    _, red_gpu = run_scenario(MAIN_CELL, reduced=True, rounds=3)
    if not all(bool((a == b).all()) for a, b in zip(red_cpu.masks, red_gpu.masks)):
        raise AssertionError("reduced run: masks differ between the card and the CPU")
    for a, b in zip(red_cpu.loss, red_gpu.loss):
        if abs(a - b) > 1e-4 * abs(a):
            raise AssertionError(f"reduced run: losses differ {red_cpu.loss} {red_gpu.loss}")
    print(f"path: reduced run on the card matches the CPU (masks bitwise, loss "
          f"rtol 1e-4): {red_gpu.loss} vs {red_cpu.loss}")
    if out_dir is not None:
        (out_dir / "chip_smoke_ledger.json").write_text(json.dumps(doc, indent=1))
    return launches, ledger


def profile_phase(torch, out_dir):
    """Where a full-width round's time goes: device busy time by kernel
    against the rounds' wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim.driver import run_simulation
    from repro_torch.sim.scenarios import get_scenario

    sc = get_scenario(MAIN_CELL)
    ds = sc.build_dataset()
    init_fn, loss_fn, _ = sc.build_model(ds)

    def run(rounds):
        return run_simulation(ds, init_fn, loss_fn, sc.fl, rounds,
                              batch_size=sc.batch_size, seed=sc.seed)[1]

    run(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ledger = run(PROFILE_ROUNDS)
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
        print("profile: the profiler recorded no device time (not measured)")
        return
    n_ops = sum(r[2] for r in rows)
    print(f"profile: {PROFILE_ROUNDS} rounds under the profiler, rounds' wall {wall} ms, "
          f"device busy {busy} ms, idle share {1 - busy / wall}; {n_ops} device ops "
          f"({n_ops / PROFILE_ROUNDS} per round)")
    for key, ms, count in rows[:12]:
        print(f"profile:   {ms:10.3f} ms  {count:6d}x  {key[:90]}")
    if out_dir is not None:
        prof.export_chrome_trace(str(out_dir / "chip_smoke_trace.json"))


def breakdown_phase(torch):
    """Host-clock ms of each layer of a full-width round, with a device sync
    after each, so every layer's time includes its device work (median over
    rounds after the first).  The layers are called as the round step calls
    them; the step itself does not sync between them, so the sum exceeds a
    round's wall time by the syncs."""
    from collections import defaultdict

    import numpy as np
    from torch.func import vmap

    from repro_torch import rng as trng
    from repro_torch.core import ocs
    from repro_torch.fl.engine import RoundEngine
    from repro_torch.fl.round import client_weights
    from repro_torch.sim.scenarios import get_scenario

    sc = get_scenario(MAIN_CELL)
    fl = sc.fl
    ds = sc.build_dataset()
    init_fn, loss_fn, _ = sc.build_model(ds)
    engine = RoundEngine(loss_fn, fl)
    dev = engine.device
    key = trng.PRNGKey(sc.seed, device=dev)
    params = init_fn(trng.fold_in(key, 1))
    weights = client_weights(fl, device=dev)
    gen = np.random.default_rng(sc.seed)
    local_update = vmap(engine._local_update, in_dims=(None, 0))
    times = defaultdict(list)

    def lap(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times[name].append((t1 - t0) * 1e3)
        return t1

    for k in range(BREAKDOWN_ROUNDS):
        t = time.perf_counter()
        clients = gen.choice(ds.n_clients, size=fl.n_clients, replace=False)
        batch = ds.sample_round_batches(gen, clients, fl.local_steps, sc.batch_size)
        t = lap("data: numpy batch assembly", t)
        batch = {bk: torch.as_tensor(v, device=dev) for bk, v in batch.items()}
        t = lap("data: upload (pageable copy)", t)
        k_sample, _ = trng.split(trng.fold_in(key, 1000 + k))
        t = lap("keys: fold_in + split", t)
        updates, losses = local_update(params, batch)
        t = lap("local update (vmap of grad, R steps)", t)
        u = ocs.client_norms(updates, weights)
        t = lap("norms", t)
        plan = ocs.sampling_plan(u, weights, fl.cohort_target(), k_sample,
                                 sampler=fl.sampler, j_max=fl.j_max,
                                 availability=fl.availability)
        t = lap("plan: probabilities + mask + alpha/gamma", t)
        aggregate = ocs.aggregate_updates(updates, plan.scale, backend=engine.backend)
        t = lap("aggregate (tree -> matrix, pad, kernel, split)", t)
        params, _ = engine._apply_server(params, (), aggregate)
        lap("server step", t)
    total = 0.0
    for name, vals in times.items():
        med = statistics.median(vals[1:])
        total += med
        print(f"breakdown: {med:9.3f} ms  {name}")
    print(f"breakdown: {total:9.3f} ms  sum of medians over {BREAKDOWN_ROUNDS - 1} rounds")


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the full-width ledger and the profile trace")
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
    kernel = kernel_phase(torch, dev, flush)
    del flush
    launches, _ = path_phase(torch, args.out)
    kernel["launches"] = launches
    profile_phase(torch, args.out)
    breakdown_phase(torch)

    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
