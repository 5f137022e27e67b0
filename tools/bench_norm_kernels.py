#!/usr/bin/env python3
"""Times the port's fused norm + aggregate kernels (kernels 3 and 4) at the
FL paths' shapes on a CUDA card, and counts the device ops of a round of the
two FL paths that run them.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 tools/bench_norm_kernels.py [--src DIR] [--label NAME]
        [--blocks N,...] [--rounds N] [--out FILE]

``--src`` is the ``src`` directory of the tree to measure (default: this
checkout's), so that two trees, e.g. a ``git archive`` of the parent commit
unpacked into a git-ignored directory, are compared on one card in one call
(run them in turns: parent, change, change, parent).  For each shape it
reports, L2 flushed before each call (median of CUDA events, or the mean of
the profiler's device time):

* ``ops_ms``: the ``ops`` call as the engine makes it, on the unpadded
  ``(C, 58430)`` matrices (any padding the tree's ``ops`` does included);
* ``kernel_ms``: the kernel wrapper alone, on the matrices the tree's ``ops``
  hands it (padded or not);
* ``device_ms``: the device time of every kernel of the ``ops`` call, by
  ``torch.profiler``; ``launches``: its device kernels per call;
* ``floor_ms``: ``torch.cuda._sleep(1)`` timed the same way.

and the device ops per round of the scan + rand-k + pallas path and of the
vmap + rand-k + pallas path (``torch.profiler`` over a few rounds after two).
``--blocks`` builds variants of ``csrc/norm_aggregate.cu`` whose client
register block (``kBlock``) is each N given and times kernels 3 and 4 with
each (the ``--src`` tree must be one whose source has that block, i.e. not
older than the one-launch kernel).
It prints one JSON object per measurement and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))                 # chip_smoke's profiler window
D = 58430
SHAPES = (("norm_scale_aggregate", 4, "none"), ("compress_norm_scale_aggregate", 4, "randk"),
          ("compress_norm_scale_aggregate", 32, "randk"))
BLOCK_KINDS = (("none", 0.0), ("randk", 0.1), ("qsgd", 8.0), ("natural", 0.0))
REPS = 100
BLOCK_LINE = re.compile(r"(constexpr int kBlock = )\d+(;)")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps=REPS) -> float:
    """Median ms of one call by CUDA events, L2 flushed before each call."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        flush.neg_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(torch, fn, flush, reps=20) -> tuple:
    """(mean device ms per call, device kernels per call) of ``fn`` under the
    profiler: one call alone, then ``reps`` calls, each after an L2 flush
    (whose ``neg`` kernel is left out), in one window split at marker
    kernels (``chip_smoke.profile_segments``)."""
    from chip_smoke import profile_segments

    seen = profile_segments(torch, [fn] + [lambda: (flush.neg_(), fn())] * reps)
    us = sum(t for seg in seen[1:] for k, t in seg if "neg_kernel" not in k)
    return us / reps / 1e3, len(seen[0])


def inputs(torch, c, kind, param, dev, seed):
    """Unpadded (C, D) f32 updates, scale and contiguous material, as the
    engine passes them."""
    from repro_torch import rng
    from repro_torch.core.compression import client_material

    gen = torch.Generator(device="cpu").manual_seed(seed)
    u = (torch.randn((c, D), generator=gen) * 1e-2).to(dev)
    s = (torch.rand((c,), generator=gen) * (torch.rand((c,), generator=gen) < 0.6)).to(dev)
    keys = rng.split(rng.PRNGKey(seed, device=dev), c)
    mats = tuple(m["u"].contiguous() for m in client_material({"u": u}, keys, kind, param))
    return u, s, mats


def kernel_shapes(torch, dev, flush, label, shapes) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels import norm_aggregate as na
    from repro_torch.kernels import ops

    pads = not hasattr(na, "_ticket")         # trees before the one-launch kernel pad
    rows = []
    for name, c, kind, param in shapes:
        u, s, mats = inputs(torch, c, kind, param, dev, seed=c + len(kind))
        if name == "norm_scale_aggregate":
            path = lambda: ops.norm_scale_aggregate(u, s)                   # noqa: E731
        else:
            path = lambda: ops.compress_norm_scale_aggregate(u, s, mats, kind, param)  # noqa: E731
        pad = (-D) % 512 if pads else 0
        uk = F.pad(u, (0, pad)) if pad else u
        mk = tuple(F.pad(m, (0, pad)) for m in mats) if pad else mats
        if name == "norm_scale_aggregate":
            kernel = lambda: na.norm_scale_aggregate_cuda(uk, s)            # noqa: E731
        else:
            kernel = lambda: na.compress_norm_scale_aggregate_cuda(        # noqa: E731
                uk, s, mk, kind, param)
        want = path()
        got = kernel()
        plain = na.compress_norm_scale_aggregate_ref(u, s, mats, kind, param)
        torch.cuda.synchronize()
        if not (torch.equal(want[0], got[0]) and torch.equal(want[1], got[1][:D])):
            raise AssertionError(f"{label}: the kernel alone differs from the ops call")
        if not torch.allclose(want[0], plain[0], rtol=1e-5, atol=0):
            raise AssertionError(f"{label}: {name} {kind} at ({c}, {D}): norms are not the "
                                 f"plain version's")
        device_ms, launches = profiled(torch, path, flush)
        row = {"label": label, "name": name, "kind": kind, "shape": [c, D],
               "ops_ms": time_ms(torch, path, flush), "kernel_ms": time_ms(torch, kernel, flush),
               "device_ms": device_ms, "launches": launches,
               "sq_sum": float(want[0].double().sum()), "agg_sum": float(want[1].double().sum())}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def round_ops(torch, label, rounds) -> list:
    """Device ops per round of the scan and vmap rand-k pallas paths."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim.driver import run_simulation
    from repro_torch.sim.scenarios import get_scenario

    rows = []
    for cell in ("femnist1-fedavg-aocs-scan", "femnist1-fedavg-aocs-randk"):
        sc = get_scenario(cell)
        fl = dataclasses.replace(sc.fl, agg_backend="pallas", compression="randk",
                                 compression_param=0.1)
        ds = sc.build_dataset()
        init_fn, loss_fn, _ = sc.build_model(ds)

        def run(n):
            return run_simulation(ds, init_fn, loss_fn, fl, n, batch_size=sc.batch_size,
                                  seed=sc.seed)[1]

        run(2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ledger = run(rounds)
        n_ops = sum(e.count for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA"))
        row = {"label": label, "path": cell + " + randk 0.1 + pallas", "rounds": rounds,
               "device_ops_per_round": n_ops / rounds,
               "round_ms_median": statistics.median(ledger.wall_ms[1:])}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--blocks", default="", help="client blocks, e.g. 4,8,16")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_norm_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{args.label}: {card_line()}; repro_torch from {args.src}", flush=True)
    flush = torch.ones(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    floor = time_ms(torch, lambda: torch.cuda._sleep(1), flush)
    rows = [{"label": args.label, "floor_ms": floor, "card": card_line()}]
    print(json.dumps(rows[0]), flush=True)
    if args.blocks:
        source = (_build.CSRC / "norm_aggregate.cu").read_text()
        if not BLOCK_LINE.search(source):
            raise SystemExit("this tree's norm_aggregate.cu has no client block line")
        shapes = [("compress_norm_scale_aggregate", c, k, p) for k, p in BLOCK_KINDS
                  for c in (4, 32)]
        base_csrc, base_build = _build.CSRC, _build.BUILD_DIR
        for n in (int(v) for v in args.blocks.split(",")):
            variant = base_build / f"block_{n}"
            shutil.rmtree(variant, ignore_errors=True)
            shutil.copytree(base_csrc, variant / "csrc")
            (variant / "csrc" / "norm_aggregate.cu").write_text(
                BLOCK_LINE.sub(rf"\g<1>{n}\g<2>", source))
            _build.CSRC, _build.BUILD_DIR = variant / "csrc", variant / "lib"
            _build._libs.clear()
            _build.build(("norm_aggregate",))
            rows += kernel_shapes(torch, dev, flush, f"{args.label} block {n}", shapes)
        _build.CSRC, _build.BUILD_DIR = base_csrc, base_build
        _build._libs.clear()
    else:
        _build.build(("norm_aggregate",))
        rows += kernel_shapes(torch, dev, flush, args.label,
                              [(n, c, k, 0.1 if k == "randk" else 0.0) for n, c, k in SHAPES])
        rows += round_ops(torch, args.label, args.rounds)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
