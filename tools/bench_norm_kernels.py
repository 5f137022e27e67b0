#!/usr/bin/env python3
"""Times the port's norm kernels (kernels 2, 3, 4 and 6) at the FL paths'
shapes on a CUDA card, and counts the device ops of a round of the three FL
paths that run them.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 tools/bench_norm_kernels.py [--src DIR] [--label NAME]
        [--variant SOURCE:CONSTANT=N[,CONSTANT=N...]] [--width D] [--rounds N]
        [--out FILE]

``--src`` is the ``src`` directory of the tree to measure (default: this
checkout's), so that two trees, e.g. a ``git archive`` of the parent commit
unpacked into a git-ignored directory, are compared on one card in one call
(run them in turns: parent, change, change, parent).  For each shape it
reports, L2 flushed before each call (median of CUDA events, or the mean of
the profiler's device time):

* ``ops_ms``: the ``ops`` call as the engine and the mesh round make it, on
  the unpadded ``(C, 58430)`` matrices (any padding the tree's ``ops`` does
  included);
* ``kernel_ms``: the kernel wrapper alone, on the matrices the tree's ``ops``
  hands it (padded or not);
* ``device_ms``: the device time of every kernel of the ``ops`` call, by
  ``torch.profiler``; ``launches``: its device kernels per call;
* ``floor_ms``: ``torch.cuda._sleep(1)`` timed the same way.

The shapes: kernel 2 (``client_sqnorms``) at 32 and 4 clients; kernel 3 at
4; kernel 4 rand-k at 4 and 32; kernel 6 (``shard_compress_aggregate``)
rand-k at 32, 8 and 1,024 clients, qsgd and natural at 32.  Then the device
ops per round of the scan + rand-k + pallas path, the vmap + rand-k + pallas
path and the mesh + rand-k + pallas path at world size 1
(``torch.profiler`` over a few rounds after two).

``--width D`` times the shapes at another model width than the MLP's
58,430 (no round ops): at a multiple of 4 a tree whose wrappers pick
16-byte loads there takes them.

``--variant norm_aggregate.cu:kSqGroup=16,kSqMinCtas=2`` builds a copy of
the sources whose ``constexpr int`` constants in that file take the values
given, prints the registers per thread of its kernels and any spills, and
times the shapes of the kernels that file holds (no round ops); one variant
per process, since a profiler window late in a process can lose device
events; the ``--src`` tree's source must have the constants. The constants:
``kBlock`` (kernels 3 and 4's client register block, timed at every
compressor kind; in ``sharded_aggregate.cu`` kernel 6's), ``kSqGroup``
(kernel 2's clients per CTA, 0 for all) and ``kSqMinCtas`` (its launch
bounds' CTAs per SM) in ``norm_aggregate.cu``, ``kMinCtas`` (kernel 6's) in
``sharded_aggregate.cu``.
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
# (kernel, clients, compressor, parameter)
SHAPES = {
    "norm_aggregate": (("client_sqnorms", 32, "none", 0.0), ("client_sqnorms", 4, "none", 0.0),
                       ("norm_scale_aggregate", 4, "none", 0.0),
                       ("compress_norm_scale_aggregate", 4, "randk", 0.1),
                       ("compress_norm_scale_aggregate", 32, "randk", 0.1)),
    "sharded_aggregate": (("shard_compress_aggregate", 32, "randk", 0.1),
                          ("shard_compress_aggregate", 8, "randk", 0.1),
                          ("shard_compress_aggregate", 1024, "randk", 0.1),
                          ("shard_compress_aggregate", 32, "qsgd", 8.0),
                          ("shard_compress_aggregate", 32, "natural", 0.0)),
}
BLOCK_KINDS = (("none", 0.0), ("randk", 0.1), ("qsgd", 8.0), ("natural", 0.0))
REPS = 100


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
    kernels (``chip_smoke.profile_segments``); (None, None) when every
    window lost device events."""
    from chip_smoke import profile_segments

    try:
        seen = profile_segments(torch, [fn] + [lambda: (flush.neg_(), fn())] * reps)
    except AssertionError as err:        # the profiler lost device events
        print(f"profiler: {err}; device time not measured", file=sys.stderr)
        return None, None
    us = sum(t for seg in seen[1:] for k, t in seg if "neg_kernel" not in k)
    return us / reps / 1e3, len(seen[0])


def inputs(torch, c, kind, param, dev, seed):
    """Unpadded (C, D) f32 updates, scale and contiguous material, as the
    engine and the mesh round pass them."""
    from repro_torch import rng
    from repro_torch.core.compression import client_material

    gen = torch.Generator(device="cpu").manual_seed(seed)
    u = (torch.randn((c, D), generator=gen) * 1e-2).to(dev)
    s = (torch.rand((c,), generator=gen) * (torch.rand((c,), generator=gen) < 0.6)).to(dev)
    keys = rng.split(rng.PRNGKey(seed, device=dev), c)
    mats = tuple(m["u"].contiguous() for m in client_material({"u": u}, keys, kind, param))
    return u, s, mats


def calls(name, u, s, mats, kind, param) -> tuple:
    """(the ops call, the kernel wrapper alone on what this tree's ops hands
    it, the plain version) of one shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import norm_aggregate as na
    from repro_torch.kernels import ops
    from repro_torch.kernels import sharded_aggregate as sa

    # the trees before the one-launch kernels pad for them
    pad = (-u.shape[1]) % 512
    if name == "client_sqnorms":
        uk = u if hasattr(na, "_counters") else F.pad(u, (0, pad))
        return (lambda: ops.client_sqnorms(u), lambda: na.client_sqnorms_cuda(uk),
                lambda: na.client_sqnorms_ref(u))
    if name == "shard_compress_aggregate":
        padded = not hasattr(sa, "_counters")
        uk = F.pad(u, (0, pad)) if padded else u
        mk = tuple(F.pad(m, (0, pad)) for m in mats) if padded else mats
        return (lambda: ops.shard_compress_aggregate(u, s, mats, kind, param),
                lambda: sa.sharded_compress_aggregate_cuda(uk, s, mk, kind, param),
                lambda: sa.sharded_compress_aggregate_ref(u, s, mats, kind, param))
    padded = not (hasattr(na, "_counters") or hasattr(na, "_ticket"))
    uk = F.pad(u, (0, pad)) if padded else u
    mk = tuple(F.pad(m, (0, pad)) for m in mats) if padded else mats
    if name == "norm_scale_aggregate":
        return (lambda: ops.norm_scale_aggregate(u, s),
                lambda: na.norm_scale_aggregate_cuda(uk, s),
                lambda: na.norm_scale_aggregate_ref(u, s))
    return (lambda: ops.compress_norm_scale_aggregate(u, s, mats, kind, param),
            lambda: na.compress_norm_scale_aggregate_cuda(uk, s, mk, kind, param),
            lambda: na.compress_norm_scale_aggregate_ref(u, s, mats, kind, param))


def _vector_of(u, mats):
    """The load width this tree's one-launch wrappers pick for the matrices
    (None before they had one)."""
    from repro_torch.kernels import norm_aggregate as na

    return na._vector(u.shape[1], u, *mats) if hasattr(na, "_vector") else None


def _pair(out) -> tuple:
    """(norms, aggregate or None) of a kernel's result."""
    return (out, None) if not isinstance(out, tuple) else out


def kernel_shapes(torch, dev, flush, label, shapes) -> list:
    rows = []
    for name, c, kind, param in shapes:
        u, s, mats = inputs(torch, c, kind, param, dev, seed=c + len(kind))
        path, kernel, plain = calls(name, u, s, mats, kind, param)
        (want_sq, want_agg), (got_sq, got_agg) = _pair(path()), _pair(kernel())
        plain_sq, _ = _pair(plain())
        torch.cuda.synchronize()
        if not (torch.equal(want_sq, got_sq)
                and (want_agg is None or torch.equal(want_agg, got_agg[:D]))):
            raise AssertionError(f"{label}: the kernel alone differs from the ops call")
        if not torch.allclose(want_sq, plain_sq, rtol=1e-5, atol=0):
            raise AssertionError(f"{label}: {name} {kind} at ({c}, {D}): norms are not the "
                                 f"plain version's")
        device_ms, launches = profiled(torch, path, flush)
        row = {"label": label, "name": name, "kind": kind, "shape": [c, D],
               "vector": _vector_of(u, mats),
               "ops_ms": time_ms(torch, path, flush), "kernel_ms": time_ms(torch, kernel, flush),
               "device_ms": device_ms, "launches": launches,
               "sq_sum": float(want_sq.double().sum()),
               "agg_sum": None if want_agg is None else float(want_agg.double().sum())}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def round_ops(torch, label, rounds) -> list:
    """Device ops per round of the scan, vmap and mesh (world size 1) rand-k
    pallas paths."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim.driver import run_scenario
    from repro_torch.sim.scenarios import get_scenario

    rows = []
    for cell in ("femnist1-fedavg-aocs-scan", "femnist1-fedavg-aocs-randk",
                 "femnist1-fedavg-aocs-shard-randk"):
        sc = get_scenario(cell)
        if not sc.sharded:
            sc = sc.with_(fl=dataclasses.replace(sc.fl, agg_backend="pallas",
                                                 compression="randk", compression_param=0.1))
        run_scenario(sc, mode="host", rounds=2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, ledger = run_scenario(sc, mode="host", rounds=rounds)
        n_ops = sum(e.count for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA"))
        row = {"label": label, "path": f"{cell} ({sc.fl.compression}, {sc.fl.agg_backend})",
               "rounds": rounds, "device_ops_per_round": n_ops / rounds,
               "round_ms_median": statistics.median(ledger.wall_ms[1:])}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def variant_shapes(torch, dev, flush, label, spec) -> list:
    """``spec`` = ``SOURCE:CONSTANT=N[,CONSTANT=N...]``: the shapes of
    SOURCE's kernels on a build whose constants are those values (kernel 4's
    at every compressor kind when the constant is its block ``kBlock``)."""
    from repro_torch.kernels import _build

    source, rest = spec.split(":")
    stem = source.removesuffix(".cu")
    text = (_build.CSRC / source).read_text()
    consts = dict(item.split("=") for item in rest.split(","))
    for const, n in consts.items():
        line = re.compile(rf"(constexpr int {const} = )\d+(;)")
        if not line.search(text):
            raise SystemExit(f"this tree's {source} has no constexpr int {const}")
        text = line.sub(rf"\g<1>{n}\g<2>", text)
    shapes = SHAPES[stem]
    if "kBlock" in consts and stem == "norm_aggregate":
        shapes = [("compress_norm_scale_aggregate", c, k, p) for k, p in BLOCK_KINDS
                  for c in (4, 32)]
    tag = "_".join(f"{k}{v}" for k, v in consts.items())
    variant = _build.BUILD_DIR / tag
    shutil.rmtree(variant, ignore_errors=True)
    shutil.copytree(_build.CSRC, variant / "csrc")
    (variant / "csrc" / source).write_text(text)
    _build.CSRC, _build.BUILD_DIR = variant / "csrc", variant / "lib"
    _build._libs.clear()
    for _, log in _build.build((stem,)).values():
        regs = sorted({line.split("Used ")[1].split(",")[0] for line in log.splitlines()
                       if "registers" in line})
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line and "0 bytes spill stores" not in line})
        print(json.dumps({"label": f"{label} {tag}", "registers": regs, "spills": spills}))
    return kernel_shapes(torch, dev, flush, f"{label} {tag}", shapes)


def main() -> int:
    global D
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--variant", default="",
                    help="SOURCE:CONSTANT=N[,CONSTANT=N...], e.g. "
                         "norm_aggregate.cu:kSqGroup=16,kSqMinCtas=2")
    ap.add_argument("--width", type=int, default=58430, help="model width D of the shapes")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    D = args.width

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
    if args.variant:
        rows += variant_shapes(torch, dev, flush, args.label, args.variant)
    else:
        _build.build(("norm_aggregate", "sharded_aggregate"))
        rows += kernel_shapes(torch, dev, flush, args.label,
                              [s for shapes in SHAPES.values() for s in shapes])
        if args.width == 58430:
            rows += round_ops(torch, args.label, args.rounds)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
