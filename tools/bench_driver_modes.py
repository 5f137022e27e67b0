#!/usr/bin/env python3
"""Times the port's FL main path and its charlm cell per driver mode on a
CUDA card: rounds/s after the first round, the median per-round ms and the
run's ms, of full-width runs.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 tools/bench_driver_modes.py [--src DIR] [--label NAME]
        [--rounds N] [--repeat K] [--modes host,prefetch,prefetch+sync]
        [--out FILE]

``--src`` is the ``src`` directory of the tree to measure (default: this
checkout's), so that two trees, e.g. a ``git archive`` of the parent commit
unpacked into a git-ignored directory, are compared on one card in one call
(run them in turns: parent, change, change, parent).  The cells: the main
path (``femnist1-fedavg-aocs-scan`` with ``agg_backend="pallas"`` and the
rand-k 0.1 of ``femnist1-fedavg-aocs-randk``, as ``chip_smoke.py`` builds
it) and ``charlm-fedavg-aocs`` where the tree registers it.  The modes, each
where the tree runs it:

* ``host``: the driver's numpy batch and pageable upload, a sync per round;
* ``prefetch``: the device-resident pool, no sync between rounds;
* ``prefetch+sync``: prefetch with a device sync after every round step
  (the driver's step wrapped here), which separates the gain of the data
  path from that of not waiting for the device.

Each (cell, mode) runs a 2-round warm-up, then ``--repeat`` runs of
``--rounds`` rounds, the modes in turn within each repeat, in reverse order
on every other repeat.  ``wall_ms`` of
a prefetch run is the dispatch cadence, so compare ``rounds_per_sec``.  It
prints one JSON object per run and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cells():
    from repro_torch.sim.scenarios import SCENARIOS, get_scenario

    sc = get_scenario("femnist1-fedavg-aocs-scan")
    main = sc.with_(name="femnist1-fedavg-aocs-scan+randk+pallas", fl=dataclasses.replace(
        sc.fl, agg_backend="pallas", compression="randk", compression_param=0.1))
    out = [main]
    if "charlm-fedavg-aocs" in SCENARIOS:
        out.append(get_scenario("charlm-fedavg-aocs"))
    return out


def run(torch, sc, mode, rounds):
    from repro_torch.sim import driver

    ds = sc.build_dataset()
    init_fn, loss_fn, _ = sc.build_model(ds)
    make_engine = driver.make_engine
    if mode == "prefetch+sync":
        def synced(*args, **kw):
            step = make_engine(*args, **kw)

            def round_step(*a):
                out = step(*a)
                torch.cuda.synchronize()
                return out

            return round_step

        driver.make_engine = synced
    try:
        return driver.run_simulation(ds, init_fn, loss_fn, sc.fl, rounds,
                                     batch_size=sc.batch_size, seed=sc.seed,
                                     mode="prefetch" if mode != "host" else "host")[1]
    finally:
        driver.make_engine = make_engine


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--modes", default="host,prefetch,prefetch+sync")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_driver_modes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build
    from repro_torch.sim import driver

    torch.cuda.set_device(torch.device("cuda", 0))
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    card = card_line()
    modes = [m for m in args.modes.split(",")
             if m == "host" or hasattr(driver, "ClientPool")]
    print(f"{args.label}: {card}; repro_torch from {args.src}; modes {modes}", flush=True)
    rows = []
    for sc in cells():
        for mode in modes:
            run(torch, sc, mode, 2)
        for rep in range(args.repeat):
            # the modes in turn, the first of them alternating between repeats
            for mode in (modes if rep % 2 == 0 else modes[::-1]):
                ledger = run(torch, sc, mode, args.rounds)
                row = {"label": args.label, "cell": sc.name, "mode": mode, "repeat": rep,
                       "rounds": args.rounds, "rounds_per_sec": ledger.rounds_per_sec,
                       "median_round_ms": statistics.median(ledger.wall_ms[1:]),
                       "run_ms": ledger.wall_s * 1e3, "first_round_ms": ledger.wall_ms[0],
                       "card": card}
                print(json.dumps(row), flush=True)
                rows.append(row)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
