"""Training driver, ``--scenario`` branch: one cell of the paper's experiment
grid (``repro_torch/sim/scenarios.py``) through ``repro_torch.sim.driver``
— the port of ``repro/launch/train.py``'s scenario branch.

``--prefetch on|off`` selects the double-buffered device-pool pipeline or
the host loop, ``--sim-rounds-per-scan N`` (N > 0) the scan-over-rounds
mode (each round one CUDA-graph replay on a card), and ``--shard on`` runs
the cell on a client mesh (the mesh round with the sharded ``ClientPool``;
``Scenario.sharded`` cells build that mesh themselves, and ``--shard off``
runs such a cell on one device).  Scan-over-rounds and a mesh are mutually
exclusive.  ``--sampler`` overrides the cell's client-selection rule, and
``--stragglers SPEC`` / ``--deadline T`` its client-state layer
(:func:`parse_stragglers`; e.g. ``--stragglers
p_up=0.35,p_down=0.15,drop=0.1,over=2 --deadline 2.0``).  The ledger goes to ``benchmarks/artifacts/sim_torch/{cell}-{mode}.json``, beside
(never over) the reference's ``sim/`` ledgers.  ``--device`` is the port's
own flag: the run is on the GPU unless it says ``cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --scenario list
  PYTHONPATH=src python -m repro_torch.launch.train --scenario femnist1-fedavg-aocs \\
      --reduced --rounds 3 --sim-rounds-per-scan 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --scenario charlm-fedavg-aocs \\
      --rounds 10 --sim-rounds-per-scan 5                 # on the GPU

Not ported yet, each raising ``NotImplementedError`` with the ROADMAP item
that brings it: ``--arch`` (the decoder family's training, queue 1 item 5),
and ``--metrics-port``, ``--diag-every``, ``--obs-jsonl``, ``--trace-dir``,
``--checkpoint``, ``--ckpt-every`` and ``--resume`` (observability and
checkpoints, item 4).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

# flag -> the ROADMAP item (queue 1) that brings it
NOT_PORTED = {
    "metrics_port": "4 (observability)",
    "diag_every": "4 (observability)",
    "obs_jsonl": "4 (observability)",
    "trace_dir": "4 (observability)",
    "checkpoint": "4 (checkpoint/resume)",
    "ckpt_every": "4 (checkpoint/resume)",
    "resume": "4 (checkpoint/resume)",
}


def _reject_unported(args) -> None:
    for name, item in NOT_PORTED.items():
        if getattr(args, name) is not None:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet (ROADMAP queue 1, item {item})")


def parse_stragglers(spec: str | None, deadline: float | None):
    """``--stragglers``/``--deadline`` -> ``(SystemConfig | None, over_select)``.

    ``spec`` is a comma-separated k=v list over the client-state knobs,
    ``p_up``, ``p_down``, ``latency_mu``, ``latency_sigma``, ``drop``
    (``drop_prob``) and ``over`` (``FLConfig.over_select``); ``deadline``
    is its own flag and composes with the defaults when given alone.
    Returns ``(None, None)`` when neither flag was passed; a bad entry exits
    with the reference's message.
    """
    if spec is None and deadline is None:
        return None, None
    from repro_torch.sim.pool import SystemConfig

    kw, over = {}, None
    for part in (spec.split(",") if spec else []):
        if "=" not in part:
            raise SystemExit(f"--stragglers entry {part!r} is not k=v")
        k, v = part.split("=", 1)
        k = k.strip()
        try:
            v = float(v)
        except ValueError:
            raise SystemExit(f"--stragglers {k}={v!r}: not a number") from None
        if k == "over":
            over = v
        elif k == "drop":
            kw["drop_prob"] = v
        elif k in ("p_up", "p_down", "latency_mu", "latency_sigma"):
            kw[k] = v
        else:
            raise SystemExit(
                f"--stragglers key {k!r} unknown; want p_up, p_down, "
                f"latency_mu, latency_sigma, drop, over"
            )
    if deadline is not None:
        kw["deadline"] = deadline
    try:
        return SystemConfig(**kw), over
    except ValueError as e:
        raise SystemExit(f"--stragglers/--deadline: {e}") from None


def run_scenario_cli(args):
    """The ``--scenario`` branch: one experiment-grid cell via
    ``repro_torch.sim``; returns the ledger (``None`` for ``list``)."""
    from repro_torch.sim.driver import build_client_mesh, run_scenario
    from repro_torch.sim.scenarios import get_scenario, list_scenarios

    if args.scenario == "list":
        for name in list_scenarios():
            sc = get_scenario(name)
            shard = " [sharded]" if sc.sharded else ""
            print(f"{name:40s} {sc.paper}{shard}")
        return None
    if args.sim_rounds_per_scan > 0:
        mode = "scan"
    else:
        mode = "prefetch" if args.prefetch == "on" else "host"
    sc = get_scenario(args.scenario)
    if args.sampler:
        # --sampler overrides the cell's own rule (the engine validates it)
        sc = sc.with_(fl=dataclasses.replace(sc.fl, sampler=args.sampler))
    system, over = parse_stragglers(args.stragglers, args.deadline)
    if system is not None:
        # the flags replace the cell's own system config; over= rides into
        # the FLConfig, so the plan over-selects
        fl = sc.fl if over is None else dataclasses.replace(sc.fl, over_select=over)
        sc = sc.with_(system=system, fl=fl)
    if args.shard == "off":
        # an explicit off overrides even a Scenario.sharded cell
        sc = sc.with_(sharded=False)
    effective = sc.reduced() if args.reduced else sc
    mesh = None
    if args.shard == "on" or effective.sharded:
        if mode == "scan":
            raise SystemExit(
                "--sim-rounds-per-scan and a mesh conflict: the shard_map "
                "round cannot run inside the scan-over-rounds block "
                "(docs/architecture.md#limits) — drop --sim-rounds-per-scan "
                "or pass --shard off"
            )
        mesh = build_client_mesh(effective.fl, device=args.device)
    # the artifact path carries the effective (possibly -reduced) name, so a
    # reduced smoke never clobbers a full run's ledger
    artifact = os.path.join("benchmarks", "artifacts", "sim_torch",
                            f"{effective.name}-{mode}.json")
    try:
        shards = 0 if mesh is None else mesh.world_size
        print(f"[sim] scenario {effective.name} ({sc.paper}) mode={mode}"
              f"{f' mesh={shards}' if shards else ''} "
              f"rounds={args.rounds if args.rounds is not None else effective.rounds}")
        _, ledger = run_scenario(
            sc, reduced=args.reduced, mode=mode, rounds=args.rounds,
            rounds_per_scan=max(args.sim_rounds_per_scan, 1), mesh=mesh,
            artifact=artifact, device=args.device,
        )
    finally:
        if mesh is not None:
            mesh.close()
    for k, (loss, sent) in enumerate(zip(ledger.loss, ledger.sent)):
        sys_col = ""
        if effective.system is not None:
            sys_col = (f"sel {ledger.over_selected[k]} miss {ledger.deadline_misses[k]} "
                       f"drop {ledger.dropouts[k]} ")
        print(f"[round {k:3d}] loss {loss:.4f} alpha {ledger.alpha[k]:.3f} "
              f"sent {sent}/{ledger.fl['n_clients']} {sys_col}"
              f"up {ledger.uplink_bits[k] / 1e9:.2f}G down {ledger.downlink_bits[k] / 1e9:.2f}G")
    print(f"[sim] {ledger.rounds_per_sec:.1f} rounds/s (steady-state), artifact {artifact}")
    return ledger


def main(argv=None):
    ap = argparse.ArgumentParser(description="federated training of a scenario cell")
    ap.add_argument("--arch", default=None,
                    help="assigned architecture to train (not ported yet: raises)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="communication rounds (default: the scenario's own)")
    ap.add_argument("--scenario", default=None,
                    help="run a registered sim scenario ('list' prints the registry)")
    ap.add_argument("--reduced", action="store_true",
                    help="the seconds-scale reduced variant of the scenario")
    ap.add_argument("--prefetch", default="on", choices=["on", "off"],
                    help="double-buffered device-pool pipeline (on) vs host loop (off)")
    ap.add_argument("--sim-rounds-per-scan", type=int, default=0,
                    help=">0 selects the scan-over-rounds mode with this block length")
    ap.add_argument("--sampler", default=None,
                    choices=["optimal", "aocs", "uniform", "full",
                             "clustered", "cyclic", "threshold"],
                    help="override the scenario's client-selection rule")
    ap.add_argument("--stragglers", default=None, metavar="SPEC",
                    help="client-state layer spec, comma-separated k=v over p_up, p_down, "
                         "latency_mu, latency_sigma, drop (drop_prob), over (over_select) "
                         "— e.g. 'p_up=0.35,p_down=0.15,drop=0.1,over=2'")
    ap.add_argument("--deadline", type=float, default=None,
                    help="round deadline in latency units (enables the client-state "
                         "layer; composes with --stragglers)")
    ap.add_argument("--shard", default="auto", choices=["auto", "on", "off"],
                    help="run on a client mesh (auto: the scenario's own setting)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    for name in NOT_PORTED:
        ap.add_argument(f"--{name.replace('_', '-')}", default=None,
                        help="not ported yet: raises")
    args = ap.parse_args(argv)
    _reject_unported(args)
    if args.scenario:
        return run_scenario_cli(args)
    if args.arch is None:
        ap.error("one of --arch or --scenario is required")
    raise NotImplementedError(
        "--arch is not ported yet: training the decoder family lands with the model "
        "zoo (ROADMAP queue 1, item 5); run a cell with --scenario")


if __name__ == "__main__":
    main()
