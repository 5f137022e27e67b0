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

``--metrics-port`` / ``--diag-every`` / ``--obs-jsonl`` / ``--trace-dir``
(with ``--trace-rounds``) / ``--obs-phases`` switch on the observability
layer (``repro_torch/obs``): a live JSON/Prometheus endpoint, the online
Eq. 2 gap estimator (single device only), the JSONL event stream, and a
``torch.profiler`` window over the first rounds; ``--obs-phases auto`` runs
the phased executor in host mode only.  ``--checkpoint DIR`` /
``--ckpt-every N`` / ``--resume PATH`` write and resume the driver's round
checkpoints (``repro_torch/checkpoint``): a resumed run ends with the
uninterrupted run's parameters bitwise and its ledger minus timing, and a
checkpoint whose config fingerprint differs from the invocation's is
refused.

Not ported yet: ``--arch`` (the decoder family's training, ROADMAP queue 1
item 5), which raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

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


def obs_from_args(args, mode: str | None = None):
    """``--metrics-port``/``--diag-every``/... -> ``ObsConfig | None`` (the
    reference's ``obs_from_args``): ``None`` when no obs flag was passed,
    so the run keeps the telemetry-off path; ``--obs-phases auto`` switches
    the phased executor on in host mode only."""
    if (args.metrics_port is None and args.diag_every == 0 and args.obs_jsonl is None
            and args.trace_dir is None and args.obs_phases != "on"):
        return None
    from repro_torch.obs import ObsConfig

    phases = args.obs_phases == "on" or (args.obs_phases == "auto" and mode == "host")
    return ObsConfig(diag_every=args.diag_every, metrics_port=args.metrics_port,
                     jsonl=args.obs_jsonl, trace_dir=args.trace_dir,
                     trace_rounds=args.trace_rounds, phases=phases)


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
        obs = obs_from_args(args, mode=mode)
        if obs is not None and obs.diag_every > 0 and mesh is not None:
            raise SystemExit(
                "--diag-every and a mesh conflict: the obs gap estimator is "
                "single-device only (docs/architecture.md#limits) — drop "
                "--diag-every or pass --shard off"
            )
        ckpt_cfg = None
        if args.checkpoint:
            from repro_torch.checkpoint import CheckpointConfig

            ckpt_cfg = CheckpointConfig(args.checkpoint, every=args.ckpt_every)
        _, ledger = run_scenario(
            sc, reduced=args.reduced, mode=mode, rounds=args.rounds,
            rounds_per_scan=max(args.sim_rounds_per_scan, 1), mesh=mesh,
            artifact=artifact, obs=obs, checkpoint=ckpt_cfg, resume=args.resume,
            device=args.device,
        )
    finally:
        if mesh is not None:
            mesh.close()
    if ckpt_cfg is not None:
        print(f"[sim] round checkpoints under {ckpt_cfg.dir} (every {ckpt_cfg.every})")
    for k, (loss, sent) in enumerate(zip(ledger.loss, ledger.sent)):
        sys_col = ""
        if effective.system is not None:
            sys_col = (f"sel {ledger.over_selected[k]} miss {ledger.deadline_misses[k]} "
                       f"drop {ledger.dropouts[k]} ")
        print(f"[round {k:3d}] loss {loss:.4f} alpha {ledger.alpha[k]:.3f} "
              f"sent {sent}/{ledger.fl['n_clients']} {sys_col}"
              f"up {ledger.uplink_bits[k] / 1e9:.2f}G down {ledger.downlink_bits[k] / 1e9:.2f}G")
    if ledger.gap_rounds:
        gaps = ", ".join(f"r{r}={g:.3g}" for r, g in zip(ledger.gap_rounds, ledger.gap_ratio))
        print(f"[sim] Eq. 2 gap ratio on the diag grid: {gaps}")
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
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve a live JSON/Prometheus metrics endpoint on this port "
                         "(0 = ephemeral; repro_torch/obs/http.py)")
    ap.add_argument("--diag-every", type=int, default=0,
                    help="run the online Eq. 2 gap estimator every N rounds "
                         "(0 = off; single-device only)")
    ap.add_argument("--obs-jsonl", default=None, metavar="PATH",
                    help="write the schema-versioned obs event stream (JSONL) to PATH")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="profile the first --trace-rounds rounds with torch.profiler "
                         "into DIR (a Chrome trace)")
    ap.add_argument("--trace-rounds", type=int, default=3,
                    help="rounds covered by the --trace-dir profiler window")
    ap.add_argument("--obs-phases", default="auto", choices=["auto", "on", "off"],
                    help="phased round execution for per-phase spans (auto: in host "
                         "mode when an obs flag is set; vmap engines only)")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="write round checkpoints under DIR every --ckpt-every rounds "
                         "(atomic step-XXXXXXXX dirs: params, server-opt state, RNG "
                         "bit state, client and sampler state, the ledger so far)")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="rounds between --checkpoint writes")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="resume from a checkpoint root (latest complete step) or a "
                         "step-XXXXXXXX directory; refused if its config fingerprint "
                         "differs from this invocation's")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    if args.scenario:
        return run_scenario_cli(args)
    if args.arch is None:
        ap.error("one of --arch or --scenario is required")
    raise NotImplementedError(
        "--arch is not ported yet: training the decoder family lands with the model "
        "zoo (ROADMAP queue 1, item 5); run a cell with --scenario")


if __name__ == "__main__":
    main()
