"""Training driver — the port of ``repro/launch/train.py``: federated
training of an architecture (``--arch``, reduced or full) with OCS, or one
cell of the paper's experiment grid (``--scenario``).

``--arch NAME`` is the reference's arch loop: every round draws a synthetic
token batch for all n clients on the host (``synthetic_token_batch``, the
reference's numpy draws bitwise) and runs one round of the engine
(``RoundEngine(model.loss, fl, server_opt)``; ``--engine vmap|scan``,
``--agg-backend jnp|pallas``, ``--scan-group``, ``--cache-groups``) or, on
a client mesh (``--shard on``, or ``auto`` with more than one CUDA device
and n divisible by their count), the mesh round of ``fl/shard_round.py``
over the process group's ranks (``fl/mesh.py``).  ``--server-opt
momentum|adam`` applies a server optimizer; ``--stragglers``/``--deadline``
run the client-state layer over all n clients; a stateful ``--sampler``
carries its state round to round.  ``--checkpoint DIR`` / ``--ckpt-every
N`` / ``--resume PATH`` write and resume the full state (parameters, the
server optimizer's state, the client and sampler state, the batch draws'
RNG bit state), fingerprinted over the flags that shape the run, in the
reference's layout.  Under autograd the models run their eager cores, so
on the card the round's kernels are the aggregates (kernel 1 on vmap +
pallas, kernel 3 on scan + pallas, kernel 5 on a mesh + pallas).
``main(argv, init_fn=...)`` takes the initial parameters from
``init_fn(device)`` in place of the model's seeded init (the parity tests
pass the reference's parameters through it).

``--scenario NAME`` runs a cell (``repro_torch/sim/scenarios.py``) through
``repro_torch.sim.driver``: ``--prefetch on|off`` selects the
double-buffered device-pool pipeline or the host loop,
``--sim-rounds-per-scan N`` (N > 0) the scan-over-rounds mode (each round
one CUDA-graph replay on a card), and ``--shard on`` runs the cell on a
client mesh (the mesh round with the sharded ``ClientPool``;
``Scenario.sharded`` cells build that mesh themselves, and ``--shard off``
runs such a cell on one device).  Scan-over-rounds and a mesh are mutually
exclusive.  ``--sampler`` overrides the cell's client-selection rule, and
``--stragglers SPEC`` / ``--deadline T`` its client-state layer
(:func:`parse_stragglers`; e.g. ``--stragglers
p_up=0.35,p_down=0.15,drop=0.1,over=2 --deadline 2.0``).  The ledger goes
to ``benchmarks/artifacts/sim_torch/{cell}-{mode}.json``, beside (never
over) the reference's ``sim/`` ledgers.  ``--device`` is the port's own
flag: the run is on the GPU unless it says ``cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b-reduced \\
      --rounds 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --rounds 3 --agg-backend pallas                     # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --scenario list
  PYTHONPATH=src python -m repro_torch.launch.train --scenario femnist1-fedavg-aocs \\
      --reduced --rounds 3 --sim-rounds-per-scan 2 --device cpu

``--metrics-port`` / ``--diag-every`` / ``--obs-jsonl`` / ``--trace-dir``
(with ``--trace-rounds``) / ``--obs-phases`` switch on the observability
layer (``repro_torch/obs``) on either branch: a live JSON/Prometheus
endpoint, the online Eq. 2 gap estimator (single device only), the JSONL
event stream, and a ``torch.profiler`` window over the first rounds;
``--obs-phases auto`` runs the phased executor in host mode (the arch loop
is one) only.  ``--checkpoint DIR`` / ``--ckpt-every N`` / ``--resume
PATH`` on the scenario branch write and resume the driver's round
checkpoints (``repro_torch/checkpoint``): a resumed run ends with the
uninterrupted run's parameters bitwise and its ledger minus timing.  Either
branch refuses a checkpoint whose config fingerprint differs from the
invocation's.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time

import numpy as np


def synthetic_token_batch(rng, cfg, n, r, b, s, device=None):
    """The arch loop's round batch: ``(n, r, b, s)`` tokens (the targets are
    the same tensor) and the stub modality inputs, drawn from the numpy
    ``Generator`` ``rng`` in the reference's order and uploaded to
    ``device`` (:func:`~repro_torch._device.upload`)."""
    from repro_torch._device import upload

    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, size=(n, r, b, s)).astype(np.int32),
    }
    if cfg.encoder_seq:
        batch["frames"] = rng.normal(size=(n, r, b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32
        ) * 0.02
    if cfg.prefix_tokens:
        batch["patches"] = rng.normal(
            size=(n, r, b, cfg.prefix_tokens, cfg.d_model)
        ).astype(np.float32) * 0.02
    out = {k: upload(v, device) for k, v in batch.items()}
    out["targets"] = out["tokens"]
    return out


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


def run_arch_cli(args, init_fn=None):
    """The ``--arch`` branch: the reference's arch loop on the port's engines.

    Returns ``(params, rows)``: the final parameters and one dict per round
    run (``loss``, ``alpha``, ``gamma``, ``sent``, ``mask``, ``norms``,
    ``total_bits``, ``wall_s``, and ``selected``/``misses``/``drops`` under
    the client-state layer), beside the reference's ``[round k]`` lines."""
    import torch
    import torch.distributed as dist

    from repro_torch._device import resolve_device
    from repro_torch.configs import get
    from repro_torch.configs.base import FLConfig
    from repro_torch.models import build_model
    from repro_torch.sim.driver import build_client_mesh

    cfg = get(args.arch)
    model = build_model(cfg)
    system, over = parse_stragglers(args.stragglers, args.deadline)
    server_opt = None
    if args.server_opt == "momentum":
        from repro_torch.optim import sgd

        server_opt = sgd(args.lr_server, momentum=0.9)
    elif args.server_opt == "adam":
        from repro_torch.optim import adam

        server_opt = adam(args.lr_server)
    fl = FLConfig(
        n_clients=args.clients, expected_clients=args.expected,
        sampler=args.sampler or "aocs",
        local_steps=args.local_steps, lr_local=args.lr_local,
        round_engine=args.engine, agg_backend=args.agg_backend,
        scan_group=args.scan_group, cache_groups=args.cache_groups,
        over_select=over if over is not None else 1.0,
    )
    # the shard_map round has no scan/cache memory policy: an explicit scan
    # request conflicts with --shard on, and wins over --shard auto
    if args.shard == "on" and args.engine == "scan":
        raise SystemExit(
            "--shard on and --engine scan conflict: the shard_map round has "
            "no scan/cache memory policy (docs/architecture.md#limits) — "
            "drop one of the two flags"
        )
    device = resolve_device(args.device)
    if dist.is_initialized():
        n_dev = dist.get_world_size()
    else:
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    shard = args.shard == "on" or (
        args.shard == "auto" and n_dev > 1 and fl.n_clients % n_dev == 0
        and args.engine != "scan"
    )
    if shard and fl.n_clients % n_dev:
        raise SystemExit(
            f"--shard on needs n_clients ({fl.n_clients}) divisible by the "
            f"device count ({n_dev})"
        )
    # the arch loop is a host loop: phase spans and the gap estimator apply
    # as in the sim driver's host mode
    obs = obs_from_args(args, mode="host")
    if shard and obs is not None and obs.diag_every > 0:
        raise SystemExit(
            "--diag-every and a mesh conflict: the obs gap estimator is "
            "single-device only (docs/architecture.md#limits) — drop "
            "--diag-every or pass --shard off"
        )
    if shard and server_opt is not None:
        raise SystemExit(
            "--server-opt and a mesh conflict: the shard_map round has "
            "no server-optimizer stage (docs/architecture.md#limits) — "
            "drop --server-opt or pass --shard off"
        )
    mesh = build_client_mesh(fl, device=args.device) if shard else None
    try:
        return _arch_rounds(args, init_fn, cfg, model, fl, system, server_opt, obs, mesh,
                            device if mesh is None else mesh.device)
    finally:
        if mesh is not None:
            mesh.close()


def _arch_rounds(args, init_fn, cfg, model, fl, system, server_opt, obs, mesh, device):
    """The arch loop's rounds on ``device`` (a mesh's rank, when given)."""
    import torch

    from repro_torch import rng as trng
    from repro_torch.checkpoint import read_meta, restore, save
    from repro_torch.checkpoint.resume import config_diff, fingerprint
    from repro_torch.core.sampling import init_sampler_state, is_stateful
    from repro_torch.fl.engine import RoundEngine, make_engine
    from repro_torch.fl.round import client_weights, round_bits
    from repro_torch.kernels.ops import tree_leaves

    key = trng.PRNGKey(0, device)
    if init_fn is not None:
        params = init_fn(device)
    else:
        params = model.init(torch.Generator(device=device).manual_seed(0), device)
    dim = sum(leaf.numel() for leaf in tree_leaves(params))
    opt_state = server_opt.init(params) if server_opt is not None else ()
    state = None
    clients = torch.arange(fl.n_clients, device=device)
    if system is not None:
        # every round's cohort is the full client set, so the trace covers
        # all n clients each round
        from repro_torch.sim.pool import init_client_state, step_client_state

        state = init_client_state(fl.n_clients, system, trng.fold_in(key, 2))

    lead = mesh is None or mesh.rank == 0
    engine = f"shard_map/{mesh.world_size}" if mesh is not None else fl.round_engine
    print(f"[train] {cfg.name}: {dim / 1e6:.1f}M params, n={fl.n_clients} "
          f"m={fl.expected_clients} sampler={fl.sampler} engine={engine} agg={fl.agg_backend}")
    tel = None
    if obs is not None and lead:
        from repro_torch.obs import Telemetry

        tel = Telemetry(obs)
    diag_on = tel is not None and tel.cfg.diag_every > 0
    phased_step = step_diag = None
    if mesh is None:
        eng = RoundEngine(model.loss, fl, server_opt, device=device)
        if tel is not None and tel.cfg.phases and eng.memory == "vmap":
            from repro_torch.obs.phased import make_phased_step

            phased_step = make_phased_step(eng, tel)
        else:
            step = eng.make_step()
            if diag_on:
                step_diag = eng.make_step(True)
        lo, k_local = 0, fl.n_clients
    else:
        step = make_engine(model.loss, fl, mesh=mesh)
        k_local = fl.n_clients // mesh.world_size
        lo = mesh.rank * k_local
    w = client_weights(fl, device=device)[lo:lo + k_local]
    rng = np.random.default_rng(0)
    total_bits = 0
    # stateful samplers (cyclic/threshold) carry their SamplerState round to round
    samp = init_sampler_state(device) if is_stateful(fl.sampler) else None

    # the arch trajectory is (params, server-opt state, the batch draws' RNG
    # stream, the client-state chains, the sampler carry): all of it rides in
    # the checkpoint, fingerprinted over the flags that shape the run
    ckpt_doc = {
        "arch": cfg.name,
        "fl": dataclasses.asdict(fl),
        "system": None if system is None else dataclasses.asdict(system),
        "batch": args.batch, "seq": args.seq,
        "server_opt": args.server_opt, "lr_server": args.lr_server,
    }

    def arch_tree():
        return {
            "params": params, "opt_state": opt_state,
            "client_state": state if state is not None else (),
            "sampler_state": samp if samp is not None else (),
        }

    k0 = 0
    if args.resume:
        meta, _ = read_meta(args.resume)
        if meta.get("arch_fingerprint") != fingerprint(ckpt_doc):
            diffs = "; ".join(config_diff(meta.get("config", {}), ckpt_doc))
            raise SystemExit(
                "--resume: checkpoint/flag fingerprint mismatch — resuming "
                "would silently change the trajectory. Differing keys: "
                + (diffs or "<fingerprint only>")
            )
        tree, _ = restore(args.resume, arch_tree())
        params, opt_state = tree["params"], tree["opt_state"]
        if state is not None:
            state = tree["client_state"]
        if samp is not None:
            samp = tree["sampler_state"]
        rng.bit_generator.state = meta["rng_state"]
        total_bits = int(meta["total_bits"])
        k0 = int(meta["round"])
        if k0 >= args.rounds:
            raise SystemExit(
                f"--resume: checkpoint already covers round {k0} — raise "
                f"--rounds past it to extend the run"
            )
        print(f"[train] resumed at round {k0} from {args.resume}")

    def write_ckpt(k_done):
        # on a mesh rank 0 alone writes, and every rank waits for it
        if lead:
            d = save(
                args.checkpoint, arch_tree(), step=k_done + 1,
                meta={
                    "round": k_done + 1,
                    "rng_state": copy.deepcopy(rng.bit_generator.state),
                    "total_bits": int(total_bits),
                    "config": ckpt_doc,
                    "arch_fingerprint": fingerprint(ckpt_doc),
                },
                keep=3,
            )
            print(f"[train] checkpoint -> {d}")
        if mesh is not None:
            mesh.barrier()

    if tel is not None:
        tel.run_start(arch=cfg.name, mode="train", sampler=fl.sampler,
                      n_clients=fl.n_clients, rounds=args.rounds, backend=device.type)
    rows = []
    for k in range(k0, args.rounds):
        if tel is not None:
            tel.round_start(k)
        batch = synthetic_token_batch(rng, cfg, fl.n_clients, fl.local_steps,
                                      args.batch, args.seq, device)
        if mesh is not None:
            batch = {name: v[lo:lo + k_local] for name, v in batch.items()}
        t0 = time.perf_counter()
        kk = trng.fold_in(key, k)
        diag = diag_on and tel.want_gap(k)
        sys_col = ""
        trace = None
        if state is not None:
            state, trace = step_client_state(state, kk, clients, system)
        if phased_step is not None:
            params, opt_state, m = phased_step(params, opt_state, batch, w, kk, trace, samp,
                                               diag=diag)
        else:
            params, opt_state, m = (step_diag if diag else step)(
                params, opt_state, batch, w, kk, trace, samp)
        if samp is not None:
            samp = m.sampler_state
        row = {"loss": float(m.loss), "alpha": float(m.alpha), "gamma": float(m.gamma),
               "sent": int(m.sent_clients), "mask": m.mask.cpu().numpy(),
               "norms": m.norms.cpu().numpy()}
        if state is not None:
            row.update(selected=int(m.selected_clients), misses=int(m.deadline_misses),
                       drops=int(m.dropouts))
            sys_col = f"sel {row['selected']} miss {row['misses']} drop {row['drops']} "
        total_bits += round_bits(fl, dim, row["mask"])
        wall_s = time.perf_counter() - t0
        row.update(total_bits=int(total_bits), wall_s=wall_s)
        rows.append(row)
        if diag:
            tel.record_gap(k, float(m.gap.gap_sq), float(m.gap.full_sq))
        if tel is not None:
            tel.record_round(k, loss=row["loss"], sent_clients=row["sent"],
                             wall_ms=wall_s * 1e3, uplink_bits_total=int(total_bits))
        print(f"[round {k:3d}] loss {row['loss']:.4f} alpha {row['alpha']:.3f} "
              f"gamma {row['gamma']:.3f} sent {row['sent']}/{fl.n_clients} "
              f"{sys_col}bits {total_bits / 1e9:.2f}G ({wall_s:.1f}s)")
        if args.checkpoint and ((k + 1) % args.ckpt_every == 0 or k + 1 == args.rounds):
            write_ckpt(k)
    if tel is not None:
        tel.finish(rounds=args.rounds)
        tel.close()
    return params, rows


def main(argv=None, init_fn=None):
    """The CLI.  ``init_fn(device)``, when given, returns the ``--arch``
    run's initial parameters in place of the model's seeded init."""
    ap = argparse.ArgumentParser(description="federated training of an architecture "
                                             "or a scenario cell")
    ap.add_argument("--arch", default=None,
                    help="architecture to train (omit with --scenario)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="communication rounds (default: 10, or the scenario's own "
                         "with --scenario)")
    ap.add_argument("--scenario", default=None,
                    help="run a registered sim scenario ('list' prints the registry)")
    ap.add_argument("--reduced", action="store_true",
                    help="with --scenario: the seconds-scale reduced variant")
    ap.add_argument("--prefetch", default="on", choices=["on", "off"],
                    help="with --scenario: double-buffered device-pool pipeline (on) "
                         "vs host loop (off)")
    ap.add_argument("--sim-rounds-per-scan", type=int, default=0,
                    help="with --scenario: >0 selects the scan-over-rounds mode with "
                         "this block length")
    ap.add_argument("--sampler", default=None,
                    choices=["optimal", "aocs", "uniform", "full",
                             "clustered", "cyclic", "threshold"],
                    help="client-selection rule (default: aocs on the arch path, the "
                         "scenario's own with --scenario)")
    ap.add_argument("--stragglers", default=None, metavar="SPEC",
                    help="client-state layer spec, comma-separated k=v over p_up, p_down, "
                         "latency_mu, latency_sigma, drop (drop_prob), over (over_select) "
                         "— e.g. 'p_up=0.35,p_down=0.15,drop=0.1,over=2'")
    ap.add_argument("--deadline", type=float, default=None,
                    help="round deadline in latency units (enables the client-state "
                         "layer; composes with --stragglers)")
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
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--expected", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr-local", type=float, default=0.05)
    ap.add_argument("--server-opt", default="none", choices=["none", "momentum", "adam"],
                    help="server optimizer applied to the aggregate (arch branch; its "
                         "state rides in --checkpoint)")
    ap.add_argument("--lr-server", type=float, default=1.0,
                    help="server optimizer learning rate (--server-opt)")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="write checkpoints under DIR every --ckpt-every rounds (atomic "
                         "step-XXXXXXXX dirs: params, server-opt state, RNG bit state, "
                         "client and sampler state; with --scenario also the ledger)")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="rounds between --checkpoint writes")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="resume from a checkpoint root (latest complete step) or a "
                         "step-XXXXXXXX directory; refused if its config fingerprint "
                         "differs from this invocation's")
    ap.add_argument("--shard", default="auto", choices=["auto", "on", "off"],
                    help="run on a client mesh (auto: with --arch when there is more "
                         "than one CUDA device and they divide the clients; with "
                         "--scenario the cell's own setting)")
    ap.add_argument("--engine", default="vmap", choices=["vmap", "scan"])
    ap.add_argument("--agg-backend", default="jnp", choices=["jnp", "pallas"])
    ap.add_argument("--scan-group", type=int, default=2,
                    help="clients per scan group (--engine scan)")
    ap.add_argument("--cache-groups", type=int, default=8,
                    help="groups whose pass-1 update matrices stay cached (0 = two-pass "
                         "recompute; >= clients/scan-group = single-pass)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    if args.scenario:
        return run_scenario_cli(args)
    if args.arch is None:
        ap.error("one of --arch or --scenario is required")
    if args.rounds is None:
        args.rounds = 10
    return run_arch_cli(args, init_fn)

if __name__ == "__main__":
    main()
