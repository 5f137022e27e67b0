"""Phased round executor: the vmap round as five timed phases — the port of
``repro/obs/phased.py``.

:func:`make_phased_step` calls the engine's five
:class:`~repro_torch.fl.engine.VmapPhases` one by one, each inside a
:func:`~repro_torch.obs.trace.span` whose block target is the phase's
output, so each phase's seconds end in a device sync and each phase shows
as its own ``repro.obs/<phase>`` slice in a ``--trace-dir`` trace.

The reference jits each phase separately, so its fusion domains (hence
some reduction orders) differ from the fused step's and its parameters
agree only to float tolerance.  The port runs eagerly: the phases issue the
fused step's ops in its order, so masks AND parameters are bitwise the
fused step's; only the syncs between phases differ.

vmap-memory engines only (the scan engine's group stream has no five-phase
cut; the driver times its rounds whole).
"""

from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.fl.engine import round_metrics
from repro_torch.obs.gap import tree_gap_stats
from repro_torch.obs.trace import span


def make_phased_step(engine, telemetry=None):
    """The engine's five phases composed into one ``round_step``.

    The signature of ``engine.make_step()``'s step plus a trailing ``diag``
    flag: ``phased_step(params, opt_state, batch, weights, key, trace=None,
    sampler_state=None, diag=False)``.  ``telemetry`` (anything with
    ``record_span``) receives each phase's seconds; ``diag=True`` adds the
    Eq. 2 gap reference to the aggregate phase, as ``make_step(diag=True)``
    does.
    """
    if engine.memory != "vmap":
        raise ValueError(
            "phased execution needs a vmap-memory engine; the scan engine "
            f"(memory={engine.memory!r}) is timed at block granularity by "
            "the sim driver instead"
        )
    ph = engine.vmap_phases()

    def phased_step(params, opt_state, batch, weights, key, trace=None,
                    sampler_state=None, diag=False):
        engine._check_devices(weights, key)
        k_sample, k_comp = rng.split(key)
        with span("local_update", telemetry) as sp:
            updates, losses = ph.local_update(params, batch)
            sp.block((updates, losses))
        with span("compress", telemetry) as sp:
            # a 'none' compressor still records its (~0 s) span, so the
            # endpoint always exports all five phases
            sendables, mats = ph.compress(updates, k_comp)
            sp.block(sendables)
        with span("sample", telemetry) as sp:
            plan = ph.sample(sendables, weights, k_sample, trace, sampler_state)
            sp.block(plan.scale)
        gap = None
        with span("aggregate", telemetry) as sp:
            aggregate = ph.aggregate(params, updates, sendables, mats, plan.scale)
            if diag:
                full = ph.aggregate(params, updates, sendables, mats,
                                    weights.to(torch.float32))
                gap = tree_gap_stats(aggregate, full)
            sp.block(aggregate)
        with span("server_opt", telemetry) as sp:
            new_params, new_opt = ph.server_opt(params, opt_state, aggregate)
            sp.block(new_params)
        return new_params, new_opt, round_metrics(plan, torch.mean(losses), trace, gap)

    return phased_step
