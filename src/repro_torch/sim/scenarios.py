"""Scenario registry: the paper's Sec. 4 experiment grid as named configs.

A copy of the reference's registry (``repro/sim/scenarios.py``), all 46
cells, with field values identical to the reference's, so one name means
one run in both packages:

* ``femnist{1,2,3}-fedavg-{full,aocs,uniform}`` (Sec. 4.2, Figs. 3-5)
* ``femnist1-dsgd-{optimal,uniform}`` (Sec. 4.1)
* ``charlm-fedavg-{aocs,uniform}`` (Sec. 4.2, Figs. 6-7: the 2-layer GRU)
* ``cifar-fedavg-aocs`` (Appendix G)
* ``femnist1-fedavg-aocs-q0.7`` (Appendix E)
* ``femnist1-fedavg-aocs-randk`` (Sec. 6 future work: rand-k x OCS)
* ``femnist1-fedavg-aocs-scan`` (the single-pass scan engine)
* ``femnist1-fedavg-aocs-pallas`` (the Eq. 2 aggregate on the CUDA kernel)
* ``femnist1-fedavg-aocs-shard``, ``-shard-randk``, ``-shard-q0.7-natural``
  (the mesh round, ``sharded=True``)
* the system-realism column (``system=``, the client-state layer): Markov
  availability (``-markov``, ``-markov-iid``), deadlines with over-selection
  (``-deadline``), dropout (``-dropout``) and their combination
  (``-straggler``, also ``-scan`` and ``-shard``), on femnist, charlm and
  cifar cells
* the sampler-zoo column: ``clustered``, ``cyclic`` and ``threshold``, alone
  and under the system layer, compression, the scan engine and the mesh

Any other name raises ``KeyError``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.configs.base import FLConfig
from repro_torch.sim.pool import SystemConfig


@dataclass(frozen=True)
class Scenario:
    """One cell of the paper's experiment grid, fully parameterized.

    ``dataset`` names a synthetic factory (``femnist1|femnist2|femnist3``,
    ``charlm``, ``cifar``); ``dataset_kw`` overrides its defaults; ``paper`` records the
    section/figure the cell reproduces.  ``sharded`` cells run the mesh round
    (``run_scenario`` builds a mesh with ``build_client_mesh`` when none is
    given).  ``system`` cells (a :class:`~repro_torch.sim.pool.SystemConfig`)
    run under the client-state layer.
    """

    name: str
    dataset: str
    fl: FLConfig
    rounds: int = 50
    batch_size: int = 20
    hidden: int = 64
    seed: int = 1
    paper: str = ""
    sharded: bool = False
    system: SystemConfig | None = None
    dataset_kw: dict = field(default_factory=dict)

    def with_(self, **kw) -> "Scenario":
        """``dataclasses.replace`` shorthand."""
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "Scenario":
        """Seconds-scale CPU smoke variant of the same grid cell (the
        reference's ``Scenario.reduced``)."""
        fl = dataclasses.replace(
            self.fl,
            n_clients=8,
            expected_clients=min(self.fl.expected_clients, 3),
            local_steps=min(self.fl.local_steps, 2),
            scan_group=2,
            cache_groups=min(self.fl.cache_groups, 2),
        )
        return self.with_(
            name=self.name + "-reduced", fl=fl, rounds=2, batch_size=4, hidden=16
        )

    def build_dataset(self, reduced: bool = False):
        """Instantiate the scenario's (optionally reduced) synthetic dataset."""
        from repro_torch.data import charlm, cifar_like, femnist_like

        kw = dict(self.dataset_kw)
        if self.dataset.startswith("femnist"):
            did = int(self.dataset[len("femnist"):])
            if reduced:
                kw.setdefault("n_clients", 24)
                kw.setdefault("dim", 48)
                kw.setdefault("num_classes", 10)
                kw.setdefault("base_examples", 24)
            else:
                kw.setdefault("n_clients", 96)
            return femnist_like(dataset_id=did, seed=0, **kw)
        if self.dataset == "charlm":
            if reduced:
                kw.setdefault("n_clients", 24)
                kw.setdefault("chars_per_client", 120)
            else:
                kw.setdefault("n_clients", 240)
            return charlm(seed=3, **kw)
        if self.dataset == "cifar":
            if reduced:
                kw.setdefault("n_clients", 24)
                kw.setdefault("num_classes", 10)
                kw.setdefault("dim", 32)
                kw.setdefault("per_client", 16)
            else:
                kw.setdefault("n_clients", 64)
            return cifar_like(**kw)
        raise ValueError(f"scenario {self.name!r}: unknown dataset {self.dataset!r}")

    def build_model(self, dataset):
        """Returns ``(init_fn, loss_fn, accuracy_fn)`` for the scenario's
        model (the GRU for ``charlm``, else the MLP), sized by ``hidden``."""
        from repro_torch.models.simple import gru_lm, mlp_classifier

        if self.dataset == "charlm":
            return gru_lm(dataset.num_classes, hidden=self.hidden, layers=2)
        return mlp_classifier(dataset.input_dim, dataset.num_classes, hidden=self.hidden)


SCENARIOS: dict = {}


def register(scenario: Scenario) -> Scenario:
    """Add a scenario to the registry (unique names enforced)."""
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    """Look up a registered scenario; the error names every registered one."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {', '.join(list_scenarios())}"
        ) from None


def list_scenarios() -> list:
    """Sorted names of every registered scenario."""
    return sorted(SCENARIOS)


def _fl(**kw) -> FLConfig:
    base = dict(n_clients=32, expected_clients=3, sampler="aocs", local_steps=8,
                lr_local=0.125)
    base.update(kw)
    return FLConfig(**base)


def _build_grid():
    # FedAvg on FEMNIST datasets 1-3 (Sec. 4.2, Figs. 3-5): OCS vs the two
    # baselines; uniform needs the paper's smaller step size.
    for did in (1, 2, 3):
        for sampler, m, lr in (
            ("full", 32, 0.125), ("aocs", 3, 0.125), ("uniform", 3, 0.03125),
        ):
            register(Scenario(
                name=f"femnist{did}-fedavg-{sampler}",
                dataset=f"femnist{did}",
                fl=_fl(sampler=sampler, expected_clients=m, lr_local=lr),
                paper=f"Sec. 4.2 Figs. 3-5 (FEMNIST dataset {did}, {sampler})",
            ))
    # DSGD (Sec. 4.1): exact Eq. 7 probabilities vs uniform, R=1 local step.
    for sampler, lr in (("optimal", 0.0625), ("uniform", 0.03125)):
        register(Scenario(
            name=f"femnist1-dsgd-{sampler}",
            dataset="femnist1",
            fl=_fl(algorithm="dsgd", sampler=sampler, local_steps=1,
                   lr_local=lr, lr_global=0.5),
            paper=f"Sec. 4.1 (DSGD, {sampler})",
        ))
    # Shakespeare-like char LM (Sec. 4.2, Figs. 6-7).
    for sampler, lr in (("aocs", 1.0), ("uniform", 0.5)):
        register(Scenario(
            name=f"charlm-fedavg-{sampler}",
            dataset="charlm",
            fl=_fl(sampler=sampler, expected_clients=2, local_steps=6, lr_local=lr),
            batch_size=8,
            paper=f"Sec. 4.2 Figs. 6-7 (Shakespeare, {sampler})",
        ))
    register(Scenario(
        name="cifar-fedavg-aocs",
        dataset="cifar",
        fl=_fl(local_steps=5, lr_local=0.0625),
        paper="Appendix G (balanced pool control)",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-q0.7",
        dataset="femnist1",
        fl=_fl(availability=0.7),
        paper="Appendix E (partial availability, q=0.7)",
    ))
    # OCS composed with unbiased compression (Sec. 6 future work).
    register(Scenario(
        name="femnist1-fedavg-aocs-randk",
        dataset="femnist1",
        fl=_fl(compression="randk", compression_param=0.1),
        paper="Sec. 6 future work (rand-k x OCS)",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-scan",
        dataset="femnist1",
        fl=_fl(round_engine="scan", scan_group=4, cache_groups=4),
        paper="Sec. 4.2 grid cell on the single-pass scan engine",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-pallas",
        dataset="femnist1",
        fl=_fl(agg_backend="pallas"),
        paper="Sec. 4.2 grid cell on the fused pallas aggregate",
    ))
    # the mesh round: clients sharded over the ranks, explicit collectives
    register(Scenario(
        name="femnist1-fedavg-aocs-shard",
        dataset="femnist1",
        fl=_fl(agg_backend="pallas"),
        sharded=True,
        paper="Sec. 4.2 grid cell on the shard_map round (per-shard kernel + one psum)",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-shard-randk",
        dataset="femnist1",
        fl=_fl(agg_backend="pallas", compression="randk", compression_param=0.1),
        sharded=True,
        paper="Sec. 6 future work (rand-k x OCS) on the shard_map round",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-shard-q0.7-natural",
        dataset="femnist1",
        fl=_fl(availability=0.7, compression="natural"),
        sharded=True,
        paper="Appendix E x natural compression on the shard_map round",
    ))
    # --- system-realism column: the client-state layer ---------------------
    # Markov availability chains (stationary pi = p_up/(p_up+p_down) = 0.7,
    # sticky: mixing rate 0.5), the degenerate chain that IS Appendix E's
    # i.i.d. Bernoulli(0.7), round deadlines with over-selection, mid-round
    # dropout faults, and the fully adversarial straggler combination.
    markov = SystemConfig(p_up=0.35, p_down=0.15)
    bernoulli_q = SystemConfig(p_up=0.7, p_down=0.3)  # degenerate: i.i.d. q=0.7
    deadline = SystemConfig(latency_mu=0.0, latency_sigma=0.75, deadline=2.0)
    dropout = SystemConfig(drop_prob=0.15)
    straggler = SystemConfig(p_up=0.35, p_down=0.15, latency_mu=0.0,
                             latency_sigma=1.0, deadline=2.0, drop_prob=0.1)
    register(Scenario(
        name="femnist1-fedavg-aocs-markov",
        dataset="femnist1", fl=_fl(), system=markov,
        paper="Appendix E generalized: correlated Markov availability (pi=0.7)",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-markov-iid",
        dataset="femnist1", fl=_fl(), system=bernoulli_q,
        paper="Appendix E via the degenerate chain (i.i.d. Bernoulli q=0.7)",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-deadline",
        dataset="femnist1", fl=_fl(over_select=1.5), system=deadline,
        paper="system realism: round deadline + 1.5x over-selection",
    ))
    register(Scenario(
        name="femnist1-fedavg-uniform-deadline",
        dataset="femnist1",
        fl=_fl(sampler="uniform", lr_local=0.03125, over_select=1.5),
        system=deadline,
        paper="system realism: deadline cell, uniform-sampling baseline",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-dropout",
        dataset="femnist1", fl=_fl(), system=dropout,
        paper="system realism: mid-round dropout fault injection (15%)",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-straggler",
        dataset="femnist1", fl=_fl(over_select=2.0), system=straggler,
        paper="system realism: Markov chains x deadline x dropout, 2x over-selection",
    ))
    register(Scenario(
        name="femnist2-fedavg-aocs-markov",
        dataset="femnist2", fl=_fl(), system=markov,
        paper="Markov availability on FEMNIST dataset 2",
    ))
    register(Scenario(
        name="charlm-fedavg-aocs-dropout",
        dataset="charlm",
        fl=_fl(expected_clients=2, local_steps=6, lr_local=1.0),
        batch_size=8, system=dropout,
        paper="mid-round dropout on the Shakespeare-like char LM",
    ))
    register(Scenario(
        name="cifar-fedavg-aocs-deadline",
        dataset="cifar",
        fl=_fl(local_steps=5, lr_local=0.0625, over_select=1.5),
        system=deadline,
        paper="deadline + over-selection on the balanced-pool control",
    ))
    register(Scenario(
        name="femnist1-dsgd-optimal-markov",
        dataset="femnist1",
        fl=_fl(algorithm="dsgd", sampler="optimal", local_steps=1,
               lr_local=0.0625, lr_global=0.5),
        system=markov,
        paper="Sec. 4.1 DSGD (exact Eq. 7) under Markov availability",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-straggler-scan",
        dataset="femnist1",
        fl=_fl(round_engine="scan", scan_group=4, cache_groups=4,
               over_select=2.0),
        system=straggler,
        paper="straggler cell on the single-pass scan engine",
    ))
    register(Scenario(
        name="femnist1-fedavg-aocs-straggler-shard",
        dataset="femnist1",
        fl=_fl(agg_backend="pallas", over_select=2.0),
        system=straggler, sharded=True,
        paper="straggler cell on the shard_map round (trace replicated)",
    ))
    # --- sampler-zoo column: alternative client-selection rules
    # from the literature, each a pluggable SAMPLERS entry running through
    # the same sampling_plan contract (availability, over-selection and all
    # engines unchanged).  clustered = arXiv 2105.05883, cyclic = arXiv
    # 2302.03662 (stateful window schedule), threshold = arXiv 2007.15197
    # (stateful adaptive norm threshold).
    for did in (1, 2):
        register(Scenario(
            name=f"femnist{did}-fedavg-clustered",
            dataset=f"femnist{did}",
            fl=_fl(sampler="clustered"),
            paper=f"arXiv 2105.05883 (clustered sampling, FEMNIST dataset {did})",
        ))
        register(Scenario(
            name=f"femnist{did}-fedavg-threshold",
            dataset=f"femnist{did}",
            fl=_fl(sampler="threshold"),
            paper=f"arXiv 2007.15197 (adaptive threshold, FEMNIST dataset {did})",
        ))
    register(Scenario(
        name="femnist1-fedavg-cyclic",
        dataset="femnist1",
        fl=_fl(sampler="cyclic"),
        paper="arXiv 2302.03662 (cyclic participation windows)",
    ))
    register(Scenario(
        name="femnist1-fedavg-threshold-randk",
        dataset="femnist1",
        fl=_fl(sampler="threshold", compression="randk", compression_param=0.1),
        paper="arXiv 2007.15197 threshold x rand-k compression",
    ))
    register(Scenario(
        name="femnist1-fedavg-clustered-markov",
        dataset="femnist1", fl=_fl(sampler="clustered"), system=markov,
        paper="arXiv 2105.05883 clustered under Markov availability",
    ))
    register(Scenario(
        name="femnist1-fedavg-cyclic-deadline",
        dataset="femnist1",
        fl=_fl(sampler="cyclic", over_select=1.5), system=deadline,
        paper="arXiv 2302.03662 cyclic windows x deadline + over-selection",
    ))
    register(Scenario(
        name="femnist1-fedavg-threshold-straggler",
        dataset="femnist1",
        fl=_fl(sampler="threshold", over_select=2.0), system=straggler,
        paper="arXiv 2007.15197 threshold under the straggler combination",
    ))
    register(Scenario(
        name="femnist1-fedavg-clustered-scan",
        dataset="femnist1",
        fl=_fl(sampler="clustered", round_engine="scan", scan_group=4,
               cache_groups=4),
        paper="arXiv 2105.05883 clustered on the single-pass scan engine",
    ))
    register(Scenario(
        name="femnist1-fedavg-threshold-shard",
        dataset="femnist1",
        fl=_fl(sampler="threshold", agg_backend="pallas"),
        sharded=True,
        paper="arXiv 2007.15197 threshold on the shard_map round "
              "(SamplerState replicated)",
    ))
    register(Scenario(
        name="femnist1-fedavg-cyclic-shard",
        dataset="femnist1",
        fl=_fl(sampler="cyclic"),
        sharded=True,
        paper="arXiv 2302.03662 cyclic windows on the shard_map round",
    ))
    register(Scenario(
        name="femnist1-dsgd-clustered",
        dataset="femnist1",
        fl=_fl(algorithm="dsgd", sampler="clustered", local_steps=1,
               lr_local=0.0625, lr_global=0.5),
        paper="arXiv 2105.05883 clustered with DSGD (R=1 local step)",
    ))



_build_grid()
