"""Scenario registry: the cells of the paper's Sec. 4 grid that the port runs.

A copy of the reference's registry (``repro/sim/scenarios.py``) restricted
to what this slice of the port can run — the MLP cells on the vmap engine
without compression, the client-state layer or a mesh — with field values
identical to the reference's, so one name means one run in both packages:

* ``femnist{1,2,3}-fedavg-{full,aocs,uniform}`` (Sec. 4.2, Figs. 3-5)
* ``femnist1-dsgd-{optimal,uniform}`` (Sec. 4.1)
* ``cifar-fedavg-aocs`` (Appendix G)
* ``femnist1-fedavg-aocs-q0.7`` (Appendix E)
* ``femnist1-fedavg-aocs-pallas`` (the Eq. 2 aggregate on the CUDA kernel)

Any other name raises ``KeyError``: a reference cell not ported yet, or an
unknown one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.configs.base import FLConfig


@dataclass(frozen=True)
class Scenario:
    """One cell of the paper's experiment grid, fully parameterized.

    ``dataset`` names a synthetic factory (``femnist1|femnist2|femnist3``,
    ``cifar``); ``dataset_kw`` overrides its defaults; ``paper`` records the
    section/figure the cell reproduces.  ``sharded`` and ``system`` keep the
    reference's fields and are always ``False``/``None`` in this slice.
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
    system: None = None
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
        from repro_torch.data import cifar_like, femnist_like

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
        """Returns ``(init_fn, loss_fn, accuracy_fn)`` for the scenario's MLP."""
        from repro_torch.models.simple import mlp_classifier

        return mlp_classifier(dataset.input_dim, dataset.num_classes, hidden=self.hidden)


SCENARIOS: dict = {}


def register(scenario: Scenario) -> Scenario:
    """Add a scenario to the registry (unique names enforced)."""
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    """Look up a registered scenario; the error names every ported one."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"scenario {name!r} is not ported yet (or unknown); the port runs: "
            f"{', '.join(list_scenarios())}"
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
    register(Scenario(
        name="femnist1-fedavg-aocs-pallas",
        dataset="femnist1",
        fl=_fl(agg_backend="pallas"),
        paper="Sec. 4.2 grid cell on the fused pallas aggregate",
    ))


_build_grid()
