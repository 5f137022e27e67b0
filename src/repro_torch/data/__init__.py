"""Synthetic federated datasets (numpy), copied from the reference."""

from repro_torch.data.synthetic import (  # noqa: F401
    CHARLM_VOCAB,
    FederatedDataset,
    charlm,
    cifar_like,
    eval_split,
    femnist_like,
    quadratics,
)
