"""Synthetic federated datasets (numpy), copied from the reference."""

from repro_torch.data.synthetic import (  # noqa: F401
    FederatedDataset,
    cifar_like,
    femnist_like,
)
