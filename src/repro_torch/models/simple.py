"""The MLP classifier of the femnist and cifar cells, in the reference's
parameter layout (``repro/models/simple.py``).

Parameters are a dict ``w1 (in, hidden), b1, w2, b2, w3, b3`` used as
``x @ w1 + b1`` — jax's layout, not ``nn.Linear``'s transposed weight — so
that the reference's parameters convert leaf by leaf and the client-major
update matrix has the same columns in both packages.  The char-LM ``gru_lm``
comes with the charlm slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import rng


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean token negative log-likelihood (``repro/models/model.py``)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def mlp_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits of the three-layer ReLU MLP with parameter dict ``p``."""
    h = torch.relu(x @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return h @ p["w3"] + p["b3"]


def mlp_init(key: torch.Tensor, input_dim: int, num_classes: int, hidden: int) -> dict:
    """Random parameters on ``key``'s device, drawn as the reference draws them."""
    k1, k2, k3 = rng.split(key, 3)
    dev = key.device
    s1 = 1 / torch.sqrt(torch.tensor(float(input_dim), device=dev))
    s2 = 1 / torch.sqrt(torch.tensor(float(hidden), device=dev))
    return {
        "w1": rng.normal(k1, (input_dim, hidden)) * s1,
        "b1": torch.zeros((hidden,), device=dev),
        "w2": rng.normal(k2, (hidden, hidden)) * s2,
        "b2": torch.zeros((hidden,), device=dev),
        "w3": rng.normal(k3, (hidden, num_classes)) * s2,
        "b3": torch.zeros((num_classes,), device=dev),
    }


class MLPClassifier(nn.Module):
    """Three-layer ReLU MLP over flat features, with parameters in jax's layout."""

    def __init__(self, input_dim: int, num_classes: int, hidden: int = 128,
                 key: torch.Tensor | None = None):
        super().__init__()
        key = rng.PRNGKey(0) if key is None else key
        params = mlp_init(key, input_dim, num_classes, hidden)
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_logits(dict(self.named_parameters()), x)


def mlp_classifier(input_dim: int, num_classes: int, hidden: int = 128):
    """``(init, loss, accuracy)`` over parameter dicts, like the reference:
    ``init(key) -> params``, ``loss(params, batch) -> (ce, {"ce": ce})``,
    ``accuracy(params, batch) -> scalar``."""

    def init(key):
        return mlp_init(key, input_dim, num_classes, hidden)

    def loss(p, batch):
        ce = cross_entropy(mlp_logits(p, batch["x"]), batch["y"])
        return ce, {"ce": ce}

    def accuracy(p, batch):
        pred = torch.argmax(mlp_logits(p, batch["x"]), dim=-1)
        return torch.mean((pred == batch["y"].long()).to(torch.float32))

    return init, loss, accuracy
