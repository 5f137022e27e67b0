"""Server and client optimizers (functional, over nested dicts of tensors)
and learning-rate schedules, ported from ``repro/optim``."""

from repro_torch.optim.optim import Optimizer, adam, sgd  # noqa: F401
from repro_torch.optim.schedules import constant, cosine, inverse_decay  # noqa: F401
