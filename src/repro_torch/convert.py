"""Parameter conversion from the reference to the port.

``params_from_jax`` takes the reference's parameter tree as numpy arrays
(``jax.device_get`` of it, or ``np.asarray`` per leaf) and returns the same
tree of torch tensors on ``device``, keyed by leaf name — the port's models
use the reference's layout, so no leaf is transposed.  The parity tests use
it so that both packages start from identical weights.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays -> the same dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
