"""Parameter conversion from the reference to the port.

``params_from_jax`` takes the reference's parameter tree as numpy arrays
(``jax.device_get`` of it, or ``np.asarray`` per leaf) and returns the same
tree of torch tensors on ``device``, keyed by leaf name — the port's models
use the reference's layout, so no leaf is transposed.  The parity tests use
it so that both packages start from identical weights.

Every leaf crosses bit for bit.  ``np.asarray`` of a jax bfloat16 array has
dtype ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` cannot take; such a
leaf crosses as its 16-bit pattern (``view(np.uint16)``) and is viewed back
as ``torch.bfloat16``.  Every other dtype goes through ``from_numpy`` as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays -> the same dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)
