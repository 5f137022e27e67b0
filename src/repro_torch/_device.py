"""Device resolution for the port's entry points.

The port runs on the GPU unless the caller asks for the CPU: ``None`` means
``"cuda"``, and a missing CUDA device is an error rather than a quiet CPU
run, so a timing or a chip check can never measure the wrong device.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by "
            "default — pass device='cpu' to run it on the CPU"
        )
    return dev


def upload(array, device) -> torch.Tensor:
    """A host array on ``device`` without a stream sync: a CUDA target gets
    a pinned copy sent with ``non_blocking=True`` (the caching host
    allocator keeps the pinned block until the copy is done), where a copy
    from pageable memory would wait for the stream.  A tensor already on
    ``device`` (or any tensor, with ``device=None``) comes back as it is."""
    t = array if isinstance(array, torch.Tensor) else torch.from_numpy(np.asarray(array))
    dev = t.device if device is None else torch.device(device)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
