"""Device resolution for the port's entry points.

The port runs on the GPU unless the caller asks for the CPU: ``None`` means
``"cuda"``, and a missing CUDA device is an error rather than a quiet CPU
run, so a timing or a chip check can never measure the wrong device.
"""

from __future__ import annotations

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
