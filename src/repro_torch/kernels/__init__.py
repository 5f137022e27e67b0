"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version, with the public wrappers in ``ops``:

* masked_aggregate — Eq. 2's masked scale-&-aggregate
  ``sum_i mask_i * (w_i/p_i) * U_i`` in one pass over the updates
  (replaces ``repro/kernels/masked_aggregate.py``).

Kernels are compiled by ``_build`` from ``csrc/`` at first use, never at
import.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
