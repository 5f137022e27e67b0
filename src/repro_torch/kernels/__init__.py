"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version, with the public wrappers in ``ops``:

* masked_aggregate — Eq. 2's masked scale-&-aggregate
  ``sum_i mask_i * (w_i/p_i) * U_i`` in one pass over the updates
  (replaces ``repro/kernels/masked_aggregate.py``);
* norm_aggregate — per-client squared norms, and the fused norm + Eq. 2
  aggregate with and without in-stream compression (replace
  ``repro/kernels/client_norm.py`` and ``repro/kernels/norm_aggregate.py``);
* sharded_aggregate — a rank's half of Eq. 2 on the mesh round, with and
  without in-stream compression (replaces
  ``repro/kernels/sharded_aggregate.py``);
* flash_attention — causal attention with an optional sliding window and
  bidirectional prefix, online softmax over key tiles (replaces
  ``repro/kernels/flash_attention.py``);
* ssd_scan — the chunked Mamba2 SSD scan with its carried state (replaces
  ``repro/kernels/ssd_scan.py``);
* update_cache — the scan engine's bounded update cache and its per-group
  post-plan contraction on either backend.

Kernels are compiled by ``_build`` from ``csrc/`` at first use, never at
import.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
