"""repro_torch: the PyTorch/CUDA port of ``repro`` (Optimal Client Sampling
for Federated Learning), a package beside the JAX reference.

It mirrors the reference's layout — ``core`` (the paper's samplers and
the Eq. 2 aggregate), ``kernels`` (hand-written CUDA kernels, each with a
plain PyTorch version beside it), ``models``, ``fl`` (the round engine),
``sim`` (the multi-round driver and scenario registry), ``configs``,
``data`` — and imports neither ``jax`` nor ``repro``.  Random decisions use
:mod:`repro_torch.rng`, which reproduces jax's threefry keys bit for bit.

Entry points (``run_simulation``, ``run_scenario``, ``make_engine``) take
``device=None``, meaning CUDA; pass ``device="cpu"`` to run on the CPU.
"""

from repro_torch._device import resolve_device  # noqa: F401
