"""Production mesh definitions in H100 form — the port of
``repro/launch/mesh.py``.

The meshes are ``DeviceMesh``es of a *fake* process group
(``torch.distributed``'s ``"fake"`` backend) in one process: they hold the
production ranks and their groups, but no collective moves a byte.  The
dry-run (``launch/dryrun.py``) runs a step on fake tensors sharded over them
and counts rank 0's work.

* pod1: ``("data", "model") = (32, 8)`` — 256 GPUs, 32 nodes of 8;
* pod2: ``("pod", "data", "model") = (2, 32, 8)`` — 512 GPUs.

The ``model`` axis is one node's 8-GPU NVLink domain; a group that spans
nodes runs over InfiniBand.  The chip counts are the reference's (its
v5e pods are 16 x 16 and 2 x 16 x 16); the reference's per-leaf specs are
generic in the mesh shape, so they apply here unchanged, but for a batch
that pod2's 64 client-axis GPUs do not divide (32 clients or sequences,
which the reference's 32 do): the dry-run lays it on 'data' and splits
each client's sequences over 'pod' (``sharding.batch_shardings``'
``fit_dims``).

Functions, not module-level constants: importing this module never starts
a process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

GPUS_PER_NODE = 8


def fake_world(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0.

    An existing fake world of another size is replaced (its meshes are then
    stale); any other existing group is an error (the dry-run must never
    run in a real job)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is active; the dry-run needs a fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _mesh(shape: tuple, names: tuple, device: str) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    fake_world(n)
    return DeviceMesh(device, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device: str = "cuda",
                    n_pod: int | None = None) -> DeviceMesh:
    """Small mesh for tests (``device='cpu'`` in CPU tests); with ``n_pod``
    a ``("pod", "data", "model")`` mesh shaped as pod2 is."""
    if n_pod is None:
        return _mesh((n_data, n_model), ("data", "model"), device)
    return _mesh((n_pod, n_data, n_model), ("pod", "data", "model"), device)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of any mesh with the
    reference's ``axis_names`` and ``devices`` (the duck-typed meshes of
    ``sharding.py`` and of the tests)."""
    if hasattr(mesh, "mesh_dim_names"):
        # sizes, not ``mesh.mesh``: a submesh's rank tensor is made lazily,
        # which fails under a fake-tensor mode
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def client_axes(mesh) -> tuple:
    """Mesh axes the FL client dimension is sharded over."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


# H100 constants for the roofline model: spec-sheet figures of the card the
# port runs on (NVIDIA H100 80GB HBM3, 700.00 W), not measurements.
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12                  # HBM3 bytes/s per GPU
NVLINK_BW = 450e9                 # bytes/s per direction per GPU, group within a node
IB_BW = 50e9                      # bytes/s per GPU (NDR, 400 Gb/s), group across nodes
