"""The 1-D client mesh of the shard round, on ``torch.distributed``.

The counterpart of the reference's ``jax.make_mesh((shards,),
(fl.client_axis,))`` (``repro/sim/driver.py::build_client_mesh``), plus the
launcher that torch needs and JAX does not: under JAX one process drives
every device of the mesh, here each rank is a process of its own.

* :class:`ClientMesh` — the process group, ``rank``, ``world_size``, the
  axis name, the rank's ``device``, and the three collectives the round
  takes: :meth:`~ClientMesh.all_gather` (tiled, in rank order),
  :meth:`~ClientMesh.all_reduce` (sum) and :meth:`~ClientMesh.pmean`.
* :func:`init_client_mesh` — join a process group as one rank.
* :func:`spawn_mesh` — run a function on ``world_size`` fresh ranks.

Transport: the tensors go straight to the collective, on either backend —
NCCL takes CUDA tensors, and gloo takes CPU tensors and, staging them
through host memory itself, CUDA tensors.  So several ranks can share one
card on gloo (NCCL refuses two ranks of one communicator on one device),
with the round's compute on the card.  A backend that fails to initialise
raises; nothing falls back to another backend.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch._device import resolve_device

BACKENDS = ("nccl", "gloo")


class ClientMesh:
    """One rank's view of the 1-D client mesh.

    ``group`` is the process group, ``device`` the rank's device.  Each rank
    owns ``n_clients / world_size`` clients, the ``rank``-th block of them.
    :meth:`close` destroys the process group when the mesh started it
    (``owned``) and removes ``store_dir``, the directory of its
    ``FileStore``, when given.
    """

    def __init__(self, group, device, axis_name: str = "data", *, owned: bool = False,
                 store_dir=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.device = _rank_device(device)
        self.axis_name = axis_name
        self._owned = owned
        self._store_dir = store_dir

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(k, ...)`` tensor, concatenated in rank order:
        ``(world_size * k, ...)`` (``jax.lax.all_gather(..., tiled=True)``)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks (``jax.lax.psum``), written into ``x`` when
        it is contiguous; returns the sum."""
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of the ``(world_size * k, ...)`` tensor
        ``x``, of which this rank keeps its ``rank``-th block of axis 0:
        ``(k, ...)`` (``jax.lax.psum_scatter(x, axis, scatter_dimension=0,
        tiled=True)``).  One ``reduce_scatter_tensor`` on either backend."""
        x = x.contiguous()
        out = torch.empty((x.shape[0] // self.world_size,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks, written into ``x`` as
        :meth:`all_reduce` does."""
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks (``jax.lax.pmean``), written into ``x``
        as :meth:`all_reduce` does."""
        return self.all_reduce(x) / self.world_size

    def barrier(self) -> None:
        """Return once every rank has reached this call: an all-reduce of one
        element, read back on the host (the same call on either backend)."""
        self.all_reduce(torch.zeros((1,), device=self.device)).cpu()

    def close(self) -> None:
        """Destroy the process group if this mesh started it."""
        if self._owned:
            self._owned = False
            dist.destroy_process_group(self.group)
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None


def _rank_device(device=None) -> torch.device:
    """The rank's device with its index: ``None`` means the current CUDA
    device (and raises without one)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_backend(backend: str, device: torch.device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {device}")


def init_client_mesh(world_size: int, rank: int, *, backend: str, init_method: str,
                     device=None, axis_name: str = "data", timeout_s: float = 300.0,
                     store_dir=None) -> ClientMesh:
    """Join the world's process group as ``rank`` of ``world_size`` and
    return its :class:`ClientMesh`.

    ``init_method`` is the rendezvous (``file://<path>`` for a ``FileStore``,
    so no port is taken); ``timeout_s`` bounds the rendezvous and every
    collective.  ``device=None`` means CUDA.  ``store_dir``, when given, is
    the directory the mesh removes when it closes.  Raises if the backend
    fails to initialise.
    """
    dev = _rank_device(device)
    _check_backend(backend, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None,
    )
    return ClientMesh(dist.group.WORLD, dev, axis_name, owned=True, store_dir=store_dir)


def local_client_mesh(device=None, axis_name: str = "data") -> ClientMesh:
    """A world of one rank in this process (NCCL on CUDA, gloo on the CPU),
    with its ``FileStore`` in a temporary directory that :meth:`ClientMesh.close`
    removes."""
    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="client_mesh_")
    return init_client_mesh(
        1, 0, backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"file://{os.path.join(tmp, 'store')}", device=dev,
        axis_name=axis_name, store_dir=tmp,
    )


def _rank_main(fn, args, rank, world_size, backend, init_method, device, timeout_s,
               results) -> None:
    """A spawned rank: join the mesh, run ``fn(mesh, *args)``, report."""
    mesh = None
    try:
        mesh = init_client_mesh(world_size, rank, backend=backend,
                                init_method=init_method, device=device,
                                timeout_s=timeout_s)
        out = fn(mesh, *args)
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if mesh is not None:
            mesh.close()


def spawn_mesh(fn, world_size: int, backend: str, timeout_s: float, *, device=None,
               args=()) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` new ranks; returns their
    results in rank order.

    Each rank is a fresh interpreter (the ``spawn`` start method: CUDA does
    not survive a fork) that joins one process group through a ``FileStore``
    in a temporary directory, so concurrent calls never share a port.
    ``fn`` must be importable by name (a module-level function) and return a
    picklable value (tensors on the CPU).  ``device=None`` means CUDA, as
    everywhere in the port, and raises without a card: rank ``r`` on
    ``cuda:r`` under NCCL, every rank on the current CUDA device under gloo
    (gloo can share one card).  A device given puts every rank there;
    ``device='cpu'`` runs the ranks on the CPU (gloo only).

    If a rank fails, or ``timeout_s`` passes first, every rank is killed and
    ``RuntimeError`` / ``TimeoutError`` is raised: no rank is left waiting
    in a collective.
    """
    if device is None:
        device = _rank_device(None)
        per_rank = backend == "nccl"
    else:
        device = resolve_device(device)
        per_rank = False
    _check_backend(backend, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="client_mesh_")
    init_method = f"file://{os.path.join(tmp, 'store')}"
    procs = []
    try:
        for rank in range(world_size):
            dev = torch.device("cuda", rank) if per_rank else device
            procs.append(ctx.Process(
                target=_rank_main,
                args=(fn, tuple(args), rank, world_size, backend, init_method, dev,
                      timeout_s, results),
                daemon=True,
            ))
            procs[-1].start()
        done = {}
        deadline = time.monotonic() + timeout_s
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn_mesh: {world_size - len(done)} of {world_size} ranks "
                    f"did not finish within {timeout_s} s"
                )
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in done]
                if dead:
                    raise RuntimeError(
                        f"spawn_mesh: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} without a result"
                    ) from None
                continue
            if not ok:
                raise RuntimeError(f"spawn_mesh: rank {rank} failed:\n{payload}")
            done[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [done[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
