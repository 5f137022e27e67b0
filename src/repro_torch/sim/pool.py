"""Device-resident client pool: pad once, gather cohorts on the device.

Ported from ``repro/sim/pool.py``.  The host loop rebuilds every round's
cohort batch with numpy fancy indexing and uploads it.  A
:class:`ClientPool` instead pads and stacks the whole ``FederatedDataset``
once into device-resident ``(pool, max_examples, ...)`` buffers; a round's
cohort is then a small index plan (:func:`plan_cohort`: client ids, each
client's example rows, the local-epoch step mask) that one device gather
(:func:`gather_batch`) turns into the ``(n, R, b, ...)`` round batch.

:func:`plan_cohort` consumes the host RNG exactly as
``FederatedDataset.sample_round_batches`` does (one ``rng.permutation(n_i)``
per cohort client, in cohort order), so a gathered batch is bitwise the
host-built one and the driver's masks stay the host loop's.

On a CUDA device the pool runs its uploads and gathers on a side stream of
its own, so the driver can dispatch round k+1's gather while round k's step
runs (``sim/driver.py``, ``mode='prefetch'``): the buffers go up once from
pinned memory, and each round's plan goes up as ONE packed int32 array from
one of two pinned staging slots used in turn (a slot is refilled only once
the gather that last read it is done, checked by an event), so no call on
the round path waits for the stream.  :meth:`ClientPool.gather` returns the
batch with a ready event; :func:`claim_batch` makes the current stream wait
for it and records the batch's tensors on that stream.

**Sharded mode** (``ClientPool(dataset, mesh=...)``, the reference's):
the pool's rows are padded to a multiple of the mesh's world size and each
rank uploads only its block of ``rows_per_shard`` rows.  A gather then runs
on every rank: the host computes each cohort position's owner rank and
local row (the cohort's order is untouched), each rank gathers the
positions it owns from its block (the others read row 0 and are zeroed),
and one :meth:`~repro_torch.fl.mesh.ClientMesh.reduce_scatter` hands each
rank its ``(n / world_size, R, b, ...)`` block of the cohort (the
reference's ``psum_scatter``).  The client-state layer (``SystemConfig``,
``ClientState``) comes with the system-realism slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device

# fold constant deriving the client-state key from the round key (the
# reference's; the client-state layer that consumes it is not ported yet)
STATE_FOLD = 7


class RoundPlan(NamedTuple):
    """One round's cohort, as host index arrays (the only per-round host work).

    ``clients``: (n,) int32 pool rows; ``take``: (n, R, b) int32 per-client
    example rows; ``step_mask``: (n, R) f32 local-epoch step mask (see
    ``FederatedDataset.sample_round_batches``).
    """

    clients: np.ndarray
    take: np.ndarray
    step_mask: np.ndarray


class PlanLayout(NamedTuple):
    """Where the parts of a packed plan (:meth:`ClientPool.pack`) lie:
    ``shape`` the ``(n, R, b)`` of its example rows, ``sizes`` the words of
    each part, in order."""

    shape: tuple
    sizes: tuple

    def rows(self, packed):
        """The packed plan's first part: the cohort's pool rows (its client
        ids without a mesh)."""
        return packed[:self.sizes[0]]


def plan_cohort(rng, sizes, clients, max_steps, batch_size, local_epoch=True) -> RoundPlan:
    """Draw one round's example indices, RNG-compatible with the host path.

    Consumes ``rng`` exactly like ``FederatedDataset.sample_round_batches``
    (one ``rng.permutation(n_i)`` per client, in cohort order) and computes
    the same cyclic ``np.resize`` fill and local-epoch step mask, so a gather
    of this plan is bitwise the host-built batch.
    """
    clients = np.asarray(clients)
    take = np.empty((len(clients), max_steps, batch_size), np.int32)
    step_mask = np.empty((len(clients), max_steps), np.float32)
    for i, ci in enumerate(clients):
        n = int(sizes[int(ci)])
        steps_i = (
            max(1, min(max_steps, -(-n // batch_size))) if local_epoch else max_steps
        )
        perm = rng.permutation(n)
        take[i] = np.resize(perm, (max_steps, batch_size))
        step_mask[i] = (np.arange(max_steps) < steps_i).astype(np.float32)
    return RoundPlan(clients.astype(np.int32), take, step_mask)


def stack_plans(plans) -> tuple:
    """Stack a block of round plans into ``(rounds, ...)`` host arrays
    (the reference's scan-over-rounds input)."""
    return (
        np.stack([p.clients for p in plans]),
        np.stack([p.take for p in plans]),
        np.stack([p.step_mask for p in plans]),
    )


def gather_batch(buffers: dict, clients: torch.Tensor, take: torch.Tensor,
                 step_mask: torch.Tensor) -> dict:
    """Pool buffers -> the ``(n, R, b, ...)`` round batch, one gather per key.

    ``buffers[k][clients[:, None, None], take]`` reads the ``(n, R, b)``
    example rows straight out of the ``(pool, max_examples, ...)`` buffer;
    no ``(n, max_examples, ...)`` intermediate is made.
    """
    rows, cols = clients.long()[:, None, None], take.long()
    batch = {k: buf[rows, cols] for k, buf in buffers.items()}
    batch["_step_mask"] = step_mask
    return batch


class ClientPool:
    """Device-resident padded copy of a ``FederatedDataset``.

    Every data key is stacked into one ``(pool, max_examples, ...)`` buffer
    on ``device`` (``None`` means CUDA; clients padded with zeros up to the
    largest client; plans address real rows only, so padding is never read).
    Built once per simulation; each round is then index generation on the
    host and a gather on the device.

    With ``mesh`` (a :class:`~repro_torch.fl.mesh.ClientMesh`; the pool then
    lies on the mesh's device) the pool is sharded (module docstring): the
    rows pad to a multiple of ``mesh.world_size``, this rank's ``buffers``
    hold its ``rows_per_shard`` rows, and :meth:`gather` returns this rank's
    block of the cohort.
    """

    def __init__(self, dataset, mesh=None, device=None):
        if mesh is not None:
            if device is not None and resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device={device!r}, but the mesh's rank lies on {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        self.n_clients = dataset.n_clients
        self.sizes = np.asarray(dataset.sizes())
        self.max_examples = int(self.sizes.max())
        shards = 1 if mesh is None else mesh.world_size
        rows = self.n_clients + (-self.n_clients) % shards
        self.rows_per_shard = rows // shards
        lo = 0 if mesh is None else mesh.rank * self.rows_per_shard
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self._slots: list = []          # pinned staging: [tensor, event or None] x 2
        self._turn = 0
        buffers = {}
        for k, first in dataset.client_data[0].items():
            buf = np.zeros((rows, self.max_examples) + first.shape[1:], first.dtype)
            for i, d in enumerate(dataset.client_data):
                buf[i, : len(d[k])] = d[k]
            buffers[k] = self._upload(torch.from_numpy(buf[lo:lo + self.rows_per_shard]))
        self.buffers = buffers

    @property
    def nbytes(self) -> int:
        """Device bytes held by the padded pool buffers (global: every
        rank's block, as the reference counts a sharded pool)."""
        shards = 1 if self.mesh is None else self.mesh.world_size
        return shards * sum(b.numel() * b.element_size() for b in self.buffers.values())

    def plan(self, rng, clients, max_steps, batch_size, local_epoch=True) -> RoundPlan:
        """:func:`plan_cohort` bound to this pool's client sizes."""
        return plan_cohort(rng, self.sizes, clients, max_steps, batch_size, local_epoch)

    def _upload(self, host: torch.Tensor) -> torch.Tensor:
        if self.stream is None:
            return host.to(self.device)
        with torch.cuda.stream(self.stream):
            return host.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, size: int) -> list:
        """The next pinned staging slot ``[tensor of size int32 words, event
        of its last gather]``, free to refill."""
        if not self._slots or self._slots[0][0].numel() != size:
            self._slots = [[torch.empty((size,), dtype=torch.int32, pin_memory=True), None]
                           for _ in range(2)]
        slot = self._slots[self._turn]
        self._turn ^= 1
        if slot[1] is not None and not slot[1].query():
            slot[1].synchronize()       # only if its gather two rounds ago still runs
        return slot

    def pack(self, plan: RoundPlan) -> tuple:
        """One round's plan as flat int32 words and their :class:`PlanLayout`:
        the cohort's pool rows (on a mesh: each position's local row, then
        after the example rows which positions this rank owns), the example
        rows, and the float bits of the step mask (on a mesh: this rank's
        block of it).  :meth:`gather_packed` reads them."""
        rows, step_mask = plan.clients, plan.step_mask
        parts = [rows, plan.take.reshape(-1)]
        if self.mesh is not None:
            # the owner rank and local row of every cohort position, in
            # cohort order; this rank's block of the step mask
            own = rows // self.rows_per_shard == self.mesh.rank
            rows = np.where(own, rows % self.rows_per_shard, 0)
            k = len(rows) // self.mesh.world_size
            step_mask = step_mask[self.mesh.rank * k:(self.mesh.rank + 1) * k]
            parts = [rows, plan.take.reshape(-1), own]
        parts.append(np.ascontiguousarray(step_mask, np.float32).view(np.int32).reshape(-1))
        parts = [np.asarray(p).astype(np.int32) for p in parts]
        return np.concatenate(parts), PlanLayout(plan.take.shape, tuple(p.size for p in parts))

    def gather(self, plan: RoundPlan) -> tuple:
        """Dispatch the device gather of one round's batch (this rank's
        block of it on a mesh); returns ``(batch, ready)``.

        On a CUDA device the plan goes up as one packed int32 array
        (:meth:`pack`) from a pinned staging slot, and the copy, the gather
        and the mesh's reduce-scatter run on the pool's stream; ``ready`` is
        an event recorded after them (``None`` on the CPU).  Hand both to
        :func:`claim_batch` before the batch is read on another stream.
        """
        words, layout = self.pack(plan)
        if self.stream is None:
            return self.gather_packed(torch.from_numpy(words), layout), None
        slot = self._stage(words.size)
        np.copyto(slot[0].numpy(), words)
        with torch.cuda.stream(self.stream):
            packed = slot[0].to(self.device, non_blocking=True)
            batch = self.gather_packed(packed, layout)
            # one event: the slot is free to refill, and the batch is ready
            slot[1] = ready = torch.cuda.Event()
            ready.record(self.stream)
        return batch, ready

    def gather_packed(self, packed: torch.Tensor, layout: PlanLayout) -> dict:
        """The batch of a packed plan (:meth:`pack`) that lies on this pool's
        device, gathered on the current stream (the scan mode calls it inside
        its captured round body)."""
        parts = torch.split(packed, layout.sizes)
        shape = layout.shape
        rows, take, step_mask = parts[0], parts[1].view(shape), parts[-1].view(torch.float32)
        step_mask = step_mask.view(-1, shape[1])
        batch = gather_batch(self.buffers, rows, take, step_mask)
        if self.mesh is None:
            return batch
        other = parts[2] == 0
        for k, v in batch.items():
            if k != "_step_mask":
                # positions another rank owns are zero here, so the sum over
                # the ranks is each position's owner's rows, bit for bit
                v = v.masked_fill(other.view((-1,) + (1,) * (v.dim() - 1)), 0)
                batch[k] = self.mesh.reduce_scatter(v)
        return batch


def claim_batch(batch: dict, ready) -> dict:
    """Make the current stream wait for a gathered batch (``ready`` from
    :meth:`ClientPool.gather`), and record the batch's tensors on it, so the
    caching allocator does not hand their memory out while the stream still
    reads them.  With ``ready=None`` (the CPU) the batch comes back as it is."""
    if ready is None:
        return batch
    stream = torch.cuda.current_stream(next(iter(batch.values())).device)
    stream.wait_event(ready)
    for t in batch.values():
        t.record_stream(stream)
    return batch
