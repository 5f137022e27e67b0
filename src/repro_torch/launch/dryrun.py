"""Multi-node dry-run: every (architecture x input shape) on the production
mesh as a fake-tensor pass over a sharded program, roofline terms per chip,
JSON records — the port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each step through GSPMD on 512 forced
host devices and reads XLA's cost analysis.  The port runs the same step
once on ``FakeTensor``s sharded as ``DTensor``s over a ``DeviceMesh`` of a
fake process group (``launch/mesh.py``), in one process, and counts rank 0's
work while it runs, allocating nothing:

* FLOPs: ``torch.utils.flop_counter``'s formulas on rank 0's *local* ops
  (the matmul-class ops; ops without a formula decompose first, as
  ``FlopCounterMode`` does);
* bytes: input plus output bytes of every local aten op that is not a
  view or a metadata query (``prim.device``) — the port runs eagerly, so
  the unfused traffic is its memory term; a redistribution's own local
  copies are left to the collective term (:func:`_unbilled`);
* collectives: what ``CommDebugMode`` saw DTensor issue, each with its
  result bytes and its group (``roofline.count_collectives``);
* peak memory: rank 0's live local storages, tracked op by op.

Divergences from the reference (each JSON record lists, over the steps
traced for it, its replicated ops, modeled redistributions and sampled loop
iterations, and the depths traced):

* the meshes are H100 nodes of 8 (``(32, 8)``, ``(2, 32, 8)``) and the
  collective term has two links (``launch/roofline.py``); pod2's client
  axes hold 64 GPUs where the reference's hold 32, so its 32 clients lie
  on 'data' and 'pod' splits each client's 8 sequences (the step's mesh
  dims ordered ('data', 'pod', 'model'), and a matmul over the flattened
  clients and sequences planned on plain shards, :func:`_unit_strided_plan`),
  and its 32 prefill sequences lie on 'data' with 'pod' replicated, the
  step then traced on the submesh without it (the record's notes say "pod
  replicated ×2"; :func:`_batch_layout`); the reference replicates a
  batch its client axes do not divide, which on its own pod2 they do;
* bytes are per-op eager bytes, not XLA's fused "bytes accessed";
* every loop iteration is counted (XLA counts a ``while`` body once): a
  block loop that autograd does not record runs its first iteration
  counted n times (``models/layers.py::BlockLoop``; every iteration has the
  same shapes), and a stack deeper than 3 layers runs 2 and 3 layers deep
  on the full-depth arguments, extrapolated (:func:`count_step`);
* ``donate`` has no meaning in torch: the argument is kept and ignored;
* the layout: parameters are stored by ``launch/sharding.py``'s specs and
  gathered over the client axes where used (FSDP, :func:`_fsdp_step`);
  over the model axis it is Megatron's (:func:`_tp_blocks`): each
  sublayer's input and output replicated (:func:`tp_input`), the heads,
  Mamba2's in-projection and the head's vocab sharded (:func:`tp_shard`),
  also where the spec replicates a weight whose dim the axis does not
  divide (whisper-small's vocab) or a shard does not split into whole heads
  (its 12 heads over 8 chips: 2 on each of 6), and every batched product
  (``torch.einsum``) keeps its operands' batch shards (:func:`sharded_einsum`):
  GSPMD lays the reference's step out so, where DTensor's per-op choice
  would shard the residual stream's hidden dim, replicate a product whose
  batch merges a client shard with a head shard, and choose differently
  from one torch version to the next; for the same reason the dry-run
  plans the vmapped embedding gradient (:func:`_index_put_strategy`), the
  embedding's lookup (on the gathered table), Mamba2's splits of its
  in-projection and conv output (gathered once, then resharded) and its
  gated norm's mean (all-reduced);
* the scan engine's group loops run one group of each loop counted n
  times (``fl/engine.py``, ``models/layers.py::BlockLoop``), and a group's
  update runs on the submesh without the client axes, over which its
  slice of the batch is whole (:func:`_without_client_axes`);
* an op for which DTensor has no sharding strategy, or none for its
  operands' placements, runs with the offending mesh dims replicated (the
  last mesh dims first, then all): its inputs are gathered (the gathers
  are counted as collectives) and its work is counted in full on rank 0;
  a redistribution DTensor cannot plan or run is modeled as gathers
  (:func:`_modeled_redistribute`).

The models take their eager forms on fake tensors (``models/layers.py::
chunked_attention``, ``models/ssm.py::ssd_chunked``): a hand-written kernel
reads ``data_ptr()``, which a fake tensor does not have.  The reference's
dry-run likewise costs its jnp models, which call no Pallas kernel.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table [--multi-pod]

The fake tensors carry the mesh's device type: ``cuda`` by default (the
engine's device check needs a card then), ``cpu`` when asked.  Records go to
``dryrun_torch_out/<mesh>/`` at the root of the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import string
import threading
import time
import traceback
import weakref
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._op_schema import OpSchema, OutputSharding, RuntimeSchemaInfo
from torch.distributed.tensor import _collective_utils as CU
from torch.distributed.tensor import _dispatch as DP
from torch.distributed.tensor import _redistribute as RD
from torch.distributed.tensor._ops import utils as OU
from torch.distributed.tensor._ops._mask_buffer import MaskBuffer
from torch.distributed.tensor._dtensor_spec import DTensorSpec
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.fl.engine import RoundEngine
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import GPUS_PER_NODE, axis_sizes, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "../../../dryrun_torch_out")

# long_500k requires a sub-quadratic decode state.  'window' = run with an
# explicit sliding-window variant (documented adaptation); 'skip' = pure
# full-attention arch, no SWA claim in the source model.
LONG_500K_POLICY = {
    "mamba2-130m": "run",        # SSM: O(1) state
    "zamba2-2.7b": "window",     # hybrid: window the shared-attn cache
    "mixtral-8x7b": "run",       # native SWA-4096
    "llama3-8b": "window",       # beyond-paper SWA variant, opt-in
    "llama4-maverick-400b-a17b": "skip",
    "granite-20b": "skip",
    "granite-8b": "skip",
    "gemma-7b": "skip",
    "whisper-small": "skip",     # also: 500k tokens is meaningless for 30s audio
    "paligemma-3b": "skip",
}
WINDOW_VARIANT = 4096


def resolve_config(arch: str, shape: InputShape):
    """Returns (cfg, note) or (None, skip_reason)."""
    cfg = ARCHS[arch]
    if shape.name == "long_500k":
        policy = LONG_500K_POLICY[arch]
        if policy == "skip":
            return None, "skipped: full-attention arch, no sub-quadratic variant"
        if policy == "window":
            return (
                cfg.with_(sliding_window=WINDOW_VARIANT),
                f"sliding-window={WINDOW_VARIANT} variant",
            )
    return cfg, ""


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


# ---------------------------------------------------------------------------
# DTensor: replicate where no sharding strategy fits

_REPLICATED: dict = {}          # op name -> the mesh dims it kept sharded
# a strategy registered here is cached on all of an op's arguments (DTensor's
# default hashes the tensors alone: two slices of one tensor would share a plan)
_EVERY_ARG = RuntimeSchemaInfo(static_argnum=1, needs_pytree=True)
_PLAN_BUDGET = 2048              # states a redistribution plan search may expand
_MODELED = [0]                   # redistributions modeled as gathers (_modeled_redistribute)
_REPLICATED_AXES: dict = {}      # client axis -> size, where a batch left it replicated
_UNCOUNTED = threading.local()   # depth of DTensor's own bookkeeping
_UNBILLED = threading.local()    # depth of a redistribution's local copies


@contextlib.contextmanager
def _uncounted():
    """DTensor's bookkeeping, not the step's work: its sharding
    propagation (shape inference at the global shape, decomposed
    candidates), which runs fake ops of its own on a cache miss only."""
    _UNCOUNTED.depth = getattr(_UNCOUNTED, "depth", 0) + 1
    try:
        yield
    finally:
        _UNCOUNTED.depth -= 1


@contextlib.contextmanager
def _unbilled():
    """Local ops whose bytes are not counted (their FLOPs, collectives and
    storage are): a redistribution's own copies."""
    _UNBILLED.depth = getattr(_UNBILLED, "depth", 0) + 1
    try:
        yield
    finally:
        _UNBILLED.depth -= 1


def _strided_shard(p: _StridedShard, size, num_chunks: int, rank, *args, **kwargs):
    """``_StridedShard.local_shard_size_and_offset`` in closed form: the dim
    cut into ``split_factor`` pieces, each into ``num_chunks`` chunks
    (``torch.chunk``'s sizes), the shard the rank's chunk of every piece.
    DTensor computes it on an index tensor, whose ``tolist()`` a fake tensor
    refuses and which at a model's sizes would fill the host's memory.
    Offsets (asked for by mode: none, the first, or all) are the local
    elements' indices; past 2^22 elements all offsets come as a range from
    the first, which only a real tensor's data would need exact."""
    mode = kwargs.get("offset_mode", args[0] if args else None)
    mode = getattr(mode, "name", "FIRST")
    if kwargs.get("return_first_offset") is False:
        mode = "ALL"
    size, rank, sf = int(size), int(rank), int(p.split_factor)
    piece = -(-size // sf) if size else 0
    local, first, spans = 0, -1, []
    for j in range(sf):
        start = j * piece
        n = max(0, min(piece, size - start))
        c = -(-n // num_chunks) if n else 0
        lo, hi = min(rank * c, n), min(rank * c + c, n)
        if hi > lo:
            first = start + lo if first < 0 else first
            spans.append(range(start + lo, start + hi))
        local += hi - lo
    if mode == "NONE":
        return local, None
    if mode == "ALL":
        if local > 1 << 22:
            return local, range(max(first, 0), max(first, 0) + local)
        return local, [i for r in spans for i in r]
    return local, first


def _strided_split(p: _StridedShard, tensor, num_chunks: int, *, with_padding: bool = True,
                   contiguous: bool = True):
    """``_StridedShard._split_tensor`` in closed form: each rank's shard a new
    fake tensor of the size :func:`_strided_shard` gives.  DTensor chunks
    each of ``split_factor`` pieces into ``num_chunks`` and concatenates,
    fake op by fake op: over the scan engine's flat client matrix (a piece
    per parameter leaf and client) minutes of trace and, on some torch
    versions, the host's memory.  A local slice moves nothing: uncounted."""
    del contiguous
    shards = []
    with _uncounted():
        for r in range(num_chunks):
            shape = list(tensor.shape)
            shape[p.dim] = _strided_shard(p, shape[p.dim], num_chunks, r)[0]
            shards.append(tensor.new_empty(shape))
    top = max(t.shape[p.dim] for t in shards)
    return shards, [top - t.shape[p.dim] for t in shards] if with_padding else []


def _relaxed(schema: OpSchema, keep: int) -> OpSchema:
    """``schema`` with every operand's placements past mesh dim ``keep``
    replicated."""

    def relax(spec: DTensorSpec) -> DTensorSpec:
        pl = tuple(p if i < keep else Replicate() for i, p in enumerate(spec.placements))
        return DTensorSpec(spec.mesh, pl, tensor_meta=spec.tensor_meta)

    return OpSchema(schema.op, tree_map_only(DTensorSpec, relax, schema.args_schema),
                    tree_map_only(DTensorSpec, relax, schema.kwargs_schema),
                    schema_info=schema.schema_info)


class _PlanTooLarge(Exception):
    """DTensor's min-cost redistribution search ran past ``_PLAN_BUDGET``."""


def _modeled_redistribute(local, current: DTensorSpec, target: DTensorSpec):
    """A redistribution DTensor could not plan or run (a strided shard on a
    3-D mesh): every mesh dim whose placement changes is gathered
    (a partial sum all-reduced), issued as collectives on the fake group so
    that they are counted, and the target's local shard is a new fake
    tensor of its shape.  It moves at least what the planned path would."""
    from torch.distributed import _functional_collectives as funcol

    mesh = current.mesh
    for i, (p, q) in enumerate(zip(current.placements, target.placements)):
        if p == q or p.is_replicate():
            continue
        if p.is_partial():
            local = funcol.wait_tensor(funcol.all_reduce(local, "sum", (mesh, i)))
        else:
            local = funcol.wait_tensor(funcol.all_gather_tensor(local, 0, (mesh, i)))
    shape = list(target.shape)
    for i, p in enumerate(target.placements):      # rank 0's shard, mesh dim by mesh dim
        if isinstance(p, (Shard, _StridedShard)):
            shape[p.dim] = p.local_shard_size_and_offset(shape[p.dim], mesh.size(i), 0)[0]
    return local.new_empty(shape)


def _replicate_strategy(op_schema):
    """The one strategy of an op DTensor has none for: every operand and
    every output replicated over the whole mesh."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    inputs = [a for a in (*op_schema.args_schema, *op_schema.kwargs_schema.values())
              if isinstance(a, OpStrategy)]
    mesh = inputs[0].mesh
    rep = (Replicate(),) * mesh.ndim
    targets = [DTensorSpec(mesh, rep, tensor_meta=a.strategies[0].output_spec.tensor_meta)
               for a in inputs]
    n_out = sum(str(r.type) == "Tensor" for r in op_schema.op._schema.returns)
    out = DTensorSpec(mesh, rep) if n_out == 1 else tuple(DTensorSpec(mesh, rep)
                                                          for _ in range(n_out))
    return OpStrategy([OpSpec(output_specs=out, input_specs=tuple(targets),
                              redistribute_cost=[generate_redistribute_costs(a, t)
                                                 for a, t in zip(inputs, targets)])])


def _dims_strategy(op_schema, touched: set, remap=None):
    """An op on one operand that moves data only along the dims in
    ``touched``: its placements kept, a shard of a touched dim replicated
    and a partial sum reduced (some torch versions cannot turn a shard into
    the partial sum a later pointwise op would then ask of its other
    operand); ``remap`` renumbers the dims of the output (a squeeze)."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    src = op_schema.args_schema[0]
    out = []
    for spec in src.strategies:
        s = spec.output_spec
        pl = tuple(Replicate() if p.is_partial() or (
            isinstance(p, (Shard, _StridedShard)) and p.dim in touched) else p
            for p in s.placements)
        target = DTensorSpec(s.mesh, pl, tensor_meta=s.tensor_meta)
        if remap is not None:
            pl = tuple(_StridedShard(remap(p.dim), split_factor=p.split_factor)
                       if isinstance(p, _StridedShard) else
                       Shard(remap(p.dim)) if isinstance(p, Shard) else p for p in pl)
        out.append(OpSpec(output_specs=DTensorSpec(s.mesh, pl), input_specs=(target,),
                          redistribute_cost=[generate_redistribute_costs(src, target)]))
    return OpStrategy(out)


def _dim_list(dims, ndim: int) -> set:
    dims = [dims] if isinstance(dims, int) else list(dims)
    return {d % ndim for d in dims}


def _pad_strategy(op_schema):
    """``constant_pad_nd``: shards of the padded dims replicated (some torch
    versions replicate every operand, which gathers whole attention blocks)."""
    pad = op_schema.args_schema[1]
    ndim = len(op_schema.args_schema[0].shape)
    return _dims_strategy(op_schema, {ndim - 1 - i // 2 for i, n in enumerate(pad) if n})


def _roll_strategy(op_schema):
    ndim = len(op_schema.args_schema[0].shape)
    dims = op_schema.args_schema[2] if len(op_schema.args_schema) > 2 else ()
    return _dims_strategy(op_schema, _dim_list(dims, ndim) if dims else set(range(ndim)))


def _flip_strategy(op_schema):
    ndim = len(op_schema.args_schema[0].shape)
    return _dims_strategy(op_schema, _dim_list(op_schema.args_schema[1], ndim))


def _squeeze_strategy(op_schema):
    shape = op_schema.args_schema[0].shape
    gone = {d for d in _dim_list(op_schema.args_schema[1], len(shape)) if shape[d] == 1}
    return _dims_strategy(op_schema, gone, remap=lambda d: d - sum(g < d for g in gone))


def _index_put_strategy(op_schema):
    """``index_put(self, indices, values)`` (the vmapped embedding
    gradient), mesh dim by mesh dim: a shard of the values on a dim the op
    does not index kept on that dim of self and the output (torch 2.13's
    rule; 2.11 has none, and replicated the (clients, vocab, hidden)
    gradient on every chip); a shard of the values on the dim of a batch
    index (``vmap``'s ``arange`` over the clients, the one index that spans
    that dim) kept as a shard of the dim it indexes, each chip writing its
    own clients; else a shard of self on a dim not indexed kept; a partial
    sum kept; any other mesh dim replicated.  Index tensors are replicated
    but for the batch dim."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    src, idx, vals = op_schema.args_schema[:3]
    idx = [(d, i) for d, i in enumerate(getattr(idx, "children", idx)) if i is not None]
    s_spec, v_spec = src.strategies[0].output_spec, vals.strategies[0].output_spec
    i_specs = [i.strategies[0].output_spec for _, i in idx]
    shape, vshape = s_spec.shape, v_spec.shape
    indexed = [d for d, _ in idx]
    nb = len(torch.broadcast_shapes(*(sp.shape for sp in i_specs)))
    ishapes = [(1,) * (nb - len(sp.shape)) + tuple(sp.shape) for sp in i_specs]
    rest = [("s", d) for d in range(len(shape)) if d not in indexed]
    if indexed == list(range(indexed[0], indexed[0] + len(indexed))):
        layout = ([r for r in rest if r[1] < indexed[0]] + [("b", k) for k in range(nb)]
                  + [r for r in rest if r[1] > indexed[0]])
    else:
        layout = [("b", k) for k in range(nb)] + rest
    off = len(layout) - len(vshape)          # values broadcast from the right
    rep = Replicate()
    pl = {"out": [], "v": [], "i": [[] for _ in idx]}
    for m in range(s_spec.mesh.ndim):
        sp, vp = s_spec.placements[m], v_spec.placements[m]
        out, v, ips = rep, rep, [rep] * len(idx)
        kind, d = layout[vp.dim + off] if type(vp) is Shard else (None, None)
        batch = [j for (j, _), ish in zip(idx, ishapes) if kind == "b" and ish[d] == shape[j]
                 and all(e == 1 for k, e in enumerate(ish) if k != d)]
        if kind == "s":
            out, v = Shard(d), vp
        elif batch:
            out, v = Shard(batch[0]), vp
            ips = [Shard(d - nb + len(sp_k.shape)) if ish[d] > 1 else rep
                   for sp_k, ish in zip(i_specs, ishapes)]
        elif type(sp) is Shard and ("s", sp.dim) in layout:
            vd = layout.index(("s", sp.dim)) - off
            out, v = sp, Shard(vd) if vd >= 0 and vshape[vd] > 1 else rep
        elif sp.is_partial() or vp.is_partial():
            out = v = Partial()
        pl["out"].append(out)
        pl["v"].append(v)
        for k, p in enumerate(ips):
            pl["i"][k].append(p)
    targets = [DTensorSpec(s_spec.mesh, tuple(pl["out"]), tensor_meta=s_spec.tensor_meta)]
    targets += [DTensorSpec(sp.mesh, tuple(p), tensor_meta=sp.tensor_meta)
                for sp, p in zip(i_specs, pl["i"])]
    targets.append(DTensorSpec(v_spec.mesh, tuple(pl["v"]), tensor_meta=v_spec.tensor_meta))
    inputs = [src, *(i for _, i in idx), vals]
    return OpStrategy([OpSpec(output_specs=DTensorSpec(s_spec.mesh, tuple(pl["out"])),
                              input_specs=tuple(targets),
                              redistribute_cost=[generate_redistribute_costs(a, t)
                                                 for a, t in zip(inputs, targets)])])


# ops whose strategies some torch versions lack or make replicate everything
_STRATEGIES = {
    "constant_pad_nd.default": _pad_strategy,
    "roll.default": _roll_strategy,
    "flip.default": _flip_strategy,
    "squeeze.dims": _squeeze_strategy,
    "index_put.default": _index_put_strategy,
}
# the schema information of a strategy, where not the first argument's alone
_SCHEMA_INFO = {"index_put.default": RuntimeSchemaInfo(static_argnum=3, needs_pytree=True)}


def _well_formed(out, has_shape_args: bool, src=None) -> bool:
    """A propagation's plan that DTensor can run: a placement per mesh dim
    in every spec (some strategies give one placement on any mesh), and for
    an op with shape arguments (a view) with a sharded output, shape
    arguments made local and every sharded output dim dividing evenly
    (DTensor's local shape for an uneven one that the view splits or merges
    is wrong) unless the view leaves it as it is in ``src``, the first
    operand's spec (the heads of ``whisper-small``'s 12 over 8 chips
    through the blocked attention's reshapes)."""
    if not isinstance(out, OutputSharding):
        return True              # a composite op DTensor decomposed and ran
    specs = out.output_spec
    specs = list(specs) if isinstance(specs, (tuple, list)) else [specs]
    if (has_shape_args and isinstance(specs[0], DTensorSpec)
            and not out.use_val_from_redistribute_schema
            and any(isinstance(p, (Shard, _StridedShard)) for p in specs[0].placements)):
        return False             # a sharded output, and the shape arguments left global
    if out.redistribute_schema is not None:
        specs += list(out.redistribute_schema.args_spec)
    for spec in specs:
        if not isinstance(spec, DTensorSpec):
            continue
        if len(spec.placements) != spec.mesh.ndim:
            return False
        if has_shape_args and spec.tensor_meta is not None and spec in specs[:1]:
            ways = [1] * len(spec.tensor_meta.shape)
            for i, p in enumerate(spec.placements):
                q = src.placements[i] if isinstance(src, DTensorSpec) else None
                if (type(p) is Shard and type(q) is Shard
                        and src.shape[q.dim] == spec.tensor_meta.shape[p.dim]):
                    continue                          # the same shard of a dim kept whole
                if isinstance(p, _StridedShard):     # its pieces must split evenly too
                    ways[p.dim] *= spec.mesh.size(i) * int(p.split_factor)
                elif isinstance(p, Shard):
                    ways[p.dim] *= spec.mesh.size(i)
            if any(n % w for n, w in zip(spec.tensor_meta.shape, ways)):
                return False
    return True


_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}


def _unit_strided(spec) -> set:
    """The mesh dims on which ``spec`` holds a strided shard of split factor
    1."""
    if not isinstance(spec, DTensorSpec):
        return set()
    return {i for i, p in enumerate(spec.placements)
            if isinstance(p, _StridedShard) and p.split_factor == 1}


def _unit_strided_plan(prop, schema: OpSchema) -> OutputSharding:
    """A matmul on a flattened dim whose outer part is sharded one entry a
    rank and whose inner part over a later mesh dim (pod2's clients on
    'data' and their sequences on 'pod'; the MoE's clients and token
    groups): DTensor's view rules give the later mesh dim a strided shard
    of split factor 1, the same local shard as a plain one, which its
    matmul strategies do not take (they would gather the tokens).  Planned
    on the plain shard; each operand keeps its strided one where the plan
    keeps that shard, and the output's shard on that mesh dim is strided
    again, so that the view back splits it."""
    def plain(spec):
        dims = _unit_strided(spec)
        if not dims:
            return spec
        return DTensorSpec(spec.mesh, tuple(Shard(p.dim) if i in dims else p
                                            for i, p in enumerate(spec.placements)),
                           tensor_meta=spec.tensor_meta)

    orig = [s for s in tree_flatten(schema.args_schema)[0] if isinstance(s, DTensorSpec)]
    flat = OpSchema(schema.op, tree_map_only(DTensorSpec, plain, schema.args_schema),
                    tree_map_only(DTensorSpec, plain, schema.kwargs_schema),
                    schema_info=schema.schema_info)
    out = prop.propagate_op_sharding_non_cached(flat)
    strided = set().union(*map(_unit_strided, orig))

    def restride(spec, ref):
        pl = tuple(_StridedShard(p.dim, split_factor=1) if i in strided and type(p) is Shard
                   and (ref is None or ref.placements[i] == _StridedShard(p.dim, split_factor=1))
                   else p for i, p in enumerate(spec.placements))
        return DTensorSpec(spec.mesh, pl, tensor_meta=spec.tensor_meta)

    expected = out.redistribute_schema or flat
    it = iter(orig)
    args = tree_map_only(DTensorSpec, lambda e: restride(e, next(it)), expected.args_schema)
    return OutputSharding(restride(out.output_spec, None),
                          OpSchema(schema.op, args, expected.kwargs_schema,
                                   schema_info=schema.schema_info),
                          needs_redistribute=True)


def install_replicate_fallback() -> None:
    """Make DTensor run an op it cannot propagate on replicated operands
    (the last mesh dims first), and record it in ``_REPLICATED``.  Once per
    process; the dry-run's process only."""
    disp = DTensor._op_dispatcher
    if getattr(disp, "_dryrun_fallback", False):
        return
    prop = disp.sharding_propagator
    slow_path = disp._propagate_op_sharding_dispatch_slow_path
    masked = MaskBuffer.apply_mask
    search = RD.DTensorRedistributePlanner.find_min_cost_path
    expand = RD.DTensorRedistributePlanner.get_next_state
    planned = RD.redistribute_local_tensor
    planned_cost = OU.redistribute_cost

    def materialize_mask(self, mask):
        # a shared mask is compared with its first copy: fakes have no values
        if self.refcount == 0 or self.data is None:
            self.data = mask
        self.refcount += 1

    def apply_mask(self, tensor):
        # a pending masked partial (a gather over a sharded dim) whose value
        # was squeezed before its reduction: the mask takes the value's shape
        if self.data is not None and self.data.numel() == tensor.numel():
            self.data = self.data.reshape(tensor.shape)
        return masked(self, tensor)

    relaxed_plans = {}      # str(schema) -> the relaxed plan found for it

    def cost(current, target):
        # on a 3-D mesh or with a strided shard, the redistribution cost of a
        # candidate strategy summed over mesh dims (DTensor plans each
        # candidate's path, which there costs seconds per op): the choice
        # only, not what is counted
        strided = any(isinstance(p, _StridedShard)
                      for p in current.placements + target.placements)
        if current.mesh.ndim < 3 and not strided:
            return planned_cost(current, target)
        if current.mesh != target.mesh:
            return float("inf")
        if current.is_replicated() or current.placements == target.placements:
            return 0.0
        if current.shard_order is None or target.shard_order is None:
            return float("inf")
        topo = CU.MeshTopoInfo.build_from_mesh(current.mesh)
        gb = CU.spec_to_bytes(current) / current.num_shards / 2**30
        total = 0.0
        for i, (a, b) in enumerate(zip(current.placements, target.placements)):
            if a != b:
                step, gb = CU._compute_placement_transition_cost(a, b, topo, i, gb)
                total += step
        return total

    def bounded_search(self, src, dst):
        self._dryrun_expansions = 0
        return search(self, src, dst)

    def next_state(self, *a, **k):
        self._dryrun_expansions = getattr(self, "_dryrun_expansions", 0) + 1
        if self._dryrun_expansions > _PLAN_BUDGET:
            raise _PlanTooLarge
        return expand(self, *a, **k)

    unplanned = set()       # (current, target) pairs DTensor could not redistribute

    def redistribute_local(local, current, target, *a, **k):
        # the collectives are counted; the local copies around them (a
        # gather's concatenation on a dim other than the first, an
        # average's division, a strided shard's permutation) are the
        # redistribution's own, which each torch version does its own way
        with _unbilled():
            if (current, target) not in unplanned:
                try:
                    return planned(local, current, target, *a, **k)
                except (_PlanTooLarge, RuntimeError):
                    # past the search budget, or a plan DTensor's own checks
                    # reject (a strided shard whose local size its planner
                    # computes otherwise than its view rules)
                    unplanned.add((current, target))
            _MODELED[0] += 1
            return _modeled_redistribute(local, current, target)

    def tail(op_call, args, kwargs, mesh, output_sharding, *rest):
        # an in-place view (matmul's squeeze_) that keeps the placements and
        # changes the shape: DTensor's fast path returns self with the old
        # shape; the spec and the wrapper's sizes are updated instead
        spec = output_sharding.output_spec
        if (len(rest) == 4 and rest[2] and isinstance(spec, DTensorSpec)
                and isinstance(args[0], DTensor)
                and args[0]._spec.placements == spec.placements
                and args[0]._spec.shape != spec.shape):
            from torch.utils._python_dispatch import return_and_correct_aliasing

            args[0]._spec = spec
            return return_and_correct_aliasing(op_call, args, kwargs, args[0])
        return fast_tail(op_call, args, kwargs, mesh, output_sharding, *rest)

    def propagate(op_call, args, kwargs, op_info, try_cache):
        # a first propagation runs fake ops of its own (shape inference,
        # decomposed candidates) that a cached one does not: none is counted
        with _uncounted():
            return plan(op_call, args, kwargs, op_info, try_cache)

    def plan(op_call, args, kwargs, op_info, try_cache):
        schema = op_info.schema
        key = str(schema)       # a schema's hash may leave out its non-tensor arguments
        if key in relaxed_plans:
            return relaxed_plans[key]
        if schema.is_out_variant_op():
            # the output is the out= tensor as it lies (a plain buffer,
            # replicated): every operand is replicated to match it, planned
            # here (a torch version's decomposition search over the scan
            # engine's cache copies, an operand per parameter leaf, does not
            # end in bounded memory)
            relaxed = _relaxed(schema, 0)
            outs = [relaxed.kwargs_schema[a.name] for a in op_call._schema.arguments if a.is_out]
            out = OutputSharding(outs[0] if len(outs) == 1 else tuple(outs), relaxed,
                                 needs_redistribute=True)
            _REPLICATED[str(op_call)] = 0
            relaxed_plans[key] = out
            return out
        if op_call in _MATMULS and any(map(_unit_strided, tree_flatten(schema.args_schema)[0])):
            out = _unit_strided_plan(prop, schema)
            relaxed_plans[key] = out
            return out
        try:
            out = slow_path(op_call, args, kwargs, op_info, try_cache)
            if _well_formed(out, op_call in prop.op_to_shape_and_stride_idx,
                            schema.args_schema[0]):
                return out
            raise RuntimeError(f"{op_call}: a plan DTensor cannot run")
        except (RuntimeError, NotImplementedError, AssertionError, KeyError):
            ndim = max((s.mesh.ndim for s in tree_flatten(schema.args_schema)[0]
                        if isinstance(s, DTensorSpec)), default=0)
            for keep in range(ndim - 1, -2, -1):
                if keep < 0:
                    # no strategy, or none that gives a plan DTensor can run
                    if prop.op_strategy_funcs.get(op_call) is _replicate_strategy:
                        raise
                    prop.register_op_strategy(op_call, _replicate_strategy, _EVERY_ARG)
                    keep = 0
                relaxed = _relaxed(schema, keep)
                try:
                    out = prop.propagate_op_sharding_non_cached(relaxed)
                except Exception:  # noqa: BLE001  (any propagation failure: relax further)
                    continue
                if not _well_formed(out, op_call in prop.op_to_shape_and_stride_idx,
                                    relaxed.args_schema[0]):
                    continue
                if not out.needs_redistribute:
                    out = OutputSharding(out.output_spec, relaxed, needs_redistribute=True)
                name = str(op_call)
                _REPLICATED[name] = min(_REPLICATED.get(name, keep), keep)
                relaxed_plans[key] = out
                return out
            raise

    prop.register_op_strategy(torch.ops.repro_dryrun.tp_layout.default, _tp_strategy,
                              RuntimeSchemaInfo(static_argnum=1))
    prop.register_op_strategy(torch.ops.repro_dryrun.einsum.default, _einsum_strategy,
                              RuntimeSchemaInfo(static_argnum=0))
    for name, strategy in _STRATEGIES.items():
        packet, overload = name.split(".")
        op = getattr(getattr(torch.ops.aten, packet), overload)
        # a single-dim strategy (some torch versions register one) would be
        # chosen over this one; the arguments after the tensor are hashed
        # as they are (torch 2.13's squeeze propagation reads a list of dims)
        getattr(prop, "op_single_dim_strategy_funcs", {}).pop(op, None)
        prop.register_op_strategy(op, strategy,
                                  _SCHEMA_INFO.get(name, RuntimeSchemaInfo(static_argnum=1)))
    _StridedShard.local_shard_size_and_offset = _strided_shard
    _StridedShard._split_tensor = _strided_split
    MaskBuffer.apply_mask = apply_mask
    RD.DTensorRedistributePlanner.find_min_cost_path = bounded_search
    RD.DTensorRedistributePlanner.get_next_state = next_state
    RD.redistribute_local_tensor = DP.redistribute_local_tensor = redistribute_local
    MaskBuffer.materialize_mask = materialize_mask
    OU.redistribute_cost = cost
    disp._propagate_op_sharding_dispatch_slow_path = propagate
    fast_tail = getattr(disp, "_dispatch_fast_path_python_tail", None)
    if fast_tail is not None:
        disp._dispatch_fast_path_python_tail = tail
    disp._dryrun_fallback = True


# ---------------------------------------------------------------------------
# counting rank 0's local work

_META_OPS = {
    torch.ops.aten.sym_is_contiguous.default, torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default, torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default, torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default, torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default, torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
}
_NO_TRAFFIC = {torch.ops.aten.detach.default, torch.ops.aten.alias.default,
               torch.ops.aten.lift_fresh.default, torch.ops.prim.device.default}
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class CommRecorder(CommDebugMode):
    """``CommDebugMode`` that also keeps, for each collective, its op in the
    reference's HLO name, its result bytes on this rank and its group:
    ``records`` holds ``(op, nbytes, group_size, intra_node)``."""

    def __init__(self, counter: "LocalCounter"):
        super().__init__()
        self.counter = counter
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if (out is not NotImplemented and packet is not None
                and getattr(func, "namespace", "") == "_c10d_functional"
                and packet.__name__ in _COLLECTIVES):
            from torch.distributed.distributed_c10d import _resolve_process_group

            name = kwargs.get("group_name") if kwargs else None
            ranks = dist.get_process_group_ranks(_resolve_process_group(name or args[-1]))
            intra = len({r // GPUS_PER_NODE for r in ranks}) == 1
            nbytes = sum(_nbytes(t) for t in _tensors(out))
            rec = (_COLLECTIVES[packet.__name__], nbytes, len(ranks), intra)
            self.records.extend([rec] * self.counter.scale)
        return out


class LocalCounter(TorchDispatchMode):
    """FLOPs, bytes and live storage of rank 0's local ops.  An op with a
    DTensor operand is left to DTensor (``NotImplemented``), which runs it
    as local ops on the shards that this mode then sees; DTensor's own
    shape inference at the global shape is not counted."""

    def __init__(self, live_bytes: int = 0):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.scale = 1             # > 1 inside a sampled loop iteration
        self.sampled = 0           # loop iterations counted without running
        self.live = live_bytes
        self.peak = live_bytes
        self._storages = {}

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside ``n`` times (``models/layers.py::BlockLoop``)."""
        self.scale *= n
        self.sampled += self.scale - self.scale // n
        try:
            yield
        finally:
            self.scale //= n

    def _release(self, key):
        ent = self._storages[key]
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._storages[key]

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        ent = self._storages.get(key)
        if ent is None:
            ent = self._storages[key] = [st.nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return NotImplemented
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func in _META_OPS or getattr(_UNCOUNTED, "depth", 0):
            return func(*args, **kwargs)
        if func is torch.ops.repro_dryrun.einsum.default:
            # the local product as torch runs it (a bmm between copies)
            with self:
                return torch.functional.einsum(*args)
        if (func not in self.registry and func is not torch.ops.prim.device.default
                and getattr(func, "namespace", "") != "_c10d_functional"):
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += self.scale * self.registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if (not func.is_view and func not in _NO_TRAFFIC and not getattr(_UNBILLED, "depth", 0)
                and getattr(func, "namespace", "") not in ("_c10d_functional", "repro_dryrun")):
            moved = sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
            self.bytes += self.scale * moved
        for t in outs:
            self._track(t)
        return out


@dataclass
class StepCounts:
    flops: float
    bytes: float
    peak_bytes: float
    coll: RL.CollectiveStats
    sampled_iterations: int = 0
    comm_records: list = field(default_factory=list)

    def _flat(self) -> dict:
        out = {("flops",): self.flops, ("bytes",): self.bytes, ("peak",): self.peak_bytes,
               ("sampled",): self.sampled_iterations}
        for name in ("counts", "raw_bytes", "traffic_bytes", "link_traffic"):
            for k, v in getattr(self.coll, name).items():
                out[(name, k)] = v
        return out

    @staticmethod
    def affine(base: "StepCounts", steps: list) -> "StepCounts":
        """``base`` plus ``m`` times each ``(deeper, m)`` step's excess over
        it: the counts of a model with ``m`` more units in each stack."""
        flat, b = base._flat(), base._flat()
        for deeper, m in steps:
            d = deeper._flat()
            for k in set(flat) | set(d):
                flat[k] = flat.get(k, 0) + m * (d.get(k, 0) - b.get(k, 0))
        coll = RL.CollectiveStats()
        for (name, *key), v in flat.items():
            if key:
                getattr(coll, name)[key[0]] = v
        return StepCounts(flat[("flops",)], flat[("bytes",)], flat[("peak",)], coll,
                          flat[("sampled",)])


def _local_bytes(tree) -> int:
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if isinstance(t, DTensor) else t)
    return total


@dataclass
class Lowered:
    """A step and its sharded stand-in arguments (the reference's
    ``jax.stages.Lowered``): :func:`trace` runs it once."""
    fn: object
    args: tuple


def trace(lowered: Lowered) -> StepCounts:
    install_replicate_fallback()
    counter = LocalCounter(_local_bytes(lowered.args))
    rec = CommRecorder(counter)
    L._LOOP_COUNTER[0] = counter.repeat
    try:
        with (SP.stand_in_mode(), implicit_replication(), _tp_blocks(), _sharded_products(),
              rec, counter):
            out = lowered.fn(*lowered.args)
            del out
    finally:
        L._LOOP_COUNTER[0] = None
    return StepCounts(counter.flops, counter.bytes, counter.peak,
                      RL.count_collectives(rec.records), counter.sampled, rec.records)


def _stacks(cfg: ModelConfig) -> dict:
    """``{config field: (layers per unit, units)}`` of each layer stack."""
    if cfg.encoder_layers:
        return {"encoder_layers": (1, cfg.encoder_layers), "num_layers": (1, cfg.num_layers)}
    unit = cfg.shared_attn_every or 1          # a hybrid's cycle of Mamba2 + shared attention
    return {"num_layers": (unit, cfg.num_layers // unit)}


def count_step(cfg: ModelConfig, shape: InputShape, mesh, **kw) -> tuple:
    """The step's counts at ``cfg``'s depth, and the depths traced.

    Every layer of a stack runs the same ops on the same shapes and
    layouts, so with the arguments at full depth (the stacked parameters,
    their gradients and updates keep their shapes and layouts) the counts
    are affine in the number of layers the step runs: a stack deeper than
    3 units is run 2 and 3 units deep and extrapolated
    (:meth:`StepCounts.affine`)."""
    stacks = _stacks(cfg)
    if all(n <= 3 for _, n in stacks.values()):
        return trace(build_lowered(cfg, shape, mesh, **kw)), [dict(
            (f, u * n) for f, (u, n) in stacks.items())]
    two = {f: u * min(n, 2) for f, (u, n) in stacks.items()}
    base = trace(build_lowered(cfg, shape, mesh, depth=two, **kw))
    steps, depths = [], [two]
    for f, (u, n) in stacks.items():
        if n > 2:
            deeper = dict(two, **{f: 3 * u})
            steps.append((trace(build_lowered(cfg, shape, mesh, depth=deeper, **kw)), n - 2))
            depths.append(deeper)
    return StepCounts.affine(base, steps), depths


# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _sharded_caches(mesh, kv_mode: str):
    """The caches a prefill makes (``models/kvcache.py``) laid out as the
    decode step's are (:func:`~repro_torch.launch.sharding.cache_shardings`)
    and not as plain tensors, which DTensor cannot write a sharded value
    into."""
    mode = "hd" if kv_mode in ("proj", "factored") else kv_mode
    saved = {name: getattr(KV, name) for name in ("init_kv", "init_ssm", "init_cross")}

    def sharded(make):
        def init(*a, **k):
            with _uncounted():
                cache = make(*a, **k)
            return SH.distribute(cache, SH.cache_shardings(cache, mesh, mode=mode))
        return init

    try:
        for name, make in saved.items():
            setattr(KV, name, sharded(make))
        yield
    finally:
        for name, make in saved.items():
            setattr(KV, name, make)


# ---------------------------------------------------------------------------
# the residual stream's layout: Megatron-style tensor parallelism


@torch.library.custom_op("repro_dryrun::tp_layout", mutates_args=())
def _tp_layout_op(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    return x.clone()


_tp_layout_op.register_fake(lambda x, dim: torch.empty_like(x))
_tp_layout_op.register_vmap(
    lambda info, in_dims, x, dim: (_tp_layout_op(x, dim), None) if in_dims[0] is None
    else (_tp_layout_op(x.movedim(in_dims[0], 0), dim), 0))


class _TPLayout(torch.autograd.Function):
    """An identity on values and on gradients; the value takes the layout
    ``dim`` and the gradient ``grad_dim`` (the same, but for
    :func:`tp_gather`).  On a DTensor the redistribution (an all-reduce of
    a partial sum, an all-gather or a slice of a shard) is counted.
    Differentiable under ``torch.func`` and ``vmap``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, dim, grad_dim):
        return _tp_layout_op(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.grad_dim = inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _TPLayout.apply(g, ctx.grad_dim, ctx.grad_dim), None, None


def tp_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` replicated over the tensor-parallel mesh dims, its client-axis
    placements kept: a sublayer's input and output, as Megatron and GSPMD
    lay them out for these specs."""
    return _TPLayout.apply(x, None, None)


def _neg(x: torch.Tensor, dim: int) -> int:
    return dim - x.dim() if dim >= 0 else dim


def tp_shard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` (the heads) sharded over the tensor-parallel mesh
    dims, its client-axis placements kept: the heads of an attention or an
    SSD core, as Megatron lays them out, also where the projection's shard
    does not split into whole heads (``whisper-small``'s 12 heads over 8
    chips: 2 on each of the first 6) or the block splits one projection
    into several inputs (Mamba2's ``in_proj``).  From a replicated ``x`` a
    local slice."""
    return _TPLayout.apply(x, _neg(x, dim), _neg(x, dim))


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` replicated over the tensor-parallel mesh dims, its gradient
    sharded on ``dim`` as :func:`tp_shard` shards it: a column-parallel
    projection's output gathered for slices that its shards do not align
    with (Mamba2's z, conv input and dt), whose weight gradient then stays
    column-parallel."""
    return _TPLayout.apply(x, None, _neg(x, dim))


def _tp_strategy(op_schema):
    """:func:`tp_input`: the tensor-parallel mesh dims replicated;
    :func:`tp_shard`: its dim sharded over each of them that it has at least
    as many entries as (else replicated)."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    src, dim = op_schema.args_schema[:2]
    out = []
    for spec in src.strategies:
        s = spec.output_spec
        names = s.mesh.mesh_dim_names or ()
        pl = tuple(p if i < len(names) and names[i] in ("pod", "data") else
                   Shard(dim % s.ndim) if dim is not None and s.shape[dim] >= s.mesh.size(i)
                   else Replicate() for i, p in enumerate(s.placements))
        target = DTensorSpec(s.mesh, pl, tensor_meta=s.tensor_meta)
        out.append(OpSpec(output_specs=target, input_specs=(target,),
                          redistribute_cost=[generate_redistribute_costs(src, target)]))
    return OpStrategy(out)


# ---------------------------------------------------------------------------
# the batched products: one op whose sharding the dry-run decides


@torch.library.custom_op("repro_dryrun::einsum", mutates_args=())
def _einsum_op(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.functional.einsum(equation, a, b)


_einsum_op.register_fake(lambda equation, a, b: torch.functional.einsum(equation, a, b))


@_einsum_op.register_vmap
def _(info, in_dims, equation, a, b):
    ins, out = equation.split("->")
    terms = ins.split(",")
    new = next(c for c in string.ascii_letters if c not in equation)
    ops = []
    for i, (x, d) in enumerate(zip((a, b), in_dims[1:])):
        if d is not None:
            x, terms[i] = x.movedim(d, 0), new + terms[i]
        ops.append(x)
    return _einsum_op(",".join(terms) + "->" + new + out, *ops), 0


class _Einsum(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(equation, a, b):
        return _einsum_op(equation, a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.equation = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, g):
        ins, out = ctx.equation.split("->")
        ta, tb = ins.split(",")
        a, b = ctx.saved_tensors
        ga = _Einsum.apply(f"{out},{tb}->{ta}", g, b) if ctx.needs_input_grad[1] else None
        gb = _Einsum.apply(f"{out},{ta}->{tb}", g, a) if ctx.needs_input_grad[2] else None
        return None, ga, gb


def _plain_terms(equation: str, n: int):
    """``(terms, out)`` of an explicit einsum equation whose every input
    letter appears once in its term and again in another term or the output
    (each operand's gradient is then a product of the others), else None."""
    equation = equation.replace(" ", "")
    if "->" not in equation or "." in equation:
        return None
    ins, out = equation.split("->")
    terms = ins.split(",")
    if len(terms) != n or n < 2:
        return None
    for i, t in enumerate(terms):
        rest = out + "".join(terms[:i] + terms[i + 1:])
        if len(set(t)) != len(t) or any(c not in rest for c in t):
            return None
    return terms, out


def sharded_einsum(equation: str, *operands):
    """``torch.einsum`` as products of two operands, left to right (a letter
    leaves as soon as no later operand and not the output holds it), each
    through one op whose sharding :func:`_einsum_strategy` decides.  On
    fake DTensors a product keeps the batch letters' shards where they lie
    (DTensor's own decomposition merges the batch dims into one view, which
    cannot hold a client shard and a head shard at once, and lays it out
    differently from one torch version to the next).  Differentiable under
    ``torch.func`` and ``vmap``."""
    terms, out = _plain_terms(equation, len(operands))
    acc, term = operands[0], terms[0]
    for i in range(1, len(terms)):
        later = out if i == len(terms) - 1 else out + "".join(terms[i + 1:])
        nxt = out if i == len(terms) - 1 else "".join(
            dict.fromkeys(c for c in term + terms[i] if c in later))
        acc, term = _Einsum.apply(f"{term},{terms[i]}->{nxt}", acc, operands[i]), nxt
    return acc


def _einsum_strategy(op_schema):
    """Each mesh dim by the first operand with a plain shard on it: its
    letter sharded in every operand that holds it, and in the output (a
    partial sum where the product contracts it); a mesh dim that no operand
    shards so, replicated in all."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    equation, *srcs = op_schema.args_schema
    ins, out = equation.split("->")
    terms = ins.split(",")
    specs = [s.strategies[0].output_spec for s in srcs]
    mesh = specs[0].mesh
    in_pl = [[Replicate()] * mesh.ndim for _ in srcs]
    out_pl = [Replicate()] * mesh.ndim
    for i in range(mesh.ndim):
        letter = next((t[p.dim] for t, s in zip(terms, specs) for p in (s.placements[i],)
                       if isinstance(p, Shard) and not isinstance(p, _StridedShard)), None)
        if letter is None:
            continue
        for k, t in enumerate(terms):
            if letter in t:
                in_pl[k][i] = Shard(t.index(letter))
        out_pl[i] = Shard(out.index(letter)) if letter in out else Partial()
    targets = [DTensorSpec(mesh, tuple(pl), tensor_meta=s.tensor_meta)
               for pl, s in zip(in_pl, specs)]
    return OpStrategy([OpSpec(output_specs=DTensorSpec(mesh, tuple(out_pl)),
                              input_specs=tuple(targets),
                              redistribute_cost=[generate_redistribute_costs(s, t)
                                                 for s, t in zip(srcs, targets)])])


@contextlib.contextmanager
def _sharded_products():
    """The step's ``torch.einsum`` calls (the eager attention's and SSD
    core's batched products, ``models/layers.py``, ``models/ssm.py``) go
    through :func:`sharded_einsum`; an equation it cannot take runs as it
    is (``torch.functional.einsum``, which this leaves alone)."""

    def einsum(equation, *operands):
        if _plain_terms(equation, len(operands)) is None:
            return torch.functional.einsum(equation, *operands)
        return sharded_einsum(equation, *operands)

    torch.einsum = einsum
    try:
        yield
    finally:
        torch.einsum = torch.functional.einsum


@contextlib.contextmanager
def _tp_blocks():
    """The step's layout over the tensor-parallel (model) axis, Megatron's.
    Every sublayer (attention, MLP, MoE, Mamba2 block) takes its input and
    gives its output through :func:`tp_input` (the f and g operators: the
    output's partial sum reduced, and a partial gradient reduced before the
    sublayer's backward products), and so does the embedding (the residual
    stream replicated over the axis from its start).  Sharded over the axis by :func:`tp_shard`,
    also where a spec leaves the weight replicated or a shard does not split
    into whole heads: the attention's heads (``layers._split_heads``, and the
    cores' outputs, whose gradients come back through the heads merge), the
    SSD core's (``ssm.ssd_chunked``: x, dt and the decay, and its outputs;
    B and C are one group shared by all heads), Mamba2's z, conv input and
    dt (``ssm._split``, from its in-projection's output gathered once by
    :func:`tp_gather`) and the head's vocab (``transformer.lm_logits``, the
    vocab-parallel head).  Gathered by :func:`tp_input`: the embedding's
    table before its lookup, Mamba2's conv output before its x, B and C are
    sliced (``ssm._split_xbc``) and its gated norm's mean
    (``ssm._mean_square``, a partial sum that torch 2.13 would
    reduce-scatter over the batch).  Left to DTensor's per-op choice, the residual
    stream's hidden dim is sharded, partial sums are all-reduced inside the
    attention loop, whole weights are gathered over the model axis, and a
    backward product whose gradient arrives replicated or as a partial sum
    runs on every head or on gathered weights."""

    def constrained(fn):
        def call(p, x, *a, **k):
            out = fn(p, tp_input(x), *a, **k)
            return (tp_input(out[0]), *out[1:]) if isinstance(out, tuple) else tp_input(out)
        return call

    def heads(fn):
        return lambda x, n_heads, head_dim: tp_shard(fn(x, n_heads, head_dim), -2)

    def core(fn):
        return lambda *a, **k: tp_shard(fn(*a, **k), -2)

    def head(fn):
        def call(p, h, cfg):
            w = "embedding" if cfg.tie_embeddings else "lm_head"
            p = dict(p, **{w: tp_shard(p[w], 0 if cfg.tie_embeddings else -1)})
            return fn(p, tp_input(h), cfg)
        return call

    def split(fn):
        # the in-projection's output gathered once, then z, the conv's input
        # and dt each sharded on its channels or heads (the conv's weight and
        # bias are sharded on their channels)
        def call(zxbcdt, cfg):
            return tuple(tp_shard(t, -1) for t in fn(tp_gather(zxbcdt, -1), cfg))
        return call

    def split_xbc(fn):
        # the conv's output gathered once for its x, B and C
        return lambda xbc, cfg: fn(tp_input(xbc), cfg)

    def mean_square(fn):
        # the gated norm's partial mean all-reduced (torch 2.13 would
        # reduce-scatter it over the batch, 2.11 does not)
        return lambda y: tp_input(fn(y))

    def ssd(fn):
        def call(xs, bmat, cmat, dt, da, chunk):
            y, state = fn(tp_shard(xs, -2), bmat, cmat, tp_shard(dt, -1), tp_shard(da, -1),
                          chunk)
            return tp_shard(y, -2), tp_shard(state, -3)
        return call

    patches = [(T, n, constrained) for n in ("apply_attention", "apply_mlp", "mamba_block",
                                             "mamba_block_decode")]
    def embed(fn):
        # the lookup on the gathered table (DTensor's own choice for a
        # vocab-sharded table differs from one torch version to the next)
        return lambda p, tokens, cfg: tp_input(fn(dict(p, embedding=tp_input(p["embedding"])),
                                                  tokens, cfg))

    patches += [(T.M, "apply_moe", constrained), (T, "lm_logits", head), (T, "embed_tokens", embed),
                (L, "_split_heads", heads), (L, "chunked_attention", core),
                (L, "attention_scores", core), (SSM, "_split", split),
                (SSM, "_split_xbc", split_xbc), (SSM, "_mean_square", mean_square),
                (SSM, "ssd_chunked", ssd)]
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in patches]
    try:
        for mod, n, wrap in patches:
            setattr(mod, n, wrap(getattr(mod, n)))
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def _replicated_dt(t, mesh):
    return SH.distribute(t, SH.NamedSharding(mesh, ()))


def _batch_layout(batch, mesh, fit_dims: tuple) -> tuple:
    """``(mesh, shardings)`` of the batch (``sharding.batch_shardings`` with
    ``fit_dims``): where the client axes' product does not divide the
    leading dim (pod2's 32 clients, or prefill sequences, over 64 GPUs),
    that dim over the axes that divide it and the axis left over on a
    client's batch (``fit_dims``).  A 'pod' axis the batch leaves
    replicated shards no input (the parameters' FSDP axis is 'data'), so
    the step runs on the submesh without it, as it would replicated over it
    (DTensor's per-op choice cannot then shard an activation over it), and
    ``_REPLICATED_AXES`` records it for the record's notes."""
    b_sh = SH.batch_shardings(batch, mesh, fit_dims=fit_dims)
    left = {a: n for a, n in SH.replicated_client_axes(b_sh, mesh).items() if a == "pod"}
    if left:
        _REPLICATED_AXES.update(left)
        mesh = mesh[tuple(a for a in mesh.mesh_dim_names if a not in left)]
        return mesh, SH.batch_shardings(batch, mesh, fit_dims=fit_dims)
    # the mesh dims in the order of the batch dims they shard ('data' on the
    # clients before 'pod' on a client's sequences): a view that merges the
    # two (a batched matmul's flattening under vmap) then keeps both shards,
    # as the same ranks in the same groups
    first = {}
    for sh in _flat(b_sh):
        for d, spec in enumerate(sh.spec):
            for a in (spec if isinstance(spec, tuple) else (spec,)):
                first.setdefault(a, d)
    names = mesh.mesh_dim_names
    order = sorted(range(len(names)), key=lambda i: (first.get(names[i], len(names)), i))
    if order == sorted(order):
        return mesh, b_sh
    mesh = DeviceMesh(mesh.device_type, mesh.mesh.permute(order),
                      mesh_dim_names=tuple(names[i] for i in order))
    return mesh, SH.batch_shardings(batch, mesh, fit_dims=fit_dims)


def _flat(tree) -> list:
    out = []
    SH._map(out.append, tree)
    return out


def _without_client_axes(fn, mesh):
    """``fn`` run on the submesh of ``mesh`` without its client axes, its
    DTensor arguments replicated over them and its results replicated over
    them again: the scan engine's group update.  A group's slice of the
    client-sharded batch lies whole on every chip (the reference's scan
    slices each group out of the sharded batch likewise), so its update is
    replicated over the client axes; on the submesh no torch version's
    per-op choice can shard an activation over them instead (torch 2.13
    split some of the in-projection's gradient over them as a strided
    shard of the tokens, 2.11 did not)."""
    names = mesh.mesh_dim_names
    kept = [i for i, a in enumerate(names) if a not in ("pod", "data")]
    if len(kept) == len(names):
        return fn
    sub = mesh[tuple(names[i] for i in kept)]

    def down(t):
        if not isinstance(t, DTensor):
            return t
        t = _gather(t, tuple(p if i in kept else Replicate()
                             for i, p in enumerate(t.placements)))
        return DTensor.from_local(t.to_local(), sub, tuple(t.placements[i] for i in kept),
                                  run_check=False, shape=t.shape, stride=t.stride())

    def up(t):
        if not isinstance(t, DTensor):
            return t
        pl = [Replicate()] * len(names)
        for j, i in enumerate(kept):
            pl[i] = t.placements[j]
        return DTensor.from_local(t.to_local(), mesh, tuple(pl), run_check=False,
                                  shape=t.shape, stride=t.stride())

    def call(*args):
        return tree_map_only(DTensor, up, fn(*tree_map_only(DTensor, down, args)))

    return call


_STACKS = ("layers", "mamba", "enc_layers", "dec_layers")


def _gather(t, placements):
    if isinstance(t, DTensor) and tuple(t.placements) != tuple(placements):
        return t.redistribute(placements=placements)
    return t


def _unstacked(placements) -> tuple:
    """One layer's placements from its stack's (the leading dim dropped)."""
    return tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in placements)


@contextlib.contextmanager
def _gathered_layers(use: dict):
    """Layer ``i`` of a stack (``models/transformer.py::layer``) gathered to
    its use placements (``use``: id of a stacked DTensor -> placements)."""
    saved = T.layer

    def layer(tree, i):
        return SH._map(lambda x: _gather(x[i], _unstacked(use[id(x)]))
                       if id(x) in use else x[i], tree)

    T.layer = layer
    try:
        yield
    finally:
        T.layer = saved


def _fsdp_step(fn, params_at: int, use_sh, per_layer: bool):
    """``fn`` with the parameters (argument ``params_at``) gathered over the
    client axes where they are used, as FSDP does and as GSPMD lays out the
    reference's step: ``use_sh`` are their shardings without the FSDP role.
    ``per_layer``: a stack's layers one at a time as the model takes them
    (serving); else every leaf once at the start (the round, whose
    ``torch.func`` transforms take plain arguments)."""
    flat_use = []
    SH._map(flat_use.append, use_sh)

    def step(*args):
        args = list(args)
        params, it = args[params_at], iter(flat_use)
        if not per_layer:
            args[params_at] = SH._map(lambda t: _gather(t, next(it).placements), params)
            return fn(*args)
        use = {}

        def top(path, t):
            pl = next(it).placements
            if path and path[0] in _STACKS:
                use[id(t)] = pl
                return t
            return _gather(t, pl)

        args[params_at] = SH._map_with_path(top, params)
        with _gathered_layers(use):
            return fn(*args)

    return step


def build_lowered(cfg: ModelConfig, shape: InputShape, mesh, fl_mode: str = "vmap",
                  fsdp: bool = True, donate: bool = False, out_shard: bool = False,
                  expert_parallel: bool = False, kv_mode: str = "hd",
                  scan_group: int = 2, depth: dict | None = None) -> Lowered:
    """The step of ``shape.mode`` and its stand-in arguments, sharded as the
    reference shards them.  Parameters are stored by ``param_shardings``
    and gathered over the client axes where they are used
    (:func:`_fsdp_step`).  ``donate`` is accepted and ignored (torch has no
    buffer donation).  ``depth`` (config fields, e.g. ``{"num_layers":
    2}``) runs the step through that many layers of each stack, on the
    arguments of the full depth (:func:`count_step`)."""
    del donate
    dev = mesh.device_type
    full = build_model(cfg)
    if shape.mode == "train":
        fl = SP.fl_config_for(cfg, shape)
        batch = SP.train_inputs(cfg, shape, fl, dev)
        # a client's (R, b, s) step keeps its b sharded: an axis the clients
        # leave over splits each client's batch
        mesh, b_sh = _batch_layout(batch, mesh, (2,))
    elif shape.mode == "prefill":
        batch = SP.prefill_inputs(cfg, shape, dev)
        mesh, b_sh = _batch_layout(batch, mesh, ())
    else:
        tok, cache, pos = SP.decode_inputs(cfg, shape, full, dev)
        mesh, t_sh = _batch_layout({"t": tok}, mesh, ())
        t_sh = t_sh["t"]
    if expert_parallel and cfg.num_experts:
        data_size = axis_sizes(mesh).get("data", 1)
        if cfg.num_experts % data_size == 0:
            cfg = cfg.with_(moe_ep_axis="data")
            full = build_model(cfg)
    model = build_model(cfg.with_(**depth)) if depth else full
    params = SP.params_spec(full, dev)
    p_sh = SH.param_shardings(params, mesh, fsdp=fsdp, expert_parallel=expert_parallel)
    p_use = SH.param_shardings(params, mesh, fsdp=False, expert_parallel=expert_parallel)

    if shape.mode == "train":
        engine = RoundEngine(model.loss, fl, memory=fl_mode, scan_group=scan_group, device=dev)
        if fl_mode == "scan":
            engine._batched_update = _without_client_axes(engine._batched_update, mesh)
        step = engine.make_step()
        w = _replicated_dt(SP._sds((fl.n_clients,), torch.float32, dev), mesh)
        key = _replicated_dt(SP._sds((2,), torch.int64, dev), mesh)
        fn = _fsdp_step(step, 0, p_use, per_layer=False)
        if out_shard:
            # the updated params redistributed to their storage placements:
            # the client aggregation ends in a reduce-scatter
            flat_sh = []
            SH._map(flat_sh.append, p_sh)
            gathered = fn

            def fn(*a):
                new_p, opt, metrics = gathered(*a)
                it = iter(flat_sh)
                return SH._map(lambda t: _gather(t, next(it).placements), new_p), opt, metrics
        return Lowered(fn, (SH.distribute(params, p_sh), (), SH.distribute(batch, b_sh), w, key))

    if shape.mode == "prefill":
        def prefill(p, b):
            with _sharded_caches(mesh, kv_mode):
                return model.prefill(p, b, shape.seq_len)

        return Lowered(_fsdp_step(prefill, 0, p_use, per_layer=True),
                       (SH.distribute(params, p_sh), SH.distribute(batch, b_sh)))

    # decode
    if kv_mode == "factored" and cfg.num_kv_heads:
        sizes = axis_sizes(mesh)
        kv = min(cfg.num_kv_heads, sizes["model"])
        if sizes["model"] % kv == 0:
            mesh_f = SH.make_factored_mesh(mesh, kv)
            p_shf = SH.factored_param_shardings(params, mesh_f, fsdp=fsdp)
            p_usef = SH.factored_param_shardings(params, mesh_f, fsdp=False)
            t_shf = SH.batch_shardings({"t": tok}, mesh_f)["t"]
            c_shf = SH.factored_cache_shardings(cache, mesh_f)
            return Lowered(_fsdp_step(model.decode_step, 0, p_usef, per_layer=True),
                           (SH.distribute(params, p_shf), SH.distribute(tok, t_shf),
                            SH.distribute(cache, c_shf), pos))
    if kv_mode == "proj":
        p_sh = SH.param_shardings(params, mesh, fsdp=fsdp,
                                  expert_parallel=expert_parallel, kv_in_shard=True)
        p_use = SH.param_shardings(params, mesh, fsdp=False,
                                   expert_parallel=expert_parallel, kv_in_shard=True)
    c_sh = SH.cache_shardings(cache, mesh, mode="hd" if kv_mode == "proj" else kv_mode)
    fn = model.decode_step
    if out_shard:
        flat_c = []
        SH._map(flat_c.append, c_sh)

        def fn(p, t, c, i):
            logits, new_c = model.decode_step(p, t, c, i)
            it = iter(flat_c)
            return logits, SH._map(lambda x: _gather(x, next(it).placements), new_c)
    return Lowered(_fsdp_step(fn, 0, p_use, per_layer=True),
                   (SH.distribute(params, p_sh), SH.distribute(tok, t_sh),
                    SH.distribute(cache, c_sh), pos))


def run_pair(arch: str, shape_name, mesh, mesh_name: str, out_dir: str,
             fl_mode: str = "vmap", fsdp: bool = True, tag: str = "",
             out_shard: bool = False, expert_parallel: bool = False,
             kv_mode: str = "hd", scan_group: int = 2):
    """One (arch, shape) on ``mesh``: its record, also written to
    ``out_dir``.  ``shape_name`` names one of ``SHAPES`` or is an
    ``InputShape`` of its own."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    cfg, note = resolve_config(arch, shape)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}{tag}.json")
    if cfg is None:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "skipped": note}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] {arch} x {shape_name}: {note}")
        return rec

    chips = mesh.size()
    _REPLICATED.clear()
    _REPLICATED_AXES.clear()
    _MODELED[0] = 0
    t0 = time.perf_counter()
    counts, depths = count_step(cfg, shape, mesh, fl_mode=fl_mode, fsdp=fsdp,
                                out_shard=out_shard, expert_parallel=expert_parallel,
                                kv_mode=kv_mode, scan_group=scan_group)
    t_trace = time.perf_counter() - t0
    coll = counts.coll
    rf = RL.build_roofline(
        arch, shape_name, mesh_name, chips,
        {"flops": counts.flops, "bytes accessed": counts.bytes}, coll,
        model_flops(cfg, shape), peak_memory=counts.peak_bytes,
        notes=note + (f" fl_mode={fl_mode}" if shape.mode == "train" else "")
        + (" out_shard" if out_shard else "")
        + (" expert_parallel" if expert_parallel else "")
        + (f" kv={kv_mode}" if kv_mode != "hd" else "")
        + "".join(f" {a} replicated ×{n}" for a, n in _REPLICATED_AXES.items()),
    )
    rec = json.loads(rf.to_json())
    rec.update(
        {
            "trace_s": round(t_trace, 1),
            "collective_link_traffic": coll.link_traffic,
            "replicated_ops": dict(sorted(_REPLICATED.items())),
            "modeled_redistributions": _MODELED[0],
            "sampled_loop_iterations": counts.sampled_iterations,
            "traced_depths": depths,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
        }
    )
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(
        f"[dryrun] {arch} x {shape_name} ({mesh_name}{tag}): OK "
        f"compute={rf.compute_s:.3e}s memory={rf.memory_s:.3e}s "
        f"collective={rf.collective_s:.3e}s bottleneck={rf.bottleneck} "
        f"(trace {t_trace:.0f}s)", flush=True,
    )
    return rec


def table(out_dir: str) -> str:
    """The records under ``out_dir`` as a markdown table, a row an arch and
    a column a shape.  A cell: the compute, memory and collective terms in
    seconds (the compute term the larger of the counted FLOPs' and the
    ``model_flops`` floor), the bottleneck's initial, the useful-FLOPs
    ratio and the trace's seconds; three significant digits (the records
    keep every digit)."""
    recs = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"])] = r
    shapes = [s for s in SHAPES if any(k[1] == s for k in recs)]
    rows = ["| arch | " + " | ".join(shapes) + " |", "|---" * (len(shapes) + 1) + "|"]
    for arch in sorted({k[0] for k in recs}):
        cells = []
        for shape in shapes:
            r = recs.get((arch, shape))
            if r is None or "skipped" in r:
                cells.append("skipped" if r else "")
                continue
            compute = max(r["compute_s"], r["compute_model_s"])
            cells.append(f"{compute:.3g} / {r['memory_s']:.3g} / {r['collective_s']:.3g}; "
                         f"{r['bottleneck'][0].upper()}; {r['useful_flops_ratio']:.2g}; "
                         f"{r['trace_s']} s")
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fl-mode", default="vmap", choices=["vmap", "scan"])
    ap.add_argument("--scan-group", type=int, default=2)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out-shard", action="store_true")
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--kv-mode", default="hd", choices=["hd", "batch", "seq", "proj", "factored"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake tensors and of the mesh")
    ap.add_argument("--table", action="store_true",
                    help="print the records already under the output directory as a "
                         "markdown table, and run nothing")
    args = ap.parse_args(argv)

    mesh_name = "pod2" if args.multi_pod else "pod1"
    out_dir = args.out or os.path.normpath(os.path.join(ARTIFACT_DIR, mesh_name))
    if args.table:
        print(table(out_dir))
        return
    mesh = make_production_mesh(multi_pod=args.multi_pod, device=args.device)

    if args.all:
        pairs = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch in ARCHS and args.shape in SHAPES:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error(f"--all, or --arch among {sorted(ARCHS)} and --shape among {sorted(SHAPES)}")

    failures = []
    for arch, shape in pairs:
        try:
            run_pair(arch, shape, mesh, mesh_name, out_dir,
                     fl_mode=args.fl_mode, fsdp=not args.no_fsdp, tag=args.tag,
                     out_shard=args.out_shard, expert_parallel=args.expert_parallel,
                     kv_mode=args.kv_mode, scan_group=args.scan_group)
        except Exception as e:
            failures.append((arch, shape, repr(e)))
            print(f"[dryrun] {arch} x {shape}: FAILED {e!r}", flush=True)
            traceback.print_exc()
    dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("[dryrun] all pairs OK")


if __name__ == "__main__":
    main()
