"""Per-leaf sharding rules for params, batches and caches — the port of
``repro/launch/sharding.py``.

Baseline scheme: tensor parallelism over 'model' on head/ffn/vocab dims,
optional FSDP over 'data' on the complementary dim, FL clients / serving
batch over ('pod','data').  Any dim not divisible by its axis size falls
back to replication (but for ``batch_shardings``' ``fit_dims``, the
dry-run's layout of a batch the client axes do not divide).

The rules are the reference's, leaf for leaf, and give the same per-dim
axis assignment (a tuple, the reference's ``PartitionSpec``: per tensor dim
``None``, an axis name or a tuple of axis names).  A :class:`NamedSharding`
turns it into DTensor placements over the mesh's dims: a dim on a mesh axis
is ``Shard(dim)`` on that mesh dim, a dim on two axis names
(``("pod", "data")``, ``("model_kv", "model_hd")``) ``Shard(dim)`` on both
mesh dims, in order; every other mesh dim is ``Replicate()``.  Meshes are
``DeviceMesh``es or any object with the reference's ``axis_names`` and
``devices`` (:func:`~repro_torch.launch.mesh.axis_sizes`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import axis_sizes

# base (right-aligned) axis roles per leaf name; F = fsdp('data'), M = 'model'
_BASE_RULES = {
    "embedding": ("M", "F"),
    "lm_head": ("F", "M"),
    "wq": ("F", "M"),
    "wk": ("F", "M"),
    "wv": ("F", "M"),
    "wo": ("M", "F"),
    "router": ("F", None),
    "in_proj": ("F", "M"),
    "out_proj": ("M", "F"),
    "conv_w": ("M", None),
    "conv_b": ("M",),
    "norm_scale": ("M",),
    "b_up": ("M",),
    "b_down": (None,),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "scale": (None,),
    "bias": (None,),
}
# MoE expert tensors carry a leading E dim treated as a stack dim (replicated
# in the baseline scheme; the expert-parallel variant remaps it)
_GATED = {"w_gate", "w_up"}
_DOWN = {"w_down"}


class NamedSharding:
    """A per-dim axis assignment on a mesh, and its DTensor placements."""

    def __init__(self, mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def placements(self) -> tuple:
        names = tuple(axis_sizes(self.mesh))
        out = []
        for ax in names:
            dims = [d for d, s in enumerate(self.spec)
                    if s == ax or (isinstance(s, tuple) and ax in s)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and self.spec == other.spec

    def __repr__(self):
        return f"NamedSharding(spec={self.spec})"


def _leaf_name(path) -> str:
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _map(fn, tree):
    return _map_with_path(lambda _, leaf: fn(leaf), tree)


def _spec_for(name: str, shape, mesh, fsdp: bool, expert_parallel: bool = False) -> tuple:
    sizes = axis_sizes(mesh)
    f_axis = "data" if (fsdp and "data" in sizes) else None

    if name in _GATED:
        base = ("F", "M")
    elif name in _DOWN:
        base = ("M", "F")
    elif name in _BASE_RULES:
        base = _BASE_RULES[name]
    else:
        base = ()

    # expert-parallel variant: shard the expert dim of MoE tensors over
    # 'data' (replacing FSDP) and keep d_ff tensor-parallel over 'model'
    if (
        expert_parallel
        and name in (_GATED | _DOWN)
        and len(shape) >= 3
        and shape[-3] % sizes.get("data", 1) == 0
    ):
        spec = [None] * len(shape)
        spec[-3] = "data"
        ff_dim = -1 if name in _GATED else -2
        if shape[ff_dim] % sizes.get("model", 1) == 0:
            spec[ff_dim] = "model"
        return tuple(spec)

    nd = len(shape)
    spec = [None] * nd
    for i, role in enumerate(base[::-1]):
        dim = nd - 1 - i
        if dim < 0:
            break
        if role == "M":
            ax = "model"
        elif role == "F":
            ax = f_axis
        else:
            ax = None
        if ax is not None and shape[dim] % sizes.get(ax, 1) == 0 and shape[dim] > 0:
            spec[dim] = ax
    return tuple(spec)


def param_shardings(params_shape, mesh, fsdp: bool = True, expert_parallel: bool = False,
                    kv_in_shard: bool = False):
    """Tree of :class:`NamedSharding` matching a tree of tensors.

    kv_in_shard (decode): shard wk/wv on the INPUT dim instead of the head
    dim, so decode-step K/V come out replicated (one small all-reduce)."""

    def per_leaf(path, leaf):
        name = _leaf_name(path)
        if kv_in_shard and name in ("wk", "wv"):
            spec = [None] * leaf.ndim
            if leaf.shape[-2] % axis_sizes(mesh).get("model", 1) == 0:
                spec[-2] = "model"
            return NamedSharding(mesh, tuple(spec))
        return NamedSharding(mesh, _spec_for(name, leaf.shape, mesh, fsdp, expert_parallel))

    return _map_with_path(per_leaf, params_shape)


def batch_shardings(batch_shape, mesh, leading_axes=None, fit_dims=None):
    """Shard the leading (client or batch) dim over ('pod','data').

    ``fit_dims=None``: the reference's rule, a leading dim that the axes'
    product does not divide replicated.  Else such a dim is sharded over the
    axes whose product divides it, taken greedily from 'data' on, and each
    axis left over goes to the first of ``fit_dims`` (dims of the leaf that
    the step keeps sharded, e.g. a client's batch) whose size it divides, or
    stays replicated: pod2's 32 clients over its 64 client-axis GPUs lie on
    'data', and 'pod' splits each client's batch."""
    sizes = axis_sizes(mesh)
    if leading_axes is None:
        leading_axes = tuple(a for a in ("pod", "data") if a in sizes)
    total = int(np.prod([sizes[a] for a in leading_axes]))

    def per_leaf(leaf):
        if leaf.ndim and leaf.shape[0] % total == 0:
            return NamedSharding(mesh, (tuple(leading_axes),))
        if fit_dims is None or not leaf.ndim:
            return NamedSharding(mesh, ())
        spec = [()] * leaf.ndim
        for ax in reversed(leading_axes):
            for d in (0, *fit_dims):
                if d < leaf.ndim and leaf.shape[d] % (sizes[ax] * math.prod(
                        sizes[a] for a in spec[d])) == 0:
                    spec[d] = (ax, *spec[d])
                    break
        return NamedSharding(mesh, tuple(s or None for s in spec))

    return _map(per_leaf, batch_shape)


def replicated_client_axes(shardings, mesh) -> dict:
    """``{axis: size}`` of the client axes that no leaf of ``shardings``
    shards."""
    flat = []
    _map(flat.append, shardings)
    used = {a for sh in flat for s in sh.spec for a in (s if isinstance(s, tuple) else (s,))}
    sizes = axis_sizes(mesh)
    return {a: sizes[a] for a in ("pod", "data") if a in sizes and a not in used}


def cache_shardings(cache_shape, mesh, mode: str = "hd"):
    """KV caches: (L, B, T, kvh, hd) — B over ('pod','data') plus, per mode:
    'hd'    : head_dim (or dim -2) over 'model'   (baseline)
    'batch' : batch only; model axis replicated
    'seq'   : cache T dim over 'model'            (flash-decode style)
    SSM states follow the 'hd' rule on their trailing dims in every mode."""
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_total = int(np.prod([sizes[a] for a in dp]))
    m = sizes.get("model", 1)

    def per_leaf(leaf):
        spec = [None] * leaf.ndim
        if leaf.ndim >= 2 and leaf.shape[1] % dp_total == 0:
            spec[1] = dp
        is_kv = leaf.ndim == 5  # (L,B,T,kvh,hd): seq mode only splits a kv buffer's T
        if mode == "seq" and is_kv and leaf.shape[2] % m == 0 and leaf.shape[2] > m:
            spec[2] = "model"
        elif mode != "batch" and leaf.ndim >= 3:
            if leaf.shape[-1] % m == 0:
                spec[-1] = "model"
            elif leaf.shape[-2] % m == 0:
                spec[-2] = "model"
        return NamedSharding(mesh, tuple(spec))

    return _map(per_leaf, cache_shape)


def replicated(tree_shape, mesh):
    return _map(lambda _: NamedSharding(mesh, ()), tree_shape)


# --------------------------------------------------------------------------
# factored serving mesh: same ranks, the model axis split into
# ('model_kv', 'model_hd') so a KV cache can be sharded (kvh x hd)


def make_factored_mesh(mesh, kv: int):
    """Refactor mesh's 'model' axis (size m) into ('model_kv'=kv, 'model_hd'=m/kv)."""
    sizes = axis_sizes(mesh)
    m = sizes["model"]
    assert m % kv == 0, (m, kv)
    shape, names = [], []
    for ax, n in sizes.items():
        if ax == "model":
            shape += [kv, m // kv]
            names += ["model_kv", "model_hd"]
        else:
            shape.append(n)
            names.append(ax)
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def _factor(spec: tuple) -> tuple:
    return tuple(("model_kv", "model_hd") if s == "model" else s for s in spec)


def factored_param_shardings(params_shape, mesh_f, fsdp=True):
    sizes = axis_sizes(mesh_f)
    m_total = sizes.get("model_kv", 1) * sizes.get("model_hd", 1)
    fake_sizes = {"data": sizes.get("data", 1), "model": m_total}
    # the unfactored spec on a duck-typed (data, model) mesh, then translated
    fake = type("M", (), {"axis_names": tuple(fake_sizes),
                          "devices": np.empty(tuple(fake_sizes.values()))})()

    def per_leaf(path, leaf):
        spec = _spec_for(_leaf_name(path), leaf.shape, fake, fsdp)
        return NamedSharding(mesh_f, _factor(spec))

    return _map_with_path(per_leaf, params_shape)


def factored_cache_shardings(cache_shape, mesh_f):
    """(L,B,T,kvh,hd): B over dp, kvh over 'model_kv', hd over 'model_hd'."""
    sizes = axis_sizes(mesh_f)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_total = int(np.prod([sizes[a] for a in dp]))
    kv, hd2 = sizes.get("model_kv", 1), sizes.get("model_hd", 1)

    def per_leaf(leaf):
        spec = [None] * leaf.ndim
        if leaf.ndim >= 2 and leaf.shape[1] % dp_total == 0:
            spec[1] = dp
        if leaf.ndim == 5:
            if leaf.shape[3] % kv == 0:
                spec[3] = "model_kv"
            if leaf.shape[4] % hd2 == 0:
                spec[4] = "model_hd"
        elif leaf.ndim >= 3 and leaf.shape[-1] % (kv * hd2) == 0:
            spec[-1] = ("model_kv", "model_hd")
        return NamedSharding(mesh_f, tuple(spec))

    return _map(per_leaf, cache_shape)


# --------------------------------------------------------------------------
# DTensor stand-ins


def local_shape(shape, sharding: NamedSharding) -> tuple:
    """Rank 0's shard of a global ``shape`` (every sharded dim divides)."""
    sizes = axis_sizes(sharding.mesh)
    out = list(shape)
    for d, s in enumerate(sharding.spec):
        axes = s if isinstance(s, tuple) else ((s,) if s else ())
        out[d] //= math.prod(sizes[a] for a in axes)
    return tuple(out)


def distribute(tree, shardings):
    """A tree of fake tensors as DTensors laid out by ``shardings``: each
    leaf becomes a fake local shard of rank 0's shape, wrapped with the
    global shape — no tensor is split, sent or allocated."""
    from repro_torch.launch.specs import stand_in_mode

    flat_s = []
    _map(flat_s.append, shardings)
    it = iter(flat_s)

    def one(t):
        sh = next(it)
        with stand_in_mode():
            loc = torch.empty(local_shape(t.shape, sh), dtype=t.dtype, device=t.device)
        return DTensor.from_local(loc, sh.mesh, sh.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return _map(one, tree)
