"""Checkpointing: trees -> versioned ``step-XXXXXXXX/{leaves.npz,index.json}``,
the port of ``repro/checkpoint/ckpt.py`` with its layout kept byte for byte,
so a checkpoint crosses between the two packages.

Leaves are saved flattened with their tree paths as keys, printed as jax's
``keystr`` prints them: ``['k']`` for a dict key (dicts flatten in sorted
key order, as jax's do), ``.field`` for a NamedTuple field
(``ClientState``, ``SamplerState``), ``[i]`` for a list or tuple entry, and
nothing for the empty tuple ``()`` or ``None``.  A leaf is a torch tensor
(synced and copied to the host) or anything ``np.asarray`` takes.  Two
contracts every caller relies on:

* **Atomicity** — :func:`save` stages the whole payload into a hidden temp
  directory next to the final name and publishes it with one
  ``os.replace`` (the payload and the directory fsynced).  A crash at any
  point leaves the previous complete set untouched, or an orphaned
  ``.tmp-*`` directory that :func:`restore` never looks at.
* **Validation** — :func:`restore` raises ``ValueError`` naming the
  offending tree key on any structure, dtype, or shape mismatch between
  the checkpoint and the caller's template tree; nothing is coerced.

bfloat16: the reference writes an ``ml_dtypes`` leaf, which the npz stores
as raw ``<V2`` with ``"bfloat16"`` in ``index.json``'s ``dtypes``.  The port
writes a torch bf16 tensor as the same ``<V2`` payload and the same index
entry, and on restore takes the dtype from the index and views the ``<V2``
bytes as int16 and then ``torch.bfloat16``, bit for bit.  (The reference's
own :func:`restore` compares the loaded ``V2`` with ``bfloat16`` and
refuses its own leaves.)

Layout: ``save(root, tree, step=k)`` writes ``root/step-%08d/``; steps
coexist (``keep`` prunes the oldest) and ``restore(root, ...)`` picks the
latest complete step.  The older flat layout (``index.json`` directly under
``root``) still restores, and a ``step-XXXXXXXX`` directory as ``path`` pins
the step.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zipfile

import numpy as np
import torch

# index.json schema: version 1 has dtypes/shapes and the free-form `meta`
# block the resume layer rides on; the flat layout (no `schema`) still reads.
CKPT_SCHEMA = 1

_STEP_RE = re.compile(r"^step-(\d{8})$")
_BF16 = "bfloat16"
# the npz header the reference's ml_dtypes bfloat16 leaves get
_BF16_DESCR = "<V2"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> list:
    """``[(key, leaf)]`` in jax's ``tree_flatten_with_path`` order, keys as
    ``jax.tree_util.keystr`` prints them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _dtype_name(leaf) -> str:
    """numpy's name of a leaf's dtype (``"bfloat16"`` for torch's)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array; a bf16 tensor as its raw 2-byte words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.asarray(leaf).shape


def _sync(leaves) -> None:
    for dev in {t.device for t in leaves if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _write_npz(path: str, arrays: list, names: list) -> None:
    """``np.savez`` of ``a{i}`` members, with a bf16 leaf's member written
    under the reference's ``<V2`` header."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, (a, name) in enumerate(zip(arrays, names)):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as fid:
                if name == _BF16:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": _BF16_DESCR, "fortran_order": False,
                              "shape": a.shape})
                    fid.write(a.tobytes())
                else:
                    np.lib.format.write_array(fid, a, allow_pickle=False)


def _step_dirname(step: int) -> str:
    return f"step-{int(step):08d}"


def _read_index(d: str) -> dict:
    with open(os.path.join(d, "index.json")) as f:
        return json.load(f)


def _is_complete(d: str) -> bool:
    """True iff ``d`` holds a loadable (index, npz) pair with every leaf."""
    try:
        idx = _read_index(d)
        with np.load(os.path.join(d, "leaves.npz")) as data:
            names = set(data.files)
        return all(f"a{i}" in names for i in range(len(idx["keys"])))
    except Exception:
        return False


def available_steps(path: str) -> list:
    """Sorted step numbers with a complete checkpoint under root ``path``
    (a crashed save's ``.tmp-*`` directory, or a ``step-*`` directory whose
    payload does not load, is left out)."""
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return []
    steps = []
    for name in names:
        m = _STEP_RE.match(name)
        if m and _is_complete(os.path.join(path, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(path: str):
    """The newest complete step under root ``path`` (None when there is none)."""
    steps = available_steps(path)
    return steps[-1] if steps else None


def resolve_dir(path: str, step=None) -> str:
    """The one checkpoint directory to read: ``path`` may be a checkpoint
    root (pick ``step``, or the latest complete step), a ``step-XXXXXXXX``
    directory, or a flat-layout directory (``index.json`` inside).  Raises
    ``FileNotFoundError`` when no complete checkpoint exists."""
    if os.path.isfile(os.path.join(path, "index.json")):
        return path
    if step is not None:
        d = os.path.join(path, _step_dirname(step))
        if not _is_complete(d):
            raise FileNotFoundError(
                f"no complete checkpoint for step {step} under {path!r} "
                f"(available: {available_steps(path)})"
            )
        return d
    s = latest_step(path)
    if s is None:
        raise FileNotFoundError(f"no complete checkpoint under {path!r}")
    return os.path.join(path, _step_dirname(s))


def save(path: str, tree, step: int = 0, meta=None, keep: int = 0) -> str:
    """Atomically write ``tree`` at ``step`` under root ``path``.

    The leaves go to the host first (after a sync of their devices), so the
    checkpoint holds copies that later work on the device cannot touch.  The
    payload (``leaves.npz`` + ``index.json``, fsynced) is staged into
    ``path/.tmp-step-...-<pid>`` and published with one ``os.replace`` to
    ``path/step-XXXXXXXX``.  ``meta`` (a JSON-serialisable dict) rides in
    the index; ``keep > 0`` prunes all but the newest ``keep`` complete
    steps after the publish.  Returns the final step directory.
    """
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    keys, leaves = [k for k, _ in flat], [v for _, v in flat]
    _sync(leaves)
    names = [_dtype_name(v) for v in leaves]
    arrays = [_to_host(v) for v in leaves]
    final = os.path.join(path, _step_dirname(step))
    tmp = os.path.join(path, f".tmp-{_step_dirname(step)}-{os.getpid()}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _write_npz(os.path.join(tmp, "leaves.npz"), arrays, names)
    with open(os.path.join(tmp, "leaves.npz"), "rb+") as f:
        os.fsync(f.fileno())
    index = {
        "schema": CKPT_SCHEMA,
        "step": int(step),
        "keys": keys,
        "dtypes": names,
        "shapes": [list(a.shape) for a in arrays],
        "meta": {} if meta is None else meta,
    }
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(final):
        shutil.rmtree(final)  # a re-save of the same step
    os.replace(tmp, final)
    # make the publish durable before pruning anything older
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    if keep and keep > 0:
        for s in available_steps(path)[:-keep]:
            shutil.rmtree(os.path.join(path, _step_dirname(s)), ignore_errors=True)
    return final


def read_meta(path: str, step=None) -> tuple:
    """``(meta, step)`` of the checkpoint ``path`` resolves to, from
    ``index.json`` alone (no payload is read)."""
    idx = _read_index(resolve_dir(path, step))
    return idx.get("meta", {}), int(idx.get("step", 0))


def _leaf(arr: np.ndarray, saved: str | None, like, key: str, where: str):
    """The restored leaf for template leaf ``like`` from the npz array
    ``arr`` (``saved``: its dtype in the index), validated; a tensor
    template gives a tensor on the template's device."""
    got = _BF16 if saved == _BF16 and arr.dtype.kind == "V" and arr.itemsize == 2 \
        else str(arr.dtype)
    want = _dtype_name(like)
    if got != want:
        raise ValueError(
            f"checkpoint dtype mismatch at key {key!r} in {where}: "
            f"saved {got}, template wants {want} "
            f"(refusing to coerce — a silent .astype loses bits)"
        )
    if arr.shape != _shape(like):
        raise ValueError(
            f"checkpoint shape mismatch at key {key!r} in {where}: "
            f"saved {arr.shape}, template wants {_shape(like)}"
        )
    if not isinstance(like, torch.Tensor):
        return arr
    if got == _BF16:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(like.device)


def _validated_leaves(idx: dict, data, keys, leaves, where: str) -> list:
    saved_keys = idx["keys"]
    if saved_keys != keys:
        bad = next(
            (f"checkpoint has {a!r}, template wants {b!r}"
             for a, b in zip(saved_keys, keys) if a != b),
            f"checkpoint has {len(saved_keys)} leaves, template wants {len(keys)}",
        )
        raise ValueError(
            f"checkpoint/tree structure mismatch in {where}: {bad} "
            f"(first divergence of {len(saved_keys)} vs {len(keys)} keys)"
        )
    dtypes = idx.get("dtypes", [None] * len(keys))
    return [_leaf(data[f"a{i}"], dtypes[i], like, key, where)
            for i, (key, like) in enumerate(zip(keys, leaves))]


def restore(path: str, like_tree, step=None) -> tuple:
    """Restore the newest complete checkpoint under ``path``; returns
    ``(tree, step)``.

    ``like_tree`` is the template: the saved key set, every leaf's dtype and
    every leaf's shape are checked against it, and a mismatch raises
    ``ValueError`` naming the key.  ``step`` pins a step; ``path`` may also
    be a ``step-XXXXXXXX`` directory (or a flat-layout checkpoint).
    """
    d = resolve_dir(path, step)
    idx = _read_index(d)
    flat = _flatten(like_tree)
    keys, leaves = [k for k, _ in flat], [v for _, v in flat]
    with np.load(os.path.join(d, "leaves.npz")) as data:
        new_leaves = _validated_leaves(idx, data, keys, leaves, d)
    return _unflatten(like_tree, iter(new_leaves)), int(idx["step"])


def restore_subtree(path: str, like_tree, prefix: str, step=None) -> tuple:
    """Restore only the leaves under ``prefix`` (e.g. ``"['params']"``) into
    ``like_tree``, with :func:`restore`'s checks; returns ``(tree, step)``.
    The serving path pulls the model parameters out of a round checkpoint
    this way."""
    d = resolve_dir(path, step)
    idx = _read_index(d)
    flat = _flatten(like_tree)
    keys, leaves = [k for k, _ in flat], [v for _, v in flat]
    sub = {k[len(prefix):]: i for i, k in enumerate(idx["keys"]) if k.startswith(prefix)}
    if not sub:
        raise ValueError(
            f"checkpoint {d} has no leaves under prefix {prefix!r} "
            f"(keys: {idx['keys'][:4]}...)"
        )
    missing = [k for k in keys if k not in sub]
    if missing:
        raise ValueError(
            f"checkpoint/tree structure mismatch in {d}: template key "
            f"{missing[0]!r} not under prefix {prefix!r}"
        )
    dtypes = idx.get("dtypes", [None] * len(idx["keys"]))
    with np.load(os.path.join(d, "leaves.npz")) as data:
        new_leaves = [_leaf(data[f"a{sub[key]}"], dtypes[sub[key]], like, prefix + key, d)
                      for key, like in zip(keys, leaves)]
    return _unflatten(like_tree, iter(new_leaves)), int(idx["step"])
