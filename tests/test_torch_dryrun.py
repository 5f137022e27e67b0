"""The port's dry-run modules (``repro_torch/launch/{mesh,specs,sharding,
roofline,dryrun}.py``) against the reference's, on the CPU, in this process
(no process group is made here; ``test_torch_dryrun_trace.py`` runs the
sharded pass in subprocesses):

* the copied tables and formulas: ``LONG_500K_POLICY``, ``WINDOW_VARIANT``,
  ``resolve_config`` and ``model_flops`` equal the reference's for all 10
  archs x 4 shapes;
* the stand-in trees: ``params_spec``, ``train_inputs``, ``prefill_inputs``
  and ``decode_inputs`` give, at full width for every arch, the keys, shapes
  and dtypes of the reference's ``jax.eval_shape`` trees; the one recorded
  divergence is ``decode_inputs``' position, a Python int where the
  reference traces an int32 scalar;
* the per-leaf specs: ``param_shardings`` (with and without FSDP, expert
  parallel, ``kv_in_shard``), ``batch_shardings``, ``cache_shardings`` (three
  modes) and the factored pair give the reference's specs for every arch's
  parameter and cache trees, on duck-typed meshes of the H100 shapes (32, 8)
  and (2, 32, 8) and the reference's (16, 16) and (2, 16, 16); the
  placements they turn into are checked on one leaf of each kind;
* the ring model: ``count_collectives`` gives bitwise the reference's
  ``parse_collectives`` on HLO lines carrying the same op, bytes and group;
* the package re-exports: every name the reference's ``repro.sim`` and
  ``repro.core`` ``__init__``s bind resolves on ``repro_torch.sim`` and
  ``repro_torch.core`` to the port's own definition (the 13 that were missing
  one case each);
* the routing: a fake CUDA tensor takes the eager forms of
  ``chunked_attention`` and ``ssd_chunked``, and the dry-run's loop sampling
  (``models/layers.py::BlockLoop``) counts exactly the FLOPs and bytes of
  the full loops.

The reference's ``launch/dryrun.py`` forces 512 host devices through
``XLA_FLAGS`` when imported: it is imported with the environment restored
after, and importing it initialises no backend.
"""

import ast
import importlib
import json
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

with mock.patch.dict(os.environ):
    from repro.launch import dryrun as j_dryrun
from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.launch import roofline as j_roofline
from repro.launch import sharding as j_sharding
from repro.launch import specs as j_specs
from repro.models import build_model as j_build
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun, roofline, sharding, specs
from repro_torch.launch.mesh import (
    HBM_BW,
    IB_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    axis_sizes,
    client_axes,
)
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

MESHES = {"pod1": ((32, 8), ("data", "model")),
          "pod2": ((2, 32, 8), ("pod", "data", "model")),
          "v5e-pod1": ((16, 16), ("data", "model")),
          "v5e-pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _duck(shape, names):
    """A mesh with the reference's ``axis_names`` and ``devices``."""
    return type("M", (), {"axis_names": tuple(names), "devices": np.empty(shape)})()


def _leaves(tree, path=()):
    """``{path: leaf}`` of a dict tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _pairs():
    return [(a, s) for a in ARCHS for s in SHAPES]


def test_skipped_pairs_write_the_references_record(tmp_path):
    """The reference's six ``long_500k`` skips, written without a mesh."""
    skips = [a for a in ARCHS if dryrun.resolve_config(a, SHAPES["long_500k"])[0] is None]
    assert len(skips) == 6
    for arch in skips:
        rec = dryrun.run_pair(arch, "long_500k", None, "pod1", str(tmp_path))
        assert rec == json.loads((tmp_path / f"{arch}__long_500k.json").read_text())
        assert rec["skipped"].startswith("skipped: full-attention arch")


def test_copied_tables_equal_the_references():
    assert dryrun.LONG_500K_POLICY == j_dryrun.LONG_500K_POLICY
    assert dryrun.WINDOW_VARIANT == j_dryrun.WINDOW_VARIANT
    assert set(ARCHS) == set(J_ARCHS) and set(SHAPES) == set(J_SHAPES)
    assert len(_pairs()) == 40


@pytest.mark.parametrize("arch,shape", _pairs())
def test_resolve_config_and_model_flops_equal_the_references(arch, shape):
    cfg, note = dryrun.resolve_config(arch, SHAPES[shape])
    j_cfg, j_note = j_dryrun.resolve_config(arch, J_SHAPES[shape])
    assert note == j_note
    assert (cfg is None) == (j_cfg is None)
    if cfg is None:
        return
    assert cfg.sliding_window == j_cfg.sliding_window
    assert dryrun.model_flops(cfg, SHAPES[shape]) == j_dryrun.model_flops(j_cfg, J_SHAPES[shape])


def _same_tree(port, ref):
    """Same keys, shapes and dtypes: a port tree of tensors against a
    reference tree of ShapeDtypeStructs."""
    p, r = _leaves(port), _leaves(ref)
    assert p.keys() == r.keys()
    for k in r:
        assert tuple(p[k].shape) == tuple(r[k].shape), k
        assert str(p[k].dtype).removeprefix("torch.") == str(r[k].dtype), k


@pytest.mark.parametrize("arch", list(ARCHS))
def test_stand_in_trees_match_the_references(arch):
    model, j_model = build_model(ARCHS[arch]), j_build(J_ARCHS[arch])
    params = specs.params_spec(model, "cpu")
    _same_tree(params, j_specs.params_spec(j_model))
    for name, shape in SHAPES.items():
        cfg, j_shape = ARCHS[arch], J_SHAPES[name]
        if shape.mode == "train":
            fl = specs.fl_config_for(cfg, shape)
            assert fl == specs.fl_config_for(cfg, shape) and fl.n_clients == 32
            _same_tree(specs.train_inputs(cfg, shape, fl, "cpu"),
                       j_specs.train_inputs(J_ARCHS[arch], j_shape,
                                            j_specs.fl_config_for(J_ARCHS[arch], j_shape)))
        elif shape.mode == "prefill":
            _same_tree(specs.prefill_inputs(cfg, shape, "cpu"),
                       j_specs.prefill_inputs(J_ARCHS[arch], j_shape))
        else:
            tok, cache, pos = specs.decode_inputs(cfg, shape, model, "cpu")
            j_tok, j_cache, j_pos = j_specs.decode_inputs(J_ARCHS[arch], j_shape, j_model)
            _same_tree({"t": tok, "c": cache}, {"t": j_tok, "c": j_cache})
            # the recorded divergence: a static Python position
            assert isinstance(pos, int) and j_pos.shape == () and str(j_pos.dtype) == "int32"
    # stand-ins allocate nothing
    assert all(isinstance(t, torch._subclasses.FakeTensor) for t in _leaves(params).values())


@pytest.fixture(scope="module")
def reference_specs():
    """The reference's sharding functions returning their PartitionSpecs:
    its ``NamedSharding`` cannot take a duck-typed mesh."""
    with mock.patch.object(j_sharding, "NamedSharding", lambda mesh, spec: spec):
        yield j_sharding


def _entries(spec) -> tuple:
    """Per-dim entries; a one-name tuple is that name (jax's normal form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _same_specs(port, ref):
    p, r = _leaves(port), _leaves(jax.tree_util.tree_map(
        _entries, ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert p.keys() == r.keys()
    for k in r:
        assert _entries(p[k].spec) == r[k], (k, p[k].spec, r[k])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_per_leaf_specs_match_the_references(arch, mesh_name, reference_specs):
    j_sh = reference_specs
    mesh = _duck(*MESHES[mesh_name])
    model, j_model = build_model(ARCHS[arch]), j_build(J_ARCHS[arch])
    params, j_params = specs.params_spec(model, "cpu"), j_specs.params_spec(j_model)
    for kw in ({}, {"fsdp": False}, {"expert_parallel": True}, {"kv_in_shard": True}):
        _same_specs(sharding.param_shardings(params, mesh, **kw),
                    j_sh.param_shardings(j_params, mesh, **kw))
    for name in ("train_4k", "prefill_32k"):
        shape = SHAPES[name]
        if shape.mode == "train":
            fl = specs.fl_config_for(ARCHS[arch], shape)
            batch = specs.train_inputs(ARCHS[arch], shape, fl, "cpu")
            j_batch = j_specs.train_inputs(J_ARCHS[arch], J_SHAPES[name],
                                           j_specs.fl_config_for(J_ARCHS[arch], J_SHAPES[name]))
        else:
            batch = specs.prefill_inputs(ARCHS[arch], shape, "cpu")
            j_batch = j_specs.prefill_inputs(J_ARCHS[arch], J_SHAPES[name])
        _same_specs(sharding.batch_shardings(batch, mesh), j_sh.batch_shardings(j_batch, mesh))
    for name in ("decode_32k", "long_500k"):
        cfg, _ = dryrun.resolve_config(arch, SHAPES[name])
        if cfg is None:
            continue
        j_cfg, _ = j_dryrun.resolve_config(arch, J_SHAPES[name])
        _, cache, _ = specs.decode_inputs(cfg, SHAPES[name], build_model(cfg), "cpu")
        _, j_cache, _ = j_specs.decode_inputs(j_cfg, J_SHAPES[name], j_build(j_cfg))
        for mode in ("hd", "batch", "seq"):
            _same_specs(sharding.cache_shardings(cache, mesh, mode),
                        j_sh.cache_shardings(j_cache, mesh, mode))
        # the factored serving mesh: the model axis split into (kv, m / kv)
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        kv = min(cfg.num_kv_heads or 1, sizes["model"])
        if sizes["model"] % kv:
            continue
        f_shape = tuple(s for ax, n in sizes.items()
                        for s in ((kv, n // kv) if ax == "model" else (n,)))
        f_names = tuple(a for ax in sizes
                        for a in (("model_kv", "model_hd") if ax == "model" else (ax,)))
        mesh_f = _duck(f_shape, f_names)
        _same_specs(sharding.factored_param_shardings(params, mesh_f),
                    j_sh.factored_param_shardings(j_params, mesh_f))
        _same_specs(sharding.factored_cache_shardings(cache, mesh_f),
                    j_sh.factored_cache_shardings(j_cache, mesh_f))


def test_specs_turn_into_placements():
    from torch.distributed.tensor import Replicate, Shard

    pod2 = _duck(*MESHES["pod2"])
    assert axis_sizes(pod2) == {"pod": 2, "data": 32, "model": 8}
    assert client_axes(pod2) == ("pod", "data")
    assert sharding.NamedSharding(pod2, (("pod", "data"), None)).placements == (
        Shard(0), Shard(0), Replicate())
    assert sharding.NamedSharding(pod2, ("data", "model")).placements == (
        Replicate(), Shard(0), Shard(1))
    f = _duck((32, 8, 1), ("data", "model_kv", "model_hd"))
    assert sharding.NamedSharding(f, (None, ("model_kv", "model_hd"))).placements == (
        Replicate(), Shard(1), Shard(1))
    assert sharding.NamedSharding(f, ()).placements == (Replicate(),) * 3
    assert sharding.local_shape((64, 4096, 1024), sharding.NamedSharding(
        pod2, (("pod", "data"), None, "model"))) == (1, 4096, 128)


@pytest.mark.parametrize("mesh_name", ["pod1", "pod2"])
def test_batches_fit_the_client_axes(mesh_name):
    """The dry-run's batch layout (``batch_shardings(fit_dims=...)``): on
    pod2, 32 clients over 64 client-axis GPUs lie on 'data' and 'pod'
    splits each client's 8 sequences; 32 prefill sequences lie on 'data',
    'pod' replicated.  On pod1 the product divides, and the layout is the
    reference's."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _duck(*MESHES[mesh_name])
    cfg, train, prefill = ARCHS["llama3-8b"], SHAPES["train_4k"], SHAPES["prefill_32k"]
    batch = specs.train_inputs(cfg, train, specs.fl_config_for(cfg, train), "cpu")
    t_sh = sharding.batch_shardings(batch, mesh, fit_dims=(2,))
    p_sh = sharding.batch_shardings(specs.prefill_inputs(cfg, prefill, "cpu"), mesh, fit_dims=())
    want = {"pod1": ((1, 1, 8, 4096), (1, 32768), {}),
            "pod2": ((1, 1, 4, 4096), (1, 32768), {"pod": 2})}[mesh_name]
    assert sharding.local_shape(batch["tokens"].shape, t_sh["tokens"]) == want[0]
    assert sharding.local_shape((32, 32768), p_sh["tokens"]) == want[1]
    assert sharding.replicated_client_axes(t_sh, mesh) == {}
    assert sharding.replicated_client_axes(p_sh, mesh) == want[2]
    if mesh_name == "pod1":
        assert t_sh == sharding.batch_shardings(batch, mesh)
    else:
        assert t_sh["tokens"].placements == (Shard(2), Shard(0), Replicate())


def test_h100_constants():
    assert (PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW, IB_BW) == (989e12, 3.35e12, 450e9, 50e9)


_HLO_TYPES = {"bf16": 2, "f32": 4, "s32": 4, "f16": 2}


@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                "collective-permute"])
def test_ring_model_equals_the_references(op):
    rng = np.random.default_rng(0)
    lines, records = [], []
    for i in range(12):
        dt = list(_HLO_TYPES)[i % 4]
        dims = [int(x) for x in rng.integers(1, 4096, size=1 + i % 3)]
        g = [2, 4, 8, 16, 32][i % 5]
        nbytes = int(np.prod(dims)) * _HLO_TYPES[dt]
        groups = (f"replica_groups=[{512 // g},{g}]<=[512]" if i % 2
                  else "replica_groups={{" + ",".join(str(r) for r in range(g)) + "}}")
        start = "-start" if i % 3 == 0 and op != "collective-permute" else ""
        lines.append(f"  %x.{i} = {dt}[{','.join(map(str, dims))}]{{0}} {op}{start}(%y.{i}), "
                     f"channel_id={i}, {groups}")
        records.append((op, nbytes, g if op != "collective-permute" else 2, i % 2 == 0))
    ref = j_roofline.parse_collectives("\n".join(lines))
    port = roofline.count_collectives(records)
    assert port.counts == ref.counts
    assert port.raw_bytes == ref.raw_bytes
    assert port.traffic_bytes == ref.traffic_bytes
    assert sum(port.link_traffic.values()) == ref.total_traffic()


def test_roofline_terms_and_bottleneck():
    coll = roofline.count_collectives([("all-reduce", 1e9, 8, True),
                                       ("all-gather", 1e9, 32, False)])
    rf = roofline.build_roofline("a", "s", "pod1", 256, {"flops": 989e12, "bytes accessed": 0},
                                 coll, model_flops=0.0)
    assert rf.compute_s == 1.0 and rf.memory_s == 0.0
    assert rf.collective_s == 2e9 * 7 / 8 / NVLINK_BW + 1e9 * 31 / 32 / IB_BW
    assert rf.bottleneck == "compute" and rf.useful_flops_ratio == 0.0
    ref_fields = set(j_roofline.Roofline.__dataclass_fields__)
    assert set(roofline.Roofline.__dataclass_fields__) == ref_fields


def test_fake_cuda_tensors_take_the_eager_forms(monkeypatch):
    """The kernels read ``data_ptr()``: a fake CUDA tensor, which has none,
    is routed to the eager forms (stubbed here: this torch has no CUDA to
    run them on)."""
    def refuse(*a, **k):
        raise AssertionError("a kernel was called on a fake tensor")

    monkeypatch.setattr(L, "flash_attention_heads", refuse)
    monkeypatch.setattr(S, "ssd_scan_heads", refuse)
    monkeypatch.setattr(L, "chunked_attention_eager", lambda *a, **k: "eager")
    monkeypatch.setattr(S, "ssd_chunked_eager", lambda *a, **k: "eager")
    with specs.stand_in_mode():
        q = torch.empty((1, 64, 2, 16), device="cuda")
        assert q.is_cuda and L.on_card(q) is False
        with torch.no_grad():
            assert L.chunked_attention(q, q, q) == "eager"
            assert S.ssd_chunked(q, q, q, q, q, 16) == "eager"
    assert L.on_card(torch.zeros(2)) is False


def _counted(fn, sampled: bool):
    counter = dryrun.LocalCounter()
    L._LOOP_COUNTER[0] = counter.repeat if sampled else None
    try:
        with specs.stand_in_mode(), counter:
            fn()
    finally:
        L._LOOP_COUNTER[0] = None
    return counter


@pytest.mark.parametrize("case", ["attention", "attention-window", "ssd-fused", "ssd-chunks"])
def test_sampled_block_loops_count_the_full_loops(case):
    """Every iteration of an eager form's block loop has the same shapes:
    the first one counted n times is the whole loop, FLOPs and bytes."""
    with specs.stand_in_mode():
        if case.startswith("attention"):
            q = torch.empty((2, 256, 4, 32))
            window = 96 if case.endswith("window") else None

            def fn():
                L.chunked_attention_eager(q, q, q, window=window, block_q=64, block_k=32)
        else:
            nc = 65 if case == "ssd-fused" else 8      # > 64 chunks: the fused pass
            xs = torch.empty((1, nc * 4, 2, 8))
            b = torch.empty((1, nc * 4, 4))
            dt = torch.empty((1, nc * 4, 2))

            def fn():
                S.ssd_chunked_eager(xs, b, b, dt, dt, 4)
    full, sampled = _counted(fn, False), _counted(fn, True)
    assert sampled.sampled > 0 and full.sampled == 0
    assert sampled.flops == full.flops > 0
    assert sampled.bytes == full.bytes
    if case.startswith("attention"):            # under autograd every iteration runs
        q.requires_grad_(True)
        assert _counted(fn, True).sampled == 0


REEXPORTS = {
    "sim": ("SIM_SCHEMA", "build_client_mesh", "ClientState", "SystemConfig",
            "init_client_state", "step_client_state", "register"),
    "core": ("STATEFUL_SAMPLERS", "SamplerState", "clustered_probabilities",
             "cyclic_probabilities", "threshold_probabilities", "init_sampler_state"),
}


def _bound_names(package: str) -> dict:
    """``{name: submodule}`` of what the reference's package ``__init__``
    binds by ``from repro.<package>.<submodule> import ...``."""
    path = os.path.join(os.path.dirname(__file__), "..", "src", "repro", package, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return {a.asname or a.name: node.module for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module for a in node.names}


@pytest.mark.parametrize("package,name", [(p, n) for p, names in REEXPORTS.items() for n in names])
def test_package_reexports_the_references_name(package, name):
    module = _bound_names(package)[name]
    port = importlib.import_module(f"repro_torch.{package}")
    definition = importlib.import_module(module.replace("repro.", "repro_torch.", 1))
    assert getattr(port, name) is getattr(definition, name)


@pytest.mark.parametrize("package", sorted(REEXPORTS))
def test_every_name_the_references_package_binds_resolves(package):
    port = importlib.import_module(f"repro_torch.{package}")
    assert [n for n in _bound_names(package) if not hasattr(port, n)] == []
