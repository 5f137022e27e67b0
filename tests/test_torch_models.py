"""The port's model substrate and serving driver against the reference's.

* ``ModelConfig`` and the registry: the port's copies equal the reference's
  field by field for all ten architectures, reduced or not, with
  ``param_count()`` and ``active_param_count()``.
* ``params_from_jax`` carries a bfloat16 reference tree bit for bit (every
  full config is bf16).
* ``zamba2-2.7b-reduced`` and ``mamba2-130m-reduced`` from the reference's
  parameters, converted: prefill logits and caches, 4 teacher-forced decode
  steps and ``forward`` / ``loss``, at prompt 40 (the masked-scores attention,
  batched SSD chunks; batch 2) and 2,100 (>= ``CHUNK_THRESHOLD``: the
  chunked attention; 132 chunks of 16: the fused SSD pass; not a chunk
  multiple: the padding; batch 1), all within atol 1e-4 in f32 (the two
  frameworks sum in other orders; the differences seen are ~1e-6).
* Every family builds: the full decoder and encoder-decoder configs on the
  meta device with the reference's cache shapes (whisper's ``cross``
  buffers among them); their parity is ``tests/test_torch_decoder.py`` and
  ``tests/test_torch_encdec.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get as j_get
from repro.models import build_model as j_build
from repro_torch.configs import ARCHS, get
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ops import tree_leaves
from repro_torch.models import build_model
from repro_torch.models.model import CHUNK_THRESHOLD

TOL = 1e-4
MODEL_ARCHS = ("zamba2-2.7b-reduced", "mamba2-130m-reduced")


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_configs_equal_the_references(name):
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for suffix in ("", "-reduced"):
        mine, theirs = get(name + suffix), j_get(name + suffix)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
        assert mine.resolved_head_dim == theirs.resolved_head_dim
        assert mine.layer_kinds() == theirs.layer_kinds()
        assert mine.with_(d_model=64) == get(name + suffix).with_(d_model=64)


def test_params_from_jax_carries_bf16_bitwise():
    """The fault the repair fixes: ``np.asarray`` of a jax bf16 array has
    dtype ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses."""
    cfg = j_get("zamba2-2.7b-reduced").with_(dtype="bfloat16")
    jp = jax.device_get(j_build(cfg, remat=False).init(jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_leaves(jp)
    bf16 = [leaf for leaf in leaves if leaf.dtype == jnp.bfloat16]
    assert bf16 and np.asarray(bf16[0]).dtype == ml_dtypes.bfloat16
    with pytest.raises(TypeError):
        torch.from_numpy(np.array(bf16[0], copy=True))     # what the old code did
    tp = params_from_jax(jp)
    got = tree_leaves(tp)
    assert len(got) == len(leaves)
    for t, leaf in zip(got, leaves):
        want = np.asarray(leaf)
        assert tuple(t.shape) == want.shape
        if want.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  want.view(np.uint16))
        else:
            assert np.array_equal(t.numpy(), want)


def _pair(arch):
    j_cfg, cfg = j_get(arch), get(arch)
    jm, m = j_build(j_cfg, remat=False), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return cfg, jm, m, jp, params_from_jax(jax.device_get(jp))


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=TOL)


@pytest.mark.parametrize("seq", (40, 2100))
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_decode_forward_match_reference(arch, seq):
    cfg, jm, m, jp, tp = _pair(arch)
    assert (seq >= CHUNK_THRESHOLD) == (seq == 2100)
    r = np.random.default_rng(seq)
    bsz = 2 if seq < CHUNK_THRESHOLD else 1
    toks = r.integers(0, cfg.vocab_size, (bsz, seq))
    cache_len = seq + 4
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, cache_len)
    with torch.inference_mode():
        tl, tc = m.prefill(tp, {"tokens": torch.as_tensor(toks)}, cache_len)
    _close(tl, jl)
    assert sorted(tc) == sorted(jc)
    for group in tc:
        for name in tc[group]:
            assert tuple(tc[group][name].shape) == jc[group][name].shape
            _close(tc[group][name], jc[group][name])
    nxt = r.integers(0, cfg.vocab_size, (bsz, 4))
    for i in range(4):                                 # teacher-forced decode
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt[:, i:i + 1], jnp.int32), jc,
                                jnp.asarray(seq + i))
        with torch.inference_mode():
            tl, tc = m.decode_step(tp, torch.as_tensor(nxt[:, i:i + 1]), tc, seq + i)
        _close(tl, jl)
    for group in tc:
        for name in tc[group]:
            _close(tc[group][name], jc[group][name])
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    j_logits, _ = jm.forward(jp, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    j_loss, _ = jm.loss(jp, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    with torch.inference_mode():
        t_batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        t_logits, _ = m.forward(tp, t_batch)
        t_loss, metrics = m.loss(tp, t_batch)
    _close(t_logits, j_logits)
    _close(t_loss, j_loss)
    assert float(metrics["ce"]) == float(t_loss)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_init_and_init_cache_are_shaped_like_the_references(arch):
    """Random init from a torch.Generator: the reference's tree, shapes and
    dtypes (cast to cfg.dtype), at f32 and bf16; and the empty cache."""
    for dtype in ("float32", "bfloat16"):
        j_cfg, cfg = j_get(arch).with_(dtype=dtype), get(arch).with_(dtype=dtype)
        jm, m = j_build(j_cfg, remat=False), build_model(cfg)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        tp = m.init(torch.Generator().manual_seed(0), "cpu")
        for want, got in ((shapes, tp), (jm.init_cache(2, 30), m.init_cache(2, 30, "cpu"))):
            want, got = jax.tree_util.tree_leaves(want), tree_leaves(got)
            assert [tuple(t.shape) for t in got] == [w.shape for w in want]
            assert all(str(t.dtype).split(".")[1] == str(w.dtype) for t, w in zip(got, want))


@pytest.mark.parametrize("name", ("llama3-8b", "mixtral-8x7b", "paligemma-3b",
                                  "whisper-small", "granite-8b-reduced"))
def test_every_family_builds(name):
    """The decoder and encoder-decoder families build, their caches shaped
    like the reference's (the full configs on the meta device; whisper's
    ``cross`` buffers included), and the reduced one initialises to the
    reference's tree."""
    cfg = get(name)
    m, jm = build_model(cfg), j_build(j_get(name), remat=False)
    want = jax.eval_shape(lambda: jm.init_cache(2, 24))
    got = m.init_cache(2, 24, "meta")
    assert sorted(got) == sorted(want)
    if cfg.encoder_layers:
        assert tuple(got["cross"]["k"].shape) == (cfg.num_layers, 2, cfg.encoder_seq,
                                                  cfg.num_kv_heads, cfg.resolved_head_dim)
    want, got = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert all(str(t.dtype).split(".")[1] == str(w.dtype) for t, w in zip(got, want))
    if name.endswith("-reduced"):
        shapes = jax.tree_util.tree_leaves(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
        tp = tree_leaves(m.init(torch.Generator().manual_seed(0), "cpu"))
        assert [tuple(t.shape) for t in tp] == [w.shape for w in shapes]
