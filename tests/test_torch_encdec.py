"""The port's encoder-decoder family (whisper) against the reference's, from
converted parameters, at ``whisper-small-reduced`` (f32, 2 encoder and 2
decoder layers, d 128, 4 heads of 32, 64 encoder frames):

* ``init`` draws the reference's tree (keys, shapes, dtypes at f32 and
  bf16) and ``init_cache`` its caches, the ``cross`` buffers included;
* at prompt 40 (batch 2: the masked-scores self-attention) and 2,048
  (batch 1: ``CHUNK_THRESHOLD``, the chunked causal self-attention, while
  the cross-attention stays dense): the prefill's last logits, its ``kv``
  and ``cross`` caches, teacher-forced decode steps (2 at 40, 1 at 2,048),
  ``forward``'s logits and ``loss``, all within atol 1e-4 (the two
  frameworks sum in other orders; the differences seen are ~1e-6);
* ``serve`` draws the reference's prompt and ``frames`` (tokens first, from
  the same ``default_rng(0)``), and its greedy tokens equal the reference's
  serving loop on the same parameters; the port's 4 greedy ``decode_step``
  logits are within 1e-4 of the reference's;
* the per-client gradients the vmap engine takes go through the layers'
  rematerialisation, bitwise the gradients that keep every activation and
  within 1e-4 (relative to the largest entry) of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs import get as j_get
from repro.models import build_model as j_build
from repro.models import model as j_model
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ops import tree_leaves
from repro_torch.launch.serve import prompt_batch, serve
from repro_torch.models import build_model, layers
from repro_torch.models.model import CHUNK_THRESHOLD

ARCH = "whisper-small-reduced"
TOL = 1e-4
GREEDY_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops in this file are small: one intra-op thread keeps a
    test worker's torch from contending with the other workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIR = {}


def _pair():
    """The reference model, its parameters and their conversion (once per module)."""
    if not _PAIR:
        cfg, jm, m = get(ARCH), j_build(j_get(ARCH), remat=False), build_model(get(ARCH))
        jp = jm.init(jax.random.PRNGKey(0))
        _PAIR["v"] = (cfg, jm, m, jp, params_from_jax(jax.device_get(jp)))
    return _PAIR["v"]


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol)


def _same_tree(got, want):
    want = jax.tree_util.tree_leaves(want)
    got = tree_leaves(got)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert all(str(t.dtype).split(".")[1] == str(w.dtype) for t, w in zip(got, want))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_init_and_cache_trees_are_the_references(dtype):
    j_cfg, cfg = j_get(ARCH).with_(dtype=dtype), get(ARCH).with_(dtype=dtype)
    jm, m = j_build(j_cfg, remat=False), build_model(cfg)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    got = m.init(torch.Generator().manual_seed(0), "cpu")
    assert sorted(got) == sorted(want) == ["dec_layers", "embed", "enc_final_norm",
                                           "enc_layers"]
    assert sorted(got["dec_layers"]) == sorted(want["dec_layers"])
    assert "xattn" in got["dec_layers"] and "xattn" not in got["enc_layers"]
    _same_tree(got, want)
    cache = m.init_cache(2, 30, "cpu")
    assert tuple(cache["cross"]["k"].shape) == (cfg.num_layers, 2, cfg.encoder_seq,
                                                cfg.num_kv_heads, cfg.resolved_head_dim)
    _same_tree(cache, jm.init_cache(2, 30))


@pytest.mark.parametrize("seq", (40, 2048))
def test_prefill_decode_forward_match_reference(seq):
    cfg, jm, m, jp, tp = _pair()
    assert (seq >= CHUNK_THRESHOLD) == (seq == 2048)
    r = np.random.default_rng(seq)
    bsz, steps = (2, 2) if seq < CHUNK_THRESHOLD else (1, 1)
    b = {"tokens": r.integers(0, cfg.vocab_size, (bsz, seq)),
         "frames": (r.normal(size=(bsz, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(
             np.float32)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    cache_len = seq + steps
    jl, jc = jm.prefill(jp, jb, cache_len)
    with torch.inference_mode():
        tl, tc = m.prefill(tp, tb, cache_len)
    _close(tl, jl)
    for part in ("kv", "cross"):
        for name in ("k", "v"):
            assert tuple(tc[part][name].shape) == jc[part][name].shape
            _close(tc[part][name], jc[part][name])
    nxt = r.integers(0, cfg.vocab_size, (bsz, steps))
    for i in range(steps):                             # teacher-forced decode
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt[:, i:i + 1], jnp.int32), jc,
                                jnp.asarray(seq + i))
        with torch.inference_mode():
            tl, tc = m.decode_step(tp, torch.as_tensor(nxt[:, i:i + 1]), tc, seq + i)
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["kv"][name], jc["kv"][name])
    jb["targets"], tb["targets"] = jb["tokens"], tb["tokens"]
    # the reference's loss from its forward, as its ``loss`` computes it
    j_logits, j_aux = jm.forward(jp, jb)
    j_loss = j_model.cross_entropy(j_logits, jb["targets"])
    with torch.inference_mode():
        t_logits, t_aux = m.forward(tp, tb)
        t_loss, metrics = m.loss(tp, tb)
    assert tuple(t_logits.shape) == (bsz, seq, cfg.vocab_size)
    _close(t_logits, j_logits)
    _close(t_loss, j_loss)
    _close(metrics["ce"], j_loss)
    assert float(t_aux) == float(j_aux) == float(metrics["aux"]) == 0.0


def test_greedy_decode_and_serve_match_reference():
    cfg, jm, m, jp, tp = _pair()
    bsz, seq, gen = 2, 40, GREEDY_STEPS + 1
    b = prompt_batch(cfg, bsz, seq)
    rng = np.random.default_rng(0)
    want_toks = rng.integers(0, cfg.vocab_size, (bsz, seq))
    want_frames = np.asarray(jnp.asarray(
        rng.normal(size=(bsz, cfg.encoder_seq, cfg.d_model)) * 0.02, jnp.float32))
    assert sorted(b) == ["frames", "tokens"]
    np.testing.assert_array_equal(b["tokens"], want_toks)
    np.testing.assert_array_equal(b["frames"], want_frames)
    # the reference's serving loop (repro/launch/serve.py::main) on the same
    # parameters, beside the port's prefill and greedy decode steps
    cache_len = seq + gen
    jb = {"tokens": jnp.asarray(want_toks, jnp.int32), "frames": jnp.asarray(want_frames)}
    jl, jc = jax.jit(lambda p, bb: jm.prefill(p, bb, cache_len))(jp, jb)
    decode = jax.jit(jm.decode_step)
    with torch.inference_mode():
        tl, tc = m.prefill(tp, {k: torch.as_tensor(v) for k, v in b.items()}, cache_len)
    _close(tl, jl)
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    t_tok = torch.argmax(tl[:, -1], dim=-1)[:, None]
    out = [tok]
    for i in range(GREEDY_STEPS):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(tok))
        jl, jc = decode(jp, tok, jc, jnp.asarray(seq + i))
        with torch.inference_mode():
            tl, tc = m.decode_step(tp, t_tok, tc, seq + i)
        _close(tl, jl)
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        t_tok = torch.argmax(tl[:, -1], dim=-1)[:, None]
        out.append(tok)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(tok))
    toks, t = serve(cfg, bsz, seq, gen, device="cpu", params=tp)
    assert toks.shape == (bsz, gen) and t["decode_steps"] == GREEDY_STEPS
    np.testing.assert_array_equal(toks, np.asarray(jnp.concatenate(out, axis=1)))


def test_rematerialised_gradient_matches_reference(monkeypatch):
    # the engine's per-client gradients, vmap(grad(loss)): forward runs each
    # of the 4 layers through remat, bitwise the gradient that keeps every
    # activation, and within TOL (relative to the largest entry) of the
    # reference's
    cfg, jm, m, jp, tp = _pair()
    r = np.random.default_rng(3)
    c, bsz, seq = 2, 1, 12
    toks = r.integers(0, cfg.vocab_size, (c, bsz, seq))
    frames = (r.normal(size=(c, bsz, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    tb = {"tokens": torch.as_tensor(toks), "targets": torch.as_tensor(toks),
          "frames": torch.as_tensor(frames)}
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks),
          "frames": jnp.asarray(frames)}
    per_client = vmap(grad_and_value(lambda p, b: m.loss(p, b)[0]), in_dims=(None, 0))
    apply, calls = layers._Remat.apply, []
    monkeypatch.setattr(layers._Remat, "apply", lambda fn, *a: calls.append(1) or apply(fn, *a))
    grads, losses = per_client(tp, tb)
    assert len(calls) == cfg.encoder_layers + cfg.num_layers
    monkeypatch.setattr(layers._Remat, "apply", lambda fn, *a: fn(*a))
    kept, kept_losses = per_client(tp, tb)
    assert torch.equal(losses, kept_losses)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(kept)))
    j_losses, j_grads = jax.jit(jax.vmap(jax.value_and_grad(lambda p, b: jm.loss(p, b)[0]),
                                         in_axes=(None, 0)))(jp, jb)
    _close(losses, j_losses)
    for got, want in zip(tree_leaves(grads), jax.tree_util.tree_leaves(j_grads)):
        want = np.asarray(want)
        _close(got, want, atol=TOL * np.abs(want).max())
