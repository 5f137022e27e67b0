"""The port's decoder family against the reference's, from converted
parameters, at the reduced configs:

* dense (``llama3-8b``: GQA; ``granite-20b``: MQA; ``gemma-7b``: GeGLU,
  ``norm_offset``, ``scale_embeddings``, head dim 32 of 256), the VLM prefix
  (``paligemma-3b``: stub ``patches`` before the tokens, a bidirectional
  prefix, logits sliced past it, a cache of ``cache_len + prefix``) and MoE
  (``mixtral-8x7b``: top-2 with a sliding window of 64 at the reduced size,
  so prompt 2,048 fills the ring buffer; ``llama4-maverick``: top-1);
* each at prompt 40 (batch 2: the masked-scores attention) and 2,048
  (batch 1: = ``CHUNK_THRESHOLD``, the chunked attention with its window or
  prefix): the prefill's last logits and its KV cache, teacher-forced
  decode steps (2 at prompt 40, 1 at 2,048), and ``forward`` / ``loss`` (ce + ``router_aux_coef`` x aux)
  with its ``aux``, all within atol 1e-4 in f32 (the differences seen are
  ~1e-6: the two frameworks sum in other orders);
* ``llama3-8b-reduced`` in bf16: the prefill logits within bf16 rounding
  (atol 5e-2 at logits of ~1) and the first greedy tokens equal;
* ``serve`` of the VLM draws its ``patches`` after the tokens from the same
  ``default_rng(0)``, as the reference's ``launch/serve.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.models import build_model as j_build
from repro.models import model as j_model
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import prompt_batch, serve
from repro_torch.models import build_model
from repro_torch.models.model import CHUNK_THRESHOLD

TOL = 1e-4
BF16_ATOL = 5e-2
ARCHS = ("llama3-8b-reduced", "granite-20b-reduced", "gemma-7b-reduced",
         "paligemma-3b-reduced", "mixtral-8x7b-reduced",
         "llama4-maverick-400b-a17b-reduced")
DECODE_STEPS = 2


@pytest.fixture(scope="module")
def pairs():
    """One reference model and its converted parameters per architecture."""
    cache = {}

    def pair(arch, dtype=None):
        if (arch, dtype) not in cache:
            j_cfg, cfg = j_get(arch), get(arch)
            if dtype is not None:
                j_cfg, cfg = j_cfg.with_(dtype=dtype), cfg.with_(dtype=dtype)
            jm, m = j_build(j_cfg, remat=False), build_model(cfg)
            jp = jm.init(jax.random.PRNGKey(0))
            cache[(arch, dtype)] = (cfg, jm, m, jp, params_from_jax(jax.device_get(jp)))
        return cache[(arch, dtype)]

    return pair


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol)


def _batch(cfg, r, bsz, seq):
    b = {"tokens": r.integers(0, cfg.vocab_size, (bsz, seq))}
    if cfg.prefix_tokens:
        b["patches"] = (r.normal(size=(bsz, cfg.prefix_tokens, cfg.d_model))
                        * 0.02).astype(np.float32)
    return b


@pytest.mark.parametrize("seq", (40, 2048))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_forward_match_reference(pairs, arch, seq):
    cfg, jm, m, jp, tp = pairs(arch)
    assert (seq >= CHUNK_THRESHOLD) == (seq == 2048)
    r = np.random.default_rng(seq)
    bsz, steps = (2, DECODE_STEPS) if seq < CHUNK_THRESHOLD else (1, 1)
    b = _batch(cfg, r, bsz, seq)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    cache_len = seq + steps
    jl, jc = jm.prefill(jp, jb, cache_len)
    with torch.inference_mode():
        tl, tc = m.prefill(tp, tb, cache_len)
    _close(tl, jl)
    for name in ("k", "v"):
        assert tuple(tc["kv"][name].shape) == jc["kv"][name].shape
        _close(tc["kv"][name], jc["kv"][name])
    if cfg.sliding_window:
        assert tc["kv"]["k"].shape[2] == min(cfg.sliding_window, cache_len)
    pre = cfg.prefix_tokens
    nxt = r.integers(0, cfg.vocab_size, (bsz, steps))
    for i in range(steps):                             # teacher-forced decode
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt[:, i:i + 1], jnp.int32), jc,
                                jnp.asarray(seq + pre + i))
        with torch.inference_mode():
            tl, tc = m.decode_step(tp, torch.as_tensor(nxt[:, i:i + 1]), tc, seq + pre + i)
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["kv"][name], jc["kv"][name])
    jb["targets"], tb["targets"] = jb["tokens"], tb["tokens"]
    # the reference's loss from its forward, as its ``loss`` computes it
    # (one reference forward a case)
    j_logits, j_aux = jm.forward(jp, jb)
    j_ce = j_model.cross_entropy(j_logits, jb["targets"])
    j_loss, j_metrics = j_ce + cfg.router_aux_coef * j_aux, {"ce": j_ce, "aux": j_aux}
    with torch.inference_mode():
        t_logits, t_aux = m.forward(tp, tb)
        t_loss, metrics = m.loss(tp, tb)
    assert tuple(t_logits.shape) == (bsz, seq, cfg.vocab_size)
    _close(t_logits, j_logits)
    _close(t_loss, j_loss)
    _close(metrics["aux"], j_metrics["aux"])
    _close(metrics["ce"], j_metrics["ce"])
    assert (float(t_aux) > 0) == bool(cfg.num_experts)


def test_bf16_prefill_and_greedy_tokens_match_reference(pairs):
    cfg, jm, m, jp, tp = pairs("llama3-8b-reduced", "bfloat16")
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 40))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, 44)
    with torch.inference_mode():
        tl, _ = m.prefill(tp, {"tokens": torch.as_tensor(toks)}, 44)
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, atol=BF16_ATOL)
    np.testing.assert_array_equal(tl[:, -1].float().argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jl[:, -1].astype(jnp.float32), -1)))


def test_serve_draws_the_vlm_patches_as_the_reference(pairs):
    cfg, jm, m, jp, tp = pairs("paligemma-3b-reduced")
    b = prompt_batch(cfg, 2, 12)
    rng = np.random.default_rng(0)
    want_toks = rng.integers(0, cfg.vocab_size, (2, 12))
    want_patches = np.asarray(jnp.asarray(
        rng.normal(size=(2, cfg.prefix_tokens, cfg.d_model)) * 0.02, jnp.float32))
    np.testing.assert_array_equal(b["tokens"], want_toks)
    np.testing.assert_array_equal(b["patches"], want_patches)
    toks, t = serve(cfg, 2, 12, 4, device="cpu", params=tp)
    assert toks.shape == (2, 4) and t["decode_steps"] == 3
    # the reference's serve loop on the same parameters: greedy tokens equal
    jb = {"tokens": jnp.asarray(want_toks, jnp.int32), "patches": jnp.asarray(want_patches)}
    logits, cache = jm.prefill(jp, jb, 16)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(3):
        logits, cache = jm.decode_step(jp, tok, cache, jnp.asarray(12 + cfg.prefix_tokens + i))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    np.testing.assert_array_equal(toks, np.asarray(jnp.concatenate(out, axis=1)))
