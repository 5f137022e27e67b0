"""The port's shared layers (``models/layers.py``) against the reference's,
on converted reference parameters, for the configurations the reduced
architectures give them — also those whose families the port does not build
yet, since the layers are shared: rmsnorm (with and without gemma's offset)
and layernorm; swiglu, geglu and gelu MLPs; attention with GQA, a sliding
window, a bidirectional prefix, RoPE, the chunked path at S >= 2,048, cached
decode (linear and ring buffer) and ``kv_override``.  f32 throughout, atol
1e-5: the two frameworks sum in other orders.  At S = 2,100, atol 5e-4 for
the attention and its keys: RoPE's angle ``position * freq`` multiplies a
one-ulp difference between the frameworks' ``exp`` in a frequency (6e-8
relative) by positions up to 2,100, about 1.3e-4 rad (measured 1.3e-4 at
``rope_theta`` 5e5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.models import layers as jl
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tl


def _x(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(np.float32)


def _both(arch, **kw):
    return j_get(arch).with_(**kw), get(arch).with_(**kw)


@pytest.mark.parametrize("arch", ("llama3-8b-reduced", "gemma-7b-reduced",
                                  "whisper-small-reduced"))
def test_norm_and_mlp_match_reference(arch):
    j_cfg, cfg = _both(arch)
    x = _x((2, 7, cfg.d_model), 1)
    jn = jl.init_norm(j_cfg, cfg.d_model)
    jn = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.arange(a.shape[0]) / a.shape[0], jn)
    got = tl.apply_norm(params_from_jax(jax.device_get(jn)), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.apply_norm(jn, jnp.asarray(x), j_cfg)),
                               atol=1e-5)
    jm = jl.init_mlp(jax.random.PRNGKey(2), j_cfg)
    got = tl.apply_mlp(params_from_jax(jax.device_get(jm)), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.apply_mlp(jm, jnp.asarray(x), j_cfg)),
                               atol=1e-5)


def test_positions_match_reference():
    x = _x((2, 9, 3, 32), 3)
    pos = np.broadcast_to(np.arange(9), (2, 9)).copy()
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tl.sinusoidal_positions(50, 64).numpy(),
                               np.asarray(jl.sinusoidal_positions(50, 64)), atol=1e-5)
    for window, prefix in ((None, 0), (5, 0), (None, 7), (3, 9)):
        assert np.array_equal(tl.causal_mask(20, window, prefix).numpy(),
                              np.asarray(jl.causal_mask(20, window, prefix)))
    for window in (None, 16):
        for pos in (0, 5, 40):
            assert np.array_equal(tl.decode_mask(16, pos, window).numpy(),
                                  np.asarray(jl.decode_mask(16, pos, window)))


CASES = (   # (arch, config overrides, S, prefix)
    ("llama3-8b-reduced", {"num_kv_heads": 2}, 40, 0),         # GQA
    ("mixtral-8x7b-reduced", {}, 100, 0),                      # sliding window 64
    ("paligemma-3b-reduced", {}, 40, 16),                      # prefix-LM
    ("llama3-8b-reduced", {"num_kv_heads": 2}, 2100, 0),       # the chunked path
    ("mixtral-8x7b-reduced", {}, 2100, 0),
    ("paligemma-3b-reduced", {}, 2100, 16),
)


@pytest.mark.parametrize("arch,kw,s,prefix", CASES)
def test_attention_prefill_and_decode_match_reference(arch, kw, s, prefix):
    j_cfg, cfg = _both(arch, **kw)
    jp = jl.init_attention(jax.random.PRNGKey(s), j_cfg)
    tp = params_from_jax(jax.device_get(jp))
    x = _x((2, s, cfg.d_model), s)
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    window = cfg.sliding_window
    if s >= 2048:
        ctx = {"mask": None, "chunked_info": (window, prefix)}
    else:
        ctx = {"mask": jl.causal_mask(s, window, prefix), "chunked_info": None}
    want, (jk, jv) = jl.apply_attention(jp, jnp.asarray(x), j_cfg, positions=jnp.asarray(pos),
                                        cache=(), **ctx)
    tctx = dict(ctx, mask=None if ctx["mask"] is None else tl.causal_mask(s, window, prefix))
    got, (tk, tv) = tl.apply_attention(tp, torch.from_numpy(x), cfg,
                                       positions=torch.from_numpy(pos), cache=(), **tctx)
    atol = 5e-4 if s >= 2048 else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=atol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)

    # one decode step into a cache of the model's buffer length (a ring buffer
    # under the sliding window), the step's keys written at its slot
    t = min(window, s + 3) if window else s + 3
    buf = _x((2, t, cfg.num_kv_heads, cfg.resolved_head_dim), s + 1)
    xt = _x((2, 1, cfg.d_model), s + 2)
    dpos = s + 1
    mask = jl.decode_mask(t, dpos, window)
    want, (wk, wv) = jl.apply_attention(
        jp, jnp.asarray(xt), j_cfg, positions=jnp.full((2, 1), dpos, jnp.int32), mask=mask,
        cache=(jnp.asarray(buf), jnp.asarray(buf * 2)), cache_index=jnp.asarray(dpos))
    kb, vb = torch.from_numpy(buf.copy()), torch.from_numpy(buf * 2)
    got, (gk, gv) = tl.apply_attention(
        tp, torch.from_numpy(xt), cfg, positions=torch.full((2, 1), dpos), cache=(kb, vb),
        mask=tl.decode_mask(t, dpos, window), cache_index=dpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    assert gk is kb and gv is vb                     # written in place
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=atol)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)


def test_kv_override_matches_reference():
    j_cfg, cfg = _both("whisper-small-reduced")
    jp = jl.init_attention(jax.random.PRNGKey(5), j_cfg)
    tp = params_from_jax(jax.device_get(jp))
    x = _x((2, 6, cfg.d_model), 6)
    kv = [_x((2, 11, cfg.num_kv_heads, cfg.resolved_head_dim), i) for i in (7, 8)]
    mask = np.ones((1, 1, 6, 11), bool)
    want, none = jl.apply_attention(jp, jnp.asarray(x), j_cfg, mask=jnp.asarray(mask),
                                    kv_override=tuple(map(jnp.asarray, kv)), use_rope=False)
    got, nothing = tl.apply_attention(tp, torch.from_numpy(x), cfg,
                                      mask=torch.from_numpy(mask),
                                      kv_override=tuple(map(torch.from_numpy, kv)),
                                      use_rope=False)
    assert none is None and nothing is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
