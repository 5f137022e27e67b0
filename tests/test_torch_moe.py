"""The port's ``models/moe.py`` against the reference's, on the same
numpy-seeded router logits and tokens:

* ``_capacity`` equal over group sizes, expert counts and capacity factors;
* ``route``: the dispatch one-hot bitwise, the combine weights within 1e-6
  and the aux loss within 1e-6 (relative; the two frameworks sum the token
  means in other orders), at top-1 and top-2, dropless and at capacity
  factor 1.25, where tokens are dropped (some token has fewer than k slots);
* ``apply_moe``: the output within atol 1e-5 and the aux within 1e-6 in f32,
  with a padded last group (T not a multiple of ``moe_group_size``);
* ``route`` under ``torch.func.vmap`` (the engine's local update maps it
  over the clients) equals it client by client.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.models import moe as jmoe
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.models import moe

CASES = (   # (arch, experts, top-k, capacity factor)
    ("mixtral-8x7b-reduced", 4, 2, 4.0),
    ("mixtral-8x7b-reduced", 8, 2, 1.25),
    ("llama4-maverick-400b-a17b-reduced", 4, 1, 4.0),
    ("llama4-maverick-400b-a17b-reduced", 8, 1, 1.25),
)


def _cfgs(arch, e, k, cf, group=64):
    kw = dict(num_experts=e, num_experts_per_token=k, moe_capacity_factor=cf,
              moe_group_size=group)
    return j_get(arch).with_(**kw), get(arch).with_(**kw)


def test_capacity_matches_reference():
    for tg in (1, 3, 64, 1024):
        for e, k, cf in ((8, 2, 1.25), (4, 2, 4.0), (128, 1, 1.25), (8, 1, 1.0)):
            j_cfg, cfg = _cfgs("mixtral-8x7b-reduced", e, k, cf)
            assert moe._capacity(cfg, tg) == jmoe._capacity(j_cfg, tg)


@pytest.mark.parametrize("arch,e,k,cf", CASES)
def test_route_matches_reference(arch, e, k, cf):
    j_cfg, cfg = _cfgs(arch, e, k, cf)
    logits = np.random.default_rng(e * 10 + k).normal(size=(3, 64, e)).astype(np.float32)
    jd, jc, ja = jmoe.route(jnp.asarray(logits), j_cfg)
    td, tc, ta = moe.route(torch.as_tensor(logits), cfg)
    assert td.dtype == torch.bool and tuple(td.shape) == jd.shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    routed = td.numpy().sum(axis=(2, 3))                     # slots per token
    assert routed.max() == k
    if cf < e:                                               # capacity binds
        assert routed.min() < k


@pytest.mark.parametrize("arch,e,k,cf", CASES)
def test_apply_moe_matches_reference(arch, e, k, cf):
    j_cfg, cfg = _cfgs(arch, e, k, cf, group=32)
    jp = jmoe.init_moe(jax.random.PRNGKey(e + k), j_cfg)
    tp = params_from_jax(jax.device_get(jp))
    x = np.random.default_rng(3).normal(size=(2, 45, cfg.d_model)).astype(np.float32)
    jy, ja = jmoe.apply_moe(jp, jnp.asarray(x), j_cfg)      # 90 tokens: groups of 32, padded
    ty, ta = moe.apply_moe(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_route_under_vmap_equals_per_client():
    _, cfg = _cfgs("mixtral-8x7b-reduced", 8, 2, 1.25)
    logits = torch.as_tensor(np.random.default_rng(1).normal(size=(4, 2, 64, 8)),
                             dtype=torch.float32)
    vd, vc, va = torch.func.vmap(lambda lg: moe.route(lg, cfg))(logits)
    for i in range(4):
        d, c, a = moe.route(logits[i], cfg)
        assert torch.equal(vd[i], d) and torch.equal(vc[i], c)
        assert torch.allclose(va[i], a, rtol=1e-6)
