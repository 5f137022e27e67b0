"""The port's samplers and sampling plan against the reference.

Probabilities of ``optimal`` (Eq. 7), ``aocs`` (Alg. 2), ``uniform`` and
``full`` agree to float32 rounding (rtol 1e-6: the two sum and sort in
different orders), including zero norms and saturated clients; the
improvement factors likewise.  Given the same norms and key, the sampling
plan's mask is bitwise the reference's (availability 1 and 0.7), and the
Eq. 4 scale identity ``scale_i = mask_i * w_i / (p_i q)`` holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import improvement as j_improvement
from repro.core import ocs as j_ocs
from repro.core import sampling as j_sampling
from repro_torch import rng
from repro_torch.core import improvement, ocs, sampling


def _norms(case: str, n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    u = r.lognormal(0.0, 1.0, size=n).astype(np.float32)
    if case == "zeros":          # clients with nothing to send
        u[r.choice(n, size=n // 3, replace=False)] = 0.0
    elif case == "saturated":    # a few norms large enough to get p = 1
        u[r.choice(n, size=3, replace=False)] *= 1e3
    elif case == "ties":
        u = np.round(u, 1)
    return u


CASES = ("plain", "zeros", "saturated", "ties")
SIZES = ((8, 3), (32, 3), (33, 6), (96, 32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n,m", SIZES)
@pytest.mark.parametrize("sampler", ("optimal", "aocs", "uniform", "full"))
def test_probabilities_match_reference(sampler, n, m, case):
    u = _norms(case, n, seed=n * 7 + m)
    pj = np.asarray(j_sampling.SAMPLERS[sampler](jnp.asarray(u), m))
    pt = sampling.SAMPLERS[sampler](torch.from_numpy(u), m).numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-7)
    assert pt.sum() <= max(m, 0) * (1 + 1e-5) or sampler == "full"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n,m", SIZES)
def test_improvement_factors_match_reference(n, m, case):
    u = _norms(case, n, seed=n + m)
    aj, gj = j_improvement.improvement_factors(jnp.asarray(u), m)
    at, gt = improvement.improvement_factors(torch.from_numpy(u), m)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(gt), float(gj), rtol=1e-6, atol=1e-7)


def test_not_ported_samplers_raise():
    # the zoo's three samplers, once refused, now resolve to the port's own
    # functions, with the reference's statefulness; an unknown name still
    # raises ValueError
    for name in ("clustered", "cyclic", "threshold"):
        fn = sampling.resolve_sampler(name)
        assert fn is sampling.SAMPLERS[name] and fn.__module__ == sampling.__name__
        assert sampling.is_stateful(fn) == sampling.is_stateful(name) == \
            j_sampling.is_stateful(name)
    assert sorted(sampling.SAMPLERS) == sorted(j_sampling.SAMPLERS)
    with pytest.raises(ValueError, match="unknown sampler"):
        sampling.resolve_sampler("nope")


@pytest.mark.parametrize("availability", (1.0, 0.7))
@pytest.mark.parametrize("sampler", ("optimal", "aocs", "uniform", "full"))
@pytest.mark.parametrize("seed", range(6))
def test_sampling_plan_mask_bitwise(seed, sampler, availability):
    n, m = 32, 3
    u = _norms(CASES[seed % len(CASES)], n, seed)
    w = np.full((n,), 1.0 / n, np.float32)
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 1000 + seed)
    kt = rng.fold_in(rng.PRNGKey(seed), 1000 + seed)
    pj = j_ocs.sampling_plan(jnp.asarray(u), jnp.asarray(w), m, kj, sampler=sampler,
                             availability=availability)
    pt = ocs.sampling_plan(torch.from_numpy(u), torch.from_numpy(w), m, kt,
                           sampler=sampler, availability=availability)
    np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(pj.mask))
    np.testing.assert_array_equal(pt.avail.numpy(), np.asarray(pj.avail))
    np.testing.assert_allclose(pt.probs.numpy(), np.asarray(pj.probs), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pt.scale.numpy(), np.asarray(pj.scale), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pt.norms.numpy(), np.asarray(pj.norms), rtol=0, atol=0)
    # Eq. 4: the estimator coefficient is mask_i * w_i / (p_i q), zero off the mask
    p, mask = pt.probs.numpy(), pt.mask.numpy()
    want = np.where(mask & (p > 1e-12),
                    w / np.maximum(p * np.float32(availability), 1e-12), 0.0)
    np.testing.assert_allclose(pt.scale.numpy(), want.astype(np.float32), rtol=1e-6)
    assert not pt.scale.numpy()[~mask].any()
    if availability == 1.0:
        assert pt.avail.numpy().all()


@pytest.mark.parametrize("backend", ("jnp", "pallas"))
def test_sample_and_aggregate_matches_reference(backend):
    r = np.random.default_rng(11)
    updates = {"w": (r.normal(size=(16, 6, 5)) * 0.1).astype(np.float32),
               "b": (r.normal(size=(16, 5)) * 0.1).astype(np.float32)}
    w = np.full((16,), 1 / 16, np.float32)
    kj = jax.random.PRNGKey(9)
    kt = rng.PRNGKey(9)
    rj = j_ocs.sample_and_aggregate({k: jnp.asarray(v) for k, v in updates.items()},
                                    jnp.asarray(w), 4, kj, backend=backend, interpret=True)
    rt = ocs.sample_and_aggregate({k: torch.from_numpy(v) for k, v in updates.items()},
                                  torch.from_numpy(w), 4, kt, backend=backend)
    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    np.testing.assert_allclose(rt.norms.numpy(), np.asarray(rj.norms), rtol=1e-6)
    np.testing.assert_allclose(rt.probs.numpy(), np.asarray(rj.probs), rtol=1e-6)
    for k in updates:
        np.testing.assert_allclose(rt.aggregate[k].numpy(), np.asarray(rj.aggregate[k]),
                                   rtol=1e-5, atol=1e-6)
