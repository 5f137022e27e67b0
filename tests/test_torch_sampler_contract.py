"""The sampler-contract suite on the port's zoo, and the zoo's parity.

The properties of tests/test_sampler_contract.py, over every entry of the
port's ``SAMPLERS`` (hypothesis with at most 25 examples):

* **budget** — ``sum(p)`` equals the declared budget (``m``; ``n`` for
  ``full``) on norms with at least ``m`` non-zero entries; ``threshold``'s
  budget is adaptive (``n`` at the cold start, then exactly ``m``);
  ``clustered`` keeps ``m`` with few non-zero norms;
* zero norms get probability 0 from the norm-driven samplers;
* **Eq. 4** — ``scale_i = mask_i * w_i / p_i`` through ``sampling_plan``;
* **Monte-Carlo unbiasedness** (``cyclic`` exempt), **permutation
  equivariance** (``cyclic`` exempt), the cyclic schedule, **stateful
  determinism**, stateless samplers leaving ``sampler_state`` ``None``,
  unknown names raising ``ValueError`` at ``sampling_plan``,
  ``RoundEngine`` and ``validate_shard_config``, callables passing through.

Parity with the reference:

* ``clustered``, ``cyclic`` and ``threshold`` probabilities agree to float32
  rounding (rtol 1e-6) on plain norms, zero norms, saturated norms and
  ties, and the stateful samplers' states over 6 rounds (``step`` bitwise,
  ``threshold`` within rtol 1e-6);
* ``clustered`` breaks ties as ``jnp.argsort`` does (stable): on norms with
  many equal non-zero values the clusters, hence ``p``, are the
  reference's;
* ``sampling_plan`` with each stateful sampler, alone and under a
  client-state trace, over 5 rounds: masks and ``SamplerState`` bitwise
  (threshold values within rtol 1e-6 by the float32 EMA; equal here).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, seed, settings, strategies as st

from repro.core import ocs as j_ocs
from repro.core import sampling as j_sampling
from repro.sim import pool as j_pool
from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import ocs, sampling
from repro_torch.core.sampling import (
    SAMPLERS,
    STATEFUL_SAMPLERS,
    SamplerState,
    init_sampler_state,
)
from repro_torch.sim import pool

_EPS = 1e-12
BUDGET = {
    "optimal": "m", "aocs": "m", "uniform": "m", "full": "n",
    "clustered": "m", "cyclic": "m", "threshold": "adaptive",
}
UNBIASED = ("optimal", "aocs", "uniform", "full", "clustered", "threshold")
PERM_EQUIVARIANT = ("optimal", "aocs", "uniform", "full", "clustered", "threshold")
ZOO = ("clustered", "cyclic", "threshold")


def test_trait_tables_cover_zoo():
    assert set(BUDGET) == set(SAMPLERS) == set(j_sampling.SAMPLERS)
    fresh, j_fresh = init_sampler_state(), j_sampling.init_sampler_state()
    assert (int(fresh.step), float(fresh.threshold)) == (int(j_fresh.step),
                                                         float(j_fresh.threshold))
    assert set(UNBIASED) <= set(SAMPLERS)
    assert set(PERM_EQUIVARIANT) <= set(SAMPLERS)
    assert STATEFUL_SAMPLERS == j_sampling.STATEFUL_SAMPLERS
    assert sampling.THRESHOLD_BETA == j_sampling.THRESHOLD_BETA


def _probs(name, u, m, state=None):
    fn = SAMPLERS[name]
    if name == "aocs":
        return fn(u, m, 4), None
    if sampling.is_stateful(name):
        return fn(u, m, init_sampler_state() if state is None else state)
    return fn(u, m), None


def _norms(n=12, seed_=3):
    r = np.random.default_rng(seed_)
    return torch.from_numpy(np.sort(r.uniform(0.5, 5.0, n))[::-1].astype(np.float32))


@pytest.mark.parametrize("name", sorted(k for k in SAMPLERS if BUDGET[k] in ("m", "n")))
def test_budget_sums_to_declared_target(name):
    n, m = 12, 4
    p, _ = _probs(name, _norms(n), m)
    target = float(m if BUDGET[name] == "m" else n)
    assert np.isclose(float(p.sum()), target, atol=1e-4), (name, p)
    assert float(p.min()) >= 0.0 and float(p.max()) <= 1.0


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_zero_norm_clients_never_send_or_are_scheduled(name):
    n, m = 10, 3
    u = _norms(n)
    u[[1, 5]] = 0.0
    p, _ = _probs(name, u, m)
    if name not in ("uniform", "full", "cyclic"):
        assert float(p[1]) == 0.0 and float(p[5]) == 0.0, name


def test_threshold_budget_is_adaptive():
    n, m = 12, 4
    u = _norms(n)
    p, state = _probs("threshold", u, m, init_sampler_state())
    assert float(p.sum()) == float(n)
    for _ in range(40):
        p, state = _probs("threshold", u, m, state)
    assert float(p.sum()) == float(m)
    s = np.sort(u.numpy())
    assert s[n - m - 1] < float(state.threshold) <= s[n - m]


def test_clustered_budget_exact_with_few_nonzero():
    n, m = 12, 4
    u = torch.zeros(n)
    u[[0, 3, 7, 9]] = torch.tensor([4.0, 3.0, 2.0, 1.0])
    p, _ = _probs("clustered", u, m)
    assert np.isclose(float(p.sum()), m, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_eq4_scale_identity(name):
    n, m = 12, 4
    u = _norms(n)
    w = torch.full((n,), 1.0 / n)
    plan = ocs.sampling_plan(u, w, m, rng.PRNGKey(5), sampler=name)
    p = plan.probs.double().numpy()
    mask = plan.mask.numpy()
    want = np.where(mask & (p > _EPS), w.double().numpy() / np.maximum(p, _EPS), 0.0)
    np.testing.assert_allclose(plan.scale.double().numpy(), want, rtol=1e-6, err_msg=name)
    assert not np.any(mask & (p <= _EPS)), name


@pytest.mark.parametrize("name", sorted(UNBIASED))
def test_mc_unbiasedness(name):
    n, m, draws = 12, 4, 400
    u = _norms(n)
    v = torch.from_numpy(np.random.default_rng(11).normal(size=n).astype(np.float32))
    w = torch.full((n,), 1.0 / n)
    truth = float((w * v).sum())
    keys = rng.split(rng.PRNGKey(42), draws)
    with warnings.catch_warnings():
        # torch.take has no batching rule yet and falls back to a loop
        warnings.simplefilter("ignore", UserWarning)
        ests = torch.func.vmap(
            lambda key: (ocs.sampling_plan(u, w, m, key, sampler=name).scale * v).sum()
        )(keys).double().numpy()
    se = ests.std() / np.sqrt(draws)
    assert abs(ests.mean() - truth) <= max(5 * se, 5e-4), (name, ests.mean(), truth, se)


@pytest.mark.parametrize("name", sorted(PERM_EQUIVARIANT))
def test_permutation_equivariance(name):
    n, m = 12, 4
    u = _norms(n)
    state = None
    if sampling.is_stateful(name):
        state = SamplerState(step=torch.tensor(3, dtype=torch.int32),
                             threshold=torch.tensor(float(np.median(u.numpy()))))
    perm = torch.from_numpy(np.random.default_rng(9).permutation(n))
    p, _ = _probs(name, u, m, state)
    p_perm, _ = _probs(name, u[perm], m, state)
    np.testing.assert_allclose(p_perm.numpy(), p.numpy()[perm.numpy()], atol=1e-6, err_msg=name)


def test_cyclic_every_client_once_per_cycle():
    n, m = 12, 4
    state = init_sampler_state()
    seen = np.zeros(n, int)
    for k in range(n // m):
        p, state = _probs("cyclic", _norms(n, seed_=k), m, state)
        p = p.numpy()
        assert set(np.unique(p)) <= {0.0, 1.0} and p.sum() == m
        seen += p.astype(int)
    np.testing.assert_array_equal(seen, np.ones(n, int))
    p, _ = _probs("cyclic", _norms(n), m, state)
    np.testing.assert_array_equal(np.flatnonzero(p.numpy()), np.arange(m))


@pytest.mark.parametrize("name", sorted(STATEFUL_SAMPLERS))
def test_stateful_trajectory_deterministic(name):
    n, m, rounds = 10, 3, 6
    w = torch.full((n,), 1.0 / n)

    def run():
        state, traj, masks = init_sampler_state(), [], []
        for k in range(rounds):
            plan = ocs.sampling_plan(_norms(n, seed_=100 + k), w, m, rng.PRNGKey(1000 + k),
                                     sampler=name, sampler_state=state)
            state = plan.sampler_state
            traj.append(tuple(x.numpy().tobytes() for x in state))
            masks.append(plan.mask.numpy().tobytes())
        return traj, masks

    t1, m1 = run()
    t2, m2 = run()
    assert t1 == t2 and m1 == m2 and t1[0] != t1[-1]


def test_stateless_samplers_leave_state_none():
    u, w = _norms(8), torch.full((8,), 0.125)
    for name in sorted(set(SAMPLERS) - set(STATEFUL_SAMPLERS)):
        assert ocs.sampling_plan(u, w, 3, rng.PRNGKey(0), sampler=name).sampler_state is None


def test_unknown_sampler_raises_listing_registry():
    from repro_torch.fl.engine import RoundEngine
    from repro_torch.fl.shard_round import validate_shard_config

    u, w = _norms(8), torch.full((8,), 0.125)
    with pytest.raises(ValueError, match="unknown sampler") as err:
        ocs.sampling_plan(u, w, 3, rng.PRNGKey(0), sampler="bogus")
    for known in SAMPLERS:
        assert known in str(err.value)
    fl = FLConfig(n_clients=8, expected_clients=3, sampler="bogus")
    with pytest.raises(ValueError, match="unknown sampler"):
        RoundEngine(lambda p, b: torch.zeros(()), fl, device="cpu")
    with pytest.raises(ValueError, match="unknown sampler"):
        validate_shard_config(fl, 1)


def test_callable_sampler_passes_through():
    def custom(u, m):
        return torch.full_like(u, 0.5)

    assert sampling.resolve_sampler(custom) is custom and not sampling.is_stateful(custom)
    assert sampling.is_stateful(sampling.cyclic_probabilities)
    u, w = _norms(8), torch.full((8,), 0.125)
    plan = ocs.sampling_plan(u, w, 4, rng.PRNGKey(0), sampler=custom)
    np.testing.assert_allclose(plan.probs.numpy(), 0.5)


prop_norms = st.lists(st.floats(min_value=0.0, max_value=1e4, allow_nan=False, width=32),
                      min_size=2, max_size=48)


@seed(20260808)
@settings(max_examples=25, deadline=None)
@given(prop_norms)
def test_property_probabilities_in_unit_interval(u_list):
    u = torch.tensor(u_list, dtype=torch.float32)
    m = max(1, len(u_list) // 3)
    for name in sorted(SAMPLERS):
        p, _ = _probs(name, u, m)
        p = p.double().numpy()
        assert np.all(p >= 0.0) and np.all(p <= 1.0 + 1e-6), (name, p)


@seed(20260809)
@settings(max_examples=25, deadline=None)
@given(prop_norms)
def test_property_clustered_budget(u_list):
    u = torch.tensor(u_list, dtype=torch.float32)
    m = max(1, len(u_list) // 3)
    total = float(_probs("clustered", u, m)[0].sum())
    if int((u > _EPS).sum()) >= m:
        assert np.isclose(total, m, atol=1e-3), (u_list, total)
    else:
        assert total <= m + 1e-3


# --- parity with the reference ----------------------------------------------

def _case_norms(case, n, seed_):
    r = np.random.default_rng(seed_)
    u = r.lognormal(0.0, 1.0, size=n).astype(np.float32)
    if case == "zeros":
        u[r.choice(n, size=n // 3, replace=False)] = 0.0
    elif case == "saturated":
        u[r.choice(n, size=3, replace=False)] *= 1e3
    elif case == "ties":
        u = np.round(u, 0).astype(np.float32)       # many equal non-zero norms
    return u


@pytest.mark.parametrize("case", ("plain", "zeros", "saturated", "ties"))
@pytest.mark.parametrize("n,m", ((8, 3), (32, 3), (33, 6), (96, 32)))
@pytest.mark.parametrize("name", ZOO)
def test_zoo_probabilities_match_reference(name, n, m, case):
    t_state, j_state = init_sampler_state(), j_sampling.init_sampler_state()
    for k in range(6):
        u = _case_norms(case, n, seed_=n * 7 + m + k)
        if sampling.is_stateful(name):
            pt, t_state = SAMPLERS[name](torch.from_numpy(u), m, t_state)
            pj, j_state = j_sampling.SAMPLERS[name](jnp.asarray(u), m, j_state)
            assert int(t_state.step) == int(j_state.step) == k + 1
            assert t_state.step.dtype == torch.int32 and t_state.threshold.dtype == torch.float32
            np.testing.assert_allclose(float(t_state.threshold), float(j_state.threshold),
                                       rtol=1e-6)
        else:
            pt = SAMPLERS[name](torch.from_numpy(u), m)
            pj = j_sampling.SAMPLERS[name](jnp.asarray(u), m)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)


def test_clustered_ties_break_as_the_reference_does():
    # a Markov round: the down clients' norms are 0 and the rest take few
    # distinct values, so the descending sort has long runs of ties; a
    # non-stable sort would put other clients in each cluster
    n, m = 32, 5
    r = np.random.default_rng(4)
    u = r.choice(np.float32([0.5, 1.0, 2.0]), size=n)
    u[r.uniform(size=n) < 0.3] = 0.0
    u = torch.from_numpy(u)
    order = torch.argsort(-u, stable=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jnp.argsort(-jnp.asarray(u))))
    pt = sampling.clustered_probabilities(u, m)
    pj = j_sampling.clustered_probabilities(jnp.asarray(u), m)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)
    assert len(set(pt.numpy()[u.numpy() == 1.0].tolist())) > 1    # the ties matter


@pytest.mark.parametrize("system", (None, "straggler"))
@pytest.mark.parametrize("name", ("clustered", "cyclic", "threshold"))
def test_stateful_plans_match_reference_over_rounds(name, system):
    n, m = 32, 6
    w = np.full((n,), 1.0 / n, np.float32)
    kw = dict(p_up=0.35, p_down=0.15, latency_sigma=1.0, deadline=2.0, drop_prob=0.1)
    if system is not None:
        jc, tc = j_pool.SystemConfig(**kw), pool.SystemConfig(**kw)
        js = j_pool.init_client_state(n, jc, jax.random.PRNGKey(9))
        ts = pool.init_client_state(n, tc, rng.PRNGKey(9))
    t_state = j_state = None
    r = np.random.default_rng(8)
    for k in range(5):
        u = r.lognormal(size=n).astype(np.float32)
        jk = jax.random.fold_in(jax.random.PRNGKey(9), 1000 + k)
        tk = rng.fold_in(rng.PRNGKey(9), 1000 + k)
        jt = tt = 1.0
        if system is not None:
            js, jt = j_pool.step_client_state(js, jk, jnp.arange(n), jc)
            ts, tt = pool.step_client_state(ts, tk, torch.arange(n), tc)
        pj = j_ocs.sampling_plan(jnp.asarray(u), jnp.asarray(w), m, jk, sampler=name,
                                 availability=jt, sampler_state=j_state)
        pt = ocs.sampling_plan(torch.from_numpy(u), torch.from_numpy(w), m, tk, sampler=name,
                               availability=tt, sampler_state=t_state)
        for field in ("mask", "selected"):
            np.testing.assert_array_equal(getattr(pt, field).numpy(),
                                          np.asarray(getattr(pj, field)), err_msg=field)
        np.testing.assert_allclose(pt.probs.numpy(), np.asarray(pj.probs), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(pt.scale.numpy(), np.asarray(pj.scale), rtol=1e-6,
                                   atol=1e-7)
        t_state, j_state = pt.sampler_state, pj.sampler_state
        if name in STATEFUL_SAMPLERS:
            assert int(t_state.step) == int(j_state.step) == k + 1
            np.testing.assert_array_equal(t_state.threshold.numpy(),
                                          np.asarray(j_state.threshold))
        else:
            assert t_state is None and j_state is None
