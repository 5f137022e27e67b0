"""The port's client-state layer (``sim/pool.py``) and its availability trace
in ``core/ocs.py::sampling_plan``: the reference's properties, and parity.

The properties of tests/test_client_state.py, on the port (hypothesis
bounds exact in float32, ``float(np.float32(0.05))``: the reference's
``0.05`` is not a float32 and hypothesis refuses it; at most 25 examples):

* one chain step from stationarity keeps the up-fraction at ``pi``, and the
  degenerate chain ``p_up = q, p_down = 1 - q`` steps to the same state from
  every state, bitwise;
* the step is deterministic in the round key;
* a trace-driven plan keeps the Eq. 7 budget and the Eq. 4 scale identity,
  and is unbiased over the whole system process (Monte Carlo, fixed keys);
* the degenerate trace carries ``include_prob == q``; config validation;
  over-selection.

Parity with the reference on the same keys:

* ``rng.exponential``: the uniform draw is bitwise, ``-log1p(-u)`` within
  rtol 2.4e-7 (two float32 ulps: torch's ``log1p`` and XLA:CPU's differ in
  the last bit);
* ``init_client_state`` and four rounds of ``step_client_state``: ``up``,
  ``on_time`` and ``kept`` bitwise; ``lat_scale`` and ``include_prob``
  within rtol 1e-6 (``exp``/``log1p`` to float32 rounding);
* ``sampling_plan`` with the trace over 5 rounds: masks, ``selected`` and
  ``avail`` bitwise, probabilities and scales within rtol 1e-6;
* ``expected_survivors``, and ``run_simulation``'s refusal of a system with
  a scalar ``availability < 1`` (the reference's ``ValueError``).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, seed, settings, strategies as st

from repro.core import ocs as j_ocs
from repro.sim import driver as j_driver
from repro.sim import pool as j_pool
from repro.sim import scenarios as j_scenarios
from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import ocs
from repro_torch.sim import driver, scenarios
from repro_torch.sim.pool import (
    ClientState,
    SystemConfig,
    expected_survivors,
    init_client_state,
    step_client_state,
)

_EPS = 1e-12
LO, HI = float(np.float32(0.05)), float(np.float32(0.95))
probs_01 = st.floats(min_value=LO, max_value=HI, allow_nan=False, width=32)
norm_vectors = st.lists(
    st.floats(min_value=0.0, max_value=1e4, allow_nan=False, width=32),
    min_size=4, max_size=32,
)
CONFIGS = {
    "straggler": dict(p_up=0.35, p_down=0.15, latency_mu=0.0, latency_sigma=1.0, deadline=2.0,
                      drop_prob=0.1),
    "markov-iid": dict(p_up=0.7, p_down=0.3),
    "deadline": dict(latency_mu=0.0, latency_sigma=0.75, deadline=2.0),
    "dropout": dict(drop_prob=0.15),
    "lognormal-mu": dict(p_up=0.4, p_down=0.3, latency_mu=0.3, latency_sigma=0.6,
                         deadline=1.5, drop_prob=0.2),
}


def _full_trace(cfg, n, key):
    """One driver-shaped state step over the whole pool: init at stationarity
    from ``fold_in(key, 2)``, then a step keyed on ``key`` itself."""
    state = init_client_state(n, cfg, rng.fold_in(key, 2))
    return step_client_state(state, key, torch.arange(n), cfg)


# --- the reference's properties -------------------------------------------

@seed(20260801)
@settings(max_examples=25, deadline=None)
@given(probs_01, probs_01, st.integers(min_value=0, max_value=1 << 20))
def test_chain_preserves_stationary_marginal(p_up, p_down, key_int):
    cfg = SystemConfig(p_up=p_up, p_down=p_down)
    n = 4096
    state, trace = _full_trace(cfg, n, rng.PRNGKey(key_int))
    pi = cfg.stationary()
    tol = 4.0 * np.sqrt(pi * (1 - pi) / n) + 1e-3
    assert abs(float(state.up.float().mean()) - pi) < tol
    assert abs(float(trace.up.float().mean()) - pi) < tol


@seed(20260802)
@settings(max_examples=25, deadline=None)
@given(probs_01, st.integers(min_value=0, max_value=1 << 20))
def test_degenerate_chain_is_bernoulli_q_bitwise(q, key_int):
    cfg = SystemConfig(p_up=q, p_down=1.0 - q)
    n = 512
    key = rng.PRNGKey(key_int)
    lat = torch.ones((n,))
    all_up = ClientState(up=torch.ones((n,), dtype=torch.bool), lat_scale=lat)
    all_down = ClientState(up=torch.zeros((n,), dtype=torch.bool), lat_scale=lat)
    s_up, t_up = step_client_state(all_up, key, torch.arange(n), cfg)
    s_dn, t_dn = step_client_state(all_down, key, torch.arange(n), cfg)
    assert torch.equal(s_up.up, s_dn.up) and torch.equal(t_up.up, t_dn.up)
    assert cfg.stationary() == pytest.approx(q, abs=1e-6)
    np.testing.assert_allclose(t_up.include_prob.numpy(), cfg.stationary(), atol=1e-6)


@seed(20260803)
@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=1 << 20), st.integers(min_value=0, max_value=1 << 20))
def test_state_step_deterministic_in_round_key(ka, kb):
    cfg = SystemConfig(p_up=0.4, p_down=0.3, latency_sigma=0.6, deadline=2.0, drop_prob=0.2)
    n = 64
    state = init_client_state(n, cfg, rng.PRNGKey(0))
    sa, ta = step_client_state(state, rng.PRNGKey(ka), torch.arange(n), cfg)
    sa2, ta2 = step_client_state(state, rng.PRNGKey(ka), torch.arange(n), cfg)
    for x, y in zip((*sa, *ta), (*sa2, *ta2)):
        assert torch.equal(x, y)
    if ka != kb:
        _, tb = step_client_state(state, rng.PRNGKey(kb), torch.arange(n), cfg)
        assert any(not torch.equal(x, y) for x, y in zip(ta, tb))


@seed(20260804)
@settings(max_examples=25, deadline=None)
@given(norm_vectors, st.integers(min_value=0, max_value=1 << 20))
def test_trace_plan_budget_and_scale_identity(u_list, key_int):
    n = len(u_list)
    u = torch.tensor(u_list, dtype=torch.float32)
    w = torch.full((n,), 1.0 / n)
    m = max(1, n // 3)
    cfg = SystemConfig(p_up=0.7, p_down=0.3, latency_sigma=0.5, deadline=2.5, drop_prob=0.15)
    key = rng.PRNGKey(key_int)
    _, trace = _full_trace(cfg, n, key)
    plan = ocs.sampling_plan(u, w, m, key, sampler="optimal", availability=trace)
    p, mask, sel = plan.probs.numpy(), plan.mask.numpy(), plan.selected.numpy()
    up, on_time, kept = trace.up.numpy(), trace.on_time.numpy(), trace.kept.numpy()
    q = trace.include_prob.numpy()
    assert np.all(p >= -1e-6) and np.all(p <= 1 + 1e-6)
    assert np.all(p[~up] == 0.0)
    assert not np.any(sel & ~up)
    assert not np.any(mask & ~(sel & on_time & kept))
    if ((u.numpy() > _EPS) & up).sum() >= m:
        assert float(plan.expected_clients) == pytest.approx(m, rel=2e-3)
    want = np.where(mask & (p > _EPS), w.numpy() / np.maximum(p * q, _EPS), 0.0)
    np.testing.assert_allclose(plan.scale.numpy(), want, rtol=1e-6, atol=1e-7)


def test_trace_plan_monte_carlo_unbiased():
    n, m = 6, 3
    u = torch.tensor([1.0, 2.0, 0.5, 4.0, 1.5, 3.0])
    w = torch.full((n,), 1.0 / n)
    cfg = SystemConfig(p_up=0.75, p_down=0.25, latency_sigma=0.4, deadline=3.0, drop_prob=0.1)

    def draw(key):
        _, trace = _full_trace(cfg, n, key)
        return ocs.sampling_plan(u, w, m, key, sampler="optimal", availability=trace).scale

    with warnings.catch_warnings():
        # torch.take has no batching rule yet and falls back to a loop
        warnings.simplefilter("ignore", UserWarning)
        draws = torch.func.vmap(draw)(rng.split(rng.PRNGKey(0), 6000))
    np.testing.assert_allclose(draws.mean(0).numpy(), w.numpy(), rtol=0.12)


def test_trace_scalar_q_equivalence_is_exact_at_stationarity():
    cfg = SystemConfig(p_up=0.7, p_down=0.3)
    _, trace = _full_trace(cfg, 32, rng.PRNGKey(5))
    np.testing.assert_allclose(trace.include_prob.numpy(), 0.7, atol=1e-6)
    assert bool(trace.on_time.all()) and bool(trace.kept.all())


def test_system_config_validation():
    with pytest.raises(ValueError, match="p_up"):
        SystemConfig(p_up=1.5)
    with pytest.raises(ValueError, match="drop_prob"):
        SystemConfig(drop_prob=1.0)
    with pytest.raises(ValueError, match="deadline"):
        SystemConfig(deadline=0.0)
    with pytest.raises(ValueError, match="latency_sigma"):
        SystemConfig(latency_sigma=-0.1)
    for kw in CONFIGS.values():
        assert dataclasses.asdict(SystemConfig(**kw)) == dataclasses.asdict(
            j_pool.SystemConfig(**kw))
        assert SystemConfig(**kw).stationary() == j_pool.SystemConfig(**kw).stationary()


def test_cohort_target_over_selection():
    fl = FLConfig(n_clients=16, expected_clients=4)
    assert fl.cohort_target() == 4
    assert FLConfig(n_clients=16, expected_clients=4, over_select=1.5).cohort_target() == 6
    assert FLConfig(n_clients=16, expected_clients=12, over_select=2.0).cohort_target() == 16
    with pytest.raises(ValueError, match="over_select"):
        FLConfig(n_clients=16, expected_clients=4, over_select=0.5)


# --- parity with the reference ----------------------------------------------

@pytest.mark.parametrize("key_int", (0, 7, 123456))
def test_exponential_matches_reference(key_int):
    want = np.asarray(jax.random.exponential(jax.random.PRNGKey(key_int), (20000,)))
    got = rng.exponential(rng.PRNGKey(key_int), (20000,)).numpy()
    assert got.dtype == np.float32 and np.all(got >= 0)
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(key_int), (20000,)))
    np.testing.assert_array_equal(rng.uniform(rng.PRNGKey(key_int), (20000,)).numpy(), u)


@pytest.mark.parametrize("seed_", (0, 3))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_client_state_matches_reference(name, seed_):
    kw, n = CONFIGS[name], 300
    jc, tc = j_pool.SystemConfig(**kw), SystemConfig(**kw)
    js = j_pool.init_client_state(n, jc, jax.random.PRNGKey(seed_))
    ts = init_client_state(n, tc, rng.PRNGKey(seed_))
    np.testing.assert_array_equal(ts.up.numpy(), np.asarray(js.up))
    np.testing.assert_allclose(ts.lat_scale.numpy(), np.asarray(js.lat_scale), rtol=1e-6)
    clients = np.random.default_rng(seed_).choice(n, size=32, replace=False)
    for k in range(4):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed_), 1000 + k)
        js, jt = j_pool.step_client_state(js, jk, jnp.asarray(clients), jc)
        ts, tt = step_client_state(ts, rng.fold_in(rng.PRNGKey(seed_), 1000 + k),
                                   torch.from_numpy(clients), tc)
        np.testing.assert_array_equal(ts.up.numpy(), np.asarray(js.up))
        for field in ("up", "on_time", "kept"):
            np.testing.assert_array_equal(getattr(tt, field).numpy(),
                                          np.asarray(getattr(jt, field)), err_msg=field)
        assert tt.include_prob.dtype == torch.float32
        np.testing.assert_allclose(tt.include_prob.numpy(), np.asarray(jt.include_prob),
                                   rtol=1e-6)


@pytest.mark.parametrize("sampler", ("aocs", "optimal", "uniform"))
@pytest.mark.parametrize("name", ("straggler", "markov-iid", "lognormal-mu"))
def test_trace_plan_matches_reference_over_rounds(name, sampler):
    n, m, kw = 32, 6, CONFIGS[name]
    jc, tc = j_pool.SystemConfig(**kw), SystemConfig(**kw)
    js = j_pool.init_client_state(n, jc, jax.random.PRNGKey(2))
    ts = init_client_state(n, tc, rng.PRNGKey(2))
    r = np.random.default_rng(1)
    w = np.full((n,), 1.0 / n, np.float32)
    for k in range(5):
        u = r.lognormal(size=n).astype(np.float32)
        jk = jax.random.fold_in(jax.random.PRNGKey(2), 1000 + k)
        tk = rng.fold_in(rng.PRNGKey(2), 1000 + k)
        js, jt = j_pool.step_client_state(js, jk, jnp.arange(n), jc)
        ts, tt = step_client_state(ts, tk, torch.arange(n), tc)
        pj = j_ocs.sampling_plan(jnp.asarray(u), jnp.asarray(w), m, jk, sampler=sampler,
                                 availability=jt)
        pt = ocs.sampling_plan(torch.from_numpy(u), torch.from_numpy(w), m, tk,
                               sampler=sampler, availability=tt)
        for field in ("mask", "selected", "avail"):
            np.testing.assert_array_equal(getattr(pt, field).numpy(),
                                          np.asarray(getattr(pj, field)), err_msg=field)
        np.testing.assert_array_equal(pt.norms.numpy(), np.asarray(pj.norms))
        np.testing.assert_allclose(pt.probs.numpy(), np.asarray(pj.probs), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(pt.scale.numpy(), np.asarray(pj.scale), rtol=1e-6,
                                   atol=1e-7)
        assert pt.sampler_state is None


def test_expected_survivors_matches_reference():
    for kw in CONFIGS.values():
        for m, over in ((3, 1.0), (3, 2.0), (5, 1.5)):
            assert expected_survivors(SystemConfig(**kw), m, over) == \
                j_pool.expected_survivors(j_pool.SystemConfig(**kw), m, over)


def test_system_with_scalar_availability_raises_as_the_reference_does():
    name = "femnist1-fedavg-aocs-q0.7"
    system = scenarios.get_scenario("femnist1-fedavg-aocs-markov").system
    with pytest.raises(ValueError) as j_err:
        j_driver.run_scenario(j_scenarios.get_scenario(name).with_(
            system=j_scenarios.get_scenario("femnist1-fedavg-aocs-markov").system),
            reduced=True, rounds=1, mode="host")
    for mode in ("host", "prefetch", "scan"):
        with pytest.raises(ValueError) as t_err:
            driver.run_scenario(scenarios.get_scenario(name).with_(system=system),
                                reduced=True, rounds=1, mode=mode, device="cpu")
        assert str(t_err.value) == str(j_err.value)
