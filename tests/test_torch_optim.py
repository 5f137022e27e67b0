"""The port's optimizers and schedules against the reference's.

``sgd`` (momentum 0 and 0.9) and ``adam`` step a nested parameter tree (a
leaf at the top and a dict of leaves under it, the shape of ``gru_lm``'s
parameters) for 5 steps from identical parameters and gradients: parameters
and optimizer state agree to rtol 1e-6 (atol 1e-7; float32 ``pow`` of the
bias corrections may differ in the last bit between torch and XLA), Adam's
step count ``t`` is an int32 tensor equal to the reference's, and the three
schedules return the same floats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as j_adam
from repro.optim import constant as j_constant
from repro.optim import cosine as j_cosine
from repro.optim import inverse_decay as j_inverse_decay
from repro.optim import sgd as j_sgd
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ops import tree_leaves
from repro_torch.optim import Optimizer, adam, constant, cosine, inverse_decay, sgd

TOL = dict(rtol=1e-6, atol=1e-7)
STEPS = 5


def _tree(gen):
    return {
        "w": gen.normal(size=(6, 4)).astype(np.float32),
        "gru0": {"wx": gen.normal(size=(4, 9)).astype(np.float32),
                 "b": gen.normal(size=(9,)).astype(np.float32)},
    }


def _close(got, want):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("name,make_j,make_t", [
    ("sgd", lambda: j_sgd(0.3), lambda: sgd(0.3)),
    ("sgd-momentum", lambda: j_sgd(0.5, momentum=0.9), lambda: sgd(0.5, momentum=0.9)),
    ("adam", lambda: j_adam(0.01), lambda: adam(0.01)),
    ("adam-betas", lambda: j_adam(0.05, b1=0.8, b2=0.99, eps=1e-6),
     lambda: adam(0.05, b1=0.8, b2=0.99, eps=1e-6)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_optimizer_steps_match_reference(name, make_j, make_t):
    gen = np.random.default_rng(3)
    p0 = _tree(gen)
    grads = [_tree(gen) for _ in range(STEPS)]
    oj, ot = make_j(), make_t()
    assert isinstance(ot, Optimizer)
    pj, sj = jax.tree_util.tree_map(jnp.asarray, p0), None
    pt = params_from_jax(p0)
    sj, st = oj.init(pj), ot.init(pt)
    for g in grads:
        pj, sj = oj.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        pt, st = ot.update(params_from_jax(g), st, pt)
        _close(pt, pj)
    if name.startswith("adam"):
        assert st["t"].dtype == torch.int32 and int(st["t"]) == int(sj["t"]) == STEPS
        _close(st["m"], sj["m"])
        _close(st["v"], sj["v"])
    elif name == "sgd-momentum":
        _close(st, sj)
    else:
        assert st == () and sj == ()
    # the tree keeps its nesting
    assert set(pt) == {"w", "gru0"} and set(pt["gru0"]) == {"wx", "b"}


def test_schedules_equal_reference():
    pairs = [
        (constant(0.1), j_constant(0.1)),
        (inverse_decay(0.5), j_inverse_decay(0.5)),
        (inverse_decay(0.5, decay=0.2), j_inverse_decay(0.5, decay=0.2)),
        (cosine(1.0, 50), j_cosine(1.0, 50)),
        (cosine(1.0, 50, warmup=5, floor=0.1), j_cosine(1.0, 50, warmup=5, floor=0.1)),
    ]
    for t_fn, j_fn in pairs:
        assert [t_fn(k) for k in range(60)] == [j_fn(k) for k in range(60)]
