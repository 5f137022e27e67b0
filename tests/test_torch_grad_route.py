"""The models' kernel routes under autograd, and ``Model.loss``'s gradient.

The hand-written attention and SSD kernels have no backward (as in the
reference, whose models never differentiate a Pallas kernel), so
``chunked_attention`` and ``ssd_chunked`` run their eager forms whenever
autograd would record the call (``layers.autograd_records``):

* the predicate is true with grad mode on and an input that requires grad,
  and under ``torch.func.grad`` and ``torch.func.vmap`` (wrapper tensors);
  false for plain tensors, under ``torch.no_grad`` and under
  ``torch.inference_mode`` (serving), which keep the kernels;
* the gradient of ``Model.loss`` of ``mamba2-130m-reduced`` (prompt 256:
  batched SSD chunks; by ``torch.func.grad``, as the engine's local update
  takes it) and ``zamba2-2.7b-reduced`` (prompt 2,100 >= ``CHUNK_THRESHOLD``:
  the chunked attention, the fused SSD pass and its padding; by
  ``loss.backward()``), from the reference's converted parameters, equals
  the reference's ``jax.grad`` within atol 1e-4 times the gradient's
  largest entry (the forward tolerance of tests/test_torch_models.py,
  relative).  Both routes differentiate the same eager ops, so each case
  takes one: the zamba2 gradient is this file's cost.

Where a segment sum of the SSD core passes float32's ``exp`` range, the
reference's gradient is nan and the port's finite (the port masks before
``exp``; the forward values are the same).

On the card the same gradient against the CPU's is
``tests/test_torch_cuda.py::test_model_loss_gradient_on_the_card_equals_the_cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.models import build_model as j_build
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ops import tree_leaves, tree_map
from repro_torch.models import build_model
from repro_torch.models.layers import autograd_records

GRAD_ATOL = 1e-4          # relative to the gradient's largest entry
GRAD_CASES = (("mamba2-130m-reduced", 2, 256, "torch.func.grad"),
              ("zamba2-2.7b-reduced", 1, 2100, "loss.backward()"))


def _x(requires_grad=False):
    return torch.ones((2, 3), requires_grad=requires_grad)


def _inside(transform):
    seen = []

    def fn(t):
        seen.append(autograd_records(t))
        return t.sum()

    transform(fn)(torch.ones((2, 3)))
    return seen[0]


@pytest.mark.parametrize("case,want", (
    ("plain", False),
    ("requires_grad", True),
    ("requires_grad under no_grad", False),
    ("requires_grad under inference_mode", False),
    ("torch.func.grad", True),
    ("torch.func.vmap", True),
))
def test_autograd_records_predicate(case, want):
    if case == "plain":
        got = autograd_records(_x(), _x())
    elif case == "requires_grad":
        got = autograd_records(_x(), _x(True))
    elif case == "requires_grad under no_grad":
        with torch.no_grad():
            got = autograd_records(_x(True))
    elif case == "requires_grad under inference_mode":
        t = _x(True)
        with torch.inference_mode():
            got = autograd_records(t)
    elif case == "torch.func.grad":
        got = _inside(torch.func.grad)
    else:
        got = _inside(lambda fn: torch.func.vmap(fn))
    assert got is want


def _reference_grad(arch, bsz, seq):
    jm, m = j_build(j_get(arch), remat=False), build_model(get(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(seq).integers(0, get(arch).vocab_size, (bsz, seq + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jg = jax.grad(lambda p: jm.loss(p, {k: jnp.asarray(v, jnp.int32)
                                        for k, v in batch.items()})[0])(jp)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jax.device_get(jg))]
    params = params_from_jax(jax.device_get(jp))
    return m, params, {k: torch.as_tensor(v) for k, v in batch.items()}, want


@pytest.mark.parametrize("arch,bsz,seq,route", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_loss_gradient_matches_reference_grad(arch, bsz, seq, route):
    m, params, batch, want = _reference_grad(arch, bsz, seq)
    if route == "loss.backward()":
        leaves = tree_map(lambda t: t.clone().requires_grad_(), params)
        m.loss(leaves, batch)[0].backward()
        got = [t.grad for t in tree_leaves(leaves)]
    else:
        got = tree_leaves(torch.func.grad(lambda p: m.loss(p, batch)[0])(params))
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    assert scale > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_ATOL * scale)


def test_ssd_gradient_stays_finite_where_the_references_overflows():
    """A divergence kept on purpose: the eager SSD core masks the segment
    sums before ``exp``.  With a large step (``dt_bias`` 3, so |dt * A| ~ 50
    a step) a segment sum above the diagonal passes float32's ``exp`` range:
    the reference's gradient is then ``0 * inf = nan`` on every leaf, the
    port's finite, and the two losses equal within the forward tolerance."""
    arch = "mamba2-130m-reduced"
    jm, m = j_build(j_get(arch), remat=False), build_model(get(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    jp["layers"]["mamba"]["dt_bias"] = jnp.full_like(jp["layers"]["mamba"]["dt_bias"], 3.0)
    tp = params_from_jax(jax.device_get(jp))
    toks = np.random.default_rng(0).integers(0, get(arch).vocab_size, (2, 40))
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]), "targets": torch.as_tensor(toks[:, 1:])}
    j_loss, j_grad = jax.value_and_grad(lambda p: jm.loss(p, jb)[0])(jp)
    t_grad, t_loss = torch.func.grad_and_value(lambda p: m.loss(p, tb)[0])(tp)
    assert abs(float(t_loss) - float(j_loss)) <= GRAD_ATOL
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree_util.tree_leaves(j_grad))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(t_grad))
