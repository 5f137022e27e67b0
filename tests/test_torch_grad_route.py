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
