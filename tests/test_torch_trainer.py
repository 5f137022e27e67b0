"""``run_training`` and its ``History`` against the reference's.

A reduced femnist workload (8 of 24 clients, 2 local steps, batch 4, 5
rounds, eval every 2 rounds on a held-out split), the port on the CPU from
the reference's initial parameters, in both driver modes:

* ``bits``, ``sent`` and ``acc_rounds`` are equal (the masks are);
* ``loss`` and ``acc`` agree to rtol 1e-4, ``alpha``/``gamma`` to rtol 1e-4
  (five rounds compound float32 sum-order differences);
* compressed rounds are billed below plain ones, at the reference's bill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import FLConfig as JFLConfig
from repro.data import eval_split as j_eval_split
from repro.data import femnist_like as j_femnist_like
from repro.fl.trainer import run_training as j_run_training
from repro.models.simple import mlp_classifier as j_mlp
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.data import eval_split, femnist_like
from repro_torch.fl import History, run_training
from repro_torch.models.simple import mlp_classifier

DS_KW = dict(n_clients=24, dim=48, num_classes=10, base_examples=24, seed=0)
FL_KW = dict(n_clients=8, expected_clients=3, local_steps=2, lr_local=0.125)
RUN_KW = dict(rounds=5, batch_size=4, eval_every=2, seed=3)
EV_KW = dict(dataset_id=1, dim=48, num_classes=10, base_examples=24)


def _reference(**fl_kw):
    init, loss, acc = j_mlp(48, 10, hidden=16)
    ds = j_femnist_like(1, **DS_KW)
    ev = {k: jnp.asarray(v) for k, v in j_eval_split(j_femnist_like, 64, **EV_KW).items()}
    p0 = jax.device_get(init(jax.random.fold_in(jax.random.PRNGKey(RUN_KW["seed"]), 1)))
    _, hist = j_run_training(ds, init, loss, JFLConfig(**FL_KW, **fl_kw), eval_fn=jax.jit(acc),
                             eval_batch=ev, **RUN_KW)
    return p0, hist


def _port(p0, mode, **fl_kw):
    _, loss, acc = mlp_classifier(48, 10, hidden=16)
    ds = femnist_like(1, **DS_KW)
    ev = eval_split(femnist_like, 64, **EV_KW)
    return run_training(ds, lambda key: params_from_jax(p0, key.device), loss,
                        FLConfig(**FL_KW, **fl_kw), eval_fn=acc, eval_batch=ev, mode=mode,
                        device="cpu", **RUN_KW)


def _same_history(ht, hj):
    assert isinstance(ht, History)
    assert ht.bits == hj.bits and ht.sent == hj.sent
    assert ht.acc_rounds == hj.acc_rounds == [0, 2, 4]
    for name in ("loss", "acc", "alpha", "gamma"):
        np.testing.assert_allclose(getattr(ht, name), getattr(hj, name), rtol=1e-4,
                                   err_msg=name)
    assert set(ht.as_arrays()) == set(hj.as_arrays())


@pytest.fixture(scope="module")
def plain_reference():
    return _reference()


@pytest.mark.parametrize("mode", ("prefetch", "host"))
def test_history_matches_reference(plain_reference, mode):
    p0, hj = plain_reference
    _, ht = _port(p0, mode)
    _same_history(ht, hj)


def test_compressed_rounds_billed_below_plain(plain_reference):
    comp = dict(compression="randk", compression_param=0.05)
    p0, hj = _reference(**comp)
    _, ht = _port(p0, "prefetch", **comp)
    _, h_plain = _port(plain_reference[0], "prefetch")
    assert ht.bits == hj.bits
    assert 0 < ht.bits[-1] < h_plain.bits[-1]
