"""The port's five example scripts (``examples/torch/*.py``) on the CPU at a
tiny size, each through its ``main(argv)``: the lines they print, in the
reference examples' forms, and what they return.

``quickstart``'s distances to the optimum at 20 rounds equal, within 1e-5
per sampler, the same loop written here on the reference's
``repro.core.sample_and_aggregate`` with the same ``fold_in`` keys (the
participation masks are the reference's; the float32 products sum in
other orders).
"""

import importlib.util
import re
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sample_and_aggregate as j_sample_and_aggregate
from repro.data import quadratics as j_quadratics

EXAMPLES = Path(__file__).resolve().parent.parent / "examples" / "torch"
QUICK_ROUNDS = 20
QUICK_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops in this file are small: one intra-op thread keeps a
    test worker's torch from contending with the other workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def _reference_quickstart(sampler, rounds):
    """``examples/quickstart.py``'s loop on the reference package."""
    n, dim, m = 8, 12, 3
    a, c, _ = map(jnp.asarray, j_quadratics(n_clients=n, dim=dim, hetero=2.0, seed=0))
    scale = jnp.asarray([0.05, 0.05, 0.1, 0.1, 0.2, 0.5, 1.0, 6.0])
    a = a * scale[:, None, None]
    x_star = jnp.asarray(np.linalg.solve(
        np.asarray(a).sum(0), np.einsum("nij,nj->i", np.asarray(a), np.asarray(c))))
    w = jnp.full((n,), 1.0 / n)
    key = jax.random.PRNGKey(0)
    x = jnp.zeros(dim)
    for k in range(rounds):
        grads = jnp.einsum("nij,nj->ni", a, x[None, :] - c)
        res = j_sample_and_aggregate({"g": grads}, w, m, jax.random.fold_in(key, k),
                                     sampler=sampler)
        x = x - 0.5 / (1 + 0.02 * k) * res.aggregate["g"]
    return float(jnp.linalg.norm(x - x_star))


def test_quickstart_matches_the_reference_loop(capsys):
    errs = _example("quickstart").main(["--rounds", str(QUICK_ROUNDS), "--device", "cpu"])
    lines = _lines(capsys)
    assert list(errs) == ["full", "optimal", "aocs", "uniform"] and len(lines) == 4
    for (sampler, err), line in zip(errs.items(), lines):
        sent = 8 if sampler == "full" else 3
        assert line == f"{sampler:8s}  ~{sent} clients/round  ||x - x*|| = {err:.4f}"
        assert abs(err - _reference_quickstart(sampler, QUICK_ROUNDS)) <= QUICK_TOL


@pytest.mark.parametrize("name,argv,pattern", (
    ("femnist_fedavg", ["--rounds", "2", "--n", "4", "--m", "2", "--hidden", "16"],
     r"(full|aocs|uniform) +eta_l=[0-9.]+ +final acc \d\.\d{3} loss \d+\.\d{3} "
     r"alpha~(nan|\d+\.\d\d) uplink \d+\.\d\d Gbit \(sent \d+\.\d/4 clients/round\)"),
    ("shakespeare_gru", ["--rounds", "2", "--pool", "8", "--n", "4", "--m", "2",
                         "--hidden", "16"],
     r"(full|aocs|uniform) +eta_l=[0-9.]+ +next-char acc \d\.\d{3} loss \d+\.\d{3} "
     r"uplink \d+\.\d\d Gbit"),
), ids=("femnist_fedavg", "shakespeare_gru"))
def test_fl_examples_run_three_samplers(capsys, name, argv, pattern):
    with warnings.catch_warnings():
        # femnist's alpha column averages the rounds after the tenth: none here
        warnings.simplefilter("ignore", RuntimeWarning)
        hists = _example(name).main(argv + ["--device", "cpu"])
    head, *rows = _lines(capsys)
    assert head.startswith("FEMNIST-like dataset 1: pool=96" if name == "femnist_fedavg"
                           else "charlm pool=8, vocab=86, n=4, m=2")
    assert len(rows) == 3 and all(re.fullmatch(pattern, r) for r in rows)
    assert list(hists) == ["full", "aocs", "uniform"]
    for h in hists.values():
        assert len(h.loss) == 2 and np.isfinite(h.loss).all() and h.acc_rounds == [0, 1]
    assert hists["full"].sent == [4, 4]


def test_federated_llm_trains_whisper(capsys):
    rows = _example("federated_llm").main(
        ["--arch", "whisper-small-reduced", "--rounds", "2", "--clients", "2", "--m", "1",
         "--seq", "16", "--batch", "1", "--device", "cpu"])
    head, *lines = _lines(capsys)
    assert head.startswith("whisper-small-reduced: 0.73M params, vocab 512, n=2 m=1 "
                           "sampler=aocs")
    assert len(rows) == len(lines) == 2
    for k, (r, line) in enumerate(zip(rows, lines)):
        assert np.isfinite(r["loss"]) and r["mask"].shape == (2,)
        assert re.fullmatch(rf"\[round +{k}\] loss \d+\.\d{{4}} alpha \d\.\d{{3}} sent "
                            rf"{r['sent']}/2 uplink \d+\.\d\d Gbit", line)


def test_serve_decode_runs_the_six_families(capsys):
    out = _example("serve_decode").main(["--device", "cpu"])
    lines = _lines(capsys)
    families = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
    assert list(out) == ["llama3-8b", "mixtral-8x7b", "mamba2-130m", "zamba2-2.7b",
                         "whisper-small", "paligemma-3b"] and len(lines) == 6
    for (name, toks), fam, line in zip(out.items(), families, lines):
        assert toks.shape == (2, 8)
        assert re.fullmatch(rf"{name:18s} \[{fam:6s}\] generated \(2, 8\) "
                            rf"cache=\d+K elems  \(\d+\.\ds\)", line)
    assert "whisper-small      [audio ] generated (2, 8) cache=98K elems" in lines[4]
