"""The port's serving driver (``repro_torch.launch.serve``) against the
reference's: ``serve(..., device="cpu")`` gives the greedy tokens of the
reference's serving steps (``repro/launch/serve.py::main``) on the same
(converted) parameters of ``zamba2-2.7b-reduced``, at prompt 40 and at 2,100
(>= ``CHUNK_THRESHOLD``: the chunked attention and the SSD's padding); its
command line runs on the CPU; ``--restore`` serves saved parameters (a
params-only checkpoint and a round checkpoint's ``['params']``, bf16 bit for
bit) with the tokens of the unsaved ones, and ``--metrics-port`` exports the
``prefill`` and ``decode`` phase seconds.
"""

import os
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.models import build_model as j_build
from repro_torch.checkpoint import save
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ops import tree_leaves
from repro_torch.launch import serve as serve_mod
from repro_torch.models import build_model


def _pair(arch):
    j_cfg, cfg = j_get(arch), get(arch)
    jm = j_build(j_cfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    return cfg, jm, jp, params_from_jax(jax.device_get(jp))


def _reference_serve(jm, jp, cfg, b, s, gen):
    """The reference's serving steps (``repro/launch/serve.py::main``) on the
    given parameters: prompt from default_rng(0), cache_len = s + gen, greedy
    argmax, decode position s + prefix + i."""
    rng = np.random.default_rng(0)
    cache_len = s + gen
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (b, s)), jnp.int32)}
    prefill = jax.jit(lambda p, bb: jm.prefill(p, bb, cache_len))
    decode = jax.jit(jm.decode_step)
    logits, cache = prefill(jp, batch)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    prefix = cfg.prefix_tokens or 0
    for i in range(gen - 1):
        logits, cache = decode(jp, tok, cache, jnp.asarray(s + prefix + i))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("s,gen", ((40, 8), (2100, 4)))
def test_serve_gives_the_references_greedy_tokens(s, gen):
    cfg, jm, jp, tp = _pair("zamba2-2.7b-reduced")
    want = _reference_serve(jm, jp, cfg, 2, s, gen)
    toks, timings = serve_mod.serve(cfg, 2, s, gen, device="cpu", params=tp)
    assert toks.shape == (2, gen) and np.array_equal(toks, want)
    assert timings["decode_steps"] == gen - 1
    assert timings["prefill_ms"] > 0 and timings["decode_ms"] > 0


class _CurrentStdout:
    """Writes to whatever ``sys.stdout`` is at the time of the write."""

    def write(self, text):
        return sys.stdout.write(text)

    def flush(self):
        sys.stdout.flush()


@pytest.fixture
def serve_log(monkeypatch):
    """The obs logger's handler holds the stdout it was made with, at import;
    for the test, it writes to the stdout that ``capsys`` captures."""
    (handler,) = serve_mod.log.handlers
    monkeypatch.setattr(handler, "stream", _CurrentStdout())


def test_serve_main_on_the_cpu(capsys, serve_log):
    toks = serve_mod.main(["--arch", "mamba2-130m-reduced", "--batch", "2", "--prompt-len",
                           "16", "--gen", "3", "--device", "cpu"])
    assert toks.shape == (2, 3)
    assert "[serve] prefill 2x16" in capsys.readouterr().out


def test_serve_status_lines_go_through_the_obs_logger():
    # the logger the reference's serve uses, under the port's logger names:
    # REPRO_LOG=WARNING leaves the run's output empty, INFO prints its lines
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2-130m-reduced",
            "--batch", "1", "--prompt-len", "8", "--gen", "2", "--device", "cpu"]
    assert serve_mod.log.name == "repro_torch.obs.serve"
    outs = {}
    for level in ("WARNING", "INFO"):
        env = dict(os.environ, REPRO_LOG=level)
        run = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        outs[level] = run.stdout.splitlines()
    assert outs["WARNING"] == []
    assert [line.split(" ")[:2] for line in outs["INFO"]] == [
        ["[serve]", "prefill"], ["[serve]", "generated"], ["[serve]", "sample"]]


@pytest.mark.parametrize("flag", (["--restore", "ckpt"], ["--metrics-port", "0"]))
def test_serve_flags_of_unported_modules_raise(flag, tmp_path, monkeypatch, capsys, serve_log):
    # both flags, once refused, now work
    arch = "mamba2-130m-reduced"
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "16", "--gen", "3",
            "--device", "cpu"]
    if flag[0] == "--restore":
        cfg = get(arch)
        params = build_model(cfg).init(torch.Generator().manual_seed(7), "cpu")
        want, _ = serve_mod.serve(cfg, 2, 16, 3, device="cpu", params=params)
        assert not np.array_equal(want, serve_mod.main(argv))
        save(str(tmp_path / "plain"), params, step=5)
        save(str(tmp_path / "round"), {"params": params, "opt_state": {"m": torch.zeros(2)}},
             step=9)
        for d, step in (("plain", 5), ("round", 9)):
            got = serve_mod.main(argv + ["--restore", str(tmp_path / d)])
            assert np.array_equal(got, want)
            assert f"(round {step})" in capsys.readouterr().out
        like = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        back, _ = serve_mod.load_params(str(tmp_path / "round"), like)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params)))
        return
    scraped = []

    class Scraped(serve_mod.MetricsServer):
        def stop(self):
            with urllib.request.urlopen(f"{self.url}/metrics") as r:
                scraped.append(r.read().decode())
            super().stop()

    monkeypatch.setattr(serve_mod, "MetricsServer", Scraped)
    serve_mod.main(argv + flag)
    (body,) = scraped
    for phase in ("prefill", "decode"):
        assert f'repro_phase_seconds{{phase="{phase}"}}' in body
    assert 'repro_run_info{arch="mamba2-130m-reduced",mode="serve"} 1' in body
    assert "metrics endpoint at http://127.0.0.1:" in capsys.readouterr().out
