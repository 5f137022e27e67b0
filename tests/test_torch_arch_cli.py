"""The port's ``launch/train.py --arch`` against the reference's arch loop.

The reference's round metrics are read from its jitted round step (a stand-in
for its module's ``jax`` whose ``jit`` records each step's ``RoundMetrics``),
once per argument list in this module;
the port's run starts from the reference's initial parameters
(``main(argv, init_fn=...)`` with ``convert.params_from_jax``).

* ``mamba2-``, ``zamba2-``, ``llama3-``, ``mixtral-8x7b-`` and
  ``whisper-small-reduced`` (its ``frames`` drawn after the tokens) at the
  reference's default flags (8 clients, m = 2, aocs, vmap, jnp; seq 16): per
  round the mask and the sent count bitwise, the ``[round k]`` line's
  ``sent`` and ``bits`` fields equal, the norms, alpha and gamma within
  rtol 1e-5 (the norms of gradients that the two frameworks sum in other
  orders agree to ~1e-6), the loss within atol 1e-4;
* ``mamba2-130m-reduced`` on vmap + pallas and scan + pallas (cached and
  two-pass), one round: norms, alpha, gamma and masks bitwise the vmap +
  jnp run's;
  in bf16 (both packages' config cast): masks bitwise, norms within
  rtol 1e-2 and loss within atol 1e-3 (bf16 gradients rounded in other
  orders);
* ``--stragglers``/``--deadline`` (the client-state layer over all n
  clients): masks and the ``sel``/``miss``/``drop`` fields equal;
* the reference's full-state resume test (momentum + threshold, 2 clients):
  a resumed run prints the uninterrupted run's round lines exactly; a port
  checkpoint resumed by the reference and a reference checkpoint resumed by
  the port give the port's straight run's masks; a changed flag is refused with
  the reference's message; a whisper round checkpoint crosses both ways too;
* ``--shard on`` on gloo meshes of 1 (in this process) and 2 ranks
  (``spawn_mesh``): masks equal the reference's (its mesh round draws its
  plain round's masks);
* the three conflicts exit with the reference's messages, and the obs flags
  (the phased executor with the gap every round, the JSONL stream) leave the
  masks bitwise the plain run's;
* ``synthetic_token_batch`` draws the reference's arrays bitwise (the VLM's
  ``patches``, whisper's ``frames``).
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.launch import train as j_train
from repro.models import build_model as j_build
from repro_torch.convert import params_from_jax
from repro_torch.launch import train

BASE = ["--rounds", "2", "--seq", "16"]
RTOL = 1e-5
LOSS_ATOL = 1e-4
WHISPER_CKPT = ["--arch", "whisper-small-reduced", "--rounds", "2", "--clients", "2",
                "--expected", "1", "--batch", "1", "--seq", "8"]
RESUME = ["--arch", "llama3-8b-reduced", "--rounds", "4", "--clients", "2", "--expected", "1",
          "--batch", "1", "--seq", "8", "--server-opt", "momentum", "--sampler", "threshold"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops in this file are small: one intra-op thread keeps a
    test worker's torch from contending with the other workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _RecordingJax:
    """The reference module's ``jax``, whose ``jit`` records the
    ``RoundMetrics`` of every round step it runs."""

    def __init__(self, rec):
        self._rec = rec

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jf = jax.jit(fn, **kw)

        def run(*a, **k):
            out = jf(*a, **k)
            if isinstance(out, tuple) and len(out) == 3 and hasattr(out[2], "mask"):
                self._rec.append(jax.device_get(out[2]))
            return out

        return run


_PARAMS = {}


def _ref_params(arch, dtype=None):
    if (arch, dtype) not in _PARAMS:
        cfg = j_get(arch) if dtype is None else j_get(arch).with_(dtype=dtype)
        _PARAMS[(arch, dtype)] = jax.device_get(
            j_build(cfg, remat=False).init(jax.random.PRNGKey(0)))
    return _PARAMS[(arch, dtype)]


_REF_RUNS = {}


def _ref(monkeypatch, capsys, argv):
    """The reference's round metrics and ``[round k]`` lines for ``argv``,
    run once per module (each run compiles its round step)."""
    if tuple(argv) not in _REF_RUNS:
        rec = []
        monkeypatch.setattr(j_train, "jax", _RecordingJax(rec))
        j_train.main(argv)
        monkeypatch.undo()
        _REF_RUNS[tuple(argv)] = (rec, _round_lines(capsys.readouterr().out))
    return _REF_RUNS[tuple(argv)]


def _port(capsys, argv, arch, dtype=None):
    tree = _ref_params(arch, dtype)
    _, rows = train.main(argv + ["--device", "cpu"],
                         init_fn=lambda dev: params_from_jax(tree, dev))
    return rows, _round_lines(capsys.readouterr().out)


def _round_lines(text):
    return [line for line in text.splitlines() if line.startswith("[round")]


def _untimed(line):
    return re.sub(r"\(\d+\.\d+s\)", "", line)


def _fields(line):
    """The round line without its loss, alpha, gamma and seconds."""
    return re.sub(r"(loss|alpha|gamma) -?\d+\.\d+ ", "", _untimed(line))


def _same_rounds(rows, lines, ref, ref_lines, rtol=RTOL, loss_atol=LOSS_ATOL):
    assert len(rows) == len(ref) == len(lines) == len(ref_lines) > 0
    for r, j, line, j_line in zip(rows, ref, lines, ref_lines):
        np.testing.assert_array_equal(r["mask"], np.asarray(j.mask))
        assert r["sent"] == int(j.sent_clients)
        assert _fields(line) == _fields(j_line)
        np.testing.assert_allclose(r["norms"], np.asarray(j.norms), rtol=rtol)
        np.testing.assert_allclose(r["alpha"], float(j.alpha), rtol=rtol)
        np.testing.assert_allclose(r["gamma"], float(j.gamma), rtol=rtol)
        assert abs(r["loss"] - float(j.loss)) <= loss_atol


@pytest.mark.parametrize("arch", ("mamba2-130m-reduced", "zamba2-2.7b-reduced",
                                  "llama3-8b-reduced", "mixtral-8x7b-reduced",
                                  "whisper-small-reduced"))
def test_arch_rounds_match_reference(monkeypatch, capsys, arch):
    argv = ["--arch", arch] + BASE
    ref, ref_lines = _ref(monkeypatch, capsys, argv)
    rows, lines = _port(capsys, argv, arch)
    _same_rounds(rows, lines, ref, ref_lines)


def test_engines_and_backends_agree_bitwise(capsys):
    arch = "mamba2-130m-reduced"
    argv = ["--arch", arch, "--rounds", "1", "--seq", "16"]
    base, base_lines = _port(capsys, argv, arch)
    for flags in (["--agg-backend", "pallas"],
                  ["--engine", "scan", "--agg-backend", "pallas"],
                  ["--engine", "scan", "--agg-backend", "pallas", "--cache-groups", "0"]):
        rows, lines = _port(capsys, argv + flags, arch)
        for r, b in zip(rows, base):
            for name in ("mask", "norms"):
                np.testing.assert_array_equal(r[name], b[name])
            assert (r["alpha"], r["gamma"], r["sent"]) == (b["alpha"], b["gamma"], b["sent"])
        assert [_fields(x) for x in lines] == [_fields(x) for x in base_lines]


def test_bf16_rounds_match_reference(monkeypatch, capsys):
    import repro_torch.configs as t_configs

    arch = "mamba2-130m-reduced"
    j_get_, t_get = j_train.get, t_configs.get
    monkeypatch.setattr(j_train, "get", lambda n: j_get_(n).with_(dtype="bfloat16"))
    rec = []
    monkeypatch.setattr(j_train, "jax", _RecordingJax(rec))
    j_train.main(["--arch", arch] + BASE)
    monkeypatch.undo()
    ref_lines = _round_lines(capsys.readouterr().out)
    monkeypatch.setattr(t_configs, "get", lambda n: t_get(n).with_(dtype="bfloat16"))
    rows, lines = _port(capsys, ["--arch", arch] + BASE, arch, "bfloat16")
    _same_rounds(rows, lines, rec, ref_lines, rtol=1e-2, loss_atol=1e-3)


def test_stragglers_match_reference(monkeypatch, capsys):
    arch = "mamba2-130m-reduced"
    argv = ["--arch", arch, "--rounds", "3", "--seq", "8", "--stragglers",
            "p_up=0.35,p_down=0.15,drop=0.1,over=2", "--deadline", "2.0"]
    ref, ref_lines = _ref(monkeypatch, capsys, argv)
    rows, lines = _port(capsys, argv, arch)
    _same_rounds(rows, lines, ref, ref_lines)
    assert all("sel " in line and "miss " in line for line in lines)
    for r, j in zip(rows, ref):
        assert (r["selected"], r["misses"], r["drops"]) == (
            int(j.selected_clients), int(j.deadline_misses), int(j.dropouts))


def test_train_cli_checkpoints_full_state(tmp_path, capsys):
    """The reference's test of the same name on the port: the checkpoint
    carries the server-opt, sampler and RNG state, a resumed run prints the
    uninterrupted run's round lines, and flag drift is refused."""
    d = str(tmp_path / "ck")
    train.main(RESUME + ["--device", "cpu"])
    ref = [_untimed(x) for x in _round_lines(capsys.readouterr().out)]
    train.main(RESUME[:3] + ["2"] + RESUME[4:] + ["--checkpoint", d, "--ckpt-every", "2",
                                                  "--device", "cpu"])
    first = _round_lines(capsys.readouterr().out)
    idx = json.load(open(os.path.join(d, "step-00000002", "index.json")))
    assert any(k.startswith("['opt_state']") for k in idx["keys"])
    assert any(k.startswith("['sampler_state']") for k in idx["keys"])
    assert idx["meta"]["round"] == 2 and "rng_state" in idx["meta"]
    train.main(RESUME + ["--resume", d, "--device", "cpu"])
    resumed = _round_lines(capsys.readouterr().out)
    assert [_untimed(x) for x in first + resumed] == ref
    with pytest.raises(SystemExit, match="fingerprint") as t_exit:
        train.main(RESUME[:-1] + ["uniform", "--resume", d, "--device", "cpu"])
    with pytest.raises(SystemExit) as j_exit:
        j_train.main(RESUME[:-1] + ["uniform", "--resume", d])
    assert str(t_exit.value) == str(j_exit.value)


def test_checkpoints_cross_between_packages(tmp_path, monkeypatch, capsys):
    arch = RESUME[1]
    # the straight run's masks: the port's (bitwise the reference's, as the
    # round tests above hold)
    straight, _ = _port(capsys, RESUME, arch)
    # the port writes round 2, the reference resumes it
    d_port = str(tmp_path / "port")
    _port(capsys, RESUME[:3] + ["2"] + RESUME[4:] + ["--checkpoint", d_port,
                                                     "--ckpt-every", "2"], arch)
    rec, _ = _ref(monkeypatch, capsys, RESUME + ["--resume", d_port])
    # the reference writes round 2, the port resumes it
    d_ref = str(tmp_path / "ref")
    _ref(monkeypatch, capsys, RESUME[:3] + ["2"] + RESUME[4:] + ["--checkpoint", d_ref,
                                                                 "--ckpt-every", "2"])
    rows, _ = _port(capsys, RESUME + ["--resume", d_ref], arch)
    assert len(rec) == len(rows) == 2
    for j_res, r_res, want in zip(rec, rows, straight[2:]):
        np.testing.assert_array_equal(np.asarray(j_res.mask), want["mask"])
        np.testing.assert_array_equal(r_res["mask"], want["mask"])
        assert abs(float(j_res.loss) - want["loss"]) <= LOSS_ATOL
        assert abs(r_res["loss"] - want["loss"]) <= LOSS_ATOL


def test_whisper_checkpoints_cross_between_packages(tmp_path, monkeypatch, capsys):
    """A whisper round checkpoint (its encoder and cross-attention leaves)
    written by either package resumes in the other on the straight run's
    masks."""
    arch = WHISPER_CKPT[1]
    straight, _ = _port(capsys, WHISPER_CKPT, arch)
    first = WHISPER_CKPT[:3] + ["1"] + WHISPER_CKPT[4:]
    d_port, d_ref = str(tmp_path / "port"), str(tmp_path / "ref")
    _port(capsys, first + ["--checkpoint", d_port, "--ckpt-every", "1"], arch)
    rec, _ = _ref(monkeypatch, capsys, WHISPER_CKPT + ["--resume", d_port])
    _ref(monkeypatch, capsys, first + ["--checkpoint", d_ref, "--ckpt-every", "1"])
    rows, _ = _port(capsys, WHISPER_CKPT + ["--resume", d_ref], arch)
    idx = json.load(open(os.path.join(d_port, "step-00000001", "index.json")))
    assert any("['xattn']" in k for k in idx["keys"])
    assert any(k.startswith("['params']['enc_layers']") for k in idx["keys"])
    assert len(rec) == len(rows) == 1
    for got in (np.asarray(rec[0].mask), rows[0]["mask"]):
        np.testing.assert_array_equal(got, straight[1]["mask"])
    for loss in (float(rec[0].loss), rows[0]["loss"]):
        assert abs(loss - straight[1]["loss"]) <= LOSS_ATOL


def _mesh_arch(mesh, argv, tree):
    _, rows = train.main(argv + ["--shard", "on", "--device", "cpu"],
                         init_fn=lambda dev: params_from_jax(tree, dev))
    return rows


def test_shard_on_matches_reference_at_world_sizes_1_and_2(monkeypatch, capsys):
    from repro_torch.fl.mesh import spawn_mesh

    arch = "llama3-8b-reduced"
    argv = ["--arch", arch] + BASE
    # the reference's mesh round draws its plain round's masks (its own
    # contract), so the port's mesh is held to the plain reference run
    ref, ref_lines = _ref(monkeypatch, capsys, argv)
    rows, lines = _port(capsys, argv + ["--shard", "on"], arch)
    _same_rounds(rows, lines, ref, ref_lines)
    out = spawn_mesh(_mesh_arch, 2, "gloo", 120, device="cpu",
                     args=(argv, _ref_params(arch)))
    for rank_rows in out:
        for r, j in zip(rank_rows, ref):
            np.testing.assert_array_equal(r["mask"], np.asarray(j.mask))
            np.testing.assert_allclose(r["norms"], np.asarray(j.norms), rtol=RTOL)
            assert abs(r["loss"] - float(j.loss)) <= LOSS_ATOL


@pytest.mark.parametrize("flags", (
    ["--shard", "on", "--engine", "scan"],
    ["--shard", "on", "--diag-every", "1"],
    ["--shard", "on", "--server-opt", "adam"],
), ids=("scan", "diag", "server-opt"))
def test_conflicts_exit_as_the_reference(flags):
    argv = ["--arch", "mamba2-130m-reduced", "--rounds", "1", "--seq", "8"] + flags
    with pytest.raises(SystemExit) as j_exit:
        j_train.main(argv)
    with pytest.raises(SystemExit) as t_exit:
        train.main(argv + ["--device", "cpu"])
    assert str(t_exit.value) == str(j_exit.value)


def test_obs_flags_keep_the_rounds(tmp_path, capsys):
    from repro_torch.obs.events import read_events

    argv = ["--arch", "mamba2-130m-reduced", "--rounds", "2", "--seq", "8", "--device", "cpu"]
    _, plain = train.main(argv)
    path = str(tmp_path / "ev.jsonl")
    _, observed = train.main(argv + ["--diag-every", "1", "--obs-jsonl", path])
    for a, b in zip(plain, observed):
        np.testing.assert_array_equal(a["mask"], b["mask"])
        np.testing.assert_array_equal(a["norms"], b["norms"])
    kinds = [e["kind"] for e in read_events(path)]
    assert kinds[0] == "run_start" and kinds.count("round") == 2
    assert kinds.count("gap") == 2 and kinds[-1] == "run_end"


@pytest.mark.parametrize("arch", ("paligemma-3b-reduced", "whisper-small-reduced"))
def test_synthetic_token_batch_is_the_references(arch):
    from repro_torch.configs import get

    got = train.synthetic_token_batch(np.random.default_rng(5), get(arch), 3, 2, 2, 8, "cpu")
    want = j_train.synthetic_token_batch(np.random.default_rng(5), j_get(arch), 3, 2, 2, 8)
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        assert str(got[name].dtype).split(".")[1] == str(v.dtype)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(v))
