"""The port's chunked SSD scan (kernel 8) and Mamba2 block against the
reference's.

On the CPU the port's ``ops.ssd_scan`` pads S to a chunk multiple with
``dt = da = 0`` steps and runs the kernel's plain version (the sequential
recurrence); it is held against the reference's ``ops.ssd_scan`` (the
Pallas kernel in interpret mode) and ``ref.ssd_scan_ref`` over the
reference's own sweep plus the models' (P, N) = (64, 64), at atol 2e-5 (the
reference's bound: the chunked form and the recurrence sum in other orders).
The Mamba2 block (``ssm.apply_mamba2`` / ``decode_mamba2``) on converted
reference parameters is held against the reference's at atol 1e-4, on both
forms of the eager chunked core (``nc <= 64`` batched; ``nc > 64`` fused, at
chunk 16 and S = 1,100), final and conv states included; and the kernel's
wiring (``ssm.ssd_scan_heads``, the model's views handed over as they are)
against the eager core.  The view entry itself is held against the
reference in ``tests/test_torch_ssd_views.py``; the CUDA kernel against the
plain version on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import ssm as j_ssm
from repro_torch.configs import get
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import ssm


def _inputs(bh, s, p, n, seed):
    """The reference test's recipe: x, B, C ~ N(0, 1/4); dt = softplus(N(0,
    1)) / 5; da = -dt exp(N(0, 1/100))."""
    r = np.random.default_rng(seed)
    x = (r.normal(size=(bh, s, p)) * 0.5).astype(np.float32)
    b = (r.normal(size=(bh, s, n)) * 0.5).astype(np.float32)
    c = (r.normal(size=(bh, s, n)) * 0.5).astype(np.float32)
    dt = (np.logaddexp(r.normal(size=(bh, s)), 0) * 0.2).astype(np.float32)
    da = (-dt * np.exp(r.normal(size=(bh, s)) * 0.1)).astype(np.float32)
    return x, b, c, dt, da


@pytest.mark.parametrize("p,n", ((16, 8), (32, 16), (64, 64)))
@pytest.mark.parametrize("s,chunk", ((32, 16), (100, 16), (128, 64)))
def test_ssd_scan_matches_reference(s, chunk, p, n):
    arrays = _inputs(3, s, p, n, seed=s * 100 + p + n)
    y_j, st_j = j_ops.ssd_scan(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    y_r, st_r = j_ref.ssd_scan_ref(*map(jnp.asarray, arrays))
    tens = [torch.from_numpy(a) for a in arrays]
    before = ss.ssd_scan_cuda.launches
    y, st = ops.ssd_scan(*tens, chunk=chunk)
    assert ss.ssd_scan_cuda.launches == before      # CPU: the plain version
    assert y.shape == (3, s, p) and st.shape == (3, p, n)
    assert y.dtype == st.dtype == torch.float32
    for got, want in ((y, y_j), (st, st_j), (y, y_r), (st, st_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    y2, st2 = ref.ssd_scan_ref(*tens)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y_r), atol=2e-5)
    np.testing.assert_allclose(st2.numpy(), np.asarray(st_r), atol=2e-5)


def test_padding_steps_leave_the_state_unchanged():
    """S = 100 at chunk 64 pads 28 identity steps: the result equals the
    unpadded recurrence exactly (the plain version runs the padded input)."""
    tens = [torch.from_numpy(a) for a in _inputs(2, 100, 16, 8, seed=5)]
    y, st = ops.ssd_scan(*tens, chunk=64)
    y0, st0 = ref.ssd_scan_ref(*tens)
    assert torch.equal(y, y0) and torch.equal(st, st0)


def _mamba_case(arch, seq, seed):
    j_cfg, cfg = j_get(arch), get(arch)
    jp = j_ssm.init_mamba2(jax.random.PRNGKey(seed), j_cfg)
    tp = params_from_jax(jax.device_get(jp))
    x = (np.random.default_rng(seed).normal(size=(2, seq, cfg.d_model)) * 0.5).astype(np.float32)
    return j_cfg, cfg, jp, tp, x


@pytest.mark.parametrize("arch", ("mamba2-130m-reduced", "zamba2-2.7b-reduced"))
@pytest.mark.parametrize("seq", (2, 40, 1100))     # nc = 1 (short conv state), 3, 69 > 64
def test_apply_and_decode_mamba2_match_reference(arch, seq):
    j_cfg, cfg, jp, tp, x = _mamba_case(arch, seq, seed=seq)
    y_j, (st_j, cv_j) = j_ssm.apply_mamba2(jp, jnp.asarray(x), j_cfg)
    y, (st, cv) = ssm.apply_mamba2(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), atol=1e-4)
    np.testing.assert_allclose(cv.numpy(), np.asarray(cv_j), atol=1e-4)
    steps = (np.random.default_rng(seq + 1).normal(size=(3, 2, 1, cfg.d_model)) * 0.5
             ).astype(np.float32)
    j_state, state = (st_j, cv_j), (st, cv)
    for xt in steps:
        o_j, j_state = j_ssm.decode_mamba2(jp, jnp.asarray(xt), j_state, j_cfg)
        o, state = ssm.decode_mamba2(tp, torch.from_numpy(xt), state, cfg)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-4)
        np.testing.assert_allclose(state[0].numpy(), np.asarray(j_state[0]), atol=1e-4)
        np.testing.assert_allclose(state[1].numpy(), np.asarray(j_state[1]), atol=1e-4)


def test_decode_from_init_state_matches_reference():
    j_cfg, cfg, jp, tp, x = _mamba_case("mamba2-130m-reduced", 1, seed=3)
    o_j, (s_j, c_j) = j_ssm.decode_mamba2(jp, jnp.asarray(x), j_ssm.init_state(j_cfg, 2),
                                          j_cfg)
    o, (s, c) = ssm.decode_mamba2(tp, torch.from_numpy(x), ssm.init_state(cfg, 2), cfg)
    for got, want in ((o, o_j), (s, s_j), (c, c_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("nc", (3, 66))               # both forms of the eager core
def test_kernel_wiring_matches_the_eager_core(nc):
    """``ssd_scan_heads`` (the CUDA branch's wiring: x (B,S,H,P) and the one
    B/C group as a (B,S,1,N) view, dt and da per head) through the plain
    version equals the model's eager chunked core."""
    r = np.random.default_rng(nc)
    bsz, h, p, n, q = 2, 3, 8, 4, 16
    seq = nc * q
    xs = torch.from_numpy((r.normal(size=(bsz, seq, h, p)) * 0.5).astype(np.float32))
    bm = torch.from_numpy((r.normal(size=(bsz, seq, n)) * 0.5).astype(np.float32))
    cm = torch.from_numpy((r.normal(size=(bsz, seq, n)) * 0.5).astype(np.float32))
    dt = torch.from_numpy((np.logaddexp(r.normal(size=(bsz, seq, h)), 0) * 0.2
                           ).astype(np.float32))
    da = -dt * 0.9
    y_k, st_k = ssm.ssd_scan_heads(xs, bm, cm, dt, da, q)
    y_e, st_e = ssm.ssd_chunked_eager(xs, bm, cm, dt, da, q)
    np.testing.assert_allclose(y_k.numpy(), y_e.numpy(), atol=2e-5)
    np.testing.assert_allclose(st_k.numpy(), st_e.numpy(), atol=2e-5)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    x = torch.zeros((2, 8, 16))
    b = torch.zeros((2, 8, 4))
    dt = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ss._check(x, b, b, dt, dt, 4)
    assert ss.smem_bytes(64, 128, 128) <= ss.MAX_SMEM_BYTES < ss.smem_bytes(128, 128, 128)
