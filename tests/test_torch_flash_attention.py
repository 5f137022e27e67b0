"""The port's flash attention (kernel 7) against the reference's.

On the CPU the port's ``ops.flash_attention`` runs the kernel's plain
version (``flash_attention_ref``, the whole ``(S, S)`` matrix); both are
held against the reference's Pallas kernel in interpret mode and its
``ref.flash_attention_ref`` over the reference's own sweep
(``tests/test_kernels.py``) plus the hybrid model's head dim 80: f32 inputs
N(0, 1) at atol 3e-5, bf16 inputs N(0, 1/4) at atol 2e-2 (the reference's
bounds: the products sum in other orders, and a bf16 output rounds once in
each).  The model's ``layers.chunked_attention`` — the eager blocked form on
the CPU, and the kernel's wiring on ``(B, S, H, hd)`` views (``flash_attention_heads``)
— is held against the reference's at atol 3e-5, and so is the wrapper on
non-contiguous ``(B, S, H, hd)`` views, which the kernel reads in place by
their strides.  The CUDA kernel itself is held against the plain version on
the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as j_layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

MASKS = ((None, 0), (48, 0), (None, 40), (30, 100))   # the last: prefix wider than window


def _qkv(shape, seed, scale=1.0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=shape) * scale).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("window,prefix", MASKS)
@pytest.mark.parametrize("d", (32, 64, 80))
@pytest.mark.parametrize("s,bq,bk", ((128, 64, 64), (200, 64, 128), (257, 128, 64)))
def test_flash_attention_matches_reference(s, bq, bk, d, window, prefix):
    q, k, v = _qkv((2, s, d), seed=s * 1000 + d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(flash_attention_pallas(jq, jk, jv, window=window, prefix=prefix,
                                               block_q=bq, block_k=bk, interpret=True))
    oracle = np.asarray(j_ref.flash_attention_ref(jq, jk, jv, window=window, prefix=prefix))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = fa.flash_attention_cuda.launches
    got = ops.flash_attention(tq, tk, tv, window=window, prefix=prefix)
    assert fa.flash_attention_cuda.launches == before      # CPU: the plain version
    assert got.shape == (2, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, atol=3e-5)
    np.testing.assert_allclose(got.numpy(), oracle, atol=3e-5)
    np.testing.assert_allclose(ref.flash_attention_ref(tq, tk, tv, window=window,
                                                       prefix=prefix).numpy(), oracle, atol=3e-5)


@pytest.mark.parametrize("d", (64, 80))
def test_flash_attention_bf16_matches_reference(d):
    q, k, v = _qkv((2, 128, d), seed=9 + d, scale=0.5)
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas, np.float32), atol=2e-2)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(j_ref.flash_attention_ref(jq, jk, jv), np.float32),
        atol=2e-2)


@pytest.mark.parametrize("b,s,h,hd,window,prefix,block", (
    (2, 160, 3, 32, 64, 0, 64),           # the reference's own window case
    (1, 600, 2, 80, None, 0, 512),        # two blocks of 512, the second ragged
    (1, 300, 2, 32, None, 70, 128),
))
def test_chunked_attention_matches_reference(b, s, h, hd, window, prefix, block):
    q, k, v = _qkv((b, s, h, hd), seed=s + hd)
    want = np.asarray(j_layers.chunked_attention(
        *map(jnp.asarray, (q, k, v)), window=window, prefix=prefix, block_q=block,
        block_k=block))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = layers.chunked_attention(tq, tk, tv, window=window, prefix=prefix, block_q=block,
                                   block_k=block)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    # the kernel's wiring: the (B, S, H, hd) views as they are
    heads = layers.flash_attention_heads(tq, tk, tv, window=window, prefix=prefix)
    np.testing.assert_allclose(heads.numpy(), want, atol=3e-5)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    q = torch.zeros((2, 8, 80))
    with pytest.raises(ValueError, match="CUDA"):
        fa._check(q, q, q, None, 0)


def _strided_qkv(b, s, h, d, seed):
    """q, k, v as non-contiguous (B, S, H, d) views of one (B, S, 3, H, d)
    buffer, as a fused projection would give them."""
    buf = torch.from_numpy(np.random.default_rng(seed).normal(size=(b, s, 3, h, d))
                           .astype(np.float32))
    return buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]


@pytest.mark.parametrize("window,prefix", MASKS)
@pytest.mark.parametrize("d", (32, 64, 80))
def test_strided_wrapper_matches_reference(d, window, prefix):
    b, s, h = 2, 200, 3
    tq, tk, tv = _strided_qkv(b, s, h, d, seed=d + (window or 0) + prefix)
    assert not tq.is_contiguous()
    before = fa.flash_attention_cuda.launches
    got = ops.flash_attention(tq, tk, tv, window=window, prefix=prefix)
    assert fa.flash_attention_cuda.launches == before      # CPU: the plain version
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32 and got.is_contiguous()
    rows = [np.ascontiguousarray(t.numpy().transpose(0, 2, 1, 3).reshape(b * h, s, d))
            for t in (tq, tk, tv)]
    pallas = np.asarray(flash_attention_pallas(*map(jnp.asarray, rows), window=window,
                                               prefix=prefix, block_q=64, block_k=64,
                                               interpret=True))
    pallas = pallas.reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), pallas, atol=3e-5)
    chunked = np.asarray(j_layers.chunked_attention(
        *(jnp.asarray(t.numpy()) for t in (tq, tk, tv)), window=window, prefix=prefix,
        block_q=64, block_k=64))
    np.testing.assert_allclose(got.numpy(), chunked, atol=3e-5)


@pytest.mark.parametrize("window,prefix", MASKS)
def test_flash_attention_heads_equals_eager_chunked(window, prefix):
    tq, tk, tv = _strided_qkv(2, 300, 2, 80, seed=31 + prefix)
    got = layers.flash_attention_heads(tq, tk, tv, window=window, prefix=prefix)
    want = layers.chunked_attention_eager(tq, tk, tv, window=window, prefix=prefix,
                                          block_q=128, block_k=128)
    assert got.shape == want.shape == (2, 300, 2, 80)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_layout_check_takes_aligned_strides_and_rejects_the_rest(dtype):
    buf = torch.zeros((2, 64, 3, 4, 80), dtype=dtype)
    fa._check_layout(buf[:, :, 0], buf[:, :, 1], buf[:, :, 2])     # strided views: taken
    good = buf[:, :, 0]
    wide = torch.zeros((2, 64, 4 * 80 + 2), dtype=dtype)            # rows of 322 elements
    step = torch.zeros((2, 64, 4, 160), dtype=dtype)
    for bad, what in (
        (good.transpose(2, 3).contiguous().transpose(2, 3), "head-dim stride"),
        (step[..., ::2], "head-dim stride"),
        (wide[..., :320].view(2, 64, 4, 80), "16-byte"),            # sequence stride 322
        (torch.zeros((2, 64, 4, 82), dtype=dtype)[..., :80], "16-byte"),   # head stride 82
    ):
        with pytest.raises(ValueError, match=what):
            fa._check_layout(bad, good, good)
