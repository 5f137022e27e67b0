"""The SSD scan's view entry (kernel 8 on the model's layout) on the CPU.

* ``ops.ssd_scan_heads`` and the model's core (``ssm.ssd_chunked``,
  ``ssm.ssd_scan_heads``) on ``(B, S, H, P)`` and ``(B, S, G, N)`` views cut
  from one projection buffer, as ``apply_mamba2`` cuts them, at G = 1 and
  G = H, against the reference's ``ssd_scan_pallas`` (interpret mode) and
  ``ref.ssd_scan_ref`` on the per-head rows, at the reference's atol 2e-5.
* The numerics of the bf16 kernel, emulated in plain torch: its three
  passes with bf16 x, B, C, and each f32 operand of a product (the scaled x
  of the chunk states, att, the entering state) split into a bf16 high and
  a bf16 low part whose two products add in f32.  It stays within the card
  check's atol 1e-4 + rtol 1e-4 of the sequential recurrence over the
  sweep's shapes; with the high part alone it does not.
* The wrapper's layout check rejects what the kernel cannot take, before
  any launch, and passes the models' own views.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.configs import get
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import ssm

SSD_ATOL, SSD_RTOL = 1e-4, 1e-4      # chip_smoke.py's bound for kernel 8
SWEEP_S = (32, 100, 128, 300)
SWEEP_CHUNK = (16, 64, 128)
SWEEP_PN = ((16, 8), (64, 64), (64, 128))


def _views(bsz, s, h, p, n, g, seed):
    """x (B,S,H,P) and B, C (B,S,G,N) as strided views of one (B, S, H*P +
    2*G*N) buffer (the reference's recipe: N(0, 1/4)); dt = softplus(N(0,
    1)) / 5 and da = -dt exp(N(0, 1/100)), (B,S,H)."""
    r = np.random.default_rng(seed)
    buf = torch.from_numpy((r.normal(size=(bsz, s, h * p + 2 * g * n)) * 0.5).astype(np.float32))
    xs = buf[..., :h * p].reshape(bsz, s, h, p)
    bm = buf[..., h * p:h * p + g * n].reshape(bsz, s, g, n)
    cm = buf[..., h * p + g * n:].reshape(bsz, s, g, n)
    dt = torch.from_numpy((np.logaddexp(r.normal(size=(bsz, s, h)), 0) * 0.2).astype(np.float32))
    da = -dt * torch.from_numpy(np.exp(r.normal(size=(bsz, s, h)) * 0.1).astype(np.float32))
    return xs, bm, cm, dt, da


def _rows(t, h):
    """(B, S, G, W) -> the per-head rows (B*H, S, W)."""
    bsz, s = t.shape[:2]
    return t.expand(bsz, s, h, t.shape[-1]).permute(0, 2, 1, 3).reshape(bsz * h, s, -1)


def _per_head(t):
    bsz, s, h = t.shape
    return t.permute(0, 2, 1).reshape(bsz * h, s)


def _reference(xs, bm, cm, dt, da, chunk):
    """The reference's Pallas kernel (interpret mode) and its sequential
    recurrence on the per-head rows, back on (B, S, H, P) and (B, H, P, N)."""
    bsz, s, h, p = xs.shape
    n = bm.shape[-1]
    args = [jnp.asarray(a.contiguous().numpy())
            for a in (_rows(xs, h), _rows(bm, h), _rows(cm, h), _per_head(dt), _per_head(da))]
    out = []
    for y, st in (j_ops.ssd_scan(*args, chunk=chunk, interpret=True), j_ref.ssd_scan_ref(*args)):
        y = torch.from_numpy(np.array(y)).reshape(bsz, h, s, p).permute(0, 2, 1, 3)
        out.append((y, torch.from_numpy(np.array(st)).reshape(bsz, h, p, n)))
    return out


@pytest.mark.parametrize("g", ("one", "heads"))
@pytest.mark.parametrize("bsz,s,h,p,n,chunk", ((2, 64, 3, 16, 8, 16), (1, 96, 2, 32, 16, 32)))
def test_view_entry_matches_the_reference(bsz, s, h, p, n, chunk, g):
    groups = 1 if g == "one" else h
    xs, bm, cm, dt, da = _views(bsz, s, h, p, n, groups, seed=s + h + groups)
    assert not xs.is_contiguous() and not bm.is_contiguous()
    before = ss.ssd_scan_cuda.launches
    got = ops.ssd_scan_heads(xs, bm, cm, dt, da, chunk=chunk)
    assert ss.ssd_scan_cuda.launches == before          # CPU: the plain version
    assert got[0].shape == (bsz, s, h, p) and got[1].shape == (bsz, h, p, n)
    assert got[0].dtype == got[1].dtype == torch.float32
    for want in _reference(xs, bm, cm, dt, da, chunk):
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), w.numpy(), atol=2e-5)


@pytest.mark.parametrize("nc", (4, 66))               # both forms of the eager core
def test_model_core_on_views_matches_the_reference(nc):
    """``ssm.ssd_chunked`` (the eager core on the CPU) and
    ``ssm.ssd_scan_heads`` (the kernel's wiring, here its plain version) on
    the model's views of one buffer, against the reference per head."""
    bsz, h, p, n, chunk = 2, 3, 16, 8, 16
    xs, bm, cm, dt, da = _views(bsz, nc * chunk, h, p, n, 1, seed=nc)
    bm, cm = bm[:, :, 0], cm[:, :, 0]                   # the model's (B, S, N) group
    wanted = _reference(xs, bm[:, :, None], cm[:, :, None], dt, da, chunk)
    for got in (ssm.ssd_chunked(xs, bm, cm, dt, da, chunk),
                ssm.ssd_scan_heads(xs, bm, cm, dt, da, chunk)):
        for want in wanted:
            for a, w in zip(got, want):
                np.testing.assert_allclose(a.numpy(), w.numpy(), atol=2e-5)


def _split(v):
    """v (f32) as its bf16 high part and the bf16 rounding of the rest."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _emulated_kernel(x, b, c, dt, da, chunk, parts=2):
    """The bf16 kernel's three passes in plain torch on the per-row layout
    (x, b, c already bf16-valued f32).  ``parts`` = 2 splits each f32 operand
    of a product into high and low bf16 parts; 1 keeps the high part only."""
    def products(v):
        hi, lo = _split(v)
        return (hi, lo)[:parts]

    bh, s, p = x.shape
    n, nc = b.shape[-1], s // chunk
    xc, bc, cc = (t.reshape(bh, nc, chunk, -1) for t in (x, b, c))
    a_cs = torch.cumsum(da.reshape(bh, nc, chunk), dim=2)
    dtc = dt.reshape(bh, nc, chunk)
    a_tot = a_cs[..., -1]
    w = torch.exp(a_tot[..., None] - a_cs) * dtc
    # pass 1: (x w)^T B, the scaled x split
    s_chunk = sum(torch.einsum("zctp,zctn->zcpn", part, bc) for part in products(xc * w[..., None]))
    # pass 2: the state entering each chunk, in order
    state = torch.zeros((bh, p, n))
    states_in = []
    for ci in range(nc):
        states_in.append(state)
        state = state * torch.exp(a_tot[:, ci])[:, None, None] + s_chunk[:, ci]
    states_in = torch.stack(states_in, dim=1)
    # pass 3: exp(a_cs) (C state_in^T), then att x, att and state_in split
    off = sum(torch.einsum("zcsn,zcpn->zcsp", cc, part) for part in products(states_in))
    y = torch.exp(a_cs)[..., None] * off
    cb = torch.einsum("zcsn,zctn->zcst", cc, bc)
    seg = a_cs[..., :, None] - a_cs[..., None, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    att = torch.where(tri, cb * torch.exp(torch.where(tri, seg, 0.0)) * dtc[:, :, None, :], 0.0)
    y = y + sum(torch.einsum("zcst,zctp->zcsp", part, xc) for part in products(att))
    return y.reshape(bh, s, p), state


def _bf16_inputs(bh, s, p, n, chunk, seed):
    r = np.random.default_rng(seed)

    def bf16(shape):
        return torch.from_numpy((r.normal(size=shape) * 0.5).astype(np.float32)).bfloat16().float()

    x, b, c = bf16((bh, s, p)), bf16((bh, s, n)), bf16((bh, s, n))
    dt = torch.from_numpy((np.logaddexp(r.normal(size=(bh, s)), 0) * 0.2).astype(np.float32))
    da = -dt * torch.from_numpy(np.exp(r.normal(size=(bh, s)) * 0.1).astype(np.float32))
    pad = (-s) % chunk          # ops.ssd_scan's identity steps
    padded = [torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (x, b, c)]
    padded += [torch.nn.functional.pad(t, (0, pad)) for t in (dt, da)]
    return (x, b, c, dt, da), padded


def _worst_excess(got, want, s):
    """max over elements of |got - want| / (atol + rtol |want|), y cut to S."""
    pairs = ((got[0][:, :s], want[0]), (got[1], want[1]))
    return max(float((g - w).abs().div(SSD_ATOL + SSD_RTOL * w.abs()).max()) for g, w in pairs)


@pytest.mark.parametrize("p,n", SWEEP_PN)
@pytest.mark.parametrize("chunk", SWEEP_CHUNK)
@pytest.mark.parametrize("s", SWEEP_S)
def test_split_numerics_stay_within_the_card_bound(s, chunk, p, n):
    raw, padded = _bf16_inputs(3, s, p, n, chunk, seed=s * 7 + chunk + p + n)
    want = ss.ssd_scan_ref(*raw)
    got = _emulated_kernel(*padded, chunk)
    assert _worst_excess(got, want, s) <= 1.0


def test_one_bf16_rounding_would_break_the_bound():
    """Without the low parts the emulation misses the bound at the models'
    (P, N) and chunk: the split is what the 1e-4 bound needs."""
    excess = []
    for p, n in SWEEP_PN[1:]:
        raw, padded = _bf16_inputs(3, 256, p, n, 128, seed=p + n)
        want = ss.ssd_scan_ref(*raw)
        assert _worst_excess(_emulated_kernel(*padded, 128), want, 256) <= 1.0
        excess.append(_worst_excess(_emulated_kernel(*padded, 128, parts=1), want, 256))
    assert min(excess) > 1.0


def _good(dtype=torch.float32, bsz=2, s=64, h=4, p=16, n=8, g=1):
    xs, bm, cm, dt, da = _views(bsz, s, h, p, n, g, seed=0)
    return [xs.to(dtype), bm.to(dtype), cm.to(dtype), dt, da]


@pytest.mark.parametrize("case", (
    "x last stride", "b last stride", "x stride not 16 bytes", "b pointer not 16 bytes",
    "ragged S", "chunk not a multiple of 16", "P not a multiple of 16", "N not a multiple of 8",
    "G neither 1 nor H", "dt dtype", "x and b dtypes", "bf16 head dim", "bf16 chunk",
    "shared memory", "dt shape",
))
def test_layout_check_rejects_what_the_kernel_cannot_take(case):
    chunk = 16
    args = _good()
    if case == "x last stride":
        args[0] = torch.zeros((2, 64, 16, 4)).transpose(2, 3)
    elif case == "b last stride":
        args[1] = torch.zeros((2, 64, 1, 16))[..., ::2]
    elif case == "x stride not 16 bytes":
        args[0] = torch.zeros((2, 64, 4 * 16 + 2))[..., :64].reshape(2, 64, 4, 16)
    elif case == "b pointer not 16 bytes":
        args[1] = torch.zeros((2, 64, 1, 12))[..., 2:10]
    elif case == "ragged S":
        chunk = 48
    elif case == "chunk not a multiple of 16":
        chunk = 8
    elif case == "P not a multiple of 16":
        args[0] = torch.zeros((2, 64, 4, 24))
    elif case == "N not a multiple of 8":
        args[1] = args[2] = torch.zeros((2, 64, 1, 12))
    elif case == "G neither 1 nor H":
        args[1] = args[2] = torch.zeros((2, 64, 2, 8))
    elif case == "dt dtype":
        args[3] = args[3].double()
    elif case == "x and b dtypes":
        args[0] = args[0].bfloat16()
    elif case == "bf16 head dim":
        args = _good(torch.bfloat16, p=128)
    elif case == "bf16 chunk":
        args, chunk = _good(torch.bfloat16, s=256), 256
    elif case == "shared memory":
        args, chunk = _good(s=128, p=128, n=128), 128
    elif case == "dt shape":
        args[4] = args[4][:, :, :2]
    before = ss.ssd_scan_cuda.launches
    with pytest.raises((ValueError, TypeError)):
        ss._check_layout(*args, chunk)
    ss._check_layout(*_good(), 16)                      # the unchanged case passes
    assert ss.ssd_scan_cuda.launches == before


def test_entries_reject_cpu_tensors_before_the_layout():
    """The kernel route's device check comes first; on CPU tensors the
    entries take the plain version instead."""
    args = _good()
    with pytest.raises(ValueError, match="CUDA"):
        ss._check_device(*args)
    rows = [_rows(args[0], 4), _rows(args[1], 4), _rows(args[2], 4), _per_head(args[3]),
            _per_head(args[4])]
    with pytest.raises(ValueError, match="CUDA"):
        ss._check(*(t.contiguous() for t in rows), 16)


@pytest.mark.parametrize("arch,dtype", (("zamba2-2.7b", torch.bfloat16),
                                        ("mamba2-130m", torch.bfloat16),
                                        ("zamba2-2.7b-reduced", torch.float32),
                                        ("mamba2-130m-reduced", torch.float32)))
def test_the_models_views_pass_the_layout_check(arch, dtype):
    """The views ``apply_mamba2`` hands the kernel (a chunk of the sequence,
    batch 2) pass its layout check, with B and C's head stride 0."""
    cfg = get(arch)
    d_in, nheads, conv_dim = ssm.dims(cfg)
    n, p, q = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
    xbc = torch.zeros((2, q, conv_dim), dtype=dtype)
    xs = xbc[..., :d_in].reshape(2, q, nheads, p)
    bm, cm = xbc[..., d_in:d_in + n].unsqueeze(2), xbc[..., d_in + n:].unsqueeze(2)
    dt = torch.zeros((2, q, nheads))
    ss._check_layout(xs, bm, cm, dt, dt, q)
    assert ss._strides(bm)[2] == 0 and ss._strides(xs) == [q * conv_dim, conv_dim, p]


@pytest.mark.parametrize("shape,want", (
    ((2, 32, 80, 1, torch.bfloat16), 8),      # zamba2-2.7b prefill: 10 groups of 8 heads
    ((2, 32, 24, 1, torch.bfloat16), 4),      # mamba2-130m prefill: 6 groups of 4
    ((2, 32, 80, 80, torch.bfloat16), 1),     # G = H: one head per CTA
    ((2, 32, 80, 1, torch.float32), 1),       # the scalar instance
    ((160, 32, 1, 1, torch.bfloat16), 1),     # the per-row interface
    ((1, 1, 7, 1, torch.bfloat16), 1),
))
def test_heads_per_cta(shape, want):
    assert ss.heads_per_cta(*shape, sms=132) == want
