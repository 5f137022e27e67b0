"""Fake-tensor input stand-ins for every (arch x input-shape) pair — the port
of ``repro/launch/specs.py``.

The reference builds ``jax.ShapeDtypeStruct``s; the port builds tensors of
one shared ``FakeTensorMode`` (:func:`stand_in_mode`): they carry shape,
dtype and device and allocate nothing, also on a ``cuda`` device without a
card.  :func:`params_spec` runs ``model.init`` under the mode, the
counterpart of ``jax.eval_shape(model.init, key)``: llama4-maverick's 777 B
parameters cost no memory.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import FLConfig, InputShape, ModelConfig

_MODE: list = []


def stand_in_mode() -> FakeTensorMode:
    """The one ``FakeTensorMode`` every stand-in and every dry-run step of
    this process lives in (tensors of two fake modes do not mix)."""
    if not _MODE:
        _MODE.append(FakeTensorMode(allow_non_fake_inputs=True))
    return _MODE[0]


def _sds(shape, dtype, device):
    with stand_in_mode():
        return torch.empty(shape, dtype=dtype, device=device)


def fl_config_for(cfg: ModelConfig, shape: InputShape, n_clients: int = 32) -> FLConfig:
    return FLConfig(
        n_clients=n_clients,
        expected_clients=6,
        sampler="aocs",
        local_steps=1,
        algorithm="fedavg",
    )


def train_inputs(cfg: ModelConfig, shape: InputShape, fl: FLConfig, device="cuda"):
    """Batch tree for one FL round: leaves (n_clients, R, b, ...)."""
    n, r = fl.n_clients, fl.local_steps
    assert shape.global_batch % n == 0, (shape.global_batch, n)
    b = shape.global_batch // n
    s = shape.seq_len
    dt = getattr(torch, cfg.dtype)
    batch = {
        "tokens": _sds((n, r, b, s), torch.int32, device),
        "targets": _sds((n, r, b, s), torch.int32, device),
    }
    if cfg.encoder_seq:
        batch["frames"] = _sds((n, r, b, cfg.encoder_seq, cfg.d_model), dt, device)
    if cfg.prefix_tokens:
        batch["patches"] = _sds((n, r, b, cfg.prefix_tokens, cfg.d_model), dt, device)
    return batch


def prefill_inputs(cfg: ModelConfig, shape: InputShape, device="cuda"):
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    batch = {"tokens": _sds((b, s), torch.int32, device)}
    if cfg.encoder_seq:
        batch["frames"] = _sds((b, cfg.encoder_seq, cfg.d_model), dt, device)
    if cfg.prefix_tokens:
        batch["patches"] = _sds((b, cfg.prefix_tokens, cfg.d_model), dt, device)
    return batch


def decode_inputs(cfg: ModelConfig, shape: InputShape, model, device="cuda"):
    """(tokens, cache, pos) stand-ins; the cache through the model's own
    ``init_cache``.  ``pos`` is a Python int, the last slot of the context
    (the port's ``decode_step`` takes the position as a static argument,
    where the reference traces an int32 scalar)."""
    b, s = shape.global_batch, shape.seq_len
    tokens = _sds((b, 1), torch.int32, device)
    with stand_in_mode():
        cache = model.init_cache(b, s, device)
    return tokens, cache, s - 1


def params_spec(model, device="cuda"):
    with stand_in_mode():
        return model.init(torch.Generator(), torch.device(device))
