"""Minimal functional optimizers over nested dicts of tensors, ported from
``repro/optim/optim.py`` (the paper uses vanilla SGD on both the clients and
the master; Adam is there for extensions).

``Optimizer(init, update)``: ``init(params) -> state`` and ``update(grads,
state, params) -> (new_params, state)``, the reference's functional form, so
``RoundEngine(server_opt=...)`` takes either package's shape of optimizer.
The arithmetic repeats the reference's op for op; Adam keeps its moments in
float32 and its step count ``t`` as an int32 tensor, and forms the bias
corrections ``1 - b ** t`` in float32 on the device, as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.kernels.ops import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (new_params, state)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """SGD, with heavy-ball momentum ``v <- momentum * v + g`` when
    ``momentum != 0`` (state: the velocity tree; else ``()``)."""

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        if momentum == 0.0:
            new = tree_map(lambda p, g: (p - lr * g.to(p.dtype)).to(p.dtype), params, grads)
            return new, state
        vel = tree_map(lambda v, g: momentum * v + g, state, grads)
        new = tree_map(lambda p, v: (p - lr * v.to(p.dtype)).to(p.dtype), params, vel)
        return new, vel

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam with bias correction; state ``{"m", "v", "t"}``."""

    def init(params):
        def zeros():
            return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)

        dev = tree_leaves(params)[0].device
        return {"m": zeros(), "v": zeros(), "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32), state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, tf), tf)
        bc2 = 1 - torch.pow(_f32(b2, tf), tf)
        new = tree_map(
            lambda p, m_, v_: (p - lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)).to(p.dtype),
            params, m, v,
        )
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device, made by a fill (no copy
    from host memory, so no stream sync)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)
