"""Assigned architecture config (see registry for the literal spec)."""

from repro_torch.configs.registry import GRANITE_20B as CONFIG  # noqa: F401

CONFIG_REDUCED = CONFIG.reduced()
