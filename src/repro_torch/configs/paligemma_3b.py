"""Assigned architecture config (see registry for the literal spec)."""

from repro_torch.configs.registry import PALIGEMMA_3B as CONFIG  # noqa: F401

CONFIG_REDUCED = CONFIG.reduced()
