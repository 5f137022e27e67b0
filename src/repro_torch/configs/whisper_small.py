"""Assigned architecture config (see registry for the literal spec)."""

from repro_torch.configs.registry import WHISPER_SMALL as CONFIG  # noqa: F401

CONFIG_REDUCED = CONFIG.reduced()
