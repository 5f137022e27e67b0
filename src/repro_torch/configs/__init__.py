"""Run configuration: a copy of the reference's ``FLConfig``."""

from repro_torch.configs.base import FLConfig  # noqa: F401
