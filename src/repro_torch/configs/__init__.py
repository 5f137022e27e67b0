"""Run and architecture configuration: copies of the reference's
``FLConfig``, ``ModelConfig`` and the registry of its ten architectures."""

from repro_torch.configs.base import FLConfig, ModelConfig  # noqa: F401
from repro_torch.configs.registry import ARCHS, get  # noqa: F401
