"""Run and architecture configuration: copies of the reference's
``FLConfig``, ``ModelConfig`` and ``InputShape``, the registry of its ten
architectures (one ``configs/<arch>.py`` shim each) and its four input
shapes."""

from repro_torch.configs.base import FLConfig, InputShape, ModelConfig  # noqa: F401
from repro_torch.configs.registry import ARCHS, get  # noqa: F401
from repro_torch.configs.shapes import SHAPES  # noqa: F401
