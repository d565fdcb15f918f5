from .base import ModelConfig, ShapeConfig, SHAPES  # noqa: F401
from .registry import get_config, list_archs, smoke_config  # noqa: F401
