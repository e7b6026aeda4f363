from .base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeConfig, shape_applicable,
)
from .registry import ARCH_IDS, all_cells, get_config  # noqa: F401
