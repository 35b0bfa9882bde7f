from .base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_configs,
    get_config,
    input_specs,
    shape_applicable,
    smoke_config,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "all_configs",
    "get_config",
    "input_specs",
    "shape_applicable",
    "smoke_config",
]
