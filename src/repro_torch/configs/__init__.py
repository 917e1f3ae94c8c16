from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                      get_config, list_configs, register)

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "list_configs", "register"]
