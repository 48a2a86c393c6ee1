from .checkpoint import load_config, load_params

__all__ = ["load_config", "load_params"]
