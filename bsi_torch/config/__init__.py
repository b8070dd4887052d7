from .config import ConfigError, ConfigLoader, deep_merge, resolve_interpolations
from .instantiate import instantiate, locate, port_target

__all__ = [
    "ConfigLoader",
    "ConfigError",
    "deep_merge",
    "resolve_interpolations",
    "instantiate",
    "locate",
    "port_target",
]
