"""Object instantiation from config dicts.

Counterpart of ``bsi_tpu/config/instantiate.py``: a dict with ``_target_:
dotted.path.Class`` becomes ``Class(**kwargs)``; nested dicts with
``_target_`` are instantiated first unless ``_recursive_: false``; ``name``
keys are display metadata and are not passed to constructors.

``configs/`` names the JAX package's classes (``_target_`` paths inside the
``bsi_tpu`` package). Such a target is read as the same path inside
``bsi_torch`` at call time, so one config tree serves both packages.
"""

from __future__ import annotations

import importlib
from typing import Any

_META_KEYS = {"_target_", "_recursive_", "name"}
JAX_PACKAGE, PORT_PACKAGE = "bsi_tpu", "bsi_torch"


def port_target(dotted: str) -> str:
    """The port's path for a ``_target_`` inside the JAX package: the same
    path inside ``bsi_torch``; any other path is returned as it is."""
    package, _, inner = dotted.partition(".")
    if package != JAX_PACKAGE:
        return dotted
    return f"{PORT_PACKAGE}.{inner}"


def locate(dotted: str) -> Any:
    module_name, _, attr = port_target(dotted).rpartition(".")
    if not module_name:
        raise ValueError(f"_target_ {dotted!r} must be a dotted path")
    module = importlib.import_module(module_name)
    try:
        return getattr(module, attr)
    except AttributeError as e:
        raise ValueError(f"{attr!r} not found in module {module_name!r}") from e


def instantiate(cfg: Any, /, **extra: Any) -> Any:
    """Build the object described by ``cfg`` (pass-through if no ``_target_``)."""
    if not isinstance(cfg, dict) or "_target_" not in cfg:
        return cfg
    target = locate(cfg["_target_"])
    recursive = cfg.get("_recursive_", True)
    kwargs = {}
    for k, v in cfg.items():
        if k in _META_KEYS:
            continue
        if recursive and isinstance(v, dict) and "_target_" in v:
            v = instantiate(v)
        kwargs[k] = v
    kwargs.update(extra)
    return target(**kwargs)
