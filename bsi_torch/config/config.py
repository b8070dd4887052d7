"""Lightweight Hydra-style config system.

Counterpart of ``bsi_tpu/config/config.py``, with its composition engine
over the same ``configs/`` tree:

- config groups: ``configs/<group>/<option>.yaml`` selected by a ``defaults``
  list or by CLI ``group=option`` / ``group.subgroup=option``;
- nested groups (a group file's own ``defaults`` select sub-groups, merged
  into its subtree);
- experiment overlays merged at the root (``# @package _global_`` semantics)
  whose ``defaults: - override /g: opt`` entries re-select earlier groups
  *before* composition (so replaced options leave no stale keys);
- CLI value overrides ``a.b.c=value`` (YAML-parsed) and additions ``+a.b=v``;
- interpolation ``${a.b.c}``, relative ``${..sibling}``, and
  ``${eval:'<python arithmetic>'}``.

The files are read by :mod:`.yaml_subset`, not PyYAML.
"""

from __future__ import annotations

import ast
import copy
import re
from pathlib import Path
from typing import Any, Iterable

from .yaml_subset import YamlError, load

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class ConfigError(ValueError):
    pass


def _yaml_load(text: str):
    try:
        return load(text)
    except YamlError as e:
        raise ConfigError(str(e)) from e


def _read_yaml(path: Path) -> dict:
    data = _yaml_load(path.read_text())
    return data or {}


def _is_global_package(path: Path) -> bool:
    head = path.read_text().lstrip().splitlines()[:1]
    return bool(head) and "@package _global_" in head[0]


def deep_merge(base: dict, overlay: dict) -> dict:
    """Merge ``overlay`` into ``base`` recursively (overlay wins)."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _nest(body: dict, package: str) -> dict:
    if not package:
        return body
    for part in reversed(package.split(".")):
        body = {part: body}
    return body


def _set_path(cfg: dict, dotted: str, value: Any, *, allow_new: bool) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            if not allow_new and k not in node:
                raise ConfigError(f"Override path {dotted!r}: unknown key {k!r}")
            node[k] = node.get(k) if isinstance(node.get(k), dict) else {}
        node = node[k]
    if not allow_new and keys[-1] not in node:
        raise ConfigError(
            f"Override path {dotted!r} does not exist (prefix with + to add new keys)"
        )
    node[keys[-1]] = value


def _get_path(cfg: dict, dotted: str) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        if not isinstance(node, dict) or k not in node:
            raise ConfigError(f"Interpolation path {dotted!r} not found")
        node = node[k]
    return node


class ConfigLoader:
    def __init__(self, config_dir: str | Path):
        self.config_dir = Path(config_dir)

    def load(self, name: str = "train", overrides: Iterable[str] = ()) -> dict:
        """Compose the config ``name`` with CLI-style overrides, resolved."""
        group_choices: dict[str, str | None] = {}
        value_overrides: list[tuple[str, Any, bool]] = []
        for ov in overrides:
            if "=" not in ov:
                raise ConfigError(f"Override {ov!r} must be key=value")
            key, _, raw = ov.partition("=")
            allow_new = key.startswith("+")
            key = key.lstrip("+")
            value = _yaml_load(raw) if raw != "" else None
            if not allow_new and self._is_group(key):
                group_choices[key.replace(".", "/")] = value
            else:
                value_overrides.append((key, value, allow_new))

        # Pre-scan: let the chosen experiment re-select groups (CLI wins)
        self._collect_experiment_overrides(name, group_choices)

        cfg = self._compose_file(name, package="", choices=group_choices)
        for key, value, allow_new in value_overrides:
            _set_path(cfg, key, value, allow_new=allow_new)
        return resolve_interpolations(cfg)

    # ------------------------------------------------------------- internals

    def _is_group(self, dotted: str) -> bool:
        return (self.config_dir / dotted.replace(".", "/")).is_dir()

    def _group_file(self, group: str, option: str) -> Path:
        path = self.config_dir / group / f"{option}.yaml"
        if not path.exists():
            gdir = self.config_dir / group
            available = sorted(p.stem for p in gdir.glob("*.yaml")) if gdir.is_dir() else []
            raise ConfigError(
                f"Unknown option {option!r} for group {group!r}; available: {available}"
            )
        return path

    def _collect_experiment_overrides(
        self, root_name: str, choices: dict[str, str | None]
    ) -> None:
        root = _read_yaml(self.config_dir / f"{root_name}.yaml")
        default_exp = None
        for entry in root.get("defaults", []):
            if isinstance(entry, dict) and "experiment" in entry:
                default_exp = entry["experiment"]
        exp = choices.get("experiment", default_exp)
        if exp is None:
            return
        exp_raw = _read_yaml(self._group_file("experiment", str(exp)))
        for entry in exp_raw.get("defaults", []):
            if not isinstance(entry, dict):
                continue
            (key, option), = entry.items()
            if key.startswith("override "):
                group = key.removeprefix("override ").strip().lstrip("/")
                choices.setdefault(group, option)

    def _compose_file(
        self, name: str, *, package: str, choices: dict[str, str | None]
    ) -> dict:
        """Compose one YAML file into a globally rooted config dict.

        ``package`` is the dot-path where this file's body lands ("" for the
        root file and for ``@package _global_`` files).
        """
        path = self.config_dir / f"{name}.yaml"
        if not path.exists():
            raise ConfigError(f"Config file {path} not found")
        if _is_global_package(path):
            package = ""
        raw = _read_yaml(path)
        defaults = raw.pop("defaults", [])
        body = _nest(raw, package)
        parent_dir = str(Path(name).parent)

        cfg: dict = {}
        self_done = False
        for entry in defaults:
            if entry == "_self_":
                cfg = deep_merge(cfg, body)
                self_done = True
                continue
            if not isinstance(entry, dict) or len(entry) != 1:
                raise ConfigError(f"Malformed defaults entry {entry!r} in {path}")
            (key, option), = entry.items()
            if key.startswith("override "):
                continue  # choice-only entries, consumed in the pre-scan
            if key.startswith("/"):
                group = key[1:]
                sub_package = group.replace("/", ".")
            else:
                group = key if parent_dir == "." else f"{parent_dir}/{key}"
                sub_package = (
                    f"{package}.{key.replace('/', '.')}" if package else group.replace("/", ".")
                )
            chosen = choices.get(group, option)
            if chosen is None:
                continue
            sub = self._compose_file(
                f"{group}/{chosen}", package=sub_package, choices=choices
            )
            cfg = deep_merge(cfg, sub)

        if not self_done:
            cfg = deep_merge(cfg, body)
        return cfg


# ------------------------------------------------------------- interpolation


def resolve_interpolations(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)

    def resolve_value(value: Any, path: list[str]) -> Any:
        if isinstance(value, str):
            return resolve_str(value, path)
        if isinstance(value, dict):
            return {k: resolve_value(v, path + [k]) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve_value(v, path) for v in value]
        return value

    def resolve_str(s: str, path: list[str]) -> Any:
        # Innermost-first substitution; a string that becomes a single
        # interpolation returns the referenced value with its type intact.
        while True:
            full = _INTERP_RE.fullmatch(s.strip())
            if full:
                return resolve_ref(full.group(1), path)
            m = _INTERP_RE.search(s)
            if not m:
                return s
            s = s[: m.start()] + str(resolve_ref(m.group(1), path)) + s[m.end() :]

    def resolve_ref(ref: str, path: list[str]) -> Any:
        ref = ref.strip()
        if ref.startswith("eval:"):
            expr = ref[len("eval:") :].strip()
            if (expr.startswith("'") and expr.endswith("'")) or (
                expr.startswith('"') and expr.endswith('"')
            ):
                expr = expr[1:-1]
            expr = str(resolve_str(expr, path))
            return _safe_eval(expr)
        # relative refs: '.x' = sibling, '..x' = parent's sibling, ...
        if ref.startswith("."):
            up = len(ref) - len(ref.lstrip("."))
            if up > len(path):
                raise ConfigError(f"Relative interpolation {ref!r} escapes the config root")
            base = path[: len(path) - up]
            rest = ref.lstrip(".")
            target = ".".join(base + [rest]) if rest else ".".join(base)
        else:
            target = ref
        value = _get_path(cfg, target)
        # path convention: includes the key whose value is being resolved
        return resolve_value(value, target.split("."))

    return resolve_value(cfg, [])


_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.Add, ast.Sub,
    ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow, ast.USub, ast.UAdd,
)


def _safe_eval(expr: str) -> Any:
    """Arithmetic-only eval, as the JAX package's."""
    tree = ast.parse(expr, mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ConfigError(f"eval resolver only supports arithmetic, got {expr!r}")
    return eval(compile(tree, "<config-eval>", "eval"))
