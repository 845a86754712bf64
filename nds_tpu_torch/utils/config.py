"""Layered engine configuration.

Port copy of ``EngineConfig``, ``load_properties`` and the
``${ENV:-default}`` substitution of ``nds_tpu/utils/config.py``:
templates are plain ``key=value`` files, and the precedence is the
reference's: template < property file < explicit CLI overrides.

The engine keys the port reads:

  engine.backend    gpu (the default: the port's device engine) | cpu
                    (the CPU oracle). The reference's ``tpu`` and
                    ``distributed`` are refused (``power_core.make_session``);
                    the sharded placement comes with the scheduler
                    (ROADMAP Queue 1 item 4)
  engine.device     the torch device of the ``gpu`` backend: ``cuda`` (the
                    default, the card) or ``cpu`` (as the tests run it)
  engine.floats     true -> float64 arithmetic (the reference's --floats
                    mode); false -> scaled-int decimals
  engine.precision  f64 only (f32/bf16 are ROADMAP Queue 1 item 10)
  columnar.encode   off | auto | dict | bitpack | rle: the compressed
                    columnar store (``columnar.configure_from``)

The reference's other keys (mesh, retry, placement, prefetch, serving,
observability) are read by modules not yet ported; they may stand in a
template and are recorded in the summaries' ``engineConf``, unread.
"""

from __future__ import annotations

import os
import re

_ENV_RE = re.compile(r"\$\{(?P<name>[A-Za-z_][A-Za-z0-9_]*)(?::-(?P<default>[^}]*))?\}")


def _substitute_env(value: str, env: dict | None = None) -> str:
    env = env if env is not None else os.environ

    def repl(m):
        name, default = m.group("name"), m.group("default")
        if name in env:
            return env[name]
        if default is not None:
            return default
        raise KeyError(f"undefined environment variable ${{{name}}} in config")

    return _ENV_RE.sub(repl, value)


def load_properties(path: str, env: dict | None = None) -> dict:
    """Parse a k=v property/template file with comments and env substitution."""
    conf: dict[str, str] = {}
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(f"{path}:{lineno}: expected key=value, got {line!r}")
            key, _, value = line.partition("=")
            conf[key.strip()] = _substitute_env(value.strip(), env)
    return conf


DEFAULTS = {
    # the card: the port's entry points run there unless asked otherwise
    "engine.backend": "gpu",
    "engine.device": "cuda",
    "engine.floats": "false",
    "engine.precision": "f64",
}


class EngineConfig:
    """Merged view over defaults < template < property file < overrides."""

    def __init__(self, template_path: str | None = None,
                 property_path: str | None = None,
                 overrides: dict | None = None) -> None:
        conf = dict(DEFAULTS)
        self.sources = {"template": template_path, "property_file": property_path}
        for layer in (load_properties(template_path) if template_path
                      else {},
                      load_properties(property_path) if property_path
                      else {},
                      {k: str(v) for k, v in (overrides or {}).items()}):
            conf.update(layer)
        self.conf = conf

    def get(self, key: str, default=None):
        return self.conf.get(key, default)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.conf.get(key)
        if v is None:
            return default
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.conf.get(key)
        return default if v is None else int(v)

    def as_dict(self) -> dict:
        return dict(self.conf)
