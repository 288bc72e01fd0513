"""What the modules of a subpackage declare, found by walking its files.

A new model, env or graph builder of the reference is a new file: a module
of `models/` that sets `MODELS = {"name": cls}`, of `envs/` that sets
`TASKS = {"task": factory}`, of `graphs/` that sets `BUILDERS = {EnvClass:
make}`. The factories look them up here beside their built-in entries, and
`reference.REFERENCE_TYPES` takes every NamedTuple of every module. Files
are read in sorted order; a name declared twice is an error that names both
files.
"""

from __future__ import annotations

import importlib
import pkgutil
from typing import Dict, Optional


def _modules(package: str, recursive: bool = False):
    pkg = importlib.import_module(package)
    walk = pkgutil.walk_packages if recursive else pkgutil.iter_modules
    for info in sorted(walk(pkg.__path__, prefix=f"{package}."), key=lambda m: m.name):
        yield importlib.import_module(info.name)


def _add(out: Dict, where: Dict, key, value, origin: str, what: str) -> None:
    if key in where:
        raise ValueError(f"{what} {key!r} is declared twice: in {where[key]} and in {origin}")
    out[key], where[key] = value, origin


def declared(package: str, attr: str, built_in: Optional[Dict] = None, built_in_file: str = "") -> Dict:
    """`built_in` (the entries that `built_in_file` holds) and the entries
    of every dict `attr` that a module of `package` sets at its top level."""
    out: Dict = {}
    where: Dict = {}
    for key, value in (built_in or {}).items():
        _add(out, where, key, value, f"{built_in_file} (built in)", attr)
    for module in _modules(package):
        for key, value in (vars(module).get(attr) or {}).items():
            _add(out, where, key, value, module.__file__, attr)
    return out


def named_tuples(package: str) -> Dict[str, type]:
    """Every NamedTuple class defined in a module of `package` or of its
    subpackages, by class name."""
    out: Dict[str, type] = {}
    where: Dict[str, str] = {}
    for module in _modules(package, recursive=True):
        for cls in vars(module).values():
            if (isinstance(cls, type) and issubclass(cls, tuple) and hasattr(cls, "_fields")
                    and cls.__module__ == module.__name__):
                _add(out, where, cls.__name__, cls, module.__file__, "NamedTuple")
    return out
