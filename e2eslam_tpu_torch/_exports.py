"""Lazy re-exports: each subpackage's flat namespace (PEP 562).

A subpackage names its public functions and classes with the submodule
that defines each; the first access of a name imports that submodule.
So ``from e2eslam_tpu_torch.core import se3_exp`` works as the JAX
package's flat imports do, and importing a subpackage imports none of its
modules (no CUDA build, no JAX)."""

from __future__ import annotations

import importlib
from typing import Dict, Optional


def lazy(package: str, exports: Dict[str, Optional[str]]):
    """``(__all__, __getattr__)`` of ``package``: ``exports`` maps each
    name to its submodule (None: the name is the submodule itself)."""

    def __getattr__(name):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(f"{package}.{exports[name] or name}")
        return module if exports[name] is None else getattr(module, name)

    return sorted(exports), __getattr__
