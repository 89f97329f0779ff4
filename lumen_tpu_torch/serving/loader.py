"""Dotted-path -> object resolution for dynamic service loading.

Same role as the reference ``src/lumen/loader.py:9-45``. The port's copy
of ``lumen_tpu/serving/loader.py`` with one addition: a ``registry_class``
under the JAX package (``lumen_tpu.<path>``) resolves to the same path
under this package (``lumen_tpu_torch.<path>``), so one deployment YAML
boots either server. A service the port does not have yet fails its load
with a "not ported yet" error (the server then boots it degraded); the
JAX package itself is never imported.
"""

from __future__ import annotations

import importlib
import importlib.util
from typing import Any

#: the JAX package's root, whose paths map onto this package's
JAX_PACKAGE = "lumen_tpu"
PORT_PACKAGE = __name__.split(".")[0]


class ServiceLoadError(Exception):
    pass


def port_path(dotted_path: str) -> str:
    """``lumen_tpu.a.b`` -> ``lumen_tpu_torch.a.b``; other paths as they are."""
    root, dot, rest = dotted_path.partition(".")
    return f"{PORT_PACKAGE}.{rest}" if root == JAX_PACKAGE and dot else dotted_path


def _module_exists(module_path: str) -> bool:
    try:
        return importlib.util.find_spec(module_path) is not None
    except ImportError:  # a parent package is missing
        return False


def resolve(dotted_path: str) -> Any:
    """Resolve ``pkg.module.Attr`` to the attribute object."""
    mapped = port_path(dotted_path)
    module_path, _, attr = mapped.rpartition(".")
    if not module_path:
        raise ServiceLoadError(f"not a dotted path: {dotted_path!r}")
    if mapped != dotted_path and not _module_exists(module_path):
        raise ServiceLoadError(
            f"{dotted_path!r} is not ported to {PORT_PACKAGE} yet "
            f"(no module {module_path!r})"
        )
    try:
        module = importlib.import_module(module_path)
    except ImportError as e:
        raise ServiceLoadError(f"cannot import module {module_path!r}: {e}") from e
    try:
        return getattr(module, attr)
    except AttributeError as e:
        raise ServiceLoadError(
            f"module {module_path!r} has no attribute {attr!r}"
        ) from e
