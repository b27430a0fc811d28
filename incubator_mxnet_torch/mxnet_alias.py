"""The name `mxnet` for the port: `install()` makes `import mxnet as mx`
give this package, so the stock scripts in `example/` run unchanged.

Every submodule of the package is imported eagerly and put in
`sys.modules` under the `mxnet.` prefix, so `mxnet.foo.bar` and
`incubator_mxnet_torch.foo.bar` are always the same module object (a
lazier scheme, a meta-path finder handing the real module to the import
machinery, lets the machinery make duplicate module objects with
duplicate class identities; the JAX package's `mxnet/__init__.py` says
the same).  The top-level `mxnet` is a module of its own that re-exports
the package's names and adds `tpu()`, the CUDA card (`gpu`), and
`num_tpus()` (`num_gpus`): scripts written for the TPU pick the card
through the alias, while the package itself has no `tpu`.
"""
from __future__ import annotations

import importlib
import pkgutil
import sys
import types
import warnings

__all__ = ["install"]

_SKIP = ("incubator_mxnet_torch.run",)


def _import_all(impl):
    for _finder, name, _ispkg in pkgutil.walk_packages(
            impl.__path__, impl.__name__ + ".", onerror=lambda _n: None):
        if name in _SKIP:
            continue
        try:
            importlib.import_module(name)
        except ImportError:
            pass                    # a missing optional dependency
        except Exception as e:      # noqa: BLE001 — one broken leaf must
            # not take down `import mxnet`, nor vanish silently
            warnings.warn(f"mxnet: skipping submodule {name}: "
                          f"{type(e).__name__}: {e}")


def install():
    """Put the package under `mxnet` in `sys.modules` (with every
    submodule as `mxnet.<name>`) and return the `mxnet` module; a second
    call returns the same one."""
    import incubator_mxnet_torch as impl
    have = sys.modules.get("mxnet")
    if getattr(have, "__alias_of__", None) == impl.__name__:
        return have
    _import_all(impl)
    alias = types.ModuleType("mxnet", impl.__doc__)
    for k in dir(impl):
        if not k.startswith("__"):
            setattr(alias, k, getattr(impl, k))
    alias.__version__ = impl.__version__
    alias.__path__ = []             # a package: `mxnet.x` is looked up
    alias.__alias_of__ = impl.__name__
    alias.tpu = impl.gpu
    alias.num_tpus = impl.num_gpus
    sys.modules["mxnet"] = alias
    prefix = impl.__name__
    for name, mod in list(sys.modules.items()):
        if name.startswith(prefix + "."):
            sys.modules["mxnet" + name[len(prefix):]] = mod
            top = name[len(prefix) + 1:].split(".")[0]
            if not hasattr(alias, top) and f"{prefix}.{top}" in sys.modules:
                setattr(alias, top, sys.modules[f"{prefix}.{top}"])
    return alias
