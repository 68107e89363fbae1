"""String -> constructor registry (the port's own copy of
``point_dae_tpu/utils/registry.py``, which the port never imports).

Model and dataset classes register under a name and are built from config
dicts whose ``NAME`` key selects the constructor (reference
``models/build.py``, ``datasets/build.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._modules: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def __iter__(self):
        return iter(self._modules.items())

    def keys(self):
        return self._modules.keys()

    def get(self, key: str) -> Callable:
        if key not in self._modules:
            raise KeyError(
                f"{key!r} is not registered in registry {self._name!r}. "
                f"Available: {sorted(self._modules)}"
            )
        return self._modules[key]

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None):
        """Use as ``@REG.register_module()`` or ``REG.register_module(module=fn)``."""
        if module is not None:
            self._register(name or module.__name__, module)
            return module

        def _decorator(mod):
            self._register(name or mod.__name__, mod)
            return mod

        return _decorator

    def _register(self, name: str, module: Callable):
        if name in self._modules:
            raise KeyError(f"{name!r} already registered in {self._name!r}")
        self._modules[name] = module

    def build(self, cfg: Any, **kwargs):
        """Build from a config object with a ``NAME`` attribute/key."""
        if hasattr(cfg, "NAME"):
            name = cfg.NAME
        else:
            name = cfg["NAME"]
        return self.get(name)(cfg, **kwargs)


MODELS = Registry("models")
DATASETS = Registry("datasets")
