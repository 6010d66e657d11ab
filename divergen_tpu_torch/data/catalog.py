"""Dataset + metadata catalogs (a copy of ``divergen_tpu/data/catalog.py``).

Counterpart of detectron2 ``data/catalog.py`` (``DatasetCatalog``,
``MetadataCatalog``): a name→loader registry and a name→attribute bag, the
glue every dataset registration and ``cfg.DATASETS.TRAIN/TEST`` lookup uses.
"""
from __future__ import annotations

import types
from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]) -> None:
        if name in self._registry:
            raise KeyError(f"dataset {name} already registered")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        return self._registry[name]()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        self._registry.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class _Metadata(types.SimpleNamespace):
    name: str = "N/A"

    def set(self, **kwargs) -> "_Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self


class _MetadataCatalog:
    def __init__(self):
        self._store: Dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        if name not in self._store:
            self._store[name] = _Metadata(name=name)
        return self._store[name]

    def list(self) -> List[str]:
        return sorted(self._store)

    def remove(self, name: str) -> None:
        self._store.pop(name, None)


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
