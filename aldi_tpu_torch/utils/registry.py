"""Name -> object registry: the port's copy of
``aldi_tpu/utils/registry.py`` (detectron2's ``Registry`` as the reference
consumes it at ``aldi/model.py:5``)."""

from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map: Dict[str, Any] = {}

    def register(self, obj: Optional[Any] = None, name: Optional[str] = None):
        if obj is None:  # decorator usage
            def deco(fn_or_cls):
                self._do_register(name or fn_or_cls.__name__, fn_or_cls)
                return fn_or_cls

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._map:
            raise KeyError(f"{name} already registered in {self._name}")
        self._map[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._map:
            raise KeyError(
                f"{name} not found in registry {self._name}; "
                f"available: {sorted(self._map)}"
            )
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def keys(self):
        return self._map.keys()
