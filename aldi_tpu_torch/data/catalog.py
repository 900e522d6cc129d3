"""Dataset and metadata catalogs.

A copy of ``aldi_tpu/data/catalog.py``: a name -> loader-function registry
plus per-dataset metadata (class names, COCO json path) used by the
evaluator. The port keeps its own registry: a dataset registered in the JAX
package is not seen here, nor the other way round.
"""

from typing import Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._map: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, fn: Callable[[], List[dict]]):
        if name in self._map:
            raise KeyError(f"dataset {name} already registered")
        self._map[name] = fn

    def get(self, name: str) -> List[dict]:
        if name not in self._map:
            raise KeyError(
                f"dataset {name} not registered; known: {sorted(self._map)}"
            )
        return self._map[name]()

    def __contains__(self, name):
        return name in self._map

    def list(self):
        return sorted(self._map)


class _MetadataCatalog:
    def __init__(self):
        self._map: Dict[str, dict] = {}

    def get(self, name: str) -> dict:
        return self._map.setdefault(name, {"name": name})


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()


def register_coco_instances(name: str, metadata: dict, json_file: str,
                            image_root: str):
    """Reference-compatible registration of a COCO-format dataset."""
    from .coco import load_coco_json

    DatasetCatalog.register(
        name, lambda: load_coco_json(json_file, image_root, name)
    )
    md = MetadataCatalog.get(name)
    md.update(metadata)
    md["json_file"] = json_file
    md["image_root"] = image_root
