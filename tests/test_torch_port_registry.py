"""The port's meta-architecture registry (``aldi_tpu_torch/models/__init__.py``
``META_ARCH_REGISTRY``, ``aldi_tpu_torch/utils/registry.py``) against the
JAX package's: the same registered names, a user's meta-architecture built
by ``build_detector``, and the registry's ``KeyError``s with the JAX
package's messages."""

import pytest

from aldi_tpu.models import META_ARCH_REGISTRY as JAX_REGISTRY
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.utils.registry import Registry as JaxRegistry
from aldi_tpu_torch.models import META_ARCH_REGISTRY, build_detector
from aldi_tpu_torch.utils.registry import Registry
from tests.torch_port_common import tiny_cfgs
from tests.torch_port_threads import capped_torch_threads  # noqa: F401


def test_registered_names_match_jax():
    assert sorted(META_ARCH_REGISTRY.keys()) == sorted(JAX_REGISTRY.keys())
    print(f"registered: {sorted(META_ARCH_REGISTRY.keys())}")


def test_user_meta_architecture_is_built(monkeypatch):
    """A class registered by the user (decorator form) is what
    ``build_detector`` returns for its MODEL.META_ARCHITECTURE, called
    with the config, the device and the seed."""
    monkeypatch.setattr(META_ARCH_REGISTRY, "_map",
                        dict(META_ARCH_REGISTRY._map))

    @META_ARCH_REGISTRY.register()
    class UserDetector:
        def __init__(self, cfg, device, seed):
            self.cfg, self.device, self.seed = cfg, device, seed

    _, cfg = tiny_cfgs()
    cfg.MODEL.META_ARCHITECTURE = "UserDetector"
    det = build_detector(cfg, device="cpu", seed=7)
    assert isinstance(det, UserDetector)
    assert (det.cfg, det.device, det.seed) == (cfg, "cpu", 7)


def test_unknown_meta_architecture_raises_as_jax():
    jcfg, cfg = tiny_cfgs()
    for c in (jcfg, cfg):
        c.MODEL.META_ARCHITECTURE = "NoSuchArch"
    with pytest.raises(KeyError) as want:
        jax_build_detector(jcfg)
    with pytest.raises(KeyError) as got:
        build_detector(cfg, device="cpu")
    print(f"port: {got.value}; JAX: {want.value}")
    assert str(got.value) == str(want.value)
    assert "NoSuchArch not found in registry META_ARCH" in str(got.value)


@pytest.mark.parametrize("registry_cls", [Registry, JaxRegistry],
                         ids=["port", "jax"])
def test_registry_rules(registry_cls):
    """Both copies: the call and decorator forms, a duplicate name and an
    unknown one raise ``KeyError``."""
    reg = registry_cls("TEST")
    reg.register(dict, name="d")

    @reg.register(name="f")
    def f():
        return 1

    assert reg.get("d") is dict and reg.get("f") is f and "f" in reg
    assert sorted(reg.keys()) == ["d", "f"]
    with pytest.raises(KeyError, match="already registered in TEST"):
        reg.register(list, name="d")
    with pytest.raises(KeyError, match="available: \\['d', 'f'\\]"):
        reg.get("g")
