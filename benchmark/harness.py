"""What every cell shares: its files found by name, the configuration for
the program and for the reference, seeded weights, the device check, the
import guard and the result line.

A cell ``<cell>`` is ``workloads/<cell>.json`` (its configuration, traffic
kind, the traffic's parameters, the limits of its comparison and why it
exists); its configuration ``<config>`` is ``configs/<config>.json``; its
traffic kind ``<kind>`` is the driver ``traffic/<kind>.py``; each metric
``<metric>`` it reports is the reader ``metrics/<metric>.py``; the
operation counts of ``<config>`` are ``flops/<config>.py``. Which metrics a
cell reports is ``BENCHMARK.json``'s to say."""

import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aldi_tpu")
WEIGHT_GAINS = {"stem.conv1": 1 / 64, "body.conv1": 1 / 64,
                "anchor_deltas": 0.1, "bbox_pred": 0.1, "cls_score": 3.0}
INPUT_STREAM = 1 << 40  # the inputs' generator: seed + this, weights': seed


class Cell:
    """One entry of BENCHMARK.json's ``workloads``, with its files."""

    def __init__(self, name, root=ROOT, bench=BENCH):
        self.name = name
        self.root, self.bench = Path(root), Path(bench)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        entry = [w for w in self.spec["workloads"] if w["name"] == name]
        if not entry:
            raise SystemExit(f"benchmark: no cell {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        self.workload = json.loads(
            (self.bench / "workloads" / f"{name}.json").read_text())
        self.config_name = self.entry["config"]
        self.config = json.loads((self.bench / "configs"
                                  / f"{self.config_name}.json").read_text())
        self.kind = self.entry["traffic"]

    def metrics(self, trace: bool) -> list:
        """(name, unit) of the metrics this cell reports: with ``trace``
        the per-layer ones, else the end-to-end ones."""
        e2e = {m["name"]: m for m in self.spec["end_to_end"]}
        mine = [m for m in e2e.values()
                if self.name in m.get("workloads", [self.name])]
        if not trace:
            return [(m["name"], m["unit"]) for m in mine]
        names = {m["name"] for m in mine}
        return [(m["name"], m["unit"]) for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def driver(self):
        return load_file(self.bench / "traffic" / f"{self.kind}.py",
                         f"benchmark.traffic.{self.kind}")

    def reader(self, metric):
        return load_file(self.bench / "metrics" / f"{metric}.py",
                         f"benchmark.metrics.{metric.replace('.', '_')}")

    def flops(self):
        return load_file(self.bench / "flops" / f"{self.config_name}.py",
                         f"benchmark.flops.{self.config_name}")

    def overrides(self) -> dict:
        return dict(self.config.get("overrides", {}))

    def yaml(self) -> str:
        return str(self.root / self.config["yaml"])


def load_file(path, name):
    """The module of ``path`` under ``name`` (within the benchmark
    package, so relative imports work; a name may hold dots)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    module.__package__ = name.rsplit(".", 1)[0]
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def program_cfg(cell):
    """The port's configuration of the cell: its YAML and overrides."""
    from aldi_tpu_torch.config import get_cfg

    from .reference.runner import set_key

    cfg = get_cfg()
    cfg.merge_from_file(cell.yaml())
    for key, value in cell.overrides().items():
        set_key(cfg, key, value)
    return cfg


def conditioned_weights(shapes: dict, seed: int, device):
    """A float32 state dict for ``shapes`` ({name: shape}, detectron2's
    names) drawn from ``seed`` on ``device`` in two calls, then scaled leaf
    by leaf so that a random network behaves like a trained one where the
    paths care: kernels of std gain/sqrt(fan_in), FrozenBN statistics near
    the identity and a small scale on each bottleneck's last conv (the
    activations stay O(1) through every layer), small box deltas (the
    proposals and detections are varied boxes), spread class logits (the
    detections pass the score threshold and fill the top-100). The same
    arithmetic as ``chip_smoke.py``'s ``conditioned_weights``, drawn on the
    device."""
    import torch

    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        shape = tuple(shapes[name])
        nrm = normal[at:at + size].view(shape)
        uni = uniform[at:at + size].view(shape)
        at += size
        mod, leaf = name.rsplit(".", 1)
        if leaf == "weight" and len(shape) > 1:
            g = next((v for k, v in WEIGHT_GAINS.items() if mod.endswith(k)),
                     1.0)
            x = nrm * (g / math.sqrt(size // shape[0]))
        elif leaf == "weight" and mod.endswith(("conv3.norm", "bn3")):
            x = uni * 0.2 + 0.1
        elif leaf in ("weight", "running_var"):
            x = uni + 0.5
        else:
            x = nrm * 0.05
        out[name] = x.clone()
    return out


def shapes_of(module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def card():
    """(name, count) of the cards this process sees, and the power limit
    (the published peaks assume 700 W)."""
    import torch

    return torch.cuda.get_device_name(0), torch.cuda.device_count()


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name, compared whole,
    is JAX's, flax's, optax's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def quantile(values, q):
    """The ``q`` quantile of ``values`` (linear between order statistics,
    as ``statistics.quantiles(..., method="inclusive")``)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def set_caches(root=ROOT):
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's kernels build into ``build/torch_kernels`` there)."""
    cache = Path(root) / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
