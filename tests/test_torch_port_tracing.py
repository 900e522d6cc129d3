"""The port's profiler ranges (``aldi_tpu_torch/utils/tracing.py``) on the
CPU: off without a profiler, where they belong under one, absent from an
exported program, and without effect on any output bit; and
``tools/sync_sites.py``, whose run on the card (``-m cuda``) reports no
host read of a device value outside an ``aldi/sync/*`` range.

Imports nothing of JAX: on the card run
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_tracing.py``.
"""

import warnings

import numpy as np
import pytest
import torch

from aldi_tpu_torch.config import get_cfg
from aldi_tpu_torch.engine.export import export_inference, make_serving_fn
from aldi_tpu_torch.engine.train_step import (create_train_state, draw_step,
                                              make_train_step)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.tools import sync_sites
from aldi_tpu_torch.utils import tracing
from torch_port_threads import capped_torch_threads  # noqa: F401

FLAGSHIP = "configs/cityscapes/ALDI-Best-Cityscapes.yaml"
SERVE_STAGES = ["aldi/serve/trunk", "aldi/serve/rpn", "aldi/serve/box_head",
                "aldi/serve/detections"]
# the flagship step's stages, as ``mark`` has always been called with them
STEP_STAGES = ["ema update", "teacher (pseudo-labels, distill targets)",
               "strong views", "strong stream fwd+bwd",
               "distill stream fwd+bwd", "optimizer"]


def tiny_cfg():
    """The flagship recipe at ResNet depth 26 on a 128 px canvas, float32."""
    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.RESNETS.DEPTH = 26
    cfg.TPU.CANVAS = (128, 128)
    cfg.TPU.MAX_GT = 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    rpn = cfg.MODEL.RPN
    rpn.PRE_NMS_TOPK_TRAIN, rpn.POST_NMS_TOPK_TRAIN = 64, 32
    rpn.PRE_NMS_TOPK_TEST, rpn.POST_NMS_TOPK_TEST = 64, 32
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD = 0.5
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    return cfg


def request(seed=0, b=2):
    gen = torch.Generator().manual_seed(seed)
    images = torch.rand((b, 128, 128, 3), generator=gen) * 255.0
    sizes = torch.tensor([[128, 128], [100, 120]], dtype=torch.int32)[:b]
    return images, sizes


def batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, 8, 4), np.float32)
    x0 = rng.uniform(0, 80, (b, 4, 2))
    boxes[:, :4, :2] = x0
    boxes[:, :4, 2:] = x0 + rng.uniform(12, 48, (b, 4, 2))
    valid = np.zeros((b, 8), bool)
    valid[:, :4] = True
    sizes = np.array([[128, 128], [112, 120]], np.int32)[:b]
    t = torch.from_numpy
    return {"labeled": {
                "image": t(rng.uniform(0, 255, (b, 128, 128, 3))
                           .astype(np.float32)),
                "sizes": t(sizes), "boxes": t(boxes),
                "classes": t(rng.integers(0, 3, (b, 8)).astype(np.int32)),
                "valid": t(valid)},
            "unlabeled": {
                "image": t(rng.uniform(0, 255, (b, 128, 128, 3))
                           .astype(np.float32)),
                "sizes": t(sizes)}}


def profiled(fn):
    """(fn's result, the profiler's events) of one call under
    ``torch.profiler`` on the CPU."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return out, prof.events()


def aldi_events(events):
    return sorted((e for e in events if e.name.startswith("aldi/")),
                  key=lambda e: e.time_range.start)


def ancestors(e):
    names = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        names.append(e.name)
    return names


@pytest.fixture(scope="module")
def detector():
    det = build_detector(tiny_cfg(), device="cpu")
    det.module.load_state_dict(det.init_variables(seed=3))
    return det


def test_off_without_a_profiler():
    """No profiler: ``span`` and ``sync`` hand out the one shared no-op,
    which records nothing and lets exceptions through."""
    assert tracing.span("serve/trunk") is tracing.OFF
    assert tracing.sync("nms_exit") is tracing.OFF
    with tracing.span("a"), tracing.sync("b") as inner:
        assert inner is None
    with pytest.raises(KeyError):
        with tracing.span("a"):
            raise KeyError("passes through")
    _, events = profiled(lambda: None)
    assert not aldi_events(events)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.span("a") is not tracing.OFF
    assert tracing.span("a") is tracing.OFF


def test_serving_stages_and_nms_ranges(detector):
    """A request under the profiler: the four serving stages in order, once
    each; NMS's loop and its exit tests inside the RPN's and the
    detections' stages, every exit test inside an ``aldi/nms``; each of
    the two copies to the device in a range of its own
    (``aldi/sync/image_copy``, ``aldi/sync/sizes_copy``), before the
    stages; K2's level constant in the box head's stage."""
    fn = make_serving_fn(detector)
    images, sizes = request()
    _, events = profiled(lambda: fn(images, sizes))
    seen = aldi_events(events)
    stages = [e.name for e in seen if e.name.startswith("aldi/serve/")]
    assert stages == SERVE_STAGES
    nms = [e for e in seen if e.name == "aldi/nms"]
    assert {ancestors(e)[0] for e in nms} == {"aldi/serve/rpn",
                                             "aldi/serve/detections"}
    exits = [e for e in seen if e.name == "aldi/sync/nms_exit"]
    assert exits and all(ancestors(e)[0] == "aldi/nms" for e in exits)
    for stage in ("aldi/serve/rpn", "aldi/serve/detections"):
        assert any(stage in ancestors(e) for e in exits)
    copies = [e for e in seen if e.name.endswith("_copy")
              and not ancestors(e)]
    assert [e.name for e in copies] == ["aldi/sync/image_copy",
                                        "aldi/sync/sizes_copy"]
    levels = [e for e in seen if e.name == "aldi/sync/canonical_size_copy"]
    assert [ancestors(e)[-1] for e in levels] == ["aldi/serve/box_head"]
    assert {e.name for e in seen} == set(SERVE_STAGES) | {
        "aldi/nms", "aldi/sync/nms_exit", "aldi/sync/image_copy",
        "aldi/sync/sizes_copy", "aldi/sync/canonical_size_copy"}


def run_steps(cfg, traced, n=2):
    """``n`` flagship steps from the same weights, batches and draws: (the
    stages ``mark`` saw, per step; metrics; the student's parameters;
    the profiler's events of the last step, if ``traced``)."""
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det, det.init_variables(seed=3))
    step = make_train_step(cfg, det)
    gen = torch.Generator().manual_seed(7)
    marks, metrics, events = [], [], None
    for i in range(n):
        draws = draw_step(gen, det, 2, 2)
        seen = []
        call = (lambda: step(state, batch(i), draws, mark=seen.append))
        if traced and i == n - 1:
            (state, m), events = profiled(call)
        else:
            state, m = call()
        marks.append(seen)
        metrics.append({k: float(v) for k, v in m.items()})
    params = {k: v.detach().clone()
              for k, v in state.student.named_parameters()}
    return marks, metrics, params, events


@pytest.fixture(scope="module")
def steps():
    cfg = tiny_cfg()
    return run_steps(cfg, False), run_steps(cfg, True)


def test_step_stages_keep_their_marks(steps):
    """``mark`` sees the flagship's stage names in their order, and a
    traced step holds one ``aldi/step/<stage>`` range per stage, in the
    same order, none inside another."""
    _, (marks, _, _, events) = steps
    assert marks == [STEP_STAGES, STEP_STAGES]
    seen = [e for e in aldi_events(events) if e.name.startswith("aldi/step/")]
    assert [e.name for e in seen] == ["aldi/step/" + s for s in STEP_STAGES]
    assert all(not any(a.startswith("aldi/step/") for a in ancestors(e))
               for e in seen)
    teacher = "aldi/step/teacher (pseudo-labels, distill targets)"
    assert any(e.name == "aldi/nms" and teacher in ancestors(e)
               for e in aldi_events(events))


def test_spans_change_no_output_bit(detector, steps):
    """The same request and the same two steps with and without the
    profiler give the same bits."""
    fn = make_serving_fn(detector)
    images, sizes = request(seed=1)
    plain = fn(images, sizes)
    traced, _ = profiled(lambda: fn(images, sizes))
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
    (_, m0, p0, _), (_, m1, p1, _) = steps
    assert m0 == m1
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_export_under_a_profiler_holds_no_range(detector):
    """``export_inference`` run while the profiler records gives a program
    without profiler ops whose outputs equal the one exported without it."""
    plain = export_inference(detector, None, 2, platforms=("cpu",))["cpu"]
    traced, events = profiled(
        lambda: export_inference(detector, None, 2, platforms=("cpu",)))
    traced = traced["cpu"]
    assert not aldi_events(events)
    targets = [str(n.target) for n in traced.graph.nodes]
    assert not any("profiler" in t or "record_function" in t
                   for t in targets)
    assert targets == [str(n.target) for n in plain.graph.nodes]
    images, sizes = request(seed=2)
    with torch.no_grad():
        want = plain.module()(images, sizes)
        got = traced.module()(images, sizes)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_sync_sites_names_the_covering_range():
    """The tool's count on the CPU: a warning inside ``sync`` is counted
    with its range, one outside every range as unspanned, and a report
    with an unspanned site exits 1."""
    def fn():
        with tracing.span("serve/rpn"), tracing.sync("nms_exit"):
            warnings.warn("inside")
        warnings.warn("outside")

    counts = sync_sites.record(fn, torch.device("cpu"))
    assert sorted(name for _, name in counts) == ["aldi/sync/nms_exit",
                                                  "unspanned"]
    assert sync_sites.report(counts, "a test") == 1

    def spanned():
        with tracing.sync("image_copy"):
            warnings.warn("inside")

    inside = sync_sites.record(spanned, torch.device("cpu"))
    assert sync_sites.report(inside, "a test") == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("args", [[], ["--serve"]],
                         ids=["daod_step", "request"])
def test_sync_sites_on_card(card, args, capsys):
    """Every host synchronisation of a full-width R50-FPN step and request
    lies inside an ``aldi/sync/*`` range."""
    rc = sync_sites.main(args)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[aldi/sync/nms_exit]" in out
    if args:  # each of the request's two copies has a range of its own
        assert "[aldi/sync/image_copy]" in out
        assert "[aldi/sync/sizes_copy]" in out
