"""CPU tests of the readers of the port's profiler ranges (``spans.py`` and
the metrics that use it) on a synthetic Chrome trace: two requests' ranges,
runtime calls and device work with known counts, gaps and busy times."""

import time

import pytest
import torch

from .. import harness, run, spans, trace

NEW_SERVE = ("nms_idle_ms.serve", "nms_rounds.serve", "host_syncs.serve",
             "sync_idle_ms.serve")
NEW_TRAIN = ("host_syncs.train", "sync_idle_ms.train")


def events(with_ranges=True):
    """A 10 ms window (us): device work A 100-1100, B 1200-2200, C
    3000-3500, a copy D 6000-7000, E 8000-9000, each launched 50-500 us
    before on thread 1, and F 9200-9400 launched on thread 2; the port's
    ranges on thread 1."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 0.0, "dur": 10000.0, "pid": 1, "tid": 1}]
    work = [("kernel", "A", 100, 1000, 1, 50, 1),
            ("kernel", "B", 1200, 1000, 2, 900, 1),
            ("kernel", "C", 3000, 500, 3, 2950, 1),
            ("gpu_memcpy", "Memcpy HtoD", 6000, 1000, 4, 5900, 1),
            ("kernel", "E", 8000, 1000, 5, 7500, 1),
            ("kernel", "F", 9200, 200, 6, 100, 2)]
    for cat, name, ts, dur, corr, launch, tid in work:
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": float(ts),
                   "dur": float(dur), "pid": 0, "tid": 7,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": float(launch),
                   "dur": 5.0, "pid": 1, "tid": tid,
                   "args": {"correlation": corr}})
    ranges = [("aldi/serve/trunk", 0, 1000), ("aldi/serve/rpn", 1000, 4000),
              ("aldi/nms", 2000, 2000), ("aldi/sync/nms_exit", 2100, 200),
              ("aldi/sync/nms_exit", 3400, 200),
              ("aldi/serve/detections", 5000, 3000),
              ("aldi/sync/image_copy", 5800, 300),
              ("aldi/sync/other", 6950, 150)]
    if with_ranges:
        ev += [{"ph": "X", "cat": "cpu_op", "name": name, "ts": float(ts),
                "dur": float(dur), "pid": 1, "tid": 1}
               for name, ts, dur in ranges]
    return ev


def record(red, units=2):
    return {"trace": red, "requests": units, "steps": units}


def read(cell, metric, rec):
    return harness.Cell(cell).reader(metric).read(rec)


def test_reduce_keeps_the_ranges_as_host_calls():
    red = trace.reduce(events())
    names = [name for _, _, name in red["host"]]
    assert names.count("aldi/sync/nms_exit") == 2
    assert spans.count(red, lambda n: n.startswith(spans.SYNC)) == 4
    # gaps: 0-100, 1100-1200, 2200-3000, 3500-6000, 7000-8000, 9000-9200,
    # 9400-10000
    assert spans.gaps(red)[2:4] == [(2200.0, 3000.0), (3500.0, 6000.0)]
    # 2200 opens in the first exit test, 3500 in the second; 7000 in
    # aldi/sync/other
    assert spans.idle_opening_in(red, lambda n: n == spans.NMS) == \
        pytest.approx(3300e-6)
    assert spans.idle_opening_in(
        red, lambda n: n.startswith(spans.SYNC)) == pytest.approx(4300e-6)


def test_readers_per_request_and_step():
    rec = record(trace.reduce(events()))
    assert read("r50fpn.serve", "nms_idle_ms.serve", rec) == \
        pytest.approx(1.65)
    assert read("r50fpn.serve", "nms_rounds.serve", rec) == \
        pytest.approx(1.0)
    assert read("r50fpn.serve", "host_syncs.serve", rec) == \
        pytest.approx(2.0)
    assert read("r50fpn.serve", "sync_idle_ms.serve", rec) == \
        pytest.approx(2.15)
    assert read("r50fpn.daod_step", "host_syncs.train", rec) == \
        pytest.approx(2.0)
    assert read("r50fpn.daod_step", "sync_idle_ms.train", rec) == \
        pytest.approx(2.15)


@pytest.mark.parametrize("case", ["no ranges", "no device", "untraced"])
def test_readers_read_nothing_without_ranges_or_device(case):
    """A program without the ranges (the parent's), a CPU run (no device
    interval) and an untraced run give None, and raise nothing."""
    if case == "untraced":
        rec = {"requests": 2, "steps": 2, "window_s": 1.0}
    else:
        ev = events(with_ranges=case != "no ranges")
        if case == "no device":
            ev = [e for e in ev if e["cat"] not in trace.DEVICE_CATS]
        rec = record(trace.reduce(ev))
    for name in NEW_SERVE:
        assert read("r50fpn.serve", name, rec) is None, name
    for name in NEW_TRAIN:
        assert read("r50fpn.daod_step", name, rec) is None, name


def test_span_busy_by_launch():
    """Each range's device work is what its thread launched inside it:
    the trunk A and B, the RPN and its NMS C, an exit test nothing, the
    detections D and E, the image copy's range D; F (thread 2) none."""
    out = spans.span_busy(events())
    assert [r[:3] for r in out] == sorted(r[:3] for r in out)
    busy = {name: b for _, _, name, b in out if name != "aldi/sync/nms_exit"}
    assert busy["aldi/serve/trunk"] == pytest.approx(2000e-6)
    assert busy["aldi/serve/rpn"] == pytest.approx(500e-6)
    assert busy["aldi/nms"] == pytest.approx(500e-6)
    assert busy["aldi/serve/detections"] == pytest.approx(2000e-6)
    assert busy["aldi/sync/image_copy"] == pytest.approx(1000e-6)
    assert busy["aldi/sync/other"] == 0.0
    exits = [b for _, _, name, b in out if name == "aldi/sync/nms_exit"]
    assert exits == [0.0, 0.0]
    assert spans.span_busy(events(), prefix="aldi/serve/")[0][2] == \
        "aldi/serve/trunk"
    assert spans.span_busy(events(with_ranges=False)) == []


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    from . import tiny

    return tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell,first,units", [
    ("r50fpn.serve", "aldi/serve/trunk", "requests"),
    ("r50fpn.daod_step", "aldi/step/ema update", "steps")])
def test_ranges_of_a_tiny_traced_run(small, cell, first, units):
    """A traced run at a tiny size on the CPU: the program's ranges reach
    the record's ``host`` list, the stages' in order and NMS's exit tests
    among them, and the new readers, with no device interval to read,
    give None and the result line leaves them out."""
    root, bench = small
    c = harness.Cell(cell, root, bench)
    rec = c.driver().run(c, 3000000001, 1, True, torch.device("cpu"),
                         time.perf_counter())
    names = [name for _, _, name in rec["trace"]["host"]
             if name.startswith(spans.PREFIX)]
    stages = [n for n in names if n.startswith(first.rsplit("/", 1)[0])]
    assert stages[0] == first and rec[units] >= 1
    assert spans.count(rec["trace"],
                       lambda n: n == spans.SYNC + "nms_exit") > 0
    assert spans.per(rec, units, lambda t: 1.0) is None
    new = NEW_SERVE if units == "requests" else NEW_TRAIN
    line = run.result(c, rec, True, torch.device("cpu"))
    assert line["correct"] is True
    assert not set(new) & set(line["metrics"])
