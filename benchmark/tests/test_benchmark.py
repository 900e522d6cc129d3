"""CPU tests of the benchmark (``python -m pytest benchmark/tests``): its
imports, the discovery of its files by name, the metric readers on a
recorded trace, the operation counts, the reference against the port, the
result line, and the comparison failing on planted faults and on its
control. ``-m cuda`` runs the cells at a tiny size on the card."""

import ast
import contextlib
import io
import json
import shutil
from pathlib import Path

import pytest
import torch

from .. import compare, control, harness, readers, run, trace
from . import faults, tiny

CPU = torch.device("cpu")
SEED = 3000000001  # above 2**31: seeds need more than 32 signed bits


def imported_tops(path):
    """Top-level names of the modules a file imports (absolute imports)."""
    tops = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("part", ["harness", "reference"])
def test_imports(part):
    """No file imports JAX, flax, optax or the JAX package (top-level names
    compared whole: ``aldi_tpu_torch`` is not ``aldi_tpu``); the reference
    imports nothing of the port or of the tests either."""
    forbidden = set(harness.FORBIDDEN)
    files = sorted(p for p in harness.BENCH.rglob("*.py")
                   if "tests" not in p.parts)
    if part == "reference":
        forbidden |= {"aldi_tpu_torch", "tests"}
        files = sorted((harness.BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        bad = imported_tops(f) & forbidden
        assert not bad, f"{f} imports {bad}"
    assert "aldi_tpu" not in {"aldi_tpu_torch".split(".")[0]}


@pytest.mark.parametrize("cell", ["r50fpn.daod_step", "r50fpn.serve"])
def test_discovery(cell):
    """Each cell of BENCHMARK.json finds its workload, configuration,
    driver, operation counts and a reader for every metric it reports."""
    c = harness.Cell(cell)
    assert c.workload["config"] == c.config_name == c.config["name"]
    assert c.workload["traffic"] == c.kind
    assert hasattr(c.driver(), "run") and hasattr(c.flops(), "step")
    for traced in (False, True):
        names = [n for n, _ in c.metrics(traced)]
        assert names and (traced or "setup_s" in names)
        for n in names:
            assert hasattr(c.reader(n), "read")
    assert set(c.workload["limits"]) and all(
        v >= 0 for v in c.workload["limits"].values())


def test_spec_files_match():
    """Every metric has its reader file, every cell and configuration its
    file, and no file under them is orphaned."""
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    metrics = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    readers_ = {p.stem for p in (harness.BENCH / "metrics").glob("*.py")
                if p.stem != "__init__"}
    assert metrics == readers_
    assert {w["name"] for w in spec["workloads"]} == {
        p.stem for p in (harness.BENCH / "workloads").glob("*.json")}
    assert {c["name"] for c in spec["configs"]} == {
        p.stem for p in (harness.BENCH / "configs").glob("*.json")}
    for c in spec["configs"]:
        assert (harness.ROOT / c["file"]).exists()


def run_line(argv, root, bench, fault=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(argv, device=CPU, fault=fault, root=root, bench=bench)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell,traced", [("r50fpn.daod_step", 0),
                                         ("r50fpn.daod_step", 1),
                                         ("r50fpn.serve", 0),
                                         ("r50fpn.serve", 1)])
def test_result_line(small, cell, traced):
    """A tiny run prints the result line's keys, ``checks`` last, its metrics
    with units, and the traced run its window and breakdown; the port in
    float32 meets the plain reference (losses, the first gradient and the
    change of the leaves; every served detection's score)."""
    root, bench = small
    rc, line = run_line(["--workload", cell, "--seed", str(SEED),
                         "--seconds", "1", "--trace", str(traced)],
                        root, bench)
    assert rc == 0 and line["correct"] is True, line["checks"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    c = harness.Cell(cell, root, bench)
    assert set(line["checks"]) == set(c.workload["limits"])
    want = {n for n, _ in c.metrics(bool(traced))}
    assert set(line["metrics"]) <= want
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert want == set(line["metrics"])


@pytest.mark.parametrize("cell,fault", [
    ("r50fpn.daod_step", faults.unchanged),
    ("r50fpn.daod_step", faults.half_batch),
    ("r50fpn.daod_step", faults.teacher_frozen),
    ("r50fpn.serve", faults.altered_answer),
    ("r50fpn.serve", faults.half_request),
    ("r50fpn.serve", faults.no_detections),
    ("r50fpn.serve", faults.duplicates)])
def test_fault_fails(small, cell, fault):
    """With the timed path broken underneath, ``correct`` is false."""
    root, bench = small
    rc, line = run_line(["--workload", cell, "--seed", str(SEED),
                         "--seconds", "0.5", "--trace", "0"], root, bench,
                        fault=fault)
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["r50fpn.daod_step", "r50fpn.serve"])
def test_control_fails(small, cell):
    """The reference in float8 put in the program's place fails the
    cell's limits."""
    root, bench = small
    c = harness.Cell(cell, root, bench)
    r = control.readings(c, SEED, CPU)
    ok, rows = compare.judge(r, c.workload["limits"])
    assert not ok, rows


def _dets(boxes, scores, classes):
    n = len(scores)
    return {"boxes": torch.tensor([boxes], dtype=torch.float32),
            "scores": torch.tensor([scores]),
            "classes": torch.tensor([classes]),
            "valid": torch.ones(1, n, dtype=torch.bool)}


@pytest.mark.parametrize("case", ["same", "shifted", "other_class",
                                  "missing_image"])
def test_teacher_matches(case):
    """Each reference detection is met by the program's detection of its
    class at IoU 0.9 or more: met ones give the median score and box gaps,
    a pass or image with none met reads 1."""
    ref = _dets([[0, 0, 100, 100], [200, 200, 300, 300]], [0.9, 0.5], [1, 2])
    prog = {"same": ref,
            "shifted": _dets([[0, 0, 100, 105], [200, 200, 300, 300]],
                             [0.8, 0.5], [1, 2]),
            "other_class": _dets([[0, 0, 100, 100], [200, 200, 300, 300]],
                                 [0.9, 0.5], [2, 1]),
            "missing_image": {k: v[:0] for k, v in ref.items()}}[case]
    m = compare.teacher_matches([prog], [ref])
    want = {"same": (0.0, 0.0, 1.0),
            "shifted": (0.05, 0.5 * (1 - 100 / 105), 1.0),
            "other_class": (1.0, 1.0, 0.0),
            "missing_image": (1.0, 1.0, 0.0)}[case]
    got = (m["matched_score_gap"], m["matched_box_gap"], m["matched_share"])
    assert got == pytest.approx(want, abs=1e-6)


def test_new_cell_metric_config_as_files(tmp_path):
    """A configuration, a cell and a per-layer metric added as new files
    plus entries in BENCHMARK.json, no file that is there edited: the run
    finds them and reports the new metric."""
    root, bench = tiny.make(tmp_path, cells=("r50fpn.serve",))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((bench / "configs" / "r50fpn_aldi_best.json")
                      .read_text())
    conf["name"] = "r50fpn_small_batch"
    (bench / "configs" / "r50fpn_small_batch.json").write_text(
        json.dumps(conf))
    shutil.copy(bench / "flops" / "r50fpn_aldi_best.py",
                bench / "flops" / "r50fpn_small_batch.py")
    work = json.loads((bench / "workloads" / "r50fpn.serve.json")
                      .read_text())
    work.update(config="r50fpn_small_batch", request_images=1)
    (bench / "workloads" / "r50fpn_small.serve_one.json").write_text(
        json.dumps(work))
    (bench / "metrics" / "requests_done.serve_one.py").write_text(
        '"""requests_done.serve_one: requests in the traced window."""\n\n\n'
        'def read(rec):\n    return float(rec["requests"])\n')
    spec["configs"].append({**spec["configs"][0],
                            "name": "r50fpn_small_batch",
                            "file": "benchmark/configs/r50fpn_small_batch.json"})
    spec["workloads"].append({"name": "r50fpn_small.serve_one",
                              "config": "r50fpn_small_batch",
                              "traffic": "serve", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "r50fpn.serve" in m["workloads"]:
            m["workloads"].append("r50fpn_small.serve_one")
    spec["per_layer"].append({
        "name": "requests_done.serve_one", "unit": "requests",
        "better": "higher", "source": "program_counter", "layer": "test",
        "moves": "serve_images_per_s",
        "workloads": ["r50fpn_small.serve_one"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line = run_line(["--workload", "r50fpn_small.serve_one", "--seed",
                         "7", "--seconds", "0.5", "--trace", "1"], root, bench)
    assert rc == 0 and line["metrics"]["requests_done.serve_one"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def synthetic_trace():
    """Chrome-trace events of a 9 ms window: two kernels, a copy, a mark
    and host calls."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 1000.0, "dur": 9000.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1000.0,
           "dur": 500.0},
          {"ph": "X", "cat": "kernel", "name": "roi_align_fwd_kernel",
           "ts": 2000.0, "dur": 2000.0},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 3000.0,
           "dur": 3000.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 8000.0, "dur": 1000.0},
          {"ph": "X", "cat": "user_annotation",
           "name": trace.MARK + "strong views", "ts": 5900.0, "dur": 1.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero",
           "ts": 6000.0, "dur": 1500.0}]
    return trace.reduce(ev)


def test_readers_on_a_recorded_trace():
    red = synthetic_trace()
    assert red["window_s"] == pytest.approx(0.009)
    assert red["busy_s"] == pytest.approx(0.005)
    rec = {"trace": red, "steps": 2, "requests": 2, "flops": 989e9,
           "stage_ms": [[("teacher (pseudo-labels, distill targets)", 3.0),
                         ("strong views", 1.0),
                         ("strong stream fwd+bwd", 4.0),
                         ("distill stream fwd+bwd", 5.0),
                         ("optimizer", 2.0)]] * 2,
           "launches": []}
    cell = harness.Cell("r50fpn.daod_step")
    get = {n: cell.reader(n).read(rec) for n, _ in cell.metrics(True)}
    assert get["idle_share.train"] == pytest.approx(100.0 * 4 / 9)
    assert get["mfu.train"] == pytest.approx(100.0 * 2 * 989e9 / 0.009
                                             / 989e12)
    assert get["stage_ms.streams.train"] == pytest.approx(9.0)
    assert get["stage_ms.teacher.train"] == pytest.approx(3.0)
    assert get["stage_ms.views.train"] == pytest.approx(1.0)
    assert get["stage_ms.optimizer.train"] == pytest.approx(2.0)
    assert get["roofline.k2_fwd.train"] is None  # no launch recorded
    serve = harness.Cell("r50fpn.serve")
    assert serve.reader("copy_ms.serve").read(rec) == pytest.approx(0.5)
    gaps = trace.idle_gaps(red)
    assert gaps[0][1] == pytest.approx(0.002)  # 6 ms .. 8 ms
    assert gaps[0][0] == "after strong views: aten::nonzero"
    assert trace.top_device_ops(red)[0] == ["gemm", pytest.approx(0.003)]
    # a K2 launch whose bound is known: the share is bound / kernel time
    hws = [(32, 64), (16, 32), (8, 16), (4, 8)]
    boxes = torch.tensor([[[4.0, 4.0, 60.0, 60.0]]])
    levels = torch.zeros((1, 1), dtype=torch.int32)
    rec["launches"] = [("roi_align_fwd", {"hws": hws, "channels": 256,
                                          "esize": 2, "boxes": boxes,
                                          "levels": levels})]
    bound = readers.launch_bound_s("roi_align_fwd", rec["launches"][0][1])
    assert 0 < bound < 0.002
    assert get is not None
    assert cell.reader("roofline.k2_fwd.train").read(rec) == pytest.approx(
        100.0 * bound / 0.002)


def test_flops_against_flop_counter():
    """The operation counts of flops/ against FlopCounterMode over the
    reference's modules at a small canvas: the trunk and pyramid, the RPN
    head, the box head (R50-FPN and ViTDet-B)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..flops import parts
    from ..reference import runner
    from ..reference.models.vit import VIT_CONFIGS

    for yaml, canvas in (("ALDI-Best-Cityscapes.yaml", (64, 128)),
                         ("ALDI-Best-ViT-Cityscapes.yaml", (64, 128))):
        cfg = runner.config(str(harness.ROOT / "configs" / "cityscapes"
                                / yaml), {"TPU.CANVAS": list(canvas)})
        det = runner.detector(cfg, "cpu")
        m = det.module
        x = torch.zeros((1, 3) + canvas)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            feats = m.backbone(x)
        trunk = fc.get_total_flops()
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            m.proposal_generator["rpn_head"](feats)
        rpn = fc.get_total_flops()
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            y = m.roi_heads["box_head"](torch.zeros((5, 7, 7, 256)))
            m.roi_heads["box_predictor"](y)
        head = fc.get_total_flops()
        b = cfg.MODEL.ROI_BOX_HEAD
        want_head = sum(parts.box_head(5, 8, b.NUM_CONV, b.NUM_FC, b.FC_DIM))
        want_rpn = sum(parts.rpn_head(canvas, len(cfg.MODEL.RPN.CONV_DIMS)))
        if "ViT" in yaml:
            v = VIT_CONFIGS["b"]
            grid = (canvas[0] // 16, canvas[1] // 16)
            want_trunk = (sum(parts.vit(grid, v["embed_dim"], v["depth"],
                                        v["num_heads"], v["global_blocks"]))
                          + sum(parts.simple_feature_pyramid(
                              grid, v["embed_dim"])))
        else:
            f, t, shapes = parts.resnet(50, True, 2, *canvas)
            want_trunk = f + t + sum(parts.fpn(shapes))
        assert (trunk, rpn, head) == (want_trunk, want_rpn, want_head), yaml


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["r50fpn.daod_step", "r50fpn.serve"])
def test_tiny_cell_on_card(card, small, cell):
    """The tiny cells run on the card, traced, with their per-layer
    metrics read from the device trace."""
    root, bench = small
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                       "2", "--trace", "1"], root=root, bench=bench)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0 and line["checks"]
