"""Port parity of the YOLOv5 DAOD step against the JAX package, as in
``tests/test_torch_port_yolo_train.py``, with TPU.GRAD_ACCUM 2 (the
running statistics carried from chunk to chunk), SOLVER.BACKWARD_AT_END
(one backward for all streams) and image-level alignment on p5 (the
reference's ``YoloAlignMixin``: ``loss_da_img`` on the labeled stream and
the target_weak stream, whose training-mode pass moves the statistics
too) at once: one JAX compile (about 45 s) covers the three. Tolerances as
there."""

from tests.test_torch_port_yolo_train import check_two_steps, two_steps
from tests.torch_port_threads import capped_torch_threads  # noqa: F401


def test_two_daod_steps_with_accum_backward_at_end_and_align_match_jax():
    want, got, state = two_steps(**{
        "TPU.GRAD_ACCUM": 2, "SOLVER.BACKWARD_AT_END": True,
        "DOMAIN_ADAPT.ALIGN.IMG_DA_ENABLED": True,
        "DOMAIN_ADAPT.ALIGN.IMG_DA_LAYER": "p5"})
    check_two_steps(want, got, state)
    for stream in ("source_strong", "target_weak"):
        assert f"loss_da_img_{stream}" in got[0][0]
