"""The plain reference of the benchmark's configurations, in float32 with
TF32 off: a frozen copy of the port's plain PyTorch path (models, losses,
samplers, NMS, the plain ROIAlign and matcher, the step's stream logic,
EMA and the optimizers), with these departures:

- every kernel is its plain version: ROIAlign's gather form with its
  gradient from autograd (``ops/roi_align.py``), the matcher one image at a
  time (``ops/matcher.py`` ``match_boxes``), the rel-pos attention a few
  heads at a time under activation checkpointing (``ops/flash_attn.py``);
- no process grid: every count and batch is the process's own (``mesh.py``);
- the ResNet-FPN trunk runs one image at a time under activation
  checkpointing when a gradient is taken (``models/rcnn.py``), which
  changes the memory and not the arithmetic;
- every product goes through ``precision.py``, float32 by default and
  float8 e4m3 for the control.

It imports nothing of ``aldi_tpu_torch``, ``aldi_tpu``, ``tests`` or JAX.
``runner.py`` is its entry point.
"""
