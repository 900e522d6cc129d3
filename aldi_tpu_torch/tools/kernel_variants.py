"""Build versions of one kernel source and hold them side by side on one
card, in one process.

Rel-pos attention (``flash_attn_fwd``, ``flash_attn_bwd``): each version
against the plain versions (``chip_smoke.check_attn``) on the tiny, ragged
and ViTDet-B grids, then its time at G = 12 and G = 48 and the time of each
of its CUDA kernels (torch.profiler). ROIAlign (``roi_align_fwd``,
``roi_align_bwd``): each version against the plain version
(``chip_smoke.check_roi`` / ``check_roi_bwd``, which print its time, bound
and share of the bound) at the synthetic all-level shapes in float32 and
bfloat16 and at a training step's shape (4 x 512) in bfloat16; the forward
also on a real R50-FPN request's proposals (seeded weights); then the time
of each CUDA kernel of one bfloat16 call. The previous ROIAlign sources are
kept in ``aldi_tpu_torch/tools/previous/``; the previous backward, whose
entry point takes zeroed float32 tables, runs behind the previous wrapper
(zeroed tables, the launch, a cast).

Run from the repository root on a machine with a CUDA card::

    python3 -m aldi_tpu_torch.tools.kernel_variants flash_attn_fwd \\
        A=aldi_tpu_torch/csrc/flash_attn_fwd.cu \\
        "B=aldi_tpu_torch/csrc/flash_attn_fwd.cu|STAGES = 2;=>STAGES = 3;"
    python3 -m aldi_tpu_torch.tools.kernel_variants roi_align_bwd \\
        old=aldi_tpu_torch/tools/previous/roi_align_bwd_atomic.cu \\
        new=aldi_tpu_torch/csrc/roi_align_bwd.cu

Each argument after the library name is ``name=source`` followed by any
number of ``|old=>new`` text substitutions (Python escapes allowed). The
versions run in the order given, then the first two once more, so that two
versions are compared within one process on one card. ``--bounded-waits``
replaces the attention forward's ``mbar_wait`` by one that traps after a
few million polls, so that a wrong barrier parity fails instead of hanging.
"""

import argparse
import ctypes
import os
import subprocess
import sys

BOUNDED_WAIT = r'''__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile("{\n.reg .pred P1;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, P1;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (i > 4000000) __trap();
  }
}

'''
GRIDS = (((8, 8), 4), ((7, 5), 3), ((50, 84), 2), ((64, 64), 4),
         ((64, 128), 12))


def variant_source(spec, bounded):
    name, rest = spec.split("=", 1)
    path, *subs = rest.split("|")
    src = open(path).read()
    for sub in subs:
        old, new = (x.encode().decode("unicode_escape")
                    for x in sub.split("=>"))
        if old not in src:
            raise SystemExit(f"{name}: {old!r} not in {path}")
        src = src.replace(old, new)
    if bounded:
        a = src.index("__device__ __forceinline__ void mbar_wait(")
        b = src.index("\n// ", a)
        src = src[:a] + BOUNDED_WAIT + src[b + 1:]
    return name, src


def load_variant(out, name):
    lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
    lib.aldi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aldi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_times(fn, calls=3):
    """Device ms per call of each CUDA kernel that ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return "; ".join(f"{e.key.split('(')[0].split('::')[-1][:48]} "
                     f"{e.device_time_total / calls / 1e3:.4f} ms x"
                     f"{e.count // calls}"
                     for e in prof.key_averages() if e.device_time_total > 0)


def table_backward(lib):
    """The previous ROIAlign backward, entry point
    ``aldi_roi_align_bwd_tables``, behind the previous wrapper: zeroed
    float32 tables of every level, the launch, a cast to the features'
    dtype."""
    import numpy as np
    import torch

    from aldi_tpu_torch.ops.roi_align_kernel import (_DTYPE_CODES,
                                                     _RoiAlignKernel)

    fn = lib.aldi_roi_align_bwd_tables
    fn.argtypes = _RoiAlignKernel.argtypes + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int

    def backward(grad, boxes, levels, feat_shapes, feat_dtype, strides,
                 sampling_ratio=2):
        b, p, out, _, c = grad.shape
        tables = [torch.zeros((b, h, w, c), dtype=torch.float32,
                              device=grad.device) for h, w in feat_shapes]
        ptrs = np.asarray([t.data_ptr() for t in tables], np.uint64)
        hw = np.asarray(feat_shapes, np.int32)
        scale = np.asarray([1.0 / s for s in strides], np.float32)
        rc = fn(ptrs.ctypes.data, hw.ctypes.data, scale.ctypes.data,
                len(feat_shapes), boxes.data_ptr(), levels.data_ptr(), p,
                b * p, c, out, sampling_ratio, _DTYPE_CODES[grad.dtype],
                grad.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"aldi_roi_align_bwd_tables: CUDA error {rc}")
        return [t.to(feat_dtype) for t in tables]

    return backward


def run_roi(args, names):
    import torch

    import chip_smoke as cs
    from aldi_tpu_torch.ops import _build
    from aldi_tpu_torch.ops.match_kernel import low_quality_mask, match_iou
    from aldi_tpu_torch.ops.roi_align_kernel import roi_align_bwd, roi_align_fwd

    step = []
    if args.step_shapes:  # the R50-FPN training step's own K2 launches
        _, _, step = cs.training_phase(
            args.card, [match_iou, low_quality_mask, roi_align_fwd,
                        roi_align_bwd])
        kind = "forward" if args.library == "roi_align_fwd" else "backward"
        step = [r for r in step if r["kind"] == kind]

    if args.library == "roi_align_fwd":
        from aldi_tpu_torch.config import get_cfg
        from aldi_tpu_torch.engine.export import make_serving_fn
        from aldi_tpu_torch.models import build_detector

        cfg = get_cfg()
        cfg.merge_from_file(cs.FLAGSHIP)
        det = build_detector(cfg)
        make_serving_fn(det, cs.seeded_weights(det, seed=0))
        gen = torch.Generator(device="cuda").manual_seed(1)
        request = cs.synthetic_request(gen, det.canvas)
        request = cs.request_proposals(det, *request)[:3]
        del det
        cases = [("synthetic all-level, float32",
                  cs.synthetic_roi_inputs(torch.float32, 11)),
                 ("synthetic all-level, bfloat16",
                  cs.synthetic_roi_inputs(torch.bfloat16, 12)),
                 ("training-step shape 4 x 512, bfloat16",
                  cs.synthetic_roi_inputs(torch.bfloat16, 15,
                                          b=cs.TRAIN_IMAGES, p=512)),
                 ("serving request, real proposals", request)]
    else:
        cases = [("training-step shape, float32",
                  cs.roi_bwd_inputs(torch.float32, 14)),
                 ("training-step shape, bfloat16",
                  cs.roi_bwd_inputs(torch.bfloat16, 15)),
                 ("serving shape 8 x 1000, bfloat16",
                  cs.roi_bwd_inputs(torch.bfloat16, 12, b=cs.BATCH,
                                    p=1000))]
    for name in names + names[:2]:
        lib = load_variant(args.out, name)
        if args.library == "roi_align_fwd":
            _build._loaded["roi_align_fwd"] = lib
            for label, inputs in cases:
                cs.check_roi(f"{name}, {label}", *inputs, plain_iters=0)
            if step:
                cs.time_step_launches(f"{name}, R50-FPN", step, plain_iters=0)
            feats, boxes, levels = cases[-1][1]

            def fn():
                roi_align_fwd(feats, boxes, levels, cs.ROI_STRIDES)
        else:
            backward = (table_backward(lib)
                        if hasattr(lib, "aldi_roi_align_bwd_tables") else None)
            if backward is None:
                _build._loaded["roi_align_bwd"] = lib
            backward = backward or roi_align_bwd
            for label, inputs in cases:
                cs.check_roi_bwd(f"{name}, {label}", *inputs, plain_iters=0,
                                 backward=backward)
            if step:
                cs.time_step_launches(f"{name}, R50-FPN", step, plain_iters=0,
                                      backward=backward)
            grad, boxes, levels, shapes = cases[1][1]

            def fn():
                backward(grad, boxes, levels, shapes, grad.dtype,
                         cs.ROI_STRIDES)
        print(f"[variant] {name}: per CUDA kernel of one bfloat16 call ("
              f"{cases[-1 if args.library == 'roi_align_fwd' else 1][0]}): "
              + kernel_times(fn), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("library", choices=["flash_attn_fwd",
                                            "flash_attn_bwd",
                                            "roi_align_fwd",
                                            "roi_align_bwd"])
    parser.add_argument("variants", nargs="+")
    parser.add_argument("--bounded-waits", action="store_true")
    parser.add_argument("--step-shapes", action="store_true",
                        help="ROIAlign: also time each version at the "
                        "launches of one R50-FPN training step (chip_smoke."
                        "training_phase runs first)")
    parser.add_argument("--out", default="build/kernel_variants")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from aldi_tpu_torch.ops import _build
    from aldi_tpu_torch.ops.flash_attn import attn_delta
    from aldi_tpu_torch.ops.flash_attn_kernel import (flash_attn_bwd,
                                                      flash_attn_fwd)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    args.card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip()
    print(args.card, flush=True)
    os.makedirs(args.out, exist_ok=True)
    procs = {}
    for spec in args.variants:
        name, src = variant_source(spec, args.bounded_waits)
        cu = os.path.join(args.out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", os.path.join(args.out, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "C75")):
                print(f"[build] {name}: {line.strip()[:160]}")
        if proc.returncode:
            raise SystemExit(f"{name} did not build:\n{log[:4000]}")

    names = list(procs)
    if args.library.startswith("roi_align"):
        return run_roi(args, names)
    kernel = flash_attn_fwd if args.library == "flash_attn_fwd" \
        else flash_attn_bwd
    for name in names + names[:2]:
        _build._loaded[args.library] = load_variant(args.out, name)
        for grid, g in GRIDS:
            cs.check_attn(name, torch.bfloat16, *grid, g, seed=21)
        times = []
        for g in (12, 48):
            q, k, v, bh, bw, dout = cs.attn_inputs(torch.bfloat16, 5, g,
                                                   64, 128)
            out, lse = flash_attn_fwd(q, k, v, bh, bw, 0.125, 64, 128)
            delta = attn_delta(out, dout)
            if kernel is flash_attn_fwd:
                def fn():
                    flash_attn_fwd(q, k, v, bh, bw, 0.125, 64, 128)
            else:
                def fn():
                    flash_attn_bwd(q, k, v, bh, bw, lse, delta, dout, 0.125,
                                   64, 128)
            times.append(cs.cuda_ms(fn, 10))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        parts = [f"{e.key.split('(')[0].split('::')[-1]} "
                 f"{e.device_time_total / e.count / 1e3:.3f} ms"
                 for e in prof.key_averages() if e.device_time_total > 0]
        print(f"[variant] {name}: G=12 {times[0]:.4f} ms, G=48 "
              f"{times[1]:.4f} ms; at G=48 " + "; ".join(parts), flush=True)


if __name__ == "__main__":
    sys.exit(main())
