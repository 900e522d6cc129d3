"""Per-block timing of the ROIAlign backward's tile kernel
(``csrc/roi_align_bwd.cu``) on one card.

Builds a copy of the source with ``%globaltimer`` stamps at the start of
each tile block, once its box list is built and before it writes its tile,
runs it at a training step's synthetic shape (``chip_smoke.roi_bwd_inputs``,
4 x 512 boxes, bfloat16) and prints, per pyramid level: the blocks, the
share that lists boxes, the boxes listed, the mean microseconds to the list
and to the write, and when the level's blocks started. Run from the
repository root on a machine with a CUDA card::

    python3 -m aldi_tpu_torch.tools.roi_tile_timing
"""

import ctypes
import os
import subprocess
import sys

STAMPS = [
    ("namespace {\n",
     "__device__ long long g_stamp[1 << 20][4];\n"
     "__device__ __forceinline__ long long stamp_now() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n\nnamespace {\n"),
    ("  const int S = output_size * sampling_ratio;\n  // acc:",
     "  const long long t_start = stamp_now();\n"
     "  long long t_list = 0;\n  int n_listed = 0;\n"
     "  const int S = output_size * sampling_ratio;\n  // acc:"),
    ("    for (int b0 = 0; b0 < total; b0 += kLatBoxes) {",
     "    if (!t_list) t_list = stamp_now();\n    n_listed += total;\n"
     "    for (int b0 = 0; b0 < total; b0 += kLatBoxes) {"),
    ("  // write the tile once, in the features' dtype\n",
     "  const long long t_write = stamp_now();\n"
     "  // write the tile once, in the features' dtype\n"),
    ("* channels + v * VS, vals);\n  }\n}",
     "* channels + v * VS, vals);\n  }\n"
     "  if (tid == 0 && blockIdx.y == 0) {\n"
     "    g_stamp[blockIdx.x][0] = t_start;\n"
     "    g_stamp[blockIdx.x][1] = t_list ? t_list : t_start;\n"
     "    g_stamp[blockIdx.x][2] = t_write;\n"
     "    g_stamp[blockIdx.x][3] = ((long long)lvl << 32) | n_listed;\n"
     "  }\n}"),
]
READ = ('\nextern "C" int aldi_stamp_read(void* dst, int n) {\n'
        '  return (int)cudaMemcpyFromSymbol(dst, g_stamp, (size_t)n * 32);\n'
        '}\n')


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from aldi_tpu_torch.ops import _build
    from aldi_tpu_torch.ops.roi_align_kernel import roi_align_bwd

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = (_build.CSRC / "roi_align_bwd.cu").read_text()
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise SystemExit(f"the source changed: {old!r}")
        src = src.replace(old, new)
    out = "build/roi_tile_timing"
    os.makedirs(out, exist_ok=True)
    with open(f"{out}/bwd.cu", "w") as f:
        f.write(src + READ)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", f"{out}/bwd.so", f"{out}/bwd.cu"], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(f"{out}/bwd.so")
    lib.aldi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aldi_cuda_error_string.restype = ctypes.c_char_p
    _build._loaded["roi_align_bwd"] = lib

    grad, boxes, levels, shapes = cs.roi_bwd_inputs(torch.bfloat16, 15)
    ms = cs.cuda_ms(lambda: roi_align_bwd(grad, boxes, levels, shapes,
                                          grad.dtype, cs.ROI_STRIDES), 10)
    roi_align_bwd(grad, boxes, levels, shapes, grad.dtype, cs.ROI_STRIDES)
    torch.cuda.synchronize()
    n = boxes.shape[0] * sum(-(-h // 8) * -(-w // 8) for h, w in shapes)
    st = np.zeros((n, 4), np.int64)
    lib.aldi_stamp_read(st.ctypes.data, n)
    t0 = st[:, 0].min()
    lvl, listed = st[:, 3] >> 32, st[:, 3] & 0xffffffff
    print(f"[tiles] 4 x 512 synthetic boxes, bf16: wrapper {ms:.4f} ms; "
          f"tile kernel span {(st[:, 2].max() - t0) / 1e3:.1f} us "
          f"(start of the first block to the last block's write)")
    for level in range(len(shapes)):
        m = lvl == level
        busy = m & (listed > 0)
        to_list = (st[busy, 1] - st[busy, 0]).mean() / 1e3 if busy.any() else 0
        to_write = (st[m, 2] - st[m, 0]) / 1e3
        print(f"[tiles] p{level + 2}: {m.sum()} blocks, "
              f"{(listed[m] > 0).mean():.3f} "
              f"with boxes, boxes listed mean {listed[m].mean():.2f} max "
              f"{listed[m].max()}; us to the list {to_list:.2f} (blocks with "
              f"boxes), to the write mean {to_write.mean():.2f} max "
              f"{to_write.max():.2f} (with boxes "
              f"{(st[busy, 2] - st[busy, 0]).mean() / 1e3 if busy.any() else 0:.2f}"
              f"); started {(st[m, 0].min() - t0) / 1e3:.1f}-"
              f"{(st[m, 0].max() - t0) / 1e3:.1f} us", flush=True)


if __name__ == "__main__":
    sys.exit(main())
