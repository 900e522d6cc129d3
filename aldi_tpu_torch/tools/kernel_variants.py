"""Build versions of one rel-pos attention kernel source and hold them side
by side on one card: each against the plain versions (``chip_smoke.
check_attn``) on the tiny, ragged and ViTDet-B grids, then its time at
G = 12 and G = 48 and the time of each of its CUDA kernels (torch.profiler).

Run from the repository root on a machine with a CUDA card::

    python3 -m aldi_tpu_torch.tools.kernel_variants flash_attn_fwd \\
        A=aldi_tpu_torch/csrc/flash_attn_fwd.cu \\
        "B=aldi_tpu_torch/csrc/flash_attn_fwd.cu|STAGES = 2;=>STAGES = 3;"

Each argument after the library name is ``name=source`` followed by any
number of ``|old=>new`` text substitutions (Python escapes allowed). The
versions run in the order given, then the first two once more, so that two
versions are compared within one process on one card. ``--bounded-waits``
replaces the forward's ``mbar_wait`` by one that traps after a few million
polls, so that a wrong barrier parity fails instead of hanging.
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("library", choices=["flash_attn_fwd",
                                            "flash_attn_bwd"])
    parser.add_argument("variants", nargs="+")
    parser.add_argument("--bounded-waits", action="store_true")
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
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

    kernel = flash_attn_fwd if args.library == "flash_attn_fwd" \
        else flash_attn_bwd
    names = list(procs)
    for name in names + names[:2]:
        lib = ctypes.CDLL(os.path.join(args.out, f"{name}.so"))
        lib.aldi_cuda_error_string.argtypes = [ctypes.c_int]
        lib.aldi_cuda_error_string.restype = ctypes.c_char_p
        _build._loaded[args.library] = lib
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
