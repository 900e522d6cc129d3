"""The assignment solver K4 (``csrc/lapjv.cu``) and its wrapper.

K4 replaces ``aldi_tpu/ops/lapjv.py:97`` ``lapjv`` (XLA while_loops, not a
Pallas kernel), which the DETR criterion runs on all of its L*B problems at
once. Its plain version is ``lapjv.lapjv_plain``, equal to it on every
input; ``custom_ops.lapjv`` dispatches between the two by device. The
library is built on the first launch, never on import. The entry point
takes one warp per problem for m <= 512 (the DETR criterion's queries) and
one thread block per problem above; ``kernel_for`` says which.
"""

import ctypes

import torch

from . import _build


class Lapjv(_build.Kernel):
    """K4: per problem the min-cost assignment of its first ``n_rows``
    rows into the m columns (n <= m), and the settles it took."""

    name = "lapjv"
    library = "lapjv"
    source = "aldi_tpu_torch/csrc/lapjv.cu"
    replaces = "aldi_tpu/ops/lapjv.py:97"
    argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 4)

    def __call__(self, cost, n_rows):
        """cost [P, n, m] float32 and n_rows [P] int32 on the card ->
        (col4row [P, n] int32, settles [P] int32)."""
        dev = cost.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} needs CUDA tensors, got {dev}")
        if cost.dtype != torch.float32 or cost.dim() != 3:
            raise ValueError("cost must be a float32 [P, n, m]")
        p, n, m = cost.shape
        if n > m:
            raise ValueError(f"lapjv requires n <= m, got {tuple(cost.shape)}")
        if (n_rows.device != dev or n_rows.dtype != torch.int32
                or n_rows.shape != (p,)):
            raise ValueError("n_rows must be an int32 [P] on the cost's "
                             "device")
        cost, n_rows = cost.contiguous(), n_rows.contiguous()
        col4row = torch.empty((p, n), dtype=torch.int32, device=dev)
        settles = torch.empty(p, dtype=torch.int32, device=dev)
        if p == 0:
            return col4row, settles
        nbytes = self.scratch_bytes(p, n, m)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            self.launch(cost.data_ptr(), n_rows.data_ptr(), p, n, m,
                        col4row.data_ptr(), settles.data_ptr(),
                        scratch.data_ptr() if nbytes else None,
                        torch.cuda.current_stream(dev).cuda_stream)
        return col4row, settles

    def scratch_bytes(self, p, n, m) -> int:
        """Bytes of global scratch a launch on P problems of [n, m] takes
        (0 unless the block kernel's state outgrows shared memory)."""
        fn = self.lib().aldi_lapjv_scratch_bytes
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_size_t
        return fn(p, n, m)

    def kernel_for(self, n, m) -> str:
        """The kernel a launch on problems of [n, m] takes (the library
        chooses it by m, and by whether the costs fit in shared memory)."""
        fn = self.lib().aldi_lapjv_kernel_name
        fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_char_p
        return fn(n, m).decode()


lapjv = Lapjv()
