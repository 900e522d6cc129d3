"""Least time of one launch of K3a (forward) and K3b (backward), the
rel-pos attention of the ViTDet global blocks, on q [G, N, D]: the
function's products, 4 N^2 D per head forward (q.k, P.v) and 10 N^2 D
backward (q.k, dO.v, dS.k, dS^T.q, P^T.dO), over the dense bf16
tensor-core peak for bfloat16 inputs and the float32 CUDA-core peak for
float32; against bytes (forward: q, k, v, Bh, Bw read and out, lse written
once; backward: q, k, v, dO, Bh, Bw, lse, delta read and dq, dk, dv, dBh,
dBw written once)."""

from . import peaks


def bound_s(kind, g, n, d, esize, h_grid, w_grid, bf16) -> float:
    """Seconds: ``kind`` "fwd" (K3a) or "bwd" (K3b)."""
    peak = peaks.BF16_FLOPS if bf16 else peaks.F32_FLOPS
    bias = g * n * (h_grid + w_grid) * 4
    if kind == "fwd":
        ops, n_bytes = 4 * n * n * d * g, 4 * g * n * d * esize + bias + g * n * 4
    else:
        ops = 10 * n * n * d * g
        n_bytes = 7 * g * n * d * esize + 2 * bias + 2 * g * n * 4
    return max(ops / peak, n_bytes / peaks.BYTES_PER_S)
