"""The split-bf16 products of the rel-pos attention backward (K3b), on the
CPU.

K3b's bfloat16 path runs dQ = dS K, dK = dS^T Q and dV = P^T dO on the
tensor cores, which take bfloat16 operands, while the TPU kernel keeps P and
dS in float32. K3b splits each float32 operand into hi + lo bfloat16 terms.
``flash_attn_split_backward`` emulates that arithmetic in plain PyTorch;
these tests hold it against ``flash_attn_plain_backward`` within the
tolerances ``chip_smoke.check_attn`` states for bfloat16 (dq/dk/dv one
bfloat16 ulp of each value plus 1e-4 of the tensor's scale, dbh/dbw 1e-4 of
the scale), and show that one bfloat16 rounding of P and dS does not hold.
"""

import numpy as np
import pytest
import torch

from aldi_tpu_torch.ops.flash_attn import (attn_delta, flash_attn_plain,
                                           flash_attn_plain_backward,
                                           flash_attn_split_backward)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

NAMES = ("dq", "dk", "dv", "dbh", "dbw")


def _inputs(seed, g, h_grid, w_grid):
    rng = np.random.default_rng(seed)
    n = h_grid * w_grid

    def t(*shape, s=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(
            (rng.standard_normal(shape) * s).astype(np.float32)).to(dtype)

    q, k, v, dout = (t(g, n, 64) for _ in range(4))
    bh = t(g, n, h_grid, s=0.5, dtype=torch.float32)
    bw = t(g, n, w_grid, s=0.5, dtype=torch.float32)
    scale = 64 ** -0.5
    out, lse = flash_attn_plain(q, k, v, bh, bw, scale, h_grid, w_grid)
    return (q, k, v, bh, bw, lse, attn_delta(out, dout), dout, scale, h_grid,
            w_grid)


def _excess(got, want):
    """Per tensor: the largest error and the largest amount by which an
    entry exceeds check_attn's bfloat16 tolerance (<= 0: within it)."""
    out = {}
    for name, a, b in zip(NAMES, got, want):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        allowed = 1e-4 * max(1.0, float(b.abs().max()))
        if name in ("dq", "dk", "dv"):
            allowed = allowed + b.abs() * 2.0 ** -7
        out[name] = (float(diff.max()), float((diff - allowed).max()))
    return out


@pytest.mark.parametrize("grid,g", [((8, 8), 2), ((7, 5), 3), ((6, 22), 1)])
def test_split_products_hold_the_bf16_tolerance(grid, g):
    """Grids with one key tile, a ragged one, and several tiles that cross
    grid rows (132 keys in 64-key tiles)."""
    args = _inputs(sum(grid), g, *grid)
    want = flash_attn_plain_backward(*args)
    split = _excess(flash_attn_split_backward(*args), want)
    print(f"split hi + lo, grid {grid}: "
          + ", ".join(f"{k} err {e:.3g} (excess {x:.3g})"
                      for k, (e, x) in split.items()))
    for name, (_, excess) in split.items():
        assert excess <= 0, name


def test_one_bf16_rounding_breaks_the_tolerance():
    args = _inputs(0, 2, 8, 16)
    want = flash_attn_plain_backward(*args)
    split = _excess(flash_attn_split_backward(*args), want)
    single = _excess(flash_attn_split_backward(*args, single=True), want)
    print("single rounding: " + ", ".join(
        f"{k} err {e:.3g} (excess {x:.3g})" for k, (e, x) in single.items()))
    print("split: " + ", ".join(
        f"{k} err {e:.3g}" for k, (e, _) in split.items()))
    assert all(split[k][1] <= 0 for k in NAMES)
    assert any(single[k][1] > 0 for k in ("dq", "dk", "dv"))
    # the split's error is far below the single rounding's
    for k in ("dq", "dk", "dv"):
        assert split[k][0] < single[k][0]
