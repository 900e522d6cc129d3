"""Attention with the decomposed relative-position bias of the ViTDet global
blocks: ``softmax(q k^T * scale + Bh[q, y_k] + Bw[q, x_k]) v``.

Port of ``aldi_tpu/ops/pallas_flash_attn.py``. q/k/v are [G, N, D] with
G = batch * heads and the keys in raster order (key k at grid cell
(y, x) = (k // w_grid, k % w_grid)); bh is [G, N, h_grid], bw
[G, N, w_grid], both float32. Two versions of the forward and of the
backward:

- ``flash_attn_plain`` and ``flash_attn_plain_backward``: plain PyTorch,
  the whole [N, N] logits of a few heads at a time, with the Pallas
  kernels' arithmetic (``:101-148`` and ``:170-214``): float32 logits from
  the input-dtype q and k, the probabilities rounded to the input dtype
  before P.V, and every product of the backward in float32. The CPU path,
  and the reference the CUDA kernels are held against.
- the CUDA kernels K3a/K3b behind ``flash_attn_kernel.flash_attn_fwd`` and
  ``flash_attn_kernel.flash_attn_bwd``.

``flash_attn_split_backward`` emulates K3b's bfloat16 arithmetic (P and dS
split into two bfloat16 terms before the tensor cores) for the tests.

``flash_attention_relpos`` calls the custom op
``aldi_tpu_torch::flash_attn_fwd`` (``custom_ops.py``): CPU tensors take the
plain versions, CUDA tensors the kernels, and its autograd pairs the forward
with the backward op, as the JAX package's ``custom_vjp`` does; the
backward is never autograd through the plain forward (that would
accumulate bfloat16 products in bfloat16). The
Pallas kernel's tilings (``supported_shape``) do not apply: the CUDA
kernels mask their ragged tiles, so any N and grid are taken.
"""

import torch

from . import custom_ops

# [G, N, N] float32 elements one plain call holds at once (1 GiB)
_PLAIN_CHUNK = 1 << 28


def _chunks(g, n):
    step = max(1, _PLAIN_CHUNK // max(n * n, 1))
    return [slice(s, min(s + step, g)) for s in range(0, g, step)]


def _logits(q, k, bh, bw, scale, w_grid):
    """float32 [g, N, N]: (q.k * scale + Bh[q, y_k]) + Bw[q, x_k]."""
    n = q.shape[1]
    keys = torch.arange(n, device=q.device)
    y, x = keys // w_grid, keys % w_grid
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    return (s + bh.float()[:, :, y]) + bw.float()[:, :, x]


def flash_attn_plain(q, k, v, bh, bw, scale, h_grid, w_grid):
    """Plain forward. Returns (out [G, N, D] in q's dtype, lse [G, N]
    float32)."""
    g, n, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((g, n), dtype=torch.float32, device=q.device)
    for sl in _chunks(g, n):
        logits = _logits(q[sl], k[sl], bh[sl], bw[sl], scale, w_grid)
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        del logits
        den = p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), v[sl].float())
        out[sl] = (o / den).to(q.dtype)
        lse[sl] = (m + torch.log(den)).squeeze(-1)
    return out, lse


def attn_delta(out, dout):
    """delta = rowsum(dout * out) in float32, [G, N]."""
    return (dout.float() * out.float()).sum(-1)


def flash_attn_plain_backward(q, k, v, bh, bw, lse, delta, dout, scale,
                              h_grid, w_grid):
    """Plain backward of ``flash_attn_plain`` for the cotangent dout, from
    its lse and ``attn_delta(out, dout)``: P from the LSE, dS = P (dO V^T -
    delta), dQ = dS K scale, dK = dS^T Q scale, dV = P^T dO, dBh = sum_x dS,
    dBw = sum_y dS, all in float32. Returns (dq, dk, dv) in the inputs'
    dtype and (dbh, dbw) in float32."""
    g, n, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dbh = torch.empty((g, n, h_grid), dtype=torch.float32, device=q.device)
    dbw = torch.empty((g, n, w_grid), dtype=torch.float32, device=q.device)
    for sl in _chunks(g, n):
        qf, kf, vf, dof = (t[sl].float() for t in (q, k, v, dout))
        p = torch.exp(_logits(q[sl], k[sl], bh[sl], bw[sl], scale, w_grid)
                      - lse[sl, :, None])
        dp = torch.matmul(dof, vf.transpose(1, 2))
        ds = p * (dp - delta[sl, :, None])
        del dp
        dq[sl] = (torch.matmul(ds, kf) * scale).to(q.dtype)
        dk[sl] = (torch.matmul(ds.transpose(1, 2), qf) * scale).to(k.dtype)
        dv[sl] = torch.matmul(p.transpose(1, 2), dof).to(v.dtype)
        del p
        grid = ds.reshape(ds.shape[0], n, h_grid, w_grid)
        dbh[sl] = grid.sum(-1)
        dbw[sl] = grid.sum(-2)
    return dq, dk, dv, dbh, dbw


def _split_bf16(x):
    """float32 x as hi + lo, both bfloat16 values (held in float32):
    hi = bf16(x), lo = bf16(x - hi); x - hi - lo is ~2^-16 of x."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def flash_attn_split_backward(q, k, v, bh, bw, lse, delta, dout, scale,
                              h_grid, w_grid, single=False):
    """Plain emulation of K3b's bfloat16 arithmetic, for the tests: P and dS
    in float32 as in ``flash_attn_plain_backward``, but the products that
    take them (dQ = dS K, dK = dS^T Q, dV = P^T dO) take them as K3b's
    tensor cores do, split into hi + lo bfloat16 terms, each product summed
    in float32 against the exact bfloat16 operand. ``single=True`` rounds P
    and dS to bfloat16 once instead (what the split avoids). dBh and dBw are
    summed as the dq kernel sums them: within each tile of 64 keys, then
    tile after tile. Returns what ``flash_attn_plain_backward``
    returns."""
    g, n, d = q.shape
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    p = torch.exp(_logits(q, k, bh, bw, scale, w_grid) - lse[:, :, None])
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta[:, :, None])

    def product(a, b):
        if single:
            return torch.matmul(a.to(torch.bfloat16).float(), b)
        hi, lo = _split_bf16(a)
        return torch.matmul(hi, b) + torch.matmul(lo, b)

    dq = (product(ds, kf) * scale).to(q.dtype)
    dk = (product(ds.transpose(1, 2), qf) * scale).to(k.dtype)
    dv = product(p.transpose(1, 2), dof).to(v.dtype)
    keys = torch.arange(n, device=q.device)
    dbh = torch.zeros((g, n, h_grid), dtype=torch.float32, device=q.device)
    dbw = torch.zeros((g, n, w_grid), dtype=torch.float32, device=q.device)
    for k0 in range(0, n, 64):
        cols = keys[k0:k0 + 64]
        part = ds[:, :, k0:k0 + 64]
        dbh += torch.zeros_like(dbh).index_add_(2, cols // w_grid, part)
        dbw += torch.zeros_like(dbw).index_add_(2, cols % w_grid, part)
    return dq, dk, dv, dbh, dbw


def flash_attention_relpos(q, k, v, bh, bw, scale, h_grid, w_grid):
    """Exact softmax(q k^T * scale + decomposed rel-pos bias) v, [G, N, D],
    differentiable in q, k, v, bh and bw. The bias is not scaled."""
    return custom_ops.flash_attn_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(),
        bh.float().contiguous(), bw.float().contiguous(), float(scale),
        int(h_grid), int(w_grid))[0]
