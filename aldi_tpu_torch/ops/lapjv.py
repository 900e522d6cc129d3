"""Min-cost assignment by Jonker-Volgenant shortest augmenting paths.

Counterpart of ``aldi_tpu/ops/lapjv.py``: ``lapjv_plain`` is a PyTorch
transcription of its ``lapjv`` (``:97``, with ``_assign_one_row`` at
``:29``), batched over P problems: the same Dijkstra from each row in index
order, the same float32 reduced costs ``minv + cost[i] - u[i] - v`` in that
order, the same tie-break among the minimal columns (the first unassigned
one if any, else the lowest index), the same dual update and augmentation.
Rows at or beyond a problem's ``n_rows`` stay -1. It runs on any device,
one host round trip per Dijkstra settle, which on the card would be
thousands per criterion call: ``lapjv`` sends a CUDA tensor to the kernel
K4 (``csrc/lapjv.cu``, ``lapjv_kernel.py``) through the custom op
``aldi_tpu_torch::lapjv`` (``custom_ops.py``), a CPU tensor to
``lapjv_plain``, and never falls back from one to the other. Both also
return the number of settles each problem took.
"""

import torch


@torch.no_grad()
def lapjv_plain(cost: torch.Tensor, n_rows: torch.Tensor):
    """cost [P, n, m] (n <= m, finite) and n_rows [P] -> (col4row [P, n]
    int32, the column of each of the first ``n_rows`` rows and -1 beyond;
    settles [P] int32)."""
    p, n, m = cost.shape
    if n > m:
        raise ValueError(f"lapjv requires n <= m, got {tuple(cost.shape)}")
    dev = cost.device
    cost = cost.to(torch.float32)
    limit = n_rows.to(device=dev, dtype=torch.int64).clamp(0, n)
    ar = torch.arange(p, device=dev)
    inf = torch.full((), torch.inf, device=dev)
    u = torch.zeros((p, n), device=dev)
    v = torch.zeros((p, m), device=dev)
    row4col = torch.full((p, m), -1, dtype=torch.int64, device=dev)
    col4row = torch.full((p, n), -1, dtype=torch.int64, device=dev)
    settles = torch.zeros(p, dtype=torch.int32, device=dev)
    cols = torch.arange(m, device=dev).expand(p, m)
    for cur in range(int(limit.max()) if p else 0):
        active = cur < limit
        # Dijkstra from row ``cur``: settle columns until the nearest
        # frontier column is unassigned
        i = torch.full((p,), cur, dtype=torch.int64, device=dev)
        minv = torch.zeros(p, device=dev)
        spc = torch.full((p, m), torch.inf, device=dev)
        path = torch.full((p, m), -1, dtype=torch.int64, device=dev)
        settled = torch.zeros((p, m), dtype=torch.bool, device=dev)
        sink = torch.full((p,), -1, dtype=torch.int64, device=dev)
        searching = active.clone()
        while bool(searching.any()):
            red = minv[:, None] + cost[ar, i] - u[ar, i][:, None] - v
            better = (red < spc) & ~settled & searching[:, None]
            path = torch.where(better, i[:, None], path)
            spc = torch.where(better, red, spc)
            masked = torch.where(settled, inf, spc)
            best = masked.min(1, keepdim=True).values
            tie = masked == best
            tie_un = tie & (row4col == -1)
            first = torch.where(tie_un.any(1, keepdim=True), tie_un, tie)
            j = torch.where(first, cols, m).min(1).values
            settled[ar[searching], j[searching]] = True
            minv = torch.where(searching, masked[ar, j], minv)
            owner = row4col[ar, j]
            found = searching & (owner < 0)
            sink = torch.where(found, j, sink)
            i = torch.where(searching & ~found, owner, i)
            settles += searching.to(torch.int32)
            searching &= ~found
        # dual update: the scanned rows are ``cur`` and the owners of the
        # settled assigned columns
        take = settled & (row4col >= 0) & active[:, None]
        owner = torch.where(take, row4col, n)
        scanned = torch.zeros((p, n + 1), dtype=torch.bool, device=dev)
        scanned.scatter_(1, owner, take)
        scanned[:, n] = False
        scanned[ar, cur] |= active
        spc_at_row = torch.zeros((p, n + 1), device=dev).scatter_(
            1, owner, torch.where(take, spc, 0.0))
        u = torch.where(scanned[:, :n], u + minv[:, None] - spc_at_row[:, :n],
                        u)
        v = torch.where(settled & active[:, None], v + spc - minv[:, None], v)
        # augment: walk the predecessor rows back from the sink
        j = sink
        while bool((j >= 0).any()):
            walk = j >= 0
            jj = j.clamp(min=0)
            r = path[ar, jj]
            row4col[ar[walk], jj[walk]] = r[walk]
            rr = r.clamp(min=0)
            j_next = col4row[ar, rr]
            col4row[ar[walk], rr[walk]] = jj[walk]
            j = torch.where(walk, j_next, j)
    return col4row.to(torch.int32), settles


def lapjv(cost: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    """``lapjv_plain``'s col4row [P, n] int32 for cost [P, n, m] and n_rows
    [P]: K4 for CUDA tensors, the plain version for CPU tensors."""
    from . import custom_ops

    return custom_ops.lapjv(cost, n_rows.to(torch.int32))[0]


def solve_assignment(cost: torch.Tensor):
    """scipy-like interface on one [n, m] problem with any n, m: (row_idx,
    col_idx) int32 of length min(n, m), sorted by row index."""
    n, m = cost.shape
    if n <= m:
        col4row = lapjv(cost[None], torch.tensor([n], device=cost.device))[0]
        return torch.arange(n, dtype=torch.int32, device=cost.device), col4row
    row4col = lapjv(cost.T[None], torch.tensor([m], device=cost.device))[0]
    order = torch.argsort(row4col, stable=True)
    return (row4col[order],
            torch.arange(m, dtype=torch.int32, device=cost.device)[order])
