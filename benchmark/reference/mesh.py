"""World 1 of the port's process grid: what ``parallel/mesh.py`` gives a
single process. Counts and batches are the process's own, and nothing is
reduced across ranks."""

import torch


def global_count(x: torch.Tensor) -> torch.Tensor:
    return x


def global_batch(n: int) -> int:
    return n


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean()


def sum_of_squares(params) -> torch.Tensor:
    """The squared global norm of the gradients of ``params``."""
    return sum((p.grad.to(torch.float32) ** 2).sum() for p in params
               if p.grad is not None)
