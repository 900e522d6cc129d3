"""Faults planted in the timed path underneath a run, for the tests that
see ``correct`` come out false: ``fault(step_or_fn) -> broken``."""

import torch


def unchanged(step):
    """A DAOD step that returns its state unchanged (the student's and the
    teacher's parameters as they were)."""
    def broken(state, batch, draws, mark=None):
        mods = [m for m in (state.student, state.teacher) if m is not None]
        saved = [[p.detach().clone() for p in m.parameters()] for m in mods]
        state, metrics = step(state, batch, draws, mark=mark)
        with torch.no_grad():
            for m, ps in zip(mods, saved):
                for p, s in zip(m.parameters(), ps):
                    p.copy_(s)
        return state, metrics
    return broken


def teacher_frozen(step):
    """A DAOD step whose EMA teacher is never updated (its parameters as
    they were before the step)."""
    def broken(state, batch, draws, mark=None):
        saved = [p.detach().clone() for p in state.teacher.parameters()]
        state, metrics = step(state, batch, draws, mark=mark)
        with torch.no_grad():
            for p, s in zip(state.teacher.parameters(), saved):
                p.copy_(s)
        return state, metrics
    return broken


def _half(tree, last=False):
    """The first half of the batch of every tensor: on the first axis, or
    on the last for drop-path masks ([2, depth, B])."""
    if isinstance(tree, dict):
        return {k: _half(v, k == "drop") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_half(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.dim():
        axis = -1 if last else 0
        return tree.narrow(axis, 0, max(tree.shape[axis] // 2, 1))
    return tree


def half_batch(step):
    """A DAOD step that leaves out the second half of each batch (the
    mean taken over the rest)."""
    def broken(state, batch, draws, mark=None):
        return step(state, _half(batch), _half(draws), mark=mark)
    return broken


def altered_answer(fn):
    """A serving call whose answer for the request's first image is
    altered: each of its detections has the next class."""
    def broken(images, sizes):
        out = dict(fn(images, sizes))
        classes = out["classes"].clone()
        classes[0] = (classes[0] + 1) % 8
        out["classes"] = classes
        return out
    return broken


def half_request(fn):
    """A serving call that answers the second half of a request's images
    with the first half's detections."""
    def broken(images, sizes):
        out = fn(images, sizes)
        b = out["scores"].shape[0]
        return {k: torch.cat([v[:b // 2], v[:b - b // 2]])
                for k, v in out.items()}
    return broken


def no_detections(fn):
    """A serving call that answers with no detection at all."""
    def broken(images, sizes):
        out = dict(fn(images, sizes))
        out["valid"] = torch.zeros_like(out["valid"])
        return out
    return broken


def duplicates(fn):
    """A serving call that answers the second half of each image's
    detections with copies of the first half's (NMS skipped)."""
    def broken(images, sizes):
        out = fn(images, sizes)
        d = out["scores"].shape[1]
        return {k: torch.cat([v[:, :d - d // 2], v[:, :d // 2]], 1)
                for k, v in out.items()}
    return broken
