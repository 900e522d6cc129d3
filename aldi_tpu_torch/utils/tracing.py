"""Profiler ranges where the port's work happens.

``span(name)`` marks a stage (``aldi/<name>``) and ``sync(site)`` a place
where the host waits on the device (``aldi/sync/<site>``, one range a wait,
named by what it reads or copies: a device value read back, or a copy to
the device that returns only once it is done). Each returns a context
manager. While a profiler of ``torch.autograd`` records
(``torch.profiler.profile``, the trainer's ``TPU.PROFILE_DIR`` trace, the
benchmark's traced window), it is a range of that profiler: a ``cpu_op``
event (the category of PyTorch's operators) in the same Kineto trace as
the device work and on its clock, so the runtime calls made inside it,
and through their correlation ids the kernels, copies and memsets they
launched, fall inside it. Otherwise, and while
``torch.compile`` or ``torch.export`` traces (an exported program holds no
profiler op), it is one shared object that does nothing: a call costs the
flag test alone. The profiler being on is the only switch.
"""

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "sync"]

# PyTorch's cheap profiler range: a ``cpu_op`` event, entered without
# going through the dispatcher (``record_function`` is a ``user_annotation``
# event and costs about five times as much)
_Range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The range while no profiler records: enters and leaves."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _on() -> bool:
    # the profiler's own flag: a plain attribute read
    return (_profiler._is_profiler_enabled
            and not torch.compiler.is_compiling()
            and not torch.compiler.is_exporting())


def span(name: str):
    """The range ``aldi/<name>`` around a stage's work, or ``OFF``."""
    return _Range("aldi/" + name) if _on() else OFF


def sync(site: str):
    """The range ``aldi/sync/<site>`` around one wait of the host on the
    device (a read of a device value or a copy to it), or ``OFF``."""
    return _Range("aldi/sync/" + site) if _on() else OFF
