"""The native decoder of the host data path: file read, decode, bilinear
resize, flip, channel swap and paste onto the canvas in C++, without the
interpreter lock, so the loader's threads decode in parallel.

Port of the JAX package's native extension (``load_resize_pad``, with its
signature and return value) as ``csrc/native_decode.cpp``, built by the
system C++ compiler at the first decode (``ops/_build.py``
``load_host``), never on import, and called through ``ctypes``, which
releases the interpreter lock during the call.

The loaders follow the JAX package's rule: its extension links libjpeg
and libpng, and where it does not build, the JAX package takes its whole
PIL branch.
- Where libjpeg's and libpng's headers and libraries are installed, the
  core reads and decodes the file itself, as the JAX package's does: its
  output is bitwise equal to it on every PNG and JPEG. ``core()`` returns
  it and ``data/transforms.py`` takes the native branch.
- Where the core does not build with its codecs, ``core()`` is None and
  ``data/transforms.py`` takes its PIL branch (PIL decodes and resizes),
  bitwise the JAX package's PIL branch.

``decoder()`` says which branch the loaders take and why. The resize
samples two taps per axis at half-pixel centres, where PIL's antialiased
bilinear filter takes more when it shrinks: the two branches give
different pixels.

``Core(codecs=False)``, the core without its codecs (PIL decodes, the core
resizes, flips, swaps and pastes), is not a branch of the loaders. It and
its plain version ``load_resize_pad_plain`` are kept to measure the
core's resize on a machine without the codecs.
"""

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from ..ops import _build

SOURCE = "native_decode"
CODEC_FLAGS = ("-DALDI_CODECS", "-ljpeg", "-lpng")

_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_SIZES = [ctypes.c_int] * 6  # short_edge, max_size, canvas h, w, bgr, flip
_OUT = [_u8, _i32, ctypes.POINTER(ctypes.c_double)]


def decode_rgb(path) -> np.ndarray:
    """PIL's decode of ``path`` as the PIL branch does it: [h, w, 3]
    uint8. Raises ``OSError`` naming the path."""
    try:
        with Image.open(path) as im:
            return np.ascontiguousarray(im.convert("RGB"))
    except OSError as e:
        raise OSError(f"failed to read/decode {path}: {e}") from e


class Core:
    """A loaded ``csrc/native_decode.cpp``: with ``codecs`` it reads and
    decodes files with libjpeg and libpng; without, PIL decodes."""

    def __init__(self, codecs: bool):
        self.lib = _build.load_host(SOURCE, CODEC_FLAGS if codecs else ())
        self.codecs = codecs
        if codecs:
            fn = self.lib.aldi_load_resize_pad
            fn.argtypes = [ctypes.c_char_p, *_SIZES, *_OUT]
            fn.restype = ctypes.c_int
        fn = self.lib.aldi_resize_pad
        fn.argtypes = [_u8, ctypes.c_int, ctypes.c_int, *_SIZES, *_OUT]
        fn.restype = ctypes.c_int

    def load_resize_pad(self, path, short_edge: int, max_size: int,
                        canvas_h: int, canvas_w: int, bgr: bool,
                        flip: bool):
        """The JAX package's ``load_resize_pad``: (canvas [canvas_h,
        canvas_w, 3] uint8 zero-padded, out_h, out_w, scale)."""
        canvas = np.zeros((canvas_h, canvas_w, 3), np.uint8)
        hw = np.zeros(2, np.int32)
        scale = ctypes.c_double()
        sizes = (int(short_edge), int(max_size), int(canvas_h),
                 int(canvas_w), int(bool(bgr)), int(bool(flip)))
        if self.codecs:
            rc = self.lib.aldi_load_resize_pad(
                os.fsencode(path), *sizes, canvas, hw, ctypes.byref(scale))
        else:
            rgb = decode_rgb(path)
            rc = self.lib.aldi_resize_pad(rgb, rgb.shape[0], rgb.shape[1],
                                          *sizes, canvas, hw,
                                          ctypes.byref(scale))
        if rc != 0:
            raise OSError(f"failed to read/decode {path}")
        return canvas, int(hw[0]), int(hw[1]), scale.value


_state = {}
_state_lock = threading.Lock()


def _error_line(err: Exception) -> str:
    lines = str(err).splitlines()
    return next((ln.strip() for ln in lines
                 if "error" in ln or "cannot find" in ln),
                lines[0] if lines else repr(err))


def _open() -> dict:
    try:
        return {"core": Core(codecs=True),
                "why": "libjpeg and libpng decode in the core"}
    except (RuntimeError, OSError) as e:
        return {"core": None,
                "why": f"PIL decodes and resizes, as the JAX package does "
                       f"without its extension: the native core did not "
                       f"build with its codecs ({_error_line(e)})"}


def core() -> Optional[Core]:
    """The process's core with its codecs, built and loaded at the first
    call; None if it does not build."""
    with _state_lock:
        if not _state:
            _state.update(_open())
        return _state["core"]


def decoder() -> Tuple[str, str]:
    """The loaders' branch and why: ("native", how it decodes) when the
    core builds with its codecs, else ("pil", the compiler's error)."""
    c = core()
    return ("native" if c is not None else "pil"), _state["why"]


def load_resize_pad(path, short_edge: int, max_size: int, canvas_h: int,
                    canvas_w: int, bgr: bool, flip: bool):
    """Decode ``path``, resize its short edge to ``short_edge`` (the long
    one capped at ``max_size``; the size then clamped to the canvas),
    flip, swap to BGR and paste onto a zeroed canvas, in the core. Returns
    (canvas [canvas_h, canvas_w, 3] uint8, out_h, out_w, scale). Raises
    ``OSError`` naming the path for a missing or undecodable file, and
    ``RuntimeError`` if the core does not build with its codecs."""
    c = core()
    if c is None:
        raise RuntimeError(_state["why"])
    return c.load_resize_pad(path, short_edge, max_size, canvas_h, canvas_w,
                             bgr, flip)


def load_resize_pad_plain(path, short_edge: int, max_size: int,
                          canvas_h: int, canvas_w: int, bgr: bool,
                          flip: bool):
    """The plain version of ``load_resize_pad``: PIL decodes
    (``convert("RGB")``), then numpy resizes, flips, swaps and pastes, in
    float32 with the core's operations in its order. Bitwise equal to the
    core on 8-bit RGB, gray and palette PNGs and on JPEGs; not on RGBA
    PNGs (libpng composites the alpha, PIL drops it) or 16-bit PNGs
    (libpng and PIL reduce them to 8 bits otherwise), where the core with
    its codecs follows libpng."""
    rgb = decode_rgb(path)
    h, w = rgb.shape[:2]
    scale = short_edge / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    out_h = min(int(h * scale + 0.5), canvas_h)
    out_w = min(int(w * scale + 0.5), canvas_w)
    canvas = np.zeros((canvas_h, canvas_w, 3), np.uint8)
    if out_h <= 0 or out_w <= 0:
        return canvas, out_h, out_w, scale
    f32 = np.float32

    def taps(n_out, n_src):
        s = f32(n_src) / f32(n_out)
        f = (np.arange(n_out, dtype=f32) + f32(0.5)) * s - f32(0.5)
        f = np.maximum(f32(0), np.minimum(f, f32(n_src - 1)))
        i0 = f.astype(np.int32)  # truncation: f >= 0
        return i0, np.minimum(i0 + 1, n_src - 1), f - i0.astype(f32)

    y0, y1, ly = taps(out_h, h)
    x0, x1, lx = taps(out_w, w)
    lx = lx[None, :, None]
    ly = ly[:, None, None]

    def row(y):
        r = rgb[y]
        return (r[:, x0].astype(f32) * (f32(1) - lx)
                + r[:, x1].astype(f32) * lx)

    v = row(y0) * (f32(1) - ly) + row(y1) * ly
    out = (v + f32(0.5)).astype(np.uint8)
    if flip:
        out = out[:, ::-1]
    if bgr:
        out = out[:, :, ::-1]
    canvas[:out_h, :out_w] = out
    return canvas, out_h, out_w, scale
