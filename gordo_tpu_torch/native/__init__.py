"""
The request codec's native library, bound with ctypes: the port's
counterpart of ``gordo_tpu/native/`` for the serving path.

``gordo_native.cpp`` is the port's own copy of the C++ source. It is
compiled with ``g++ -O3 -std=c++17 -shared -fPIC`` at first use into
``build/gordo_tpu_torch/native/<hash>/libgordo_native.so`` beside the
package, where ``<hash>`` covers the source, the compiler's identity and
the flags: a changed source or toolchain builds anew, an unchanged one is
loaded as built. The library is written under a temporary name and renamed
into place, so a concurrent builder never loads a half-written file. A
failed build raises with the compiler's output; there is no quiet fallback
to Python (``GORDO_TPU_FAST_CODEC=0`` is the one switch to the dict path,
server/fast_codec.py).

Bound here: :func:`parse_xy`, :func:`parse_columns` and
:func:`encode_template`. The source's ``gordo_resample`` and
``gordo_rolling_min_max`` are built but not bound yet: the dataset and
threshold call sites that use them in the JAX package are not ported
(ROADMAP.md queue A10).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "gordo_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gordo_tpu_torch" / "native"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_encode_tpl = None  # the PYFUNCTYPE binding of gordo_encode_tpl

_P_F64 = ctypes.POINTER(ctypes.c_double)
_P_I64 = ctypes.POINTER(ctypes.c_int64)
_P_I32 = ctypes.POINTER(ctypes.c_int32)


def _compiler_id() -> bytes:
    """The first line of ``g++ --version``: a toolchain change builds anew."""
    proc = subprocess.run(["g++", "--version"], capture_output=True, timeout=30, check=True)
    return proc.stdout.splitlines()[0]


def library_path() -> Path:
    """Where the library of this source, compiler and flags is built."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(b"\0" + _compiler_id() + b"\0" + " ".join(FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libgordo_native.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp-{os.getpid()}-{threading.get_ident()}.so")
    proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed on {SRC.name} ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib, _encode_tpl
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.gordo_parse_xy.restype = ctypes.c_int32
        lib.gordo_parse_xy.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _P_F64, ctypes.c_int64, _P_I64,
            _P_F64, ctypes.c_int64, _P_I64,
        ]
        lib.gordo_parse_body_cols.restype = ctypes.c_int32
        lib.gordo_parse_body_cols.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _P_F64, ctypes.c_int64, _P_I64, _P_I32,
            ctypes.c_int64, _P_I64, _P_I32, ctypes.c_int64, _P_I64,
        ]
        # the encoder calls CPython's float formatter, which needs the GIL:
        # a PYFUNCTYPE binding keeps it held across the call
        encode = ctypes.PYFUNCTYPE(
            ctypes.c_int64, ctypes.c_char_p, _P_I32, ctypes.c_int64, _P_F64,
            ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
        )
        _encode_tpl = encode(("gordo_encode_tpl", lib))
        _lib = lib
        return lib


def _ptr(array: np.ndarray, kind):
    return array.ctypes.data_as(kind)


def parse_xy(body: bytes):
    """Strict one-pass parse of a ``{"X": [[...]], "y": [[...]]}`` body
    (``y`` absent or null allowed) into float64 matrices: ``(X, y)`` with
    ``y`` None when absent, or None when the body is not of that grammar
    (extra or repeated keys, escaped key spellings, ragged rows, trailing
    bytes): the caller then parses it with ``json``."""
    lib = load()
    body = bytes(body)
    # every value costs at least two body bytes, which bounds the count
    cap = len(body) // 2 + 8
    xbuf = np.empty(cap, np.float64)
    ybuf = np.empty(cap, np.float64)
    xshape = (ctypes.c_int64 * 2)()
    yshape = (ctypes.c_int64 * 2)()
    rc = lib.gordo_parse_xy(body, len(body), _ptr(xbuf, _P_F64), cap, xshape,
                            _ptr(ybuf, _P_F64), cap, yshape)
    if rc != 1:
        return None
    X = xbuf[: xshape[0] * xshape[1]].reshape(xshape[0], xshape[1])
    y = None
    if yshape[0] >= 0:
        y = ybuf[: yshape[0] * yshape[1]].reshape(yshape[0], yshape[1])
    return X, y


def parse_columns(body: bytes):
    """Strict one-pass parse of a flat column-dict body
    ``{"X": {name: {key: num, ...}, ...}}`` (``y`` absent or null):
    ``(values, names, keys)`` with values (n_rows, n_cols) in the body's
    column order, or None when the body is not of that grammar (columns
    with other key sequences, escaped spellings, repeated names or keys)."""
    lib = load()
    body = bytes(body)
    # every cell costs at least six body bytes, every name or key three
    cap = len(body) // 4 + 8
    vals = np.empty(cap, np.float64)
    key_off = np.empty(cap, np.int64)
    key_len = np.empty(cap, np.int32)
    name_off = np.empty(cap, np.int64)
    name_len = np.empty(cap, np.int32)
    shape = (ctypes.c_int64 * 2)()
    rc = lib.gordo_parse_body_cols(
        body, len(body), _ptr(vals, _P_F64), cap, _ptr(key_off, _P_I64),
        _ptr(key_len, _P_I32), cap, _ptr(name_off, _P_I64), _ptr(name_len, _P_I32), cap,
        shape,
    )
    if rc != 1:
        return None
    rows, cols = shape[0], shape[1]
    # filled column by column: the transpose is a view
    values = vals[: rows * cols].reshape(cols, rows).T
    try:
        names = [body[name_off[c]: name_off[c] + name_len[c]].decode() for c in range(cols)]
        keys = [body[key_off[r]: key_off[r] + key_len[r]].decode() for r in range(rows)]
    except UnicodeDecodeError:  # json would refuse it too: let it say so
        return None
    return values, names, keys


def encode_template(template: bytes, pre_lens: np.ndarray, values: np.ndarray
                    ) -> Optional[bytes]:
    """``template``'s byte chunks interleaved with ``values`` formatted as
    ``repr(float)`` formats them (CPython's own shortest-repr digits, so the
    bytes are those ``json.dumps`` writes), non-finite values as ``null``.
    ``pre_lens`` (int32, ``len(values) + 1`` entries) are the chunk lengths
    before each value and after the last. None if the rendering failed."""
    load()
    values = np.ascontiguousarray(values, np.float64)
    pre_lens = np.ascontiguousarray(pre_lens, np.int32)
    if len(pre_lens) != len(values) + 1:
        raise ValueError(
            f"pre_lens must have len(values) + 1 entries: {len(pre_lens)} vs {len(values)}"
        )
    cap = len(template) + 32 * len(values) + 64
    out = ctypes.create_string_buffer(cap)
    written = _encode_tpl(template, _ptr(pre_lens, _P_I32), len(values),
                          _ptr(values, _P_F64), out, cap)
    if written <= 0:
        return None
    return ctypes.string_at(out, written)
