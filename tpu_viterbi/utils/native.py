"""ctypes bindings to the native host-ops library (csrc/host_ops.cpp).

The reference keeps all host-side hot loops (bit packing, BER accounting) in
C++ (src/main.cpp:151-171, src/viterbiDF.h).  This module binds the native
equivalents: BER accounting (used by utils/bits.count_bit_errors whenever
the library builds; NumPy fallback otherwise) and host-IO quantize/pack +
unpack for callers ingesting host-side sample streams (the simulation chain
itself quantizes on device — chain/quantize.py).  The shared library is
built once on demand with g++ -O3 into <repo>/build/ (ignored by git).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _build_and_load() -> Optional[ctypes.CDLL]:
    src = os.path.join(_REPO, "csrc", "host_ops.cpp")
    out = os.path.join(_REPO, "build", "libviterbi_host.so")
    if not os.path.exists(src):
        return None
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src)):
        # build under a private name, then rename: concurrent builders
        # (test workers) never load a half-written library
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", src, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None
    lib.count_bit_errors_u32.restype = ctypes.c_longlong
    lib.count_bit_errors_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
    lib.count_bit_errors_u16.restype = ctypes.c_longlong
    lib.count_bit_errors_u16.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
    lib.quantize_pack_f32.restype = ctypes.c_longlong
    lib.quantize_pack_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_float,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.unpack_soft_words.restype = None
    lib.unpack_soft_words.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
        return _LIB


def native_count_bit_errors(decoded_words: np.ndarray, bits_per_pack: int,
                            ref_bits: np.ndarray) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    ref = np.ascontiguousarray(ref_bits, dtype=np.uint8)
    if bits_per_pack == 32:
        w = np.ascontiguousarray(decoded_words, dtype=np.uint32)
        fn, ptr_t = lib.count_bit_errors_u32, ctypes.c_uint32
    elif bits_per_pack == 16:
        w = np.ascontiguousarray(decoded_words, dtype=np.uint16)
        fn, ptr_t = lib.count_bit_errors_u16, ctypes.c_uint16
    else:
        return None
    return int(fn(w.ctypes.data_as(ctypes.POINTER(ptr_t)), len(w),
                  ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                  len(ref)))


def native_quantize_pack(values: np.ndarray, width: int,
                         scale: float = 1.0) -> Optional[np.ndarray]:
    """Host-side quantize + MSB-first pack of float soft values into int32
    channel words (reference SoftDecisionPacker, src/viterbiDF.h:98-167).
    width: 1 (HARD) / 4 / 8 / 16.  None if the native library is absent."""
    lib = get_lib()
    if lib is None or width not in (1, 4, 8, 16):
        return None
    v = np.ascontiguousarray(values, dtype=np.float32)
    per_word = 32 // width
    out = np.empty((len(v) + per_word - 1) // per_word, dtype=np.int32)
    lib.quantize_pack_f32(v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          len(v), ctypes.c_float(scale), width,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def native_unpack_soft(words: np.ndarray, width: int) -> Optional[np.ndarray]:
    """Packed channel words -> sign-extended int32 soft values (HARD -> +-1);
    the host-side inverse of native_quantize_pack.  None if the native
    library is absent."""
    lib = get_lib()
    if lib is None or width not in (1, 4, 8, 16):
        return None
    w = np.ascontiguousarray(words, dtype=np.int32)
    out = np.empty(len(w) * (32 // width), dtype=np.int32)
    lib.unpack_soft_words(w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                          len(w), width,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
