"""Quantizer / packer and the matching unpackers.

Reference semantics (src/viterbiDF.h:98-167, SoftDecisionPacker):
  - every float is scaled by ``scale`` (40000.0 in the driver, main.cpp:137);
  - HARD:   v > 0 -> 1 else 0 (strict greater-than);
  - SOFT4:  round-to-nearest(-even) then saturate to [-8, 7], keep 4 bits;
  - SOFT8:  saturate to [-128, 127], keep 8 bits;
  - SOFT16: saturate to [-32768, 32767], keep 16 bits;
  - FP32:   scaled floats pass through unpacked;
  - packing is MSB = earliest-in-time into int32 words (viterbiDF.h:157-163).

Rounding: the reference uses lrintf (round half to even in the default FP
environment); jnp.rint matches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ChannelIn
from .pipeline import ComputeElement

_QUANT_PARAMS = {
    ChannelIn.SOFT4: (4, -8, 7),
    ChannelIn.SOFT8: (8, -128, 127),
    ChannelIn.SOFT16: (16, -32768, 32767),
}


def quantize_fields(values: jnp.ndarray, channel_in: ChannelIn,
                    scale: float = 1.0):
    """(n,) float soft values -> ((n,) uint32 masked field values, width).
    The scale/round/saturate/mask stage of the packer without the packing
    (reference: quantFuncs, viterbiDF.h:105-125)."""
    v = values.astype(jnp.float32) * scale
    if channel_in == ChannelIn.HARD:
        return (v > 0.0).astype(jnp.uint32), 1
    width, lo, hi = _QUANT_PARAMS[channel_in]
    q = jnp.clip(jnp.rint(v), lo, hi).astype(jnp.int32)
    return q.astype(jnp.uint32) & jnp.uint32((1 << width) - 1), width


def quantize_and_pack(values: jnp.ndarray, channel_in: ChannelIn,
                      scale: float = 1.0) -> jnp.ndarray:
    """(n,) float soft values -> packed int32 words (or scaled float32 for
    FP32).  n is zero-padded up to a whole number of words."""
    if channel_in == ChannelIn.FP32:
        return values.astype(jnp.float32) * scale

    q, width = quantize_fields(values, channel_in, scale)
    per_word = 32 // width
    n = values.shape[0]
    n_pad = (-n) % per_word
    if n_pad:
        q = jnp.pad(q, (0, n_pad))
    return pack_words(q, width).astype(jnp.int32)


def _pack_matrices(width: int):
    """Banded constant matrices for matmul-based word packing: W[l*pw+j, l]
    holds the power-of-two weight of field j of word l of a 128-word row
    (hi/lo 16-bit halves separately so every f32 sum stays exact < 2^16)."""
    pw = 32 // width
    half = pw // 2
    whi = np.zeros((pw * 128, 128), np.float32)
    wlo = np.zeros((pw * 128, 128), np.float32)
    for lane in range(128):
        for j in range(half):
            whi[lane * pw + j, lane] = 2.0 ** (width * (half - 1 - j))
        for j in range(half, pw):
            wlo[lane * pw + j, lane] = 2.0 ** (width * (pw - 1 - j))
    return whi, wlo


def _pack_precision(width: int):
    """Matmul precision for the banded pack matmuls.  Fields of width w
    are integers < 2^w and the per-half weighted sums stay < 2^16.  At
    DEFAULT precision a GPU runs f32 matmuls in TF32 (10 explicit
    significand bits) with f32 accumulation: with w <= 8 every operand and
    every product f * 2^k is exact in TF32, and every partial sum is an
    integer below 2^16, exact in f32 — so DEFAULT is exact.  16-bit fields
    (SOFT16) need HIGHEST (0xD9C2 does not fit TF32's significand).
    Exactness is checked by tests/test_chain.py pack round-trips on the
    CPU and by chip_smoke.py against a shift-or packer on the card."""
    return (jax.lax.Precision.HIGHEST if width > 8
            else jax.lax.Precision.DEFAULT)


def pack_words(q: jnp.ndarray, width: int) -> jnp.ndarray:
    """(n,) uint field values (already masked to `width` bits) -> packed
    uint32 words, MSB = earliest.

    Formulation: the bit-packing is one matmul per 16-bit half against a
    banded power-of-two matrix, with every tensor keeping a 128-wide minor
    dimension (the reference packer is a scalar shift-or loop,
    viterbiDF.h:157-163)."""
    per_word = 32 // width
    if per_word == 1:
        return q.astype(jnp.uint32)
    n = q.shape[0]
    n_words = n // per_word
    span = 128 * per_word
    n_pad = (-n) % span
    qf = q.astype(jnp.float32)
    if n_pad:
        qf = jnp.concatenate([qf, jnp.zeros((n_pad,), jnp.float32)])
    q3 = qf.reshape(-1, span)
    whi, wlo = _pack_matrices(width)
    prec = _pack_precision(width)   # exactness argument: _pack_precision
    hi = jnp.dot(q3, jnp.asarray(whi), preferred_element_type=jnp.float32,
                 precision=prec)
    lo = jnp.dot(q3, jnp.asarray(wlo), preferred_element_type=jnp.float32,
                 precision=prec)
    words = (hi.astype(jnp.uint32) << 16) | lo.astype(jnp.uint32)
    return words.reshape(-1)[:n_words]


def _pack_matrices_strided(width: int, stream: int):
    """Banded matrices like _pack_matrices, but placing this stream's value
    j into field 2j+stream of each word (the interleave [out0, out1] per
    stage, viterbiDF.h:157-163, ridden on the pack matmul so the
    interleaved value stream never materializes)."""
    vpw = 32 // width
    p = vpw // 2
    whi = np.zeros((p * 128, 128), np.float32)
    wlo = np.zeros((p * 128, 128), np.float32)
    for lane in range(128):
        for j in range(p):
            field = 2 * j + stream
            low_bit = 32 - (field + 1) * width
            if low_bit >= 16:
                whi[lane * p + j, lane] = 2.0 ** (low_bit - 16)
            else:
                wlo[lane * p + j, lane] = 2.0 ** low_bit
    return whi, wlo


def pack_words_2streams(q0: jnp.ndarray, q1: jnp.ndarray,
                        width: int) -> jnp.ndarray:
    """Two (n,) masked field streams (even/odd stage positions) -> packed
    uint32 words of the interleaved stream [q0[0], q1[0], q0[1], q1[1], ...],
    MSB = earliest.  Equals pack_words(interleave(q0, q1), width) without
    ever forming the (n, 2) pair array."""
    vpw = 32 // width
    p = vpw // 2
    n = q0.shape[0]
    n_words = -(-2 * n // vpw)
    span = 128 * p
    n_pad = (-n) % span
    word_acc = None
    for stream, q in enumerate((q0, q1)):
        qf = q.astype(jnp.float32)
        if n_pad:
            qf = jnp.concatenate([qf, jnp.zeros((n_pad,), jnp.float32)])
        q3 = qf.reshape(-1, span)
        whi, wlo = _pack_matrices_strided(width, stream)
        prec = _pack_precision(width)   # see _pack_precision
        hi = jnp.dot(q3, jnp.asarray(whi),
                     preferred_element_type=jnp.float32,
                     precision=prec)
        lo = jnp.dot(q3, jnp.asarray(wlo),
                     preferred_element_type=jnp.float32,
                     precision=prec)
        words = (hi.astype(jnp.uint32) << 16) | lo.astype(jnp.uint32)
        word_acc = words if word_acc is None else (word_acc | words)
    return word_acc.reshape(-1)[:n_words]


def _interleave_matrices():
    """One-hot scatter matrices for the f32 stream interleave: S[j, 2j+s]=1
    places value j of stream s into interleaved position 2j+s per 128-wide
    output row."""
    s0 = np.zeros((64, 128), np.float32)
    s1 = np.zeros((64, 128), np.float32)
    for j in range(64):
        s0[j, 2 * j] = 1.0
        s1[j, 2 * j + 1] = 1.0
    return s0, s1


def interleave_2streams_f32(x0: jnp.ndarray, x1: jnp.ndarray) -> jnp.ndarray:
    """Two (n,) float32 streams -> the (2n,) interleaved stream
    [x0[0], x1[0], x1[1], ...] (the FP32 channel's wire format, dpp=1;
    viterbiDF.h:157-163 interleave order) without forming the (n, 2) pair
    array.  One matmul per stream against a one-hot scatter matrix; at
    HIGHEST precision every output is an exact copy of one input."""
    n = x0.shape[0]
    n_pad = (-n) % 64
    if n_pad:
        z = jnp.zeros((n_pad,), jnp.float32)
        x0 = jnp.concatenate([x0.astype(jnp.float32), z])
        x1 = jnp.concatenate([x1.astype(jnp.float32), z])
    s0, s1 = _interleave_matrices()
    y = (jnp.dot(x0.astype(jnp.float32).reshape(-1, 64), jnp.asarray(s0),
                 preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST) +
         jnp.dot(x1.astype(jnp.float32).reshape(-1, 64), jnp.asarray(s1),
                 preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST))
    return y.reshape(-1)[: 2 * n]


def unpack_to_soft(packed: jnp.ndarray, channel_in: ChannelIn) -> jnp.ndarray:
    """Packed words -> per-value soft array.

    HARD   -> int32 in {-1, +1} (BPSK re-map of the hard bits)
    SOFT4  -> int32 in [-8, 7]      (sign-extended nibbles)
    SOFT8  -> int32 in [-128, 127]
    SOFT16 -> int32 in [-32768, 32767]
    FP32   -> float32 clamped to [-2^(FPprecision-1), 2^(FPprecision-1)-1]
              (clamp semantics of the reference kernel, viterbiBM.cuh:139-151)
    """
    if channel_in == ChannelIn.FP32:
        from ..config import FP_PRECISION
        lo = -(1 << (FP_PRECISION - 1))
        hi = (1 << (FP_PRECISION - 1)) - 1
        return jnp.clip(packed.astype(jnp.float32), lo, hi)

    words = packed.astype(jnp.int32).view(jnp.uint32)
    if channel_in == ChannelIn.HARD:
        width = 1
    else:
        width = _QUANT_PARAMS[channel_in][0]
    per_word = 32 // width
    shifts = jnp.arange(per_word - 1, -1, -1, dtype=jnp.uint32) * width
    vals = (words[:, None] >> shifts[None, :]) & jnp.uint32((1 << width) - 1)
    vals = vals.reshape(-1).astype(jnp.int32)
    if channel_in == ChannelIn.HARD:
        return vals * 2 - 1
    half = 1 << (width - 1)
    return ((vals + half) & ((1 << width) - 1)) - half  # sign extend


def unpack_to_soft_np(packed: np.ndarray, channel_in: ChannelIn) -> np.ndarray:
    """NumPy twin of unpack_to_soft for the golden model."""
    if channel_in == ChannelIn.FP32:
        from ..config import FP_PRECISION
        lo = -(1 << (FP_PRECISION - 1))
        hi = (1 << (FP_PRECISION - 1)) - 1
        return np.clip(np.asarray(packed, dtype=np.float32), lo, hi)
    words = np.asarray(packed).astype(np.int64) & 0xFFFFFFFF
    width = 1 if channel_in == ChannelIn.HARD else _QUANT_PARAMS[channel_in][0]
    per_word = 32 // width
    shifts = (np.arange(per_word)[::-1] * width)
    vals = ((words[:, None] >> shifts[None, :]) & ((1 << width) - 1)).reshape(-1)
    if channel_in == ChannelIn.HARD:
        return (vals * 2 - 1).astype(np.int32)
    half = 1 << (width - 1)
    return (((vals + half) & ((1 << width) - 1)) - half).astype(np.int32)


class SoftDecisionPacker(ComputeElement):
    def __init__(self, channel_in: ChannelIn, scale: float = 1.0):
        super().__init__()
        self.channel_in = ChannelIn(channel_in)
        self.scale = float(scale)

    def process(self, soft_values):
        return quantize_and_pack(soft_values, self.channel_in, self.scale)
