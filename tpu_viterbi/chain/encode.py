"""Convolutional encoder, fully vectorized (no Python loop over bits).

Reference semantics (src/viterbiDF.h:36-63): a K-bit shift register where the
newest bit enters at bit K-1 (`buffer >>= 1; buffer |= bit << (K-1)`), two
parity outputs per input bit from XOR-popcount of `buffer & poly{1,2}`, coded
output interleaved [out0, out1] per stage with poly 0o171 first, and the
register starting at zero (bits before t=0 are 0).

Vectorized formulation: out_k[t] = XOR over tap offsets d of bit[t-d], which
we compute with shifted views of the zero-padded bit array — one vector XOR
per polynomial tap, O(K) vector ops total for the whole message.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import CONST_LEN, POLY1, POLY2
from .pipeline import ComputeElement


def _tap_offsets(poly: int) -> list:
    """Delay d of each tap: reference buffer bit (K-1-d) holds input bit t-d."""
    return [CONST_LEN - 1 - b for b in range(CONST_LEN) if (poly >> b) & 1]


_TAPS0 = _tap_offsets(POLY1)
_TAPS1 = _tap_offsets(POLY2)


def conv_encode_streams(bits: jnp.ndarray):
    """Encode (n,) {0,1} bits -> two (n,) parity streams (out0, out1),
    NOT interleaved.  Both streams stay flat; chain/workload.py packs
    them into interleaved words without ever forming the value stream."""
    bits = bits.astype(jnp.uint8)
    n = bits.shape[0]
    padded = jnp.pad(bits, (CONST_LEN - 1, 0))  # bits[t-d] with zeros for t<d

    def parity(taps):
        acc = jnp.zeros((n,), dtype=jnp.uint8)
        for d in taps:
            acc = acc ^ padded[CONST_LEN - 1 - d: CONST_LEN - 1 - d + n]
        return acc

    return parity(_TAPS0), parity(_TAPS1)


def conv_encode(bits: jnp.ndarray) -> jnp.ndarray:
    """Encode (n,) {0,1} bits -> (2n,) coded bits, interleaved [out0, out1].

    Fine up to a few tens of Mb; at production scale prefer
    chain/workload.py, which avoids the padded (n, 2) intermediate."""
    out0, out1 = conv_encode_streams(bits)
    n = out0.shape[0]
    return jnp.stack([out0, out1], axis=1).reshape(2 * n)


def conv_encode_np(bits: np.ndarray) -> np.ndarray:
    """NumPy twin of conv_encode for golden-model tests."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[0]
    padded = np.pad(bits, (CONST_LEN - 1, 0))

    def parity(taps):
        acc = np.zeros((n,), dtype=np.uint8)
        for d in taps:
            acc ^= padded[CONST_LEN - 1 - d: CONST_LEN - 1 - d + n]
        return acc

    out = np.empty(2 * n, dtype=np.uint8)
    out[0::2] = parity(_TAPS0)
    out[1::2] = parity(_TAPS1)
    return out


class ConvolutionalEncoder(ComputeElement):
    def __init__(self, const_len: int = CONST_LEN, poly1: int = POLY1,
                 poly2: int = POLY2):
        super().__init__()
        if (const_len, poly1, poly2) != (CONST_LEN, POLY1, POLY2):
            raise NotImplementedError(
                "framework is specialized for K=7, polys 0o171/0o133 "
                "(matching the reference build)")

    def process(self, bits):
        return conv_encode(bits)
