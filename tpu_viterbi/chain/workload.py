"""Production-scale workload builder: bits -> packed channel words with
flat layouts end to end.

The element pipeline (source | encoder | noise | packer) is the semantic
reference and mirrors the reference driver (src/main.cpp:131-141), but it
materializes the interleaved (n, 2) value stream on the way.

This builder never forms the interleaved stream: the encoder's two parity
streams (conv_encode_streams) are BPSK-mapped, noised, and quantized as
flat (n,) arrays, then packed directly into the interleaved word format by
two strided banded-matrix matmuls (pack_words_2streams) — one matmul pass
per stream, bit-identical words.

Equality with the element pipeline: exact when noiseless (same bits, same
deterministic math; locked by tests/test_chain.py); under noise the draws
are assigned per-stream instead of per-interleaved-position, so streams
are statistically identical but not bitwise (both are AWGN of the same
sigma — the BER curve is unchanged).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..config import ChannelIn
from .channel import snr_to_sigma
from .encode import conv_encode_streams
from .quantize import pack_words_2streams, quantize_fields
from .source import random_bits


def packed_workload(key: jax.Array, n: int, channel_in: ChannelIn,
                    snr_db: float, scale: float):
    """-> (message_bits (n,) uint8, packed channel words).

    snr_db = math.inf means a noiseless channel.  FP32 channel returns the
    scaled float value stream (dpp=1 wire format): the two parity streams
    are noised flat and interleaved by one-hot matmuls
    (interleave_2streams_f32) — no (n, 2) pair array at any point."""
    k1, k2, k3 = jax.random.split(key, 3)
    bits = random_bits(k1, n)
    sigma = 0.0 if math.isinf(snr_db) else snr_to_sigma(snr_db)

    out0, out1 = conv_encode_streams(bits)
    sym_streams = []
    for k, out in ((k2, out0), (k3, out1)):
        sym = out.astype(jnp.float32) * 2.0 - 1.0
        if sigma:
            sym = sym + sigma * jax.random.normal(k, sym.shape,
                                                  dtype=jnp.float32)
        sym_streams.append(sym)

    if channel_in == ChannelIn.FP32:
        from .quantize import interleave_2streams_f32
        packed = interleave_2streams_f32(sym_streams[0] * scale,
                                         sym_streams[1] * scale)
        return bits, packed

    q_streams = []
    for sym in sym_streams:
        q, width = quantize_fields(sym, channel_in, scale)
        q_streams.append(q)
    packed = pack_words_2streams(q_streams[0], q_streams[1], width)
    return bits, packed.astype(jnp.int32)


def ref_words_from_packs(bit_packs: jnp.ndarray, extra_l: int,
                         message_len: int) -> jnp.ndarray:
    """Aligned message-bit packs -> ground-truth decoded words: decoded
    bit i = message bit i + extra_l (main.cpp:160-161), 32-bit packs,
    MSB = earliest.  A one-word shift-combine, so a sharded stream only
    trades one boundary word with its neighbour."""
    nw = message_len // 32
    lo_shift = 32 - extra_l
    w = bit_packs.view(jnp.uint32) if bit_packs.dtype == jnp.int32 \
        else bit_packs.astype(jnp.uint32)
    need = nw + 1
    if w.shape[0] < need:
        w = jnp.concatenate([w, jnp.zeros((need - w.shape[0],), w.dtype)])
    return ((w[:nw] << extra_l) |
            (w[1:nw + 1] >> lo_shift)).astype(jnp.uint32)
