"""Fully in-graph sharded simulation: workload generation + decode + BER
accounting on the device mesh, with no host data movement.

The reference pipeline builds the whole workload on the host and copies it
to the device (src/main.cpp:119-172, src/viterbiDF.h). At scale that
plumbing becomes the bottleneck (SURVEY.md §7.3 #6): gigabytes of packed
input would cross the host link just to be decoded in milliseconds. The
answer here is to keep the entire chain

    key -> message bits -> conv encode -> AWGN -> quantize/pack
        -> sharded decode (shard_map + ppermute halo)
        -> on-device bit-error count

inside ONE jitted program over the mesh. Generation is counter-mode (the
element chain with the partitionable threefry lowering, enabled in
tpu_viterbi/__init__.py), so every device computes exactly its slice of
the *same* global random stream a single-device run would draw
(bit-identical across mesh shapes, which the tests exploit). The only
cross-device traffic is the tiny edge realignment of the encoder's
K-1-bit shifted views, the 64-stage decode halo (one ppermute), and the
scalar BEN all-reduce.

Only two int32 scalars (BEN, checksum-free message length is static) leave
the device per simulated message.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..chain.quantize import pack_words
from ..chain.workload import packed_workload, ref_words_from_packs
from ..config import ChannelIn, DecoderConfig
from ..decoder.api import DEFAULT_DEC_LEN
from .blocks import build_sharded_decoder, sharded_stage_count
from .mesh import BLOCK_AXIS

# channel scale the CLI driver uses per input format (reference scale
# 40000.0 saturates every soft format at main.cpp:137; these keep the soft
# field in range so the BER waterfall is meaningful — see bench/ber_curve.py)
DEFAULT_SCALES = {
    ChannelIn.HARD: 1.0,
    ChannelIn.SOFT4: 4.0,
    ChannelIn.SOFT8: 32.0,
    ChannelIn.SOFT16: 8192.0,
    ChannelIn.FP32: 4.0,
}


def _ref_words32(bits: jnp.ndarray, cfg: DecoderConfig,
                 m32: int) -> jnp.ndarray:
    """Ground-truth decoded stream as 32-bit packs covering m32 decoded
    bits (a multiple of 32, >= get_message_len; decoded bit i equals
    message bit i + extra_l, MSB earliest — main.cpp:160-161).  The bpp=16
    comparison happens against these 32-bit packs directly (see simulate).

    Order matters for scaling: pack the bit stream at its ALIGNED
    positions first (shard-local matmuls), then apply the extra_l shift in
    pack space (ref_words_from_packs: one-word shift-combine whose only
    cross-shard traffic is a single boundary word).  Slicing
    bits[extra_l:] before packing misaligns every shard and made GSPMD
    all-gather the full f32 stream — caught by the collective census audit
    (sharding/audit.py; tests/test_scaling_structure.py locks it out)."""
    packs = pack_words(bits.astype(jnp.uint32), 1)
    return ref_words_from_packs(packs, cfg.extra_l, m32)


def build_sharded_simulation(cfg: DecoderConfig, message_len: int, mesh,
                             snr_db: float = 5.5, scale: float = None,
                             dec_len: int = DEFAULT_DEC_LEN,
                             return_output: bool = False,
                             backend: str = "auto"):
    """Returns (jitted simulate(key), message_len_out).

    simulate(key) runs the full generate->decode->count chain on the mesh
    and returns the bit-error count as an int32 scalar (plus the sharded
    packed output words when return_output=True). snr_db=math.inf means
    a noiseless channel (sigma=0 passthrough, viterbiDF.h:79-85).
    """
    num_devices = mesh.shape[BLOCK_AXIS]
    total_stages = message_len
    sd = sharded_stage_count(total_stages, num_devices, cfg.bits_per_pack)
    input_num = 2 * total_stages
    m = cfg.get_message_len(input_num)
    if m <= 0:
        raise ValueError(f"message_len {message_len} too short to decode")

    decode_fn, _, _, _ = build_sharded_decoder(cfg, sd, mesh, dec_len,
                                               backend=backend)
    dpp = 1 if cfg.channel_in == ChannelIn.FP32 else cfg.enc_data_per_pack
    words_needed = sd * num_devices * 2 // dpp
    if scale is None:
        scale = DEFAULT_SCALES[cfg.channel_in]
    block_sharding = NamedSharding(mesh, P(BLOCK_AXIS))
    # bpp=16 allows m % 32 == 16; the reference stream is built as
    # rounded-up 32-bit packs either way and compared in 32-bit space
    m32 = -(-m // 32) * 32

    def gen_ref32_and_packed(key):
        bits, packed = packed_workload(key, message_len, cfg.channel_in,
                                       snr_db, scale)
        bits = jax.lax.with_sharding_constraint(bits, block_sharding)
        return _ref_words32(bits, cfg, m32), packed

    def count_errors(out, ref32):
        if cfg.bits_per_pack == 32:
            valid = out[: m // 32].astype(jnp.uint32)
            return jnp.sum(jax.lax.population_count(valid ^ ref32)
                           .astype(jnp.int32))
        # bpp=16: compare the 16-bit output packs against the 32-bit
        # reference halves without materializing an interleaved stream
        nh = m // 16
        v = out[:nh].astype(jnp.uint32)
        hi = (ref32 >> jnp.uint32(16))[: (nh + 1) // 2]
        lo = (ref32 & jnp.uint32(0xFFFF))[: nh // 2]
        return (jnp.sum(jax.lax.population_count(v[0::2] ^ hi)
                        .astype(jnp.int32)) +
                jnp.sum(jax.lax.population_count(v[1::2] ^ lo)
                        .astype(jnp.int32)))

    def simulate(key):
        ref32, packed = gen_ref32_and_packed(key)
        pad = words_needed - packed.shape[0]
        if pad > 0:
            packed = jnp.pad(packed, (0, pad))
        elif pad < 0:
            packed = packed[:words_needed]
        packed = jax.lax.with_sharding_constraint(packed, block_sharding)
        out = decode_fn(packed)
        ben = count_errors(out, ref32)
        if return_output:
            return ben, out
        return ben

    return jax.jit(simulate), m


def simulate_sharded(cfg: DecoderConfig, message_len: int, mesh,
                     snr_db: float = 5.5, seed: int = 0,
                     scale: float = None, dec_len: int = DEFAULT_DEC_LEN,
                     backend: str = "auto") -> Tuple[int, int]:
    """Convenience one-shot: returns (bit_error_count, message_len)."""
    fn, m = build_sharded_simulation(cfg, message_len, mesh, snr_db=snr_db,
                                     scale=scale, dec_len=dec_len,
                                     backend=backend)
    ben = int(jax.block_until_ready(fn(jax.random.PRNGKey(seed))))
    return ben, m
