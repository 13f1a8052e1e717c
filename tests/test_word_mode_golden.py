"""Golden coverage of the packed-input production entry: decode_packed_xla
— word-granular staging and unpack — checked directly against the golden
full-history oracle for every channel type and both output pack widths,
with a natural (partial) last block.  The Hopper kernel is held to
decode_packed_xla bit for bit (tests/test_cuda_kernel.py on the CPU,
chip_smoke.py on the card), so this closes the kernel-vs-golden link too.

Reference contract being locked: traceback/output packing viterbiTB.cuh:
4-21 and MSB-first input packing viterbiDF.h:157-163.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_viterbi.chain.quantize import unpack_to_soft_np
from tpu_viterbi.config import ChannelIn, DecodeOut, DecoderConfig
from tpu_viterbi.decoder.core_xla import decode_packed_xla, plan_blocks
from tpu_viterbi.decoder.golden import golden_decode_block
from tpu_viterbi.utils.bits import unpack_msb_first


def _random_words(rng, cfg, n_vals):
    if cfg.channel_in == ChannelIn.FP32:
        return rng.integers(-8, 8, size=(n_vals,)).astype(np.float32)
    dpp = cfg.enc_data_per_pack
    return rng.integers(-2 ** 31, 2 ** 31,
                        size=(n_vals // dpp,)).astype(np.int32)


def _golden_soft(words, cfg, n_vals):
    if cfg.channel_in == ChannelIn.FP32:
        r = words[:n_vals].reshape(-1, 2).astype(np.float64)
        return np.trunc(np.clip(r, -8, 7))  # FP_PRECISION clamp + trunc
    return unpack_to_soft_np(words, cfg.channel_in)[:n_vals] \
        .reshape(-1, 2).astype(np.int64)


def _check_against_golden(bits, r, plan, ctx, hard=False):
    # natural framing: block k owns bits [k*dec_len, min((k+1)*dec_len, m));
    # the beyond-stream tail is zero WORDS (-1 values under HARD)
    need = (plan.num_blocks - 1) * plan.dec_len + plan.block_len
    if len(r) < need:
        r = np.concatenate(
            [r, np.full((need - len(r), 2), -1 if hard else 0, r.dtype)])
    for k, off in enumerate(plan.offsets()):
        want = golden_decode_block(r[off:off + plan.block_len], plan.dec_len)
        n = min(plan.dec_len, plan.message_len - off)
        assert np.array_equal(bits[off: off + n], want[:n]), (
            f"{ctx} block={k} off={off}")


@pytest.mark.parametrize("decode_out", list(DecodeOut),
                         ids=lambda o: o.name)
@pytest.mark.parametrize("channel", list(ChannelIn), ids=lambda c: c.name)
def test_packed_xla_matches_golden(rng, channel, decode_out):
    """Production entry (word staging + unpack) vs golden, with a partial
    (natural-framed) last block (message_len not a dec_len multiple)."""
    cfg = DecoderConfig(channel_in=channel, decode_out=decode_out)
    bpp = cfg.bits_per_pack
    dec_len = 3 * bpp
    message_len = 7 * bpp            # not a multiple of dec_len -> overlap
    plan = plan_blocks(message_len, bpp, dec_len)
    assert plan.overlap_bits > 0
    n_vals = 2 * (message_len + 64)
    words = _random_words(rng, cfg, n_vals)

    out = np.asarray(decode_packed_xla(jnp.asarray(words), cfg, plan))
    bits = unpack_msb_first(out, bpp)
    r = _golden_soft(words, cfg, n_vals)
    _check_against_golden(bits, r, plan,
                          f"{channel.name}/{decode_out.name}",
                          hard=channel == ChannelIn.HARD)
