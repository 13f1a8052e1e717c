"""Word-granular staging (core_xla.stage_layout_packed) must produce
exactly the same (n_packs, bpp, 2, b_pad) stage tensor as soft-value
staging, for every channel type and for the natural last block.  Both
layouts are pure XLA and run on the CPU backend."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_viterbi.chain.quantize import quantize_and_pack, unpack_to_soft
from tpu_viterbi.config import ChannelIn, DecodeOut, DecoderConfig
from tpu_viterbi.decoder.core_xla import (overlapped_windows, plan_blocks,
                                          stage_layout_packed)


def _stage_layout(r, plan, b_pad):
    """Reference soft-value staging: global (S, 2) soft stages ->
    (n_packs, bpp, 2, b_pad), the last block's tail reading the
    zero-padded stream."""
    dl, L, B = plan.dec_len, plan.block_len, plan.num_blocks
    blocks = overlapped_windows(r, dl, L, B)            # (B, L, 2)
    if b_pad > B:
        pad = jnp.zeros((b_pad - B, L, 2), r.dtype)
        blocks = jnp.concatenate([blocks, pad], axis=0)
    return blocks.transpose(1, 2, 0).reshape(plan.n_packs,
                                             plan.bits_per_pack, 2, b_pad)


CHANNELS = [ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT8,
            ChannelIn.SOFT16, ChannelIn.FP32]


@pytest.mark.parametrize("channel", CHANNELS)
@pytest.mark.parametrize("message_len,dec_len", [(512, 128), (608, 128)])
def test_packed_staging_matches_soft_staging(rng, channel, message_len,
                                             dec_len):
    cfg = DecoderConfig(channel_in=channel)
    plan = plan_blocks(message_len, cfg.bits_per_pack, dec_len)
    n_stages = message_len + 64
    input_num = 2 * (message_len + cfg.extra_l + cfg.extra_r)

    vals = rng.normal(size=(input_num,)).astype(np.float32) * 3.0
    packed = quantize_and_pack(jnp.asarray(vals), channel, 1.0)

    soft = unpack_to_soft(packed, channel)
    r = soft[: 2 * n_stages].reshape(n_stages, 2)
    is_float = channel == ChannelIn.FP32
    b_pad = 8  # force padding blocks

    ref = _stage_layout(
        r.astype(jnp.float32 if is_float else jnp.int32), plan, b_pad)
    got = stage_layout_packed(
        packed.astype(jnp.float32 if is_float else jnp.int32),
        cfg, plan, b_pad)

    assert got.shape == ref.shape == (plan.n_packs, plan.bits_per_pack,
                                      2, b_pad)
    # padding lanes (blocks >= num_blocks) are decoded and discarded; their
    # fill differs for HARD (zero words unpack to -1, soft padding is 0).
    # The same applies to the last real block's beyond-stream tail under
    # natural framing (BlockPlan): those stages pad with zero WORDS on the
    # packed path and zero VALUES on the soft path, and every bit they can
    # influence is discarded — compare real stages only.
    nb = plan.num_blocks
    g, f = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(g[..., : nb - 1], f[..., : nb - 1])
    v = n_stages - (nb - 1) * plan.dec_len      # real stages in last block
    last_g = g[..., nb - 1].reshape(-1, 2)[:v]
    last_f = f[..., nb - 1].reshape(-1, 2)[:v]
    np.testing.assert_array_equal(last_g, last_f)


@pytest.mark.parametrize("channel", CHANNELS)
def test_decode_packed_xla_matches_gather_path(rng, channel):
    """decode_packed_xla (production staging) must be bit-identical to the
    readable gather_blocks + decode_blocks reference path."""
    from tpu_viterbi.decoder.core_xla import (decode_blocks,
                                              decode_packed_xla,
                                              gather_blocks)
    cfg = DecoderConfig(channel_in=channel)
    message_len, dec_len = 608, 128
    plan = plan_blocks(message_len, cfg.bits_per_pack, dec_len)
    input_num = 2 * (message_len + cfg.extra_l + cfg.extra_r)
    vals = rng.normal(size=(input_num,)).astype(np.float32) * 3.0
    packed = quantize_and_pack(jnp.asarray(vals), channel, 1.0)

    got = decode_packed_xla(packed, cfg, plan)

    # pad with zero WORDS before unpacking so the gather path sees the
    # same beyond-stream fill as the word path (natural framing: the last
    # block's tail reads zero words, which unpack to -1 under HARD)
    need = (plan.num_blocks - 1) * plan.dec_len + plan.block_len
    dpp = 1 if channel == ChannelIn.FP32 else cfg.enc_data_per_pack
    pad_words = max(0, -(-2 * need // dpp) - packed.shape[0])
    packed_p = jnp.concatenate(
        [packed, jnp.zeros((pad_words,), packed.dtype)])
    soft = unpack_to_soft(packed_p, channel)
    r = soft[: 2 * need].reshape(need, 2)
    want = decode_blocks(gather_blocks(r, plan), cfg, plan)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("metric_name", ["M_B16", "M_FP16"])
def test_decode_packed_xla_metric_dtypes(rng, metric_name):
    from tpu_viterbi.config import Metric
    from tpu_viterbi.decoder.core_xla import (decode_blocks,
                                              decode_packed_xla,
                                              gather_blocks)
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT4,
                        metric=getattr(Metric, metric_name))
    message_len, dec_len = 512, 128
    plan = plan_blocks(message_len, cfg.bits_per_pack, dec_len)
    input_num = 2 * (message_len + cfg.extra_l + cfg.extra_r)
    vals = rng.normal(size=(input_num,)).astype(np.float32) * 3.0
    packed = quantize_and_pack(jnp.asarray(vals), cfg.channel_in, 1.0)

    got = decode_packed_xla(packed, cfg, plan)
    soft = unpack_to_soft(packed, cfg.channel_in)
    r = soft[: 2 * (message_len + 64)].reshape(message_len + 64, 2)
    want = decode_blocks(gather_blocks(r, plan), cfg, plan)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_packed_staging_b16_packs(rng):
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8, decode_out=DecodeOut.O_B16)
    message_len, dec_len = 400, 96
    plan = plan_blocks(message_len, cfg.bits_per_pack, dec_len)
    input_num = 2 * (message_len + cfg.extra_l + cfg.extra_r)
    vals = rng.normal(size=(input_num,)).astype(np.float32) * 20.0
    packed = quantize_and_pack(jnp.asarray(vals), cfg.channel_in, 1.0)
    soft = unpack_to_soft(packed, cfg.channel_in)
    r = soft[: 2 * (message_len + 64)].reshape(message_len + 64, 2)
    b_pad = 8
    ref = _stage_layout(r.astype(jnp.int32), plan, b_pad)
    got = stage_layout_packed(packed.astype(jnp.int32), cfg, plan, b_pad)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("channel", [ChannelIn.HARD, ChannelIn.SOFT4,
                                     ChannelIn.SOFT8, ChannelIn.SOFT16])
def test_stage_words_matches_kernel_unpack_contract(rng, channel):
    """The CUDA kernel's word unpack (csrc/viterbi_hopper.cu Field::get:
    value v of word w is bits [32-(v+1)*width, 32-v*width), stage s uses
    values (2s, 2s+1) of word s // (dpp/2)) must reproduce exactly the
    sign-extended values the value-mode staging produces."""
    from tpu_viterbi.decoder.core_xla import stage_words

    cfg = DecoderConfig(channel_in=channel)
    message_len, dec_len = 512, 128
    plan = plan_blocks(message_len, cfg.bits_per_pack, dec_len)
    dpp, width = cfg.enc_data_per_pack, cfg.enc_data_width
    n_vals = 2 * (message_len + 64)
    words = jnp.asarray(rng.integers(-2 ** 31, 2 ** 31, size=(n_vals // dpp,))
                        .astype(np.int32))
    b_pad = 8

    ref = np.asarray(stage_layout_packed(words, cfg, plan, b_pad))
    wt = np.asarray(stage_words(words, cfg, plan, b_pad))
    rs = wt.reshape(plan.n_packs, -1, b_pad)      # (n_packs, wpp, b_pad)

    ppw = dpp // 2
    bpp = plan.bits_per_pack
    got = np.zeros_like(ref)
    for s in range(bpp):
        j, k = s % ppw, s // ppw
        wv = rs[:, k]                             # (n_packs, b_pad)
        for h, v in enumerate((2 * j, 2 * j + 1)):
            if width == 1:
                val = ((wv >> (31 - v)) & 1) * 2 - 1
            else:
                val = (wv << (v * width)).astype(np.int32) >> (32 - width)
            got[:, s, h] = val
    np.testing.assert_array_equal(got, ref)
