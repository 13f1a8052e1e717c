"""Block decoder (XLA core) tests: bit-exact agreement with the golden
oracle on arbitrary noisy inputs, framing/assembly correctness, metric-dtype
variants, and end-to-end noiseless exactness through the full API."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_viterbi.chain.encode import conv_encode_np
from tpu_viterbi.chain.quantize import quantize_and_pack
from tpu_viterbi.config import (ChannelIn, DecodeOut, DecoderConfig, Metric)
from tpu_viterbi.decoder.api import ViterbiTPU
from tpu_viterbi.decoder.core_xla import (decode_blocks, gather_blocks,
                                          plan_blocks)
from tpu_viterbi.decoder.golden import golden_decode_block
from tpu_viterbi.utils.bits import unpack_msb_first

EXTRA_L = 26


def _random_soft_blocks(rng, b, dec_len, lo=-31, hi=31):
    return rng.integers(lo, hi + 1, size=(b, dec_len + 64, 2)).astype(np.int32)


def test_kernel_matches_golden_random_soft(rng):
    """Bit-exact vs golden on random (nonsense) soft inputs — the strongest
    implementation-equivalence test (exercises every ACS/traceback path)."""
    dec_len, b = 96, 5
    r_blocks = _random_soft_blocks(rng, b, dec_len)
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    plan = plan_blocks(dec_len * b, cfg.bits_per_pack, dec_len)
    assert plan.num_blocks == b and plan.dec_len == dec_len
    out = np.asarray(decode_blocks(jnp.asarray(r_blocks), cfg, plan))
    got_bits = unpack_msb_first(out, 32)
    for k in range(b):
        want = golden_decode_block(r_blocks[k].astype(np.int64), dec_len)
        got = got_bits[k * dec_len: (k + 1) * dec_len]
        assert np.array_equal(got, want), f"block {k} mismatch"


def test_kernel_matches_golden_b16_packs(rng):
    dec_len, b = 96, 3
    r_blocks = _random_soft_blocks(rng, b, dec_len)
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT4, metric=Metric.M_B32,
                        decode_out=DecodeOut.O_B16)
    plan = plan_blocks(dec_len * b, cfg.bits_per_pack, dec_len)
    out = np.asarray(decode_blocks(jnp.asarray(r_blocks), cfg, plan))
    assert out.dtype == np.uint16
    got_bits = unpack_msb_first(out, 16)
    for k in range(b):
        want = golden_decode_block(r_blocks[k].astype(np.int64), dec_len)
        got = got_bits[k * dec_len: (k + 1) * dec_len]
        assert np.array_equal(got, want)


def test_metric_dtypes_agree(rng):
    """int16 (with renorm) and int32 metrics must agree on small inputs."""
    dec_len, b = 64, 4
    r_blocks = _random_soft_blocks(rng, b, dec_len, -8, 7)
    plan = plan_blocks(dec_len * b, 32, dec_len)
    outs = {}
    for metric in [Metric.M_B32, Metric.M_B16]:
        cfg = DecoderConfig(channel_in=ChannelIn.SOFT4, metric=metric)
        outs[metric] = np.asarray(
            decode_blocks(jnp.asarray(r_blocks), cfg, plan))
    assert np.array_equal(outs[Metric.M_B32], outs[Metric.M_B16])


def test_last_block_overlap_assembly(rng):
    """message_len not divisible by dec_len: the last (partial) block must
    contribute exactly its first dec_len - overlap_bits bits, matching a
    golden decode of its zero-padded span (natural framing, BlockPlan)."""
    dec_len = 64
    m = 64 * 3 + 32  # forces overlap of 32 bits
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    plan = plan_blocks(m, cfg.bits_per_pack, dec_len)
    assert plan.num_blocks == 4 and plan.overlap_bits == 32
    s = m + 64
    r = rng.integers(-31, 32, size=(s, 2)).astype(np.int32)
    r_blocks = gather_blocks(jnp.asarray(r), plan)
    out = np.asarray(decode_blocks(r_blocks, cfg, plan))
    bits = unpack_msb_first(out, 32)
    assert len(bits) == m
    # every output bit must match a golden block decode covering it
    need = (plan.num_blocks - 1) * dec_len + plan.block_len
    rp = np.concatenate([r, np.zeros((need - s, 2), r.dtype)])
    for k, off in enumerate(plan.offsets()):
        want = golden_decode_block(
            rp[off: off + dec_len + 64].astype(np.int64), dec_len)
        n = min(dec_len, m - off)
        assert np.array_equal(bits[off: off + n], want[:n]), k


def _end_to_end(cfg, n=4096, sigma=0.0, seed=5, dec_len=256, scale=4.0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    coded = conv_encode_np(bits).astype(np.float32)
    sym = 2 * coded - 1
    if sigma:
        sym = sym + rng.normal(0, sigma, sym.shape).astype(np.float32)
    packed = quantize_and_pack(jnp.asarray(sym), cfg.channel_in, scale)
    dec = ViterbiTPU(cfg, dec_len=dec_len, backend="xla")
    input_num = 2 * n
    out, _ = dec.run(np.asarray(packed), input_num)
    m = cfg.get_message_len(input_num)
    got = unpack_msb_first(out, cfg.bits_per_pack)[:m]
    want = bits[EXTRA_L: EXTRA_L + m]
    return got, want


def test_end_to_end_noiseless_all_channels():
    for chan in [ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT8,
                 ChannelIn.SOFT16, ChannelIn.FP32]:
        cfg = DecoderConfig(channel_in=chan)
        got, want = _end_to_end(cfg)
        assert np.array_equal(got, want), chan


def test_end_to_end_noiseless_b16_and_metrics():
    for cfg in [DecoderConfig(ChannelIn.SOFT4, Metric.M_B16, DecodeOut.O_B16),
                DecoderConfig(ChannelIn.HARD, Metric.M_FP16, DecodeOut.O_B16),
                DecoderConfig(ChannelIn.SOFT8, Metric.M_B16, DecodeOut.O_B32),
                DecoderConfig(ChannelIn.FP32, Metric.M_FP16, DecodeOut.O_B16)]:
        got, want = _end_to_end(cfg)
        assert np.array_equal(got, want), cfg


def test_end_to_end_noisy_low_ber():
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    got, want = _end_to_end(cfg, n=20000, sigma=0.35, dec_len=512, scale=32.0)
    ber = np.count_nonzero(got != want) / len(want)
    assert ber < 1e-3, ber


def test_renorm_long_run_int16(rng):
    """A long single block with int16 metrics must survive renormalization
    without overflow (cf. viterbiACS.cuh:307-378)."""
    dec_len = 4096
    n = dec_len + 64
    bits = rng.integers(0, 2, n).astype(np.uint8)
    coded = conv_encode_np(bits).astype(np.float32)
    sym = 2 * coded - 1 + rng.normal(0, 0.5, 2 * n).astype(np.float32)
    r = np.clip(np.rint(sym * 100), -128, 127).astype(np.int32).reshape(-1, 2)
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8, metric=Metric.M_B16)
    plan = plan_blocks(dec_len, cfg.bits_per_pack, dec_len)
    out = np.asarray(decode_blocks(jnp.asarray(r)[None], cfg, plan))
    got = unpack_msb_first(out, 32)
    want = bits[EXTRA_L: EXTRA_L + dec_len]
    ber = np.count_nonzero(got != want) / dec_len
    assert ber < 5e-3, ber


def test_run_times_single_dispatch():
    """run() reports a positive wall time for exactly one pre-compiled
    dispatch, decodes correctly, and reports no time when not asked."""
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    n = 2048
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    coded = conv_encode_np(bits).astype(np.float32)
    packed = quantize_and_pack(jnp.asarray(2 * coded - 1), cfg.channel_in, 4.0)
    dec = ViterbiTPU(cfg, dec_len=256, backend="xla")
    input_num = 2 * n
    out, t = dec.run(np.asarray(packed), input_num)
    assert t is not None and t > 0
    m = cfg.get_message_len(input_num)
    got = unpack_msb_first(out, 32)[:m]
    assert np.array_equal(got, bits[EXTRA_L: EXTRA_L + m])
    out2, t2 = dec.run(np.asarray(packed), input_num, want_time=False)
    assert t2 is None and np.array_equal(out2, out)


def test_auto_dec_len_policy_and_api():
    """dec_len='auto': large messages keep the preferred 1024; below
    1024 * 1024 bits dec_len shrinks so ~1024 blocks stay in flight; floor
    WARMUP=64; and the resolved plan decodes correctly through
    ViterbiTPU."""
    from tpu_viterbi.decoder.core_xla import WARMUP, auto_dec_len

    assert auto_dec_len(32_000_000, 32) == 1024
    assert auto_dec_len(1024 * 1024, 32) == 1024
    # 1M bits: ceil(1e6/1024) = 977 -> 992 (pack multiple) -> 1009 blocks
    assert auto_dec_len(1_000_000, 32) == 992
    assert -(-1_000_000 // 992) >= 1000
    # 100K: ceil/1024 = 98 -> 128
    assert auto_dec_len(100_000, 32) == 128
    # bpp=16 rounding
    assert auto_dec_len(1_000_000, 16) % 16 == 0
    # tiny messages hit the WARMUP floor
    assert auto_dec_len(1000, 32) == WARMUP

    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    n = 20_000
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    coded = conv_encode_np(bits).astype(np.float32)
    packed = quantize_and_pack(jnp.asarray(2 * coded - 1), cfg.channel_in,
                               4.0)
    dec = ViterbiTPU(cfg, dec_len="auto", backend="xla")
    out, _ = dec.run(np.asarray(packed), 2 * n, want_time=False)
    m = cfg.get_message_len(2 * n)
    assert dec._plan.dec_len == auto_dec_len(m, 32)
    got = unpack_msb_first(out, 32)[:m]
    assert np.array_equal(got, bits[EXTRA_L: EXTRA_L + m])


def test_run_rejects_short_input():
    import pytest as _pytest

    from tpu_viterbi.config import ChannelIn, DecoderConfig
    from tpu_viterbi.decoder.api import ViterbiTPU

    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    dec = ViterbiTPU(cfg)
    input_num = 2 * 10_000
    words = cfg.get_input_words(input_num)
    short = np.zeros(words - 1, dtype=np.int32)
    with _pytest.raises(ValueError, match="need"):
        dec.run(short, input_num, want_time=False)


def test_run_stream_matches_run():
    """Sustained serving mode: run_stream decodes a back-to-back message
    stream with one trailing block, bit-identical per message to run()."""
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    n = 4096
    rng = np.random.default_rng(29)
    dec = ViterbiTPU(cfg, dec_len=256, backend="xla")
    msgs = []
    for _ in range(3):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        coded = conv_encode_np(bits).astype(np.float32)
        msgs.append(np.asarray(quantize_and_pack(
            jnp.asarray(2 * coded - 1), cfg.channel_in, 4.0)))
    outs, per = dec.run_stream(msgs, 2 * n)
    assert per is not None and per > 0
    assert len(outs) == 3
    for msg, out in zip(msgs, outs):
        ref, _ = dec.run(msg, 2 * n, want_time=False)
        assert np.array_equal(out, ref)
    with pytest.raises(ValueError, match="need"):
        dec.run_stream([msgs[0][:-1]], 2 * n)


def test_exec_cache_keyed_by_input_size():
    """Alternating input sizes must NOT re-lower/recompile: the executable
    cache is keyed per size (reference pre-alloc intent
    viterbi.cu:31-36)."""
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    dec = ViterbiTPU(cfg, dec_len=256, backend="xla")
    n_a, n_b = 2 * 4096, 2 * 8192
    rng = np.random.default_rng(3)

    def run(n):
        words = cfg.get_input_words(n)
        x = rng.integers(-2 ** 31, 2 ** 31, size=words).astype(np.int32)
        dec.run(x, n, want_time=False)
        return dec._exec

    e_a1, e_b1 = run(n_a), run(n_b)
    assert e_a1 is not e_b1
    e_a2, e_b2 = run(n_a), run(n_b)
    assert e_a2 is e_a1            # same compiled executable reused
    assert e_b2 is e_b1
    assert set(dec._exec_cache) == {n_a, n_b}

    # bounded LRU: a long-lived instance fed many sizes must not retain
    # an executable per size forever — the least recently used is evicted
    # at _EXEC_CACHE_SIZE, and recently-run sizes survive
    cap = dec._EXEC_CACHE_SIZE
    sizes = [2 * 4096 * (k + 3) for k in range(cap)]
    for n in sizes:
        run(n)
    assert len(dec._exec_cache) == cap
    assert n_a not in dec._exec_cache and n_b not in dec._exec_cache
    assert sizes[-1] in dec._exec_cache
    assert run(sizes[-1]) is dec._exec_cache[sizes[-1]][-1]
