"""Streaming decoder tests: chunked push/flush must reproduce the one-shot
decode contract (output bit i = message bit i + extra_l) across chunk
boundaries, for every channel format and dec_len policy."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_viterbi.chain.encode import conv_encode_np
from tpu_viterbi.chain.quantize import quantize_and_pack
from tpu_viterbi.config import ChannelIn, DecoderConfig
from tpu_viterbi.decoder.streaming import StreamingViterbi
from tpu_viterbi.utils.bits import unpack_msb_first

EXTRA_L = 26

# canonical per-channel scales (sharding/simulate.py); HARD's scale is
# sign-irrelevant so the shared table's 1.0 is equivalent to any positive
from tpu_viterbi.sharding.simulate import DEFAULT_SCALES as _SCALES


def _workload(n, sigma, seed=21, channel=ChannelIn.SOFT8):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    coded = conv_encode_np(bits).astype(np.float32)
    sym = 2 * coded - 1
    if sigma:
        sym = sym + rng.normal(0, sigma, sym.shape).astype(np.float32)
    packed = np.asarray(quantize_and_pack(jnp.asarray(sym), channel,
                                          _SCALES[channel]))
    return bits, packed


def test_streaming_noiseless_exact():
    n = 40_000
    bits, packed = _workload(n, 0.0)
    sv = StreamingViterbi(DecoderConfig(channel_in=ChannelIn.SOFT8),
                          dec_len=512, backend="xla")
    outs = []
    chunk_words = 4096  # 8192 stages per chunk
    for i in range(0, len(packed), chunk_words):
        outs.append(sv.push(packed[i: i + chunk_words]))
    outs.append(sv.flush())
    stream = np.concatenate([unpack_msb_first(o, 32) for o in outs
                             if len(o)])
    # contract: output bit i == message bit i + extra_l; check everything
    # except the padding-influenced tail
    usable = n - EXTRA_L - 64
    assert len(stream) >= usable
    assert np.array_equal(stream[:usable],
                          bits[EXTRA_L: EXTRA_L + usable])


def test_streaming_matches_oneshot_noisy():
    n = 24_000
    bits, packed = _workload(n, 0.5)
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)

    sv = StreamingViterbi(cfg, dec_len=512, backend="xla")
    outs = []
    for i in range(0, len(packed), 2048):
        outs.append(sv.push(packed[i: i + 2048]))
    outs.append(sv.flush())
    stream = np.concatenate([unpack_msb_first(o, 32) for o in outs
                             if len(o)])

    from tpu_viterbi.decoder.api import ViterbiTPU
    one = ViterbiTPU(cfg, dec_len=512, backend="xla")
    input_num = 2 * n
    out1, _ = one.run(packed, input_num, want_time=False)
    m1 = cfg.get_message_len(input_num)
    oneshot = unpack_msb_first(out1, 32)[:m1]

    ref = bits[EXTRA_L: EXTRA_L + m1]
    err_stream = np.count_nonzero(stream[:m1] != ref)
    err_one = np.count_nonzero(oneshot != ref)
    # same algorithm, different chunk framing: error counts must be close
    assert abs(err_stream - err_one) <= max(8, err_one), \
        (err_stream, err_one)


def test_streaming_incremental_lengths():
    """Push sizes that leave non-trivial carries."""
    n = 10_000
    bits, packed = _workload(n, 0.0, seed=5)
    sv = StreamingViterbi(DecoderConfig(channel_in=ChannelIn.SOFT8),
                          dec_len=128, backend="xla")
    outs = []
    sizes = [100, 900, 2000, 50, 1950]
    pos = 0
    for s in sizes:
        outs.append(sv.push(packed[pos: pos + s]))
        pos += s
    outs.append(sv.push(packed[pos:]))
    outs.append(sv.flush())
    stream = np.concatenate([unpack_msb_first(o, 32) for o in outs
                             if len(o)])
    usable = n - EXTRA_L - 64
    assert np.array_equal(stream[:usable], bits[EXTRA_L: EXTRA_L + usable])


@pytest.mark.parametrize("channel", [ChannelIn.HARD, ChannelIn.SOFT4,
                                     ChannelIn.SOFT8, ChannelIn.SOFT16,
                                     ChannelIn.FP32])
def test_streaming_oneshot_contract_all_channels(channel):
    """push()+flush() must emit EXACTLY get_message_len(stream) bits, all
    correct — i.e. the one-shot framing contract with no synthetic-padding
    tail.  This is the regression lock for the old HARD flush bias
    (zero-word padding = 32 explicit '0' bits, a non-neutral halo): under
    HARD the biased halo flipped tail decisions,
    which the exact full-length equality below would catch."""
    n = 20_000
    bits, packed = _workload(n, 0.0, seed=3, channel=channel)
    cfg = DecoderConfig(channel_in=channel)
    sv = StreamingViterbi(cfg, dec_len=512, backend="xla")
    outs = []
    for i in range(0, len(packed), 1024):
        outs.append(sv.push(packed[i: i + 1024]))
    outs.append(sv.flush())
    stream = np.concatenate([unpack_msb_first(o, 32) for o in outs
                             if len(o)])
    m = cfg.get_message_len(2 * n)
    assert len(stream) == m
    assert np.array_equal(stream, bits[EXTRA_L: EXTRA_L + m]), channel


@pytest.mark.parametrize("channel", [ChannelIn.HARD, ChannelIn.SOFT8])
def test_streaming_auto_backend(channel):
    """The streaming wrapper on backend='auto' (the XLA core on the CPU,
    the Hopper kernel on a GPU) must match the explicit XLA-core stream
    bit for bit and cover exactly get_message_len."""
    n = 6_000
    bits, packed = _workload(n, 0.4, seed=11, channel=channel)
    cfg = DecoderConfig(channel_in=channel)
    outs_a, outs_x = [], []
    sv_a = StreamingViterbi(cfg, dec_len=256)
    sv_x = StreamingViterbi(cfg, dec_len=256, backend="xla")
    for i in range(0, len(packed), 1024):
        outs_a.append(sv_a.push(packed[i: i + 1024]))
        outs_x.append(sv_x.push(packed[i: i + 1024]))
    outs_a.append(sv_a.flush())
    outs_x.append(sv_x.flush())
    got_a = np.concatenate([o for o in outs_a if len(o)])
    got_x = np.concatenate([o for o in outs_x if len(o)])
    assert np.array_equal(got_a, got_x)
    m = cfg.get_message_len(2 * n)
    assert len(got_a) * 32 == m
