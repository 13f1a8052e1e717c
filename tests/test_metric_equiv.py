"""CPU regression for the metric-dtype-equivalence invariant: the
reference sizes renorm strides so int16 PMs never wrap (viterbiACS.cuh:320
+ viterbi.cu:173) and restricts fp16 to channels whose PMs stay
integer-exact below 2048 (OptionsValid, viterbi.h:22-41) — the metric dtype
is a performance knob, not a semantics knob.  The Hopper kernel relies on
this: every metric mode runs on its int32 arithmetic (core_cuda.py).  This
test guards the invariant via the dtype-faithful XLA cores on full-range
(worst-case branch-metric magnitude) inputs; chip_smoke.py checks the
kernel against the b16/fp16 XLA cores on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_viterbi.config import ChannelIn, DecoderConfig, Metric
from tpu_viterbi.decoder.core_xla import decode_packed_xla, plan_blocks


# every valid non-b32 metric x channel combo (viterbi.h:22-41)
COMBOS = ([(Metric.M_B16, ch) for ch in (ChannelIn.HARD, ChannelIn.SOFT4,
                                         ChannelIn.SOFT8, ChannelIn.FP32)]
          + [(Metric.M_FP16, ch) for ch in (ChannelIn.HARD, ChannelIn.SOFT4,
                                            ChannelIn.FP32)])


@pytest.mark.parametrize("metric,channel",
                         COMBOS, ids=[f"{m.name}-{c.name}" for m, c in COMBOS])
def test_metric_dtype_decodes_identically_to_int32(rng, metric, channel):
    m, dec_len = 40_000, 2048
    cfg = DecoderConfig(channel_in=channel, metric=metric)
    cfg32 = DecoderConfig(channel_in=channel, metric=Metric.M_B32)
    plan = plan_blocks(m, cfg.bits_per_pack, dec_len)
    n_words = cfg.get_input_words(2 * m)
    if channel == ChannelIn.FP32:
        words = jnp.asarray(rng.integers(-8, 8, size=(n_words,))
                            .astype(np.float32))
    else:
        words = jnp.asarray(rng.integers(-2 ** 31, 2 ** 31, size=(n_words,))
                            .astype(np.int32))
    got = np.asarray(decode_packed_xla(words, cfg, plan))
    want = np.asarray(decode_packed_xla(words, cfg32, plan))
    assert np.array_equal(got, want), (
        f"{metric.name} x {channel.name}: "
        f"{int(np.count_nonzero(got != want))}/{len(got)} words differ — "
        "the metric-width-is-a-perf-knob invariant broke; running every "
        "metric mode on the int32 CUDA kernel is no longer sound")
