"""Path-metric renormalization past the renorm-free int32 bound
(reference: viterbiACS.cuh:307-378, viterbi.cu:173).

Blocks reset PMs to zero, so the int32 cores run renorm-free while
block_len * max|bm| < 2^30 (needs_int32_renorm).  Past that, both cores
switch on a periodic min-subtract renorm, which is decision-invariant —
these tests prove (a) a SOFT16 decode at dec_len past the old cap (where
PMs would wrap int32 without renorm) still matches the int64 golden
oracle, and (b) the renorm path, forced on at small shapes, decodes
exactly like the golden oracle.  The Hopper kernel's own renorm (a
per-pack min-subtract) is checked by tests/test_cuda_kernel.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_viterbi.config import ChannelIn, DecoderConfig
from tpu_viterbi.decoder import core_xla
from tpu_viterbi.decoder.core_xla import (decode_blocks, needs_int32_renorm,
                                          plan_blocks)
from tpu_viterbi.decoder.golden import golden_decode_block
from tpu_viterbi.utils.bits import unpack_msb_first


def test_needs_renorm_boundary():
    cfg16 = DecoderConfig(channel_in=ChannelIn.SOFT16)
    # SOFT16 max|bm| = 65536: the bound trips at block_len 16384, i.e.
    # dec_len 16320 once the 64-stage extraL+extraR halo is counted
    assert not needs_int32_renorm(cfg16, plan_blocks(16288, 32, 16288))
    assert needs_int32_renorm(cfg16, plan_blocks(16320, 32, 16320))
    cfg8 = DecoderConfig(channel_in=ChannelIn.SOFT8)
    assert not needs_int32_renorm(cfg8, plan_blocks(32_000_000, 32, 8192))


def test_soft16_past_old_cap_matches_golden(rng):
    """dec_len 32768 at SOFT16: growth ~2.1e9 wraps int32 without renorm
    (the old validate_plan rejected anything past 16384 stages)."""
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT16)
    m = 32768
    plan = plan_blocks(m, cfg.bits_per_pack, m)
    assert needs_int32_renorm(cfg, plan)
    # near-max-magnitude values drive PM growth at ~max|bm| per stage
    r = rng.choice(np.array([-32768, -32767, 32766, 32767]),
                   size=(m + 64, 2)).astype(np.int64)
    out = np.asarray(decode_blocks(jnp.asarray(r, jnp.int32)[None][0]
                                   .reshape(1, -1, 2), cfg, plan))
    bits = unpack_msb_first(out, cfg.bits_per_pack)
    want = golden_decode_block(r, m)            # int64 oracle, no wrap
    assert np.array_equal(bits, want)


@pytest.mark.parametrize("channel", [ChannelIn.SOFT8, ChannelIn.SOFT16])
def test_xla_renorm_is_decision_invariant(rng, monkeypatch, channel):
    """Force the int32 renorm on at small shape and check bit-identity with
    golden — proves the min-subtract itself."""
    cfg = DecoderConfig(channel_in=channel)
    dec_len, b = 96, 2
    m = dec_len * b
    plan = plan_blocks(m, cfg.bits_per_pack, dec_len)
    lim = 100 if channel == ChannelIn.SOFT8 else 30000
    r = rng.integers(-lim, lim + 1, size=(m + 64, 2)).astype(np.int32)

    monkeypatch.setattr(core_xla, "needs_int32_renorm", lambda c, p: True)
    jax.clear_caches()      # retrace the jitted scan with renorm on
    out = np.asarray(core_xla.decode_blocks(
        core_xla.gather_blocks(jnp.asarray(r), plan), cfg, plan))
    jax.clear_caches()
    bits = unpack_msb_first(out, cfg.bits_per_pack)
    for k, off in enumerate(plan.offsets()):
        want = golden_decode_block(r[off:off + plan.block_len]
                                   .astype(np.int64), dec_len)
        assert np.array_equal(bits[off:off + dec_len], want), f"block {k}"
