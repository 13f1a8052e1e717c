"""Config/constants contract tests against values derived from the reference
(SURVEY.md §2.2; reference: src/viterbi/viterbi.h:61-87, viterbi.cu:64-100)."""

import pytest

from tpu_viterbi.config import (ALL_VALID_CONFIGS, ChannelIn, CompMode,
                                DecodeOut, DecoderConfig, Metric,
                                options_valid)


def test_framing_constants_b32():
    cfg = DecoderConfig(decode_out=DecodeOut.O_B32)
    assert cfg.bits_per_pack == 32
    assert cfg.extra_l == 26
    assert cfg.extra_r == 38
    assert cfg.slide_size == 32
    assert cfg.forward_len == 96
    assert cfg.warmup == 64


def test_framing_constants_b16():
    cfg = DecoderConfig(decode_out=DecodeOut.O_B16)
    assert cfg.bits_per_pack == 16
    assert cfg.extra_l == 26
    assert cfg.extra_r == 38
    assert cfg.forward_len == 96


def test_enc_data_per_pack():
    expect = {ChannelIn.HARD: (32, 1), ChannelIn.SOFT4: (8, 4),
              ChannelIn.SOFT8: (4, 8), ChannelIn.SOFT16: (2, 16),
              ChannelIn.FP32: (1, 4)}
    for c, (dpp, width) in expect.items():
        cfg = DecoderConfig(channel_in=c)
        assert cfg.enc_data_per_pack == dpp
        assert cfg.enc_data_width == width


def test_input_size_formulas():
    # reference: viterbi.cu:64-84
    n = 1 << 20
    assert DecoderConfig(channel_in=ChannelIn.HARD).get_input_size(n) == n // 8
    assert DecoderConfig(channel_in=ChannelIn.SOFT4).get_input_size(n) == n // 2
    assert DecoderConfig(channel_in=ChannelIn.SOFT8).get_input_size(n) == n
    assert DecoderConfig(channel_in=ChannelIn.SOFT16).get_input_size(n) == 2 * n
    assert DecoderConfig(channel_in=ChannelIn.FP32).get_input_size(n) == 4 * n


def test_message_len_and_output_size():
    # reference: viterbi.cu:86-92
    cfg = DecoderConfig()
    n = 2_000_000
    m = cfg.get_message_len(n)
    assert m == (n // 2 - 64) // 32 * 32
    assert cfg.get_output_size(n) == m // 8
    cfg16 = DecoderConfig(decode_out=DecodeOut.O_B16)
    m16 = cfg16.get_message_len(n)
    assert m16 == (n // 2 - 64) // 16 * 16


def test_validity_table():
    # reference: viterbi.h:22-41
    assert not options_valid(ChannelIn.SOFT8, Metric.M_FP16,
                             DecodeOut.O_B32, CompMode.REG)
    assert not options_valid(ChannelIn.SOFT16, Metric.M_FP16,
                             DecodeOut.O_B32, CompMode.REG)
    assert not options_valid(ChannelIn.SOFT16, Metric.M_B16,
                             DecodeOut.O_B32, CompMode.REG)
    assert not options_valid(ChannelIn.HARD, Metric.M_FP16,
                             DecodeOut.O_B16, CompMode.DPX)
    assert options_valid(ChannelIn.SOFT8, Metric.M_B16,
                         DecodeOut.O_B16, CompMode.DPX)
    # 60 total combos - 12 (channel x metric invalid) - 6 (FP16 x DPX on the
    # remaining FP16-capable channels) = 42 buildable configs
    assert len(ALL_VALID_CONFIGS) == 42


def test_invalid_config_raises():
    with pytest.raises(ValueError):
        DecoderConfig(channel_in=ChannelIn.SOFT16, metric=Metric.M_B16)


def test_options_roundtrip():
    for cfg in ALL_VALID_CONFIGS:
        assert DecoderConfig.from_options(cfg.options) == cfg


def test_pm_norm_stride():
    # reference: viterbi.cu:173 (SURVEY.md §2.2 table)
    assert DecoderConfig(channel_in=ChannelIn.HARD,
                         metric=Metric.M_B16).pm_norm_stride == 8192
    assert DecoderConfig(channel_in=ChannelIn.SOFT4,
                         metric=Metric.M_B16).pm_norm_stride == 1024
    assert DecoderConfig(channel_in=ChannelIn.SOFT8,
                         metric=Metric.M_B16).pm_norm_stride == 64
    assert DecoderConfig(channel_in=ChannelIn.SOFT16,
                         metric=Metric.M_B32).pm_norm_stride == 16384
    assert DecoderConfig(channel_in=ChannelIn.HARD,
                         metric=Metric.M_FP16).pm_norm_stride == 256


def test_every_valid_config_decodes():
    """The analog of the reference's INSTANTIATE_ALL block
    (viterbi.cu:240-262): every one of the 42 buildable configs must
    actually decode — noiseless coded input comes back exactly."""
    import numpy as np
    import jax.numpy as jnp

    from tpu_viterbi.chain.encode import conv_encode_np
    from tpu_viterbi.chain.quantize import quantize_and_pack
    from tpu_viterbi.decoder.core_xla import decode_packed_xla, plan_blocks
    from tpu_viterbi.utils.bits import unpack_msb_first

    scales = {ChannelIn.HARD: 1.0, ChannelIn.SOFT4: 4.0,
              ChannelIn.SOFT8: 32.0, ChannelIn.SOFT16: 8192.0,
              ChannelIn.FP32: 4.0}
    rng = np.random.default_rng(3)
    n = 2048
    bits = rng.integers(0, 2, n).astype(np.uint8)
    sym = 2 * conv_encode_np(bits).astype(np.float32) - 1

    for cfg in ALL_VALID_CONFIGS:
        packed = quantize_and_pack(jnp.asarray(sym), cfg.channel_in,
                                   scales[cfg.channel_in])
        m = cfg.get_message_len(2 * n)
        plan = plan_blocks(m, cfg.bits_per_pack, 512)
        out = np.asarray(decode_packed_xla(packed, cfg, plan))
        got = unpack_msb_first(out, cfg.bits_per_pack)[:m]
        assert np.array_equal(got, bits[cfg.extra_l: cfg.extra_l + m]), cfg


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise the fixed <repo>/.jax_cache."""
    import jax

    from tpu_viterbi.utils import cache

    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert cache.enable_compile_cache() == cache.CACHE_DIR
        assert cache.CACHE_DIR.endswith(".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_require_gpu_refuses_the_cpu():
    """Measurement entry points (bench.py, chip_smoke.py) fail without a
    GPU instead of timing the CPU."""
    import pytest

    from tpu_viterbi.utils.device import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()
