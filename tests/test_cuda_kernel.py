"""CPU coverage of the Hopper decode kernel (csrc/viterbi_hopper.cu).

A CUDA kernel has no interpret mode, so its arithmetic is checked here
through `mirror_kernel`, a NumPy transcription of the kernel's per-lane
steps (rotating two-states-per-lane layout, xor-shuffle exchange, chunked
word broadcast, survivor dump, one-lane traceback).  It runs on exactly the
operands, attributes and result shapes the FFI wrapper builds
(core_cuda.kernel_words / kernel_attrs / kernel_result_shapes) and feeds
core_xla.assemble_output, and must reproduce decode_packed_xla bit for bit.
The kernel itself is compared with the XLA core on the card by
chip_smoke.py; tests marked `gpu` run it there through pytest.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_viterbi.chain.encode import conv_encode_np
from tpu_viterbi.chain.quantize import quantize_and_pack
from tpu_viterbi.config import (ChannelIn, ConfigResolutionError, DecodeOut,
                                DecoderConfig, Metric)
from tpu_viterbi.decoder import core_cuda
from tpu_viterbi.decoder.api import ViterbiTPU, resolve_backend
from tpu_viterbi.decoder.core_xla import (WARMUP, assemble_output,
                                          decode_packed_xla, plan_blocks,
                                          stage_layout_packed)
from tpu_viterbi.trellis import BRANCH_CODE_J0

_WIDTH = {0: 1, 1: 4, 2: 8, 3: 16, 4: 8}
_LANES = np.arange(32)


def _rotl5(x, p):
    p %= 5
    return ((x << p) | (x >> (5 - p))) & 31


def _field(w, f, width, hard):
    """Field f (0 = MSB) of uint32 words w, signed (HARD -> +-1)."""
    w = np.asarray(w, np.uint32)
    if hard:
        return ((w >> np.uint32(31 - f)) & np.uint32(1)).astype(np.int32) * 2 - 1
    return (w << np.uint32(width * f)).view(np.int32) >> (32 - width)


def _coefficients(mode):
    """(5, 32) per-phase branch-metric coefficients, as the kernel derives
    them from the reversed generator taps."""
    s = 2 * np.stack([_rotl5(_LANES, p) for p in range(5)])
    par = np.vectorize(lambda v: bin(v).count("1") & 1)
    s0 = 2 * par(s & 0o117) - 1
    s1 = 2 * par(s & 0o155) - 1
    if mode == 4:
        return np.where(s0 == s1, s0, 0), np.where(s0 == s1, 0, s0)
    return s0, s1


def mirror_kernel(words: np.ndarray, mode: int, bpp: int, dec_len: int,
                  num_blocks: int, renorm: int) -> np.ndarray:
    """NumPy transcription of viterbi_kernel: returns the (B * n_emit,)
    uint32 output packs.  Blocks are a leading batch axis; lanes the
    second."""
    width = _WIDTH[mode]
    dpp = 32 // width
    spw = dpp // 2
    wpp = bpp // spw
    ppc = 32 // wpp
    n_packs = (dec_len + WARMUP) // bpp
    n_words = words.shape[0]
    words = words.view(np.uint32)
    base = np.arange(num_blocks)[:, None] * (2 * dec_len // dpp)
    ca, cb = _coefficients(mode)

    def load_chunk(c):
        idx = base + 32 * c + _LANES[None, :]
        safe = np.minimum(idx, n_words - 1)
        return np.where(idx < n_words, words[safe], np.uint32(0))

    pm0 = np.zeros((num_blocks, 32), np.int32)
    pm1 = np.zeros_like(pm0)
    pp0 = np.zeros((num_blocks, 32), np.uint32)
    pp1 = np.zeros_like(pp0)
    wcur = None
    wnext = load_chunk(0)
    surv = np.zeros((num_blocks, n_packs, 64), np.uint32)
    for k in range(n_packs):
        if k % ppc == 0:
            wcur, wnext = wnext, load_chunk(k // ppc + 1)
        ph0 = (k * bpp) % 5
        for s in range(bpp):
            ph = (ph0 + s) % 5
            if s % spw == 0:
                w = wcur[:, (k * wpp + s // spw) & 31][:, None]
            f = (2 * s) % dpp
            x = _field(w, f, width, mode == 0)
            y = _field(w, f + 1, width, mode == 0)
            bm = (ca[ph] * x + cb[ph] * y).astype(np.int32)
            e0, e1 = pm0 + bm, pm1 - bm
            o0, o1 = pm0 - bm, pm1 + bm
            de, do = e1 > e0, o1 > o0
            ne, no = np.where(de, e1, e0), np.where(do, o1, o0)
            qe = (np.where(de, pp1, pp0) << np.uint32(1)) | de.astype(np.uint32)
            qo = (np.where(do, pp1, pp0) << np.uint32(1)) | do.astype(np.uint32)
            m = (9 - ph) % 5
            hi = ((_LANES >> m) & 1).astype(bool)[None, :]
            partner = _LANES ^ (1 << m)
            rpm = np.where(hi, ne, no)[:, partner]
            rpp = np.where(hi, qe, qo)[:, partner]
            pm0, pm1 = np.where(hi, rpm, ne), np.where(hi, no, rpm)
            pp0, pp1 = np.where(hi, rpp, qe), np.where(hi, qo, rpp)
        st = _rotl5(_LANES, (ph0 + bpp) % 5)
        surv[:, k, st] = pp0
        surv[:, k, st + 32] = pp1
        if renorm:
            mn = np.minimum(pm0, pm1).min(axis=1, keepdims=True)
            pm0, pm1 = pm0 - mn, pm1 - mn

    n_emit = dec_len // bpp
    n_conv = -(-(38 - bpp) // bpp)
    lo = n_packs - n_conv - n_emit
    out = np.zeros((num_blocks, n_emit), np.uint32)
    state = np.zeros(num_blocks, np.int64)
    rows = np.arange(num_blocks)
    for k in range(n_packs - 1, lo - 1, -1):
        v = surv[rows, k, state]
        if k < lo + n_emit:
            out[:, k - lo] = v & np.uint32(0xFFFF) if bpp == 16 else v
        state = ((v >> np.uint32(bpp - 6)) & np.uint32(63)).astype(np.int64)
    return out.reshape(-1)


def _mirror_decode(packed, cfg, plan):
    """decode_packed_cuda with the FFI call replaced by mirror_kernel."""
    words = np.asarray(core_cuda.kernel_words(jnp.asarray(packed), cfg))
    attrs = core_cuda.kernel_attrs(cfg, plan)
    assert attrs["dec_len"] == plan.dec_len
    packs = mirror_kernel(words, **attrs)
    out_shape, surv_shape = core_cuda.kernel_result_shapes(plan)
    assert packs.shape == out_shape.shape and packs.dtype == out_shape.dtype
    assert surv_shape.shape == (plan.num_blocks * plan.n_packs * 64,)
    return np.asarray(assemble_output(jnp.asarray(packs).reshape(
        plan.num_blocks, -1), cfg, plan))


def _coded_stream(rng, cfg, message_len, sigma):
    bits = rng.integers(0, 2, message_len + 256).astype(np.uint8)
    coded = conv_encode_np(bits).astype(np.float32)
    x = (2.0 * coded - 1.0) + sigma * rng.standard_normal(coded.shape)
    scale = {ChannelIn.HARD: 1.0, ChannelIn.SOFT4: 4.0, ChannelIn.SOFT8: 32.0,
             ChannelIn.SOFT16: 8192.0, ChannelIn.FP32: 4.0}[cfg.channel_in]
    return np.asarray(quantize_and_pack(jnp.asarray(x.astype(np.float32)),
                                        cfg.channel_in, scale))


def test_branch_coefficients_match_trellis():
    """The kernel's per-lane sign derivation equals trellis.BRANCH_CODE_J0
    for the even child it computes, in every phase."""
    s0, s1 = _coefficients(2)
    for p in range(5):
        code = BRANCH_CODE_J0[2 * _rotl5(_LANES, p)]
        np.testing.assert_array_equal(s0[p], 2 * ((code >> 1) & 1) - 1)
        np.testing.assert_array_equal(s1[p], 2 * (code & 1) - 1)


def test_layout_is_a_permutation_with_period_five():
    """Every phase maps (lane, register) onto all 64 states once, and the
    exchange partner of phase p moves exactly the children's bit 5."""
    for p in range(5):
        states = np.concatenate([_rotl5(_LANES, p), _rotl5(_LANES, p) + 32])
        assert sorted(states) == list(range(64))
        m = (9 - p) % 5
        i = _rotl5(_LANES, p)
        j = _rotl5(_LANES ^ (1 << m), p)
        np.testing.assert_array_equal(((2 * i) ^ (2 * j)), np.full(32, 32))
    np.testing.assert_array_equal(_rotl5(_LANES, 5), _LANES)


@pytest.mark.parametrize("channel", list(ChannelIn))
@pytest.mark.parametrize("decode_out", list(DecodeOut))
@pytest.mark.parametrize("dec_len", [256, 32])
def test_mirror_matches_xla_core(rng, channel, decode_out, dec_len):
    """Every channel x pack width on noisy coded input, with a natural
    partial last block and with the smallest blocks a plan allows: the
    kernel's arithmetic equals the XLA core."""
    cfg = DecoderConfig(channel_in=channel, decode_out=decode_out)
    input_num = 2 * (1536 + 8 * 32)
    m = cfg.get_message_len(input_num)
    plan = plan_blocks(m, cfg.bits_per_pack, dec_len)
    assert plan.overlap_bits > 0 or dec_len < 256
    packed = _coded_stream(rng, cfg, input_num // 2, 0.9)
    packed = packed[:cfg.get_input_words(input_num)]
    want = np.asarray(decode_packed_xla(jnp.asarray(packed), cfg, plan))
    got = _mirror_decode(packed, cfg, plan)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channel", [ChannelIn.SOFT8, ChannelIn.SOFT16])
def test_mirror_renorm_is_decision_invariant(rng, channel):
    """The kernel's per-pack min-subtract (renorm attribute) leaves every
    decision unchanged, on random full-range words."""
    cfg = DecoderConfig(channel_in=channel)
    m = 640
    plan = plan_blocks(m, 32, 160)
    words = rng.integers(-2 ** 31, 2 ** 31, cfg.get_input_words(2 * m + 128),
                         dtype=np.int64).astype(np.int32)
    attrs = core_cuda.kernel_attrs(cfg, plan)
    a = mirror_kernel(words, **dict(attrs, renorm=0))
    b = mirror_kernel(words, **dict(attrs, renorm=1))
    np.testing.assert_array_equal(a, b)
    want = np.asarray(decode_packed_xla(jnp.asarray(words), cfg, plan))
    got = np.asarray(assemble_output(jnp.asarray(b).reshape(
        plan.num_blocks, -1), cfg, plan))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channel", list(ChannelIn))
@pytest.mark.parametrize("bpp", [16, 32])
def test_block_reads_match_staged_layout(rng, channel, bpp):
    """The words block b reads (offset b * wpb, halo included, zeros past
    the stream) unpack to exactly stage_layout_packed's stage values; FP32
    (u, d) words give trunc(r0 +- r1) of its clamped floats."""
    cfg = DecoderConfig(channel_in=channel,
                        decode_out=DecodeOut.O_B16 if bpp == 16
                        else DecodeOut.O_B32)
    m = 704
    plan = plan_blocks(m, bpp, 192)
    n_vals = 2 * (m + 64)
    if channel == ChannelIn.FP32:
        packed = (rng.standard_normal(n_vals) * 6).astype(np.float32)
    else:
        packed = rng.integers(-2 ** 31, 2 ** 31, cfg.get_input_words(n_vals),
                              dtype=np.int64).astype(np.int32)
    words = np.asarray(core_cuda.kernel_words(jnp.asarray(packed), cfg))
    mode = core_cuda.kernel_attrs(cfg, plan)["mode"]
    width = _WIDTH[mode]
    dpp = 32 // width
    L = plan.block_len
    staged = np.asarray(stage_layout_packed(
        jnp.asarray(packed, jnp.float32 if channel == ChannelIn.FP32
                    else jnp.int32), cfg, plan, plan.num_blocks))
    staged = staged.reshape(L, 2, plan.num_blocks)
    for b in range(plan.num_blocks):
        base = b * (2 * plan.dec_len // dpp)
        idx = base + np.arange(2 * L // dpp)
        w = np.where(idx < words.size, words[np.minimum(idx, words.size - 1)],
                     0).astype(np.int32)
        fields = np.stack([_field(w, f, width, mode == 0)
                           for f in range(dpp)], axis=1).reshape(L, 2)
        r = staged[:, :, b]
        if channel == ChannelIn.FP32:
            r = np.stack([np.trunc(r[:, 0] + r[:, 1]),
                          np.trunc(r[:, 0] - r[:, 1])], axis=1)
        np.testing.assert_array_equal(fields, r.astype(np.int32))


@pytest.mark.parametrize("channel,metric,bpp,dec_len,renorm", [
    (ChannelIn.SOFT8, Metric.M_B32, 32, 8192, 0),
    (ChannelIn.HARD, Metric.M_B16, 16, 2048, 0),
    (ChannelIn.SOFT4, Metric.M_FP16, 32, 1024, 0),
    (ChannelIn.FP32, Metric.M_B32, 16, 512, 0),
    (ChannelIn.SOFT16, Metric.M_B32, 32, 16384, 1),
])
def test_kernel_attrs_and_shapes(channel, metric, bpp, dec_len, renorm):
    """Attributes per config: the int32 kernel serves every metric mode,
    FP32 is mode 4 ((u, d) words), renorm follows needs_int32_renorm, and
    the result shapes follow the plan."""
    cfg = DecoderConfig(channel_in=channel, metric=metric,
                        decode_out=DecodeOut.O_B16 if bpp == 16
                        else DecodeOut.O_B32)
    plan = plan_blocks(4 * dec_len + 3 * bpp, bpp, dec_len)
    attrs = core_cuda.kernel_attrs(cfg, plan)
    assert attrs == dict(mode=4 if channel == ChannelIn.FP32
                         else int(channel), bpp=bpp, dec_len=dec_len,
                         num_blocks=5, renorm=renorm)
    out, surv = core_cuda.kernel_result_shapes(plan)
    assert out.shape == (5 * dec_len // bpp,)
    assert surv.shape == (5 * (dec_len + 64) // bpp * 64,)
    assert out.dtype == surv.dtype == jnp.uint32


def test_backend_resolution_on_cpu():
    """'auto' picks the XLA core off the GPU; 'cuda' raises there; unknown
    names are rejected."""
    assert resolve_backend("auto") == "xla"
    assert resolve_backend("xla") == "xla"
    with pytest.raises(ConfigResolutionError, match="GPU"):
        resolve_backend("cuda")
    with pytest.raises(ValueError, match="backend"):
        resolve_backend("pallas")
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    assert ViterbiTPU(cfg, dec_len=256).core == "xla"
    with pytest.raises(ConfigResolutionError):
        ViterbiTPU(cfg, dec_len=256, backend="cuda")


def test_build_uses_sm90a(monkeypatch, tmp_path):
    """The library is built for sm_90a from the tracked source into an
    ignored build directory; a failed build raises instead of falling back."""
    calls = []

    class _Res:
        returncode = 1
        stderr = "nvcc: not found"

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return _Res()

    monkeypatch.setattr(core_cuda, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(core_cuda.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        core_cuda.build()
    (cmd,) = calls
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert core_cuda.SOURCE in cmd
    assert not (tmp_path / "lib.so").exists()


@pytest.mark.gpu
@pytest.mark.parametrize("channel", list(ChannelIn))
def test_kernel_matches_xla_core_on_gpu(rng, channel):
    """On the card: the compiled kernel equals the XLA core."""
    cfg = DecoderConfig(channel_in=channel)
    input_num = 2 * (8192 + 96)
    m = cfg.get_message_len(input_num)
    plan = plan_blocks(m, 32, 1024)
    packed = _coded_stream(rng, cfg, input_num // 2, 0.9)
    x = jnp.asarray(packed[:cfg.get_input_words(input_num)])
    np.testing.assert_array_equal(
        np.asarray(core_cuda.decode_packed_cuda(x, cfg, plan)),
        np.asarray(decode_packed_xla(x, cfg, plan)))
