"""Block-parallel Viterbi decoder core — pure XLA (lax.scan) implementation.

The plain-JAX form of the reference's fused persistent kernel (reference:
src/viterbi/viterbi.cu:144-207 `viterbi_core`, viterbiACS.cuh,
viterbiTB.cuh), and the semantic reference the Hopper kernel
(core_cuda.py) is held to bit for bit.  It is the decode core off the GPU.
Key translations:

  - 6400 persistent warps, one time-block each  ->  B independent time-blocks
    batched on the minor axis of (64, B) path-metric tensors; a single
    lax.scan over stages advances every block in lockstep.
  - `__shfl_xor_sync` butterfly + 6-cycle shuffle-exchange state layout
    (viterbiACS.cuh:418-480)  ->  fixed state-indexed layout where the two
    predecessor-metric vectors are pairwise row-repeats of the lower/upper
    half of the state axis (see trellis.py) — static slices, no shuffles.
  - int16x2 / DPX packed-pair SIMD (viterbiACS.cuh:98-303)  ->  metric dtype
    parameter (int32 / int16 / float16).
  - per-warp circular survivor buffer + single-lane traceback
    (viterbiTB.cuh)  ->  survivor packs dumped every bits_per_pack stages to
    a (n_packs, 64, B) array; traceback is a lax.scan over pack index,
    vectorized across all B blocks with a one-hot gather.
  - warp-vote + shuffle-reduce PM renormalization (viterbiACS.cuh:307-378)
    ->  per-block (per-column) branchless renorm: each block subtracts
    its own column minimum when its column max exceeds the threshold.
    int32 metrics skip renorm entirely: unlike the reference's continuous
    per-warp stream, blocks here reset PMs to zero, so growth is bounded by
    dec_len * max|bm| (enforced at plan time).

Decision-bit and state conventions are documented in trellis.py/golden.py;
the two implementations must stay bit-identical (tested in
tests/test_decoder.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ChannelIn, DecoderConfig, Metric, NUM_STATES
from ..trellis import BRANCH_CODE_J0

WARMUP = 64          # extra_l + extra_r stages per block (viterbi.h:73-76)

# PM renorm thresholds (reference: viterbiACS.cuh:320, 341, 359)
_RENORM_LIMIT = {Metric.M_B16: 16000, Metric.M_B32: 10 ** 9,
                 Metric.M_FP16: 500.0}


def metric_dtype(metric: Metric):
    return {Metric.M_B32: jnp.int32, Metric.M_B16: jnp.int16,
            Metric.M_FP16: jnp.float16}[metric]


@dataclass(frozen=True)
class BlockPlan:
    """Static partition of a message into equal overlap-save blocks.

    All blocks decode `dec_len` output bits from `dec_len + 64` input
    stages; block k starts at k*dec_len (reference instead distributes
    remainder packs, viterbi.cu:156-162 — equal blocks keep every tensor
    and every warp's work uniform).  The last block's span may run past
    message_len; only its first dec_len - overlap_bits bits are kept
    (assemble_output), the rest — decoded from the zero-padded stream
    tail — are discarded.  get_message_len guarantees every KEPT bit's
    extra_r right halo is real input, so this "natural" framing is as
    valid as any, and no staging path needs a patch for the last block.
    """

    message_len: int
    dec_len: int
    num_blocks: int
    bits_per_pack: int

    @property
    def block_len(self) -> int:  # ACS stages per block
        return self.dec_len + WARMUP

    @property
    def n_packs(self) -> int:  # survivor packs per block
        return self.block_len // self.bits_per_pack

    @property
    def overlap_bits(self) -> int:  # discarded tail bits of the last block
        return self.num_blocks * self.dec_len - self.message_len

    def offsets(self) -> np.ndarray:
        return np.arange(self.num_blocks, dtype=np.int32) * self.dec_len


def plan_blocks(message_len: int, bits_per_pack: int,
                dec_len: int = 1024) -> BlockPlan:
    if message_len % bits_per_pack:
        raise ValueError("message_len must be a multiple of bits_per_pack")
    dec_len = max(bits_per_pack, min(dec_len, message_len))
    dec_len -= dec_len % bits_per_pack
    num_blocks = -(-message_len // dec_len)
    return BlockPlan(message_len, dec_len, num_blocks, bits_per_pack)


def auto_dec_len(message_len: int, bits_per_pack: int,
                 preferred: int = 1024, min_blocks: int = 1024) -> int:
    """Message-size-aware dec_len.  Large messages keep `preferred`; below
    preferred * min_blocks bits dec_len shrinks to ceil(m / min_blocks),
    rounded up to a pack multiple, so at least ~min_blocks blocks (one
    warp each in the Hopper kernel) stay in flight — the analog of the
    reference's remainder distribution keeping all warps busy at any n
    (viterbi.cu:156-162).  Floor WARMUP: below it the 64-stage halo
    dominates.

    Both constants come from a dec_len sweep of the kernel on an H200
    (PERF.md, PR 1): at 32M bits 1024 to 4096 are equal within noise and
    1024 is the best point, and at 1M bits 256 to 1024 are equal while
    2048 and up are slower."""
    if message_len >= preferred * min_blocks:
        return preferred
    dl = -(-message_len // min_blocks)
    dl = -(-dl // bits_per_pack) * bits_per_pack
    return max(WARMUP, min(preferred, dl))


_MAX_ABS_BM = {ChannelIn.HARD: 2, ChannelIn.SOFT4: 16,
               ChannelIn.SOFT8: 256, ChannelIn.SOFT16: 65536,
               ChannelIn.FP32: 16}


def needs_int32_renorm(cfg: DecoderConfig, plan: BlockPlan) -> bool:
    """int32 path metrics normally run renorm-free (blocks reset PMs to
    zero, so growth is bounded by block_len * max|bm|); once that bound
    approaches 2^31 the cores switch on the same periodic min-subtract
    renorm the b16/fp16 metrics always use (reference: viterbiACS.cuh:307-
    378 — its b32 threshold 10^9 is _RENORM_LIMIT[M_B32]).  Renorm is
    decision-invariant (a common subtrahend never changes a compare), so
    decodes are bit-identical either way; SOFT16 at dec_len >= ~16K stages
    is the binding case (tests/test_renorm.py pins the boundary)."""
    return plan.block_len * _MAX_ABS_BM[cfg.channel_in] >= (1 << 30)


def validate_plan(cfg: DecoderConfig, plan: BlockPlan) -> None:
    """Plan sanity guard (kept as the hook for future static checks).
    Plans past the renorm-free int32 bound decode correctly through
    needs_int32_renorm-gated renormalization in both cores."""
    del cfg, plan


def gather_blocks(r: jnp.ndarray, plan: BlockPlan) -> jnp.ndarray:
    """Global (S, 2) soft stage pairs -> (B, L, 2) per-block views (with the
    extra_l/extra_r halo materialized by overlapping slices).

    The readable reference staging; production entry points use
    stage_layout_packed below."""
    offs = jnp.asarray(plan.offsets())
    need = (plan.num_blocks - 1) * plan.dec_len + plan.block_len
    if r.shape[0] < need:   # natural framing: zero-pad the last block's tail
        pad = [(0, need - r.shape[0])] + [(0, 0)] * (r.ndim - 1)
        r = jnp.pad(r, pad)
    idx = offs[:, None] + jnp.arange(plan.block_len, dtype=jnp.int32)[None, :]
    return r[idx]


def overlapped_windows(x: jnp.ndarray, stride: int, win: int,
                       num: int) -> jnp.ndarray:
    """(N, ...) stream -> (num, win, ...) overlapping windows at `stride`
    without an index gather: ceil(win/stride) shifted reshaped views
    concatenated along the window axis.  The stream is zero-padded as needed; window k covers
    x[k*stride : k*stride + win]."""
    reps = -(-win // stride)
    need = (num + reps) * stride
    if x.shape[0] < need:
        pad = [(0, need - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        x = jnp.pad(x, pad)
    parts = [x[j * stride: (j + num) * stride]
             .reshape((num, stride) + x.shape[1:]) for j in range(reps)]
    out = parts[0] if reps == 1 else jnp.concatenate(parts, axis=1)
    return out[:, :win]


def stage_words(packed: jnp.ndarray, cfg: DecoderConfig,
                plan: BlockPlan, b_pad: int) -> jnp.ndarray:
    """Packed channel words -> (Lw, b_pad) word-major block layout.

    The block split (overlapped windows of shifted reshaped views) happens
    at *word* granularity — 1/dpp of the soft-value traffic.  FP32 channel
    values are treated as width-32 one-value words.  Natural framing: the
    last block's span past the stream is zero-padded (BlockPlan docstring)."""
    is_float = cfg.channel_in == ChannelIn.FP32
    dpp = 1 if is_float else cfg.enc_data_per_pack
    dl, B = plan.dec_len, plan.num_blocks
    wpb = 2 * dl // dpp                 # body words per block
    wph = 2 * WARMUP // dpp             # halo words per block
    Lw = wpb + wph

    blocks = overlapped_windows(packed, wpb, Lw, B)         # (B, Lw)

    if b_pad > B:
        blocks = jnp.concatenate(
            [blocks, jnp.zeros((b_pad - B, Lw), packed.dtype)], axis=0)

    return blocks.transpose(1, 0)                           # (Lw, b_pad)


def stage_layout_packed(packed: jnp.ndarray, cfg: DecoderConfig,
                        plan: BlockPlan, b_pad: int) -> jnp.ndarray:
    """Packed channel words -> (n_packs, bpp, 2, b_pad) scan-major staged
    stages.

    The block split runs at word granularity (stage_words) and the
    word->value unpack runs after the (Lw, B) transpose, so the dpp axis
    sits between two big dimensions.  FP32 channel values are clamped
    only (viterbiBM.cuh:139-151 semantics)."""
    from ..config import FP_PRECISION
    is_float = cfg.channel_in == ChannelIn.FP32
    dpp = 1 if is_float else cfg.enc_data_per_pack
    width = cfg.enc_data_width

    wt = stage_words(packed, cfg, plan, b_pad)              # (Lw, b_pad)

    if is_float:
        lo = -(1 << (FP_PRECISION - 1))
        hi = (1 << (FP_PRECISION - 1)) - 1
        vals = jnp.clip(wt, lo, hi)[:, None, :]
    else:
        u = wt.view(jnp.uint32)
        shifts = jnp.arange(dpp - 1, -1, -1, dtype=jnp.uint32)[None, :, None]
        vals = ((u[:, None, :] >> (shifts * width))
                & jnp.uint32((1 << width) - 1)).astype(jnp.int32)
        if cfg.channel_in == ChannelIn.HARD:
            vals = vals * 2 - 1
        elif width < 32:
            half = 1 << (width - 1)
            vals = ((vals + half) & ((1 << width) - 1)) - half

    return vals.reshape(plan.n_packs, plan.bits_per_pack, 2, b_pad)


def fp32_ud_words(vals: jnp.ndarray) -> jnp.ndarray:
    """FP32 interleaved channel values -> packed u/d integer words: the
    FP32 channel's 'word mode' wire.  Per stage the pair
    (u, d) = (trunc(r0 + r1), trunc(r0 - r1)) after the FPprecision clamp
    (reference clamp+trunc semantics: viterbiBM.cuh:139-151) is packed
    exactly like a SOFT8 stream — 4 signed 8-bit fields per int32 word,
    MSB = earliest, [u, d] interleaved per stage — so the Hopper kernel
    (core_cuda.py) reads FP32 at SOFT8's cost.

    Exactness: the branch metric is +-trunc(r0 +- r1); trunc is odd
    (trunc(-x) = -trunc(x)), so hoisting the trunc into staging leaves
    every branch metric bit-identical to the float path of the XLA core
    (tests/test_cuda_kernel.py; chip_smoke.py on the card).  u, d are in
    [-15, 14] after the clamp to [-8, 7], so 8-bit fields are exact.

    The r0/r1 deinterleave is two one-hot matmuls (each output an exact
    copy of one input) and the interleaved u/d packing is the strided
    banded-matrix matmul (chain.quantize.pack_words_2streams)."""
    from ..chain.quantize import _interleave_matrices, pack_words_2streams
    from ..config import FP_PRECISION
    lo = float(-(1 << (FP_PRECISION - 1)))
    hi = float((1 << (FP_PRECISION - 1)) - 1)
    v = jnp.clip(vals.astype(jnp.float32), lo, hi)
    pad = (-v.shape[0]) % 256
    if pad:
        v = jnp.concatenate([v, jnp.zeros((pad,), jnp.float32)])
    s0, s1 = _interleave_matrices()             # (64, 128) one-hot
    rows = v.reshape(-1, 128)
    # one-hot rows make each output an exact COPY of one f32 input, but
    # only at HIGHEST precision: a reduced-precision pass (TF32 on the GPU)
    # rounds the operand's mantissa.  chip_smoke.py checks the words
    # against a NumPy packer on trunc-boundary values on the card.
    r0 = jnp.dot(rows, jnp.asarray(s0.T), preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST).reshape(-1)
    r1 = jnp.dot(rows, jnp.asarray(s1.T), preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST).reshape(-1)
    qu = jnp.trunc(r0 + r1).astype(jnp.int32).astype(jnp.uint32) \
        & jnp.uint32(0xFF)
    qd = jnp.trunc(r0 - r1).astype(jnp.int32).astype(jnp.uint32) \
        & jnp.uint32(0xFF)
    return pack_words_2streams(qu, qd, 8).astype(jnp.int32)


# BPSK sign of each expected coded bit on the j=0 branch, per state:
# +1 where the expected bit is 1 (correlation convention of the reference's
# dp2a/dp4a coefficient tables, viterbiBM.cuh:45-124).
_SIGN0_NP = (2 * ((BRANCH_CODE_J0 >> 1) & 1) - 1).astype(np.int32)[:, None]
_SIGN1_NP = (2 * (BRANCH_CODE_J0 & 1) - 1).astype(np.int32)[:, None]


def _branch_metrics(r0, r1, cfg: DecoderConfig):
    """(64, B) j=0 branch metrics bmA[s] = sign0[s]*r0 + sign1[s]*r1
    (reference: viterbiBM.cuh — dp2a/dp4a correlations with +-1 coeffs).
    The j=1 metric is -bmA (see _acs_stage)."""
    mdtype = metric_dtype(cfg.metric)
    if cfg.channel_in == ChannelIn.FP32:
        # reference truncates the float correlation toward zero
        # (viterbiBM.cuh:128-153: static_cast<int>)
        s0 = jnp.asarray(_SIGN0_NP, jnp.float32)
        s1 = jnp.asarray(_SIGN1_NP, jnp.float32)
        bmA = jnp.trunc(s0 * r0[None, :] + s1 * r1[None, :])
        return bmA.astype(mdtype)
    s0 = jnp.asarray(_SIGN0_NP).astype(mdtype)
    s1 = jnp.asarray(_SIGN1_NP).astype(mdtype)
    r0 = r0.astype(mdtype)
    r1 = r1.astype(mdtype)
    return s0 * r0[None, :] + s1 * r1[None, :]


def _repeat2(x):
    """Pairwise row repeat [x0,x0,x1,x1,...]: broadcast+reshape (layout ops)
    instead of jnp.repeat (gather)."""
    h, b = x.shape
    return jnp.broadcast_to(x[:, None, :], (h, 2, b)).reshape(2 * h, b)


def _acs_stage(pm, pp, bmA):
    """One add-compare-select stage over all 64 states x B blocks.

    bmA is the j=0 branch metric per state; the j=1 metric is exactly -bmA
    because both generator polynomials tap the dropped bit b_{t-6} (bit 0 of
    0o171 and 0o133), so flipping j flips both coded bits and negates the
    correlation."""
    pm_lo = _repeat2(pm[:32])                # predecessors (s>>1)
    pm_hi = _repeat2(pm[32:])                # predecessors (s>>1)+32
    cand0 = pm_lo + bmA
    cand1 = pm_hi - bmA
    dec = cand1 > cand0                      # tie -> j=0 (matches golden)
    pm_new = jnp.where(dec, cand1, cand0)
    pp_lo = _repeat2(pp[:32])
    pp_hi = _repeat2(pp[32:])
    pp_new = (jnp.where(dec, pp_hi, pp_lo) << 1) | dec.astype(jnp.uint32)
    return pm_new, pp_new


def _renorm(pm, cfg: DecoderConfig):
    """Per-block branchless PM renormalization (cf. viterbiACS.cuh:307-378)."""
    limit = _RENORM_LIMIT[cfg.metric]
    col_max = jnp.max(pm, axis=0, keepdims=True)
    col_min = jnp.min(pm, axis=0, keepdims=True)
    shift = jnp.where(col_max > jnp.asarray(limit, pm.dtype), col_min,
                      jnp.zeros_like(col_min))
    return pm - shift


@functools.partial(jax.jit, static_argnames=("cfg", "plan"))
def forward_scan(r_blocks: jnp.ndarray, cfg: DecoderConfig,
                 plan: BlockPlan) -> jnp.ndarray:
    """ACS over all stages for all blocks.  r_blocks: (B, L, 2) soft values.
    Returns survivor packs (n_packs, 64, B) uint32."""
    # scan-major layout: (n_packs, bpp, 2, B)
    rs = r_blocks.transpose(1, 2, 0).reshape(plan.n_packs,
                                             plan.bits_per_pack, 2,
                                             r_blocks.shape[0])
    return forward_scan_staged(rs, cfg, plan)


@functools.partial(jax.jit, static_argnames=("cfg", "plan"))
def forward_scan_staged(rs: jnp.ndarray, cfg: DecoderConfig,
                        plan: BlockPlan) -> jnp.ndarray:
    """ACS from the scan-major (n_packs, bpp, 2, B) stage layout (the
    output of stage_layout_packed).  Returns (n_packs, 64, B) uint32."""
    B = rs.shape[3]
    bpp = plan.bits_per_pack
    do_renorm = (cfg.metric in (Metric.M_B16, Metric.M_FP16)
                 or needs_int32_renorm(cfg, plan))
    mdtype = metric_dtype(cfg.metric)

    pm0 = jnp.zeros((NUM_STATES, B), dtype=mdtype)
    pp0 = jnp.zeros((NUM_STATES, B), dtype=jnp.uint32)

    def stage_step(carry, rt):
        pm, pp = carry
        bmA = _branch_metrics(rt[0], rt[1], cfg)
        pm, pp = _acs_stage(pm, pp, bmA)
        return (pm, pp), None

    def pack_step(carry, r_pack):
        carry, _ = jax.lax.scan(stage_step, carry, r_pack, unroll=bpp)
        pm, pp = carry
        if do_renorm:
            pm = _renorm(pm, cfg)
        dump = pp if bpp == 32 else (pp & jnp.uint32(0xFFFF))
        return (pm, pp), dump

    (_, _), surv = jax.lax.scan(pack_step, (pm0, pp0), rs)
    return surv


@functools.partial(jax.jit, static_argnames=("cfg", "plan"))
def traceback_scan(surv: jnp.ndarray, cfg: DecoderConfig,
                   plan: BlockPlan) -> jnp.ndarray:
    """Vectorized sliding-window traceback over survivor packs.

    Replaces the reference's single-lane state chase (viterbiTB.cuh:4-21)
    with a pack-granular scan batched over all blocks; the per-block dynamic
    state index becomes a one-hot select+reduce over the 64-state axis.
    Returns (B, dec_len / bpp) output packs, oldest first.
    """
    bpp = plan.bits_per_pack
    n_conv = -(-(cfg.extra_r - bpp) // bpp)   # packs consumed for convergence
    n_emit = plan.dec_len // bpp
    shift = jnp.uint32(bpp - 6)
    B = surv.shape[2]

    # packs visited, newest first: indices n_packs-1 .. n_packs-n_conv-n_emit
    lo = plan.n_packs - n_conv - n_emit
    seq = surv[lo:][::-1]                     # (n_conv + n_emit, 64, B)

    states = jax.lax.broadcasted_iota(jnp.int32, (NUM_STATES, 1), 0)

    def tb_step(state, surv_kp):
        onehot = states == state[None, :]
        pack = jnp.where(onehot, surv_kp, jnp.uint32(0)).sum(
            axis=0, dtype=jnp.uint32)
        new_state = ((pack >> shift) & jnp.uint32(63)).astype(jnp.int32)
        return new_state, pack

    _, packs = jax.lax.scan(tb_step, jnp.zeros((B,), jnp.int32), seq)
    out = packs[n_conv:][::-1]                # (n_emit, B), oldest first
    return out.transpose(1, 0)


@functools.partial(jax.jit, static_argnames=("cfg", "plan"))
def assemble_output(out_packs: jnp.ndarray, cfg: DecoderConfig,
                    plan: BlockPlan) -> jnp.ndarray:
    """(B, n_emit) per-block packs -> flat packed output words.

    Blocks 0..B-2 contribute their full span; the last block contributes
    only its first dec_len - overlap_bits bits (the rest ran past
    message_len into the zero-padded tail), so the decoded stream covers
    exactly [0, message_len) with the reference's bit<->pack mapping (MSB =
    earliest, main.cpp:160)."""
    ov_words = plan.overlap_bits // plan.bits_per_pack
    if plan.num_blocks == 1:
        n_emit = out_packs.shape[1]
        words = out_packs[0, : n_emit - ov_words]
    else:
        head = out_packs[:-1].reshape(-1)
        n_emit = out_packs.shape[1]
        tail = out_packs[-1, : n_emit - ov_words]
        words = jnp.concatenate([head, tail])
    if plan.bits_per_pack == 16:
        return words.astype(jnp.uint16)
    return words


def decode_blocks(r_blocks: jnp.ndarray, cfg: DecoderConfig,
                  plan: BlockPlan) -> jnp.ndarray:
    """Full block-parallel decode: (B, L, 2) soft values -> packed words."""
    validate_plan(cfg, plan)
    surv = forward_scan(r_blocks, cfg, plan)
    out_packs = traceback_scan(surv, cfg, plan)
    return assemble_output(out_packs, cfg, plan)


@functools.partial(jax.jit, static_argnames=("cfg", "plan"))
def decode_packed_xla(packed: jnp.ndarray, cfg: DecoderConfig,
                      plan: BlockPlan) -> jnp.ndarray:
    """Full decode straight from packed channel words on the XLA scan core
    (the decode core off the GPU, and the reference the Hopper kernel is
    checked against).  Staging is word-granular (stage_layout_packed)."""
    validate_plan(cfg, plan)
    is_float = cfg.channel_in == ChannelIn.FP32
    packed = packed.astype(jnp.float32 if is_float else jnp.int32)
    rs = stage_layout_packed(packed, cfg, plan, plan.num_blocks)
    surv = forward_scan_staged(rs, cfg, plan)
    out_packs = traceback_scan(surv, cfg, plan)
    return assemble_output(out_packs, cfg, plan)
