#!/usr/bin/env python
"""On-card smoke test: the decoder's main path on one GPU, end to end.

    python chip_smoke.py             # phases (a)-(e) on one card
    python chip_smoke.py --cards 4   # phase (f) only, on four cards

(a) device: platform, device_kind, count, card name and power limit;
    fails unless JAX runs on a GPU.
(b) the Hopper kernel against decode_packed_xla, bit for bit: every
    channel x pack width at 4M bits, SOFT8/b32 at 32M bits, and the b16 /
    fp16 metric modes (which the int32 kernel serves).
(c) the kernel against golden.golden_decode_block on the host for 64
    blocks of the 32M-bit plan, the first and the partial last included.
(d) the banded pack matmuls (pack_words, pack_words_2streams,
    fp32_ud_words) against a NumPy shift-or packer on adversarial fields
    at widths 1, 4, 8 and 16, at the card's default matmul precision.
(e) the entry points: the CLI at 32M bits and 15 dB (BEN 0), run_stream
    against run, an --emit-file / --decode-file / --stream-words round
    trip, and --e2e-device noiseless at 32M bits (BEN 0).
(f) --cards 4: decode_sharded over a 4-card mesh on 4 x 32M bits against
    the single-card XLA core under the same framing, then
    simulate_sharded noiseless (BEN 0).

Every phase raises on a mismatch, so any failure exits nonzero.  The last
line of stdout is {"ok": true, "device": {...}}.  Everything runs in this
one process (the CLI is called in process), so one process holds the card.
"""

import argparse
import contextlib
import io
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

T0 = time.time()


def log(msg):
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def workload(cfg, n_bits, seed, snr_db=5.5):
    """(message bits, packed channel words) on the device."""
    import jax

    from tpu_viterbi.chain import packed_workload
    from tpu_viterbi.sharding.simulate import DEFAULT_SCALES
    return jax.jit(lambda k: packed_workload(
        k, n_bits, cfg.channel_in, snr_db,
        DEFAULT_SCALES[cfg.channel_in]))(jax.random.PRNGKey(seed))


def kernel_vs_xla(cfg, n_bits, dec_len, seed):
    """Decode one workload on both cores; returns (equal, words)."""
    import jax

    from tpu_viterbi.decoder.core_cuda import decode_packed_cuda
    from tpu_viterbi.decoder.core_xla import decode_packed_xla, plan_blocks
    input_num = 2 * n_bits
    plan = plan_blocks(cfg.get_message_len(input_num), cfg.bits_per_pack,
                       dec_len)
    _, packed = workload(cfg, n_bits, seed)
    x = packed[:cfg.get_input_words(input_num)]
    a = np.asarray(jax.jit(lambda p: decode_packed_cuda(p, cfg, plan))(x))
    b = np.asarray(jax.jit(lambda p: decode_packed_xla(p, cfg, plan))(x))
    return np.array_equal(a, b), a.size


def phase_b():
    from tpu_viterbi.config import ChannelIn, DecodeOut, DecoderConfig, Metric
    cases = [(DecoderConfig(channel_in=c, decode_out=o), 4_000_000)
             for c in ChannelIn for o in DecodeOut]
    cases.append((DecoderConfig(channel_in=ChannelIn.SOFT8), 32_000_000))
    # b16 / fp16 metric modes ride the int32 kernel; the XLA core keeps
    # their own dtypes (SOFT8 x fp16 is not a valid combination)
    cases += [(DecoderConfig(channel_in=c, metric=mt), 4_000_000)
              for c, mt in ((ChannelIn.HARD, Metric.M_B16),
                            (ChannelIn.SOFT8, Metric.M_B16),
                            (ChannelIn.HARD, Metric.M_FP16),
                            (ChannelIn.SOFT4, Metric.M_FP16))]
    for i, (cfg, n) in enumerate(cases):
        eq, words = kernel_vs_xla(cfg, n, 2048, seed=100 + i)
        log(f"(b) {cfg.channel_in.name}/{cfg.metric.name}/"
            f"{cfg.decode_out.name} {n} bits: {words} words "
            f"{'equal' if eq else 'DIFFER'}")
        check(eq, f"kernel != XLA core for {cfg} at {n} bits")


def phase_c():
    import jax

    from tpu_viterbi.chain.quantize import unpack_to_soft
    from tpu_viterbi.config import ChannelIn, DecoderConfig
    from tpu_viterbi.decoder.api import DEFAULT_DEC_LEN
    from tpu_viterbi.decoder.core_cuda import decode_packed_cuda
    from tpu_viterbi.decoder.core_xla import plan_blocks
    from tpu_viterbi.decoder.golden import golden_decode_block
    from tpu_viterbi.utils.bits import unpack_msb_first

    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    n_bits = 32_000_000
    input_num = 2 * n_bits
    plan = plan_blocks(cfg.get_message_len(input_num), 32, DEFAULT_DEC_LEN)
    check(plan.overlap_bits > 0, "the 32M plan has no partial last block")
    _, packed = workload(cfg, n_bits, seed=7)
    x = packed[:cfg.get_input_words(input_num)]
    out = np.asarray(jax.jit(lambda p: decode_packed_cuda(p, cfg, plan))(x))
    bits = unpack_msb_first(out, 32)
    soft = np.asarray(unpack_to_soft(x, cfg.channel_in)).reshape(-1, 2)
    need = (plan.num_blocks - 1) * plan.dec_len + plan.block_len
    soft = np.concatenate([soft, np.zeros((need - len(soft), 2), soft.dtype)])
    rng = np.random.default_rng(0)
    blocks = np.unique(np.concatenate([
        [0, 1, plan.num_blocks - 2, plan.num_blocks - 1],
        rng.choice(plan.num_blocks, 60, replace=False)]))
    for k in blocks:
        off = int(k) * plan.dec_len
        want = golden_decode_block(
            soft[off:off + plan.block_len].astype(np.int64), plan.dec_len)
        n = min(plan.dec_len, plan.message_len - off)
        check(np.array_equal(bits[off:off + n], want[:n]),
              f"kernel != golden in block {k}")
    log(f"(c) golden agrees on {len(blocks)} of {plan.num_blocks} blocks "
        f"(first, partial last with {plan.overlap_bits} overlap bits)")


def _shift_or_pack(fields, width):
    per = 32 // width
    f = fields.astype(np.uint64).reshape(-1, per)
    shifts = (np.arange(per - 1, -1, -1, dtype=np.uint64) * width)
    return np.bitwise_or.reduce(f << shifts[None, :], axis=1) \
        .astype(np.uint32)


def phase_d():
    import jax.numpy as jnp

    from tpu_viterbi.chain.quantize import pack_words, pack_words_2streams
    from tpu_viterbi.config import FP_PRECISION
    from tpu_viterbi.decoder.core_xla import fp32_ud_words

    rng = np.random.default_rng(5)
    n = 1 << 21
    for width in (1, 4, 8, 16):
        top = (1 << width) - 1
        # adversarial: all-ones, single high bits, alternating patterns
        pool = np.array([0, top, 1 << (width - 1), top ^ (top >> 1),
                         0x5555 & top, 0xAAAA & top, top - 1], np.uint32)
        fields = np.where(rng.random(n) < 0.5, rng.choice(pool, n),
                          rng.integers(0, top + 1, n)).astype(np.uint32)
        got = np.asarray(pack_words(jnp.asarray(fields), width))
        check(np.array_equal(got, _shift_or_pack(fields, width)),
              f"pack_words inexact at width {width}")
        q0, q1 = fields[0::2], fields[1::2]
        got2 = np.asarray(pack_words_2streams(jnp.asarray(q0),
                                              jnp.asarray(q1), width))
        check(np.array_equal(got2, _shift_or_pack(fields, width)),
              f"pack_words_2streams inexact at width {width}")
    # FP32 (u, d) words: values straddling every trunc boundary of the
    # clamp window, plus out-of-window values
    lim = 1 << (FP_PRECISION - 1)
    v = np.concatenate([
        rng.integers(-lim - 2, lim + 2, n // 2) + rng.choice(
            np.array([0.0, 0.5, -0.5, 1e-6, -1e-6, 0.999999, -0.999999],
                     np.float32), n // 2),
        rng.standard_normal(n // 2) * 6]).astype(np.float32)
    got = np.asarray(fp32_ud_words(jnp.asarray(v))).view(np.uint32)
    # float32 arithmetic, as on the card: the sum's rounding decides the
    # trunc at the boundaries
    r = np.clip(v, np.float32(-lim), np.float32(lim - 1)).reshape(-1, 2)
    u = np.trunc(r[:, 0] + r[:, 1]).astype(np.int64) & 0xFF
    d = np.trunc(r[:, 0] - r[:, 1]).astype(np.int64) & 0xFF
    want = _shift_or_pack(np.stack([u, d], 1).reshape(-1), 8)
    check(np.array_equal(got[:want.size], want), "fp32_ud_words inexact")
    log(f"(d) pack matmuls exact: {n} fields at widths 1/4/8/16, "
        f"{n} FP32 values")


def run_cli(argv):
    """cli.main in this process; returns its stdout, raises on rc != 0."""
    from tpu_viterbi import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    check(rc == 0, f"cli {argv} exited {rc}:\n{out}")
    return out


def phase_e():
    from tpu_viterbi.config import ChannelIn, DecoderConfig
    from tpu_viterbi.decoder.api import ViterbiTPU

    out = run_cli(["-n", "32000000", "-s", "15", "-i", "s8", "-m", "b32",
                   "-v", "--seed", "3"])
    check("BEN: 0 " in out and "Decode core: cuda" in out, out)
    log("(e) CLI 32M bits at 15 dB: BEN 0 on the cuda core")

    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    n_bits = 4_000_000
    dec = ViterbiTPU(cfg)
    msgs = [np.asarray(workload(cfg, n_bits, seed=40 + i)[1])
            for i in range(4)]
    outs, per = dec.run_stream(msgs, 2 * n_bits)
    for msg, o in zip(msgs, outs):
        check(np.array_equal(o, dec.run(msg, 2 * n_bits)[0]),
              "run_stream != run")
    log(f"(e) run_stream of 4 messages equals run ({per * 1e3:.3f} ms/msg)")

    with tempfile.TemporaryDirectory() as tmp:
        ch = os.path.join(tmp, "c.bin")
        run_cli(["-n", "4000000", "-s", "6", "-i", "s8", "--seed", "9",
                 "--emit-file", ch])
        one, chunked = os.path.join(tmp, "one"), os.path.join(tmp, "chunk")
        run_cli(["-i", "s8", "--decode-file", ch, "--out-file", one])
        run_cli(["-i", "s8", "--decode-file", ch, "--out-file", chunked,
                 "--stream-words", "65536"])
        a = np.fromfile(one, np.uint32)
        b = np.fromfile(chunked, np.uint32)
        check(a.size > 0 and np.array_equal(a, b),
              "file decode != streamed file decode")
        raw = np.fromfile(ch, np.int32)
        ref, _ = ViterbiTPU(cfg, backend="xla").run(raw, raw.size * 4)
        check(np.array_equal(a, ref), "file decode != XLA core")
    log(f"(e) emit/decode-file/stream-words round trip bit-equal "
        f"({a.size} words)")

    out = run_cli(["-n", "32000000", "-s", "inf", "-i", "s8",
                   "--e2e-device", "-v", "--seed", "4"])
    check("BEN: 0 " in out and "decode core: cuda" in out, out)
    log("(e) --e2e-device 32M bits noiseless: BEN 0")


def phase_f(per_card=32_000_000):
    import jax

    from tpu_viterbi.config import ChannelIn, DecoderConfig
    from tpu_viterbi.sharding.blocks import decode_sharded, shard_reference
    from tpu_viterbi.sharding.mesh import make_block_mesh
    from tpu_viterbi.sharding.simulate import simulate_sharded

    devices = jax.devices()
    check(len(devices) >= 4, f"--cards 4 needs 4 GPUs, found {len(devices)}")
    mesh = make_block_mesh(devices[:4])
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    n_bits = 4 * per_card
    dec_len = 2048
    _, packed = workload(cfg, n_bits, seed=21)
    packed = np.asarray(packed)
    t = time.time()
    out, m = decode_sharded(packed, 2 * n_bits, cfg, mesh, dec_len=dec_len)
    log(f"(f) decode_sharded over 4 cards: {m} bits "
        f"({time.time() - t:.1f}s with compile)")
    with jax.default_device(devices[0]):
        ref = shard_reference(packed, cfg, 4, dec_len)
    check(np.array_equal(out, ref[:out.size]),
          "4-card sharded decode != single-card XLA core")
    log("(f) sharded decode bit-equal to the single-card XLA core")
    ben, m2 = simulate_sharded(cfg, n_bits, mesh, snr_db=math.inf, seed=6,
                               dec_len=dec_len)
    check(ben == 0, f"simulate_sharded noiseless BEN {ben}")
    log(f"(f) simulate_sharded noiseless over 4 cards: {m2} bits, BEN 0")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = p.parse_args()

    from tpu_viterbi.utils.cache import enable_compile_cache
    from tpu_viterbi.utils.device import (card_name_and_power_limit,
                                          require_gpu)
    device = require_gpu()
    log(f"(a) platform {device['platform']}, kind {device['kind']}, "
        f"count {device['count']}")
    print(card_name_and_power_limit(), flush=True)
    log(f"compile cache: {enable_compile_cache()}")
    from tpu_viterbi.decoder import core_cuda
    t = time.time()
    core_cuda.build()
    log(f"kernel library ready ({time.time() - t:.1f}s)")

    if args.cards == 4:
        phase_f()
    else:
        phase_b()
        phase_c()
        phase_d()
        phase_e()
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
