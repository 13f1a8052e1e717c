#!/usr/bin/env python
"""Benchmark harness: decoded throughput on the GPU.

    python bench.py [message_bits]        (default 32000000)

Prints ONE JSON line:
  {"metric": "decoded_throughput_soft8_b32", "value": Gb/s, ...}

Headline config: K=7 rate-1/2, SOFT8 input, int32 metrics, b32 packs, the
reference's default size (SURVEY.md §6).  Every time is wall clock around
work that ends in block_until_ready, median of repeats, with the
quartiles beside it:

  value          decoded Gb/s of one ViterbiTPU.run (input device
                 resident, output blocked on — the reference's cudaEvent
                 boundary around its kernel, viterbi.cu:224-232)
  e2e_gbps       the in-graph loop: generation + decode + BER count as one
                 jitted program (sharding/simulate.py), per call
  sustained_gbps ViterbiTPU.run_stream over 10 queued messages

The JSON names the device (platform, device_kind, count), the card's name
and power limit, and the decode core that ran.  Without a GPU it exits
nonzero and prints no result.
"""

import json
import sys
import time

import numpy as np

REPEATS = 10


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _stats(ts):
    ts = np.asarray(ts)
    return (float(np.median(ts)), float(np.percentile(ts, 25)),
            float(np.percentile(ts, 75)))


def main():
    import jax

    from tpu_viterbi.utils.cache import enable_compile_cache
    from tpu_viterbi.utils.device import (card_name_and_power_limit,
                                          require_gpu)
    try:
        device = require_gpu()
    except RuntimeError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 1
    card = card_name_and_power_limit()
    enable_compile_cache()

    from tpu_viterbi.chain import packed_workload
    from tpu_viterbi.chain.quantize import pack_words
    from tpu_viterbi.config import ChannelIn, DecoderConfig
    from tpu_viterbi.decoder.api import ViterbiTPU
    from tpu_viterbi.sharding.mesh import make_block_mesh
    from tpu_viterbi.sharding.simulate import build_sharded_simulation

    message_len = int(sys.argv[1]) if len(sys.argv) > 1 else 32_000_000
    snr_db = 5.5
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    input_num = 2 * message_len
    m = cfg.get_message_len(input_num)
    dec = ViterbiTPU(cfg, dec_len="auto")
    _log(f"{card}; m={m}; decode core {dec.core}")

    @jax.jit
    def make_workload(key):
        bits, packed = packed_workload(key, message_len, ChannelIn.SOFT8,
                                       snr_db, 32.0)
        ref = pack_words(
            bits[cfg.extra_l: cfg.extra_l + m].astype(jax.numpy.uint32), 1)
        return packed, ref

    inputs = [jax.block_until_ready(make_workload(jax.random.PRNGKey(42 + i)))
              for i in range(REPEATS + 1)]
    t0 = time.perf_counter()
    dec.run(inputs[0][0], input_num, want_time=False)     # compile
    compile_s = time.perf_counter() - t0
    times, errors = [], 0
    for packed, ref in inputs[1:]:
        out, t = dec.run(packed, input_num)
        times.append(t)
        errors += int(np.unpackbits(
            (out ^ np.asarray(ref)).view(np.uint8)).sum())
    kernel_s, q1, q3 = _stats(times)
    ber = errors / (m * REPEATS)
    _log(f"decode {kernel_s * 1e3:.3f} ms (IQR {q1 * 1e3:.3f}-"
         f"{q3 * 1e3:.3f}); BER {ber:.3g}")
    if ber > 1e-2:
        print(f"bench.py: BER {ber:.3g} too high", file=sys.stderr)
        return 1
    plan = dec._plan
    result = {
        "metric": "decoded_throughput_soft8_b32",
        "value": m / kernel_s / 1e9,
        "unit": "Gb/s",
        "message_len": message_len,
        "kernel_seconds": kernel_s,
        "kernel_seconds_iqr": [q1, q3],
        "compile_seconds": compile_s,
        "repeats": REPEATS,
        "ber_at_5p5dB": ber,
        "core": dec.core,
        "dec_len": plan.dec_len,
        "device": device,
        "card": card,
    }

    sim, m_e2e = build_sharded_simulation(
        cfg, message_len, make_block_mesh(jax.devices()[:1]),
        snr_db=snr_db, dec_len=plan.dec_len)
    ben = int(sim(jax.random.PRNGKey(1000)))                 # compile
    e2e = []
    for i in range(REPEATS):
        t0 = time.perf_counter()
        ben += int(jax.block_until_ready(sim(jax.random.PRNGKey(1001 + i))))
        e2e.append(time.perf_counter() - t0)
    e2e_s, q1, q3 = _stats(e2e)
    result.update({"e2e_seconds": e2e_s, "e2e_seconds_iqr": [q1, q3],
                   "e2e_gbps": m_e2e / e2e_s / 1e9,
                   "e2e_ber": ben / (m_e2e * (REPEATS + 1))})

    msgs = [p for p, _ in inputs[:REPEATS]]
    dec.run_stream(msgs[:1], input_num, want_time=False)
    _, per = dec.run_stream(msgs, input_num)
    result.update({"sustained_seconds_per_msg": per,
                   "sustained_gbps": m / per / 1e9})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
