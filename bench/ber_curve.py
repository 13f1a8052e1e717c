"""BER-vs-SNR curve harness.

Sweeps SNR points for a set of decoder configs, decodes on the current
backend, and emits a JSON table plus an aligned text table.  The golden
numpy decoder can be included at small message sizes as the parity
reference (--golden), standing in for the reference implementation's curve
(the reference validates exclusively through this curve, src/main.cpp:151-171).

Usage:
    python -m bench.ber_curve --num 2000000 --snrs 3,3.5,...,8
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


# Quantizer scale per channel width, chosen so a unit-amplitude BPSK symbol
# uses ~1/4 of the quantizer range (noise headroom ~4 sigma before clipping).
# The reference driver's fixed scale=40000 (main.cpp:137) saturates every
# soft format to full scale, collapsing soft-decision gain to hard-decision
# performance — a driver quirk, not a capability; the decoder itself is
# scale-agnostic, so the curve harness picks informative scales.
def _default_scale(channel_in):
    return {"HARD": 40000.0, "SOFT4": 4.0, "SOFT8": 32.0,
            "SOFT16": 8192.0, "FP32": 4.0}[channel_in.name]


def run_point(cfg, message_len, snr_db, seed, backend="auto", dec=None):
    import jax
    import jax.numpy as jnp

    from tpu_viterbi.chain import add_awgn, conv_encode, quantize_and_pack
    from tpu_viterbi.chain.channel import snr_to_sigma
    from tpu_viterbi.chain.source import random_bits
    from tpu_viterbi.decoder.api import ViterbiTPU
    from tpu_viterbi.utils.bits import count_bit_errors

    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    bits = random_bits(k1, message_len)
    coded = conv_encode(bits)
    noisy = add_awgn(k2, coded, snr_to_sigma(snr_db))
    packed = np.asarray(quantize_and_pack(noisy, cfg.channel_in,
                                          _default_scale(cfg.channel_in)))
    if dec is None:
        dec = ViterbiTPU(cfg, backend=backend)
    input_num = 2 * message_len
    out, _ = dec.run(packed, input_num, want_time=False)
    m = cfg.get_message_len(input_num)
    ben = count_bit_errors(out, cfg.bits_per_pack, np.asarray(bits),
                           cfg.extra_l)
    return ben, m


def golden_point(cfg, message_len, snr_db, seed):
    import jax

    from tpu_viterbi.chain import add_awgn, conv_encode, quantize_and_pack
    from tpu_viterbi.chain.channel import snr_to_sigma
    from tpu_viterbi.chain.quantize import unpack_to_soft_np
    from tpu_viterbi.chain.source import random_bits
    from tpu_viterbi.decoder.golden import golden_decode_full

    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    bits = np.asarray(random_bits(k1, message_len))
    coded = conv_encode(jax.numpy.asarray(bits))
    noisy = add_awgn(k2, coded, snr_to_sigma(snr_db))
    packed = np.asarray(quantize_and_pack(noisy, cfg.channel_in,
                                          _default_scale(cfg.channel_in)))
    r = unpack_to_soft_np(packed, cfg.channel_in)[
        : 2 * message_len].reshape(-1, 2).astype(np.int64)
    m = cfg.get_message_len(2 * message_len)
    out_bits = golden_decode_full(r, m)
    ben = int(np.count_nonzero(out_bits != bits[cfg.extra_l:
                                                cfg.extra_l + m]))
    return ben, m


def main(argv=None):
    from tpu_viterbi.config import (ChannelIn, DecodeOut, DecoderConfig,
                                    Metric)

    p = argparse.ArgumentParser()
    p.add_argument("--num", type=int, default=2_000_000)
    # NB: this project's SNR convention is sigma = 10^(-SNR/5)
    # (main.cpp:135): the BER waterfall sits around -1..+2 "dB"
    p.add_argument("--snrs", type=str, default="-1,-0.5,0,0.5,1,1.5,2")
    p.add_argument("--configs", type=str,
                   default="h/b32,s4/b32,s8/b32,s16/b32,f/b32,s4/b16,s8/b16")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--golden", action="store_true",
                   help="include golden numpy decoder (slow; small --num)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "cuda"])
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)

    chan = {"h": ChannelIn.HARD, "s4": ChannelIn.SOFT4, "s8": ChannelIn.SOFT8,
            "s16": ChannelIn.SOFT16, "f": ChannelIn.FP32}
    met = {"b32": Metric.M_B32, "b16": Metric.M_B16, "f16": Metric.M_FP16}

    snrs = [float(s) for s in args.snrs.split(",")]
    rows = []
    for spec in args.configs.split(","):
        c, mname = spec.split("/")
        cfg = DecoderConfig(channel_in=chan[c], metric=met[mname])
        from tpu_viterbi.decoder.api import ViterbiTPU
        dec = ViterbiTPU(cfg, backend=args.backend)   # one compile per config
        for snr in snrs:
            ben, m = run_point(cfg, args.num, snr, args.seed,
                               backend=args.backend, dec=dec)
            row = {"config": spec, "snr_db": snr, "ben": int(ben),
                   "bits": int(m), "ber": ben / m}
            if args.golden:
                gben, gm = golden_point(cfg, min(args.num, 200_000), snr,
                                        args.seed)
                row["golden_ber"] = gben / gm
            rows.append(row)
            print(f"{spec:8s} snr={snr:4.1f}  BEN={ben:9d}  "
                  f"BER={ben/m:.3e}"
                  + (f"  golden={row.get('golden_ber', 0):.3e}"
                     if args.golden else ""), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
            f.write('\n')
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
