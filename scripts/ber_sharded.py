"""BER parity across device counts: decodes the same noisy workloads
through the single-device path and through decode_sharded on a mesh, and
records both BER figures.  On the 8-virtual-CPU backend this validates the
sharded halo-exchange path end to end; on several cards the same script
measures the real thing.

Writes bench/ber_sharded.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

T0 = time.time()


def main():
    import jax
    import jax.numpy as jnp

    from tpu_viterbi.chain.encode import conv_encode_np
    from tpu_viterbi.chain.quantize import quantize_and_pack
    from tpu_viterbi.chain.channel import snr_to_sigma
    from tpu_viterbi.config import ChannelIn, DecoderConfig
    from tpu_viterbi.decoder.api import ViterbiTPU
    from tpu_viterbi.sharding.blocks import decode_sharded
    from tpu_viterbi.sharding.mesh import make_block_mesh
    from tpu_viterbi.utils.bits import count_bit_errors

    mesh = make_block_mesh()
    n_dev = mesh.shape["blocks"]
    n = 400_000
    rng = np.random.default_rng(99)
    rows = []
    for ch, scale in [(ChannelIn.SOFT8, 32.0), (ChannelIn.HARD, 1.0)]:
        cfg = DecoderConfig(channel_in=ch)
        dec = ViterbiTPU(cfg, dec_len=2048)
        for snr in (0.0, 0.5, 1.0, 1.5):
            bits = rng.integers(0, 2, n).astype(np.uint8)
            sym = 2 * conv_encode_np(bits).astype(np.float32) - 1
            sym = sym + rng.normal(0, snr_to_sigma(snr),
                                   sym.shape).astype(np.float32)
            packed = np.asarray(quantize_and_pack(jnp.asarray(sym), ch,
                                                  scale))
            out1, _ = dec.run(packed, 2 * n, want_time=False)
            m1 = cfg.get_message_len(2 * n)
            ben1 = count_bit_errors(out1, cfg.bits_per_pack,
                                    bits[cfg.extra_l:], 0)
            outs, ms = decode_sharded(packed, 2 * n, cfg, mesh,
                                      dec_len=2048)
            bens = count_bit_errors(outs, cfg.bits_per_pack,
                                    bits[cfg.extra_l:], 0)
            rows.append({"channel": ch.name, "snr_db": snr,
                         "devices": n_dev, "bits": int(m1),
                         "ber_single": ben1 / m1, "ber_sharded": bens / ms,
                         "sharded_bits": int(ms)})
            print(f"+{time.time()-T0:6.1f}s {ch.name:6s} snr={snr:3.1f} "
                  f"single={ben1/m1:.3e}  sharded({n_dev}dev)={bens/ms:.3e}",
                  flush=True)

    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench", "ber_sharded.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
        f.write('\n')
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
