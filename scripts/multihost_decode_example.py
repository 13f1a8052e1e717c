"""Multi-host / multi-card decode example (SURVEY.md §2.3 P7).

Runs the full chain — per-process deterministic workload build, block-
sharded decode over the 'blocks' mesh axis (64-stage halo via one
ppermute), BER check — on whatever devices the process sees:

  # single host, all local cards:
  python scripts/multihost_decode_example.py -n 8000000 -s 5.5

  # validate the same code path without hardware (8 virtual CPU devices):
  env JAX_PLATFORMS=cpu \\
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python scripts/multihost_decode_example.py -n 400000

  # several hosts (one process per host):
  python scripts/multihost_decode_example.py -n 512000000 \\
      --coordinator host0:1234 --num-processes N --process-id $i

By default the whole chain (generation -> decode -> BER count) runs
in-graph on the mesh (sharding/simulate.py): each device generates its
slice of the shared-seed random stream (partitionable threefry), so no
workload bytes ever cross between host and device or between hosts —
only the scalar BEN comes back.  --host-data switches to the legacy path where every process
builds the global workload on its host and ships it in (useful for
decoding externally supplied data).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-n", "--num", type=int, default=8_000_000)
    p.add_argument("-s", "--snr", type=float, default=5.5)
    p.add_argument("-i", "--input", default="s8",
                   choices=["h", "s4", "s8", "s16"])
    p.add_argument("--dec-len", type=int, default=2048)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--host-data", action="store_true",
                   help="build the workload on the host and ship it in "
                        "(default: fully in-graph on the mesh)")
    args = p.parse_args()

    from tpu_viterbi.sharding.mesh import initialize_distributed
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_viterbi.chain import add_awgn, conv_encode, quantize_and_pack
    from tpu_viterbi.chain.channel import snr_to_sigma
    from tpu_viterbi.chain.source import random_bits
    from tpu_viterbi.config import ChannelIn, DecoderConfig
    from tpu_viterbi.sharding.blocks import decode_sharded
    from tpu_viterbi.sharding.mesh import make_block_mesh
    from tpu_viterbi.utils.bits import count_bit_errors

    chan = {"h": ChannelIn.HARD, "s4": ChannelIn.SOFT4,
            "s8": ChannelIn.SOFT8, "s16": ChannelIn.SOFT16}[args.input]
    scale = {"h": 1.0, "s4": 4.0, "s8": 32.0, "s16": 8192.0}[args.input]
    cfg = DecoderConfig(channel_in=chan)
    mesh = make_block_mesh()
    n_dev = mesh.shape["blocks"]
    if jax.process_index() == 0:
        print(f"mesh: {n_dev} devices x {jax.process_count()} processes, "
              f"channel={chan.name}", flush=True)

    key = jax.random.PRNGKey(args.seed)
    if args.host_data:
        k1, k2 = jax.random.split(key)
        bits = random_bits(k1, args.num)
        coded = conv_encode(bits)
        noisy = add_awgn(k2, coded, snr_to_sigma(args.snr))
        packed = np.asarray(quantize_and_pack(noisy, chan, scale))
        bits = np.asarray(bits)

        t0 = time.time()
        out, m = decode_sharded(packed, 2 * args.num, cfg, mesh,
                                dec_len=args.dec_len)
        dt = time.time() - t0

        ben = count_bit_errors(out, cfg.bits_per_pack, bits[cfg.extra_l:],
                               offset=0)
    else:
        from tpu_viterbi.sharding.simulate import build_sharded_simulation
        fn, m = build_sharded_simulation(cfg, args.num, mesh,
                                         snr_db=args.snr, scale=scale,
                                         dec_len=args.dec_len)
        t0 = time.time()
        ben = int(jax.block_until_ready(fn(key)))
        dt = time.time() - t0
    if jax.process_index() == 0:
        print(f"decoded {m} bits on {n_dev} devices in {dt*1e3:.1f} ms "
              f"(first call includes compile)")
        print(f"BEN: {ben}   BER: {ben / m:.3e}")
    return 0 if ben == 0 or args.snr < 3 else 1


if __name__ == "__main__":
    sys.exit(main())
