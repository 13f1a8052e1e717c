"""One process of a multi-process (multi-host-style) decode run.

Exercises the REAL jax.distributed code path (sharding/mesh.py
initialize_distributed + sharding over a global mesh whose devices span
processes) without several hosts: each process owns 4 virtual CPU devices,
the two of them form one 8-device global mesh, and both the in-graph
simulation (sharding/simulate.py) and the host-data decode
(sharding/blocks.py decode_sharded, host->global device_put + cross-process
allgather of the output) run over it.  Each process independently
recomputes the single-process reference on a local 1-device mesh and
asserts bit-identity — the counter-mode generator and overlap-save
framing make the global stream invariant to the mesh shape.

Launched by tests/test_distributed.py as:

  env JAX_PLATFORMS=cpu \\
      XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
  python scripts/distributed_worker.py --coordinator localhost:PORT \\
      --num-processes 2 --process-id {0,1}

Prints one machine-checkable line per check:  DIST_OK <name> ben=N sha=H
"""

import argparse
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("-n", "--num", type=int, default=8 * 2048)
    p.add_argument("--dec-len", type=int, default=256)
    p.add_argument("--snr", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=17)
    p.add_argument("--output", choices=["b32", "b16"], default="b32",
                   help="decode output pack width (b16 exercises the "
                        "uint16 process_allgather path)")
    args = p.parse_args()

    from tpu_viterbi.sharding.mesh import initialize_distributed
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id)

    import numpy as np
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.process_count() == args.num_processes, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == args.num_processes * n_local, (n_global, n_local)

    from tpu_viterbi.config import ChannelIn, DecodeOut, DecoderConfig
    from tpu_viterbi.sharding.blocks import decode_sharded
    from tpu_viterbi.sharding.mesh import make_block_mesh
    from tpu_viterbi.sharding.simulate import build_sharded_simulation

    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8,
                        decode_out=(DecodeOut.O_B16 if args.output == "b16"
                                    else DecodeOut.O_B32))
    mesh = make_block_mesh()                       # global: spans processes
    local_mesh = make_block_mesh(jax.local_devices()[:1])  # reference

    def run_sim(m):
        fn, msg_len = build_sharded_simulation(
            cfg, args.num, m, snr_db=args.snr, dec_len=args.dec_len,
            return_output=True)
        key = jax.device_put(jax.random.PRNGKey(args.seed),
                             NamedSharding(m, P()))
        ben, out = jax.block_until_ready(fn(key))
        if jax.process_count() > 1 and m is mesh:
            out = multihost_utils.process_allgather(out, tiled=True)
        return int(ben), np.asarray(out), msg_len

    # --- in-graph simulation over the global (cross-process) mesh ---
    ben_g, out_g, m = run_sim(mesh)
    ben_l, out_l, m_l = run_sim(local_mesh)
    assert m == m_l
    assert ben_g == ben_l, (ben_g, ben_l)
    np.testing.assert_array_equal(out_g, out_l)
    sha = hashlib.sha256(out_g.tobytes()).hexdigest()[:16]
    print(f"DIST_OK ingraph ben={ben_g} sha={sha}", flush=True)

    # --- host-data decode (device_put across processes + allgather) ---
    from tpu_viterbi.chain import packed_workload
    key = jax.random.PRNGKey(args.seed)
    bits, packed = packed_workload(key, args.num, cfg.channel_in,
                                   args.snr, 32.0)
    packed = np.asarray(packed)
    out_d, m_d = decode_sharded(packed, 2 * args.num, cfg, mesh,
                                dec_len=args.dec_len)
    out_1, m_1 = decode_sharded(packed, 2 * args.num, cfg, local_mesh,
                                dec_len=args.dec_len)
    assert m_d == m_1
    np.testing.assert_array_equal(out_d, out_1)
    sha_d = hashlib.sha256(out_d.tobytes()).hexdigest()[:16]
    print(f"DIST_OK hostdata ben={ben_g} sha={sha_d}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
