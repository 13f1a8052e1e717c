"""BER parity on a MULTI-PROCESS mesh: launches N coordinator+worker processes (CPU
backend, a few virtual devices each), forms one global mesh spanning them,
and runs the same noisy workloads through decode_sharded over the real
jax.distributed code path.  Every process independently computes the
single-device reference BER and asserts the sharded BER matches; process 0
appends the rows to bench/ber_sharded.json with a "processes" field.

Run (self-launching):  env JAX_PLATFORMS=cpu \
    python scripts/ber_sharded_mp.py [--processes 4]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

T0 = time.time()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(num_processes: int, devices_per_process: int) -> int:
    port = _free_port()
    env = dict(os.environ)
    env.update({
        # children stay on the CPU even on a GPU machine, so none of them
        # opens a card that another process holds
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": ("--xla_force_host_platform_device_count="
                      f"{devices_per_process}"),
    })
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         "--coordinator", f"localhost:{port}",
         "--processes", str(num_processes), "--process-id", str(pid)],
        env=env, cwd=REPO) for pid in range(num_processes)]
    rc = 0
    for p in procs:
        rc |= p.wait(timeout=1200)
    return rc


def worker(args) -> int:
    from tpu_viterbi.sharding.mesh import initialize_distributed
    initialize_distributed(args.coordinator, args.processes,
                           args.process_id)

    import numpy as np
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

    assert jax.process_count() == args.processes
    mesh = make_block_mesh()                  # global, spans processes
    n_dev = mesh.shape["blocks"]
    n = 200_000
    rng = np.random.default_rng(99)          # same stream in every process
    rows = []
    for ch, scale in [(ChannelIn.SOFT8, 32.0), (ChannelIn.HARD, 1.0)]:
        cfg = DecoderConfig(channel_in=ch)
        dec = ViterbiTPU(cfg, dec_len=2048, backend="xla")
        for snr in (0.5, 1.0):
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
            # the sharded run pads/reframes blocks at shard edges, so
            # individual boundary decisions may differ under noise
            # (overlap-save truncation); the BER must agree within
            # simulation noise (2% relative)
            assert abs(bens / ms - ben1 / m1) < \
                0.02 * max(ben1 / m1, 1e-3), (bens, ben1)
            rows.append({"channel": ch.name, "snr_db": snr,
                         "devices": n_dev, "processes": args.processes,
                         "bits": int(m1), "ber_single": ben1 / m1,
                         "ber_sharded": bens / ms,
                         "sharded_bits": int(ms)})
            if args.process_id == 0:
                print(f"+{time.time()-T0:6.1f}s {ch.name:6s} snr={snr:3.1f}"
                      f" single={ben1/m1:.3e}  sharded({n_dev}dev/"
                      f"{args.processes}proc)={bens/ms:.3e}", flush=True)

    if args.process_id == 0:
        path = os.path.join(REPO, "bench", "ber_sharded.json")
        try:
            with open(path) as f:
                existing = json.load(f)
        except (OSError, ValueError):
            existing = []
        existing = [r for r in existing
                    if r.get("processes") != args.processes]
        existing.extend(rows)
        with open(path, "w") as f:
            json.dump(existing, f, indent=1)
            f.write("\n")
        print(f"wrote {path}")
    return 0


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--processes", type=int, default=4)
    p.add_argument("--devices-per-process", type=int, default=2)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args()
    if args.coordinator is None:
        return launch(args.processes, args.devices_per_process)
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
