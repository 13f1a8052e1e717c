"""Collective-census audit at an arbitrary virtual device count.

Compiles the sharded decoder and the in-graph simulation over an N-device
CPU mesh and prints one JSON line with every collective in the optimized
(post-SPMD) HLO and its shape (tpu_viterbi/sharding/audit.py).  The
scaling claim this verifies: the census is EXACTLY one halo
collective-permute (+ O(1) boundary permutes + the scalar BEN all-reduce)
and is invariant in N — no all-gathers, no resharding that grows with the
mesh.

Run (the env must be set BEFORE python starts; tests/test_scaling_structure.py
spawns this for N=16, 32):

  env JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=N \
  python scripts/scaling_audit.py --devices N
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=0,
                   help="expected device count (sanity check)")
    p.add_argument("--stages-per-device", type=int, default=32768)
    p.add_argument("--dec-len", type=int, default=512)
    args = p.parse_args()

    from tpu_viterbi.sharding.audit import run_audit
    print(json.dumps(run_audit(args.devices, args.stages_per_device,
                               args.dec_len)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
