"""Real multi-process jax.distributed test: two
localhost processes (coordinator + worker, CPU backend, 4 virtual devices
each) bring up an 8-device GLOBAL mesh via
sharding.mesh.initialize_distributed and run both the in-graph sharded
simulation and the host-data decode_sharded over it, asserting
bit-identity with the single-process result inside each worker
(scripts/distributed_worker.py).  This exercises the actual cross-process code path
— cross-process device_put, shard_map collectives over a multi-process
mesh, and the output allgather — that the virtual single-process mesh
tests cannot reach.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "distributed_worker.py")


def _run_processes(num_processes: int, devices_per_process: int,
                   extra_args=()):
    port = _free_port()
    env = dict(os.environ)
    env.update({
        # children stay on the CPU even on a GPU machine, so none of them
        # opens a card that another process holds
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": ("--xla_force_host_platform_device_count="
                      f"{devices_per_process}"),
    })
    procs = []
    for pid in range(num_processes):
        procs.append(subprocess.Popen(
            [sys.executable, WORKER,
             "--coordinator", f"localhost:{port}",
             "--num-processes", str(num_processes),
             "--process-id", str(pid), *extra_args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=840)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
        assert "DIST_OK ingraph" in out, f"process {pid}:\n{out[-4000:]}"
        assert "DIST_OK hostdata" in out, f"process {pid}:\n{out[-4000:]}"

    # all processes must have produced the same decode (ben= / sha= lines)
    def marks(out):
        return sorted(ln for ln in out.splitlines()
                      if ln.startswith("DIST_OK"))
    for out in outs[1:]:
        assert marks(out) == marks(outs[0])


def test_two_process_distributed_decode():
    _run_processes(2, 4)


@pytest.mark.slow   # second multi-process spawn; the 2-process test
                    # stays fast as the cross-process representative
def test_four_process_distributed_decode_b16():
    """4 processes x 2 devices (the >2-process path) with O_B16 output — covering process_allgather of the uint16
    pack stream, which the 2-process b32 case never touched."""
    _run_processes(4, 2, ("--output", "b16"))
