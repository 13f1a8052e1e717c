"""Structural scaling audit: prove, without a multi-card machine, that the
sharded programs scale linearly in device count.

The claim is that the sharded decode and the in-graph simulation are
embarrassingly parallel after one tiny halo exchange: the ONLY
cross-device traffic is

  - one `collective-permute` of the 64-stage halo (sharding/blocks.py
    local_decode's ppermute; 16 words at SOFT8),
  - the scalar BEN `all-reduce` (sharding/simulate.py count_errors), and
  - O(1)-sized boundary permutes for the ground-truth word realignment
    (ref_words_from_packs' one-word shift across shard edges).

No all-gathers, no all-to-alls, no reduce-scatters, and no hidden
GSPMD resharding whose size grows with device count.  This module compiles
the real entry points on an n-device mesh and extracts every collective
from the OPTIMIZED (post-SPMD-partitioning) HLO, with its shape — so a CI
test can assert the census is exactly the list above and is invariant in
device count (tests/test_scaling_structure.py runs it at 8 in-process and
at 16/32 via scripts/scaling_audit.py subprocesses).
"""

from __future__ import annotations

import re
from typing import Dict, List

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import ChannelIn, DecoderConfig
from .mesh import BLOCK_AXIS

# Opcode occurrences on an instruction's RHS are `<opcode>(`; operand
# references are bare names and never directly followed by '(' — so this
# matches definitions only.  `-start` variants (async collectives) count as
# the op; `-done` halves are excluded by the required '('.
_COLL_RE = re.compile(
    r"\b(all-gather|all-reduce|collective-permute|reduce-scatter|"
    r"all-to-all|collective-broadcast|ragged-all-to-all)(-start)?\(")


def collective_census(hlo_text: str) -> Dict[str, List[str]]:
    """Optimized-HLO text -> {collective opcode: sorted result shapes}.

    The shape recorded for each collective is the instruction's result
    shape (the cross-device wire contract); async `-start` tuples keep
    their tuple text, which is still device-count-invariant when the
    program is.
    """
    out: Dict[str, List[str]] = {}
    for line in hlo_text.splitlines():
        if " = " not in line:
            continue
        rhs = line.split(" = ", 1)[1]
        m = _COLL_RE.search(rhs)
        if not m:
            continue
        shape = rhs[: m.start()].strip()
        out.setdefault(m.group(1), []).append(shape)
    for k in out:
        out[k].sort()
    return out


def _input_dtype(cfg: DecoderConfig):
    return jnp.float32 if cfg.channel_in == ChannelIn.FP32 else jnp.int32


def audit_decoder(cfg: DecoderConfig, stages_per_device: int, mesh,
                  dec_len: int = 512,
                  backend: str = "auto") -> Dict[str, List[str]]:
    """Collective census of the compiled sharded decoder
    (sharding/blocks.py build_sharded_decoder) on `mesh`."""
    from .blocks import build_sharded_decoder
    fn, _, local_words, _ = build_sharded_decoder(
        cfg, stages_per_device, mesh, dec_len, backend=backend)
    n = mesh.shape[BLOCK_AXIS]
    aval = jax.ShapeDtypeStruct((n * local_words,), _input_dtype(cfg),
                                sharding=NamedSharding(mesh, P(BLOCK_AXIS)))
    compiled = fn.lower(aval).compile()
    return collective_census(compiled.as_text())


def audit_simulation(cfg: DecoderConfig, message_len: int, mesh,
                     dec_len: int = 512,
                     snr_db: float = 5.5) -> Dict[str, List[str]]:
    """Collective census of the compiled in-graph simulation
    (sharding/simulate.py build_sharded_simulation) on `mesh`."""
    from .simulate import build_sharded_simulation
    fn, _ = build_sharded_simulation(cfg, message_len, mesh, snr_db=snr_db,
                                     dec_len=dec_len)
    aval = jax.ShapeDtypeStruct((2,), jnp.uint32,
                                sharding=NamedSharding(mesh, P()))
    compiled = fn.lower(aval).compile()
    return collective_census(compiled.as_text())


def run_audit(n_expected_devices: int = 0, stages_per_device: int = 32768,
              dec_len: int = 512) -> dict:
    """Full audit over all local devices; returns a JSON-able dict."""
    from .mesh import make_block_mesh
    mesh = make_block_mesh()
    n = mesh.shape[BLOCK_AXIS]
    if n_expected_devices and n != n_expected_devices:
        raise RuntimeError(f"expected {n_expected_devices} devices, "
                           f"got {n}")
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    message_len = stages_per_device * n
    return {
        "n_devices": n,
        "stages_per_device": stages_per_device,
        "decoder": audit_decoder(cfg, stages_per_device, mesh, dec_len),
        "sim": audit_simulation(cfg, message_len, mesh, dec_len),
    }
