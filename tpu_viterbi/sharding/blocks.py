"""Multi-chip block-parallel decode: overlap-save over a device mesh.

The decomposition is the reference's time-block scheme (SURVEY.md §5
"long-context") lifted one level: the coded stage stream is sharded along
the 'blocks' mesh axis; each device decodes exactly the output bits whose
stages live in its shard, and fetches the extra_l+extra_r = 64-stage right
halo from its neighbor with a single `ppermute` edge exchange (replacing
nothing in the reference — it has no multi-device story).

Within a device the usual block batch runs (the decode core api.py
resolves); across devices no further communication is needed (overlap-save
blocks are independent), so scaling is embarrassingly parallel after one
tiny halo exchange.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import ChannelIn, DecoderConfig
from ..decoder.api import DEFAULT_DEC_LEN, decode_core, resolve_backend
from ..decoder.core_xla import WARMUP, decode_packed_xla, plan_blocks
from .mesh import BLOCK_AXIS


def sharded_stage_count(total_stages: int, num_devices: int,
                        bits_per_pack: int) -> int:
    """Stages per device: total padded up so each shard is a whole number of
    packs and of packed input words for every channel type (lcm 32)."""
    per = -(-total_stages // num_devices)
    return -(-per // 32) * 32


def build_sharded_decoder(cfg: DecoderConfig, stages_per_device: int,
                          mesh, dec_len: int = DEFAULT_DEC_LEN,
                          backend: str = "auto"):
    """Returns (jitted decode, plan, local_words, info) for a
    globally-sharded packed input.

    Input:  packed words for num_devices * stages_per_device coded stages,
            sharded along the 'blocks' axis.
    Output: packed decoded words, sharded the same way; each device emits
            stages_per_device output bits.  The globally valid prefix is
            get_message_len(2 * total_stages) bits; the tail past it (which
            consumed the wraparound halo of device 0) must be discarded by
            the caller.

    backend: 'auto' | 'xla' | 'cuda' — same knob as ViterbiTPU
    (api.resolve_backend); info = {'backend': the resolved core}.
    """
    num_devices = mesh.shape[BLOCK_AXIS]
    sd = stages_per_device
    if sd % 32:
        raise ValueError("stages_per_device must be a multiple of 32")
    local_words = sd * 2 // cfg.enc_data_per_pack
    if dec_len == "auto":    # per-shard block-count fill (auto_dec_len)
        from ..decoder.core_xla import auto_dec_len
        dec_len = auto_dec_len(sd, cfg.bits_per_pack)
    plan = plan_blocks(sd, cfg.bits_per_pack, dec_len)
    perm = [((d + 1) % num_devices, d) for d in range(num_devices)]
    core = resolve_backend(backend)
    decode = decode_core(core)

    # halo exchanged at packed-word granularity (the wire format): the
    # first 64 coded stages of the right neighbor, one tiny ppermute edge
    dpp = 1 if cfg.channel_in == ChannelIn.FP32 else cfg.enc_data_per_pack
    halo_words = 2 * WARMUP // dpp

    def local_decode(words_local):
        halo = jax.lax.ppermute(words_local[:halo_words], BLOCK_AXIS, perm)
        return decode(jnp.concatenate([words_local, halo]), cfg, plan)

    # check_vma=False: the decoder's zero-initialized scan carries are
    # unvarying over the mesh axis by construction; axis-varying inference
    # would otherwise require threading pvary through the shared core.
    fn = shard_map(local_decode, mesh=mesh,
                   in_specs=P(BLOCK_AXIS), out_specs=P(BLOCK_AXIS),
                   check_vma=False)
    return jax.jit(fn), plan, local_words, {"backend": core}


def decode_sharded(packed_global, input_num: int, cfg: DecoderConfig,
                   mesh, dec_len: int = DEFAULT_DEC_LEN,
                   backend: str = "auto") -> Tuple[np.ndarray, int]:
    """Convenience end-to-end sharded decode.

    packed_global: full packed channel input (host array).  Returns
    (packed_output_words, message_len)."""
    num_devices = mesh.shape[BLOCK_AXIS]
    total_stages = input_num // 2
    sd = sharded_stage_count(total_stages, num_devices, cfg.bits_per_pack)
    padded_stages = sd * num_devices
    words_needed = padded_stages * 2 // cfg.enc_data_per_pack

    arr = np.asarray(packed_global)
    if cfg.channel_in == ChannelIn.FP32:
        arr = arr.astype(np.float32)
    else:
        arr = arr.astype(np.int32)
    if len(arr) < words_needed:
        arr = np.pad(arr, (0, words_needed - len(arr)))
    else:
        arr = arr[:words_needed]

    fn, _, _, _ = build_sharded_decoder(cfg, sd, mesh, dec_len,
                                        backend=backend)
    # device_put of the host array onto the (possibly multi-process) mesh:
    # each process materializes only its addressable shards
    x = jax.device_put(arr, NamedSharding(mesh, P(BLOCK_AXIS)))
    out = jax.block_until_ready(fn(x))
    if jax.process_count() > 1:
        # the output spans non-addressable devices; gather so every
        # process returns the full decoded stream (SURVEY §2.3 P7)
        from jax.experimental import multihost_utils
        out = multihost_utils.process_allgather(out, tiled=True)
    out = np.asarray(out)

    message_len = cfg.get_message_len(input_num)
    return out[: message_len // cfg.bits_per_pack], message_len


def shard_reference(packed_global, cfg: DecoderConfig, num_devices: int,
                    dec_len: int) -> np.ndarray:
    """What decode_sharded must return, computed shard by shard on one
    device with the XLA core: each shard's words plus the first halo
    words of the next shard (wrapping around, as the ppermute does),
    decoded under the shard's own plan.  Returns all num_devices * sd
    output bits' words; decode_sharded keeps the first message_len."""
    words = np.asarray(packed_global)
    dpp = cfg.enc_data_per_pack
    total_stages = words.shape[0] * dpp // 2
    sd = sharded_stage_count(total_stages, num_devices, cfg.bits_per_pack)
    local = sd * 2 // dpp
    words = np.pad(words, (0, max(0, local * num_devices - words.shape[0])))
    halo = 2 * WARMUP // dpp
    plan = plan_blocks(sd, cfg.bits_per_pack, dec_len)
    outs = []
    for d in range(num_devices):
        nxt = ((d + 1) % num_devices) * local
        x = np.concatenate([words[d * local:(d + 1) * local],
                            words[nxt:nxt + halo]])
        outs.append(np.asarray(decode_packed_xla(jnp.asarray(x), cfg, plan)))
    return np.concatenate(outs)
