"""Multi-device sharded decode tests on the virtual 8-device CPU mesh:
halo exchange correctness (device-boundary bits must match a single-device
decode bit-for-bit) and mesh plumbing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_viterbi.chain.encode import conv_encode_np
from tpu_viterbi.chain.quantize import quantize_and_pack
from tpu_viterbi.config import ChannelIn, DecoderConfig
from tpu_viterbi.decoder.api import ViterbiTPU
from tpu_viterbi.sharding.blocks import decode_sharded
from tpu_viterbi.sharding.mesh import make_block_mesh
from tpu_viterbi.utils.bits import unpack_msb_first

EXTRA_L = 26

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _workload(n, sigma, seed=11, channel=ChannelIn.SOFT8, scale=32.0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    coded = conv_encode_np(bits).astype(np.float32)
    sym = 2 * coded - 1
    if sigma:
        sym = sym + rng.normal(0, sigma, sym.shape).astype(np.float32)
    packed = np.asarray(quantize_and_pack(jnp.asarray(sym), channel, scale))
    return bits, packed


def test_sharded_noiseless_exact():
    n = 8 * 2048
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    bits, packed = _workload(n, 0.0)
    mesh = make_block_mesh(jax.devices()[:8])
    out, m = decode_sharded(packed, 2 * n, cfg, mesh, dec_len=512)
    got = unpack_msb_first(out, 32)[:m]
    assert np.array_equal(got, bits[EXTRA_L: EXTRA_L + m])


def test_sharded_matches_single_device_noisy():
    """Sharded output must be bit-identical to the single-device decoder on
    the same packed input — including across every device boundary (halo
    exchange correctness)."""
    n = 8 * 1024
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    bits, packed = _workload(n, 0.6)
    mesh = make_block_mesh(jax.devices()[:8])
    out_sharded, m = decode_sharded(packed, 2 * n, cfg, mesh, dec_len=256)

    # single-device decode with the same per-device block partition:
    # device span = 1024 stages, dec_len 256 -> identical framing
    dec = ViterbiTPU(cfg, dec_len=256, backend="xla")
    out_single, _ = dec.run(packed, 2 * n)
    m1 = cfg.get_message_len(2 * n)
    assert m == m1
    a = unpack_msb_first(out_sharded, 32)[:m]
    b = unpack_msb_first(out_single, 32)[:m]
    # the streams may differ only where the *block* framings differ; with
    # dec_len dividing the device span both partitions coincide on all
    # interior block starts except near the global tail (the single-device
    # partition left-shifts its last block).  Compare the exactly-aligned
    # prefix.
    aligned = (m // 1024) * 1024 - 1024
    assert np.array_equal(a[:aligned], b[:aligned])
    # and the full sharded stream must still decode the message correctly
    err = np.count_nonzero(a != bits[EXTRA_L: EXTRA_L + m])
    assert err <= np.count_nonzero(b != bits[EXTRA_L: EXTRA_L + m]) + 8


def test_sharded_hard_channel():
    n = 8 * 1024
    cfg = DecoderConfig(channel_in=ChannelIn.HARD)
    bits, packed = _workload(n, 0.0, channel=ChannelIn.HARD)
    mesh = make_block_mesh(jax.devices()[:8])
    out, m = decode_sharded(packed, 2 * n, cfg, mesh, dec_len=256)
    got = unpack_msb_first(out, 32)[:m]
    assert np.array_equal(got, bits[EXTRA_L: EXTRA_L + m])


def test_sharded_auto_dec_len():
    """dec_len='auto' resolves per shard (core_xla.auto_dec_len) through
    decode_sharded and the in-graph simulation."""
    import math
    from tpu_viterbi.sharding.simulate import simulate_sharded

    n = 8 * 2048
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    bits, packed = _workload(n, 0.0)
    mesh = make_block_mesh(jax.devices()[:8])
    out, m = decode_sharded(packed, 2 * n, cfg, mesh, dec_len="auto")
    got = unpack_msb_first(out, 32)[:m]
    assert np.array_equal(got, bits[EXTRA_L: EXTRA_L + m])
    ben, _ = simulate_sharded(cfg, n, mesh, snr_db=math.inf, seed=4,
                              dec_len="auto")
    assert ben == 0


def test_mesh_axis_name():
    mesh = make_block_mesh(jax.devices()[:4])
    assert mesh.shape == {"blocks": 4}


# --- fully in-graph sharded simulation (sharding/simulate.py) ---

def test_ingraph_generation_identical_across_shardings():
    """Partitionable threefry: the sharded in-graph bit stream must equal
    the single-device stream value-for-value (each device computes its
    slice of the same counter-mode stream)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpu_viterbi.chain.source import random_bits

    n = 8 * 4096
    key = jax.random.PRNGKey(3)
    single = np.asarray(jax.jit(lambda k: random_bits(k, n))(key))

    mesh = make_block_mesh(jax.devices()[:8])
    spec = NamedSharding(mesh, P("blocks"))

    @jax.jit
    def gen(k):
        return jax.lax.with_sharding_constraint(random_bits(k, n), spec)

    sharded = np.asarray(gen(key))
    assert np.array_equal(single, sharded)


def test_ingraph_simulation_noiseless_exact():
    import math
    from tpu_viterbi.sharding.simulate import simulate_sharded

    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    mesh = make_block_mesh(jax.devices()[:8])
    ben, m = simulate_sharded(cfg, 8 * 2048, mesh, snr_db=math.inf,
                              seed=5, dec_len=512)
    assert m == cfg.get_message_len(2 * 8 * 2048)
    assert ben == 0


def test_ingraph_simulation_matches_host_path():
    """The in-graph chain (generate+decode+count on the mesh) must produce
    exactly the BEN of the host-path replication: same key through the same
    chain ops on a single device, packed input fed to the same sharded
    decoder, errors counted on host."""
    from tpu_viterbi.chain import packed_workload
    from tpu_viterbi.sharding.simulate import build_sharded_simulation
    from tpu_viterbi.utils.bits import count_bit_errors

    n = 8 * 1024
    snr = -1.0  # low enough that errors exist (waterfall sits at -1..+2)
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    mesh = make_block_mesh(jax.devices()[:8])
    key = jax.random.PRNGKey(17)

    fn, m = build_sharded_simulation(cfg, n, mesh, snr_db=snr, dec_len=256)
    ben_graph = int(fn(key))
    assert ben_graph > 0

    bits, packed = packed_workload(key, n, ChannelIn.SOFT8, snr, 32.0)
    bits, packed = np.asarray(bits), np.asarray(packed)
    out, m2 = decode_sharded(packed, 2 * n, cfg, mesh, dec_len=256)
    assert m2 == m
    ben_host = count_bit_errors(out, cfg.bits_per_pack, bits[EXTRA_L:],
                                offset=0)
    assert ben_graph == ben_host


def test_ingraph_simulation_b16_output():
    import math
    from tpu_viterbi.config import DecodeOut
    from tpu_viterbi.sharding.simulate import simulate_sharded

    cfg = DecoderConfig(channel_in=ChannelIn.HARD, decode_out=DecodeOut.O_B16)
    mesh = make_block_mesh(jax.devices()[:8])
    ben, _ = simulate_sharded(cfg, 8 * 1024, mesh, snr_db=math.inf,
                              seed=9, dec_len=256)
    assert ben == 0


def test_ingraph_simulation_fp32_channel():
    """FP32 channel takes the unpacked float staging path (dpp=1)."""
    import math
    from tpu_viterbi.sharding.simulate import simulate_sharded

    cfg = DecoderConfig(channel_in=ChannelIn.FP32)
    mesh = make_block_mesh(jax.devices()[:8])
    ben, _ = simulate_sharded(cfg, 8 * 1024, mesh, snr_db=math.inf,
                              seed=2, dec_len=256)
    assert ben == 0


@pytest.mark.parametrize("channel,decode_out", [
    (ChannelIn.SOFT8, "O_B32"), (ChannelIn.FP32, "O_B32"),
    (ChannelIn.HARD, "O_B16")])
def test_sharded_matches_shard_reference(channel, decode_out):
    """decode_sharded equals shard_reference — each shard plus its
    neighbour's halo decoded alone on one device — bit for bit, on noisy
    input, wraparound tail included: the comparison chip_smoke.py makes on
    four cards."""
    from tpu_viterbi.config import DecodeOut
    from tpu_viterbi.sharding.blocks import shard_reference

    n = 8 * 1024
    cfg = DecoderConfig(channel_in=channel, decode_out=DecodeOut[decode_out])
    scale = {ChannelIn.SOFT8: 32.0, ChannelIn.FP32: 4.0,
             ChannelIn.HARD: 1.0}[channel]
    _, packed = _workload(n, 0.8, seed=5, channel=channel, scale=scale)
    mesh = make_block_mesh(jax.devices()[:8])
    out, m = decode_sharded(packed, 2 * n, cfg, mesh, dec_len=256)
    ref = shard_reference(packed, cfg, 8, 256)
    assert out.dtype == ref.dtype
    assert np.array_equal(out, ref[:out.shape[0]])
