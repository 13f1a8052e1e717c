"""Structural scaling audit: compile the sharded decoder and the in-graph
simulation at 8 / 16 / 32 virtual devices and assert the optimized HLO's
collective set is EXACTLY the designed one — one halo `collective-permute`
(+ O(1)-sized boundary permutes + the scalar BEN `all-reduce`), with
shapes invariant in device count.  This is the hardware-free proof that
per-card work and cross-card traffic do not grow with the mesh, i.e. that
decode throughput is linear in cards (the reference has no multi-device
story).

8 devices run in-process (conftest mesh); 16 and 32 need their own
XLA_FLAGS so they run scripts/scaling_audit.py subprocesses.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "scaling_audit.py")

SD = 32768          # stages/device
DEC_LEN = 512

# The designed cross-device contract (shapes from the optimized HLO):
#   decoder: 1 halo permute of 2*WARMUP/dpp = 32 SOFT8 words
#   sim:     halo permute + 1-word ref-stream boundary permute + BEN psum
#            + the encoder shifted-view edge realignment (<= K-1+1 tiny u8
#            permutes, each <= 7 bytes)
DECODER_WANT = {"collective-permute": ["s32[32]{0}"]}
FORBIDDEN = ("all-gather", "all-to-all", "reduce-scatter",
             "collective-broadcast", "ragged-all-to-all")


def _check(audit):
    assert audit["decoder"] == DECODER_WANT, audit["decoder"]
    sx = audit["sim"]
    assert sx["all-reduce"] == ["s32[]"], sx
    perms = sx["collective-permute"]
    assert "s32[32]{0}" in perms and "u32[1]{0}" in perms, perms
    extra = [s for s in perms if s not in ("s32[32]{0}", "u32[1]{0}")]
    # encoder edge realignment: tiny O(1)-sized u8 permutes only (exact
    # byte counts are a GSPMD partitioning detail and wobble a few bytes
    # with device count; what matters is they are bounded constants, not
    # functions of the message size)
    assert all(s.startswith("u8[") for s in extra), extra
    assert all(int(s[3:].split("]")[0]) <= 64 for s in extra), extra
    assert len(extra) <= 20, extra
    for census in (audit["decoder"], sx):
        for op in FORBIDDEN:
            assert op not in census, (op, census)


def test_collective_census_8_devices():
    from tpu_viterbi.sharding.audit import run_audit
    audit = run_audit(8, SD, DEC_LEN)
    _check(audit)


@pytest.mark.parametrize("channel,decode_out,halo", [
    ("FP32", "O_B32", "f32[128]{0}"),     # dpp=1 float wire
    ("SOFT16", "O_B32", "s32[64]{0}"),    # dpp=2
    ("SOFT8", "O_B16", "s32[32]{0}"),
    ("HARD", "O_B32", "s32[4]{0}"),       # dpp=32
], ids=lambda v: str(v).split("{")[0])
def test_decoder_census_other_wire_formats(channel, decode_out, halo):
    """The one-halo-permute contract holds for every wire format and both
    output widths — not just the headline SOFT8/b32 config run_audit
    covers.  The permute's shape is the format's 64-stage halo
    (2*WARMUP/dpp words), the whole cross-device wire contract of a
    sharded decode."""
    from tpu_viterbi.config import ChannelIn, DecodeOut, DecoderConfig
    from tpu_viterbi.sharding.audit import audit_decoder
    from tpu_viterbi.sharding.mesh import make_block_mesh
    cfg = DecoderConfig(channel_in=ChannelIn[channel],
                        decode_out=DecodeOut[decode_out])
    census = audit_decoder(cfg, SD, make_block_mesh(), DEC_LEN)
    assert census == {"collective-permute": [halo]}, census


@pytest.fixture(scope="module")
def census_by_devices():
    """Subprocess audits at 16 and 32 virtual devices (each needs its own
    XLA_FLAGS device count, so each gets its own interpreter)."""
    out = {}
    for n in (16, 32):
        env = dict(os.environ)
        # the child stays on the CPU even on a GPU machine, so it never
        # opens a card another process holds
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": f"--xla_force_host_platform_device_count={n}",
        })
        r = subprocess.run(
            [sys.executable, SCRIPT, "--devices", str(n),
             "--stages-per-device", str(SD), "--dec-len", str(DEC_LEN)],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=840)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        out[n] = json.loads(r.stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("n", [16, 32])
def test_collective_census_device_count_invariant(census_by_devices, n):
    """Same census — op set AND shapes — at 16/32 devices as at 8: the
    per-shard program is device-count-invariant, so aggregate throughput
    at fixed stages/device is linear in chips by construction."""
    audit = census_by_devices[n]
    assert audit["n_devices"] == n
    _check(audit)
