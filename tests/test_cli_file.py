"""CLI file mode: --emit-file writes the packed channel stream in the
getInputSize layout (viterbi.cu:64-84) and --decode-file serves a real
decode of it (inputNum from file size, viterbiDF.h:190)."""

import numpy as np
import pytest

from tpu_viterbi import cli
from tpu_viterbi.chain import RandBitGen
from tpu_viterbi.config import ChannelIn, DecoderConfig
from tpu_viterbi.utils.bits import count_bit_errors

N = 20_000
SEED = 7


def _source_bits():
    return np.asarray(RandBitGen(N, seed=SEED).process(None))


@pytest.mark.parametrize("chan,flag,out_dtype", [
    (ChannelIn.SOFT8, "s8", np.uint32),
    (ChannelIn.FP32, "f", np.uint32),      # float32 file dtype path
])
def test_emit_then_decode_roundtrip(tmp_path, chan, flag, out_dtype):
    emit = str(tmp_path / "packed.bin")
    out = str(tmp_path / "dec.bin")
    assert cli.main(["-n", str(N), "-s", "6", "-i", flag,
                     "--seed", str(SEED), "--emit-file", emit]) == 0
    assert cli.main(["-i", flag, "--decode-file", emit,
                     "--out-file", out]) == 0
    cfg = DecoderConfig(channel_in=chan)
    # the emitted file must be the raw packer words (float32 for FP32)
    in_dtype = np.float32 if chan == ChannelIn.FP32 else np.int32
    words = np.fromfile(emit, dtype=in_dtype)
    assert words.shape[0] == cfg.get_input_words(2 * N)
    dec = np.fromfile(out, dtype=out_dtype)
    ben = count_bit_errors(dec, cfg.bits_per_pack, _source_bits(),
                           cfg.extra_l)
    assert ben == 0


def test_decode_file_b16_output(tmp_path):
    emit = str(tmp_path / "packed.bin")
    out = str(tmp_path / "dec.bin")
    assert cli.main(["-n", str(N), "-s", "15", "-i", "s4", "-m", "b16",
                     "-o", "b16", "--seed", str(SEED),
                     "--emit-file", emit]) == 0
    assert cli.main(["-i", "s4", "-m", "b16", "-o", "b16",
                     "--decode-file", emit, "--out-file", out]) == 0
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT4,
                        metric=cli._METRIC_NAMES["b16"],
                        decode_out=cli._OUTPUT_NAMES["b16"])
    dec = np.fromfile(out, dtype=np.uint16)
    assert dec.nbytes == cfg.get_output_size(2 * N)
    ben = count_bit_errors(dec, cfg.bits_per_pack, _source_bits(),
                           cfg.extra_l)
    assert ben == 0


def test_decode_file_default_out_path(tmp_path):
    emit = str(tmp_path / "packed.bin")
    assert cli.main(["-n", str(N), "-s", "15", "-i", "h",
                     "--seed", str(SEED), "--emit-file", emit]) == 0
    assert cli.main(["-i", "h", "--decode-file", emit]) == 0
    cfg = DecoderConfig(channel_in=ChannelIn.HARD)
    dec = np.fromfile(emit + ".dec", dtype=np.uint32)
    ben = count_bit_errors(dec, cfg.bits_per_pack, _source_bits(),
                           cfg.extra_l)
    assert ben == 0


def test_decode_multiple_files_one_decoder(tmp_path):
    """Several equal-sized files queue back to back through run_stream;
    each writes its own <file>.dec."""
    paths = []
    for i, snr in enumerate(("15", "6")):
        p = str(tmp_path / f"m{i}.bin")
        assert cli.main(["-n", str(N), "-s", snr, "-i", "s8",
                         "--seed", str(SEED), "--emit-file", p]) == 0
        paths.append(p)
    assert cli.main(["-i", "s8", "--decode-file", *paths]) == 0
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    bits = _source_bits()
    for p in paths:
        dec = np.fromfile(p + ".dec", dtype=np.uint32)
        assert count_bit_errors(dec, cfg.bits_per_pack, bits,
                                cfg.extra_l) == 0
    # --out-file is ambiguous with several inputs
    assert cli.main(["-i", "s8", "--decode-file", *paths,
                     "--out-file", str(tmp_path / "o.bin")]) == -1


def test_decode_mixed_size_files(tmp_path):
    """Files of different sizes fall back to the per-file loop (the
    executable cache still compiles each size once)."""
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    paths, lens = [], (N, N // 2)
    for i, n in enumerate(lens):
        p = str(tmp_path / f"m{i}.bin")
        assert cli.main(["-n", str(n), "-s", "15", "-i", "s8",
                         "--seed", str(SEED), "--emit-file", p]) == 0
        paths.append(p)
    assert cli.main(["-i", "s8", "--decode-file", *paths]) == 0
    for p, n in zip(paths, lens):
        dec = np.fromfile(p + ".dec", dtype=np.uint32)
        bits = np.asarray(RandBitGen(n, seed=SEED).process(None))
        assert count_bit_errors(dec, cfg.bits_per_pack, bits,
                                cfg.extra_l) == 0


def test_stream_words_matches_one_shot(tmp_path):
    """--stream-words chunked decode is byte-identical to the one-shot
    file decode (the streaming push/flush framing contract)."""
    emit = str(tmp_path / "packed.bin")
    assert cli.main(["-n", str(N), "-s", "6", "-i", "s8",
                     "--seed", str(SEED), "--emit-file", emit]) == 0
    one = str(tmp_path / "one.bin")
    chunked = str(tmp_path / "chunked.bin")
    assert cli.main(["-i", "s8", "--decode-file", emit,
                     "--out-file", one]) == 0
    assert cli.main(["-i", "s8", "--decode-file", emit, "--out-file",
                     chunked, "--stream-words", "2048"]) == 0
    a = np.fromfile(one, dtype=np.uint32)
    b = np.fromfile(chunked, dtype=np.uint32)
    assert a.shape == b.shape and np.array_equal(a, b)
    # and correct vs ground truth
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    assert count_bit_errors(b, cfg.bits_per_pack, _source_bits(),
                            cfg.extra_l) == 0


def test_stream_words_flag_validation(tmp_path):
    f = str(tmp_path / "x.bin")
    np.zeros(4096, np.int32).tofile(f)
    assert cli.main(["--decode-file", f, "--stream-words", "1000"]) == -1
    assert cli.main(["-n", "20000", "--stream-words", "2048"]) == -1


def test_decode_file_flag_conflicts(tmp_path):
    f = str(tmp_path / "x.bin")
    np.zeros(4096, np.int32).tofile(f)
    # simulation knobs are rejected in file mode, not silently ignored
    assert cli.main(["--decode-file", f, "-n", "1000"]) == -1
    assert cli.main(["--decode-file", f, "-s", "6"]) == -1
    assert cli.main(["--decode-file", f, "--seed", "1"]) == -1
    assert cli.main(["--decode-file", f, "--e2e-device"]) == -1
    assert cli.main(["--decode-file", f, "--emit-file", f]) == -1
    # --out-file only makes sense in file mode
    assert cli.main(["-n", "20000", "--out-file", f]) == -1


def test_decode_file_too_short(tmp_path):
    f = str(tmp_path / "tiny.bin")
    np.zeros(2, np.int32).tofile(f)   # 64 encoded bits < framing overhead
    assert cli.main(["-i", "h", "--decode-file", f]) == 1


def test_decode_file_missing(tmp_path):
    assert cli.main(["--decode-file", str(tmp_path / "nope.bin")]) == 1
