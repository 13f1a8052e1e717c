"""CLI driver tests (reference: src/main.cpp): flag parsing, validity
errors with reference strings, and an end-to-end noiseless run."""

import numpy as np
import pytest

from tpu_viterbi import cli


def test_invalid_combo_exit_codes(capsys):
    assert cli.main(["-i", "s16", "-m", "f16", "-n", "1000"]) == -1
    assert "fp16 metric does not support 16-bit" in capsys.readouterr().err
    assert cli.main(["-i", "s16", "-m", "b16", "-n", "1000"]) == -1
    assert cli.main(["-i", "s8", "-m", "f16", "-n", "1000"]) == -1
    assert cli.main(["-m", "f16", "-c", "dpx", "-n", "1000"]) == -1


def test_cli_end_to_end_noiseless(capsys):
    rc = cli.main(["-n", "20000", "-s", "15", "-i", "s8", "-m", "b32",
                   "--seed", "7", "--dec-len", "512", "--backend", "xla"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Pipeline executed." in out
    assert "BEN: 0" in out


def test_cli_verbose_config_echo(capsys):
    rc = cli.main(["-n", "20000", "-s", "15", "-i", "s4", "-m", "b16",
                   "-o", "b16", "--seed", "7", "-v", "--dec-len", "256",
                   "--backend", "xla"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Input Channel Type: 4-bit Soft Decision" in out
    assert "Metric Type: 16-bit" in out
    assert "Output Type: 16-bit" in out
    assert "kernel time" in out  # -v prints pipeline status


def test_cli_guards_match_options_valid():
    """The CLI's hand-rolled runtime guards (mirroring the reference's
    main.cpp:26-41) must reject exactly the combos config.options_valid
    rejects."""
    from tpu_viterbi.config import (ChannelIn, CompMode, DecodeOut, Metric,
                                    options_valid)

    ch_flag = {ChannelIn.HARD: "h", ChannelIn.SOFT4: "s4",
               ChannelIn.SOFT8: "s8", ChannelIn.SOFT16: "s16",
               ChannelIn.FP32: "f"}
    m_flag = {Metric.M_B32: "b32", Metric.M_B16: "b16", Metric.M_FP16: "f16"}
    o_flag = {DecodeOut.O_B32: "b32", DecodeOut.O_B16: "b16"}
    c_flag = {CompMode.REG: "reg", CompMode.DPX: "dpx"}

    for ch in ChannelIn:
        for m in Metric:
            for o in DecodeOut:
                for c in CompMode:
                    argv = ["-i", ch_flag[ch], "-m", m_flag[m],
                            "-o", o_flag[o], "-c", c_flag[c], "-n", "0"]
                    rc = cli.main(argv)
                    if options_valid(ch, m, o, c):
                        # valid combos get past the guards and fail later
                        # on the degenerate -n 0 (anything but the -1
                        # validity exit)
                        assert rc != -1, (ch, m, o, c)
                    else:
                        assert rc == -1, (ch, m, o, c)


def test_cli_e2e_device_mode(capsys):
    rc = cli.main(["-n", "40000", "-s", "15", "-i", "s8", "-m", "b32",
                   "--seed", "5", "--e2e-device", "-v"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "BEN: 0" in out
    assert "In-graph chain over" in out


def test_cli_flag_interplay(capsys):
    """Knobs that only make sense in one mode are rejected elsewhere
    instead of silently ignored: --stream-words and --out-file need
    --decode-file, and the removed flags no longer parse."""
    base = ["-n", "40000", "-s", "15", "--seed", "5"]
    assert cli.main(base + ["--stream-words", "2048"]) == -1
    assert "--stream-words requires --decode-file" in \
        capsys.readouterr().err
    assert cli.main(base + ["--out-file", "x.dec"]) == -1
    assert "--out-file requires --decode-file" in capsys.readouterr().err
    for flag in (["--time-mode", "slope"], ["--generator", "xla"],
                 ["--survivor", "window"], ["--backend", "pallas"]):
        with pytest.raises(SystemExit):
            cli.main(base + flag)
    capsys.readouterr()


def test_cli_cuda_backend_rejected_off_gpu(capsys):
    """--backend cuda without a GPU fails with a one-line error, on the
    pipeline, the file-serving and the --e2e-device paths alike."""
    base = ["-n", "40000", "-s", "15", "--seed", "5", "--backend", "cuda"]
    assert cli.main(base) == -1
    err = capsys.readouterr().err
    assert err.startswith("Error: backend 'cuda' needs a GPU"), err
    assert cli.main(base + ["--e2e-device"]) == -1
    assert "needs a GPU" in capsys.readouterr().err


def test_cli_verbose_reports_decode_core(capsys):
    """-v names the decode core that ran (the XLA core on the CPU), on
    the pipeline and the --e2e-device paths."""
    base = ["-n", "20000", "-s", "15", "-i", "s8", "--seed", "5", "-v",
            "--dec-len", "512"]
    assert cli.main(base) == 0
    assert "Decode core: xla" in capsys.readouterr().out
    assert cli.main(base + ["--e2e-device"]) == 0
    assert "(decode core: xla)" in capsys.readouterr().out
