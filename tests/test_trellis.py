"""Trellis-table tests: consistency between the state convention and the
reference's shift-register encoder (reference: src/viterbiDF.h:43-62)."""

import numpy as np

from tpu_viterbi.chain.encode import conv_encode_np
from tpu_viterbi.config import CONST_LEN, NUM_STATES
from tpu_viterbi.trellis import (BRANCH_CODE, branch_sign_table,
                                 encode_output_table)


def _encode_bits_scalar(bits):
    """Literal transcription of the reference encoder semantics
    (viterbiDF.h:43-62) for use as a test oracle."""
    buffer = 0
    out = []
    for b in bits:
        buffer >>= 1
        buffer |= int(b) << (CONST_LEN - 1)
        o0 = bin(buffer & 0o171).count("1") % 2
        o1 = bin(buffer & 0o133).count("1") % 2
        out += [o0, o1]
    return np.array(out, dtype=np.uint8)


def test_conv_encode_matches_shift_register(rng):
    bits = rng.integers(0, 2, 500).astype(np.uint8)
    assert np.array_equal(conv_encode_np(bits), _encode_bits_scalar(bits))


def test_branch_code_consistent_with_encoder(rng):
    """Walk a random bit stream; at every stage the branch code looked up by
    (new_state, dropped_bit) must equal the encoder's actual output pair."""
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    coded = conv_encode_np(bits)
    history = np.zeros(len(bits) + 6, dtype=np.int64)
    history[6:] = bits
    for t in range(len(bits)):
        window = history[t: t + 7]  # b_{t-6} .. b_t
        state = int(sum(window[6 - i] << i for i in range(6)))  # newest @ LSB
        j = int(window[0])  # b_{t-6}
        c = BRANCH_CODE[state, j]
        assert (c >> 1) & 1 == coded[2 * t]
        assert c & 1 == coded[2 * t + 1]


def test_branch_sign_table():
    signs = branch_sign_table()
    assert signs.shape == (NUM_STATES, 2, 2)
    assert set(np.unique(signs)) == {-1, 1}
    # sign must agree with the code bit
    out0 = (BRANCH_CODE >> 1) & 1
    out1 = BRANCH_CODE & 1
    assert np.array_equal(signs[..., 0], 2 * out0 - 1)
    assert np.array_equal(signs[..., 1], 2 * out1 - 1)


def test_branch_code_balanced():
    """Each state has 2 incoming branches; over all (state, j) each code
    value appears equally often (code symmetry)."""
    vals, counts = np.unique(BRANCH_CODE, return_counts=True)
    assert list(vals) == [0, 1, 2, 3]
    assert all(c == 32 for c in counts)


def test_encode_output_table_matches_scalar():
    table = encode_output_table()
    for buf in [0, 1, 0o171, 0o133, 127, 64, 37]:
        o0 = bin(buf & 0o171).count("1") % 2
        o1 = bin(buf & 0o133).count("1") % 2
        assert table[buf] == (o0 << 1) | o1
