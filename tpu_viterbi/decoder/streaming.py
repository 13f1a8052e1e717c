"""Streaming decode: feed the channel stream in chunks, get decoded bits out.

The reference cannot resume across ``run()`` calls — every call re-derives
framing from scratch and the caller must present the whole message at once
(reference: src/viterbi/viterbi.cu:210-238; SURVEY.md §5 checkpoint/resume).
This module adds the capability: a StreamingViterbi instance
buffers the undecodable tail of each chunk (the extra_l + extra_r = 64-stage
overlap-save boundary) and prepends it to the next chunk, so an arbitrarily
long stream can be decoded in fixed-size pieces with exactly the same
per-block framing/quality as the one-shot decoder.

Output alignment matches the one-shot contract: across all emitted chunks,
output bit i is the estimate of stream message bit i + extra_l, and the
total emitted length equals ``get_message_len`` of the whole stream — the
final extra_r-and-rounding stages are consumed as right halo only, exactly
as the reference's framing discards them (viterbi.cu:86-88).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import DecoderConfig
from .api import DEFAULT_DEC_LEN, ViterbiTPU


class StreamingViterbi:
    """Chunked decoding with carry-over of the overlap-save boundary."""

    def __init__(self, config: DecoderConfig = DecoderConfig(),
                 dec_len: int = DEFAULT_DEC_LEN, backend: str = "auto"):
        """dec_len / backend are forwarded to the underlying ViterbiTPU
        (api.py)."""
        self.config = config
        self._dec = ViterbiTPU(config, dec_len=dec_len, backend=backend)
        self._carry: Optional[np.ndarray] = None  # packed words carried over

    @property
    def _values_per_word(self) -> int:
        return self.config.enc_data_per_pack

    def push(self, packed_chunk: np.ndarray) -> np.ndarray:
        """Feed packed channel words; returns packed decoded words for every
        output bit that became decodable (possibly empty).

        Chunks must be whole packed words; for bit alignment across chunks
        the chunk word count must keep stages a multiple of bits_per_pack
        (any equal-sized chunks >= 1024 words satisfy this).
        """
        cfg = self.config
        chunk = np.asarray(packed_chunk)
        if self._carry is not None:
            chunk = np.concatenate([self._carry, chunk])

        input_num = chunk.shape[0] * self._values_per_word
        message_len = cfg.get_message_len(input_num)
        if message_len <= 0:
            self._carry = chunk
            return np.zeros(0, dtype=np.uint16 if cfg.bits_per_pack == 16
                            else np.uint32)

        out, _ = self._dec.run(chunk, input_num, want_time=False)

        # carry everything from the first un-decoded message bit onward:
        # decoded bits cover stream stages [0, message_len); the next call
        # must re-see stages from message_len on (they were only used as
        # right-halo here).  message_len is a bits_per_pack multiple; carry
        # at word granularity.
        consumed_values = 2 * message_len
        consumed_words = consumed_values // self._values_per_word
        self._carry = chunk[consumed_words:]
        return out

    def flush(self) -> np.ndarray:
        """Decode whatever remains of the carried tail under the one-shot
        contract: only bits whose extra_r right halo is real input are
        emitted (``get_message_len`` of the carry), with NO synthetic
        padding — so across push()+flush() the streaming output covers
        exactly the bits a one-shot decode of the concatenated stream
        would (getMessageLen, reference viterbi.cu:86-88).

        Padding the right halo with zero words instead would squeeze out
        ~extra_r more bits, but under HARD a zero word is 32 explicit '0'
        bits (strong -1 symbols), a biased halo that can corrupt the tail
        decisions; the reference itself never emits those halo-less bits
        either — its message length stops extra_r short of the input
        (viterbi.cu:86-88), exactly what this does."""
        cfg = self.config
        out_dtype = np.uint16 if cfg.bits_per_pack == 16 else np.uint32
        if self._carry is None or self._carry.shape[0] == 0:
            return np.zeros(0, dtype=out_dtype)
        carry, self._carry = self._carry, None
        input_num = carry.shape[0] * self._values_per_word
        if cfg.get_message_len(input_num) <= 0:
            # tail too short to decode anything under the halo contract
            return np.zeros(0, dtype=out_dtype)
        out, _ = self._dec.run(carry, input_num, want_time=False)
        return out
