"""Public decoder API: the analog of the reference's ViterbiCUDA class
(reference: src/viterbi/viterbi.h:91-152, src/viterbi/viterbi.cu:210-238).

Surface kept: constructor (optionally pre-sized), ``run(input, input_num)``
returning packed decoded words plus a kernel time, and the size calculators
``get_input_size`` / ``get_message_len`` / ``get_output_size``.  The exported
framing constants (extra_l, extra_r, bits_per_pack, enc_data_per_pack, ...)
live on the DecoderConfig.

``run`` device-puts the packed input, executes the AOT-compiled
block-parallel decode, and blocks until ready; the reported kernel time is
the wall time of that one execution (compare: cudaEvent around the kernel
launch, viterbi.cu:224-232, excluding host<->device copies).  Compilation
happens ahead of time (``jit(...).lower(...).compile()``), outside the
timed region.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ChannelIn, ConfigResolutionError, DecoderConfig
from .core_xla import auto_dec_len, decode_packed_xla, plan_blocks

# output bits per block: the best point of the Hopper kernel's dec_len
# sweep at 32M and 1M bits on an H200 (PERF.md, PR 1)
DEFAULT_DEC_LEN = 1024

BACKENDS = ("auto", "xla", "cuda")


def resolve_backend(backend: str) -> str:
    """The decode core a backend name runs on this process's platform:
    'auto' is the Hopper kernel ('cuda') on a GPU and the XLA scan core
    elsewhere; an explicit 'cuda' off the GPU raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    on_gpu = jax.default_backend() == "gpu"
    if backend == "cuda" and not on_gpu:
        raise ConfigResolutionError(
            "backend 'cuda' needs a GPU, but JAX runs on "
            f"{jax.default_backend()!r}")
    if backend == "auto":
        return "cuda" if on_gpu else "xla"
    return backend


def decode_core(core: str):
    """decode(packed, cfg, plan) of a resolved core name."""
    if core == "cuda":
        from .core_cuda import decode_packed_cuda
        return decode_packed_cuda
    return decode_packed_xla


class ViterbiTPU:
    """Block-parallel Viterbi decoder."""

    def __init__(self, config: DecoderConfig = DecoderConfig(),
                 input_num: Optional[int] = None,
                 dec_len: int = DEFAULT_DEC_LEN,
                 backend: str = "auto"):
        """backend: 'auto' | 'xla' | 'cuda' (see resolve_backend); the
        resolved core is ``self.core``.  dec_len='auto' picks a
        message-size-aware block length (core_xla.auto_dec_len)."""
        self.config = config
        self.dec_len = dec_len if dec_len == "auto" else int(dec_len)
        self.backend = backend
        self.core = resolve_backend(backend)
        self._exec_cache: dict = {}
        if input_num is not None:
            # Pre-sizing hook (reference pre-allocating ctor, viterbi.cu:31-36);
            # under XLA the analog is warming the compile cache for this size.
            self._warm(input_num)

    # --- size API (reference: viterbi.cu:64-92) ---
    def get_input_size(self, input_num: int) -> int:
        return self.config.get_input_size(input_num)

    def get_message_len(self, input_num: int) -> int:
        return self.config.get_message_len(input_num)

    def get_output_size(self, input_num: int) -> int:
        return self.config.get_output_size(input_num)

    # --- decode ---
    def _build(self, input_num: int):
        cfg = self.config
        message_len = cfg.get_message_len(input_num)
        dl = auto_dec_len(message_len, cfg.bits_per_pack) \
            if self.dec_len == "auto" else self.dec_len
        plan = plan_blocks(message_len, cfg.bits_per_pack, dl)
        decode = decode_core(self.core)

        @jax.jit
        def run(packed):
            return decode(packed, cfg, plan)

        return run, plan

    _exec = None
    _EXEC_CACHE_SIZE = 8   # compiled sizes kept per instance (LRU)

    def _input_dtype(self):
        return (jnp.float32 if self.config.channel_in == ChannelIn.FP32
                else jnp.int32)

    def _warm(self, input_num: int):
        """Build and AOT-compile the decode for this input size (the analog
        of the reference's pre-allocating constructor, viterbi.cu:31-36 —
        there memory, here the compile cache).  Compiling ahead of time
        keeps compilation strictly outside the timed region of ``run``
        without spending a throwaway execution.  Executables are cached
        PER input size (keyed dict), so alternating sizes never re-lower or
        recompile (the reference's single pre-alloc, viterbi.cu:31-36,
        covers one size — this covers every size seen)."""
        ent = self._exec_cache.pop(input_num, None)
        if ent is None:
            fn, plan = self._build(input_num)
            words = self.config.get_input_words(input_num)
            aval = jax.ShapeDtypeStruct((words,), self._input_dtype())
            ent = (plan, fn.lower(aval).compile())
            # Bounded LRU: compiled executables pin device memory, so a
            # long-lived instance fed many distinct sizes must not retain
            # one per size forever — evict the least recently used beyond
            # _EXEC_CACHE_SIZE (re-inserting below marks this one newest).
            while len(self._exec_cache) >= self._EXEC_CACHE_SIZE:
                self._exec_cache.pop(next(iter(self._exec_cache)))
        self._exec_cache[input_num] = ent
        self._plan, self._exec = ent

    def _check_decodable(self, input_num: int) -> int:
        cfg = self.config
        if cfg.get_message_len(input_num) <= 0:
            raise ValueError(
                f"input_num={input_num} yields no decodable message bits "
                f"(need > {2 * (cfg.extra_l + cfg.extra_r)} encoded bits)")
        return cfg.get_input_words(input_num)

    def _stage(self, packed_input, input_num: int, words: int):
        n_in = np.shape(packed_input)[0]
        if n_in < words:
            # the reference would read out of bounds here (caller contract:
            # buffer sized by getInputSize, viterbi.cu:64-84); fail loudly
            raise ValueError(
                f"packed input has {n_in} words, need {words} for "
                f"input_num={input_num} ({self.config.channel_in.name})")
        return jax.device_put(
            jnp.asarray(packed_input, dtype=self._input_dtype())[:words])

    def run(self, packed_input, input_num: int,
            want_time: bool = True) -> Tuple[np.ndarray, Optional[float]]:
        """Decode `input_num` encoded bits from packed channel words.

        Returns (packed_output_words, kernel_seconds).  Output dtype is
        uint32 for O_B32 and uint16 for O_B16 (reference decPack_t).

        The time spans exactly one execution of the pre-compiled decode
        (input already device-resident, output blocked-on) — the cudaEvent
        boundary of the reference (viterbi.cu:224-232)."""
        words = self._check_decodable(input_num)
        self._warm(input_num)
        x = self._stage(packed_input, input_num, words)
        jax.block_until_ready(x)
        start = time.perf_counter()
        out = jax.block_until_ready(self._exec(x))
        t = time.perf_counter() - start
        return np.asarray(out), (t if want_time else None)

    def run_stream(self, packed_inputs, input_num: int,
                   want_time: bool = True):
        """Sustained serving mode: decode a stream of messages back to
        back — the serving analog of the reference's persistent
        single-launch kernel (viterbi.cu:228).

        All inputs are staged to the device first (untimed, like the
        reference's host->device copies outside its cudaEvent pair); the
        pre-compiled executable is then dispatched for every message
        WITHOUT blocking in between, so JAX's async dispatch queues the
        whole stream, and one block at the end drains it.

        Returns (outputs, sustained_seconds_per_message).  outputs is a
        list of packed output word arrays in input order."""
        words = self._check_decodable(input_num)
        self._warm(input_num)
        xs = [self._stage(p, input_num, words) for p in packed_inputs]
        jax.block_until_ready(xs)
        t0 = time.perf_counter()
        outs = [self._exec(x) for x in xs]     # no intermediate blocking
        jax.block_until_ready(outs)
        t = time.perf_counter() - t0
        per = t / max(1, len(outs)) if want_time else None
        return [np.asarray(o) for o in outs], per
