"""tpu_viterbi — block-parallel Viterbi decoding framework in JAX.

A from-scratch JAX rebuild of the capabilities of the reference CUDA
project (alireza-md93/GPU-Accelerated-Viterbi-Decoder): the K=7 rate-1/2
convolutional code SDR chain (bit source -> encoder -> AWGN -> quantize/pack
-> decode -> BER), a block-parallel fused BM+ACS+register-exchange decoder
(a CUDA kernel for Hopper GPUs, called through jax.ffi, with a plain XLA
core beside it), and multi-card scaling over a jax.sharding mesh.
"""

import jax as _jax

# Partitionable threefry keys make sharded in-graph workload generation
# possible: each mesh device computes its slice of the random stream
# independently, with no gather, and the slices equal a single-device draw
# (sharding/simulate.py, scripts/multihost_decode_example.py).
_jax.config.update("jax_threefry_partitionable", True)

from .config import (ChannelIn, CompMode, DecodeOut, DecoderConfig, Metric,
                     options_valid)
from .decoder.api import ViterbiTPU

__all__ = [
    "ChannelIn", "CompMode", "DecodeOut", "DecoderConfig", "Metric",
    "options_valid", "ViterbiTPU",
]

__version__ = "0.1.0"
