"""Hopper decode kernel (csrc/viterbi_hopper.cu) called through jax.ffi.

The kernel is the reference's fused persistent design (SURVEY.md §3.3-3.4):
one warp per overlap-save block of the plan, two trellis states per lane,
the butterfly by __shfl_xor_sync, path metrics and register-exchange path
words in registers, a survivor dump every pack and a one-lane traceback in
the same kernel.  It reads the packed channel words straight from the flat
stream, so none of stage_layout_packed's window copies or transposes run.
Its decoded bits equal decode_packed_xla's for every config: b16 and fp16
metric modes ride the int32 kernel, which decodes them identically
(tests/test_metric_equiv.py).

The shared library is built from the tracked source with nvcc on first use
into <repo>/build/ (or by ``python -m tpu_viterbi.decoder.core_cuda``); a
failed build raises.  There is no interpret mode: CPU tests cover the
wrapper (operands, attributes, result shapes, assembly) and a NumPy mirror
of the kernel's lane arithmetic (tests/test_cuda_kernel.py); chip_smoke.py
runs the kernel itself against the XLA core and golden.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import jax
import jax.numpy as jnp

from ..config import ChannelIn, DecoderConfig
from .core_xla import (BlockPlan, assemble_output, fp32_ud_words,
                       needs_int32_renorm, validate_plan)

TARGET = "viterbi_hopper_decode"
_SYMBOL = "ViterbiDecode"
_MODE_UD = 4          # FP32 rides SOFT8-format (u, d) words
_LOCK = threading.Lock()
_REGISTERED = False

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "csrc", "viterbi_hopper.cu")
LIBRARY = os.path.join(_REPO, "build", "libviterbi_hopper.so")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> str:
    """Compile SOURCE for sm_90a into LIBRARY unless it is up to date.
    Writes to a temporary name first, so concurrent builders never load a
    half-written library.  Raises on failure."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, SOURCE]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}): {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def register() -> None:
    """Build (if needed), load and register the FFI target once."""
    global _REGISTERED
    with _LOCK:
        if _REGISTERED:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(getattr(lib, _SYMBOL)),
            platform="CUDA")
        _REGISTERED = True


def kernel_words(packed: jnp.ndarray, cfg: DecoderConfig) -> jnp.ndarray:
    """The int32 word stream the kernel reads: the packed channel words
    themselves, or for FP32 the (u, d) words of the clamped values."""
    if cfg.channel_in == ChannelIn.FP32:
        return fp32_ud_words(packed.astype(jnp.float32))
    return packed.astype(jnp.int32)


def kernel_attrs(cfg: DecoderConfig, plan: BlockPlan) -> dict:
    """Static attributes of the FFI call (see decode_impl in the .cu)."""
    mode = (_MODE_UD if cfg.channel_in == ChannelIn.FP32
            else int(cfg.channel_in))
    return dict(mode=mode, bpp=plan.bits_per_pack, dec_len=plan.dec_len,
                num_blocks=plan.num_blocks,
                renorm=int(needs_int32_renorm(cfg, plan)))


def kernel_result_shapes(plan: BlockPlan):
    """(output packs, survivor scratch): B * dec_len / bpp uint32 packs,
    block-major, and B * n_packs * 64 uint32 path words."""
    b = plan.num_blocks
    return (jax.ShapeDtypeStruct((b * (plan.dec_len // plan.bits_per_pack),),
                                 jnp.uint32),
            jax.ShapeDtypeStruct((b * plan.n_packs * 64,), jnp.uint32))


def decode_packed_cuda(packed: jnp.ndarray, cfg: DecoderConfig,
                       plan: BlockPlan) -> jnp.ndarray:
    """Full decode of packed channel words on the Hopper kernel; same
    contract and output as core_xla.decode_packed_xla."""
    validate_plan(cfg, plan)
    register()
    out_shape, surv_shape = kernel_result_shapes(plan)
    packs, _ = jax.ffi.ffi_call(TARGET, (out_shape, surv_shape))(
        kernel_words(packed, cfg), **kernel_attrs(cfg, plan))
    return assemble_output(packs.reshape(plan.num_blocks, -1), cfg, plan)


if __name__ == "__main__":
    print(build())
