"""Host build of the GPU band fill kernel for the CPU test suite.

build(out_dir) compiles native/band_fill_kernel.cuh with shim.h's warp
emulation into a shared library that exports the same XLA FFI handlers
as native/band_fill.cu; register() makes them the "cpu" targets of
minialign_jax.dp.cuda_fill.
"""

import os
import subprocess

import jax

HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE = os.path.join(os.path.dirname(os.path.dirname(HERE)), "native")


def build(out_dir: str) -> str:
    so = os.path.join(out_dir, "libminialign_cuda_emu.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-I", HERE, "-I", NATIVE, "-I", jax.ffi.include_dir(),
         "-o", so, os.path.join(HERE, "emu_fill.cpp")],
        check=True, capture_output=True, text=True)
    return so


def register(out_dir: str) -> None:
    from minialign_jax.dp import cuda_fill
    cuda_fill.register(build(out_dir), platform="cpu")
