"""The band fill on NVIDIA GPUs: native/band_fill.cu behind jax.ffi.

Same store contract as band.make_store_fill, bit-identical results:
each problem's characters are read by pointer from the device-resident
sequence stores (sa[offa[k] : offa[k] + lna[k]], N beyond), so no
per-dispatch gather or packing runs before the fill. One warp fills one
problem (two for W=16) and stops on its own X-drop or p-limit, so the
trace blocks past a problem's own end (n_steps // BLK) are left
unwritten: nothing reads them (the walkers start at the max and walk
back).

The library is built from the repository's sources with nvcc on first
use (`make -C native cuda`, into native/build/); a build or load failure
raises, there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..params import COMBINED, ScoreParams
from . import band

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libminialign_cuda.so")
TARGETS = (("minialign_band_fill", "MinialignBandFill"),
           ("minialign_band_fill_trace", "MinialignBandFillTrace"))
_LOCK = threading.Lock()
_REGISTERED: set = set()     # platforms whose FFI targets are registered


def build() -> float:
    """Compile the CUDA library if it is missing or stale; returns the
    seconds spent. Raises RuntimeError with the compiler output when the
    build fails."""
    t0 = time.perf_counter()
    r = subprocess.run(
        ["make", "-C", _NATIVE_DIR, "cuda",
         f"FFI_INCLUDE={jax.ffi.include_dir()}"],
        capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("building the CUDA band fill failed:\n"
                           + r.stdout + r.stderr)
    return time.perf_counter() - t0


def register(lib_path: str | None = None, platform: str = "CUDA") -> None:
    """Register the fill's FFI targets for `platform`. With no lib_path
    the CUDA library is built (if needed) and loaded."""
    with _LOCK:
        if platform in _REGISTERED:
            return
        if lib_path is None:
            build()
            lib_path = LIB_PATH
        lib = ctypes.CDLL(lib_path)
        for name, sym in TARGETS:
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, sym)),
                platform=platform)
        _REGISTERED.add(platform)


def score_cfg(p: ScoreParams, W: int, max_blocks: int) -> np.ndarray:
    """The kernel's int32 `cfg` attribute (layout: CFG_* in
    native/band_fill_kernel.cuh)."""
    floor = band.score_floor(p)
    head = [W, max_blocks, p.gi, p.ge, p.gfa_eff, p.gfb_eff, p.gfa, p.gfb,
            int(p.model == COMBINED), p.xdrop, floor,
            max(int(p.gap_a(1)), floor), max(int(p.gap_b(1)), floor)]
    return np.asarray(head + p.matrix55().reshape(-1).tolist(), np.int32)


def make_fill(p: ScoreParams, W: int, la: int, lb: int, trace: bool):
    """Store-contract fill for windows of at most la / lb characters
    (fixes the block capacity, band.max_blocks_for). Returns
    fn(sa, offa, lna, sb, offb, lnb) -> FillResult, or (FillResult,
    TraceBuffers) with trace=True. Registers the CUDA targets unless a
    platform was registered already (tests register a host build)."""
    p.check()
    if W not in (16, 32, 64):
        raise ValueError(f"band width {W} is not 16, 32 or 64")
    if not _REGISTERED:
        register()
    nb = band.max_blocks_for(la, lb)
    cfg = score_cfg(p, W, nb)

    def fill(sa, offa, lna, sb, offb, lnb):
        B = lna.shape[0]
        res_t = jax.ShapeDtypeStruct((4, B), jnp.int32)
        args = (sa, jnp.asarray(offa, jnp.int32), jnp.asarray(lna, jnp.int32),
                sb, jnp.asarray(offb, jnp.int32), jnp.asarray(lnb, jnp.int32))
        if trace:
            outs = jax.ffi.ffi_call(TARGETS[1][0], (
                res_t,
                jax.ShapeDtypeStruct((B, nb, band.BLK, 16), jnp.uint32),
                jax.ShapeDtypeStruct((B, nb), jnp.uint32),
                jax.ShapeDtypeStruct((B, nb), jnp.int32),
                jax.ShapeDtypeStruct((B, nb), jnp.int32)))(*args, cfg=cfg)
            res = outs[0]
        else:
            res = jax.ffi.ffi_call(TARGETS[0][0], (res_t,))(
                *args, cfg=cfg)[0]
        out = band.FillResult(max_score=res[0], max_i=res[1], max_j=res[2],
                              n_steps=res[3],
                              n_blocks=jnp.max(res[3]) // band.BLK)
        return (out, band.TraceBuffers(*outs[1:])) if trace else out

    return fill
