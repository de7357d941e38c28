"""The GPU band fill (native/band_fill_kernel.cuh) against the XLA
reference fill: identical FillResult fields, and identical TraceBuffers
on every block each problem filled.

On the CPU the kernel body is compiled for the host with the warp
emulation of tests/cuda_emu and registered as the "cpu" target of
dp/cuda_fill.py, so the wrapper (ffi_call, cfg, unpacking) runs as it
does on the card. test_gpu_kernel_matches_xla runs the nvcc build on a
GPU (skipped here; chip_smoke.py runs the same check at real widths)."""

import os
import re

import jax
import numpy as np
import pytest

from minialign_jax.dp import band, cuda_fill
from minialign_jax.params import MapParams, ScoreParams

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    from cuda_emu import register
    register(str(tmp_path_factory.mktemp("cuda_emu")))


def simple(m, x, gi, ge, **kw):
    mat = tuple(m if (i & 3) == (i >> 2) else -x for i in range(16))
    return ScoreParams(matrix=mat, gi=gi, ge=ge, xdrop=80, **kw)


PARAMS = {"affine": simple(2, 3, 5, 1),
          "combined": simple(2, 4, 4, 2, gfa=3, gfb=3),
          "linear": simple(1, 2, 0, 1),
          "default": MapParams().score}


def mutate(rng, a, wband):
    out = []
    drift = 0
    lim = wband // 2 - 6
    for ch in a:
        r = rng.random()
        if r < 0.10:
            out.append(rng.integers(0, 4))
        elif r < 0.15 and drift < lim:
            out.append(rng.integers(0, 4))
            out.append(ch)
            drift += 1
        elif r < 0.20 and drift > -lim:
            drift -= 1
        else:
            out.append(ch)
    return np.asarray(out, np.int8)


def stores(seqs_a, seqs_b):
    """Concatenated stores + per-problem offsets and lengths."""
    def one(seqs):
        lens = np.asarray([len(s) for s in seqs], np.int32)
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
        flat = np.concatenate([np.asarray(s, np.int8) for s in seqs])
        return band.pad_store(flat), offs, lens
    sa, offa, lna = one(seqs_a)
    sb, offb, lnb = one(seqs_b)
    return sa, offa, lna, sb, offb, lnb


def assert_same(ref, got, trace):
    r1, r2 = (ref[0], got[0]) if trace else (ref, got)
    for f in r1._fields:
        np.testing.assert_array_equal(np.asarray(getattr(r1, f)),
                                      np.asarray(getattr(r2, f)), err_msg=f)
    if trace:
        nblk = np.asarray(r1.n_steps) // band.BLK
        for f in ref[1]._fields:
            x1 = np.asarray(getattr(ref[1], f))
            x2 = np.asarray(getattr(got[1], f))
            for k, n in enumerate(nblk):
                np.testing.assert_array_equal(x1[k, :n], x2[k, :n],
                                              err_msg=f"{f}[{k}]")


def problems(rng, W):
    a = [rng.integers(0, 4, int(rng.integers(40, 250))).astype(np.int8)
         for _ in range(5)]
    b = [mutate(rng, x, W) for x in a]
    a += [np.zeros(0, np.int8),                          # empty
          rng.integers(0, 4, 300).astype(np.int8)]       # b runs out
    b += [np.zeros(0, np.int8), a[-1][:40].copy()]
    # unrelated sequences: the X-drop ends the fill early
    a.append(rng.integers(0, 4, 200).astype(np.int8))
    b.append(rng.integers(0, 4, 200).astype(np.int8))
    return a, b


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("pname,W", [("affine", 64), ("combined", 32),
                                     ("linear", 16)])
def test_kernel_matches_xla(emu, pname, W, trace):
    p = PARAMS[pname]
    rng = np.random.default_rng(13)
    args = stores(*problems(rng, W))
    ref = band.make_store_fill(p, W, 512, 512, trace)(*args)
    got = jax.jit(cuda_fill.make_fill(p, W, 512, 512, trace))(*args)
    assert_same(ref, got, trace)


@pytest.mark.parametrize("W", [64, 16])
def test_kernel_long_band_moves(emu, W):
    """Default scoring, 2 kb problems (the band drifts far from the
    diagonal) and an odd batch (W=16 packs two problems per warp)."""
    p = PARAMS["default"]
    rng = np.random.default_rng(W)
    a = [rng.integers(0, 4, n).astype(np.int8) for n in (2000, 1500, 33)]
    b = [mutate(rng, a[0], W), mutate(rng, a[1], W), a[2]]
    args = stores(a, b)
    ref = band.make_store_fill(p, W, 2400, 2400, True)(*args)
    got = cuda_fill.make_fill(p, W, 2400, 2400, True)(*args)
    assert_same(ref, got, True)
    assert int(np.asarray(got[0].max_score)[0]) > 500


def test_fill_wrapper_outputs(emu):
    """FillResult / TraceBuffers dtypes and shapes match make_fill's;
    n_blocks is the batch-wide block count; offsets index the stores."""
    p = PARAMS["default"]
    rng = np.random.default_rng(1)
    a = [rng.integers(0, 4, 120).astype(np.int8) for _ in range(3)]
    args = stores(a, [x.copy() for x in a])
    la, lb = 256, 256
    nb = band.max_blocks_for(la, lb)
    res, bufs = cuda_fill.make_fill(p, 64, la, lb, True)(*args)
    ref, rbufs = band.make_store_fill(p, 64, la, lb, True)(*args)
    for x, y in zip(res, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
    for x, y in zip(bufs, rbufs):
        assert x.dtype == y.dtype and x.shape == y.shape
    assert bufs.masks.shape == (3, nb, band.BLK, 16)
    assert int(res.n_blocks) == int(np.asarray(res.n_steps).max()) // band.BLK
    # identical sequences: the max is the full diagonal
    assert np.asarray(res.max_score).tolist() == [120] * 3
    assert np.asarray(res.max_i).tolist() == [120] * 3
    # a shifted offset reads a different window
    sa, offa, lna, sb, offb, lnb = args
    moved = cuda_fill.make_fill(p, 64, la, lb, False)(
        sa, offa + 1, lna - 1, sb, offb, lnb)
    assert int(np.asarray(moved.max_score)[0]) < 120


def test_score_cfg_layout():
    """cuda_fill.score_cfg follows the header's CFG_* enum."""
    src = open(os.path.join(NATIVE, "band_fill_kernel.cuh")).read()
    body = re.search(r"enum \{([^}]*)\}", src).group(1)
    names = [n.strip().split("=")[0].strip() for n in body.split(",")]
    pos = {n: i for i, n in enumerate(names) if n.startswith("CFG_")}
    p = ScoreParams(gi=2, ge=1, gfa=3, gfb=4, xdrop=61)
    cfg = cuda_fill.score_cfg(p, 32, 77)
    assert cfg.dtype == np.int32 and len(cfg) == pos["CFG_MAT"] + 25
    floor = band.score_floor(p)
    want = {"CFG_W": 32, "CFG_MAX_BLOCKS": 77, "CFG_GI": 2, "CFG_GE": 1,
            "CFG_GFA": p.gfa_eff, "CFG_GFB": p.gfb_eff, "CFG_GFA_BND": 3,
            "CFG_GFB_BND": 4, "CFG_COMBINED": 1, "CFG_XDROP": 61,
            "CFG_FLOOR": floor,
            "CFG_INIT_A1": max(int(p.gap_a(1)), floor),
            "CFG_INIT_B1": max(int(p.gap_b(1)), floor)}
    for name, v in want.items():
        assert cfg[pos[name]] == v, name
    np.testing.assert_array_equal(cfg[pos["CFG_MAT"]:],
                                  p.matrix55().reshape(-1))


def test_make_fill_rejects_bad_width(emu):
    with pytest.raises(ValueError):
        cuda_fill.make_fill(PARAMS["default"], 48, 256, 256, False)


@pytest.mark.gpu
def test_gpu_kernel_matches_xla(gpu):
    cuda_fill.register()
    rng = np.random.default_rng(3)
    for W in (64, 32, 16):
        args = [jax.device_put(x, gpu) for x in stores(*problems(rng, W))]
        for trace in (False, True):
            ref = band.make_store_fill(PARAMS["affine"], W, 512, 512,
                                       trace)(*args)
            got = cuda_fill.make_fill(PARAMS["affine"], W, 512, 512,
                                      trace)(*args)
            assert_same(ref, got, trace)
