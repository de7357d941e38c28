"""Cross-validation of the banded fill + traceback against the naive
oracle — the load-bearing test, mirroring the reference's 5000-trial
randomized "cross" unittest (gaba.c:5723-5764): random sequences,
mutated copies with band-bounded indel drift, compared on score, max
position, and path."""

import numpy as np
import pytest

from minialign_jax.dp import band
from minialign_jax.dp.oracle import oracle_extend
from minialign_jax.dp.traceback import traceback_batch
from minialign_jax.params import ScoreParams


def simple(m, x, gi, ge, **kw):
    mat = tuple(m if (i & 3) == (i >> 2) else -x for i in range(16))
    return ScoreParams(matrix=mat, gi=gi, ge=ge, xdrop=80, **kw)


PARAMS = {
    "linear": simple(1, 2, 0, 1),
    "affine": simple(2, 3, 5, 1),
    "affine_default": simple(1, 1, 1, 1),
    "combined": simple(2, 3, 5, 1, gfa=2, gfb=2),
    "combined_pacbio": simple(2, 4, 4, 2, gfa=3, gfb=3),
}


def mutate(rng, a, wband):
    """Mutated copy of a with drift bounded to the band width."""
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
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("pname", list(PARAMS))
@pytest.mark.parametrize("W", [16, 32, 64])
def test_cross_band_vs_oracle(pname, W):
    p = PARAMS[pname]
    import zlib
    rng = np.random.default_rng(zlib.crc32(f"{pname}/{W}".encode()))
    # 40 x 15 (model x W) cells = 600 randomized trials total, vs the
    # reference's 5000-trial cross test (gaba.c:5723-5764) run once
    # per release; the E2E fuzzer (tests/tools/fuzz_parity.py) layers
    # whole-pipeline coverage on top
    n_trials = 40
    seqs_a, seqs_b, expect = [], [], []
    for _ in range(n_trials):
        la = int(rng.integers(10, 300))
        a = rng.integers(0, 4, la)
        b = mutate(rng, a, W)
        if len(b) == 0:
            b = np.asarray([a[0]], np.int64)
        seqs_a.append(a)
        seqs_b.append(b)
        expect.append(oracle_extend(p, a, b))

    ab, alen = band.pad_codes(seqs_a)
    bb, blen = band.pad_codes(seqs_b)
    fill = band.make_fill(p, W, max_blocks=40, trace=True)
    res, bufs = fill(ab, alen, bb, blen)
    res = type(res)(*(np.asarray(x) for x in res))
    bufs = type(bufs)(*(np.asarray(x) for x in bufs))

    traces = traceback_batch(p, W, bufs, res)
    for k in range(n_trials):
        e = expect[k]
        assert int(res.max_score[k]) == e.score, (
            pname, W, k, int(res.max_score[k]), e.score)
        assert int(res.max_i[k]) == e.alen, (pname, W, k)
        assert int(res.max_j[k]) == e.blen, (pname, W, k)
        t = traces[k]
        assert t is not None, (pname, W, k)
        assert t.path == e.path, (pname, W, k, t.path, e.path)


def test_notrace_matches_trace():
    p = PARAMS["combined"]
    rng = np.random.default_rng(7)
    seqs_a = [rng.integers(0, 4, 200) for _ in range(8)]
    seqs_b = [mutate(rng, a, 64) for a in seqs_a]
    ab, alen = band.pad_codes(seqs_a)
    bb, blen = band.pad_codes(seqs_b)
    f1 = band.make_fill(p, 64, max_blocks=32, trace=False)
    f2 = band.make_fill(p, 64, max_blocks=32, trace=True)
    r1 = f1(ab, alen, bb, blen)
    r2, _ = f2(ab, alen, bb, blen)
    np.testing.assert_array_equal(np.asarray(r1.max_score),
                                  np.asarray(r2.max_score))
    np.testing.assert_array_equal(np.asarray(r1.max_i), np.asarray(r2.max_i))


def test_empty_and_all_mismatch():
    p = PARAMS["affine_default"]
    a = [np.asarray([0, 0, 0, 0]), np.asarray([0, 1, 2, 3])]
    b = [np.asarray([3, 3, 3, 3]), np.asarray([0, 1, 2, 3])]
    ab, alen = band.pad_codes(a)
    bb, blen = band.pad_codes(b)
    fill = band.make_fill(p, 32, max_blocks=16, trace=False)
    r = fill(ab, alen, bb, blen)
    assert int(np.asarray(r.max_score)[0]) == 0
    assert int(np.asarray(r.max_score)[1]) == 4
    assert int(np.asarray(r.max_i)[1]) == 4
