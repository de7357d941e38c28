"""Oracle tests: the naive-DP literal cases from the reference
(gaba.c:4781-4894), one block per gap model."""

import numpy as np
import pytest

from minialign_jax.dp.oracle import oracle_extend
from minialign_jax.params import ScoreParams

CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}


def enc(s):
    return np.asarray([CODE[c] for c in s], np.int64)


def simple(m, x, gi, ge, **kw):
    mat = tuple(m if (i & 3) == (i >> 2) else -x for i in range(16))
    return ScoreParams(matrix=mat, gi=gi, ge=ge, xdrop=80, **kw)


LINEAR_P = simple(1, 2, 0, 1)          # unittest_default_params[1] linear
AFFINE_P = simple(2, 3, 5, 1)          # affine params[0]
COMBINED_P = simple(2, 3, 5, 1, gfa=2, gfb=2)   # combined params[0]


# (params, a, b, score, path) — literals from gaba.c naive unittests
CASES = [
    # LINEAR (gaba.c:4781-4798; params[0] = (1,1,0,1) via restore-default
    # is the m=1 matrix; the literal block uses params[0]=(2,3,0,6)...
    # we use the universal all-match/mismatch forms checked per-model)
    (AFFINE_P, "AAAA", "AAAA", 8, "DRDRDRDR"),
    (AFFINE_P, "AAAAAAAA", "TAAAAAAAA", 11, "DRDRDRDRDRDRDRDR"),
    (AFFINE_P, "GTTTTTTTT", "TTTTTTTT", 11, "DRDRDRDRDRDRDRDR"),
    (AFFINE_P, "TTTTACGTACGT", "TTACGTACGT", 13, "DRDRRRDRDRDRDRDRDRDRDR"),
    (AFFINE_P, "TTACGTACGT", "TTTTACGTACGT", 13, "DRDRDDDRDRDRDRDRDRDRDR"),
    (AFFINE_P, "ATGAAGCTGCGAGGC", "TGATGGCTTGCGAGGC", 6,
     "DDDRDRDRRRDRDRDRDDRDRDRDRDRDRDR"),
    (COMBINED_P, "AAAA", "AAAA", 8, "DRDRDRDR"),
    (COMBINED_P, "AAAAAAAA", "TAAAAAAAA", 14, "DDRDRDRDRDRDRDRDR"),
    (COMBINED_P, "GTTTTTTTT", "TTTTTTTT", 14, "RDRDRDRDRDRDRDRDR"),
    (COMBINED_P, "TTTTACGTACGT", "TTACGTACGT", 16, "DRDRRRDRDRDRDRDRDRDRDR"),
    (COMBINED_P, "TTACGTACGT", "TTTTACGTACGT", 16, "DRDRDDDRDRDRDRDRDRDRDR"),
    (COMBINED_P, "ATGAAGCTGCGAGGC", "TGATGGCTTGCGAGGC", 17,
     "RDRDRDRDRDRDDRDRDDRDRDRDRDRDRDR"),
]


@pytest.mark.parametrize("p,a,b,score,path", CASES)
def test_naive_literals(p, a, b, score, path):
    r = oracle_extend(p, enc(a), enc(b))
    assert r.score == score, (r.score, score, r.path)
    assert r.path == path


def test_empty_on_mismatch():
    p = AFFINE_P
    r = oracle_extend(p, enc("AAAA"), enc("TTTT"))
    assert r.score == 0
    assert r.path == ""


def test_n_never_matches():
    p = AFFINE_P
    r = oracle_extend(p, enc("NNNN"), enc("NNNN"))
    assert r.score == 0


def test_calc_score_matches_traced():
    """calc_score (gaba_dp_calc_score equivalent) recomputes the traced
    score exactly for both affine and combined models."""
    import numpy as np

    from minialign_jax.dp import band
    from minialign_jax.dp.traceback import calc_score, traceback_batch
    from minialign_jax.params import ScoreParams

    for p in (ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -3
                                       for i in range(16)),
                          gi=4, ge=1, xdrop=60),
              ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -4
                                       for i in range(16)),
                          gi=4, ge=2, gfa=3, gfb=3, xdrop=60)):
        rng = np.random.default_rng(7)
        B = 6
        seqs_a, seqs_b = [], []
        for _ in range(B):
            L = int(rng.integers(60, 240))
            a = rng.integers(0, 4, L)
            b = a.copy()
            mut = rng.random(L) < 0.10
            b[mut] = rng.integers(0, 4, int(mut.sum()))
            seqs_a.append(a)
            seqs_b.append(b)
        ab, alen = band.pad_codes(seqs_a)
        bb, blen = band.pad_codes(seqs_b)
        fill = band.make_fill(p, 32, max_blocks=24, trace=True)
        res, bufs = fill(ab, alen, bb, blen)
        res = type(res)(*(np.asarray(x) for x in res))
        bufs = type(bufs)(*(np.asarray(x) for x in bufs))
        trs = traceback_batch(p, 32, bufs, res)
        checked = 0
        for k, tr in enumerate(trs):
            if tr is None or tr.plen == 0:
                continue
            got = calc_score(p, tr.path, np.asarray(seqs_a[k]),
                             np.asarray(seqs_b[k]))
            assert got["score"] == tr.score, k
            assert got["agcnt"] == tr.agcnt and got["bgcnt"] == tr.bgcnt
            checked += 1
        assert checked >= 4
