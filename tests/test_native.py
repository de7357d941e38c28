"""Native (C++) host runtime vs the pure-Python fallbacks: identical
results required for traceback, CIGAR RLE, MD walk, and FASTA/FASTQ
parsing. The native library is built on demand (native/Makefile)."""

import importlib
import os

import numpy as np
import pytest

from minialign_jax import native


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def _fallback(module, fn, *args, **kw):
    """Run a function with the native library disabled."""
    old = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        return fn(*args, **kw)
    finally:
        native._lib, native._tried = old


def test_cigar_and_parse_rv_parity():
    from minialign_jax.io import sam
    rng = np.random.default_rng(5)
    for it in range(60):
        n = int(rng.integers(1, 400))
        toks = ["D", "R", "DR"]
        if it % 5 == 4:                       # exercise >64 gap runs
            toks += ["R" * int(rng.integers(60, 200)),
                     "D" * int(rng.integers(60, 200))]
        path = "".join(rng.choice(toks, n))
        got_ops = sam.cigar_ops(path)
        want_ops = _fallback(sam, sam.cigar_ops, path)
        assert got_ops == want_ops, path
        L = len(path)
        for off in (0, L // 3):
            plen = L - off if off == 0 else L - off - L // 4
            if plen <= 0:
                continue
            got = sam.parse_path_rv(path, off, plen)
            want = _fallback(sam, sam.parse_path_rv, path, off, plen)
            assert got == want, (path, off, plen)
            assert sum(c * (2 if op == "M" else 1)
                       for c, op in got) == plen


def test_fastx_parse_parity(tmp_path):
    from minialign_jax.io import bseq
    fa = tmp_path / "x.fa"
    fa.write_bytes(b">one comment  here \nACGTN\nacgt\n\n"
                   b">two\t tabbed comment\nGG  GG\n>three\nA\n")
    fq = tmp_path / "x.fq"
    fq.write_bytes(b"@r1 c1\nACGT\nNNNN\n+\nIIII\nJJJJ\n"
                   b"@r2\nGG\n+ r2\nI@\n@r3  sp\nTTT\n+\nABC\n")
    for path in (str(fa), str(fq)):
        for kw in ({}, {"keep_qual": True}, {"min_len": 3},
                   {"tags": ("CO",)}):
            got = list(bseq.read_seqs(path, **kw))
            want = _fallback(bseq, lambda: list(
                bseq.read_seqs(path, **kw)))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.name == w.name
                assert g.comment == w.comment
                assert g.qual == w.qual
                assert g.tags == w.tags
                np.testing.assert_array_equal(g.codes, w.codes)


def test_traceback_parity():
    """Random fills through the XLA band, traced with and without the
    native walker — full TraceResult equality."""
    from minialign_jax.dp import band, traceback
    from minialign_jax.params import ScoreParams

    p = ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -4
                                 for i in range(16)),
                    gi=4, ge=2, gfa=3, gfb=3, xdrop=60)
    rng = np.random.default_rng(11)
    B, W = 8, 32
    seqs_a, seqs_b = [], []
    for _ in range(B):
        L = int(rng.integers(50, 300))
        a = rng.integers(0, 4, L)
        b = a.copy()
        mut = rng.random(L) < 0.12
        b[mut] = rng.integers(0, 4, int(mut.sum()))
        seqs_a.append(a)
        seqs_b.append(b)
    ab, alen = band.pad_codes(seqs_a)
    bb, blen = band.pad_codes(seqs_b)
    fill = band.make_fill(p, W, max_blocks=32, trace=True)
    res, bufs = fill(ab, alen, bb, blen)
    res = type(res)(*(np.asarray(x) for x in res))
    masks = np.asarray(bufs.masks)
    dirs = np.asarray(bufs.dirs)
    iheads = np.asarray(bufs.iheads)

    for k in range(B):
        got = traceback.traceback_one(
            p, W, masks[k], dirs[k], iheads[k],
            int(res.max_score[k]), int(res.max_i[k]),
            int(res.max_j[k]))
        want = _fallback(traceback, traceback.traceback_one,
                         p, W, masks[k], dirs[k], iheads[k],
                         int(res.max_score[k]), int(res.max_i[k]),
                         int(res.max_j[k]))
        assert (got is None) == (want is None)
        if got is None:
            continue
        assert got == want, f"problem {k}"


def test_sketch_parity():
    from minialign_jax.index import sketch as sk
    rng = np.random.default_rng(9)
    for trial in range(20):
        L = int(rng.integers(1, 800))
        k = int(rng.choice([5, 11, 15, 19]))
        w = int(rng.choice([1, 2, 5, 10, 16]))
        codes = rng.integers(0, 4, L).astype(np.int64)
        got = sk.sketch(codes, k, w)
        want = _fallback(sk, sk.sketch, codes, k, w)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_), (trial, L, k, w)


def test_chain_parity():
    from minialign_jax import chain as ch
    rng = np.random.default_rng(41)
    for trial in range(25):
        n = int(rng.integers(2, 300))
        n_rid = int(rng.integers(1, 4))
        rid = np.sort(rng.integers(0, n_rid, n))
        up = np.empty(n, np.int64)
        for r in range(n_rid):
            m = rid == r
            up[m] = np.sort(rng.integers(0, 4000, int(m.sum()))) + ch.OFS
        vp = rng.integers(0, 4000, n) + ch.OFS
        order = np.lexsort((np.arange(n), up, rid))
        seeds = np.stack([up[order], rid[order],
                          vp[order]], axis=1).astype(np.int64)
        lens = rng.integers(2000, 6000, n_rid).astype(np.int64)
        circ = rng.integers(0, 2, n_rid).astype(np.uint8)
        twlen = int(rng.choice([50, 300, 1000]))
        got = ch.chain_seeds(seeds, twlen, lens=lens, circular=circ)
        want = _fallback(ch, ch.chain_seeds, seeds, twlen,
                         lens=lens, circular=circ)
        assert [(c.plen, c.root_sid, c.leaf_sid) for c in got] == \
            [(c.plen, c.root_sid, c.leaf_sid) for c in want], trial


def test_rle_paths_parity():
    """native.rle_paths vs the numpy LUT builder (extend.rle_paths_py)
    on randomized bit-packed (op | len << 2) entries, including the
    int8-negative wrap for len >= 32 and the empty walk."""
    from minialign_jax import extend
    rng = np.random.default_rng(11)
    cases = [np.zeros(0, np.uint8)]
    for _ in range(40):
        n = int(rng.integers(1, 600))
        ops = rng.integers(1, 4, n)
        lens = rng.integers(1, 64, n)
        cases.append((ops | (lens << 2)).astype(np.uint8))
    for ent in cases:
        got = native.rle_paths(ent)
        assert got is not None
        want = extend.rle_paths_py(ent)
        assert got == want


def test_collect_seeds_parity():
    """native.collect_seeds (fused sketch+lookup+expand) vs the numpy
    round-0 path in chain.collect_seeds, on a randomized reference
    with planted repeats (to exercise the rescue tier) and reads from
    both strands."""
    from minialign_jax import chain
    from minialign_jax.index.build import IndexParams, build_index

    rng = np.random.default_rng(7)
    rep = rng.integers(0, 4, 400).astype(np.int8)
    g = np.concatenate([rng.integers(0, 4, 8000).astype(np.int8)]
                       + [rep] * 12)
    g2 = rng.integers(0, 4, 3000).astype(np.int8)
    mi = build_index(IndexParams(k=15, w=10), ["s1", "s2"], [g, g2])

    comp = np.array([3, 2, 1, 0], np.int8)
    for it in range(12):
        ln = int(rng.integers(200, 3000))
        st = int(rng.integers(0, len(g) - ln))
        q = g[st:st + ln].copy()
        mut = rng.random(ln) < 0.10
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        if it % 2:
            q = comp[q[::-1]]
        got = native.collect_seeds(mi, q)
        assert got is not None, "native path unavailable"
        want = _fallback(chain, chain.collect_seeds, mi, q)
        np.testing.assert_array_equal(got[0], want.upos)
        np.testing.assert_array_equal(got[1], want.vpos)
        np.testing.assert_array_equal(got[2], want.rid)
        np.testing.assert_array_equal(got[3], want.resc)
