"""Device-side traceback vs the host walker: identical paths, counts,
penalties and out-of-band statuses on randomized fills (both models)."""

import numpy as np
import pytest

from minialign_jax.dp import band, dtrace, traceback
from minialign_jax.params import ScoreParams


def _expand(rle_col):
    """Backward RLE entries (op | len << 2) -> (path, path_rev) like
    the host walker."""
    ent = np.asarray(rle_col).view(np.uint8).astype(np.int32)
    ops = np.repeat(ent & 3, ent >> 2)
    fwd, rev = [], []
    for o in ops:
        if o == dtrace.OP_D:
            fwd.append("D")
            rev.append("D")
        elif o == dtrace.OP_R:
            fwd.append("R")
            rev.append("R")
        elif o == dtrace.OP_X:
            fwd.append("RD")
            rev.append("DR")
    return "".join(fwd)[::-1], "".join(rev)


@pytest.mark.parametrize("pname", ["affine", "combined"])
def test_device_traceback_matches_host(pname):
    p = {"affine": ScoreParams(
            matrix=tuple(2 if (i & 3) == (i >> 2) else -3
                         for i in range(16)), gi=4, ge=1, xdrop=60),
         "combined": ScoreParams(
            matrix=tuple(2 if (i & 3) == (i >> 2) else -4
                         for i in range(16)), gi=4, ge=2, gfa=3, gfb=3,
            xdrop=60)}[pname]
    W = 32
    rng = np.random.default_rng(23)
    B = 16
    seqs_a, seqs_b = [], []
    for _ in range(B):
        L = int(rng.integers(40, 400))
        a = rng.integers(0, 4, L)
        b = a.copy()
        mut = rng.random(L) < 0.15
        b[mut] = rng.integers(0, 4, int(mut.sum()))
        # a few structural indels
        for _ in range(int(rng.integers(0, 3))):
            pos = int(rng.integers(0, len(b)))
            b = np.concatenate([b[:pos], rng.integers(0, 4, 5), b[pos:]])
        seqs_a.append(a)
        seqs_b.append(b)
    ab, alen = band.pad_codes(seqs_a)
    bb, blen = band.pad_codes(seqs_b)
    fill = band.make_fill(p, W, max_blocks=40, trace=True)
    res, bufs = fill(ab, alen, bb, blen)
    res = type(res)(*(np.asarray(x) for x in res))

    dt = dtrace.make_device_traceback(p, W)
    rle, _head, summary = dt(bufs.masks, bufs.dirs, bufs.iheads,
                      res.max_score, res.max_i, res.max_j)
    rle = np.asarray(rle)
    row = dict(zip(dtrace.SUMMARY_ROWS, np.asarray(summary)))
    n_ops, n_ent, bad = row["n_ops"], row["n_ent"], row["bad"]
    counts = row

    masks = np.asarray(bufs.masks)
    dirs = np.asarray(bufs.dirs)
    iheads = np.asarray(bufs.iheads)
    for k in range(B):
        want = traceback.traceback_one(
            p, W, masks[k], dirs[k], iheads[k],
            int(res.max_score[k]), int(res.max_i[k]),
            int(res.max_j[k]))
        if want is None:
            assert bad[k] == 1, k
            continue
        assert bad[k] == 0, k
        fwd, rev = _expand(rle[:n_ent[k], k])
        assert fwd == want.path, k
        assert rev == want.path_rev, k
        assert int((rle[:n_ent[k], k] >> 2).sum()) == n_ops[k], k
        assert counts["dcnt"][k] == want.dcnt, k
        assert counts["agcnt"][k] == want.agcnt, k
        assert counts["bgcnt"][k] == want.bgcnt, k
        gp = (counts["n_open"][k] * p.gi + counts["n_ext"][k] * p.ge
              + counts["gf_pen"][k])
        assert gp == want.gap_penalty, k
        want_epen = want.score + want.gap_penalty  # not comparable; use
        # identity instead: recompute from e_pen and compare floats
        ident = traceback._identity(p, int(res.max_score[k]),
                                    int(counts["dcnt"][k]),
                                    int(counts["e_pen"][k]))
        assert ident == want.identity, k
