"""Chaining formulation evidence (SURVEY hard part 4): is the reference's greedy chainer re-derivable as a
sort-by-(rpos-2qpos) + segmented-scan device kernel?

Answer, pinned here: NO, not at byte parity. The reference's
README.md:92-115 pseudocode describes linking to the p-farthest seed
inside a FIXED parallelogram window — an associative formulation a
segmented scan could compute. The implementation (mm_chain_seeds,
minialign.c:3547-3625) is different: every accepted link SHRINKS the
window via the coupled `_update_wv` bounds (uub -= vub - fv.v;
vub -= uub - fv.u, minialign.c:3370-3402), so each link depends on the
coordinates of every previously accepted seed in the chain — a
non-associative serial recurrence. On real PBSIM-profile seed sets the
two formulations produce different chain sets for essentially every
read (60/60 on the 20 kb benchmark workload, round 4), and golden SAM
parity pins the shrinking-window behavior.

Consequence: chaining stays the exact serial recurrence, implemented
in native C++ (native/minialign_native.cpp chain_seeds_c, <2% of the
E2E profile); the device/segmented-scan chainer is not a valid
optimization target for this reference. If this test ever starts
PASSING the equivalence check, that conclusion should be revisited.
"""

import numpy as np
import pytest

from minialign_jax import chain as C
from minialign_jax.index.build import build_index
from minialign_jax.io import bseq
from minialign_jax.params import IndexParams


def _chain_fixed_window(seeds, twlen):
    """README.md:92-115's formulation: link to the largest in-window
    seed with the window FIXED at the current front seed (no
    _update_wv shrinking). Same traversal/merge scaffolding as
    chain.chain_seeds' reference loop."""
    n = len(seeds)
    up, rid, vp = seeds[:, 0], seeds[:, 1], seeds[:, 2]
    lid_of = np.full(n, -1, np.int64)
    out = []
    nlsid = 0
    while nlsid < n:
        lid = len(out)
        lsid = nlsid
        nrsid = nlsid
        nlsid_next = None
        while True:
            rsid = nrsid
            v0 = int(vp[rsid])
            vub = v0 + twlen
            uub = int(up[rsid]) + twlen
            r0 = int(rid[rsid])
            best = None
            sid = rsid + 1
            while sid < n:
                if rid[sid] > r0 or up[sid] > uub:
                    nlsid_next = sid if nlsid_next is None \
                        else min(nlsid_next, sid)
                    break
                if v0 < int(vp[sid]) <= vub:
                    best = sid
                else:
                    nlsid_next = sid if nlsid_next is None \
                        else min(nlsid_next, sid)
                sid += 1
            if sid >= n and nlsid_next is None:
                nlsid_next = n
            if best is None:
                nrsid = rsid
                break
            if lid_of[best] != -1:
                nrsid = best
                break
            lid_of[best] = lid
            nrsid = best
            if nlsid_next is not None and nlsid_next <= nrsid:
                nlsid_next = None
        out.append((lsid, nrsid))
        nlsid = nlsid_next if nlsid_next is not None else n
        while nlsid < n and lid_of[nlsid] != -1:
            nlsid += 1
    return out


def _synthetic_seeds(rng, n, spread):
    """Random seed sets shaped like a real read's: a noisy diagonal
    plus scattered repeats, in rotated (upos, vpos) coordinates,
    sorted by (rid, upos) like seed_round's output."""
    x = np.sort(rng.integers(0, spread, n))
    y = x + rng.integers(-2000, 2000, n)
    up = (2 * x - y + C.OFS).astype(np.int64)
    vp = (2 * y - x + C.OFS).astype(np.int64)
    rid = np.zeros(n, np.int64)
    order = np.lexsort((up, rid))
    return np.stack([up[order], rid[order], vp[order]], axis=1)


def test_fixed_window_formulation_is_not_equivalent():
    """On seed sets dense enough that windows overlap (any real long
    read; 60/60 of the 20 kb PBSIM benchmark reads diverge), the fixed
    window and the reference's shrinking window produce different
    chain sets. On the sparse golden set they happen to agree — this
    synthetic case reproduces the dense regime deterministically."""
    rng = np.random.default_rng(7)
    twlen = 7000
    n_diff = 0
    for trial in range(8):
        seeds = _synthetic_seeds(rng, 400, 20000)
        ref = sorted((c.leaf_sid, c.root_sid)
                     for c in C.chain_seeds(seeds, twlen))
        alt = sorted(_chain_fixed_window(seeds, twlen))
        if ref != alt:
            n_diff += 1
    assert n_diff > 0, (
        "fixed-window chaining suddenly matches the reference "
        "recurrence — revisit the device/segmented-scan chainer")


def test_golden_reads_still_checked():
    """Sanity: the two formulations at least RUN identically-shaped on
    the golden set (where sparsity makes them agree), so the synthetic
    divergence above is about window coupling, not harness bugs."""
    import os
    data = os.path.join(os.path.dirname(__file__), "data")
    refs = list(bseq.read_seqs(os.path.join(data, "tref.fa")))
    mi = build_index(IndexParams(), [r.name for r in refs],
                     [np.asarray(r.codes, np.int8) & 3 for r in refs])
    n_checked = 0
    for rec in bseq.read_seqs(os.path.join(data, "treads.fq")):
        q = np.asarray(rec.codes, np.int8) & 3
        st = C.collect_seeds(mi, q)
        seeds = C.seed_round(mi, st, 0)
        if seeds is None:
            continue
        ref = sorted((c.leaf_sid, c.root_sid)
                     for c in C.chain_seeds(seeds, 7000, mi.lens,
                                            mi.circular))
        alt = sorted(_chain_fixed_window(seeds, 7000))
        assert ref == alt
        n_checked += 1
    assert n_checked >= 3
