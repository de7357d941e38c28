"""Batched adaptive-banded semi-global DP (the GABA-equivalent engine).

Design notes
------------
The reference engine (gaba.c:735-2103) is an anti-diagonal band of width
W in SIMD registers with int8 difference recurrences, advancing one
right/down step at a time, 32 steps per block. Here the same band
geometry is computed batched across B problems at once: every array is
(B, W), one lax.scan step advances all B bands by one anti-diagonal, and
a lax.while_loop advances 32-step blocks until every problem terminates.
Sequence characters are gathered per block (a 32-char lookahead slab per
side), so the inner loop is pure vector arithmetic. This XLA fill is the
reference and the CPU fill; GPUs run the hand-written kernel of
native/band_fill_kernel.cuh (dp/cuda_fill.py), bit-identical to it.

Semantics (validated against dp/oracle.py, which mirrors the reference's
unittest_naive, gaba.c:4638-4778):
  * semi-global alignment anchored at the origin; scores calibrated so
    the empty alignment scores 0 at the origin.
  * band of width W; adaptive movement: go down iff S[W-1] > S[0]
    (derived from the reference's accumulator rule, gaba.c:752-781:
    acc telescopes to S[lane0] - S[laneW-1] plus a constant that is
    zero for the symmetric init ramp).
  * virtual init ramp on out-of-matrix lanes, decaying like
    gaba_init_middle_delta (gaba.c:3684-3694), so ramp-in directions
    alternate; true first-row/col boundary values override in-matrix
    boundary lanes (naive-oracle semantics).
  * max tracking: strict-greater updates per step, first lane on ties
    (= min i+j, then min query-consumed, matching unittest_naive's
    max update at gaba.c:4702-4707).
  * X-drop: gaba's saturating center-lane drop accumulator
    (gaba.c:1650/1738, init -128 at gaba.c:3780-3788, tx = xdrop - 128
    at gaba.c:3823): terminate when the center lane falls more than
    xdrop below its rolling peak, tested once per 32-step block.
  * traceback mask bits stored per step per lane (6 masks: gfa-step,
    F-gap, gfb-step, E-gap, F-open, E-open), bit-packed to uint32;
    consumed by dp/traceback.py which reproduces the naive traceback
    priority (query-gap > ref-gap > diagonal, gaps left-aligned).

Band geometry: lane q of the band at anti-diagonal step p holds cell
(i, j) = (ihead - q, (p + 2) - ihead + q) of the (1-based) DP matrix;
i + j == p + 2. A right move increments ihead (new ref char enters at
lane 0); a down move keeps it (new query char enters at lane W-1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..params import ScoreParams

BLK = 32           # steps per block, matches gaba's BLK (gaba.c:177)
NCODE = 4          # N sentinel code
TAIL_N = 96        # N-tail length per side (minialign.c:4516)


class FillResult(NamedTuple):
    max_score: jax.Array   # (B,) int32, >= 0 (0 == empty)
    max_i: jax.Array       # (B,) int32: ref bases consumed at the max
    max_j: jax.Array       # (B,) int32: query bases consumed at the max
    n_steps: jax.Array     # (B,) int32: #anti-diagonal steps filled
    n_blocks: jax.Array    # () int32: #blocks filled (batch-wide)


class TraceBuffers(NamedTuple):
    masks: jax.Array       # (B, NB, BLK, 16) uint32 packed cell codes
                           # (word r bits [8f, 8f+6) = lane r+16f's
                           # 6-bit plane code; see _pack_codes)
    dirs: jax.Array        # (B, NB) uint32: per-block direction bits
                           # (bit s of block k = step k*32+s; 1 = down)
    iheads: jax.Array      # (B, NB) int32: ihead at each block start
    rprevs: jax.Array      # (B, NB) int32: rprev flag at block start


# mask indices
M_GFA, M_F, M_GFB, M_E, M_FO, M_EO = range(6)


def score_floor(p: ScoreParams) -> int:
    """The naive oracle's score floor (gaba.c:4668)."""
    return int(np.iinfo(np.int16).min - p.min_match - 2 * p.gi)


def _gap_ladder(p: ScoreParams, n: np.ndarray, side: str) -> np.ndarray:
    g = p.gap_a(n) if side == "a" else p.gap_b(n)
    return np.asarray(g, np.int64)


def _init_band(p: ScoreParams, W: int, B: int, a, b):
    """Initial band state at p = -1 (see module docstring)."""
    c = W // 2
    floor = score_floor(p)

    # virtual lanes are floor; ramp-in direction balance is handled by
    # forced alternation in _step instead of an init ramp.
    S1 = np.full(W, floor, np.int32)
    S1[c - 1] = max(int(_gap_ladder(p, np.int64(1), "b")), floor)  # (1,0)
    S1[c] = max(int(_gap_ladder(p, np.int64(1), "a")), floor)      # (0,1)
    E1 = np.full(W, floor, np.int32)
    E1[c - 1] = S1[c - 1]
    F1 = np.full(W, floor, np.int32)
    F1[c] = S1[c]
    S2 = np.full(W, floor, np.int32)
    S2[c] = 0                                                      # (0,0)

    bcast = lambda v: jnp.broadcast_to(jnp.asarray(v)[None, :], (B, W))

    # chars: achar[q] = a[c-1-q] (i-1 for i = c-q), bchar[q] = b[q-c]
    ai = np.arange(W)[::-1] - (W - c)      # = c - 1 - q
    bj = np.arange(W) - c
    LA, LB = a.shape[1], b.shape[1]
    achar = jnp.where(
        jnp.asarray((ai >= 0) & (ai < LA))[None, :],
        jnp.take(a, jnp.asarray(np.clip(ai, 0, LA - 1)), axis=1),
        NCODE).astype(jnp.int8)
    bchar = jnp.where(
        jnp.asarray((bj >= 0) & (bj < LB))[None, :],
        jnp.take(b, jnp.asarray(np.clip(bj, 0, LB - 1)), axis=1),
        NCODE).astype(jnp.int8)

    return dict(
        S=bcast(S1), Sp=bcast(S2), E=bcast(E1), F=bcast(F1),
        achar=achar, bchar=bchar,
        ihead=jnp.full((B,), c, jnp.int32),      # ihead at p=-1
        rprev=jnp.zeros((B,), jnp.int32),        # move into p=-1 was D
        p=jnp.int32(-1),
        gmax=jnp.zeros((B,), jnp.int32),
        gi_=jnp.zeros((B,), jnp.int32),
        gj_=jnp.zeros((B,), jnp.int32),
        term=jnp.zeros((B,), jnp.bool_),
        nsteps=jnp.zeros((B,), jnp.int32),
        # gaba's x-drop accumulator (gaba.c:1650/1738/3780-3788):
        # int8-saturating fall-from-rolling-peak of the center lane,
        # initialized at the saturation floor -128; termination tests
        # cdrop > xdrop - 128 at block ends
        cdrop=jnp.full((B,), -128, jnp.int32),
    )


def _pack_codes(masks) -> jax.Array:
    """6 x (B, W<=64) bool -> (B, 16) uint32 per-CELL code pack.

    Word r carries the 6-bit plane codes of lanes q = r + 16*f at
    bits [8*f, 8*f+6), f = 0..W//16-1 (one int8 field per lane). This
    is the ONE canonical trace-buffer layout: the device walker
    gathers a single element per probed cell (dp/dtrace.py cell_code)
    instead of 6+ plane words, and the fill kernels pack it with a
    handful of shifted selects instead of a 32-way bit reduction."""
    B, W = masks[0].shape
    code = None
    for mi, m in enumerate(masks):
        t = jnp.where(m, jnp.uint32(1 << mi), jnp.uint32(0))
        code = t if code is None else (code | t)
    if W < 16:
        code = jnp.pad(code, ((0, 0), (0, 16 - W)))
        W = 16
    out = code[:, 0:16]
    for f in range(1, W // 16):
        out = out | (code[:, 16 * f:16 * (f + 1)] << jnp.uint32(8 * f))
    return out


def _step(p: ScoreParams, W: int, st, anext, bnext, store_masks: bool):
    """Advance all bands by one anti-diagonal.

    anext/bnext: (B,) int8 — next chars (a[ihead] and b[jhead + W - 1]),
    already gathered/clamped by the caller.
    """
    floor = score_floor(p)
    gi, ge = p.gi, p.ge
    gfa, gfb = p.gfa_eff, p.gfb_eff
    sub55 = jnp.asarray(p.matrix55(), jnp.int32)

    S, Sp, E, F = st["S"], st["Sp"], st["E"], st["F"]
    achar, bchar = st["achar"], st["bchar"]
    ihead, rprev, pp = st["ihead"], st["rprev"], st["p"]
    B = S.shape[0]

    # direction: down iff S[W-1] > S[0]. While either band edge is still
    # outside the matrix (ramp-in), alternate R/D to keep the band
    # centered — the role gaba's symmetric init ramp plays
    # (gaba.c:3684-3694 keeps the accumulator near zero during ramp-in).
    edge_ok = (ihead - (W - 1) >= 0) & ((pp + 2) - ihead >= 0)
    down = jnp.where(edge_ok, S[:, W - 1] > S[:, 0], ((pp + 1) & 1) == 1)
    d = down[:, None]

    def roll_q(x, delta, fill):
        """out[q] = x[q + delta] with `fill` rolled in (delta = +-1)."""
        if delta == 1:
            return jnp.concatenate(
                [x[:, 1:], jnp.full((B, 1), fill, x.dtype)], axis=1)
        return jnp.concatenate(
            [jnp.full((B, 1), fill, x.dtype), x[:, :-1]], axis=1)

    # E source (i-1, j): lane q on right, q+1 on down
    SsrcE = jnp.where(d, roll_q(S, 1, floor), S)
    EsrcE = jnp.where(d, roll_q(E, 1, floor), E)
    # F source (i, j-1): lane q-1 on right, q on down
    SsrcF = jnp.where(d, S, roll_q(S, -1, floor))
    FsrcF = jnp.where(d, F, roll_q(F, -1, floor))

    E_new = jnp.maximum(SsrcE - gi, EsrcE) - ge
    F_new = jnp.maximum(SsrcF - gi, FsrcF) - ge

    # diag source from band p-2: lane shift = (down?1:0) - rprev
    sh = down.astype(jnp.int32) - rprev      # (B,) in {-1, 0, 1}
    Sdiag = jnp.where((sh == 1)[:, None], roll_q(Sp, 1, floor),
                      jnp.where((sh == -1)[:, None], roll_q(Sp, -1, floor),
                                Sp))

    achar_new = jnp.where(d, achar, jnp.concatenate(
        [anext[:, None].astype(jnp.int8), achar[:, :-1]], axis=1))
    bchar_new = jnp.where(d, jnp.concatenate(
        [bchar[:, 1:], bnext[:, None].astype(jnp.int8)], axis=1), bchar)

    subsc = sub55[bchar_new.astype(jnp.int32), achar_new.astype(jnp.int32)]

    S_new = jnp.maximum(
        Sdiag + subsc,
        jnp.maximum(jnp.maximum(E_new, SsrcE - gfb),
                    jnp.maximum(F_new, SsrcF - gfa)))
    S_new = jnp.maximum(S_new, floor)

    # traceback masks (boundary lanes are handled positionally on host).
    # Slots 0-3 mirror gaba's mask_gfv/gv/gfh/gh (S-source equalities,
    # gaba.c:1617-1620); slots 4-5 mirror the open components of
    # f.all/e.all (gaba.c:1625/1631: te = max(de, t), bit = te == t,
    # i.e. the NEXT cell's E/F opens from this cell's S; ties open)
    if store_masks:
        masks = _pack_codes([
            S_new == SsrcF - gfa,
            S_new == F_new,
            S_new == SsrcE - gfb,
            S_new == E_new,
            S_new - gi >= F_new,
            S_new - gi >= E_new,
        ])                                    # (B, 16) cell codes
    else:
        masks = None

    # geometry of the new band
    ihead_new = ihead + (~down).astype(jnp.int32)
    p_new = pp + 1
    q = jnp.arange(W, dtype=jnp.int32)
    i_lane = ihead_new[:, None] - q[None, :]          # (B, W)
    j_lane = (p_new + 2) - i_lane

    # true boundary overrides (first row/col of the DP matrix)
    if p.model == 2:
        gap_a_j = jnp.maximum(-gi * (j_lane > 0) - ge * j_lane,
                              -p.gfa * j_lane)
        gap_b_i = jnp.maximum(-gi * (i_lane > 0) - ge * i_lane,
                              -p.gfb * i_lane)
    else:
        gap_a_j = -gi * (j_lane > 0) - ge * j_lane
        gap_b_i = -gi * (i_lane > 0) - ge * i_lane
    gap_a_j = jnp.maximum(gap_a_j, floor).astype(jnp.int32)
    gap_b_i = jnp.maximum(gap_b_i, floor).astype(jnp.int32)

    on_i0 = (i_lane == 0) & (j_lane >= 0)
    on_j0 = (j_lane == 0) & (i_lane >= 0)
    invalid = (i_lane < 0) | (j_lane < 0)

    S_new = jnp.where(on_i0, gap_a_j, S_new)
    S_new = jnp.where(on_j0, gap_b_i, S_new)
    S_new = jnp.where(invalid, floor, S_new)
    E_new = jnp.where(on_j0, gap_b_i, E_new)
    E_new = jnp.where(on_i0 | invalid, floor, E_new)
    F_new = jnp.where(on_i0, gap_a_j, F_new)
    F_new = jnp.where(on_j0 | invalid, floor, F_new)

    # max tracking: interior cells only, strict greater, first lane on
    # ties (q ascends with j, so first = min j, matching the oracle)
    cand = jnp.where(on_i0 | on_j0 | invalid, floor, S_new)
    step_max = jnp.max(cand, axis=1)
    step_arg = jnp.argmax(cand, axis=1).astype(jnp.int32)
    upd = (step_max > st["gmax"]) & ~st["term"]
    gmax = jnp.where(upd, step_max, st["gmax"])
    gi_ = jnp.where(upd, ihead_new - step_arg, st["gi_"])
    gj_ = jnp.where(upd, (p_new + 2) - (ihead_new - step_arg), st["gj_"])

    # x-drop accumulator: saturating (int8) negative sum of the center
    # lane's per-step deltas (gaba's `drop = _subs_n(drop, _t)`,
    # gaba.c:1650); clamps at -128 while rising, so it measures the
    # center lane's fall from its rolling peak
    cW = S.shape[1] // 2
    cdrop = jnp.clip(st["cdrop"] - (S_new[:, cW] - S[:, cW]), -128, 127)

    st_new = dict(
        S=S_new, Sp=S, E=E_new, F=F_new,
        achar=achar_new, bchar=bchar_new,
        ihead=ihead_new, rprev=(~down).astype(jnp.int32), p=p_new,
        gmax=gmax, gi_=gi_, gj_=gj_,
        term=st["term"],
        nsteps=st["nsteps"] + (~st["term"]).astype(jnp.int32),
        cdrop=cdrop,
    )
    return st_new, down, masks


def make_fill(p: ScoreParams, W: int, max_blocks: int, trace: bool):
    """Build a jitted batched fill function.

    Returns fn(a, alen, b, blen): a is (B, LA) int8 codes padded with N
    (code 4); alen is (B,) int32 true lengths. The pad must include at
    least TAIL_N + W N columns (mirroring the reference's 96-byte tail
    sections). When trace=True the function returns (FillResult,
    TraceBuffers), else FillResult.
    """
    p.check()
    c = W // 2

    def fill(a, alen, b, blen):
        B, LA = a.shape
        LB = b.shape[1]
        st = _init_band(p, W, B, a, b)
        plim = jnp.minimum(alen + blen + 2 * TAIL_N,
                           jnp.int32(max_blocks * BLK - 2))

        if trace:
            bufs = TraceBuffers(
                masks=jnp.zeros((B, max_blocks, BLK, 16), jnp.uint32),
                dirs=jnp.zeros((B, max_blocks), jnp.uint32),
                iheads=jnp.zeros((B, max_blocks), jnp.int32),
                rprevs=jnp.zeros((B, max_blocks), jnp.int32),
            )
        else:
            bufs = ()

        def block_body(carry):
            st, bufs, blk = carry
            ihead0 = st["ihead"]
            jhead0 = (st["p"] + 2) - st["ihead"] + (W - 1)
            ar = ihead0[:, None] + jnp.arange(BLK)[None, :]
            aslab = jnp.where(ar < LA,
                              jnp.take_along_axis(
                                  a, jnp.clip(ar, 0, LA - 1), axis=1),
                              NCODE)
            br = jhead0[:, None] + jnp.arange(BLK)[None, :]
            bslab = jnp.where((br >= 0) & (br < LB),
                              jnp.take_along_axis(
                                  b, jnp.clip(br, 0, LB - 1), axis=1),
                              NCODE)

            if trace:
                bufs = bufs._replace(
                    iheads=bufs.iheads.at[:, blk].set(st["ihead"]),
                    rprevs=bufs.rprevs.at[:, blk].set(st["rprev"]))

            def scan_step(st, _):
                na = jnp.take_along_axis(
                    aslab, (st["ihead"] - ihead0)[:, None], axis=1)[:, 0]
                nb = jnp.take_along_axis(
                    bslab, ((st["p"] + 2) - st["ihead"] + (W - 1)
                            - jhead0)[:, None], axis=1)[:, 0]
                st, down, masks = _step(p, W, st, na, nb, trace)
                return st, ((down, masks) if trace else (down,))

            st, outs = jax.lax.scan(scan_step, st, None, length=BLK)
            if trace:
                downs, masks = outs             # (BLK,B), (BLK,B,16)
                dirbits = jnp.sum(
                    downs.astype(jnp.uint32).T
                    * (jnp.uint32(1)
                       << jnp.arange(BLK, dtype=jnp.uint32))[None, :],
                    axis=1, dtype=jnp.uint32)
                bufs = bufs._replace(
                    masks=jax.lax.dynamic_update_slice(
                        bufs.masks, masks.transpose(1, 0, 2)[:, None],
                        (0, blk, 0, 0)),
                    dirs=bufs.dirs.at[:, blk].set(dirbits))

            # X-drop test at block end (gaba.c:1738: TERM when the
            # center-lane drop accumulator exceeds tx = xdrop - 128)
            # + p-limit
            xdrop_hit = st["cdrop"] > (p.xdrop - 128)
            st["term"] = st["term"] | xdrop_hit | (st["p"] >= plim)
            return (st, bufs, blk + 1)

        def block_cond(carry):
            st, _, blk = carry
            return (~jnp.all(st["term"])) & (blk < max_blocks)

        st, bufs, nblk = jax.lax.while_loop(
            block_cond, block_body, (st, bufs, jnp.int32(0)))

        res = FillResult(max_score=st["gmax"], max_i=st["gi_"],
                         max_j=st["gj_"], n_steps=st["nsteps"],
                         n_blocks=nblk)
        return (res, bufs) if trace else res

    return jax.jit(fill)


def max_blocks_for(la: int, lb: int) -> int:
    """Block capacity of a fill over windows of la / lb characters:
    the p-limit alen + blen + 2 * TAIL_N, plus slack."""
    return (la + lb + 2 * TAIL_N) // BLK + 2


# store rows are quantized to this grid: every jit that takes a store
# specializes on its shape, and an exact-length store gave each fresh
# read batch a novel shape and a full recompile
STORE_QUANTUM = 1 << 20


def pad_store(flat: np.ndarray) -> np.ndarray:
    """1D int8 code stream -> NCODE-padded copy whose length is a
    multiple of STORE_QUANTUM (at least one pad byte)."""
    n = len(flat)
    out = np.full(-(-(n + 1) // STORE_QUANTUM) * STORE_QUANTUM, NCODE,
                  np.int8)
    out[:n] = flat
    return out


def gather_windows(flat, base, start, cap, seglen, wrap, L: int):
    """XLA gather of per-problem windows from a flat store: row k is
    flat[base_k + (start_k + c)] for c < cap_k, taken mod wrap_k when
    wrap_k > 0 (circular references), NCODE past the window or past the
    segment's seglen_k characters. Returns (B, L) int8."""
    col = jnp.arange(L, dtype=jnp.int32)
    idx = start[:, None] + col[None, :]
    idxw = jnp.where(wrap[:, None] > 0,
                     idx % jnp.maximum(wrap[:, None], 1), idx)
    safe = jnp.clip(idxw, 0, jnp.maximum(seglen - 1, 0)[:, None])
    vals = jnp.take(flat, base[:, None] + safe, mode="clip")
    ok = (col[None, :] < cap[:, None]) & \
        ((wrap[:, None] > 0) | (idx < seglen[:, None]))
    return jnp.where(ok, vals, jnp.int8(NCODE)).astype(jnp.int8)


def make_store_fill(p: ScoreParams, W: int, la: int, lb: int, trace: bool):
    """make_fill behind the store contract the GPU kernel implements:
    fn(sa, offa, lna, sb, offb, lnb), where problem k's characters are
    sa[offa_k : offa_k + lna_k] (N beyond) and at most la / lb long.
    The windows are gathered into (B, la) / (B, lb) rows first."""
    fill = make_fill(p, W, max_blocks=max_blocks_for(la, lb), trace=trace)

    def rows(s, off, ln, L):
        off = jnp.asarray(off, jnp.int32)
        ln = jnp.asarray(ln, jnp.int32)
        z = jnp.zeros_like(ln)
        return gather_windows(s, z, off, ln, jnp.full_like(ln, s.shape[0]),
                              z, L)

    def f(sa, offa, lna, sb, offb, lnb):
        return fill(rows(sa, offa, lna, la), jnp.asarray(lna, jnp.int32),
                    rows(sb, offb, lnb, lb), jnp.asarray(lnb, jnp.int32))

    return f


def pad_codes(seqs, pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Pack a list of code arrays into an N-padded (B, L) int8 batch."""
    lens = np.asarray([len(s) for s in seqs], np.int32)
    L = int(max(lens, default=0)) + TAIL_N + 128
    if pad_to is not None:
        L = max(L, pad_to)
    L = -(-L // 128) * 128
    out = np.full((len(seqs), L), NCODE, np.int8)
    for k, s in enumerate(seqs):
        out[k, :len(s)] = s
    return out, lens
