"""Device-side traceback: the per-alignment mask walk as a batched XLA
state machine, so the (large) mask buffers never leave the device —
only RUN-LENGTH op entries and counters transfer to the host.

Semantics are EXACTLY dp/traceback.traceback_one's walk — gaba's
trace_core state machine (gaba.c:3123-3207): horizontal (R) gaps are
tested in the d_head state, vertical (D) gaps only in the d_tail state
(after a diagonal or a v-gap); a gap head takes the one-base gf branch
when the folded bit (gh & ~gfh) | open_next is clear, else an affine
run continuing while NOT (h == 0 and e == 1) at each arrived cell.

Run-length emission (round-2): each while-loop iteration emits ONE
int8 entry `op | count << 2` per live problem instead of one op:

  * boundary drains (i==0 / j==0) emit the remaining run in 63-op
    entries (the int8 length cap; phases 3/4 guard the one-time
    pricing across split entries);
  * diagonal and affine-gap runs are chunked CHAIN probes deep: the
    iteration walks up to CHAIN cells of the run, probing each arrived
    cell's masks, and emits the run prefix as one entry; a still-live
    run resumes via phases 1/2 exactly like the single-step walker.

This cuts both the while-loop trip count (~5x at PBSIM identity) and
the device->host result transfer (the one-op encoding shipped ~1 byte
per DP step). Equality
with the host walker is enforced by tests/test_dtrace.py.

Op codes: 0 pad, 1 'D', 2 'R', 3 diagonal ("DR").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..params import ScoreParams
from .band import BLK, M_E, M_EO, M_F, M_FO, M_GFA, M_GFB

OP_PAD, OP_D, OP_R, OP_X = 0, 1, 2, 3
import os as _os

CHAIN = int(_os.environ.get("MINIALIGN_DTRACE_CHAIN", "24"))
# probe depth per iteration for diag/gap runs: deeper probes trade
# iteration count against wasted trajectory columns (24 is kept until
# the GPU measures otherwise).
# Bounds: the dir window gathers 3 words (96 dir bits), which covers
# a probe only while 2*CHAIN-1 <= 95 with rel <= 2, i.e. CHAIN <= 32
# given BLK=32; CHAIN == 1 would crash on the zero-width cumprod.
CHAIN = min(max(CHAIN, 2), 32)
LEN_CAP = 63              # int8 entry: op | len << 2
# static head-slice rows returned next to the full rle buffer: when
# the walk finished within HEAD_T iterations (the typical case — run
# entries average ~13 ops at PBSIM identity) the harvest reads the
# pre-sliced head and pays no extra device slice dispatch
HEAD_T = int(_os.environ.get("MINIALIGN_DTRACE_HEAD", "4096"))
# rows of the (14, B) summary array returned next to the rle entries
SUMMARY_ROWS = ("n_ops", "n_ent", "bad", "dcnt", "agcnt", "bgcnt",
                "n_open", "n_ext", "gf_pen", "e_pen",
                "score", "ai", "bj", "t_fin")


def make_device_traceback(p: ScoreParams, W: int):
    """Returns jit fn(masks, dirs, iheads, score, ai, bj) ->
    (rle (T, B) int8 backward run entries, summary (10, B) int32 with
    rows SUMMARY_ROWS — op/entry counts, out-of-band status, and the
    walk counters packed into one array so the host pays ONE transfer).
    masks: (B, NB, BLK, 16) uint32 cell codes (dp/band.py
    _pack_codes), dirs: (B, NB) uint32, as produced by the fill;
    T = NB*BLK + 2 entries worst case (every entry carries >= 1
    op)."""
    gi, ge = p.gi, p.ge
    gfa_eff, gfb_eff = p.gfa_eff, p.gfb_eff
    model = p.model

    @jax.jit
    def run(masks, dirs, iheads, score, ai, bj):
        # column 0 = the fill's initial ihead; sliced inside the jit
        # (an eager device slice costs a dispatch round)
        iheads0 = iheads[:, 0]
        B, NB = dirs.shape
        T = NB * BLK + 2

        # the fill emits per-CELL 6-bit plane codes directly
        # (dp/band.py _pack_codes: word r of a step packs lane
        # q = r + 16*f at bits [8f, 8f+6)), so a probe gathers ONE
        # element per visited cell — round 3's first form gathered 6+
        # plane words per probe (~78 us per while iteration, 5+ s per
        # 128-problem batch) and then needed an 805 MB repack pass
        codes = masks.astype(jnp.uint32).reshape(B, NB * BLK * 16)

        def cell_code(pp, q):
            """(B, ...) int32 6-bit plane code at band step pp, lane q
            (clipped; callers gate out-of-range)."""
            qc = jnp.clip(q, 0, W - 1)
            idx = jnp.clip(pp, 0, None) * 16 + (qc & 15)
            w = jnp.take_along_axis(codes, idx, axis=1)
            return ((w >> ((qc >> 4) << 3).astype(jnp.uint32))
                    & 0x3F).astype(jnp.int32)

        def code_bits(c):
            """gaba mask algebra on a packed cell code: hb/vb/eb/fb."""
            m_e = (c >> M_E) & 1
            m_gfb = (c >> M_GFB) & 1
            m_f = (c >> M_F) & 1
            m_gfa = (c >> M_GFA) & 1
            hb = (m_e | m_gfb) == 1
            vb = (m_f | m_gfa) == 1
            eb = ((m_e & (1 - m_gfb)) | ((c >> M_EO) & 1)) == 1
            fb = ((m_f & (1 - m_gfa)) | ((c >> M_FO) & 1)) == 1
            return hb, vb, eb, fb

        # ---- init (mirrors traceback_one's prologue)
        i0 = ai.astype(jnp.int32)
        j0 = bj.astype(jnp.int32)
        empty = (score <= 0) | ((i0 == 0) & (j0 == 0))
        pp0 = i0 + j0 - 2
        # ihead at band p = pp0: iheads0 + number of rights in steps
        # [0, pp0]; count via cumulative popcount over dir words
        full = jnp.cumsum(
            BLK - jax.lax.population_count(dirs).astype(jnp.int32),
            axis=1)                                       # (B, NB)
        blk0 = jnp.clip(pp0, 0, None) // BLK
        infull = jnp.where(blk0 > 0,
                           jnp.take_along_axis(
                               full, jnp.clip(blk0 - 1, 0, None)[:, None],
                               axis=1)[:, 0], 0)
        lastw = jnp.take_along_axis(dirs, blk0[:, None], axis=1)[:, 0]
        rem = jnp.clip(pp0, 0, None) % BLK + 1
        lastmask = jnp.where(rem >= BLK, jnp.uint32(0xFFFFFFFF),
                             (jnp.uint32(1) << rem.astype(jnp.uint32))
                             - 1)
        inlast = rem - jax.lax.population_count(
            lastw & lastmask).astype(jnp.int32)
        ihead_pp0 = iheads0.astype(jnp.int32) + \
            jnp.where(pp0 >= 0, infull + inlast, 0)
        q0 = ihead_pp0 - i0
        bad0 = (~empty) & ((q0 < 0) | (q0 >= W))

        rle0 = jnp.zeros((T, B), jnp.int8)
        counts0 = {k: jnp.zeros(B, jnp.int32) for k in
                   ("dcnt", "agcnt", "bgcnt", "n_open", "n_ext",
                    "gf_pen", "e_pen")}

        # the walk carries the CURRENT cell's 6-bit code in state:
        # every move's landing cell is probed by the iteration that
        # makes the move (trajectory column n_run-1 for chained runs,
        # a dedicated gather column for one-base gf gaps), so the loop
        # body never pays a separate head-probe gather round (~8 us
        # per take_along_axis CALL; this was 1 of 3 dependent rounds)
        ccode0 = cell_code(pp0[:, None], q0[:, None])[:, 0]

        state0 = dict(i=i0, j=j0, pp=pp0, q=q0, ccode=ccode0,
                      phase=jnp.zeros(B, jnp.int32),
                      head=jnp.ones(B, bool),   # gaba starts at d_head
                      done=empty | bad0, bad=bad0,
                      t=jnp.int32(0), rle=rle0, **counts0)

        def cond(st):
            return (~jnp.all(st["done"])) & (st["t"] < T)

        def body(st):
            i, j, pp, q = st["i"], st["j"], st["pp"], st["q"]
            phase = st["phase"]
            head = st["head"]
            done = st["done"]
            bad = st["bad"]
            live = ~done

            # dir bits D[:, o] = direction at band step pp - o, for
            # o in [0, 2*CHAIN): one 3-word gather + local extraction
            # (chain trajectories below need the whole window; the
            # former per-step dir_at gathers were a dependent chain)
            NO = 2 * CHAIN
            base = jnp.clip(pp, 0, None) // BLK               # (B,)
            dw = jnp.take_along_axis(
                dirs, jnp.clip(base[:, None]
                               - jnp.arange(3)[None, :], 0, None),
                axis=1)                                       # (B, 3)
            o_ = jnp.arange(NO, dtype=jnp.int32)[None, :]
            po = pp[:, None] - o_                             # (B, NO)
            rel = base[:, None] - jnp.clip(po, 0, None) // BLK
            wsel = jnp.where(rel == 0, dw[:, 0:1],
                             jnp.where(rel == 1, dw[:, 1:2],
                                       dw[:, 2:3]))
            D = ((wsel >> (jnp.clip(po, 0, None) % BLK).astype(
                jnp.uint32)) & 1).astype(jnp.int32)
            D = jnp.where(po >= 0, D, 0)                      # (B, NO)

            d_pp = D[:, 0]
            d_pp1 = D[:, 1]

            at_i0 = live & (i == 0)
            at_j0 = live & (j == 0) & ~at_i0
            inband = (q >= 0) & (q < W)
            # out-of-band abort only applies in the normal/run phases
            oob = live & ~at_i0 & ~at_j0 & (phase <= 2) & ~inband

            norm = live & ~at_i0 & ~at_j0 & ~oob & (phase == 0)
            in_f = live & ~at_i0 & ~at_j0 & ~oob & (phase == 1)
            in_e = live & ~at_i0 & ~at_j0 & ~oob & (phase == 2)

            # current cell's bits ride in the carry (see ccode0 above)
            hb, vb, eb, fb = code_bits(st["ccode"])


            # dispatch: head tests the h side only; tail tests v first,
            # then falls through to the head dispatch at the same cell
            h_disp = norm & (head | (~head & ~vb))
            v_disp = norm & ~head & vb
            b_hgf = h_disp & hb & ~eb
            b_e = h_disp & hb & eb
            b_dg = h_disp & ~hb
            b_vgf = v_disp & ~fb
            b_f = v_disp & fb

            # boundary entry: price the whole remaining run up front
            # (traceback_one's i==0 / j==0 blocks); phases 3/4 guard
            # re-pricing across length-capped drain entries
            ent_i0 = at_i0 & (phase != 3)
            ent_j0 = at_j0 & (phase != 4)
            if model == 2:
                gfa_win = p.gfa * j < gi + j * ge
                gfb_win = p.gfb * i < gi + i * ge
            else:
                gfa_win = jnp.zeros_like(done)
                gfb_win = jnp.zeros_like(done)

            # ---- chained runs: affine gaps and diagonal streaks walk
            # up to CHAIN cells in this iteration, probing each arrived
            # cell (identical stop rules to the single-step walker).
            # Round-3 form: the positions a run visits depend ONLY on
            # the dir bits (already extracted above), never on the
            # masks — so the whole CHAIN-deep trajectory is computed
            # up front and all its cells are probed with ONE gather,
            # replacing CHAIN-1 dependent gather rounds per iteration.
            run_e = b_e | in_e
            run_f = b_f | in_f
            run_d = b_dg
            chain = run_e | run_f | run_d
            C = CHAIN

            # q after m moves (column m-1), per run type:
            #   e: q + sum_{r<m} D[r]         (pp - m)
            #   f: q - m + sum_{r<m} D[r]     (pp - m)
            #   d: q + sum_{r<m} (D[2r] + D[2r+1] - 1)   (pp - 2m)
            Se = jnp.cumsum(D[:, :C], axis=1)
            Sd = jnp.cumsum(D[:, 0::2][:, :C] + D[:, 1::2][:, :C] - 1,
                            axis=1)
            m1 = jnp.arange(1, C + 1, dtype=jnp.int32)[None, :]
            q_tr = jnp.where(run_e[:, None], q[:, None] + Se,
                             jnp.where(run_f[:, None],
                                       q[:, None] - m1 + Se,
                                       q[:, None] + Sd))   # (B, C)
            pp_tr = pp[:, None] - m1 * jnp.where(run_d[:, None], 2, 1)
            # ONE gather probes the trajectory AND the two candidate
            # one-base gf landing cells (columns C / C+1), so the next
            # iteration's head probe is a carry update, not a gather
            q_gfh = q + d_pp
            q_gfv = q - (1 - d_pp)
            cA = cell_code(
                jnp.concatenate([pp_tr, (pp - 1)[:, None],
                                 (pp - 1)[:, None]], axis=1),
                jnp.concatenate([q_tr, q_gfh[:, None],
                                 q_gfv[:, None]], axis=1))
            cT = cA[:, :C]
            hbt, vbt, ebt, fbt = code_bits(cT)
            okq = (q_tr >= 0) & (q_tr < W)

            # cont after probing position m (loop iteration m):
            # stop rules and budget tests identical to the single-step
            # walker; prefix-AND via cumprod reproduces the sequential
            # early-stop exactly
            stop = jnp.where(run_e[:, None], (~hbt) & ebt,
                             jnp.where(run_f[:, None], (~vbt) & fbt,
                                       vbt | hbt))
            cnt_ok = jnp.where(
                run_e[:, None], i[:, None] - m1 > 0,
                jnp.where(run_f[:, None], j[:, None] - m1 > 0,
                          (i[:, None] - m1 > 0)
                          & (j[:, None] - m1 > 0)))
            keep = okq & (~stop) & cnt_ok                  # (B, C)
            pref = jnp.cumprod(keep[:, :C - 1].astype(jnp.int32),
                               axis=1)                     # (B, C-1)
            n_run = jnp.where(chain,
                              1 + jnp.sum(pref, axis=1), 0)
            contC = chain & (pref[:, C - 2] == 1)

            ik = i - jnp.where(run_e | run_d, n_run, 0)
            jk = j - jnp.where(run_f | run_d, n_run, 0)
            ppk = pp - n_run * jnp.where(run_d, 2, 1)
            # q after n_run moves, via the cumsums already in hand —
            # an arithmetic select instead of another gather round
            SeN = jnp.sum(jnp.where(m1 <= n_run[:, None],
                                    D[:, :C], 0), axis=1)
            SdN = jnp.sum(jnp.where(m1 <= n_run[:, None],
                                    D[:, 0::2][:, :C]
                                    + D[:, 1::2][:, :C] - 1, 0),
                          axis=1)
            qk = jnp.where(run_e, q + SeN,
                           jnp.where(run_f, q - n_run + SeN,
                                     q + SdN))
            qk = jnp.where(chain, qk, q)

            # run continuation into the NEXT iteration: stop iff the
            # ARRIVED cell has (h == 0 and e == 1) for e-runs /
            # (v == 0 and f == 1) for f-runs (gaba's _trace_test_gap).
            # Only reachable when all C moves were made, so the arrived
            # cell is trajectory column C-1.
            e_more = contC & run_e & ~((~hbt[:, C - 1]) & ebt[:, C - 1]) \
                & (ik > 0)
            f_more = contC & run_f & ~((~vbt[:, C - 1]) & fbt[:, C - 1]) \
                & (jk > 0)

            # one-base gf gaps (always exactly one base)
            q_s = jnp.where(b_hgf, q + d_pp, q - (1 - d_pp))
            single = b_hgf | b_vgf

            # ---- boundary drains, length-capped for the int16 entry
            dr_i0 = jnp.minimum(jnp.where(at_i0, j, 0), LEN_CAP)
            dr_j0 = jnp.minimum(jnp.where(at_j0, i, 0), LEN_CAP)

            # ---- entry emission
            op = jnp.where(at_i0 | run_f | b_vgf, OP_D,
                           jnp.where(at_j0 | run_e | b_hgf, OP_R,
                                     jnp.where(run_d, OP_X, OP_PAD)))
            length = jnp.where(at_i0, dr_i0,
                               jnp.where(at_j0, dr_j0,
                                         jnp.where(chain, n_run,
                                                   single.astype(
                                                       jnp.int32))))
            emit = live & (length > 0)
            entry = jnp.where(emit, op | (length << 2), 0).astype(
                jnp.int8)
            rle = jax.lax.dynamic_update_index_in_dim(
                st["rle"], entry, st["t"], axis=0)

            # ---- counters (whole-run amounts per iteration)
            c = {k: st[k] for k in ("dcnt", "agcnt", "bgcnt", "n_open",
                                    "n_ext", "gf_pen", "e_pen")}
            c["dcnt"] += jnp.where(run_d, n_run, 0)
            c["bgcnt"] += jnp.where(ent_i0, j,
                                    jnp.where(run_f, n_run,
                                              b_vgf.astype(jnp.int32)))
            c["agcnt"] += jnp.where(ent_j0, i,
                                    jnp.where(run_e, n_run,
                                              b_hgf.astype(jnp.int32)))
            c["n_open"] += (b_f | b_e
                            | (ent_i0 & ~gfa_win)
                            | (ent_j0 & ~gfb_win)).astype(jnp.int32)
            c["n_ext"] += jnp.where(run_f | run_e, n_run, 0) \
                + jnp.where(ent_i0 & ~gfa_win, j, 0) \
                + jnp.where(ent_j0 & ~gfb_win, i, 0)
            c["gf_pen"] += jnp.where(b_vgf, gfa_eff, 0) \
                + jnp.where(b_hgf, gfb_eff, 0) \
                + jnp.where(ent_i0 & gfa_win, p.gfa * j, 0) \
                + jnp.where(ent_j0 & gfb_win, p.gfb * i, 0)
            c["e_pen"] += jnp.where(b_hgf, gfb_eff, 0) \
                + jnp.where(b_e, gi, 0) \
                + jnp.where(run_e, n_run * ge, 0) \
                + jnp.where(ent_j0 & gfb_win, p.gfb * i, 0) \
                + jnp.where(ent_j0 & ~gfb_win, gi + i * ge, 0)

            # ---- final state per lane
            i_n = jnp.where(chain, ik,
                            jnp.where(b_hgf, i - 1,
                                      jnp.where(at_j0, i - dr_j0, i)))
            j_n = jnp.where(chain, jk,
                            jnp.where(b_vgf, j - 1,
                                      jnp.where(at_i0, j - dr_i0, j)))
            pp_n = jnp.where(chain, ppk,
                             jnp.where(single, pp - 1, pp))
            q_n = jnp.where(chain, qk,
                            jnp.where(single, q_s, q))

            phase_n = jnp.where(f_more, 1,
                                jnp.where(e_more, 2,
                                          jnp.where(at_i0 & (j_n > 0),
                                                    3,
                                                    jnp.where(
                                                        at_j0
                                                        & (i_n > 0),
                                                        4, 0))))
            phase_n = jnp.where(live, phase_n, phase)
            # h-gaps return to d_head; diagonals and v-gaps to d_tail
            head_n = jnp.where(live & (b_hgf | run_e), True,
                               jnp.where(live & (run_d | b_vgf
                                                 | run_f), False,
                                         head))

            # defensive post-move band check (the single-step walker's
            # -1 <= q <= W tolerance; anything further is corruption)
            post_bad = live & ~at_i0 & ~at_j0 & ~oob & \
                ((q_n < -1) | (q_n > W))
            bad_n = bad | oob | post_bad
            done_n = done | oob | post_bad | \
                (live & (i_n == 0) & (j_n == 0))

            i = jnp.where(live, i_n, i)
            j = jnp.where(live, j_n, j)
            pp = jnp.where(live, pp_n, pp)
            q = jnp.where(live, q_n, q)

            # carry the landing cell's code: trajectory column
            # n_run-1 for chained runs (arithmetic select, no gather),
            # the pre-probed gf landing column for one-base gaps;
            # boundary-drain lanes never read theirs
            cN = jnp.sum(jnp.where(m1 == n_run[:, None], cT, 0),
                         axis=1)
            ccode = jnp.where(chain, cN,
                              jnp.where(b_hgf, cA[:, C],
                                        jnp.where(b_vgf, cA[:, C + 1],
                                                  st["ccode"])))
            ccode = jnp.where(live, ccode, st["ccode"])

            return dict(i=i, j=j, pp=pp, q=q, ccode=ccode,
                        phase=phase_n,
                        head=head_n, done=done_n, bad=bad_n,
                        t=st["t"] + 1, rle=rle, **c)

        st = jax.lax.while_loop(cond, body, state0)
        # int8 entries are bit-packed (op | len << 2) and may wrap
        # negative; widen via uint8 to recover the length field
        n_ops = jnp.sum((st["rle"].astype(jnp.uint8)
                         .astype(jnp.int32) >> 2),
                        axis=0).astype(jnp.int32)
        n_ent = jnp.sum(st["rle"] != 0, axis=0).astype(jnp.int32)
        # every scalar-per-problem result rides in ONE summary array:
        # one device->host transfer (rows: SUMMARY_ROWS; the fill's
        # score/max position come along for free)
        summary = jnp.stack(
            [n_ops, n_ent, st["bad"].astype(jnp.int32),
             st["dcnt"], st["agcnt"], st["bgcnt"], st["n_open"],
             st["n_ext"], st["gf_pen"], st["e_pen"],
             score.astype(jnp.int32), ai.astype(jnp.int32),
             bj.astype(jnp.int32),
             jnp.broadcast_to(st["t"], (B,)).astype(jnp.int32)])
        # the static head slice ships alongside: when t_fin fits it,
        # the harvest transfers the (small) head instead of paying an
        # eager data-dependent device slice (a full dispatch round)
        return st["rle"], st["rle"][:min(HEAD_T, T)], summary

    return run
