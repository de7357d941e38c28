"""Batched extension driver.

The reference extends one chain at a time per thread (mm_extend,
minialign.c:4118-4173): downward fill from a seed, max search, dedup
test, upward fill from the max, traceback, record, then rescue-seed
retries. The control flow is inherently sequential per read, so the
design batches ACROSS reads: each read runs as a generator that
yields extension requests; the scheduler gathers requests from all
active reads, executes them as one padded device batch per shape
bucket, and feeds results back. Device utilization scales with the
number of in-flight reads, not with per-read parallelism.

Semantic notes (all mirrored from the reference):
  * trial budgets crem=50000 per run / srem=8 per chain
    (MM_CREM/MM_SREM, minialign.c:3777-3778).
  * band narrowing on duplicate collisions: W 64 -> 32 -> 16
    (minialign.c:4122-4126, st.narrow).
  * the dedup hash stores extension end/head/tail positions keyed by
    _key(pos, ids) (minialign.c:3362, 3953-3994). The reference's
    test_dup reads the just-overwritten hash slot when deciding
    chain-termination (minialign.c:3985 consults t after *t = ...), so
    the "contained in previous result" early-exit never fires; the
    observable behavior (narrow bump only) is replicated.
  * record() accumulates the res score as aln score plus a query-
    coverage bonus 2*ovl*identity (minialign.c:4041-4046), with the
    release-build bin-init semantics (lb=0; see Bin docstring).
  * the upward-extension min-score test uses the global min_score
    (minialign.c:4149); the ratcheted st.min_score is written but
    never read in the reference — not carried here.
"""

from __future__ import annotations

import dataclasses
import os as _os

import numpy as np

from .chain import _u, _v, chain_seeds, collect_seeds, coords_to_xy, seed_round
from .dp import band
from .dp.traceback import traceback_one
from .index.build import MMIndex
from .params import MapParams, ScoreParams

MM_CREM = 50000
MM_SREM = 8


def _key(x: int, y: int) -> int:
    """_key position-hash fold (minialign.c:3362)."""
    x &= (1 << 64) - 1
    y &= (1 << 64) - 1
    swap = ((y & 0xFFFFFFFF) << 32) | (y >> 32)
    return (x ^ (x >> 29) ^ y ^ swap) & ((1 << 64) - 1)


def _poskey(apos: int, bpos: int, rid: int, qid: int) -> int:
    return _key((apos & 0xFFFFFFFF) | ((bpos & 0xFFFFFFFF) << 32),
                (rid & 0xFFFFFFFF) | ((qid & 0xFFFFFFFF) << 32))


@dataclasses.dataclass
class Seg:
    """One gaba_path_section_t-equivalent: a piece of an alignment
    lying within a single pass over the reference (alignments on
    circular references split at the origin; gaba.c:2862
    trace_push_segment). Coordinates are mod-rlen on the ref side."""
    as0: int
    ae: int
    bs0: int
    be: int
    path: str
    po: int = 0            # start offset within the full forward path
                           # (display order); maps to the up-space bit
                           # position for the printers' reverse parse


@dataclasses.dataclass
class Aln:
    rid: int
    rev: int
    as0: int               # head-segment ref start (forward, mod coords)
    ae: int                # tail-segment ref end (mod coords)
    bs0: int               # query start (strand space)
    be: int                # query end (strand space)
    score: int
    path: str              # forward-space ops: D=query base, R=ref base
    identity: float
    dcnt: int
    agcnt: int
    bgcnt: int
    segs: list = None      # [Seg] head-to-tail; None -> single segment
    upath: str = ""        # up-space bit path (gaba's aln->path order);
                           # the printers reverse-parse this
                           # (gaba_dump_cigar_reverse, minialign.c:5173)

    def __post_init__(self):
        if self.segs is None:
            self.segs = [Seg(self.as0, self.ae, self.bs0, self.be,
                             self.path, po=0)]

    @property
    def plen(self) -> int:
        return len(self.path)

    @property
    def slen(self) -> int:
        return len(self.segs)


def split_segments(as0_u: int, bs0: int, path: str, rlen: int,
                   ops: list | None = None) -> list:
    """Split a (possibly origin-wrapping) alignment into per-pass
    segments. as0_u is the unwrapped ref start (negative when the
    alignment began before the origin of the final pass); the split
    points are the multiples of rlen crossed by the ref walk."""
    # walk the WALKER's pop tokens (ops: 'X' diagonal pair / 'R' /
    # 'D'), not raw path chars: gaba pushes the segment boundary when a
    # pop's section test fires, and only h-gap and diagonal pops test
    # the a-side index (_trace_tail_h/d_test_index, gaba.c:2935-2937).
    # A v-gap pop checks bgidx alone, so insertions that follow the
    # origin-crossing DIAGONAL stay in the current segment, while a
    # lone crossing R (gap pop, returning to d_head) splits at once.
    if ops is None:
        ops = []                   # derive pair tokens from the chars
        i = 0
        while i < len(path):
            if path[i] == "D" and i + 1 < len(path) \
                    and path[i + 1] == "R":
                ops.append("X")
                i += 2
            else:
                ops.append(path[i])
                i += 1
    segs = []
    seg_a0, seg_b0, start = as0_u, bs0, 0
    apos, bpos = as0_u, bs0
    pos = 0                        # char position in path
    k, n = 0, len(ops)
    while k < n:
        t = ops[k]
        if t == "X" or t[0] == "R":
            w = len(t) if t[0] == "R" else 1
            crossed = False
            for _ in range(w):     # boundary drains are multi-R tokens
                apos += 1
                if apos % rlen == 0:
                    crossed = True
            if t == "X":
                bpos += 1
            pos += 2 if t == "X" else len(t)
            k += 1
            if crossed:
                if t == "X":
                    # absorb following v pops into this segment
                    while k < n and ops[k][0] == "D":
                        bpos += len(ops[k])
                        pos += len(ops[k])
                        k += 1
                if k < n:
                    segs.append(Seg(seg_a0 % rlen,
                                    ((apos - 1) % rlen) + 1,
                                    seg_b0, bpos, path[start:pos],
                                    po=start))
                    seg_a0, seg_b0, start = apos, bpos, pos
        else:
            bpos += len(t)
            pos += len(t)
            k += 1
    segs.append(Seg(seg_a0 % rlen, ((apos - 1) % rlen) + 1, seg_b0, bpos,
                    path[start:], po=start))
    return segs


@dataclasses.dataclass
class Bin:
    """mm_bin_t. lb/ub init note: the source (minialign.c:3855) writes
    `.lb = UINT32_MAX` through a compound literal pushed as void**, a
    strict-aliasing violation that gcc -O3 (the release build, and the
    build behind every published benchmark and our golden files) elides
    — the released binary runs with lb = 0, so ovl degenerates to
    `be - min(ub, be)` and lb stays 0 forever. We match the release
    binary (PARITY.md item 5)."""
    n_aln: int = 0
    plen: int = 0
    lb: int = 0
    ub: int = 0
    slot_idx: list = dataclasses.field(default_factory=list)
    mapq: int = 0


def revcomp_codes(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c)
    out = (3 - c[::-1]).astype(np.int8)
    out[np.asarray(c[::-1]) > 3] = band.NCODE
    return out


def ref_revcomp(mi, rid: int) -> np.ndarray:
    """Cached reverse complement of reference sequence `rid` — the
    root loader needs it per chain, and recomputing a multi-Mb
    revcomp per chain dominated host time (measured 5.3 s of a 21 s
    E2E run). The cache lives on the index object (works through the
    ShardedIndex facade too)."""
    cache = getattr(mi, "_codes_rev", None)
    if cache is None:
        cache = {}
        try:
            object.__setattr__(mi, "_codes_rev", cache)
        except (AttributeError, TypeError):
            return revcomp_codes(np.asarray(mi.codes[rid], np.int8))
    if rid not in cache:
        cache[rid] = revcomp_codes(np.asarray(mi.codes[rid], np.int8))
    return cache[rid]


# ---------------------------------------------------------------------------
# device batch engine
# ---------------------------------------------------------------------------

# process-wide jitted-function cache shared by every engine with the same
# scoring params and fill: without it each CLI invocation / FillEngine
# instance re-traces and re-compiles every shape bucket
_FN_CACHE: dict = {}
# window-bucket floor on the device path: merging the small rescue-probe
# shapes into one bucket shrinks the set of compiled variants; padded
# problems stop at their own p-limit, so device steps don't grow
_MIN_BUCKET = int(_os.environ.get("MINIALIGN_MIN_BUCKET", "4096"))
_REF_STORE_CACHE: dict = {}
WIDTHS = (64, 32, 16)      # indexed by st.narrow
CAPU_ADD = 4 * 64 + 2 * band.TAIL_N + 64   # up-window cap beyond 2 * tp1


# byte LUTs for op-code -> path-string builds (op 3 = diagonal is
# two chars: "RD" backward / "DR" in rev-token order)
_LUT_FWD1 = np.frombuffer(b"\0DRR", np.uint8)
_LUT_REV1 = np.frombuffer(b"\0DRD", np.uint8)
_LUT_TOK = np.frombuffer(b"\0DRX", np.uint8)


def rle_paths_py(ent: np.ndarray):
    """Pure-numpy fallback for native.rle_paths: expand bit-packed
    (op | len << 2) RLE entries into (path, path_rev, ops_rev)
    strings. Parity with the native implementation is enforced by
    tests/test_native.py::test_rle_paths_parity."""
    ent = np.asarray(ent)
    col = np.repeat(ent & 3, ent >> 2)
    widths = np.where(col == 3, 2, 1)
    starts = np.cumsum(widths) - widths
    total = int(starts[-1] + widths[-1]) if len(col) else 0
    bf = np.empty(total, np.uint8)
    bf[starts] = _LUT_FWD1[col]
    bf[starts[col == 3] + 1] = ord("D")
    path = bytes(bf[::-1]).decode()
    bf[starts] = _LUT_REV1[col]
    bf[starts[col == 3] + 1] = ord("R")
    path_rev = bytes(bf).decode()
    ops_rev = bytes(_LUT_TOK[col]).decode()
    return path, path_rev, ops_rev


def _score_key(p: ScoreParams):
    return (tuple(p.matrix), p.gi, p.ge, p.gfa, p.gfb, p.xdrop)


def backend() -> str:
    """The JAX platform the engine runs on ("gpu", "cpu", ...)."""
    import jax
    return jax.default_backend()


def platform_fill(platform: str):
    """The store-contract fill builder a platform runs (signature of
    band.make_store_fill): the CUDA kernel on GPUs, the XLA fill on the
    CPU. Any other platform has no fill."""
    if platform == "gpu":
        from .dp import cuda_fill
        return cuda_fill.make_fill
    if platform == "cpu":
        return band.make_store_fill
    raise ValueError(f"no band fill for platform {platform!r} "
                     "(supported: gpu, cpu)")


class FillEngine:
    """Shape-bucketed jitted fill executor, in one of two structures.

    Device path (the default on GPUs): the reference and the current
    read batch live on the device as flat code stores (set_index /
    set_queries); a request names its windows by (base, start, cap)
    specs; the store-contract fill reads them by pointer (the CUDA
    kernel) or by XLA gather (band.make_store_fill); a down/up extension
    pair runs as one fused dispatch (duo) and the traceback walks on the
    device (dp/dtrace), so only run-length paths come back.

    Host path (the CPU default): requests carry host code arrays,
    padded into (B, L) batches for band.make_fill, and the traceback
    runs on the host walker.

    fill: the device path's store-contract fill builder; defaults to
    platform_fill(backend()) (pass band.make_store_fill to compare the
    XLA fill against the kernel on a GPU). device_path defaults to
    backend() == "gpu"."""

    def __init__(self, score: ScoreParams, batch: int | None = None,
                 fill=None, device_path: bool | None = None):
        plat = backend()
        self.p = score
        self.make_fill = fill if fill is not None else platform_fill(plat)
        self.device_path = plat == "gpu" if device_path is None \
            else device_path
        # max problems per dispatch
        self.batch = batch if batch is not None else \
            (int(_os.environ.get("MINIALIGN_DISPATCH_B", "512"))
             if self.device_path else 32)
        self._fns = _FN_CACHE.setdefault(
            (_score_key(score), self.device_path, self.make_fill), {})
        # dispatch-shape statistics (MINIALIGN_STATS=1 prints at exit):
        # (kind, n_real, B_padded) per device dispatch. None when the
        # flag is unset so long-lived processes don't grow the list
        # unboundedly (the atexit dump is the only consumer).
        self.stats = None
        if _os.environ.get("MINIALIGN_STATS"):
            import atexit

            self.stats = []

            def _dump(st=self.stats):
                import collections
                import sys
                c = collections.Counter(st)
                for k, n in sorted(c.items()):
                    print(f"[stats] {k[0]} nreal={k[1]} B={k[2]} "
                          f"x{n}", file=sys.stderr)
            atexit.register(_dump)

    def _bucket(self, n: int) -> int:
        b = _MIN_BUCKET if self.device_path else 512
        while b < n:
            b *= 2
        return b

    def _pad_batch(self, n: int) -> int:
        """Padded dispatch size. Device path: a power of two from 32, so
        every window bucket compiles a handful of batch shapes; the fill
        kernel itself takes any B. Host path: a multiple of the batch."""
        if self.device_path:
            return max(32, 1 << max(n - 1, 0).bit_length())
        return max(self.batch, -(-n // self.batch) * self.batch)

    def _fn(self, W, la, lb, trace):
        """Host-path fill over (B, la) / (B, lb) code arrays."""
        key = (W, la, lb, trace)
        if key not in self._fns:
            self._fns[key] = band.make_fill(
                self.p, W, max_blocks=band.max_blocks_for(la, lb),
                trace=trace)
        return self._fns[key]

    def _dtrace(self, W):
        key = ("dtrace", W)
        if key not in self._fns:
            from .dp.dtrace import make_device_traceback
            self._fns[key] = make_device_traceback(self.p, W)
        return self._fns[key]

    # ------------------------------------------------------------------
    # device-resident sequence store: the reference genome and the
    # current read batch are uploaded ONCE; per-request band inputs are
    # read from per-problem (offset, length) windows, so no sequence
    # bytes cross the host->device link per dispatch (the reference's
    # immutable shared index, device-resident)
    # ------------------------------------------------------------------

    def set_index(self, mi) -> None:
        if getattr(self, "_ref_src", None) is getattr(mi, "codes", None):
            return
        # process-global store cache: engines are per-CLI-call, but the
        # uploaded reference store (revcomp + pad + device_put) is
        # reusable across calls on the same index object (the cache
        # holds a strong codes reference so the id key cannot be
        # recycled)
        cached = _REF_STORE_CACHE.get(id(mi.codes))
        if cached is not None and cached[0] is mi.codes:
            (_, self._ref_store, self._ref_fw, self._ref_rv,
             self._ref_len) = cached
            self._ref_src = mi.codes
            return
        import jax
        fw_bases, rv_bases, lens = [], [], []
        parts = []
        off = 0
        for c in mi.codes:
            c = np.asarray(c, np.int8)
            r = revcomp_codes(c)
            fw_bases.append(off)
            parts.append(c)
            off += len(c)
            rv_bases.append(off)
            parts.append(r)
            off += len(r)
            lens.append(len(c))
        flat = np.concatenate(parts) if parts else np.zeros(1, np.int8)
        self._ref_store = jax.device_put(band.pad_store(flat))
        self._ref_fw = fw_bases
        self._ref_rv = rv_bases
        self._ref_len = lens
        self._ref_src = mi.codes
        _REF_STORE_CACHE.clear()      # bound: one live index store
        _REF_STORE_CACHE[id(mi.codes)] = (
            mi.codes, self._ref_store, fw_bases, rv_bases, lens)

    def set_queries(self, reads) -> None:
        import jax
        bases, lens, parts = [], [], []
        off = 0
        for c in reads:
            c = np.asarray(c, np.int8)
            r = revcomp_codes(c)
            bases.append((off, off + len(c)))
            parts.append(c)
            parts.append(r)
            off += 2 * len(c)
            lens.append(len(c))
        flat = np.concatenate(parts) if parts else np.zeros(1, np.int8)
        self._q_store = jax.device_put(band.pad_store(flat))
        self._q_bases = bases
        self._q_len = lens

    def _gather_fn(self, L):
        """jit of band.gather_windows for L-wide rows (circular-reference
        windows, which wrap and so have no single store offset)."""
        key = ("gather", L)
        if key not in self._fns:
            import functools

            import jax
            self._fns[key] = jax.jit(
                functools.partial(band.gather_windows, L=L))
        return self._fns[key]

    def _side_meta(self, specs, B):
        """Per-problem window rows for one side of a dispatch, plus its
        store. Spec forms:
          ("ref", rid, rev, start, cap, wrap)   wrap>0 = circular mod
          ("q", qidx, which, start)             which 1 = revcomp
        off/elen: the window's store offset and length (non-wrapping)."""
        base = np.zeros(B, np.int32)
        start = np.zeros(B, np.int32)
        cap = np.zeros(B, np.int32)
        seglen = np.zeros(B, np.int32)
        wrap = np.zeros(B, np.int32)
        elen = np.zeros(B, np.int32)
        store = None
        for s, spec in enumerate(specs):
            if spec[0] == "ref":
                _, rid, rev, st0, cp, wr = spec
                store = self._ref_store
                base[s] = self._ref_rv[rid] if rev else self._ref_fw[rid]
                start[s] = st0
                rlen = self._ref_len[rid]
                seglen[s] = rlen
                wrap[s] = wr
                cap[s] = cp
                elen[s] = cp if wr else max(0, min(cp, rlen - st0))
            else:
                _, qidx, which, st0 = spec
                store = self._q_store
                b0, b1 = self._q_bases[qidx]
                base[s] = b1 if which else b0
                start[s] = st0
                qlen = self._q_len[qidx]
                seglen[s] = qlen
                cap[s] = max(0, qlen - st0)
                elen[s] = cap[s]
        # clamp padded problems' start (past the data) to the segment end
        off = base + np.minimum(start, seglen)
        return dict(base=base, start=start, cap=cap, seglen=seglen,
                    wrap=wrap, elen=elen, off=off, store=store)

    def _fused_fn(self, W, la, lb, trace, B):
        """Fill (+ device traceback when tracing) as one jit: (sa, offa,
        lna, sb, offb, lnb) -> stacked (3, B) [score, i, j], or the
        dtrace outputs (rle, head, summary)."""
        key = ("fused", W, la, lb, trace, B)
        if key not in self._fns:
            import jax
            import jax.numpy as jnp
            fill = self.make_fill(self.p, W, la, lb, trace)
            dt = self._dtrace(W) if trace else None

            @jax.jit
            def f(sa, offa, lna, sb, offb, lnb):
                if trace:
                    res, bufs = fill(sa, offa, lna, sb, offb, lnb)
                    return dt(bufs.masks, bufs.dirs, bufs.iheads,
                              res.max_score, res.max_i, res.max_j)
                res = fill(sa, offa, lna, sb, offb, lnb)
                return jnp.stack([res.max_score, res.max_i, res.max_j])

            self._fns[key] = f
        return self._fns[key]

    def _duo_fn(self, W, la, lb, lau, lbu, B):
        """Fused down-fill -> up-window math -> up-fill -> device
        trace, ONE dispatch per extension trial (the reference's
        mm_extend_core down/up pair, minialign.c:4075-4147, runs two
        host round trips here otherwise). The up window offsets are
        pure arithmetic on the down max and per-problem geometry, so
        they move onto the device; the host dedup test between down
        and up (mm_search_test_dup) is applied at harvest — a dup
        simply discards the speculative up result, which is byte-
        neutral. Circular references stay on the two-step path."""
        key = ("duo", W, la, lb, lau, lbu, B)
        if key not in self._fns:
            import jax
            import jax.numpy as jnp

            fill_d = self.make_fill(self.p, W, la, lb, False)
            fill_u = self.make_fill(self.p, 64, lau, lbu, True)
            dt = self._dtrace(64)

            @jax.jit
            def f(sa, offa, lna, sb, offb, lnb,
                  rvbase, qub, rlen_r, qlen_r, cp0_r, cp1_r):
                down = fill_d(sa, offa, lna, sb, offb, lnb)
                ae = cp0_r + down.max_i
                be = cp1_r + down.max_j
                tp0 = jnp.clip(ae, 1, rlen_r)
                tp1 = jnp.clip(be, 1, qlen_r)
                # a failed down (score 0) would otherwise trace a
                # full-length garbage alignment and stretch the whole
                # trace batch's walk; zero-length inputs terminate its
                # up fill immediately
                ok = (down.max_score > 0).astype(jnp.int32)
                lna_u = jnp.minimum(2 * tp1 + CAPU_ADD, tp0) * ok
                offa_u = rvbase + (rlen_r - tp0)
                lnb_u = tp1 * ok
                offb_u = qub + (qlen_r - tp1)
                upres, bufs = fill_u(sa, offa_u, lna_u, sb, offb_u, lnb_u)
                rle, head, summ = dt(bufs.masks, bufs.dirs,
                                     bufs.iheads,
                                     upres.max_score, upres.max_i,
                                     upres.max_j)
                # down results ride as 3 extra summary rows: ONE
                # device->host array per harvest
                dsum = jnp.stack([down.max_score, down.max_i,
                                  down.max_j])
                return rle, head, jnp.concatenate([summ, dsum],
                                                  axis=0)

            self._fns[key] = f
        return self._fns[key]

    def _trace_device_harvest(self, out, pend):
        from . import native as _nat
        from .dp.dtrace import SUMMARY_ROWS
        from .dp.traceback import TraceResult, _identity

        sub, W, rle_d, head_d, summary_d = pend
        p = self.p
        nreal = len(sub)
        # one transfer for every per-problem scalar
        summ = np.asarray(summary_d)[:, :nreal]
        row = dict(zip(SUMMARY_ROWS, summ))
        ms, mi, mj = row["score"], row["ai"], row["bj"]
        n_ent, bad = row["n_ent"], row["bad"]
        counts = row
        # RLE entries: only max(n_ent) rows of int8 cross the link.
        # uint8 view first: entries are bit-packed (op | len << 2)
        # and wrap negative as int8 for len >= 32.
        # Typical walks finish inside the static head slice, whose
        # transfer needs no extra device slice dispatch
        tmax = int(n_ent.max()) if nreal else 0
        if head_d is not None and int(summ[SUMMARY_ROWS.index(
                "t_fin"), 0] if nreal else 0) <= head_d.shape[0]:
            rle = np.asarray(head_d)[:tmax, :nreal]
        else:
            rle = np.asarray(rle_d[:tmax, :nreal])
        rle = rle.view(np.uint8).astype(np.int32)

        for s, i in enumerate(sub):
            score = int(ms[s])
            ai, bj = int(mi[s]), int(mj[s])
            if score <= 0 or (ai == 0 and bj == 0):
                tr = TraceResult(score=max(score, 0), alen=0, blen=0,
                                 path="", path_rev="", dcnt=0, agcnt=0,
                                 bgcnt=0, identity=0.0, gap_penalty=0)
            elif bad[s]:
                tr = None
            else:
                ent = rle[:n_ent[s], s]
                r3 = _nat.rle_paths(ent.astype(np.uint8))
                if r3 is None:
                    r3 = rle_paths_py(ent)
                path, path_rev, ops_rev = r3
                dcnt = int(counts["dcnt"][s])
                gap_penalty = (int(counts["n_open"][s]) * p.gi
                               + int(counts["n_ext"][s]) * p.ge
                               + int(counts["gf_pen"][s]))
                tr = TraceResult(
                    score=score, alen=ai, blen=bj, path=path,
                    path_rev=path_rev, dcnt=dcnt,
                    agcnt=int(counts["agcnt"][s]),
                    bgcnt=int(counts["bgcnt"][s]),
                    identity=_identity(p, score, dcnt,
                                       int(counts["e_pen"][s])),
                    gap_penalty=gap_penalty, ops_rev=ops_rev)
            out[i] = (score, ai, bj, tr)

    def _req_lens(self, a, b):
        la = len(a) if isinstance(a, np.ndarray) else (
            a[4] if a[0] == "ref" else 0)
        if not isinstance(a, np.ndarray) and a[0] == "ref":
            _, rid, rev, st0, cp, wr = a
            la = cp if wr else max(0, min(cp, self._ref_len[rid] - st0))
        lb = len(b) if isinstance(b, np.ndarray) else \
            max(0, self._q_len[b[1]] - b[3])
        return la, lb

    def run(self, reqs: list) -> list:
        """reqs: list of (kind, a, b, W[, meta]) with kind 'down', 'up'
        or 'duo'; a/b are raw code arrays (host path) or store window
        specs (device path, see _side_meta). Returns per-request
        (score, mi, mj, trace|None), or for 'duo' (down score, mi, mj,
        up score, mi, mj, trace)."""
        out = [None] * len(reqs)
        groups = {}
        duo_groups = {}
        for i, req in enumerate(reqs):
            kind, a, b, W = req[0], req[1], req[2], req[3]
            ra, rb = self._req_lens(a, b)
            la = self._bucket(ra + band.TAIL_N + 128)
            lb = self._bucket(rb + band.TAIL_N + 128)
            if kind == "duo":
                rlen, qlen = req[4][3], req[4][4]
                lau = self._bucket(min(2 * qlen + CAPU_ADD, rlen)
                                   + band.TAIL_N + 128)
                lbu = self._bucket(qlen + band.TAIL_N + 128)
                duo_groups.setdefault((W, la, lb, lau, lbu),
                                      []).append(i)
            else:
                groups.setdefault((kind == "up", W, la, lb),
                                  []).append(i)
        if self.device_path:
            self._run_device(reqs, groups, duo_groups, out)
        else:
            self._run_host(reqs, groups, out)
        return out

    def _run_host(self, reqs, groups, out) -> None:
        pending_plain = []
        for (trace, W, la, lb), idxs in groups.items():
            fn = self._fn(W, la, lb, trace)
            for base in range(0, len(idxs), self.batch):
                sub = idxs[base:base + self.batch]
                B = self._pad_batch(len(sub))
                ab = np.full((B, la), band.NCODE, np.int8)
                bb = np.full((B, lb), band.NCODE, np.int8)
                alen = np.zeros(B, np.int32)
                blen = np.zeros(B, np.int32)
                for s, i in enumerate(sub):
                    _, a, b, _ = reqs[i]
                    ab[s, :len(a)] = a
                    bb[s, :len(b)] = b
                    alen[s] = len(a)
                    blen[s] = len(b)
                if not trace:
                    pending_plain.append((sub, fn(ab, alen, bb, blen)))
                    continue
                res_d, bufs = fn(ab, alen, bb, blen)
                res = type(res_d)(*(np.asarray(x) for x in res_d))
                # the traceback walks backward from the max and never
                # past it: fetch only the reachable blocks
                nreal = len(sub)
                nblk = int((res.max_i[:nreal]
                            + res.max_j[:nreal]).max()) // band.BLK + 2
                nblk = min(-(-nblk // 32) * 32, bufs.dirs.shape[1])
                masks = np.asarray(bufs.masks[:nreal, :nblk])
                dirs = np.asarray(bufs.dirs[:nreal, :nblk])
                iheads = np.asarray(bufs.iheads[:nreal])
                for s, i in enumerate(sub):
                    tr = traceback_one(
                        self.p, W, masks[s], dirs[s], iheads[s],
                        int(res.max_score[s]), int(res.max_i[s]),
                        int(res.max_j[s]))
                    out[i] = (int(res.max_score[s]), int(res.max_i[s]),
                              int(res.max_j[s]), tr)
        for sub, res in pending_plain:
            import jax.numpy as jnp
            smm = np.asarray(jnp.stack(
                [res.max_score, res.max_i, res.max_j]))
            for s, i in enumerate(sub):
                out[i] = (int(smm[0, s]), int(smm[1, s]), int(smm[2, s]),
                          None)

    def _run_device(self, reqs, groups, duo_groups, out) -> None:
        pending = []            # deferred device-trace harvests
        pending_duo = []        # deferred fused down+up harvests
        pending_plain = []      # deferred no-trace materializations
        zpad_a = ("ref", 0, 0, 0, 0, 0)
        zpad_b = ("q", 0, 0, 10**9)
        for (trace, W, la, lb), idxs in groups.items():
            for base in range(0, len(idxs), self.batch):
                sub = idxs[base:base + self.batch]
                B = self._pad_batch(len(sub))
                ma = self._side_meta([reqs[i][1] for i in sub]
                                     + [zpad_a] * (B - len(sub)), B)
                mb = self._side_meta([reqs[i][2] for i in sub]
                                     + [zpad_b] * (B - len(sub)), B)
                sa, offa = ma["store"], ma["off"]
                if ma["wrap"].any():
                    # circular windows wrap at the origin: materialize
                    # the (B, la) rows, then read them as a store
                    sa = self._gather_fn(la)(
                        sa, ma["base"], ma["start"], ma["cap"],
                        ma["seglen"], ma["wrap"]).reshape(-1)
                    offa = np.arange(B, dtype=np.int32) * la
                r = self._fused_fn(W, la, lb, trace, B)(
                    sa, offa, ma["elen"], mb["store"], mb["off"],
                    mb["elen"])
                if trace:
                    pending.append((sub, W) + tuple(r))
                    if self.stats is not None:
                        self.stats.append(("trace", len(sub), B))
                else:
                    pending_plain.append((sub, r))
        for gkey, idxs in duo_groups.items():
            W, la, lb, lau, lbu = gkey
            for base in range(0, len(idxs), self.batch):
                sub = idxs[base:base + self.batch]
                B = self._pad_batch(len(sub))
                ma = self._side_meta([reqs[i][1] for i in sub]
                                     + [zpad_a] * (B - len(sub)), B)
                mb = self._side_meta([reqs[i][2] for i in sub]
                                     + [zpad_b] * (B - len(sub)), B)
                rvbase = np.zeros(B, np.int32)
                qub = np.zeros(B, np.int32)
                rlen_r = np.ones(B, np.int32)
                qlen_r = np.ones(B, np.int32)
                cp0_r = np.zeros(B, np.int32)
                cp1_r = np.zeros(B, np.int32)
                for s, i in enumerate(sub):
                    rid, rev, qidx, rlen, qlen, cp0, cp1 = reqs[i][4]
                    rvbase[s] = self._ref_rv[rid]
                    b0, b1 = self._q_bases[qidx]
                    qub[s] = b1 if (1 - rev) else b0
                    rlen_r[s] = rlen
                    qlen_r[s] = qlen
                    cp0_r[s] = cp0
                    cp1_r[s] = cp1
                f = self._duo_fn(W, la, lb, lau, lbu, B)
                rle_d, head_d, s16_d = f(
                    ma["store"], ma["off"], ma["elen"],
                    mb["store"], mb["off"], mb["elen"],
                    rvbase, qub, rlen_r, qlen_r, cp0_r, cp1_r)
                pending_duo.append((sub, rle_d, head_d, s16_d))
                if self.stats is not None:
                    self.stats.append(("duo", len(sub), B))
        # start all device->host copies before any blocking harvest, so
        # later batches' results stream while earlier ones materialize
        from .dp.dtrace import SUMMARY_ROWS as _SR
        for x in [x for pend in pending for x in pend[3:]] + \
                [x for pend in pending_duo for x in pend[2:]] + \
                [r for _, r in pending_plain]:
            x.copy_to_host_async()
        for pend in pending:
            self._trace_device_harvest(out, pend)
        nsr = len(_SR)
        for sub, rle_d, head_d, s16_d in pending_duo:
            s16 = np.asarray(s16_d)[:, :len(sub)]
            dsum = s16[nsr:nsr + 3]
            ups = [None] * len(sub)
            self._trace_device_harvest(ups, (list(range(len(sub))),
                                             64, rle_d, head_d,
                                             s16[:nsr]))
            for s, i in enumerate(sub):
                usc, uai, ubj, tr = ups[s]
                out[i] = (int(dsum[0, s]), int(dsum[1, s]),
                          int(dsum[2, s]), usc, uai, ubj, tr)
        for sub, r in pending_plain:
            smm = np.asarray(r)
            for s, i in enumerate(sub):
                out[i] = (int(smm[0, s]), int(smm[1, s]), int(smm[2, s]),
                          None)


# ---------------------------------------------------------------------------
# per-read extension task
# ---------------------------------------------------------------------------

def _slice_cap(brem: int, W: int) -> int:
    return 2 * brem + 4 * W + 2 * band.TAIL_N + 64


def _slice_a(codes: np.ndarray, start: int, brem: int, W: int,
             circ: bool = False) -> np.ndarray:
    cap = _slice_cap(brem, W)
    if circ:
        # circular section re-feed (rtp, minialign.c:3753): the same
        # ref section is fed again past its end, i.e. codes[pos % len]
        return np.take(codes, np.arange(start, start + cap), mode="wrap")
    return codes[start:start + cap]


@dataclasses.dataclass
class _SearchState:
    """mm_search_t equivalent (minialign.c:3216-3227)."""
    cp: tuple
    tp: tuple
    rev: int
    prem: int
    pacc: int = 0
    srem: int = MM_SREM
    narrow: int = 0
    sid: int = 0
    next_arr: list = dataclasses.field(default_factory=list)


def _load_next(st: _SearchState, seeds, tglen: int, rid: int, qlen: int,
               rlen: int = 1 << 62, kk: int = 0):
    """mm_search_load_next (minialign.c:3888-3948): pick a rescue seed
    within the tglen window behind the current head."""
    if st.srem == 0:
        return False
    st.srem -= 1

    bx = st.cp[1] - (qlen if st.rev else 0)
    fu = int(_u(st.cp[0], bx))
    fv = int(_v(st.cp[0], bx))

    ofs2 = 2 * tglen
    plim = ofs2 - st.pacc
    if st.pacc > ofs2:
        st.next_arr = []
    kept = []
    for pd, sid in st.next_arr:
        if pd >= plim:
            break
        kept.append((pd + st.pacc, sid))
    st.next_arr = kept

    rcnt = 2 * st.srem
    sid = st.sid
    while sid > 0 and rcnt > 0:
        su = int(seeds[sid - 1, 0])
        sr = int(seeds[sid - 1, 1])
        sv = int(seeds[sid - 1, 2])
        if sr < rid or su + tglen < fu:
            break
        inside = (fv > sv) and (fv <= sv + tglen) and (sr == rid)
        near = (fv > sv) and (fv <= sv + 128) and (fu <= su + 128) \
            and (sr == rid)
        if inside and not near:
            pdiff = (su + tglen - fu) + (sv + tglen - fv)
            st.next_arr.append((pdiff, sid - 1))
            rcnt -= 1
        sid -= 1
    st.sid = sid
    if not st.next_arr:
        st.pacc = 0
        st.srem = 0
        return False
    # radix_sort_64x keyed on pdiff ONLY (minialign.c:3931): equal
    # pdiffs keep ksort's permutation, and the reference pops the
    # LAST element after the sort
    from .ksort import ks_radix64
    keys = np.asarray([pd & 0xFFFFFFFF for pd, _ in st.next_arr],
                      np.uint32)
    order = ks_radix64(keys)
    st.next_arr = [st.next_arr[i] for i in order]
    pdiff, nsid = st.next_arr.pop()
    st.pacc = ofs2 - pdiff

    x, y = coords_to_xy(seeds[nsid, 0], seeds[nsid, 2])
    st.rev = 1 if y < 0 else 0
    apos = x
    bpos = y + (qlen if y < 0 else 0)
    # mm_search_load_pos over-end adjustment also runs on rescue
    # loads (minialign.c:3937); rlen is current here (mm_init_ref ran
    # at the root load)
    if apos >= rlen or bpos >= qlen:
        apos -= min(apos, kk)
        bpos -= min(bpos, kk)
    st.cp = (apos, bpos)
    return st.srem > 0


def extend_read(mp: MapParams, mi: MMIndex, qcodes: np.ndarray, qid: int,
                qidx: int | None = None, tbuf: dict | None = None):
    """Generator: yields ('down'|'up', a, b, W) requests, receives
    (score, mi, mj, trace) via .send(). With qidx (the read's index in
    the engine's device query store) requests are store window specs,
    and down/up pairs on linear references fuse into 'duo' requests. Returns (res, slots, rec) where
    res is a list of [accumulated_score, Bin] and slots the global
    aln-slot list (mm_align_seq up to the extend stage,
    minialign.c:4427-4450).

    tbuf carries the reference's per-thread-buffer state: the root
    bounds test in mm_search_load_pos (minialign.c:3828) reads
    self->rlen BEFORE mm_init_ref updates it (minialign.c:3865-3873),
    so it sees the ref length of the PREVIOUSLY loaded root — of an
    earlier chain, an earlier read, or 0 (calloc) for the very first
    root of the buffer's lifetime (one mm_align_init per index block).
    tbuf = {"rlen": <stale value>, "spec": bool}; with spec=True the
    first root of this read uses the current ref length as a guess and
    the caller replays the read if the guess disagrees with the true
    sequential value (see pipeline.align_batch). rec reports what this
    read did: its first root's raw position and fired flag, and the
    rlen it leaves behind."""
    score_p = mp.score
    qlen = len(qcodes)
    rec = {"first": None, "fired": False, "out_rlen": None}
    if tbuf is None:
        tbuf = {"rlen": 0, "spec": False}
    if qlen < mi.k or qlen * score_p.mcoef < mp.min_score:
        return None

    qf = np.ascontiguousarray(np.asarray(qcodes, np.int8))
    qr = revcomp_codes(qf)
    qrc = {0: qf, 1: qr}
    twlen = mp.wlen              # _ud(wlen, wlen) == wlen
    tglen = mp.glen

    st_seed = None
    res = []                     # [accumulated_score, Bin]
    slots = []                   # global aln slots (self->bin array)
    pos_hash = {}                # _key -> [eid, nid]
    crem = MM_CREM

    for rnd in range(len(mi.occ)):
        if rnd == 0:
            st_seed = collect_seeds(mi, qf)
        seeds = seed_round(mi, st_seed, rnd)
        if seeds is None or len(seeds) == 0:
            continue
        chains = chain_seeds(seeds, twlen, lens=mi.lens,
                             circular=mi.circular)
        if not chains:
            continue

        for ch in chains:
            if ch.plen * score_p.mcoef < 2.0 * mp.min_score:
                break
            # ---- load root (minialign.c:3839-3885)
            rsid = ch.root_sid
            x, y = coords_to_xy(seeds[rsid, 0], seeds[rsid, 2])
            rid = int(seeds[rsid, 1])
            rcodes = np.asarray(mi.codes[rid], np.int8)
            rrev = ref_revcomp(mi, rid)
            rlen = int(mi.lens[rid])
            circ = bool(mi.circular[rid])
            apos = x
            bpos = y + (qlen if y < 0 else 0)
            if rec["first"] is None:
                rec["first"] = (apos, bpos)
                fired = (apos >= (rlen if tbuf["spec"] else tbuf["rlen"])
                         or bpos >= qlen)
                rec["fired"] = fired
            else:
                fired = apos >= tbuf["rlen"] or bpos >= qlen
            if fired:
                apos -= min(apos, mi.k)
                bpos -= min(bpos, mi.k)
            tbuf["rlen"] = rlen
            rec["out_rlen"] = rlen
            st = _SearchState(cp=(apos, bpos), tp=(apos, bpos),
                              rev=1 if y < 0 else 0, prem=ch.plen,
                              sid=rsid)
            eid = len(res)
            bin_ = Bin()
            res.append([0, bin_])
            slots_mark = len(slots)

            first = True
            while st.srem > 0 and st.prem > 0:
                if not first:
                    if not _load_next(st, seeds, tglen, rid, qlen,
                                      rlen=rlen, kk=mi.k):
                        break
                first = False
                W = WIDTHS[st.narrow]
                qdir = qrc[st.rev]

                # ---- downward extension (+ fused speculative up:
                # one device round per trial when the store path and
                # non-circular geometry allow — mm_extend_core's
                # down/up pair, minialign.c:4075-4147)
                cap = _slice_cap(qlen - st.cp[1], W)
                use_duo = (qidx is not None and not circ
                           and st.cp[0] >= 0 and st.cp[1] >= 0)
                if use_duo:
                    a = ("ref", rid, 0, st.cp[0], cap, 0)
                    b = ("q", qidx, st.rev, st.cp[1])
                    meta = (rid, st.rev, qidx, rlen, qlen,
                            st.cp[0], st.cp[1])
                    sc, mi_, mj_, usc, umi, umj, tr = yield (
                        "duo", a, b, W, meta)
                else:
                    if qidx is not None:
                        a = ("ref", rid, 0, st.cp[0], cap,
                             rlen if circ else 0)
                        b = ("q", qidx, st.rev, st.cp[1])
                    else:
                        a = _slice_a(rcodes, st.cp[0], qlen - st.cp[1],
                                     W, circ)
                        b = qdir[st.cp[1]:]
                    sc, mi_, mj_, _ = yield ("down", a, b, W)
                if sc == 0:
                    continue
                ae, be = st.cp[0] + mi_, st.cp[1] + mj_
                if circ and ae > rlen:
                    # gaba reports the max within the re-fed section;
                    # fold the unwrapped end back (pos in (0, rlen])
                    ae = ((ae - 1) % rlen) + 1
                # test_dup (minialign.c:3953-3994), clip to [1, len]
                st.tp = (min(max(ae, 1), rlen), min(max(be, 1), qlen))
                k = _poskey(ae, be, rid, qid)
                dup = k in pos_hash
                pos_hash[k] = [eid, -1]
                if dup:
                    # the fused path's speculative up result is simply
                    # discarded — byte-neutral vs the two-step skip
                    st.narrow = min(st.narrow + 1, 2)
                    continue

                if not use_duo:
                    # ---- upward extension on reversed sequences
                    W0 = WIDTHS[0]
                    capu = _slice_cap(st.tp[1], W0)
                    if qidx is not None:
                        au = ("ref", rid, 1, rlen - st.tp[0], capu,
                              rlen if circ else 0)
                        # revcomp(qdir) is just the OTHER strand copy
                        bu = ("q", qidx, 1 - st.rev, qlen - st.tp[1])
                    else:
                        au = _slice_a(rrev, rlen - st.tp[0], st.tp[1],
                                      W0, circ)
                        bu = revcomp_codes(qdir)[qlen - st.tp[1]:]
                    usc, umi, umj, tr = yield ("up", au, bu, W0)
                if usc < mp.min_score or tr is None:
                    continue

                ae, be = st.tp
                as0_u, bs0 = ae - umi, be - umj
                segs = split_segments(as0_u, bs0, tr.path_rev, rlen,
                                      ops=list(tr.ops_rev) or None) \
                    if (circ and as0_u < 0) else None
                as0 = segs[0].as0 if segs else as0_u
                aln = Aln(rid=rid, rev=st.rev, as0=as0, ae=ae,
                          bs0=bs0, be=be, score=usc, path=tr.path_rev,
                          identity=tr.identity, dcnt=tr.dcnt,
                          agcnt=tr.agcnt, bgcnt=tr.bgcnt, segs=segs,
                          upath=tr.path)

                # ---- record (minialign.c:4018-4067)
                st.cp = (as0, bs0)
                st.prem -= aln.plen
                st.pacc = aln.plen
                hk = _poskey(as0, bs0, rid, qid)
                tk = _poskey(ae, be, rid, qid)
                hent = pos_hash.get(hk)
                new = hent is None or hent[1] == -1 \
                    or hent[1] >= len(slots)        # stale after rollback
                if new:
                    nid = len(slots)
                    slots.append(aln)
                    bin_.slot_idx.append(nid)
                else:
                    nid = hent[1]
                ovl = ((max(bin_.lb, bs0) - min(bin_.ub, be)
                        - bs0 + be) & 0xFFFFFFFF)
                res[eid][0] += aln.score + int((ovl * 2) * aln.identity)
                bin_.n_aln += 1 if new else 0
                bin_.plen += aln.plen
                bin_.lb = min(bin_.lb, bs0)
                bin_.ub = max(bin_.ub, be)
                if (not new) and slots[nid].score > aln.score:
                    pos_hash[tk] = [eid, -1]
                else:
                    if not new:
                        slots[nid] = aln
                    pos_hash[hk] = [eid, nid]
                    pos_hash[tk] = [eid, nid]
                st.srem, st.narrow = MM_SREM, 0
                if (not new) or st.prem <= 0:
                    break

            # ---- finish root (minialign.c:3795-3811)
            if bin_.n_aln == 0 or res[eid][0] < mp.min_score:
                res.pop()
                del slots[slots_mark:]
                crem -= 1
            else:
                crem = MM_CREM if crem != 0 else 0
            if crem == 0:
                break
        if res:
            break

    if not res:
        return None, None, rec
    return res, slots, rec
