"""Chip smoke test: the aligner end to end on one NVIDIA GPU.

    python chip_smoke.py           # one GPU: phases 1-4 below
    python chip_smoke.py --four    # four GPUs of one host: phase 5 only

Phases (each prints its result and seconds, the card's name and power
limit beside every time; any failure fails the run):
  1. set-up: devices, the CUDA fill's build, the native host library,
     and the test suite's `gpu`-marked tests, in this process;
  2. the CUDA fill against the XLA fill at W 64/32/16, trace on and
     off, B=512 at 4 kb and 32 kb windows plus one 150 kb pair (exact
     equality), the device traceback against the host walker on those
     buffers, the XLA window gather against host slicing, and the
     memory analysis of the fused and duo dispatches;
  3. every tests/data golden through the CLI, byte-identical modulo @PG;
  4. an E.coli-scale workload (4.6 Mb genome, 500 PBSIM-profile ~20 kb
     reads, fixed seed) mapped with -t4 -xpacbio from a prebuilt index:
     cold and warm walls, rates, peak device memory, the SAM digest
     against an XLA-fill engine, and the fill and traceback timed alone;
  5. (--four) the hash-range-sharded index with the data-parallel fill
     over four GPUs against the single-device engine, byte for byte, on
     a 100 Mb genome with 200 reads, and the 64-bit key lookup at k=19.

The last line of standard output is one JSON object: {"ok": true,
"device": {"platform", "kind", "count"}}. Without a GPU, or without the
repository around it, the script exits non-zero and prints no result.
"""

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
SEED = 20261016
# workload sizes (see the module docstring)
PARITY_CASES = ((4096, 512, 4096 - 224), (32768, 512, 32768 - 224),
                (262144, 1, 150000))       # (window bucket, B, length)
ECOLI = (4_600_000, 500, 20000)            # genome, reads, read length
KERNEL_ALONE = (20000, 32768, (128, 512, 2048))   # length, bucket, Bs
FOUR = (100_000_000, 200, 20000)
GPU_INFO = "unknown GPU"
FAILED = []


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode:
        raise RuntimeError("nvidia-smi failed: " + r.stderr.strip())
    return "; ".join(ln.strip() for ln in r.stdout.splitlines() if ln)


def say(msg: str, secs: float | None = None) -> None:
    if secs is not None:
        msg += f" | {secs:.6f} s [{GPU_INFO}]"
    print(msg, flush=True)


def phase(fn):
    """Run one phase; a failure is recorded and the run goes on, so one
    call on the card reports every broken phase."""
    def run(*a, **k):
        say(f"== phase {fn.__name__}")
        t0 = time.perf_counter()
        try:
            fn(*a, **k)
        except Exception:          # noqa: BLE001 - reported, run fails
            traceback.print_exc()
            FAILED.append(fn.__name__)
            say(f"== phase {fn.__name__}: FAILED",
                time.perf_counter() - t0)
            return
        say(f"== phase {fn.__name__}: ok", time.perf_counter() - t0)
    return run


def run_cli(args) -> str:
    from minialign_jax import cli
    out = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        rc = cli.main(list(args))
    finally:
        sys.stdout = old
    if rc != 0:
        raise RuntimeError(f"cli.main{tuple(args)} returned {rc}")
    return out.getvalue()


@contextlib.contextmanager
def xla_fill_on_gpu():
    """Engines built inside run the XLA store fill on the GPU (the
    comparison engine); the device path is unchanged."""
    from minialign_jax import extend
    from minialign_jax.dp import band
    real = extend.platform_fill
    extend.platform_fill = lambda plat: (band.make_store_fill
                                         if plat == "gpu" else real(plat))
    try:
        yield
    finally:
        extend.platform_fill = real


def block(x):
    import jax
    return jax.block_until_ready(x)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def pair_stores(rng, n, la_max, lb_max, length):
    """n PBSIM-profile pairs (a random, b = a with ~12% errors) as
    device stores + offsets + lengths (the fill's store contract)."""
    import jax
    import numpy as np

    from bench_e2e import pbsim_mutate
    from minialign_jax.dp import band
    a = [rng.integers(0, 4, min(length, la_max)).astype(np.int8)
         for _ in range(n)]
    b = [pbsim_mutate(rng, x)[:lb_max] for x in a]

    def one(seqs):
        lens = np.asarray([len(s) for s in seqs], np.int32)
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
        return (jax.device_put(band.pad_store(np.concatenate(seqs))),
                jax.device_put(offs), jax.device_put(lens))
    sa, offa, lna = one(a)
    sb, offb, lnb = one(b)
    return sa, offa, lna, sb, offb, lnb


def compare_fills(ref, got, trace):
    """Exact equality: FillResult fields, and every TraceBuffers field
    on the blocks each problem filled (n_steps // BLK)."""
    import numpy as np

    from minialign_jax.dp import band
    r1, r2 = (ref[0], got[0]) if trace else (ref, got)
    for f in r1._fields:
        x1, x2 = np.asarray(getattr(r1, f)), np.asarray(getattr(r2, f))
        if not np.array_equal(x1, x2):
            bad = np.flatnonzero(np.atleast_1d(x1 != x2))[:5]
            raise AssertionError(f"FillResult.{f} differs at {bad}")
    if not trace:
        return
    nblk = np.asarray(r1.n_steps) // band.BLK
    for f in ref[1]._fields:
        x1 = np.asarray(getattr(ref[1], f))
        x2 = np.asarray(getattr(got[1], f))
        for k, n in enumerate(nblk):
            if not np.array_equal(x1[k, :n], x2[k, :n]):
                raise AssertionError(f"TraceBuffers.{f} differs, problem {k}")


def walks(p, W, res, bufs, idx):
    """Device walker vs host walker on the problems idx; returns
    (device seconds, host seconds) for those problems."""
    import numpy as np

    from minialign_jax.dp import dtrace, traceback as tb
    dt = dtrace.make_device_traceback(p, W)
    block(dt(bufs.masks, bufs.dirs, bufs.iheads, res.max_score, res.max_i,
             res.max_j))
    t0 = time.perf_counter()
    rle, _head, summ = dt(bufs.masks, bufs.dirs, bufs.iheads,
                          res.max_score, res.max_i, res.max_j)
    summ = np.asarray(summ)
    row = dict(zip(dtrace.SUMMARY_ROWS, summ))
    rle = np.asarray(rle[:int(row["n_ent"].max()) + 1])
    t_dev = time.perf_counter() - t0

    t0 = time.perf_counter()
    ms, mi, mj = (np.asarray(x) for x in (res.max_score, res.max_i,
                                          res.max_j))
    nblk = int((mi[idx] + mj[idx]).max()) // 32 + 2
    masks = np.asarray(bufs.masks[idx[0]:idx[-1] + 1, :nblk])
    dirs = np.asarray(bufs.dirs[idx[0]:idx[-1] + 1, :nblk])
    iheads = np.asarray(bufs.iheads[idx[0]:idx[-1] + 1])
    want = [tb.traceback_one(p, W, masks[k - idx[0]], dirs[k - idx[0]],
                             iheads[k - idx[0]], int(ms[k]), int(mi[k]),
                             int(mj[k])) for k in idx]
    t_host = time.perf_counter() - t0

    for k, w in zip(idx, want):
        if w is None:
            assert row["bad"][k] == 1, k
            continue
        assert row["bad"][k] == 0, k
        ent = rle[:row["n_ent"][k], k].view(np.uint8).astype(np.int32)
        ops = np.repeat(ent & 3, ent >> 2)
        fwd = "".join({1: "D", 2: "R", 3: "RD"}[int(o)] for o in ops)[::-1]
        assert fwd == w.path, k
        assert row["dcnt"][k] == w.dcnt, k
        assert row["agcnt"][k] == w.agcnt and row["bgcnt"][k] == w.bgcnt, k
    return t_dev, t_host


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@phase
def setup():
    import jax

    from minialign_jax import native
    from minialign_jax.dp import cuda_fill
    say(f"devices: {jax.devices()}")
    say(f"device_kind: {jax.devices()[0].device_kind}")
    say(f"card: {GPU_INFO}")
    say("CUDA fill build (make -C native cuda)", cuda_fill.build())
    cuda_fill.register()
    if os.environ.get("MINIALIGN_NO_NATIVE") or native._load() is None:
        raise RuntimeError("the native host library did not load")
    say(f"native host library: {native._SO}")
    import pytest

    class Passed:
        n = 0

        def pytest_runtest_logreport(self, report):
            self.n += report.when == "call" and report.passed
    passed = Passed()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")], plugins=[passed])
    say(f"pytest -m gpu: exit {int(rc)}, {passed.n} passed",
        time.perf_counter() - t0)
    if rc != 0 or passed.n == 0:
        raise RuntimeError(f"gpu-marked tests did not pass (exit {rc})")


@phase
def parity():
    import jax
    import numpy as np

    from minialign_jax.dp import band, cuda_fill
    from minialign_jax.extend import FillEngine
    from minialign_jax.params import MapParams
    p = MapParams().score
    rng = np.random.default_rng(SEED)
    for L, B, length in PARITY_CASES:
        args = pair_stores(rng, B, length, L - band.TAIL_N - 128, length)
        for W in (64, 32, 16):
            for trace in (False, True):
                t0 = time.perf_counter()
                ref = block(jax.jit(band.make_store_fill(
                    p, W, L, L, trace))(*args))
                t_x = time.perf_counter() - t0
                t0 = time.perf_counter()
                got = block(jax.jit(cuda_fill.make_fill(
                    p, W, L, L, trace))(*args))
                t_c = time.perf_counter() - t0
                compare_fills(ref, got, trace)
                res = got[0] if trace else got
                say(f"fill L={L} B={B} W={W} trace={int(trace)}: equal, "
                    f"n_blocks={int(res.n_blocks)}, "
                    f"max score {int(np.asarray(res.max_score).max())}; "
                    f"first calls (compile incl.) xla {t_x:.6f} s, cuda",
                    t_c)
                if trace:
                    idx = np.arange(min(B, 16))
                    t_d, t_h = walks(p, W, got[0], got[1], idx)
                    say(f"dtrace == host walker, L={L} W={W}, "
                        f"{len(idx)} problems: device {t_d:.6f} s, host",
                        t_h)
                del ref, got
        del args

    # XLA window gather vs host slicing, normal / wrap / past-end
    n, L = 512, 32768
    store = rng.integers(0, 4, 10_000_000).astype(np.int8)
    seglen = np.full(n, 1_000_000, np.int32)
    base = (rng.integers(0, 9, n) * 1_000_000).astype(np.int32)
    start = rng.integers(0, 1_000_000, n).astype(np.int32)
    start[:32] = 1_000_000 - 100             # past the segment end
    cap = rng.integers(0, L + 1, n).astype(np.int32)
    wrap = np.where(np.arange(n) % 3 == 0, seglen, 0).astype(np.int32)
    g = jax.jit(band.gather_windows, static_argnames="L")
    t0 = time.perf_counter()
    got = np.asarray(g(jax.device_put(band.pad_store(store)), base, start,
                       cap, seglen, wrap, L=L))
    t_g = time.perf_counter() - t0
    col = np.arange(L)[None, :]
    idx = start[:, None] + col
    idxw = np.where(wrap[:, None] > 0, idx % np.maximum(wrap, 1)[:, None],
                    idx)
    ok = (col < cap[:, None]) & ((wrap[:, None] > 0)
                                 | (idx < seglen[:, None]))
    want = np.where(ok, store[base[:, None]
                              + np.minimum(idxw, seglen[:, None] - 1)],
                    band.NCODE)
    assert np.array_equal(got, want), "gather differs from host slicing"
    say(f"XLA gather == host slicing ({n} x {L}, wrap + past-end rows)",
        t_g)

    eng = FillEngine(p)
    i32 = lambda *s: jax.ShapeDtypeStruct(s, np.int32)   # noqa: E731
    st = jax.ShapeDtypeStruct((64 << 20,), np.int8)
    fused = eng._fused_fn(64, 32768, 32768, True, 512).lower(
        st, i32(512), i32(512), st, i32(512), i32(512)).compile()
    say(f"memory_analysis fused(W=64, 32k x 32k, trace, B=512): "
        f"{fused.memory_analysis()}")
    duo = eng._duo_fn(64, 65536, 32768, 65536, 32768, 512).lower(
        st, i32(512), i32(512), st, i32(512), i32(512),
        *(i32(512) for _ in range(6))).compile()
    say(f"memory_analysis duo(W=64, 64k x 32k, B=512): "
        f"{duo.memory_analysis()}")


GOLDENS = [
    # (argv, golden, comparison); paths are relative to tests/data
    (["-t1", "tref.fa", "treads.fq"], "ref_out.sam", "sam"),
    (["-t4", "tref.fa", "treads.fq"], "ref_out.sam", "sam"),
    (["-t1", "-xpacbio", "tref.fa", "treads.fq"], "ref_pacbio.sam", "sam"),
    (["-t1", "-TAS,NM,MD,XS,NH,IH", "tref.fa", "treads.fq"],
     "ref_tags.sam", "md"),
    (["-t1", "-Q", "tref.fa", "treads.fq"], "ref_qual.sam", "sam"),
    (["-t1", "-Opaf", "tref.fa", "treads.fq"], "ref_out.paf", "exact"),
    (["-t1", "-Omaf", "tref.fa", "treads.fq"], "ref_out.maf", "exact"),
    (["-t1", "-Oblast6", "tref.fa", "treads.fq"], "ref_out.b6", "exact"),
    (["-t1", "-X", "-xava", "-Opaf", "treads.fa", "treads2.fq"],
     "ref_ava.paf", "exact"),
    (["-t1", "-X", "-xava", "-R", "@RG\\tID:ava", "treads.fa",
      "treads2.fq"], "ref_ava_rg.sam", "sam"),
    (["-t1", "-cplasmid", "cplas.fa", "creads.fq"], "ref_circ.sam", "sam"),
    (["-t1", "-Opaf", "-cplasmid", "cplas.fa", "creads.fq"],
     "ref_circ.paf", "exact"),
    (["-t1", "-cplasmid", "-TAS,NM,MD,SA,XS,NH,IH", "cplas.fa",
      "creads.fq"], "ref_circ_tags.sam", "md"),
    (["-t1", "tref.fa", "treads.bam"], "ref_bam.sam", "sam"),
    (["-t1", "-Q", "tref.fa", "treads.bam"], "ref_bam_q.sam", "sam"),
    (["-t1", "-xont.r9.4.1d", "tref.fa", "treads.fq"], "ref_ont.sam",
     "sam"),
    (["-t1", "-a2", "-b5", "-p5", "-q1", "-r3,3", "-eGA+3", "tref.fa",
      "treads.fq"], "ref_emod.sam", "sam"),
    (["-t1", "-xont.1dsq", "-cplasmid", "-TSA,MD", "cplas.fa",
      "creads.fq"], "ref_ont1dsq_circ.sam", "md"),
    (["-t1", "mref.fa", "mreads.fq"], "ref_multi.sam", "sam"),
    (["-t1", "-xpacbio", "repref.fa", "repreads.fq"], "ref_rep.sam", "sam"),
    (["-t1", "-xpacbio.ccs", "tieref.fa", "tiereads.fq"], "ref_tie.sam",
     "sam"),
    (["-t1", "-a2", "-b1", "-p4", "-q2", "-TAS,NM,XS,NH", "xdref.fa",
      "xdreads.fq"], "ref_xdrop.sam", "md"),
    (["-t1", "-a3", "-b4", "-p0", "-q2", "-m0.5", "-cc0", "-Omaf",
      "cmref.fa", "cmreads.fq"], "ref_circmaf.maf", "exact"),
    (["-t1", "-a3", "-b4", "-p0", "-q2", "-m0.5", "-cc0", "cmref.fa",
      "cmreads.fq"], "ref_circsplit.sam", "sam"),
    (["-t1", "-a3", "-b2", "-p5", "-q2", "-r3,3", "-s59", "-m0.2", "-k10",
      "-w3", "ksref.fa", "ksreads.fq"], "ref_ksort.sam", "md"),
]


def _norm(text, how):
    if how == "exact":
        return text.splitlines()
    lines = [ln for ln in text.splitlines() if not ln.startswith("@PG")]
    if how == "md":
        lines = ["\t".join(f for f in ln.split("\t")
                           if not f.startswith("MD:Z:")) for ln in lines]
    return lines


@phase
def goldens():
    def path(a):
        return os.path.join(DATA, a) if os.path.exists(
            os.path.join(DATA, a)) else a
    with tempfile.TemporaryDirectory() as td:
        mai = os.path.join(td, "two.mai")
        run_cli(["-t1", "-d", mai, path("tref.fa"), path("tref.fa")])
        conf = os.path.join(td, "myconf")
        with open(conf, "w") as f:
            f.write("-k15 -w10 -a2\n-b4 -p4 -q2 -r3,3 -Y50 -s50 -m0.3\n")
        table = GOLDENS + [
            (["-t1", mai, "treads.fq"], "ref_twoblock.sam", "sam"),
            (["-t1", "-x", conf, "tref.fa", "treads.fq"], "ref_pacbio.sam",
             "sam")]
        bad = []
        for argv, golden, how in table:
            t0 = time.perf_counter()
            got = run_cli([a if a.startswith("-") else path(a)
                           for a in argv])
            with open(os.path.join(DATA, golden)) as f:
                same = _norm(got, how) == _norm(f.read(), how)
            say(f"golden {golden} {' '.join(argv[:-2])}: "
                f"{'identical' if same else 'DIFFERS'}",
                time.perf_counter() - t0)
            if not same:
                bad.append(golden)
    if bad:
        raise AssertionError(f"goldens differ: {bad}")


def _compile_counter():
    import collections

    from jax import monitoring
    counts = collections.Counter()
    monitoring.register_event_duration_secs_listener(
        lambda name, secs, **kw: counts.update([name]))
    monitoring.register_event_listener(
        lambda name, **kw: counts.update([name]))
    return counts


class _HashSink(io.TextIOBase):
    def __init__(self):
        self.h = hashlib.sha256()
        self.n = 0

    def write(self, s):
        if not s.startswith("@PG"):
            self.h.update(s.encode())
        self.n += len(s)
        return len(s)


def map_digest(argv):
    from minialign_jax import cli
    sink = _HashSink()
    old = sys.stdout
    sys.stdout = sink
    try:
        rc = cli.main(argv)
    finally:
        sys.stdout = old
    if rc:
        raise RuntimeError(f"cli.main{tuple(argv)} returned {rc}")
    return sink.h.hexdigest()


@phase
def real_size(counts):
    import jax
    import numpy as np

    from bench_e2e import pbsim_reads, write_fasta, write_fastq
    from minialign_jax.dp import band, cuda_fill
    from minialign_jax.params import MapParams
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        glen, n_reads, read_len = ECOLI
        g = rng.integers(0, 4, glen).astype(np.int8)
        reads = pbsim_reads(rng, g, n_reads, read_len)
        ref_fa, reads_fq = os.path.join(td, "ecoli.fa"), os.path.join(
            td, "reads.fq")
        write_fasta(ref_fa, "chr", g)
        write_fastq(reads_fq, reads)
        n_bases = sum(len(r) for r in reads)
        say(f"workload: {glen} b genome, {len(reads)} reads, {n_bases} bases "
            "(set-up)", time.perf_counter() - t0)
        mai = os.path.join(td, "ecoli.mai")
        t0 = time.perf_counter()
        run_cli(["-xpacbio", "-d", mai, ref_fa])
        say("index build -xpacbio (set-up)", time.perf_counter() - t0)
        argv = ["-t4", "-xpacbio", mai + ".npz", reads_fq]

        c0 = counts.copy()
        t0 = time.perf_counter()
        d_cold = map_digest(argv)
        cold = time.perf_counter() - t0
        n_comp = (counts["/jax/core/compile/backend_compile_duration"]
                  - c0["/jax/core/compile/backend_compile_duration"])
        n_hit = (counts["/jax/compilation_cache/cache_hits"]
                 - c0["/jax/compilation_cache/cache_hits"])
        say(f"map cold: {n_comp} backend compiles, {n_hit} persistent "
            "cache hits", cold)
        c0 = counts.copy()
        t0 = time.perf_counter()
        d_warm = map_digest(argv)
        warm = time.perf_counter() - t0
        n_comp = (counts["/jax/core/compile/backend_compile_duration"]
                  - c0["/jax/core/compile/backend_compile_duration"])
        say(f"map warm: {n_comp} backend compiles, "
            f"{n_bases / warm / 1e6:.6f} Mbases/s, "
            f"{len(reads) / warm:.6f} reads/s", warm)
        assert d_cold == d_warm, "cold and warm SAM differ"
        stats = jax.devices()[0].memory_stats() or {}
        say(f"device peak bytes in use: {stats.get('peak_bytes_in_use')}")

        with xla_fill_on_gpu():
            for run in ("cold", "warm"):
                t0 = time.perf_counter()
                d_xla = map_digest(argv)
                t_x = time.perf_counter() - t0
                say(f"SAM sha256 cuda fill {d_warm} / xla fill {d_xla}: "
                    f"{'equal' if d_warm == d_xla else 'DIFFER'}; "
                    f"xla-fill map {run}, "
                    f"{n_bases / t_x / 1e6:.6f} Mbases/s", t_x)
                assert d_warm == d_xla, "CUDA-fill and XLA-fill SAM differ"

    # the fill alone, W=64, 20 kb PBSIM-profile pairs
    p = MapParams().score
    length, L, Bs = KERNEL_ALONE
    for B in Bs:
        args = pair_stores(rng, B, length, L - band.TAIL_N - 128, length)
        for trace in (False, True):
            for name, mk in (("cuda", cuda_fill.make_fill),
                             ("xla", band.make_store_fill)):
                f = jax.jit(mk(p, 64, L, L, trace))
                out = block(f(*args))
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    block(f(*args))
                    ts.append(time.perf_counter() - t0)
                res = out[0] if trace else out
                cells = float(np.asarray(res.n_steps, np.int64).sum()) * 64
                say(f"fill alone {name} W=64 B={B} trace={int(trace)}: "
                    f"runs {ts}, {cells / min(ts) / 1e9:.6f} GCUPS",
                    min(ts))
                if trace and B == Bs[1] and name == "cuda":
                    t_d, t_h = walks(p, 64, out[0], out[1], np.arange(B))
                    say(f"walk alone, {B} problems: device {t_d:.6f} s, "
                        "host walker (D2H + native)", t_h)
                del out
        del args


@phase
def four():
    import jax
    import numpy as np

    from bench_e2e import pbsim_reads, write_fasta, write_fastq
    from minialign_jax.index.build import build_index
    from minialign_jax.index.sketch import sketch
    from minialign_jax.params import IndexParams
    from minialign_jax.parallel import shard
    n = len(jax.devices())
    if n < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {n}")
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        glen, n_reads, read_len = FOUR
        g = rng.integers(0, 4, glen).astype(np.int8)
        reads = pbsim_reads(rng, g, n_reads, read_len)
        ref_fa, reads_fq = os.path.join(td, "g.fa"), os.path.join(td,
                                                                 "r.fq")
        write_fasta(ref_fa, "chr", g)
        write_fastq(reads_fq, reads)
        say(f"workload: {glen} b genome, {n_reads} reads (set-up)",
            time.perf_counter() - t0)
        argv = ["-t4", "-xpacbio", ref_fa, reads_fq]
        digests = {}
        for shard_env, what in (("1", f"sharded over {n} GPUs"),
                                ("0", "single GPU")):
            os.environ["MINIALIGN_SHARD"] = shard_env
            t0 = time.perf_counter()
            digests[shard_env] = map_digest(argv)
            say(f"map {what} (index build and compiles incl.): "
                f"sha256 {digests[shard_env]}", time.perf_counter() - t0)
        os.environ.pop("MINIALIGN_SHARD")
        assert digests["1"] == digests["0"], \
            "sharded and single-device SAM differ"
    # 64-bit minimizer keys on the mesh: k=19 hashes exceed 32 bits
    mesh = shard.make_mesh()
    gk = rng.integers(0, 4, 2_000_000).astype(np.int8)
    mi = build_index(IndexParams(k=19, w=10), ["c"], [gk])
    sidx = shard.ShardedIndex(mi, mesh)
    qh, _, _ = sketch(gk[500_000:540_000].astype(np.int64), 19, 10)
    qh = np.concatenate([qh, np.asarray(qh[:50], np.uint64)
                         ^ np.uint64(1 << 40)])
    st_d, cn_d = sidx.lookup(qh)
    st_h, cn_h = mi.lookup(qh)
    assert int(np.asarray(qh, np.uint64).max()) >= 1 << 32
    assert np.array_equal(cn_d, cn_h) and np.array_equal(st_d, st_h), \
        "sharded k=19 lookup differs from the host index"
    say(f"sharded lookup k=19 == host ({len(qh)} hashes, "
        f"{int((cn_h > 0).sum())} hits)")


def main() -> int:
    global GPU_INFO
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-GPU sharded phase only")
    opts = ap.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    try:
        import minialign_jax  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the program is not beside this script: {e}",
              file=sys.stderr)
        return 2
    GPU_INFO = card()
    say(f"nvidia-smi name, power.limit: {GPU_INFO}")
    counts = _compile_counter()
    if opts.four:
        four()
    else:
        setup()
        parity()
        goldens()
        real_size(counts)
    if FAILED:
        say(f"chip_smoke FAILED phases: {FAILED}")
        return 1
    say(f"card: {GPU_INFO}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
