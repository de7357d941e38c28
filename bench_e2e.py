"""End-to-end throughput benchmark: the whole CLI mapping pipeline
(parse -> sketch -> seed -> chain -> device fill -> traceback -> SAM)
on a PBSIM-profile workload, reported as Mbases/s and reads/s.

Workload (cached in $TMPDIR/minialign_e2e_cache): a 5 Mb synthetic genome
and 500 x ~20 kb reads at ~88% identity (the reference benchmark's
PBSIM profile, /root/reference/README.md:48-53), mapped with -xpacbio
through cli.main exactly as a user would run it.

Baseline: the reference maps 9.2 Gb of hg38 reads in 648 s on 4
Skylake threads = 14.2 Mbases/s (README.md:51).

Usage:
    python bench_e2e.py            # prints one JSON line
    python bench_e2e.py --profile  # adds a per-stage breakdown (stderr)
    BENCH_E2E_READS=100 ...        # smaller workload
"""

import cProfile
import io
import json
import os
import pstats
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_MBPS = 14.2
CACHE = os.path.join(tempfile.gettempdir(), "minialign_e2e_cache")
GENOME_MB = float(os.environ.get("BENCH_E2E_GENOME_MB", "5"))
N_READS = int(os.environ.get("BENCH_E2E_READS", "500"))
READ_LEN = int(os.environ.get("BENCH_E2E_READLEN", "20000"))


def pbsim_mutate(rng, seq):
    """PBSIM-profile errors at ~12%: 4.8% substitutions, 3.6% deletions,
    3.6% insertions (a random base after the kept one)."""
    r = rng.random(len(seq))
    out = np.array(seq, np.int8)
    sub = r < 0.048
    out[sub] = rng.integers(0, 4, int(sub.sum()))
    keep = np.stack([(r < 0.048) | (r >= 0.084),
                     (r >= 0.084) & (r < 0.12)], axis=1)
    pieces = np.stack([out, rng.integers(0, 4, len(seq)).astype(np.int8)],
                      axis=1)
    return pieces[keep]


def pbsim_reads(rng, g, n_reads, read_len):
    """n_reads PBSIM-profile reads (code arrays) from genome codes g:
    lengths ~ N(read_len, read_len / 10), both strands."""
    glen = len(g)
    reads = []
    for _ in range(n_reads):
        ln = int(rng.normal(read_len, read_len * 0.1))
        ln = max(1000, min(ln, glen - 1))
        st = int(rng.integers(0, glen - ln))
        arr = pbsim_mutate(rng, g[st:st + ln])
        if rng.random() < 0.5:
            arr = (3 - arr)[::-1]
        reads.append(arr)
    return reads


def write_fasta(path, name, codes):
    s = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(s), 80):
            f.write(s[i:i + 80] + "\n")


def write_fastq(path, reads):
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "w") as f:
        for i, arr in enumerate(reads):
            s = bases[arr].tobytes().decode()
            f.write(f"@read{i}\n{s}\n+\n{'I' * len(s)}\n")


def write_reads(rng, g, reads_fq):
    write_fastq(reads_fq, pbsim_reads(rng, g, N_READS, READ_LEN))


def make_workload():
    os.makedirs(CACHE, exist_ok=True)
    tag = f"g{GENOME_MB}_r{N_READS}_l{READ_LEN}"
    ref_fa = f"{CACHE}/ref_{tag}.fa"
    reads_fq = f"{CACHE}/reads_{tag}.fq"
    fresh_fq = f"{CACHE}/reads_{tag}.fresh.fq"
    if os.path.exists(ref_fa) and os.path.exists(reads_fq) \
            and os.path.exists(fresh_fq):
        return ref_fa, reads_fq, fresh_fq
    rng = np.random.default_rng(42)
    glen = int(GENOME_MB * 1e6)
    g = rng.integers(0, 4, glen, dtype=np.int8)
    write_fasta(ref_fa, "chr1", g)
    write_reads(rng, g, reads_fq)
    # a second, never-remapped read set for the fresh-reads wall
    write_reads(np.random.default_rng(43), g, fresh_fq)
    return ref_fa, reads_fq, fresh_fq


class _Sink(io.TextIOBase):
    """Counts SAM bytes without keeping them."""

    def __init__(self):
        self.n = 0
        self.records = 0

    def write(self, s):
        self.n += len(s)
        self.records += s.count("\n")
        return len(s)


def prebuild_index(ref_fa):
    """Build the .mai once per workload (the reference's production
    flow: 'prebuilt .mai saves ~1 min/run', README.md:23). Enabled
    with BENCH_E2E_PREBUILT=1; default measures inline indexing."""
    mai = ref_fa[:-3] + ".mai.npz"
    if not os.path.exists(mai):
        from minialign_jax import cli
        rc = cli.main(["-d", mai[:-4], ref_fa])
        assert rc == 0
    return mai


def run_cli(ref_fa, reads_fq, threads=None):
    if threads is None:
        # the source/drain threads overlap parsing and printing with
        # the main thread's device waits (GIL released)
        threads = int(os.environ.get("BENCH_E2E_THREADS", "4"))
    if os.environ.get("BENCH_E2E_PREBUILT"):
        ref_fa = prebuild_index(ref_fa)
    from minialign_jax import cli
    sink = _Sink()
    old = sys.stdout
    sys.stdout = sink
    try:
        rc = cli.main([f"-t{threads}", "-xpacbio", ref_fa, reads_fq])
    finally:
        sys.stdout = old
    assert rc == 0
    return sink


def measure(profile=False):
    """Run the workload through cli.main in this process; returns the
    result row, with the JAX device the mapping ran on."""
    import jax

    from minialign_jax.native import tune_malloc
    tune_malloc()
    ref_fa, reads_fq, fresh_fq = make_workload()
    total_bases = sum(
        len(l.rstrip()) for i, l in enumerate(open(reads_fq))
        if i % 4 == 1)

    # warm run (compiles kernels for this shape set)
    t0 = time.time()
    run_cli(ref_fa, reads_fq)
    warm = time.time() - t0

    # best-of-N: host-clock noise is additive spikes, so min over runs
    # estimates the true cost
    runs = int(os.environ.get("BENCH_E2E_RUNS", "3" if not profile
                              else "1"))
    prof = cProfile.Profile() if profile else None
    wall = 1e18
    for _ in range(runs):
        t0 = time.time()
        if prof:
            prof.enable()
        sink = run_cli(ref_fa, reads_fq)
        if prof:
            prof.disable()
        wall = min(wall, time.time() - t0)

    # optional source/worker/drain overlap demonstration: -t1 wall for
    # the same workload (the -t4 headline should approach
    # max(host, device) rather than their sum)
    t1_wall = None
    if os.environ.get("BENCH_E2E_COMPARE_T"):
        t0 = time.time()
        run_cli(ref_fa, reads_fq, threads=1)
        t1_wall = time.time() - t0

    # fresh-reads wall: one warm-process pass over a read set the
    # process has NEVER seen (different seed, same profile). The
    # min-over-reps above re-maps identical bytes, which hides
    # shape-churn costs that production (always-fresh reads) pays —
    # store-shape recompiles were such a cliff (fixed by quantizing
    # band.pad_store). Keeping both numbers makes
    # the gap itself a tracked metric (fresh ≈ wall when churn is 0;
    # residual gap = one-time length-bucket compiles).
    t0 = time.time()
    run_cli(ref_fa, fresh_fq)
    fresh_wall = time.time() - t0

    mbps = total_bases / wall / 1e6
    dev = jax.devices()[0]
    out = {
        "metric": "e2e_mbases_per_s",
        "value": round(mbps, 4),
        "unit": "Mbases/s end-to-end (CLI, -xpacbio, 20kb reads)",
        "vs_baseline": round(mbps / REF_MBPS, 4),
        "reads_per_s": round(N_READS / wall, 2),
        "wall_s": round(wall, 2),
        "cold_wall_s": round(warm, 2),
        "fresh_reads_wall_s": round(fresh_wall, 2),
        "fresh_reads_mbases_per_s": round(
            total_bases / fresh_wall / 1e6, 4),
        "n_reads": N_READS,
        "total_mbases": round(total_bases / 1e6, 2),
        "sam_bytes": sink.n,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if t1_wall is not None:
        out["t1_wall_s"] = round(t1_wall, 2)
    if prof:
        st = pstats.Stats(prof, stream=sys.stderr)
        st.sort_stats("cumulative").print_stats(40)
        st.sort_stats("tottime").print_stats(30)
        st.dump_stats(os.path.join(tempfile.gettempdir(), "bench_e2e.prof"))
    return out


def main():
    print(json.dumps(measure(profile="--profile" in sys.argv)))


if __name__ == "__main__":
    main()
