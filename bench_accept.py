"""Acceptance config 1 at REAL size (BASELINE.md row 1).

The reference's headline benchmark is E.coli MG1655 + PBSIM x100
simulated PacBio reads — 460 Mb of reads — mapped with `-xpacbio`
(reference README.md:48: 10.0 s on a 4-thread i5-6260U). This harness
reproduces that config at full size on this machine:

  1. generate an E.coli-sized genome (4,641,652 bp, seeded RNG — the
     judge's fresh-case protocol also uses random genomes) and x100
     coverage of PBSIM-profile reads (len ~ N(20k, 2k), accuracy
     ~ N(0.88, 0.07), error split sub/ins/del = 40/30/30 as in
     tests/tools/fuzz_parity.py::mutate, both strands),
  2. run the reference binary and minialign-jax on identical inputs,
  3. byte-compare the SAM streams (modulo @PG) and report both walls.

Prints one JSON line. Usage:

  python bench_accept.py [--cov 100] [--ref-bin /tmp/refbuild/minialign]
                         [--dir /tmp/accept1] [--keep]

The reference binary is built once from /root/reference (see
.claude/skills/verify/SKILL.md). The host's core count is recorded next
to the numbers (the reference row used 4 Skylake threads).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ECOLI_LEN = 4_641_652          # E.coli K-12 MG1655 genome length
BASES = np.frombuffer(b"ACGT", np.uint8)


def gen_genome(rng, path, n=ECOLI_LEN):
    codes = rng.integers(0, 4, n, dtype=np.int8)
    seq = BASES[codes]
    with open(path, "wb") as f:
        f.write(b">ecoli_sim\n")
        for i in range(0, n, 80):
            f.write(seq[i:i + 80].tobytes() + b"\n")
    return codes


def mutate_codes(rng, src, err):
    """Vectorized PBSIM-style mutation of a 0..3 code array: per base,
    P(sub)=0.4*err, P(del)=0.3*err, P(ins-after)=0.3*err (the
    fuzz_parity.py mutate model at array speed)."""
    n = src.shape[0]
    r = rng.random(n)
    sub = r < err * 0.4
    dele = (r >= err * 0.4) & (r < err * 0.7)
    ins = (r >= err * 0.7) & (r < err)
    out_src = np.where(sub, rng.integers(0, 4, n, dtype=np.int8), src)
    counts = np.ones(n, np.int64)
    counts[dele] = 0
    counts[ins] = 2
    total = int(counts.sum())
    out = np.empty(total, np.int8)
    start = np.cumsum(counts) - counts
    keep = counts >= 1
    out[start[keep]] = out_src[keep]
    ins_pos = start[ins] + 1
    out[ins_pos] = rng.integers(0, 4, ins_pos.shape[0], dtype=np.int8)
    return out


def gen_reads(rng, genome, path, cov, mean=20000, sd=2000,
              acc_mean=0.88, acc_sd=0.07):
    glen = genome.shape[0]
    target = cov * glen
    emitted = 0
    i = 0
    comp = np.array([3, 2, 1, 0], np.int8)
    with open(path, "wb") as f:
        while emitted < target:
            ln = int(np.clip(rng.normal(mean, sd), 1000, glen - 1))
            st = int(rng.integers(0, glen - ln))
            err = 1.0 - float(np.clip(rng.normal(acc_mean, acc_sd),
                                      0.70, 0.999))
            r = mutate_codes(rng, genome[st:st + ln], err)
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            seq = BASES[r].tobytes()
            f.write(b"@S1_%d\n" % i + seq + b"\n+\n"
                    + b"I" * len(seq) + b"\n")
            emitted += ln
            i += 1
    return i, emitted


def build_ref_bin():
    out = "/tmp/refbuild/minialign"
    if os.path.exists(out):
        return out
    shutil.copytree("/root/reference", "/tmp/refbuild",
                    dirs_exist_ok=True)
    subprocess.run(["make", "-j4"], cwd="/tmp/refbuild", check=True,
                   capture_output=True)
    return out


def run_timed(cmd, out_path, env=None):
    t0 = time.time()
    with open(out_path, "wb") as f:
        r = subprocess.run(cmd, stdout=f, stderr=subprocess.DEVNULL,
                           env=env)
    return time.time() - t0, r.returncode


def sam_equal_mod_pg(a, b):
    """Byte-compare two SAM files skipping @PG header lines."""
    rc = subprocess.run(
        ["bash", "-c",
         'cmp -s <(grep -v "^@PG" "%s") <(grep -v "^@PG" "%s")'
         % (a, b)]).returncode
    return rc == 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cov", type=int, default=100)
    ap.add_argument("--dir", default="/tmp/accept1")
    ap.add_argument("--ref-bin", default=None)
    ap.add_argument("--seed", type=int, default=51)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="reuse existing inputs + ref.sam in --dir")
    args = ap.parse_args()

    d = args.dir
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    ref_fa = os.path.join(d, "ecoli.fa")
    reads = os.path.join(d, "reads.fq")

    meta = os.path.join(d, "meta.json")
    if args.resume and os.path.exists(meta):
        with open(meta) as f:
            m = json.load(f)
        n_reads, n_bases, ref_wall, rc1 = (
            m["n_reads"], m["n_bases"], m["ref_wall"], 0)
    else:
        t0 = time.time()
        genome = gen_genome(rng, ref_fa)
        n_reads, n_bases = gen_reads(rng, genome, reads, args.cov)
        print(f"generated {n_reads} reads / {n_bases / 1e6:.1f} Mbases "
              f"in {time.time() - t0:.1f} s", file=sys.stderr)

        ref_bin = args.ref_bin or build_ref_bin()
        ref_wall, rc1 = run_timed(
            [ref_bin] + ["-t4", "-xpacbio", ref_fa, reads],
            os.path.join(d, "ref.sam"))
        print(f"reference: {ref_wall:.1f} s (rc={rc1})", file=sys.stderr)
        with open(meta, "w") as f:
            json.dump({"n_reads": n_reads, "n_bases": n_bases,
                       "ref_wall": ref_wall}, f)
    opts = ["-t4", "-xpacbio"]

    our_wall, rc2 = run_timed(
        [sys.executable, "-m", "minialign_jax.cli"] + opts
        + [ref_fa, reads], os.path.join(d, "ours.sam"))
    print(f"ours: {our_wall:.1f} s (rc={rc2})", file=sys.stderr)

    ok = (rc1 == 0 and rc2 == 0 and sam_equal_mod_pg(
        os.path.join(d, "ref.sam"), os.path.join(d, "ours.sam")))

    res = {
        "config": "BASELINE config 1: E.coli-size genome + PBSIM-"
                  f"profile x{args.cov} (-xpacbio), REAL size",
        "n_reads": n_reads,
        "read_mbases": round(n_bases / 1e6, 1),
        "parity": "byte-identical modulo @PG" if ok else "MISMATCH",
        "ref_wall_s_this_host": round(ref_wall, 1),
        "our_wall_s": round(our_wall, 1),
        "our_mbases_per_s": round(n_bases / 1e6 / our_wall, 3),
        "our_reads_per_s": round(n_reads / our_wall, 1),
        "ref_published_wall_s": 10.0,
        "host_note": f"{os.cpu_count()} core(s); reference published "
                     "row used 4 Skylake threads",
    }
    print(json.dumps(res))
    if not args.keep:
        shutil.rmtree(d, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
