"""BASELINE config 5 rehearsal at scale: hg38-scale (default 3 Gb)
genome, minimizer table HASH-RANGE-SHARDED over an 8-device mesh with
cross-shard hit merge, mapped output byte-compared against the
single-device engine, peak RSS recorded per process.

This drives the CLI auto-path (MINIALIGN_SHARD=1 + multi-device mesh
-> ShardedIndex + psum merge, parallel/shard.py) at real index scale
instead of the toy genome. The mesh is 8 virtual CPU devices — the row
demonstrates correctness + memory behavior of the sharded path at
hg38 scale, not multi-device wall-clock (`python chip_smoke.py --four`
runs the sharded path on four GPUs).

Each run rebuilds the index from FASTA in-process (the reference's
own timing methodology excludes index build; we report it
separately). Prints one JSON line. Usage:

  python bench_shard_scale.py [--gb 3.0] [--reads 12]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_accept import BASES, gen_genome, mutate_codes  # noqa: E402


def gen_sample(rng, genome, path, n_reads, mean=20000, sd=2000):
    comp = np.array([3, 2, 1, 0], np.int8)
    total = 0
    with open(path, "wb") as f:
        for i in range(n_reads):
            ln = int(np.clip(rng.normal(mean, sd), 4000,
                             genome.shape[0] - 1))
            st = int(rng.integers(0, genome.shape[0] - ln))
            err = 1.0 - float(np.clip(rng.normal(0.88, 0.07),
                                      0.70, 0.999))
            r = mutate_codes(rng, genome[st:st + ln], err)
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            seq = BASES[r].tobytes()
            f.write(b"@h38_%d\n" % i + seq + b"\n+\n"
                    + b"I" * len(seq) + b"\n")
            total += ln
    return total


def run(shard, n_dev, args):
    # CPU-pinned children: the virtual mesh
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["MINIALIGN_SHARD"] = shard
    if n_dev > 1:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_"
                            f"count={n_dev}").strip()
    t0 = time.time()
    p = subprocess.Popen(
        [sys.executable, "-m", "minialign_jax.cli"] + args,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    sam = p.stdout.read()
    _, rc, ru = os.wait4(p.pid, 0)
    p.stdout.close()
    assert os.waitstatus_to_exitcode(rc) == 0
    return sam, time.time() - t0, ru.ru_maxrss / 1e6  # GB


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=3.0)
    ap.add_argument("--reads", type=int, default=12)
    ap.add_argument("--seed", type=int, default=53)
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "g.fa")
        fq = os.path.join(td, "r.fq")
        t0 = time.time()
        # chromosome-sized records, as a real genome presents them
        n = int(args.gb * 1e9)
        with open(fa, "wb") as fh:
            pass
        chunks = []
        left, ci = n, 0
        while left > 0:
            m = min(250_000_000, left)
            g = gen_genome(rng, os.path.join(td, "c.fa"), m)
            with open(os.path.join(td, "c.fa")) as one, \
                    open(fa, "a") as out:
                one.readline()
                out.write(f">chr{ci}\n")
                for line in one:
                    out.write(line)
            chunks.append(g)
            left -= m
            ci += 1
        genome = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        del chunks
        n_bases = gen_sample(rng, genome, fq, args.reads)
        del genome
        gen_s = time.time() - t0
        print(f"generated {args.gb} Gb genome ({ci} chr) + "
              f"{args.reads} reads / {n_bases / 1e6:.1f} Mb in "
              f"{gen_s:.0f} s", file=sys.stderr)

        cli_args = ["-t1", fa, fq]
        sam1, w1, rss1 = run("0", 1, cli_args)
        print(f"single-device: {w1:.0f} s, peak {rss1:.1f} GB",
              file=sys.stderr)
        sam8, w8, rss8 = run("1", 8, cli_args)
        print(f"8-shard mesh:  {w8:.0f} s, peak {rss8:.1f} GB",
              file=sys.stderr)

    strip = lambda t: [ln for ln in t.split(b"\n")  # noqa: E731
                       if not ln.startswith(b"@PG")]
    ok = strip(sam1) == strip(sam8)
    out = {
        "config": f"BASELINE config 5 rehearsal: {args.gb} Gb genome, "
                  "hash-range-sharded minimizer table over an "
                  "8-device mesh, cross-shard hit merge",
        "n_reads": args.reads,
        "read_mbases": round(n_bases / 1e6, 1),
        "byte_identical_vs_single_device": bool(ok),
        "wall_single_s": round(w1, 1),
        "wall_sharded_s": round(w8, 1),
        "peak_rss_single_gb": round(rss1, 2),
        "peak_rss_sharded_gb": round(rss8, 2),
        "host_note": "8 virtual CPU devices; walls include the "
                     "in-process index build; correctness + memory at "
                     "hg38 scale is the claim, not multi-device speedup",
    }
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
