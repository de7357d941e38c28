"""Index-construction scale benchmark: builds the minimizer index for a
synthetic genome (default 1 Gb) and reports build rate + peak RSS.

Reference baseline: ~1 min/Gb for hg38 on 4 Skylake threads
(/root/reference/README.md:23 prebuilt-index note; 3-phase pt pipeline,
minialign.c:2750-2997).

Usage: python bench_index.py [--gb 1.0]
Prints one JSON line {"metric": "index_build_mbases_per_s", ...}.
"""

import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    from minialign_jax.native import tune_malloc
    tune_malloc()
    gb = 1.0
    if "--gb" in sys.argv:
        gb = float(sys.argv[sys.argv.index("--gb") + 1])
    n = int(gb * 1e9)

    from minialign_jax.index.build import build_index
    from minialign_jax.params import IndexParams

    rng = np.random.default_rng(7)
    # chromosome-sized chunks, as a real genome presents them
    chunk = 250_000_000
    names, codes = [], []
    left = n
    i = 0
    while left > 0:
        ln = min(chunk, left)
        codes.append(rng.integers(0, 4, ln, dtype=np.int8))
        names.append(f"chr{i + 1}")
        left -= ln
        i += 1

    ip = IndexParams(k=15, w=10)
    t0 = time.time()
    mi = build_index(ip, names, codes)
    dt = time.time() - t0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    # sanity: lookups over a sampled read round-trip
    s = codes[0][: 10_000].astype(np.int64)
    from minialign_jax.index.sketch import sketch
    h, _, _ = sketch(s, ip.k, ip.w)
    _, cnt = mi.lookup(h)
    assert (cnt > 0).all(), "sampled lookups must hit"

    mbps = n / dt / 1e6
    print(json.dumps({
        "metric": "index_build_mbases_per_s",
        "value": round(mbps, 2),
        "unit": "Mbases/s index construction",
        "vs_baseline": round(mbps / (1e9 / 60 / 1e6), 3),
        "wall_s": round(dt, 1),
        "peak_rss_gb": round(peak_gb, 2),
        "genome_gb": gb,
        "n_minimizers": int(len(mi.vals_pos)),
        "n_keys": int(len(mi.keys)),
    }))


if __name__ == "__main__":
    main()
