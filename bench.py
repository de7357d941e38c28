"""Benchmark runner: one JSON line with the headline metric — end-to-end
CLI mapping throughput (Mbases/s) — plus the banded-DP fill rates
(no-trace AND trace mode) as companion fields. Runs on an NVIDIA GPU
only; without one it exits non-zero.

Baselines (/root/reference/README.md:48-53, BASELINE.md):
  * E2E: the reference maps hg38 x3 (9.2 Gb reads) in 648 s on 4
    Skylake threads = 14.2 Mbases/s; vs_baseline = ours / 14.2.
  * fill: the same workload implies ~3.6 GCUPS of effective
    banded-DP throughput on the reference host.

Workloads:
  * fill: B x 20 kb PBSIM-profile (88% identity) extension pairs
    through the W=64 fill of the platform (the CUDA kernel).
  * e2e: bench_e2e.py's CLI run (5 Mb genome, 500 x 20 kb reads,
    -xpacbio, prebuilt index) in this process, so one process owns the
    card — BENCH_E2E_READS et al. override.

The CPU scaling harnesses (bench_scaling.py) measure the host, not the
device, and are run on their own.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_MBPS = 14.2
REF_GCUPS = 3.6


def kernel_rates():
    import jax

    from bench_e2e import pbsim_mutate
    from minialign_jax.dp import band
    from minialign_jax.extend import backend, platform_fill
    from minialign_jax.params import ScoreParams

    p = ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -4
                                 for i in range(16)),
                    gi=4, ge=2, gfa=3, gfb=3, xdrop=50)  # -xpacbio
    B = int(os.environ.get("BENCH_B", "512"))
    L = int(os.environ.get("BENCH_L", "20000"))
    rng = np.random.default_rng(0)
    a = [rng.integers(0, 4, L).astype(np.int8) for _ in range(B)]
    b = [pbsim_mutate(rng, x) for x in a]
    la = 1 << (L + band.TAIL_N + 128 - 1).bit_length()
    lb = 1 << (max(len(x) for x in b) + band.TAIL_N + 128 - 1).bit_length()

    def store(seqs):
        lens = np.asarray([len(s) for s in seqs], np.int32)
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
        return (jax.device_put(band.pad_store(np.concatenate(seqs))),
                jax.device_put(offs), jax.device_put(lens))
    args = store(a) + store(b)

    out = {}
    for trace in (False, True):
        fill = jax.jit(platform_fill(backend())(p, 64, la, lb, trace))
        r = jax.block_until_ready(fill(*args))
        best = 1e9
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fill(*args))
            best = min(best, time.perf_counter() - t0)
        n_steps = int(np.asarray((r[0] if trace else r).n_steps).sum())
        out["trace" if trace else "notrace"] = n_steps * 64 / best / 1e9
    return out


def main():
    import jax

    import bench_e2e
    from minialign_jax.native import tune_malloc
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX platform {dev.platform!r})")
    tune_malloc()
    k = kernel_rates()
    # prebuilt index: the baseline numbers exclude index-build time
    # ('Index-build time excluded from timings', BASELINE.md)
    os.environ["BENCH_E2E_PREBUILT"] = "1"
    e = bench_e2e.measure()
    if e["device"]["platform"] != "gpu":
        sys.exit(f"bench: the e2e run did not map on the GPU: {e['device']}")
    out = {
        "metric": "e2e_mbases_per_s",
        "value": e["value"],
        "unit": "Mbases/s end-to-end (CLI -xpacbio, 20 kb reads; "
                "fill GCUPS in companion fields)",
        "vs_baseline": e["vs_baseline"],
        "device": e["device"],
        "reads_per_s": e["reads_per_s"],
        "e2e_wall_s": e["wall_s"],
        "e2e_cold_wall_s": e["cold_wall_s"],
        "e2e_fresh_reads_wall_s": e["fresh_reads_wall_s"],
        "kernel_gcups_notrace": k["notrace"],
        "kernel_gcups_trace": k["trace"],
        "kernel_vs_ref_gcups": k["notrace"] / REF_GCUPS,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
