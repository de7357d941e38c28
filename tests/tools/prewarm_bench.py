"""Prewarm evidence: measure fresh-process mapping startup with an
EMPTY persistent compile cache vs after `python -m
minialign_jax.prewarm`, on the CPU backend.

Protocol: point JAX_COMPILATION_CACHE_DIR at a fresh tmp dir, (1) time
a cold fresh-process CLI mapping (pays every jit compile), (2) run the
prewarm command once, (3) time the same fresh-process mapping again —
now riding the cache the prewarm populated. Reference startup is
~0.1 s (minialign.c:6213-6483); the north star was <=15 s.

Prints one JSON line.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "tests", "data")


def run_cli(env, args):
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "minialign_jax.cli"]
                       + args, env=env, cwd=ROOT,
                       stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
    assert r.returncode == 0
    return time.time() - t0


def main():
    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["JAX_COMPILATION_CACHE_DIR"] = cache
        args = ["-t1", f"{DATA}/tref.fa", f"{DATA}/treads.fq"]

        cold = run_cli(env, args)

        t0 = time.time()
        # lengths spanning the workload's shape buckets (treads.fq is
        # 2.1-3.9 kb reads)
        r = subprocess.run(
            [sys.executable, "-m", "minialign_jax.prewarm",
             "3900", "2500"],
            env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        assert r.returncode == 0
        prewarm_s = time.time() - t0

        warm = run_cli(env, args)

    out = {
        "metric": "prewarm_fresh_process_wall_s",
        "cold_fresh_process_s": round(cold, 2),
        "prewarm_cmd_s": round(prewarm_s, 2),
        "warm_fresh_process_s": round(warm, 2),
        "backend": "cpu",
        "host_cores": os.cpu_count(),
        "note": "cold pays every jit compile at first contact; warm "
                "rides the cache the prewarm populated. The residual "
                "warm wall is interpreter+jax import+index build+the "
                "mapping itself on this host, not compiles.",
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
