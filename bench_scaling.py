"""Multi-host scaling benchmark (BASELINE north star: >=80% reads/s
efficiency from 1 host to >=2): wall-clock for a fixed mapping
workload with ONE process vs TWO real jax.distributed CPU processes
(round-robin batch shares, merged byte-identically — the same path
tests/test_distributed.py proves correct).

Efficiency = t1 / (n_hosts * t_n). NOTE the honest caveat: on a
single-core dev VM two CPU processes share one core, so the ceiling
here is ~0.5 regardless of the framework — the number demonstrates
the harness, not the hardware. On a real multi-host deployment each
process owns its devices/cores and the per-host work is embarrassingly
parallel until the ordered merge.

Prints one JSON line; bench.py embeds it as a companion field.
"""

import io
import json
import os

# everything here is a host-side harness: pin this process (and the
# merge step's index load) to CPU
os.environ["JAX_PLATFORMS"] = "cpu"

import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "tests", "data")
TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "tests", "tools")
# enough batch granularity that (a) round-robin shares balance and
# (b) in-loop lazy XLA compiles are amortized by real mapping work
REPS = int(os.environ.get("BENCH_SCALING_REPS", "48"))


def _env():
    # this harness is CPU-only by design
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["MINIALIGN_DIST_WARM"] = "1"   # steady-state mapping timing
    return env


def device_axis():
    """Device-axis scaling row: the same mapping
    workload through the 8-device virtual CPU mesh (ShardedFillEngine
    + hash-range ShardedIndex) vs the single-device engine, as a throughput ratio. HONEST
    caveat, same as the host axis: the dev VM has ONE core, so all 8
    virtual devices share it and the wall-clock speedup ceiling is
    1.0 (not 8) — the row demonstrates the mesh path's overhead vs
    the single-device engine at equal silicon, not real-chip scaling.
    busy ratio (CPU seconds, scheduler-independent) shows how much
    extra work the mesh path spends. Prints one JSON line."""
    reps = int(os.environ.get("BENCH_DEVAXIS_REPS", "12"))
    with tempfile.TemporaryDirectory() as td:
        reads = os.path.join(td, "reads.fq")
        with open(reads, "w") as f:
            f.write(open(f"{DATA}/treads.fq").read() * reps)
        args = ["-t1", "-165537", f"{DATA}/tref.fa", reads]

        def run(n_dev):
            env = _env()
            env.pop("MINIALIGN_PROC_WORKERS", None)
            if n_dev > 1:
                env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                                    " --xla_force_host_platform_"
                                    f"device_count={n_dev}").strip()
                env["MINIALIGN_SHARD"] = "1"
            else:
                env["MINIALIGN_SHARD"] = "0"
            outs = []
            for _ in range(2):      # 2nd run rides the compile cache
                t0 = time.time()
                p = subprocess.Popen(
                    [sys.executable, "-m", "minialign_jax.cli"] + args,
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL)
                sam = p.stdout.read()
                _, rc, ru = os.wait4(p.pid, 0)
                p.stdout.close()
                assert os.waitstatus_to_exitcode(rc) == 0
                outs.append((time.time() - t0,
                             ru.ru_utime + ru.ru_stime, sam))
            return outs[-1]

        w1, b1, sam1 = run(1)
        w8, b8, sam8 = run(8)
    ok = sam1 == sam8
    print(json.dumps({
        "metric": "device_axis_8dev_throughput_ratio",
        "value": round(w1 / w8, 4) if w8 > 0 else 0.0,
        "unit": "wall(1 device) / wall(8-device mesh), same workload, "
                "virtual CPU devices on one shared core",
        "wall_1dev_s": round(w1, 2),
        "wall_8dev_s": round(w8, 2),
        "busy_1dev_s": round(b1, 2),
        "busy_8dev_s": round(b8, 2),
        "busy_ratio_8_over_1": round(b8 / b1, 4) if b1 > 0 else 0.0,
        "byte_identical": bool(ok),
        "host_cores": os.cpu_count(),
        "note": "8 virtual devices share 1 physical core: wall "
                "speedup ceiling is 1.0 by construction; the ratio "
                "reports mesh-path overhead at equal silicon, the "
                "busy ratio reports extra CPU work spent by the "
                "sharded path (cross-shard merge, psum)",
    }))


def main():
    with tempfile.TemporaryDirectory() as td:
        reads = os.path.join(td, "reads.fq")
        with open(reads, "w") as f:
            f.write(open(f"{DATA}/treads.fq").read() * REPS)
        args = ["-t1", "-165537", f"{DATA}/tref.fa", reads]

        # single host = the same per-host worker with n_hosts=1, so
        # both sides measure the identical mapping phase. Busy time
        # (CPU seconds) is scheduler-independent: on a shared-core VM
        # the wall clock conflates scheduling, CPU time does not.
        one_out = os.path.join(td, "one.out")
        t0 = time.time()
        p1 = subprocess.Popen(
            [sys.executable, os.path.join(TOOLS, "dist_host.py"),
             "0", "1", "", one_out] + args,
            env=_env(), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE)
        err1 = p1.stderr.read()
        _, rc1, ru1 = os.wait4(p1.pid, 0)
        p1.returncode = os.waitstatus_to_exitcode(rc1)
        p1.stderr.close()
        t1 = time.time() - t0
        busy1 = ru1.ru_utime + ru1.ru_stime
        assert p1.returncode == 0, err1.decode()[-2000:]
        map1 = json.load(open(one_out + ".stats"))["busy_map_s"]
        one = os.path.join(td, "one.sam")
        with open(one, "w") as f:
            from minialign_jax.parallel import distributed as _d
            _d.merge_host_outputs(args, [one_out], f)

        # two jax.distributed processes; per-host busy time via wait4
        port = 12421
        outs = [os.path.join(td, f"h{h}.out") for h in (0, 1)]
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(TOOLS, "dist_host.py"),
             str(h), "2", f"localhost:{port}", outs[h]] + args,
            env=_env(), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE) for h in (0, 1)]
        errs = [p.stderr.read() for p in procs]
        busy2 = []
        for p in procs:
            _, rc, ru = os.wait4(p.pid, 0)
            p.returncode = os.waitstatus_to_exitcode(rc)
            p.stderr.close()
            busy2.append(ru.ru_utime + ru.ru_stime)
        t2 = time.time() - t0
        for p, e in zip(procs, errs):
            assert p.returncode == 0, e.decode()[-2000:]

        # merged two-host output must equal the single-process bytes
        from minialign_jax.parallel import distributed
        buf = io.StringIO()
        distributed.merge_host_outputs(args, outs, buf)
        ok = buf.getvalue() == open(one).read()
        map2 = [json.load(open(o + ".stats"))["busy_map_s"]
                for o in outs]

    eff_wall = t1 / (2 * t2) if t2 > 0 else 0.0
    # mapping-phase busy-time efficiency: t1_map_cpu /
    # (n * max_host_map_cpu). Per-process CPU time is scheduler-
    # independent and the mapping phase excludes per-process fixed
    # startup (interpreter, jax init, index load, compiles), so this
    # is the defensible scaling figure on a shared-core VM: it asks "did splitting the work double any host's CPU
    # bill for the work itself?" — perfect splitting gives
    # max_host_map = map1/2 and efficiency 1.0.
    eff_map = map1 / (2 * max(map2)) if max(map2) > 0 else 0.0
    eff_busy = busy1 / (2 * max(busy2)) if max(busy2) > 0 else 0.0
    print(json.dumps({
        "metric": "scaling_1to2_efficiency",
        "value": round(eff_map, 4),
        "unit": "mapping-phase busy time: t1_map_cpu / "
                "(2 * max_host_map_cpu), jax.distributed CPU processes",
        "t1_s": round(t1, 2),
        "t2_s": round(t2, 2),
        "map1_busy_s": round(map1, 2),
        "map2_busy_s": [round(x, 2) for x in map2],
        "proc_busy_efficiency": round(eff_busy, 4),
        "t1_busy_s": round(busy1, 2),
        "t2_busy_s": [round(x, 2) for x in busy2],
        "wall_efficiency": round(eff_wall, 4),
        "host_cores": os.cpu_count(),
        "byte_identical_merge": bool(ok),
        "note": "wall_efficiency is confounded on a shared-core VM "
                "(two processes, one core: ceiling ~0.5) and "
                "proc_busy_efficiency still carries per-process fixed "
                "startup; the mapping-phase figure counts CPU seconds "
                "of the work itself, which the scheduler cannot "
                "inflate",
    }))


if __name__ == "__main__":
    if "--device-axis" in sys.argv:
        device_axis()
    else:
        main()
