"""Parity fuzzer: random (reference, reads, options) cases run through
both the reference binary and minialign-jax, outputs diffed byte-wise
(modulo @PG and the documented reverse-strand MD bug, PARITY.md 1).

Usage: python tests/tools/fuzz_parity.py <ref_binary> [n_cases] [seed]
Writes failing cases to /tmp/fuzz_fail_<case>/ for replay.
"""

import os
import random
import shutil
import subprocess
import sys
import tempfile

import numpy as np

BASES = "ACGT"

# CPU-pin the CLI children: fuzz cases are semantics checks
ENV = dict(os.environ)
ENV["JAX_PLATFORMS"] = "cpu"


def rnd_seq(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def mutate(rng, s, err):
    out = []
    for ch in s:
        r = rng.random()
        if r < err * 0.4:
            out.append(BASES[rng.integers(4)])
        elif r < err * 0.7:
            pass
        elif r < err:
            out.append(ch)
            out.append(BASES[rng.integers(4)])
        else:
            out.append(ch)
    return "".join(out)


def rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def gen_case(rng, d):
    n_chr = int(rng.integers(1, 4))
    chrs = {}
    with open(f"{d}/ref.fa", "w") as f:
        for c in range(n_chr):
            n = int(rng.integers(8000, 40000))
            s = rnd_seq(rng, n)
            # sometimes embed a repeat
            if rng.random() < 0.3:
                u = rnd_seq(rng, int(rng.integers(200, 800)))
                s = s[:n // 2] + u * int(rng.integers(3, 8)) + s[n // 2:]
            chrs[f"c{c}"] = s
            f.write(f">c{c}\n")
            for i in range(0, len(s), 80):
                f.write(s[i:i + 80] + "\n")
    err = float(rng.uniform(0.03, 0.18))
    wrap = rng.random() < 0.25          # pair with the -cc0 option
    with open(f"{d}/reads.fq", "w") as f:
        for i in range(int(rng.integers(3, 10))):
            cn = f"c{int(rng.integers(n_chr))}"
            cs = chrs[cn]
            ln = int(rng.integers(500, min(5000, len(cs) - 10)))
            if wrap and cn == "c0" and rng.random() < 0.4:
                # origin-wrapping read (meaningful under -cc0)
                st = int(rng.integers(len(cs) - ln + ln // 4,
                                      len(cs) - 100))
                src = (cs + cs)[st:st + ln]
            else:
                st = int(rng.integers(0, len(cs) - ln))
                src = cs[st:st + ln]
            r = mutate(rng, src, err)
            if rng.random() < 0.5:
                r = rc(r)
            f.write(f"@r{i}_{cn}_{st}\n{r}\n+\n{'I' * len(r)}\n")

    opts = ["-t1"]
    choice = rng.random()
    if choice < 0.25:
        opts.append(rng.choice(["-xpacbio", "-xont.r9.4.1d",
                                "-xont.1dsq", "-xpacbio.ccs"]))
    elif choice < 0.6:
        a = int(rng.integers(1, 4))
        b = int(rng.integers(1, min(2 * a + 2, 6)))
        gi = int(rng.integers(0, 6))
        ge = int(rng.integers(1, 3))
        opts += [f"-a{a}", f"-b{b}", f"-p{gi}", f"-q{ge}"]
        if rng.random() < 0.5 and gi > 0:
            gf = int(rng.integers(ge + 1, ge + 3))
            if b > gf - ge:      # gf sum constraint
                opts.append(f"-r{gf},{gf}")
    if rng.random() < 0.3:
        opts.append("-s" + str(int(rng.integers(20, 80))))
    if rng.random() < 0.3:
        opts.append("-m0." + str(int(rng.integers(1, 6))))
    if rng.random() < 0.25:
        opts += ["-k" + str(int(rng.integers(10, 17))),
                 "-w" + str(int(rng.integers(3, 14)))]
    if wrap:
        # circular reference (named form: a bare -c would consume the
        # following positional as its optional argument)
        opts.append("-cc0")
    fmt = rng.choice(["sam", "sam", "sam", "paf", "blast6", "maf"])
    if fmt != "sam":
        opts.append("-O" + fmt)
    elif rng.random() < 0.4:
        opts.append("-TAS,NM,XS,NH")
    return opts


def strip(text, is_sam):
    lines = [l for l in text.splitlines() if not l.startswith("@PG")]
    if is_sam:
        lines = ["\t".join(f for f in l.split("\t")
                           if not f.startswith("MD:Z:"))
                 for l in lines]
    return "\n".join(lines)


def main():
    ref_bin = sys.argv[1]
    n_cases = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    fails = 0
    for case in range(n_cases):
        rng = np.random.default_rng(seed * 10000 + case)
        d = tempfile.mkdtemp(prefix="fuzzp_")
        opts = gen_case(rng, d)
        is_sam = not any(o.startswith("-O") for o in opts)
        use_mai = case % 4 == 3        # prebuilt-index round trip
        if case % 5 == 2:              # all-vs-all over the read set
            opts = ["-t1", "-X", "-xava", "-Opaf"]
            is_sam = False
            use_mai = False
        cmd_ref = [ref_bin] + opts + [f"{d}/ref.fa", f"{d}/reads.fq"]
        cmd_our = [sys.executable, "-m", "minialign_jax.cli"] + opts + \
            [f"{d}/ref.fa", f"{d}/reads.fq"]
        if case % 5 == 2:
            cmd_ref = cmd_ref[:-2] + [f"{d}/reads.fq"]
            cmd_our = cmd_our[:-2] + [f"{d}/reads.fq"]
        if use_mai:
            subprocess.run([ref_bin] + opts
                           + ["-d", f"{d}/r.mai", f"{d}/ref.fa"],
                           capture_output=True, timeout=120)
            subprocess.run([sys.executable, "-m", "minialign_jax.cli"]
                           + opts + ["-d", f"{d}/o.mai", f"{d}/ref.fa"],
                           capture_output=True, timeout=1200, env=ENV)
            cmd_ref = [ref_bin] + opts + [f"{d}/r.mai", f"{d}/reads.fq"]
            cmd_our = [sys.executable, "-m", "minialign_jax.cli"] + \
                opts + [f"{d}/o.mai", f"{d}/reads.fq"]
        r1 = subprocess.run(cmd_ref, capture_output=True, text=True,
                            timeout=120)
        r2 = subprocess.run(cmd_our, capture_output=True, text=True,
                            timeout=1200, env=ENV)
        if r1.returncode < 0 or r1.returncode == 139:
            # the reference binary itself crashes on some valid
            # parameter sets (e.g. -a1 -b2 -p5 -q1; PARITY.md item 9)
            print(f"case {case}: SKIP (reference crashed, "
                  f"rc={r1.returncode}) {' '.join(opts)}", flush=True)
            shutil.rmtree(d, ignore_errors=True)
            continue
        ok = (strip(r1.stdout, is_sam) == strip(r2.stdout, is_sam)
              and (r1.returncode == 0) == (r2.returncode == 0))
        print(f"case {case}: {'OK ' if ok else 'FAIL'} "
              f"{' '.join(opts)}", flush=True)
        if not ok:
            fails += 1
            keep = f"/tmp/fuzz_fail_{case}"
            shutil.copytree(d, keep, dirs_exist_ok=True)
            with open(f"{keep}/cmds.txt", "w") as f:
                f.write(" ".join(cmd_ref) + "\n" + " ".join(cmd_our)
                        + "\n")
            with open(f"{keep}/ref.out", "w") as f:
                f.write(r1.stdout)
            with open(f"{keep}/our.out", "w") as f:
                f.write(r2.stdout)
        shutil.rmtree(d, ignore_errors=True)
    print(f"{n_cases - fails}/{n_cases} identical")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
