"""Deployment prewarm: compile the fill/trace kernel lattice ahead of
first contact.

    python -m minialign_jax.prewarm [-x preset ...] [read lengths...]

Maps a tiny synthetic workload (random mini-reference + reads at the
given lengths, default 20000 and 4000) through the normal pipeline
with the given options, discarding output. Shape buckets depend only
on padded lengths, so this populates exactly the jit/persistent-cache
entries a production run at those read lengths needs: fresh processes
then start at cache speed instead of paying the kernel compiles at
first contact (~0.1 s reference startup is the north star).

Notes: the persistent JAX compilation cache (minialign_jax/__init__.py)
makes this survive across processes."""

from __future__ import annotations

import io
import sys
import time

import numpy as np


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    lens = [int(a) for a in argv if a.isdigit()] or [20000, 4000]
    opts = [a for a in argv if not a.isdigit()]

    from . import cli

    rng = np.random.default_rng(0)
    glen = max(lens) * 2 + 10000
    bases = "ACGT"
    ref = "".join(bases[c] for c in rng.integers(0, 4, glen))
    reads = []
    for li, L in enumerate(lens):
        s0 = int(rng.integers(0, glen - L))
        seq = list(ref[s0:s0 + L])
        # PBSIM-profile mutations so the fills terminate realistically
        for k in range(len(seq)):
            r = rng.random()
            if r < 0.06:
                seq[k] = bases[int(rng.integers(0, 4))]
        reads.append("".join(seq))

    import tempfile

    with tempfile.TemporaryDirectory() as td:
        ref_fa = f"{td}/ref.fa"
        reads_fq = f"{td}/reads.fq"
        with open(ref_fa, "w") as f:
            f.write(f">prewarm_ref\n{ref}\n")
        with open(reads_fq, "w") as f:
            for i, r in enumerate(reads):
                f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
        t0 = time.time()
        old = sys.stdout
        sys.stdout = io.StringIO()
        try:
            rc = cli.main(opts + [ref_fa, reads_fq])
        finally:
            sys.stdout = old
        print(f"[minialign] prewarm done in {time.time() - t0:.1f} s "
              f"(lengths {lens}, opts {opts or ['<default>']})",
              file=sys.stderr)
        return rc


if __name__ == "__main__":
    raise SystemExit(main())
