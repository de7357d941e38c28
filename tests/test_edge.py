"""Edge-case robustness: inputs the reference handles (or declares)
must not crash the CLI, and unmappable reads come out as unmapped
records."""

import io
import os
import sys

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


def _run(args):
    from minialign_jax import cli
    out = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        rc = cli.main(args)
    finally:
        sys.stdout = old
    return rc, out.getvalue()


def test_empty_query_file(tmp_path):
    q = tmp_path / "empty.fq"
    q.write_text("")
    rc, out = _run(["-t1", f"{DATA}/tref.fa", str(q)])
    assert rc == 0
    assert all(l.startswith("@") for l in out.splitlines())


def test_reads_shorter_than_k(tmp_path):
    q = tmp_path / "short.fq"
    q.write_text("@tiny\nACGTACGT\n+\nIIIIIIII\n")
    rc, out = _run(["-t1", f"{DATA}/tref.fa", str(q)])
    assert rc == 0
    recs = [l for l in out.splitlines() if not l.startswith("@")]
    assert len(recs) == 1 and recs[0].split("\t")[1] == "4"  # unmapped


def test_n_bases_and_whitespace(tmp_path):
    ref = tmp_path / "r.fa"
    seq = "".join("ACGT"[i % 4] for i in range(400))
    ref.write_text(f">r desc\n{seq[:200]}\n\n{seq[200:]}\n")
    q = tmp_path / "q.fa"
    q.write_text(f">q\nNNN{seq[50:150]}NNNN\n")
    rc, out = _run(["-t1", "-s20", str(ref), str(q)])
    assert rc == 0
    recs = [l for l in out.splitlines() if not l.startswith("@")]
    assert len(recs) >= 1


def test_unmappable_read(tmp_path):
    rng = np.random.default_rng(1)
    q = tmp_path / "rand.fq"
    s = "".join("ACGT"[i] for i in rng.integers(0, 4, 500))
    q.write_text(f"@noise\n{s}\n+\n{'I' * len(s)}\n")
    rc, out = _run(["-t1", f"{DATA}/tref.fa", str(q)])
    assert rc == 0
    recs = [l for l in out.splitlines() if not l.startswith("@")]
    assert recs and recs[0].split("\t")[1] == "4"


def test_crlf_and_multiline_fastq(tmp_path):
    q = tmp_path / "crlf.fq"
    body = ("@r1 c\r\n" + "ACGT" * 30 + "\r\n" + "ACGT" * 10 + "\r\n"
            + "+\r\n" + "I" * 120 + "\r\n" + "J" * 40 + "\r\n")
    q.write_bytes(body.encode())
    from minialign_jax.io import bseq
    seqs = list(bseq.read_seqs(str(q), keep_qual=True))
    assert len(seqs) == 1
    assert len(seqs[0].codes) == 160
    assert seqs[0].qual == b"I" * 120 + b"J" * 40


def test_min_len_filter(tmp_path):
    q = tmp_path / "mix.fq"
    q.write_text("@a\nACGTACGTACGTACGTACGT\n+\n" + "I" * 20 + "\n"
                 "@b\nACG\n+\nIII\n")
    from minialign_jax.io import bseq
    assert len(list(bseq.read_seqs(str(q), min_len=10))) == 1


def test_bseq_fasta_spec(tmp_path):
    """The reference's (disabled) bseq.fasta unittest literals
    (minialign.c:2166-2226): space-after-'>', CRLF, empty lines,
    trailing-space comments."""
    from minialign_jax.io import bseq
    fa = tmp_path / "spec.fa"
    fa.write_bytes(b">test0\nAAAA\n"
                   b"> test1\nATAT\nCGCG\r\n\r\n"
                   b">  test2\n\nAAAA\n"
                   b">test3 comment comment  \nACGT\n\n")
    seqs = list(bseq.read_seqs(str(fa), tags=("CO",)))
    assert [s.name for s in seqs] == ["test0", "test1", "test2", "test3"]
    assert list(seqs[0].codes) == [0, 0, 0, 0]
    assert list(seqs[1].codes) == [0, 3, 0, 3, 1, 2, 1, 2]
    assert list(seqs[2].codes) == [0, 0, 0, 0]
    assert list(seqs[3].codes) == [0, 1, 2, 3]
    assert seqs[3].tags == ["CO:Z:comment comment"]
    assert seqs[0].tags == []


def test_bseq_fastq_spec(tmp_path):
    """The reference's (disabled) bseq.fastq unittest literals
    (minialign.c:2228-2290): '+' lines with text, quals containing
    '@'/'+', multi-line seq and qual, empty lines."""
    from minialign_jax.io import bseq
    fq = tmp_path / "spec.fq"
    fq.write_bytes(b"@test0\nAAAA\n+test0\nNNNN\n"
                   b"@ test1\nATAT\nCGCG\n+ test1\n12+3\n+123\r\n"
                   b"@  test2\n\nAAAA\n+  test2\n\n\n12@3\n\n"
                   b"@test3  comment comment   \nACGT\n\n+ test3\n@123")
    seqs = list(bseq.read_seqs(str(fq), keep_qual=True, tags=("CO",)))
    assert [s.name for s in seqs] == ["test0", "test1", "test2", "test3"]
    assert list(seqs[1].codes) == [0, 3, 0, 3, 1, 2, 1, 2]
    assert seqs[0].qual == b"NNNN"
    assert seqs[1].qual == b"12+3+123"
    assert seqs[2].qual == b"12@3"
    assert seqs[3].qual == b"@123"
    assert seqs[3].tags == ["CO:Z:comment comment"]



def test_former_package_name_runs_cli():
    """The package's former name still runs the CLI with `python -m`."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    alias = [d for d in os.listdir(root) if d.startswith("minialign_")
             and d != "minialign_jax"
             and os.path.isfile(os.path.join(root, d, "cli.py"))]
    assert len(alias) == 1
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-m", alias[0] + ".cli", "-t1",
                        f"{DATA}/tref.fa", f"{DATA}/treads.fq"],
                       capture_output=True, text=True, env=env, cwd=root,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = open(f"{DATA}/ref_out.sam").read()
    strip = lambda t: [ln for ln in t.splitlines()  # noqa: E731
                       if not ln.startswith("@PG")]
    assert strip(r.stdout) == strip(want)
