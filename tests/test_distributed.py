"""Multi-host data-parallel mapping: two real jax.distributed CPU
processes each map half the batches; merge_host_outputs restores
global order and the cross-host stale-rlen chain, and the result must
be byte-identical to the single-process CLI output (SURVEY.md §2.6
multi-host data parallelism)."""

import io
import os
import subprocess
import sys

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
TOOLS = os.path.join(os.path.dirname(__file__), "tools")

def _args(reads_path):
    # smallest legal batch (>64k, mm_opt_batch) so the repeated read
    # set splits into several ranks across hosts
    return ["-t1", "-165537", f"{DATA}/tref.fa", str(reads_path)]


def _single_process_output(args):
    from minialign_jax import cli
    out = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        rc = cli.main(list(args))
    finally:
        sys.stdout = old
    assert rc == 0
    return out.getvalue()


@pytest.mark.slow
def test_two_host_merge_byte_identical(tmp_path):
    reads = tmp_path / "reads6.fq"
    reads.write_text(open(f"{DATA}/treads.fq").read() * 6)
    ARGS = _args(reads)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)   # one device per process is fine
    coord = "127.0.0.1:19733"
    procs = []
    outs = []
    for hid in range(2):
        out = str(tmp_path / f"host{hid}.out")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(TOOLS, "dist_host.py"),
             str(hid), "2", coord, out] + ARGS,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err.decode()[-2000:]

    from minialign_jax.parallel.distributed import merge_host_outputs
    merged = io.StringIO()
    merge_host_outputs(list(ARGS), outs, merged)

    want = _single_process_output(ARGS)
    assert merged.getvalue() == want


@pytest.mark.slow
def test_two_host_merge_multiblock(tmp_path):
    """Multi-block (-d over two refs) distributed run: _plan must
    accumulate base_qid across index blocks exactly like cli.main, so
    the 64-bit pos-dedup hash sees identical qids."""
    ref2 = tmp_path / "tref2.fa"
    # a second, distinct reference block: reverse-complemented tref
    lines = open(f"{DATA}/tref.fa").read().splitlines()
    seq = "".join(lines[1:])
    rc = seq[::-1].translate(str.maketrans("ACGTacgt", "TGCAtgca"))
    ref2.write_text(">chr_u rc\n" + "\n".join(
        rc[i:i + 60] for i in range(0, len(rc), 60)) + "\n")
    idx = tmp_path / "idx.mai"
    _single_process_output(
        ["-d", str(idx), f"{DATA}/tref.fa", str(ref2)])
    reads = tmp_path / "reads4.fq"
    reads.write_text(open(f"{DATA}/treads.fq").read() * 4)
    ARGS = ["-t1", "-165537", str(idx), str(reads)]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    coord = "127.0.0.1:19737"
    procs = []
    outs = []
    for hid in range(2):
        out = str(tmp_path / f"mb_host{hid}.out")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(TOOLS, "dist_host.py"),
             str(hid), "2", coord, out] + ARGS,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err.decode()[-2000:]

    from minialign_jax.parallel.distributed import merge_host_outputs
    merged = io.StringIO()
    merge_host_outputs(list(ARGS), outs, merged)

    want = _single_process_output(ARGS)
    assert merged.getvalue() == want
