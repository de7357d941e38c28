"""Intra-host process workers (MINIALIGN_PROC_WORKERS): the multi-host
round-robin worker + rank-ordered merge machinery run with N local
processes must produce byte-identical output to the single-process
CLI (the reference's analogue is pt-pool worker parallelism,
minialign.c:4535-4732)."""

import os
import subprocess
import sys

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(extra_env, args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env)
    r = subprocess.run(
        [sys.executable, "-m", "minialign_jax.cli"] + args,
        capture_output=True, env=env, cwd=ROOT, timeout=900)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r.stdout


@pytest.mark.slow
@pytest.mark.parametrize("fmt", ["-Opaf", "-Osam"])
def test_proc_workers_byte_identical(fmt):
    args = ["-t1", fmt, "-165537",
            os.path.join(DATA, "tref.fa"),
            os.path.join(DATA, "treads.fq")]
    one = _run({}, args)
    two = _run({"MINIALIGN_PROC_WORKERS": "2"}, args)
    # full byte equality INCLUDING the @PG header: the merged stream
    # reuses the same arg_line, so SAM headers match exactly
    assert one == two


def test_nth_drives_worker_count(monkeypatch):
    """`-tN` IS the worker count (reference contract: -t sizes the pt
    pool, minialign.c:4729), clamped to visible cores; the env var
    overrides both ways."""
    import os as _os

    from minialign_jax.cli import _nproc_for

    monkeypatch.delenv("MINIALIGN_PROC_WORKERS", raising=False)
    monkeypatch.setattr(_os, "cpu_count", lambda: 8)
    assert _nproc_for(4) == 4
    assert _nproc_for(1) == 1
    assert _nproc_for(64) == 8          # clamped to cores
    monkeypatch.setattr(_os, "cpu_count", lambda: 1)
    assert _nproc_for(4) == 1           # this CI host
    monkeypatch.setenv("MINIALIGN_PROC_WORKERS", "3")
    assert _nproc_for(1) == 3           # override up
    monkeypatch.setenv("MINIALIGN_PROC_WORKERS", "1")
    assert _nproc_for(64) == 1          # override down
