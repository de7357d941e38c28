"""Multi-device CLI path: MINIALIGN_SHARD=1 on the virtual 8-device
CPU mesh routes cli.main through ShardedFillEngine + ShardedIndex
(data-parallel extension batches, hash-range-sharded minimizer table
with cross-shard merge) and must produce byte-identical output to the
single-device run (reference analogue: -t
engaging pt everywhere, minialign.c:4729)."""

import io
import os
import sys

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


def _run_cli(args, shard: str):
    from minialign_jax import cli
    old_env = os.environ.get("MINIALIGN_SHARD")
    os.environ["MINIALIGN_SHARD"] = shard
    out = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        rc = cli.main(args)
    finally:
        sys.stdout = old
        if old_env is None:
            del os.environ["MINIALIGN_SHARD"]
        else:
            os.environ["MINIALIGN_SHARD"] = old_env
    assert rc == 0
    return out.getvalue()


@pytest.mark.slow
def test_mesh_cli_byte_identical():
    import jax
    assert len(jax.devices()) >= 8   # conftest forces the virtual mesh
    args = ["-t1", f"{DATA}/tref.fa", f"{DATA}/treads.fq"]
    sharded = _run_cli(args, "1")
    want = open(f"{DATA}/ref_out.sam").read()
    strip = lambda t: [l for l in t.splitlines()
                       if not l.startswith("@PG")]   # noqa: E731
    assert strip(sharded) == strip(want)
