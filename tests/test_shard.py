"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from minialign_jax.dp import band
from minialign_jax.index.build import build_index
from minialign_jax.index.sketch import sketch
from minialign_jax.params import IndexParams, ScoreParams
from minialign_jax.parallel import shard


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    return shard.make_mesh()


@pytest.mark.parametrize("trace", [False, True])
def test_sharded_fill_matches_single(mesh, trace):
    p = ScoreParams()
    rng = np.random.default_rng(3)
    n = len(jax.devices())
    B, L = 2 * n, 200
    a = rng.integers(0, 4, (B, L)).astype(np.int8)
    b = a.copy()
    ab, alen = band.pad_codes(list(a))
    bb, blen = band.pad_codes(list(b))
    la, lb = ab.shape[1], bb.shape[1]

    single = band.make_fill(p, 64, max_blocks=band.max_blocks_for(la, lb),
                            trace=trace)
    r1 = single(ab, alen, bb, blen)
    sharded = shard.make_sharded_fill(p, 64, la, lb, mesh=mesh, trace=trace)
    r2 = sharded(ab, alen, bb, blen)
    if trace:
        (r1, t1), (r2, t2) = r1, r2
        for f in ("masks", "dirs", "iheads"):
            np.testing.assert_array_equal(np.asarray(getattr(t1, f)),
                                          np.asarray(getattr(t2, f)))
    for f in r1._fields:
        np.testing.assert_array_equal(np.asarray(getattr(r1, f)),
                                      np.asarray(getattr(r2, f)))


@pytest.mark.parametrize("k,w", [(11, 6), (19, 10)])
def test_sharded_lookup_matches_host(mesh, k, w):
    """k > 16 hashes need more than 32 bits: the device lookup compares
    both 32-bit halves (JAX narrows uint64 without x64)."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 3000).astype(np.int8)
    mi = build_index(IndexParams(k=k, w=w), ["c"], [g])
    n = len(jax.devices())
    keys_sh, starts_sh, counts_sh = shard.shard_index_arrays(
        mi.keys, mi.offsets, n)
    khi, klo = shard.split_keys(keys_sh)
    lookup = shard.make_sharded_lookup(mesh)

    qh, _, _ = sketch(g[100:800].astype(np.int64), k, w)
    if k > 16:
        assert int(np.asarray(qh, np.uint64).max()) >= 1 << 32
    st_d, cn_d = lookup(khi, klo, starts_sh, counts_sh, qh)
    st_h, cn_h = mi.lookup(qh)
    np.testing.assert_array_equal(np.asarray(cn_d), cn_h)
    np.testing.assert_array_equal(np.asarray(st_d), st_h)

    # absent keys return zero counts, including one that equals a present
    # key in its low 32 bits
    miss = np.asarray([0xDEADBEEF,
                       int(qh[0]) ^ (1 << 40)], np.uint64)
    _, cn0 = lookup(khi, klo, starts_sh, counts_sh, miss)
    assert np.asarray(cn0).tolist() == [0, 0]


@pytest.mark.slow
def test_align_batch_sharded_matches_single(mesh):
    """Full mapping pipeline with both mesh axes engaged (data-parallel
    fills + hash-range-sharded index lookups) must produce exactly the
    single-device results."""
    import os

    from minialign_jax.io import bseq
    from minialign_jax.params import MapParams
    from minialign_jax.pipeline import align_batch

    data = os.path.join(os.path.dirname(__file__), "data")
    ref = list(bseq.read_seqs(os.path.join(data, "tref.fa")))
    reads = list(bseq.read_seqs(os.path.join(data, "treads.fq")))[:4]
    mi = build_index(IndexParams(), [s.name for s in ref],
                     [s.codes for s in ref])
    mp = MapParams(score=ScoreParams())

    single = align_batch(mp, mi, [s.codes for s in reads])
    multi = shard.align_batch_sharded(mp, mi, [s.codes for s in reads],
                                      mesh)
    assert len(single) == len(multi)
    for s1, s2 in zip(single, multi):
        assert (s1 is None) == (s2 is None)
        if s1 is None:
            continue
        assert s1.n_uniq == s2.n_uniq
        assert len(s1.alns) == len(s2.alns)
        for a1, a2 in zip(s1.alns, s2.alns):
            assert a1.mapq == a2.mapq
            assert a1.aln == a2.aln


def test_host_batches_partition():
    """Multi-host partitioning: round-robin batch ranks cover every
    batch exactly once across hosts (the full merge — rank order +
    cross-host stale-rlen chain replay — is exercised end-to-end with
    two real jax.distributed processes in tests/test_distributed.py)."""
    from minialign_jax.parallel import distributed as dist

    batches = [f"batch{i}" for i in range(11)]
    n_hosts = 3
    seen = {}
    for h in range(n_hosts):
        for rank, b in dist.host_batches(batches, h, n_hosts):
            assert rank not in seen
            assert batches[rank] == b
            seen[rank] = h
    assert sorted(seen) == list(range(11))
