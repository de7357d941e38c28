"""End-to-end API smoke tests: synthetic genome -> index -> map."""

import numpy as np
import pytest

from minialign_jax.extend import FillEngine, revcomp_codes
from minialign_jax.index.build import build_index
from minialign_jax.params import IndexParams, MapParams
from minialign_jax.pipeline import align_batch


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(42)
    return rng.integers(0, 4, 5000).astype(np.int8)


@pytest.fixture(scope="module")
def index(genome):
    return build_index(IndexParams(), ["chr_t"], [genome])


@pytest.fixture(scope="module")
def engine():
    return FillEngine(MapParams().score, batch=8)


def _mutate(rng, s, err=0.08):
    out = []
    for ch in s:
        r = rng.random()
        if r < err * 0.5:
            out.append(rng.integers(0, 4))
        elif r < err * 0.75:
            out.append(rng.integers(0, 4))
            out.append(ch)
        elif r < err:
            pass
        else:
            out.append(ch)
    return np.asarray(out, np.int8)


def test_perfect_read(index, genome, engine):
    mp = MapParams()
    read = genome[1000:2500].copy()
    regs = align_batch(mp, index, [read], engine)
    assert regs[0] is not None
    a = regs[0].alns[0].aln
    assert a.rev == 0
    assert a.as0 == 1000 and a.ae == 2500
    assert a.bs0 == 0 and a.be == 1500
    assert a.score == 1500 * mp.score.max_match
    assert a.path == "DR" * 1500


def test_reverse_read(index, genome, engine):
    mp = MapParams()
    read = revcomp_codes(genome[1000:2500])
    regs = align_batch(mp, index, [read], engine)
    assert regs[0] is not None
    a = regs[0].alns[0].aln
    assert a.rev == 1
    assert a.as0 == 1000 and a.ae == 2500
    # strand-space query coords cover the whole read
    assert a.bs0 == 0 and a.be == 1500


def test_mutated_reads(index, genome, engine):
    mp = MapParams()
    rng = np.random.default_rng(7)
    reads, starts = [], []
    for _ in range(6):
        st = int(rng.integers(0, 3000))
        ln = int(rng.integers(800, 2000))
        r = _mutate(rng, genome[st:st + ln])
        if rng.random() < 0.5:
            r = revcomp_codes(r)
        reads.append(r)
        starts.append(st)
    regs = align_batch(mp, index, reads, engine)
    for k, reg in enumerate(regs):
        assert reg is not None, k
        a = reg.alns[0].aln
        assert abs(a.as0 - starts[k]) < 50, (k, a.as0, starts[k])
        assert a.identity > 0.85


def test_unmappable_read(index, engine):
    mp = MapParams()
    rng = np.random.default_rng(3)
    read = rng.integers(0, 4, 1000).astype(np.int8)
    regs = align_batch(mp, index, [read], engine)
    assert regs[0] is None


def test_short_read_skipped(index, engine):
    mp = MapParams()
    regs = align_batch(mp, index, [np.zeros(10, np.int8)],
                       engine)
    assert regs[0] is None


def test_device_seq_store_matches_default():
    """The device path (sequence stores on the device, window reads,
    fused down+up dispatch, device traceback) run with the XLA store
    fill must produce identical regs to the host path."""
    import os

    from minialign_jax.dp import band
    from minialign_jax.io import bseq

    data = os.path.join(os.path.dirname(__file__), "data")
    ref = list(bseq.read_seqs(os.path.join(data, "tref.fa")))
    reads = [s.codes for s in
             bseq.read_seqs(os.path.join(data, "treads.fq"))][:3]
    mi = build_index(IndexParams(), [s.name for s in ref],
                     [s.codes for s in ref])
    mp = MapParams()
    base = align_batch(mp, mi, reads)
    dev = FillEngine(mp.score, fill=band.make_store_fill, device_path=True)
    store = align_batch(mp, mi, reads, dev)
    for r1, r2 in zip(base, store):
        assert (r1 is None) == (r2 is None)
        if r1 is None:
            continue
        assert len(r1.alns) == len(r2.alns)
        for a1, a2 in zip(r1.alns, r2.alns):
            assert a1.aln == a2.aln and a1.mapq == a2.mapq


def test_stale_rlen_tbuf(index, genome, engine):
    """The root bounds test uses the thread-buffer's STALE rlen
    (minialign.c:3828 reads self->rlen before mm_init_ref at :3873
    updates it; 0 from calloc for the block's first root, which then
    always shifts the root by -k). align_batch must replicate the
    sequential -t1 coupling and leave the last loaded root's ref
    length in tbuf."""
    from minialign_jax.extend import extend_read
    mp = MapParams()
    read = genome[1000:2500].copy()

    tb = {"rlen": 0}
    regs = align_batch(mp, index, [read], engine, tbuf=tb)
    assert regs[0] is not None
    assert tb["rlen"] == len(genome)     # rlen left behind by the root

    # first root of a block (stale rlen = 0): apos >= 0 always fires
    g = extend_read(mp, index, read, 0, tbuf={"rlen": 0, "spec": False})
    req = g.send(None)
    try:
        while True:
            req = g.send(engine.run([req])[0])
    except StopIteration as e:
        res, slots, rec = e.value
    assert rec["first"] is not None and rec["fired"]
    assert rec["out_rlen"] == len(genome)

    # second read in sequence (stale rlen = genome length): in-bounds
    # root, test must NOT fire
    g = extend_read(mp, index, read, 1,
                    tbuf={"rlen": len(genome), "spec": False})
    req = g.send(None)
    try:
        while True:
            req = g.send(engine.run([req])[0])
    except StopIteration as e:
        res, slots, rec = e.value
    assert not rec["fired"]

    # the always-fired -k shift on the first root must not change the
    # final alignment here (root interior to the sequence)
    a = regs[0].alns[0].aln
    assert (a.as0, a.ae, a.bs0, a.be) == (1000, 2500, 0, 1500)
