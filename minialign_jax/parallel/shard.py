"""Multi-chip sharding for the mapping pipeline.

The reference is single-node pthreads (minialign.c:780-1133); the
parallel axes here are designed for device meshes (SURVEY.md section 2.6):

  * data parallelism: extension-problem batches sharded over the mesh
    ('dp' axis) — each device fills its own band batch; no collectives
    on the hot path.
  * index sharding: the minimizer key/value table is sharded by sorted
    hash range ('dp' axis reused); query hashes are replicated, each
    shard answers lookups falling into its range, and per-shard hit
    counts are merged with an all_gather (cross-host hit merge of
    BASELINE config 5).

Everything compiles and runs on a virtual CPU mesh
(xla_force_host_platform_device_count) — see tests/test_shard.py — and
on the GPUs of one host (`python chip_smoke.py --four`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dp import band
from ..extend import _FN_CACHE, FillEngine, _score_key
from ..params import ScoreParams


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()[:n_devices] if n_devices else jax.devices()
    return jax.make_mesh(
        (len(devs),), ("dp",),
        axis_types=(jax.sharding.AxisType.Auto,), devices=devs)


# ---------------------------------------------------------------------------
# data-parallel band fill
# ---------------------------------------------------------------------------

def make_sharded_fill(p: ScoreParams, W: int, la: int, lb: int, mesh: Mesh,
                      trace: bool = False, make_fill=None):
    """Batched fill over (B, la) / (B, lb) code arrays with the problem
    axis sharded over the mesh. The fill is embarrassingly parallel over
    problems: each device runs the store-contract fill (make_fill,
    default: the platform's — the CUDA kernel on GPUs) on its own rows,
    and only the batch-wide block count is reduced across devices."""
    from ..extend import backend, platform_fill

    fill = (make_fill or platform_fill(backend()))(p, W, la, lb, trace)
    bsh = NamedSharding(mesh, P("dp", None))
    vsh = NamedSharding(mesh, P("dp"))

    def local(a, alen, b, blen):
        rows = jnp.arange(a.shape[0], dtype=jnp.int32)
        out = fill(a.reshape(-1), rows * a.shape[1], alen,
                   b.reshape(-1), rows * b.shape[1], blen)
        res = out[0] if trace else out
        res = res._replace(n_blocks=jax.lax.pmax(res.n_blocks, "dp"))
        return (res, out[1]) if trace else res

    rspec = band.FillResult(P("dp"), P("dp"), P("dp"), P("dp"), P())
    ospec = (rspec, band.TraceBuffers(P("dp"), P("dp"), P("dp"), P("dp"))) \
        if trace else rspec
    run = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("dp", None), P("dp"), P("dp", None),
                                    P("dp")),
        out_specs=ospec, check_vma=False))

    def sharded(a, alen, b, blen):
        return run(jax.device_put(a, bsh), jax.device_put(alen, vsh),
                   jax.device_put(b, bsh), jax.device_put(blen, vsh))

    return sharded


# ---------------------------------------------------------------------------
# sharded index lookup
# ---------------------------------------------------------------------------

def shard_index_arrays(keys: np.ndarray, offsets: np.ndarray,
                       n_shards: int):
    """Split the sorted key table into n_shards contiguous hash ranges,
    padded to a common size. Returns (keys_sh, starts_sh, counts_sh)
    stacked as (n_shards, K_pad) arrays; keys stay uint64 here and are
    split into 32-bit halves for the device (split_keys)."""
    K = len(keys)
    # bucket-major indexes are only per-bucket sorted; the shard tables
    # need global order for the per-shard search, so sort once at shard
    # build (starts/counts ride along)
    kord = np.argsort(keys, kind="stable")
    keys = np.asarray(keys, np.uint64)[kord]
    st_all = np.asarray(offsets[:-1], np.int64)[kord]
    cn_all = (np.asarray(offsets[1:], np.int64)
              - np.asarray(offsets[:-1], np.int64))[kord]
    per = -(-K // n_shards) if K else 1
    kpad = per * n_shards
    keys_p = np.full(kpad, np.iinfo(np.uint64).max, np.uint64)
    keys_p[:K] = keys
    starts = np.zeros(kpad, np.int64)
    counts = np.zeros(kpad, np.int64)
    starts[:K] = st_all
    counts[:K] = cn_all
    return (keys_p.reshape(n_shards, per),
            starts.reshape(n_shards, per),
            counts.reshape(n_shards, per))


def split_keys(keys) -> tuple[np.ndarray, np.ndarray]:
    """uint64 hashes -> (hi, lo) uint32 halves. JAX narrows 64-bit
    arrays to 32 bits unless x64 is enabled, and minimizer hashes of
    k > 16 use more than 32 bits, so the device compares both halves."""
    keys = np.asarray(keys, np.uint64)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def make_sharded_lookup(mesh: Mesh):
    """Build a jitted lookup: query hashes (replicated) against the
    hash-range-sharded key table; per-shard hits merged with psum
    across the mesh (each hash lives in exactly one shard). Takes the
    key table as split_keys halves (khi, klo), starts_sh, counts_sh, and
    host uint64 query hashes q; returns (starts, counts)."""

    def _local(khi, klo, starts, counts, qhi, qlo):
        # lower bound of (qhi, qlo) in the sorted (khi, klo) pairs
        K = khi.shape[0]
        lo = jnp.zeros(qhi.shape, jnp.int32)
        hi = jnp.full(qhi.shape, K, jnp.int32)
        for _ in range(max(K, 1).bit_length()):
            mid = (lo + hi) // 2
            mc = jnp.minimum(mid, K - 1)
            less = (khi[mc] < qhi) | ((khi[mc] == qhi) & (klo[mc] < qlo))
            act = lo < hi
            lo, hi = (jnp.where(act & less, mid + 1, lo),
                      jnp.where(act & ~less, mid, hi))
        idx_c = jnp.minimum(lo, K - 1)
        found = (khi[idx_c] == qhi) & (klo[idx_c] == qlo)
        st = jnp.where(found, starts[idx_c], 0)
        cn = jnp.where(found, counts[idx_c], 0)
        return st, cn

    def body(khi, klo, starts, counts, qhi, qlo):
        st, cn = _local(khi[0], klo[0], starts[0], counts[0], qhi, qlo)
        # merge across shards: each key matches exactly one shard
        return jax.lax.psum(st, "dp"), jax.lax.psum(cn, "dp")

    sh = P("dp", None)
    run = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(sh, sh, sh, sh, P(), P()),
        out_specs=(P(), P())))

    def lookup(khi, klo, starts_sh, counts_sh, q):
        return run(khi, klo, starts_sh, counts_sh, *split_keys(q))

    return lookup


# ---------------------------------------------------------------------------
# data-parallel fill engine
# ---------------------------------------------------------------------------

class ShardedFillEngine(FillEngine):
    """FillEngine (host path) whose device batches are sharded over the
    mesh's 'dp' axis (batch data parallelism of SURVEY.md section 2.6:
    the pt_stream worker pool becomes extension-problem batches split
    across devices). Results are bit-identical to the single-device
    engine (tests/test_shard.py)."""

    def __init__(self, score: ScoreParams, mesh: Mesh,
                 batch: int | None = None):
        super().__init__(score, batch=batch or 16 * mesh.devices.size,
                         device_path=False)
        self.mesh = mesh
        # a cache partition of its own: same keys as the single-device
        # fills, different functions
        self._fns = _FN_CACHE.setdefault(
            (_score_key(score), "sharded", id(mesh), self.make_fill), {})

    def _fn(self, W, la, lb, trace):
        key = (W, la, lb, trace)
        if key not in self._fns:
            self._fns[key] = make_sharded_fill(
                self.p, W, la, lb, self.mesh, trace, self.make_fill)
        return self._fns[key]


class ShardedIndex:
    """MMIndex facade whose minimizer lookups run on device against a
    hash-range-sharded key table with cross-shard psum merge (the
    BASELINE config-5 layout: per-host index shards, query hashes
    replicated, hits merged over the mesh). Sequence data and metadata
    stay replicated; only the (keys, offsets) table is sharded."""

    def __init__(self, mi, mesh: Mesh):
        self._mi = mi
        self.mesh = mesh
        n = mesh.devices.size
        keys_sh, starts_sh, counts_sh = shard_index_arrays(
            mi.keys, mi.offsets, n)
        sh = NamedSharding(mesh, P("dp", None))
        self._khi, self._klo = (jax.device_put(k, sh)
                                for k in split_keys(keys_sh))
        self._starts = jax.device_put(starts_sh.astype(np.int32), sh)
        self._counts = jax.device_put(counts_sh.astype(np.int32), sh)
        self._lookup = make_sharded_lookup(mesh)

    def __getattr__(self, name):
        return getattr(self._mi, name)

    def lookup(self, h):
        h = np.asarray(h, np.uint64)
        n = len(h)
        if n == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int64))
        # pad to a power of two so reads of any seed count share a few
        # compiled shapes; the pad hash is the table's own pad key,
        # whose count is 0
        q = np.full(1 << (n - 1).bit_length(), np.iinfo(np.uint64).max,
                    np.uint64)
        q[:n] = h
        st, cn = self._lookup(self._khi, self._klo, self._starts,
                              self._counts, q)
        return (np.asarray(st, np.int64)[:n], np.asarray(cn, np.int64)[:n])


def align_batch_sharded(mp, mi, reads, mesh: Mesh, base_qid: int = 0,
                        tbuf: dict | None = None):
    """pipeline.align_batch with both parallel axes on the mesh:
    extension problems data-parallel ('dp') and index lookups against
    the hash-range-sharded table. Output order and content match the
    single-device pipeline exactly."""
    from ..pipeline import align_batch

    smi = ShardedIndex(mi, mesh)
    engine = ShardedFillEngine(mp.score, mesh)
    return align_batch(mp, smi, reads, engine, base_qid=base_qid,
                       tbuf=tbuf)
