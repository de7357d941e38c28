"""The GPU path's structure, run on the CPU: device-resident sequence
stores, store-window fills, fused down+up dispatches and the device
traceback, with the XLA store fill standing in for the CUDA kernel
(tests/test_cuda_fill.py checks the kernel against that fill). Also the
platform rules around it: the fill chosen by platform, one process per
card, the compile-cache location, and chip_smoke.py refusing to run
without a GPU."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from minialign_jax import cli, extend
from minialign_jax.dp import band

DATA = os.path.join(os.path.dirname(__file__), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu_structure(monkeypatch):
    """Make the engine believe it runs on a GPU, with the XLA fill."""
    monkeypatch.setattr(extend, "backend", lambda: "gpu")
    real = extend.platform_fill
    monkeypatch.setattr(extend, "platform_fill",
                        lambda plat: band.make_store_fill if plat == "gpu"
                        else real(plat))


def _run_cli(args):
    out = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        rc = cli.main(args)
    finally:
        sys.stdout = old
    assert rc == 0
    return out.getvalue()


def _strip_pg(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


@pytest.mark.parametrize("args,golden", [
    (["-t1", "tref.fa", "treads.fq"], "ref_out.sam"),
    # -t4 on a GPU keeps one process (its threads only)
    (["-t4", "-xpacbio", "tref.fa", "treads.fq"], "ref_pacbio.sam"),
    # circular reference: wrapping windows take the XLA gather first
    (["-t1", "-cplasmid", "cplas.fa", "creads.fq"], "ref_circ.sam"),
    (["-t1", "mref.fa", "mreads.fq"], "ref_multi.sam"),
], ids=["default", "pacbio_t4", "circular", "multichrom"])
def test_gpu_structure_goldens(gpu_structure, monkeypatch, args, golden):
    import jax

    def no_procs(*a, **k):
        raise AssertionError("worker processes started on a GPU backend")
    monkeypatch.setattr(cli, "_align_procs", no_procs)
    # several GPUs visible (conftest's virtual devices): the mesh is
    # still not used unless MINIALIGN_SHARD=1 asks for it
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("MINIALIGN_SHARD", raising=False)
    assert len(jax.devices()) > 1
    engines = []
    real_init = extend.FillEngine.__init__

    def spy(self, *a, **k):
        real_init(self, *a, **k)
        engines.append(self)
    monkeypatch.setattr(extend.FillEngine, "__init__", spy)
    got = _run_cli([a if a.startswith("-") else f"{DATA}/{a}"
                    for a in args])
    assert engines and all(type(e) is extend.FillEngine and e.device_path
                           for e in engines)
    want = open(f"{DATA}/{golden}").read()
    assert _strip_pg(got) == _strip_pg(want)


def test_platform_fill_choice():
    from minialign_jax.dp import cuda_fill
    assert extend.platform_fill("gpu") is cuda_fill.make_fill
    assert extend.platform_fill("cpu") is band.make_store_fill
    with pytest.raises(ValueError, match="rocm"):
        extend.platform_fill("rocm")


def test_engine_refuses_unknown_platform(monkeypatch):
    from minialign_jax.params import ScoreParams
    monkeypatch.setattr(extend, "backend", lambda: "rocm")
    with pytest.raises(ValueError):
        extend.FillEngine(ScoreParams())
    # an explicit fill still names what runs
    eng = extend.FillEngine(ScoreParams(), fill=band.make_store_fill,
                            device_path=True)
    assert eng.make_fill is band.make_store_fill


def test_engine_structure_by_platform(monkeypatch):
    from minialign_jax.params import ScoreParams
    cpu = extend.FillEngine(ScoreParams())
    assert not cpu.device_path
    assert cpu.make_fill is band.make_store_fill
    monkeypatch.setattr(extend, "backend", lambda: "gpu")
    from minialign_jax.dp import cuda_fill
    gpu = extend.FillEngine(ScoreParams())
    assert gpu.device_path
    assert gpu.make_fill is cuda_fill.make_fill


def test_pad_batch():
    from minialign_jax.params import ScoreParams
    dev = extend.FillEngine(ScoreParams(), fill=band.make_store_fill,
                            device_path=True)
    assert [dev._pad_batch(n) for n in (1, 32, 33, 100, 512)] == \
        [32, 32, 64, 128, 512]
    host = extend.FillEngine(ScoreParams(), batch=32)
    assert [host._pad_batch(n) for n in (1, 32, 33)] == [32, 32, 64]


def test_one_process_per_gpu(monkeypatch):
    monkeypatch.delenv("MINIALIGN_PROC_WORKERS", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 16)
    assert cli._nproc_for(4) == 4
    monkeypatch.setattr(extend, "backend", lambda: "gpu")
    assert cli._nproc_for(4) == 1
    assert cli._nproc_for(64) == 1
    monkeypatch.setenv("MINIALIGN_PROC_WORKERS", "1")
    assert cli._nproc_for(4) == 1
    monkeypatch.setenv("MINIALIGN_PROC_WORKERS", "2")
    with pytest.raises(ValueError, match="one process owns the card"):
        cli._nproc_for(4)


def _gather_ref(store, base, start, cap, seglen, wrap, L):
    out = np.full((len(base), L), band.NCODE, np.int8)
    for k in range(len(base)):
        for c in range(min(L, cap[k])):
            idx = start[k] + c
            if wrap[k]:
                idx %= wrap[k]
            elif idx >= seglen[k]:
                continue
            out[k, c] = store[base[k] + idx]
    return out


@pytest.mark.parametrize("case", ["normal", "wrap", "past_end"])
def test_gather_windows_matches_host_slicing(case):
    rng = np.random.default_rng(7)
    segs = [rng.integers(0, 4, n).astype(np.int8) for n in (300, 57, 1000)]
    base = np.cumsum([0] + [len(s) for s in segs[:-1]]).astype(np.int32)
    store = band.pad_store(np.concatenate(segs))
    seglen = np.asarray([len(s) for s in segs], np.int32)
    L = 256
    if case == "normal":
        start = np.asarray([10, 0, 500], np.int32)
        cap = np.asarray([200, 57, 256], np.int32)
        wrap = np.zeros(3, np.int32)
    elif case == "wrap":
        start = np.asarray([250, 40, 990], np.int32)
        cap = np.asarray([256, 200, 100], np.int32)
        wrap = seglen.copy()
    else:
        start = np.asarray([290, 57, 10**6], np.int32)
        cap = np.asarray([256, 256, 256], np.int32)
        wrap = np.zeros(3, np.int32)
    got = np.asarray(band.gather_windows(store, base, start, cap, seglen,
                                         wrap, L))
    want = _gather_ref(store, base, start, cap, seglen, wrap, L)
    np.testing.assert_array_equal(got, want)


def test_pad_store_quantized():
    s = band.pad_store(np.arange(10, dtype=np.int8) % 4)
    assert s.dtype == np.int8 and len(s) == band.STORE_QUANTUM
    assert (s[10:] == band.NCODE).all()
    assert len(band.pad_store(np.zeros(band.STORE_QUANTUM, np.int8))) == \
        2 * band.STORE_QUANTUM


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_location(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX_PERSISTENT_CACHE")
           and k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = ROOT
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, minialign_jax, os; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(os.environ.get('JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS'))"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert r.returncode == 0, r.stderr
    cache_dir, min_secs = r.stdout.split()
    if env_dir:
        assert cache_dir == str(tmp_path / env_dir)
        assert min_secs == "None"      # nothing set in code
    else:
        assert cache_dir == os.path.join(ROOT, ".jax_cache")


def test_chip_smoke_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory, without the program
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    r = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
