"""minialign-jax: a JAX long-read alignment engine.

A from-scratch reimplementation of the capabilities of ocxtal/minialign
(minimizer index + seed chaining + adaptive-banded Smith-Waterman-Gotoh
extension) for accelerators: the banded-DP wavefront runs as batched
device fills (a CUDA kernel on NVIDIA GPUs, XLA elsewhere), and the host
side orchestrates seeding, chaining, batched extension scheduling and
SAM emission.

Reference behavior spec: the reference's minialign.c and gaba.c — cited
throughout as file:line. This package is a new design, not a
translation.
"""

import os as _os

# persistent XLA compilation cache: one compiled variant per (W, shape
# bucket, trace), reusable across runs. JAX_COMPILATION_CACHE_DIR wins
# when set (nothing is set in code then); otherwise the cache lives at a
# fixed path in the checkout (the path is part of the cache's key, so it
# must not move). Set through jax.config too: JAX reads these variables
# once, when it is first imported.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _CACHE = {
        "jax_compilation_cache_dir": _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache"),
        "jax_persistent_cache_min_compile_time_secs": 1,
        "jax_persistent_cache_min_entry_size_bytes": -1,
    }
    for _k, _v in _CACHE.items():
        _os.environ[_k.upper()] = str(_v)
        _jax.config.update(_k, _v)

__version__ = "0.1.0"
VERSION_STRING = "minialign-jax-0.1.0"
