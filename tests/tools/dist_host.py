"""Per-host worker for the multi-host mapping test: initializes
jax.distributed on CPU and maps this host's round-robin batch share.

Usage: dist_host.py <host_id> <n_hosts> <coordinator> <out> <argv...>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from minialign_jax.parallel import distributed  # noqa: E402


def main():
    host_id, n_hosts = int(sys.argv[1]), int(sys.argv[2])
    coordinator, out_path = sys.argv[3], sys.argv[4]
    distributed.run_host(sys.argv[5:], out_path, host_id, n_hosts,
                         coordinator=coordinator or None)


if __name__ == "__main__":
    main()
