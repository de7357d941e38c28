"""`python -m <former package name>.cli` runs minialign_jax's CLI."""

import sys

from minialign_jax.cli import main

if __name__ == "__main__":
    sys.exit(main())
