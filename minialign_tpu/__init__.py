"""The package's former name, kept so that existing command lines
(`python -m <this package>.cli ...`) still run. Everything lives in
minialign_jax."""

from minialign_jax import VERSION_STRING, __version__  # noqa: F401
