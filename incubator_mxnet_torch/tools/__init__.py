"""Measurement tools of the port (counterpart of the repository's `tools/`
scripts that the JAX package's experiments use)."""
