"""The configuration tree, shared with echr_tpu (it imports no jax)."""
from echr_tpu.config import Config, flagship_config  # noqa: F401
