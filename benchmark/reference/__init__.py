"""The plain reference of the served model, in plain PyTorch at float32.

It follows the published description of ECHR (SST proposals, the
hierarchical contexts with TSRM, the decoder cores) as the JAX package
states it, one video at a time, and imports nothing of the port, of the
JAX package or of jax.  ``model.Reference`` computes; ``check.judge``
holds what a run served against it.
"""
