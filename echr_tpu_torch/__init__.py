"""echr_tpu_torch — the PyTorch/CUDA port of echr_tpu for one NVIDIA H100.

A second package beside ``echr_tpu``; the JAX package is the reference the
port is held against (tests/test_torch_*.py).  Module names mirror
``echr_tpu`` so each counterpart is easy to find:

  ops/        — dense / masked / recurrent / attention primitives, and the
                two hand-written CUDA kernels (kernel_attention, kernel_head)
                with their build (native) and plain PyTorch versions
  models/     — SST, TSRM, contexts, captioner, three_stream decoder, init
  engine/     — the batched encode / select / decode steps
  bridge.py   — JAX param trees (numpy) <-> port modules
  serve.py    — CaptionService, the batched greedy serving API

The port imports torch and never jax.  JAX-free host code of echr_tpu
(config, data.labels, data.batcher.pick_bucket, engine.proposals,
utils.text, metrics) is reused by import.
"""

__version__ = "0.1.0"
