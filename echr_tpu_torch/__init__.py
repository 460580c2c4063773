"""echr_tpu_torch — the PyTorch/CUDA port of echr_tpu for one NVIDIA H100.

A second package beside ``echr_tpu``; the JAX package is the reference the
port is held against (tests/test_torch_*.py).  Module names mirror
``echr_tpu`` so each counterpart is easy to find:

  ops/        — dense / dropout / masked / recurrent / attention primitives,
                and the hand-written CUDA kernels' wrappers (kernel_attention:
                kernels 1, 3 and 4; kernel_head: kernel 2;
                kernel_attention_step: 5 and 6; kernel_probe_head: 7 and 8;
                kernel_probe_scores: 9 and 10) with their build (native) and
                plain PyTorch versions
  experiments/ — the Pallas probes' counterparts, which drive kernels 7-10,
                and probe_tanh (the tanh of kernels 1, 3 and 4 against tanhf)
  models/     — SST, TSRM, contexts, captioner, the decoder family (every
                core of echr_tpu's CORE_REGISTRY), beam search, init
  engine/     — the batched encode / select / decode / beam steps, the
                training and SCST steps, the XE and SCST training loop
                (train), SCST's host rewards (rl), checkpoints, the
                batched eval loop (evaluate) and the host proposal
                selection (proposals)
  parallel/   — data parallelism on torch.distributed, one rank a device:
                joining the group, the gradient all-reduce, a rank's rows,
                the state broadcast and the eval gathers
  config.py, data/, utils/ — the port's own copies of echr_tpu's host code:
                the Config tree, the datasets, batcher and loader, and
                caption rendering
  native/     — the host library, echr_tpu/native's counterpart: the IoU
                label grid, the two NMS and caption rendering in C++ (g++ at
                first use, ctypes), with force_numpy() for their numpy
                versions
  losses.py   — the training criteria
  bridge.py   — JAX param trees (numpy) <-> port modules
  serve.py    — CaptionService, batched greedy and beam serving

The port imports torch and nothing of jax or echr_tpu: the host code of
echr_tpu that it needs is copied into it.  Only the tests import both
packages.
"""

__version__ = "0.1.0"
