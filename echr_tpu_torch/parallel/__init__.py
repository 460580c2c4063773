"""Data parallelism on torch.distributed (echr_tpu/parallel/): one process,
a rank, per device; NCCL between CUDA ranks, gloo between CPU ranks.

  distributed — joining the group (explicitly or from echr_tpu's cluster
                environment variables), the rank helpers and the object
                gathers of the eval sweep
  mesh        — the data axis: the layout check, a rank's rows of the
                global batch, the gradient all-reduce and the state
                broadcast
"""
