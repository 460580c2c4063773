"""echr_tpu's (data, model) mesh and its sequence ring on torch.distributed
(echr_tpu/parallel/): one process, a rank, per device; NCCL between CUDA
ranks, gloo between CPU ranks.

  distributed — joining the group (explicitly or from echr_tpu's cluster
                environment variables), the rank helpers and the object
                gathers of the eval sweep
  mesh        — the (dp, tp) layout and its groups, a row's share of the
                global batch, the gradient all-reduce over a dp column,
                the state broadcast, and the model axis's sharding rule,
                cut and gather
  tensor      — the collectives of the vocab- and head-parallel modules
  sequence    — the frame-sharded SST ring, forward only
"""
