"""Distributed training of the port on `torch.distributed`: the ambient
mesh (`distributed.context`), the sharding rules and per-rank blocks
(`distributed.sharding`) and the strapped hierarchical collectives
(`distributed.collectives`).

The reference jits its train step under a ("pod", "data", "model") mesh
and lets GSPMD keep the numbers of the sharded step equal to a
single-device step.  The port has no GSPMD, so each rank's work is
explicit:

- storage follows the reference's specs: each rank holds, of every
  parameter and optimizer-state leaf, the block that
  `NamedSharding(mesh, spec)` places on the device at its coordinate;
- compute is data-parallel over ("pod", "data"): each rank all-gathers
  the full parameters, runs forward and backward on its batch shard,
  reduces the gradients with `hierarchical_psum_tree` and updates only
  its own blocks (`train.step.make_sharded_train_step`);
- the "model" axis computes only where the reference names it
  explicitly, the expert-parallel MoE (`models.moe.moe_apply_ep`);
  elsewhere the "model" ranks run the dense layers redundantly, which is
  correct but not fast.
"""
