"""Distributed training of the port on `torch.distributed`: the ambient
mesh (`distributed.context`), the sharding rules and per-rank blocks
(`distributed.sharding`), the strapped hierarchical collectives
(`distributed.collectives`) and the "model" axis
(`distributed.tensor_parallel`).

The reference jits its train step under a ("pod", "data", "model") mesh
and lets GSPMD keep the numbers of the sharded step equal to a
single-device step.  The port has no GSPMD, so each rank's work is
explicit:

- storage follows the reference's specs: each rank holds, of every
  parameter and optimizer-state leaf, the block that
  `NamedSharding(mesh, spec)` places on the device at its coordinate;
- each rank computes on its "model" blocks, as GSPMD partitions the
  reference's program (`distributed.tensor_parallel`: the attention's
  heads, the MLP's "ff" columns, the head's vocab rows, the experts,
  the decode cache's positions, and the residual stream's sequence
  under `seq_parallel`); the other leaves are gathered whole
  (`tensor_parallel.model_split` is the rule); the batch is split over
  ("pod", "data"), the gradients reduced with `hierarchical_psum_tree`
  and each rank updates only its own blocks
  (`train.step.make_sharded_train_step`);
- the MoE routes the rank's own tokens and computes the slots of its
  experts (`models.moe`): the mesh-global `moe_apply` exchanges slots
  over the dp ranks at the global capacity, the expert-parallel
  `moe_apply_ep` (`cfg.moe_ep`) over "model" at the local one.
"""
