"""Training of the port: optimizers (`train.optimizer`), the train step
and its sharded form over a mesh (`train.step`) and the fault-tolerant
loop (`train.loop`)."""
