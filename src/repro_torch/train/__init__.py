"""Single-process training of the port: optimizers (`train.optimizer`),
the train step (`train.step`) and the fault-tolerant loop
(`train.loop`)."""
