"""Checkpoints of the port (`ckpt.manager`), interchangeable with the
reference's."""
