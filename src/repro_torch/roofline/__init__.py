"""The roofline of the port on an NVIDIA H100 (port of `repro.roofline`):
the analytic HBM and model-FLOP arithmetic (`analytic`), what one step of
the port does, counted around it (`counts`: the counterpart of the
reference's HLO scanners), and the three-term roofline over the dry
run's results (`analyze`)."""
