"""Runtime of the port: fault tolerance (`runtime.fault`), and spans and
counters (`runtime.trace`)."""
