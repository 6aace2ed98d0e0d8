"""Runtime of the port: fault tolerance (`runtime.fault`)."""
