"""Architecture configs of the families the port runs (see registry)."""
