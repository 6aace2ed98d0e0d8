"""Launchers of the port: the co-design service CLI (`launch.serve`)."""
