"""Launchers of the port: the co-design service CLI (`launch.serve`) and
the sweep fabric (`launch.mesh`, `launch.shard`, `launch.elastic`,
`launch.multiproc`)."""
