"""Launchers of the port: the co-design service CLI (`launch.serve`), the
sweep fabric (`launch.mesh`, `launch.shard`, `launch.elastic`,
`launch.multiproc`) and single-process training (`launch.train`)."""
