"""Launchers of the port: the co-design service CLI (`launch.serve`), the
sweep fabric (`launch.mesh`, `launch.shard`, `launch.elastic`,
`launch.multiproc`), single-process training (`launch.train`), the
training mesh (`launch.mesh.make_train_mesh`), a process group spawned on
one host (`launch.group`) and the optimization levels
(`launch.optlevels`)."""
