"""Launchers of the port: device meshes and the tensor-parallel rank
launcher (``launch.mesh``)."""
