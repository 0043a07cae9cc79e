"""Launchers: the serving and training entry points, their step factories,
the mesh and its logical sharding rules, and the compressed cross-pod
step."""
