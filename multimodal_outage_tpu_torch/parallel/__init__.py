"""SPMD over a (data, model, time) mesh of ranks: the collectives, the
launcher and the sharding rules and steps (JAX parallel/)."""
