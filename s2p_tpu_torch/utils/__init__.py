"""Training infrastructure of the port: seeding, checkpoints, logging."""
