"""Training and experiment infrastructure of the port: seeding, checkpoints,
logging, timers and profiling, the launcher, sweeps, plotting and IO."""
