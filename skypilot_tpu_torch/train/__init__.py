"""Training on one card: ``trainer`` (TrainConfig, Trainer,
measure_throughput) and ``optim`` (the optax pieces it uses)."""
