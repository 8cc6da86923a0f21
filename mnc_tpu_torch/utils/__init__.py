"""Device selection, image normalization and the JAX weight bridge."""
