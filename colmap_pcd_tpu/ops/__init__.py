"""Device-side compute ops (JAX/XLA)."""
