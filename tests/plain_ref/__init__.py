"""Plain references that the port's tests hold it against: torch alone,
float64, nothing of `cfjax_torch` or of JAX."""
