"""The plain reference the benchmark holds the port to: float64 PyTorch,
written from the configuration's numbers; it imports nothing of the port
and nothing of JAX."""
