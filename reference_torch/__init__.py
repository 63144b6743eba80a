"""Plain float32 PyTorch references the port is held to in the CPU tests
(they import nothing of the port or of JAX)."""
