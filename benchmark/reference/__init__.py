"""Plain PyTorch references of the configurations; they import neither the
program nor JAX."""
