"""Model state: mesh-anchored Gaussian fields and deformation models."""
