"""Math and kernel primitives: SH, quaternions, cameras, kNN, projection, rasterization."""
