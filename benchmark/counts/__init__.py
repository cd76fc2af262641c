"""Operation and byte counts of the functions the benchmark bounds, one
file a function. Each counts what the function needs on its inputs, not
what an implementation does: no tile, chunk or padding enters a count."""
