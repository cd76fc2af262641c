"""Manipulation: the PBD cloth simulator, pick-and-place action generators
and the data collection that feeds the GNN dynamics."""
