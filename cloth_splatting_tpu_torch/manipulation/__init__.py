"""Manipulation: the PBD cloth simulator, pick-and-place action generators,
the data collection that feeds the GNN dynamics, and the closed loop that
plans with it (environment, MPC, observations, planning, action tools,
demos and deformed meshes)."""
