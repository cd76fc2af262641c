"""Several devices: the scene-parallel sweep (one scene per device)."""
