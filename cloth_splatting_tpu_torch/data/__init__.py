"""Scene construction: meshes and synthetic scenes."""
