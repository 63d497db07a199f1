"""Command-line entry points, the production meshes and the multi-host launch."""
