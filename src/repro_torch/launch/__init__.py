"""Meshes and the dry-run on an emulated mesh (the port's ``repro/launch``)."""
