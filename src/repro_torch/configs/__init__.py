"""Architecture configurations of the port (``base.ArchConfig``)."""
