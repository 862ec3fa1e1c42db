"""Launchers of the port: step functions and their bundles, the serving
entry point, the training driver and its ``--fl`` path, the meshes, the
roofline analysis and the dry-run."""
