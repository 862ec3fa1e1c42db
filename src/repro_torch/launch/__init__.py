"""Launchers of the port: step functions, the serving entry point and the
training driver's ``--fl`` path."""
