"""Launchers of the port: step functions and the serving entry point."""
