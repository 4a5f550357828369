"""Launchers of the port: serving and single-process training."""
