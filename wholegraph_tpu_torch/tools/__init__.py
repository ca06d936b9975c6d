"""Measurement tools of the port: not part of any path."""
