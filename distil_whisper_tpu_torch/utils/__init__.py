"""Utilities of the port: step timing and metrics logging."""
