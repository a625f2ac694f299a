"""Hopper probes of the port (counterparts of the repository's experiments/)."""
