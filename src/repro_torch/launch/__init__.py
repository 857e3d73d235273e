"""Launchers: the serving CLI."""
