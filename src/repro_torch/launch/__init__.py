"""Launchers: the serving entry point and its step factories."""
