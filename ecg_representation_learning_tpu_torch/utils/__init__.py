"""Logging and argument validation."""
