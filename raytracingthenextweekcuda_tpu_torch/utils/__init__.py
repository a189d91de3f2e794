"""Timing, progress and logging of the port's frontends."""
