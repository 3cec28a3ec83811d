"""Timers, metrics, CLI parsing and PNG output."""
