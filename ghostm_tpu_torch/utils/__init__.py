"""Logging, metrics and synthetic data."""
