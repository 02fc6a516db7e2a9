"""Numeric building blocks: alphabet encoding, translation, scoring, E-values."""
