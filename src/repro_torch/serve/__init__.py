"""Decode caches and the single-token decode step."""
