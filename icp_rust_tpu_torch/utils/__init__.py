"""Scan IO and data synthesis."""
