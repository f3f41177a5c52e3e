"""Seeded weight trees for the benchmark configurations."""
