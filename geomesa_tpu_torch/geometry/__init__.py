"""Planar geometry values and their f64 host predicates (trimmed copies)."""
