"""Spatial decomposition of a forward on one card (`chop`)."""
