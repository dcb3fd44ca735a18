"""Experiments on CC3M's image-text pairs."""
