"""Measurement probes of the card (no model semantics)."""
