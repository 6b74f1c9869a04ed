"""Structured memory: entities and bitemporal facts."""
