"""Embedding providers and the MiniLM encoder."""
