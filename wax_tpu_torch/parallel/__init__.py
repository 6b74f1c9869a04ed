"""Corpus-sharded serving programs on a mesh of devices (one device in this port)."""
