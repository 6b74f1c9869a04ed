"""Crash-safe single-file store: codec, file I/O, format, WAL, compression."""
