"""Tokenizer and analyzer tables copied from the JAX package."""
