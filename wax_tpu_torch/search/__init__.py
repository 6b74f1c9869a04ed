"""Vector engine and hybrid search engine."""
