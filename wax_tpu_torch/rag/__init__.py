"""Token-budgeted RAG context assembly."""
