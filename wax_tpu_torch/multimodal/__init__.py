"""Photo and video RAG orchestrators over the port's MemoryOrchestrator."""
