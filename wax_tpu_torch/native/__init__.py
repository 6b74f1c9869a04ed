"""Native C++ host libraries (LZ4, BPE, HNSW), built from source on first use."""
