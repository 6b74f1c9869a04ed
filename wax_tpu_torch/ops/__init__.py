"""Dense scan, top-k, BM25 and fusion ops, and the CUDA kernel build."""
