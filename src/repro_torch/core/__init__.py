"""U-HNSW core: the Lp op table and metrics (lp_ops, metrics), synthetic
datasets (datasets), the sequential and host bulk builders (build), the
shared-pass bulk builder (bulk_build), batched beam search (hnsw) and
Algorithm 1 with its verification paths (uhnsw)."""
