"""U-HNSW core: the Lp op table and metrics (lp_ops, metrics), synthetic
datasets (datasets), the bulk HNSW builder (build), batched beam search
(hnsw) and Algorithm 1 with early-abandoning verification (uhnsw)."""
