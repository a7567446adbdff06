"""Index tiers around the U-HNSW graphs: the compressed int8 band
(compressed) that the two-band verification screens against."""
