"""repro_torch: U-HNSW in PyTorch, with hand-written CUDA kernels for an
NVIDIA H100 (sm_90a).

The port of `repro` (JAX + Pallas for the TPU), mirroring its layout:

  repro_torch.core     — Lp op table and metrics, synthetic datasets, the
                         sequential and host bulk builders (build), the
                         shared-pass NN-Descent builder (bulk_build),
                         batched beam search, U-HNSW (Algorithm 1) with
                         early-abandoning, two-band and energy-ordered
                         verification, and the MLSH baseline (mlsh)
  repro_torch.index    — segment (partition and per-segment builds),
                         sharded (ShardedUHNSW: segments folded into one
                         batched search; independent / two_phase /
                         round_robin), delta (the insert buffer and its
                         compaction), health (segment health and degraded
                         search), compressed (the int8 band), wal (the
                         insert log) and persist (snapshots, recovery,
                         DurableIndex, restore_segment), in the
                         reference's on-disk format
  repro_torch.kernels  — seven CUDA kernel wrappers (pairwise_lp,
                         rowwise_lp, gather_lp, gather_lp_multi,
                         gather_lp_abandon, gather_lp_screen in
                         lp_distance; lp_topk in lp_topk), their plain
                         PyTorch versions (ref), the dispatchers (ops) and
                         the nvcc build that loads them (_build)
  repro_torch.retrieval — service (UniversalVectorService: the mixed-p
                         micro-batcher, serve_grouped, serve_v1) and engine
                         (ServingEngine: deadline-flushed buckets, ladder
                         waves, the two-stage pipeline, fault injection,
                         poisoned-segment quarantine and recovery) and
                         knn_lm (kNN-LM over a U-HNSW datastore)
  repro_torch.configs  — the ten architecture configs, field for field
  repro_torch.dist     — Runtime on one card (the mesh is not ported)
  repro_torch.models   — parameter specs, GQA (full and local) and MLA
                         attention (the flash forward and its backward),
                         the dense FFN and the MoE, RG-LRU and SSD, the
                         loss, prefill and decode (every block kind)
  repro_torch.optim    — adamw: the reference's AdamW, in place
  repro_torch.train    — step (TrainConfig, make_train_step: microbatches,
                         int8 gradient compression), compression and
                         monitor (StepWatchdog, HeartbeatMonitor)
  repro_torch.checkpoint — store: checkpoints in the reference's on-disk
                         format, AsyncCheckpointer
  repro_torch.serve    — ServeEngine: batched prefill + decode
  repro_torch.data     — the synthetic token pipeline and its iterator
  repro_torch.launch   — serve: the LM's and the retrieval tier's command
                         line; train: the LM's training command line;
                         supervisor: restart on failure
  repro_torch.tree     — leaves / tree_map over nested dicts and lists
  repro_torch.convert  — carries a reference index, LM's weights or
                         training state into the port

Entry points run on "cuda" unless the caller passes device="cpu"; on CPU
tensors the kernels' plain versions run instead. It imports neither jax
nor repro.
"""

__version__ = "0.1.0"
