"""repro_torch: the U-HNSW query path in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

The port of `repro` (JAX + Pallas for the TPU), mirroring its layout:

  repro_torch.core     — Lp op table and metrics, synthetic datasets, the
                         bulk HNSW builder, batched beam search, U-HNSW
                         (Algorithm 1) with early-abandoning verification
  repro_torch.kernels  — CUDA kernels for the verification hot path
                         (gather_lp, gather_lp_abandon), their plain PyTorch
                         versions, and the nvcc build that loads them
  repro_torch.convert  — carries a reference index into the port

Entry points run on "cuda" unless the caller passes device="cpu"; on CPU
tensors the kernels' plain versions run instead. It imports neither jax
nor repro.
"""

__version__ = "0.1.0"
