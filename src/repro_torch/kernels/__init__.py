"""Hand-written CUDA kernels for exact-Lp scoring.

  csrc/          — pairwise_lp.cu, rowwise_lp.cu, gather_lp.cu,
                   gather_lp_multi.cu (the build's two-metric gather),
                   gather_lp_abandon.cu, gather_lp_screen.cu and lp_topk.cu
                   (sm_90a), sharing lp_common.cuh
  _build.py      — builds them with nvcc at first use, loads them with ctypes
  lp_distance.py — their wrappers (CUDA -> kernel, CPU -> plain version),
                   with launch counts; lp_topk.py the top-k kernel's
  ref.py         — the plain PyTorch versions
  ops.py         — the dispatchers the query path and the builders call
"""
