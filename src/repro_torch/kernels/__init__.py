"""Hand-written CUDA kernels for exact-Lp scoring.

  csrc/          — pairwise_lp.cu, gather_lp.cu, gather_lp_abandon.cu and
                   gather_lp_screen.cu (sm_90a), sharing lp_common.cuh
  _build.py      — builds them with nvcc at first use, loads them with ctypes
  lp_distance.py — their wrappers (CUDA -> kernel, CPU -> plain version),
                   with launch counts
  ref.py         — the plain PyTorch versions
  ops.py         — the dispatchers the query path and the builders call
"""
