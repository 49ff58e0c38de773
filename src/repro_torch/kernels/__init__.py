"""repro_torch.kernels — CUDA kernels for Hopper (sm_90a), each beside its
plain PyTorch version.

  figmn_update.py  matvec2 + rank2_apply (the per-point Λ passes)
  figmn_stream.py  the resident whole-chunk fit (state in shared memory:
                   one block, or a cooperative grid of blocks)
  figmn_sparse.py  gathered_matvec + scatter_apply (the top-C shortlist)
  mahalanobis.py   batched squared Mahalanobis distance
  flash_attention.py  the LM's flash attention: forward, the two backward
                   kernels and the autograd Function around them
  ops.py           the update wrappers behind backend="pallas"
  ref.py           the plain versions every kernel is held against
  _build.py        nvcc build of csrc/*.cu, ctypes binding, launch counts
"""
