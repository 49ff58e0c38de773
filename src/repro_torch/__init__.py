"""repro_torch — the Fast Incremental Gaussian Mixture Model (Pinto & Engel,
2015) in PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

A port of the JAX package ``repro``, which stays the reference; the layout
and names mirror it.  This package imports torch, numpy and the standard
library only.

  core      the precision-form learner (types, figmn), eq. 27 inference and
            mixture merging
  kernels   CUDA kernels (csrc/*.cu, built with nvcc at first use and bound
            with ctypes) + their plain PyTorch versions (ref.py)
  stream    StreamRuntime: chunked ingestion (scan/vmem/sparse), the pool
            lifecycle, telemetry
  api       Mixture / MixtureSpec on the "runtime" tier
  interop   configs, mixture states and LM parameters to and from numpy
  data      deterministic synthetic streams and LM tokens
  models    the LM stack, dense family (config, layers, transformer)
  configs   the LM architecture registry (h2o-danube-1.8b so far)
  serve     the batched LM serving engine
  train     the LM's loss gradient (trainer._grads, _accumulated_grads)

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
device and no card they raise.  Float32 products run in full float32: TF32
is switched off here for matrix products and convolutions, since it keeps
about three decimal digits and alone breaks parity with the reference.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
