"""musketeer_tpu_torch — the caption-inference path of musketeer_tpu in PyTorch + CUDA.

A port of the JAX package ``musketeer_tpu`` (the reference, which stays
beside it) to PyTorch on one NVIDIA H100. Layout mirrors the JAX package:

  config.py                      model / generation dataclasses (same fields)
  params.py                      random init in the JAX layout; JAX tree → port params
  models/resnet.py               frozen-BN ResNet image embedder
  models/ofa.py                  encoder (flash branch) + incremental decoder
  ops/flash_attention_infer.py   K1: attention with decomposed bias (CUDA kernel)
  ops/topk_projection.py         K2: output projection + softmax stats (CUDA kernel)
  generation/beam_search.py      beam search, fast candidate path
  csrc/                          the kernels' CUDA C++ sources (sm_90a)

Imports torch and never jax.
"""

__version__ = "0.1.0"
