"""musketeer_tpu_torch — musketeer_tpu in PyTorch + CUDA, for one NVIDIA H100.

A port of the JAX package ``musketeer_tpu`` (the reference, which stays
beside it). Ported so far: caption inference with its serving options, the
joint multi-task training step and loop, both attention branches (the
kernels' and the XLA one with attention dropout, patch subsampling, prompts
and code masks), fairseq checkpoint I/O with the NormFormer options, the
evaluation path (TSV row to metric), the detection and pretraining tasks,
the CLI, data-parallel and FSDP training over ``torch.distributed`` ranks
with per-layer activation checkpointing, and the JAX package's kernel entry
points.
Layout mirrors the JAX package:

  cli.py                         train (one process per rank under torchrun) / evaluate /
                                 evaluate-all / convert (--device)
  config.py                      model / generation / optimizer / criterion / mesh /
                                 train dataclasses and the arch presets
  params.py                      random init in the JAX layout; JAX tree → port params;
                                 trainable fp32 masters; to_inference casts; one ResNet
                                 block (block_from_jax)
  convert/fairseq.py             fairseq state dicts ↔ the port's tree
  models/positions.py            position tables (restated from the JAX package)
  models/resnet.py               ResNet image embedder, frozen or batch-statistics BN
                                 (cuDNN)
  models/ofa.py                  encoder, teacher-forced decoder (flash and XLA
                                 branches), incremental decoder, int8 serving branches,
                                 the NormFormer options, adapters, prompts
  models/heads.py                classification heads, vocab growth
  criterions/label_smoothed_ce.py  the training criterion
  training/                      lr schedule, train state (AdamW, EMA), the joint step,
                                 train_loop, checkpoints, prefetch, metrics
  generation/beam_search.py      beam search: the fast candidate path and the general
                                 body (tries, prefixes, constraints, boxes, sampling,
                                 diverse and lexical search, ensembles); generate
  generation/trie.py, lexical.py constrained-decoding tables
  tokenization/                  GPT-2 BPE (stdlib ``re``) and the OFA vocabulary,
                                 over the port's copy of assets/bpe/
  data/                          example builders (uint8 transport; detection and the
                                 pretraining mixture), collate, train augmentation,
                                 the TSV reader
  utils/                         CIDEr-D, the summary normalizer, eval utilities
                                 (boxes, IoU, allcand scoring), the FLOPs count (flops.py)
  native/                        the g++ TSV reader (a batch's rows in one C call)
  parallel/                      the mesh's axes over torch.distributed ranks and the
                                 sharding rules (mesh.py), data-parallel and FSDP training
                                 (data_parallel.py), gloo/NCCL dry runs (dryrun.py)
  examples/                      the joint-training demo
  tasks/                         Task, iter_batches, the eval, detection and pretraining
                                 tasks (TASK_REGISTRY), the joint loader
                                 (MusketeerDataLoader)
  ops/flash_attention_infer.py   K1: attention with decomposed bias
  ops/topk_projection.py         K2, K2-q8: output projection + softmax stats
  ops/flash_attention_bwd.py     K3, K4: training attention forward / backward
  ops/flash_attention.py         K5: the JAX ``ops`` attention API
  ops/decode_cross_attn.py       K6: decode cross-attention over the int8 cache
  ops/decode_stack.py            K7: all decoder layers of a decode step
  ops/bottleneck.py              K8: the fused ResNet bottleneck
  ops/_build.py                  nvcc → one shared library, bound with ctypes; the
                                 route by device and dtype
  csrc/                          the kernels' CUDA C++ sources (sm_90a); in bf16 on
                                 tensor cores: attention (K1, K3, K5:
                                 flash_fwd_sm90.cuh; K4: flash_bwd_sm90.cuh), the
                                 decode step's products (K7, K2, K2-q8 with int8
                                 widened on chip: skinny_gemm_sm90.cuh) and
                                 cross-attentions (K7: decode_attn_sm90.cuh; K6 over
                                 the int8 cache: decode_cross_attn.cu), on
                                 sm90.cuh's primitives; K8, and fp32, on the CUDA
                                 cores

Each kernel wrapper runs its plain PyTorch version for CPU tensors and its
CUDA kernel for CUDA tensors. Imports torch, numpy and the standard library
(PIL where an image is decoded), never jax or the JAX package.
"""

__version__ = "0.1.0"
