"""CLIP-SCST: the policy gradient of image generation with the CLIP reward
(port of ``musketeer_tpu/criterions/clip_scst.py``; ref:
criterions/clip_scst_loss.py:1-277).

Sample K code sequences a caption, decode them with the frozen VQGAN, score
each image against its caption with the frozen CLIP, subtract the
leave-one-out mean, and take the policy-gradient step of
``criterions/scst.py`` (``make_scst_fns(..., gen_code=True)``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def clip_rewards(images_uint8: torch.Tensor, captions: List[str], K: int, clip_params,
                 clip_cfg) -> np.ndarray:
    """images [B·K, H, W, 3] uint8, caption-major → the CLIP similarity of each
    with its caption minus the leave-one-out mean → [B, K]."""
    from ..tasks.image_gen import clip_similarity

    with torch.no_grad():
        sim = clip_similarity(images_uint8, captions, clip_params, clip_cfg, groups=K)
    rewards = sim.cpu().numpy().astype(np.float32)
    if K > 1:
        total = rewards.sum(axis=1, keepdims=True)
        baseline = (total - rewards) / (K - 1)
    else:
        baseline = np.zeros_like(rewards)
    return rewards - baseline


def clip_scst_train_step(state, vocab, image_gen_task, grad_step_fn, batch: Dict, model_cfg,
                         rng: torch.Generator):
    """One CLIP-SCST update on an image_gen batch; ``image_gen_task`` carries
    the CLIP and VQGAN parameters and the sampling configuration."""
    from ..tasks.base import params_device, to_device

    device = params_device(state.params)
    src = to_device(batch["src_tokens"], device)
    codes, _ = image_gen_task.generate_codes(state.params, model_cfg, src, rng=rng)
    B, K, gh, gw = codes.shape
    imgs = image_gen_task.decode_images(codes.reshape(B * K, gh, gw))
    if imgs is None:
        raise ValueError("CLIP-SCST needs VQGAN weights")
    caps = [e["caption"] for e in batch["extras"]]
    adv = clip_rewards(imgs, caps, K, image_gen_task.clip_params, image_gen_task.clip_cfg)

    v = vocab
    n = gh * gw
    toks = codes.reshape(B, K, n).cpu().numpy() + v.code_start
    prev = np.full((B, K, n + 1), v.pad, np.int64)
    tgt = np.full((B, K, n + 1), v.pad, np.int64)
    prev[:, :, 0] = v.bos
    prev[:, :, 1:] = toks
    tgt[:, :, :n] = toks
    tgt[:, :, n] = v.eos
    state, metrics = grad_step_fn(state, src, None, None, to_device(prev, device),
                                  to_device(tgt, device), to_device(adv, device))
    metrics["mean_clip_reward"] = float(adv.mean())
    return state, metrics
