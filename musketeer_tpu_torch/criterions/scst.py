"""SCST (self-critical sequence training) with the CIDEr-D reward (port of
``musketeer_tpu/criterions/scst.py``; ref: criterions/scst_loss.py:22-223).

One update in three parts, as in the JAX package:

1. sampling: K chains per sample through the beam search's sampling mode,
   without autograd (the model's attention takes K1);
2. host-side CIDEr-D rewards against the references, minus the per-sample
   leave-one-out mean (ref: scst_loss.py:165-180);
3. the policy-gradient step: the sampled sequences teacher-forced through
   encode → ``tile_encoder_out`` → decode (K3 forward, K4 backward),
   loss = −Σ lprob(sampled) · advantage over non-pad positions, divided by
   the token count, then the port's AdamW (``training/train_state.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import GenerationConfig, ModelConfig
from ..generation import beam_search
from ..generation.beam_search import tile_encoder_out
from ..models import ofa
from ..utils.cider import CiderD


def scst_loss(
    logits: torch.Tensor,  # [N, T, V] teacher-forced over the sampled sequences
    targets: torch.Tensor,  # [N, T] the sampled tokens (eos included)
    advantages: torch.Tensor,  # [N] reward − baseline
    pad_id: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """−Σ lprob(token) · advantage over non-pad positions → (loss, ntokens)."""
    lprobs = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = torch.gather(lprobs, -1, targets.long()[..., None])[..., 0]
    keep = targets != pad_id
    per_seq = torch.where(keep, tok_lp, 0.0).sum(dim=-1)
    return -torch.sum(per_seq * advantages), keep.sum()


def compute_rewards(
    hyps: List[List[str]],  # [B][K] sampled caption strings
    refs: List[List[str]],  # [B] reference strings per image
    scorer: Optional[CiderD] = None,
) -> np.ndarray:
    """CIDEr-D per hypothesis minus the per-image leave-one-out mean → [B, K]."""
    scorer = scorer or CiderD()
    gts, res = {}, {}
    for b, (hs, rs) in enumerate(zip(hyps, refs)):
        for k, h in enumerate(hs):
            gts[f"{b}_{k}"] = rs
            res[f"{b}_{k}"] = h
    _, per = scorer.compute_score(gts, res)
    B, K = len(hyps), len(hyps[0])
    rewards = np.asarray([[per[f"{b}_{k}"] for k in range(K)] for b in range(B)], np.float32)
    if K > 1:
        total = rewards.sum(axis=1, keepdims=True)
        baseline = (total - rewards) / (K - 1)  # leave-one-out (ref :172-177)
    else:
        baseline = np.zeros_like(rewards)
    return rewards - baseline


def make_scst_fns(model_cfg: ModelConfig, gen_cfg: GenerationConfig, optim_tx,
                  gen_code: bool = False):
    """(sample_fn, grad_step_fn) of the SCST loop. ``gen_code`` decodes code
    targets: image positions, and in the teacher-forced decoder every row
    marked (``code_masks_all``), which keeps it on the flash branch
    (CLIP-SCST, ``criterions/clip_scst.py``)."""
    from ..training.train_state import named_leaves  # the training package imports this one

    if not gen_cfg.sampling:
        raise ValueError("the SCST generator must sample")

    @torch.no_grad()
    def sample_fn(params, src_tokens, patch_images, patch_masks, rng: torch.Generator):
        enc = ofa.encode(params, model_cfg, src_tokens, patch_images, patch_masks)
        max_len = int(gen_cfg.max_len_a * src_tokens.shape[1] + gen_cfg.max_len_b)
        return beam_search(params, model_cfg, gen_cfg, enc, max_len=max_len, rng=rng,
                           code_masks_value=gen_code)

    def grad_step_fn(state, src_tokens, patch_images, patch_masks, prev_out, targets,
                     advantages):
        params = state.params
        leaves = [p for _, p in named_leaves(params)]
        for p in leaves:
            p.grad = None
        B, K, T = prev_out.shape
        enc = ofa.encode(params, model_cfg, src_tokens, patch_images, patch_masks)
        code_masks = (torch.ones((B * K,), dtype=torch.bool, device=src_tokens.device)
                      if gen_code else None)
        logits = ofa.decode(params, model_cfg, prev_out.reshape(B * K, T),
                            tile_encoder_out(enc, K), code_masks=code_masks,
                            deterministic=True, code_masks_all=gen_code)
        loss, ntok = scst_loss(logits, targets.reshape(B * K, T), advantages.reshape(B * K),
                               model_cfg.pad)
        loss = loss / torch.clamp(ntok, min=1)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
        optim_tx.update(params, grads, state.opt_state)
        for p in leaves:
            p.grad = None
        return state._replace(step=state.step + 1), {"scst_loss": loss.detach(), "ntokens": ntok}

    return sample_fn, grad_step_fn


def scst_train_step(state, vocab, sample_fn, grad_step_fn, batch: Dict,
                    rng: torch.Generator, max_len: int):
    """One SCST update on a collated caption batch (``scst`` split: the
    references in ``extras["caption_refs"]``): sample → reward → policy-gradient step."""
    from ..tasks.base import params_device, to_device

    device = params_device(state.params)
    src = to_device(batch["src_tokens"], device)
    imgs = to_device(batch["patch_images"], device, torch.float32)
    masks = to_device(batch["patch_masks"], device)
    toks, _ = sample_fn(state.params, src, imgs, masks, rng)
    toks_np = toks.cpu().numpy()  # [B, K, T]
    B, K, T = toks_np.shape
    hyps = [[vocab.decode_ids([int(t) for t in toks_np[b, k] if t not in (vocab.pad, vocab.eos)])
             for k in range(K)] for b in range(B)]
    refs = [[r.strip() for r in e["caption_refs"].split("&&")] for e in batch["extras"]]
    adv = compute_rewards(hyps, refs)
    # teacher forcing of the samples: the target is the row without its pads
    prev = np.full((B, K, T), vocab.pad, np.int64)
    tgt = np.full((B, K, T), vocab.pad, np.int64)
    for b in range(B):
        for k in range(K):
            seq = [int(t) for t in toks_np[b, k] if t != vocab.pad]
            prev[b, k, 0] = vocab.bos
            prev[b, k, 1:len(seq)] = seq[:-1]
            tgt[b, k, :len(seq)] = seq
    state, metrics = grad_step_fn(state, src, imgs, masks, to_device(prev, device),
                                  to_device(tgt, device), to_device(adv, device))
    metrics["mean_reward"] = float(adv.mean())
    return state, metrics
