"""Text-to-image generation (port of ``musketeer_tpu/tasks/image_gen.py``;
ref: tasks/mm_tasks/image_gen.py:137-371).

Prompt → code-token generation (``gen_code``: the ``<code_k>`` band, the
decoder's image positions) → VQGAN ``decode_code`` → CLIP text-image
similarity. CLIP and VQGAN weights are the caller's (``--clip-pt``,
``--vqgan-pt``); without them the task still generates and scores code
sequences (``code_token_acc``). The device work runs without autograd on the
device of the parameters, with a ``torch.Generator`` for sampling.

The JAX task's code-grid numbers are kept for parity: ``code_image_size``
(default 256) ``// 16`` codes a side.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import GenerationConfig
from ..data import task_data as D
from ..generation import beam_search
from ..models import ofa
from .base import Task, iter_batches, params_device, to_device


def clip_similarity(images_uint8: torch.Tensor, captions: List[str], clip_params,
                    clip_cfg, groups: int = 1) -> torch.Tensor:
    """Cosine similarity of each image with its caption → [B, groups] fp32, the
    uint8 images [B · groups, H, W, 3] in caption-major order (ref:
    image_gen.py:262-291). The images are scaled to [0, 1], resized bilinearly
    with antialiasing (``jax.image.resize``'s "bilinear" when it shrinks;
    within 3e-7 of it on 256² → 224²) and normalised as CLIP's."""
    from ..models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, encode_image, encode_text
    from .clip_tokenizer import tokenize

    device, res = images_uint8.device, clip_cfg.image_resolution
    imgs = F.interpolate(images_uint8.float().div(255.0).permute(0, 3, 1, 2), size=(res, res),
                         mode="bilinear", antialias=True, align_corners=False).permute(0, 2, 3, 1)
    imgs = ((imgs - torch.as_tensor(CLIP_IMAGE_MEAN, device=device))
            / torch.as_tensor(CLIP_IMAGE_STD, device=device))
    toks = torch.from_numpy(tokenize(captions, clip_cfg.context_length)).to(device)
    ie = encode_image(clip_params, clip_cfg, imgs).reshape(len(captions), groups, -1)
    te = encode_text(clip_params, clip_cfg, toks)[:, None]
    ie = ie / torch.linalg.vector_norm(ie, dim=-1, keepdim=True)
    te = te / torch.linalg.vector_norm(te, dim=-1, keepdim=True)
    return torch.sum(ie * te, dim=-1)


class ImageGenTask(Task):
    name = "image_gen"

    def __init__(
        self, *a,
        clip_params=None, clip_cfg=None,
        vqgan_params=None, vqgan_cfg=None,
        sampling_times: int = 1,
        code_image_size: int = 256,
        **kw,
    ):
        super().__init__(*a, **kw)
        self.clip_params, self.clip_cfg = clip_params, clip_cfg
        self.vqgan_params, self.vqgan_cfg = vqgan_params, vqgan_cfg
        self.sampling_times = sampling_times
        self.code_image_size = code_image_size

    def builder(self, split: str = "train"):
        return D.ImageGenBuilder(self.vocab, description=self.description, split=split, **self.kw)

    def generation_config(self) -> GenerationConfig:
        v = self.vocab
        grid = self.code_image_size // 16  # 16x16 codes per 256² image (f=16)
        n_codes = grid * grid
        return GenerationConfig(
            # sampling_times > 1 (SCST / best-of-K ranking) sets the number of
            # sampled chains; plain eval keeps beam 5
            beam_size=self.sampling_times if self.sampling_times > 1 else 5,
            max_len_b=n_codes,
            min_len=n_codes,
            gen_code=True,
            constraint_range=(v.code_start, v.code_start + v.code_dict_size),
            sampling=self.sampling_times > 1,
        )

    @torch.no_grad()
    def generate_codes(self, params, model_cfg, src_tokens: torch.Tensor,
                       rng: Optional[torch.Generator] = None):
        """→ (code indices [B, K, grid, grid] (vocab ids shifted to 0-base), scores [B, K])."""
        gen_cfg = self.generation_config()
        v = self.vocab
        grid = self.code_image_size // 16
        n = grid * grid
        enc = ofa.encode(params, model_cfg, src_tokens)
        toks, scores = beam_search(params, model_cfg, gen_cfg, enc, max_len=n,
                                   code_masks_value=True, rng=rng)
        codes = torch.clamp(toks[:, :, :n] - v.code_start, 0, v.code_dict_size - 1)
        B, K = codes.shape[:2]
        return codes.reshape(B, K, grid, grid), scores

    @torch.no_grad()
    def decode_images(self, codes: torch.Tensor) -> Optional[torch.Tensor]:
        """[N, grid, grid] codes → uint8 images [N, H, W, 3] on the codes'
        device, if VQGAN weights are present."""
        if self.vqgan_params is None:
            return None
        from ..models.vqgan import codes_to_images_uint8

        return codes_to_images_uint8(self.vqgan_params, self.vqgan_cfg, codes)

    @torch.no_grad()
    def clip_rank(self, images_uint8: torch.Tensor, captions: List[str]) -> np.ndarray:
        """CLIP ti_sim of each image against its caption (ref: image_gen.py:262-291)."""
        if self.clip_params is None:
            return np.zeros((len(images_uint8),), np.float32)
        sim = clip_similarity(images_uint8, captions, self.clip_params, self.clip_cfg)
        return sim[:, 0].cpu().numpy()

    def evaluate(self, params, model_cfg, dataset, batch_size=2, limit=None,
                 dump_dir: Optional[str] = None,
                 rng: Optional[torch.Generator] = None) -> Dict[str, float]:
        v = self.vocab
        device = params_device(params)
        rng = rng if rng is not None else torch.Generator(device=device).manual_seed(0)
        sims: List[float] = []
        token_acc: List[float] = []
        n = 0
        for batch in iter_batches(dataset, self.builder("valid"), batch_size, v.pad, limit=limit,
                                  drop_last=True):
            src = to_device(batch["src_tokens"], device)
            codes, _ = self.generate_codes(params, model_cfg, src, rng=rng)
            best = codes[:, 0]  # [B, grid, grid]
            # token-level accuracy against the reference codes (always computable)
            best_np = best.cpu().numpy()
            tgt = np.asarray(batch["target"])[:, : best_np.shape[1] * best_np.shape[2]]
            tgt_codes = np.clip(tgt - v.code_start, 0, v.code_dict_size - 1)
            acc = (best_np.reshape(len(best_np), -1) == tgt_codes).mean(axis=1)
            token_acc.extend(acc.tolist())
            imgs = self.decode_images(best)
            if imgs is not None:
                caps = [e["caption"] for e in batch["extras"]]
                sims.extend(self.clip_rank(imgs, caps).tolist())
                if dump_dir:
                    from PIL import Image

                    os.makedirs(dump_dir, exist_ok=True)
                    imgs_np = imgs.cpu().numpy()
                    for i, uid in enumerate(batch["id"]):
                        Image.fromarray(imgs_np[i]).save(os.path.join(dump_dir, f"{uid}.png"))
            n += len(best_np)
        out = {"code_token_acc": float(np.mean(token_acc)) if token_acc else 0.0, "n": n}
        if sims:
            out["ti_sim"] = float(np.mean(sims))
        return out
