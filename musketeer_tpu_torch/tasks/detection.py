"""Detection task (port of ``musketeer_tpu/tasks/detection.py``; ref:
tasks/cv_tasks/detection_task.py:1-197).

Multi-object generation: decode alternating [4×<bin>, label-tokens] groups
and de-bin them to boxes. The reference's build_shared_model is a
passthrough (:149-150) and its valid path reports the loss only; the JAX
package adds generated-box precision / recall / F1, and so does the port.
The device work runs eagerly under ``torch.inference_mode()`` on the device
of the parameters.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..config import GenerationConfig
from ..criterions import label_smoothed_ce
from ..data.detection import DetectionBuilder
from ..generation import beam_search
from ..models import ofa
from ..utils.eval_utils import debin_boxes, match_detections
from .base import Task, iter_batches, params_device, to_device


class DetectionTask(Task):
    name = "detection"

    def __init__(self, *a, max_image_size: int = 512, **kw):
        super().__init__(*a, **kw)
        self.max_image_size = max_image_size

    def builder(self, split: str = "train"):
        return DetectionBuilder(self.vocab, description=self.description, split=split,
                                max_image_size=self.max_image_size, **self.kw)

    def generation_config(self) -> GenerationConfig:
        return GenerationConfig(beam_size=5, max_len_b=60, min_len=5)

    def parse_boxes(self, tokens: np.ndarray, w_ratio: float,
                    h_ratio: float) -> List[Tuple[np.ndarray, str]]:
        """Token sequence → [(box_xyxy, label_text)] groups."""
        v = self.vocab
        toks = [int(t) for t in tokens if t not in (v.pad, v.eos)]
        is_bin = lambda t: v.bin_start <= t < v.bin_start + v.num_bins
        out = []
        i = 0
        while i + 4 <= len(toks):
            quad = toks[i:i + 4]
            if not all(is_bin(t) for t in quad):
                i += 1
                continue
            i += 4
            label_toks = []
            while i < len(toks) and not is_bin(toks[i]):
                label_toks.append(toks[i])
                i += 1
            box = debin_boxes(np.asarray([quad]), v.bin_start, v.num_bins, self.max_image_size,
                              np.asarray([w_ratio]), np.asarray([h_ratio]))[0]
            out.append((box, v.decode_ids(label_toks)))
        return out

    def evaluate(self, params, model_cfg, dataset, batch_size=4, limit=None):
        """Teacher-forced loss (the reference's only detection valid signal)
        plus generated-box precision / recall / F1 at IoU 0.5 with greedy
        label-matched assignment, as the JAX task computes them."""
        gen_cfg = self.generation_config()
        v = self.vocab
        device = params_device(params)
        total_loss, total_tok, n = 0.0, 0.0, 0
        tp_sum, np_sum, ng_sum = 0, 0, 0
        with torch.inference_mode():
            for batch in iter_batches(dataset, self.builder("valid"), batch_size, v.pad,
                                      limit=limit, drop_last=True):
                src = to_device(batch["src_tokens"], device)
                imgs = to_device(batch["patch_images"], device, torch.float32)
                masks = to_device(batch["patch_masks"], device)
                logits = ofa.forward(params, model_cfg, src,
                                     to_device(batch["prev_output_tokens"], device), imgs, masks)
                out = label_smoothed_ce(logits, to_device(batch["target"], device), epsilon=0.1,
                                        pad_id=model_cfg.pad, vocab_size=model_cfg.vocab_size)
                total_loss += float(out.loss)
                total_tok += float(out.ntokens)
                n += batch["nsentences"]

                enc = ofa.encode(params, model_cfg, src, imgs, masks)
                toks, _ = beam_search(params, model_cfg, gen_cfg, enc, max_len=gen_cfg.max_len_b)
                top = toks.cpu().numpy()[:, 0]  # top hypothesis per sample
                for b, ex in enumerate(batch["extras"]):
                    groups = self.parse_boxes(top[b], float(ex["w_resize_ratio"]),
                                              float(ex["h_resize_ratio"]))
                    pb = np.asarray([g[0] for g in groups], np.float64).reshape(-1, 4)
                    tp, npred, ngt = match_detections(
                        pb, [g[1].strip() for g in groups], ex["boxes"],
                        [label.strip() for label in ex["labels"]])
                    tp_sum += tp
                    np_sum += npred
                    ng_sum += ngt

        prec = tp_sum / max(1, np_sum)
        rec = tp_sum / max(1, ng_sum)
        f1 = 2 * prec * rec / max(1e-9, prec + rec)
        return {"loss": total_loss / max(1.0, total_tok), "f1@0.5": f1, "precision": prec,
                "recall": rec, "n": n}
