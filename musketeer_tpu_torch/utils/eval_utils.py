"""Per-task evaluation primitives (port of ``musketeer_tpu/utils/eval_utils.py``).

Box de-binning, IoU and detection matching on the host (numpy, copied from
the JAX package); allcand candidate scoring on the device: the teacher-forced
decoder (``ofa.decode``, whose attentions run K1 on the card) then the tied
output layer on the answer span, constrained log-probs summed over it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..generation.beam_search import tile_encoder_out
from ..models import ofa


# ---------------------------------------------------------------------------
# refcoco / grounding (ref: utils/eval_utils.py:220-253)
# ---------------------------------------------------------------------------

def debin_boxes(
    bin_tokens: np.ndarray,  # [B, 4] vocab ids of <bin_k> tokens
    bin_start: int,
    num_bins: int,
    max_image_size: int,
    w_ratios: np.ndarray,  # [B]
    h_ratios: np.ndarray,  # [B]
) -> np.ndarray:
    """<bin> tokens → original-image pixel boxes [B, 4]."""
    bins = bin_tokens.astype(np.float64) - bin_start
    coords = bins / (num_bins - 1) * max_image_size
    coords[:, 0::2] /= w_ratios[:, None]
    coords[:, 1::2] /= h_ratios[:, None]
    return coords


def box_iou(hyps: np.ndarray, refs: np.ndarray) -> np.ndarray:
    """Per-pair IoU between xyxy boxes; 0 where there is no overlap."""
    lt = np.maximum(hyps[:, :2], refs[:, :2])
    rb = np.minimum(hyps[:, 2:], refs[:, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[:, 0] * wh[:, 1]
    a1 = (hyps[:, 2] - hyps[:, 0]) * (hyps[:, 3] - hyps[:, 1])
    a2 = (refs[:, 2] - refs[:, 0]) * (refs[:, 3] - refs[:, 1])
    return (inter / (a1 + a2 - inter + 1e-6)).astype(np.float32)


def box_iou_accuracy(hyps: np.ndarray, refs: np.ndarray, thresh: float = 0.5) -> np.ndarray:
    """Acc@thresh per box pair (ref: _calculate_ap_score)."""
    return (box_iou(hyps, refs) >= thresh).astype(np.float32)


def pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix [Na, Nb] between xyxy box sets."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    ab = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / (aa[:, None] + ab[None, :] - inter + 1e-6)


def match_detections(
    pred_boxes: np.ndarray,  # [Np, 4] xyxy
    pred_labels: List[str],
    gt_boxes: np.ndarray,  # [Ng, 4] xyxy
    gt_labels: List[str],
    thresh: float = 0.5,
) -> Tuple[int, int, int]:
    """Greedy IoU matching with label agreement → (tp, n_pred, n_gt): each
    prediction may claim at most one ground-truth box of the same label with
    IoU ≥ thresh, matched greedily in decode order."""
    iou = pairwise_iou(np.asarray(pred_boxes, np.float64).reshape(-1, 4),
                       np.asarray(gt_boxes, np.float64).reshape(-1, 4))
    used = np.zeros(len(gt_labels), bool)
    tp = 0
    for i, pl in enumerate(pred_labels):
        cand = [
            j for j in range(len(gt_labels))
            if not used[j] and gt_labels[j] == pl and iou[i, j] >= thresh
        ]
        if cand:
            j = max(cand, key=lambda j: iou[i, j])
            used[j] = True
            tp += 1
    return tp, len(pred_labels), len(gt_labels)


# ---------------------------------------------------------------------------
# allcand candidate scoring (ref: tasks/mm_tasks/vqa_gen.py:244-310,
# snli_ve.py:165-228, image_classify.py:104-265)
# ---------------------------------------------------------------------------

def _score_chunk(params, cfg, enc_tiled, prev, target, masks):
    logits = ofa.decode(params, cfg, prev, enc_tiled).float()
    if masks is not None:
        logits = torch.where(masks, logits, -1e9)
    lprobs = torch.log_softmax(logits, dim=-1)
    tok_lp = torch.gather(lprobs, -1, target[..., None])[..., 0]
    keep = target != cfg.pad
    return torch.where(keep, tok_lp, 0.0).sum(dim=-1)


def score_candidates(
    params,
    cfg: ModelConfig,
    encoder_out: ofa.EncoderOut,  # [B, ...]
    cand_prev: torch.Tensor,  # [B, C, T] decoder inputs (prompt + candidate)
    cand_target: torch.Tensor,  # [B, C, T] targets, pad except candidate span
    cand_masks: Optional[torch.Tensor] = None,  # [B, C, T, V] constraint masks
    chunk_size: Optional[int] = None,  # candidates scored per decoder pass
) -> torch.Tensor:
    """Teacher-forced log-prob score of every candidate → [B, C].

    Encode once, tile the encoder output over candidates, one decoder pass
    per chunk of ``chunk_size`` candidates (C padded to a chunk multiple with
    pad candidates, whose scores are dropped), sum the constrained log-probs
    over the candidate span."""
    B, C, T = cand_prev.shape
    if chunk_size is None or chunk_size >= C:
        enc_tiled = tile_encoder_out(encoder_out, C)
        masks = cand_masks.reshape(B * C, T, -1) if cand_masks is not None else None
        scores = _score_chunk(params, cfg, enc_tiled, cand_prev.reshape(B * C, T),
                              cand_target.reshape(B * C, T), masks)
        return scores.reshape(B, C)

    n_chunks = -(-C // chunk_size)
    padn = n_chunks * chunk_size - C
    pad_c = lambda a, value: torch.cat(
        [a, torch.full((B, padn) + a.shape[2:], value, dtype=a.dtype, device=a.device)], dim=1)
    prev, target = pad_c(cand_prev, cfg.pad), pad_c(cand_target, cfg.pad)
    masks = pad_c(cand_masks, True) if cand_masks is not None else None
    enc_tiled = tile_encoder_out(encoder_out, chunk_size)
    out = []
    for c in range(n_chunks):
        part = lambda a: a[:, c * chunk_size:(c + 1) * chunk_size].reshape(
            (B * chunk_size,) + a.shape[2:])
        out.append(_score_chunk(params, cfg, enc_tiled, part(prev), part(target),
                                part(masks) if masks is not None else None
                                ).reshape(B, chunk_size))
    return torch.cat(out, dim=1)[:, :C]


def score_candidates_span(
    params,
    cfg: ModelConfig,
    encoder_out: ofa.EncoderOut,  # [B, ...]
    cand_prev: torch.Tensor,  # [B, C, T] prompt + candidate decoder inputs
    ans_pos: torch.Tensor,  # [B, Tc] target positions of the answer span
    ans_target: torch.Tensor,  # [C, Tc] answer tokens + eos, pad-padded
    ans_masks: Optional[torch.Tensor] = None,  # [C, Tc, V] constraint masks
    trie=None,  # DenseTrie: build masks on the device from ans_nodes
    ans_nodes: Optional[torch.Tensor] = None,  # [C, Tc] trie cursors
) -> torch.Tensor:
    """Memory-bounded allcand scoring: the decoder's features are sliced to the
    answer span before the output layer, masking and softmax, so no
    ``[*, T, V]`` log-probs exist. The masks depend only on (candidate, span
    position): one ``[C, Tc, V]`` table shared across the batch, gathered from
    the trie cursors when ``trie`` and ``ans_nodes`` are given. → scores [B, C].
    """
    B, C, T = cand_prev.shape
    Tc = ans_pos.shape[1]
    enc_tiled = tile_encoder_out(encoder_out, C)
    feats = ofa.decode(params, cfg, cand_prev.reshape(B * C, T), enc_tiled,
                       features_only=True)  # [B*C, T, d]
    span_idx = ans_pos.repeat_interleave(C, dim=0)  # [B*C, Tc]
    feats_span = torch.gather(feats, 1, span_idx[..., None].expand(-1, -1, feats.shape[-1]))
    logits = ofa.output_layer(params, cfg, feats_span).float().reshape(B, C, Tc, -1)
    if trie is not None and ans_nodes is not None:
        V = logits.shape[-1]
        ans_masks = trie.allowed_mask(ans_nodes.reshape(-1), V).reshape(C, Tc, V)
    if ans_masks is not None:
        logits = torch.where(ans_masks[None], logits, -1e9)
    lprobs = torch.log_softmax(logits, dim=-1)
    tok_lp = torch.gather(lprobs, -1, ans_target[None, :, :, None].expand(B, C, Tc, 1))[..., 0]
    keep = ans_target != cfg.pad
    return torch.where(keep[None], tok_lp, 0.0).sum(dim=-1)


def build_candidate_arrays(
    vocab,
    answers: List[str],
    prompt_prev: np.ndarray,  # [Tp] decoder prompt (e.g. src[:-1]) for ONE sample
    pad_to: Optional[int] = None,
    trie=None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Host-side construction of (prev [C,T], target [C,T], masks [C,T,V])."""
    encs = [vocab.encode_text(" " + a.strip()) for a in answers]
    Tp = len(prompt_prev)
    T = pad_to or (Tp + max(len(e) for e in encs) + 1)
    C = len(answers)
    prev = np.full((C, T), vocab.pad, np.int32)
    target = np.full((C, T), vocab.pad, np.int32)
    masks = None
    if trie is not None:
        masks = np.zeros((C, T, vocab.padded_size), bool)
    for c, e in enumerate(encs):
        seq = np.concatenate([prompt_prev, e]).astype(np.int32)
        prev[c, : len(seq)] = seq[:T]
        tgt = np.concatenate([seq[1:], [vocab.eos]]).astype(np.int32)
        tgt[: Tp - 1] = vocab.pad  # supervise only the answer span
        target[c, : len(tgt)] = tgt[:T]
        if trie is not None:
            node = 0
            for i in range(Tp - 1, min(len(tgt), T)):
                masks[c, i] = trie.allowed_mask_np(node)
                node = trie.transition_np(node, int(tgt[i]))
    return prev, target, masks


# ---------------------------------------------------------------------------
# result aggregation across processes (ref: eval_utils.py:433-460 all_gather_object)
# ---------------------------------------------------------------------------

def merge_results(local_results: List[dict]) -> List[dict]:
    """Gather per-process result lists: the identity in one process, else
    ``torch.distributed.all_gather_object`` over the default group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return local_results
    gathered: List[List[dict]] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local_results)
    out: List[dict] = []
    for part in gathered:
        out.extend(part)
    return out
