"""Concrete task implementations (port of ``musketeer_tpu/tasks/tasks.py``).

Each task wires: builder → device compute (beam search or allcand scorer) →
host-side metric. Decode configs mirror the reference eval scripts (cited).
Where the JAX task jits its device work, this one calls it under
``torch.inference_mode()`` on the device of the parameters the caller built
(an ensemble: a list of trees on one device); on the card the encoder and the
teacher-forced decoder run K1 and the fast beam path K2.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import GenerationConfig
from ..data import task_data as D
from ..generation import DenseTrie, beam_search, generate
from ..models import ofa
from ..utils.cider import CiderD
from ..utils.eval_utils import box_iou, box_iou_accuracy, debin_boxes, score_candidates_span
from ..utils.summary_detok import normalize_summary_hyp
from .base import Task, iter_batches, params_device, to_device


def _image_inputs(batch, device):
    """(src_tokens, patch_images fp32, patch_masks) of a collated batch on ``device``."""
    return (to_device(batch["src_tokens"], device),
            to_device(batch["patch_images"], device, torch.float32),
            to_device(batch["patch_masks"], device))


def _text(v, toks_row) -> str:
    """A hypothesis's ids without pad and eos → text."""
    return v.decode_ids([int(t) for t in toks_row if t not in (v.pad, v.eos)])


class CaptionTask(Task):
    """COCO caption: beam=5 gen + CIDEr-D (ref: tasks/mm_tasks/caption.py,
    run_scripts/caption/evaluate_caption_base.sh:36-57)."""

    name = "caption"

    def builder(self, split: str = "train"):
        return D.CaptionBuilder(
            self.vocab, description=self.description, split=split, **self.kw
        )

    def generation_config(self) -> GenerationConfig:
        return GenerationConfig(
            beam_size=5, max_len_b=16, min_len=1, no_repeat_ngram_size=3
        )

    def evaluate(self, params, model_cfg, dataset, batch_size=8, limit=None):
        gen_cfg = self.generation_config()
        v = self.vocab
        device = params_device(params)
        gts, res = {}, {}
        b = self.builder("valid")
        with torch.inference_mode():
            # generate() takes a list of param trees as an ensemble
            for batch in iter_batches(
                dataset, b, batch_size, v.pad, src_len=None, limit=limit, drop_last=True
            ):
                toks, _ = generate(params, model_cfg, gen_cfg, *_image_inputs(batch, device))
                toks = toks.cpu().numpy()
                for i, uid in enumerate(batch["id"]):
                    res[str(uid)] = _text(v, toks[i, 0])
                    refs = batch["extras"][i]["caption_refs"].split("&&")
                    gts[str(uid)] = [r.strip() for r in refs]
        score, _ = CiderD().compute_score(gts, res)
        out = {"cider": score, "n": len(res), "predictions": res}
        try:  # BLEU via sacrebleu (ref: caption.py:139-163 eval_bleu path)
            import sacrebleu

            max_refs = max(len(r) for r in gts.values())
            ref_streams = [
                [gts[i][k] if k < len(gts[i]) else gts[i][0] for i in res]
                for k in range(max_refs)
            ]
            out["bleu4"] = sacrebleu.corpus_bleu(
                [res[i] for i in res], ref_streams
            ).score
        except Exception:
            pass
        return out


class RefcocoTask(Task):
    """Visual grounding: gen_box beam → de-bin → IoU@0.5
    (ref: tasks/mm_tasks/refcoco.py:125-157; utils/eval_utils.py:220-253)."""

    name = "refcoco"

    def __init__(self, *a, max_image_size: int = 512, **kw):
        super().__init__(*a, **kw)
        self.max_image_size = max_image_size

    def builder(self, split: str = "train"):
        return D.RefcocoBuilder(
            self.vocab, description=self.description, split=split,
            max_image_size=self.max_image_size, **self.kw
        )

    def generation_config(self) -> GenerationConfig:
        v = self.vocab
        return GenerationConfig(
            beam_size=5, max_len_b=4, min_len=4, no_repeat_ngram_size=3,
            gen_box=True, constraint_range=(v.bin_start, v.vocab_size),
        )

    def evaluate(self, params, model_cfg, dataset, batch_size=8, limit=None):
        gen_cfg = self.generation_config()
        v = self.vocab
        device = params_device(params)
        accs, ious = [], []
        with torch.inference_mode():
            for batch in iter_batches(
                dataset, self.builder("valid"), batch_size, v.pad, limit=limit, drop_last=True
            ):
                toks, _ = generate(params, model_cfg, gen_cfg, *_image_inputs(batch, device))
                bins = toks.cpu().numpy()[:, 0, :4]  # top hypo, 4 bin tokens
                w_r = np.asarray([e["w_resize_ratio"] for e in batch["extras"]])
                h_r = np.asarray([e["h_resize_ratio"] for e in batch["extras"]])
                boxes = debin_boxes(
                    bins, v.bin_start, v.num_bins, self.max_image_size, w_r, h_r
                )
                refs = np.stack([e["region_coord"] for e in batch["extras"]])
                accs.append(box_iou_accuracy(boxes, refs))
                ious.append(box_iou(boxes, refs))
        acc = float(np.concatenate(accs).mean()) if accs else 0.0
        miou = float(np.concatenate(ious).mean()) if ious else 0.0
        return {
            "acc@0.5": acc,
            "mean_iou": miou,  # finer-grained convergence signal than acc@0.5
            "n": int(sum(len(a) for a in accs)),
        }


class AllCandTask(Task):
    """Shared machinery for closed-vocabulary tasks (VQA / SNLI-VE /
    ImageNet / GLUE): score every candidate answer with teacher forcing +
    constraint masks, argmax (ref: tasks/mm_tasks/vqa_gen.py:244-310).

    Candidates are scored in chunks of ``valid_batch_size`` (the last chunk
    filled with repeats of its last candidate) with span-sliced logits, so
    memory per call is [B, chunk, Tc, V] with Tc = answer length + 1.
    """

    name = ""
    answers: List[str] = []
    prompt_type = "prev_output"
    valid_batch_size = 20  # candidates per scoring call (ref default)

    def __init__(self, *a, answers: Optional[Sequence[str]] = None, **kw):
        super().__init__(*a, **kw)
        if answers is not None:
            self.answers = list(answers)
        # host tables for the builders; each evaluate takes ``trie.on(device)``
        self.trie = DenseTrie.from_answers(self.vocab, self.answers, device=None)
        self._ans_enc = [
            self.vocab.encode_text(" " + a.strip()) for a in self.answers
        ]
        v = self.vocab
        C = len(self.answers)
        # no candidate set (zero-shot VQA removes the trie): no allcand tables
        self.Tc = (max(len(e) for e in self._ans_enc) + 1) if C else 1
        self._ans_target = np.full((C, self.Tc), v.pad, np.int64)
        self._ans_nodes = np.full((C, self.Tc), -1, np.int64)
        for c, e in enumerate(self._ans_enc):
            seq = list(e) + [v.eos]
            self._ans_target[c, : len(seq)] = seq
            node = 0
            for i, t in enumerate(seq):
                self._ans_nodes[c, i] = node
                node = self.trie.transition_np(node, int(t))

    def _assemble_prev(self, src_rows: List[np.ndarray], chunk_enc: List[np.ndarray],
                       padded_src: int):
        """[B, chunk, T] decoder inputs + [B, Tc] answer-span positions for
        prompt_type=prev_output (ref: vqa_gen_dataset.py:162-173); T is keyed
        on the bucketed source width, as in the JAX task."""
        v = self.vocab
        B, C = len(src_rows), len(chunk_enc)
        T = padded_src - 1 + self.Tc
        prev = np.full((B, C, T), v.pad, np.int64)
        ans_pos = np.zeros((B, self.Tc), np.int64)
        for b, src in enumerate(src_rows):
            L = len(src) - 1  # drop final eos
            prev[b, :, :L] = src[:-1]
            for c, e in enumerate(chunk_enc):
                prev[b, c, L : L + len(e)] = e
            ans_pos[b] = (L - 1) + np.arange(self.Tc)
        return prev, ans_pos

    def _eval_common(self, params, model_cfg, dataset, batch_size, limit, with_image):
        v = self.vocab
        C = len(self.answers)
        if C == 0:
            raise ValueError(
                f"{self.name}: allcand scoring needs a candidate answer set "
                "(pass answers=), or use the zero-shot path"
            )
        device = params_device(params)
        trie = self.trie.on(device)
        chunk = min(self.valid_batch_size, C)
        n_correct, n_total, soft_sum = 0, 0, 0.0
        pairs: List[tuple] = []
        builder = self.builder("valid")
        with torch.inference_mode():
            for batch in iter_batches(
                dataset, builder, batch_size, v.pad, limit=limit, drop_last=True
            ):
                src_rows = [
                    np.asarray([t for t in row if t != v.pad], np.int32)
                    for row in batch["src_tokens"]
                ]
                if with_image:
                    enc = ofa.encode(params, model_cfg, *_image_inputs(batch, device))
                else:
                    enc = ofa.encode(params, model_cfg, to_device(batch["src_tokens"], device))
                all_scores = []
                for c0 in range(0, C, chunk):
                    c1 = min(c0 + chunk, C)
                    idxs = list(range(c0, c1))
                    while len(idxs) < chunk:  # the JAX task's static chunk shape
                        idxs.append(c1 - 1)
                    prev, ans_pos = self._assemble_prev(
                        src_rows, [self._ans_enc[i] for i in idxs],
                        batch["src_tokens"].shape[1],
                    )
                    scores = score_candidates_span(
                        params, model_cfg, enc, to_device(prev, device),
                        to_device(ans_pos, device), to_device(self._ans_target[idxs], device),
                        trie=trie, ans_nodes=to_device(self._ans_nodes[idxs], device),
                    )
                    all_scores.append(scores.cpu().numpy()[:, : c1 - c0])
                scores = np.concatenate(all_scores, axis=1)  # [B, C]
                pred_idx = scores.argmax(axis=1)
                for i, e in enumerate(batch["extras"]):
                    pred = self.answers[pred_idx[i]]
                    ref = e.get("ref_dict", {e.get("label"): 1.0})
                    soft_sum += ref.get(pred, 0.0)
                    n_correct += int(pred == max(ref, key=ref.get))
                    n_total += 1
                    pairs.append((pred, max(ref, key=ref.get)))
        return {
            "acc": n_correct / max(1, n_total),
            "soft_score": soft_sum / max(1, n_total),
            "n": n_total,
            "pairs": pairs,
        }


class SnliVeTask(AllCandTask):
    name = "snli_ve"
    answers = ["no", "yes", "maybe"]

    def builder(self, split="train"):
        return D.SnliVeBuilder(
            self.vocab, description=self.description, split=split,
            trie=self.trie, **self.kw
        )

    def evaluate(self, params, model_cfg, dataset, batch_size=8, limit=None):
        return self._eval_common(params, model_cfg, dataset, batch_size, limit, True)


class VqaTask(AllCandTask):
    name = "vqa_gen"

    def builder(self, split="train"):
        return D.VqaBuilder(
            self.vocab, description=self.description, split=split,
            trie=self.trie, **self.kw
        )

    def evaluate(self, params, model_cfg, dataset, batch_size=4, limit=None):
        return self._eval_common(params, model_cfg, dataset, batch_size, limit, True)

    def evaluate_beam(self, params, model_cfg, dataset, batch_size=4, limit=None):
        """Trie-constrained beam-search VQA eval (ref run script
        evaluate_vqa_beam_base.sh --beam-search-vqa-eval: vqa_gen.py:184-189
        builds a constrained generator, :311-318 generates with the question
        as ``prefix_tokens``, strips the per-row prefix and soft-scores the
        suffix against ref_dict)."""
        if not self.answers:
            raise ValueError("beam VQA eval needs the answer trie")
        v = self.vocab
        device = params_device(params)
        trie = self.trie.on(device)
        soft_sum, n = 0.0, 0
        with torch.inference_mode():
            for batch in iter_batches(
                dataset, self.builder("valid"), batch_size, v.pad, limit=limit, drop_last=True
            ):
                src = np.asarray(batch["src_tokens"])
                # decoder prompt = question without bos/eos (prompt_type
                # prev_output; right-padded per-row prompts, pads unforced)
                pref = src[:, 1:].copy()
                pref[pref == v.eos] = v.pad
                gen_cfg = GenerationConfig(
                    beam_size=5, min_len=1, normalize_scores=False,
                    max_len_b=pref.shape[1] + self.Tc + 1,
                )
                toks, _ = generate(params, model_cfg, gen_cfg, *_image_inputs(batch, device),
                                   prefix_tokens=to_device(pref, device), trie=trie)
                toks = toks.cpu().numpy()
                for i, e in enumerate(batch["extras"]):
                    plen = int((pref[i] != v.pad).sum())
                    seq = []
                    for t in toks[i, 0, plen:]:
                        if t == v.eos:
                            break
                        if t != v.pad:
                            seq.append(int(t))
                    pred = v.decode_ids(seq).strip()
                    soft_sum += e["ref_dict"].get(pred, 0.0)
                    n += 1
        return {"soft_score": soft_sum / max(1, n), "n": n}

    def evaluate_zero_shot(self, params, model_cfg, dataset, batch_size=4, limit=None):
        """Open-vocabulary beam decode, no trie (ref: utils/zero_shot_utils.py:
        40-46 — generator.zero_shot=True, constraint trie removed)."""
        gen_cfg = GenerationConfig(
            beam_size=5, max_len_b=8, min_len=1, zero_shot=True
        )
        v = self.vocab
        device = params_device(params)
        soft_sum, n = 0.0, 0
        with torch.inference_mode():
            for batch in iter_batches(
                dataset, self.builder("valid"), batch_size, v.pad, limit=limit, drop_last=True
            ):
                enc = ofa.encode(params, model_cfg, *_image_inputs(batch, device))
                toks, _ = beam_search(params, model_cfg, gen_cfg, enc, max_len=gen_cfg.max_len_b)
                toks = toks.cpu().numpy()
                for i, e in enumerate(batch["extras"]):
                    soft_sum += e["ref_dict"].get(_text(v, toks[i, 0]), 0.0)
                    n += 1
        return {"zero_shot_score": soft_sum / max(1, n), "n": n}


class ImageClassifyTask(AllCandTask):
    name = "image_classify"

    def builder(self, split="train"):
        return D.ImageClassifyBuilder(
            self.vocab, description=self.description, split=split,
            trie=self.trie, **self.kw
        )

    def evaluate(self, params, model_cfg, dataset, batch_size=4, limit=None):
        return self._eval_common(params, model_cfg, dataset, batch_size, limit, True)


class GlueTask(AllCandTask):
    def __init__(self, glue_task: str, *a, **kw):
        self.name = glue_task
        self.glue_task = glue_task
        label_map = D.GlueBuilder.TASK_DEFS[glue_task][2]
        answers = sorted(set(label_map.values()))
        super().__init__(*a, answers=answers, **kw)

    def builder(self, split="train"):
        return D.GlueBuilder(
            self.glue_task, self.vocab, description=self.description,
            trie=self.trie, **self.kw
        )

    def evaluate(self, params, model_cfg, dataset, batch_size=8, limit=None):
        out = self._eval_common(params, model_cfg, dataset, batch_size, limit, False)
        if self.glue_task == "cola":
            out["mcc"] = self._mcc(out.pop("pairs"))
        else:
            out.pop("pairs", None)
        return out

    @staticmethod
    def _mcc(pairs):
        """Matthews correlation from (pred, ref) yes/no pairs
        (ref: tasks/nlu_tasks/cola.py:107-160)."""
        tp = fp = tn = fn = 0
        for pred, ref in pairs:
            p, r = pred == "yes", ref == "yes"
            tp += p and r
            fp += p and not r
            tn += (not p) and (not r)
            fn += (not p) and r
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return (tp * tn - fp * fn) / denom if denom > 0 else 0.0


class GigawordTask(Task):
    """Summarization: beam gen + ROUGE-1/2/L
    (ref: tasks/nlg_tasks/gigaword.py:195-268)."""

    name = "gigaword"

    def builder(self, split="train"):
        return D.GigawordBuilder(
            self.vocab, description=self.description, split=split, **self.kw
        )

    def generation_config(self):
        return GenerationConfig(
            beam_size=5, max_len_b=32, min_len=1, no_repeat_ngram_size=3
        )

    def hypotheses(self, params, model_cfg, dataset, batch_size=8, limit=None):
        """(reference summary, normalized hypothesis) pairs: the generation
        half of ``evaluate``, without ROUGE."""
        gen_cfg = self.generation_config()
        v = self.vocab
        device = params_device(params)
        out = []
        with torch.inference_mode():
            for batch in iter_batches(
                dataset, self.builder("valid"), batch_size, v.pad, limit=limit, drop_last=True
            ):
                toks, _ = generate(params, model_cfg, gen_cfg,
                                   to_device(batch["src_tokens"], device))
                toks = toks.cpu().numpy()
                for i, e in enumerate(batch["extras"]):
                    # ref normalization before ROUGE (gigaword.py:283):
                    # lower + fix_tokenization + <unk>/digit rewrites
                    out.append((e["target_text"], normalize_summary_hyp(_text(v, toks[i, 0]))))
        return out

    def evaluate(self, params, model_cfg, dataset, batch_size=8, limit=None):
        from rouge_score import rouge_scorer

        scorer = rouge_scorer.RougeScorer(
            ["rouge1", "rouge2", "rougeL"], use_stemmer=True
        )
        agg: Dict[str, list] = {"rouge1": [], "rouge2": [], "rougeL": []}
        for target, hyp in self.hypotheses(params, model_cfg, dataset, batch_size, limit):
            s = scorer.score(target, hyp)
            for k in agg:
                agg[k].append(s[k].fmeasure)
        return {k: float(np.mean(vs)) if vs else 0.0 for k, vs in agg.items()}


def _pretrain_entries():
    # detection registers in tasks/__init__.py, as in the JAX package
    from .pretrain import (
        ImageTextMatchingTask, ImageTextPairTask, PureImageTask, TextInfillingTask,
        VisualGroundingTask,
    )

    return {
        "text_infilling": TextInfillingTask,
        "image_text_pair": ImageTextPairTask,
        "image_text_matching": ImageTextMatchingTask,
        "pure_image": PureImageTask,
        "visual_grounding": VisualGroundingTask,
    }


TASK_REGISTRY = {
    "caption": CaptionTask,
    "refcoco": RefcocoTask,
    "vqa_gen": VqaTask,
    "snli_ve": SnliVeTask,
    "image_classify": ImageClassifyTask,
    "gigaword": GigawordTask,
    "cola": lambda *a, **kw: GlueTask("cola", *a, **kw),
    "sst2": lambda *a, **kw: GlueTask("sst2", *a, **kw),
    "mrpc": lambda *a, **kw: GlueTask("mrpc", *a, **kw),
    "qqp": lambda *a, **kw: GlueTask("qqp", *a, **kw),
    "qnli": lambda *a, **kw: GlueTask("qnli", *a, **kw),
    "rte": lambda *a, **kw: GlueTask("rte", *a, **kw),
    "mnli": lambda *a, **kw: GlueTask("mnli", *a, **kw),
}
TASK_REGISTRY.update(_pretrain_entries())
