"""The port's eval tasks against the JAX package's, TSV row to metric, on
``ofa_tiny`` (2 + 2 layers, ResNet (1, 1, 1)) in float32 with one seeded
parameter tree in the JAX layout, carried to the port through ``from_jax``
(random rel-pos tables and BN statistics, and ``row_dependent``'s scalings,
so that the encoded image or source moves the top tokens: with the plain
seeded tree every row of a task decodes to the same tokens, and the metrics
are constants): each task's
``evaluate`` on the same TSV (written as ``tests/test_tasks.py`` writes its
TSVs, with seeded noise images) must return the same metric dict,
predictions included, exactly, and the generation tasks the same per-row
outputs (each decoded token sequence and its text; refcoco's top tokens and
boxes), with at least two rows that differ. The allcand scores themselves
are held to 1e-5 of max|ref|.
"""

import base64
import dataclasses
import io
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from musketeer_tpu import tasks as jtasks
from musketeer_tpu.config import ofa_tiny
from musketeer_tpu.data import FileDataset as JaxFileDataset
from musketeer_tpu.generation.trie import DenseTrie as JaxTrie
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.tasks import tasks as jtasks_module
from musketeer_tpu.tokenization import default_vocab as jax_vocab
from musketeer_tpu.utils import eval_utils as jeval
from musketeer_tpu_torch import tasks as ttasks
from musketeer_tpu_torch.config import ModelConfig
from musketeer_tpu_torch.data import FileDataset
from musketeer_tpu_torch.generation import DenseTrie
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.params import from_jax
from musketeer_tpu_torch.tasks import tasks as ttasks_module
from musketeer_tpu_torch.tokenization import default_vocab
from musketeer_tpu_torch.utils import eval_utils as teval
from tests.test_tasks import write_tsv
from tests.test_torch_port_search import numpy_tree

REL_TOL = 1e-5


def row_dependent(tree):
    """Scale a seeded JAX-layout tree so that its outputs depend on the input
    rows: the decoder's cross-attention output ×64 and its q/k ×4 (sharper,
    larger reads of the encoder), the tied embedding ×¼ (a weaker token prior
    in the logits). ``test_task_rows_match_jax`` asserts the effect."""
    cross = tree["decoder"]["layers"]["encoder_attn"]
    cross["out_proj"]["w"] *= 64.0
    cross["q_proj"]["w"] *= 4.0
    cross["k_proj"]["w"] *= 4.0
    tree["embed_tokens"] *= 0.25
    return tree
VQA_ANSWERS = ["yes", "no", "two", "red", "a dog", "blue car"]
CLASSES = ["tabby cat", "golden retriever", "sports car", "tree"]


def noise_image_b64(rng, w, h):
    img = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.urlsafe_b64encode(buf.getvalue()).decode()


def _vqa_ref(rng):
    picks = rng.choice(len(VQA_ANSWERS), 3, replace=False)
    return "&&".join(f"{c:.1f}|!+{VQA_ANSWERS[i]}" for c, i in zip((1.0, 0.6, 0.3), picks))


def _rows(rng):
    img = lambda w, h: noise_image_b64(rng, w, h)
    return {
        "caption": [[str(i), img(32, 32), f"a thing number {i}&&another thing {i}"]
                    for i in range(4)],
        # boxes over most of the image, so that the predicted boxes overlap them
        "refcoco": [[str(i), img(64, 48), f"the object {i}", f"{i}.0,{i}.5,{64 - 3 * i}.0,48.0"]
                    for i in range(4)],
        "snli_ve": [[str(i), img(32, 32), "a dog runs", f"an animal {i}",
                     ["entailment", "neutral", "contradiction"][i % 3]] for i in range(4)],
        "vqa_gen": [[str(i), img(32, 32), f"what is object {i}", _vqa_ref(rng)] for i in range(4)],
        "image_classify": [[str(i), img(40, 32), CLASSES[i % 4]] for i in range(4)],
        "cola": [["the cat sat", "1"], ["cat the sat on", "0"], ["dogs bark loudly", "1"],
                 ["loudly bark the", "0"]],
        "mrpc": [["he left early", "he went home early", "1"], ["it rains", "the sun shines", "0"],
                 ["a b c", "a b c", "1"], ["one two", "three four", "0"]],
        "gigaword": [[f"the minister said on day {i} that talks will resume soon", f"talks to resume {i}"]
                     for i in range(4)],
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg_j = dataclasses.replace(ofa_tiny(), dtype="float32", use_flash_attention=True,
                                encoder_layers=2, decoder_layers=2, resnet_layers=(1, 1, 1))
    cfg_t = ModelConfig(**dataclasses.asdict(cfg_j))
    tree = row_dependent(numpy_tree(cfg_t, 0))
    d = tmp_path_factory.mktemp("tsv")
    paths = {k: write_tsv(d / f"{k}.tsv", rows)
             for k, rows in _rows(np.random.RandomState(11)).items()}
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=jax.tree.map(jnp.asarray, tree),
                params_t=from_jax(tree, cfg_t, "cpu", torch.float32), paths=paths,
                vocab_j=jax_vocab(), vocab_t=default_vocab())


# id: (task name, data, constructor kwargs, evaluate method, batch size, generation overrides)
CASES = {
    "caption": ("CaptionTask", "caption", dict(patch_image_size=32), "evaluate", 2),
    "refcoco": ("RefcocoTask", "refcoco", dict(patch_image_size=32), "evaluate", 2),
    "snli_ve": ("SnliVeTask", "snli_ve", dict(patch_image_size=32), "evaluate", 2),
    "vqa_allcand": ("VqaTask", "vqa_gen", dict(patch_image_size=32, answers=VQA_ANSWERS),
                    "evaluate", 2),
    "vqa_beam": ("VqaTask", "vqa_gen", dict(patch_image_size=32, answers=VQA_ANSWERS),
                 "evaluate_beam", 2),
    "vqa_zero_shot": ("VqaTask", "vqa_gen", dict(patch_image_size=32, answers=VQA_ANSWERS),
                      "evaluate_zero_shot", 2),
    "image_classify": ("ImageClassifyTask", "image_classify",
                       dict(patch_image_size=32, answers=CLASSES), "evaluate", 2),
    "cola": ("cola", "cola", {}, "evaluate", 2),
    "mrpc": ("mrpc", "mrpc", {}, "evaluate", 4),
    "gigaword": ("GigawordTask", "gigaword", dict(max_src_length=24), "evaluate", 2,
                 dict(max_len_b=12)),
}


def _task(module, name, vocab, kw):
    if name in module.TASK_REGISTRY and name.islower():
        return module.TASK_REGISTRY[name](vocab, description="base", **kw)
    return getattr(module, name)(vocab, description="base", **kw)


def _recorded(task, module, run):
    """``run()``'s result, with every (ids, text) the task decodes and every
    (top tokens, boxes) it de-bins, in call order: the per-row outputs."""
    decoded, boxes = [], []
    decode_ids, debin = task.vocab.decode_ids, module.debin_boxes

    def decode(ids):
        text = decode_ids(ids)
        decoded.append(([int(t) for t in ids], text))
        return text

    def debin_rec(bins, *a):
        out = debin(bins, *a)
        boxes.append((np.array(bins), np.array(out)))
        return out

    with mock.patch.object(task.vocab, "decode_ids", decode), \
            mock.patch.object(module, "debin_boxes", debin_rec):
        result = run()
    return result, decoded, boxes


@pytest.fixture(scope="module")
def evaluated(setup):
    """case → each side's (metrics, decoded rows, de-binned rows), run once."""
    runs = {}

    def run(case):
        if case not in runs:
            name, data, kw, method, bs, *overrides = CASES[case]
            s = setup
            path = s["paths"][data]
            tasks = _task(jtasks, name, s["vocab_j"], kw), _task(ttasks, name, s["vocab_t"], kw)
            for t in tasks:
                if overrides:
                    t.set_generation_overrides(**overrides[0])
            ref = _recorded(tasks[0], jtasks_module, lambda: getattr(tasks[0], method)(
                s["params_j"], s["cfg_j"], JaxFileDataset(path), batch_size=bs))
            out = _recorded(tasks[1], ttasks_module, lambda: getattr(tasks[1], method)(
                s["params_t"], s["cfg_t"], FileDataset(path), batch_size=bs))
            runs[case] = ref, out, tasks[1]
        return runs[case]

    return run


@pytest.mark.parametrize("case", list(CASES))
def test_task_metrics_match_jax(evaluated, case):
    (ref, _, _), (out, _, _), _ = evaluated(case)
    assert out == ref
    assert out["n"] == 4 if "n" in ref else len(out) == 3  # gigaword: ROUGE-1/2/L


GENERATION_CASES = ("caption", "refcoco", "vqa_beam", "vqa_zero_shot", "gigaword")


@pytest.mark.parametrize("case", GENERATION_CASES)
def test_task_rows_match_jax(setup, evaluated, case):
    """Per row, on the same collated batches: the decoded tokens and text
    (captions, VQA answers, summaries), refcoco's top tokens and boxes; and
    the fixture makes at least two rows differ, so that a constant output
    cannot pass."""
    (_, dec_j, box_j), (_, dec_t, box_t), task_t = evaluated(case)
    if case == "refcoco":
        assert len(box_t) == len(box_j) == 2  # two batches of 2
        rows = []
        for (bins_j, b_j), (bins_t, b_t) in zip(box_j, box_t):
            np.testing.assert_array_equal(bins_t, bins_j)
            np.testing.assert_array_equal(b_t, b_j)
            rows += [tuple(r) for r in bins_t]
    else:
        assert len(dec_t) == len(dec_j) == 4
        assert dec_t == dec_j
        rows = [tuple(ids) for ids, _ in dec_t]
    assert len(set(rows)) >= 2, f"{case}: every row gave {rows[0]}"
    if case == "gigaword":  # the port's generation half of evaluate, on its own
        from musketeer_tpu.utils.summary_detok import normalize_summary_hyp

        s = setup
        hyps = task_t.hypotheses(s["params_t"], s["cfg_t"], FileDataset(s["paths"]["gigaword"]),
                                 batch_size=CASES[case][4])
        assert [h for _, h in hyps] == [normalize_summary_hyp(text) for _, text in dec_j]


def test_task_registry_matches_jax():
    """Every JAX task, ``image_gen`` included: the registries are equal."""
    assert set(ttasks.TASK_REGISTRY) == set(jtasks.TASK_REGISTRY)
    assert ttasks.TASK_REGISTRY["image_gen"] is ttasks.ImageGenTask


def test_allcand_scores_match_jax(setup):
    """``score_candidates_span`` (trie masks from the cursors) and the chunked
    ``score_candidates`` on the same inputs: within 1e-5 of max|ref|."""
    s = setup
    rng = np.random.RandomState(5)
    Bq, C, T, Tc, S = 2, 5, 9, 3, 7
    src = rng.randint(4, 3000, (Bq, S)).astype(np.int32)
    src[:, -1] = 2
    imgs = rng.randn(Bq, 32, 32, 3).astype(np.float32)
    masks = np.ones((Bq,), bool)
    enc_j = jax.jit(lambda p, *a: jofa.encode(p, s["cfg_j"], *a))(
        s["params_j"], jnp.asarray(src), jnp.asarray(imgs), jnp.asarray(masks))
    enc_t = ofa.encode(s["params_t"], s["cfg_t"], torch.from_numpy(src).long(),
                       torch.from_numpy(imgs), torch.from_numpy(masks))
    seqs = [[100, 200, 2], [100, 300, 2], [400, 2], [500, 501, 2], [600, 2]]
    prev = rng.randint(4, 3000, (Bq, C, T)).astype(np.int32)
    ans_pos = np.stack([np.arange(Tc) + 4, np.arange(Tc) + 5]).astype(np.int32)
    ans_target = np.full((C, Tc), 1, np.int32)
    ans_nodes = np.full((C, Tc), -1, np.int32)
    jtrie, ttrie = JaxTrie(seqs, 59520), DenseTrie(seqs, 59520, "cpu")
    for c, seq in enumerate(seqs):
        ans_target[c, :len(seq)] = seq
        node = 0
        for i, t in enumerate(seq):
            ans_nodes[c, i] = node
            node = jtrie.transition_np(node, t)
    span = jax.jit(lambda p, e, *a: jeval.score_candidates_span(
        p, s["cfg_j"], e, *a[:3], trie=jtrie, ans_nodes=a[3]))
    ref = np.asarray(span(s["params_j"], enc_j, jnp.asarray(prev), jnp.asarray(ans_pos),
                          jnp.asarray(ans_target), jnp.asarray(ans_nodes)))
    with torch.inference_mode():
        out = teval.score_candidates_span(
            s["params_t"], s["cfg_t"], enc_t, torch.from_numpy(prev).long(),
            torch.from_numpy(ans_pos).long(), torch.from_numpy(ans_target).long(),
            trie=ttrie, ans_nodes=torch.from_numpy(ans_nodes).long()).numpy()
    assert np.abs(out - ref).max() <= REL_TOL * np.abs(ref).max()

    target = np.where(rng.rand(Bq, C, T) < 0.5, prev, 1).astype(np.int32)
    full = jax.jit(lambda p, e, *a: jeval.score_candidates(p, s["cfg_j"], e, *a, chunk_size=2))
    ref = np.asarray(full(s["params_j"], enc_j, jnp.asarray(prev), jnp.asarray(target)))
    with torch.inference_mode():
        out = teval.score_candidates(s["params_t"], s["cfg_t"], enc_t,
                                     torch.from_numpy(prev).long(),
                                     torch.from_numpy(target).long(), chunk_size=2).numpy()
    assert np.abs(out - ref).max() <= REL_TOL * np.abs(ref).max()
