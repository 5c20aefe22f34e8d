"""The port's eval tasks against the JAX package's, TSV row to metric, on
``ofa_tiny`` (2 + 2 layers, ResNet (1, 1, 1)) in float32 with one seeded
parameter tree in the JAX layout, carried to the port through ``from_jax``
(random rel-pos tables and BN statistics): each task's ``evaluate`` on the same TSV (written as
``tests/test_tasks.py`` writes its TSVs, with seeded noise images) must return
the same metric dict, predictions included, exactly. The allcand scores
themselves are held to 1e-5 of max|ref|.
"""

import base64
import dataclasses
import io

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
from musketeer_tpu.tokenization import default_vocab as jax_vocab
from musketeer_tpu.utils import eval_utils as jeval
from musketeer_tpu_torch import tasks as ttasks
from musketeer_tpu_torch.config import ModelConfig
from musketeer_tpu_torch.data import FileDataset
from musketeer_tpu_torch.generation import DenseTrie
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.params import from_jax
from musketeer_tpu_torch.tokenization import default_vocab
from musketeer_tpu_torch.utils import eval_utils as teval
from tests.test_tasks import write_tsv
from tests.test_torch_port_search import numpy_tree

REL_TOL = 1e-5
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
    tree = numpy_tree(cfg_t, 0)
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


@pytest.mark.parametrize("case", list(CASES))
def test_task_metrics_match_jax(setup, case):
    name, data, kw, method, bs, *overrides = CASES[case]
    s = setup
    path = s["paths"][data]
    tasks = _task(jtasks, name, s["vocab_j"], kw), _task(ttasks, name, s["vocab_t"], kw)
    for t in tasks:
        if overrides:
            t.set_generation_overrides(**overrides[0])
    ref = getattr(tasks[0], method)(s["params_j"], s["cfg_j"], JaxFileDataset(path), batch_size=bs)
    out = getattr(tasks[1], method)(s["params_t"], s["cfg_t"], FileDataset(path), batch_size=bs)
    assert out == ref
    assert out["n"] == 4 if "n" in ref else len(out) == 3  # gigaword: ROUGE-1/2/L


def test_task_registry_matches_jax():
    ported = set(ttasks.TASK_REGISTRY)
    pretrain = {"text_infilling", "image_text_pair", "image_text_matching", "pure_image",
                "visual_grounding", "image_gen", "detection"}
    assert ported == set(jtasks.TASK_REGISTRY) - pretrain


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
