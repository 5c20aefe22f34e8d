"""The port's host-side eval modules against the JAX package's: tokenizer, data
builders and ``collate``, the TSV reader, CIDEr, the summary normalizer, the
trie and lexical-constraint tables, the eval utilities, and the search's
sampling filter and n-gram ban (no JAX program of the model is compiled).

Tolerances: BPE ids, examples, batches, trie and constraint tables, boxes,
IoU and CIDEr exactly equal; the sampling filter exactly equal on the same
log-probs; the categorical draw (whose PRNG cannot match JAX's) by its
statistics.
"""

import dataclasses
import importlib
import sys
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from musketeer_tpu import data as jdata
from musketeer_tpu.generation import lexical as jlex
from musketeer_tpu.generation.beam_search import _apply_no_repeat_ngram as jax_no_repeat
from musketeer_tpu.generation.trie import DenseTrie as JaxTrie
from musketeer_tpu.tokenization import default_vocab as jax_vocab
from musketeer_tpu.utils import cider as jcider
from musketeer_tpu.utils import eval_utils as jeval
from musketeer_tpu.utils import summary_detok as jdetok
from musketeer_tpu_torch import data as tdata
from musketeer_tpu_torch.generation import lexical as tlex
from musketeer_tpu_torch.generation.trie import DenseTrie
from musketeer_tpu_torch.tasks import batch_to_taskbatch
from musketeer_tpu_torch.tokenization import bpe as tbpe
from musketeer_tpu_torch.tokenization import default_vocab
from musketeer_tpu_torch.utils import cider as tcider
from musketeer_tpu_torch.utils import eval_utils as teval
from musketeer_tpu_torch.utils import summary_detok as tdetok
from tests.test_data import fake_image_b64

# the module, not the function the package exports under its name
tbs = importlib.import_module("musketeer_tpu_torch.generation.beam_search")

CORPUS = [
    "a man riding a horse on a sandy beach.",
    "Two dogs play with a frisbee in the park, while kids watch!",
    "Café crème, naïve façade, jalapeño, Ærøskøbing, Łódź, İstanbul",
    "東京タワーの夜景 and 北京烤鸭 with 한국어 텍스트",
    "x² + y² = r², ½ cup, ¾ mile, ⅓ off, 10³ m",
    "emoji 😀🎉👍🏽 family 👨‍👩‍👧 flag 🇯🇵",
    "it's   they're  we've I'm you'll he'd\t\ttabs\n\nnew lines  ",
    "€100, £5.99, 50% off; (parens) [brackets] {braces} <tags> #hash @at",
    "Ünïcödé ٣٤٥ digits ३४५ and  non-breaking spaces　ideographic",
]


@pytest.fixture(scope="module")
def vocabs():
    return jax_vocab(), default_vocab()


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,pattern", [("L", r"\p{L}"), ("N", r"\p{N}"), ("space", r"\s")])
def test_pattern_classes_match_regex(name, pattern):
    """Each class of the stdlib pattern holds exactly the code points that
    ``regex``'s class matches, over every code point unicodedata assigns."""
    ranges = tbpe.unicode_classes()[name]
    ours = np.zeros(sys.maxunicode + 1, bool)
    for lo, hi in ranges:
        ours[lo:hi + 1] = True
    ref = regex.compile(pattern)
    bad = [cp for cp in range(sys.maxunicode + 1)
           if unicodedata.category(chr(cp)) != "Cn" and bool(ref.match(chr(cp))) != ours[cp]]
    assert not bad, [hex(cp) for cp in bad[:10]]


@pytest.mark.parametrize("text", CORPUS)
def test_bpe_ids_match_jax(vocabs, text):
    jv, tv = vocabs
    assert tbpe.gpt2_pattern().findall(text) == regex.findall(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""", text)
    assert tv.bpe.encode(text) == jv.bpe.encode(text)
    ids = tv.encode_text(" " + text, append_bos=True, append_eos=True)
    np.testing.assert_array_equal(ids, jv.encode_text(" " + text, append_bos=True, append_eos=True))
    assert tv.decode_ids(ids) == jv.decode_ids(ids)


def test_vocab_layout_matches_jax(vocabs):
    jv, tv = vocabs
    for attr in ("vocab_size", "padded_size", "code_start", "bin_start", "mask_index",
                 "bos", "pad", "eos", "unk"):
        assert getattr(tv, attr) == getattr(jv, attr), attr
    assert (tv.vocab_size, tv.padded_size) == (59457, 59520)
    assert tv.dict.symbols == jv.dict.symbols
    bins = [tv.bin_token(3), tv.code_token(5), 7]
    assert tv.decode_ids(bins) == jv.decode_ids(bins)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

ANSWERS = ["yes", "no", "two", "red car", "a small dog"]
ROWS = {
    "caption": (["7", fake_image_b64(40, 30), "A dog, on the beach!&&a puppy runs"], {}),
    "refcoco": (["8", fake_image_b64(64, 48), "the Left-most / red car", "5.0,6.5,30.0,40.0"],
                dict(max_image_size=512)),
    "vqa": (["9", fake_image_b64(32, 32), "What color is the car", "0.6|!+red car&&1.0|!+two",
             "car&&road"], dict(add_object=True)),
    "snli": (["10", fake_image_b64(32, 32), "A dog runs.", "An animal moving", "neutral"], {}),
    "image_classify": (["11", fake_image_b64(50, 20), "a small dog"], {}),
    "gigaword": (["The Minister SAID on monday that talks will resume", "talks to resume"], {}),
    "cola": (["The cat sat on the mat.", "1"], {}),
    "mrpc": (["He said hi.", "He greeted us.", "0"], {}),
}
BUILDERS = {"caption": "CaptionBuilder", "refcoco": "RefcocoBuilder", "vqa": "VqaBuilder",
            "snli": "SnliVeBuilder", "image_classify": "ImageClassifyBuilder",
            "gigaword": "GigawordBuilder", "cola": "GlueBuilder", "mrpc": "GlueBuilder"}


def _builders(name, vocabs):
    jv, tv = vocabs
    row, kw = ROWS[name]
    kw = dict(kw, description="base", split="valid", patch_image_size=32)
    args = (name,) if name in ("cola", "mrpc") else ()
    if name in ("vqa", "snli", "image_classify", "cola"):
        jkw = dict(kw, trie=JaxTrie.from_answers(jv, ANSWERS))
        tkw = dict(kw, trie=DenseTrie.from_answers(tv, ANSWERS, None))
    else:
        jkw = tkw = kw
    jb = getattr(jdata, BUILDERS[name])(*args, jv, **jkw)
    tb = getattr(tdata, BUILDERS[name])(*args, tv, **tkw)
    return row, jb, tb


def _assert_examples_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif f.name == "extras":
            assert x.keys() == y.keys()
            for k in x:
                if isinstance(x[k], np.ndarray):
                    np.testing.assert_array_equal(x[k], y[k])
                else:
                    assert x[k] == y[k], k
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", list(ROWS))
def test_builder_examples_match_jax(vocabs, name):
    row, jb, tb = _builders(name, vocabs)
    _assert_examples_equal(jb(row), tb(row))


@pytest.mark.parametrize("name", ["vqa", "refcoco", "gigaword", "cola"])
def test_collate_matches_jax(vocabs, name):
    row, jb, tb = _builders(name, vocabs)
    rows = [row, row[:1] + [c + " again" if i == 2 else c for i, c in enumerate(row[1:], 1)]]
    if name in ("gigaword", "cola"):
        rows[1] = [row[0] + " and more words here"] + row[1:]
    jbatch = jdata.collate([jb(r) for r in rows], pad_id=1)
    tbatch = tdata.collate([tb(r) for r in rows], pad_id=1)
    assert jbatch.keys() == tbatch.keys()
    for k in jbatch:
        if isinstance(jbatch[k], np.ndarray):
            np.testing.assert_array_equal(jbatch[k], tbatch[k], err_msg=k)
    tb_ = batch_to_taskbatch(tbatch, "cpu", accum=True)
    assert tuple(tb_.src_tokens.shape) == (1,) + jbatch["src_tokens"].shape
    assert tb_.src_tokens.dtype == torch.long


def test_train_split_augmentation_not_ported(vocabs):
    """The train split's augmentation, which this test once required to be
    refused, is ported: with the same seeds (the builder's own and Python's
    and numpy's global ones) the port's builder gives the JAX builder's
    pixels and targets."""
    import random

    row = ["0", fake_image_b64(40, 30), "tabby cat"]
    out = []
    for mod, vocab in ((jdata, vocabs[0]), (tdata, vocabs[1])):
        random.seed(5)
        np.random.seed(5)
        out.append(mod.ImageClassifyBuilder(vocab, split="train", patch_image_size=32, seed=2)(row))
    np.testing.assert_array_equal(out[1].patch_image, out[0].patch_image)
    np.testing.assert_array_equal(out[1].target_ids, out[0].target_ids)


def test_file_dataset_matches_jax(tmp_path):
    p = tmp_path / "rows.tsv"
    p.write_text("".join(f"id{i}\tcol é{i}\t{i * i}\n" for i in range(11)))
    for kw in (dict(), dict(selected_col_ids=[2, 0]), dict(shard_id=1, num_shards=3)):
        j, t = jdata.FileDataset(str(p), **kw), tdata.FileDataset(str(p), **kw)
        assert (len(t), t.total_row_count) == (len(j), j.total_row_count)
        idx = [0, 3, 3, len(t) - 1, len(t) + 2]
        assert [t[i] for i in idx] == [j[i] for i in idx] == t.get_batch(idx)
        t.close()


def test_cider_and_detok_match_jax():
    gts = {"a": ["a dog runs on the beach", "a puppy running"], "b": ["two cats sleep"],
           "c": ["a red car parked on the street", "the car is red"]}
    res = {"a": "a dog running on a beach", "b": "two cats", "c": "a red red car"}
    assert tcider.CiderD().compute_score(gts, res) == jcider.CiderD().compute_score(gts, res)
    for s in ("the u.s. army 's #,### troops -lrb- ap -rrb-", "it 's a `` test '' , ok .",
              "<unk> rises #.# percent in q# ; dollar-yen"):
        assert tdetok.normalize_summary_hyp(s) == jdetok.normalize_summary_hyp(s)
        assert tdetok.fix_tokenization(s) == jdetok.fix_tokenization(s)


# ---------------------------------------------------------------------------
# trie and lexical constraints
# ---------------------------------------------------------------------------

SEQS = [[10, 20, 2], [10, 30, 2], [40, 2], [10, 20, 50, 2], [60, 61, 62, 63, 2]]


def test_trie_tables_match_jax():
    V = 128
    j, t = JaxTrie(SEQS, V), DenseTrie(SEQS, V, "cpu")
    np.testing.assert_array_equal(t.child_tokens.numpy(), np.asarray(j.child_tokens))
    np.testing.assert_array_equal(t.child_next.numpy(), np.asarray(j.child_next))
    nodes = np.array([0, 1, 2, 3, -1, 5, 7, 9, 0, -1], np.int32)
    toks = np.array([10, 20, 99, 2, 5, 50, 63, 2, 40, 127], np.int32)
    np.testing.assert_array_equal(
        t.allowed_mask(torch.from_numpy(nodes).long(), V).numpy(),
        np.asarray(j.allowed_mask(jnp.asarray(nodes), V)))
    np.testing.assert_array_equal(
        t.transition(torch.from_numpy(nodes).long(), torch.from_numpy(toks).long()).numpy(),
        np.asarray(j.transition(jnp.asarray(nodes), jnp.asarray(toks))))
    for n in range(-1, t.num_nodes):
        np.testing.assert_array_equal(t.allowed_mask_np(n), j.allowed_mask_np(n))
        for tok in (2, 10, 20, 40, 63, 127):
            assert t.transition_np(n, tok) == j.transition_np(n, tok)


def test_trie_on_device_keeps_one_copy():
    """A trie built without a device holds host tables only; ``on(device)``
    makes the device tables once and leaves the trie itself as it was."""
    host = DenseTrie(SEQS, 128, None)
    nodes = torch.tensor([0, 1, -1])
    with pytest.raises(AttributeError):
        host.child_tokens
    on = host.on("cpu")
    assert on is host.on(torch.device("cpu")) and on is not host and host.device is None
    assert on.on("cpu") is on and on.device == torch.device("cpu")
    np.testing.assert_array_equal(on.allowed_mask(nodes, 128).numpy(),
                                  DenseTrie(SEQS, 128, "cpu").allowed_mask(nodes, 128).numpy())
    with pytest.raises(ValueError, match="trie.on"):
        DenseTrie(SEQS, 128, "meta").allowed_mask(nodes, 128)


def test_lexical_matches_jax():
    phrases = [[[5, 6], [7]], [[8, 8, 9]], []]
    jc, js = jlex.pack_constraints(phrases)
    tc, ts = tlex.pack_constraints(phrases)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    total = (tc != 1).sum(1)
    rng = np.random.RandomState(0)
    ptr = rng.randint(0, 4, (3, 12))
    toks = rng.choice([5, 6, 7, 8, 9, 11], (3, 12))
    ref = jlex.constraint_transition(jnp.asarray(jc), jnp.asarray(js), jnp.asarray(total),
                                     jnp.asarray(ptr), jnp.asarray(toks))
    out = tlex.constraint_transition(*(torch.from_numpy(np.asarray(a)).long()
                                       for a in (tc, ts, total, ptr, toks)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    bank = rng.randint(0, 3, (2, 15))
    score = rng.choice([-1.0, -2.5, -3.0, -1e9], (2, 15)).astype(np.float32)  # ties
    for fn in ("stripe_rank", "stripe_key"):
        ref = getattr(jlex, fn)(jnp.asarray(bank), jnp.asarray(score))
        out = getattr(tlex, fn)(torch.from_numpy(bank), torch.from_numpy(score))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# eval utilities
# ---------------------------------------------------------------------------

def test_box_utils_match_jax(vocabs):
    rng = np.random.RandomState(1)
    bins = rng.randint(58457, 59457, (6, 4))
    w, h = rng.uniform(0.5, 2, 6), rng.uniform(0.5, 2, 6)
    args = (bins, 58457, 1000, 512, w, h)
    np.testing.assert_array_equal(teval.debin_boxes(*args), jeval.debin_boxes(*args))
    a = np.sort(rng.uniform(0, 100, (6, 4)), axis=1)[:, [0, 1, 2, 3]]
    b = np.sort(rng.uniform(0, 100, (6, 4)), axis=1)
    for fn in ("box_iou", "box_iou_accuracy", "pairwise_iou"):
        np.testing.assert_array_equal(getattr(teval, fn)(a, b), getattr(jeval, fn)(a, b))
    labels_p, labels_g = ["dog", "cat", "dog", "car", "dog", "cat"], ["dog"] * 3 + ["cat"] * 3
    assert teval.match_detections(a, labels_p, b, labels_g, 0.1) == jeval.match_detections(
        a, labels_p, b, labels_g, 0.1)
    jv, tv = vocabs
    prompt = tv.encode_text(" what is it?", append_bos=True)
    t_out = teval.build_candidate_arrays(tv, ANSWERS, prompt, trie=DenseTrie.from_answers(tv, ANSWERS, None))
    j_out = jeval.build_candidate_arrays(jv, ANSWERS, prompt, trie=JaxTrie.from_answers(jv, ANSWERS))
    for x, y in zip(t_out, j_out):
        np.testing.assert_array_equal(x, y)
    assert teval.merge_results([{"a": 1}]) == [{"a": 1}]


# ---------------------------------------------------------------------------
# the search's host-free pieces
# ---------------------------------------------------------------------------

def _jax_sampling_filter(lprobs, topk, topp):
    """The filter of the JAX search's ``_sampling_grow`` (a closure there)."""
    filt = lprobs
    if topk > 0:
        kth = jax.lax.top_k(filt, topk)[0][:, -1:]
        filt = jnp.where(filt < kth, -1e9, filt)
    if topp > 0:
        srt = jnp.sort(filt, axis=-1)[:, ::-1]
        cum = jnp.cumsum(jnp.exp(srt), axis=-1)
        cutoff_idx = jnp.argmax(cum >= topp, axis=-1)
        cutoff = jnp.take_along_axis(srt, cutoff_idx[:, None], axis=-1)
        filt = jnp.where(filt < cutoff, -1e9, filt)
    return filt


@pytest.mark.parametrize("topk,topp", [(5, -1.0), (-1, 0.7), (12, 0.5), (1, -1.0), (-1, 0.999)])
def test_sampling_filter_matches_jax(topk, topp):
    rng = np.random.RandomState(topk + 10)
    logits = rng.randn(6, 300).astype(np.float32) * 2
    logits[0, 10:20] = logits[0, 5]  # ties at the cut
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    ref = np.asarray(_jax_sampling_filter(jnp.asarray(lp), topk, topp))
    out = tbs.sampling_filter(torch.from_numpy(lp), topk, topp).numpy()
    np.testing.assert_array_equal(out, ref)


def test_categorical_draw_statistics():
    """The Gumbel-max draw follows softmax(logits), as ``jax.random.categorical``
    does: frequencies over 40000 draws within 4.5 standard errors of the
    probabilities, for the port and for JAX, and filtered tokens never drawn."""
    logits = np.log(np.array([0.5, 0.25, 0.15, 0.1, 0.0], np.float32) + 1e-30)
    logits[-1] = -1e9
    p = np.exp(logits) / np.exp(logits).sum()
    n = 40000
    g = torch.Generator().manual_seed(0)
    draws = tbs.sample_categorical(torch.from_numpy(np.tile(logits, (n, 1))), g).numpy()
    jdraws = np.asarray(jax.random.categorical(jax.random.PRNGKey(0), jnp.asarray(logits), shape=(n,)))
    for d in (draws, jdraws):
        freq = np.bincount(d, minlength=5) / n
        assert freq[-1] == 0.0
        assert np.all(np.abs(freq - p) <= 4.5 * np.sqrt(p * (1 - p) / n) + 1e-12), freq


def test_no_repeat_ngram_matches_jax():
    """The n-gram ban adds −1e9 per match: a token banned twice gets −2e9."""
    toks = np.array([[0, 5, 6, 5, 6, 5, 1, 1], [0, 7, 7, 7, 7, 8, 1, 1]], np.int64)
    rng = np.random.RandomState(3)
    lp = rng.randn(2, 16).astype(np.float32)
    for step, n in ((4, 2), (4, 3), (5, 2)):
        ref = np.asarray(jax_no_repeat(jnp.asarray(lp), jnp.asarray(toks, jnp.int32), step, n))
        out = tbs._apply_no_repeat_ngram(torch.from_numpy(lp), torch.from_numpy(toks), step, n)
        np.testing.assert_array_equal(out.numpy(), ref)
    assert ref.min() < -1.5e9  # a double ban occurred
