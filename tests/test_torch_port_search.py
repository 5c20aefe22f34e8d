"""The port's general beam-search body against the JAX search, on ``ofa_tiny``
(2 + 2 layers, ResNet (1, 1, 1)) in float32, one seeded parameter tree in
the JAX layout given to both sides (through ``from_jax`` to the port; random
rel-pos tables and BN statistics, as in ``test_torch_port_model.py``).

Each case runs JAX ``beam_search`` and the port's on the same encoder output
(each side's own encoder: the JAX flash branch in interpret mode, the port's
plain K1): tokens exactly equal, scores within 1e-5 of max|ref|. Sampling's
draws cannot match JAX's PRNG; with top-k 1 the draw is the filter's one
token, so that case holds the chains' bookkeeping to JAX's exactly (the
filter and the draw's statistics: ``test_torch_port_host.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu.config import GenerationConfig as JaxGenerationConfig
from musketeer_tpu.config import ofa_tiny
from musketeer_tpu.generation import beam_search as jax_beam_search
from musketeer_tpu.generation import pack_constraints
from musketeer_tpu.generation.trie import DenseTrie as JaxTrie
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu_torch.config import GenerationConfig, ModelConfig
from musketeer_tpu_torch.generation import DenseTrie, beam_search, generate
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.params import from_jax, init_ofa_params, map_leaves
from tests.test_torch_port_model import _randomize

REL_TOL = 1e-5
MASKED = -1e8  # at or below: a score built on a −1e9 ban
B, S, IMG = 2, 8, 32
BINS = (58457, 59457)
# answer-like token sequences, each ending with eos
SEQS = [[100, 200, 2], [100, 300, 2], [400, 2], [100, 200, 500, 2], [600, 601, 602, 2]]


def numpy_tree(cfg_t, seed: int):
    """A seeded parameter tree in the JAX layout, as numpy (the port's
    ``init_ofa_params``, which a test holds to the JAX init's layout), with
    random rel-pos tables and BN statistics."""
    tree = init_ofa_params(cfg_t, torch.Generator().manual_seed(seed), "cpu")
    tree = map_leaves(lambda t: None if t is None else t.numpy(), tree)
    return _randomize(tree, np.random.RandomState(7 + seed))


@pytest.fixture(scope="module")
def models():
    cfg_j = dataclasses.replace(ofa_tiny(), dtype="float32", use_flash_attention=True,
                                encoder_layers=2, decoder_layers=2, resnet_layers=(1, 1, 1))
    cfg_t = ModelConfig(**dataclasses.asdict(cfg_j))
    rng = np.random.RandomState(0)
    src = rng.randint(4, 5000, (B, S)).astype(np.int32)
    src[:, -1] = cfg_j.eos
    src[0, -3:] = [cfg_j.eos, cfg_j.pad, cfg_j.pad]  # ragged lengths
    imgs = rng.randn(B, IMG, IMG, 3).astype(np.float32)
    masks = np.ones((B,), bool)
    encode = jax.jit(lambda p, s, i, m: jofa.encode(p, cfg_j, s, i, m))
    out = dict(cfg_j=cfg_j, cfg_t=cfg_t, src=src, params_j=[], params_t=[], enc_j=[], enc_t=[])
    for seed in (0, 1):
        tree = numpy_tree(cfg_t, seed)
        pj = jax.tree.map(jnp.asarray, tree)
        pt = from_jax(tree, cfg_t, "cpu", torch.float32)
        out["params_j"].append(pj)
        out["params_t"].append(pt)
        out["enc_j"].append(encode(pj, jnp.asarray(src), jnp.asarray(imgs), jnp.asarray(masks)))
        out["enc_t"].append(ofa.encode(pt, cfg_t, torch.from_numpy(src).long(),
                                       torch.from_numpy(imgs), torch.from_numpy(masks)))
    return out


def _allowed(xnp, step, n_rows, V, even):
    """Even steps: ids 100..399 and eos; odd steps: ids 300..699 and eos."""
    lo = xnp.where(even, 100, 300)
    ids = xnp.arange(V)
    row = ((ids >= lo) & (ids < lo + 300)) | (ids == 2)
    return xnp.broadcast_to(row[None, :], (n_rows, V))


def _allowed_jax(step, toks):
    return _allowed(jnp, step, toks.shape[0], 59457, step % 2 == 0)


def _allowed_torch(step, toks):
    return _allowed(torch, step, toks.shape[0], 59457, torch.tensor(step % 2 == 0))


def _prefix():
    p = np.full((B, 3), 1, np.int32)
    p[0] = [100, 200, 500]
    p[1, :1] = [600]  # a shorter row prefix: its trie activates earlier
    return p


# name: (generation config, search options)
CASES = {
    "trie": (dict(beam_size=3, max_len_b=6), dict(trie=True)),
    "trie_prefix": (dict(beam_size=3, max_len_b=7), dict(trie=True, prefix=True)),
    # the trie offers eos before min_len allows it: the additive eos ban decides
    "trie_min_len": (dict(beam_size=3, max_len_b=6, min_len=3, temperature=0.2), dict(trie=True)),
    "constraint_range": (dict(beam_size=3, max_len_b=4, constraint_range=BINS), {}),
    "constraint_range_zero_shot": (
        dict(beam_size=3, max_len_b=5, constraint_range=(4, 700), zero_shot=True), dict(trie=True)),
    "gen_box": (dict(beam_size=5, max_len_b=4, min_len=4, no_repeat_ngram_size=3, gen_box=True,
                     constraint_range=BINS), {}),
    "unk_penalty": (dict(beam_size=3, max_len_b=5, unk_penalty=3.0, temperature=0.7), {}),
    "len_a_general": (dict(beam_size=3, max_len_a=0.5, max_len_b=2, min_len_a=0.5, min_len=1,
                           no_repeat_ngram_size=2, use_fast_path=False), dict(src_lengths=True)),
    "len_a_fast": (dict(beam_size=3, max_len_a=0.5, max_len_b=2, min_len_a=0.5, min_len=1,
                        no_repeat_ngram_size=2), dict(src_lengths=True)),
    "diverse_groups": (dict(beam_size=4, max_len_b=5, diverse_beam_groups=2,
                            diversity_strength=0.7), {}),
    "diversity_rate": (dict(beam_size=3, max_len_b=5, diversity_rate=0.4), {}),
    "lexical_met": (dict(beam_size=3, max_len_b=6), dict(constraints=[[[700, 701]], [[800], [801]]])),
    "lexical_unmeetable": (dict(beam_size=3, max_len_b=3),
                           dict(constraints=[[[700, 701, 702, 703, 704]], [[800]]])),
    "allowed_fn": (dict(beam_size=3, max_len_b=5), dict(allowed_fn=True)),
    "ensemble": (dict(beam_size=3, max_len_b=5, no_repeat_ngram_size=3, temperature=1.3),
                 dict(ensemble=True)),
    "sampling_top1": (dict(beam_size=3, max_len_b=5, sampling=True, sampling_topk=1), {}),
    "sampling_top1_trie": (dict(beam_size=3, max_len_b=6, sampling=True, sampling_topk=1),
                           dict(trie=True, prefix=True)),
}


def _run(models, gen, opts):
    m = models
    gj, gt = JaxGenerationConfig(**gen), GenerationConfig(**gen)
    max_len = int(gen.get("max_len_a", 0.0) * S + gen["max_len_b"])
    kj, kt = {}, {}
    if opts.get("trie"):
        kj["trie"], kt["trie"] = JaxTrie(SEQS, 59520), DenseTrie(SEQS, 59520, "cpu")
    if opts.get("prefix"):
        kj["prefix_tokens"], kt["prefix_tokens"] = jnp.asarray(_prefix()), torch.from_numpy(_prefix())
    if opts.get("src_lengths"):
        sl = (m["src"] != 1).sum(1)
        kj["src_lengths"], kt["src_lengths"] = jnp.asarray(sl), torch.from_numpy(sl)
    if "constraints" in opts:
        packed = pack_constraints(opts["constraints"])
        kj["constraints"] = kt["constraints"] = packed
    if opts.get("allowed_fn"):
        kj["allowed_fn"], kt["allowed_fn"] = _allowed_jax, _allowed_torch
    if gen.get("sampling"):
        kj["rng"], kt["rng"] = jax.random.PRNGKey(3), torch.Generator().manual_seed(3)
    if opts.get("ensemble"):
        stack = lambda *xs: jnp.stack(xs)
        pj = jax.tree.map(stack, *m["params_j"])
        ej = jofa.EncoderOut(*(stack(*xs) for xs in zip(*m["enc_j"])))
        tj, sj = jax_beam_search(pj, m["cfg_j"], gj, ej, max_len=max_len, n_models=2, **kj)
        tt, st = beam_search(m["params_t"], m["cfg_t"], gt, m["enc_t"], max_len=max_len,
                             n_models=2, **kt)
    else:
        tj, sj = jax_beam_search(m["params_j"][0], m["cfg_j"], gj, m["enc_j"][0],
                                 max_len=max_len, **kj)
        tt, st = beam_search(m["params_t"][0], m["cfg_t"], gt, m["enc_t"][0], max_len=max_len,
                             **kt)
    return np.asarray(tj), np.asarray(sj), tt.numpy(), st.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_general_search_matches_jax(models, name):
    gen, opts = CASES[name]
    tj, sj, tt, st = _run(models, gen, opts)
    np.testing.assert_array_equal(tt, tj)
    # live scores within 1e-5 of their max|ref|; the −1e9-scale scores of
    # banned or fallback hypotheses (whose bans add up) exactly equal
    live = sj > MASKED
    np.testing.assert_array_equal(st[~live], sj[~live])
    assert float(np.abs(st[live] - sj[live]).max()) <= REL_TOL * float(np.abs(sj[live]).max())
    if name == "lexical_unmeetable":  # sample 0: no finished hypothesis, the eos-terminated fallback
        assert (sj[0] < -1e8).all() and (tj[0, :, -1] == 2).all() and (sj[1, 0] > -1e8)
    if name == "gen_box":  # four bins, then eos
        assert ((tj[:, :, :4] >= BINS[0]) & (tj[:, :, :4] < BINS[1])).all()
        assert (tj[:, :, 4] == 2).all()
    if name == "trie":
        assert all(list(r[: list(r).index(2) + 1]) in SEQS for r in tj.reshape(-1, tj.shape[-1]))


def test_generate_routes_each_option(models):
    """``generate`` takes the general body for every option the fast path
    refuses (``use_fast_path`` is the JAX predicate); ``gen_code`` runs there
    on code masks, specials banned until eos."""
    m = models
    src = torch.from_numpy(m["src"]).long()
    gen = GenerationConfig(beam_size=2, max_len_b=2, unk_penalty=1.0)
    toks, scores = generate(m["params_t"], m["cfg_t"], gen, src)  # text-only ensemble
    assert tuple(toks.shape) == (B, 2, 3) and bool(torch.isfinite(scores).all())
    toks, scores = generate(m["params_t"][0], m["cfg_t"],
                            GenerationConfig(beam_size=2, max_len_b=3, min_len=3, gen_code=True),
                            src)
    assert tuple(toks.shape) == (B, 2, 4) and bool((toks[:, :, :3] >= 4).all())
    assert bool((toks[:, :, 3] == m["cfg_t"].eos).all())
    with pytest.raises(ValueError, match="rng"):
        generate(m["params_t"][0], m["cfg_t"], GenerationConfig(sampling=True), src)
