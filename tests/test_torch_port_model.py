"""The PyTorch port's caption path against the JAX package, on ``ofa_tiny``.

Both sides get the same parameters (the JAX init, with random rel-pos tables
and BatchNorm statistics so that those paths carry data, bridged through
``from_jax``) and the same numpy inputs, in float32. The JAX encoder runs its
flash branch (Pallas kernels in interpret mode); the port's runs K1's plain
version. Tolerance: the done rule's 1e-5 relative, as max|a − ref| over
max|ref| (XLA and ATen sum in different orders), for ResNet features,
encoder features, caches, logits and beam scores; logits masked to −1e9 must
be equal. Beam tokens exactly.
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
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.models.resnet import resnet_forward as jax_resnet_forward
from musketeer_tpu_torch.config import GenerationConfig, ModelConfig
from musketeer_tpu_torch.generation import beam_search
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.models.resnet import resnet_forward
from musketeer_tpu_torch.params import from_jax
from tests.test_model import make_batch

REL_TOL = 1e-5
MASKED = -1e8  # at or below: a −1e9 mask (padded vocab, banned tokens)


def _randomize(tree, rng):
    """Random rel-pos tables and BN statistics (the JAX init leaves them trivial)."""
    for part in ("encoder", "decoder"):
        for name in ("token_rel_pos_table", "image_rel_pos_table"):
            tree[part][name] = (rng.randn(*tree[part][name].shape) * 0.5).astype(np.float32)

    def bn(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                shape = node["mean"].shape
                node["scale"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
                node["bias"] = (rng.randn(*shape) * 0.1).astype(np.float32)
                node["mean"] = (rng.randn(*shape) * 0.1).astype(np.float32)
                node["var"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            else:
                for v in node.values():
                    bn(v)

    bn(tree["encoder"]["resnet"])
    return tree


@pytest.fixture(scope="module")
def pair():
    cfg_j = dataclasses.replace(ofa_tiny(), dtype="float32", use_flash_attention=True)
    params = jofa.init_ofa_params(jax.random.PRNGKey(0), cfg_j)
    params_np = _randomize(jax.tree.map(np.array, params), np.random.RandomState(7))
    params_j = jax.tree.map(jnp.asarray, params_np)
    cfg_t = ModelConfig(**dataclasses.asdict(cfg_j))
    params_t = from_jax(params_np, cfg_t, "cpu", torch.float32)
    src, imgs, masks = (np.array(a) for a in make_batch(cfg_j, B=2, T=8, img=64))
    return dict(cfg_j=cfg_j, params_j=params_j, cfg_t=cfg_t, params_t=params_t,
                src=src, imgs=imgs, masks=masks)


@pytest.fixture(scope="module")
def encoded(pair):
    p = pair
    enc_j = jofa.encode(p["params_j"], p["cfg_j"], jnp.asarray(p["src"]),
                        jnp.asarray(p["imgs"]), jnp.asarray(p["masks"]))
    enc_t = ofa.encode(p["params_t"], p["cfg_t"], torch.from_numpy(p["src"]),
                       torch.from_numpy(p["imgs"]), torch.from_numpy(p["masks"]))
    return enc_j, enc_t


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _rel_err(a, ref):
    """max|a − ref| / max|ref| over the entries where ref is above −1e8; the
    masked entries must be equal."""
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    live = ref > MASKED
    np.testing.assert_array_equal(a[~live], ref[~live])
    return float(np.abs(a[live] - ref[live]).max() / np.abs(ref[live]).max())


def test_resnet_forward_matches_jax(pair):
    ref = np.asarray(jax_resnet_forward(pair["params_j"]["encoder"]["resnet"],
                                        jnp.asarray(pair["imgs"])))
    out = resnet_forward(pair["params_t"]["encoder"]["resnet"], torch.from_numpy(pair["imgs"]))
    assert tuple(out.shape) == ref.shape == (2, 4, 4, 1024)
    assert _rel_err(out.numpy(), ref) <= REL_TOL


def test_encode_matches_jax(encoded):
    enc_j, enc_t = encoded
    np.testing.assert_array_equal(enc_t.padding_mask.numpy(), np.asarray(enc_j.padding_mask))
    assert _rel_err(enc_t.x.numpy(), enc_j.x) <= REL_TOL
    assert _rel_err(enc_t.pos_embed.numpy(), enc_j.pos_embed) <= REL_TOL


def test_text_only_encode_matches_jax(pair):
    p = pair
    enc_j = jofa.encode(p["params_j"], p["cfg_j"], jnp.asarray(p["src"]))
    enc_t = ofa.encode(p["params_t"], p["cfg_t"], torch.from_numpy(p["src"]))
    assert _rel_err(enc_t.x.numpy(), enc_j.x) <= REL_TOL


def test_decode_steps_match_jax(pair, encoded):
    """Three incremental steps at beam 3 from one encoder output: logits and caches."""
    p, (enc_j, _) = pair, encoded
    K, max_len = 3, 6
    enc_t = ofa.EncoderOut(*(torch.from_numpy(np.array(a)) for a in enc_j))
    st_j = jofa.init_decoder_state(p["params_j"], p["cfg_j"], enc_j, max_len, beam_size=K)
    st_t = ofa.init_decoder_state(p["params_t"], p["cfg_t"], enc_t, max_len, beam_size=K)
    assert _rel_err(st_t.cross_bias_full.numpy(), st_j.cross_bias_full) <= REL_TOL
    for name in ("cross_k", "cross_v"):
        assert _rel_err(st_t.cache[name].numpy(), st_j.cache[name]) <= REL_TOL, name
    toks = np.random.RandomState(3).randint(4, p["cfg_j"].vocab_size, (3, 2 * K))
    for step in range(3):
        lj, st_j = jofa.decode_step(p["params_j"], p["cfg_j"], jnp.asarray(toks[step]),
                                    jnp.int32(step), st_j)
        lt, st_t = ofa.decode_step(p["params_t"], p["cfg_t"], torch.from_numpy(toks[step]),
                                   step, st_t)
        assert _rel_err(lt.numpy(), lj) <= REL_TOL, f"step {step} logits"
        for name in ("self_k", "self_v"):
            assert _rel_err(st_t.cache[name].numpy(), st_j.cache[name]) <= REL_TOL, \
                f"step {step} {name}"


@pytest.mark.parametrize("beam,ngram,min_len,max_len", [(5, 3, 1, 16), (2, 2, 4, 6)])
def test_beam_search_tokens_match_jax(pair, encoded, beam, ngram, min_len, max_len):
    """The whole slice: each side encodes, then searches; tokens must be equal."""
    p, (enc_j, enc_t) = pair, encoded
    kw = dict(beam_size=beam, max_len_b=max_len, min_len=min_len, no_repeat_ngram_size=ngram)
    toks_j, sc_j = jax_beam_search(p["params_j"], p["cfg_j"], JaxGenerationConfig(**kw),
                                   enc_j, max_len=max_len)
    toks_t, sc_t = beam_search(p["params_t"], p["cfg_t"], GenerationConfig(**kw),
                               enc_t, max_len=max_len)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    assert _rel_err(sc_t.numpy(), sc_j) <= REL_TOL
