"""The PyTorch port's serving options of caption beam search against the JAX
package, on ``ofa_tiny`` in float32.

Serving A: ``quantize_output_proj`` + ``int8_cross_kv`` + ``decode_int8_kv_kernel``
(K2-q8 and K6). Serving B: ``decode_stack_kernel`` (K7). Both sides get the
same parameters (the JAX init with random rel-pos tables and BatchNorm
statistics, bridged through ``from_jax``) and the same numpy inputs; the JAX
kernels run in interpret mode, the port's wrappers their plain versions.
Tolerances: the quantizers bit for bit; logits, self caches of chained
decode steps and beam scores to the done rule's 1e-5 relative, as max|a − ref|
over max|ref| (the two sides sum in different orders; −1e9 masks equal); beam
tokens exactly.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musketeer_tpu.ops.decode_stack as jax_decode_stack
from musketeer_tpu.config import GenerationConfig as JaxGenerationConfig
from musketeer_tpu.generation import beam_search as jax_beam_search
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu_torch.config import GenerationConfig
from musketeer_tpu_torch.generation import beam_search
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.params import from_jax
from tests.test_torch_port_model import REL_TOL, _rel_err, encoded, pair  # noqa: F401  (fixtures)

SERVING = {
    "A_int8": dict(model=dict(decode_int8_kv_kernel=True), gen=dict(int8_cross_kv=True), q8=True),
    "B_stack": dict(model=dict(decode_stack_kernel=True), gen={}, q8=False),
}
INT8_KEYS = ("cross_k", "cross_v", "cross_k_scale", "cross_v_scale")


def _cfgs(p, **kw):
    return dataclasses.replace(p["cfg_j"], **kw), dataclasses.replace(p["cfg_t"], **kw)


@pytest.fixture(scope="module")
def quantized(pair):
    """The JAX tree through JAX's quantize_output_proj, bridged by from_jax."""
    params_jq = jofa.quantize_output_proj(pair["params_j"])
    params_tq = from_jax(jax.tree.map(np.array, params_jq), pair["cfg_t"], "cpu", torch.float32)
    return params_jq, params_tq


def test_from_jax_accepts_a_quantized_tree(pair, quantized):
    params_jq, params_tq = quantized
    assert params_tq["embed_tokens_q8"].dtype == torch.int8
    np.testing.assert_array_equal(params_tq["embed_tokens_q8"].numpy(),
                                  np.asarray(params_jq["embed_tokens_q8"]))
    np.testing.assert_array_equal(params_tq["embed_tokens_scale"].numpy(),
                                  np.asarray(params_jq["embed_tokens_scale"]))
    # the port's own quantizer on the bridged fp32 master gives the same leaves
    mine = ofa.quantize_output_proj(pair["params_t"])
    for name in ("embed_tokens_q8", "embed_tokens_scale"):
        assert torch.equal(mine[name], params_tq[name]), name


def test_int8_output_layer_matches_jax(pair, quantized):
    params_jq, params_tq = quantized
    feats = np.random.RandomState(5).randn(2, 3, pair["cfg_t"].embed_dim).astype(np.float32)
    ref = jofa.output_layer(params_jq, pair["cfg_j"], jnp.asarray(feats))
    out = ofa.output_layer(params_tq, pair["cfg_t"], torch.from_numpy(feats))
    assert _rel_err(out.numpy(), ref) <= REL_TOL


def _states(p, enc_j, cfg_j, cfg_t, K, max_len):
    enc_t = ofa.EncoderOut(*(torch.from_numpy(np.array(a)) for a in enc_j))
    st_j = jofa.init_decoder_state(p["params_j"], cfg_j, enc_j, max_len, beam_size=K)
    st_t = ofa.init_decoder_state(p["params_t"], cfg_t, enc_t, max_len, beam_size=K)
    return st_j, st_t


def test_quantize_cross_kv_matches_jax_bit_for_bit(pair, encoded):
    p, (enc_j, _) = pair, encoded
    st_j, st_t = _states(p, enc_j, p["cfg_j"], p["cfg_t"], 2, 4)
    # the same fp32 cache on both sides, so that the quantizers alone are compared
    same = {n: torch.from_numpy(np.array(st_j.cache[n])) for n in ("cross_k", "cross_v")}
    q_j = jofa.quantize_cross_kv(st_j)
    q_t = ofa.quantize_cross_kv(st_t._replace(cache={**st_t.cache, **same}))
    for name in INT8_KEYS:
        ref = np.asarray(q_j.cache[name])
        assert q_t.cache[name].dtype == {np.int8: torch.int8, np.float32: torch.float32}[ref.dtype.type]
        assert tuple(q_t.cache[name].shape) == ref.shape
        np.testing.assert_array_equal(q_t.cache[name].numpy(), ref, name)


@pytest.mark.parametrize("route", ["int8_plain", "int8_k6", "stack"])
def test_decode_steps_match_jax(pair, encoded, route):
    """Four chained steps at beam 3: logits and self caches."""
    p, (enc_j, _) = pair, encoded
    kw = {"int8_plain": {}, "int8_k6": dict(decode_int8_kv_kernel=True),
          "stack": dict(decode_stack_kernel=True)}[route]
    cfg_j, cfg_t = _cfgs(p, **kw)
    K, max_len = 3, 6
    st_j, st_t = _states(p, enc_j, cfg_j, cfg_t, K, max_len)
    if route == "stack":
        assert st_t.kernel_pack is not None
        assert st_t.cache["cross_k"].dtype == torch.float32  # the compute dtype here
    else:
        st_j = jofa.quantize_cross_kv(st_j)
        # JAX's int8 cache on both sides (the fp32 caches differ in their last
        # bits, which may move a value across a rounding boundary)
        st_t = st_t._replace(cache={**st_t.cache, **{
            n: torch.from_numpy(np.array(st_j.cache[n])) for n in INT8_KEYS}})
    toks = np.random.RandomState(3).randint(4, cfg_j.vocab_size, (4, 2 * K))
    calls = mock.patch.object(ofa, "decode_stack_step", wraps=ofa.decode_stack_step)
    with calls as stack_calls:
        for step in range(4):
            lj, st_j = jofa.decode_step(p["params_j"], cfg_j, jnp.asarray(toks[step]),
                                        jnp.int32(step), st_j)
            lt, st_t = ofa.decode_step(p["params_t"], cfg_t, torch.from_numpy(toks[step]),
                                       step, st_t)
            assert _rel_err(lt.numpy(), lj) <= REL_TOL, f"step {step} logits"
            for name in ("self_k", "self_v"):
                assert _rel_err(st_t.cache[name].numpy(), st_j.cache[name]) <= REL_TOL, \
                    f"step {step} {name}"
    assert stack_calls.call_count == (4 if route == "stack" else 0)


@pytest.mark.parametrize("serving", list(SERVING))
def test_serving_beam_tokens_match_jax(pair, encoded, quantized, serving):
    """Each side encodes, then searches with the serving option; tokens must be equal."""
    p, (enc_j, enc_t) = pair, encoded
    spec = SERVING[serving]
    cfg_j, cfg_t = _cfgs(p, **spec["model"])
    params_j, params_t = quantized if spec["q8"] else (p["params_j"], p["params_t"])
    kw = dict(beam_size=5, max_len_b=16, min_len=1, no_repeat_ngram_size=3, **spec["gen"])
    toks_j, sc_j = jax_beam_search(params_j, cfg_j, JaxGenerationConfig(**kw), enc_j, max_len=16)
    toks_t, sc_t = beam_search(params_t, cfg_t, GenerationConfig(**kw), enc_t, max_len=16)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    assert _rel_err(sc_t.numpy(), sc_j) <= REL_TOL


def _stack_calls_jax(p, cfg_j, enc_j, K, int8):
    st = jofa.init_decoder_state(p["params_j"], cfg_j, enc_j, 4, beam_size=K)
    if int8:
        st = jofa.quantize_cross_kv(st)
    rows = enc_j.x.shape[0] * K
    with mock.patch.object(jax_decode_stack, "decode_stack_step",
                           wraps=jax_decode_stack.decode_stack_step) as calls:
        jofa.decode_step(p["params_j"], cfg_j, jnp.full((rows,), cfg_j.bos, jnp.int32),
                         jnp.int32(0), st)
    return calls.call_count


@pytest.mark.parametrize("case", ["even_samples", "int8_cache", "odd_samples"])
def test_stack_routing_matches_jax(pair, encoded, case):
    """K7 runs where JAX's stack branch runs: a pack, no int8 cache, an even sample count."""
    p, (enc_j, _) = pair, encoded
    if case == "odd_samples":
        enc_j = jofa.EncoderOut(*(a[:1] for a in enc_j))
    cfg_j, cfg_t = _cfgs(p, decode_stack_kernel=True)
    int8 = case == "int8_cache"
    K = 2
    enc_t = ofa.EncoderOut(*(torch.from_numpy(np.array(a)) for a in enc_j))
    st_t = ofa.init_decoder_state(p["params_t"], cfg_t, enc_t, 4, beam_size=K)
    if int8:
        st_t = ofa.quantize_cross_kv(st_t)
    rows = enc_t.x.shape[0] * K
    with mock.patch.object(ofa, "decode_stack_step", wraps=ofa.decode_stack_step) as calls:
        logits, _ = ofa.decode_step(p["params_t"], cfg_t, torch.full((rows,), cfg_t.bos), 0, st_t)
    assert bool(torch.isfinite(logits).all())
    expected = int(case == "even_samples")
    assert calls.call_count == expected
    assert _stack_calls_jax(p, cfg_j, enc_j, K, int8) == expected


@pytest.mark.parametrize("flag", [True, False])
def test_k6_route_taken_only_with_its_flag(pair, encoded, flag):
    p, (_, enc_t) = pair, encoded
    _, cfg_t = _cfgs(p, decode_int8_kv_kernel=flag)
    st = ofa.quantize_cross_kv(ofa.init_decoder_state(p["params_t"], cfg_t, enc_t, 4, beam_size=2))
    rows = enc_t.x.shape[0] * 2
    with mock.patch.object(ofa, "decode_cross_attention_int8",
                           wraps=ofa.decode_cross_attention_int8) as calls:
        ofa.decode_step(p["params_t"], cfg_t, torch.full((rows,), cfg_t.bos), 0, st)
    assert calls.call_count == (cfg_t.decoder_layers if flag else 0)
    # without an int8 cache the flag changes nothing
    st = ofa.init_decoder_state(p["params_t"], cfg_t, enc_t, 4, beam_size=2)
    with mock.patch.object(ofa, "decode_cross_attention_int8") as calls:
        ofa.decode_step(p["params_t"], cfg_t, torch.full((rows,), cfg_t.bos), 0, st)
    assert calls.call_count == 0
