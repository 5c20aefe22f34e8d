"""The seq axis of the port (``parallel/ring_attention.py`` and the
sequence-parallel encoder and decoder) against the JAX package's, the
counterparts of ``tests/test_ring_attention.py`` and
``tests/test_sp_encoder.py``.

The port's ring runs on 4 gloo ranks spawned once for the file (one intra-op
thread each, a ring of 4); the JAX model on a ``seq`` mesh of 4 CPU
devices, as the JAX tests run it. Ring attention: each rank's chunk of q,
k, v, pos_q, pos_k and its query rows of rel, ``kpad`` whole, against the
whole attention in fp32, as the JAX tests hold the JAX ring (their three
``causal × has_pos × has_rel`` cases and the causal gradients). The model: ``tests.test_model.tiny_cfg(seq_parallel=True)``
(2 + 2 layers) with random rel tables, float32: encode (S = 12, and S = 13
padded to 16), the whole forward with a ragged target (T = 6 padded to 8),
the forward's and the encoder's gradients (with remat too), each rank's
share summed over the ring. Every output to 1e-5 of max|ref|, every gradient
to 1e-5 of the largest |g|.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from musketeer_tpu_torch import config as tc
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.parallel import set_mesh
from musketeer_tpu_torch.parallel.dryrun import run_fn
from musketeer_tpu_torch.parallel.mesh import SEQ, Mesh, make_mesh
from musketeer_tpu_torch.parallel.ring_attention import NEG_INF, ring_attention, seq_chunk
from musketeer_tpu_torch.params import from_jax, trainable
from musketeer_tpu_torch.training.train_state import named_leaves

RING_CASES = [(False, True, True), (True, True, True), (False, False, False)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's work in the test process, as the
    entry-point files run theirs: beside the suite's other workers one
    thread runs these small ops faster than many."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _ring_inputs(B, S, has_pos, has_rel, grad):
    H, D = 2, 8
    q, k, v = _rand((B, H, S, D), 0), _rand((B, H, S, D), 1), _rand((B, H, S, D), 2, 1.0)
    pq = _rand((B, H, S, D), 3) if has_pos else None
    pk = _rand((B, H, S, D), 4) if has_pos else None
    rel = _rand((H, S, S), 5) if has_rel else None
    kpad = np.zeros((B, S), bool)
    if not grad:
        kpad[0, -9:] = True
    g = _rand((B, H, S, D), 6) if grad else None
    return q, k, v, pq, pk, rel, kpad, g


def _ranks(_, device, model):
    mesh = make_mesh(tc.MeshConfig(seq=4))
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = {}
    for i, (causal, has_pos, has_rel) in enumerate(RING_CASES + [(True, True, True)]):
        grad = i == len(RING_CASES)
        q, k, v, pq, pk, rel, kpad, g = map(t, _ring_inputs(1 if grad else 2, 32 if grad else 64,
                                                            has_pos, has_rel, grad))
        xs = [x for x in (q, k, v, pq, pk, rel) if x is not None]
        for x in xs:
            x.requires_grad_(grad)
        c = lambda x, dim=2: None if x is None else seq_chunk(x, dim, mesh)
        o = ring_attention(c(q), c(k), c(v), c(pq), c(pk), c(rel, 1), kpad, mesh, causal=causal)
        rec = {"out": o.detach()}
        if grad:
            (o * c(g)).sum().backward()
            rec["grads"] = [x.grad for x in xs]
        out[f"ring{i}" if not grad else "ring_grad"] = rec
    for name, (cfg, params, src, imgs, masks, prev) in model.items():
        with set_mesh(mesh):
            if name == "encode_grads" or name == "encode_grads_remat":
                x = ofa.encode(params, cfg, src, imgs, masks).x
                loss = (x.float() ** 2).sum() * 1e-3
            elif name == "forward_grads":
                logits = ofa.forward(params, cfg, src, prev, imgs, masks)
                lp = torch.log_softmax(logits[..., :cfg.vocab_size].float(), -1)
                loss = (lp ** 2).sum() * 1e-5
            elif name == "forward":
                out[name] = {"out": ofa.forward(params, cfg, src, prev, imgs, masks).detach()}
                continue
            else:
                out[name] = {"out": ofa.encode(params, cfg, src, imgs, masks).x.detach()}
                continue
            (loss / mesh.shape[SEQ]).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                 for _, p in named_leaves(params)]
        for gg in grads:
            torch.distributed.all_reduce(gg, group=mesh.group(SEQ))
        out[name] = {"grads": grads}
    return out


@pytest.fixture(scope="module")
def model_setup():
    from tests.test_model import make_batch, tiny_cfg
    from tests.test_torch_port_model import _randomize
    from tests.test_torch_port_tensor_parallel import _numpy_init

    cfg_j = tiny_cfg(seq_parallel=True)
    tree = _randomize(_numpy_init(cfg_j), np.random.RandomState(7))
    batches = {T: tuple(np.asarray(a) for a in make_batch(cfg_j, B=2, T=T)) for T in (8, 9)}
    prev = np.random.RandomState(7).randint(4, 100, (2, 6)).astype(np.int32)
    prev[0, 4:] = cfg_j.pad  # a ragged target
    return dict(cfg_j=cfg_j, tree=tree, batches=batches, prev=prev)


def _case(s, T=8, **kw):
    cfg_t = tc.ModelConfig(**dataclasses.asdict(dataclasses.replace(s["cfg_j"], **kw)))
    params = trainable(from_jax(s["tree"], cfg_t, "cpu", torch.float32))
    t = lambda a: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
    src, imgs, masks = s["batches"][T]
    return (cfg_t, params, t(src), t(imgs), t(masks), t(s["prev"]))


@pytest.fixture(scope="module")
def port(model_setup):
    s = model_setup
    model = {"encode": _case(s), "encode_odd": _case(s, T=9), "forward": _case(s),
             "forward_grads": _case(s), "encode_grads": _case(s),
             "encode_grads_remat": _case(s, remat=True)}
    return run_fn(4, _ranks, model, mesh=tc.MeshConfig(seq=4), timeout=300)


@pytest.fixture(scope="module")
def jax_ref(model_setup):
    """The JAX SP model on a seq mesh of 4 CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from musketeer_tpu.models import ofa as jofa

    mesh = JaxMesh(np.array(jax.devices()[:4]), ("seq",))
    out = {}
    s = model_setup
    cfg, p = s["cfg_j"], jax.tree.map(jnp.asarray, s["tree"])
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg))
    bridge = lambda tree: [t for _, t in named_leaves(from_jax(
        jax.tree.map(np.asarray, tree), cfg_t, "cpu", torch.float32))]
    src, imgs, masks = (jnp.asarray(a) for a in s["batches"][8])
    prev = jnp.asarray(s["prev"])
    with jax.set_mesh(mesh):
        out["encode"] = np.asarray(jax.jit(lambda p: jofa.encode(p, cfg, src, imgs, masks).x)(p))
        odd = tuple(jnp.asarray(a) for a in s["batches"][9])
        out["encode_odd"] = np.asarray(jax.jit(lambda p: jofa.encode(p, cfg, *odd).x)(p))
        out["forward"] = np.asarray(jax.jit(
            lambda p: jofa.forward(p, cfg, src, prev, imgs, masks))(p))

        def fwd_loss(p):
            logits = jofa.forward(p, cfg, src, prev, imgs, masks)
            return jnp.sum(jax.nn.log_softmax(
                logits[..., :cfg.vocab_size].astype(jnp.float32)) ** 2) * 1e-5

        def enc_loss(p):
            return jnp.sum(jofa.encode(p, cfg, src, imgs, masks).x.astype(jnp.float32) ** 2) * 1e-3

        out["forward_grads"] = bridge(jax.jit(jax.grad(fwd_loss))(p))
        out["encode_grads"] = bridge(jax.jit(jax.grad(enc_loss))(p))
    return out


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * float(np.abs(b).max())


def _attention(q, k, v, pq, pk, rel, kpad, causal):
    """``attention_reference``'s function in fp32 (the JAX ring tests'
    reference): softmax(q·kᵀ + pos_q·pos_kᵀ + rel) with NEG_INF at masked
    keys and, causal, at later positions, times v."""
    w = q @ k.transpose(-1, -2)
    if pq is not None:
        w = w + pq @ pk.transpose(-1, -2)
    if rel is not None:
        w = w + rel[None]
    w = w.masked_fill(kpad[:, None, None, :], NEG_INF)
    if causal:
        S = q.shape[2]
        w = w.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), NEG_INF)
    return torch.softmax(w, -1) @ v


@pytest.mark.parametrize("case", range(len(RING_CASES)),
                         ids=[f"causal{int(c)}_pos{int(p)}_rel{int(r)}" for c, p, r in RING_CASES])
def test_ring_attention_matches_reference(port, case):
    """Ring attention over 4 ranks (each its chunk) against the whole
    attention, as ``test_ring_attention.py`` holds the JAX ring."""
    causal, has_pos, has_rel = RING_CASES[case]
    t = lambda a: None if a is None else torch.from_numpy(a)
    q, k, v, pq, pk, rel, kpad, _ = map(t, _ring_inputs(2, 64, has_pos, has_rel, False))
    got = torch.cat([port[r][f"ring{case}"]["out"] for r in range(4)], dim=2)
    _close(got, _attention(q, k, v, pq, pk, rel, kpad, causal))


def test_ring_attention_grads_match_reference(port):
    """The reverse ring's gradients of q, k, v, pos_q, pos_k and rel (each
    rank's chunk of q/k/v/pos and query rows of rel; the whole ones summed
    over the ring, the rest zero) equal the whole attention's."""
    t = lambda a: torch.from_numpy(a)
    q, k, v, pq, pk, rel, kpad, g = map(t, _ring_inputs(1, 32, True, True, True))
    xs = [x.requires_grad_() for x in (q, k, v, pq, pk, rel)]
    (_attention(*xs, kpad, True) * g).sum().backward()
    got = [sum(port[r]["ring_grad"]["grads"][i] for r in range(4)) for i in range(6)]
    for a, x in zip(got, xs):
        _close(a, x.grad)


@pytest.mark.parametrize("name", ["encode", "encode_odd", "forward"])
def test_sp_model_matches_jax(port, jax_ref, name):
    """The SP encoder (S = 12; S = 13 padded to 16 and sliced back) and the
    whole forward (causal ring self-attention, cross attention of each
    rank's query rows; T = 6 padded to 8) equal the JAX model's on the ring,
    on every rank."""
    ref = jax_ref[name]
    for rank in (0, 3):
        got = port[rank][name]["out"]
        if name == "forward":  # the real vocabulary (the padded rows are -1e9)
            got, ref = got[..., :200], ref[..., :200]
        _close(got, ref)


@pytest.mark.parametrize("name", ["forward_grads", "encode_grads", "encode_grads_remat"])
def test_sp_gradients_match_jax(port, jax_ref, name):
    ref = jax_ref[name.replace("_remat", "")]
    scale = max(float(g.abs().max()) for g in ref)
    for a, b in zip(port[0][name]["grads"], ref):
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_sp_gate_follows_jax(model_setup, monkeypatch, caplog):
    """The SP gate is the JAX model's: under a regulariser in training (and
    with prompts or patch subsampling) the encoder runs replicated, with the
    JAX warning once; deterministic, or with every rate zero, it rides the
    ring; a seq axis of one rank runs the plain layers."""
    class Ring(Exception):
        pass

    def ring(*a, **k):
        raise Ring

    monkeypatch.setattr(ofa, "ring_attention", ring)
    cfg, params, src, imgs, masks, _ = _case(model_setup)
    reg = dataclasses.replace(cfg, dropout=0.1)
    monkeypatch.setattr(ofa, "_warned_once", set())
    with set_mesh(Mesh((1, 1, 1, 1, 4), 0, {})), caplog.at_level(
            logging.WARNING, logger="musketeer_tpu_torch"):
        monkeypatch.setattr(ofa, "seq_chunk", lambda x, dim, mesh: x)
        with pytest.raises(Ring):
            ofa.encode(params, cfg, src, imgs, masks)
        with pytest.raises(Ring):  # training, every rate zero
            ofa.encode(params, cfg, src, imgs, masks, generator=torch.Generator(),
                       deterministic=False)
        with pytest.raises(Ring):  # a regulariser, but deterministic
            ofa.encode(params, reg, src, imgs, masks)
        for _ in range(2):
            replicated = ofa.encode(params, reg, src, imgs, masks,
                                    generator=torch.Generator().manual_seed(1),
                                    deterministic=False).x
    assert [r.getMessage() for r in caplog.records if "seq_parallel" in r.getMessage()] == [
        "seq_parallel is configured but disabled for this forward (dropout/drop-path active, "
        "encoder prompts, or per-sample patch subsampling) — the encoder runs replicated over "
        "the seq axis"]
    plain = ofa.encode(params, reg, src, imgs, masks, generator=torch.Generator().manual_seed(1),
                       deterministic=False).x
    assert torch.equal(replicated, plain)
    with set_mesh(Mesh((1, 1, 1, 1, 1), 0, {})):  # one rank on the seq axis
        assert torch.equal(ofa.encode(params, cfg, src, imgs, masks).x,
                           ofa.encode(params, dataclasses.replace(cfg, seq_parallel=False), src,
                                      imgs, masks).x)
