"""The pipe axis of the port (``parallel/pipeline.py`` and the pipelined
encoder and decoder) against the JAX package's, the counterparts of
``tests/test_pipeline.py``.

The port's pipelines run on 4 gloo ranks spawned once for the file (one
intra-op thread each): P stages and 4/P data ranks, each data rank's
pipeline on the whole batch. ``pipeline_scan`` is held, as the JAX tests
hold theirs, to the plain loop over the layers; the model to the JAX model
on a ``data=2 × pipe=2`` mesh of CPU devices with ``shard_params``, the
port's layout: outputs to 1e-5 of max|ref|, gradients (each rank's share
summed over the pipe ranks, the loss counted once) to 1e-5 of the largest
|g|. ``tests.test_model.tiny_cfg`` (2 + 2
layers, d 64, 4 heads) with the flash branch, random rel tables, float32.

The gate (the JAX model's: flash on, no SP, no code masks on the decoder,
and no generator or no in-layer regulariser) and the interleave downgrade's
warning are checked in this process.

The pipe axis's state layout: on ``ofa_tiny`` (meta tensors, no ranks) each
rank's ``DataParallel`` blocks of the parameters, AdamW moments and EMA
equal, leaf by leaf and in total, the bytes that the JAX ``param_shardings``
puts on the device at that rank's coordinate of a mesh of the 8 CPU
devices; and on the ranks, validation's tree (a data 2 × pipe 2 rank's
blocks gathered with ``full``) equals the tree, and its forward and beam
search under the mesh equal one rank's.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from musketeer_tpu_torch import config as tc
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.parallel import DataParallel, set_mesh
from musketeer_tpu_torch.parallel.data_parallel import reckoned_state_bytes
from musketeer_tpu_torch.parallel.dryrun import run_fn
from musketeer_tpu_torch.parallel.mesh import PIPE, Mesh, _owned, make_mesh
from musketeer_tpu_torch.parallel.pipeline import pipeline_scan
from musketeer_tpu_torch.params import from_jax, trainable
from musketeer_tpu_torch.training.train_state import named_leaves

# (P, L, M, microbatch rows, D, V, remat, seed) of the scan cases, as test_pipeline.py's
SCANS = {
    "matches_scan": (4, 8, 4, 2, 16, 1, False, 0),
    "single_stage": (1, 3, 2, 2, 8, 1, False, 1),
    "interleaved_matches_scan": (4, 8, 4, 2, 16, 2, False, 2),
    "interleaved_grads": (2, 8, 2, 2, 8, 4, False, 3),
    "interleaved_grads_remat": (2, 8, 2, 2, 8, 4, True, 3),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's work in the test process, as the
    entry-point files run theirs: beside the suite's other workers one
    thread runs these small ops faster than many."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scan_inputs(L, M, mb, D, seed, bias: bool):
    rs = np.random.RandomState(seed)
    xs = {"w": (rs.randn(L, D, D) * 0.1).astype(np.float32)}
    if bias:
        xs["b"] = (rs.randn(L, D) * 0.1).astype(np.float32)
    x = rs.randn(M, mb, D).astype(np.float32)
    c = (rs.randn(D) * 0.1).astype(np.float32) if bias else None
    return xs, x, c


def _scan_body(pl, layer, consts, _side):
    """``test_pipeline.py``'s bodies: tanh(x·w + b + c), or tanh(x·w) without b."""
    y = pl["x"] @ layer["w"]
    if "b" in layer:
        y = y + layer["b"] + consts
    return {"x": torch.tanh(y)}


def _single_body(pl, layer, _consts, _side):
    return {"x": pl["x"] + pl["x"] @ layer["w"]}


def _model_cfgs():
    from tests.test_model import tiny_cfg

    cfg_j = tiny_cfg(use_flash_attention=True)
    return {"gpipe": cfg_j, "interleaved": dataclasses.replace(cfg_j, encoder_layers=4)}


def _ranks(_, device, scans, model):
    """Every port-side case on this rank → its results (rank-local values)."""
    out = {}
    for name, (P, L, M, mb, D, V, remat, seed) in scans.items():
        mesh = make_mesh(tc.MeshConfig(pipe=P))
        xs, x, c = _scan_inputs(L, M, mb, D, seed, bias=name in ("matches_scan",
                                                                 "interleaved_matches_scan"))
        w = {k: torch.from_numpy(v).requires_grad_() for k, v in xs.items()}
        # this stage's layers, chunk by chunk
        own = [i for chunk in _owned(L, P, V, mesh.coords[PIPE]) for i in chunk]
        layers = [{k: v[i] for k, v in w.items()} for i in own]
        body = _single_body if name == "single_stage" else _scan_body
        y = pipeline_scan(body, {"x": torch.from_numpy(x)}, layers, mesh,
                          consts=None if c is None else torch.from_numpy(c), remat=remat,
                          interleave=V)["x"]
        rec = {"out": y.detach()}
        if name.startswith("interleaved_grads"):
            ((y ** 2).sum() / P).backward()
            g = w["w"].grad
            torch.distributed.all_reduce(g, group=mesh.group(PIPE))
            rec["grad"] = g
        out[name] = rec
    mesh = make_mesh(tc.MeshConfig(pipe=2))
    out["validation"] = _validate(mesh, *model["forward"])
    for name, (cfg, params, src, imgs, masks, prev) in model.items():
        with set_mesh(mesh):
            if name == "forward":
                out[name] = {"out": ofa.forward(params, cfg, src, prev, imgs, masks).detach()}
                continue
            enc = ofa.encode(params, cfg, src, imgs, masks)
            rec = {"out": enc.x.detach()}
            if name.startswith("grads"):
                loss = (enc.x.float() ** 2).sum() * 1e-3
                (loss / 2).backward()
        if name.startswith("grads"):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                     for _, p in named_leaves(params)]
            for g in grads:
                torch.distributed.all_reduce(g, group=mesh.group(PIPE))
            rec["grads"] = grads
        out[name] = rec
    return out


def _validate(mesh, cfg, params, src, imgs, masks, prev):
    """As ``train_loop`` validates under ``DataParallel``: this rank's blocks
    gathered with ``full``, the forward and a beam search on them under the
    mesh with the batch whole on every rank → (the gathered tree's leaves,
    the stage's layer count, the logits, the tokens)."""
    from musketeer_tpu_torch.config import GenerationConfig
    from musketeer_tpu_torch.generation import beam_search

    par = DataParallel(mesh, params, cfg)
    blocks = par.shard(params)
    full = par.gather(blocks, full=True)
    with set_mesh(mesh, model_split=False, batch_local=False), torch.no_grad():
        logits = ofa.forward(full, cfg, src, prev, imgs, masks)
        enc = ofa.encode(full, cfg, src, imgs, masks)
        tokens = beam_search(full, cfg, GenerationConfig(beam_size=2, max_len_b=4), enc,
                             max_len=4)
    return {"tree": [t.detach() for _, t in named_leaves(full)],
            "held": len(blocks["encoder"]["layers"]), "logits": logits, "tokens": tokens}


@pytest.fixture(scope="module")
def model_setup():
    from tests.test_model import make_batch
    from tests.test_torch_port_model import _randomize
    from tests.test_torch_port_tensor_parallel import _numpy_init

    out = {}
    for name, cfg_j in _model_cfgs().items():
        tree = _randomize(_numpy_init(cfg_j), np.random.RandomState(7))
        src, imgs, masks = (np.asarray(a) for a in make_batch(cfg_j, B=4))
        prev = np.random.RandomState(5).randint(4, 100, (4, 6)).astype(np.int32)
        out[name] = dict(cfg_j=cfg_j, tree=tree, src=src, imgs=imgs, masks=masks, prev=prev)
    return out


def _port_model_case(s, **cfg_kw):
    cfg_j = dataclasses.replace(s["cfg_j"], pipeline_microbatches=2, **cfg_kw)
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    params = trainable(from_jax(s["tree"], cfg_t, "cpu", torch.float32))
    t = lambda a: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
    return (cfg_t, params, t(s["src"]), t(s["imgs"]), t(s["masks"]), t(s["prev"]))


@pytest.fixture(scope="module")
def port(model_setup):
    g, il = model_setup["gpipe"], model_setup["interleaved"]
    model = {"encode": _port_model_case(g), "grads": _port_model_case(g),
             "grads_remat": _port_model_case(g, remat=True),
             "interleaved": _port_model_case(il, pipeline_interleave=2),
             "forward": _port_model_case(g)}
    return run_fn(4, _ranks, SCANS, model, mesh=tc.MeshConfig(pipe=2), timeout=300)


@pytest.fixture(scope="module")
def jax_model(model_setup):
    """The JAX model on a data=2 × pipe=2 mesh, the port's layout: encode
    (GPipe, M = 2), its gradients, the interleaved encode (4 layers, V = 2)
    and the forward."""
    import jax
    import jax.numpy as jnp

    from musketeer_tpu import config as jc
    from musketeer_tpu.models import ofa as jofa
    from musketeer_tpu.parallel import make_mesh, shard_params

    mesh = make_mesh(jc.MeshConfig(data=2, fsdp=1, model=1, pipe=2), devices=jax.devices()[:4])
    out = {}
    for name, s in model_setup.items():
        kw = dict(pipeline_microbatches=2)
        if name == "interleaved":
            kw["pipeline_interleave"] = 2
        cfg = dataclasses.replace(s["cfg_j"], **kw)
        src, imgs, masks = (jnp.asarray(s[k]) for k in ("src", "imgs", "masks"))
        with jax.set_mesh(mesh):
            sp = shard_params(mesh, jax.tree.map(jnp.asarray, s["tree"]))
            out[name] = np.asarray(jax.jit(lambda p: jofa.encode(p, cfg, src, imgs, masks).x)(sp))
            if name != "gpipe":
                continue

            def loss(p):
                x = jofa.encode(p, cfg, src, imgs, masks).x
                return jnp.sum(x.astype(jnp.float32) ** 2) * 1e-3

            out["grads"] = jax.device_get(jax.jit(jax.grad(loss))(sp))
            out["forward"] = np.asarray(jax.jit(lambda p: jofa.forward(
                p, cfg, src, jnp.asarray(s["prev"]), imgs, masks))(sp))
    cfg_t = tc.ModelConfig(**dataclasses.asdict(model_setup["gpipe"]["cfg_j"]))
    out["grads"] = [t for _, t in named_leaves(from_jax(
        jax.tree.map(np.asarray, out["grads"]), cfg_t, "cpu", torch.float32))]
    return out


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * float(np.abs(b).max())


def _plain_scan(name):
    """The reference of ``test_pipeline.py``'s scan tests: every microbatch
    through the L layers in turn (the JAX tests' ``lax.scan``) → (output,
    the gradient of Σ out² by the stacked ``w``, or None)."""
    P, L, M, mb, D, V, remat, seed = SCANS[name]
    bias = name in ("matches_scan", "interleaved_matches_scan")
    xs, x, c = _scan_inputs(L, M, mb, D, seed, bias)
    w = {k: torch.from_numpy(v).requires_grad_() for k, v in xs.items()}
    body = _single_body if name == "single_stage" else _scan_body
    outs = []
    for m in range(M):
        pl = {"x": torch.from_numpy(x[m])}
        for i in range(L):
            pl = body(pl, {k: v[i] for k, v in w.items()},
                      None if c is None else torch.from_numpy(c), None)
        outs.append(pl["x"])
    out = torch.stack(outs)
    if not name.startswith("interleaved_grads"):
        return out.detach(), None
    (out ** 2).sum().backward()
    return out.detach(), w["w"].grad


@pytest.mark.parametrize("name", list(SCANS))
def test_pipeline_scan_matches_plain_scan(port, name):
    """``pipeline_scan`` (GPipe over 4 stages with a constant, one stage, the
    interleaved schedule, its gradients with and without remat) equals the
    plain loop over the layers, as ``test_pipeline.py`` holds the JAX one to
    ``lax.scan`` (each stage's gradient share summed over the pipe ranks)."""
    ref, grad = _plain_scan(name)
    for rank in range(4):  # every stage holds the output
        _close(port[rank][name]["out"], ref)
    if grad is not None:
        _close(port[0][name]["grad"], grad)


@pytest.mark.parametrize("name", ["encode", "interleaved", "forward"])
def test_model_pipeline_matches_jax(port, jax_model, name):
    """encode with pipeline_microbatches 2 over pipe 2 (GPipe; the
    interleaved schedule on 4 layers) and the whole forward equal the JAX
    model's on the data=2 × pipe=2 mesh."""
    ref = jax_model["gpipe" if name == "encode" else name]
    for rank in (0, 3):
        got = port[rank][name]["out"]
        if name == "forward":  # the real vocabulary (the padded rows are -1e9)
            ref, got = ref[..., :200], got[..., :200]
        _close(got, ref)


@pytest.mark.parametrize("name", ["grads", "grads_remat"])
def test_encoder_pipeline_grads_match_jax(port, jax_model, name):
    """Every gradient leaf of the pipelined encoder (each stage's share summed
    over the pipe ranks; remat: each stage recomputed in the backward) equals
    the JAX model's on the pipe mesh."""
    got, ref = port[0][name]["grads"], jax_model["grads"]
    scale = max(float(g.abs().max()) for g in ref)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-5 * scale


def _fake_pipe_mesh(P=2):
    return Mesh((1, 1, 1, P, 1), 0, {})


class _Pipelined(Exception):
    pass


def test_pipeline_gate_follows_jax(model_setup, monkeypatch):
    """The pipeline runs where the JAX gate lets it (no generator, or no
    in-layer regulariser; flash on; no SP; no code masks on the decoder; a
    pipe axis of more than one stage) and the plain loop everywhere else,
    with the plain loop's result."""
    def pipelined(*a, **k):
        raise _Pipelined

    monkeypatch.setattr(ofa, "pipeline_scan", pipelined)
    cfg, params, src, imgs, masks, prev = _port_model_case(model_setup["gpipe"])
    reg = dataclasses.replace(cfg, dropout=0.1)
    with set_mesh(_fake_pipe_mesh()):
        with pytest.raises(_Pipelined):  # no generator
            ofa.encode(params, cfg, src, imgs, masks)
        with pytest.raises(_Pipelined):  # a generator but no regulariser
            ofa.encode(params, cfg, src, imgs, masks, generator=torch.Generator(),
                       deterministic=False)
        with pytest.raises(_Pipelined):  # the decoder, no code masks
            ofa.decode(params, cfg, prev, ofa.encode(params, reg, src, imgs, masks))
        # a generator and a regulariser, the XLA branch, no microbatches: plain
        inside = ofa.encode(params, reg, src, imgs, masks,
                            generator=torch.Generator().manual_seed(1), deterministic=False).x
        for c in (dataclasses.replace(cfg, use_flash_attention=False),
                  dataclasses.replace(cfg, pipeline_microbatches=0)):
            ofa.encode(params, c, src, imgs, masks)
        out = ofa.encode(params, dataclasses.replace(cfg, pipeline_microbatches=0), src, imgs,
                         masks)
        codes = torch.ones(src.shape[0], dtype=torch.bool)
        ofa.decode(params, cfg, prev, out, code_masks=codes, code_masks_all=True)  # code masks
    with set_mesh(_fake_pipe_mesh(1)):  # a pipe axis of one stage
        ofa.encode(params, cfg, src, imgs, masks)
    plain = ofa.encode(params, reg, src, imgs, masks, generator=torch.Generator().manual_seed(1),
                       deterministic=False).x
    assert torch.equal(inside, plain)


def test_interleave_downgrade_warns_as_jax(caplog):
    """``pipeline_interleave`` falls back to GPipe, with the JAX model's
    warning, where the stack or the microbatches do not fit it."""
    cfg = dataclasses.replace(tc.ofa_tiny(), pipeline_microbatches=4, pipeline_interleave=2)
    mesh = _fake_pipe_mesh(2)
    with caplog.at_level(logging.WARNING, logger="musketeer_tpu_torch"):
        assert ofa._usable_interleave(cfg, 4, mesh, 2) == 2
        assert ofa._usable_interleave(cfg, 4, mesh, 4) == 1  # M > P
        assert ofa._usable_interleave(cfg, 6, mesh, 2) == 1  # L % (P·V)
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 2 and all("falls back to plain GPipe" in m for m in msgs)


def test_pipeline_refuses_a_batch_the_microbatches_do_not_split(model_setup, monkeypatch):
    monkeypatch.setattr(ofa, "pipeline_scan", lambda *a, **k: None)
    cfg, params, src, imgs, masks, _ = _port_model_case(model_setup["gpipe"])
    with set_mesh(_fake_pipe_mesh()), pytest.raises(ValueError, match="microbatches"):
        ofa.encode(params, dataclasses.replace(cfg, pipeline_microbatches=3), src, imgs, masks)


def test_validation_on_the_gathered_tree_matches_one_rank(port, model_setup):
    """Each data 2 × pipe 2 rank holds one of the two layers of a stack;
    gathered with ``full`` (validation's and the checkpoints' tree) the tree
    equals the whole tree bit for bit, and the forward and beam search on it
    under the mesh equal one rank's without a mesh."""
    from musketeer_tpu_torch.config import GenerationConfig
    from musketeer_tpu_torch.generation import beam_search

    cfg, params, src, imgs, masks, prev = _port_model_case(model_setup["gpipe"])
    with torch.no_grad():
        logits = ofa.forward(params, cfg, src, prev, imgs, masks)
        tokens = beam_search(params, cfg, GenerationConfig(beam_size=2, max_len_b=4),
                             ofa.encode(params, cfg, src, imgs, masks), max_len=4)
    for rank in range(4):
        got = port[rank]["validation"]
        assert got["held"] == 1
        assert all(torch.equal(a, b) for a, (_, b) in zip(got["tree"], named_leaves(params)))
        _close(got["logits"], logits)
        assert torch.equal(got["tokens"][0], tokens[0])  # the tokens; the scores:
        _close(got["tokens"][1], tokens[1])


# the meshes of the layout test: (data, fsdp, model, pipe), the model options
LAYOUTS = {
    "pipe2": ((1, 1, 1, 2), {}),
    "data2_pipe2": ((2, 1, 1, 2), {}),
    "fsdp2_pipe2": ((1, 2, 1, 2), {}),
    "model2_pipe2": ((1, 1, 2, 2), {}),
    "pipe2_interleave2": ((1, 1, 1, 2), dict(pipeline_microbatches=2, pipeline_interleave=2)),
}


@pytest.fixture(scope="module")
def tiny_shapes():
    import jax

    from musketeer_tpu import config as jc
    from musketeer_tpu.models import ofa as jofa

    cfg_j = jc.ofa_tiny()
    return cfg_j, jax.eval_shape(lambda: jofa.init_ofa_params(jax.random.PRNGKey(0), cfg_j))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipe_state_layout_matches_param_shardings(tiny_shapes, layout):
    """Every rank's blocks of the parameters, both AdamW moments and the EMA
    (``DataParallel.shard_state`` of ``ofa_tiny``'s state) hold, leaf by leaf,
    the bytes of the JAX ``param_shardings`` shard on the device at the
    rank's coordinate: a stage its own layers and their rows of the rel-pos
    tables (under the interleaved schedule its two chunks: the same bytes as
    JAX's contiguous block); in total ``state_bytes`` and ``leaf_spec``'s
    reckoning agree."""
    import jax

    from musketeer_tpu import config as jc
    from musketeer_tpu.parallel import make_mesh as jax_make_mesh
    from musketeer_tpu.parallel import mesh as jax_mesh
    from musketeer_tpu_torch.config import OptimConfig
    from musketeer_tpu_torch.training import init_train_state

    cfg_j, shapes = tiny_shapes
    sizes, opts = LAYOUTS[layout]
    cfg_t = dataclasses.replace(tc.ModelConfig(**dataclasses.asdict(cfg_j)), **opts)
    world = int(np.prod(sizes))
    jm = jax_make_mesh(jc.MeshConfig(*sizes), devices=jax.devices()[:world])
    shardings = dict(jax_mesh._tree_paths(jax_mesh.param_shardings(jm, shapes)))
    leaves = dict(jax_mesh._tree_paths(shapes))
    tree = from_jax(jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes),
                    cfg_t, "meta", torch.float32)
    state = init_train_state(tree, OptimConfig(), ema_decay=0.9)
    want_total = 0
    for rank in range(world):
        mesh = Mesh((*sizes, 1), rank, {})
        device = jm.devices[tuple(mesh.coords[a] for a in ("data", "fsdp", "model", "pipe"))
                            + (0,) * (jm.devices.ndim - 4)]
        want = {}
        for path, leaf in leaves.items():
            idx = shardings[path].devices_indices_map(leaf.shape)[device]
            want[path] = 4 * int(np.prod([len(range(*i.indices(n))) for i, n in
                                          zip(idx, leaf.shape)] or [1]))
        par = DataParallel(mesh, tree, cfg_t)
        held = par.shard_state(state)
        for t in (held.params, held.opt_state["mu"], held.opt_state["nu"], held.ema_params):
            got = {}
            for path, x in named_leaves(t):
                got[path] = got.get(path, 0) + x.numel() * x.element_size()
            assert got == want, [p for p in want if got.get(p) != want[p]]
        assert par.state_bytes(held) == 4 * sum(want.values()) == reckoned_state_bytes(
            tree, mesh, 4)
        assert par.state_bytes(held, full=True) == 4 * sum(
            4 * int(np.prod(leaf.shape)) for leaf in leaves.values())
        want_total += sum(want.values())
        if sizes[3] > 1 and world == 2:  # one stage holds half of every stack
            assert len(held.params["decoder"]["layers"]) == cfg_t.decoder_layers // 2
    assert want_total < world * 4 * sum(int(np.prod(leaf.shape)) for leaf in leaves.values())
