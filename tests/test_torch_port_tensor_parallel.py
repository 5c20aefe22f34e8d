"""The model axis (Megatron tensor parallelism) of the port against the JAX
package's GSPMD split on the same mesh.

The JAX joint step runs on a ``fsdp=2 × model=2`` mesh of 4 CPU devices
(``shard_params``, ``accum_batch_sharding``): ``jax.value_and_grad`` of
``multitask_loss`` for the loss, metrics and every gradient leaf, and the
step's optimizer on those gradients for the parameters after one update
(the step's own parts, without a second compile); on its XLA attention
branch, one compile a tree, the function of the port's either branch (as
``test_torch_port_loop.py`` compares them). The port runs the same
update on 4 gloo ranks (spawned once for the file, one intra-op thread each)
at ``model 2`` (data 2 × model 2) and ``model 2 × fsdp 2``: each rank holds
1/model of every head and FFN leaf (and 1/fsdp under FSDP), and the JAX
function is the same on either mesh. Each rank's parameter bytes are held to
the JAX shards' bytes on the device at its coordinates.

Three cases: the flash branch (at both layouts), the XLA branch (at model
2) and a NormFormer tree (at model 2 × fsdp 2; all four options,
``ffn_layernorm`` split over the model ranks, ``c_attn`` read per head).
``ofa_tiny`` cut to 1 + 1 layers and a 1024-row vocabulary (the tokens are
below 1000), ResNet (1, 1, 1), 32² images, float32, dropout off; an image
task and a text task, 4 rows each, R-Drop, an active drop-worst. Tolerances: loss and
metrics to 1e-5 relative, every gradient leaf to 1e-5 of the tree's largest
|g|, each parameter's move to ``test_torch_port_train._check_update``'s bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

from musketeer_tpu_torch import config as tc
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.parallel import DataParallel, set_mesh
from musketeer_tpu_torch.parallel.dryrun import run_fn
from musketeer_tpu_torch.parallel.mesh import DATA, FSDP, Mesh, make_mesh, shard_batches
from musketeer_tpu_torch.params import from_jax, init_ofa_params, map_leaves, trainable
from musketeer_tpu_torch.training import TaskBatch, init_train_state
from musketeer_tpu_torch.training.train_state import make_optimizer, named_leaves
from musketeer_tpu_torch.training.train_step import multitask_loss
from musketeer_tpu_torch.training.trainer import step_generator

UPDATE = 7000  # drop-worst active after 6000
CRIT = dict(label_smoothing=0.1, use_rdrop=True, drop_worst_ratio=0.2, drop_worst_after=6000)
OPTIM = dict(lr=1e-4, warmup_updates=0, total_updates=100)
B = 4
CASES = ("flash", "xla", "normformer")
RUNS = [("flash", "model2"), ("flash", "model2_fsdp2"), ("xla", "model2"),
        ("normformer", "model2_fsdp2")]
TREE = {"flash": "plain", "xla": "plain", "normformer": "normformer"}  # a case's tree
LAYOUTS = {"model2": tc.MeshConfig(model=2), "model2_fsdp2": tc.MeshConfig(fsdp=2, model=2)}
JAX_LAYOUT = "model2_fsdp2"  # the mesh the JAX step runs on


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's work in the test process, as the
    entry-point files run theirs: beside the suite's other workers one
    thread runs these small ops faster than many."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg_j(tree, flash):
    from musketeer_tpu import config as jc

    nf = {o: True for o in ("scale_attn", "scale_fc", "scale_heads", "scale_resids")}
    return dataclasses.replace(jc.ofa_tiny(), dtype="float32", encoder_layers=1, decoder_layers=1,
                               resnet_layers=(1, 1, 1), use_flash_attention=flash,
                               vocab_size=1024, padded_vocab_size=1024,
                               **(nf if tree == "normformer" else {}))


def _numpy_init(cfg_j):
    """A seeded tree in the JAX layout, as numpy arrays (the port's init: the
    JAX init's shapes and distributions, drawn in a fraction of its time)."""
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    tree = init_ofa_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    return map_leaves(lambda t: None if t is None else t.numpy(), tree)


def _np_batch(rs, cfg, Ts, Tt, img=False):
    tgt = rs.randint(4, 1000, (B, Tt)).astype(np.int32)
    tgt[:, -1] = cfg.eos
    tgt[0, -2:] = cfg.pad
    prev = np.roll(tgt, 1, 1)
    prev[:, 0] = cfg.bos
    src = rs.randint(4, 1000, (B, Ts)).astype(np.int32)
    src[-1, -2:] = cfg.pad
    b = dict(src_tokens=src, prev_output_tokens=prev, target=tgt)
    if img:
        b["patch_images"] = rs.rand(B, 32, 32, 3).astype(np.float32)
        b["patch_masks"] = np.ones(B, bool)
    return {k: v[None] for k, v in b.items()}  # the accumulation axis, A = 1


def _torch_batches(nb):
    t = lambda a: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
    return {n: TaskBatch(**{k: t(v) for k, v in b.items()}) for n, b in nb.items()}


def _like(tree, leaves):
    """``tree`` with its leaves replaced, in ``named_leaves`` order, by ``leaves``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: v for k, v in sorted(((k, walk(node[k])) for k in sorted(node)))}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return next(it)
    return walk(tree)


def _rank_runs(_, device, runs):
    """On each rank, for each (case, layout): the step's loss, metrics and
    gradients, taken as ``make_train_step`` takes them (the loss counted
    once over model; the gradients reduced, then gathered whole), the
    parameters after its optimizer takes them (gathered), and this rank's
    parameter bytes."""
    out = []
    for layout, cfg, params, batches in runs:
        mesh = make_mesh(layout)
        par = DataParallel(mesh, params)
        crit, optim = tc.CriterionConfig(**CRIT), tc.OptimConfig(**OPTIM)
        local = shard_batches(batches, mesh)
        state = init_train_state(par.shard(params), optim)._replace(step=UPDATE)
        full = par.gather(state.params, requires_grad=True)
        leaves = [p for _, p in named_leaves(full)]
        micro = {n: TaskBatch(*[None if x is None else x[0] for x in b]) for n, b in local.items()}
        with set_mesh(mesh):
            loss, metrics = multitask_loss(full, cfg, crit, micro, None, UPDATE, comm=par)
            (loss * par.loss_scale).backward()
        metrics = dict(metrics, loss=loss)
        keys = sorted(metrics)
        summed = par.all_reduce(torch.stack([metrics[k].detach() for k in keys]))
        grads = par.reduce_grads([torch.zeros_like(p) if p.grad is None else p.grad
                                  for p in leaves])
        make_optimizer(optim).update(state.params, grads, state.opt_state, norm=par.global_norm)
        rank_bytes = sum(t.numel() * t.element_size() for _, t in named_leaves(state.params))
        keep = lambda tree: [t.detach().clone() for _, t in named_leaves(tree)]
        grads = par.gather(_like(state.params, grads), full=True)
        state = par.gather_state(state)
        out.append(dict(rank_bytes=rank_bytes, metrics=dict(zip(keys, map(float, summed))),
                        grads=keep(grads) if mesh.rank == 0 else None,
                        params=keep(state.params) if mesh.rank == 0 else None))
    return out


@pytest.fixture(scope="module")
def setup():
    from tests.test_torch_port_model import _randomize
    from tests.test_torch_port_normformer import perturb_normformer

    trees = {}
    for name in ("plain", "normformer"):
        cfg_j = _cfg_j(name, False)
        rng = np.random.RandomState(7)
        tree = _randomize(_numpy_init(cfg_j), rng)
        if name == "normformer":
            tree = perturb_normformer(tree, rng)
        rs = np.random.RandomState(3)
        nb = {"caption": _np_batch(rs, cfg_j, 8, 5, img=True), "gigaword": _np_batch(rs, cfg_j, 10, 5)}
        trees[name] = dict(cfg_j=cfg_j, tree=tree, nb=nb)
    out = {}
    for case in CASES:
        t = trees[TREE[case]]
        cfg_t = tc.ModelConfig(**dataclasses.asdict(_cfg_j(TREE[case], case != "xla")))
        out[case] = dict(t, cfg_t=cfg_t)
    return out


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Per tree, the JAX step (its XLA branch) on the fsdp 2 × model 2 mesh:
    loss, metrics and gradients (``value_and_grad`` of ``multitask_loss``),
    the parameters and Adam's first moment after the step's optimizer takes
    those gradients; and per layout the bytes of each device's parameter
    shards. → by case."""
    import jax
    import jax.numpy as jnp
    import optax

    from musketeer_tpu import config as jc
    from musketeer_tpu.parallel import make_mesh as jax_make_mesh
    from musketeer_tpu.parallel import mesh as jax_mesh
    from musketeer_tpu.parallel import shard_params as jax_shard_params
    from musketeer_tpu.training import TaskBatch as JaxTaskBatch
    from musketeer_tpu.training import init_train_state as jax_init_state
    from musketeer_tpu.training.train_state import make_optimizer as jax_make_optimizer
    from musketeer_tpu.training.train_step import multitask_loss as jax_multitask_loss
    from tests.test_torch_port_train import _adam_state

    out = {}
    for case in ("xla", "normformer"):  # one case of each tree
        s = setup[case]
        cfg_j, cfg_t = s["cfg_j"], s["cfg_t"]
        crit, optim = jc.CriterionConfig(**CRIT), jc.OptimConfig(**OPTIM)
        bridge = lambda tree: [t for _, t in named_leaves(from_jax(
            jax.tree.map(np.asarray, tree), cfg_t, "cpu", torch.float32))]
        rec = {"bytes": {}}
        for name, layout in LAYOUTS.items():
            d, f, m, p, q = layout.axis_sizes(4)
            jmesh = jax_make_mesh(jc.MeshConfig(data=d, fsdp=f, model=m),
                                  devices=jax.devices()[:4])
            with jax.set_mesh(jmesh):
                params = jax_shard_params(jmesh, jax.tree.map(jnp.asarray, s["tree"]))
            per_device = dict.fromkeys(jmesh.devices.reshape(-1), 0)
            for leaf in jax.tree.leaves(params):
                for shard in leaf.addressable_shards:
                    per_device[shard.device] += shard.data.nbytes
            rec["bytes"][name] = [per_device[dv] for dv in jmesh.devices.reshape(-1)]
            if name != JAX_LAYOUT:
                continue
            with jax.set_mesh(jmesh):
                put = lambda a: jax.device_put(jnp.asarray(a),
                                               jax_mesh.accum_batch_sharding(jmesh))
                batches = {n: JaxTaskBatch(**{k: put(v) for k, v in b.items()})
                           for n, b in s["nb"].items()}
                micro = jax.tree.map(lambda a: a[0], batches)

                def f(pp):
                    return jax_multitask_loss(pp, cfg_j, crit, micro, jax.random.PRNGKey(1),
                                              jnp.int32(UPDATE))

                (loss, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
                # the step's update: its optimizer on these gradients
                st = jax_init_state(params, optim)
                updates, opt = jax.jit(jax_make_optimizer(optim).update)(grads, st.opt_state,
                                                                         params)
            rec.update(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
                       grads=bridge(grads), params=bridge(optax.apply_updates(params, updates)),
                       mu=bridge(_adam_state(st._replace(opt_state=opt)).mu))
        out[TREE[case]] = rec
    return {case: out[TREE[case]] for case in CASES}


@pytest.fixture(scope="module")
def port_runs(setup):
    runs = []
    for case, layout in RUNS:
        s = setup[case]
        params = trainable(from_jax(s["tree"], s["cfg_t"], "cpu", torch.float32))
        runs.append((LAYOUTS[layout], s["cfg_t"], params, _torch_batches(s["nb"])))
    per_rank = run_fn(4, _rank_runs, runs, timeout=300)
    return {key: dict(per_rank[0][i], rank_bytes=[r[i]["rank_bytes"] for r in per_rank])
            for i, key in enumerate(RUNS)}


@pytest.mark.parametrize("case,layout", RUNS, ids=[f"{c}-{lay}" for c, lay in RUNS])
def test_step_matches_jax_mesh(setup, jax_runs, port_runs, case, layout):
    from musketeer_tpu import config as jc
    from tests.test_torch_port_train import GRAD_REL

    ref, got = jax_runs[case], port_runs[(case, layout)]
    assert abs(got["metrics"]["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for k, v in ref["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-5 * max(abs(v), 1e-12), k
    scale = max(float(g.abs().max()) for g in ref["grads"])
    paths = [p for p, _ in named_leaves(from_jax(setup[case]["tree"], setup[case]["cfg_t"], "cpu",
                                                 torch.float32))]
    for path, a, b in zip(paths, got["grads"], ref["grads"]):
        assert float((a - b).abs().max()) <= 1e-5 * scale, path
    # each parameter's move, to test_torch_port_train._check_update's bound
    before = [t for _, t in named_leaves(from_jax(setup[case]["tree"], setup[case]["cfg_t"],
                                                  "cpu", torch.float32))]
    lr, b1, eps = OPTIM["lr"], jc.OptimConfig().adam_b1, jc.OptimConfig().adam_eps
    for pt, pj, p0, mu in zip(got["params"], ref["params"], before, ref["mu"]):
        g = (mu / (1 - b1)).numpy()
        bound = lr * (1e-2 + GRAD_REL * np.abs(g).max() * eps / (np.abs(g) + eps) ** 2)
        assert (np.abs((pt - p0).numpy() - (pj - p0).numpy()) - bound).max() <= 0
    # each rank holds the bytes of the JAX shards on the device at its coordinates
    assert got["rank_bytes"] == ref["bytes"][layout]
    assert max(got["rank_bytes"]) < sum(t.numel() * 4 for t in before)


def _dropout_rank(mesh, device, cfgs, params, batches, seed):
    """The joint loss under each of ``cfgs`` on this rank: its block of the
    batch, the generator of its batch block."""
    par = DataParallel(mesh, params)
    local = shard_batches(batches, mesh)
    micro = {n: TaskBatch(*[None if x is None else x[0] for x in b]) for n, b in local.items()}
    losses = []
    for cfg in cfgs:
        gen = step_generator(seed, 0, device, mesh.index(DATA, FSDP))
        with set_mesh(mesh), torch.no_grad():
            loss, _ = multitask_loss(par.gather(par.shard(params)), cfg,
                                     tc.CriterionConfig(label_smoothing=0.1), micro, gen, 0,
                                     comm=par)
        losses.append(float(par.all_reduce(loss.detach().clone())))
    return losses


def test_dropout_masks_under_model(setup):
    """With dropout, activation dropout and drop-path on, the two model ranks
    of a batch block compute one loss (the masks on the activations they
    replicate are equal: one generator per batch block), while the masks on
    their split activations (fc1's hidden units) are drawn per block; the
    keep rate of a block's mask is 1 − p, as the JAX model's."""
    s = setup["flash"]
    cfg = dataclasses.replace(s["cfg_t"], dropout=0.1, activation_dropout=0.3,
                              encoder_drop_path_rate=0.1, decoder_drop_path_rate=0.1)
    params = trainable(from_jax(s["tree"], cfg, "cpu", torch.float32))
    batches = _torch_batches(s["nb"])
    off = dataclasses.replace(cfg, dropout=0.0, activation_dropout=0.0,
                              encoder_drop_path_rate=0.0, decoder_drop_path_rate=0.0)
    per_rank = run_fn(4, _dropout_rank, [cfg, off], params, batches, 5,
                      mesh=tc.MeshConfig(model=2))
    losses, deterministic = zip(*per_rank)
    assert losses[0] == losses[1] and losses[2] == losses[3] and losses[0] == losses[2]
    assert deterministic[0] != losses[0]
    # a split activation's mask: one block's draw from the batch block's generator
    p = cfg.activation_dropout
    h = torch.ones(64, 512)  # fc1's hidden units of one model rank (ffn / 2)
    kept = ofa._dropout(h, p, step_generator(5, 0, "cpu", 0), False) != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.01


def test_step_generator_follows_the_batch_block():
    """Ranks of one batch block (any model, pipe and seq coordinates) get one
    generator; another block, seed or update another."""
    from musketeer_tpu_torch.parallel.mesh import Mesh

    sizes = (2, 1, 2, 2, 1)  # data, fsdp, model, pipe, seq
    streams = {}
    for r in range(8):
        block = Mesh(sizes, r, {}).index(DATA, FSDP)
        draw = torch.rand(4, generator=step_generator(7, 3, "cpu", block))
        streams.setdefault(block, []).append(draw)
    assert len(streams) == 2
    for draws in streams.values():
        assert all(torch.equal(d, draws[0]) for d in draws)
    assert not torch.equal(streams[0][0], streams[1][0])


def test_kernel_inputs_are_contiguous_on_a_model_shard(setup, monkeypatch):
    """On the card the attention kernels read their tensors in place and
    refuse strided ones: one model rank's shard (rank 0 of model 2, its
    collectives on a gloo group of one process) hands ``flash_attention``
    contiguous q, k, v, pos_q, pos_k and rel, as the whole tree does."""
    import torch.distributed as dist

    from musketeer_tpu_torch.parallel.dryrun import _free_port

    s = setup["flash"]
    params = trainable(from_jax(s["tree"], s["cfg_t"], "cpu", torch.float32))
    mesh = Mesh((1, 1, 2, 1, 1), 0, {})
    blocks = DataParallel(mesh, params).shard(params)
    blocks["embed_tokens"] = params["embed_tokens"]
    seen = []
    inner = ofa.flash_attention

    def checked(*args, **kw):
        seen.append(args[0].shape[1])
        for t in args:
            assert t is None or t.is_contiguous()
        return inner(*args, **kw)

    monkeypatch.setattr(ofa, "flash_attention", checked)
    batches = _torch_batches(s["nb"])
    micro = {n: TaskBatch(*[None if x is None else x[0] for x in b]) for n, b in batches.items()}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        with set_mesh(mesh):
            loss, _ = multitask_loss(blocks, s["cfg_t"], tc.CriterionConfig(**CRIT), micro, None,
                                     UPDATE)
            loss.backward()
    finally:
        dist.destroy_process_group()
    assert seen and set(seen) == {s["cfg_t"].attention_heads // 2}
