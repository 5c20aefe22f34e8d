"""Data-parallel and FSDP training of the port against the JAX package's mesh.

The JAX joint step runs once, on a ``data=2 × fsdp=2`` mesh of 4 CPU devices
(parameters sharded by ``shard_params``, batches by ``accum_batch_sharding``).
The port runs the same update on gloo ranks spawned from this process (one
intra-op thread each) over the layouts ``data × fsdp`` = 1 × 1, 4 × 1,
1 × 4 and 2 × 2: each rank holds its block of every batch and, under FSDP,
1/fsdp of every sharded leaf of the parameters, AdamW moments and EMA.

``ofa_tiny`` cut to 1 + 1 layers, ResNet (1, 1, 1), 32² images, float32, both
packages on the XLA attention branch; three tasks (an image task and two
text tasks that pack into one forward), two micro-batches of 4 rows each,
R-Drop, an active drop-worst, dropout off. Tolerances: loss, gradient norm
and per-task metrics to 1e-5 relative; AdamW moments and EMA to 1e-5 of the
tree's largest value; each parameter's move to the bound of
``test_torch_port_train._check_update`` (Adam's first step divides each
gradient by |g| + eps, so a gradient difference of 1e-5 of a leaf's largest
|g| moves a parameter whose |g| is near eps by up to lr).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu import config as jc
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.parallel import make_mesh as jax_make_mesh
from musketeer_tpu.parallel import mesh as jax_mesh
from musketeer_tpu.parallel import shard_params as jax_shard_params
from musketeer_tpu.training import TaskBatch as JaxTaskBatch
from musketeer_tpu.training import init_train_state as jax_init_state
from musketeer_tpu.training import make_train_step as jax_make_step
from musketeer_tpu_torch import config as tc
from musketeer_tpu_torch.parallel import mesh
from musketeer_tpu_torch.parallel.dryrun import (
    Job, dryrun_multirank, run_job, run_layouts, run_ranks,
)
from musketeer_tpu_torch.params import from_jax, trainable
from musketeer_tpu_torch.training import TaskBatch
from musketeer_tpu_torch.training.train_state import named_leaves
from tests.test_torch_port_model import _randomize
from tests.test_torch_port_train import GRAD_REL, _adam_state

UPDATE = 7000  # drop-worst active after 6000
CRIT = dict(label_smoothing=0.1, use_rdrop=True, drop_worst_ratio=0.2, drop_worst_after=6000)
OPTIM = dict(lr=1e-4, warmup_updates=0, total_updates=100)
EMA = 0.9
B, A = 4, 2  # global rows per task batch, micro-batches per update


def _np_batch(rs, cfg, Ts, Tt, img=False):
    def one():
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
        return b
    parts = [one() for _ in range(A)]
    return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


def _torch_step(nb):
    t = lambda a: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
    return {n: TaskBatch(**{k: t(v) for k, v in b.items()}) for n, b in nb.items()}


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jc.ofa_tiny(), dtype="float32", use_flash_attention=False,
                                encoder_layers=1, decoder_layers=1, resnet_layers=(1, 1, 1))
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    params = jax.jit(jofa.init_ofa_params, static_argnums=1)(jax.random.PRNGKey(0), cfg_j)
    params_np = _randomize(jax.tree.map(np.array, params), np.random.RandomState(7))
    rs = np.random.RandomState(3)
    steps = [{"caption": _np_batch(rs, cfg_j, 8, 5, img=True),
              "gigaword": _np_batch(rs, cfg_j, 10, 5),
              "infill": _np_batch(rs, cfg_j, 10, 5)} for _ in range(2)]
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_np=params_np, steps=steps)


def _job(setup, steps, **kw):
    params = trainable(from_jax(setup["params_np"], setup["cfg_t"], "cpu", torch.float32))
    return Job(setup["cfg_t"], tc.CriterionConfig(**CRIT), tc.OptimConfig(**OPTIM), params,
               [_torch_step(s) for s in steps], update=UPDATE, ema_decay=EMA, **kw)


@pytest.fixture(scope="module")
def jax_run(setup):
    """The JAX step on the data=2 × fsdp=2 mesh of 4 CPU devices → (metrics,
    params, Adam mu and nu, EMA), bridged to the port's layout."""
    cfg_j = setup["cfg_j"]
    jmesh = jax_make_mesh(jc.MeshConfig(data=2, fsdp=2), devices=jax.devices()[:4])
    optim = jc.OptimConfig(**OPTIM)
    with jax.set_mesh(jmesh):
        params = jax_shard_params(jmesh, jax.tree.map(jnp.asarray, setup["params_np"]))
        st = jax_init_state(params, optim, ema_decay=EMA)._replace(step=jnp.int32(UPDATE))
        step = jax_make_step(cfg_j, jc.CriterionConfig(**CRIT), optim, ema_decay=EMA,
                             donate=False)
        put = lambda a: jax.device_put(jnp.asarray(a), jax_mesh.accum_batch_sharding(jmesh))
        batches = {n: JaxTaskBatch(**{k: put(v) for k, v in b.items()})
                   for n, b in setup["steps"][0].items()}
        st, m = step(st, batches, jax.random.PRNGKey(1))
    bridge = lambda tree: [t for _, t in named_leaves(from_jax(
        jax.tree.map(np.asarray, tree), setup["cfg_t"], "cpu", torch.float32))]
    adam = _adam_state(st)
    return dict(metrics={k: float(v) for k, v in m.items()}, params=bridge(st.params),
                mu=bridge(adam.mu), nu=bridge(adam.nu), ema=bridge(st.ema_params))


def _check_against_jax(setup, rec, ref):
    m = rec["metrics"][0]
    assert set(m) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert abs(m[k] - v) <= 1e-5 * max(abs(v), 1e-12), (k, m[k], v)
    for key in ("mu", "nu", "ema"):
        scale = max(float(t.abs().max()) for t in ref[key])
        worst = max(float((a - b).abs().max()) for a, b in zip(rec[key], ref[key]))
        assert worst <= 1e-5 * scale, (key, worst, scale)
    # each parameter's move, to test_torch_port_train._check_update's bound
    before = [t for _, t in named_leaves(
        from_jax(setup["params_np"], setup["cfg_t"], "cpu", torch.float32))]
    lr, b1, eps = OPTIM["lr"], jc.OptimConfig().adam_b1, jc.OptimConfig().adam_eps
    for pt, pj, p0, mu in zip(rec["params"], ref["params"], before, ref["mu"]):
        g = (mu / (1 - b1)).numpy()
        bound = lr * (1e-2 + GRAD_REL * np.abs(g).max() * eps / (np.abs(g) + eps) ** 2)
        assert (np.abs((pt - p0).numpy() - (pj - p0).numpy()) - bound).max() <= 0


LAYOUTS = [(1, 1), (4, 1), (1, 4), (2, 2)]  # (data, fsdp)


@pytest.fixture(scope="module")
def rank_runs(setup, tmp_path_factory):
    """One spawn of 4 gloo ranks runs the update in the three 4-rank layouts
    and the two updates at 2 × 2 that save the first (the resume test's);
    a world of 1 runs the update apart. → ({(data, fsdp): record}, the
    checkpoint's dir, the 2 × 2 two-update record)."""
    ckpt = tmp_path_factory.mktemp("ckpt_2x2")
    one = _job(setup, setup["steps"][:1])
    recs = run_layouts(4, [(f, one) for d, f in LAYOUTS[1:]]
                       + [(2, _job(setup, setup["steps"], save_dir=str(ckpt)))])
    by_layout = dict(zip(LAYOUTS[1:], recs[:3]))
    by_layout[(1, 1)] = run_ranks(1, 1, one)
    return by_layout, ckpt, recs[3]


@pytest.mark.parametrize("data,fsdp", LAYOUTS, ids=[f"data{d}_fsdp{f}" for d, f in LAYOUTS])
def test_step_matches_jax_mesh(setup, jax_run, rank_runs, data, fsdp):
    rec = rank_runs[0][(data, fsdp)]
    assert rec["step"] == UPDATE + 1
    # under fsdp every rank holds less than one rank's state
    assert (max(rec["rank_state_bytes"]) < rank_runs[0][(1, 1)]["state_bytes"]) == (fsdp > 1)
    _check_against_jax(setup, rec, jax_run)


def test_checkpoint_at_2x2_resumes_at_one_rank(setup, rank_runs):
    """Saved (gathered) after the first update at data 2 × fsdp 2, resumed at
    one rank for the second: the same metrics and state as the 2 × 2 run's."""
    _, ckpt, straight = rank_runs
    resumed = run_job(_job(setup, setup["steps"][1:], load_dir=str(ckpt)))
    assert straight["step"] == resumed["step"] == UPDATE + 2
    for k, v in straight["metrics"][1].items():
        assert abs(resumed["metrics"][0][k] - v) <= 1e-5 * max(abs(v), 1e-12), k
    for key in ("params", "mu", "nu", "ema"):
        scale = max(float(t.abs().max()) for t in straight[key])
        worst = max(float((a - b).abs().max()) for a, b in zip(resumed[key], straight[key]))
        assert worst <= 1e-5 * scale, (key, worst)


def test_dryrun_multirank():
    out = dryrun_multirank(4)
    assert np.isfinite(out["loss"]) and out["gnorm"] > 0



def _jax_specs(cfg, sizes):
    """(path, fitted spec, shape) of every leaf of the JAX tree under ``cfg``,
    on a mesh of ``sizes`` (data, fsdp) of the CPU devices."""
    shapes = jax.eval_shape(lambda: jofa.init_ofa_params(jax.random.PRNGKey(0), cfg))
    jm = jax_make_mesh(jc.MeshConfig(data=sizes[0], fsdp=sizes[1]),
                       devices=jax.devices()[:sizes[0] * sizes[1]])
    out = {}
    for path, leaf in jax_mesh._tree_paths(shapes):
        spec = jax_mesh._fit_spec(jax_mesh.param_spec(path, leaf.ndim), leaf.shape, jm)
        out[path] = (tuple(spec), leaf.shape)
    return shapes, out


@pytest.mark.parametrize("preset", ["ofa_tiny", "ofa_base"])
def test_param_specs_match_jax(preset):
    """param_spec / _fit_spec on every JAX leaf equal the JAX package's, and
    every leaf of the port's tree gets that spec in its own layout."""
    cfg_j = jc.ARCH_PRESETS[preset]()
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    for sizes in ((2, 2), (1, 4)):
        port_mesh = mesh.Mesh((*sizes, 1, 1, 1), 0, {})
        assert port_mesh.shape == dict(jax_make_mesh(
            jc.MeshConfig(data=sizes[0], fsdp=sizes[1]), devices=jax.devices()[:4]).shape)
        shapes, specs = _jax_specs(cfg_j, sizes)
        for path, (spec, shape) in specs.items():
            ours = mesh._fit_spec(mesh.param_spec(path, len(shape)), shape, port_mesh)
            assert ours == spec, path
        # the port's tree, built on the meta device from the JAX shapes
        meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes)
        tree = from_jax(meta, cfg_t, "meta", torch.float32)
        sharded = 0
        for path, leaf in named_leaves(tree):
            spec, shape = specs[path]
            stacked = len(shape) == leaf.dim() + 1
            assert mesh.jax_shape(path, leaf.shape) == tuple(shape[stacked:]), path
            want = (spec + (None,) * (len(shape) - len(spec)))[stacked:]  # JAX drops trailing Nones
            got = mesh.leaf_spec(path, leaf.shape, port_mesh)
            if leaf.dim() == 2 and path.endswith(".w"):
                got = got[::-1]
            elif leaf.dim() == 4:
                got = (got[2], got[3], got[1], got[0])  # OIHW → HWIO
            assert got == want, path
            sharded += mesh.sharded_dim(path, leaf.shape, port_mesh, mesh.FSDP) is not None
        assert sharded > 20
        assert mesh.sharded_dim("encoder.embed_image_positions",
                                tree["encoder"]["embed_image_positions"].shape, port_mesh,
                                mesh.FSDP) is None


def test_rank_blocks_follow_the_batch_sharding():
    """Rank r's block is device r's under P((DATA, FSDP)), data-major."""
    for sizes in ((2, 2, 1, 1, 1), (4, 1, 1, 1, 1), (1, 4, 1, 1, 1)):
        jm = jax_make_mesh(jc.MeshConfig(data=sizes[0], fsdp=sizes[1]), devices=jax.devices()[:4])
        x = jax.device_put(jnp.arange(8), jax_mesh.batch_sharding(jm))
        for r, dev in enumerate(jm.devices.reshape(-1)):
            shard = next(s for s in x.addressable_shards if s.device == dev)
            block = mesh.batch_block(8, mesh.Mesh(sizes, r, {}))
            np.testing.assert_array_equal(np.asarray(shard.data), np.arange(8)[block])


@pytest.mark.parametrize("seed", [1, 1 << 16, (1 << 31) - 1])
def test_step_generator_rank_streams(seed):
    """Batch block 0 (a one-process run's, the default argument) draws from
    the generator seeded with SeedSequence([seed, update, 0])'s first word;
    every block is seeded with a value of its own: no (seed, block)
    shares it with another pair, also for seeds of 2^16 and more, where a
    block shifted into the seed's bits would; the value is a function of
    (seed, update, block) alone; and the CPU masks depend on the seed (the
    CPU's mt19937 keeps only a seed's low 32 bits)."""
    from musketeer_tpu_torch.training.trainer import step_generator

    draw = lambda g: torch.rand(8, generator=g)
    block0 = int(np.random.SeedSequence([seed, 3, 0]).generate_state(1, np.uint64)[0])
    assert torch.equal(draw(step_generator(seed, 3, "cpu")),
                       draw(torch.Generator().manual_seed(block0)))
    assert torch.equal(draw(step_generator(seed, 3, "cpu", 0)), draw(step_generator(seed, 3, "cpu")))
    value = lambda s, update, block: step_generator(s, update, "cpu", block).initial_seed()
    pairs = [(s, r) for s in (seed, seed + (1 << 16), seed + 2 * (1 << 16)) for r in range(4)]
    assert len({value(s, 3, r) for s, r in pairs}) == len(pairs)
    assert value(seed, 3, 1) == value(seed, 3, 1) != value(seed, 4, 1)
    assert len({float(draw(step_generator(s, 3, "cpu"))[0]) for s in (seed, seed + 1)}) == 2


def test_two_seeds_give_two_cpu_masks():
    """Two --seed values draw two dropout masks on the CPU, at every update
    and block (the fault: ``(seed << 32) + update`` kept the update alone)."""
    from musketeer_tpu_torch.models.ofa import _dropout
    from musketeer_tpu_torch.training.trainer import step_generator

    x = torch.ones(64, 64)
    for update in (0, 5):
        for block in (0, 1):
            a, b = (_dropout(x, 0.1, step_generator(seed, update, "cpu", block), False)
                    for seed in (7, 8))
            assert not torch.equal(a, b)
