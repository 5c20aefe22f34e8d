"""The port's training entry points against the JAX package: the joint loader
with its uint8 transport, image_classify's train augmentation, prefetch,
metrics, checkpoints, the early stopper, ``train_loop`` and the CLI.

The loader, augmentation and ``train_loop`` comparisons read the same seeded
TSVs (noise PNGs, as ``tests/test_torch_port_tasks.py`` writes them) on both
sides. ``train_loop`` runs ``ofa_tiny`` cut to 2 + 2 layers and ResNet
(1, 1, 1) in float32 with every dropout rate 0, from one seeded parameter
tree (the JAX init with random rel-pos tables and BN statistics, bridged by
``from_jax``); the JAX loop's step is its XLA attention branch (one compile),
the port's the plain K3/K4 of its flash branch, the same function. Logged
losses: update 1 within 1e-5 relative, later ones within 1e-4 (the two
sides' parameters drift apart by rounding as updates accumulate; measured:
see CHANGES.md). The CLI runs ``--device cpu --arch ofa_tiny``. The CLI's
``train`` at ``--fsdp 2``, ``--remat`` and the model, pipe and seq axes
against its one-rank run is in ``tests/test_torch_port_loop_axes.py``.
"""

import dataclasses
import json
import random
import shutil
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu import config as jc
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.tasks import MusketeerDataLoader as JaxLoader
from musketeer_tpu.tasks import SubTaskSpec as JaxSpec
from musketeer_tpu.tokenization import default_vocab as jax_vocab
from musketeer_tpu.training import init_train_state as jax_init_state
from musketeer_tpu.training.metrics import MetricsLogger as JaxMetricsLogger
from musketeer_tpu.training.trainer import train_loop as jax_train_loop
from musketeer_tpu_torch import cli
from musketeer_tpu_torch import config as tc
from musketeer_tpu_torch.convert import convert_state_dict
from musketeer_tpu_torch.convert import load_checkpoint as convert_load
from musketeer_tpu_torch.data.task_data import ImageClassifyBuilder
from musketeer_tpu_torch.params import from_jax, init_ofa_params, trainable
from musketeer_tpu_torch.tasks import MusketeerDataLoader, SubTaskSpec
from musketeer_tpu_torch.tokenization import default_vocab
from musketeer_tpu_torch.training import (
    CheckpointManager, EarlyStopper, MetricsLogger, init_train_state, load_checkpoint,
    save_checkpoint, train_loop, wait_for_saves,
)
from musketeer_tpu_torch.training.checkpoint import export_pt, import_pt
from musketeer_tpu_torch.training.prefetch import PrefetchIterator
from musketeer_tpu_torch.training.train_state import named_leaves
from tests.test_tasks import write_tsv
from tests.test_torch_port_model import _randomize
from tests.test_torch_port_normformer import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_port_tasks import VQA_ANSWERS, CLASSES, _vqa_ref, noise_image_b64

IMG = 32


def _train_rows(rng, n=8):
    img = lambda: noise_image_b64(rng, 40, 32)
    return {
        "caption": [[str(i), img(), f"a thing number {i} on a table"] for i in range(n)],
        "vqa_gen": [[str(i), img(), f"what is object {i}", _vqa_ref(rng)] for i in range(n)],
        "snli_ve": [[str(i), img(), "a dog runs", f"an animal {i}",
                     ["entailment", "neutral", "contradiction"][i % 3]] for i in range(n)],
        "image_classify": [[str(i), img(), CLASSES[i % 4]] for i in range(4)],
    }


@pytest.fixture(scope="module")
def tsvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_tsv")
    return {k: write_tsv(d / f"{k}.tsv", rows)
            for k, rows in _train_rows(np.random.RandomState(5)).items()}


def _specs(cls, tsvs, names):
    kw = {"vqa_gen": dict(answers=VQA_ANSWERS)}
    return [cls(n, tsvs[n], batch_size=2,
                task_kwargs=dict(patch_image_size=IMG, **kw.get(n, {}))) for n in names]


LOADER_TASKS = ("caption", "vqa_gen", "snli_ve")


def test_loader_batches_match_jax(tsvs):
    """Two epochs' batches, every field exactly: tokens, masks, the uint8
    images and their affine, the bit-packed constraint masks; a resume
    (``skip_steps``) gives the tail of the same order."""
    jl = JaxLoader(jax_vocab(), _specs(JaxSpec, tsvs, LOADER_TASKS), seed=3, update_freq=2)
    tl = MusketeerDataLoader(default_vocab(), _specs(SubTaskSpec, tsvs, LOADER_TASKS), seed=3,
                             update_freq=2)
    seen = set()
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        for skip in (0, 1):
            ref = list(jl.epoch_iterator(skip_steps=skip))
            out = list(tl.epoch_iterator(skip_steps=skip))
            assert len(out) == len(ref) == tl.steps_per_epoch() - skip == 2 - skip
            for bj, bt in zip(ref, out):
                assert set(bj) == set(bt) == set(LOADER_TASKS)
                for name in LOADER_TASKS:
                    for field, a, b in zip(bj[name]._fields, bj[name], bt[name]):
                        assert (a is None) == (b is None), (name, field)
                        if a is None:
                            continue
                        a = np.asarray(a)
                        assert b.shape[0] == 2  # the accumulation axis
                        np.testing.assert_array_equal(b.numpy(), a.astype(b.numpy().dtype))
                        seen.add((field, str(b.dtype)))
    tl.close()
    assert ("patch_images", "torch.uint8") in seen and ("constraint_masks", "torch.uint8") in seen
    assert ("patch_norm", "torch.float32") in seen


def test_unported_loader_options_raise(tsvs, tmp_path):
    """No task or loader option is refused any more: ``image_gen`` (which was)
    loads, its batches carrying code masks and code targets, and
    ``sample_patch_num`` is accepted (``test_torch_port_pretrain.py`` holds
    its orders to JAX's)."""
    v = default_vocab()
    path = tmp_path / "gen.tsv"
    path.write_text("".join(f"{i}\ta red cube {i}\t{' '.join(str(c) for c in range(i, i + 16))}\n"
                            for i in range(4)))
    loader = MusketeerDataLoader(v, [SubTaskSpec("image_gen", str(path)),
                                     SubTaskSpec("caption", tsvs["caption"], sample_patch_num=16)])
    batch = next(iter(loader.epoch_iterator()))["image_gen"]
    loader.close()
    assert bool(batch.code_masks.all()) and batch.patch_images is None
    assert bool(((batch.target[..., :16] >= v.code_start) & (batch.target[..., :16] < v.code_start + 16 + 4)).all())


def test_image_classify_train_augmentation_matches_jax(tsvs):
    from musketeer_tpu.data.task_data import ImageClassifyBuilder as JaxBuilder
    from musketeer_tpu.data import FileDataset as JaxFileDataset

    rows = [JaxFileDataset(tsvs["image_classify"])[i] for i in range(4)]
    out = {}
    for side, cls, vocab in (("jax", JaxBuilder, jax_vocab()), ("torch", ImageClassifyBuilder,
                                                                 default_vocab())):
        random.seed(11)
        np.random.seed(11)
        b = cls(vocab, split="train", patch_image_size=IMG, seed=4)
        out[side] = [b(r) for r in rows]
    for ej, et in zip(out["jax"], out["torch"]):
        np.testing.assert_array_equal(et.patch_image, ej.patch_image)
        np.testing.assert_array_equal(et.target_ids, ej.target_ids)
    # the augmentation draws: a different seed gives other pixels
    assert not np.array_equal(out["torch"][0].patch_image, out["torch"][1].patch_image)


# ---------------------------------------------------------------------------
# prefetch (as tests/test_prefetch.py holds the JAX package's)
# ---------------------------------------------------------------------------

def test_prefetch_order_and_exception():
    assert list(PrefetchIterator(iter(range(100)), depth=3)) == list(range(100))

    def gen():
        yield 1
        yield 2
        raise ValueError("boom")

    it = PrefetchIterator(gen(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="boom"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_close_and_depth():
    produced = []

    def gen(n):
        for i in range(n):
            produced.append(i)
            yield i

    it = PrefetchIterator(gen(1000), depth=2)
    assert next(it) == 0
    it.close()
    time.sleep(0.3)
    assert len(produced) < 20
    with pytest.raises(StopIteration):
        next(it)
    assert not it._thread.is_alive()

    produced.clear()
    it = PrefetchIterator(gen(50), depth=2)
    time.sleep(0.3)
    assert len(produced) <= 4  # depth + in-flight slack
    assert list(it) == list(range(50)) and len(produced) == 50
    assert it.producer_items == 50 and it.consumed == 51


def test_prefetch_moves_batches_to_the_device():
    from musketeer_tpu_torch.training import TaskBatch

    items = [{"t": TaskBatch(torch.ones(2, 3), torch.zeros(2, 3), torch.zeros(2, 3))}] * 3
    out = list(PrefetchIterator(iter(items), depth=2, device="cpu"))
    assert len(out) == 3 and all(o["t"].src_tokens.device.type == "cpu" for o in out)


def test_metrics_logger_derived_metrics_match_jax():
    steps = [{"loss/a": 2.0, "nll/a": 3.0, "nll/b": 5.0}, {"loss/a": 1.0, "nll/a": 1.0,
                                                            "nll/b": 2.0}]
    logs = [JaxMetricsLogger(), MetricsLogger()]
    for i, values in enumerate(steps, 1):
        for lg in logs:
            lg.log_step(i, values)
    ref, out = logs[0].averages(), logs[1].averages()
    assert set(ref) == set(out)
    for k in ref:
        if k != "ups":  # a wall-clock rate
            assert out[k] == pytest.approx(ref[k], rel=1e-12), k
    assert out["ppl"] == pytest.approx(2.0 ** ((2.0 + 3.5) / 2))


# ---------------------------------------------------------------------------
# checkpoints and the early stopper (as tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _tiny_cfg():
    return dataclasses.replace(tc.ofa_tiny(), use_flash_attention=True, embed_dim=32, ffn_dim=64,
                               encoder_layers=1, decoder_layers=1, attention_heads=4,
                               vocab_size=64, padded_vocab_size=128, resnet_layers=(1, 1, 1))


def _tiny_state(seed=0, ema=0.0):
    cfg = _tiny_cfg()
    tree = init_ofa_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    params = trainable(from_jax(tree, cfg, "cpu", torch.float32))
    return init_train_state(params, tc.OptimConfig(), ema_decay=ema)


def _equal(a, b):
    la, lb = named_leaves(a), named_leaves(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x.detach(), y.detach()) for (_, x), (_, y) in zip(la, lb))


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip(tmp_path, async_save):
    state = _tiny_state(ema=0.99)._replace(step=17)
    with torch.no_grad():
        state.opt_state["mu"]["embed_tokens"].normal_()
        state.ema_params["embed_tokens"].add_(1.0)
    state.opt_state["count"] = 17
    save_checkpoint(str(tmp_path), state, "checkpoint_last", {"epoch": 3}, async_save=async_save)
    template = _tiny_state(seed=1, ema=0.99)
    restored, meta = load_checkpoint(str(tmp_path), template)  # waits for the write itself
    assert restored.step == 17 and meta["epoch"] == 3 and restored.opt_state["count"] == 17
    assert _equal(restored.params, state.params) and _equal(restored.ema_params, state.ema_params)
    assert _equal(restored.opt_state["mu"], state.opt_state["mu"])
    assert all(p.requires_grad for _, p in named_leaves(restored.params))
    # without a template: the same values, parameters that require grad
    bare, _ = load_checkpoint(str(tmp_path), device="cpu")
    assert _equal(bare.params, state.params) and bare.params["embed_tokens"].requires_grad
    # saving a name again replaces it
    save_checkpoint(str(tmp_path), state._replace(step=18), "checkpoint_last", None, async_save)
    wait_for_saves()
    assert load_checkpoint(str(tmp_path), template)[0].step == 18
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint_last",
                                                          "checkpoint_last.meta.json"]


def test_checkpoint_ema_structure_adaptation(tmp_path):
    state = _tiny_state(ema=0.99)
    save_checkpoint(str(tmp_path), state, "with_ema")
    restored, _ = load_checkpoint(str(tmp_path), _tiny_state(seed=1), "with_ema")
    assert restored.ema_params is not None and _equal(restored.ema_params, state.ema_params)
    save_checkpoint(str(tmp_path), _tiny_state(), "no_ema")
    restored0, _ = load_checkpoint(str(tmp_path), _tiny_state(seed=2, ema=0.99), "no_ema")
    assert restored0.ema_params is None


LOADERS = {
    "checkpoint.load_checkpoint": lambda d: load_checkpoint(str(d)),
    "import_pt": lambda d: import_pt(str(d / "tiny.pt")),
    "convert.load_checkpoint": lambda d: convert_load(str(d / "tiny.pt")),
    "convert_state_dict": lambda d: convert_state_dict(
        torch.load(d / "tiny.pt", weights_only=False)["model"]),
}


@pytest.mark.parametrize("loader", sorted(LOADERS))
def test_loaders_need_a_device(tmp_path, loader):
    """A loader that builds a tree without a template has no default device,
    as ``from_jax`` has none: a caller that names no device is refused, not
    put on the CPU."""
    state = _tiny_state()
    save_checkpoint(str(tmp_path), state)
    export_pt(state.params, _tiny_cfg(), str(tmp_path / "tiny.pt"))
    with pytest.raises((TypeError, ValueError), match="device"):
        LOADERS[loader](tmp_path)


def test_checkpoint_manager_best_policy(tmp_path):
    state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path), keep_best_checkpoints=2, save_interval_updates=5)
    w1 = mgr.step(state, 1, 10, val_metric=0.5, end_of_epoch=True)
    assert "checkpoint_best" in w1 and "checkpoint1" in w1
    assert "checkpoint_2_15" in mgr.step(state, 2, 15, steps_in_epoch=5)
    w2 = mgr.step(state, 2, 20, val_metric=0.7, end_of_epoch=True)
    assert "checkpoint_best" in w2
    w3 = mgr.step(state, 3, 30, val_metric=0.4, end_of_epoch=True)
    assert "checkpoint_best" not in w3
    kept = sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("checkpoint.best") and not p.name.endswith(".json"))
    assert kept == ["checkpoint.best_score_0.5000", "checkpoint.best_score_0.7000"]
    meta = json.loads((tmp_path / "checkpoint_last.meta.json").read_text())
    assert meta["best_val"] == 0.7 and meta["num_updates"] == 30


def test_early_stopper():
    s = EarlyStopper(patience=2, maximize=True)
    assert not s.should_stop(0.5)
    assert not s.should_stop(0.6)
    assert not s.should_stop(0.55)  # run 1
    assert s.should_stop(0.55)  # run 2: stop
    assert not EarlyStopper(patience=-1, maximize=True).should_stop(0.1)
    m = EarlyStopper(patience=1, maximize=False)
    assert not m.should_stop(2.0) and not m.should_stop(1.0) and m.should_stop(1.5)


# ---------------------------------------------------------------------------
# train_loop against the JAX package's, and resume
# ---------------------------------------------------------------------------

LOOP_TASKS = ("caption", "snli_ve")


def _loop_cfgs(**kw):
    cfg_j = dataclasses.replace(jc.ofa_tiny(), dtype="float32", encoder_layers=2,
                                decoder_layers=2, resnet_layers=(1, 1, 1), **kw)
    cfg_t = tc.ModelConfig(**dataclasses.asdict(dataclasses.replace(cfg_j,
                                                                    use_flash_attention=True)))
    return cfg_j, cfg_t


def _train_cfg(mod, **kw):
    return mod.TrainConfig(optim=mod.OptimConfig(lr=1e-3, warmup_updates=1, total_updates=100),
                           criterion=mod.CriterionConfig(), max_epoch=1, **kw)


@pytest.fixture(scope="module")
def loop_tree():
    cfg_j, _ = _loop_cfgs()
    params = jax.jit(jofa.init_ofa_params, static_argnums=1)(jax.random.PRNGKey(0), cfg_j)
    return _randomize(jax.tree.map(np.array, params), np.random.RandomState(7))


def test_train_loop_matches_jax(tsvs, loop_tree):
    """3 updates of each loop on the same loader: the logged losses."""
    cfg_j, cfg_t = _loop_cfgs()
    logged = {"jax": [], "torch": []}
    jl = JaxLoader(jax_vocab(), _specs(JaxSpec, tsvs, LOOP_TASKS), seed=3)
    jax_train_loop(_train_cfg(jc, max_update=3), cfg_j,
                   jax_init_state(jax.tree.map(jnp.asarray, loop_tree), _train_cfg(jc).optim),
                   jl, log_interval=1, on_metrics=lambda n, m: logged["jax"].append(m["loss"]))
    tl = MusketeerDataLoader(default_vocab(), _specs(SubTaskSpec, tsvs, LOOP_TASKS), seed=3)
    params = trainable(from_jax(loop_tree, cfg_t, "cpu", torch.float32))
    state = train_loop(_train_cfg(tc, max_update=3), cfg_t,
                       init_train_state(params, _train_cfg(tc).optim), tl, log_interval=1,
                       on_metrics=lambda n, m: logged["torch"].append(m["loss"]))
    tl.close()
    assert state.step == 3 and len(logged["torch"]) == len(logged["jax"]) == 3
    gaps = [abs(a - b) / abs(b) for a, b in zip(logged["torch"], logged["jax"])]
    assert gaps[0] <= 1e-5 and max(gaps[1:]) <= 1e-4, gaps


def test_train_loop_resume_is_bit_identical(tsvs, loop_tree, tmp_path):
    """4 updates straight against 2, a save, and a resumed run to 4 (dropout
    on, so the per-update generator matters): bit-identical parameters. This
    needs ``one_thread``: on several threads the CPU step's scatter-adds (the
    backward of the embedding and rel-table gathers) sum in a thread-dependent
    order, so two identical runs differ in the last bits (the JAX package's
    XLA CPU step is deterministic)."""
    _, cfg_t = _loop_cfgs(dropout=0.1)

    def run(save_dir, max_update):
        tl = MusketeerDataLoader(default_vocab(), _specs(SubTaskSpec, tsvs, ["caption"]), seed=3)
        params = trainable(from_jax(loop_tree, cfg_t, "cpu", torch.float32))
        state = train_loop(_train_cfg(tc, max_update=max_update), cfg_t,
                           init_train_state(params, _train_cfg(tc).optim), tl,
                           save_dir=str(save_dir))
        tl.close()
        return state

    full = run(tmp_path / "full", 4)
    assert full.step == 4
    assert run(tmp_path / "part", 2).step == 2
    meta = json.loads((tmp_path / "part" / "checkpoint_last.meta.json").read_text())
    assert meta["steps_in_epoch"] == 2 and not meta["end_of_epoch"]
    resumed = run(tmp_path / "part", 4)
    assert resumed.step == 4 and resumed.opt_state["count"] == 4
    assert _equal(resumed.params, full.params)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tsvs, tmp_path_factory):
    """A seeded ofa_tiny tree written as a fairseq .pt, converted by ``cli
    convert``, and ``cli train`` for 2 updates with EMA into a save dir."""
    d = tmp_path_factory.mktemp("cli")
    cfg = tc.ofa_tiny()  # the preset, as the .pt's inferred config has it
    params = from_jax(init_ofa_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, "cpu",
                      torch.float32)
    export_pt(params, cfg, str(d / "tiny.pt"))
    cli.main(["convert", "--pt", str(d / "tiny.pt"), "--out", str(d / "converted"),
              "--device", "cpu"])
    tasks = ",".join(f"{n}={tsvs[n]}" for n in ("caption", "snli_ve"))
    state = cli.main(["train", "--tasks", tasks, "--arch", "ofa_tiny", "--device", "cpu",
                      "--patch-image-size", str(IMG), "--max-update", "2", "--ema-decay", "0.9",
                      "--save-dir", str(d / "run"), "--warmup-updates", "1"])
    return dict(dir=d, params=params, cfg=cfg, state=state)


def test_cli_convert_writes_the_checkpoint(cli_run):
    d = cli_run["dir"]
    state, meta = load_checkpoint(str(d), None, "converted", device="cpu")
    assert meta["arch_embed_dim"] == 256 and state.step == 0
    assert _equal(state.params, cli_run["params"])
    again, cfg = import_pt(str(d / "tiny.pt"), device="cpu")
    assert _equal(again, cli_run["params"]) and cfg == cli_run["cfg"]


def test_cli_train_takes_two_updates(cli_run):
    state = cli_run["state"]
    assert state.step == 2 and state.ema_params is not None
    saved, meta = load_checkpoint(str(cli_run["dir"] / "run"), device="cpu")
    assert saved.step == 2 and meta["num_updates"] == 2
    assert _equal(saved.params, state.params)
    assert all(torch.isfinite(p).all() for _, p in named_leaves(saved.params))


@pytest.mark.parametrize("source", ["ckpt_ema", "pt"])
def test_cli_evaluate(cli_run, tsvs, source, capsys):
    d = cli_run["dir"]
    src = (["--ckpt", str(d / "run" / "checkpoint_last"), "--use-ema"] if source == "ckpt_ema"
           else ["--pt", str(d / "tiny.pt")])
    out = cli.main(["evaluate", "--task", "caption", "--data", tsvs["caption"], "--device", "cpu",
                    "--arch", "ofa_tiny", "--patch-image-size", str(IMG), "--limit", "2",
                    "--max-len-b", "4", *src])
    assert out["task"] == "caption" and out["n"] == 2 and np.isfinite(out["cider"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_cli_evaluate_all(cli_run, tsvs):
    d = cli_run["dir"]
    tasks = f"caption={tsvs['caption']},snli_ve={tsvs['snli_ve']}"
    out = cli.main(["evaluate-all", "--tasks", tasks, "--pt", str(d / "tiny.pt"),
                    "--device", "cpu", "--patch-image-size", str(IMG), "--limit", "2"])
    assert set(out) == {"caption", "snli_ve"} and out["snli_ve"]["n"] == 2


def test_cli_fsdp_needs_ranks(tsvs, monkeypatch):
    """``--fsdp 2`` (and ``--model-parallel``, ``--pipeline``,
    ``--seq-parallel`` 2) in one process names torchrun; reward fine-tuning
    refuses a multi-rank launch."""
    for flag in ("--fsdp", "--model-parallel", "--pipeline", "--seq-parallel"):
        with pytest.raises(ValueError, match="torchrun"):
            cli.main(["train", "--tasks", f"caption={tsvs['caption']}", "--device", "cpu",
                      flag, "2"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="one rank"):
        cli.main(["train", "--criterion", "scst", "--tasks", f"caption={tsvs['caption']}",
                  "--device", "cpu"])


def test_cli_train_validates_on_two_ranks(tsvs, tmp_path):
    """``cli train --fsdp 2 --valid-data`` on two gloo ranks, validating after
    each update, against the one-rank run of the same flags: every rank
    validates the gathered parameters (none waits in a collective while
    another does), and the best metric and checkpoint_best's update are the
    one-rank run's."""
    from musketeer_tpu_torch.parallel.dryrun import run_cli_ranks

    tasks = ",".join(f"{n}={tsvs[n]}" for n in ("caption", "snli_ve"))
    argv = ["train", "--tasks", tasks, "--arch", "ofa_tiny", "--device", "cpu",
            "--patch-image-size", str(IMG), "--max-update", "2", "--warmup-updates", "1",
            "--valid-data", tsvs["snli_ve"], "--validate-interval-updates", "1"]
    cli.main(argv + ["--save-dir", str(tmp_path / "one")])
    run_cli_ranks(2, argv + ["--fsdp", "2", "--save-dir", str(tmp_path / "two")])
    metas = {}
    for run in ("one", "two"):
        meta = {}
        for name in ("checkpoint_last", "checkpoint_best"):
            with open(tmp_path / run / f"{name}.meta.json") as f:
                meta[name] = json.load(f)
        last, best = meta["checkpoint_last"], meta["checkpoint_best"]
        assert last["num_updates"] == 2 and best["val_metric"] is not None
        metas[run] = (last["best_val"], best["val_metric"], best["num_updates"])
        shutil.rmtree(tmp_path / run)  # ~0.5 GB of fp32 state a run
    assert metas["two"] == metas["one"]


def test_cli_refuses_a_missing_cuda_device(tsvs):
    """The default device is cuda; without one the CLI raises (no CPU fallback)."""
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["evaluate", "--task", "caption", "--data", tsvs["caption"]])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["vqgan-encode", "--vqgan", "x", "--data", "y", "--out", "z"])
