"""Boundaries of the PyTorch port: no jax, a complete parameter bridge, restated
host code equal to the JAX package's, and refusal of unported options."""

import dataclasses
import hashlib
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import musketeer_tpu.config as jax_config
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.models import positions as jax_positions
from musketeer_tpu_torch import config
from musketeer_tpu_torch.generation import beam_search
from musketeer_tpu_torch.generation.beam_search import use_fast_path
from musketeer_tpu_torch.models import ofa, positions
from musketeer_tpu_torch.params import check_supported, from_jax, init_ofa_params

REPO = Path(__file__).resolve().parent.parent


def _tiny_cfgs():
    cfg_j = dataclasses.replace(
        jax_config.ofa_tiny(), dtype="float32", use_flash_attention=True,
        encoder_layers=2, decoder_layers=2, resnet_layers=(2, 1, 2),
    )
    return cfg_j, config.ModelConfig(**dataclasses.asdict(cfg_j))


def test_port_imports_no_jax():
    """Every module of the port, and ``chip_smoke.py``, loads with jax, the JAX
    package and ``regex`` blocked, and the tokenizer runs (own process: the
    test harness has already imported jax here)."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "musketeer_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'musketeer_tpu', 'regex'): sys.modules[name] = None\n"
        f"for m in {modules + ['chip_smoke']!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "from musketeer_tpu_torch.tokenization import default_vocab\n"
        "assert default_vocab().encode_text(' a dog on a ½ beach²').tolist()\n"
        "from musketeer_tpu_torch.tasks.clip_tokenizer import tokenize\n"
        "assert tokenize(['a dog on a ½ beach²'])[0, 0] == 49406\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and (\n"
        "       m == 'jax' or m.startswith('jax.') or m == 'regex'\n"
        "       or m == 'musketeer_tpu' or m.startswith('musketeer_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert len(modules) >= 10
    assert {"musketeer_tpu_torch.ops.flash_attention_bwd", "musketeer_tpu_torch.training.train_step",
            "musketeer_tpu_torch.training.train_state", "musketeer_tpu_torch.training.lr_schedule",
            "musketeer_tpu_torch.criterions.label_smoothed_ce",
            "musketeer_tpu_torch.tokenization.bpe", "musketeer_tpu_torch.tokenization.dictionary",
            "musketeer_tpu_torch.data.transforms", "musketeer_tpu_torch.data.prompts",
            "musketeer_tpu_torch.data.task_data", "musketeer_tpu_torch.data.file_dataset",
            "musketeer_tpu_torch.utils.cider", "musketeer_tpu_torch.utils.summary_detok",
            "musketeer_tpu_torch.utils.eval_utils", "musketeer_tpu_torch.generation.trie",
            "musketeer_tpu_torch.generation.lexical", "musketeer_tpu_torch.tasks.base",
            "musketeer_tpu_torch.tasks.tasks", "musketeer_tpu_torch.cli",
            "musketeer_tpu_torch.convert.fairseq", "musketeer_tpu_torch.models.heads",
            "musketeer_tpu_torch.data.augment", "musketeer_tpu_torch.tasks.musketeer",
            "musketeer_tpu_torch.training.checkpoint", "musketeer_tpu_torch.training.trainer",
            "musketeer_tpu_torch.training.prefetch",
            "musketeer_tpu_torch.training.metrics", "musketeer_tpu_torch.data.detection",
            "musketeer_tpu_torch.data.pretrain", "musketeer_tpu_torch.tasks.detection",
            "musketeer_tpu_torch.tasks.pretrain", "musketeer_tpu_torch.models.clip",
            "musketeer_tpu_torch.models.vqgan", "musketeer_tpu_torch.tasks.clip_tokenizer",
            "musketeer_tpu_torch.tasks.image_gen", "musketeer_tpu_torch.criterions.scst",
            "musketeer_tpu_torch.criterions.clip_scst",
            "musketeer_tpu_torch.training.scst_loop", "musketeer_tpu_torch.native.__init__",
            "musketeer_tpu_torch.utils.flops", "musketeer_tpu_torch.parallel.mesh",
            "musketeer_tpu_torch.parallel.data_parallel", "musketeer_tpu_torch.parallel.dryrun",
            "musketeer_tpu_torch.parallel.tensor_parallel", "musketeer_tpu_torch.parallel.pipeline",
            "musketeer_tpu_torch.parallel.ring_attention",
            "musketeer_tpu_torch.examples.joint_training_demo"} <= set(modules)


@pytest.mark.parametrize("name", ["dict.txt", "encoder.json", "vocab.bpe"])
def test_bpe_assets_are_copies(name):
    """The port's BPE assets are byte for byte the JAX package's."""
    ours = (REPO / "musketeer_tpu_torch" / "assets" / "bpe" / name).read_bytes()
    theirs = (REPO / "musketeer_tpu" / "assets" / "bpe" / name).read_bytes()
    assert hashlib.sha256(ours).hexdigest() == hashlib.sha256(theirs).hexdigest()


def test_clip_bpe_asset_is_a_copy():
    """The port's CLIP vocabulary is byte for byte the JAX package's."""
    ours = (REPO / "musketeer_tpu_torch" / "assets" / "clip_bpe_vocab.txt.gz").read_bytes()
    theirs = (REPO / "musketeer_tpu" / "assets" / "clip_bpe_vocab.txt.gz").read_bytes()
    assert hashlib.sha256(ours).hexdigest() == hashlib.sha256(theirs).hexdigest()


def _default(f):
    """A field's default, a default factory's product as a dict."""
    if f.default_factory is not dataclasses.MISSING:
        return dataclasses.asdict(f.default_factory())
    return f.default


@pytest.mark.parametrize("cls", ["ModelConfig", "GenerationConfig", "OptimConfig",
                                 "CriterionConfig", "MeshConfig", "TrainConfig"])
def test_config_fields_match_jax(cls):
    ours = {f.name: _default(f) for f in dataclasses.fields(getattr(config, cls))}
    theirs = {f.name: _default(f) for f in dataclasses.fields(getattr(jax_config, cls))}
    assert ours == theirs


@pytest.mark.parametrize("module,cls", [("clip", "ClipConfig"), ("vqgan", "VQGANConfig")])
def test_clip_vqgan_configs_match_jax(module, cls):
    """The restated CLIP and VQGAN configs: field by field, default by default."""
    ours = getattr(importlib.import_module(f"musketeer_tpu_torch.models.{module}"), cls)
    theirs = getattr(importlib.import_module(f"musketeer_tpu.models.{module}"), cls)
    assert [(f.name, _default(f)) for f in dataclasses.fields(ours)] == [
        (f.name, _default(f)) for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


@pytest.mark.parametrize("preset", ["ofa_tiny", "ofa_medium", "ofa_base", "ofa_large",
                                    "ofa_huge"])
def test_config_presets_match_jax(preset):
    assert dataclasses.asdict(getattr(config, preset)()) == dataclasses.asdict(
        getattr(jax_config, preset)())
    assert dataclasses.asdict(config.ARCH_PRESETS[preset]()) == dataclasses.asdict(
        jax_config.ARCH_PRESETS[preset]())


def test_mesh_axis_sizes_match_jax():
    for kw, n in ((dict(), 8), (dict(fsdp=2, seq=2), 8), (dict(data=1), 1)):
        assert config.MeshConfig(**kw).axis_sizes(n) == jax_config.MeshConfig(**kw).axis_sizes(n)
    with pytest.raises(ValueError):
        config.MeshConfig(data=3).axis_sizes(8)


@pytest.mark.parametrize("fn,args", [
    ("make_token_bucket_position", (256, 1024)),
    ("make_token_bucket_position", (256, 17)),
    ("make_image_bucket_position", (42, (2 * 42 - 1) ** 2 + 3)),
    ("encoder_image_position_ids", (30, 30, 42)),
    ("decoder_image_position_idx", (128, 42, 1024)),
    ("decoder_image_position_idx", (256, 42)),
])
def test_position_tables_match_jax(fn, args):
    np.testing.assert_array_equal(getattr(positions, fn)(*args), getattr(jax_positions, fn)(*args))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {} if tree is None else {prefix: tuple(tree.shape)}


def test_init_params_tree_matches_jax():
    cfg_j, cfg_t = _tiny_cfgs()
    ref = _shapes(jax.eval_shape(lambda k: jofa.init_ofa_params(k, cfg_j), jax.random.PRNGKey(0)))
    tree = init_ofa_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(tree) == ref
    emb = tree["embed_tokens"]
    assert (emb[cfg_t.vocab_size:] == 0).all() and (emb[: cfg_t.vocab_size] != 0).any()
    assert abs(float(emb[: cfg_t.vocab_size].std()) - cfg_t.embed_dim ** -0.5) < 1e-3
    bound = np.sqrt(6.0 / (2 * cfg_t.embed_dim)) / np.sqrt(2.0)
    q_w = tree["encoder"]["layers"]["self_attn"]["q_proj"]["w"]
    assert float(q_w.abs().max()) <= bound and float(q_w.abs().max()) > 0.9 * bound
    assert not tree["encoder"]["token_rel_pos_table"].any()


def test_from_jax_consumes_every_leaf_once():
    cfg_j, cfg_t = _tiny_cfgs()
    tree = init_ofa_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    p = from_jax(tree, cfg_t, "cpu", torch.bfloat16)
    assert p["encoder"]["layers"][0]["fc1"]["w"].shape == (cfg_t.ffn_dim, cfg_t.embed_dim)
    assert p["encoder"]["layers"][1]["fc1"]["w"].dtype == torch.bfloat16
    assert p["decoder"]["self_pos_q_linear"]["w"].dtype == torch.float32
    assert p["embed_tokens"].dtype == torch.float32 and p["embed_tokens_c"].dtype == torch.bfloat16
    assert [len(p["encoder"]["resnet"][f"layer{i}"]) for i in (1, 2, 3)] == [2, 1, 2]
    assert p["encoder"]["resnet"]["conv1"].shape == (64, 3, 7, 7)

    extra = dict(tree, stray=torch.zeros(3))
    with pytest.raises(ValueError, match="stray"):
        from_jax(extra, cfg_t, "cpu", torch.float32)
    missing = dict(tree, decoder={k: v for k, v in tree["decoder"].items() if k != "pos_ln"})
    with pytest.raises(ValueError, match="decoder/pos_ln"):
        from_jax(missing, cfg_t, "cpu", torch.float32)


@pytest.mark.parametrize("option", [dict(activation_fn="relu")])
def test_unported_model_options_raise(option):
    cfg = dataclasses.replace(_tiny_cfgs()[1], **option)
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        ofa.encode({}, cfg, torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("option", [
    dict(encoder_prompt=True), dict(decoder_prompt=True), dict(interpolate_position=True),
    dict(use_adapter=True), dict(use_flash_attention=False), dict(remat=True),
    dict(seq_parallel=True), dict(pipeline_microbatches=2, pipeline_interleave=2),
])
def test_ported_model_options_pass_the_check(option):
    """The options the XLA branch carries are no longer refused (the
    parity tests in ``test_torch_port_xla_branch.py`` hold them to JAX), nor
    the pipe and seq axes' (``test_torch_port_pipeline.py``,
    ``test_torch_port_ring.py``)."""
    check_supported(dataclasses.replace(_tiny_cfgs()[1], **option))


SEARCH_OPTIONS = [
    (dict(sampling=True), {}), (dict(diverse_beam_groups=2), {}), (dict(unk_penalty=0.5), {}),
    (dict(constraint_range=(4, 10)), {}), ({}, dict(prefix_tokens=torch.zeros(1, 2))),
    ({}, dict(n_models=2)),
]


@pytest.mark.parametrize("gen,kw", SEARCH_OPTIONS)
def test_search_options_route_to_general_body(gen, kw):
    """These options take the general body (the JAX routing predicate); the
    default configuration takes the fast path."""
    cfg = _tiny_cfgs()[1]
    n = kw.get("n_models", 1)
    route = {k: v for k, v in kw.items() if k != "n_models"}
    assert not use_fast_path(config.GenerationConfig(**gen), cfg, n_models=n, **route)
    assert use_fast_path(config.GenerationConfig(), cfg)


@pytest.fixture(scope="module")
def tiny_params():
    cfg = _tiny_cfgs()[1]
    return from_jax(init_ofa_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, "cpu",
                    torch.float32)


@pytest.mark.parametrize("gen,kw", SEARCH_OPTIONS)
def test_unported_search_options_raise(tiny_params, gen, kw):
    """``gen_code`` used to raise whatever it was combined with (the decoder's
    code masks were not ported); it now runs with each option on code masks
    and keeps the specials out until the last step: every row's tokens are
    ids 4 and up, then eos. (``test_torch_port_image_gen.py`` holds its beam
    and sampling searches to JAX's.)"""
    cfg = _tiny_cfgs()[1]
    rs = np.random.RandomState(0)
    enc = ofa.EncoderOut(torch.from_numpy(rs.randn(1, 3, cfg.embed_dim).astype(np.float32)),
                         torch.zeros(1, 3, dtype=torch.bool),
                         torch.from_numpy(rs.randn(1, 3, cfg.embed_dim).astype(np.float32)))
    gen_cfg = config.GenerationConfig(**{"beam_size": 4, **gen}, gen_code=True, min_len=4)
    kw = dict(kw, prefix_tokens=torch.full((1, 2), 700)) if "prefix_tokens" in kw else kw
    n = kw.get("n_models", 1)
    toks, scores = beam_search([tiny_params] * n if n > 1 else tiny_params, cfg, gen_cfg,
                               [enc] * n if n > 1 else enc, max_len=4, code_masks_value=True,
                               rng=torch.Generator().manual_seed(0), **kw)
    assert tuple(toks.shape) == (1, 4, 5) and bool(torch.isfinite(scores).all())
    assert bool((toks[:, :, :4] >= 4).all()) and bool((toks[:, :, 4] == cfg.eos).all())
    if "constraint_range" in gen:
        assert bool((toks[:, :, :4] < 10).all())
    if "prefix_tokens" in kw:
        assert bool((toks[:, :, :2] == 700).all())
