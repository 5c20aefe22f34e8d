"""The port's fairseq checkpoint I/O and heads against the JAX package's, on
``ofa_tiny`` cut to 2 + 2 layers and ResNet (1, 1, 1) with all four
NormFormer options on (their leaves drawn away from the init's ones and
zeros), random rel-pos tables and BN statistics.

The fairseq ``.pt`` is the interchange format between the packages: the JAX
``export_state_dict`` of the tree, converted by the port, equals ``from_jax``
of the tree bit for bit (in fp32 and in bf16); the port's
``export_state_dict``, converted by JAX's ``convert_state_dict``, equals the
tree bit for bit; ``infer_config`` agrees, ``use_flash_attention`` too; the
files go both ways; the port's round trip is
the identity. The heads match JAX's to 1e-5 of max|ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu.convert import torch_to_jax as jconv
from musketeer_tpu.models import heads as jheads
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.training.checkpoint import export_pt as jax_export_pt
from musketeer_tpu.training.checkpoint import import_pt as jax_import_pt
from musketeer_tpu_torch.convert import (
    convert_state_dict, export_state_dict, infer_config, load_checkpoint,
)
from musketeer_tpu_torch.models import heads
from musketeer_tpu_torch.params import from_jax
from musketeer_tpu_torch.training.checkpoint import export_pt, import_pt
from tests.test_torch_port_model import _randomize
from tests.test_torch_port_normformer import normformer_cfgs, one_thread  # noqa: F401
from tests.test_torch_port_normformer import perturb_normformer

REL_TOL = 1e-5


@pytest.fixture(scope="module")
def tree():
    cfg_j, cfg_t = normformer_cfgs()
    params = jax.jit(jofa.init_ofa_params, static_argnums=1)(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(7)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t,
                np=perturb_normformer(_randomize(jax.tree.map(np.array, params), rng), rng))


def _leaves(t, prefix=""):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k], f"{prefix}/{k}")]
    if isinstance(t, list):
        return [x for i, v in enumerate(t) for x in _leaves(v, f"{prefix}/{i}")]
    return [] if t is None else [(prefix, t)]


def assert_trees_equal(a, b):
    """Same paths, dtypes and values, bit for bit."""
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=path)


def _cfg_dict(cfg, **kw):
    return dataclasses.asdict(dataclasses.replace(cfg, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_converts_the_jax_export_bit_for_bit(tree, dtype):
    sd = jconv.export_state_dict(tree["np"], tree["cfg_j"])
    params, cfg = convert_state_dict(sd, device="cpu", dtype=dtype)
    assert all(getattr(cfg, o) for o in ("scale_attn", "scale_fc", "scale_heads", "scale_resids"))
    assert_trees_equal(params, from_jax(tree["np"], tree["cfg_t"], "cpu", dtype))


def test_jax_converts_the_port_export_bit_for_bit(tree):
    sd = export_state_dict(from_jax(tree["np"], tree["cfg_t"], "cpu", torch.float32),
                           tree["cfg_t"])
    back, _ = jconv.convert_state_dict(sd)
    assert_trees_equal(back, tree["np"])


@pytest.mark.parametrize("prefix", ["", "module."])
def test_infer_config_matches_jax(tree, prefix):
    sd = jconv.export_state_dict(tree["np"], tree["cfg_j"])
    ref = jconv.infer_config(sd)
    assert dataclasses.asdict(infer_config(sd)) == dataclasses.asdict(ref)
    assert ref.scale_attn and ref.scale_heads
    # a module. prefix converts as JAX converts it
    params, cfg = convert_state_dict({prefix + k: v for k, v in sd.items()}, device="cpu")
    assert_trees_equal(params, from_jax(tree["np"], tree["cfg_t"], "cpu", torch.float32))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


def test_pt_files_both_ways(tree, tmp_path):
    jax_export_pt(tree["np"], tree["cfg_j"], str(tmp_path / "from_jax.pt"))
    params, cfg = import_pt(str(tmp_path / "from_jax.pt"), device="cpu")
    assert_trees_equal(params, from_jax(tree["np"], tree["cfg_t"], "cpu", torch.float32))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_import_pt(str(tmp_path / "from_jax.pt"))[1])
    export_pt(params, cfg, str(tmp_path / "from_port.pt"))
    back, _ = jax_import_pt(str(tmp_path / "from_port.pt"))
    assert_trees_equal(back, tree["np"])
    # load_checkpoint reads a bare state dict as well as {"model": ...}
    torch.save(export_state_dict(params, cfg), tmp_path / "bare.pt")
    assert_trees_equal(load_checkpoint(str(tmp_path / "bare.pt"), device="cpu")[0], params)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_round_trip_is_the_identity(tree, dtype):
    params = from_jax(tree["np"], tree["cfg_t"], "cpu", dtype)
    back, cfg = convert_state_dict(export_state_dict(params, tree["cfg_t"]), device="cpu",
                                   dtype=dtype)
    assert_trees_equal(back, params)
    assert dataclasses.asdict(cfg) == _cfg_dict(tree["cfg_t"], dtype="bfloat16",
                                                use_flash_attention=False)


def _rel_err(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("pooler", ["mlp", "linear"])
def test_classification_head_matches_jax(tree, pooler):
    cfg_j, cfg_t = tree["cfg_j"], tree["cfg_t"]
    head_j = jheads.init_classification_head(jax.random.PRNGKey(3), cfg_j, 5,
                                             pooler_classifier=pooler)
    head_t = {k: v if isinstance(v, str) else
              {"w": torch.from_numpy(np.array(v["w"]).T.copy()),
               "b": torch.from_numpy(np.array(v["b"]))}
              for k, v in head_j.items()}
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 6, cfg_j.embed_dim).astype(np.float32)
    prev = rng.randint(4, 100, (3, 6)).astype(np.int32)
    prev[0, 4:] = cfg_j.pad
    prev[1, 1:] = cfg_j.pad
    ref = jheads.classification_forward(head_j, cfg_j, jnp.asarray(feats), jnp.asarray(prev))
    out = heads.classification_forward(head_t, cfg_t, torch.from_numpy(feats),
                                       torch.from_numpy(prev).long())
    assert _rel_err(out.numpy(), ref) <= REL_TOL
    # the port's own init: JAX's shapes, xavier-uniform bounds
    own = heads.init_classification_head(cfg_t, 5, torch.Generator().manual_seed(0),
                                         pooler_classifier=pooler)
    assert {k: tuple(v["w"].shape) for k, v in own.items() if k != "pooler_classifier"} == \
        {k: tuple(np.array(v["w"]).T.shape) for k, v in head_j.items() if k != "pooler_classifier"}


@pytest.mark.parametrize("rows", ["answers", "random"])
def test_grow_vocab_matches_jax(tree, rows):
    cfg_j, cfg_t = tree["cfg_j"], tree["cfg_t"]
    ids = [[10, 20], [30], [40, 50, 60]] if rows == "answers" else None
    ref = jheads.grow_vocab(tree["np"], cfg_j, 3, answer_token_ids=ids)["embed_tokens"]
    params = from_jax(tree["np"], cfg_t, "cpu", torch.bfloat16)
    grown = heads.grow_vocab(params, cfg_t, 3, answer_token_ids=ids)
    assert tuple(grown["embed_tokens"].shape) == ref.shape == (59520, cfg_t.embed_dim)
    assert _rel_err(grown["embed_tokens"].numpy(), ref) <= REL_TOL
    assert torch.equal(grown["embed_tokens_c"], grown["embed_tokens"].to(torch.bfloat16))
