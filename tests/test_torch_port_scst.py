"""The port's SCST and CLIP-SCST against the JAX package's: ``scst_loss``,
``compute_rewards``, ``clip_rewards``, one ``scst_train_step`` and one
``clip_scst_train_step`` (loss, token count, rewards and every gradient),
``scst_training`` over 2 updates (losses and the checkpoints it keeps), and
``cli train --criterion scst|clip_scst`` on the CPU.

``ofa_tiny`` cut to 2 + 2 layers in float32, one seeded tree in the JAX
layout for both packages (``tests/test_torch_port_search.py::numpy_tree``),
and the tiny CLIP and VQGAN of ``tests/test_torch_port_image_gen.py``. The
samples cannot match across the two PRNGs, so both sides get the same
sampled sequences (a fixed ``sample_fn``, or a task whose ``generate_codes``
returns fixed codes) and everything after the sampling is compared: the
CIDEr-D rewards exactly, the CLIP rewards, losses and gradients within 1e-5
of max|ref| (the gradients of the whole tree read from each side's first Adam
moment, (1 − b1)·g, with the clip off). JAX's CLIP-SCST step decodes on its
XLA branch (it passes code masks without ``code_masks_all``); the port's on
the flash branch, where every row is a code target.
"""

import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musketeer_tpu.criterions.scst as jscst_module
import musketeer_tpu_torch.criterions.scst as tscst_module
from musketeer_tpu import config as jc
from musketeer_tpu.config import ofa_tiny
from musketeer_tpu.criterions import clip_scst as jclip_scst
from musketeer_tpu.criterions import scst as jscst
from musketeer_tpu.data import CaptionBuilder as JaxCaptionBuilder
from musketeer_tpu.data import ImageGenBuilder as JaxImageGenBuilder
from musketeer_tpu.data import collate as jax_collate
from musketeer_tpu.models import clip as jclip
from musketeer_tpu.models import vqgan as jvq
from musketeer_tpu.tasks.image_gen import ImageGenTask as JaxImageGenTask
from musketeer_tpu.tokenization import default_vocab as jax_vocab
from musketeer_tpu.training import init_train_state as jax_init_state
from musketeer_tpu.training import make_optimizer as jax_make_optimizer
from musketeer_tpu.training.scst_loop import scst_training as jax_scst_training
from musketeer_tpu_torch import cli
from musketeer_tpu_torch.config import GenerationConfig, ModelConfig, OptimConfig
from musketeer_tpu_torch.criterions import clip_scst as tclip_scst
from musketeer_tpu_torch.criterions import scst as tscst
from musketeer_tpu_torch.data import CaptionBuilder, ImageGenBuilder, collate
from musketeer_tpu_torch.models import clip as tclip
from musketeer_tpu_torch.models import vqgan as tvq
from musketeer_tpu_torch.params import from_jax, trainable
from musketeer_tpu_torch.tasks.image_gen import ImageGenTask
from musketeer_tpu_torch.tokenization import default_vocab
from musketeer_tpu_torch.training import init_train_state, make_optimizer
from musketeer_tpu_torch.training.scst_loop import scst_training
from musketeer_tpu_torch.training.train_state import named_leaves
from tests.test_torch_port_image_gen import CAPTIONS, TINY_CLIP, _vqgan_sd, _png_b64
from tests.test_torch_port_normformer import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_port_search import numpy_tree
from tests.test_torch_port_train import _adam_state

REL_TOL = 1e-5
# the clip off, so that the first Adam moment is (1 − b1) · the gradient
OPTIM = dict(lr=1e-4, warmup_updates=1, total_updates=10, clip_norm=0.0)
B, K = 2, 3
HYPS = [["a man rides a horse", "a dog on the beach", "a man rides a horse on a beach"],
        ["two cats sleeping", "a red car", "two cats sleeping on a sofa"]]
REFS = ["a man rides a horse on the beach&&a person riding a horse",
        "two cats sleeping on a sofa&&cats asleep on a couch"]


def _rel(got, ref):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    return abs(got - float(ref)) / max(abs(float(ref)), 1e-12)


def _close(got, ref, tol=REL_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= tol * float(np.abs(ref).max())


@pytest.fixture(scope="module")
def pair():
    cfg_j = dataclasses.replace(ofa_tiny(), dtype="float32", use_flash_attention=True,
                                encoder_layers=2, decoder_layers=2, resnet_layers=(1, 1, 1))
    cfg_t = ModelConfig(**dataclasses.asdict(cfg_j))
    tree = numpy_tree(cfg_t, 0)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, tree=tree)


def _states(pair):
    optim_j, optim_t = jc.OptimConfig(**OPTIM), OptimConfig(**OPTIM)
    st_j = jax_init_state(jax.tree.map(jnp.asarray, pair["tree"]), optim_j)
    st_t = init_train_state(trainable(from_jax(pair["tree"], pair["cfg_t"], "cpu",
                                               torch.float32)), optim_t)
    return st_j, jax_make_optimizer(optim_j), st_t, make_optimizer(optim_t)


def _check_grads(pair, st_j, st_t):
    """Every gradient leaf of the port's step against JAX's, both read from the
    first Adam moment, within 1e-5 of the tree's largest |g|."""
    b1 = jc.OptimConfig().adam_b1
    mu_j = jax.tree.map(lambda m: np.asarray(m) / (1 - b1), _adam_state(st_j).mu)
    gj = named_leaves(from_jax(mu_j, pair["cfg_t"], "cpu", torch.float32))
    gt = [(p, m / (1 - b1)) for p, m in named_leaves(st_t.opt_state["mu"])]
    assert [p for p, _ in gt] == [p for p, _ in gj]
    scale = max(float(g.abs().max()) for _, g in gj)
    assert scale > 0
    for (path, a), (_, b) in zip(gt, gj):
        assert float((a - b).abs().max()) <= REL_TOL * scale, path
    return scale


def _sampled(vocab, T=12):
    """HYPS as sampled rows [B, K, T]: ids, eos, pad."""
    toks = np.full((B, K, T), vocab.pad, np.int32)
    for b in range(B):
        for k in range(K):
            ids = list(vocab.encode_text(" " + HYPS[b][k])) + [vocab.eos]
            toks[b, k, :len(ids)] = ids
    return toks


def test_scst_loss_matches_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(4, 6, 50).astype(np.float32) * 3
    targets = rs.randint(2, 50, (4, 6)).astype(np.int32)
    targets[1, 3:] = 1  # pad
    adv = rs.randn(4).astype(np.float32)
    (lj, nj), gj = jax.value_and_grad(lambda x: jscst.scst_loss(x, jnp.asarray(targets),
                                                                jnp.asarray(adv)), has_aux=True)(
        jnp.asarray(logits))
    lt_in = torch.from_numpy(logits).requires_grad_(True)
    lt, nt = tscst.scst_loss(lt_in, torch.from_numpy(targets), torch.from_numpy(adv))
    lt.backward()
    assert int(nt) == int(nj) == 21 and _rel(lt, lj) <= REL_TOL
    _close(lt_in.grad, gj)


def test_compute_rewards_match_jax():
    refs = [r.split("&&") for r in REFS]
    got, ref = tscst.compute_rewards(HYPS, refs), jscst.compute_rewards(HYPS, refs)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(ref.sum(axis=1), 0.0, atol=1e-4)
    assert ref[0, 2] > ref[0, 1] and ref[1, 2] > ref[1, 1]


def _caption_batches(vocab_j, vocab_t):
    rng = np.random.RandomState(1)
    rows = [[str(i), _png_b64(rng, 40), REFS[i]] for i in range(B)]
    kw = dict(description="base", split="train", scst=True, patch_image_size=32)
    bj, bt = JaxCaptionBuilder(vocab_j, **kw), CaptionBuilder(vocab_t, **kw)
    return (jax_collate([bj(r) for r in rows], pad_id=1),
            collate([bt(r) for r in rows], pad_id=1))


SCST_GEN = dict(beam_size=K, max_len_b=11, min_len=1, sampling=True)


@pytest.fixture(scope="module")
def jax_grad_fn(pair):
    """JAX's jitted SCST policy-gradient step, compiled once for the module."""
    tx = jax_make_optimizer(jc.OptimConfig(**OPTIM))
    return jscst.make_scst_fns(pair["cfg_j"], jc.GenerationConfig(**SCST_GEN), tx)[1]


def test_scst_train_step_matches_jax(pair, jax_grad_fn):
    """One SCST update on fixed samples: the mean advantage, the loss, the
    token count and every gradient."""
    vj, vt = jax_vocab(), default_vocab()
    toks = _sampled(vt)
    batch_j, batch_t = _caption_batches(vj, vt)
    st_j, _, st_t, tx_t = _states(pair)
    grad_j = jax_grad_fn
    _, grad_t = tscst.make_scst_fns(pair["cfg_t"], GenerationConfig(**SCST_GEN), tx_t)
    st_j, m_j = jscst.scst_train_step(st_j, vj, lambda *a: (jnp.asarray(toks), None), grad_j,
                                      batch_j, jax.random.PRNGKey(0), max_len=11)
    st_t, m_t = tscst.scst_train_step(st_t, vt, lambda *a: (torch.from_numpy(toks), None),
                                      grad_t, batch_t, torch.Generator().manual_seed(0),
                                      max_len=11)
    assert st_t.step == int(st_j.step) == 1
    assert m_t["mean_reward"] == m_j["mean_reward"]
    assert int(m_t["ntokens"]) == int(m_j["ntokens"]) == int((toks != 1).sum())
    assert _rel(m_t["scst_loss"], m_j["scst_loss"]) <= REL_TOL and float(m_j["scst_loss"]) != 0
    _check_grads(pair, st_j, st_t)


@pytest.fixture(scope="module")
def clip_vqgan():
    sd_c = tclip.init_clip_state_dict(TINY_CLIP, torch.Generator().manual_seed(0))
    sd_v = _vqgan_sd(12, codebook_size=8192)
    heads = dict(vision_heads=4, transformer_heads=4)
    pj, cj = jclip.convert_clip_state_dict(sd_c)
    pt, ct = tclip.convert_clip_state_dict(sd_c, device="cpu")
    vj, vcj = jvq.convert_vqgan_state_dict(sd_v)
    vt, vct = tvq.convert_vqgan_state_dict(sd_v, device="cpu")
    return dict(jax=dict(clip_params=pj, clip_cfg=dataclasses.replace(cj, **heads),
                         vqgan_params=vj, vqgan_cfg=vcj),
                torch=dict(clip_params=pt, clip_cfg=dataclasses.replace(ct, **heads),
                           vqgan_params=vt, vqgan_cfg=vct),
                sd_c=sd_c, sd_v=sd_v)


def test_clip_rewards_match_jax(clip_vqgan):
    imgs = np.random.RandomState(2).randint(0, 256, (B * K, 16, 16, 3)).astype(np.uint8)
    cj, ct = clip_vqgan["jax"], clip_vqgan["torch"]
    ref = jclip_scst.clip_rewards(imgs, CAPTIONS[:B], K, cj["clip_params"], cj["clip_cfg"])
    got = tclip_scst.clip_rewards(torch.from_numpy(imgs), CAPTIONS[:B], K, ct["clip_params"],
                                  ct["clip_cfg"])
    assert got.shape == (B, K) and got.dtype == np.float32
    _close(got, ref, REL_TOL)
    np.testing.assert_allclose(ref.sum(axis=1), 0.0, atol=1e-5)


def test_clip_scst_train_step_matches_jax(pair, clip_vqgan):
    """One CLIP-SCST update on fixed sampled codes (4 × 4): the rewards, the
    loss, the token count and every gradient."""
    vj, vt = jax_vocab(), default_vocab()
    codes = np.random.RandomState(3).randint(0, 8192, (B, K, 4, 4))
    task_j = JaxImageGenTask(vj, description="base", code_image_size=64, **clip_vqgan["jax"])
    task_t = ImageGenTask(vt, description="base", code_image_size=64, **clip_vqgan["torch"])
    task_j.sampling_times = task_t.sampling_times = K
    task_j.generate_codes = lambda *a, **kw: (jnp.asarray(codes), None)
    task_t.generate_codes = lambda *a, **kw: (torch.from_numpy(codes), None)
    rows = [[str(i), CAPTIONS[i], "0 1 2"] for i in range(B)]
    batch_j = jax_collate([JaxImageGenBuilder(vj, description="base")(r) for r in rows], pad_id=1)
    batch_t = collate([ImageGenBuilder(vt, description="base")(r) for r in rows], pad_id=1)
    st_j, tx_j, st_t, tx_t = _states(pair)
    _, grad_j = jscst.make_scst_fns(pair["cfg_j"], task_j.generation_config(), tx_j, gen_code=True)
    _, grad_t = tscst.make_scst_fns(pair["cfg_t"], task_t.generation_config(), tx_t, gen_code=True)
    st_j, m_j = jclip_scst.clip_scst_train_step(st_j, vj, task_j, grad_j, batch_j, pair["cfg_j"],
                                                jax.random.PRNGKey(0))
    st_t, m_t = tclip_scst.clip_scst_train_step(st_t, vt, task_t, grad_t, batch_t, pair["cfg_t"],
                                                torch.Generator().manual_seed(0))
    assert int(m_t["ntokens"]) == int(m_j["ntokens"]) == B * K * 17
    assert abs(m_t["mean_clip_reward"] - m_j["mean_clip_reward"]) <= 1e-6
    assert _rel(m_t["scst_loss"], m_j["scst_loss"]) <= REL_TOL and float(m_j["scst_loss"]) != 0
    _check_grads(pair, st_j, st_t)


def _fixed_sampling(module, toks, losses, to_array, grad_fn=None):
    """``module.make_scst_fns`` with the sampling replaced by fixed rows, and
    each update's loss recorded (``grad_fn``: a policy-gradient step built
    already, with the same configuration)."""
    make = module.make_scst_fns

    def patched(*a, **kw):
        step = grad_fn or make(*a, **kw)[1]

        def recorded(*args):
            state, m = step(*args)
            losses.append(float(m["scst_loss"]))
            return state, m
        return (lambda *args: (to_array(toks), None)), recorded
    return mock.patch.object(module, "make_scst_fns", patched)


def test_scst_training_matches_jax(pair, jax_grad_fn, tmp_path):
    """``scst_training`` over 2 epochs of one update each (2 rows, batch 2,
    fixed samples): the same losses, and the same checkpoints kept on
    ``mean_reward``, with the same metadata."""
    vt = default_vocab()
    rng = np.random.RandomState(4)
    path = tmp_path / "cap.tsv"
    path.write_text("".join(f"{i}\t{_png_b64(rng, 40)}\t{REFS[i]}\n" for i in range(B)))
    toks = _sampled(vt)
    kw = dict(criterion="scst", batch_size=B, sample_beams=K, max_len_b=11, max_epoch=2,
              description="base", patch_image_size=32, seed=7)
    losses_j, losses_t = [], []
    with _fixed_sampling(jscst_module, toks, losses_j, jnp.asarray, jax_grad_fn):
        st_j = jax_scst_training(jax_vocab(), pair["cfg_j"], jax.tree.map(jnp.asarray, pair["tree"]),
                                 str(path), optim=jc.OptimConfig(**OPTIM),
                                 save_dir=str(tmp_path / "jax"), **kw)
    with _fixed_sampling(tscst_module, toks, losses_t, torch.from_numpy):
        st_t = scst_training(vt, pair["cfg_t"],
                             trainable(from_jax(pair["tree"], pair["cfg_t"], "cpu", torch.float32)),
                             str(path), optim=OptimConfig(**OPTIM),
                             save_dir=str(tmp_path / "torch"), **kw)
    assert st_t.step == int(st_j.step) == 2 and len(losses_t) == len(losses_j) == 2
    for a, b in zip(losses_t, losses_j):
        assert _rel(a, b) <= REL_TOL
    names = lambda d: sorted(p.name for p in d.iterdir() if p.name.endswith(".meta.json"))
    assert names(tmp_path / "torch") == names(tmp_path / "jax") == [
        f"{n}.meta.json" for n in ("checkpoint1", "checkpoint2", "checkpoint_best",
                                   "checkpoint_last")]
    keys = ("epoch", "num_updates", "val_metric", "end_of_epoch", "best_val")
    for n in names(tmp_path / "jax"):
        mj = json.loads((tmp_path / "jax" / n).read_text())
        mt = json.loads((tmp_path / "torch" / n).read_text())
        assert {k: mt[k] for k in keys} == {k: mj[k] for k in keys}, n


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------

CLI = ["--arch", "ofa_tiny", "--device", "cpu", "--batch-size", "2", "--max-update", "2",
       "--scst-sample-beams", "2", "--description", "base", "--warmup-updates", "1"]


def test_cli_train_scst(tmp_path, caplog):
    """``cli train --criterion scst``: 2 updates with a save, finite moved
    parameters, and the JAX CLI's warning on a flag it ignores."""
    rng = np.random.RandomState(5)
    path = tmp_path / "cap.tsv"
    path.write_text("".join(f"{i}\t{_png_b64(rng, 40)}\t{REFS[i % 2]}\n" for i in range(4)))
    with caplog.at_level("WARNING"):
        state = cli.main(["train", "--criterion", "scst", "--tasks", f"caption={path}",
                          "--patch-image-size", "32", "--scst-max-len-b", "4",
                          "--save-dir", str(tmp_path / "run"), "--update-freq", "2", *CLI])
    assert "ignores --update-freq" in caplog.text
    assert state.step == 2 and state.opt_state["count"] == 2
    assert all(torch.isfinite(p).all() for _, p in named_leaves(state.params))
    assert (tmp_path / "run" / "checkpoint_best").is_file()


def test_cli_train_clip_scst(tmp_path, clip_vqgan):
    """``cli train --criterion clip_scst`` from CLIP and VQGAN ``.pt`` files in
    the upstream layouts (the preset's code grid: 128 // 16 = 8 a side); it
    refuses to run without them, as the JAX CLI asserts."""
    # widths of 128: the converter gives 2 heads a tower (width // 64)
    clip_cfg = dataclasses.replace(TINY_CLIP, vision_width=128, transformer_width=128)
    torch.save(tclip.init_clip_state_dict(clip_cfg, torch.Generator().manual_seed(1)),
               tmp_path / "clip.pt")
    torch.save({"state_dict": clip_vqgan["sd_v"]}, tmp_path / "vqgan.ckpt")
    rng = np.random.RandomState(6)
    path = tmp_path / "gen.tsv"
    path.write_text("".join(
        f"{i}\t{CAPTIONS[i]}\t{' '.join(map(str, rng.randint(0, 8192, 64)))}\n" for i in range(4)))
    args = ["train", "--criterion", "clip_scst", "--tasks", f"image_gen={path}", *CLI]
    with pytest.raises(ValueError, match="--clip-pt and --vqgan-pt"):
        cli.main(args)
    state = cli.main(args + ["--clip-pt", str(tmp_path / "clip.pt"),
                             "--vqgan-pt", str(tmp_path / "vqgan.ckpt")])
    assert state.step == 2
    assert all(torch.isfinite(p).all() for _, p in named_leaves(state.params))
