"""The port's image-generation path against the JAX package's: the CLIP
tokenizer, CLIP (ViT and ModifiedResNet towers, text tower, scores), VQGAN
(decode, encode, the first-stage training losses and gradients, both
converters), ``ImageGenBuilder`` with ``collate``, the ``gen_code`` search
(beam and top-1 sampling) and ``ImageGenTask.evaluate`` with CLIP and VQGAN.

CLIP and VQGAN run at the tiny widths of ``tests/test_clip_vqgan.py`` (CLIP:
d 64, 2 layers, patch 8 at 32², text d 48; VQGAN: ch 32, z 64, a codebook of
50, two levels), both packages converting one seeded torch state dict in the
upstream layout; ``clip_vqgan_from_jax`` must give the port's converter's
tree bit for bit. The OFA side is ``ofa_tiny`` cut to 2 + 2 layers in
float32, one seeded tree in the JAX layout given to both packages (the JAX
attention in Pallas interpret mode, the port's plain K1). Values are held to
1e-5 of max|ref|; tokens, codes and token accuracies exactly.
"""

import base64
import dataclasses
import io
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from musketeer_tpu.config import GenerationConfig as JaxGenerationConfig
from musketeer_tpu.config import ofa_tiny
from musketeer_tpu.data import FileDataset as JaxFileDataset
from musketeer_tpu.data import ImageGenBuilder as JaxImageGenBuilder
from musketeer_tpu.data import collate as jax_collate
from musketeer_tpu.generation import beam_search as jax_beam_search
from musketeer_tpu.models import clip as jclip
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.models import vqgan as jvq
from musketeer_tpu.tasks.clip_tokenizer import tokenize as jax_tokenize
from musketeer_tpu.tasks.image_gen import ImageGenTask as JaxImageGenTask
from musketeer_tpu.tokenization import default_vocab as jax_vocab
from musketeer_tpu_torch.config import GenerationConfig, ModelConfig
from musketeer_tpu_torch.data import FileDataset, ImageGenBuilder, collate
from musketeer_tpu_torch.generation import beam_search
from musketeer_tpu_torch.models import clip as tclip
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.models import vqgan as tvq
from musketeer_tpu_torch.params import clip_vqgan_from_jax, from_jax
from musketeer_tpu_torch.tasks.clip_tokenizer import clip_pattern
from musketeer_tpu_torch.tasks.clip_tokenizer import tokenize as torch_tokenize
from musketeer_tpu_torch.tasks.image_gen import ImageGenTask
from musketeer_tpu_torch.tokenization import default_vocab
from tests.test_torch_port_search import numpy_tree
from tests.test_torch_port_normformer import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_port_tasks import row_dependent

REL_TOL = 1e-5
TINY_CLIP = tclip.ClipConfig(image_resolution=32, patch_size=8, vision_width=64, vision_layers=2,
                             vision_heads=4, embed_dim=32, context_length=16, vocab_size=49408,
                             transformer_width=48, transformer_layers=2, transformer_heads=4)
TINY_VQGAN = tvq.VQGANConfig(codebook_size=50, embed_dim=64, z_channels=64, ch=32, ch_mult=(1, 2),
                             num_res_blocks=1, attn_resolutions=(8,), resolution=16)
CODE_IMAGE = 64  # ImageGenTask's code_image_size: a 4 x 4 code grid, 16 codes


def _close(got, ref, tol=REL_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, f"max err {err:.3e} > {tol} * {scale:.3e}"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_same_tree(a, b):
    a, b = dict(_flat(a)), dict(_flat(b))
    assert a.keys() == b.keys(), sorted(a.keys() ^ b.keys())
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].stride() == b[k].stride(), k
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the CLIP tokenizer
# ---------------------------------------------------------------------------

TEXTS = {
    "accents": ["Crème brûlée à la façon d'Éloïse, naïve café", "ÀÉÎÕÜ çà ñ ß ſt"],
    "non_latin": ["Кошка сидит на окне", "一只猫坐在窗台上", "القطة تجلس", "γάτα ͅ ᾳ"],
    "digits": ["2 dogs and 13 cats in 1999, ½ ² ٣", "room 101 &amp; 42nd street"],
    "contractions": ["it's the dog's ball, they're here, we've I'm you'll he'd DON'T",
                     "'S 'T 'ſ rock'n'roll"],
    "over_long": [" ".join(["a red bicycle leaning against the old stone wall"] * 12)],
}


@pytest.mark.parametrize("case", list(TEXTS))
def test_clip_tokenizer_matches_jax(case):
    """Ids of the port's ``re`` pattern equal the JAX tokenizer's (``regex``),
    the over-long text cut at ``context_length`` with eot last."""
    for ctx in (77, 16):
        got, ref = torch_tokenize(TEXTS[case], ctx), jax_tokenize(TEXTS[case], ctx)
        np.testing.assert_array_equal(got, ref)
    if case == "over_long":
        assert ref[0, -1] == 49407 and (ref[0] != 0).all()


def test_clip_pattern_matches_regex_on_every_code_point():
    """The split of each code point that Python's ``unicodedata`` assigns,
    alone and beside a letter, a digit and an apostrophe, equals ``regex``'s
    under the JAX package's pattern and flags."""
    import sys
    import unicodedata

    import regex

    ref = regex.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+"
                        r"|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)
    ours = clip_pattern()
    bad = []
    for cp in range(sys.maxunicode + 1):
        c = chr(cp)
        if 0xD800 <= cp <= 0xDFFF or unicodedata.category(c) == "Cn":
            continue
        for s in (c, f"a{c}1", f"'{c}"):
            if ours.findall(s) != ref.findall(s):
                bad.append(hex(cp))
                break
    assert not bad, bad[:20]


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------

def _rn_state_dict(g: torch.Generator, width=8, layers=(1, 1, 2, 1), res=64, out_dim=16):
    """A seeded OpenAI ModifiedResNet CLIP state dict (the tower of
    ``tests/test_clip_vqgan.py``), with non-trivial BatchNorm statistics."""
    text_cfg = dataclasses.replace(TINY_CLIP, embed_dim=out_dim)
    sd = {k: v for k, v in tclip.init_clip_state_dict(text_cfg, g).items()
          if not k.startswith("visual.")}
    rnd = lambda *shape: torch.randn(*shape, generator=g) * 0.2

    def conv(name, cin, cout, k):
        sd[f"{name}.weight"] = rnd(cout, cin, k, k) * (cin * k * k) ** -0.5 * 5

    def bn(name, c):
        sd[f"{name}.weight"] = 1 + rnd(c)
        sd[f"{name}.bias"] = rnd(c)
        sd[f"{name}.running_mean"] = rnd(c)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(3)

    conv("visual.conv1", 3, width // 2, 3), bn("visual.bn1", width // 2)
    conv("visual.conv2", width // 2, width // 2, 3), bn("visual.bn2", width // 2)
    conv("visual.conv3", width // 2, width, 3), bn("visual.bn3", width)
    inp = width
    for li, n in enumerate(layers, start=1):
        planes = width * 2 ** (li - 1)
        for bi in range(n):
            pre = f"visual.layer{li}.{bi}"
            conv(f"{pre}.conv1", inp, planes, 1), bn(f"{pre}.bn1", planes)
            conv(f"{pre}.conv2", planes, planes, 3), bn(f"{pre}.bn2", planes)
            conv(f"{pre}.conv3", planes, planes * 4, 1), bn(f"{pre}.bn3", planes * 4)
            if bi == 0:
                conv(f"{pre}.downsample.0", inp, planes * 4, 1)
                bn(f"{pre}.downsample.1", planes * 4)
            inp = planes * 4
    ap, dim = "visual.attnpool", width * 32
    sd[f"{ap}.positional_embedding"] = rnd((res // 32) ** 2 + 1, dim)
    for n in ("q", "k", "v"):
        sd[f"{ap}.{n}_proj.weight"], sd[f"{ap}.{n}_proj.bias"] = rnd(dim, dim) * 0.2, rnd(dim)
    sd[f"{ap}.c_proj.weight"], sd[f"{ap}.c_proj.bias"] = rnd(out_dim, dim) * 0.2, rnd(out_dim)
    return sd


def _clip_pair(sd):
    pj, cj = jclip.convert_clip_state_dict(sd)
    pt, ct = tclip.convert_clip_state_dict(sd, device="cpu")
    heads = dict(transformer_heads=TINY_CLIP.transformer_heads)
    if ct.rn_layers is None:
        heads["vision_heads"] = TINY_CLIP.vision_heads
    cj, ct = dataclasses.replace(cj, **heads), dataclasses.replace(ct, **heads)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    _assert_same_tree(clip_vqgan_from_jax(pj, "cpu"), pt)
    return pj, cj, pt, ct


@pytest.fixture(scope="module")
def clip_vit():
    return _clip_pair(tclip.init_clip_state_dict(TINY_CLIP, torch.Generator().manual_seed(0)))


def test_clip_vit_towers_and_scores_match_jax(clip_vit):
    pj, cj, pt, ct = clip_vit
    rng = np.random.RandomState(0)
    im = rng.randn(2, 32, 32, 3).astype(np.float32)
    toks = rng.randint(1, 98, (3, 16))
    toks[:, -1] = 99
    toks[1, 5:] = 0  # eot in the middle: argmax picks it, the causal mask hides the rest
    toks[1, 4] = 99
    _close(tclip.encode_image(pt, ct, torch.from_numpy(im)),
           jclip.encode_image(pj, cj, jnp.asarray(im)))
    _close(tclip.encode_text(pt, ct, torch.from_numpy(toks)),
           jclip.encode_text(pj, cj, jnp.asarray(toks)))
    _close(tclip.clip_scores(pt, ct, torch.from_numpy(im), torch.from_numpy(toks)),
           jclip.clip_scores(pj, cj, jnp.asarray(im), jnp.asarray(toks)))


def test_clip_modified_resnet_tower_matches_jax():
    pj, cj, pt, ct = _clip_pair(_rn_state_dict(torch.Generator().manual_seed(1)))
    assert ct.rn_layers == (1, 1, 2, 1) and ct.image_resolution == 64
    im = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    _close(tclip.encode_image(pt, ct, torch.from_numpy(im)),
           jclip.encode_image(pj, cj, jnp.asarray(im)))


# ---------------------------------------------------------------------------
# VQGAN
# ---------------------------------------------------------------------------

def _vqgan_sd(seed: int, gumbel: bool = False, codebook_size: int = 50):
    """A seeded taming state dict at ``TINY_VQGAN`` whose codebook is drawn
    from the encoder's own latents (so that images map to many codes); with
    ``codebook_size`` 8192 (the vocabulary's code band), seeded normal."""
    g = torch.Generator().manual_seed(seed)
    cfg = dataclasses.replace(TINY_VQGAN, codebook_size=codebook_size)
    sd = tvq.init_vqgan_state_dict(cfg, g, gumbel=gumbel)
    if codebook_size != 50:
        sd["quantize.embedding.weight"] = torch.randn(codebook_size, 64, generator=g)
    elif not gumbel:
        params, _ = tvq.convert_vqgan_state_dict(sd, device="cpu")
        imgs = torch.rand(4, 16, 16, 3, generator=g) * 2 - 1
        with torch.no_grad():
            h = tvq._encoder_features(params, imgs.permute(0, 3, 1, 2))
            z = tvq._conv(params["quant_conv"], h).permute(0, 2, 3, 1).reshape(-1, 64)
        sd["quantize.embedding.weight"] = z[torch.randperm(len(z), generator=g)[:50]].clone()
    return sd


@pytest.fixture(scope="module")
def vqgan():
    sd = _vqgan_sd(1)
    vj, cj = jvq.convert_vqgan_state_dict(sd)
    vt, ct = tvq.convert_vqgan_state_dict(sd, device="cpu")
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    _assert_same_tree(clip_vqgan_from_jax(vj, "cpu"), vt)
    return vj, cj, vt, ct


def test_vqgan_decode_matches_jax(vqgan):
    vj, cj, vt, ct = vqgan
    codes = np.random.RandomState(2).randint(0, 50, (2, 4, 4))
    ref = jvq.decode_code(vj, cj, jnp.asarray(codes))
    _close(tvq.decode_code(vt, ct, torch.from_numpy(codes)), ref)
    u8 = tvq.codes_to_images_uint8(vt, ct, torch.from_numpy(codes)).numpy().astype(int)
    u8_ref = np.asarray(jvq.codes_to_images_uint8(vj, cj, jnp.asarray(codes))).astype(int)
    assert u8.shape == (2, 8, 8, 3) and np.abs(u8 - u8_ref).max() <= 1


@pytest.mark.parametrize("gumbel", [False, True])
def test_vqgan_encode_codes_match_jax(vqgan, gumbel):
    if gumbel:
        sd = _vqgan_sd(3, gumbel=True)
        vj, cj = jvq.convert_vqgan_state_dict(sd, gumbel=True)
        vt, ct = tvq.convert_vqgan_state_dict(sd, gumbel=True, device="cpu")
        _assert_same_tree(clip_vqgan_from_jax(vj, "cpu"), vt)
        assert "gumbel_proj" in vt and "quant_conv" not in vt
    else:
        vj, cj, vt, ct = vqgan
    imgs = np.clip(np.random.RandomState(4).randn(3, 16, 16, 3), -1, 1).astype(np.float32)
    ref = np.asarray(jvq.encode_codes(vj, cj, jnp.asarray(imgs)))
    got = tvq.encode_codes(vt, ct, torch.from_numpy(imgs)).numpy()
    assert got.shape == (3, 8, 8)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(ref)) >= 8  # the codes are not one constant


def test_vqgan_quantize_train_matches_jax(vqgan):
    """Straight-through codes, loss and the gradients to z and the codebook."""
    vj, _, vt, _ = vqgan
    z = np.random.RandomState(5).randn(2, 4, 4, 64).astype(np.float32) * 0.5
    emb = np.asarray(vj["codebook"])

    def total_j(z, e):
        z_q, codes, q_loss = jvq.quantize_train({"codebook": e}, z, beta=0.25)
        return 1.3 * jnp.sum(z_q) + q_loss, (codes, q_loss)

    (tot_j, (codes_j, q_j)), (gz_j, ge_j) = jax.value_and_grad(
        total_j, argnums=(0, 1), has_aux=True)(jnp.asarray(z), jnp.asarray(emb))
    zt = torch.from_numpy(z).requires_grad_(True)
    et = torch.from_numpy(emb.copy()).requires_grad_(True)
    z_q, codes_t, q_t = tvq.quantize_train({"codebook": et}, zt, beta=0.25)
    tot_t = 1.3 * z_q.sum() + q_t
    tot_t.backward()
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    assert len(np.unique(np.asarray(codes_j))) >= 4
    _close(q_t, q_j)
    _close(tot_t, tot_j)
    _close(zt.grad, gz_j)
    _close(et.grad, ge_j)


def test_vqgan_autoencode_train_matches_jax(vqgan):
    """encode → quantize → decode: the losses, codes and every gradient leaf
    (each within 1e-5 of the tree's largest |g|)."""
    vj, cj, vt, ct = vqgan
    imgs = (np.random.RandomState(6).rand(2, 16, 16, 3) * 2 - 1).astype(np.float32)

    def loss_j(p):
        recon, codes, losses = jvq.autoencode_train(p, cj, jnp.asarray(imgs))
        return losses["loss"], (recon, codes, losses)

    (lj, (recon_j, codes_j, losses_j)), grads_j = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(jax.tree.map(jnp.asarray, vj))
    params = {k: v for k, v in _flat(vt)}
    for t in params.values():
        t.requires_grad_(True)
    recon, codes, losses = tvq.autoencode_train(vt, ct, torch.from_numpy(imgs))
    losses["loss"].backward()
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    _close(recon, recon_j)
    for k in ("loss", "rec_loss", "q_loss"):
        _close(losses[k], losses_j[k])
    gj = dict(_flat(clip_vqgan_from_jax(jax.tree.map(np.asarray, grads_j), "cpu")))
    scale = max(float(g.abs().max()) for g in gj.values())
    assert gj.keys() == params.keys()
    for k, p in params.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert float((got - gj[k]).abs().max()) <= REL_TOL * scale, k
    for part in ("/encoder/conv_in/w", "/codebook", "/up/1/blocks/0/conv1/w", "/quant_conv/w"):
        assert float(gj[part].abs().max()) > 0, part


# ---------------------------------------------------------------------------
# ImageGenBuilder, the gen_code search, ImageGenTask
# ---------------------------------------------------------------------------

CAPTIONS = ["a small red cube on a table", "Two dogs run on the beach!", "a blue car",
            "an old stone bridge over a river"]


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    rng = np.random.RandomState(3)
    path = tmp_path_factory.mktemp("image_gen") / "gen.tsv"
    lines = [f"{i}\t{cap}\t{' '.join(str(c) for c in rng.randint(0, 8192, 16))}"
             for i, cap in enumerate(CAPTIONS)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_image_gen_builder_and_collate_match_jax(rows):
    ds_j, ds_t = JaxFileDataset(rows), FileDataset(rows)
    for desc in ("tep", "base"):
        bj = JaxImageGenBuilder(jax_vocab(), description=desc, split="valid")
        bt = ImageGenBuilder(default_vocab(), description=desc, split="valid")
        ej = [bj(ds_j[i]) for i in range(4)]
        et = [bt(ds_t[i]) for i in range(4)]
        cj, ct = jax_collate(ej, pad_id=1), collate(et, pad_id=1)
        assert set(cj) == set(ct) and "code_masks" in ct and "patch_images" not in ct
        for k in cj:
            if isinstance(cj[k], np.ndarray):
                np.testing.assert_array_equal(ct[k], cj[k])
            else:
                assert ct[k] == cj[k], k
        assert ct["target"][0, 0] == default_vocab().code_start + int(ds_t[0][2].split()[0])
    ds_t.close()


def code_dependent(tree):
    """``row_dependent``'s scalings, with the code band's embeddings ×8 and the
    decoder's cross-attention values ×8: a seeded tree's text encoder
    otherwise leaves every row's code sequence one repeated code."""
    tree = row_dependent(tree)
    v = default_vocab()
    tree["embed_tokens"][v.code_start:v.code_start + v.code_dict_size] *= 8.0
    tree["decoder"]["layers"]["encoder_attn"]["v_proj"]["w"] *= 8.0
    return tree


@pytest.fixture(scope="module")
def models():
    cfg_j = dataclasses.replace(ofa_tiny(), dtype="float32", use_flash_attention=True,
                                encoder_layers=2, decoder_layers=2, resnet_layers=(1, 1, 1))
    cfg_t = ModelConfig(**dataclasses.asdict(cfg_j))
    tree = code_dependent(numpy_tree(cfg_t, 0))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=jax.tree.map(jnp.asarray, tree),
                params_t=from_jax(tree, cfg_t, "cpu", torch.float32))


@pytest.mark.parametrize("mode", ["beam", "sampling_top1", "beam18_stack"])
def test_gen_code_search_matches_jax(models, mode):
    """``gen_code`` through the general body on one seeded encoder output: the
    decoder on image positions (code masks), specials banned until the last
    step, the code band from ``constraint_range``; with top-k 1 the sampling
    chains' bookkeeping; at beam 18 with ``decode_stack_kernel`` the port's
    steps through K7's route (past 16 beams: two beam tiles on the card)."""
    m, v = models, default_vocab()
    gen = dict(beam_size=3, max_len_b=16, min_len=16, gen_code=True,
               constraint_range=(v.code_start, v.code_start + v.code_dict_size))
    cfg_t = m["cfg_t"]
    if mode == "sampling_top1":
        gen.update(sampling=True, sampling_topk=1)
    if mode == "beam18_stack":
        gen.update(beam_size=18)
        cfg_t = dataclasses.replace(cfg_t, decode_stack_kernel=True)
    rs = np.random.RandomState(10)
    x, pos = (rs.randn(2, 12, m["cfg_t"].embed_dim).astype(np.float32) for _ in range(2))
    pad = np.zeros((2, 12), bool)
    pad[1, -3:] = True
    enc_j = jofa.EncoderOut(jnp.asarray(x), jnp.asarray(pad), jnp.asarray(pos))
    enc_t = ofa.EncoderOut(torch.from_numpy(x), torch.from_numpy(pad), torch.from_numpy(pos))
    kj = dict(rng=jax.random.PRNGKey(3)) if mode == "sampling_top1" else {}
    kt = dict(rng=torch.Generator().manual_seed(3)) if mode == "sampling_top1" else {}
    tj, sj = jax_beam_search(m["params_j"], m["cfg_j"], JaxGenerationConfig(**gen), enc_j,
                             max_len=16, code_masks_value=True, **kj)
    with mock.patch.object(ofa, "decode_stack_step", wraps=ofa.decode_stack_step) as k7:
        tt, st = beam_search(m["params_t"], cfg_t, GenerationConfig(**gen), enc_t, max_len=16,
                             code_masks_value=True, **kt)
    assert k7.call_count == (17 if mode == "beam18_stack" else 0)  # K7's route, every step
    tj = np.asarray(tj)
    np.testing.assert_array_equal(tt.numpy(), tj)
    _close(st, sj)
    assert ((tj[:, :, :16] >= v.code_start) & (tj[:, :, :16] < v.code_start + v.code_dict_size)).all()
    assert (tj[:, :, 16] == v.eos).all()
    assert len({tuple(r) for r in tj[:, 0]}) == 2  # the two rows differ
    assert min(len(set(r)) for r in tj[:, 0, :16]) >= 4  # and hold more than one code


@pytest.fixture(scope="module")
def evaluated(models, clip_vit, tmp_path_factory):
    """Both tasks' ``evaluate`` (beam 5, 16 codes, ``base`` prompts) on a TSV
    whose reference codes are the port's best codes at their first 8
    positions and random after, so that the accuracy is neither 0 nor 1."""
    m = models
    sd = _vqgan_sd(12, codebook_size=8192)
    (vj, vcj), (vt, vct) = (jvq.convert_vqgan_state_dict(sd),
                            tvq.convert_vqgan_state_dict(sd, device="cpu"))
    pj, cj, pt, ct = clip_vit
    d = tmp_path_factory.mktemp("image_gen_eval")
    kw = dict(description="base", code_image_size=CODE_IMAGE)
    task_j = JaxImageGenTask(jax_vocab(), clip_params=pj, clip_cfg=cj, vqgan_params=vj,
                             vqgan_cfg=vcj, **kw)
    task_t = ImageGenTask(default_vocab(), clip_params=pt, clip_cfg=ct, vqgan_params=vt,
                          vqgan_cfg=vct, **kw)
    b = task_t.builder("valid")
    src = collate([b([str(i), c, "0"]) for i, c in enumerate(CAPTIONS)], pad_id=1)["src_tokens"]
    best = task_t.generate_codes(m["params_t"], m["cfg_t"], torch.from_numpy(src).long())[0]
    codes = best[:, 0].reshape(len(CAPTIONS), -1).numpy()
    codes[:, 8:] = np.random.RandomState(11).randint(0, 8192, codes[:, 8:].shape)
    path = d / "eval.tsv"
    path.write_text("".join(f"{i}\t{c}\t{' '.join(map(str, codes[i]))}\n"
                            for i, c in enumerate(CAPTIONS)))
    out_j = task_j.evaluate(m["params_j"], m["cfg_j"], JaxFileDataset(str(path)), batch_size=2,
                            dump_dir=str(d / "jax"))
    out_t = task_t.evaluate(m["params_t"], m["cfg_t"], FileDataset(str(path)), batch_size=2,
                            dump_dir=str(d / "torch"))
    return out_j, out_t, d, task_t


def test_image_gen_evaluate_matches_jax(evaluated):
    """code_token_acc exactly, ti_sim within 1e-5, the dumped PNGs within one
    level of the JAX task's."""
    out_j, out_t, dumps, _ = evaluated
    assert out_t["n"] == out_j["n"] == 4
    assert out_t["code_token_acc"] == out_j["code_token_acc"]
    assert 0.4 < out_j["code_token_acc"] < 0.6
    assert set(out_t) == set(out_j) == {"code_token_acc", "n", "ti_sim"}
    assert abs(out_t["ti_sim"] - out_j["ti_sim"]) <= REL_TOL * abs(out_j["ti_sim"])
    for i in range(4):
        a = np.asarray(Image.open(dumps / "torch" / f"{i}.png")).astype(int)
        b = np.asarray(Image.open(dumps / "jax" / f"{i}.png")).astype(int)
        assert a.shape == (8, 8, 3) and np.abs(a - b).max() <= 1


def test_image_gen_clip_rank_matches_jax(evaluated, clip_vit):
    """``clip_rank`` on 256² uint8 images (CLIP's resize shrinks them with
    antialiasing, as ``jax.image.resize`` does)."""
    task_t = evaluated[3]
    pj, cj, *_ = clip_vit
    task_j = JaxImageGenTask(jax_vocab(), clip_params=pj, clip_cfg=cj)
    imgs = np.random.RandomState(9).randint(0, 256, (2, 256, 256, 3)).astype(np.uint8)
    caps = CAPTIONS[:2]
    _close(task_t.clip_rank(torch.from_numpy(imgs), caps), task_j.clip_rank(imgs, caps))


def _png_b64(rng, size):
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (size, size, 3)).astype(np.uint8)).save(buf, format="PNG")
    return base64.urlsafe_b64encode(buf.getvalue()).decode()


def test_cli_vqgan_encode_matches_jax(tmp_path):
    """``cli vqgan-encode`` on the CPU: the same code rows as the JAX CLI's."""
    from musketeer_tpu import cli as jax_cli
    from musketeer_tpu_torch import cli

    torch.save({"state_dict": _vqgan_sd(7)}, tmp_path / "vq.ckpt")
    rng = np.random.RandomState(8)
    (tmp_path / "imgs.tsv").write_text(
        "".join(f"{i}\t{_png_b64(rng, 24)}\n" for i in range(3)))
    common = ["vqgan-encode", "--vqgan", str(tmp_path / "vq.ckpt"), "--data",
              str(tmp_path / "imgs.tsv"), "--image-size", "16", "--batch-size", "2"]
    assert cli.main(common + ["--out", str(tmp_path / "t.tsv"), "--device", "cpu"]) == 3
    jax_cli.main(common + ["--out", str(tmp_path / "j.tsv")])
    got, ref = (tmp_path / "t.tsv").read_text(), (tmp_path / "j.tsv").read_text()
    assert got == ref and len(got.splitlines()) == 3
    assert len(got.splitlines()[0].split("\t")[2].split()) == 64


def test_cli_evaluate_image_gen(tmp_path, capsys):
    """``cli evaluate --task image_gen`` on the CPU (the task's 256 codes, beam
    2, no CLIP or VQGAN: the token accuracy only), as the JAX CLI runs it."""
    import json

    from musketeer_tpu_torch import cli

    rng = np.random.RandomState(13)
    path = tmp_path / "gen256.tsv"
    path.write_text("".join(f"{i}\t{c}\t{' '.join(map(str, rng.randint(0, 8192, 256)))}\n"
                            for i, c in enumerate(CAPTIONS)))
    out = cli.main(["evaluate", "--task", "image_gen", "--data", str(path), "--arch", "ofa_tiny",
                    "--device", "cpu", "--limit", "2", "--description", "base", "--beam", "2"])
    assert out["task"] == "image_gen" and out["n"] == 2 and "ti_sim" not in out
    assert 0.0 <= out["code_token_acc"] <= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
