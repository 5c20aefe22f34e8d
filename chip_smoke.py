#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``musketeer_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. device: requires CUDA (never runs on the CPU) and prints ``nvidia-smi``'s
   name and power limit of the card;
2. build: compiles the kernels from ``musketeer_tpu_torch/csrc`` with nvcc, timed;
3. K1 (attention) against its plain PyTorch version at the caption encoder
   shape, and at small causal, cross (``rel=None``), ``skip_max`` and fully
   masked cases;
4. K2 (projection + softmax stats) against its plain version at the beam
   decode shape;
5. the slice: ``ofa_base`` (random weights from a seed, random rel-pos tables
   and BatchNorm statistics) encodes 16 seeded 480² images with the caption
   prompt and beam-searches them (beam 5, 16 tokens, no repeated trigrams) in
   bf16, through the entry points a user calls; the launch counters must show
   6 K1 launches per encode and one K2 launch per beam step; tokens and
   scores must be well formed; samples/s and p50 batch latency over a warm-up
   and 3 timed runs;
6. exactness: the same slice in float32 at batch 2, once through the kernels
   and once through their plain versions, must give identical tokens.

Prints a JSON line of the kernels (launches in phase 5, error against the
plain version, times), then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

# " what does the image describe?" with bos/eos, from the JAX package's GPT-2
# BPE dictionary: default_vocab().encode_text(prompt, append_bos=True,
# append_eos=True); a constant because the tokenizer needs the `regex`
# package, which the port does not depend on
PROMPT_IDS = [0, 99, 473, 5, 2274, 6190, 116, 2]
SEED = 0
BATCH, BEAM, MAX_LEN, IMAGE = 16, 5, 16, 480
K1_SHAPE = dict(B=16, H=12, T=908, S=908, D=64)  # 900 patches + 8 prompt tokens
K2_SHAPE = dict(N=BATCH * BEAM, D=768, Vp=59520, vocab_size=59457)
# bf16 tolerances: the kernel and the plain version round the probabilities
# (K1) or the logits (K2) to bf16 after fp32 sums taken in different orders,
# so a value may land one or two bf16 steps apart: 2**-7 relative to the
# output's magnitude
BF16_TOL = 2.0 ** -7 * 2
FP32_TOL = 1e-4  # fp32: different summation orders only


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after two warm-ups (CUDA events)."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    # fp32 products in full fp32 (phase 6 compares two fp32 runs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> float:
    from musketeer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    log(f"[build] nvcc sm_90a library in {secs:.1f} s")
    return secs


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _k1_inputs(g, B, H, T, S, D, dtype, rel=True, pad_frac=0.1, masked_row=None):
    dev = "cuda"
    rnd = lambda *s: (torch.randn(*s, generator=g, device=dev) * 0.5).to(dtype)
    x = dict(q=rnd(B, H, T, D), k=rnd(B, H, S, D), v=rnd(B, H, S, D),
             pos_q=rnd(B, H, T, D), pos_k=rnd(B, H, S, D),
             rel=rnd(H, T, S) if rel else None,
             kpad=torch.rand(B, S, generator=g, device=dev) < pad_frac)
    if masked_row is not None:
        x["kpad"][masked_row] = True
    return x


def phase_k1(g) -> dict:
    from musketeer_tpu_torch.ops import flash_attention_infer as k1

    names = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")
    x = _k1_inputs(g, **K1_SHAPE, dtype=torch.bfloat16)
    args = [x[n] for n in names]
    out = k1.flash_attention_inference(*args)
    ref = k1.flash_attention_plain(*args)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    tol = BF16_TOL * max(1.0, float(ref.float().abs().max()))
    log(f"[K1] B16 H12 T=S=908 D64 bf16: max abs err {err:.3e} (tol {tol:.3e})")
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"K1 disagrees with its plain version: {err} > {tol}")
    ms = cuda_ms(lambda: k1.flash_attention_inference(*args), 10)
    plain_ms = cuda_ms(lambda: k1.flash_attention_plain(*args), 10)
    log(f"[K1] kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per call")
    del x, args, out, ref

    cases = {
        "causal": dict(shape=dict(B=2, H=2, T=100, S=100, D=64), causal=True),
        "cross rel=None": dict(shape=dict(B=2, H=2, T=17, S=130, D=64), rel=False),
        "skip_max": dict(shape=dict(B=2, H=2, T=70, S=70, D=64), skip_max=True),
        "fully masked row": dict(shape=dict(B=2, H=2, T=33, S=33, D=64), masked_row=1),
    }
    for name, c in cases.items():
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            xs = _k1_inputs(g, **c["shape"], dtype=dtype, rel=c.get("rel", True),
                            masked_row=c.get("masked_row"))
            kw = dict(causal=c.get("causal", False), skip_max=c.get("skip_max", False))
            a = k1.flash_attention_inference(*(xs[n] for n in names), **kw)
            b = k1.flash_attention_plain(*(xs[n] for n in names), **kw)
            e = _max_err(a, b)
            log(f"[K1] {name} {str(dtype)[6:]}: max abs err {e:.3e}")
            if not e <= tol * max(1.0, float(b.float().abs().max())):
                raise AssertionError(f"K1 {name} {dtype}: {e}")
            if "masked_row" in c:
                mean_v = xs["v"][1].float().mean(dim=1, keepdim=True).expand_as(b[1])
                if _max_err(a[1], mean_v) > tol:
                    raise AssertionError("K1: a fully masked row must give the mean of v")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_k2(g) -> dict:
    from musketeer_tpu_torch.ops import topk_projection as k2

    N, D, Vp, vs = (K2_SHAPE[k] for k in ("N", "D", "Vp", "vocab_size"))
    h = torch.randn(N, D, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(Vp, D, generator=g, device="cuda") * D ** -0.5).to(torch.bfloat16)
    w[vs:] = 0
    out = k2.project_with_stats(h, w, vocab_size=vs)
    ref = k2.project_plain(h, w, vocab_size=vs)
    torch.cuda.synchronize()
    errs = {name: _max_err(a, b) for name, a, b in zip(("logits", "bmax", "Z"), out, ref)}
    log(f"[K2] N80 Vp59520 D768 bf16: max abs err logits {errs['logits']:.3e} "
        f"bmax {errs['bmax']:.3e} Z {errs['Z']:.3e}")
    logit_tol = BF16_TOL * max(1.0, float(ref[0].float().abs().max()))
    if not (errs["logits"] <= logit_tol and errs["bmax"] <= FP32_TOL and errs["Z"] <= FP32_TOL):
        raise AssertionError(f"K2 disagrees with its plain version: {errs}")
    if not bool((out[0][:, vs:] == k2.NEG_INF).all()):
        raise AssertionError("K2: padded vocab columns must be -1e9")
    a = k2.project_with_stats(h.float(), w.float(), vocab_size=vs)
    b = k2.project_plain(h.float(), w.float(), vocab_size=vs)
    e = max(_max_err(x, y) for x, y in zip(a, b))
    log(f"[K2] fp32: max abs err {e:.3e}")
    if not e <= FP32_TOL:
        raise AssertionError(f"K2 fp32: {e}")
    ms = cuda_ms(lambda: k2.project_with_stats(h, w, vocab_size=vs), 20)
    plain_ms = cuda_ms(lambda: k2.project_plain(h, w, vocab_size=vs), 20)
    log(f"[K2] kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per call")
    return dict(max_abs_err=errs["logits"], ms=ms, plain_ms=plain_ms)


def _random_model_tree(cfg, seed: int):
    """``ofa_base`` parameters in the JAX layout, with the zero-init rel-pos
    tables and the trivial BN statistics filled with seeded random values."""
    from musketeer_tpu_torch.params import init_ofa_params

    g = torch.Generator().manual_seed(seed)
    tree = init_ofa_params(cfg, g, "cpu")
    for part in ("encoder", "decoder"):
        for name in ("token_rel_pos_table", "image_rel_pos_table"):
            tree[part][name] = torch.randn(tree[part][name].shape, generator=g) * 0.5

    def bn(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                c = node["mean"].shape
                node["scale"] = torch.rand(c, generator=g) + 0.5
                node["bias"] = torch.randn(c, generator=g) * 0.1
                node["mean"] = torch.randn(c, generator=g) * 0.1
                node["var"] = torch.rand(c, generator=g) + 0.5
            else:
                for v in node.values():
                    bn(v)

    bn(tree["encoder"]["resnet"])
    return tree


def _inputs(batch: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.tensor([PROMPT_IDS] * batch, device="cuda")
    images = torch.rand(batch, IMAGE, IMAGE, 3, generator=g, device="cuda")
    masks = torch.ones(batch, dtype=torch.bool, device="cuda")
    return src, images, masks


def _caption(params, cfg, gen_cfg, src, images, masks):
    """The main path, through the entry points a user calls."""
    from musketeer_tpu_torch.generation import beam_search
    from musketeer_tpu_torch.models import ofa

    enc = ofa.encode(params, cfg, src, images, masks)
    tokens, scores = beam_search(params, cfg, gen_cfg, enc, max_len=MAX_LEN)
    torch.cuda.synchronize()
    return enc, tokens, scores


def _check_tokens(tokens, scores, cfg, batch):
    if tuple(tokens.shape) != (batch, BEAM, MAX_LEN + 1) or tuple(scores.shape) != (batch, BEAM):
        raise AssertionError(f"shapes {tuple(tokens.shape)} {tuple(scores.shape)}")
    if not bool(torch.isfinite(scores).all()) or bool((scores > 0).any()):
        raise AssertionError("scores must be finite log-probabilities")
    if bool(((tokens < 0) | (tokens >= cfg.vocab_size)).any()):
        raise AssertionError("token ids out of the vocabulary")
    is_eos = tokens == cfg.eos
    if not bool(is_eos.any(dim=-1).all()):
        raise AssertionError("every hypothesis must end with eos")
    after = is_eos.long().cumsum(-1) - is_eos.long() > 0  # positions after the first eos
    if not bool((tokens[after] == cfg.pad).all()) or bool((tokens[~after] == cfg.pad).any()):
        raise AssertionError("pad must fill exactly the positions after eos")


def phase_slice(tree, smi: str) -> dict:
    from musketeer_tpu_torch.config import GenerationConfig, ofa_base
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.ops import topk_projection as k2
    from musketeer_tpu_torch.params import from_jax

    cfg = dataclasses.replace(ofa_base(), dtype="bfloat16", use_flash_attention=True)
    params = from_jax(tree, cfg, "cuda", torch.bfloat16)
    gen_cfg = GenerationConfig(beam_size=BEAM, max_len_b=MAX_LEN, min_len=1, no_repeat_ngram_size=3)
    src, images, masks = _inputs(BATCH, SEED)

    _caption(params, cfg, gen_cfg, src, images, masks)  # warm-up
    k1.flash_attention_inference.launches = 0
    k2.project_with_stats.launches = 0
    with mock.patch.object(ofa, "decode_step", wraps=ofa.decode_step) as steps:
        enc, tokens, scores = _caption(params, cfg, gen_cfg, src, images, masks)
    launches = {"K1": k1.flash_attention_inference.launches, "K2": k2.project_with_stats.launches}
    log(f"[slice] launches {launches}, beam steps {steps.call_count}")
    if launches["K1"] != cfg.encoder_layers:
        raise AssertionError(f"K1 ran {launches['K1']} times in one encode, expected 6")
    if not (1 <= steps.call_count <= MAX_LEN + 1 and launches["K2"] == steps.call_count):
        raise AssertionError(f"K2 ran {launches['K2']} times over {steps.call_count} steps")
    if tuple(enc.x.shape) != (BATCH, 908, 768) or not bool(torch.isfinite(enc.x).all()):
        raise AssertionError("encoder output must be finite [16, 908, 768]")
    _check_tokens(tokens, scores, cfg, BATCH)
    log(f"[slice] first hypothesis: {tokens[0, 0].tolist()} score {float(scores[0, 0]):.4f}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _caption(params, cfg, gen_cfg, src, images, masks)
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    log(f"[slice] ofa_base bf16 batch {BATCH} beam {BEAM} 480²: p50 batch latency "
        f"{p50 * 1e3:.1f} ms, {BATCH / p50:.2f} samples/s (runs {[round(t * 1e3, 1) for t in times]} ms) "
        f"on {smi}")
    return launches


def phase_exactness(tree) -> None:
    from musketeer_tpu_torch.config import GenerationConfig, ofa_base
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.ops import topk_projection as k2
    from musketeer_tpu_torch.params import from_jax

    search_module = importlib.import_module("musketeer_tpu_torch.generation.beam_search")
    cfg = dataclasses.replace(ofa_base(), dtype="float32", use_flash_attention=True)
    params = from_jax(tree, cfg, "cuda", torch.float32)
    gen_cfg = GenerationConfig(beam_size=BEAM, max_len_b=MAX_LEN, min_len=1, no_repeat_ngram_size=3)
    src, images, masks = _inputs(2, SEED + 1)

    before = (k1.flash_attention_inference.launches, k2.project_with_stats.launches)
    _, tok_k, sc_k = _caption(params, cfg, gen_cfg, src, images, masks)
    mid = (k1.flash_attention_inference.launches, k2.project_with_stats.launches)
    with mock.patch.object(ofa, "flash_attention_inference", k1.flash_attention_plain), \
            mock.patch.object(search_module, "project_with_stats", k2.project_plain):
        _, tok_p, sc_p = _caption(params, cfg, gen_cfg, src, images, masks)
    after = (k1.flash_attention_inference.launches, k2.project_with_stats.launches)
    if not (mid[0] > before[0] and mid[1] > before[1] and after == mid):
        raise AssertionError(f"kernel/plain routing wrong: {before} {mid} {after}")
    _check_tokens(tok_k, sc_k, cfg, 2)
    log(f"[exact] fp32 batch 2: kernel tokens {tok_k[:, 0].tolist()}; "
        f"max score diff {_max_err(sc_k, sc_p):.3e}")
    if not torch.equal(tok_k, tok_p):
        raise AssertionError("fp32 tokens through the kernels differ from the plain versions'")


def main() -> int:
    smi = phase_device()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    k1_stats = phase_k1(g)
    k2_stats = phase_k2(g)
    from musketeer_tpu_torch.config import ofa_base

    tree = _random_model_tree(dataclasses.replace(ofa_base(), use_flash_attention=True), SEED)
    launches = phase_slice(tree, smi)
    phase_exactness(tree)

    kernels = [
        dict(name="flash_attention_inference", route="cuda",
             source="musketeer_tpu_torch/csrc/flash_attention_infer.cu",
             replaces="musketeer_tpu/ops/flash_attention_infer.py:109",
             launches=launches["K1"], **k1_stats),
        dict(name="project_with_stats", route="cuda",
             source="musketeer_tpu_torch/csrc/topk_projection.cu",
             replaces="musketeer_tpu/ops/topk_projection.py:95",
             launches=launches["K2"], **k2_stats),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
