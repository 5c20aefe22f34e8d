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
   and once through their plain versions, must give identical tokens;
7. K3 (training attention forward with logsumexp) and K4 (its backward, six
   gradients) against their plain versions at the encoder train shape
   (B4 H12 T=S=980, 10 % padded keys), a causal decoder shape (T=90) and a
   cross shape (T=90, S=990, ``rel=None``) in bf16, and at small fp32 cases
   (``skip_max``, a fully masked row, an odd batch);
8. the training slice: the joint multi-task step of ``ofa_base`` in bf16 on
   8 tasks (the JAX bench's 9-task envelope without ``image_gen`` and with
   ``caption`` unsubsampled), batch 2 per task, R-Drop, label smoothing 0.1,
   drop-worst 0.2 after 6000 with the state at step 7000, AdamW as the bench
   sets it, through ``init_train_state`` and ``make_train_step``; one warm-up
   and 3 timed steps; the loss must be finite at every step and the
   parameters must move; in a step K1 runs 0 times and K3 and K4 each
   ``encoder_layers + 2 · decoder_layers`` times per transformer forward, the
   forwards counted from the step's packing groups;
9. training exactness: the step's loss and gradients in float32 on 2 tasks
   at batch 1, once through K3/K4 and once through their plain versions:
   loss and gradient norm to 1e-5 relative, every gradient leaf to 1e-3 of
   its largest |g|, floored at 1e-4 of the largest |g| of the whole tree (the
   key biases' exact gradient is zero: softmax ignores a shift shared by a
   row's scores, so both sides hold rounding noise there).

Prints a JSON line of the kernels (launches in phases 5 and 8, error against
the plain version, times), then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
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
# K3/K4 at the training step's attention shapes (R-Drop doubles batch 2)
K34_SHAPES = {
    "encoder": dict(shape=dict(B=4, H=12, T=980, S=980, D=64)),
    "decoder causal": dict(shape=dict(B=4, H=12, T=90, S=90, D=64), causal=True),
    "cross rel=None": dict(shape=dict(B=4, H=12, T=90, S=990, D=64), rel=False),
}
K34_SMALL = {
    "skip_max": dict(shape=dict(B=2, H=2, T=70, S=70, D=64), skip_max=True),
    "fully masked row": dict(shape=dict(B=2, H=2, T=33, S=33, D=64), masked_row=1),
    "odd batch causal": dict(shape=dict(B=3, H=2, T=41, S=41, D=64), causal=True),
}
GRAD_NAMES = ("dq", "dk", "dv", "dpos_q", "dpos_k", "drel")
# the training slice: bench.py's joint envelope without image_gen, caption
# without patch subsampling; name: (src len, tgt len, image, constraint masks, conf)
TRAIN_TASKS = {
    "caption": (80, 20, True, False, None),
    "refcoco": (80, 5, True, False, None),
    "vqa_gen": (90, 90, True, True, None),
    "snli_ve": (90, 90, True, True, None),
    "image_classify": (70, 72, True, True, None),
    "detection": (70, 30, True, False, 2.0),
    "gigaword": (512, 32, False, False, None),
    "text_infilling": (512, 32, False, False, None),
}
TRAIN_BATCH = 2
TRAIN_STEP0 = 7000  # TrainState.step: drop-worst active
EXACT_TASKS = ("caption", "gigaword")  # fp32 exactness: a vision and a text task


def _train_configs():
    """The bench's criterion and optimizer for the joint step."""
    from musketeer_tpu_torch.config import CriterionConfig, OptimConfig

    crit = CriterionConfig(label_smoothing=0.1, use_rdrop=True, drop_worst_ratio=0.2,
                           drop_worst_after=6000)
    return crit, OptimConfig(lr=1e-4, warmup_updates=1000, total_updates=30000)


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
    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.ops import topk_projection as k2
    from musketeer_tpu_torch.params import from_jax

    search_module = importlib.import_module("musketeer_tpu_torch.generation.beam_search")
    attn_module = importlib.import_module("musketeer_tpu_torch.ops.flash_attention_bwd")
    cfg = dataclasses.replace(ofa_base(), dtype="float32", use_flash_attention=True)
    params = from_jax(tree, cfg, "cuda", torch.float32)
    gen_cfg = GenerationConfig(beam_size=BEAM, max_len_b=MAX_LEN, min_len=1, no_repeat_ngram_size=3)
    src, images, masks = _inputs(2, SEED + 1)

    before = (k1.flash_attention_inference.launches, k2.project_with_stats.launches)
    _, tok_k, sc_k = _caption(params, cfg, gen_cfg, src, images, masks)
    mid = (k1.flash_attention_inference.launches, k2.project_with_stats.launches)
    with mock.patch.object(attn_module, "flash_attention_inference", k1.flash_attention_plain), \
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


def _elem_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max(1, |b|), element by element (lse is −1e9 on masked rows)."""
    return float(((a.float() - b.float()).abs() / b.float().abs().clamp_min(1.0)).max())


def phase_k3_k4(g) -> dict:
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb

    names = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")
    cases = [(n, c, torch.bfloat16, BF16_TOL) for n, c in K34_SHAPES.items()]
    cases += [(n, c, torch.float32, FP32_TOL) for n, c in K34_SMALL.items()]
    stats = {}
    for name, c, dtype, tol in cases:
        x = _k1_inputs(g, **c["shape"], dtype=dtype, rel=c.get("rel", True),
                       masked_row=c.get("masked_row"))
        args = [x[n] for n in names]
        kw = dict(causal=c.get("causal", False), skip_max=c.get("skip_max", False))
        o, lse = kb.flash_attention_fwd(*args, **kw)
        o_p, lse_p = kb.flash_attention_fwd_plain(*args, **kw)
        e_o, e_lse = _max_err(o, o_p), _elem_rel_err(lse, lse_p)
        if not (e_o <= tol * max(1.0, float(o_p.float().abs().max())) and e_lse <= FP32_TOL
                and bool(torch.isfinite(o).all())):
            raise AssertionError(f"K3 {name}: o err {e_o}, lse err {e_lse}")
        # K4 on the plain forward's o and lse, so that it alone is compared
        do = (torch.randn(o_p.shape, generator=g, device="cuda") * 0.5).to(dtype)
        bwd_args = (*args, o_p, lse_p, do)
        grads = kb.flash_attention_bwd(*bwd_args, causal=kw["causal"])
        ref = kb.flash_attention_bwd_plain(*bwd_args, causal=kw["causal"])
        torch.cuda.synchronize()
        errs = {}
        for gname, a, b in zip(GRAD_NAMES, grads, ref):
            if b is None:
                if a is not None:
                    raise AssertionError(f"K4 {name}: {gname} without rel")
                continue
            errs[gname] = _max_err(a, b)
            lim = (FP32_TOL if b.dtype == torch.float32 else tol) * max(1.0, float(b.abs().max()))
            if not (errs[gname] <= lim and bool(torch.isfinite(a).all())):
                raise AssertionError(f"K4 {name}: {gname} err {errs[gname]} > {lim}")
        log(f"[K3] {name} {str(dtype)[6:]}: max abs err o {e_o:.3e}, lse rel {e_lse:.3e}")
        log(f"[K4] {name} {str(dtype)[6:]}: max abs err "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        if dtype != torch.bfloat16:
            continue
        times = {
            "K3": (cuda_ms(lambda: kb.flash_attention_fwd(*args, **kw), 10),
                   cuda_ms(lambda: kb.flash_attention_fwd_plain(*args, **kw), 10)),
            "K4": (cuda_ms(lambda: kb.flash_attention_bwd(*bwd_args, causal=kw["causal"]), 10),
                   cuda_ms(lambda: kb.flash_attention_bwd_plain(*bwd_args, causal=kw["causal"]), 10)),
        }
        for kname, (ms, plain_ms) in times.items():
            log(f"[{kname}] {name} {c['shape']}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per call")
        if name == "encoder":
            stats["K3"] = dict(max_abs_err=e_o, ms=times["K3"][0], plain_ms=times["K3"][1])
            stats["K4"] = dict(max_abs_err=max(errs.values()), ms=times["K4"][0],
                               plain_ms=times["K4"][1])
        del x, args, o, lse, o_p, lse_p, do, bwd_args, grads, ref
    return stats


def _train_batches(cfg, tasks: dict, batch: int, seed: int) -> dict:
    """Seeded numpy batches on the card, built as the JAX bench builds its
    joint batches, with a leading accumulation axis of 1."""
    import numpy as np

    from musketeer_tpu_torch.training import TaskBatch

    rs = np.random.RandomState(seed)
    hi = min(50000, cfg.vocab_size - 1)
    out = {}
    for name, (ts, tt, image, cmask, conf) in tasks.items():
        tgt = rs.randint(4, hi, (batch, tt))
        tgt[:, -1] = cfg.eos
        prev = np.roll(tgt, 1, 1)
        prev[:, 0] = cfg.bos
        b = dict(src_tokens=rs.randint(4, hi, (batch, ts)), prev_output_tokens=prev, target=tgt)
        if image:
            b["patch_images"] = rs.rand(batch, IMAGE, IMAGE, 3).astype(np.float32)
            b["patch_masks"] = np.ones(batch, bool)
        if cmask:
            m = rs.rand(batch, tt, cfg.padded_vocab_size) < 0.02
            # no layout-padding id is ever allowed (the bench's masks allow some,
            # whose −1e9 log-probabilities then dominate the smoothing term)
            m[..., cfg.vocab_size:] = False
            m[np.arange(batch)[:, None], np.arange(tt)[None], tgt] = True
            b["constraint_masks"] = m
        if conf is not None:
            b["conf"] = np.full(batch, conf, np.float32)
        out[name] = TaskBatch(**{k: torch.from_numpy(v[None]).to("cuda") for k, v in b.items()})
    return out


def _micro(batches: dict) -> dict:
    """The first (only) microbatch of each task."""
    return {n: type(b)(*[None if x is None else x[0] for x in b]) for n, b in batches.items()}


def _expected_forwards(batches: dict) -> int:
    """Transformer forwards in one step, from the step's packing groups: same-
    resolution images share one stem pass and are replaced by stride-16,
    1024-channel features, then batches with equal ``_pack_key`` share a forward."""
    from collections import Counter

    from musketeer_tpu_torch.training import train_step

    micro = _micro(batches)
    res = Counter(tuple(b.patch_images.shape[1:]) for b in micro.values()
                  if b.patch_images is not None)
    keys = []
    for b in micro.values():
        if b.patch_images is not None and res[tuple(b.patch_images.shape[1:])] > 1:
            n, h, w, _ = b.patch_images.shape
            feats = torch.empty((n, h // 16, w // 16, 1024), device="meta")
            b = b._replace(patch_images=None, resnet_feats=feats)
        keys.append(train_step._pack_key(b))
    groups = Counter(k for k in keys if k is not None)
    return keys.count(None) + len(groups)


def phase_train(tree, smi: str) -> dict:
    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.training import init_train_state, make_train_step
    from musketeer_tpu_torch.training.train_state import named_leaves

    cfg = dataclasses.replace(ofa_base(), dtype="bfloat16", use_flash_attention=True)
    crit, optim = _train_configs()
    state = init_train_state(trainable(from_jax(tree, cfg, "cuda", torch.float32)), optim)
    state = state._replace(step=TRAIN_STEP0)
    step = make_train_step(cfg, crit, optim)
    batches = _train_batches(cfg, TRAIN_TASKS, TRAIN_BATCH, SEED)
    forwards = _expected_forwards(batches)
    per_forward = cfg.encoder_layers + 2 * cfg.decoder_layers
    before = [p.detach().clone() for _, p in named_leaves(state.params)]

    def run(state):
        t0 = time.perf_counter()
        state, m = step(state, batches)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not (math.isfinite(loss) and float(m["skipped_nonfinite"]) == 0.0):
            raise AssertionError(f"training step: loss {loss}, skipped {float(m['skipped_nonfinite'])}")
        return state, loss, secs

    torch.cuda.reset_peak_memory_stats()
    state, loss, secs = run(state)
    log(f"[train] warm-up step: loss {loss:.4f} in {secs * 1e3:.1f} ms")
    k1.flash_attention_inference.launches = 0
    kb.flash_attention_fwd.launches = kb.flash_attention_bwd.launches = 0
    with mock.patch.object(ofa, "forward", wraps=ofa.forward) as fwd:
        state, loss, secs = run(state)
    launches = {"K1": k1.flash_attention_inference.launches,
                "K3": kb.flash_attention_fwd.launches, "K4": kb.flash_attention_bwd.launches}
    log(f"[train] launches {launches} over {fwd.call_count} transformer forwards "
        f"(expected {forwards} from the packing groups, {per_forward} attentions each)")
    if fwd.call_count != forwards:
        raise AssertionError(f"{fwd.call_count} forwards in a step, expected {forwards}")
    if launches != {"K1": 0, "K3": per_forward * forwards, "K4": per_forward * forwards}:
        raise AssertionError(f"training launches {launches}")
    losses, times = [loss], [secs]
    for _ in range(2):
        state, loss, secs = run(state)
        losses.append(loss)
        times.append(secs)
    moved = sum(not torch.equal(p.detach(), p0)
                for (_, p), p0 in zip(named_leaves(state.params), before))
    log(f"[train] losses {[round(x, 4) for x in losses]}; {moved} of {len(before)} parameter "
        f"leaves moved; optimizer updates {state.opt_state['count']}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if state.step != TRAIN_STEP0 + 4 or moved < len(before) // 2:
        raise AssertionError(f"the parameters must move: step {state.step}, {moved} leaves moved")
    p50 = statistics.median(times)
    samples = TRAIN_BATCH * len(TRAIN_TASKS)
    log(f"[train] ofa_base bf16 {len(TRAIN_TASKS)} tasks x batch {TRAIN_BATCH}: p50 step "
        f"{p50 * 1e3:.1f} ms, {samples / p50:.2f} samples/s (steps "
        f"{[round(t * 1e3, 1) for t in times]} ms) on {smi}")
    return launches


def phase_train_exactness(tree) -> None:
    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.training.train_state import global_norm, named_leaves
    from musketeer_tpu_torch.training.train_step import multitask_loss

    cfg = dataclasses.replace(ofa_base(), dtype="float32", use_flash_attention=True)
    crit, _ = _train_configs()
    tasks = {n: TRAIN_TASKS[n] for n in EXACT_TASKS}
    micro = _micro(_train_batches(cfg, tasks, 1, SEED + 1))

    def loss_and_grads():
        params = trainable(from_jax(tree, cfg, "cuda", torch.float32))
        loss, _ = multitask_loss(params, cfg, crit, micro, None, TRAIN_STEP0)
        loss.backward()
        return float(loss.detach()), [(path, p.grad) for path, p in named_leaves(params)]

    counts = lambda: (kb.flash_attention_fwd.launches, kb.flash_attention_bwd.launches)
    before = counts()
    loss_k, grads_k = loss_and_grads()
    mid = counts()
    with mock.patch.object(kb, "flash_attention_fwd", kb.flash_attention_fwd_plain), \
            mock.patch.object(kb, "flash_attention_bwd", kb.flash_attention_bwd_plain):
        loss_p, grads_p = loss_and_grads()
    if not (mid[0] > before[0] and mid[1] > before[1] and counts() == mid):
        raise AssertionError(f"kernel/plain routing wrong: {before} {mid} {counts()}")
    norm = lambda gs: float(global_norm([g for _, g in gs if g is not None]))
    gn_k, gn_p = norm(grads_k), norm(grads_p)
    gmax = max(float(g.abs().max()) for _, g in grads_p if g is not None)
    worst, worst_path = 0.0, ""
    for (path, a), (_, b) in zip(grads_k, grads_p):
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError(f"{path}: a gradient on one side only")
            continue
        ratio = _max_err(a, b) / (1e-3 * max(float(b.abs().max()), 1e-4 * gmax))
        if ratio > worst:
            worst, worst_path = ratio, path
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    log(f"[train-exact] fp32 {'+'.join(EXACT_TASKS)} batch 1: loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {rel(loss_k, loss_p):.2e}), grad norm {gn_k:.6f} vs {gn_p:.6f} "
        f"(rel {rel(gn_k, gn_p):.2e}), worst leaf {worst_path} at {worst:.3f} of its bound")
    if rel(loss_k, loss_p) > 1e-5 or rel(gn_k, gn_p) > 1e-5 or worst > 1.0:
        raise AssertionError("fp32 step through K3/K4 differs from the plain versions'")


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
    k34_stats = phase_k3_k4(g)
    train_launches = phase_train(tree, smi)
    phase_train_exactness(tree)

    kernels = [
        dict(name="flash_attention_inference", route="cuda",
             source="musketeer_tpu_torch/csrc/flash_attention_infer.cu",
             replaces="musketeer_tpu/ops/flash_attention_infer.py:109",
             launches=launches["K1"], **k1_stats),
        dict(name="project_with_stats", route="cuda",
             source="musketeer_tpu_torch/csrc/topk_projection.cu",
             replaces="musketeer_tpu/ops/topk_projection.py:95",
             launches=launches["K2"], **k2_stats),
        dict(name="flash_attention_fwd", route="cuda",
             source="musketeer_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="musketeer_tpu/ops/flash_attention_bwd.py:247",
             launches=train_launches["K3"], **k34_stats["K3"]),
        dict(name="flash_attention_bwd", route="cuda",
             source="musketeer_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="musketeer_tpu/ops/flash_attention_bwd.py:296",
             launches=train_launches["K4"], **k34_stats["K4"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
