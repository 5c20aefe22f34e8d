"""Beam search, fast candidate path (port of ``generation/beam_search.py``).

Restates ``body_fast`` step for step. Each step runs the incremental decoder
for its features, projects them through K2 (``ops/topk_projection.py``:
logits, 128-token block maxes, exact logsumexp in one pass over the tied
embedding; K2-q8 when ``params`` carry the int8 projection of
``ofa.quantize_output_proj``), selects candidate blocks, and applies every ban in the candidate
domain: pad, the min-length eos ban, the n-gram ban and the at-max cut, with
the forced-eos column. The beam competition is the JAX package's two-stage
top-2K with alive / finished bookkeeping and length-normalised scores.

``lax.while_loop`` becomes a Python loop that checks the JAX ``cond`` before
each step (one host sync per step). Ties keep index order, as ``lax.top_k``
does, so the tokens match the JAX search exactly.

``int8_cross_kv`` quantizes the cross K/V cache right after
``init_decoder_state`` (``ofa.quantize_cross_kv``), as the JAX search does.

Only the fast path is ported: any option that selects the general path
(tries, prefix tokens, constraints, sampling, diverse beams, ensembles,
``gen_box``/``gen_code``, ``unk_penalty``) raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import GenerationConfig, ModelConfig
from ..models import ofa
from ..ops.topk_projection import project_with_stats, select_candidate_blocks, top_k_stable

NEG_INF = -1e9


def _check_fast_path(gen_cfg: GenerationConfig, cfg: ModelConfig, args: dict) -> None:
    unsupported = {**args,
        "use_fast_path=False": not gen_cfg.use_fast_path,
        "constraint_range": gen_cfg.constraint_range is not None,
        "sampling": gen_cfg.sampling,
        "diverse_beam_groups": gen_cfg.diverse_beam_groups > 1,
        "diversity_rate": gen_cfg.diversity_rate != 0,
        "unk_penalty": gen_cfg.unk_penalty != 0,
        "gen_box": gen_cfg.gen_box,
        "gen_code": gen_cfg.gen_code,
        "zero_shot": gen_cfg.zero_shot,
        "padded_vocab_size % 128": cfg.padded_vocab_size % 128 != 0,
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(f"musketeer_tpu_torch beam_search does not support {name}")


def _gather_beams(x: torch.Tensor, beam_idx: torch.Tensor) -> torch.Tensor:
    """x [B, K, ...], beam_idx [B, K'] → [B, K', ...]."""
    idx = beam_idx.reshape(beam_idx.shape + (1,) * (x.dim() - 2)).expand(
        beam_idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def beam_search(
    params,
    cfg: ModelConfig,
    gen_cfg: GenerationConfig,
    encoder_out: ofa.EncoderOut,  # [B, S, ...] untiled
    max_len: int,
    prefix_tokens=None,
    trie=None,
    code_masks_value: bool = False,
    rng=None,
    src_lengths=None,
    constraints=None,
    allowed_fn=None,
    n_models: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens [B, K, max_len+1], normalised scores [B, K]), best first.

    Tokens start after bos and end with eos, pad-filled, as in the JAX search.
    """
    _check_fast_path(gen_cfg, cfg, {
        "prefix_tokens": prefix_tokens is not None, "trie": trie is not None,
        "rng": rng is not None, "src_lengths": src_lengths is not None,
        "constraints": constraints is not None, "allowed_fn": allowed_fn is not None,
        "code_masks": code_masks_value, "n_models": n_models != 1,
    })
    B = encoder_out.x.shape[0]
    K = gen_cfg.beam_size
    N = B * K
    bos, pad, eos = cfg.bos, cfg.pad, cfg.eos
    Vp = cfg.padded_vocab_size
    T = max_len + 2
    device = encoder_out.x.device
    ngram = gen_cfg.no_repeat_ngram_size

    state = ofa.init_decoder_state(params, cfg, encoder_out, max_len=max_len + 1, beam_size=K)
    if gen_cfg.int8_cross_kv:
        state = ofa.quantize_cross_kv(state)
    proj_dtype = ofa.compute_dtype(cfg)
    if "embed_tokens_q8" in params:
        w_proj, w_scale = params["embed_tokens_q8"], params["embed_tokens_scale"]
    else:
        w_proj, w_scale = ofa.output_weight(params, proj_dtype), None  # cast once, not per step
    nb_sel = min(2 * K + 2 + (T - ngram + 1 if ngram > 0 else 0), Vp // 128)

    def length_norm(step: int) -> float:
        return (step + 1.0) ** gen_cfg.len_penalty if gen_cfg.normalize_scores else 1.0

    alive_tokens = torch.full((B, K, T), pad, dtype=torch.long, device=device)
    alive_tokens[:, :, 0] = bos
    alive_scores = torch.zeros((B, K), dtype=torch.float32, device=device)
    alive_scores[:, 1:] = NEG_INF  # only beam 0 live at step 0
    finished_tokens = torch.full((B, K, T), pad, dtype=torch.long, device=device)
    finished_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    rows_of = torch.arange(B, device=device)[:, None] * K
    ngram_starts = torch.arange(T - ngram + 1, device=device) if ngram > 0 else None

    step = 0
    while step <= max_len:
        # the JAX cond: can any alive beam still beat the worst finished one?
        best_alive = alive_scores.amax(dim=1) / length_norm(max_len)
        if not bool((best_alive > finished_scores.amin(dim=1)).any()):
            break
        cur = alive_tokens[:, :, step].reshape(N)
        feats, state = ofa.decode_step(params, cfg, cur, step, state, features_only=True)
        h = feats.to(proj_dtype)
        if gen_cfg.temperature != 1.0:
            h = h / gen_cfg.temperature  # projection is linear with no bias
        logits, bmax, Z = project_with_stats(h, w_proj, w_scale, vocab_size=cfg.vocab_size)
        vals, ids = select_candidate_blocks(logits, bmax, nb_sel)
        alive_flat = alive_scores.reshape(N)
        cand = vals.float() - Z[:, None] + alive_flat[:, None]
        cand = cand.masked_fill(cand.isnan(), NEG_INF)
        cand = cand.masked_fill(ids == pad, NEG_INF)
        if step < gen_cfg.min_len:
            cand = cand.masked_fill(ids == eos, NEG_INF)
        if ngram > 0 and step + 2 - ngram >= 0:
            # a candidate is banned iff it completes an n-gram already seen
            toks = alive_tokens.reshape(N, T)
            match = (ngram_starts + ngram - 1 <= step)[None, :].expand(N, -1)
            for j in range(ngram - 1):
                ctx = toks[:, step - (ngram - 2) + j][:, None]
                match = match & (toks[:, j:j + T - ngram + 1] == ctx)
            banned = toks[:, ngram - 1:]
            hit = ((ids[:, :, None] == banned[:, None, :]) & match[:, None, :]).any(dim=2)
            cand = cand.masked_fill(hit, NEG_INF)
        at_max = step >= max_len
        if at_max:
            cand = torch.full_like(cand, NEG_INF)
        # forced-eos column: the cumulative score when at max, else −1e9
        eos_val = alive_flat if at_max else torch.full_like(alive_flat, NEG_INF)
        cand_ext = torch.cat([cand, eos_val[:, None]], dim=1)
        ids_ext = torch.cat([ids, torch.full((N, 1), eos, dtype=ids.dtype, device=device)], dim=1)

        # two-stage top-2K over the candidate set
        row_sc, row_pos = top_k_stable(cand_ext, 2 * K)
        row_ix = torch.gather(ids_ext, 1, row_pos)
        topk_scores, sel = top_k_stable(row_sc.reshape(B, K * 2 * K), 2 * K)
        topk_beams = torch.div(sel, 2 * K, rounding_mode="floor")
        topk_toks = torch.gather(row_ix.reshape(B, K * 2 * K), 1, sel)

        cand_tokens = _gather_beams(alive_tokens, topk_beams)  # [B, 2K, T]
        cand_tokens[:, :, step + 1] = topk_toks
        is_eos = topk_toks == eos
        new_fin = (topk_scores / length_norm(step)).masked_fill(~is_eos, NEG_INF)
        finished_scores, fin_idx = top_k_stable(torch.cat([finished_scores, new_fin], dim=1), K)
        finished_tokens = _gather_beams(torch.cat([finished_tokens, cand_tokens], dim=1), fin_idx)

        alive_cand = topk_scores.masked_fill(is_eos, NEG_INF)
        alive_scores, alive_idx = top_k_stable(alive_cand, K)
        alive_tokens = _gather_beams(cand_tokens, alive_idx)
        src = torch.gather(topk_beams, 1, alive_idx)
        bbsz = (rows_of + src).reshape(N)
        state = state._replace(cache={
            **state.cache,
            "self_k": state.cache["self_k"][:, bbsz],
            "self_v": state.cache["self_v"][:, bbsz],
        })
        step += 1

    # a sentence with no finished hypothesis returns its best alive prefix,
    # terminated with eos (the JAX search's fallback)
    have_fin = finished_scores > NEG_INF / 2
    scores = torch.where(have_fin, finished_scores, alive_scores / length_norm(max_len))
    alive_tokens[:, :, -1] = eos
    tokens = torch.where(have_fin[:, :, None], finished_tokens, alive_tokens)
    return tokens[:, :, 1:], scores
