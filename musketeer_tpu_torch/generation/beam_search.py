"""Constrained beam search (port of ``musketeer_tpu/generation/beam_search.py``).

Two bodies, routed as the JAX search routes them (``use_fast_path``):

- **the fast candidate path** (``body_fast``): each step runs the incremental
  decoder for its features and projects them through K2
  (``ops/topk_projection.py``: logits, 128-token block maxes and the exact
  logsumexp in one pass over the tied embedding; K2-q8 when ``params`` carry
  the int8 projection of ``ofa.quantize_output_proj``), selects candidate
  blocks and applies every ban in the candidate domain: pad, the min-length
  eos ban, the n-gram ban and the at-max cut, with the forced-eos column;
- **the general body** (``body``), for every option the fast path does not
  take: tries (``generation/trie.py``, pre-softmax, or post-softmax under
  ``zero_shot``), per-row prefix forcing with the trie activated past each
  row's own prefix, ``constraint_range``, ``allowed_fn``, ``unk_penalty``,
  ``gen_box``'s 4-bins-then-eos cycle, per-sentence min and max lengths,
  lexical constraints (``generation/lexical.py``: the eos block, Post &
  Vilar candidates, stripe selection), diverse groups and the sibling-rank
  penalty, top-k / top-p sampling, and ensembles (``params`` a list: each
  model keeps its own decoder state and self K/V cache; log-probs averaged in
  probability space as ``logsumexp − log M``).

Both keep the JAX search's alive / finished bookkeeping and length-normalised
scores, its order of floating-point operations in the candidate domain
(``logits − Z + alive`` in fp32) and its additive bans (the min-length and the
lexical eos bans, the n-gram ban's scatter-add) beside its ``where`` bans.
``lax.while_loop`` becomes a Python loop that checks the JAX ``cond`` before
each step (one host sync per step). Every top-k and argmax keeps index order
on ties, as ``lax.top_k`` does, so the tokens match the JAX search exactly.
Sampling draws from a ``torch.Generator`` (Gumbel-max, as
``jax.random.categorical``); its draws cannot match JAX's PRNG.

``int8_cross_kv`` quantizes the cross K/V cache right after
``init_decoder_state`` (``ofa.quantize_cross_kv``), as the JAX search does.
``code_masks_value`` marks every row as a code target (the decoder's image
positions and rel buckets, in ``init_decoder_state`` and each
``decode_step``); ``gen_code`` takes the general body and bans the special
tokens below 4 until the last step (eos only there), with the code band from
``constraint_range``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..config import GenerationConfig, ModelConfig
from ..models import ofa
from ..ops.topk_projection import project_with_stats, select_candidate_blocks, top_k_stable
from .lexical import constraint_transition, stripe_key
from .trie import DenseTrie

NEG_INF = -1e9


class BeamState(NamedTuple):
    step: int
    alive_tokens: torch.Tensor  # [B, K, T+2] long (slot 0 = bos)
    alive_scores: torch.Tensor  # [B, K] fp32 cumulative lprob
    finished_tokens: torch.Tensor  # [B, K', T+2]
    finished_scores: torch.Tensor  # [B, K] normalized (length-penalized)
    decs: List[ofa.DecoderState]  # one per model; self K/V written in place by decode_step
    trie_nodes: Optional[torch.Tensor] = None  # [B, K] trie cursor
    cons_ptr: Optional[torch.Tensor] = None  # [B, K] lexical-constraint pointer


def use_fast_path(gen_cfg: GenerationConfig, cfg: ModelConfig, trie=None, prefix_tokens=None,
                  constraints=None, allowed_fn=None, n_models: int = 1) -> bool:
    """The JAX search's routing predicate: the fast path when no vocab-shaped
    constraint, sampling, diversity, prefix or ensemble applies."""
    return (
        gen_cfg.use_fast_path
        and trie is None
        and gen_cfg.constraint_range is None
        and allowed_fn is None
        and constraints is None
        and not gen_cfg.sampling
        and gen_cfg.diverse_beam_groups <= 1
        and gen_cfg.diversity_rate == 0
        and prefix_tokens is None
        and gen_cfg.unk_penalty == 0
        and not gen_cfg.gen_box
        and not gen_cfg.gen_code
        and n_models == 1
        and cfg.padded_vocab_size % 128 == 0
    )


def _gather_beams(x: torch.Tensor, beam_idx: torch.Tensor) -> torch.Tensor:
    """x [B, K, ...], beam_idx [B, K'] → [B, K', ...]."""
    idx = beam_idx.reshape(beam_idx.shape + (1,) * (x.dim() - 2)).expand(
        beam_idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def tile_encoder_out(enc: ofa.EncoderOut, beam_size: int) -> ofa.EncoderOut:
    """Repeat each batch row beam_size times (ref: reorder_encoder_out tiling)."""
    rep = lambda a: a.repeat_interleave(beam_size, dim=0)
    return ofa.EncoderOut(rep(enc.x), rep(enc.padding_mask), rep(enc.pos_embed))


def _ngram_match(tokens_flat: torch.Tensor, step: int, n: int):
    """(match [N, L-n+1], banned [N, L-n+1]): the token at i+n-1 of every
    n-gram start i whose first n-1 tokens equal the last n-1 generated ones."""
    N, L = tokens_flat.shape
    idx = torch.arange(L - n + 1, device=tokens_flat.device)
    match = (idx + n - 1 <= step)[None, :].expand(N, -1)
    for j in range(n - 1):
        ctx = tokens_flat[:, step - (n - 2) + j][:, None]
        match = match & (tokens_flat[:, j:j + L - n + 1] == ctx)
    return match, tokens_flat[:, n - 1:]


def _apply_no_repeat_ngram(lprobs: torch.Tensor, tokens_flat: torch.Tensor, step: int,
                           n: int) -> torch.Tensor:
    """Ban tokens that would complete an already-seen n-gram: −1e9 added at each
    banned id for each match, so an id banned twice gets −2e9 (the JAX
    search's scatter-add)."""
    match, banned = _ngram_match(tokens_flat, step, n)
    rows = torch.arange(lprobs.shape[0], device=lprobs.device)[:, None].expand_as(banned)
    updates = torch.where(match, NEG_INF, 0.0).to(lprobs.dtype)
    return lprobs.index_put((rows, banned), updates, accumulate=True)


def _band_ban(V: int, constraint_range, device) -> torch.Tensor:
    cs, ce = constraint_range
    band = torch.arange(V, device=device)
    return ((band >= 4) & (band < cs) | (band >= ce))[None, :]


def _constrain_logits_pre(logits, gen_cfg: GenerationConfig, trie: Optional[DenseTrie],
                          trie_nodes_flat):
    """Pre-log_softmax constraints (renormalizing). ref: sequence_generator.py:855-873."""
    V = logits.shape[-1]
    if trie is not None and not gen_cfg.zero_shot:
        logits = torch.where(trie.allowed_mask(trie_nodes_flat, V), logits, NEG_INF)
    if gen_cfg.constraint_range is not None and not gen_cfg.zero_shot:
        logits = torch.where(_band_ban(V, gen_cfg.constraint_range, logits.device), NEG_INF, logits)
    return logits


def _constrain_lprobs_post(lprobs, gen_cfg: GenerationConfig, trie: Optional[DenseTrie],
                           trie_nodes_flat):
    """Post-log_softmax constraints (zero-shot mode). ref: :880-887."""
    V = lprobs.shape[-1]
    if trie is not None and gen_cfg.zero_shot:
        lprobs = torch.where(trie.allowed_mask(trie_nodes_flat, V), lprobs, NEG_INF)
    if gen_cfg.constraint_range is not None and gen_cfg.zero_shot:
        lprobs = torch.where(_band_ban(V, gen_cfg.constraint_range, lprobs.device), NEG_INF, lprobs)
    return lprobs


def sampling_filter(lprobs: torch.Tensor, topk: int, topp: float) -> torch.Tensor:
    """Top-k then top-p (nucleus) filtering of ``[N, V]`` log-probs: filtered
    entries become −1e9 (the JAX search's ``_sampling_grow``)."""
    filt = lprobs
    if topk > 0:
        kth = top_k_stable(filt, topk)[0][:, -1:]
        filt = torch.where(filt < kth, NEG_INF, filt)
    if topp > 0:
        srt = torch.sort(filt, dim=-1, descending=True).values
        cum = torch.cumsum(torch.exp(srt), dim=-1)
        # smallest set with cumulative prob >= topp (the first such index)
        cutoff_idx = torch.argmax((cum >= topp).to(torch.int32), dim=-1)
        cutoff = torch.gather(srt, 1, cutoff_idx[:, None])
        filt = torch.where(filt < cutoff, NEG_INF, filt)
    return filt


def sample_categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick → [N] long."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _as_rows(x, N: int, device) -> torch.Tensor:
    """A Python bool or a per-row bool tensor → [N] bool."""
    if isinstance(x, torch.Tensor):
        return x.expand(N)
    return torch.full((N,), bool(x), dtype=torch.bool, device=device)


def beam_search(
    params,
    cfg: ModelConfig,
    gen_cfg: GenerationConfig,
    encoder_out,  # ofa.EncoderOut [B, S, ...] untiled; a list of them for an ensemble
    max_len: int,
    prefix_tokens: Optional[torch.Tensor] = None,  # [B, P] pad-padded
    trie: Optional[DenseTrie] = None,
    code_masks_value: bool = False,
    rng: Optional[torch.Generator] = None,  # required when gen_cfg.sampling
    src_lengths: Optional[torch.Tensor] = None,  # [B] → per-sentence min/max
    constraints=None,  # (cons_tokens [B, C], phrase_start [B, C]) from pack_constraints
    allowed_fn: Optional[Callable] = None,  # (step, tokens_flat [B*K, T]) → bool [B*K, V]
    n_models: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens [B, K, max_len+1], normalised scores [B, K]), best first.

    Tokens start after bos and end with eos, pad-filled, as in the JAX search.
    ``n_models > 1``: ``params`` and ``encoder_out`` are lists, one entry a
    model. ``allowed_fn``'s mask is applied to the post-softmax log-probs
    without renormalizing (the reference's PrefixConstrainedBeamSearch hook).
    A sentence with no finished hypothesis (unmeetable constraints, dead
    sampling chains) returns its best alive prefix terminated with eos, with
    its deeply negative score.
    """
    models = list(params) if n_models > 1 else [params]
    encs = list(encoder_out) if n_models > 1 else [encoder_out]
    if len(models) != n_models or len(encs) != n_models:
        raise ValueError(f"n_models={n_models} needs that many params trees and encoder outputs")
    if n_models > 1 and gen_cfg.int8_cross_kv:
        raise ValueError("int8 KV + ensemble not supported")
    if gen_cfg.sampling and rng is None:
        raise ValueError("sampling mode needs an rng (a torch.Generator)")
    B = encs[0].x.shape[0]
    K = gen_cfg.beam_size
    N = B * K
    bos, pad, eos, unk = cfg.bos, cfg.pad, cfg.eos, cfg.unk
    Vp = cfg.padded_vocab_size
    T = max_len + 2
    device = encs[0].x.device
    ngram = gen_cfg.no_repeat_ngram_size
    as_dev = lambda x: torch.as_tensor(x, device=device).long()

    if trie is not None and trie.device != device:
        raise ValueError(f"the trie's tables are on {trie.device}, the search on {device}: "
                         "pass trie.on(device)")
    if constraints is not None:
        if gen_cfg.sampling or gen_cfg.diverse_beam_groups > 1 or gen_cfg.diversity_rate != 0:
            raise ValueError("lexical constraints don't compose with sampling/diverse modes")
        cons_t, starts_t = as_dev(constraints[0]), as_dev(constraints[1])
        cons_total = (cons_t != pad).sum(dim=1)
        Cc = cons_t.shape[1]

    # gen_code: every row decodes code tokens (image positions and rel buckets)
    code_masks = torch.ones((N,), dtype=torch.bool, device=device) if code_masks_value else None
    decs = []
    for p, e in zip(models, encs):
        dec = ofa.init_decoder_state(p, cfg, e, max_len=max_len + 1, code_masks=code_masks,
                                     beam_size=K)
        decs.append(ofa.quantize_cross_kv(dec) if gen_cfg.int8_cross_kv else dec)

    fast = use_fast_path(gen_cfg, cfg, trie, prefix_tokens, constraints, allowed_fn, n_models)
    G = gen_cfg.diverse_beam_groups
    if gen_cfg.sampling:
        init_alive = torch.zeros((B, K), dtype=torch.float32, device=device)  # K independent chains
    elif G > 1:
        # group-local pruning never crosses groups: each group's seed beam g is live
        live = torch.arange(K, device=device) < G
        init_alive = torch.where(live, 0.0, NEG_INF)[None].expand(B, K).float().contiguous()
    else:
        init_alive = torch.zeros((B, K), dtype=torch.float32, device=device)
        init_alive[:, 1:] = NEG_INF  # only beam 0 live at step 0
    alive_tokens = torch.full((B, K, T), pad, dtype=torch.long, device=device)
    alive_tokens[:, :, 0] = bos
    s = BeamState(
        step=0,
        alive_tokens=alive_tokens,
        alive_scores=init_alive,
        finished_tokens=torch.full((B, K, T), pad, dtype=torch.long, device=device),
        finished_scores=torch.full((B, K), NEG_INF, dtype=torch.float32, device=device),
        decs=decs,
        trie_nodes=(torch.zeros((B, K), dtype=torch.long, device=device)
                    if trie is not None else None),
        cons_ptr=(torch.zeros((B, K), dtype=torch.long, device=device)
                  if constraints is not None else None),
    )

    prefix_len = 0 if prefix_tokens is None else prefix_tokens.shape[1]
    if prefix_tokens is not None:
        ptok = as_dev(prefix_tokens).repeat_interleave(K, dim=0)  # [N, P]
        # per-row prefix lengths: each row's trie activates past its own prefix
        row_plen = (ptok != pad).sum(dim=1)  # [N]
    if src_lengths is not None:  # per-sentence length constraints (ref: search.py:526-549)
        sl = src_lengths.to(device=device, dtype=torch.float32)
        row_min = (gen_cfg.min_len_a * sl + gen_cfg.min_len).repeat_interleave(K)
        row_max = (gen_cfg.max_len_a * sl + gen_cfg.max_len_b).repeat_interleave(K)
    else:
        row_min = row_max = None
    min_thr = row_min if row_min is not None else gen_cfg.min_len
    rows_of = torch.arange(B, device=device)[:, None] * K
    iota_v = torch.arange(Vp, device=device)
    eos_col = (iota_v == eos)[None, :]
    log_m = torch.log(torch.tensor(float(n_models), device=device))

    def length_norm(step: int) -> float:
        # score / (gen_len)**len_penalty; gen_len = step+1 incl. eos
        return (step + 1.0) ** gen_cfg.len_penalty if gen_cfg.normalize_scores else 1.0

    def at_max_rows(step: int):
        """Python bool, or [N] bool with per-sentence max lengths."""
        at_max = step >= max_len
        if row_max is not None:
            return at_max | (step >= row_max)
        return at_max

    def reorder(dec_list, bbsz):
        for d in dec_list:
            d.cache["self_k"] = d.cache["self_k"][:, bbsz]
            d.cache["self_v"] = d.cache["self_v"][:, bbsz]
        return dec_list

    def finish(s: BeamState, cand_tokens, topk_toks, topk_scores, step: int):
        """Merge the eos candidates into the finished set → (scores, tokens, is_eos)."""
        is_eos = topk_toks == eos
        new_fin = torch.where(is_eos, topk_scores / length_norm(step), NEG_INF)
        fin_scores, fin_idx = top_k_stable(torch.cat([s.finished_scores, new_fin], dim=1), K)
        fin_tokens = _gather_beams(torch.cat([s.finished_tokens, cand_tokens], dim=1), fin_idx)
        return fin_scores, fin_tokens, is_eos

    # ---- fast candidate path ---------------------------------------------
    if fast:
        proj_dtype = ofa.compute_dtype(cfg)
        if "embed_tokens_q8" in params:
            w_proj, w_scale = params["embed_tokens_q8"], params["embed_tokens_scale"]
        else:
            w_proj, w_scale = ofa.output_weight(params, proj_dtype), None  # cast once, not per step
        nb_sel = min(2 * K + 2 + (T - ngram + 1 if ngram > 0 else 0), Vp // 128)

    def body_fast(s: BeamState) -> BeamState:
        step = s.step
        cur = s.alive_tokens[:, :, step].reshape(N)
        feats, _ = ofa.decode_step(params, cfg, cur, step, s.decs[0], code_masks=code_masks,
                                   features_only=True)
        h = feats.to(proj_dtype)
        if gen_cfg.temperature != 1.0:
            h = h / gen_cfg.temperature  # projection is linear with no bias
        logits, bmax, Z = project_with_stats(h, w_proj, w_scale, vocab_size=cfg.vocab_size)
        vals, ids = select_candidate_blocks(logits, bmax, nb_sel)
        alive_flat = s.alive_scores.reshape(N)
        cand = vals.float() - Z[:, None] + alive_flat[:, None]
        cand = cand.masked_fill(cand.isnan(), NEG_INF)
        cand = cand.masked_fill(ids == pad, NEG_INF)
        min_act = step < min_thr
        if isinstance(min_act, torch.Tensor):
            cand = cand.masked_fill(min_act[:, None] & (ids == eos), NEG_INF)
        elif min_act:
            cand = cand.masked_fill(ids == eos, NEG_INF)
        if ngram > 0 and step + 2 - ngram >= 0:
            # a candidate is banned iff it completes an n-gram already seen
            match, banned = _ngram_match(s.alive_tokens.reshape(N, T), step, ngram)
            hit = ((ids[:, :, None] == banned[:, None, :]) & match[:, None, :]).any(dim=2)
            cand = cand.masked_fill(hit, NEG_INF)
        at_max = _as_rows(at_max_rows(step), N, device)
        cand = cand.masked_fill(at_max[:, None], NEG_INF)
        # forced-eos column: the cumulative score when at max, else −1e9
        eos_val = torch.where(at_max, alive_flat, NEG_INF)
        cand_ext = torch.cat([cand, eos_val[:, None]], dim=1)
        ids_ext = torch.cat([ids, torch.full((N, 1), eos, dtype=ids.dtype, device=device)], dim=1)

        # two-stage top-2K over the candidate set
        row_sc, row_pos = top_k_stable(cand_ext, 2 * K)
        row_ix = torch.gather(ids_ext, 1, row_pos)
        topk_scores, sel = top_k_stable(row_sc.reshape(B, K * 2 * K), 2 * K)
        topk_beams = torch.div(sel, 2 * K, rounding_mode="floor")
        topk_toks = torch.gather(row_ix.reshape(B, K * 2 * K), 1, sel)

        cand_tokens = _gather_beams(s.alive_tokens, topk_beams)  # [B, 2K, T]
        cand_tokens[:, :, step + 1] = topk_toks
        fin_scores, fin_tokens, is_eos = finish(s, cand_tokens, topk_toks, topk_scores, step)
        alive_scores, alive_idx = top_k_stable(topk_scores.masked_fill(is_eos, NEG_INF), K)
        src = torch.gather(topk_beams, 1, alive_idx)
        return BeamState(step + 1, _gather_beams(cand_tokens, alive_idx), alive_scores,
                         fin_tokens, fin_scores, reorder(s.decs, (rows_of + src).reshape(N)))

    # ---- general body --------------------------------------------------------
    def decode(cur: torch.Tensor, step: int, dec_list) -> torch.Tensor:
        """The step's logits [N, Vp] (fp32 when tempered); for an ensemble the
        models' log-probs averaged in probability space."""
        if n_models == 1:
            logits, _ = ofa.decode_step(models[0], cfg, cur, step, dec_list[0], code_masks)
            if gen_cfg.temperature != 1.0:
                logits = logits.float() / gen_cfg.temperature
            return logits
        logits_m = torch.stack([ofa.decode_step(p, cfg, cur, step, d, code_masks)[0]
                                for p, d in zip(models, dec_list)]).float()
        if gen_cfg.temperature != 1.0:
            logits_m = logits_m / gen_cfg.temperature
        return torch.logsumexp(torch.log_softmax(logits_m, dim=-1), dim=0) - log_m

    def sampling_grow(s: BeamState, lprobs, step: int, trie_active_rows) -> BeamState:
        """K independent chains, one sampled token per chain per step (fairseq
        Sampling search, models/search.py:526)."""
        filt = sampling_filter(lprobs, gen_cfg.sampling_topk, gen_cfg.sampling_topp)
        sampled = sample_categorical(filt, rng)  # [N]
        tok_lp = torch.gather(lprobs, 1, sampled[:, None])[:, 0].view(B, K)
        sampled = sampled.view(B, K)
        dead = s.alive_scores <= NEG_INF / 2
        new_scores = torch.where(dead, NEG_INF, s.alive_scores + tok_lp)
        tokens = s.alive_tokens.clone()
        tokens[:, :, step + 1] = sampled
        is_eos = (sampled == eos) & ~dead
        fin_new = torch.where(is_eos, new_scores / length_norm(step), NEG_INF)
        fin_scores, fin_idx = top_k_stable(torch.cat([s.finished_scores, fin_new], dim=1), K)
        fin_tokens = _gather_beams(torch.cat([s.finished_tokens, tokens], dim=1), fin_idx)
        trie_nodes = None
        if trie is not None:
            old = s.trie_nodes.reshape(N)
            nodes = trie.transition(old, sampled.reshape(N))
            if trie_active_rows is not None:
                nodes = torch.where(trie_active_rows, nodes, old)
            trie_nodes = nodes.view(B, K)
        # chains keep their own rows: no reorder
        return BeamState(step + 1, tokens, torch.where(is_eos, NEG_INF, new_scores),
                         fin_tokens, fin_scores, s.decs, trie_nodes)

    def body(s: BeamState) -> BeamState:
        step = s.step
        cur = s.alive_tokens[:, :, step].reshape(N)
        logits = decode(cur, step, s.decs).float()

        # trie constraints apply only past each row's own prefix
        trie_active_rows = (step >= row_plen) if prefix_len else None  # [N] or None (= all)
        trie_nodes_flat = s.trie_nodes.reshape(N) if trie is not None else None
        c_logits = _constrain_logits_pre(logits, gen_cfg, trie, trie_nodes_flat)
        logits = torch.where(trie_active_rows[:, None], c_logits, logits) if prefix_len else c_logits
        if gen_cfg.sampling:
            lprobs = torch.log_softmax(logits, dim=-1)  # true per-token log-probs
            at_max_eos = 0.0
        else:
            # the candidate domain: lprob + cumulative score, in this order
            Z = torch.logsumexp(logits, dim=-1, keepdim=True)
            alive_flat = s.alive_scores.reshape(N, 1)
            lprobs = logits - Z + alive_flat
            at_max_eos = alive_flat
        c_lprobs = _constrain_lprobs_post(lprobs, gen_cfg, trie, trie_nodes_flat)
        lprobs = torch.where(trie_active_rows[:, None], c_lprobs, lprobs) if prefix_len else c_lprobs

        if allowed_fn is not None:
            # additive 0/−inf mask on lprobs, no renormalization (ref: search.py:159-180)
            am = allowed_fn(step, s.alive_tokens.reshape(N, T))
            if am.shape[-1] < Vp:  # a mask over the unpadded vocab
                am = torch.nn.functional.pad(am, (0, Vp - am.shape[-1]))
            lprobs = torch.where(am, lprobs, NEG_INF)

        # prefix forcing (ref: _prefix_tokens :600-631)
        if prefix_tokens is not None:
            in_prefix = step < prefix_len and step < max_len
            if in_prefix:
                pt = ptok[:, step]  # [N]
                forced_lp = torch.gather(lprobs, 1, pt[:, None])
                forced = torch.where(iota_v[None, :] == pt[:, None], forced_lp, NEG_INF)
                lprobs = torch.where((pt != pad)[:, None], forced, lprobs)
            min_len_active = (step < min_thr) if not in_prefix else False
        else:
            min_len_active = step < min_thr
        # min length: no eos yet (additive, as the JAX search)
        lprobs = lprobs + torch.where(_as_rows(min_len_active, N, device)[:, None] & eos_col,
                                      NEG_INF, 0.0)

        lprobs = torch.where(lprobs.isnan(), NEG_INF, lprobs)
        lprobs = torch.where((iota_v == pad)[None, :], NEG_INF, lprobs)
        if gen_cfg.unk_penalty:
            lprobs = lprobs - torch.where((iota_v == unk)[None, :], gen_cfg.unk_penalty, 0.0)
        if (gen_cfg.gen_code or gen_cfg.gen_box) and step < max_len:
            # ban specials while generating (ref :389-390)
            lprobs = torch.where((iota_v < 4)[None, :], NEG_INF, lprobs)
        if gen_cfg.gen_box:
            # 4 bins then eos, repeating (ref :391-397)
            lprobs = torch.where((iota_v == Vp - 1)[None, :], NEG_INF, lprobs)
            cs = (gen_cfg.constraint_range[0] if gen_cfg.constraint_range
                  else cfg.vocab_size - cfg.num_bins)
            if (step + 1) % 5 == 0:
                ban = (iota_v >= cs) & (iota_v < cfg.vocab_size)
            else:
                ban = iota_v >= cfg.vocab_size
            lprobs = torch.where(ban[None, :], NEG_INF, lprobs)

        # max length: eos only; in the candidate domain the forced eos keeps
        # the hypothesis's cumulative score (ref :400-404; per-sentence :549)
        at_max = at_max_rows(step)
        if isinstance(at_max, torch.Tensor) or at_max:
            lprobs = torch.where(_as_rows(at_max, N, device)[:, None],
                                 torch.where(eos_col, at_max_eos, NEG_INF), lprobs)

        # lexical constraints: eos blocked until all constraints are met (additive)
        if constraints is not None:
            unfinished = (s.cons_ptr < cons_total[:, None]).reshape(N)
            lprobs = lprobs + torch.where(unfinished[:, None] & eos_col, NEG_INF, 0.0)

        if ngram > 0 and step + 2 - ngram >= 0:
            lprobs = _apply_no_repeat_ngram(lprobs, s.alive_tokens.reshape(N, T), step, ngram)

        if gen_cfg.sampling:
            return sampling_grow(s, lprobs, step, trie_active_rows)

        # ---- grow: top candidates per sentence over K·V scores
        cand_ptr = None
        if constraints is not None:
            # Post & Vilar dynamic beam allocation (ref: search.py:264-300):
            # global top-2K ∪ each beam's top-1 ∪ each beam's next constraint token
            cand = lprobs.view(B, K, Vp)
            row_sc, row_ix = top_k_stable(lprobs, 2 * K)
            sc2k, sel = top_k_stable(row_sc.reshape(B, K * 2 * K), 2 * K)
            beams2k = torch.div(sel, 2 * K, rounding_mode="floor")
            toks2k = torch.gather(row_ix.reshape(B, K * 2 * K), 1, sel)
            top1_sc = row_sc.view(B, K, 2 * K)[:, :, 0]
            top1_tok = row_ix.view(B, K, 2 * K)[:, :, 0]
            next_tok = torch.gather(cons_t, 1, s.cons_ptr.clamp_max(Cc - 1))  # [B, K]
            unf = s.cons_ptr < cons_total[:, None]
            forced_sc = torch.gather(cand, 2, next_tok[:, :, None])[..., 0]
            forced_sc = torch.where(unf, forced_sc, NEG_INF)
            beam_ids = torch.arange(K, device=device)[None].expand(B, K)
            topk_scores = torch.cat([sc2k, top1_sc, forced_sc], dim=1)  # [B, 4K]
            topk_beams = torch.cat([beams2k, beam_ids, beam_ids], dim=1)
            topk_toks = torch.cat([toks2k, top1_tok, next_tok], dim=1)
            # dedup: a per-beam top-1 or forced candidate may repeat an earlier one
            same = (topk_beams[:, None, :] == topk_beams[:, :, None]) & (
                topk_toks[:, None, :] == topk_toks[:, :, None])
            ar = torch.arange(4 * K, device=device)
            dup = (same & (ar[None, :] < ar[:, None])[None]).any(dim=2)
            topk_scores = torch.where(dup, NEG_INF, topk_scores)
            ptr_cand = torch.gather(s.cons_ptr, 1, topk_beams)
            cand_ptr = constraint_transition(cons_t, starts_t, cons_total, ptr_cand, topk_toks)
        elif G > 1:
            # grouped Hamming diversity (ref: models/search.py:551-618): group g
            # owns beams g::G and pays `strength` per earlier selection of a token
            if K % G:
                raise ValueError(f"beam {K} not divisible by groups {G}")
            Kg = K // G
            lp3 = lprobs.view(B, K, Vp)
            counts = torch.zeros((B, Vp), dtype=torch.float32, device=device)
            sc_l, bm_l, tk_l = [], [], []
            for g in range(G):
                cand_g = lp3[:, g::G] - gen_cfg.diversity_strength * counts[:, None, :]
                r_sc, r_ix = top_k_stable(cand_g, 2 * Kg)  # [B, Kg, 2Kg]
                sc_g, sel_g = top_k_stable(r_sc.reshape(B, Kg * 2 * Kg), 2 * Kg)
                tk_g = torch.gather(r_ix.reshape(B, Kg * 2 * Kg), 1, sel_g)
                sc_l.append(sc_g)
                bm_l.append(torch.div(sel_g, 2 * Kg, rounding_mode="floor") * G + g)
                tk_l.append(tk_g)
                counts = counts.index_put(
                    (torch.arange(B, device=device)[:, None].expand_as(tk_g), tk_g),
                    torch.ones_like(sc_g), accumulate=True)
            topk_scores = torch.cat(sc_l, dim=1)  # [B, 2K]
            topk_beams = torch.cat(bm_l, dim=1)
            topk_toks = torch.cat(tk_l, dim=1)
        elif gen_cfg.diversity_rate > 0:
            # sibling-rank penalty (ref: models/search.py:745-814)
            v_sc, v_ix = top_k_stable(lprobs.view(B, K, Vp), 2 * K)  # [B, K, 2K]
            penalty = gen_cfg.diversity_rate * torch.arange(
                1, 2 * K + 1, dtype=torch.float32, device=device)
            cand = v_sc - penalty[None, None, :]
            topk_scores, flat_ix = top_k_stable(cand.reshape(B, K * 2 * K), 2 * K)
            topk_beams = torch.div(flat_ix, 2 * K, rounding_mode="floor")
            topk_toks = torch.gather(v_ix.reshape(B, K * 2 * K), 1, flat_ix)
        else:
            # two-stage exact top-2K: per-row top-2K, then a merge over [B, K·2K]
            row_sc, row_ix = top_k_stable(lprobs, 2 * K)  # [N, 2K]
            topk_scores, sel = top_k_stable(row_sc.reshape(B, K * 2 * K), 2 * K)
            topk_beams = torch.div(sel, 2 * K, rounding_mode="floor")
            topk_toks = torch.gather(row_ix.reshape(B, K * 2 * K), 1, sel)

        cand_tokens = _gather_beams(s.alive_tokens, topk_beams)  # [B, 2K (4K), T]
        cand_tokens[:, :, step + 1] = topk_toks
        fin_scores, fin_tokens, is_eos = finish(s, cand_tokens, topk_toks, topk_scores, step)

        # ---- alive set: top-K non-eos candidates
        alive_cand = torch.where(is_eos, NEG_INF, topk_scores)
        if constraints is not None:
            # lexicographic (stripe rank asc, score desc): every bank keeps its best
            _, alive_idx = top_k_stable(stripe_key(cand_ptr, alive_cand), K)
            alive_scores = torch.gather(alive_cand, 1, alive_idx)
        elif G > 1:
            # group-local pruning keeps beams g::G owned by group g
            Kg = K // G
            a_sc, a_ix = [], []
            for g in range(G):
                lo = 2 * Kg * g
                top_sc, top_ix = top_k_stable(alive_cand[:, lo:lo + 2 * Kg], Kg)
                a_sc.append(top_sc)
                a_ix.append(top_ix + lo)
            # position kg*G+g holds group g's kg-th
            alive_scores = torch.stack(a_sc, dim=2).reshape(B, K)
            alive_idx = torch.stack(a_ix, dim=2).reshape(B, K)
        else:
            alive_scores, alive_idx = top_k_stable(alive_cand, K)
        src = torch.gather(topk_beams, 1, alive_idx)  # [B, K]

        trie_nodes = None
        if trie is not None:
            src_nodes = torch.gather(s.trie_nodes, 1, src).reshape(N)
            chosen = torch.gather(topk_toks, 1, alive_idx).reshape(N)
            nodes = trie.transition(src_nodes, chosen)
            if trie_active_rows is not None:
                nodes = torch.where(trie_active_rows, nodes, src_nodes)
            trie_nodes = nodes.view(B, K)
        cons_ptr = torch.gather(cand_ptr, 1, alive_idx) if constraints is not None else None
        return BeamState(step + 1, _gather_beams(cand_tokens, alive_idx), alive_scores,
                         fin_tokens, fin_scores, reorder(s.decs, (rows_of + src).reshape(N)),
                         trie_nodes, cons_ptr)

    step_fn = body_fast if fast else body
    while s.step <= max_len:
        # the JAX cond: can any alive beam still beat the worst finished one?
        best_alive = s.alive_scores.amax(dim=1) / length_norm(max_len)
        if not bool((best_alive > s.finished_scores.amin(dim=1)).any()):
            break
        s = step_fn(s)

    # a sentence with no finished hypothesis returns its best alive prefix,
    # terminated with eos (the JAX search's fallback)
    have_fin = s.finished_scores > NEG_INF / 2
    scores = torch.where(have_fin, s.finished_scores, s.alive_scores / length_norm(max_len))
    alive_terminated = s.alive_tokens.clone()
    alive_terminated[:, :, -1] = eos
    tokens = torch.where(have_fin[:, :, None], s.finished_tokens, alive_terminated)
    return tokens[:, :, 1:], scores


def generate(
    params,
    cfg: ModelConfig,
    gen_cfg: GenerationConfig,
    src_tokens: torch.Tensor,
    patch_images: Optional[torch.Tensor] = None,
    patch_masks: Optional[torch.Tensor] = None,
    prefix_tokens: Optional[torch.Tensor] = None,
    trie: Optional[DenseTrie] = None,
    constraints=None,
    allowed_fn: Optional[Callable] = None,
    rng: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """encode + beam_search.

    ``params`` may be a list of same-architecture parameter trees: ensemble
    decoding, each model encoding the batch itself (ref: EnsembleModel,
    models/sequence_generator.py:767-940). ``rng`` is passed to the search
    (sampling). → (tokens [B, K, max_len+1], normalized scores [B, K]).
    """
    models = list(params) if isinstance(params, (list, tuple)) else [params]
    encs = [ofa.encode(p, cfg, src_tokens, patch_images, patch_masks) for p in models]
    max_len = int(gen_cfg.max_len_a * src_tokens.shape[1] + gen_cfg.max_len_b)
    # per-sentence length constraints activate when a length slope is set
    src_lengths = ((src_tokens != cfg.pad).sum(dim=1)
                   if (gen_cfg.min_len_a or gen_cfg.max_len_a) else None)
    n = len(models)
    return beam_search(
        models if n > 1 else models[0], cfg, gen_cfg, encs if n > 1 else encs[0],
        max_len=max_len, prefix_tokens=prefix_tokens, trie=trie,
        code_masks_value=gen_cfg.gen_code, rng=rng, src_lengths=src_lengths,
        constraints=constraints, allowed_fn=allowed_fn, n_models=n,
    )
