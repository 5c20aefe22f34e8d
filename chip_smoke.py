#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``musketeer_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py
    python3 chip_smoke.py --train-only   # phases 1, 2 and 8 with its profiled step
    python3 chip_smoke.py --decode-only  # phases 1, 2, 4, 10, 11, 12, 5 and 13, and 15
    python3 chip_smoke.py --k8-only      # phases 1, 2 and 17
    python3 chip_smoke.py --eval-only    # phases 1, 2 and 18
    python3 chip_smoke.py --entry-only   # phases 1, 2 and 19
    python3 chip_smoke.py --xla-only     # phases 1, 2 and 20
    python3 chip_smoke.py --scst-only    # phases 1, 2 and 21
    python3 chip_smoke.py --parallel-only  # phases 1, 2 and 22
    python3 chip_smoke.py --multi-card   # phases 1, 2 and 23, on four cards
    python3 chip_smoke.py --multi-axes-only  # phases 1, 2 and 23 (c), on four cards
    python3 chip_smoke.py --axes-only    # phases 1, 2 and 24
    python3 chip_smoke.py --huge-only    # phases 1, 2 and 25 (ofa_huge, head dim 80)
    python3 chip_smoke.py --head-dims-only  # phases 1, 2 and 26 (head dims 8 to 128)
    python3 chip_smoke.py --shapes-only  # phases 1, 2 and 27 (beams, S, Tmax, d, D past today's)
    python3 chip_smoke.py --wide-heads-only  # phases 1, 2 and 28 (head dims 130 to 256)
    python3 chip_smoke.py --deep-heads-only  # phases 1, 2 and 29 (head dims 264 to 1280)
    python3 chip_smoke.py --k4-only      # phases 1, 2 and K3/K4 at head dims 64 and 80, timed
    python3 chip_smoke.py --instances-only  # phases 1, 2 and today's instances' device times
    python3 chip_smoke.py --instances-only --case "K3 B4 H2 T=S=980 D384"  # that case alone

``--train-only``, ``--decode-only``, ``--k8-only``, ``--k4-only`` and
``--instances-only`` also run against an older tree's package when this file
is copied into that tree's root, so that one call can time the training
step, or K2, K2-q8, K6, K7 and the caption slices, or K8, or K3/K4 at the
encoder train shape at head dims 64 and 80 (phase 7's and phase 25's calls),
or the device time of K1, K4, K6 and K7 at head dim 64, of K1, K3-K7 at 128
and 256, of K1, K3, K4, K5 at 192 and past 256, of both trees on one card;
they print no result line.

Phases; any failure raises and the script exits non-zero:

1. device: requires CUDA (never runs on the CPU) and prints ``nvidia-smi``'s
   name and power limit of the card;
2. build: compiles the kernels from ``musketeer_tpu_torch/csrc`` with nvcc,
   timed, and prints ptxas's registers and spills of the tensor-core
   kernels (``flash_fwd_sm90.cuh``: K1, K3, K5; ``flash_bwd_sm90.cuh``: K4's
   two launches; ``skinny_gemm_sm90.cuh``: K7's products, K2's
   ``proj_sm90_kernel`` and K2-q8's ``proj_q8_sm90_kernel``;
   ``decode_attn_sm90.cuh``: K7's cross-attention; ``decode_cross_attn.cu``:
   K6's ``cross_attn_i8_sm90_kernel``; ``bottleneck_sm90.cuh``: K8's
   ``mk::bneck::kernel``), and for each head-dim-80 instance of the
   attention kernels one line of its registers and spill bytes;
3. K1 (attention) against its plain PyTorch version at the caption encoder
   shape, and at small causal, cross (``rel=None``), ``skip_max`` and fully
   masked cases; in bf16 also against the function in fp32 on the same bf16
   inputs (the plain version on ``.float()`` inputs): the kernel's error may
   exceed the bf16 plain version's by at most one bf16 step of max|ref|;
4. K2 (projection + softmax stats) against its plain version at the beam
   decode shape: bf16 on the tensor-core route (its counter must move),
   also against the function in fp32 as in phase 3, the padded columns
   exactly -1e9; fp32 on the FMA kernel alone; the call, plain and bound
   times (CUDA events, as every kernel's), the kernel's own device time
   (``torch.profiler``; the wrapper's host time exceeds it), and one
   ``torch.matmul`` of the product alone as a yardstick;
5. the slice: ``ofa_base`` (random weights from a seed, random rel-pos tables
   and BatchNorm statistics) encodes 16 seeded 480² images with the caption
   prompt and beam-searches them (beam 5, 16 tokens, no repeated trigrams) in
   bf16, through the entry points a user calls; the launch counters must show
   6 K1 launches per encode and one K2 launch per beam step (the bf16
   tensor-core route's counter too); tokens and
   scores must be well formed; samples/s and p50 batch latency over a warm-up
   and 3 timed runs;
6. exactness: the same slice in float32 at batch 2, the second row's image
   masked out (a text-only row) so that the two rows' best hypotheses differ
   (asserted), once through the kernels and once through their plain
   versions: identical tokens, scores within 1e-4 of the largest (floored
   at 1);
7. K3 (training attention forward with logsumexp) and K4 (its backward, six
   gradients) against their plain versions at the encoder train shape
   (B4 H12 T=S=980, 10 % padded keys), a causal decoder shape (T=90) and a
   cross shape (T=90, S=990, ``rel=None``) in bf16, and at small cases in
   fp32 and bf16 (``skip_max``, a fully masked row, an odd batch, an odd S,
   a ragged T of two q tiles, cross with an odd S); every bf16 call also
   against the function in fp32, as in phase 3; the encoder call also
   timed without rel (and drel); then K4 on inputs saved from a training
   run (``K4_SAVED_CASE``), held as every case (within one bf16 step of the
   plain version's error against the fp32 function), its dq's distance
   printed in bf16 steps;
8. the training slice: the joint multi-task step of ``ofa_base`` in bf16 on
   8 tasks (the JAX bench's 9-task envelope without ``image_gen`` and with
   ``caption`` unsubsampled), batch 2 per task, R-Drop, label smoothing 0.1,
   drop-worst 0.2 after 6000 with the state at step 7000, AdamW as the bench
   sets it, through ``init_train_state`` and ``make_train_step``; one warm-up
   and 3 timed steps; the loss must be finite at every step and the
   parameters must move; in a step K1 runs 0 times and K3 and K4 each
   ``encoder_layers + 2 · decoder_layers`` times per transformer forward, the
   forwards counted from the step's packing groups; then one more step under
   ``torch.profiler`` (phase 15's training part): device time, device
   operations, busy share, and K3's and K4's kernel time and share;
9. training exactness: the step's loss and gradients in float32 on 2 tasks
   at batch 1, once through K3/K4 and once through their plain versions:
   loss and gradient norm to 1e-5 relative, every gradient leaf to 1e-3 of
   its largest |g|, floored at 1e-4 of the largest |g| of the whole tree (the
   key biases' exact gradient is zero: softmax ignores a shift shared by a
   row's scores, so both sides hold rounding noise there);
10. K2-q8 (K2 over the int8 projection with row scales) against its plain
    version at the beam decode shape (the real vocabulary's logits; the
    padded columns exactly -1e9): bf16 features on the tensor-core route
    (its counter must move), also against the function in fp32 as in phase
    3; fp32 features on the FMA kernel alone; the call, plain and bound
    times, the kernel's own device time and the call's device and host time;
11. K6 (a decode step of cross-attention over the int8 cache) against its
    plain version at B16 H12 Kb5 S908 in bf16 (10 % padded keys, the bias a
    strided view as the model passes it, one fully padded sample, which must
    give exact zeros) and small cases (S37, Kb 1 with S130, Kb 16): bf16 on
    the tensor-core route (its counter must move), also against the function
    in fp32; fp32 (S37) on the FMA kernel alone; timed as in phase 10;
12. K7 (all decoder layers of a step) against its plain version at rows 80
    (16 × 5), L6, d768, f3072, Tmax 17, S908, cache_index 0, 5 and 16, in
    bf16 (the tensor-core route; also against the function in fp32 as in
    phase 3) and fp32 (the FMA route); per index the kernel, plain and bound
    times and the device time by kernel (products, self-attention,
    cross-attention, copies; the tensor-core route's C call without
    programmatic dependent launch); then that C call with and without it,
    in turns;
13. the serving slices, the caption slice of phase 5 with the JAX package's
    serving options: A (int8: ``quantize_output_proj``, ``int8_cross_kv``,
    ``decode_int8_kv_kernel``) must launch K1 6 times per encode, K2-q8 once
    and K6 6 times per beam step, both on their tensor-core routes, K2 and K7
    never; B (``decode_stack_kernel``) K7 and K2 once per beam step, both on
    their tensor-core routes, K6 and K2-q8 never; tokens well formed;
    p50 batch latency and samples/s over 3 timed runs;
14. serving exactness: each serving slice in float32 at batch 2, as in
    phase 6;
15. profile: one run of the caption slice and of each serving slice under
    ``torch.profiler``: device operations per beam step, device time and the
    device's busy share;
16. K5, the JAX package's attention entry points (``musketeer_tpu_torch.ops``):
    its main path calls ``flash_attention_bias`` at the ``ofa_base`` encoder
    shape (B16 H12 S908 D64, bf16, rel [12, 908, 908], 10 % padded keys) and
    causal at B4 H12 S90, and ``flash_cross_attention`` at B4 H12 T90 S990,
    each once: 2 + 1 launches and nothing else; each against its plain
    version; small fp32 and bf16 cases: a fully masked sample, which must give
    sum(v) / Sp (Sp the JAX wrapper's padded key count), S not a multiple of
    block_q (also block_q 64), rel in fp32 with bf16 streams, an odd S (with
    rel in bf16 and in fp32, and cross); every bf16 call also against the
    function in fp32, as in phase 3; kernel, plain and
    ``scaled_dot_product_attention`` times, and each main call's device time
    under ``torch.profiler`` beside its host time;
17. K8, the fused ResNet bottleneck, on the path the JAX package's probe
    drives it (``probe_bottleneck.py``): ``ofa_base``'s ResNet-101 on 16
    seeded 480² images in bf16, the stem and each stage's first block through
    the port's model code, each stage's stride-1 blocks (2 at 120², 3 at 60²,
    22 at 30²) through ``fused_bottleneck``: exactly 27 K8 launches, all 27
    on the bf16 tensor-core route, and nothing else; each block against its
    plain version on the same input and against the function in fp32, as in
    phase 3; small cases in fp32 (the FMA kernel) and bf16 (the tensor-core
    route): ragged edges, an image smaller than one tile, widths not
    multiples of 64, layer3's widths, Wd 192 (a partial conv2 pass); the autograd
    Function's gradients against autograd through the unfused block; per
    stage, the kernel chain (CUDA events; its kernels' device time under
    ``torch.profiler`` and the wrapper calls' host time), the plain chain and
    the port's unfused cuDNN chain (what the model runs; no single library
    call; cuDNN's benchmark mode pinned on, 5 timings for a range, and the
    heuristic choice beside it);
18. the eval path: each task of ``musketeer_tpu_torch.tasks`` through its own
    ``evaluate`` at ``ofa_base`` in bf16, full width and depth, on a seeded
    TSV written to a temporary directory (PNG images, base64, at the task's
    size; without PIL each task's ``builder()`` returns seeded arrays at the
    builders' output shapes, and the phase says which ran): caption (32 rows,
    batch 16, 480², beam 5, 16 tokens: the fast path, K1 and K2), refcoco (16
    rows, 512²: the general body with ``gen_box`` and ``constraint_range``),
    snli_ve allcand (16 rows, 3 candidates: K1 in the encoder and the
    teacher-forced decoder), VQA with 64 answers through ``evaluate``
    (allcand) and ``evaluate_beam`` (trie + per-row prefix), gigaword (text
    only; its generation alone where ``rouge_score`` is missing); per task the
    K1 and K2 counters against its encodes, teacher-forced decodes and beam
    steps (nothing else launched), its metric, rows/s, and host against
    device time (``torch.profiler``); then each task at batch 2 in fp32
    through the kernels and through their plain versions: identical
    predictions (beam tokens, allcand picks, the task's output);
19. the entry points: ``ofa_base`` at full width and depth in bf16 with all
    four NormFormer options, their leaves drawn from a seed, written as a
    fairseq ``.pt`` by ``export_pt``; ``python -m musketeer_tpu_torch.cli
    convert`` on it in a process of its own; ``import_pt`` of the ``.pt`` and
    the converted checkpoint must give every leaf bit for bit; ``cli train``
    (in this process, through ``cli.main``) on seeded caption, vqa_gen and
    snli_ve TSVs at batch 2 each, uint8 transport, prefetch depth 2, from the
    ``.pt`` with EMA: 4 updates saving every 2, then a resumed run to 6 that
    must start at update 4; vqa_gen given its answer list (the CLI passes
    none); every task's loss in (0, 2 ln V] at every update; K3 and K4 each
    ``encoder_layers + 2 · decoder_layers`` times per transformer forward and
    nothing else launched; the loop's time per update (updates/s), the step
    call's, the share outside it, and each save's and the resume load's
    seconds; each K3 and K4 shape the loop reached, on its own inputs,
    against the plain version and the fp32 function, as in phase 7; a third
    run resumed from update 2's checkpoint to 4 against the straight run's
    state (parameters and EMA within 1e-3 of their change since update 2,
    the AdamW moments within 1e-3 of their norm); ``cli evaluate --task caption`` from ``checkpoint_last`` with
    ``--use-ema`` and from the ``.pt`` on a 32-row TSV at batch 16 with
    ``decode_stack_kernel`` forced on: the preset's (and the ``.pt``'s)
    ``use_flash_attention`` is False, as the JAX CLI runs it, so the encoder
    takes the XLA branch (6 calls per encode) and K1 is not launched; K2
    once per beam step on its tensor-core route, K7 never (the NormFormer
    model refuses it); rows/s; then the NormFormer caption slice in fp32 as
    in phase 6;
20. the XLA attention branch and the detection and pretraining tasks at
    ``ofa_base`` (6 + 6 layers, 768/3072, 12 heads, 480² images): (a) ``cli
    evaluate --task caption`` under the preset (XLA: K1 0, 6 XLA calls per
    encode, K2 per beam step) in bf16 and fp32, the fp32 tokens equal to the
    same run's with ``use_flash_attention=True`` and the scores within
    ``FP32_TOL`` · max|ref|, and one encode of the caption slice timed on
    each branch; ``DetectionTask.evaluate`` on 4 rows under the preset and
    with the flag (XLA calls or K1 per attention, K2 per beam step); each K1
    and K2 shape of the bf16 runs held to its plain version and the fp32
    function, as in phase 18; (b) the reference's joint recipe, 6 updates of
    ``train_loop`` (flash) on caption subsampled to 196 patches, pure_image
    (256 code targets) and detection at batch 2: each task's loss in
    (0, w · 2 ln V] (w its conf weight) at every update, K3 = K4 = 6 per
    encode that is not subsampled + 12 per decode, 6 XLA calls per
    subsampled encode, each K3 and K4 shape held to its plain version and the
    fp32 function as in phase 7, a second run from the same seed with
    bit-equal losses; then 2 updates of ``cli train --no-flash``: K3 = K4 =
    0; (c) one update each with attention dropout, encoder and decoder
    prompts (100), adapters (200), ``interpolate_position`` and
    ``train_bn``: the loss in range and finite gradients, the counters JAX's
    gates predict, each K3 and K4 shape held as in (b); then the fp32
    caption search with a decoder prompt through the kernels and their plain
    versions: equal tokens, K7 not launched;
21. SCST, CLIP-SCST and image generation at ``ofa_base`` (bf16, 6 + 6
    layers), with a seeded full-width CLIP ViT-B/16 and VQGAN (8192 codes,
    ch 128, ch_mult (1, 1, 2, 2, 4)) that the phase writes as upstream
    ``.pt`` files: (a) ``cli train --criterion scst`` on 6 seeded 480² caption
    rows (references ``a&&b``), batch 2, 5 sampled captions of up to 16
    tokens, 3 updates, saved at the epoch's end, with the raw mean CIDEr-D
    printed; (b) ``cli train --criterion clip_scst`` on seeded image_gen rows,
    2 updates (8 × 8 codes: the preset's code_image_size 128 // 16); (c) ``cli
    vqgan-encode`` over 256² PNGs and ``decode_code`` of its codes; (d)
    ``ImageGenTask.evaluate`` (beam 5, 256 codes) with CLIP and VQGAN, 2
    batches of 2; (e) ``cli train`` on caption + image_gen (1024 codes + eos,
    ``--tgt-bucket 1025``), 2 updates, each task's loss in (0, 2 ln V]; (f)
    the fp32 ``gen_code`` search (64 codes) through the kernels and their
    plain versions: equal codes. The counters of each part must equal the
    JAX gates' prediction (K1 once per encoder layer of each encode without
    autograd; K3 and K4 once per encoder layer and twice per decoder layer of
    each policy-gradient or training forward; nothing else), and each K1,
    K3 and K4 shape reached is held to its plain version and the fp32
    function, as in phases 7 and 18; each part's seconds and peak memory.

22. data-parallel training's pieces on one card: (a) the joint loader over
    the native TSV reader (g++): every fetch one batched C call
    (``NativeTsv.batch_calls``), the rows equal to the Python reader's;
    (b) the ``ofa_large`` joint step (bf16, phase 8's 8 tasks at batch 2 or
    the largest batch that fits without remat, dropout and drop-path 0.1)
    for 3 updates without and with ``--remat``: losses within ``BF16_TOL``,
    K3 twice and K4 once the launches without remat, a lower peak memory,
    both peaks and step times printed; (c) ``cli train`` (ofa_base,
    caption + snli_ve at 256², 10 updates) under ``python -m
    torch.distributed.run --nproc_per_node=1`` on NCCL and without a process
    group, both at once: the same loss at update 10 within ``BF16_TOL``,
    the checkpoints' bit-equal leaves counted; (d) MFU: ``utils/flops.py``'s
    FLOPs of phase 8's and phase 19's training steps and of (b)'s, over the
    step time and the card's dense bf16 peak (``PEAK_BF16``, by the name
    ``nvidia-smi`` reports); (e) ``musketeer_tpu_torch.examples.
    joint_training_demo`` in bf16: every task's metric improves, K3 = K4 > 0.

23. (``--multi-card`` only, on four cards) the mesh's axes over NCCL
    ranks, one per card: ``dryrun_multirank`` in each layout (data 4, fsdp
    4, 2 x 2, and the model, pipe and seq layouts of ``dryrun.AXES_LAYOUTS``:
    model 2 x fsdp 2, model 4, pipe 4, data 2 x pipe 2 interleaved, seq 4)
    against one card within 1e-5 in fp32, then phase 22 (b)'s ``ofa_large``
    step under ``--remat`` on one card and on four as data 4 and as fsdp 4:
    state bytes and peak memory per rank, step times, MFU; then (c)
    ``ofa_large`` bf16 ``--remat`` with dropout off at model 4, pipe 4
    (M = 4; M = 8 at 4 and at 8 rows a task), seq 4 and data 2 x pipe 2
    interleaved (V = 2), a spawn each with a time limit each, every rank
    printing its state (a pipe stage holds its own layers: the bytes must be
    what ``leaf_spec`` reckons), its steps and its peak memory as it goes,
    its K1/K3/K4 launches counted over the updates (K3 and K4 on every rank;
    none at seq 4, whose ring attention runs plain products),
    and where it waits (the pipeline's clock and collective, every thread's
    stack) while a step runs past a minute; each layout's losses within
    ``BF16_TOL`` of one card's on the same batch.
24. the model, pipe and seq axes at size 1 (``ofa_large`` bf16, 4 + 4
    layers): the plain step, the whole-mesh step at model 1, pipe 1 with
    M = 2 and with ``--remat``, seq 1, each within ``BF16_TOL`` of the plain
    step; the pipelined forward without autograd (K1 at B/M rows); one
    model rank's shard at model 4 (4 heads, ffn 1024); every K1/K3/K4 shape
    against its plain version and the fp32 function.
25. ``ofa_huge`` (d 1280, 16 heads of 80, 24 + 12 layers, ResNet (3, 8,
    36); random weights from a seed, as phase 5's tree): (a) the kernels at
    its shapes through the functions of phases 3, 4, 10, 11, 12, 7 and 16,
    with their checks, tolerances and times: K1 at B16 H16 T=S=908 D80 and
    small D80 cases (causal, cross, skip_max, a fully masked row, ragged T
    and S), K2 and K2-q8 at N80 D1280 (the row tile and how many times the
    weight streams printed), K6 at B16 H16 Kb5 S908 D80 and phase 11's small
    cases at D80, K7 at rows 80 L12 d1280 f5120 Tmax 17 S908 (cache_index 0,
    5, 16), K3/K4 at B4 H16 T=S=980, causal T90 and cross T90 S990 and phase
    7's small cases at D80 (without the saved D64 input), K5's main path at
    H16 D80 and its small cases at D80; (b) the caption slice and serving A
    and B at ``ofa_huge`` bf16, batch 16, beam 5, 16 tokens, 480² (K1 24
    times an encode, K2 or K2-q8 once and K6 12 times or K7 once a beam
    step; p50, samples/s, peak memory), one profiled run of each as phase
    15's, then each in fp32 at batch 2 through the kernels and their plain
    versions, as phases 6 and 14; (c) the 8-task joint step in bf16 under
    ``--remat``, a warm-up and 2 timed updates (losses finite, parameters
    moved, K3 2 x 48 and K4 48 per transformer forward; p50, peak memory,
    MFU) and one profiled as phase 8's, then phase 9's fp32 check at
    ``ofa_huge``. The default run starts phase 25 as ``--huge-only`` in a
    process of its own and reads its results from its ``[huge kernels]``
    line.
26. every head dim up to 128 (the instances 32, 64, 80, 128 of the
    attention kernels): (a) K1, K3/K4, K5, K6 and K7 at head dims 8, 16,
    20 (not a multiple of 8: the wrappers' zero-padded copies, counted),
    32, 48, 96, 112 and 128, each at an ``ofa_base``-wide shape (H ~ 768 /
    D) and small cases, held to its plain version and the fp32 function in
    the kind and tolerance of phases 3, 7, 11, 12 and 16, timed with its
    bound and SDPA's time; (b) ``ofa_base`` split into 6 heads of 128
    (``ofa_base_hd128``) and into 24 of 32 (``ofa_base_hd32``), full width
    and depth, seeded weights: the caption slice and serving A and B at
    bf16, batch 16, beam 5, 480², each then in fp32 at batch 2 through the
    kernels and their plain versions (phases 5, 6, 13, 14), phase 8's joint
    step (8 tasks x batch 2, profiled) and phase 9's fp32 check; every
    launch counter on its path. The default run starts phase 26 as
    ``--head-dims-only`` in a process of its own and reads its
    ``[head dims kernels]`` line.
27. the decode kernels at every beam count, encoder length, cache length
    and width the Pallas kernels take: (a) K6 and K7 at 17, 24 and 32 beams
    (S 908), at 16 and 24 beams with S 1772 (also at head dims 80 and 128),
    past the bf16 whole row's fit (K6 5 beams at S 4352, K7 at S 4928) and
    past the FMA route's (16 beams there); K7 at Tmax 2049 and 4096
    (cache_index 0, 2047, 2048, Tmax - 1) and at d 864 and 800 (L6, f 4d);
    K2 and K2-q8 at D 5120, 6144 and 8192 (N80, Vp59520); each in bf16 and
    fp32 against its plain version (bf16 also the fp32 function), its route
    counters (``.beam_tiled``, ``.chunked``, ``.cache_chunked``,
    ``.ragged``, ``.streamed``, ``.streamed_q8``) as its plan says, timed by
    CUDA events beside plain and the bound; (b) best-of-24 image generation
    (``ImageGenTask(sampling_times=24)``, two prompts, 256 codes, seeded
    ``ofa_base``) under serving B's and A's flags: the fp32 beam-24 search's
    codes equal to the plain versions', bf16 sampling's K6/K7 launches (on
    beam tiles), p50 and device time; the three caption slices at 672²
    (S 1772), batch 16, beam 16 as phases 5, 6, 13 and 14 (K6 and K7 on
    their score-chunked routes). The default run starts phase 27 as
    ``--shapes-only`` in a process of its own and reads its
    ``[shapes kernels]`` line; after phase 12 it checks that phases 4, 10,
    11 and 12 took none of these routes.
28. every head dim past 128 up to 256 (the instances 192 and 256: the bf16
    K1, K3, K4 and K5 on the pair route, one CTA building each score tile
    once for both column blocks of 128, counted in ``.pair``; K6's and K7's
    shallower rings, counted in ``.wide``): (a) phase 26 (a)'s calls at head
    dims 130 (not a multiple of 8), 136 and 200 (not of 16: K6's padded
    copy), 160, 192 and 256, at ~768 / D heads, each bf16 K1, K3, K4, K5
    call's plan beside its time (``_deep_plan_stats``: blocks a CTA, score
    builds per tile, bytes streamed); K6 and K7 at 256 past the bf16 whole row's fit (16
    beams, S 1772: the score-chunked route); K3/K4 at 256 on a causal case
    with a fully masked row; the instance and the routes checked from the
    counters; (b) ``ofa_base`` split into 4 heads of 192 (``ofa_base_hd192``)
    and into 3 of 256 (``ofa_base_hd256``) as phase 26 (b). The default run
    starts phase 28 as ``--wide-heads-only`` in a process of its own and
    reads its ``[wide heads kernels]`` line; after phases 12 and 16 it
    checks that phases 3-16 took no route past 128.
29. every head dim past 256 (the deep route: the head dim streamed through
    the products in chunks of 128 and each output's columns in blocks of
    128 over the grid, counted in ``.deep``): (a) phase 26 (a)'s calls at
    head dims 264, 300 (not a multiple of 8), 384, 520 (a short last chunk;
    264 and 520 not multiples of 16: K6's padded copy), 576, 768 and 1280,
    at ~768 / D heads, each with the fused backend SDPA takes there; K6 and
    K7 at 576 on the score-chunked route (16 beams, S 1772); K3/K4 at 384 on
    a causal case with a fully masked row; bf16 K1 and K4's device time a
    column block at 384 and 768; (b) ``ofa_base`` split into 2 heads of 384
    (``ofa_base_hd384``) and into 1 of 768 (``ofa_base_hd768``) as phase 26
    (b), K1, K3, K4, K6 and K7 on the deep route. The default run starts
    phase 29 as ``--deep-heads-only`` in a process of its own and reads its
    ``[deep heads kernels]`` line; phases 3-16 take no deep route.

The counters of every kernel are set to 0 just before each main path (the
caption slice, the training step, serving A, serving B, K5's calls, the K8
stage chain, each eval task, each CLI run of phase 19, each part of phases
20 and 21, each run of phase 24, phase 25's slices, K5 calls and timed
updates, and phases 26's, 28's and 29's slices and steps) and read just after. The new phases' bf16 checks allow 2⁻⁶ of
the reference's largest magnitude, their fp32 checks 1e-4 of it (floored at 1).

Prints a JSON line of the ten kernel entry points (K1–K8, K5 twice: launches
on their main path, error against the plain version, kernel, plain and
library times, the bound of the same work on an H100 SXM at 3.35 TB/s and
989 TFLOP/s bf16; K8's times are the 27-block chain's, with the cuDNN chain
as ``cudnn_block_ms`` (the median; ``cudnn_block_ms_range`` its range) and
the kernels' device time and the calls' host time as ``device_ms`` and
``host_ms``; for K2, K2-q8 and K6 the kernel's own device time as
``device_ms`` and the wrapper call's host time as ``host_ms``), then as its
last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
K1's and K2's entries also carry ``eval_launches``: their launches in each
eval task of phase 18; K1's, K2's, K3's and K4's ``entry_launches``: theirs
in each CLI run of phase 19, and ``xla_phase_launches``: theirs in each part
of phase 20; K1's, K3's and K4's ``scst_phase_launches``: theirs in each part
of phase 21; K3's and K4's ``remat_launches``: theirs in phase 22's updates
without and with ``--remat``; K1's, K3's and K4's ``axes_launches``: theirs
in each run of phase 24. Each of K1, K3–K7 (K5 twice) also carries ``hd80``,
and K2 and K2-q8 ``d1280``: phase 25's error, times, bound and library time
at ``ofa_huge``'s shapes and the launches on its main paths; and
``head_dims``: phase 26's and 28's, by head dim (its instance in
``instance``; the launches on the path of the configuration of that head
dim, 0 where no configuration has it; K6's and K7's score-chunked cases at
256 under ``"256 <shape> <dtype>"``); K2's, K2-q8's, K6's and K7's ``shapes``: phase
27's cases (error, times, bound, the routes they took), their launches on
the 672² caption paths and (K6, K7) on best-of-24 image generation.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import torch

# " what does the image describe?" with bos/eos: default_vocab().encode_text(
# prompt, append_bos=True, append_eos=True) (phase 18 runs the tokenizer)
PROMPT_IDS = [0, 99, 473, 5, 2274, 6190, 116, 2]
SEED = 0
BATCH, BEAM, MAX_LEN, IMAGE = 16, 5, 16, 480
K1_SHAPE = dict(B=16, H=12, T=908, S=908, D=64)  # 900 patches + 8 prompt tokens
K2_SHAPE = dict(N=BATCH * BEAM, D=768, Vp=59520, vocab_size=59457)
K6_SHAPE = dict(B=BATCH, H=12, Kb=BEAM, S=908, D=64)
K7_SHAPE = dict(L=6, B=BATCH, Kb=BEAM, H=12, f=3072, Tmax=MAX_LEN + 1, S=908)
K7_INDICES = (0, 5, 16)
# the card's published peaks (H100 SXM data sheet, dense): bytes and bf16 operations per ms
HBM_BYTES_PER_MS = 3.35e12 / 1e3
BF16_OPS_PER_MS = 989e12 / 1e3
# bf16 tolerances: the kernel and the plain version round the probabilities
# (K1) or the logits (K2) to bf16 after fp32 sums taken in different orders,
# so a value may land one or two bf16 steps apart: 2**-7 relative to the
# output's magnitude
BF16_TOL = 2.0 ** -7 * 2
FP32_TOL = 1e-4  # fp32: different summation orders only
# the fp32 outputs of bf16 calls (K4's drel): None holds them to FP32_TOL, as
# phases 7 and 26 do; phase 28 sets 1e-4 (see WH_DREL_TOL)
BF16_FP32_OUT_TOL = None
# the reference of the fp32 calls of K1, K3, K4 and K5: False, the fp32 plain
# version; True (phase 29), the function evaluated in fp64 (the plain version
# on the inputs widened to fp64), whatever the tolerance: past head dim 256
# the fp32 plain version's own rounding of the 2 D-deep scores reaches the
# 1e-5 of max|ref| that the fp32 calls are held to (see F64_NOTE)
FP32_REF_F64 = False
F64_NOTE = ("the fp32 plain version against the same fp64 function: max abs err {:.3e}")
# K3/K4 at the training step's attention shapes (R-Drop doubles batch 2)
K34_SHAPES = {
    "encoder": dict(shape=dict(B=4, H=12, T=980, S=980, D=64)),
    "decoder causal": dict(shape=dict(B=4, H=12, T=90, S=90, D=64), causal=True),
    "cross rel=None": dict(shape=dict(B=4, H=12, T=90, S=990, D=64), rel=False),
}
# small K3/K4 cases, each in fp32 and bf16
K34_SMALL = {
    "skip_max": dict(shape=dict(B=2, H=2, T=70, S=70, D=64), skip_max=True),
    "fully masked row": dict(shape=dict(B=2, H=2, T=33, S=33, D=64), masked_row=1),
    "odd batch causal": dict(shape=dict(B=3, H=2, T=41, S=41, D=64), causal=True),
    # odd S: rel's scalar loads and a ragged last key tile
    "odd S": dict(shape=dict(B=2, H=2, T=67, S=67, D=64)),
    "ragged T, two q tiles": dict(shape=dict(B=2, H=2, T=70, S=70, D=64)),
    "cross, odd S": dict(shape=dict(B=2, H=2, T=33, S=67, D=64), rel=False),
}
GRAD_NAMES = ("dq", "dk", "dv", "dpos_q", "dpos_k", "drel")
# K4's inputs at one batch row and head of a call of phase 19's ``cli train``
# (B2 H12 T232 S232, causal, rel, bf16), saved from a run whose encoder summed
# the image positions' gradient in another order: with dW rounded once to
# bf16 as the operand of dq's product, K4's dq there (on an H100) was 1.78
# bf16 steps of max|dq| from the fp32 function, the plain version's 0.49,
# more than the one step that ``_check_function`` allows over plain; dq and
# dpos_q now take dW in two bf16 parts, and phase 7 holds this input as every
# case
K4_SAVED_CASE = "chip_smoke_cases/k4_causal_t232.pt"
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
# K5's main path: flash_attention_bias at the encoder shape and causal,
# flash_cross_attention (no rel) at a decoder cross shape; bf16
K5_SHAPES = {
    "encoder": dict(shape=dict(B=16, H=12, T=908, S=908, D=64)),
    "causal": dict(shape=dict(B=4, H=12, T=90, S=90, D=64), causal=True),
    "cross": dict(shape=dict(B=4, H=12, T=90, S=990, D=64), cross=True),
}
# small K5 cases, each in fp32 and bf16 (rel_f32: bf16 only)
K5_SMALL = {
    "fully masked sample": dict(shape=dict(B=2, H=2, T=70, S=70, D=64), masked_row=1),
    "causal, masked sample": dict(shape=dict(B=2, H=2, T=70, S=70, D=64), causal=True,
                                  masked_row=0),
    "block_q 64": dict(shape=dict(B=3, H=2, T=100, S=100, D=64), block_q=64),
    "cross, masked sample": dict(shape=dict(B=2, H=2, T=33, S=70, D=64), cross=True,
                                 masked_row=1),
    "rel fp32": dict(shape=dict(B=2, H=2, T=70, S=70, D=64), rel_f32=True),
    # odd S: rel's rows are not pair-aligned, so the bf16 core reads them
    # column by column, and the last key tile is ragged by an odd count
    "odd S": dict(shape=dict(B=2, H=2, T=67, S=67, D=64)),
    "odd S, rel fp32": dict(shape=dict(B=2, H=2, T=67, S=67, D=64), rel_f32=True),
    "cross, odd S": dict(shape=dict(B=2, H=2, T=33, S=67, D=64), cross=True, masked_row=0),
}


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
    text = _build.ptxas_log().read_text()
    for line in _ptxas_lines(text):
        log(f"[build] ptxas {line}")
    for name, regs, stores, loads in _ptxas_deep(text):
        # fwd_deep, bwd_kv_deep and bwd_q_deep on the pair route's CTA (2 blocks) or the deep's
        route = "pair route" if PAIR_KERNEL_MARK in name and "4sm90" in name else "deep route"
        log(f"[build] {route}: {name}: {regs} registers, {stores} bytes spill stores, "
            f"{loads} bytes spill loads")
    for dp, name, regs, stores, loads in _ptxas_instances(text):
        log(f"[build] instance {dp}: {name}: {regs} registers, {stores} bytes spill stores, "
            f"{loads} bytes spill loads")
    return secs


# the mangled names of the deep route's kernels (common.cuh::DEEP, the
# instance 0 of the templates on the tile width, and the kernels of their own:
# fwd_deep, bwd_kv_deep, bwd_q_deep, self_attn_deep, flash_deep's)
DEEP_KERNEL_NAMES = ("11decode_attn6kernelILi0E",
                     "10cross_attn6kernelILi0E", "cross_attn_i8_sm90_kernelILi0E", "_deep",
                     "10flash_deep")
# the end of the template arguments of fwd_deep, bwd_kv_deep and bwd_q_deep on
# a CTA of PW = 2 block warpgroups (the pair route, head dims 129 to 256)
PAIR_KERNEL_MARK = "Li2EEEv"


def _ptxas_deep(text: str) -> list:
    """ptxas's registers and spills of each deep-route kernel → [(mangled
    name, registers, spill stores, spill loads)]."""
    out, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = line.split("'")[1] if "'" in line else line
            name = m if any(k in m for k in DEEP_KERNEL_NAMES) else None
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = tuple(nums[1:3])
        elif name and "Used" in line and "registers" in line:
            if all(o[0] != name for o in out):  # a kernel built in two sources
                out.append((name, int(line.split("Used")[1].split()[0]), *spills))
            name = None
    return out


# substrings of the mangled names of the tensor-core kernels: the attention
# cores (mk::sm90), the weight-streaming products (mk::skinny, K7; K2's
# proj_sm90_kernel, K2-q8's proj_q8_sm90_kernel), K7's cross-attention
# (mk::decode_attn), K6's cross_attn_i8_sm90_kernel and K8's mk::bneck::kernel
TENSOR_CORE_KERNELS = ("sm90", "skinny", "decode_attn", "bneck")


def _ptxas_lines(text: str) -> list:
    """ptxas's lines on the tensor-core attention core's entry functions (those
    whose mangled names hold ``sm90``): each entry's name, then its registers
    and spills; and every line that names wgmma or GMMA (where ptxas
    serialises the products or injects waits around them)."""
    out, ours = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            ours = any(k in line for k in TENSOR_CORE_KERNELS)
            if ours:
                out.append(line.strip())
        elif "wgmma" in line or "GMMA" in line or (
                ours and ("registers" in line or "spill" in line)):
            out.append(line.strip())
    return out


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _as_f32(x: dict) -> dict:
    """The same inputs with every floating tensor widened to fp32."""
    return {n: t.float() if t is not None and t.is_floating_point() else t for n, t in x.items()}


def _as_f64(x: dict) -> dict:
    """The same inputs with every floating tensor widened to fp64."""
    return {n: t.double() if t is not None and t.is_floating_point() else t for n, t in x.items()}


def _widened64(args) -> list:
    """The same arguments with every floating tensor widened to fp64."""
    return [t.double() if torch.is_tensor(t) and t.is_floating_point() else t for t in args]


def _check_function(name: str, out: torch.Tensor, plain: torch.Tensor, fn: torch.Tensor,
                    ref: str = "plain") -> str:
    """A bf16 kernel against the function in fp32 on the same bf16 inputs: its
    max error may exceed the bf16 plain version's (or another reference's,
    named by ``ref``) by at most one bf16 step of max|ref|, so that a new
    summation order cannot drift unseen."""
    top = float(fn.abs().max())
    step = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    e_k, e_p = _max_err(out, fn), _max_err(plain, fn)
    if not e_k <= e_p + step:
        raise AssertionError(f"{name}: max abs err against the fp32 function {e_k:.3e} > "
                             f"{ref}'s {e_p:.3e} + one bf16 step {step:.3e}")
    return f"against the fp32 function {e_k:.3e} ({ref} {e_p:.3e}, step {step:.3e})"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(nbytes: float, ops: float) -> dict:
    """The least time of the work on the card: bytes over the memory rate or
    operations over the bf16 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, ops / BF16_OPS_PER_MS
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def _check_close(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """Max abs error, which must be ≤ tol · max(1, max|ref|), on finite outputs."""
    err = _max_err(out, ref)
    lim = tol * max(1.0, float(ref.float().abs().max()))
    if not (err <= lim and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{name}: max abs err {err:.3e} > {lim:.3e} (or not finite)")
    return err


def _sdpa_inputs(x: dict):
    """K1/K3's inputs as one scaled_dot_product_attention call: [q|pos_q]·[k|pos_k]
    with rel and the padding (−1e9) as a float mask, scale 1."""
    (B, H, T, _), S = x["q"].shape, x["k"].shape[2]
    # the memory-efficient kernel wants the mask's row stride a multiple of 8:
    # a view of a wider buffer
    mask = torch.zeros((B, H, T, -(-S // 8) * 8), dtype=x["q"].dtype, device=x["q"].device)
    mask = mask[..., :S]
    mask += x["kpad"][:, None, None, :].to(mask.dtype) * -1e9
    if x["rel"] is not None:
        mask += x["rel"][None, :, :T, :S]
    return (torch.cat([x["q"], x["pos_q"]], -1), torch.cat([x["k"], x["pos_k"]], -1),
            x["v"], mask)


def _library_ms(name: str, fn, iters: int = 10):
    """The time of one PyTorch library call computing the kernel's function, or
    None where the library refuses these inputs."""
    try:
        ms = cuda_ms(fn, iters)
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"[{name}] library call refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}")
        return None
    log(f"[{name}] library call {ms:.3f} ms")
    return ms


# the bf16 tensor-core routes counted apart from their kernel's other launches
SM90_ROUTES = frozenset({"K2-sm90", "K2-q8-sm90", "K6-sm90", "K7-sm90", "K8-sm90"})


def _counter_owners(routes: frozenset = SM90_ROUTES) -> dict:
    """Each kernel's wrapper and the attribute that counts its launches; of the
    bf16 tensor-core routes' counters only those in ``routes`` (an older tree,
    run by ``--decode-only``, ``--train-only`` or ``--k8-only``, lacks some);
    and ``XLA``, the calls of the model's XLA attention branch, where the tree
    has that branch."""
    from musketeer_tpu_torch.ops import bottleneck as k8
    from musketeer_tpu_torch.ops import decode_cross_attn as k6
    from musketeer_tpu_torch.ops import decode_stack as k7
    from musketeer_tpu_torch.ops import flash_attention as k5
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.ops import topk_projection as k2

    from musketeer_tpu_torch.models import ofa

    owners = {"K1": (k1.flash_attention_inference, "launches"),
              "K2": (k2.project_with_stats, "launches"),
              "K2-sm90": (k2.project_with_stats, "launches_sm90"),
              "K2-q8": (k2.project_with_stats, "launches_q8"),
              "K2-q8-sm90": (k2.project_with_stats, "launches_q8_sm90"),
              "K3": (kb.flash_attention_fwd, "launches"),
              "K4": (kb.flash_attention_bwd, "launches"),
              "K5": (k5.flash_attention_bias, "launches"),
              "K5-cross": (k5.flash_cross_attention, "launches"),
              "K6": (k6.decode_cross_attention_int8, "launches"),
              "K6-sm90": (k6.decode_cross_attention_int8, "launches_sm90"),
              "K7": (k7.decode_stack_step, "launches"),
              "K7-sm90": (k7.decode_stack_step, "launches_sm90"),
              "K8": (k8.fused_bottleneck, "launches"),
              "K8-sm90": (k8.fused_bottleneck, "launches_sm90")}
    if hasattr(ofa, "xla_attention"):  # the XLA branch's attention calls (no kernel)
        owners["XLA"] = (ofa.xla_attention, "calls")
    return {k: v for k, v in owners.items() if k in routes or k not in SM90_ROUTES}


def _sm90_routes() -> frozenset:
    """The bf16 tensor-core routes this tree counts apart: ``--train-only``,
    ``--decode-only`` and ``--k8-only`` ask, since they also run against older
    trees; the full run requires them all."""
    owners = _counter_owners()
    return frozenset(k for k in SM90_ROUTES if hasattr(*owners[k]))


def _counters(routes: frozenset = SM90_ROUTES) -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counter_owners(routes).items()}


def _reset_counters(routes: frozenset = SM90_ROUTES) -> None:
    for fn, attr in _counter_owners(routes).values():
        setattr(fn, attr, 0)


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


def phase_k1(g, shape: dict = K1_SHAPE) -> dict:
    """K1 at ``shape`` (B, H, T = S, D) and at small cases of its head dim."""
    from musketeer_tpu_torch.ops import flash_attention_infer as k1

    names = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")
    x = _k1_inputs(g, **shape, dtype=torch.bfloat16)
    args = [x[n] for n in names]
    out = k1.flash_attention_inference(*args)
    ref = k1.flash_attention_plain(*args)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    tol = BF16_TOL * max(1.0, float(ref.float().abs().max()))
    fn_msg = _check_function("K1", out, ref, k1.flash_attention_plain(
        *(_as_f32(x)[n] for n in names)))
    log(f"[K1] B{shape['B']} H{shape['H']} T=S={shape['T']} D{shape['D']} bf16: max abs err "
        f"{err:.3e} (tol {tol:.3e}); {fn_msg}")
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"K1 disagrees with its plain version: {err} > {tol}")
    ms = cuda_ms(lambda: k1.flash_attention_inference(*args), 10)
    plain_ms = cuda_ms(lambda: k1.flash_attention_plain(*args), 10)
    no_rel = args[:5] + [None, x["kpad"]]  # what reading rel costs the kernel
    log(f"[K1] kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per call; the kernel without rel "
        f"{cuda_ms(lambda: k1.flash_attention_inference(*no_rel), 10):.3f} ms")
    B, H, T, D = x["q"].shape
    bound = _bound(_nbytes(*args, out), 6.0 * B * H * T * x["k"].shape[2] * D)
    qc, kc, v, mask = _sdpa_inputs(x)
    library_ms = _library_ms("K1", lambda: torch.nn.functional.scaled_dot_product_attention(
        qc, kc, v, attn_mask=mask, scale=1.0))
    del x, args, out, ref, qc, kc, v, mask

    D = shape["D"]
    cases = {
        "causal": dict(shape=dict(B=2, H=2, T=100, S=100, D=D), causal=True),
        "cross rel=None": dict(shape=dict(B=2, H=2, T=17, S=130, D=D), rel=False),
        "skip_max": dict(shape=dict(B=2, H=2, T=70, S=70, D=D), skip_max=True),
        "fully masked row": dict(shape=dict(B=2, H=2, T=33, S=33, D=D), masked_row=1),
    }
    if D != K1_SHAPE["D"]:  # ragged T and S: a partial q tile, an odd key tile
        cases["ragged T and S"] = dict(shape=dict(B=2, H=2, T=70, S=67, D=D))
    for name, c in cases.items():
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            xs = _k1_inputs(g, **c["shape"], dtype=dtype, rel=c.get("rel", True),
                            masked_row=c.get("masked_row"))
            kw = dict(causal=c.get("causal", False), skip_max=c.get("skip_max", False))
            a = k1.flash_attention_inference(*(xs[n] for n in names), **kw)
            b = k1.flash_attention_plain(*(xs[n] for n in names), **kw)
            fn_msg = ""
            if dtype == torch.float32 and FP32_REF_F64:
                b64 = k1.flash_attention_plain(*(_as_f64(xs)[n] for n in names), **kw)
                fn_msg, b = "; against the fp64 function; " + F64_NOTE.format(_max_err(b, b64)), b64
            e = _max_err(a, b)
            if dtype == torch.bfloat16:
                fn_msg = "; " + _check_function(f"K1 {name}", a, b, k1.flash_attention_plain(
                    *(_as_f32(xs)[n] for n in names), **kw))
            log(f"[K1] {name} D{D} {str(dtype)[6:]}: max abs err {e:.3e}{fn_msg}")
            if not e <= tol * max(1.0, float(b.float().abs().max())):
                raise AssertionError(f"K1 {name} {dtype}: {e}")
            if "masked_row" in c:
                mean_v = xs["v"][1].float().mean(dim=1, keepdim=True).expand_as(b[1])
                if _max_err(a[1], mean_v) > tol:
                    raise AssertionError("K1: a fully masked row must give the mean of v")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)


def _timings(tag: str, call, plain, kernel: str, iters: int = 20) -> dict:
    """A kernel wrapper's call time by CUDA events (``ms``), its kernel's own
    device time (``device_ms``, torch.profiler), the call's device and host
    time (``_device_host_ms``), and the plain version's time by events. At a
    few hundredths of a ms the wrapper's host time can exceed the kernel's,
    and CUDA events then time the host."""
    ms = cuda_ms(call, iters)
    device_ms = _device_ms_by_kernel(call, iters)[kernel]
    dev_ms, host_ms = _device_host_ms(call, iters)
    plain_ms = cuda_ms(plain, iters)
    log(f"[{tag}] kernel {ms:.4f} ms per call by CUDA events ({kernel} {device_ms:.4f} ms of "
        f"device time; the whole call {dev_ms:.4f} ms of device and {host_ms:.4f} ms of host "
        f"time), plain {plain_ms:.3f} ms per call")
    return dict(ms=ms, device_ms=device_ms, host_ms=host_ms, plain_ms=plain_ms)


def phase_k2(g, routes: frozenset = SM90_ROUTES, shape: dict = K2_SHAPE) -> dict:
    """K2 at the beam decode shape; ``routes`` without ``K2-sm90`` only for an
    older tree, whose bf16 K2 has no tensor-core route (``--decode-only``)."""
    from musketeer_tpu_torch.ops import topk_projection as k2

    N, D, Vp, vs = (shape[k] for k in ("N", "D", "Vp", "vocab_size"))
    h = torch.randn(N, D, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(Vp, D, generator=g, device="cuda") * D ** -0.5).to(torch.bfloat16)
    w[vs:] = 0
    sm90 = "K2-sm90" in routes
    before = _counters(routes)
    out = k2.project_with_stats(h, w, vocab_size=vs)
    ref = k2.project_plain(h, w, vocab_size=vs)
    torch.cuda.synchronize()
    if sm90 and _counters(routes)["K2-sm90"] != before["K2-sm90"] + 1:
        raise AssertionError("K2: a bf16 call must run the tensor-core kernel")
    # the logits of the real vocabulary (the padded columns are -1e9 on both sides,
    # checked below, and would set the tolerance)
    real = lambda t: t[:, :vs]
    errs = {name: _max_err(a, b) for name, a, b in
            zip(("logits", "bmax", "Z"), (real(out[0]), *out[1:]), (real(ref[0]), *ref[1:]))}
    fn_msg = _check_function("K2 logits", real(out[0]), real(ref[0]),
                             real(k2.project_plain(h.float(), w.float(), vocab_size=vs)[0]))
    log(f"[K2] N{N} Vp{Vp} D{D} bf16: max abs err logits {errs['logits']:.3e} "
        f"bmax {errs['bmax']:.3e} Z {errs['Z']:.3e}; logits {fn_msg}")
    logit_tol = BF16_TOL * max(1.0, float(real(ref[0]).float().abs().max()))
    if not (errs["logits"] <= logit_tol and errs["bmax"] <= FP32_TOL and errs["Z"] <= FP32_TOL):
        raise AssertionError(f"K2 disagrees with its plain version: {errs}")
    if not bool((out[0][:, vs:] == k2.NEG_INF).all()):
        raise AssertionError("K2: padded vocab columns must be -1e9")
    mid = _counters(routes)
    a = k2.project_with_stats(h.float(), w.float(), vocab_size=vs)
    b = k2.project_plain(h.float(), w.float(), vocab_size=vs)
    e = max(_max_err(x, y) for x, y in zip(a, b))
    log(f"[K2] fp32 (FMA kernel): max abs err {e:.3e}")
    if not e <= FP32_TOL or _counters(routes) != {**mid, "K2": mid["K2"] + 1}:
        raise AssertionError(f"K2 fp32: err {e}, or it did not run the FMA kernel alone")
    times = _timings("K2", lambda: k2.project_with_stats(h, w, vocab_size=vs),
                     lambda: k2.project_plain(h, w, vocab_size=vs),
                     "proj_sm90_kernel" if sm90 else "proj_stats_kernel")
    # a yardstick only: the product alone, no statistics (no one call gives them)
    matmul_ms = cuda_ms(lambda: torch.matmul(h, w.t()), 20)
    work = _bound(_nbytes(h, w, *out), 2.0 * N * Vp * D)
    log(f"[K2] bound {work['bound_ms']:.4f} ms ({work['bound_by']}); torch.matmul of the "
        f"product alone {matmul_ms:.4f} ms")
    return dict(max_abs_err=errs["logits"], library_ms=None, **times, **work)


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


# the caption slice and its two serving variants: model options,
# search options, whether the int8 output projection is used
SLICES = {
    "slice": dict(model={}, gen={}, q8=False),
    "serving A": dict(model=dict(decode_int8_kv_kernel=True), gen=dict(int8_cross_kv=True),
                      q8=True),
    "serving B": dict(model=dict(decode_stack_kernel=True), gen={}, q8=False),
}


def _slice_setup(tree, name: str, dtype: str, model: dict = None, arch: str = "ofa_base"):
    from musketeer_tpu_torch.config import ARCH_PRESETS, GenerationConfig
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.params import from_jax

    spec = SLICES[name]
    cfg = dataclasses.replace(ARCH_PRESETS[arch](), dtype=dtype, use_flash_attention=True,
                              **spec["model"], **(model or {}))
    params = from_jax(tree, cfg, "cuda", getattr(torch, dtype))
    if spec["q8"]:
        params = ofa.quantize_output_proj(params)
    gen_cfg = GenerationConfig(beam_size=BEAM, max_len_b=MAX_LEN, min_len=1, no_repeat_ngram_size=3,
                               **spec["gen"])
    return cfg, params, gen_cfg


def _expected_launches(name: str, cfg, steps: int, routes: frozenset = SM90_ROUTES) -> dict:
    """Each kernel's launches in one encode + beam search of the slice."""
    want = dict.fromkeys(_counter_owners(routes), 0)
    want["K1"] = cfg.encoder_layers
    if name == "serving A":
        want.update({"K2-q8": steps, "K6": cfg.decoder_layers * steps})
    elif name == "serving B":
        want.update({"K2": steps, "K7": steps})
    else:
        want["K2"] = steps
    if cfg.dtype == "bfloat16":  # bf16 K2, K2-q8, K6 and K7 on the tensor cores
        want.update({r: want[r[:-len("-sm90")]] for r in routes})
    return want


def phase_slice(tree, smi: str, name: str, routes: frozenset = SM90_ROUTES,
                arch: str = "ofa_base", model: dict = None) -> dict:
    """One main path: encode + beam search of the slice in bf16, counted and
    timed (``routes`` as in ``phase_k2``; ``model``: options the tree was made
    with, such as another head count)."""
    from musketeer_tpu_torch.models import ofa

    cfg, params, gen_cfg = _slice_setup(tree, name, "bfloat16", model, arch)
    src, images, masks = _inputs(BATCH, SEED)
    what = arch + "".join(f" {k}={v}" for k, v in (model or {}).items())
    tag = f"[{name}]" if what == "ofa_base" else f"[{what} {name}]"

    torch.cuda.reset_peak_memory_stats()
    _caption(params, cfg, gen_cfg, src, images, masks)  # warm-up
    _reset_counters(routes)
    with mock.patch.object(ofa, "decode_step", wraps=ofa.decode_step) as steps:
        enc, tokens, scores = _caption(params, cfg, gen_cfg, src, images, masks)
    launches = _counters(routes)
    log(f"{tag} launches {launches}, beam steps {steps.call_count}")
    want = _expected_launches(name, cfg, steps.call_count, routes)
    if not (1 <= steps.call_count <= MAX_LEN + 1 and launches == want):
        raise AssertionError(f"{name}: launches {launches} over {steps.call_count} steps, "
                             f"expected {want}")
    S = (IMAGE // 16) ** 2 + len(PROMPT_IDS)  # the patches and the prompt tokens
    if tuple(enc.x.shape) != (BATCH, S, cfg.embed_dim) or not bool(torch.isfinite(enc.x).all()):
        raise AssertionError(f"encoder output must be finite [{BATCH}, {S}, {cfg.embed_dim}]")
    _check_tokens(tokens, scores, cfg, BATCH)
    log(f"{tag} first hypothesis: {tokens[0, 0].tolist()} score {float(scores[0, 0]):.4f}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _caption(params, cfg, gen_cfg, src, images, masks)
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    log(f"{tag} {what} bf16 batch {BATCH} beam {BEAM} {IMAGE}²: p50 batch latency "
        f"{p50 * 1e3:.1f} ms, {BATCH / p50:.2f} samples/s (runs {[round(t * 1e3, 1) for t in times]} ms) "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    return launches


def phase_exactness(tree, name: str, model: dict = None, arch: str = "ofa_base") -> None:
    """The slice in fp32 at batch 2 through the kernels and through their plain
    versions: identical tokens, scores within ``FP32_TOL`` · max(1, max|ref|)
    (``model``: options the tree was made with, such as NormFormer's). The
    second row has its image masked out, as a text-only row: the seeded
    ResNet maps any two images to nearly the same features, so two images
    alone decode the same tokens; the two rows' best hypotheses must differ."""
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import decode_cross_attn as k6
    from musketeer_tpu_torch.ops import decode_stack as k7
    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.ops import topk_projection as k2

    search_module = importlib.import_module("musketeer_tpu_torch.generation.beam_search")
    attn_module = importlib.import_module("musketeer_tpu_torch.ops.flash_attention_bwd")
    cfg, params, gen_cfg = _slice_setup(tree, name, "float32", model, arch)
    src, images, _ = _inputs(2, SEED + 1)
    masks = torch.tensor([True, False], device="cuda")

    before = _counters()
    _, tok_k, sc_k = _caption(params, cfg, gen_cfg, src, images, masks)
    mid = _counters()
    with mock.patch.object(attn_module, "flash_attention_inference", k1.flash_attention_plain), \
            mock.patch.object(search_module, "project_with_stats", k2.project_plain), \
            mock.patch.object(ofa, "decode_cross_attention_int8",
                              k6.decode_cross_attention_int8_plain), \
            mock.patch.object(ofa, "decode_stack_step", k7.decode_stack_plain):
        _, tok_p, sc_p = _caption(params, cfg, gen_cfg, src, images, masks)
    after = _counters()
    ran = {k for k in mid if mid[k] > before[k]}
    want = {k for k, n in _expected_launches(name, cfg, 1).items() if n}
    if ran != want or after != mid:
        raise AssertionError(f"{name}: kernel/plain routing wrong: {before} {mid} {after}")
    _check_tokens(tok_k, sc_k, cfg, 2)
    tag = name if not model else f"{name}, " + ", ".join(f"{k}={v}" for k, v in model.items())
    tag = tag if arch == "ofa_base" else f"{arch} {tag}"
    gap, lim = _max_err(sc_k, sc_p), FP32_TOL * max(1.0, float(sc_p.abs().max()))
    log(f"[{tag} exact] fp32 batch 2: kernel tokens {tok_k[:, 0].tolist()}; "
        f"max score diff {gap:.3e} (tol {lim:.3e})")
    if torch.equal(tok_k[0, 0], tok_k[1, 0]):
        raise AssertionError(f"{name}: both rows' best hypotheses are the same tokens: the "
                             "check would not see its input")
    if not torch.equal(tok_k, tok_p) or not gap <= lim:
        raise AssertionError(f"{name}: fp32 tokens or scores through the kernels differ from "
                             f"the plain versions' (score gap {gap:.3e}, tol {lim:.3e})")


def _elem_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max(1, |b|), element by element (lse is −1e9 on masked rows)."""
    return float(((a.float() - b.float()).abs() / b.float().abs().clamp_min(1.0)).max())


def _device_ms_by_kernel(fn, iters: int = 5) -> dict:
    """Each CUDA kernel's device time per call of ``fn`` (torch.profiler, after a
    warm-up), keyed by the kernel's name without its namespace and arguments."""
    from torch.profiler import ProfilerActivity

    def run():
        for _ in range(iters):
            fn()

    fn()
    out = {}
    for e in _profiled_device_events(run, [ProfilerActivity.CUDA]):
        name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
        key = name.split("(")[0].split("<")[0].split("::")[-1]
        out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return out


def _library_k3(x: dict):
    """aten's memory-efficient attention with its logsumexp, on K3's inputs;
    None where v's rows are not whole 16-byte units (called directly, that
    kernel does not check its alignment and faults)."""
    if x["v"].shape[-1] * x["v"].element_size() % 16:
        log("[K3] library call not made: the memory-efficient kernel needs rows of whole "
            "16-byte units")
        return None
    qc, kc, v, mask = _sdpa_inputs(x)
    if x["q"].shape[-1] > 256:  # past 256: only where SDPA's own checks let that kernel run
        from torch.nn.attention import SDPBackend, sdpa_kernel
        try:
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                torch.nn.functional.scaled_dot_product_attention(qc, kc, v, attn_mask=mask,
                                                                 scale=1.0)
        except RuntimeError as e:
            log(f"[K3] library call not made: {str(e).splitlines()[0][:160]}")
            return None
    return _library_ms("K3", lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        qc, kc, v, mask, True, scale=1.0))


def _library_k4(x: dict, do: torch.Tensor):
    """The backward of scaled_dot_product_attention on K4's inputs: d[q|pos_q],
    d[k|pos_k], dv and the mask's gradient (drel before its sum over the batch)."""
    qc, kc, v, mask = (t.detach().requires_grad_(True) for t in _sdpa_inputs(x))
    try:
        out = torch.nn.functional.scaled_dot_product_attention(qc, kc, v, attn_mask=mask, scale=1.0)
    except RuntimeError as e:
        log(f"[K4] library call refused: {str(e).splitlines()[0][:160]}")
        return None
    return _library_ms("K4", lambda: torch.autograd.grad(out, (qc, kc, v, mask), do,
                                                         retain_graph=True))


def _widened(args) -> list:
    """The same arguments with every floating tensor widened to fp32."""
    return [t.float() if torch.is_tensor(t) and t.is_floating_point() else t for t in args]


def _check_k3(tag: str, args, kw: dict):
    """K3 on ``args`` against its plain version: o within the dtype's
    tolerance · max(1, max|ref|) and finite, lse within ``FP32_TOL`` element
    by element; in bf16 also o against the function in fp32 (``_check_function``).
    → (o, lse, plain o, plain lse, o's max abs err)."""
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb

    tol = BF16_TOL if args[0].dtype == torch.bfloat16 else FP32_TOL
    o, lse = kb.flash_attention_fwd(*args, **kw)
    o_p, lse_p = kb.flash_attention_fwd_plain(*args, **kw)
    msg = ""
    if args[0].dtype == torch.float32 and FP32_REF_F64:  # the fp64 function, rounded to fp32
        o64, lse64 = kb.flash_attention_fwd_plain(*_widened64(args), **kw)
        msg = "; against the fp64 function; " + F64_NOTE.format(_max_err(o_p, o64))
        o_p, lse_p = o64.float(), lse64.float()
    e_o, e_lse = _max_err(o, o_p), _elem_rel_err(lse, lse_p)
    if not (e_o <= tol * max(1.0, float(o_p.float().abs().max())) and e_lse <= FP32_TOL
            and bool(torch.isfinite(o).all())):
        raise AssertionError(f"K3 {tag}: o err {e_o}, lse err {e_lse}")
    if args[0].dtype == torch.bfloat16:
        msg = "; o " + _check_function(f"K3 {tag}", o, o_p, kb.flash_attention_fwd_plain(
            *_widened(args), **kw)[0])
    log(f"[K3] {tag}: max abs err o {e_o:.3e}, lse rel {e_lse:.3e}{msg}")
    return o, lse, o_p, lse_p, e_o


def _check_k4(tag: str, args, kw: dict):
    """K4 on ``args`` (q … kpad, o, lse, do) against its plain version: each
    gradient within the tolerance of its dtype · max(1, max|ref|) and finite;
    in bf16 also against the function in fp32, within one bf16 step of the
    plain version's error. → (grads, max abs errs)."""
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb

    tol = BF16_TOL if args[0].dtype == torch.bfloat16 else FP32_TOL
    grads = kb.flash_attention_bwd(*args, **kw)
    ref = kb.flash_attention_bwd_plain(*args, **kw)
    note = ""
    if args[0].dtype == torch.float32 and FP32_REF_F64:
        ref64 = kb.flash_attention_bwd_plain(*_widened64(args), **kw)
        note = "; against the fp64 function; " + F64_NOTE.format(max(
            _max_err(a, b) for a, b in zip(ref, ref64) if b is not None))
        ref = ref64
    torch.cuda.synchronize()
    errs = {}
    f32_tol = FP32_TOL if args[0].dtype == torch.float32 or BF16_FP32_OUT_TOL is None \
        else BF16_FP32_OUT_TOL
    for gname, a, b in zip(GRAD_NAMES, grads, ref):
        if b is None:
            if a is not None:
                raise AssertionError(f"K4 {tag}: {gname} without rel")
            continue
        errs[gname] = _max_err(a, b)
        lim = (f32_tol if b.dtype == torch.float32 else tol) * max(1.0, float(b.abs().max()))
        if not (errs[gname] <= lim and bool(torch.isfinite(a).all())):
            raise AssertionError(f"K4 {tag}: {gname} err {errs[gname]} > {lim}")
    msg = ""
    if args[0].dtype == torch.bfloat16:
        fn = kb.flash_attention_bwd_plain(*_widened(args), **kw)
        msg = "; " + "; ".join(f"{gname} " + _check_function(f"K4 {tag} {gname}", a, b, f)
                               for gname, a, b, f in zip(GRAD_NAMES, grads, ref, fn)
                               if f is not None)
    log(f"[K4] {tag}: max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + msg
        + note)
    return grads, errs


def _k4_saved_case() -> None:
    """K4 on ``K4_SAVED_CASE``'s inputs, held as every case: against its plain
    version, and against the fp32 function within one bf16 step of the plain
    version's error (dq missed that by 0.287 steps while dW entered its
    product rounded once to bf16); dq's and dk's distances from the fp32
    function printed in bf16 steps of their largest magnitude, beside
    plain's."""
    import os

    from musketeer_tpu_torch.ops import flash_attention_bwd as kb

    case = torch.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), K4_SAVED_CASE),
                      map_location="cuda")
    args, kw = case["args"], dict(causal=case["causal"], need_drel=case["need_drel"])
    grads, _ = _check_k4("saved causal T232", args, kw)
    fn = kb.flash_attention_bwd_plain(*_widened(args), **kw)
    plain = kb.flash_attention_bwd_plain(*args, **kw)
    parts = []
    for i, gname in ((0, "dq"), (1, "dk")):
        step = 2.0 ** (math.floor(math.log2(float(fn[i].abs().max()))) - 7)
        e_k, e_p = _max_err(grads[i], fn[i]), _max_err(plain[i], fn[i])
        parts.append(f"{gname} {e_k / step:.3f} bf16 steps from the fp32 function, plain "
                     f"{e_p / step:.3f}")
    log("[K4] saved causal T232: " + "; ".join(parts))


def phase_k3_k4(g, shapes: dict = K34_SHAPES, small: dict = K34_SMALL,
                saved: bool = True) -> dict:
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb

    names = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")
    cases = [(n, c, torch.bfloat16) for n, c in shapes.items()]
    cases += [(n, c, dtype) for n, c in small.items()
              for dtype in (torch.float32, torch.bfloat16)]
    stats = {}
    for name, c, dtype in cases:
        x = _k1_inputs(g, **c["shape"], dtype=dtype, rel=c.get("rel", True),
                       masked_row=c.get("masked_row"))
        args = [x[n] for n in names]
        kw = dict(causal=c.get("causal", False), skip_max=c.get("skip_max", False))
        tag = f"{name} D{c['shape']['D']} {str(dtype)[6:]}"
        o, lse, o_p, lse_p, e_o = _check_k3(tag, args, kw)
        # K4 on the plain forward's o and lse, so that it alone is compared
        do = (torch.randn(o_p.shape, generator=g, device="cuda") * 0.5).to(dtype)
        bwd_args = (*args, o_p, lse_p, do)
        grads, errs = _check_k4(tag, bwd_args, dict(causal=kw["causal"]))
        if dtype != torch.bfloat16 or name in small:
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
            # what reading rel (and writing drel) costs each kernel
            no_rel = args[:5] + [None, x["kpad"]]
            log(f"[K3] encoder without rel {cuda_ms(lambda: kb.flash_attention_fwd(*no_rel), 10):.3f}"
                f" ms; [K4] encoder without rel or drel "
                f"{cuda_ms(lambda: kb.flash_attention_bwd(*no_rel, o_p, lse_p, do), 10):.3f} ms")
            by_kernel = _device_ms_by_kernel(lambda: kb.flash_attention_bwd(*bwd_args))
            log("[K4] encoder device time by kernel (torch.profiler): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in by_kernel.items()))
            B, H, T, D = x["q"].shape
            unit = 2.0 * B * H * T * x["k"].shape[2] * D  # one [T, S] x D product
            stats["K3"] = dict(max_abs_err=e_o, ms=times["K3"][0], plain_ms=times["K3"][1],
                               library_ms=_library_k3(x),
                               **_bound(_nbytes(*args, o, lse), 3 * unit))
            # K4 without its recomputes: the two score products, then dV, dP, dq,
            # dk, dpos_q and dpos_k
            stats["K4"] = dict(max_abs_err=max(errs.values()), ms=times["K4"][0],
                               plain_ms=times["K4"][1], library_ms=_library_k4(x, do),
                               **_bound(_nbytes(*bwd_args, *grads), 8 * unit))
        del x, args, o, lse, o_p, lse_p, do, bwd_args, grads
    if saved:
        _k4_saved_case()
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


def phase_train(tree, smi: str, routes: frozenset = SM90_ROUTES, model: dict = None,
                name: str = "ofa_base") -> dict:
    """Phase 8: the joint step of ``ofa_base`` (with ``model``'s options, such
    as another head count, called ``name``) in bf16. → (launches of a step, p50 ms)."""
    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.training import init_train_state, make_train_step
    from musketeer_tpu_torch.training.train_state import named_leaves

    cfg = dataclasses.replace(ofa_base(), dtype="bfloat16", use_flash_attention=True,
                              **(model or {}))
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
    _reset_counters(routes)
    with mock.patch.object(ofa, "forward", wraps=ofa.forward) as fwd:
        state, loss, secs = run(state)
    launches = _counters(routes)
    log(f"[train] launches {launches} over {fwd.call_count} transformer forwards "
        f"(expected {forwards} from the packing groups, {per_forward} attentions each)")
    if fwd.call_count != forwards:
        raise AssertionError(f"{fwd.call_count} forwards in a step, expected {forwards}")
    want = dict.fromkeys(launches, 0)
    want.update({"K3": per_forward * forwards, "K4": per_forward * forwards})
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
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
    log(f"[train] {name} bf16 {len(TRAIN_TASKS)} tasks x batch {TRAIN_BATCH}: p50 step "
        f"{p50 * 1e3:.1f} ms, {samples / p50:.2f} samples/s (steps "
        f"{[round(t * 1e3, 1) for t in times]} ms) on {smi}")
    _profile_train_step(step, state, batches, smi)
    return launches, p50 * 1e3


# the demangled names of K3's and K4's CUDA kernels, on either core (K1 shares
# K3's kernels but runs 0 times in a training step)
# K3's kernels in a training step's profile (the bf16 forward past head dim
# 128, fwd_deep, serves K1 too, but a step launches only K3)
K3_KERNELS = ("flash_fwd::kernel<", "sm90::fwd_deep<false") + tuple(
    f"sm90::kernel<{dp}, false" for dp in (32, 64, 80, 128))
K4_KERNELS = ("dsum_kernel", "bwd_kv", "bwd_q", "drel_sum")


def _profile_train_step(step, state, batches, smi: str) -> None:
    """Phase 15's training part: one more step (the earlier ones warm it up)
    under torch.profiler; its device time, device operations and busy share,
    and the device time of K3's and K4's kernels. The step's p50 is host-noisy,
    so a kernel change is read from these numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step(state, batches)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("torch.profiler recorded no device operations")
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3

    def kernels(keys):
        sel = [e for e in dev if any(k in e.name for k in keys)]
        return sum(e.time_range.elapsed_us() for e in sel) / 1e3, len(sel)

    (k3_ms, k3_n), (k4_ms, k4_n) = kernels(K3_KERNELS), kernels(K4_KERNELS)
    log(f"[profile train] one step: {len(dev)} device operations, {busy:.2f} ms device time "
        f"over {wall:.2f} ms wall under the profiler (busy share {busy / wall:.3f}); K3 "
        f"{k3_ms:.2f} ms in {k3_n} kernels ({k3_ms / busy:.3f} of the device time), K4 "
        f"{k4_ms:.2f} ms in {k4_n} kernels ({k4_ms / busy:.3f}) on {smi}")
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    top = sorted((e for e in prof.key_averages() if dev_us(e) > 0), key=dev_us, reverse=True)
    log("[profile train] device time by operation: " + "; ".join(
        f"{e.key[:48]} {dev_us(e) / 1e3:.2f} ms x{e.count}" for e in top[:8]))


def phase_train_exactness(tree, arch: str = "ofa_base", model: dict = None) -> None:
    from musketeer_tpu_torch.config import ARCH_PRESETS
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.training.train_state import global_norm, named_leaves
    from musketeer_tpu_torch.training.train_step import multitask_loss

    cfg = dataclasses.replace(ARCH_PRESETS[arch](), dtype="float32", use_flash_attention=True,
                              **(model or {}))
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
    what = arch + "".join(f" {k}={v}" for k, v in (model or {}).items())
    log(f"[train-exact] {what} fp32 {'+'.join(EXACT_TASKS)} batch 1: loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {rel(loss_k, loss_p):.2e}), grad norm {gn_k:.6f} vs {gn_p:.6f} "
        f"(rel {rel(gn_k, gn_p):.2e}), worst leaf {worst_path} at {worst:.3f} of its bound")
    if rel(loss_k, loss_p) > 1e-5 or rel(gn_k, gn_p) > 1e-5 or worst > 1.0:
        raise AssertionError("fp32 step through K3/K4 differs from the plain versions'")


def phase_k2q8(g, routes: frozenset = SM90_ROUTES, shape: dict = K2_SHAPE) -> dict:
    """K2-q8 at the beam decode shape: bf16 features on the tensor-core route
    (``routes`` without ``K2-q8-sm90`` only for an older tree), also against
    the function in fp32 as in phase 3; fp32 features on the FMA kernel alone."""
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import topk_projection as k2

    N, D, Vp, vs = (shape[k] for k in ("N", "D", "Vp", "vocab_size"))
    sm90 = "K2-q8-sm90" in routes
    w = torch.randn(Vp, D, generator=g, device="cuda") * D ** -0.5
    w[vs:] = 0
    q = ofa.quantize_output_proj({"embed_tokens": w})
    w8, scale = q["embed_tokens_q8"], q["embed_tokens_scale"]
    real = lambda t: t[:, :vs]  # the -1e9 columns, checked apart, would set the tolerance
    stats = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        h = torch.randn(N, D, generator=g, device="cuda").to(dtype)
        before = _counters(routes)
        out = k2.project_with_stats(h, w8, scale, vocab_size=vs)
        ref = k2.project_plain(h, w8, scale, vocab_size=vs)
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in _counters(routes).items() if n != before[k]}
        want = {"K2-q8": 1, **({"K2-q8-sm90": 1} if sm90 and dtype == torch.bfloat16 else {})}
        if moved != want:
            raise AssertionError(f"K2-q8 {dtype}: launches {moved}, expected {want} (bf16 on "
                                 f"the tensor-core kernel, fp32 on the FMA kernel alone)")
        err = _check_close("K2-q8 logits", real(out[0]), real(ref[0]), tol)
        for name, a, b in zip(("bmax", "Z"), out[1:], ref[1:]):
            _check_close(f"K2-q8 {name}", a, b, FP32_TOL)
        if not bool((out[0][:, vs:] == k2.NEG_INF).all()):
            raise AssertionError("K2-q8: padded vocab columns must be -1e9")
        fn_msg = "" if dtype != torch.bfloat16 else "; logits " + _check_function(
            "K2-q8 logits", real(out[0]), real(ref[0]),
            real(k2.project_plain(h.float(), w8, scale, vocab_size=vs)[0]))
        log(f"[K2-q8] N{N} Vp{Vp} D{D} int8 w, {str(dtype)[6:]} h: max abs err logits {err:.3e}, "
            f"bmax {_max_err(out[1], ref[1]):.3e}, Z {_max_err(out[2], ref[2]):.3e}{fn_msg}")
        if dtype == torch.bfloat16:
            times = _timings("K2-q8", lambda: k2.project_with_stats(h, w8, scale, vocab_size=vs),
                             lambda: k2.project_plain(h, w8, scale, vocab_size=vs),
                             "proj_q8_sm90_kernel" if sm90 else "proj_stats_kernel")
            work = _bound(_nbytes(h, w8, scale, *out), 2.0 * N * Vp * D)
            log(f"[K2-q8] bound {work['bound_ms']:.4f} ms ({work['bound_by']})")
            stats = dict(max_abs_err=err, library_ms=None, **times, **work)
    return stats


def _k6_inputs(g, B, H, Kb, S, D, dtype, full_pad=None):
    """K6's inputs; the bias a strided [B, H, S] view of a [B, H, 4, S] table,
    as the model passes its cross-position bias row."""
    dev = "cuda"
    x = dict(q=(torch.randn(B, H, Kb, D, generator=g, device=dev) * 0.3).to(dtype),
             k_i8=torch.randint(-127, 128, (B, H, S, D), generator=g, device=dev, dtype=torch.int8),
             v_i8=torch.randint(-127, 128, (B, H, S, D), generator=g, device=dev, dtype=torch.int8),
             k_scale=torch.rand(B, H, S, generator=g, device=dev) * 0.02,
             v_scale=torch.rand(B, H, S, generator=g, device=dev) * 0.02,
             bias=torch.randn(B, H, 4, S, generator=g, device=dev)[:, :, 2],
             enc_pad=torch.rand(B, S, generator=g, device=dev) < 0.1)
    if full_pad is not None:
        x["enc_pad"][full_pad] = True
    return x


# K6's main call (serving A's shape) and small cases: (name, shape, dtype)
K6_CASES = (("B16 H12 Kb5 S908", K6_SHAPE, torch.bfloat16),
            ("B3 H2 Kb3 S37", dict(B=3, H=2, Kb=3, S=37, D=64), torch.bfloat16),
            ("B2 H3 Kb1 S130", dict(B=2, H=3, Kb=1, S=130, D=64), torch.bfloat16),
            ("B2 H2 Kb16 S908", dict(B=2, H=2, Kb=16, S=908, D=64), torch.bfloat16),
            ("B3 H2 Kb3 S37", dict(B=3, H=2, Kb=3, S=37, D=64), torch.float32))


def phase_k6(g, routes: frozenset = SM90_ROUTES, cases: tuple = K6_CASES,
             main: dict = K6_SHAPE) -> dict:
    """K6 against its plain version: bf16 on the tensor-core route (``routes``
    without ``K6-sm90`` only for an older tree), also against the function in
    fp32; fp32 on the FMA kernel alone; sample 1 fully padded in every case."""
    from musketeer_tpu_torch.ops import decode_cross_attn as k6

    names = ("q", "k_i8", "v_i8", "k_scale", "v_scale", "bias", "enc_pad")
    sm90 = "K6-sm90" in routes
    stats = {}
    for name, shape, dtype in cases:
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        x = _k6_inputs(g, **shape, dtype=dtype, full_pad=1)
        args = [x[n] for n in names]
        before = _counters(routes)
        out = k6.decode_cross_attention_int8(*args)
        ref = k6.decode_cross_attention_int8_plain(*args)
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in _counters(routes).items() if n != before[k]}
        want = {"K6": 1, **({"K6-sm90": 1} if sm90 and dtype == torch.bfloat16 else {})}
        if moved != want:
            raise AssertionError(f"K6 {name} {dtype}: launches {moved}, expected {want}")
        err = _check_close(f"K6 {name}", out, ref, tol)
        if not bool((out[1] == 0).all()):
            raise AssertionError("K6: a fully padded sample must give exact zeros")
        fn_msg = "" if dtype != torch.bfloat16 else "; " + _check_function(
            f"K6 {name}", out, ref, k6.decode_cross_attention_int8_plain(
                x["q"].float(), *args[1:]))
        log(f"[K6] {name} D{shape['D']} {str(dtype)[6:]}, 10 % padded keys, sample 1 fully padded (exact "
            f"zeros): max abs err {err:.3e}{fn_msg}")
        if shape is main:
            times = _timings("K6", lambda: k6.decode_cross_attention_int8(*args),
                             lambda: k6.decode_cross_attention_int8_plain(*args),
                             "cross_attn_i8_sm90_kernel" if sm90 else "kernel")
            B, H, Kb, S, D = (shape[k] for k in ("B", "H", "Kb", "S", "D"))
            work = _bound(_nbytes(*args, out), 4.0 * B * H * Kb * S * D)
            log(f"[K6] bound {work['bound_ms']:.5f} ms ({work['bound_by']})")
            stats = dict(max_abs_err=err, library_ms=None, **times, **work)
    return stats


def _k7_inputs(g, L, B, Kb, H, f, Tmax, S, dtype, hd=64):
    dev, d, rows = "cuda", H * hd, B * Kb
    rnd = lambda *shape, std=1.0: torch.randn(*shape, generator=g, device=dev) * std
    pack = {"w_self3": rnd(L, 3 * d, d, std=d ** -0.5), "b_self3": rnd(L, 3 * d, std=0.02),
            "w_so": rnd(L, d, d, std=d ** -0.5), "w_cq": rnd(L, d, d, std=d ** -0.5),
            "w_co": rnd(L, d, d, std=d ** -0.5), "w_fc1": rnd(L, f, d, std=d ** -0.5),
            "b_fc1": rnd(L, f, std=0.02), "w_fc2": rnd(L, d, f, std=f ** -0.5),
            "b_misc": rnd(L, 4, d, std=0.02)}
    pack = {k: v.to(dtype) for k, v in pack.items()}
    ln = torch.stack([1 + rnd(L, d, std=0.1), rnd(L, d, std=0.1)] * 3, dim=1)
    pack["ln"] = ln.contiguous()
    cbias = rnd(B, H, S)
    cbias.masked_fill_((torch.rand(B, S, generator=g, device=dev) < 0.1)[:, None, :], -1e9)
    x = dict(x0=rnd(rows, d).to(dtype), sbias=rnd(L, rows, H, Tmax), cbias=cbias,
             self_k=rnd(L, rows, H, Tmax, hd).to(dtype), self_v=rnd(L, rows, H, Tmax, hd).to(dtype),
             cross_k=rnd(L, B, H, S, hd).to(dtype), cross_v=rnd(L, B, H, S, hd).to(dtype))
    return pack, x


def _k7_work(pack, x, idx: int) -> dict:
    """K7's bound: its weights, the cross K/V, the cache rows before idx (the
    only ones the step reads), the biases; the products and both attentions."""
    L, rows, H, _, hd = x["self_k"].shape
    d, f, S = H * hd, pack["w_fc1"].shape[1], x["cross_k"].shape[3]
    el = x["x0"].element_size()
    cache = 2 * L * rows * H * idx * hd * el
    nbytes = (_nbytes(*pack.values(), x["x0"], x["sbias"], x["cbias"], x["cross_k"], x["cross_v"])
              + cache + (2 * L + 1) * rows * d * el)  # k_new, v_new, x_out
    ops = L * (2.0 * rows * (6 * d * d + 2 * d * f) + 4.0 * rows * H * hd * (idx + 1 + S))
    return _bound(nbytes, ops)


# K7's CUDA kernels by profiler key (_device_ms_by_kernel), on either route
K7_PARTS = {"gemm_kernel": "products", "self_attn_kernel": "self-attention",
            "self_attn_bf16": "self-attention",
            "kernel": "cross-attention"}


def _k7_by_kernel(fn) -> dict:
    """K7's device time per step by part: its products, self-attention,
    cross-attention, and copies or fills (anything else under its own name).
    ``fn`` runs a step without programmatic dependent launch: a kernel that
    starts early spends its wait inside its own time."""
    parts = {}
    for key, ms in _device_ms_by_kernel(fn).items():
        part = K7_PARTS.get(key, "copy" if key.startswith(("Memcpy", "Memset")) else key)
        parts[part] = parts.get(part, 0.0) + ms
    return parts


def _k7_spans(k7, pack, args, idx: int, scaling: float, tol: float,
              span: int = K7_SHAPE["L"]) -> list:
    """K7 over a stack in spans of ``span`` layers (by default phase 12's
    depth, ``K7_SHAPE``'s L), each span on the plain version's input to its
    first layer, every output within ``tol`` · max(1, max|ref|) of the plain
    version's. Between two bf16 computations of the whole stack the rounding
    differences grow with depth: at 12 layers the kernel and plain differ by
    ~1.7–1.9 % of max|x_out| at head dim 64 and 80 alike (on an H100),
    each as close to the fp32 function as the other, which phase_k7 checks
    on the whole stack. → each output's largest error over the spans."""
    x0, sbias, cbias, self_k, self_v, cross_k, cross_v = args
    worst, x = [0.0, 0.0, 0.0], x0
    for l0 in range(0, self_k.shape[0], span):
        sl = slice(l0, l0 + span)
        sub = [x, sbias[sl], cbias, self_k[sl], self_v[sl], cross_k[sl], cross_v[sl]]
        part = {k: v[sl] for k, v in pack.items()}
        out = k7.decode_stack_step(part, *sub, idx, beam_size=BEAM, scaling=scaling)
        ref = k7.decode_stack_plain(part, *sub, idx, beam_size=BEAM, scaling=scaling)
        for i, (n, a, b) in enumerate(zip(("x_out", "k_new", "v_new"), out, ref)):
            worst[i] = max(worst[i], _check_close(
                f"K7 {n} cache_index {idx} layers {l0}..{l0 + span - 1}", a, b, tol))
        x = ref[0]
    return worst


def phase_k7(g, routes: frozenset = SM90_ROUTES, shape: dict = K7_SHAPE, hd: int = 64) -> dict:
    """K7 at the serving B decode shape (``routes`` as in ``phase_k2``)."""
    from musketeer_tpu_torch.ops import decode_stack as k7

    names = ("x0", "sbias", "cbias", "self_k", "self_v", "cross_k", "cross_v")
    scaling = (hd * 2.0) ** -0.5
    tag = (f"rows {shape['B'] * shape['Kb']} L{shape['L']} d{shape['H'] * hd} f{shape['f']} "
           f"Tmax {shape['Tmax']} S{shape['S']} hd{hd}")
    sm90 = "K7-sm90" in routes
    stats = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        pack, x = _k7_inputs(g, **shape, dtype=dtype, hd=hd)
        args = [x[n] for n in names]
        for idx in K7_INDICES:
            call = lambda fn, p=pack, a=args: fn(p, *a, idx, beam_size=BEAM, scaling=scaling)
            before = _counters(routes)
            out, ref = call(k7.decode_stack_step), call(k7.decode_stack_plain)
            torch.cuda.synchronize()
            routed = _counters(routes)["K7-sm90"] - before["K7-sm90"] if sm90 else None
            if sm90 and routed != (dtype == torch.bfloat16):
                raise AssertionError(f"K7 {dtype}: bf16 must run the tensor-core route, fp32 the "
                                     f"FMA route ({routed} tensor-core launches)")
            if dtype == torch.bfloat16 and shape["L"] > K7_SHAPE["L"]:
                full = [_max_err(a, b) for a, b in zip(out, ref)]
                log(f"[K7] {tag} bf16 cache_index {idx}: the whole stack against plain: max abs "
                    f"diff x_out {full[0]:.3e}, k_new {full[1]:.3e}, v_new {full[2]:.3e} (held to "
                    f"the fp32 function below, and each span of {K7_SHAPE['L']} layers to plain)")
                errs = _k7_spans(k7, pack, args, idx, scaling, tol)
            else:
                errs = [_check_close(f"K7 {n} cache_index {idx}", a, b, tol)
                        for n, a, b in zip(("x_out", "k_new", "v_new"), out, ref)]
            log(f"[K7] {tag} {str(dtype)[6:]} cache_index {idx}: "
                f"max abs err x_out {errs[0]:.3e}, k_new {errs[1]:.3e}, v_new {errs[2]:.3e} "
                f"(max |x_out| {float(ref[0].float().abs().max()):.2f})")
            if dtype != torch.bfloat16:
                continue
            # the function in fp32 on the same bf16 inputs
            fn = call(k7.decode_stack_plain, {k: v.float() for k, v in pack.items()},
                      [a.float() for a in args])
            log(f"[K7] cache_index {idx} bf16: " + "; ".join(
                f"{n} " + _check_function(f"K7 {n} cache_index {idx}", a, b, c)
                for n, a, b, c in zip(("x_out", "k_new", "v_new"), out, ref, fn)))
            del fn
            ms = cuda_ms(lambda: call(k7.decode_stack_step), 10)
            plain_ms = cuda_ms(lambda: call(k7.decode_stack_plain), 5)
            work = _k7_work(pack, x, idx)
            if sm90:  # the route's C call itself, without programmatic dependent launch
                outs = tuple(torch.empty_like(t) for t in out)
                serial = lambda: k7._run_sm90(pack, *args, idx, BEAM, scaling, outs, pdl=False)
            else:  # an older tree: no programmatic dependent launch
                serial = lambda: call(k7.decode_stack_step)
            parts = _k7_by_kernel(serial)
            log(f"[K7] cache_index {idx}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms per step, "
                f"bound {work['bound_ms']:.4f} ms ({work['bound_by']}); device time by kernel "
                f"(torch.profiler, no PDL): " + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
            stats = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
                         **work)  # the last index, the fullest cache
        if dtype == torch.bfloat16 and sm90:
            # the route's C call with programmatic dependent launch and without,
            # in turns, at the fullest cache
            outs = tuple(torch.empty_like(t) for t in out)
            times = {True: [], False: []}
            for pdl in (True, False, False, True):
                times[pdl].append(cuda_ms(lambda: k7._run_sm90(
                    pack, *args, K7_INDICES[-1], BEAM, scaling, outs, pdl=pdl), 20))
            log(f"[K7] cache_index {K7_INDICES[-1]}: the C call with programmatic dependent "
                f"launch {times[True]} ms, without {times[False]} ms per step")
        del pack, x, args
    return stats


def phase_profile(tree, arch: str = "ofa_base") -> None:
    """Device operations per beam step and the device's busy share, from
    torch.profiler, over one run of each slice (after a warm-up run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from musketeer_tpu_torch.generation import beam_search
    from musketeer_tpu_torch.models import ofa

    for name in SLICES:
        cfg, params, gen_cfg = _slice_setup(tree, name, "bfloat16", arch=arch)
        tag = name if arch == "ofa_base" else f"{arch} {name}"
        src, images, masks = _inputs(BATCH, SEED)
        _caption(params, cfg, gen_cfg, src, images, masks)
        with mock.patch.object(ofa, "decode_step", wraps=ofa.decode_step) as steps, \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            enc = ofa.encode(params, cfg, src, images, masks)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            beam_search(params, cfg, gen_cfg, enc, max_len=MAX_LEN)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        enc_us = (t1 - t0) * 1e6
        # device operations that started during the search (the trace's clock
        # starts with the profiler, as t0 does, up to the profiler's set-up)
        first = min(e.time_range.start for e in dev)
        search = [e for e in dev if e.time_range.start - first >= enc_us]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        wall = (t2 - t0) * 1e3
        log(f"[profile {tag}] {len(dev)} device operations, {busy:.2f} ms device time over "
            f"{wall:.2f} ms wall under the profiler (busy share {busy / wall:.3f}); encode "
            f"{(t1 - t0) * 1e3:.2f} ms wall; search: {steps.call_count} beam steps, about "
            f"{len(search)} device operations ({len(search) / steps.call_count:.1f} per step)")
        dev_us = lambda e: getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0))
        top = sorted((e for e in prof.key_averages() if dev_us(e) > 0), key=dev_us, reverse=True)
        log(f"[profile {tag}] device time by operation: " + "; ".join(
            f"{e.key[:48]} {dev_us(e) / 1e3:.2f} ms x{e.count}" for e in top[:6]))


def _profiled_device_events(run, activities) -> list:
    """The device events of one torch.profiler session around ``run()``. A
    session that records none (CUPTI now and then returns an empty trace on
    the card, even in a fresh process) is run up to twice more, logged,
    tracing the device alone; a third empty one raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=activities if attempt == 0
                     else [ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            return dev
        log("[profiler] a session recorded no device operations" +
            ("; running it once more, tracing the device alone" if attempt < 2 else ""))
    raise AssertionError("torch.profiler recorded no device operations")


def _device_host_ms(fn, iters: int) -> tuple:
    """Where back-to-back calls of ``fn`` spend their time: the device time of
    the operations they launch (torch.profiler) and the host time of the calls
    alone (perf_counter around the loop, before the closing synchronize), each
    per call, after two warm-ups. CUDA events see the larger of the two."""
    from torch.profiler import ProfilerActivity

    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    dev = _profiled_device_events(run, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / iters, host_ms


def _k5_call(k5, x: dict, c: dict, plain: bool = False):
    """One K5 call on ``_k1_inputs``: flash_cross_attention (no rel) or
    flash_attention_bias, through the wrapper or its plain version."""
    args = [x[n] for n in ("q", "k", "v", "pos_q", "pos_k")]
    block_q = c.get("block_q", 128)
    if c.get("cross"):
        fn = k5.flash_cross_attention_plain if plain else k5.flash_cross_attention
        return fn(*args, x["kpad"], block_q=block_q)
    fn = k5.flash_attention_bias_plain if plain else k5.flash_attention_bias
    return fn(*args, x["rel"], x["kpad"], causal=c.get("causal", False), block_q=block_q)


def phase_k5(g, shapes: dict = K5_SHAPES, small: dict = K5_SMALL):
    """K5's main path (three calls, counted), each against its plain version
    and timed, then the small fp32 and bf16 cases."""
    from musketeer_tpu_torch.ops import flash_attention as k5

    xs = {name: _k1_inputs(g, **c["shape"], dtype=torch.bfloat16, rel=not c.get("cross"))
          for name, c in shapes.items()}
    _reset_counters()
    outs = {name: _k5_call(k5, xs[name], c) for name, c in shapes.items()}
    torch.cuda.synchronize()
    launches = _counters()
    want = dict.fromkeys(launches, 0)
    want.update({"K5": 2, "K5-cross": 1})
    log(f"[K5] launches {launches}")
    if launches != want:
        raise AssertionError(f"K5 main path: launches {launches}, expected {want}")

    stats = {}
    for name, c in shapes.items():
        x = xs[name]
        ref = _k5_call(k5, x, c, plain=True)
        torch.cuda.synchronize()
        err = _check_close(f"K5 {name}", outs[name], ref, BF16_TOL)
        log(f"[K5] {name} bf16: " + _check_function(f"K5 {name}", outs[name], ref,
                                                     _k5_call(k5, _as_f32(x), c, plain=True)))
        ms = cuda_ms(lambda: _k5_call(k5, x, c), 10)
        plain_ms = cuda_ms(lambda: _k5_call(k5, x, c, plain=True), 5)
        dev_ms, host_ms = _device_host_ms(lambda: _k5_call(k5, x, c), 10)
        B, H, T, D = x["q"].shape
        S = x["k"].shape[2]
        args = [x[n] for n in ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")]
        bound = _bound(_nbytes(*args, outs[name]), 6.0 * B * H * T * S * D)
        log(f"[K5] {name} {c['shape']} bf16: max abs err {err:.3e}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms per call, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
            f"the kernel's device time under torch.profiler {dev_ms:.4f} ms, the wrapper's host "
            f"time {host_ms:.4f} ms per call")
        if name in ("encoder", "cross"):
            qc, kc, v, mask = _sdpa_inputs(x)
            library_ms = _library_ms(f"K5 {name}", lambda: torch.nn.functional.
                                     scaled_dot_product_attention(qc, kc, v, attn_mask=mask,
                                                                  scale=1.0))
            stats["K5" if name == "encoder" else "K5-cross"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
            del qc, kc, v, mask
        del ref
    del xs, outs

    for name, c in small.items():
        dtypes = ((torch.bfloat16, BF16_TOL),) if c.get("rel_f32") else \
            ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL))
        for dtype, tol in dtypes:
            x = _k1_inputs(g, **c["shape"], dtype=dtype, rel=not c.get("cross"),
                           masked_row=c.get("masked_row"))
            if c.get("rel_f32"):
                x["rel"] = torch.randn(x["rel"].shape, generator=g, device="cuda") * 2
            a, b = _k5_call(k5, x, c), _k5_call(k5, x, c, plain=True)
            fn_msg = ""
            if dtype == torch.float32 and FP32_REF_F64:
                b64 = _k5_call(k5, _as_f64(x), c, plain=True)
                fn_msg, b = "; against the fp64 function; " + F64_NOTE.format(_max_err(b, b64)), b64
            e = _check_close(f"K5 {name} {dtype}", a, b, tol)
            if dtype == torch.bfloat16:
                fn_msg = "; " + _check_function(f"K5 {name}", a, b,
                                                _k5_call(k5, _as_f32(x), c, plain=True))
            log(f"[K5] {name} {c['shape']} {str(dtype)[6:]}: max abs err {e:.3e}{fn_msg}")
            if "masked_row" in c:
                S = x["k"].shape[2]
                mult = 128 if c.get("cross") else c.get("block_q", 128)
                Sp = -(-S // mult) * mult
                want_row = (x["v"][c["masked_row"]].float().sum(dim=1, keepdim=True) / Sp)
                e_row = _max_err(a[c["masked_row"]], want_row.expand_as(a[c["masked_row"]]))
                if e_row > tol * max(1.0, float(want_row.abs().max())):
                    raise AssertionError(f"K5 {name}: a fully masked sample must give "
                                         f"sum(v) / Sp (Sp {Sp}), err {e_row}")
    return stats, launches


def _rest_block(tree_rest: dict, i: int) -> dict:
    """Block i of a stacked "rest" subtree in the JAX layout."""
    return {k: _rest_block(v, i) if isinstance(v, dict) else v[i] for k, v in tree_rest.items()}


def _k8_work(x: torch.Tensor, p: dict) -> dict:
    """K8's bound: x read, the output written, the weights and affines read; the
    three convolutions' operations, 2·B·H·W·(2·C·Wd + 9·Wd²)."""
    B, H, W, C = x.shape
    Wd = p["conv1"].shape[0]
    nbytes = 2 * _nbytes(x) + _nbytes(p["conv1"], p["conv2"], p["conv3"]) + 4 * (4 * Wd + 2 * C)
    return _bound(nbytes, 2.0 * B * H * W * (2 * C * Wd + 9 * Wd * Wd))


# K8's small cases, each in fp32 (the FMA kernel) and bf16 (the tensor-core
# route): the block ("random": seeded widths; "layerN": that stage's first
# stride-1 block of the model tree) and x's [B, H, W, C]
K8_SMALL = {
    "B2 12x12 C16 Wd8 (ragged columns, widths padded to 64)": ("random", (2, 12, 12, 16), 8),
    "B2 10x6 C256 Wd64 (an image smaller than one tile)": ("layer1", (2, 10, 6, 256), 64),
    "B1 17x9 C200 Wd72 (ragged, C and Wd not multiples of 64)": ("random", (1, 17, 9, 200), 72),
    "B1 30x30 C1024 Wd256": ("layer3", (1, 30, 30, 1024), 256),
    "B1 9x11 C64 Wd192 (six ring stages, a partial conv2 pass)": ("random", (1, 9, 11, 64), 192),
}


def _random_block(g, C: int, Wd: int) -> dict:
    """A seeded stride-1 block in the JAX layout (HWIO) with non-trivial frozen BN."""
    rnd = lambda *shape, std=1.0: torch.randn(*shape, generator=g, device="cuda") * std
    blk = {"conv1": rnd(1, 1, C, Wd, std=C ** -0.5), "conv2": rnd(3, 3, Wd, Wd, std=(9 * Wd) ** -0.5),
           "conv3": rnd(1, 1, Wd, C, std=Wd ** -0.5)}
    for i, c in ((1, Wd), (2, Wd), (3, C)):
        blk[f"bn{i}"] = {"scale": 1 + rnd(c, std=0.1), "bias": rnd(c, std=0.1),
                         "mean": rnd(c, std=0.1), "var": rnd(c).abs() + 0.5}
    return blk


def _widen(p: dict) -> dict:
    """A block dict with every tensor in fp32 (the same values)."""
    return {k: _widen(v) if isinstance(v, dict) else v.float() for k, v in p.items()}


def _k8_bf16(k8, name: str, x: torch.Tensor, p: dict, sm90: bool) -> tuple:
    """bf16 K8 on x against its plain version (BF16_TOL) and against the
    function in fp32 on the same bf16 inputs (``_check_function``); with
    ``sm90`` its tensor-core counter must move by one. → (error, message,
    max|ref|)."""
    before = k8.fused_bottleneck.launches_sm90 if sm90 else 0
    out = k8.fused_bottleneck(x, p)
    torch.cuda.synchronize()
    if sm90 and k8.fused_bottleneck.launches_sm90 != before + 1:
        raise AssertionError(f"K8 {name}: bf16 did not run on the tensor-core route")
    ref = k8.fused_bottleneck_plain(x, p)
    err = _check_close(f"K8 {name}", out, ref, BF16_TOL)
    msg = _check_function(f"K8 {name}", out, ref, k8.fused_bottleneck_plain(x.float(), _widen(p)))
    return err, msg, float(ref.float().abs().max())


def _k8_checks(g, tree, sm90: bool) -> None:
    """K8's small cases in fp32 against its plain version and in bf16 as
    ``_k8_bf16``, the fold kernel's affines against ``fold_bn`` bit for bit,
    and the Function's gradients against autograd through the unfused block."""
    from musketeer_tpu_torch.models import resnet as rn
    from musketeer_tpu_torch.ops import bottleneck as k8
    from musketeer_tpu_torch.params import block_from_jax

    res = tree["encoder"]["resnet"]
    for name, (src, shape, Wd) in K8_SMALL.items():
        blk = _random_block(g, shape[3], Wd) if src == "random" else \
            _rest_block(res[src]["rest"], 0)
        x = torch.randn(*shape, generator=g, device="cuda")
        p = block_from_jax(blk, "cuda", torch.float32)
        a, b = k8.fused_bottleneck(x, p), k8.fused_bottleneck_plain(x, p)
        torch.cuda.synchronize()
        log(f"[K8] {name} fp32: max abs err {_check_close(f'K8 {name}', a, b, FP32_TOL):.3e}")
        pb = block_from_jax(blk, "cuda", torch.bfloat16)
        err, msg, _ = _k8_bf16(k8, name, x.to(torch.bfloat16), pb, sm90)
        log(f"[K8] {name} bf16: max abs err {err:.3e}; {msg}")
        if sm90:  # the fold kernel's affines against fold_bn's torch ops, bit for bit
            folds = [k8.fold_bn(p[f"bn{i}"]) for i in (1, 2, 3)]
            if not torch.equal(k8._affines(p), torch.cat([g for g, _ in folds] +
                                                         [b for _, b in folds])):
                raise AssertionError(f"K8 {name}: the folded affines differ from fold_bn's")

    # gradients: the Function (forward K8, backward the unfused block recomputed)
    # against autograd through the unfused block with the same leaves
    p = block_from_jax(_rest_block(res["layer1"]["rest"], 1), "cuda", torch.float32)
    leaves = k8._flat(p)
    x = torch.randn(2, 12, 10, 256, generator=g, device="cuda")
    cot = torch.randn(x.shape, generator=g, device="cuda")
    grads = {}
    for route in ("kernel", "unfused"):
        xs = x.clone().requires_grad_(True)
        ls = [t.detach().clone().requires_grad_(True) for t in leaves]
        if route == "kernel":
            before = k8.fused_bottleneck.launches
            out = k8.fused_bottleneck(xs, k8._unflat(ls))
            if k8.fused_bottleneck.launches != before + 1:
                raise AssertionError("K8's Function did not launch the kernel")
        else:
            out = rn._bottleneck(xs.permute(0, 3, 1, 2), k8._unflat(ls)).permute(0, 2, 3, 1)
        grads[route] = torch.autograd.grad((out * cot).sum(), [xs, *ls])
    worst = max(_max_err(a, b) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(grads["kernel"], grads["unfused"]))
    log(f"[K8] gradients of x and {len(leaves)} leaves, fp32: worst max abs err / max|g| "
        f"{worst:.3e}")
    if worst > 1e-5:
        raise AssertionError(f"K8's gradients differ from the unfused block's: {worst}")


def _k8_kernel_ms(fn, iters: int) -> float:
    """The device time of K8's own kernel launches per call of ``fn``
    (torch.profiler): the BN fold and the tensor-core kernel
    ``mk::bneck::kernel`` or, in an older tree, the FMA kernel
    ``(anonymous namespace)::kernel``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and any(k in e.name for k in ("bneck::kernel", "fold_bn_kernel",
                                             "namespace)::kernel<"))) / 1e3 / iters


def phase_k8(g, tree, smi: str, routes: frozenset = SM90_ROUTES) -> tuple:
    """K8 on the ResNet-101 stage path at B16 480² in bf16: the counted chain,
    each block against its plain version and the fp32 function, the small
    cases, per-stage times. ``routes`` without ``K8-sm90`` only for an older
    tree (``--k8-only``), whose bf16 K8 has no tensor-core route."""
    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.models import resnet as rn
    from musketeer_tpu_torch.ops import bottleneck as k8
    from musketeer_tpu_torch.params import from_jax

    sm90 = "K8-sm90" in routes
    cfg = dataclasses.replace(ofa_base(), dtype="bfloat16", use_flash_attention=True)
    params = from_jax(tree, cfg, "cuda", torch.bfloat16)["encoder"]["resnet"]
    images = _inputs(BATCH, SEED)[1].to(torch.bfloat16)

    def chain(x, blocks, fn):
        """A stage's stride-1 blocks through fn, on NHWC views of channels_last x."""
        h = x.permute(0, 2, 3, 1)
        for p in blocks:
            h = fn(h, p)
        return h.permute(0, 3, 1, 2)

    def unfused(h, p):
        return rn._bottleneck(h.permute(0, 3, 1, 2), p).permute(0, 2, 3, 1)

    def fused_recording(h, p):
        block_inputs.append((h, p))
        return k8.fused_bottleneck(h, p)

    with torch.no_grad():
        stage_inputs, block_inputs = {}, []
        _reset_counters(routes)
        x = rn.stem(params, images)
        for s, stride in rn.STAGES:
            x = rn._bottleneck(x, params[f"layer{s}"][0], stride)
            stage_inputs[s] = x
            x = chain(x, params[f"layer{s}"][1:], fused_recording)
        torch.cuda.synchronize()
        launches = _counters(routes)
        want = dict.fromkeys(launches, 0)
        want["K8"] = sum(len(params[f"layer{s}"]) - 1 for s, _ in rn.STAGES)
        if sm90:  # every bf16 block on the tensor-core route
            want["K8-sm90"] = want["K8"]
        log(f"[K8] stage path launches {launches}")
        if launches != want or want["K8"] != 27:
            raise AssertionError(f"K8 stage path: launches {launches}, expected {want}")
        if tuple(x.shape) != (BATCH, 1024, IMAGE // 16, IMAGE // 16) \
                or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"ResNet features {tuple(x.shape)} must be finite "
                                 f"[{BATCH}, 1024, 30, 30]")

        errs, rel_errs = [], []
        for i, (h, p) in enumerate(block_inputs):
            err, msg, top = _k8_bf16(k8, f"block {i}", h, p, sm90)
            errs.append(err)
            rel_errs.append(err / top)
            log(f"[K8] block {i} bf16: max abs err {err:.3e}; {msg}")
        # the seeded BN statistics grow the activations block by block (max|ref|
        # from ~10 to ~1e7), so the error is read against each block's max|ref|
        log(f"[K8] 27 blocks bf16 against the plain version: max abs err {max(errs):.3e}; "
            f"max abs err / max|ref| per block {[float(f'{e:.2e}') for e in rel_errs]}")
        del block_inputs

        # cuDNN picks its algorithms by heuristics unless benchmark mode is on,
        # and then by timing them at the first call of each shape: pinned on
        # here, each chain warmed up, then timed 5 times to give its range; the
        # heuristic choice is timed too, for the comparison
        totals = dict(ms=0.0, plain_ms=0.0, cudnn_block_ms=0.0, bound_ms=0.0, device_ms=0.0,
                      host_ms=0.0, cudnn_device_ms=0.0, cudnn_host_ms=0.0)
        cudnn_lo = cudnn_hi = 0.0
        ops_bound_ms = 0.0  # the part of the chain's bound set by operations
        benchmark = torch.backends.cudnn.benchmark
        for s, _ in rn.STAGES:
            x0, blocks = stage_inputs[s], params[f"layer{s}"][1:]
            work = _k8_work(x0.permute(0, 2, 3, 1), blocks[0])
            fused = lambda: chain(x0, blocks, k8.fused_bottleneck)
            times = {"ms": cuda_ms(fused, 5),
                     "plain_ms": cuda_ms(lambda: chain(x0, blocks, k8.fused_bottleneck_plain), 3)}
            times["device_ms"] = _k8_kernel_ms(fused, 3)
            _, times["host_ms"] = _device_host_ms(fused, 3)
            torch.backends.cudnn.benchmark = False
            heur = [cuda_ms(lambda: chain(x0, blocks, unfused), 10) for _ in range(3)]
            torch.backends.cudnn.benchmark = True
            tuned = [cuda_ms(lambda: chain(x0, blocks, unfused), 10) for _ in range(5)]
            times["cudnn_block_ms"] = statistics.median(tuned)
            times["cudnn_device_ms"], times["cudnn_host_ms"] = _device_host_ms(
                lambda: chain(x0, blocks, unfused), 5)
            n = len(blocks)
            for k, v in times.items():
                totals[k] += v
            cudnn_lo, cudnn_hi = cudnn_lo + min(tuned), cudnn_hi + max(tuned)
            totals["bound_ms"] += n * work["bound_ms"]
            ops_bound_ms += n * work["bound_ms"] * (work["bound_by"] == "operations")
            B, C, H, W = x0.shape
            log(f"[K8] layer{s}: {n} blocks at B{B} {H}x{W} C{C} Wd{blocks[0]['conv1'].shape[0]}: "
                f"kernel {times['ms']:.3f} ms per chain by CUDA events (its kernels' device time "
                f"{times['device_ms']:.3f} ms, the wrapper calls' host time "
                f"{times['host_ms']:.3f} ms), plain {times['plain_ms']:.3f} ms, cuDNN block chain "
                f"{min(tuned):.3f}-{max(tuned):.3f} ms (benchmark mode: device "
                f"{times['cudnn_device_ms']:.3f} ms, host {times['cudnn_host_ms']:.3f} ms; "
                f"heuristics {min(heur):.3f}-{max(heur):.3f} ms); per block kernel "
                f"{times['ms'] / n:.4f} ms, "
                f"bound {work['bound_ms']:.4f} ms ({work['bound_by']}) on {smi}")
        torch.backends.cudnn.benchmark = benchmark
        del stage_inputs
    _k8_checks(g, tree, sm90)
    log(f"[K8] 27-block chain: kernel {totals['ms']:.3f} ms (device {totals['device_ms']:.3f}, "
        f"host {totals['host_ms']:.3f}), plain {totals['plain_ms']:.3f} ms, cuDNN block chain "
        f"{cudnn_lo:.3f}-{cudnn_hi:.3f} ms (device {totals['cudnn_device_ms']:.3f}, host "
        f"{totals['cudnn_host_ms']:.3f}), bound {totals['bound_ms']:.4f} ms on {smi}")
    stats = dict(max_abs_err=max(errs), library_ms=None,
                 bound_by="operations" if ops_bound_ms >= totals["bound_ms"] / 2 else "bytes",
                 cudnn_block_ms_range=[cudnn_lo, cudnn_hi], **totals)
    return stats, launches


# ---------------------------------------------------------------------------
# phase 18: the eval tasks, TSV row to metric
# ---------------------------------------------------------------------------

# 64 closed-set answers for VQA: yes/no, counts, colours, colour + object
_COLOURS = ("red", "blue", "green", "white", "black", "yellow", "brown", "gray")
_OBJECTS = ("dog", "car", "cat", "bus", "tree")
VQA_ANSWERS = (["yes", "no"] + [str(i) for i in range(14)] + list(_COLOURS)
               + [f"{c} {o}" for c in _COLOURS for o in _OBJECTS])
# name: (task class or registry key, TSV rows, image size, evaluate method, batch size)
EVAL_TASKS = {
    "caption": ("CaptionTask", 32, 480, "evaluate", 16),
    "refcoco": ("RefcocoTask", 16, 512, "evaluate", 8),
    "snli_ve": ("SnliVeTask", 16, 480, "evaluate", 8),
    "vqa allcand": ("VqaTask", 16, 480, "evaluate", 4),
    "vqa beam": ("VqaTask", 16, 480, "evaluate_beam", 4),
    "gigaword": ("GigawordTask", 16, None, "evaluate", 8),
}
_SENTENCES = ("a man rides a horse on the beach", "two dogs play with a red ball in the park",
              "a bus parked beside a tall tree", "a cat sleeps on a white sofa near the window")


def _eval_rows(name: str, n: int, size, rng) -> list:
    """``n`` seeded TSV rows in the task's format: smooth random images (a
    random 40 × 30 image upsampled to 4/3 · size × size, PNG, base64) and
    sentences, boxes and answers drawn from small seeded lists."""
    import base64
    import io

    from PIL import Image

    def image():
        small = Image.fromarray(rng.randint(0, 256, (30, 40, 3)).astype("uint8"))
        buf = io.BytesIO()
        small.resize((size * 4 // 3, size), Image.BILINEAR).save(buf, format="PNG")
        return base64.urlsafe_b64encode(buf.getvalue()).decode()

    text = lambda: _SENTENCES[rng.randint(len(_SENTENCES))]
    rows = []
    for i in range(n):
        if name == "caption":
            rows.append([str(i), image(), f"{text()}&&{text()}"])
        elif name == "refcoco":
            x0, y0 = rng.randint(0, size // 2, 2)
            rows.append([str(i), image(), text(), f"{x0}.0,{y0}.0,{x0 + size // 2}.0,{y0 + size // 3}.0"])
        elif name == "snli_ve":
            rows.append([str(i), image(), text(), text(),
                         ("entailment", "neutral", "contradiction")[i % 3]])
        elif name.startswith("vqa"):
            picks = rng.choice(len(VQA_ANSWERS), 3, replace=False)
            ref = "&&".join(f"{c}|!+{VQA_ANSWERS[a]}" for c, a in zip((1.0, 0.6, 0.3), picks))
            rows.append([str(i), image(), f"what is in the picture number {i}", ref])
        else:  # gigaword
            rows.append([f"{text()} , officials said on {text()} .", text()])
    return rows


def _eval_task(name: str, size):
    """The task of ``EVAL_TASKS[name]`` (description "base", the task's image
    size)."""
    from musketeer_tpu_torch import tasks
    from musketeer_tpu_torch.tokenization import default_vocab

    cls = getattr(tasks, EVAL_TASKS[name][0])
    kw = {"patch_image_size": size} if size else {}
    if name.startswith("vqa"):
        kw["answers"] = VQA_ANSWERS
    return cls(default_vocab(), description="base", **kw)


def _has_rouge() -> bool:
    import importlib.util

    return importlib.util.find_spec("rouge_score") is not None


def _run_eval(task, name: str, params, cfg, path: str, batch: int, limit=None):
    """One evaluate call of the task (for gigaword without ``rouge_score``:
    its generation, ``hypotheses``) → its result."""
    from musketeer_tpu_torch.data import FileDataset

    method = EVAL_TASKS[name][3]
    if name == "gigaword" and not _has_rouge():
        method = "hypotheses"
    return getattr(task, method)(params, cfg, FileDataset(path), batch_size=batch, limit=limit)


def _summary(name: str, out) -> str:
    if isinstance(out, list):  # gigaword's hypotheses
        return f"{len(out)} summaries generated (rouge_score missing: no ROUGE); first {out[0][1]!r}"
    return json.dumps({k: v for k, v in out.items() if k not in ("predictions", "pairs")})


def _eval_expected(name: str, cfg, calls: dict) -> dict:
    """K1 and K2 launches of one evaluate call: K1 once per encoder layer of
    every encode and twice per decoder layer (self and cross attention) of
    every teacher-forced decode; K2 once per beam step on the fast path
    (caption, gigaword); nothing else."""
    want = dict.fromkeys(_counter_owners(), 0)
    want["K1"] = cfg.encoder_layers * calls["encode"] + 2 * cfg.decoder_layers * calls["decode"]
    if name in ("caption", "gigaword"):
        want["K2"] = want["K2-sm90"] = calls["decode_step"]
    return want


def _snapshot(t):
    """A copy of a tensor argument with the same strides (a view of a wider
    table stays such a view), so that a kernel call can be replayed later."""
    if not torch.is_tensor(t):
        return t
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)


def _recording(fn, calls: dict, key):
    """``fn``, keeping the arguments of its first call for each ``key(*args)``."""
    def call(*a, **kw):
        calls.setdefault(key(*a, **kw), ([_snapshot(t) for t in a], kw))
        return fn(*a, **kw)
    return call


def _k1_key(q, k, v, pos_q, pos_k, rel, kpad, causal=False, skip_max=False):
    return (f"B{q.shape[0]} H{q.shape[1]} T{q.shape[2]} S{k.shape[2]} D{q.shape[3]}"
            f"{' rel' if rel is not None else ''}{' causal' if causal else ''}"
            f"{' skip_max' if skip_max else ''} {str(q.dtype)[6:]}")


def _k2_key(h, w, w_scale=None, vocab_size=None):
    return f"N{h.shape[0]} Vp{w.shape[0]} D{h.shape[1]} {str(w.dtype)[6:]}"


def _recording_k1_k2(k1_calls: dict, k2_calls: dict):
    """The model's K1 and the beam search's K2, keeping the arguments of their
    first call at each shape (one context manager)."""
    from contextlib import ExitStack

    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.ops import topk_projection as k2

    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        importlib.import_module("musketeer_tpu_torch.ops.flash_attention_bwd"),
        "flash_attention_inference", _recording(k1.flash_attention_inference, k1_calls, _k1_key)))
    stack.enter_context(mock.patch.object(
        importlib.import_module("musketeer_tpu_torch.generation.beam_search"),
        "project_with_stats", _recording(k2.project_with_stats, k2_calls, _k2_key)))
    return stack


def _check_eval_calls(tag: str, k1_calls: dict, k2_calls: dict, seen: set) -> None:
    """Each K1 and K2 call of the eval path at a shape not checked before, on
    the inputs the path gave it: against its plain version (bf16, within
    ``BF16_TOL`` · max|ref|; K2's block maxes and logsumexp within
    ``FP32_TOL`` · max|ref|) and against the function in fp32, as phases 3
    and 4 hold K1 and K2."""
    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.ops import topk_projection as k2

    for key, (a, kw) in k1_calls.items():
        if ("K1", key) in seen:
            continue
        seen.add(("K1", key))
        out, ref = k1.flash_attention_inference(*a, **kw), k1.flash_attention_plain(*a, **kw)
        err = _check_close(f"K1 {tag} {key}", out, ref, BF16_TOL)
        fn_msg = _check_function(f"K1 {tag} {key}", out, ref, k1.flash_attention_plain(*_widened(a), **kw))
        log(f"[K1 {tag}] {key}: max abs err {err:.3e}; {fn_msg}")
    for key, (a, kw) in k2_calls.items():
        if ("K2", key) in seen:
            continue
        seen.add(("K2", key))
        vs = kw["vocab_size"]
        out, ref = k2.project_with_stats(*a, **kw), k2.project_plain(*a, **kw)
        real = lambda t: t[:, :vs]
        err = _check_close(f"K2 {tag} {key} logits", real(out[0]), real(ref[0]), BF16_TOL)
        stats = [_check_close(f"K2 {tag} {key} {n}", x, y, FP32_TOL)
                 for n, x, y in zip(("bmax", "Z"), out[1:], ref[1:])]
        fn_msg = _check_function(f"K2 {tag} {key} logits", real(out[0]), real(ref[0]),
                                 real(k2.project_plain(*_widened(a), **kw)[0]))
        if not bool((out[0][:, vs:] == k2.NEG_INF).all()):
            raise AssertionError(f"K2 {tag} {key}: padded vocab columns must be -1e9")
        log(f"[K2 {tag}] {key}: max abs err logits {err:.3e} bmax {stats[0]:.3e} Z "
            f"{stats[1]:.3e}; logits {fn_msg}")


def phase_eval(tree, smi: str, tmp: str) -> dict:
    """Phase 18: each eval task at ``ofa_base`` in bf16, full width and depth,
    through its own ``evaluate`` on a seeded TSV: the K1 and K2 counters
    against the encodes, teacher-forced decodes and beam steps it ran; each
    K1 and K2 shape it reached, on its own inputs, against the plain version
    and the fp32 function; its metric, rows/s, and device against host time;
    then at batch 2 in fp32 through the kernels and through their plain
    versions: identical predictions. → each task's launches."""
    import os

    import numpy as np
    import PIL
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.params import from_jax

    log(f"[eval] PIL {PIL.__version__}: the builders decode the TSV's images")
    cfg = dataclasses.replace(ofa_base(), dtype="bfloat16", use_flash_attention=True)
    params = from_jax(tree, cfg, "cuda", torch.bfloat16)
    rng = np.random.RandomState(SEED)
    paths = {}
    for name, (_, n, size, _, _) in EVAL_TASKS.items():
        paths[name] = os.path.join(tmp, f"{name.replace(' ', '_')}.tsv")
        with open(paths[name], "w") as f:
            f.writelines("\t".join(r) + "\n" for r in _eval_rows(name, n, size, rng))
    launches, seen = {}, set()
    for name, (_, n, size, _, batch) in EVAL_TASKS.items():
        task = _eval_task(name, size)
        tag = f"[eval {name}]"
        k1_calls, k2_calls = {}, {}
        _reset_counters()
        with mock.patch.object(ofa, "encode", wraps=ofa.encode) as enc, \
                mock.patch.object(ofa, "decode", wraps=ofa.decode) as dec, \
                mock.patch.object(ofa, "decode_step", wraps=ofa.decode_step) as steps, \
                _recording_k1_k2(k1_calls, k2_calls):
            out = _run_eval(task, name, params, cfg, paths[name], batch)
        got = _counters()
        calls = dict(encode=enc.call_count, decode=dec.call_count, decode_step=steps.call_count)
        want = _eval_expected(name, cfg, calls)
        log(f"{tag} launches {{K1: {got['K1']}, K2: {got['K2']}}} over {calls}")
        if got != want or enc.call_count != n // batch:
            raise AssertionError(f"{name}: launches {got}, expected {want} ({calls})")
        launches[name] = got
        _check_eval_calls(name, k1_calls, k2_calls, seen)
        del k1_calls, k2_calls

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _run_eval(task, name, params, cfg, paths[name], batch)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _run_eval(task, name, params, cfg, paths[name], batch)
            torch.cuda.synchronize()
        dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA) / 1e3
        log(f"{tag} {_summary(name, out)}; ofa_base bf16, {n} rows at batch {batch}: "
            f"{n / host_s:.2f} rows/s, host {host_s * 1e3:.1f} ms (data, encode, search or "
            f"scoring, metric) against device {dev_ms:.1f} ms (busy share "
            f"{dev_ms / (host_s * 1e3):.3f}) on {smi}")
    _eval_exactness(tree, paths)
    return launches


def _eval_exactness(tree, paths: dict) -> None:
    """Each eval task at batch 2 in fp32, through the kernels and through
    their plain versions: identical predictions (beam tokens, allcand picks),
    and scores within ``FP32_TOL`` · max(1, max|ref|)."""
    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.ops import topk_projection as k2
    from musketeer_tpu_torch.params import from_jax

    tasks_module = importlib.import_module("musketeer_tpu_torch.tasks.tasks")
    search_module = importlib.import_module("musketeer_tpu_torch.generation.beam_search")
    attn_module = importlib.import_module("musketeer_tpu_torch.ops.flash_attention_bwd")
    cfg = dataclasses.replace(ofa_base(), dtype="float32", use_flash_attention=True)
    params = from_jax(tree, cfg, "cuda", torch.float32)

    def recorded(name: str, plain: bool):
        record = []

        def keep(fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                record.append([t.cpu() for t in (out if isinstance(out, tuple) else (out,))])
                return out
            return call

        with mock.patch.object(tasks_module, "generate", keep(tasks_module.generate)), \
                mock.patch.object(tasks_module, "score_candidates_span",
                                  keep(tasks_module.score_candidates_span)), \
                mock.patch.object(attn_module, "flash_attention_inference",
                                  k1.flash_attention_plain if plain else k1.flash_attention_inference), \
                mock.patch.object(search_module, "project_with_stats",
                                  k2.project_plain if plain else k2.project_with_stats):
            task = _eval_task(name, EVAL_TASKS[name][2])
            out = _run_eval(task, name, params, cfg, paths[name], 2, limit=2)
        return out, record

    for name in EVAL_TASKS:
        before = _counters()
        out_k, rec_k = recorded(name, False)
        mid = _counters()
        out_p, rec_p = recorded(name, True)
        after = _counters()
        fast = name in ("caption", "gigaword")
        if mid["K1"] == before["K1"] or (mid["K2"] > before["K2"]) != fast or after != mid:
            raise AssertionError(f"{name}: kernel/plain routing wrong: {before} {mid} {after}")
        allcand = "allcand" in name or name == "snli_ve"
        # beam tokens, or the allcand scores' argmax, and the task's own output
        preds = lambda rec: [r[0].argmax(-1) if allcand else r[0] for r in rec]
        same = all(torch.equal(a, b) for a, b in zip(preds(rec_k), preds(rec_p)))
        if not len(rec_k) == len(rec_p) > 0:
            raise AssertionError(f"{name}: {len(rec_k)} and {len(rec_p)} recorded calls")
        diff = max(_max_err(a[-1], b[-1]) for a, b in zip(rec_k, rec_p))
        lim = FP32_TOL * max(1.0, *(float(b[-1].abs().max()) for b in rec_p))
        log(f"[eval {name} exact] fp32 batch 2: {'scores' if allcand else 'beam scores'} "
            f"max diff {diff:.3e} (tol {lim:.3e}); predictions identical: {same and out_k == out_p}")
        if not (same and out_k == out_p):
            raise AssertionError(f"{name}: fp32 predictions through the kernels differ from the "
                                 "plain versions'")
        if not diff <= lim:
            raise AssertionError(f"{name}: fp32 scores through the kernels differ from the plain "
                                 f"versions' by {diff:.3e} > {lim:.3e}")


# ---------------------------------------------------------------------------
# phase 19: the entry points (the CLI) on a NormFormer ofa_base
# ---------------------------------------------------------------------------

NORMFORMER = ("scale_attn", "scale_fc", "scale_heads", "scale_resids")
ENTRY_TASKS = ("caption", "vqa_gen", "snli_ve")
ENTRY_ROWS = 16  # per training TSV: 6 updates at batch 2 fit one epoch
ENTRY_EVAL_ROWS, ENTRY_EVAL_BATCH = 32, 16
ENTRY_UPDATES = (4, 6)  # a run to 4 updates, then a resumed run to 6
# a run resumed at update 2 against the straight run at 4: the state read back,
# the iterator position and the (seed, update) dropout draws make the same
# two updates, and only the order of a few fp32 sums on the card may differ,
# which moves the state by far less than this share of the two updates' change;
# a wrong moment, step count, batch or dropout draw moves it by its own size
RESUME_TOL = 1e-3


def _normformer_tree(seed: int):
    """``ofa_base`` with all four NormFormer options: ``_random_model_tree``
    with every NormFormer leaf drawn from a seed (c_attn and w_resid in
    [0.5, 1.5), the extra LayerNorms' scales too, their biases N(0, 0.1)),
    so that a dropped multiply or LayerNorm would show."""
    from musketeer_tpu_torch.config import ofa_base

    cfg = dataclasses.replace(ofa_base(), use_flash_attention=True, **dict.fromkeys(NORMFORMER, True))
    tree = _random_model_tree(cfg, seed)
    g = torch.Generator().manual_seed(seed + 19)

    def walk(node):
        for k, v in node.items():
            if k in ("c_attn", "w_resid"):
                node[k] = torch.rand(v.shape, generator=g) + 0.5
            elif k in ("attn_ln", "self_attn_ln", "cross_attn_ln", "ffn_layernorm"):
                v["scale"] = torch.rand(v["scale"].shape, generator=g) + 0.5
                v["bias"] = torch.randn(v["bias"].shape, generator=g) * 0.1
            elif isinstance(v, dict):
                walk(v)

    walk(tree)
    return cfg, tree


def _flat(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _flat(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _assert_bitwise(got, want, what: str) -> int:
    """Same leaves, dtypes and values, bit for bit → the number of leaves."""
    a, b = _flat(got), _flat(want)
    if [p for p, _ in a] != [p for p, _ in b]:
        raise AssertionError(f"{what}: the trees' leaves differ")
    for (path, x), (_, y) in zip(a, b):
        if x.dtype != y.dtype or not torch.equal(x.detach().cpu(), y.detach().cpu()):
            raise AssertionError(f"{what}: leaf {path} differs")
    return len(a)


def _timed(fn, record: list):
    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        record.append(time.perf_counter() - t0)
        return out
    return call


def _k4_key(q, k, v, pos_q, pos_k, rel, kpad, o, lse, do, causal=False, need_drel=True):
    return _k1_key(q, k, v, pos_q, pos_k, rel, kpad, causal) + (
        " drel" if need_drel and rel is not None else "")


def _recording_attention(k3_calls: dict, k4_calls: dict):
    """The model's K3/K4 autograd Function, keeping the arguments of its first
    K3 and K4 call at each shape; a K3 call inside a backward (``--remat``'s
    recompute of a checkpointed layer) is kept apart, under its key plus
    " recompute". (The kernel wrappers count their launches through their
    module's names, so those names stay as they are.)"""
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb

    parent = kb.FlashAttentionTrainable

    class Recording(parent):
        @staticmethod
        def forward(ctx, *args):
            key = _k1_key(*args)
            if torch._C._current_graph_task_id() != -1:
                key += " recompute"
            k3_calls.setdefault(key, ([_snapshot(t) for t in args], {}))
            return parent.forward(ctx, *args)

        @staticmethod
        def backward(ctx, do):
            # the saved tensors are unpacked once (a checkpointed layer's may
            # be unpacked only once) and handed on to the parent's backward
            ctx = _Unpacked(ctx)
            # K4's arguments as the parent's backward passes them
            args = (*ctx.saved_tensors, do.contiguous(), ctx.causal, ctx.needs_input_grad[5])
            k4_calls.setdefault(_k4_key(*args), ([_snapshot(t) for t in args], {}))
            return parent.backward(ctx, do)

    return Recording


class _Unpacked:
    """An autograd ctx whose ``saved_tensors`` were unpacked once."""

    def __init__(self, ctx):
        self._ctx = ctx
        self.saved_tensors = ctx.saved_tensors

    def __getattr__(self, name):
        return getattr(self._ctx, name)


def _gap(got, want, base=None) -> float:
    """‖got − want‖ / ‖want − base‖ over every leaf of two trees (‖want‖ with
    no ``base``), in fp64."""
    num = den = 0.0
    base = _flat(base) if base is not None else [(p, None) for p, _ in _flat(want)]
    for (path, a), (_, b), (_, c) in zip(_flat(got), _flat(want), base):
        a, b = a.detach().double(), b.detach().double()
        num += float((a - b).pow(2).sum())
        den += float((b if c is None else b - c.detach().double()).pow(2).sum())
    return (num / den) ** 0.5 if den else float("inf")


def _check_resume(resumed, straight, mid) -> str:
    """The state of a run resumed from ``mid``'s checkpoint against the
    straight run's at the same update: parameters and EMA within
    ``RESUME_TOL`` of the change since ``mid``, the AdamW moments within
    ``RESUME_TOL`` of their norm, the same step and AdamW count."""
    count = lambda st: (st.step, int(st.opt_state["count"]))
    if count(resumed) != count(straight):
        raise AssertionError(f"resumed run at step {resumed.step}, the straight run at "
                             f"{straight.step}")
    gaps = {"params": _gap(resumed.params, straight.params, mid.params),
            "ema": _gap(resumed.ema_params, straight.ema_params, mid.ema_params),
            "mu": _gap(resumed.opt_state["mu"], straight.opt_state["mu"]),
            "nu": _gap(resumed.opt_state["nu"], straight.opt_state["nu"])}
    if not all(g <= RESUME_TOL for g in gaps.values()):
        raise AssertionError(f"the resumed run's state differs from the straight run's: {gaps}")
    return ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())


def _check_train_calls(tag: str, k3_calls: dict, k4_calls: dict, seen: set = None) -> int:
    """Each K3 and K4 call of a training run at a new shape (one not in
    ``seen``, which then gets it), on the inputs the run gave it, against its
    plain version and the function in fp32 (as phase 7). → the calls held."""
    seen = set() if seen is None else seen
    n = 0
    for kernel, calls, check in (("K3", k3_calls, _check_k3), ("K4", k4_calls, _check_k4)):
        for key, (a, kw) in calls.items():
            if (kernel, key) not in seen:
                seen.add((kernel, key))
                check(f"{tag} {key}", a, kw)
                n += 1
    return n


def _check_task_losses(tag: str, losses: list, tasks, updates: int, vocab_size: int,
                       conf=None) -> float:
    """``updates`` updates' losses, each with one entry per task and the
    total, and each task's in (0, w · 2 ln V], w its samples' conf weight
    (``conf`` by task, else 1): near ln V for a seeded model on the open
    vocabulary, ln of the choices under a trie; outside it the loss, the masks
    or the update is wrong. → 2 ln V."""
    top = 2 * math.log(vocab_size)
    keys = sorted(["loss", "loss/total"] + [f"loss/{t}" for t in tasks])
    bad = [(i + 1, k, v) for i, m in enumerate(losses) for k, v in m.items()
           if k.startswith("loss/") and k != "loss/total"
           and not 0.0 < v <= top * (conf or {}).get(k[len("loss/"):], 1.0)]
    if len(losses) != updates or bad or any(sorted(m) != keys for m in losses):
        raise AssertionError(f"{tag}: {len(losses)} updates (expected {updates}); a task's loss "
                             f"outside (0, w · {top:.2f}] or a loss missing: {bad or losses}")
    return top


def _entry_train(cfg, pt: str, tmp: str, smi: str, phase8_ms, mfu: dict = None) -> dict:
    """``cli train`` on caption, vqa_gen and snli_ve (batch 2 each, uint8
    transport, prefetch depth 2) from the NormFormer ``.pt``: 4 updates with
    saves every 2, then a resumed run to 6. Each task's loss in (0, 2 ln V]
    at every update; each K3 and K4 shape of the loop held to its plain
    version; a third run, resumed from update 2's checkpoint to 4, against
    the straight run's state at 4. → K1-K8 launches of the first two runs;
    ``mfu`` gets the step's FLOPs and time (phase 22)."""
    import glob
    import os
    import shutil

    import numpy as np

    from musketeer_tpu_torch import cli
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.training import checkpoint as ckpt_module
    from musketeer_tpu_torch.training import trainer as trainer_module

    rng = np.random.RandomState(SEED + 19)
    paths = {}
    for name in ENTRY_TASKS:
        paths[name] = os.path.join(tmp, f"train_{name}.tsv")
        rows = _eval_rows("vqa" if name == "vqa_gen" else name, ENTRY_ROWS, IMAGE, rng)
        with open(paths[name], "w") as f:
            f.writelines("\t".join(r) + "\n" for r in rows)
    run_dir, twin_dir = os.path.join(tmp, "run"), os.path.join(tmp, "resumed_at_2")

    def args(save_dir: str, updates: int) -> list:
        return ["train", "--tasks", ",".join(f"{n}={paths[n]}" for n in ENTRY_TASKS),
                "--arch", "ofa_base", "--device", "cuda", "--batch-size", "2",
                "--restore-pt", pt, "--save-dir", save_dir, "--save-interval-updates", "2",
                "--ema-decay", "0.999", "--warmup-updates", "1", "--prefetch-depth", "2",
                "--max-update", str(updates)]

    # vqa_gen trains against its answer list's trie, as a library caller
    # passes it in SubTaskSpec.task_kwargs; the CLI passes none (nor does
    # the JAX CLI), and without one every answer token is masked
    task_kwargs = cli._task_kwargs

    def with_answers(name: str, patch_image_size: int) -> dict:
        kw = task_kwargs(name, patch_image_size)
        return {**kw, "answers": VQA_ANSWERS} if name == "vqa_gen" else kw

    rec = dict(step=[], start=[], secs=[], forwards=[], losses=[], shapes=[])
    saves, loads, prefetchers, k3_calls, k4_calls = [], [], [], {}, {}
    make_train_step = trainer_module.make_train_step
    prefetch_cls = trainer_module.PrefetchIterator

    def recording_prefetch(*a, **kw):
        it = prefetch_cls(*a, **kw)
        prefetchers.append(it)
        return it

    def recording_make(*a, **kw):
        step = make_train_step(*a, **kw)

        def recorded(state, batches, generator=None):
            rec["step"].append(state.step)
            rec["forwards"].append(_expected_forwards(batches))
            rec["shapes"].append(_batch_shapes(batches))
            t0 = time.perf_counter()
            rec["start"].append(t0)
            state, m = step(state, batches, generator)
            rec["secs"].append(time.perf_counter() - t0)
            rec["losses"].append({k: v.detach() for k, v in m.items() if k.startswith("loss")})
            return state, m
        return recorded

    _reset_counters()
    with mock.patch.object(cli, "_task_kwargs", with_answers), \
            mock.patch.object(trainer_module, "make_train_step", recording_make), \
            mock.patch.object(ofa, "forward", wraps=ofa.forward) as fwd, \
            mock.patch.object(kb, "FlashAttentionTrainable",
                              _recording_attention(k3_calls, k4_calls)), \
            mock.patch.object(ckpt_module, "save_checkpoint",
                              _timed(ckpt_module.save_checkpoint, saves)), \
            mock.patch.object(ckpt_module, "load_checkpoint",
                              _timed(ckpt_module.load_checkpoint, loads)), \
            mock.patch.object(trainer_module, "PrefetchIterator", recording_prefetch):
        states, walls = [], []
        for updates in ENTRY_UPDATES:
            t0 = time.perf_counter()
            states.append(cli.main(args(run_dir, updates)))
            walls.append(time.perf_counter() - t0)
            if updates == ENTRY_UPDATES[0]:  # update 2's checkpoint, for the third run
                (mid,) = glob.glob(os.path.join(run_dir, "checkpoint_*_2"))
                os.makedirs(twin_dir)
                for ext in ("", ".meta.json"):
                    shutil.copy(mid + ext, os.path.join(twin_dir, "checkpoint_last" + ext))
    launches = _counters()
    per_forward = cfg.encoder_layers + 2 * cfg.decoder_layers
    forwards = sum(rec["forwards"])
    want = dict.fromkeys(launches, 0)
    want.update({"K3": per_forward * forwards, "K4": per_forward * forwards})
    losses = [{k: float(v) for k, v in m.items()} for m in rec["losses"]]
    log(f"[entry train] launches {launches} over {fwd.call_count} transformer forwards "
        f"(expected {forwards} from the packing groups, {per_forward} attentions each) in "
        f"{len(rec['step'])} updates; losses by update {losses}")
    if fwd.call_count != forwards or launches != want:
        raise AssertionError(f"cli train: launches {launches}, expected {want}")
    first, last = ENTRY_UPDATES
    _check_task_losses("cli train", losses, ENTRY_TASKS, last, cfg.vocab_size)
    if [s.step for s in states] != list(ENTRY_UPDATES) or rec["step"] != list(range(last)):
        raise AssertionError(f"cli train: updates {[s.step for s in states]}, steps {rec['step']}")
    if len(loads) != 1:
        raise AssertionError(f"the resumed run must load checkpoint_last once, loaded {len(loads)}")
    # the loop's time per update: between successive step starts of one run,
    # leaving out the intervals that hold a checkpoint save
    saved_after = {u for u in range(1, last + 1) if u % 2 == 0}
    intervals = [rec["start"][i + 1] - rec["start"][i] for i in range(last - 1)
                 if i + 1 != first and (i + 1) not in saved_after]
    loop_ms = statistics.median(intervals) * 1e3
    step_ms = statistics.median(rec["secs"][1:]) * 1e3
    state_gb = sum(t.numel() * t.element_size() for _, t in _flat({
        "p": states[-1].params, "mu": states[-1].opt_state["mu"],
        "nu": states[-1].opt_state["nu"], "e": states[-1].ema_params})) / 1e9
    log(f"[entry train] ofa_base bf16 NormFormer, {len(ENTRY_TASKS)} tasks x batch 2: loop "
        f"{loop_ms:.1f} ms per update ({1e3 / loop_ms:.2f} updates/s; intervals without a save "
        f"{[round(x * 1e3, 1) for x in intervals]} ms), the step call {step_ms:.1f} ms "
        f"(median after the first: host share of the loop outside the step "
        f"{max(0.0, loop_ms - step_ms) / loop_ms:.3f})"
        + (f", phase 8's 8-task step p50 {phase8_ms:.1f} ms" if phase8_ms else "")
        + f"; runs {[round(w, 1) for w in walls]} s on {smi}")
    if mfu is not None:  # the step's FLOPs by utils/flops.py (the CLI trains without R-Drop)
        mfu.update(flops=[_step_flops(cfg, sh, rdrop=False) for sh in rec["shapes"][1:]],
                   secs=rec["secs"][1:], shapes=rec["shapes"][1])
    items = sum(p.producer_items for p in prefetchers)
    log(f"[entry train] prefetch (depth 2, the copy to the card in its thread): {items} "
        f"batches, the producer {sum(p.producer_wall_s for p in prefetchers) / items * 1e3:.1f} "
        f"ms wall and {sum(p.producer_cpu_s for p in prefetchers) / items * 1e3:.1f} ms CPU a "
        f"batch; the loop waited {sum(p.stall_s for p in prefetchers) * 1e3:.1f} ms in all, "
        f"{sum(p.stall_count for p in prefetchers)} times over 1 ms")
    log(f"[entry train] checkpoint state {state_gb:.2f} GB (fp32 params, AdamW moments, EMA): "
        f"{len(saves)} saves {[round(x, 2) for x in saves]} s, resume load "
        f"{loads[0]:.2f} s on {smi}")
    # a third run, resumed from update 2's checkpoint, to 4: the straight run's state
    with mock.patch.object(cli, "_task_kwargs", with_answers):
        twin = cli.main(args(twin_dir, first))
    mid_state, _ = ckpt_module.load_checkpoint(run_dir, None, os.path.basename(mid), device="cuda")
    log(f"[entry train] resumed at update 2 to {first} against the straight run, "
        f"relative gaps: {_check_resume(twin, states[0], mid_state)} (bound {RESUME_TOL})")
    del twin, mid_state, states
    _check_train_calls("entry train", k3_calls, k4_calls)
    log(f"[entry train] {len(k3_calls)} K3 and {len(k4_calls)} K4 shapes of the loop held to "
        f"their plain versions and the fp32 function")
    return launches


def _entry_eval(cfg, pt: str, tmp: str, smi: str) -> dict:
    """``cli evaluate --task caption`` from the run's checkpoint_last with
    ``--use-ema`` and from the ``.pt``, on a 32-row TSV at batch 16, with
    ``decode_stack_kernel`` set (its refusal of a NormFormer model is what is
    checked). ``evaluate`` runs the preset's (and the ``.pt``'s inferred)
    ``use_flash_attention``, False, as the JAX CLI does: the encoder takes
    the XLA branch, 6 calls per encode, and K1 is never launched; K2 once per
    beam step on its tensor-core route, K7 never. → the launches of each run."""
    import os

    import numpy as np

    from musketeer_tpu_torch import cli
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.tasks import tasks as tasks_module

    path = os.path.join(tmp, "eval_caption.tsv")
    with open(path, "w") as f:
        f.writelines("\t".join(r) + "\n" for r in _eval_rows(
            "caption", ENTRY_EVAL_ROWS, IMAGE, np.random.RandomState(SEED + 20)))
    init_state = ofa.init_decoder_state

    def with_stack_flag(params, model_cfg, *a, **kw):
        return init_state(params, dataclasses.replace(model_cfg, decode_stack_kernel=True), *a, **kw)

    runs = {"ckpt --use-ema": ["--ckpt", os.path.join(tmp, "run", "checkpoint_last"), "--use-ema"],
            "pt": ["--pt", pt]}
    launches = {}
    for run, src in runs.items():
        evals = []
        _reset_counters()
        with mock.patch.object(ofa, "init_decoder_state", with_stack_flag), \
                mock.patch.object(ofa, "encode", wraps=ofa.encode) as enc, \
                mock.patch.object(ofa, "decode_step", wraps=ofa.decode_step) as steps, \
                mock.patch.object(tasks_module.CaptionTask, "evaluate",
                                  _timed(tasks_module.CaptionTask.evaluate, evals)):
            t0 = time.perf_counter()
            out = cli.main(["evaluate", "--task", "caption", "--data", path, "--device", "cuda",
                            "--arch", "ofa_base", "--batch-size", str(ENTRY_EVAL_BATCH), *src])
            wall = time.perf_counter() - t0
        got = _counters()
        want = dict.fromkeys(got, 0)
        want["XLA"] = cfg.encoder_layers * enc.call_count  # the preset's branch: no K1
        want["K2"] = want["K2-sm90"] = steps.call_count
        log(f"[entry eval {run}] launches {{K1: {got['K1']}, XLA: {got['XLA']}, K2: {got['K2']}, "
            f"K2-sm90: {got['K2-sm90']}, K7: {got['K7']}}} over {enc.call_count} encodes and "
            f"{steps.call_count} beam steps; cider {out['cider']:.4f}")
        if got != want or enc.call_count != ENTRY_EVAL_ROWS // ENTRY_EVAL_BATCH \
                or out["n"] != ENTRY_EVAL_ROWS:
            raise AssertionError(f"cli evaluate ({run}): launches {got}, expected {want}")
        log(f"[entry eval {run}] ofa_base bf16 NormFormer caption, {ENTRY_EVAL_ROWS} rows at "
            f"batch {ENTRY_EVAL_BATCH}: evaluate {ENTRY_EVAL_ROWS / evals[0]:.2f} rows/s "
            f"({evals[0]:.2f} s; the CLI call {wall:.2f} s with the checkpoint's load) on {smi}")
        launches[f"eval {run}"] = got
    return launches


def phase_entry(smi: str, tmp: str, phase8_ms=None, mfu: dict = None) -> dict:
    """Phase 19: the port's CLI, the way a user runs it, on ``ofa_base`` in
    bf16 at full width and depth with all four NormFormer options (their
    leaves drawn from a seed). → K1-K8 launches of each CLI run; ``mfu``
    gets the training step's FLOPs and time."""
    import os

    from musketeer_tpu_torch.params import from_jax
    from musketeer_tpu_torch.training.checkpoint import export_pt, import_pt, load_checkpoint

    cfg, tree = _normformer_tree(SEED)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = from_jax(tree, cfg, "cpu", torch.float32)
    pt = os.path.join(tmp, "normformer_ofa_base.pt")
    t0 = time.perf_counter()
    export_pt(params, cfg, pt)
    export_s = time.perf_counter() - t0
    # 1. convert, in a process of its own, as a user runs it
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "musketeer_tpu_torch.cli", "convert", "--pt", pt,
                    "--out", os.path.join(tmp, "converted"), "--device", "cuda"],
                   cwd=os.path.dirname(os.path.abspath(__file__)), check=True)
    convert_s = time.perf_counter() - t0
    back, back_cfg = import_pt(pt, device="cpu")
    n = _assert_bitwise(back, params, "import_pt of the exported .pt")
    converted, _ = load_checkpoint(tmp, None, "converted", device="cpu")
    _assert_bitwise(converted.params, params, "cli convert's checkpoint")
    if not all(getattr(back_cfg, o) for o in NORMFORMER):
        raise AssertionError(f"infer_config lost a NormFormer option: {back_cfg}")
    log(f"[entry convert] export_pt {export_s:.2f} s; cli convert (its own process) "
        f"{convert_s:.2f} s; import_pt and the converted checkpoint: all {n} leaves bit for bit")
    launches = {"train": _entry_train(cfg, pt, tmp, smi, phase8_ms, mfu)}
    launches.update(_entry_eval(cfg, pt, tmp, smi))
    # 4. the NormFormer caption slice in fp32 through the kernels and the plain versions
    phase_exactness(tree, "slice", dict.fromkeys(NORMFORMER, True))
    return launches


# ---------------------------------------------------------------------------
# phase 20: the XLA attention branch and the detection and pretraining tasks
# ---------------------------------------------------------------------------

XLA_EVAL_ROWS, XLA_EVAL_BATCH = 8, 4
JOINT_ROWS, JOINT_UPDATES, JOINT_PATCHES = 12, 6, 196  # 6 updates at batch 2: one epoch
JOINT_CONF = {"pure_image": 2.0, "detection": 2.0}  # their builders' conf weights
OPTION_TREE = dict(use_adapter=True, encoder_prompt=True, decoder_prompt=True)
# one update each at ofa_base (flash config): model options, and whether the
# encoder and the decoder leave the flash branch (the JAX model's gates)
OPTION_CASES = {
    "attention_dropout 0.1": (dict(attention_dropout=0.1), True, True),
    "encoder + decoder prompts (100)": (dict(encoder_prompt=True, decoder_prompt=True), True, True),
    "adapter (200)": (dict(use_adapter=True), False, False),
    "interpolate_position (480² over 256²)": (dict(interpolate_position=True), False, False),
    "train_bn": ({}, False, False),
}


def _strip_options(tree: dict, cfg) -> dict:
    """``tree`` (the JAX layout) without the adapter and prompt leaves ``cfg``
    does not turn on."""
    out = {**tree, "encoder": dict(tree["encoder"]), "decoder": dict(tree["decoder"])}
    for side, prompt in (("encoder", cfg.encoder_prompt), ("decoder", cfg.decoder_prompt)):
        if not prompt:
            out[side].pop("prompt_embedding", None)
        if not cfg.use_adapter:
            out[side]["layers"] = {k: v for k, v in out[side]["layers"].items() if k != "adapter"}
    return out


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def _xla_eval(tree, tmp: str, smi: str) -> dict:
    """(a) ``cli evaluate --task caption --arch ofa_base`` under the preset
    (``use_flash_attention`` False: the XLA branch) in bf16 and fp32, and in
    fp32 with the flag set (K1): the XLA runs launch no K1, the fp32 tokens of
    the two branches are equal and their scores within ``FP32_TOL``; each K2
    shape of the bf16 run held to its plain version and the fp32 function."""
    import os

    import numpy as np

    from musketeer_tpu_torch import cli
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.params import from_jax
    from musketeer_tpu_torch.tasks import tasks as tasks_module

    path = os.path.join(tmp, "xla_caption.tsv")
    with open(path, "w") as f:
        f.writelines("\t".join(r) + "\n" for r in _eval_rows(
            "caption", XLA_EVAL_ROWS, IMAGE, np.random.RandomState(SEED + 21)))
    preset, generate = cli._preset, tasks_module.generate
    runs = {"bf16": dict(dtype="bfloat16"), "fp32": dict(dtype="float32"),
            "fp32 flash": dict(dtype="float32", use_flash_attention=True)}
    launches, outputs, seen = {}, {}, set()
    for run, over in runs.items():
        gens, k1_calls, k2_calls = [], {}, {}

        def recording(*a, **kw):
            out = generate(*a, **kw)
            gens.append(out)
            return out

        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        with mock.patch.object(cli, "_preset", lambda arch: dataclasses.replace(preset(arch), **over)), \
                mock.patch.object(cli, "_seeded_params",
                                  lambda cfg, seed, device, dtype: from_jax(tree, cfg, device, dtype)), \
                mock.patch.object(tasks_module, "generate", recording), \
                mock.patch.object(ofa, "encode", wraps=ofa.encode) as enc, \
                mock.patch.object(ofa, "decode_step", wraps=ofa.decode_step) as steps, \
                _recording_k1_k2(k1_calls, k2_calls):
            t0 = time.perf_counter()
            out = cli.main(["evaluate", "--task", "caption", "--data", path, "--device", "cuda",
                            "--arch", "ofa_base", "--batch-size", str(XLA_EVAL_BATCH),
                            "--patch-image-size", str(IMAGE)])
            secs = time.perf_counter() - t0
        cfg = dataclasses.replace(preset("ofa_base"), **over)
        got = _counters()
        want = dict.fromkeys(got, 0)
        want["K1" if cfg.use_flash_attention else "XLA"] = cfg.encoder_layers * enc.call_count
        want["K2"] = steps.call_count
        if cfg.dtype == "bfloat16":
            want["K2-sm90"] = steps.call_count
        tokens = torch.cat([g[0] for g in gens])
        scores = torch.cat([g[1] for g in gens])
        log(f"[xla eval {run}] launches {{K1: {got['K1']}, XLA: {got['XLA']}, K2: {got['K2']}}} "
            f"over {enc.call_count} encodes and {steps.call_count} beam steps; cider "
            f"{out['cider']:.4f}; {secs:.2f} s ({XLA_EVAL_ROWS / secs:.2f} rows/s with the "
            f"parameters' build), peak {_peak_gb():.2f} GB on {smi}")
        if got != want or not steps.call_count or enc.call_count != XLA_EVAL_ROWS // XLA_EVAL_BATCH \
                or out["n"] != XLA_EVAL_ROWS or not math.isfinite(out["cider"]):
            raise AssertionError(f"xla eval ({run}): launches {got}, expected {want}")
        _check_tokens(tokens, scores, cfg, XLA_EVAL_ROWS)
        if cfg.dtype == "bfloat16":
            _check_eval_calls(f"xla eval {run}", k1_calls, k2_calls, seen)
        launches[f"xla eval {run}"], outputs[run] = got, (tokens, scores)
        del k1_calls, k2_calls
    (tok_x, sc_x), (tok_f, sc_f) = outputs["fp32"], outputs["fp32 flash"]
    gap, lim = _max_err(sc_x, sc_f), FP32_TOL * float(sc_f.abs().max())
    log(f"[xla eval] fp32 XLA branch against the flash branch: tokens "
        f"{'equal' if torch.equal(tok_x, tok_f) else 'DIFFER'}, max score diff {gap:.3e} "
        f"(tol {lim:.3e}); first hypotheses {tok_x[:2, 0].tolist()}")
    if not torch.equal(tok_x, tok_f) or not gap <= lim:
        raise AssertionError(f"xla eval: the fp32 XLA branch's tokens or scores differ from the "
                             f"flash branch's (score gap {gap:.3e}, tol {lim:.3e})")
    # the cost of the preset's branch: one encode of the caption slice (batch
    # 16, bf16) on each branch, by CUDA events, with its peak memory
    src, images, masks = _inputs(BATCH, SEED)
    params = from_jax(tree, preset("ofa_base"), "cuda", torch.bfloat16)
    times = {}
    for name, flash in (("XLA", False), ("K1", True)):
        cfg = dataclasses.replace(preset("ofa_base"), use_flash_attention=flash)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            times[name] = cuda_ms(lambda: ofa.encode(params, cfg, src, images, masks), 5)
        times[name + " peak GB"] = _peak_gb()
    log(f"[xla eval] one encode of the caption slice (ofa_base bf16, batch {BATCH}, 480²): XLA "
        f"branch {times['XLA']:.2f} ms (peak {times['XLA peak GB']:.2f} GB), K1 branch "
        f"{times['K1']:.2f} ms (peak {times['K1 peak GB']:.2f} GB) by CUDA events on {smi}")
    return launches


def _joint_rows(name: str, n: int, rng) -> list:
    """Seeded TSV rows: caption as phase 18's; pure_image a 256² image with 256
    VQGAN codes; detection a 480² image with two or three labelled boxes."""
    import base64
    import io

    from PIL import Image

    if name == "caption":
        return _eval_rows("caption", n, IMAGE, rng)

    def image(size):
        small = Image.fromarray(rng.randint(0, 256, (30, 40, 3)).astype("uint8"))
        buf = io.BytesIO()
        small.resize((size * 4 // 3, size), Image.BILINEAR).save(buf, format="PNG")
        return base64.urlsafe_b64encode(buf.getvalue()).decode()

    rows = []
    for i in range(n):
        if name == "pure_image":
            rows.append([str(i), image(256), " ".join(str(c) for c in rng.randint(0, 8192, 256))])
        else:  # detection
            boxes = []
            for j in range(2 + i % 2):
                x0, y0 = rng.randint(0, IMAGE // 2, 2)
                boxes.append(f"{x0}.0,{y0}.0,{x0 + IMAGE // 3}.0,{y0 + IMAGE // 4}.0,{j},"
                             f"{_OBJECTS[rng.randint(len(_OBJECTS))]}")
            rows.append([str(i), image(IMAGE), "&&".join(boxes)])
    return rows


def _recording_steps(trainer_module, losses: list):
    """``trainer.make_train_step``, keeping each update's losses."""
    make_train_step = trainer_module.make_train_step

    def make(*a, **kw):
        step = make_train_step(*a, **kw)

        def recorded(state, batches, generator=None):
            state, m = step(state, batches, generator)
            losses.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
            return state, m
        return recorded
    return make


def _joint_recipe(tree, tmp: str, smi: str) -> dict:
    """(b) 6 updates of ``train_loop`` with ``use_flash_attention=True`` on
    caption (the head task, ``sample_patch_num=196``), pure_image and
    detection at batch 2, twice from one seed: each task's loss in range at
    every update, bit-equal between the runs, and each K3 and K4 shape of the
    first run held to its plain version and the fp32 function; then 2
    updates of ``cli train --no-flash`` on the same TSVs."""
    import os

    import numpy as np

    from musketeer_tpu_torch import cli
    from musketeer_tpu_torch.config import OptimConfig, TrainConfig, ofa_base
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.tasks import MusketeerDataLoader, SubTaskSpec
    from musketeer_tpu_torch.tokenization import default_vocab
    from musketeer_tpu_torch.training import init_train_state, train_loop
    from musketeer_tpu_torch.training import trainer as trainer_module

    rng = np.random.RandomState(SEED + 22)
    names = ("caption", "pure_image", "detection")
    paths = {}
    for name in names:
        paths[name] = os.path.join(tmp, f"joint_{name}.tsv")
        with open(paths[name], "w") as f:
            f.writelines("\t".join(r) + "\n" for r in _joint_rows(name, JOINT_ROWS, rng))
    cfg = dataclasses.replace(ofa_base(), use_flash_attention=True)
    train_cfg = TrainConfig(max_update=JOINT_UPDATES, optim=OptimConfig(warmup_updates=1))
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    launches, runs, k3_calls, k4_calls = {}, [], {}, {}
    for run in range(2):
        specs = [SubTaskSpec("caption", paths["caption"], batch_size=2,
                             sample_patch_num=JOINT_PATCHES, task_kwargs={"patch_image_size": IMAGE}),
                 SubTaskSpec("pure_image", paths["pure_image"], batch_size=2),
                 SubTaskSpec("detection", paths["detection"], batch_size=2,
                             task_kwargs={"patch_image_size": IMAGE})]
        loader = MusketeerDataLoader(default_vocab(), specs)
        state = init_train_state(trainable(from_jax(tree, cfg, "cuda", torch.float32)), train_cfg.optim)
        losses = []
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        # the first run keeps each K3 and K4 shape's first arguments
        attention = (_recording_attention(k3_calls, k4_calls) if run == 0
                     else kb.FlashAttentionTrainable)
        try:
            with mock.patch.object(trainer_module, "make_train_step",
                                   _recording_steps(trainer_module, losses)), \
                    mock.patch.object(ofa, "encode", wraps=ofa.encode) as enc, \
                    mock.patch.object(ofa, "decode", wraps=ofa.decode) as dec, \
                    mock.patch.object(kb, "FlashAttentionTrainable", attention):
                t0 = time.perf_counter()
                state = train_loop(train_cfg, cfg, state, loader, max_epoch=1)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
        finally:
            loader.close()
        got = _counters()
        subsampled = sum(c.kwargs.get("sample_patch_order") is not None for c in enc.call_args_list)
        whole = enc.call_count - subsampled
        want = dict.fromkeys(got, 0)
        want["K3"] = want["K4"] = Le * whole + 2 * Ld * dec.call_count
        want["XLA"] = Le * subsampled
        log(f"[joint recipe run {run + 1}] launches {{K3: {got['K3']}, K4: {got['K4']}, XLA: "
            f"{got['XLA']}}} over {whole} whole and {subsampled} subsampled encodes and "
            f"{dec.call_count} decodes in {len(losses)} updates; losses by update "
            f"{[round(m['loss'], 4) for m in losses]} (update 1 by task "
            f"{ {k: round(v, 4) for k, v in losses[0].items() if k.startswith('loss/')} }, "
            f"pure_image and detection weighted by their conf 2.0); {secs:.2f} s "
            f"({len(losses) / secs:.2f} updates/s), peak {_peak_gb():.2f} GB on {smi}")
        if got != want or (whole, subsampled, dec.call_count) != (
                2 * JOINT_UPDATES, JOINT_UPDATES, 3 * JOINT_UPDATES) or state.step != JOINT_UPDATES:
            raise AssertionError(f"joint recipe: launches {got}, expected {want} "
                                 f"({whole} whole, {subsampled} subsampled, {dec.call_count} decodes)")
        _check_task_losses("joint recipe", losses, names, JOINT_UPDATES, cfg.vocab_size, JOINT_CONF)
        launches[f"joint recipe run {run + 1}"] = got
        runs.append(losses)
        del state
    if runs[0] != runs[1]:
        raise AssertionError(f"joint recipe: two runs from one seed differ: {runs}")
    log(f"[joint recipe] two runs from seed {train_cfg.seed}: every task's loss at every update "
        f"bit-equal, each within (0, w · 2 ln V] (w: {JOINT_CONF}, else 1)")
    _check_train_calls("joint recipe", k3_calls, k4_calls)
    log(f"[joint recipe] {len(k3_calls)} K3 and {len(k4_calls)} K4 shapes of the first run held "
        f"to their plain versions and the fp32 function")
    del k3_calls, k4_calls

    # 2 updates of cli train --no-flash on the same TSVs: the XLA branch throughout
    losses = []
    _reset_counters()
    with mock.patch.object(cli, "_seeded_params",
                           lambda cfg, seed, device, dtype: from_jax(tree, cfg, device, dtype)), \
            mock.patch.object(trainer_module, "make_train_step",
                              _recording_steps(trainer_module, losses)), \
            mock.patch.object(ofa, "forward", wraps=ofa.forward) as fwd:
        t0 = time.perf_counter()
        state = cli.main(["train", "--tasks", ",".join(f"{n}={paths[n]}" for n in names),
                          "--arch", "ofa_base", "--device", "cuda", "--batch-size", "2",
                          "--patch-image-size", str(IMAGE), "--warmup-updates", "1",
                          "--max-update", "2", "--no-flash"])
        secs = time.perf_counter() - t0
    got = _counters()
    want = dict.fromkeys(got, 0)
    want["XLA"] = (Le + 2 * Ld) * fwd.call_count
    log(f"[joint recipe cli --no-flash] launches {{K3: {got['K3']}, K4: {got['K4']}, XLA: "
        f"{got['XLA']}}} over {fwd.call_count} forwards in {len(losses)} updates; losses "
        f"{[round(m['loss'], 4) for m in losses]}; {secs:.2f} s on {smi}")
    if got != want or fwd.call_count != 3 * 2 or state.step != 2:
        raise AssertionError(f"cli train --no-flash: launches {got}, expected {want}")
    _check_task_losses("cli train --no-flash", losses, names, 2, cfg.vocab_size, JOINT_CONF)
    launches["cli train --no-flash"] = got
    return launches


def _detection_eval(tree, tmp: str, smi: str) -> dict:
    """``DetectionTask.evaluate`` (teacher-forced loss, beam search, box F1) on
    4 seeded rows at batch 2, in bf16, under the preset (the XLA branch) and
    with ``use_flash_attention`` set (K1): each attention of every encode and
    teacher-forced decode on the branch the flag picks, K2 once per beam step;
    each K1 and K2 shape held to its plain version and the fp32 function."""
    import os

    import numpy as np

    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.data import FileDataset
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.params import from_jax
    from musketeer_tpu_torch.tasks import DetectionTask
    from musketeer_tpu_torch.tokenization import default_vocab

    path = os.path.join(tmp, "eval_detection.tsv")
    with open(path, "w") as f:
        f.writelines("\t".join(r) + "\n" for r in _joint_rows(
            "detection", 4, np.random.RandomState(SEED + 24)))
    launches, seen = {}, set()
    for flash in (False, True):
        cfg = dataclasses.replace(ofa_base(), use_flash_attention=flash)
        params = from_jax(tree, cfg, "cuda", torch.bfloat16)
        task = DetectionTask(default_vocab(), description="base", patch_image_size=IMAGE)
        k1_calls, k2_calls = {}, {}
        _reset_counters()
        with mock.patch.object(ofa, "encode", wraps=ofa.encode) as enc, \
                mock.patch.object(ofa, "decode", wraps=ofa.decode) as dec, \
                mock.patch.object(ofa, "decode_step", wraps=ofa.decode_step) as steps, \
                _recording_k1_k2(k1_calls, k2_calls):
            t0 = time.perf_counter()
            out = task.evaluate(params, cfg, FileDataset(path), batch_size=2)
            secs = time.perf_counter() - t0
        got = _counters()
        want = dict.fromkeys(got, 0)
        want["K1" if flash else "XLA"] = (cfg.encoder_layers * enc.call_count
                                          + 2 * cfg.decoder_layers * dec.call_count)
        want["K2"] = want["K2-sm90"] = steps.call_count
        tag = f"[detection eval {'K1' if flash else 'XLA'} branch]"
        log(f"{tag} launches {{K1: {got['K1']}, XLA: {got['XLA']}, K2: {got['K2']}}} over "
            f"{enc.call_count} encodes, {dec.call_count} decodes and {steps.call_count} beam "
            f"steps; {json.dumps(out)}; {secs:.2f} s on {smi}")
        if got != want or out["n"] != 4 or (enc.call_count, dec.call_count) != (4, 2) \
                or not math.isfinite(out["loss"]):
            raise AssertionError(f"detection eval: launches {got}, expected {want}; {out}")
        _check_eval_calls(tag[1:-1], k1_calls, k2_calls, seen)
        launches[tag[1:-1]] = got
        del params, k1_calls, k2_calls
    return launches


def _option_batch(cfg):
    """A caption batch at batch 2 (the JAX step's layout, accumulation axis 1)."""
    from musketeer_tpu_torch.training import TaskBatch

    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    src, images, masks = _inputs(2, SEED + 23)
    tgt = torch.randint(4, 30000, (2, 20), generator=g, device="cuda")
    tgt[:, -1] = cfg.eos
    prev = torch.roll(tgt, 1, 1)
    prev[:, 0] = cfg.bos
    return TaskBatch(src_tokens=src[None], prev_output_tokens=prev[None], target=tgt[None],
                     patch_images=images[None], patch_masks=masks[None])


def _xla_options(smi: str) -> dict:
    """(c) One update at ofa_base (bf16, flash config) with each option of
    ``OPTION_CASES``: the loss in (0, 2 ln V], finite gradients, K3/K4 and
    XLA counters as the JAX gates predict, each K3 and K4 shape held to its
    plain version and the fp32 function; then the fp32 caption search with a
    decoder prompt through the kernels and their plain versions."""
    from musketeer_tpu_torch.config import CriterionConfig, GenerationConfig, OptimConfig, ofa_base
    from musketeer_tpu_torch.criterions import label_smoothed_ce
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.ops import topk_projection as k2
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.training import TaskBatch, init_train_state, make_train_step
    from musketeer_tpu_torch.training.train_state import global_norm, named_leaves

    t0 = time.perf_counter()
    full = _random_model_tree(dataclasses.replace(ofa_base(), **OPTION_TREE), SEED + 20)
    log(f"[xla options] ofa_base tree with adapters and prompts built in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    for case, (options, enc_xla, dec_xla) in OPTION_CASES.items():
        cfg = dataclasses.replace(ofa_base(), use_flash_attention=True, **options)
        params = trainable(from_jax(_strip_options(full, cfg), cfg, "cuda", torch.float32))
        batch = _option_batch(cfg)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        k3_calls, k4_calls = {}, {}
        recording = mock.patch.object(kb, "FlashAttentionTrainable",
                                      _recording_attention(k3_calls, k4_calls))
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        t0 = time.perf_counter()
        state = None
        recording.start()
        if case == "train_bn":  # the encoder's batch-statistics BN: a forward and backward
            b = TaskBatch(*[None if x is None else x[0] for x in batch])
            logits = ofa.forward(params, cfg, b.src_tokens, b.prev_output_tokens, b.patch_images,
                                 b.patch_masks, generator=gen, deterministic=False, train_bn=True)
            out = label_smoothed_ce(logits, b.target, epsilon=0.1, pad_id=cfg.pad,
                                    vocab_size=cfg.vocab_size)
            loss = out.loss / out.ntokens
            loss.backward()
            grads = [p.grad for _, p in named_leaves(params) if p.grad is not None]
            loss, gnorm = loss.item(), float(global_norm(grads))
            skipped = 0.0
        else:
            state = init_train_state(params, OptimConfig(warmup_updates=1))
            step = make_train_step(cfg, CriterionConfig(), OptimConfig(warmup_updates=1))
            state, m = step(state, {"caption": batch}, gen)
            loss, gnorm, skipped = float(m["loss"]), float(m["gnorm"]), float(m["skipped_nonfinite"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        recording.stop()
        got = _counters()
        want = dict.fromkeys(got, 0)
        flash = cfg.encoder_layers * (not enc_xla) + 2 * cfg.decoder_layers * (not dec_xla)
        want.update(K3=flash, K4=flash, XLA=cfg.encoder_layers * enc_xla
                    + 2 * cfg.decoder_layers * dec_xla)
        log(f"[xla options {case}] launches {{K3: {got['K3']}, K4: {got['K4']}, XLA: "
            f"{got['XLA']}}}; loss {loss:.4f}, gradient norm {gnorm:.4f}; {secs:.2f} s, peak "
            f"{_peak_gb():.2f} GB on {smi}")
        top = 2 * math.log(cfg.vocab_size)
        if got != want or not (0.0 < loss <= top and math.isfinite(gnorm)) or skipped:
            raise AssertionError(f"{case}: launches {got}, expected {want}; loss {loss} (range "
                                 f"(0, {top:.2f}]), gradient norm {gnorm}")
        _check_train_calls(f"option {case}", k3_calls, k4_calls)
        launches[f"option {case}"] = got
        del params, state, k3_calls, k4_calls
    # the fp32 caption search with a decoder prompt, K7 asked for and refused
    cfg = dataclasses.replace(ofa_base(), dtype="float32", use_flash_attention=True,
                              decoder_prompt=True, decode_stack_kernel=True)
    params = from_jax(_strip_options(full, cfg), cfg, "cuda", torch.float32)
    gen_cfg = GenerationConfig(beam_size=BEAM, max_len_b=MAX_LEN, min_len=1, no_repeat_ngram_size=3)
    src, images, _ = _inputs(2, SEED + 1)
    masks = torch.tensor([True, False], device="cuda")
    search_module = importlib.import_module("musketeer_tpu_torch.generation.beam_search")
    attn_module = importlib.import_module("musketeer_tpu_torch.ops.flash_attention_bwd")
    _reset_counters()
    with mock.patch.object(ofa, "decode_step", wraps=ofa.decode_step) as steps:
        _, tok_k, sc_k = _caption(params, cfg, gen_cfg, src, images, masks)
    got = _counters()
    want = dict.fromkeys(got, 0)
    want.update(K1=cfg.encoder_layers, K2=steps.call_count)
    with mock.patch.object(attn_module, "flash_attention_inference", k1.flash_attention_plain), \
            mock.patch.object(search_module, "project_with_stats", k2.project_plain):
        _, tok_p, sc_p = _caption(params, cfg, gen_cfg, src, images, masks)
    _check_tokens(tok_k, sc_k, cfg, 2)
    gap, lim = _max_err(sc_k, sc_p), FP32_TOL * max(1.0, float(sc_p.abs().max()))
    log(f"[xla options decoder prompt search] fp32 batch 2: launches {{K1: {got['K1']}, K2: "
        f"{got['K2']}, K7: {got['K7']}}} over {steps.call_count} steps; kernel tokens "
        f"{tok_k[:, 0].tolist()}; max score diff against the plain versions {gap:.3e} (tol {lim:.3e})")
    if got != want or _counters() != got or not torch.equal(tok_k, tok_p) or not gap <= lim:
        raise AssertionError(f"decoder prompt search: launches {got}, expected {want}, or the "
                             f"plain versions' tokens or scores differ (gap {gap:.3e})")
    if torch.equal(tok_k[0, 0], tok_k[1, 0]):
        raise AssertionError("decoder prompt search: both rows' best hypotheses are equal")
    launches["decoder prompt search"] = got
    return launches


def phase_xla(tree, smi: str, tmp: str) -> dict:
    """Phase 20: the XLA attention branch and the detection and pretraining
    tasks at ``ofa_base`` on the card, through the port's entry points
    (``tree``: the seeded ofa_base tree). → each part's counters."""
    launches = {}
    for part, fn in (("eval", lambda: _xla_eval(tree, tmp, smi)),
                     ("detection", lambda: _detection_eval(tree, tmp, smi)),
                     ("joint", lambda: _joint_recipe(tree, tmp, smi)),
                     ("options", lambda: _xla_options(smi))):
        t0 = time.perf_counter()
        launches.update(fn())
        log(f"[xla {part}] part done in {time.perf_counter() - t0:.1f} s on {smi}")
    return launches


# ---------------------------------------------------------------------------
# phase 21: SCST, CLIP-SCST and image generation
# ---------------------------------------------------------------------------

SCST_ROWS, SCST_UPDATES, SCST_BEAMS, SCST_MAX_LEN = 6, 3, 5, 16  # 3 updates at batch 2: one epoch
CLIP_SCST_UPDATES = 2
GEN_ROWS, GEN_BATCH = 4, 2  # ImageGenTask.evaluate: 2 batches of 2
VQGAN_IMAGES, VQGAN_SIZE = 4, 256
JOINT_GEN_CODES, JOINT_GEN_UPDATES = 1024, 2  # bench.py's image_gen target: 1024 codes + eos
GEN_EXACT_CODE_IMAGE = 128  # the fp32 gen_code check: an 8 x 8 code grid


def _gen_rows(n: int, codes: int, rng) -> list:
    """Seeded image_gen TSV rows: id, a caption, ``codes`` VQGAN code ids."""
    return [[str(i), _SENTENCES[rng.randint(len(_SENTENCES))],
             " ".join(str(c) for c in rng.randint(0, 8192, codes))] for i in range(n)]


def _write_tsv(path: str, rows: list) -> str:
    with open(path, "w") as f:
        f.writelines("\t".join(r) + "\n" for r in rows)
    return path


def _recording_scst_fns(scst_module, losses: list):
    """``make_scst_fns`` whose policy-gradient step records each update's loss."""
    make = scst_module.make_scst_fns

    def patched(*a, **kw):
        sample_fn, grad_fn = make(*a, **kw)

        def recorded(*args):
            state, m = grad_fn(*args)
            losses.append(float(m["scst_loss"]))
            return state, m
        return sample_fn, recorded
    return patched


def _scst_part(tag: str, smi: str, seen: set, run, want_fn) -> dict:
    """Run ``run()`` with every counter at 0 and the model's encode, decode and
    forward counted, K1's and K3/K4's first call at each shape recorded: the
    counters must equal ``want_fn(counts)``; then each new K1, K3 and K4 shape
    is held to its plain version and the fp32 function. A K4 call whose
    output gradient is below 1e-3 (the seeded model's advantages are ~0, so
    the policy gradient nearly vanishes) is also held so with a seeded
    unit-scale one. → the counters, the run's output, the call counts and
    seconds."""
    import gc

    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb

    k1_calls, k2_calls, k3_calls, k4_calls = {}, {}, {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with mock.patch.object(ofa, "encode", wraps=ofa.encode) as enc, \
            mock.patch.object(ofa, "decode", wraps=ofa.decode) as dec, \
            mock.patch.object(ofa, "forward", wraps=ofa.forward) as fwd, \
            mock.patch.object(kb, "FlashAttentionTrainable", _recording_attention(k3_calls, k4_calls)), \
            _recording_k1_k2(k1_calls, k2_calls):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    got = _counters()
    counts = dict(encode=enc.call_count, decode=dec.call_count, forward=fwd.call_count)
    want = dict.fromkeys(got, 0)
    want.update(want_fn(counts))
    log(f"[scst {tag}] launches {{K1: {got['K1']}, K3: {got['K3']}, K4: {got['K4']}}} over "
        f"{counts}; {secs:.2f} s, peak {_peak_gb():.2f} GB on {smi}")
    if got != want:
        raise AssertionError(f"scst {tag}: launches {got}, expected {want} ({counts})")
    new_k1 = {k: v for k, v in k1_calls.items() if ("K1", k) not in seen}
    _check_eval_calls(f"scst {tag}", k1_calls, k2_calls, seen)
    new_k34 = [k for k in k3_calls if ("K3", k) not in seen]
    for k in new_k34:
        seen.add(("K3", k))
        _check_k3(f"scst {tag} {k}", *k3_calls[k])
    for k in [k for k in k4_calls if ("K4", k) not in seen]:
        seen.add(("K4", k))
        args, kw = k4_calls[k]
        _check_k4(f"scst {tag} {k}", args, kw)
        do = args[9]
        if float(do.float().abs().max()) < 1e-3:
            g = torch.Generator(device=do.device).manual_seed(SEED + 35)
            unit = torch.randn(do.shape, generator=g, device=do.device).to(do.dtype)
            _check_k4(f"scst {tag} {k}, seeded unit do (the update's max |do| "
                      f"{float(do.float().abs().max()):.1e})", [*args[:9], unit, *args[10:]], kw)
    log(f"[scst {tag}] {len(new_k1)} new K1 and {len(new_k34)} new K3/K4 shapes held to their "
        f"plain versions and the fp32 function: {sorted(new_k1) + new_k34}")
    return dict(out=out, launches=got, counts=counts, secs=secs)


def phase_scst(tree, smi: str, tmp: str) -> dict:
    """Phase 21: SCST, CLIP-SCST and image generation at ``ofa_base`` through the
    port's entry points, with seeded full-width CLIP ViT-B/16 and VQGAN
    (written as upstream ``.pt`` files): (a) ``cli train --criterion scst``,
    (b) ``cli train --criterion clip_scst``, (c) ``cli vqgan-encode`` and
    ``decode_code`` of its codes, (d) ``ImageGenTask.evaluate``, (e) ``cli
    train`` on caption + image_gen, (f) the fp32 ``gen_code`` search through
    the kernels and their plain versions. → each part's counters."""
    import glob
    import os

    import numpy as np

    from musketeer_tpu_torch import cli
    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.criterions import scst as scst_module
    from musketeer_tpu_torch.data import FileDataset
    from musketeer_tpu_torch.models import clip, ofa, vqgan
    from musketeer_tpu_torch.params import from_jax
    from musketeer_tpu_torch.tasks import image_gen as image_gen_module
    from musketeer_tpu_torch.tokenization import default_vocab
    from musketeer_tpu_torch.training import checkpoint as ckpt_module
    from musketeer_tpu_torch.training import trainer as trainer_module
    from musketeer_tpu_torch.utils.cider import CiderD

    cfg = dataclasses.replace(ofa_base(), use_flash_attention=True)
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    vocab = default_vocab()
    rng = np.random.RandomState(SEED + 31)
    seeded = mock.patch.object(cli, "_seeded_params",
                               lambda cfg, seed, device, dtype: from_jax(tree, cfg, device, dtype))
    common = ["--arch", "ofa_base", "--device", "cuda", "--batch-size", "2", "--warmup-updates", "1"]
    launches, seen = {}, set()

    # (a) SCST with the CIDEr-D reward on seeded 480² caption rows
    cap = _write_tsv(os.path.join(tmp, "scst_caption.tsv"), _eval_rows("caption", SCST_ROWS, IMAGE, rng))
    losses, cider, compute = [], [], scst_module.compute_rewards

    def recording_rewards(hyps, refs, scorer=None):
        gts = {f"{b}_{k}": refs[b] for b in range(len(hyps)) for k in range(len(hyps[b]))}
        res = {f"{b}_{k}": h for b, hs in enumerate(hyps) for k, h in enumerate(hs)}
        cider.append(float(CiderD().compute_score(gts, res)[0]))
        return compute(hyps, refs, scorer)

    saves, save = [], ckpt_module.save_checkpoint
    save_dir = os.path.join(tmp, "scst_run")

    def run_scst():
        with seeded, mock.patch.object(scst_module, "compute_rewards", recording_rewards), \
                mock.patch.object(scst_module, "make_scst_fns", _recording_scst_fns(scst_module, losses)), \
                mock.patch.object(ckpt_module, "save_checkpoint", _timed(save, saves)):
            return cli.main(["train", "--criterion", "scst", "--tasks", f"caption={cap}", *common,
                             "--patch-image-size", str(IMAGE), "--scst-sample-beams", str(SCST_BEAMS),
                             "--scst-max-len-b", str(SCST_MAX_LEN), "--max-update", str(SCST_UPDATES),
                             "--save-dir", save_dir])

    r = _scst_part("a: cli train --criterion scst", smi, seen, run_scst, lambda c: dict(
        K1=Le * SCST_UPDATES, K3=Le * SCST_UPDATES + 2 * Ld * c["decode"],
        K4=Le * SCST_UPDATES + 2 * Ld * c["decode"]))
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(save_dir, "checkpoint*"))
                   if not p.endswith(".json"))
    if (r["out"].step != SCST_UPDATES or r["counts"]["encode"] != 2 * SCST_UPDATES
            or r["counts"]["decode"] != SCST_UPDATES or len(losses) != SCST_UPDATES
            or not all(math.isfinite(x) for x in losses)
            or names != ["checkpoint1", "checkpoint_best", "checkpoint_last"]):
        raise AssertionError(f"scst: step {r['out'].step}, {r['counts']}, losses {losses}, "
                             f"checkpoints {names}")
    log(f"[scst a] ofa_base bf16, batch 2 x {SCST_BEAMS} sampled captions of up to "
        f"{SCST_MAX_LEN} tokens: losses {losses}, raw mean CIDEr-D by update {cider} (the loop's "
        f"mean_reward is the mean advantage, 0 by construction); {SCST_UPDATES / r['secs']:.3f} "
        f"updates/s with {len(saves)} saves ({', '.join(f'{s:.2f}' for s in saves)} s: {names})")
    launches["scst"] = r["launches"]
    del r

    # (b) CLIP-SCST: seeded full-width CLIP ViT-B/16 and VQGAN, upstream layouts
    t0 = time.perf_counter()
    clip_pt, vq_pt = os.path.join(tmp, "clip_vit_b16.pt"), os.path.join(tmp, "vqgan.ckpt")
    torch.save(clip.init_clip_state_dict(clip.ClipConfig(), torch.Generator().manual_seed(SEED + 32)),
               clip_pt)
    torch.save({"state_dict": vqgan.init_vqgan_state_dict(
        vqgan.VQGANConfig(), torch.Generator().manual_seed(SEED + 33))}, vq_pt)
    log(f"[scst b] seeded CLIP ViT-B/16 ({os.path.getsize(clip_pt) / 1e6:.0f} MB) and VQGAN "
        f"({os.path.getsize(vq_pt) / 1e6:.0f} MB) written in {time.perf_counter() - t0:.1f} s")
    gen = _write_tsv(os.path.join(tmp, "clip_scst.tsv"), _gen_rows(4, 64, rng))
    losses, sims, similarity = [], [], image_gen_module.clip_similarity

    def recording_similarity(*a, **kw):
        s = similarity(*a, **kw)
        sims.append(float(s.mean()))
        return s

    def run_clip_scst():
        with seeded, mock.patch.object(image_gen_module, "clip_similarity", recording_similarity), \
                mock.patch.object(scst_module, "make_scst_fns", _recording_scst_fns(scst_module, losses)):
            return cli.main(["train", "--criterion", "clip_scst", "--tasks", f"image_gen={gen}",
                             *common, "--scst-sample-beams", str(SCST_BEAMS),
                             "--max-update", str(CLIP_SCST_UPDATES), "--clip-pt", clip_pt,
                             "--vqgan-pt", vq_pt])

    r = _scst_part("b: cli train --criterion clip_scst", smi, seen, run_clip_scst, lambda c: dict(
        K1=Le * CLIP_SCST_UPDATES, K3=Le * CLIP_SCST_UPDATES + 2 * Ld * c["decode"],
        K4=Le * CLIP_SCST_UPDATES + 2 * Ld * c["decode"]))
    if (r["out"].step != CLIP_SCST_UPDATES or r["counts"]["encode"] != 2 * CLIP_SCST_UPDATES
            or r["counts"]["decode"] != CLIP_SCST_UPDATES or len(losses) != CLIP_SCST_UPDATES
            or not all(math.isfinite(x) for x in losses + sims)):
        raise AssertionError(f"clip_scst: step {r['out'].step}, {r['counts']}, losses {losses}, "
                             f"similarities {sims}")
    log(f"[scst b] batch 2 x {SCST_BEAMS} sampled 8 x 8 code grids (the preset's code_image_size "
        f"128 // 16), VQGAN-decoded to 128², CLIP ViT-B/16 at 224²: losses {losses}, raw mean CLIP "
        f"similarity by update {sims}; {CLIP_SCST_UPDATES / r['secs']:.3f} updates/s")
    launches["clip_scst"] = r["launches"]
    del r

    # (c) cli vqgan-encode over 256² PNGs, then decode_code of its codes
    imgs = _write_tsv(os.path.join(tmp, "vq_images.tsv"),
                      _eval_rows("caption", VQGAN_IMAGES, VQGAN_SIZE, rng))
    codes_path = os.path.join(tmp, "vq_codes.tsv")
    vq_params, vq_cfg = vqgan.convert_vqgan_state_dict(ckpt_module.load_state_dict(vq_pt),
                                                       device="cuda")

    def run_encode():
        n = cli.main(["vqgan-encode", "--vqgan", vq_pt, "--data", imgs, "--out", codes_path,
                      "--image-size", str(VQGAN_SIZE), "--batch-size", "2", "--device", "cuda"])
        with open(codes_path) as f:
            codes = [[int(c) for c in line.rstrip("\n").split("\t")[2].split()] for line in f]
        codes = torch.tensor(codes, device="cuda").view(n, 16, 16)
        with torch.inference_mode():
            return codes, vqgan.decode_code(vq_params, vq_cfg, codes)

    r = _scst_part("c: cli vqgan-encode + decode_code", smi, seen, run_encode, lambda c: {})
    codes, decoded = r["out"]
    if (tuple(decoded.shape) != (VQGAN_IMAGES, VQGAN_SIZE, VQGAN_SIZE, 3)
            or not bool(torch.isfinite(decoded).all())
            or bool(((codes < 0) | (codes >= vq_cfg.codebook_size)).any())):
        raise AssertionError(f"vqgan-encode: codes {tuple(codes.shape)}, images {tuple(decoded.shape)}")
    log(f"[scst c] {VQGAN_IMAGES} images of {VQGAN_SIZE}² → 16 x 16 codes ({len(codes.unique())} "
        f"distinct) → decoded {tuple(decoded.shape)} in [{float(decoded.min()):.3f}, "
        f"{float(decoded.max()):.3f}]")
    launches["vqgan-encode"] = r["launches"]
    del r, codes, decoded

    # (d) ImageGenTask.evaluate with CLIP and VQGAN: beam 5, 256 codes
    params = from_jax(tree, cfg, "cuda", torch.bfloat16)
    clip_params, clip_cfg = clip.convert_clip_state_dict(ckpt_module.load_state_dict(clip_pt),
                                                         device="cuda")
    task = image_gen_module.ImageGenTask(vocab, clip_params=clip_params, clip_cfg=clip_cfg,
                                         vqgan_params=vq_params, vqgan_cfg=vq_cfg)
    gen_eval = _write_tsv(os.path.join(tmp, "image_gen_eval.tsv"), _gen_rows(GEN_ROWS, 256, rng))
    dumps = os.path.join(tmp, "image_gen_dumps")
    r = _scst_part("d: ImageGenTask.evaluate", smi, seen, lambda: task.evaluate(
        params, cfg, FileDataset(gen_eval), batch_size=GEN_BATCH, dump_dir=dumps),
        lambda c: dict(K1=Le * c["encode"]))
    out = r["out"]
    if (r["counts"]["encode"] != GEN_ROWS // GEN_BATCH or out["n"] != GEN_ROWS
            or not math.isfinite(out["ti_sim"]) or len(os.listdir(dumps)) != GEN_ROWS):
        raise AssertionError(f"image_gen evaluate: {out}, {r['counts']}")
    log(f"[scst d] {json.dumps(out)}: {GEN_ROWS} rows at batch {GEN_BATCH}, beam 5, 256 codes "
        f"each (the task's code_image_size 256 // 16), {GEN_ROWS / r['secs']:.3f} rows/s")
    launches["image_gen eval"] = r["launches"]
    del r, params, task, clip_params

    # (e) the joint loader on caption + image_gen (1024 codes + eos, bench.py's target)
    joint = _write_tsv(os.path.join(tmp, "joint_image_gen.tsv"), _gen_rows(4, JOINT_GEN_CODES, rng))
    losses = []

    def run_joint():
        with seeded, mock.patch.object(trainer_module, "make_train_step",
                                       _recording_steps(trainer_module, losses)):
            # the targets at bench.py's 1025 tokens: the loader's default bucket
            # (a multiple of 8, 1032) passes the decoder's 1026 image positions,
            # in the JAX package too
            return cli.main(["train", "--tasks", f"caption={cap},image_gen={joint}", *common,
                             "--patch-image-size", str(IMAGE), "--tgt-bucket",
                             str(JOINT_GEN_CODES + 1), "--max-update", str(JOINT_GEN_UPDATES)])

    r = _scst_part("e: cli train caption + image_gen", smi, seen, run_joint, lambda c: dict(
        K3=(Le + 2 * Ld) * c["forward"], K4=(Le + 2 * Ld) * c["forward"]))
    if r["out"].step != JOINT_GEN_UPDATES or r["counts"]["forward"] != 2 * JOINT_GEN_UPDATES:
        raise AssertionError(f"joint image_gen: step {r['out'].step}, {r['counts']}")
    _check_task_losses("joint image_gen", losses, ("caption", "image_gen"), JOINT_GEN_UPDATES,
                       cfg.vocab_size)
    log(f"[scst e] losses by update {[{k: round(v, 4) for k, v in m.items()} for m in losses]}; "
        f"{JOINT_GEN_UPDATES / r['secs']:.3f} updates/s")
    launches["joint image_gen"] = r["launches"]
    del r

    # (f) the fp32 gen_code search through the kernels and their plain versions
    from musketeer_tpu_torch.ops import flash_attention_infer as k1

    attn_module = importlib.import_module("musketeer_tpu_torch.ops.flash_attention_bwd")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = from_jax(tree, cfg32, "cuda", torch.float32)
    task = image_gen_module.ImageGenTask(vocab, description="base",
                                         code_image_size=GEN_EXACT_CODE_IMAGE)
    from musketeer_tpu_torch.data import collate

    b = task.builder("valid")
    rows = _gen_rows(2, 64, np.random.RandomState(SEED + 34))
    src = torch.from_numpy(collate([b(row) for row in rows], pad_id=vocab.pad)["src_tokens"])
    src = src.to("cuda").long()
    r = _scst_part("f: fp32 gen_code, kernels", smi, seen,
                   lambda: task.generate_codes(params, cfg32, src), lambda c: dict(K1=Le))
    codes_k, scores_k = r["out"]
    with mock.patch.object(attn_module, "flash_attention_inference", k1.flash_attention_plain):
        codes_p, scores_p = task.generate_codes(params, cfg32, src)
    gap, lim = _max_err(scores_k, scores_p), FP32_TOL * max(1.0, float(scores_p.abs().max()))
    log(f"[scst f] fp32 batch 2, beam 5, 64 codes: kernel codes equal to plain's: "
        f"{torch.equal(codes_k, codes_p)}, max score diff {gap:.3e} (tol {lim:.3e}); distinct "
        f"codes in each row's best {[len(c.unique()) for c in codes_k[:, 0]]}, rows differ: "
        f"{not torch.equal(codes_k[0, 0], codes_k[1, 0])}")
    if not torch.equal(codes_k, codes_p) or not gap <= lim:
        raise AssertionError("fp32 gen_code: the kernels' codes or scores differ from the plain "
                             f"versions' (score gap {gap:.3e}, tol {lim:.3e})")
    launches["gen_code fp32"] = r["launches"]
    return launches


# ---------------------------------------------------------------------------
# phase 22: the native TSV reader, --remat at ofa_large, the process-group
# path, MFU
# ---------------------------------------------------------------------------

NATIVE_ROWS, NATIVE_BATCH = 20, 2  # per TSV: 10 updates at batch 2 (the CLI logs update 10)
PG_UPDATES, PG_IMAGE = 10, 256
REMAT_UPDATES = 3
REMAT_BATCHES = (2, 1)  # phase 8's batch, then the fallback if it does not fit without remat
REMAT_RATES = dict(dropout=0.1, activation_dropout=0.1, encoder_drop_path_rate=0.1,
                   decoder_drop_path_rate=0.1)
# dense bf16 FLOP/s from NVIDIA's data sheets, by the name nvidia-smi reports
# (the first key the name contains)
PEAK_BF16 = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H100", 989e12))


def _peak_bf16(smi: str) -> float:
    name = smi.split(",")[0]
    for key, peak in PEAK_BF16:
        if key in name:
            return peak
    raise AssertionError(f"no bf16 peak for {name!r} in PEAK_BF16")


def _batch_shapes(batches: dict) -> dict:
    """{task: (rows of all micro-batches, src len, tgt len, image size or None)}."""
    out = {}
    for name, b in batches.items():
        A, B, ts = b.src_tokens.shape
        img = None if b.patch_images is None else int(b.patch_images.shape[2])
        out[name] = (A * B, int(ts), int(b.prev_output_tokens.shape[-1]), img)
    return out


def _step_flops(cfg, shapes: dict, rdrop: bool) -> float:
    """utils/flops.py's FLOPs of one training step over task batches of
    ``shapes``: forward and backward, no remat recompute (the one convention)."""
    from musketeer_tpu_torch.utils import flops

    return flops.TRAIN_FWD_BWD_MULT * sum(
        flops.seq2seq_fwd_flops(cfg, rows, ts, tt, img_size=img, rdrop=rdrop)
        for rows, ts, tt, img in shapes.values())


def _parallel_native(tmp: str, smi: str) -> dict:
    """(a) the joint loader over the native reader: every fetch one C call,
    and the rows equal the Python reader's. → the TSV paths."""
    import os

    import numpy as np

    from musketeer_tpu_torch import native
    from musketeer_tpu_torch.tasks import MusketeerDataLoader, SubTaskSpec
    from musketeer_tpu_torch.tokenization import default_vocab

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native TSV reader did not build (g++)")
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 22)
    paths = {n: _write_tsv(os.path.join(tmp, f"native_{n}.tsv"),
                           _eval_rows(n, NATIVE_ROWS, PG_IMAGE, rng)) for n in ("caption", "snli_ve")}
    specs = [SubTaskSpec(n, p, batch_size=NATIVE_BATCH, task_kwargs={"patch_image_size": PG_IMAGE})
             for n, p in paths.items()]
    loader = MusketeerDataLoader(default_vocab(), specs)
    loader.set_epoch(1)
    native.NativeTsv.batch_calls = 0
    t0 = time.perf_counter()
    steps = sum(1 for _ in loader.epoch_iterator())
    epoch_s = time.perf_counter() - t0
    calls = native.NativeTsv.batch_calls
    if steps == 0 or calls != steps * len(specs):
        raise AssertionError(f"native reader: {calls} batched reads for {steps} steps of "
                             f"{len(specs)} tasks")
    reads = []
    for name, ds in loader.datasets.items():
        idx = list(range(ds.row_count))[::-1]
        t0 = time.perf_counter()
        fast = ds.get_batch(idx)
        t1 = time.perf_counter()
        slow = [ds[i] for i in idx]
        t2 = time.perf_counter()
        if fast != slow:
            raise AssertionError(f"native reader: {name}'s rows differ from the Python reader's")
        reads.append(f"{name} {len(idx)} rows native {(t1 - t0) * 1e3:.2f} ms, Python "
                     f"{(t2 - t1) * 1e3:.2f} ms")
    loader.close()
    log(f"[parallel a] native reader (g++ build or load {build_s:.2f} s): {calls} batched reads "
        f"over {steps} loader steps of {len(specs)} tasks ({epoch_s:.2f} s with the builders); "
        f"rows equal to the Python reader's: {'; '.join(reads)}")
    return paths


def _parallel_remat(smi: str, seen: set) -> dict:
    """(b) the ofa_large joint step in bf16 (phase 8's tasks, dropout and
    drop-path 0.1), 3 updates with and without --remat from one state and
    one generator seed: the losses and gradient norms of every update and the
    parameters after the last bit-equal (the recompute replays the dropout
    masks and runs the same kernels on the same inputs), K3 2x and K4 1x the
    launches without remat, a lower peak; each run's new K3/K4 shapes (the
    recompute's K3 among them) held to their plain versions and the fp32
    function. → {remat: record}."""
    from musketeer_tpu_torch.config import ofa_large
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.training import init_train_state, make_train_step
    from musketeer_tpu_torch.training.train_state import named_leaves
    from musketeer_tpu_torch.training.trainer import step_generator

    cfg0 = dataclasses.replace(ofa_large(), dtype="bfloat16", use_flash_attention=True,
                               **REMAT_RATES)
    t0 = time.perf_counter()
    tree = _random_model_tree(cfg0, SEED + 22)
    log(f"[parallel b] ofa_large tree ({cfg0.encoder_layers} + {cfg0.decoder_layers} layers, "
        f"d {cfg0.embed_dim}) drawn on the host in {time.perf_counter() - t0:.1f} s")
    crit, optim = _train_configs()
    per_forward = cfg0.encoder_layers + 2 * cfg0.decoder_layers
    for batch in REMAT_BATCHES:
        batches = _train_batches(cfg0, TRAIN_TASKS, batch, SEED)
        forwards = _expected_forwards(batches)
        runs, calls = {}, {}
        try:
            for remat in (False, True):
                cfg = dataclasses.replace(cfg0, remat=remat)
                state = init_train_state(trainable(from_jax(tree, cfg, "cuda", torch.float32)),
                                         optim)._replace(step=TRAIN_STEP0)
                step = make_train_step(cfg, crit, optim)
                calls[remat] = ({}, {})
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _reset_counters()
                losses, gnorms, times = [], [], []
                with mock.patch.object(kb, "FlashAttentionTrainable",
                                       _recording_attention(*calls[remat])):
                    for _ in range(REMAT_UPDATES):
                        t1 = time.perf_counter()
                        state, m = step(state, batches,
                                        step_generator(SEED, state.step, "cuda"))
                        losses.append(float(m["loss"]))
                        gnorms.append(float(m["gnorm"]))
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t1)
                runs[remat] = dict(losses=losses, gnorms=gnorms, times=times,
                                   launches=_counters(), peak=torch.cuda.max_memory_allocated(),
                                   params=[t.detach().cpu() for _, t in named_leaves(state.params)])
                del state, step, m
                torch.cuda.empty_cache()
        except torch.cuda.OutOfMemoryError:
            log(f"[parallel b] batch {batch} does not fit (remat {len(runs) > 0}); trying smaller")
            runs = calls = None
            torch.cuda.empty_cache()
            continue
        break
    if runs is None:
        raise AssertionError("ofa_large does not fit at batch 1 without remat")
    base, rem = runs[False], runs[True]
    want = dict.fromkeys(base["launches"], 0)
    want.update(K3=per_forward * forwards * REMAT_UPDATES, K4=per_forward * forwards * REMAT_UPDATES)
    want_remat = dict(want, K3=2 * want["K3"])
    equal = sum(torch.equal(a, b) for a, b in zip(rem["params"], base["params"]))
    flops = _step_flops(cfg0, _batch_shapes(batches), rdrop=crit.use_rdrop)
    snap = sum(t.numel() * t.element_size() for c in calls[True] for a, _ in c.values()
               for t in a if torch.is_tensor(t))
    for tag, r in (("without remat", base), ("--remat", rem)):
        p50 = statistics.median(r["times"][1:])
        log(f"[parallel b] ofa_large bf16 {len(TRAIN_TASKS)} tasks x batch {batch} {tag}: "
            f"losses {r['losses']}, gnorms {r['gnorms']}, peak {r['peak'] / 2**30:.2f} GiB, steps "
            f"{[round(t * 1e3, 1) for t in r['times']]} ms (p50 after the first {p50 * 1e3:.1f} ms, "
            f"MFU {flops / p50 / _peak_bf16(smi):.4f}), launches K3 {r['launches']['K3']} "
            f"K4 {r['launches']['K4']} on {smi}")
    log(f"[parallel b] remat against none: losses and gnorms bit-equal "
        f"{rem['losses'] == base['losses'] and rem['gnorms'] == base['gnorms']}; {equal} of "
        f"{len(base['params'])} parameter leaves bit-equal after update {REMAT_UPDATES}; peak "
        f"{rem['peak'] / base['peak']:.3f} of it (each peak includes the recorded K3/K4 "
        f"arguments, {snap / 2**20:.1f} MiB under --remat); time "
        f"{statistics.median(rem['times'][1:]) / statistics.median(base['times'][1:]):.3f} of it")
    if base["launches"] != want or rem["launches"] != want_remat:
        raise AssertionError(f"remat launches {rem['launches']} / {base['launches']}, expected "
                             f"{want_remat} / {want}")
    if (rem["losses"] != base["losses"] or rem["gnorms"] != base["gnorms"]
            or equal != len(base["params"])):
        raise AssertionError(f"remat changes the updates: losses {rem['losses']} vs "
                             f"{base['losses']}, gnorms {rem['gnorms']} vs {base['gnorms']}, "
                             f"{equal} of {len(base['params'])} parameter leaves bit-equal")
    if not rem["peak"] < base["peak"]:
        raise AssertionError(f"remat: peak {rem['peak']} not below {base['peak']}")
    t0 = time.perf_counter()
    held = [_check_train_calls(f"parallel b {tag}", *calls[remat], seen)
            for tag, remat in (("without remat", False), ("--remat", True))]
    log(f"[parallel b] {held[0]} K3/K4 shapes without remat and {held[1]} more under --remat "
        f"(its recompute's K3) held to their plain versions and the fp32 function "
        f"({time.perf_counter() - t0:.1f} s)")
    for r in runs.values():
        del r["params"]
    return {"batch": batch, "flops": flops, **{("remat" if k else "plain"): v for k, v in runs.items()}}


def _parallel_process_group(paths: dict, tmp: str, smi: str, seen: set) -> dict:
    """(c) ``cli train`` under ``python -m torch.distributed.run
    --nproc_per_node=1`` (NCCL), and at the same time on the same card in
    this process without a process group: the same loss at update 10, the
    checkpoints compared. The run in this process records its K3/K4 calls,
    whose shapes are the rank's, and holds each new one to its plain version
    and the fp32 function."""
    import os
    import re
    import socket

    from musketeer_tpu_torch import cli
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.training import trainer as trainer_module
    from musketeer_tpu_torch.training.checkpoint import load_checkpoint
    from musketeer_tpu_torch.training.train_state import named_leaves

    root = os.path.dirname(os.path.abspath(__file__))

    def args(save_dir: str) -> list:
        return ["train", "--tasks", ",".join(f"{n}={p}" for n, p in paths.items()),
                "--arch", "ofa_base", "--device", "cuda", "--batch-size", str(NATIVE_BATCH),
                "--patch-image-size", str(PG_IMAGE), "--max-update", str(PG_UPDATES),
                "--save-dir", save_dir]

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dirs = {"plain": os.path.join(tmp, "pg_plain"), "torchrun": os.path.join(tmp, "pg_torchrun")}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes=1", "--nproc_per_node=1",
         "--master_addr=localhost", f"--master_port={port}", "-m", "musketeer_tpu_torch.cli",
         *args(dirs["torchrun"])],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    losses, k3_calls, k4_calls = [], {}, {}
    try:
        with mock.patch.object(trainer_module, "make_train_step",
                               _recording_steps(trainer_module, losses)), \
                mock.patch.object(kb, "FlashAttentionTrainable",
                                  _recording_attention(k3_calls, k4_calls)):
            cli.main(args(dirs["plain"]))
        out = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli train (torchrun) exited {proc.returncode}:\n{out[-4000:]}")
    got = re.search(rf"updates {PG_UPDATES} loss ([0-9.eE+-]+) gnorm ([0-9.eE+-]+)", out)
    if not got or len(losses) != PG_UPDATES:
        raise AssertionError(f"no update-{PG_UPDATES} log line or {len(losses)} updates: "
                             f"{out[-2000:]}")
    loss = {"plain": losses[-1]["loss"], "torchrun": float(got.group(1))}
    rank_line = next((ln for ln in out.splitlines() if "rank 0 of 1" in ln), "")
    if "nccl" not in rank_line:
        raise AssertionError(f"the torchrun rank did not report NCCL: {rank_line!r}")
    states = {k: load_checkpoint(d, None, device="cpu")[0] for k, d in dirs.items()}
    pairs = list(zip(named_leaves(states["plain"].params), named_leaves(states["torchrun"].params)))
    equal = sum(torch.equal(a.detach(), b.detach()) for (_, a), (_, b) in pairs)
    gap = max(float((a.detach() - b.detach()).abs().max()) for (_, a), (_, b) in pairs)
    log(f"[parallel c] cli train ofa_base bf16 caption + snli_ve batch {NATIVE_BATCH} at "
        f"{PG_IMAGE}², {PG_UPDATES} updates: loss at update {PG_UPDATES} without a process group "
        f"{loss['plain']}, under torchrun (1 rank, {rank_line.split('(')[-1].split(',')[0]}; its "
        f"log line rounds to 4 places) {loss['torchrun']}; checkpoints: {equal} of {len(pairs)} parameter "
        f"leaves bit-equal, largest gap {gap:.3e}; both runs at once on the card in {wall:.1f} s "
        f"on {smi}")
    if abs(loss["plain"] - loss["torchrun"]) > BF16_TOL * abs(loss["plain"]):
        raise AssertionError(f"process-group loss {loss['torchrun']} vs {loss['plain']}")
    t0 = time.perf_counter()
    held = _check_train_calls("parallel c", k3_calls, k4_calls, seen)
    log(f"[parallel c] {held} new K3/K4 shapes of the run held to their plain versions and the "
        f"fp32 function ({time.perf_counter() - t0:.1f} s)")
    return dict(loss=loss, equal_leaves=equal, leaves=len(pairs))


def phase_parallel(smi: str, tmp: str, phase8: dict = None, entry_mfu: dict = None) -> dict:
    """Phase 22: (a) the native reader, (b) --remat at ofa_large, (c) the
    process-group path, (d) MFU of phase 8's and phase 19's training steps
    and of (b)'s, by utils/flops.py over the card's bf16 peak."""
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb

    t0 = time.perf_counter()
    seen = set()  # the K3/K4 shapes held to their plain versions so far
    paths = _parallel_native(tmp, smi)
    remat = _parallel_remat(smi, seen)
    pg = _parallel_process_group(paths, tmp, smi, seen)
    peak = _peak_bf16(smi)
    rows = []
    if phase8:
        crit, _ = _train_configs()
        from musketeer_tpu_torch.config import ofa_base

        cfg = dataclasses.replace(ofa_base(), dtype="bfloat16")
        shapes = {n: (TRAIN_BATCH, ts, tt, IMAGE if image else None)
                  for n, (ts, tt, image, _, _) in TRAIN_TASKS.items()}
        f = _step_flops(cfg, shapes, rdrop=crit.use_rdrop)
        rows.append(("phase 8 ofa_base 8 tasks x 2, R-Drop", f, phase8["p50_ms"] / 1e3))
    if entry_mfu:
        rows.append(("phase 19 cli train ofa_base NormFormer 3 tasks x 2",
                     sum(entry_mfu["flops"]) / len(entry_mfu["flops"]),
                     sum(entry_mfu["secs"]) / len(entry_mfu["secs"])))
    for key in ("plain", "remat"):
        rows.append((f"phase 22b ofa_large 8 tasks x {remat['batch']} {key}", remat["flops"],
                     statistics.median(remat[key]["times"][1:])))
    mfu = {}
    # (e) the port's joint-training demo on the card: three tasks, evaluated
    # before and after, each metric asserted to improve
    from musketeer_tpu_torch.examples import joint_training_demo

    k1_calls, k2_calls, k3_calls, k4_calls = {}, {}, {}, {}
    _reset_counters()
    t1 = time.perf_counter()
    with mock.patch.object(kb, "FlashAttentionTrainable", _recording_attention(k3_calls, k4_calls)), \
            _recording_k1_k2(k1_calls, k2_calls):
        demo = joint_training_demo.main(["--device", "cuda"])
    demo_launches = _counters()
    log(f"[parallel e] joint_training_demo: {demo['steps']} steps at {demo['step_ms']} ms, loss "
        f"{demo['loss_first']} -> {demo['loss_last']}, before {demo['before']}, after "
        f"{demo['after']}; launches K1 {demo_launches['K1']} K2 {demo_launches['K2']} K3 "
        f"{demo_launches['K3']} K4 {demo_launches['K4']}; {time.perf_counter() - t1:.1f} s")
    if demo_launches["K3"] == 0 or demo_launches["K3"] != demo_launches["K4"]:
        raise AssertionError(f"the demo's training must run K3 and K4: {demo_launches}")
    held = _check_train_calls("parallel e demo", k3_calls, k4_calls, seen)
    _check_eval_calls("parallel e demo", k1_calls, k2_calls, seen)
    log(f"[parallel e] {held} K3/K4 shapes of the demo's training and {len(k1_calls)} K1 and "
        f"{len(k2_calls)} K2 shapes of its evaluations held to their plain versions and the "
        f"fp32 function")
    for tag, flops, secs in rows:
        mfu[tag] = flops / secs / peak
        log(f"[parallel d] {tag}: {flops / 1e12:.3f} TFLOP a step (utils/flops.py) in "
            f"{secs * 1e3:.1f} ms = MFU {mfu[tag]:.4f} of {peak / 1e12:.0f} TFLOP/s bf16 dense, "
            f"{smi}")
    log(f"[parallel] phase 22 done in {time.perf_counter() - t0:.1f} s")
    return dict(remat={k: remat[k]["launches"] for k in ("plain", "remat")}, mfu=mfu, pg=pg)


# ---------------------------------------------------------------------------
# phase 23 (--multi-card, four cards): the mesh's axes over NCCL ranks
# ---------------------------------------------------------------------------

MULTI_RANKS = 4
MULTI_LAYOUTS = (1, MULTI_RANKS, 2)  # fsdp of the ranks: data 4, fsdp 4, data 2 x fsdp 2


def phase_multi_card(smi: str) -> dict:
    """Phase 23: (a) ``dryrun_multirank`` on 4 NCCL ranks, one per card, in
    each layout: ``ofa_tiny`` (1 + 1 layers, fp32, K3/K4 on the FMA
    kernels) on three tasks with R-Drop and drop-worst, against one process
    on card 0 within 1e-5; (b) phase 22 (b)'s ``ofa_large`` step under
    ``--remat`` (bf16, phase 8's 8 tasks, 2 rows a task per card, 3
    updates) on card 0 alone and on the 4 cards as data 4 and as fsdp 4: the
    state bytes and the peak memory of each rank, the step times, and the
    losses of the two layouts within BF16_TOL of each other. The ranks'
    K3/K4 shapes are those of a run on card 0 in this process (each rank
    holds 2 rows of a task in (a), as ``demo_job(1)`` does, and
    ``TRAIN_BATCH`` rows in (b), as the one-card run does): that run and
    (a)'s one-card reference record their calls, and each shape is held to
    its plain version and the fp32 function; (c) ``_multi_axes``."""
    from musketeer_tpu_torch.config import ofa_large
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.parallel import dryrun

    if torch.cuda.device_count() < MULTI_RANKS:
        raise RuntimeError(f"--multi-card needs {MULTI_RANKS} cards, found "
                           f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    seen, k3_calls, k4_calls = set(), {}, {}
    failed = []  # a part that fails is reported, the next runs, and the phase fails at the end
    with mock.patch.object(kb, "FlashAttentionTrainable", _recording_attention(k3_calls, k4_calls)):
        dryrun.run_job(dryrun.demo_job(1), device="cuda:0")  # one rank's shapes
        for fsdp in MULTI_LAYOUTS:
            t1 = time.perf_counter()
            # the last spawn also runs the model, pipe and seq layouts
            layouts = list(dryrun.AXES_LAYOUTS) if fsdp == MULTI_LAYOUTS[-1] else []
            try:
                out = dryrun.dryrun_multirank(MULTI_RANKS, fsdp, "cuda", layouts=layouts)
            except Exception as e:
                failed.append(f"(a) fsdp {fsdp}")
                log(f"[multi a] fsdp {fsdp}: FAILED after {time.perf_counter() - t1:.1f} s: "
                    f"{type(e).__name__}: {e}")
                continue
            log(f"[multi a] data {MULTI_RANKS // fsdp} x fsdp {fsdp}"
                f"{' and ' + ', '.join(layouts) if layouts else ''} on NCCL: {out} equal to "
                f"one card's within 1e-5 ({time.perf_counter() - t1:.1f} s)")
    held = _check_train_calls("multi a", k3_calls, k4_calls, seen)
    log(f"[multi a] {held} K3/K4 shapes (a rank's and the one-card reference's) held to their "
        f"plain versions and the fp32 function")
    crit, optim = _train_configs()
    cfg = dataclasses.replace(ofa_large(), dtype="bfloat16", use_flash_attention=True,
                              remat=True, **REMAT_RATES)
    params = trainable(from_jax(_random_model_tree(cfg, SEED + 22), cfg, "cpu", torch.float32))
    runs = {}
    for name, world, fsdp in (("one card", 1, 1), ("data 4", MULTI_RANKS, 1),
                              ("fsdp 4", MULTI_RANKS, MULTI_RANKS)):
        batches = {n: type(b)(*[None if x is None else x.cpu() for x in b]) for n, b in
                   _train_batches(cfg, TRAIN_TASKS, TRAIN_BATCH * world, SEED).items()}
        job = dryrun.Job(cfg, crit, optim, params, [batches] * REMAT_UPDATES, update=TRAIN_STEP0,
                         seed=SEED, keep_state=False)
        t1 = time.perf_counter()
        if world == 1:
            k3_calls, k4_calls = {}, {}
            with mock.patch.object(kb, "FlashAttentionTrainable",
                                   _recording_attention(k3_calls, k4_calls)):
                rec = dryrun.run_job(job, device="cuda:0")
            rec.update(peaks=[rec["peak"]], rank_state_bytes=[rec["state_bytes"]])
            held = _check_train_calls("multi b", k3_calls, k4_calls, seen)
            log(f"[multi b] {held} K3/K4 shapes of the one-card run (each rank's below, the "
                f"recompute's K3 among them) held to their plain versions and the fp32 function")
        else:
            rec = dryrun.run_ranks(world, fsdp, job, "cuda")
        runs[name] = rec
        flops = _step_flops(cfg, _batch_shapes(batches), rdrop=crit.use_rdrop)
        p50 = statistics.median(rec["secs"][1:])
        log(f"[multi b] ofa_large bf16 --remat, {len(TRAIN_TASKS)} tasks x {TRAIN_BATCH * world} "
            f"rows on {name}: losses {[m['loss'] for m in rec['metrics']]}, steps "
            f"{[round(x * 1e3, 1) for x in rec['secs']]} ms (p50 after the first {p50 * 1e3:.1f} "
            f"ms, {len(TRAIN_TASKS) * TRAIN_BATCH * world / p50:.2f} samples/s, MFU "
            f"{flops / p50 / (world * _peak_bf16(smi)):.4f}), state per rank "
            f"{[round(b / 2**30, 3) for b in rec['rank_state_bytes']]} GiB, peak per rank "
            f"{[round(x / 2**30, 2) for x in rec['peaks']]} GiB ({time.perf_counter() - t1:.1f} s)"
            f" on {smi}")
    a, b = runs["data 4"], runs["fsdp 4"]
    gaps = [abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in zip(b["metrics"], a["metrics"])]
    log(f"[multi b] fsdp 4 against data 4: loss gaps {gaps} (tol {BF16_TOL}); state per rank "
        f"{b['rank_state_bytes'][0] / a['rank_state_bytes'][0]:.3f} of it")
    if not max(gaps) <= BF16_TOL or not b["rank_state_bytes"][0] < a["rank_state_bytes"][0]:
        failed.append("(b)")
        log(f"[multi b] FAILED: fsdp 4 against data 4: loss gaps {gaps}, state "
            f"{b['rank_state_bytes']} vs {a['rank_state_bytes']}")
    try:
        runs.update(_multi_axes(smi))
    except AssertionError as e:
        failed.append(str(e))
    log(f"[multi] phase 23 done in {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"phase 23: {failed}")
    return runs


# (c): ofa_large at the model, pipe and seq axes on the four cards, one spawn
# a layout: (name, the layout's axes, rows a task in all, its model options,
# the seconds its spawn may take, its NCCL timeout less 30). Every rank of
# model, pipe and seq holds all rows of the step (the axes split the layers,
# not the batch), so 2 rows a task is a one-card run's batch on every rank;
# M = 8 needs 4 (R-Drop's 8 forward rows a task, one a microbatch). Data 2 x
# pipe 2 splits the 2 rows over the data ranks: R-Drop's 2 a rank, one a
# microbatch, 24 layers in 2 chunks a stage.
MULTI_AXES = (
    ("model 4", dict(model=MULTI_RANKS), TRAIN_BATCH, {}, 180.0),
    ("pipe 4 M4", dict(pipe=MULTI_RANKS), TRAIN_BATCH, dict(pipeline_microbatches=4), 180.0),
    ("seq 4", dict(seq=MULTI_RANKS), TRAIN_BATCH, dict(seq_parallel=True), 180.0),
    ("data 2 x pipe 2 V2", dict(pipe=2), TRAIN_BATCH,
     dict(pipeline_microbatches=2, pipeline_interleave=2), 180.0),
    ("pipe 4 M8", dict(pipe=MULTI_RANKS), 2 * TRAIN_BATCH, dict(pipeline_microbatches=8), 300.0),
    ("pipe 4 M8 8 rows", dict(pipe=MULTI_RANKS), 4 * TRAIN_BATCH,
     dict(pipeline_microbatches=8), 420.0),
)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  encoder_drop_path_rate=0.0, decoder_drop_path_rate=0.0)


def _multi_axes(smi: str) -> dict:
    """Phase 23 (c): ``ofa_large`` bf16 ``--remat`` with dropout off (the
    pipeline's and the SP gate's condition in training), phase 8's 8 tasks,
    3 updates, at each layout of ``MULTI_AXES`` on the 4 cards, each in a
    spawn of its own, every rank printing its state, its steps and its peak
    memory as it goes; and on card 0 alone in this process on the same
    batches (the layouts' options act only over a mesh). Each layout's
    losses are held to the one card's within BF16_TOL, and its step times,
    samples/s, MFU, state and peak per rank are printed; each rank's state
    must be the bytes ``leaf_spec`` reckons for its place on the mesh (a
    pipe stage: its own layers' parameters and moments). A layout that
    fails or outlives its limit is reported and the next one runs; the phase
    then fails."""
    from musketeer_tpu_torch.config import MeshConfig, ofa_large
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.parallel import dryrun

    crit, optim = _train_configs()
    base = dataclasses.replace(ofa_large(), dtype="bfloat16", use_flash_attention=True,
                               remat=True, **NO_DROPOUT)
    params = trainable(from_jax(_random_model_tree(base, SEED + 22), base, "cpu", torch.float32))
    steps, refs, runs, failed = {}, {}, {}, []

    def job(cfg, rows: int, report: str):
        return dryrun.Job(cfg, crit, optim, params, [steps[rows]] * REMAT_UPDATES,
                          update=TRAIN_STEP0, seed=SEED, keep_state=False, report=report)

    def show(name: str, world: int, rows: int, rec: dict, secs: float) -> None:
        flops = _step_flops(base, _batch_shapes(steps[rows]), rdrop=crit.use_rdrop)
        p50 = statistics.median(rec["secs"][1:])
        log(f"[multi c] ofa_large bf16 --remat, dropout off, {len(TRAIN_TASKS)} tasks x {rows} "
            f"rows on {name}: losses {[m['loss'] for m in rec['metrics']]}, steps "
            f"{[round(x * 1e3, 1) for x in rec['secs']]} ms (p50 after the first {p50 * 1e3:.1f} "
            f"ms, {len(TRAIN_TASKS) * rows / p50:.2f} samples/s, MFU "
            f"{flops / p50 / (world * _peak_bf16(smi)):.4f}), state per rank "
            f"{[round(b / 2**30, 3) for b in rec['rank_state_bytes']]} GiB, peak per rank "
            f"{[round(x / 2**30, 2) for x in rec['peaks']]} GiB ({secs:.1f} s) on {smi}")

    for name, axes, rows, opts, limit in MULTI_AXES:
        if rows not in steps:
            steps[rows] = {n: type(b)(*[None if x is None else x.cpu() for x in b]) for n, b in
                           _train_batches(base, TRAIN_TASKS, rows, SEED).items()}
            t1 = time.perf_counter()
            rec = dryrun.run_job(job(base, rows, f"multi c one card {rows}"), device="cuda:0")
            rec.update(peaks=[rec["peak"]], rank_state_bytes=[rec["state_bytes"]])
            refs[rows] = runs[f"one card {rows}"] = rec
            show("one card", 1, rows, rec, time.perf_counter() - t1)
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        try:
            rec = dryrun.run_layouts(
                MULTI_RANKS, [(MeshConfig(**axes), job(dataclasses.replace(base, **opts), rows,
                                                       f"multi c {name}"))],
                "cuda", timeout=limit)[0]
        except Exception as e:  # reported; the next layout runs, and the phase fails below
            failed.append(name)
            log(f"[multi c] {name}: FAILED after {time.perf_counter() - t1:.1f} s: "
                f"{type(e).__name__}: {e}")
            continue
        runs[name] = rec
        show(name, MULTI_RANKS, rows, rec, time.perf_counter() - t1)
        ref = refs[rows]["metrics"]
        gaps = [abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in zip(rec["metrics"], ref)]
        log(f"[multi c] {name} against one card: loss gaps {gaps} (tol {BF16_TOL}); state per "
            f"rank {rec['rank_state_bytes']} bytes, leaf_spec reckons {rec['rank_reckoned_bytes']}"
            f" (one card {refs[rows]['state_bytes']}); peak per rank "
            f"{[round(x / 2**30, 2) for x in rec['peaks']]} GiB")
        log(f"[multi c] {name}: K1/K3/K4 launches over the {REMAT_UPDATES} updates per rank "
            f"{rec['rank_launches']} (one card {refs[rows]['launches']})")
        ring = "seq" in axes  # ring attention: plain products, no K3/K4 (phase 24)
        launched = all(n["K3"] == n["K4"] == 0 if ring else n["K3"] > 0 and n["K4"] > 0
                       for n in rec["rank_launches"])
        if (not max(gaps) <= BF16_TOL or rec["rank_state_bytes"] != rec["rank_reckoned_bytes"]
                or not launched):
            failed.append(name)
    if failed:
        raise AssertionError(f"phase 23 (c): {failed} failed or differ from one card")
    return runs


# ---------------------------------------------------------------------------
# phase 24: the model, pipe and seq axes at size 1 on one card
# ---------------------------------------------------------------------------

# ofa_large at full width, depth cut to 4 + 4 (a pipeline stage's L/P layers);
# an image task and a text task, 2 rows each (R-Drop: 4), dropout off (the
# pipeline's and the SP gate's condition in training)
AXES_LAYERS = 4
AXES_TASKS = {"caption": TRAIN_TASKS["caption"], "gigaword": (128, 32, False, False, None)}
AXES_MODEL = 4  # one rank's shard: 16 / 4 heads, ffn 4096 / 4


def _one_rank_group():
    """A process group of this process alone (NCCL), which the model axis's
    collectives run on when a mesh names no group of its own."""
    import os
    import socket

    import torch.distributed as dist

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    os.environ.setdefault("MASTER_ADDR", "localhost")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))


def phase_axes(smi: str, seen: set = None) -> dict:
    """Phase 24: ``ofa_large`` bf16 (4 + 4 layers) through each new path at
    size 1 on one card, one joint update each from one state: the plain step;
    the whole-mesh step at model 1 (``DataParallel`` over a world of one);
    the pipelined encoder and decoder at pipe 1 with M = 2 (GPipe's schedule,
    each stage's K3/K4 at B/M rows), and with ``--remat`` (the stage's forward
    on K1, its recompute on K3 and K4); ring attention at seq 1. Each run's
    loss and gradient norm equal the plain step's within ``BF16_TOL``. The
    pipelined forward without autograd (validation's) runs K1 at B/M rows.
    Then one model rank's shard at model 4 (4 heads, ffn 1024): its forward
    and backward, the model axis's collectives on a process group of one,
    K3/K4 at 4 heads. The pipe and seq gates open at one rank only here: the
    model's gate functions are patched to return a mesh of one rank. Every
    K1/K3/K4 shape of these runs is held to its plain version and the fp32
    function. → {run: its K1/K3/K4 launches}."""
    import torch.distributed as dist

    from musketeer_tpu_torch.config import ofa_large
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.parallel import DataParallel, set_mesh
    from musketeer_tpu_torch.parallel.mesh import Mesh
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.training import init_train_state, make_train_step
    from musketeer_tpu_torch.training.train_state import named_leaves
    from musketeer_tpu_torch.training.train_step import multitask_loss

    t0 = time.perf_counter()
    seen = set() if seen is None else seen
    cfg0 = dataclasses.replace(ofa_large(), dtype="bfloat16", use_flash_attention=True,
                               encoder_layers=AXES_LAYERS, decoder_layers=AXES_LAYERS)
    tree = _random_model_tree(cfg0, SEED + 24)
    crit, optim = _train_configs()
    batches = _train_batches(cfg0, AXES_TASKS, TRAIN_BATCH, SEED)
    one = Mesh((1, 1, 1, 1, 1), 0, {})
    pipe_gate = lambda cfg: one if cfg.pipeline_microbatches > 0 else None
    seq_gate = lambda cfg: one if cfg.seq_parallel else None
    runs = {"plain": {}, "model 1": {}, "pipe 1 M2": dict(pipeline_microbatches=2),
            "pipe 1 M2 remat": dict(pipeline_microbatches=2, remat=True),
            "seq 1": dict(seq_parallel=True)}
    k1_calls, k3_calls, k4_calls = {}, {}, {}
    out, launches = {}, {}
    for name, kw in runs.items():
        cfg = dataclasses.replace(cfg0, **kw)
        params = trainable(from_jax(tree, cfg, "cuda", torch.float32))
        state = init_train_state(params, optim)._replace(step=TRAIN_STEP0)
        par = DataParallel(one, params, cfg) if name == "model 1" else None
        step = make_train_step(cfg, crit, optim, parallel=par)
        torch.cuda.synchronize()
        _reset_counters()
        t1 = time.perf_counter()
        with mock.patch.object(ofa, "_active_pipe_mesh", pipe_gate), \
                mock.patch.object(ofa, "_active_seq_mesh", seq_gate), \
                mock.patch.object(kb, "FlashAttentionTrainable",
                                  _recording_attention(k3_calls, k4_calls)), \
                _recording_k1_k2(k1_calls, {}):
            state, m = step(state, batches, None)
            torch.cuda.synchronize()
        c = _counters()
        launches[name] = {k: c[k] for k in ("K1", "K3", "K4")}
        out[name] = dict(loss=float(m["loss"]), gnorm=float(m["gnorm"]))
        log(f"[axes] {name}: loss {out[name]['loss']:.6f} gnorm {out[name]['gnorm']:.6f}, "
            f"launches {launches[name]}, {time.perf_counter() - t1:.2f} s")
        del state, step, params
    ref = out["plain"]
    for name, r in out.items():
        gaps = {k: abs(r[k] - ref[k]) / abs(ref[k]) for k in ("loss", "gnorm")}
        if max(gaps.values()) > BF16_TOL:
            raise AssertionError(f"[axes] {name} against the plain step: {gaps} > {BF16_TOL}")
    if launches["model 1"] != launches["plain"] or out["model 1"] != out["plain"]:
        raise AssertionError(f"[axes] model 1 differs from the plain step: {out}, {launches}")
    for name in ("pipe 1 M2", "pipe 1 M2 remat"):  # each microbatch's calls
        n = launches[name]
        if not (n["K3"] == n["K4"] == 2 * launches["plain"]["K4"]):
            raise AssertionError(f"[axes] {name}: K3/K4 launches {n} against {launches['plain']}")
    if launches["pipe 1 M2 remat"]["K1"] != 2 * launches["plain"]["K3"]:
        raise AssertionError(f"[axes] the remat stage's forward runs K1: {launches}")
    if launches["seq 1"]["K3"] != 0 or launches["seq 1"]["K4"] != 0:
        raise AssertionError(f"[axes] ring attention is plain PyTorch: {launches['seq 1']}")
    # the pipelined forward without autograd (validation's): K1 at B/M rows
    cfg = dataclasses.replace(cfg0, pipeline_microbatches=2)
    params = from_jax(tree, cfg, "cuda", torch.bfloat16)
    b = _micro(batches)["caption"]
    _reset_counters()
    with mock.patch.object(ofa, "_active_pipe_mesh", pipe_gate), torch.no_grad(), \
            _recording_k1_k2(k1_calls, {}):
        pipelined = ofa.forward(params, cfg, b.src_tokens, b.prev_output_tokens,
                                b.patch_images.to(torch.bfloat16), b.patch_masks)
        torch.cuda.synchronize()
    c = _counters()
    launches["pipe 1 M2 no grad"] = {k: c[k] for k in ("K1", "K3", "K4")}
    with torch.no_grad():
        plain = ofa.forward(params, dataclasses.replace(cfg, pipeline_microbatches=0),
                            b.src_tokens, b.prev_output_tokens, b.patch_images.to(torch.bfloat16),
                            b.patch_masks)
    err = _check_close("[axes] pipelined forward", pipelined[..., :cfg.vocab_size].float(),
                       plain[..., :cfg.vocab_size].float(), BF16_TOL)
    want = 2 * (cfg.encoder_layers + 2 * cfg.decoder_layers)  # per microbatch
    if launches["pipe 1 M2 no grad"] != {"K1": want, "K3": 0, "K4": 0}:
        raise AssertionError(f"[axes] pipelined forward launches {launches['pipe 1 M2 no grad']}")
    log(f"[axes] pipelined forward without autograd: logits within {err:.3e} of the plain "
        f"forward's, launches {launches['pipe 1 M2 no grad']}")
    # one model rank's shard at model 4
    _one_rank_group()
    try:
        mesh4 = Mesh((1, 1, AXES_MODEL, 1, 1), 0, {})
        full = trainable(from_jax(tree, cfg0, "cuda", torch.float32))
        blocks = DataParallel(mesh4, full, cfg0).shard(full)
        blocks["embed_tokens"] = full["embed_tokens"]  # the model uses it whole
        _reset_counters()
        with set_mesh(mesh4), mock.patch.object(kb, "FlashAttentionTrainable",
                                                _recording_attention(k3_calls, k4_calls)):
            loss, _ = multitask_loss(blocks, cfg0, crit, _micro(batches), None, TRAIN_STEP0)
            loss.backward()
        torch.cuda.synchronize()
        c = _counters()
        launches[f"model {AXES_MODEL} shard"] = {k: c[k] for k in ("K1", "K3", "K4")}
        grads = [p.grad for _, p in named_leaves(blocks) if p.grad is not None]
        if not (math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)):
            raise AssertionError("[axes] the model shard's loss or gradients are not finite")
        q = blocks["encoder"]["layers"][0]["self_attn"]["q_proj"]["w"]
        f1 = blocks["encoder"]["layers"][0]["fc1"]["w"]
        log(f"[axes] model {AXES_MODEL} shard: q_proj {tuple(q.shape)}, fc1 {tuple(f1.shape)}, "
            f"loss {float(loss):.6f} (a shard's part), {len(grads)} finite gradient leaves, "
            f"launches {launches[f'model {AXES_MODEL} shard']}")
    finally:
        dist.destroy_process_group()
    shard_keys = [k for k in k3_calls if f" H{cfg0.attention_heads // AXES_MODEL} " in k]
    if not shard_keys:
        raise AssertionError(f"[axes] no K3 call at {cfg0.attention_heads // AXES_MODEL} heads")
    t1 = time.perf_counter()
    held = _check_train_calls("axes", k3_calls, k4_calls, seen)
    _check_eval_calls("axes", k1_calls, {}, seen)
    log(f"[axes] {held} K3/K4 shapes (the model shard's {sorted(shard_keys)} among them) and "
        f"{len(k1_calls)} K1 shapes held to their plain versions and the fp32 function "
        f"({time.perf_counter() - t1:.1f} s)")
    log(f"[axes] phase 24 done in {time.perf_counter() - t0:.1f} s on {smi}")
    return launches


# phase 25: ofa_huge (d 1280, 16 heads: head dim 80; 24 + 12 layers, ResNet
# (3, 8, 36)), the one preset whose head dim is not 64
HUGE = "ofa_huge"
HUGE_HD = 80
HUGE_K1 = dict(B=16, H=16, T=908, S=908, D=HUGE_HD)
HUGE_K2 = dict(N=BATCH * BEAM, D=1280, Vp=59520, vocab_size=59457)
HUGE_K34 = {n: dict(c, shape=dict(c["shape"], H=16, D=HUGE_HD)) for n, c in K34_SHAPES.items()}
HUGE_K34_SMALL = {n: dict(c, shape=dict(c["shape"], D=HUGE_HD)) for n, c in K34_SMALL.items()}
HUGE_K5 = {n: dict(c, shape=dict(c["shape"], H=16, D=HUGE_HD)) for n, c in K5_SHAPES.items()}
HUGE_K5_SMALL = {n: dict(c, shape=dict(c["shape"], D=HUGE_HD)) for n, c in K5_SMALL.items()}
HUGE_K6 = dict(B=BATCH, H=16, Kb=BEAM, S=908, D=HUGE_HD)
HUGE_K6_CASES = tuple((name.replace("H12", "H16"), HUGE_K6 if shape is K6_SHAPE
                       else dict(shape, D=HUGE_HD), dtype) for name, shape, dtype in K6_CASES)
HUGE_K7 = dict(L=12, B=BATCH, Kb=BEAM, H=16, f=5120, Tmax=MAX_LEN + 1, S=908)
# the mangled names of the tensor-core kernels that take the tile width as a
# template argument (flash_fwd_sm90.cuh, flash_bwd_sm90.cuh, decode_attn_sm90.cuh,
# decode_cross_attn.cu), and their instances (csrc/common.cuh::with_head_dim)
HEAD_DIM_KERNELS = ("2mk4sm90", "11decode_attn", "cross_attn_i8_sm90_kernel")
HEAD_DIM_INSTANCES = (32, 64, 80, 128, 192, 256)
# the instances past 128 (phase 28) are reported for the FMA kernels too:
# flash_fwd.cuh's and flash_attention.cu's forwards, flash_attention_bwd.cu's
# two backward kernels, cross_attn.cuh's, and K7's self-attentions
WIDE_INSTANCES = (192, 256)
WIDE_KERNELS = ("9flash_fwd6kernel", "10cross_attn6kernel", "bwd_kv_kernel", "bwd_q_kernel",
                "self_attn", "_GLOBAL__N_16kernel")


def _ptxas_instances(text: str) -> list:
    """ptxas's registers and spills of each instance of the tensor-core
    attention kernels → [(instance, mangled name, registers, spill stores,
    spill loads)]."""
    out, name, dp = [], None, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = line.split("'")[1] if "'" in line else line
            dp = next((n for n in HEAD_DIM_INSTANCES if f"ILi{n}E" in m), None)
            kernels = HEAD_DIM_KERNELS + (WIDE_KERNELS if dp in WIDE_INSTANCES else ())
            # the pair and deep routes' kernels (their maps' chunk is 128) print on their own
            name = m if any(k in m for k in kernels) and dp and "_deep" not in m else None
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = nums[1:3]
        elif name and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            if all(o[1] != name for o in out):  # an instance built in two sources
                out.append((dp, name, regs, *spills))
            name = None
    return sorted(out, key=lambda o: o[0])


def _huge_train(tree, smi: str) -> dict:
    """(c) The joint step of ofa_huge in bf16 under --remat on phase 8's tasks
    and batches: one warm-up and 2 timed updates through init_train_state and
    make_train_step; the loss finite at every update, the parameters moved;
    K3 2x (the recompute) and K4 1x ``encoder_layers + 2 decoder_layers`` per
    transformer forward, the forwards counted from the step's packing groups;
    the step's p50, peak memory and MFU (utils/flops.py); one more step under
    torch.profiler (phase 8's). → its launches."""
    from musketeer_tpu_torch.config import ofa_huge
    from musketeer_tpu_torch.params import from_jax, trainable
    from musketeer_tpu_torch.training import init_train_state, make_train_step
    from musketeer_tpu_torch.training.train_state import named_leaves

    cfg = dataclasses.replace(ofa_huge(), dtype="bfloat16", use_flash_attention=True, remat=True)
    crit, optim = _train_configs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(trainable(from_jax(tree, cfg, "cuda", torch.float32)), optim)
    state = state._replace(step=TRAIN_STEP0)
    step = make_train_step(cfg, crit, optim)
    batches = _train_batches(cfg, TRAIN_TASKS, TRAIN_BATCH, SEED)
    forwards = _expected_forwards(batches)
    per_forward = cfg.encoder_layers + 2 * cfg.decoder_layers
    first = [p.detach().flatten()[:4].clone() for _, p in named_leaves(state.params)]
    n_params = sum(p.numel() for _, p in named_leaves(state.params))
    losses, times = [], []
    for i in range(3):
        if i == 1:
            _reset_counters()
        t0 = time.perf_counter()
        state, m = step(state, batches)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if not (math.isfinite(loss) and float(m["skipped_nonfinite"]) == 0.0):
            raise AssertionError(f"{HUGE} training step: loss {loss}, skipped "
                                 f"{float(m['skipped_nonfinite'])}")
    launches = _counters()
    want = dict.fromkeys(launches, 0)
    want.update(K3=2 * 2 * per_forward * forwards, K4=2 * per_forward * forwards)
    if launches != want:
        raise AssertionError(f"{HUGE} --remat training launches over 2 updates {launches}, "
                             f"expected {want}")
    moved = sum(not torch.equal(p.detach().flatten()[:4], p0)
                for (_, p), p0 in zip(named_leaves(state.params), first))
    if moved < len(first) // 2:
        raise AssertionError(f"{HUGE}: the parameters must move ({moved} of {len(first)} leaves)")
    p50 = statistics.median(times[1:])
    flops = _step_flops(cfg, _batch_shapes(batches), rdrop=crit.use_rdrop)
    samples = TRAIN_BATCH * len(TRAIN_TASKS)
    log(f"[huge train] {HUGE} ({n_params} trainable parameters) bf16 --remat "
        f"{len(TRAIN_TASKS)} tasks x batch {TRAIN_BATCH}: "
        f"losses {[round(x, 4) for x in losses]}, {moved} of {len(first)} parameter leaves moved; "
        f"steps {[round(t * 1e3, 1) for t in times]} ms, p50 of the 2 timed {p50 * 1e3:.1f} ms, "
        f"{samples / p50:.2f} samples/s, MFU {flops / p50 / _peak_bf16(smi):.4f} "
        f"({flops / 1e12:.2f} TFLOP a step, utils/flops.py), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches over the 2 timed "
        f"updates {launches} ({forwards} transformer forwards a step, {per_forward} attentions "
        f"each, K3 twice under --remat) on {smi}")
    _profile_train_step(step, state, batches, smi)
    del state, step, m
    torch.cuda.empty_cache()
    return {k: n // 2 for k, n in launches.items()}  # a step's


def phase_huge(smi: str) -> tuple:
    """Phase 25: ofa_huge. (a) K1, K3/K4, K5, K6 and K7 at head dim 80 and K2,
    K2-q8 at d 1280 against their plain versions, in the kind and tolerance of
    phases 3, 4, 7, 10, 11, 12 and 16, timed, with their bounds and library
    calls; (b) the caption slice and both serving slices at full width and
    depth, their profile, then their fp32 exactness at batch 2; (c) a --remat
    training step and its profile, and the fp32 training exactness. → (stats by kernel, each kernel's
    launches on its main path)."""
    from musketeer_tpu_torch.config import ofa_huge
    from musketeer_tpu_torch.ops import _build
    from musketeer_tpu_torch.ops import topk_projection as k2

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    stats = {"K1": phase_k1(g, HUGE_K1)}
    rows, d = HUGE_K2["N"], HUGE_K2["D"]
    for q8 in (False, True):
        tile, ctas, _ = k2.proj_plan(rows, d, _build.sm_count(torch.device("cuda")),
                                     HUGE_K2["Vp"], q8=q8)
        log(f"[huge K2{'-q8' if q8 else ''}] d {d}: row tile {tile} for {rows} rows, so "
            f"{-(-rows // tile)} row tiles of {ctas} CTAs, each streaming the whole weight")
    stats["K2"] = phase_k2(g, shape=HUGE_K2)
    stats["K2-q8"] = phase_k2q8(g, shape=HUGE_K2)
    stats["K6"] = phase_k6(g, cases=HUGE_K6_CASES, main=HUGE_K6)
    stats["K7"] = phase_k7(g, shape=HUGE_K7, hd=HUGE_HD)
    stats.update(phase_k3_k4(g, HUGE_K34, HUGE_K34_SMALL, saved=False))
    k5_stats, k5_launches = phase_k5(g, HUGE_K5, HUGE_K5_SMALL)
    stats.update(k5_stats)
    t1 = time.perf_counter()
    log(f"[huge a] the kernels at head dim {HUGE_HD} and d {d}: {t1 - t0:.1f} s")
    tree = _random_model_tree(dataclasses.replace(ofa_huge(), use_flash_attention=True),
                              SEED + 25)
    t2 = time.perf_counter()
    log(f"[huge b] {HUGE} tree drawn on the host in {t2 - t1:.1f} s")
    launches = {name: phase_slice(tree, smi, name, arch=HUGE) for name in SLICES}
    phase_profile(tree, HUGE)
    for name in SLICES:
        phase_exactness(tree, name, arch=HUGE)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    log(f"[huge b] the caption and serving slices and their fp32 exactness: {t3 - t2:.1f} s")
    train_launches = _huge_train(tree, smi)
    phase_train_exactness(tree, HUGE)
    torch.cuda.empty_cache()
    log(f"[huge c] the training step and its fp32 exactness: {time.perf_counter() - t3:.1f} s; "
        f"phase 25 in {time.perf_counter() - t0:.1f} s on {smi}")
    on_path = {"K1": launches["slice"], "K2": launches["slice"], "K2-q8": launches["serving A"],
               "K3": train_launches, "K4": train_launches, "K5": k5_launches,
               "K5-cross": k5_launches, "K6": launches["serving A"], "K7": launches["serving B"]}
    log(HUGE_TAG + json.dumps({k: dict(v, launches=on_path[k][k]) for k, v in stats.items()}))
    return stats, on_path


HUGE_TAG = "[huge kernels] "


def _phase_in_own_process(phase: int, flag: str, tag: str) -> dict:
    """Phase ``phase`` in the default run: this script with ``flag`` in a
    process of its own (the library already built), its output printed here.
    After the earlier phases' some forty torch.profiler sessions, one more in
    the same process recorded no device operations on the card; a fresh
    process also starts the phase with the card's memory free. → the entries
    of its ``tag`` line."""
    import os

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    run = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                         capture_output=True, text=True)
    print(run.stdout, end="", flush=True)
    print(run.stderr, end="", file=sys.stderr, flush=True)
    if run.returncode != 0:
        raise AssertionError(f"phase {phase} ({flag}) exited with {run.returncode}")
    line = next(l for l in run.stdout.splitlines() if l.startswith(tag))
    return json.loads(line[len(tag):])


def _huge_in_own_process() -> tuple:
    """Phase 25 (``--huge-only``) in a process of its own. → its (stats by
    kernel, launches by kernel) from its ``HUGE_TAG`` line."""
    entries = _phase_in_own_process(25, "--huge-only", HUGE_TAG)
    return ({k: {n: x for n, x in v.items() if n != "launches"} for k, v in entries.items()},
            {k: {k: v["launches"]} for k, v in entries.items()})


# phase 26: every head dim up to 128 (the instances 32, 64, 80 and 128 of the
# attention kernels), and ofa_base split into 6 heads of 128 and 24 of 32
HD_DIMS = (8, 16, 20, 32, 48, 96, 112, 128)  # 20: not a multiple of 8 (padded copies)
HD_CONFIGS = {"ofa_base_hd128": dict(attention_heads=6),
              "ofa_base_hd32": dict(attention_heads=24)}
HD_TAG = "[head dims kernels] "
HD_FP32_TOL = 1e-5  # phase 26's fp32 calls: the done rule's 1e-5, not the earlier phases' 1e-4
HD_KERNELS = ("K1", "K3", "K4", "K5", "K5-cross", "K6", "K7")
# the depth of phases 26, 28 and 29 (b)'s configurations: ofa_base's width,
# head counts and ResNet at 2 + 2 layers (a head dim takes the same routes at
# any depth; at 6 + 6 the (b) parts took 72-76 s a phase of a run's 1171 s)
HD_DEPTH = dict(encoder_layers=2, decoder_layers=2)


def _heads_for(D: int, width: int = 768) -> int:
    """The head count whose width H·D lies nearest ``width`` among those that
    are a multiple of 64 (K7's products take d in chunks of 64)."""
    return min((h for h in range(1, 2 * width // D + 2) if h * D % 64 == 0),
               key=lambda h: (abs(h * D - width), h))


def _padded_counts() -> dict:
    """The attention wrappers' launches on zero-padded copies (``.padded``)."""
    from musketeer_tpu_torch.ops import decode_cross_attn as k6
    from musketeer_tpu_torch.ops import decode_stack as k7
    from musketeer_tpu_torch.ops import flash_attention as k5
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.ops import flash_attention_infer as k1

    fns = {"K1": k1.flash_attention_inference, "K3": kb.flash_attention_fwd,
           "K4": kb.flash_attention_bwd, "K5": k5.flash_attention_bias,
           "K5-cross": k5.flash_cross_attention, "K6": k6.decode_cross_attention_int8,
           "K7": k7.decode_stack_step}
    return {k: fn.padded for k, fn in fns.items()}


def _hd_k7(g, D: int, H: int, L: int) -> dict:
    """K7 at head dim D: rows 80, L layers, d = H·D, f = 4 d, Tmax 17, S 908;
    bf16 at cache_index 0 and 16: the whole stack against the fp32 function
    (within plain's error + one bf16 step) and each layer on plain's input
    against plain (``BF16_TOL``), as phase 25 holds a stack deeper than
    phase 12's in spans (the whole 6-layer stacks' difference, printed: on
    an H100 1.36 % of max|x_out| at hd 64 in phase 12, 1.38 % at 32 and
    1.67 % at 128 here, each as far from the fp32 function as plain's);
    fp32 at 16, the whole stack against plain (``FP32_TOL``); timed at 16."""
    from musketeer_tpu_torch.ops import decode_stack as k7

    names = ("x0", "sbias", "cbias", "self_k", "self_v", "cross_k", "cross_v")
    shape = dict(L=L, B=BATCH, Kb=BEAM, H=H, f=4 * H * D, Tmax=MAX_LEN + 1, S=908)
    scaling, idx_last = (D * 2.0) ** -0.5, K7_INDICES[-1]
    tag = f"rows {BATCH * BEAM} L{L} d{H * D} H{H} hd{D}"
    stats = {}
    for dtype, tol, indices in ((torch.bfloat16, BF16_TOL, (0, idx_last)),
                                (torch.float32, FP32_TOL, (idx_last,))):
        pack, x = _k7_inputs(g, **shape, dtype=dtype, hd=D)
        args = [x[n] for n in names]
        for idx in indices:
            call = lambda fn, p=pack, a=args: fn(p, *a, idx, beam_size=BEAM, scaling=scaling)
            before = _counters()
            out, ref = call(k7.decode_stack_step), call(k7.decode_stack_plain)
            torch.cuda.synchronize()
            if _counters()["K7-sm90"] - before["K7-sm90"] != (dtype == torch.bfloat16):
                raise AssertionError(f"K7 hd{D} {dtype}: bf16 must run the tensor-core route, "
                                     "fp32 the FMA route")
            if dtype == torch.bfloat16:
                whole = [_max_err(a, b) for a, b in zip(out, ref)]
                log(f"[K7] {tag} bf16 cache_index {idx}: the whole stack against plain: max abs "
                    f"diff x_out {whole[0]:.3e}, k_new {whole[1]:.3e}, v_new {whole[2]:.3e} "
                    f"(max |x_out| {float(ref[0].float().abs().max()):.2f})")
                errs = _k7_spans(k7, pack, args, idx, scaling, tol, span=1)
            else:
                errs = [_check_close(f"K7 hd{D} {n} cache_index {idx}", a, b, tol)
                        for n, a, b in zip(("x_out", "k_new", "v_new"), out, ref)]
            msg = ""
            if dtype == torch.bfloat16:
                fn = call(k7.decode_stack_plain, {k: v.float() for k, v in pack.items()},
                          [a.float() for a in args])
                msg = "; " + "; ".join(f"{n} " + _check_function(f"K7 hd{D} {n}", a, b, c)
                                       for n, a, b, c in zip(("x_out", "k_new", "v_new"), out,
                                                             ref, fn))
                del fn
            log(f"[K7] {tag} {str(dtype)[6:]} cache_index {idx}: max abs err "
                f"{'a layer ' if dtype == torch.bfloat16 else ''}x_out {errs[0]:.3e}, k_new "
                f"{errs[1]:.3e}, v_new {errs[2]:.3e}{msg}")
            if dtype == torch.bfloat16 and idx == idx_last:
                ms = cuda_ms(lambda: call(k7.decode_stack_step), 10)
                plain_ms = cuda_ms(lambda: call(k7.decode_stack_plain), 5)
                work = _k7_work(pack, x, idx)
                log(f"[K7] {tag} cache_index {idx}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
                    f"per step, bound {work['bound_ms']:.4f} ms ({work['bound_by']})")
                stats = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
                             **work)
        del pack, x, args
    return stats


def _hd_kernels(g, D: int, on_path: bool, H: int = None) -> tuple:
    """Phase 26 (a) at head dim D, through phases 3, 7, 11, 12 and 16's
    functions: H heads, by default ~ 768 / D (``_heads_for``); at a head dim
    of (b)'s configurations (``on_path``) the main shapes at their full batch
    and all of the small cases, else batch 4 and a few small cases. → (stats
    by kernel, K5's launches on its main path)."""
    H = H or _heads_for(D)
    B = BATCH if on_path else 4
    with_d = lambda cases, **kw: {n: dict(c, shape=dict(c["shape"], D=D, **kw))
                                  for n, c in cases.items()}
    pick = lambda cases, names: cases if on_path else {n: cases[n] for n in names}
    log(f"[head dims a] D{D}: {H} heads (width {H * D}), instance "
        f"{next((n for n in HEAD_DIM_INSTANCES if n >= -(-D // 8) * 8), 'deep')}")
    stats = {"K1": phase_k1(g, dict(B=B, H=H, T=908, S=908, D=D))}
    stats.update(phase_k3_k4(g, with_d(K34_SHAPES, H=H),
                             with_d(pick(K34_SMALL, ("odd batch causal", "cross, odd S"))),
                             saved=False))
    k5_shapes = with_d(K5_SHAPES, H=H)
    k5_shapes["encoder"]["shape"]["B"] = B
    k5_stats, k5_launches = phase_k5(g, k5_shapes, with_d(pick(
        K5_SMALL, ("fully masked sample", "odd S", "cross, odd S"))))
    stats.update(k5_stats)
    main = dict(B=B, H=H, Kb=BEAM, S=908, D=D)
    cases = ((f"B{B} H{H} Kb5 S908", main, torch.bfloat16),
             ("B3 H2 Kb3 S37", dict(B=3, H=2, Kb=3, S=37, D=D), torch.bfloat16),
             ("B3 H2 Kb3 S37", dict(B=3, H=2, Kb=3, S=37, D=D), torch.float32))
    stats["K6"] = phase_k6(g, cases=cases, main=main)
    stats["K7"] = _hd_k7(g, D, H, K7_SHAPE["L"] if on_path else 2)
    return stats, k5_launches


def _hd_config(name: str, model: dict, smi: str, phase: int = 26) -> dict:
    """Phase 26 (b) (or 28's, 29's): ``ofa_base`` with ``model``'s head count,
    full width, ``HD_DEPTH``'s layers, seeded weights: the three caption
    slices in bf16 and in fp32 through the kernels and their plain versions,
    phase 8's joint step and phase 9's fp32 check. → each kernel's launches
    on its path."""
    from musketeer_tpu_torch.config import ofa_base

    t0 = time.perf_counter()
    model = dict(model, **HD_DEPTH)
    cfg = dataclasses.replace(ofa_base(), use_flash_attention=True, **model)
    tree = _random_model_tree(cfg, SEED + phase)
    log(f"[head dims b] {name}: d {cfg.embed_dim}, {cfg.attention_heads} heads of "
        f"{cfg.head_dim}, {cfg.encoder_layers} + {cfg.decoder_layers} layers, ResNet "
        f"{cfg.resnet_layers}; tree drawn in {time.perf_counter() - t0:.1f} s")
    launches = {s: phase_slice(tree, smi, s, model=model) for s in SLICES}
    for s in SLICES:
        phase_exactness(tree, s, model)
    train_launches, _ = phase_train(tree, smi, model=model, name=name)
    phase_train_exactness(tree, model=model)
    del tree
    torch.cuda.empty_cache()
    log(f"[head dims b] {name} in {time.perf_counter() - t0:.1f} s")
    return {"K1": launches["slice"]["K1"], "K2": launches["slice"]["K2"],
            "K2-q8": launches["serving A"]["K2-q8"], "K6": launches["serving A"]["K6"],
            "K7": launches["serving B"]["K7"], "K3": train_launches["K3"],
            "K4": train_launches["K4"]}


def phase_head_dims(smi: str) -> dict:
    """Phase 26: (a) the attention kernels at every head dim of ``HD_DIMS``,
    the wrappers' zero-padded copies counted where the head dim is not a
    multiple of 8 (K6: of 16); (b) the two configurations of
    ``HD_CONFIGS``; every fp32 check within ``HD_FP32_TOL``. → {kernel:
    {head dim: stats, its instance and the launches on its path}}."""
    with mock.patch.object(sys.modules[__name__], "FP32_TOL", HD_FP32_TOL):
        return _head_dims(smi)


def _head_dims(smi: str) -> dict:
    from musketeer_tpu_torch.config import ofa_base

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 26)
    heads = {name: ofa_base().embed_dim // m["attention_heads"] for name, m in HD_CONFIGS.items()}
    stats, k5_launches = {}, {}
    for D in HD_DIMS:
        t1, before = time.perf_counter(), _padded_counts()
        stats[D], k5_launches[D] = _hd_kernels(g, D, D in heads.values())
        padded = {k: n - before[k] for k, n in _padded_counts().items()}
        unit = {k: 16 if k == "K6" else 8 for k in padded}
        if any((n > 0) != (D % unit[k] != 0) for k, n in padded.items()):
            raise AssertionError(f"head dim {D}: launches on zero-padded copies {padded}")
        log(f"[head dims a] D{D} in {time.perf_counter() - t1:.1f} s; launches on zero-padded "
            f"copies {padded}")
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    log(f"[head dims a] the kernels at head dims {HD_DIMS}: {t2 - t0:.1f} s")
    on_path = {heads[name]: _hd_config(name, model, smi) for name, model in HD_CONFIGS.items()}
    log(f"[head dims b] both configurations: {time.perf_counter() - t2:.1f} s; phase 26 in "
        f"{time.perf_counter() - t0:.1f} s on {smi}")
    out = {}
    for k in HD_KERNELS:
        out[k] = {}
        for D in HD_DIMS:
            n = k5_launches[D][k] if k in ("K5", "K5-cross") else on_path.get(D, {}).get(k, 0)
            out[k][str(D)] = dict(stats[D][k], launches=n,
                                  instance=next(i for i in HEAD_DIM_INSTANCES
                                                if i >= -(-D // 8) * 8))
    log(HD_TAG + json.dumps(out))
    return out


# phase 27: the decode kernels K6, K7 and K2/K2-q8 at every beam count,
# encoder length, cache length and width that the Pallas kernels take (the
# routes of ops/decode_stack.py::stack_plan, ops/decode_cross_attn.py::plan
# and ops/topk_projection.py::proj_plan), best-of-24 image generation and the
# caption slices at 672²
SHAPES_TAG = "[shapes kernels] "
SHAPES_FP32_TOL = 1e-5  # the fp32 calls of phase 27, as phase 26's
SHAPES_BOTH = (torch.bfloat16, torch.float32)
# K6 and K7's cross-attention: (B, Kb, S, D); H from _heads_for(D)
SHAPES_CROSS = ((4, 17, 908, 64), (4, 24, 908, 64), (4, 32, 908, 64), (16, 16, 1772, 64),
                (16, 24, 1772, 64), (4, 24, 1772, 80), (4, 24, 1772, 128))
SHAPES_K6_LONG = ((16, 5, 4352, 64), (4, 16, 4352, 64))  # past the bf16 fit; past the FMA's
SHAPES_K7_LONG = ((16, 5, 4928, 64), (4, 16, 4928, 64))
SHAPES_TMAX = (2049, 4096)
SHAPES_WIDTHS = ((12, 72), (10, 80))  # (H, hd): d 864 and 800, not multiples of 64
SHAPES_K2_D = (5120, 6144, 8192)
SHAPES_IMAGE, SHAPES_BEAM = 672, 16  # the caption slices: ofa_base's 42 x 42 image buckets
GEN_BEST_OF, GEN_PROMPTS = 24, 2
BLK_K2 = 128  # K2's vocabulary block: one bmax and one bsum each


def _route_counts() -> dict:
    """The launches of the routes that phase 27 adds: beam tiles, score chunks,
    the self cache in chunks, d % 64 != 0, h streamed (0 where a tree lacks them)."""
    from musketeer_tpu_torch.ops import decode_cross_attn as k6
    from musketeer_tpu_torch.ops import decode_stack as k7
    from musketeer_tpu_torch.ops import topk_projection as k2

    fns = {"K6": (k6.decode_cross_attention_int8, ("beam_tiled", "chunked")),
           "K7": (k7.decode_stack_step, ("beam_tiled", "chunked", "cache_chunked", "ragged")),
           "K2": (k2.project_with_stats, ("streamed",)),
           "K2-q8": (k2.project_with_stats, ("streamed_q8",))}
    return {f"{k}.{a}": getattr(fn, a, 0) for k, (fn, attrs) in fns.items() for a in attrs}


def _route_moves(before: dict) -> dict:
    return {k: n - before[k] for k, n in _route_counts().items() if n != before[k]}


def _shape_case(kernel: str, tag: str, dtype, call, plain, fn, want: dict, work: dict,
                iters: int = 5, stats_from: int = None) -> dict:
    """One phase-27 call: the kernel against its plain version (bf16 within
    ``BF16_TOL`` and the fp32 function; fp32 within ``SHAPES_FP32_TOL``; the
    outputs from ``stats_from`` on, fp32 statistics, within ``FP32_TOL`` in
    bf16 as phase 4 holds them), the route counters moved as ``want``, its
    time by CUDA events beside plain's and the bound ``work``. ``call``,
    ``plain``: → a tuple of outputs; ``fn``: the function in fp32 (bf16 only)."""
    before = _route_counts()
    out = call()
    torch.cuda.synchronize()
    moved = _route_moves(before)
    if moved != want:
        raise AssertionError(f"{kernel} {tag} {dtype}: routes {moved}, expected {want}")
    ref = plain()
    tol = BF16_TOL if dtype == torch.bfloat16 else SHAPES_FP32_TOL
    tols = [tol if stats_from is None or i < stats_from else min(tol, FP32_TOL)
            for i in range(len(out))]
    err = max(_check_close(f"{kernel} {tag} {dtype} output {i}", a, b, t)
              for i, (a, b, t) in enumerate(zip(out, ref, tols)))
    msg = ""
    if dtype == torch.bfloat16:
        f = fn()
        msg = "; " + _check_function(f"{kernel} {tag}", out[0], ref[0], f[0])
        del f
    del out, ref
    ms, plain_ms = cuda_ms(call, iters), cuda_ms(plain, max(2, iters // 2))
    log(f"[shapes a] {kernel} {tag} {str(dtype)[6:]}: routes {moved}; max abs err {err:.3e}"
        f"{msg}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {work['bound_ms']:.4f} ms "
        f"({work['bound_by']})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, routes=moved, **work)


def _shapes_k6(g) -> dict:
    from musketeer_tpu_torch.ops import decode_cross_attn as k6

    names = ("q", "k_i8", "v_i8", "k_scale", "v_scale", "bias", "enc_pad")
    stats = {}
    for B, Kb, S, D in SHAPES_CROSS + SHAPES_K6_LONG:
        H = _heads_for(D)
        for dtype in SHAPES_BOTH:
            plan = k6.plan(Kb, S, D, fp32=dtype == torch.float32)
            want = {**({"K6.beam_tiled": 1} if plan["beam_tiles"] > 1 else {}),
                    **({"K6.chunked": 1} if plan["chunk"] < S else {})}
            if not want and _must_be_new(dtype, Kb, S):
                raise AssertionError(f"K6 Kb{Kb} S{S} D{D} {dtype}: a phase-27 shape must take a "
                                     f"route of the plan past today's ({plan})")
            x = _k6_inputs(g, B, H, Kb, S, D, dtype, full_pad=1)
            args = [x[n] for n in names]
            tag = f"B{B} H{H} Kb{Kb} S{S} D{D}"
            stats[f"{tag} {str(dtype)[6:]}"] = _shape_case(
                "K6", tag, dtype, lambda: (k6.decode_cross_attention_int8(*args),),
                lambda: (k6.decode_cross_attention_int8_plain(*args),),
                lambda: (k6.decode_cross_attention_int8_plain(x["q"].float(), *args[1:]),),
                want, _bound(_nbytes(*args) + x["q"].numel() * x["q"].element_size(),
                             4.0 * B * H * Kb * S * D))
            del x, args
    return stats


def _must_be_new(dtype, Kb: int, S: int) -> bool:
    """Whether a phase-27 cross-attention case must take a route past today's:
    every bf16 case; in fp32 those with more than 16 beams or, at 16 beams,
    with S past the FMA route's whole row (16 x 4096 scores and more)."""
    return dtype == torch.bfloat16 or Kb > 16 or Kb * S > 16 * 4096


def _shapes_k7_case(g, tag: str, shape: dict, hd: int, indices: tuple, dtype,
                    must: bool = False) -> dict:
    from musketeer_tpu_torch.ops import decode_stack as k7

    names = ("x0", "sbias", "cbias", "self_k", "self_v", "cross_k", "cross_v")
    scaling = (hd * 2.0) ** -0.5
    pack, x = _k7_inputs(g, **shape, dtype=dtype, hd=hd)
    args = [x[n] for n in names]
    out = {}
    for idx in indices:
        plan = k7.stack_plan(shape["Kb"], shape["S"], shape["Tmax"], idx, shape["H"] * hd,
                             shape["H"], fp32=dtype == torch.float32)
        want = {f"K7.{k}": 1 for k, on in (("beam_tiled", plan["beam_tiles"] > 1),
                                           ("chunked", plan["chunk"] < shape["S"]),
                                           ("cache_chunked", plan["cache_chunked"]),
                                           ("ragged", plan["ragged"])) if on}
        if must and not want:
            raise AssertionError(f"K7 {tag} {dtype}: a phase-27 shape must take a route past "
                                 f"today's ({plan})")
        call = lambda fn, p=pack, a=args, i=idx: fn(p, *a, i, beam_size=shape["Kb"],
                                                     scaling=scaling)
        out[f"{tag} cache_index {idx} {str(dtype)[6:]}"] = _shape_case(
            "K7", f"{tag} cache_index {idx}", dtype, lambda: call(k7.decode_stack_step),
            lambda: call(k7.decode_stack_plain),
            lambda: call(k7.decode_stack_plain, {k: v.float() for k, v in pack.items()},
                         [a.float() for a in args]),
            want, _k7_work(pack, x, idx), iters=3)
    del pack, x, args
    return out


def _shapes_k7(g) -> dict:
    stats = {}
    base = dict(L=2, f=3072, Tmax=MAX_LEN + 1)
    for B, Kb, S, D in SHAPES_CROSS + SHAPES_K7_LONG:
        H = _heads_for(D)
        shape = dict(base, B=B, Kb=Kb, S=S, H=H, f=4 * H * D)
        for dtype in SHAPES_BOTH:
            stats.update(_shapes_k7_case(g, f"rows {B * Kb} L2 H{H} hd{D} Kb{Kb} S{S}", shape,
                                         D, (MAX_LEN,), dtype, _must_be_new(dtype, Kb, S)))
    for Tmax in SHAPES_TMAX:
        shape = dict(base, B=2, Kb=BEAM, S=908, H=12, Tmax=Tmax)
        indices = tuple(sorted({0, 2047, 2048, Tmax - 1}))
        for dtype in SHAPES_BOTH:
            stats.update(_shapes_k7_case(g, f"rows {2 * BEAM} L2 Tmax {Tmax}", shape, 64,
                                         indices, dtype))
    for H, hd in SHAPES_WIDTHS:
        shape = dict(K7_SHAPE, H=H, f=4 * H * hd)
        for dtype in SHAPES_BOTH:
            stats.update(_shapes_k7_case(g, f"rows {BATCH * BEAM} L6 d{H * hd} H{H} hd{hd}",
                                         shape, hd, (MAX_LEN,), dtype, must=True))
    return stats


def _shapes_k2(g) -> tuple:
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import topk_projection as k2

    N, Vp, vs = K2_SHAPE["N"], K2_SHAPE["Vp"], K2_SHAPE["vocab_size"]
    stats = {"K2": {}, "K2-q8": {}}
    for D in SHAPES_K2_D:
        w = torch.randn(Vp, D, generator=g, device="cuda") * D ** -0.5
        w[vs:] = 0
        q = ofa.quantize_output_proj({"embed_tokens": w})
        w8, scale = q["embed_tokens_q8"], q["embed_tokens_scale"]
        for dtype in SHAPES_BOTH:
            h = torch.randn(N, D, generator=g, device="cuda").to(dtype)
            wd = w.to(dtype)
            bf16 = dtype == torch.bfloat16
            if bf16 and not k2.proj_plan(N, D, 132, Vp)[2]:
                raise AssertionError(f"K2 D{D}: a phase-27 width must stream h")
            tag = f"N{N} Vp{Vp} D{D}"
            real = lambda o: (o[0][:, :vs], *o[1:])  # the -1e9 columns would set the tolerance
            outs = N * Vp * (h.element_size() + 8 / BLK_K2)  # logits, bmax and bsum
            stats["K2"][f"{tag} {str(dtype)[6:]}"] = _shape_case(
                "K2", tag, dtype, lambda: real(k2.project_with_stats(h, wd, vocab_size=vs)),
                lambda: real(k2.project_plain(h, wd, vocab_size=vs)),
                lambda: real(k2.project_plain(h.float(), wd.float(), vocab_size=vs)),
                {"K2.streamed": 1} if bf16 else {},
                _bound(_nbytes(h, wd) + outs, 2.0 * N * Vp * D), stats_from=1)
            stats["K2-q8"][f"{tag} {str(dtype)[6:]}"] = _shape_case(
                "K2-q8", tag, dtype,
                lambda: real(k2.project_with_stats(h, w8, scale, vocab_size=vs)),
                lambda: real(k2.project_plain(h, w8, scale, vocab_size=vs)),
                lambda: real(k2.project_plain(h.float(), w8, scale, vocab_size=vs)),
                {"K2-q8.streamed_q8": 1} if bf16 else {},
                _bound(_nbytes(h, w8, scale) + outs, 2.0 * N * Vp * D), stats_from=1)
            del h, wd
        del w, w8, scale, q
        torch.cuda.empty_cache()
    return stats["K2"], stats["K2-q8"]


def _gen_search(tree, smi: str, flags: str) -> dict:
    """Best-of-24 image generation (``ImageGenTask(sampling_times=24)``, 256
    codes) on two captions under serving ``flags``' options: fp32 beam search
    at beam 24 through the kernels and their plain versions (equal codes);
    bf16 best-of-24 sampling, counted (K6/K7 at beam tiles) and timed."""
    import numpy as np

    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.data import collate
    from musketeer_tpu_torch.models import ofa
    from musketeer_tpu_torch.ops import decode_cross_attn as k6
    from musketeer_tpu_torch.ops import decode_stack as k7
    from musketeer_tpu_torch.ops import flash_attention_infer as k1
    from musketeer_tpu_torch.params import from_jax
    from musketeer_tpu_torch.tasks.image_gen import ImageGenTask
    from musketeer_tpu_torch.tokenization import default_vocab

    attn_module = importlib.import_module("musketeer_tpu_torch.ops.flash_attention_bwd")
    vocab = default_vocab()
    task = ImageGenTask(vocab, description="base", sampling_times=GEN_BEST_OF)
    b = task.builder("valid")
    rows = _gen_rows(GEN_PROMPTS, 256, np.random.RandomState(SEED + 27))
    src = torch.from_numpy(collate([b(r) for r in rows], pad_id=vocab.pad)["src_tokens"])
    src = src.to("cuda").long()
    model = SLICES[flags]["model"]
    gen = dataclasses.replace(task.generation_config(), **SLICES[flags]["gen"])
    kernel = "K6" if flags == "serving A" else "K7"
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(ofa_base(), dtype=dtype, use_flash_attention=True, **model)
        params = from_jax(tree, cfg, "cuda", getattr(torch, dtype))
        gen_cfg = gen if dtype == "bfloat16" else dataclasses.replace(gen, sampling=False)
        rng = lambda: torch.Generator(device="cuda").manual_seed(SEED + 27)

        def run():
            with mock.patch.object(task, "generation_config", lambda: gen_cfg):
                return task.generate_codes(params, cfg, src, rng=rng())

        _reset_counters()
        before = _route_counts()
        with mock.patch.object(ofa, "decode_step", wraps=ofa.decode_step) as steps:
            if dtype == "bfloat16":  # the counted run also gives the device time
                dev_ms, (codes, scores) = _device_ms_once(run)
            else:
                codes, scores = run()
        torch.cuda.synchronize()
        launches, moved = _counters(), _route_moves(before)
        n = steps.call_count
        per_step = cfg.decoder_layers if kernel == "K6" else 1
        want = {f"{kernel}.beam_tiled": per_step * n}
        if (launches[kernel] != per_step * n or moved != want
                or launches["K1"] != cfg.encoder_layers):
            raise AssertionError(f"image_gen {flags} {dtype}: launches {launches}, routes {moved} "
                                 f"over {n} steps (expected {kernel} {per_step} a step on beam "
                                 "tiles)")
        grid = task.code_image_size // 16
        if (tuple(codes.shape) != (GEN_PROMPTS, GEN_BEST_OF, grid, grid)
                or not bool(torch.isfinite(scores).all())):
            raise AssertionError(f"image_gen {flags}: codes {tuple(codes.shape)}, scores finite "
                                 f"{bool(torch.isfinite(scores).all())}")
        tag = f"[shapes b] image_gen best-of-{GEN_BEST_OF} {flags} {dtype}"
        if dtype == "float32":
            with mock.patch.object(attn_module, "flash_attention_inference",
                                   k1.flash_attention_plain), \
                    mock.patch.object(ofa, "decode_cross_attention_int8",
                                      k6.decode_cross_attention_int8_plain), \
                    mock.patch.object(ofa, "decode_stack_step", k7.decode_stack_plain):
                codes_p, scores_p = run()
            gap = _max_err(scores, scores_p)
            lim = FP32_TOL * max(1.0, float(scores_p.abs().max()))
            log(f"{tag} beam search (sampling off), {n} steps: codes equal to plain's "
                f"{torch.equal(codes, codes_p)}, max score diff {gap:.3e} (tol {lim:.3e}); "
                f"distinct codes in each prompt's best {[len(c.unique()) for c in codes[:, 0]]}")
            if not torch.equal(codes, codes_p) or not gap <= lim:
                raise AssertionError(f"image_gen {flags} fp32: the kernels' codes or scores "
                                     f"differ from the plain versions'")
        else:
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            p50 = statistics.median(times)
            log(f"{tag} sampling, {n} steps: {kernel} launches {launches[kernel]}; p50 "
                f"{p50 * 1e3:.1f} ms (runs {[round(t * 1e3, 1) for t in times]} ms), device "
                f"time {dev_ms:.1f} ms, {GEN_PROMPTS * GEN_BEST_OF / p50:.2f} images' codes/s "
                f"on {smi}")
            out = dict(launches={kernel: launches[kernel], "K1": launches["K1"]}, steps=n,
                       p50_ms=p50 * 1e3, device_ms=dev_ms)
        del params
        torch.cuda.empty_cache()
    return out


def _device_ms_once(fn) -> tuple:
    """(the device time (torch.profiler) of the operations one call of ``fn``
    launches, the call's result). Device activity only: over a 257-step
    search, the host operations' events would take the profiler tens of
    seconds to gather."""
    from torch.profiler import ProfilerActivity

    out = []
    dev = _profiled_device_events(lambda: out.append(fn()), [ProfilerActivity.CUDA])
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3, out[-1]


def _shapes_captions(tree, smi: str) -> dict:
    """The three caption slices at 672² (S 1772), beam 16, batch 16 in bf16
    (phase 5/13's path: launches, p50, peak memory; one more run's device
    time) and fp32 at batch 2 through the kernels and their plain versions
    (phase 6's check); K6 and K7 on their score-chunked routes."""
    mod = sys.modules[__name__]
    model = dict(patch_image_size=SHAPES_IMAGE)
    launches = {}
    with mock.patch.object(mod, "IMAGE", SHAPES_IMAGE), mock.patch.object(mod, "BEAM", SHAPES_BEAM):
        for name in SLICES:
            before = _route_counts()
            launches[name] = phase_slice(tree, smi, name, model=model)
            moved = _route_moves(before)
            cfg, params, gen_cfg = _slice_setup(tree, name, "bfloat16", model)
            inputs = _inputs(BATCH, SEED)
            dev_ms, _ = _device_ms_once(lambda: _caption(params, cfg, gen_cfg, *inputs))
            log(f"[shapes b] {name} at {SHAPES_IMAGE}², beam {SHAPES_BEAM}: device time "
                f"{dev_ms:.2f} ms an encode + search (torch.profiler) on {smi}")
            del params
            for k in ("K6", "K7"):
                chunked = moved.get(f"{k}.chunked", 0)
                # phase_slice runs the path 5 times; the counters hold the counted run's launches
                if launches[name][k] and chunked != 5 * launches[name][k]:
                    raise AssertionError(f"{name} at {SHAPES_IMAGE}²: {k} launches must all take "
                                         f"the score-chunked route ({moved})")
            for part in ("K6.beam_tiled", "K7.beam_tiled", "K2.streamed", "K2-q8.streamed_q8"):
                if moved.get(part):
                    raise AssertionError(f"{name} at {SHAPES_IMAGE}²: unexpected route {part}")
        for name in SLICES:
            phase_exactness(tree, name, model)
    return launches


def phase_shapes(smi: str) -> dict:
    """Phase 27: (a) K6, K7, K2 and K2-q8 at the shapes past today's routes,
    bf16 and fp32, against their plain versions, their routes counted; (b)
    best-of-24 image generation under serving A and B, and the caption slices
    at 672². → {kernel: {case: stats}} and the paths' numbers."""
    from musketeer_tpu_torch.config import ofa_base

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 27)
    stats = {"K6": _shapes_k6(g)}
    torch.cuda.empty_cache()
    stats["K7"] = _shapes_k7(g)
    torch.cuda.empty_cache()
    stats["K2"], stats["K2-q8"] = _shapes_k2(g)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    log(f"[shapes a] the kernels at phase 27's shapes: {t1 - t0:.1f} s")
    tree = _random_model_tree(dataclasses.replace(ofa_base(), use_flash_attention=True),
                              SEED + 27)
    t2 = time.perf_counter()
    log(f"[shapes b] the seeded ofa_base tree in {t2 - t1:.1f} s")
    paths = {}
    for f in ("serving B", "serving A"):
        paths[f"image_gen {f}"] = _gen_search(tree, smi, f)
        log(f"[shapes b] image_gen under {f}'s flags in {time.perf_counter() - t2:.1f} s")
        t2 = time.perf_counter()
    captions = _shapes_captions(tree, smi)
    log(f"[shapes b] the {SHAPES_IMAGE}² captions in {time.perf_counter() - t2:.1f} s")
    launches = {"K1": captions["slice"]["K1"], "K2": captions["slice"]["K2"],
                "K2-q8": captions["serving A"]["K2-q8"], "K6": captions["serving A"]["K6"],
                "K7": captions["serving B"]["K7"]}
    log(f"[shapes b] image_gen and the {SHAPES_IMAGE}² captions: {time.perf_counter() - t1:.1f} s;"
        f" phase 27 in {time.perf_counter() - t0:.1f} s on {smi}")
    out = {k: dict(cases=v, caption_launches=launches[k]) for k, v in stats.items()}
    for k in ("K6", "K7"):
        path = paths["image_gen serving A" if k == "K6" else "image_gen serving B"]
        out[k]["image_gen_launches"] = path["launches"][k]
    log(SHAPES_TAG + json.dumps(out))
    return out


# phase 28: every head dim past 128 up to 256 (the instances 192 and 256: the
# bf16 attention core and K4 on the pair route, both column blocks of 128 in
# one CTA; K6's and K7's shallower rings, K7's q in shared memory), and
# ofa_base split into 4 heads of 192 and 3 of 256
WH_DIMS = (130, 136, 160, 192, 200, 256)  # 130: not a multiple of 8; 136, 200: not of 16 (K6)
WH_CONFIGS = {"ofa_base_hd192": dict(attention_heads=4),
              "ofa_base_hd256": dict(attention_heads=3)}
WH_TAG = "[wide heads kernels] "
# K6 and K7 at DP 256 past the whole row's fit (the score-chunked route): B, Kb, S
WH_CHUNKED = (2, 16, 1772)
# bf16 K4's fp32 drel: phase 7's FP32_TOL. Phase 26 held it to its fp32 calls'
# 1e-5; at DP 256 the tensor cores' fp32 sums over 512-deep scores (and 256-deep
# dP) put it 1.3e-5 of max|drel| from plain on an H100 (B2 H3 T=S=300), while
# the fp32 calls (FMA kernels) stay within 1e-5
WH_DREL_TOL = 1e-4
# K3/K4 at DP 256 on a causal case with a fully masked row, as phase 7's small cases
WH_K4_MASKED = {"causal, fully masked row": dict(shape=dict(B=2, H=2, T=70, S=70, D=256),
                                                 causal=True, masked_row=1)}


def _wide_counts() -> dict:
    """The launches of the routes past head dim 128: K1, K3, K4 and K5's bf16
    launches on the pair route (``.pair``), K6's and K7's launches on an
    instance past 128 (``.wide``); 0 where a tree lacks them."""
    from musketeer_tpu_torch.ops import decode_cross_attn as k6
    from musketeer_tpu_torch.ops import decode_stack as k7
    from musketeer_tpu_torch.ops import flash_attention as k5
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.ops import flash_attention_infer as k1

    fns = {"K1": k1.flash_attention_inference, "K3": kb.flash_attention_fwd,
           "K4": kb.flash_attention_bwd, "K5": k5.flash_attention_bias,
           "K5-cross": k5.flash_cross_attention}
    out = {f"{k}.pair": getattr(fn, "pair", 0) for k, fn in fns.items()}
    out["K6.wide"] = getattr(k6.decode_cross_attention_int8, "wide", 0)
    out["K7.wide"] = getattr(k7.decode_stack_step, "wide", 0)
    return out


def _wide_moves(before: dict) -> dict:
    return {k: n - before[k] for k, n in _wide_counts().items() if n != before[k]}


def _wide_heads_for(D: int, width: int = 768) -> int:
    """``_heads_for``, or where no head count near ``width`` makes a multiple of
    64, the nearest whose width is a multiple of 8 (K7's ragged products)."""
    try:
        return _heads_for(D, width)
    except ValueError:
        return min((h for h in range(1, 2 * width // D + 2) if h * D % 8 == 0),
                   key=lambda h: (abs(h * D - width), h))


def _wide_chunked(g, D: int = 256, H: int = 3, route: str = "wide") -> dict:
    """K6 and K7 at head dim D (by default DP 256, 3 heads), 16 beams and S
    1772, past the bf16 whole row's fit, in bf16 and fp32, against plain
    (``_shape_case``): the score-chunked route on the shallower ring (phase
    29: on the deep route, ``route`` "deep")."""
    from musketeer_tpu_torch.ops import decode_cross_attn as k6

    B, Kb, S = WH_CHUNKED
    counts = _deep_counts if route == "deep" else _wide_counts
    names = ("q", "k_i8", "v_i8", "k_scale", "v_scale", "bias", "enc_pad")
    stats = {"K6": {}, "K7": {}}
    for dtype in SHAPES_BOTH:
        plan = k6.plan(Kb, S, D, fp32=dtype == torch.float32)
        want = {"K6.chunked": 1} if plan["chunk"] < S else {}
        if dtype == torch.bfloat16 and not want:
            raise AssertionError(f"K6 Kb{Kb} S{S} D{D}: bf16 must take the score-chunked route")
        x = _k6_inputs(g, B, H, Kb, S, D, dtype, full_pad=1)
        args = [x[n] for n in names]
        tag = f"B{B} H{H} Kb{Kb} S{S} D{D}"
        before = counts()
        stats["K6"][f"{tag} {str(dtype)[6:]}"] = _shape_case(
            "K6", tag, dtype, lambda: (k6.decode_cross_attention_int8(*args),),
            lambda: (k6.decode_cross_attention_int8_plain(*args),),
            lambda: (k6.decode_cross_attention_int8_plain(x["q"].float(), *args[1:]),),
            want, _bound(_nbytes(*args) + x["q"].numel() * x["q"].element_size(),
                         4.0 * B * H * Kb * S * D), iters=3)
        if counts()[f"K6.{route}"] - before[f"K6.{route}"] < 1:
            raise AssertionError(f"K6 {tag} {dtype}: must run on the {route} route")
        del x, args
        shape = dict(L=2, B=B, Kb=Kb, S=S, H=H, f=4 * H * D, Tmax=MAX_LEN + 1)
        before = counts()
        stats["K7"].update(_shapes_k7_case(g, f"rows {B * Kb} L2 H{H} hd{D} Kb{Kb} S{S}", shape,
                                           D, (MAX_LEN,), dtype, dtype == torch.bfloat16))
        if counts()[f"K7.{route}"] - before[f"K7.{route}"] < 1:
            raise AssertionError(f"K7 {tag} {dtype}: must run on the {route} route")
    return stats


def phase_wide_heads(smi: str) -> dict:
    """Phase 28: (a) the attention kernels at every head dim of ``WH_DIMS``
    (phase 26's calls at ~768 / D heads), the padded copies and the pair
    route counted, each bf16 K1, K3, K4, K5 call's plan beside its time
    (``_deep_plan_stats``), K6 and K7 on the score-chunked route and K4 on a
    causal fully masked row at 256; (b) the two configurations of ``WH_CONFIGS``;
    every fp32 call's check within ``HD_FP32_TOL``, bf16 K4's fp32 drel within
    ``WH_DREL_TOL``. → {kernel: {head dim: stats, its instance and the
    launches on its path}}."""
    module = sys.modules[__name__]
    with mock.patch.object(module, "FP32_TOL", HD_FP32_TOL), \
            mock.patch.object(module, "BF16_FP32_OUT_TOL", WH_DREL_TOL):
        return _wide_heads(smi)


def _wide_heads(smi: str) -> dict:
    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 28)
    heads = {name: ofa_base().embed_dim // m["attention_heads"] for name, m in WH_CONFIGS.items()}
    stats, k5_launches = {}, {}
    for D in WH_DIMS:
        t1, before, before_w = time.perf_counter(), _padded_counts(), _wide_counts()
        dp = _build.head_instance(D)
        if dp != (192 if D <= 192 else 256) or _build.col_halves(D) != 2:
            raise AssertionError(f"head dim {D}: instance {dp}, {_build.col_halves(D)} blocks")
        H = _wide_heads_for(D)
        stats[D], k5_launches[D] = _hd_kernels(g, D, D in heads.values(), H)
        _deep_plan_stats(D, H, BATCH if D in heads.values() else 4, stats[D])
        padded = {k: n - before[k] for k, n in _padded_counts().items()}
        unit = {k: 16 if k == "K6" else 8 for k in padded}
        if any((n > 0) != (D % unit[k] != 0) for k, n in padded.items()):
            raise AssertionError(f"head dim {D}: launches on zero-padded copies {padded}")
        wide = _wide_moves(before_w)
        if set(wide) != set(before_w) or min(wide.values()) < 1:
            raise AssertionError(f"head dim {D}: every kernel must take its route past 128, "
                                 f"moved {wide}")
        log(f"[wide heads a] D{D} on the instance {dp} in {time.perf_counter() - t1:.1f} s; "
            f"launches on zero-padded copies {padded}, past 128 {wide}")
        torch.cuda.empty_cache()
    before = _wide_counts()
    phase_k3_k4(g, {}, WH_K4_MASKED, saved=False)
    if _wide_moves(before).get("K4.pair", 0) < 1:
        raise AssertionError("K4's fully masked causal case must run on the pair route")
    chunked = _wide_chunked(g)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    log(f"[wide heads a] the kernels at head dims {WH_DIMS}: {t2 - t0:.1f} s")
    on_path = {}
    for name, model in WH_CONFIGS.items():
        before = _wide_counts()
        on_path[heads[name]] = _hd_config(name, model, smi, phase=28)
        wide = _wide_moves(before)
        if any(wide.get(k, 0) < 1 for k in ("K1.pair", "K3.pair", "K4.pair", "K6.wide",
                                             "K7.wide")):
            raise AssertionError(f"{name}: the paths must run K1, K3, K4 on the pair route and "
                                 f"K6, K7 past 128, moved {wide}")
        log(f"[wide heads b] {name}: launches past 128 {wide}")
    log(f"[wide heads b] both configurations: {time.perf_counter() - t2:.1f} s; phase 28 in "
        f"{time.perf_counter() - t0:.1f} s on {smi}")
    out = {}
    for k in HD_KERNELS:
        out[k] = {}
        for D in WH_DIMS:
            n = k5_launches[D][k] if k in ("K5", "K5-cross") else on_path.get(D, {}).get(k, 0)
            out[k][str(D)] = dict(stats[D][k], launches=n, instance=_build.head_instance(D))
    for k, cases in chunked.items():
        for tag, c in cases.items():
            out[k][f"256 {tag}"] = dict(c, launches=0, instance=256)
    log(WH_TAG + json.dumps(out))
    return out


# phase 29: every head dim past 256 (the deep route: the head dim streamed
# through the products in chunks of 128, each output's columns in blocks of
# 128 over the grid), and ofa_base as 2 heads of 384 and 1 head of 768
DEEP_DIMS = (264, 300, 384, 520, 576, 768, 1280)  # 300: not a multiple of 8; 264, 520: of 16
DEEP_CONFIGS = {"ofa_base_hd384": dict(attention_heads=2),
                "ofa_base_hd768": dict(attention_heads=1)}
DEEP_TAG = "[deep heads kernels] "
DEEP_CHUNKED_D = 576  # K6 and K7 on the score-chunked route at absorbed MLA's q.k width
# K3/K4 on a causal case with a fully masked row on the deep route
DEEP_K4_MASKED = {"causal, fully masked row": dict(shape=dict(B=2, H=2, T=70, S=70, D=384),
                                                   causal=True, masked_row=1)}
DEEP_KERNELS = ("K1", "K3", "K4", "K5", "K5-cross", "K6", "K7")


def _deep_counts() -> dict:
    """The attention wrappers' launches on the deep route (``.deep``); 0 where
    a tree lacks it."""
    from musketeer_tpu_torch.ops import decode_cross_attn as k6
    from musketeer_tpu_torch.ops import decode_stack as k7
    from musketeer_tpu_torch.ops import flash_attention as k5
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.ops import flash_attention_infer as k1

    fns = {"K1": k1.flash_attention_inference, "K3": kb.flash_attention_fwd,
           "K4": kb.flash_attention_bwd, "K5": k5.flash_attention_bias,
           "K5-cross": k5.flash_cross_attention, "K6": k6.decode_cross_attention_int8,
           "K7": k7.decode_stack_step}
    return {f"{k}.deep": getattr(fn, "deep", 0) for k, fn in fns.items()}


def _deep_moves(before: dict) -> dict:
    return {k: n - before[k] for k, n in _deep_counts().items() if n != before[k]}


def _sdpa_backend(D: int, H: int) -> str:
    """The fused backend scaled_dot_product_attention takes at K1's inputs of
    head dim D ([q|pos_q] 2 D wide, a float mask, scale 1), probed in
    PyTorch's order of preference; "none" where only the math path takes it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = torch.Generator(device="cuda").manual_seed(SEED)
    qc, kc, v, mask = _sdpa_inputs(_k1_inputs(g, 2, H, 130, 130, D, torch.bfloat16))
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]):
                torch.nn.functional.scaled_dot_product_attention(qc, kc, v, attn_mask=mask,
                                                                 scale=1.0)
            torch.cuda.synchronize()
            return name.lower()
        except RuntimeError:
            continue
    return "none"


def _one_block_ms(g, D: int, H: int) -> dict:
    """bf16 K1 and K4 at head dim D on the deep route (B4 T=S=908 and the
    encoder train shape B4 T=S=980, H heads): each kernel's device time
    (torch.profiler) and that time over the column blocks, what one block of
    128 output columns costs (a CTA's group of up to three blocks sharing
    each score tile)."""
    from musketeer_tpu_torch.ops import _build
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.ops import flash_attention_infer as k1

    names = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")
    nch = _build.col_halves(D)
    out = {}
    for kernel, T in (("K1", 908), ("K4", 980)):
        x = _k1_inputs(g, 4, H, T, T, D, torch.bfloat16)
        args = [x[n] for n in names]
        if kernel == "K1":
            call = lambda: k1.flash_attention_inference(*args)
        else:
            o, lse = kb.flash_attention_fwd_plain(*args)
            do = (torch.randn(o.shape, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
            call = lambda: kb.flash_attention_bwd(*args, o, lse, do)
        dev = sum(_device_ms_by_kernel(call, 5).values())
        out[kernel] = dict(device_ms=dev, blocks=nch, block_ms=dev / nch)
        log(f"[deep heads] {kernel} B4 H{H} T=S={T} D{D}: device {dev:.4f} ms in {nch} column "
            f"blocks, {dev / nch:.4f} ms a block")
        del x, args
    return out


def _deep_plan_stats(D: int, H: int, B: int, stats: dict) -> None:
    """The plan (``flash_attention_infer.deep_plan``) of bf16 K1, K3, K4, K5
    and K5-cross at phase 28 or 29 (a)'s shapes for head dim D (the pair
    route up to 256, else the deep route), printed beside each kernel's
    measured time (``stats[name]["ms"]``): the column blocks a CTA owns, the
    64-column boxes of the last chunk, how often each score tile is built
    (K4: S and dP; one block a CTA: the column-split design that ran head
    dims 129 to 256 before the pair route builds as often), the bytes
    the planner reckons the producers stream into shared memory, and the
    fill rate those bytes would imply over the measured time. The plan is a
    model of the kernel, not a count taken on the card, so it stays in the
    log and out of the kernels line."""
    from musketeer_tpu_torch.ops import flash_attention_infer as k1

    shapes = {"K1": ("K1", B, 908, 908), "K3": ("K1", 4, 980, 980), "K4": ("K4", 4, 980, 980),
              "K5": ("K5", B, 908, 908), "K5-cross": ("K5", 4, 90, 990)}
    for name, (kind, b, T, S) in shapes.items():
        p = k1.deep_plan(D, kind, B=b, H=H, T=T, S=S)
        ms = stats[name]["ms"]
        builds = (f"S {p['score_builds']}x, dP {p['dp_builds']}x (one block a CTA: S "
                  f"{p['score_builds_one_block']}x, dP {p['dp_builds_one_block']}x)"
                  if kind == "K4" else
                  f"{p['score_builds']}x (one block a CTA: {p['score_builds_one_block']}x)")
        fill = p["bytes"] / (ms * 1e-3) / 1e12
        log(f"[{p['route']} plan] {name} D{D} B{b} H{H} T{T} S{S}: {p['blocks']} column blocks a "
            f"CTA ({p['last_blocks']} in the last group of {p['nch']}; last chunk "
            f"{64 * p['last_boxes']} columns), each score tile built "
            f"{builds} a (q tile, key tile); {p['bytes'] / 1e9:.3f} GB streamed into shared "
            f"memory (one block a CTA: {p['bytes_one_block'] / 1e9:.3f}); kernel {ms:.4f} ms: "
            f"{fill:.2f} TB/s derived from the plan's bytes")


def phase_deep_heads(smi: str) -> dict:
    """Phase 29: (a) the attention kernels at every head dim of ``DEEP_DIMS``
    (phase 26's calls at ~768 / D heads), the padded copies and the deep route
    counted, each bf16 K1, K3, K4, K5 call's deep plan beside its time
    (``_deep_plan_stats``), K6 and K7 on the score-chunked route at 576 and
    K4 on a causal fully masked row at 384, each head dim's SDPA backend, one
    column block's device time at 384 and 768; (b) the two configurations of
    ``DEEP_CONFIGS``; every fp32 call's check within ``HD_FP32_TOL``, that of
    K1, K3, K4 and K5 against the function in fp64 (``FP32_REF_F64``), bf16
    K4's fp32 drel within ``WH_DREL_TOL``. → {kernel: {head dim: stats, the
    route and the launches on its path}}."""
    module = sys.modules[__name__]
    with mock.patch.object(module, "FP32_TOL", HD_FP32_TOL), \
            mock.patch.object(module, "BF16_FP32_OUT_TOL", WH_DREL_TOL), \
            mock.patch.object(module, "FP32_REF_F64", True):
        return _deep_heads(smi)


def _deep_heads(smi: str) -> dict:
    from musketeer_tpu_torch.config import ofa_base
    from musketeer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 290)
    heads = {name: ofa_base().embed_dim // m["attention_heads"]
             for name, m in DEEP_CONFIGS.items()}
    stats, k5_launches, backends = {}, {}, {}
    for D in DEEP_DIMS:
        t1, before, before_d = time.perf_counter(), _padded_counts(), _deep_counts()
        if _build.head_instance(D) != _build.DEEP or _build.col_halves(D) != -(-D // 128):
            raise AssertionError(f"head dim {D}: instance {_build.head_instance(D)}, "
                                 f"{_build.col_halves(D)} blocks")
        H = _wide_heads_for(D)
        stats[D], k5_launches[D] = _hd_kernels(g, D, D in heads.values(), H)
        _deep_plan_stats(D, H, BATCH if D in heads.values() else 4, stats[D])
        backends[D] = _sdpa_backend(D, H)
        if backends[D] == "none":  # no fused library kernel takes this head dim
            for k in ("K1", "K3", "K4", "K5", "K5-cross"):
                stats[D][k]["library_ms"] = None
        padded = {k: n - before[k] for k, n in _padded_counts().items()}
        unit = {k: 16 if k == "K6" else 8 for k in padded}
        if any((n > 0) != (D % unit[k] != 0) for k, n in padded.items()):
            raise AssertionError(f"head dim {D}: launches on zero-padded copies {padded}")
        deep = _deep_moves(before_d)
        if set(deep) != set(before_d) or min(deep.values()) < 1:
            raise AssertionError(f"head dim {D}: every kernel must take the deep route, "
                                 f"moved {deep}")
        log(f"[deep heads a] D{D} ({H} heads, {_build.col_halves(D)} column blocks) in "
            f"{time.perf_counter() - t1:.1f} s; launches on zero-padded copies {padded}, on the "
            f"deep route {deep}; SDPA's fused backend: {backends[D]}")
        torch.cuda.empty_cache()
    before = _deep_counts()
    phase_k3_k4(g, {}, DEEP_K4_MASKED, saved=False)
    if _deep_moves(before).get("K4.deep", 0) < 2:
        raise AssertionError("K4's fully masked causal case must run on the deep route")
    before = _deep_counts()
    chunked = _wide_chunked(g, DEEP_CHUNKED_D, 1, "deep")
    if any(_deep_moves(before).get(f"{k}.deep", 0) < 2 for k in ("K6", "K7")):
        raise AssertionError("K6 and K7's score-chunked cases must run on the deep route")
    blocks = {D: _one_block_ms(g, D, _wide_heads_for(D)) for D in (384, 768)}
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    log(f"[deep heads a] the kernels at head dims {DEEP_DIMS}: {t2 - t0:.1f} s")
    on_path = {}
    for name, model in DEEP_CONFIGS.items():
        before = _deep_counts()
        on_path[heads[name]] = _hd_config(name, model, smi, phase=29)
        deep = _deep_moves(before)
        if any(deep.get(f"{k}.deep", 0) < 1 for k in ("K1", "K3", "K4", "K6", "K7")):
            raise AssertionError(f"{name}: the paths must run K1, K3, K4, K6 and K7 on the "
                                 f"deep route, moved {deep}")
        log(f"[deep heads b] {name}: launches on the deep route {deep}")
    log(f"[deep heads b] both configurations: {time.perf_counter() - t2:.1f} s; phase 29 in "
        f"{time.perf_counter() - t0:.1f} s on {smi}")
    out = {}
    for k in DEEP_KERNELS:
        out[k] = {}
        for D in DEEP_DIMS:
            n = k5_launches[D][k] if k in ("K5", "K5-cross") else on_path.get(D, {}).get(k, 0)
            out[k][str(D)] = dict(stats[D][k], launches=n, instance="deep",
                                  blocks=_build.col_halves(D))
            if k not in ("K6", "K7"):  # SDPA's fused backend at this head dim, or "none"
                out[k][str(D)]["library_backend"] = backends[D]
            if k in ("K1", "K4") and D in blocks:
                out[k][str(D)]["one_block"] = blocks[D][k]
    for k, cases in chunked.items():
        for tag, c in cases.items():
            out[k][f"{DEEP_CHUNKED_D} {tag}"] = dict(c, launches=0, instance="deep")
    log(DEEP_TAG + json.dumps(out))
    return out


# --instances-only: the device times of today's instances, for a parent/change
# pair (copied into an older tree's root, it times that tree's kernels): K1,
# K4, K6 and K7 at ofa_base's shapes (head dim 64), K1, K3, K4, K5, K6, K7
# at 6 heads of 128 (phase 26's hd 128 cases), K1, K3, K4, K5, K6, K7 at 3
# heads of 256 (the widest instance) and K1, K3, K4, K5 at 4 heads of 192
# (the pair route's two instances), and K1, K3, K4, K5 on the deep route at 2
# heads of 384 and 1 head of 768 (phase 29's shapes), bf16
INSTANCE_CASES = {
    "K1 B16 H12 T=S=908 D64": ("K1", dict(K1_SHAPE)),
    "K4 B4 H12 T=S=980 D64": ("K4", dict(K34_SHAPES["encoder"]["shape"])),
    "K6 B16 H12 Kb5 S908 D64": ("K6", dict(K6_SHAPE)),
    "K7 rows 80 L6 d768 hd64 S908 Tmax17": ("K7", dict(K7_SHAPE, hd=64)),
    "K1 B16 H6 T=S=908 D128": ("K1", dict(K1_SHAPE, H=6, D=128)),
    "K3 B4 H6 T=S=980 D128": ("K3", dict(K34_SHAPES["encoder"]["shape"], H=6, D=128)),
    "K4 B4 H6 T=S=980 D128": ("K4", dict(K34_SHAPES["encoder"]["shape"], H=6, D=128)),
    "K5 B16 H6 S908 D128": ("K5", dict(K1_SHAPE, H=6, D=128)),
    "K6 B16 H6 Kb5 S908 D128": ("K6", dict(K6_SHAPE, H=6, D=128)),
    "K7 rows 80 L6 d768 hd128 S908 Tmax17": ("K7", dict(K7_SHAPE, H=6, hd=128)),
    "K1 B16 H3 T=S=908 D256": ("K1", dict(K1_SHAPE, H=3, D=256)),
    "K3 B4 H3 T=S=980 D256": ("K3", dict(K34_SHAPES["encoder"]["shape"], H=3, D=256)),
    "K4 B4 H3 T=S=980 D256": ("K4", dict(K34_SHAPES["encoder"]["shape"], H=3, D=256)),
    "K5 B16 H3 S908 D256": ("K5", dict(K1_SHAPE, H=3, D=256)),
    "K6 B16 H3 Kb5 S908 D256": ("K6", dict(K6_SHAPE, H=3, D=256)),
    "K7 rows 80 L6 d768 hd256 S908 Tmax17": ("K7", dict(K7_SHAPE, H=3, hd=256)),
    "K1 B16 H4 T=S=908 D192": ("K1", dict(K1_SHAPE, H=4, D=192)),
    "K3 B4 H4 T=S=980 D192": ("K3", dict(K34_SHAPES["encoder"]["shape"], H=4, D=192)),
    "K4 B4 H4 T=S=980 D192": ("K4", dict(K34_SHAPES["encoder"]["shape"], H=4, D=192)),
    "K5 B16 H4 S908 D192": ("K5", dict(K1_SHAPE, H=4, D=192)),
    "K1 B16 H2 T=S=908 D384": ("K1", dict(K1_SHAPE, H=2, D=384)),
    "K3 B4 H2 T=S=980 D384": ("K3", dict(K34_SHAPES["encoder"]["shape"], H=2, D=384)),
    "K4 B4 H2 T=S=980 D384": ("K4", dict(K34_SHAPES["encoder"]["shape"], H=2, D=384)),
    "K5 B16 H2 S908 D384": ("K5", dict(K1_SHAPE, H=2, D=384)),
    "K1 B16 H1 T=S=908 D768": ("K1", dict(K1_SHAPE, H=1, D=768)),
    "K3 B4 H1 T=S=980 D768": ("K3", dict(K34_SHAPES["encoder"]["shape"], H=1, D=768)),
    "K4 B4 H1 T=S=980 D768": ("K4", dict(K34_SHAPES["encoder"]["shape"], H=1, D=768)),
    "K5 B16 H1 S908 D768": ("K5", dict(K1_SHAPE, H=1, D=768)),
}
INSTANCES_TAG = "[instances] "


def _instance_call(g, kernel: str, shape: dict):
    """One bf16 call of ``kernel`` at ``shape`` on seeded inputs, as a closure."""
    from musketeer_tpu_torch.ops import decode_cross_attn as k6
    from musketeer_tpu_torch.ops import decode_stack as k7
    from musketeer_tpu_torch.ops import flash_attention as k5
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb
    from musketeer_tpu_torch.ops import flash_attention_infer as k1

    names = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")
    if kernel == "K6":
        x = _k6_inputs(g, **shape, dtype=torch.bfloat16, full_pad=1)
        args = [x[n] for n in ("q", "k_i8", "v_i8", "k_scale", "v_scale", "bias", "enc_pad")]
        return lambda: k6.decode_cross_attention_int8(*args)
    if kernel == "K7":
        hd = shape.pop("hd")
        pack, x = _k7_inputs(g, **shape, dtype=torch.bfloat16, hd=hd)
        args = [x[n] for n in ("x0", "sbias", "cbias", "self_k", "self_v", "cross_k", "cross_v")]
        return lambda: k7.decode_stack_step(pack, *args, K7_INDICES[-1], beam_size=BEAM,
                                            scaling=(hd * 2.0) ** -0.5)
    x = _k1_inputs(g, **shape, dtype=torch.bfloat16)
    args = [x[n] for n in names]
    if kernel == "K1":
        return lambda: k1.flash_attention_inference(*args)
    if kernel == "K3":
        return lambda: kb.flash_attention_fwd(*args)
    if kernel == "K5":
        return lambda: k5.flash_attention_bias(*args)
    o, lse = kb.flash_attention_fwd_plain(*args)
    do = (torch.randn(o.shape, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    return lambda: kb.flash_attention_bwd(*args, o, lse, do)


def _deep_drel(D: int = 1280, H: int = 1) -> dict:
    """bf16 K4's drel at head dim D (B4 H T=S=980, rel, 10 % padded keys;
    one seeded input, the same in any tree) against its plain version: the
    largest error and that over max|drel| (phases 28 and 29 hold it to
    ``WH_DREL_TOL``), so that a parent/change pair compares the sum order of
    the route past 128 that D takes."""
    from musketeer_tpu_torch.ops import flash_attention_bwd as kb

    g = torch.Generator(device="cuda").manual_seed(D)
    x = _k1_inputs(g, 4, H, 980, 980, D, torch.bfloat16)
    args = [x[n] for n in ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")]
    o, lse = kb.flash_attention_fwd_plain(*args)
    do = (torch.randn(o.shape, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    got = kb.flash_attention_bwd(*args, o, lse, do)[5]
    ref = kb.flash_attention_bwd_plain(*args, o, lse, do)[5]
    err, top = _max_err(got, ref), float(ref.abs().max())
    log(f"[instances] K4 B4 H{H} T=S=980 D{D} bf16 drel: max abs err {err:.4e} against plain, "
        f"max|drel| {top:.3f}: {err / top:.3e} of it")
    return dict(max_abs_err=err, max_abs=top, relative=err / top)


def phase_instances(smi: str, cases=None) -> dict:
    """Each case of ``INSTANCE_CASES``: its kernels' device time per call
    (torch.profiler, the sum over the call's kernels, 10 calls) and the
    call's time by CUDA events (20 calls); then bf16 K4's drel at 256 and
    1280 against plain (``_deep_drel``), printed as one ``INSTANCES_TAG``
    line. ``cases`` (names of ``INSTANCE_CASES``) times only those, in that
    order, drawing their inputs from the same seeded generator, and skips
    drel: a case alone in its process, or after chosen others."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    out = {}

    def timed(key, call):
        dev = sum(_device_ms_by_kernel(call, 10).values())
        ms = cuda_ms(call, 20)
        out[key] = dict(device_ms=dev, ms=ms)
        log(f"[instances] {key}: device {dev:.4f} ms, call {ms:.4f} ms per call on {smi}")

    for name in cases or INSTANCE_CASES:
        kernel, shape = INSTANCE_CASES[name]
        timed(name, _instance_call(g, kernel, dict(shape)))
        torch.cuda.empty_cache()
    if not cases:
        out["K4 D256 drel"] = _deep_drel(256, 3)
        out["K4 D1280 drel"] = _deep_drel()
    log(INSTANCES_TAG + json.dumps(out))
    return out


def _check_today_routes() -> None:
    """Phases 4, 10, 11 and 12 (K2, K2-q8, K6, K7 at today's shapes) ran the
    routes they ran before phase 27's: no beam tiles, score or cache chunks,
    ragged widths or streamed h; and phases 3-12 none of phase 28's routes
    past head dim 128 (column halves, shallower rings) and none of phase 29's
    deep route."""
    moved = {k: n for k, n in _route_counts().items() if n}
    moved.update({k: n for k, n in _wide_counts().items() if n})
    moved.update({k: n for k, n in _deep_counts().items() if n})
    if moved:
        raise AssertionError(f"phases 3-12: today's shapes took new routes {moved}")
    log("[routes] phases 3-12 ran today's routes (no beam tiles, score or cache chunks, ragged "
        "widths, streamed h, column halves or rings past head dim 128)")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--train-only", action="store_true",
                      help="after phases 1-2, run only phase 8 with its profiled step, and print "
                           "no result line")
    only.add_argument("--decode-only", action="store_true",
                      help="after phases 1-2, run only phases 4, 10, 11 and 12 (K2, K2-q8, "
                           "K6, K7), the three caption slices (5, 13) and their profile (15), "
                           "and print no result line")
    only.add_argument("--k8-only", action="store_true",
                      help="after phases 1-2, run only phase 17 (K8's stage path, its checks "
                           "and times), and print no result line")
    only.add_argument("--eval-only", action="store_true",
                      help="after phases 1-2, run only phase 18 (the eval tasks, their "
                           "counters, times and fp32 exactness), and print no result line")
    only.add_argument("--xla-only", action="store_true",
                      help="after phases 1-2, run only phase 20 (the XLA attention branch, "
                           "the joint recipe with detection and pure_image, the options), "
                           "and print no result line")
    only.add_argument("--scst-only", action="store_true",
                      help="after phases 1-2, run only phase 21 (SCST, CLIP-SCST, vqgan-encode, "
                           "image_gen's evaluate and joint training, the fp32 gen_code search), "
                           "and print no result line")
    only.add_argument("--parallel-only", action="store_true",
                      help="after phases 1-2, run only phase 22 (the native reader, --remat "
                           "at ofa_large, the process-group path, MFU), and print no result line")
    only.add_argument("--multi-card", action="store_true",
                      help="after phases 1-2, run only phase 23 on four cards (the mesh's axes "
                           "over NCCL ranks), and print no result line")
    only.add_argument("--multi-axes-only", action="store_true",
                      help="after phases 1-2, run only phase 23 (c) on four cards (ofa_large at "
                           "the model, pipe and seq axes over NCCL ranks), and print no result "
                           "line")
    only.add_argument("--axes-only", action="store_true",
                      help="after phases 1-2, run only phase 24 (the model, pipe and seq axes "
                           "at size 1, a model rank's shard), and print no result line")
    only.add_argument("--huge-only", action="store_true",
                      help="after phases 1-2, run only phase 25 (ofa_huge: the kernels at head "
                           "dim 80, the caption and serving slices, a --remat training step), "
                           "and print no result line")
    only.add_argument("--k4-only", action="store_true",
                      help="after phases 1-2, run only K3/K4 at the encoder train shape at head "
                           "dims 64 and 80 (phase 7's and phase 25's calls, checked and timed), "
                           "and print no result line")
    only.add_argument("--head-dims-only", action="store_true",
                      help="after phases 1-2, run only phase 26 (the attention kernels at head "
                           "dims 8 to 128, ofa_base in 6 heads of 128 and in 24 of 32), and "
                           "print no result line")
    only.add_argument("--wide-heads-only", action="store_true",
                      help="after phases 1-2, run only phase 28 (the attention kernels at head "
                           "dims 130 to 256, ofa_base in 4 heads of 192 and in 3 of 256), and "
                           "print no result line")
    only.add_argument("--deep-heads-only", action="store_true",
                      help="after phases 1-2, run only phase 29 (the attention kernels at head "
                           "dims 264 to 1280 on the deep route, ofa_base in 2 heads of 384 and "
                           "in 1 of 768), and print no result line")
    only.add_argument("--instances-only", action="store_true",
                      help="after phases 1-2, only time today's instances (K1, K4, K6, K7 at "
                           "head dim 64, K1 and K3-K7 at 128 and 256, K1, K3, K4, K5 at 192) "
                           "and the deep route (K1, K3, K4, K5 at 2 heads of 384 and 1 "
                           "of 768; device time and call time) for a parent/change pair, and "
                           "print no result line")
    ap.add_argument("--case", action="append", choices=list(INSTANCE_CASES), metavar="NAME",
                    help="with --instances-only, time only this case (repeatable, in the order "
                         "given), and skip drel")
    only.add_argument("--shapes-only", action="store_true",
                      help="after phases 1-2, run only phase 27 (K6, K7, K2 and K2-q8 at more "
                           "than 16 beams, long encoder outputs and caches, ragged widths and "
                           "wide features; best-of-24 image generation, the captions at 672²), "
                           "and print no result line")
    only.add_argument("--entry-only", action="store_true",
                      help="after phases 1-2, run only phase 19 (the CLI's convert, train "
                           "with its resume, and evaluate on a NormFormer ofa_base), and print "
                           "no result line")
    opts = ap.parse_args(argv)
    if opts.case and not opts.instances_only:
        ap.error("--case goes with --instances-only")
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    if opts.huge_only:
        phase_huge(smi)
        log(f"[done] ofa_huge phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.k4_only:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        for shapes in (K34_SHAPES, HUGE_K34):
            phase_k3_k4(g, {"encoder": shapes["encoder"]}, {}, saved=False)
        log(f"[done] K3/K4 phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.head_dims_only:
        phase_head_dims(smi)
        log(f"[done] head-dims phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.shapes_only:
        phase_shapes(smi)
        log(f"[done] shapes phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.wide_heads_only:
        phase_wide_heads(smi)
        log(f"[done] wide-heads phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.deep_heads_only:
        phase_deep_heads(smi)
        log(f"[done] deep-heads phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.instances_only:
        phase_instances(smi, opts.case)
        log(f"[done] instances timed in {time.perf_counter() - t_start:.1f} s")
        return 0
    from musketeer_tpu_torch.config import ofa_base

    tree = _random_model_tree(dataclasses.replace(ofa_base(), use_flash_attention=True), SEED)
    if opts.train_only or opts.decode_only or opts.k8_only:
        routes = _sm90_routes()  # an older tree counts fewer tensor-core routes apart
        log(f"[routes] bf16 routes on the tensor cores, counted apart: {sorted(routes)}")
    if opts.train_only:
        phase_train(tree, smi, routes)
        return 0
    if opts.multi_card:
        phase_multi_card(smi)
        log(f"[done] multi-card phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.multi_axes_only:
        if torch.cuda.device_count() < MULTI_RANKS:
            raise RuntimeError(f"--multi-axes-only needs {MULTI_RANKS} cards, found "
                               f"{torch.cuda.device_count()}")
        _multi_axes(smi)
        log(f"[done] multi-card axes phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.parallel_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_parallel(smi, tmp)
        log(f"[done] parallel phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.axes_only:
        phase_axes(smi)
        log(f"[done] axes phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.entry_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_entry(smi, tmp)
        log(f"[done] entry-point phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.xla_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_xla(tree, smi, tmp)
        log(f"[done] XLA-branch phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.scst_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_scst(tree, smi, tmp)
        log(f"[done] SCST and image-generation phase passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.k8_only:
        phase_k8(torch.Generator(device="cuda").manual_seed(SEED), tree, smi, routes)
        log(f"[done] K8 phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.eval_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_eval(tree, smi, tmp)
        log(f"[done] eval phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if opts.decode_only:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        phase_k2(g, routes)
        phase_k2q8(g, routes)
        phase_k6(g, routes)
        phase_k7(g, routes)
        _check_today_routes()
        for name in SLICES:
            phase_slice(tree, smi, name, routes)
        phase_profile(tree)
        log(f"[done] decode phases passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    g = torch.Generator(device="cuda").manual_seed(SEED)
    stats = {"K1": phase_k1(g), "K2": phase_k2(g), "K2-q8": phase_k2q8(g), "K6": phase_k6(g),
             "K7": phase_k7(g)}
    _check_today_routes()
    launches = {name: phase_slice(tree, smi, name) for name in SLICES}
    for name in SLICES:
        phase_exactness(tree, name)
    stats.update(phase_k3_k4(g))
    train_launches, train_p50_ms = phase_train(tree, smi)
    phase_train_exactness(tree)
    phase_profile(tree)
    k5_stats, k5_launches = phase_k5(g)
    stats.update(k5_stats)
    _check_today_routes()  # phases 3-16
    stats["K8"], k8_launches = phase_k8(g, tree, smi)
    with tempfile.TemporaryDirectory() as tmp:
        eval_launches = phase_eval(tree, smi, tmp)
    entry_mfu = {}
    with tempfile.TemporaryDirectory() as tmp:
        entry_launches = phase_entry(smi, tmp, train_p50_ms, entry_mfu)
    with tempfile.TemporaryDirectory() as tmp:
        xla_launches = phase_xla(tree, smi, tmp)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scst_launches = phase_scst(tree, smi, tmp)
    log(f"[scst] phase 21 done in {time.perf_counter() - t0:.1f} s on {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        parallel = phase_parallel(smi, tmp, {"p50_ms": train_p50_ms}, entry_mfu)
    axes_launches = phase_axes(smi)
    huge_stats, huge_launches = _huge_in_own_process()
    head_dims = _phase_in_own_process(26, "--head-dims-only", HD_TAG)
    shapes = _phase_in_own_process(27, "--shapes-only", SHAPES_TAG)
    t0 = time.perf_counter()
    wide_heads = _phase_in_own_process(28, "--wide-heads-only", WH_TAG)
    log(f"[wide heads] phase 28 in its own process: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    deep_heads = _phase_in_own_process(29, "--deep-heads-only", DEEP_TAG)
    log(f"[deep heads] phase 29 in its own process: {time.perf_counter() - t0:.1f} s")
    for k, by_dim in (*wide_heads.items(), *deep_heads.items()):  # phases 28-29 join 26's
        head_dims[k].update(by_dim)

    # each kernel's launches on its main path
    on_path = {"K1": launches["slice"], "K2": launches["slice"], "K2-q8": launches["serving A"],
               "K3": train_launches, "K4": train_launches, "K5": k5_launches,
               "K5-cross": k5_launches, "K6": launches["serving A"], "K7": launches["serving B"],
               "K8": k8_launches}
    table = [
        ("K1", "flash_attention_inference", "flash_fwd_sm90.cuh", "flash_attention_infer.py:109"),
        ("K2", "project_with_stats", "topk_projection.cu", "topk_projection.py:95"),
        ("K2-q8", "project_with_stats_q8", "topk_projection.cu", "topk_projection.py:71"),
        ("K3", "flash_attention_fwd", "flash_fwd_sm90.cuh", "flash_attention_bwd.py:247"),
        ("K4", "flash_attention_bwd", "flash_bwd_sm90.cuh", "flash_attention_bwd.py:296"),
        ("K5", "flash_attention_bias", "flash_fwd_sm90.cuh", "flash_attention.py:154"),
        ("K5-cross", "flash_cross_attention", "flash_fwd_sm90.cuh", "flash_attention.py:112"),
        ("K6", "decode_cross_attention_int8", "decode_cross_attn.cu", "decode_cross_attn.py:71"),
        ("K7", "decode_stack_step", "decode_stack.cu", "decode_stack.py:384"),
        ("K8", "fused_bottleneck", "bottleneck_sm90.cuh", "bottleneck.py:191"),
    ]
    kernels = [dict(name=name, route="cuda", source=f"musketeer_tpu_torch/csrc/{src}",
                    replaces=f"musketeer_tpu/ops/{tpu}", launches=on_path[k][k], **stats[k])
               for k, name, src, tpu in table]
    for entry, (k, *_) in zip(kernels, table):
        if k in ("K1", "K2"):  # the eval path's launches, task by task (phase 18)
            entry["eval_launches"] = {task: n[k] for task, n in eval_launches.items()}
        if k in ("K1", "K2", "K3", "K4"):  # the CLI's launches (phase 19), phase 20's
            entry["entry_launches"] = {run: n[k] for run, n in entry_launches.items()}
            entry["xla_phase_launches"] = {part: n[k] for part, n in xla_launches.items()}
        if k in ("K1", "K3", "K4"):  # phase 21's, part by part
            entry["scst_phase_launches"] = {part: n[k] for part, n in scst_launches.items()}
        if k in ("K3", "K4"):  # phase 22's ofa_large updates without and with --remat
            entry["remat_launches"] = {run: n[k] for run, n in parallel["remat"].items()}
        if k in ("K1", "K3", "K4"):  # phase 24's runs: the axes at size 1, a model shard
            entry["axes_launches"] = {run: n[k] for run, n in axes_launches.items()}
        if k in huge_stats:  # phase 25: ofa_huge, head dim 80 (K2, K2-q8: d 1280)
            entry["d1280" if k in ("K2", "K2-q8") else "hd80"] = dict(
                huge_stats[k], launches=huge_launches[k][k])
        if k in head_dims:  # phases 26, 28 and 29: by head dim, 8 to 1280
            entry["head_dims"] = head_dims[k]
        if k in shapes:  # phase 27: the routes past today's shapes
            entry["shapes"] = shapes[k]
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
