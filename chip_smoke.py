#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions, and the build of the hand-written kernels from
   ``paddle_tpu_torch/csrc`` (nvcc, sm_90a) with its time;
2. each kernel against its plain PyTorch version on the card, at the
   serving, generation and training paths' shapes, in bf16 and f32
   (K4 also at the training shape against one ``is_causal`` SDPA call,
   in bf16, f32 and fp16 (amp's O1 arm); the backward as the fused
   kernel K7, in bf16 and fp16 on wgmma and in f32 as 3xTF32; K7 also at
   Mistral's GQA width with its window; K4 and K7 also at GPT-2 345M's
   training shape, B = 16, S = 1,024, H = 16, D = 64, in bf16 against
   ``is_causal`` SDPA, K4 also at phase 19's generate forward (S = 543,
   partial tiles) and FusedMultiTransformer prefill (B = 8, S = 512,
   H = 32, D = 128), K5 also at its decode step (B = 8, H = HK = 32,
   S_max = 1,024, 513-576 live tokens); K1 also at the training path's
   4,096 rows, past the L2; K6 also at the packed width 2,048 and at phase
   8's f32 rows; the varlen backward in bf16 as the
   fused kernel K8 at the packed 941M row, with GQA and a window, with
   unequal query and key lengths, and with empty segments, in f32 as the
   fused 3xTF32 kernel at the packed row; K3 also at the packed 941M row
   (bf16 and f32) and
   with GQA and a window; K2's int8 arm with static (HK,) scales and with
   per-row scale pools at the serving shape and at GQA 32/8, and K2's
   static scales over float pools; K2 also over one sequence and one KV
   head of 4,096 tokens, K5 also at the generate run's own step, 4 rows
   of 4,096 live tokens; K4 also non-causal at phase 20's SD UNet
   attention, against one SDPA call each: self-attention at the 64 x 64
   latents (B = 2, S = 4,096, H = 5, D = 64), cross-attention there (Sk =
   77) and self-attention at the 8 x 8 level (S = 64, H = 20)): max
   error, kernel / plain /
   library-call device times (torch.profiler, summed kernel durations;
   CUDA events where the profiler records none, as ``timers`` says; where
   several library calls compute the same function the fastest counts,
   and ``library_call`` names it), the kernel's CUDA-event time over
   back-to-back calls (launch gaps included), the least time the card
   could take (``bound_ms``), its share of the kernel's time
   (``bound_share``) and the kernel's time over the library call's
   (``vs_library``);
3. the serving main path end to end: full Llama-2-7B in bf16 (32 layers,
   seeded random weights) through ``create_serving_engine``, 16 requests,
   the decode quantum as the engine's captured CUDA graph (each replay
   adds its capture's launches to the counters); launch counters zeroed
   just before and read just after; the same requests again with the
   sampling arm (top-k, top-p, temperature); then a torch.profiler
   breakdown of one mixed step and one replayed decode quantum, greedy
   and sampled;
4. the kernel path against the plain path end to end, at full width and
   4 layers in f32 (no argmax near-ties): greedy streams must be equal;
5. contiguous-cache generation end to end: full Mistral-7B in bf16 (32
   layers, seeded random weights) through ``LlamaForCausalLM.generate``,
   4 rows of 4,608-token prompts (the prefill band clips at the 4,096
   window and the decode buffer wraps) and 64 new tokens, the decode step
   a captured CUDA graph; launch counters zeroed just before and read
   just after; the same run with eager decode steps (equal streams, and
   every step's logits); then ``top_k=1`` sampling, whose stream must
   equal the greedy one (up to exact argmax ties), phase 13's generate
   half, and a torch.profiler breakdown of one prefill and one eager
   decode step;
6. generation's kernel path against its plain path (Mistral width, 4
   layers, f32, greedy streams equal), and one fixed-seed sampling
   serving run repeated (Llama-2-7B width, 4 layers: equal streams);
7. the training main path: Llama-2-7B width with 4 layers in bf16
   (bench.py's configuration: f32 master weights, bf16 AdamW moments,
   weight decay 0.01, no recompute, B=1, S=4,096, one seeded batch)
   through ``JittedTrainStep``: 2 warm-up steps, then 10 steps in one
   ``run_steps`` call with the launch counters zeroed just before and read
   just after (exactly K1 9, K4 4, K6 9, K7 4 per step), step
   time, tokens/s, MFU and peak memory; the loss must fall. Then the same
   configuration with ``fuse_linear_cross_entropy`` (its step-1 loss
   within bf16 rounding of the unfused one, its peak memory), and a
   torch.profiler breakdown of one unfused step;
8. the training kernel path against its plain path in f32 (Llama-2-7B
   width, 2 layers, S=1,024; the backward's f32 route, the fused f32 K7,
   exactly one launch per layer and backward, and never the bf16 K7):
   step-1 gradients per tensor within 1e-4 of the tensor's largest |g|,
   and the losses of 3 steps within 1e-4; each step's wall time, then
   one more step under the profiler;
9. packed (cu_seqlens) training, ``scripts/bench_suite.py``'s
   llama_941m_packed_varlen_train_mfu on the port: hidden 2,048, 16
   layers, 32 heads, bf16 with f32 masters and bf16 moments, one row of 8
   segments (T = 4,096), the model called as ``model(ids, cu)`` and the
   packed criterion on f32 logits: 2 warm-up steps, then 10 in one
   ``run_steps`` with the counters zeroed just before and read just after
   (exactly K1 33, K6 33, K3 16, K8 16 per step and no f32 K8, K4 or
   K7),
   step time, tokens/s, MFU (attention at the effective length
   sum(len^2) / T), peak memory and a step profile; the loss must fall.
   Then the same configuration with full recompute for 3 steps from the
   same weights and batches: its losses beside the first run's, a lower
   peak, and K1 65 and K3 32 launches per step;
10. packed training's kernel path against its plain path in f32 (the same
    width, 2 layers, T = 1,024 in 4 segments; the backward's f32 route,
    the fused f32 K8, exactly one launch per layer and backward, and never
    the bf16 K8): step-1 gradients per tensor within 1e-5 of the tensor's
    largest |g|, the losses of 3 steps within 1e-6; step walls and one
    profiled step, as in phase 8;
11. int8 serving at full width: Llama-2-7B in bf16 (32 layers, seeded
    weights), phase 3's knobs and requests, three engines through
    ``create_serving_engine``: ``quantize="weight_only_int8"`` (the entry
    point sweeps the model), the float engine over the dequantized
    weights (its greedy streams must be equal), and
    ``quantize="weight_only_int8", kv_dtype="int8"`` (the main path of
    K2's per-row mode: counters zeroed just before and read just after;
    it must launch K1, K3 and K2's per-row mode and no float K2). Per
    arm: tokens/s, peak memory, the pool's bytes in use after a fixed
    step, the float / int8 residency ratio, the int8-KV arm's token
    agreement with the weight-only arm; then profiles of its mixed step
    and replayed decode quantum, and of the w8 arm's quantum run eagerly
    with the weight dequantization as its own range (a replay runs no
    Python, so it has no such range);
12. int8 parity in f32 (Llama-2-7B width, 4 layers), kernel path against
    plain path: the weight-only int8 engine (equal greedy streams), the
    int8-KV engine (equal streams up to partings at near-ties, each a
    swap of the two best tokens: an f32 rounding difference can move a
    KV element to the neighbouring int8 value), and one
    ``block_multihead_attention`` mixed batch over int8 pools with static
    quant scales at the serving shape (8 slots, 128-token prefill chunks
    and decode rows), the path of K2's static int8 arm, and one decode
    step of 8 sequences through ``paged_decode_attention`` with (HK,)
    scales over f32 pools (the public op that applies such scales to any
    pool), the path of K2's static-scale mode over float pools: kernel
    path vs plain within f32 1e-4, equal pools. The two int8 engines
    record each step's two best tokens on the host, so the kernel and
    plain runs that compare them run their quantum eagerly; each engine
    also runs first on its kernel path as the card runs it, the quantum
    captured, and its streams must equal the eager kernel run's;
13. the decode graphs at full width (the card's name and power limit
    beside every timing). Serving: Llama-2-7B bf16 with phase 3's knobs
    and first 8 requests, the captured quantum against its eager body (greedy;
    sampled at fixed seeds), ``multi_quantum=4`` against 1 (equal streams
    and ``decode_quanta``), two engines driven dispatch, dispatch,
    collect, collect against ``step()``, and phase 11's w8kv8 engine
    captured against eager: streams equal token for token; then the
    decode dispatch's wall, host and device ms, busy share and replays,
    eager and captured, float and w8kv8. Generate (in phase 5, on its
    Mistral-7B): ``sampling_search`` captured against eager (equal
    streams), and greedy ``generate`` through its entry point, eagerly
    and as replays of the step it captured and kept: per decode step the
    stream's ms, the host's enqueue ms and the device ms, with its busy
    share;
14. the prefix cache at full width (run right after phase 3, on its
    Llama-2-7B bf16 model and knobs): a warm request (a 1,024-token
    system prompt + 96 tokens) runs to its first token, then 16 requests
    sharing the system prompt (32-256-token tails, 32-64 new tokens; two
    are the bare system prompt, one repeats the warm prompt), with
    ``prefix_cache=True`` and without, the quantum captured; the cached
    run's counters zeroed just before and read just after. Checks: hits
    and at least 2 copy-on-writes; the prefill tokens saved equal the
    cached tokens skipped (one short of a fully cached prompt); every
    copy made in place (no pool tensor moves, the copy holds its
    source's rows, the sources keep theirs to the end); the pool drains
    to scratch + cached blocks; the captured streams equal the eager
    body's; ``multi_quantum=4`` equals 1; an int8-KV arm's copies (scale
    rows included). Per arm: hits, misses, copies, evictions, prefill
    tokens, mixed steps, time to first token (median, max), tokens/s and
    wall; the mixed step of one hit row under torch.profiler; then, at
    Llama-2-7B width with 4 layers in f32, the cached engine's greedy
    streams against the unshared engine's (a parting passes only as a
    runner-up swap, as in phase 12);
15. speculative serving (run last on phase 3's Llama-2-7B bf16 model,
    after phase 14): a stand-in draft of one layer that shares the
    target's embedding, layer 0, final norm and lm head, the target's
    layers 1-31 with ``o_proj`` and ``down_proj`` scaled by 0.01
    (``scripts/bench_serving.py``'s ``_spec_pair``), and an independent
    seeded one-layer draft. (a) phase 3's requests and knobs through
    ``create_serving_engine(spec_draft=stand-in, spec_gamma=4)``, the
    round a captured CUDA graph, counters zeroed just before and read
    just after (the ``spec_serving`` path): wall, tokens/s, time to first
    token, acceptance, rounds, target forwards per token, peak memory,
    beside the plain engine on the same trace (bf16 greedy agreement)
    and the round's eager body (equal streams); (b) steady-state decode
    capacity, the reference row ``scripts/bench_serving.py:1367`` (γ = 8,
    8 live slots, block 32, max_context 1,792, 128-token prompts):
    interleaved windows of rounds and plain quanta, the median of 5 per
    draft, the round's wall, host and device ms, busy share, launches,
    profile, and the verify attention's products and gather split out of
    one eager round; (c) f32 at Llama-2-7B width with 4 layers: greedy
    speculative streams equal the plain engine's for both drafts, and
    sampling with the target as its own draft equals the plain sampling
    engine's with every proposal accepted. Both pools drain to their
    scratch block in every run;
16. the serving front door (run after phase 14 and before phase 15, on
    phase 3's Llama-2-7B bf16 model; each record beside the card's name
    and power limit): (a) phase 3's requests and knobs through
    ``inference.serve(policy=no_shed_policy(), trace=True)``, counters
    zeroed just before and read just after (the ``frontdoor`` path):
    streams and finish reasons equal the bare engine's on the same trace,
    then the same trace under ``run_async`` with ``async for`` consumers
    equals the sync run; (b) the observability overhead, the reference's
    ``slo_overhead`` / ``serving_obs_overhead`` rows at their TPU
    configuration (8 slots, block 32, quantum 16, 16-token prompts):
    steady-state decode dispatches with obs, the trace, the SLOs (evaluated
    after every dispatch) and the flight recorder on against
    ``obs="off"``, 5 interleaved windows of 2, the median ratio of
    tokens/s and of host ms a dispatch, and the synchronizing calls a
    dispatch in both arms, which must be equal (one event wait, no other
    sync); (c) overload, the reference's ``serving_overload`` row at its
    TPU configuration (8 slots, block 32, quantum 16, 96 requests, prompts
    log-uniform over 32-128 tokens, 16-64 new, its INTERACTIVE / NORMAL /
    BATCH mix): a capacity calibrated on a warm door, Poisson arrivals at
    3x it through a shedding door and a no-shed door (each warmed first),
    both drained to JSONL: time to first token by class, sheds by reason,
    preemptions, resumes, recomputed tokens, health, tokens/s; the
    journal and the Chrome trace validate, the attribution ledger
    conserves, a ``MetricsExporter`` on 127.0.0.1 answers ``/metrics``,
    ``/healthz`` and ``/slo`` during the shed arm, and the shed arm
    preempts; (d) recompute-on-resume under the captured quantum: 4 BATCH
    requests sharing a 96-token system prompt decode in the graph, 2
    INTERACTIVE arrivals preempt them, and in f32 at Llama-2-7B width with
    4 layers every stream equals the undisturbed engine's, with and
    without the prefix cache (bf16 on phase 3's model: agreement only);
17. resilience, crash recovery and the cluster (run after phase 16 and
    before phase 15, on phase 3's Llama-2-7B bf16 model and an f32 model
    of its width with 4 layers; replicas and restored engines share their
    model's weights; each record beside the card's name and power limit):
    (a) ``run_soak`` in f32 at 4 layers, rounds 50, seed 0, then its
    speculative arm with a 1-layer draft of the same width, rounds 60:
    the soak's own checks hold (non-poisoned streams equal the fault-free
    arm's, definite finish reasons, no leaked block); (b) phase 3's 16
    requests at 32 layers with ``resilience=True``, the prefix cache on
    and an injector plan (transient decode and mixed raises, an
    allocation failure, a poisoned request, a bit flip in a cached
    block), then the same prompts again: every request ends with a
    definite reason, the poisoned one with "error", the flip is
    quarantined, the pools drain, K1-K3 launch (counters zeroed just
    before the first wave, read just after: the ``resilience`` path); the
    streams' agreement with phase 3's is recorded; then steady decode
    dispatches of the default engine against ``resilience=True``: tokens/s
    and host ms a dispatch, the watchdog's deadline and trips, and one
    event wait and no other sync a dispatch in both arms, with the same
    launches a replay; (c) snapshot mid-run, drop the engine, restore,
    finish: f32 at 4 layers equal to the undisturbed run, bf16 at 32
    layers agreement recorded; (d) two replicas over phase 3's trace with
    two shared system prompts, a ``ClusterExporter`` scraped from a thread
    meanwhile: affinity hits, f32 streams equal a cluster of one's, and
    the prefill/decode hand-off's equal a single replica's; (e)
    ``python -m paddle_tpu_torch.obs check --device cuda`` as a
    subprocess exits 0.

18. LoRA fine-tuning of Llama-2-7B under amp (run after phase 13; every
    record beside the card's name and power limit): (a) the full 32-layer model
    built in f32 and ``amp.decorate``d to bf16 at O2, ``get_lora_model``
    (r = 8, alpha 16, q_proj / v_proj), AdamW over the adapters with
    ``multi_precision``, ``JittedTrainStep`` in
    ``InstrumentedTrainStep.for_transformer`` under ``auto_cast(O2,
    bf16)``, B = 1, S = 4,096, 2 + 10 steps: exact launches per step (K1
    65 and K6 64 in f32, rms_norm being black-listed; K4 and K7 32 in
    bf16), step time, tokens/s and MFU from the registry and from CUDA
    events, peak memory beside the full-parameter state, the loss falls,
    every frozen parameter bit-equal to its start, one profiled step; (d)
    ``merge`` then ``unmerge`` on (a)'s model: the fold bit-exact, unmerge
    within one bf16 ulp, merged logits against the adapted forward; (b)
    f32 without amp, 2 layers, S = 1,024: kernel path against plain path,
    step-1 adapter gradients and 3 losses within 1e-4; (c) an f32 model of
    4 layers, S = 4,096, under ``auto_cast(fp16)`` (O1) with
    ``GradScaler.minimize``: exactly 4 fp16 K4 and 4 fp16 K7 launches a
    step, the found-inf sequence and the scales (the reference's rule),
    skipped steps leave every parameter bit-equal.
19. the GPT-2 family and the incubate fused tier (run last; every record
    beside the card's name and power limit): (a) GPT-2 345M training,
    ``scripts/bench_suite.py``'s ``gpt2_jit`` recipe (B = 16, S = 1,024,
    D = 64, selective recompute, the fused lm-head + CE in 2,048-row
    chunks, bf16 parameters, f32 masters, bf16 AdamW moments), 1 + 5
    steps on one batch: exactly 36 K4 (24 and the 12 recomputed blocks')
    and 24 K7 launches a step, step ms, tokens/s, MFU, peak memory, the
    loss falls, one profiled step; (b) greedy ``generate`` on (a)'s
    model, 2 rows of 512-token prompts and 32 new tokens: 24 K4 a token,
    the kernel path's agreement with the plain path (where a row's
    streams part: the step, the plain path's top-2 margin there and the
    two paths' largest logit difference), the kernel path's logits over
    the longest forward within 2^-5 (relative L2) of the plain path's,
    and a 2-layer f32 model's kernel and plain streams equal; (c)
    ``FusedMultiTransformer`` at Llama-2-7B width (32 layers, swiglu,
    rmsnorm, bf16), 8 rows of 512-token prompts into 1,024-slot caches,
    then 64 decode steps: exactly 32 K4 and 64 K1 in the prefill, 32 K5
    and 64 K1 a decode step, prefill ms, decode ms a step, tokens/s, peak
    memory, the prefill's and the first 4 decode steps' outputs within
    2^-5 (relative L2) of the plain path's on the same inputs, one
    profiled decode step; (d) (c) after ``quantize_weight_only``: the int8 bytes,
    the casts' ms a call, decode ms a step with the same launches, the
    outputs within 5% (relative L2) of (c)'s; (e) f32 at two layers of
    (c)'s width with GQA 32 / 8: prefill, a chunked prefill and 8 decode
    steps with per-row lengths, the kernel path against the plain path,
    outputs and caches; (f) ``MoELayer`` at Mixtral-8x7B's layer width
    (GShard top-2, swiglu, bf16, 4,096 tokens): forward and backward in
    the einsum and grouped modes, their ms, the dropped assignments, and
    the two modes within 2^-5 of the largest value, at the layer's
    capacity factor 2 and at 0.5, where assignments are dropped.
    ``scripts/torch_gpt_phase.py`` runs this phase alone, after phase 2's
    cases at its shapes.
20. the vision tier (run last; every record beside the card's name and
    power limit): (a) the SD UNet at stable-diffusion-2-base's widths
    (block channels 320 / 640 / 1,280 / 1,280, 2 layers a block, heads of
    64, 1,024-wide context, 64 x 64 latents) through the reference's UNet
    architecture, seeded weights in bf16, batch 2, 77-token context, 20
    DDIM steps through ``ddim_sample``, whose whole loop is one captured
    CUDA graph: exactly 42 K4 launches a step (21 attention blocks, self
    and cross), the captured sampler's latents equal the eager sampler's
    bit for bit, the kernel path's latents within the bf16 / f32 gap of
    the plain path's (relative L2: the kernel path may part from the
    plain path by no more than bf16 itself parts from f32 on the same
    weights), ms a sample and a UNet step (CUDA events, median of 5), the
    eager sampler's, device ms, busy share and K4's share of one step by
    kernel family (convolutions, GroupNorm and LayerNorm passes, K4,
    products), one profiled replay; then in f32 at 1 layer a block, 3
    steps, the kernel path (K4's f32 arm) within 1e-4 of the plain path;
    (b) ResNet-50 at ``scripts/bench_suite.py``'s ``resnet50_eager``
    recipe (f32, batch 32, 224 x 224, CrossEntropyLoss, Momentum(0.1)):
    10 eager steps with the f32 convolutions in full f32 (this script
    turns cuDNN's TF32 off; images/s over the first 5), bn1's running
    statistics move by paddle's rule, one profiled step; 5 more with TF32
    on (torch's default) and their images/s; the run's last 5 losses each
    below its first; an eval forward in bf16 and its images/s. ``scripts/torch_vision_phase.py`` runs this phase alone,
    after phase 2's K4 cases at the UNet's shapes (self-attention at 64 x
    64, B = 2, S = 4,096, H = 5, D = 64; cross-attention there, Sk = 77;
    self-attention at 8 x 8, S = 64, H = 20; non-causal, against one
    SDPA call each).
21. BASELINE config #4 and its layer tier (run last; every record beside
    the card's name and power limit): (a) ERNIE-3.0 base
    (``ErnieConfig()``: 12 layers, hidden 768, 12 heads, FFN 3,072, vocab
    40,000) pretraining through the auto-parallel ``Engine`` by
    ``scripts/bench_suite.py``'s ``ernie_engine`` recipe at the model's
    full length (f32, dropout 0, AdamW(1e-4), labels on every 7th token,
    B = 16, S = 512): a cold and a warm ``fit`` epoch of 8 batches with
    TF32 off and one with TF32 on, ms a step (median by CUDA events),
    tokens/s, one profiled step by family (products, the plain f32
    attention, LayerNorm, the MLM log-softmax, AdamW), no K4 / K7 (the
    masked attention is plain, as the reference's), the warm epoch's last
    loss below the cold epoch's first, ``evaluate`` and ``predict`` on the
    card, ``save`` -> a new ``Engine``'s ``load`` evaluating equal, and
    the first step's loss within 1e-5 of the CPU's on the same weights
    (B = 1, S = 128); (b) ``nn.Transformer`` at its defaults (d_model
    512, 8 heads, 6 + 6 layers, FFN 2,048; dropout 0) in bf16, B = 16,
    source = target = 512 under the causal target mask: one train step
    with exactly 12 K4 and 12 K7 (the encoder's self- and the decoder's
    cross-attention), its loss and whole gradient within 2^-5 (relative
    L2) of the plain path's, each parameter's gradient within that or
    within bf16's own gap from the f32 plain step, and 32 cached decode
    steps (``Cache``, no mask:
    12 K4 a step at Sq = 1) against the plain path; (c) ``hapi.Model``
    with LeNet on synthetic 28 x 28 images: ``evaluate``, ``fit``,
    ``evaluate`` (accuracy and loss improve), ``save`` / ``load``; (d)
    T5-small (``T5Config()``, dropout 0) in f32, 5 train steps at B = 16,
    source 512, target 128: the loss falls, exactly 32 K1 and 32 K6 a
    step (its RMSNorms; its attention is plain). ``scripts/
    torch_bert_phase.py`` runs this phase alone, after phase 2's K4 / K7
    cases at nn.Transformer's shapes.
22. BASELINE config #3's hybrid-parallel tier on one card (``fleet_phase``,
    last): ``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node 1 --device cuda chip_smoke.py --fleet-worker OUT``
    starts one NCCL rank that trains phase 7's configuration (Llama-2-7B
    width, 4 layers, bf16, B = 1, S = 4,096, the same seed and batch)
    through ``fleet.init`` (dp = mp = pp = sharding = 1, stage-3
    sharding), the tensor-parallel build (``tensor_parallel=True``),
    ``distributed_model``, ``distributed_optimizer(AdamW)`` and
    ``JittedTrainStep(state_sharding_axis="sharding")``: every collective
    of the tier runs, at degree 1 (2 warm-up and 6 timed steps). Checks:
    the backend is nccl, every parameter and state tensor is on cuda:0
    and a stage-3 shard, one unit gathered at a time, exactly phase 7's
    launches a step (K1 9, K4 4, K6 9, K7 4), losses bit-equal to phase
    7's (same weights, batch and kernels; degree 1), a falling loss,
    the worker's exit code 0 and its result file read back. Emits step ms
    (median by CUDA events), tokens/s and MFU beside phase 7's, peak
    memory, the rank's parameter and optimizer bytes, and one step's
    device time by family with NCCL's kernels as a family of their own.
23. the Paddle tensor API tier (``tensor_api_phase``, last; every record
    beside the card's name and power limit): (a) every op of
    ``paddle_tpu_torch.tensor`` and ``linalg`` once on CUDA tensors
    against the same port function on a CPU copy computed in f64
    (elementwise, reduction and manipulation ops on (2, 2,048, 4,096) in
    bf16 and f32, the CPU computing the first 256 rows of the row-wise
    ones; sorts, searches and quantiles on (2, 512, 4,096); products at
    4,096, the CPU computing their first 256 rows; decompositions at 512
    in f32; creation ops on the card against the CPU): max |card - cpu|
    over max(1, max |cpu|) within ``TENSOR_API_TOL`` per dtype, integer
    and copied results exact; every random op drawn twice after one
    seed (equal) with its moments within 5 sigma; one record of the ops
    run, failures by name and the worst error per dtype; (b) BASELINE
    config #1 through the public API: ``scripts/bench_suite.py``'s
    ``resnet50_eager`` body with ``import paddle_tpu_torch as paddle``
    and ``float(loss)`` for its JAX-only sync, the weights carried into
    phase 20's direct-path model, cuDNN deterministic: three losses
    bit-equal to the direct path's, the same kernel launches a step
    under the profiler, images/s beside phase 20's; (c) a user-written
    ``paddle.nn.Layer`` (a SwiGLU MLP 4,096 -> 11,008 -> 4,096 from
    ``create_parameter`` and ``ParamAttr(initializer=)``, ``paddle.matmul``
    and ``paddle.mean``) trained three AdamW steps in bf16 on (2, 2,048,
    4,096): finite losses, and its first forward's first 64 rows within
    2^-5 (relative L2) of an f32 CPU run of the same weights.
    ``scripts/torch_tensor_api_phase.py`` runs this phase alone.
24. the static and deployment tier (``static_phase``, last; every record
    beside the card's name and power limit): (a) Llama-2-7B's widths
    (hidden 4,096, 32 heads, FFN 11,008, vocab 32,000) in bf16 at
    ``STATIC_LAYERS`` layers, ids (2, 512): ``torch._dynamo.explain``
    finds one graph and no break; ``jit.to_static`` (inductor) launches
    exactly the eager forward's K1 (2L + 1) and K4 (L), its logits within
    phase 2's bf16 tolerance (or 2^-5 relative L2) of eager's, the same
    compiled forward under ``plain_versions()`` launches nothing and
    agrees within 2^-5; ``loss.backward()`` through it launches K6 (2L +
    1) and K7 (L) with every gradient within 2^-5 of eager's; ``jit.save``
    with ``InputSpec([None, None], "int64")``, ``inference.Config`` and
    ``create_predictor``: the Predictor launches K1 and K4 as eager does
    and its logits hold to to_static's, also at a second shape; the
    compile-and-first-call wall, steady and eager calls (CUDA events),
    save and load walls; (b) ResNet-50 at ``resnet50_eager``'s batch (32,
    224 x 224, f32, eval) through ``jit.save`` with a dynamic batch and a
    Predictor, against the eager forward; the C API's client
    (``paddle_tpu_torch/csrc/capi/predict_client.c``, built with g++ on
    the card) runs the saved model from a second process, and its output
    and its clone's (a second thread) equal the Python Predictor's at the
    client's precision flags (torch's defaults) within f32's tolerance.
    ``scripts/torch_static_phase.py`` runs this phase alone.
25. the manifest tier (``manifest_phase``, last; every record beside the
    card's name and power limit): (a) K2 and K5 as custom ops in graphs,
    Llama-2-7B's widths in bf16 at ``STATIC_LAYERS`` layers: the
    contiguous-cache decode step (K5; 8 rows, a 1,024-token cache, at
    positions 512 and 1,023) and phase 3's engine's paged decode math
    over its pool (K2, float and w8kv8's per-row int8 mode; 8 rows of
    512-1,024 cached tokens), each through ``torch._dynamo.explain``
    (one graph, no break) and ``jit.to_static`` (inductor): launches as
    eager's, outputs within phase 2's bf16 bound or 2^-5 relative L2 of
    eager's and of the same compiled function under ``plain_versions()``
    (which launches nothing); ``jit.save`` and a Predictor of the K5 step
    (its caches buffers the program mutates), its logits against eager's;
    no eager K5 call and no eager or captured engine quantum through the
    dispatcher (profiler op events), phase 13's captured quantum beside
    the recorded one (``RECORDED_QUANTUM_MS``); (b)
    ``flash_attn_qkvpacked`` at (1, 4,096, 3, 32, 128), causal, bf16: K4
    and K7 once each, against ``plain_versions()`` at phase 2's bounds;
    (c) the large PTB LSTM of Zaremba et al. 2014 (2 x 1,500, vocabulary
    10,000, 35 steps, batch 20), f32: AdamW steps
    (dropout off) held against the port's CPU run of the same weights,
    timed steps with the paper's dropout 0.65; a bidirectional 2-layer
    GRU and a SimpleRNN forward at the same width against the CPU; (d)
    ``signal.stft`` / ``istft`` at Whisper's front end (8 x 30 s of 16
    kHz audio, n_fft 400, hop 160, Hann) and ``fft.rfft`` / ``fft2`` /
    ``irfftn`` on (8, 256, 256), against the CPU; (e) ``affine_grid`` +
    ``grid_sample`` at (32, 3, 224, 224) and ``unfold`` / ``fold`` at
    (8, 64, 56, 56) with a 3 x 3 kernel, forward and backward, against
    the CPU; (f) ``sparse.matmul`` of a (4,096, 4,096) COO matrix at 1%
    by (4,096, 512), forward and backward, against ``to_dense()`` and a
    product. f32 results within ``MANIFEST_F32_BOUND`` (max |card - cpu|
    over max |cpu|). ``scripts/torch_manifest_phase.py`` runs this phase
    alone.

The line before the last is the ``{"kernels": [...]}`` record (each
kernel's launches come from the run of the path that carries it: K1-K3
the serving run of phase 3, K4-K5 the generation run of phase 5, K6 and
K7 the training run of phase 7, the f32 K7 and K4 the f32 kernel run of
phase 8, K8 the packed training run of phase 9, the f32 K8 and K3 the f32
packed kernel run of phase 10, K2's per-row int8 mode the int8-KV serving run
of phase 11, its static int8 arm and its float-pool scaled mode the two
runs of phase 12; ``launches_by_path`` has every path's count, phase 14's
cached float and int8-KV runs, phase 16's ``frontdoor``, phase 17's
``resilience``, phase 15's ``spec_serving``, phase 18's ``lora`` and
``lora_fp16``, phase 19's ``gpt_train`` and ``fmt_decode`` and phase
20's ``sd_unet`` (one captured sample) and phase 21's
``ernie_engine``, ``transformer_train``, ``transformer_decode`` and
``t5_train``, phase 22's ``fleet``, phase 23's ``tensor_api`` (no
hand-written kernel: all zero), phase 24's ``static_train`` (the
to_static train step), ``static_predictor`` and ``static_resnet``,
phase 25's ``manifest_k5_step``, ``manifest_k5_predictor``,
``manifest_k2_float``, ``manifest_k2_w8kv8`` (the compiled calls, each
counted from zero) and ``manifest_qkvpacked`` among them; K4's and K7's fp16
arms take theirs from phase 18 (c));
the last
line is ``{"ok": true, "device": {...}}``.
Without CUDA it prints no result and exits 2.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12,    # f32 outside the tensor cores
              "tfloat32": 495e12}  # dense TF32 tensor-core rate
SEED = 0
# phase 5: rows, prompt tokens (past Mistral's 4,096 window), new tokens
GENERATE_SHAPE = (4, 4608, 64)
# phase 6: the same for the f32 kernel-vs-plain generate run
GENERATE_PARITY_SHAPE = (2, 4352, 16)
# phase 7: batch, sequence, warm-up steps, timed steps (one run_steps)
TRAIN_SHAPE = (1, 4096, 2, 10)
# phase 22: the fleet step's warm-up and timed steps (phase 7's batch and
# sequence)
FLEET_STEPS = (2, 6)
# phase 8: sequence and steps of the f32 kernel-vs-plain training run
TRAIN_PARITY_SHAPE = (1024, 3)
# phase 9: the packed row of scripts/bench_suite.py's 941M configuration
# (T = 4,096) and its steps: warm-up, timed (one run_steps), with recompute
PACKED_LENS = [1600, 800, 600, 400, 300, 200, 120, 76]
PACKED_TRAIN_STEPS = (2, 10, 3)
# phase 10: the f32 kernel-vs-plain packed run's segments and steps
PACKED_PARITY = ([500, 300, 150, 74], 3)
# phase 18: LoRA at Llama-2-7B: batch, sequence, warm-up steps, timed
# steps of (a); sequence and steps of (b)'s f32 parity; layers, sequence
# and steps of (c)'s fp16 GradScaler run
LORA_SHAPE = (1, 4096, 2, 10)
LORA_PARITY_SHAPE = (1024, 3)
LORA_FP16_SHAPE = (4, 4096, 16)
# phase 19 and phase 2's rows at its attention: GPT-2 345M training's
# attention (label, B, Sq, Sk, H, HK, D); (a)'s warm-up and timed steps;
# (b)'s rows, prompt and new tokens; (c)'s rows, prompt, max_length and
# decode steps; (e)'s prefill, chunk and decode steps; (f)'s tokens
GPT2_TRAIN_ATTN = ("gpt2_train", 16, 1024, 1024, 16, 16, 64)
GPT_TRAIN_STEPS = (1, 5)
GPT_GENERATE_SHAPE = (2, 512, 32)
FMT_SHAPE = (8, 512, 1024, 64)
# phase 2's rows at (b)'s and (c)'s attention: (b)'s longest forward
# (prompt + new - 1 tokens), (c)'s prefill, and (c)'s decode step as
# (label, S_max, lens, H, HK), the rows spread over the 64 steps' lengths
GPT2_GENERATE_ATTN = ("gpt2_generate", 2, 543, 543, 16, 16, 64)
FMT_PREFILL_ATTN = ("fmt_prefill", 8, 512, 512, 32, 32, 128)
FMT_DECODE_ATTN = ("fmt_decode", 1024, [513 + 9 * i for i in range(8)],
                   32, 32)
GPT_PHASE_LABELS = ("gpt2_train", "gpt2_generate", "fmt_prefill",
                    "fmt_decode")
# phase 20 and phase 2's rows at its attention: the SD UNet's K4 calls at
# stable-diffusion-2-base's widths, batch 2 (a classifier-free-guidance
# pair), non-causal (label, B, Sq, Sk, H, D): (a) self-attention at the
# 64 x 64 latents, (b) cross-attention there (77 text tokens: a partial
# key tile), (c) self-attention at the 8 x 8 level
UNET_SELF_ATTN = ("unet_self_64x64", 2, 4096, 4096, 5, 64)
UNET_CROSS_ATTN = ("unet_cross_64x64", 2, 4096, 77, 5, 64)
UNET_LOW_ATTN = ("unet_self_8x8", 2, 64, 64, 20, 64)
UNET_PHASE_LABELS = ("unet_",)
# (a): stable-diffusion-2-base's unet/config.json widths through the
# reference's UNet architecture; 20 DDIM steps (scripts/bench_suite.py's
# sd_unet count); timed samples; (a)'s f32 kernel-vs-plain run at
# layers_per_block=1 and its steps
SD_UNET_WIDTH = dict(block_out_channels=(320, 640, 1280, 1280),
                     layers_per_block=2, cross_attention_dim=1024,
                     attention_head_dim=64, norm_num_groups=32,
                     sample_size=64)
SD_BATCH, SD_CONTEXT, SD_STEPS, SD_TIMED = 2, 77, 20, 5
SD_F32_STEPS = 3
# (a)'s f32 bound: max |kernel - plain| over max |plain| latent after
# SD_F32_STEPS steps (K4's f32 arm is 3xTF32, ~f32; the convolutions are
# the same calls on both paths)
SD_F32_BOUND = 1e-4
# (b): scripts/bench_suite.py's resnet50_eager recipe: batch, image side,
# classes, steps (TF32 off, then on), learning rate
RESNET_SHAPE = (32, 224, 1000)
# (b)'s steps, one training run on one batch: 5 timed in f32, 5 more in
# f32, one profiled, 5 timed with TF32 on. At lr 0.1 with momentum and no
# warm-up the loss swings before it settles (on an H100: 7.67, 7.00,
# 11.89-11.99, 7.78-7.99, 8.94-9.28, then 9.25, 9.69-10.29, 7.15-7.86,
# 5.20-5.80, 5.24-8.38; cuDNN's backward sums in no fixed order, so runs
# part from step 2), so the loss is held at the run's end: each of the
# last 5 losses below the first
RESNET_STEPS = (5, 5, 5)
RESNET_LR = 0.1
# phase 21 and phase 2's rows at its attention: (a) BASELINE config #4,
# ERNIE-3.0 base through the auto-parallel Engine at scripts/
# bench_suite.py's ernie_engine recipe with the model's full length: batch,
# sequence, batches an epoch, and the CPU parity check's sequence (batch
# 1); (b) nn.Transformer at its defaults (d_model 512, 8 heads, D = 64,
# 6 + 6 layers, FFN 2,048) in bf16: batch, source = target length,
# incremental decode steps; its K4 / K7 calls as (label, B, Sq, Sk, H,
# D): the encoder's self-attention and the decoder's cross-attention
# (non-causal, no mask), the cached decode's cross-attention over the
# memory and its self-attention at the last step; (c) LeNet under
# hapi.Model: samples, batch, epochs; (d) t5-small: batch, source and
# target lengths, steps
ERNIE_SHAPE = (16, 512, 8, 128)
TRANSFORMER_SHAPE = (16, 512, 32)
TRANSFORMER_ATTN = ("transformer_train", 16, 512, 512, 8, 64)
TRANSFORMER_DECODE_CROSS = ("transformer_decode_cross", 16, 1, 512, 8, 64)
TRANSFORMER_DECODE_SELF = ("transformer_decode_self", 16, 1, 32, 8, 64)
BERT_PHASE_LABELS = ("transformer_",)
LENET_SHAPE = (512, 64, 3)
T5_SHAPE = (16, 512, 128, 5)
# (a)'s bound on the first step's loss, the card's (TF32 off) against the
# CPU's on the same weights and batch: relative, f32 summed in other
# orders over 12 layers and a 40,000-way log-softmax
ERNIE_CPU_BOUND = 1e-5
# (c)'s width: Llama-2-7B's embed, heads, FFN and layers; (f)'s:
# Mixtral-8x7B's d_model, d_hidden and experts
FMT_WIDTH = (4096, 32, 11008, 32)
MOE_WIDTH = (4096, 14336, 8)
FMT_PARITY_SHAPE = (256, 64, 8)
# (c)'s decode steps that are also run on the plain path
FMT_PLAIN_STEPS = 4
MOE_TOKENS = 4096
# (d)'s bound: the int8 stack's outputs against the float stack's, L2
# over L2 (per-channel int8 moves a product by ~1% of its size)
FMT_INT8_BOUND = 0.05
# (b)'s and (c)'s bound: the bf16 kernel path's outputs against the
# plain path's on the same inputs, L2 over L2 (both compute in f32 and
# round once, but K4 rounds P to bf16 before its product and the
# roundings compound over the layers; a wrong tile or split is O(1))
KERNEL_PATH_BOUND = 2.0 ** -5
# (f)'s bound: the grouped mode against the einsum mode, max |diff| over
# the largest |value| (bf16: the modes round and sum in other orders, a
# few bf16 steps apart)
MOE_AGREE_BOUND = 2.0 ** -5
# (f)'s second capacity factor: 0.5 gives 8 experts room for half of the
# 2 * 4,096 assignments, so the overflow path drops some
MOE_OVERFLOW_FACTOR = 0.5
# phase 23: (a) the op sweep's shapes: elementwise, reduction and
# manipulation ops; sorts, searches and quantiles (the CPU reference sorts
# in f64); products (the CPU reference computes their first rows) and
# decompositions; its tolerance, max |card - cpu f64| over max(1, max
# |cpu|): f32 products and reductions of up to 2^24 terms in other orders,
# and in bf16 two roundings of an element (2^-8 of it each: an
# intermediate's and the output's) with room;
# (b) the public-API ResNet-50's steps compared and timed; (c) the SwiGLU
# layer's width, batch and sequence, steps, the rows checked against the
# CPU and their bound (relative L2: bf16 rounds the two products' inputs
# and the hidden activation, ~2^-8 each, over f32's run of the same
# weights)
TENSOR_API_SHAPE = (2, 2048, 4096)
TENSOR_API_SEARCH_SHAPE = (2, 512, 4096)
TENSOR_API_MATMUL = 4096
TENSOR_API_CPU_ROWS = 256
TENSOR_API_DECOMP = 512
# and the decompositions' (f32 at 512: cuSOLVER's and LAPACK's orders of
# operations; an eigen-reconstruction carries ~n eps ||A||)
TENSOR_API_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6,
                  "float32_decomposition": 1e-3}
RESNET_API_STEPS, RESNET_API_TIMED = 3, 3
SWIGLU_WIDTH = (4096, 11008)
SWIGLU_SHAPE = (2, 2048)
SWIGLU_STEPS = 3
SWIGLU_CPU_ROWS = 64
SWIGLU_BOUND = 2.0 ** -5
# phase 24: (a) Llama-2-7B's widths in bf16 at this many decoder layers
# (the depth is cut: the compiled graph repeats one layer's code, and the
# kernels' shapes are every layer's), the ids' batch and length, and the
# steady calls timed by CUDA events
STATIC_LAYERS = 2
STATIC_IDS = (2, 512)
STATIC_TIMED = 5
# the serving sampling arm's knobs (phases 3 and 6)
SAMPLING = dict(decode_strategy="sampling", top_k=50, top_p=0.9,
                temperature=0.8)


# phase 25: (a) K2 and K5 in graphs at STATIC_LAYERS layers of Llama-2-7B's
# widths in bf16: the contiguous-cache decode step over (rows, cache
# length) at each of the positions, and phase 3's engine's paged decode
# math over its pool with the rows' cached tokens drawn in the range
MANIFEST_DECODE = (8, 1024, (512, 1023))
MANIFEST_PAGED_LENS = (512, 1024)
# the captured decode quantum at phase 3's knobs as PERF.md §6 records it
# before K2 / K5 became custom ops (wall ms a dispatch, NVIDIA H100 80GB
# HBM3, 700 W)
RECORDED_QUANTUM_MS = (63.2, 66.7)
# (b) flash_attn_qkvpacked at phase 7's attention shape (B, S, H, D)
QKVPACKED_SHAPE = (1, 4096, 32, 128)
# (c) the large PTB LSTM of Zaremba, Sutskever and Vinyals 2014
# (arXiv:1409.2329): layers, hidden, vocabulary, unrolled steps, batch,
# dropout; AdamW at PTB_LR; PTB_STEPS = (steps held against the CPU with
# dropout off, timed steps with the paper's dropout)
PTB_LARGE = (2, 1500, 10000, 35, 20, 0.65)
PTB_LR = 1e-3
PTB_STEPS = (3, 3)
# (d) Whisper's audio front end (whisper/audio.py): batch, samples (30 s
# at 16 kHz), n_fft, hop; and the (B, H, W) field of the transforms
WHISPER_AUDIO = (8, 480000, 400, 160)
FFT_FIELD = (8, 256, 256)
# (e) the grid ops at ResNet-50's input, unfold / fold with a 3 x 3 kernel
GRID_SHAPE = (32, 3, 224, 224)
FOLD_SHAPE = (8, 64, 56, 56, 3)
# (f) a COO matrix (M, K) at this density times a dense (K, N)
SPARSE_SHAPE = (4096, 4096, 0.01, 512)
# f32 results on the card against the port's CPU run of the same inputs
# and weights: max |card - cpu| / max |cpu| (summation orders only: cuBLAS,
# cuFFT and atomics against the CPU's; the LSTM's losses after AdamW
# steps, where an update's sign follows a gradient's last bits, 1e-4
# relative each)
MANIFEST_F32_BOUND = 1e-4

_T0 = time.perf_counter()


def emit(record):
    """One JSON line; a phase's record also gets ``t_s``, the seconds
    since the script started."""
    if "phase" in record:
        record = {**record, "t_s": time.perf_counter() - _T0}
    print(json.dumps(record), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(nbytes, flops, f32):
    """bound_ms of an attention kernel doing ``flops`` (bf16) operations;
    in f32 each product is three TF32 products (3xTF32)."""
    return (bound_ms(nbytes, 3 * flops, "tfloat32") if f32 else
            bound_ms(nbytes, flops, "bfloat16"))


def device_ms(torch, fn, iters=10):
    """(GPU time of one call, timer). The time is the summed durations of
    every kernel the call launches (torch.profiler), without the launch
    gaps between them. Now and then the profiler on this stack records no
    device time for a whole profile (once a library call, once a port
    kernel): the profile is then taken again, three times in all, and
    after that the call is timed by CUDA events (launch gaps included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(_device_us(ev) for ev in prof.key_averages()
                       if ev.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            return total_us / iters / 1e3, "profiler"
    return cuda_ms(torch, fn), "cuda_events"


def _device_us(ev):
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0))


def cuda_ms(torch, fn, iters=20, warmup=3):
    """CUDA-event time per call over back-to-back calls: includes the
    gaps when the host enqueues slower than the card runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(torch, out, ref, dtype, p_rounded=False):
    """(max abs error, within tolerance) over one output or a tuple of
    them. f32: 1e-4 relative + absolute (summation order only). bf16: one
    rounding step of the reference value (both sides compute in f32 and
    round once), plus 1e-2 absolute where probabilities or their
    gradients are rounded to bf16 before a product (K3, K4, K7, K8, as the
    TPU kernels do): a p on a rounding boundary may round one step
    differently when the f32 scores differ in their last bits, which
    moves the output by up to 2^-8 * |v|. fp16 (K4 and K7 under amp's O1)
    the same with fp16's step: 2^-10 relative, 2e-3 absolute where P or
    dS are rounded. A 1-D output (K6's dw, a sum over every row) takes
    the absolute term times its largest value."""
    if dtype == torch.bfloat16:
        rtol, atol = 2.0 ** -7, (1e-2 if p_rounded else 1e-3)
    elif dtype == torch.float16:
        rtol, atol = 2.0 ** -10, (2e-3 if p_rounded else 1e-3)
    else:
        rtol, atol = 1e-4, 1e-4
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    err, ok = 0.0, True
    for o, r in zip(out, ref):
        # a sum over many rows (K6's dw) is held relative to its size
        a = atol * max(1.0, float(r.float().abs().max())) if r.dim() == 1 \
            else atol
        diff = (o.float() - r.float()).abs()
        ok &= bool((diff <= a + rtol * r.float().abs()).all())
        err = max(err, float(diff.max()))
    return err, ok, {"rtol": rtol, "atol": atol}


def env_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from paddle_tpu_torch.ops import _library

    nvcc = subprocess.run([_library._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    t0 = time.perf_counter()
    _library.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _library.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc.stdout.strip()
          .splitlines()[-1], "python": sys.version.split()[0],
          "kernel_build_s": build_s,
          "built_here": _library.BUILD_INFO["built"], "ptxas": ptxas})
    return smi


# ------------------------------------------------------------ phase 2
def k1_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    import torch.nn.functional as tF

    for dtype in (torch.bfloat16, torch.float32):
        # 1,024 rows (the primary, in the L2 across back-to-back calls) and
        # the training path's 4,096 (67 MB in bf16: past the 50 MB L2)
        for rows in (8, 1024, 4096):
            n = 4096
            x = torch.randn(rows, n, generator=g, device=dev).to(dtype)
            w = torch.randn(n, generator=g, device=dev).to(dtype)
            e = x.element_size()
            nbytes = (2 * rows * n + n) * e
            yield dict(
                name="rms_norm", dtype=dtype, shape=f"rows={rows},N={n}",
                primary=(rows == 1024 and dtype == torch.bfloat16),
                kernel=lambda: ops.rms_norm(x, w),
                plain=lambda: ops.rms_norm_plain(x, w)[0],
                library=lambda: tF.rms_norm(x, (n,), w, 1e-6),
                bound=bound_ms(nbytes, 4.0 * rows * n, "float32"))


def _paged_inputs(torch, g, dev, dtype, b, h, hk, d, bs, lens_list,
                  pool_dtype=None, reach=2048):
    """q in ``dtype`` over pools of ``pool_dtype`` (default q's; int8 pools
    hold the whole int8 range), tables of ``reach`` tokens."""
    w = reach // bs
    num_blocks = b * w + 1
    shape = (num_blocks, bs, hk, d)
    if pool_dtype == torch.int8:
        kp, vp = (torch.randint(-128, 128, shape, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
    else:
        kp = torch.randn(*shape, generator=g, device=dev).to(dtype)
        vp = torch.randn(*shape, generator=g, device=dev).to(dtype)
    perm = torch.randperm(num_blocks - 1, generator=g, device=dev) + 1
    tables = torch.full((b, w), 10 ** 7, dtype=torch.int32, device=dev)
    nxt = 0
    for i, ln in enumerate(lens_list):
        nb = -(-ln // bs)
        tables[i, :nb] = perm[nxt:nxt + nb].int()
        nxt += nb
        if nb < w:
            tables[i, nb:] = -3 - i   # garbage past the length, never read
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    return q, kp, vp, tables, lens


def k2_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    import torch.nn.functional as tF

    d, bs = 128, 32
    # B=8 sequences of 1-2,048 tokens; then one sequence and one head over
    # 4,096 tokens (the split plan's smallest B x HK), bf16 only
    shapes = [(8, [1, 31, 32, 33, 500, 1024, 2047, 2048], dtype, h, hk)
              for dtype in (torch.bfloat16, torch.float32)
              # MHA, GQA 4, and Qwen2-7B's group of 7 (28 query heads over 4)
              for h, hk in ((32, 32), (32, 8), (28, 4))]
    shapes.append((1, [4096], torch.bfloat16, 1, 1))
    for b, lens_list, dtype, h, hk in shapes:
        q, kp, vp, tables, lens = _paged_inputs(
            torch, g, dev, dtype, b, h, hk, d, bs, lens_list,
            reach=max(2048, lens_list[-1]))
        # the library yardstick: SDPA over the dense gathered cache
        lmax = max(lens_list)
        nb = -(-lmax // bs)
        safe = torch.where(
            torch.arange(nb, device=dev)[None] * bs < lens[:, None],
            tables[:, :nb], 0).long()
        kd = kp[safe].reshape(b, nb * bs, hk, d).repeat_interleave(
            h // hk, dim=2).transpose(1, 2).contiguous()
        vd = vp[safe].reshape(b, nb * bs, hk, d).repeat_interleave(
            h // hk, dim=2).transpose(1, 2).contiguous()
        mask = (torch.arange(nb * bs, device=dev)[None]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        e = q.element_size()
        live = sum(lens_list)
        nbytes = (2 * b * h * d + 2 * live * hk * d) * e \
            + 4 * (b + sum(-(-ln // bs) for ln in lens_list))
        yield dict(
            name="paged_decode_attention", dtype=dtype,
            shape=f"B={b},H={h},HK={hk},D={d},BS={bs},lens={lens_list}",
            primary=(hk == 32 and dtype == torch.bfloat16),
            kernel=lambda: ops.paged_decode_attention(q, kp, vp, tables,
                                                      lens),
            plain=lambda: ops.paged_decode_attention_plain(
                q, kp, vp, tables, lens),
            library=lambda: tF.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask),
            bound=bound_ms(nbytes, 4.0 * live * h * d,
                           str(dtype).removeprefix("torch.")))
        if hk != 32:
            continue
        # the static-scale mode over float pools: (HK,) k and v scales
        # (the TPU kernel's has_scales arm on a float pool); the
        # yardstick scales the gathered dense cache, then one SDPA call
        ks = torch.rand(hk, generator=g, device=dev) * 1.5 + 0.25
        vs = torch.rand(hk, generator=g, device=dev) * 1.5 + 0.25
        ksr = ks.repeat_interleave(h // hk)[None, :, None, None]
        vsr = vs.repeat_interleave(h // hk)[None, :, None, None]
        yield dict(
            name="paged_decode_attention_scaled", dtype=dtype,
            shape=f"B={b},H={h},HK={hk},D={d},BS={bs},lens={lens_list},"
                  f"(HK,) scales",
            primary=(dtype == torch.bfloat16),
            kernel=lambda: ops.paged_decode_attention(
                q, kp, vp, tables, lens, k_scale=ks, v_scale=vs),
            plain=lambda: ops.paged_decode_attention_plain(
                q, kp, vp, tables, lens, k_scale=ks, v_scale=vs),
            library=lambda: tF.scaled_dot_product_attention(
                q4, (kd * ksr).to(dtype), (vd * vsr).to(dtype),
                attn_mask=mask),
            bound=bound_ms(nbytes + 2 * 4 * hk, 4.0 * live * h * d,
                           str(dtype).removeprefix("torch.")))


def k2_int8_cases(torch, g, dev):
    """K2's int8 arm: int8 pools dequantized by static (HK,) scales (the
    TPU kernel's arm) and by per-row scale pools (the int8 engine's
    quantum), at the K2 serving shape and at GQA 32/8. The library
    yardstick gathers the live blocks, dequantizes them and runs one
    SDPA call, all inside the timed function (SDPA takes no int8)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.paged_attention import (
        _paged_decode_attention_rows, _paged_decode_attention_rows_plain)
    import torch.nn.functional as tF

    b, d, bs = 8, 128, 32
    lens_list = [1, 31, 32, 33, 500, 1024, 2047, 2048]
    live = sum(lens_list)
    live_blocks = sum(-(-ln // bs) for ln in lens_list)
    for dtype in (torch.bfloat16, torch.float32):
        for h, hk in ((32, 32), (32, 8)):
            q, kp, vp, tables, lens = _paged_inputs(
                torch, g, dev, dtype, b, h, hk, d, bs, lens_list,
                pool_dtype=torch.int8)
            nb_pool = kp.shape[0]
            ks = torch.rand(hk, generator=g, device=dev) * 0.02 + 0.005
            vs = torch.rand(hk, generator=g, device=dev) * 0.02 + 0.005
            rks = torch.rand(nb_pool, bs, hk, generator=g, device=dev) \
                * 0.02 + 0.005
            rvs = torch.rand(nb_pool, bs, hk, generator=g, device=dev) \
                * 0.02 + 0.005
            nb = -(-max(lens_list) // bs)
            safe = torch.where(
                torch.arange(nb, device=dev)[None] * bs < lens[:, None],
                tables[:, :nb], 0).long()
            mask = (torch.arange(nb * bs, device=dev)[None]
                    < lens[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]

            def library(k_sc, v_sc, safe=safe, kp=kp, vp=vp, hk=hk, h=h,
                        mask=mask, q4=q4):
                def dense(pool, sc):
                    x = pool[safe].float() * sc
                    return x.reshape(b, nb * bs, hk, d).to(q4.dtype) \
                        .repeat_interleave(h // hk, dim=2).transpose(1, 2)
                return tF.scaled_dot_product_attention(
                    q4, dense(kp, k_sc(safe)), dense(vp, v_sc(safe)),
                    attn_mask=mask)

            e = q.element_size()
            common = dict(dtype=dtype, primary=(hk == 32
                                                and dtype == torch.bfloat16))
            shape = (f"B={b},H={h},HK={hk},D={d},BS={bs},lens={lens_list},"
                     f"int8 pools")
            # q and out, int8 K/V rows, tables and lens
            nbytes = 2 * b * h * d * e + 2 * live * hk * d \
                + 4 * (b + live_blocks)
            ddt = str(dtype).removeprefix("torch.")
            yield dict(
                name="paged_decode_attention_int8",
                shape=shape + ", (HK,) scales",
                kernel=lambda: ops.paged_decode_attention(
                    q, kp, vp, tables, lens, k_scale=ks, v_scale=vs),
                plain=lambda: ops.paged_decode_attention_plain(
                    q, kp, vp, tables, lens, k_scale=ks, v_scale=vs),
                library=lambda: library(lambda i: ks[:, None],
                                        lambda i: vs[:, None]),
                bound=bound_ms(nbytes + 2 * 4 * hk, 4.0 * live * h * d,
                               ddt), **common)
            yield dict(
                name="paged_decode_attention_int8_rows",
                shape=shape + ", (NB, BS, HK) row scales",
                kernel=lambda: _paged_decode_attention_rows(
                    q, kp, vp, rks, rvs, tables, lens),
                plain=lambda: _paged_decode_attention_rows_plain(
                    q, kp, vp, rks, rvs, tables, lens),
                library=lambda: library(lambda i: rks[i][..., None],
                                        lambda i: rvs[i][..., None]),
                bound=bound_ms(nbytes + 2 * 4 * live * hk,
                               4.0 * live * h * d, ddt), **common)


def k3_cases(torch, g, dev):
    """K3 at the serving path's shape (8 x 128-token chunks over cached
    contexts; the primary), at the packed training path's row (the 941M
    configuration: D = 64, causal) and with GQA and a window at D = 128.
    The serving case's library yardstick is one SDPA call over the
    segments padded to a batch; the packed cases' the faster of one
    block-diagonal-masked SDPA call over the row and the per-segment SDPA
    forwards (``is_causal`` where no window cuts)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.varlen_flash_attention import segment_mask
    import torch.nn.functional as tF

    d, chunk = 128, 128
    cached = [0, 64, 192, 320, 448, 640, 896, 1920]   # mixed-step rows
    lq = [chunk] * len(cached)
    lk = [c + chunk for c in cached]
    cu_q = torch.tensor([0] + list(_cumsum(lq)), dtype=torch.int32,
                        device=dev)
    cu_k = torch.tensor([0] + list(_cumsum(lk)), dtype=torch.int32,
                        device=dev)
    tq, tk = sum(lq), sum(lk)
    pairs = int(segment_mask(cu_q, cu_k, tq, tk, True).sum())
    for dtype in (torch.bfloat16, torch.float32):
        for h, hk in ((32, 32), (32, 8)):
            q = torch.randn(tq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(tk, hk, d, generator=g, device=dev).to(dtype)
            v = torch.randn(tk, hk, d, generator=g, device=dev).to(dtype)
            # library yardstick: one SDPA call over the segments padded
            # to a batch, with the same bottom-right causal mask
            nseg, kmax = len(lq), max(lk)
            qb = q.view(nseg, chunk, h, d).transpose(1, 2).contiguous()
            kb = torch.zeros(nseg, kmax, hk, d, device=dev, dtype=dtype)
            vb = torch.zeros_like(kb)
            for i, (a, n) in enumerate(zip(cu_k.tolist()[:-1], lk)):
                kb[i, :n] = k[a:a + n]
                vb[i, :n] = v[a:a + n]
            kb = kb.repeat_interleave(h // hk, dim=2).transpose(1, 2)
            vb = vb.repeat_interleave(h // hk, dim=2).transpose(1, 2)
            kb, vb = kb.contiguous(), vb.contiguous()
            lk_t = torch.tensor(lk, device=dev)
            rel_q = (torch.arange(chunk, device=dev)[None]
                     + lk_t[:, None] - chunk)
            kpos = torch.arange(kmax, device=dev)
            mask = ((kpos[None, None] <= rel_q[:, :, None])
                    & (kpos[None, None] < lk_t[:, None, None]))[:, None]
            e = q.element_size()
            nbytes = (2 * tq * h * d + 2 * tk * hk * d) * e \
                + 4 * (tq * h + 2 * (nseg + 1))
            yield dict(
                name="varlen_flash_attention", dtype=dtype,
                shape=f"H={h},HK={hk},D={d},chunk={chunk},cached={cached}",
                primary=(hk == 32 and dtype == torch.bfloat16),
                kernel=lambda: ops.varlen_flash_attention(
                    q, k, v, cu_q, cu_k, causal=True),
                plain=lambda: ops.varlen_flash_attention_plain(
                    q, k, v, cu_q, cu_k, causal=True)[0],
                library=lambda: tF.scaled_dot_product_attention(
                    qb, kb, vb, attn_mask=mask),
                bound=attention_bound(nbytes, 4.0 * pairs * h * d,
                                      dtype == torch.float32))
    # (label, lens, H, HK, D, window, dtypes)
    for label, lens, h, hk, d, window, dtypes in (
            ("packed_941m", PACKED_LENS, 32, 32, 64, None,
             (torch.bfloat16, torch.float32)),
            ("gqa_window", PACKED_LENS, 32, 8, 128, 512, (torch.bfloat16,))):
        cu = torch.tensor([0] + list(_cumsum(lens)), dtype=torch.int32,
                          device=dev)
        t = sum(lens)
        pairs = int(segment_mask(cu, cu, t, t, True, window).sum())
        for dtype in dtypes:
            q = torch.randn(t, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(t, hk, d, generator=g, device=dev).to(dtype)
            v = torch.randn(t, hk, d, generator=g, device=dev).to(dtype)
            e = q.element_size()
            nbytes = (2 * t * h * d + 2 * t * hk * d) * e \
                + 4 * (t * h + 2 * (len(lens) + 1))
            f32 = dtype == torch.float32
            yield dict(
                name="varlen_flash_attention", dtype=dtype,
                shape=f"{label}:lens={lens},H={h},HK={hk},D={d},causal,"
                      f"window={window}",
                # K3's f32 forward (flash_f32.cuh) at the packed row has
                # its own row
                primary=f32 and label == "packed_941m",
                row="varlen_flash_attention_f32" if f32
                else "varlen_flash_attention",
                kernel=lambda q=q, k=k, v=v, cu=cu, window=window:
                    ops.varlen_flash_attention(q, k, v, cu, cu, causal=True,
                                               window_size=window),
                plain=lambda q=q, k=k, v=v, cu=cu, window=window:
                    ops.varlen_flash_attention_plain(
                        q, k, v, cu, cu, causal=True,
                        window_size=window)[0],
                library=_segment_forward_library(torch, q, k, v, lens,
                                                 window),
                bound=attention_bound(nbytes, 4.0 * pairs * h * d, f32))


def _segment_forward_library(torch, q, k, v, lens, window):
    """K3's library yardsticks on a packed row (equal query and key
    lengths): one SDPA call over the row under the block-diagonal causal
    (banded) mask, and the per-segment SDPA forwards (``is_causal``, or
    the segment's band under a window)."""
    from paddle_tpu_torch.ops.flash_attention import band_mask
    from paddle_tpu_torch.ops.varlen_flash_attention import segment_mask
    import torch.nn.functional as tF

    dev = q.device
    h, hk = q.shape[1], k.shape[1]
    cu = torch.tensor([0] + list(_cumsum(lens)), device=dev)
    qt = q.transpose(0, 1)[None].contiguous()
    kt = _sdpa_layout(torch, k[None], h // hk).contiguous()
    vt = _sdpa_layout(torch, v[None], h // hk).contiguous()
    mask = segment_mask(cu, cu, q.shape[0], k.shape[0], True, window)
    segs = [tuple(x[:, :, a:b].contiguous() for x in (qt, kt, vt))
            + (None if window is None
               else band_mask(b - a, b - a, True, window, dev),)
            for a, b in zip(cu.tolist(), cu.tolist()[1:]) if b > a]

    def per_segment():
        return [tF.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
                if band is None else
                tF.scaled_dot_product_attention(qs, ks, vs, attn_mask=band)
                for qs, ks, vs, band in segs]
    return {
        "sdpa_block_diagonal_mask": lambda: tF.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask),
        "sdpa_per_segment": per_segment}


def _sdpa_layout(torch, x, rep):
    """(B, S, HK, D) -> (B, H, S, D) with each KV head repeated ``rep``
    times (the library call's layout)."""
    return x.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()


def k4_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.flash_attention import band_mask
    import torch.nn.functional as tF

    # (label, B, Sq, Sk, H, HK, D, window, dtypes): Mistral prefill (the
    # primary), Llama-2 no-cache dense causal, bottom-right causal (Sq <
    # Sk), the training shape (Llama-2-7B width, S = 4,096), where one
    # is_causal SDPA call computes the same function, and phase 19's
    # shapes in bf16: GPT-2 345M's training (D = 64), its generate's
    # longest forward (partial tiles) and FusedMultiTransformer's prefill
    # fp16 at the training shape: amp's O1 attention (phase 18 (c))
    both = (torch.bfloat16, torch.float32)
    for label, b, sq, sk, h, hk, d, window, dtypes in (
            ("mistral_prefill", 1, 4608, 4608, 32, 8, 128, 4096, both),
            ("dense_causal", 1, 2048, 2048, 32, 32, 128, None, both),
            ("bottom_right", 1, 64, 1024, 32, 8, 128, None, both),
            ("train", 1, 4096, 4096, 32, 32, 128, None,
             both + (torch.float16,)),
            *(shape + (None, (torch.bfloat16,))
              for shape in (GPT2_TRAIN_ATTN, GPT2_GENERATE_ATTN,
                            FMT_PREFILL_ATTN))):
        mask = band_mask(sq, sk, True, window, dev)
        pairs = int(mask.sum())
        for dtype in dtypes:
            q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(b, sk, hk, d, generator=g, device=dev).to(dtype)
            v = torch.randn(b, sk, hk, d, generator=g, device=dev).to(dtype)
            qt = q.transpose(1, 2).contiguous()
            kt, vt = _sdpa_layout(torch, k, h // hk), _sdpa_layout(
                torch, v, h // hk)
            if sq == sk and window is None:
                library = (lambda qt=qt, kt=kt, vt=vt:
                           tF.scaled_dot_product_attention(
                               qt, kt, vt, is_causal=True))
            else:
                library = (lambda qt=qt, kt=kt, vt=vt:
                           tF.scaled_dot_product_attention(
                               qt, kt, vt, attn_mask=mask))
            e = q.element_size()
            nbytes = (2 * b * sq * h * d + 2 * b * sk * hk * d) * e \
                + 4 * b * h * sq
            yield dict(
                name="flash_attention", dtype=dtype,
                shape=f"{label}:B={b},Sq={sq},Sk={sk},H={h},HK={hk},D={d},"
                      f"causal,window={window}",
                primary=(label == "mistral_prefill"
                         and dtype == torch.bfloat16)
                or (label == "train" and dtype != torch.bfloat16),
                # the f32 forward (flash_f32.cuh) and the fp16 arm have
                # rows of their own
                row={torch.float32: "flash_attention_f32",
                     torch.float16: "flash_attention_f16"}.get(
                         dtype, "flash_attention"),
                kernel=lambda q=q, k=k, v=v: ops.flash_attention(
                    q, k, v, causal=True, window_size=window),
                plain=lambda q=q, k=k, v=v: ops.flash_attention_plain(
                    q, k, v, causal=True, window_size=window)[0],
                library=library,
                # fp16 runs at bf16's tensor-core rate
                bound=attention_bound(nbytes, 4.0 * pairs * b * h * d,
                                      dtype == torch.float32))


def k4_unet_cases(torch, g, dev):
    """K4 at the SD UNet's attention (phase 20 (a)), bf16, non-causal with
    HK = H: each against its plain version and one non-causal SDPA call."""
    from paddle_tpu_torch import ops
    import torch.nn.functional as tF

    for label, b, sq, sk, h, d in (UNET_SELF_ATTN, UNET_CROSS_ATTN,
                                   UNET_LOW_ATTN):
        dtype = torch.bfloat16
        q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * 2 \
            + 4 * b * h * sq
        yield dict(
            name="flash_attention", dtype=dtype,
            shape=f"{label}:B={b},Sq={sq},Sk={sk},H={h},HK={h},D={d},"
                  f"non-causal",
            primary=False,
            kernel=lambda q=q, k=k, v=v: ops.flash_attention(q, k, v),
            plain=lambda q=q, k=k, v=v: ops.flash_attention_plain(
                q, k, v)[0],
            library=lambda qt=qt, kt=kt, vt=vt:
                tF.scaled_dot_product_attention(qt, kt, vt),
            bound=attention_bound(nbytes, 4.0 * sq * sk * b * h * d,
                                  False))


def k47_transformer_cases(torch, g, dev):
    """K4 and K7 at nn.Transformer's attention (phase 21 (b)), bf16,
    non-causal with HK = H: K4 at the encoder's self-attention and the
    decoder's cross-attention (one shape) and at the cached decode's two
    calls (Sq = 1), K7 at the training shape; each against its plain
    version and non-causal SDPA (its whole backward through autograd for
    K7)."""
    from paddle_tpu_torch import ops
    import torch.nn.functional as tF

    dtype = torch.bfloat16
    for label, b, sq, sk, h, d in (TRANSFORMER_ATTN, TRANSFORMER_DECODE_CROSS,
                                   TRANSFORMER_DECODE_SELF):
        q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * 2 \
            + 4 * b * h * sq
        yield dict(
            name="flash_attention", dtype=dtype,
            shape=f"{label}:B={b},Sq={sq},Sk={sk},H={h},HK={h},D={d},"
                  f"non-causal",
            primary=False,
            kernel=lambda q=q, k=k, v=v: ops.flash_attention(q, k, v),
            plain=lambda q=q, k=k, v=v: ops.flash_attention_plain(
                q, k, v)[0],
            library=lambda qt=qt, kt=kt, vt=vt:
                tF.scaled_dot_product_attention(qt, kt, vt),
            bound=attention_bound(nbytes, 4.0 * sq * sk * b * h * d,
                                  False))
    label, b, s, _, h, d = TRANSFORMER_ATTN
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    delta = ops.flash_attention_bwd_delta(out, do)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lo = tF.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    nbytes = 7 * b * s * h * d * 2 + 8 * b * h * s
    yield dict(
        name="flash_attention_bwd", dtype=dtype, primary=False,
        shape=f"{label}:B={b},S={s},H={h},HK={h},D={d},non-causal",
        kernel=lambda: ops.flash_attention_bwd_fused(q, k, v, do, lse, delta,
                                                     False),
        plain=lambda: ops.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                    False, delta=delta),
        library=lambda: torch.autograd.grad(lo, (qt, kt, vt), dot,
                                            retain_graph=True),
        bound=attention_bound(nbytes, 10.0 * d * s * s * b * h, False))


def k5_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    import torch.nn.functional as tF

    d = 128
    # (label, S_max, lens, H, HK, dtype): Mistral's GQA 4, MHA, and
    # Qwen2-7B's group of 7 over 1-4,096 live tokens; then the generate
    # run's own step (4 rows of 4,096 live tokens in the rolling
    # 4,096-token buffer) and FusedMultiTransformer's decode step (phase
    # 19 (c)), bf16
    shapes = [("", 4096, [1, 1500, 3000, 4096], h, hk, dtype)
              for h, hk in ((32, 8), (32, 32), (28, 4))
              for dtype in (torch.bfloat16, torch.float32)]
    shapes.append(("", 4096, [4096] * 4, 32, 8, torch.bfloat16))
    shapes.append(FMT_DECODE_ATTN + (torch.bfloat16,))
    for label, s_max, lens_list, h, hk, dtype in shapes:
        b = len(lens_list)
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        mask = (torch.arange(s_max, device=dev)[None]
                < lens[:, None])[:, None, None, :]
        q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
        kc = torch.randn(b, s_max, hk, d, generator=g,
                         device=dev).to(dtype)
        vc = torch.randn(b, s_max, hk, d, generator=g,
                         device=dev).to(dtype)
        q4 = q[:, :, None, :]
        kt, vt = _sdpa_layout(torch, kc, h // hk), _sdpa_layout(
            torch, vc, h // hk)
        e = q.element_size()
        live = sum(lens_list)
        nbytes = (2 * b * h * d + 2 * live * hk * d) * e + 4 * b
        yield dict(
            name="decode_attention", dtype=dtype,
            shape=f"{label + ':' if label else ''}B={b},H={h},HK={hk},"
                  f"D={d},S_max={s_max},lens={lens_list}",
            primary=(hk == 8 and dtype == torch.bfloat16
                     and lens_list[0] == 1),
            kernel=lambda q=q, kc=kc, vc=vc, lens=lens:
                ops.decode_attention(q, kc, vc, lens),
            plain=lambda q=q, kc=kc, vc=vc, lens=lens:
                ops.decode_attention_plain(q, kc, vc, lens),
            library=lambda q4=q4, kt=kt, vt=vt, mask=mask:
                tF.scaled_dot_product_attention(q4, kt, vt,
                                                attn_mask=mask),
            bound=bound_ms(nbytes, 4.0 * live * h * d,
                           str(dtype).removeprefix("torch.")))


def k6_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    import torch.nn.functional as tF

    # the training path's rows (B=1, S=4,096) at Llama-2-7B's width, the
    # packed path's at the 941M width, and phase 8's f32 rows (S=1,024)
    for dtype, rows, n in ((torch.bfloat16, 4096, 4096),
                           (torch.float32, 4096, 4096),
                           (torch.bfloat16, 4096, 2048),
                           (torch.float32, 1024, 4096)):
        x = torch.randn(rows, n, generator=g, device=dev).to(dtype)
        w = torch.randn(n, generator=g, device=dev).to(dtype)
        dy = torch.randn(rows, n, generator=g, device=dev).to(dtype)
        _, r = ops.rms_norm_plain(x, w)
        # the library yardstick: F.rms_norm's backward through autograd
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        yl = tF.rms_norm(xl, (n,), wl, 1e-6)
        e = x.element_size()
        nbytes = (3 * rows * n + 2 * n) * e + 4 * rows
        yield dict(
            name="rms_norm_bwd", dtype=dtype, shape=f"rows={rows},N={n}",
            primary=(dtype == torch.bfloat16 and n == 4096),
            kernel=lambda x=x, w=w, r=r, dy=dy: ops.rms_norm_bwd(x, w, r, dy),
            plain=lambda x=x, w=w, r=r, dy=dy: ops.rms_norm_bwd_plain(
                x, w, r, dy),
            library=lambda yl=yl, xl=xl, wl=wl, dy=dy: torch.autograd.grad(
                yl, (xl, wl), dy, retain_graph=True),
            bound=bound_ms(nbytes, 8.0 * rows * n, "float32"))


def k7_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.flash_attention import band_mask
    import torch.nn.functional as tF

    # (label, B, S, H, HK, D, window, dtypes): the training path
    # (Llama-2-7B width, S=4,096, causal; the fused kernel K7 is the
    # primary in bf16 and in f32, its 3xTF32 kernel), Mistral's GQA width
    # with its window, and GPT-2 345M's training shape (phase 19 (a))
    for label, b, sq, h, hk, d, window, dtypes in (
            ("train", 1, 4096, 32, 32, 128, None,
             (torch.bfloat16, torch.float32, torch.float16)),
            ("mistral_gqa_window", 1, 4608, 32, 8, 128, 4096,
             (torch.bfloat16,)),
            GPT2_TRAIN_ATTN[:3] + GPT2_TRAIN_ATTN[4:] + (
                None, (torch.bfloat16,))):
        mask = band_mask(sq, sq, True, window, dev)
        pairs = int(mask.sum())
        for dtype in dtypes:
            q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(b, sq, hk, d, generator=g, device=dev).to(dtype)
            v = torch.randn(b, sq, hk, d, generator=g, device=dev).to(dtype)
            do = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
            out, lse = ops.flash_attention(q, k, v, causal=True,
                                           window_size=window,
                                           return_lse=True)
            delta = ops.flash_attention_bwd_delta(out, do)
            # the library yardstick: SDPA's whole backward (dq, dk, dv)
            # through autograd on the same inputs
            qt = q.transpose(1, 2).contiguous().requires_grad_()
            kt = _sdpa_layout(torch, k, h // hk).requires_grad_()
            vt = _sdpa_layout(torch, v, h // hk).requires_grad_()
            lo = (tF.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
                  if window is None else
                  tF.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask))
            dot = do.transpose(1, 2).contiguous()
            e = q.element_size()
            f32 = dtype == torch.float32
            common = dict(
                dtype=dtype, primary=label == "train",
                shape=f"{label}:B={b},S={sq},H={h},HK={hk},D={d},causal,"
                      f"window={window}",
                library=lambda lo=lo, qt=qt, kt=kt, vt=vt, dot=dot:
                    torch.autograd.grad(lo, (qt, kt, vt), dot,
                                        retain_graph=True))
            args = (q, k, v, do, lse, delta, True)

            def plain(q=q, k=k, v=v, out=out, lse=lse, do=do, delta=delta,
                      window=window):
                return ops.flash_attention_bwd_plain(
                    q, k, v, out, lse, do, True, window_size=window,
                    delta=delta)
            # q, do, dq and k, v, dk, dv once each, lse and delta
            nbytes = (3 * b * sq * h * d + 4 * b * sq * hk * d) * e \
                + 8 * b * h * sq
            # K7: S^T, dP^T, dV, dK, dQ: 10 * D flops per live pair; in
            # f32 each product is three TF32 products (3xTF32)
            flops = 10.0 * d * pairs * b * h
            yield dict(
                name={torch.float32: "flash_attention_bwd_f32",
                      torch.float16: "flash_attention_bwd_f16"}.get(
                          dtype, "flash_attention_bwd"),
                kernel=lambda args=args, window=window:
                    ops.flash_attention_bwd_fused(*args,
                                                  window_size=window),
                plain=plain,
                bound=attention_bound(nbytes, flops, f32),
                **common)


def _segment_library(torch, q, k, v, do, lens_q, lens_k, window):
    """The library yardsticks of K8 (bf16 and f32): SDPA's whole backward
    (dq, dk, dv) through autograd on the same inputs, once over the packed
    row under a block-diagonal causal (banded) mask and once as the sum of
    per-segment SDPA backwards (``is_causal`` where a segment's query and
    key lengths agree and no window cuts, else its bottom-right band)."""
    from paddle_tpu_torch.ops.flash_attention import band_mask
    from paddle_tpu_torch.ops.varlen_flash_attention import segment_mask
    import torch.nn.functional as tF

    dev = q.device
    h, hk = q.shape[1], k.shape[1]
    cu_q = torch.tensor([0] + list(_cumsum(lens_q)), device=dev)
    cu_k = torch.tensor([0] + list(_cumsum(lens_k)), device=dev)
    qt = q.transpose(0, 1)[None].contiguous().requires_grad_()
    kt = _sdpa_layout(torch, k[None], h // hk).requires_grad_()
    vt = _sdpa_layout(torch, v[None], h // hk).requires_grad_()
    mask = segment_mask(cu_q, cu_k, q.shape[0], k.shape[0], True, window)
    lo = tF.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(0, 1)[None].contiguous()
    outs, ins, grads = [], [], []
    for a, b, c, e in zip(cu_q.tolist(), cu_q.tolist()[1:], cu_k.tolist(),
                          cu_k.tolist()[1:]):
        if b == a or e == c:
            continue
        qs, ks, vs = (x.detach()[:, :, lo_:hi_].clone().requires_grad_()
                      for x, lo_, hi_ in ((qt, a, b), (kt, c, e), (vt, c, e)))
        if b - a == e - c and window is None:
            o = tF.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        else:
            o = tF.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=band_mask(b - a, e - c, True, window,
                                                dev))
        outs.append(o)
        ins += [qs, ks, vs]
        grads.append(dot[:, :, a:b])
    return {
        "sdpa_block_diagonal_mask": lambda: torch.autograd.grad(
            lo, (qt, kt, vt), dot, retain_graph=True),
        "sdpa_per_segment": lambda: torch.autograd.grad(
            outs, ins, grads, retain_graph=True)}


def k8_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.varlen_flash_attention import segment_mask

    # (label, lens_q, lens_k or None, H, HK, D, window, dtypes): the packed
    # training path (the 941M configuration's row; the fused bf16 kernel K8
    # is the primary in bf16 and in f32, its 3xTF32 kernel),
    # GQA with a window shorter than the long segments, unequal query and
    # key lengths, and empty segments
    for label, lens_q, lens_k, h, hk, d, window, dtypes in (
            ("packed_941m", PACKED_LENS, None, 32, 32, 64, None,
             (torch.bfloat16, torch.float32)),
            ("gqa_window", PACKED_LENS, None, 32, 8, 128, 512,
             (torch.bfloat16,)),
            ("cross_lengths", [1024, 512, 300, 76], [1600, 512, 700, 76],
             32, 32, 64, None, (torch.bfloat16,)),
            ("empty_segments", [1600, 0, 800, 600, 0, 400, 300, 200, 120,
                                76, 0], None, 32, 32, 64, None,
             (torch.bfloat16,))):
        lens_k = lens_q if lens_k is None else lens_k
        cu_q = torch.tensor([0] + list(_cumsum(lens_q)), dtype=torch.int32,
                            device=dev)
        cu_k = torch.tensor([0] + list(_cumsum(lens_k)), dtype=torch.int32,
                            device=dev)
        tq, tk = sum(lens_q), sum(lens_k)
        pairs = int(segment_mask(cu_q, cu_k, tq, tk, True, window).sum())
        for dtype in dtypes:
            q = torch.randn(tq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(tk, hk, d, generator=g, device=dev).to(dtype)
            v = torch.randn(tk, hk, d, generator=g, device=dev).to(dtype)
            do = torch.randn(tq, h, d, generator=g, device=dev).to(dtype)
            out, lse = ops.varlen_flash_attention(
                q, k, v, cu_q, cu_k, causal=True, window_size=window,
                return_lse=True)
            delta = ops.varlen_flash_attention_bwd_delta(out, do)
            e = q.element_size()
            common = dict(
                dtype=dtype, primary=label == "packed_941m",
                shape=f"{label}:lens_q={lens_q},lens_k={lens_k},H={h},"
                      f"HK={hk},D={d},causal,window={window}",
                library=_segment_library(torch, q, k, v, do, lens_q, lens_k,
                                         window))
            args = (q, k, v, do, lse, delta, cu_q, cu_k, True)

            def plain(args=args, out=out, window=window):
                q, k, v, do, lse, delta, cu_q, cu_k, causal = args
                return ops.varlen_flash_attention_bwd_plain(
                    q, k, v, out, lse, do, cu_q, cu_k, causal,
                    window_size=window, delta=delta)
            # K8: q, do, dq and k, v, dk, dv once each, lse and delta;
            # S^T, dP^T, dV, dK, dQ: 10 * D flops per live pair; in f32
            # each product is three TF32 products (3xTF32)
            f32 = dtype == torch.float32
            nbytes = (3 * tq * h * d + 4 * tk * hk * d) * e + 8 * h * tq
            flops = 10.0 * d * pairs * h
            yield dict(
                name="varlen_flash_attention_bwd_f32" if f32 else
                     "varlen_flash_attention_bwd",
                kernel=lambda args=args, window=window:
                    ops.varlen_flash_attention_bwd_fused(
                        *args, window_size=window),
                plain=plain,
                bound=attention_bound(nbytes, flops, f32),
                **common)


def _cumsum(xs):
    t = 0
    for x in xs:
        t += x
        yield t


KERNELS = {
    "rms_norm": ("cuda", "paddle_tpu_torch/csrc/rms_norm.cu",
                 "paddle_tpu/ops/pallas/rms_norm.py:67"),
    "paged_decode_attention": (
        "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention.py:157"),
    # K2's int8 arm (_paged_kernel's has_scales, lines 53-58): static
    # (HK,) scales, and the per-row scale pools of the int8 engine
    "paged_decode_attention_int8": (
        "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention.py:157"),
    "paged_decode_attention_int8_rows": (
        "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention.py:157"),
    # the same arm's static scales over float pools
    "paged_decode_attention_scaled": (
        "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention.py:157"),
    "varlen_flash_attention": (
        "cuda", "paddle_tpu_torch/csrc/varlen_flash_attention.cu",
        "paddle_tpu/ops/pallas/varlen_flash_attention.py:160"),
    "flash_attention": (
        "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:225"),
    "decode_attention": (
        "cuda", "paddle_tpu_torch/csrc/decode_attention.cu",
        "paddle_tpu/ops/pallas/decode_attention.py:128"),
    "rms_norm_bwd": ("cuda", "paddle_tpu_torch/csrc/rms_norm.cu",
                     "paddle_tpu/ops/pallas/rms_norm.py:91"),
    # K7, the fused bf16 backward: both TPU kernels of `_flash_bwd`
    "flash_attention_bwd": (
        "cuda", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:402, :425"),
    # K7 in f32 (3xTF32), the route of an f32 model (phase 8)
    "flash_attention_bwd_f32": (
        "cuda", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:402, :425"),
    # K4's f32 forward (flash_f32.cuh, 3xTF32), the route of an f32 model
    # (phase 8)
    "flash_attention_f32": (
        "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:225"),
    # K4's and K7's fp16 arms (amp's O1 attention; phase 18 (c))
    "flash_attention_f16": (
        "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:225"),
    "flash_attention_bwd_f16": (
        "cuda", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:402, :425"),
    # K8, the fused bf16 varlen backward: both TPU kernels of `_varlen_bwd`
    "varlen_flash_attention_bwd": (
        "cuda", "paddle_tpu_torch/csrc/varlen_flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/varlen_flash_attention.py:336, :376"),
    # K8 in f32 (3xTF32), the route of an f32 model (phase 10)
    "varlen_flash_attention_bwd_f32": (
        "cuda", "paddle_tpu_torch/csrc/varlen_flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/varlen_flash_attention.py:336, :376"),
    # K3's f32 forward (flash_f32.cuh, 3xTF32), the route of an f32 model
    # (phase 10)
    "varlen_flash_attention_f32": (
        "cuda", "paddle_tpu_torch/csrc/varlen_flash_attention.cu",
        "paddle_tpu/ops/pallas/varlen_flash_attention.py:160"),
}
# the kernels each main path must launch
SERVING_KERNELS = ("rms_norm", "paged_decode_attention",
                   "varlen_flash_attention")
GENERATE_KERNELS = ("rms_norm", "flash_attention", "decode_attention")
# the same paths of an f32 model (phases 4 and 6): the f32 forwards
SERVING_F32_KERNELS = ("rms_norm", "paged_decode_attention",
                       "varlen_flash_attention_f32")
GENERATE_F32_KERNELS = ("rms_norm", "flash_attention_f32",
                        "decode_attention")
TRAIN_KERNELS = ("rms_norm_bwd", "flash_attention_bwd")
# phase 18: (a) LoRA under amp O2 bf16 (K1 and K6 run their f32 arms:
# rms_norm is black-listed), (c) under O1 fp16
LORA_KERNELS = ("rms_norm", "rms_norm_bwd", "flash_attention",
                "flash_attention_bwd")
LORA_FP16_KERNELS = ("flash_attention_f16", "flash_attention_bwd_f16")
TRAIN_F32_KERNELS = ("rms_norm_bwd", "flash_attention_f32",
                     "flash_attention_bwd_f32")
PACKED_KERNELS = ("varlen_flash_attention_bwd",)
PACKED_F32_KERNELS = ("varlen_flash_attention_f32",
                      "varlen_flash_attention_bwd_f32")
INT8_SERVING_KERNELS = ("rms_norm", "varlen_flash_attention",
                        "paged_decode_attention_int8_rows")
STATIC_INT8_KERNELS = ("paged_decode_attention_int8",
                       "varlen_flash_attention_f32")
SCALED_FLOAT_KERNELS = ("paged_decode_attention_scaled",)
# the path whose run gives each kernel's launches in the kernels line
KERNEL_PATH = {"flash_attention_f16": "lora_fp16",
               "flash_attention_bwd_f16": "lora_fp16",
               "flash_attention_bwd_f32": "train_f32_parity",
               "flash_attention_f32": "train_f32_parity",
               "varlen_flash_attention_bwd_f32": "packed_f32_parity",
               "varlen_flash_attention_f32": "packed_f32_parity",
               "paged_decode_attention_int8": "block_mha_static_int8",
               "paged_decode_attention_int8_rows": "int8_serving",
               "paged_decode_attention_scaled": "scaled_float_decode"}


def run_kernel_case(torch, case):
    """Hold one case's kernel to its plain version and time the kernel,
    the plain version and the library call(s). Emits the record, fails on
    a disagreement and returns the record."""
    out = case["kernel"]()
    ref = case["plain"]()
    torch.cuda.synchronize()
    err, ok, tol = close(torch, out, ref, case["dtype"],
                         "flash_attention" in case["name"])
    del out, ref
    ms, ms_timer = device_ms(torch, case["kernel"])
    plain_ms, plain_timer = device_ms(torch, case["plain"], iters=3)
    # several library calls compute the same function: the fastest one is
    # the yardstick, and the record says which
    libs = case["library"]
    if not isinstance(libs, dict):
        libs = {"library": libs}
    lib_times = {k: device_ms(torch, fn) for k, fn in libs.items()}
    lib_call = min(lib_times, key=lambda k: lib_times[k][0])
    lib_ms, lib_timer = lib_times[lib_call]
    rec = {"phase": "kernel_check", "name": case["name"],
           "dtype": str(case["dtype"]).removeprefix("torch."),
           "shape": case["shape"], "max_abs_err": err, "tol": tol,
           "ok": ok, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "timers": {"ms": ms_timer, "plain_ms": plain_timer,
                      "library_ms": lib_timer},
           "event_ms": cuda_ms(torch, case["kernel"]),
           "bound_ms": case["bound"][0], "bound_by": case["bound"][1],
           # the share of the card's peak the kernel reaches, and its time
           # over the library call's
           "bound_share": case["bound"][0] / ms, "vs_library": ms / lib_ms}
    if len(libs) > 1:
        rec["library_call"] = lib_call
        rec["library_calls_ms"] = {k: v[0] for k, v in lib_times.items()}
    emit(rec)
    check(ok, f"{case['name']} disagrees with its plain version: {rec}")
    return rec


def all_kernel_cases(torch, dev):
    """Every case of phase 2, one at a time, from one seeded generator."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    return itertools.chain(k1_cases(torch, g, dev), k2_cases(torch, g, dev),
                           k2_int8_cases(torch, g, dev),
                           k3_cases(torch, g, dev), k4_cases(torch, g, dev),
                           k4_unet_cases(torch, g, dev),
                           k5_cases(torch, g, dev), k6_cases(torch, g, dev),
                           k7_cases(torch, g, dev), k8_cases(torch, g, dev),
                           k47_transformer_cases(torch, g, dev))


def kernel_phase(torch, dev):
    primary = {}
    # one case at a time: each case's inputs live only while it runs
    for case in all_kernel_cases(torch, dev):
        rec = run_kernel_case(torch, case)
        if case["primary"]:
            primary[case.get("row", case["name"])] = rec
        del case
    torch.cuda.empty_cache()
    return primary


def run_kernel_cases(torch, dev, keep):
    """Phase 2's cases for which ``keep(case)`` holds, on phase 2's own
    seeded inputs (a phase run alone checks its kernels' shapes)."""
    for case in all_kernel_cases(torch, dev):
        if keep(case):
            run_kernel_case(torch, case)
        del case
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 3, 4
def make_requests(vocab, n=16):
    import numpy as np

    rng = np.random.RandomState(SEED)
    lens = np.exp(rng.uniform(math.log(64), math.log(512), n)).astype(int)
    max_new = rng.randint(32, 65, n)
    return [dict(prompt=rng.randint(1, vocab, int(ln)).astype(np.int32),
                 max_new_tokens=int(mn)) for ln, mn in zip(lens, max_new)]


def serve(torch, model, requests, residency_at=None, on_engine=None,
          eager=False, **kw):
    """Drive ``requests`` through a fresh engine; returns the engine, the
    requests, the wall time and the mixed-step / decode-dispatch time
    split (with ``residency_at``, also the pool's bytes in use after that
    step). ``on_engine`` is called with the engine before the run;
    ``eager`` runs the quantum's body eagerly (the oracle of the captured
    graph, the engine's decode path on the card)."""
    from paddle_tpu_torch import create_serving_engine

    engine = create_serving_engine(model, **serve_kw(**kw))
    engine._eager = eager
    if on_engine is not None:
        on_engine(engine)
    # the peak from here on: weights, pools and the run (not the sweep of
    # a model that the engine quantized)
    torch.cuda.reset_peak_memory_stats()
    split = {"mixed_s": 0.0, "decode_s": 0.0}
    if residency_at is not None:
        step, steps = engine.step, [0]

        def counted():
            more = step()
            steps[0] += 1
            if steps[0] == residency_at:
                split["pool_bytes"] = engine.pool.bytes_in_use()
            return more

        engine.step = counted

    def timed(fn, key):
        def run():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
        return run

    engine._mixed_step = timed(engine._mixed_step, "mixed_s")
    dispatch, collect = engine._decode_dispatch, engine._decode_collect

    def timed_dispatch():
        t0 = time.perf_counter()
        pending = dispatch()
        pending["smoke_t0"] = t0
        return pending

    def timed_collect(pending):
        collect(pending)
        torch.cuda.synchronize()
        split["decode_s"] += time.perf_counter() - pending["smoke_t0"]

    engine._decode_dispatch = timed_dispatch
    engine._decode_collect = timed_collect
    if engine.spec_draft is not None:
        # a speculative round runs to completion inside step_dispatch
        engine._spec_round_step = timed(engine._spec_round_step, "decode_s")
    reqs = [engine.submit(**r) for r in requests]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return engine, reqs, wall, split


def check_run(engine, reqs, vocab):
    for r in reqs:
        check(r.finished and r.finish_reason == "length"
              and len(r.tokens) == r.max_new_tokens,
              f"request {r.req_id} ended {r.finish_reason} with "
              f"{len(r.tokens)}/{r.max_new_tokens} tokens")
        check(all(0 <= t < vocab for t in r.tokens),
              f"request {r.req_id} emitted a token outside the vocabulary")
    # the scratch block, and the blocks a prefix cache holds (in the
    # draft's pool too)
    for pool in engine._pools():
        st = pool.fragmentation_stats()
        check(st["blocks_in_use"] == 1 + pool.cached_blocks,
              f"pool did not drain to the scratch block: {st}")


def e2e_phase(torch, dev, smi):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    requests = make_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    engine, reqs, wall, split = serve(torch, model, requests)
    launches = dict(ops.LAUNCHES)
    for name in SERVING_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the serving path")
    check(engine._graph is not None,
          "the serving path's decode quantum did not run as a graph")
    check_run(engine, reqs, cfg.vocab_size)
    want = [list(r.tokens) for r in reqs]
    st = engine.engine_stats()
    gen = sum(len(r.tokens) for r in reqs)
    emit({"phase": "e2e_llama2_7b_bf16", "layers": cfg.num_hidden_layers,
          "requests": len(reqs), "prompt_tokens": sum(
              len(r["prompt"]) for r in requests),
          "generated_tokens": gen, "wall_s": wall,
          "generated_tok_per_s": gen / wall,
          "prefill_tok_per_s": st["prefill_tokens"] / split["mixed_s"],
          "mixed_step_s": split["mixed_s"], "decode_quanta_s": split[
              "decode_s"], "mixed_steps": st["mixed_steps"],
          "decode_quanta": st["decode_quanta"],
          "decode_steps": st["decode_quanta"] * engine.config.decode_quantum,
          "decode_graph_launches_per_replay": engine._graph.launches,
          "prefill_tokens": st["prefill_tokens"], "launches": launches,
          "model_init_s": init_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    del engine
    # the same requests sampled: the per-step draw's cost beside greedy
    sampled = [dict(r, seed=i) for i, r in enumerate(requests)]
    engine, reqs, swall, ssplit = serve(torch, model, sampled, **SAMPLING)
    check_run(engine, reqs, cfg.vocab_size)
    st = engine.engine_stats()
    emit({"phase": "e2e_llama2_7b_bf16_sampling", **SAMPLING,
          "generated_tokens": sum(len(r.tokens) for r in reqs),
          "wall_s": swall, "greedy_wall_s": wall,
          "generated_tok_per_s": gen / swall,
          "mixed_step_s": ssplit["mixed_s"],
          "decode_quanta_s": ssplit["decode_s"],
          "greedy_decode_quanta_s": split["decode_s"],
          "mixed_steps": st["mixed_steps"],
          "decode_quanta": st["decode_quanta"]})
    del engine
    profile_phase(torch, model, requests)
    profile_phase(torch, model, sampled, labels=("decode_quantum",),
                  tag="_sampling", **SAMPLING)
    # phase 14 on the same model: no second 7B model is built
    prefix_launches = prefix_phase(torch, dev, smi, model)
    # phases 16 and 17 on it too, before phase 15
    door_launches = frontdoor_phase(torch, dev, smi, model, requests)
    res_launches = resilience_phase(torch, dev, smi, model, requests, want)
    # phase 15 last on it: its stand-in draft scales the model's tails
    spec_launches = spec_phase(torch, dev, smi, model, requests)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {**prefix_launches, **door_launches, **res_launches,
                      **spec_launches}


def _kernel_family(name):
    # K6 is two launches: the row pass (rms_norm_bwd_rows_kernel, or
    # rms_norm_bwd_any_kernel off the vector path) and the dw reduction
    for key, fam in (("nccl", "NCCL collectives"),
                     ("Memcpy", "memcpy"),
                     ("rms_norm_bwd_", "K6 rms_norm_bwd"),
                     ("rms_norm_dw_kernel", "K6 rms_norm_bwd"),
                     ("rms_norm_kernel", "K1 rms_norm"),
                     ("varlen_bwd_fused_f32",
                      "K8 f32 varlen_flash_attention_bwd_f32"),
                     ("varlen_bwd_fused_", "K8 varlen_flash_attention_bwd"),
                     ("tile_order_kernel", "K3 tile order"),
                     ("bwd_fused_f32", "K7 f32 flash_attention_bwd_f32"),
                     ("bwd_fused_", "K7 flash_attention_bwd"),
                     ("PagedRows<1>", "K2-int8 static"),
                     ("PagedRows<2>", "K2-int8 rows"),
                     ("PagedRows", "K2 paged_decode"),
                     ("varlen_fwd_", "K3 varlen_flash"),
                     ("flash_fwd_", "K4 flash_attention"),
                     ("ContiguousRows", "K5 decode_attention"),
                     ("gemm", "matmul"), ("nvjet", "matmul"),
                     ("cutlass", "matmul"), ("xmma", "matmul")):
        if key in name:
            return fam
    return "other"


def profile_phase(torch, model, requests,
                  labels=("mixed_step", "decode_quantum"), tag="",
                  eager=False, **kw):
    """Where one mixed step and one decode quantum spend device time:
    torch.profiler over a single engine step each (the main run's counts
    are read before this). Device busy share = summed kernel time over the
    step's wall time under the profiler. The quantum profiled is a replay
    of its captured graph (the first decode step, which captures it, runs
    before), or with ``eager`` its body run eagerly. A weight-only int8
    model's dequantization runs under its own record_function range and is
    reported as "dequant" (its kernels are elementwise ones, named like
    "other"); a replay runs no Python, so only an eager profile splits it
    out."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch import create_serving_engine
    from paddle_tpu_torch.nn.quant import QuantizedLinear

    dequant = QuantizedLinear.dequantized_weight

    def traced_dequant(self, dtype):
        with record_function("dequant"):
            return dequant(self, dtype)

    engine = create_serving_engine(model, **serve_kw(**kw))
    engine._eager = eager
    for r in requests[:8]:
        engine.submit(**r)
    for label in labels:
        if label == "decode_quantum":
            # admission happens inside step(): run until every admitted
            # request has finished its prefill, then one decode step (the
            # capture)
            while (engine.scheduler.prefilling()
                   or not engine.scheduler.decoding()):
                engine.step()
            engine.step()
            check(eager or engine._graph is not None,
                  "the decode quantum was not captured")
        torch.cuda.synchronize()
        QuantizedLinear.dequantized_weight = traced_dequant
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                engine.step()
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
        finally:
            QuantizedLinear.dequantized_weight = dequant
        rec = _profile_record(torch, prof, label + tag, wall_us,
                              ranges=("dequant",))
        if kw.get("quantize"):
            rec["dequant_device_ms"] = _split_range(torch, prof, rec,
                                                    "dequant", "dequant")
        emit(rec)
    del engine


def _profile_record(torch, prof, label, wall_us, ranges=()):
    """Device time by kernel family. ``ranges`` names record_function
    ranges: their device-side annotation spans are no kernels and are
    left out of the sums."""
    fams, n_kernels = {}, 0
    for ev in prof.key_averages():
        dev_us = _device_us(ev)
        if ev.key in ranges:
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            fam = _kernel_family(ev.key)
            fams[fam] = fams.get(fam, 0.0) + dev_us
            n_kernels += ev.count
    busy = sum(fams.values())
    return {"phase": "profile", "step": label,
            "wall_ms_under_profiler": wall_us / 1e3,
            "device_ms": busy / 1e3 if busy else "not measured",
            "device_busy_share": busy / wall_us if busy else "not measured",
            "kernels_launched": n_kernels,
            "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
                fams.items(), key=lambda kv: -kv[1])}}


def serve_kw(**kw):
    return dict(num_slots=8, block_size=32, max_context=2048,
                prefill_chunk=128, decode_quantum=8, **kw)


def parity_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=4, dtype="float32")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    requests = make_requests(cfg.vocab_size)
    streams, launches = [], []
    for plain in (False, True):
        ops.reset_launches()
        if plain:
            with ops.plain_versions():
                engine, reqs, wall, _ = serve(torch, model, requests)
        else:
            engine, reqs, wall, _ = serve(torch, model, requests)
        check_run(engine, reqs, cfg.vocab_size)
        streams.append([list(r.tokens) for r in reqs])
        launches.append(dict(ops.LAUNCHES))
        emit({"phase": "parity_f32_4layer", "path": "plain" if plain
              else "kernels", "wall_s": wall, "launches": launches[-1]})
        del engine
    check(all(launches[0][k] > 0 for k in SERVING_F32_KERNELS)
          and launches[0]["varlen_flash_attention"] == 0,
          f"kernel path missed a kernel: {launches[0]}")
    check(all(n == 0 for n in launches[1].values()),
          f"plain path launched a kernel: {launches[1]}")
    same = [a == b for a, b in zip(*streams)]
    emit({"phase": "parity_f32_4layer", "streams_equal": all(same),
          "requests_equal": sum(same), "requests": len(same)})
    check(all(same), "kernel and plain greedy streams differ")
    # fixed-seed sampling serving, twice: the same streams
    sampled = []
    for _ in range(2):
        engine, reqs, wall, _ = serve(
            torch, model, [dict(r, seed=i) for i, r in enumerate(requests)],
            **SAMPLING)
        check_run(engine, reqs, cfg.vocab_size)
        sampled.append([list(r.tokens) for r in reqs])
        del engine
    emit({"phase": "sampling_serving_f32_4layer", "wall_s": wall,
          "streams_equal": sampled[0] == sampled[1],
          "differs_from_greedy": sum(a != b for a, b in
                                     zip(sampled[0], streams[0]))})
    check(sampled[0] == sampled[1], "fixed-seed sampling streams differ")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 5, 6
def _mistral_prompts(vocab, b, s):
    import numpy as np

    return np.random.RandomState(SEED).randint(1, vocab, (b, s))


def _timed_generate(torch, model, ids, eager=False, logits=False, **kw):
    """``model.generate`` timed: CUDA events at its start, after the
    prefill forward (run inside the record_function range
    "generate_prefill") and at its end, and the host's clock when the
    prefill returns and when generate returns. Returns the output, the
    wall, prefill and decode seconds with the host's decode seconds (the
    time to enqueue the decode steps), and, with ``logits``, each
    forward's last-position logits (call 0 the prefill; only eager
    steps run a forward in Python). The decode step runs as the entry
    point's captured graph, or with ``eager`` as eager steps on buffers
    of the call's own."""
    from torch.profiler import record_function
    from paddle_tpu_torch.nlp import generation

    calls = []
    orig = model.forward

    def forward(*args, **kwargs):
        if calls:
            out = orig(*args, **kwargs)
        else:
            with record_function("generate_prefill"):
                out = orig(*args, **kwargs)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        calls.append((ev, out[0][:, -1].clone() if logits else None,
                      time.perf_counter()))
        if not logits:
            del model.forward   # a capture must record no event
        return out

    model.forward = forward
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prev, generation._EAGER = generation._EAGER, eager
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = model.generate(ids, **kw)
        t_ret = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        generation._EAGER = prev
        model.__dict__.pop("forward", None)
    timing = {"wall_s": wall,
              "prefill_s": start.elapsed_time(calls[0][0]) / 1e3,
              "decode_s": calls[0][0].elapsed_time(end) / 1e3,
              "host_decode_s": t_ret - calls[0][2],
              "decode_steps": kw["max_new_tokens"] - 1}
    return out, timing, [lg for _, lg, _ in calls]


def _same_up_to_ties(torch, greedy, sampled, logits, s_in):
    """Row by row, the top_k=1 sampled stream equals the greedy one until
    a step whose greedy logits tie at the maximum; there the sampled token
    must be one of the tied maxima (the two runs shared every earlier
    token, so they saw the same logits), and the rows may part. Returns
    (rows equal, ties met) or raises."""
    equal = ties = 0
    for r in range(greedy.shape[0]):
        diff = (greedy[r, s_in:] != sampled[r, s_in:]).nonzero()
        if diff.numel() == 0:
            equal += 1
            continue
        t = int(diff[0])
        lg = logits[t][r].float()
        check(lg[greedy[r, s_in + t]] == lg.max()
              and lg[sampled[r, s_in + t]] == lg.max(),
              f"row {r}: top_k=1 sampling left greedy at step {t} without "
              f"an argmax tie")
        ties += 1
    return equal, ties


def generate_phase(torch, dev, smi):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.mistral_7b(dtype="bfloat16")
    b, s_in, new = GENERATE_SHAPE
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    model.eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.from_numpy(_mistral_prompts(cfg.vocab_size, b, s_in)).to(dev)
    layers = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, timing, _ = _timed_generate(torch, model, ids, max_new_tokens=new)
    launches = dict(ops.LAUNCHES)
    steps = new - 1
    want = dict.fromkeys(launches, 0)
    want.update({"flash_attention": layers,
                 "decode_attention": layers * steps,
                 "rms_norm": (2 * layers + 1) * new})
    check(launches == want, f"generate launches {launches}, expected {want}")
    check(tuple(out.shape) == (b, s_in + new)
          and bool((out[:, :s_in] == ids).all())
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"generate returned {tuple(out.shape)} or ids outside the vocab")
    # the eager steps: the captured graph's oracle, and the logits of
    # every step for the top_k=1 run's tie check
    eager_out, eager_timing, logits = _timed_generate(
        torch, model, ids, eager=True, logits=True, max_new_tokens=new)
    same = bool(torch.equal(out, eager_out))
    del eager_out
    emit({"phase": "e2e_mistral_7b_bf16_generate", "layers": layers,
          "batch": b, "prompt_tokens": s_in, "new_tokens": new,
          "window": cfg.sliding_window, **timing,
          "captured_equals_eager": same,
          "eager_decode_s": eager_timing["decode_s"],
          "prefill_tok_per_s": b * s_in / timing["prefill_s"],
          "decode_tok_per_s": b * steps / timing["decode_s"],
          "generated_tok_per_s": b * new / timing["wall_s"],
          "launches": launches, "model_init_s": init_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    check(same, "generate's captured decode steps part from the eager ones")
    sampled, stiming, _ = _timed_generate(
        torch, model, ids, max_new_tokens=new, decode_strategy="sampling",
        top_k=1, seed=7)
    equal, ties = _same_up_to_ties(torch, out, sampled, logits, s_in)
    emit({"phase": "e2e_mistral_7b_bf16_sampling_top_k_1",
          "wall_s": stiming["wall_s"], "rows_equal_to_greedy": equal,
          "rows_parted_at_an_argmax_tie": ties, "rows": b})
    del logits, sampled
    generate_graphs(torch, model, ids, smi)
    generate_profile(torch, model, ids)
    del model
    torch.cuda.empty_cache()
    return launches


def _generate_timing(torch, model, ids, eager, timed=2):
    """Greedy ``generate`` through its entry point, its decode steps
    eager or replays of the step the entry point captured and kept: one
    call to warm up (the captured arm's capture; the eager arm runs after
    phase 5's calls and has none), ``timed`` calls timed
    (``_timed_generate``), one under torch.profiler. Per decode step and
    timed call: the stream's ms between the events after the prefill
    and at the end (the decode's wall on the card) and the host's ms to
    enqueue it; the device ms (the profiled call's kernels outside the
    prefill's range) with its share of the last timed call's stream
    ms."""
    from torch.profiler import ProfilerActivity, profile

    new = GENERATE_SHAPE[2]
    if not eager:   # the eager arm captures nothing to warm up
        _timed_generate(torch, model, ids, eager=eager, max_new_tokens=new)
    runs = [_timed_generate(torch, model, ids, eager=eager,
                            max_new_tokens=new)[1] for _ in range(timed)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _timed_generate(torch, model, ids, eager=eager, max_new_tokens=new)
        wall_us = 1e6 * (time.perf_counter() - t0)
    rec = _profile_record(torch, prof, "generate", wall_us,
                          ranges=("generate_prefill",))
    prefill = _split_range(torch, prof, rec, "generate_prefill", "prefill")
    steps = new - 1
    stream = [1e3 * t["decode_s"] / steps for t in runs]
    measured = "not measured" not in (rec["device_ms"], prefill)
    dev_ms = ((rec["device_ms"] - prefill) / steps if measured
              else "not measured")
    return {"stream_ms_per_step": stream,
            "host_ms_per_step": [1e3 * t["host_decode_s"] / steps
                                 for t in runs],
            "device_ms_per_step": dev_ms,
            "device_busy_share": (dev_ms / stream[-1] if measured
                                  else "not measured"),
            "replays": 0 if eager else steps, "steps": steps,
            "call_wall_s": [t["wall_s"] for t in runs],
            "prefill_s": [t["prefill_s"] for t in runs],
            "profiled_prefill_device_ms": prefill}


def generate_graphs(torch, model, ids, smi):
    """Phase 13 (generate): ``sampling_search`` with its decode step
    captured against eager (equal streams), then greedy ``generate``
    through its entry point, eager and captured (``_generate_timing``)."""
    from paddle_tpu_torch.nlp import generation

    new = GENERATE_SHAPE[2]
    outs, walls = [], []
    for eager in (True, False):
        prev, generation._EAGER = generation._EAGER, eager
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(generation.sampling_search(
                model, ids, max_new_tokens=new, seed=11, top_k=50,
                top_p=0.9, temperature=0.8))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        finally:
            generation._EAGER = prev
    same = bool(torch.equal(outs[0], outs[1]))
    b, s_in = ids.shape
    timing = {("eager" if eager else "captured"):
              _generate_timing(torch, model, ids, eager)
              for eager in (True, False)}
    emit({"phase": "graphs_mistral_7b_generate", "gpu": smi,
          "batch": b, "prompt_tokens": s_in, "new_tokens": new,
          "sampling_search_captured_equals_eager": same,
          "sampling_search_wall_s": {"eager": walls[0],
                                     "captured": walls[1]},
          "generate_decode": timing})
    check(same, "sampling_search: captured and eager streams differ")
    del outs


def generate_profile(torch, model, ids):
    """Where one Mistral prefill and one decode step spend device time."""
    from torch.profiler import ProfilerActivity, profile

    b, s_in = ids.shape
    with torch.no_grad():
        caches = model.init_caches(b, s_in + 2)
        for label in ("generate_prefill", "generate_decode_step"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if label == "generate_prefill":
                    logits, caches = model(ids, 0, caches)
                else:
                    logits, caches = model(tok, s_in, caches)
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            emit(_profile_record(torch, prof, label, wall_us))
    del caches


def generate_parity_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.mistral_7b(num_hidden_layers=4, dtype="float32")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    model.eval()
    b, s_in, new = GENERATE_PARITY_SHAPE
    ids = torch.from_numpy(_mistral_prompts(cfg.vocab_size, b, s_in)).to(dev)
    outs, launches = [], []
    for plain in (False, True):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if plain:
            with ops.plain_versions():
                outs.append(model.generate(ids, max_new_tokens=new))
        else:
            outs.append(model.generate(ids, max_new_tokens=new))
        torch.cuda.synchronize()
        launches.append(dict(ops.LAUNCHES))
        emit({"phase": "generate_parity_f32_4layer",
              "path": "plain" if plain else "kernels",
              "wall_s": time.perf_counter() - t0, "launches": launches[-1]})
    check(all(launches[0][k] > 0 for k in GENERATE_F32_KERNELS)
          and launches[0]["flash_attention"] == 0,
          f"generate kernel path missed a kernel: {launches[0]}")
    check(all(n == 0 for n in launches[1].values()),
          f"generate plain path launched a kernel: {launches[1]}")
    same = bool(torch.equal(outs[0], outs[1]))
    emit({"phase": "generate_parity_f32_4layer", "streams_equal": same})
    check(same, "generate kernel and plain greedy streams differ")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 7, 8
def _train_setup(torch, dev, cfg, seed):
    """bench.py's training setup on the port: model, criterion (the
    unfused one on f32 logits), AdamW with f32 master weights for a bf16
    model, and the step."""
    from paddle_tpu_torch.jit import JittedTrainStep
    from paddle_tpu_torch.nlp import (LlamaForCausalLM,
                                      LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed))
    fused = cfg.fuse_linear_cross_entropy
    crit = LlamaPretrainingCriterion(cfg,
                                     lm_head=model.lm_head if fused else None)
    bf16 = cfg.dtype == "bfloat16"
    opt = AdamW(1e-4, parameters=model.named_parameters(), weight_decay=0.01,
                multi_precision=bf16,
                moment_dtype="bfloat16" if bf16 else "float32")
    step = JittedTrainStep(
        model, crit if fused else (lambda out, lb: crit(out.float(), lb)),
        opt)
    return model, step


def _train_ids(torch, dev, vocab, b, s):
    import numpy as np

    return torch.from_numpy(
        np.random.RandomState(SEED).randint(0, vocab, (b, s))).to(dev)


TRAIN_RECORD = {}  # phase 7's losses and speed, for phase 22
RESNET_RECORD = {}  # phase 20's ResNet-50 speed, for phase 23
QUANTUM_RECORD = {}  # phase 13's decode dispatch timing, for phase 25


def train_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig
    from paddle_tpu_torch.profiler import MFUMeter, transformer_train_flops

    b, seq, warm, steps = TRAIN_SHAPE
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=4, tensor_parallel=False,
                                dtype="bfloat16")
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model, step = _train_setup(torch, dev, cfg, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = _train_ids(torch, dev, cfg.vocab_size, b, seq)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = b * seq
    flops = transformer_train_flops(n_params, tokens, num_layers=layers,
                                    seq_len=seq, hidden=cfg.hidden_size)
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids, ids) for _ in range(warm)]
    stacked = ids[None].expand(steps, b, seq)
    ops.reset_launches()
    meter = MFUMeter(flops * steps, tokens * steps)
    timed = []
    res = meter.measure(lambda: timed.append(step.run_steps(stacked,
                                                            stacked)),
                        warmup=0, iters=1)
    launches = dict(ops.LAUNCHES)
    per_step = {"rms_norm": 2 * layers + 1, "flash_attention": layers,
                "rms_norm_bwd": 2 * layers + 1,
                "flash_attention_bwd": layers}
    want = {k: per_step.get(k, 0) * steps for k in launches}
    check(launches == want, f"train launches {launches}, expected {want}")
    losses = torch.cat([torch.stack(losses), timed[0]]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses}")
    check(float(losses[-1]) < float(losses[0]),
          f"the loss did not fall over {len(losses)} steps: {losses}")
    step_s = res["step_time_s"] / steps
    TRAIN_RECORD.update(losses=[float(x) for x in losses],
                        step_ms=1e3 * step_s, tok_per_s=tokens / step_s,
                        mfu=flops / step_s / PEAK_FLOPS["bfloat16"])
    emit({"phase": "train_llama2_7b_width_bf16", "layers": layers,
          "params": n_params, "batch": b, "seq": seq,
          "warmup_steps": warm, "timed_steps": steps, "step_ms": 1e3 * step_s,
          "train_tok_per_s": tokens / step_s,
          "model_tflops_per_step": flops / 1e12,
          "model_tflop_per_s": flops / step_s / 1e12,
          "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "mfu_meter": res["mfu"], "losses": [float(x) for x in losses],
          "launches": launches, "model_init_s": init_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    train_profile(torch, step, ids, ids)
    unfused_loss1 = float(losses[0])
    del model, step, timed, stacked
    torch.cuda.empty_cache()

    # the same configuration with the chunked fused lm-head + loss
    fcfg = LlamaConfig.llama2_7b(num_hidden_layers=4, tensor_parallel=False,
                                 dtype="bfloat16",
                                 fuse_linear_cross_entropy=True)
    model, step = _train_setup(torch, dev, fcfg, SEED)
    torch.cuda.reset_peak_memory_stats()
    floss = [float(step(ids, ids)) for _ in range(warm)]
    torch.cuda.synchronize()
    rel = abs(floss[0] - unfused_loss1) / abs(unfused_loss1)
    emit({"phase": "train_llama2_7b_width_bf16_fused_lce",
          "chunk_rows": fcfg.lce_chunk_rows, "losses": floss,
          "unfused_step1_loss": unfused_loss1, "step1_rel_diff": rel,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    check(rel <= 2.0 ** -7, f"fused step-1 loss {floss[0]} is not within "
          f"bf16 rounding of the unfused {unfused_loss1}")
    del model, step
    torch.cuda.empty_cache()
    return launches


def train_profile(torch, step, inputs, labels, label="train_step"):
    """Where one training step spends device time: torch.profiler over a
    single step, the optimizer update under its own record_function range
    (its kernels are elementwise ones that fall under "other" by name)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    opt = step._optimizer
    apply = opt.apply

    def traced_apply(*a, **kw):
        with record_function("optimizer_update"):
            return apply(*a, **kw)

    opt.apply = traced_apply
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(inputs, labels)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    del opt.apply
    rec = _profile_record(torch, prof, label, wall_us,
                          ranges=("optimizer_update",))
    # the update's kernels are elementwise ones, named like "other"
    rec["optimizer_device_ms"] = _split_range(
        torch, prof, rec, "optimizer_update", "optimizer (AdamW update)")
    emit(rec)


def _range_kernels(torch, prof, name):
    """(kernel name, device ms) of each kernel that ran within one of the
    record_function range ``name``'s device-side annotation spans, once
    (the spans themselves are no kernels); None if the range left no
    span."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [ev for ev in prof.events() if ev.device_type == cuda]
    spans = [(ev.time_range.start, ev.time_range.end) for ev in events
             if ev.name == name]
    if not spans:
        return None
    return [(ev.name, (ev.time_range.end - ev.time_range.start) / 1e3)
            for ev in events
            if ev.name != name
            and any(a <= ev.time_range.start and ev.time_range.end <= b
                    for a, b in spans)]


def _split_range(torch, prof, rec, name, family):
    """Move the device time of the kernels that ran inside the
    record_function range ``name`` to ``family`` in a profile record,
    each out of its own family; returns it in ms, or "not measured"."""
    fams = rec["device_ms_by_family"]
    total = 0.0
    for kernel, ms in _range_kernels(torch, prof, name) or ():
        own = _kernel_family(kernel)
        if own in fams:
            fams[own] -= ms
            fams[family] = fams.get(family, 0.0) + ms
        total += ms
    return total if total else "not measured"


def _timed_steps(step, inputs, labels, n):
    """The losses of ``n`` steps and each step's wall ms (reading the loss
    waits for the step's work on the card)."""
    losses, walls = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step(inputs, labels)))
        walls.append(1e3 * (time.perf_counter() - t0))
    return losses, walls


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def train_parity_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig

    seq, steps = TRAIN_PARITY_SHAPE
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, tensor_parallel=False,
                                dtype="float32")
    ids = _train_ids(torch, dev, cfg.vocab_size, 1, seq)
    runs = []
    for plain in (False, True):
        model, step = _train_setup(torch, dev, cfg, SEED + 3)
        ops.reset_launches()
        with (ops.plain_versions() if plain else contextlib.nullcontext()):
            loss = step._criterion(model(ids), ids)
            loss.backward()
            grads = _grads(model)
            model.zero_grad(set_to_none=True)
            losses, walls = _timed_steps(step, ids, ids, steps)
        launches = dict(ops.LAUNCHES)
        emit({"phase": "train_parity_f32_2layer",
              "path": "plain" if plain else "kernels", "seq": seq,
              "losses": losses, "step_wall_ms": walls,
              "launches": launches})
        if not plain:
            # one more step under the profiler: the f32 step's device time
            train_profile(torch, step, ids, ids, label="train_f32_step")
        if plain:
            check(all(n == 0 for n in launches.values()),
                  f"plain training path launched a kernel: {launches}")
        else:
            check(all(launches[k] > 0 for k in TRAIN_F32_KERNELS
                      + ("rms_norm",)),
                  f"training kernel path missed a kernel: {launches}")
            # one f32 forward per attention layer and forward (one loss,
            # then one per step), never the bf16 K4
            check(launches["flash_attention_f32"]
                  == cfg.num_hidden_layers * (1 + steps)
                  and launches["flash_attention"] == 0,
                  f"the f32 forward is not one f32 launch per layer: "
                  f"{launches}")
            # one fused f32 backward per attention layer and backward
            # (one loss.backward, then one per step), never the bf16 K7
            check(launches["flash_attention_bwd_f32"]
                  == cfg.num_hidden_layers * (1 + steps)
                  and launches["flash_attention_bwd"] == 0,
                  f"the f32 backward is not one fused f32 launch per "
                  f"layer: {launches}")
            kernel_launches = launches
        runs.append((grads, losses))
        del model, step, loss
        torch.cuda.empty_cache()
    (gk, lk), (gp, lp) = runs
    worst = max(float((gk[n] - gp[n]).abs().max())
                / max(float(gp[n].abs().max()), 1e-30) for n in gp)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    emit({"phase": "train_parity_f32_2layer", "grad_worst_rel_to_max": worst,
          "loss_worst_rel": loss_rel})
    check(worst <= 1e-4, f"kernel and plain step-1 grads differ: {worst}")
    check(loss_rel <= 1e-4, f"kernel and plain losses differ: {lk} {lp}")
    return kernel_launches


# ----------------------------------------------------------- phase 9, 10
def _packed_cfg(torch, **overrides):
    """The reference's packed configuration, ``scripts/bench_suite.py``'s
    llama_941m_packed_varlen_train_mfu: hidden 2,048, intermediate 5,504,
    16 layers, 32 heads (head dim 64), vocab 32,000, no recompute."""
    from paddle_tpu_torch.nlp import LlamaConfig

    cfg = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
               num_hidden_layers=16, num_attention_heads=32,
               max_position_embeddings=4096, tensor_parallel=False,
               use_recompute=False, dtype="bfloat16")
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def _packed_setup(torch, dev, cfg, seed):
    """The reference benchmark's packed training on the port: the model
    wrapped as ``_Packed`` (``model(ids, cu)``), the unfused packed
    criterion on f32 logits, AdamW with f32 master weights for a bf16
    model (bf16 moments), weight decay 0.01, lr 1e-4, and the step."""
    from paddle_tpu_torch.jit import JittedTrainStep
    from paddle_tpu_torch.nlp import (LlamaForCausalLM,
                                      LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    class Packed(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, cu):
            return self.m(ids, cu_seqlens=cu)

    model = Packed(LlamaForCausalLM(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed)))
    crit = LlamaPretrainingCriterion()
    bf16 = cfg.dtype == "bfloat16"
    opt = AdamW(1e-4, parameters=model.named_parameters(), weight_decay=0.01,
                multi_precision=bf16,
                moment_dtype="bfloat16" if bf16 else "float32")
    step = JittedTrainStep(
        model, lambda out, labels, cu: crit(out.float(), labels,
                                            cu_seqlens=cu), opt)
    return model, step


def _packed_batches(torch, dev, vocab, n, lens):
    """(n, 1, T) token rows and the (n, nseg + 1) int32 cu_seqlens stacked
    beside them, as the reference's packed benchmark feeds ``run_steps``.
    One seeded row (the reference's RandomState(1) draw) repeated, as
    phase 7 repeats its batch: on fresh random rows a randomly initialised
    model's loss only wanders around log(vocab), and a repeated row shows
    the steps learn."""
    import numpy as np

    t = sum(lens)
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, vocab, (1, 1, t))).to(dev)
    cu = torch.tensor([0] + list(_cumsum(lens)), dtype=torch.int32,
                      device=dev)
    return (ids.expand(n, 1, t).contiguous(),
            cu[None].expand(n, -1).contiguous())


def packed_train_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.profiler import MFUMeter, transformer_train_flops

    warm, steps, rsteps = PACKED_TRAIN_STEPS
    cfg = _packed_cfg(torch)
    layers = cfg.num_hidden_layers
    t = sum(PACKED_LENS)
    t0 = time.perf_counter()
    model, step = _packed_setup(torch, dev, cfg, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids, cu = _packed_batches(torch, dev, cfg.vocab_size, warm + steps,
                              PACKED_LENS)
    n_params = sum(p.numel() for p in model.parameters())
    # attention FLOPs scale with sum(len^2): the reference folds them into
    # an effective sequence length (bench_suite.py)
    eff_seq = sum(ln * ln for ln in PACKED_LENS) / t
    flops = transformer_train_flops(n_params, t, num_layers=layers,
                                    seq_len=eff_seq, hidden=cfg.hidden_size,
                                    causal=True)
    torch.cuda.reset_peak_memory_stats()
    losses = [step([ids[i], cu[i]], [ids[i], cu[i]]) for i in range(warm)]
    ops.reset_launches()
    meter = MFUMeter(flops * steps, t * steps)
    timed = []
    res = meter.measure(lambda: timed.append(step.run_steps(
        [ids[warm:], cu[warm:]], [ids[warm:], cu[warm:]])), warmup=0,
        iters=1)
    launches = dict(ops.LAUNCHES)
    per_step = {"rms_norm": 2 * layers + 1, "rms_norm_bwd": 2 * layers + 1,
                "varlen_flash_attention": layers,
                "varlen_flash_attention_bwd": layers}
    want = {k: per_step.get(k, 0) * steps for k in launches}
    check(launches == want,
          f"packed train launches {launches}, expected {want}")
    losses = torch.cat([torch.stack(losses), timed[0]]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses}")
    check(float(losses[-1]) < float(losses[0]),
          f"the loss did not fall over {len(losses)} steps: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = res["step_time_s"] / steps
    emit({"phase": "train_llama_941m_packed_bf16", "layers": layers,
          "params": n_params, "segments": PACKED_LENS, "tokens": t,
          "eff_seq": eff_seq, "warmup_steps": warm, "timed_steps": steps,
          "step_ms": 1e3 * step_s, "train_tok_per_s": t / step_s,
          "model_tflops_per_step": flops / 1e12,
          "model_tflop_per_s": flops / step_s / 1e12,
          "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "mfu_meter": res["mfu"], "losses": [float(x) for x in losses],
          "launches": launches,
          "launches_per_step": {k: v / steps for k, v in launches.items()},
          "model_init_s": init_s, "peak_mem_gb": peak})
    train_profile(torch, step, [ids[0], cu[0]], [ids[0], cu[0]],
                  label="packed_train_step")
    del model, step, timed
    torch.cuda.empty_cache()

    # the same configuration with full recompute, from the same weights
    # and batches: the same losses, a lower peak, K1 and K3 run again
    model, step = _packed_setup(
        torch, dev, _packed_cfg(torch, use_recompute=True,
                                recompute_granularity="full"), SEED)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rlosses = step.run_steps([ids[:rsteps], cu[:rsteps]],
                             [ids[:rsteps], cu[:rsteps]]).float().cpu()
    torch.cuda.synchronize()
    rlaunches = dict(ops.LAUNCHES)
    rpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step.update(rms_norm=4 * layers + 1, varlen_flash_attention=2 *
                    layers)
    rwant = {k: per_step.get(k, 0) * rsteps for k in rlaunches}
    diff = float((rlosses - losses[:rsteps]).abs().max())
    emit({"phase": "train_llama_941m_packed_bf16_recompute_full",
          "steps": rsteps, "losses": [float(x) for x in rlosses],
          "no_recompute_losses": [float(x) for x in losses[:rsteps]],
          "losses_bit_equal": bool(torch.equal(rlosses, losses[:rsteps])),
          "max_loss_diff": diff, "peak_mem_gb": rpeak,
          "no_recompute_peak_mem_gb": peak, "launches": rlaunches,
          "launches_per_step": {k: v / rsteps for k, v in rlaunches.items()}})
    check(rlaunches == rwant,
          f"recompute launches {rlaunches}, expected {rwant}")
    check(diff <= 2.0 ** -7 * float(losses[:rsteps].abs().max()),
          f"recompute losses {rlosses} part from {losses[:rsteps]}")
    check(rpeak < peak, f"recompute peak {rpeak} GiB is not below {peak}")
    del model, step
    torch.cuda.empty_cache()
    return launches


def packed_parity_phase(torch, dev):
    from paddle_tpu_torch import ops

    lens, steps = PACKED_PARITY
    cfg = _packed_cfg(torch, num_hidden_layers=2, dtype="float32")
    ids, cu = _packed_batches(torch, dev, cfg.vocab_size, 1, lens)
    inputs = [ids[0], cu[0]]
    runs = []
    for plain in (False, True):
        model, step = _packed_setup(torch, dev, cfg, SEED + 4)
        ops.reset_launches()
        with (ops.plain_versions() if plain else contextlib.nullcontext()):
            loss = step._criterion(model(*inputs), *inputs)
            loss.backward()
            grads = _grads(model)
            model.zero_grad(set_to_none=True)
            losses, walls = _timed_steps(step, inputs, inputs, steps)
        launches = dict(ops.LAUNCHES)
        emit({"phase": "train_packed_parity_f32_2layer",
              "path": "plain" if plain else "kernels", "segments": lens,
              "losses": losses, "step_wall_ms": walls,
              "launches": launches})
        if not plain:
            # one more step under the profiler: the f32 step's device time
            train_profile(torch, step, inputs, inputs,
                          label="packed_f32_step")
        if plain:
            check(all(n == 0 for n in launches.values()),
                  f"plain packed path launched a kernel: {launches}")
        else:
            check(all(launches[k] > 0 for k in PACKED_F32_KERNELS + (
                "rms_norm", "rms_norm_bwd")),
                  f"packed kernel path missed a kernel: {launches}")
            # one f32 forward per attention layer and forward, never the
            # bf16 K3
            check(launches["varlen_flash_attention_f32"]
                  == cfg.num_hidden_layers * (1 + steps)
                  and launches["varlen_flash_attention"] == 0,
                  f"the f32 packed forward is not one f32 launch per "
                  f"layer: {launches}")
            # one fused f32 backward per attention layer and backward,
            # never the bf16 K8
            check(launches["varlen_flash_attention_bwd_f32"]
                  == cfg.num_hidden_layers * (1 + steps)
                  and launches["varlen_flash_attention_bwd"] == 0,
                  f"the f32 packed backward is not one fused f32 launch "
                  f"per layer: {launches}")
            kernel_launches = launches
        runs.append((grads, losses))
        del model, step, loss
        torch.cuda.empty_cache()
    (gk, lk), (gp, lp) = runs
    worst = max(float((gk[n] - gp[n]).abs().max())
                / max(float(gp[n].abs().max()), 1e-30) for n in gp)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    emit({"phase": "train_packed_parity_f32_2layer",
          "grad_worst_rel_to_max": worst, "loss_worst_rel": loss_rel})
    check(worst <= 1e-5, f"packed kernel and plain grads differ: {worst}")
    check(loss_rel <= 1e-6,
          f"packed kernel and plain losses differ: {lk} {lp}")
    return kernel_launches


# ---------------------------------------------------------- phase 11, 12
INT8_ARMS = (("w8", dict(quantize="weight_only_int8")),
             ("float_dequantized", {}),
             ("w8kv8", dict(quantize="weight_only_int8", kv_dtype="int8")))
# the engine step after which each arm's pool residency is read (the arms
# schedule identically: no eos, the same token counts)
RESIDENCY_STEP = 8


def _dequantized_float_model(torch, qmodel):
    """The float oracle of a weight-only int8 model: a copy whose every
    QuantizedLinear is a float Linear holding the dequantized product it
    multiplies by (in the model's dtype), so the same cuBLAS products
    run."""
    import copy

    from paddle_tpu_torch.nn.quant import QuantizedLinear

    model = copy.deepcopy(qmodel)
    dtype = model.config.torch_dtype
    for mod in list(model.modules()):
        for name, sub in list(mod.named_children()):
            if isinstance(sub, QuantizedLinear):
                lin = torch.nn.Linear(sub.in_features, sub.out_features,
                                      bias=sub.bias is not None,
                                      device=sub.quant_weight.device,
                                      dtype=dtype)
                with torch.no_grad():
                    lin.weight.copy_(sub.dequantized_weight(dtype))
                    if sub.bias is not None:
                        lin.bias.copy_(sub.bias)
                setattr(mod, name, lin)
    return model


def _agreement(a, b):
    """Share of tokens equal before each stream's first difference."""
    same = total = 0
    for x, y in zip(a, b):
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        same += n
        total += len(x)
    return same / total


def int8_serving_phase(torch, dev):
    """Phase 11: int8 serving at full Llama-2-7B width and depth through
    ``create_serving_engine``: weight-only int8 (the entry point sweeps the
    seeded model), the float engine over the dequantized weights (its
    oracle: equal greedy streams), and int8 weights with int8 KV pools
    (the main path of K2's per-row mode, counters zeroed just before and
    read just after)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    qmodel = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    requests = make_requests(cfg.vocab_size)
    streams, records, launches, graphs = {}, {}, {}, True
    for arm, kw in INT8_ARMS:
        model = (_dequantized_float_model(torch, qmodel)
                 if arm == "float_dequantized" else qmodel)
        # the previous arm's engine sits in a reference cycle (its timed
        # methods close over it): free it before this arm's peak
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launches()
        engine, reqs, wall, split = serve(
            torch, model, requests, residency_at=RESIDENCY_STEP, **kw)
        launches[arm] = dict(ops.LAUNCHES)
        graphs = graphs and engine._graph is not None
        check_run(engine, reqs, cfg.vocab_size)
        st = engine.engine_stats()
        gen = sum(len(r.tokens) for r in reqs)
        streams[arm] = [list(r.tokens) for r in reqs]
        records[arm] = {
            "phase": "int8_serving_llama2_7b", "arm": arm, **kw,
            "layers": cfg.num_hidden_layers, "requests": len(reqs),
            "generated_tokens": gen, "wall_s": wall,
            "generated_tok_per_s": gen / wall,
            "prefill_tok_per_s": st["prefill_tokens"] / split["mixed_s"],
            "mixed_step_s": split["mixed_s"],
            "decode_quanta_s": split["decode_s"],
            "decode_steps": st["decode_quanta"] * engine.config.decode_quantum,
            "pool_kv_dtype": st["pool"]["kv_dtype"],
            "pool_bytes_in_use_at_step": {RESIDENCY_STEP:
                                          split["pool_bytes"]},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches[arm]}
        del engine
        if arm == "float_dequantized":
            del model
    equal = streams["w8"] == streams["float_dequantized"]
    f_bytes = records["w8"]["pool_bytes_in_use_at_step"][RESIDENCY_STEP]
    q_bytes = records["w8kv8"]["pool_bytes_in_use_at_step"][RESIDENCY_STEP]
    records["w8"]["streams_equal_dequantized_float"] = equal
    records["w8kv8"]["residency_ratio_float_over_int8"] = f_bytes / q_bytes
    records["w8kv8"]["token_agreement_with_w8"] = _agreement(
        streams["w8kv8"], streams["w8"])
    for arm, _ in INT8_ARMS:
        emit(records[arm])
    check(equal, "weight-only int8 greedy streams differ from the "
          "dequantized float engine's")
    main_path = launches["w8kv8"]
    check(graphs, "an int8 engine's decode quantum did not run as a graph")
    for name in INT8_SERVING_KERNELS:
        check(main_path[name] > 0,
              f"kernel {name} was not launched by the int8 serving path")
    check(main_path["paged_decode_attention"] == 0
          and main_path["paged_decode_attention_int8"] == 0,
          f"the int8 KV engine launched a float or static K2: {main_path}")
    profile_phase(torch, qmodel, requests, tag="_w8kv8",
                  **dict(INT8_ARMS)["w8kv8"])
    # the dequantization's share: only an eager quantum runs its range
    profile_phase(torch, qmodel, requests, labels=("decode_quantum",),
                  tag="_w8_eager", eager=True, **dict(INT8_ARMS)["w8"])
    del qmodel
    torch.cuda.empty_cache()
    return main_path


# cached tokens of the 8 rows of phase 12's batches
STATIC_BATCH_CACHED = (0, 320, 896, 1792, 31, 500, 1024, 2046)


def _static_scale_batch(torch, g, dev):
    """One block_multihead_attention mixed batch over int8 pools with
    static per-head quant scales (K2's static int8 arm) at the serving
    shape: 8 slots, 4 of them prefilling 128-token chunks over cached
    contexts, 4 decoding one token; H = HK = 32, D = 128, block size 32,
    f32."""
    import numpy as np
    from paddle_tpu_torch.incubate.nn.functional import (
        block_multihead_attention)

    h = hk = 32
    d, bs, w = 128, 32, 64
    this = [128, 128, 128, 128, 1, 1, 1, 1]
    num_blocks = 8 * w + 1
    shape = (num_blocks, bs, hk, d)
    kp, vp = (torch.randint(-128, 128, shape, generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    perm = torch.randperm(num_blocks - 1, generator=g, device=dev) + 1
    tables = perm[:8 * w].view(8, w).int().cpu().numpy()
    qkv = torch.randn(sum(this), (h + 2 * hk) * d, generator=g, device=dev)
    qs = torch.rand(hk, generator=g, device=dev) * 20 + 30
    args = dict(
        seq_lens_encoder=np.asarray([t if t > 1 else 0 for t in this],
                                    np.int32),
        seq_lens_decoder=np.asarray(STATIC_BATCH_CACHED, np.int32),
        seq_lens_this_time=np.asarray(this, np.int32), block_tables=tables,
        num_heads=h, kv_num_heads=hk, head_dim=d,
        cache_k_quant_scales=qs, cache_v_quant_scales=qs * 0.8)

    def run():
        pools = (kp.clone(), vp.clone())
        out = block_multihead_attention(qkv, *pools, **args)
        return out, pools

    return run


def _scaled_float_decode(torch, g, dev):
    """One decode step of 8 sequences through the public
    ``paged_decode_attention`` with (HK,) k and v scales over f32 pools
    (the reference's op applies such scales to any pool dtype;
    block_multihead_attention passes them only to int8 pools): the
    static batch's cached lengths plus the new token, H = HK = 32, D =
    128, block size 32."""
    from paddle_tpu_torch import ops

    h = hk = 32
    d, bs, w = 128, 32, 64
    num_blocks = 8 * w + 1
    kp, vp = (torch.randn((num_blocks, bs, hk, d), generator=g, device=dev)
              for _ in range(2))
    perm = torch.randperm(num_blocks - 1, generator=g, device=dev) + 1
    tables = perm[:8 * w].view(8, w).int()
    lens = torch.tensor([c + 1 for c in STATIC_BATCH_CACHED],
                        dtype=torch.int32, device=dev)
    q = torch.randn(8, h, d, generator=g, device=dev)
    ks = torch.rand(hk, generator=g, device=dev) * 1.5 + 0.25
    vs = ks * 0.8

    def run():
        return ops.paged_decode_attention(q, kp, vp, tables, lens,
                                          k_scale=ks, v_scale=vs)

    return run


def _record_runner_up(engine, table):
    """Wrap the engine's token choice to keep, for every (request, tokens
    emitted so far), the top two token ids and their logit gap. The
    record reads them on the host at every step, so the engine runs its
    quantum eagerly (phase 12 holds the captured quantum to this eager
    kernel run in a run of its own)."""
    engine._eager = True
    select = engine._select

    def traced(logits, slots, steps):
        top = logits.float().topk(2, dim=-1)
        ids, vals = top.indices.tolist(), top.values.tolist()
        owner = {r.slot: r for r in engine.scheduler.live()}
        rows = range(engine.config.num_slots) if slots is None else slots
        for i, (slot, step) in enumerate(zip(rows, steps.tolist())):
            if slot in owner:
                table[(owner[slot].req_id, int(step))] = (
                    ids[i][0], ids[i][1], vals[i][0] - vals[i][1])
        return select(logits, slots, steps)

    engine._select = traced


def _partings(streams, tables, reqs, names=("kernel", "plain")):
    """Each request's first differing token between two runs, with both
    runs' (best, runner-up, gap) there; a parting is a runner-up swap
    when each run's token is the other run's second choice."""
    out = []
    for (a, b), r0, r1 in zip(zip(*streams), *reqs):
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        t0, t1 = tables[0][(r0.req_id, j)], tables[1][(r1.req_id, j)]
        out.append({"request": len(out), "token": j, names[0]: t0,
                    names[1]: t1, "swap": (t0[0], t0[1]) == (a[j], b[j])
                    and (t1[0], t1[1]) == (b[j], a[j])})
    return out


def int8_parity_phase(torch, dev):
    """Phase 12: f32 parity at Llama-2-7B width with 4 layers, kernel path
    against plain path: the weight-only int8 engine (equal greedy
    streams), the int8-KV engine, then STATIC (HK,) scales (the TPU
    kernel's own has_scales arm) in a block_multihead_attention mixed
    batch over int8 pools and in a paged_decode_attention step over f32
    pools, within f32 1e-4, their counters zeroed just before and read
    just after each kernel-path call. The int8-KV engine's streams are
    equal up to partings at near-ties: a 1-ulp difference before
    ``quantize_kv_rows`` can round a KV element to the neighbouring int8
    value (1/127 of its row's range), so each parting must be a runner-up
    swap (each path's token the other's second choice) and the share of
    equal tokens is reported."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=4, dtype="float32")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    requests = make_requests(cfg.vocab_size)
    for arm, kw in (INT8_ARMS[0], INT8_ARMS[2]):
        # the kernel path as the card runs it: the quantum captured
        ops.reset_launches()
        engine, reqs, wall, _ = serve(torch, model, requests, **kw)
        check_run(engine, reqs, cfg.vocab_size)
        check(engine._graph is not None,
              f"{arm}: the decode quantum was not captured")
        captured = [list(r.tokens) for r in reqs]
        captured_launches = dict(ops.LAUNCHES)
        emit({"phase": "int8_parity_f32_4layer", "arm": arm,
              "path": "kernels_captured", "wall_s": wall,
              "launches": captured_launches})
        del engine
        streams, launches, tables, reqs_by_path = [], [], [], []
        for plain in (False, True):
            table = {}
            ops.reset_launches()
            with (ops.plain_versions() if plain
                  else contextlib.nullcontext()):
                engine, reqs, wall, _ = serve(
                    torch, model, requests,
                    on_engine=lambda e, t=table: _record_runner_up(e, t),
                    **kw)
            check_run(engine, reqs, cfg.vocab_size)
            streams.append([list(r.tokens) for r in reqs])
            launches.append(dict(ops.LAUNCHES))
            tables.append(table)
            reqs_by_path.append(reqs)
            emit({"phase": "int8_parity_f32_4layer", "arm": arm,
                  "path": "plain" if plain else "kernels", "wall_s": wall,
                  "launches": launches[-1]})
            del engine
        check(all(n == 0 for n in launches[1].values()),
              f"plain path launched a kernel: {launches[1]}")
        partings = _partings(streams, tables, reqs_by_path)
        emit({"phase": "int8_parity_f32_4layer", "arm": arm,
              "captured_equals_eager_kernels": captured == streams[0],
              "streams_equal": not partings,
              "requests_equal": len(requests) - len(partings),
              "requests": len(requests),
              "token_agreement": _agreement(*streams),
              "partings": partings})
        check(captured == streams[0], f"{arm}: the captured quantum's "
              f"streams differ from the eager kernel path's")
        if arm == "w8":
            check(launches[0]["paged_decode_attention"] > 0
                  and captured_launches["paged_decode_attention"] > 0,
                  f"kernel path missed K2: {launches[0]}, "
                  f"{captured_launches}")
            check(not partings, "weight-only int8 engine: kernel and plain "
                  "greedy streams differ")
        else:
            check(launches[0]["paged_decode_attention_int8_rows"] > 0
                  and captured_launches[
                      "paged_decode_attention_int8_rows"] > 0,
                  f"kernel path missed K2's per-row mode: {launches[0]}, "
                  f"{captured_launches}")
            check(all(p["swap"] for p in partings),
                  f"int8-KV engine: a parting is no runner-up swap: "
                  f"{partings}")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    launches = {}
    for label, kernels, make in (
            ("block_mha_static_int8", STATIC_INT8_KERNELS,
             _static_scale_batch),
            ("scaled_float_decode", SCALED_FLOAT_KERNELS,
             _scaled_float_decode)):
        run = make(torch, torch.Generator(device=dev).manual_seed(SEED + 2),
                   dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        out = run()
        torch.cuda.synchronize()
        launches[label] = dict(ops.LAUNCHES)
        with ops.plain_versions():
            ref = run()
        if isinstance(out, tuple):  # block_multihead_attention's pools
            (out, pools), (ref, ref_pools) = out, ref
            pools_equal = all(torch.equal(a, b)
                              for a, b in zip(pools, ref_pools))
        else:
            pools_equal = True
        err, ok, tol = close(torch, out, ref, torch.float32)
        ok = ok and bool(torch.isfinite(out).all())
        emit({"phase": label + "_f32", "max_abs_err": err, "tol": tol,
              "ok": ok, "pools_equal": pools_equal,
              "launches": launches[label]})
        check(ok and pools_equal,
              f"{label}: kernel path differs from plain (err {err}, pools "
              f"equal {pools_equal})")
        for name in kernels:
            check(launches[label][name] > 0,
                  f"kernel {name} was not launched by the {label} run")
        del run, out, ref
    return launches


# ---------------------------------------------------------------- phase 13
def _quantum_timing(torch, model, requests, eager, smi, n=3, **kw):
    """The decode dispatch, eagerly or as replays of its captured graph,
    on phase 3's knobs and first 8 requests: after the prefill and one
    decode step (the capture), ``n`` dispatches each timed from
    ``step_dispatch`` (host ms: until it returns) to the end of
    ``step_collect`` (wall ms), then one more under torch.profiler
    (device ms and busy share, as ``profile_phase``)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import create_serving_engine

    engine = create_serving_engine(model, **serve_kw(**kw))
    engine._eager = eager
    for r in requests[:8]:
        engine.submit(**r)
    while engine.scheduler.prefilling() or not engine.scheduler.decoding():
        engine.step()
    engine.step()
    host, wall, replays = [], [], []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        prof = None
        if len(wall) == n:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        pending = engine.step_dispatch()
        t1 = time.perf_counter()
        check(pending is not None, "a timed step was no decode dispatch")
        engine.step_collect(pending)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
            rec = _profile_record(torch, prof, "decode_quantum", 1e6 * (
                t2 - t0))
        else:
            host.append(1e3 * (t1 - t0))
            wall.append(1e3 * (t2 - t0))
            replays.append(0 if eager else pending["k"])
    del engine
    return {"gpu": smi, "wall_ms": wall, "host_ms_per_dispatch": host,
            "replays_per_dispatch": replays,
            "profiled_wall_ms": rec["wall_ms_under_profiler"],
            "device_ms": rec["device_ms"],
            "device_busy_share": rec["device_busy_share"],
            "kernels_launched": rec["kernels_launched"],
            "device_ms_by_family": rec["device_ms_by_family"]}


def _overlapped(torch, model, traces):
    """Two engines (one per (requests, knobs) trace) on one model, driven
    dispatch, dispatch, collect, collect until both are idle; returns
    each engine's streams and the wall."""
    from paddle_tpu_torch import create_serving_engine

    engines = [create_serving_engine(model, **serve_kw(**kw))
               for _, kw in traces]
    reqs = [[e.submit(**r) for r in tr] for e, (tr, _) in zip(engines,
                                                              traces)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while any(e.has_work for e in engines):
        pending = [e.step_dispatch() if e.has_work else None
                   for e in engines]
        for e, p in zip(engines, pending):
            e.step_collect(p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(e._graph is not None for e in engines),
          "an overlapped engine did not capture its quantum")
    streams = [[list(r.tokens) for r in rs] for rs in reqs]
    del engines
    return streams, wall


def graphs_serving_phase(torch, dev, smi):
    """Phase 13 (serving): full Llama-2-7B bf16, phase 3's knobs and
    first 8 requests. The captured quantum against its eager body (greedy,
    sampled at fixed seeds), ``multi_quantum=4`` against 1, two engines
    driven dispatch, dispatch, collect, collect against ``step()``, and
    phase 11's w8kv8 engine captured against eager: streams equal token
    for token. Then the decode dispatch's wall, host, device ms and busy
    share, eager and captured, float and w8kv8."""
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    # phase 3's first 8 requests: one wave of its 8 slots (the whole
    # smoke's time limit; phases 3 and 14-17 serve all 16)
    requests = make_requests(cfg.vocab_size)[:8]
    sampled = [dict(r, seed=i) for i, r in enumerate(requests)]
    w8kv8 = dict(INT8_ARMS)["w8kv8"]
    arms = (("greedy", requests, {}, (True, False)),
            ("sampling", sampled, SAMPLING, (True, False)),
            ("multi_quantum_4", requests, dict(multi_quantum=4), (False,)),
            ("w8kv8", requests, w8kv8, (True, False)))
    runs, timing = {}, {}
    model = None
    for name, reqs, kw, modes in arms:
        if model is None or name == "w8kv8":
            # the w8kv8 engine sweeps its model in place: a fresh one
            del model
            gc.collect()
            torch.cuda.empty_cache()
            model = LlamaForCausalLM(
                cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
        for eager in modes:
            gc.collect()
            torch.cuda.empty_cache()
            engine, rs, wall, split = serve(torch, model, reqs, eager=eager,
                                            **kw)
            check_run(engine, rs, cfg.vocab_size)
            check(eager == (engine._graph is None),
                  f"{name}: eager={eager} but graph {engine._graph}")
            st = engine.engine_stats()
            runs[name, eager] = {
                "streams": [list(r.tokens) for r in rs], "wall_s": wall,
                "decode_dispatch_s": split["decode_s"],
                "mixed_step_s": split["mixed_s"],
                "decode_quanta": st["decode_quanta"], "steps": st["steps"]}
            del engine
        if name in ("greedy", "w8kv8"):
            timing[name] = {("eager" if eager else "captured"):
                            _quantum_timing(torch, model, requests, eager,
                                            smi, **kw)
                            for eager in (True, False)}
        if name == "sampling":
            overlapped, o_wall = _overlapped(
                torch, model, ((requests, {}), (sampled, SAMPLING)))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    equal = {name: runs[name, True]["streams"] == runs[name, False]["streams"]
             for name in ("greedy", "sampling", "w8kv8")}
    greedy = runs["greedy", False]
    mq = runs["multi_quantum_4", False]
    equal["multi_quantum_4_vs_1"] = mq["streams"] == greedy["streams"]
    equal["dispatch_collect_vs_step"] = overlapped == [
        greedy["streams"], runs["sampling", False]["streams"]]
    emit({"phase": "graphs_llama2_7b_serving", "gpu": smi,
          "streams_equal": equal,
          "w8kv8_token_agreement": _agreement(
              runs["w8kv8", False]["streams"],
              runs["w8kv8", True]["streams"]),
          "decode_quanta": {"k1": greedy["decode_quanta"],
                            "k4": mq["decode_quanta"]},
          "host_steps": {"k1": greedy["steps"], "k4": mq["steps"]},
          "overlapped_wall_s": o_wall,
          "runs": {f"{n}_{'eager' if e else 'captured'}":
                   {k: v for k, v in r.items() if k != "streams"}
                   for (n, e), r in runs.items()}})
    QUANTUM_RECORD.update(timing)
    for name, rec in timing.items():
        emit({"phase": "graphs_llama2_7b_decode_dispatch", "engine": name,
              **rec})
    check(all(equal.values()), f"captured and eager streams differ: {equal}")
    check(mq["decode_quanta"] == greedy["decode_quanta"],
          f"multi_quantum=4 ran {mq['decode_quanta']} quanta, K=1 "
          f"{greedy['decode_quanta']}")


# ---------------------------------------------------------------- phase 14
# the shared system prompt (32 full blocks), the warm request's tail, and
# the tails and new tokens of the 16 requests after it
PREFIX_SHAPE = dict(system=1024, warm_tail=96, tails=(32, 256),
                    new=(32, 64), requests=16)
# requests that are the bare system prompt (a fully cached chain: the last
# token is prefilled again into a shared block) and the repeat of the warm
# request's whole prompt
PREFIX_BARE = (3, 9)
PREFIX_REPEAT = 5


def prefix_requests(vocab):
    """Phase 14's trace, fixed by seed 0: the warm request, then 16
    requests that share its system prompt."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    shape = PREFIX_SHAPE
    system = rng.randint(1, vocab, shape["system"]).astype(np.int32)
    warm = dict(prompt=np.concatenate([system, rng.randint(
        1, vocab, shape["warm_tail"]).astype(np.int32)]), max_new_tokens=32)
    lo, hi = shape["tails"]
    tails = rng.randint(lo, hi + 1, shape["requests"])
    new = rng.randint(shape["new"][0], shape["new"][1] + 1,
                      shape["requests"])
    requests = []
    for i, (n, mn) in enumerate(zip(tails, new)):
        if i in PREFIX_BARE:
            prompt = system.copy()
        elif i == PREFIX_REPEAT:
            prompt = warm["prompt"].copy()
        else:
            prompt = np.concatenate([system, rng.randint(
                1, vocab, int(n)).astype(np.int32)])
        requests.append(dict(prompt=prompt, max_new_tokens=int(mn)))
    return warm, requests


class _CowAudit:
    """Wraps an engine pool's ``make_writable``: around every call the
    pool tensors' addresses must not change (and must be the captured
    graph's once it exists), and every block copied must hold its source's
    rows right after the copy. The sources' rows are kept, so that
    ``check_sharers`` can show after the run that the writer's writes
    never reached a block another holder maps."""

    def __init__(self, torch, engine):
        self.torch, self.engine = torch, engine
        pool = engine.pool
        self.tensors = pool._pool_tensors()
        self.ptrs = engine._pool_ptrs()
        self.copies, self.kept = 0, []
        orig = pool.make_writable

        def audited(seq_id, start, end):
            table = list(pool._tables.get(seq_id, ()))
            before = engine._pool_ptrs()
            n = orig(seq_id, start, end)
            after = engine._pool_ptrs()
            check(before == after == self.ptrs,
                  "a copy-on-write moved a pool tensor")
            check(engine._graph_pools in (None, after),
                  "the pools differ from the captured graph's")
            if n:
                new = pool._tables[seq_id]
                for j, (old, blk) in enumerate(zip(table, new)):
                    if old == blk:
                        continue
                    rows = [t[old].clone() for t in self.tensors]
                    check(all(torch.equal(t[blk], r) for t, r in
                              zip(self.tensors, rows)),
                          f"copy-on-write block {old} -> {blk}: the copy "
                          f"differs from its source")
                    self.kept.append((old, rows))
                    self.copies += 1
            return n

        pool.make_writable = audited

    def check_sharers(self):
        """Every source block the index still holds keeps the rows it had
        when it was copied. Returns the blocks checked."""
        pool, torch = self.engine.pool, self.torch
        checked = 0
        for blk, rows in self.kept:
            if blk in pool._cached_blocks:
                check(all(torch.equal(t[blk], r) for t, r in
                          zip(self.tensors, rows)),
                      f"the shared block {blk} changed after a "
                      f"copy-on-write")
                checked += 1
        return checked


def _prefix_trace(torch, model, warm, requests, eager=False, audit=False,
                  on_engine=None, **kw):
    """Phase 14's trace through a fresh engine: the warm request runs
    until its first token (its chain is then published), then the 16
    requests are submitted and the engine runs until idle. Returns the
    engine, the requests (warm first), the wall time and the
    ``_CowAudit`` (with ``audit``)."""
    from paddle_tpu_torch import create_serving_engine

    engine = create_serving_engine(model, **serve_kw(**kw))
    engine._eager = eager
    cow = _CowAudit(torch, engine) if audit else None
    if on_engine is not None:
        on_engine(engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = engine.submit(**warm)
    while not first.tokens:
        engine.step()
    reqs = [first] + [engine.submit(**r) for r in requests]
    engine.run()
    torch.cuda.synchronize()
    return engine, reqs, time.perf_counter() - t0, cow


def _prefix_record(engine, reqs, wall, smi):
    import numpy as np

    st = engine.engine_stats()
    pc = st.get("prefix_cache") or {}
    ttft = [r.first_token_time - r.arrival_time for r in reqs]
    gen = sum(len(r.tokens) for r in reqs)
    return {"gpu": smi, "hits": pc.get("hits", 0),
            "misses": pc.get("misses", 0),
            "cow_copies": pc.get("cow_copies", 0),
            "evictions": pc.get("evictions", 0),
            "cached_blocks": pc.get("cached_blocks", 0),
            "prefill_tokens": st["prefill_tokens"],
            "mixed_steps": st["mixed_steps"],
            "decode_quanta": st["decode_quanta"],
            "ttft_median_s": float(np.median(ttft)),
            "ttft_max_s": float(max(ttft)), "wall_s": wall,
            "generated_tokens": gen, "generated_tok_per_s": gen / wall}


def _hit_row_profile(torch, model, warm, requests):
    """torch.profiler over the one mixed step that admits and prefills a
    request whose system prompt is cached (its tail in one chunk)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import create_serving_engine

    engine = create_serving_engine(model, **serve_kw(prefix_cache=True))
    engine.run([warm])
    hit = next(r for i, r in enumerate(requests)
               if i not in PREFIX_BARE and i != PREFIX_REPEAT
               and len(r["prompt"]) - PREFIX_SHAPE["system"]
               <= engine.config.prefill_chunk)
    req = engine.submit(**hit)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    check(req.cached_prefix_tokens == PREFIX_SHAPE["system"]
          and len(req.tokens) == 1,
          f"the profiled step was no single-chunk hit: cached "
          f"{req.cached_prefix_tokens}, tokens {len(req.tokens)}")
    rec = _profile_record(torch, prof, "mixed_step_hit_row", wall_us)
    rec["tail_tokens"] = int(len(hit["prompt"]) - req.cached_prefix_tokens)
    del engine
    return rec


def prefix_phase(torch, dev, smi, model):
    """Phase 14: the prefix cache at full width, on phase 3's Llama-2-7B
    bf16 model and knobs. The trace (the warm request, then 16 requests
    sharing its 1,024-token system prompt) with the cache on and off, the
    quantum captured; the cached run's launch counters zeroed just before
    and read just after. Checks: hits and copy-on-writes, the prefill
    tokens saved equal to the cached tokens skipped, every copy made in
    place (no pool tensor moves; the copy holds its source's rows; the
    sources the index still holds keep theirs to the end), the pool
    drained to scratch + cached blocks, the captured streams equal to the
    eager body's, ``multi_quantum=4`` equal to 1, and an int8-KV arm's
    copies (scale rows included). Then, at Llama-2-7B width with 4 layers
    in f32, the cached engine's greedy streams against the unshared
    engine's (a parting passes only as a runner-up swap). Returns the
    launch counts of the cached float and int8-KV runs."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    vocab = model.config.vocab_size
    warm, requests = prefix_requests(vocab)
    runs, launches = {}, {}
    for name, kw, eager, audit in (
            ("cached", dict(prefix_cache=True), False, True),
            ("unshared", {}, False, False),
            ("cached_eager", dict(prefix_cache=True), True, False),
            ("cached_multi_quantum_4", dict(prefix_cache=True,
                                            multi_quantum=4), False, False),
            ("cached_int8_kv", dict(prefix_cache=True, kv_dtype="int8"),
             False, True)):
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launches()
        engine, reqs, wall, cow = _prefix_trace(
            torch, model, warm, requests, eager=eager, audit=audit, **kw)
        counts = dict(ops.LAUNCHES)
        check_run(engine, reqs, vocab)
        check(eager == (engine._graph is None),
              f"{name}: eager={eager} but graph {engine._graph}")
        rec = _prefix_record(engine, reqs, wall, smi)
        if cow is not None:
            rec["audited_copies"] = cow.copies
            rec["sharers_checked"] = cow.check_sharers()
            check(cow.copies == rec["cow_copies"] and cow.copies >= 2,
                  f"{name}: {cow.copies} audited copies, "
                  f"{rec['cow_copies']} counted")
            check(rec["sharers_checked"] > 0,
                  f"{name}: no copied source stayed cached to be checked")
        if name != "unshared":
            check(rec["hits"] > 0 and rec["cow_copies"] >= 2,
                  f"{name}: hits {rec['hits']}, copies {rec['cow_copies']}")
        if name in ("cached", "cached_int8_kv"):
            launches[name] = counts
        rec["saved_prefill_tokens_expected"] = sum(
            min(r.cached_prefix_tokens, r.prefill_target - 1) for r in reqs)
        runs[name] = (rec, [list(r.tokens) for r in reqs])
        emit({"phase": "prefix_llama2_7b_bf16", "arm": name, **rec,
              **({"launches": counts} if name in launches else {})})
        del engine, reqs
    for name, kernels in (("cached", SERVING_KERNELS),
                          ("cached_int8_kv", INT8_SERVING_KERNELS)):
        for k in kernels:
            check(launches[name][k] > 0,
                  f"kernel {k} was not launched by the prefix path {name}")
    check(launches["cached"]["paged_decode_attention_int8_rows"] == 0
          and launches["cached_int8_kv"]["paged_decode_attention"] == 0,
          f"a prefix arm launched the other pool's K2: {launches}")
    cached, unshared = runs["cached"], runs["unshared"]
    saved = unshared[0]["prefill_tokens"] - cached[0]["prefill_tokens"]
    equal = {"captured_vs_eager": cached[1] == runs["cached_eager"][1],
             "multi_quantum_4_vs_1":
                 runs["cached_multi_quantum_4"][1] == cached[1]}
    profile = _hit_row_profile(torch, model, warm, requests)
    emit({"phase": "prefix_llama2_7b_bf16", "gpu": smi,
          "streams_equal": equal,
          "prefill_tokens_saved": saved,
          "prefill_tokens_saved_expected":
              cached[0]["saved_prefill_tokens_expected"],
          "cached_vs_unshared_token_agreement": _agreement(cached[1],
                                                          unshared[1]),
          "int8_kv_vs_float_token_agreement": _agreement(
              runs["cached_int8_kv"][1], cached[1]),
          "mixed_step_hit_row": {"gpu": smi, **profile}})
    check(all(equal.values()), f"prefix streams differ: {equal}")
    check(saved == cached[0]["saved_prefill_tokens_expected"] > 0,
          f"the cache saved {saved} prefill tokens, expected "
          f"{cached[0]['saved_prefill_tokens_expected']}")
    gc.collect()
    torch.cuda.empty_cache()

    # f32 at full width, 4 layers: cached against unshared greedy streams
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=4, dtype="float32")
    f32 = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    streams, tables, by_arm = [], [], []
    for prefix in (True, False):
        table = {}
        engine, reqs, wall, _ = _prefix_trace(
            torch, f32, warm, requests, prefix_cache=prefix,
            on_engine=lambda e, t=table: _record_runner_up(e, t))
        check_run(engine, reqs, vocab)
        streams.append([list(r.tokens) for r in reqs])
        tables.append(table)
        by_arm.append(reqs)
        del engine
    partings = _partings(streams, tables, by_arm, ("cached", "unshared"))
    emit({"phase": "prefix_parity_f32_4layer", "gpu": smi,
          "streams_equal": not partings,
          "requests_equal": len(by_arm[0]) - len(partings),
          "requests": len(by_arm[0]),
          "token_agreement": _agreement(*streams), "partings": partings})
    check(all(p["swap"] for p in partings),
          f"f32 prefix cache: a parting is no runner-up swap: {partings}")
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefix_serving": launches["cached"],
            "prefix_serving_int8_kv": launches["cached_int8_kv"]}


# ---------------------------------------------------------------- phase 15
# (a): proposals per round of the serving run; (b): the reference row
# scripts/bench_serving.py:1367 (γ, slots, block, max_context, prompt
# tokens), its interleaved windows and the dispatches in each; (c): the
# f32 parity run's requests (phase 3's first 8)
SPEC_GAMMA = 4
SPEC_STEADY = dict(gamma=8, slots=8, block=32, max_context=1792,
                   prompt=128, windows=5, dispatches=2)
SPEC_F32_REQUESTS = 8
# the stand-in draft's tail gain (bench_serving.py's eps)
SPEC_TAIL_GAIN = 0.01


def spec_drafts(torch, dev, target, seed):
    """``scripts/bench_serving.py:1321`` ``_spec_pair`` on the port: the
    stand-in draft is one layer that shares the target's embedding, layer
    0, final norm and lm head (the modules themselves), and the target's
    layers 1-31 get ``o_proj`` and ``down_proj`` scaled by 0.01 IN PLACE
    (a low-gain tail, so acceptance lands in a trained pair's regime);
    the independent draft is one seeded layer of the same width, the
    acceptance floor. Returns (stand-in, independent)."""
    import copy

    from paddle_tpu_torch.nlp import LlamaForCausalLM

    d_cfg = copy.copy(target.config)
    d_cfg.num_hidden_layers = 1
    standin = LlamaForCausalLM(
        d_cfg, generator=torch.Generator(device=dev).manual_seed(seed))
    standin.llama.embed_tokens = target.llama.embed_tokens
    standin.llama.layers[0] = target.llama.layers[0]
    standin.llama.norm = target.llama.norm
    standin.lm_head = target.lm_head
    with torch.no_grad():
        for layer in target.llama.layers[1:]:
            layer.self_attn.o_proj.weight.mul_(SPEC_TAIL_GAIN)
            layer.mlp.down_proj.weight.mul_(SPEC_TAIL_GAIN)
    indep = LlamaForCausalLM(
        d_cfg, generator=torch.Generator(device=dev).manual_seed(seed + 1))
    gc.collect()
    torch.cuda.empty_cache()
    return standin.eval(), indep.eval()


def _spec_record(engine, reqs, wall, split, smi):
    import numpy as np

    st = engine.engine_stats()
    gen = sum(len(r.tokens) for r in reqs)
    rec = {"gpu": smi, "wall_s": wall, "generated_tokens": gen,
           "generated_tok_per_s": gen / wall,
           "ttft_median_s": float(np.median(
               [r.first_token_time - r.arrival_time for r in reqs])),
           "mixed_steps": st["mixed_steps"], "mixed_step_s": split[
               "mixed_s"], "decode_s": split["decode_s"]}
    if engine.spec_draft is None:
        rec["decode_quanta"] = st["decode_quanta"]
        rec["target_forwards_per_decoded_token"] = 1.0
        return rec
    # slot-rounds (one target forward of a live row each) over the tokens
    # the rounds emitted
    slot_rounds = st["spec_proposed"] / engine.spec_gamma
    rec.update(spec_rounds=st["spec_rounds"],
               spec_proposed=st["spec_proposed"],
               spec_accepted=st["spec_accepted"],
               acceptance_rate=st["spec_acceptance_rate"],
               round_tokens=st["quantum_tokens"],
               target_forwards_per_decoded_token=(
                   slot_rounds / max(st["quantum_tokens"], 1)),
               draft_forwards_per_decoded_token=(
                   slot_rounds * (engine.spec_gamma + 1)
                   / max(st["quantum_tokens"], 1)))
    return rec


def _spec_serving(torch, target, standin, requests, smi):
    """Phase 15 (a): phase 3's requests and knobs through
    ``create_serving_engine(spec_draft=stand-in, spec_gamma=4)``, the
    round captured (counters zeroed just before and read just after),
    the plain engine on the same trace, and the round's eager body."""
    from paddle_tpu_torch import ops

    vocab = target.config.vocab_size
    ops.reset_launches()
    engine, reqs, wall, split = serve(torch, target, requests,
                                      spec_draft=standin,
                                      spec_gamma=SPEC_GAMMA)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in SERVING_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the speculative path")
    check(engine._graph is not None,
          "the speculative round did not run as a graph")
    check_run(engine, reqs, vocab)
    spec = _spec_record(engine, reqs, wall, split, smi)
    spec.update(launches=launches, peak_mem_gb=peak,
                round_graph_launches=engine._graph.launches)
    streams = [list(r.tokens) for r in reqs]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine, reqs, wall, split = serve(torch, target, requests)
    check_run(engine, reqs, vocab)
    plain = _spec_record(engine, reqs, wall, split, smi)
    plain_streams = [list(r.tokens) for r in reqs]
    del engine
    engine, reqs, e_wall, _ = serve(torch, target, requests, eager=True,
                                    spec_draft=standin,
                                    spec_gamma=SPEC_GAMMA)
    check_run(engine, reqs, vocab)
    eager_streams = [list(r.tokens) for r in reqs]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "spec_serving_llama2_7b_bf16", "gamma": SPEC_GAMMA,
          "draft": "stand-in", "spec": spec, "plain": plain,
          "eager_wall_s": e_wall,
          "captured_equals_eager": streams == eager_streams,
          "greedy_token_agreement_with_plain": _agreement(streams,
                                                          plain_streams)})
    check(streams == eager_streams,
          "captured and eager speculative streams differ")
    return launches


def _steady_engine(torch, target, prompts, **kw):
    from paddle_tpu_torch import create_serving_engine

    cfg = SPEC_STEADY
    engine = create_serving_engine(
        target, num_slots=cfg["slots"], block_size=cfg["block"],
        max_context=cfg["max_context"], prefill_chunk=cfg["prompt"],
        decode_quantum=8, **kw)
    for p in prompts:
        engine.submit(p, max_new_tokens=cfg["max_context"] - cfg["prompt"]
                      - cfg["gamma"] - 4)
    while engine.scheduler.prefilling() or not engine.scheduler.decoding():
        engine.step()
    engine.step()           # the warm-up and the capture
    check(engine._graph is not None, "a steady-state engine did not capture")
    return engine


def _window(torch, engine, n):
    """Generated tokens/s over ``n`` dispatches (each ends synced)."""
    g0 = int(engine._n_gen.sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        engine.step()
    torch.cuda.synchronize()
    return (int(engine._n_gen.sum()) - g0) / (time.perf_counter() - t0)


def _round_timing(torch, engine, n=3):
    """``n`` replayed rounds: wall ms (step start to its end, synced) and
    host ms (step start until the round's graph and read-back are
    enqueued), then one more round under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    stage = engine._stage_and_run
    marks = []

    def marked(k):
        event = stage(k)
        marks.append(time.perf_counter())
        return event

    engine._stage_and_run = marked
    host, wall = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        wall.append(1e3 * (time.perf_counter() - t0))
        host.append(1e3 * (marks[-1] - t0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    engine._stage_and_run = stage
    rec = _profile_record(torch, prof, "spec_round", wall_us)
    return {"wall_ms": wall, "host_ms": host,
            "device_ms": rec["device_ms"],
            "device_busy_share": rec["device_busy_share"],
            "busy_share_unprofiled": (
                rec["device_ms"] / (sorted(wall)[len(wall) // 2])
                if isinstance(rec["device_ms"], float) else "not measured"),
            "profiled_wall_ms": rec["wall_ms_under_profiler"],
            "kernels_launched": rec["kernels_launched"],
            "device_ms_by_family": rec["device_ms_by_family"]}


def _verify_split(torch, engine):
    """One round run eagerly with the verify attention
    (``_paged_chunk_attn``) under a record_function range: the device ms
    of its matrix products (the einsums) and of the rest inside it (the
    gather, the mask, the softmax). A replay runs the same kernels but no
    Python, so only an eager round splits them out."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch.serving import engine as engine_mod

    attn = engine_mod._paged_chunk_attn

    def ranged(*a, **kw):
        with record_function("verify_attention"):
            return attn(*a, **kw)

    engine._eager = True
    engine_mod._paged_chunk_attn = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.step()
            torch.cuda.synchronize()
    finally:
        engine_mod._paged_chunk_attn = attn
        engine._eager = False
    inside = _range_kernels(torch, prof, "verify_attention")
    if inside is None:
        return "not measured"
    out = {"einsum": 0.0, "gather_mask_softmax": 0.0, "kernels": {},
           "by_family": {}}
    for kernel, ms in inside:
        fam = _kernel_family(kernel)
        out["einsum" if fam == "matmul" else "gather_mask_softmax"] += ms
        out["by_family"][fam] = out["by_family"].get(fam, 0.0) + ms
        out["kernels"][kernel[:60]] = out["kernels"].get(kernel[:60],
                                                         0.0) + ms
    return out


def _spec_steady(torch, target, drafts, smi):
    """Phase 15 (b): steady-state decode capacity, the reference row
    ``scripts/bench_serving.py:1367``: γ = 8, 8 live slots, block 32,
    max_context 1,792, 128-token prompts; windows of spec rounds and of
    plain quanta interleaved, the median of 5 per draft. Then the round's
    wall, host and device ms, its busy share, its launches and a
    breakdown of one replayed round (draft K2, matmul, the verify
    attention's einsum and gather, other)."""
    import numpy as np

    cfg = SPEC_STEADY
    vocab = target.config.vocab_size
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, vocab, cfg["prompt"]).astype(np.int32)
               for _ in range(cfg["slots"])]
    plain = _steady_engine(torch, target, prompts)
    for name, draft in drafts.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        spec = _steady_engine(torch, target, prompts, spec_draft=draft,
                              spec_gamma=cfg["gamma"])
        st0 = spec.engine_stats()
        pairs = [(_window(torch, plain, cfg["dispatches"]),
                  _window(torch, spec, cfg["dispatches"]))
                 for _ in range(cfg["windows"])]
        st = spec.engine_stats()
        rounds = st["spec_rounds"] - st0["spec_rounds"]
        accepted = st["spec_accepted"] - st0["spec_accepted"]
        proposed = st["spec_proposed"] - st0["spec_proposed"]
        emitted = st["quantum_tokens"] - st0["quantum_tokens"]
        ratios = sorted(q / p for p, q in pairs)
        row = {"gpu": smi, "draft": name,
               "spec_tok_per_s": float(np.median([q for _, q in pairs])),
               "plain_tok_per_s": float(np.median([p for p, _ in pairs])),
               "speedup_vs_plain_quantum": ratios[len(ratios) // 2],
               "windows": [{"plain": p, "spec": q} for p, q in pairs],
               "acceptance_rate": accepted / max(proposed, 1),
               "tokens_per_round_per_slot": emitted / max(
                   rounds * cfg["slots"], 1),
               "launches_per_round": spec._graph.launches,
               "round": _round_timing(torch, spec),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        if name == "stand-in":
            split = _verify_split(torch, spec)
            row["verify_attention_eager_ms"] = split
            fam = row["round"]["device_ms_by_family"]
            if isinstance(split, dict) and fam:
                # the replay's families with the verify attention's
                # kernels (timed in the eager round) taken out of them,
                # each out of its own family
                inner = split["by_family"]
                row["round_breakdown_ms"] = {
                    "draft K2": fam.get("K2 paged_decode", 0.0),
                    "K1": fam.get("K1 rms_norm", 0.0),
                    "matmul (weights)": fam.get("matmul", 0.0)
                    - split["einsum"],
                    "verify products": split["einsum"],
                    "verify gather, move, mask, softmax":
                        split["gather_mask_softmax"],
                    "memcpy": fam.get("memcpy", 0.0)
                    - inner.get("memcpy", 0.0),
                    "other": fam.get("other", 0.0)
                    - inner.get("other", 0.0)}
        emit({"phase": "spec_steady_llama2_7b_bf16", **cfg, **row})
        del spec
    del plain
    gc.collect()
    torch.cuda.empty_cache()


def _spec_parity(torch, dev, smi):
    """Phase 15 (c), f32 at Llama-2-7B width with 4 layers, phase 3's
    first 8 requests: for both drafts the greedy speculative streams equal
    the plain engine's; sampling with the target as its own draft equals
    the plain sampling engine's streams with every proposal accepted.
    Both pools drain to their scratch block (``check_run``)."""
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=4, dtype="float32")
    target = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    standin, indep = spec_drafts(torch, dev, target, SEED + 3)
    requests = make_requests(cfg.vocab_size)[:SPEC_F32_REQUESTS]
    sampled = [dict(r, seed=i) for i, r in enumerate(requests)]

    def streams(reqs, **kw):
        engine, rs, wall, _ = serve(torch, target, reqs, **kw)
        check_run(engine, rs, cfg.vocab_size)
        check(engine._graph is not None, f"{kw}: no captured graph")
        st = engine.engine_stats()
        out = ([list(r.tokens) for r in rs], st, wall)
        del engine
        return out

    plain, _, _ = streams(requests)
    rec = {"gpu": smi, "layers": 4, "requests": len(requests),
           "gamma": SPEC_GAMMA}
    for name, draft in (("stand-in", standin), ("independent", indep)):
        got, st, wall = streams(requests, spec_draft=draft,
                                spec_gamma=SPEC_GAMMA)
        rec[name] = {"greedy_streams_equal": got == plain,
                     "acceptance_rate": st["spec_acceptance_rate"],
                     "wall_s": wall}
    plain_s, _, _ = streams(sampled, **SAMPLING)
    got, st, _ = streams(sampled, spec_draft=target, spec_gamma=SPEC_GAMMA,
                         **SAMPLING)
    partings = [{"request": i, "position": next(
        j for j in range(min(len(a), len(b))) if a[j] != b[j]),
        "spec": a, "plain": b} for i, (a, b) in enumerate(zip(got, plain_s))
        if a != b]
    rec["sampling_target_draft"] = {
        "streams_equal": not partings, "partings": partings,
        "spec_proposed": st["spec_proposed"],
        "spec_accepted": st["spec_accepted"]}
    emit({"phase": "spec_parity_f32_4layer", **rec})
    for name in ("stand-in", "independent"):
        check(rec[name]["greedy_streams_equal"],
              f"f32 greedy speculative streams ({name} draft) differ from "
              f"the plain engine's")
    check(not partings and st["spec_accepted"] == st["spec_proposed"],
          f"f32 sampling with the target as its own draft parted from the "
          f"plain engine: {rec['sampling_target_draft']}")
    del target, standin, indep
    gc.collect()
    torch.cuda.empty_cache()


def spec_phase(torch, dev, smi, model, requests):
    """Phase 15: speculative serving. On phase 3's Llama-2-7B bf16 model
    (last: the stand-in draft scales its tails): (a) the serving run, (b)
    steady-state decode capacity; then (c) the f32 parity at 4 layers.
    Returns the launches of (a)'s captured run as ``spec_serving``."""
    standin, indep = spec_drafts(torch, dev, model, SEED + 2)
    launches = _spec_serving(torch, model, standin, requests, smi)
    _spec_steady(torch, model, {"stand-in": standin, "independent": indep},
                 smi)
    del standin, indep
    gc.collect()
    torch.cuda.empty_cache()
    _spec_parity(torch, dev, smi)
    return {"spec_serving": launches}


# ------------------------------------------------------------ phase 16
# (b): steady-state decode at the reference's slo_overhead /
# serving_obs_overhead TPU configuration (scripts/bench_serving.py:383,
# :610): 8 slots, block 32, quantum 16, 16-token prompts, 5 interleaved
# windows of 2 dispatches
FRONTDOOR_STEADY = dict(slots=8, block=32, quantum=16, prompt=16,
                        windows=5, dispatches=2)
# (c): the serving_overload row at its TPU configuration
# (scripts/bench_serving.py:696-860)
FRONTDOOR_OVERLOAD = dict(slots=8, block=32, quantum=16, chunk=128,
                          requests=96, prompt=(32, 128), new=(16, 64),
                          overload=3.0)
# (d): a system prompt and the tails of 6 requests over 4 slots; the first
# 4 are BATCH, the last 2 INTERACTIVE arrivals that preempt them
FRONTDOOR_PREEMPT = dict(system=96, tails=(40, 17, 63, 5, 28, 51), slots=4,
                         new=24)


def _sync_counts(torch, fn):
    """(synchronizing calls PyTorch's sync debug mode reports, CUDA events
    waited on) while ``fn`` runs: the decode dispatch's one host sync is
    its event's."""
    import warnings

    events = [0]
    sync = torch.cuda.Event.synchronize

    def counted(ev):
        events[0] += 1
        return sync(ev)

    torch.cuda.Event.synchronize = counted
    # the mode is set before the recording starts: its first setting in a
    # process warns by itself
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.Event.synchronize = sync
    return (sum("synchronizing" in str(w.message) for w in caught),
            events[0])


def _registry_ttft(registry):
    h = registry.get("serving_ttft_seconds")
    return {"count": h.count(), "p50_s": h.quantile(0.5),
            "p95_s": h.quantile(0.95)}


def _door_streams(torch, model, requests, smi):
    """Phase 16 (a): phase 3's requests through ``inference.serve`` with
    ``no_shed_policy()`` and phase 3's knobs, greedy: the streams and
    finish reasons equal the bare engine's on the same trace, then the
    same trace under ``run_async`` with ``async for`` consumers equals the
    sync run. Returns the sync run's launches (counters zeroed just
    before, read just after)."""
    import asyncio

    from paddle_tpu_torch import create_serving_engine, ops
    from paddle_tpu_torch.inference import serve
    from paddle_tpu_torch.obs import validate_chrome_trace
    from paddle_tpu_torch.serving import no_shed_policy

    bare = create_serving_engine(model, **serve_kw())
    bare_reqs = [bare.submit(**r) for r in requests]
    bare.run()
    want = [list(r.tokens) for r in bare_reqs]
    want_reasons = [r.finish_reason for r in bare_reqs]
    del bare, bare_reqs
    gc.collect()
    torch.cuda.empty_cache()

    door = serve(model, policy=no_shed_policy(), trace=True, **serve_kw())
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    streams = [door.submit(r["prompt"], max_new_tokens=r["max_new_tokens"])
               for r in requests]
    got = [list(s) for s in streams]        # each pull pumps the engine
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for name in SERVING_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched through the front door")
    eng = door.engine
    check(eng._graph is not None,
          "the front door's decode quantum did not run as a graph")
    check_run(eng, [s.request for s in streams], model.config.vocab_size)
    check(got == want and [s.finish_reason for s in streams]
          == want_reasons,
          "the front door's streams differ from the bare engine's")
    validate_chrome_trace(eng.obs.tracer.chrome_trace())
    rec = {"gpu": smi, "requests": len(requests),
           "generated_tokens": sum(len(g) for g in got), "wall_s": wall,
           "generated_tok_per_s": sum(len(g) for g in got) / wall,
           "streams_equal_bare_engine": True,
           "ttft_registry": _registry_ttft(eng.obs.registry),
           "attribution": eng.attribution(), "health": eng.health()["state"],
           "trace_events": len(eng.obs.tracer),
           "drain": door.drain(), "launches": launches}
    del door, eng, streams
    gc.collect()
    torch.cuda.empty_cache()

    adoor = serve(model, policy=no_shed_policy(), **serve_kw())

    async def consume(stream):
        return [tok async for tok in stream]

    async def main():
        streams = [adoor.submit(r["prompt"],
                                max_new_tokens=r["max_new_tokens"])
                   for r in requests]
        task = asyncio.create_task(adoor.run_async(idle_s=0.001))
        outs = await asyncio.gather(*(consume(s) for s in streams))
        adoor.stop()
        await asyncio.wait_for(task, timeout=600)
        return outs

    t0 = time.perf_counter()
    agot = asyncio.run(main())
    rec["async_wall_s"] = time.perf_counter() - t0
    check(agot == got, "the async streams differ from the sync run's")
    rec["async_streams_equal_sync"] = True
    emit({"phase": "frontdoor_streams_llama2_7b_bf16", **rec})
    del adoor
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _door_overhead(torch, model, smi):
    """Phase 16 (b): steady-state decode dispatches with obs, the trace,
    the SLOs and the flight recorder on and the SLOs evaluated after every
    dispatch, against ``obs="off"``: interleaved windows, the median
    ratio of tokens/s and of host ms a dispatch (host: until
    ``step_dispatch`` returns, plus ``step_collect`` and the evaluation
    after the card is done), and the synchronizing calls a dispatch in
    both arms, which must be equal."""
    import numpy as np

    from paddle_tpu_torch import create_serving_engine

    cfg = FRONTDOOR_STEADY
    vocab = model.config.vocab_size
    rng = np.random.RandomState(SEED)
    t_steps, plen = cfg["quantum"], cfg["prompt"]
    max_ctx = plen + t_steps * (2 * cfg["windows"] + 4) + 8
    max_ctx = -(-max_ctx // cfg["block"]) * cfg["block"]

    def steady(**kw):
        engine = create_serving_engine(
            model, num_slots=cfg["slots"], block_size=cfg["block"],
            prefill_chunk=plen, decode_quantum=t_steps, max_context=max_ctx,
            **kw)
        for _ in range(cfg["slots"]):
            engine.submit(rng.randint(1, vocab, plen).astype(np.int32),
                          max_new_tokens=max_ctx - plen - 4)
        while (engine.scheduler.prefilling()
               or not engine.scheduler.decoding()):
            engine.step()
        engine.step()           # the warm-up and the capture
        check(engine._graph is not None, "a steady engine did not capture")
        return engine

    def window(engine, evaluate):
        g0 = int(engine._n_gen.sum())
        dispatch = collect = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cfg["dispatches"]):
            a = time.perf_counter()
            pending = engine.step_dispatch()
            b = time.perf_counter()
            check(pending is not None, "a timed step was no decode dispatch")
            pending["event"].synchronize()      # the card is done
            c = time.perf_counter()
            engine.step_collect(pending)
            if evaluate:
                engine.health()     # the shedding admission's poll
            d = time.perf_counter()
            dispatch += b - a
            collect += d - c
        wall = time.perf_counter() - t0
        n = cfg["dispatches"]
        return {"tok_per_s": (int(engine._n_gen.sum()) - g0) / wall,
                "dispatch_host_ms": 1e3 * dispatch / n,
                "collect_host_ms": 1e3 * collect / n,
                "host_ms": 1e3 * (dispatch + collect) / n}

    base = steady(obs="off")
    inst = steady(trace=True, slo=True, flight=True)
    pairs = [(window(base, False), window(inst, True))
             for _ in range(cfg["windows"])]

    def med(xs):
        return float(np.median(xs))

    syncs = {}
    for name, engine, evaluate in (("off", base, False), ("on", inst, True)):
        def one(engine=engine, evaluate=evaluate):
            engine.step()
            if evaluate:
                engine.health()
        syncs[name] = [_sync_counts(torch, one) for _ in range(2)]
    rec = {"gpu": smi, **cfg, "max_context": max_ctx,
           "off_tok_per_s": med([b["tok_per_s"] for b, _ in pairs]),
           "on_tok_per_s": med([i["tok_per_s"] for _, i in pairs]),
           "tok_per_s_ratio_median": med([i["tok_per_s"] / b["tok_per_s"]
                                          for b, i in pairs]),
           "host_ms_ratio_median": med([i["host_ms"] / b["host_ms"]
                                        for b, i in pairs]),
           "off_host_ms": med([b["host_ms"] for b, _ in pairs]),
           "on_host_ms": med([i["host_ms"] for _, i in pairs]),
           "off_dispatch_host_ms": med([b["dispatch_host_ms"]
                                        for b, _ in pairs]),
           "on_dispatch_host_ms": med([i["dispatch_host_ms"]
                                       for _, i in pairs]),
           "off_collect_host_ms": med([b["collect_host_ms"]
                                       for b, _ in pairs]),
           "on_collect_host_ms": med([i["collect_host_ms"]
                                      for _, i in pairs]),
           "windows": [{"off": b, "on": i} for b, i in pairs],
           "syncs_per_dispatch": {k: [{"sync_debug": a, "events": e}
                                      for a, e in v]
                                  for k, v in syncs.items()},
           "health": inst.health()["state"]}
    emit({"phase": "frontdoor_overhead_llama2_7b_bf16", **rec})
    check(syncs["on"] == syncs["off"],
          f"observability changed the syncs of a dispatch: {syncs}")
    check(all(e == 1 for _, e in syncs["on"]),
          f"a decode dispatch did not wait on exactly one event: {syncs}")
    del base, inst
    gc.collect()
    torch.cuda.empty_cache()


def _scrape(exporter, stop, seen):
    """The exporter's three endpoints, scraped until ``stop`` is set (a
    thread of its own; it touches no tensor)."""
    import urllib.error
    import urllib.request

    while True:
        for path in ("/metrics", "/healthz", "/slo"):
            try:
                with urllib.request.urlopen(exporter.url(path),
                                            timeout=5) as resp:
                    status, body = resp.status, resp.read()
            except urllib.error.HTTPError as e:
                status, body = e.code, e.read()
            seen.setdefault(path, []).append((status, len(body)))
        if stop.wait(0.2):
            return


def _door_overload(torch, model, smi, tmp):
    """Phase 16 (c): the reference's serving_overload row at its TPU
    configuration on the card: a capacity calibrated on a warm door, then
    96 requests arriving as Poisson at 3x that capacity, through a
    shedding door and a no-shed door (each warmed first: its first pump
    captures the quantum), both ending in ``drain(path)``. Per arm: time
    to first token of admitted requests by class (the stamps the
    registry's histogram observes; the registry has no class label, its
    own quantiles beside them) and from each request's scheduled arrival
    (a submission waits for the pump in flight), sheds by reason, preemptions, resumes,
    recomputed tokens, health and tokens/s. Checks: the drained journal
    and the Chrome trace validate, the attribution ledger's invariants
    hold, the exporter answers ``/metrics``, ``/healthz`` and ``/slo``
    during the shed arm, and the shed arm preempts."""
    import threading

    import numpy as np

    from paddle_tpu_torch.inference import serve
    from paddle_tpu_torch.obs import (FlightRecorder, MetricsExporter,
                                      SLOSet, load_flight_records,
                                      validate_chrome_trace)
    from paddle_tpu_torch.serving import (BATCH, INTERACTIVE, NORMAL,
                                          FrontDoorPolicy, no_shed_policy)

    cfg = FRONTDOOR_OVERLOAD
    vocab = model.config.vocab_size
    rng = np.random.RandomState(SEED)
    n_req, slots = cfg["requests"], cfg["slots"]
    p_lens = np.exp(rng.uniform(np.log(cfg["prompt"][0]),
                                np.log(cfg["prompt"][1]), n_req)).astype(int)
    n_news = np.exp(rng.uniform(np.log(cfg["new"][0]),
                                np.log(cfg["new"][1]), n_req)).astype(int)
    classes = [INTERACTIVE, NORMAL, BATCH, NORMAL, BATCH,
               NORMAL, INTERACTIVE, NORMAL, BATCH, NORMAL]
    requests = [(rng.randint(1, vocab, int(p)).astype(np.int32), int(n),
                 classes[i % len(classes)])
                for i, (p, n) in enumerate(zip(p_lens, n_news))]
    mean_new = float(np.mean([n for _, n, _ in requests]))
    max_ctx = max(p.shape[0] + n for p, n, _ in requests)
    max_ctx = -(-max_ctx // cfg["block"]) * cfg["block"]

    def build(shed):
        policy = (FrontDoorPolicy(shed_on_warn=(BATCH,),
                                  shed_on_critical=(BATCH,),
                                  max_waiting=2 * slots, preempt=True)
                  if shed else no_shed_policy(preempt=False))
        slo = SLOSet()
        return serve(model, policy=policy, slo=slo, trace=True,
                     flight=FlightRecorder(slo=slo, max_anomalies=4096),
                     num_slots=slots, block_size=cfg["block"],
                     prefill_chunk=cfg["chunk"],
                     decode_quantum=cfg["quantum"], max_context=max_ctx)

    def warm(door):
        for p, n, _ in requests[:slots]:
            door.submit(p, max_new_tokens=n)
        door.run_until_idle()

    calib = build(shed=False)
    warm(calib)                  # the capture pass
    for p, n, _ in requests[:slots]:
        calib.submit(p, max_new_tokens=n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calib.run_until_idle()
    calib_s = time.perf_counter() - t0
    capacity = sum(len(r.tokens) for r in calib.engine.completed[slots:]) \
        / calib_s
    del calib
    gc.collect()
    torch.cuda.empty_cache()
    req_rate = cfg["overload"] * capacity / mean_new
    arrivals = np.cumsum(rng.exponential(1.0 / req_rate, n_req))
    arrivals[0] = 0.0

    def run_arm(shed):
        door = build(shed)
        eng = door.engine
        warm(door)
        eng.completed.clear()
        eng.obs.reset()
        exporter = stop = scraper = None
        seen = {}
        if shed:
            exporter = MetricsExporter.for_engine(eng).start()
            stop = threading.Event()
            scraper = threading.Thread(target=_scrape,
                                       args=(exporter, stop, seen))
            scraper.start()
        try:
            submitted = 0
            scheduled = {}       # id(request) -> its Poisson arrival
            t0 = eng.obs.now()   # the clock the requests are stamped on
            while submitted < n_req or eng.has_work:
                now = eng.obs.now() - t0
                while submitted < n_req and arrivals[submitted] <= now:
                    p, n, pri = requests[submitted]
                    stream = door.submit(p, max_new_tokens=n, priority=pri)
                    scheduled[id(stream.request)] = t0 + arrivals[submitted]
                    submitted += 1
                if eng.has_work:
                    door.pump()
                elif submitted < n_req:
                    time.sleep(min(arrivals[submitted] - now, 0.01))
            path = os.path.join(tmp, f"flight_{'shed' if shed else 'noshed'}"
                                ".jsonl")
            drain = door.drain(path)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            if scraper is not None:
                stop.set()
                scraper.join(timeout=30)
                exporter.stop()
        done = eng.completed
        records = load_flight_records(path)
        validate_chrome_trace(eng.obs.tracer.chrome_trace())
        reasons = {}
        for r in records:
            ev = r["events"][-1]
            if ev["kind"] == "shed":
                reasons[ev["reason"]] = reasons.get(ev["reason"], 0) + 1
        check(sum(reasons.values()) == len(door.shed_requests),
              f"shed journals {reasons} != {len(door.shed_requests)} sheds")
        att = eng.attribution()
        raw = att["raw_counters"]
        check(sum(att["emitted_tokens"].values())
              == raw["serving_tokens_emitted_total"]
              and att["prefill_work_tokens"]["novel"]
              + att["prefill_work_tokens"]["recompute"]
              == raw["serving_prefill_tokens_total"],
              f"the attribution ledger does not conserve: {att}")
        # submissions happen between pumps, so a request's stamp can lag
        # its scheduled arrival by up to one pump: time to first token is
        # read from both (the registry observes it from the stamp)
        by_class, from_arrival = {}, {}
        for name, pri in (("interactive", INTERACTIVE), ("normal", NORMAL),
                          ("batch", BATCH)):
            rs = [r for r in done
                  if r.priority == pri and r.first_token_time is not None]
            for out, start in ((by_class, lambda r: r.arrival_time),
                               (from_arrival, lambda r: scheduled[id(r)])):
                ts = sorted(r.first_token_time - start(r) for r in rs)
                if ts:
                    out[name] = {"n": len(ts),
                                 "ttft_p50_s": ts[len(ts) // 2],
                                 "ttft_p95_s": ts[int(len(ts) * 0.95)]}
        lags = sorted(r.arrival_time - scheduled[id(r)] for r in done)
        reg = eng.obs.registry
        arm = {"gpu": smi, "shedding": shed, "completed": len(done),
               "shed": len(door.shed_requests), "shed_by_reason": reasons,
               "preempted": eng.scheduler.preempted_total,
               "resumed": eng.scheduler.resumed_total,
               "recomputed_tokens": reg.get(
                   "serving_tokens_recomputed_total").value(),
               "ttft_by_class": by_class,
               "ttft_from_scheduled_arrival_by_class": from_arrival,
               "submit_lag_s": {"p50": lags[len(lags) // 2],
                                "p95": lags[int(len(lags) * 0.95)],
                                "max": lags[-1]},
               "ttft_registry": _registry_ttft(reg),
               "tok_per_s": sum(len(r.tokens) for r in done) / wall,
               "wall_s": wall, "health": eng.health()["state"],
               "drain": {k: drain[k] for k in ("completed", "shed",
                                               "preempted", "resumed")},
               "flight_records": len(records),
               "useful_token_fraction": att["useful_token_fraction"],
               "trace_events": len(eng.obs.tracer)}
        if shed:
            arm["exporter"] = {k: {"answers": len(v),
                                   "statuses": sorted({s for s, _ in v})}
                               for k, v in seen.items()}
            for path_ in ("/metrics", "/healthz", "/slo"):
                check(any(s in (200, 503) for s, _ in seen.get(path_, ())),
                      f"the exporter did not answer {path_}: {seen}")
            check(arm["preempted"] >= 1, "the shed arm preempted nothing")
        del door, eng, done
        gc.collect()
        torch.cuda.empty_cache()
        return arm

    shed_arm = run_arm(True)
    noshed_arm = run_arm(False)
    emit({"phase": "frontdoor_overload_llama2_7b_bf16", **cfg,
          "gpu": smi, "calibrated_capacity_tok_per_s": capacity,
          "offered_req_per_s": req_rate, "mean_new_tokens": mean_new,
          "max_context": max_ctx, "shed_arm": shed_arm,
          "no_shed_arm": noshed_arm})


def _preempt_trace(torch, model, prefix_cache):
    """Phase 16 (d)'s trace: a system prompt and 6 tails; undisturbed
    through a bare engine, then through the front door with the first 4
    as BATCH (each decoding in the captured quantum) and the last 2 as
    INTERACTIVE arrivals that preempt them. Returns (undisturbed streams,
    front door streams, front door stats)."""
    import numpy as np

    from paddle_tpu_torch import create_serving_engine
    from paddle_tpu_torch.inference import serve
    from paddle_tpu_torch.serving import BATCH, INTERACTIVE, FrontDoorPolicy

    cfg = FRONTDOOR_PREEMPT
    vocab = model.config.vocab_size
    rng = np.random.RandomState(SEED + 5)
    system = rng.randint(1, vocab, cfg["system"]).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(1, vocab, n).astype(
        np.int32)]) for n in cfg["tails"]]
    kw = dict(num_slots=cfg["slots"], block_size=32, prefill_chunk=128,
              decode_quantum=8, max_context=512, prefix_cache=prefix_cache)
    calm = create_serving_engine(model, **kw)
    want = [calm.submit(p, max_new_tokens=cfg["new"]) for p in prompts]
    calm.run()
    want = [list(r.tokens) for r in want]
    del calm
    door = serve(model, policy=FrontDoorPolicy(shed_on_warn=(),
                                               shed_on_critical=()), **kw)
    low = [door.submit(p, max_new_tokens=cfg["new"], priority=BATCH)
           for p in prompts[:cfg["slots"]]]
    while min(len(s.request.tokens) for s in low) < 4:
        door.pump()
    check(door.engine._graph is not None,
          "the victims were not decoding in the captured quantum")
    high = [door.submit(p, max_new_tokens=cfg["new"], priority=INTERACTIVE)
            for p in prompts[cfg["slots"]:]]
    door.run_until_idle()
    got = [list(s.request.tokens) for s in low + high]
    st = door.stats()
    check_run(door.engine, [s.request for s in low + high], vocab)
    stats = {"preempted": st["preempted"], "resumed": st["resumed"],
             "recomputed_tokens": door.engine.obs.registry.get(
                 "serving_tokens_recomputed_total").value(),
             "prefix_cache": st.get("prefix_cache")}
    check(stats["preempted"] >= 1 and stats["resumed"] == stats["preempted"],
          f"the trace did not preempt and resume: {stats}")
    del door
    gc.collect()
    torch.cuda.empty_cache()
    return want, got, stats


def _door_preemption(torch, dev, smi, model):
    """Phase 16 (d): recompute-on-resume under the captured quantum. In
    f32 at Llama-2-7B width with 4 layers the preempted-and-resumed
    streams equal the undisturbed run's, without and with the prefix
    cache; in bf16 on phase 3's model their agreement is recorded
    (a re-prefill batches rows otherwise than the decode steps did)."""
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    rec = {"gpu": smi, **FRONTDOOR_PREEMPT}
    for prefix_cache in (False, True):
        want, got, stats = _preempt_trace(torch, model, prefix_cache)
        rec[f"bf16_prefix_{prefix_cache}"] = {
            "agreement": _agreement(got, want), **stats}
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=4, dtype="float32")
    f32 = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 6))
    for prefix_cache in (False, True):
        want, got, stats = _preempt_trace(torch, f32, prefix_cache)
        rec[f"f32_prefix_{prefix_cache}"] = {"streams_equal": got == want,
                                             **stats}
    emit({"phase": "frontdoor_preemption", **rec})
    for prefix_cache in (False, True):
        check(rec[f"f32_prefix_{prefix_cache}"]["streams_equal"],
              f"f32 preempted streams (prefix_cache={prefix_cache}) differ "
              f"from the undisturbed run's")
    del f32
    gc.collect()
    torch.cuda.empty_cache()


def frontdoor_phase(torch, dev, smi, model, requests):
    """Phase 16: the serving front door on phase 3's Llama-2-7B bf16 model
    (before phase 15, which scales its tails): (a) the streams, (b) the
    observability overhead, (c) overload, (d) recompute-on-resume. Returns
    (a)'s launches as ``frontdoor``."""
    import tempfile

    t0 = time.perf_counter()
    launches = _door_streams(torch, model, requests, smi)
    _door_overhead(torch, model, smi)
    with tempfile.TemporaryDirectory() as tmp:
        _door_overload(torch, model, smi, tmp)
    _door_preemption(torch, dev, smi, model)
    emit({"phase": "frontdoor", "gpu": smi,
          "wall_s": time.perf_counter() - t0})
    return {"frontdoor": launches}


# ---------------------------------------------------------------- phase 17
# (b): the fault plan at full depth (each fires at its first eligible
# calls), the poisoned request of phase 3's 16 and the new tokens of the
# second wave that attaches the cached chains; (c): the dispatches before
# the snapshot; (d): the two system prompts' length (4 blocks of 32)
RESILIENCE_FAULTS = (("decode", "raise", 2), ("mixed", "raise", 1),
                     ("alloc", "alloc_fail", 1), ("kv", "bit_flip", 1))
RESILIENCE_POISON = 5
RESILIENCE_WAVE_NEW = 4
RESTORE_AFTER_STEPS = 24
CLUSTER_SYSTEM = 128
# steady dispatches before (b)'s timed windows: the watchdog arms after
# its policy's min_samples (16) observations
WATCHDOG_WARM = 16


def _f32_model(torch, dev, layers, seed):
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=layers, dtype="float32")
    return LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed))


def _free(torch):
    """Collect the dropped engines and give their memory back."""
    gc.collect()
    torch.cuda.empty_cache()


def _soaks(torch, dev, smi, f32):
    """Phase 17 (a): the two-arm chaos soak (faults x preemption x
    copy-on-write) at Llama-2-7B width in f32 with 4 layers, rounds 50,
    seed 0, then its speculative arm with a 1-layer draft of the same
    width, rounds 60. ``run_soak`` asserts itself that every non-poisoned
    stream equals the fault-free arm's, that every request ends with a
    definite reason and that no block leaks."""
    from paddle_tpu_torch.serving import run_soak

    t0 = time.perf_counter()
    rep = run_soak(f32, rounds=50, seed=0, device=dev)
    plain_s = time.perf_counter() - t0
    draft = _f32_model(torch, dev, 1, SEED + 8)
    t0 = time.perf_counter()
    spec = run_soak(f32, spec_draft=draft, rounds=60, seed=0, device=dev)
    spec_s = time.perf_counter() - t0
    emit({"phase": "resilience_soak_llama2_7b_f32", "gpu": smi,
          "layers": 4, "plain": {**rep, "wall_s": plain_s},
          "speculative": {**spec, "wall_s": spec_s}})
    for r in (rep, spec):
        check(r["faults_injected"] > 0, f"the soak injected nothing: {r}")
        check(r["bitexact_streams"] == r["requests"] - len(r["poisoned"]),
              f"the soak lost streams: {r}")
    del draft
    _free(torch)


def _fault_plan():
    from paddle_tpu_torch.serving import FaultInjector, FaultSpec

    return FaultInjector(plan=[FaultSpec(site, kind, times=n)
                               for site, kind, n in RESILIENCE_FAULTS],
                         seed=SEED)


def _faults_full_depth(torch, smi, model, requests, want):
    """Phase 17 (b): phase 3's 16 requests at Llama-2-7B bf16 (32 layers)
    with ``resilience=True``, the prefix cache on and the injector's plan
    (transient decode and mixed raises, an allocation failure, one
    poisoned request, a bit flip in a cached block), then the same prompts
    again (4 new tokens each), whose attach finds the flipped chain. Every
    request ends with a definite reason, the poisoned one with "error";
    the flip is quarantined; the pools drain. The non-poisoned streams'
    agreement with phase 3's undisturbed run is recorded. Returns the
    first wave's launches (counters zeroed just before, read just
    after)."""
    from paddle_tpu_torch import create_serving_engine, ops
    from paddle_tpu_torch.serving import ResiliencePolicy

    inj = _fault_plan()
    engine = create_serving_engine(
        model, faults=inj, resilience=ResiliencePolicy(),
        **serve_kw(prefix_cache=True))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    reqs = [engine.submit(**r) for r in requests]
    inj.poison(reqs[RESILIENCE_POISON].req_id)
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for name in SERVING_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched under faults")
    check(engine._graph is not None,
          "the faulted engine's decode quantum did not run as a graph")
    wave = [engine.submit(r["prompt"], max_new_tokens=RESILIENCE_WAVE_NEW)
            for r in requests]
    engine.run()
    rep = engine.resilience_report()
    for i, r in enumerate(reqs + wave):
        poisoned = i == RESILIENCE_POISON
        check(r.finished and r.finish_reason == ("error" if poisoned
                                                 else "length"),
              f"request {r.req_id} ended {r.finish_reason}")
    check(rep["quarantined"] == [str(reqs[RESILIENCE_POISON].req_id)],
          f"the poisoned request was not quarantined: {rep}")
    check(any("block" in j for j in inj.journal),
          f"no cached block was flipped: {inj.journal}")
    check(rep["prefix_quarantines"] >= 1,
          f"the flipped block was not quarantined: {rep}")
    for pool in engine._pools():
        st = pool.fragmentation_stats()
        check(st["blocks_in_use"] == 1 + pool.cached_blocks,
              f"the faulted engine leaked blocks: {st}")
    keep = [i for i in range(len(reqs)) if i != RESILIENCE_POISON]
    got = [list(reqs[i].tokens) for i in keep]
    rec = {"gpu": smi, "requests": len(reqs), "wave": len(wave),
           "wall_s": wall, "generated_tokens": sum(len(g) for g in got),
           "agreement_with_undisturbed": _agreement(
               got, [want[i] for i in keep]),
           "streams_equal_undisturbed": sum(
               g == want[i] for g, i in zip(got, keep)),
           "report": rep, "journal": inj.journal,
           "watchdog_deadline_s": engine.watchdog.deadline("decode"),
           "prefix_cache": engine.pool.prefix_cache_stats(),
           "launches": launches}
    emit({"phase": "resilience_faults_llama2_7b_bf16", **rec})
    del engine, reqs, wave
    _free(torch)
    return launches


def _resilience_overhead(torch, smi, model):
    """Phase 17 (b), continued: steady decode dispatches of the default
    engine against ``resilience=True`` (phase 16 (b)'s configuration and
    windows, after WATCHDOG_WARM dispatches that arm the watchdog): the
    median ratio of tokens/s and of host ms a dispatch, the watchdog's
    deadline and trips, and the synchronizing calls of a dispatch in both
    arms, which must be equal: one event wait and no other sync."""
    import numpy as np

    from paddle_tpu_torch import create_serving_engine

    cfg = FRONTDOOR_STEADY
    vocab = model.config.vocab_size
    rng = np.random.RandomState(SEED)
    t_steps, plen = cfg["quantum"], cfg["prompt"]
    max_ctx = plen + t_steps * (2 * cfg["windows"] + 4 + WATCHDOG_WARM) + 8
    max_ctx = -(-max_ctx // cfg["block"]) * cfg["block"]

    def steady(**kw):
        engine = create_serving_engine(
            model, num_slots=cfg["slots"], block_size=cfg["block"],
            prefill_chunk=plen, decode_quantum=t_steps, max_context=max_ctx,
            **kw)
        for _ in range(cfg["slots"]):
            engine.submit(rng.randint(1, vocab, plen).astype(np.int32),
                          max_new_tokens=max_ctx - plen - 4)
        while (engine.scheduler.prefilling()
               or not engine.scheduler.decoding()):
            engine.step()
        engine.step()           # the warm-up and the capture
        check(engine._graph is not None, "a steady engine did not capture")
        for _ in range(WATCHDOG_WARM):
            engine.step()
        return engine

    def window(engine):
        g0 = int(engine._n_gen.sum())
        host = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cfg["dispatches"]):
            a = time.perf_counter()
            pending = engine.step_dispatch()
            b = time.perf_counter()
            check(pending is not None, "a timed step was no decode dispatch")
            pending["event"].synchronize()      # the card is done
            c = time.perf_counter()
            engine.step_collect(pending)
            host += (b - a) + (time.perf_counter() - c)
        wall = time.perf_counter() - t0
        return {"tok_per_s": (int(engine._n_gen.sum()) - g0) / wall,
                "host_ms": 1e3 * host / cfg["dispatches"]}

    base = steady()
    armed = steady(resilience=True)
    pairs = [(window(base), window(armed)) for _ in range(cfg["windows"])]
    syncs = {name: [_sync_counts(torch, engine.step) for _ in range(2)]
             for name, engine in (("default", base), ("resilience", armed))}

    def med(xs):
        return float(np.median(xs))

    rec = {"gpu": smi, **cfg, "max_context": max_ctx,
           "default_tok_per_s": med([b["tok_per_s"] for b, _ in pairs]),
           "resilience_tok_per_s": med([a["tok_per_s"] for _, a in pairs]),
           "tok_per_s_ratio_median": med([a["tok_per_s"] / b["tok_per_s"]
                                          for b, a in pairs]),
           "default_host_ms": med([b["host_ms"] for b, _ in pairs]),
           "resilience_host_ms": med([a["host_ms"] for _, a in pairs]),
           "host_ms_ratio_median": med([a["host_ms"] / b["host_ms"]
                                        for b, a in pairs]),
           "windows": [{"default": b, "resilience": a} for b, a in pairs],
           "watchdog": armed.resilience_report()["watchdog"],
           "watchdog_deadline_s": armed.watchdog.deadline("decode"),
           "graph_launches_per_replay": {"default": base._graph.launches,
                                         "resilience": armed._graph.launches},
           "syncs_per_dispatch": {k: [{"sync_debug": a, "events": e}
                                      for a, e in v]
                                  for k, v in syncs.items()}}
    emit({"phase": "resilience_overhead_llama2_7b_bf16", **rec})
    check(syncs["resilience"] == syncs["default"],
          f"resilience changed the syncs of a dispatch: {syncs}")
    check(all(e == 1 for _, e in syncs["resilience"]),
          f"a decode dispatch did not make exactly one event wait: {syncs}")
    check(base._graph.launches == armed._graph.launches,
          "resilience changed the captured quantum's launches")
    del base, armed
    _free(torch)


def _snapshot_restore(torch, model, requests, want):
    """A run of ``requests`` snapshotted after RESTORE_AFTER_STEPS steps
    (a JSON round trip), the engine dropped, a fresh one restored on the
    same model and run to the end. Returns the streams and the record."""
    from paddle_tpu_torch import create_serving_engine
    from paddle_tpu_torch.serving import ServingEngine

    engine = create_serving_engine(model, **serve_kw())
    reqs = [engine.submit(**r) for r in requests]
    for _ in range(RESTORE_AFTER_STEPS):
        engine.step()
    snap = json.loads(json.dumps(engine.snapshot()))
    done = {str(r.req_id): list(r.tokens) for r in engine.completed}
    ids = [str(r.req_id) for r in reqs]
    inflight = {st["req_id"]: len(st["tokens"]) for st in snap["inflight"]}
    del engine, reqs          # the crash: the pools go before the restore
    _free(torch)
    t0 = time.perf_counter()
    restored = ServingEngine.restore(snap, model)
    restored.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_run(restored, restored.completed, model.config.vocab_size)
    check(restored._graph is not None,
          "the restored engine's decode quantum did not run as a graph")
    done.update({str(r.req_id): list(r.tokens) for r in restored.completed})
    got = [done[i] for i in ids]
    rec = {"inflight": len(inflight),
           "resumed_tokens": sum(inflight.values()),
           "restore_wall_s": wall,
           "restores": restored.obs.registry.get(
               "serving_restores_total").value()}
    del restored
    _free(torch)
    return got, rec


def _restores(torch, smi, model, f32, requests, want):
    """Phase 17 (c): snapshot mid-run, drop the engine, restore, finish.
    In f32 at 4 layers the streams equal the undisturbed run's; in bf16 at
    32 layers (phase 3's model) their agreement is recorded."""
    from paddle_tpu_torch import create_serving_engine

    calm = create_serving_engine(f32, **serve_kw())
    want4 = [calm.submit(**r) for r in requests]
    calm.run()
    want4 = [list(r.tokens) for r in want4]
    del calm
    _free(torch)
    got4, rec4 = _snapshot_restore(torch, f32, requests, want4)
    got, rec = _snapshot_restore(torch, model, requests, want)
    emit({"phase": "resilience_restore", "gpu": smi,
          "after_steps": RESTORE_AFTER_STEPS,
          "f32_4_layers": {**rec4, "streams_equal": got4 == want4},
          "bf16_32_layers": {**rec, "agreement": _agreement(got, want)}})
    check(rec4["inflight"] > 0 and rec["inflight"] > 0,
          "the snapshot caught no request in flight")
    check(got4 == want4, "f32 restored streams differ from the undisturbed "
          "run's")


def _ring_owner(tokens, replicas=2, vnodes=32):
    """The replica a 2-replica router's ring gives ``tokens``' affinity
    key (``ClusterRouter._ring_lookup`` over its default vnodes)."""
    import bisect

    from paddle_tpu_torch.serving import prompt_prefix_key
    from paddle_tpu_torch.serving.cluster import _string_key

    key = prompt_prefix_key(tokens, serve_kw()["block_size"], max_blocks=4)
    ring = sorted((_string_key(f"r{i}#{v}"), f"r{i}")
                  for i in range(replicas) for v in range(vnodes))
    return ring[bisect.bisect_left(ring, (key,)) % len(ring)][1]


def _cluster_trace(requests, vocab):
    """Phase 3's trace over two shared system prompts, which the ring
    gives to different replicas (so that both replicas decode)."""
    import numpy as np

    rng = np.random.RandomState(SEED + 9)
    first = rng.randint(1, vocab, CLUSTER_SYSTEM).astype(np.int32)
    second = rng.randint(1, vocab, CLUSTER_SYSTEM).astype(np.int32)
    while _ring_owner(second) == _ring_owner(first):
        second = rng.randint(1, vocab, CLUSTER_SYSTEM).astype(np.int32)
    systems = (first, second)
    return [dict(r, prompt=np.concatenate([systems[i % 2], r["prompt"]]))
            for i, r in enumerate(requests)]


def _run_cluster(torch, model, trace, roles, exporter_seen=None):
    import threading

    from paddle_tpu_torch import create_serving_engine
    from paddle_tpu_torch.obs import ClusterExporter
    from paddle_tpu_torch.serving import (ClusterFrontDoor, ClusterReplica,
                                          ClusterRouter, no_shed_policy)

    reps = [ClusterReplica(f"r{i}", create_serving_engine(
        model, **serve_kw(prefix_cache=True)), role=role,
        policy=no_shed_policy()) for i, role in enumerate(roles)]
    cfd = ClusterFrontDoor(ClusterRouter(reps))
    t0 = time.perf_counter()
    streams = [cfd.submit(r["prompt"], max_new_tokens=r["max_new_tokens"])
               for r in trace]
    if exporter_seen is None:
        cfd.run_until_idle()
    else:
        with ClusterExporter.for_cluster(cfd) as exp:
            stop = threading.Event()
            th = threading.Thread(target=_scrape,
                                  args=(exp, stop, exporter_seen))
            th.start()
            try:
                cfd.run_until_idle()
            finally:
                stop.set()
                th.join()
    wall = time.perf_counter() - t0
    got = [list(s.result()) for s in streams]
    for rep in reps:
        check_run(rep.engine, [], model.config.vocab_size)
    stats = {"wall_s": wall, "router": cfd.router.affinity_stats(),
             "handoffs": cfd.router._c_handoffs.value(),
             "per_replica": {r.name: r.engine.stats["decode_quanta"]
                             for r in reps}}
    del cfd, reps, streams
    _free(torch)
    return got, stats


def _cluster(torch, smi, f32, requests):
    """Phase 17 (d): two replicas (sharing the f32 4-layer model, their
    graphs replaying on one stream) over phase 3's trace with two shared
    system prompts, a ``ClusterExporter`` scraped from a thread meanwhile:
    affinity hits > 0 and the streams equal a cluster of one's; then the
    prefill/decode hand-off, whose streams equal a single replica's."""
    trace = _cluster_trace(requests, f32.config.vocab_size)
    one, one_st = _run_cluster(torch, f32, trace, ["general"])
    seen = {}
    two, two_st = _run_cluster(torch, f32, trace, ["general", "general"],
                               exporter_seen=seen)
    hand, hand_st = _run_cluster(torch, f32, trace, ["prefill", "decode"])
    emit({"phase": "resilience_cluster_f32", "gpu": smi, "layers": 4,
          "requests": len(trace), "system_prompt": CLUSTER_SYSTEM,
          "one": one_st, "two": two_st, "handoff": hand_st,
          "two_equal_one": two == one, "handoff_equal_one": hand == one,
          "scrapes": {p: len(v) for p, v in seen.items()}})
    check(two_st["router"]["affinity_hits"] > 0,
          f"no request landed on its prefix's replica: {two_st}")
    check(all(n > 0 for n in two_st["per_replica"].values()),
          f"a replica did not decode: {two_st}")
    check(two == one, "the 2-replica streams differ from a cluster of one's")
    check(hand_st["handoffs"] > 0 and hand == one,
          "the hand-off's streams differ from a single replica's")
    check(seen.get("/metrics") and all(s == 200 for s, _ in seen["/metrics"]),
          f"the cluster exporter's /metrics failed: {seen}")


def _obs_check_cli(smi):
    """Phase 17 (e): ``python -m paddle_tpu_torch.obs check --device cuda``
    as a subprocess: rc 0, its lines printed."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.obs", "check", "--device",
         "cuda"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    for ln in lines:
        print(f"obs check: {ln}", flush=True)
    emit({"phase": "resilience_obs_check", "gpu": smi, "rc": out.returncode,
          "wall_s": time.perf_counter() - t0, "lines": len(lines),
          "stderr_tail": out.stderr[-2000:]})
    check(out.returncode == 0, f"obs check failed: {out.stderr[-2000:]}")


def resilience_phase(torch, dev, smi, model, requests, want):
    """Phase 17: resilience, crash recovery and the cluster on phase 3's
    Llama-2-7B bf16 model (before phase 15, which scales its tails) and an
    f32 4-layer model of the same width: (a) the soaks, (b) faults at full
    depth and the tier's dispatch overhead, (c) snapshot / restore, (d)
    the cluster, (e) the ``obs check`` command line. Returns (b)'s
    launches as ``resilience``."""
    t0 = time.perf_counter()
    f32 = _f32_model(torch, dev, 4, SEED + 7)
    _soaks(torch, dev, smi, f32)
    launches = _faults_full_depth(torch, smi, model, requests, want)
    _resilience_overhead(torch, smi, model)
    _restores(torch, smi, model, f32, requests, want)
    _cluster(torch, smi, f32, requests)
    del f32
    _free(torch)
    _obs_check_cli(smi)
    emit({"phase": "resilience", "gpu": smi,
          "wall_s": time.perf_counter() - t0})
    return {"resilience": launches}


# ---------------------------------------------------------------- phase 18
def _lora_counts(layers, steps, backward_norms):
    """Launches of ``steps`` LoRA steps over ``layers`` decoder layers
    (q_proj / v_proj adapted, everything else frozen): K1 at every norm,
    K4 and K7 once a layer; K6 at every norm whose input needs a gradient,
    which is all but layer 0's input norm (its input is the frozen
    embedding's output) when ``backward_norms``."""
    return {"rms_norm": (2 * layers + 1) * steps,
            "rms_norm_bwd": 2 * layers * steps if backward_norms else 0,
            "attn": layers * steps}


def _lora_model(torch, dev, cfg, seed, dtype=None, r=8, alpha=16):
    """A seeded Llama in ``cfg.dtype``, decorated to ``dtype`` at O2 when
    given, then LoRA on q_proj / v_proj (the reference's defaults)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.peft import LoRAConfig, get_lora_model

    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed))
    if dtype is not None:
        model = amp.decorate(model, level="O2", dtype=dtype)
    return get_lora_model(
        model, LoRAConfig(r=r, lora_alpha=alpha),
        generator=torch.Generator(device=dev).manual_seed(seed + 1))


def _adapters(lora):
    return [(n, p) for n, p in lora.named_parameters() if p.requires_grad]


def _host_copy(torch, lora):
    """Every frozen parameter copied to the host (the bit-equality
    reference, off the card's memory)."""
    return {n: p.detach().to("cpu", copy=True)
            for n, p in lora.named_parameters() if not p.requires_grad}


def _frozen_equal(torch, lora, snap):
    return all(torch.equal(p.detach().cpu(), snap[n])
               for n, p in lora.named_parameters() if n in snap)


def _scale_rule(init, found, incr_every, decr_every, incr=2.0, decr=0.5):
    """The reference's GradScaler.update over a found-inf sequence: the
    scale after each step."""
    scale, good, bad, out = init, 0, 0, []
    for f in found:
        if f:
            bad, good = bad + 1, 0
            if bad >= decr_every:
                scale, bad = max(scale * decr, 1.0), 0
        else:
            good, bad = good + 1, 0
            if good >= incr_every:
                scale, good = scale * incr, 0
        out.append(scale)
    return out


def lora_phase(torch, dev, smi):
    """Phase 18: LoRA fine-tuning of Llama-2-7B under amp. (a) bf16 O2 at
    full size through JittedTrainStep in InstrumentedTrainStep, (d) merge
    and unmerge on (a)'s model, (b) f32 kernel path against plain path at
    two layers, (c) fp16 O1 with GradScaler at four layers. Returns the
    ``lora`` (a) and ``lora_fp16`` (c) launch counts."""
    from paddle_tpu_torch import amp, ops
    from paddle_tpu_torch.jit import JittedTrainStep
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaPretrainingCriterion
    from paddle_tpu_torch.obs import InstrumentedTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import transformer_train_flops

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # (a) -----------------------------------------------------------------
    b, seq, warm, steps = LORA_SHAPE
    cfg = LlamaConfig.llama2_7b(tensor_parallel=False)  # f32 weights
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    lora = _lora_model(torch, dev, cfg, SEED + 18, dtype="bfloat16")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(all(p.dtype == torch.bfloat16 for n, p in lora.named_parameters()
              if not p.requires_grad)
          and all(p.dtype == torch.float32 for _, p in _adapters(lora)),
          "decorate(O2) left a frozen weight outside bf16, or an adapter "
          "outside f32")
    n_params = sum(p.numel() for p in lora.parameters())
    n_train = sum(p.numel() for _, p in _adapters(lora))
    snap = _host_copy(torch, lora)
    crit = LlamaPretrainingCriterion(cfg)
    opt = AdamW(3e-4, parameters=_adapters(lora), multi_precision=True)
    step = JittedTrainStep(lora, lambda out, lb: crit(out, lb), opt)
    tokens = b * seq
    inst = InstrumentedTrainStep.for_transformer(
        step, n_params=n_params, tokens_per_step=tokens, num_layers=layers,
        seq_len=seq, hidden=cfg.hidden_size)
    ids = _train_ids(torch, dev, cfg.vocab_size, b, seq)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        for _ in range(warm):
            losses.append(float(inst(ids, ids)))
        ops.reset_launches()
        inst.registry.reset()
        inst._times.clear()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        ev[0].record()
        for i in range(steps):
            losses.append(inst(ids, ids))
            ev[i + 1].record()
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    event_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    c = _lora_counts(layers, steps, True)
    want = {k: 0 for k in launches}
    want.update(rms_norm=c["rms_norm"], rms_norm_bwd=c["rms_norm_bwd"],
                flash_attention=c["attn"], flash_attention_bwd=c["attn"])
    check(launches == want,
          f"LoRA O2 launches {launches}, expected {want}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"the LoRA loss did not fall: {losses}")
    frozen_ok = _frozen_equal(torch, lora, snap)
    check(frozen_ok, "a frozen parameter moved during LoRA training")
    reg = inst.registry
    rep = inst.report()
    step_s = statistics.median(event_ms) / 1e3
    flops_6nt = transformer_train_flops(n_params, tokens, num_layers=layers,
                                        seq_len=seq, hidden=cfg.hidden_size)
    # LoRA's own work: the frozen weights take no weight gradient, so 4NT
    # (forward 2NT, input gradients 2NT) plus attention's forward and
    # backward
    flops_lora = flops_6nt - 2.0 * n_params * tokens
    emit({"phase": "lora_llama2_7b_bf16_o2", "gpu": smi, "layers": layers,
          "params": n_params, "trainable_params": n_train,
          "rank": lora.lora_config.r, "batch": b, "seq": seq,
          "warmup_steps": warm, "timed_steps": steps,
          "step_ms_events": event_ms, "step_ms_median_events": 1e3 * step_s,
          "tok_per_s_events": tokens / step_s,
          "registry": {
              "train_steps_total": reg.get("train_steps_total").value(),
              "train_tokens_per_second":
                  reg.get("train_tokens_per_second").value(),
              "train_mfu": reg.get("train_mfu").value(),
              "train_model_tflops_per_second":
                  reg.get("train_model_tflops_per_second").value()},
          "report": rep,
          "mfu_6nt_events": flops_6nt / step_s / PEAK_FLOPS["bfloat16"],
          "mfu_lora_4nt_events": flops_lora / step_s
          / PEAK_FLOPS["bfloat16"],
          "losses": losses, "launches": launches,
          "launches_per_step": {k: v // steps for k, v in launches.items()
                                if v},
          "frozen_bit_equal": frozen_ok, "model_init_s": init_s,
          "peak_mem_gb": peak_gb,
          # bf16 weights and gradients, f32 masters, bf16 moments: the
          # full-parameter step phase 7 runs, without activations
          "full_param_state_gb": 12 * n_params / 2 ** 30})
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        train_profile(torch, step, ids, ids, label="lora_step")
    del inst, step, opt, snap
    gc.collect()
    torch.cuda.empty_cache()

    # (d) merge then unmerge on (a)'s model -------------------------------
    from paddle_tpu_torch.peft import LoRALinear

    layers_l = [m for m in lora.modules() if isinstance(m, LoRALinear)]
    with torch.no_grad():
        w0 = [m.base.weight.detach().clone() for m in layers_l]
        deltas = [m._delta(m.base.weight.dtype) for m in layers_l]
    short = ids[:, :512]
    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        adapted = lora(short).float()
        lora.merge()
        merged = lora(short).float()
        merged_w = [m.base.weight.detach().clone() for m in layers_l]
        lora.unmerge()
        again = lora(short).float()
    fold_exact = all(torch.equal(mw, w + d)
                     for mw, w, d in zip(merged_w, w0, deltas))
    eps = torch.finfo(torch.bfloat16).eps
    unmerge_ulps = max(
        float(((m.base.weight.float() - w.float()).abs()
               / (eps * torch.maximum(w.float().abs(), mw.float().abs())
                  .clamp_min(torch.finfo(torch.bfloat16).tiny))).max())
        for m, w, mw in zip(layers_l, w0, merged_w))
    scale = float(adapted.abs().max())
    merge_rel = float((merged - adapted).abs().max()) / scale
    again_rel = float((again - adapted).abs().max()) / scale
    top1 = float((merged.argmax(-1) == adapted.argmax(-1)).float().mean())
    emit({"phase": "lora_llama2_7b_merge", "gpu": smi, "tokens": 512,
          "wrapped_layers": len(layers_l), "fold_bit_exact": fold_exact,
          "unmerge_max_ulps": unmerge_ulps,
          "merged_vs_adapted_rel_to_max": merge_rel,
          "unmerged_vs_adapted_rel_to_max": again_rel,
          "merged_top1_agreement": top1})
    check(fold_exact, "merge did not fold W + bf16(A @ B * scaling)")
    check(unmerge_ulps <= 1.0, f"unmerge left {unmerge_ulps} bf16 ulps")
    check(math.isfinite(merge_rel) and merge_rel <= 2.0 ** -4,
          f"merged logits part from the adapted forward: {merge_rel}")
    del lora, w0, deltas, merged_w, adapted, merged, again
    gc.collect()
    torch.cuda.empty_cache()

    # (b) f32 parity, no amp ----------------------------------------------
    pseq, psteps = LORA_PARITY_SHAPE
    pcfg = LlamaConfig.llama2_7b(num_hidden_layers=2, tensor_parallel=False)
    pids = _train_ids(torch, dev, pcfg.vocab_size, 1, pseq)
    runs = []
    for plain in (False, True):
        lora = _lora_model(torch, dev, pcfg, SEED + 21)
        crit = LlamaPretrainingCriterion(pcfg)
        step = JittedTrainStep(lora, lambda out, lb: crit(out, lb),
                               AdamW(1e-3, parameters=_adapters(lora)))
        ops.reset_launches()
        with (ops.plain_versions() if plain else contextlib.nullcontext()):
            loss = crit(lora(pids), pids)
            loss.backward()
            grads = {n: p.grad.detach().clone() for n, p in _adapters(lora)}
            lora.zero_grad(set_to_none=True)
            plosses, walls = _timed_steps(step, pids, pids, psteps)
        pl = dict(ops.LAUNCHES)
        if plain:
            check(all(v == 0 for v in pl.values()),
                  f"the plain LoRA path launched a kernel: {pl}")
        else:
            c = _lora_counts(2, 1 + psteps, True)
            want = {k: 0 for k in pl}
            want.update(rms_norm=c["rms_norm"],
                        rms_norm_bwd=c["rms_norm_bwd"],
                        flash_attention_f32=c["attn"],
                        flash_attention_bwd_f32=c["attn"])
            check(pl == want, f"LoRA f32 launches {pl}, expected {want}")
        emit({"phase": "lora_parity_f32_2layer",
              "path": "plain" if plain else "kernels", "seq": pseq,
              "losses": plosses, "step_wall_ms": walls, "launches": pl})
        runs.append((grads, plosses))
        del lora, step, loss
        torch.cuda.empty_cache()
    (gk, lk), (gp, lp) = runs
    worst = max(float((gk[n] - gp[n]).abs().max())
                / max(float(gp[n].abs().max()), 1e-30) for n in gp)
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(lk, lp))
    emit({"phase": "lora_parity_f32_2layer", "adapters": len(gp),
          "grad_worst_rel_to_max": worst, "loss_worst_rel": loss_rel})
    check(worst <= 1e-4, f"LoRA kernel and plain grads differ: {worst}")
    check(loss_rel <= 1e-4, f"LoRA kernel and plain losses differ: {lk} "
          f"{lp}")

    # (c) fp16 O1 with GradScaler -----------------------------------------
    flayers, fseq, fsteps = LORA_FP16_SHAPE
    fcfg = LlamaConfig.llama2_7b(num_hidden_layers=flayers,
                                 tensor_parallel=False)  # f32 weights
    lora = _lora_model(torch, dev, fcfg, SEED + 23)
    crit = LlamaPretrainingCriterion(fcfg)
    opt = AdamW(1e-3, parameters=_adapters(lora))
    # 2^24 overflows the fp16 gradients of the LoRA factors (sums over
    # 4,096 tokens): the scaler halves to a scale that fits, then doubles
    # after two good steps
    init_scale, incr_every, decr_every = 2.0 ** 24, 2, 1
    scaler = amp.GradScaler(init_loss_scaling=init_scale,
                            incr_every_n_steps=incr_every,
                            decr_every_n_nan_or_inf=decr_every)
    fids = _train_ids(torch, dev, fcfg.vocab_size, 1, fseq)
    found, scales, flosses, skipped_equal = [], [], [], []
    ops.reset_launches()
    fp16_launches = None
    for i in range(fsteps):
        before = {n: p.detach().clone() for n, p in lora.named_parameters()}
        step_count = opt._step_count
        ops.reset_launches()
        with amp.auto_cast(dtype="float16"):
            loss = crit(lora(fids), fids)
        scaler.minimize(opt, scaler.scale(loss))
        torch.cuda.synchronize()
        sl = dict(ops.LAUNCHES)
        want = {k: 0 for k in sl}
        want.update(rms_norm=2 * flayers + 1, rms_norm_bwd=2 * flayers,
                    flash_attention_f16=flayers,
                    flash_attention_bwd_f16=flayers)
        check(sl == want, f"fp16 O1 step {i} launches {sl}, expected {want}")
        fp16_launches = {k: (fp16_launches or {}).get(k, 0) + v
                         for k, v in sl.items()}
        found.append(bool(scaler._found_inf))
        scales.append(scaler._scale)
        flosses.append(float(loss.detach()))
        if scaler._found_inf:
            same = opt._step_count == step_count and all(
                torch.equal(p, before[n]) for n, p in lora.named_parameters())
            skipped_equal.append(same)
            check(same, f"skipped fp16 step {i} changed a parameter")
        del before
    want_scales = _scale_rule(init_scale, found, incr_every, decr_every)
    emit({"phase": "lora_fp16_o1_grad_scaler", "gpu": smi,
          "layers": flayers, "seq": fseq, "steps": fsteps,
          "found_inf": found, "scales": scales,
          "reference_rule_scales": want_scales, "losses": flosses,
          "skipped": sum(found), "skipped_bit_equal": skipped_equal,
          "launches": fp16_launches,
          "launches_per_step": {k: v // fsteps
                                for k, v in fp16_launches.items() if v}})
    check(scales == want_scales,
          f"GradScaler scales {scales} break the reference's rule "
          f"{want_scales}")
    check(any(found) and not all(found),
          f"the fp16 run did not both skip and take steps: {found}")
    del lora, opt, scaler
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lora_done", "wall_s": time.perf_counter() - t_phase})
    return {"lora": launches, "lora_fp16": fp16_launches}


# ---------------------------------------------------------------- phase 19
def _event_ms(torch, fn):
    """(fn's result, CUDA-event ms of the one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _rel_to_max(a, b):
    """max |a - b| over max |b|, in f32."""
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


def _gpt_train(torch, dev, smi):
    """(a) GPT-2 345M training, scripts/bench_suite.py's gpt2_jit recipe:
    B = 16, S = 1,024, selective recompute, the fused lm-head + CE in
    2,048-row chunks over the unshifted ids (the recipe's criterion), bf16
    parameters with f32 masters and bf16 moments. Returns the model, the
    timed steps' launches and the record."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_linear_cross_entropy)
    from paddle_tpu_torch.jit import JittedTrainStep
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import transformer_train_flops

    _, b, seq, _, h, _, d = GPT2_TRAIN_ATTN
    warm, steps = GPT_TRAIN_STEPS
    cfg = GPTConfig.gpt2_345m(
        intermediate_size=4096, use_recompute=True,
        recompute_granularity="selective", fuse_linear_cross_entropy=True,
        lce_chunk_rows=2048, dtype="bfloat16")
    layers, e = cfg.num_hidden_layers, cfg.hidden_size
    check(cfg.num_attention_heads == h and cfg.head_dim == d,
          "phase 2's GPT-2 attention rows do not match the model")
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 19))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def crit(out, labels):
        return fused_linear_cross_entropy(
            out.reshape(-1, e), model.lm_head.weight, labels.reshape(-1),
            chunk_rows=cfg.lce_chunk_rows)

    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True,
                moment_dtype="bfloat16")
    step = JittedTrainStep(model, crit, opt)
    ids = _train_ids(torch, dev, cfg.vocab_size, b, seq)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = b * seq
    flops = transformer_train_flops(n_params, tokens, num_layers=layers,
                                    seq_len=seq, hidden=e, causal=True)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(ids, ids)) for _ in range(warm)]
    ops.reset_launches()
    ms = []
    for _ in range(steps):
        loss, t = _event_ms(torch, lambda: step(ids, ids))
        losses.append(float(loss))
        ms.append(t)
    launches = dict(ops.LAUNCHES)
    # selective recompute wraps the even blocks: their backward runs the
    # block's forward again, K4 included
    remat = sum(1 for i in range(layers) if i % 2 == 0)
    per_step = {"flash_attention": layers + remat,
                "flash_attention_bwd": layers}
    want = {k: per_step.get(k, 0) * steps for k in launches}
    check(launches == want, f"GPT train launches {launches}, expected "
          f"{want}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the GPT loss did not fall: {losses}")
    step_ms = statistics.median(ms)
    rec = {"phase": "gpt2_345m_train_bf16", "gpu": smi, "layers": layers,
           "params": n_params, "batch": b, "seq": seq, "heads": h,
           "head_dim": d, "recompute": "selective",
           "lce_chunk_rows": cfg.lce_chunk_rows, "warmup_steps": warm,
           "timed_steps": steps, "step_ms": step_ms, "step_ms_all": ms,
           "train_tok_per_s": tokens / step_ms * 1e3,
           "model_tflops_per_step": flops / 1e12,
           "mfu_vs_989_tflops": flops / (step_ms / 1e3)
           / PEAK_FLOPS["bfloat16"],
           "losses": losses, "launches": launches,
           "launches_per_step_per_layer": {
               k: v / steps / layers for k, v in launches.items() if v},
           "model_init_s": init_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(rec)
    train_profile(torch, step, ids, ids, label="gpt2_345m_train_step")
    del step, opt
    return model, launches


def _gpt_generate(torch, dev, smi, model):
    """(b) GPT-2 345M greedy generate on (a)'s bf16 model: kernel path
    against plain path (agreement), then a 2-layer f32 model at the same
    width whose kernel and plain streams must be equal."""
    import numpy as np
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM

    rows, prompt, new = GPT_GENERATE_SHAPE
    vocab = model.config.vocab_size
    ids = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, vocab, (rows, prompt))).to(dev)
    model.eval()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    layers = model.config.num_hidden_layers
    want = {k: 0 for k in launches}
    want["flash_attention"] = layers * new
    check(launches == want, f"GPT generate launches {launches}, expected "
          f"{want}")
    with ops.plain_versions():
        plain = model.generate(ids, max_new_tokens=new)
    agree = float((out[:, prompt:] == plain[:, prompt:]).float().mean())
    # the kernel path's logits against the plain path's over the kernel
    # stream's longest forward (phase 2 checks K4 at that shape); where a
    # row's streams part, the plain path's top-2 margin at that step and
    # the two paths' largest logit difference there
    seq = out[:, :-1]
    with torch.no_grad():
        k_logits = model.lm_head(model.gpt(seq)).float()
        with ops.plain_versions():
            p_logits = model.lm_head(model.gpt(seq)).float()
    rel_l2 = float((k_logits - p_logits).norm() / p_logits.norm())
    partings = []
    for r in range(rows):
        diff = (out[r, prompt:] != plain[r, prompt:]).nonzero()
        if diff.numel():
            t = int(diff[0])
            top2 = p_logits[r, prompt + t - 1].topk(2).values
            partings.append({
                "row": r, "step": t,
                "tokens": [int(out[r, prompt + t]), int(plain[r, prompt + t])],
                "plain_top2_margin": float(top2[0] - top2[1]),
                "max_logit_diff_there": float(
                    (k_logits[r, prompt + t - 1]
                     - p_logits[r, prompt + t - 1]).abs().max())})
    del k_logits, p_logits
    cfg = GPTConfig.gpt2_345m(num_hidden_layers=2)
    f32 = GPTForCausalLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 20))
    f_out = f32.generate(ids, max_new_tokens=new)
    with ops.plain_versions():
        f_plain = f32.generate(ids, max_new_tokens=new)
    equal = bool(torch.equal(f_out, f_plain))
    emit({"phase": "gpt2_345m_generate", "gpu": smi, "rows": rows,
          "prompt": prompt, "new_tokens": new, "wall_s": wall,
          "tok_per_s": rows * new / wall, "launches": launches,
          "bf16_kernel_vs_plain_agreement": agree,
          "bf16_logits_rel_l2": rel_l2, "rel_l2_bound": KERNEL_PATH_BOUND,
          "partings": partings,
          "kernel_stream": out[:, prompt:].tolist(),
          "plain_stream": plain[:, prompt:].tolist(),
          "f32_2layer_streams_equal": equal})
    check(out.shape == (rows, prompt + new), f"generate shape {out.shape}")
    check(rel_l2 <= KERNEL_PATH_BOUND, f"GPT bf16 kernel-path logits "
          f"{rel_l2} (relative L2) from the plain path's")
    check(equal, "GPT f32 kernel and plain greedy streams differ")
    del f32


def _fmt_inputs(torch, dev, b, prompt, chunk, steps, e, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randn(b, prompt, e, generator=g, device=dev).to(dtype)]
    if chunk:
        xs.append(torch.randn(b, chunk, e, generator=g, device=dev).to(dtype))
    xs += [torch.randn(b, 1, e, generator=g, device=dev).to(dtype)
           for _ in range(steps)]
    return xs


def _fmt_run(torch, fmt, xs, max_len, cache_dtype, seq_lens=None):
    """Prefill xs[0] (and a chunk where the next input has more than one
    token), then one decode step per one-token input, on fresh caches.
    ``seq_lens(offset)`` gives the decode rows' lengths. Returns (outputs,
    caches, prefill ms, each decode step's ms, the prefill's launches, the
    decode steps' launches), times by CUDA events."""
    from paddle_tpu_torch import ops

    caches = fmt.gen_cache(xs[0].shape[0], max_len, cache_dtype)
    outs, pre_ms, dec_ms, off = [], 0.0, [], 0
    pre_launches = None
    ops.reset_launches()
    for x in xs:
        s = x.shape[1]
        if s == 1 and pre_launches is None:
            pre_launches = dict(ops.LAUNCHES)
            ops.reset_launches()
        kw = {"seq_lens": seq_lens(off)} if s == 1 and seq_lens else {}
        (out, caches), t = _event_ms(
            torch, lambda: fmt(x, caches=caches, time_step=off, **kw))
        if s == 1:
            dec_ms.append(t)
        else:
            pre_ms += t
        outs.append(out)
        off += s
    return outs, caches, pre_ms, dec_ms, pre_launches, dict(ops.LAUNCHES)


def _fmt_step_profile(torch, fmt, xs, max_len, label):
    """Where one decode step of the stack spends device time
    (torch.profiler), after a prefill of xs[0] on fresh caches."""
    from torch.profiler import ProfilerActivity, profile

    caches = fmt.gen_cache(xs[0].shape[0], max_len, "bfloat16")
    _, caches = fmt(xs[0], caches=caches, time_step=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fmt(xs[1], caches=caches, time_step=xs[0].shape[1])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    emit(_profile_record(torch, prof, label, wall_us))


def _fmt_phase(torch, dev, smi):
    """(c) FusedMultiTransformer at Llama-2-7B width in bf16, prefill and
    decode, then the prefill and first decode steps again on the plain
    path; (d) the same after quantize_weight_only; (e) f32 parity at two
    layers with GQA 32 / 8."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer

    b, prompt, max_len, steps = FMT_SHAPE
    e, h, ffn, layers = FMT_WIDTH
    t0 = time.perf_counter()
    fmt = FusedMultiTransformer(
        e, h, ffn, activation="swiglu", norm_type="rmsnorm",
        num_layers=layers, epsilon=1e-6, dtype="bfloat16", device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 21))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    xs = _fmt_inputs(torch, dev, b, prompt, 0, steps, e, torch.bfloat16,
                     SEED + 22)
    with torch.no_grad():
        _fmt_run(torch, fmt, xs[:3], max_len, "bfloat16")   # warm-up
        torch.cuda.reset_peak_memory_stats()
        outs, _, pre_ms, dec_ms, pre_l, dec_l = _fmt_run(
            torch, fmt, xs, max_len, "bfloat16")
    want_pre = {k: 0 for k in pre_l}
    want_pre.update(flash_attention=layers, rms_norm=2 * layers)
    want_dec = {k: 0 for k in dec_l}
    want_dec.update(decode_attention=layers * steps,
                    rms_norm=2 * layers * steps)
    check(pre_l == want_pre, f"FMT prefill launches {pre_l}, expected "
          f"{want_pre}")
    check(dec_l == want_dec, f"FMT decode launches {dec_l}, expected "
          f"{want_dec}")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          "FMT output not finite")
    # the kernel path against the plain path on the same inputs and fresh
    # caches: the prefill and the first decode steps
    n_plain = 1 + FMT_PLAIN_STEPS
    with torch.no_grad(), ops.plain_versions():
        pouts = _fmt_run(torch, fmt, xs[:n_plain], max_len, "bfloat16")[0]
    plain_l2 = [float((o.float() - p.float()).norm() / p.float().norm())
                for o, p in zip(outs[:n_plain], pouts)]
    del pouts
    weight_gb = sum(p.numel() * p.element_size()
                    for p in fmt.parameters()) / 1e9
    step_ms = statistics.median(dec_ms)
    emit({"phase": "fmt_llama2_7b_width_bf16", "gpu": smi, "layers": layers,
          "embed_dim": e, "heads": h, "kv_heads": h, "ffn": ffn,
          "batch": b, "prompt": prompt, "max_length": max_len,
          "decode_steps": steps, "prefill_ms": pre_ms,
          "prefill_tok_per_s": b * prompt / pre_ms * 1e3,
          "decode_ms_per_step": step_ms,
          "decode_ms_mean": statistics.fmean(dec_ms),
          "decode_tok_per_s": b / step_ms * 1e3,
          "weights_gb": weight_gb, "model_init_s": init_s,
          "prefill_launches": pre_l, "decode_launches": dec_l,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "kernel_vs_plain_rel_l2": plain_l2,
          "rel_l2_bound": KERNEL_PATH_BOUND})
    check(max(plain_l2) <= KERNEL_PATH_BOUND, f"FMT bf16 kernel-path "
          f"outputs {plain_l2} (relative L2: prefill, then decode steps) "
          f"from the plain path's")
    with torch.no_grad():
        _fmt_step_profile(torch, fmt, xs, max_len, "fmt_decode_step")

    # (d) weight-only int8 ------------------------------------------------
    with torch.no_grad():
        fmt.quantize_weight_only()
        torch.cuda.empty_cache()
        names = ("qkv_weight", "linear_weight", "ffn1_weight", "ffn2_weight")
        int8_bytes = sum(getattr(fmt, n).numel() for n in names)

        def casts():
            # the casts one call of the stack makes: every layer's four
            # int8 weights to bf16
            return [getattr(fmt, n)[i].to(torch.bfloat16)
                    for i in range(layers) for n in names]
        casts()
        cast_ms = statistics.median(_event_ms(torch, casts)[1]
                                    for _ in range(3))
        _fmt_run(torch, fmt, xs[:3], max_len, "bfloat16")
        torch.cuda.reset_peak_memory_stats()
        qouts, _, qpre_ms, qdec_ms, _, qdec_l = _fmt_run(
            torch, fmt, xs, max_len, "bfloat16")
    check(qdec_l == want_dec, f"int8 FMT decode launches {qdec_l}, "
          f"expected {want_dec}")
    with torch.no_grad():
        _fmt_step_profile(torch, fmt, xs, max_len, "fmt_int8_decode_step")
    dev_q = max(_rel_to_max(q, f) for q, f in zip(qouts, outs))
    l2 = max(float((q.float() - f.float()).norm() / f.float().norm())
             for q, f in zip(qouts, outs))
    q_ms = statistics.median(qdec_ms)
    emit({"phase": "fmt_llama2_7b_width_int8", "gpu": smi,
          "int8_bytes": int8_bytes, "cast_ms_per_call": cast_ms,
          "prefill_ms": qpre_ms, "decode_ms_per_step": q_ms,
          "decode_tok_per_s": b / q_ms * 1e3,
          "decode_over_float": q_ms / step_ms,
          "max_err_rel_to_max_vs_float": dev_q,
          "max_rel_l2_vs_float": l2, "rel_l2_bound": FMT_INT8_BOUND,
          "decode_launches": qdec_l,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    check(l2 <= FMT_INT8_BOUND, f"int8 FMT outputs {l2} (relative L2) from "
          f"the float stack's, over {FMT_INT8_BOUND}")
    del fmt, outs, qouts
    gc.collect()
    torch.cuda.empty_cache()
    _fmt_parity(torch, dev, smi)
    return dec_l


def _fmt_parity(torch, dev, smi):
    """(e) f32, two layers at (c)'s width with GQA 32 / 8: the kernel
    path against the plain path over a prefill, one chunked prefill and
    decode steps with per-row lengths."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer

    prompt, chunk, steps = FMT_PARITY_SHAPE
    b, max_len = 4, 512
    e, h, ffn, _ = FMT_WIDTH
    hk = h // 4                     # GQA 32 / 8 at Llama-2-7B's width
    fmt = FusedMultiTransformer(
        e, h, ffn, activation="swiglu", norm_type="rmsnorm",
        num_layers=2, num_key_value_heads=hk, epsilon=1e-6, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 23))
    xs = _fmt_inputs(torch, dev, b, prompt, chunk, steps, e,
                     torch.float32, SEED + 24)

    def lens(off):
        # row 1 leaves out its last two cached tokens
        return torch.tensor([off + 1, off - 1, off + 1, off + 1],
                            dtype=torch.int32, device=dev)

    with torch.no_grad():
        outs, caches, _, _, pre_l, dec_l = _fmt_run(
            torch, fmt, xs, max_len, "float32", lens)
        with ops.plain_versions():
            pouts, pcaches, _, _, _, _ = _fmt_run(
                torch, fmt, xs, max_len, "float32", lens)
    errs = [close(torch, o, p, torch.float32) for o, p in zip(outs, pouts)]
    cerrs = [close(torch, c, p, torch.float32)
             for c, p in zip(caches, pcaches)]
    emit({"phase": "fmt_parity_f32_2layer", "gpu": smi, "batch": b,
          "prompt": prompt, "chunk": chunk, "decode_steps": steps,
          "kv_heads": hk, "max_abs_err": max(x[0] for x in errs),
          "cache_max_abs_err": max(x[0] for x in cerrs), "tol": errs[0][2],
          "prefill_launches": pre_l, "decode_launches": dec_l})
    check(all(x[1] for x in errs + cerrs),
          "FMT f32 kernel and plain paths disagree")
    check(pre_l["flash_attention_f32"] == 4 and
          dec_l["decode_attention"] == 2 * steps,
          f"FMT f32 launches {pre_l} {dec_l}")
    del fmt


def _moe_phase(torch, dev, smi):
    """(f) MoELayer at Mixtral-8x7B's layer width in bf16: GShard top-2,
    swiglu, forward and backward in both dispatch modes, which must
    agree; at the layer's capacity factor, then at one that drops
    assignments (the overflow path)."""
    import numpy as np
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.incubate.distributed.models.moe.gate import (
        _capacity)

    t = MOE_TOKENS
    m, hid, experts = MOE_WIDTH
    moe = MoELayer(m, hid, experts, gate="gshard", activation="swiglu",
                   dtype=torch.bfloat16, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(
                       SEED + 25))
    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    x = torch.randn(t, m, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(t, m, generator=g, device=dev).to(torch.bfloat16)
    for factor in (moe.gate.capacity_factor, MOE_OVERFLOW_FACTOR):
        moe.gate.capacity_factor = factor
        res = {}
        for mode in ("einsum", "grouped"):
            moe.dispatch_mode = mode
            xg = x.clone().requires_grad_()
            moe.zero_grad(set_to_none=True)

            def fwd():
                return moe(xg)
            with torch.no_grad():
                fwd()
                _, fwd_ms = _event_ms(torch, fwd)

            def fwd_bwd():
                y = moe(xg)
                torch.autograd.backward((y, moe.l_aux), (dy, torch.ones_like(
                    moe.l_aux)))
                return y
            fwd_bwd()
            moe.zero_grad(set_to_none=True)
            xg.grad = None
            torch.cuda.reset_peak_memory_stats()
            y, fb_ms = _event_ms(torch, fwd_bwd)
            res[mode] = dict(
                y=y.detach(), dx=xg.grad, aux=float(moe.l_aux.detach()),
                grads={n: p.grad.clone() for n, p in moe.named_parameters()},
                fwd_ms=fwd_ms, fwd_bwd_ms=fb_ms,
                peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
        with torch.no_grad():
            logits = x.float() @ moe.gate_weight.float()
            _, gate_vals, _ = moe.gate.topk_assignments(logits)
        dropped = int((gate_vals == 0).sum())
        ein, grp = res["einsum"], res["grouped"]
        err = {"y": _rel_to_max(grp["y"], ein["y"]),
               "dx": _rel_to_max(grp["dx"], ein["dx"]),
               **{f"d{n}": _rel_to_max(grp["grads"][n], ein["grads"][n])
                  for n in ein["grads"]}}
        emit({"phase": "moe_mixtral_width_bf16", "gpu": smi, "tokens": t,
              "d_model": m, "d_hidden": hid, "experts": experts,
              "top_k": moe.gate.top_k, "capacity_factor": factor,
              "capacity": _capacity(t, experts, factor, moe.gate.top_k),
              "dropped_assignments": dropped,
              "assignments": moe.gate.top_k * t,
              "expert_weight_gb": (moe.w1.numel() + moe.w2.numel()) * 2 / 1e9,
              **{f"{k}_{q}": res[k][q] for k in res
                 for q in ("fwd_ms", "fwd_bwd_ms", "peak_gb")},
              "l_aux": [ein["aux"], grp["aux"]],
              "grouped_vs_einsum_rel_to_max": err,
              "bound_rel_to_max": MOE_AGREE_BOUND})
        check(all(np.isfinite(v) for v in err.values()),
              f"MoE not finite {err}")
        check(max(err.values()) <= MOE_AGREE_BOUND,
              f"MoE grouped and einsum modes disagree: {err}")
        check(abs(ein["aux"] - grp["aux"]) <= 1e-6 * max(1.0, abs(ein["aux"])),
              f"MoE l_aux differs between modes: {ein['aux']} {grp['aux']}")
        check(factor != MOE_OVERFLOW_FACTOR or dropped > 0,
              f"MoE at capacity factor {factor} dropped nothing")
        del res, ein, grp
    del moe


def gpt_phase(torch, dev, smi):
    """Phase 19: the GPT-2 family and the incubate fused tier. (a) GPT-2
    345M training, (b) its greedy generate, (c) FusedMultiTransformer at
    Llama-2-7B width, (d) the same in weight-only int8, (e) its f32
    kernel-vs-plain parity, (f) MoELayer at Mixtral's layer width.
    Returns the ``gpt_train`` and ``fmt_decode`` launch counts."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model, train_launches = _gpt_train(torch, dev, smi)
    _gpt_generate(torch, dev, smi, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    fmt_launches = _fmt_phase(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    _moe_phase(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "gpt_done", "wall_s": time.perf_counter() - t_phase})
    return {"gpt_train": train_launches, "fmt_decode": fmt_launches}


# ---------------------------------------------------------------- phase 20
def _rel_l2(a, b):
    """||a - b|| / ||b|| in f32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def _vision_family(name):
    """A kernel's family by name: cuDNN's convolution kernels (forward,
    dgrad, wgrad), K4, matrix products, the rest."""
    low = name.lower()
    if "flash_fwd_" in name:
        return "K4 flash_attention"
    if any(k in low for k in ("conv", "dgrad", "wgrad", "fprop", "cudnn",
                              "implicit", "winograd", "xmma")):
        return "convolution"
    return _kernel_family(name)


def _vision_profile(torch, fn, label, ranges, family=None):
    """Device time of one call of ``fn`` by family: a kernel that runs
    inside a device-side span of one of the record_function ``ranges``
    (a dict, range name -> family: the forward's convolutions and norm
    passes) counts for that family, the rest by :func:`_vision_family`
    (the backward's BatchNorm passes fall under "other"; ``family``
    replaces that rule for a model without convolutions). Device busy
    share = summed kernel time over the call's wall under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    events = [ev for ev in prof.events() if ev.device_type == cuda]
    spans = {r: [(ev.time_range.start, ev.time_range.end) for ev in events
                 if ev.name == r] for r in ranges}
    fams, n = {}, 0
    for ev in events:
        if ev.name in ranges:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        if b <= a:
            continue
        fam = next((ranges[r] for r, sp in spans.items()
                    if any(x <= a and b <= y for x, y in sp)),
                   None) or (family or _vision_family)(ev.name)
        fams[fam] = fams.get(fam, 0.0) + (b - a)
        n += 1
    busy = sum(fams.values())
    return {"phase": "profile", "step": label,
            "wall_ms_under_profiler": wall_us / 1e3,
            "device_ms": busy / 1e3 if busy else "not measured",
            "device_busy_share": busy / wall_us if busy else "not measured",
            "kernels_launched": n,
            "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
                fams.items(), key=lambda kv: -kv[1])}}


@contextlib.contextmanager
def _traced_functionals(torch, names):
    """The port's functionals ``names`` under record_function ranges of
    their own names (the layers look them up on the module at call
    time)."""
    from torch.profiler import record_function
    from paddle_tpu_torch.nn import functional as F

    saved = {n: getattr(F, n) for n in names}

    def traced(n, fn):
        def call(*a, **kw):
            with record_function(n):
                return fn(*a, **kw)
        return call

    for n, fn in saved.items():
        setattr(F, n, traced(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(F, n, fn)


def _sd_inputs(torch, dev, cfg, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    side = cfg["sample_size"]
    lat = torch.randn(SD_BATCH, 4, side, side, generator=g, device=dev)
    ctx = torch.randn(SD_BATCH, SD_CONTEXT, cfg["cross_attention_dim"],
                      generator=g, device=dev)
    return lat.to(dtype), ctx.to(dtype)


def _sd_unet(torch, dev, smi):
    """(a) the SD UNet at stable-diffusion-2-base's widths in bf16, batch
    2, 77 x 1,024 context, 20 DDIM steps through the captured sampler.
    Returns the launches of one captured sample."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.vision.models import (SDUNetConfig,
                                                UNet2DConditionModel,
                                                ddim_sample, sd_unet)

    cfg = SDUNetConfig(**SD_UNET_WIDTH)
    t0 = time.perf_counter()
    unet = UNet2DConditionModel(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 20)).eval()
    n_params = sum(p.numel() for p in unet.parameters())
    f32_state = {k: v.clone() for k, v in unet.state_dict().items()}
    unet.to(torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    heads = {c // 64 for c in cfg.block_out_channels}
    check({h for *_, h, _ in (UNET_SELF_ATTN, UNET_CROSS_ATTN,
                              UNET_LOW_ATTN)} <= heads,
          "phase 2's UNet attention rows do not match the model")
    lat, ctx = _sd_inputs(torch, dev, SD_UNET_WIDTH, torch.bfloat16,
                          SEED + 21)
    torch.cuda.reset_peak_memory_stats()

    def sample():
        return ddim_sample(unet, lat, ctx, num_inference_steps=SD_STEPS)

    # the first call warms up on the capture stream (its answer) and
    # captures; later calls replay
    ops.reset_launches()
    first, first_ms = _event_ms(torch, sample)
    check(len(unet._ddim_loops) == 1, "the sampler was not cached")
    loop = next(iter(unet._ddim_loops.values()))
    check(loop.graph is not None and loop.graph.graph is not None,
          "the DDIM loop was not captured")
    ops.reset_launches()
    captured, _ = _event_ms(torch, sample)
    launches = dict(ops.LAUNCHES)
    blocks = 2 * len(cfg.block_out_channels) * cfg.layers_per_block \
        + len(cfg.block_out_channels) + 1
    want = {k: 0 for k in launches}
    want["flash_attention"] = 2 * blocks * SD_STEPS
    check(launches == want, f"SD sample launches {launches}, expected "
          f"{want}")
    ms = [_event_ms(torch, sample)[1] for _ in range(SD_TIMED)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    graph_prof = _vision_profile(torch, sample, "sd_unet_sample_replay",
                                 {})
    step_prof = _sd_step_profile(torch, unet, lat, ctx)
    # the eager oracle, then the plain path (eager), then f32 (plain)
    sd_unet._EAGER = True
    try:
        eager, eager_ms = _event_ms(torch, sample)
        eager_ms2 = _event_ms(torch, sample)[1]
        with ops.plain_versions():
            plain = sample()
        unet.to(torch.float32).load_state_dict(f32_state)
        del f32_state
        with ops.plain_versions():
            f32 = ddim_sample(unet, lat.float(), ctx.float(),
                              num_inference_steps=SD_STEPS)
    finally:
        sd_unet._EAGER = False
    check(torch.equal(captured, eager) and torch.equal(first, eager),
          "the captured sampler's latents differ from the eager sampler's")
    check(bool(torch.isfinite(captured).all())
          and captured.shape == lat.shape, "SD latents not finite")
    kernel_gap = _rel_l2(captured, plain)
    precision_gap = _rel_l2(plain, f32)
    unet._ddim_loops.clear()
    k4 = step_prof["device_ms_by_family"].get("K4 flash_attention", 0.0)
    sample_ms = statistics.median(ms)
    rec = {"phase": "sd_unet_sd2base_bf16", "gpu": smi,
           "config": SD_UNET_WIDTH, "params": n_params, "batch": SD_BATCH,
           "context": [SD_CONTEXT, SD_UNET_WIDTH["cross_attention_dim"]],
           "steps": SD_STEPS, "model_init_s": init_s,
           "first_call_ms_warmup_and_capture": first_ms,
           "sample_ms": sample_ms, "sample_ms_all": ms,
           "unet_step_ms": sample_ms / SD_STEPS,
           "eager_sample_ms": [eager_ms, eager_ms2],
           "eager_unet_step_ms": eager_ms2 / SD_STEPS,
           "launches_per_sample": launches,
           "k4_launches_per_step": launches["flash_attention"] / SD_STEPS,
           "captured_equals_eager": True,
           "kernel_vs_plain_rel_l2": kernel_gap,
           "bf16_vs_f32_rel_l2": precision_gap,
           "bound": "kernel_vs_plain_rel_l2 <= bf16_vs_f32_rel_l2",
           "step_device_ms": step_prof["device_ms"],
           "step_device_busy_share": step_prof["device_busy_share"],
           "k4_share_of_step_device_ms": (
               k4 / step_prof["device_ms"]
               if isinstance(step_prof["device_ms"], float) else
               "not measured"),
           "replay_device_busy_share": graph_prof["device_busy_share"],
           "replay_device_ms_per_step": (
               graph_prof["device_ms"] / SD_STEPS
               if isinstance(graph_prof["device_ms"], float) else
               "not measured"),
           "peak_mem_gb": peak}
    emit(rec)
    emit({**graph_prof, "gpu": smi})
    check(kernel_gap <= precision_gap,
          f"the kernel path parts from the plain path by more than bf16 "
          f"from f32: {kernel_gap} > {precision_gap}")
    del unet, first, captured, eager, plain, f32
    return launches


def _sd_step_profile(torch, unet, lat, ctx):
    """One eager UNet step (the kernel path) by family: convolutions,
    GroupNorm and LayerNorm passes (their functionals' ranges), K4,
    matrix products, the rest."""
    t = torch.full((lat.shape[0],), 999, dtype=torch.int32,
                   device=lat.device)
    ranges = {"conv2d": "convolution", "group_norm": "group_norm",
              "layer_norm": "layer_norm"}
    with torch.no_grad():
        unet(lat, t, ctx)
        with _traced_functionals(torch, ranges):
            rec = _vision_profile(torch, lambda: unet(lat, t, ctx),
                                  "sd_unet_step_eager", ranges)
    emit(rec)
    return rec


def _sd_f32_parity(torch, dev, smi):
    """(a) in f32 at layers_per_block=1: the kernel path (K4's f32 arm)
    against the plain path over SD_F32_STEPS DDIM steps, both eager."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.vision.models import (SDUNetConfig,
                                                UNet2DConditionModel,
                                                ddim_sample, sd_unet)

    width = dict(SD_UNET_WIDTH, layers_per_block=1)
    unet = UNet2DConditionModel(SDUNetConfig(**width), device=dev,
                                generator=torch.Generator(
                                    device=dev).manual_seed(SEED + 22))
    lat, ctx = _sd_inputs(torch, dev, width, torch.float32, SEED + 23)
    sd_unet._EAGER = True
    try:
        ops.reset_launches()
        got = ddim_sample(unet, lat, ctx, num_inference_steps=SD_F32_STEPS)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        with ops.plain_versions():
            want = ddim_sample(unet, lat, ctx,
                               num_inference_steps=SD_F32_STEPS)
    finally:
        sd_unet._EAGER = False
    err = _rel_to_max(got, want)
    emit({"phase": "sd_unet_parity_f32_1layer", "gpu": smi,
          "steps": SD_F32_STEPS, "max_err_over_max": err,
          "bound": SD_F32_BOUND, "launches": launches})
    check(launches.get("flash_attention_f32", 0) > 0,
          f"the f32 UNet did not reach K4's f32 arm: {launches}")
    check(err <= SD_F32_BOUND, f"SD f32 kernel and plain paths part: "
          f"{err}")
    del unet


def _resnet50(torch, dev, smi):
    """(b) ResNet-50 at scripts/bench_suite.py's resnet50_eager recipe:
    f32, batch 32, 3 x 224 x 224, CrossEntropyLoss, Momentum(0.1), eager
    steps on one batch with the convolutions in full f32 (cuDNN's TF32
    off, as this script sets it), one more under the profiler, then steps
    with TF32 on (torch's own default for convolutions), then an eval
    forward in bf16. The loss is held at the run's end
    (``RESNET_STEPS``)."""
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    b, side, classes = RESNET_SHAPE
    timed, more, tf32_steps = RESNET_STEPS
    model = resnet50(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 25))
    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    x = torch.randn(b, 3, side, side, generator=g, device=dev)
    y = torch.randint(0, classes, (b,), generator=g, device=dev)
    ce = CrossEntropyLoss()
    opt = Momentum(RESNET_LR, parameters=model.parameters())

    def step():
        loss = ce(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss)

    def steps(n):
        losses, walls = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            losses.append(step())
            walls.append(1e3 * (time.perf_counter() - t0))
        return losses, walls

    # bn1's input and running statistics around the first step
    seen = {}
    hook = model.bn1.register_forward_pre_hook(
        lambda m, a: seen.setdefault("x", a[0].detach().float()))
    before = (model.bn1._mean.clone(), model.bn1._variance.clone())
    torch.cuda.reset_peak_memory_stats()
    losses, walls = steps(1)
    hook.remove()
    after = (model.bn1._mean.clone(), model.bn1._variance.clone())
    xs = seen.pop("x")
    n = xs.numel() // xs.shape[1]
    var = xs.var(dim=(0, 2, 3), unbiased=False) * n / (n - 1)
    stats_err = max(
        _rel_to_max(after[0], 0.9 * before[0] + 0.1 * xs.mean(dim=(0, 2, 3))),
        _rel_to_max(after[1], 0.9 * before[1] + 0.1 * var))
    del xs
    more_losses, more_walls = steps(timed - 1 + more)
    losses += more_losses
    walls += more_walls
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ranges = {"conv2d": "convolution", "batch_norm": "batch_norm"}
    with _traced_functionals(torch, ranges):
        prof = _vision_profile(torch, step, "resnet50_train_step_f32",
                               ranges)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_losses, tf32_walls = steps(tf32_steps)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    model.to(torch.bfloat16).eval()
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        logits = model(xb)
        fwd_ms = [_event_ms(torch, lambda: model(xb))[1] for _ in range(5)]
    # the first step pays cuDNN's and the allocator's warm-up
    step_ms = statistics.median(walls[1:timed])
    tf32_ms = statistics.median(tf32_walls[1:])
    rec = {"phase": "resnet50_train_f32", "gpu": smi, "batch": b,
           "image": [3, side, side], "lr": RESNET_LR,
           "conv_precision": "float32 (cudnn.allow_tf32 False)",
           "losses_f32": losses, "losses_tf32": tf32_losses,
           "step_ms_f32": walls[:timed],
           "images_per_s_f32": b / step_ms * 1e3,
           "step_ms_tf32": tf32_walls,
           "images_per_s_tf32": b / tf32_ms * 1e3,
           "bn1_running_stats_err_over_max": stats_err,
           "peak_mem_gb": peak,
           "eval_bf16_forward_ms": fwd_ms,
           "eval_bf16_images_per_s": b / statistics.median(fwd_ms) * 1e3,
           "step_device_ms": prof["device_ms"],
           "step_device_busy_share": prof["device_busy_share"]}
    emit(rec)
    RESNET_RECORD.update(images_per_s_f32=rec["images_per_s_f32"])
    emit({**prof, "gpu": smi})
    every = losses + tf32_losses
    check(all(math.isfinite(v) for v in every), f"non-finite loss {every}")
    check(all(v < losses[0] for v in tf32_losses),
          f"the ResNet-50 loss did not fall: {every}")
    check(stats_err <= 1e-5, f"bn1's running statistics did not move by "
          f"paddle's rule: {stats_err}")
    check(logits.shape == (b, classes)
          and bool(torch.isfinite(logits).all()), "bf16 eval logits")
    del model, opt


def vision_phase(torch, dev, smi):
    """Phase 20: the vision tier. (a) the SD UNet's captured DDIM sampler
    at stable-diffusion-2-base's widths, with its f32 parity run, (b)
    ResNet-50 training at resnet50_eager's recipe. Returns the
    ``sd_unet`` launch counts (one captured sample)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    launches = _sd_unet(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    _sd_f32_parity(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    _resnet50(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "vision_done", "wall_s": time.perf_counter() - t_phase})
    return {"sd_unet": launches}


# ---------------------------------------------------------------- phase 21
def _recorded_steps(torch, step):
    """Wrap the train step's ``_one_step`` so each step leaves its loss
    and a pair of CUDA events; returns the list they land in."""
    rec = []
    one = step._one_step

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = one(*a, **kw)
        end.record()
        rec.append((loss, start, end))
        return loss

    step._one_step = timed
    return rec


def _epoch(torch, eng, data, batch):
    """One ``Engine.fit`` epoch; (losses, step ms by CUDA events, wall
    s)."""
    step = eng._ensure_train_step()
    rec = _recorded_steps(torch, step)
    t0 = time.perf_counter()
    eng.fit(data, batch_size=batch, epochs=1, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del step._one_step
    return ([float(x[0]) for x in rec],
            [x[1].elapsed_time(x[2]) for x in rec], wall)


def _ernie_family(name):
    """A kernel's family in a model without convolutions: cuBLAS's f32
    products are named ``..._xmma_gemm_...`` on Hopper, which the vision
    rule would count as convolutions."""
    low = name.lower()
    if "gemm" in low or "nvjet" in low or "cutlass" in low:
        return "matmul"
    return _kernel_family(name)


def _ernie_step_profile(torch, eng, data, batch):
    """Where one ERNIE train step's device time goes: the forward's
    LayerNorms, plain attention and MLM cross entropy inside
    record_function ranges of their functionals, the AdamW update in its
    own, the rest by kernel name."""
    from torch.profiler import record_function

    step = eng._ensure_train_step()
    ins, lbs = eng._split_batch(next(iter(eng._loader(data, batch, False))))
    opt = step._optimizer
    apply = opt.apply

    def traced_apply(*a, **kw):
        with record_function("adamw_update"):
            return apply(*a, **kw)

    opt.apply = traced_apply
    ranges = {"layer_norm": "LayerNorm", "cross_entropy":
              "MLM log-softmax + NLL", "scaled_dot_product_attention":
              "attention (plain f32)", "adamw_update": "AdamW update"}
    try:
        with _traced_functionals(torch, [k for k in ranges
                                         if k != "adamw_update"]):
            prof = _vision_profile(torch, lambda: step(ins, lbs),
                                   "ernie_engine_train_step_f32", ranges,
                                   family=_ernie_family)
    finally:
        del opt.apply
    step.sync_to_model()
    return prof


def _ernie(torch, dev, smi):
    """(a) BASELINE config #4: ERNIE-3.0 base (``ErnieConfig()``: 12
    layers, hidden 768, 12 heads, FFN 3,072, vocab 40,000) pretraining
    through ``Engine.fit``, ernie_engine's recipe at B = 16, S = 512: f32,
    dropout 0, AdamW(1e-4), a cold and a warm epoch of 8 batches with TF32
    off, one more with TF32 on; evaluate and predict on the card, save ->
    a new Engine's load evaluates equal; the first step's loss against
    the CPU's on the same weights at B = 1, S = 128. Returns the timed
    epochs' launches (ERNIE's attention runs under its additive mask:
    the plain path, no K4 / K7, as the reference's XLA path)."""
    import tempfile

    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    from paddle_tpu_torch.nlp import (BertPretrainingCriterion, ErnieConfig,
                                      ErnieForPretraining)
    from paddle_tpu_torch.optimizer import AdamW

    import numpy as np
    from paddle_tpu_torch.io import Dataset

    class ErnieData(Dataset):
        """ernie_engine's dataset: ids from RandomState(seed) in [1,
        vocab), labels on every 7th token, -100 elsewhere."""

        def __init__(self, n, seq, seed):
            rng = np.random.RandomState(seed)
            self.ids = rng.randint(1, cfg.vocab_size, (n, seq)).astype("i8")
            self.labels = np.full((n, seq), -100, "i8")
            self.labels[:, ::7] = self.ids[:, ::7]

        def __len__(self):
            return len(self.ids)

        def __getitem__(self, i):
            return self.ids[i], self.labels[i]

    b, seq, batches, cpu_seq = ERNIE_SHAPE
    cfg = ErnieConfig(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    check(cfg.hidden_size // cfg.num_attention_heads == 64
          and cfg.max_position_embeddings >= seq, "ERNIE widths")
    t0 = time.perf_counter()
    model = ErnieForPretraining(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 31))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    crit = BertPretrainingCriterion()

    def loss_fn(out, labels):
        return crit(out[0], out[1], labels)

    def engine(m):
        return Engine(m, loss_fn, AdamW(1e-4, parameters=m.parameters()),
                      device=dev)

    # the first step's loss against the CPU's on the same weights
    probe = ErnieData(1, cpu_seq, SEED + 32)
    pids, plabels = (torch.from_numpy(a) for a in (probe.ids, probe.labels))
    with torch.no_grad():
        gpu_loss = float(loss_fn(model(pids.to(dev)), plabels.to(dev)))
    cpu_model = ErnieForPretraining(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    with torch.no_grad():
        cpu_loss = float(loss_fn(cpu_model(pids), plabels))
    del cpu_model
    cpu_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    eng = engine(model)
    data = ErnieData(b * batches, seq, SEED)
    torch.cuda.reset_peak_memory_stats()
    cold, cold_ms, cold_wall = _epoch(torch, eng, data, b)
    ops.reset_launches()
    warm, warm_ms, warm_wall = _epoch(torch, eng, data, b)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = _ernie_step_profile(torch, eng, data, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, tf32_ms, tf32_wall = _epoch(torch, eng, data, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tokens = b * seq
    step_ms = statistics.median(warm_ms)
    tf32_step_ms = statistics.median(tf32_ms)
    n_params = sum(p.numel() for p in model.parameters())
    # evaluate and predict on the card; save -> a new engine loads equal
    held = ErnieData(2 * b + 3, seq, SEED + 33)
    t0 = time.perf_counter()
    ev = eng.evaluate(held, batch_size=b, verbose=0)
    eval_s = time.perf_counter() - t0
    preds = eng.predict(held, batch_size=b)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ernie")
        eng.save(path)
        other = ErnieForPretraining(cfg, device=dev,
                                    generator=torch.Generator(
                                        device=dev).manual_seed(SEED + 34))
        eng2 = engine(other)
        eng2.load(path)
        ev2 = eng2.evaluate(held, batch_size=b, verbose=0)
    tied = other.cls.decoder_weight is \
        other.bert.embeddings.word_embeddings.weight
    del other, eng2
    rec = {"phase": "ernie_engine_train_f32", "gpu": smi,
           "config": "ErnieConfig() (ERNIE-3.0 base), dropout 0",
           "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
           "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size,
           "params": n_params, "batch": b, "seq": seq,
           "steps_an_epoch": batches, "model_init_s": init_s,
           "losses_cold": cold, "losses_warm": warm, "losses_tf32": tf32,
           "step_ms_cold": cold_ms, "step_ms_warm": warm_ms,
           "step_ms_tf32": tf32_ms, "epoch_wall_s": {
               "cold": cold_wall, "warm": warm_wall, "tf32": tf32_wall},
           "step_ms": step_ms, "train_tok_per_s": tokens / step_ms * 1e3,
           "step_ms_tf32_median": tf32_step_ms,
           "train_tok_per_s_tf32": tokens / tf32_step_ms * 1e3,
           "warm_epoch_tok_per_s_wall": tokens * batches / warm_wall,
           "step_device_ms": prof["device_ms"],
           "step_device_busy_share": prof["device_busy_share"],
           "step_kernels_launched": prof["kernels_launched"],
           "launches_warm_epoch": {k: v for k, v in launches.items() if v},
           "peak_mem_gb": peak,
           "eval_loss": ev["loss"], "eval_loss_after_load": ev2["loss"],
           "eval_s": eval_s, "predict_batches": [
               int(p[0].shape[0]) for p in preds],
           "first_step_loss_b1_s128": {"cuda": gpu_loss, "cpu": cpu_loss,
                                       "rel_err": cpu_err,
                                       "bound": ERNIE_CPU_BOUND}}
    emit(rec)
    emit({**prof, "gpu": smi})
    every = cold + warm + tf32
    check(all(math.isfinite(v) for v in every), f"non-finite loss {every}")
    check(len(cold) == len(warm) == batches, f"steps an epoch {rec}")
    check(warm[-1] < cold[0], f"the ERNIE loss did not fall: {every}")
    check(not any(launches.values()), f"ERNIE's masked attention reached a "
          f"kernel: {launches}")
    check(cpu_err <= ERNIE_CPU_BOUND, f"ERNIE's first loss on the card is "
          f"{gpu_loss}, on the CPU {cpu_loss}")
    check(math.isfinite(ev["loss"]) and tied
          and abs(ev2["loss"] - ev["loss"]) <= 1e-6 * abs(ev["loss"]),
          f"Engine.save -> load evaluates {ev2['loss']} against "
          f"{ev['loss']} (tied {tied})")
    check([p[0].shape[0] for p in preds] == [b, b, 3]
          and all(p[0].device.type == "cuda"
                  and bool(torch.isfinite(p[0]).all()) for p in preds),
          "Engine.predict on the card")
    del eng, model, preds
    return launches


def _transformer(torch, dev, smi):
    """(b) ``nn.Transformer`` at its defaults (dropout 0), bf16, B = 16,
    source = target = 512, the causal target mask from
    ``generate_square_subsequent_mask``: one train step through the
    kernels (exactly 12 K4 and 12 K7: the encoder's self-attention and
    the decoder's cross-attention; the masked self-attention is plain),
    one with ``plain_versions``: the loss and the whole gradient within
    ``KERNEL_PATH_BOUND`` of the plain path's, and each parameter's
    gradient within that bound or within the gap between the plain
    path's bf16 gradient and its f32 one, where that is larger (the
    kernel path may part from the plain path by no more than bf16
    itself parts from f32); then 32 cached decode steps (``Cache``, no
    mask: 12 K4 a step at Sq = 1) against the plain path. Returns the
    train step's and the decode's launches."""
    from paddle_tpu_torch import nn, ops

    b, s, steps = TRANSFORMER_SHAPE
    _, _, _, _, h, d = TRANSFORMER_ATTN
    torch.manual_seed(SEED + 35)
    model = nn.Transformer(dropout=0.0, device=dev, dtype=torch.bfloat16)
    check(model.d_model // model.nhead == d and model.nhead == h,
          "phase 2's Transformer rows do not match the model")
    layers = len(model.encoder.layers)
    g = torch.Generator(device=dev).manual_seed(SEED + 36)
    src, tgt, w = (torch.randn(b, s, model.d_model, generator=g,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
    mask = nn.Transformer.generate_square_subsequent_mask(s, device=dev)

    def train_step(m=model, dtype=torch.bfloat16):
        for p in m.parameters():
            p.grad = None
        out = m(src.to(dtype), tgt.to(dtype), tgt_mask=mask)
        loss = (out.float() * w.float()).mean()
        loss.backward()
        return loss.detach(), {n: p.grad.detach().float()
                               for n, p in m.named_parameters()}

    def errs(got, want):
        """Each gradient's relative L2 error, over its own norm or over
        the norm it would have at the whole gradient's RMS where that is
        larger (a bias or norm gradient is a sum over 8,192 rows that
        mostly cancels: its own norm can sit below the rounding its terms
        carry), and the whole gradient's."""
        cat = torch.cat([g.flatten() for g in want.values()])
        rms = float(cat.norm()) / cat.numel() ** 0.5
        per = {n: float((got[n] - want[n]).norm())
               / max(float(want[n].norm()), rms * want[n].numel() ** 0.5)
               for n in want}
        whole = _rel_l2(torch.cat([g.flatten() for g in got.values()]), cat)
        return per, whole

    train_step()  # warm-up
    ops.reset_launches()
    (loss, grads), ms = _event_ms(torch, train_step)
    train_launches = dict(ops.LAUNCHES)
    with ops.plain_versions():
        (plain_loss, plain_grads), plain_ms = _event_ms(torch, train_step)
        # the same step in f32 on the plain path: how far bf16 itself
        # moves each gradient
        f32 = copy.deepcopy(model).float()
        f32_loss, f32_grads = train_step(f32, torch.float32)
        del f32
    loss_err = abs(float(loss) - float(plain_loss)) / max(
        abs(float(plain_loss)), 1e-30)
    grad_errs, all_err = errs(grads, plain_grads)
    gaps, all_gap = errs(plain_grads, f32_grads)
    over = {n: (e, gaps[n]) for n, e in grad_errs.items()
            if e > max(KERNEL_PATH_BOUND, gaps[n])}
    del grads, plain_grads, f32_grads
    # the cached decoder: Cache (self) + StaticCache (cross), no mask
    with torch.no_grad():
        memory = model.encoder(src)

        def decode(n):
            cache = model.decoder.gen_cache(memory)
            outs = []
            for i in range(n):
                out, cache = model.decoder(tgt[:, i:i + 1], memory,
                                           cache=cache)
                outs.append(out)
            return torch.cat(outs, dim=1)

        decode(2)  # warm-up
        ops.reset_launches()
        dec, dec_ms = _event_ms(torch, lambda: decode(steps))
        decode_launches = dict(ops.LAUNCHES)
        with ops.plain_versions():
            plain_dec, plain_dec_ms = _event_ms(torch, lambda: decode(steps))
    dec_err = _rel_l2(dec, plain_dec)
    rec = {"phase": "transformer_bf16", "gpu": smi,
           "d_model": model.d_model, "heads": h, "head_dim": d,
           "layers": [layers, len(model.decoder.layers)], "batch": b,
           "seq": s, "train_step_ms": ms, "plain_train_step_ms": plain_ms,
           "loss": float(loss), "plain_loss": float(plain_loss),
           "loss_rel_err": loss_err, "grads_rel_l2_all": all_err,
           "grads_rel_l2_max": max(grad_errs.values()),
           "grads_rel_l2_worst": dict(sorted(
               grad_errs.items(), key=lambda kv: -kv[1])[:3]),
           "f32_loss": float(f32_loss),
           "bf16_vs_f32_grads_rel_l2_all": all_gap,
           "bf16_vs_f32_worst": dict(sorted(
               gaps.items(), key=lambda kv: -kv[1])[:3]),
           "grads_over_bound_and_gap": over,
           "train_launches": {k: v for k, v in train_launches.items() if v},
           "decode_steps": steps, "decode_ms": dec_ms,
           "decode_ms_a_step": dec_ms / steps,
           "plain_decode_ms": plain_dec_ms, "decode_rel_l2": dec_err,
           "decode_launches": {k: v for k, v in decode_launches.items()
                               if v},
           "bound": KERNEL_PATH_BOUND}
    emit(rec)
    want = {k: 0 for k in train_launches}
    want.update(flash_attention=2 * layers, flash_attention_bwd=2 * layers)
    check(train_launches == want, f"Transformer step launches "
          f"{train_launches}, expected {want}")
    want = {k: 0 for k in decode_launches}
    want.update(flash_attention=2 * layers * steps)
    check(decode_launches == want, f"cached decode launches "
          f"{decode_launches}, expected {want}")
    check(math.isfinite(float(loss)) and loss_err <= KERNEL_PATH_BOUND
          and all_err <= KERNEL_PATH_BOUND and not over,
          f"the Transformer kernel path parts from the plain path: {rec}")
    check(dec_err <= KERNEL_PATH_BOUND and bool(torch.isfinite(dec).all()),
          f"the cached decode parts from the plain path: {dec_err}")
    del model
    return train_launches, decode_launches


def _hapi_lenet(torch, dev, smi):
    """(c) ``hapi.Model`` with LeNet (tests/test_vision_hapi.py's recipe)
    on synthetic 28 x 28 images, 4 classes, each image its class's fixed
    pattern plus noise: ``prepare`` with ``Accuracy``, ``evaluate``,
    ``fit``, ``evaluate`` (accuracy rises), ``save`` -> zeroed weights ->
    ``load`` evaluates equal."""
    import tempfile

    import numpy as np
    from paddle_tpu_torch import Model, metric
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet

    n, batch, epochs = LENET_SHAPE
    rng = np.random.RandomState(SEED + 37)
    patterns = rng.standard_normal((4, 1, 28, 28)).astype(np.float32)
    labels = rng.randint(0, 4, (n, 1)).astype(np.int64)
    images = (patterns[labels[:, 0]] + 2.0 * rng.standard_normal(
        (n, 1, 28, 28))).astype(np.float32)
    data = TensorDataset([images, labels])
    net = LeNet(num_classes=4, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 38))
    model = Model(net, device=dev)
    model.prepare(Adam(1e-3, parameters=net.parameters()),
                  CrossEntropyLoss(), metric.Accuracy())
    before = model.evaluate(data, batch_size=batch, verbose=0)
    t0 = time.perf_counter()
    model.fit(data, epochs=epochs, batch_size=batch, verbose=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    after = model.evaluate(data, batch_size=batch, verbose=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lenet")
        model.save(path)
        with torch.no_grad():
            for p in net.parameters():
                p.zero_()
        model.load(path)
    again = model.evaluate(data, batch_size=batch, verbose=0)
    before, after, again = ({k: float(v) for k, v in r.items()}
                            for r in (before, after, again))
    rec = {"phase": "hapi_lenet", "gpu": smi, "samples": n, "batch": batch,
           "epochs": epochs, "before": before, "after": after,
           "after_load": again, "fit_s": fit_s}
    emit(rec)
    check(after["acc"] > before["acc"] and after["loss"] < before["loss"],
          f"hapi.Model's LeNet did not learn: {rec}")
    check(again == after, f"hapi save -> load: {again} against {after}")


def _t5(torch, dev, smi):
    """(d) T5-small (``T5Config()``, dropout 0) in f32: 5 train steps
    (``JittedTrainStep``, AdamW(1e-3)) on one batch, B = 16, source 512,
    target 128; every loss finite and falling. T5's attention is plain
    (no 1/sqrt(d), an f32 bias); its RMSNorms run K1 and K6. Returns the
    steps' launches."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.jit import JittedTrainStep
    from paddle_tpu_torch.nlp import T5Config, T5ForConditionalGeneration
    from paddle_tpu_torch.optimizer import AdamW

    b, src_len, tgt_len, steps = T5_SHAPE
    cfg = T5Config(dropout_rate=0.0)
    model = T5ForConditionalGeneration(cfg, device=dev,
                                       generator=torch.Generator(
                                           device=dev).manual_seed(SEED + 39))
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    src = torch.randint(1, cfg.vocab_size, (b, src_len), generator=g,
                        device=dev)
    labels = torch.randint(1, cfg.vocab_size, (b, tgt_len), generator=g,
                           device=dev)
    dec = model.prepare_decoder_input_ids(labels)
    step = JittedTrainStep(model, lambda out: out[0],
                           AdamW(1e-3, parameters=model.parameters()))
    ops.reset_launches()
    losses, ms = [], []
    for _ in range(steps):
        loss, t = _event_ms(torch, lambda: step([src, dec, labels], []))
        losses.append(float(loss))
        ms.append(t)
    launches = dict(ops.LAUNCHES)
    norms = 2 * cfg.num_layers + 1 + 3 * cfg.num_decoder_layers + 1
    rec = {"phase": "t5_small_train_f32", "gpu": smi, "batch": b,
           "source": src_len, "target": tgt_len, "losses": losses,
           "step_ms": ms, "tokens_per_s": b * (src_len + tgt_len)
           / statistics.median(ms[1:]) * 1e3,
           "launches": {k: v for k, v in launches.items() if v},
           "rms_norms_a_step": norms}
    emit(rec)
    check(all(math.isfinite(v) for v in losses), f"non-finite T5 loss "
          f"{losses}")
    check(losses[-1] < losses[0], f"the T5 loss did not fall: {losses}")
    want = {k: 0 for k in launches}
    want.update(rms_norm=norms * steps, rms_norm_bwd=norms * steps)
    check(launches == want, f"T5 launches {launches}, expected {want}")
    del step, model
    return launches


def bert_phase(torch, dev, smi):
    """Phase 21: BASELINE config #4 and the layer tier it stands on. (a)
    ERNIE-3.0 base pretraining through ``Engine``, (b) ``nn.Transformer``
    at its defaults with its cached decoder, (c) ``hapi.Model`` with
    LeNet, (d) T5-small training. Returns the launches of (a)'s warm
    epoch, (b)'s train step and cached decode, and (d)'s steps."""
    t_phase = time.perf_counter()
    out = {}
    for name, run in (("ernie_engine", _ernie), ("transformer", _transformer),
                      ("hapi_lenet", _hapi_lenet), ("t5_train", _t5)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got = run(torch, dev, smi)
        emit({"phase": "bert_phase_part", "part": name,
              "wall_s": time.perf_counter() - t0})
        if name == "transformer":
            out["transformer_train"], out["transformer_decode"] = got
        elif got is not None:
            out[name] = got
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "bert_done", "wall_s": time.perf_counter() - t_phase})
    return out


def _fleet_worker(out_path):
    """Phase 22's rank (``chip_smoke.py --fleet-worker OUT``, started by
    the port's launcher): phase 7's configuration through fleet at degree
    1 with stage-3 sharding; writes its record to ``OUT``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        group_sharded)
    from paddle_tpu_torch.jit import JittedTrainStep
    from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                      LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import transformer_train_flops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1}
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 3}
    fleet.init(is_collective=True, strategy=strategy)
    dev = torch.device("cuda", torch.cuda.current_device())
    b, seq, _, _ = TRAIN_SHAPE
    warm, steps = FLEET_STEPS
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=4, tensor_parallel=True,
                                dtype="bfloat16")
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    raw = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in raw.parameters())
    model = fleet.distributed_model(raw)
    crit = LlamaPretrainingCriterion(cfg)
    opt = fleet.distributed_optimizer(AdamW(
        1e-4, parameters=model.named_parameters(), weight_decay=0.01,
        multi_precision=True, moment_dtype="bfloat16"))
    step = JittedTrainStep(model, lambda out, lb: crit(out.float(), lb), opt,
                           state_sharding_axis="sharding")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = _train_ids(torch, dev, cfg.vocab_size, b, seq)
    tensors = ([p for p in model.parameters()]
               + [t for st in step._states for t in st.values()])
    state_bytes = {
        "params": sum(p.numel() * p.element_size()
                      for p in model.parameters()),
        "optimizer": sum(t.numel() * t.element_size()
                         for st in step._states for t in st.values())}
    torch.cuda.reset_peak_memory_stats()
    group_sharded.stage3_stats(reset=True)
    losses = [float(step(ids, ids)) for _ in range(warm)]
    ops.reset_launches()
    events = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(ids, ids)
        end.record()
        events.append((start, end, loss))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    losses += [float(loss) for _, _, loss in events]
    step_ms = [s_.elapsed_time(e_) for s_, e_, _ in events]
    stats = group_sharded.stage3_stats()
    peak = torch.cuda.max_memory_allocated()
    from torch.profiler import ProfilerActivity, profile, record_function

    # the update's kernels are elementwise ones, named like "other": give
    # them a range, as train_profile does
    inner = getattr(step._optimizer, "_inner", step._optimizer)
    apply = inner.apply

    def traced_apply(*a, **kw):
        with record_function("optimizer_update"):
            return apply(*a, **kw)

    inner.apply = traced_apply
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(ids, ids)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t1)
    del inner.apply
    prof_rec = _profile_record(torch, prof, "fleet_step", wall_us,
                               ranges=("optimizer_update",))
    prof_rec["optimizer_device_ms"] = _split_range(
        torch, prof, prof_rec, "optimizer_update", "optimizer (AdamW update)")
    med = statistics.median(step_ms)
    tokens = b * seq
    flops = transformer_train_flops(n_params, tokens, num_layers=layers,
                                    seq_len=seq, hidden=cfg.hidden_size)
    record = {
        "backend": dist.get_backend(), "world_size": dist.get_world_size(),
        "devices": sorted({str(t.device) for t in tensors}),
        "degrees": {a: g.nranks for a, g in
                    fleet.get_hybrid_communicate_group()._groups.items()},
        "sharded": all(getattr(p, "_stage3", None) is not None
                       for p in model.parameters()),
        "layers": layers, "params": n_params, "batch": b, "seq": seq,
        "warmup_steps": warm, "timed_steps": steps, "losses": losses,
        "launches": launches, "step_ms": step_ms, "step_ms_median": med,
        "train_tok_per_s": tokens / (med / 1e3),
        "mfu_vs_989_tflops": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"],
        "peak_mem_gb": peak / 2 ** 30, "state_bytes": state_bytes,
        "stage3_gathers_per_step": stats["gathers"] / (warm + steps),
        "stage3_peak_units": stats["peak"], "model_init_s": init_s,
        "profile": prof_rec}
    with open(out_path, "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()
    return 0


def fleet_phase(torch, dev, smi):
    """Phase 22: BASELINE config #3's hybrid-parallel tier at degree 1.
    ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 1
    --device cuda`` starts one NCCL rank running phase 7's configuration
    (Llama-2-7B width, 4 layers, bf16, B = 1, S = 4,096, the same seed and
    batch) through ``fleet.init`` (dp = mp = pp = sharding = 1, stage-3
    sharding), ``distributed_model``, ``distributed_optimizer(AdamW)`` and
    ``JittedTrainStep(state_sharding_axis="sharding")``: the mp layers,
    the stage-3 gathers and reduce-scatters and the data-parallel
    all-reduces all run, on one rank. Checks the backend, the devices,
    phase 7's launches a step and losses, and a falling loss; returns the
    timed steps' launches."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "fleet.json")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "1", "--device", "cuda",
             os.path.abspath(__file__), "--fleet-worker", out],
            env=env, cwd=root, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"the fleet worker exited {proc.returncode}:\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(out) as f:
            rec = json.load(f)
    warm, steps = FLEET_STEPS
    layers = rec["layers"]
    check(rec["backend"] == "nccl", f"backend {rec['backend']}, not nccl")
    check(rec["devices"] == ["cuda:0"],
          f"parameters and state on {rec['devices']}, not cuda:0 alone")
    check(rec["sharded"], "a parameter is not a stage-3 shard")
    check(rec["stage3_peak_units"] == 1,
          f"{rec['stage3_peak_units']} units gathered at once, not 1")
    per_step = {"rms_norm": 2 * layers + 1, "flash_attention": layers,
                "rms_norm_bwd": 2 * layers + 1,
                "flash_attention_bwd": layers}
    want = {k: per_step.get(k, 0) * steps for k in rec["launches"]}
    check(rec["launches"] == want,
          f"fleet launches {rec['launches']}, expected {want}")
    losses, ref = rec["losses"], TRAIN_RECORD["losses"]
    n = min(len(losses), len(ref))
    check(all(math.isfinite(x) for x in losses), f"non-finite: {losses}")
    check(losses[-1] < losses[0],
          f"the loss did not fall over {len(losses)} steps: {losses}")
    check(losses[:n] == ref[:n],
          f"losses {losses[:n]} are not bit-equal to phase 7's {ref[:n]} "
          "for the same weights, batch and kernels")
    profile = rec.pop("profile")
    emit({"phase": "fleet_llama2_7b_width", **rec, "worker_wall_s": wall,
          "phase7_losses": ref[:n],
          "phase7_step_ms": TRAIN_RECORD["step_ms"],
          "phase7_train_tok_per_s": TRAIN_RECORD["tok_per_s"],
          "phase7_mfu_vs_989_tflops": TRAIN_RECORD["mfu"], "smi": smi})
    emit({**profile, "phase": "profile",
          "nccl_device_ms": profile["device_ms_by_family"].get(
              "NCCL collectives", 0.0)})
    return rec["launches"]


# ---------------------------------------------------------------- phase 23
def _api_inputs(torch, dev, shape, dtype, seed):
    """The sweep's named inputs on the card: normals, domains for the ops
    that need one, integer-valued floats (``mod`` / ``floor_divide`` stay
    exact), ints and bools."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi):
        return (torch.rand(shape, generator=g, device=dev) * (hi - lo)
                + lo).to(dtype)

    def n():
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    ints = torch.randint(-50, 50, shape, generator=g, device=dev)
    return {"x": n(), "y": n(), "pos": u(0.1, 3.0), "pos2": u(0.1, 3.0),
            "unit": u(-0.9, 0.9), "gt1": u(1.1, 4.0),
            "prob": u(0.05, 0.95), "near1": u(0.998, 1.002),
            "exp": u(-1.5, 1.5), "whole": ints.to(dtype),
            "wdiv": torch.randint(1, 10, shape, generator=g,
                                  device=dev).to(dtype),
            "ints": ints, "small": torch.randint(1, 12, shape, generator=g,
                                                 device=dev),
            "shift": torch.randint(0, 8, shape, generator=g,
                                   device=dev).to(torch.int32),
            "mask": torch.rand(shape, generator=g, device=dev) > 0.5,
            "mask2": torch.rand(shape, generator=g, device=dev) > 0.5}


def _api_cases(paddle):
    """(name, input keys, fn(paddle, *inputs), compare) for every op of the
    tier: ``compare`` is "close" (max |card - cpu| over max(1, max|cpu|)),
    "exact", or a function (card out, cpu out, card ins, cpu ins) -> that
    same error. Index outputs where bf16 ties make the index ambiguous are
    held by the values they pick."""
    C, E = "close", "exact"
    unary = ["exp", "expm1", "square", "abs", "neg", "sign", "floor", "ceil",
             "round", "trunc", "frac", "sin", "cos", "tan", "atan", "sinh",
             "cosh", "tanh", "asinh", "erf", "sigmoid", "deg2rad",
             "rad2deg", "positive", "stanh", "sgn", "i0", "i0e", "i1",
             "i1e", "isnan", "isinf", "isfinite", "isposinf", "isneginf",
             "isreal", "signbit", "nan_to_num", "real"]
    unary_dom = {"log": "pos", "log2": "pos", "log10": "pos",
                 "log1p": "pos", "sqrt": "pos", "rsqrt": "pos",
                 "reciprocal": "pos", "digamma": "pos", "lgamma": "pos",
                 "gammaln": "pos", "asin": "unit", "acos": "unit",
                 "atanh": "unit", "erfinv": "unit", "acosh": "gt1",
                 "logit": "prob"}
    binary = ["add", "subtract", "multiply", "maximum", "minimum", "fmax",
              "fmin", "atan2", "hypot", "logaddexp", "copysign", "heaviside"]
    cases = [(n, ("x",), lambda m, a, n=n: getattr(m, n)(a), C)
             for n in unary]
    cases += [(n, (d,), lambda m, a, n=n: getattr(m, n)(a), C)
              for n, d in unary_dom.items()]
    cases += [(n, ("x", "y"), lambda m, a, b, n=n: getattr(m, n)(a, b), C)
              for n in binary]
    cases += [
        ("divide", ("x", "pos"), lambda m, a, b: m.divide(a, b), C),
        # one step to the next value of the input's own dtype: its CPU
        # reference runs in that dtype
        ("nextafter", ("x", "y"), lambda m, a, b: m.nextafter(a, b),
         "same_dtype"),
        ("pow", ("pos", "exp"), lambda m, a, b: m.pow(a, b), C),
        ("igamma", ("pos", "pos2"), lambda m, a, b: m.igamma(a, b), C),
        ("igammac", ("pos", "pos2"), lambda m, a, b: m.igammac(a, b), C),
        ("gammainc", ("pos", "pos2"), lambda m, a, b: m.gammainc(a, b), C),
        ("gammaincc", ("pos", "pos2"), lambda m, a, b: m.gammaincc(a, b),
         C),
        ("polygamma", ("pos",), lambda m, a: m.polygamma(a, 1), C),
        ("multigammaln", ("gt1",), lambda m, a: m.multigammaln(a, 2), C),
        ("ldexp", ("x", "shift"), lambda m, a, b: m.ldexp(a, b), C),
        ("frexp", ("pos",), lambda m, a: m.frexp(a), C),
    ]
    cases += [(n, ("whole", "wdiv"), lambda m, a, b, n=n: getattr(m, n)(
        a, b), C) for n in ("mod", "remainder", "floor_mod",
                            "floor_divide")]
    cases += [(n, ("ints", "small"), lambda m, a, b, n=n: getattr(m, n)(
        a, b), E) for n in ("gcd", "lcm", "bitwise_and", "bitwise_or",
                            "bitwise_xor", "equal", "not_equal",
                            "greater_than", "greater_equal", "less_than",
                            "less_equal")]
    cases += [(n, ("ints", "shift"), lambda m, a, b, n=n: getattr(m, n)(
        a.abs().to(b.dtype), b), E) for n in ("bitwise_left_shift",
                                              "bitwise_right_shift")]
    cases += [(n, ("mask", "mask2"), lambda m, a, b, n=n: getattr(m, n)(
        a, b), E) for n in ("logical_and", "logical_or", "logical_xor")]
    cases += [
        ("logical_not", ("mask",), lambda m, a: m.logical_not(a), E),
        ("bitwise_not", ("ints",), lambda m, a: m.bitwise_not(a), E),
        ("isclose", ("x", "y"), lambda m, a, b: m.isclose(a, a + 1e-9 * b),
         E),
        ("allclose", ("x",), lambda m, a: m.allclose(a, a), E),
        ("equal_all", ("x", "y"), lambda m, a, b: m.equal_all(a, b), E),
        ("where", ("mask", "x", "y"), lambda m, c, a, b: m.where(c, a, b),
         E),
        ("clip", ("x",), lambda m, a: m.clip(a, -0.5, 0.7), C),
        ("scale", ("x",), lambda m, a: m.scale(a, 2.0, 0.5), C),
        ("lerp", ("x", "y"), lambda m, a, b: m.lerp(a, b, 0.25), C),
        ("increment", ("x",), lambda m, a: m.increment(a.clone(), 2.0), C),
        ("add_n", ("x", "y"), lambda m, a, b: m.add_n([a, b, a]), C),
        ("angle", ("x",), lambda m, a: m.angle(a), C),
        ("conj", ("x",), lambda m, a: m.conj(a), C),
        ("imag", ("x",), lambda m, a: m.imag(m.complex(
            a.float(), a.float())), C),
        ("complex", ("x", "y"), lambda m, a, b: m.complex(a.float(),
                                                          b.float()), C),
        ("polar", ("pos", "x"), lambda m, a, b: m.polar(a.float(),
                                                        b.float()), C),
        ("as_real", ("x", "y"), lambda m, a, b: m.as_real(
            m.complex(a.float(), b.float())), C),
        ("as_complex", ("x",), lambda m, a: m.as_complex(
            a.float().reshape([-1, 2])), C),
        ("rsqrt_", ("pos",), lambda m, a: m.rsqrt_(a.clone()), C),
    ]
    # reductions (positive inputs: sums of 2^24 terms stay well scaled)
    for n in ("sum", "mean", "nansum", "nanmean", "max", "min", "amax",
              "amin", "logsumexp"):
        cases.append((n, ("pos",), lambda m, a, n=n: getattr(m, n)(
            a, axis=-1), C))
        cases.append((n + "[all]", ("pos",), lambda m, a, n=n: getattr(
            m, n)(a), C))
    cases += [
        ("prod", ("near1",), lambda m, a: m.prod(a, axis=-1), C),
        ("std", ("x",), lambda m, a: m.std(a, axis=-1), C),
        ("var", ("x",), lambda m, a: m.var(a, axis=[0, 2],
                                           unbiased=False), C),
        ("all", ("mask",), lambda m, a: m.all(a, axis=-1), E),
        ("any", ("mask",), lambda m, a: m.any(a, axis=1), E),
        ("count_nonzero", ("mask",), lambda m, a: m.count_nonzero(a, axis=0),
         E),
        ("numel", ("x",), lambda m, a: m.numel(a), E),
        ("cumsum", ("pos",), lambda m, a: m.cumsum(a, axis=-1), C),
        ("cumprod", ("near1",), lambda m, a: m.cumprod(a, dim=-1), C),
        ("logcumsumexp", ("x",), lambda m, a: m.logcumsumexp(a, axis=-1),
         C),
        ("cummax", ("x",), lambda m, a: m.cummax(a, axis=-1)[0], C),
        ("cummin", ("x",), lambda m, a: m.cummin(a, axis=1)[0], C),
        ("diff", ("x",), lambda m, a: m.diff(a, axis=-1), C),
        ("trapezoid", ("pos",), lambda m, a: m.trapezoid(a, dx=0.5,
                                                         axis=-1), C),
        ("cumulative_trapezoid", ("pos",),
         lambda m, a: m.cumulative_trapezoid(a, axis=-1), C),
        ("renorm", ("x",), lambda m, a: m.renorm(a, 2.0, 1, 20.0), C),
    ]
    # manipulation: exact copies
    cases += [
        ("reshape", ("x",), lambda m, a: m.reshape(a, [0, -1, 64]), E),
        ("reshape_", ("x",), lambda m, a: m.reshape_(
            a.clone(), [-1, a.shape[2]]), E),
        ("view", ("x",), lambda m, a: m.view(a, [a.shape[2], -1]), E),
        ("view_as", ("x",), lambda m, a: m.view_as(a[0], a[1]), E),
        ("transpose", ("x",), lambda m, a: m.transpose(a, [2, 0, 1]), E),
        ("permute", ("x",), lambda m, a: m.permute(a, 1, 0, 2), E),
        ("moveaxis", ("x",), lambda m, a: m.moveaxis(a, 0, 2), E),
        ("t", ("x",), lambda m, a: m.t(a[0]), E),
        ("transpose_last", ("x",), lambda m, a: m.transpose_last(a), E),
        ("squeeze", ("x",), lambda m, a: m.squeeze(a[:1], 0), E),
        ("squeeze_", ("x",), lambda m, a: m.squeeze_(a[:1].clone(), 0), E),
        ("unsqueeze", ("x",), lambda m, a: m.unsqueeze(a, [0, -1]), E),
        ("unsqueeze_", ("x",), lambda m, a: m.unsqueeze_(a.clone(), 1), E),
        ("concat", ("x", "y"), lambda m, a, b: m.concat([a, b], axis=1), E),
        ("stack", ("x", "y"), lambda m, a, b: m.stack([a, b], axis=-1), E),
        ("hstack", ("x", "y"), lambda m, a, b: m.hstack([a, b]), E),
        ("row_stack", ("x", "y"), lambda m, a, b: m.row_stack([a, b]), E),
        ("column_stack", ("x", "y"), lambda m, a, b: m.column_stack(
            [a[0], b[0]]), E),
        ("split", ("x",), lambda m, a: m.split(a, [a.shape[1] // 2, -1],
                                               axis=1), E),
        ("chunk", ("x",), lambda m, a: m.chunk(a, 4, axis=-1), E),
        ("tensor_split", ("x",), lambda m, a: m.tensor_split(a, 3, axis=2),
         E),
        ("hsplit", ("x",), lambda m, a: m.hsplit(a, [a.shape[1] // 3]), E),
        ("vsplit", ("x",), lambda m, a: m.vsplit(a, 2), E),
        ("dsplit", ("x",), lambda m, a: m.dsplit(a, [5, a.shape[2] - 7]),
         E),
        ("unbind", ("x",), lambda m, a: m.unbind(a, axis=0), E),
        ("unstack", ("x",), lambda m, a: m.unstack(a, axis=0), E),
        ("flatten", ("x",), lambda m, a: m.flatten(a, 0, 1), E),
        ("unflatten", ("x",), lambda m, a: m.unflatten(a, 2, [-1, 64]), E),
        ("flip", ("x",), lambda m, a: m.flip(a, [0, 2]), E),
        ("rot90", ("x",), lambda m, a: m.rot90(a, 1, (1, 2)), E),
        ("roll", ("x",), lambda m, a: m.roll(a, 17, axis=2), E),
        ("tile", ("x",), lambda m, a: m.tile(a[:, :64], [1, 2, 1]), E),
        ("expand", ("x",), lambda m, a: m.expand(a[:, :1], list(a.shape)),
         E),
        ("expand_as", ("x", "y"), lambda m, a, b: m.expand_as(a[:1], b), E),
        ("broadcast_to", ("x",), lambda m, a: m.broadcast_to(
            a[:, :, :1], list(a.shape)), E),
        ("broadcast_tensors", ("x", "y"), lambda m, a, b:
         m.broadcast_tensors([a, b[:1]]), E),
        ("slice", ("x",), lambda m, a: m.slice(a, [1, 2], [5, 7], [
            a.shape[1] // 2, a.shape[2] - 9]), E),
        ("strided_slice", ("x",), lambda m, a: m.strided_slice(
            a, [2], [1], [a.shape[2] - 5], [3]), E),
        ("crop", ("x",), lambda m, a: m.crop(a, [1, a.shape[1] // 2,
                                                a.shape[2] // 2],
                                             [1, 10, 20]), E),
        ("pad", ("x",), lambda m, a: m.pad(a, [1, 2], mode="reflect"), E),
        ("diagonal", ("x",), lambda m, a: m.diagonal(a, 0, 1, 2), E),
        ("diag", ("x",), lambda m, a: m.diag(a[0, 0, :512]), E),
        ("diagflat", ("x",), lambda m, a: m.diagflat(a[0, 0, :256]), E),
        ("diag_embed", ("x",), lambda m, a: m.diag_embed(a[0, :8, :256]), E),
        ("tril", ("x",), lambda m, a: m.tril(a, -1), E),
        ("triu", ("x",), lambda m, a: m.triu(a, 1), E),
        ("trace", ("x",), lambda m, a: m.trace(a[0]), C),
        ("atleast_1d", ("x",), lambda m, a: m.atleast_1d(a[0, 0, 0]), E),
        ("atleast_2d", ("x",), lambda m, a: m.atleast_2d(a[0, 0]), E),
        ("atleast_3d", ("x",), lambda m, a: m.atleast_3d(a[0]), E),
        ("as_strided", ("x",), lambda m, a: m.as_strided(
            a, [a.shape[1] // 2, 64], [a.shape[2], 2], 3), E),
        ("repeat_interleave", ("x",), lambda m, a: m.repeat_interleave(
            a[:, :256], 2, axis=1), E),
        ("block_diag", ("x", "y"), lambda m, a, b: m.block_diag(
            [a[0, :64, :64], b[0, :32, :96]]), E),
        ("select_scatter", ("x", "y"), lambda m, a, b: m.select_scatter(
            a, b[:, 0], 1, 5), E),
        ("slice_scatter", ("x", "y"), lambda m, a, b: m.slice_scatter(
            a, b[:, :, :a.shape[2] // 2], [2], [0], [a.shape[2]], [2]), E),
        ("diagonal_scatter", ("x", "y"), lambda m, a, b:
         m.diagonal_scatter(a[0], b[0].diagonal()), E),
        ("cast", ("x",), lambda m, a: m.cast(a, "float32"), E),
        ("clone", ("x",), lambda m, a: m.clone(a), E),
        ("assign", ("x",), lambda m, a: m.assign(a), E),
        ("masked_fill", ("x", "mask"), lambda m, a, k: m.masked_fill(
            a, k, -1.0), E),
        ("masked_select", ("x", "mask"), lambda m, a, k: m.masked_select(
            a, k), E),
        ("masked_scatter", ("x", "mask", "y"), lambda m, a, k, b:
         m.masked_scatter(a, k, b), E),
        ("gather", ("x", "ints"), lambda m, a, i: m.gather(
            a, i[0, 0, :100] % a.shape[1], axis=1), E),
        ("gather_nd", ("x", "ints"), lambda m, a, i: m.gather_nd(
            a, m.stack([i[0, 0, :100] % 2, i[0, 1, :100] % a.shape[1]],
                       axis=1)), E),
        ("index_select", ("x", "ints"), lambda m, a, i: m.index_select(
            a, i[0, 0, :100] % a.shape[2], axis=2), E),
        ("index_sample", ("x", "ints"), lambda m, a, i: m.index_sample(
            a[0], i[0, :, :8] % a.shape[2]), E),
        ("take_along_axis", ("x", "ints"), lambda m, a, i:
         m.take_along_axis(a, i[:, :, :8] % a.shape[2], axis=2), E),
        ("put_along_axis", ("x", "ints"), lambda m, a, i: m.put_along_axis(
            a, (i[:, :, :1] + 50) % a.shape[2], 9.0, axis=2), E),
        ("take", ("x", "ints"), lambda m, a, i: m.take(
            a, i[0, :4] % 1000), E),
        ("index_fill", ("x", "ints"), lambda m, a, i: m.index_fill(
            a, i[0, 0, :4] % a.shape[2], 2, -7.0), E),
        ("index_add", ("x", "y", "ints"), lambda m, a, b, i: m.index_add(
            a, i[0, 0, :4] % a.shape[1], 1, b[:, :4]), C),
        ("index_put", ("x", "y", "ints"), lambda m, a, b, i: m.index_put(
            a[0], (i[0, 0, :64] % a.shape[1], i[0, 1, :64] % a.shape[2]),
            b[0, 0, :64], accumulate=True), C),
        ("scatter", ("x", "y"), lambda m, a, b: m.scatter(
            a[0], m.flip(m.arange(8), [0]) * 3, b[0, :8]), E),
        ("scatter_", ("x", "y"), lambda m, a, b: m.scatter_(
            a[0].clone(), m.arange(8) * 5, b[0, :8]), E),
        ("scatter_nd", ("y", "ints"), lambda m, b, i: m.scatter_nd(
            m.reshape(i[0, 0, :8] % b.shape[1], [8, 1]), b[0, :8],
            list(b.shape[1:])), C),
        ("scatter_nd_add", ("x", "y", "ints"), lambda m, a, b, i:
         m.scatter_nd_add(a[0], m.reshape(i[0, 0, :8] % a.shape[1], [8, 1]),
                          b[0, :8]), C),
        ("multiplex", ("x", "y", "ints"), lambda m, a, b, i: m.multiplex(
            [a[0], b[0]], m.reshape(i[0, :, :1] % 2, [a.shape[1], 1])), E),
        ("shard_index", ("ints",), lambda m, i: m.shard_index(
            m.reshape(i[0, 0] + 50, [-1, 1]), 100, 4, 1), E),
        ("one_hot", ("ints",), lambda m, i: m.one_hot(i[0, 0, :512] + 50,
                                                      100), E),
        ("bincount", ("ints",), lambda m, i: m.bincount(i[0, 0] + 50), E),
        ("histogram", ("x",), lambda m, a: m.histogram(a[0], bins=50,
                                                       min=-3, max=3), E),
        ("histogramdd", ("x",), lambda m, a: m.histogramdd(
            a[0, :, :2].float(), bins=8)[0], E),
        ("unique", ("ints",), lambda m, i: m.unique(
            i, return_index=True, return_inverse=True, return_counts=True),
         E),
        ("unique_consecutive", ("ints",), lambda m, i:
         m.unique_consecutive(i // 20, return_counts=True), E),
        ("vander", ("x",), lambda m, a: m.vander(a[0, 0, :64], 5), C),
        ("combinations", ("x",), lambda m, a: m.combinations(
            a[0, 0, :64], 2), E),
        ("cartesian_prod", ("x", "y"), lambda m, a, b: m.cartesian_prod(
            [a[0, 0, :64], b[0, 0, :64]]), E),
        ("meshgrid", ("x", "y"), lambda m, a, b: m.meshgrid(
            a[0, 0, :64], b[0, 0, :32]), E),
        ("unfold", ("x",), lambda m, a: m.unfold(
            a[:, :8, :256].reshape([2, 8, 16, 16]), 3, 1, 1), E),
        ("is_empty", ("x",), lambda m, a: m.is_empty(a), E),
        ("rank", ("x",), lambda m, a: m.rank(a), E),
        ("shape", ("x",), lambda m, a: m.shape(a), E),
    ]
    return cases


def _row_wise(cases):
    """Names among ``cases`` that act on each row of the inputs' dim 1 alone
    (elementwise ops, reductions and scans along the last axis): their CPU
    reference computes the first ``TENSOR_API_CPU_ROWS`` rows."""
    along_last = {"sum", "mean", "nansum", "nanmean", "max", "min", "amax",
                  "amin", "logsumexp", "prod", "std", "cumsum", "cumprod",
                  "logcumsumexp", "cummax", "diff", "trapezoid",
                  "cumulative_trapezoid"}
    shaped = {"x", "y", "pos", "pos2", "unit", "gt1", "prob", "near1",
              "exp", "whole", "wdiv", "ints", "small", "shift", "mask",
              "mask2"}
    elementwise = set()
    for name, keys, fn, cmp in cases:
        if name in along_last or (set(keys) <= shaped and name in _ELEMENTWISE):
            elementwise.add(name)
    return elementwise


def _rows(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_rows(e) for e in x)
    return x[:, :TENSOR_API_CPU_ROWS]


def _api_search_cases(paddle):
    """Sorts, searches and quantiles, at ``TENSOR_API_SEARCH_SHAPE``."""
    C, E = "close", "exact"

    def picked(key_axis):
        def err(a, b, ins_a, ins_b):
            return _api_err(_take(ins_a[0], a, key_axis),
                            _take(ins_b[0], b, key_axis))
        return err

    def vals_picked(a, b, ins_a, ins_b):
        return max(_api_err(a[0], b[0]), picked(-1)(a[1], b[1], ins_a,
                                                      ins_b))

    return [
        ("argmax", ("x",), lambda m, a: m.argmax(a, axis=-1, keepdim=True),
         picked(-1)),
        ("argmin", ("x",), lambda m, a: m.argmin(a, axis=-1, keepdim=True),
         picked(-1)),
        ("argsort", ("x",), lambda m, a: m.argsort(a, axis=-1), E),
        ("argsort[desc]", ("x",), lambda m, a: m.argsort(
            a, axis=-1, descending=True), E),
        ("sort", ("x",), lambda m, a: m.sort(a, axis=-1), E),
        ("topk", ("x",), lambda m, a: m.topk(a, 8, axis=-1), vals_picked),
        ("kthvalue", ("x",), lambda m, a: m.kthvalue(a, 10, axis=-1), E),
        ("mode", ("ints",), lambda m, i: m.mode(i % 7, axis=-1), E),
        ("median", ("x",), lambda m, a: m.median(a, axis=-1), C),
        ("nanmedian", ("x",), lambda m, a: m.nanmedian(a, axis=-1), C),
        ("quantile", ("x",), lambda m, a: m.quantile(a, [0.1, 0.9],
                                                     axis=-1), C),
        ("nanquantile", ("x",), lambda m, a: m.nanquantile(a, 0.3,
                                                           axis=-1), C),
        ("nonzero", ("mask",), lambda m, k: m.nonzero(k[0]), E),
        ("searchsorted", ("x", "y"), lambda m, a, b: m.searchsorted(
            m.sort(a, axis=-1), b), E),
        ("bucketize", ("x", "y"), lambda m, a, b: m.bucketize(
            b[0, 0], m.sort(a[0, 0])), E),
    ]


def _api_product_cases(paddle):
    """Products at ``TENSOR_API_MATMUL`` over (a, b): (name, fn, cpu_args,
    part): the CPU reference computes ``fn`` on ``cpu_args(a, b)`` (the
    first ``TENSOR_API_CPU_ROWS`` rows where a full f64 product would take
    the CPU seconds) and is held against ``part(card output)``."""
    r = TENSOR_API_CPU_ROWS

    def rows_a(a, b):
        return a[:r], b

    def rows_ab(a, b):
        return a[:r], b[:r]

    def full(a, b):
        return a, b

    def first(o):
        return o[:r]

    def whole(o):
        return o

    return [
        ("matmul", lambda m, a, b: m.matmul(a, b), rows_a, first),
        ("matmul[T]", lambda m, a, b: m.matmul(a, b, transpose_y=True),
         rows_a, first),
        ("mm", lambda m, a, b: m.mm(a, b), rows_a, first),
        ("bmm", lambda m, a, b: m.bmm(m.stack([a, a]), m.stack([b, b])),
         rows_a, lambda o: o[:, :r]),
        ("addmm", lambda m, a, b: m.addmm(m.ones_like(a[:, :64]), a,
                                          b[:, :64]), rows_a, first),
        ("mv", lambda m, a, b: m.mv(a, b[:, 0]), rows_a, first),
        ("einsum", lambda m, a, b: m.einsum("ik,kj->ij", a, b), rows_a,
         first),
        ("tensordot", lambda m, a, b: m.tensordot(a, b, [[1], [0]]),
         rows_a, first),
        ("multi_dot", lambda m, a, b: m.multi_dot([a, b, b[:, :64]]),
         rows_a, first),
        ("inner", lambda m, a, b: m.inner(a, b), rows_a, first),
        ("cdist", lambda m, a, b: m.cdist(a, b), rows_a, first),
        ("outer", lambda m, a, b: m.outer(a[:, 0], b[0]), rows_a, first),
        ("dot", lambda m, a, b: m.dot(a, b), rows_ab, first),
        ("cross", lambda m, a, b: m.cross(a[:, :3], b[:, :3], axis=1),
         rows_ab, first),
        ("norm", lambda m, a, b: m.norm(a, p=2, axis=1), rows_a, first),
        ("kron", lambda m, a, b: m.kron(a[:64, :64], b[:64, :64]), full,
         whole),
        ("dist", lambda m, a, b: m.dist(a, b), full, whole),
    ]


def _api_linalg_cases(paddle):
    """Decompositions and solves at ``TENSOR_API_DECOMP`` in f32, over a
    well-conditioned matrix near the identity (``near``), an SPD matrix
    (``spd``) and a tall one (``tall``); results that are unique only up
    to signs are compared by what is unique (values, reconstructions)."""
    C = "close"
    L = paddle.linalg

    def recon_svd(m, a):
        u, s, vh = L.svd(a)
        return s, m.matmul(u * s[None, :], vh)

    def recon_qr(m, a):
        q, r = L.qr(a)
        return m.abs(r), m.matmul(q, r)

    def recon_eigh(m, a):
        w, v = L.eigh(a)
        return w, m.matmul(v * w[None, :], v.T)

    def recon_lu(m, a):
        p, lo, up = L.lu_unpack(*L.lu(a))
        return m.matmul(p, m.matmul(lo, up))

    return [
        ("inv", ("near",), lambda m, a: L.inv(a), C),
        ("inverse", ("near",), lambda m, a: m.inverse(a), C),
        ("det", ("near",), lambda m, a: L.det(a), C),
        ("slogdet", ("spd",), lambda m, a: L.slogdet(a), C),
        ("cholesky", ("spd",), lambda m, a: L.cholesky(a), C),
        ("cholesky_solve", ("spd", "rhs"), lambda m, a, b: L.cholesky_solve(
            b, L.cholesky(a)), C),
        ("solve", ("near", "rhs"), lambda m, a, b: L.solve(a, b), C),
        ("triangular_solve", ("near", "rhs"), lambda m, a, b:
         L.triangular_solve(m.triu(a), b), C),
        ("lstsq", ("tall", "rhs2"), lambda m, a, b: L.lstsq(a, b)[0], C),
        ("pinv", ("tall",), lambda m, a: L.pinv(a), C),
        ("matrix_power", ("near",), lambda m, a: L.matrix_power(a, 3), C),
        ("matrix_rank", ("tall",), lambda m, a: L.matrix_rank(a), "exact"),
        ("matrix_exp", ("near",), lambda m, a: L.matrix_exp(a), C),
        ("cond", ("spd",), lambda m, a: L.cond(a), C),
        ("svd", ("tall",), recon_svd, C),
        ("qr", ("tall",), recon_qr, C),
        ("eigh", ("spd",), recon_eigh, C),
        ("eigvalsh", ("spd",), lambda m, a: L.eigvalsh(a), C),
        ("eig", ("spd",), lambda m, a: m.sort(m.real(L.eig(a)[0])), C),
        ("eigvals", ("spd",), lambda m, a: m.sort(m.real(L.eigvals(a))), C),
        ("lu", ("near",), lambda m, a: L.lu(a), C),
        ("lu_unpack", ("near",), recon_lu, C),
        ("householder_product", ("refl", "tau"), lambda m, a, t:
         L.householder_product(a, t), C),
        ("corrcoef", ("tall",), lambda m, a: L.corrcoef(a[:, :64].T), C),
        ("cov", ("tall",), lambda m, a: L.cov(a[:, :64].T), C),
    ]


def _api_creation_cases(paddle):
    """Ops that make tensors from shapes and values, on the current place
    (the card, then the CPU for the reference)."""
    import numpy as np

    b, r, n = TENSOR_API_SHAPE
    return [
        ("zeros", lambda m: m.zeros([b, r, n])),
        ("ones", lambda m: m.ones([r, n], dtype="bfloat16")),
        ("full", lambda m: m.full([r, n], 1.5)),
        ("empty", lambda m: m.empty([r, n]) * 0),
        ("zeros_like", lambda m: m.zeros_like(m.ones([8, n]))),
        ("ones_like", lambda m: m.ones_like(m.zeros([8, n]))),
        ("full_like", lambda m: m.full_like(m.zeros([8, n]), 2.5)),
        ("empty_like", lambda m: m.empty_like(m.zeros([8, n])) * 0),
        ("arange", lambda m: m.arange(0, r * n)),
        ("linspace", lambda m: m.linspace(-1.0, 1.0, r * n)),
        ("logspace", lambda m: m.logspace(0, 2, 4096)),
        ("eye", lambda m: m.eye(n)),
        ("tril_indices", lambda m: m.tril_indices(512, 512, -1)),
        ("triu_indices", lambda m: m.triu_indices(512, 512, 1)),
        ("to_tensor", lambda m: m.to_tensor(np.arange(1 << 20,
                                                       dtype=np.float64))),
        ("broadcast_shape", lambda m: m.to_tensor(
            m.broadcast_shape([b, 1, n], [r, 1]))),
        ("tolist", lambda m: m.to_tensor(m.tolist(m.arange(64)))),
        ("is_tensor", lambda m: m.to_tensor(m.is_tensor(m.ones([2])))),
        ("is_complex", lambda m: m.to_tensor(m.is_complex(m.ones([2])))),
        ("is_floating_point", lambda m: m.to_tensor(
            m.is_floating_point(m.ones([2])))),
        ("is_integer", lambda m: m.to_tensor(m.is_integer(m.arange(2)))),
    ]


def _api_random_cases(paddle, shape, dtype):
    """(name, draw(), mean, variance) at the sweep's shape: each draw is
    taken twice after ``seed(s)`` (equal bit for bit) and its moments held
    within 5 sigma (a sample mean's and a sample variance's own sd)."""
    x = paddle.zeros(list(shape), dtype=dtype)
    return [
        ("rand", lambda: paddle.rand(list(shape), dtype=dtype), 0.5, 1 / 12),
        ("randn", lambda: paddle.randn(list(shape), dtype=dtype), 0.0, 1.0),
        ("standard_normal", lambda: paddle.standard_normal(
            list(shape), dtype=dtype), 0.0, 1.0),
        ("uniform", lambda: paddle.uniform(list(shape), dtype=dtype,
                                           min=-2.0, max=4.0), 1.0, 3.0),
        ("normal", lambda: paddle.normal(2.0, 3.0, list(shape)), 2.0, 9.0),
        ("rand_like", lambda: paddle.rand_like(x), 0.5, 1 / 12),
        ("randn_like", lambda: paddle.randn_like(x), 0.0, 1.0),
        ("randint", lambda: paddle.randint(0, 10, list(shape)), 4.5,
         99 / 12),
        ("randint_like", lambda: paddle.randint_like(x, 0, 4), 1.5, 15 / 12),
        ("bernoulli", lambda: paddle.bernoulli(paddle.full_like(
            x, 0.3, dtype="float32")), 0.3, 0.21),
        ("poisson", lambda: paddle.poisson(paddle.full_like(
            x, 4.0, dtype="float32")), 4.0, 4.0),
        ("multinomial", lambda: paddle.multinomial(paddle.to_tensor(
            [0.2, 0.3, 0.5]), 1 << 20, replacement=True), 1.3, 0.61),
        ("randperm", lambda: paddle.randperm(1 << 20).float() / (1 << 20),
         0.5 - 0.5 / (1 << 20), None),
        ("uniform_", lambda: paddle.uniform_(x.clone(), 0.0, 2.0), 1.0,
         1 / 3),
        ("normal_", lambda: paddle.normal_(x.clone(), 1.0, 0.5), 1.0, 0.25),
        ("exponential_", lambda: paddle.exponential_(x.clone(), 2.0), 0.5,
         0.25),
        ("gumbel_softmax", lambda: paddle.gumbel_softmax(
            x.reshape([-1, 2]).float())[:, 0], 0.5, None),
    ]


def _api_ref(x, device):
    """An output as a tensor on ``device`` to compare: floats in f64,
    complex in complex128, ints in int64; nested structures kept."""
    import torch

    if isinstance(x, (list, tuple)):
        return [_api_ref(e, device) for e in x]
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    x = x.detach().to(device)
    if x.is_complex():
        return x.to(torch.complex128)
    if x.is_floating_point():
        return x.double()
    return x.long()


def _first_device(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (list, tuple)):
        for e in x:
            d = _first_device(e)
            if d is not None:
                return d
    return None


def _api_err(a, b):
    """max |a - b| over max(1, max |b|), with NaN / inf where both have
    them; a mismatch of structure, shape or finiteness is inf. Computed on
    ``a``'s device (the card: the CPU reference moves there)."""
    import torch

    dev = _first_device(a) or torch.device("cpu")
    a, b = _api_ref(a, dev), _api_ref(b, dev)
    if isinstance(b, list):
        if not isinstance(a, list) or len(a) != len(b):
            return math.inf
        return max([_api_err(x, y) for x, y in zip(a, b)] or [0.0])
    if isinstance(a, list) or a.shape != b.shape:
        return math.inf
    if b.numel() == 0:
        return 0.0
    if not (b.is_floating_point() or b.is_complex()):
        return 0.0 if torch.equal(a.double(), b.double()) else math.inf
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return math.inf
    if not torch.equal(a[~fb].nan_to_num(0.0, 1.0, -1.0),
                       b[~fb].nan_to_num(0.0, 1.0, -1.0)):
        return math.inf
    if not bool(fb.any()):
        return 0.0
    scale = max(1.0, float(b[fb].abs().max()))
    return float((a[fb] - b[fb]).abs().max()) / scale


def _take(x, idx, axis):
    """``x``'s values at indices ``idx`` along ``axis`` (on ``x``'s
    device)."""
    return x.gather(axis, idx.to(x.device))


def _api_cpu(t):
    """A card input's CPU copy, floats in f64 (complex in complex128)."""
    import torch

    t = t.detach().cpu()
    if t.is_complex():
        return t.to(torch.complex128)
    return t.double() if t.is_floating_point() else t


class _Sweep:
    """Runs cases on the card and their references on the CPU; keeps the
    ops run, the failures by name and the worst error per dtype."""

    def __init__(self, torch, paddle):
        self.torch, self.paddle = torch, paddle
        self.run_names, self.failures, self.worst = set(), {}, {}
        self.errors, self.walls = {}, {}
        self.count = 0

    def case(self, name, fn, ins, compare, dtype_name, cpu_ins=None,
             cpu_args=None, part=None):
        torch, paddle = self.torch, self.paddle
        place = paddle.core.place
        label = f"{name}[{dtype_name}]"
        self.run_names.add(name.split("[")[0])
        t0 = time.perf_counter()
        try:
            out = fn(paddle, *ins)
            torch.cuda.synchronize()
            if cpu_ins is None:
                cpu_ins = [t.detach().cpu() if compare == "same_dtype"
                           else _api_cpu(t)
                           for t in (cpu_args(*ins) if cpu_args else ins)]
            saved = place._current
            paddle.set_device("cpu")
            try:
                ref = fn(paddle, *cpu_ins)
            finally:
                place._current = saved
            if part is not None:
                out = part(out)
            err = (compare(out, ref, ins, cpu_ins) if callable(compare)
                   else _api_err(out, ref))
        except Exception as e:  # recorded as this op's failure
            self.failures[label] = f"{type(e).__name__}: {e}"[:300]
            return
        self.count += 1
        self.walls[label] = time.perf_counter() - t0
        tol = 0.0 if compare in ("exact", "same_dtype") else \
            TENSOR_API_TOL[dtype_name]
        if tol:
            self.worst[dtype_name] = max(self.worst.get(dtype_name, 0.0),
                                         err)
            self.errors[label] = err
        if not err <= tol:
            self.failures[label] = err


def _api_sweep(torch, paddle, dev):
    """(a) every op of the tier once on CUDA tensors against the same port
    function on a CPU copy in f64; random ops by reproducibility at a seed
    and moments. Returns the record."""
    sweep = _Sweep(torch, paddle)
    t0 = time.perf_counter()
    cases = _api_cases(paddle)
    typed = [c for c in cases if any(k in c[1] for k in _API_FLOAT_KEYS)]
    row_wise = _row_wise(cases)
    untyped = [c for c in cases if c not in typed]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        ins = _api_inputs(torch, dev, TENSOR_API_SHAPE, dtype, SEED + 40)
        cpu = {k: _api_cpu(v) for k, v in ins.items()}
        rows = {k: v[:, :TENSOR_API_CPU_ROWS] for k, v in cpu.items()}
        for name, keys, fn, cmp in typed:
            by_row = name in row_wise
            sweep.case(name, fn, [ins[k] for k in keys], cmp, dname,
                       cpu_ins=None if cmp == "same_dtype" else
                       [(rows if by_row else cpu)[k] for k in keys],
                       cpu_args=(lambda *a: [_rows(t) for t in a])
                       if by_row else None,
                       part=_rows if by_row else None)
        del cpu, rows
        sins = _api_inputs(torch, dev, TENSOR_API_SEARCH_SHAPE, dtype,
                           SEED + 41)
        cpu = {k: _api_cpu(v) for k, v in sins.items()}
        for name, keys, fn, cmp in _api_search_cases(paddle):
            sweep.case(name, fn, [sins[k] for k in keys], cmp, dname,
                       cpu_ins=[cpu[k] for k in keys])
        del cpu
        g = torch.Generator(device=dev).manual_seed(SEED + 42)
        n = TENSOR_API_MATMUL
        a = torch.randn(n, n, generator=g, device=dev).to(dtype)
        b = torch.randn(n, n, generator=g, device=dev).to(dtype)
        for name, fn, cpu_args, part in _api_product_cases(paddle):
            sweep.case(name, fn, [a, b], "close", dname, cpu_args=cpu_args,
                       part=part)
        del ins, sins, a, b
        gc.collect()
        torch.cuda.empty_cache()
    ints = _api_inputs(torch, dev, TENSOR_API_SHAPE, torch.float32,
                       SEED + 40)
    cpu = {k: _api_cpu(v) for k, v in ints.items()}
    rows = {k: v[:, :TENSOR_API_CPU_ROWS] for k, v in cpu.items()}
    for name, keys, fn, cmp in untyped:
        by_row = name in row_wise
        sweep.case(name, fn, [ints[k] for k in keys], cmp, "int",
                   cpu_ins=[(rows if by_row else cpu)[k] for k in keys],
                   part=_rows if by_row else None)
    del cpu, rows
    del ints
    g = torch.Generator(device=dev).manual_seed(SEED + 43)
    n = TENSOR_API_DECOMP
    c = torch.randn(n, n, generator=g, device=dev)
    lin = {"near": torch.eye(n, device=dev) + c / (4 * math.sqrt(n)),
           "spd": c @ c.T / n + torch.eye(n, device=dev),
           "tall": torch.randn(2 * n, n, generator=g, device=dev),
           "rhs": torch.randn(n, 8, generator=g, device=dev),
           "rhs2": torch.randn(2 * n, 8, generator=g, device=dev),
           "tau": torch.rand(n, generator=g, device=dev) + 0.5}
    # reflectors with a unit head and a small tail, as geqrf leaves them
    lin["refl"] = lin["tall"] / (4 * math.sqrt(2 * n))
    for name, keys, fn, cmp in _api_linalg_cases(paddle):
        sweep.case(name, fn, [lin[k] for k in keys], cmp,
                   "float32_decomposition")
    for name, fn in _api_creation_cases(paddle):
        sweep.case(name, lambda m, fn=fn: fn(m), [], "close"
                   if name in ("linspace", "logspace") else "exact",
                   "float32")
    random_rec = {}
    for name, draw, mean, var in _api_random_cases(
            paddle, TENSOR_API_SHAPE, "float32"):
        sweep.run_names.add(name)
        try:
            paddle.seed(SEED + 44)
            first = draw()
            paddle.seed(SEED + 44)
            again = draw()
            same = bool(torch.equal(first, again))
            v = first.double()
            k = v.numel()
            var_s = float(v.var())
            sd = math.sqrt(var if var is not None else var_s)
            mean_z = abs(float(v.mean()) - mean) / (sd / math.sqrt(k))
            var_z = 0.0
            if var is not None:
                mu4 = float(((v - v.mean()) ** 4).mean())
                var_z = abs(var_s - var) / math.sqrt(
                    max(mu4 - var ** 2, 1e-30) / k)
            if name == "randperm":
                same = same and bool(torch.equal(
                    torch.sort(first).values,
                    torch.arange(k, device=dev).float() / k))
            random_rec[name] = {"n": k, "repeats": same,
                                "mean_sigmas": mean_z, "var_sigmas": var_z}
            sweep.count += 1
            if not (same and mean_z <= 5 and var_z <= 5):
                sweep.failures[f"{name}[random]"] = random_rec[name]
        except Exception as e:  # recorded as this op's failure
            sweep.failures[f"{name}[random]"] = \
                f"{type(e).__name__}: {e}"[:300]
    missing = sorted(set(paddle.tensor.__all__) - sweep.run_names)
    return {"phase": "tensor_api_sweep", "ops_run": sweep.count,
            "op_names": len(sweep.run_names), "not_run": missing,
            "failures": sweep.failures, "worst_err_by_dtype": sweep.worst,
            "largest_errors": dict(sorted(sweep.errors.items(),
                                          key=lambda kv: -kv[1])[:12]),
            "slowest_cases_s": dict(sorted(sweep.walls.items(),
                                           key=lambda kv: -kv[1])[:12]),
            "tolerance_by_dtype": dict(TENSOR_API_TOL),
            "shapes": {"elementwise_reduction_manipulation":
                       list(TENSOR_API_SHAPE),
                       "search": list(TENSOR_API_SEARCH_SHAPE),
                       "products": [TENSOR_API_MATMUL] * 2,
                       "products_cpu_rows": TENSOR_API_CPU_ROWS,
                       "decompositions": [TENSOR_API_DECOMP] * 2},
            "random": random_rec, "wall_s": time.perf_counter() - t0}


_API_FLOAT_KEYS = ("x", "y", "pos", "pos2", "unit", "gt1", "prob", "near1",
                   "exp", "whole", "wdiv")
# the elementwise ops of the sweep (output element i reads input element i)
_ELEMENTWISE = {
    "exp", "expm1", "square", "abs", "neg", "sign", "floor", "ceil", "round",
    "trunc", "frac", "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh",
    "asinh", "erf", "sigmoid", "deg2rad", "rad2deg", "positive", "stanh",
    "sgn", "i0", "i0e", "i1", "i1e", "isnan", "isinf", "isfinite",
    "isposinf", "isneginf", "isreal", "signbit", "nan_to_num", "real", "log",
    "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal", "digamma",
    "lgamma", "gammaln", "asin", "acos", "atanh", "erfinv", "acosh", "logit",
    "add", "subtract", "multiply", "maximum", "minimum", "fmax", "fmin",
    "atan2", "hypot", "logaddexp", "copysign", "heaviside", "divide", "pow",
    "igamma", "igammac", "gammainc", "gammaincc", "polygamma",
    "multigammaln", "ldexp", "frexp", "mod", "remainder", "floor_mod",
    "floor_divide", "gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor",
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "bitwise_left_shift", "bitwise_right_shift", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_not", "isclose",
    "where", "clip", "scale", "lerp", "increment", "add_n", "angle", "conj",
    "rsqrt_", "masked_fill"}


def _kernel_names(torch, fn):
    """The CUDA kernels one call of ``fn`` launches, by name (a Counter),
    from one torch.profiler window."""
    import collections
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return collections.Counter(ev.name for ev in prof.events()
                               if ev.device_type == cuda)


def _api_resnet(torch, paddle, dev, smi):
    """(b) BASELINE config #1 through the public API: the body of
    scripts/bench_suite.py's ``resnet50_eager`` with the import swapped to
    ``paddle_tpu_torch`` and its JAX-only sync (``np.asarray(
    loss._value)``) replaced by ``float(loss)``; the weights carried into
    phase 20's direct-path model (``vision.models.resnet50(device=,
    generator=)``, the port's CrossEntropyLoss and Momentum) before either
    steps; both fed the same batch. cuDNN runs deterministic algorithms
    here, so the two paths' losses can be equal bit for bit."""
    import numpy as np
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        # -- the body of resnet50_eager (scripts/bench_suite.py:48-73)
        paddle.seed(0)
        model = resnet50()
        ce = paddle.nn.CrossEntropyLoss()
        opt = paddle.optimizer.Momentum(0.1, parameters=model.parameters())
        rng = np.random.RandomState(0)
        batch = 32
        x = paddle.to_tensor(rng.randn(batch, 3, 224, 224).astype("f4"))
        y = paddle.to_tensor(rng.randint(0, 1000, batch).astype("i8"))

        def step():
            loss = ce(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            float(loss)  # block: same sync rule as the jit bench
            return loss
        # -- end of the body

        direct = resnet50(device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED + 25))
        direct.load_state_dict(model.state_dict())
        d_ce = CrossEntropyLoss()
        d_opt = Momentum(RESNET_LR, parameters=direct.parameters())

        def d_step():
            loss = d_ce(direct(x), y)
            loss.backward()
            d_opt.step()
            d_opt.clear_grad()
            return float(loss)

        check(model.training and x.device.type == "cuda"
              and next(model.parameters()).device.type == "cuda",
              "the public path did not build on the card by default")
        api = [float(step()) for _ in range(RESNET_API_STEPS)]
        ref = [d_step() for _ in range(RESNET_API_STEPS)]
        # a profile may drop events (one profile of the direct step once
        # read 35 fewer launches than the same step in another run), so
        # each path is profiled twice, in turns, and counts its larger one
        profiles = {"public_api": [], "direct": []}
        for _ in range(2):
            profiles["public_api"].append(_kernel_names(torch, step))
            profiles["direct"].append(_kernel_names(torch, d_step))
        counts = {k: [sum(c.values()) for c in v]
                  for k, v in profiles.items()}
        most = {k: max(v, key=lambda c: sum(c.values()))
                for k, v in profiles.items()}
        differ = {n: (most["public_api"][n], most["direct"][n])
                  for n in set(most["public_api"]) | set(most["direct"])
                  if most["public_api"][n] != most["direct"][n]}
        walls = []
        for _ in range(RESNET_API_TIMED):
            t0 = time.perf_counter()
            step()
            walls.append(1e3 * (time.perf_counter() - t0))
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    ms = statistics.median(walls)
    rec = {"phase": "tensor_api_resnet50", "gpu": smi, "batch": batch,
           "losses_public_api": api, "losses_direct": ref,
           "bit_equal": api == ref,
           "launches_per_step_public_api": max(counts["public_api"]),
           "launches_per_step_direct": max(counts["direct"]),
           "launches_by_profile": counts,
           "kernels_differing": dict(list(differ.items())[:10]),
           "step_ms_public_api": walls,
           "images_per_s_public_api": batch / ms * 1e3,
           "images_per_s_phase20_direct_f32": RESNET_RECORD.get(
               "images_per_s_f32", "not measured"),
           "cudnn_deterministic": True}
    emit(rec)
    check(api == ref, f"public-API losses {api} are not bit-equal to the "
          f"direct path's {ref}")
    check(all(math.isfinite(v) for v in api), f"non-finite losses {api}")
    check(max(counts["public_api"]) == max(counts["direct"]),
          f"kernel launches a step through the public API {counts} differ "
          f"from the direct path's: {differ}")
    del model, direct, opt, d_opt


def _swiglu(paddle, d, f, dtype):
    """A user-written paddle Layer: a SwiGLU MLP d -> f -> d built with
    ``create_parameter`` and ``ParamAttr(initializer=...)``."""
    init = paddle.nn.initializer

    class SwiGLU(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.gate = self.create_parameter([d, f], dtype=dtype,
                                              attr=paddle.ParamAttr(
                                                  name="gate",
                                                  initializer=init.Normal(
                                                      0.0, 0.02)))
            self.up = self.create_parameter([d, f], dtype=dtype,
                                            attr=paddle.ParamAttr(
                                                name="up", initializer=(
                                                    init.XavierUniform())))
            self.down = self.create_parameter([f, d], dtype=dtype,
                                              attr=paddle.ParamAttr(
                                                  name="down",
                                                  initializer=init.Normal(
                                                      0.0, 0.02)))

        def forward(self, x):
            h = paddle.nn.functional.silu(paddle.matmul(x, self.gate))
            return paddle.matmul(h * paddle.matmul(x, self.up), self.down)

    return SwiGLU()


def _api_swiglu(torch, paddle, dev, smi):
    """(c) a user-written ``paddle.nn.Layer`` at Llama-2-7B's MLP width
    (4,096 -> 11,008 -> 4,096) in bf16: three AdamW steps on (2, 2,048,
    4,096) with a ``paddle.mean`` loss; its first forward's first
    ``SWIGLU_CPU_ROWS`` rows against an f32 CPU run of the same weights."""
    d, f = SWIGLU_WIDTH
    b, s = SWIGLU_SHAPE
    paddle.seed(SEED + 45)
    layer = _swiglu(paddle, d, f, "bfloat16")
    start = {k: v.detach().float().cpu() for k, v in
             layer.state_dict().items()}
    x = paddle.randn([b, s, d], dtype="bfloat16")
    target = paddle.randn([b, s, d], dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=layer.parameters())
    losses, walls, first = [], [], None
    for _ in range(SWIGLU_STEPS):
        t0 = time.perf_counter()
        out = layer(x)
        if first is None:
            first = out[0, :SWIGLU_CPU_ROWS].detach().float().cpu()
        loss = paddle.mean((out - target) * (out - target))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        walls.append(1e3 * (time.perf_counter() - t0))
    place = paddle.core.place
    saved = place._current
    paddle.set_device("cpu")
    try:
        cpu_layer = _swiglu(paddle, d, f, "float32")
        missing, unexpected = cpu_layer.set_state_dict(start)
        with paddle.no_grad():
            want = cpu_layer(x[0, :SWIGLU_CPU_ROWS].float().cpu())
    finally:
        place._current = saved
    err = _rel_l2(first, want)
    rec = {"phase": "tensor_api_swiglu", "gpu": smi, "width": [d, f, d],
           "shape": [b, s, d], "dtype": "bfloat16", "losses": losses,
           "step_ms": walls, "param_names": sorted(layer.state_dict()),
           "cpu_rows": SWIGLU_CPU_ROWS, "rel_l2_vs_cpu_f32": err,
           "bound": SWIGLU_BOUND}
    emit(rec)
    check(not missing and not unexpected,
          f"the CPU copy's state dict: missing {missing}, unexpected "
          f"{unexpected}")
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(err <= SWIGLU_BOUND, f"the bf16 layer's first rows are {err} "
          f"(relative L2) from the f32 CPU run, above {SWIGLU_BOUND}")
    del layer, opt


def tensor_api_phase(torch, dev, smi):
    """Phase 23: the Paddle tensor API tier. (a) the op sweep, (b)
    ResNet-50 through the public API against phase 20's direct path, (c)
    a user-written SwiGLU Layer at Llama-2-7B's width. Returns the
    launches of (b) and (c), counted from zero (the ``tensor_api``
    path: they reach no hand-written kernel)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import ops

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rec = _api_sweep(torch, paddle, dev)
    emit({**rec, "gpu": smi})
    check(not rec["failures"], f"the op sweep failed: {rec['failures']}")
    check(not rec["not_run"], f"ops the sweep did not run: {rec['not_run']}")
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    _api_resnet(torch, paddle, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    _api_swiglu(torch, paddle, dev, smi)
    launches = dict(ops.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "tensor_api_done", "wall_s": time.perf_counter() - t_phase,
          "launches": launches})
    return {"tensor_api": launches}


# ------------------------------------------------------------ phase 24
def _launched(ops):
    return {k: v for k, v in ops.LAUNCHES.items() if v}


def _event_timed(torch, fn, n):
    """(wall s of the first call, median CUDA-event ms of ``n`` more)."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return first, statistics.median(times) if times else None


def _static_llama(torch, dev, smi, tmp):
    """(a) Llama-2-7B's widths in bf16 at ``STATIC_LAYERS`` layers:
    to_static of the forward (zero graph breaks, K1 and K4 launched as
    the eager forward launches them, logits against eager and against
    the same compiled run under ``plain_versions()``), the backward
    through it (K6 and K7, gradients against eager's), then ``jit.save``
    with a dynamic (batch, length) spec, ``inference.Config`` and
    ``create_predictor``: the Predictor's logits against to_static's."""
    from paddle_tpu_torch import inference, jit, ops
    from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                      LlamaPretrainingCriterion)
    from paddle_tpu_torch.static import InputSpec

    layers = STATIC_LAYERS
    b, s = STATIC_IDS
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16", num_hidden_layers=layers)
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 40))
    crit = LlamaPretrainingCriterion(cfg)
    ids = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED + 41))
    want = {"rms_norm": 2 * layers + 1, "flash_attention": layers}
    want_bwd = {"rms_norm_bwd": 2 * layers + 1, "flash_attention_bwd": layers}

    with torch.no_grad():
        ops.reset_launches()
        eager = model(ids)
        eager_launches = _launched(ops)
        explain = torch._dynamo.explain(model.forward)(ids)
    check(eager_launches == want,
          f"the eager forward launched {eager_launches}, not {want}")
    check(explain.graph_break_count == 0 and explain.graph_count == 1,
          f"to_static of the Llama forward breaks its graph: "
          f"{explain.break_reasons}")
    t0 = time.perf_counter()
    jit.to_static(model)
    sf = model.forward
    with torch.no_grad():
        ops.reset_launches()
        first_s, steady_ms = _event_timed(torch, lambda: model(ids), 0)
        static_launches = _launched(ops)
        logits = model(ids)
        _, steady_ms = _event_timed(torch, lambda: model(ids), STATIC_TIMED)
        _, eager_ms = _event_timed(
            torch, lambda: sf._function(ids), STATIC_TIMED)
        with ops.plain_versions():
            ops.reset_launches()
            plain = model(ids)
            plain_launches = _launched(ops)
    check(sf.graph_breaks == [], f"to_static broke: {sf.graph_breaks}")
    check(static_launches == want,
          f"to_static's first forward launched {static_launches}, not {want}")
    check(plain_launches == {},
          f"to_static under plain_versions() launched {plain_launches}")
    err, ok, tol = close(torch, logits, eager, torch.bfloat16, True)
    rel = _rel_l2(logits, eager)
    plain_rel = _rel_l2(plain, logits)
    check(bool(torch.isfinite(logits).all()), "to_static logits not finite")
    check(ok or rel <= KERNEL_PATH_BOUND,
          f"to_static logits {err} (rel L2 {rel}) from eager's")
    check(plain_rel <= KERNEL_PATH_BOUND,
          f"to_static's kernel path {plain_rel} (rel L2) from its plain "
          "path")

    # the backward through the compiled forward, against eager's
    def grads(fn):
        model.zero_grad(set_to_none=True)
        loss = crit(fn(ids).float(), ids)
        loss.backward()
        return loss.detach(), {n: p.grad.detach().clone()
                               for n, p in model.named_parameters()}

    eager_loss, eager_grads = grads(sf._function)
    ops.reset_launches()
    t1 = time.perf_counter()
    static_loss, static_grads = grads(model)
    torch.cuda.synchronize()
    bwd_first_s = time.perf_counter() - t1
    bwd_launches = _launched(ops)
    train_counts = dict(ops.LAUNCHES)
    model.zero_grad(set_to_none=True)
    check(all(bwd_launches.get(k) == v for k, v in {**want, **want_bwd}
              .items()), f"to_static's train step launched {bwd_launches}")
    grad_rel = max(_rel_l2(static_grads[n], eager_grads[n])
                   for n in eager_grads)
    check(grad_rel <= KERNEL_PATH_BOUND,
          f"to_static's gradients {grad_rel} (rel L2) from eager's")
    del eager_grads, static_grads
    compile_s = time.perf_counter() - t0

    # jit.save -> Config -> create_predictor
    prefix = os.path.join(tmp, "llama")
    t2 = time.perf_counter()
    jit.save(model, prefix, input_spec=[InputSpec([None, None], "int64")])
    save_s = time.perf_counter() - t2
    t3 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(prefix + ".pdmodel",
                                                       prefix + ".pdiparams"))
    load_s = time.perf_counter() - t3
    ids_np = ids.cpu().numpy()
    ops.reset_launches()
    (pred_logits,) = pred.run([ids_np])
    pred_launches = _launched(ops)
    pred_counts = dict(ops.LAUNCHES)
    _, pred_ms = _event_timed(torch, lambda: pred.run([ids_np]), 2)
    pl = torch.from_numpy(pred_logits)
    p_err, p_ok, _ = close(torch, pl, logits.float().cpu(), torch.bfloat16,
                           True)
    p_rel = _rel_l2(pl, logits.cpu())
    eager_exact = float((pl - eager.float().cpu()).abs().max())
    check(pred_launches == want,
          f"the Predictor launched {pred_launches}, not {want}")
    check(p_ok or p_rel <= KERNEL_PATH_BOUND,
          f"the Predictor's logits {p_err} (rel L2 {p_rel}) from "
          "to_static's")
    # another shape through the same dynamic program
    ids2 = ids[:1, :s // 2].contiguous()
    (pl2,) = pred.run([ids2.cpu().numpy()])
    with torch.no_grad():
        e2 = sf._function(ids2).float().cpu()
    check(_rel_l2(torch.from_numpy(pl2), e2) <= KERNEL_PATH_BOUND,
          "the Predictor's second shape parts from eager")
    emit({"phase": "static_llama2_7b_width", "layers": layers, "ids": [b, s],
          "graph_breaks": explain.graph_break_count,
          "graphs": len(sf.graphs), "backend": "inductor",
          "compile_and_first_call_s": first_s,
          "steady_call_ms": steady_ms, "eager_call_ms": eager_ms,
          "train_step_first_call_s": bwd_first_s,
          "phase_compile_s": compile_s,
          "launches_forward": static_launches,
          "launches_train_step": bwd_launches,
          "logits_max_abs_err_vs_eager": err, "logits_close": ok,
          "logits_tol": tol, "logits_rel_l2_vs_eager": rel,
          "plain_rel_l2": plain_rel, "plain_launches": plain_launches,
          "loss": float(static_loss), "eager_loss": float(eager_loss),
          "grad_max_rel_l2": grad_rel, "save_s": save_s,
          "predictor_load_s": load_s, "predictor_ms": pred_ms,
          "predictor_launches": pred_launches,
          "predictor_max_abs_err_vs_static": p_err,
          "predictor_rel_l2_vs_static": p_rel,
          "predictor_max_abs_diff_vs_eager": eager_exact, "gpu": smi})
    del model, pred, sf
    return train_counts, pred_counts


def _static_resnet(torch, dev, smi, tmp):
    """(b) ResNet-50 at resnet50_eager's batch in f32, eval: ``jit.save``
    with a dynamic batch, a Predictor against the eager forward, and the
    C API's client compiled on the card: its output and its clone's
    (second thread) equal to the Python Predictor's at the client's
    precision flags (f32 tolerance; bit equality reported)."""
    from paddle_tpu_torch import inference, jit, ops
    from paddle_tpu_torch.inference import capi
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision.models import resnet50
    import numpy as np

    b, side, classes = RESNET_SHAPE
    model = resnet50(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 42))
    model.eval()
    x = torch.randn(b, 3, side, side, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED + 43))
    with torch.no_grad():
        eager = model(x)
    prefix = os.path.join(tmp, "resnet50")
    t0 = time.perf_counter()
    jit.save(model, prefix, input_spec=[InputSpec([None, 3, side, side],
                                                  "float32")])
    save_s = time.perf_counter() - t0
    pred = inference.create_predictor(inference.Config(prefix))
    x_np = x.cpu().numpy()
    ops.reset_launches()
    (out,) = pred.run([x_np])
    launches = dict(ops.LAUNCHES)
    _, pred_ms = _event_timed(torch, lambda: pred.run([x_np]), 2)
    err, ok, tol = close(torch, torch.from_numpy(out), eager.cpu(),
                         torch.float32)
    check(out.shape == (b, classes) and ok,
          f"the ResNet-50 Predictor {err} from the eager forward")
    t1 = time.perf_counter()
    exe = capi.build_client(os.path.join(tmp, "predict_client"))
    build_s = time.perf_counter() - t1
    x_np.tofile(os.path.join(tmp, "in.f32"))
    t2 = time.perf_counter()
    r = subprocess.run(
        [exe, prefix, os.path.join(tmp, "in.f32"),
         os.path.join(tmp, "out.f32"), "4", str(b), "3", str(side),
         str(side)], capture_output=True, text=True,
        env=capi.client_env(), timeout=600)
    client_s = time.perf_counter() - t2
    check(r.returncode == 0, f"the C client failed ({r.returncode}): "
          f"{r.stderr[-2000:]}")
    got = np.fromfile(os.path.join(tmp, "out.f32"), np.float32)
    got_clone = np.fromfile(os.path.join(tmp, "out.f32.clone"), np.float32)
    # the client's process runs at torch's default precision flags (cuDNN
    # may use TF32), this script with TF32 off: its Predictor is run
    # again at the defaults for the comparison
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        (out_default,) = pred.run([x_np])
    c_err, c_ok, _ = close(torch, torch.from_numpy(got.reshape(out.shape)),
                           torch.from_numpy(out_default), torch.float32)
    cl_err, cl_ok, _ = close(torch, torch.from_numpy(
        got_clone.reshape(out.shape)), torch.from_numpy(out_default),
        torch.float32)
    c_equal = bool(np.array_equal(got.reshape(out.shape), out_default))
    check(c_ok and cl_ok,
          f"the C client's outputs part from the Predictor's: {c_err}, "
          f"clone {cl_err}")
    emit({"phase": "static_resnet50", "batch": b, "side": side,
          "save_s": save_s, "predictor_ms": pred_ms,
          "predictor_max_abs_err_vs_eager": err, "tol": tol,
          "launches": {k: v for k, v in launches.items() if v},
          "c_api_build_s": build_s,
          "c_client_wall_s": client_s,
          "c_client_stdout": r.stdout.strip().splitlines()[-1:],
          "c_client_max_abs_diff": c_err, "c_clone_max_abs_diff": cl_err,
          "c_client_bit_equal": c_equal,
          "c_client_vs_tf32_off_max_abs_diff": float(np.abs(
              got.reshape(out.shape) - out).max()), "gpu": smi})
    return launches


def static_phase(torch, dev, smi):
    """Phase 24: the static and deployment tier. (a) ``to_static``,
    ``jit.save`` and a Predictor at Llama-2-7B's widths, (b) ResNet-50
    through ``jit.save``, a Predictor and the C API. Returns the
    launches of (a)'s to_static train step and Predictor run and of
    (b)'s Predictor run, each counted from zero."""
    import tempfile

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        train, pred = _static_llama(torch, dev, smi, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        resnet = _static_resnet(torch, dev, smi, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    from torch._inductor import async_compile

    async_compile.shutdown_compile_workers()
    emit({"phase": "static_done", "wall_s": time.perf_counter() - t_phase})
    return {"static_train": train, "static_predictor": pred,
            "static_resnet": resnet}


# ------------------------------------------------------------ phase 25
def _dispatched(torch, fn):
    """Calls of the port's custom ops that went through the dispatcher
    while ``fn`` ran (the profiler's op events named
    ``paddle_tpu_torch::...``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.name.startswith("paddle_tpu_torch::"))


def _graph_check(torch, ops, name, fn, args, want):
    """``torch._dynamo.explain`` (no break, one graph), then ``to_static``
    of ``fn``: its launches against ``want`` (as eager's), its outputs
    against eager's (phase 2's bf16 bound, or ``KERNEL_PATH_BOUND``
    relative L2) and against the same compiled function under
    ``plain_versions()`` (no launch, within ``KERNEL_PATH_BOUND``).
    ``args`` is a list of argument tuples, run in turn. Returns the
    compiled calls' launch counts and the record."""
    from paddle_tpu_torch import jit

    with torch.no_grad():
        explain = torch._dynamo.explain(fn)(*args[0])
        ops.reset_launches()
        eager = [fn(*a) for a in args]
        eager_launches = _launched(ops)
        sf = jit.to_static(fn)
        ops.reset_launches()
        t0 = time.perf_counter()
        outs = [sf(*a) for a in args]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = _launched(ops)
        counts = dict(ops.LAUNCHES)
        _, static_ms = _event_timed(torch, lambda: sf(*args[-1]),
                                    STATIC_TIMED)
        _, eager_ms = _event_timed(torch, lambda: fn(*args[-1]),
                                   STATIC_TIMED)
        with ops.plain_versions():
            ops.reset_launches()
            plain = [sf(*a) for a in args]
            plain_launches = _launched(ops)
    check(explain.graph_break_count == 0 and explain.graph_count == 1,
          f"{name}: to_static breaks its graph: {explain.break_reasons}")
    check(sf.graph_breaks == [], f"{name}: {sf.graph_breaks}")
    check(eager_launches == want and launches == want,
          f"{name}: launches eager {eager_launches}, to_static "
          f"{launches}, not {want}")
    check(plain_launches == {},
          f"{name}: plain_versions() launched {plain_launches}")
    errs, rels, plain_rels = [], [], []
    for o, e, p in zip(outs, eager, plain):
        err, ok, tol = close(torch, o, e, torch.bfloat16, True)
        rel, prel = _rel_l2(o, e), _rel_l2(p, o)
        check(bool(torch.isfinite(o).all()), f"{name}: not finite")
        check(ok or rel <= KERNEL_PATH_BOUND,
              f"{name}: to_static {err} (rel L2 {rel}) from eager")
        check(prel <= KERNEL_PATH_BOUND,
              f"{name}: the kernel path {prel} (rel L2) from the plain")
        errs.append(err)
        rels.append(rel)
        plain_rels.append(prel)
    return counts, {
        "graph_breaks": explain.graph_break_count,
        "graphs": len(sf.graphs), "launches": launches,
        "compile_and_first_calls_s": first_s, "static_ms": static_ms,
        "eager_ms": eager_ms, "max_abs_err_vs_eager": errs,
        "rel_l2_vs_eager": rels, "plain_rel_l2": plain_rels,
        "plain_launches": plain_launches, "bound": tol}


def _decode_step_layer(torch, model, caches):
    """The Llama's contiguous-cache decode step as a Layer whose caches
    are buffers: ``forward(tok, pos)`` writes the token's K/V at ``pos``
    in place and returns the logits (jit.save exports the writes as
    mutated inputs)."""
    class DecodeStep(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model
            for i, (k, v) in enumerate(caches):
                self.register_buffer(f"k{i}", k)
                self.register_buffer(f"v{i}", v)
            self.n = len(caches)

        def forward(self, tok, pos):
            pairs = [(getattr(self, f"k{i}"), getattr(self, f"v{i}"))
                     for i in range(self.n)]
            return self.model(tok, pos, pairs)[0]

    return DecodeStep()


def _manifest_decode(torch, dev, smi, tmp):
    """(a) K5 and K2 in graphs at Llama-2-7B's widths, bf16, at
    ``STATIC_LAYERS`` layers: to_static of the contiguous decode step
    (K5) at each position of ``MANIFEST_DECODE``, then its jit.save and
    Predictor; to_static of the serving engine's paged decode math (K2)
    over phase 3's pool, float and w8kv8 (K2's per-row int8 mode); no
    eager or captured call of the engine through the dispatcher. Returns
    the launches of each compiled path."""
    from paddle_tpu_torch import create_serving_engine, inference, jit, ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving.engine import paged_decode_math
    from paddle_tpu_torch.static import InputSpec
    import numpy as np

    layers = STATIC_LAYERS
    rows, cache_len, positions = MANIFEST_DECODE
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16", num_hidden_layers=layers)
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    model = LlamaForCausalLM(cfg, generator=g)
    paths, records = {}, {}

    # K5: the contiguous-cache decode step
    caches = model.init_caches(rows, cache_len)
    for kc, vc in caches:
        kc.copy_(torch.randn(kc.shape, generator=g, device=dev))
        vc.copy_(torch.randn(vc.shape, generator=g, device=dev))
    tok = torch.randint(0, cfg.vocab_size, (rows, 1), device=dev,
                        generator=g)
    pos_t = [torch.tensor(p, dtype=torch.int32, device=dev)
             for p in positions]

    def k5_step(tok, pos):
        return model(tok, pos, caches)[0]

    want = {"rms_norm": (2 * layers + 1) * len(positions),
            "decode_attention": layers * len(positions)}
    counts, rec = _graph_check(torch, ops, "k5_step", k5_step,
                               [(tok, p) for p in pos_t], want)
    paths["manifest_k5_step"] = counts
    records["k5_step"] = rec
    with torch.no_grad():
        eager_direct = _dispatched(torch, lambda: k5_step(tok, pos_t[-1]))
    # jit.save -> Predictor of the step; the saved caches are this state
    layer = _decode_step_layer(torch, model, caches)
    prefix = os.path.join(tmp, "k5_step")
    t0 = time.perf_counter()
    jit.save(layer, prefix, input_spec=[InputSpec([rows, 1], "int64"),
                                        InputSpec([], "int32")])
    save_s = time.perf_counter() - t0
    pred = inference.create_predictor(inference.Config(prefix))
    with torch.no_grad():
        eager = layer(tok, pos_t[-1]).float().cpu()
    ops.reset_launches()
    (got,) = pred.run([tok.cpu().numpy(), np.asarray(positions[-1],
                                                     np.int32)])
    pred_launches = _launched(ops)
    paths["manifest_k5_predictor"] = dict(ops.LAUNCHES)
    _, pred_ms = _event_timed(torch, lambda: pred.run(
        [tok.cpu().numpy(), np.asarray(positions[-1], np.int32)]), 2)
    got = torch.from_numpy(got)
    p_err, p_ok, _ = close(torch, got, eager, torch.bfloat16, True)
    check(pred_launches == {"rms_norm": 2 * layers + 1,
                            "decode_attention": layers},
          f"the K5 Predictor launched {pred_launches}")
    check(p_ok, f"the K5 Predictor's logits {p_err} from eager's")
    records["k5_predictor"] = {
        "save_s": save_s, "predictor_ms": pred_ms,
        "launches": pred_launches, "max_abs_err_vs_eager": p_err,
        "bit_equal": bool(torch.equal(got, eager))}
    del pred, layer, caches
    gc.collect()
    torch.cuda.empty_cache()

    # K2: the serving engine's paged decode math, float and w8kv8
    lo, hi = MANIFEST_PAGED_LENS
    for arm, kw, kernel in (
            ("float", {}, "paged_decode_attention"),
            ("w8kv8", dict(INT8_ARMS)["w8kv8"],
             "paged_decode_attention_int8_rows")):
        if arm == "w8kv8":  # the w8 engine sweeps its model in place
            del model
            gc.collect()
            torch.cuda.empty_cache()
            model = LlamaForCausalLM(cfg, generator=torch.Generator(
                device=dev).manual_seed(SEED + 50))
        engine = create_serving_engine(model, **serve_kw(**kw))
        pool = engine.pool
        # eager and captured quanta of the engine: no op call through the
        # dispatcher (the captured replay runs no Python at all)
        for r in make_requests(cfg.vocab_size)[:rows]:
            engine.submit(**dict(r, max_new_tokens=32))
        while engine.scheduler.prefilling() or \
                not engine.scheduler.decoding():
            engine.step()
        engine.step()

        def quantum():
            pending = engine.step_dispatch()
            check(pending is not None, f"{arm}: no decode dispatch")
            engine.step_collect(pending)

        captured = _dispatched(torch, quantum)
        check(engine._graph is not None, f"{arm}: no captured quantum")
        engine._eager = True
        eager_quantum = _dispatched(torch, quantum)
        check(captured == 0 and eager_quantum == 0 and eager_direct == 0,
              f"{arm}: calls through the dispatcher: captured {captured}, "
              f"eager quantum {eager_quantum}, eager K5 {eager_direct}")
        scratch = engine._scratch_block
        bs = pool.block_size
        width = -(-(hi + 1) // bs)
        free = [b for b in range(pool.num_blocks) if b != scratch]
        check(len(free) >= rows * width, f"{arm}: the pool is too small")
        tables = torch.tensor(free[:rows * width], dtype=torch.int32,
                              device=dev).reshape(rows, width)
        gen = torch.Generator(device=dev).manual_seed(SEED + 51)
        for p in pool.k_pools + pool.v_pools:
            if p.dtype == torch.int8:
                p.copy_(torch.randint(-127, 128, p.shape, generator=gen,
                                      device=dev, dtype=torch.int8))
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev))
        for sc in pool.k_scales + pool.v_scales:
            sc.copy_(torch.rand(sc.shape, generator=gen, device=dev) / 64)
        lens = torch.randint(lo, hi, (rows,), generator=gen, device=dev,
                             dtype=torch.int32)
        live = torch.ones(rows, dtype=torch.bool, device=dev)
        live[-1] = False  # a finished row writes the scratch block
        ids = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                            device=dev)

        def k2_step(ids, lens, tables, live):
            return paged_decode_math(
                engine.model, scratch, ids, lens, tables, pool.k_pools,
                pool.v_pools, live, pool.k_scales, pool.v_scales,
                engine.attn_impl)

        counts, rec = _graph_check(
            torch, ops, f"k2_{arm}", k2_step, [(ids, lens, tables, live)],
            {"rms_norm": 2 * layers + 1, kernel: layers})
        paths[f"manifest_k2_{arm}"] = counts
        records[f"k2_{arm}"] = dict(rec, lens=lens.tolist(),
                                    dispatcher_calls={
                                        "captured_quantum": captured,
                                        "eager_quantum": eager_quantum})
        del engine, pool
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    q13 = QUANTUM_RECORD.get("greedy", {}).get("captured", {})
    emit({"phase": "manifest_decode_graphs", "layers": layers,
          "rows": rows, "cache_len": cache_len, "positions": positions,
          "paged_lens": [lo, hi], **records,
          "eager_k5_dispatcher_calls": eager_direct,
          "phase13_captured_quantum_wall_ms": q13.get("wall_ms"),
          "recorded_captured_quantum_wall_ms": list(RECORDED_QUANTUM_MS),
          "gpu": smi})
    return paths


def _manifest_qkvpacked(torch, dev, smi):
    """(b) ``flash_attn_qkvpacked`` at phase 7's attention shape, causal,
    bf16: forward and backward launch K4 and K7 once each, held against
    the same calls under ``plain_versions()`` at phase 2's bounds."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nn.functional.flash_attention import \
        flash_attn_qkvpacked

    b, s, h, d = QKVPACKED_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED + 52)
    qkv0 = torch.randn(b, s, 3, h, d, generator=g, device=dev).to(
        torch.bfloat16)
    do = torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)

    def run():
        qkv = qkv0.clone().requires_grad_()
        out = flash_attn_qkvpacked(qkv, causal=True)[0]
        out.backward(do)
        return out.detach(), qkv.grad

    ops.reset_launches()
    out, grad = run()
    launches = _launched(ops)
    counts = dict(ops.LAUNCHES)
    check(launches == {"flash_attention": 1, "flash_attention_bwd": 1},
          f"flash_attn_qkvpacked launched {launches}")
    _, ms = _event_timed(torch, run, 3)
    with ops.plain_versions():
        p_out, p_grad = run()
        _, plain_ms = _event_timed(torch, run, 1)
    err, ok, tol = close(torch, out, p_out, torch.bfloat16, True)
    g_err, g_ok, _ = close(torch, grad, p_grad, torch.bfloat16, True)
    check(ok and g_ok, f"flash_attn_qkvpacked {err} / grad {g_err} from "
          "its plain path")
    emit({"phase": "manifest_qkvpacked", "shape": [b, s, 3, h, d],
          "causal": True, "launches": launches, "fwd_bwd_ms": ms,
          "plain_fwd_bwd_ms": plain_ms, "max_abs_err": err,
          "grad_max_abs_err": g_err, "tol": tol, "gpu": smi})
    return counts


def _rel_max(torch, a, b):
    """max |a - b| / max |b| (f32; complex by magnitude)."""
    a, b = a.detach(), b.detach()
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return float((a.float().cpu() - b.float().cpu()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30).cpu())


def _ptb_model(torch, nn):
    layers, hidden, vocab, _, _, p = PTB_LARGE

    class PTBLarge(nn.Layer):
        """Embedding -> dropout -> LSTM (dropout between layers) ->
        dropout -> Linear: the non-recurrent connections dropped, as
        in the paper."""

        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, hidden)
            self.drop = nn.Dropout(p)
            self.lstm = nn.LSTM(hidden, hidden, num_layers=layers,
                                dropout=p)
            self.head = nn.Linear(hidden, vocab)

        def forward(self, ids):
            out, _ = self.lstm(self.drop(self.embed(ids)))
            return self.head(self.drop(out))

    return PTBLarge()


def _manifest_rnn(torch, dev, smi):
    """(c) The RNN family at the large PTB LSTM's width, f32: AdamW train
    steps of Embedding -> LSTM -> Linear held against the port's CPU run
    of the same weights (dropout off, so both draw nothing), timed steps
    with the paper's dropout; a bidirectional 2-layer GRU and a
    SimpleRNN forward against the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    layers, hidden, vocab, steps, batch, p = PTB_LARGE
    held, timed = PTB_STEPS
    torch.manual_seed(SEED + 53)
    model = _ptb_model(torch, nn).to(dev)
    cpu_model = copy.deepcopy(model).to("cpu")
    g = torch.Generator(device=dev).manual_seed(SEED + 54)
    data = torch.randint(0, vocab, (held + timed, batch, steps + 1),
                         generator=g, device=dev)

    def train(m, n, offset, device):
        opt = AdamW(PTB_LR, parameters=m.parameters())
        losses, logits0 = [], None
        for i in range(n):
            seq = data[offset + i].to(device)
            logits = m(seq[:, :-1])
            if logits0 is None:
                logits0 = logits.detach()
            loss = F.cross_entropy(logits.reshape(-1, vocab),
                                   seq[:, 1:].reshape(-1))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.detach())
        return losses, logits0

    model.eval()
    cpu_model.eval()
    t0 = time.perf_counter()
    losses, logits0 = train(model, held, 0, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    place = paddle.get_device()
    paddle.set_device("cpu")
    try:
        t1 = time.perf_counter()
        cpu_losses, cpu_logits0 = train(cpu_model, held, 0, "cpu")
        cpu_s = time.perf_counter() - t1
    finally:
        paddle.set_device(place)
    loss_rel = [abs(float(a) - float(b)) / abs(float(b))
                for a, b in zip(losses, cpu_losses)]
    logits_rel = _rel_max(torch, logits0, cpu_logits0)
    check(max(loss_rel) <= MANIFEST_F32_BOUND
          and logits_rel <= MANIFEST_F32_BOUND,
          f"the PTB LSTM parts from its CPU run: losses {loss_rel}, "
          f"logits {logits_rel}")
    # the paper's dropout in training: timed steps (CUDA events)
    model.train()
    step_ms, train_losses = [], []
    opt = AdamW(PTB_LR, parameters=model.parameters())
    for i in range(timed):
        seq = data[held + i]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        loss = F.cross_entropy(model(seq[:, :-1]).reshape(-1, vocab),
                               seq[:, 1:].reshape(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        train_losses.append(float(loss.detach()))
    check(all(math.isfinite(v) for v in train_losses),
          f"the PTB LSTM's dropout steps: {train_losses}")
    del model, cpu_model, opt
    # a bidirectional 2-layer GRU and a SimpleRNN at the same width
    x = torch.randn(batch, steps, hidden, generator=g, device=dev)
    fwd = {}
    for name, make in (("gru_bidirect_2", lambda: nn.GRU(
            hidden, hidden, num_layers=2, direction="bidirect")),
                       ("simple_rnn", lambda: nn.SimpleRNN(hidden, hidden))):
        torch.manual_seed(SEED + 55)
        m = make().to(dev)
        cpu_m = copy.deepcopy(m).to("cpu")
        with torch.no_grad():
            out, h = m(x)
            _, ms = _event_timed(torch, lambda: m(x), 3)
            cpu_out, cpu_h = cpu_m(x.cpu())
        err = max(_rel_max(torch, out, cpu_out), _rel_max(torch, h, cpu_h))
        check(err <= MANIFEST_F32_BOUND, f"{name} {err} from its CPU run")
        fwd[name] = {"forward_ms": ms, "rel_max_err_vs_cpu": err,
                     "final_states": list(h.shape)}
        del m, cpu_m
    emit({"phase": "manifest_rnn_ptb_large", "config": {
        "layers": layers, "hidden": hidden, "vocab": vocab,
        "steps": steps, "batch": batch, "dropout": p, "lr": PTB_LR},
        "held_losses": [float(v) for v in losses],
        "cpu_losses": [float(v) for v in cpu_losses],
        "loss_rel_err": loss_rel, "logits_rel_max_err": logits_rel,
        "held_steps_s": card_s, "cpu_steps_s": cpu_s,
        "train_step_ms": step_ms, "dropout_losses": train_losses,
        **fwd, "bound": MANIFEST_F32_BOUND, "gpu": smi})


def _manifest_signal(torch, dev, smi):
    """(d) ``signal.stft`` / ``istft`` at Whisper's front end and
    ``fft.rfft`` / ``fft2`` / ``irfftn`` on a field, each against the
    CPU run of the same input; the round trip back to the audio."""
    from paddle_tpu_torch import fft, signal

    b, n, n_fft, hop = WHISPER_AUDIO
    g = torch.Generator(device=dev).manual_seed(SEED + 56)
    x = 0.1 * torch.randn(b, n, generator=g, device=dev)
    win = torch.hann_window(n_fft, device=dev)

    def stft(v, w):
        return signal.stft(v, n_fft, hop, window=w)

    def istft(spec, w):
        return signal.istft(spec, n_fft, hop, window=w, length=n)

    spec = stft(x, win)
    back = istft(spec, win)
    _, stft_ms = _event_timed(torch, lambda: stft(x, win), 3)
    _, istft_ms = _event_timed(torch, lambda: istft(spec, win), 3)
    cpu_spec = stft(x.cpu(), win.cpu())
    cpu_back = istft(cpu_spec, win.cpu())
    errs = {"stft": _rel_max(torch, spec, cpu_spec),
            "istft": _rel_max(torch, back, cpu_back),
            "round_trip": _rel_max(torch, back, x)}
    field = torch.randn(*FFT_FIELD, generator=g, device=dev)
    cpu_field = field.cpu()
    ms = {}
    for name, fn in (("rfft", fft.rfft), ("fft2", fft.fft2),
                     ("irfftn", lambda v: fft.irfftn(fft.rfftn(v)))):
        errs[name] = _rel_max(torch, fn(field), fn(cpu_field))
        _, ms[name] = _event_timed(torch, lambda: fn(field), 3)
    check(all(e <= MANIFEST_F32_BOUND for e in errs.values()),
          f"signal / fft from their CPU runs: {errs}")
    emit({"phase": "manifest_signal_fft", "audio": [b, n],
          "n_fft": n_fft, "hop": hop, "spectrum": list(spec.shape),
          "field": list(FFT_FIELD), "stft_ms": stft_ms,
          "istft_ms": istft_ms, "fft_ms": ms, "rel_max_err_vs_cpu": errs,
          "bound": MANIFEST_F32_BOUND, "gpu": smi})


def _manifest_grid_fold(torch, dev, smi):
    """(e) ``affine_grid`` + ``grid_sample`` (bilinear, zeros) at
    ResNet-50's input and ``unfold`` / ``fold`` with a 3 x 3 kernel,
    forward and backward, against the CPU run of the same inputs."""
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 57)
    n, c, hh, ww = GRID_SHAPE
    x0 = torch.randn(n, c, hh, ww, generator=g, device=dev)
    theta0 = (torch.tensor([[1.0, 0, 0], [0, 1, 0]], device=dev)
              + 0.1 * torch.randn(n, 2, 3, generator=g, device=dev))
    w_grid = torch.randn(n, c, hh, ww, generator=g, device=dev)
    fb, fc, fh, fw, k = FOLD_SHAPE
    y0 = torch.randn(fb, fc, fh, fw, generator=g, device=dev)
    w_fold = torch.randn(fb, fc, fh, fw, generator=g, device=dev)

    def grid(x0, theta0, w):
        x, theta = x0.clone().requires_grad_(), theta0.clone() \
            .requires_grad_()
        out = F.grid_sample(x, F.affine_grid(theta, list(x.shape),
                                             align_corners=False),
                            mode="bilinear", padding_mode="zeros",
                            align_corners=False)
        (out * w).sum().backward()
        return out.detach(), x.grad, theta.grad

    def fold(y0, w):
        y = y0.clone().requires_grad_()
        cols = F.unfold(y, k, paddings=k // 2)
        out = F.fold(cols, [fh, fw], k, paddings=k // 2)
        (out * w).sum().backward()
        return cols.detach(), out.detach(), y.grad

    errs, ms = {}, {}
    for name, fn, args in (("grid", grid, (x0, theta0, w_grid)),
                           ("fold", fold, (y0, w_fold))):
        card = fn(*args)
        _, ms[name] = _event_timed(torch, lambda: fn(*args), 3)
        cpu = fn(*(a.cpu() for a in args))
        errs[name] = [_rel_max(torch, a, b) for a, b in zip(card, cpu)]
    check(all(e <= MANIFEST_F32_BOUND for v in errs.values() for e in v),
          f"grid / fold from their CPU runs: {errs}")
    emit({"phase": "manifest_grid_fold", "grid_input": list(GRID_SHAPE),
          "fold_input": [fb, fc, fh, fw], "kernel": k,
          "fwd_bwd_ms": ms, "rel_max_err_vs_cpu": errs,
          "bound": MANIFEST_F32_BOUND, "gpu": smi})


def _manifest_sparse(torch, dev, smi):
    """(f) ``sparse.matmul`` of a COO matrix at ``SPARSE_SHAPE``'s
    density by a dense matrix, forward and backward (to the values and
    the dense operand), against ``to_dense()`` followed by a product."""
    from paddle_tpu_torch import sparse

    m, k, density, n = SPARSE_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED + 58)
    nnz = int(m * k * density)
    flat = torch.randperm(m * k, generator=g, device=dev)[:nnz]
    idx = torch.stack([flat // k, flat % k])
    vals0 = torch.randn(nnz, generator=g, device=dev)
    y0 = torch.randn(k, n, generator=g, device=dev)
    w = torch.randn(m, n, generator=g, device=dev)

    def run(dense):
        vals, y = vals0.clone().requires_grad_(), y0.clone() \
            .requires_grad_()
        sp = sparse.sparse_coo_tensor(idx, vals, (m, k))
        out = sp.to_dense() @ y if dense else sparse.matmul(sp, y)
        (out * w).sum().backward()
        return out.detach(), vals.grad, y.grad

    got, want = run(False), run(True)
    errs = [_rel_max(torch, a, b) for a, b in zip(got, want)]
    check(max(errs) <= MANIFEST_F32_BOUND,
          f"sparse.matmul from to_dense() @ y: {errs}")
    _, ms = _event_timed(torch, lambda: run(False), 3)
    _, dense_ms = _event_timed(torch, lambda: run(True), 3)
    emit({"phase": "manifest_sparse", "shape": [m, k, n], "nnz": nnz,
          "fwd_bwd_ms": ms, "to_dense_fwd_bwd_ms": dense_ms,
          "rel_max_err_vs_dense": errs, "bound": MANIFEST_F32_BOUND,
          "gpu": smi})


def manifest_phase(torch, dev, smi):
    """Phase 25: the manifest tier. (a) K2 and K5 in to_static graphs
    and a jit.save Predictor, (b) ``flash_attn_qkvpacked``, (c) the RNN
    family at the large PTB LSTM's width, (d) ``signal`` and ``fft`` at
    Whisper's front end, (e) the grid ops and ``unfold`` / ``fold``, (f)
    ``sparse.matmul``. Returns the launches of each compiled or
    kernel-reaching path, each counted from zero."""
    import tempfile

    t_phase = time.perf_counter()
    walls = {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.perf_counter()
        paths = _manifest_decode(torch, dev, smi, tmp)
        walls["decode"] = time.perf_counter() - t0
    for name, part in (("qkvpacked", _manifest_qkvpacked),
                       ("rnn", _manifest_rnn), ("signal", _manifest_signal),
                       ("grid_fold", _manifest_grid_fold),
                       ("sparse", _manifest_sparse)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts = part(torch, dev, smi)
        walls[name] = time.perf_counter() - t0
        if counts is not None:
            paths[f"manifest_{name}"] = counts
    gc.collect()
    torch.cuda.empty_cache()
    from torch._inductor import async_compile

    async_compile.shutdown_compile_workers()
    emit({"phase": "manifest_done", "walls_s": walls,
          "wall_s": time.perf_counter() - t_phase})
    return paths


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if "--fleet-worker" in sys.argv:
        return _fleet_worker(sys.argv[sys.argv.index("--fleet-worker") + 1])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    # full f32 products on the card (the f32 parity phase relies on it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = env_phase(torch)
    primary = kernel_phase(torch, dev)
    launches, prefix_launches = e2e_phase(torch, dev, smi)
    parity_phase(torch, dev)
    gen_launches = generate_phase(torch, dev, smi)
    generate_parity_phase(torch, dev)
    train_launches = train_phase(torch, dev)
    parity_launches = train_parity_phase(torch, dev)
    packed_launches = packed_train_phase(torch, dev)
    packed_parity_launches = packed_parity_phase(torch, dev)
    int8_launches = int8_serving_phase(torch, dev)
    batch_launches = int8_parity_phase(torch, dev)
    graphs_serving_phase(torch, dev, smi)
    lora_launches = lora_phase(torch, dev, smi)
    gpt_launches = gpt_phase(torch, dev, smi)
    vision_launches = vision_phase(torch, dev, smi)
    bert_launches = bert_phase(torch, dev, smi)
    fleet_launches = fleet_phase(torch, dev, smi)
    api_launches = tensor_api_phase(torch, dev, smi)
    static_launches = static_phase(torch, dev, smi)
    manifest_launches = manifest_phase(torch, dev, smi)
    paths = {"serving": launches, "generate": gen_launches,
             "train": train_launches, "train_f32_parity": parity_launches,
             "packed_train": packed_launches,
             "packed_f32_parity": packed_parity_launches,
             "int8_serving": int8_launches, **batch_launches,
             **prefix_launches, **lora_launches, **gpt_launches,
             **vision_launches, **bert_launches, "fleet": fleet_launches,
             **api_launches, **static_launches, **manifest_launches}
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        rec = primary[name]
        path = KERNEL_PATH.get(name) or (
            "serving" if name in SERVING_KERNELS else
            "train" if name in TRAIN_KERNELS else
            "packed_train" if name in PACKED_KERNELS else "generate")
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": paths[path][name],
            "launches_path": path,
            "launches_by_path": {k: v[name] for k, v in paths.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "event_ms": rec["event_ms"], "timers": rec["timers"],
            "dtype": rec["dtype"], "shape": rec["shape"],
            **({"library_call": rec["library_call"],
                "library_calls_ms": rec["library_calls_ms"]}
               if "library_call" in rec else {})})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
