#!/usr/bin/env python3
"""Drive horovod_tpu_torch's serving, training and vision paths on one
NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Card: the card's name and power limit, as ``nvidia-smi`` reports them.
2. Build: every kernel under ``horovod_tpu_torch/ops/csrc/``, one
   ``nvcc`` per source, all started together, with ptxas's registers
   and spill bytes of each kernel printed, and those of the
   register-tiled f32 K1 and G2 on a line of their own (a spill fails).
   Then the tensor-core check: ``cuobjdump -sass`` (from ``nvcc``'s toolkit) counts the
   ``HMMA``/``HGMMA`` instructions (and ``UTMALDG``, TMA loads) of every
   kernel function in the flash and grouped-product libraries; the bf16
   K1 kernel must have some, and the bf16 K2 and K3 kernels (D = 64 and
   128), G1's bf16 kernel in both its modes and G2's bf16 kernel HGMMA
   (wgmma), no HMMA, and TMA loads; the f32 K2, K3, G1 and G2 kernels
   none.
3. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes, each maximum error printed beside its
   tolerance: flash attention forward (K1) in bf16 and f32, head_dim 64
   and 128, causal, S from 8 to 2048; paged-attention decode (K4) over
   f32, bf16 and int8 pools with an edge table (partial last page, a
   slot at table capacity, a ``limit = 0`` slot, a page shared by two
   slots, limits on a split boundary and one past it, splits wholly
   past the limit, R = 1 and 8, and the speculative verify's R = 20 in
   f32, bf16 and int8 -> bf16), each case called twice and required
   to agree bit for bit; flash-attention backward (K2 dk/dv, K3 dq)
   through the autograd Function with a nonzero lse cotangent, bf16 and
   f32, head_dim 64 and 128, S 8, 100 and 2048, causal, full and shifted
   masks, MHA and GQA (G = 4), against the plain backward on the same
   forward.
   Edge shapes for K1-K3 in both dtypes: ragged S (1, 17, 63, 65,
   2047) and S = 100 against T = 300, unmasked, bottom-right causal
   (shift = S - T) and fully masked (shift = T - S); K1 also at the
   resume bucket, S = 2176 (``max_len``), B = 2, and at the suffix
   shapes of ``prefill_with_prefix`` (``SUFFIX_SHAPES``: S0 queries
   over T = p0 + S0 keys, shift = -p0), B = 2, H = 16, H_kv = 4; at the
   suffix shapes also with the shift read from device memory (the
   captured suffix prefills' mode), against the plain version and bit
   for bit against the by-value shift.  Then ``grouped_kernel``: G1,
   the dropless MoE dispatch's grouped product, forward and with W read
   transposed (the input's gradient, dx), and G2, the weights' gradient,
   in bf16 and f32 at the prefill's gate and down shapes (T = 4 x 2048,
   E = 8) with multinomial, skewed and empty-expert routings and T = 1,
   17 and 8191, each relative error (of the largest output) within f32
   1e-4 / bf16 2e-2; a row's bits the same inside two batch
   compositions, in both of G1's modes; their times beside
   ``torch._grouped_mm`` (bf16) or a per-expert cuBLAS loop (f32).
4. Serving at full width: the d1024/L8/H16/kv4 bf16 Transformer from
   ``init_params`` seed 0, 8 slots.  First the decode tick at 8 slots
   and depth 1000 (half the slots sampling), three ways, each with its
   host wall, device busy time, idle share, kernels a tick and tok/s:
   eager and synchronous (``decode_step_paged`` and the pick called
   directly, the tick without a graph), the CUDA graph synchronous
   (``overlap=False``), and the graph with the overlapped pipeline
   (the default); the sampler's own device time.  Then the captured
   tick against the eager one: 20 ticks of a live mix from a copy of
   the same state must give equal tokens, max logits, pool bytes and
   positions, with K4 launched once a layer a replay.  Then
   ``InferenceEngine`` + ``ServingServer``, warmed over every prompt
   bucket (``ENGINE_WARM_LENS``: each admission graph ``("full", bucket,
   k)`` and ``("sample", k)`` captured, the captures' count, seconds
   and the device memory reserved around the sweep printed): 8
   concurrent ``POST /generate`` requests, half greedy and half
   sampled with fixed seeds, whose prompts cover the buckets 8..2048.
   Every request must return
   its full token count, both kernels' launch counters must grow during
   the run, ``decode_compilations`` must read 1 before and after, and
   ``prefill_compilations`` and ``sample_compilations`` must not grow
   past the warmups over the prefix runs and the burst.
   Then durability in bf16: the same prompts on a pool of
   ``DURABLE_PAGES`` pages, below capacity parity, so that decode growth
   suspends requests, and a decode tick raising midway through the
   burst: every request returns its full count, with at least one
   preemption and one resume, one restart, an empty journal and one
   capture; then the graph check again on the restarted engine (its pool
   reset in place).
   Shared prefixes, on the same engine before its HTTP burst: a registered
   ``PREFIX_LEN``-token prefix (its last page partial) and eight
   requests, six sharers with suffixes of 16-512 tokens and a greedy
   and a sampled one whose prompt is the prefix, after a warmup of the
   prefix's suffix graphs (``PREFIX_SUFFIXES`` as the suffix lengths).
   Every request returns its full count; the only whole-prompt
   prefill is the prefix's (the
   sharers prefill their suffixes only, the prefix prompts nothing);
   ``kv_pages_shared`` is above 0 while they decode; after
   ``unregister_prefix`` the pool is whole; one capture.  Then the same
   prompts with nothing registered; both runs' tok/s, TTFT p50 and
   prefill tokens are printed with the card.  An admission profile:
   one group of two prompts at bucket 2048 and one at bucket 16, each
   admitted alone: host wall, device busy and kernel count
   (``torch.profiler``), and the time from ``_admit_batch``'s entry to
   the replay and to its first-token sync: the captured path, one
   prefill replay.  Then the SLO leg of ``benchmarks/serving.py`` (two
   waves of two long batch prompts and six short interactive
   ones; 4 slots, K = 2) on fresh engines driven by their own thread:
   ``slo`` (chunks of 32 tokens, priority classes) and ``fcfs``
   (whole-prompt prefill, one class), each warmed over the buckets its
   prompts and their resumes reach, each request its full count, one
   capture of the tick and none of admission past the warmup; per-class
   TTFT p50/p99, tok/s and preemptions printed.
   Then tracing (``tracing_full_width``), on one engine of the same
   configuration warmed over ``ENGINE_WARM_LENS`` with
   ``model_flops_per_token`` from ``obs.xprof``: the eight prompts,
   greedy, stepped with a request tracer and a span recorder on and one
   decode tick raising once each has a token (its live journal entries
   name the requests' span ids; each interrupted request's span gets
   ``engine_restart`` then ``resume``); ``Timeline.profile`` over
   ``TRACE_PROFILE_TICKS`` captured ticks at 8 slots, whose Chrome trace
   must name K4's split and combine kernels a launch each a layer a
   tick, merged by ``obs.merge`` with the host timeline into one file
   holding both; then four HTTP bursts of the eight greedy prompts
   (``TRACE_LEGS``: untraced, traced, traced, untraced; each queued in a
   fixed order with the engine held, so that every leg schedules alike),
   requests 0 and 1 carrying ``X-Trace-Id`` with ``X-Parent-Span`` and
   with ``X-Trace-Sampled``: tokens, ticks and host syncs a tick equal
   across the legs, no capture in any, K1 and K4 launched in each; in
   each traced leg one start and one finish record a request, a trace
   tree rooted at each request's span (request 0's under the given
   parent), request 1's tick detail kept and the others' dropped, each
   breakdown summing to its total within 1 ms; a ``/metrics`` scrape
   read by a strict parser, ``serving_achieved_flops_per_sec`` above 0
   and ``xla_compiles_total{fn="serving_decode"}`` up by the engine's
   decode captures; then ``TRACE_TRAIN_STEPS`` captured LM training
   steps inside ``obs.training_step`` with a timeline started: one
   ``train_step`` span a step, ``training_steps_total`` up by as many.
   Printed with the card: each leg's tok/s, median decode step, host
   syncs a tick, span lines and JSONL bytes a request.
   Then the serving fleet (``fleet_full_width``): the serving
   configuration's weights (``init_params`` seed 0) written by
   ``replica_main.dump_model``, ``FLEET_REPLICAS`` replica processes on
   the one card (each its own CUDA context, warmed over
   ``FLEET_WARM_LENS``, the buckets the prompts and their resumes reach)
   under ``ReplicaSupervisor`` (journals, span streams, logs) behind
   ``RouterServer`` with ``resume_lookup``; the replicas' seconds from
   spawn to routable, their ``warmup_reserved_bytes`` beside
   ``nvidia-smi``'s memory used.  Three legs, in bf16: the eight serving
   prompts concurrently (every reply 200 with its full count, both
   replicas answering; in each replica K1's and K4's counters grow, one
   tick capture, no admission capture after warmup; router tok/s and
   TTFT beside the serving phase's single-engine burst); the same burst
   with one replica SIGKILLed once every request has tokens (full
   counts, a ``resumed`` reply, ``router_resume_failovers_total`` >= 1,
   the slot respawned and back in rotation, ``GET /trace/<id>`` of a
   resumed request one tree with the killed attempt's unfinished span
   and the journal's resume edge; kill to last reply, kill to rejoin and
   the re-prefilled tokens printed); ``POST /rollout`` of
   ``FLEET_CANDIDATE`` under back-to-back bursts (the rollout ``done``,
   every replica at ``config_generation`` 1, no request dropped; its
   duration and steps printed).  A failed gate prints every replica
   log's tail.
5. Token identity: the same configuration in f32 (TF32 off for matmuls
   and cuDNN) against the per-request oracles, ``greedy_decode`` for the
   greedy requests and ``sample_decode`` at the request's seed for the
   sampled ones.  A mismatch is exempt only at or after a position where
   the oracle's top-2 margin is below ``NEAR_TIE``; every exemption is
   printed.  Then the same burst on the same engine through three
   faults, one after another (``F32_FAULTS``: a decode tick raising at
   depth 1, a fetch raising, non-finite logits): every request resumes
   and must equal the same oracles; at the end three restarts, an empty
   journal, ``healthy`` and one capture.  Printed with the card's name
   and power limit: each fault's seconds to the first clean tick after
   it, ``resume_wasted_tokens``, and each faulted burst's tok/s beside
   its clean counterpart's.  Each faulted burst is a main path of its
   own: K1 and K4 must launch during it.  Then, on the same engine, a
   registered prefix with three sharers and one request whose prompt is
   the prefix, and the ``slo`` leg in f32 through one ``prefill_chunk``
   fault at a chunk boundary (one restart, ``healthy`` at the end): the
   tokens of both against ``greedy_decode`` / ``sample_decode`` of the
   whole prompt, by the same near-tie rule.
   Speculative decoding in f32, on the same prompts: an engine with
   ``speculative=True`` for each draft source (``SPEC_DRAFTS``: n-gram
   prompt lookup, the target as its own draft, and a half-depth draft
   made of the target's first four layers, its embedding, final norm
   and head): its tokens must equal the plain engine's and the oracles'
   by the same near-tie rule, the self-draft's acceptance must reach
   0.9 with more than one token a tick, and one decode fault mid-burst
   must leave the tokens equal to the oracles (one restart, two
   captures, an empty journal).
   The f32 fleet (``fleet_identity_f32``, TF32 off in the replicas,
   PyTorch's default): two replicas serve the same prompts, half
   sampled, one SIGKILLed once every request has tokens; every reply,
   resumed ones included, equals the oracles by the same near-tie rule.
   Then an f32 engine in this process with ``autotune=True`` and
   ``FLEET_TUNER_WINDOW``-tick scoring windows serves bursts of them
   until its tuner has applied ``FLEET_TUNER_APPLIES`` settings: the
   tokens equal the oracles, and no graph is captured after warmup.
6. Speculative decoding at full width in bf16 (``spec_legs``): for each
   draft source a speculative engine against the plain one on the same
   8 prompts, interleaved repetitions, tok/s over full-occupancy steps
   (``benchmarks/serving.py``'s ``_ab_spec``), acceptance, tokens a
   tick, each graph's replays, the step's wall and device time
   (profiler); the n-gram leg on the random-init target is the losing
   case, where the adaptive control must disable the slots and fall back
   to the plain graph.  Then an HTTP burst through ``ServingServer``
   (half sampled, one opted out): full counts, ``decode_compilations``
   2 before and after, no admission capture past the warmup.  The
   repetitive leg (``spec_repetitive``, ``_ab_spec``'s): a target
   trained with ``spmd.make_train_step`` on the cyclic corpus, the
   n-gram draft against plain decode on cyclic prompts; its tokens must
   equal the plain engine's.  Then the slot-contiguous cache
   (``unpaged``, ``_ab_paged``'s protocol): the f32 ``paged=False``
   engine's tokens against the oracles and the paged engine's, also
   through a decode fault (one restart, one capture, the cache's
   tensors kept); the bf16 p25 step of the paged and the unpaged engine
   in turns, each tick's profile, the contiguous tick's graph against
   its eager body, and the most concurrent requests at 2 x max_len
   cache tokens; and ``paged_kernel_ab`` (``paged_decode_ab.py``'s
   protocol): the f32 gather engine's tokens against the oracles and
   K4's, no K4 launch, then K4 against the gathered pages over bf16 and
   int8 pools (p25 step, profile, the analytic attention bytes).
7. Collectives: a size-1 NCCL group, every collective of the port
   (each allreduce op with and without pre/postscale, compression,
   grouped Average and Adasum, allgather, broadcast, alltoall even and
   with splits, reducescatter, hierarchical allreduce and allgather,
   every ``*_async`` with ``poll`` and one ``synchronize``, sparse
   against dense, the object collectives, ``join``, ``masked_average``
   at active 0 and 1) on CUDA tensors in f32 and bf16: each result must
   equal its size-1 value exactly.  With the native runtime and without
   it, and once more after ``basics.init(axis_name="workers")``, the
   ``axis_name`` forms under the bound ``MeshSpec()`` mesh: every
   collective over ``dp``, ``tp``, ``(dp, tp)``, ``(tp, dp)`` and
   ``(dp, fsdp, tp)``, Adasum over an axis and a pair, ``masked_average``
   over an axis, exact, and JAX's texts where a tuple is refused; then
   ``TRAIN`` 3 eager steps through ``DistributedAdasumOptimizer(AdamW,
   axis_name="dp")`` and ``DistributedOptimizer(AdamW, axis_name="dp",
   sparse_keys=("embed",))``, each bit-equal to plain AdamW, K1-K3
   counted.
8. Model gradients: a 2-layer d1024 model's f32 loss and parameter
   gradients through the kernels against the plain attention path, and
   with remat ``full`` and ``dots`` against no remat (TF32 off).
9. Training at full width: a size-1 NCCL process group, then four legs
   of 10 data-parallel steps (``spmd.make_train_step`` +
   ``DistributedOptimizer(AdamW)``) of the d1024/L8/H16 MHA model with
   f32 master parameters and bf16 compute on one fixed batch of 8 x 2048
   tokens, from the same parameters: eager (the step's eager body),
   remat ``full``, remat ``dots`` and captured (two eager warm-up
   steps, one CUDA graph capture, replays).  Every loss must be finite,
   the last below the first; K1 must launch once a layer a step (twice
   under remat), K2 and K3 once, also under the graph; the remat and
   captured legs' losses must equal the eager leg's within 1e-3
   relative a step, and each remat leg's peak memory must be below the
   eager leg's.  Each leg prints its step time, tokens/s, MFU on useful
   FLOP, peak memory and launches, and one more step is profiled
   (device busy, idle share; its K3 must be the wgmma
   ``flash_bwd_dq_kernel_wgmma``).
   Then ``sequence_parallel``: the virtual ring (every rank's shards in
   this process, ``attention._virtual_ring``: the ring's own step body,
   the exchange a list rotation) at P = 4 over one 8192-token sequence
   (B = 1, H = 16, D = 64, H_kv 16 and 4, bf16 and f32): the causal
   ring, the non-causal ring and the zigzag ring (data permuted by
   ``zigzag_perm``), forward and backward, held to K1-K3 over the whole
   sequence and to the f32 plain version (relative to the largest
   value: f32 1e-4, bf16 2e-2), K1, K2 and K3 launched once a chunk call
   (16 a ring pass, 48 a zigzag pass, fully masked chunks included);
   each virtual rank's K1 + K2 + K3 device time (CUDA events around
   calls queued behind a sleep, ``queued_ms``) over its chunk calls,
   ring against zigzag, and the max over the mean; K1-K3
   at the chunk shape (S = T = 2048) for the diagonal, a wholly visible
   and a wholly masked shift beside their bounds, plain versions and
   SDPA on the same mask; ``TRAIN`` at sp = 1 (a size-1 NCCL group and
   ``make_mesh(MeshSpec())`` bound) with ``attention_impl`` ``ring``,
   ``ring_zigzag`` and ``ulysses``, 10 captured steps each, losses
   within 1e-3 relative of the captured flash leg's a step, K1-K3
   launched once a chunk call a layer a step; a ``ring`` config served
   through ``InferenceEngine`` (its prefill K1 over the whole prompt)
   giving the tokens of the same weights under ``flash``.
   Then ``gspmd``, GSPMD training at mesh size 1 on a size-1 NCCL group:
   ``TRAIN`` from one set of f32 master weights, three AdamW steps on
   the same batches through ``spmd.make_gspmd_train_step`` over
   ``make_mesh(MeshSpec())`` with ``param_specs`` / ``batch_specs``
   (DTensor parameters, K1-K3 under ``local_map``, captured) and through
   ``make_train_step``: losses within 1e-3 relative (bit-equality
   reported), every parameter within 2e-2 of its change over the steps,
   K1, K2 and K3 launched ``n_layers`` times a step each by the GSPMD
   leg; the pod checkpoint (``checkpoint.save`` of the DTensor
   parameters and AdamW state through ``torch.distributed.checkpoint``,
   timed, its bytes; ``restore`` into a zeroed template) whose next
   step's loss equals the uninterrupted one's bit for bit; then each
   step's wall, queued device time, tok/s and eager body's wall.
   Then ``pipeline``, pipeline and expert parallelism on one card
   (``pipeline_full_width``): ``TRAIN`` at B = 8 through the virtual
   pipeline (``parallel.pipeline._Stages.virtual``: every stage in this
   process, the exchange a list rotation) at P = 4 (2 layers a stage),
   M = 8: ``gpipe``, ``1f1b`` and ``interleaved`` (v = 2) in f32 against
   ``loss_fn``'s backward (the loss within ``PIPE_LOSS_TOL``, each
   gradient's largest difference within ``PIPE_GRAD_TOL`` of its largest
   value), then in bf16 each timed against the eager plain step (the
   same backward; wall, the host's enqueue, and the profiler's device
   busy time, profiled last), K1, K2 and K3 counted on each call against
   the schedule's count (1F1B replays every stage's forward); 1F1B's peak
   memory over its start at M = 4 and 16 with microbatches of one row
   (below 2 x and below GPipe's at 16); ``pipelined_value_and_grad``
   under 1F1B over the real exchange at pp = 1 on a size-1 NCCL group
   against ``loss_fn`` in f32; then ``MOE_TRAIN`` with ``moe_axis="ep"``
   bound to a size-1 group, bit-equal to ``moe_axis=None`` eager and
   through a captured ``make_train_step(mesh=, axis="ep")`` with
   ``DistributedOptimizer(axis_name="ep")``, and pipelined under 1F1B
   with the balance loss at M = 1 against ``loss_fn`` in f32.  The phase
   must end within ``PIPE_BUDGET_S``.
   Then ``launcher_elastic``, the launch and cluster layer: ``python -m
   horovod_tpu_torch.runner --check-build``, then one LM job of the same
   width and batch (``LAUNCH_WORKER``, written to a temporary directory:
   ``import horovod_tpu_torch as hvd; hvd.init()``, AdamW in
   ``DistributedOptimizer``, the captured step, the broadcast, LR
   warm-up, LR schedule and metric-average callbacks, an
   ``elastic.State`` under ``@hvd.elastic.run``, a durable commit
   through ``CheckpointManager`` every 4 steps, the batch a function of
   the step) run twice.  Leg 1, ``python -m horovod_tpu_torch.runner -np
   1``: exit 0, one capture and 8 replays though the rate changes under
   them, the rate read back after each step equal to the schedule's,
   K1-K3 launched 80 times each.  Leg 2, the port's ``ElasticDriver``
   in this process over ``localhost-a:1`` and ``localhost-b:1`` with
   ``min_np = max_np = 1``: the worker of epoch 0 kills itself
   (SIGKILL) after step 6; exit 0, ``epoch_sizes`` [1, 1], blacklist
   ``["localhost-a"]``, epoch 1 restoring step 4 and journaling steps
   5-10, and the final parameters equal to leg 1's bit for bit.
   Printed with the card: ``--check-build``, the parameters' checksum,
   the median step, the time from the kill to epoch 1's first step (by
   stage) and each commit's seconds and bytes.
10. Mixture of experts: ``moe_train`` (``benchmarks/moe_dispatch_ab.py``'s
   protocol, ``MOE_TRAIN``: at E = 8 switch-sort round-robined against
   switch-cumsum, dense dispatch and the dense MLP, at E = 2 against
   dense dispatch, each a captured ``make_train_step`` without remat,
   best of ``MOE_ROUNDS`` turns; tok/s and MFU with one expert a token,
   the dense dispatch's executed MFU beside it; the dropless dispatch
   trained too, against switch-sort in the same turns, with G1 six and
   G2 three launches a layer a step, its captured losses bit-identical
   to an eager leg's; sort and cumsum losses and one step's gradients
   bit-identical; the captured switch-sort losses bit-identical to an
   eager leg's, a remat ``dots`` eager leg within 1e-3; the aux term's
   wiring and ``expert_load``; at f32 and cf = E switch and dropless
   each equal to dense, outputs and gradients, within 1e-4;
   ``switch_moe`` over a size-1 NCCL group bit-identical to the local
   call); ``moe_prefill`` (four 2048-token
   prompts through ``prefill``, dropless against dense dispatch, round-
   robined); ``moe_serve_bf16`` (the serving configuration with 8
   experts of d_ff 2048, every graph captured at warmup: the decode
   tick's profile and the HTTP burst beside the dense serving phase;
   K1, K4 and G1 launched, nothing captured after warmup) and
   ``moe_serve_f32`` (the f32 burst's tokens against the oracles by the
   near-tie rule).
11. Vision (``vision_full_width``), no kernel of the port: full ResNet-50
   in f32 (batch 4, 224², TF32 off) on CUDA against the same model and
   weights on the CPU (logits, loss, every gradient, the batch
   statistics; the ``s2d`` stem one forward), each error beside its
   tolerance; then on a size-1 NCCL group the bf16 channels_last legs
   in ``horovod_tpu_torch.bench``'s protocol (10 warm-up batches, 10 ×
   10 timed, ``cudnn.benchmark`` on): batch 384 eager and captured (with
   the loader-fed A/B and a profiled step each), batch 64 eager,
   captured and captured with bf16 gradient reduction, each from
   ``init_variables`` seed 0 on one batch, with img/s, MFU from
   ``obs.xprof``'s FLOP count and peak memory; before them the first 10
   losses at batch 64 of the eager and captured step under
   ``cudnn.deterministic`` within 1e-3 relative; InceptionV3 (299², batch
   64, captured, 3 × 10 timed) and the MLP (20 loader-fed captured
   steps).  Every loss finite and the last below the first, one capture
   a captured leg with every later call a replay, MFU in (0, 1).
12. Times: each kernel at its path's shape (CUDA events around 10
   back-to-back calls, median of 20; also one call alone, which adds
   the host's launch cost; K4 and its yardstick, whose calls are
   shorter than their launching, by CUDA events around calls queued
   behind a sleep, ``queued_ms``) beside
   its bound, its achieved TFLOP/s (the bound's FLOP count over its
   time), its plain version and a PyTorch yardstick the port never
   calls, and K4's split grid; the serving run's decode tok/s, TTFT and
   per-tick time.  K1 also at the prefix phase's suffix shape, by value
   and with the shift read from device memory, SDPA with the same mask
   as a boolean ``attn_mask`` its yardstick.  K4 also at the verify's
   R = 20 (8 slots x 2176 positions; K4 at R = 4 timed beside it, SDPA
   over the gathered K/V at R = 20 its yardstick), its own entry in the
   kernels line with the verify launches of the speculative legs.
13. Tensor-parallel serving (``tp``, run after ``paged_kernel_ab``):
   one card has no peers and NCCL refuses two ranks on one device, so
   the sharded engine runs in its virtual form (every shard in this
   process, one after another).  K4 at R = 4 and 20 and K1 at a
   shard's heads (H_kv 2 and 1) against their plain versions; ``FULL``
   in f32 at tp = 1, 2 and 4 over 8 requests on 4 slots (prompts 5-700,
   half sampled), each request's tokens against ``greedy_decode`` /
   ``sample_decode`` by the near-tie rule and the tp > 1 tokens counted
   against tp = 1's, one decode capture an engine, K4 tp x layers a
   replay and K1 tp x layers a whole-prompt prefill replay; the real
   form (one shard, its collectives captured in the graphs, the step's
   broadcast) over a size-1 NCCL group, equal to tp = 1; bf16's first
   decode tick at tp = 2 and 4 within ``TP_BF16_TOL`` of tp = 1's
   logits; then K1 and K4 timed at the shard shapes.

Each phase's seconds are printed as it ends.

A ``report:`` line carries every measurement as JSON; the line before
last is a JSON object of the kernels (each one's launches summed over
the main paths' runs that launch it: the HTTP burst, the prefix run,
the two SLO legs, the speculative legs (the repetitive one too), the
unpaged and paged-kernel A/B runs, the tracing phase's four bursts, the fleet's clean burst in both replicas and its SIGKILL burst
in the survivor (read from each replica's ``/stats``), the four
training legs and the traced training steps, the MoE legs, prefill runs
and bursts, the sequence_parallel phase's virtual-ring passes, sp = 1
training legs and ring-config bursts, the gspmd phase's GSPMD leg, the
pipeline phase's schedules and MoE legs; K4's
verify calls at R = 20 in an entry of their own; G1's
over the dropless prefill runs, both MoE bursts and the dropless
training leg, G2's over that leg; K1's and K4's also over the tp
phase's churns).  Launches go to the dtype each run runs: the f32
kernels (K1-K4, G1 and G2 in f32, their own kernel functions) have
entries of their own, over the f32 serving phase's faulted burst, its
speculative and SLO legs, the f32 MoE burst and gate, the tp churns,
the virtual ring's f32 passes and the pipeline phase's f32 runs, each
timed at the bf16 entry's shape with its bound at the f32 rate and SDPA
(TF32 off, its backend named) or the cuBLAS loop beside it; the rest
are bf16 (K4: bf16 and int8 pools).  The f32 K1 is also timed at the
training and tp shard shapes, K1 and K4 at the tp shards in both
dtypes (f32 with the churns' launches, bf16 with the first tick's),
and G2 in f32 with every row on one expert.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores and HBM3 bandwidth; the bf16 tensor-core peak is read from
# horovod_tpu_torch.obs.xprof's table in main().
PEAK_FLOPS = {torch.float32: 67e12}
H100 = "NVIDIA H100 80GB HBM3"
PEAK_BYTES = 3.35e12
NEAR_TIE = 1e-3  # f32 top-2 logit margin under which the pick is a tie

FULL = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
            n_kv_heads=4, d_ff=4096, max_seq=2176, attention_impl="flash")
# benchmarks/transformer.py's defaults: MHA, seq 2048, batch 8 a card.
TRAIN = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
             n_kv_heads=0, d_ff=4096, max_seq=2048, attention_impl="flash")
TRAIN_BATCH, TRAIN_STEPS = 8, 10
ENGINE = dict(n_slots=8, max_len=2176, max_prefills_per_tick=2,
              page_size=16, max_queue_depth=64, default_max_new_tokens=128)
PROMPT_LENS = [5, 16, 40, 100, 300, 700, 1500, 2048]
# One prompt length in each prefill bucket of ENGINE, 8 to 2048 and 2176
# (max_len, which a resumed long prompt reaches): the serving, durability
# and f32 engines' warmup captures the whole-prompt graphs of all of them.
ENGINE_WARM_LENS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 2170]
NEW_TOKENS = [128, 64, 96, 128, 80, 112, 64, 128]
F32_NEW_TOKENS = 32
PROFILE_DEPTH = 1000  # every slot's prompt length in the profiled ticks
RESUME_S = ENGINE["max_len"]  # the prefill bucket of a resumed long prompt
# The f32 faults, one after another, each at the next visit of its site
# once the burst has emitted that many tokens in all: a decode tick
# raising at depth 1, a fetch raising, non-finite logits.
F32_FAULTS = [("decode_tick", "raise", 1), ("decode_fetch", "raise", 96),
              ("decode_tick", "nonfinite", 176)]
# The bf16 faulted burst's page pool, below capacity parity (8 x 136 =
# 1088 pages) so that decode growth runs out and preempts; it still holds
# the 8 prompts and the graph check's 20 positions beyond them.
DURABLE_PAGES = 320
# Each request's sampling, by its index: half greedy, half sampled with a
# fixed seed, every option of the sampler.
SAMPLING = [{}, dict(temperature=1.0, seed=1), {},
            dict(temperature=0.8, top_k=40, seed=2), {},
            dict(temperature=1.2, top_p=0.9, seed=3), {},
            dict(temperature=0.7, top_k=100, top_p=0.95, seed=4)]
# The shared-prefix phase: a registered prefix of PREFIX_LEN tokens (not a
# multiple of the page size 16, so its partial last page is copied on
# write), six sharers with suffixes of PREFIX_SUFFIXES tokens, then a
# greedy and a sampled request whose prompt is the prefix.
PREFIX_LEN = 1000
PREFIX_SUFFIXES = [16, 40, 100, 200, 300, 512]
PREFIX_NEW_TOKENS = 64
PREFIX_SAMPLING = SAMPLING[:6] + [{}, dict(temperature=0.9, top_k=50,
                                           seed=5)]
# The SLO leg of benchmarks/serving.py (_slo_mode): two waves 0.25 s
# apart, each two long batch prompts of 240-288 tokens, then six
# interactive prompts of 3-12 tokens 10 ms apart; 16 new tokens each;
# 4 slots, K = 2, chunks of 32 tokens.
SLO_LONG, SLO_CHUNK, SLO_NEW_TOKENS = 288, 32, 16
SLO_ENGINE = dict(n_slots=4, max_len=SLO_LONG + 2 * SLO_NEW_TOKENS + 32,
                  max_prefills_per_tick=2, page_size=16, max_queue_depth=64)
# The f32 SLO leg's fault: the prefill_chunk visit after this many more.
SLO_FAULT_SKIP = 5
# The speculative phase (EngineConfig's default spec_k = 4: W = 5, the
# verify's K4 at R = G * W = 20).  The bf16 legs, after benchmarks/
# serving.py's _ab_spec: 8 prompts of SPEC_PROMPT_LEN tokens, each leg's
# speculative engine against the plain one on them, SPEC_NEW_TOKENS
# tokens a request, SPEC_REPS measured repetitions after a warm one;
# tok/s over full-occupancy steps.  The f32 legs' decode fault fires once
# the burst has emitted SPEC_FAULT_AT tokens.
SPEC_K = 4
SPEC_PROMPT_LEN, SPEC_NEW_TOKENS, SPEC_REPS = 64, 128, 2
SPEC_FAULT_AT = 64
SPEC_DRAFTS = ("ngram", "self", "half")
# _ab_spec's repetitive leg (benchmarks/serving.py, at its defaults
# --steps 128 --iters 3): the target trained on Markov-1 cyclic sequences
# of period REP_PERIOD (batch REP_BATCH x REP_SEQ, the corpus drawn from
# seed 5), then the n-gram draft against the plain engine on 8 cyclic
# prompts of REP_PROMPT_LEN tokens, REP_NEW_TOKENS tokens a request,
# REP_REPS repetitions after a warm one.  _ab_spec trains 45 Adam steps at
# lr 1e-2, which diverge at this width; AdamW (REP_LR, weight decay 1e-4
# as the training legs') over REP_TRAIN_STEPS steps learns to continue
# the cycle.
REP_PERIOD, REP_BATCH, REP_SEQ, REP_LR = 8, 32, 48, 3e-4
REP_TRAIN_STEPS = 200
REP_PROMPT_LEN, REP_NEW_TOKENS, REP_REPS = 12, 256, 3
# _ab_paged (benchmarks/serving.py at --prompt-len 2048 --steps 128
# --iters 3): 8 copies of an AB_PROMPT_LEN-token prompt, AB_NEW_TOKENS
# tokens each, AB_REPS repetitions interleaved, each engine's
# full-occupancy ticks compared at their p25.  Its capacity leg: a budget
# of 2 x max_len cache tokens, 16 requests (PROMPT_LENS twice) of
# CAPACITY_NEW_TOKENS tokens.  benchmarks/paged_decode_ab.py's protocol
# (KERNEL_AB_REPS repetitions) on the same workload, over the model's
# bf16 pool and an int8 one.
AB_PROMPT_LEN, AB_NEW_TOKENS, AB_REPS = 1024, 128, 4
CAPACITY_NEW_TOKENS = 16
KERNEL_AB_REPS, KERNEL_AB_POOLS = 2, (None, "int8")

REPORT: dict = {"phase_s": {}}
SCRIPT_LIMIT_S = 900.0  # time budget for the whole script, in seconds


def log(msg: str) -> None:
    print(msg, flush=True)


class phase:
    """Times a phase into ``REPORT["phase_s"]`` and prints its seconds."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dt = time.monotonic() - self.t0
        REPORT["phase_s"][self.name] = dt
        log(f"phase {self.name}: {dt:.1f} s")


def time_ms(fn, reps: int = 20, warm: int = 3, batch: int = 10) -> float:
    """Median device time of one call, by CUDA events around ``batch``
    back-to-back calls (divided by ``batch``), so that the host's cost
    of launching a short kernel does not show as device time.  ``batch=1``
    times one call alone (the host's launch cost included), which is
    enough for calls that take many milliseconds."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def device_ms(fn, tag: str = "", reps: int = 20) -> float:
    """Device time of one call: ``torch.profiler``'s kernel time of
    ``reps`` calls (kernels whose name holds ``tag``), over ``reps``.
    For calls so short that back-to-back CUDA events time the host's
    launching instead."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # A profiler session on an H100 has come back with no device event
    # at all (once, for the SDPA yardstick beside K4, which other runs
    # profile fine): such a session is logged with what it did record
    # (the CPU-side runtime calls, such as cudaLaunchKernel, show
    # whether the launches were seen while their kernels' records were
    # not) and profiled again, twice at most.
    from torch.autograd import DeviceType

    name = getattr(fn, "__qualname__", repr(fn))
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        total = sum(e.self_device_time_total for e in events if tag in e.key)
        if total > 0:
            return total / 1e3 / reps
        if events:
            break
        host = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CUDA]
        log(f"device_ms: profiler session {attempt + 1} of 3 for {name} "
            f"(tag {tag!r}) recorded no device event and "
            f"{sum(e.count for e in host)} CPU-side events "
            f"{sorted({e.key for e in host})[:8]}; profiling again")
    raise AssertionError(f"the profiler saw no kernel matching {tag!r} "
                         f"for {name}")


def queued_ms(fn, n: int = 10, reps: int = 5) -> float:
    """Device time of one call with the host's launching hidden: ``n``
    calls queued behind ``torch.cuda._sleep`` (which holds the stream
    until the host has queued them all), between two CUDA events; the
    median of ``reps``.  For calls shorter than their launching, where
    back-to-back events time the host; and where ``torch.profiler``
    cannot be trusted: late in this script it has kept about one kernel
    record in five of a session (a chunk kernel's device time a fifth
    of the same call's in a fresh process).  Not for an eager step of
    thousands of launches: the launch queue fills behind the sleep and
    the host waits, so the calls never fit."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 24, []
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        if a.query():  # the sleep ended before the calls were queued
            b.synchronize()
            cycles *= 2
            continue
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


def tflops(flops: float, ms: float) -> float:
    """Achieved rate: the bound's FLOP count over the measured time."""
    return flops / (ms * 1e-3) / 1e12


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {out}")
    REPORT["card"] = out
    return out


def build() -> None:
    from horovod_tpu_torch.ops import _cuda

    t0 = time.monotonic()
    built = _cuda.build_all()
    dt = time.monotonic() - t0
    log(f"build: {sorted(built)} in {dt:.1f} s")
    REPORT["build_s"] = dt
    regs = {}
    for out in built.values():
        regs.update(_ptxas(out))
    for fn, r in sorted(regs.items()):
        log(f"ptxas: {fn}: {r}")
    REPORT["ptxas"] = regs


def _ptxas(out: str) -> dict:
    """ptxas's report (-Xptxas -v) in one nvcc's output: registers a
    thread and spill bytes of each kernel, which set how many CTAs an SM
    holds."""
    regs, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = _kernel_name(m.group(1))
            regs[fn] = {}
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            regs[fn]["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn]["registers"] = int(m.group(1))
    return regs


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_kernel_wgmma<bf16,64>``-style name of a mangled flash
    kernel, ``paged_attend_split_kernel<int8,bf16,R4,L8>`` or
    ``paged_attend_rows_kernel<bf16,64>`` of a paged one (other names are
    returned as they are)."""
    rows = re.search(r"\d+(paged_attend_rows_kernel)ILi(\d+)E", mangled)
    if rows:  # bf16 pools only; the template is the head-dim block
        return f"{rows.group(1)}<bf16,{rows.group(2)}>"
    paged = re.search(r"\d+(paged_attend_[a-z_]+?)(?:I(.*?)EEv|E)", mangled)
    if paged:
        kinds = {"13__nv_bfloat16": "bf16", "a": "int8", "f": "f32"}
        toks = re.findall(r"13__nv_bfloat16|S1_|Li\d+|a|f",
                          paged.group(2) or "")
        ints = iter(("R", "L"))  # query rows a CTA, lanes a position
        args = [kinds.get(t, kinds.get(toks[0])) if not t.startswith("Li")
                else next(ints) + t[2:] for t in toks]
        return paged.group(1) + (f"<{','.join(args)}>" if args else "")
    grouped = re.search(r"\d+(grouped_(?:mm|dw)_kernel(?:_wgmma)?)"
                        r"(?:ILi(\d)EE|E)", mangled)
    if grouped:
        name, mode = grouped.groups()
        if name == "grouped_dw_kernel_wgmma":  # G2 bf16: no template
            return f"{name}<bf16>"
        if name.endswith("_wgmma"):  # B_MN_MAJOR: 1 the forward, 0 dx
            return f"{name}<bf16,{'fwd' if mode == '1' else 'dx'}>"
        return f"{name}<f32{',dx' if mode == '1' else ''}>"
    name = re.search(r"\d+(flash_[a-z_]+?)I", mangled)
    dim = re.search(r"Li(\d+)E", mangled)
    if not (name and dim):
        return mangled
    dtype = "bf16" if "bfloat16" in mangled else "f32"
    return f"{name.group(1)}<{dtype},{dim.group(1)}>"


# The grouped kernels and the flash kernels (K1, K2, K3) by
# `_kernel_name`: bf16 on wgmma fed by TMA, and f32 on no tensor core at
# all; K4's rows kernel (bf16 pools, R > 8) on mma.sync fed by TMA.
GROUPED_WGMMA = ("grouped_mm_kernel_wgmma<bf16,fwd>",
                 "grouped_mm_kernel_wgmma<bf16,dx>",
                 "grouped_dw_kernel_wgmma<bf16>")
GROUPED_F32 = ("grouped_mm_kernel<f32>", "grouped_mm_kernel<f32,dx>",
               "grouped_dw_kernel<f32>")
FLASH_FWD_WGMMA = tuple(f"flash_fwd_kernel_wgmma<bf16,{d}>"
                        for d in (64, 128))
FLASH_FWD_F32 = tuple(f"flash_fwd_kernel<f32,{d}>" for d in (64, 128))
PAGED_ROWS = tuple(f"paged_attend_rows_kernel<bf16,{d}>" for d in (64, 128))
FLASH_BWD_WGMMA = tuple(f"flash_bwd_{k}_kernel_wgmma<bf16,{d}>"
                        for k in ("dkdv", "dq") for d in (64, 128))
FLASH_BWD_F32 = tuple(f"flash_bwd_{k}_kernel<f32,{d}>"
                      for k in ("dkdv", "dq") for d in (64, 128))


# The f32 kernels redesigned as register-tiled FFMA fed by cp.async.
FFMA_TILED = FLASH_FWD_F32 + FLASH_BWD_F32 + ("grouped_dw_kernel<f32>",)


def ptxas_check() -> dict:
    """ptxas's registers and spills of the register-tiled f32 kernels
    (:data:`FFMA_TILED`), from :func:`build`'s report: fails on a spill
    or a missing kernel."""
    regs = {fn: REPORT["ptxas"].get(fn) for fn in FFMA_TILED}
    log("register-tiled f32 kernels, ptxas: " + ", ".join(
        f"{fn} {r}" for fn, r in regs.items()))
    bad = {fn: r for fn, r in regs.items()
           if not r or r.get("spill_store_bytes", 0) or "registers" not in r}
    if bad:
        raise AssertionError(f"spills or no ptxas report: {bad}")
    return regs


def sass_check() -> dict:
    """Tensor-core instructions (``HMMA``, ``HGMMA``) in each kernel
    function of the flash, paged and grouped-product libraries, by
    ``cuobjdump -sass`` from the toolkit of the ``nvcc`` that built them,
    and TMA loads (``UTMALDG``).  Fails unless both bf16 instantiations
    (D = 64, 128) of K1, K2 and K3, G1's bf16 kernel in both modes and
    G2's bf16 kernel run on wgmma (HGMMA, no HMMA) fed by TMA, K4's rows
    kernel (both head-dim blocks) runs on mma.sync (HMMA) fed by TMA, and
    the f32 kernels of K1, K2, K3, G1 (both modes) and G2 have no
    tensor-core instruction at all (TF32 would break the f32
    contract)."""
    from horovod_tpu_torch.ops import _cuda

    tool = Path(_cuda._nvcc()).resolve().parent / "cuobjdump"
    counts, tma = {}, {}
    for lib in ("flash_fwd", "flash_bwd", "paged_attention",
                "grouped_matmul"):
        sass = subprocess.run(
            [str(tool), "-sass", str(_cuda.BUILD_DIR / f"lib{lib}.so")],
            capture_output=True, text=True, timeout=300, check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = _kernel_name(m.group(1))
                counts[fn], tma[fn] = {"HMMA": 0, "HGMMA": 0}, 0
            elif fn is not None:
                op = re.search(r"\b(HG?MMA)\b", line)
                if op:
                    counts[fn][op.group(1)] += 1
                tma[fn] += bool(re.search(r"\bUTMALDG\b", line))
    for fn, n in sorted(counts.items()):
        log(f"sass: {fn}: {n['HMMA']} HMMA, {n['HGMMA']} HGMMA, {tma[fn]} "
            f"UTMALDG")
    for fn in FLASH_FWD_WGMMA + FLASH_BWD_WGMMA + GROUPED_WGMMA:
        n = counts.get(fn, {})
        if not (n.get("HGMMA") and not n.get("HMMA") and tma.get(fn)):
            raise AssertionError(f"{fn}: expected HGMMA, no HMMA and TMA "
                                 f"loads, got {n}, {tma.get(fn)} UTMALDG "
                                 f"({sorted(counts)})")
    for fn in PAGED_ROWS:
        n = counts.get(fn, {})
        if not (n.get("HMMA") and tma.get(fn)):
            raise AssertionError(f"{fn}: expected HMMA and TMA loads, got "
                                 f"{n}, {tma.get(fn)} UTMALDG "
                                 f"({sorted(counts)})")
    for fn in FLASH_FWD_F32 + FLASH_BWD_F32 + GROUPED_F32:
        if fn not in counts or any(counts[fn].values()):
            raise AssertionError(f"{fn}: expected no tensor-core "
                                 f"instruction, got {counts.get(fn)} "
                                 f"({sorted(counts)})")
    return {"tensor_core": counts, "tma_loads": tma}


# --- phase 3: kernels against their plain versions ---------------------------


def _k1_inputs(B, H, Hkv, S, D, dtype, seed, T=None):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    T = S if T is None else T
    return r(B, H, S, D), r(B, Hkv, T, D), r(B, Hkv, T, D)


def _shift(mask: str, S: int, T: int):
    """The mask names of the checks as the kernels' shift: position (row,
    col) attends iff col + shift <= row; None is unmasked."""
    return {"causal": 0, "full": None, "shift": S // 3,
            "bottom_right": S - T, "none_visible": T - S}[mask]


# Edge shapes of K1-K3: ragged S, and S != T under each mask kind.
EDGE_S = (1, 17, 63, 65, 2047)
EDGE_T = (100, 300)  # (S, T)
EDGE_T_MASKS = ("full", "bottom_right", "none_visible")
# K1 as prefill_with_prefix calls it, (p0, S0): S0 suffix queries over
# T = p0 + S0 keys with shift = -p0 (the bottom-right causal mask) — the
# prefix phase's shape, a prefix on no page or key-block boundary, a
# tiny one, the chunk shape, and the last chunk of a 2048-token prompt.
SUFFIX_SHAPES = ((1024, 512), (1000, 256), (15, 16), (32, 32), (2016, 32))


def check_flash() -> dict:
    from horovod_tpu_torch.ops import attention as A

    worst = {}
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    dts = (torch.bfloat16, torch.float32)
    cases = [(dt, D, S, S, "causal") for dt in dts
             for D in (64, 128) for S in (8, 100, 2048)]
    cases += [(dt, 64, 256, 256, "full") for dt in dts]
    cases += [(dt, 64, S, S, "causal") for dt in dts for S in EDGE_S]
    cases += [(dt, D, *EDGE_T, m) for dt in dts for D in (64, 128)
              for m in EDGE_T_MASKS]
    # The resume bucket: a resumed 2048-token prompt plus its emitted
    # tokens prefills at max_len, 2176, which warmup never reaches.
    cases += [(dt, 64, RESUME_S, RESUME_S, "causal") for dt in dts]
    cases += [(dt, 64, S0, p0 + S0, "bottom_right") for dt in dts
              for p0, S0 in SUFFIX_SHAPES]
    for i, (dt, D, S, T, mask) in enumerate(cases):
        B, H, Hkv = 2, 16, 4
        shift = _shift(mask, S, T)
        q, k, v = _k1_inputs(B, H, Hkv, S, D, dt, seed=i, T=T)

        def k1():
            if shift is None:
                return A.flash_attention_with_lse(q, k, v, False)
            return A.flash_attention_shifted(q, k, v, shift)

        (o, lse), (o2, lse2) = k1(), k1()
        o_r, l_r = A._reference_attention_lse(
            q, A.expand_kv(k, H), A.expand_kv(v, H), shift,
            1.0 / math.sqrt(D))
        torch.cuda.synchronize()
        err = max((o.float() - o_r.float()).abs().max().item(),
                  (lse - l_r).abs().max().item())
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        name = f"K1 {str(dt)[6:]} D={D} S={S} T={T} {mask}"
        log(f"{name}: max_abs_err={err:.3e} tol={tol[dt]:.0e}, two calls "
            f"bit-identical: {same}")
        if not err <= tol[dt]:
            raise AssertionError(f"{name} disagrees with its plain version")
        if not same:
            raise AssertionError(f"{name}: two calls differ")
        if D == 64 and S == T == 2048:
            worst["serving" + _suffix(dt)] = err
        if dt == torch.bfloat16 and (T - S, S) == SUFFIX_SHAPES[0]:
            worst["suffix"] = err
        worst[name] = err
    # The device shift at the suffix shapes: the key buffer padded past
    # p0 + S0 with junk, as the captured suffix prefill's is.
    for i, (dt, (p0, S0)) in enumerate((dt, sh) for dt in dts
                                       for sh in SUFFIX_SHAPES):
        B, H, Hkv, D = 2, 16, 4, 64
        T = p0 + S0 + 64
        q, k, v = _k1_inputs(B, H, Hkv, S0, D, dt, seed=500 + i, T=T)
        shift = torch.tensor(-p0, dtype=torch.int32, device="cuda")
        o, lse = A.flash_attention_shifted(q, k, v, shift)
        o_v, lse_v = A.flash_attention_shifted(q, k, v, -p0)
        o_r, l_r = A._reference_attention_lse(
            q, A.expand_kv(k, H), A.expand_kv(v, H), -p0, 1.0 / math.sqrt(D))
        torch.cuda.synchronize()
        err = max((o.float() - o_r.float()).abs().max().item(),
                  (lse - l_r).abs().max().item())
        same = torch.equal(o, o_v) and torch.equal(lse, lse_v)
        name = (f"K1 device shift {str(dt)[6:]} D={D} S={S0} T={T} "
                f"shift={-p0}")
        log(f"{name}: max_abs_err={err:.3e} tol={tol[dt]:.0e}, "
            f"bit-identical to the by-value shift: {same}")
        if not (err <= tol[dt] and same):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 "or with the by-value shift")
        if dt == torch.bfloat16 and (p0, S0) == SUFFIX_SHAPES[0]:
            worst["suffix_device_shift"] = err
        worst[name] = err
    return worst


def _rel_err(got, want) -> float:
    """Max abs error over max(1, max |want|)."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1.0)).item()


def _bwd_repeats(*args) -> bool:
    """Two calls of K2 and of K3 on ``args`` give the same bits."""
    from horovod_tpu_torch.ops import attention as A

    first = (*A._flash_bwd_dkdv_cuda(*args), A._flash_bwd_dq_cuda(*args))
    again = (*A._flash_bwd_dkdv_cuda(*args), A._flash_bwd_dq_cuda(*args))
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(first, again))


def check_flash_bwd() -> dict:
    """K2 and K3 through the autograd Function against the plain backward
    on the same forward results.  Tolerance, relative to the largest
    gradient (floored at 1): f32 1e-4 (summation order); bf16 2e-2 (p,
    ds and the outputs round to bf16, whose step is 2^-8 of a value; the
    kernel and the plain version sum in other orders, so a few entries
    round one step apart).  The shifted mask (shift = S // 3) leaves the
    first rows fully masked (lse = NEG_INF).  Every f32 case also runs
    K2 and K3 twice, bit for bit."""
    from horovod_tpu_torch.ops import attention as A

    bf16, f32 = torch.bfloat16, torch.float32
    tol = {f32: 1e-4, bf16: 2e-2}
    masks = ("causal", "full", "shift")
    cases = [(dt, D, S, S, m, G) for dt in (bf16, f32) for D in (64, 128)
             for S in (8, 100) for m in masks for G in (1, 4)]
    cases += [(dt, D, 2048, 2048, m, 4) for dt in (bf16, f32)
              for D in (64, 128) for m in masks]
    # The training run's attention (MHA), at B = 2: its errors go in the
    # kernels line.
    cases += [(dt, 64, 2048, 2048, "causal", 1) for dt in (bf16, f32)]
    cases += [(dt, 64, S, S, "causal", G) for dt in (bf16, f32)
              for S in EDGE_S for G in (1, 4)]
    cases += [(dt, D, *EDGE_T, m, 4) for dt in (bf16, f32) for D in (64, 128)
              for m in EDGE_T_MASKS]
    worst, failed = {}, []
    for i, (dt, D, S, T, mask, G) in enumerate(cases):
        B, H = 2, 16
        shift = _shift(mask, S, T)
        q, k, v = _k1_inputs(B, H, H // G, S, D, dt, seed=200 + i, T=T)
        g = torch.Generator(device="cuda").manual_seed(400 + i)
        do = torch.randn((B, H, S, D), generator=g, device="cuda").to(dt)
        dlse = torch.randn((B, H, S), generator=g, device="cuda")
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        scale = 1.0 / math.sqrt(D)
        o, lse = A._FlashAttention.apply(q, k, v, shift, scale)
        dq, dk, dv = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
        delta = (do.float() * o.float()).sum(-1) - dlse
        rq, rk, rv = A._flash_bwd_reference(
            q.detach(), k.detach(), v.detach(), do, lse.detach(), delta,
            shift, scale)
        torch.cuda.synchronize()
        err = max(_rel_err(a, b) for a, b in ((dq, rq), (dk, rk), (dv, rv)))
        name = f"K2/K3 {str(dt)[6:]} D={D} S={S} T={T} {mask} G={G}"
        log(f"{name}: rel_err={err:.3e} tol={tol[dt]:.0e}")
        if not err <= tol[dt]:
            failed.append(name)
        if dt == f32 and not _bwd_repeats(q.detach(), k.detach(), v.detach(),
                                          do, lse.detach(), delta, shift,
                                          scale):
            failed.append(name + " (two calls differ)")
        worst[name] = err
        if S == T == 2048 and G == 1:
            worst["training" + _suffix(dt)] = {
                "dkdv": max((dk.float() - rk.float()).abs().max().item(),
                            (dv.float() - rv.float()).abs().max().item()),
                "dq": (dq.float() - rq.float()).abs().max().item()}
        del q, k, v, o, lse, do, dq, dk, dv, rq, rk, rv
    if failed:
        raise AssertionError(f"K2/K3 disagree with the plain backward: "
                             f"{failed}")
    return worst


# Slot limits of the K4 checks at the serving shape (8 slots, 136 pages
# of 16, split_grid: 9 pages = 144 positions a split): a slot at table
# capacity, a partial last page, limit 0, two slots sharing pages.
K4_LIMITS = [16 * 136, 5, 0, 16 + 3, 1000, 1, 2048, 777]
# Split edges: on a split boundary (144, 288) and one position past it,
# one short of it, and slots whose later splits are all past the limit.
K4_SPLIT_LIMITS = [144, 145, 0, 288, 289, 143, 16 * 136, 17]


def _k4_case(kind, compute, Dh=64, S=8, Hkv=4, R=4, ps=16, MP=136,
             P=1089, seed=0, lim=K4_LIMITS):
    from horovod_tpu_torch.models import transformer as T

    g = torch.Generator(device="cuda").manual_seed(seed)
    qg = torch.randn((S, Hkv, R, Dh), generator=g, device="cuda")
    kf = torch.randn((P, Hkv, ps, Dh), generator=g, device="cuda")
    vf = torch.randn((P, Hkv, ps, Dh), generator=g, device="cuda")
    table = torch.randint(1, P, (S, MP), generator=g, device="cuda",
                          dtype=torch.int32)
    table[1] = table[0]                       # a page shared by two slots
    limit = torch.tensor(lim[:S], dtype=torch.int32, device="cuda")
    if kind == "int8":
        kq, ks = T.kv_quantize(kf)
        vq, vs = T.kv_quantize(vf)
        args = (qg.to(compute), kq, vq, ks, vs)
    else:
        args = (qg.to(kind), kf.to(kind), vf.to(kind), None, None)
    return args, table, limit


def check_paged() -> dict:
    """K4 against its plain version; every case is called twice and the
    two results must be equal bit for bit (no atomics, partials combined
    in split order)."""
    from horovod_tpu_torch.ops import paged_attention as PA

    worst = {}
    f32, bf16 = torch.float32, torch.bfloat16
    # (pool, compute dtype, Dh, R, limits, tolerance)
    cases = [(f32, f32, 64, 4, K4_LIMITS, 1e-4),
             (bf16, bf16, 64, 4, K4_LIMITS, 2e-2),
             ("int8", bf16, 64, 4, K4_LIMITS, 2e-2),
             ("int8", f32, 64, 4, K4_LIMITS, 1e-4),
             (bf16, bf16, 128, 4, K4_LIMITS, 2e-2),
             (f32, f32, 64, 4, K4_SPLIT_LIMITS, 1e-4),
             (bf16, bf16, 64, 4, K4_SPLIT_LIMITS, 2e-2),
             ("int8", bf16, 128, 4, K4_SPLIT_LIMITS, 2e-2),
             (bf16, bf16, 64, 1, K4_SPLIT_LIMITS, 2e-2),
             (bf16, bf16, 64, 8, K4_LIMITS, 2e-2),
             (f32, f32, 128, 8, K4_SPLIT_LIMITS, 1e-4),
             # The speculative verify: R = G * W = 4 * 5; a bf16 pool's
             # R > 8 runs the rows kernel (16: one row tile, 32: both
             # full, 20 at Dh = 128: two boxes a row).
             (f32, f32, 64, 20, K4_LIMITS, 1e-4),
             (bf16, bf16, 64, 20, K4_LIMITS, 2e-2),
             ("int8", bf16, 64, 20, K4_LIMITS, 2e-2),
             (bf16, bf16, 64, 16, K4_SPLIT_LIMITS, 2e-2),
             (bf16, bf16, 64, 32, K4_LIMITS, 2e-2),
             (bf16, bf16, 128, 20, K4_SPLIT_LIMITS, 2e-2)]
    for i, (kind, compute, Dh, R, lim, tol) in enumerate(cases):
        args, table, limit = _k4_case(kind, compute, Dh=Dh, R=R, seed=i,
                                      lim=lim)
        o, lse = PA.paged_attend(*args, table, limit, compute_dtype=compute)
        o2, lse2 = PA.paged_attend(*args, table, limit,
                                   compute_dtype=compute)
        o_r, l_r = PA.paged_attend_reference(*args, table, limit,
                                             compute_dtype=compute)
        torch.cuda.synchronize()
        live = limit > 0
        err = max((o - o_r).abs().max().item(),
                  (lse[live] - l_r[live]).abs().max().item())
        edges = "split edges" if lim is K4_SPLIT_LIMITS else "edge table"
        name = f"K4 pool={str(kind).replace('torch.', '')} " \
               f"compute={str(compute)[6:]} Dh={Dh} R={R} {edges}"
        log(f"{name}: max_abs_err={err:.3e} tol={tol:.0e}")
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version")
        if o[~live].abs().max().item() != 0 or \
                not (lse[~live] <= PA.NEG_INF / 2).all():
            raise AssertionError(f"{name}: a limit=0 slot is not (0, NEG_INF)")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{name}: two calls differ")
        if kind in (bf16, f32) and Dh == 64 and R == 4 and lim is K4_LIMITS:
            worst["serving" + _suffix(kind)] = err
        if kind == bf16 and Dh == 64 and R == 20:
            worst["verify"] = err
        worst[name] = err
    return worst


# --- phases 4 and 5: serving --------------------------------------------------


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, FULL["vocab_size"], n).tolist()
            for n in PROMPT_LENS]


def _post(url, payload, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _device_events(prof):
    """The profile's kernels and copies on the card.  Left out, because
    they repeat a kernel's time: CPU-side events (an operation that
    launches a kernel itself, such as an autograd Function's ctypes
    launch, carries that kernel's time as its own) and annotated ranges
    on the device timeline (the optimizer's step)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]


def _grant_ahead(engine, n: int) -> None:
    """Pages for every active slot's next ``n`` positions (a paged
    engine's), and the tick's table, tokens, mask and sampling columns
    refreshed from the host: the state a tick run outside the engine
    (the eager twin) needs."""
    from horovod_tpu_torch.serving import NULL_PAGE

    tick = engine._tick
    if engine.engine_cfg.paged:
        ps = engine.slots.page_size
        for s in range(engine.engine_cfg.n_slots):
            if engine._states[s] is None:
                continue
            p0 = int(engine._page_pos[s])
            for idx in range(p0 // ps, (p0 + n) // ps + 1):
                if engine.slots.table[s, idx] == NULL_PAGE:
                    engine.slots.grant(s, idx)
        tick.table.copy_(torch.from_numpy(engine.slots.table))
    tick.tokens.copy_(torch.from_numpy(engine._host_tokens()))
    tick.active.copy_(torch.from_numpy(engine.slots.active_mask()))
    engine._samp.device()


def _fill_slots(engine, depth: int, new_tokens: int, seed: int):
    """Every slot busy at ``depth``, half of them sampling; the pipeline
    running (two ticks past the last admission)."""
    rng = np.random.default_rng(seed)
    futs = [engine.submit(rng.integers(0, FULL["vocab_size"], depth).tolist(),
                          max_new_tokens=new_tokens, **SAMPLING[i % 8])
            for i in range(ENGINE["n_slots"])]
    while engine.scheduler.depth or engine._taken:
        engine.step()
    for _ in range(2):
        engine.step()
    return futs


def profile_decode(engine, mode: str, sampler_ms: float,
                   n_ticks: int = 8) -> dict:
    """Where a steady decode tick's time goes, 8 slots at depth
    ``PROFILE_DEPTH`` (half sampling), in one of three modes:
    ``eager_sync`` — ``decode_step_paged`` and the pick called directly
    (``DecodeTick.body`` on a twin of the engine's state) and fetched
    at once, the tick without a graph; ``graph_sync`` —
    ``engine.step()`` of an ``overlap=False`` engine, one replay and one
    fetch a tick;
    ``graph_overlap`` — ``engine.step()`` of the default engine.
    ``n_ticks`` ticks timed by the host clock, then ``n_ticks`` more
    under ``torch.profiler`` for device time by kernel (the profiler's
    host cost stays out of the wall time).  ``sampler_ms``: the pick's
    device time (:func:`sampler_device_ms`; the same kernels run in every
    mode, and inside a graph the profiler cannot tell them apart)."""
    from horovod_tpu_torch.serving.graph import download
    from torch.profiler import ProfilerActivity, profile

    futs = _fill_slots(engine, PROFILE_DEPTH, 3 * n_ticks + 8, seed=2)
    if mode == "eager_sync":
        _grant_ahead(engine, 2 * n_ticks + 2)
        twin = engine._tick.twin()

        def tick():
            download(*twin.body()).wait()
    else:
        tick = engine.step
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n_ticks):
        tick()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / n_ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            tick()
        torch.cuda.synchronize()
    if mode == "eager_sync":
        del twin
    while not all(f.done() for f in futs):
        engine.step()
    kernels, launches = {}, 0
    for e in _device_events(prof):
        kernels[e.key] = e.self_device_time_total / 1e3 / n_ticks  # ms a tick
        launches += e.count
    busy = sum(kernels.values())
    if busy <= 0:
        raise AssertionError(f"{mode}: the profiler recorded no device time")
    # K4 is two kernels a call: split and combine.
    k4 = sum(t for k, t in kernels.items() if "paged_attend_" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out = {"mode": mode, "ticks": n_ticks, "tick_wall_ms": wall_ms,
           "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "paged_attend_ms": k4, "paged_attend_share_of_busy": k4 / busy,
           "kernels_launched_per_tick": launches / n_ticks,
           "sampler_ms": sampler_ms,
           "sampler_share_of_busy": sampler_ms / busy,
           "tok_per_s": ENGINE["n_slots"] / wall_ms * 1e3,
           "top_kernels_ms": {k[:70]: t for k, t in top}}
    log(f"decode tick {mode} (8 slots at depth {PROFILE_DEPTH}): wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms (idle share "
        f"{out['idle_share']:.3f}), paged_attend {k4:.3f} ms, "
        f"{out['kernels_launched_per_tick']:.0f} kernels per tick, "
        f"sampler {sampler_ms:.3f} ms ({sampler_ms / busy:.1%} of busy), "
        f"{out['tok_per_s']:.1f} tok/s")
    return out


def sampler_device_ms() -> dict:
    """Device time of the tick's sampled pick alone, at the tick's shape
    (8 slots x 32000 f32 logits, half sampling), by the profiler."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving.sampling import SlotSampling

    samp = SlotSampling(ENGINE["n_slots"], "cuda")
    for i, kw in enumerate(SAMPLING):
        if kw:
            samp.set(i, temperature=kw["temperature"],
                     top_k=kw.get("top_k", 0), top_p=kw.get("top_p", 0.0),
                     seed=kw["seed"])
    cols = samp.device()
    g = torch.Generator(device="cuda").manual_seed(9)
    logits = torch.randn((ENGINE["n_slots"], FULL["vocab_size"]),
                         generator=g, device="cuda") * 3
    pos = torch.full((ENGINE["n_slots"],), PROFILE_DEPTH + 1,
                     dtype=torch.int64, device="cuda")
    ms = device_ms(lambda: T.sample_token_rows(logits, *cols, pos,
                                               torch.zeros_like(pos)))
    log(f"sampler (8 x {FULL['vocab_size']} f32): {ms:.4f} ms device time")
    return {"sampler_ms": ms}


def graph_vs_eager(engine, n_ticks: int = 20) -> dict:
    """The captured tick against the eager one, bit for bit: every slot
    busy (half sampling, unequal depths), ``n_ticks`` replays against
    ``n_ticks`` eager runs of ``DecodeTick.body`` on a copy of the same
    state, one slot leaving halfway.  Tokens, max logits, pool (or slot
    cache) bytes and positions must be equal; K4 must launch once a layer
    a replay on a paged engine with K4 engaged, never otherwise.  Leaves
    the engine's host mirror behind its cache: terminates it."""
    from horovod_tpu_torch.ops import paged_attention as PA

    rng = np.random.default_rng(4)
    for i in range(ENGINE["n_slots"]):
        engine.submit(rng.integers(0, FULL["vocab_size"],
                                   PROMPT_LENS[i]).tolist(),
                      max_new_tokens=64, **SAMPLING[i])
    while engine.scheduler.depth or engine._taken:
        engine.step()
    _grant_ahead(engine, n_ticks)
    tick = engine._tick
    twin = tick.twin()
    k4, replays = PA.paged_attend_launches, tick.replays
    graphed = []
    for i in range(n_ticks):
        if i == n_ticks // 2:
            tick.active[3] = False
        nxt, mx = tick.run()
        graphed.append((nxt.clone(), mx.clone()))
    k4_per_replay = (PA.paged_attend_launches - k4) / (tick.replays - replays)
    for i in range(n_ticks):
        if i == n_ticks // 2:
            twin.active[3] = False
        nxt, mx = twin.body()
        if not (torch.equal(nxt, graphed[i][0])
                and torch.equal(mx, graphed[i][1])):
            raise AssertionError(f"graph tick {i} differs from the eager "
                                 "tick")
    differ = [k for k, t in tick.pool.items()
              if not torch.equal(t, twin.pool[k])]
    if differ:
        raise AssertionError(f"graph and eager pools differ: {differ}")
    want_k4 = FULL["n_layers"] if tick.kernel else 0
    if k4_per_replay != want_k4:
        raise AssertionError(f"K4 launched {k4_per_replay} times a replay, "
                             f"expected {want_k4}")
    engine.terminate("graph check done")
    kind = "paged" if engine.engine_cfg.paged else "slot-contiguous"
    log(f"graph vs eager ({kind}): {n_ticks} ticks bit-identical (tokens, "
        f"max logits, cache, pos), K4 {k4_per_replay:.0f} launches a "
        "replay")
    return {"ticks": n_ticks, "bit_identical": True,
            "k4_launches_per_replay": k4_per_replay}


def _generate_burst(engine, prompts):
    """The serving prompts (``NEW_TOKENS``, ``SAMPLING``) as concurrent
    ``POST /generate`` requests to a ``ServingServer`` over ``engine``,
    each checked for its full count.  The main path's run: the kernels'
    launch counters read 0 just before it and are read when the last
    request has returned.  -> (replies, wall seconds, launches, the
    engine's stats at the end)."""
    from horovod_tpu_torch.serving import ServingServer

    srv = ServingServer(engine, port=0, request_timeout=600).start()
    url = "http://%s:%d/generate" % srv.address
    results = [None] * len(prompts)
    _zero_launches()
    t0 = time.monotonic()

    def client(i):
        results[i] = _post(url, {"tokens": prompts[i],
                                 "max_new_tokens": NEW_TOKENS[i],
                                 **SAMPLING[i]})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    launches = _launches()
    stats = engine.stats()
    srv.stop()
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError(f"request {i} failed: {res}")
        body = res[1]
        if len(body["tokens"]) != NEW_TOKENS[i] or \
                body["finish_reason"] != "length":
            raise AssertionError(f"request {i} returned "
                                 f"{len(body['tokens'])} tokens "
                                 f"({body['finish_reason']})")
    return results, wall, launches, stats


def serve_full_width(card: str) -> dict:
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0)
    n_params = sum(t.numel() for t in [params["embed"], params["head"],
                                        params["ln_f"],
                                        *params["layers"].values()])
    # The synchronous engine: the eager and graph-synchronous decode
    # profiles, then the graph-against-eager check (which ends it).
    sampler = sampler_device_ms()
    sync = InferenceEngine(params, cfg, EngineConfig(**ENGINE, overlap=False))
    sync.warmup((8,))
    modes = [profile_decode(sync, "eager_sync", sampler["sampler_ms"]),
             profile_decode(sync, "graph_sync", sampler["sampler_ms"])]
    check = graph_vs_eager(sync)
    del sync
    engine = InferenceEngine(params, cfg, EngineConfig(**ENGINE))
    t0 = time.monotonic()
    engine.warmup(ENGINE_WARM_LENS)
    warm_s = time.monotonic() - t0
    warm_graphs = _admission_graphs(engine)
    reserved = warm_graphs["warmup_reserved_bytes"]
    log(f"admission graphs on {card}: warmup over buckets 8-2176 in "
        f"{warm_s:.3f} s; {warm_graphs['prefill_compilations']} prefill "
        f"and {warm_graphs['sample_compilations']} sampler captures in "
        f"{warm_graphs['prefill_capture_s']:.3f} s; reserved "
        f"{reserved[0]} -> {reserved[1]} bytes across the sweep "
        f"(+{(reserved[1] - reserved[0]) / 2**20:.1f} MiB, the tick's "
        f"capture included); buckets {engine.stats()['prefill_buckets']}")
    captures0 = engine.stats()["decode_compilations"]
    modes.append(profile_decode(engine, "graph_overlap",
                                sampler["sampler_ms"]))
    sampler["share_of_tick_busy"] = modes[-1]["sampler_share_of_busy"]
    # The prefix phase and the admission profile step the engine
    # directly, before the HTTP burst (stopping the server drains it).
    with phase("prefix_bf16"):
        prefix = prefix_full_width(engine, card)
    with phase("admission_profile"):
        admission = admission_profile(engine)
    graphs0 = _admission_graphs(engine)
    ticks0 = engine.metrics.decode_ticks.value
    sums0 = {k: getattr(engine.metrics, k).snapshot()["sum"]
             for k in ("tick_dispatch", "tick_device_wait", "tick_host")}
    prompts = _prompts()
    results, wall, launches, stats = _generate_burst(engine, prompts)
    del launches["grouped_matmul"]  # a dense model
    if not (launches["flash_fwd"] > 0 and launches["paged_attend"] > 0):
        raise AssertionError(f"the serving run missed a kernel: {launches}")
    captures = (captures0, stats["decode_compilations"])
    if captures != (1, 1):
        raise AssertionError(f"decode_compilations before/after the burst: "
                             f"{captures}, expected 1 and 1")
    graphs1 = _admission_graphs(engine)
    if graphs1 != graphs0:
        raise AssertionError(f"the burst captured admission graphs: "
                             f"{graphs0} before, {graphs1} after")
    ticks = stats["decode_ticks"] - ticks0
    tick_s = sum(stats[f"{k}_seconds"]["sum"] - sums0[k] for k in sums0)
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    total = sum(NEW_TOKENS)
    out = {
        "params": n_params, "requests": len(prompts),
        "prompt_lens": PROMPT_LENS, "new_tokens": NEW_TOKENS,
        "sampling": SAMPLING,
        "wall_s": wall, "tokens": total, "tok_per_s": total / wall,
        "decode_ticks": ticks, "tick_ms_mean": tick_s / ticks * 1e3,
        "ttft_ms_p50": statistics.median(ttft), "ttft_ms_max": ttft[-1],
        "launches": launches,
        "decode_compilations_before_after": list(captures),
        "host_syncs_per_tick": stats["host_syncs_per_tick"],
        "kv_pages_high_water": stats["kv_pages_high_water"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "decode_modes": modes, "sampler": sampler,
        "graph_vs_eager": check, "warmup_s": warm_s,
        "admission_graphs_after_warmup": warm_graphs,
        "admission_graphs_after_burst": graphs1,
        "prefill_buckets": stats["prefill_buckets"],
    }
    log(f"serving bf16: {len(prompts)} requests (half sampled), {total} "
        f"tokens in {wall:.3f} s = {out['tok_per_s']:.1f} tok/s; {ticks} "
        f"decode ticks at {out['tick_ms_mean']:.3f} ms; TTFT p50 "
        f"{out['ttft_ms_p50']:.1f} ms max {out['ttft_ms_max']:.1f} ms; "
        f"launches {launches}; decode_compilations before/after "
        f"{captures}; admission graphs {graphs1} (none captured during the "
        f"burst); sampler {sampler['share_of_tick_busy']:.1%} of the "
        "graph tick's device busy")
    out["prefix"], out["admission_profile"] = prefix, admission
    del engine
    torch.cuda.empty_cache()
    with phase("durability_bf16"):
        out["durability"] = durability_bf16(params, cfg)
    with phase("slo_bf16"):
        out["slo"] = {}
        for slo in (True, False):
            leg = slo_leg(params, cfg, slo)
            del leg["prompts"], leg["tokens"]
            out["slo"][leg["leg"]] = leg
    slo_, fcfs = out["slo"]["slo"], out["slo"]["fcfs"]
    log(f"SLO legs on {card}: interactive TTFT p50/p99 slo "
        f"{slo_['interactive_ttft_ms_p50']:.1f}/"
        f"{slo_['interactive_ttft_ms_p99']:.1f} ms vs fcfs "
        f"{fcfs['interactive_ttft_ms_p50']:.1f}/"
        f"{fcfs['interactive_ttft_ms_p99']:.1f} ms; batch slo "
        f"{slo_['batch_ttft_ms_p50']:.1f}/{slo_['batch_ttft_ms_p99']:.1f} "
        f"vs fcfs {fcfs['batch_ttft_ms_p50']:.1f}/"
        f"{fcfs['batch_ttft_ms_p99']:.1f} ms; tok/s slo "
        f"{slo_['tok_per_s']:.1f} vs fcfs {fcfs['tok_per_s']:.1f}; "
        f"preemptions {slo_['preemptions']} / {fcfs['preemptions']}")
    del params
    torch.cuda.empty_cache()
    return out


def durability_bf16(params, cfg) -> dict:
    """The serving phase's configuration and prompts on a pool of
    ``DURABLE_PAGES`` pages, below capacity parity, so that decode growth
    runs out of pages and suspends requests, and one decode tick raising
    midway through the burst.  Every request must return its full token
    count, with at least one preemption and one resume, one capture
    throughout; then the graph check again on the restarted engine (its
    pool and inputs reset in place): 20 replays bit-identical to the
    eager tick, K4 once a layer a replay."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import (EngineConfig, FaultInjector,
                                           InferenceEngine)

    inj = FaultInjector()
    engine = InferenceEngine(params, cfg, EngineConfig(
        **ENGINE, n_pages=DURABLE_PAGES, faults=inj))
    engine.warmup(ENGINE_WARM_LENS)
    prompts = _prompts()
    # The durability phase's main path: the launch counters read 0 here
    # and are read again after its last request.
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    futs = [engine.submit(p, max_new_tokens=n, **SAMPLING[i])
            for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS))]
    faults = [("decode_tick", "raise", sum(NEW_TOKENS) // 2)]
    run = _burst_with_faults(engine, inj, futs, faults)
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    for i, f in enumerate(futs):
        got = f.result(timeout=0)
        if len(got) != NEW_TOKENS[i] or f.finish_reason != "length":
            raise AssertionError(f"bf16 faulted request {i} returned "
                                 f"{len(got)} tokens ({f.finish_reason})")
    st = _durability_checks("bf16 faulted", engine, launches, 1)
    if st["preemptions"] < 1 or st["requests_resumed"] < 1:
        raise AssertionError(
            f"bf16 faulted burst: preemptions {st['preemptions']}, "
            f"requests_resumed {st['requests_resumed']}, expected >= 1 each")
    out = {"n_pages": DURABLE_PAGES, "faults": faults, "fired": inj.fired,
           "recovery_s": run["recovery_s"],
           "preemptions": st["preemptions"],
           "requests_resumed": st["requests_resumed"],
           "resume_wasted_tokens": st["resume_wasted_tokens"],
           "kv_pages_high_water": st["kv_pages_high_water"],
           "launches": launches,
           "faulted_tok_per_s": sum(NEW_TOKENS) / run["wall_s"]}
    log(f"durability bf16 ({DURABLE_PAGES} pages): fault fired "
        f"{inj.fired}; {st['preemptions']} preemptions, "
        f"{st['requests_resumed']} resumes, every request its full count; "
        f"restarts 1, journal_inflight 0, healthy, decode_compilations 1; "
        f"launches {launches}")
    out["graph_vs_eager"] = graph_vs_eager(engine)  # ends the engine
    if engine.stats()["decode_compilations"] != 1:
        raise AssertionError("the restarted engine recaptured its tick")
    del engine
    torch.cuda.empty_cache()
    return out


def _f32_oracles(params, cfg, prompts, sampling=SAMPLING,
                 new_tokens=F32_NEW_TOKENS) -> list:
    """Each request's oracle tokens and top-2 margins: ``greedy_decode``
    for greedy requests, ``sample_decode`` at the request's seed for
    sampled ones (``sampling[i]`` is request ``i``'s)."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import seed_key

    refs = []
    for i, p in enumerate(prompts):
        kw = dict(sampling[i])
        prompt = torch.tensor([p], device="cuda")
        if kw:
            ref, gap = T.sample_decode(params, prompt, new_tokens, cfg,
                                       rng=seed_key(kw.pop("seed")),
                                       margins=True, **kw)
        else:
            ref, gap = T.greedy_decode(params, prompt, new_tokens, cfg,
                                       margins=True)
        refs.append((ref[0].tolist(), gap[0].tolist()))
    return refs


def _check_f32(label: str, prompts, outs, refs, sampling=SAMPLING) -> list:
    """Every request's tokens (``outs``) against its oracle.  A mismatch
    is exempt only at or after a pick whose oracle top-2 gap is below
    ``NEAR_TIE``; returns the exemptions."""
    exempt = []
    for i, (p, got, (ref, gap)) in enumerate(zip(prompts, outs, refs)):
        if got == ref:
            continue
        first = next((j for j in range(len(ref))
                      if j >= len(got) or got[j] != ref[j]), len(ref))
        ties = [j for j in range(min(first + 1, len(ref)))
                if gap[j] < NEAR_TIE]
        if len(got) != len(ref) or not ties:
            raise AssertionError(
                f"{label} request {i} (prompt {len(p)}, "
                f"{sampling[i] or 'greedy'}, {len(got)} tokens) diverges "
                f"from the oracle at token {first}")
        exempt.append({"request": i, "prompt_len": len(p),
                       "sampled": bool(sampling[i]),
                       "first_mismatch": first, "tie_at": ties[0],
                       "margin": gap[ties[0]]})
        log(f"exemption: {label} request {i} diverges at token {first} "
            f"after a near-tie at token {ties[0]} (margin "
            f"{gap[ties[0]]:.3e} < {NEAR_TIE})")
    return exempt


def _burst_with_faults(engine, inj, futs, faults) -> dict:
    """Step ``engine`` until every future resolves, injecting each
    ``(site, kind, at)`` of ``faults`` at the next visit of its site once
    the burst has emitted ``at`` tokens in all.  Each fault must restart
    the engine; its recovery time runs from the step it is armed before
    to the end of the first clean tick after the restart (the engine
    back to ``healthy``), synchronized."""
    from horovod_tpu_torch.serving import FaultSpec

    def emitted():
        return sum(len(f.tokens_so_far()) for f in futs)

    def step():
        if engine.terminal or all(f.done() for f in futs):
            raise AssertionError(f"the faulted burst ended early: "
                                 f"{engine.stats()['error']}")
        engine.step()

    recoveries = []
    t0 = time.monotonic()
    for site, kind, at in faults:
        while emitted() < at:
            step()
        restarts = engine.metrics.engine_restarts.value
        inj.add(FaultSpec(site=site, kind=kind, skip=inj.visits(site)))
        t_fault = time.monotonic()
        while engine.metrics.engine_restarts.value == restarts:
            step()
        while engine.health != "healthy":
            if engine.terminal:
                raise AssertionError("the engine went terminal")
            engine.step()
        torch.cuda.synchronize()
        recoveries.append(time.monotonic() - t_fault)
    while not all(f.done() for f in futs):
        engine.step()
    torch.cuda.synchronize()
    return {"wall_s": time.monotonic() - t0, "recovery_s": recoveries}


def _durability_checks(label: str, engine, launches: dict, restarts: int,
                       captures: int = 1):
    """What every faulted burst must leave: the expected restarts, an
    empty journal, a healthy engine, its decode captures (one, two for a
    speculative engine), and both kernels of the path launched during
    the burst."""
    st = engine.stats()
    got = (st["engine_restarts"], st["journal_inflight"], st["state"],
           st["decode_compilations"])
    if got != (restarts, 0, "healthy", captures):
        raise AssertionError(
            f"{label}: (engine_restarts, journal_inflight, state, "
            f"decode_compilations) = {got}, expected "
            f"({restarts}, 0, 'healthy', {captures})")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"{label}: the faulted burst missed a kernel: "
                             f"{launches}")
    return st


#: token_identity's prompts, oracles, f32 parameters, config and the
#: paged (K4) engine's tokens, kept for the f32 fleet leg, the unpaged
#: phase and the paged-kernel A/B, and dropped after them.
F32_ORACLE: dict = {}


def token_identity() -> dict:
    """f32 engine tokens of a half-sampled burst against the per-request
    oracles: ``greedy_decode`` for greedy requests, ``sample_decode`` at
    the request's seed for sampled ones.  A mismatch is exempt only at
    or after a pick whose oracle top-2 gap is below ``NEAR_TIE``.  Then
    the same burst on the same engine through the three ``F32_FAULTS``:
    every request resumes, and its tokens must equal the same oracle."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import (EngineConfig, FaultInjector,
                                           InferenceEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = T.TransformerConfig(**FULL, dtype=torch.float32)
    params = T.init_params(cfg, seed=0)
    inj = FaultInjector()  # no fault until the faulted burst adds them
    engine = InferenceEngine(params, cfg, EngineConfig(**ENGINE, faults=inj))
    engine.warmup(ENGINE_WARM_LENS)
    prompts = _prompts(seed=1)
    t0 = time.monotonic()
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS, **SAMPLING[i])
            for i, p in enumerate(prompts)]
    while not all(f.done() for f in futs):
        engine.step()
    torch.cuda.synchronize()
    clean_s = time.monotonic() - t0
    refs = _f32_oracles(params, cfg, prompts)
    plain_outs = [f.result(timeout=0) for f in futs]
    exempt = _check_f32("f32", prompts, plain_outs, refs)
    captures = engine.stats()["decode_compilations"]
    if captures != 1:
        raise AssertionError(f"f32 engine captured {captures} ticks")
    log(f"token identity f32: {len(prompts)} requests (half sampled) x "
        f"{F32_NEW_TOKENS} tokens, {len(exempt)} near-tie exemptions "
        "(TF32 off)")
    # The faulted burst: the durability phase's main path, its launch
    # counters read 0 here and are read again after its last request.
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS, **SAMPLING[i])
            for i, p in enumerate(prompts)]
    run = _burst_with_faults(engine, inj, futs, F32_FAULTS)
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    fault_exempt = _check_f32("f32 faulted", prompts,
                              [f.result(timeout=0) for f in futs], refs)
    st = _durability_checks("f32 faulted", engine, launches,
                            len(F32_FAULTS))
    tokens = len(prompts) * F32_NEW_TOKENS
    faulted = {"faults": F32_FAULTS, "exemptions": fault_exempt,
               "fired": inj.fired, "recovery_s": run["recovery_s"],
               "engine_restarts": st["engine_restarts"],
               "requests_resumed": st["requests_resumed"],
               "resume_wasted_tokens": st["resume_wasted_tokens"],
               "launches": launches,
               "clean_tok_per_s": tokens / clean_s,
               "faulted_tok_per_s": tokens / run["wall_s"]}
    log(f"durability f32: faults {[f[:2] for f in F32_FAULTS]} fired "
        f"{inj.fired}; {st['requests_resumed']} resumes, "
        f"{len(fault_exempt)} near-tie exemptions; restarts "
        f"{st['engine_restarts']}, journal_inflight 0, healthy, "
        f"decode_compilations 1; launches {launches}")
    # The f32 fleet leg (beside this phase) serves the same prompts
    # against the same oracles.
    F32_ORACLE.update(prompts=prompts, refs=refs, params=params, cfg=cfg,
                      paged_outs=plain_outs)
    with phase("prefix_f32"):
        prefix = prefix_identity_f32(engine, params, cfg)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    with phase("slo_f32"):
        slo = slo_identity_f32(params, cfg)
    with phase("spec_f32"):
        spec = spec_identity_f32(params, cfg, prompts, refs, plain_outs)
    del params
    torch.cuda.empty_cache()
    return {"requests": len(prompts), "exemptions": exempt,
            "durability": faulted, "prefix": prefix, "slo": slo,
            "speculative": spec}


# --- shared prefixes, chunked prefill, the admission profile -----------------


def _prefix_prompts(seed: int):
    """The prefix phase's prefix and its eight prompts (six sharers, then
    the prefix itself twice)."""
    rng = np.random.default_rng(seed)
    V = FULL["vocab_size"]
    prefix = rng.integers(0, V, PREFIX_LEN).tolist()
    prompts = [prefix + rng.integers(0, V, n).tolist()
               for n in PREFIX_SUFFIXES]
    return prefix, prompts + [list(prefix), list(prefix)]


class _PrefillCounter:
    """The engine's prefills while entered: each replay of a whole-prompt
    graph (``prefill``) and of a suffix graph (``prefill_with_prefix``),
    with its padded and real token counts, read from the host arrays the
    engine uploads (no host sync)."""

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        self.calls = []
        replay = self.engine._replay

        def call(key, fields):
            name = "prefill" if key[0] == "full" else "prefill_with_prefix"
            self.calls.append((name, int(np.size(fields["tokens"])),
                               int(np.sum(fields["lens"]))))
            return replay(key, fields)

        self.engine._replay = call
        return self

    def __exit__(self, *exc):
        del self.engine._replay

    def summary(self, into: dict = None) -> dict:
        out = {} if into is None else into
        for name, padded, tokens in self.calls:
            d = out.setdefault(name, {"calls": 0, "tokens": 0,
                                      "padded_tokens": 0})
            d["calls"] += 1
            d["tokens"] += tokens
            d["padded_tokens"] += padded
        return out


def _admission_graphs(engine) -> dict:
    """The engine's admission-graph counts: captures of prefills and of
    the first-token sampler, their seconds, the device memory reserved
    before and after the last warmup, and the prefill shapes used."""
    st = engine.stats()
    out = {k: st[k] for k in ("prefill_compilations", "sample_compilations",
                              "prefill_capture_s", "warmup_reserved_bytes",
                              "decode_compilations")}
    out["prefill_shapes_used"] = (len(st["prefill_buckets"])
                                  + len(st["prefill_suffix_shapes"]))
    return out


def _warm_lens(engine, lens) -> list:
    """One length for each prefill bucket that prompts of ``lens`` and
    their resumes (up to ``SLO_NEW_TOKENS`` tokens longer) reach: the
    longest in each."""
    longest = {}
    for n in lens:
        for m in range(n, n + SLO_NEW_TOKENS + 1):
            b = engine._bucket(m)
            longest[b] = max(longest.get(b, 0), m)
    return sorted(longest.values())


def _stepped_burst(engine, prompts, sampling, new_tokens) -> dict:
    """Submit every prompt at once and step the engine until each has
    returned its full count: wall, tok/s, TTFT and the most pages shared
    at once (the ``kv_pages_shared`` gauge after each step)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    futs = [engine.submit(p, max_new_tokens=new_tokens, **sampling[i])
            for i, p in enumerate(prompts)]
    shared = 0
    while not all(f.done() for f in futs):
        engine.step()
        shared = max(shared, engine.metrics.kv_pages_shared.value)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for i, f in enumerate(futs):
        got = f.result(timeout=0)
        if len(got) != new_tokens or f.finish_reason != "length":
            raise AssertionError(f"request {i} returned {len(got)} tokens "
                                 f"({f.finish_reason})")
    ttft = sorted(f.ttft for f in futs)
    return {"wall_s": wall, "tok_per_s": len(futs) * new_tokens / wall,
            "ttft_ms_p50": statistics.median(ttft) * 1e3,
            "ttft_ms_max": ttft[-1] * 1e3, "pages_shared_max": shared,
            "tokens": [f.result(timeout=0) for f in futs]}


def prefix_full_width(engine, card: str) -> dict:
    """The serving engine (bf16, full width, warmed) with one registered
    ``PREFIX_LEN``-token prefix and eight requests: six sharers, a greedy
    and a sampled one whose prompt is the prefix.  Every request must
    return its full count, the prefix must be prefilled exactly once
    (one whole-prompt prefill, of the prefix; the sharers only their
    suffixes; the prefix prompts none), pages must be shared while they
    decode, the pool must be whole again after ``unregister_prefix``,
    and the tick captured once.  Then the same prompts with nothing
    registered, for comparison.  The prefix's suffix graphs are warmed
    between its registration and the first run, and neither run may
    capture an admission graph."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA

    prefix, prompts = _prefix_prompts(seed=5)
    n_pages = engine.slots.n_pages
    with _PrefillCounter(engine) as counted:
        t0 = time.monotonic()
        engine.register_prefix(prefix)
        torch.cuda.synchronize()
        register_s = time.monotonic() - t0
    # The prefix's suffix graphs, captured before the timed run (the JAX
    # warmup compiles a registered prefix's suffix prefills).
    t0 = time.monotonic()
    engine.warmup(PREFIX_SUFFIXES)
    warm_s = time.monotonic() - t0
    graphs = _admission_graphs(engine)
    # The prefix path's run: the launch counters read 0 here and are
    # read again after its last request.
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    with _PrefillCounter(engine) as run_counted:
        shared = _stepped_burst(engine, prompts, PREFIX_SAMPLING,
                                PREFIX_NEW_TOKENS)
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    pinned_free = engine.slots.free_pages
    engine.unregister_prefix(prefix)
    engine.drain(timeout=60)
    free_after = engine.slots.free_pages
    prefills = run_counted.summary(counted.summary())
    want_full = {"calls": 1, "tokens": PREFIX_LEN,
                 "padded_tokens": engine._bucket(PREFIX_LEN)}
    if prefills.get("prefill") != want_full:
        raise AssertionError(f"the prefix was not prefilled exactly once: "
                             f"{prefills}")
    if prefills["prefill_with_prefix"]["tokens"] != sum(PREFIX_SUFFIXES):
        raise AssertionError(f"the sharers prefilled more than their "
                             f"suffixes: {prefills}")
    if shared["pages_shared_max"] < 1:
        raise AssertionError("no page was shared while the sharers decoded")
    pin = engine.slots.pages_for(PREFIX_LEN)
    if (pinned_free, free_after) != (n_pages - pin, n_pages):
        raise AssertionError(f"free pages {pinned_free} pinned, {free_after} "
                             f"after unregister; expected {n_pages - pin} "
                             f"and {n_pages}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"the prefix run missed a kernel: {launches}")
    with _PrefillCounter(engine) as counted:
        plain = _stepped_burst(engine, prompts, PREFIX_SAMPLING,
                               PREFIX_NEW_TOKENS)
    plain_prefills = counted.summary()
    after = _admission_graphs(engine)
    if after != graphs:
        raise AssertionError(f"the prefix runs captured past the warmup: "
                             f"{graphs} before, {after} after")
    same = sum(a == b for a, b in zip(shared.pop("tokens"),
                                      plain.pop("tokens")))
    out = {"prefix_len": PREFIX_LEN, "suffixes": PREFIX_SUFFIXES,
           "new_tokens": PREFIX_NEW_TOKENS, "register_s": register_s,
           "shared": shared, "plain": plain, "prefills": prefills,
           "plain_prefills": plain_prefills, "launches": launches,
           "pinned_pages": pin, "requests_equal_to_plain_run": same,
           "suffix_warmup_s": warm_s, "admission_graphs": graphs,
           "suffix_shapes": engine.stats()["prefill_suffix_shapes"]}
    log(f"prefix bf16 on {card}: {PREFIX_LEN}-token prefix registered in "
        f"{register_s:.3f} s; shared {shared['tok_per_s']:.1f} tok/s, TTFT "
        f"p50 {shared['ttft_ms_p50']:.1f} ms, prefill tokens "
        f"{sum(d['tokens'] for d in prefills.values())} "
        f"({prefills}), pages shared up to {shared['pages_shared_max']:.0f}"
        f"; nothing registered {plain['tok_per_s']:.1f} tok/s, TTFT p50 "
        f"{plain['ttft_ms_p50']:.1f} ms, prefill tokens "
        f"{sum(d['tokens'] for d in plain_prefills.values())}; "
        f"{same}/8 requests token-equal across the runs (bf16); launches "
        f"{launches}; suffix graphs warmed in {warm_s:.3f} s, admission "
        f"graphs {graphs} before and after both runs")
    return out


def admission_profile(engine) -> dict:
    """One admission group of k = 2 prompts at bucket 2048 and one at
    bucket 16 on the warmed bf16 engine (one replay of its captured
    ``("full", bucket, 2)`` graph each), each admitted alone
    (``_admit_pending``, no decode tick): its host wall (the admission
    and a device sync), the time from ``_admit_batch``'s entry to the
    replay and to the return of its first-token sync, and, from a second
    admission under
    ``torch.profiler``, its device busy time and kernel count.  Each
    bucket runs once unmeasured first."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(8)
    marks = {}
    admit, first = engine._admit_batch, engine._first_tokens
    replay = engine._replay

    def timed_admit(reqs):
        marks["entry"] = time.monotonic()
        return admit(reqs)

    def timed_replay(key, fields):
        marks["replay"] = time.monotonic()
        return replay(key, fields)

    def timed_first(*args):
        toks = first(*args)
        marks["sync"] = time.monotonic()
        return toks

    engine._admit_batch, engine._first_tokens = timed_admit, timed_first
    engine._replay = timed_replay
    out = {}
    try:
        for n in (2048, 16):
            rec = {"bucket": engine._bucket(n), "k": 2}
            for mode in ("warm", "timed", "profiled"):
                futs = [engine.submit(
                    rng.integers(0, FULL["vocab_size"], n).tolist(),
                    max_new_tokens=2) for _ in range(2)]
                calls = engine.stats()["prefill_calls"]
                marks.clear()
                torch.cuda.synchronize()
                t0 = time.monotonic()
                if mode == "profiled":
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        engine._admit_pending()
                        torch.cuda.synchronize()
                else:
                    engine._admit_pending()
                    torch.cuda.synchronize()
                wall = time.monotonic() - t0
                if engine.stats()["prefill_calls"] != calls + 1 or \
                        "sync" not in marks:
                    raise AssertionError(f"bucket {n}: the two prompts did "
                                         "not admit as one group")
                if mode == "timed":
                    rec["host_wall_ms"] = wall * 1e3
                    rec["entry_to_first_token_sync_ms"] = \
                        (marks["sync"] - marks["entry"]) * 1e3
                    # The host's part before the replay (pages, landing
                    # indices, the inputs' upload), the device idle.
                    rec["entry_to_replay_ms"] = \
                        (marks["replay"] - marks["entry"]) * 1e3
                elif mode == "profiled":
                    events = _device_events(prof)
                    rec["device_busy_ms"] = sum(
                        e.self_device_time_total for e in events) / 1e3
                    rec["kernels"] = sum(e.count for e in events)
                    rec["profiled_wall_ms"] = wall * 1e3
                while not all(f.done() for f in futs):
                    engine.step()
            rec["idle_share"] = 1 - rec["device_busy_ms"] / rec["host_wall_ms"]
            log(f"admission profile bucket {rec['bucket']} k=2: host wall "
                f"{rec['host_wall_ms']:.3f} ms, entry to first-token sync "
                f"{rec['entry_to_first_token_sync_ms']:.3f} ms (of it "
                f"{rec['entry_to_replay_ms']:.3f} ms before the replay), "
                f"device busy "
                f"{rec['device_busy_ms']:.3f} ms in {rec['kernels']} kernels "
                f"(idle share {rec['idle_share']:.3f})")
            out[str(rec["bucket"])] = rec
    finally:
        del engine._admit_batch, engine._first_tokens, engine._replay
    engine.drain(timeout=60)
    return out


def _slo_work(seed: int = 0) -> list:
    """``benchmarks/serving.py``'s SLO workload, drawn the same way:
    ``(arrival s, prompt, class)`` for two waves."""
    rng = np.random.default_rng(seed)
    V = FULL["vocab_size"]
    work, t = [], 0.0
    for _ in range(2):
        for _ in range(2):
            n = int(rng.integers(SLO_LONG - 48, SLO_LONG + 1))
            work.append((t, rng.integers(0, V, n).tolist(), "batch"))
        for j in range(6):
            n = int(rng.integers(3, 13))
            work.append((t + 0.01 * (j + 1),
                         rng.integers(0, V, n).tolist(), "interactive"))
        t += 0.25
    return work


def slo_leg(params, cfg, slo: bool, fault: bool = False) -> dict:
    """One leg of the SLO workload on a fresh warmed engine driven by its
    own thread, the arrivals on their schedule: ``slo`` chunked (32
    tokens) with the two classes, else whole-prompt prefill with one
    class.  With ``fault``, a ``prefill_chunk`` raise at a chunk
    boundary.  Every request must return its full count and the tick be
    captured once (with the fault: one restart, ``healthy`` at the
    end).  Per-class TTFT p50 / p99 as ``benchmarks/serving.py`` takes
    them."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import (EngineConfig, FaultInjector,
                                           FaultSpec, InferenceEngine)

    inj = FaultInjector()
    engine = InferenceEngine(params, cfg, EngineConfig(
        **SLO_ENGINE, prefill_chunk_tokens=SLO_CHUNK if slo else 0,
        faults=inj))
    work = _slo_work()
    t0 = time.monotonic()
    engine.warmup(_warm_lens(engine, {len(p) for _, p, _ in work}))
    warm_s = time.monotonic() - t0
    graphs = _admission_graphs(engine)
    if fault:
        inj.add(FaultSpec(site="prefill_chunk", kind="raise",
                          skip=inj.visits("prefill_chunk") + SLO_FAULT_SKIP))
    before = engine.stats()
    # This leg's run: the launch counters read 0 here and are read again
    # after its last request.
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    engine.start()
    try:
        futs = []
        t0 = time.monotonic()
        for arrival, prompt, pri in work:
            now = time.monotonic() - t0
            if now < arrival:
                time.sleep(arrival - now)
            futs.append((pri, engine.submit(
                prompt, max_new_tokens=SLO_NEW_TOKENS,
                priority=pri if slo else "interactive")))
        for _, f in futs:
            f.result(timeout=600)
        wall = time.monotonic() - t0
    finally:
        engine.stop()
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    st = engine.stats()
    label = ("slo" if slo else "fcfs") + (" f32 faulted" if fault else "")
    for i, (_, f) in enumerate(futs):
        got = f.result(timeout=0)
        if len(got) != SLO_NEW_TOKENS or f.finish_reason != "length":
            raise AssertionError(f"{label} request {i} returned {len(got)} "
                                 f"tokens ({f.finish_reason})")
    if st["decode_compilations"] != 1:
        raise AssertionError(f"{label}: decode_compilations "
                             f"{st['decode_compilations']}")
    if _admission_graphs(engine) != graphs:
        raise AssertionError(f"{label}: the leg captured past its warmup: "
                             f"{graphs} before, {_admission_graphs(engine)}")
    restarts = st["engine_restarts"] - before["engine_restarts"]
    if (restarts, st["state"]) != ((1 if fault else 0), "healthy"):
        raise AssertionError(f"{label}: {restarts} restarts, state "
                             f"{st['state']}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"{label}: the run missed a kernel: {launches}")
    out = {"leg": label, "requests": len(futs), "wall_s": wall,
           "tok_per_s": len(futs) * SLO_NEW_TOKENS / wall,
           "preemptions": st["preemptions"] - before["preemptions"],
           "engine_restarts": restarts, "fired": inj.fired,
           "decode_compilations": st["decode_compilations"],
           "warmup_s": warm_s, "admission_graphs": graphs,
           "launches": launches, "prompts": [p for _, p, _ in work],
           "tokens": [f.result(timeout=0) for _, f in futs]}
    for cls in ("interactive", "batch"):
        vals = sorted(f.ttft for pri, f in futs if pri == cls)
        out[f"{cls}_ttft_ms_p50"] = vals[len(vals) // 2] * 1e3
        out[f"{cls}_ttft_ms_p99"] = \
            vals[min(len(vals) - 1, int(len(vals) * 0.99))] * 1e3
    log(f"SLO leg {label}: {out['tok_per_s']:.1f} tok/s; TTFT p50/p99 "
        f"interactive {out['interactive_ttft_ms_p50']:.1f}/"
        f"{out['interactive_ttft_ms_p99']:.1f} ms, batch "
        f"{out['batch_ttft_ms_p50']:.1f}/{out['batch_ttft_ms_p99']:.1f} "
        f"ms; {out['preemptions']} preemptions, {restarts} restarts "
        f"(fired {inj.fired}); launches {launches}; warmup {warm_s:.3f} s, "
        f"admission graphs {graphs} before and after")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def prefix_identity_f32(engine, params, cfg) -> dict:
    """On the f32 engine: the registered prefix with three sharers (one
    sampled) and one request whose prompt is the prefix, against the
    whole prompt's oracle (the near-tie rule of ``_check_f32``); the pool
    whole again after ``unregister_prefix``."""
    prefix, prompts = _prefix_prompts(seed=6)
    pick = (0, 1, 5, 6)
    prompts = [prompts[i] for i in pick]
    sampling = [PREFIX_SAMPLING[i] for i in pick]
    engine.register_prefix(prefix)
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS, **sampling[i])
            for i, p in enumerate(prompts)]
    while not all(f.done() for f in futs):
        engine.step()
    engine.unregister_prefix(prefix)
    engine.drain(timeout=60)
    refs = _f32_oracles(params, cfg, prompts, sampling, F32_NEW_TOKENS)
    exempt = _check_f32("f32 prefix", prompts,
                        [f.result(timeout=0) for f in futs], refs, sampling)
    if engine.slots.free_pages != engine.slots.n_pages:
        raise AssertionError("f32 prefix: pages left after unregister")
    log(f"prefix identity f32: {len(prompts)} requests over a "
        f"{PREFIX_LEN}-token prefix ({[len(p) for p in prompts]} tokens), "
        f"{len(exempt)} near-tie exemptions")
    return {"prompt_lens": [len(p) for p in prompts], "exemptions": exempt}


def slo_identity_f32(params, cfg) -> dict:
    """The SLO leg in f32, chunked with priorities, through one
    ``prefill_chunk`` fault: every request's tokens against
    ``greedy_decode`` of its prompt (the near-tie rule)."""
    leg = slo_leg(params, cfg, slo=True, fault=True)
    prompts, greedy = leg.pop("prompts"), [{}] * leg["requests"]
    refs = _f32_oracles(params, cfg, prompts, greedy, SLO_NEW_TOKENS)
    leg["exemptions"] = _check_f32("f32 SLO", prompts, leg.pop("tokens"),
                                   refs, greedy)
    log(f"SLO identity f32: {len(prompts)} requests through fault "
        f"{leg['fired']}, {len(leg['exemptions'])} near-tie exemptions")
    return leg


# --- phases 6 and 7: training --------------------------------------------------


# --- speculative decoding ----------------------------------------------------


def _draft_model(name: str, params, cfg):
    """``(draft_params, draft_cfg)`` of a draft source: None for the
    n-gram draft, the target itself, or a half-depth model made of the
    target's first layers, its embedding, final norm and head."""
    import dataclasses

    if name == "ngram":
        return None, None
    if name == "self":
        return params, cfg
    n = cfg.n_layers // 2
    dcfg = dataclasses.replace(cfg, n_layers=n)
    return ({**params, "layers": {k: v[:n].contiguous()
                                  for k, v in params["layers"].items()}},
            dcfg)


def _spec_engine(name: str, params, cfg, **kw):
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine

    dp, dc = _draft_model(name, params, cfg)
    return InferenceEngine(
        params, cfg, EngineConfig(**ENGINE, speculative=True, spec_k=SPEC_K,
                                  **kw), draft_params=dp, draft_cfg=dc)


def spec_identity_f32(params, cfg, prompts, refs, plain_outs) -> dict:
    """The f32 burst through a speculative engine of each draft source:
    its tokens against the oracles and against the plain engine's
    (``plain_outs``), by the near-tie rule; the self-draft's acceptance
    at least 0.9 and more than one token a tick; then the same burst on
    the same engine through one decode fault once ``SPEC_FAULT_AT``
    tokens are out: the oracles' tokens again, one restart, two
    captures."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import FaultInjector

    out = {}
    for name in SPEC_DRAFTS:
        inj = FaultInjector()
        engine = _spec_engine(name, params, cfg, faults=inj)
        engine.warmup((8,))
        futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS,
                              **SAMPLING[i]) for i, p in enumerate(prompts)]
        while not all(f.done() for f in futs):
            engine.step()
        outs = [f.result(timeout=0) for f in futs]
        exempt = _check_f32(f"f32 spec {name}", prompts, outs, refs)
        vs_plain = _check_f32(f"f32 spec {name} vs plain", prompts, outs,
                              [(o, r[1]) for o, r in zip(plain_outs, refs)])
        st = engine.stats()
        acc, tpt = st["spec_acceptance_ratio"], st["tokens_per_tick"]["mean"]
        if name == "self" and not (acc is not None and acc >= 0.9
                                   and tpt > 1):
            raise AssertionError(f"f32 self-draft: acceptance {acc}, "
                                 f"{tpt} tokens a tick")
        A.flash_fwd_launches = 0
        PA.paged_attend_launches = 0
        futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS,
                              **SAMPLING[i]) for i, p in enumerate(prompts)]
        run = _burst_with_faults(engine, inj, futs,
                                 [("decode_tick", "raise", SPEC_FAULT_AT)])
        launches = {"flash_fwd": A.flash_fwd_launches,
                    "paged_attend": PA.paged_attend_launches}
        fault_exempt = _check_f32(f"f32 spec {name} faulted", prompts,
                                  [f.result(timeout=0) for f in futs], refs)
        st = _durability_checks(f"f32 spec {name} faulted", engine,
                                launches, 1, captures=2)
        out[name] = {"exemptions": exempt, "exemptions_vs_plain": vs_plain,
                     "acceptance": acc, "tokens_per_tick_mean": tpt,
                     "faulted_exemptions": fault_exempt,
                     "recovery_s": run["recovery_s"],
                     "requests_resumed": st["requests_resumed"],
                     "launches": launches}
        log(f"speculative f32 {name}: {len(prompts)} requests (half "
            f"sampled) equal the oracles and the plain engine ({len(exempt)}"
            f" / {len(vs_plain)} near-tie exemptions); acceptance {acc}, "
            f"{tpt:.3f} tokens a tick; through a decode fault "
            f"{len(fault_exempt)} exemptions, {st['requests_resumed']} "
            f"resumes, decode_compilations 2")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _measure_spec(engines: dict, prompts, steps: int, reps: int) -> dict:
    """``_ab_spec``'s measurement: each engine decodes the same prompts,
    interleaved repetitions (the first warm, unmeasured), and tok/s over
    the steps at full occupancy (tokens and wall summed a step, as a
    speculative step emits a varying count).  Returns each engine's
    tok/s, its tokens (every repetition) and its full-occupancy steps."""
    stats = {n: [0, 0.0, [], 0] for n in engines}
    for rep in range(reps + 1):
        for name, eng in engines.items():
            futs = [eng.submit(p, max_new_tokens=steps) for p in prompts]
            while not all(f.done() for f in futs):
                full = eng.slots.active_count == ENGINE["n_slots"]
                before = eng.metrics.tokens_generated.value
                t0 = time.perf_counter()
                eng.step()
                dt = time.perf_counter() - t0
                if full and rep:
                    stats[name][0] += (eng.metrics.tokens_generated.value
                                       - before)
                    stats[name][1] += dt
                    stats[name][3] += 1
            stats[name][2].append([f.result(timeout=0) for f in futs])
    return {n: {"tok_per_s": v[0] / v[1] if v[1] else 0.0,
                "tokens": v[2], "steps": v[3]}
            for n, v in stats.items()}


def _profile_steps(engine, prompts, n_steps: int = 8) -> dict:
    """Host wall a step at full occupancy over ``n_steps`` steps, then
    device busy a step by ``torch.profiler`` over ``n_steps`` more (the
    profiler's host cost stays out of the wall), and which graph the
    profiled steps ran (the speculative tick or the plain one)."""
    from torch.profiler import ProfilerActivity, profile

    futs = [engine.submit(p, max_new_tokens=SPEC_NEW_TOKENS)
            for p in prompts]
    while engine.scheduler.depth or engine._taken:
        engine.step()
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) * 1e3 / n_steps
    spec0, plain0 = engine._spec_tick.runs, engine._tick.runs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in _device_events(prof)) \
        / 1e3 / n_steps
    out = {"steps": n_steps, "step_wall_ms": wall, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall,
           "spec_replays": engine._spec_tick.runs - spec0,
           "plain_replays": engine._tick.runs - plain0}
    while not all(f.done() for f in futs):
        engine.step()
    return out


def spec_leg_bf16(name: str, params, cfg, plain, prompts, card, *,
                  label: str = "", new_tokens: int = SPEC_NEW_TOKENS,
                  reps: int = SPEC_REPS) -> dict:
    """One draft source's bf16 leg against the plain engine ``plain``:
    the measured repetitions (the main path's run: the launch counters
    read 0 before and are read after), acceptance, tokens a tick, each
    graph's replays, the step's profile, then the HTTP burst.  ``label``
    names the leg (the draft source by default); the random legs' n-gram
    draft must fall back to the plain graph, a repetitive leg need not."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import ServingServer

    label = label or name
    engine = _spec_engine(name, params, cfg)
    t0 = time.monotonic()
    engine.warmup([len(prompts[0])])
    warm_s = time.monotonic() - t0
    graphs0 = _admission_graphs(engine)
    if graphs0["decode_compilations"] != 2:
        raise AssertionError(f"spec {label}: decode_compilations "
                             f"{graphs0['decode_compilations']} after warmup")
    spec0, plain0 = engine._spec_tick.runs, engine._tick.runs
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    PA.paged_attend_launches_by_rows.clear()
    m = _measure_spec({"spec": engine, "plain": plain}, prompts,
                      new_tokens, reps)
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches,
                "paged_attend_by_rows": dict(PA.paged_attend_launches_by_rows)}
    spec_replays = engine._spec_tick.runs - spec0
    plain_replays = engine._tick.runs - plain0
    st = engine.stats()
    verify_rows = FULL["n_heads"] // FULL["n_kv_heads"] * (SPEC_K + 1)
    if not (launches["flash_fwd"] > 0 and launches["paged_attend"] > 0
            and launches["paged_attend_by_rows"].get(verify_rows, 0) > 0):
        raise AssertionError(f"spec {label}: the leg missed a kernel: "
                             f"{launches}")
    if label == "ngram" and plain_replays == 0:
        raise AssertionError("spec ngram: the adaptive control never fell "
                             "back to the plain graph")
    ratio = m["spec"]["tok_per_s"] / m["plain"]["tok_per_s"]
    prof = _profile_steps(engine, prompts)
    # The HTTP burst: half sampled, one request opted out.
    srv = ServingServer(engine, port=0, request_timeout=600).start()
    url = "http://%s:%d/generate" % srv.address
    results = [None] * len(prompts)

    def client(i):
        results[i] = _post(url, {"tokens": prompts[i],
                                 "max_new_tokens": SPEC_NEW_TOKENS // 2,
                                 "speculative": i != 2, **SAMPLING[i]})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    srv.stop()
    for i, res in enumerate(results):
        if res is None or res[0] != 200 or \
                len(res[1]["tokens"]) != SPEC_NEW_TOKENS // 2:
            raise AssertionError(f"spec {label}: HTTP request {i} failed: "
                                 f"{res and res[0]}")
    graphs1 = _admission_graphs(engine)
    if graphs1 != graphs0:
        raise AssertionError(f"spec {label}: captured past the warmup: "
                             f"{graphs0} before, {graphs1} after")
    out = {"draft": name, "leg": label, "warmup_s": warm_s,
           "spec_tok_per_s": m["spec"]["tok_per_s"],
           "plain_tok_per_s": m["plain"]["tok_per_s"],
           "spec_over_plain": ratio,
           "full_steps": {n: v["steps"] for n, v in m.items()},
           "equal_tokens_to_plain": m["spec"]["tokens"] == m["plain"]["tokens"],
           "acceptance": st["spec_acceptance_ratio"],
           "tokens_per_tick_mean": st["tokens_per_tick"]["mean"],
           "spec_slots_live": st["spec_slots_live"],
           "spec_replays": spec_replays, "plain_replays": plain_replays,
           "launches": launches, "profile": prof,
           "decode_compilations": graphs1["decode_compilations"],
           "admission_graphs": graphs1}
    log(f"speculative bf16 {label} on {card}: {out['spec_tok_per_s']:.1f} "
        f"tok/s against plain {out['plain_tok_per_s']:.1f} "
        f"({ratio:.3f}x, full-occupancy steps); acceptance "
        f"{out['acceptance']}, {out['tokens_per_tick_mean']:.3f} tokens a "
        f"tick; replays spec {spec_replays} plain {plain_replays}; step "
        f"{prof['step_wall_ms']:.3f} ms wall, {prof['device_busy_ms']:.3f} "
        f"ms device (idle {prof['idle_share']:.3f}; {prof['spec_replays']} "
        f"spec / {prof['plain_replays']} plain replays); tokens equal to "
        f"plain: {out['equal_tokens_to_plain']}; launches {launches}; "
        "HTTP burst full, decode_compilations 2, no capture past warmup")
    engine.terminate("speculative leg done")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spec_full_width(card: str) -> dict:
    """The bf16 legs of every draft source (``SPEC_DRAFTS``) against one
    plain engine, on the serving phase's configuration."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, FULL["vocab_size"], SPEC_PROMPT_LEN).tolist()
               for _ in range(ENGINE["n_slots"])]
    plain = InferenceEngine(params, cfg, EngineConfig(**ENGINE))
    plain.warmup([SPEC_PROMPT_LEN])
    out = {"prompt_len": SPEC_PROMPT_LEN, "new_tokens": SPEC_NEW_TOKENS,
           "reps": SPEC_REPS, "spec_k": SPEC_K, "legs": {}}
    for name in SPEC_DRAFTS:
        out["legs"][name] = spec_leg_bf16(name, params, cfg, plain, prompts,
                                          card)
    del plain, params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("spec_repetitive"):
        out["legs"]["repetitive"] = spec_repetitive(cfg, card)
    return out


def _cyclic_batch(rng, V: int, n: int, s: int):
    """_ab_spec's corpus: ``n`` rows of ``s`` tokens cycling through a
    block of ``REP_PERIOD`` ids from a random phase, and their next
    tokens."""
    block = rng.integers(0, V // REP_PERIOD, n)
    start = rng.integers(0, REP_PERIOD, n)
    ar = np.arange(s)[None, :]
    toks = block[:, None] * REP_PERIOD + (start[:, None] + ar) % REP_PERIOD
    nxt = block[:, None] * REP_PERIOD + (start[:, None] + 1 + ar) % REP_PERIOD
    return {"tokens": torch.as_tensor(toks, device="cuda"),
            "targets": torch.as_tensor(nxt, device="cuda")}


def _train_repetitive(cfg) -> tuple:
    """The repetitive leg's target: ``REP_TRAIN_STEPS`` steps of the
    port's trainer (``spmd.make_train_step`` over a size-1 NCCL group,
    AdamW at ``REP_LR``, f32 masters, bf16 compute) on the cyclic corpus
    -> (bf16 serving parameters, losses)."""
    from horovod_tpu_torch import basics, optim, spmd
    from horovod_tpu_torch.models import transformer as T

    params = T.init_params(cfg, seed=11, param_dtype=torch.float32)
    named = optim.named_parameters(params)
    for _, t in named:
        t.requires_grad_()
    rng = np.random.default_rng(5)
    losses = []
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        opt = optim.DistributedOptimizer(
            torch.optim.AdamW([t for _, t in named], lr=REP_LR,
                              weight_decay=1e-4),
            named_parameters=named)
        step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
        for _ in range(REP_TRAIN_STEPS):
            batch = _cyclic_batch(rng, cfg.vocab_size, REP_BATCH, REP_SEQ)
            losses.append(float(step(params, batch)))
    finally:
        basics.shutdown()
    if not all(math.isfinite(x) for x in losses) or not \
            losses[-1] < losses[0]:
        raise AssertionError(f"repetitive training: losses {losses}")

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.detach().to(cfg.dtype)

    serve = cast(params)
    del params, named, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return serve, losses


def spec_repetitive(cfg, card: str) -> dict:
    """_ab_spec's repetitive leg at full width: a target trained on the
    cyclic corpus (:func:`_train_repetitive`), the n-gram draft against
    the plain engine on cyclic prompts (:func:`spec_leg_bf16`); the
    speculative tokens must equal the plain engine's."""
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine

    t0 = time.monotonic()
    params, losses = _train_repetitive(cfg)
    train_s = time.monotonic() - t0
    V = cfg.vocab_size
    prompts = [((b % (V // REP_PERIOD)) * REP_PERIOD
                + np.arange(REP_PROMPT_LEN) % REP_PERIOD).tolist()
               for b in range(ENGINE["n_slots"])]
    plain = InferenceEngine(params, cfg, EngineConfig(**ENGINE))
    plain.warmup([REP_PROMPT_LEN])
    leg = spec_leg_bf16("ngram", params, cfg, plain, prompts, card,
                        label="repetitive", new_tokens=REP_NEW_TOKENS,
                        reps=REP_REPS)
    if not leg["equal_tokens_to_plain"]:
        raise AssertionError("spec repetitive: the speculative tokens differ "
                             "from the plain engine's")
    leg.update(train_losses=losses, train_s=train_s,
               new_tokens=REP_NEW_TOKENS, reps=REP_REPS,
               prompt_len=REP_PROMPT_LEN)
    log(f"speculative bf16 repetitive on {card}: trained {REP_TRAIN_STEPS} "
        f"steps in {train_s:.1f} s (loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}); {leg['spec_tok_per_s']:.1f} tok/s against "
        f"plain {leg['plain_tok_per_s']:.1f} ({leg['spec_over_plain']:.3f}x)"
        f", acceptance {leg['acceptance']}; tokens equal to plain")
    del plain, params
    gc.collect()
    torch.cuda.empty_cache()
    return leg


def _tick_p25(engines: dict, prompt, steps: int, reps: int) -> dict:
    """_ab_paged's and paged_decode_ab.py's measurement: each engine
    decodes ``n_slots`` copies of ``prompt`` for ``steps`` tokens, the
    engines in turns, ``reps`` times; a step's host wall counts when
    every slot was busy before and after it.  -> each engine's p25 step
    ms, its tok/s at that p25, the steps counted and its tokens."""
    S = ENGINE["n_slots"]
    dts = {n: [] for n in engines}
    toks = {n: [] for n in engines}
    for _ in range(reps):
        for name, eng in engines.items():
            futs = [eng.submit(prompt, max_new_tokens=steps)
                    for _ in range(S)]
            while not all(f.done() for f in futs):
                full = eng.slots.active_count == S
                t0 = time.perf_counter()
                eng.step()
                dt = time.perf_counter() - t0
                if full and eng.slots.active_count == S:
                    dts[name].append(dt)
            toks[name].extend(f.result(timeout=0) for f in futs)
    out = {}
    for name, d in dts.items():
        p25 = float(np.percentile(d, 25))
        out[name] = {"tick_ms_p25": p25 * 1e3, "tok_per_s": S / p25,
                     "ticks": len(d), "tokens": toks[name]}
    return out


def _agreement(a: list, b: list) -> float:
    """The share of positions at which two lists of token lists agree."""
    same = total = 0
    for x, y in zip(a, b):
        same += sum(int(p == q) for p, q in zip(x, y))
        total += max(len(x), len(y))
    return same / total


def unpaged_full_width(card: str, sampler_ms: float) -> dict:
    """The slot-contiguous cache (``EngineConfig(paged=False)``) at full
    width, by benchmarks/serving.py's ``_ab_paged`` protocol.

    Gates: the f32 engine's tokens (token_identity's prompts, half
    sampled) equal the oracles and the paged engine's, by the near-tie
    rule; through a decode fault the same, with one restart, its slot
    cache reset in place and its tick captured once; the captured
    contiguous tick equals its eager body (:func:`graph_vs_eager`).
    Measured: bf16 decode at the p25 step, paged against unpaged in
    turns (the main path's run: the launch counters read 0 before it and
    are read after); each tick's device busy and idle share; the most
    concurrent requests at a budget of 2 x max_len cache tokens."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import (EngineConfig, FaultInjector,
                                           InferenceEngine)

    o = F32_ORACLE
    prompts, refs = o["prompts"], o["refs"]
    inj = FaultInjector()
    engine = InferenceEngine(o["params"], o["cfg"],
                             EngineConfig(**ENGINE, paged=False, faults=inj))
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS, **SAMPLING[i])
            for i, p in enumerate(prompts)]
    while not all(f.done() for f in futs):
        engine.step()
    outs = [f.result(timeout=0) for f in futs]
    exempt = _check_f32("f32 unpaged", prompts, outs, refs)
    vs_paged = _check_f32("f32 unpaged vs paged", prompts, outs,
                          [(po, r[1]) for po, r in zip(o["paged_outs"],
                                                       refs)])
    ptrs = [t.data_ptr() for t in engine.slots.cache.values()]
    A.flash_fwd_launches = PA.paged_attend_launches = 0
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS, **SAMPLING[i])
            for i, p in enumerate(prompts)]
    run = _burst_with_faults(engine, inj, futs,
                             [("decode_tick", "raise", F32_FAULTS[1][2])])
    fault_exempt = _check_f32("f32 unpaged faulted", prompts,
                              [f.result(timeout=0) for f in futs], refs)
    st = _durability_checks("f32 unpaged faulted", engine,
                            {"flash_fwd": A.flash_fwd_launches}, 1)
    if PA.paged_attend_launches or engine._tick.captures != 1 or \
            [t.data_ptr() for t in engine.slots.cache.values()] != ptrs:
        raise AssertionError(
            f"f32 unpaged faulted: K4 launches {PA.paged_attend_launches}, "
            f"tick captures {engine._tick.captures}, the cache moved: "
            f"{[t.data_ptr() for t in engine.slots.cache.values()] != ptrs}")
    f32 = {"exemptions": exempt, "exemptions_vs_paged": vs_paged,
           "faulted_exemptions": fault_exempt,
           "recovery_s": run["recovery_s"],
           "requests_resumed": st["requests_resumed"]}
    log(f"unpaged f32: {len(prompts)} requests (half sampled) equal the "
        f"oracles and the paged engine ({len(exempt)} / {len(vs_paged)} "
        f"near-tie exemptions); through a decode fault {len(fault_exempt)} "
        f"exemptions, {st['requests_resumed']} resumes, restarts 1, "
        "decode_compilations 1, the slot cache reset in place")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    cfg = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0)
    prompt = np.random.default_rng(3).integers(
        0, FULL["vocab_size"], AB_PROMPT_LEN).tolist()
    engines = {"paged": InferenceEngine(params, cfg, EngineConfig(**ENGINE)),
               "unpaged": InferenceEngine(params, cfg, EngineConfig(
                   **ENGINE, paged=False))}
    for eng in engines.values():
        eng.warmup([AB_PROMPT_LEN])
    graphs0 = {n: _admission_graphs(e) for n, e in engines.items()}
    _zero_launches()
    m = _tick_p25(engines, prompt, AB_NEW_TOKENS, AB_REPS)
    launches = _launches()
    del launches["grouped_matmul"]
    graphs1 = {n: _admission_graphs(e) for n, e in engines.items()}
    if graphs1 != graphs0 or any(g["decode_compilations"] != 1
                                 for g in graphs1.values()):
        raise AssertionError(f"unpaged A/B: captures past the warmup: "
                             f"{graphs0} -> {graphs1}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"unpaged A/B missed a kernel: {launches}")
    agree = _agreement(m["paged"]["tokens"], m["unpaged"]["tokens"])
    profiles = {n: profile_decode(e, f"{n}_overlap", sampler_ms)
                for n, e in engines.items()}
    check = graph_vs_eager(engines["unpaged"])  # ends the engine
    del engines
    gc.collect()
    torch.cuda.empty_cache()

    # Capacity at a fixed budget of cache tokens: pages of the budget for
    # the paged engine, budget // max_len slots for the contiguous one.
    budget = 2 * ENGINE["max_len"]
    rng = np.random.default_rng(4)
    cap_prompts = [rng.integers(0, FULL["vocab_size"], n).tolist()
                   for n in PROMPT_LENS * 2]
    capacity = {"budget_tokens": budget}
    for name, kw in (("paged", dict(n_pages=budget // ENGINE["page_size"])),
                     ("unpaged", dict(paged=False,
                                      n_slots=budget // ENGINE["max_len"]))):
        eng = InferenceEngine(params, cfg, EngineConfig(**{
            **ENGINE, "max_prefills_per_tick": ENGINE["n_slots"], **kw}))
        futs = [eng.submit(p, max_new_tokens=CAPACITY_NEW_TOKENS)
                for p in cap_prompts]
        peak = 0
        t0 = time.monotonic()
        while not all(f.done() for f in futs):
            eng.step()
            peak = max(peak, eng.slots.active_count)
        wall = time.monotonic() - t0
        if any(len(f.result(timeout=0)) != CAPACITY_NEW_TOKENS
               for f in futs):
            raise AssertionError(f"capacity {name}: a request fell short")
        capacity[name] = {"peak_concurrent": peak, "wall_s": wall,
                          "preemptions": eng.stats()["preemptions"]}
        eng.terminate("capacity leg done")
        del eng
    out = {"f32": f32, "prompt_len": AB_PROMPT_LEN,
           "new_tokens": AB_NEW_TOKENS, "reps": AB_REPS,
           "tick_ms_p25": {n: v["tick_ms_p25"] for n, v in m.items()},
           "tok_per_s": {n: v["tok_per_s"] for n, v in m.items()},
           "ticks_counted": {n: v["ticks"] for n, v in m.items()},
           "unpaged_over_paged_tick": m["unpaged"]["tick_ms_p25"]
           / m["paged"]["tick_ms_p25"],
           "bf16_token_agreement": agree, "launches": launches,
           "profiles": profiles, "graph_vs_eager": check,
           "capacity": capacity}
    log(f"unpaged bf16 on {card}: p25 step paged "
        f"{out['tick_ms_p25']['paged']:.3f} ms vs unpaged "
        f"{out['tick_ms_p25']['unpaged']:.3f} ms "
        f"({out['unpaged_over_paged_tick']:.3f}x), tok/s "
        f"{out['tok_per_s']['paged']:.1f} vs {out['tok_per_s']['unpaged']:.1f}"
        f"; device busy {profiles['paged']['device_busy_ms']:.3f} vs "
        f"{profiles['unpaged']['device_busy_ms']:.3f} ms (idle "
        f"{profiles['paged']['idle_share']:.3f} vs "
        f"{profiles['unpaged']['idle_share']:.3f}); bf16 tokens agree "
        f"{agree:.4f}; capacity at {budget} cache tokens: paged "
        f"{capacity['paged']['peak_concurrent']} concurrent "
        f"({capacity['paged']['preemptions']} preemptions), unpaged "
        f"{capacity['unpaged']['peak_concurrent']}; launches {launches}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _attn_bytes(kv_dtype) -> dict:
    """paged_decode_ab.py's analytic attention bytes a tick over the
    serving pool (the full table row, ``MP`` pages a slot a layer, both
    paths): fused ``E * stored [+ scales]``, unfused ``3 * E * stored
    [+ scales] [+ 2 * E * compute]`` per K or V, ``E = S * H_kv * MP *
    page * Dh``."""
    ps = ENGINE["page_size"]
    mp = -(-ENGINE["max_len"] // ps)
    hkv, dh = FULL["n_kv_heads"], FULL["d_model"] // FULL["n_heads"]
    S = ENGINE["n_slots"]
    elems = S * hkv * mp * ps * dh
    quant = kv_dtype == "int8"
    stored = 1 if quant else 2
    scales = S * hkv * mp * ps * 4 if quant else 0
    fused = FULL["n_layers"] * 2 * (elems * stored + scales)
    unfused = FULL["n_layers"] * 2 * (3 * elems * stored + scales
                                      + (2 * elems * 2 if quant else 0))
    return {"fused": fused, "unfused": unfused, "ratio": unfused / fused}


def paged_kernel_ab(card: str, sampler_ms: float) -> dict:
    """benchmarks/paged_decode_ab.py's protocol at full width: two
    engines over the same parameters, ``paged_kernel=None`` (K4) and
    ``False`` (the gathered pages).  Gates: the f32 gather engine's
    tokens equal the oracles and the K4 engine's (token_identity's), by
    the near-tie rule, with no K4 launch; over each pool (the model's
    bf16, int8) the K4 engine launches K4 once a layer a replay and the
    gather engine never.  Measured: the p25 step of each in turns (the
    main path's run), the tick's device busy, the analytic attention
    bytes, and (reported, not gated) the bf16 tokens' agreement."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine

    o = F32_ORACLE
    prompts, refs = o["prompts"], o["refs"]
    engine = InferenceEngine(o["params"], o["cfg"],
                             EngineConfig(**ENGINE, paged_kernel=False))
    k4 = PA.paged_attend_launches
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS, **SAMPLING[i])
            for i, p in enumerate(prompts)]
    while not all(f.done() for f in futs):
        engine.step()
    outs = [f.result(timeout=0) for f in futs]
    if (PA.paged_attend_launches != k4 or engine._tick.k4_launches_per_replay
            or engine.stats()["paged_kernel_engaged"] is not False):
        raise AssertionError("f32 gather engine launched K4")
    exempt = _check_f32("f32 gather", prompts, outs, refs)
    vs_k4 = _check_f32("f32 gather vs K4", prompts, outs,
                       [(po, r[1]) for po, r in zip(o["paged_outs"], refs)])
    out = {"f32": {"exemptions": exempt, "exemptions_vs_k4": vs_k4},
           "prompt_len": AB_PROMPT_LEN, "new_tokens": AB_NEW_TOKENS,
           "reps": KERNEL_AB_REPS, "pools": {}}
    log(f"paged_kernel f32: the gather engine's {len(prompts)} requests "
        f"equal the oracles and the K4 engine's ({len(exempt)} / "
        f"{len(vs_k4)} near-tie exemptions), no K4 launch")
    del engine
    gc.collect()

    cfg = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0)
    prompt = np.random.default_rng(3).integers(
        0, FULL["vocab_size"], AB_PROMPT_LEN).tolist()
    launches = {"flash_fwd": 0, "paged_attend": 0}
    for kv in KERNEL_AB_POOLS:
        pool = kv or "bf16"
        engines = {"k4": InferenceEngine(params, cfg, EngineConfig(
                       **ENGINE, kv_dtype=kv)),
                   "gather": InferenceEngine(params, cfg, EngineConfig(
                       **ENGINE, kv_dtype=kv, paged_kernel=False))}
        for eng in engines.values():
            eng.warmup([AB_PROMPT_LEN])
        per = {n: e._tick.k4_launches_per_replay for n, e in engines.items()}
        if per != {"k4": FULL["n_layers"], "gather": 0}:
            raise AssertionError(f"paged_kernel {pool}: K4 a replay {per}")
        replays = engines["k4"]._tick.replays
        _zero_launches()
        m = _tick_p25(engines, prompt, AB_NEW_TOKENS, KERNEL_AB_REPS)
        run = _launches()
        k4_ticks = engines["k4"]._tick.replays - replays
        if run["paged_attend"] != k4_ticks * FULL["n_layers"] or \
                not run["flash_fwd"]:
            raise AssertionError(
                f"paged_kernel {pool}: {run['paged_attend']} K4 launches "
                f"for {k4_ticks} K4 ticks; K1 {run['flash_fwd']}")
        for k in launches:
            launches[k] += run[k]
        profiles = {n: profile_decode(e, f"{pool}_{n}_overlap", sampler_ms)
                    for n, e in engines.items()}
        leg = {"tick_ms_p25": {n: v["tick_ms_p25"] for n, v in m.items()},
               "tok_per_s": {n: v["tok_per_s"] for n, v in m.items()},
               "ticks_counted": {n: v["ticks"] for n, v in m.items()},
               "gather_over_k4_tick": m["gather"]["tick_ms_p25"]
               / m["k4"]["tick_ms_p25"],
               "token_agreement": _agreement(m["k4"]["tokens"],
                                             m["gather"]["tokens"]),
               "k4_ticks": k4_ticks, "attn_bytes": _attn_bytes(kv),
               "profiles": {n: {k: p[k] for k in (
                   "tick_wall_ms", "device_busy_ms", "idle_share",
                   "paged_attend_ms")} for n, p in profiles.items()}}
        out["pools"][pool] = leg
        log(f"paged_kernel {pool} pool on {card}: p25 step K4 "
            f"{leg['tick_ms_p25']['k4']:.3f} ms vs gather "
            f"{leg['tick_ms_p25']['gather']:.3f} ms "
            f"({leg['gather_over_k4_tick']:.3f}x); device busy "
            f"{profiles['k4']['device_busy_ms']:.3f} vs "
            f"{profiles['gather']['device_busy_ms']:.3f} ms; analytic "
            f"attention bytes a tick {leg['attn_bytes']['fused']} vs "
            f"{leg['attn_bytes']['unfused']} "
            f"({leg['attn_bytes']['ratio']:.3f}x); tokens agree "
            f"{leg['token_agreement']:.4f}; K4 {run['paged_attend']} "
            f"launches over {k4_ticks} ticks, none in the gather engine")
        for eng in engines.values():
            eng.terminate("paged_kernel A/B done")
        del engines
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = launches
    del params
    torch.cuda.empty_cache()
    return out


def model_grads_f32() -> dict:
    """f32 loss and every parameter gradient of a 2-layer model, TF32 off:
    attention by K1-K3 against the plain softmax attention (tolerance
    1e-4 of each parameter's largest gradient: f32 summation order), and
    remat ``full`` and ``dots`` against no remat, both through K1-K3
    (tolerance 1e-5: the recompute runs the same kernels on the same
    inputs)."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.optim import named_parameters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dict(FULL, n_layers=2, max_seq=512)
    grads = {}
    for name, impl, remat in (("flash", "flash", None),
                              ("reference", "reference", None),
                              ("remat_full", "flash", "full"),
                              ("remat_dots", "flash", "dots")):
        cfg = T.TransformerConfig(**dict(small, attention_impl=impl),
                                  dtype=torch.float32,
                                  remat=remat is not None,
                                  remat_policy=remat or "full")
        params = T.init_params(cfg, seed=1, param_dtype=torch.float32)
        named = named_parameters(params)
        for _, t in named:
            t.requires_grad_()
        batch = T.synthetic_batch(1, cfg, 2, 512)
        loss = T.loss_fn(params, batch, cfg)
        loss.backward()
        grads[name] = (loss.item(), {n: t.grad for n, t in named})
    lf, gf = grads["flash"]
    out = {"loss_flash": lf}
    for other, tol in (("reference", 1e-4), ("remat_full", 1e-5),
                       ("remat_dots", 1e-5)):
        lo, go = grads[other]
        errs = {n: ((go[n] - gf[n]).abs().max() / gf[n].abs().max()).item()
                for n in gf}
        worst = max(errs, key=errs.get)
        log(f"model f32 (L=2, d1024, H16, kv4, seq 512, batch 2): loss "
            f"flash {lf:.7f} {other} {lo:.7f}; worst gradient {worst} "
            f"rel_err {errs[worst]:.3e} tol {tol:.0e}")
        if not (abs(lo - lf) <= 1e-5 * abs(lf) and errs[worst] <= tol):
            raise AssertionError(f"the {other} model gradients disagree "
                                 "with the flash path's")
        out[f"loss_{other}"] = lo
        out[f"grad_rel_err_{other}"] = errs
    del grads, gf
    torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def profile_train_step(step, params, batch, flash: bool = True) -> dict:
    """One more step under ``torch.profiler``: device time by kernel,
    against that step's own wall time (the profiler slows the host).
    ``flash``: the step runs K1-K3 (the LM's), whose share is reported
    and whose bf16 K3 must be the tensor-core kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = {e.key: e.self_device_time_total / 1e3
               for e in _device_events(prof)}
    busy = sum(kernels.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")

    def ms(tag):
        return sum(t for k, t in kernels.items() if tag in k)

    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms,
           "top_kernels_ms": {k[:70]: t for k, t in sorted(
               kernels.items(), key=lambda kv: -kv[1])[:10]}}
    if not flash:
        log(f"step profile: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
            f"(idle share {out['idle_share']:.3f})")
        return out
    out.update({"flash_fwd_ms": ms("flash_fwd_kernel"),
                "flash_bwd_dkdv_ms": ms("flash_bwd_dkdv_kernel"),
                "flash_bwd_dq_ms": ms("flash_bwd_dq_kernel"),
                "grouped_matmul_ms": ms("grouped_mm_kernel"),
                "grouped_matmul_dw_ms": ms("grouped_dw_kernel")})
    k13 = out["flash_fwd_ms"] + out["flash_bwd_dkdv_ms"] + \
        out["flash_bwd_dq_ms"]
    out["flash_share_of_busy"] = k13 / busy
    if not any("flash_bwd_dq_kernel_wgmma" in k for k in kernels):
        raise AssertionError("the bf16 step did not run K3 on wgmma: "
                             f"{sorted(kernels)[:20]}")
    log(f"train step profile: device busy {busy:.1f} ms of {wall_ms:.1f} "
        f"ms (idle share {out['idle_share']:.3f}); K1 "
        f"{out['flash_fwd_ms']:.1f}, K2 {out['flash_bwd_dkdv_ms']:.1f}, K3 "
        f"{out['flash_bwd_dq_ms']:.1f} ms ({out['flash_share_of_busy']:.1%}"
        f" of busy); G1 {out['grouped_matmul_ms']:.1f}, G2 "
        f"{out['grouped_matmul_dw_ms']:.1f} ms "
        f"({out['grouped_matmul_dw_ms'] / busy:.1%} of busy)")
    return out


TRAIN_LEGS = ("eager", "remat_full", "remat_dots", "captured")


def _train_leg(name: str) -> dict:
    """One training leg at full width: 10 steps from ``init_params`` seed
    0 on one fixed batch.  ``eager`` and the remat legs call the step's
    eager body (``TrainStep.body``); ``captured`` calls the step itself,
    which warms up eagerly, captures one CUDA graph and replays it.
    The K1-K3 counters read 0 just before the steps and are read just
    after them."""
    from horovod_tpu_torch import optim, spmd
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A

    remat = name.startswith("remat")
    cfg = T.TransformerConfig(**TRAIN, dtype=torch.bfloat16, remat=remat,
                              remat_policy=name[6:] if remat else "full")
    params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
    named = optim.named_parameters(params)
    for _, t in named:
        t.requires_grad_()
    n_params = sum(t.numel() for _, t in named)
    n_matmul = n_params - params["embed"].numel()
    opt = optim.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in named], lr=3e-4,
                          betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
        named_parameters=named)
    step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
    if not step.graphed:
        raise AssertionError("make_train_step did not capture on CUDA")
    run = step if name == "captured" else step.body
    B, S = TRAIN_BATCH, TRAIN["max_seq"]
    batch = T.synthetic_batch(0, cfg, B, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.flash_fwd_launches = 0
    A.flash_bwd_dkdv_launches = 0
    A.flash_bwd_dq_launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.monotonic()
        losses.append(float(run(params, batch)))  # waits for the card
        times.append(time.monotonic() - t0)
    launches = {"flash_fwd": A.flash_fwd_launches,
                "flash_bwd_dkdv": A.flash_bwd_dkdv_launches,
                "flash_bwd_dq": A.flash_bwd_dq_launches}
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times)
    # Useful work only: a remat leg's recompute is not counted.
    flops = 6 * n_matmul * B * S + 6 * cfg.n_layers * B * S * S * \
        cfg.d_model
    out = {"params": n_params, "matmul_params": n_matmul,
           "losses": losses, "step_s": times, "step_s_median": step_s,
           "tokens_per_s": B * S / step_s, "step_flops": flops,
           "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
           "bound_step_ms": flops / PEAK_FLOPS[torch.bfloat16] * 1e3,
           "peak_mem_gb": peak / 1e9, "launches": launches,
           "captures": step.captures, "replays": step.replays}
    log(f"train [{name}] losses: {[round(x, 4) for x in losses]}")
    log(f"train [{name}]: {n_params} params, median step "
        f"{step_s * 1e3:.1f} ms, {out['tokens_per_s']:.0f} tok/s, MFU "
        f"{out['mfu']:.4f} (useful FLOP only; bound "
        f"{out['bound_step_ms']:.1f} ms a step), peak memory "
        f"{out['peak_mem_gb']:.2f} GB, launches {launches}, captures "
        f"{step.captures}, replays {step.replays}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    L = cfg.n_layers * TRAIN_STEPS
    want = {"flash_fwd": 2 * L if remat else L, "flash_bwd_dkdv": L,
            "flash_bwd_dq": L}
    if launches != want:
        raise AssertionError(f"[{name}] expected K1-K3 launches {want}, got "
                             f"{launches}")
    if name == "captured" and (step.captures != 1 or step.replays
                               != TRAIN_STEPS - spmd.WARMUP_STEPS):
        raise AssertionError(f"captured leg: {step.captures} captures, "
                             f"{step.replays} replays")
    out["profile"] = profile_train_step(run, params, batch)
    del params, opt, step, run, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_full_width() -> dict:
    """The main training path, through the entry points a user calls, in
    four legs (``TRAIN_LEGS``) on a size-1 NCCL group: each remat leg's
    and the captured leg's losses equal the eager leg's within 1e-3
    relative a step, and each remat leg's peak memory is below the eager
    leg's."""
    from horovod_tpu_torch import basics

    # The serving engines hold themselves in reference cycles (the
    # scheduler's callbacks): collect them, so that the peak memory
    # below is the training run's own.
    gc.collect()
    torch.cuda.empty_cache()
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        legs = {name: _train_leg(name) for name in TRAIN_LEGS}
    finally:
        basics.shutdown()
    eager = legs["eager"]
    for name in TRAIN_LEGS[1:]:
        gap = max(abs(a - b) / abs(b) for a, b in
                  zip(legs[name]["losses"], eager["losses"]))
        legs[name]["loss_gap_vs_eager"] = gap
        log(f"train [{name}] largest loss gap against eager: {gap:.3e} "
            "(limit 1e-3 relative)")
        if gap > 1e-3:
            raise AssertionError(f"[{name}] losses differ from eager's by "
                                 f"{gap:.3e}")
        if name.startswith("remat") and not (
                legs[name]["peak_mem_gb"] < eager["peak_mem_gb"]):
            raise AssertionError(f"[{name}] peak memory "
                                 f"{legs[name]['peak_mem_gb']:.2f} GB is not "
                                 f"below eager's {eager['peak_mem_gb']:.2f}")
    launches = {k: sum(leg["launches"][k] for leg in legs.values())
                for k in eager["launches"]}
    return {"legs": legs, "launches": launches}


# --- the sequence_parallel phase: ring, zigzag ring and Ulysses -------------

# The virtual ring: SP_P ranks' shards of one SP_S-token sequence on the
# card (B = 1, H = 16, D = 64, H_kv in SP_KV), each rank's chunk calls the
# ring's own, bf16 and f32.  Tolerances relative to the largest value, as
# check_flash_bwd's.
SP_P, SP_S, SP_H, SP_D, SP_KV = 4, 8192, 16, 64, (16, 4)
SP_MODES = ("ring_causal", "ring_full", "zigzag")
SP_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The training legs at sp = 1 (TRAIN at full width, captured) and each
# impl's K1 (= K2 = K3) calls a layer a step.
SP_TRAIN_CHUNKS = {"ring": 1, "ring_zigzag": 3, "ulysses": 1}
# The prefill leg: a ring config and the same weights under flash, one
# burst each.
SP_ENGINE = dict(n_slots=4, max_len=512, max_prefills_per_tick=2,
                 page_size=16, max_queue_depth=16)
SP_PROMPT_LENS, SP_WARM_LENS, SP_NEW_TOKENS = (40, 100, 200, 300), \
    (64, 128, 256, 300), 32


def _sp_inputs(Hkv: int, seed: int):
    """q, k, v and the output's cotangent over the whole sequence, f32
    holding bf16 values, so that one plain oracle serves both dtypes."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(h):
        return torch.randn((1, h, SP_S, SP_D), generator=g, device="cuda"
                           ).to(torch.bfloat16).float()

    return r(SP_H), r(Hkv), r(Hkv), r(SP_H)


def _sp_plain(q, k, v, do, causal: bool):
    """The plain version in f32 over the whole sequence: output and the
    analytic q/k/v gradients from its logsumexp (K2's and K3's plain
    versions; a 16 x 8192^2 f32 score matrix is 4.3 GB)."""
    from horovod_tpu_torch.ops import attention as A

    shift, scale = (0 if causal else None), 1.0 / math.sqrt(SP_D)
    with torch.no_grad():
        o, lse = A._reference_attention_lse(
            q, A.expand_kv(k, SP_H), A.expand_kv(v, SP_H), shift, scale)
        delta = (do * o).sum(-1)
        grads = A._flash_bwd_reference(q, k, v, do, lse, delta, shift,
                                       scale)
    return (o, *grads)


def _sp_whole(q, k, v, do, causal: bool):
    """K1-K3 over the whole sequence: output and q/k/v gradients."""
    from horovod_tpu_torch.ops import attention as A

    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = A.flash_attention(q, k, v, causal)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


def _sp_virtual(q, k, v, do, mode: str):
    """One pass of the virtual ring (``attention._virtual_ring``: every
    rank's shards on the card, the exchange a list rotation), forward and
    backward, the zigzag mode on the data permuted by ``zigzag_perm`` ->
    output and q/k/v gradients over the whole sequence, in its order."""
    from horovod_tpu_torch.ops import attention as A

    zigzag = mode == "zigzag"
    order = torch.as_tensor(A.zigzag_perm(SP_S, SP_P)[0] if zigzag
                            else np.arange(SP_S), device="cuda")
    shards = [[part.contiguous().requires_grad_()
               for part in t[:, :, order].chunk(SP_P, dim=2)]
              for t in (q, k, v)]
    outs = A._virtual_ring(*shards, causal=mode != "ring_full",
                           zigzag=zigzag)
    torch.autograd.backward(outs, list(do[:, :, order].chunk(SP_P, dim=2)))
    inv = torch.argsort(order)

    def whole(parts):
        return torch.cat(parts, dim=2)[:, :, inv]

    return (whole([o.detach() for o in outs]),
            *(whole([t.grad for t in ts]) for ts in shards))


def _flash_counts() -> tuple:
    from horovod_tpu_torch.ops import attention as A

    return (A.flash_fwd_launches, A.flash_bwd_dkdv_launches,
            A.flash_bwd_dq_launches)


def sp_virtual_ring() -> dict:
    """The ring's every chunk call at P = SP_P on one card: for each H_kv,
    dtype and mode (causal ring, non-causal ring, zigzag) one virtual
    pass, held to K1-K3 over the whole sequence (the leg's mask) and to
    the plain version in f32, within SP_TOL; K1, K2 and K3 launched
    once a chunk call (16 a ring pass, 48 a zigzag pass, fully masked
    chunks included), the counters read 0 just before the pass."""
    from horovod_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    cases, failed, total = {}, [], [0, 0, 0]
    for Hkv in SP_KV:
        base = _sp_inputs(Hkv, seed=600 + Hkv)
        plain = {c: _sp_plain(*base, c) for c in (True, False)}
        torch.cuda.empty_cache()
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do = (t.to(dt) for t in base)
            whole = {c: _sp_whole(q, k, v, do, c) for c in (True, False)}
            for mode in SP_MODES:
                causal = mode != "ring_full"
                A.flash_fwd_launches = A.flash_bwd_dkdv_launches = 0
                A.flash_bwd_dq_launches = 0
                got = _sp_virtual(q, k, v, do, mode)
                torch.cuda.synchronize()
                launches = _flash_counts()
                chunks = SP_P * SP_P * (3 if mode == "zigzag" else 1)
                total = [a + b for a, b in zip(total, launches)]
                err_k = max(_rel_err(a, b) for a, b in zip(got, whole[causal]))
                err_p = max(_rel_err(a, b) for a, b in zip(got, plain[causal]))
                name = f"{mode} {str(dt)[6:]} H_kv={Hkv}"
                log(f"sp virtual ring P={SP_P} S={SP_S} [{name}]: rel_err "
                    f"against K1-K3 over the whole sequence {err_k:.3e}, "
                    f"against the f32 plain version {err_p:.3e} (tol "
                    f"{SP_TOL[dt]:.0e}); K1/K2/K3 launches {launches} "
                    f"(chunk calls {chunks})")
                cases[name] = {"rel_err_kernels": err_k,
                               "rel_err_plain": err_p,
                               "launches": launches, "chunks": chunks}
                if not (err_k <= SP_TOL[dt] and err_p <= SP_TOL[dt]
                        and launches == (chunks,) * 3):
                    failed.append(name)
                del got
            del whole, q, k, v, do
        del base, plain
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the virtual ring disagrees or miscounts: "
                             f"{failed}")
    return {"cases": cases, "launches": dict(zip(
        ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"), total))}


def _sp_chunk_tensors(S: int, seed: int):
    """bf16 q, k, v, do of one MHA chunk (B = 1, H = 16, S = T), the
    causal forward's logsumexp and a delta, for the kernels' timing."""
    from horovod_tpu_torch.ops import attention as A

    q, k, v = _k1_inputs(1, SP_H, SP_H, S, SP_D, torch.bfloat16, seed=seed)
    do = torch.randn_like(q)
    o, lse = A._flash_fwd_cuda(q, k, v, 0, 1.0 / math.sqrt(SP_D))
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1)


def sp_balance(card: str) -> dict:
    """Each virtual rank's K1 + K2 + K3 device time (:func:`queued_ms`)
    over its chunk calls of one causal ring pass and one zigzag pass
    (bf16, MHA, shards of SP_S / SP_P), the calls issued straight to the
    kernels with each call's shift; the max over the mean across the
    ranks."""
    from horovod_tpu_torch.ops import attention as A

    n, scale = SP_S // SP_P, 1.0 / math.sqrt(SP_D)
    out = {}
    for mode, zigzag in (("ring", False), ("zigzag", True)):
        q, k, v, do, lse, delta = _sp_chunk_tensors(n // 2 if zigzag else n,
                                                    seed=700)
        ranks = []
        for me in range(SP_P):
            shifts = [shift for s in range(SP_P) for _, _, shift in
                      A._ring_blocks(me, (me - s) % SP_P, SP_P, n, True,
                                     zigzag)]

            def run(shifts=shifts):
                for shift in shifts:
                    A._flash_fwd_cuda(q, k, v, shift, scale)
                    A._flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, shift,
                                           scale)
                    A._flash_bwd_dq_cuda(q, k, v, do, lse, delta, shift,
                                         scale)

            ranks.append(queued_ms(run, n=3))
        mean = statistics.mean(ranks)
        out[mode] = {"rank_ms": ranks, "max_over_mean": max(ranks) / mean,
                     "max_ms": max(ranks)}
        del q, k, v, do, lse, delta
    log(f"sp balance on {card} (K1+K2+K3 device ms a virtual rank, P="
        f"{SP_P}, shards of {n}, bf16 MHA, queued behind a sleep): ring "
        f"{[round(x, 4) for x in out['ring']['rank_ms']]} max/mean "
        f"{out['ring']['max_over_mean']:.3f}; zigzag "
        f"{[round(x, 4) for x in out['zigzag']['rank_ms']]} max/mean "
        f"{out['zigzag']['max_over_mean']:.3f}; the lockstep ring's step "
        f"pays the slowest rank: ring {out['ring']['max_ms']:.4f} ms, "
        f"zigzag {out['zigzag']['max_ms']:.4f} ms")
    return out


def time_ring_chunks() -> list:
    """K1, K2 and K3 at the ring's chunk shape (B = 1, H = 16 MHA, S = T
    = SP_S / SP_P, D = 64, bf16) for the diagonal (shift 0), a wholly
    visible (shift -T) and a wholly masked (shift T: the dead-tile skip)
    chunk, each beside its bound (the pairs the mask leaves; a wholly
    masked chunk's outputs do not depend on its inputs, so only its
    writes count), its plain version and SDPA on the same mask (causal,
    none, or a boolean mask of False; for K2 and K3 its backward, one
    call for the pair).  Kernel and SDPA by :func:`queued_ms` (a masked
    chunk's kernel is shorter than the host's launching, which CUDA
    events around back-to-back calls time); those events' time beside
    it."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    n, D, scale = SP_S // SP_P, SP_D, 1.0 / math.sqrt(SP_D)
    q, k, v, do, lse, delta = _sp_chunk_tensors(n, seed=701)
    B, H, nq = 1, SP_H, q.numel()
    rows = B * H * n * 4  # one f32 per row: lse, delta
    dead = torch.zeros((n, n), dtype=torch.bool, device="cuda")
    out = []
    for kind, shift, pairs, sdpa in (
            ("diagonal", 0, n * (n + 1) / 2, dict(is_causal=True)),
            ("visible", -n, n * n, {}),
            ("masked", n, 0, dict(attn_mask=dead))):
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, **sdpa)
        lib_fwd = queued_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, **sdpa))
        lib_bwd = queued_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True))
        bwd = (q, k, v, do, lse, delta, shift, scale)
        # (name, TPU kernel, kernel, plain, FLOP a pair, bytes read,
        # bytes written, SDPA)
        for name, src, fn, plain, per_pair, read, written, lib in (
                ("flash_fwd", "horovod_tpu/ops/attention.py:124",
                 lambda: A._flash_fwd_cuda(q, k, v, shift, scale),
                 lambda: A._reference_attention_lse(q, k, v, shift, scale),
                 4 * D, 2 * 3 * nq, 2 * nq + rows, lib_fwd),
                ("flash_bwd_dkdv", "horovod_tpu/ops/attention.py:254",
                 lambda: A._flash_bwd_dkdv_cuda(*bwd),
                 lambda: A._flash_bwd_dkdv_reference(*bwd),
                 8 * D, 2 * 4 * nq + 2 * rows, 2 * 2 * nq, lib_bwd),
                ("flash_bwd_dq", "horovod_tpu/ops/attention.py:315",
                 lambda: A._flash_bwd_dq_cuda(*bwd),
                 lambda: A._flash_bwd_dq_reference(*bwd),
                 6 * D, 2 * 4 * nq + 2 * rows, 2 * nq, lib_bwd)):
            ms, events_ms = queued_ms(fn), time_ms(fn)
            plain_ms = time_ms(plain, reps=5, batch=1)
            flops = per_pair * B * H * pairs
            b_ms, b_by = bound(flops, written + (read if pairs else 0),
                               torch.bfloat16)
            out.append({"name": name, "replaces": src, "chunk": kind,
                        "shift": shift, "ms": ms, "events_ms": events_ms,
                        "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib,
                        "shape": f"B=1 H={H} S=T={n} D={D} bf16 {kind} "
                                 f"chunk (shift {shift})"})
            log(f"ring chunk {name} [{kind}, shift {shift}]: {ms:.4f} ms "
                f"queued (back to back: {events_ms:.4f}), "
                f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
                f"SDPA {'forward' if name == 'flash_fwd' else 'backward'} "
                f"on the same mask {lib:.4f} ms")
        del ql, kl, vl, ol
    del q, k, v, do, lse, delta
    torch.cuda.empty_cache()
    return out


def _sp_train_leg(impl: str, mesh) -> dict:
    """TRAIN at full width with ``attention_impl=impl`` at sp = 1 (the
    mesh bound): 10 steps of the captured step from ``init_params`` seed
    0 on one fixed batch, as the training phase's captured leg; K1, K2
    and K3 launched ``SP_TRAIN_CHUNKS[impl]`` times a layer a step."""
    from horovod_tpu_torch import optim, parallel, spmd
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A

    cfg = T.TransformerConfig(**dict(TRAIN, attention_impl=impl),
                              dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
    named = optim.named_parameters(params)
    for _, t in named:
        t.requires_grad_()
    opt = optim.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in named], lr=3e-4,
                          betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
        named_parameters=named)
    step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
    if not step.graphed:
        raise AssertionError("make_train_step did not capture on CUDA")
    B, S = TRAIN_BATCH, TRAIN["max_seq"]
    batch = T.synthetic_batch(0, cfg, B, S)
    torch.cuda.synchronize()
    A.flash_fwd_launches = A.flash_bwd_dkdv_launches = 0
    A.flash_bwd_dq_launches = 0
    losses, times = [], []
    with parallel.bind(mesh):
        for _ in range(TRAIN_STEPS):
            t0 = time.monotonic()
            losses.append(float(step(params, batch)))
            times.append(time.monotonic() - t0)
    launches = _flash_counts()
    want = (SP_TRAIN_CHUNKS[impl] * cfg.n_layers * TRAIN_STEPS,) * 3
    step_s = statistics.median(times)
    out = {"losses": losses, "step_s": times, "step_s_median": step_s,
           "tokens_per_s": B * S / step_s, "launches": launches,
           "captures": step.captures, "replays": step.replays}
    log(f"sp train [{impl}] sp=1 losses: {[round(x, 4) for x in losses]}; "
        f"median step {step_s * 1e3:.1f} ms, {out['tokens_per_s']:.0f} "
        f"tok/s, K1/K2/K3 launches {launches}, captures {step.captures}, "
        f"replays {step.replays}")
    if launches != want:
        raise AssertionError(f"[{impl}] expected K1-K3 launches {want}, "
                             f"got {launches}")
    if step.captures != 1 or step.replays != TRAIN_STEPS - spmd.WARMUP_STEPS:
        raise AssertionError(f"[{impl}] {step.captures} captures, "
                             f"{step.replays} replays")
    del params, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_train(card: str, flash: dict) -> dict:
    """The training legs at sp = 1 on a size-1 NCCL group and its mesh
    (``make_mesh(MeshSpec())``): each impl's losses equal the training
    phase's captured flash leg's within 1e-3 relative a step."""
    from horovod_tpu_torch import basics, parallel

    gc.collect()
    torch.cuda.empty_cache()
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        mesh = parallel.make_mesh(parallel.MeshSpec())
        legs = {impl: _sp_train_leg(impl, mesh) for impl in SP_TRAIN_CHUNKS}
    finally:
        basics.shutdown()
    for impl, leg in legs.items():
        gap = max(abs(a - b) / abs(b) for a, b in
                  zip(leg["losses"], flash["losses"]))
        leg["loss_gap_vs_flash"] = gap
        if gap > 1e-3:
            raise AssertionError(f"[{impl}] losses differ from the flash "
                                 f"leg's by {gap:.3e}")
    log(f"sp train legs on {card} (TRAIN, sp = 1, captured; median step ms "
        f"/ tok/s / largest loss gap against flash): flash "
        f"{flash['step_s_median'] * 1e3:.1f} / {flash['tokens_per_s']:.0f}"
        + "".join(f"; {impl} {leg['step_s_median'] * 1e3:.1f} / "
                  f"{leg['tokens_per_s']:.0f} / {leg['loss_gap_vs_flash']:.2e}"
                  for impl, leg in legs.items()))
    launches = {k: sum(leg["launches"][i] for leg in legs.values())
                for i, k in enumerate(("flash_fwd", "flash_bwd_dkdv",
                                       "flash_bwd_dq"))}
    return {"legs": legs, "launches": launches}


def sp_prefill(card: str) -> dict:
    """A ``ring`` config served through ``InferenceEngine`` (its prefill
    attends the whole prompt with K1, needing no mesh) against the same
    weights under ``flash``: one greedy burst each, the same tokens."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine

    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, FULL["vocab_size"], n).tolist()
               for n in SP_PROMPT_LENS]
    params = T.init_params(T.TransformerConfig(**FULL, dtype=torch.bfloat16),
                           seed=0)
    runs = {}
    for impl in ("flash", "ring"):
        cfg = T.TransformerConfig(**dict(FULL, attention_impl=impl),
                                  dtype=torch.bfloat16)
        engine = InferenceEngine(params, cfg, EngineConfig(**SP_ENGINE))
        engine.warmup(SP_WARM_LENS)
        _zero_launches()
        burst = _stepped_burst(engine, prompts, [{}] * len(prompts),
                               SP_NEW_TOKENS)
        burst["launches"] = _launches()
        runs[impl] = burst
        del engine
        gc.collect()
    same = runs["ring"]["tokens"] == runs["flash"]["tokens"]
    log(f"sp prefill on {card}: a ring config served {len(prompts)} "
        f"prompts x {SP_NEW_TOKENS} tokens, tokens equal to flash's: "
        f"{same}; launches ring {runs['ring']['launches']}, flash "
        f"{runs['flash']['launches']}")
    if not same or runs["ring"]["launches"]["flash_fwd"] == 0:
        raise AssertionError("the ring config's burst differs from flash's "
                             "or launched no K1")
    del params
    torch.cuda.empty_cache()
    return {impl: {k: v for k, v in r.items() if k != "tokens"}
            for impl, r in runs.items()}


def sequence_parallel(card: str, flash_leg: dict) -> dict:
    """The phase: the virtual ring, the balance, the chunk times, the
    training legs at sp = 1 and the prefill of a ring config."""
    virtual = sp_virtual_ring()
    balance = sp_balance(card)
    chunks = time_ring_chunks()
    train = sp_train(card, flash_leg)
    prefill = sp_prefill(card)
    launches = {k: virtual["launches"][k] + train["launches"][k]
                for k in virtual["launches"]}
    launches["flash_fwd"] += sum(r["launches"]["flash_fwd"]
                                 for r in prefill.values())
    launches["paged_attend"] = sum(r["launches"]["paged_attend"]
                                   for r in prefill.values())
    return {"virtual_ring": virtual, "balance": balance, "chunks": chunks,
            "train": train, "prefill": prefill, "launches": launches}


# --- the gspmd phase: make_gspmd_train_step at mesh size 1 -------------------

# TRAIN at full width, GSPMD_STEPS steps of AdamW (the training leg's
# settings) from the same f32 master weights on the same batches, through
# make_gspmd_train_step over make_mesh(MeshSpec()) with param_specs /
# batch_specs and through make_train_step; then GSPMD_TIMED steps of each
# timed.  GSPMD_PARAM_TOL: the largest parameter difference between the
# two legs, relative to the largest change a leg made to that parameter
# (the bf16 tolerance of the sequence_parallel phase's checks).
GSPMD_STEPS, GSPMD_TIMED = 3, 5
GSPMD_LOSS_TOL, GSPMD_PARAM_TOL = 1e-3, 2e-2


def _adamw(tensors):
    return torch.optim.AdamW(tensors, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _state_template(opt):
    """``opt.state_dict()`` with every state tensor zeroed in place of its
    own (same placement, device and dtype): what a restore loads into."""
    sd = opt.state_dict()
    sd["state"] = {i: {k: torch.zeros_like(v) for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def _gspmd_leg(cfg, mesh, master, batches):
    """The GSPMD leg: the master weights placed by ``param_specs``, the
    counters set to 0 just before its steps and read just after."""
    from horovod_tpu_torch import optim, spmd
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.parallel import sharding as SH

    params = SH.distribute(master,
                           SH.named_shardings(mesh, T.param_specs(cfg)))
    named = optim.named_parameters(params)
    for _, t in named:
        t.requires_grad_()
    opt = _adamw([t for _, t in named])
    step = spmd.make_gspmd_train_step(
        lambda p, b: T.loss_fn(p, b, cfg), opt, mesh=mesh,
        param_spec=T.param_specs(cfg), batch_spec=T.batch_specs())
    torch.cuda.synchronize()
    A.flash_fwd_launches = A.flash_bwd_dkdv_launches = 0
    A.flash_bwd_dq_launches = 0
    losses, times = [], []
    for b in batches:
        t0 = time.monotonic()
        losses.append(float(step(params, b)))
        times.append(time.monotonic() - t0)
    launches = _flash_counts()
    return {"params": params, "named": named, "opt": opt, "step": step,
            "losses": losses, "step_s": times, "launches": launches}


def _dp_leg(cfg, master, batches):
    from horovod_tpu_torch import optim, spmd
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.parallel import sharding as SH

    params = SH.tree_map(torch.clone, master)
    named = optim.named_parameters(params)
    for _, t in named:
        t.requires_grad_()
    opt = optim.DistributedOptimizer(_adamw([t for _, t in named]),
                                     named_parameters=named)
    step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
    losses, times = [], []
    for b in batches:
        t0 = time.monotonic()
        losses.append(float(step(params, b)))
        times.append(time.monotonic() - t0)
    return {"params": params, "named": named, "opt": opt, "step": step,
            "losses": losses, "step_s": times}


def _step_times(leg, batch, B: int, S: int) -> dict:
    """GSPMD_TIMED more steps on one batch: the median wall of a step
    (ending in the loss's read), the queued device time of one step (one
    call behind the sleep: a second replay of a graph waits on the host
    for the first), and the median wall of the step's eager body (its
    host cost: DTensor's dispatch in the GSPMD leg)."""
    def median_wall(fn) -> float:
        times = []
        for _ in range(GSPMD_TIMED):
            t0 = time.monotonic()
            float(fn(leg["params"], batch))
            times.append(time.monotonic() - t0)
        return statistics.median(times)

    wall = median_wall(leg["step"])
    queued = queued_ms(lambda: leg["step"](leg["params"], batch), n=1,
                       reps=GSPMD_TIMED)
    eager = median_wall(leg["step"].body)
    return {"wall_ms": wall * 1e3, "queued_ms": queued,
            "eager_wall_ms": eager * 1e3, "tokens_per_s": B * S / wall,
            "captured": leg["step"].graphed,
            "captures": leg["step"].captures}


def _pod_checkpoint(cfg, mesh, g, batch, tmp: Path) -> dict:
    """``checkpoint.save`` of the GSPMD leg's DTensor parameters and AdamW
    state (``torch.distributed.checkpoint``), timed, its bytes; the next
    step uninterrupted; then ``restore`` into a fresh template (zeros
    placed alike, the state's zeroed) and that step again from a new
    step object: its loss equal to the uninterrupted one bit for bit."""
    from horovod_tpu_torch import checkpoint, optim, spmd
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.parallel import sharding as SH

    path = tmp / "gspmd_ckpt"
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checkpoint.save(str(path), {"params": g["params"],
                                "opt": g["opt"].state_dict()})
    save_s = time.monotonic() - t0
    nbytes = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    uninterrupted = float(g["step"](g["params"], batch))
    params = SH.tree_map(torch.zeros_like, g["params"])  # same placements
    named = optim.named_parameters(params)
    for _, t in named:
        t.requires_grad_()
    opt = _adamw([t for _, t in named])
    template = {"params": params, "opt": _state_template(g["opt"])}
    t0 = time.monotonic()
    back = checkpoint.restore(str(path), template)
    opt.load_state_dict(back["opt"])
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    step = spmd.make_gspmd_train_step(
        lambda p, b: T.loss_fn(p, b, cfg), opt, mesh=mesh,
        param_spec=T.param_specs(cfg), batch_spec=T.batch_specs())
    resumed = float(step(params, batch))
    out = {"save_s": save_s, "restore_s": restore_s, "bytes": nbytes,
           "files": sorted(f.name for f in path.iterdir()),
           "uninterrupted_loss": uninterrupted, "resumed_loss": resumed}
    log(f"gspmd pod checkpoint: {nbytes} bytes in {save_s:.2f} s "
        f"({nbytes / save_s / 1e9:.2f} GB/s; files {out['files']}), "
        f"restore {restore_s:.2f} s; next step's loss uninterrupted "
        f"{uninterrupted!r}, resumed {resumed!r}")
    if resumed != uninterrupted:
        raise AssertionError("the resumed GSPMD step's loss differs from "
                             f"the uninterrupted one's: {resumed!r} vs "
                             f"{uninterrupted!r}")
    del params, opt, step, back, template
    return out


def gspmd_full_width(card: str, tmp: Path) -> dict:
    """The phase: on a size-1 NCCL group, ``make_gspmd_train_step`` over
    ``make_mesh(MeshSpec())`` (one axis of size 1: every placement
    replicated) against ``make_train_step`` on TRAIN at full width, K1-K3
    under ``local_map``; losses within GSPMD_LOSS_TOL relative, every
    parameter within GSPMD_PARAM_TOL, K1, K2 and K3 launched
    ``n_layers`` times a step each by the GSPMD leg; then the pod
    checkpoint's round trip; then both steps timed."""
    from horovod_tpu_torch import basics, optim, parallel
    from horovod_tpu_torch.models import transformer as T

    gc.collect()
    torch.cuda.empty_cache()
    cfg = T.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    B, S = TRAIN_BATCH, TRAIN["max_seq"]
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        mesh = parallel.make_mesh(parallel.MeshSpec())
        master = T.init_params(cfg, seed=0, param_dtype=torch.float32)
        batches = [T.synthetic_batch(i, cfg, B, S) for i in range(GSPMD_STEPS)]
        g = _gspmd_leg(cfg, mesh, master, batches)
        d = _dp_leg(cfg, master, batches)
        initial = dict(optim.named_parameters(master))
        gap = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                     d["losses"]))
        bitwise = g["losses"] == d["losses"]
        full = {n: t.detach().full_tensor() for n, t in g["named"]}
        errs = {}
        for n, t in d["named"]:
            diff = float((full[n] - t.detach()).abs().max())
            moved = float((t.detach() - initial[n]).abs().max())
            errs[n] = diff / max(moved, 1e-30)
        del master, initial
        worst = max(errs, key=errs.get)
        want = (cfg.n_layers * GSPMD_STEPS,) * 3
        log(f"gspmd on {card} (TRAIN, MeshSpec(), AdamW, {GSPMD_STEPS} "
            f"steps): losses {g['losses']} against make_train_step's "
            f"{d['losses']} (largest gap {gap:.3e}, limit {GSPMD_LOSS_TOL:.0e}"
            f"; bit-equal {bitwise}); largest parameter difference over the "
            f"parameter's change {errs[worst]:.3e} ({worst}; limit "
            f"{GSPMD_PARAM_TOL:.0e}); K1/K2/K3 launches {g['launches']} "
            f"(want {want}); captured: gspmd {g['step'].graphed} "
            f"({g['step'].captures} captures, {g['step'].replays} replays), "
            f"make_train_step {d['step'].graphed}")
        if gap > GSPMD_LOSS_TOL:
            raise AssertionError(f"GSPMD losses differ from make_train_step's "
                                 f"by {gap:.3e}")
        if errs[worst] > GSPMD_PARAM_TOL:
            raise AssertionError(f"GSPMD parameter {worst} differs by "
                                 f"{errs[worst]:.3e} of its change")
        if g["launches"] != want:
            raise AssertionError(f"GSPMD leg: K1-K3 launches {g['launches']},"
                                 f" want {want}")
        if not g["step"].graphed or g["step"].captures != 1:
            raise AssertionError("the GSPMD step was not captured on CUDA")
        ckpt = _pod_checkpoint(cfg, mesh, g, batches[-1], tmp)
        timed = {"gspmd": _step_times(g, batches[0], B, S),
                 "make_train_step": _step_times(d, batches[0], B, S)}
        log(f"gspmd step on {card} (wall ms / queued ms / tok/s / "
            "captured / eager body wall ms): " + "; ".join(
                f"{k} {v['wall_ms']:.2f} / {v['queued_ms']:.2f} / "
                f"{v['tokens_per_s']:.0f} / {v['captured']} / "
                f"{v['eager_wall_ms']:.2f}" for k, v in timed.items()))
    finally:
        basics.shutdown()
    launches = dict(zip(("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"),
                        g["launches"]))
    out = {"losses": g["losses"], "dp_losses": d["losses"], "loss_gap": gap,
           "bit_equal": bitwise, "param_err": errs[worst],
           "param_err_at": worst, "launches": launches,
           "checkpoint": ckpt, "timed": timed}
    del g, d, full
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- the pipeline phase: GPipe, 1F1B, interleaved; expert parallelism --------

# The virtual pipeline: TRAIN at B = PIPE_M rows cut into PIPE_M
# microbatches of one row, PIPE_P stages of 2 layers, the interleaved
# schedule at PIPE_V chunks a stage.  f32 tolerances, relative: the loss,
# and a gradient's largest difference over its largest value (K1-K3's
# f32 tolerance in the sequence_parallel phase).  The bf16 timings: the
# median of PIPE_REPS calls after a warm one.  1F1B's memory at
# microbatches of one row, M in PIPE_MEM_M.  The phase's budget.
PIPE_P, PIPE_M, PIPE_V, PIPE_REPS = 4, 8, 2, 3
PIPE_SCHEDULES = ("gpipe", "1f1b", "interleaved")
PIPE_LOSS_TOL, PIPE_GRAD_TOL = 1e-5, 1e-4
PIPE_MEM_M = (4, 16)
PIPE_BUDGET_S = 90.0


def _flash_zero() -> None:
    from horovod_tpu_torch.ops import attention as A

    A.flash_fwd_launches = A.flash_bwd_dkdv_launches = 0
    A.flash_bwd_dq_launches = 0


def _counted(fn, total: dict):
    """``fn()`` with K1-K3's counters set to 0 just before and read just
    after -> (its result, its launches); the launches are added to
    ``total``, and by dtype to ``total["by_dtype"]``."""
    _flash_zero()
    before = _by_dtype()
    out = fn()
    got = dict(zip(("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"),
                   _flash_counts()))
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    by_dtype = total.setdefault("by_dtype", {})
    for dt, counts in _by_dtype_since(before).items():
        into = by_dtype.setdefault(dt, {})
        for k, v in counts.items():
            into[k] = into.get(k, 0) + v
    return out, got


def _pipe_launches(schedule: str, layers: int, P: int, M: int) -> dict:
    """K1-K3 a call of a schedule: each layer's forward and backward once
    a microbatch; 1F1B also replays the forward of every stage but the
    last (whose forward wave output goes nowhere)."""
    fwd = layers * M
    if schedule == "1f1b":
        fwd += layers * M * (P - 1) // P
    return {"flash_fwd": fwd, "flash_bwd_dkdv": layers * M,
            "flash_bwd_dq": layers * M}


def _plain_value_and_grad(params, batch, cfg):
    """``loss_fn``'s loss and gradients by autograd, in ``params``'
    shape (the eager plain step's forward and backward)."""
    from horovod_tpu_torch import optim
    from horovod_tpu_torch.models import transformer as T

    leaves = [t.detach().requires_grad_() for _, t in
              optim.named_parameters(params)]
    tree = optim._unflatten(params, leaves)
    loss = T.loss_fn(tree, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), optim._unflatten(params, grads)


def _pipe_errors(ref, got) -> dict:
    """The loss's relative difference, and each gradient's largest
    difference over its largest value."""
    from horovod_tpu_torch import optim

    (l0, g0), (l1, g1) = ref, got
    out = {"loss": abs(float(l1) - float(l0)) / abs(float(l0))}
    want = dict(optim.named_parameters(g0))
    for name, t in optim.named_parameters(g1):
        w = want[name].float()
        out[name] = float((t.float() - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
    return out


def _check_pipe(label: str, errs: dict) -> None:
    worst = max((k for k in errs if k != "loss"), key=errs.get)
    log(f"pipeline [{label}]: loss {errs['loss']:.3e} (limit "
        f"{PIPE_LOSS_TOL:.0e}), largest gradient difference {errs[worst]:.3e}"
        f" ({worst}; limit {PIPE_GRAD_TOL:.0e})")
    if errs["loss"] > PIPE_LOSS_TOL or errs[worst] > PIPE_GRAD_TOL:
        raise AssertionError(f"pipeline [{label}] differs from loss_fn: "
                             f"{errs}")


def _median_s(fn) -> tuple:
    """The median over PIPE_REPS calls (after a warm one) of a call's
    wall, ending in a synchronise, and of the host's time to enqueue it
    (up to the synchronise): an enqueue near the wall is a device that
    waits on the host."""
    fn()
    torch.cuda.synchronize()
    walls, enqueues = [], []
    for _ in range(PIPE_REPS):
        t0 = time.monotonic()
        fn()
        enqueues.append(time.monotonic() - t0)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    return statistics.median(walls), statistics.median(enqueues)


def _busy_ms(fn) -> float:
    """The profiler's kernel time of one call (device busy)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in _device_events(prof)) / 1e3
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return busy


def _pipe_schedules(card: str, total: dict) -> dict:
    """The virtual pipeline at full width: f32 against ``loss_fn``, bf16
    timed against the plain step, launches counted a call, 1F1B's
    memory."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.parallel import pipeline as PL

    st = PL._Stages.virtual(PIPE_P)
    B, S = PIPE_M, TRAIN["max_seq"]
    out = {"f32": {}, "bf16": {}, "launches": {}, "memory": {}}
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = T.TransformerConfig(**TRAIN, dtype=torch.float32)
    params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
    batch = T.synthetic_batch(0, cfg, B, S)
    ref, _ = _counted(lambda: _plain_value_and_grad(params, batch, cfg),
                      total)
    for sched in PIPE_SCHEDULES:
        got, _ = _counted(lambda: T._pipelined_value_and_grad(
            params, batch, cfg, st, n_microbatches=PIPE_M, schedule=sched,
            n_virtual=PIPE_V), total)
        errs = _pipe_errors(ref, got)
        _check_pipe(f"f32 {sched}", errs)
        out["f32"][sched] = {"loss": errs.pop("loss"),
                             "grad": max(errs.values())}
        del got
    del ref, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = T.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
    runs = {"plain": lambda: _plain_value_and_grad(params, batch, cfg)}
    for sched in PIPE_SCHEDULES:
        runs[sched] = (lambda sched=sched: T._pipelined_value_and_grad(
            params, batch, cfg, st, n_microbatches=PIPE_M, schedule=sched,
            n_virtual=PIPE_V))
    for name, fn in runs.items():
        _, got = _counted(fn, total)
        if name != "plain":
            want = _pipe_launches(name, cfg.n_layers, PIPE_P, PIPE_M)
            out["launches"][name] = got
            if got != want:
                raise AssertionError(f"pipeline [{name}]: K1-K3 launches "
                                     f"{got}, want {want}")
        (step_s, enqueue_s), _ = _counted(lambda: _median_s(fn), total)
        out["bf16"][name] = {"step_ms": step_s * 1e3,
                             "enqueue_ms": enqueue_s * 1e3,
                             "tokens_per_s": B * S / step_s}
    # Device busy last: after a profiler session the host launches more
    # slowly (the plain step's wall is taken again after them).
    for name, fn in runs.items():
        v = out["bf16"][name]
        v["busy_ms"], _ = _counted(lambda: _busy_ms(fn), total)
        v["idle_share"] = 1 - v["busy_ms"] / v["step_ms"]
    (step_s, _), _ = _counted(lambda: _median_s(runs["plain"]), total)
    out["bf16"]["plain"]["step_ms_after_profiler"] = step_s * 1e3
    plain = out["bf16"]["plain"]["step_ms"]
    for sched in PIPE_SCHEDULES:
        out["bf16"][sched]["over_plain"] = \
            out["bf16"][sched]["step_ms"] / plain
    log(f"pipeline bf16 on {card} (TRAIN, B = {B}, P = {PIPE_P}, M = "
        f"{PIPE_M}; forward and backward, no update; wall synchronised and "
        f"the host's enqueue before it, median of {PIPE_REPS}; device busy: "
        "the profiler's kernel time of one call): " + "; ".join(
            f"{k} {v['step_ms']:.1f} ms wall ({v.get('over_plain', 1):.3f}x"
            f" plain), enqueue {v['enqueue_ms']:.1f} ms, busy "
            f"{v['busy_ms']:.1f} ms, idle share {v['idle_share']:.3f}"
            for k, v in out["bf16"].items())
        + "; plain again after the profiler "
        f"{out['bf16']['plain']['step_ms_after_profiler']:.1f} ms; launches "
        f"K1/K2/K3 {out['launches']}")

    for sched, M in [("1f1b", m) for m in PIPE_MEM_M] + [
            ("gpipe", PIPE_MEM_M[-1])]:
        b = T.synthetic_batch(1, cfg, M, S)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, _ = _counted(lambda: T._pipelined_value_and_grad(
            params, b, cfg, st, n_microbatches=M, schedule=sched), total)
        torch.cuda.synchronize()
        out["memory"][f"{sched}.m{M}"] = \
            torch.cuda.max_memory_allocated() - base
        del res, b
    mem = out["memory"]
    small, big = (mem[f"1f1b.m{m}"] for m in PIPE_MEM_M)
    gpipe = mem[f"gpipe.m{PIPE_MEM_M[-1]}"]
    log(f"pipeline memory on {card} (peak over the start, bf16, one row a "
        f"microbatch): 1F1B M={PIPE_MEM_M[0]} {small / 1e9:.3f} GB, "
        f"M={PIPE_MEM_M[1]} {big / 1e9:.3f} GB ({big / small:.3f}x); GPipe "
        f"M={PIPE_MEM_M[1]} {gpipe / 1e9:.3f} GB")
    if not (big < 2 * small and big < gpipe):
        raise AssertionError(f"1F1B's memory grows with M: {mem}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pipe_size_one(total: dict) -> dict:
    """``pipelined_value_and_grad`` (the bound pp axis, a size-1 NCCL
    group: the real exchange, the identity) under 1F1B against
    ``loss_fn`` in f32."""
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(**TRAIN, dtype=torch.float32)
    params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
    batch = T.synthetic_batch(2, cfg, PIPE_M, TRAIN["max_seq"])
    ref, _ = _counted(lambda: _plain_value_and_grad(params, batch, cfg),
                      total)
    with parallel.bind(parallel.make_mesh(parallel.MeshSpec())):
        got, launches = _counted(lambda: T.pipelined_value_and_grad(
            params, batch, cfg, n_microbatches=2, schedule="1f1b"), total)
    errs = _pipe_errors(ref, got)
    _check_pipe("pp = 1, NCCL", errs)
    want = _pipe_launches("1f1b", cfg.n_layers, 1, 2)
    if launches != want:
        raise AssertionError(f"pp = 1: K1-K3 launches {launches}, want "
                             f"{want}")
    del params, ref, got
    return {"loss": errs.pop("loss"), "grad": max(errs.values())}


def _moe_ep_leg(card: str, total: dict) -> dict:
    """``MOE_TRAIN`` (8 experts) with ``moe_axis="ep"`` bound to a size-1
    group: eager loss and gradients bit-equal to ``moe_axis=None``'s;
    ``make_train_step(mesh=, axis="ep")`` with
    ``DistributedOptimizer(axis_name="ep")``, captured, its losses and
    parameters bit-equal to the plain captured step's; then 1F1B at
    P = PIPE_P over the virtual pipeline with ``moe_aux_coeff`` at one
    microbatch against ``loss_fn`` in f32."""
    from horovod_tpu_torch import optim, parallel, spmd
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.parallel import pipeline as PL

    mesh = parallel.make_mesh(parallel.MeshSpec())
    base = _moe_cfg(n_experts=8)
    batch = T.synthetic_batch(0, base, MOE_BATCH)
    out = {}
    with parallel.bind(mesh):
        res = []
        for axis in (None, "ep"):
            cfg = dataclasses.replace(base, moe_axis=axis)
            params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
            (loss, grads), _ = _counted(
                lambda: _plain_value_and_grad(params, batch, cfg), total)
            res.append([loss] + [g for _, g in
                                 optim.named_parameters(grads)])
            del params, grads
        out["eager_bit_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(*res))
        del res
    steps = {}
    for axis in (None, "ep"):
        cfg = dataclasses.replace(base, moe_axis=axis)
        params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
        named = optim.named_parameters(params)
        for _, t in named:
            t.requires_grad_()
        opt = optim.DistributedOptimizer(_adamw([t for _, t in named]),
                                         named_parameters=named,
                                         axis_name=axis)
        kw = dict(mesh=mesh, axis="ep") if axis else {}
        step = spmd.make_train_step(lambda p, b, c=cfg: T.loss_fn(p, b, c),
                                    opt, **kw)
        losses, _ = _counted(lambda: [float(step(params, batch))
                                      for _ in range(MOE_EAGER_STEPS)],
                             total)
        steps[axis] = {"losses": losses, "captures": step.captures,
                       "params": [t.detach() for _, t in named]}
        del opt, step
    a, b = steps[None], steps["ep"]
    out["captured_bit_equal"] = a["losses"] == b["losses"] and all(
        torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    out["captures"] = b["captures"]
    out["losses"] = b["losses"]
    del steps, a, b
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _moe_cfg(torch.float32, n_experts=8, capacity_factor=8.0,
                   moe_aux_coeff=1e-2, moe_axis="ep")
    params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
    with parallel.bind(mesh):
        ref, _ = _counted(lambda: _plain_value_and_grad(params, batch, cfg),
                          total)
        got, launches = _counted(lambda: T._pipelined_value_and_grad(
            params, batch, cfg, PL._Stages.virtual(PIPE_P),
            n_microbatches=1, schedule="1f1b"), total)
    errs = _pipe_errors(ref, got)
    _check_pipe("MoE 1F1B, aux, M = 1", errs)
    want = _pipe_launches("1f1b", cfg.n_layers, PIPE_P, 1)
    if launches != want:
        raise AssertionError(f"MoE 1F1B: K1-K3 launches {launches}, want "
                             f"{want}")
    out["aux_1f1b"] = {"loss": errs.pop("loss"), "grad": max(errs.values())}
    log(f"expert parallelism on {card} (MOE_TRAIN, E = 8, moe_axis='ep' "
        f"bound to a size-1 group): eager bit-equal to moe_axis=None "
        f"{out['eager_bit_equal']}; captured make_train_step(mesh=, "
        f"axis='ep') bit-equal {out['captured_bit_equal']} ({out['captures']}"
        f" capture, losses {out['losses']})")
    if not (out["eager_bit_equal"] and out["captured_bit_equal"]
            and out["captures"] == 1):
        raise AssertionError(f"moe_axis at size 1 differs: {out}")
    del params, ref, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipeline_full_width(card: str) -> dict:
    """The phase (see the module docstring): on a size-1 NCCL group."""
    from horovod_tpu_torch import basics

    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    total: dict = {}
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        out = {"virtual": _pipe_schedules(card, total)}
        t1 = time.monotonic()
        out["size_one"] = _pipe_size_one(total)
        t2 = time.monotonic()
        out["moe"] = _moe_ep_leg(card, total)
        out["part_s"] = {"virtual": t1 - t0, "size_one": t2 - t1,
                         "moe": time.monotonic() - t2}
    finally:
        basics.shutdown()
    out["launches"] = total
    out["seconds"] = time.monotonic() - t0
    log(f"pipeline phase: {out['seconds']:.1f} s of its {PIPE_BUDGET_S:.0f}"
        f" s budget (by part: {out['part_s']}); launches {total}")
    if out["seconds"] > PIPE_BUDGET_S:
        raise AssertionError(f"the pipeline phase took {out['seconds']:.1f}"
                             f" s, over its {PIPE_BUDGET_S:.0f} s budget")
    return out


# --- the launcher_elastic phase: horovodrun, elastic.run, checkpoints --------

# The job of the launcher_elastic phase: TRAIN's LM at full width, batch
# TRAIN_BATCH, AdamW 3e-4 in DistributedOptimizer, LAUNCH_STEPS steps of
# the captured step on the batch of the step's index.  Epochs of
# LAUNCH_STEPS_PER_EPOCH steps; LearningRateWarmupCallback over the first
# LAUNCH_WARMUP_EPOCHS epochs (steps 1-6; flat at size 1, where Horovod's
# warm-up runs from lr / size to lr), then LearningRateScheduleCallback
# lowers the rate by LAUNCH_DECAY an epoch, per batch, so that it changes
# at each later step under the captured step's replays.  A durable commit
# through CheckpointManager every LAUNCH_COMMIT_EVERY steps; in leg 2 the
# worker of epoch 0 kills itself (SIGKILL) after step LAUNCH_KILL_AFTER.
LAUNCH_STEPS, LAUNCH_COMMIT_EVERY, LAUNCH_KILL_AFTER = 10, 4, 6
LAUNCH_STEPS_PER_EPOCH, LAUNCH_WARMUP_EPOCHS = 2, 3
LAUNCH_LR, LAUNCH_DECAY = 3e-4, 0.1

LAUNCH_WORKER = '''\
"""One rank of chip_smoke.py's launcher_elastic job (written there and
launched by ``python -m horovod_tpu_torch.runner`` or the elastic
driver): an LM trained by the captured step under ``elastic.run``, with
the LR callbacks, durable commits through ``CheckpointManager``, and a
journal of every step in OUT."""
import time
t_boot = time.time()
import json, os, signal, sys

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as cb, checkpoint, optim, spmd
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import attention as A

job = json.loads(os.environ["SMOKE_JOB"])
dev = job["device"]
if dev == "cpu":
    torch.set_num_threads(1)
t_imported = time.time()
hvd.init(device=dev)
rank, size = hvd.rank(), hvd.size()
epoch = int(os.environ.get("HOROVOD_ELASTIC_EPOCH", "0"))
out = job["out"]
journal = open(os.path.join(out, f"journal.e{epoch}.r{rank}.jsonl"), "a")


def record(**kv):
    kv.update(epoch=epoch, rank=rank, size=size, t=time.time())
    journal.write(json.dumps(kv) + "\\n")
    journal.flush()


cfg = T.TransformerConfig(**job["model"], dtype=getattr(torch, job["dtype"]))
params = T.init_params(cfg, seed=0, device=dev, param_dtype=torch.float32)
named = optim.named_parameters(params)
for _, t in named:
    t.requires_grad_()
opt = optim.DistributedOptimizer(
    torch.optim.AdamW([t for _, t in named], lr=job["lr"],
                      betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
    named_parameters=named)
step_fn = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)

t_built = time.time()
mgr = checkpoint.CheckpointManager(job["ckpt"], max_to_keep=2)
resumed, tree = mgr.restore_latest(
    {"params": params, "opt": opt.state_dict(), "step": 0})
if resumed is not None:
    with torch.no_grad():
        for (_, t), (_, v) in zip(named,
                                  optim.named_parameters(tree["params"])):
            t.copy_(v)
    opt.load_state_dict(tree["opt"])
    del tree
t_restored = time.time()
record(event="start", resumed=resumed, import_s=t_imported - t_boot,
       build_s=t_built - t_imported, restore_s=t_restored - t_built)

spe, warm = job["steps_per_epoch"], job["warmup_epochs"]
model = cb.Model(params, opt)
callbacks = [
    cb.BroadcastGlobalVariablesCallback(0),
    cb.LearningRateWarmupCallback(warmup_epochs=warm, steps_per_epoch=spe,
                                  initial_lr=job["lr"]),
    cb.LearningRateScheduleCallback(
        multiplier=lambda e: 1.0 - job["decay"] * (e - warm),
        start_epoch=warm, staircase=False, steps_per_epoch=spe,
        initial_lr=job["lr"]),
    cb.MetricAverageCallback(),
]
for c in callbacks:
    c.set_model(model)
for c in callbacks:
    c.on_train_begin()
state = hvd.elastic.State(params=params, opt=opt.state_dict(),
                          step=resumed or 0)
record(event="train_begin", s=time.time() - t_restored)


def launches():
    return {"flash_fwd": A.flash_fwd_launches,
            "flash_bwd_dkdv": A.flash_bwd_dkdv_launches,
            "flash_bwd_dq": A.flash_bwd_dq_launches}


@hvd.elastic.run
def train(state):
    while state.step < job["steps"]:
        s = state.step
        e, b = divmod(s, spe)
        if b == 0:
            for c in callbacks:
                c.on_epoch_begin(e)
        for c in callbacks:
            c.on_batch_begin(b)
        batch = T.synthetic_batch(1000 + s, cfg, job["batch"], job["seq"],
                                  device=dev)
        t0 = time.monotonic()
        loss = float(step_fn(params, batch))
        dt = time.monotonic() - t0
        state.step = s + 1
        logs = {"loss": loss}
        for c in callbacks:
            c.on_batch_end(b, logs)
        if b == spe - 1:
            for c in callbacks:
                c.on_epoch_end(e, logs)
        record(step=state.step, loss=loss, lr=model.lr, s=dt,
               captures=step_fn.captures, replays=step_fn.replays,
               launches=launches())
        if state.step % job["commit_every"] == 0:
            state.opt = opt.state_dict()
            t0 = time.monotonic()
            mgr.save(state.step, {"params": params, "opt": state.opt,
                                  "step": state.step})
            state.commit()
            hvd.barrier()
            path = os.path.join(mgr._step_dir(state.step),
                                checkpoint.TREE_FILE)
            record(commit=state.step, s=time.monotonic() - t0,
                   bytes=os.path.getsize(path) if rank == 0 else 0)
        crash = job.get("crash")
        if crash and [epoch, rank, state.step] == crash:
            record(event="kill", step=state.step)
            journal.close()
            os.kill(os.getpid(), signal.SIGKILL)
    return state.step


final = train(state)
if rank == 0:
    torch.save({n: t.detach().cpu() for n, t in named},
               os.path.join(out, f"final.e{epoch}.pt"))
record(final=final, captures=step_fn.captures, replays=step_fn.replays,
       launches=launches())
journal.close()
hvd.shutdown()
'''


def _launch_env(job: dict) -> dict:
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["SMOKE_JOB"] = json.dumps(job)
    # The job's native control plane on a port of its own.
    env["HOROVOD_NATIVE_PORT"] = str(_free_port())
    return env


def _journal(out: Path) -> dict:
    """Every journal record of the job, by ``(epoch, rank)``."""
    recs: dict = {}
    for p in sorted(out.glob("journal.e*.r*.jsonl")):
        for line in p.read_text().splitlines():
            r = json.loads(line)
            recs.setdefault((r["epoch"], r["rank"]), []).append(r)
    return recs


def _expected_lr(step: int, f32: bool) -> float:
    """The rate the callbacks set before step ``step`` (1-based) at size
    1: ``warmup_schedule`` over the warm-up's steps, then the per-batch
    decay at the callback's fractional epoch; as the device's f32 ``lr``
    holds it when ``f32`` (a CUDA optimizer), else the float."""
    from horovod_tpu_torch import callbacks

    e, b = divmod(step - 1, LAUNCH_STEPS_PER_EPOCH)
    warm_steps = LAUNCH_WARMUP_EPOCHS * LAUNCH_STEPS_PER_EPOCH
    if step - 1 < warm_steps:
        lr = callbacks.warmup_schedule(LAUNCH_LR, warmup_steps=warm_steps,
                                       size=1)(step - 1)
    else:
        lr = LAUNCH_LR * (1.0 - LAUNCH_DECAY * (
            e + b / LAUNCH_STEPS_PER_EPOCH - LAUNCH_WARMUP_EPOCHS))
    return float(torch.tensor(lr, dtype=torch.float32)) if f32 else lr


def _log_tail(d: Path) -> str:
    return "".join(f"--- {p.name}\n{p.read_text()[-3000:]}"
                   for p in sorted(d.rglob("rank.*")) if p.is_file())


def _steps(recs: list) -> list:
    return [r for r in recs if "step" in r and "loss" in r]


def launcher_elastic(card: str, tmp: Path, model: dict = None,
                     dtype: str = "bfloat16", device=None,
                     batch: int = TRAIN_BATCH) -> dict:
    """The launch and cluster layer on the card: the LM job of
    ``LAUNCH_WORKER`` at ``model``'s width (``TRAIN``: full width), one
    rank, twice.

    * Leg 1, plain: ``python -m horovod_tpu_torch.runner -np 1 python
      worker.py``, 10 steps with no fault.  Exit 0; one capture and 8
      replays though the LR callbacks set the rate at every step; the LR
      read back after each step equal to the schedule's; K1-K3 launched.
    * Leg 2, elastic: the port's ``ElasticDriver`` in this process over
      ``localhost-a:1`` and ``localhost-b:1``, ``min_np = max_np = 1``;
      the worker of epoch 0 kills itself after step 6 (after the commit
      at step 4).  Exit 0; ``epoch_sizes`` [1, 1] and the blacklist
      ``["localhost-a"]``; epoch 1 restores step 4 and journals steps
      5-10; the final parameters equal leg 1's bit for bit.

    Prints ``--check-build``, the parameters' checksum, the wall time a
    step, the time to recover (the kill to epoch 1's first step) and
    each commit's seconds and bytes, beside the card."""
    import hashlib
    import shutil

    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.runner.discovery import FixedHostDiscovery
    from horovod_tpu_torch.runner.elastic_driver import ElasticDriver
    from horovod_tpu_torch.runner.hosts import HostSpec

    model = dict(model or TRAIN)
    cuda = device != "cpu"  # the step captured, the kernels launched
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    worker = tmp / "worker.py"
    worker.write_text(LAUNCH_WORKER)
    root = Path(__file__).resolve().parent

    def job(leg: str, crash=None) -> dict:
        out = tmp / leg
        out.mkdir()
        return {"model": model, "dtype": dtype, "device": device,
                "batch": batch, "seq": model["max_seq"],
                "lr": LAUNCH_LR, "decay": LAUNCH_DECAY,
                "steps": LAUNCH_STEPS, "steps_per_epoch":
                LAUNCH_STEPS_PER_EPOCH, "warmup_epochs":
                LAUNCH_WARMUP_EPOCHS, "commit_every": LAUNCH_COMMIT_EVERY,
                "out": str(out), "ckpt": str(out / "ckpt"), "crash": crash}

    res: dict = {}
    cb_out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "--check-build"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=_launch_env({}))
    if cb_out.returncode != 0:
        raise AssertionError(f"--check-build failed: {cb_out.stderr}")
    log("launcher --check-build:\n" + cb_out.stdout.rstrip())
    res["check_build"] = cb_out.stdout

    # Leg 1: the plain launch.
    j1 = job("plain")
    t0 = time.monotonic()
    p1 = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "1",
         "--output-filename", str(tmp / "plain_logs"), sys.executable,
         str(worker)], capture_output=True, text=True, timeout=900,
        cwd=root, env=_launch_env(j1))
    res["plain_wall_s"] = time.monotonic() - t0
    if p1.returncode != 0:
        raise AssertionError(f"leg 1 exited {p1.returncode}:\n{p1.stdout}"
                             f"\n{p1.stderr}\n{_log_tail(tmp / 'plain_logs')}")
    recs = _journal(Path(j1["out"]))[(0, 0)]
    steps = _steps(recs)
    final = recs[-1]
    if [r["step"] for r in steps] != list(range(1, LAUNCH_STEPS + 1)):
        raise AssertionError(f"leg 1 journaled steps {steps}")
    if (final["captures"], final["replays"]) != ((
            1, LAUNCH_STEPS - spmd.WARMUP_STEPS) if cuda else (0, 0)):
        raise AssertionError(f"leg 1: {final['captures']} captures, "
                             f"{final['replays']} replays")
    lrs = [r["lr"] for r in steps]
    want = [_expected_lr(r["step"], cuda) for r in steps]
    if lrs != want:
        raise AssertionError(f"leg 1 LR {lrs} is not the schedule's {want}")
    if len(set(lrs)) < 3:
        raise AssertionError(f"leg 1's LR did not change: {lrs}")
    L = model["n_layers"] * LAUNCH_STEPS if cuda else 0
    if final["launches"] != {"flash_fwd": L, "flash_bwd_dkdv": L,
                             "flash_bwd_dq": L}:
        raise AssertionError(f"leg 1 K1-K3 launches {final['launches']}, "
                             f"expected {L} each")
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"leg 1 loss not finite: {losses}")
    commits = [r for r in recs if "commit" in r]
    res["plain"] = {"losses": losses, "lr": lrs,
                    "step_s": [r["s"] for r in steps],
                    "step_s_median": statistics.median(
                        r["s"] for r in steps[-4:]),
                    "captures": final["captures"],
                    "replays": final["replays"],
                    "launches": final["launches"],
                    "commits": [{k: r[k] for k in ("commit", "s", "bytes")}
                                for r in commits]}
    shutil.rmtree(j1["ckpt"], ignore_errors=True)
    plain = torch.load(os.path.join(j1["out"], "final.e0.pt"),
                       weights_only=True)
    h = hashlib.sha256()
    for n, t in plain.items():
        h.update(t.numpy().tobytes())
    res["checksum_sha256"] = h.hexdigest()
    res["param_sum"] = float(sum(t.double().sum() for t in plain.values()))

    # Leg 2: the elastic driver, a SIGKILL after step 6.
    j2 = job("elastic", crash=[0, 0, LAUNCH_KILL_AFTER])
    driver = ElasticDriver(
        [sys.executable, str(worker)],
        FixedHostDiscovery([HostSpec("localhost-a", 1),
                            HostSpec("localhost-b", 1)]),
        min_np=1, max_np=1, env=_launch_env(j2),
        output_filename=str(tmp / "elastic_logs"))
    t0 = time.monotonic()
    try:
        rc = driver.run()
    except Exception as e:
        raise AssertionError(f"leg 2 failed: {e}\n"
                             f"{_log_tail(tmp / 'elastic_logs')}") from e
    res["elastic_wall_s"] = time.monotonic() - t0
    journal = _journal(Path(j2["out"]))
    if rc != 0 or driver.epoch_sizes != [1, 1] or \
            driver.blacklist.hosts() != ["localhost-a"]:
        raise AssertionError(
            f"leg 2: rc {rc}, epoch_sizes {driver.epoch_sizes}, blacklist "
            f"{driver.blacklist.hosts()}\n{_log_tail(tmp / 'elastic_logs')}")
    e0, e1 = journal[(0, 0)], journal[(1, 0)]
    kill = [r for r in e0 if r.get("event") == "kill"]
    s0 = [r["step"] for r in _steps(e0)]
    s1 = [r["step"] for r in _steps(e1)]
    if not kill or s0 != list(range(1, LAUNCH_KILL_AFTER + 1)):
        raise AssertionError(f"leg 2 epoch 0 journaled {s0}, kill {kill}")
    if e1[0].get("resumed") != LAUNCH_COMMIT_EVERY or s1 != list(
            range(LAUNCH_COMMIT_EVERY + 1, LAUNCH_STEPS + 1)):
        raise AssertionError(f"leg 2 epoch 1 resumed from "
                             f"{e1[0].get('resumed')} and journaled {s1}")
    lr1 = [r["lr"] for r in _steps(e1)]
    if lr1 != [_expected_lr(s, cuda) for s in s1]:
        raise AssertionError(f"leg 2 epoch 1 LR {lr1}")
    if e1[-1]["captures"] != int(cuda):
        raise AssertionError(f"leg 2 epoch 1: {e1[-1]['captures']} "
                             "captures")
    elastic = torch.load(os.path.join(j2["out"], "final.e1.pt"),
                         weights_only=True)
    diff = {n: float((elastic[n].double() - t.double()).abs().max())
            for n, t in plain.items() if not torch.equal(elastic[n], t)}
    res["elastic"] = {
        "epoch_sizes": driver.epoch_sizes,
        "blacklist": driver.blacklist.hosts(),
        "epoch0_steps": s0, "epoch1_steps": s1,
        "losses_epoch1": [r["loss"] for r in _steps(e1)],
        "recover_s": _steps(e1)[0]["t"] - kill[0]["t"],
        # The respawned worker's time by stage: from the kill to its
        # process (the driver's backoff and the spawn), its imports, its
        # init and model, the restore, the broadcast callback and the
        # State, its first step.
        "recover_breakdown_s": {
            "kill_to_process": e1[0]["t"] - kill[0]["t"]
            - e1[0]["import_s"] - e1[0]["build_s"] - e1[0]["restore_s"],
            "imports": e1[0]["import_s"], "init_and_model":
            e1[0]["build_s"], "restore": e1[0]["restore_s"],
            "train_begin": e1[1]["s"], "first_step": _steps(e1)[0]["s"]},
        "epoch1_captures": e1[-1]["captures"],
        "epoch1_replays": e1[-1]["replays"],
        "launches": {k: _steps(e0)[-1]["launches"][k]
                     + e1[-1]["launches"][k] for k in final["launches"]},
        "commits": [{k: r[k] for k in ("epoch", "commit", "s", "bytes")}
                    for r in e0 + e1 if "commit" in r],
        "unequal_params": diff}
    res["launches"] = {k: res["plain"]["launches"][k]
                       + res["elastic"]["launches"][k]
                       for k in final["launches"]}
    pe = res["elastic"]
    log(f"launcher_elastic on {card}: leg 1 (horovodrun -np 1) exit 0, "
        f"{final['captures']} capture, {final['replays']} replays, LR "
        f"{[f'{x:.3e}' for x in lrs]}, median step "
        f"{res['plain']['step_s_median'] * 1e3:.1f} ms, losses "
        f"{[round(x, 4) for x in losses]}, params sha256 "
        f"{res['checksum_sha256'][:16]} (sum {res['param_sum']:.6f}), wall "
        f"{res['plain_wall_s']:.1f} s")
    log(f"launcher_elastic on {card}: leg 2 (ElasticDriver, SIGKILL after "
        f"step {LAUNCH_KILL_AFTER}) exit 0, epoch_sizes "
        f"{pe['epoch_sizes']}, blacklist {pe['blacklist']}, epoch 1 steps "
        f"{s1}, time to recover (kill to epoch 1's first step) "
        f"{pe['recover_s']:.2f} s (by stage, s: "
        f"{ {k: round(v, 2) for k, v in pe['recover_breakdown_s'].items()} }"
        f"), wall {res['elastic_wall_s']:.1f} s; "
        f"commits (s, bytes): "
        f"{[(r['commit'], round(r['s'], 2), r['bytes']) for r in res['plain']['commits'] + pe['commits']]}")
    log(f"launcher_elastic on {card}: final parameters of leg 2 against "
        f"leg 1: {len(plain) - len(diff)} of {len(plain)} tensors equal "
        f"bit for bit" + (f"; max abs differences {diff}" if diff else ""))
    if diff:
        raise AssertionError(f"leg 2's final parameters differ from leg "
                             f"1's: {diff}")
    return res


# --- the tracing phase: spans, timeline, profile and /metrics ---------------

TRACE_LEGS = ("untraced", "traced", "traced", "untraced") * 2
TRACE_PROFILE_TICKS = 20
TRACE_TRAIN_STEPS = 5
# Tail sampling of the traced legs: no latency verdict, so that only the
# forced request (and any that errs or carries a typed event) keeps its
# per-tick detail.
TRACE_SAMPLING = dict(latency_threshold_s=30.0, max_tick_spans=512)
# The trace headers of the burst: request 0 names its trace and its
# parent span, request 1 its trace and forces full span detail.
TRACE_HEADERS = {0: {"X-Trace-Id": "smoke-parented",
                     "X-Parent-Span": "feedfacecafebeef"},
                 1: {"X-Trace-Id": "smoke-sampled", "X-Trace-Sampled": "1"}}


def _prom_parse(text: str) -> dict:
    """A strict reading of Prometheus text (0.0.4): every line a ``# HELP
    name text``, a ``# TYPE name kind`` or a sample ``name{labels}
    value``; every sample's family announced by HELP and TYPE before it
    (a histogram's ``_bucket``/``_sum``/``_count`` samples belong to it).
    Returns ``{family: {"type", "help", "samples": [(name, labels,
    value)]}}``."""
    name = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
    sample = re.compile(rf"^({name})(?:\{{((?:[a-zA-Z_][a-zA-Z0-9_]*="
                        r'"(?:[^"\\]|\\.)*",?)*)\})? '
                        r"(-?[0-9.]+(?:[eE][+-]?[0-9]+)?|[+-]?Inf|NaN)$")
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    fams: dict = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            fam = line[7:].split(" ", 1)[0]
            fams.setdefault(fam, {"type": None, "help": None,
                                  "samples": []})["help"] = line
            continue
        if line.startswith("# TYPE "):
            fam, kind = line[7:].split(" ")
            if fam not in fams or kind not in ("counter", "gauge",
                                               "histogram"):
                raise AssertionError(f"/metrics: TYPE before HELP or an "
                                     f"unknown type: {line!r}")
            fams[fam]["type"] = kind
            continue
        m = sample.match(line)
        if not m:
            raise AssertionError(f"/metrics: not a sample line: {line!r}")
        sname = m.group(1)
        fam = sname
        if fam not in fams:
            for suffix in ("_bucket", "_sum", "_count"):
                if sname.endswith(suffix) and \
                        sname[:-len(suffix)] in fams:
                    fam = sname[:-len(suffix)]
        if fam not in fams or fams[fam]["type"] is None:
            raise AssertionError(f"/metrics: sample before its family's "
                                 f"HELP and TYPE: {line!r}")
        fams[fam]["samples"].append(
            (sname, dict(label.findall(m.group(2) or "")),
             float(m.group(3))))
    bare = sorted(f for f, v in fams.items() if v["type"] is None)
    if bare:
        raise AssertionError(f"/metrics: families without a TYPE: {bare}")
    return fams


def _lines(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _http_burst(engine, base: str, prompts, timed: list) -> dict:
    """The eight greedy requests through the server, queued in a fixed
    order with the engine held (its lock), then released at once: every
    leg schedules the same way, so its tokens, ticks and host syncs are
    the same.  Returns the replies, the wall and the counters' moves."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA

    results = [None] * len(prompts)

    def quiesce():
        # The pipeline's last tick is fetched by the step after its
        # requests resolve (``_pending`` is cleared before that fetch,
        # inside the step): read between steps, under the engine's lock,
        # so that the fetch counts inside the leg, never across legs.
        deadline = time.monotonic() + 60
        while True:
            with engine._lock:
                if engine._pending is None and not engine.slots.active_count:
                    return
            if time.monotonic() > deadline:
                raise AssertionError("the engine did not go idle")
            time.sleep(0.001)

    def client(i):
        req = urllib.request.Request(
            base + "/generate", data=json.dumps({
                "tokens": prompts[i],
                "max_new_tokens": NEW_TOKENS[i]}).encode(),
            headers={"Content-Type": "application/json",
                     **TRACE_HEADERS.get(i, {})}, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            results[i] = (r.status, json.loads(r.read()))

    m = engine.metrics
    # (generation, seconds) of each garbage collection during the leg
    pauses, started = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           time.perf_counter() - started[0]))

    quiesce()
    graphs0 = _admission_graphs(engine)
    syncs0, ticks0 = m.host_syncs.value, m.decode_ticks.value
    threads = []
    with engine._lock:
        for i in range(len(prompts)):
            depth = engine.scheduler.depth
            t = threading.Thread(target=client, args=(i,))
            t.start()
            threads.append(t)
            deadline = time.monotonic() + 30
            while engine.scheduler.depth == depth:
                if time.monotonic() > deadline:
                    raise AssertionError(f"request {i} was not queued")
                time.sleep(0.001)
        del timed[:]
        A.flash_fwd_launches = 0
        PA.paged_attend_launches = 0
        gc.callbacks.append(on_gc)
        t0 = time.monotonic()
    try:
        for t in threads:
            t.join(600)
        wall = time.monotonic() - t0
    finally:
        gc.callbacks.remove(on_gc)
    gcs = [sum(1 for g, _ in pauses if g == n) for n in range(3)]
    quiesce()
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    for i, res in enumerate(results):
        if res is None or res[0] != 200 or \
                len(res[1]["tokens"]) != NEW_TOKENS[i]:
            raise AssertionError(f"traced burst: request {i} returned {res}")
    ticks = m.decode_ticks.value - ticks0
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    return {"replies": [r[1] for r in results], "wall_s": wall,
            "tok_per_s": sum(NEW_TOKENS) / wall,
            "tick_wall_ms_median": statistics.median(timed) * 1e3,
            # Steady decode rate at full occupancy: a tick emits a token
            # for every slot.
            "decode_tok_per_s": ENGINE["n_slots"] / statistics.median(timed),
            "tick_wall_ms_max": max(timed) * 1e3,
            "tick_wall_ms_sum": sum(timed) * 1e3,
            "ttft_ms_p50": statistics.median(ttft), "ttft_ms_max": ttft[-1],
            "gc_collections": gcs,
            "gc_ms_total": sum(d for _, d in pauses) * 1e3,
            "gc_ms_max": max((d for _, d in pauses), default=0.0) * 1e3,
            "decode_steps": len(timed), "decode_ticks": ticks,
            "host_syncs_per_tick": (m.host_syncs.value - syncs0) / ticks,
            "launches": launches, "graphs": (graphs0,
                                             _admission_graphs(engine))}


def _check_spans(leg: dict, span_path, replies) -> dict:
    """One traced leg's span stream: every request one start and one
    finish record; request 0's span under the given parent, request 1's
    detail kept (one tick span a decode tick), the clean requests'
    dropped; each breakdown's phases summing to its total."""
    from horovod_tpu_torch.obs.trace_store import TraceStore

    recs = _lines(span_path)
    store = TraceStore([str(span_path)])
    out = {"span_lines_per_request": (len(recs) - 1) / len(replies)}
    for i, body in enumerate(replies):
        b = body["breakdown"]
        sid, tid = b["span_id"], body["trace_id"]
        mine = [r for r in recs if sid in (r.get("id"), r.get("span"),
                                           r.get("parent"))]
        kinds = [r["k"] for r in mine]
        if kinds.count("s") != 1 or kinds.count("f") != 1:
            raise AssertionError(f"request {i}: span records {kinds}")
        roots = store.tree(tid)
        if [n.id for n in roots] != [sid]:
            raise AssertionError(f"request {i}: trace tree roots "
                                 f"{[n.id for n in roots]}, want [{sid}]")
        parts = b["queue_wait_s"] + b["prefill_s"] + b["decode_s"]
        if abs(parts - b["total_s"]) > 1e-3:
            raise AssertionError(f"request {i}: breakdown {b} does not sum")
        fin = [r for r in mine if r["k"] == "f"][0]["a"]
        ticks = sum(1 for r in mine if r["k"] == "d" and r["name"] == "tick")
        if i == 0 and roots[0].parent != TRACE_HEADERS[0]["X-Parent-Span"]:
            raise AssertionError(f"request 0's span has parent "
                                 f"{roots[0].parent}")
        if i == 1 and (fin.get("retained") != "forced"
                       or ticks != min(b["decode_ticks"],
                                       TRACE_SAMPLING["max_tick_spans"])
                       or ticks == 0):
            raise AssertionError(f"request 1: retained "
                                 f"{fin.get('retained')}, {ticks} tick "
                                 f"spans for {b['decode_ticks']} ticks")
        if i >= 2 and (fin.get("retained") is not None or ticks):
            raise AssertionError(f"request {i} kept detail: "
                                 f"{fin.get('retained')}, {ticks} ticks")
    return out


def _traced_fault(engine, prompts, span_dir, journal) -> dict:
    """The burst stepped synchronously with the tracer and spans on, one
    decode tick raising once every request has a token: each request
    the restart interrupts gets ``engine_restart`` then ``resume`` on its
    own span, and its live journal entry (``read_live``) names that
    span."""
    from horovod_tpu_torch.obs import tracing as TR
    from horovod_tpu_torch.serving import FaultSpec, RequestJournal

    rec = TR.start_spans(str(span_dir / "fault.jsonl"), proc="engine",
                         sampling=TR.SpanSampling(**TRACE_SAMPLING))
    try:
        futs = [engine.submit(p, max_new_tokens=n, trace_id=f"fault-{i}")
                for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS))]
        while not all(f.tokens_so_far() for f in futs):
            engine.step()
        live = RequestJournal.read_live(journal)
        want = {f.trace_id: f.trace.span_id for f in futs if not f.done()}
        got = {k: v["span_id"] for k, v in live.items()}
        if got != want:
            raise AssertionError(f"journal span ids {got}, want {want}")
        inj = engine.engine_cfg.faults
        restarts = engine.metrics.engine_restarts.value
        inj.add(FaultSpec(site="decode_tick", kind="raise",
                          skip=inj.visits("decode_tick")))
        interrupted = [f for f in futs if not f.done()]
        while not all(f.done() for f in futs):
            engine.step()
        torch.cuda.synchronize()
    finally:
        TR.stop_spans()
    if engine.metrics.engine_restarts.value != restarts + 1:
        raise AssertionError("the traced fault did not restart the engine")
    for i, f in enumerate(futs):
        if len(f.result(timeout=0)) != NEW_TOKENS[i]:
            raise AssertionError(f"traced fault: request {i} short")
    recs = _lines(rec.path)
    for f in interrupted:
        ev = [r["type"] for r in recs
              if r["k"] == "e" and r.get("span") == f.trace.span_id]
        if ev != ["engine_restart", "resume"]:
            raise AssertionError(f"{f.trace_id}: span events {ev}")
        if [k for k, _, _ in f.trace.events] != ev:
            raise AssertionError(f"{f.trace_id}: trace events "
                                 f"{f.trace.events}")
    return {"interrupted": len(interrupted),
            "journal_span_ids": len(got)}


def _profile_ticks(engine, tl, prof_dir) -> dict:
    """``Timeline.profile`` over ``TRACE_PROFILE_TICKS`` steady captured
    ticks at 8 slots: the exported Chrome trace must name K4's split and
    combine kernels, a launch each a layer a tick (the tick in flight
    when the window opens may add its own)."""
    futs = _fill_slots(engine, PROFILE_DEPTH, 3 * TRACE_PROFILE_TICKS + 8,
                       seed=7)
    replays = engine._tick.replays
    with tl.profile(str(prof_dir)):
        for _ in range(TRACE_PROFILE_TICKS):
            engine.step()
    if engine._tick.replays - replays != TRACE_PROFILE_TICKS:
        raise AssertionError("the profiled steps were not captured ticks")
    while not all(f.done() for f in futs):
        engine.step()
    with open(tl.profile_path) as f:
        events = json.load(f)["traceEvents"]
    n = FULL["n_layers"] * TRACE_PROFILE_TICKS
    counts = {}
    for k in ("paged_attend_split_kernel", "paged_attend_combine_kernel"):
        counts[k] = sum(1 for e in events if k in str(e.get("name", ""))
                        and e.get("ph") == "X")
        if not n <= counts[k] <= n + FULL["n_layers"]:
            raise AssertionError(f"profile of {TRACE_PROFILE_TICKS} ticks "
                                 f"holds {counts[k]} {k}, want {n}")
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError("the profile recorded no device kernel")
    return {"profile_path": tl.profile_path, "k4_kernels": counts,
            "device_kernels": kernels,
            "profile_bytes": Path(tl.profile_path).stat().st_size}


def _traced_train(tl_path) -> dict:
    """The captured LM step (``TRACE_TRAIN_STEPS`` steps: the eager
    warm-up, the capture, replays) inside ``obs.training_step`` with a
    timeline started: one ``train_step`` B/E pair a step on it,
    ``training_steps_total`` up by the step count, K1-K3 launched."""
    from horovod_tpu_torch import basics, obs, optim, spmd
    from horovod_tpu_torch import timeline as TL
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A

    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        cfg = T.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
        params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
        named = optim.named_parameters(params)
        for _, t in named:
            t.requires_grad_()
        opt = optim.DistributedOptimizer(
            torch.optim.AdamW([t for _, t in named], lr=3e-4,
                              weight_decay=1e-4), named_parameters=named)
        step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
        batch = T.synthetic_batch(0, cfg, TRAIN_BATCH, TRAIN["max_seq"])
        steps = obs.training_metrics().steps
        n0 = steps.value
        A.flash_fwd_launches = 0
        A.flash_bwd_dkdv_launches = 0
        A.flash_bwd_dq_launches = 0
        TL.start_timeline(str(tl_path))
        losses = []
        try:
            for _ in range(TRACE_TRAIN_STEPS):
                with obs.training_step():
                    losses.append(float(step(params, batch)))
        finally:
            TL.stop_timeline()
        launches = {"flash_fwd": A.flash_fwd_launches,
                    "flash_bwd_dkdv": A.flash_bwd_dkdv_launches,
                    "flash_bwd_dq": A.flash_bwd_dq_launches}
        captures, replays = step.captures, step.replays
        del params, opt, step, batch
    finally:
        basics.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    with open(tl_path) as f:
        pairs = [e["ph"] for e in json.load(f) if e["name"] == "train_step"]
    if pairs != ["B", "E"] * TRACE_TRAIN_STEPS:
        raise AssertionError(f"train_step span events {pairs}")
    if steps.value - n0 != TRACE_TRAIN_STEPS:
        raise AssertionError("training_steps_total did not rise by the "
                             "step count")
    if captures != 1 or not all(math.isfinite(x) for x in losses) or \
            not all(n > 0 for n in launches.values()):
        raise AssertionError(f"traced training: captures {captures}, "
                             f"losses {losses}, launches {launches}")
    return {"steps": TRACE_TRAIN_STEPS, "train_step_pairs": len(pairs) // 2,
            "losses": losses, "captures": captures, "replays": replays,
            "launches": launches}


def tracing_full_width(card: str, tmp: Path) -> dict:
    """The serving phase's configuration (bf16, 8 slots, max_len 2176)
    traced: a fault with spans on, ``Timeline.profile`` over captured
    ticks and its merge with the host timeline, then four HTTP bursts of
    the eight greedy prompts on one engine, untraced and traced in turns
    (tokens, host syncs a tick and captures equal; K1 and K4 launched in
    each), the spans of the traced ones, a strict ``/metrics`` scrape,
    and the captured LM step inside ``obs.training_step``."""
    from horovod_tpu_torch import timeline as TL
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.obs import merge as M
    from horovod_tpu_torch.obs import tracing as TR
    from horovod_tpu_torch.obs import xprof
    from horovod_tpu_torch.obs.registry import training_metrics
    from horovod_tpu_torch.serving import (EngineConfig, FaultInjector,
                                           InferenceEngine, ServingServer)

    cfg = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0)
    fpt = xprof.transformer_flops_per_token(params)
    compiles = training_metrics().compiles.labels(fn="serving_decode")
    decode0 = compiles.value
    journal = tmp / "journal.jsonl"
    engine = InferenceEngine(params, cfg, EngineConfig(
        **ENGINE, model_flops_per_token=fpt, faults=FaultInjector(),
        journal_path=str(journal)))
    engine.warmup(ENGINE_WARM_LENS)
    prompts = _prompts()
    out = {"model_flops_per_token": fpt}
    # A fault with spans on, and the profile, stepped synchronously.
    span_dir = tmp / "spans"
    TR.start(str(tmp / "host.rank0.json"),
             jsonl_path=str(tmp / "fault.events.jsonl"))
    try:
        out["fault"] = _traced_fault(engine, prompts, span_dir, journal)
        out["profile"] = _profile_ticks(engine, TL.get(), tmp / "prof")
    finally:
        TR.stop()
    merged = tmp / "merged.json"
    if M.main([str(merged), str(tmp / "host.rank0.json"),
               out["profile"]["profile_path"]]) != 0:
        raise AssertionError("obs.merge failed")
    with open(merged) as f:
        events = json.load(f)
    blocks = {e["pid"] // M.PID_STRIDE for e in events}
    if blocks != {1, 2}:
        raise AssertionError(f"the merged trace's pid blocks: {blocks}")
    out["merged_events"] = len(events)
    del events
    # The HTTP legs, untraced and traced in turns.
    timed: list = []
    inner = engine.step

    def step():
        n = engine.metrics.decode_ticks.value
        t0 = time.monotonic()
        worked = inner()
        if engine.metrics.decode_ticks.value != n:
            timed.append(time.monotonic() - t0)
        return worked

    engine.step = step
    srv = ServingServer(engine, port=0, request_timeout=600).start()
    base = "http://%s:%d" % srv.address
    legs = []
    try:
        for i, name in enumerate(TRACE_LEGS):
            if name == "traced":
                d = tmp / f"leg{i}"
                d.mkdir()
                TR.start(str(d / "trace.json"),
                         jsonl_path=str(d / "events.jsonl"))
                rec = TR.start_spans(
                    str(d / "spans.jsonl"), proc="replica",
                    sampling=TR.SpanSampling(**TRACE_SAMPLING))
            try:
                leg = _http_burst(engine, base, prompts, timed)
                # A reply leaves when its future resolves, just before
                # the engine thread writes the span's finish record.
                deadline = time.monotonic() + 30
                while name == "traced" and rec.n_finished < len(prompts):
                    if time.monotonic() > deadline:
                        raise AssertionError("span finish records missing")
                    time.sleep(0.001)
            finally:
                if name == "traced":
                    TR.stop_spans()
                    TR.stop()
            leg["name"] = name
            if name == "traced":
                leg.update(_check_spans(leg, d / "spans.jsonl",
                                        leg["replies"]))
                leg["jsonl_bytes_per_request"] = \
                    (d / "events.jsonl").stat().st_size / len(prompts)
                leg["span_bytes_per_request"] = \
                    (d / "spans.jsonl").stat().st_size / len(prompts)
            legs.append(leg)
            log(f"tracing leg {i} ({name}) on {card}: burst "
                f"{leg['tok_per_s']:.1f} tok/s, decode "
                f"{leg['decode_tok_per_s']:.1f} tok/s at "
                f"{ENGINE['n_slots']} slots, median decode step "
                f"{leg['tick_wall_ms_median']:.4f} "
                f"ms (max {leg['tick_wall_ms_max']:.3f}, sum "
                f"{leg['tick_wall_ms_sum']:.1f}) over {leg['decode_steps']} "
                f"steps, TTFT p50/max {leg['ttft_ms_p50']:.1f}/"
                f"{leg['ttft_ms_max']:.1f} ms, gc collections by "
                f"generation {leg['gc_collections']} taking "
                f"{leg['gc_ms_total']:.1f} ms (longest "
                f"{leg['gc_ms_max']:.1f}), "
                f"{leg['decode_ticks']} ticks, host syncs a tick "
                f"{leg['host_syncs_per_tick']:.4f}, launches "
                f"{leg['launches']}" + (
                    f", {leg['span_lines_per_request']:.2f} span lines and "
                    f"{leg['jsonl_bytes_per_request']:.0f} JSONL bytes a "
                    f"request" if name == "traced" else ""))
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            text = r.read().decode()
    finally:
        srv.stop()
        del engine.step
    ref = legs[0]
    ref_tokens = [b["tokens"] for b in ref["replies"]]
    for leg in legs:
        if [b["tokens"] for b in leg["replies"]] != ref_tokens:
            raise AssertionError(f"leg {leg['name']}: tokens differ from "
                                 "the untraced leg's")
        if (leg["host_syncs_per_tick"], leg["decode_ticks"]) != \
                (ref["host_syncs_per_tick"], ref["decode_ticks"]):
            raise AssertionError(f"leg {leg['name']}: host syncs a tick "
                                 f"{leg['host_syncs_per_tick']} over "
                                 f"{leg['decode_ticks']} ticks, untraced "
                                 f"{ref['host_syncs_per_tick']} over "
                                 f"{ref['decode_ticks']}")
        g0, g1 = leg.pop("graphs")
        if g0 != g1 or g1["decode_compilations"] != 1:
            raise AssertionError(f"leg {leg['name']} captured: {g0} -> {g1}")
        if not all(n > 0 for n in leg["launches"].values()):
            raise AssertionError(f"leg {leg['name']} missed a kernel: "
                                 f"{leg['launches']}")
        del leg["replies"]
    fams = _prom_parse(text)
    achieved = fams["serving_achieved_flops_per_sec"]["samples"][0][2]
    decode = {s[1].get("fn"): s[2] for s in
              fams["xla_compiles_total"]["samples"]}.get("serving_decode")
    if not achieved > 0:
        raise AssertionError(f"serving_achieved_flops_per_sec {achieved}")
    if decode - decode0 != engine.stats()["decode_compilations"]:
        raise AssertionError(f"xla_compiles_total{{fn=serving_decode}} grew "
                             f"by {decode - decode0}, the engine captured "
                             f"{engine.stats()['decode_compilations']}")
    out["metrics"] = {"families": len(fams),
                      "achieved_flops_per_sec": achieved,
                      "serving_decode_compiles": decode - decode0}
    out["legs"] = legs
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = _traced_train(tmp / "train.json")
    un = [lg for lg in legs if lg["name"] == "untraced"]
    tr = [lg for lg in legs if lg["name"] == "traced"]
    log(f"tracing on {card}: burst tok/s untraced "
        f"{[round(lg['tok_per_s'], 1) for lg in un]} traced "
        f"{[round(lg['tok_per_s'], 1) for lg in tr]}; decode tok/s at "
        f"{ENGINE['n_slots']} slots untraced "
        f"{[round(lg['decode_tok_per_s'], 1) for lg in un]} traced "
        f"{[round(lg['decode_tok_per_s'], 1) for lg in tr]}; median "
        f"decode step ms untraced "
        f"{[round(lg['tick_wall_ms_median'], 4) for lg in un]} "
        f"traced {[round(lg['tick_wall_ms_median'], 4) for lg in tr]}; "
        f"tokens, host syncs a tick ({ref['host_syncs_per_tick']:.4f}) and "
        f"captures equal; fault: {out['fault']['interrupted']} spans with "
        f"engine_restart + resume; profile: {out['profile']['k4_kernels']} "
        f"in {out['profile']['device_kernels']} device kernels; /metrics "
        f"{len(fams)} families, achieved {achieved:.4e} FLOP/s; "
        f"{out['train']['train_step_pairs']} train_step spans")
    return out


# --- the serving fleet: replica processes behind the router ------------------

# The fleet phase: FLEET_REPLICAS replica processes of the serving
# configuration on the one card, each with its own CUDA context (no NCCL
# between them), warmed over the buckets the serving prompts and their
# resumes reach (prompt + emitted: the 2048-token prompt resumes at 2176);
# the rollout's candidate and the canary's one scoring window, whose TTFT
# SLO (5 s) only a stalled canary breaks; the f32 tuner leg's windows
# (worked ticks) and the applies it must reach.
FLEET_REPLICAS = 2
FLEET_DEVICE = "cuda"
FLEET_WARM_LENS = [8, 16, 64, 128, 256, 512, 1024, 2048, 2170]
FLEET_CANDIDATE = {"max_prefills_per_tick": 1}
FLEET_WINDOW_S = 2.0
FLEET_TTFT_SLO_S = 5.0
FLEET_TUNER_WINDOW = 4
FLEET_TUNER_APPLIES = 3
# A victim for the SIGKILL holds a request with at least this many tokens
# still to come, so that its resume carries a partial decode.
FLEET_KILL_REMAINING = 16


def _post_headers(url, payload, timeout=600):
    """POST JSON -> (status, body, headers), an HTTP error read like a
    reply."""
    import urllib.error

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get_json(url, timeout=60):
    import urllib.error

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _memory_used() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


class _Fleet:
    """``FLEET_REPLICAS`` replicas of one ``dump_model`` pickle under a
    ``ReplicaSupervisor`` (journals, span streams and logs under
    ``root``), behind a ``RouterServer`` with ``resume_lookup`` and the
    span store, and a ``RolloutController`` when ``rollout``."""

    def __init__(self, root: Path, pkl: str, rollout: bool = False):
        from horovod_tpu_torch.serving.router import (ReplicaRegistry,
                                                      ReplicaSpec,
                                                      ReplicaSupervisor,
                                                      RolloutController,
                                                      RouterServer)
        from horovod_tpu_torch.tuning import Objective

        self.root = root
        spec = ReplicaSpec(
            params_path=pkl, slots=ENGINE["n_slots"],
            max_prefills_per_tick=ENGINE["max_prefills_per_tick"],
            max_queue_depth=ENGINE["max_queue_depth"], tick_timeout=120.0,
            request_timeout=600.0, drain_timeout=60.0,
            warm=tuple(FLEET_WARM_LENS), device=FLEET_DEVICE,
            # Latency alone keeps no tick detail: only the resume path.
            extra_args=("--span-latency-threshold", "600"))
        self.reg = ReplicaRegistry(poll_interval=0.1, poll_timeout=5.0,
                                   heartbeat_stale=60.0)
        self.sup = ReplicaSupervisor(
            spec, FLEET_REPLICAS, registry=self.reg, startup_timeout=600.0,
            unhealthy_grace=30.0, shutdown_grace=60.0, backoff_initial=0.1,
            journal_dir=str(root / "journal"), span_dir=str(root / "spans"),
            log_dir=str(root / "logs"))
        self.ctl = None
        if rollout:
            self.ctl = RolloutController(
                self.sup, window_s=FLEET_WINDOW_S, canary_windows=1,
                ready_timeout=600.0, drain_margin=30.0,
                objective=Objective(
                    ttft_slo={"interactive": FLEET_TTFT_SLO_S}))
        self.rt = RouterServer(self.reg, port=0, max_attempts=4,
                               retry_backoff=0.05, proxy_timeout=600.0,
                               resume_lookup=self.sup.resume_lookup,
                               span_dir=str(root / "spans"),
                               rollout=self.ctl)
        self.ready_s: dict = {}

    def start(self) -> "_Fleet":
        self.sup.start()
        self.rt.start()
        self.base = "http://%s:%d" % self.rt.address
        self.wait_ready()
        return self

    def wait_ready(self, timeout: float = 600.0) -> dict:
        """Block until every live replica is in rotation; each one's
        seconds from spawn to routable (its imports, the pickle, the
        warmup's captures) are kept by replica id."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            handles = self.sup.replicas()
            for h in handles:
                if h.rid not in self.ready_s and self.reg.is_routable(h.rid):
                    self.ready_s[h.rid] = time.monotonic() - h.spawned_at
            if len(handles) == FLEET_REPLICAS and all(
                    h.rid in self.ready_s for h in handles):
                return self.ready_s
            time.sleep(0.05)
        raise AssertionError(f"fleet replicas never ready\n{self.tails()}")

    def stats(self) -> dict:
        """Every routable replica's /stats, by replica id."""
        out = {}
        for st in self.reg.in_rotation():
            code, body = _get_json(st.endpoint.base_url + "/stats")
            if code == 200:
                out[st.endpoint.rid] = body
        return out

    def tails(self, n: int = 3000) -> str:
        logs = sorted((self.root / "logs").glob("*.log"))
        return "\n".join(f"--- {p.name} (last {n} bytes)\n"
                         + p.read_text(errors="replace")[-n:] for p in logs)

    def check(self, ok: bool, msg: str) -> None:
        """A failed gate raises with every replica log's tail."""
        if not ok:
            raise AssertionError(f"{msg}\n{self.tails()}")

    def stop(self) -> None:
        self.rt.stop()
        self.sup.stop(drain=False)


def _fleet_burst(fleet: _Fleet, prompts, new_tokens, sampling,
                 during=None) -> dict:
    """The prompts concurrently through the router, ``during(done)``
    called from this thread once they are sent (``done`` the indices
    answered so far).  Every request must return 200 with its full
    count."""
    url = fleet.base + "/generate"
    results: list = [None] * len(prompts)
    t0 = time.monotonic()

    def client(i):
        res = _post_headers(url, {"tokens": prompts[i],
                                  "max_new_tokens": new_tokens[i],
                                  **sampling[i]})
        results[i] = (*res, time.monotonic())

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    extra = during(lambda: [i for i, r in enumerate(results) if r]) \
        if during else None
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    for i, r in enumerate(results):
        fleet.check(r is not None and r[0] == 200
                    and len(r[1].get("tokens", ())) == new_tokens[i],
                    f"fleet request {i}: {r and r[:2]}")
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    served = {}
    for r in results:
        rid = r[2].get("X-Router-Replica")
        served[rid] = served.get(rid, 0) + 1
    return {"wall_s": wall, "tokens": sum(new_tokens),
            "tok_per_s": sum(new_tokens) / wall,
            "ttft_ms_p50": statistics.median(ttft), "ttft_ms_max": ttft[-1],
            "served_by": served, "results": results, "during": extra}


def _fleet_deltas(fleet: _Fleet, before: dict, after: dict) -> dict:
    """Per replica alive at both reads: K1's and K4's launches in its
    process between them; the leg's gates: both grew, one tick capture,
    no admission or sampler capture."""
    out = {}
    for rid in sorted(set(before) & set(after)):
        b, a = before[rid], after[rid]
        d = {k: a[k] - b[k] for k in ("flash_fwd_launches",
                                      "paged_attend_launches")}
        fleet.check(all(v > 0 for v in d.values()),
                    f"replica {rid} missed a kernel: {d}")
        fleet.check(a["decode_compilations"] == 1,
                    f"replica {rid}: {a['decode_compilations']} tick "
                    "captures")
        for k in ("prefill_compilations", "sample_compilations"):
            fleet.check(a[k] == b[k], f"replica {rid} captured after "
                        f"warmup: {k} {b[k]} -> {a[k]}")
        out[rid] = d
    return out


def _kill_mid_burst(fleet: _Fleet, n: int):
    """The ``during`` hook of the SIGKILL leg: once every request has
    tokens (a live journal entry with one, or a reply), SIGKILL the
    replica holding the most requests with ``FLEET_KILL_REMAINING``
    tokens still to come.  Returns (victim handle, kill time)."""
    import os
    import signal

    from horovod_tpu_torch.serving import RequestJournal

    def hook(done):
        seen = set()
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            busy = []
            for h in fleet.sup.replicas():
                try:
                    live = RequestJournal.read_live(
                        fleet.sup._journal_paths[h.rid])
                except Exception:
                    continue
                n_mid = 0
                for tid, d in live.items():
                    got = len(d["emitted_tokens"])
                    if got:
                        seen.add(tid)
                    if got and d["max_new_tokens"] - got >= \
                            FLEET_KILL_REMAINING:
                        n_mid += 1
                busy.append((n_mid, h))
            if len(seen) + len(done()) >= n and any(b for b, _ in busy):
                _, victim = max(busy, key=lambda x: x[0])
                t_kill = time.monotonic()
                os.kill(victim.pid, signal.SIGKILL)
                return victim, t_kill
            time.sleep(0.002)
        raise AssertionError(f"no replica held a request mid-decode\n"
                             f"{fleet.tails()}")

    return hook


def _autopsy(fleet: _Fleet, tid: str) -> dict:
    """``GET /trace/<tid>`` of a resumed request: one tree holding the
    killed attempt's unfinished ``generate`` span and the survivor's,
    the resume edge from the journal linked to the dead span."""
    def walk(node):
        yield node
        for c in node["children"]:
            yield from walk(c)

    code, a = _get_json(f"{fleet.base}/trace/{tid}")
    fleet.check(code == 200, f"/trace/{tid}: {code} {a}")
    spans = [s for root in a["tree"] for s in walk(root)]
    gen = [s for s in spans if s["name"] == "generate"]
    dead = [s for s in gen if s["unfinished"]]
    resume = [e for e in a["events"] if e["type"] == "resume"
              and e["attrs"].get("source") == "journal"]
    fleet.check(a["resumed"] is True and a["failovers"] >= 1
                and a["carried_tokens"] >= 1 and len(a["tree"]) == 1
                and len(gen) >= 2 and dead and resume
                and resume[0]["attrs"]["resumed_from_span"]
                in {s["span_id"] for s in dead},
                f"the autopsy of {tid}: {json.dumps(a)[:3000]}")
    return {"processes": a["processes"], "failovers": a["failovers"],
            "carried_tokens": a["carried_tokens"],
            "generate_spans": len(gen), "unfinished": len(dead)}


def fleet_full_width(card: str, tmp: Path, single: dict) -> dict:
    """The bf16 fleet's three legs: clean, SIGKILL, rollout under load
    (see the module docstring).  ``single``: the serving phase's burst,
    printed beside the router's."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.obs import tracing as TR
    from horovod_tpu_torch.serving.router.replica_main import dump_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    pkl = str(tmp / "bf16.pkl")
    params = T.init_params(cfg, seed=0)
    dump_model(pkl, params, cfg)
    del params
    torch.cuda.empty_cache()
    prompts = _prompts()
    fleet = _Fleet(tmp / "bf16", pkl, rollout=True)
    TR.start_spans(str(tmp / "bf16" / "spans" / "router.spans.jsonl"),
                   proc="router", role="router",
                   sampling=TR.SpanSampling(latency_threshold_s=600.0))
    out = {"replicas": FLEET_REPLICAS, "warm_lens": FLEET_WARM_LENS}
    try:
        fleet.start()
        st = fleet.stats()
        out["ready_s"] = dict(fleet.ready_s)
        out["warmup_reserved_bytes"] = {
            rid: s["warmup_reserved_bytes"] for rid, s in st.items()}
        out["memory_used"] = _memory_used()
        log(f"fleet on {card}: {FLEET_REPLICAS} replicas ready, seconds "
            f"from spawn {out['ready_s']}; warmup_reserved_bytes "
            f"{out['warmup_reserved_bytes']}; nvidia-smi memory.used "
            f"{out['memory_used']} (the smoke process included)")
        # Leg 1: the clean burst.
        before = fleet.stats()
        clean = _fleet_burst(fleet, prompts, NEW_TOKENS, SAMPLING)
        after = fleet.stats()
        fleet.check(len(clean["served_by"]) == FLEET_REPLICAS,
                    f"one replica served every request: "
                    f"{clean['served_by']}")
        clean["launches"] = _fleet_deltas(fleet, before, after)
        del clean["results"]
        out["clean"] = clean
        log(f"fleet clean (bf16) on {card}: {clean['tok_per_s']:.1f} "
            f"tok/s, TTFT p50 {clean['ttft_ms_p50']:.1f} ms max "
            f"{clean['ttft_ms_max']:.1f} ms, served by "
            f"{clean['served_by']}; one engine (the serving phase's "
            f"burst): {single['tok_per_s']:.1f} tok/s, TTFT p50 "
            f"{single['ttft_ms_p50']:.1f} ms max "
            f"{single['ttft_ms_max']:.1f} ms; launches {clean['launches']}")
        # Leg 2: SIGKILL a replica once every request has tokens.
        before = fleet.stats()
        kill = _fleet_burst(fleet, prompts, NEW_TOKENS, SAMPLING,
                            during=_kill_mid_burst(fleet, len(prompts)))
        victim, t_kill = kill["during"]
        last = max(r[3] for r in kill["results"])
        resumed = [(i, r[1]) for i, r in enumerate(kill["results"])
                   if r[1].get("resumed")]
        fleet.check(bool(resumed), "no reply resumed after the SIGKILL")
        failovers = fleet.reg.metrics.resume_failovers.value
        fleet.check(failovers >= 1, "router_resume_failovers_total is 0")
        wasted = sum(len(prompts[i]) + body["resume_carried_tokens"]
                     for i, body in resumed)
        deadline = time.monotonic() + 600.0
        while True:
            h = fleet.sup.handle(victim.slot)
            if h is not None and h.gen > victim.gen \
                    and fleet.reg.is_routable(h.rid):
                break
            fleet.check(time.monotonic() < deadline,
                        f"slot {victim.slot} never rejoined")
            time.sleep(0.05)
        rejoin = time.monotonic() - t_kill
        fleet.wait_ready()
        autopsy = _autopsy(fleet, resumed[0][1]["trace_id"])
        after = fleet.stats()
        kill_out = {
            "victim": victim.rid, "respawned_as": h.rid,
            "tok_per_s": kill["tok_per_s"], "wall_s": kill["wall_s"],
            "kill_to_last_reply_s": last - t_kill,
            "kill_to_rejoin_s": rejoin, "resumed_replies": len(resumed),
            "resume_failovers": failovers,
            "resume_wasted_tokens": wasted,
            "served_by": kill["served_by"], "autopsy": autopsy,
            "launches": {rid: {k: after[rid][k] - before[rid][k]
                               for k in ("flash_fwd_launches",
                                         "paged_attend_launches")}
                         for rid in set(before) & set(after)}}
        out["sigkill"] = kill_out
        log(f"fleet SIGKILL (bf16) on {card}: killed {victim.rid} once "
            f"every request had tokens; {len(prompts)} of {len(prompts)} "
            f"full counts, {len(resumed)} resumed, "
            f"router_resume_failovers_total {failovers}; kill to last reply "
            f"{kill_out['kill_to_last_reply_s']:.3f} s, kill to rejoin "
            f"({h.rid}) {rejoin:.3f} s; resume_wasted_tokens {wasted} "
            f"(prompt + carried, re-prefilled); /trace: "
            f"{autopsy['generate_spans']} generate spans, "
            f"{autopsy['unfinished']} unfinished, processes "
            f"{autopsy['processes']}")
        # Leg 3: the rollout under load.
        out["rollout"] = _rollout_leg(fleet, prompts, card)
    finally:
        fleet.stop()
        TR.stop_spans()
    return out


def _rollout_leg(fleet: _Fleet, prompts, card: str) -> dict:
    """``POST /rollout`` of ``FLEET_CANDIDATE`` while bursts run back to
    back: the rollout ends ``done``, every replica reads
    ``config_generation`` 1, every request of every burst returns its
    full count."""
    stop = threading.Event()
    bursts: list = []
    errors: list = []

    def load():
        while not stop.is_set():
            try:
                bursts.append(_fleet_burst(fleet, prompts, NEW_TOKENS,
                                           SAMPLING))
            except AssertionError as e:
                errors.append(str(e))
                return

    t = threading.Thread(target=load)
    t.start()
    time.sleep(1.0)
    t0 = time.monotonic()
    code, body, _ = _post_headers(fleet.base + "/rollout",
                                  {"candidate": FLEET_CANDIDATE})
    fleet.check(code == 202, f"POST /rollout: {code} {body}")
    fleet.ctl.wait(900.0)
    duration = time.monotonic() - t0
    stop.set()
    t.join(900)
    fleet.check(not errors, f"a request failed during the rollout: "
                f"{errors[:1]}")
    _, status = _get_json(fleet.base + "/rollout")
    fleet.check(status["state"] == "done", f"rollout ended {status}")
    fleet.wait_ready()
    gens = {rid: s["config_generation"] for rid, s in fleet.stats().items()}
    fleet.check(len(gens) == FLEET_REPLICAS
                and set(gens.values()) == {1},
                f"config generations after the rollout: {gens}")
    n = sum(len(b["results"]) for b in bursts)
    out = {"candidate": FLEET_CANDIDATE, "duration_s": duration,
           "state": status["state"], "step_durations_s":
           status["step_durations_s"], "config_generations": gens,
           "bursts": len(bursts), "requests": n, "dropped": 0,
           "canary_score": status["canary_score"],
           "incumbent_score": status["incumbent_score"]}
    log(f"fleet rollout (bf16) on {card}: {FLEET_CANDIDATE} "
        f"{status['state']} in {duration:.3f} s (steps "
        f"{status['step_durations_s']}); config_generation {gens}; "
        f"{n} requests in {len(bursts)} bursts during it, none dropped")
    return out


def fleet_identity_f32(card: str, tmp: Path, oracle: dict) -> dict:
    """Leg 4, beside ``token_identity_f32`` (TF32 off in the replicas,
    PyTorch's default): a 2-replica f32 fleet serves that phase's prompts,
    half sampled, with a SIGKILL once every request has tokens; every
    reply, resumed ones included, equals ``_f32_oracles`` by the same
    near-tie rule.  Then in this process an f32 engine with
    ``autotune=True`` and ``FLEET_TUNER_WINDOW``-tick windows serves
    bursts of the same prompts until its tuner has applied
    ``FLEET_TUNER_APPLIES`` settings: every burst's tokens equal the
    oracles, no capture after warmup."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine
    from horovod_tpu_torch.serving.router.replica_main import dump_model
    from horovod_tpu_torch.tuning import tuner as tuner_mod

    prompts, refs, params, cfg = (oracle["prompts"], oracle["refs"],
                                  oracle["params"], oracle["cfg"])
    new = [F32_NEW_TOKENS] * len(prompts)
    pkl = str(tmp / "f32.pkl")
    dump_model(pkl, params, cfg)
    fleet = _Fleet(tmp / "f32", pkl)
    try:
        fleet.start()
        kill = _fleet_burst(fleet, prompts, new, SAMPLING,
                            during=_kill_mid_burst(fleet, len(prompts)))
        outs = [r[1]["tokens"] for r in kill["results"]]
        resumed = sum(bool(r[1].get("resumed")) for r in kill["results"])
        fleet.check(resumed >= 1, "no f32 reply resumed")
        exempt = _check_f32("f32 fleet", prompts, outs, refs)
    finally:
        fleet.stop()
    fleet_out = {"ready_s": dict(fleet.ready_s), "resumed": resumed,
                 "exemptions": exempt, "tok_per_s": kill["tok_per_s"],
                 "victim": kill["during"][0].rid}
    log(f"fleet f32 on {card}: SIGKILL of {fleet_out['victim']} mid-burst, "
        f"{resumed} resumed; {len(prompts)} replies equal the oracles "
        f"({len(exempt)} near-tie exemptions)")
    # The online tuner in this process, small windows.
    engine = InferenceEngine(params, cfg, EngineConfig(**ENGINE,
                                                       autotune=True))
    engine.warmup(FLEET_WARM_LENS)
    # Installed by warmup() at the default 32-tick windows; the leg's
    # bursts are short, so it is reinstalled over the same space.
    engine._tuner = None
    tuner = tuner_mod.OnlineTuner.install(
        engine, window_ticks=FLEET_TUNER_WINDOW, warmup_windows=0,
        bo_samples=4)
    applied: list = []
    orig = tuner_mod.apply_settings

    def counting(eng, settings):
        applied.append(dict(settings))
        return orig(eng, settings)

    keys = ("decode_compilations", "prefill_compilations",
            "sample_compilations")
    warm = {k: engine.stats()[k] for k in keys}
    tuner_mod.apply_settings = counting
    exempt, bursts = [], 0
    try:
        while len(applied) < FLEET_TUNER_APPLIES and bursts < 6:
            futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS,
                                  **SAMPLING[i])
                    for i, p in enumerate(prompts)]
            while not all(f.done() for f in futs):
                engine.step()
            bursts += 1
            exempt += _check_f32(f"f32 tuned burst {bursts}", prompts,
                                 [f.result(timeout=0) for f in futs], refs)
    finally:
        tuner_mod.apply_settings = orig
    now = {k: engine.stats()[k] for k in keys}
    if len(applied) < FLEET_TUNER_APPLIES:
        raise AssertionError(f"the tuner applied {applied} in {bursts} "
                             "bursts")
    if now != warm or warm["decode_compilations"] != 1:
        raise AssertionError(f"captures under the tuner: {warm} -> {now}")
    snap = tuner.snapshot()
    del engine
    torch.cuda.empty_cache()
    out = {"fleet": fleet_out, "tuner": {
        "bursts": bursts, "applied": applied, "phase": snap["phase"],
        "samples": snap["samples"], "exemptions": exempt,
        "captures": now}}
    log(f"online tuner f32 on {card}: {len(applied)} applies {applied} in "
        f"{bursts} bursts (phase {snap['phase']}, {snap['samples']} "
        f"samples); tokens equal the oracles ({len(exempt)} near-tie "
        f"exemptions); captures {now}, as after warmup")
    return out


# --- the vision phase: ResNet-50 in bench.py's protocol ------------------------

# bench.py's protocol: 10 warm-up batches, 10 iterations of 10 batches.
# Each leg: (batch, run the captured step or its eager body, bf16 gradient
# reduction).  The batch-384 legs are the JAX bench's default, batch 64 the
# reference's batch a GPU (BASELINE.md).
VISION_LEGS = {"b384_eager": (384, False, False),
               "b384_captured": (384, True, False),
               "b64_eager": (64, False, False),
               "b64_captured": (64, True, False),
               "b64_captured_fp16_allreduce": (64, True, True)}
VISION_SIZE = 224
VISION_GAP_STEPS, VISION_GAP = 10, 1e-3
# The f32 check: CUDA against the CPU, each error relative to the largest
# magnitude of the tensor compared (cuDNN's and the CPU's algorithms sum in
# other orders; a gradient also moves where a pre-activation within that
# rounding of zero falls on the other side of a relu).
VISION_F32_BATCH = 4
VISION_F32_TOL = {"logits": 1e-3, "loss": 1e-4, "grad": 1e-2,
                  "batch_stats": 1e-3, "s2d_logits": 1e-3}
INCEPTION_SIZE, INCEPTION_BATCH = 299, 64
MLP_BATCH, MLP_STEPS = 128, 20


def _rel(got, want) -> float:
    return ((got.float().cpu() - want.float().cpu()).abs().max()
            / want.float().cpu().abs().max().clamp_min(1e-30)).item()


def vision_f32_check() -> dict:
    """Full ResNet-50 (1000 classes) in f32 from ``init_variables`` seed 0,
    batch 4 at 224 × 224, ``conv7`` stem, train mode: the port on CUDA
    against the same model and weights on the CPU (the tier-1 tests hold
    the CPU against flax): logits, loss, every gradient and the batch
    statistics the forward moved; then one forward of the ``s2d`` stem.
    TF32 is off for the check and restored after it."""
    import copy

    from horovod_tpu_torch.models import resnet

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        errs = {}
        g = torch.Generator().manual_seed(4)
        x = torch.rand((VISION_F32_BATCH, 3, VISION_SIZE, VISION_SIZE),
                       generator=g)
        y = torch.randint(0, 1000, (VISION_F32_BATCH,), generator=g)
        for stem in ("conv7", "s2d"):
            gpu = resnet.create("ResNet50", 1000, torch.float32, stem,
                                seed=0, device="cuda").train()
            cpu = copy.deepcopy(gpu).to("cpu")
            outs = {}
            for name, m in (("cuda", gpu), ("cpu", cpu)):
                dev = next(m.parameters()).device
                xb = x.to(dev).contiguous(memory_format=torch.channels_last)
                logits = m(xb)
                if stem == "conv7":
                    loss = torch.nn.functional.cross_entropy(logits,
                                                             y.to(dev))
                    loss.backward()
                    outs[name] = (logits, loss)
                else:
                    outs[name] = (logits.detach(), None)
            if stem == "s2d":
                errs["s2d_logits"] = _rel(outs["cuda"][0], outs["cpu"][0])
                continue
            errs["logits"] = _rel(outs["cuda"][0], outs["cpu"][0])
            errs["loss"] = _rel(outs["cuda"][1], outs["cpu"][1])
            pc = dict(cpu.named_parameters())
            grads = {n: _rel(p.grad, pc[n].grad)
                     for n, p in gpu.named_parameters()}
            worst = max(grads, key=grads.get)
            errs["grad"] = grads[worst]
            bc = dict(cpu.named_buffers())
            stats = {n: _rel(b, bc[n]) for n, b in gpu.named_buffers()}
            errs["batch_stats"] = max(stats.values())
            log(f"vision f32 (ResNet-50, batch {VISION_F32_BATCH}, "
                f"{VISION_SIZE}², TF32 off), CUDA against the CPU: worst "
                f"gradient {worst}")
            del gpu, cpu, outs
        for k, e in errs.items():
            log(f"vision f32 {k}: max relative error {e:.3e} (tolerance "
                f"{VISION_F32_TOL[k]:.0e})")
        bad = {k: e for k, e in errs.items() if not e <= VISION_F32_TOL[k]}
        if bad:
            raise AssertionError(f"vision f32: CUDA and the CPU disagree: "
                                 f"{bad}")
        return errs
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
        _collect()


def _resnet_step(batch: int, fp16_allreduce: bool = False):
    """A fresh ResNet-50 (``init_variables`` seed 0), its bench step and
    the fixed synthetic batch (seed 0)."""
    from horovod_tpu_torch import bench

    model = bench.create_model("ResNet50", seed=0, device="cuda")
    step = bench.make_step(model, fp16_allreduce=fp16_allreduce)
    return model, step, bench.synthetic_batch(batch, VISION_SIZE,
                                              device="cuda")


def _collect() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def vision_gap() -> dict:
    """Batch 64 under ``cudnn.deterministic`` (benchmark off): the first
    ``VISION_GAP_STEPS`` losses of the eager body and of the captured step,
    each from a fresh model of the same seed on the same batch, within
    ``VISION_GAP`` relative."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        losses = {}
        for mode in ("eager", "captured"):
            model, step, batch = _resnet_step(64)
            run = step if mode == "captured" else step.body
            losses[mode] = [float(run(model, batch))
                            for _ in range(VISION_GAP_STEPS)]
            del model, step, batch, run
            _collect()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    gap = max(abs(a - b) / abs(b) for a, b in
              zip(losses["captured"], losses["eager"]))
    log(f"vision batch 64, cudnn.deterministic: eager losses "
        f"{[round(v, 5) for v in losses['eager']]}; largest gap of the "
        f"captured step {gap:.3e} (limit {VISION_GAP:.0e} relative)")
    if not gap <= VISION_GAP:
        raise AssertionError(f"vision: captured and eager losses differ by "
                             f"{gap:.3e}")
    return {"losses": losses, "gap": gap}


def _check_losses(label: str, losses: list) -> None:
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")


def _check_capture(label: str, step) -> None:
    """One capture, made after ``WARMUP_STEPS`` eager steps of the same
    shapes (which ran cuDNN's autotuning: a benchmark inside a capture
    would fail it), and every later call a replay."""
    from horovod_tpu_torch import spmd

    if step.captures != 1 or step.replays != step.calls - spmd.WARMUP_STEPS:
        raise AssertionError(f"{label}: {step.captures} captures, "
                             f"{step.replays} replays of {step.calls} calls")


def _vision_summary(label, res, batch, step, captured, peak) -> dict:
    from horovod_tpu_torch import bench

    out = dict(bench.summarize(res, batch_size=batch, peak=peak),
               losses=res["losses"], peak_mem_bytes=res["peak_mem_bytes"],
               captures=step.captures, replays=step.replays,
               img_per_sec=res["img_per_sec"])
    _check_losses(label, res["losses"])
    if captured:
        _check_capture(label, step)
    if out["mfu"] is None or not 0 < out["mfu"] < 1:
        raise AssertionError(f"{label}: MFU {out['mfu']} (a reading of 1 "
                             "or more is a fault in the FLOP count)")
    return out


def vision_leg(name: str, card: str, host=None) -> dict:
    """One ResNet-50 leg of ``VISION_LEGS`` in bench.py's protocol, with
    ``cudnn.benchmark`` on; the batch-384 legs also profile one more step,
    and with ``host`` the captured leg runs the loader-fed A/B."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.data import DataLoader
    from horovod_tpu_torch.obs import xprof

    t0 = time.monotonic()
    batch, captured, fp16 = VISION_LEGS[name]
    model, step, data = _resnet_step(batch, fp16)
    run = step if captured else step.body
    loader = None
    if host is not None:
        loader = DataLoader(host, batch, shuffle=False, shard=False,
                            prefetch=2, device="cuda")
    res = bench.measure(run, model, data, warmup=10, per_iter=10, iters=10,
                        loader=loader)
    out = _vision_summary(f"vision [{name}]", res, batch, step, captured,
                          xprof.chip_peak_flops())
    if loader is not None:
        if not all(math.isfinite(v) for v in res["fed_losses"]):
            raise AssertionError(f"vision [{name}]: a loader-fed loss is "
                                 f"not finite: {res['fed_losses']}")
        fed = statistics.median(res["fed_img_per_sec"])
        link = bench.link_bound(host, batch, torch.device("cuda"))
        out.update(fed_img_per_sec=fed,
                   overhead_pct=100 * (1 - fed / out["value"]),
                   host_to_device_bound_img_per_sec=link,
                   efficiency_vs_ceiling_pct=100 * fed / min(out["value"],
                                                             link))
    if batch == 384:
        out["profile"] = profile_train_step(run, model, data, flash=False)
    out["seconds"] = time.monotonic() - t0
    log(f"vision [{name}] on {card} ({out['seconds']:.1f} s): "
        f"{out['value']:.1f} img/s "
        f"(±{out['stddev95']:.1f}), MFU {out['mfu']:.4f} "
        f"({out['flops_per_img'] / 1e9:.2f} GFLOP an image counted), peak "
        f"{out['peak_mem_bytes'] / 1e9:.2f} GB, captures {step.captures}, "
        f"replays {step.replays}, losses "
        f"{[round(v, 4) for v in res['losses'][:3]]} … "
        f"{round(res['losses'][-1], 4)}"
        + (f"; loader-fed {out['fed_img_per_sec']:.1f} img/s (overhead "
           f"{out['overhead_pct']:.2f} %, host→device bound "
           f"{out['host_to_device_bound_img_per_sec']:.0f} img/s, "
           f"efficiency {out['efficiency_vs_ceiling_pct']:.2f} %)"
           if loader is not None else ""))
    return out


def inception_leg(card: str) -> dict:
    """InceptionV3 at 299, batch 64, captured, in a shortened protocol
    (10 warm-up batches, 3 iterations of 10)."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.obs import xprof

    t0 = time.monotonic()
    model = bench.create_model("InceptionV3", seed=0, device="cuda")
    step = bench.make_step(model)
    data = bench.synthetic_batch(INCEPTION_BATCH, INCEPTION_SIZE,
                                 device="cuda")
    res = bench.measure(step, model, data, warmup=10, per_iter=10, iters=3)
    out = _vision_summary("vision [inception]", res, INCEPTION_BATCH, step,
                          True, xprof.chip_peak_flops())
    out["seconds"] = time.monotonic() - t0
    log(f"vision [InceptionV3 {INCEPTION_SIZE}², batch {INCEPTION_BATCH}, "
        f"captured] on {card} ({out['seconds']:.1f} s): "
        f"{out['value']:.1f} img/s (±{out['stddev95']:.1f}), MFU "
        f"{out['mfu']:.4f} ({out['flops_per_img'] / 1e9:.2f} GFLOP an "
        f"image), peak {out['peak_mem_bytes'] / 1e9:.2f} GB")
    return out


def mlp_leg() -> dict:
    """The MLP (784-256-128-10) for ``MLP_STEPS`` captured Adam steps fed
    by the DataLoader from host rows whose labels a fixed linear map
    decides: the loss must fall."""
    from horovod_tpu_torch import optim, spmd
    from horovod_tpu_torch.data import DataLoader
    from horovod_tpu_torch.models import mlp

    rng = np.random.default_rng(0)
    x = rng.standard_normal((MLP_BATCH * MLP_STEPS, 784), dtype=np.float32)
    y = (x @ rng.standard_normal((784, 10), dtype=np.float32)).argmax(1)
    loader = DataLoader({"x": x, "y": y}, MLP_BATCH, seed=0, device="cuda")
    params = mlp.init_params(seed=0, device="cuda")
    for t in params.values():
        t.requires_grad_()
    step = spmd.make_train_step(
        lambda p, b: mlp.loss_fn(p, (b["x"], b["y"])),
        optim.DistributedOptimizer(torch.optim.Adam(params.values(),
                                                    lr=1e-3)))
    losses = [float(step(params, b)) for b in loader]
    log(f"vision [mlp]: {len(losses)} loader-fed steps, losses "
        f"{[round(v, 4) for v in losses]}")
    if len(losses) != MLP_STEPS:
        raise AssertionError(f"mlp: {len(losses)} batches")
    _check_losses("vision [mlp]", losses)
    _check_capture("vision [mlp]", step)
    return {"losses": losses, "captures": step.captures,
            "replays": step.replays}


def vision_full_width(card: str) -> dict:
    """The vision phase on a size-1 NCCL group: the f32 check, the
    deterministic eager-against-captured gap, the ResNet-50 legs (the
    batch-384 captured leg with the loader-fed A/B), InceptionV3 and the
    MLP."""
    from horovod_tpu_torch import basics, bench

    _collect()
    t0 = time.monotonic()
    out = {"f32": vision_f32_check()}
    log(f"vision f32 check: {time.monotonic() - t0:.1f} s")
    saved = torch.backends.cudnn.benchmark
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        out["gap"] = vision_gap()
        torch.backends.cudnn.benchmark = True
        host = bench.host_epoch(384 * 10, VISION_SIZE)
        out["legs"] = {}
        for name in VISION_LEGS:
            out["legs"][name] = vision_leg(
                name, card, host if name == "b384_captured" else None)
            _collect()
        del host
        out["inception"] = inception_leg(card)
        _collect()
        out["mlp"] = mlp_leg()
    finally:
        torch.backends.cudnn.benchmark = saved
        basics.shutdown()
    return out


# --- the collectives at size 1 ------------------------------------------------


def check_collectives(device) -> list:
    """Every collective of the port on ``device`` tensors in f32 and
    bf16, in a job of size 1 (``basics.init`` already called): each
    result must equal its size-1 value exactly.  At size 1 this proves
    the backend's paths on the device's tensors and dtypes, not the
    arithmetic across ranks (the CPU tests hold that against JAX)."""
    import importlib

    from horovod_tpu_torch import state
    # The package exports the function join, which shadows the module.
    join = importlib.import_module("horovod_tpu_torch.join")
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import sparse as SP
    from horovod_tpu_torch.ops.compression import Compression

    checked = []

    def same(label, got, want):
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"collective {label}: {got} != {want}")
        checked.append(label)

    g = torch.Generator(device=device).manual_seed(5)
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt)[6:]
        x = torch.randn((96, 33), generator=g, device=device).to(dt)
        for op in ("Sum", "Average", "Min", "Max", "Product", "Adasum"):
            same(f"allreduce.{op}.{tag}", C.allreduce(x, op), x)
            same(f"allreduce.{op}.scaled.{tag}",
                 C.allreduce(x, op, prescale_factor=0.5,
                             postscale_factor=3.0),
                 x.clone().mul_(0.5).mul_(3.0))
            h = C.allreduce_async(x, op)
            C.poll(h)
            same(f"allreduce_async.{op}.{tag}", C.synchronize(h), x)
        with C._hierarchical(True):
            same(f"hierarchical.allreduce.{tag}", C.allreduce(x, "Sum"), x)
            same(f"hierarchical.allgather.{tag}", C.allgather(x), x)
        same(f"allreduce.compression.{tag}",
             C.allreduce(x.float(), "Sum", compression=Compression.bf16),
             x.float().to(torch.bfloat16).float())
        same(f"process_sum.{tag}", C.process_sum(x), x)
        for op in ("Average", "Adasum"):
            for i, t in enumerate(C.grouped_allreduce([x, x[:7, :5]], op)):
                same(f"grouped.{op}.{i}.{tag}", t, [x, x[:7, :5]][i])
        same(f"allgather.{tag}", C.allgather(x), x)
        same(f"broadcast.{tag}", C.broadcast(x, 0), x)
        same(f"alltoall.{tag}", C.alltoall(x), x)
        same(f"alltoall.splits.{tag}", C.alltoall(x, [x.shape[0]]), x)
        for op in ("Sum", "Average"):
            same(f"reducescatter.{op}.{tag}", C.reducescatter(x, op), x)
        for label, h in (("allgather_async", C.allgather_async(x)),
                         ("broadcast_async", C.broadcast_async(x, 0)),
                         ("reducescatter_async",
                          C.reducescatter_async(x, "Sum")),
                         ("alltoall_async", C.alltoall_async(x)),
                         ("alltoall_async.splits",
                          C.alltoall_async(x, [x.shape[0]]))):
            C.poll(h)
            same(f"{label}.{tag}", C.synchronize(h), x)
            if not C.poll(h):
                raise AssertionError(f"{label}: a spent handle polls busy")
            try:
                C.synchronize(h)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{label}: a handle synchronized twice")
        sp = torch.zeros((64, 8), device=device, dtype=dt)
        sp[[3, 17, 40]] = torch.randn((3, 8), generator=g,
                                      device=device).to(dt)
        for op in ("Sum", "Average"):
            got, stats = SP.sparse_allreduce(sp, op, return_stats=True)
            same(f"sparse_allreduce.{op}.{tag}", got, sp)
            same(f"sparse_vs_dense.{op}.{tag}", got, C.allreduce(sp, op))
            if stats["rows"] != 3:
                raise AssertionError(f"sparse rows {stats}")
        for active in (0, 1):
            got = join.masked_average([x], active)[0]
            same(f"masked_average.active{active}.{tag}", got,
                 x if active else torch.zeros_like(x))
            if not torch.isfinite(got.float()).all():
                raise AssertionError("masked_average is not finite")
    obj = {"step": 7, "name": "card", "t": [1.5, 2]}
    if state.broadcast_object(obj, 0) != obj:
        raise AssertionError("broadcast_object")
    if state.allgather_object(obj) != [obj]:
        raise AssertionError("allgather_object")
    checked += ["broadcast_object", "allgather_object"]
    if join.join() != 0:
        raise AssertionError("join() at size 1 must return 0")
    checked.append("join")
    C.barrier()
    checked.append("barrier")
    return checked


# The axis forms the collectives phase drives at size 1: one axis, a pair
# in both orders, three axes (alltoall, reducescatter and Adasum refuse
# it, as JAX's do).
AXIS_FORMS = ("dp", "tp", ("dp", "tp"), ("tp", "dp"), ("dp", "fsdp", "tp"))
AXIS_TRAIN_STEPS = 3


def check_axis_forms(device) -> list:
    """The collectives' ``axis_name`` forms on ``device`` tensors in f32
    and bf16, in a job of size 1 (``basics.init`` already called), under
    the bound mesh of ``MeshSpec()``: every collective over each of
    :data:`AXIS_FORMS`, ``adasum_allreduce`` over an axis and a pair,
    ``masked_average`` over an axis.  Each result must equal its size-1
    value exactly; alltoall and reducescatter over a tuple, and Adasum
    over three axes, must raise JAX's texts."""
    import importlib

    join = importlib.import_module("horovod_tpu_torch.join")
    from horovod_tpu_torch.ops import adasum as AD
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.parallel import meshes

    checked = []

    def same(label, got, want):
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"axis form {label}: {got} != {want}")
        checked.append(label)

    def raises(label, fn, text):
        try:
            fn()
        except ValueError as e:
            if str(e) != text:
                raise AssertionError(f"axis form {label}: {e!r}") from e
            checked.append(label)
            return
        raise AssertionError(f"axis form {label}: no ValueError")

    g = torch.Generator(device=device).manual_seed(6)
    with meshes.bind(meshes.make_mesh(meshes.MeshSpec())):
        for dt in (torch.float32, torch.bfloat16):
            tag = str(dt)[6:]
            x = torch.randn((96, 33), generator=g, device=device).to(dt)
            parts = [x, x[:7, :5]]
            for axes in AXIS_FORMS:
                one = isinstance(axes, str)
                name = axes if one else "_".join(axes)
                ops = ["Sum", "Average", "Min", "Max", "Product"]
                if one or len(axes) == 2:
                    ops.append("Adasum")
                for op in ops:
                    same(f"{name}.allreduce.{op}.{tag}",
                         C.allreduce(x, op, axis_name=axes), x)
                    for i, t in enumerate(C.grouped_allreduce(
                            parts, op, axis_name=axes)):
                        same(f"{name}.grouped.{op}.{i}.{tag}", t, parts[i])
                same(f"{name}.allgather.{tag}",
                     C.allgather(x, axis_name=axes), x)
                same(f"{name}.broadcast.{tag}",
                     C.broadcast(x, 0, axis_name=axes), x)
                same(f"{name}.broadcast_.{tag}",
                     C.broadcast_(x.clone(), 0, axis_name=axes), x)
                if one:
                    same(f"{name}.alltoall.{tag}",
                         C.alltoall(x, axis_name=axes), x)
                    same(f"{name}.alltoall.splits.{tag}",
                         C.alltoall(x, [x.shape[0]], axis_name=axes), x)
                    for op in ("Sum", "Average"):
                        same(f"{name}.reducescatter.{op}.{tag}",
                             C.reducescatter(x, op, axis_name=axes), x)
                    continue
                for kind, fn in (("alltoall", C.alltoall),
                                 ("reducescatter", C.reducescatter)):
                    raises(f"{name}.{kind}.raises.{tag}",
                           lambda: fn(x, axis_name=axes),
                           f"{kind} supports a single mesh axis")
            for axes in ("dp", ("dp", "tp")):
                same(f"adasum_allreduce.{axes}.{tag}",
                     AD.adasum_allreduce(x, axis_name=axes), x)
            raises(f"adasum_allreduce.three_axes.raises.{tag}",
                   lambda: AD.adasum_allreduce(x, axis_name=AXIS_FORMS[-1]),
                   "adasum_allreduce takes one axis or (cross, local)")
            for active in (0, 1):
                same(f"masked_average.dp.active{active}.{tag}",
                     join.masked_average([x], active, axis_name="dp")[0],
                     x if active else torch.zeros_like(x))
    return checked


def check_workers_axis(device) -> list:
    """After ``basics.init(axis_name="workers")``: the flat mesh takes
    the name, an allreduce over it is the world's, and the default name
    is unbound (``NameError``, as JAX's unbound axis)."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import collectives as C

    if basics.axis_name() != "workers" or \
            basics.mesh().mesh_dim_names != ("workers",):
        raise AssertionError(f"init(axis_name='workers'): "
                             f"{basics.axis_name()} "
                             f"{basics.mesh().mesh_dim_names}")
    x = torch.randn((96, 33), device=device)
    for op in ("Sum", "Average", "Adasum"):
        got = C.allreduce(x, op, axis_name="workers")
        if not torch.equal(got, x) or not torch.equal(got,
                                                      C.allreduce(x, op)):
            raise AssertionError(f"allreduce {op} over 'workers' is not "
                                 "the world's")
    try:
        C.allreduce(x, axis_name=basics.AXIS)
    except NameError:
        pass
    else:
        raise AssertionError("the default axis name is still bound")
    return ["workers.allreduce.Sum", "workers.allreduce.Average",
            "workers.allreduce.Adasum", "workers.unbound_default"]


def _axis_train_leg(kind: str, batches) -> dict:
    """TRAIN from ``init_params`` seed 0 (bf16 on f32 masters), one eager
    step a batch under the bound size-1 mesh through ``kind``'s
    optimizer over one AdamW (``capturable`` with a device ``lr``, as
    ``optim.DistributedOptimizer`` sets its own): ``plain``, the AdamW
    itself; ``adasum``, ``DistributedAdasumOptimizer(axis_name="dp")``;
    ``sparse``, ``DistributedOptimizer(axis_name="dp",
    sparse_keys=("embed",))``.  The K1-K3 counters are set to 0 just
    before the steps and read just after."""
    from horovod_tpu_torch import optim
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.parallel import meshes

    cfg = T.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
    named = optim.named_parameters(params)
    for _, t in named:
        t.requires_grad_()
    tensors = [t for _, t in named]
    lr = torch.tensor(3e-4, dtype=torch.float32, device=tensors[0].device)
    opt = torch.optim.AdamW(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4, capturable=True)
    if kind == "adasum":
        opt = optim.DistributedAdasumOptimizer(opt, axis_name="dp")
    elif kind == "sparse":
        opt = optim.DistributedOptimizer(opt, named_parameters=named,
                                         axis_name="dp",
                                         sparse_keys=("embed",))
    torch.cuda.synchronize()
    A.flash_fwd_launches = A.flash_bwd_dkdv_launches = 0
    A.flash_bwd_dq_launches = 0
    times, losses = [], []
    with meshes.bind(meshes.make_mesh(meshes.MeshSpec())):
        for b in batches:
            t0 = time.monotonic()
            opt.zero_grad()
            loss = T.loss_fn(params, b, cfg)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))  # waits for the card
            times.append(time.monotonic() - t0)
    launches = dict(zip(("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"),
                        _flash_counts()))
    want = cfg.n_layers * len(batches)
    if launches != dict.fromkeys(launches, want):
        raise AssertionError(f"axis TRAIN leg {kind}: K1-K3 launches "
                             f"{launches}, want {want} each")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"axis TRAIN leg {kind}: losses {losses}")
    return {"params": [t.detach() for t in tensors], "losses": losses,
            "step_ms": [round(v * 1e3, 3) for v in times],
            "launches": launches}


def axis_train_legs(card: str) -> dict:
    """The two TRAIN legs over ``axis_name="dp"`` at size 1, each held
    bit for bit to plain AdamW on the same batches."""
    from horovod_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    batches = [T.synthetic_batch(300 + i, cfg, TRAIN_BATCH, TRAIN["max_seq"])
               for i in range(AXIS_TRAIN_STEPS)]
    plain = _axis_train_leg("plain", batches)
    legs = {}
    for kind in ("adasum", "sparse"):
        leg = _axis_train_leg(kind, batches)
        diff = max(float((a - b).abs().max())
                   for a, b in zip(leg.pop("params"), plain["params"]))
        if diff != 0.0 or leg["losses"] != plain["losses"]:
            raise AssertionError(f"axis TRAIN leg {kind}: parameters differ "
                                 f"from plain AdamW's by {diff:.3e}, losses "
                                 f"{leg['losses']} against "
                                 f"{plain['losses']}")
        legs[kind] = leg
        _collect()
    plain.pop("params")
    log(f"axis TRAIN legs on {card} ({AXIS_TRAIN_STEPS} eager steps of batch "
        f"{TRAIN_BATCH} x {TRAIN['max_seq']}, axis_name='dp' at size 1): "
        "parameters and losses bit-equal to plain AdamW's; step ms "
        + "; ".join(f"{k} {v['step_ms']}" for k, v in
                    {"plain": plain, **legs}.items())
        + f"; K1-K3 launches a leg {legs['adasum']['launches']}")
    return {"plain": plain, **legs, "launches": {
        k: sum(leg["launches"][k] for leg in legs.values())
        for k in plain["launches"]}}


def collectives_size_one(card: str) -> dict:
    """The collectives phase: a size-1 NCCL group on the card, twice:
    through the native eager runtime (``basics.init``'s default) and with
    ``HOROVOD_NATIVE=0`` (the direct path), each with the axis forms;
    then once more after ``basics.init(axis_name="workers")``: the axis
    forms again, the new flat name, and the two TRAIN legs over
    ``axis_name="dp"`` (:func:`axis_train_legs`)."""
    from horovod_tpu_torch import basics, eager_runtime

    out = {}
    for mode in ("native", "direct"):
        saved = os.environ.get("HOROVOD_NATIVE")
        if mode == "direct":
            os.environ["HOROVOD_NATIVE"] = "0"
        try:
            basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
        finally:
            if saved is None:
                os.environ.pop("HOROVOD_NATIVE", None)
            else:
                os.environ["HOROVOD_NATIVE"] = saved
        try:
            rt = eager_runtime.get()
            if (rt is None) != (mode == "direct"):
                raise AssertionError(f"collectives {mode}: runtime {rt}")
            checked = check_collectives(basics.device())
            t_axes = time.monotonic()
            axes = check_axis_forms(basics.device())
            t_axes = time.monotonic() - t_axes
            responses = rt.responses_executed if rt is not None else 0
            if mode == "native" and responses == 0:
                raise AssertionError("no collective went through the runtime")
        finally:
            basics.shutdown()
        log(f"collectives at size 1 over NCCL ({mode}), f32 and bf16, each "
            f"equal to its size-1 value: {len(checked)} checks, {responses} "
            "native responses: "
            + ", ".join(sorted({c.rsplit(".", 1)[0] if c.endswith((
                "float32", "bfloat16")) else c for c in checked})))
        log(f"collectives axis forms at size 1 ({mode}): {len(axes)} checks "
            f"exact in {t_axes:.2f} s over "
            + ", ".join(str(a) for a in AXIS_FORMS))
        out[mode] = {"checked": checked, "native_responses": responses,
                     "axis_forms": axes, "axis_forms_s": t_axes}
    t0 = time.monotonic()
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}",
                axis_name="workers")
    try:
        dev = basics.device()
        workers = check_workers_axis(dev) + check_axis_forms(dev)
        legs = axis_train_legs(card)
    finally:
        basics.shutdown()
    out["workers"] = {"checked": workers, "seconds": time.monotonic() - t0}
    out["axis_train"] = legs
    out["launches"] = legs.pop("launches")
    log(f"collectives after init(axis_name='workers'): {len(workers)} checks "
        f"exact; with the TRAIN legs {out['workers']['seconds']:.1f} s")
    return out


# --- the eager_native phase: the native control plane's eager runtime ----------

# benchmarks/eager_fusion.py's bert_style_tensors at its defaults: 24
# layers x 14 tensors at hidden 256 (1 KB - 512 KB each, f32).
EAGER_LAYERS, EAGER_HIDDEN = 24, 256
EAGER_TURNS, EAGER_STEPS = 3, 4


def _bert_style_shapes(layers: int = EAGER_LAYERS,
                       hidden: int = EAGER_HIDDEN) -> list:
    h = hidden
    return [shape for _ in range(layers) for shape in (
        (h, h), (h, h), (h, h), (h, h), (h, 2 * h), (2 * h, h), (h,), (h,),
        (h,), (h,), (2 * h,), (h,), (h,), (h,))]


def _eager_step(tensors, prefix: str, direct: bool):
    """One step of the torch-hook pattern: an ``allreduce_async`` a
    tensor, then ``synchronize`` each -> (results, seconds)."""
    import contextlib

    from horovod_tpu_torch.ops import collectives as C

    ctx = C._direct_path() if direct else contextlib.nullcontext()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ctx:
        hs = [C.allreduce_async(t, C.Average, name=f"{prefix}.{i}")
              for i, t in enumerate(tensors)]
        outs = [C.synchronize(h) for h in hs]
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def _eager_load(rt, tensors, prefix: str) -> dict:
    """Native against direct in turns: the median ms a step, responses a
    step, tensors / responses (the fusion ratio) and cache hits a step;
    every native result equal to the direct one bit for bit."""
    want, _ = _eager_step(tensors, prefix, True)
    _eager_step(tensors, prefix, False)  # warm: the cache fills
    times = {"native": [], "direct": []}
    resp = tens = hits = 0
    for _ in range(EAGER_TURNS):
        for mode in ("native", "direct"):
            for _ in range(EAGER_STEPS):
                r0, t0, h0 = (rt.responses_executed, rt.tensors_executed,
                              rt.cache_hits())
                outs, dt = _eager_step(tensors, prefix, mode == "direct")
                times[mode].append(dt)
                if mode == "native":
                    resp += rt.responses_executed - r0
                    tens += rt.tensors_executed - t0
                    hits += rt.cache_hits() - h0
                for o, w in zip(outs, want):
                    if not torch.equal(o, w):
                        raise AssertionError(f"{prefix}: native {mode} "
                                             "result differs from direct")
                del outs
    n = EAGER_TURNS * EAGER_STEPS
    if tens != n * len(tensors):
        raise AssertionError(f"{prefix}: {tens} tensors executed, want "
                             f"{n * len(tensors)}")
    return {"tensors": len(tensors),
            "values": sum(t.numel() for t in tensors),
            "bytes": sum(t.numel() * t.element_size() for t in tensors),
            "native_ms_median": statistics.median(times["native"]) * 1e3,
            "direct_ms_median": statistics.median(times["direct"]) * 1e3,
            "native_ms": [round(s * 1e3, 4) for s in times["native"]],
            "direct_ms": [round(s * 1e3, 4) for s in times["direct"]],
            "responses_per_step": resp / n, "fusion_ratio": tens / resp,
            "cache_hits_per_step": hits / n, "bit_equal": True}


def _side_stream_check(dev) -> dict:
    """A tensor written on a side stream behind a long kernel and submitted
    from that stream without a sync comes back right: the executor's
    stream waits for the event recorded at submission."""
    from horovod_tpu_torch.ops import collectives as C

    x = torch.zeros(1 << 22, device=dev)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)  # ~50 ms of spinning on the stream
        x.fill_(3.0)
        out = C.synchronize(C.allreduce_async(x, C.Sum, name="side.stream"))
        ok = bool((out == 3.0).all())
    if not ok:
        raise AssertionError("side stream: the collective read the tensor "
                             "before the side stream wrote it")
    return {"ok": ok, "elements": x.numel()}


def _latency(dev, reps: int = 50) -> dict:
    """What the negotiation cycle costs one op: the median ms of a 4-byte
    allreduce and of ``state.broadcast_object`` (the elastic respawn's
    restore) through the runtime against the direct path, in turns."""
    import contextlib

    from horovod_tpu_torch import state
    from horovod_tpu_torch.ops import collectives as C

    x = torch.ones(1, device=dev)
    obj = {"step": 7, "lr": 1e-3, "names": ["w"] * 64}
    times = {}
    for turn in range(2):
        for mode in ("native", "direct"):
            ctx = C._direct_path if mode == "direct" else \
                contextlib.nullcontext
            for label, fn in (("allreduce", lambda: C.allreduce(x, C.Sum)),
                              ("broadcast_object",
                               lambda: state.broadcast_object(obj, 0))):
                ms = []
                with ctx():
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t0) * 1e3)
                times.setdefault(f"{label}_{mode}_ms", []).append(
                    statistics.median(ms))
    return {k: min(v) for k, v in times.items()} | {"reps": reps}


def _captured_step_no_responses(rt, dev) -> dict:
    """A training step captured as a CUDA graph with the runtime up: one
    capture, its collectives direct, 0 native responses across it."""
    from horovod_tpu_torch import optim, spmd

    g = torch.Generator(device=dev).manual_seed(3)
    w1 = torch.randn((256, 512), generator=g, device=dev).mul_(0.05)
    w2 = torch.randn((512, 16), generator=g, device=dev).mul_(0.05)
    params = [w1.requires_grad_(), w2.requires_grad_()]
    opt = optim.DistributedOptimizer(torch.optim.AdamW(params, lr=1e-3))

    def loss_fn(ps, batch):
        return torch.nn.functional.cross_entropy(
            torch.relu(batch["x"] @ ps[0]) @ ps[1], batch["y"])

    step = spmd.make_train_step(loss_fn, opt)
    batch = {"x": torch.randn((64, 256), generator=g, device=dev),
             "y": torch.randint(0, 16, (64,), generator=g, device=dev)}
    r0 = rt.responses_executed
    losses = [float(step(params, batch)) for _ in range(6)]
    responses = rt.responses_executed - r0
    if step.captures != 1 or step.replays < 3 or responses != 0:
        raise AssertionError(f"captured step: {step.captures} captures, "
                             f"{step.replays} replays, {responses} native "
                             "responses")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"captured step losses {losses}")
    return {"captures": step.captures, "replays": step.replays,
            "native_responses": responses, "losses": losses}


def _autotune_windows(rt, tensors) -> dict:
    """A few autotune windows over the many-tensor load: each window's
    fusion threshold applied behind a native barrier; results equal the
    direct path's throughout."""
    from horovod_tpu_torch.autotune import Autotuner

    want, _ = _eager_step(tensors, "tune", True)
    tuner = Autotuner(warmup_samples=0, steps_per_sample=1, bo_samples=4,
                      sync_scores=False, categoricals=[])
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    windows = []
    while tuner.active:
        r0, t0 = rt.responses_executed, rt.tensors_executed
        thr = tuner.fusion_threshold
        outs, dt = _eager_step(tensors, "tune", False)
        for o, w in zip(outs, want):
            if not torch.equal(o, w):
                raise AssertionError("autotune: a result differs from the "
                                     "direct path's")
        windows.append({"fusion_threshold": thr,
                        "cycle_time_ms": round(tuner.cycle_time_ms, 3),
                        "ms": dt * 1e3,
                        "responses": rt.responses_executed - r0,
                        "tensors": rt.tensors_executed - t0})
        tuner.record(nbytes, dt)
    rt.set_fusion_bytes(64 << 20)
    rt.set_cycle_ms(1.0)
    if len({w["fusion_threshold"] for w in windows}) < 2:
        raise AssertionError(f"autotune never moved the threshold {windows}")
    return {"windows": windows, "final": tuner.settings}


def eager_native(card: str) -> dict:
    """The eager_native phase on a size-1 NCCL group, the runtime up:

    (a) the full-width training LM's (``TRAIN``) parameter tensors as f32
        gradients, one ``allreduce_async`` each, then ``synchronize``;
    (b) benchmarks/eager_fusion.py's 336 tensors (24 layers x 14 at
        hidden 256), built here;

    each native against direct in turns, bit for bit; then the side-stream
    ordering check, ``join()`` through the native join, a few autotune
    windows, and a captured training step with 0 native responses."""
    from horovod_tpu_torch import basics, eager_runtime, optim
    from horovod_tpu_torch.models import transformer as T

    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        rt = eager_runtime.get()
        if rt is None:
            raise AssertionError("eager_native: the runtime is not up")
        dev = basics.device()
        g = torch.Generator(device=dev).manual_seed(19)
        params = T.init_params(T.TransformerConfig(**TRAIN), seed=0,
                               param_dtype=torch.float32)
        shapes = [tuple(p.shape) for _, p in optim.named_parameters(params)]
        del params
        full = [torch.randn(s, generator=g, device=dev) for s in shapes]
        res = {"full_width": _eager_load(rt, full, "lm")}
        del full
        torch.cuda.empty_cache()
        many = [torch.randn(s, generator=g, device=dev)
                for s in _bert_style_shapes()]
        res["many_small"] = _eager_load(rt, many, "bert")
        if res["many_small"]["fusion_ratio"] <= 1.0:
            raise AssertionError("no fusion over the 336-tensor set: "
                                 f"{res['many_small']}")
        res["side_stream"] = _side_stream_check(dev)
        join = __import__("importlib").import_module("horovod_tpu_torch.join")
        joined = join.join()
        if joined != 0 or rt.last_joined_rank() != 0:
            raise AssertionError(f"native join: {joined}, last joined "
                                 f"{rt.last_joined_rank()}")
        res["join"] = {"returned": joined,
                       "last_joined_rank": rt.last_joined_rank()}
        res["autotune"] = _autotune_windows(rt, many)
        del many
        res["captured_step"] = _captured_step_no_responses(rt, dev)
        res["latency"] = _latency(dev)
        res["cycle_ms"] = float(os.environ.get("HOROVOD_CYCLE_TIME") or 1.0)
    finally:
        basics.shutdown()
    for key in ("full_width", "many_small"):
        r = res[key]
        log(f"eager_native {key} on {card}: {r['tensors']} f32 tensors, "
            f"{r['values']} values ({r['bytes'] / 1e9:.3f} GB), a step "
            f"median {r['native_ms_median']:.3f} ms native against "
            f"{r['direct_ms_median']:.3f} ms direct; "
            f"{r['responses_per_step']:.2f} responses a step, fusion ratio "
            f"{r['fusion_ratio']:.2f}, {r['cache_hits_per_step']:.1f} cache "
            "hits a step; bit-equal to direct")
    log(f"eager_native on {card}: side stream ok; join() "
        f"{res['join']['returned']} (last joined "
        f"{res['join']['last_joined_rank']}); autotune thresholds "
        f"{[w['fusion_threshold'] for w in res['autotune']['windows']]} "
        "responses "
        f"{[w['responses'] for w in res['autotune']['windows']]}, results "
        f"equal; captured step {res['captured_step']['captures']} capture, "
        f"{res['captured_step']['replays']} replays, "
        f"{res['captured_step']['native_responses']} native responses")
    lat = res["latency"]
    log(f"eager_native latency on {card} (median ms of one call, best of "
        f"two turns, cycle {res['cycle_ms']} ms): allreduce of 4 bytes "
        f"{lat['allreduce_native_ms']:.3f} native against "
        f"{lat['allreduce_direct_ms']:.3f} direct; broadcast_object "
        f"{lat['broadcast_object_native_ms']:.3f} against "
        f"{lat['broadcast_object_direct_ms']:.3f}")
    return res


# --- the frontend phase: horovod.torch over the card -------------------------

# The LM leg: TRAIN through the hook optimizer and the step-time one,
# FRONT_STEPS steps each at k = 1 and 2 (k backward passes a step, each
# on its own batch).  The ResNet-50 leg: batch FRONT_RESNET_BATCH as the
# vision phase's b64 legs, bench.measure's protocol cut to
# FRONT_RESNET_ITERS timed iterations of FRONT_RESNET_PER_ITER steps
# after as many warm-up steps.  The estimator leg: a TorchEstimator
# of FRONT_EST_ROWS rows at num_proc 1 on the card.
FRONT_STEPS = {1: 4, 2: 2}
FRONT_RESNET_BATCH, FRONT_RESNET_ITERS, FRONT_RESNET_PER_ITER = 64, 3, 5
FRONT_EST_ROWS, FRONT_EST_EPOCHS = 1024, 3


def _front_lm_leg(kind: str, k: int, rt) -> dict:
    """TRAIN from ``init_params`` seed 0, ``FRONT_STEPS[k]`` steps of k
    passes through ``kind``'s optimizer over one AdamW configuration
    (``capturable`` with a device ``lr`` in both, as
    ``optim.DistributedOptimizer`` sets its own): the frontend's hooks
    fire during each backward and ``step()`` waits for them; the
    step-time optimizer reduces at its k-th ``step()``.  Returns the
    parameters after the last step, the step times and the runtime's
    counters a step; the hook leg's K1-K3 launches too."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import optim
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A

    cfg = T.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
    named = optim.named_parameters(params)
    for _, t in named:
        t.requires_grad_()
    dev = named[0][1].device
    lr = torch.tensor(3e-4, dtype=torch.float32, device=dev)
    inner = torch.optim.AdamW([t for _, t in named], lr=lr,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4, capturable=True)
    if kind == "hooks":
        opt = hvd.DistributedOptimizer(inner, named_parameters=named,
                                       backward_passes_per_step=k)
        if opt.graph_safe:
            raise AssertionError("the frontend's optimizer claims graph_safe")
    else:
        opt = optim.DistributedOptimizer(inner, named_parameters=named,
                                         backward_passes_per_step=k)
    batches = [T.synthetic_batch(100 + i, cfg, TRAIN_BATCH, TRAIN["max_seq"])
               for i in range(FRONT_STEPS[k] * k)]
    torch.cuda.synchronize()
    A.flash_fwd_launches = 0
    A.flash_bwd_dkdv_launches = 0
    A.flash_bwd_dq_launches = 0
    c0, r0, t0 = rt.cycles(), rt.responses_executed, rt.tensors_executed
    times, losses = [], []
    for s in range(FRONT_STEPS[k]):
        t_start = time.monotonic()
        if kind == "hooks":
            opt.zero_grad()
        for j in range(k):
            if kind == "step":
                opt.zero_grad()
            loss = T.loss_fn(params, batches[s * k + j], cfg)
            loss.backward()
            if kind == "step":
                opt.step()
        if kind == "hooks":
            opt.step()
        losses.append(float(loss.detach()))  # waits for the card
        times.append(time.monotonic() - t_start)
    n = FRONT_STEPS[k]
    out = {"params": [t.detach() for _, t in named],
           "step_ms": [round(x * 1e3, 3) for x in times],
           "step_ms_median": statistics.median(times) * 1e3,
           "losses": losses,
           "cycles_per_step": (rt.cycles() - c0) / n,
           "responses_per_step": (rt.responses_executed - r0) / n,
           "tensors_per_step": (rt.tensors_executed - t0) / n,
           "launches": {"flash_fwd": A.flash_fwd_launches,
                        "flash_bwd_dkdv": A.flash_bwd_dkdv_launches,
                        "flash_bwd_dq": A.flash_bwd_dq_launches}}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"frontend LM [{kind} k={k}]: losses {losses}")
    want = cfg.n_layers * n * k
    if kind == "hooks" and out["launches"] != dict.fromkeys(
            out["launches"], want):
        raise AssertionError(f"frontend LM [hooks k={k}]: K1-K3 launches "
                             f"{out['launches']}, want {want} each")
    if kind == "hooks" and out["tensors_per_step"] != len(named):
        raise AssertionError(f"frontend LM [hooks k={k}]: "
                             f"{out['tensors_per_step']} tensors a step "
                             f"through the runtime, want {len(named)}")
    if kind == "step" and out["tensors_per_step"] != 0:
        raise AssertionError("the step-time optimizer went through the "
                             "runtime")
    del opt, inner, batches
    return out


def _front_lm(k: int, rt, card: str) -> dict:
    hooks = _front_lm_leg("hooks", k, rt)
    step = _front_lm_leg("step", k, rt)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(hooks.pop("params"), step.pop("params")))
    if diff != 0.0:
        raise AssertionError(f"frontend LM k={k}: the hook optimizer's "
                             f"parameters differ from the step-time one's "
                             f"by {diff:.3e}")
    log(f"frontend LM k={k} on {card} (TRAIN, {FRONT_STEPS[k]} steps of "
        f"{k} x batch {TRAIN_BATCH}): parameters bit-equal to the step-time "
        f"optimizer's; median step ms hooks {hooks['step_ms_median']:.2f} "
        f"against step-time {step['step_ms_median']:.2f}; runtime cycles a "
        f"step {hooks['cycles_per_step']:.1f} against "
        f"{step['cycles_per_step']:.1f}; fused responses a step "
        f"{hooks['responses_per_step']:.2f} ({hooks['tensors_per_step']:.0f}"
        f" tensors) against {step['responses_per_step']:.2f}; K1-K3 "
        f"launches {hooks['launches']}")
    _collect()
    return {"hooks": hooks, "step": step, "max_abs_diff": diff}


class _Timed:
    """A function wrapped to count its calls and the seconds inside."""

    def __init__(self, fn):
        self.fn, self.s, self.n = fn, 0.0, 0

    def __call__(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **k)
        finally:
            self.s += time.perf_counter() - t0
            self.n += 1


def _front_resnet_hooks(rt) -> dict:
    """ResNet-50 as an ``nn.Module`` through the frontend's hooks (SGD
    with momentum), bench.measure's protocol at batch 64, after
    ``broadcast_parameters`` of its state dict (BatchNorm buffers
    included).  With the runtime up (``rt``), the seconds a step spent in
    the hooks' submissions and in the runtime's executor are counted too
    (each wrapped in a timer)."""
    import torch.nn.functional as F

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import bench

    model = bench.create_model("ResNet50", seed=0, device="cuda")
    sd = model.state_dict()
    before = {k: v.clone() for k, v in sd.items()}
    hvd.broadcast_parameters(sd, root_rank=0)
    for k, v in sd.items():
        if not (v.shape == before[k].shape and v.dtype == before[k].dtype
                and torch.equal(v, before[k])):
            raise AssertionError(f"frontend ResNet: broadcast changed {k}")
    n_hooks = sum(1 for p in model.parameters() if p.requires_grad)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters())
    calls = [0]

    def run(m, b):
        calls[0] += 1
        opt.zero_grad()
        loss = F.cross_entropy(m(b["images"]), b["labels"])
        loss.backward()
        opt.step()
        return loss.detach()

    data = bench.synthetic_batch(FRONT_RESNET_BATCH, VISION_SIZE,
                                 device="cuda")
    submit = _Timed(hvd.allreduce_async_)
    hvd.allreduce_async_ = submit  # the hooks look it up at each call
    if rt is not None:
        execute = _Timed(rt._execute)
        rt._rt.set_executor(execute)
        c0, r0, t0 = rt.cycles(), rt.responses_executed, rt.tensors_executed
    try:
        res = bench.measure(run, model, data, warmup=FRONT_RESNET_PER_ITER,
                            per_iter=FRONT_RESNET_PER_ITER,
                            iters=FRONT_RESNET_ITERS)
    finally:
        hvd.allreduce_async_ = submit.fn
        if rt is not None:
            rt._rt.set_executor(rt._execute)
    _check_losses("frontend ResNet", res["losses"])
    n = calls[0]
    out = {"img_per_sec": res["img_per_sec"],
           "img_per_sec_median": statistics.median(res["img_per_sec"]),
           "losses": res["losses"], "hooks": n_hooks, "steps": n,
           "state_dict_tensors": len(sd),
           "hook_submit_ms_per_step": submit.s / n * 1e3,
           "hook_submits_per_step": submit.n / n}
    if submit.n != n * n_hooks:
        raise AssertionError(f"frontend ResNet: {submit.n} hook submissions "
                             f"in {n} steps of {n_hooks} hooks")
    if rt is not None:
        out.update(tensors_per_step=(rt.tensors_executed - t0) / n,
                   responses_per_step=(rt.responses_executed - r0) / n,
                   cycles_per_step=(rt.cycles() - c0) / n,
                   executor_ms_per_step=execute.s / n * 1e3)
        if out["tensors_per_step"] != n_hooks:
            raise AssertionError(f"frontend ResNet: {out['tensors_per_step']}"
                                 f" tensors a step, want {n_hooks}")
    del model, opt, data
    _collect()
    return out


def _front_resnet(rt, card: str) -> dict:
    """The ResNet-50 leg: the hooks through the runtime, then a fresh
    model through the bench's step-time step (the vision phase's eager
    body) in the same protocol, for the img/s beside it."""
    from horovod_tpu_torch import bench

    out = _front_resnet_hooks(rt)
    model = bench.create_model("ResNet50", seed=0, device="cuda")
    step = bench.make_step(model)
    data = bench.synthetic_batch(FRONT_RESNET_BATCH, VISION_SIZE,
                                 device="cuda")
    ref = bench.measure(step.body, model, data, warmup=FRONT_RESNET_PER_ITER,
                        per_iter=FRONT_RESNET_PER_ITER,
                        iters=FRONT_RESNET_ITERS)
    _check_losses("frontend ResNet, step-time", ref["losses"])
    out.update(step_time_img_per_sec=ref["img_per_sec"],
               step_time_img_per_sec_median=statistics.median(
                   ref["img_per_sec"]))
    log(f"frontend ResNet-50 on {card} (batch {FRONT_RESNET_BATCH}, SGD "
        f"momentum through the hooks): {out['img_per_sec_median']:.1f} img/s"
        f" (median of {FRONT_RESNET_ITERS}) against the step-time "
        f"optimizer's {out['step_time_img_per_sec_median']:.1f} in the same "
        f"protocol; {out['hooks']} hooks, {out['tensors_per_step']:.0f} "
        f"tensors a step in {out['responses_per_step']:.2f} responses over "
        f"{out['cycles_per_step']:.1f} cycles; a step's hook submissions "
        f"{out['hook_submit_ms_per_step']:.2f} ms, the executor "
        f"{out['executor_ms_per_step']:.2f} ms; "
        f"{out['state_dict_tensors']} state-dict tensors broadcast; losses "
        f"{[round(v, 4) for v in out['losses'][:3]]} … "
        f"{round(out['losses'][-1], 4)}")
    del model, step, data
    _collect()
    return out


def _est_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(16, 64), torch.nn.ReLU(),
                               torch.nn.Linear(64, 1))


def _est_opt(params):
    return torch.optim.SGD(params, lr=0.05, momentum=0.9)


def _front_estimator(tmp: Path, card: str) -> dict:
    """One TorchEstimator fit and predict at num_proc 1, its rank on the
    card through the port's launcher (the device by the port's rule)."""
    import torch.nn.functional as F

    from horovod_tpu_torch.estimator import (EstimatorParams, LocalStore,
                                             TorchEstimator)

    rng = np.random.RandomState(0)
    x = rng.randn(FRONT_EST_ROWS, 16).astype(np.float32)
    y = (x @ rng.randn(16, 1)).astype(np.float32)
    t0 = time.monotonic()
    est = TorchEstimator(model_factory=_est_model,
                         optimizer_factory=_est_opt, loss_fn=F.mse_loss,
                         store=LocalStore(str(tmp / "store")),
                         params=EstimatorParams(num_proc=1, batch_size=64,
                                                epochs=FRONT_EST_EPOCHS))
    model = est.fit(x, y)
    ran_on = []
    hook = model.model.register_forward_hook(
        lambda mod, inp, out: ran_on.append(out.device.type))
    pred = model.predict(x[:8])
    hook.remove()
    dt = time.monotonic() - t0
    hist = model.history
    if not model.trained_on.startswith("cuda"):
        raise AssertionError(
            f"estimator: the rank trained on {model.trained_on}")
    if ran_on != ["cuda"] or not model.device.startswith("cuda"):
        raise AssertionError(f"estimator: predict ran on {ran_on}, the "
                             f"model on {model.device}")
    if not (len(hist) == FRONT_EST_EPOCHS and hist[-1] < hist[0]):
        raise AssertionError(f"estimator: the loss did not fall: {hist}")
    if pred.shape != (8, 1) or not np.isfinite(pred).all():
        raise AssertionError(f"estimator: predictions {pred}")
    log(f"frontend TorchEstimator on {card}: num_proc 1 trained on "
        f"{model.trained_on}, predicted on {model.device}; epoch losses "
        f"{[round(v, 5) for v in hist]}; fit and predict {dt:.1f} s")
    return {"device": model.trained_on, "predict_device": model.device,
            "history": hist, "seconds": dt}


def frontend_full_width(card: str, tmp: Path) -> dict:
    """The frontend phase on a size-1 NCCL group, the runtime up: the LM
    leg (k = 1 and 2), the ResNet-50 leg, a frontend call given a CPU
    tensor raising, then the estimator leg in a rank of its own."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import basics, eager_runtime

    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        rt = eager_runtime.get()
        if rt is None:
            raise AssertionError("frontend: the runtime is not up")
        res = {"lm": {f"k{k}": _front_lm(k, rt, card) for k in (1, 2)}}
        res["resnet"] = _front_resnet(rt, card)
        try:
            hvd.allreduce(torch.ones(4))
        except ValueError as e:
            res["cpu_tensor_refused"] = str(e)
        else:
            raise AssertionError("frontend: a CPU tensor in a CUDA job was "
                                 "reduced")
    finally:
        basics.shutdown()
    # The hooks again with the runtime off: each an async NCCL allreduce
    # launched from autograd's thread.
    saved = os.environ.get("HOROVOD_NATIVE")
    os.environ["HOROVOD_NATIVE"] = "0"
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        off = _front_resnet_hooks(None)
    finally:
        basics.shutdown()
        if saved is None:
            os.environ.pop("HOROVOD_NATIVE")
        else:
            os.environ["HOROVOD_NATIVE"] = saved
    res["resnet"]["native_off_img_per_sec_median"] = off["img_per_sec_median"]
    res["resnet"]["native_off_hook_submit_ms_per_step"] = \
        off["hook_submit_ms_per_step"]
    log(f"frontend ResNet-50 on {card}, the runtime off "
        f"(HOROVOD_NATIVE=0): {off['img_per_sec_median']:.1f} img/s; a "
        f"step's hook submissions {off['hook_submit_ms_per_step']:.2f} ms")
    res["estimator"] = _front_estimator(tmp, card)
    res["launches"] = {k: sum(leg["hooks"]["launches"][k]
                              for leg in res["lm"].values())
                       for k in ("flash_fwd", "flash_bwd_dkdv",
                                 "flash_bwd_dq")}
    return res


# --- mixture of experts --------------------------------------------------------

# benchmarks/moe_dispatch_ab.py's defaults: d1024, L8, 16 heads (MHA),
# d_ff 2048, seq 2048, batch 4, capacity factor 1.25, flash attention;
# pairs round-robined MOE_ROUNDS times, MOE_STEPS_PER_ROUND steps a
# turn, each model keeping its best turn.
MOE_TRAIN = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
                 n_kv_heads=0, d_ff=2048, max_seq=2048, attention_impl="flash",
                 capacity_factor=1.25)
MOE_BATCH, MOE_ROUNDS, MOE_STEPS_PER_ROUND = 4, 4, 3
# The eager legs' steps: the first MOE_EAGER_STEPS of the captured
# switch-sort leg (its two warm-up steps and three replays).
MOE_EAGER_STEPS = 5
# The serving configuration with 8 experts of d_ff 2048.
MOE_FULL = dict(FULL, d_ff=2048, n_experts=8)
# G1's checks: group sizes over 8 experts at the prefill's T = 4 x 2048
# (drawn from a multinomial), every row on one expert, empty experts, and
# T = 1, 17 and 8191; at the gate (K 1024, N 2048) and down (K 2048,
# N 1024) products.
GMM_SHAPES = {"gate": (1024, 2048), "down": (2048, 1024)}
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _gmm_counts() -> dict:
    rng = np.random.default_rng(14)
    return {"prefill": rng.multinomial(8192, [1 / 8] * 8).tolist(),
            "skewed": [0, 0, 8192, 0, 0, 0, 0, 0],
            "empty": [0, 300, 0, 0, 517, 0, 0, 207],
            "T1": [0, 0, 0, 1, 0, 0, 0, 0],
            "T17": [5, 0, 12, 0, 0, 0, 0, 0],
            "T8191": rng.multinomial(8191, [1 / 8] * 8).tolist()}


def _gmm_inputs(counts, K, N, dtype, seed=0):
    """xs (T, K), w (E, K, N), the offsets, and an output gradient dy
    (T, N) for the backward products."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn((sum(counts), K), generator=g, device="cuda").to(dtype)
    w = (torch.randn((len(counts), K, N), generator=g, device="cuda")
         / math.sqrt(K)).to(dtype)
    off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                       dtype=torch.int32, device="cuda")
    dy = torch.randn((sum(counts), N), generator=g, device="cuda").to(dtype)
    return xs, w, off, dy


def _gmm_products():
    """The three grouped products of the dropless dispatch and its
    backward, each ``(kernel wrapper, plain version, operands)`` over
    :func:`_gmm_inputs`' tensors: G1 forward, G1 with W read transposed
    (dx) and G2 (dW)."""
    from horovod_tpu_torch.ops import grouped_matmul as GM

    return {"G1": (GM.grouped_matmul, GM.grouped_matmul_reference,
                   lambda xs, w, off, dy: (xs, w, off)),
            "G1_dx": (GM.grouped_matmul_dx, GM.grouped_matmul_dx_reference,
                      lambda xs, w, off, dy: (dy, w, off)),
            "G2": (GM.grouped_matmul_dw, GM.grouped_matmul_dw_reference,
                   lambda xs, w, off, dy: (xs, dy, off))}


def check_grouped() -> dict:
    """G1 (forward and with W read transposed, dx) and G2 (dW) against
    their plain versions in both dtypes, at both products' shapes, for
    every case of :func:`_gmm_counts`; each relative error (of the
    largest output) beside its tolerance.  Then row invariance of G1's
    two modes, bit for bit: the prefill case's rows again with 37 rows
    ahead of them and expert 3 emptied (T and every row's tile position
    change).  Then G2's determinism: two calls bit-identical on the
    prefill, skewed and empty routings at the gate shape."""
    errs, abs_errs = {}, {}
    products = _gmm_products()
    for dtype in (torch.bfloat16, torch.float32):
        for shape, (K, N) in GMM_SHAPES.items():
            for case, counts in _gmm_counts().items():
                ops = _gmm_inputs(counts, K, N, dtype)
                for prod, (kernel, plain, args) in products.items():
                    out = kernel(*args(*ops))
                    ref = plain(*args(*ops))
                    torch.cuda.synchronize()
                    diff = (out.float() - ref.float()).abs().max()
                    err = (diff / ref.float().abs().max()).item()
                    key = f"{prod}.{str(dtype)[6:]}.{shape}.{case}"
                    errs[key], abs_errs[key] = err, diff.item()
                    if not (err <= GMM_TOL[dtype]
                            and torch.isfinite(out).all()):
                        raise AssertionError(f"{key}: error {err:.3e} > "
                                             f"{GMM_TOL[dtype]}")
                del ops
        counts = _gmm_counts()["prefill"]
        xs, w, off, dy = _gmm_inputs(counts, 1024, 2048, dtype)
        starts = np.concatenate([[0], np.cumsum(counts)])
        counts_b = [counts[0] + 37, *counts[1:3], 0, *counts[4:]]
        off_b = torch.tensor(np.concatenate([[0], np.cumsum(counts_b)]),
                             dtype=torch.int32, device="cuda")
        for prod in ("G1", "G1_dx"):
            kernel = products[prod][0]
            a = xs if prod == "G1" else dy
            out = kernel(a, w, off)
            extra = torch.randn((37, a.shape[1]), device="cuda").to(dtype)
            out_b = kernel(torch.cat([extra, a[:starts[3]], a[starts[4]:]]),
                           w, off_b)
            if not torch.equal(out_b[37:], torch.cat([out[:starts[3]],
                                                      out[starts[4]:]])):
                raise AssertionError(f"{prod} {dtype}: rows differ between "
                                     "batches")
        del xs, w, off, dy
        kernel = products["G2"][0]
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        for case in ("prefill", "skewed", "empty"):
            xs, _, off, dy = _gmm_inputs(_gmm_counts()[case], 1024, 2048,
                                         dtype)
            if not torch.equal(kernel(xs, dy, off).view(bits),
                               kernel(xs, dy, off).view(bits)):
                raise AssertionError(f"G2 {dtype} {case}: two calls differ")
            del xs, off, dy
    worst = {f"{prod}.{str(dt)[6:]}": max(v for k, v in errs.items()
                                          if k.startswith(
                                              f"{prod}.{str(dt)[6:]}."))
             for prod in products for dt in GMM_TOL}
    log(f"grouped products against their plain versions, {len(errs)} cases "
        f"(G1 forward, G1 transposed for dx, G2 for dW; prefill, skewed, "
        f"empty experts, T = 1, 17, 8191; gate and down shapes): worst "
        f"relative error " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       worst.items())
        + " (limits bf16 2e-2, f32 1e-4); G1's rows bit-identical across "
        "batch compositions in both modes and both dtypes; G2 bit-identical "
        "over two calls (prefill, skewed, empty; both dtypes)")
    return {"errors": errs, "worst": worst, "row_invariant": True,
            "g2_deterministic": True,
            "max_abs_err": {prod: abs_errs[f"{prod}.bfloat16.gate.prefill"]
                            for prod in products},
            "abs_errors": abs_errs}


def _library_grouped(prod, xs, w, off, dy):
    """One PyTorch call computing a grouped product, which the port never
    makes: ``torch._grouped_mm`` (offsets of the groups' ends, int32) in
    bf16 — G1 ``(xs, W)``, dx ``(dy, W^T)`` and G2 ``(xs^T, dy)``, its
    2-D by 2-D form with a 3-D result; in f32 (which it does not take) a
    loop of per-expert cuBLAS products over counts read on the host.
    Held to the plain version.  -> (fn, name)."""
    plain, args = _gmm_products()[prod][1:]
    if xs.dtype == torch.bfloat16:
        ends = off[1:].contiguous()
        a, b = {"G1": (xs, w), "G1_dx": (dy, w.transpose(1, 2)),
                "G2": (xs.t(), dy)}[prod]

        def fn():
            return torch._grouped_mm(a, b, offs=ends)

        name = "torch._grouped_mm"
    else:
        bounds = off.tolist()
        spans = list(enumerate(zip(bounds[:-1], bounds[1:])))
        fn = {"G1": lambda: torch.cat([xs[i:j] @ w[e] for e, (i, j) in spans]),
              "G1_dx": lambda: torch.cat([dy[i:j] @ w[e].t()
                                          for e, (i, j) in spans]),
              "G2": lambda: torch.stack([xs[i:j].t() @ dy[i:j]
                                         for e, (i, j) in spans])}[prod]
        name = "per-expert cuBLAS loop (counts read on the host)"
    ref = plain(*args(xs, w, off, dy))
    err = ((fn().float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    if err > GMM_TOL[xs.dtype]:
        raise AssertionError(f"{name} ({prod}) disagrees with the plain "
                             f"version: {err:.3e}")
    return fn, name


# The timed products: (product, shape, dtype, routing).  The first G1
# and G2 rows are the kernels line's.
GMM_TIMED = (("G1", "gate", torch.bfloat16, "prefill"),
             ("G2", "gate", torch.bfloat16, "prefill"),
             ("G1", "down", torch.bfloat16, "prefill"),
             ("G1_dx", "gate", torch.bfloat16, "prefill"),
             ("G1_dx", "down", torch.bfloat16, "prefill"),
             ("G2", "down", torch.bfloat16, "prefill"),
             ("G2", "gate", torch.bfloat16, "skewed"),
             ("G1", "gate", torch.float32, "prefill"),
             ("G1_dx", "gate", torch.float32, "prefill"),
             ("G2", "gate", torch.float32, "prefill"),
             ("G2", "gate", torch.float32, "skewed"))


def time_grouped(errs: dict) -> list:
    """The grouped products at the MoE prefill's and training step's
    shapes (T = 4 x 2048, E = 8, the multinomial routing of
    :func:`_gmm_counts`; G2 also with every row on one expert): each
    with its bound, its plain version and one library call
    (:func:`_library_grouped`).  Bytes: each operand once, the output
    once; G1 reads the weights of every non-empty group, G2 writes every
    group's dW.  f32 is bound on the f32 rate outside the tensor
    cores.  ``errs``: :func:`check_grouped`'s absolute errors by case."""
    out = []
    products = _gmm_products()
    for prod, shape, dtype, case in GMM_TIMED:
        K, N = GMM_SHAPES[shape]
        counts = _gmm_counts()[case]
        ops = _gmm_inputs(counts, K, N, dtype, seed=5)
        kernel, plain, args = products[prod]
        call = args(*ops)
        T_, E = ops[0].shape[0], len(counts)
        ms, one = time_ms(lambda: kernel(*call)), \
            time_ms(lambda: kernel(*call), batch=1)
        plain_ms = _plain_ms(lambda: plain(*call), dtype)
        lib_fn, lib_name = _library_grouped(prod, *ops)
        lib = time_ms(lib_fn)
        flops = 2 * T_ * K * N
        live = sum(c > 0 for c in counts)
        elems = {"G1": T_ * K + T_ * N + live * K * N,
                 "G1_dx": T_ * N + T_ * K + live * K * N,
                 "G2": T_ * K + T_ * N + E * K * N}[prod]
        nbytes = ops[0].element_size() * elems + 4 * (E + 1)
        b_ms, b_by = bound(flops, nbytes, dtype)
        name = {"G1": "grouped_matmul", "G1_dx": "grouped_matmul_dx",
                "G2": "grouped_matmul_dw"}[prod] + _suffix(dtype)
        what = {"G1": "forward", "G1_dx": "dx = dy W^T, G1 transposed",
                "G2": "dW = xs^T dy"}[prod]
        out.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/grouped_matmul.cu",
            "replaces": "horovod_tpu/ops/moe.py:229 (lax.ragged_dot, an XLA "
                        "op: no Pallas original)" if prod != "G2" else
                        "horovod_tpu/ops/moe.py:229 (the VJP of "
                        "lax.ragged_dot, an XLA op: no Pallas original)",
            "launches": None,
            "max_abs_err": errs[f"{prod}.{_dt(dtype)}.{shape}.{case}"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib, "tflops": tflops(flops, ms),
            "one_call_ms": one, "library": lib_name,
            "shape": f"T={T_} K={K} N={N} E={E} {str(dtype)[6:]} ({shape} "
                     f"product, {what}) {case} groups {counts}"})
        del ops, call
    torch.cuda.empty_cache()
    return out


def _moe_cfg(dtype=torch.bfloat16, **kw):
    from horovod_tpu_torch.models import transformer as T

    return T.TransformerConfig(**{**MOE_TRAIN, **kw}, dtype=dtype)


def _moe_flops(cfg, tokens: int, executed: bool = False) -> float:
    """A step's useful FLOP (benchmarks/transformer.py's count): 6 x the
    matmul parameters x tokens, each token's MLP ONE expert (the expert
    stacks count 1/E), plus the causal attention scores; ``executed``
    counts every expert (the dense dispatch's work)."""
    D, L, S, F_ = cfg.d_model, cfg.n_layers, cfg.max_seq, cfg.d_ff
    attn_params = L * (2 * D * D + 2 * D * cfg.kv_heads * cfg.head_dim)
    E = max(cfg.n_experts, 1)
    experts = L * 3 * D * F_ * (E if executed else 1)
    router = L * D * E if E > 1 else 0
    head = D * cfg.vocab_size
    return 6 * (attn_params + experts + router + head) * tokens + \
        6 * L * tokens * S * D


def _moe_model(cfg) -> dict:
    """A captured train step of ``cfg`` on f32 master parameters from
    ``init_params`` seed 0: AdamW (the optax defaults but decay 1e-4),
    ``spmd.make_train_step``."""
    from horovod_tpu_torch import optim, spmd
    from horovod_tpu_torch.models import transformer as T

    params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
    named = optim.named_parameters(params)
    for _, t in named:
        t.requires_grad_()
    opt = optim.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in named], lr=3e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=named)
    step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
    if not step.graphed:
        raise AssertionError("make_train_step did not capture on CUDA")
    return {"cfg": cfg, "params": params, "opt": opt, "step": step,
            "losses": [], "best_s": math.inf}


def _moe_turn(m: dict, batch, n: int, counts: dict) -> float:
    """``n`` steps of model ``m``, synchronised: seconds a step.  The
    K1-K3, G1 and G2 launches of the steps are added to ``counts``; a
    dropless model must launch G1 six times a layer a step (three
    products and their dx) and G2 three times, any other none."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import grouped_matmul as GM

    A.flash_fwd_launches = A.flash_bwd_dkdv_launches = 0
    A.flash_bwd_dq_launches = 0
    GM.grouped_matmul_launches = GM.grouped_matmul_dw_launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        m["losses"].append(m["step"](m["params"], batch))
    torch.cuda.synchronize()
    dt = (time.monotonic() - t0) / n
    got = {"flash_fwd": A.flash_fwd_launches,
           "flash_bwd_dkdv": A.flash_bwd_dkdv_launches,
           "flash_bwd_dq": A.flash_bwd_dq_launches,
           "grouped_matmul": GM.grouped_matmul_launches,
           "grouped_matmul_dw": GM.grouped_matmul_dw_launches}
    cfg = m["cfg"]
    dropless = cfg.n_experts > 1 and cfg.moe_impl == "dropless"
    want = (6 * cfg.n_layers * n, 3 * cfg.n_layers * n) if dropless else (0, 0)
    if (got["grouped_matmul"], got["grouped_matmul_dw"]) != want:
        raise AssertionError(f"{n} steps of {cfg.moe_impl} launched G1 "
                             f"{got['grouped_matmul']} and G2 "
                             f"{got['grouped_matmul_dw']} times, not {want}")
    for k, v in got.items():
        counts[k] = counts.get(k, 0) + v
    return dt


def _moe_ab(models: dict, batch, counts: dict) -> dict:
    """Round-robin the pair (its models warmed and captured first):
    each model's best seconds a step over ``MOE_ROUNDS`` turns."""
    from horovod_tpu_torch import spmd

    best = {}
    for name, m in models.items():
        if m["step"].captures == 0:
            _moe_turn(m, batch, spmd.WARMUP_STEPS + 1, counts)
        best[name] = math.inf
    for _ in range(MOE_ROUNDS):
        for name, m in models.items():
            best[name] = min(best[name], _moe_turn(
                m, batch, MOE_STEPS_PER_ROUND, counts))
    return best


def _losses(m) -> list:
    return [float(x) for x in m["losses"]]


def _moe_grads(cfg, params, batch) -> list:
    from horovod_tpu_torch.models import transformer as T

    leaves = [t for t in [params["embed"], params["head"], params["ln_f"],
                          *params["layers"].values()]]
    return torch.autograd.grad(T.loss_fn(params, batch, cfg), leaves)


def moe_equalities_f32() -> dict:
    """At cf >= E nothing drops, so in f32 (TF32 off) the switch
    dispatch and the dropless dispatch (G1 forward; G1 transposed and G2
    backward) each equal the dense dispatch, outputs and every gradient:
    the CPU tests' tolerance, 1e-4 of the largest value.  The MoE
    training model's widths at E = 8, cut to 2 layers, one 2048-token
    row."""
    from horovod_tpu_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg(torch.float32, n_layers=2, n_experts=8, capacity_factor=8.0)
    params = T.init_params(cfg, seed=3)
    for t in [params["embed"], params["head"], params["ln_f"],
              *params["layers"].values()]:
        t.requires_grad_()
    batch = T.synthetic_batch(3, cfg, 1)
    outs, grads = {}, {}
    before = _by_dtype()
    for impl in ("switch", "dense", "dropless"):
        c = dataclasses.replace(cfg, moe_impl=impl)
        with torch.no_grad():
            outs[impl] = T.forward(params, batch["tokens"], c)
        grads[impl] = _moe_grads(c, params, batch)
    res = {"switch_vs_dense": _rel_err(outs["switch"], outs["dense"]),
           "dropless_vs_dense": _rel_err(outs["dropless"], outs["dense"]),
           "grads_switch_vs_dense": max(_rel_err(a, b) for a, b in zip(
               grads["switch"], grads["dense"])),
           "grads_dropless_vs_dense": max(_rel_err(a, b) for a, b in zip(
               grads["dropless"], grads["dense"]))}
    log(f"MoE f32 at cf = E = 8 (TF32 off): logits switch vs dense "
        f"{res['switch_vs_dense']:.3e}, dropless (G1) vs dense "
        f"{res['dropless_vs_dense']:.3e}; gradients switch vs dense "
        f"{res['grads_switch_vs_dense']:.3e}, dropless (G1 transposed, G2) "
        f"vs dense {res['grads_dropless_vs_dense']:.3e} (limit 1e-4 of the "
        f"largest)")
    if max(res.values()) > 1e-4:
        raise AssertionError(f"MoE dispatches differ at f32: {res}")
    # Every launch above is the gate's own run (f32): K1-K3 in all
    # three, G1 and G2 in the dropless one.
    res["launches"] = _by_dtype_since(before).get("float32", {})
    del params, outs, grads
    torch.cuda.empty_cache()
    return res


def moe_ep_size_one() -> dict:
    """``switch_moe(group=)`` over a size-1 NCCL group against the local
    call, bf16 and f32: outputs, aux and every gradient bit-identical."""
    import torch.distributed as dist

    from horovod_tpu_torch.ops import moe as M

    pg = dist.new_group([0])
    checked = []
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(8)
        x = torch.randn((4096, 1024), generator=g, device="cuda").to(dtype)
        router = torch.randn((1024, 8), generator=g, device="cuda") * 0.05
        w = [(torch.randn(s, generator=g, device="cuda") / math.sqrt(s[1])
              ).to(dtype) for s in ((8, 1024, 2048), (8, 1024, 2048),
                                    (8, 2048, 1024))]
        res = []
        for group in (None, pg):
            leaves = [t.detach().clone().requires_grad_()
                      for t in (x, router, *w)]
            y, aux = M.switch_moe(*leaves, capacity_factor=1.25, group=group,
                                  return_aux=True)
            (y.float().square().sum() + aux).backward()
            res.append([y, aux] + [t.grad for t in leaves])
        if not all(torch.equal(a, b) for a, b in zip(*res)):
            raise AssertionError(f"switch_moe over a size-1 group differs "
                                 f"from the local call ({dtype})")
        checked.append(str(dtype)[6:])
    log(f"expert parallelism at size 1 over NCCL: switch_moe(group=) equals "
        f"the local call bit for bit (output, aux, every gradient) in "
        f"{checked}")
    return {"bit_identical": checked}


def moe_train(card: str) -> dict:
    """``benchmarks/moe_dispatch_ab.py``'s protocol on the card (see
    ``MOE_TRAIN``), each model a captured ``make_train_step`` without
    remat (the protocol's remat ``dots`` runs its policy in Python, a
    host-bound step here: ``PERF.md`` §5), on a size-1 NCCL group: at
    E = 8 switch-sort against switch-cumsum, against dense dispatch and
    against the dense MLP; at E = 2 switch-sort against dense dispatch.
    Gates: sort and cumsum bit-identical (losses of every step, and the
    gradients of one step); the captured switch-sort leg's losses
    bit-identical to an eager leg's; a remat ``dots`` eager leg within
    1e-3 of it; with ``moe_aux_coeff`` 1e-2 the loss is the
    cross-entropy plus 1e-2 times the aux term, and ``expert_load``'s
    rows sum to 1; the f32 dispatch equalities at cf = E; expert
    parallelism at size 1."""
    from horovod_tpu_torch import basics

    gc.collect()
    torch.cuda.empty_cache()
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        out = {"equalities_f32": moe_equalities_f32(),
               "ep_size_one": moe_ep_size_one()}
        out.update(_moe_legs(card))
    finally:
        basics.shutdown()
    return out


def _moe_legs(card: str) -> dict:
    from horovod_tpu_torch.models import transformer as T

    tokens = MOE_BATCH * MOE_TRAIN["max_seq"]
    batch = T.synthetic_batch(0, _moe_cfg(), MOE_BATCH)
    counts: dict = {}
    rows, legs = [], {}

    def row(E, a, b, best, models):
        ratio = best[b] / best[a]
        rows.append({"E": E, "a": a, "b": b, "a_tok_per_s": tokens / best[a],
                     "b_tok_per_s": tokens / best[b], "a_over_b": ratio})
        for name in (a, b):
            m = models[name]
            cfg = m["cfg"]
            leg = legs.setdefault(f"E{E}.{name}" if cfg.n_experts else name,
                                  {"step_s_best": math.inf})
            leg["step_s_best"] = min(leg["step_s_best"], best[name])
            leg["tok_per_s"] = tokens / leg["step_s_best"]
            leg["mfu"] = _moe_flops(cfg, tokens) / leg["step_s_best"] / \
                PEAK_FLOPS[torch.bfloat16]
            if cfg.n_experts > 1 and cfg.moe_impl == "dense":
                leg["mfu_executed"] = _moe_flops(cfg, tokens, True) / \
                    leg["step_s_best"] / PEAK_FLOPS[torch.bfloat16]
            leg["captures"] = m["step"].captures
        log(f"moe_train E={E}: {a} {tokens / best[a]:.0f} tok/s | {b} "
            f"{tokens / best[b]:.0f} tok/s | {a} = {ratio:.2f}x of {b} "
            f"(best of {MOE_ROUNDS} turns of {MOE_STEPS_PER_ROUND} steps, "
            f"captured, {card})")

    for E, others in ((8, ("switch-cumsum", "dropless", "dense-dispatch",
                           "dense-mlp")),
                      (2, ("dense-dispatch",))):
        sort = _moe_model(_moe_cfg(n_experts=E, moe_dispatch="sort"))
        for other in others:
            cfg = {"switch-cumsum": _moe_cfg(n_experts=E,
                                             moe_dispatch="cumsum"),
                   "dropless": _moe_cfg(n_experts=E, moe_impl="dropless"),
                   "dense-dispatch": _moe_cfg(n_experts=E, moe_impl="dense"),
                   "dense-mlp": _moe_cfg(n_experts=0)}[other]
            models = {"switch-sort": sort, other: _moe_model(cfg)}
            best = _moe_ab(models, batch, counts)
            row(E, "switch-sort", other, best, models)
            if E == 8 and other == "switch-cumsum":
                a, b = _losses(sort), _losses(models[other])
                if a != b:
                    raise AssertionError(f"switch-sort and switch-cumsum "
                                         f"losses differ: {a} vs {b}")
                legs["E8.switch-sort"]["losses"] = a
            if other == "dropless":
                legs["E8.dropless"]["losses"] = _losses(models[other])
                legs["E8.dropless"]["profile"] = profile_train_step(
                    models[other]["step"], models[other]["params"], batch)
                dropless_eager = _dropless_eager_leg(models[other], batch)
            for t in models[other]["params"]["layers"].values():
                t.grad = None
            del models
            gc.collect()
            torch.cuda.empty_cache()
        if E == 8:
            # Where the switch-sort step's device time goes (one more
            # replay under the profiler).
            legs["E8.switch-sort"]["profile"] = profile_train_step(
                sort["step"], sort["params"], batch)
            eager = _moe_eager_legs(sort, batch, counts)
        del sort
        gc.collect()
        torch.cuda.empty_cache()
    return {"rows": rows, "legs": legs, **eager,
            "dropless_eager": dropless_eager, "launches": counts}


def _eager_leg(cfg, batch) -> tuple:
    """``MOE_EAGER_STEPS`` eager steps (``step.body``) of a fresh model
    of ``cfg`` from the captured legs' seed -> (losses, seconds a step)."""
    m = _moe_model(cfg)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(MOE_EAGER_STEPS):
        m["losses"].append(m["step"].body(m["params"], batch))
    torch.cuda.synchronize()
    step_s = (time.monotonic() - t0) / MOE_EAGER_STEPS
    losses = _losses(m)
    del m
    gc.collect()
    torch.cuda.empty_cache()
    return losses, step_s


def _dropless_eager_leg(captured: dict, batch) -> dict:
    """The dropless E = 8 model trained eagerly: its losses bit-identical
    to the captured leg's first ``MOE_EAGER_STEPS`` (G1 and G2 read the
    offsets on the device and sum in one fixed order, so a replay equals
    the eager step)."""
    want = _losses(captured)[:MOE_EAGER_STEPS]
    losses, step_s = _eager_leg(captured["cfg"], batch)
    log(f"moe_train eager [dropless] E=8: {step_s * 1e3:.1f} ms a step; "
        f"losses {[round(x, 5) for x in losses]}; the captured leg's "
        f"{[round(x, 5) for x in want]}")
    if losses != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"the captured dropless step's losses {want} "
                             f"differ from the eager step's {losses}")
    return {"losses": losses, "step_s": step_s}


def _moe_eager_legs(sort: dict, batch, counts: dict) -> dict:
    """The eager switch-sort E = 8 leg against the captured one's first
    ``MOE_EAGER_STEPS`` losses, bit for bit; a remat ``dots`` eager leg
    within 1e-3 relative; sort against cumsum gradients bit for bit on
    one batch; the aux wiring and ``expert_load``."""
    from horovod_tpu_torch.models import transformer as T

    captured = _losses(sort)[:MOE_EAGER_STEPS]
    res = {}
    for name, kw in (("eager", {}), ("remat_dots", dict(
            remat=True, remat_policy="dots"))):
        losses, step_s = _eager_leg(_moe_cfg(n_experts=8, **kw), batch)
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, captured))
        res[name] = {"losses": losses, "step_s": step_s,
                     "loss_gap_vs_captured": gap}
        log(f"moe_train eager [{name}] E=8 switch-sort: {step_s * 1e3:.1f} "
            f"ms a step; losses {[round(x, 5) for x in losses]}; largest "
            f"gap against the captured leg {gap:.3e}")
        if name == "eager" and losses != captured:
            raise AssertionError(f"the captured MoE step's losses {captured} "
                                 f"differ from the eager step's {losses}")
        if gap > 1e-3 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[{name}] MoE losses {losses} against "
                                 f"{captured}")
    # Sort against cumsum, one batch: the gradient of every parameter.
    params = T.init_params(_moe_cfg(n_experts=8), seed=0,
                           param_dtype=torch.float32)
    for t in [params["embed"], params["head"], params["ln_f"],
              *params["layers"].values()]:
        t.requires_grad_()
    g_sort = _moe_grads(_moe_cfg(n_experts=8, moe_dispatch="sort"), params,
                        batch)
    g_cum = _moe_grads(_moe_cfg(n_experts=8, moe_dispatch="cumsum"), params,
                       batch)
    if not all(torch.equal(a, b) for a, b in zip(g_sort, g_cum)):
        raise AssertionError("switch-sort and switch-cumsum gradients differ")
    del g_sort, g_cum
    # The balance term: loss(coeff) = loss(0) + coeff * aux.
    cfg0 = _moe_cfg(n_experts=8)
    cfg_aux = dataclasses.replace(cfg0, moe_aux_coeff=1e-2)
    with torch.no_grad():
        base = T.loss_fn(params, batch, cfg0).item()
        _, aux = T.forward(params, batch["tokens"], cfg0, return_aux=True)
        with_aux = T.loss_fn(params, batch, cfg_aux).item()
        load = T.expert_load(params, batch["tokens"], cfg0)
    gap = abs(with_aux - (base + 1e-2 * aux.item())) / abs(with_aux)
    rows = load.sum(-1)
    log(f"moe aux: loss {base:.6f} + 1e-2 x aux {aux.item():.6f} = "
        f"{base + 1e-2 * aux.item():.6f}, loss_fn with the coefficient "
        f"{with_aux:.6f} (gap {gap:.2e}); expert_load rows sum to "
        f"{rows.tolist()}; sort and cumsum gradients bit-identical")
    if gap > 1e-6 or not torch.allclose(rows, torch.ones_like(rows),
                                        atol=1e-6):
        raise AssertionError(f"aux wiring: gap {gap}, load rows {rows}")
    res["aux"] = {"loss": base, "aux": aux.item(), "loss_with_aux": with_aux,
                  "expert_load": load.tolist()}
    del params
    torch.cuda.empty_cache()
    return res


def moe_prefill(card: str) -> dict:
    """``moe_dispatch_ab.py --prefill``'s A/B at E = 8: four 2048-token
    prompts through ``prefill`` with the dropless dispatch (G1) and with
    the dense dispatch, round-robined (best of ``MOE_ROUNDS`` turns of
    ``MOE_STEPS_PER_ROUND``), attention through K1 (JAX's A/B used its
    reference attention).  The dropless runs are a main path: G1's
    launches are counted over them.  Then one more run of each under the
    profiler: its device busy time (the eager prefill's wall includes
    the host's pace, which the device time does not) and G1's share."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import grouped_matmul as GM

    cfg = _moe_cfg(n_experts=8)
    params = T.init_params(cfg, seed=0)
    prompt = T.synthetic_batch(0, cfg, MOE_BATCH)["tokens"]
    S = cfg.max_seq

    def run(impl):
        return T.prefill(params, prompt, T.init_cache(cfg, MOE_BATCH, S), cfg,
                         moe_impl=impl)[0]

    logits = {impl: run(impl) for impl in ("dropless", "dense")}
    best = {impl: math.inf for impl in logits}
    launches = {"grouped_matmul": 0, "flash_fwd": 0}
    for _ in range(MOE_ROUNDS):
        for impl in best:
            GM.grouped_matmul_launches = A.flash_fwd_launches = 0
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(MOE_STEPS_PER_ROUND):
                run(impl)
            torch.cuda.synchronize()
            best[impl] = min(best[impl],
                             (time.monotonic() - t0) / MOE_STEPS_PER_ROUND)
            if impl == "dropless":
                launches["grouped_matmul"] += GM.grouped_matmul_launches
            launches["flash_fwd"] += A.flash_fwd_launches
    want = 3 * cfg.n_layers * MOE_ROUNDS * MOE_STEPS_PER_ROUND
    if launches["grouped_matmul"] != want:
        raise AssertionError(f"dropless prefill launched G1 "
                             f"{launches['grouped_matmul']} times, not {want}")
    diff = (logits["dropless"] - logits["dense"]).abs().max().item()
    from torch.profiler import ProfilerActivity, profile

    device = {}
    for impl in best:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(impl)
            torch.cuda.synchronize()
        kernels = {e.key: e.self_device_time_total / 1e3
                   for e in _device_events(prof)}
        device[impl] = sum(kernels.values())
        device[f"{impl}_g1"] = sum(t for k, t in kernels.items()
                                   if "grouped_mm_kernel" in k)
    out = {"dropless_ms": best["dropless"] * 1e3,
           "dense_ms": best["dense"] * 1e3,
           "dropless_speedup": best["dense"] / best["dropless"],
           "dropless_device_ms": device["dropless"],
           "dense_device_ms": device["dense"],
           "dropless_g1_device_ms": device["dropless_g1"],
           "logits_max_diff_bf16": diff, "launches": launches}
    log(f"moe_prefill E=8 (4 x 2048, bf16, K1 attention) on {card}: dropless "
        f"(G1) {out['dropless_ms']:.2f} ms | dense dispatch "
        f"{out['dense_ms']:.2f} ms | dropless = {out['dropless_speedup']:.2f}x"
        f" faster; device busy (profiler, one run each) dropless "
        f"{device['dropless']:.2f} ms (G1 {device['dropless_g1']:.2f}) | dense "
        f"{device['dense']:.2f} ms; last-position logits differ by {diff:.3e} "
        f"(bf16; the dense dispatch routes with a bf16 router)")
    del params, logits
    torch.cuda.empty_cache()
    return out


def _zero_launches() -> None:
    """Every kernel's launch counter to 0, just before a main path's run."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import grouped_matmul as GM
    from horovod_tpu_torch.ops import paged_attention as PA

    A.flash_fwd_launches = PA.paged_attend_launches = 0
    GM.grouped_matmul_launches = 0


def _launches() -> dict:
    """The serving kernels' launches since :func:`_zero_launches`."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import grouped_matmul as GM
    from horovod_tpu_torch.ops import paged_attention as PA

    return {"flash_fwd": A.flash_fwd_launches,
            "paged_attend": PA.paged_attend_launches,
            "grouped_matmul": GM.grouped_matmul_launches}


def _moe_engine(cfg, params):
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine

    engine = InferenceEngine(params, cfg, EngineConfig(**ENGINE))
    engine.warmup(ENGINE_WARM_LENS)
    return engine, _admission_graphs(engine)


def _no_capture_after(engine, warm: dict, label: str) -> None:
    now = _admission_graphs(engine)
    if now != warm or now["decode_compilations"] != 1:
        raise AssertionError(f"{label}: captures after warmup: {warm} -> "
                             f"{now}")


def moe_serve_bf16(card: str, dense: dict) -> dict:
    """The serving configuration with 8 experts of d_ff 2048
    (``MOE_FULL``), bf16, every graph captured at warmup: the decode tick
    profiled at 8 slots and depth ``PROFILE_DEPTH`` (the dense
    dispatch), then the serving phase's HTTP burst of the 8 prompts
    (half sampled); K1, K4 and G1 must launch, and nothing is captured
    after warmup.  Printed beside the dense serving phase of this run."""
    from horovod_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(**MOE_FULL, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0)
    engine, warm = _moe_engine(cfg, params)
    tick = profile_decode(engine, "graph_overlap",
                          dense["sampler"]["sampler_ms"])
    results, wall, launches, _ = _generate_burst(engine, _prompts())
    _no_capture_after(engine, warm, "moe_serve_bf16")
    if not all(launches.values()):
        raise AssertionError(f"the MoE burst missed a kernel: {launches}")
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    run = {"wall_s": wall, "tok_per_s": sum(NEW_TOKENS) / wall,
           "ttft_ms_p50": statistics.median(ttft), "ttft_ms_max": ttft[-1],
           "launches": launches}
    dense_tick = dense["decode_modes"][-1]
    out = {**run, "tick": tick, "admission_graphs": warm}
    log(f"moe_serve_bf16 on {card}: burst {run['tok_per_s']:.1f} tok/s, TTFT "
        f"p50 {run['ttft_ms_p50']:.1f} max {run['ttft_ms_max']:.1f} ms; decode "
        f"tick device busy {tick['device_busy_ms']:.3f} ms of "
        f"{tick['tick_wall_ms']:.3f} ms wall | the dense serving phase: "
        f"{dense['tok_per_s']:.1f} tok/s, TTFT p50 {dense['ttft_ms_p50']:.1f} "
        f"max {dense['ttft_ms_max']:.1f} ms, tick busy "
        f"{dense_tick['device_busy_ms']:.3f} ms of "
        f"{dense_tick['tick_wall_ms']:.3f} ms; launches {run['launches']}; "
        f"no capture after warmup ({warm['prefill_compilations']} prefill, "
        f"{warm['sample_compilations']} sampler, 1 tick)")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_serve_f32(card: str) -> dict:
    """The same MoE configuration in f32 (TF32 off): the half-sampled
    burst's tokens against ``greedy_decode`` / ``sample_decode`` (the
    dropless prefill and dense decode of one request) under the
    serving phase's near-tie rule; K1, K4 and G1 launched; no capture
    after warmup."""
    from horovod_tpu_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = T.TransformerConfig(**MOE_FULL, dtype=torch.float32)
    params = T.init_params(cfg, seed=0)
    engine, warm = _moe_engine(cfg, params)
    prompts = _prompts(seed=1)
    _zero_launches()
    run = _stepped_burst(engine, prompts, SAMPLING, F32_NEW_TOKENS)
    run["launches"] = _launches()
    _no_capture_after(engine, warm, "moe_serve_f32")
    if not all(run["launches"].values()):
        raise AssertionError(f"the MoE burst missed a kernel: "
                             f"{run['launches']}")
    engine.terminate("moe_serve_f32 done")
    del engine
    refs = _f32_oracles(params, cfg, prompts)
    exempt = _check_f32("moe f32", prompts, run.pop("tokens"), refs)
    log(f"moe_serve_f32 on {card}: {len(prompts)} requests (half sampled) x "
        f"{F32_NEW_TOKENS} tokens equal to the oracles, {len(exempt)} "
        f"near-tie exemptions; launches {run['launches']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {**run, "exemptions": exempt}


# --- phase 8: times ----------------------------------------------------------


def _dt(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _suffix(dtype) -> str:
    """A kernels-line name's suffix: f32 runs its own kernel functions."""
    return "_f32" if dtype == torch.float32 else ""


def _plain_ms(fn, dtype) -> float:
    """The plain version's time: five calls alone in bf16; in f32, whose
    plain versions run for tens of milliseconds, one call after one
    warm-up."""
    if dtype == torch.float32:
        return time_ms(fn, reps=1, warm=1, batch=1)
    return time_ms(fn, reps=5, batch=1)


def sdpa_backend(*args, **kw) -> str:
    """The backend PyTorch's dispatcher picks for one SDPA call on these
    arguments (``torch._fused_sdp_choice``, what
    ``scaled_dot_product_attention`` itself asks): ``FLASH_ATTENTION``,
    ``EFFICIENT_ATTENTION`` (CUTLASS's memory-efficient kernels),
    ``CUDNN_ATTENTION`` or ``MATH`` (PyTorch's own matmuls and softmax).
    Read from the dispatcher, not a profile: late in this script the
    profiler has kept no kernel record of such a call."""
    from torch.nn.attention import SDPBackend

    return "SDPA " + SDPBackend(torch._fused_sdp_choice(*args, **kw)).name


# The wrappers' counters by dtype (never set to 0: read before and after
# a run), under the kernels line's keys.
BY_DTYPE = {"flash_fwd": ("A", "flash_fwd_launches_by_dtype"),
            "flash_bwd_dkdv": ("A", "flash_bwd_dkdv_launches_by_dtype"),
            "flash_bwd_dq": ("A", "flash_bwd_dq_launches_by_dtype"),
            "paged_attend": ("PA", "paged_attend_launches_by_dtype"),
            "grouped_matmul": ("GM", "grouped_matmul_launches_by_dtype"),
            "grouped_matmul_dw": ("GM",
                                  "grouped_matmul_dw_launches_by_dtype")}


def _by_dtype() -> dict:
    """Every kernel's launches so far by dtype: ``{kernel: {dtype: n}}``."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import grouped_matmul as GM
    from horovod_tpu_torch.ops import paged_attention as PA

    mods = {"A": A, "PA": PA, "GM": GM}
    return {k: dict(getattr(mods[m], attr)) for k, (m, attr) in
            BY_DTYPE.items()}


def _by_dtype_since(before: dict) -> dict:
    """The launches by dtype since ``before`` (:func:`_by_dtype`):
    ``{dtype: {kernel: n}}``."""
    out: dict = {}
    for k, now in _by_dtype().items():
        for dt, n in now.items():
            d = n - before[k].get(dt, 0)
            if d:
                out.setdefault(dt, {})[k] = d
    return out


def time_flash(err: float, launches: int, B: int = 2, Hkv: int = 4,
               H: int = 16, queued: bool = False,
               dtype=torch.bfloat16) -> dict:
    """K1 at the serving prefill's shape (``H`` query heads over ``Hkv``)
    in ``dtype``; ``queued`` times the kernel and its yardstick by
    :func:`queued_ms`.  The yardstick is SDPA on the same inputs; in
    f32 with TF32 off, as the f32 paths run, its backend named."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    S, D, dt = 2048, 64, dtype
    timer = queued_ms if queued else time_ms
    q, k, v = _k1_inputs(B, H, Hkv, S, D, dt, seed=100)
    ke, ve = A.expand_kv(k, H), A.expand_kv(v, H)
    scale = 1.0 / math.sqrt(D)
    def kernel():
        return A.flash_attention_with_lse(q, k, v, True)

    ms, one = timer(kernel), time_ms(kernel, batch=1)
    plain = _plain_ms(lambda: A._reference_attention_lse(
        q, A.expand_kv(k, H), A.expand_kv(v, H), 0, scale), dt)

    lib_args = ((q, k, v), dict(is_causal=True, enable_gqa=True))

    def library():
        return F.scaled_dot_product_attention(*lib_args[0], **lib_args[1])

    try:
        lib = timer(library)
    except TypeError:  # a PyTorch without enable_gqa: expanded K/V
        lib_args = ((q, ke, ve), dict(is_causal=True))
        lib = timer(library)
    pairs = B * H * S * (S + 1) / 2
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + q.numel()) + 4 * B * H * S
    b_ms, b_by = bound(4 * D * pairs, nbytes, dt)
    return {"name": "flash_fwd" + _suffix(dt), "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "horovod_tpu/ops/attention.py:124",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "tflops": tflops(4 * D * pairs, ms),
            "one_call_ms": one,
            "library": sdpa_backend(*lib_args[0], **lib_args[1])
            + (", GQA" if Hkv < H else ""),
            "shape": f"B={B} H={H} H_kv={Hkv} S=T={S} D={D} {_dt(dt)} "
                     "causal"}


def time_flash_suffix(err: float) -> dict:
    """K1 at the prefix phase's suffix shape, ``shift = -p0`` over ``T =
    p0 + S0`` keys; the library yardstick is SDPA with the same mask as
    a boolean ``attn_mask``."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    p0, S0 = SUFFIX_SHAPES[0]
    B, H, Hkv, D, dt = 2, 16, 4, 64, torch.bfloat16
    T = p0 + S0
    q, k, v = _k1_inputs(B, H, Hkv, S0, D, dt, seed=101, T=T)
    scale = 1.0 / math.sqrt(D)

    def kernel():
        return A.flash_attention_shifted(q, k, v, -p0)

    shift = torch.tensor(-p0, dtype=torch.int32, device="cuda")

    def kernel_dev():
        return A.flash_attention_shifted(q, k, v, shift)

    ms, one = time_ms(kernel), time_ms(kernel, batch=1)
    # The two shift modes by CUDA events (the host's launching shows at
    # this size) and, in turns with the yardstick, by the profiler's
    # device time of every kernel of one call.
    dev_ms = time_ms(kernel_dev)
    kern = {"by_value": device_ms(kernel), "device": device_ms(kernel_dev)}
    plain = time_ms(lambda: A._reference_attention_lse(
        q, A.expand_kv(k, H), A.expand_kv(v, H), -p0, scale), reps=5,
        batch=1)
    mask = (torch.arange(T, device="cuda")[None, :]
            <= torch.arange(S0, device="cuda")[:, None] + p0)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    try:
        lib = time_ms(library)
    except TypeError:  # a PyTorch without enable_gqa: expanded K/V
        ke, ve = A.expand_kv(k, H), A.expand_kv(v, H)

        def library():
            return F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)

        lib = time_ms(library)
    kern["library"] = device_ms(library)
    kern["by_value_again"] = device_ms(kernel)
    kern["device_again"] = device_ms(kernel_dev)
    pairs = B * H * (S0 * p0 + S0 * (S0 + 1) / 2)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S0
    b_ms, b_by = bound(4 * D * pairs, nbytes, dt)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "horovod_tpu/ops/attention.py:124",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "tflops": tflops(4 * D * pairs, ms),
            "one_call_ms": one, "device_shift_ms": dev_ms,
            "kernel_device_ms": kern,
            "shape": f"B={B} H={H} H_kv={Hkv} S={S0} T={T} D={D} bf16 "
                     f"shift={-p0}"}


def time_flash_bwd(errs: dict, launches: dict,
                   dtype=torch.bfloat16) -> list:
    """K2 and K3 at the training shape in ``dtype``; the library
    yardstick is the backward of ``scaled_dot_product_attention`` (one
    autograd call, dq, dk and dv together; TF32 off), so both rows carry
    the pair's time."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, S, D, dt = TRAIN_BATCH, 16, 2048, 64, dtype
    scale = 1.0 / math.sqrt(D)
    q, k, v = _k1_inputs(B, H, H, S, D, dt, seed=300)
    do = torch.randn((B, H, S, D), device="cuda").to(dt)
    o, lse = A._flash_fwd_cuda(q, k, v, 0, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, 0, scale)
    ms2 = time_ms(lambda: A._flash_bwd_dkdv_cuda(*args))
    ms3 = time_ms(lambda: A._flash_bwd_dq_cuda(*args))
    one2 = time_ms(lambda: A._flash_bwd_dkdv_cuda(*args), batch=1)
    one3 = time_ms(lambda: A._flash_bwd_dq_cuda(*args), batch=1)
    plain2 = _plain_ms(lambda: A._flash_bwd_dkdv_reference(*args), dt)
    torch.cuda.empty_cache()
    plain3 = _plain_ms(lambda: A._flash_bwd_dq_reference(*args), dt)
    torch.cuda.empty_cache()
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    def library():
        return torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)

    lib = time_ms(library)
    lib_name = sdpa_backend(ql, kl, vl, is_causal=True) + " backward"
    pairs = B * H * S * (S + 1) / 2
    rows = 4 * B * H * S  # lse and delta, f32
    n, es = q.numel(), q.element_size()
    shape = f"B={B} H={H} S=T={S} D={D} {_dt(dt)} causal"
    out = []
    for name, src, line, ms, one, plain, flop_per_pair, outs in (
            ("flash_bwd_dkdv", "horovod_tpu/ops/attention.py:254", "dkdv",
             ms2, one2, plain2, 8 * D, 2),
            ("flash_bwd_dq", "horovod_tpu/ops/attention.py:315", "dq",
             ms3, one3, plain3, 6 * D, 1)):
        flops = flop_per_pair * pairs
        b_ms, b_by = bound(flops, es * 4 * n + 2 * rows + es * outs * n, dt)
        out.append({"name": name + _suffix(dt), "route": "cuda",
                    "source": "horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                    "replaces": src, "launches": launches[name],
                    "max_abs_err": errs[line], "ms": ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                    "tflops": tflops(flops, ms), "one_call_ms": one,
                    "library": lib_name, "shape": shape})
    del q, k, v, do, o, lse, delta, ql, kl, vl, ol
    torch.cuda.empty_cache()
    return out


def flash_bwd_ab(sources: list) -> list:
    """The f32 K2 and K3 of this tree against other builds of
    ``flash_bwd.cu`` (each a directory holding its ``csrc`` sources, such
    as the parent commit's, built here into ``build/ab/``), in turns on
    one card: :func:`time_flash_bwd` at the training shape with each
    build loaded, in the order a, b, ..., this, this, ..., b, a."""
    import ctypes

    from horovod_tpu_torch.ops import _cuda

    libs, procs = {"this": _cuda.library("flash_bwd")}, {}
    for i, src in enumerate(sources):
        out = _cuda.BUILD_DIR.parent / "ab" / str(i)
        out.mkdir(parents=True, exist_ok=True)
        procs[src] = out, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o",
             str(out / "libflash_bwd.so"), str(Path(src) / "flash_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for src, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        for fn, r in sorted(_ptxas(text).items()):
            if fn in FLASH_BWD_F32:
                log(f"ptxas ({src}): {fn}: {r}")
        libs[src] = ctypes.CDLL(str(out / "libflash_bwd.so"))
    runs = []
    for tag in [*sources, "this", "this", *reversed(sources)]:
        _cuda._libs["flash_bwd"] = libs[tag]
        rows = time_flash_bwd({"dkdv": None, "dq": None},
                              {"flash_bwd_dkdv": 0, "flash_bwd_dq": 0},
                              dtype=torch.float32)
        for r in rows:
            log(f"flash_bwd_ab {tag}: {r['name']} [{r['shape']}] "
                f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s; one call "
                f"{r['one_call_ms']:.4f}), bound {r['bound_ms']:.4f}, plain "
                f"{r['plain_ms']:.4f}, {r['library']} {r['library_ms']:.4f}")
        runs.append({"build": tag, "rows": rows})
    _cuda._libs["flash_bwd"] = libs["this"]
    return runs


def time_paged(err: float, launches: int, R: int = 4, Hkv: int = 4,
               dtype=torch.bfloat16) -> dict:
    """K4 at the serving shape, 8 slots x 2176 positions, with ``R``
    query rows a kv head: the decode tick's G = 4, or the speculative
    verify's G * W = 20 (its own kernels-line entry); ``Hkv`` kv heads
    (a tp shard's ``4 / tp``); q and the pool in ``dtype`` (an f32 pool
    runs the split kernel's f32 instantiation)."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import paged_attention as PA

    S, Dh, ps, MP = 8, 64, 16, 136
    P = S * MP + 1
    g = torch.Generator(device="cuda").manual_seed(7)
    qg = torch.randn((S, Hkv, R, Dh), generator=g, device="cuda").to(dtype)
    kp = torch.randn((P, Hkv, ps, Dh), generator=g, device="cuda").to(dtype)
    vp = torch.randn_like(kp)
    # Every slot at full depth, each with its own pages in shuffled order.
    perm = torch.randperm(P - 1, generator=g, device="cuda")[:S * MP] + 1
    table = perm.reshape(S, MP).to(torch.int32).contiguous()
    limit = torch.full((S,), MP * ps, dtype=torch.int32, device="cuda")
    def kernel():
        return PA.paged_attend(qg, kp, vp, None, None, table, limit,
                               compute_dtype=dtype)

    # Device time (split + combine kernels): CUDA events around 10
    # back-to-back calls time the host's launching at this size, and the
    # profiler (device_ms) late in this script has read below the byte
    # bound (0.0012 ms against 0.0053): the calls queued behind a sleep.
    ms = queued_ms(kernel)
    call_ms, one = time_ms(kernel), time_ms(kernel, batch=1)
    plain = time_ms(lambda: PA.paged_attend_reference(
        qg, kp, vp, None, None, table, limit, compute_dtype=dtype), reps=10,
        batch=1)
    kg = T._gather_pages(kp, table)
    vg = T._gather_pages(vp, table)
    vis = (torch.arange(MP * ps, device="cuda")[None, :]
           < limit[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=vis)

    torch.backends.cuda.matmul.allow_tf32 = False
    lib, lib_call = queued_ms(library), time_ms(library)
    pps, grid = PA.split_grid(S, Hkv, R, MP, kp.dtype)
    log(f"K4 grid at the serving shape, R = {R}: "
        f"{'rows' if R > 8 else 'split'} kernel {grid} = "
        f"{math.prod(grid)} CTAs of {pps} pages, combine {grid[0]} CTAs")
    n_pos = int(limit.sum())
    kv_bytes = 2 * n_pos * Hkv * Dh * kp.element_size()
    nbytes = (kv_bytes + qg.numel() * qg.element_size() + table.numel() * 4
              + S * 4 + S * Hkv * R * Dh * 4 + S * Hkv * R * 4)
    flops = 4 * Hkv * R * Dh * n_pos
    b_ms, b_by = bound(flops, nbytes, dtype)
    return {"name": ("paged_attend" if R == 4 else "paged_attend_verify")
            + _suffix(dtype),
            "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "horovod_tpu/ops/paged_attention.py:101",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "tflops": tflops(flops, ms),
            "one_call_ms": one, "call_ms": call_ms,
            "library_call_ms": lib_call,
            "library": sdpa_backend(qg, kg, vg, attn_mask=vis)
            + ", gathered K/V",
            "grid": list(grid), "pages_per_split": pps,
            "shape": f"S={S} H_kv={Hkv} R={R} Dh={Dh} page={ps} "
                     f"pages/slot={MP} {_dt(dtype)}, every slot at {MP * ps}"}


# --- the tp phase: tensor-parallel serving -----------------------------------

# One card has no peers and NCCL refuses two ranks on one device, so the
# sharded body runs here in the virtual form (every shard in this
# process, the partials summed in shard order; the body the CPU tests
# hold to JAX over gloo ranks), against the tp = 1 engine at full width:
# f32 churns at tp = 2 and 4 (one kv head a shard) of 8 requests over 4
# slots, TP_PROMPT_LENS (buckets 8 to 1024), half of them sampled; a bf16
# first decode tick;
# K1 and K4 at the shard-local shapes; and the real form's collectives,
# captured in the tick, over a size-1 NCCL group.
TP_DEGREES = (2, 4)
TP_ENGINE = dict(n_slots=4, max_len=1024, max_prefills_per_tick=2,
                 page_size=16, max_queue_depth=64, paged_kernel=True)
TP_PROMPT_LENS = [5, 16, 40, 100, 300, 700, 200, 64]
TP_SAMPLING = SAMPLING
TP_NEW_TOKENS = 32
# The bf16 first tick's logits against tp = 1, over the tp = 1 logits'
# largest magnitude: partials rounded to bf16 once each and once more
# after the f32 sum, where tp = 1 rounds once (8 layers, 2 sums each).
TP_BF16_TOL = 0.05


def _tp_engine(params, cfg, tp: int, **kw):
    from horovod_tpu_torch import serving

    return serving.InferenceEngine(
        params, cfg, serving.EngineConfig(**TP_ENGINE, tp=tp), device="cuda",
        _virtual_tp=tp > 1, **kw)


def _tp_churn(engine, prompts, label: str) -> dict:
    """Warm ``engine`` over the prompts' buckets, then serve them all at
    once: tokens, and the captures and launches the churn made."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA

    engine.warmup(sorted({len(p) for p in prompts}))
    caps = engine.decode_compilations
    k1, k4 = A.flash_fwd_launches, PA.paged_attend_launches
    replays, pre = engine._tick.replays, engine._graphs.replays
    t0 = time.monotonic()
    futs = [engine.submit(p, max_new_tokens=TP_NEW_TOKENS, **TP_SAMPLING[i])
            for i, p in enumerate(prompts)]
    while not all(f.done() for f in futs):
        engine.step()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    tp, L = engine.engine_cfg.tp, engine.cfg.n_layers
    full = {k: g.k1_launches_per_replay
            for k, g in engine._graphs._graphs.items() if k[0] == "full"}
    out = {"tokens": [f.result() for f in futs], "seconds": dt,
           "captures": [caps, engine.decode_compilations],
           "tick_replays": engine._tick.replays - replays,
           "prefill_replays": engine._graphs.replays - pre,
           "k4_per_replay": engine._tick.k4_launches_per_replay,
           "k1_per_full_prefill": sorted(set(full.values())),
           "launches": {"flash_fwd": A.flash_fwd_launches - k1,
                        "paged_attend": PA.paged_attend_launches - k4},
           "mesh": engine.stats()["mesh"]}
    if out["captures"] != [1, 1]:
        raise AssertionError(f"tp {label}: decode captures "
                             f"{out['captures']}, want one across the churn")
    if out["k4_per_replay"] != tp * L or out["launches"]["paged_attend"] \
            != out["tick_replays"] * tp * L:
        raise AssertionError(
            f"tp {label}: K4 {out['launches']['paged_attend']} launches over "
            f"{out['tick_replays']} replays, {out['k4_per_replay']} a "
            f"replay; want tp x layers = {tp * L} a replay")
    if out["k1_per_full_prefill"] != [tp * L]:
        raise AssertionError(f"tp {label}: K1 a prefill replay "
                             f"{out['k1_per_full_prefill']}, want {tp * L}")
    return out


def _tp_first_tick(params, cfg, prompts, sharding=None, first=None) -> tuple:
    """The decode tick's body once, after a prefill landed in a paged pool
    (K1, then K4 with ``kernel=True``), sharded by ``sharding`` (virtual)
    or whole: ``(prefill logits, tick logits, the tick's input tokens)``.
    The tick takes ``first`` (the whole model's picks), else the
    prefill's argmax: a near-tie picked otherwise would feed a row
    another token."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import cache as C

    tparams = sharding.shard_params(params) if sharding else params
    S, n = len(prompts), max(len(p) for p in prompts)
    ps = TP_ENGINE["page_size"]
    MP = -(-(n + 1) // ps)
    pool = C.init_page_pool(cfg, S, S * MP + 1, ps, device="cuda",
                            sharding=sharding)
    table = torch.arange(1, S * MP + 1, dtype=torch.int32,
                         device="cuda").reshape(S, MP)
    tokens = torch.zeros((S, n), dtype=torch.long, device="cuda")
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p, device="cuda")
    lens = torch.tensor([len(p) for p in prompts], device="cuda")
    cache = T.init_cache(cfg, S, n, device="cuda", params=tparams)
    logits0, kv = T.prefill(tparams, tokens, cache, cfg, true_len=lens)
    t = torch.arange(n, device="cuda")
    phys = torch.where(t[None, :] < lens[:, None],
                       table[:, t // ps].long(), torch.zeros_like(t))
    C.paged_insert(pool, torch.arange(S, device="cuda"), lens, phys,
                   (t % ps)[None, :].expand(S, n), kv["k"], kv["v"])
    if first is None:
        first = torch.argmax(logits0, dim=-1)
    active = torch.ones(S, dtype=torch.bool, device="cuda")
    logits, _ = T.decode_step_paged(tparams, first, pool, table, cfg, active,
                                    kernel=True, check_capacity=False)
    torch.cuda.synchronize()
    return logits0, logits, first


def check_tp_kernels() -> dict:
    """K4 at R = 4 (the tick) and R = 20 (the verify) and K1 over the
    shard-local heads, H_kv = 2 (tp = 2) and 1 (tp = 4), bf16 and f32,
    against their plain versions (K4 twice, bit for bit)."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA

    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 1e-4, bf16: 2e-2}
    errs = {}
    for i, (dt, Hkv, R) in enumerate((dt, Hkv, R) for dt in (f32, bf16)
                                     for Hkv in (2, 1) for R in (4, 20)):
        args, table, limit = _k4_case(dt, dt, Hkv=Hkv, R=R, seed=900 + i)
        o, lse = PA.paged_attend(*args, table, limit, compute_dtype=dt)
        o2, lse2 = PA.paged_attend(*args, table, limit, compute_dtype=dt)
        o_r, l_r = PA.paged_attend_reference(*args, table, limit,
                                             compute_dtype=dt)
        torch.cuda.synchronize()
        live = limit > 0
        err = max((o - o_r).abs().max().item(),
                  (lse[live] - l_r[live]).abs().max().item())
        name = f"K4 tp-local {str(dt)[6:]} H_kv={Hkv} R={R}"
        log(f"{name}: max_abs_err={err:.3e} tol={tol[dt]:.0e}")
        if not (err <= tol[dt] and torch.equal(o, o2)
                and torch.equal(lse, lse2)):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 "or between two calls")
        errs[name] = err
    k1_tol = {f32: 1e-4, bf16: 5e-2}
    for i, (dt, Hkv) in enumerate((dt, Hkv) for dt in (f32, bf16)
                                  for Hkv in (2, 1)):
        H, S, D = 4 * Hkv, 1024, 64
        q, k, v = _k1_inputs(2, H, Hkv, S, D, dt, seed=950 + i)
        o, lse = A.flash_attention_with_lse(q, k, v, True)
        o_r, l_r = A._reference_attention_lse(
            q, A.expand_kv(k, H), A.expand_kv(v, H), 0, 1.0 / math.sqrt(D))
        torch.cuda.synchronize()
        err = max((o.float() - o_r.float()).abs().max().item(),
                  (lse - l_r).abs().max().item())
        name = f"K1 tp-local {str(dt)[6:]} H={H} H_kv={Hkv} S={S}"
        log(f"{name}: max_abs_err={err:.3e} tol={k1_tol[dt]:.0e}")
        if not err <= k1_tol[dt]:
            raise AssertionError(f"{name} disagrees with its plain version")
        errs[name] = err
    return errs


def _tp_size_one(params, cfg, prompts, want: list) -> dict:
    """The real form (a rank's one shard and its group's collectives: two
    all_reduce a layer, the embedding's, the logits' all_gather, and the
    step's broadcast) over a size-1 NCCL group, the collectives captured
    in the tick and the admission graphs: tokens equal to tp = 1's."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.serving.sharding import ServingSharding

    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        sh = ServingSharding(cfg, 1, device="cuda")
        if sh.group is None or not sh.replicated:
            raise AssertionError("the size-1 real form has no group")
        eng = _tp_engine(params, cfg, 1, _sharding=sh)
        res = _tp_churn(eng, prompts, "real form, size-1 NCCL")
        del eng
    finally:
        basics.shutdown()
    if res["tokens"] != want:
        raise AssertionError("tp real form over a size-1 NCCL group: "
                             "tokens differ from the tp = 1 engine's")
    return res


def time_tp_kernels(errs: dict, launches: dict) -> list:
    """K1 and K4 at the shard-local shapes of tp = 2 and 4 (queued device
    time, bound, plain version, SDPA), K4 at the tick's 8 x 2176: in f32,
    with the launches of the f32 churns (``launches["float32"]``), and in
    bf16, with those of the bf16 first tick (``launches["bfloat16"]``)."""
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for tp in TP_DEGREES:
            Hkv, H = 4 // tp, 16 // tp
            n = launches[_dt(dt)][tp]
            k4 = time_paged(errs[f"K4 tp-local {_dt(dt)} H_kv={Hkv} R=4"],
                            n.get("paged_attend", 0), Hkv=Hkv, dtype=dt)
            k4["name"] = f"paged_attend_tp{tp}" + _suffix(dt)
            k1 = time_flash(errs[f"K1 tp-local {_dt(dt)} H={H} H_kv={Hkv} "
                                 "S=1024"], n.get("flash_fwd", 0), Hkv=Hkv,
                            H=H, queued=True, dtype=dt)
            k1["name"] = f"flash_fwd_tp{tp}" + _suffix(dt)
            rows += [k1, k4]
    return rows


def tp_full_width(card: str) -> dict:
    """The tp phase (module docstring, phase 13)."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving.sharding import ServingSharding

    out = {"kernels": check_tp_kernels()}
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, FULL["vocab_size"], n).tolist()
               for n in TP_PROMPT_LENS]
    cfg = T.TransformerConfig(**FULL, dtype=torch.float32)
    params = T.init_params(cfg, seed=0, device="cuda")
    refs = _f32_oracles(params, cfg, prompts, TP_SAMPLING, TP_NEW_TOKENS)
    legs = {}
    for tp in (1,) + TP_DEGREES:
        eng = _tp_engine(params, cfg, tp)
        legs[tp] = _tp_churn(eng, prompts, f"f32 tp={tp}")
        legs[tp]["exempt"] = _check_f32(f"tp={tp} f32", prompts,
                                        legs[tp]["tokens"], refs,
                                        TP_SAMPLING)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same = {tp: sum(a == b for a, b in zip(legs[tp]["tokens"],
                                           legs[1]["tokens"]))
            for tp in TP_DEGREES}
    log(f"tp f32 on {card}: requests token-identical to tp = 1 "
        + ", ".join(f"tp={tp} {same[tp]}/{len(prompts)}"
                    for tp in TP_DEGREES)
        + "; churn s " + ", ".join(f"tp={tp} {legs[tp]['seconds']:.2f}"
                                   for tp in legs)
        + " (virtual: shards one after another on one card, not a "
          "tp speed-up)")
    out["size_one_nccl"] = _tp_size_one(params, cfg, prompts,
                                        legs[1]["tokens"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg16 = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    p16 = T.init_params(cfg16, seed=0, device="cuda")
    base0, base, first = _tp_first_tick(p16, cfg16, prompts)
    bf16, bf16_launches = {}, {}
    for tp in TP_DEGREES:
        sh = ServingSharding(cfg16, tp, device="cuda", virtual=True)
        before = _by_dtype()
        l0, l1, _ = _tp_first_tick(p16, cfg16, prompts, sh, first)
        bf16_launches[tp] = _by_dtype_since(before).get("bfloat16", {})
        scale = base.abs().max().item()
        bf16[tp] = {
            "prefill_err": (l0 - base0).abs().max().item()
            / base0.abs().max().item(),
            "tick_err": (l1 - base).abs().max().item() / scale,
            "prefill_agree": float((l0.argmax(-1) == base0.argmax(-1))
                                   .float().mean()),
            "tick_agree": float((l1.argmax(-1) == base.argmax(-1))
                                .float().mean())}
        log(f"tp bf16 first tick on {card}, tp={tp} vs tp = 1: prefill "
            f"logits err {bf16[tp]['prefill_err']:.3e}, tick logits err "
            f"{bf16[tp]['tick_err']:.3e} (of the largest |logit|; tol "
            f"{TP_BF16_TOL}), argmax agreement prefill "
            f"{bf16[tp]['prefill_agree']:.2f} tick "
            f"{bf16[tp]['tick_agree']:.2f}")
        if not max(bf16[tp]["prefill_err"], bf16[tp]["tick_err"]) \
                <= TP_BF16_TOL:
            raise AssertionError(f"tp={tp} bf16 first tick beyond "
                                 f"{TP_BF16_TOL} of tp = 1")
    del p16
    out.update(f32={tp: {k: v for k, v in leg.items() if k != "tokens"}
                    for tp, leg in legs.items()},
               identical_to_tp1=same, bf16=bf16,
               bf16_launches=bf16_launches,
               launches={tp: legs[tp]["launches"] for tp in legs})
    out["launches"]["size_one"] = out["size_one_nccl"]["launches"]
    out["size_one_nccl"].pop("tokens")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import horovod_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: horovod_tpu_torch is not importable ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    from horovod_tpu_torch.obs import xprof

    PEAK_FLOPS[torch.bfloat16] = xprof.PEAK_FLOPS_BY_KIND[H100]
    t_start = time.monotonic()
    card = card_info()
    if sys.argv[1:2] == ["--ab-flash-bwd"]:
        # `chip_smoke.py --ab-flash-bwd DIR [DIR ...]`: only the f32 K2
        # and K3 of this tree against the flash_bwd.cu under each DIR.
        build()
        log(json.dumps({"flash_bwd_ab": flash_bwd_ab(sys.argv[2:]),
                        "card": card}))
        return 0
    with phase("build"):
        build()
        REPORT["ffma_tiled_ptxas"] = ptxas_check()
        REPORT["sass_hmma"] = sass_check()
    with phase("kernel_checks"):
        k1 = check_flash()
        k23 = check_flash_bwd()
        k4 = check_paged()
    REPORT["kernel_checks"] = {"flash_fwd": k1, "flash_bwd": k23,
                               "paged_attend": k4}
    with phase("grouped_kernel"):
        g1 = check_grouped()
        g1_times = time_grouped(g1["abs_errors"])
    REPORT["kernel_checks"]["grouped_matmul"] = g1
    with phase("serving"):
        serving = serve_full_width(card)
    REPORT["serving_bf16"] = serving
    with phase("tracing"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_tracing_") as tmp:
        traced = tracing_full_width(card, Path(tmp))
    REPORT["tracing"] = traced
    with phase("fleet"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_fleet_") as tmp:
        fleet = fleet_full_width(card, Path(tmp), serving)
    REPORT["fleet"] = fleet
    with phase("token_identity_f32"):
        ident = token_identity()
    REPORT["token_identity_f32"] = ident
    with phase("fleet_f32"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_fleet_f32_") as tmp:
        REPORT["fleet_f32"] = fleet_identity_f32(card, Path(tmp), F32_ORACLE)
    f32d, bf16d = ident["durability"], serving["durability"]
    log(f"durability on {card}: recovery s from the fault to the first "
        f"clean tick: f32 {[round(s, 4) for s in f32d['recovery_s']]}, "
        f"bf16 {[round(s, 4) for s in bf16d['recovery_s']]}; "
        f"resume_wasted_tokens f32 {f32d['resume_wasted_tokens']}, bf16 "
        f"{bf16d['resume_wasted_tokens']}; burst tok/s f32 clean "
        f"{f32d['clean_tok_per_s']:.1f} faulted "
        f"{f32d['faulted_tok_per_s']:.1f} (same engine and prompts); bf16 "
        f"serving burst {serving['tok_per_s']:.1f}, faulted and preempting "
        f"burst {bf16d['faulted_tok_per_s']:.1f}")
    with phase("speculative"):
        spec = spec_full_width(card)
    REPORT["speculative_bf16"] = spec
    sampler_ms = serving["sampler"]["sampler_ms"]
    with phase("unpaged"):
        unpaged = unpaged_full_width(card, sampler_ms)
    REPORT["unpaged"] = unpaged
    with phase("paged_kernel_ab"):
        kernel_ab = paged_kernel_ab(card, sampler_ms)
    REPORT["paged_kernel_ab"] = kernel_ab
    with phase("tp"):
        tp = tp_full_width(card)
    REPORT["tp"] = tp
    F32_ORACLE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    with phase("collectives"):
        coll = collectives_size_one(card)
    REPORT["collectives"] = coll
    with phase("eager_native"):
        REPORT["eager_native"] = eager_native(card)
    with phase("frontend"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_frontend_") as tmp:
        front = frontend_full_width(card, Path(tmp))
    REPORT["frontend"] = front
    with phase("model_grads_f32"):
        REPORT["model_grads_f32"] = model_grads_f32()
    with phase("training"):
        train = train_full_width()
    REPORT["train_bf16"] = train
    legs = train["legs"]
    log(f"training legs on {card} (median step ms / tok/s / MFU on useful "
        "FLOP / peak GB / device busy ms / idle share): " + "; ".join(
            f"{n} {lg['step_s_median'] * 1e3:.1f} / "
            f"{lg['tokens_per_s']:.0f} / {lg['mfu']:.4f} / "
            f"{lg['peak_mem_gb']:.2f} / "
            f"{lg['profile']['device_busy_ms']:.1f} / "
            f"{lg['profile']['idle_share']:.3f}" for n, lg in legs.items()))
    with phase("sequence_parallel"):
        sp = sequence_parallel(card, legs["captured"])
    REPORT["sequence_parallel"] = sp
    with phase("gspmd"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_gspmd_") as tmp:
        gs = gspmd_full_width(card, Path(tmp))
    REPORT["gspmd"] = gs
    with phase("pipeline"):
        pipe = pipeline_full_width(card)
    REPORT["pipeline"] = pipe
    with phase("launcher_elastic"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_launch_") as tmp:
        launch = launcher_elastic(card, Path(tmp))
    REPORT["launcher_elastic"] = launch
    with phase("moe_train"):
        moe_tr = moe_train(card)
    REPORT["moe_train"] = moe_tr
    with phase("moe_prefill"):
        moe_pf = moe_prefill(card)
    REPORT["moe_prefill"] = moe_pf
    with phase("moe_serve_bf16"):
        moe_sv = moe_serve_bf16(card, serving)
    REPORT["moe_serve_bf16"] = moe_sv
    with phase("moe_serve_f32"):
        moe_sv32 = moe_serve_f32(card)
    REPORT["moe_serve_f32"] = moe_sv32
    with phase("vision"):
        vision = vision_full_width(card)
    REPORT["vision"] = vision
    log(f"vision ResNet-50 legs (bf16, channels_last, 224², bench.py's "
        f"protocol; median img/s ±1.96σ / MFU / peak GB / captures / "
        f"replays) on {card}: " + "; ".join(
            f"{n} {lg['value']:.1f} ±{lg['stddev95']:.1f} / "
            f"{lg['mfu']:.4f} / {lg['peak_mem_bytes'] / 1e9:.2f} / "
            f"{lg['captures']} / {lg['replays']}"
            + (f" / device busy {lg['profile']['device_busy_ms']:.1f} ms of "
               f"{lg['profile']['wall_ms']:.1f}, idle share "
               f"{lg['profile']['idle_share']:.3f}" if "profile" in lg
               else "")
            for n, lg in vision["legs"].items()))
    fr = front["resnet"]
    log(f"frontend ResNet-50 batch {FRONT_RESNET_BATCH} on {card}: hooks "
        f"{fr['img_per_sec_median']:.1f} img/s, the step-time optimizer "
        f"{fr['step_time_img_per_sec_median']:.1f} (frontend phase); the "
        f"vision phase's b64_eager {vision['legs']['b64_eager']['value']:.1f}")
    # Each kernel's launches are the sum over the main paths' runs that
    # launch it: serving (the HTTP burst, the prefix run, the two SLO
    # legs, the speculative legs, the repetitive one included, the
    # tracing phase's four bursts, the unpaged A/B: K1 in both engines'
    # admissions, the contiguous graphs included, K4 in the paged
    # engine's ticks; the paged-kernel A/B: K4 in the K4 engines' ticks)
    # and, for K1-K3, the four training legs (K1 twice a layer a step in
    # the remat legs) and the tracing phase's traced training steps.
    served = [serving, serving["prefix"], *serving["slo"].values(),
              *spec["legs"].values(), *traced["legs"], moe_sv, moe_sv32,
              unpaged, kernel_ab]
    trained = {k: train["launches"][k] + traced["train"]["launches"][k]
               + moe_tr["launches"][k] + launch["launches"][k]
               for k in train["launches"]}
    # The fleet's bursts, per replica process (its /stats counters): the
    # clean leg's two replicas and the SIGKILL leg's survivor.
    fleet_launches = {k: sum(d[f"{k}_launches"] for leg in ("clean", "sigkill")
                             for d in fleet[leg]["launches"].values())
                      for k in ("flash_fwd", "paged_attend")}
    # The sequence_parallel phase: the virtual ring's passes and the sp
    # training legs (K1-K3), the ring config's prefill burst (K1, K4).
    trained = {k: v + sp["launches"][k] for k, v in trained.items()}
    # The gspmd phase's GSPMD leg (K1-K3 under local_map), the pipeline
    # phase's schedules and MoE legs.
    trained = {k: v + gs["launches"][k] + pipe["launches"][k]
               for k, v in trained.items()}
    # The frontend phase's LM legs through the hooks (k = 1 and 2).
    trained = {k: v + front["launches"][k] for k, v in trained.items()}
    # The collectives phase's TRAIN legs over axis_name="dp" (Adasum and
    # the dense sparse_keys route, not their plain AdamW reference).
    trained = {k: v + coll["launches"][k] for k, v in trained.items()}
    # The tp phase's churns: tp = 1, the virtual tp = 2 and 4 engines
    # (K1 and K4 shard-local, tp x layers a replay) and the real form
    # over a size-1 NCCL group.
    tp_launches = {k: sum(leg[k] for leg in tp["launches"].values())
                   for k in ("flash_fwd", "paged_attend")}
    k1_launches = sum(r["launches"]["flash_fwd"] for r in served) + \
        trained["flash_fwd"] + fleet_launches["flash_fwd"] + \
        moe_pf["launches"]["flash_fwd"] + tp_launches["flash_fwd"]
    # G1's main paths: the dropless prefill runs, both MoE bursts and the
    # dropless training leg (forward and dx); G2's: that leg.
    g1_launches = moe_pf["launches"]["grouped_matmul"] + sum(
        r["launches"]["grouped_matmul"] for r in (moe_sv, moe_sv32)) + \
        moe_tr["launches"]["grouped_matmul"]
    g2_launches = moe_tr["launches"]["grouped_matmul_dw"]
    verify_rows = FULL["n_heads"] // FULL["n_kv_heads"] * (SPEC_K + 1)
    k4_verify = sum(leg["launches"]["paged_attend_by_rows"].get(
        verify_rows, 0) for leg in spec["legs"].values())
    k4_launches = sum(r["launches"]["paged_attend"] for r in served) \
        - k4_verify + fleet_launches["paged_attend"] + \
        sp["launches"]["paged_attend"] + tp_launches["paged_attend"]
    # By dtype: each phase's launches go to the dtype it runs.  The f32
    # runs among the sums above: the f32 MoE burst, the tp churns, the
    # virtual ring's f32 passes and the pipeline phase's f32 runs; and,
    # counted only here, the f32 serving phase's faulted burst, its
    # speculative and SLO legs, and the f32 MoE gate.  The rest is bf16
    # (K4: bf16 and int8 pools).
    keys = tuple(BY_DTYPE)
    sp_f32 = {k: sum(c["launches"][i] for n, c in
                     sp["virtual_ring"]["cases"].items() if "float32" in n)
              for i, k in enumerate(keys[:3])}
    pipe_f32 = pipe["launches"].get("by_dtype", {}).get("float32", {})
    in_sums = [moe_sv32["launches"], *tp["launches"].values(), sp_f32,
               pipe_f32]
    serve_f32 = [ident["durability"]["launches"], ident["slo"]["launches"],
                 *(leg["launches"] for leg in
                   ident["speculative"].values()), moe_sv32["launches"]]
    train_f32 = [sp_f32, pipe_f32, moe_tr["equalities_f32"]["launches"]]

    def total(runs):
        return {k: sum(r.get(k, 0) for r in runs) for k in keys}

    f32_in_sums, f32 = total(in_sums), total(
        serve_f32 + train_f32 + list(tp["launches"].values()))
    f32_k1 = {"serving": total(serve_f32)["flash_fwd"],
              "training": total(train_f32)["flash_fwd"]}
    k1_launches -= f32_in_sums["flash_fwd"]
    k4_launches -= f32_in_sums["paged_attend"]
    g1_launches -= f32_in_sums["grouped_matmul"]
    trained = {k: v - f32_in_sums[k] for k, v in trained.items()}
    REPORT["launches_f32"] = {"all": f32, "K1": f32_k1}
    log(f"f32 launches over every f32 path: {f32} (K1: serving "
        f"{f32_k1['serving']}, training {f32_k1['training']}, the tp "
        "churns the rest)")
    t_times = time.monotonic()
    g1_times[0]["launches"] = g1_launches
    g1_times[1]["launches"] = g2_launches
    kernels = [time_flash(k1["serving"], k1_launches),
               *time_flash_bwd(k23["training"], trained),
               time_paged(k4["serving"], k4_launches),
               time_paged(k4["verify"], k4_verify, R=verify_rows),
               *g1_times[:2]]
    gmm_f32 = {(r["name"], "skewed" in r["shape"]): r
               for r in g1_times[2:]}
    g1_f32 = gmm_f32[("grouped_matmul_f32", False)]
    g2_f32 = gmm_f32[("grouped_matmul_dw_f32", False)]
    g1_f32["launches"] = f32["grouped_matmul"]
    g2_f32["launches"] = f32["grouped_matmul_dw"]
    # The f32 kernels, each with its launches over every f32 path.
    kernels += [time_flash(k1["serving_f32"], f32["flash_fwd"],
                           dtype=torch.float32),
                *time_flash_bwd(k23["training_f32"], f32,
                                dtype=torch.float32),
                time_paged(k4["serving_f32"], f32["paged_attend"],
                           dtype=torch.float32),
                g1_f32, g2_f32]
    REPORT["grouped_matmul_other_shapes"] = [
        r for r in g1_times[2:] if r is not g1_f32 and r is not g2_f32]
    idle = [kr["name"] for kr in kernels if not kr["launches"]]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    k1_train = time_flash(None, train["launches"]["flash_fwd"],
                          B=TRAIN_BATCH, Hkv=16)
    REPORT["flash_fwd_training_shape"] = k1_train
    k1_train_f32 = time_flash(None, f32_k1["training"], B=TRAIN_BATCH,
                              Hkv=16, dtype=torch.float32)
    REPORT["flash_fwd_f32_training_shape"] = k1_train_f32
    k1_suffix = time_flash_suffix(k1["suffix"])
    REPORT["flash_fwd_suffix_shape"] = k1_suffix
    tp_kernels = time_tp_kernels(tp["kernels"], {
        "float32": tp["launches"], "bfloat16": tp["bf16_launches"]})
    REPORT["tp_kernels"] = tp_kernels
    REPORT["phase_s"]["times"] = time.monotonic() - t_times
    log(f"phase times: {REPORT['phase_s']['times']:.1f} s")
    log(f"flash_fwd device shift [{k1_suffix['shape']}]: "
        f"{k1_suffix['device_shift_ms']:.4f} ms against "
        f"{k1_suffix['ms']:.4f} ms by value (CUDA events, 10 calls); "
        f"kernel device time (profiler, in turns) "
        f"{k1_suffix['kernel_device_ms']}")
    k4r4, k4r20 = kernels[3], kernels[4]
    log(f"K4 at the verify's R = {verify_rows} on {card}: "
        f"{k4r20['ms']:.4f} ms device time beside {k4r4['ms']:.4f} ms at "
        f"R = 4; byte bound {k4r20['bound_ms']:.4f} ms ({k4r20['bound_by']}"
        f"); SDPA over gathered K/V at R = {verify_rows} "
        f"{k4r20['library_ms']:.4f} ms; {k4_verify} verify launches in the "
        "speculative legs")
    for kr in kernels + [k1_train, k1_train_f32, k1_suffix,
                         *REPORT["grouped_matmul_other_shapes"],
                         *tp_kernels]:
        log(f"{kr['name']} [{kr['shape']}]: {kr['ms']:.4f} ms "
            f"({kr['tflops']:.1f} TFLOP/s; one call alone "
            f"{kr['one_call_ms']:.4f} ms), bound {kr['bound_ms']:.4f} ms "
            f"({kr['bound_by']}), plain {kr['plain_ms']:.4f} ms, library "
            f"{kr['library_ms']:.4f} ms ({kr.get('library', 'SDPA')}); "
            f"launches {kr['launches']}")
    REPORT["kernels"] = kernels
    REPORT["seconds"] = time.monotonic() - t_start
    log(f"script: {REPORT['seconds']:.1f} s, headroom "
        f"{SCRIPT_LIMIT_S - REPORT['seconds']:.1f} s of {SCRIPT_LIMIT_S:.0f};"
        " phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in
                                    REPORT["phase_s"].items()))
    log("report: " + json.dumps(REPORT, default=str))
    log(f"card: {card}")
    print(json.dumps({"kernels": [
        {k: v for k, v in kr.items()
         if k not in ("shape", "grid", "pages_per_split", "call_ms",
                      "library_call_ms", "library")}
        for kr in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
