#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``tpudist_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, in
order; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``tpudist_torch/csrc`` (one
   ``nvcc`` per source, all at once; ``LATE_BUILD``, the slowest, builds
   on through phases 3-6, and phase 3e, its check, runs after phase 6);
3. each serving kernel against its plain PyTorch version at the serving
   slice's shapes (8 slots, dh 128, KV block 16, 128 blocks per lane, window
   8, chunk 64, vocab 256): bf16 and int8 pools, ragged cursors with partial
   blocks, sentinel table tails, ragged chunk lengths, a sliding window;
   written int8 blocks must be byte-identical.  The sampling prep
   (:func:`check_sample`) on both arms (the row arm, one CTA a row; the
   cluster arm, a thread-block cluster a row) at ``SAMPLE_CASES``: S 8 and
   40 at vocab 256, 32000 and 50257, and S 8 at phase 16's vocabularies
   51200 and 256000, no filter, top-k 50, top-p 0.9 and
   both, with and without grammar rows, on rows with ties straddling the
   k-th value, a flat row, a temperature-0 row whose masked entries scale
   to -inf and a row masked whole (masked, greedy and top-k exact, top-p
   within the stated margin; each call one launch on its arm), every case
   timed on every arm beside ``torch.topk`` and ``torch.sort`` of the
   scaled row; and its grammar arm at ``GRAMMAR_CASES`` ((g) the serving
   shape with phase 4e's ``[5, 64, 256]`` pool, (h) vocab 32000 with a
   ``[5, 64, 32000]`` pool: masked, scaled and greedy exact on both arms,
   timed beside the planned arm without the pool).
   The paged decode kernel also runs the speculative verify's call (q
   ``[8, 8, s, 128]``, s = 5 and 9, a K + 1 window at fill 0; bf16 and int8
   pools, ragged cursors, a window, GQA 8/2); every decode case runs on
   the split walk (twice: the second call must equal the first) and on the
   CUDA-core walk it replaced (``decode_readings``), and the two arms are
   timed in turns at the decode step and the s = 5 verify.  The paged
   prefill's tensor-core arm
   is also held at GQA (8 q heads over 2 kv heads), chunks 16 and 128 and
   window 40, and its CUDA-core arm at the serving shape; both arms, and
   the tensor-core arm's attention without its block writes, are timed on
   the same inputs, each split by kernel under ``torch.profiler``.  Each
   kernel is timed with CUDA events
   (median of 30 after warm-up, L2 flushed between launches) beside its
   plain version, its bound and, where one PyTorch call computes the same
   function, that call; the s = 5 verify beside the s = 1 step and beside
   SDPA over the gathered view under the verify rows' own mask.  The
   paged decode and prefill also run at head dim 80 (``PAGED_HEAD_DIMS``,
   Phi-2's) and at 256 over one kv head (Gemma-2B's): each arm that takes
   the head dim against the plain version, the planned arm the tensor
   cores' at 80 and the CUDA cores' at 256, the arms timed in turns;
3b. the flash forward, dq and dk/dv kernels against their plain versions at
   the training path's shapes (b 8, h 8, s 2048, dh 128, bf16, causal), a
   GQA sliding-window case (h_kv 2, window 512), a non-causal ragged length
   (s 1000), head dim 64 (one tile; GQA 8/1 under a band at s 2047), dead
   rows, an f32 case and head dims 32 and 16 (bf16 and f32), elementwise,
   per row and over the whole tensor (:func:`flash_case_readings`); on the
   forward's wgmma arm also its f32 output, on the backward's wgmma arm
   the dq kernel that forms delta itself.  Timed as in phase 3, forward
   and backward each beside the mma.sync arm that their wgmma arm replaced
   in the same call, in turns (the replaced forward held first on the same
   inputs); the yardstick is
   ``scaled_dot_product_attention(is_causal=True)``, forward alone and
   forward + backward, and its backward beside FlashAttention's backward
   alone (dq forming delta, dk/dv).  Then every head dim: the cases at
   head dims 3 to 256 in ``FLASH_CASES`` (bf16 and f32, causal, GQA, MQA,
   windows and bands; Phi-2's 80 and Gemma-2B's 256 at phase 16's
   training shapes), and ``FLASH_TIMED`` (those two shapes) timed on the
   mma.sync arms beside SDPA's forward and backward;
3c. the fused RoPE+QKV and LoRA gather-matmul kernels against their plain
   versions at the adapter path's shapes (8 slots, d 1024, decode T 1, the
   speculative verify's T 5 and prefill T 64, rank 8, lane ids mixing
   adapters, base lanes and the sentinel), a GQA case, a rope-off ragged
   case and f32 cases (:func:`linear_agreement`: elementwise, per row and
   over the tensor), ``fused_rope_qkv`` on the arm ``_rope_arm`` picks
   (its counters must show that arm) and, for bf16, on the mma.sync arm
   too, with the split and wgmma arms' edges (the verify's T 5, ragged S 3
   x T 5 under GQA, 64 rows, 65 rows at head dim 64); timed as in phase 3
   beside the unfused chain ``fused_rope=False`` runs and ``F.linear`` of
   the product alone; ``fused_rope_qkv``'s split arm (decode, the T 5
   verify) and wgmma arm (prefill) beside the mma.sync arm they replaced,
   and ``lora_delta``'s cluster arm (decode and verify) beside the staged
   kernel it replaced, in turns; an empty kernel's time (one CTA, and the
   split arm's grid of clusters: the timer's floor); the card's
   ``cudaOccupancyMaxActiveClusters`` for both cluster arms.  Then every
   head dim, depth and rank (``QKV_WIDE_CASES``, ``LORA_RANK_CASES``:
   head dims 80, 96 and 256 over d_model 2560, 2048 and 96, a depth off
   16, an odd head dim with RoPE off; ranks 3, 12, 128 and 200, the cluster
   arm beside the staged arm), timed at ``QKV_WIDE_SHAPES`` and
   ``LORA_RANK_SHAPES``;
3d. the residual prep of the speculative verify against its plain version
   on both arms at ``RESIDUAL_CASES``: ``[8, 4, 256]`` (temperatures 0,
   0.7, 1.3, an empty-residual row, -inf entries), ``[8, 2, 17]``, ``[8, 4,
   32000]`` f32 and bf16 and ``[8, 4, 256]`` bf16 (:func:`residual_close`;
   each call one launch on its arm), timed as in phase 3 beside
   ``torch.softmax`` of both inputs;
3e. the fused toy-MLP kernel against its plain version (``MLP_CASES``: the
   toy model's weights at batches 256, 4096, a ragged 1000 and 2**20, and
   five 128-wide layers), within ``MLP_PLAIN_REL`` of it and
   ``MLP_F64_REL`` of float64 numpy, timed as in phase 3 (and with the
   host's launch, as 3c) beside its bound and the plain chain, with the
   launch plan (arm, rows a thread and a CTA, grid) of each case;
4. the main path: ``InferenceServer`` on the d1024 / 8-layer / 8-head /
   ff4096 / vocab-256 / max_len-2048 RoPE TransformerLM in bf16 (random
   weights from a seed), 16 greedy requests with prompts of 1-300 tokens
   (chunked prefill) and 16-64 new tokens; every request must finish
   "length", every kernel's launch count (zeroed just before) must grow,
   the paged prefill's tensor-core arm must serve every prefill launch, the
   paged decode's split walk every decode launch and the sampling prep's
   planned arm at vocab 256 every sampling launch.  Telemetry is on, as
   shipped; the same warm-up and requests then run on a new server with
   ``TPUDIST_TELEMETRY=0`` (:func:`serve_main_path_off`), printed beside;
4b. the adapter path: the same model and server geometry with
   ``fused_rope``, ``adapters`` and ``lora_kernel`` on, 4 adapters of rank
   8 loaded, 16 greedy requests of which a third are base lanes;
   ``fused_rope_qkv`` must launch once and ``lora_delta`` three times per
   layer and forward (``fused_rope_qkv``'s split arm serving every decode
   forward and its wgmma arm every prefill chunk; ``lora_delta``'s cluster
   arm the decode launches, the staged arm the prefill chunks), every
   base lane must equal the same
   request on the server without adapters and every adapter lane must
   differ from it, or
   equal it only where the CPU f32 path shows the adapter acting and the
   card's stream leaving an f32 stream at a near tie
   (:func:`adapter_lane_ties`);
4c. speculative decoding on phase 4's server and requests (``spec=True,
   spec_k=4``, the tied 4-layer draft): 12 greedy spec lanes, 2 greedy
   ``spec=False`` lanes, 2 lanes sampled at temperature 0.8.  Every request
   must finish "length"; ``fused_residual_prep`` must launch once a spec
   block and the paged decode kernel once a layer of every decode-arm
   forward (8 a target forward, 4 a draft forward), every launch on the
   split walk, every sampling and residual prep launch on its planned arm;
   every greedy lane must
   equal its phase-4 stream or leave it first at a near tie of the card's
   logits (:func:`hold_greedy_streams`);
4d. the same on phase 4b's adapter server and traffic (every lane greedy,
   held against phase 4b's streams; ``fused_rope_qkv`` and ``lora_delta``
   once / three times a layer of every target and draft forward, every
   decode, draft and verify forward on ``fused_rope_qkv``'s split arm and
   every prefill chunk on its wgmma arm);
4e. structured output on phase 4's model and requests
   (:func:`serve_constrained_path`): ``ServeConfig(constrain=True,
   logprobs=5)``, 6 lanes over three regexes, 4 lanes of a JSON schema, 6
   free lanes of which 3 carry stop sequences cut from phase 4's streams,
   8 greedy and 8 at temperature 0.8, every lane asking top-5 logprobs;
   first the same traffic without grammars, stops or logprobs (the
   yardstick; its greedy lanes hold phase 4's streams).  Gates: each
   constrained lane's text in its language (``re.fullmatch``, the schema's
   own check) or a prefix of a member, no ``grammar_violation``, free
   greedy lanes equal to phase 4's streams bit for bit or leaving them
   first at a near tie (the schedule moves bf16 rounding), each stop lane
   ended at its first match (a two-token match straddling two
   deliveries), the logprobs rows, every sampling launch carrying the
   grammar pool;
4f. the same traffic on phase 4c's spec server (greedy lanes equal their
   4e streams or leave them at a near tie of the logits the grammar
   allows) and on phase 4b's adapter server (the grammar gates);
4g. the JAX package's default serving configuration and its neighbours on
   phase 4's model and phase 4c's traffic (:func:`serve_arm`): (a) the
   dense cache, teacher-forced prefill and unfused sampling tail; (b) (a)
   with the sampling kernel; (c) the gather decode over the paged pool
   beside the prefill and sampling kernels; (d) phase 4c's spec server on
   the dense cache, unfused and kernel tail.  Gates: no paged decode
   launch, no kernel at all on the unfused dense runs, the sampling prep at
   least once a decode step on (b) and (c), the paged prefill on (c), the
   residual prep once a spec block on (d)'s kernel half; greedy lanes hold
   phase 4's streams (bit for bit or a near tie); the sampled lanes of (a)
   and (b), and of (d)'s halves, byte for byte alike.  (e)
   (:func:`lanes_path`): ``peek_logits`` on phase 4's kernel engine
   launches nothing and advances nothing; two lanes exported mid-stream
   from a (c) engine continue bit for bit in another (c) engine's other
   slots, and the greedy one in a kernel-arm engine bit for bit or from a
   near tie;
5. where the time goes: one admission prefill and one decode block of the
   same model under ``torch.profiler`` (device busy time, idle share, the
   heaviest kernels), on phase 4's engine and on phase 4b's; 5c: one
   speculative block (draft propose + verify) per emitted token beside
   phase 5's decode block;
6. one prompt's logits through the paged prefill path on the card (bf16,
   kernels) against the port's CPU plain path (f32, same weights); 5b: the
   same for one adapter lane through the fused RoPE+QKV arm;
7. the training main path: ``tpudist_torch.train``'s step on the d1024 /
   8-layer / 8-head / ff4096 / vocab-256 / seq-2048 LM with learned
   positions, batch 8, bf16 compute over f32 masters, Adam lr 3e-4, on
   increment-chain tokens, for 30 steps: losses, median step ms after 3
   warm-up steps, tokens/s, MFU, peak memory; the loss must fall and every
   flash kernel (counts zeroed just before) must launch 8 times a step, all
   on the wgmma arms (forward, dq and dk/dv);
8. where the training time goes: one step under ``torch.profiler``;
9. gradients at batch 2, same weights: the bf16 kernel path against the
   card's f32 plain path (dense attention, no kernel): the loss and every
   parameter's gradient by cosine similarity;
10. the toy ``demo.py`` path: ``python -m tpudist_torch.examples.demo
   --dry_run --seed 0`` for the reference's 1000 iterations, as a
   subprocess under the torchrun contract at world size 1 (the NCCL group,
   DDP, the device-group loss all-reduce) in a temporary directory, with
   ``--backend ici`` and then ``--backend host``: exit 0, 1000 metric rows,
   both losses from about 3 to at most 0.3;
11. the toy benches (``tpudist_torch.bench``): ``bench_toy`` (samples/s of
   the scanned two-model step, ``TOY_BENCH_ROUNDS`` timed runs) and ``bench_fused_mlp`` at batch 4096 (the
   kernel against the plain chain), counts zeroed just before — the fused
   kernel must launch once a timed call at least; then one toy step window
   under ``torch.profiler``;
12. the model split (:func:`split_path`): the toy models in two layer
   groups over ``[cuda:0, cuda:0]`` (``data_model_mesh(devices=...)``)
   under DDP, 1000 iterations under the torchrun contract at world size 1
   (NCCL), losses equal to phase 10's within ``SPLIT_RTOL``; then ``python
   -m tpudist_torch.examples.demo_model_split --model_parallel 1
   --dry_run --seed 0`` (phase 10's seed);
13. the MPI bootstrap (:func:`mpi_path`): ``python -m
   tpudist_torch.examples.demo_mpi_bootstrap`` under ``OMPI_COMM_WORLD_*``
   at world size 1 with ``MASTER_ADDR``/``MASTER_PORT`` (NCCL), final
   losses at most ``DEMO_LOSS_MAX``;
14. the Trainer facade (:func:`trainer_path`): ``python -m
   tpudist_torch.examples.demo_trainer --dry_run --seed 0`` fp32 and bf16
   (1000 steps, batch 128) converging (``TRAINER_LAST_MAX``); a checkpoint round
   trip (600 steps saving every 200, ``--resume`` to 1000) whose rows
   601-1000 equal the unbroken fp32 run's within ``RESUME_RTOL``; and a
   ``--profile_dir`` run of the demo whose trace holds the card's kernels.
   Each prints its wall time and losses;
15. the LM entry point whole (:func:`lm_entry_subprocess`,
   :func:`lm_entry_in_process`): on a corpus of increment chains (40
   batches of 8 x 2048 tokens and a 10% held-out tail), ``python -m
   tpudist_torch.examples.demo_long_context`` at phase 7's geometry with
   remat ``dots``, ``--num_workers 2``, eval every 10 and ``--generate 16``
   as a subprocess under the torchrun contract at world size 1 (NCCL, DDP):
   the loss falls, the eval rows are finite, the tokens print.  Then the
   same configuration in this process: under remat the flash forward
   launches 16 times a step and dq and dk/dv 8 (counts zeroed just before,
   all on the wgmma arms), fed by the native pool (which must build) and
   the device prefetch; step ms, tokens/s, MFU and idle share with the pool
   and prefetch and with the synchronous loader; every greedy token of
   ``--generate`` equal to the training forward's arg-max or at a near tie;
   peak memory under each remat policy below phase 7's; remat's gradients
   equal the plain step's bit for bit; adafactor and lion lower the loss;
16. public configurations' attention widths end to end
   (:func:`public_widths_path`, ``PUBLIC_CONFIGS``): the repo's RoPE
   TransformerLM at Phi-2's widths (16a: d 2560, 32 heads of 80, d_ff
   10240, vocab 51200; adapters of rank 128) and Gemma-2B's (16b: d 2048, 8
   heads of 256 over one KV head, d_ff 16384, vocab 256000; rank 12),
   random weights from seed 0, depth cut to 2 layers.  Each trains 10
   steps at batch 2 x seq 2048 through phase 7's step (one batch's
   gradients first held against the plain attention on the card), losses
   finite and falling, every flash launch counted; then serves 8 greedy
   requests on the trained weights with ``fused_rope``, ``adapters`` and
   ``lora_kernel`` on, four adapters loaded and the even lanes on one,
   each lane's stream equal to the dense sequential ``generate`` with its
   adapter merged into the weights or leaving it at a near tie; at head
   dim 80 every paged launch on the tensor cores;
17. sequence parallelism (:func:`seq_parallel_path`): (a) ring attention
   over 4 shards of 2048 on one card (a ``LocalRing``: the launches a rank
   of a 4-rank ring would run) at b 2, h 8, s 8192, dh 128, bf16
   (``RING_CASES``: causal, causal GQA 8/2, window 512 GQA, zigzag,
   non-causal), forward and backward held against the single-call flash
   attention and against the plain carry body, the flash launches counted
   (causal 10 of each kernel, window 512 7, zigzag and non-causal 16),
   causal again at ``inner_block`` 512 bit for bit, forward + backward
   timed beside the single call; the hop shapes' kernels (``RING_HOPS``:
   an unmasked 2048 block and window 512's corner band, f32 output)
   against their plain versions and timed; (b) the entry point's
   configuration at ``--seq_shards 4`` against ``--seq_shards 1`` on the
   same batches (seq 8192, batch 2, d1024): f32 at 2 layers within
   ``SEQ_F32_RTOL`` a step, then bf16 at 8 layers for 10 steps (step ms,
   tokens/s, MFU, peak memory, 80 flash forward launches a step against 8,
   all on the wgmma arms) within ``SEQ_BF16_RTOL`` a step, and a ring
   whose last hop leaves K/V in place outside it;
18. sharded state and tensor parallelism (:func:`sharded_path`): this
   process joins a world of 1 over NCCL under the torchrun contract and
   runs phase 7's step for 10 steps on the same batches under ``dp``
   (DDP), ``fsdp`` (ZeRO-3), ``zero1``, TP over a model axis of 2 folded
   onto the card and TP merged with FSDP, and with the bf16 gradient
   reduce: FSDP and ZeRO-1 within ``SHARD_RTOL`` of dp a step, TP within
   ``TP_RTOL``, 8 flash launches of each kernel a step (16 under TP, each
   shard at 4 heads), all wgmma; step ms, tokens/s, MFU, peak memory
   (above what was held before the run, :func:`memory_held`),
   collectives a step and ``state_bytes_per_device`` printed (at world 1
   the collectives are copies: no memory saving is measured); the flash
   kernels at the TP shard's shape held against their plain versions and
   timed beside their bound and SDPA; ``--fsdp --seq_shards 4`` against
   ``--seq_shards 4`` at seq 8192 for 5 steps, within ``SHARD_RTOL``.
19. expert parallelism, the collective matmuls, 3-D parallelism and the
   scanned step (:func:`expert_3d_path`).
20. pipeline parallelism (:func:`pipeline_path`): world 1 over NCCL,
   ``demo_pipeline``'s build at phase 7's model with 4 stages folded onto
   the card, 10 steps on phase 7's batches under GPipe (M 4), 1F1B (M 4)
   and interleaved 1F1B (V 2, M 8): losses within ``TP_RTOL`` of phase 7's
   and of each other, the flash launches a step of ``PP_LAUNCHES``, all
   wgmma; step ms, tokens/s, MFU and peak memory printed; 1F1B again at
   batch 16, M 8, its peak held against GPipe's and its M-4 peak; the
   flash kernels at the microbatches' shapes (b 2 and b 1) held and timed;
   the Trainer's ``pp`` (``demo_trainer --strategy pp``) as a subprocess.
21. the serving mesh (:func:`serve_mesh_path`, run after phase 6 on phase
   4's model): phase 4's 16 requests served over ``data x model`` places
   folded onto the card (``MESH_RUNS``: (a) 1x2, (b) 1x2 with the ring
   overlap, (c) 2x2 ring on the pool, (d) 1x8, one kv head a place, (e)
   2x2 on the dense arena, (f) phase 4b's adapter server at 1x2, (g)
   phase 4c's spec server at 1x2), each beside the unsharded run of its
   family on the same schedule (every request queued before the server
   starts).  Gates: greedy lanes equal phase 4's streams (4b's for (f))
   or leave them first at a near tie; the launches of
   :func:`mesh_launches_want` and, where the forwards match the unsharded
   run's, each per-place kernel (``fused_rope_qkv``, ``paged_attention``,
   ``paged_prefill``, ``lora_delta``'s qkv and wi deltas) at the places
   times the unsharded launches, the sampling and residual preps at the
   unsharded launches; every launch on its planned arm; the pool drained;
   ``spmd_stats``' bytes a place below the total.  Then the kernels at the
   per-place shapes (4 and 1 kv heads: decode, prefill chunk 64, the qkv
   column slice, the qkv and wi B column slices) against their plain
   versions and timed; and ``make_hybrid_mesh`` of this one-process job
   equal to ``make_mesh``.  Tokens/s, TTFT p50 and TPOT p50 of each run
   are printed beside the unsharded run's and phase 4's (no speed gate).
22. runtime robustness and telemetry (:func:`phase22_train`,
   :func:`phase22_serve`, :func:`watchdog_path`): (a) the Trainer's LM loop
   at phase 7's model on phase 7's batches, 12 steps unbroken under an
   armed watchdog (8 launches of each flash kernel a step, all wgmma), the
   same under ``TPUDIST_FAULT=sigterm@step:6`` with a save every 4
   (stopped at 6 with a forced save stamped ``preempted``,
   ``Trainer.preempted``), then ``resume=True`` at restart 1 to 12: the
   resumed losses equal the unbroken run's within ``RESUME_RTOL``, and
   the report over both generations sums its goodput to its wall-clock
   within 1% (idle is the rest, so this checks that no spans overlap);
   the report's step p50 within ``PHASE22_STEP_SPAN_REL`` of the
   CUDA-event step interval (a logged step's span ends on its loss).  (b) phase 4's server and 16 requests queued before start,
   with telemetry and the endpoints on ``TPUDIST_METRICS_PORT=0``:
   ``/healthz`` 200 and ``/statusz`` with the KV gauges mid-serve,
   ``/metrics`` with the token counter and the TTFT/TPOT sketches; the
   streams and launches equal phase 21's unsharded run on the same
   schedule, greedy lanes phase 4's or a near tie, a
   ``TPUDIST_TELEMETRY=0`` run launching the same; the report's and the
   sketch's TTFT and TPOT p50 within ``QUANTILE_REL_ERROR`` of the
   handles'; ``python -m tpudist_torch.telemetry trace`` one lifeline a
   request; tokens/s on and off printed, not gated.  (c) SIGTERM to the
   smoke's own process right after a server starts: ``serve_drain``, new
   submits refused ``draining``, the admitted requests finishing.  (d) in
   the subprocess pool: the toy demo with ``TPUDIST_WATCHDOG_S`` below an
   injected ``host_delay`` exits 124, its crash record holding the stacks.
   Every serving, training and entry-point phase records into a telemetry
   session too (``runs/telemetry`` under its working directory).
23. graceful degradation and the fleet (:func:`phase23_serve`, after
   phase 22 (b)-(c) on phase 4's model and server geometry, telemetry on;
   see the ``P23_*`` constants): (a) phase 4's first 8 requests, then 4
   priority-1 requests once every lane has its first decode block, with
   preemption into the host tier and without, twice.  At budgets of 65
   and 33 tokens every decode block is K 8: preemptions, every preempted
   lane's stream (greedy and sampled) bit for bit its preempt=False
   stream, every request ``length``; export + serialize and deserialize
   + import ms a lane, package bytes, priority-1 TTFT.  At 64 and 32
   (short last blocks) each greedy lane is its preempt=False stream or
   parts where that run's top-2 margin is within ``NEAR_TIE_GAP``; the
   sampled lane's parting is printed.  (b) 8 two-turn sessions with the
   tier on and off: 8 resumes, turn 2's paged prefill launches exactly
   the suffixes' chunks, each greedy turn 2 the tier-off stream or
   parting where the tier-off run's top-2 margin (its ``logprobs=2``
   rows) is within ``NEAR_TIE_GAP`` (turn 1's decoded KV came from
   decode's shapes, not prefill's); turn-2 TTFT.  (c) a calibration run
   measures the gold tenant's TTFT alone and under a burst of bulk work
   that fills the slots, and the TTFT SLO is set between the two (their
   geometric mean); under it, the same burst: the gold tenant alone within
   the SLO, a ``shed_state`` flip, bulk requests served before it, shed
   ones ``shed_load``, protected ones ``length``, a bulk submit after the
   flip rejected; fair share rejecting the hog with the queue more than
   half full.  (d) ``host_tier_corrupt@nth:1`` over (b)'s first 2
   sessions: one corrupt count, that turn re-prefilled to (b)'s tier-off
   stream bit for bit.  (e) 2 replicas behind ``FleetRouter``: 4 sessions' turn 2
   resumed on their home replicas, phase 4's 16 requests twice (fleet
   tokens/s beside phase 4's), the second time with
   ``replica_kill@nth:1``: no ``replica_lost``, a request re-homed,
   greedy streams phase 4's or a near tie.  Each sub-phase's serving runs
   must launch every serving kernel; the phase's launches are their sum.
24. prefill/decode disaggregation (:func:`phase24_serve`, after phase 23
   on phase 4's model, telemetry on; see the ``P24_*`` constants): phase
   4's traffic (its sampled lanes at 0.8) through ``serve_forever`` with
   ``disagg=True``: 1 prefill worker of 4 slots, 2 decode workers of 8,
   decode block 8.  (a) ``handoff="serial"`` and ``"device"``: every
   request ``length``, 16 handoffs, each greedy lane phase 4's stream or
   first differing at a near tie (``NEAR_TIE_GAP``), the sampled lanes
   equal to phase 4's server's at the same seeds counted; TTFT p50/p95,
   TPOT p50, handoff wait p50, package bytes, export (+ serialize) and
   (deserialize +) import ms a lane, tokens/s beside phase 4's, and the
   launches of each pool (differences of the counts around its engines'
   calls).  (a') 2 greedy and 2 sampled requests through the
   disaggregated and the single server, both at decode block 1 (and the
   prefill pool at phase 4's 8 slots): bit for bit.  (b)
   ``P24_KILL`` kills decode worker 0 inside the burst: one worker lost,
   lanes recovered, every request ``length``, each greedy lane (a)'s
   serial stream or a near tie, the sampled recovered lanes' equality
   printed.  (c) ``handoff_corrupt@nth:2``: one request
   ``handoff_corrupt``, the rest ``length``, a request after it served.
   Each sub-phase must launch every serving kernel; the phase's launches
   are their sum.
25. MoE serving and the draft-distillation flywheel
   (:func:`phase25_moe`, :func:`phase25_flywheel`, after phase 24).  (a)
   phase 4's widths with ``P25_EXPERTS`` experts a block (random bf16
   weights drawn on the card; every serving forward runs the dense top-1
   reference) serve phase 4's 16 requests on the kernel arms: every
   request ``length``, each greedy lane the model's stream on 4g (a)'s
   JAX-default arms (no kernel launched there) or a near tie, the paged
   decode and prefill launched once a layer of each decode step and
   prefill forward of the burst (phase 4's counts hold the same formula);
   tokens/s, TTFT, TPOT and peak memory beside phase 4's, one decode
   block's device time by kernel, and one block's MoE FFN timed at the
   decode and prefill shapes beside its bound.  (b) the same model on
   phase 4c's spec server (tied 4-layer draft, K 4), 4c's gates held
   against (a)'s streams.  (c) the same model over 1x2 places folded onto
   the card: (a)'s streams or near ties, phase 21's launch formula, the
   overlap off and the FFN replicated.  (d) phase 4c's spec server on
   phase 4's model with the capture armed by ``TPUDIST_DISTILL_CAPTURE=1``
   serves 4c's traffic, then one ``DistillLoop.run_once()``: the flash
   forward, dq and dk/dv launched as the draft's layers x
   ``P25_STEPS`` steps (+ 2 holdout forwards) predict and no serving
   kernel, the target's weights bit-equal; a ``draft_swap_corrupt`` round
   rejected with the serving draft bit-equal; ``DistillLoop.start()``
   beside a burst (TPOT with and without the thread); two noised
   candidates swapped with requests in flight on the kernel arms (greedy
   lanes held to phase 4's streams or near ties, and compared with the
   same burst without swaps: ROADMAP C3) and on 4g (d kernel)'s dense
   arms, whose decode the schedule cannot move (bit for bit against 4g's
   streams); the slot programs the same object, ``draft_swaps`` 2, the
   target bit-equal.  (e) phase 24's pools with the spec draft: one swap
   broadcast to both decode workers in lockstep.  No ``distill_round``
   event may carry ``reason="error"``.

The entry points that run as subprocesses (phases 10, 12's
``demo_model_split``, 13, 14, 15a and 20's Trainer) run together after
phase 9, ``SUBPROCESS_WORKERS`` at once (:func:`entry_point_paths`), and
the phases that use them follow; their process walls are those of a
shared host and card.  A ``timeline:`` line after each phase gives the
seconds since the start.

It prints the kernels' JSON record (a kernel with several arms also lists
each arm's time on the same inputs and its launches on the main path; the
flash kernels also their phase 17-20 launches and shape times; every
kernel its phase 21 launches by run and the per-place shapes' times, and
its phase 22, 23, 24 and 25 launches) and
the ``nvidia-smi`` line before the last line, which is the contract line
``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without CUDA or outside the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # CUDA-core f32 peak

SLOTS, HEADS, DH, BS, M, W, P, V, LAYERS = 8, 8, 128, 16, 128, 8, 64, 256, 8
MODEL = dict(vocab=256, d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
             max_len=2048, rope=True)
# the training main path: benchmarks/mfu_hunt.py GEOM as bench.py bench_lm
# trains it (learned positions, max_len = seq_len, batch 8, Adam 3e-4)
TRAIN_ARGS = ["--device", "cuda", "--seq_len", "2048", "--d_model", "1024",
              "--n_layers", "8", "--n_heads", "8", "--d_ff", "4096",
              "--vocab", "256", "--batch_size", "8", "--precision", "bf16",
              "--lr", "3e-4", "--seed", "0"]
TRAIN_STEPS, TRAIN_WARMUP = 30, 3
# phase 3b's cases: (name, b, h, h_kv, s, head dim, dtype, band); head dim
# 32 is ``python -m tpudist_torch.train``'s default model (d 128, 4 heads).
# bf16 at head dims 64 and 128 runs the backward's wgmma arm, whose dq
# kernel is also held with the delta it forms itself
FLASH_CASES = (("main path", 8, 8, 8, 2048, DH, "bf16", (0, None)),
               ("GQA + window 512", 2, 8, 2, 2048, DH, "bf16", (0, 512)),
               ("non-causal, s 1000", 2, 8, 8, 1000, DH, "bf16",
                (None, None)),
               ("dh 64 one tile", 1, 2, 2, 64, 64, "bf16", (None, None)),
               ("dh 64 GQA 8/1 band, s 2047", 1, 8, 1, 2047, 64, "bf16",
                (-20, 64)),
               ("dead rows, s 130", 2, 4, 4, 130, DH, "bf16", (10, 40)),
               ("f32 causal", 1, 4, 4, 512, DH, "f32", (0, None)),
               ("dh 32 causal", 8, 4, 4, 512, 32, "bf16", (0, None)),
               ("dh 16 GQA band", 2, 4, 2, 300, 16, "bf16", (-20, 64)),
               ("dh 32 f32 window", 2, 4, 2, 300, 32, "f32", (0, 40)),
               # every head dim up to 256: the public models' widths at
               # phase 16's training shapes (Phi-2: 32 heads of 80;
               # Gemma-2B: 8 heads of 256 over one KV head), the padded
               # mma.sync widths (8 in 16, 24 in 32, 40 in 64, 96, 200 in
               # 256), widths off 8 (element-wise copies), f32 at each
               ("dh 80 causal (Phi-2)", 2, 32, 32, 2048, 80, "bf16",
                (0, None)),
               ("dh 256 MQA causal (Gemma-2B)", 2, 8, 1, 2048, 256, "bf16",
                (0, None)),
               ("dh 96 GQA window 256", 2, 8, 2, 1000, 96, "bf16", (0, 256)),
               ("dh 200 band", 1, 4, 4, 700, 200, "bf16", (-20, 64)),
               ("dh 40 GQA causal", 2, 8, 2, 512, 40, "bf16", (0, None)),
               ("dh 24 window 40", 2, 4, 4, 300, 24, "bf16", (0, 40)),
               ("dh 8 GQA causal", 2, 4, 2, 300, 8, "bf16", (0, None)),
               ("dh 3 causal", 1, 4, 4, 130, 3, "bf16", (0, None)),
               ("dh 80 f32 causal", 1, 4, 4, 512, 80, "f32", (0, None)),
               ("dh 256 f32 MQA causal", 1, 4, 1, 300, 256, "f32",
                (0, None)),
               ("dh 96 f32 GQA window 40", 1, 4, 2, 300, 96, "f32", (0, 40)),
               ("dh 200 f32 band", 1, 2, 2, 200, 200, "f32", (-20, 64)),
               ("dh 40 f32 GQA causal", 1, 4, 2, 200, 40, "f32", (0, None)),
               ("dh 24 f32 window 40", 1, 4, 4, 200, 24, "f32", (0, 40)),
               ("dh 8 f32 causal", 1, 4, 4, 200, 8, "f32", (0, None)),
               ("dh 130 f32 MQA full", 1, 2, 1, 130, 130, "f32",
                (None, None)))
# phase 3b's timed shapes at other head dims (name, b, h, h_kv, s, dh):
# phase 16's training attention, bf16 causal, on the mma.sync arms
FLASH_TIMED = (("Phi-2 dh 80", 2, 32, 32, 2048, 80),
               ("Gemma-2B dh 256 MQA", 2, 8, 1, 2048, 256))
# the delta the dq kernel forms (rowsum(out·do) - dlse in f32) against the
# plain one, relative to rowsum(|out·do|) + |dlse|: two f32 sums of 128
# products in different orders, each within ~128·2**-24 of that magnitude
DELTA_REL_MAX = 1e-5
SERVE_KERNELS = ("paged_attention", "paged_prefill", "fused_sample")
# phase 2's slowest source (80-143 s of nvcc on an H100 host against at
# most 46-64 for the others): phases 3-6 run while it builds, and phase 3e,
# its check, after them
LATE_BUILD = "fused_mlp"
# phase 3's sampling shapes (label, S, vocab, top_k, top_p): (a) the serving
# main path, (b) the verify's 40 rows through sample_tail, (c) both filters
# at vocab 256, (d)-(f) the long vocabularies of GPT-2-style and larger LMs,
# (i) and (j) phase 16's greedy serving at Phi-2's and Gemma-2B's vocab
SAMPLE_CASES = (("a", SLOTS, V, 0, 0.0), ("b", 40, V, 0, 0.0),
                ("c", SLOTS, V, 50, 0.9), ("d", SLOTS, 32000, 0, 0.0),
                ("e", SLOTS, 32000, 0, 0.9), ("f", SLOTS, 50257, 50, 0.9),
                ("i", SLOTS, 51200, 0, 0.0), ("j", SLOTS, 256000, 0, 0.0))
# the cases that phase 16 serves at, reported under the kernels line's
# ``shapes`` beside the plain version's time
SAMPLE_PUBLIC = ("i", "j")
# the structured-output server of phases 4e and 4f: ServeConfig's grammar
# pool (4 blocks of 64 states, the sentinel block beside them), top-5
# logprobs, token 0 as EOS for the constrained lanes
CONSTRAIN_BLOCKS, CONSTRAIN_STATES, N_LOGPROBS, EOS_ID = 4, 64, 5, 0
# phase 3's grammar cases of the sampling prep (label, S, vocab, pool [G+1,
# S_max]): (g) the serving shape with that server's pool, (h) a 32000 vocab
# with a [5, 64, 32000] pool (10.2 MB)
GRAMMAR_CASES = (("g", SLOTS, V, (CONSTRAIN_BLOCKS + 1, CONSTRAIN_STATES)),
                 ("h", SLOTS, 32000, (5, 64)))
# phase 4e's grammars over default_vocab(256): three regexes (12, 24 and 47
# automaton states) and an object with an integer and a boolean (26)
CONSTRAIN_REGEXES = {"r1": "[a-f]{3,8}-[0-9]{2}",
                     "r2": "[A-Z][a-z]{2,6}( [A-Z][a-z]{2,6}){0,2}",
                     "r3": "(GET|PUT|POST) /[a-z]{1,8}(/[a-z0-9]{1,8}){0,3}"}
CONSTRAIN_SCHEMA = {"type": "object",
                    "properties": {"n": {"type": "integer"},
                                   "ok": {"type": "boolean"}},
                    "required": ["n", "ok"]}
# phase 4e's 16 lanes on phase 4's requests: each lane's grammar (6 regex
# lanes, 4 schema lanes, 6 free lanes), temperature (8 greedy, 8 at 0.8)
# and stop sequences, cut from phase 4's stream of the same request by
# token index: lane 4 one token, lane 8 the pair ending at token 9 (the
# boundary of two 8-token decode blocks when the schedule runs blocks of
# 8), lane 9 the pair ending at token 1 (token 0 comes from the prefill, so
# that pair always straddles two deliveries)
LANE_GRAMMARS = ("r1", "r1", "json", None, None, "r2", "r2", "json", None,
                 None, "r3", "r3", "json", None, "json", None)
LANE_TEMPS = tuple(0.0 if i in (0, 2, 3, 4, 5, 8, 9, 10) else 0.8
                   for i in range(16))
LANE_STOPS = {4: ((5, 6),), 8: ((8, 10),), 9: ((0, 2),)}
# phase 3d's residual shapes (label, k, vocab, dtype): the verify's main
# shape first
RESIDUAL_CASES = (("[8, 4, 256] f32", 4, V, "float32"),
                  ("[8, 2, 17] f32", 2, 17, "float32"),
                  ("[8, 4, 32000] f32", 4, 32000, "float32"),
                  ("[8, 4, 32000] bf16", 4, 32000, "bfloat16"),
                  ("[8, 4, 256] bf16", 4, V, "bfloat16"))
TRAIN_KERNELS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
ADAPTER_KERNELS = ("fused_rope_qkv", "lora_delta")
# the adapter-serving path (phases 3c, 4b, 5b): ServeConfig's pool (8 blocks
# of rank 8), 4 adapters loaded, names cycling so a third of the lanes are
# base lanes; ragged decode cursors and prefill chunk starts of the main
# path, and which lanes carry an adapter
RANK, N_ADAPTERS = 8, 4
# the speculative path's draft length: its verify runs SPEC_K + 1 rows a slot
SPEC_K = 4
# phase 4c's traffic beside the 12 greedy spec lanes: greedy lanes with
# spec=False, and lanes sampled at temperature 0.8 (spec on)
SPEC_OFF_LANES, SAMPLED_LANES = (3, 9), (6, 13)
# the largest top-2 gap of the card's bf16 logits at which a greedy spec
# lane may leave its non-speculative stream (hold_greedy_streams).  On the
# H100 7 lanes of phases 4c and 4d left theirs, every one where the gap was
# 0.015625, one bf16 step of a logit in [2, 4); phase 6 reads card logits
# at most 0.0445 (3 such steps) off the f32 plain path.  The bound is 4
# steps; a wrong verify row moves logits by far more than that.
NEAR_TIE_GAP = 0.0625
ADAPTER_NAMES = ("a0", None, "a1", "a2", None, "a3")
DECODE_OFFS = [37, 364, 120, 250, 5, 300, 180, 64]
PREFILL_OFFS = [0, 64, 128, 0, 192, 64, 256, 0]
LANE_ON = [1, 0, 1, 1, 0, 1, 1, 0]
LORA_IDS = [0, 8, 1, 8, 2, 3, 8, 0]  # 8 = the sentinel of an 8-block pool
# agreement of the fused linear kernels with their plain versions (phase
# 3c): (elementwise against |ref| + the row's largest |ref|, per row, over
# the tensor) by dtype
# the bounds sit above the H100's readings over the phase's cases: bf16
# 3.6e-3, 4.2e-3 and 2.4e-4 (the LoRA prefill products: the plain version's
# cuBLAS sums the 4096-deep intermediate in another order and rounds it to
# bf16 one step apart; fused_rope_qkv's split arm sums the depth in 8
# slices and reads 3.1e-3, 1.4e-3 and 1.2e-4, its wgmma and mma.sync arms
# 0 — bit for bit), f32 1.3e-6, 1.6e-6 and 3.2e-7.  A missed delta or a
# wrong rotation angle moves whole rows by 0.1 or more.
LINEAR_BOUNDS = {"bf16": (2 ** -7, 2 ** -7, 2 ** -10),
                 "f32": (1e-5, 1e-5, 2e-6)}
# phase 3c's cases at other head dims, depths and ranks: the public
# models' widths phase 16 serves (Phi-2: d 2560, 32 heads of 80; Gemma-2B:
# d 2048, 8 heads of 256 over one KV head), a head of 96 over d 96, a depth
# off 16 (element copies), an odd head dim with RoPE off, f32.  (name, S,
# T, nh, n_kv, dh, d, dtype, rope, delta, offsets)
QKV_WIDE_CASES = tuple(
    (name, S, T, nh, n_kv, dh, d, dtype, rope, True, offs)
    for name, S, T, nh, n_kv, dh, d, dtype, rope, offs in (
        ("Phi-2 decode, dh 80, d 2560", 8, 1, 32, 32, 80, 2560, "bf16",
         True, DECODE_OFFS),
        ("Phi-2 prefill, dh 80, d 2560", 8, 64, 32, 32, 80, 2560, "bf16",
         True, PREFILL_OFFS),
        ("Gemma-2B decode, dh 256 MQA, d 2048", 8, 1, 8, 1, 256, 2048,
         "bf16", True, DECODE_OFFS),
        ("Gemma-2B prefill, dh 256 MQA, d 2048", 8, 64, 8, 1, 256, 2048,
         "bf16", True, PREFILL_OFFS),
        ("dh 96, d 96, T 5", 8, 5, 1, 1, 96, 96, "bf16", True, DECODE_OFFS),
        ("dh 48, d 100", 3, 9, 4, 2, 48, 100, "bf16", True, [0, 9, 700]),
        ("rope off, dh 7, d 60", 3, 5, 3, 1, 7, 60, "bf16", False,
         [0, 5, 9]),
        ("f32 dh 80, d 2560", 3, 5, 32, 32, 80, 2560, "f32", True,
         [0, 3, 11])))
# (name, S, T, d_in, d_out, dtype, rank, ids): ranks 3 and 12 (padded to
# the widths 4 and 16), 128 and 200 (chunks of 64) at the public models'
# projections, on both arms at decode and verify rows
LORA_RANK_CASES = (
    ("rank 3 qkv decode (Phi-2)", SLOTS, 1, 2560, 7680, "bf16", 3,
     LORA_IDS),
    ("rank 12 qkv decode (Gemma-2B)", SLOTS, 1, 2048, 2560, "bf16", 12,
     LORA_IDS),
    ("rank 128 qkv decode (Phi-2)", SLOTS, 1, 2560, 7680, "bf16", 128,
     LORA_IDS),
    ("rank 128 wo prefill (Phi-2)", SLOTS, P, 10240, 2560, "bf16", 128,
     LORA_IDS),
    ("rank 200 wi verify (Gemma-2B)", SLOTS, SPEC_K + 1, 2048, 16384,
     "bf16", 200, LORA_IDS),
    ("rank 12 wi prefill (Gemma-2B)", SLOTS, P, 2048, 16384, "bf16", 12,
     LORA_IDS),
    ("f32 rank 200, ragged", 3, 37, 512, 300, "f32", 200, [1, 8, 7]),
    ("f32 rank 3, odd depth", 3, 3, 1001, 500, "f32", 3, [0, 8, 3]))
# phase 3c's timed shapes there: (label, T, d, nh, n_kv, dh) and (label,
# T, d_in, d_out, rank)
QKV_WIDE_SHAPES = (("Phi-2 decode", 1, 2560, 32, 32, 80),
                   ("Phi-2 prefill", P, 2560, 32, 32, 80),
                   ("Gemma-2B decode", 1, 2048, 8, 1, 256),
                   ("Gemma-2B prefill", P, 2048, 8, 1, 256),
                   ("dh 96 d 96 verify", SPEC_K + 1, 96, 1, 1, 96))
LORA_RANK_SHAPES = (("rank 3 qkv decode (Phi-2)", 1, 2560, 7680, 3),
                    ("rank 12 qkv decode (Gemma-2B)", 1, 2048, 2560, 12),
                    ("rank 128 qkv decode (Phi-2)", 1, 2560, 7680, 128),
                    ("rank 128 qkv prefill (Phi-2)", P, 2560, 7680, 128),
                    ("rank 200 wi verify (Gemma-2B)", SPEC_K + 1, 2048,
                     16384, 200))
# gradient agreement, bf16 kernel path vs f32 plain path on the same batch
# (phase 9).  Readings on the H100 (tests/torch_flash_faults.py; the same
# on the mma.sync arm and on the wgmma arm): the sound kernels leave 1 -
# cosine at 6.2e-5 at worst over the 52 parameters and the loss 1.1e-4
# apart; a bf16 plain path (dense attention, no kernel) reads 6.3e-5 and
# 1.4e-4, so that is bf16's own rounding.  On the wgmma arm, dropping the
# last (64-query) dk/dv step of every KV tile reads 1.1e-3, the diagonal
# dS·K tile of every Q tile 7.4e-3, half of every row sum of the folded
# delta 0.40 (the mma.sync arm's 32-query step read 5.2e-4).  The bounds
# sit 4.8 and 9 times above the sound readings.
GRAD_COS_MIN, LOSS_REL_MAX = 0.9997, 1e-3
# phase 3e's cases (name, weights, batch): the toy model's weights at the
# bench's batch 4096, the JAX bench's block of 256, a ragged batch and 2**20
# rows, and five 128-wide layers (the widest shape the JAX kernel takes)
MLP_CASES = (("toy b256", "toy", 256), ("toy b4096", "toy", 4096),
             ("toy ragged b1000", "toy", 1000),
             ("toy b1048576", "toy", 1 << 20),
             ("wide 128x5 b4096", "wide", 4096))
# the kernel against its plain version (both full f32, summed in another
# order; H100 readings at most 3.4e-7) and against float64 numpy
# (bench.py's own bound; readings at most 6.2e-7), relative to the
# output's largest magnitude
MLP_PLAIN_REL, MLP_F64_REL = 1e-5, 1e-4
# phase 10: the reference demo's own run (demo.py:88, 1000 iterations) from
# seed 0.  The losses end at most 0.3 (the toy data's noise floor is an MSE
# of 0.25); at 300 iterations neither this port (0.321 and 0.311 on the
# CPU) nor the JAX demo (0.374 and 0.276 on its 8-device CPU mesh) is
# there yet.
DEMO_ITERATIONS = 1000
DEMO_ARGS = ["--dry_run", "--seed", "0", "--total_iterations",
             str(DEMO_ITERATIONS)]
DEMO_LOSS_MAX = 0.3
LOSS_NAMES = ("loss/model_X", "loss/model_Y")
# phase 12: the split's losses against phase 10's.  Both stages on one card
# do the unsplit model's arithmetic in the same order, so bit for bit is
# expected; the bound admits a last-bit difference of cuBLAS's choice of
# kernel between the two processes and nothing a wrong stage moves (a
# layer's activation left out moves a loss by 1e-2 or more)
SPLIT_RTOL = 1e-5
# phase 14: demo_trainer (1000 steps, batch 128) on the CPU ends at 0.2520
# and 0.2277 (fp32), 0.2484 and 0.2248 (bf16), the means of the last 16 at
# 0.2363 and 0.2251, 0.2344 and 0.2250: the toy data's noise floor (an MSE
# of 0.25) plus the batch's own fluctuation.  A batch of 128 samples' MSE
# at the floor has a standard deviation of 0.25 * sqrt(2 / 128) = 0.031,
# so the last row's bound is the floor plus 4 of them, and the mean of
# the last 16 (a standard deviation of 0.008) keeps phase 10's 0.3
TRAINER_LAST_MAX = 0.375
# the resumed rows against the unbroken run's: bit for bit expected (the
# same kernels on the same data from the same state)
RESUME_RTOL = 1e-6
PROFILE_ITERATIONS = 50
# phase 11: one timed run of bench_toy's (8 windows of 256 steps; the
# bench's own default takes the best of 3)
TOY_BENCH_ROUNDS = 1
TRAINER_BASE = ["--dry_run", "--seed", "0"]
# the entry points run as subprocesses this many at once: each holds about
# one of the host's 8 cores and leaves the card mostly idle
SUBPROCESS_WORKERS = 8
# phase 15: the LM entry point whole at phase 7's geometry.  The corpus:
# 360 windows of 2048 increment-chain tokens at vocab 256 (seed 15), 36 held
# out (--eval_fraction 0.1), 324 training windows = 40 batches of 8 and 4
LM_CORPUS_WINDOWS, LM_CORPUS_SEED = 360, 15
LM_STEPS = 30
LM_FLAGS = ["--remat", "--remat_policy", "dots", "--num_workers", "2",
            "--eval_fraction", "0.1", "--eval_every", "10",
            "--generate", "16"]
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch")
# phase 15's optimizer runs: 10 steps each; adafactor's update is scaled by
# the parameter's RMS (~0.03 at d 1024), so its lr is 1e-2 for a step of
# Adam's size; lion at a third of Adam's 3e-4 (its sign update moves every
# weight by the full lr)
OPT_STEPS = 10
OPT_LR = {"adafactor": "1e-2", "lion": "1e-4"}
# phase 16: the repo's TransformerLM (RoPE over the full head dim, bf16
# compute over f32 masters, random weights from seed 0) at two public
# configurations' widths, each config.json's own; depth cut to 2 layers,
# and what the repo's LM does not have is not modelled.  The adapter rank
# of its serving run, and what each config names that is not modelled.
PUBLIC_CONFIGS = (
    dict(phase="16a", name="Phi-2", source="microsoft/phi-2 config.json",
         model=dict(vocab=51200, d_model=2560, n_heads=32, n_kv_heads=32,
                    d_ff=10240, n_layers=2),
         layers=32, rank=128,
         not_modelled="partial rotary (32 of 80 dims), the parallel "
                      "attention + MLP block, biases"),
    dict(phase="16b", name="Gemma-2B", source="google/gemma-2b config.json",
         model=dict(vocab=256000, d_model=2048, n_heads=8, n_kv_heads=1,
                    d_ff=16384, n_layers=2),
         layers=18, rank=12,
         not_modelled="GeGLU, RMSNorm, tied embeddings"))
# its training run (phase 7's step: Adam 3e-4) and serving run: 8 of
# phase 4's kind of requests (prompts 1-300 tokens, 16-32 new, greedy),
# four adapters loaded, the even lanes on one
PUBLIC_SEQ, PUBLIC_BATCH, PUBLIC_STEPS, PUBLIC_WARMUP = 2048, 2, 10, 3
PUBLIC_REQUESTS = 8
PUBLIC_NAMES = ("a0", None, "a1", None, "a2", None, "a3", None)
# phase 17: sequence parallelism.  (a) the ring at the training path's
# attention at 4x its context (b 2, h 8, s 8192, dh 128, bf16) over 4 local
# shards of 2048: (name, layout, causal, window, inner_block, kv heads); an
# inner_block changes nothing on the kernel body, so that case runs again
# with it and must give the same bits and launches
RING_SHARDS, RING_B, RING_H, RING_S = 4, 2, 8, 8192
RING_CASES = (("causal", "ring", True, None, 512, 8),
              ("causal gqa", "ring", True, None, None, 2),
              ("window 512 gqa", "ring", True, 512, None, 2),
              ("zigzag", "zigzag", True, None, None, 8),
              ("non-causal", "ring", False, None, None, 8))
# the hop shapes' kernels held and timed: a later hop's unmasked block and
# window 512's corner band over shards of 2048 (only the first 511 query
# rows have a live key), each with the f32 output the ring merges
RING_HOPS = (("ring hop unmasked", 2, 8, 8, 2048, DH, "bf16", (None, None)),
             ("ring hop corner band", 2, 8, 2, 2048, DH, "bf16",
              (None, 512 - 2048)))
# (b) the entry point at --seq_shards 4 against --seq_shards 1 on the same
# batches: the main training geometry at seq 8192, batch 2 (phase 7's
# tokens a step), 10 steps in bf16; the f32 pair at 2 layers, 5 steps, each
# step's loss within SEQ_F32_RTOL (the same sums in another order)
SEQ_ARGS = ["--device", "cuda", "--seq_len", "8192", "--d_model", "1024",
            "--n_layers", "8", "--n_heads", "8", "--d_ff", "4096",
            "--vocab", "256", "--batch_size", "2", "--lr", "3e-4",
            "--seed", "0"]
SEQ_STEPS, SEQ_F32_STEPS, SEQ_F32_LAYERS = 10, 5, 2
SEQ_F32_RTOL = 1e-4
# bf16 runs of the two layouts round at other places: each step's losses
# within this relative gap of each other; a ring whose last hop leaves K/V
# in place (one live block a layer read twice, another never) must leave it.
# On an H100 80GB HBM3 at 700 W the sound ring read 2.18e-5 and the stale
# one 1.26e-3: the bound sits ~9x above the one and ~6x below the other
SEQ_BF16_RTOL = 2e-4
# phase 18: sharded state and tensor parallelism at phase 7's model and
# step (TRAIN_ARGS), SHARD_STEPS steps each on the same batches, world 1
# over NCCL: dp (DDP), fsdp and zero1, TP over a model axis of TP_SHARDS
# folded onto the card and TP merged with FSDP, and the bf16 gradient
# reduce; then the entry point's --fsdp beside the ring of phase 17.
# FSDP and ZeRO-1 at world 1 gather and reduce-scatter by copies: the same
# numbers as dp, bf16 launches in the same order, each step's loss within
# SHARD_RTOL of dp's (phase 17's bound of one bf16 run against another)
SHARD_STEPS, SHARD_SEQ_STEPS, TP_SHARDS = 10, 5, 2
SHARD_RTOL = SEQ_BF16_RTOL
# TP sums two bf16 partial outputs of proj and wo (in f32, rounded once)
# where the unsharded block rounds one product: each step's loss within
# TP_RTOL of dp's.  On an H100 80GB HBM3 at 700 W TP and TP + FSDP read
# 6.10e-5 (FSDP and ZeRO-1 0: the same launches on the same numbers)
TP_RTOL = 5e-4
# the flash kernels at the TP shard's shape: phase 7's attention at half
# its heads (b 8, h 4, s 2048, dh 128, bf16, causal)
TP_FLASH_CASE = ("TP shard", 8, 8 // TP_SHARDS, 8 // TP_SHARDS, 2048, DH,
                 "bf16", (0, None))


# phase 19: (a) phase 7's model with MOE_EXPERTS experts a block folded
# onto the card, top MOE_TOPK, balance weight MOE_BALANCE, MOE_STEPS steps;
# one layer at top-1 with nothing dropped against the dense reference, its
# largest error within MOE_REF_BOUND of the output's largest magnitude (and
# its relative RMS within it): two bf16 roundings of the same products
MOE_EXPERTS, MOE_TOPK, MOE_BALANCE, MOE_STEPS, MOE_LAYERS = 8, 2, 0.01, 10, 8
MOE_REF_BOUND = 2 ** -7
# (b) the LM's MLP widths (rows = phase 7's tokens a step) at these model
# axes; each hop of the reduce-scatter rounds its running sum to bf16 once,
# so the overlapped bodies stay within m * OVERLAP_BOUND of the output's
# largest magnitude of the off body's one f32 sum
OVERLAP_SHAPE, OVERLAP_MODELS, OVERLAP_BOUND = (16384, 1024, 4096), (2, 4), \
    2 ** -7
# (c) the 3-D path's flash shape: a ring hop's unmasked block over one TP
# shard's heads (phase 17's hop at half its heads); (d) the scanned window
THREE_D_HOP = ("3-D hop (TP shard)", 2, 8 // TP_SHARDS, 8 // TP_SHARDS,
               2048, DH, "bf16", (None, None))
SCAN_K = 4
# phase 20: pipeline parallelism at phase 7's model and batches through
# demo_pipeline's build at --stages PP_STAGES folded onto the card, world
# 1 over NCCL, PP_STEPS steps a run: (schedule, microbatches, chunks) of
# PP_RUNS, each step's loss within TP_RTOL of phase 7's unpipelined step
# and of the other schedules', the flash launches a step of PP_LAUNCHES
# ((forward, dq, dk/dv); a dead unit launches nothing, 1F1B recomputes
# each forward in its backward), all on the wgmma arms; then 1F1B at batch
# PP_BIG_BATCH with M 8 (the micro stays 2) for memory; the kernels at the
# microbatches' shapes; the Trainer's pp as a subprocess
PP_STAGES, PP_STEPS, PP_BIG_BATCH = 4, 10, 16
PP_RUNS = (("gpipe", 4, 1), ("1f1b", 4, 1), ("interleaved", 8, 2))
PP_LAUNCHES = {"gpipe": (32, 32, 32), "1f1b": (64, 32, 32),
               "interleaved": (128, 64, 64)}
PP_FLASH_CASES = (("pipeline micro b 2", 2, 8, 8, 2048, DH, "bf16",
                   (0, None)),
                  ("pipeline micro b 1", 1, 8, 8, 2048, DH, "bf16",
                   (0, None)))
# the slack of the memory gate: 1F1B's peak at M 8 may exceed its M-4 peak
# by the batch-sized buffers it holds plus this share of the M-4 peak
PP_MEM_SLACK = 0.10
PP_TRAINER_ARGS = ["--strategy", "pp", "--stages", "2", "--pp_schedule",
                   "1f1b", "--dry_run", "--seed", "0", "--total_iterations",
                   "30", "--batch_size", "8"]
PP_TRAINER_LAST_MAX = 3.0
# phase 22: the Trainer's LM loop at phase 7's model, 12 steps; the
# SIGTERM drill at step 6 with a save every 4; the watchdog armed on the
# unbroken fit, its deadline far above a step (the first gets 10x)
PHASE22_STEPS, PHASE22_SIGTERM_AT, PHASE22_CKPT_EVERY = 12, 6, 4
PHASE22_WATCHDOG_S = 120
# the report's step p50 against the CUDA-event step interval: a logged
# step's span ends on the loss, so it reads the card's time; the interval
# also holds the host's work between two steps (the row, the batch)
PHASE22_STEP_SPAN_REL = 0.20
# (d): the toy demo's watchdog deadline, below the host delay injected
# into its metric reduce
WATCHDOG_DRILL_S, WATCHDOG_DELAY_MS = 3, 60000
# phase 23: graceful degradation and the fleet on phase 4's server.  (a)
# phase 4's first 8 requests, then 4 priority-1 requests (prompts 64-256
# tokens) once every low lane has its first decode block; (b) 8 sessions of
# 2 turns: turn 1 200-300 tokens, turn 2 turn 1's context plus 32-64 user
# tokens; (c) a protected tenant (priority 1) beside bulk work, and fair
# share over a hog and a light tenant; (d) (b)'s first 2 sessions with the
# first park corrupted; (e) 2 replicas behind the router.  The budgets are
# 1 + a multiple of the decode block (65, 33): a lane's remaining budget
# after its prefill-sampled token then stays a multiple of 8, so every
# decode block of every run is K = 8.  A lane's decode logits depend on
# its block boundaries (the paged decode kernel's split walk merges a
# position in the pool or in the window buffer otherwise: on the H100,
# phase 4's 8 lanes decoded at K 1, 4 or mixed left the K 8 run's
# logprobs from their second block on, and 1-3 of 8 greedy streams within
# 48 tokens; tests/torch_decode_schedule.py), and one lane's last short
# blocks shrink every neighbour's K; at K 8 throughout, a stream's blocks
# are its own, so a preempted or re-prefilled lane can be held bit for bit
# against the unbroken run.  (a) runs again at 64 and 32, where the short
# last blocks move the neighbours' K: there the greedy lanes are held to
# the near-tie bound
P23_HIGH, P23_HIGH_NEW, P23_LOW_NEW = 4, 33, 65
P23_SESSIONS, P23_TURN_NEW = 8, 33
# (c): the gold tenant's requests alone, then under the burst (8 filling
# bulk lanes, bulk requests queued behind them); the calibration run's
# TTFTs must be this far apart for an SLO to sit between them
P23_GOLD_ALONE, P23_GOLD, P23_GOLD_NEW = 2, 4, 8
P23_FILL_NEW, P23_BULK, P23_BULK_NEW = 32, 16, 16
P23_BURST_RATIO = 4.0
P23_FAIR_SHARE, P23_FAIR_QUEUE, P23_HOG_NEW = 1.5, 16, 64
P23_FLEET_SESSIONS = 4
# phase 24: prefill/decode disaggregation on phase 4's model and traffic.
# Decode worker 0 takes lanes first, so its 12th engine call (the warm-up
# makes 2: an import and a block) falls inside the burst, with lanes on it
P24_CONFIG = dict(disagg=True, num_slots=SLOTS, prefill_slots=4,
                  prefill_workers=1, decode_workers=2, decode_block=8,
                  kv_block=BS, prefill_pad=P, queue_limit=64, max_new=64)
P24_KILL = "serve_worker_kill@call:12,pool:1,worker:0"
P24_CORRUPT = "handoff_corrupt@nth:2"
# (a'): two greedy lanes and phase 4's two sampled lanes
P24_EXACT_LANES = (0, 1) + SAMPLED_LANES
# phase 25: (a)-(c) phase 4's widths with phase 19's experts a block; (d) a
# round's Trainer steps, the background loop's cadence, a churn candidate's
# relative noise and the burst tokens emitted before each swap lands
P25_EXPERTS = 8
P25_STEPS, P25_INTERVAL_S, P25_NOISE, P25_SWAP_AT = 10, 2.0, 0.05, 96
# (e): phase 4's first requests through the disaggregated pools
P25_DISAGG_REQUESTS = 8
P25_CORRUPT = "draft_swap_corrupt@nth:1"


def log(msg: str) -> None:
    print(msg, flush=True)


def entry_name(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    entry (``dkv_wgmma<128>``), or the mangled name if it has no template
    arguments."""
    for m in re.finditer(r"\d+", mangled):
        n, end = int(m.group()), m.end()
        args = re.match(r"I((?:Li-?\d+E)+)E", mangled[end + n:])
        if args and re.fullmatch(r"[A-Za-z_]\w*", mangled[end:end + n]):
            return (mangled[end:end + n] + "<"
                    + ",".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">")
    return mangled


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# a ~2 ms spin the device runs ahead of each timed call (cycles at the H100's
# ~1.98 GHz boost clock)
SPIN_CYCLES = 4_000_000


def time_ms(torch, fn, flush, n: int = 30, warmup: int = 5,
            spin: bool = True) -> float:
    """Median device time of ``fn`` over ``n`` launches (CUDA events), the
    L2 cache flushed before each.  With ``spin`` the device runs a ~2 ms
    spin kernel before the start event, so the host has queued ``fn``'s
    launches by the time the device reaches them and the events see the
    device work alone; without it (as PRs 1-2 timed) the events also see
    the host's wrapper and launch overhead, which dominates a kernel of a
    few microseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_split(torch, fn, flush, names, n: int = 30) -> dict:
    """Device ms of each kernel of ``fn`` (each launched once a call), under
    ``torch.profiler`` over ``n`` calls, each after an L2 flush as
    :func:`time_ms` times them: ``{name: ms}``, the mean over the launches
    of kernels whose name contains ``name``, for each of ``names``.  The
    mean is over the launches the window recorded: on the H100 a window
    now and then comes back with some or all of them missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        seen = {name: [] for name in names}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            for name in names:
                if name in e.name:
                    seen[name].append(e.time_range.elapsed_us() / 1e3)
        if all(len(t) >= n // 2 for t in seen.values()):
            if any(len(t) < n for t in seen.values()):
                got = {k: len(v) for k, v in seen.items()}
                log(f"  profiler window: {got} of {n} launches recorded")
            return {name: statistics.mean(t) for name, t in seen.items()}
    raise AssertionError(f"the profiler recorded too few launches of "
                         f"{names}: {({k: len(v) for k, v in seen.items()})}")


def band_live_extent(seq_q: int, seq_k: int, band) -> tuple:
    """``(rows, keys)``: the query rows with a live key in ``band`` and the
    keys with a live query row, the most of each operand a banded launch
    must read (its outputs are written whole)."""
    lo = -seq_k if band[0] is None else band[0]
    hi = seq_q + seq_k if band[1] is None else band[1]
    rows = sum(max(0, i - hi + 1) <= min(seq_k - 1, i - lo)
               for i in range(seq_q))
    keys = sum(max(0, j + lo) <= min(seq_q - 1, j + hi - 1)
               for j in range(seq_k))
    return rows, keys


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def decode_inputs(torch, dev, gen, pos0, quant, fill, window_cols=W, s=1,
                  n_kv=HEADS, dh=DH):
    S = SLOTS
    nb = 1024
    q = torch.randn(S, HEADS, s, dh, generator=gen, device=dev).bfloat16()
    if quant:
        pk = torch.randint(-127, 128, (LAYERS, nb, n_kv, BS, dh),
                           generator=gen, device=dev, dtype=torch.int8)
        pv = torch.randint(-127, 128, (LAYERS, nb, n_kv, BS, dh),
                           generator=gen, device=dev, dtype=torch.int8)
        sk = torch.rand(LAYERS, nb, n_kv, generator=gen, device=dev) * 0.02
        sv = torch.rand(LAYERS, nb, n_kv, generator=gen, device=dev) * 0.02
    else:
        pk = torch.randn(LAYERS, nb, n_kv, BS, dh, generator=gen,
                         device=dev).bfloat16()
        pv = torch.randn(LAYERS, nb, n_kv, BS, dh, generator=gen,
                         device=dev).bfloat16()
        sk = torch.ones(LAYERS, nb, n_kv, device=dev)
        sv = torch.ones(LAYERS, nb, n_kv, device=dev)
    pos0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    table = torch.full((S, M), nb, dtype=torch.int32, device=dev)
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    used = 0
    for b in range(S):
        live = -(-int(pos0[b]) // BS)
        table[b, :live] = perm[used:used + live]  # sentinel tail after
        used += live
    fill = torch.tensor(fill, dtype=torch.int32, device=dev)
    wk = torch.randn(S, n_kv, window_cols, dh, generator=gen,
                     device=dev).bfloat16()
    wv = torch.randn(S, n_kv, window_cols, dh, generator=gen,
                     device=dev).bfloat16()
    return [q, pk, pv, sk, sv, table, pos0, fill, wk, wv]


def prefill_inputs(torch, dev, gen, pos0, clen, quant, n_kv=HEADS, chunk=P,
                   dh=DH):
    """One prefill call's inputs: q of ``HEADS`` heads and a ``chunk`` of
    K/V over ``n_kv`` kv heads (GQA below ``HEADS``), the pool holding each
    lane's prefix, the write table of the engine's rule."""
    from tpudist_torch.models.paged import PagedKVConfig, _Paged

    base = decode_inputs(torch, dev, gen, [p + chunk for p in pos0], quant,
                         [0] * SLOTS, n_kv=n_kv, dh=dh)
    q = torch.randn(SLOTS, HEADS, chunk, dh, generator=gen,
                    device=dev).bfloat16()
    kn = torch.randn(SLOTS, n_kv, chunk, dh, generator=gen,
                     device=dev).bfloat16()
    vn = torch.randn(SLOTS, n_kv, chunk, dh, generator=gen,
                     device=dev).bfloat16()
    pos0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    clen = torch.tensor(clen, dtype=torch.int32, device=dev)

    from types import SimpleNamespace

    geom = SimpleNamespace(  # the pool geometry _Paged reads off a model
        n_layers=LAYERS, n_kv=n_kv, head_dim=dh, max_len=M * BS,
        dtype=torch.bfloat16)
    pg = _Paged(geom, SLOTS, PagedKVConfig(1024, BS, quant), dev)
    wtable = pg.write_tables(base[5], pos0, clen, chunk,
                             torch.ones(SLOTS, dtype=torch.bool, device=dev))
    return [q, kn, vn] + base[1:6] + [wtable, pos0, clen]


def dense_sdpa(torch, q, pool_k, pool_v, scale_k, scale_v, table, keep_cols,
               fresh_k, fresh_v, layer):
    """(library yardstick) one ``scaled_dot_product_attention`` call over
    the gathered dense K/V (gathered here, outside the timed call, and
    repeated to every query head under GQA/MQA) under the boolean mask
    ``keep_cols [S, 1, Tq, K]``, as a closure."""
    import torch.nn.functional as F

    from tpudist_torch.ops.paged_attention import _dense_view

    rows = table.long().clamp(max=pool_k.shape[1] - 1)
    k = torch.cat([_dense_view(pool_k, scale_k, rows, layer, q.dtype),
                   fresh_k], 2)
    v = torch.cat([_dense_view(pool_v, scale_v, rows, layer, q.dtype),
                   fresh_v], 2)
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, 1)
        v = v.repeat_interleave(group, 1)
    return lambda: F.scaled_dot_product_attention(q, k, v,
                                                  attn_mask=keep_cols)


def close_bf16(torch, out, ref, vmax: float) -> float:
    """Max |out - ref|, raising past ``2**-7 * vmax + 2**-8 * |ref|``.
    Both sides compute in f32 and round to bf16 at different points: the
    kernel rounds the unnormalized probabilities exp(s - m) (online softmax),
    the plain version the normalized weights (JAX's kernel and reference
    differ the same way), each a 2**-9 relative step of a weight, so an
    output (a weighted mean of V) moves by at most ~2 * 2**-9 * max|V|;
    both then round the output itself (2**-9 * |out| each)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    if not bool((err <= 2 ** -7 * vmax + 2 ** -8 * ref.abs()).all()):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def v_max(pool_v, scale_v, fresh_v) -> float:
    """Largest |V| the attention can see (int8 pools dequantized)."""
    if pool_v.dtype.is_floating_point:
        pool = float(pool_v.float().abs().max())
    else:
        pool = 127.0 * float(scale_v.max())
    return max(pool, float(fresh_v.float().abs().max()))


# phase 3's decode cases: (pos0, int8 pool, fill, window, s, kv heads).
# pos0: an empty lane, partial blocks, lanes past several 128-key splits,
# near and at max_len, prefixes ending on a split boundary; a sliding window
# that leaves whole early splits without a live key; the speculative
# verify's s = K + 1 queries over a K + 1 window at fill 0 (K = 4 and 8),
# MHA and GQA 8/2 (36 query rows a kv head: three row tiles)
_RAGGED = [0, 1, 17, 100, 255, 364, 1000, 2040]
DECODE_CASES = (
    (_RAGGED, False, [0, 3, 7, 1, 0, 5, 2, 0], None, 1, HEADS),
    (_RAGGED, True, [1, 0, 2, 7, 4, 0, 6, 3], None, 1, HEADS),
    ([5, 33, 80, 160, 200, 640, 999, 1500], False, [0, 1, 2, 3, 4, 5, 6, 7],
     100, 1, HEADS),
    ([128, 256, 2048, 0, 127, 129, 383, 384], False, [0, 0, 0, 0, 7, 7, 3, 3],
     None, 1, HEADS),
    ([5, 33, 80, 160, 200, 640, 999, 1500], True, [0, 1, 2, 3, 4, 5, 6, 7],
     40, 1, 2),
) + tuple(
    (_RAGGED[:7] + [2048 - s - 7], quant, [0] * SLOTS, window, s, n_kv)
    for s, quant, window, n_kv in ((5, False, None, HEADS),
                                   (5, True, None, HEADS),
                                   (9, False, None, HEADS),
                                   (9, True, None, HEADS),
                                   (5, False, 100, HEADS),
                                   (9, False, None, 2), (5, True, 40, 2)))


def decode_readings(torch, dev, gen) -> dict:
    """Phase 3's decode cases (``DECODE_CASES``, layers 0 and 7) on the
    planned arm (the split walk for bf16 dh 128) and on the CUDA-core arm,
    each within :func:`close_bf16`'s bound of the plain version; the split
    walk's output equal, bit for bit, to a second call's (its merge counters
    are left zero).  Verdicts under ``ok``; nothing raises."""
    from tpudist_torch import ops
    from tpudist_torch.ops.paged_attention import (_paged_attention_on_arm,
                                                   paged_attention,
                                                   paged_attention_reference)

    res = dict(err=0.0, verify_err=0.0, cc_err=0.0, ok=True, failed=[],
               repeat_equal=True, tc_launches=0, launches=0)
    ops.reset_launch_counts()
    for pos0, quant, fill, window, s, n_kv in DECODE_CASES:
        args = decode_inputs(torch, dev, gen, pos0, quant, fill,
                             window_cols=W if s == 1 else s, s=s, n_kv=n_kv)
        vmax = v_max(args[2], args[4], args[9])
        for layer in (0, LAYERS - 1):
            out = paged_attention(*args, layer=layer, window=window)
            again = paged_attention(*args, layer=layer, window=window)
            cc = _paged_attention_on_arm("cc", *args, layer=layer,
                                         window=window)
            ref = paged_attention_reference(*args, layer=layer,
                                            window=window)
            torch.cuda.synchronize()
            res["repeat_equal"] &= bool(torch.equal(out, again))
            for key, got in (("verify_err" if s > 1 else "err", out),
                             ("cc_err", cc)):
                try:
                    res[key] = max(res[key], close_bf16(torch, got, ref,
                                                        vmax))
                except AssertionError:
                    res["ok"] = False
                    res["failed"].append(dict(
                        pos0=pos0[:3], quant=quant, window=window, s=s,
                        n_kv=n_kv, layer=layer, arm=key,
                        max_abs_err=float((got.float() - ref.float())
                                          .abs().max())))
    res["launches"] = paged_attention.launches
    res["tc_launches"] = paged_attention.launches_tc
    # two planned calls a case and layer, both on the split walk, and one
    # forced CUDA-core call
    res["ok"] &= res["repeat_equal"] and res["tc_launches"] \
        == 2 * (res["launches"] - res["tc_launches"]) > 0
    ops.reset_launch_counts()
    return res


# phase 3's paged cases at other head dims (dh, kv heads): Phi-2's 80,
# which the tensor-core arms' instantiations now take (phase 16a serves on
# them), and Gemma-2B's 256 under MQA, which only the CUDA-core arms take
# (phase 16b serves on them)
PAGED_HEAD_DIMS = ((80, HEADS), (256, 1))


def paged_head_dim_readings(torch, dev, gen, flush, dh: int,
                            n_kv: int) -> dict:
    """The paged decode and prefill at head dim ``dh`` over ``n_kv`` kv
    heads (8 slots, 8 heads, KV block 16, the main path's cursors): each
    arm that takes ``dh`` against the plain version (:func:`close_bf16`;
    bf16 and int8 pools for the decode, the prefill's written blocks
    exact), the planned arm the tensor cores' where ``TC_HEAD_DIMS`` holds
    ``dh`` and the CUDA cores' elsewhere (its counter), and the arms timed
    in turns (cc, tc, tc, cc; cc, cc with one arm) beside the plain
    version and the bound."""
    from tpudist_torch import ops
    from tpudist_torch.ops.paged_attention import (TC_HEAD_DIMS,
                                                   _paged_attention_on_arm,
                                                   paged_attention,
                                                   paged_attention_reference)
    from tpudist_torch.ops.paged_prefill import (_paged_prefill_on_arm,
                                                 paged_prefill_attention,
                                                 paged_prefill_reference)

    planned = "tc" if dh in TC_HEAD_DIMS else "cc"
    order = ("cc", "tc", "tc", "cc") if planned == "tc" else ("cc", "cc")
    res = dict(head_dim=dh, n_kv=n_kv, planned=planned)
    pos0 = [37, 364, 120, 250, 5, 300, 180, 64]
    live = sum(-(-p // BS) for p in pos0)
    for quant in (True, False):  # the timed inputs last
        args = decode_inputs(torch, dev, gen, pos0, quant, [3] * SLOTS,
                             n_kv=n_kv, dh=dh)
        ops.reset_launch_counts()
        out = paged_attention(*args, layer=3)
        cc = _paged_attention_on_arm("cc", *args, layer=3)
        ref = paged_attention_reference(*args, layer=3)
        torch.cuda.synchronize()
        if paged_attention.launches_tc != (planned == "tc"):
            raise AssertionError(f"a bf16 dh-{dh} decode did not run the "
                                 f"planned {planned} arm")
        vmax = v_max(args[2], args[4], args[9])
        res[f"decode_err_{'int8' if quant else 'bf16'}"] = max(
            close_bf16(torch, out, ref, vmax),
            close_bf16(torch, cc, ref, vmax))
    nbytes = (2 * args[0].numel() * 2 + 2 * live * n_kv * BS * dh * 2
              + live * 4 + SLOTS * 8 + 2 * args[8].numel() * 2)
    flops = 4 * HEADS * dh * sum(p + 3 + 1 for p in pos0)
    turns = {arm: [] for arm in order}
    for arm in order:
        turns[arm].append(time_ms(torch, lambda: _paged_attention_on_arm(
            arm, *args, layer=3), flush))
    # the library yardstick of the main table's row 1: SDPA over the
    # pre-gathered dense view, each lane's prefix and its 4 window columns
    keep = (torch.arange(M * BS + W, device=dev)[None]
            < torch.tensor(pos0, device=dev)[:, None])
    keep[:, M * BS:M * BS + 4] = True
    res["decode"] = dict(
        arm_ms=turns, ms=statistics.mean(turns[planned]),
        plain_ms=time_ms(torch, lambda: paged_attention_reference(
            *args, layer=3), flush),
        library_ms=time_ms(torch, dense_sdpa(
            torch, args[0], *args[1:6], keep[:, None, None], args[8],
            args[9], 3), flush),
        bound=bound(nbytes, flops, H100_BF16_FLOPS))
    ppos = [0, 64, 128, 0, 192, 64, 256, 0]
    clen = [64, 64, 64, 37, 44, 64, 30, 12]
    args = prefill_inputs(torch, dev, gen, ppos, clen, False, n_kv=n_kv,
                          dh=dh)
    ops.reset_launch_counts()
    out = paged_prefill_attention(*args, layer=3, window=40)
    cc = _paged_prefill_on_arm("cc", *args, layer=3, window=40)
    ref = paged_prefill_reference(*args, layer=3, window=40)
    torch.cuda.synchronize()
    if paged_prefill_attention.launches_tc != (planned == "tc"):
        raise AssertionError(f"a bf16 dh-{dh} prefill did not run the "
                             f"planned {planned} arm")
    vmax = v_max(args[4], args[6], args[2])
    res["prefill_err"] = max(close_bf16(torch, out[0], ref[0], vmax),
                             close_bf16(torch, cc[0], ref[0], vmax))
    for got in (out, cc):
        for a, b in zip(got[1:], ref[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"dh-{dh} prefill's written blocks "
                                     f"differ from the plain version's")
    wt = args[8]
    live_blocks = sum(-(-p // BS) for p in ppos)
    touched = int((wt < 1024).sum())
    nbytes = (2 * args[0].numel() * 2 + 2 * args[1].numel() * 2
              + 2 * (live_blocks + touched) * n_kv * BS * dh * 2
              + 2 * wt.numel() * n_kv * (BS * dh * 2 + 4)
              + wt.numel() * 4 + (live_blocks + touched) * 4 + SLOTS * 8)
    flops = 4 * HEADS * dh * sum(c * p + c * (c + 1) // 2
                                 for p, c in zip(ppos, clen))
    turns = {arm: [] for arm in order}
    for arm in order:
        turns[arm].append(time_ms(torch, lambda: _paged_prefill_on_arm(
            arm, *args, layer=3), flush))
    # row 2's yardstick: SDPA over each lane's prefix and its causal chunk
    kpos = torch.arange(M * BS + P, device=dev)
    keep = torch.where(kpos < M * BS,
                       kpos < torch.tensor(ppos, device=dev)[:, None, None],
                       (kpos - M * BS)
                       <= torch.arange(P, device=dev)[None, :, None])
    res["prefill"] = dict(
        arm_ms=turns, ms=statistics.mean(turns[planned]),
        plain_ms=time_ms(torch, lambda: paged_prefill_reference(
            *args, layer=3), flush),
        library_ms=time_ms(torch, dense_sdpa(
            torch, args[0], *args[3:8], keep[:, None], args[1], args[2], 3),
            flush),
        bound=bound(nbytes, flops, H100_BF16_FLOPS))
    for key in ("decode", "prefill"):
        r = res[key]
        log(f"kernel paged {key} at head dim {dh}, {n_kv} kv heads: arms in "
            f"turns ({', '.join(order)}) " + ", ".join(
                f"{r['arm_ms'][a][order[:i].count(a)]:.4f}"
                for i, a in enumerate(order))
            + f" ms (plain {r['plain_ms']:.4f} ms, SDPA on the gathered "
            f"dense view {r['library_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.5f} ms by {r['bound'][1]}); max_abs_err "
            + (f"{res['prefill_err']:.3g}" if key == "prefill" else
               f"{res['decode_err_bf16']:.3g} bf16, "
               f"{res['decode_err_int8']:.3g} int8"))
    return res


def check_kernels(torch, dev):
    from tpudist_torch import ops
    from tpudist_torch.ops.paged_attention import (_paged_attention_on_arm,
                                                   paged_attention,
                                                   paged_attention_reference)
    from tpudist_torch.ops.paged_prefill import (TC_ROWS,
                                                 _paged_prefill_on_arm,
                                                 paged_prefill_attention,
                                                 paged_prefill_reference)

    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rec = {}

    # -- row 1: paged decode attention (the split walk and the CUDA-core
    # arm against the plain version)
    dec = decode_readings(torch, dev, gen)
    if not dec["ok"]:
        raise AssertionError(f"paged decode kernel disagrees with its plain "
                             f"version: {dec}")
    err, verify_err = dec["err"], dec["verify_err"]
    err = max(err, verify_err)

    # timing at main-path cursors (prompts of 1-300 plus 16-64 new tokens):
    # a decode step (s 1, fill 3 of a K = 8 window) and a K = 4 verify
    # (s 5, fill 0); the verify moves the same bytes but 5 times the q and
    # output rows (and its own 5-column window)
    pos0 = [37, 364, 120, 250, 5, 300, 180, 64]
    live = sum(-(-p // BS) for p in pos0)

    def decode_bytes(args):
        return (2 * args[0].numel() * 2  # q in, out
                + 2 * live * HEADS * BS * DH * 2  # live K/V blocks
                + live * 4 + SLOTS * 8  # table entries, pos0, fill
                + 2 * args[8].numel() * 2)  # window K/V

    vargs = decode_inputs(torch, dev, gen, pos0, False, [0] * SLOTS,
                          window_cols=5, s=5)
    vflops = 4 * HEADS * DH * sum(p + i + 1 for p in pos0 for i in range(5))
    # the verify rows' own mask over the dense view: the lane's prefix, and
    # window columns up to the row (fill 0)
    kpos = torch.arange(M * BS + 5, device=dev)
    vkeep = torch.where(
        kpos < M * BS, kpos < torch.tensor(pos0, device=dev)[:, None, None],
        (kpos - M * BS) <= torch.arange(5, device=dev)[None, :, None])
    verify = dict(
        s=5, max_abs_err=verify_err,
        ms=time_ms(torch, lambda: paged_attention(*vargs, layer=3), flush),
        plain_ms=time_ms(torch, lambda: paged_attention_reference(
            *vargs, layer=3), flush),
        library_ms=time_ms(torch, dense_sdpa(
            torch, vargs[0], *vargs[1:6], vkeep[:, None], vargs[8],
            vargs[9], 3), flush),
        bound=bound(decode_bytes(vargs), vflops, H100_BF16_FLOPS))
    fill = [3] * SLOTS
    args = decode_inputs(torch, dev, gen, pos0, False, fill)
    nbytes = decode_bytes(args)
    flops = 4 * HEADS * DH * sum(p + f + 1 for p, f in zip(pos0, fill))
    keep = (torch.arange(M * BS + W, device=dev)[None]
            < torch.tensor(pos0, device=dev)[:, None])
    keep[:, M * BS:M * BS + fill[0] + 1] = True
    rec["paged_attention"] = dict(
        route="cuda", source="tpudist_torch/csrc/paged_attention.cu",
        replaces="tpudist/ops/paged_attention.py:162", max_abs_err=err,
        ms=time_ms(torch, lambda: paged_attention(*args, layer=3), flush),
        plain_ms=time_ms(torch, lambda: paged_attention_reference(
            *args, layer=3), flush),
        library_ms=time_ms(torch, dense_sdpa(
            torch, args[0], *args[1:6], keep[:, None, None], args[8],
            args[9], 3), flush),
        bound=bound(nbytes, flops, H100_BF16_FLOPS), cc_max_abs_err=dec[
            "cc_err"])
    # the arms on the same inputs, in turns (cc, tc, tc, cc): the split walk
    # and the CUDA-core walk it replaced, at the decode step and the verify
    turns = {key: {"tc": [], "cc": []} for key in ("s1", "s5")}
    for arm in ("cc", "tc", "tc", "cc"):
        for key, a in (("s1", args), ("s5", vargs)):
            turns[key][arm].append(time_ms(
                torch, lambda: _paged_attention_on_arm(arm, *a, layer=3),
                flush))
    rec["paged_attention"]["arm_ms"] = turns["s1"]
    verify["arm_ms"] = turns["s5"]

    # -- row 2: paged prefill attention + block writes: the main path's
    # shape (MHA, chunk 64) at layers 0 and 7, then GQA (8 q heads over 2
    # kv heads: 64-row tiles span q heads), chunk 16 (R under one tile)
    # and chunk 128 (two chunk tiles), each with and without a window; bf16
    # and int8 pools.  The serving shape runs the tensor-core arm.
    err = 0.0
    pos0 = [0, 5, 64, 100, 300, 17, 1000, 0]
    clen = [64, 1, 30, 64, 0, 50, 64, 10]
    cases = [dict(n_kv=HEADS, chunk=P, layers=(0, LAYERS - 1))] + [
        dict(n_kv=n_kv, chunk=chunk, layers=(LAYERS - 1,))
        for n_kv, chunk in ((2, P), (HEADS, 16), (HEADS, 128))]
    for c in cases:
        for quant in (True, False):
            cl = [min(x, c["chunk"]) for x in clen]
            args = prefill_inputs(torch, dev, gen, pos0, cl, quant,
                                  n_kv=c["n_kv"], chunk=c["chunk"])
            vmax = v_max(args[4], args[6], args[2])
            for layer, window in ([(lay, None) for lay in c["layers"]]
                                  + [(1, 40)]):
                ops.reset_launch_counts()
                out = paged_prefill_attention(*args, layer=layer,
                                              window=window)
                ref = paged_prefill_reference(*args, layer=layer,
                                              window=window)
                torch.cuda.synchronize()
                if paged_prefill_attention.launches_tc != 1:
                    raise AssertionError("a bf16 dh-128 prefill did not run "
                                         "the tensor-core arm")
                err = max(err, close_bf16(torch, out[0], ref[0], vmax))
                for a, b in zip(out[1:], ref[1:]):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            "prefill kernel's written blocks/scales differ "
                            "from the plain version's")
    # the CUDA-core arm on the main path's shape, held as well
    args = prefill_inputs(torch, dev, gen, pos0, clen, False)
    out = _paged_prefill_on_arm("cc", *args, layer=3, window=40)
    ref = paged_prefill_reference(*args, layer=3, window=40)
    torch.cuda.synchronize()
    cc_err = close_bf16(torch, out[0], ref[0], v_max(args[4], args[6],
                                                      args[2]))
    # the tensor-core arm over these lanes too: one CTA walks each lane, so
    # the lane at pos0 1000 (16 prefix tiles) sets the time
    long_ms = time_ms(torch, lambda: paged_prefill_attention(*args, layer=3),
                      flush)
    pos0 = [0, 64, 128, 0, 192, 64, 256, 0]  # chunked prefill of prompts
    clen = [64, 64, 64, 37, 44, 64, 30, 12]
    args = prefill_inputs(torch, dev, gen, pos0, clen, False)
    wt = args[8]
    live_blocks = sum(-(-p // BS) for p in pos0)
    touched = int((wt < 1024).sum())
    nbytes = (2 * args[0].numel() * 2 + 2 * args[1].numel() * 2
              + 2 * (live_blocks + touched) * HEADS * BS * DH * 2
              + 2 * wt.numel() * HEADS * (BS * DH * 2 + 4)
              + wt.numel() * 4 + (live_blocks + touched) * 4 + SLOTS * 8)
    flops = 4 * HEADS * DH * sum(c * p + c * (c + 1) // 2
                                 for p, c in zip(pos0, clen))
    kpos = torch.arange(M * BS + P, device=dev)
    p0 = torch.tensor(pos0, device=dev)[:, None, None]
    row = torch.arange(P, device=dev)[None, :, None]
    keep = torch.where(kpos < M * BS, kpos < p0, (kpos - M * BS) <= row)
    planned = lambda: paged_prefill_attention(*args, layer=3)  # noqa: E731
    # the arms on the same inputs, each split by kernel: the tensor-core
    # arm is one launch (its block writes run in extra CTAs beside the
    # attention), and alone without them; the CUDA-core arm launches the
    # attention, then the same block writes as a kernel of their own
    tc, cc = ("prefill_tc_kernel",), ("paged_attention_kernel",
                                      "prefill_write_kernel")
    arms = {
        "tc": (tc, planned),
        "tc attention alone": (tc, lambda: _paged_prefill_on_arm(
            "tc", *args, layer=3, writes=False)),
        "cc": (cc, lambda: _paged_prefill_on_arm("cc", *args, layer=3))}
    arm_rec = {name: dict(ms=time_ms(torch, fn, flush),
                          split=kernel_split(torch, fn, flush, names))
               for name, (names, fn) in arms.items()}
    rec["paged_prefill"] = dict(
        route="cuda", source="tpudist_torch/csrc/paged_prefill.cu",
        replaces="tpudist/ops/paged_prefill.py:189", max_abs_err=err,
        ms=arm_rec["tc"]["ms"],
        plain_ms=time_ms(torch, lambda: paged_prefill_reference(
            *args, layer=3), flush),
        library_ms=time_ms(torch, dense_sdpa(
            torch, args[0], *args[3:8], keep[:, None], args[1], args[2], 3),
            flush),
        bound=bound(nbytes, flops, H100_BF16_FLOPS),
        kernel_ms=arm_rec["tc"]["split"][tc[0]],
        attn_ms=arm_rec["tc attention alone"]["split"][tc[0]],
        write_ms=arm_rec["cc"]["split"][cc[1]],
        cc_max_abs_err=cc_err, arms=arm_rec, long_lanes_ms=long_ms)

    for name, r in rec.items():
        log(f"kernel {name}: max_abs_err {r['max_abs_err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']} ms, bound {r['bound'][0]:.5f} ms by "
            f"{r['bound'][1]})")
    pr = rec["paged_prefill"]
    log(f"kernel paged_prefill, tensor-core arm ({TC_ROWS} rows a CTA): "
        f"{pr['ms']:.4f} ms, one launch of {pr['kernel_ms']:.4f} ms on the "
        f"device; attention alone {pr['attn_ms']:.4f} ms, the block writes "
        f"as a kernel of their own {pr['write_ms']:.4f} ms (profiler, per "
        f"call); arms on the same inputs: " + "; ".join(
            f"{name} {a['ms']:.4f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in a["split"].items()) + ")"
            for name, a in pr["arms"].items())
        + f"; CUDA-core arm max_abs_err {pr['cc_max_abs_err']:.3g}; "
        f"lanes up to pos0 1000 {pr['long_lanes_ms']:.4f} ms")
    log(f"kernel paged_attention, verify s 5 and 9 (bf16, int8, window, "
        f"GQA 8/2): max_abs_err {verify_err:.3g}; s 5 timed "
        f"{verify['ms']:.4f} ms (plain {verify['plain_ms']:.4f} ms, library "
        f"{verify['library_ms']:.4f} ms, bound "
        f"{verify['bound'][0]:.5f} ms by {verify['bound'][1]}) beside s 1 "
        f"{rec['paged_attention']['ms']:.4f} ms")
    for key, arms in (("s 1", rec["paged_attention"]["arm_ms"]),
                      ("verify s 5", verify["arm_ms"])):
        log(f"kernel paged_attention {key}, arms in turns (cc, tc, tc, cc): "
            f"{arms['cc'][0]:.4f}, {arms['tc'][0]:.4f}, {arms['tc'][1]:.4f}, "
            f"{arms['cc'][1]:.4f} ms; split walk / CUDA-core "
            f"{sum(arms['tc']) / sum(arms['cc']):.3f}")
    log(f"kernel paged_attention: split walk s 5 / s 1 "
        f"{sum(verify['arm_ms']['tc']) / sum(rec['paged_attention']['arm_ms']['tc']):.3f}; "
        f"CUDA-core arm max_abs_err {dec['cc_err']:.3g}; "
        f"{dec['tc_launches']} checking launches on the split walk")
    rec["paged_attention"]["verify"] = verify
    for dh, n_kv in PAGED_HEAD_DIMS:
        r = paged_head_dim_readings(torch, dev, gen, flush, dh, n_kv)
        label = f"dh {dh}" + (f" kv {n_kv}" if n_kv != HEADS else "")
        for name, key in (("paged_attention", "decode"),
                          ("paged_prefill", "prefill")):
            rec[name].setdefault("head_dims", {})[label] = dict(
                r[key], max_abs_err=r["prefill_err"] if key == "prefill"
                else max(r["decode_err_bf16"], r["decode_err_int8"]))
    del flush
    ops.reset_launch_counts()
    return rec


def residual_close(torch, out, ref, lt, temps) -> float:
    """The residual prep against its plain version, with the CPU test's
    tolerances (tests/test_torch_spec.py): ``pt`` and ``pd`` to ``rtol
    2e-6, atol 1e-7`` (the kernel sums each softmax in another order), the
    same rows with an empty residual, those rows' logits ``lt / temp`` bit
    for bit, the residual probabilities ``exp(lr)`` to ``atol 1e-6``.
    Returns the largest difference of ``pt``, ``pd`` and ``exp(lr)``."""
    err = 0.0
    for a, b in zip(out[:2], ref[:2]):
        if not torch.allclose(a, b, rtol=2e-6, atol=1e-7):
            raise AssertionError("fused_residual_prep's softmax differs from "
                                 "its plain version")
        err = max(err, float((a - b).abs().max()))
    has = [(torch.clamp(x[0] - x[1], min=0) > 0).any(-1) for x in (out, ref)]
    if not torch.equal(has[0], has[1]):
        raise AssertionError("fused_residual_prep finds another set of "
                             "empty residuals than its plain version")
    temp = torch.clamp(temps, min=1e-6)[:, None, None]
    scaled = (lt.float() / temp)[~has[0]]
    if not (torch.equal(out[2][~has[0]], scaled)
            and torch.equal(ref[2][~has[0]], scaled)):
        raise AssertionError("an empty residual row is not lt / temp bit "
                             "for bit")
    pe, re = out[2][has[0]].exp(), ref[2][has[0]].exp()
    if not torch.allclose(pe, re, rtol=0, atol=1e-6):
        raise AssertionError("fused_residual_prep's residual differs from "
                             "its plain version")
    return max(err, float((pe - re).abs().max()) if pe.numel() else 0.0)


def sample_inputs(torch, dev, gen, S: int, vocab: int):
    """Logits ``[S, vocab]`` with ties straddling the top-k threshold (row
    1), a flat row (2), a temperature-0 row whose grammar-masked entries
    scale to -inf (3), and a row the grammar masks whole at temperature 1
    (6: every scaled value finfo(f32).min); temperatures; grammar rows."""
    lg = torch.randn(S, vocab, generator=gen, device=dev) * 2
    lg[1, :60] = 4.0
    lg[2] = 0.5
    temps = torch.tensor([1.0, 0.7, 1.3, 0.0, 2.0, 0.5, 1.0, 0.9] * (
        S // 8 + 1), device=dev)[:S]
    gallow = torch.rand(2, 3, vocab, generator=gen, device=dev) > 0.5
    gallow[1] = True
    gallow[0, 2] = False
    gidx = torch.tensor(([1, 1, 1, 0, 1, 0, 0, 1] * (S // 8 + 1))[:S],
                        dtype=torch.int32, device=dev)
    gstate = torch.tensor(([0, 1, 2, 1, 0, 1, 2, 2] * (S // 8 + 1))[:S],
                          dtype=torch.int32, device=dev)
    return lg, temps, gallow, gidx, gstate


def grammar_inputs(torch, dev, gen, S: int, vocab: int, pool):
    """A grammar case's inputs: logits ``[S, vocab]`` (unit normal times
    2), temperatures with greedy rows, a bool pool ``[G+1, S_max, vocab]``
    whose rows allow from a few to most tokens (block ``G`` the all-True
    sentinel; block 0's state 0 allows token 1 alone, an automaton that
    takes nothing but EOS), and each row's ``(gidx, gstate)``: rows 2 and 5
    on the sentinel, row 0 on the one-token state, the others on random
    blocks and states."""
    G1, n_states = pool
    lg = torch.randn(S, vocab, generator=gen, device=dev) * 2
    temps = torch.tensor(([0.0, 0.8, 1.0, 0.0, 0.8, 1.3, 0.8, 0.5] * S)[:S],
                         device=dev)
    dens = torch.rand(G1, n_states, 1, generator=gen, device=dev)
    gallow = torch.rand(G1, n_states, vocab, generator=gen,
                        device=dev) < dens
    gallow[0, 0] = False
    gallow[0, 0, 1] = True
    gallow[G1 - 1] = True
    gidx = torch.randint(0, G1 - 1, (S,), generator=gen, device=dev,
                         dtype=torch.int32)
    gstate = torch.randint(0, n_states, (S,), generator=gen, device=dev,
                           dtype=torch.int32)
    gidx[[2, 5]] = G1 - 1
    gidx[0] = gstate[0] = 0
    return lg, temps, gallow, gidx, gstate


def prep_arms(kind: str, rows: int, vocab: int) -> list:
    """Both arms of the sampling (``kind`` "sample") or residual
    ("residual") prep that take ``rows`` rows of ``vocab``: the plan's
    first, then the other (the row arm only up to its longest row, the
    cluster arm at the size the plan would give it)."""
    from tpudist_torch.ops import fused_sample as fs

    plan = fs._sample_arm if kind == "sample" else fs._residual_arm
    most = (fs.SAMPLE_ROW_MAX_NV if kind == "sample"
            else fs.RESIDUAL_ROW_MAX_NV) * fs.SAMPLE_THREADS
    arms = [plan(rows, vocab)]
    if arms[0][0] == "row":
        arms.append(("cluster", fs._cluster_size(rows, vocab)))
    elif vocab <= most:
        arms.append(("row",
                     fs._pow2_at_least(-(-vocab // fs.SAMPLE_THREADS))))
    return arms


def check_sample(torch, dev):
    """Phase 3, row 3: ``fused_sample_prep`` against its plain version at
    the serving shape (arg-max ties, top-k 5 and 12, top-p, grammar rows)
    and on both arms at ``SAMPLE_CASES`` (the arm the plan names, and the
    other where it takes the row) on :func:`sample_inputs`' rows, with and
    without grammar rows; masked, greedy and top-k exact, top-p within
    ``check_filters``' margin; each call one launch on the arm it was
    given.  Then the times: every case on every arm
    that takes it (CUDA events, median of 30, L2 flushed before each
    launch), the plain version at the main path's shape, ``torch.topk(.,
    50)`` and ``torch.sort`` of the scaled row (one step of the plain
    version each, not the same function) where the filters run, and each
    case's bytes bound."""
    from tpudist_torch import ops
    from tpudist_torch.ops.fused_sample import (_launch_sample,
                                                fused_sample_prep,
                                                fused_sample_reference)

    gen = torch.Generator(device=dev).manual_seed(4321)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # the serving shape on the planned arm: tied maxima (lowest index wins),
    # a zero row, grammar rows; the filters at top-k 5 and 12 (12 values
    # tied at the 12th), top-p 0.9 and both, a flat row
    lg = torch.randn(SLOTS, V, generator=gen, device=dev)
    lg[0, [3, 9, 200]] = 10.0
    lg[1] = 0.0
    temps = torch.tensor([0, 0.7, 1.3, 0, 2, 0.5, 0, 1], device=dev)
    gallow = torch.rand(3, 5, V, generator=gen, device=dev) > 0.3
    gallow[2] = True
    gidx = torch.tensor([0, 2, 1, 2, 0, 1, 2, 0], dtype=torch.int32,
                        device=dev)
    gstate = torch.tensor([1, 0, 3, 4, 2, 0, 1, 4], dtype=torch.int32,
                          device=dev)
    for a in ((lg, temps), (lg, temps, gallow, gidx, gstate)):
        out = fused_sample_prep(*a)
        for x, y in zip(out, fused_sample_reference(*a)):
            if not torch.equal(x, y):
                raise AssertionError("fused_sample_prep differs from its "
                                     "plain version")
    if int(out[2][1]) != 0 or int(fused_sample_prep(lg, temps)[2][0]) != 3:
        raise AssertionError("arg-max ties must pick the lowest index")
    lg[2, :12] = 3.0
    lg[3] = 0.5
    for tk, tp in ((5, 0.0), (0, 0.9), (5, 0.9), (12, 0.0)):
        for a in ((lg, temps), (lg, temps, gallow, gidx, gstate)):
            check_filters(torch, fused_sample_prep(*a, top_k=tk, top_p=tp),
                          fused_sample_reference(*a, top_k=tk, top_p=tp),
                          fused_sample_reference(*a, top_k=tk)[1], tp)
    cases = {}
    for label, S, vocab, tk, tp in SAMPLE_CASES:
        args = sample_inputs(torch, dev, gen, S, vocab)
        filtered = 0 < tk < vocab or 0.0 < tp < 1.0
        arms = prep_arms("sample", S, vocab)
        for arm, width in arms:
            for a in (args[:2], args):
                ops.reset_launch_counts()
                out = _launch_sample(arm, width, *a, top_k=tk, top_p=tp)
                torch.cuda.synchronize()
                got = (ops.fused_sample_prep.launches_row,
                       ops.fused_sample_prep.launches_cluster)
                if got != ((1, 0) if arm == "row" else (0, 1)):
                    raise AssertionError(f"fused_sample_prep ({label}) on "
                                         f"the {arm} arm launched {got}")
                check_filters(torch, out,
                              fused_sample_reference(*a, top_k=tk, top_p=tp),
                              fused_sample_reference(*a, top_k=tk)[1], tp)
        # timed on rows of unit-normal logits times 2 at temperatures in
        # [0.5, 1.5): the checked rows' ties and flat rows are edge cases
        lg = torch.randn(S, vocab, generator=gen, device=dev) * 2
        temps = torch.rand(S, generator=gen, device=dev) + 0.5
        nbytes = S * vocab * 4 * 3 + S * 4 * 2
        row = dict(S=S, vocab=vocab, top_k=tk, top_p=tp,
                   planned=f"{arms[0][0]}{arms[0][1]}",
                   bound=bound(nbytes, 3 * S * vocab, H100_F32_FLOPS),
                   arm_ms={f"{arm}{width}": time_ms(
                       torch, lambda: _launch_sample(arm, width, lg, temps,
                                                     top_k=tk, top_p=tp),
                       flush) for arm, width in arms})
        if label in SAMPLE_PUBLIC:
            row["plain_ms"] = time_ms(
                torch, lambda: fused_sample_reference(lg, temps, top_k=tk,
                                                      top_p=tp), flush)
        if filtered:
            scaled = fused_sample_reference(lg, temps)[1]
            row["topk_ms"] = time_ms(
                torch, lambda: torch.topk(scaled, 50, dim=-1), flush)
            row["sort_ms"] = time_ms(
                torch, lambda: torch.sort(scaled, dim=-1, descending=True),
                flush)
        cases[label] = row
        log(f"kernel fused_sample ({label}: S {S}, vocab {vocab}, top_k "
            f"{tk}, top_p {tp}): " + ", ".join(
                f"{a} {ms:.4f}" for a, ms in row["arm_ms"].items())
            + f" ms (plan {row['planned']}); bound {row['bound'][0]:.6f} ms"
            + (f"; plain {row['plain_ms']:.4f} ms" if "plain_ms" in row
               else "")
            + (f"; torch.topk(50) {row['topk_ms']:.4f}, torch.sort "
               f"{row['sort_ms']:.4f} ms" if filtered else ""))
    for label, S, vocab, pool in GRAMMAR_CASES:
        cases[label] = check_grammar_case(torch, dev, gen, flush, label, S,
                                          vocab, pool)
    main = cases["a"]
    lg = torch.randn(SLOTS, V, generator=gen, device=dev) * 2
    temps = torch.rand(SLOTS, generator=gen, device=dev) + 0.5
    rec = dict(
        route="cuda", source="tpudist_torch/csrc/fused_sample.cu",
        replaces="tpudist/ops/fused_sample.py:79", max_abs_err=0.0,
        ms=main["arm_ms"][main["planned"]],
        plain_ms=time_ms(torch, lambda: fused_sample_reference(lg, temps),
                         flush),
        library_ms=None, bound=main["bound"],
        arm_ms={k.rstrip("0123456789"): v
                for k, v in main["arm_ms"].items()},
        cases=cases,
        shapes={f"[{cases[c]['S']}, {cases[c]['vocab']}]": dict(
            ms=cases[c]["arm_ms"][cases[c]["planned"]],
            plain_ms=cases[c]["plain_ms"], library_ms=None,
            bound=cases[c]["bound"]) for c in SAMPLE_PUBLIC})
    log(f"kernel fused_sample: max_abs_err 0 (exact; top-p within the "
        f"margin), {rec['ms']:.4f} ms at the main path (plain "
        f"{rec['plain_ms']:.4f} ms, library none, bound "
        f"{rec['bound'][0]:.6f} ms by {rec['bound'][1]})")
    del flush
    ops.reset_launch_counts()
    return {"fused_sample": rec}


def check_grammar_case(torch, dev, gen, flush, label, S, vocab, pool):
    """Phase 3, row 3's grammar arm at a constrained server's pool
    (``GRAMMAR_CASES``): on both arms, one launch each (counted by
    ``launches_grammar`` too), masked, scaled and greedy equal to the plain
    version bit for bit on :func:`grammar_inputs`; then timed as in phase
    3 on both arms, beside the planned arm without the grammar operands on
    the same logits and the plain version.  The bound counts the logits
    read, one allow row read a slot (``S · V`` bytes), ``masked`` and
    ``scaled`` written, and the per-row scalars."""
    from tpudist_torch import ops
    from tpudist_torch.ops.fused_sample import (_launch_sample,
                                                fused_sample_reference)

    args = grammar_inputs(torch, dev, gen, S, vocab, pool)
    arms = prep_arms("sample", S, vocab)
    for arm, width in arms:
        ops.reset_launch_counts()
        out = _launch_sample(arm, width, *args)
        torch.cuda.synchronize()
        fs = ops.fused_sample_prep
        got = (fs.launches_row, fs.launches_cluster, fs.launches_grammar)
        if got != ((1, 0, 1) if arm == "row" else (0, 1, 1)):
            raise AssertionError(f"fused_sample_prep ({label}) on the {arm} "
                                 f"arm launched {got} (row, cluster, "
                                 "grammar)")
        for name, x, y in zip(("masked", "scaled", "greedy"), out,
                              fused_sample_reference(*args)):
            if not torch.equal(x, y):
                raise AssertionError(f"fused_sample_prep's grammar arm "
                                     f"({label}, {arm}) differs from its "
                                     f"plain version in {name}")
    G1, n_states = pool
    nbytes = S * vocab * 4 + S * vocab + 2 * S * vocab * 4 + S * 4 * 4
    plan = arms[0]
    row = dict(
        S=S, vocab=vocab, pool=[G1, n_states, vocab],
        pool_bytes=G1 * n_states * vocab, planned=f"{plan[0]}{plan[1]}",
        bound=bound(nbytes, 3 * S * vocab, H100_F32_FLOPS),
        arm_ms={f"{arm}{width}": time_ms(
            torch, lambda: _launch_sample(arm, width, *args), flush)
            for arm, width in arms},
        free_ms=time_ms(torch, lambda: _launch_sample(*plan, *args[:2]),
                        flush),
        plain_ms=time_ms(torch, lambda: fused_sample_reference(*args),
                         flush))
    log(f"kernel fused_sample ({label}: S {S}, vocab {vocab}, grammar pool "
        f"{row['pool']} = {row['pool_bytes']} bytes): " + ", ".join(
            f"{a} {ms:.4f}" for a, ms in row["arm_ms"].items())
        + f" ms (plan {row['planned']}); the planned arm without grammar "
        f"{row['free_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms; bound "
        f"{row['bound'][0]:.6f} ms by {row['bound'][1]}; masked, scaled and "
        f"greedy exact")
    ops.reset_launch_counts()
    return row


def check_residual(torch, dev):
    """Phase 3d: the residual prep kernel against its plain version
    (:func:`residual_close`) on both arms at ``RESIDUAL_CASES``
    (temperatures 0, 0.7 and 1.3, a row with draft == target, ``-inf``
    target entries), each call one launch on the arm it was given; every
    case timed on every arm that takes it as in phase 3, beside the bytes
    bound and ``torch.softmax`` of ``lt`` and of ``ld`` (one step of the
    plain version, not the same function)."""
    from tpudist_torch import ops
    from tpudist_torch.ops.fused_sample import (_launch_residual,
                                                fused_residual_reference)

    gen = torch.Generator(device=dev).manual_seed(99)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    temps = torch.tensor([0, 0.7, 1.3, 0.7, 0, 1.3, 0.7, 1.3], device=dev)
    err, cases = 0.0, {}
    for label, k, vocab, dtype in RESIDUAL_CASES:
        dt = getattr(torch, dtype)
        lt = torch.randn(SLOTS, k, vocab, generator=gen, device=dev) * 3
        ld = torch.randn(SLOTS, k, vocab, generator=gen, device=dev) * 3
        ld[2] = lt[2]  # an empty residual
        lt[3, 0, ::5] = float("-inf")
        lt, ld = lt.to(dt), ld.to(dt)
        arms = prep_arms("residual", SLOTS * k, vocab)
        for arm, width in arms:
            ops.reset_launch_counts()
            out = _launch_residual(arm, width, lt, ld, temps)
            torch.cuda.synchronize()
            got = (ops.fused_residual_prep.launches_row,
                   ops.fused_residual_prep.launches_cluster)
            if got != ((1, 0) if arm == "row" else (0, 1)):
                raise AssertionError(f"fused_residual_prep ({label}) on the "
                                     f"{arm} arm launched {got}")
            err = max(err, residual_close(
                torch, out, fused_residual_reference(lt, ld, temps), lt,
                temps))
        lt = (torch.randn(SLOTS, k, vocab, generator=gen, device=dev)
              * 3).to(dt)
        ld = (torch.randn(SLOTS, k, vocab, generator=gen, device=dev)
              * 3).to(dt)
        nbytes = SLOTS * k * vocab * (2 * lt.element_size() + 3 * 4) \
            + SLOTS * 4
        row = dict(
            k=k, vocab=vocab, dtype=dtype, planned=f"{arms[0][0]}{arms[0][1]}",
            # ~12 f32 operations an entry: 4 divisions, 2 exps, 3
            # subtractions, a max, an add and a log
            bound=bound(nbytes, 12 * SLOTS * k * vocab, H100_F32_FLOPS),
            arm_ms={f"{arm}{width}": time_ms(
                torch, lambda: _launch_residual(arm, width, lt, ld, temps),
                flush) for arm, width in arms},
            softmax_ms=time_ms(torch, lambda: (torch.softmax(lt, dim=-1),
                                               torch.softmax(ld, dim=-1)),
                               flush))
        cases[label] = row
        log(f"kernel fused_residual_prep ({label}): " + ", ".join(
            f"{a} {ms:.4f}" for a, ms in row["arm_ms"].items())
            + f" ms (plan {row['planned']}); bound {row['bound'][0]:.6f} "
            f"ms; torch.softmax of lt and ld {row['softmax_ms']:.4f} ms")
    main = cases[RESIDUAL_CASES[0][0]]
    lt = torch.randn(SLOTS, 4, V, generator=gen, device=dev) * 3
    ld = torch.randn(SLOTS, 4, V, generator=gen, device=dev) * 3
    rec = dict(
        route="cuda", source="tpudist_torch/csrc/fused_sample.cu",
        replaces="tpudist/ops/fused_sample.py:219", max_abs_err=err,
        ms=main["arm_ms"][main["planned"]],
        plain_ms=time_ms(torch, lambda: fused_residual_reference(
            lt, ld, temps), flush),
        library_ms=None, bound=main["bound"],
        arm_ms={k.rstrip("0123456789"): v
                for k, v in main["arm_ms"].items()},
        cases=cases)
    log(f"kernel fused_residual_prep: max_abs_err {err:.3g}, "
        f"{rec['ms']:.4f} ms at the verify's shape (plain "
        f"{rec['plain_ms']:.4f} ms, library none, bound "
        f"{rec['bound'][0]:.6f} ms by {rec['bound'][1]})")
    del flush
    ops.reset_launch_counts()
    return {"fused_residual_prep": rec}


def check_filters(torch, out, ref, topk_row, top_p: float) -> None:
    """Sampling outputs with top-k / top-p on: masked, greedy and top-k
    exact.  A top-p kept set may differ from the plain version's only where
    the softmax mass before a value lies within ``V * 2**-23`` of
    ``top_p``: the kernel sums the row's probabilities in another order
    than a sequential cumsum, each of V additions rounding by at most
    2**-24 relative on either side.  A row whose top value is not finite
    has no softmax to round: its kept set is exact."""
    import numpy as np

    for x, y in ((out[0], ref[0]), (out[2], ref[2])):
        if not torch.equal(x, y):
            raise AssertionError("fused_sample_prep differs from its plain "
                                 "version")
    if top_p == 0.0:
        if not torch.equal(out[1], ref[1]):
            raise AssertionError("top-k filtered logits differ")
        return
    neg = torch.finfo(torch.float32).min
    o, r, t = (x.cpu().numpy() for x in (out[1], ref[1], topk_row))
    n_vocab = o.shape[1]
    for row in range(o.shape[0]):
        diff = np.flatnonzero((o[row] == neg) != (r[row] == neg))
        srt = np.sort(t[row].astype(np.float64))[::-1]
        if not np.isfinite(srt[0]):  # no softmax: the kept sets are exact
            if diff.size:
                raise AssertionError("top-p kept sets differ on a row whose "
                                     "top value is not finite")
            continue
        p = np.exp(srt - srt[0])
        before = np.concatenate([[0.0], np.cumsum(p / p.sum())[:-1]])
        for pos in diff:
            first = int(np.flatnonzero(srt == float(t[row, pos]))[0])
            if abs(before[first] - top_p) > n_vocab * 2.0 ** -23:
                raise AssertionError(
                    f"top-p kept sets differ at mass {before[first]} "
                    f"(top_p {top_p})")
    kept = out[1] > neg
    if not torch.equal(out[1][kept], ref[1][kept]):
        raise AssertionError("top-p kept values differ")


# ---------------------------------------------------------------------------
# phase 3b: the flash kernels against their plain versions


def flash_agreement(torch, out, ref, dtype, grad: bool = True,
                    vmax: float = 0.0) -> dict:
    """How a flash output or gradient agrees with its plain version, against
    the stated bounds.

    Elementwise: f32 sums in another order only (``1e-4 * max|ref| + 1e-4 *
    |ref|``).  bf16 gradients round ds and p to bf16 before their products
    on both sides, and a value on a rounding boundary can land one bf16 step
    (2**-8) apart: ``2**-7 * max|ref| + 2**-7 * |ref|``.  The bf16 output
    takes :func:`close_bf16`'s bound over ``vmax`` = max|V|.

    Per row (the last axis) and over the whole tensor, since an elementwise
    bound scaled by the largest value cannot see a fault confined to rows
    whose values are small (a causal row over n keys has |out| ~ n**-0.5):
    ``|err_row| <= row * |ref_row| + floor * mean_rows |ref_row|`` and
    ``|err| / |ref| <= rms``.  Readings of the sound kernels on the H100 over
    the phase's cases (tests/torch_flash_faults.py): bf16 outputs at most
    5.7e-3 per row and 2.3e-3 overall; bf16 gradients, whose rows can
    cancel to nearly nothing, at most 0.025 of the mean row per row and
    1.9e-4 overall (the wgmma arm and the dq forming delta included); f32
    below 7e-7 per row and 5e-6 of the mean row.  So
    bf16 takes ``row = 2**-6``, ``rms = 2**-7`` and for gradients ``floor =
    2**-4``; f32 takes ``row = rms = 1e-5`` and for gradients ``floor =
    1e-4``.  Half of one KV tile's P·V dropped in one head's last Q tile
    reads 0.26 per row at the main-path shapes and passes the elementwise
    bound alone."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    top = float(ref.abs().max())
    if dtype == torch.float32:
        ok = bool((err <= 1e-4 * top + 1e-4 * ref.abs()).all())
        row, floor, rms = 1e-5, (1e-4 if grad else 0.0), 1e-5
    elif grad:
        ok = bool((err <= 2 ** -7 * top + 2 ** -7 * ref.abs()).all())
        row, floor, rms = 2 ** -6, 2 ** -4, 2 ** -7
    else:
        ok = bool((err <= 2 ** -7 * vmax + 2 ** -8 * ref.abs()).all())
        row, floor, rms = 2 ** -6, 0.0, 2 ** -7
    ref_rows, err_rows = ref.norm(dim=-1), (out - ref).norm(dim=-1)
    rel = float((out - ref).norm() / ref.norm().clamp(min=1e-30))
    return dict(
        max_abs_err=float(err.max()), max_ref=top, elementwise_ok=ok,
        rows_ok=bool((err_rows <= row * ref_rows
                      + floor * float(ref_rows.mean())).all()),
        worst_row=float((err_rows / ref_rows.clamp(min=1e-30)).max()),
        worst_row_of_mean=float(err_rows.max() / ref_rows.mean()),
        rel_rms=rel, rms_ok=rel <= rms)


def flash_close(torch, out, ref, dtype, what: str, grad: bool = True,
                vmax: float = 0.0) -> float:
    """Max |out - ref|, raising unless :func:`flash_agreement` holds."""
    r = flash_agreement(torch, out, ref, dtype, grad, vmax)
    if not (r["elementwise_ok"] and r["rows_ok"] and r["rms_ok"]):
        raise AssertionError(f"{what} disagrees with its plain version: {r}")
    return r["max_abs_err"]


def flash_case_readings(torch, gen, case) -> dict:
    """One ``FLASH_CASES`` case on the card: the forward, dq and dk/dv
    kernels against their plain versions (:func:`flash_agreement` of out,
    dq, dk, dv; lse within ``1e-4 + 1e-5·|lse|``).  On the forward's wgmma
    arm also its ``out_f32`` output (the bf16 output's bound, on f32
    values).  On the backward's wgmma arm also the dq kernel that forms
    delta itself, with a random lse cotangent: its delta within
    ``DELTA_REL_MAX`` of the plain one, its dq against the plain dq, and bit
    for bit the explicit-delta arm's dq on its delta.  Every check's verdict
    is under ``ok``."""
    from tpudist_torch.ops.flash_attention import (
        _bwd_arm, _fwd_arm, flash_backward_dkv, flash_backward_dq,
        flash_backward_dq_delta, flash_backward_reference, flash_forward,
        flash_forward_reference)

    name, b, h, h_kv, s, d, dt, band = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                  .to(dtype) for shape in ((b, h, s, d), (b, h_kv, s, d),
                                           (b, h_kv, s, d), (b, h, s, d)))
    vmax = float(v.float().abs().max())
    out, lse = flash_forward(q, k, v, band)
    ref, rlse = flash_forward_reference(q, k, v, band)
    delta = (ref.float() * g.float()).sum(-1).contiguous()
    dq = flash_backward_dq(q, k, v, g, rlse, delta, band)
    dk, dv = flash_backward_dkv(q, k, v, g, rlse, delta, band)
    rq, rk, rv = flash_backward_reference(q, k, v, g, rlse, delta, band)
    torch.cuda.synchronize()
    res = dict(case=name, arm=_bwd_arm(q), fwd_arm=_fwd_arm(q), lse_ok=bool(
        ((lse - rlse).abs() <= 1e-4 + 1e-5 * rlse.abs()).all()))
    for t, a, r, grad in (("out", out, ref, False), ("dq", dq, rq, True),
                          ("dk", dk, rk, True), ("dv", dv, rv, True)):
        res[t] = flash_agreement(torch, a, r, dtype, grad, vmax)
    if res["fwd_arm"] == "wgmma":
        o32, l32 = flash_forward(q, k, v, band, out_f32=True)
        r32, _ = flash_forward_reference(q, k, v, band, out_f32=True)
        torch.cuda.synchronize()
        res["out_f32"] = flash_agreement(torch, o32, r32, dtype, False, vmax)
        res["lse_ok"] &= bool(
            ((l32 - rlse).abs() <= 1e-4 + 1e-5 * rlse.abs()).all())
    if res["arm"] == "wgmma":
        g_lse = torch.randn(b, h, s, generator=gen, device="cuda")
        fq, fdelta = flash_backward_dq_delta(q, k, v, g, rlse, ref, g_lse,
                                             band)
        pdelta = (ref.float() * g.float()).sum(-1) - g_lse
        mag = (ref.float() * g.float()).abs().sum(-1) + g_lse.abs()
        rq = flash_backward_reference(q, k, v, g, rlse, pdelta, band)[0]
        eq = flash_backward_dq(q, k, v, g, rlse, fdelta, band)
        torch.cuda.synchronize()
        res["delta_rel"] = float(((fdelta - pdelta).abs() / mag).max())
        res["dq_fold"] = flash_agreement(torch, fq, rq, dtype)
        res["fold_equals_explicit"] = bool(torch.equal(fq, eq))
    checks = [res["lse_ok"]] + [
        r["elementwise_ok"] and r["rows_ok"] and r["rms_ok"]
        for r in (res[t] for t in ("out", "out_f32", "dq", "dk", "dv",
                                   "dq_fold") if t in res)]
    if "delta_rel" in res:
        checks += [res["delta_rel"] <= DELTA_REL_MAX,
                   res["fold_equals_explicit"]]
    res["ok"] = all(checks)
    return res


def check_flash(torch, dev):
    """Phase 3b: forward, dq and dk/dv kernels against their plain versions
    on ``FLASH_CASES`` (:func:`flash_case_readings`), then timed at the
    training path's shapes beside the mma.sync arm the wgmma arm replaced
    and the folded delta beside the given one."""
    import torch.nn.functional as F

    from tpudist_torch import ops
    from tpudist_torch.ops.flash_attention import (
        FlashAttention, _launch_dkv, _launch_dq, _launch_fwd,
        band_live_pairs, flash_backward_dkv, flash_backward_dq,
        flash_backward_dq_delta, flash_backward_reference, flash_forward,
        flash_forward_reference)

    gen = torch.Generator(device=dev).manual_seed(4321)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16

    def inputs(b, h, h_kv, s, dtype, d=DH):
        def r(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)
        return (r(b, h, s, d), r(b, h_kv, s, d), r(b, h_kv, s, d),
                r(b, h, s, d))

    err = {"flash_forward": 0.0, "flash_backward_dq": 0.0,
           "flash_backward_dkv": 0.0}
    fold = dict(delta_rel=0.0, dq_max_abs_err=0.0, cases=0)
    for case in FLASH_CASES:
        r = flash_case_readings(torch, gen, case)
        if not r["ok"]:
            raise AssertionError(f"flash kernels disagree with their plain "
                                 f"versions ({case[0]}): {r}")
        err["flash_forward"] = max(err["flash_forward"],
                                   r["out"]["max_abs_err"])
        err["flash_backward_dq"] = max(err["flash_backward_dq"],
                                       r["dq"]["max_abs_err"],
                                       r.get("dq_fold", r["dq"])
                                       ["max_abs_err"])
        err["flash_backward_dkv"] = max(err["flash_backward_dkv"],
                                        r["dk"]["max_abs_err"],
                                        r["dv"]["max_abs_err"])
        if "delta_rel" in r:
            fold["delta_rel"] = max(fold["delta_rel"], r["delta_rel"])
            fold["dq_max_abs_err"] = max(fold["dq_max_abs_err"],
                                         r["dq_fold"]["max_abs_err"])
            fold["cases"] += 1
        log(f"flash {case[0]}: b {case[1]} h {case[2]}/{case[3]} s "
            f"{case[4]} dh {case[5]} {case[6]}, forward on the "
            f"{r['fwd_arm']} arm, backward on the {r['arm']} arm: agrees"
            + (f"; folded delta rel {r['delta_rel']:.2e}, dq equal to the "
               f"given-delta arm's" if "delta_rel" in r else ""))

    # timing at the main path's shapes (b 8, h 8, s 2048, dh 128, causal)
    b, h, s, band = 8, 8, 2048, (0, None)
    q, k, v, g = inputs(b, h, h, s, bf16)
    out, lse = flash_forward(q, k, v, band)
    # the forward's mma.sync arm, which the wgmma arm replaced at this
    # shape, held on the same inputs before it is timed beside it
    mout, mlse = _launch_fwd("mma", q, k, v, band)
    ref, rlse = flash_forward_reference(q, k, v, band)
    torch.cuda.synchronize()
    for o_, l_ in ((out, lse), (mout, mlse)):
        flash_close(torch, o_, ref, bf16, "the forward's arms", False,
                    float(v.float().abs().max()))
        if not bool(((l_ - rlse).abs() <= 1e-4 + 1e-5 * rlse.abs()).all()):
            raise AssertionError("the forward's lse disagrees with its "
                                 "plain version")
    del mout, mlse, ref, rlse
    delta = (out.float() * g.float()).sum(-1).contiguous()
    work = b * h * band_live_pairs(s, s, band)
    elt = q.numel()
    io = 4 * elt * 2  # q, k, v, do (or out) in bf16
    rows = b * h * s * 4  # one f32 per query row (lse, delta)

    def plain_dq_delta():
        dl = (out.float() * g.float()).sum(-1)
        return flash_backward_reference(q, k, v, g, lse, dl, band)[0], dl

    shapes = dict(
        flash_forward=(io + rows, 4 * work * DH,
                       lambda: flash_forward(q, k, v, band),
                       lambda: flash_forward_reference(q, k, v, band),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, is_causal=True),
                       "tpudist/ops/flash_attention.py:283",
                       "tpudist_torch/csrc/flash_attention.cu"),
        # the main path's dq: the kernel forms delta from out and do
        flash_backward_dq=(io + elt * 2 + 2 * rows + elt * 2,
                           6 * work * DH + 2 * elt,
                           lambda: flash_backward_dq_delta(
                               q, k, v, g, lse, out, None, band),
                           plain_dq_delta, None,
                           "tpudist/ops/flash_attention.py:622",
                           "tpudist_torch/csrc/flash_backward.cu"),
        flash_backward_dkv=(io + 2 * rows + 2 * elt * 2, 8 * work * DH,
                            lambda: flash_backward_dkv(q, k, v, g, lse,
                                                       delta, band),
                            lambda: flash_backward_reference(
                                q, k, v, g, lse, delta, band), None,
                            "tpudist/ops/flash_attention.py:669",
                            "tpudist_torch/csrc/flash_backward.cu"),
    )
    rec = {}
    for name, (nbytes, flops, kern, plain, lib, replaces, src) in \
            shapes.items():
        rec[name] = dict(
            route="cuda", source=src, replaces=replaces,
            max_abs_err=err[name], ms=time_ms(torch, kern, flush),
            plain_ms=time_ms(torch, plain, flush, n=5, warmup=1),
            library_ms=time_ms(torch, lib, flush) if lib else None,
            bound=bound(nbytes, flops, H100_BF16_FLOPS))
    # the same call: dq with a given delta, and the mma.sync arm that the
    # wgmma arm replaced at this shape, in turns (mma, wgmma, wgmma, mma)
    given_ms = time_ms(torch, lambda: flash_backward_dq(
        q, k, v, g, lse, delta, band), flush)
    arms = {"mma": [], "wgmma": []}
    for arm in ("mma", "wgmma", "wgmma", "mma"):
        arms[arm].append(dict(
            dq=time_ms(torch, lambda: _launch_dq(arm, q, k, v, g, lse, delta,
                                                 band), flush),
            dkv=time_ms(torch, lambda: _launch_dkv(arm, q, k, v, g, lse,
                                                   delta, band), flush)))
    fwd_arms = {"mma": [], "wgmma": []}
    for arm in ("mma", "wgmma", "wgmma", "mma"):
        fwd_arms[arm].append(time_ms(torch, lambda: _launch_fwd(
            arm, q, k, v, band), flush))
    rec["flash_forward"]["replaced_ms"] = fwd_arms["mma"]
    rec["flash_forward"]["arm_ms"] = fwd_arms["wgmma"]
    rec["flash_backward_dq"]["given_delta_ms"] = given_ms
    rec["flash_backward_dq"]["replaced_ms"] = [a["dq"] for a in arms["mma"]]
    rec["flash_backward_dkv"]["replaced_ms"] = [a["dkv"]
                                                for a in arms["mma"]]
    rec["flash_backward_dq"]["arm_ms"] = [a["dq"] for a in arms["wgmma"]]
    rec["flash_backward_dkv"]["arm_ms"] = [a["dkv"] for a in arms["wgmma"]]
    # forward + backward: FlashAttention (fwd, dq with delta, dk/dv)
    # against one scaled_dot_product_attention forward + backward
    qa, ka, va = (t.detach().requires_grad_(True) for t in (q, k, v))

    def ours():
        o, _ = FlashAttention.apply(qa, ka, va, True)
        o.backward(g)

    def sdpa():
        o = F.scaled_dot_product_attention(qa, ka, va, is_causal=True)
        o.backward(g)

    # the backward alone (dq forming delta, dk/dv against SDPA's backward),
    # over one forward graph kept alive between the timed calls
    o_ours, _ = FlashAttention.apply(qa, ka, va, True)
    o_sdpa = F.scaled_dot_product_attention(qa, ka, va, is_causal=True)
    fwd_bwd = dict(ms=time_ms(torch, ours, flush),
                   library_ms=time_ms(torch, sdpa, flush),
                   bwd_ms=time_ms(torch, lambda: torch.autograd.grad(
                       o_ours, (qa, ka, va), g, retain_graph=True), flush),
                   library_bwd_ms=time_ms(torch, lambda: torch.autograd.grad(
                       o_sdpa, (qa, ka, va), g, retain_graph=True), flush),
                   bound_ms=bound(io + 2 * rows + 3 * elt * 2,
                                  18 * work * DH, H100_BF16_FLOPS)[0],
                   folded_delta=fold)
    for name, r in rec.items():
        log(f"kernel {name}: max_abs_err {r['max_abs_err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']} ms, bound {r['bound'][0]:.5f} ms by "
            f"{r['bound'][1]})")
    dq_r, dkv_r = rec["flash_backward_dq"], rec["flash_backward_dkv"]
    fw = rec["flash_forward"]
    log(f"flash forward arms, same call (mma, wgmma, wgmma, mma): "
        f"{fw['replaced_ms'][0]:.4f}, {fw['arm_ms'][0]:.4f}, "
        f"{fw['arm_ms'][1]:.4f}, {fw['replaced_ms'][1]:.4f} ms; wgmma / "
        f"mma.sync {sum(fw['arm_ms']) / sum(fw['replaced_ms']):.3f}; SDPA "
        f"causal forward {fw['library_ms']:.4f} ms")
    log(f"flash backward arms, same call (mma, wgmma, wgmma, mma): dq "
        f"{dq_r['replaced_ms'][0]:.4f}, {dq_r['arm_ms'][0]:.4f}, "
        f"{dq_r['arm_ms'][1]:.4f}, {dq_r['replaced_ms'][1]:.4f} ms; dk/dv "
        f"{dkv_r['replaced_ms'][0]:.4f}, {dkv_r['arm_ms'][0]:.4f}, "
        f"{dkv_r['arm_ms'][1]:.4f}, {dkv_r['replaced_ms'][1]:.4f} ms; the "
        f"wgmma dq forming delta {dq_r['ms']:.4f} ms, given delta "
        f"{dq_r['given_delta_ms']:.4f} ms; folded delta over "
        f"{fold['cases']} cases: rel {fold['delta_rel']:.2e} <= "
        f"{DELTA_REL_MAX}")
    log(f"flash fwd+bwd (FlashAttention): {fwd_bwd['ms']:.4f} ms, SDPA "
        f"fwd+bwd {fwd_bwd['library_ms']:.4f} ms, bound "
        f"{fwd_bwd['bound_ms']:.5f} ms; backward alone "
        f"{fwd_bwd['bwd_ms']:.4f} ms, SDPA backward "
        f"{fwd_bwd['library_bwd_ms']:.4f} ms")
    del q, k, v, g, qa, ka, va, o_ours, o_sdpa
    for case in FLASH_TIMED:
        timed = flash_head_dim_timings(torch, gen, flush, case)
        for name, r in timed.items():
            rec[name].setdefault("head_dims", {})[case[0]] = r
    del flush
    ops.reset_launch_counts()
    return rec, fwd_bwd


def flash_head_dim_timings(torch, gen, flush, case) -> dict:
    """One ``FLASH_TIMED`` shape (bf16, causal): the forward, dq (given
    delta) and dk/dv kernels on the arm the plan picks, each timed as phase
    3 times it beside its plain version and its bound; the yardsticks are
    ``scaled_dot_product_attention(is_causal=True)``'s forward (beside the
    forward) and its backward alone (dq, dk and dv together, beside both
    backward kernels), over K/V expanded to every q head outside the timed
    call.  ``{kernel: {ms, plain_ms, library_ms, bound, arm}}``."""
    import torch.nn.functional as F

    from tpudist_torch.ops.flash_attention import (
        _bwd_arm, band_live_pairs, flash_backward_dkv, flash_backward_dq,
        flash_backward_reference, flash_forward, flash_forward_reference)

    name, b, h, h_kv, s, d = case
    band = (0, None)
    q, g = (torch.randn(b, h, s, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    k, v = (torch.randn(b, h_kv, s, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    out, lse = flash_forward(q, k, v, band)
    delta = (out.float() * g.float()).sum(-1).contiguous()
    work = b * h * band_live_pairs(s, s, band)
    qb, kvb, rows = q.numel() * 2, k.numel() * 2, b * h * s * 4
    ke, ve = (t.repeat_interleave(h // h_kv, dim=1).requires_grad_(True)
              for t in (k, v))
    qa = q.detach().requires_grad_(True)
    o_sdpa = F.scaled_dot_product_attention(qa, ke, ve, is_causal=True)
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_sdpa, (qa, ke, ve), g, retain_graph=True), flush)
    res = {}
    for kname, kern, plain, nbytes, flops, lib in (
            ("flash_forward", lambda: flash_forward(q, k, v, band),
             lambda: flash_forward_reference(q, k, v, band),
             2 * qb + 2 * kvb + rows, 4 * work * d,
             time_ms(torch, lambda: F.scaled_dot_product_attention(
                 q, ke, ve, is_causal=True), flush)),
            ("flash_backward_dq", lambda: flash_backward_dq(
                q, k, v, g, lse, delta, band),
             lambda: flash_backward_reference(q, k, v, g, lse, delta, band),
             3 * qb + 2 * kvb + 2 * rows, 6 * work * d, sdpa_bwd),
            ("flash_backward_dkv", lambda: flash_backward_dkv(
                q, k, v, g, lse, delta, band),
             lambda: flash_backward_reference(q, k, v, g, lse, delta, band),
             2 * qb + 4 * kvb + 2 * rows, 8 * work * d, sdpa_bwd)):
        res[kname] = dict(
            arm=_bwd_arm(q), ms=time_ms(torch, kern, flush),
            plain_ms=time_ms(torch, plain, flush, n=3, warmup=1),
            library_ms=lib, bound=bound(nbytes, flops, H100_BF16_FLOPS))
        r = res[kname]
        log(f"kernel {kname} at {name} (b {b} h {h}/{h_kv} s {s}, causal, "
            f"{r['arm']} arm): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
            f"ms, SDPA {'backward' if 'backward' in kname else 'forward'} "
            f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms by "
            f"{r['bound'][1]})")
    return res


# ---------------------------------------------------------------------------
# phase 3c: the fused RoPE+QKV and LoRA gather-matmul kernels


def linear_agreement(torch, out, ref, dtype: str) -> dict:
    """How a fused linear kernel's output agrees with its plain version:
    elementwise against ``|ref|`` plus the largest ``|ref|`` of its row (a
    rotated pair mixes two values of a row), per row (the last axis) and
    over the whole tensor, against ``LINEAR_BOUNDS[dtype]``."""
    out, ref = out.float(), ref.float()
    diff = out - ref
    scale = ref.abs() + ref.abs().amax(dim=-1, keepdim=True)
    elem, row, rms = LINEAR_BOUNDS[dtype]
    r = dict(
        max_abs_err=float(diff.abs().max()),
        worst_elem=float((diff.abs() / scale.clamp(min=1e-30)).max()),
        worst_row=float((diff.norm(dim=-1)
                         / ref.norm(dim=-1).clamp(min=1e-30)).max()),
        rel_rms=float(diff.norm() / ref.norm().clamp(min=1e-30)))
    r["ok"] = (r["worst_elem"] <= elem and r["worst_row"] <= row
               and r["rel_rms"] <= rms)
    return r


def linear_close(torch, out, ref, dtype: str, what: str) -> dict:
    r = linear_agreement(torch, out, ref, dtype)
    if not r["ok"]:
        raise AssertionError(f"{what} disagrees with its plain version: {r}")
    return r


def qkv_inputs(torch, dev, gen, S, T, nh, n_kv, dh, dtype, offs,
               extra=True, on_bool=False, d=None):
    """``fused_rope_qkv`` arguments: h, the qkv weight as the port stores it
    (``[dtot, d]``, passed as its transposed view), offsets, the delta and
    the lane mask; the depth ``d`` is ``nh · dh`` unless given."""
    d, dtot = nh * dh if d is None else d, (nh + 2 * n_kv) * dh

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    on = torch.tensor((LANE_ON * S)[:S], device=dev,
                      dtype=torch.bool if on_bool else torch.int32)
    return (r(S, T, d), r(dtot, d, scale=d ** -0.5).t(),
            torch.tensor(offs, dtype=torch.int32, device=dev),
            r(S, T, dtot, scale=0.1) if extra else None,
            on if extra else None)


def lora_inputs(torch, dev, gen, S, T, d_in, d_out, dtype, rank, ids,
                blocks=8):
    """``lora_delta`` arguments over an ``[LAYERS, blocks, ...]`` pool
    (factors scaled as ``make_adapter_factors`` scales them)."""
    x = torch.randn(S, T, d_in, generator=gen, device=dev).to(dtype)
    a = torch.randn(LAYERS, blocks, d_in, rank, generator=gen,
                    device=dev) * d_in ** -0.5
    b = torch.randn(LAYERS, blocks, rank, d_out, generator=gen,
                    device=dev) * 0.05
    return x, a, b, torch.tensor(ids, dtype=torch.int32, device=dev)


def unfused_qkv(torch, h, w, offsets, extra, on, nh, n_kv, dh):
    """The chain ``fused_rope=False`` runs for one layer: ``F.linear``, the
    adapter select, the head split and two ``rope_rotate``."""
    import torch.nn.functional as F

    from tpudist_torch.models.transformer import rope_rotate

    S, T, _ = h.shape
    qkv = F.linear(h, w.t())
    if extra is not None:
        qkv = torch.where(on[:, None, None] != 0, qkv + extra, qkv)
    q = qkv[..., :nh * dh].reshape(S, T, nh, dh).transpose(1, 2)
    k = qkv[..., nh * dh:(nh + n_kv) * dh].reshape(S, T, n_kv,
                                                   dh).transpose(1, 2)
    v = qkv[..., (nh + n_kv) * dh:].reshape(S, T, n_kv, dh).transpose(1, 2)
    return rope_rotate(q, offset=offsets), rope_rotate(k, offset=offsets), v


def check_fused_linear(torch, dev):
    """Phase 3c: both kernels against their plain versions at the main
    path's shapes (decode T 1, the verify's T 5, prefill T 64, 8 slots, d
    1024, rank 8), a GQA case, a rope-off ragged case and f32 cases, each
    ``fused_rope_qkv`` case on the arm ``_rope_arm`` picks and the bf16
    ones also on the mma.sync arm; then timed as in phase 3:
    ``fused_rope_qkv``'s split and wgmma arms beside the mma.sync arm they
    replaced and ``lora_delta``'s cluster arm beside the staged arm, on the
    same inputs, in turns; ``F.linear`` of the qkv product alone; an empty
    kernel (the timer's floor for a tiny launch and for the split arm's
    grid); and the card's ``cudaOccupancyMaxActiveClusters`` for both
    cluster arms."""
    import torch.nn.functional as F

    from tpudist_torch import ops
    from tpudist_torch.ops.fused_linear import (LORA_DECODE_ROWS,
                                                ROPE_SPLIT_COLS,
                                                ROPE_SPLIT_KS, _launch_empty,
                                                _launch_lora, _launch_rope,
                                                _lora_arm, _rope_arm,
                                                fused_rope_qkv,
                                                fused_rope_qkv_reference,
                                                lora_delta,
                                                lora_delta_reference,
                                                lora_max_active_clusters,
                                                rope_max_active_clusters)

    gen = torch.Generator(device=dev).manual_seed(5678)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    readings = {}
    # (name, S, T, nh, n_kv, dh, dtype, rope, extra, offsets)
    qkv_cases = (
        ("decode", SLOTS, 1, HEADS, HEADS, DH, bf16, True, True,
         DECODE_OFFS),
        ("prefill", SLOTS, P, HEADS, HEADS, DH, bf16, True, True,
         PREFILL_OFFS),
        ("GQA n_kv 2, T 16", SLOTS, 16, HEADS, 2, DH, bf16, True, True,
         DECODE_OFFS),
        ("rope off, ragged T 37, dh 64", 3, 37, 4, 4, 64, bf16, False,
         False, [0, 5, 9]),
        ("f32 GQA, bool mask", 5, 9, 4, 2, 64, f32, True, True,
         [0, 3, 11, 100, 2000]))
    worst = {"fused_rope_qkv": 0.0, "lora_delta": 0.0}

    def hold_qkv(name, S, T, nh, n_kv, dh, dtype, rope, extra, offs, g,
                 on_bool, d=None):
        dt = "bf16" if dtype == bf16 else "f32"
        args = qkv_inputs(torch, dev, g, S, T, nh, n_kv, dh, dtype, offs,
                          extra, on_bool=on_bool, d=d)
        kw = dict(n_heads=nh, n_kv=n_kv, dh=dh, rope=rope)
        ref = fused_rope_qkv_reference(*args, **kw)
        arm = _rope_arm(S * T, dh, args[0].shape[-1], dtype)
        ops.reset_launch_counts()
        outs = {arm: fused_rope_qkv(*args, **kw)}
        ran = {a: getattr(fused_rope_qkv, f"launches_{a}")
               for a in ("split", "wgmma")}
        if ran.get(arm, 1) != 1 or sum(ran.values()) != (arm in ran):
            raise AssertionError(f"fused_rope_qkv {name}: launched {ran}, "
                                 f"the plan says {arm}")
        if dtype == bf16 and arm != "mma":  # the arm the new ones replaced
            outs["mma"] = _launch_rope("mma", *args, **kw)
        torch.cuda.synchronize()
        for a, out in outs.items():
            for part, x, y in zip("qkv", out, ref):
                key = f"fused_rope_qkv {name} {part}" + (
                    " (mma arm)" if a != arm else "")
                r = linear_close(torch, x, y, dt, key)
                readings[key] = r
                worst["fused_rope_qkv"] = max(worst["fused_rope_qkv"],
                                              r["max_abs_err"])
        log(f"fused_rope_qkv {name}: agrees on the {arm} arm"
            + (" and the mma arm" if len(outs) > 1 else ""))

    for name, S, T, nh, n_kv, dh, dtype, rope, extra, offs in qkv_cases:
        hold_qkv(name, S, T, nh, n_kv, dh, dtype, rope, extra, offs, gen,
                 dtype == f32)
    # (name, S, T, d_in, d_out, dtype, rank, ids)
    # (the cases added later come last, so the earlier ones keep the draws
    # of the generator they were read against)
    lora_cases = (
        ("qkv decode", SLOTS, 1, 1024, 3072, bf16, RANK, LORA_IDS),
        ("wi decode", SLOTS, 1, 1024, 4096, bf16, RANK, LORA_IDS),
        ("wo prefill", SLOTS, P, 4096, 1024, bf16, RANK, LORA_IDS),
        ("qkv prefill", SLOTS, P, 1024, 3072, bf16, RANK, LORA_IDS),
        ("f32 rank 2, ragged", 3, 37, 256, 200, f32, 2, [1, 8, 7]),
        ("rank 64, sentinel only", 2, 5, 512, 300, bf16, 64, [8, 8]),
        ("wo decode", SLOTS, 1, 4096, 1024, bf16, RANK, LORA_IDS),
        ("wi verify", SLOTS, SPEC_K + 1, 1024, 4096, bf16, RANK, LORA_IDS))
    for name, S, T, d_in, d_out, dtype, rank, ids in lora_cases:
        dt = "bf16" if dtype == bf16 else "f32"
        args = lora_inputs(torch, dev, gen, S, T, d_in, d_out, dtype, rank,
                           ids)
        for layer in (0, LAYERS - 1):
            out = lora_delta(*args, layer=layer)
            ref = lora_delta_reference(*args, layer=layer)
            torch.cuda.synchronize()
            r = linear_close(torch, out, ref, dt,
                             f"lora_delta {name} layer {layer}")
            readings[f"lora_delta {name} layer {layer}"] = r
            worst["lora_delta"] = max(worst["lora_delta"], r["max_abs_err"])
        log(f"lora_delta {name}: agrees")

    # the split and wgmma arms' own edges, on a generator of their own (the
    # cases above keep the draws they were read against): the verify's T
    # 5, a ragged S 3 x T 5 under GQA with a bool mask, the split arm's
    # last row count (64) and the wgmma arm's first (65, a row tile cut
    # mid-slot) at head dim 64
    gen2 = torch.Generator(device=dev).manual_seed(5679)
    for name, S, T, nh, n_kv, dh, rope, extra, offs, on_bool in (
            ("verify T 5", SLOTS, SPEC_K + 1, HEADS, HEADS, DH, True, True,
             DECODE_OFFS, False),
            ("split GQA 8/2, S 3 x T 5", 3, 5, HEADS, 2, DH, True, True,
             [7, 1999, 64], True),
            ("split 64 rows, rope off", 4, 16, HEADS, 2, DH, False, True,
             [0, 3, 5, 9], False),
            ("wgmma 65 rows, dh 64", 5, 13, 16, 4, 64, True, True,
             [0, 100, 1000, 5, 17], False)):
        hold_qkv(name, S, T, nh, n_kv, dh, bf16, rope, extra, offs, gen2,
                 on_bool)

    # every head dim, depth and rank, on a generator of their own
    gen3 = torch.Generator(device=dev).manual_seed(5680)
    for (name, S, T, nh, n_kv, dh, d, dt, rope, extra,
         offs) in QKV_WIDE_CASES:
        hold_qkv(name, S, T, nh, n_kv, dh, bf16 if dt == "bf16" else f32,
                 rope, extra, offs, gen3, dt == "f32", d=d)
    for name, S, T, d_in, d_out, dt, rank, ids in LORA_RANK_CASES:
        args = lora_inputs(torch, dev, gen3, S, T, d_in, d_out,
                           bf16 if dt == "bf16" else f32, rank, ids)
        arms = ["planned"] + (["staged"] if T <= LORA_DECODE_ROWS else [])
        for layer in (0, LAYERS - 1):
            ref = lora_delta_reference(*args, layer=layer)
            for arm in arms:
                out = (lora_delta(*args, layer=layer) if arm == "planned"
                       else _launch_lora(arm, *args, layer))
                torch.cuda.synchronize()
                key = f"lora_delta {name} layer {layer} ({arm} arm)"
                r = linear_close(torch, out, ref, dt, key)
                readings[key] = r
                worst["lora_delta"] = max(worst["lora_delta"],
                                          r["max_abs_err"])
        log(f"lora_delta {name}: agrees on the {' and '.join(arms)} arm")

    for kname in ADAPTER_KERNELS:
        rs = [r for k, r in readings.items() if k.startswith(kname)]
        log(f"{kname} readings, worst over {len(rs)} outputs: "
            + ", ".join(f"{m} {max(r[m] for r in rs):.3g}"
                        for m in ("worst_elem", "worst_row", "rel_rms")))
    rec, timings = {}, {}
    d, dtot = HEADS * DH, 3 * HEADS * DH
    for label, T, offs in (("decode", 1, DECODE_OFFS),
                           ("prefill", P, PREFILL_OFFS),
                           ("verify", SPEC_K + 1, DECODE_OFFS)):
        args = qkv_inputs(torch, dev, gen, SLOTS, T, HEADS, HEADS, DH, bf16,
                          offs)
        kw = dict(n_heads=HEADS, n_kv=HEADS, dh=DH)
        rows = SLOTS * T
        nbytes = 2 * (d * dtot + rows * d + 2 * rows * dtot) + SLOTS * 8
        t = timings[f"fused_rope_qkv {label}"] = dict(
            ms=time_ms(torch, lambda: fused_rope_qkv(*args, **kw), flush),
            host_ms=time_ms(torch, lambda: fused_rope_qkv(*args, **kw),
                            flush, spin=False),
            plain_ms=time_ms(torch, lambda: fused_rope_qkv_reference(
                *args, **kw), flush),
            unfused_ms=time_ms(torch, lambda: unfused_qkv(
                torch, *args, HEADS, HEADS, DH), flush),
            bound=bound(nbytes, 2 * rows * d * dtot, H100_BF16_FLOPS))
        # the product alone through one PyTorch call: a yardstick for the
        # product, not for the function (no single call adds the delta and
        # rotates)
        wt = args[1].t()
        t["linear_ms"] = time_ms(torch, lambda: F.linear(args[0], wt), flush)
        # the new arm and the mma.sync arm it replaced, in turns
        arm = _rope_arm(rows, DH, d, bf16)
        t["arm"], t["arm_ms"] = arm, {"mma": [], arm: []}
        for a in ("mma", arm, arm, "mma"):
            t["arm_ms"][a].append(time_ms(torch, lambda: _launch_rope(
                a, *args, **kw), flush))
    # the timer's floor: an empty kernel of one CTA, and one of the split
    # arm's grid at decode (clusters of ROPE_SPLIT_KS CTAs)
    split_ctas = ROPE_SPLIT_KS * dtot // ROPE_SPLIT_COLS
    floor = dict(one_cta=time_ms(torch, lambda: _launch_empty(1), flush),
                 split_grid=time_ms(torch, lambda: _launch_empty(
                     split_ctas, True), flush), split_ctas=split_ctas)
    log(f"timer floor (time_ms of an empty kernel): one CTA "
        f"{floor['one_cta']:.4f} ms, {split_ctas} CTAs in clusters of "
        f"{ROPE_SPLIT_KS} {floor['split_grid']:.4f} ms")
    for label, T, d_in, d_out in (("qkv decode", 1, 1024, 3072),
                                  ("wi decode", 1, 1024, 4096),
                                  ("wo decode", 1, 4096, 1024),
                                  ("wi verify", SPEC_K + 1, 1024, 4096),
                                  ("wi prefill", P, 1024, 4096)):
        args = lora_inputs(torch, dev, gen, SLOTS, T, d_in, d_out, bf16,
                           RANK, LORA_IDS)
        blocks = len({min(i, 7) for i in LORA_IDS})
        rows = SLOTS * T
        nbytes = (2 * rows * (d_in + d_out) + SLOTS * 4
                  + blocks * RANK * (d_in + d_out) * 4)
        t = timings[f"lora_delta {label}"] = dict(
            ms=time_ms(torch, lambda: lora_delta(*args, layer=3), flush),
            host_ms=time_ms(torch, lambda: lora_delta(*args, layer=3),
                            flush, spin=False),
            plain_ms=time_ms(torch, lambda: lora_delta_reference(
                *args, layer=3), flush),
            bound=bound(nbytes, 2 * rows * RANK * (d_in + d_out),
                        H100_BF16_FLOPS))
        if T <= LORA_DECODE_ROWS:  # the staged arm it replaced, in turns
            arm_ms = {"cluster": [], "staged": []}
            for arm in ("staged", "cluster", "cluster", "staged"):
                arm_ms[arm].append(time_ms(torch, lambda: _launch_lora(
                    arm, *args, 3), flush))
            t["arm_ms"] = arm_ms
    # the public models' widths and the new ranks: each on the arm its plan
    # picks, beside its plain version, its bound and (fused_rope_qkv)
    # F.linear of the product alone; a new arm beside the mma.sync arm, the
    # cluster arm beside the staged arm, in turns
    wide = {}
    for label, T, dm, nh, n_kv, dh in QKV_WIDE_SHAPES:
        offs = DECODE_OFFS if T <= SPEC_K + 1 else PREFILL_OFFS
        args = qkv_inputs(torch, dev, gen3, SLOTS, T, nh, n_kv, dh, bf16,
                          offs, d=dm)
        kw = dict(n_heads=nh, n_kv=n_kv, dh=dh)
        rows, dt = SLOTS * T, (nh + 2 * n_kv) * dh
        nbytes = 2 * (dm * dt + rows * dm + 2 * rows * dt) + SLOTS * 8
        wt = args[1].t()
        arm = _rope_arm(rows, dh, dm, bf16)
        t = wide[f"fused_rope_qkv {label}"] = dict(
            arm=arm, head_dim=dh, d_model=dm,
            ms=time_ms(torch, lambda: fused_rope_qkv(*args, **kw), flush),
            plain_ms=time_ms(torch, lambda: fused_rope_qkv_reference(
                *args, **kw), flush),
            linear_ms=time_ms(torch, lambda: F.linear(args[0], wt), flush),
            bound=bound(nbytes, 2 * rows * dm * dt, H100_BF16_FLOPS))
        if arm != "mma":
            t["arm_ms"] = {"mma": [], arm: []}
            for a in ("mma", arm, arm, "mma"):
                t["arm_ms"][a].append(time_ms(torch, lambda: _launch_rope(
                    a, *args, **kw), flush))
    for label, T, d_in, d_out, rank in LORA_RANK_SHAPES:
        args = lora_inputs(torch, dev, gen3, SLOTS, T, d_in, d_out, bf16,
                           rank, LORA_IDS)
        blocks = len({min(i, 7) for i in LORA_IDS})
        rows = SLOTS * T
        nbytes = (2 * rows * (d_in + d_out) + SLOTS * 4
                  + blocks * rank * (d_in + d_out) * 4)
        t = wide[f"lora_delta {label}"] = dict(
            rank=rank, arm=_lora_arm(T, rank),
            ms=time_ms(torch, lambda: lora_delta(*args, layer=3), flush),
            plain_ms=time_ms(torch, lambda: lora_delta_reference(
                *args, layer=3), flush),
            bound=bound(nbytes, 2 * rows * rank * (d_in + d_out),
                        H100_BF16_FLOPS))
        if t["arm"] == "cluster":
            t["arm_ms"] = {"cluster": [], "staged": []}
            for arm in ("staged", "cluster", "cluster", "staged"):
                t["arm_ms"][arm].append(time_ms(torch, lambda: _launch_lora(
                    arm, *args, 3), flush))
    for name, t in wide.items():
        log(f"kernel {name} ({t['arm']} arm): {t['ms']:.4f} ms (plain "
            f"{t['plain_ms']:.4f} ms"
            + (f", F.linear of the product alone {t['linear_ms']:.4f} ms"
               if "linear_ms" in t else "")
            + (f"; arms in turns {t['arm_ms']}" if "arm_ms" in t else "")
            + f", bound {t['bound'][0]:.5f} ms by {t['bound'][1]})")
    clusters = lora_max_active_clusters(SLOTS)
    log(f"lora_delta cluster arm: at most {clusters} clusters of 8 CTAs "
        f"resident at once (cudaOccupancyMaxActiveClusters; {SLOTS} a "
        f"call)")
    rope_clusters = {rows: rope_max_active_clusters(rows, d, dtot)
                     for rows in (SLOTS, SLOTS * (SPEC_K + 1))}
    log(f"fused_rope_qkv split arm: at most {rope_clusters} clusters of "
        f"{ROPE_SPLIT_KS} CTAs resident at once by rows "
        f"(cudaOccupancyMaxActiveClusters; {dtot // ROPE_SPLIT_COLS} a "
        f"call)")
    for name, t in timings.items():
        log(f"kernel {name}: {t['ms']:.4f} ms (with host launch "
            f"{t['host_ms']:.4f} ms; plain {t['plain_ms']:.4f} "
            f"ms" + (f", unfused chain {t['unfused_ms']:.4f} ms"
                     if "unfused_ms" in t else "")
            + (f", F.linear of the product alone {t['linear_ms']:.4f} ms"
               if "linear_ms" in t else "")
            + (f"; arms in turns {t['arm_ms']}" if "arm_ms" in t else "")
            + f", bound {t['bound'][0]:.5f} ms by {t['bound'][1]})")
    for name, src, replaces, key in (
            ("fused_rope_qkv", "tpudist_torch/csrc/fused_rope_qkv.cu",
             "tpudist/ops/fused_linear.py:86", "fused_rope_qkv decode"),
            ("lora_delta", "tpudist_torch/csrc/lora_delta.cu",
             "tpudist/ops/fused_linear.py:214", "lora_delta wi decode")):
        t = timings[key]
        rec[name] = dict(route="cuda", source=src, replaces=replaces,
                         max_abs_err=worst[name], ms=t["ms"],
                         plain_ms=t["plain_ms"], library_ms=None,
                         bound=t["bound"])
    rec["lora_delta"]["arm_ms"] = timings["lora_delta wi decode"]["arm_ms"]
    # each arm at its own main-path shape: split and the mma.sync arm at
    # decode, wgmma at prefill
    dec, pre = (timings[f"fused_rope_qkv {k}"] for k in ("decode", "prefill"))
    rec["fused_rope_qkv"]["arm_ms"] = {
        "split": dec["arm_ms"]["split"], "mma": dec["arm_ms"]["mma"],
        "wgmma": pre["arm_ms"]["wgmma"]}
    for name in ADAPTER_KERNELS:
        rec[name]["shapes"] = {k[len(name) + 1:]: t for k, t in wide.items()
                               if k.startswith(name)}
    del flush
    ops.reset_launch_counts()
    return rec, dict(timings=timings, shapes=wide, readings=readings,
                     lora_max_active_clusters=clusters,
                     rope_max_active_clusters=rope_clusters,
                     timer_floor_ms=floor)


# ---------------------------------------------------------------------------
# phase 3e: the fused toy-MLP kernel against its plain version


def mlp_weights(torch, kind, dev):
    """``toy``: the toy model's own weights (``create_toy_model(0)``, the
    bench's); ``wide``: five 128-wide layers from a numpy seed, the widest
    shape the JAX kernel takes; a tuple of widths: layers of those widths
    from a numpy seed (the CUDA tests' edge cases)."""
    import numpy as np

    from tpudist_torch.models import create_toy_model

    if kind == "toy":
        return [(w.detach(), b.detach())
                for w, b in create_toy_model(0, device=dev).layers()]
    widths = (128,) * 6 if kind == "wide" else tuple(kind)
    r = np.random.default_rng(3 if kind == "wide" else len(widths))
    return [(torch.from_numpy(r.normal(scale=a ** -0.5, size=(a, b))
                              .astype(np.float32)).to(dev),
             torch.from_numpy(r.normal(scale=0.1, size=b)
                              .astype(np.float32)).to(dev))
            for a, b in zip(widths[:-1], widths[1:])]


def mlp_inputs(torch, kind, batch: int, dev):
    import numpy as np

    weights = mlp_weights(torch, kind, dev)
    x = np.random.default_rng(batch).standard_normal(
        (batch, weights[0][0].shape[0])).astype(np.float32)
    return weights, torch.from_numpy(x).to(dev)


def mlp_agreement(torch, out, ref, weights, x) -> dict:
    """The kernel's output against its plain version and against a float64
    numpy forward, each as the largest difference over the float64
    output's largest magnitude; held to ``MLP_PLAIN_REL`` and
    ``MLP_F64_REL``."""
    import numpy as np

    from tpudist_torch.bench import f64_forward

    r64 = f64_forward(x.cpu().numpy(), [(w.cpu().numpy(), b.cpu().numpy())
                                        for w, b in weights])
    scale = max(float(np.abs(r64).max()), 1e-6)
    o, p = out.cpu().numpy(), ref.cpu().numpy()
    res = dict(max_abs_err=float(np.abs(o - p).max()),
               rel_vs_plain=float(np.abs(o - p).max() / scale),
               rel_vs_f64=float(np.abs(o - r64).max() / scale),
               plain_rel_vs_f64=float(np.abs(p - r64).max() / scale))
    if not (np.isfinite(o).all() and res["rel_vs_plain"] <= MLP_PLAIN_REL
            and res["rel_vs_f64"] <= MLP_F64_REL):
        raise AssertionError(f"fused_mlp disagrees: {res}")
    return res


def mlp_bound(widths, batch: int):
    """Bytes: x and the output once each, the weights once; operations:
    the multiply-adds, 2 a weight a row (bias adds and activations left
    out)."""
    pairs = list(zip(widths[:-1], widths[1:]))
    nbytes = 4 * (batch * (widths[0] + widths[-1])
                  + sum(a * b + b for a, b in pairs))
    flops = 2 * batch * sum(a * b for a, b in pairs)
    return bound(nbytes, flops, H100_F32_FLOPS)


def check_fused_mlp(torch, dev):
    """Phase 3e: the fused MLP kernel against its plain version at
    ``MLP_CASES`` (:func:`mlp_agreement`), each timed as in phase 3 beside
    its bound and the plain chain; the kernels line takes the bench's batch
    4096."""
    import dataclasses

    from tpudist_torch import ops
    from tpudist_torch.ops.fused_mlp import (_mlp_plan, fused_mlp,
                                             mlp_reference, pack_params)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cases, err = {}, 0.0
    with torch.no_grad():
        for name, kind, batch in MLP_CASES:
            weights, x = mlp_inputs(torch, kind, batch, dev)
            packed = pack_params(weights)
            out = fused_mlp(x, packed)
            ref = mlp_reference(x, weights)
            torch.cuda.synchronize()
            agree = mlp_agreement(torch, out, ref, weights, x)
            err = max(err, agree["max_abs_err"])
            cases[name] = dict(
                agree, batch=batch, widths=list(packed.widths),
                plan=dataclasses.asdict(_mlp_plan(packed.widths, batch)),
                ms=time_ms(torch, lambda: fused_mlp(x, packed), flush),
                host_ms=time_ms(torch, lambda: fused_mlp(x, packed), flush,
                                spin=False),
                plain_ms=time_ms(torch, lambda: mlp_reference(x, weights),
                                 flush),
                bound=mlp_bound(packed.widths, batch))
            c = cases[name]
            log(f"kernel fused_mlp {name}: {c['ms']:.4f} ms (with host "
                f"launch {c['host_ms']:.4f} ms; {c['plan']['arm']} arm, "
                f"{c['plan']['rows']} rows a thread, "
                f"{c['plan']['rows_per_cta']} a tile, {c['plan']['blocks']} "
                f"tiles; plain "
                f"{c['plain_ms']:.4f} ms, bound {c['bound'][0]:.7f} ms by "
                f"{c['bound'][1]}); vs plain {c['rel_vs_plain']:.2e}, vs "
                f"f64 {c['rel_vs_f64']:.2e} (plain vs f64 "
                f"{c['plain_rel_vs_f64']:.2e})")
    main = cases["toy b4096"]
    rec = dict(route="cuda", source="tpudist_torch/csrc/fused_mlp.cu",
               replaces="tpudist/ops/fused_mlp.py:64", max_abs_err=err,
               ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
               bound=main["bound"])
    del flush
    ops.reset_launch_counts()
    return {"fused_mlp": rec}, cases


# ---------------------------------------------------------------------------
# phase 4: the main path; phase 5: prompt logits on the card vs the CPU


def phase4_run(torch, model, gen_seed: int, probe=None):
    """Phase 4's serving run: a new server, a warm-up request, then 16
    requests timed from their submits (launch counts zeroed just before);
    ``probe(server)`` reads what the caller needs before the server
    closes.  Every request must finish ``"length"``.  Returns the handles,
    the requests, the wall, the probe's result and the engine's decode
    counters after the warm-up."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.serve import InferenceServer, ServeConfig

    cfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                      prefill_pad=P, decode_block=8, kv_block=BS)
    server = InferenceServer(model, cfg, device="cuda").start()
    rng = np.random.default_rng(gen_seed)
    try:
        warm = server.submit(rng.integers(0, V, size=70), max_new=9)
        if not warm.wait(600) or warm.finish_reason != "length":
            raise AssertionError("warm-up request did not finish")
        torch.cuda.synchronize()
        warm_decode = dict(server.engine.decode_stats())
        reqs = [(rng.integers(0, V, size=int(rng.integers(1, 301))),
                 int(rng.integers(16, 65))) for _ in range(16)]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [server.submit(p, max_new=n) for p, n in reqs]
        for h in handles:
            if not h.wait(900):
                raise AssertionError("request timed out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        probed = probe(server) if probe is not None else None
    finally:
        server.close(60)
    for h, (_, n) in zip(handles, reqs):
        if h.finish_reason != "length" or len(h.tokens) != n:
            raise AssertionError(f"request {h.id}: {h.finish_reason}, "
                                 f"{len(h.tokens)}/{n} tokens")
    return handles, reqs, wall, probed, warm_decode


def serve_main_path(torch, model, gen_seed: int):
    from tpudist_torch import ops

    def probe(server):
        return dict(
            counts=ops.launch_counts(),
            prefill_arms=dict(tc=ops.paged_prefill_attention.launches_tc,
                              cc=ops.paged_prefill_attention.launches_cc),
            decode_tc=ops.paged_attention.launches_tc,
            sample_arm_launches=prep_arm_launches(ops.fused_sample_prep),
            stats=server.stats())

    held = memory_held(torch)
    torch.cuda.reset_peak_memory_stats()
    handles, reqs, wall, got, warm = phase4_run(torch, model, gen_seed,
                                                probe)
    peak = torch.cuda.max_memory_allocated()
    counts, prefill_arms, decode_tc, sample_arm_launches, stats = (
        got[k] for k in ("counts", "prefill_arms", "decode_tc",
                         "sample_arm_launches", "stats"))
    if stats["kv"]["blocks_in_use"] != 0:
        raise AssertionError("KV pool did not drain")
    if not all(counts[name] > 0 for name in SERVE_KERNELS):
        raise AssertionError(f"a kernel was not launched on the serving "
                             f"path: {counts}")
    if prefill_arms != dict(tc=counts["paged_prefill"], cc=0):
        raise AssertionError(f"the tensor-core arm did not serve every "
                             f"prefill launch: {prefill_arms} of "
                             f"{counts['paged_prefill']}")
    if decode_tc != counts["paged_attention"]:
        raise AssertionError(f"the split walk served {decode_tc} of the "
                             f"{counts['paged_attention']} decode launches")
    hold_planned_arm("fused_sample_prep", sample_arm_launches,
                     counts["fused_sample"], planned_arms()["sample"])
    tokens = sum(len(h.tokens) for h in handles)
    return dict(
        requests=len(handles), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall,
        ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
        tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles),
        prompt_lens=[len(p) for p, _ in reqs],
        peak_mem_gb=peak / 1e9, peak_above_held_gb=(peak - held) / 1e9,
        decode=stats["decode"], decode_warm=warm, launches=counts,
        prefill_arm_launches=prefill_arms, decode_tc_launches=decode_tc,
        sample_arm_launches=sample_arm_launches,
        streams=[h.tokens for h in handles])


def serve_main_path_off(torch, model, gen_seed: int) -> dict:
    """Phase 4's run again on a new server with ``TPUDIST_TELEMETRY=0``
    (the active session finished first): the reading that compares with
    the phase 4 lines of the PRs before telemetry was on by default."""
    from tpudist_torch import telemetry

    telemetry.finish(write_report=False)
    with env_set(TPUDIST_TELEMETRY="0"):
        handles, _, wall, _, _ = phase4_run(torch, model, gen_seed)
    tokens = sum(len(h.tokens) for h in handles)
    return dict(
        tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
        tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles))


def planned_arms() -> dict:
    """The arms the plans name at the serving vocab
    (``ops/fused_sample.py`` ``_sample_arm``, ``_residual_arm``):
    ``fused_sample_prep``'s for the decode step's 8 rows and the verify's
    ``8 * (K + 1)`` (one arm for both), ``fused_residual_prep``'s for the
    verify's ``8 * K``."""
    from tpudist_torch.ops.fused_sample import _residual_arm, _sample_arm

    sample = {_sample_arm(n, V)[0] for n in (SLOTS, SLOTS * (SPEC_K + 1))}
    if len(sample) != 1:
        raise AssertionError(f"decode and verify rows plan {sample}")
    return dict(sample=sample.pop(),
                residual=_residual_arm(SLOTS * SPEC_K, V)[0])


def prep_arm_launches(fn) -> dict:
    """A sampling or residual prep's launches by arm since the last reset."""
    return dict(row=fn.launches_row, cluster=fn.launches_cluster)


def hold_planned_arm(name: str, by_arm: dict, total: int, arm: str) -> None:
    """Gate of phases 4, 4c and 4d: every launch of ``name`` on ``arm``,
    the arm its plan names at the serving vocab."""
    if by_arm.get(arm, 0) != total or sum(by_arm.values()) != total:
        raise AssertionError(f"{name} launched {by_arm} by arm, want all "
                             f"{total} on the {arm} arm")


def near_tie_gap(torch, model, prompt, got, want, factors=None, tg=None):
    """Where a greedy stream ``got`` differs from ``want``: the first
    differing position and the top-2 gap of the card's bf16 logits there,
    the common prefix teacher-forced through :func:`prompt_logits`; with a
    grammar ``tg``, of the logits its automaton allows at that state.  Two
    streams that agree until one ends (a stop or EOS at another place)
    fail."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        raise AssertionError(f"a greedy stream ends after {len(got)} tokens "
                             f"where its reference ends after {len(want)} "
                             "on the same tokens")
    seq = list(prompt) + list(want[:j])
    lg = prompt_logits(torch, model, seq, factors)[-1].float()
    if tg is not None:
        allow = torch.from_numpy(tg.allowed[tg.walk(want[:j])])
        lg = torch.where(allow, lg, torch.full_like(lg, -math.inf))
    top = lg.topk(2)
    return j, float(top.values[0] - top.values[1])


def hold_greedy_streams(torch, model, prompts, streams, base, lanes,
                        factors=None, names=None, grammars=None):
    """Gate of phases 4c, 4d and 4f: each greedy lane in ``lanes`` equals
    its non-speculative stream ``base``, or differs first where the card's
    top-2 logits (those its grammar allows, ``grammars[lane]``) lie within
    ``NEAR_TIE_GAP`` (the verify computes a row in an ``S * (K + 1)``-row
    pass, so bf16 rounds otherwise than in the ``s = 1`` decode).  Returns
    ``(equal lanes, [(lane, position, gap)])``."""
    equal, ties = 0, []
    for i in lanes:
        if streams[i] == base[i]:
            equal += 1
            continue
        f = None if names is None or names[i] is None else factors[names[i]]
        j, gap = near_tie_gap(torch, model, prompts[i], streams[i], base[i],
                              f, None if grammars is None else grammars[i])
        ties.append((i, j, gap))
        log(f"  lane {i} first differs at token {j}: top-2 logit gap "
            f"{gap:.5f} (bound {NEAR_TIE_GAP})")
        if gap > NEAR_TIE_GAP:
            raise AssertionError(
                f"greedy lane {i} differs from its non-speculative stream "
                f"at token {j} where the top-2 gap {gap:.5f} is no near tie")
    return equal, ties


def serve_spec_path(torch, model, gen_seed: int, base: dict,
                    factors=None) -> dict:
    """Phases 4c and 4d: speculative decoding (``spec=True, spec_k=4``, the
    tied 4-layer draft) on phase 4's server and requests, or with
    ``factors`` on phase 4b's adapter server and traffic.  Phase 4c runs
    ``SPEC_OFF_LANES`` greedy with ``spec=False`` and ``SAMPLED_LANES`` at
    temperature 0.8; phase 4d runs every lane greedy.  Gates: every request
    finishes ``length``; spec blocks ran; ``fused_residual_prep`` launched
    once a spec block; the paged decode kernel once a layer of every
    decode-arm forward (8 a target forward, 4 a draft forward), and with
    adapters ``fused_rope_qkv`` and ``lora_delta`` once / three times a
    layer of every forward; greedy lanes hold their non-speculative stream
    ``base["streams"]`` (:func:`hold_greedy_streams`)."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.serve import InferenceServer, ServeConfig

    on = factors is not None
    rng = np.random.default_rng(gen_seed)
    warm_prompt = None if on else rng.integers(0, V, size=70)
    reqs = [(rng.integers(0, V, size=int(rng.integers(1, 301))),
             int(rng.integers(16, 65))) for _ in range(16)]
    names = ([ADAPTER_NAMES[i % len(ADAPTER_NAMES)] for i in range(16)]
             if on else [None] * 16)
    spec_on = [on or i not in SPEC_OFF_LANES for i in range(16)]
    temps = [0.8 if not on and i in SAMPLED_LANES else 0.0
             for i in range(16)]
    cfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                      prefill_pad=P, decode_block=8, kv_block=BS,
                      fused_rope=on, adapters=on, lora_kernel=on, spec=True,
                      spec_k=SPEC_K)
    server = InferenceServer(model, cfg, device="cuda")
    eng = server.engine
    try:
        for name, f in (factors or {}).items():
            server.load_adapter(name, f)
        if not on:  # phase 4's schedule: warm up, then submit all
            server.start()
            warm = server.submit(warm_prompt, max_new=9)
            if not warm.wait(600) or warm.finish_reason != "length":
                raise AssertionError("warm-up request did not finish")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        before = dict(eng.decode_stats(), blocks_spec=eng.n_spec_blocks)
        t0 = time.perf_counter()
        handles = [server.submit(p, max_new=n, temperature=t, seed=i,
                                 spec=sp, adapter=a)
                   for i, ((p, n), t, sp, a) in enumerate(
                       zip(reqs, temps, spec_on, names))]
        if on:  # phase 4b's schedule: all queued, then start
            server.start()
        for h in handles:
            if not h.wait(900):
                raise AssertionError("request timed out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        decode_tc = ops.paged_attention.launches_tc
        rope_arms = {"split": ops.fused_rope_qkv.launches_split,
                     "wgmma": ops.fused_rope_qkv.launches_wgmma}
        sample_arm_launches = prep_arm_launches(ops.fused_sample_prep)
        residual_arm_launches = prep_arm_launches(ops.fused_residual_prep)
        stats = server.stats()
    finally:
        server.close(60)
    for h, (_, n) in zip(handles, reqs):
        if h.finish_reason != "length" or len(h.tokens) != n:
            raise AssertionError(f"request {h.id}: {h.finish_reason}, "
                                 f"{len(h.tokens)}/{n} tokens")
    if stats["kv"]["blocks_in_use"] != 0:
        raise AssertionError("KV pool did not drain")
    if decode_tc != counts["paged_attention"]:
        raise AssertionError(f"the split walk served {decode_tc} of the "
                             f"{counts['paged_attention']} decode launches")
    dec, spec = stats["decode"], stats["spec"]
    tf = dec["forwards"] - before["forwards"]
    df = dec["draft_forwards"] - before["draft_forwards"]
    t_dec = dec["steps"] - before["steps"]
    d_dec = dec["draft_decode_forwards"] - before["draft_decode_forwards"]
    blocks = eng.n_spec_blocks - before["blocks_spec"]
    d_layers = eng.draft_model.n_layers
    if not (blocks > 0 and spec["drafted"] > 0):
        raise AssertionError(f"no speculative block ran: {spec}")
    want = {"fused_residual_prep": blocks,
            "paged_attention": LAYERS * t_dec + d_layers * d_dec}
    if on:
        want["fused_rope_qkv"] = LAYERS * tf + d_layers * df
        want["lora_delta"] = 3 * (LAYERS * tf + d_layers * df)
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(
                f"{name} launched {counts[name]} times, want {n} ({blocks} "
                f"spec blocks, {tf} target / {df} draft forwards, {t_dec} / "
                f"{d_dec} of them on the decode arm)")
    # every decode, draft and verify forward on fused_rope_qkv's split arm,
    # every prefill chunk on its wgmma arm
    want_arms = ({"split": LAYERS * t_dec + d_layers * d_dec,
                  "wgmma": LAYERS * (tf - t_dec) + d_layers * (df - d_dec)}
                 if on else {"split": 0, "wgmma": 0})
    if rope_arms != want_arms:
        raise AssertionError(
            f"fused_rope_qkv's arms served {rope_arms} of "
            f"{counts['fused_rope_qkv']} launches (want {want_arms}: "
            f"{t_dec} / {d_dec} target / draft decode-arm forwards of {tf} "
            f"/ {df})")
    if not all(counts[name] > 0 for name in SERVE_KERNELS):
        raise AssertionError(f"a serving kernel was not launched: {counts}")
    arms = planned_arms()
    hold_planned_arm("fused_sample_prep", sample_arm_launches,
                     counts["fused_sample"], arms["sample"])
    hold_planned_arm("fused_residual_prep", residual_arm_launches,
                     counts["fused_residual_prep"], arms["residual"])
    streams = [h.tokens for h in handles]
    greedy = [i for i in range(16) if temps[i] == 0.0]
    equal, ties = hold_greedy_streams(
        torch, model, [p for p, _ in reqs], streams, base["streams"], greedy,
        factors, names)
    tokens = sum(len(h.tokens) for h in handles)
    return dict(
        requests=len(handles), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall,
        ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
        tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles),
        acceptance_rate=spec["acceptance_rate"],
        tokens_per_target_pass=spec["accepted_per_pass"],
        spec_blocks=blocks, target_forwards=tf, draft_forwards=df,
        greedy_lanes_equal=f"{equal}/{len(greedy)}", near_ties=ties,
        spec=spec, launches=counts, decode_tc_launches=decode_tc,
        rope_arm_launches=rope_arms, sample_arm_launches=sample_arm_launches,
        residual_arm_launches=residual_arm_launches, decode=dec,
        base={k: base[k] for k in ("tokens_per_s", "ttft_p50_ms",
                                   "tpot_p50_ms")})


def adapter_factors(torch, model) -> dict:
    """The ``N_ADAPTERS`` seeded factor sets of phases 4b and 5b (CPU
    generators, so every run loads the same adapters)."""
    from tpudist_torch.models.lora import make_adapter_factors

    return {f"a{i}": make_adapter_factors(
        torch.Generator().manual_seed(100 + i), model, RANK)
        for i in range(N_ADAPTERS)}


def cpu_stream(torch, cpu_model, prompt, n: int, name=None, factors=None):
    """One request's greedy stream on the port's CPU f32 path (every
    kernel's plain version), through adapter ``name`` if given."""
    from tpudist_torch.serve import InferenceServer, ServeConfig

    on = name is not None
    cfg = ServeConfig(num_slots=1, queue_limit=4, max_new=64, prefill_pad=P,
                      decode_block=8, kv_block=BS, fused_rope=True,
                      adapters=on, lora_kernel=on)
    server = InferenceServer(cpu_model, cfg, device="cpu")
    try:
        if on:
            server.load_adapter(name, factors)
        h = server.submit(prompt, max_new=n, adapter=name)
        server.start()
        if not h.wait(900):
            raise AssertionError("CPU reference request timed out")
    finally:
        server.close(60)
    return h.tokens


def adapter_lane_ties(torch, model, cpu_model, prompt, n, name, factors,
                      stream):
    """Gate of phase 4b for an adapter lane whose card stream equals its
    base lane's: in f32 on the CPU the adapter stream must differ from the
    base stream, and where the card's one ``stream`` leaves either f32
    stream it must leave it first at a near tie of the card's logits (top-2
    gap within ``NEAR_TIE_GAP``, :func:`hold_greedy_streams`' standard).  On
    random weights a lane can settle into one repeated token, so an adapter
    may first move a greedy choice late, at a gap that bf16 rounding
    crosses.  Returns ``[(stream, position, gap)]``."""
    ref = {None: cpu_stream(torch, cpu_model, prompt, n),
           name: cpu_stream(torch, cpu_model, prompt, n, name, factors)}
    if ref[None] == ref[name]:
        raise AssertionError(f"adapter {name} leaves the stream unchanged "
                             f"on the CPU f32 path too")
    ties = []
    for key, f in ((None, None), (name, factors)):
        if stream == ref[key]:
            continue
        j, gap = near_tie_gap(torch, model, prompt, stream, ref[key], f)
        ties.append((key or "base", j, gap))
        if gap > NEAR_TIE_GAP:
            raise AssertionError(
                f"the card's stream leaves the f32 {key or 'base'} stream at "
                f"token {j} where the top-2 gap {gap:.5f} is no near tie")
    return ties


def serve_adapter_path(torch, model, gen_seed: int, cpu_model) -> dict:
    """Phase 4b: ``InferenceServer`` with ``fused_rope``, ``adapters`` and
    ``lora_kernel`` on, over phase 4's model and geometry; 16 greedy
    requests (prompts 1-300 tokens, 16-64 new tokens) naming
    ``ADAPTER_NAMES`` in turn.  The same requests then run on a server that
    differs only by ``adapters=False`` (each base lane must match it token
    for token, each adapter lane must differ, or be held by
    :func:`adapter_lane_ties` against the CPU f32 path of ``cpu_model``)
    and on phase 4's unfused arm (base-lane agreement reported only: bf16
    rounds in another order).  Every request is queued before its server
    starts, so the three servers run the same schedule."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.ops import fused_rope_qkv, lora_delta
    from tpudist_torch.serve import InferenceServer, ServeConfig

    rng = np.random.default_rng(gen_seed)
    reqs = [(rng.integers(0, V, size=int(rng.integers(1, 301))),
             int(rng.integers(16, 65))) for _ in range(16)]
    names = [ADAPTER_NAMES[i % len(ADAPTER_NAMES)] for i in range(16)]
    factors = adapter_factors(torch, model)

    def run(fused: bool, adapters: bool):
        cfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                          prefill_pad=P, decode_block=8, kv_block=BS,
                          fused_rope=fused, adapters=adapters,
                          lora_kernel=adapters)
        server = InferenceServer(model, cfg, device="cuda")
        try:
            if adapters:
                for name, f in factors.items():
                    server.load_adapter(name, f)
            handles = [server.submit(p, max_new=n,
                                     adapter=a if adapters else None)
                       for (p, n), a in zip(reqs, names)]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            fw0 = server.engine.n_forwards
            st0 = server.engine.n_decode_steps
            t0 = time.perf_counter()
            server.start()
            for h in handles:
                if not h.wait(900):
                    raise AssertionError("request timed out")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            cluster = lora_delta.launches_cluster
            rope_arms = {"split": fused_rope_qkv.launches_split,
                         "wgmma": fused_rope_qkv.launches_wgmma}
            forwards = server.engine.n_forwards - fw0
            steps = server.engine.n_decode_steps - st0
            stats = server.stats()
        finally:
            server.close(60)
        for h, (_, n) in zip(handles, reqs):
            if h.finish_reason != "length" or len(h.tokens) != n:
                raise AssertionError(f"request {h.id}: {h.finish_reason}, "
                                     f"{len(h.tokens)}/{n} tokens")
        if stats["kv"]["blocks_in_use"] != 0:
            raise AssertionError("KV pool did not drain")
        tokens = sum(len(h.tokens) for h in handles)
        return dict(
            streams=[h.tokens for h in handles], requests=len(handles),
            tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
            ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
            tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles),
            forwards=forwards, decode_forwards=steps, launches=counts,
            lora_cluster_launches=cluster, rope_arm_launches=rope_arms,
            decode=stats["decode"], adapters=stats["adapters"])

    main = run(fused=True, adapters=True)
    L, fw, c = LAYERS, main["forwards"], main["launches"]
    if c["fused_rope_qkv"] != L * fw or c["lora_delta"] != 3 * L * fw:
        raise AssertionError(
            f"{fw} forwards of {L} layers launched fused_rope_qkv "
            f"{c['fused_rope_qkv']} and lora_delta {c['lora_delta']} times "
            f"(want {L * fw} and {3 * L * fw})")
    # every decode forward on the split arm, every prefill chunk on wgmma
    dec = main["decode_forwards"]
    want = {"split": L * dec, "wgmma": L * (fw - dec)}
    if main["rope_arm_launches"] != want or not 0 < dec < fw:
        raise AssertionError(
            f"fused_rope_qkv's arms served {main['rope_arm_launches']} of "
            f"{c['fused_rope_qkv']} launches over {dec} decode and "
            f"{fw - dec} prefill forwards (want {want})")
    if not all(c[name] > 0 for name in SERVE_KERNELS):
        raise AssertionError(f"a serving kernel was not launched: {c}")
    if not 0 < main["lora_cluster_launches"] < c["lora_delta"]:
        raise AssertionError(
            f"lora_delta's cluster arm served {main['lora_cluster_launches']}"
            f" of {c['lora_delta']} launches: decode must take it, the "
            f"prefill chunks the staged arm")
    base = run(fused=True, adapters=False)
    ties = {}
    for i, name in enumerate(names):
        same = main["streams"][i] == base["streams"][i]
        if name is None and not same:
            raise AssertionError(f"base lane {i} differs from the same "
                                 "request on the engine without adapters")
        if name is not None and same:
            ties[i] = adapter_lane_ties(
                torch, model, cpu_model, reqs[i][0], reqs[i][1], name,
                factors[name], main["streams"][i])
            log(f"  adapter lane {i} ({name}) equals its base stream on the "
                f"card; against the CPU f32 streams: {ties[i]} (bound "
                f"{NEAR_TIE_GAP})")
    unfused = run(fused=False, adapters=False)
    lanes = [i for i, n in enumerate(names) if n is None]
    agree = sum(main["streams"][i] == unfused["streams"][i] for i in lanes)
    first_diff = [next((t for t, (a, b) in enumerate(zip(
        main["streams"][i], unfused["streams"][i])) if a != b), None)
        for i in lanes]
    main.update(prompt_lens=[len(p) for p, _ in reqs], names=names,
                base_lanes_equal_no_adapter_engine=len(lanes),
                adapter_lanes_differ=len(names) - len(lanes) - len(ties),
                adapter_lanes_at_near_ties=ties,
                base_lanes_equal_unfused=f"{agree}/{len(lanes)}",
                first_divergence_vs_unfused=first_diff,
                no_adapter_run={k: base[k] for k in (
                    "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms")},
                unfused_run={k: unfused[k] for k in (
                    "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms")})
    return main


def log_spec(what: str, r: dict, base: str, card: str) -> None:
    b = r["base"]
    log(f"{what}: {r['requests']} requests, {r['tokens']} tokens in "
        f"{r['wall_s']:.3f} s = {r['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{r['ttft_p50_ms']:.2f} ms, TPOT p50 {r['tpot_p50_ms']:.3f} ms "
        f"({card}); {base} in this run {b['tokens_per_s']:.1f} tokens/s, "
        f"TTFT p50 {b['ttft_p50_ms']:.2f} ms, TPOT p50 "
        f"{b['tpot_p50_ms']:.3f} ms; acceptance {r['acceptance_rate']}, "
        f"{r['tokens_per_target_pass']} tokens per lane and target pass, "
        f"{r['spec_blocks']} spec blocks, {r['target_forwards']} target / "
        f"{r['draft_forwards']} draft forwards; greedy lanes equal to "
        f"{base}: {r['greedy_lanes_equal']}, near ties {r['near_ties']}; "
        f"launches {r['launches']}")


# ---------------------------------------------------------------------------
# phases 4e and 4f: structured output, logprobs and stop sequences on the
# serving path


def constrain_grammars() -> tuple:
    """Phase 4e's grammars by kind (``CONSTRAIN_REGEXES`` and ``"json"``,
    ``CONSTRAIN_SCHEMA``) over ``default_vocab(256)`` with EOS ``EOS_ID``,
    each compiled once through the port's compiler (the server's own
    compiles of the same asks are then cache hits): ``({kind:
    TokenGrammar}, {kind: host ms of its compile})``."""
    from tpudist_torch.constrain import compile_grammar, default_vocab

    out, ms = {}, {}
    for kind in ("r1", "r2", "r3", "json"):
        kw = (dict(json_schema=CONSTRAIN_SCHEMA) if kind == "json"
              else dict(regex=CONSTRAIN_REGEXES[kind]))
        t0 = time.perf_counter()
        out[kind] = compile_grammar(vocab=default_vocab(V), eos_id=EOS_ID,
                                    max_states=CONSTRAIN_STATES, **kw)
        ms[kind] = (time.perf_counter() - t0) * 1e3
    return out, ms


def first_stop(stream, seqs):
    """The index of the last token of ``stream``'s first stop-sequence
    match (the server's suffix match after every token), or None."""
    for e in range(len(stream)):
        for q in seqs:
            if e + 1 >= len(q) and tuple(stream[e + 1 - len(q):e + 1]) == q:
                return e
    return None


def hold_language(i, h, tg, kind) -> None:
    """Gate 1 of phases 4e and 4f for constrained lane ``i``: finished
    ``eos``, its text (the tokens before EOS) is in the language
    (``re.fullmatch`` of the regex; ``json.loads`` and the schema's own
    check: an object of exactly an int ``n`` and a bool ``ok``); finished
    ``length``, its tokens walk the automaton (every state is live, so they
    spell a prefix of a member).  Anything else fails."""
    from tpudist_torch.constrain import default_vocab

    vocab = default_vocab(V)
    if h.finish_reason == "eos":
        text = "".join(vocab[t] for t in h.tokens[:-1])
        if kind == "json":
            try:
                obj = json.loads(text)
            except ValueError:
                obj = None
            ok = (isinstance(obj, dict) and set(obj) == {"n", "ok"}
                  and type(obj["n"]) is int and type(obj["ok"]) is bool)
        else:
            ok = re.fullmatch(CONSTRAIN_REGEXES[kind], text) is not None
    elif h.finish_reason == "length":
        ok = tg.walk(h.tokens) is not None
        text = "".join(vocab[t] for t in h.tokens)
    else:
        ok, text = False, None
    if not ok:
        raise AssertionError(f"constrained lane {i} ({kind}) finished "
                             f"{h.finish_reason} with {text!r}, outside its "
                             "language")


def hold_logprobs(i, h, tg, greedy: bool) -> int:
    """Gate 5 of phases 4e and 4f for lane ``i``: one row a token, None for
    the prefill's first token; each row ``N_LOGPROBS`` wide, sorted, every
    value ``<= 0``; a greedy lane's token is its row's top id; on a
    constrained lane every id above -1e30 is allowed by the host shadow at
    that token's state.  Returns the rows checked."""
    if len(h.logprobs) != len(h.tokens) or h.logprobs[0] is not None:
        raise AssertionError(f"lane {i}: {len(h.logprobs)} logprobs rows "
                             f"for {len(h.tokens)} tokens (the first None)")
    state = 0 if tg is None else tg.advance(0, h.tokens[0])
    for j in range(1, len(h.tokens)):
        ids, vals = h.logprobs[j]
        tok = h.tokens[j]
        if len(ids) != N_LOGPROBS or any(
                b > a for a, b in zip(vals, vals[1:])) or max(vals) > 0:
            raise AssertionError(f"lane {i} token {j}: logprobs row "
                                 f"{ids} {vals} is not a sorted top-"
                                 f"{N_LOGPROBS} of log-probabilities")
        if greedy and ids[0] != tok:
            raise AssertionError(f"greedy lane {i} token {j}: emitted {tok}, "
                                 f"top logprob id {ids[0]}")
        if tg is not None:
            if any(v > -1e30 and not tg.token_allowed(state, t)
                   for t, v in zip(ids, vals)):
                raise AssertionError(f"constrained lane {i} token {j}: a "
                                     "forbidden id carries probability")
            state = tg.advance(state, tok)
    return len(h.tokens) - 1


def serve_constrained_path(torch, model, gen_seed: int, base: dict,
                           mode: str = "plain", constrained=None) -> dict:
    """Phase 4e (``mode="plain"``): ``ServeConfig(constrain=True,
    logprobs=5)`` on phase 4's model, geometry and 16 requests, the lanes
    as ``LANE_GRAMMARS`` / ``LANE_TEMPS`` / ``LANE_STOPS`` say, every lane
    asking top-5 logprobs.  Phase 4f: the same traffic on phase 4c's spec
    server (``mode="spec"``) and on phase 4b's adapter server with its four
    adapters (``mode="adapter"``, names cycling as in 4b).  ``mode="free"``
    is 4e's yardstick: the same requests, temperatures and seeds on phase
    4's server, without grammars, stops or logprobs (every lane runs to
    its budget; each greedy lane must hold phase 4's stream, gate 3).
    The launch counts are zeroed just before the requests and read just
    after.

    Gates: (1) every constrained lane in its language
    (:func:`hold_language`); (2) no ``grammar_violation``; (3) on 4e each
    free greedy lane equals phase 4's stream ``base["streams"]`` bit for
    bit or leaves it first at a near tie (:func:`hold_greedy_streams`: the
    server's schedule, which moves with when requests arrive and with the
    decode block sizes that the constrained lanes' early EOS changes,
    moves where the paged decode splits a lane's keys, so bf16 rounds
    otherwise; phase 4's own traffic differs so between runs; the sentinel
    row's identity itself is exact in phase 3's (g) and (h)), on the spec
    server every greedy lane its 4e stream (``constrained["streams"]``) up
    to a near tie of the logits its grammar allows; (4) each stop lane
    ends at its first match with the stop tokens kept (on 4e: phase 4's
    stream cut there, and a two-token match straddles two deliveries), or,
    off phase 4's stream, at its budget without a match; (5) the logprobs
    rows (:func:`hold_logprobs`); (6) the sampling kernel's grammar arm
    launched: on the plain and adapter servers every sampling launch
    carries the pool, on the spec server the decode steps' do (the
    verify's rows are masked before the kernel, the draft proposes
    unmasked)."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.constrain import compile_cache_stats
    from tpudist_torch.serve import InferenceServer, ServeConfig

    rng = np.random.default_rng(gen_seed)
    warm_prompt = rng.integers(0, V, size=70)
    reqs = [(rng.integers(0, V, size=int(rng.integers(1, 301))),
             int(rng.integers(16, 65))) for _ in range(16)]
    cache0 = compile_cache_stats()
    grammars, compile_ms = ({}, {}) if mode == "free" \
        else constrain_grammars()
    ref = base["streams"]
    stops = {i: tuple(tuple(ref[i][a:b]) for a, b in cuts)
             for i, cuts in LANE_STOPS.items()}
    names = ([ADAPTER_NAMES[i % len(ADAPTER_NAMES)] for i in range(16)]
             if mode == "adapter" else [None] * 16)
    on, free = mode == "adapter", mode == "free"
    if free:
        stops = {}
    cfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                      prefill_pad=P, decode_block=8, kv_block=BS,
                      fused_rope=on, adapters=on, lora_kernel=on,
                      spec=mode == "spec", spec_k=SPEC_K, constrain=not free,
                      constrain_blocks=CONSTRAIN_BLOCKS,
                      constrain_states=CONSTRAIN_STATES,
                      logprobs=0 if free else N_LOGPROBS)
    server = InferenceServer(model, cfg, device="cuda")
    deliveries = {}
    deliver = server._deliver_block

    def record(slot, toks, lp=None):
        # each delivery's size by request: where a stop match straddles
        h = server._slot_handles[slot]
        deliveries.setdefault(h.id, []).append(len(toks))
        return deliver(slot, toks, lp)

    server._deliver_block = record
    try:
        for name, f in (adapter_factors(torch, model) if on else {}).items():
            server.load_adapter(name, f)
        if not on:  # phase 4's schedule: warm up, then submit all
            server.start()
            warm = server.submit(warm_prompt, max_new=9)
            if not warm.wait(600) or warm.finish_reason != "length":
                raise AssertionError("warm-up request did not finish")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        dec0 = server.engine.decode_stats()
        t0 = time.perf_counter()
        handles = []
        for i, (p, n) in enumerate(reqs):
            kind = None if free else LANE_GRAMMARS[i]
            ask = ({} if kind is None else dict(
                eos_id=EOS_ID, **({"json_schema": CONSTRAIN_SCHEMA}
                                  if kind == "json" else
                                  {"grammar": CONSTRAIN_REGEXES[kind]})))
            handles.append(server.submit(
                p, max_new=n, temperature=LANE_TEMPS[i], seed=i,
                adapter=names[i], stop=stops.get(i),
                logprobs=0 if free else N_LOGPROBS, **ask))
        if on:  # phase 4b's schedule: all queued, then start
            server.start()
        for h in handles:
            if not h.wait(900):
                raise AssertionError("request timed out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        grammar_launches = ops.fused_sample_prep.launches_grammar
        sample_arm_launches = prep_arm_launches(ops.fused_sample_prep)
        stats = server.stats()
    finally:
        server.close(60)
    # host wall of the decode iterations (dispatch plus the one fetch) per
    # target pass: a decode step, or a spec block's verify
    dec = {k: stats["decode"][k] - dec0[k]
           for k in ("steps", "dispatch_s", "sync_s", "tokens")}
    step_ms = 1e3 * (dec["dispatch_s"] + dec["sync_s"]) / max(dec["steps"], 1)
    if stats["kv"]["blocks_in_use"] != 0:
        raise AssertionError("KV pool did not drain")
    if not free and stats["constrained"]["pinned"] != 0:
        raise AssertionError(f"grammar blocks still pinned: "
                             f"{stats['constrained']}")
    lane_g = [None if k is None or free else grammars[k]
              for k in LANE_GRAMMARS]
    reasons = {}
    rows = 0
    for i, h in enumerate(handles):
        reasons[h.finish_reason] = reasons.get(h.finish_reason, 0) + 1
        if h.finish_reason == "grammar_violation":  # gate 2
            raise AssertionError(f"lane {i} finished grammar_violation")
        if lane_g[i] is not None:
            hold_language(i, h, lane_g[i], LANE_GRAMMARS[i])
        elif i not in stops and (h.finish_reason != "length"
                                 or len(h.tokens) != reqs[i][1]):
            raise AssertionError(f"free lane {i}: {h.finish_reason}, "
                                 f"{len(h.tokens)}/{reqs[i][1]} tokens")
        if not free:
            rows += hold_logprobs(i, h, lane_g[i], LANE_TEMPS[i] == 0.0)
    streams = [h.tokens for h in handles]
    straddles = {}
    for i, seqs in stops.items():  # gate 4
        h = handles[i]
        e = first_stop(h.tokens, seqs)
        if e is None:
            # off phase 4's stream (an adapter lane, or a lane that left it
            # at a near tie, gate 3) the sequence may never come: the
            # budget ends it
            if h.finish_reason != "length" or len(h.tokens) != reqs[i][1]:
                raise AssertionError(f"stop lane {i}: {h.finish_reason} "
                                     f"after {len(h.tokens)} tokens without "
                                     "a match")
            continue
        if h.finish_reason != "stop_sequence" or e != len(h.tokens) - 1:
            raise AssertionError(f"stop lane {i}: {h.finish_reason} after "
                                 f"{len(h.tokens)} tokens, first match of "
                                 f"{seqs} ends at {e}")
        starts = np.cumsum([0] + deliveries[h.id])
        chunk = np.searchsorted(starts, [e + 1 - len(seqs[0]), e],
                                side="right")
        straddles[i] = bool(chunk[0] != chunk[1])
    if mode == "plain" and not any(
            straddles.get(i) for i in stops if len(stops[i][0]) == 2):
        raise AssertionError(f"no two-token stop match straddled two "
                             f"deliveries: {straddles}")
    greedy = [i for i in range(16) if LANE_TEMPS[i] == 0.0]
    equal, ties = len(greedy), []
    if mode in ("plain", "free"):  # gate 3: the sentinel row is an identity
        want = [r[:first_stop(r, stops[i]) + 1] if i in stops else r
                for i, r in enumerate(ref)]
        greedy = [i for i in greedy if lane_g[i] is None]
        equal, ties = hold_greedy_streams(
            torch, model, [p for p, _ in reqs], streams, want, greedy)
    elif mode == "spec":
        equal, ties = hold_greedy_streams(
            torch, model, [p for p, _ in reqs], streams,
            constrained["streams"], greedy, grammars=lane_g)
    if not all(counts[name] > 0 for name in SERVE_KERNELS):
        raise AssertionError(f"a serving kernel was not launched: {counts}")
    if on and not (counts["fused_rope_qkv"] > 0 and counts["lora_delta"] > 0):
        raise AssertionError(f"the adapter kernels were not launched: "
                             f"{counts}")
    if mode == "spec" and counts["fused_residual_prep"] == 0:
        raise AssertionError("no speculative verify ran")
    if free:
        if grammar_launches:
            raise AssertionError(f"{grammar_launches} grammar launches "
                                 "without a grammar pool")
    elif not 0 < grammar_launches <= counts["fused_sample"] or (
            mode != "spec" and grammar_launches != counts["fused_sample"]):
        raise AssertionError(  # gate 6
            f"fused_sample_prep carried the grammar pool in "
            f"{grammar_launches} of {counts['fused_sample']} launches")
    hold_planned_arm("fused_sample_prep", sample_arm_launches,
                     counts["fused_sample"], planned_arms()["sample"])
    cache1 = compile_cache_stats()
    tokens = sum(len(h.tokens) for h in handles)
    return dict(
        mode=mode, requests=len(handles), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall,
        ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
        tpot_p50_ms=1e3 * statistics.median(
            h.tpot_s for h in handles if h.tpot_s is not None),
        finish_reasons=reasons, logprob_rows=rows, decode=dec,
        decode_step_ms=step_ms,
        grammar_states={k: g.n_states for k, g in grammars.items()},
        compile_ms=compile_ms,
        compile_cache=dict(hits=cache1["hits"] - cache0["hits"],
                           misses=cache1["misses"] - cache0["misses"]),
        stops={i: [list(q) for q in seqs] for i, seqs in stops.items()},
        stop_straddles=straddles,
        greedy_lanes_equal=f"{equal}/{len(greedy)}", near_ties=ties,
        launches=counts, grammar_launches=grammar_launches,
        sample_arm_launches=sample_arm_launches,
        spec=stats["spec"], constrained=stats.get("constrained"),
        streams=streams,
        base={k: base[k] for k in ("tokens_per_s", "ttft_p50_ms",
                                   "tpot_p50_ms")})


def log_constrained(what: str, r: dict, card: str) -> None:
    b = r["base"]
    log(f"{what}: {r['requests']} requests, {r['tokens']} tokens in "
        f"{r['wall_s']:.3f} s = {r['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{r['ttft_p50_ms']:.2f} ms, TPOT p50 {r['tpot_p50_ms']:.3f} ms, "
        f"{r['decode_step_ms']:.3f} ms of host wall per target pass of the "
        f"decode ({r['decode']['steps']} passes) ({card}); phase 4 in this "
        f"run {b['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{b['ttft_p50_ms']:.2f} ms, TPOT p50 {b['tpot_p50_ms']:.3f} ms; "
        f"finish reasons {r['finish_reasons']}; "
        f"grammar states {r['grammar_states']}; compile host ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in r["compile_ms"].items())
        + f" (this phase's compiles: {r['compile_cache']}); launches "
        f"{r['launches']}, fused_sample.grammar {r['grammar_launches']} of "
        f"{r['launches']['fused_sample']}; {r['logprob_rows']} logprobs rows "
        f"held; stops {r['stops']}, straddling two deliveries "
        f"{r['stop_straddles']}; greedy lanes equal "
        f"{r['greedy_lanes_equal']}, near ties {r['near_ties']}")


# phase 4g: the JAX package's default serving configuration on the card and
# its neighbours, each on phase 4's model and phase 4c's traffic (phase 4's
# requests; SPEC_OFF_LANES greedy with spec off, SAMPLED_LANES at 0.8, the
# rest greedy): (a) the JAX defaults, the dense cache with the
# teacher-forced prefill and the unfused tail; (b) (a) with the sampling
# kernel; (c) the gather decode over the paged pool beside the prefill and
# sampling kernels; (d) phase 4c's spec server on the dense cache, the
# unfused and the kernel tail
DEFAULT_ARMS = {
    "a": dict(paged=False, attn_kernel="gather", prefill_kernel=False,
              sample_kernel=False),
    "b": dict(paged=False, attn_kernel="gather", prefill_kernel=False,
              sample_kernel=True),
    "c": dict(paged=True, attn_kernel="gather", prefill_kernel=True,
              sample_kernel=True),
    "d unfused": dict(paged=False, attn_kernel="gather",
                      prefill_kernel=False, sample_kernel=False, spec=True,
                      spec_k=SPEC_K),
    "d kernel": dict(paged=False, attn_kernel="gather", prefill_kernel=False,
                     sample_kernel=True, spec=True, spec_k=SPEC_K),
}
# the sampled lanes two runs must draw byte for byte alike
SAME_DRAWS = (("a", "b"), ("d unfused", "d kernel"))


def phase4_traffic(gen_seed: int):
    """Phase 4's warm-up prompt and 16 requests (the same draws), with
    phase 4c's temperatures and speculation flags."""
    import numpy as np

    rng = np.random.default_rng(gen_seed)
    warm = rng.integers(0, V, size=70)
    reqs = [(rng.integers(0, V, size=int(rng.integers(1, 301))),
             int(rng.integers(16, 65))) for _ in range(16)]
    temps = [0.8 if i in SAMPLED_LANES else 0.0 for i in range(16)]
    spec_on = [i not in SPEC_OFF_LANES for i in range(16)]
    return warm, reqs, temps, spec_on


def serve_arm(torch, model, knobs: dict, gen_seed: int) -> dict:
    """One phase 4g run: phase 4's server geometry with ``knobs``, warmed
    up, then the traffic of :func:`phase4_traffic` with the launch counts
    zeroed just before it.  Every request must finish ``length``."""
    from tpudist_torch import ops
    from tpudist_torch.serve import InferenceServer, ServeConfig

    warm_prompt, reqs, temps, spec_on = phase4_traffic(gen_seed)
    cfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                      prefill_pad=P, decode_block=8, kv_block=BS, **knobs)
    server = InferenceServer(model, cfg, device="cuda").start()
    eng = server.engine
    try:
        warm = server.submit(warm_prompt, max_new=9)
        if not warm.wait(600) or warm.finish_reason != "length":
            raise AssertionError("warm-up request did not finish")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        before = dict(eng.decode_stats(), spec_blocks=eng.n_spec_blocks)
        t0 = time.perf_counter()
        handles = [server.submit(p, max_new=n, temperature=t, seed=i,
                                 spec=sp)
                   for i, ((p, n), t, sp) in enumerate(
                       zip(reqs, temps, spec_on))]
        for h in handles:
            if not h.wait(900):
                raise AssertionError("request timed out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        stats = server.stats()
    finally:
        server.close(60)
    for h, (_, n) in zip(handles, reqs):
        if h.finish_reason != "length" or len(h.tokens) != n:
            raise AssertionError(f"request {h.id}: {h.finish_reason}, "
                                 f"{len(h.tokens)}/{n} tokens")
    dec = stats["decode"]
    tokens = sum(len(h.tokens) for h in handles)
    return dict(
        knobs=knobs, requests=len(handles), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall,
        ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
        tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles),
        launches=counts, steps=dec["steps"] - before["steps"],
        spec_blocks=eng.n_spec_blocks - before["spec_blocks"],
        kv=stats["kv"], prompts=[p for p, _ in reqs], temps=temps,
        streams=[h.tokens for h in handles])


def hold_default_arms(torch, model, runs: dict, base: dict) -> dict:
    """Phase 4g's gates over :func:`serve_arm`'s runs: no paged decode
    launch on any arm; the unfused runs launch no kernel at all; the
    sampling prep at least once a decode step where it is on; the paged
    prefill on (c); the residual prep once a spec block on (d)'s kernel
    half (none on the other); greedy lanes hold phase 4's streams
    (:func:`hold_greedy_streams`); the sampled lanes of (a) and (b), and of
    the two halves of (d), byte for byte alike.  Returns the lanes held
    equal and the near ties, by run."""
    held = {}
    for name, r in runs.items():
        n = r["launches"]
        if n["paged_attention"]:
            raise AssertionError(f"phase 4g {name}: {n['paged_attention']} "
                                 "paged decode launches on a gather arm")
        kern = r["knobs"]["sample_kernel"]
        if not kern and any(n.values()):
            raise AssertionError(f"phase 4g {name}: kernels launched on the "
                                 f"unfused dense arm: {n}")
        if kern and n["fused_sample"] < r["steps"]:
            raise AssertionError(
                f"phase 4g {name}: fused_sample_prep launched "
                f"{n['fused_sample']} times in {r['steps']} decode steps")
        if r["knobs"]["prefill_kernel"] != (n["paged_prefill"] > 0):
            raise AssertionError(f"phase 4g {name}: paged prefill launches "
                                 f"{n['paged_prefill']}")
        if r["knobs"].get("spec"):
            if r["spec_blocks"] < 1:
                raise AssertionError(f"phase 4g {name}: no spec block ran")
            if n["fused_residual_prep"] != (r["spec_blocks"] if kern
                                            else 0):
                raise AssertionError(
                    f"phase 4g {name}: fused_residual_prep launched "
                    f"{n['fused_residual_prep']} times in "
                    f"{r['spec_blocks']} spec blocks")
        greedy = [i for i, t in enumerate(r["temps"]) if t == 0.0]
        held[name] = hold_greedy_streams(torch, model, r["prompts"],
                                         r["streams"], base["streams"],
                                         greedy)
    for x, y in SAME_DRAWS:
        for i in SAMPLED_LANES:
            if runs[x]["streams"][i] != runs[y]["streams"][i]:
                raise AssertionError(f"phase 4g: sampled lane {i} draws "
                                     f"otherwise on {x} and {y}")
    return held


def adopt_lane(src, slot: int, dst, dslot: int) -> None:
    """Export ``slot`` of engine ``src`` (``export_lane``) and install it in
    free ``dslot`` of engine ``dst`` (``import_lane``; a paged ``dst``
    reserves the lane's footprint first) with the host shadows the
    continuation needs."""
    import numpy as np

    lane, row = src.fns.export_lane(src.state, src.cache, slot)
    if dst.alloc is not None:
        got, _ = dst.alloc.admit(dslot, int(src.pos[slot]),
                                 int(src.budget[slot]), ())
        table = np.full(dst.max_len // dst.paged_cfg.block_size,
                        dst.paged_cfg.num_blocks, np.int32)
        table[:len(got)] = got
        dst.state, dst.cache = dst.fns.import_lane(
            dst.state, dst.cache, dslot, dst._t(table), lane, row)
    else:
        dst.state, dst.cache = dst.fns.import_lane(dst.state, dst.cache,
                                                   dslot, lane, row)
    dst.occupied[dslot] = dst.decoding[dslot] = True
    for name in ("pos", "counts", "budget", "temps"):
        getattr(dst, name)[dslot] = getattr(src, name)[slot]


def finish_lanes(eng, out: dict) -> dict:
    """Decode every lane of ``eng`` to its budget, appending to ``out``."""
    while eng.num_active:
        for s, toks in eng.decode_block()[1].items():
            out.setdefault(s, []).extend(toks)
            if eng.counts[s] >= eng.budget[s]:
                eng.evict(s)
    return out


def lanes_path(torch, model, gen_seed: int, base: dict) -> dict:
    """Phase 4g (e).  ``peek_logits`` on phase 4's kernel engine (8 of
    phase 4's requests prefilled and decoded one block): no kernel
    launches, nothing advances, and each greedy lane's next token is the
    peek's arg-max or within ``NEAR_TIE_GAP`` of it (the peek reads the
    gather view, the step the kernel).  Then two lanes (one greedy, one at
    0.8) exported mid-stream from an engine of (c)'s arms and imported into
    another (c) engine, in another slot, which must continue both streams
    bit for bit, and into a kernel-arm engine, whose greedy lane must
    continue bit for bit or leave first at a near tie."""
    from tpudist_torch import ops
    from tpudist_torch.serve import SlotEngine

    _, reqs, _, _ = phase4_traffic(gen_seed)
    geo = dict(num_slots=SLOTS, prefill_pad=P, decode_block=8, kv_block=BS,
               device="cuda")
    gather = dict(attn_kernel="gather", prefill_kernel=True)

    def admit(eng, temps):
        """Phase 4's first 8 prompts (48 new tokens each), prefilled and
        decoded two blocks → the tokens so far, by slot."""
        out = {i: [] for i in range(SLOTS)}
        firsts = eng.start_batch([(i, reqs[i][0], temps[i], i, 48)
                                  for i in range(SLOTS)])
        while eng.prefilling_slots():
            firsts.update(eng.advance_prefill())
        for s, tok in firsts.items():
            out[s].append(tok)
        for _ in range(2):
            for s, toks in eng.decode_block()[1].items():
                out[s].extend(toks)
        return out

    kern = SlotEngine(model, **geo)
    admit(kern, [0.0] * SLOTS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    before = [t.clone() for t in kern.state] + [kern.cache.cursor.clone()]
    peek = kern.fns.peek_logits(kern.state, kern.cache)
    torch.cuda.synchronize()
    peek_launches = ops.launch_counts()
    if any(peek_launches.values()):
        raise AssertionError(f"peek_logits launched kernels: "
                             f"{peek_launches}")
    if not all(torch.equal(a, b) for a, b in zip(
            before, list(kern.state) + [kern.cache.cursor])):
        raise AssertionError("peek_logits advanced the engine")
    nxt = kern.decode_block(max_k=1)[1]
    top = peek.float().topk(2)
    peek_gaps = []
    for s, toks in nxt.items():
        gap = float(top.values[s, 0] - top.values[s, 1])
        if toks[0] != int(top.indices[s, 0]):
            peek_gaps.append((s, gap))
            if gap > NEAR_TIE_GAP:
                raise AssertionError(f"lane {s}: peek's arg-max "
                                     f"{int(top.indices[s, 0])} is not the "
                                     f"next token {toks[0]} (gap {gap:.4f})")
    del kern
    temps = [0.8 if i == 1 else 0.0 for i in range(SLOTS)]
    src = SlotEngine(model, **geo, **gather)
    pre = admit(src, temps)
    twin = SlotEngine(model, **geo, **gather)
    kdst = SlotEngine(model, **geo)
    moved = {0: 5, 1: 6}
    for slot, dslot in moved.items():
        adopt_lane(src, slot, twin, dslot)
        adopt_lane(src, slot, kdst, dslot)
    t0 = time.perf_counter()
    unbroken = finish_lanes(src, {})
    twin_out, kdst_out = finish_lanes(twin, {}), finish_lanes(kdst, {})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for slot, dslot in moved.items():
        if twin_out[dslot] != unbroken[slot]:
            raise AssertionError(f"lane {slot} imported into another engine "
                                 "of its arms does not continue its stream")
    g = 0
    equal_kernel = {slot: kdst_out[dslot] == unbroken[slot]
                    for slot, dslot in moved.items()}
    ties = []
    if not equal_kernel[g]:
        full = pre[g] + unbroken[g]
        got = pre[g] + kdst_out[moved[g]]
        j, gap = near_tie_gap(torch, model, reqs[g][0], got, full)
        ties.append((g, j, gap))
        if gap > NEAR_TIE_GAP:
            raise AssertionError(f"greedy lane {g} imported into the kernel "
                                 f"arm leaves its stream at token {j} "
                                 f"(gap {gap:.5f})")
    for e in (src, twin, kdst):
        if e.alloc.free_blocks != e.alloc.num_blocks:
            raise AssertionError("a lane's blocks were not released")
    return dict(peek_launches=peek_launches, peek_gaps=peek_gaps,
                exported_at=[len(pre[s]) for s in moved],
                continued_tokens=[len(unbroken[s]) for s in moved],
                twin_equal=True, kernel_equal=equal_kernel,
                kernel_near_ties=ties, continuation_wall_s=wall)


def log_default_arms(runs: dict, held: dict, base: dict, lanes: dict,
                     card: str) -> None:
    for name, r in runs.items():
        equal, ties = held[name]
        knobs = ", ".join(f"{k}={v}" for k, v in r["knobs"].items())
        log(f"phase 4g {name} ({knobs}): "
            f"{r['requests']} requests, {r['tokens']} tokens in "
            f"{r['wall_s']:.3f} s = {r['tokens_per_s']:.1f} tokens/s, TTFT "
            f"p50 {r['ttft_p50_ms']:.2f} ms, TPOT p50 {r['tpot_p50_ms']:.3f} "
            f"ms ({card}); phase 4 {base['tokens_per_s']:.1f} tokens/s, "
            f"TTFT p50 {base['ttft_p50_ms']:.2f} ms, TPOT p50 "
            f"{base['tpot_p50_ms']:.3f} ms; {r['steps']} decode steps, "
            f"{r['spec_blocks']} spec blocks, launches {r['launches']}; "
            f"greedy lanes equal to phase 4's {equal}, near ties {ties}")
    log(f"phase 4g e: peek_logits launches {lanes['peek_launches']}, lanes "
        f"off the peek's arg-max at near ties {lanes['peek_gaps']}; lanes "
        f"exported after {lanes['exported_at']} tokens continue "
        f"{lanes['continued_tokens']} tokens bit for bit in another (c) "
        f"engine; in the kernel arm equal {lanes['kernel_equal']}, near ties "
        f"{lanes['kernel_near_ties']}")


def device_profile(torch, fn, prep):
    """``fn`` timed plain (host clock to a synchronize, after ``prep``) and
    once under ``torch.profiler`` for the device's kernel time; the idle
    share is 1 - kernel time / profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prep()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    # device kernels only: a user annotation (torch.optim's
    # ``Optimizer.step#Adam.step``) spans kernels that are counted already.
    # The raw kineto events: ``prof.events()`` first builds every CPU op's
    # event and their tree, seconds for a window of 40,000 launches
    kern = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]
    by_name = {}
    for e in kern:
        name = torch._C._demangle(e.name())
        by_name[name] = by_name.get(name, 0.0) + e.duration_ns() / 1e6
    busy = sum(by_name.values())
    return dict(
        wall_ms=wall, profiled_wall_ms=prof_wall,
        device_busy_ms=busy if kern else None,
        idle_share=(1 - busy / prof_wall) if kern else None,
        device_events=len(kern),
        top=sorted(by_name.items(), key=lambda kv: -kv[1])[:6])


def log_profile(prof: dict) -> None:
    for name, r in prof.items():
        log(f"profile {name}: wall {r['wall_ms']:.3f} ms (profiled "
            f"{r['profiled_wall_ms']:.3f} ms), device busy "
            f"{r['device_busy_ms']} ms, idle share {r['idle_share']} "
            f"({r['device_events']} device events)")
        for kname, ms in r["top"]:
            log(f"  {ms:9.4f} ms  {kname[:110]}")


def profile_engine(torch, model, factors=None):
    """Where the time goes: one admission prefill (8 lanes x 60 tokens) and
    one K=8 decode block over 8 busy lanes (:func:`device_profile`).  With
    ``factors`` (name → factor set), the adapter path: ``fused_rope``,
    ``adapters`` and ``lora_kernel`` on, lanes naming ``ADAPTER_NAMES``."""
    import numpy as np

    from tpudist_torch.serve import SlotEngine

    on = factors is not None
    eng = SlotEngine(model, num_slots=SLOTS, prefill_pad=P, decode_block=8,
                     kv_block=BS, fused_rope=on, adapters=on,
                     lora_kernel=on, device="cuda")
    for name, f in (factors or {}).items():
        eng.load_adapter(name, f)
    rng = np.random.default_rng(3)

    def clear():
        for s in range(SLOTS):
            if eng.occupied[s]:
                eng.evict(s)

    def admit():
        eng.start_batch([(s, rng.integers(0, V, size=60), 0.0, 0, 200, (),
                          None, ADAPTER_NAMES[s % len(ADAPTER_NAMES)]
                          if on else None) for s in range(SLOTS)])

    admit()  # warm both programs
    eng.decode_block()
    out = {"prefill": device_profile(torch, admit, clear)}
    out["decode_block"] = device_profile(torch, eng.decode_block,
                                         lambda: None)
    clear()
    return out


def profile_spec_block(torch, model) -> dict:
    """Phase 5c: one speculative block (``draft_propose`` of the tied
    4-layer draft + ``spec_verify``, K = 4) over 8 busy lanes at ~60 tokens
    of context under ``torch.profiler`` (:func:`device_profile`), with the
    tokens it emitted."""
    import numpy as np

    from tpudist_torch.serve import SlotEngine

    eng = SlotEngine(model, num_slots=SLOTS, prefill_pad=P, decode_block=8,
                     kv_block=BS, spec_draft=LAYERS // 2, spec_k=SPEC_K,
                     device="cuda")
    rng = np.random.default_rng(3)
    eng.start_batch([(s, rng.integers(0, V, size=60), 0.0, 0, 200)
                     for s in range(SLOTS)])
    eng.spec_decode_block()  # warm
    emitted = []

    def block():
        info, _ = eng.spec_decode_block()
        emitted.append(info["tokens"])

    prof = device_profile(torch, block, lambda: None)
    prof.update(emitted_tokens=emitted[-1], wall_emitted_tokens=emitted[0],
                device_ms_per_token=(prof["device_busy_ms"] / emitted[-1]
                                     if prof["device_busy_ms"] else None),
                wall_ms_per_token=prof["wall_ms"] / emitted[0])
    for s in range(SLOTS):
        eng.evict(s)
    return prof


def prompt_logits(torch, model, prompt, factors=None):
    """All of ``prompt``'s logits through the paged prefill path (two
    chunks: the second walks the first one's committed blocks).  With
    ``factors``, one adapter lane through the fused RoPE+QKV arm."""
    from tpudist_torch.models import PagedKVConfig, lora, make_slot_decode

    dev = model.tok_embed.device
    ads, acfg = None, None
    if factors is not None:
        acfg = lora.AdapterPoolConfig(1, int(factors["a_qkv"].shape[-1]))
        pool = lora.load_factors(lora.init_adapter_pool(model, acfg), 0,
                                 factors)
        ads = lora.pool_collection(pool, torch.zeros(1, dtype=torch.int32,
                                                     device=dev))
    nb = max(16, -(-len(prompt) // BS))
    fns = make_slot_decode(model, 1, P, PagedKVConfig(nb, BS, False),
                           fused_rope=factors is not None, adapters=acfg)
    pkv = fns.init_slots()
    rows = torch.full((1, M), nb, dtype=torch.int32, device=dev)
    rows[0, :nb] = torch.arange(nb, device=dev)
    out = []
    for start in range(0, len(prompt), P):
        chunk = prompt[start:start + P]
        toks = torch.zeros((1, P), dtype=torch.int32, device=dev)
        toks[0, :len(chunk)] = torch.as_tensor(chunk, device=dev)
        pkv, lg = fns.prefill_chunk(
            pkv, rows, torch.tensor([start], dtype=torch.int32, device=dev),
            torch.tensor([len(chunk)], dtype=torch.int32, device=dev), toks,
            torch.ones(1, dtype=torch.bool, device=dev), ads)
        out.append(lg[0, :len(chunk)].float().cpu())
    return torch.cat(out)


# ---------------------------------------------------------------------------
# phase 21: the serving mesh (data x model places folded onto the card)

#: phase 21's runs: (label, mesh, tp_overlap, knob family)
MESH_RUNS = (("a 1x2", "1x2", "off", "plain"),
             ("b 1x2 ring", "1x2", "ring", "plain"),
             ("c 2x2 ring", "2x2", "ring", "plain"),
             ("d 1x8", "1x8", "off", "plain"),
             ("e 2x2 dense", "2x2", "off", "dense"),
             ("f 1x2 adapters", "1x2", "off", "adapters"),
             ("g 1x2 spec", "1x2", "off", "spec"))
#: each family's knobs beside phase 4's server geometry: phase 4's kernel
#: arms, the dense arena (the gather arm), phase 4b's adapter server,
#: phase 4c's spec server
MESH_FAMILIES = {"plain": {}, "dense": dict(paged=False,
                                            attn_kernel="gather",
                                            prefill_kernel=False),
                 "adapters": dict(fused_rope=True, adapters=True,
                                  lora_kernel=True),
                 "spec": dict(spec=True, spec_k=SPEC_K)}
#: the kernels each place launches on its slice (attention places times the
#: unsharded run's launches), and those run once on gathered rows
MESH_SHARDED = ("fused_rope_qkv", "paged_attention", "paged_prefill")
MESH_ONCE = ("fused_sample", "fused_residual_prep")
#: the per-place kernel shapes phase 3 does not hold: kv heads a place at
#: 1x2 and at 1x8
MESH_PLACE_HEADS = (("place of 1x2", HEADS // 2), ("place of 1x8",
                                                    HEADS // 8))


def mesh_serve_run(torch, model, family: str, mesh=None, overlap="off",
                   factors=None) -> dict:
    """One phase 21 run: phase 4's requests (phase 4b's adapter names,
    phase 4c's spec-off and sampled lanes) on ``family``'s server, over
    ``mesh`` (None: unsharded), every request queued before the server
    starts so every run of a family runs the same schedule."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.serve import InferenceServer, ServeConfig

    knobs = MESH_FAMILIES[family]
    ad, spec = family == "adapters", family == "spec"
    rng = np.random.default_rng(7)
    if not ad:
        rng.integers(0, V, size=70)  # phase 4's warm-up prompt
    reqs = [(rng.integers(0, V, size=int(rng.integers(1, 301))),
             int(rng.integers(16, 65))) for _ in range(16)]
    names = [ADAPTER_NAMES[i % len(ADAPTER_NAMES)] if ad else None
             for i in range(16)]
    temps = [0.8 if spec and i in SAMPLED_LANES else 0.0 for i in range(16)]
    cfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                      prefill_pad=P, decode_block=8, kv_block=BS, mesh=mesh,
                      tp_overlap=overlap, **knobs)
    server = InferenceServer(model, cfg, device="cuda")
    eng = server.engine
    try:
        for name, f in (factors or {}).items():
            server.load_adapter(name, f)
        handles = [server.submit(
            p, max_new=n, temperature=t, seed=i, adapter=a,
            spec=(i not in SPEC_OFF_LANES) if spec else None)
            for i, ((p, n), t, a) in enumerate(zip(reqs, temps, names))]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        server.start()
        for h in handles:
            if not h.wait(900):
                raise AssertionError("request timed out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        arms = dict(
            decode_tc=ops.paged_attention.launches_tc,
            prefill=dict(tc=ops.paged_prefill_attention.launches_tc,
                         cc=ops.paged_prefill_attention.launches_cc),
            rope=dict(split=ops.fused_rope_qkv.launches_split,
                      wgmma=ops.fused_rope_qkv.launches_wgmma),
            lora_cluster=ops.lora_delta.launches_cluster,
            sample=prep_arm_launches(ops.fused_sample_prep),
            residual=prep_arm_launches(ops.fused_residual_prep))
        stats = server.stats()
        places = eng.places
        split = ((places.attn_places, places.wi_places)
                 if places is not None else (1, 1))
        draft_layers = eng.draft_model.n_layers if eng.spec else 0
    finally:
        server.close(60)
    for h, (_, n) in zip(handles, reqs):
        if h.finish_reason != "length" or len(h.tokens) != n:
            raise AssertionError(f"request {h.id}: {h.finish_reason}, "
                                 f"{len(h.tokens)}/{n} tokens")
    if stats["kv"]["paged"] and stats["kv"]["blocks_in_use"] != 0:
        raise AssertionError("KV pool did not drain")
    tokens = sum(len(h.tokens) for h in handles)
    return dict(
        streams=[h.tokens for h in handles], prompts=[p for p, _ in reqs],
        names=names, temps=temps, requests=len(handles), tokens=tokens,
        wall_s=wall, tokens_per_s=tokens / wall,
        ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
        tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles),
        launches=counts, arms=arms, decode=stats["decode"],
        spec_blocks=stats["spec"]["blocks"], spmd=stats["spmd"],
        split=split, family=family, draft_layers=draft_layers)


def mesh_launches_want(r: dict) -> dict:
    """A phase 21 run's launches from its own engine counters: each kernel
    a place runs on its slice once a layer of every forward that reaches
    it, at the attention places (``lora_delta``: the qkv delta a place of
    attention, the wi delta a place of ``wi``, the wo delta once); one
    sampling prep a target forward and a draft proposal, one residual prep
    a spec block."""
    knobs = MESH_FAMILIES[r["family"]]
    pa, pw = r["split"]
    d, L, dl = r["decode"], LAYERS, r["draft_layers"]
    tf, df = d["forwards"], d["draft_forwards"]
    td, dd = d["steps"], d["draft_decode_forwards"]
    paged = knobs.get("paged", True)
    spec = knobs.get("spec", False)
    return {
        "paged_attention": pa * (L * td + dl * dd) if paged else 0,
        "paged_prefill": pa * (L * (tf - td) + dl * (df - dd))
        if paged else 0,
        "fused_rope_qkv": pa * (L * tf + dl * df)
        if knobs.get("fused_rope") else 0,
        "lora_delta": (pa + pw + 1) * (L * tf + dl * df)
        if knobs.get("adapters") else 0,
        # a proposal is a draft decode forward of a spec block but its
        # last; a plain block's one draft pass samples nothing
        "fused_sample": tf + (dd - d["blocks"] if spec else 0),
        "fused_residual_prep": r["spec_blocks"]}


def hold_mesh_launches(label: str, r: dict, base: dict) -> dict:
    """Phase 21's launch gates: the launches of :func:`mesh_launches_want`
    (held on the unsharded run ``base`` of the family as well); where the
    run made the same forwards as ``base`` (every run but the spec
    server's, whose acceptance follows the card's rounding), each per-place
    kernel at the attention places times ``base``'s launches and the
    sampling and residual preps at ``base``'s; every launch on its planned
    arm."""
    pa, pw = r["split"]
    c, b = r["launches"], base["launches"]
    for run, name in ((base, "the unsharded run"), (r, label)):
        want = mesh_launches_want(run)
        bad = {k: (run["launches"][k], n) for k, n in want.items()
               if run["launches"][k] != n}
        if bad:
            raise AssertionError(f"{name}: launches (got, want) {bad} over "
                                 f"{run['decode']}, {run['spec_blocks']} "
                                 f"spec blocks")
    same = all(r["decode"][k] == base["decode"][k] for k in (
        "forwards", "steps", "draft_forwards", "draft_decode_forwards",
        "blocks"))
    if r["family"] != "spec" and not same:
        raise AssertionError(f"{label}: forwards {r['decode']} where the "
                             f"unsharded run made {base['decode']}")
    if same:
        for k in MESH_SHARDED + MESH_ONCE:
            n = b[k] * (pa if k in MESH_SHARDED else 1)
            if c[k] != n:
                raise AssertionError(f"{label}: {k} launched {c[k]} times, "
                                     f"want {n} (unsharded {b[k]})")
    a = r["arms"]
    d, L, dl = r["decode"], LAYERS, r["draft_layers"]
    decode_fw = L * d["steps"] + dl * d["draft_decode_forwards"]
    arms = planned_arms()
    if a["decode_tc"] != c["paged_attention"] or a["prefill"] != dict(
            tc=c["paged_prefill"], cc=0):
        raise AssertionError(f"{label}: paged launches off their arms: {a}")
    if c["fused_rope_qkv"] and a["rope"] != dict(
            split=pa * decode_fw, wgmma=c["fused_rope_qkv"] - pa * decode_fw):
        raise AssertionError(f"{label}: fused_rope_qkv's arms {a['rope']} "
                             f"of {c['fused_rope_qkv']} launches")
    if c["lora_delta"] and a["lora_cluster"] != (pa + pw + 1) * decode_fw:
        raise AssertionError(f"{label}: lora_delta's cluster arm served "
                             f"{a['lora_cluster']} of {c['lora_delta']}")
    hold_planned_arm("fused_sample_prep", a["sample"], c["fused_sample"],
                     arms["sample"])
    hold_planned_arm("fused_residual_prep", a["residual"],
                     c["fused_residual_prep"], arms["residual"])
    return dict(same_schedule_as_unsharded=same, **{
        k: c[k] for k in MESH_SHARDED + MESH_ONCE + ("lora_delta",)})


def mesh_kernel_readings(torch, dev) -> dict:
    """Phase 21's kernel checks at the per-place shapes phase 3 does not
    hold (``MESH_PLACE_HEADS``: 4 and 1 kv heads a place, MHA within the
    place): the paged decode (a decode step) and prefill (chunk 64) on
    their planned tensor-core arms, ``fused_rope_qkv`` on the place's
    column slice of qkv (decode and prefill, on the planned arm) and
    ``lora_delta`` on the B column slices of qkv and wi; each against its
    plain version, timed as in phase 3 beside its bound and, where one
    call computes the same function, that call."""
    import torch.nn.functional as F

    from tpudist_torch import ops
    from tpudist_torch.ops.fused_linear import (_rope_arm,
                                                fused_rope_qkv_reference,
                                                lora_delta_reference)
    from tpudist_torch.ops.paged_attention import paged_attention_reference
    from tpudist_torch.ops.paged_prefill import paged_prefill_reference

    gen = torch.Generator(device=dev).manual_seed(2121)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16
    out = {k: {} for k in ("paged_attention", "paged_prefill",
                           "fused_rope_qkv", "lora_delta")}
    d = HEADS * DH
    for label, hk in MESH_PLACE_HEADS:
        # paged decode: phase 3's timing cursors, fill 3 of an 8 window
        pos0, fill = DECODE_OFFS, [3] * SLOTS
        args = decode_inputs(torch, dev, gen, pos0, False, fill, n_kv=hk)
        args[0] = args[0][:, :hk].contiguous()
        live = sum(-(-p // BS) for p in pos0)
        ops.reset_launch_counts()
        got = ops.paged_attention(*args, layer=3)
        ref = paged_attention_reference(*args, layer=3)
        if ops.paged_attention.launches_tc != 1:
            raise AssertionError(f"{label} decode not on the split walk")
        keep = (torch.arange(M * BS + W, device=dev)[None]
                < torch.tensor(pos0, device=dev)[:, None])
        keep[:, M * BS:M * BS + fill[0] + 1] = True
        heads = f"{hk} kv head" + ("s" if hk > 1 else "")
        out["paged_attention"][f"decode, {label} ({heads})"] = dict(
            max_abs_err=close_bf16(torch, got, ref, v_max(args[2], args[4],
                                                          args[9])),
            ms=time_ms(torch, lambda: ops.paged_attention(*args, layer=3),
                       flush),
            plain_ms=time_ms(torch, lambda: paged_attention_reference(
                *args, layer=3), flush),
            library_ms=time_ms(torch, dense_sdpa(
                torch, args[0], *args[1:6], keep[:, None, None], args[8],
                args[9], 3), flush),
            bound=bound(2 * args[0].numel() * 2
                        + 2 * live * hk * BS * DH * 2 + live * 4 + SLOTS * 8
                        + 2 * args[8].numel() * 2,
                        4 * hk * DH * sum(p + f + 1
                                          for p, f in zip(pos0, fill)),
                        H100_BF16_FLOPS))
        # paged prefill: phase 3's chunked-prefill cursors, chunk 64
        pos0 = PREFILL_OFFS
        clen = [64, 64, 64, 37, 44, 64, 30, 12]
        args = prefill_inputs(torch, dev, gen, pos0, clen, False, n_kv=hk)
        args[0] = args[0][:, :hk].contiguous()
        ops.reset_launch_counts()
        got = ops.paged_prefill_attention(*args, layer=3)
        ref = paged_prefill_reference(*args, layer=3)
        if ops.paged_prefill_attention.launches_tc != 1:
            raise AssertionError(f"{label} prefill not on the tensor cores")
        for a, b in zip(got[1:], ref[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"{label} prefill's written blocks "
                                     "differ from the plain version's")
        wt = args[8]
        live = sum(-(-p // BS) for p in pos0)
        touched = int((wt < 1024).sum())
        kpos = torch.arange(M * BS + P, device=dev)
        p0 = torch.tensor(pos0, device=dev)[:, None, None]
        row = torch.arange(P, device=dev)[None, :, None]
        keep = torch.where(kpos < M * BS, kpos < p0, (kpos - M * BS) <= row)
        out["paged_prefill"][f"chunk 64, {label} ({heads})"] = dict(
            max_abs_err=close_bf16(torch, got[0], ref[0], v_max(
                args[4], args[6], args[2])),
            ms=time_ms(torch, lambda: ops.paged_prefill_attention(
                *args, layer=3), flush),
            plain_ms=time_ms(torch, lambda: paged_prefill_reference(
                *args, layer=3), flush),
            library_ms=time_ms(torch, dense_sdpa(
                torch, args[0], *args[3:8], keep[:, None], args[1], args[2],
                3), flush),
            bound=bound(2 * args[0].numel() * 2 + 2 * args[1].numel() * 2
                        + 2 * (live + touched) * hk * BS * DH * 2
                        + 2 * wt.numel() * hk * (BS * DH * 2 + 4)
                        + wt.numel() * 4 + (live + touched) * 4 + SLOTS * 8,
                        4 * hk * DH * sum(c * p + c * (c + 1) // 2
                                          for p, c in zip(pos0, clen)),
                        H100_BF16_FLOPS))
        # fused_rope_qkv on the place's qkv columns (hk q heads, hk kv
        # heads, depth d), with the adapter delta
        dt = 3 * hk * DH
        for what, T, offs in (("decode", 1, DECODE_OFFS),
                              ("prefill", P, PREFILL_OFFS)):
            args = qkv_inputs(torch, dev, gen, SLOTS, T, hk, hk, DH, bf16,
                              offs, d=d)
            kw = dict(n_heads=hk, n_kv=hk, dh=DH)
            rows = SLOTS * T
            ops.reset_launch_counts()
            got = ops.fused_rope_qkv(*args, **kw)
            ref = fused_rope_qkv_reference(*args, **kw)
            arm = _rope_arm(rows, DH, d, bf16)
            by_arm = dict(split=ops.fused_rope_qkv.launches_split,
                          wgmma=ops.fused_rope_qkv.launches_wgmma)
            if arm in by_arm and by_arm[arm] != 1:
                raise AssertionError(f"{label} {what} qkv not on the {arm} "
                                     f"arm: {by_arm}")
            err = max(linear_close(torch, g, r, "bf16",
                                   f"fused_rope_qkv {label} {what}")[
                "max_abs_err"] for g, r in zip(got, ref))
            wt = args[1].t()
            out["fused_rope_qkv"][f"{what}, {label} ({dt} columns)"] = dict(
                arm=arm, max_abs_err=err,
                ms=time_ms(torch, lambda: ops.fused_rope_qkv(*args, **kw),
                           flush),
                plain_ms=time_ms(torch, lambda: fused_rope_qkv_reference(
                    *args, **kw), flush),
                library_ms=time_ms(torch, lambda: F.linear(args[0], wt),
                                   flush),
                bound=bound(2 * (d * dt + rows * d + 2 * rows * dt)
                            + SLOTS * 8, 2 * rows * d * dt,
                            H100_BF16_FLOPS))
        # lora_delta on the B column slices (qkv's and wi's), decode
        m = HEADS // hk
        for what, d_out in (("qkv", dt), ("wi", MODEL["d_ff"] // m)):
            args = lora_inputs(torch, dev, gen, SLOTS, 1, d, d_out, bf16,
                               RANK, LORA_IDS)
            got = ops.lora_delta(*args, layer=3)
            ref = lora_delta_reference(*args, layer=3)
            blocks = len({min(i, 7) for i in LORA_IDS})
            out["lora_delta"][f"{what} decode, {label} ({d_out} columns)"] \
                = dict(
                max_abs_err=linear_close(torch, got, ref, "bf16",
                                         f"lora_delta {label} {what}")[
                    "max_abs_err"],
                ms=time_ms(torch, lambda: ops.lora_delta(*args, layer=3),
                           flush),
                plain_ms=time_ms(torch, lambda: lora_delta_reference(
                    *args, layer=3), flush),
                library_ms=None,
                bound=bound(2 * SLOTS * (d + d_out) + SLOTS * 4
                            + blocks * RANK * (d + d_out) * 4,
                            2 * SLOTS * RANK * (d + d_out),
                            H100_BF16_FLOPS))
    del flush
    ops.reset_launch_counts()
    for name, shapes in out.items():
        for label, t in shapes.items():
            log(f"  kernel {name} at {label}: max_abs_err "
                f"{t['max_abs_err']:.3g}, {t['ms']:.4f} ms (plain "
                f"{t['plain_ms']:.4f} ms, library {t['library_ms']} ms, "
                f"bound {t['bound'][0]:.5f} ms by {t['bound'][1]})")
    return out


def serve_mesh_path(torch, model, main_path: dict, ad_streams, card: str
                    ) -> dict:
    """Phase 21: phase 4's model served over ``data x model`` places
    folded onto the card (``MESH_RUNS``), each run against the unsharded
    run of its family on the same schedule.  Gates: greedy lanes equal
    phase 4's streams (phase 4b's on the adapter server) or leave them
    first at a near tie (:func:`hold_greedy_streams`); the launches of
    :func:`hold_mesh_launches`; the pool drained; the parameter bytes a
    place below the total.  Then the kernels at the per-place shapes
    (:func:`mesh_kernel_readings`) and the hybrid mesh of this one-process
    job (:func:`~tpudist_torch.runtime.mesh.make_hybrid_mesh`, equal to
    ``make_mesh``)."""
    from tpudist_torch.runtime.mesh import (MeshConfig, make_hybrid_mesh,
                                            make_mesh)

    t0 = time.perf_counter()
    factors = adapter_factors(torch, model)
    base = {fam: mesh_serve_run(torch, model, fam,
                                factors=factors if fam == "adapters"
                                else None)
            for fam in MESH_FAMILIES}
    runs, held = {}, {}
    for label, mesh, overlap, fam in MESH_RUNS:
        r = mesh_serve_run(torch, model, fam, mesh, overlap,
                           factors if fam == "adapters" else None)
        gc.collect()
        torch.cuda.empty_cache()
        ref = ad_streams if fam == "adapters" else main_path["streams"]
        greedy = [i for i in range(16) if r["temps"][i] == 0.0]
        equal, ties = hold_greedy_streams(
            torch, model, r["prompts"], r["streams"], ref, greedy,
            factors if fam == "adapters" else None,
            r["names"] if fam == "adapters" else None)
        want = hold_mesh_launches(label, r, base[fam])
        sp = r["spmd"]
        if not sp["param_bytes_per_device"] < sp["param_bytes_total"]:
            raise AssertionError(f"{label}: spmd_stats {sp}")
        same_as_unsharded = sum(a == b for a, b in zip(
            r["streams"], base[fam]["streams"]))
        held[label] = dict(greedy_lanes_equal=f"{equal}/{len(greedy)}",
                           near_ties=ties, launches_held=want,
                           lanes_equal_unsharded=f"{same_as_unsharded}/16")
        runs[label] = {k: v for k, v in r.items()
                       if k not in ("streams", "prompts", "names", "temps")}
        log(f"phase 21 {label}: {r['tokens']} tokens in {r['wall_s']:.3f} s"
            f" = {r['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{r['ttft_p50_ms']:.2f} ms, TPOT p50 {r['tpot_p50_ms']:.3f} ms "
            f"(unsharded {base[fam]['tokens_per_s']:.1f} tokens/s, "
            f"{base[fam]['ttft_p50_ms']:.2f} / "
            f"{base[fam]['tpot_p50_ms']:.3f} ms; phase 4 "
            f"{main_path['tokens_per_s']:.1f} tokens/s) ({card}); greedy "
            f"lanes equal {held[label]['greedy_lanes_equal']}, near ties "
            f"{ties}; lanes equal to the unsharded run "
            f"{held[label]['lanes_equal_unsharded']}; launches {want}; "
            f"spmd {sp}")
    kernels = mesh_kernel_readings(torch, torch.device("cuda"))
    hybrid = make_hybrid_mesh(MeshConfig(), device="cuda")
    if hybrid != make_mesh(MeshConfig(), device="cuda"):
        raise AssertionError("the hybrid mesh of a one-process job is not "
                             "make_mesh's")
    wall = time.perf_counter() - t0
    log(f"phase 21 wall: {wall:.1f} s; make_hybrid_mesh at world 1 equals "
        f"make_mesh ({hybrid.shape})")
    return dict(runs=runs, held=held, kernels=kernels, wall_s=wall,
                unsharded={fam: {k: v for k, v in r.items()
                                 if k not in ("streams", "prompts", "names",
                                              "temps")}
                           for fam, r in base.items()},
                plain_streams=base["plain"]["streams"])


# ---------------------------------------------------------------------------
# phases 7-9: the training main path, its profile, gradients vs plain f32


def train_main_path(torch):
    """Phase 7: ``TRAIN_STEPS`` steps of ``tpudist_torch.train`` on the
    training geometry, every kernel count zeroed just before."""
    from tpudist_torch import ops
    from tpudist_torch.train.__main__ import build_training, get_args
    from tpudist_torch.utils.flops import (mfu, transformer_param_count,
                                           transformer_train_flops)

    args = get_args(TRAIN_ARGS + ["--total_iterations", str(TRAIN_STEPS)])
    model, step, next_batch = build_training(args)
    batches = [torch.from_numpy(next_batch()).cuda()
               for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times = [], []
    for tokens in batches:
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = ops.launch_counts()
    wgmma = {n: ops.KERNEL_WRAPPERS[n].launches_wgmma for n in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[TRAIN_WARMUP:])
    geom = dict(d_model=args.d_model, n_layers=args.n_layers,
                d_ff=args.d_ff, vocab=args.vocab)
    flops = transformer_train_flops(batch=args.batch_size,
                                    seq_len=args.seq_len, **geom)
    res = dict(
        steps=TRAIN_STEPS, first_loss=losses[0], last_loss=losses[-1],
        last5_mean=statistics.mean(losses[-5:]), losses=losses,
        step_ms_p50=step_s * 1e3, step_ms=[t * 1e3 for t in times],
        tokens_per_s=args.batch_size * args.seq_len / step_s,
        flops_per_step=flops,
        mfu=mfu(flops, step_s, 1, peak_per_chip=H100_BF16_FLOPS),
        params=transformer_param_count(max_len=args.seq_len, **geom),
        peak_mem_gb=peak / 1e9, launches=counts, launches_wgmma=wgmma)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if res["last5_mean"] > losses[0] - 0.1:
        raise AssertionError(
            f"loss did not fall 0.1 nat: first {losses[0]:.4f}, mean of the "
            f"last 5 {res['last5_mean']:.4f}")
    per_step = args.n_layers * TRAIN_STEPS
    for name in TRAIN_KERNELS:
        if counts[name] != per_step:
            raise AssertionError(f"{name} launched {counts[name]} times, not "
                                 f"{per_step} (8 layers x {TRAIN_STEPS})")
    for name, n in wgmma.items():
        if n != per_step:
            raise AssertionError(f"{name} ran {n} of its {per_step} launches "
                                 f"on the wgmma arm")
    return res, step, batches[0]


class PlainCausal:
    """The training attention arm without kernels, for the card's f32 plain
    path: dense causal softmax with K/V broadcast to every q head (q and k
    rotated first for a RoPE model)."""

    def __init__(self, rope: bool = False):
        self.rope = rope

    def positions(self, batch, seq, device):
        import torch

        return torch.arange(seq, device=device)[None].expand(batch, seq)

    def attend(self, layer, q, k, v, rotated: bool = False):
        from tpudist_torch.models.transformer import (attention_reference,
                                                      rope_rotate)

        if self.rope and not rotated:
            q, k = rope_rotate(q), rope_rotate(k)
        group = q.shape[1] // k.shape[1]
        if group > 1:
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        return attention_reference(q, k, v, causal=True)


def grad_readings(torch, bf16_ctx=None) -> dict:
    """Loss and gradients at batch 2 of the training geometry, the bf16 path
    (the kernels, or ``bf16_ctx``'s attention) against the f32 plain path,
    same weights (seed 0): the loss's relative difference and the worst
    cosine over the parameters."""
    import numpy as np

    from tpudist_torch.models import create_transformer, lm_loss
    from tpudist_torch.train.__main__ import make_batch

    cfg = dict(vocab=256, d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
               max_len=2048)
    tokens = torch.from_numpy(make_batch(np.random.default_rng(5), 2, 2048,
                                         256)).cuda()
    res = {}
    for label, dtype, ctx in (("bf16", torch.bfloat16, bf16_ctx),
                              ("f32_plain", torch.float32, PlainCausal())):
        model = create_transformer(0, device="cuda", dtype=dtype,
                                   param_dtype=torch.float32,
                                   trainable=True, **cfg)
        loss = lm_loss(model(tokens, ctx), tokens)
        loss.backward()
        res[label] = (loss.item(), {n: p.grad.detach().float()
                                    for n, p in model.named_parameters()})
        del model, loss
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = res["bf16"], res["f32_plain"]
    cos = {n: float(torch.nn.functional.cosine_similarity(
        gk[n].flatten(), gp[n].flatten(), dim=0)) for n in gp}
    worst = min(cos, key=cos.get)
    return dict(loss_bf16_kernels=lk, loss_f32_plain=lp,
                loss_rel_diff=abs(lk - lp) / abs(lp), min_cos=cos[worst],
                min_cos_param=worst, params=len(cos))


def grads_agree(out: dict) -> bool:
    return out["loss_rel_diff"] <= LOSS_REL_MAX and \
        out["min_cos"] >= GRAD_COS_MIN


def grad_check(torch):
    """Phase 9: :func:`grad_readings` of the kernels, held to
    ``GRAD_COS_MIN`` and ``LOSS_REL_MAX``."""
    out = grad_readings(torch)
    if not grads_agree(out):
        raise AssertionError(f"bf16 kernel gradients disagree with the f32 "
                             f"plain path: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 16: public configurations' attention widths, end to end


def public_train_flops(m: dict) -> float:
    """Matmul FLOPs of one phase-16 train step (``transformer_train_flops``'
    terms with the qkv product at the config's KV width): per block qkv
    ``2·b·s·d·(d + 2·kv)``, proj ``2·b·s·d²``, attention ``4·pairs·d``,
    FFN ``4·b·s·d·f``; the head ``2·b·s·d·V``; train = 3x forward."""
    from tpudist_torch.utils.flops import attention_live_pairs

    b, s, d, f = PUBLIC_BATCH, PUBLIC_SEQ, m["d_model"], m["d_ff"]
    kv = m["n_kv_heads"] * d // m["n_heads"]
    block = (2 * b * s * d * (d + 2 * kv) + 2 * b * s * d * d
             + 4.0 * b * attention_live_pairs(s, causal=True) * d
             + 4 * b * s * d * f)
    return 3.0 * (m["n_layers"] * block + 2 * b * s * d * m["vocab"])


def public_train(torch, cfg: dict, card: str) -> tuple:
    """Phase 16's training run: ``tpudist_torch.train``'s model and step
    (phase 7's: bf16 over f32 masters, Adam 3e-4) at ``cfg``'s widths with
    RoPE, batch 2 x seq 2048.  First one batch's loss and gradients through
    the flash kernels against the same batch through the plain attention
    on the card (``grads_agree``: phase 9's bounds); then ``PUBLIC_STEPS``
    steps, every flash count zeroed just before: losses finite and the last
    below the first, each kernel launched once a layer and step.  Returns
    ``(readings, the trained model)``."""
    from tpudist_torch import ops
    from tpudist_torch.models import lm_loss
    from tpudist_torch.train.__main__ import build_training, get_args

    m = cfg["model"]
    args = get_args([
        "--device", "cuda", "--seq_len", str(PUBLIC_SEQ), "--vocab",
        str(m["vocab"]), "--d_model", str(m["d_model"]), "--n_layers",
        str(m["n_layers"]), "--n_heads", str(m["n_heads"]), "--n_kv_heads",
        str(m["n_kv_heads"]), "--d_ff", str(m["d_ff"]), "--batch_size",
        str(PUBLIC_BATCH), "--precision", "bf16", "--lr", "3e-4", "--seed",
        "0", "--rope", "--total_iterations", str(PUBLIC_STEPS)])
    t0 = time.perf_counter()
    model, step, next_batch = build_training(args)
    batches = [torch.from_numpy(next_batch()).cuda()
               for _ in range(PUBLIC_STEPS)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    grads, losses = {}, {}
    for label, ctx in (("kernels", None), ("plain", PlainCausal(rope=True))):
        model.zero_grad(set_to_none=True)
        loss = lm_loss(model(batches[0], ctx), batches[0])
        loss.backward()
        losses[label] = float(loss)
        grads[label] = {n: q.grad.detach().float().clone()
                        for n, q in model.named_parameters()}
        del loss
    model.zero_grad(set_to_none=True)
    cos = {n: float(torch.nn.functional.cosine_similarity(
        grads["kernels"][n].flatten(), grads["plain"][n].flatten(), dim=0))
        for n in grads["plain"]}
    worst = min(cos, key=cos.get)
    gcheck = dict(loss_kernels=losses["kernels"],
                  loss_plain=losses["plain"],
                  loss_rel_diff=abs(losses["kernels"] - losses["plain"])
                  / abs(losses["plain"]),
                  min_cos=cos[worst], min_cos_param=worst, params=len(cos))
    del grads
    torch.cuda.empty_cache()
    if not grads_agree(gcheck):
        raise AssertionError(f"phase {cfg['phase']}: the kernel gradients "
                             f"disagree with the plain attention's: {gcheck}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times, train_losses = [], []
    for tokens in batches:
        t1 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        train_losses.append(float(loss))
    counts = {n: ops.KERNEL_WRAPPERS[n].launches for n in TRAIN_KERNELS}
    wgmma = {n: ops.KERNEL_WRAPPERS[n].launches_wgmma for n in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[PUBLIC_WARMUP:])
    flops = public_train_flops(m)
    res = dict(
        steps=PUBLIC_STEPS, losses=train_losses, step_ms=[t * 1e3
                                                          for t in times],
        step_ms_p50=step_s * 1e3,
        tokens_per_s=PUBLIC_BATCH * PUBLIC_SEQ / step_s,
        flops_per_step=flops, mfu=flops / step_s / H100_BF16_FLOPS,
        peak_mem_gb=peak / 1e9, build_s=build_s, grads=gcheck,
        launches={n: dict(mma=counts[n] - wgmma[n], wgmma=wgmma[n])
                  for n in TRAIN_KERNELS},
        params=sum(q.numel() for q in model.parameters()))
    if not all(math.isfinite(x) for x in train_losses):
        raise AssertionError(f"phase {cfg['phase']}: non-finite training "
                             f"loss: {train_losses}")
    if not train_losses[-1] < train_losses[0]:
        raise AssertionError(f"phase {cfg['phase']}: the loss did not fall: "
                             f"{train_losses}")
    per_run = m["n_layers"] * PUBLIC_STEPS
    if any(n != per_run for n in counts.values()):
        raise AssertionError(f"phase {cfg['phase']}: flash launches "
                             f"{counts}, want {per_run} each")
    log(f"phase {cfg['phase']} ({cfg['name']} widths, {m['n_layers']} of "
        f"{cfg['layers']} layers) training: loss {train_losses[0]:.4f} -> "
        f"{train_losses[-1]:.4f} over {PUBLIC_STEPS} steps; step p50 "
        f"{res['step_ms_p50']:.2f} ms = {res['tokens_per_s']:.0f} tokens/s, "
        f"MFU {res['mfu']:.4f} of 989 TFLOP/s, peak memory "
        f"{res['peak_mem_gb']:.2f} GB ({card}); flash launches by arm "
        f"{res['launches']}; gradients against the plain attention: loss "
        f"rel {gcheck['loss_rel_diff']:.2e}, min cosine "
        f"{gcheck['min_cos']:.6f} ({gcheck['min_cos_param']}); "
        f"{res['params'] / 1e9:.3f} G parameters, model and batches built "
        f"in {build_s:.1f} s")
    del step
    return res, model


def merged_adapter(torch, model, factors):
    """Fold an adapter's ``(A·B)ᵀ`` into ``model``'s qkv, wi and wo weights
    in place (f32 sums, rounded to the weights' dtype); returns the
    originals for :func:`restore_weights`."""
    saved = {}
    with torch.no_grad():
        for layer, blk in enumerate(model.blocks):
            for proj in ("qkv", "wi", "wo"):
                w = getattr(blk, proj)
                saved[(layer, proj)] = w.detach().clone()
                a = factors[f"a_{proj}"][layer].to(w.device)
                b = factors[f"b_{proj}"][layer].to(w.device)
                w.copy_((w.float() + (a @ b).t()).to(w.dtype))
    return saved


def restore_weights(torch, model, saved) -> None:
    with torch.no_grad():
        for (layer, proj), w in saved.items():
            getattr(model.blocks[layer], proj).copy_(w)


def public_serve(torch, cfg: dict, trained, card: str) -> dict:
    """Phase 16's serving run on the trained weights in bf16:
    ``InferenceServer`` with ``fused_rope``, ``adapters`` and
    ``lora_kernel`` on and four adapters of ``cfg``'s rank loaded,
    ``PUBLIC_REQUESTS`` greedy requests naming ``PUBLIC_NAMES``, every
    count zeroed just before.  Gates: every request finishes "length";
    ``fused_rope_qkv`` once and ``lora_delta`` three times a layer and
    forward; at a head dim the tensor-core arms take, every paged decode
    and prefill launch on them; each lane's stream equal to the port's
    dense sequential ``generate`` on the same card and weights (the lane's
    adapter merged into them), or first leaving it at a near tie of the
    served path's logits (:func:`near_tie_gap`, ``NEAR_TIE_GAP``)."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.models import TransformerLM
    from tpudist_torch.models.generate import generate
    from tpudist_torch.models.lora import make_adapter_factors
    from tpudist_torch.ops import fused_rope_qkv, lora_delta
    from tpudist_torch.ops.paged_attention import TC_HEAD_DIMS
    from tpudist_torch.serve import InferenceServer, ServeConfig

    m = cfg["model"]
    with torch.device("cuda"):
        model = TransformerLM(dtype=torch.bfloat16, max_len=PUBLIC_SEQ,
                              rope=True, **m)
    model.load_state_dict(trained.state_dict())
    model.requires_grad_(False)
    del trained
    torch.cuda.empty_cache()
    rank, L = cfg["rank"], m["n_layers"]
    factors = {f"a{i}": make_adapter_factors(
        torch.Generator().manual_seed(160 + i), model, rank)
        for i in range(4)}
    rng = np.random.default_rng(16)
    reqs = [(rng.integers(0, m["vocab"], size=int(rng.integers(1, 301))),
             int(rng.integers(16, 33))) for _ in range(PUBLIC_REQUESTS)]
    scfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                       prefill_pad=P, decode_block=8, kv_block=BS,
                       fused_rope=True, adapters=True, lora_kernel=True,
                       adapter_blocks=4, adapter_rank=rank)
    server = InferenceServer(model, scfg, device="cuda").start()
    try:
        for name, f in factors.items():
            server.load_adapter(name, f)
        warm = server.submit(rng.integers(0, m["vocab"], size=70),
                             max_new=9, adapter="a0")
        if not warm.wait(600) or warm.finish_reason != "length":
            raise AssertionError("warm-up request did not finish")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        fw0 = server.engine.n_forwards
        t0 = time.perf_counter()
        handles = [server.submit(p, max_new=n, adapter=a)
                   for (p, n), a in zip(reqs, PUBLIC_NAMES)]
        for h in handles:
            if not h.wait(900):
                raise AssertionError("request timed out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        forwards = server.engine.n_forwards - fw0
        arms = dict(
            paged_attention=dict(tc=ops.paged_attention.launches_tc,
                                 cc=counts["paged_attention"]
                                 - ops.paged_attention.launches_tc),
            paged_prefill=dict(tc=ops.paged_prefill_attention.launches_tc,
                               cc=ops.paged_prefill_attention.launches_cc),
            fused_sample=prep_arm_launches(ops.fused_sample_prep),
            fused_rope_qkv=dict(
                split=fused_rope_qkv.launches_split,
                wgmma=fused_rope_qkv.launches_wgmma,
                mma=counts["fused_rope_qkv"] - fused_rope_qkv.launches_split
                - fused_rope_qkv.launches_wgmma),
            lora_delta=dict(cluster=lora_delta.launches_cluster,
                            staged=counts["lora_delta"]
                            - lora_delta.launches_cluster))
        stats = server.stats()
    finally:
        server.close(60)
    for h, (_, n) in zip(handles, reqs):
        if h.finish_reason != "length" or len(h.tokens) != n:
            raise AssertionError(f"request {h.id}: {h.finish_reason}, "
                                 f"{len(h.tokens)}/{n} tokens")
    if stats["kv"]["blocks_in_use"] != 0:
        raise AssertionError("KV pool did not drain")
    c = counts
    if c["fused_rope_qkv"] != L * forwards or \
            c["lora_delta"] != 3 * L * forwards:
        raise AssertionError(
            f"{forwards} forwards of {L} layers launched fused_rope_qkv "
            f"{c['fused_rope_qkv']} and lora_delta {c['lora_delta']} times")
    if not all(c[name] > 0 for name in SERVE_KERNELS):
        raise AssertionError(f"a serving kernel was not launched: {c}")
    dh = m["d_model"] // m["n_heads"]
    if dh in TC_HEAD_DIMS and (arms["paged_attention"]["cc"]
                               or arms["paged_prefill"]["cc"]):
        raise AssertionError(f"head dim {dh}: a paged launch left the "
                             f"tensor cores: {arms}")
    # the reference: the dense sequential generate, one lane at a time,
    # the lane's adapter merged into the weights
    equal, ties = 0, []
    t1 = time.perf_counter()
    for i, ((prompt, n), name) in enumerate(zip(reqs, PUBLIC_NAMES)):
        saved = (merged_adapter(torch, model, factors[name])
                 if name is not None else None)
        want = generate(model, torch.as_tensor(prompt[None], device="cuda"),
                        n)[0, len(prompt):].tolist()
        if saved is not None:
            restore_weights(torch, model, saved)
        got = handles[i].tokens
        if got == want:
            equal += 1
            continue
        j, gap = near_tie_gap(torch, model, prompt, got, want,
                              None if name is None else factors[name])
        ties.append((i, j, gap))
        log(f"  lane {i} ({name or 'base'}) first leaves generate at token "
            f"{j}: top-2 logit gap {gap:.5f} (bound {NEAR_TIE_GAP})")
        if gap > NEAR_TIE_GAP:
            raise AssertionError(
                f"phase {cfg['phase']}: lane {i} leaves the sequential "
                f"generate at token {j} where the top-2 gap {gap:.5f} is "
                f"no near tie")
    ref_s = time.perf_counter() - t1
    tokens = sum(len(h.tokens) for h in handles)
    res = dict(
        requests=len(handles), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall,
        ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
        tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles),
        forwards=forwards, launches=counts, arms=arms, rank=rank,
        prompt_lens=[len(p) for p, _ in reqs], names=list(PUBLIC_NAMES),
        lanes_equal_generate=equal, near_ties=ties, reference_s=ref_s)
    log(f"phase {cfg['phase']} ({cfg['name']} widths) serving, rank "
        f"{rank} adapters on lanes {[i for i, a in enumerate(PUBLIC_NAMES) if a]}"
        f": {res['requests']} requests, {tokens} tokens in {wall:.3f} s = "
        f"{res['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{res['ttft_p50_ms']:.2f} ms, TPOT p50 {res['tpot_p50_ms']:.3f} ms "
        f"({card}); launches by arm {arms}; lanes equal to the sequential "
        f"generate {equal}/{len(handles)}, near ties {ties} (references "
        f"{ref_s:.1f} s)")
    return res


def public_widths_path(torch, card: str) -> dict:
    """Phase 16: for each of ``PUBLIC_CONFIGS``, :func:`public_train` then
    :func:`public_serve` on the trained weights."""
    out = {}
    for cfg in PUBLIC_CONFIGS:
        t0 = time.perf_counter()
        train, trained = public_train(torch, cfg, card)
        serve = public_serve(torch, cfg, trained, card)
        del trained
        torch.cuda.empty_cache()
        out[cfg["phase"]] = dict(
            name=cfg["name"], source=cfg["source"], model=cfg["model"],
            layers_of=cfg["layers"], not_modelled=cfg["not_modelled"],
            train=train, serve=serve, wall_s=time.perf_counter() - t0)
        log(f"phase {cfg['phase']} wall: {out[cfg['phase']]['wall_s']:.1f} "
            f"s")
    return out


# ---------------------------------------------------------------------------
# phase 17: sequence parallelism — the ring on the flash kernels


def ring_launches(n: int, causal: bool, window, shard: int,
                  zigzag: bool = False) -> int:
    """Flash launches of one ring forward over ``n`` local shards (each of
    the backward's dq and dk/dv kernels launches as often): a launch per
    shard and live hop.  Causal: the diagonal hops plus, at hop t, the
    ``n - t`` shards whose block comes from the past, until a window's band
    leaves every shard; zigzag: one launch per shard and hop."""
    if zigzag or not causal:
        return n * n
    total = n
    for step in range(1, n):
        if window is not None and window - step * shard <= -(shard - 1):
            break
        total += n - step
    return total


def ring_case(torch, gen, case) -> dict:
    """One ``RING_CASES`` case: the ring's forward and backward over 4
    local shards on the flash kernels, its launches counted (counts zeroed
    just before), held against the single-call flash attention of phase 3b
    over the whole sequence and against the plain carry body on the same
    inputs (:func:`flash_agreement`'s bounds: the bf16 output's over max|V|,
    the bf16 gradients'), and timed forward + backward beside the single
    call."""
    from tpudist_torch import ops
    from tpudist_torch.ops import FlashAttention
    from tpudist_torch.parallel import (LocalRing, make_ring_attention,
                                        make_zigzag_ring_attention,
                                        zigzag_indices)

    name, layout, causal, window, inner, h_kv = case
    b, h, s, n = RING_B, RING_H, RING_S, RING_SHARDS
    if inner is not None and (layout != "ring" or window is not None):
        raise ValueError(f"phase 17 {name}: inner_block is checked on the "
                         f"plain causal ring only")
    q, g = (torch.randn(b, h, s, DH, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    k, v = (torch.randn(b, h_kv, s, DH, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    vmax = float(v.float().abs().max())
    ring = LocalRing(n)
    if layout == "zigzag":
        pi = torch.as_tensor(zigzag_indices(s, n), device="cuda").long()
        attn = make_zigzag_ring_attention(ring)
        plain = make_zigzag_ring_attention(ring, kernel="xla")
    else:
        pi = torch.arange(s, device="cuda")
        attn = make_ring_attention(ring, causal=causal, window=window)
        plain = make_ring_attention(ring, causal=causal, window=window,
                                    inner_block=inner, kernel="xla")
    qp, kp, vp, gp = (t[:, :, pi].contiguous() for t in (q, k, v, g))

    def run(fn, *ts, cot):
        leaves = [t.detach().requires_grad_(True) for t in ts]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, cot))

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = run(attn, qp, kp, vp, cot=gp)
    torch.cuda.synchronize()
    counts = {k_: v_ for k_, v_ in ops.launch_counts().items() if v_}
    want_n = ring_launches(n, causal, window, s // n, layout == "zigzag")
    res = dict(case=name, launches=counts, expected_launches=want_n)
    if counts != {kn: want_n for kn in TRAIN_KERNELS}:
        raise AssertionError(f"phase 17 {name}: launches {counts}, not "
                             f"{want_n} of each flash kernel")
    if inner is not None:
        # the kernel body's tiles already bound the score memory, so
        # inner_block only checks that it divides the shard
        ops.reset_launch_counts()
        again = run(make_ring_attention(ring, causal=causal,
                                        inner_block=inner),
                    qp, kp, vp, cot=gp)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        res["inner_block"] = dict(inner_block=inner, bit_for_bit=same,
                                  launches={k_: v_ for k_, v_ in
                                            ops.launch_counts().items()
                                            if v_})
        del again
        if not same or res["inner_block"]["launches"] != counts:
            raise AssertionError(f"phase 17 {name}: inner_block {inner} "
                                 f"changed the kernel ring: "
                                 f"{res['inner_block']}")

    def single(q_, k_, v_):
        return FlashAttention.apply(q_, k_, v_, causal, window)[0]

    ref = [t[:, :, pi] for t in run(single, q, k, v, cot=g)]
    res["vs_single_call"] = {
        t: flash_agreement(torch, a, r, torch.bfloat16, t != "out", vmax)
        for t, a, r in zip(("out", "dq", "dk", "dv"), got, ref)}
    del ref
    pl = run(plain, qp, kp, vp, cot=gp)
    res["vs_plain"] = {
        t: flash_agreement(torch, a, r, torch.bfloat16, t != "out", vmax)
        for t, a, r in zip(("out", "dq", "dk", "dv"), got, pl)}
    del pl, got
    torch.cuda.empty_cache()
    for against in ("vs_single_call", "vs_plain"):
        for t, r in res[against].items():
            if not (r["elementwise_ok"] and r["rows_ok"] and r["rms_ok"]):
                raise AssertionError(f"phase 17 {name}: the ring's {t} "
                                     f"leaves {against}: {r}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    leaves = [t.detach().requires_grad_(True) for t in (qp, kp, vp)]
    sleaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    res["ring_fwd_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        attn(*leaves), leaves, gp), flush, n=10, warmup=2)
    res["single_fwd_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        single(*sleaves), sleaves, g), flush, n=10, warmup=2)
    worst = max(r["worst_row_of_mean"] for a in ("vs_single_call",
                                                  "vs_plain")
                for r in res[a].values())
    log(f"phase 17 ring {name} (b {b} h {h}/{h_kv} s {s} over {n} shards, "
        f"bf16): launches {counts}"
        + (f" (inner_block {inner}: the same bits and launches)"
           if inner is not None else "")
        + "; vs single-call flash rel RMS "
        + ", ".join(f"{t} {r['rel_rms']:.2e}"
                    for t, r in res["vs_single_call"].items())
        + "; vs the plain body "
        + ", ".join(f"{t} {r['rel_rms']:.2e}"
                    for t, r in res["vs_plain"].items())
        + f" (worst row {worst:.2e} of the mean); forward + backward "
        f"{res['ring_fwd_bwd_ms']:.3f} ms, single call "
        f"{res['single_fwd_bwd_ms']:.3f} ms")
    return res


def ring_hop_readings(torch, gen, flush, case) -> dict:
    """One ``RING_HOPS`` shape: the forward (f32 output, as the ring calls
    it), dq and dk/dv kernels against their plain versions
    (:func:`flash_case_readings`), then each timed as phase 3 times it
    beside its plain version, its bound by operations over the live pairs
    and, for the unmasked hop, ``scaled_dot_product_attention``'s forward
    and backward (K/V expanded outside the timed call; the corner band has
    no library call that gives its dead rows 0).  The bound's bytes read
    only the query rows and keys the band leaves live
    (:func:`band_live_extent`) and write every output row.  ``{kernel:
    {ms, plain_ms, library_ms, bound}}`` under ``kernels``."""
    import torch.nn.functional as F

    from tpudist_torch.ops.flash_attention import (
        band_live_pairs, flash_backward_dkv, flash_backward_dq,
        flash_backward_reference, flash_forward, flash_forward_reference)

    name, b, h, h_kv, s, d, _, band = case
    readings = flash_case_readings(torch, gen, case)
    if not readings["ok"]:
        raise AssertionError(f"phase 17 {name}: the kernels disagree with "
                             f"their plain versions: {readings}")
    q, g = (torch.randn(b, h, s, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    k, v = (torch.randn(b, h_kv, s, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    out, lse = flash_forward(q, k, v, band, out_f32=True)
    delta = (out * g.float()).sum(-1).contiguous()
    work = b * h * band_live_pairs(s, s, band)
    qb, kvb, rows = q.numel() * 2, k.numel() * 2, b * h * s * 4
    live_q, live_k = band_live_extent(s, s, band)
    # reads of the live rows (q, dO, lse, delta) and keys (k, v)
    qr, kvr, rr = qb * live_q // s, kvb * live_k // s, rows * live_q // s
    sdpa_fwd = sdpa_bwd = None
    if band == (None, None):
        ke, ve = (t.repeat_interleave(h // h_kv, dim=1).requires_grad_(True)
                  for t in (k, v))
        qa = q.detach().requires_grad_(True)
        o_sdpa = F.scaled_dot_product_attention(qa, ke, ve)
        sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
            o_sdpa, (qa, ke, ve), g, retain_graph=True), flush)
        sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ke, ve), flush)
    res = dict(readings=readings, kernels={})
    for kname, kern, plain, nbytes, flops, lib in (
            ("flash_forward",
             lambda: flash_forward(q, k, v, band, out_f32=True),
             lambda: flash_forward_reference(q, k, v, band, out_f32=True),
             qr + 2 * kvr + 2 * qb + rows, 4 * work * d, sdpa_fwd),
            ("flash_backward_dq", lambda: flash_backward_dq(
                q, k, v, g, lse, delta, band),
             lambda: flash_backward_reference(q, k, v, g, lse, delta, band),
             2 * qr + 2 * kvr + 2 * rr + qb, 6 * work * d, sdpa_bwd),
            ("flash_backward_dkv", lambda: flash_backward_dkv(
                q, k, v, g, lse, delta, band),
             lambda: flash_backward_reference(q, k, v, g, lse, delta, band),
             2 * qr + 2 * kvr + 2 * rr + 2 * kvb, 8 * work * d,
             sdpa_bwd)):
        res["kernels"][kname] = dict(
            ms=time_ms(torch, kern, flush),
            plain_ms=time_ms(torch, plain, flush, n=3, warmup=1),
            library_ms=lib, bound=bound(nbytes, flops, H100_BF16_FLOPS))
        r = res["kernels"][kname]
        lib_txt = (f"SDPA {'backward' if 'backward' in kname else 'forward'}"
                   f" {lib:.4f} ms" if lib is not None else "no library call")
        log(f"kernel {kname} at the {name} (b {b} h {h}/{h_kv} s {s}, band "
            f"{band}, {work} live pairs over {live_q} rows and {live_k} "
            f"keys): {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms, {lib_txt}, bound {r['bound'][0]:.5f} "
            f"ms by {r['bound'][1]})")
    return res


def memory_held(torch) -> int:
    """The bytes allocated on the card before a run builds anything (what
    earlier phases and runs left, once their reference cycles are
    collected): a run's peak is read above them, so it is the run's own."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def seq_entry_run(torch, shards: int, steps: int, *extra) -> dict:
    """``steps`` steps of the entry point's configuration (``SEQ_ARGS``,
    ``--seq_shards shards``, through ``build_training``: one process, a
    LocalRing over the card) on its seeded synthetic batches, every kernel
    count zeroed just before: losses, step ms p50 (steps after the first
    3), tokens/s, MFU, peak memory, launches."""
    from tpudist_torch import ops
    from tpudist_torch.train.__main__ import build_training, get_args
    from tpudist_torch.utils.flops import mfu, transformer_train_flops

    args = get_args(SEQ_ARGS + ["--seq_shards", str(shards),
                                "--total_iterations", str(steps), *extra])
    held = memory_held(torch)
    model, step, next_batch = build_training(args)

    def cuda(batch):
        if isinstance(batch, tuple):
            return tuple(torch.from_numpy(a).cuda() for a in batch)
        return torch.from_numpy(batch).cuda()

    batches = [cuda(next_batch()) for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times = [], []
    for tokens in batches:
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    wgmma = {n: ops.KERNEL_WRAPPERS[n].launches_wgmma for n in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[3:] if steps > 4 else times)
    flops = transformer_train_flops(
        batch=args.batch_size, seq_len=args.seq_len, d_model=args.d_model,
        n_layers=args.n_layers, d_ff=args.d_ff, vocab=args.vocab)
    del model, step, batches
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"phase 17: non-finite losses at "
                             f"--seq_shards {shards}: {losses}")
    return dict(shards=shards, losses=losses, step_ms_p50=step_s * 1e3,
                tokens_per_s=args.batch_size * args.seq_len / step_s,
                mfu=mfu(flops, step_s, 1, peak_per_chip=H100_BF16_FLOPS),
                peak_mem_gb=(peak - held) / 1e9, held_gb=held / 1e9,
                launches=counts, launches_wgmma=wgmma, layers=args.n_layers)


class StaleLastHop:
    """A known-wrong ring for the bf16 bound's control run: while it is
    entered, every causal ring pass over a ``LocalRing`` leaves K/V in
    place on its last hop, so the last shard folds in shard 1's block twice
    and never shard 0's (one live hop of ten a layer wrong)."""

    def __enter__(self):
        from tpudist_torch.parallel.ring import LocalRing

        self.hop, calls = LocalRing.hop, [0]
        hop = self.hop

        def stale(ring, ks, vs):
            calls[0] += 1
            if calls[0] % (ring.size - 1) == 0:
                return ks, vs
            return hop(ring, ks, vs)

        LocalRing.hop = stale
        return self

    def __exit__(self, *exc):
        from tpudist_torch.parallel.ring import LocalRing

        LocalRing.hop = self.hop


def seq_parallel_path(torch, card: str) -> dict:
    """Phase 17: (a) every ``RING_CASES`` case (:func:`ring_case`) and the
    hop shapes' kernels (:func:`ring_hop_readings`); (b) the entry point at
    ``--seq_shards 4`` against ``--seq_shards 1`` on the same batches: f32
    at ``SEQ_F32_LAYERS`` layers, each step's loss within
    ``SEQ_F32_RTOL``; bf16 at full depth, ``SEQ_STEPS`` steps, the flash
    kernels launched ``ring_launches`` times a layer and step on the ring
    (80 forward a step at 4 shards) against once a layer unsharded, every
    launch on the wgmma arms, each step's losses within ``SEQ_BF16_RTOL``
    of each other; then the ring again with a stale last hop
    (:class:`StaleLastHop`), whose losses must leave that bound."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1717)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if (ring_launches(4, True, None, 2048), ring_launches(4, True, 512, 2048)
            ) != (10, 7):
        raise AssertionError("ring_launches miscounts the causal ring")
    res = dict(cases={c[0]: ring_case(torch, gen, c) for c in RING_CASES})
    res["hops"] = {c[0]: ring_hop_readings(torch, gen, flush, c)
                   for c in RING_HOPS}
    del flush
    torch.cuda.empty_cache()
    f32 = [seq_entry_run(torch, n, SEQ_F32_STEPS, "--precision", "fp32",
                         "--n_layers", str(SEQ_F32_LAYERS))
           for n in (RING_SHARDS, 1)]
    rel = [abs(a - b) / abs(b) for a, b in zip(f32[0]["losses"],
                                               f32[1]["losses"])]
    res["f32"] = dict(ring=f32[0], unsharded=f32[1], max_rel=max(rel))
    log(f"phase 17 entry point f32 ({SEQ_F32_LAYERS} layers, seq "
        f"{RING_S}, batch {RING_B}): --seq_shards {RING_SHARDS} losses "
        f"{f32[0]['losses']}, --seq_shards 1 {f32[1]['losses']}; max rel "
        f"{max(rel):.2e} (bound {SEQ_F32_RTOL})")
    if max(rel) > SEQ_F32_RTOL:
        raise AssertionError(f"phase 17: the f32 ring's losses leave the "
                             f"unsharded run's: {rel}")
    bf16 = [seq_entry_run(torch, n, SEQ_STEPS, "--precision", "bf16")
            for n in (RING_SHARDS, 1)]
    ring, flat = bf16
    per_layer = ring_launches(RING_SHARDS, True, None, RING_S // RING_SHARDS)
    for r, k in ((ring, per_layer), (flat, 1)):
        want = {n: k * r["layers"] * SEQ_STEPS for n in TRAIN_KERNELS}
        got = {n: r["launches"].get(n, 0) for n in TRAIN_KERNELS}
        if got != want or r["launches_wgmma"] != want:
            raise AssertionError(f"phase 17: --seq_shards {r['shards']} "
                                 f"launched {got} ({r['launches_wgmma']} on "
                                 f"the wgmma arms), not {want} in "
                                 f"{SEQ_STEPS} steps")
    gap = [abs(a - b) / abs(b) for a, b in zip(ring["losses"],
                                               flat["losses"])]
    with StaleLastHop():
        stale = seq_entry_run(torch, RING_SHARDS, SEQ_STEPS, "--precision",
                              "bf16")["losses"]
    stale_gap = [abs(a - b) / abs(b) for a, b in zip(stale, flat["losses"])]
    res["bf16"] = dict(ring=ring, unsharded=flat, max_rel=max(gap),
                       stale_hop=dict(losses=stale, max_rel=max(stale_gap)))
    for r in bf16:
        log(f"phase 17 entry point bf16 --seq_shards {r['shards']} (d1024, "
            f"8 layers, seq {RING_S}, batch {RING_B}, {SEQ_STEPS} steps): "
            f"step p50 {r['step_ms_p50']:.2f} ms = {r['tokens_per_s']:.0f} "
            f"tokens/s, MFU {r['mfu']:.4f}, peak memory "
            f"{r['peak_mem_gb']:.3f} GB above the {r['held_gb']:.3f} GB held "
            f"before the run ({card}); flash launches "
            f"{r['launches'].get('flash_forward', 0) // SEQ_STEPS} forward "
            f"a step; losses {[round(x, 4) for x in r['losses']]}")
    log(f"phase 17 bf16 losses, ring vs unsharded: max rel {max(gap):.2e}; "
        f"a ring with a stale last hop: max rel {max(stale_gap):.2e} "
        f"(bound {SEQ_BF16_RTOL}), losses {[round(x, 4) for x in stale]}")
    if max(gap) > SEQ_BF16_RTOL:
        raise AssertionError(f"phase 17: the bf16 ring's losses leave the "
                             f"unsharded run's: {gap}")
    if max(stale_gap) <= SEQ_BF16_RTOL:
        raise AssertionError(f"phase 17: the bf16 bound {SEQ_BF16_RTOL} "
                             f"does not tell a stale hop: {stale_gap}")
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 17 wall: {res['wall_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 18: sharded state (FSDP, ZeRO-1), tensor parallelism, the bf16
# gradient reduce


def shard_run(torch, label: str, steps: int, layout=None, *, tp=False,
              reduce_dtype=None) -> dict:
    """``steps`` steps of phase 7's step (``TRAIN_ARGS``: the demo's model
    and optimizer) on the seeded synthetic batches under ``layout(mesh,
    model, opt)`` (``None``: DDP), on the ``data`` mesh or, with ``tp``, a
    ``('data', 'model')`` mesh of ``TP_SHARDS`` places on the card; every
    count zeroed just before: losses, step ms p50 (after the first 3),
    tokens/s, MFU, peak memory, flash launches (and on the wgmma arms),
    the runtime's collectives a step and ``state_bytes_per_device``."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.examples.demo_long_context import (build_model,
                                                          make_batch)
    from tpudist_torch.parallel import state_bytes_per_device
    from tpudist_torch.runtime.mesh import data_model_mesh, data_parallel_mesh
    from tpudist_torch.train.__main__ import get_args
    from tpudist_torch.train.lm import make_lm_train_step
    from tpudist_torch.train.optim import build_optimizer_from_args
    from tpudist_torch.utils.flops import mfu, transformer_train_flops

    args = get_args(TRAIN_ARGS + ["--total_iterations", str(steps)])
    dev = torch.device("cuda")
    held = memory_held(torch)
    model = build_model(args, dev)
    opt, sched = build_optimizer_from_args(args, model.parameters())
    mesh = (data_model_mesh(TP_SHARDS, devices=[dev] * TP_SHARDS) if tp
            else data_parallel_mesh(device=dev))
    plan = layout(mesh, model, opt) if layout is not None else None
    step = make_lm_train_step(model, opt, scheduler=sched,
                              state_sharding=plan,
                              grad_reduce_dtype=reduce_dtype)
    rng = np.random.default_rng(args.seed)
    batches = [torch.from_numpy(make_batch(rng, args.batch_size,
                                           args.seq_len, args.vocab)).to(dev)
               for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rt = step.runtime
    if rt is not None:
        rt.counts.update({k: 0 for k in rt.counts})
    losses, times = [], []
    for tokens in batches:
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = {n: ops.launch_counts().get(n, 0) for n in TRAIN_KERNELS}
    wgmma = {n: ops.KERNEL_WRAPPERS[n].launches_wgmma for n in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[3:])
    flops = transformer_train_flops(
        batch=args.batch_size, seq_len=args.seq_len, d_model=args.d_model,
        n_layers=args.n_layers, d_ff=args.d_ff, vocab=args.vocab)
    res = dict(label=label, losses=losses, step_ms_p50=step_s * 1e3,
               tokens_per_s=args.batch_size * args.seq_len / step_s,
               mfu=mfu(flops, step_s, 1, peak_per_chip=H100_BF16_FLOPS),
               peak_mem_gb=(peak - held) / 1e9, held_gb=held / 1e9,
               launches=counts, launches_wgmma=wgmma, layers=args.n_layers,
               collectives=(None if rt is None else
                            {k: v / steps for k, v in rt.counts.items()}),
               state_bytes=(None if plan is None
                            else state_bytes_per_device(plan)))
    del model, opt, step, batches, rt
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"phase 18 {label}: non-finite losses "
                             f"{losses}")
    return res


def log_shard_run(r: dict, card: str, base=None) -> None:
    gap = "" if base is None else (
        f"; losses vs dp max rel "
        f"{max(abs(a - b) / abs(b) for a, b in zip(r['losses'], base)):.2e}")
    coll = "" if r["collectives"] is None else (
        f"; collectives a step {r['collectives']}")
    sb = "" if r["state_bytes"] is None else (
        f"; state_bytes_per_device {r['state_bytes'] / 2**20:.1f} MiB")
    log(f"phase 18 {r['label']} (phase 7's model, world 1, "
        f"{len(r['losses'])} steps): step p50 {r['step_ms_p50']:.2f} ms = "
        f"{r['tokens_per_s']:.0f} tokens/s, MFU {r['mfu']:.4f}, peak "
        f"memory {r['peak_mem_gb']:.3f} GB above the {r['held_gb']:.3f} GB "
        f"held before the run ({card}); flash launches a step "
        f"{ {n: v // len(r['losses']) for n, v in r['launches'].items()} }"
        f"{coll}{sb}{gap}; losses {[round(x, 4) for x in r['losses']]}")


def hold_launches(r: dict, per_layer: int) -> None:
    """Every flash kernel ``per_layer`` times a layer and step, all on the
    wgmma arms."""
    steps = len(r["losses"])
    want = {n: per_layer * r["layers"] * steps for n in TRAIN_KERNELS}
    if r["launches"] != want or r["launches_wgmma"] != want:
        raise AssertionError(f"phase 18 {r['label']}: flash launches "
                             f"{r['launches']} (wgmma {r['launches_wgmma']})"
                             f", not {want}")


def hold_losses(r: dict, base, rtol: float) -> float:
    gap = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], base))
    if gap > rtol:
        raise AssertionError(f"phase 18 {r['label']}: losses leave dp's by "
                             f"{gap:.2e} > {rtol}: {r['losses']} vs {base}")
    return gap


def sharded_path(torch, card: str) -> dict:
    """Phase 18: (a) ``dp`` (DDP), ``fsdp`` and ``zero1`` at world 1 over
    NCCL (this process under the torchrun contract), each step's loss
    within ``SHARD_RTOL`` of ``dp``'s, 8 flash launches of each kernel a
    step; (b) TP over ``TP_SHARDS`` places folded onto the card and TP
    merged with FSDP, within ``TP_RTOL`` of ``dp``, 16 launches of each a
    step, all wgmma; the flash kernels at the shard's shape
    (``TP_FLASH_CASE``) against their plain versions and timed beside
    their bound and SDPA; (c) the bf16 gradient reduce against ``dp``'s f32
    one (the gap printed); (d) the entry point's ``--fsdp --seq_shards
    4`` against ``--seq_shards 4`` (phase 17's configuration,
    ``SHARD_SEQ_STEPS`` steps), within ``SHARD_RTOL``."""
    from tpudist_torch.models.transformer import transformer_tp_sharding
    from tpudist_torch.parallel import (fsdp_sharding, merge_shardings,
                                        zero1_sharding)
    from tpudist_torch.runtime import initialize, shutdown

    t0 = time.perf_counter()
    env = torchrun_env()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        initialize(device=torch.device("cuda"))
        runs = {"dp": shard_run(torch, "dp (DDP)", SHARD_STEPS)}
        base = runs["dp"]["losses"]
        runs["fsdp"] = shard_run(torch, "fsdp", SHARD_STEPS, fsdp_sharding)
        runs["zero1"] = shard_run(torch, "zero1", SHARD_STEPS,
                                  zero1_sharding)
        runs["tp"] = shard_run(torch, f"TP model {TP_SHARDS}", SHARD_STEPS,
                               transformer_tp_sharding, tp=True)
        runs["tp_fsdp"] = shard_run(
            torch, f"TP model {TP_SHARDS} + FSDP", SHARD_STEPS,
            lambda mesh, m, o: merge_shardings(
                transformer_tp_sharding(mesh, m, o),
                fsdp_sharding(mesh, m, o)), tp=True)
        runs["bf16_reduce"] = shard_run(torch, "grad_reduce_dtype bf16",
                                        SHARD_STEPS,
                                        reduce_dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(1818)
        readings = flash_case_readings(torch, gen, TP_FLASH_CASE)
        if not readings["ok"]:
            raise AssertionError(f"phase 18: the flash kernels disagree "
                                 f"with their plain versions at the TP "
                                 f"shard's shape: {readings}")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        timed = flash_head_dim_timings(torch, gen, flush,
                                       TP_FLASH_CASE[:6])
        del flush
        torch.cuda.empty_cache()
        seq_fsdp = seq_entry_run(torch, RING_SHARDS, SHARD_SEQ_STEPS,
                                 "--precision", "bf16", "--fsdp")
        seq_plain = seq_entry_run(torch, RING_SHARDS, SHARD_SEQ_STEPS,
                                  "--precision", "bf16")
    finally:
        shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for name, r in runs.items():
        log_shard_run(r, card, None if name == "dp" else base)
    gaps = {}
    for name in ("dp", "fsdp", "zero1"):
        hold_launches(runs[name], 1)
    for name in ("tp", "tp_fsdp"):
        hold_launches(runs[name], TP_SHARDS)
    for name in ("fsdp", "zero1"):
        gaps[name] = hold_losses(runs[name], base, SHARD_RTOL)
    for name in ("tp", "tp_fsdp"):
        gaps[name] = hold_losses(runs[name], base, TP_RTOL)
    gaps["bf16_reduce"] = max(abs(a - b) / abs(b) for a, b in
                              zip(runs["bf16_reduce"]["losses"], base))
    log("phase 18 (a) world 1: the collectives are copies, so the memory "
        "FSDP and ZeRO-1 save over more ranks is not measured on this box")
    log(f"phase 18 (c) bf16 gradient reduce against the f32 reduce: losses "
        f"max rel {gaps['bf16_reduce']:.2e}")
    seq_gap = max(abs(a - b) / abs(b) for a, b in
                  zip(seq_fsdp["losses"], seq_plain["losses"]))
    for r, tag in ((seq_fsdp, "--fsdp --seq_shards 4"),
                   (seq_plain, "--seq_shards 4")):
        log(f"phase 18 (d) entry point {tag} (seq {RING_S}, batch "
            f"{RING_B}, {SHARD_SEQ_STEPS} steps): step p50 "
            f"{r['step_ms_p50']:.2f} ms = {r['tokens_per_s']:.0f} tokens/s, "
            f"MFU {r['mfu']:.4f}, peak memory {r['peak_mem_gb']:.3f} GB "
            f"above the {r['held_gb']:.3f} GB held before the run ({card}); "
            f"flash forward launches "
            f"{r['launches'].get('flash_forward', 0)}; losses "
            f"{[round(x, 4) for x in r['losses']]}")
    log(f"phase 18 (d) --fsdp against the ring alone: losses max rel "
        f"{seq_gap:.2e} (bound {SHARD_RTOL})")
    if seq_fsdp["launches"] != seq_plain["launches"]:
        raise AssertionError(f"phase 18 (d): --fsdp launched "
                             f"{seq_fsdp['launches']}, the ring "
                             f"{seq_plain['launches']}")
    if seq_gap > SHARD_RTOL:
        raise AssertionError(f"phase 18 (d): --fsdp leaves the ring's "
                             f"losses by {seq_gap:.2e}")
    res = dict(runs=runs, gaps=gaps, tp_flash=dict(readings=readings,
                                                   kernels=timed),
               seq=dict(fsdp=seq_fsdp, plain=seq_plain, max_rel=seq_gap),
               wall_s=time.perf_counter() - t0)
    log(f"phase 18 wall: {res['wall_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 19: expert parallelism with its aux loss, the collective matmuls,
# 3-D parallelism and the scanned step


def timed_steps(torch, step, batches, aux: bool) -> tuple:
    """Run ``step`` over ``batches`` (each timed on the host clock, ending
    in a synchronize): the losses, the seconds of each step and, with
    ``aux``, each step's statistics as floats."""
    losses, times, stats = [], [], []
    for tokens in batches:
        t0 = time.perf_counter()
        out = step(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        loss, got = out if aux else (out, {})
        losses.append(float(loss))
        stats.append({k: v.tolist() for k, v in got.items()})
    return losses, times, stats


def train_readings(torch, args, held: int, losses, times, label: str,
                   steps: int, **extra) -> dict:
    """Step ms p50 (after the first 3), tokens/s, MFU by
    ``utils/flops.py``'s dense formula, peak memory above ``held`` and the
    flash launches (all and on the wgmma arms) of a run of ``args``."""
    from tpudist_torch import ops
    from tpudist_torch.utils.flops import mfu, transformer_train_flops

    step_s = statistics.median(times[3:])
    flops = transformer_train_flops(
        batch=args.batch_size, seq_len=args.seq_len, d_model=args.d_model,
        n_layers=args.n_layers, d_ff=args.d_ff, vocab=args.vocab)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"phase 19 {label}: non-finite losses "
                             f"{losses}")
    return dict(label=label, losses=losses, step_ms_p50=step_s * 1e3,
                tokens_per_s=args.batch_size * args.seq_len / step_s,
                mfu=mfu(flops, step_s, 1, peak_per_chip=H100_BF16_FLOPS),
                peak_mem_gb=(torch.cuda.max_memory_allocated() - held) / 1e9,
                held_gb=held / 1e9, layers=args.n_layers, steps=steps,
                launches={n: ops.launch_counts().get(n, 0)
                          for n in TRAIN_KERNELS},
                launches_wgmma={n: ops.KERNEL_WRAPPERS[n].launches_wgmma
                                for n in TRAIN_KERNELS}, **extra)


def moe_run(torch) -> dict:
    """(a) Phase 7's model and batches with ``MOE_EXPERTS`` experts in every
    block, top ``MOE_TOPK``, balance weight ``MOE_BALANCE``, through the
    entry point's ``build_training`` (the experts' places folded onto the
    card), ``MOE_STEPS`` steps with every count zeroed just before."""
    from tpudist_torch import ops
    from tpudist_torch.train.__main__ import build_training, get_args

    args = get_args(TRAIN_ARGS + [
        "--total_iterations", str(MOE_STEPS), "--moe_experts",
        str(MOE_EXPERTS), "--moe_topk", str(MOE_TOPK), "--moe_balance",
        str(MOE_BALANCE)])
    held = memory_held(torch)
    model, step, next_batch = build_training(args)
    batches = [torch.from_numpy(next_batch()).cuda()
               for _ in range(MOE_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times, stats = timed_steps(torch, step, batches, aux=True)
    res = train_readings(torch, args, held, losses, times, "MoE",
                         MOE_STEPS, moe=stats)
    # one more step under the profiler, after the counts were read
    res["profile"] = device_profile(torch, lambda: step(batches[-1]),
                                    lambda: None)
    res["ep_vs_dense"] = moe_reference_check(torch, model)
    del model, step, batches
    torch.cuda.empty_cache()
    return res


def moe_reference_check(torch, model) -> dict:
    """One MoE layer's forward at top-1 with a capacity factor of
    ``MOE_EXPERTS`` (every expert's queue holds every token: nothing drops)
    against the dense reference on the same bf16 weights and tokens."""
    from tpudist_torch.models.transformer import (dense_moe_reference,
                                                  moe_expert_fn)
    from tpudist_torch.parallel import make_moe
    from tpudist_torch.runtime.mesh import data_model_mesh

    moe = model.blocks[0].moe
    params = {"router": moe.router.detach().bfloat16(),
              "experts": {"w": moe.w.detach().bfloat16(),
                          "wo": moe.wo.detach().bfloat16()}}
    gen = torch.Generator(device="cuda").manual_seed(1919)
    x = torch.randn(8 * 2048, model.d_model, generator=gen,
                    device="cuda").bfloat16()
    mesh = data_model_mesh(MOE_EXPERTS,
                           devices=[torch.device("cuda")] * MOE_EXPERTS)
    with torch.no_grad():
        y, stats = make_moe(mesh, moe_expert_fn, k=1,
                            capacity_factor=float(MOE_EXPERTS))(params, x)
        ref = dense_moe_reference(params, x)
    diff = (y.float() - ref.float()).abs()
    vmax = float(ref.float().abs().max())
    rel_rms = float((y.float() - ref.float()).norm() / ref.float().norm())
    res = dict(max_abs_err=float(diff.max()), ref_max=vmax, rel_rms=rel_rms,
               dropped=float(stats.dropped_fraction),
               bound=MOE_REF_BOUND * vmax)
    if res["dropped"] != 0.0 or res["max_abs_err"] > res["bound"] or \
            rel_rms > MOE_REF_BOUND:
        raise AssertionError(f"phase 19 (a): the expert-parallel layer "
                             f"leaves the dense reference: {res}")
    return res


def overlap_mlp_readings(torch, flush) -> dict:
    """(b) ``make_tp_mlp(overlap='ring'|'bidir')`` against ``'off'`` at
    each of ``OVERLAP_MODELS`` places folded onto the card, at the LM's MLP
    widths in bf16: the largest gap (under ``m·OVERLAP_BOUND`` of the
    output's largest magnitude: each hop rounds the reduce-scatter's
    running sum) and each mode's time (CUDA events)."""
    from tpudist_torch.parallel import init_mlp_params, make_tp_mlp
    from tpudist_torch.runtime.mesh import data_model_mesh

    rows, d, f = OVERLAP_SHAPE
    gen = torch.Generator().manual_seed(1920)
    params = {k: v.cuda().bfloat16()
              for k, v in init_mlp_params(gen, d, f).items()}
    x = torch.randn(rows, d, generator=gen).cuda().bfloat16()
    res = {}
    for m in OVERLAP_MODELS:
        mesh = data_model_mesh(m, devices=[torch.device("cuda")] * m)
        fns = {mode: make_tp_mlp(mesh, overlap=mode)
               for mode in ("off", "ring", "bidir")}
        with torch.no_grad():
            off = fns["off"](params, x).float()
            r = dict(ms={}, gap={}, bound=m * OVERLAP_BOUND *
                     float(off.abs().max()))
            for mode, fn in fns.items():
                if mode != "off":
                    r["gap"][mode] = float((fn(params, x).float() - off)
                                           .abs().max())
                r["ms"][mode] = time_ms(torch, lambda fn=fn: fn(params, x),
                                        flush)
        res[m] = r
        log(f"phase 19 (b) TP MLP at model {m} folded onto the card "
            f"({rows} x {d} -> {f} -> {d}, bf16): off {r['ms']['off']:.4f} "
            f"ms, ring {r['ms']['ring']:.4f} ms, bidir "
            f"{r['ms']['bidir']:.4f} ms; largest gap against off: ring "
            f"{r['gap']['ring']:.4e}, bidir {r['gap']['bidir']:.4e} (bound "
            f"{r['bound']:.4e}); one card has no links, so no hop can run "
            f"beside a matmul here: these times show the chains' cost, not "
            f"their overlap")
        if max(r["gap"].values()) > r["bound"]:
            raise AssertionError(f"phase 19 (b): the overlapped MLP leaves "
                                 f"the off body at model {m}: {r}")
    return res


def three_d_run(torch) -> dict:
    """(c) ``demo_3d_parallel``'s build at phase 17's geometry
    (``SEQ_ARGS``: seq 8192, batch 2, bf16) over ``--seq_shards
    RING_SHARDS --model_shards TP_SHARDS``, one process (a LocalRing, the
    model axis folded onto the card), ``SEQ_STEPS`` steps on phase 17's
    batches with every count zeroed just before."""
    from tpudist_torch import ops
    from tpudist_torch.examples import demo_3d_parallel as demo

    args = demo.get_args(SEQ_ARGS + [
        "--precision", "bf16", "--seq_shards", str(RING_SHARDS),
        "--model_shards", str(TP_SHARDS), "--total_iterations",
        str(SEQ_STEPS)])
    held = memory_held(torch)
    mesh = demo.build_mesh(args, torch.device("cuda"))
    model, step, next_batch = demo.build(args, mesh)
    batches = [tuple(torch.from_numpy(a).cuda() for a in next_batch())
               for _ in range(SEQ_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times, _ = timed_steps(torch, step, batches, aux=False)
    res = train_readings(torch, args, held, losses, times, "3-D", SEQ_STEPS,
                         mesh=dict(mesh.shape))
    res["profile"] = device_profile(torch, lambda: step(batches[-1]),
                                    lambda: None)
    del model, step, batches
    torch.cuda.empty_cache()
    return res


def scanned_run(torch) -> dict:
    """(d) ``make_scanned_lm_train_step`` over ``SCAN_K`` of phase 7's
    batches against ``SCAN_K`` plain steps from the same weights."""
    import numpy as np

    from tpudist_torch.examples.demo_long_context import (build_model,
                                                          make_batch)
    from tpudist_torch.train.__main__ import get_args
    from tpudist_torch.train.lm import (make_lm_train_step,
                                        make_scanned_lm_train_step)
    from tpudist_torch.train.optim import build_optimizer_from_args

    args = get_args(TRAIN_ARGS + ["--total_iterations", str(SCAN_K)])
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(np.stack([
        make_batch(rng, args.batch_size, args.seq_len, args.vocab)
        for _ in range(SCAN_K)])).cuda()
    losses = {}
    for kind in ("scanned", "plain"):
        model = build_model(args, torch.device("cuda"))
        opt, sched = build_optimizer_from_args(args, model.parameters())
        if kind == "scanned":
            out = make_scanned_lm_train_step(model, opt, scheduler=sched)(
                toks)
        else:
            step = make_lm_train_step(model, opt, scheduler=sched)
            out = torch.stack([step(t) for t in toks])
        losses[kind] = out.tolist()
        del model, opt
        torch.cuda.empty_cache()
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses["scanned"],
                                                  losses["plain"]))
    return dict(losses=losses, max_rel=gap,
                bit_for_bit=losses["scanned"] == losses["plain"])


def log_train(r: dict, card: str) -> None:
    per_step = {n: v // r["steps"] for n, v in r["launches"].items()}
    log(f"phase 19 {r['label']} (phase 7's model, world 1, {r['steps']} "
        f"steps): step p50 {r['step_ms_p50']:.2f} ms = "
        f"{r['tokens_per_s']:.0f} tokens/s, MFU {r['mfu']:.4f} (the dense "
        f"formula: one FFN a token), peak memory {r['peak_mem_gb']:.3f} GB "
        f"above the {r['held_gb']:.3f} GB held before the run ({card}); "
        f"flash launches a step {per_step}, on the wgmma arms "
        f"{r['launches_wgmma']}; losses {[round(x, 4) for x in r['losses']]}")


def expert_3d_path(torch, card: str, ring_losses) -> dict:
    """Phase 19: (a) :func:`moe_run`, gated on finite, falling losses, 8
    launches of each flash kernel a step (all wgmma) and
    :func:`moe_reference_check`; (b) :func:`overlap_mlp_readings`; (c)
    :func:`three_d_run` against ``ring_losses`` (phase 17's ``--seq_shards
    4`` run on the same batches) within ``TP_RTOL``, every flash launch on
    the wgmma arms, ``TP_SHARDS`` times phase 17's, and the kernels at the
    shard's hop shape (``THREE_D_HOP``); (d) :func:`scanned_run`, bit for
    bit or within ``SHARD_RTOL`` (printed).  World 1 under the torchrun
    contract (NCCL)."""
    from tpudist_torch.runtime import initialize, shutdown

    t0 = time.perf_counter()
    env = torchrun_env()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        initialize(device=torch.device("cuda"))
        moe = moe_run(torch)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        mlp = overlap_mlp_readings(torch, flush)
        three = three_d_run(torch)
        gen = torch.Generator(device="cuda").manual_seed(1921)
        hop = ring_hop_readings(torch, gen, flush, THREE_D_HOP)
        del flush
        torch.cuda.empty_cache()
        scan = scanned_run(torch)
    finally:
        shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log_train(moe, card)
    log_profile({"phase 19 MoE step": moe["profile"],
                 "phase 19 3-D step": three["profile"]})
    for i, st in enumerate(moe["moe"]):
        log(f"phase 19 (a) step {i} moe/*: dropped fraction "
            f"{st['moe_dropped_fraction']:.4f}, load max "
            f"{max(st['moe_expert_load']):.4f}, balance loss "
            f"{st['moe_balance_loss']:.4f}")
    ref = moe["ep_vs_dense"]
    log(f"phase 19 (a) one MoE layer at top-1, capacity factor "
        f"{MOE_EXPERTS} (dropped {ref['dropped']}), against the dense "
        f"reference in bf16: max abs err {ref['max_abs_err']:.4e} (bound "
        f"{ref['bound']:.4e} = {MOE_REF_BOUND} of the largest |y| "
        f"{ref['ref_max']:.4f}), rel RMS {ref['rel_rms']:.3e}")
    log_train(three, card)
    per_layer = ring_launches(RING_SHARDS, True, None, RING_S // RING_SHARDS)
    want = {n: TP_SHARDS * per_layer * MOE_LAYERS * SEQ_STEPS
            for n in TRAIN_KERNELS}
    if three["launches"] != want or three["launches_wgmma"] != want:
        raise AssertionError(f"phase 19 (c): 3-D flash launches "
                             f"{three['launches']} (wgmma "
                             f"{three['launches_wgmma']}), not {want}")
    moe_want = {n: MOE_LAYERS * MOE_STEPS for n in TRAIN_KERNELS}
    if moe["launches"] != moe_want or moe["launches_wgmma"] != moe_want:
        raise AssertionError(f"phase 19 (a): MoE flash launches "
                             f"{moe['launches']} (wgmma "
                             f"{moe['launches_wgmma']}), not {moe_want}")
    first, last3 = moe["losses"][0], statistics.mean(moe["losses"][-3:])
    if not last3 < first:
        raise AssertionError(f"phase 19 (a): the MoE losses do not fall: "
                             f"{moe['losses']}")
    gap = max(abs(a - b) / abs(b) for a, b in zip(three["losses"],
                                                  ring_losses))
    three["max_rel_vs_ring"] = gap
    log(f"phase 19 (c) 3-D (seq {RING_SHARDS} x model {TP_SHARDS}) against "
        f"phase 17's --seq_shards {RING_SHARDS} on the same batches: losses "
        f"max rel {gap:.2e} (bound {TP_RTOL})")
    if gap > TP_RTOL:
        raise AssertionError(f"phase 19 (c): the 3-D losses leave the "
                             f"ring's: {three['losses']} vs {ring_losses}")
    log(f"phase 19 (d) scanned step, K {SCAN_K}: losses "
        f"{scan['losses']['scanned']} against {SCAN_K} plain steps "
        f"{scan['losses']['plain']}: bit for bit {scan['bit_for_bit']}, "
        f"max rel {scan['max_rel']:.2e}")
    if scan["max_rel"] > SHARD_RTOL:
        raise AssertionError(f"phase 19 (d): the scanned step leaves the "
                             f"plain steps: {scan}")
    res = dict(moe=moe, overlap_mlp=mlp, three_d=three, three_d_hop=hop,
               scanned=scan, wall_s=time.perf_counter() - t0)
    log(f"phase 19 wall: {res['wall_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 20: pipeline parallelism


def pipeline_args(schedule: str, micro: int, chunks: int, batch: int = 8):
    """``demo_pipeline``'s arguments at phase 7's geometry (``TRAIN_ARGS``)
    for one schedule."""
    from tpudist_torch.examples import demo_pipeline as demo

    argv = TRAIN_ARGS + ["--stages", str(PP_STAGES), "--schedule", schedule,
                         "--chunks", str(chunks), "--microbatches",
                         str(micro), "--total_iterations", str(PP_STEPS),
                         "--max_len", "2048"]
    argv[argv.index("--batch_size") + 1] = str(batch)
    return demo.get_args(argv)


def pipeline_run(torch, schedule: str, micro: int, chunks: int,
                 batch: int = 8) -> dict:
    """``PP_STEPS`` steps of ``demo_pipeline``'s build (the stages folded
    onto the card) on phase 7's seeded batches, every count zeroed just
    before: :func:`train_readings`, the flash launches a step and, at batch
    8, one more step under the profiler (:func:`device_profile`)."""
    from tpudist_torch import ops
    from tpudist_torch.examples import demo_pipeline as demo
    from tpudist_torch.runtime.mesh import MeshConfig, make_mesh

    args = pipeline_args(schedule, micro, chunks, batch)
    held = memory_held(torch)
    mesh = make_mesh(MeshConfig(data=-1, stage=PP_STAGES),
                     device=torch.device("cuda"))
    model, step, next_batch = demo.build(args, mesh)
    batches = [torch.from_numpy(next_batch()).cuda()
               for _ in range(PP_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times, _ = timed_steps(torch, step, batches, aux=False)
    label = (f"{schedule} M {micro}" + (f" V {chunks}" if chunks > 1 else "")
             + (f" batch {batch}" if batch != 8 else ""))
    res = train_readings(torch, args, held, losses, times, label, PP_STEPS,
                         schedule=schedule, microbatches=micro,
                         chunks=chunks, batch=batch, mesh=dict(mesh.shape))
    res["launches_per_step"] = {n: v // PP_STEPS
                                for n, v in res["launches"].items()}
    if batch == 8:
        # one more step under the profiler, after the counts were read
        res["profile"] = device_profile(torch, lambda: step(batches[-1]),
                                        lambda: None)
    del model, step, batches
    torch.cuda.empty_cache()
    return res


def log_pipeline_run(r: dict, card: str, base) -> None:
    gap = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], base))
    log(f"phase 20 {r['label']} (phase 7's model, {PP_STAGES} stages folded "
        f"onto the card, world 1, {r['steps']} steps): step p50 "
        f"{r['step_ms_p50']:.2f} ms = {r['tokens_per_s']:.0f} tokens/s, MFU "
        f"{r['mfu']:.4f} (utils/flops.py's dense formula: 1F1B's recompute "
        f"is not counted), peak memory {r['peak_mem_gb']:.3f} GB above the "
        f"{r['held_gb']:.3f} GB held before the run ({card}); flash "
        f"launches a step {r['launches_per_step']}, on the wgmma arms "
        f"{ {n: v // r['steps'] for n, v in r['launches_wgmma'].items()} }; "
        f"losses vs phase 7 max rel {gap:.2e}; losses "
        f"{[round(x, 4) for x in r['losses']]}")


def pipeline_trainer() -> dict:
    """(d) ``demo_trainer`` with ``PP_TRAINER_ARGS`` (the Trainer's ``pp``
    on the LM module, fp32) as a subprocess under the torchrun contract at
    world 1 (NCCL): its last ``loss/lm`` under ``PP_TRAINER_LAST_MAX``."""
    out, wall, rows = run_module("tpudist_torch.examples.demo_trainer",
                                 PP_TRAINER_ARGS, torchrun_env())
    rows = rows["demo_trainer"]
    res = dict(wall_s=wall, rows=len(rows), first=rows[0]["loss/lm"],
               last=rows[-1]["loss/lm"])
    if "final losses" not in out or not res["last"] < PP_TRAINER_LAST_MAX:
        raise AssertionError(f"phase 20 (d): demo_trainer --strategy pp "
                             f"did not train: {res}; {out[-2000:]}")
    return res


def pipeline_path(torch, card: str, phase7_losses, trainer: dict) -> dict:
    """Phase 20: (a) GPipe at M 4, 1F1B at M 4 and interleaved at V 2, M 8
    (``PP_RUNS``) through ``demo_pipeline``'s build at phase 7's model,
    ``PP_STEPS`` steps each on phase 7's batches: the flash launches a step
    of ``PP_LAUNCHES``, all wgmma; each step's loss within ``TP_RTOL`` of
    phase 7's (``phase7_losses``) and of the other schedules'; (b) 1F1B at
    batch ``PP_BIG_BATCH``, M 8: 1F1B's peak at batch 8 below GPipe's, and
    its peak at M 8 at most its M-4 peak plus the batch-sized buffers it
    holds (the embedded batch and the dx bank, reckoned here in f32) plus
    ``PP_MEM_SLACK`` of the M-4 peak; (c) the flash kernels at the
    microbatches' shapes (``PP_FLASH_CASES``) against their plain versions
    and timed beside their bound and SDPA; (d) :func:`pipeline_trainer`
    (``trainer``, run with the other entry points).
    World 1 under the torchrun contract (NCCL)."""
    from tpudist_torch.runtime import initialize, shutdown

    t0 = time.perf_counter()
    env = torchrun_env()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        initialize(device=torch.device("cuda"))
        runs = {sch: pipeline_run(torch, sch, m, v) for sch, m, v in PP_RUNS}
        runs["1f1b_big"] = pipeline_run(torch, "1f1b", 8, 1, PP_BIG_BATCH)
        gen = torch.Generator(device="cuda").manual_seed(2020)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        shapes = {}
        for case in PP_FLASH_CASES:
            readings = flash_case_readings(torch, gen, case)
            if not (readings["ok"] and readings["arm"] == "wgmma"
                    and readings["fwd_arm"] == "wgmma"):
                raise AssertionError(f"phase 20 (c) {case[0]}: the flash "
                                     f"kernels disagree with their plain "
                                     f"versions: {readings}")
            shapes[case[0]] = dict(readings=readings, kernels=(
                flash_head_dim_timings(torch, gen, flush, case[:6])))
        del flush
        torch.cuda.empty_cache()
    finally:
        shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    base = phase7_losses[:PP_STEPS]
    for r in runs.values():
        if r["batch"] == 8:
            log_pipeline_run(r, card, base)
    log_profile({f"phase 20 {sch} step": runs[sch]["profile"]
                 for sch, _, _ in PP_RUNS})
    gaps = {}
    for sch, _, _ in PP_RUNS:
        r = runs[sch]
        want = dict(zip(TRAIN_KERNELS, (n * PP_STEPS
                                        for n in PP_LAUNCHES[sch])))
        if r["launches"] != want or r["launches_wgmma"] != want:
            raise AssertionError(f"phase 20 (a) {sch}: flash launches "
                                 f"{r['launches']} (wgmma "
                                 f"{r['launches_wgmma']}), not {want}")
        gaps[sch] = max(abs(a - b) / abs(b)
                        for a, b in zip(r["losses"], base))
        if gaps[sch] > TP_RTOL:
            raise AssertionError(f"phase 20 (a) {sch}: the losses leave "
                                 f"phase 7's by {gaps[sch]:.2e} > {TP_RTOL}")
    cross = max(abs(a - b) / abs(b)
                for x, _, _ in PP_RUNS for y, _, _ in PP_RUNS
                for a, b in zip(runs[x]["losses"], runs[y]["losses"]))
    log(f"phase 20 (a) losses against phase 7's unpipelined step, max rel "
        f"{gaps}; between the schedules {cross:.2e} (bound {TP_RTOL})")
    if cross > TP_RTOL:
        raise AssertionError(f"phase 20 (a): the schedules' losses leave "
                             f"each other by {cross:.2e}")
    big, small, gp = runs["1f1b_big"], runs["1f1b"], runs["gpipe"]
    args = pipeline_args("1f1b", 4, 1)
    extra_rows = PP_BIG_BATCH - 8
    # the embedded batch and the dx bank: [rows, seq, d] each, in f32
    buffers = 2 * extra_rows * args.seq_len * args.d_model * 4 / 1e9
    allowed = small["peak_mem_gb"] + buffers + PP_MEM_SLACK * small[
        "peak_mem_gb"]
    mem = dict(gpipe_gb=gp["peak_mem_gb"], f1b_m4_gb=small["peak_mem_gb"],
               f1b_m8_gb=big["peak_mem_gb"], buffers_gb=buffers,
               allowed_gb=allowed, big_step_ms_p50=big["step_ms_p50"])
    log(f"phase 20 (b) memory above what was held ({card}): GPipe M 4 "
        f"{gp['peak_mem_gb']:.3f} GB, 1F1B M 4 {small['peak_mem_gb']:.3f} "
        f"GB, 1F1B batch {PP_BIG_BATCH} M 8 {big['peak_mem_gb']:.3f} GB "
        f"(allowed {allowed:.3f} GB = the M-4 peak + {buffers:.3f} GB of "
        f"batch-sized buffers, the embedded batch and the dx bank in f32, + "
        f"{PP_MEM_SLACK:.0%}); its step p50 {big['step_ms_p50']:.2f} ms, "
        f"losses {[round(x, 4) for x in big['losses']]}; one card folds "
        f"every stage, so the pipeline bubble is not measurable here")
    if not small["peak_mem_gb"] < gp["peak_mem_gb"]:
        raise AssertionError(f"phase 20 (b): 1F1B peaks at "
                             f"{small['peak_mem_gb']:.3f} GB, not below "
                             f"GPipe's {gp['peak_mem_gb']:.3f}")
    if big["peak_mem_gb"] > allowed:
        raise AssertionError(f"phase 20 (b): 1F1B at M 8 peaks at "
                             f"{big['peak_mem_gb']:.3f} GB > {allowed:.3f}")
    log(f"phase 20 (d) demo_trainer {' '.join(PP_TRAINER_ARGS)} (world 1 "
        f"under the torchrun contract, NCCL, fp32): {trainer['rows']} rows "
        f"in {trainer['wall_s']:.1f} s of process wall ({card}); loss/lm "
        f"{trainer['first']:.4f} -> {trainer['last']:.4f} (bound "
        f"{PP_TRAINER_LAST_MAX})")
    res = dict(runs=runs, gaps=gaps, cross=cross, memory=mem,
               shapes=shapes, trainer=trainer,
               wall_s=time.perf_counter() - t0)
    log(f"phase 20 wall: {res['wall_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phases 10-11: the toy demo.py path and the toy benches


def run_module(module: str, args, env=None, cwd=None, timeout: int = 600):
    """``python -m module *args`` as a subprocess in ``cwd`` (default: a
    temporary working directory), with the repository on the path and
    ``env`` added to the environment; it must exit 0.  Returns its output,
    its wall time in seconds and the metric rows of each
    ``runs/<group>/metrics.jsonl`` under ``cwd`` (by group)."""
    import tempfile

    if cwd is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_module(module, args, env, tmp, timeout)
    repo = os.path.dirname(os.path.abspath(__file__))
    full = dict(os.environ, PYTHONPATH=repo, **(env or {}))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=full, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{module} {' '.join(args)} exited "
                             f"{proc.returncode}: "
                             f"{(proc.stdout + proc.stderr)[-3000:]}")
    rows = {}
    runs = os.path.join(cwd, "runs")
    for group in (os.listdir(runs) if os.path.isdir(runs) else []):
        path = os.path.join(runs, group, "metrics.jsonl")
        if not os.path.isfile(path):  # runs/telemetry: the span stream
            continue
        with open(path) as f:
            rows[group] = [json.loads(line) for line in f]
    return proc.stdout, wall, rows


_PORTS_GIVEN: set = set()
_PORTS_LOCK = threading.Lock()


def torchrun_env(**extra) -> dict:
    """The torchrun contract at world size 1 on a free local port, one no
    earlier call gave (the entry points run several at once)."""
    from tpudist_torch.runtime.bootstrap import find_free_port

    with _PORTS_LOCK:
        port = find_free_port()
        while port in _PORTS_GIVEN:
            port = find_free_port()
        _PORTS_GIVEN.add(port)
    return dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                MASTER_ADDR="localhost", MASTER_PORT=str(port), **extra)


def loss_summary(rows, names=LOSS_NAMES) -> dict:
    """First and last losses and the mean of the last 16 of metric rows."""
    return dict(rows=len(rows), first={k: rows[0][k] for k in names},
                last={k: rows[-1][k] for k in names},
                last16_mean={k: statistics.mean(r[k] for r in rows[-16:])
                             for k in names})


def hold_converged(what: str, res: dict,
                   last_bound: float = DEMO_LOSS_MAX) -> None:
    """``DEMO_ITERATIONS`` rows whose losses start near 3 and end at most
    ``DEMO_LOSS_MAX`` (the mean of the last 16) and ``last_bound`` (the
    last row)."""
    if res["rows"] != DEMO_ITERATIONS:
        raise AssertionError(f"{what} logged {res['rows']} rows, not "
                             f"{DEMO_ITERATIONS}")
    for k in LOSS_NAMES:
        if not (res["first"][k] >= 2.0 and res["last"][k] <= last_bound
                and res["last16_mean"][k] <= DEMO_LOSS_MAX):
            raise AssertionError(f"{what} did not converge: {res}")


def demo_path(backend: str) -> dict:
    """Phase 10: ``python -m tpudist_torch.examples.demo`` as the reference
    runs it (``--dry_run``, ``DEMO_ARGS``), a subprocess under the torchrun
    contract at world size 1 (so the NCCL group, DDP and the device-group
    loss all-reduce run) in a temporary working directory.  It must exit 0
    and log one row an iteration; both models' losses must start near 3
    and end at most ``DEMO_LOSS_MAX`` (the last row, and the mean of the
    last 16)."""
    out, wall, rows = run_module("tpudist_torch.examples.demo",
                                 DEMO_ARGS + ["--backend", backend],
                                 torchrun_env())
    rows = rows["demo_dp"]
    res = dict(backend=backend, wall_s=wall, **loss_summary(rows),
               banner=[line for line in out.splitlines()
                       if "launch=" in line],
               losses=[[r[k] for k in LOSS_NAMES] for r in rows])
    if "launch=torchrun" not in out or "backend=nccl" not in out:
        raise AssertionError(f"the demo did not run on the NCCL group: "
                             f"{res['banner']}")
    hold_converged(f"the demo ({backend})", res)
    return res


def bench_path(torch) -> dict:
    """Phase 11: ``tpudist_torch.bench``'s two benches on the card, every
    kernel count zeroed just before; the fused kernel must launch at least
    once a timed call.  Then one toy step window (256 iterations of the
    scanned step) under ``torch.profiler``."""
    from tpudist_torch import ops
    from tpudist_torch.bench import bench_fused_mlp, bench_toy, toy_setup

    ops.reset_launch_counts()
    toy = bench_toy("cuda", rounds=TOY_BENCH_ROUNDS)
    fused = bench_fused_mlp(4096, "cuda")
    counts = ops.launch_counts()
    if counts["fused_mlp"] < fused["kernel_calls"]:
        raise AssertionError(f"fused_mlp launched {counts['fused_mlp']} "
                             f"times for {fused['kernel_calls']} timed calls")
    states, chunk_step, x_all, y_all, idx = toy_setup(torch.device("cuda"))
    chunk_step(states, x_all, y_all, idx)  # warm-up
    prof = device_profile(
        torch, lambda: chunk_step(states, x_all, y_all, idx), lambda: None)
    return dict(toy=toy, fused_mlp=fused, launches=counts,
                toy_window_profile=prof)


# ---------------------------------------------------------------------------
# phases 12-14: the reference's other entry points — the model split, the
# MPI bootstrap, the Trainer facade — with checkpoint/resume and a trace


def split_path(torch, demo_losses, mp1: dict) -> dict:
    """Phase 12: the toy models split at model axis 2 over ``[cuda:0,
    cuda:0]`` (``data_model_mesh(devices=...)``: both stages on the one
    card), trained for ``DEMO_ITERATIONS`` through the demo's
    ``build_training(split=True)`` and ``run_training`` under the torchrun
    contract at world size 1 (the NCCL group, DDP over the two-stage
    modules, the device-group loss all-reduce), in this process.  Its
    per-iteration losses must equal phase 10's (``--backend ici``) within
    ``SPLIT_RTOL``.  ``mp1`` is :func:`model_split_mp1`'s run."""
    import tempfile

    from tpudist_torch.config import get_args
    from tpudist_torch.examples.common import build_training
    from tpudist_torch.models.split_mlp import SplitToyMLP
    from tpudist_torch.runtime import initialize, shutdown
    from tpudist_torch.runtime.mesh import data_model_mesh
    from tpudist_torch.train import run_training
    from tpudist_torch.utils import MetricsLogger

    saved = {k: os.environ.get(k) for k in torchrun_env()}
    os.environ.update(torchrun_env())
    try:
        ctx = initialize(device="cuda")
        import torch.distributed as dist

        backend = dist.get_backend()
        mesh = data_model_mesh(2, devices=["cuda:0", "cuda:0"])
        states, step, loader, cfg, chunk = build_training(
            get_args(DEMO_ARGS), mesh, split=True)
        for st in states.values():
            if not (isinstance(st.model, SplitToyMLP)
                    and len(st.model.stages) == 2 and isinstance(
                        st.replica, torch.nn.parallel.DistributedDataParallel)):
                raise AssertionError("the split models are not two-stage "
                                     "modules under DDP")
        cfg.progress_bar = False
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "metrics.jsonl")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_training(states, step, loader, mesh,
                         MetricsLogger(jsonl_path=Path(path)), cfg, chunk)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(path) as f:
                rows = [json.loads(line) for line in f]
        shutdown()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    res = dict(launch=ctx.launch_source, backend=backend,
               devices=[str(d) for d in mesh.devices],
               stages=[len(i) for _, i in states["model_X"].model.stages],
               train_wall_s=wall, **loss_summary(rows))
    hold_converged("the split", res)
    got = [[r[k] for k in LOSS_NAMES] for r in rows]
    rel = max(abs(g / w - 1) for gr, wr in zip(got, demo_losses)
              for g, w in zip(gr, wr))
    res["max_rel_vs_phase10"] = rel
    res["equal_to_phase10"] = got == demo_losses
    if ctx.launch_source != "torchrun" or backend != "nccl" \
            or rel > SPLIT_RTOL:
        raise AssertionError(f"the split's losses leave phase 10's: {res}")
    res["mp1_wall_s"], res["mp1"] = mp1["wall_s"], mp1["summary"]
    return res


def model_split_mp1() -> dict:
    """Phase 12's entry point: ``python -m
    tpudist_torch.examples.demo_model_split --model_parallel 1 --dry_run
    --seed 0`` must exit 0 and converge."""
    # from the reference run's seed, as phase 10 (``DEMO_ARGS``): the
    # convergence bound is that run's, and a seed drawn per run ended at
    # 0.304 once
    _, wall, rows = run_module(
        "tpudist_torch.examples.demo_model_split",
        ["--model_parallel", "1", "--dry_run", "--seed", "0"])
    res = dict(wall_s=wall, summary=loss_summary(rows["demo_model_split"]))
    hold_converged("demo_model_split --model_parallel 1", res["summary"])
    return res


def mpi_path() -> dict:
    """Phase 13: ``python -m tpudist_torch.examples.demo_mpi_bootstrap``
    under ``OMPI_COMM_WORLD_RANK=0 OMPI_COMM_WORLD_SIZE=1`` with
    ``MASTER_ADDR``/``MASTER_PORT`` (the env contract: no ``mpi4py``), so
    the NCCL group forms as in phase 10.  It must exit 0, report the mpi
    launch and print final losses at most ``DEMO_LOSS_MAX``."""
    import ast

    env = torchrun_env()
    env = dict(OMPI_COMM_WORLD_RANK="0", OMPI_COMM_WORLD_SIZE="1",
               MASTER_ADDR=env["MASTER_ADDR"], MASTER_PORT=env["MASTER_PORT"])
    out, wall, rows = run_module("tpudist_torch.examples.demo_mpi_bootstrap",
                                 DEMO_ARGS, env)
    found = re.findall(r"final losses: (\{.*\})", out)
    res = dict(wall_s=wall, banner=[line for line in out.splitlines()
                                    if "launch=" in line],
               final=ast.literal_eval(found[-1]) if found else None,
               metric_files=sorted(rows))
    if not ("launch=mpi" in out and "backend=nccl" in out and found
            and not rows and all(v <= DEMO_LOSS_MAX
                                 for v in res["final"].values())):
        raise AssertionError(f"the MPI demo failed its gates: {res}\n"
                             f"{out[-2000:]}")
    return res


def trainer_run(precision: str) -> dict:
    """Phase 14: ``python -m tpudist_torch.examples.demo_trainer --dry_run
    --seed 0`` (the reference's Lightning shape: 1000 steps, batch 128) at
    ``precision`` under the torchrun contract at world size 1; it must
    converge (the last row within ``TRAINER_LAST_MAX``).  Its losses are
    returned under ``losses`` for :func:`trainer_path`."""
    out, wall, r = run_module("tpudist_torch.examples.demo_trainer",
                              TRAINER_BASE + ["--precision", precision],
                              torchrun_env())
    rows = r["demo_trainer"]
    res = dict(wall_s=wall, **loss_summary(rows))
    if "final losses" not in out:
        raise AssertionError(out[-2000:])
    hold_converged(f"demo_trainer --precision {precision}", res,
                   TRAINER_LAST_MAX)
    res["losses"] = [[row[k] for k in LOSS_NAMES] for row in rows]
    return res


def trainer_resume() -> dict:
    """Phase 14's checkpoint round trip: 600 steps saving every 200, then
    ``--resume`` to 1000 in the same directory; the resumed run's losses
    are held by :func:`trainer_path`."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        walls = []
        for total, extra in (("600", []), ("1000", ["--resume"])):
            _, wall, r = run_module(
                "tpudist_torch.examples.demo_trainer",
                TRAINER_BASE + ["--total_iterations", total,
                                "--checkpoint_dir", ck, "--checkpoint_every",
                                "200", *extra],
                torchrun_env(), cwd=tmp)
            walls.append(wall)
        steps = sorted(os.listdir(ck))
    return dict(walls_s=walls, files=steps, losses=[
        [row[k] for k in LOSS_NAMES] for row in r["demo_trainer"]])


def trainer_profile() -> dict:
    """Phase 14's trace: ``python -m tpudist_torch.examples.demo
    --profile_dir`` for ``PROFILE_ITERATIONS``; its trace must exist and
    hold kernel events of the card."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _, wall, _ = run_module(
            "tpudist_torch.examples.demo",
            ["--dry_run", "--seed", "0", "--total_iterations",
             str(PROFILE_ITERATIONS), "--profile_dir", "prof"], cwd=tmp)
        path = os.path.join(tmp, "prof", "process_0", "trace.json")
        size = os.path.getsize(path) if os.path.isfile(path) else 0
        kernels = 0
        if size:
            with open(path) as f:
                trace = json.load(f)
            kernels = sum(1 for e in trace.get("traceEvents", [])
                          if e.get("cat") == "kernel")
    res = dict(wall_s=wall, trace_bytes=size, kernel_events=kernels)
    if not (size > 0 and kernels > 0):
        raise AssertionError(f"the --profile_dir trace is missing or has "
                             f"no kernel: {res}")
    return res


def trainer_path(entry: dict) -> dict:
    """Phase 14 from :func:`entry_point_paths`' runs: fp32 and bf16
    (:func:`trainer_run`), the round trip (:func:`trainer_resume`), whose
    rows 601-1000 must equal the fp32 run's within ``RESUME_RTOL`` (bit
    for bit expected), and the trace (:func:`trainer_profile`)."""
    res = {p: dict(entry[f"trainer {p}"]) for p in ("fp32", "bf16")}
    want = res["fp32"]["losses"][600:]
    for p in res:
        del res[p]["losses"]
    resume = dict(entry["trainer resume"])
    resumed = resume.pop("losses")
    got = resumed[600:]
    rel = max(abs(g / w - 1) for gr, wr in zip(got, want)
              for g, w in zip(gr, wr))
    res["resume"] = dict(resume, rows=len(resumed), bit_for_bit=got == want,
                         max_rel=rel)
    if len(resumed) != DEMO_ITERATIONS or rel > RESUME_RTOL:
        raise AssertionError(f"the resumed run leaves the unbroken one: "
                             f"{res['resume']}")
    res["profile"] = entry["trainer profile"]
    return res


def entry_point_paths(corpus: str) -> dict:
    """Every entry point the smoke runs as a subprocess (phase 10's demos,
    phase 12's ``demo_model_split``, phases 13 and 14, phase 15a on
    ``corpus`` and phase 20 (d)), at most ``SUBPROCESS_WORKERS`` at once,
    the longest first.  Each is paced by its host process and leaves the
    card mostly idle, so together they take about the wall of the longest
    few; the process walls they report are those of a shared host and
    card.  Returns each run's result by name; the first failure raises."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = {"trainer resume": trainer_resume,
            "demo ici": lambda: demo_path("ici"),
            "demo host": lambda: demo_path("host"),
            "trainer bf16": lambda: trainer_run("bf16"),
            "trainer fp32": lambda: trainer_run("fp32"),
            "mpi": mpi_path,
            "lm": lambda: lm_entry_subprocess(corpus),
            "model split mp1": model_split_mp1,
            "pp trainer": pipeline_trainer,
            "trainer profile": trainer_profile,
            "watchdog": watchdog_path}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SUBPROCESS_WORKERS) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        out = {name: f.result() for name, f in futures.items()}
    log(f"entry points as subprocesses, {SUBPROCESS_WORKERS} at once: "
        f"{len(jobs)} runs in {time.perf_counter() - t0:.1f} s of wall")
    return out


# ---------------------------------------------------------------------------
# phase 15: the LM entry point whole


def write_chain_corpus(path: str) -> str:
    """``LM_CORPUS_WINDOWS`` windows of 2048 increment-chain tokens at vocab
    256 from ``LM_CORPUS_SEED``, one flat ``.npy`` stream."""
    import numpy as np

    starts = np.random.default_rng(LM_CORPUS_SEED).integers(
        0, 256, size=(LM_CORPUS_WINDOWS, 1))
    tokens = (starts + np.arange(2048)[None]) % 256
    np.save(path, tokens.astype(np.uint16).ravel())
    return path


def lm_entry_subprocess(corpus: str) -> dict:
    """Phase 15a: ``python -m tpudist_torch.examples.demo_long_context`` at
    phase 7's geometry with ``LM_FLAGS`` (remat ``dots``, the native pool,
    eval every 10, ``--generate 16``) on ``corpus`` for ``LM_STEPS``, a
    subprocess under the torchrun contract at world size 1 (NCCL, DDP, the
    loss all-reduce).  It must exit 0 with one row an iteration, its loss
    falling 0.1 nat (the mean of the last 5 against the first), finite eval
    rows at iterations 0, 10 and 20, and the prompt and its 16 generated
    tokens printed."""
    out, wall, rows = run_module(
        "tpudist_torch.examples.demo_long_context",
        TRAIN_ARGS + LM_FLAGS + ["--data_path", corpus, "--dry_run",
                                 "--total_iterations", str(LM_STEPS)],
        torchrun_env(), timeout=600)
    rows = rows["demo_long_context"]
    lm = [r["loss/lm"] for r in rows]
    evals = {r["iteration"]: r["loss/eval"] for r in rows
             if "loss/eval" in r}
    m = re.search(r"prompt (\[[^\]]*\]) -> (\[[^\]]*\])", out)
    res = dict(wall_s=wall, rows=len(rows), first=lm[0] if lm else None,
               last=lm[-1] if lm else None,
               last5_mean=statistics.mean(lm[-5:]) if lm else None,
               evals=evals, banner=[line for line in out.splitlines()
                                    if "launch=" in line],
               prompt=json.loads(m.group(1)) if m else None,
               generated=json.loads(m.group(2)) if m else None)
    if "launch=torchrun" not in out or "backend=nccl" not in out:
        raise AssertionError(f"the LM entry point did not run on the NCCL "
                             f"group: {res['banner']}")
    if len(rows) != LM_STEPS or not all(map(math.isfinite, lm)) or \
            res["last5_mean"] > lm[0] - 0.1:
        raise AssertionError(f"the LM entry point did not converge: {res}")
    if sorted(evals) != [0, 10, 20] or not all(
            map(math.isfinite, evals.values())):
        raise AssertionError(f"the eval rows are missing or not finite: "
                             f"{evals}")
    if m is None or len(res["generated"]) != 16:
        raise AssertionError(f"--generate printed no 16 tokens: "
                             f"{out[-1500:]}")
    return res


def lm_args(corpus: str, *extra):
    from tpudist_torch.examples.demo_long_context import get_args

    return get_args(TRAIN_ARGS + ["--data_path", corpus, "--eval_fraction",
                                  "0.1", "--total_iterations",
                                  str(LM_STEPS), *extra])


def lm_training(torch, args):
    """The entry point's model, optimizer and step for ``args``."""
    from tpudist_torch.examples.demo_long_context import build_model
    from tpudist_torch.train import (build_optimizer_from_args,
                                     make_lm_train_step)

    model = build_model(args, "cuda")
    opt, sched = build_optimizer_from_args(args, model.parameters())
    return model, make_lm_train_step(model, opt, scheduler=sched)


def lm_loop(torch, step, next_batch, n: int) -> tuple:
    """``n`` steps on ``next_batch()``, synchronized once at the end:
    the host-clock ms per step and the losses."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(next_batch()) for _ in range(n)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, [float(x) for x in losses]


def lm_throughput(torch, args, ms: float) -> dict:
    from tpudist_torch.utils.flops import mfu, transformer_train_flops

    flops = transformer_train_flops(
        batch=args.batch_size, seq_len=args.seq_len, d_model=args.d_model,
        n_layers=args.n_layers, d_ff=args.d_ff, vocab=args.vocab)
    return dict(step_ms=ms, tokens_per_s=args.batch_size * args.seq_len
                / (ms / 1e3),
                mfu=mfu(flops, ms / 1e3, 1, peak_per_chip=H100_BF16_FLOPS))


def lm_entry_in_process(torch, corpus: str, phase7_peak_gb: float) -> dict:
    """Phase 15b: the entry point's configuration in this process.

    - The native pool feeds ``prefetch_to_device`` (``native_available()``,
      the loader a ``PrefetchingTokenBatches``); with counts zeroed after 3
      warm-up steps, ``LM_STEPS`` steps under remat ``dots`` launch the
      flash forward 16 times a step (8 layers, each recomputed) and dq and
      dk/dv 8 times, every launch on the wgmma arms.
    - Step ms, tokens/s, MFU and the idle share of 5 steps
      (:func:`device_profile`), fed by the pool and the prefetch, then by
      the synchronous loader with a copy a step (measured, no claim).
    - ``--generate 16`` from the corpus prompt: each greedy token equals
      the arg-max of the training forward over the sequence so far, or
      that forward's top-2 logits lie within ``NEAR_TIE_GAP``.
    - Peak memory and step ms under each remat policy (4 steps from a
      fresh model, peak statistics reset after building, as phase 7), each
      peak below phase 7's.
    - One step's gradients with remat ``dots`` against the same step
      without remat, same weights and batch: equal bit for bit.
    - ``OPT_STEPS`` steps of adafactor and of lion: the mean of the last 3
      losses below the first by 0.05 nat."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.data import prefetch_to_device
    from tpudist_torch.data.native_loader import native_available
    from tpudist_torch.examples.demo_long_context import open_corpus
    from tpudist_torch.models import generate, lm_loss

    res = {}
    args = lm_args(corpus, "--remat", "--remat_policy", "dots",
                   "--num_workers", "2")
    if not native_available():
        raise AssertionError("the native gather pool did not build on the "
                             "card's machine")
    model, step = lm_training(torch, args)
    windows, stream, _ = open_corpus(args)
    res["loader"] = type(stream).__name__
    if res["loader"] != "PrefetchingTokenBatches":
        raise AssertionError(f"--num_workers 2 gave {res['loader']}, not "
                             f"the native pool's loader")
    batches = prefetch_to_device(stream, "cuda")
    lm_loop(torch, step, lambda: next(batches), 3)
    ops.reset_launch_counts()
    ms, losses = lm_loop(torch, step, lambda: next(batches), LM_STEPS)
    counts = ops.launch_counts()
    wgmma = {n: ops.KERNEL_WRAPPERS[n].launches_wgmma for n in TRAIN_KERNELS}
    res["remat_launches"] = {n: counts[n] for n in TRAIN_KERNELS}
    res["remat_launches_wgmma"] = wgmma
    per_step = {"flash_forward": 16, "flash_backward_dq": 8,
                "flash_backward_dkv": 8}
    for name, k in per_step.items():
        if counts[name] != k * LM_STEPS or wgmma[name] != k * LM_STEPS:
            raise AssertionError(
                f"{name} launched {counts[name]} times ({wgmma[name]} on "
                f"the wgmma arm), not {k} x {LM_STEPS} under remat")
    res["losses"] = losses
    if statistics.mean(losses[-5:]) > losses[0] - 0.1:
        raise AssertionError(f"the in-process run did not converge: "
                             f"{losses}")
    res["prefetch"] = dict(lm_throughput(torch, args, ms), idle=device_profile(
        torch, lambda: [step(next(batches)) for _ in range(5)],
        lambda: None))
    _, sync_stream, _ = open_corpus(lm_args(corpus, "--remat",
                                            "--remat_policy", "dots"))

    def sync_batch():
        return torch.from_numpy(next(sync_stream)).cuda()

    sync_ms, _ = lm_loop(torch, step, sync_batch, 10)
    res["sync"] = dict(lm_throughput(torch, args, sync_ms),
                       idle=device_profile(
                           torch, lambda: [step(sync_batch())
                                           for _ in range(5)],
                           lambda: None))
    batches.close()
    stream.close()

    prompt = torch.from_numpy(windows.gather(np.zeros(1, np.int64))[:, :8])
    out = generate(model, prompt.cuda(), 16)
    with torch.no_grad():
        logits = model(out[:, :-1])[0].float()  # row t predicts token t+1
    ties = []
    for t in range(8, 24):
        want = int(logits[t - 1].argmax())
        if want != int(out[0, t]):
            top = logits[t - 1].topk(2).values
            ties.append((t, float(top[0] - top[1])))
    res["generate"] = dict(prompt=prompt[0].tolist(),
                           tokens=out[0, 8:].tolist(), ties=ties)
    if any(gap > NEAR_TIE_GAP for _, gap in ties):
        raise AssertionError(f"--generate left the full forward's arg-max "
                             f"at no near tie: {ties}")
    del model, step, batches
    torch.cuda.empty_cache()

    fixed = [torch.from_numpy(next(sync_stream)).cuda() for _ in range(4)]
    res["policies"] = {}
    for policy in REMAT_POLICIES:
        model, step = lm_training(torch, lm_args(
            corpus, "--remat", "--remat_policy", policy))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for tokens in fixed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(tokens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        res["policies"][policy] = dict(peak_mem_gb=peak,
                                       step_ms=statistics.median(times[1:]))
        del model, step
        torch.cuda.empty_cache()
        if peak >= phase7_peak_gb:
            raise AssertionError(f"remat {policy} peaks at {peak:.2f} GB, "
                                 f"not below phase 7's {phase7_peak_gb:.2f}")

    grads = {}
    for remat in (False, True):
        extra = ["--remat", "--remat_policy", "dots"] if remat else []
        model, _ = lm_training(torch, lm_args(corpus, *extra))
        lm_loss(model(fixed[0]), fixed[0]).backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
        del model
    diff = max(float((grads[True][n] - grads[False][n]).abs().max())
               for n in grads[False])
    equal = all(torch.equal(grads[True][n], grads[False][n])
                for n in grads[False])
    res["remat_grads"] = dict(bit_for_bit=equal, max_abs_diff=diff,
                              params=len(grads[False]))
    del grads
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError(f"remat's gradients leave the plain step's: "
                             f"{res['remat_grads']}")

    res["optimizers"] = {}
    for opt in ("adafactor", "lion"):
        model, step = lm_training(torch, lm_args(
            corpus, "--optimizer", opt, "--lr", OPT_LR[opt]))
        _, losses = lm_loop(torch, step, sync_batch, OPT_STEPS)
        res["optimizers"][opt] = losses
        del model, step
        torch.cuda.empty_cache()
        if statistics.mean(losses[-3:]) > losses[0] - 0.05:
            raise AssertionError(f"{opt} did not lower the loss in "
                                 f"{OPT_STEPS} steps: {losses}")
    return res


# ---------------------------------------------------------------------------
# phase 22: runtime robustness and telemetry


@contextlib.contextmanager
def env_set(**values):
    """Set environment variables for the block (None unsets one), then
    put every one back as it was."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class EventedBatches:
    """Phase 7's batches as a Trainer loader that records a CUDA event on
    the current stream as it hands each batch over: the Trainer logs each
    step's loss (a host sync) before it asks for the next batch, so the
    interval between two events is one step on the card's clock, the
    host's dispatch gaps included."""

    def __init__(self, torch, batches):
        self.torch, self.batches, self.events = torch, batches, []

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            yield b

    def step_ms(self) -> list:
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                   self.events[1:])]


def phase22_trainer_fit(torch, batches, **fields) -> dict:
    """One fit of the Trainer's LM loop on phase 7's model (its own bf16
    compute over f32 masters, Adam at 3e-4: ``TRAIN_ARGS``) over
    ``batches``, in a temporary working directory (the Trainer's metric
    rows land under it).  Returns the rows' losses by iteration, the
    CUDA-event step intervals, the launches and whether it was preempted."""
    import tempfile

    from tpudist_torch import ops
    from tpudist_torch.examples.demo_long_context import (build_model,
                                                          get_args)
    from tpudist_torch.train.optim import build_optimizer_from_args
    from tpudist_torch.trainer import LMTrainerModule, Trainer

    args = get_args(TRAIN_ARGS + ["--total_iterations",
                                  str(PHASE22_STEPS)])

    class Phase7LM(LMTrainerModule):
        def configure_lm(self, generator):
            return build_model(args, torch.device(args.device))

        def configure_optimizers(self):
            return lambda params: build_optimizer_from_args(args, params)

    loader = EventedBatches(torch, batches)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            trainer = Trainer(max_steps=PHASE22_STEPS, progress_bar=False,
                              dry_run=True, seed=0, group="phase22",
                              device=args.device, **fields)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            trainer.fit(Phase7LM(), loader)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            wgmma = {n: ops.KERNEL_WRAPPERS[n].launches_wgmma
                     for n in TRAIN_KERNELS}
            with open(os.path.join("runs", "phase22",
                                   "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
        finally:
            os.chdir(cwd)
    preempted = trainer.preempted
    del trainer
    torch.cuda.empty_cache()
    return dict(losses=[r["loss/lm"] for r in rows], wall_s=wall,
                step_ms=loader.step_ms(), launches=counts,
                launches_wgmma=wgmma, preempted=preempted)


def phase22_train(torch, card: str) -> dict:
    """Phase 22 (a): the Trainer's LM loop at phase 7's model, three fits,
    each recording into a telemetry session it does not own: 12 steps
    unbroken under an armed watchdog; the same with
    ``TPUDIST_FAULT=sigterm@step:6`` and ``checkpoint_every=4``, which
    must stop at step 6 with a forced save stamped ``preempted``; and
    ``resume=True`` at ``TPUDIST_RESTART_COUNT=1`` to step 12.  The drill
    and its resume share a telemetry directory (generations 0 and 1)."""
    import tempfile

    from tpudist_torch import telemetry
    from tpudist_torch.examples.demo_long_context import get_args, make_batch
    from tpudist_torch.runtime import faults

    import numpy as np

    args = get_args(TRAIN_ARGS)
    rng = np.random.default_rng(args.seed)  # phase 7's batches
    batches = [make_batch(rng, args.batch_size, args.seq_len, args.vocab)
               for _ in range(PHASE22_STEPS)]
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    try:
        with env_set(TPUDIST_WATCHDOG_S=PHASE22_WATCHDOG_S,
                     TPUDIST_RESTART_COUNT="0", TPUDIST_FAULT=None):
            telemetry.start(os.path.join(root, "unbroken"))
            try:
                whole = phase22_trainer_fit(torch, batches)
            finally:
                report = telemetry.finish()
        per_step = LAYERS * PHASE22_STEPS
        for name in TRAIN_KERNELS:
            n, wg = whole["launches"][name], whole["launches_wgmma"][name]
            if n != per_step or wg != per_step:
                raise AssertionError(
                    f"phase 22 (a): {name} launched {n} times ({wg} on the "
                    f"wgmma arm) in {PHASE22_STEPS} steps, not {per_step}")
        if whole["preempted"] or len(whole["losses"]) != PHASE22_STEPS:
            raise AssertionError("phase 22 (a): the unbroken fit did not "
                                 "run its 12 steps")
        ck = os.path.join(root, "ck")
        drill_dir = os.path.join(root, "drill")
        with env_set(TPUDIST_FAULT=f"sigterm@step:{PHASE22_SIGTERM_AT}",
                     TPUDIST_RESTART_COUNT="0"):
            telemetry.start(drill_dir)
            try:
                drill = phase22_trainer_fit(
                    torch, batches, checkpoint_dir=ck,
                    checkpoint_every=PHASE22_CKPT_EVERY)
            finally:
                telemetry.finish(write_report=False)
                faults.disarm()
        files = sorted(os.listdir(ck))
        meta = torch.load(os.path.join(ck, f"step_{PHASE22_SIGTERM_AT}.pt"),
                          map_location="cpu", weights_only=True)["meta"]
        if not drill["preempted"] or meta.get("preempted") is not True \
                or meta.get("iteration") != PHASE22_SIGTERM_AT:
            raise AssertionError(f"phase 22 (a): the drill did not stop at "
                                 f"{PHASE22_SIGTERM_AT} with a preempted "
                                 f"save: preempted {drill['preempted']}, "
                                 f"meta {meta}, files {files}")
        want = [f"step_{PHASE22_CKPT_EVERY}.pt",
                f"step_{PHASE22_SIGTERM_AT}.pt"]
        if files != want or len(drill["losses"]) != PHASE22_SIGTERM_AT:
            raise AssertionError(f"phase 22 (a): drill files {files} (want "
                                 f"{want}), {len(drill['losses'])} rows")
        with env_set(TPUDIST_RESTART_COUNT="1", TPUDIST_FAULT=None):
            telemetry.start(drill_dir)
            try:
                resumed = phase22_trainer_fit(
                    torch, batches, checkpoint_dir=ck, resume=True)
            finally:
                both = telemetry.finish()
    finally:
        tmp.cleanup()
    tail = whole["losses"][PHASE22_SIGTERM_AT:]
    got = drill["losses"] + resumed["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, whole["losses"]))
    if len(got) != PHASE22_STEPS or rel > RESUME_RTOL:
        raise AssertionError(f"phase 22 (a): the drill and its resume "
                             f"{got} left the unbroken run {tail} by "
                             f"{rel:.2e} (bound {RESUME_RTOL})")
    if resumed["preempted"]:
        raise AssertionError("phase 22 (a): the resumed fit was preempted")
    gp_sum, wall = both["goodput_sum_s"], both["wall_clock_s"]
    if both["generations"] != 2 or abs(gp_sum - wall) > 0.01 * wall:
        raise AssertionError(f"phase 22 (a): the report over both "
                             f"generations sums its goodput to {gp_sum} s "
                             f"of {wall} s ({both['generations']} "
                             f"generations)")
    ev = statistics.median(whole["step_ms"][1:])
    span_p50 = report["step"]["p50_s"] * 1e3
    if abs(span_p50 - ev) > PHASE22_STEP_SPAN_REL * ev:
        raise AssertionError(f"phase 22 (a): the report's step p50 "
                             f"{span_p50:.2f} ms is not within "
                             f"{PHASE22_STEP_SPAN_REL:.0%} of the CUDA-event "
                             f"step interval p50 {ev:.2f} ms")
    res = dict(losses=whole["losses"], drill_losses=drill["losses"],
               resumed_losses=resumed["losses"], max_rel=rel,
               bit_for_bit=got == whole["losses"], files=files, meta=meta,
               launches=whole["launches"],
               launches_wgmma=whole["launches_wgmma"],
               report_step_p50_ms=span_p50,
               event_step_ms_p50=ev, event_step_ms=whole["step_ms"],
               goodput={k: v["s"] for k, v in both["goodput"].items()},
               goodput_sum_s=gp_sum, wall_clock_s=wall,
               walls_s=[whole["wall_s"], drill["wall_s"],
                        resumed["wall_s"]])
    log(f"phase 22 (a) Trainer LM, phase 7's model, {PHASE22_STEPS} steps "
        f"under the watchdog ({PHASE22_WATCHDOG_S} s): launches "
        f"{ {n: whole['launches'][n] for n in TRAIN_KERNELS} } all wgmma; "
        f"sigterm@step:{PHASE22_SIGTERM_AT} stopped at "
        f"{meta['iteration']} (files {files}, meta {meta}); resumed steps "
        f"{PHASE22_SIGTERM_AT + 1}-{PHASE22_STEPS} against the unbroken "
        f"run: bit for bit {res['bit_for_bit']}, max rel {rel:.2e}; the "
        f"report over both generations: goodput {res['goodput']} summing "
        f"to {gp_sum:.3f} of {wall:.3f} s (a check that no spans "
        f"overlap: idle is the rest); step p50 in the report "
        f"{span_p50:.2f} ms (the span ends on the logged loss) beside the "
        f"CUDA-event step interval p50 {ev:.2f} ms (bound "
        f"{PHASE22_STEP_SPAN_REL:.0%}); fit walls {[round(w, 2) for w in res['walls_s']]} "
        f"s ({card})")
    return res


def http_get(port: int, path: str) -> tuple:
    """``(status, body)`` of a GET on the loopback endpoint."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def phase22_serve_run(torch, model, tele_dir=None, drain=False,
                      endpoints=True) -> dict:
    """One phase 22 serving run: phase 4's server and 16 requests, every
    request queued before the server starts (phase 21's schedule), with a
    telemetry session into ``tele_dir`` and, with ``endpoints``, the
    endpoints on an ephemeral loopback port (``TPUDIST_METRICS_PORT=0``),
    read mid-serve (``/healthz``, ``/statusz``) and after (``/metrics``);
    or with ``TPUDIST_TELEMETRY=0`` when ``tele_dir`` is None.  With
    ``drain`` it signals SIGTERM to its own process first and holds the
    drain (new submits refused ``draining``, the admitted requests
    finishing)."""
    import signal

    import numpy as np

    from tpudist_torch import ops, telemetry
    from tpudist_torch.serve import AdmissionError, InferenceServer, \
        ServeConfig
    from tpudist_torch.telemetry import statusz

    rng = np.random.default_rng(7)
    rng.integers(0, V, size=70)  # phase 4's warm-up prompt
    reqs = [(rng.integers(0, V, size=int(rng.integers(1, 301))),
             int(rng.integers(16, 65))) for _ in range(16)]
    on = tele_dir is not None
    scrape = on and endpoints and not drain
    mid = {}
    with env_set(TPUDIST_TELEMETRY=None if on else "0",
                 TPUDIST_METRICS_PORT="0" if scrape else None):
        if on:
            telemetry.start(tele_dir)
        cfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                          prefill_pad=P, decode_block=8, kv_block=BS)
        server = InferenceServer(model, cfg, device="cuda")
        try:
            handles = [server.submit(p, max_new=n) for p, n in reqs]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            server.start()
            if drain:
                if not server._installed_preemption:
                    raise AssertionError("phase 22 (c): the server did not "
                                         "install its SIGTERM handler")
                os.kill(os.getpid(), signal.SIGTERM)
                deadline = time.monotonic() + 60
                while not server._draining and time.monotonic() < deadline:
                    time.sleep(0.001)
                try:
                    server.submit(reqs[0][0], max_new=4)
                    mid["refused"] = None
                except AdmissionError as e:
                    mid["refused"] = e.reason
            if scrape:
                port = statusz.active().port
                mid["healthz"] = http_get(port, "/healthz")[0]
                mid["statusz"] = json.loads(http_get(port, "/statusz")[1])
                mid["in_flight"] = sum(not h.done for h in handles)
            for h in handles:
                if not h.wait(900):
                    raise AssertionError("request timed out")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            if scrape:
                mid["metrics"] = http_get(port, "/metrics")[1]
        finally:
            server.close(60)
            statusz.stop()
            report = telemetry.finish() if on else None
    for h, (_, n) in zip(handles, reqs):
        if h.finish_reason != "length" or len(h.tokens) != n:
            raise AssertionError(f"phase 22 request {h.id}: "
                                 f"{h.finish_reason}, {len(h.tokens)}/{n} "
                                 "tokens")
    tokens = sum(len(h.tokens) for h in handles)
    return dict(streams=[h.tokens for h in handles],
                prompts=[p for p, _ in reqs], launches=counts, wall_s=wall,
                tokens=tokens, tokens_per_s=tokens / wall,
                ttft_s=[h.ttft_s for h in handles],
                tpot_s=[h.tpot_s for h in handles], mid=mid, report=report)


def nearest_rank(vals, q: float) -> float:
    """The nearest-rank percentile the report and the sketch use."""
    s = sorted(vals)
    return s[max(0, min(len(s) - 1, int(round(q / 100 * (len(s) - 1)))))]


def phase22_serve(torch, model, main_path: dict, mesh: dict,
                  card: str) -> dict:
    """Phase 22 (b) and (c) on phase 4's model: the telemetry run, one run
    with ``TPUDIST_TELEMETRY=0`` and the SIGTERM drain run, in turns (see
    :func:`phase22_serve_run`).  Gates: mid-serve ``/healthz`` 200 and
    ``/statusz`` carrying the KV gauges, ``/metrics`` the token counter
    and the TTFT and TPOT sketches; the streams and the launch counts
    equal phase 21's unsharded run of phase 4's traffic on the same
    schedule, and greedy lanes equal phase 4's or leave at a near tie;
    the off run's launches equal the on run's (telemetry launches
    nothing); the report's TTFT and TPOT p50 and the sketch's within
    ``QUANTILE_REL_ERROR`` of the handles' exact values; the trace CLI
    writes one lifeline a request; the drain emits ``serve_drain``,
    refuses new submits ``draining`` and finishes every admitted
    request."""
    import tempfile

    from tpudist_torch.telemetry import aggregate, metrics
    from tpudist_torch.telemetry.metrics import QUANTILE_REL_ERROR

    tmp = tempfile.TemporaryDirectory()
    try:
        metrics.registry().clear()
        tdir = os.path.join(tmp.name, "serve")
        on = phase22_serve_run(torch, model, tdir)
        sketch = {k: metrics.registry().histogram(
            f"tpudist_{k}_seconds", tenant="default").quantile(50)
            for k in ("ttft", "tpot")}
        off = phase22_serve_run(torch, model)
        # telemetry without the endpoints' scrapes and without, in turns:
        # the spans' own cost beside the run-to-run spread
        turns = [phase22_serve_run(torch, model,
                                   os.path.join(tmp.name, "serve2"),
                                   endpoints=False),
                 phase22_serve_run(torch, model)]
        ddir = os.path.join(tmp.name, "drain")
        drain = phase22_serve_run(torch, model, ddir, drain=True)
        drain_names = [r["name"] for r in aggregate.load_records(ddir)]
        proc = subprocess.run(
            [sys.executable, "-m", "tpudist_torch.telemetry", "trace", tdir],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(
                os.path.abspath(__file__))))
        with open(os.path.join(tdir, "trace.json")) as f:
            traces = json.load(f)["otherData"]["traces"]
    finally:
        tmp.cleanup()
    mid = on["mid"]
    doc = mid["statusz"]["serve"]
    if mid["healthz"] != 200 or "kv" not in doc \
            or doc["kv"]["block_occupancy"] is None or mid["in_flight"] < 1:
        raise AssertionError(f"phase 22 (b): mid-serve /healthz "
                             f"{mid['healthz']}, /statusz {doc}, "
                             f"{mid['in_flight']} requests in flight")
    for name in ("tpudist_tokens_out_total", "tpudist_ttft_seconds",
                 "tpudist_tpot_seconds"):
        if name not in mid["metrics"]:
            raise AssertionError(f"phase 22 (b): /metrics lacks {name}")
    base = mesh["unsharded"]["plain"]
    if on["launches"] != base["launches"] \
            or on["streams"] != mesh["plain_streams"]:
        raise AssertionError(f"phase 22 (b): launches {on['launches']} "
                             f"or streams differ from phase 21's "
                             f"unsharded run on the same schedule "
                             f"({base['launches']})")
    for r in [off] + turns:
        if r["launches"] != on["launches"]:
            raise AssertionError(f"phase 22 (b): telemetry moved the "
                                 f"launches: {on['launches']} on, "
                                 f"{r['launches']} in a later turn")
    equal, ties = hold_greedy_streams(torch, model, on["prompts"],
                                      on["streams"], main_path["streams"],
                                      range(16))
    rep = on["report"]["serving"]
    quant = {}
    for k, vals in (("ttft", on["ttft_s"]), ("tpot", on["tpot_s"])):
        exact = nearest_rank(vals, 50)
        quant[k] = dict(exact_s=exact, report_s=rep[k]["p50_s"],
                        sketch_s=sketch[k])
        for got in (rep[k]["p50_s"], sketch[k]):
            if abs(got - exact) > QUANTILE_REL_ERROR * exact:
                raise AssertionError(f"phase 22 (b): {k} p50 {got} against "
                                     f"the handles' {exact}")
    if proc.returncode != 0 or traces != 16:
        raise AssertionError(f"phase 22 (b): the trace CLI wrote {traces} "
                             f"lifelines: {proc.stdout}{proc.stderr}")
    if drain["mid"]["refused"] != "draining" \
            or "serve_drain" not in drain_names \
            or drain_names.count("request_finished") != 16:
        raise AssertionError(f"phase 22 (c): refused "
                             f"{drain['mid']['refused']}, records "
                             f"{sorted(set(drain_names))}")
    res = dict(launches=on["launches"], tokens_per_s=dict(
        on=[on["tokens_per_s"], turns[0]["tokens_per_s"]],
        off=[off["tokens_per_s"], turns[1]["tokens_per_s"]],
        drain=drain["tokens_per_s"]), p50=quant, lanes_equal_phase4=equal,
        near_ties=ties, statusz_kv=doc["kv"], traces=traces,
        report_requests=rep["requests_finished"])
    log(f"phase 22 (b) phase 4's server, 16 requests queued before start "
        f"with telemetry and the endpoints: /healthz {mid['healthz']} with "
        f"{mid['in_flight']} in flight, /statusz kv {doc['kv']}; launches "
        f"{on['launches']} equal phase 21's unsharded run and the "
        f"TPUDIST_TELEMETRY=0 run's; greedy lanes equal phase 4's "
        f"{equal}/16 (near ties {ties}); p50 exact/report/sketch {quant}; "
        f"trace CLI {traces} lifelines; tokens/s in turns (on and "
        f"scraped, off, on, off; not gated): "
        f"{[round(r['tokens_per_s'], 1) for r in (on, off, *turns)]} "
        f"({card})")
    log(f"phase 22 (c) SIGTERM after start: serve_drain emitted, a new "
        f"submit refused '{drain['mid']['refused']}', the 16 admitted "
        f"requests finished ({drain['tokens_per_s']:.1f} tokens/s)")
    return res


# phase 23: graceful degradation and the fleet


def p23_config(**knobs):
    """Phase 4's server geometry (the kernel arms) with ``knobs``."""
    from tpudist_torch.serve import ServeConfig

    return ServeConfig(**{**dict(num_slots=SLOTS, queue_limit=64,
                                 max_new=64, prefill_pad=P, decode_block=8,
                                 kv_block=BS), **knobs})


class Timed:
    """Wrap ``obj.name`` so each call is timed on the host clock after a
    ``torch.cuda.synchronize()`` on both sides (the card's work included);
    ``sink`` gets ``(seconds, result)``.  ``undo()`` restores it."""

    def __init__(self, torch, obj, name: str, sink: list):
        self.obj, self.name = obj, name
        self.orig = getattr(obj, name)
        orig = self.orig

        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0, out))
            return out

        setattr(obj, name, wrapped)

    def undo(self) -> None:
        setattr(self.obj, self.name, self.orig)


def p23_hold(what: str, ok: bool, detail) -> None:
    if not ok:
        raise AssertionError(f"phase 23 {what}: {detail}")


def launches_since(before: dict) -> dict:
    """Each kernel's launches since ``before`` (an earlier
    ``ops.launch_counts()``): a sub-phase's count without zeroing the
    counts that an enclosing phase reads."""
    from tpudist_torch import ops

    return {k: n - before.get(k, 0) for k, n in ops.launch_counts().items()}


def p23_hold_launches(what: str, launches: dict) -> None:
    """Gate: every serving kernel launched in ``what``'s serving runs."""
    p23_hold(what, all(launches.get(k, 0) > 0 for k in SERVE_KERNELS),
             f"a serving kernel never launched: {launches}")


def p23_parting(torch, model, prompt, got, want, lp_want):
    """Where greedy stream ``got`` parts from ``want``: the position and
    the top-2 margin of ``want``'s run there — from its ``logprobs=2``
    rows, or, at a prefill-sampled first token (no row), from the card's
    bf16 logits over the teacher-forced prefix (:func:`near_tie_gap`)."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        raise AssertionError("phase 23: a stream ends early on the same "
                             "tokens")
    row = lp_want[j] if lp_want is not None and j < len(lp_want) else None
    if row is None:
        return near_tie_gap(torch, model, prompt, got, want)
    return j, float(row[1][0] - row[1][1])


def p23_preempt_run(torch, model, preempt: bool, low_new: int,
                    high_new: int, logprobs: int = 0) -> dict:
    """Phase 23 (a), one run: phase 4's first 8 requests (greedy and phase
    4's sampled lane, ``low_new`` new tokens) queued before the server
    starts, so all 8 admit in the first batch; once every one of them has
    its first decode block the 4 priority-1 requests (``high_new``) are
    submitted from the engine thread (a token callback), so both runs see
    the same schedule up to the preemption.  Host tier on; ``preempt`` on
    or off; ``logprobs=2`` records the low lanes' top-2 rows.  The export,
    serialize, deserialize and import of each moved lane are timed."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.serve import InferenceServer, disagg

    _, reqs, temps, _ = phase4_traffic(7)
    rng = np.random.default_rng(23)
    high = [rng.integers(0, V, size=int(rng.integers(64, 257)))
            for _ in range(P23_HIGH)]
    server = InferenceServer(model, p23_config(host_tier=True,
                                               preempt=preempt,
                                               logprobs=logprobs),
                             device="cuda")
    sinks = {k: [] for k in ("export", "put", "deser", "import",
                             "preempt")}
    timers = [Timed(torch, server.engine, "export_slot", sinks["export"]),
              Timed(torch, server._tier, "put", sinks["put"]),
              Timed(torch, server.engine, "import_slot", sinks["import"]),
              Timed(torch, disagg, "deserialize_package", sinks["deser"])]
    orig_preempt = server._preempt_slot

    def preempt_slot(slot, h, by):
        sinks["preempt"].append(h.id)
        return orig_preempt(slot, h, by)

    server._preempt_slot = preempt_slot
    lows, highs = [], []

    def trigger(_tok, _idx):
        if not highs and len(lows) == 8 \
                and all(len(h.tokens) >= 2 for h in lows):
            highs.extend(server.submit(p, max_new=high_new, priority=1)
                         for p in high)

    before = ops.launch_counts()
    try:
        for i, (p, _) in enumerate(reqs[:8]):
            lows.append(server.submit(p, max_new=low_new,
                                      temperature=temps[i], seed=i,
                                      on_token=trigger, logprobs=logprobs))
        torch.cuda.synchronize()
        server.start()
        for h in lows:
            if not h.wait(600):
                raise AssertionError("phase 23 (a): a request timed out")
        if len(highs) != P23_HIGH or not all(h.wait(600) for h in highs):
            raise AssertionError("phase 23 (a): the priority-1 requests did "
                                 "not finish")
        torch.cuda.synchronize()
        launches = launches_since(before)
        stats = server.stats()
    finally:
        for t in timers:
            t.undo()
        server.close(60)
    for h in lows + highs:
        want = low_new if h in lows else high_new
        p23_hold("(a)", h.finish_reason == "length" and len(h.tokens)
                 == want, f"request {h.id} {h.finish_reason} "
                 f"{len(h.tokens)}/{want}")
    ids = [h.id for h in lows]
    moved = [ids.index(i) for i in sinks["preempt"]]
    n = len(moved)
    bytes_ = [int(out) for _, out in sinks["put"] if out is not None]
    return dict(
        streams=[h.tokens for h in lows],
        logprobs=[h.logprobs for h in lows], preempted=moved,
        preemptions=server.preemptions, resumes=server.tier_resumes,
        parked_after=stats["parked"],
        high_ttft_ms=[1e3 * h.ttft_s for h in highs],
        export_serialize_ms=[1e3 * (e[0] + p_[0]) for e, p_ in
                             zip(sinks["export"][:n], sinks["put"][:n])],
        deserialize_import_ms=[1e3 * (d[0] + i[0]) for d, i in
                               zip(sinks["deser"], sinks["import"])],
        package_bytes=bytes_, tier=stats["host_tier"], launches=launches)


def p23_session_traffic(n: int):
    import numpy as np

    rng = np.random.default_rng(2323)
    turn1 = [rng.integers(0, V, size=int(rng.integers(200, 301)))
             for _ in range(n)]
    extra = [rng.integers(0, V, size=int(rng.integers(32, 65)))
             for _ in range(n)]
    return turn1, extra


def p23_session_run(torch, model, tier: bool, n: int = P23_SESSIONS,
                    corrupt: bool = False) -> dict:
    """Phase 23 (b)/(d), one run: ``n`` sessions' turn 1 queued before the
    server starts, then, once all finished (and parked), their turn 2
    with ``logprobs=2``.  Returns the run's launches and turn 2's
    (differences of the counts, which stay running).  Host tier on or
    off; ``corrupt`` arms ``host_tier_corrupt@nth:1``."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.runtime import faults
    from tpudist_torch.serve import InferenceServer

    turn1, extra = p23_session_traffic(P23_SESSIONS)
    turn1, extra = turn1[:n], extra[:n]
    server = InferenceServer(model, p23_config(host_tier=tier, logprobs=2),
                             device="cuda")
    if corrupt:
        faults.arm("host_tier_corrupt@nth:1")
    start = ops.launch_counts()
    try:
        h1 = [server.submit(p, max_new=P23_TURN_NEW, session=f"s{i}")
              for i, p in enumerate(turn1)]
        server.start()
        for h in h1:
            if not h.wait(600) or h.finish_reason != "length":
                raise AssertionError(f"phase 23 (b): turn 1 {h.id} "
                                     f"{h.finish_reason}")
        torch.cuda.synchronize()
        parked = server._tier.parks if tier else 0
        prompts = [np.concatenate([p, np.asarray(h.tokens, np.int32), x])
                   for p, h, x in zip(turn1, h1, extra)]
        before = ops.launch_counts()
        h2 = [server.submit(p, max_new=P23_TURN_NEW, session=f"s{i}",
                            logprobs=2) for i, p in enumerate(prompts)]
        for h in h2:
            if not h.wait(600):
                raise AssertionError("phase 23 (b): turn 2 timed out")
        torch.cuda.synchronize()
        counts = launches_since(before)
        launches = launches_since(start)
    finally:
        if corrupt:
            faults.disarm()
        server.close(60)
    for h in h2:
        p23_hold("(b)", h.finish_reason in ("length", "session_resumed")
                 and len(h.tokens) == P23_TURN_NEW,
                 f"turn 2 {h.id} {h.finish_reason} {len(h.tokens)}")
    # a resumed lane prefills prompt[pos:], pos = turn 1's prompt and
    # stream less the stream's last token (the pending position)
    suffix = [len(p2) - (len(p1) + P23_TURN_NEW - 1)
              for p1, p2 in zip(turn1, prompts)]
    return dict(
        prompts=prompts, streams=[h.tokens for h in h2],
        logprobs=[h.logprobs for h in h2],
        resumed=[bool(h.resumed) for h in h2], parks=parked,
        resumes=server.tier_resumes, corrupt=server.tier_corrupt,
        ttft_ms=[1e3 * h.ttft_s for h in h2], prefill_launches=counts.get(
            "paged_prefill", 0), turn2_launches=counts, launches=launches,
        suffix=suffix,
        suffix_chunks=[-(-s // P) for s in suffix])


def p23_burst(torch, model, shed: bool) -> dict:
    """Phase 23 (c), one run of the burst: the gold tenant's
    ``P23_GOLD_ALONE`` requests one at a time on the idle server, then 8
    bulk lanes filling the slots and, once every filling lane has its
    first token, the gold tenant's ``P23_GOLD`` requests (priority 1),
    which wait for a slot.  With ``shed`` the controller is on (the SLO is
    the caller's ``TPUDIST_SLO_TTFT_MS``), ``P23_BULK`` bulk requests are
    queued behind the filling lanes for it to shed, the first flip's time
    is stamped and a bulk submit right after it is tried.  The calibration
    run (``shed`` off) leaves the queued bulk requests out: the gold
    requests outrank them, so they do not move a gold TTFT."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.serve import AdmissionError, InferenceServer

    rng = np.random.default_rng(2324)
    prompt = lambda: rng.integers(0, V, size=int(  # noqa: E731
        rng.integers(64, 129)))
    gold_p = [prompt() for _ in range(P23_GOLD_ALONE + P23_GOLD)]
    fill_p = [prompt() for _ in range(SLOTS)]
    bulk_p = [prompt() for _ in range(P23_BULK)] if shed else []
    server = InferenceServer(model, p23_config(shed=shed), device="cuda")
    ctrl, flip_at = server._ctrl, []
    if shed:
        orig_tick = ctrl.tick

        def tick(now=None):
            out = orig_tick(now)
            if ctrl.shed_active and not flip_at:
                flip_at.append(time.monotonic() if now is None else now)
            return out

        ctrl.tick = tick
    gold = lambda p: server.submit(  # noqa: E731
        p, max_new=P23_GOLD_NEW, priority=1, tenant="gold")
    before = ops.launch_counts()
    try:
        server.start()
        alone = []
        for p in gold_p[:P23_GOLD_ALONE]:
            alone.append(gold(p))
            if not alone[-1].wait(600):
                raise AssertionError("phase 23 (c): timed out")
        shed_before_burst = bool(shed and ctrl.shed_active)
        fill = [server.submit(p, max_new=P23_FILL_NEW, priority=0,
                              tenant="bulk") for p in fill_p]
        bulk = [server.submit(p, max_new=P23_BULK_NEW, priority=0,
                              tenant="bulk") for p in bulk_p]
        deadline = time.monotonic() + 120
        while not all(h.tokens or h.done for h in fill) \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        burst = [gold(p) for p in gold_p[P23_GOLD_ALONE:]]
        late = None
        if shed:
            while not flip_at and time.monotonic() < deadline:
                time.sleep(0.001)
            try:
                bulk.append(server.submit(prompt(), max_new=8, priority=0,
                                          tenant="bulk"))
            except AdmissionError as e:
                late = e.reason
        for h in alone + fill + bulk + burst:
            if not h.wait(600):
                raise AssertionError("phase 23 (c): timed out")
        torch.cuda.synchronize()
        launches = launches_since(before)
        stats = server.stats().get("overload")
    finally:
        server.close(60)
    return dict(alone=alone, fill=fill, bulk=bulk, burst=burst,
                flip_at=flip_at[0] if flip_at else None, late=late,
                shed_before_burst=shed_before_burst, stats=stats,
                launches=launches)


def p23_overload(torch, model) -> dict:
    """Phase 23 (c): the calibration run (no controller) places the TTFT
    SLO between the gold tenant's TTFT alone and under the burst (their
    geometric mean); the shed run repeats the burst under that SLO; the
    fair-share run follows (module doc)."""
    import tempfile

    import numpy as np

    from tpudist_torch import ops, telemetry
    from tpudist_torch.serve import AdmissionError, InferenceServer
    from tpudist_torch.telemetry import metrics

    cal = p23_burst(torch, model, shed=False)
    alone_ms = max(1e3 * h.ttft_s for h in cal["alone"])
    burst_ms = min(1e3 * h.ttft_s for h in cal["burst"])
    p23_hold("(c)", burst_ms >= P23_BURST_RATIO * alone_ms,
             f"the burst delays the gold tenant to {burst_ms:.2f} ms from "
             f"{alone_ms:.2f} ms alone, less than {P23_BURST_RATIO}x")
    slo_ms = math.sqrt(alone_ms * burst_ms)
    rng = np.random.default_rng(2325)
    prompt = lambda: rng.integers(0, V, size=int(  # noqa: E731
        rng.integers(64, 129)))
    tmp = tempfile.TemporaryDirectory()
    telemetry.finish(write_report=False)
    metrics.registry().clear()
    try:
        with env_set(TPUDIST_SLO_TTFT_MS=repr(slo_ms)):
            telemetry.start(os.path.join(tmp.name, "shed"))
            run = p23_burst(torch, model, shed=True)
            telemetry.finish(write_report=False)
        metrics.registry().clear()
        telemetry.start(os.path.join(tmp.name, "fair"))
        server = InferenceServer(model, p23_config(
            fair_share=P23_FAIR_SHARE, queue_limit=P23_FAIR_QUEUE),
            device="cuda")
        before = ops.launch_counts()
        try:
            mouse = [server.submit(prompt(), max_new=8, tenant="mouse")]
            hogs = [server.submit(prompt(), max_new=P23_HOG_NEW,
                                  tenant="hog") for _ in range(SLOTS)]
            server.start()
            deadline = time.monotonic() + 120
            while (server._ctrl._fair_tenants < 2
                   or sum(len(h.tokens) for h in hogs) < 100) \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
            mouse += [server.submit(prompt(), max_new=8, tenant="mouse")
                      for _ in range(P23_FAIR_QUEUE // 2 + 1)]
            pending = server.scheduler.pending()
            try:
                hogs.append(server.submit(prompt(), max_new=8,
                                          tenant="hog"))
                hog_reason = None
            except AdmissionError as e:
                hog_reason = e.reason
            for h in mouse + hogs:
                if not h.wait(600):
                    raise AssertionError("phase 23 (c): timed out")
            torch.cuda.synchronize()
            fair_launches = launches_since(before)
            fair_stats = server.stats()["overload"]
        finally:
            server.close(60)
            telemetry.finish(write_report=False)
    finally:
        metrics.registry().clear()
        tmp.cleanup()
    st, flip = run["stats"], run["flip_at"]
    bulk = run["fill"] + run["bulk"]
    shed = [h for h in bulk if h.finish_reason == "shed_load"]
    served_first = [h for h in bulk if h.finish_reason == "length"
                    and flip is not None and h.t_done < flip]
    p23_hold("(c)", not run["shed_before_burst"]
             and all(1e3 * h.ttft_s <= slo_ms for h in run["alone"]),
             f"the gold tenant alone missed the {slo_ms:.2f} ms SLO: "
             f"{[1e3 * h.ttft_s for h in run['alone']]} ms")
    p23_hold("(c)", st["flips"] >= 1 and flip is not None
             and min(st["last_attainment"].values()) < st[
                 "shed_attainment_target"],
             f"no shed_state flip under the burst: {st}")
    p23_hold("(c)", {h.finish_reason for h in run["alone"] + run["burst"]}
             == {"length"}, "protected requests "
             f"{[h.finish_reason for h in run['alone'] + run['burst']]}")
    p23_hold("(c)", {h.finish_reason for h in bulk}
             <= {"length", "shed_load"} and len(shed) >= 1
             and len(shed) == st["sheds"] and len(served_first) >= 1,
             f"bulk reasons {[h.finish_reason for h in bulk]}, served "
             f"before the flip {len(served_first)}, {st}")
    p23_hold("(c)", run["late"] == "shed_load",
             f"a bulk submit after the flip: {run['late']}")
    p23_hold("(c)", pending * 2 > P23_FAIR_QUEUE
             and hog_reason is not None
             and hog_reason.startswith("fair_share")
             and fair_stats["fair_rejects"] == 1,
             f"pending {pending}, the hog's submit {hog_reason}, "
             f"{fair_stats}")
    p23_hold("(c)", all(h.finish_reason == "length" for h in mouse + hogs),
             f"fair run reasons {[h.finish_reason for h in mouse + hogs]}")
    launches = {k: run["launches"][k] + fair_launches[k]
                for k in fair_launches}
    return dict(
        slo_ms=slo_ms, calib_alone_ms=alone_ms, calib_burst_ms=burst_ms,
        alone_ms=[1e3 * h.ttft_s for h in run["alone"]],
        burst_ms=[1e3 * h.ttft_s for h in run["burst"]],
        flips=st["flips"], shed=len(shed), bulk_served=len(bulk) - len(shed),
        served_before_flip=len(served_first),
        attainment=st["last_attainment"], late_bulk=run["late"],
        fair_pending=pending, hog_rejected=hog_reason,
        rates=fair_stats["tenant_rates_tps"], launches=launches)


def p23_fleet(torch, model, main_path: dict) -> dict:
    """Phase 23 (e): 2 replicas of phase 4's server (host tier on) on the
    one card behind :class:`~tpudist_torch.serve.router.FleetRouter`, each
    warmed before the router's probes start.  4 two-turn sessions (turn 2
    must land on its home replica and resume), then phase 4's 16 requests
    twice: a wave without faults (fleet tokens/s) and a wave with
    ``replica_kill@nth:1`` armed once they are queued (mid-serve)."""
    import numpy as np

    from tpudist_torch.runtime import faults
    from tpudist_torch.serve import (FleetRouter, InferenceServer,
                                     RouterConfig)

    _, reqs, _, _ = phase4_traffic(7)
    rng = np.random.default_rng(2325)
    turn1 = [rng.integers(0, V, size=int(rng.integers(100, 201)))
             for _ in range(P23_FLEET_SESSIONS)]
    from tpudist_torch import ops

    before = ops.launch_counts()
    reps = [InferenceServer(model, p23_config(host_tier=True),
                            device="cuda", install_signal_handler=False)
            .start() for _ in range(2)]
    router = None
    try:
        for r in reps:
            warm = r.submit(rng.integers(0, V, size=70), max_new=9)
            if not warm.wait(600) or warm.finish_reason != "length":
                raise AssertionError("phase 23 (e): warm-up failed")
        torch.cuda.synchronize()
        router = FleetRouter(reps, RouterConfig()).start()
        h1 = [router.submit(p, max_new=16, session=f"f{i}")
              for i, p in enumerate(turn1)]
        for h in h1:
            if not h.wait(600) or h.finish_reason != "length":
                raise AssertionError(f"phase 23 (e): turn 1 "
                                     f"{h.finish_reason}")
        deadline = time.monotonic() + 60
        while router.stats()["stash_entries"] < P23_FLEET_SESSIONS \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        h2 = [router.submit(np.concatenate([p, np.asarray(h.tokens,
                                                          np.int32),
                                            rng.integers(0, V, size=24)]),
                            max_new=16, session=f"f{i}")
              for i, (p, h) in enumerate(zip(turn1, h1))]
        for h in h2:
            if not h.wait(600):
                raise AssertionError("phase 23 (e): turn 2 timed out")
        waves = {}
        for wave in ("plain", "kill"):
            t0 = time.perf_counter()
            hs = [router.submit(p, max_new=n) for p, n in reqs]
            if wave == "kill":
                faults.arm("replica_kill@nth:1")
            try:
                for h in hs:
                    if not h.wait(600):
                        raise AssertionError("phase 23 (e): timed out")
            finally:
                faults.disarm()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            waves[wave] = dict(handles=hs, wall_s=wall, tokens_per_s=sum(
                len(h.tokens) for h in hs) / wall)
        launches = launches_since(before)
        stats = router.stats()
    finally:
        if router is not None:
            router.close(60)
        else:
            for r in reps:
                r.close(60)
    p23_hold("(e)", all(b.replica == a.replica and b.resumed
                        for a, b in zip(h1, h2)),
             f"turn 2 replicas {[h.replica for h in h2]} (turn 1 "
             f"{[h.replica for h in h1]}), resumed "
             f"{[h.resumed for h in h2]}")
    out = {}
    for wave, w in waves.items():
        hs = w["handles"]
        p23_hold("(e)", all(h.finish_reason == "length"
                            and len(h.tokens) == n
                            for h, (_, n) in zip(hs, reqs)),
                 f"{wave} wave: {[(h.finish_reason, len(h.tokens)) for h in hs]}")
        equal, ties = hold_greedy_streams(
            torch, model, [p for p, _ in reqs], [h.tokens for h in hs],
            main_path["streams"], range(16))
        out[wave] = dict(tokens_per_s=w["tokens_per_s"], wall_s=w["wall_s"],
                         equal=equal, near_ties=ties,
                         rehomed=[i for i, h in enumerate(hs)
                                  if h.attempts > 1])
    p23_hold("(e)", stats["replica_deaths"] == 1 and stats["lost"] == 0
             and len(out["kill"]["rehomed"]) >= 1,
             f"router {stats}, re-homed {out['kill']['rehomed']}")
    return dict(out, router=stats, launches=launches,
                turn2_replicas=[h.replica for h in h2])


def p23_hold_lanes(torch, model, what: str, on: dict, off: dict,
                   lanes) -> list:
    """Gate of phase 23 (a) at the 64/32 budgets: each greedy lane of
    ``lanes`` is its preempt=False stream or parts where that run's top-2
    margin is within ``NEAR_TIE_GAP`` (:func:`p23_parting`).  Returns the
    partings ``(lane, token, margin)``."""
    _, reqs, _, _ = phase4_traffic(7)
    parted = []
    for i in lanes:
        if on["streams"][i] == off["streams"][i]:
            continue
        j, gap = p23_parting(torch, model, reqs[i][0], on["streams"][i],
                             off["streams"][i], off["logprobs"][i])
        parted.append((i, j, gap))
        p23_hold(what, gap <= NEAR_TIE_GAP,
                 f"lane {i} parts at token {j} where the top-2 margin "
                 f"{gap:.5f} is above {NEAR_TIE_GAP}")
    return parted


def phase23_serve(torch, model, main_path: dict, card: str) -> dict:
    """Phase 23 on phase 4's model (module doc): (a) preemption at the K-8
    budgets and at 64/32, (b) sessions, (c) overload, (d) a corrupt park,
    (e) the fleet.  Each sub-phase's serving runs report their launches
    as differences of the running counts (the checks' own prefills are
    left out); the phase's launches are their sum, and every sub-phase
    must have launched every serving kernel."""
    med = statistics.median
    walls, t0 = {}, time.perf_counter()

    def lap(sub: str) -> None:
        nonlocal t0
        t1 = time.perf_counter()
        walls[sub] = round(t1 - t0, 2)
        t0 = t1

    # (a)
    off = p23_preempt_run(torch, model, False, P23_LOW_NEW, P23_HIGH_NEW)
    on = p23_preempt_run(torch, model, True, P23_LOW_NEW, P23_HIGH_NEW)
    p23_hold("(a)", on["preemptions"] >= 1 and off["preemptions"] == 0
             and on["parked_after"] == 0,
             f"preemptions {on['preemptions']}/{off['preemptions']}")
    for i in on["preempted"]:
        p23_hold("(a)", on["streams"][i] == off["streams"][i],
                 f"preempted lane {i} (sampled: {i in SAMPLED_LANES}) "
                 f"differs from its preempt=False stream")
    p23_hold_launches("(a)", on["launches"])
    log(f"phase 23 (a) preemption, budgets {P23_LOW_NEW}/{P23_HIGH_NEW} "
        f"(every decode block K 8): {on['preemptions']} lanes preempted "
        f"({on['preempted']}) into the host tier by 4 priority-1 "
        f"requests and resumed, every stream equal to its preempt=False "
        f"run's bit for bit (greedy and sampled); export + serialize "
        f"{[round(x, 3) for x in on['export_serialize_ms']]} ms a lane, "
        f"deserialize + import "
        f"{[round(x, 3) for x in on['deserialize_import_ms']]} ms, package "
        f"bytes {on['package_bytes']}; priority-1 TTFT p50 "
        f"{med(on['high_ttft_ms']):.2f} ms with preemption, "
        f"{med(off['high_ttft_ms']):.2f} ms without; launches "
        f"{on['launches']} ({card})")
    off2 = p23_preempt_run(torch, model, False, P23_LOW_NEW - 1,
                           P23_HIGH_NEW - 1, logprobs=2)
    on2 = p23_preempt_run(torch, model, True, P23_LOW_NEW - 1,
                          P23_HIGH_NEW - 1, logprobs=2)
    p23_hold("(a) 64/32", on2["preemptions"] >= 1
             and off2["preemptions"] == 0 and on2["parked_after"] == 0,
             f"preemptions {on2['preemptions']}/{off2['preemptions']}")
    greedy = [i for i in range(8) if i not in SAMPLED_LANES]
    parted2 = p23_hold_lanes(torch, model, "(a) 64/32", on2, off2, greedy)
    sampled_parted = [i for i in range(8) if i in SAMPLED_LANES
                      and on2["streams"][i] != off2["streams"][i]]
    p23_hold_launches("(a) 64/32", on2["launches"])
    log(f"phase 23 (a) preemption, budgets {P23_LOW_NEW - 1}/"
        f"{P23_HIGH_NEW - 1} (short last blocks, K 1-8): "
        f"{on2['preemptions']} lanes preempted ({on2['preempted']}); "
        f"greedy lanes equal to the preempt=False run's "
        f"{len(greedy) - len(parted2)}/{len(greedy)}, partings (lane, "
        f"token, top-2 margin of the preempt=False run, bound "
        f"{NEAR_TIE_GAP}): {parted2}; sampled lanes parted (not gated at "
        f"these budgets): {sampled_parted}; priority-1 TTFT p50 "
        f"{med(on2['high_ttft_ms']):.2f} ms with preemption, "
        f"{med(off2['high_ttft_ms']):.2f} ms without ({card})")
    lap("a")
    # (b)
    s_off = p23_session_run(torch, model, tier=False)
    s_on = p23_session_run(torch, model, tier=True)
    p23_hold("(b)", s_on["resumes"] == P23_SESSIONS
             and all(s_on["resumed"]), f"resumes {s_on['resumes']}")
    want = LAYERS * sum(s_on["suffix_chunks"])
    p23_hold("(b)", s_on["prefill_launches"] == want
             and want < s_off["prefill_launches"],
             f"turn 2 paged prefill launches {s_on['prefill_launches']} "
             f"(the suffixes' chunks: {want}; tier off "
             f"{s_off['prefill_launches']})")
    p23_hold_launches("(b)", s_on["launches"])
    parted = []
    for i in range(P23_SESSIONS):
        if s_on["streams"][i] == s_off["streams"][i]:
            continue
        j, gap = p23_parting(torch, model, s_on["prompts"][i],
                             s_on["streams"][i], s_off["streams"][i],
                             s_off["logprobs"][i])
        parted.append((i, j, gap))
        p23_hold("(b)", gap <= NEAR_TIE_GAP,
                 f"session {i} parts at token {j} where the top-2 margin "
                 f"{gap:.5f} is above {NEAR_TIE_GAP}")
    log(f"phase 23 (b) sessions: {s_on['resumes']}/{P23_SESSIONS} turns "
        f"resumed from the host tier, turn-2 paged prefill launches "
        f"{s_on['prefill_launches']} (the suffixes' chunks "
        f"{s_on['suffix_chunks']} x {LAYERS} layers) against "
        f"{s_off['prefill_launches']} tier off; turn-2 TTFT p50 "
        f"{med(s_on['ttft_ms']):.2f} ms tier on, "
        f"{med(s_off['ttft_ms']):.2f} ms tier off; parted lanes (session, "
        f"token, top-2 margin of the tier-off run, bound {NEAR_TIE_GAP}): "
        f"{parted} ({card})")
    lap("b")
    # (c)
    over = p23_overload(torch, model)
    p23_hold_launches("(c)", over["launches"])
    log(f"phase 23 (c) overload: the gold tenant's TTFT alone "
        f"{over['calib_alone_ms']:.2f} ms and under the burst "
        f"{over['calib_burst_ms']:.2f} ms (calibration run) place the SLO "
        f"at {over['slo_ms']:.2f} ms; shed run: gold alone "
        f"{[round(x, 2) for x in over['alone_ms']]} ms, under the burst "
        f"{[round(x, 2) for x in over['burst_ms']]} ms, "
        f"{over['flips']} shed_state flip(s) (attainment "
        f"{over['attainment']}), {over['served_before_flip']} bulk "
        f"requests served before the flip, {over['bulk_served']} served "
        f"in all, {over['shed']} shed, every protected request length, a "
        f"bulk submit after the flip rejected '{over['late_bulk']}'; fair "
        f"share {P23_FAIR_SHARE}x rejected the hog at {over['fair_pending']}"
        f"/{P23_FAIR_QUEUE} queued: '{over['hog_rejected']}' ({card})")
    lap("c")
    # (d): held against (b)'s tier-off run, whose first 2 sessions are
    # these (decode and prefill are row-independent at the fixed 8-slot
    # shapes, and every block is K 8)
    c_on = p23_session_run(torch, model, tier=True, n=2, corrupt=True)
    bad = [i for i in range(2) if not c_on["resumed"][i]]
    p23_hold("(d)", c_on["corrupt"] == 1 and len(bad) == 1,
             f"tier_corrupt {c_on['corrupt']}, resumed {c_on['resumed']}")
    p23_hold_launches("(d)", c_on["launches"])
    i = bad[0]
    if c_on["streams"][i] != s_off["streams"][i]:
        raise AssertionError(
            f"phase 23 (d): the re-prefilled turn of session {i} parts "
            f"from (b)'s tier-off run's at "
            f"{p23_parting(torch, model, s_off['prompts'][i], c_on['streams'][i], s_off['streams'][i], s_off['logprobs'][i])}")
    log(f"phase 23 (d) host_tier_corrupt@nth:1: tier_corrupt "
        f"{c_on['corrupt']}, session {i}'s turn 2 re-prefilled to (b)'s "
        f"tier-off stream bit for bit, session {1 - i} resumed")
    lap("d")
    # (e)
    fleet = p23_fleet(torch, model, main_path)
    p23_hold_launches("(e)", fleet["launches"])
    log(f"phase 23 (e) fleet: 2 replicas on one card behind the router, "
        f"4 sessions' turn 2 on their home replicas "
        f"{fleet['turn2_replicas']}, all resumed; phase 4's 16 requests "
        f"at {fleet['plain']['tokens_per_s']:.1f} tokens/s through the "
        f"fleet beside {main_path['tokens_per_s']:.1f} on one server "
        f"(phase 4; both engine threads share one host and card); "
        f"replica_kill@nth:1 mid-serve: {fleet['router']['replica_deaths']} "
        f"death, re-homed {fleet['kill']['rehomed']}, 0 replica_lost, "
        f"{fleet['kill']['tokens_per_s']:.1f} tokens/s; greedy lanes equal "
        f"the single server's {fleet['plain']['equal']}/16 and "
        f"{fleet['kill']['equal']}/16 (near ties "
        f"{fleet['plain']['near_ties']} {fleet['kill']['near_ties']}) "
        f"({card})")
    lap("e")
    runs = {"a": [off, on, off2, on2], "b": [s_off, s_on],
            "c": [over], "d": [c_on], "e": [fleet]}
    by_sub = {sub: {k: sum(r["launches"].get(k, 0) for r in rs)
                    for k in SERVE_KERNELS} for sub, rs in runs.items()}
    launches = {k: sum(b[k] for b in by_sub.values()) for k in SERVE_KERNELS}
    log(f"phase 23 launches of the serving runs by sub-phase {by_sub}, in "
        f"all {launches}; seconds by sub-phase {walls}")
    return dict(
        launches=launches, launches_by_subphase=by_sub, walls_s=walls,
        preempt=dict(on={k: v for k, v in on.items()
                         if k not in ("streams", "logprobs")},
                     off=dict(high_ttft_ms=off["high_ttft_ms"]),
                     budgets_64_32=dict(
                         preempted=on2["preempted"], parted=parted2,
                         sampled_parted=sampled_parted,
                         high_ttft_ms=dict(on=on2["high_ttft_ms"],
                                           off=off2["high_ttft_ms"]))),
        sessions=dict(
            on={k: v for k, v in s_on.items()
                if k not in ("prompts", "streams", "logprobs")},
            off=dict(ttft_ms=s_off["ttft_ms"],
                     prefill_launches=s_off["prefill_launches"]),
            parted=parted),
        overload=over, corrupt=dict(session=i),
        fleet=fleet)


# ---------------------------------------------------------------------------
# phase 24: prefill/decode disaggregation


def p24_hold(what: str, ok: bool, detail) -> None:
    if not ok:
        raise AssertionError(f"phase 24 {what}: {detail}")


class PoolLaunches:
    """Each pool's kernel launches: the differences of the global counts
    around its engines' calls (the prefill pool's ``start_batch`` and
    ``advance_prefill``, the decode pool's ``decode_auto``; the lane
    transfer itself launches nothing).  ``undo()`` restores the engines."""

    def __init__(self, server):
        from tpudist_torch import ops

        self.by_pool = {"prefill": {}, "decode": {}}
        self.wrapped = []
        for pool, engines, names in (
                ("prefill", server.prefill_pool,
                 ("start_batch", "advance_prefill")),
                ("decode", server.decode_pool, ("decode_auto",))):
            tally = self.by_pool[pool]
            for eng in engines:
                for name in names:
                    orig = getattr(eng, name)

                    def wrapped(*a, _orig=orig, _tally=tally, **kw):
                        before = ops.launch_counts()
                        try:
                            return _orig(*a, **kw)
                        finally:
                            for k, n in ops.launch_counts().items():
                                _tally[k] = (_tally.get(k, 0) + n
                                             - before.get(k, 0))

                    setattr(eng, name, wrapped)
                    self.wrapped.append((eng, name))

    def undo(self) -> None:
        for eng, name in self.wrapped:
            delattr(eng, name)


def p24_run(torch, model, knobs: dict, reqs, temps, fault=None,
            timed=False, after=False) -> dict:
    """One phase 24 run: ``serve_forever`` with ``P24_CONFIG`` and
    ``knobs``, warmed up, then ``reqs`` with ``temps`` (seed = the lane)
    with the counts read just before; ``fault`` is armed once the warm-up
    is done.  ``timed`` times each lane's export (+ serialize) and
    (deserialize +) import, synchronized on both sides; ``after`` serves
    one more request once the burst is done."""
    from tpudist_torch import ops
    from tpudist_torch.runtime import faults
    from tpudist_torch.serve import ServeConfig, disagg, serve_forever

    warm_prompt, _, _, _ = phase4_traffic(7)
    server = serve_forever(model, ServeConfig(**{**P24_CONFIG, **knobs}),
                           device="cuda")
    sinks = {k: [] for k in ("export", "serialize", "deserialize",
                             "import")}
    seams, pools = [], None
    try:
        warm = server.submit(warm_prompt, max_new=9)
        if not warm.wait(600) or warm.finish_reason != "length":
            raise AssertionError("phase 24: warm-up request did not finish")
        torch.cuda.synchronize()
        if timed:
            seams = [Timed(torch, server.prefill_pool[0], "export_slot",
                           sinks["export"])]
            seams += [Timed(torch, eng, "import_slot", sinks["import"])
                      for eng in server.decode_pool]
            if server.handoff_mode == "serial":
                seams += [Timed(torch, disagg, "serialize_package",
                                sinks["serialize"]),
                          Timed(torch, disagg, "deserialize_package",
                                sinks["deserialize"])]
        pools = PoolLaunches(server)
        before, st0 = ops.launch_counts(), server.stats()
        if fault:
            faults.arm(fault)
        t0 = time.perf_counter()
        handles = [server.submit(p, max_new=n, temperature=t, seed=i)
                   for i, ((p, n), t) in enumerate(zip(reqs, temps))]
        for h in handles:
            if not h.wait(900):
                raise AssertionError("phase 24: a request timed out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_since(before)
        stats = server.stats()
        if after:
            late = server.submit(warm_prompt, max_new=9)
            if not late.wait(600) or late.finish_reason != "length":
                raise AssertionError(f"phase 24: the request after the "
                                     f"burst {late.finish_reason}")
    finally:
        faults.disarm()
        for seam in seams:
            seam.undo()
        if pools is not None:
            pools.undo()
        server.close(60)
    ms = {k: [1e3 * t for t, _ in v] for k, v in sinks.items()}
    lane_bytes = [ser["bytes"] for _, ser in sinks["serialize"]]
    tokens = sum(len(h.tokens) for h in handles)
    ttft = sorted(1e3 * h.ttft_s for h in handles)
    return dict(
        handles=handles, streams=[h.tokens for h in handles], wall_s=wall,
        tokens=tokens, tokens_per_s=tokens / wall,
        ttft_p50_ms=statistics.median(ttft),
        ttft_p95_ms=nearest_rank(ttft, 95),
        tpot_p50_ms=1e3 * statistics.median(
            h.tpot_s for h in handles if h.tpot_s is not None),
        handoff_wait_p50_ms=1e3 * statistics.median(
            h.handoff_wait_s for h in handles
            if h.handoff_wait_s is not None),
        handoffs=stats["handoffs"] - st0["handoffs"],
        workers_lost=stats["workers_lost"],
        lanes_recovered=stats["lanes_recovered"],
        recovered=[i for i, h in enumerate(handles)
                   if len(h.decode_segments) > 1],
        reasons=[h.finish_reason for h in handles],
        launches=launches, pool_launches=pools.by_pool,
        export_ms=[a + b for a, b in zip(ms["export"], ms["serialize"])]
        if ms["serialize"] else ms["export"],
        import_ms=[a + b for a, b in zip(ms["deserialize"], ms["import"])]
        if ms["deserialize"] else ms["import"],
        package_bytes=lane_bytes)


def nonzero(counts: dict) -> dict:
    """The kernels a run launched, with their counts."""
    return {k: n for k, n in counts.items() if n}


def p24_hold_launches(what: str, launches: dict) -> None:
    """Gate: every serving kernel launched in ``what``'s run."""
    p24_hold(what, all(launches.get(k, 0) > 0 for k in SERVE_KERNELS),
             f"a serving kernel never launched: {launches}")


def phase24_serve(torch, model, main_path: dict, card: str) -> dict:
    """Phase 24 on phase 4's model (module doc): (a) the oracle in both
    handoff modes, (a') bit for bit at decode block 1, (b) a decode worker
    killed inside the burst, (c) a corrupt package."""
    _, reqs, temps, _ = phase4_traffic(7)
    prompts = [p for p, _ in reqs]
    greedy = [i for i in range(16) if i not in SAMPLED_LANES]
    walls, t0 = {}, time.perf_counter()

    def lap(sub: str) -> None:
        nonlocal t0
        t1 = time.perf_counter()
        walls[sub] = round(t1 - t0, 2)
        t0 = t1

    def hold_length(what: str, r: dict, skip=()) -> None:
        bad = [(i, h.finish_reason, len(h.tokens))
               for i, (h, (_, n)) in enumerate(zip(r["handles"], reqs))
               if i not in skip and (h.finish_reason != "length"
                                     or len(h.tokens) != n)]
        p24_hold(what, not bad, f"requests not length: {bad}")

    # (a): phase 4's server on the same traffic, its sampled lanes drawn
    sampled_ref = serve_arm(torch, model, {}, 7)
    runs = {}
    for mode in ("serial", "device"):
        r = p24_run(torch, model, dict(handoff=mode), reqs, temps,
                    timed=True)
        what = f"(a) {mode}"
        hold_length(what, r)
        p24_hold(what, r["handoffs"] == 16, f"handoffs {r['handoffs']}")
        p24_hold_launches(what, r["launches"])
        r["equal"], r["near_ties"] = hold_greedy_streams(
            torch, model, prompts, r["streams"], main_path["streams"],
            greedy)
        r["sampled_equal"] = sum(r["streams"][i] == sampled_ref["streams"][i]
                                 for i in SAMPLED_LANES)
        runs[mode] = r
        med = statistics.median
        log(f"phase 24 (a) handoff={mode}: 16 requests, {r['tokens']} "
            f"tokens in {r['wall_s']:.3f} s = {r['tokens_per_s']:.1f} "
            f"tokens/s beside phase 4's {main_path['tokens_per_s']:.1f}; "
            f"TTFT p50 {r['ttft_p50_ms']:.2f} ms, p95 "
            f"{r['ttft_p95_ms']:.2f} ms (phase 4 p50 "
            f"{main_path['ttft_p50_ms']:.2f}), TPOT p50 "
            f"{r['tpot_p50_ms']:.3f} ms (phase 4 "
            f"{main_path['tpot_p50_ms']:.3f}), handoff wait p50 "
            f"{r['handoff_wait_p50_ms']:.3f} ms; "
            + (f"package bytes {min(r['package_bytes'])}-"
               f"{max(r['package_bytes'])} (sum "
               f"{sum(r['package_bytes'])}), export + serialize p50 "
               f"{med(r['export_ms']):.3f} ms (max "
               f"{max(r['export_ms']):.3f}), deserialize + import p50 "
               if mode == "serial" else
               f"export p50 {med(r['export_ms']):.3f} ms (max "
               f"{max(r['export_ms']):.3f}), import p50 ")
            + f"{med(r['import_ms']):.3f} ms (max {max(r['import_ms']):.3f})"
            f" a lane (each synchronized on both sides); greedy lanes equal "
            f"to phase 4's {r['equal']}/{len(greedy)}, near ties (lane, "
            f"token, top-2 gap) {r['near_ties']}; sampled lanes equal to "
            f"phase 4's server at the same seeds {r['sampled_equal']}/"
            f"{len(SAMPLED_LANES)}; launches {nonzero(r['launches'])}, by "
            f"pool { {k: nonzero(v) for k, v in r['pool_launches'].items()} }"
            f" ({card})")
    lap("a")
    # (a')
    lanes = list(P24_EXACT_LANES)
    sub = [reqs[i] for i in lanes]
    sub_t = [temps[i] for i in lanes]
    exact = p24_run(torch, model, dict(decode_block=1, prefill_slots=SLOTS,
                                       handoff="serial"), sub, sub_t)
    single = phase4_server_run(torch, model, dict(decode_block=1), sub,
                               sub_t)
    differ = [lane for lane, a, b in zip(lanes, exact["streams"],
                                         single["streams"]) if a != b]
    p24_hold("(a')", not differ, f"streams differ on lanes {differ}")
    p24_hold("(a')", all(h.finish_reason == "length" and len(h.tokens) == n
                         for h, (_, n) in zip(exact["handles"], sub)),
             exact["reasons"])
    p24_hold_launches("(a')", exact["launches"])
    log(f"phase 24 (a') lanes {lanes} (sampled {list(SAMPLED_LANES)}) at "
        f"decode block 1: the disaggregated streams equal the single "
        f"server's bit for bit; launches {nonzero(exact['launches'])} "
        f"({card})")
    lap("a'")
    # (b)
    kill = p24_run(torch, model, dict(handoff="serial"), reqs, temps,
                   fault=P24_KILL)
    hold_length("(b)", kill)
    p24_hold("(b)", kill["workers_lost"] == 1
             and kill["lanes_recovered"] >= 1 and kill["recovered"],
             f"workers lost {kill['workers_lost']}, lanes recovered "
             f"{kill['lanes_recovered']} ({kill['recovered']})")
    p24_hold_launches("(b)", kill["launches"])
    kill["equal"], kill["near_ties"] = hold_greedy_streams(
        torch, model, prompts, kill["streams"], runs["serial"]["streams"],
        greedy)
    kill["sampled_recovered_equal"] = {
        i: kill["streams"][i] == runs["serial"]["streams"][i]
        for i in kill["recovered"] if i in SAMPLED_LANES}
    log(f"phase 24 (b) {P24_KILL}: {kill['workers_lost']} worker lost, "
        f"{kill['lanes_recovered']} lanes recovered (lanes "
        f"{kill['recovered']} decoded on two workers), every request "
        f"length; greedy lanes equal to (a)'s serial run "
        f"{kill['equal']}/{len(greedy)}, near ties {kill['near_ties']}; "
        f"recovered sampled lanes equal to (a)'s "
        f"{kill['sampled_recovered_equal']}; {kill['tokens_per_s']:.1f} "
        f"tokens/s; launches {nonzero(kill['launches'])} ({card})")
    lap("b")
    # (c)
    bad = p24_run(torch, model, dict(handoff="serial"), reqs, temps,
                  fault=P24_CORRUPT, after=True)
    corrupt = [i for i, why in enumerate(bad["reasons"])
               if why == "handoff_corrupt"]
    p24_hold("(c)", len(corrupt) == 1, f"finish reasons {bad['reasons']}")
    hold_length("(c)", bad, skip=corrupt)
    p24_hold_launches("(c)", bad["launches"])
    log(f"phase 24 (c) {P24_CORRUPT}: lane {corrupt[0]} finished "
        f"handoff_corrupt, the other 15 length, a request after the burst "
        f"served length; launches {nonzero(bad['launches'])} ({card})")
    lap("c")
    by_sub = {"a serial": runs["serial"]["launches"],
              "a device": runs["device"]["launches"], "a'": exact["launches"],
              "b": kill["launches"], "c": bad["launches"]}
    by_sub = {k: {n: v.get(n, 0) for n in SERVE_KERNELS}
              for k, v in by_sub.items()}
    launches = {n: sum(b[n] for b in by_sub.values()) for n in SERVE_KERNELS}
    log(f"phase 24 launches by sub-phase {by_sub}, in all {launches}; "
        f"seconds by sub-phase {walls}")
    keep = ("tokens", "wall_s", "tokens_per_s", "ttft_p50_ms", "ttft_p95_ms",
            "tpot_p50_ms", "handoff_wait_p50_ms", "handoffs", "export_ms",
            "import_ms", "package_bytes", "equal", "near_ties",
            "sampled_equal", "launches", "pool_launches", "workers_lost",
            "lanes_recovered", "recovered", "sampled_recovered_equal",
            "reasons")
    brief = lambda r: {k: r[k] for k in keep if k in r}  # noqa: E731
    return dict(launches=launches, launches_by_subphase=by_sub,
                walls_s=walls, serial=brief(runs["serial"]),
                device=brief(runs["device"]), exact=brief(exact),
                kill=brief(kill), corrupt=dict(brief(bad), lane=corrupt[0]))


# ---------------------------------------------------------------------------
# phase 25: MoE serving and the draft-distillation flywheel


def p25_hold(what: str, ok: bool, detail) -> None:
    if not ok:
        raise AssertionError(f"phase 25 {what}: {detail}")


def state_copy(torch, model) -> dict:
    """A copy of ``model``'s state dict on its device (the bit-equality
    yardstick of the swaps)."""
    return {k: t.detach().clone() for k, t in model.state_dict().items()}


def weights_equal(torch, model, saved: dict) -> bool:
    sd = model.state_dict()
    return set(sd) == set(saved) and all(torch.equal(sd[k], saved[k])
                                         for k in saved)


def checksum(torch, sd: dict) -> float:
    """The sum of every weight in f64: a short print of a state dict."""
    return float(sum(t.double().sum() for t in sd.values()))


def noised(torch, sd: dict, seed: int) -> dict:
    """A same-geometry candidate: each float tensor times ``1 +
    P25_NOISE * N(0, 1)`` from a seeded generator, in its own dtype."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for k, t in sd.items():
        n = torch.randn(t.shape, generator=gen, device=t.device,
                        dtype=torch.float32)
        out[k] = (t.float() * (1 + P25_NOISE * n)).to(t.dtype)
    return out


class EventTap:
    """Every telemetry event named in ``names`` recorded (``.got``) on its
    way to the session (``telemetry.event`` wrapped; ``undo()``
    restores it)."""

    def __init__(self, names):
        from tpudist_torch import telemetry

        self.mod, self.orig, self.got = telemetry, telemetry.event, []

        def event(name, **fields):
            if name in names:
                self.got.append(dict(fields, name=name))
            return self.orig(name, **fields)

        telemetry.event = event

    def undo(self) -> None:
        self.mod.event = self.orig


def p25_burst(torch, server, reqs, temps=None, spec_on=None, swaps=()):
    """``reqs`` submitted at once (seed = the lane); each candidate of
    ``swaps`` handed to ``server.swap_draft`` once the burst has emitted
    ``P25_SWAP_AT * (i + 1)`` tokens — with requests in flight — and
    landed by the engine loop between decode blocks.  Returns the
    handles, the wall, the swaps' records and the launches."""
    from tpudist_torch import ops

    temps = temps or [0.0] * len(reqs)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    handles = [server.submit(p, max_new=n, temperature=t, seed=i,
                             spec=None if spec_on is None else spec_on[i])
               for i, ((p, n), t) in enumerate(zip(reqs, temps))]
    infos = []
    for i, cand in enumerate(swaps):
        deadline = time.monotonic() + 600
        while (sum(len(h.tokens) for h in handles) < P25_SWAP_AT * (i + 1)
               and not all(h.done for h in handles)):
            if time.monotonic() > deadline:
                raise AssertionError("phase 25: the burst stalled")
            time.sleep(0.001)
        infos.append(dict(server.swap_draft(cand), at_tokens=sum(
            len(h.tokens) for h in handles)))
    for h in handles:
        if not h.wait(900):
            raise AssertionError("phase 25: a request timed out")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [(i, h.finish_reason, len(h.tokens))
           for i, (h, (_, n)) in enumerate(zip(handles, reqs))
           if h.finish_reason != "length" or len(h.tokens) != n]
    p25_hold("burst", not bad, f"requests not length: {bad}")
    tokens = sum(len(h.tokens) for h in handles)
    return dict(handles=handles, streams=[h.tokens for h in handles],
                wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
                ttft_p50_ms=1e3 * statistics.median(h.ttft_s
                                                    for h in handles),
                tpot_p50_ms=1e3 * statistics.median(
                    h.tpot_s for h in handles if h.tpot_s is not None),
                swaps=infos, launches=launches_since(before))


def p25_server(torch, model, knobs: dict, disagg: bool = False):
    """A started server of phase 4's geometry (``P24_CONFIG``'s pools
    with ``disagg``) with ``knobs``, warmed up with phase 4's warm-up
    request."""
    from tpudist_torch.serve import InferenceServer, ServeConfig, \
        serve_forever

    warm_prompt, _, _, _ = phase4_traffic(7)
    if disagg:
        server = serve_forever(model, ServeConfig(**{**P24_CONFIG,
                                                     **knobs}),
                               device="cuda")
    else:
        server = InferenceServer(model, p23_config(**knobs), device="cuda",
                                 install_signal_handler=False).start()
    warm = server.submit(warm_prompt, max_new=9)
    if not warm.wait(600) or warm.finish_reason != "length":
        server.close(60)
        raise AssertionError("phase 25: warm-up request did not finish")
    return server


def spec_delta(after: dict, before: dict) -> dict:
    """A burst's speculative counters and acceptance from two
    ``spec_stats()`` readings."""
    acc = after["accepted"] - before["accepted"]
    dr = after["drafted"] - before["drafted"]
    return dict(accepted=acc, drafted=dr,
                acceptance_rate=acc / dr if dr else None,
                blocks=after["blocks"] - before["blocks"])


def moe_model_of(torch):
    """Phase 4's widths with ``P25_EXPERTS`` experts a block, random bf16
    weights drawn on the card from seed 25: lecun-normal as
    ``create_transformer`` draws them (truncated at 2 sigma, the expert
    axis in the fan-in), LayerNorm scales 1."""
    from tpudist_torch.models import TransformerLM

    with torch.device("cuda"):
        model = TransformerLM(dtype=torch.bfloat16, n_experts=P25_EXPERTS,
                              **MODEL)
    gen = torch.Generator(device="cuda").manual_seed(25)
    d, f, e = MODEL["d_model"], MODEL["d_ff"], P25_EXPERTS
    fan_in = {"moe.w": d * e, "moe.wo": f * e, "proj": d}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("ln"):
                p.fill_(1.0)
                continue
            key = ".".join(name.split(".")[-2:])
            fan = fan_in.get(key, fan_in.get(name.rsplit(".", 1)[-1], d))
            std = math.sqrt(1.0 / fan) / 0.87962566103423978
            t = torch.empty(p.shape, device="cuda")
            torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                        generator=gen)
            p.copy_(t)
    return model.requires_grad_(False)


def moe_ffn_ms(torch, moe) -> dict:
    """One block's MoE FFN (the dense top-1 reference's einsums) at the
    decode step's 8 tokens and at a 64-token prefill chunk of 8 lanes,
    timed with CUDA events (L2 flushed), beside its bound: every expert's
    ``w`` and ``wo`` read once."""
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    blk = moe.blocks[0]
    gen = torch.Generator(device=dev).manual_seed(25)
    out = {}
    for label, tokens in (("decode 8", SLOTS), ("prefill 8x64", SLOTS * P)):
        h = torch.randn((tokens, 1, MODEL["d_model"]), generator=gen,
                        device=dev).to(torch.bfloat16)
        ms = time_ms(torch, lambda: blk.moe(h, dense=True), flush)
        e, d, f = P25_EXPERTS, MODEL["d_model"], MODEL["d_ff"]
        nbytes = 2 * e * d * f * 2 + d * e * 2 + 2 * tokens * d * 2
        flops = 2 * 2 * tokens * e * d * f
        out[label] = dict(ms=ms, bound=bound(nbytes, flops,
                                             H100_BF16_FLOPS))
    return out


def phase25_moe(torch, main_path: dict, card: str) -> dict:
    """Phase 25 (a)-(c): an MoE model of phase 4's widths served."""
    walls, t0 = {}, time.perf_counter()

    def lap(sub: str) -> None:
        nonlocal t0
        t1 = time.perf_counter()
        walls[sub] = round(t1 - t0, 2)
        t0 = t1

    moe = moe_model_of(torch)
    lap("model")
    out = {"walls_s": walls}
    # (a) the kernel arms, and 4g (a)'s JAX-default arms as the yardstick
    a = serve_main_path(torch, moe, 7)
    dense = serve_arm(torch, moe, DEFAULT_ARMS["a"], 7)
    p25_hold("(a) dense arms", not any(dense["launches"].values()),
             f"kernels launched on the dense arms: {dense['launches']}")
    greedy = [i for i in range(16) if dense["temps"][i] == 0.0]
    a["equal"], a["near_ties"] = hold_greedy_streams(
        torch, moe, dense["prompts"], a["streams"], dense["streams"],
        greedy)
    def predicted(r: dict) -> dict:
        """The paged kernels' launches the engine's counters predict for
        the burst (the warm-up's taken off): one a layer of each decode
        step, one a layer of each prefill forward."""
        tf = r["decode"]["forwards"] - r["decode_warm"]["forwards"]
        td = r["decode"]["steps"] - r["decode_warm"]["steps"]
        return {"paged_attention": LAYERS * td,
                "paged_prefill": LAYERS * (tf - td)}

    want = predicted(a)
    got = {k: a["launches"][k] for k in want}
    p25_hold("(a) launches", got == want, f"{got}, want {want}")
    p4_want = predicted(main_path)
    p25_hold("(a) phase 4's counts", all(
        main_path["launches"][k] == n for k, n in p4_want.items()),
        f"phase 4 launched {main_path['launches']}, its formula {p4_want}")
    steps = a["decode"]["steps"] - a["decode_warm"]["steps"]
    p25_hold("(a) sampling", a["launches"]["fused_sample"] >= steps,
             f"fused_sample {a['launches']['fused_sample']} in {steps} "
             "decode steps")
    prof = profile_engine(torch, moe)
    ffn = moe_ffn_ms(torch, moe)
    block_ms = prof["decode_block"]["device_busy_ms"]
    # a K = 8 decode block runs every layer's FFN 8 times
    share = (8 * LAYERS * ffn["decode 8"]["ms"] / block_ms
             if block_ms else None)
    log(f"phase 25 (a) MoE ({P25_EXPERTS} experts a block, "
        f"{sum(p.numel() for p in moe.parameters()) / 1e6:.1f} M "
        f"parameters bf16) on phase 4's traffic: {a['tokens']} tokens in "
        f"{a['wall_s']:.3f} s = {a['tokens_per_s']:.1f} tokens/s (phase 4 "
        f"dense {main_path['tokens_per_s']:.1f}), TTFT p50 "
        f"{a['ttft_p50_ms']:.2f} ms ({main_path['ttft_p50_ms']:.2f}), TPOT "
        f"p50 {a['tpot_p50_ms']:.3f} ms ({main_path['tpot_p50_ms']:.3f}), "
        f"peak memory {a['peak_mem_gb']:.2f} GB, {a['peak_above_held_gb']:.2f}"
        f" above what was held ({main_path['peak_mem_gb']:.2f} / "
        f"{main_path['peak_above_held_gb']:.2f}); greedy lanes equal to the "
        f"JAX-default arms {a['equal']}/{len(greedy)}, near ties "
        f"{a['near_ties']}; launches {nonzero(a['launches'])} (held: "
        f"{want}; phase 4 {nonzero(main_path['launches'])}); the dense arms "
        f"at {dense['tokens_per_s']:.1f} tokens/s ({card})")
    log(f"phase 25 (a) one MoE FFN (dense top-1 reference) "
        + ", ".join(f"{k}: {v['ms']:.4f} ms (bound {v['bound'][0]:.4f} ms, "
                    f"{v['bound'][1]})" for k, v in ffn.items())
        + f"; a K 8 decode block's device time {block_ms} ms, of it the "
        f"MoE FFNs ~{share if share is None else round(share, 3)}")
    log_profile({"phase 25 MoE decode_block": prof["decode_block"],
                 "phase 25 MoE prefill": prof["prefill"]})
    out["a"] = dict({k: v for k, v in a.items() if k != "streams"},
                    dense_arms={k: dense[k] for k in (
                        "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms")},
                    ffn=ffn, ffn_share_of_decode_block=share,
                    profile=prof)
    lap("a")
    # (b) spec decoding on the MoE model, held against (a)'s streams
    b = serve_spec_path(torch, moe, 7, a)
    log_spec("phase 25 (b) MoE spec path (tied 4-layer draft, K 4)", b,
             "phase 25 (a)", card)
    out["b"] = b
    lap("b")
    # (c) the serving mesh 1x2, held against (a)'s streams
    c = mesh_serve_run(torch, moe, "plain", "1x2")
    c["equal"], c["near_ties"] = hold_greedy_streams(
        torch, moe, c["prompts"], c["streams"], a["streams"],
        list(range(16)))
    want = mesh_launches_want(c)
    got = {k: c["launches"][k] for k in want}
    p25_hold("(c) launches", got == want, f"{got}, want {want}")
    sp = c["spmd"]
    p25_hold("(c) spmd", sp["tp_overlap"] == "off"
             and "moe" in sp["replicated"], sp)
    log(f"phase 25 (c) MoE over 1x2 places folded onto the card: "
        f"{c['tokens']} tokens in {c['wall_s']:.3f} s = "
        f"{c['tokens_per_s']:.1f} tokens/s, TTFT p50 {c['ttft_p50_ms']:.2f} "
        f"ms, TPOT p50 {c['tpot_p50_ms']:.3f} ms; greedy lanes equal to "
        f"(a)'s {c['equal']}/16, near ties {c['near_ties']}; launches "
        f"{want}; spmd {sp} ({card})")
    out["c"] = {k: v for k, v in c.items()
                if k not in ("streams", "prompts", "names", "temps")}
    lap("c")
    log(f"phase 25 (a)-(c) seconds by sub-phase {walls}")
    launches = {}
    for r in (a, b, c):
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    del moe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase25_flywheel(torch, model, main_path: dict, default_runs: dict,
                     card: str) -> dict:
    """Phase 25 (d)-(e) on phase 4's model: the capture, a round, swaps
    under traffic, the corrupt round, the background loop, the
    disaggregated broadcast."""
    from tpudist_torch import ops
    from tpudist_torch.distill import DistillLoop
    from tpudist_torch.runtime import faults

    _, reqs, temps, spec_on = phase4_traffic(7)
    prompts = [p for p, _ in reqs]
    target = state_copy(torch, model)
    target_sum = checksum(torch, target)
    tap = EventTap(("distill_round", "draft_swap"))
    launches = {}

    def add(counts: dict) -> None:
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    walls, t0 = {}, time.perf_counter()

    def lap(sub: str) -> None:
        nonlocal t0
        t1 = time.perf_counter()
        walls[sub] = round(t1 - t0, 2)
        t0 = t1

    out = {"flywheel_walls_s": walls}
    try:
        # (d) setup: phase 4c's spec server, the tap armed from the env
        with env_set(TPUDIST_DISTILL_CAPTURE="1"):
            server = p25_server(torch, model, dict(spec=True,
                                                   spec_k=SPEC_K))
        try:
            eng = server.engine
            p25_hold("(d) capture", server.capture is not None,
                     "TPUDIST_DISTILL_CAPTURE=1 armed no capture")
            fns = eng.fns
            st0 = eng.spec_stats()
            d1 = p25_burst(torch, server, reqs, temps, spec_on)
            add(d1["launches"])
            no_swap_streams = d1["streams"]
            before = spec_delta(eng.spec_stats(), st0)
            greedy = [i for i in range(16) if temps[i] == 0.0]
            d1["equal"], d1["near_ties"] = hold_greedy_streams(
                torch, model, prompts, d1["streams"], main_path["streams"],
                greedy)
            loop = DistillLoop(server, server.capture, steps=P25_STEPS,
                               interval_s=P25_INTERVAL_S)
            dl = eng.draft_model.n_layers
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            rnd = loop.run_once()
            torch.cuda.synchronize()
            got = ops.launch_counts()
            add(got)
            p25_hold("(d) round", rnd["reason"] not in ("min_tokens",
                                                        "no_draft"), rnd)
            want = {"flash_forward": dl * (P25_STEPS + 2),
                    "flash_backward_dq": dl * P25_STEPS,
                    "flash_backward_dkv": dl * P25_STEPS}
            p25_hold("(d) round launches", all(
                got[k] == n for k, n in want.items()) and not any(
                got[k] for k in SERVE_KERNELS),
                f"{nonzero(got)}, want {want} ({dl} draft layers x "
                f"{P25_STEPS} steps, 2 holdout forwards)")
            p25_hold("(d) target", weights_equal(torch, model, target),
                     "the target's weights moved in the round")
            log(f"phase 25 (d) flywheel: phase 4c's traffic on the spec "
                f"server (capture from TPUDIST_DISTILL_CAPTURE=1: "
                f"{server.capture.stats()['streams']} streams, "
                f"{server.capture.stats()['tokens']} tokens), greedy lanes "
                f"equal phase 4's {d1['equal']}/{len(greedy)}, near ties "
                f"{d1['near_ties']}; one round ({P25_STEPS} Trainer steps "
                f"on {rnd.get('train_streams')} streams): {rnd}; launches "
                f"{nonzero(got)} = held {want}; target checksum "
                f"{target_sum!r} before and after, bit-equal ({card})")
            # the corrupt round: rejected, the serving draft untouched
            draft_before = state_copy(torch, eng.draft_model)
            faults.arm(P25_CORRUPT)
            try:
                bad = loop.run_once()
            finally:
                faults.disarm()
            p25_hold("(d) corrupt", bad.get("fault") == "draft_swap_corrupt"
                     and not bad["swapped"], bad)
            p25_hold("(d) corrupt draft", weights_equal(
                torch, eng.draft_model, draft_before),
                "the serving draft moved under a rejected round")
            log(f"phase 25 (d) {P25_CORRUPT}: rejected ({bad['reason']}, "
                f"candidate acceptance {bad['candidate_acceptance']} vs "
                f"baseline {bad['baseline']}); serving draft checksum "
                f"{checksum(torch, draft_before)!r} unchanged, bit-equal")
            # the thread: a round beside a burst
            st0 = eng.spec_stats()
            rounds0 = loop.rounds
            loop.start()
            try:
                d4 = p25_burst(torch, server, reqs, temps, spec_on)
                deadline = time.monotonic() + 300
                while loop.rounds == rounds0 or loop.last_round is None \
                        or loop.last_round.get("round") == rounds0:
                    p25_hold("(d) thread", time.monotonic() < deadline,
                             "no round completed in 300 s")
                    time.sleep(0.01)
            finally:
                p25_hold("(d) thread stop", loop.stop(120), "the loop "
                         "thread did not stop")
            add(d4["launches"])
            after = spec_delta(eng.spec_stats(), st0)
            thread_round = loop.last_round
            p25_hold("(d) fns", eng.fns is fns, "a swap rebuilt the slot "
                     "programs")
            p25_hold("(d) thread target", weights_equal(torch, model,
                                                        target),
                     "the target's weights moved")
            d4["equal"], d4["near_ties"] = hold_greedy_streams(
                torch, model, prompts, d4["streams"], main_path["streams"],
                greedy)
            log(f"phase 25 (d) DistillLoop.start() during phase 4c's burst: "
                f"{loop.rounds - rounds0} round(s) in the thread, the last "
                f"{thread_round}; burst TPOT p50 {d4['tpot_p50_ms']:.3f} ms "
                f"beside {d1['tpot_p50_ms']:.3f} ms without the thread, "
                f"{d4['tokens_per_s']:.1f} / {d1['tokens_per_s']:.1f} "
                f"tokens/s; acceptance {before['acceptance_rate']} before the "
                f"rounds, {after['acceptance_rate']} in this burst; greedy "
                f"lanes equal phase 4's {d4['equal']}/{len(greedy)}, near "
                f"ties {d4['near_ties']}; loop {loop.stats()} ({card})")
            out["d"] = dict(
                capture=server.capture.stats(), round=rnd,
                round_launches=got, corrupt=bad, thread_round=thread_round,
                loop=loop.stats(), acceptance_before=before,
                acceptance_after=after,
                serve={k: d1[k] for k in ("tokens_per_s", "ttft_p50_ms",
                                          "tpot_p50_ms", "equal",
                                          "near_ties")},
                serve_with_thread={k: d4[k] for k in (
                    "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms", "equal",
                    "near_ties")},
                target_checksum=target_sum)
        finally:
            server.close(60)
        lap("d round, corrupt, thread")
        # (d) two swaps under traffic: the kernel arms held to phase 4's
        # streams (a near tie may part a lane: the acceptance moves the
        # verify windows, ROADMAP C3), the dense arms bit for bit against
        # phase 4g (d kernel)'s run, whose decode the schedule cannot move
        churn = {}
        for arm, knobs, ref in (
                ("kernel", dict(spec=True, spec_k=SPEC_K), None),
                ("dense", DEFAULT_ARMS["d kernel"],
                 default_runs["d kernel"]["streams"])):
            server = p25_server(torch, model, knobs)
            try:
                eng = server.engine
                fns = eng.fns
                _, sd = server.draft_ref()
                cands = [noised(torch, sd, 250 + i) for i in range(2)]
                st0 = eng.spec_stats()
                r = p25_burst(torch, server, reqs, temps, spec_on,
                              swaps=cands)
                add(r["launches"])
                r["acceptance"] = spec_delta(eng.spec_stats(), st0)
                p25_hold(f"(d) churn {arm}", eng.draft_swaps == 2
                         and eng.fns is fns
                         and all(i["swapped"] for i in r["swaps"]),
                         f"draft_swaps {eng.draft_swaps}, {r['swaps']}")
                p25_hold(f"(d) churn {arm} target", weights_equal(
                    torch, model, target), "the target's weights moved")
                p25_hold(f"(d) churn {arm} draft", weights_equal(
                    torch, eng.draft_model, cands[1]),
                    "the serving draft is not the last candidate")
                if ref is None:
                    r["equal"], r["near_ties"] = hold_greedy_streams(
                        torch, model, prompts, r["streams"],
                        main_path["streams"], greedy)
                    # ROADMAP C3: did a swap move a stream?  The same
                    # server and traffic without swaps, (d)'s first burst
                    r["moved_by_swaps"] = [
                        i for i in greedy
                        if r["streams"][i] != no_swap_streams[i]]
                else:
                    differ = [i for i in greedy
                              if r["streams"][i] != ref[i]]
                    p25_hold(f"(d) churn {arm}", not differ,
                             f"greedy lanes {differ} moved across the "
                             "swaps")
                    r["equal"], r["near_ties"] = len(greedy), []
            finally:
                server.close(60)
            moved = ("" if ref is not None else
                     f"; greedy lanes moved against (d)'s burst without "
                     f"swaps: {r['moved_by_swaps']}")
            log(f"phase 25 (d) two swaps under traffic, {arm} arms: "
                + str([{k: i[k] for k in ("lanes_rearmed", "swap_s",
                                          "at_tokens")}
                       for i in r["swaps"]])
                + f"; greedy lanes equal {r['equal']}/{len(greedy)} to "
                + ("phase 4's" if ref is None else "phase 4g (d kernel)'s")
                + f" (near ties {r['near_ties']}){moved}, acceptance "
                f"{r['acceptance']}, slot programs the same object, "
                f"draft_swaps 2, target bit-equal ({card})")
            churn[arm] = {k: r[k] for k in ("swaps", "equal", "near_ties",
                                            "acceptance", "tokens_per_s",
                                            "tpot_p50_ms", "moved_by_swaps")
                          if k in r}
        out["churn"] = churn
        lap("d churn")
        # (e) the disaggregated flavour: the broadcast over 2 decode workers
        server = p25_server(torch, model, dict(spec=True, spec_k=SPEC_K),
                            disagg=True)
        try:
            _, sd = server.draft_ref()
            n = P25_DISAGG_REQUESTS
            r = p25_burst(torch, server, reqs[:n], temps[:n], spec_on[:n],
                          swaps=[noised(torch, sd, 260)])
            add(r["launches"])
            info = r["swaps"][0]
            counts = [e.draft_swaps for e in server.decode_pool]
            logical = server.stats()["decode_pool"]["spec"]["draft_swaps"]
            p25_hold("(e)", info["engines"] == 2 and counts == [1, 1]
                     and logical == 1, f"{info}, workers {counts}, pool "
                     f"{logical}")
            p25_hold("(e) target", weights_equal(torch, model, target),
                     "the target's weights moved")
            lanes = [i for i in greedy if i < n]
            r["equal"], r["near_ties"] = hold_greedy_streams(
                torch, model, prompts, r["streams"], main_path["streams"],
                lanes)
        finally:
            server.close(60)
        log(f"phase 25 (e) DisaggServer (1 prefill + 2 decode workers, spec "
            f"K 4): the swap broadcast {info}, workers' draft_swaps "
            f"{counts}, the pool's {logical}; phase 4's first {n} "
            f"requests, greedy lanes equal phase 4's {r['equal']}/"
            f"{len(lanes)}, near ties {r['near_ties']}; "
            f"{r['tokens_per_s']:.1f} tokens/s ({card})")
        out["e"] = dict(swap=info, workers=counts, equal=r["equal"],
                        near_ties=r["near_ties"],
                        tokens_per_s=r["tokens_per_s"])
        lap("e")
        log(f"phase 25 (d)-(e) seconds by sub-phase {walls}")
    finally:
        tap.undo()
        # the rounds' Trainer fits initialized this one-process job's
        # runtime (a single-process context, cached); the fits' teardown
        # lets the later phases start their own launch contracts
        from tpudist_torch.trainer import Trainer

        Trainer.teardown()
    errors = [e for e in tap.got if e["name"] == "distill_round"
              and e.get("reason") == "error"]
    p25_hold("events", not errors, f"distill_round errors {errors}")
    out["events"] = dict(
        distill_round=sum(e["name"] == "distill_round" for e in tap.got),
        draft_swap=sum(e["name"] == "draft_swap" for e in tap.got))
    out["flywheel_launches"] = launches
    return out


def phase4_server_run(torch, model, knobs: dict, reqs, temps) -> dict:
    """Phase 4's single server with ``knobs``, warmed up, serving ``reqs``
    at ``temps`` (seed = the lane): the yardstick of phase 24 (a')."""
    from tpudist_torch.serve import InferenceServer

    warm_prompt, _, _, _ = phase4_traffic(7)
    server = InferenceServer(model, p23_config(**knobs), device="cuda",
                             install_signal_handler=False).start()
    try:
        warm = server.submit(warm_prompt, max_new=9)
        if not warm.wait(600) or warm.finish_reason != "length":
            raise AssertionError("phase 24: warm-up request did not finish")
        handles = [server.submit(p, max_new=n, temperature=t, seed=i)
                   for i, ((p, n), t) in enumerate(zip(reqs, temps))]
        for h in handles:
            if not h.wait(900):
                raise AssertionError("phase 24: a request timed out")
    finally:
        server.close(60)
    return dict(streams=[h.tokens for h in handles])


def watchdog_path() -> dict:
    """Phase 22 (d): the toy demo as a subprocess under the torchrun
    contract with ``TPUDIST_WATCHDOG_S`` below an injected ``host_delay``
    (``--backend host``: the loop's metric reduce runs on the stalled
    host fabric).  It must exit 124 and leave a crash record holding
    every thread's stack."""
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        err = os.path.join(tmp, "err_%r.json")
        env = dict(os.environ, PYTHONPATH=repo, TPUDIST_ERROR_FILE=err,
                   TPUDIST_WATCHDOG_S=str(WATCHDOG_DRILL_S),
                   TPUDIST_FAULT=f"host_delay@ms:{WATCHDOG_DELAY_MS}",
                   **torchrun_env())
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpudist_torch.examples.demo", "--dry_run",
             "--seed", "0", "--total_iterations", "64", "--backend", "host"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        path = os.path.join(tmp, "err_0.json")
        rec = None
        if os.path.isfile(path):
            with open(path) as f:
                rec = json.load(f)
    if proc.returncode != 124 or rec is None \
            or rec.get("exc_type") != "WatchdogStall" or not rec.get("stacks"):
        raise AssertionError(f"phase 22 (d): exit {proc.returncode}, crash "
                             f"record {rec and rec.get('exc_type')}: "
                             f"{(proc.stdout + proc.stderr)[-2000:]}")
    return dict(rc=proc.returncode, wall_s=wall, threads=len(rec["stacks"]),
                stalled_for_s=rec["stalled_for_s"],
                stall_timeout_s=rec["stall_timeout_s"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full result as JSON to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from tpudist_torch import ops
        from tpudist_torch.models import TransformerLM, create_transformer
        from tpudist_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t_start = time.perf_counter()
    timeline = {}

    def mark(phase: str) -> None:
        """Log the seconds since the start at ``phase``'s end."""
        timeline[phase] = time.perf_counter() - t_start
        log(f"timeline: {phase} done at {timeline[phase]:.1f} s")

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    # every nvcc starts now; the slowest source (LATE_BUILD) builds on in
    # a thread through the phases before 3e, which do not call it
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    late_pool = ThreadPoolExecutor(1)
    late = late_pool.submit(_build.build, (LATE_BUILD,))
    secs = _build.build([n for n in _build.KERNELS if n != LATE_BUILD])
    log(f"build: {time.perf_counter() - t0:.1f} s wall for "
        f"{len(secs)} of {len(_build.KERNELS)} kernels ({LATE_BUILD} builds "
        f"on), per kernel " + ", ".join(f"{k} {v:.1f} s"
                                        for k, v in secs.items()))
    mark("build")

    rec = check_kernels(torch, dev)
    mark("phase 3 paged")
    rec.update(check_sample(torch, dev))
    rec.update(check_residual(torch, dev))
    mark("phase 3 sampling")
    flash_rec, flash_fwd_bwd = check_flash(torch, dev)
    mark("phase 3b")
    lin_rec, lin_info = check_fused_linear(torch, dev)
    mark("phase 3c")

    cpu_model = create_transformer(0, device="cpu", dtype=torch.float32,
                                   **MODEL)
    model = TransformerLM(dtype=torch.bfloat16, **MODEL)
    model.load_state_dict(cpu_model.state_dict())
    model = model.to(dev).requires_grad_(False)
    t0 = time.perf_counter()
    main_path = serve_main_path(torch, model, gen_seed=7)
    main_path["telemetry_off"] = off4 = serve_main_path_off(torch, model, 7)
    log(f"main path (telemetry on, as shipped): {main_path['requests']} "
        f"requests, {main_path['tokens']} tokens in "
        f"{main_path['wall_s']:.3f} s = "
        f"{main_path['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{main_path['ttft_p50_ms']:.2f} ms, TPOT p50 "
        f"{main_path['tpot_p50_ms']:.3f} ms; the same with "
        f"TPUDIST_TELEMETRY=0: {off4['tokens_per_s']:.1f} tokens/s, TTFT "
        f"p50 {off4['ttft_p50_ms']:.2f} ms, TPOT p50 "
        f"{off4['tpot_p50_ms']:.3f} ms ({card}); launches "
        f"{main_path['launches']}; prefill launches by arm "
        f"{main_path['prefill_arm_launches']}")
    spec_path = serve_spec_path(torch, model, 7, main_path)
    log_spec("spec path (tied 4-layer draft, K 4)", spec_path, "phase 4",
             card)
    mark("phase 4")

    t0 = time.perf_counter()
    ad_path = serve_adapter_path(torch, model, gen_seed=7,
                                 cpu_model=cpu_model)
    log(f"adapter path (fused_rope, 4 adapters, rank {RANK}): "
        f"{ad_path['requests']} requests, {ad_path['tokens']} tokens in "
        f"{ad_path['wall_s']:.3f} s = {ad_path['tokens_per_s']:.1f} "
        f"tokens/s, TTFT p50 {ad_path['ttft_p50_ms']:.2f} ms, TPOT p50 "
        f"{ad_path['tpot_p50_ms']:.3f} ms ({card}); {ad_path['forwards']} "
        f"forwards ({ad_path['decode_forwards']} decode), launches "
        f"{ad_path['launches']}, fused_rope_qkv by arm "
        f"{ad_path['rope_arm_launches']}; base lanes equal the "
        f"server without adapters "
        f"({ad_path['base_lanes_equal_no_adapter_engine']}), adapter lanes "
        f"differ ({ad_path['adapter_lanes_differ']}); base "
        f"lanes equal to the unfused arm: "
        f"{ad_path['base_lanes_equal_unfused']} (first divergence "
        f"{ad_path['first_divergence_vs_unfused']}); without adapters "
        f"{ad_path['no_adapter_run']}, unfused {ad_path['unfused_run']}")
    ad_streams = ad_path.pop("streams")
    spec_ad_path = serve_spec_path(torch, model, 7, dict(
        ad_path, streams=ad_streams), adapter_factors(torch, model))
    log_spec("spec adapter path (fused_rope, 4 adapters, tied 4-layer "
             "draft, K 4)", spec_ad_path, "phase 4b", card)
    mark("phase 4b")

    constrained_free = serve_constrained_path(torch, model, 7, main_path,
                                              "free")
    log_constrained("phase 4e's traffic without grammars, stops or "
                    "logprobs (its yardstick)", constrained_free, card)
    constrained = serve_constrained_path(torch, model, 7, main_path)
    log_constrained("phase 4e, constrained serving (4 grammars, top-5 "
                    "logprobs, stop sequences)", constrained, card)
    constrained_spec = serve_constrained_path(
        torch, model, 7, main_path, "spec", constrained)
    log_constrained("phase 4f, the same on the spec server (tied 4-layer "
                    "draft, K 4)", constrained_spec, card)
    constrained_ad = serve_constrained_path(torch, model, 7, main_path,
                                            "adapter")
    log_constrained("phase 4f, the same on the adapter server (fused_rope, "
                    "4 adapters)", constrained_ad, card)
    mark("phase 4e-4f")

    default_runs = {name: serve_arm(torch, model, knobs, 7)
                    for name, knobs in DEFAULT_ARMS.items()}
    default_held = hold_default_arms(torch, model, default_runs, main_path)
    lanes = lanes_path(torch, model, 7, main_path)
    log_default_arms(default_runs, default_held, main_path, lanes, card)
    mark("phase 4g")

    prof = profile_engine(torch, model)
    prof.update({f"adapter {k}": v for k, v in profile_engine(
        torch, model, adapter_factors(torch, model)).items()})
    prof["spec_block"] = profile_spec_block(torch, model)
    log_profile(prof)
    sb, db = prof["spec_block"], prof["decode_block"]
    log(f"spec block: {sb['emitted_tokens']} tokens emitted, device "
        f"{sb['device_ms_per_token']} ms and wall "
        f"{sb['wall_ms_per_token']:.3f} ms per emitted token; phase 5's "
        f"decode block (64 tokens): device "
        f"{(db['device_busy_ms'] or 0) / 64:.4f} ms and wall "
        f"{db['wall_ms'] / 64:.3f} ms per token")
    mark("phase 5")

    import numpy as np

    prompt = np.random.default_rng(11).integers(0, V, size=100)
    ops.reset_launch_counts()
    gpu = prompt_logits(torch, model, prompt)
    with torch.no_grad():
        cpu = prompt_logits(torch, cpu_model, prompt)
    diff = (gpu - cpu).abs()
    rel_rms = float((gpu - cpu).norm() / cpu.norm())
    top1 = float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())
    log(f"prompt logits, card bf16 vs CPU f32: max abs err "
        f"{float(diff.max()):.4f}, rel RMS {rel_rms:.5f}, top-1 agreement "
        f"{top1:.3f} (|logits| max {float(cpu.abs().max()):.3f})")
    # bf16 weights and activations through 8 layers: a few bf16 rounding
    # steps (2**-8 relative each) of a ~1-magnitude logit
    if not (rel_rms <= 0.05 and float(diff.max()) <= 0.25):
        raise AssertionError("card logits disagree with the CPU plain path")
    factors = adapter_factors(torch, cpu_model)["a0"]
    gpu_ad = prompt_logits(torch, model, prompt, factors)
    with torch.no_grad():
        cpu_ad = prompt_logits(torch, cpu_model, prompt, factors)
    ad_diff = (gpu_ad - cpu_ad).abs()
    ad_rel_rms = float((gpu_ad - cpu_ad).norm() / cpu_ad.norm())
    ad_top1 = float((gpu_ad.argmax(-1) == cpu_ad.argmax(-1)).float().mean())
    ad_moved = float((cpu_ad - cpu).norm() / cpu.norm())
    log(f"adapter lane prompt logits (fused RoPE+QKV, LoRA kernel), card "
        f"bf16 vs CPU f32: max abs err {float(ad_diff.max()):.4f}, rel RMS "
        f"{ad_rel_rms:.5f}, top-1 agreement {ad_top1:.3f}; the adapter moves "
        f"the CPU logits by {ad_moved:.4f} rel RMS")
    if not (ad_rel_rms <= 0.05 and float(ad_diff.max()) <= 0.25):
        raise AssertionError("adapter-lane card logits disagree with the "
                             "CPU plain path")
    mark("phase 6")
    secs.update(late.result())
    late_pool.shutdown()
    log(f"build: {LATE_BUILD} {secs[LATE_BUILD]:.1f} s")
    for name in _build.KERNELS:
        text = _build.library_path(name).with_suffix(".log").read_text() \
            if _build.library_path(name).with_suffix(".log").is_file() else ""
        entry = ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = " " + entry_name(m.group(1))
            elif "Used" in line or "spill" in line:
                log(f"  ptxas {name}{entry}: {line.strip()}")
    mlp_rec, mlp_cases = check_fused_mlp(torch, dev)
    mark("phase 3e")
    mesh = serve_mesh_path(torch, model, main_path, ad_streams, card)
    mark("phase 21")
    robust_serve = phase22_serve(torch, model, main_path, mesh, card)
    mark("phase 22 (b)-(c)")
    degrade = phase23_serve(torch, model, main_path, card)
    mark("phase 23")
    disagg = phase24_serve(torch, model, main_path, card)
    mark("phase 24")
    p25 = phase25_moe(torch, main_path, card)
    p25.update(phase25_flywheel(torch, model, main_path, default_runs, card))
    p25["launches"] = {k: p25["launches"].get(k, 0) + n for k, n in
                       p25.pop("flywheel_launches").items()}
    mark("phase 25")
    del model, cpu_model
    gc.collect()
    torch.cuda.empty_cache()

    train, step, tokens = train_main_path(torch)
    log(f"training main path: {train['steps']} steps, loss "
        f"{train['first_loss']:.4f} -> {train['last_loss']:.4f} (mean of the "
        f"last 5 {train['last5_mean']:.4f}); step p50 "
        f"{train['step_ms_p50']:.2f} ms = {train['tokens_per_s']:.0f} "
        f"tokens/s, MFU {train['mfu']:.4f} of 989 TFLOP/s "
        f"({train['flops_per_step'] / 1e12:.2f} TFLOP/step), peak memory "
        f"{train['peak_mem_gb']:.2f} GB ({card}); launches "
        f"{train['launches']}, on the wgmma arms "
        f"{train['launches_wgmma']}")
    train_prof = {"train_step": device_profile(torch, lambda: step(tokens),
                                               lambda: None)}
    log_profile(train_prof)
    del step
    torch.cuda.empty_cache()
    grads = grad_check(torch)
    log(f"gradients, batch 2, bf16 kernels vs f32 plain on the card: loss "
        f"{grads['loss_bf16_kernels']:.5f} vs {grads['loss_f32_plain']:.5f} "
        f"(rel {grads['loss_rel_diff']:.2e} <= {LOSS_REL_MAX}), min cosine "
        f"{grads['min_cos']:.5f} ({grads['min_cos_param']}, >= "
        f"{GRAD_COS_MIN}) over {grads['params']} parameters")
    mark("phases 7-9")

    import tempfile

    corpus_dir = tempfile.TemporaryDirectory()
    corpus = write_chain_corpus(os.path.join(corpus_dir.name, "chains.npy"))
    entry = entry_point_paths(corpus)
    mark("entry points")
    demos = [entry["demo ici"], entry["demo host"]]
    for d in demos:
        log(f"toy demo (--backend {d['backend']}, world 1 under the torchrun "
            f"contract, NCCL): {d['rows']} rows in {d['wall_s']:.1f} s of "
            f"process wall; losses {d['first']} -> {d['last']}, mean of "
            f"the last 16 {d['last16_mean']}")
    benches = bench_path(torch)
    toy, fused = benches["toy"], benches["fused_mlp"]
    log(f"bench_toy: {toy['value']:.1f} samples/s/card ({card}); "
        f"bench_fused_mlp (batch 4096): kernel {fused['kernel_fused']:.1f}, "
        f"plain chain {fused['plain_chain']:.1f} samples/s, ratio "
        f"{fused['kernel_over_plain']:.3f}; vs f64 "
        f"{fused['max_rel_err_vs_f64']:.2e} and "
        f"{fused['plain_rel_err_vs_f64']:.2e}; launches "
        f"{benches['launches']['fused_mlp']} for {fused['kernel_calls']} "
        f"timed calls")
    log_profile({"toy_window": benches["toy_window_profile"]})
    mark("phase 11")

    split = split_path(torch, demos[0]["losses"], entry["model split mp1"])
    log(f"split (model axis 2 on {split['devices']}, stages "
        f"{split['stages']}, world 1 under the {split['launch']} contract, "
        f"{split['backend']}, DDP): {split['rows']} rows, training "
        f"{split['train_wall_s']:.2f} s ({card}); losses {split['first']} -> "
        f"{split['last']}, mean of the last 16 {split['last16_mean']}; "
        f"max rel vs phase 10 {split['max_rel_vs_phase10']:.2e} (bit for "
        f"bit: {split['equal_to_phase10']}); demo_model_split "
        f"--model_parallel 1: {split['mp1']['rows']} rows in "
        f"{split['mp1_wall_s']:.1f} s of process wall, losses -> "
        f"{split['mp1']['last']}")
    mpi = entry["mpi"]
    log(f"MPI demo (OMPI_COMM_WORLD_* world 1 + MASTER_ADDR, NCCL): "
        f"{mpi['wall_s']:.1f} s of process wall ({card}); {mpi['banner']}; "
        f"final losses {mpi['final']}")
    trainer = trainer_path(entry)
    for precision in ("fp32", "bf16"):
        t = trainer[precision]
        log(f"demo_trainer --precision {precision} (1000 steps, batch 128, "
            f"world 1 under the torchrun contract, NCCL): {t['rows']} rows "
            f"in {t['wall_s']:.1f} s of process wall ({card}); losses "
            f"{t['first']} -> {t['last']}, mean of the last 16 "
            f"{t['last16_mean']}")
    r = trainer["resume"]
    log(f"demo_trainer checkpoint round trip (600 steps saving every 200, "
        f"then --resume to 1000): {r['walls_s'][0]:.1f} + "
        f"{r['walls_s'][1]:.1f} s of process wall, {r['rows']} rows, files "
        f"{r['files']}; rows 601-1000 against the unbroken run: bit for bit "
        f"{r['bit_for_bit']}, max rel {r['max_rel']:.2e}")
    p = trainer["profile"]
    log(f"demo --profile_dir ({PROFILE_ITERATIONS} iterations): "
        f"{p['wall_s']:.1f} s of process wall, trace {p['trace_bytes']} "
        f"bytes, {p['kernel_events']} kernel events")

    lm_sub = entry["lm"]
    lm_in = lm_entry_in_process(torch, corpus, train["peak_mem_gb"])
    corpus_dir.cleanup()
    log(f"LM entry point (d1024 bf16, remat dots, --num_workers 2, eval "
        f"every 10, --generate 16; world 1 under the torchrun contract, "
        f"NCCL): {lm_sub['rows']} rows in {lm_sub['wall_s']:.1f} s of "
        f"process wall ({card}); loss {lm_sub['first']:.4f} -> "
        f"{lm_sub['last']:.4f} (mean of the last 5 "
        f"{lm_sub['last5_mean']:.4f}); eval {lm_sub['evals']}; prompt "
        f"{lm_sub['prompt']} -> {lm_sub['generated']}")
    log(f"LM in process: loader {lm_in['loader']}; launches under remat "
        f"({LM_STEPS} steps) {lm_in['remat_launches']}, on the wgmma arms "
        f"{lm_in['remat_launches_wgmma']}")
    for mode in ("prefetch", "sync"):
        r = lm_in[mode]
        log(f"LM step, remat dots, {mode} feed ({card}): "
            f"{r['step_ms']:.2f} ms = {r['tokens_per_s']:.0f} tokens/s, MFU "
            f"{r['mfu']:.4f}; 5 steps profiled: device busy "
            f"{r['idle']['device_busy_ms']} ms of "
            f"{r['idle']['profiled_wall_ms']:.2f}, idle share "
            f"{r['idle']['idle_share']}")
    for policy, r in lm_in["policies"].items():
        log(f"remat {policy}: peak memory {r['peak_mem_gb']:.2f} GB (phase "
            f"7 without remat {train['peak_mem_gb']:.2f}), step "
            f"{r['step_ms']:.2f} ms ({card})")
    g = lm_in["remat_grads"]
    log(f"remat dots gradients vs no remat: bit for bit {g['bit_for_bit']} "
        f"over {g['params']} parameters (max abs diff {g['max_abs_diff']})")
    log(f"--generate: {lm_in['generate']}")
    for opt, losses in lm_in["optimizers"].items():
        log(f"{opt} ({OPT_STEPS} steps, lr {OPT_LR[opt]}): losses "
            f"{[round(x, 4) for x in losses]}")
    torch.cuda.empty_cache()
    mark("phases 12-15")

    public = public_widths_path(torch, card)
    mark("phase 16")
    seq = seq_parallel_path(torch, card)
    mark("phase 17")
    shard = sharded_path(torch, card)
    mark("phase 18")
    moe = expert_3d_path(torch, card, seq["bf16"]["ring"]["losses"])
    mark("phase 19")
    pipe = pipeline_path(torch, card, train["losses"], entry["pp trainer"])
    mark("phase 20")
    robust_train = phase22_train(torch, card)
    wd = entry["watchdog"]
    log(f"phase 22 (d) watchdog: the toy demo under TPUDIST_WATCHDOG_S="
        f"{WATCHDOG_DRILL_S} with host_delay@ms:{WATCHDOG_DELAY_MS} exited "
        f"{wd['rc']} after {wd['wall_s']:.1f} s of process wall, stalled "
        f"{wd['stalled_for_s']:.1f} s, the crash record holding "
        f"{wd['threads']} threads' stacks")
    mark("phase 22")

    kernels = []
    launches = dict(main_path["launches"])
    launches.update({n: train["launches"][n] for n in flash_rec})
    launches.update({n: ad_path["launches"][n] for n in lin_rec})
    launches["fused_residual_prep"] = spec_path["launches"][
        "fused_residual_prep"]
    launches["fused_mlp"] = benches["launches"]["fused_mlp"]
    # the kernels with several arms: each arm's time on the same inputs
    # (the mean of its turns) and its launches on the main path
    mean = statistics.mean
    arms = {
        "paged_attention": (
            {a: mean(t) for a, t in rec["paged_attention"]["arm_ms"].items()},
            {"tc": main_path["decode_tc_launches"],
             "cc": launches["paged_attention"]
             - main_path["decode_tc_launches"]}),
        "paged_prefill": (
            {a: rec["paged_prefill"]["arms"][a]["ms"] for a in ("tc", "cc")},
            main_path["prefill_arm_launches"]),
        # the row arm at the main path's shape beside the cluster arm on the
        # same inputs; serving launches all on the row arm
        "fused_sample": (rec["fused_sample"]["arm_ms"],
                         main_path["sample_arm_launches"]),
        "fused_residual_prep": (rec["fused_residual_prep"]["arm_ms"],
                                spec_path["residual_arm_launches"]),
        "lora_delta": (
            {a: mean(t) for a, t in lin_rec["lora_delta"]["arm_ms"].items()},
            {"cluster": ad_path["lora_cluster_launches"],
             "staged": launches["lora_delta"]
             - ad_path["lora_cluster_launches"]}),
        # split and mma at decode, wgmma at prefill
        "fused_rope_qkv": (
            {a: mean(t)
             for a, t in lin_rec["fused_rope_qkv"]["arm_ms"].items()},
            dict(ad_path["rope_arm_launches"],
                 mma=launches["fused_rope_qkv"]
                 - sum(ad_path["rope_arm_launches"].values())))}
    for name in TRAIN_KERNELS:
        wg = train["launches_wgmma"][name]
        arms[name] = ({"wgmma": mean(flash_rec[name]["arm_ms"]),
                       "mma": mean(flash_rec[name]["replaced_ms"])},
                      {"wgmma": wg, "mma": launches[name] - wg})
    for name, r in (list(rec.items()) + list(flash_rec.items())
                    + list(lin_rec.items()) + list(mlp_rec.items())):
        kernels.append(dict(
            name=name, route=r["route"], source=r["source"],
            replaces=r["replaces"],
            launches=int(launches[name]),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"]))
        if name in arms:
            kernels[-1]["arms"] = {
                a: dict(ms=ms, launches=int(arms[name][1][a]))
                for a, ms in arms[name][0].items()}
        # the shapes this slice added (phase 3, 3b, 3c) and each public
        # configuration's launches by arm (phase 16's runs)
        shapes = r.get("head_dims") or r.get("shapes")
        if shapes:
            kernels[-1]["shapes"] = {
                str(k): dict(ms=t["ms"], plain_ms=t["plain_ms"],
                             library_ms=t.get("library_ms",
                                              t.get("linear_ms")),
                             bound_ms=t["bound"][0], bound_by=t["bound"][1])
                for k, t in shapes.items()}
        # phase 4g's launches by run (the JAX defaults and their
        # neighbours: the dense and gather arms launch no paged decode)
        kernels[-1]["phase4g"] = {
            run: int(r["launches"][name])
            for run, r in default_runs.items() if name in r["launches"]}
        kernels[-1]["phase16"] = {
            ph: (p["train"]["launches"].get(name)
                 or p["serve"]["arms"].get(name))
            for ph, p in public.items()
            if name in p["train"]["launches"] or name in p["serve"]["arms"]}
        if name in TRAIN_KERNELS:
            # phase 17: the ring's launches in the entry point's 10 bf16
            # steps at --seq_shards 4 and in each ring case, and the kernel
            # at the hop shapes
            kernels[-1]["phase17"] = dict(
                launches=int(seq["bf16"]["ring"]["launches"][name]),
                cases={c: int(r["launches"][name])
                       for c, r in seq["cases"].items()},
                hops={hop: dict(ms=h["kernels"][name]["ms"],
                                plain_ms=h["kernels"][name]["plain_ms"],
                                library_ms=h["kernels"][name]["library_ms"],
                                bound_ms=h["kernels"][name]["bound"][0],
                                bound_by=h["kernels"][name]["bound"][1])
                      for hop, h in seq["hops"].items()})
            # phase 18: the TP runs' launches (model 2 folded onto the
            # card, 10 steps) and the kernel at the TP shard's shape
            t = shard["tp_flash"]["kernels"][name]
            kernels[-1]["phase18"] = dict(
                launches={run: int(shard["runs"][run]["launches"][name])
                          for run in shard["runs"]},
                seq_fsdp_launches=int(
                    shard["seq"]["fsdp"]["launches"][name]),
                tp_shard=dict(ms=t["ms"], plain_ms=t["plain_ms"],
                              library_ms=t["library_ms"],
                              bound_ms=t["bound"][0],
                              bound_by=t["bound"][1]))
            # phase 19: the MoE LM's and the 3-D path's launches (10 steps
            # each) and the kernel at the 3-D path's hop shape
            t = moe["three_d_hop"]["kernels"][name]
            kernels[-1]["phase19"] = dict(
                launches={"moe": int(moe["moe"]["launches"][name]),
                          "3d": int(moe["three_d"]["launches"][name])},
                three_d_hop=dict(ms=t["ms"], plain_ms=t["plain_ms"],
                                 library_ms=t["library_ms"],
                                 bound_ms=t["bound"][0],
                                 bound_by=t["bound"][1]))
            # phase 20: each schedule's launches (10 steps at phase 7's
            # model, the stages folded onto the card) and the kernel at
            # the microbatches' shapes
            kernels[-1]["phase20"] = dict(
                launches={run: int(r["launches"][name])
                          for run, r in pipe["runs"].items()},
                shapes={c: dict(ms=sh["kernels"][name]["ms"],
                                plain_ms=sh["kernels"][name]["plain_ms"],
                                library_ms=sh["kernels"][name]["library_ms"],
                                bound_ms=sh["kernels"][name]["bound"][0],
                                bound_by=sh["kernels"][name]["bound"][1])
                        for c, sh in pipe["shapes"].items()})
        # phase 21: each serving-mesh run's launches, and the per-place
        # shapes' times
        kernels[-1]["phase21"] = dict(
            launches={run: int(r["launches"][name])
                      for run, r in mesh["runs"].items()},
            unsharded={fam: int(r["launches"][name])
                       for fam, r in mesh["unsharded"].items()},
            shapes={c: dict(ms=t["ms"], plain_ms=t["plain_ms"],
                            library_ms=t["library_ms"],
                            bound_ms=t["bound"][0], bound_by=t["bound"][1])
                    for c, t in mesh["kernels"].get(name, {}).items()})
        # phase 22: the launches of the Trainer's unbroken fit (the flash
        # kernels) and of the telemetry serving run (the serving kernels)
        kernels[-1]["phase22"] = int(
            robust_train["launches"].get(name, 0)
            + robust_serve["launches"].get(name, 0))
        # phase 23: the launches of the degradation and fleet runs
        kernels[-1]["phase23"] = int(degrade["launches"].get(name, 0))
        # phase 24: the launches of the disaggregated runs
        kernels[-1]["phase24"] = int(disagg["launches"].get(name, 0))
        # phase 25: the launches of the MoE serving runs and the flywheel
        # (its serving runs, the rounds' draft training and scoring)
        kernels[-1]["phase25"] = int(p25["launches"].get(name, 0))
        if name == "fused_sample":
            # the grammar arm on the constrained server (phase 4e's launches)
            # and at phase 3's grammar cases (the planned arm)
            kernels[-1]["grammar"] = dict(
                launches=int(constrained["grammar_launches"]),
                cases={c: dict(ms=r["cases"][c]["arm_ms"][
                    r["cases"][c]["planned"]],
                    bound_ms=r["cases"][c]["bound"][0],
                    plain_ms=r["cases"][c]["plain_ms"],
                    free_ms=r["cases"][c]["free_ms"])
                    for c, *_ in GRAMMAR_CASES})
    result = dict(card=card, kernels=kernels, main_path=main_path,
                  adapter_path=dict(ad_path, streams=ad_streams),
                  spec_path=spec_path, spec_adapter_path=spec_ad_path,
                  constrained_free_path=constrained_free,
                  constrained_path=constrained,
                  constrained_spec_path=constrained_spec,
                  constrained_adapter_path=constrained_ad,
                  default_arms={name: {k: v for k, v in r.items()
                                       if k not in ("prompts", "streams")}
                                for name, r in default_runs.items()},
                  default_arms_held=default_held, lanes=lanes,
                  verify_kernel=rec["paged_attention"]["verify"],
                  fused_linear=lin_info,
                  profile=prof, flash_fwd_bwd=flash_fwd_bwd, train=train,
                  train_profile=train_prof, grads=grads,
                  logits=dict(max_abs_err=float(diff.max()),
                              rel_rms=rel_rms, top1=top1),
                  adapter_logits=dict(max_abs_err=float(ad_diff.max()),
                                      rel_rms=ad_rel_rms, top1=ad_top1,
                                      adapter_moves=ad_moved),
                  fused_mlp_cases=mlp_cases, demos=demos, benches=benches,
                  split=split, mpi=mpi, trainer=trainer,
                  lm_entry=dict(subprocess=lm_sub, in_process=lm_in),
                  public_widths=public, seq_parallel=seq,
                  sharded=shard, moe_overlap_3d=moe, pipeline=pipe,
                  serve_mesh=mesh, robustness=dict(
                      train=robust_train, serve=robust_serve,
                      watchdog=entry["watchdog"]), degradation=degrade,
                  disaggregation=disagg, moe_and_distill=p25,
                  timeline=timeline,
                  smoke_wall_s=time.perf_counter() - t_start)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    log(f"smoke wall: {result['smoke_wall_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
