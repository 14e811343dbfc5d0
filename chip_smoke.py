#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``byteps_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases (any failure raises and the exit code is not 0):

  1. toolchain: torch and CUDA versions, nvcc, the card's name and power
     limit; build the Hopper kernels from ``byteps_tpu_torch/csrc`` (the
     flash kernels at head dims 64 and 128) with ptxas -v, and print each
     flash instantiation's registers, stack and spills (from the log kept
     beside each library, so a cached build prints them too), its dynamic
     shared memory and its count of wgmma (HGMMA), TMA tensor load
     (UTMALDG) and bulk copy (UBLKCP) instructions (``cuobjdump -sass``);
     it fails unless every one holds HGMMA and UTMALDG and spills
     nothing. The same for every codec kernel instance, with its count of
     128-bit global loads and stores (``LDG.E.128``, ``STG.E.128``, any
     modifiers) and bulk copies: it fails on any spill, and unless int8
     quantize, fp8 SR and onebit pack hold a 128-bit load and onebit
     unpack and int8 dequantize a 128-bit store (or a bulk copy), in every
     instance but pack's 4-byte-load one (``WIDE_EXEMPT``). Then the host
     cost of one tensor map encode.
  2. kernel checks, each kernel held against its plain PyTorch version on
     the card, with seeded inputs:
       - flash forward and fused backward at the BERT shape (s 512, h 16,
         d 64, bf16): b 4 causal and not, b 8; the fused backward also
         against autograd of the plain forward;
       - flash forward, dq and dk/dv (the split backward) at the GPT-2
         shape (b 8, s 1024, h 16, d 64, bf16), causal and not; the split
         route's gradients also against autograd of the plain forward;
       - the same three kernels in their bias forms at the T5-small shapes
         (h 8, d 64, T5's scale 1.0): the rel-table form at the encoder's
         (b 8, s 1024, bidirectional) and the decoder's (b 8, s 512,
         causal), the dense form at the encoder's with the materialized
         ``relative_bias`` of the same table; out, lse, dq, dk, dv and
         dtable / dbias (within REL_TOL · max|plain|); the dense and table
         forms bit for bit on out, lse, dq, dk and dv; two launches of the
         table-form dq, the same dtable bits; and the no-bias forward, dq
         and dk/dv at the cross-attention shape (b 8, sq 512 queries over
         sk 1024 keys, not causal, scale 1.0);
       - every flash form again at head dim 128: the forward and fused
         backward at the dh128 BERT shape (b 8, s 512, h 8, d 128), full
         and causal, also against autograd of the plain forward; the
         forward, dq and dk/dv at b 8, s 1024, h 8, causal and full, and
         the split route against autograd; the table and dense forms (bit
         for bit against each other, dtable the same bits on relaunch),
         the causal table and the cross shape at T5's geometry (h 8,
         scale 1.0);
       - onebit pack and unpack, bit for bit, on an adversarial vector
         (±0.0, NaN, ±inf, denormals, 77 elements);
       - int8 quantize and dequantize and fp8 stochastic rounding (E4M3
         and E5M2), bit for bit, on the device encode's probe vector, one
         1,024,000-element bucket and sizes 1 and 128·256 + 3 (dequantize
         launched twice, the same bits); and the
         device encode's payloads of the probe vector against the numpy
         codec (``compress/wire.py``), byte for byte;
       - int8 and fp8 quantize and onebit pack of the views ``x[k:]``,
         onebit unpack of ``words[k:]`` and int8 dequantize of ``q[k:]``,
         k in 0..3, at one bucket, 4,096,003 and 1,025 floats: bit for
         bit, and two launches the same bits;
       - the two forms only ring attention reaches: the forward with fp32
         out (form 1f) at the BERT shape (b 8, s 512, h 16, d 64) and the
         dh128 shape (h 8, d 128), full and causal, and at b 8, s 1024,
         h 16 causal: out within REL_TOL · max|plain|, lse within LSE_TOL,
         and out rounded to bf16 and lse bit for bit the bf16 launch's;
         the fused backward with delta given (form 2d) at the BERT and
         dh128 shapes, full and causal, delta = rowsum(dO∘out): within
         REL_TOL of the plain version, within REL_TOL_AUTOGRAD of autograd
         of the plain forward, and bit for bit the split route's dq and
         dk/dv with the same delta;
       - determinism: each flash kernel launched twice on the same
         inputs, the same bits (forward bf16 and fp32 out, fused backward
         with delta computed and given at the BERT shapes; dq and dk/dv
         at b 8, s 1024 causal; forward, dq and dk/dv in the dense and
         table forms at T5's encoder shape), at head dims 64 and 128;
       - GPT-2's long context: the forward, dq and dk/dv kernels at b 1,
         s 32768, h 16, d 64, causal, launched on all 16 heads; heads 0
         and 15 held against the plain versions run on that head alone
         (all 16 heads' fp32 scores would be 68.7 GB);
       - the flash ring's schedule at sp 4 in one process
         (``parallel/ring.py::ring_schedule``: the shards are slices; each
         rank's blocks in the ring's order, kv rank (rank - step) mod 4,
         diagonal, visible and hidden): b 2, global s 2048 (four 512
         shards), h 16 d 64 and h 8 d 128, causal and full; out against
         ``local_attention`` of the whole sequence (REL_TOL), dq, dk, dv
         against its autograd (REL_TOL_AUTOGRAD).
  3. times (CUDA events, median of 30 launches, L2 flushed before each,
     the device kept busy until the launch is enqueued) of
     each kernel, its plain version and, where one PyTorch call computes
     the same function, that call (``scaled_dot_product_attention``, timed
     as a yardstick only; the port never calls it; for the bias forms with
     the materialized bias as its float ``attn_mask``, built outside the
     timed window), beside the least time the card could take. Attention
     at the shape its training phase gives it (the table and dense forms
     at the T5 shapes above); at head dim 128 the forward and fused
     backward at the dh128 shape, the forward, dq and dk/dv at b 8, s
     1024, h 8 causal, the table and dense forms at T5's encoder geometry;
     onebit, int8 and fp8 on one 4,096,000-byte bucket (and, printed
     only, on four buckets at once, beside the harness's floor: an almost
     empty launch, ``torch.cuda._sleep(0)``, timed the same way; pack of
     ``x[1:]`` and dequantize of ``q[1:]``, their instances for views,
     under ``view`` in the kernel line); the forward, dq and dk/dv at
     b 1, s 32768, h 16, d 64 causal (their plain versions head by head,
     median of 3); the ring's forms 1f and 2d at the BERT shape (d 64) and the dh128 shape (d 128), full,
     against the library's forward and backward; and each flash
     wrapper's host microseconds per call at the BERT shapes (checks,
     allocations, tensor maps and launches, enqueued while the card is
     busy), and the autograd Function's forward.
  4. training through the port's ``DistributedTrainer``, random weights
     from seed 0, AdamW(1e-4, weight_decay 1e-4), 3 steps on one fixed
     synthetic batch of 8, at full width (bf16 compute over fp32 params,
     whole-block remat). Each run zeroes every kernel's launch counter
     just before its 3 steps and reads them just after; they must read
     what that path launches (remat runs each layer's forward twice):
       - BERT-large MLM, 24 x 1024 x 16, vocab 30522, seq 512: 144
         forward and 72 fused-backward launches, all at head dim 64;
       - BERT-large under ``examples/perf_lab.py``'s other ``--remat``
         arms (``BERT_REMAT``): no remat, ``dots``, ``mlp_only``,
         ``save_attn``: 72 forward launches (144 under ``dots``, which
         recomputes the flash forward) and 72 fused; step 1's loss bit
         for bit the whole-block run's; the step-1 gradients' norm of
         fresh weights within GRAD_NORM_TOL of its (printed whether bit
         for bit); peak memory and step beside whole-block remat's;
       - BERT-large with ``attn_impl="hybrid"``: attention's forward
         from plain products (``flash_attention.hybrid_fwd``), no forward
         kernel; 72 fused-backward launches at head dim 64; step 1's loss
         within HYBRID_TOL of the flash run's; its step time, peak memory
         and the plain forward's device time (the ``bps::hybrid_fwd``
         range) printed beside the flash run's; then ``check_hybrid``:
         ``hybrid_fwd`` against the forward kernel on the same inputs at
         the path's shape (lse within HYBRID_LSE_TOL, out within a bf16
         step), the attention's gradients there within HYBRID_OP_TOL of
         the flash route's and the step-1 gradients of fresh weights
         within HYBRID_GRAD_TOL of the flash path's, with the fault
         controls of HYBRID_CONTROLS (bf16 products, an lse one bf16 step
         high, TF32; T5 also without its relative bias) read beside them,
         the gated ones above the limit;
       - BERT-large at 8 heads of 128 (``bench.py``'s dh128 variant,
         ``dataclasses.replace(bert_large, heads=8)``): 144 forward and 72
         fused-backward launches, all at head dim 128, none at 64; its step
         time, rates and profiled step printed beside the d-64 run's;
       - GPT-2 medium, 24 x 1024 x 16, vocab 50257, seq 1024 (two 512
         attention blocks, so the split backward): 144 forward, 72 dq and
         72 dk/dv launches;
       - the LM head at GPT-2's shape (b 8, s 1024, vocab 50257): the
         bf16 x bf16 -> fp32 GEMM against the fp32 product of the rounded
         operands on the same inputs (logits within HEAD_LOGITS_TOL ·
         max|ref|, dh and dE within REL_TOL), both timed forward and
         forward + backward; then GPT-2 medium dense again with the fp32
         route (``gpt2_medium dense fp32 head``): step 1 within
         HEAD_LOSS_TOL of the dense run's, its step beside it;
       - GPT-2 medium with the README's gradient compression (onebit with
         the L1-mean scale, vanilla error feedback, Nesterov momentum):
         as the dense run, plus 3 x nc pack and 3 x 2 x nc unpack
         launches for the nc compressed buckets of the plan (world 1:
         error feedback's decompress and the one gathered payload's);
       - GPT-2 medium at ``CUT_LAYERS`` with the compressors beyond
         onebit (``GPT2_COMPRESSION``): topk and randomk at 1% with error
         feedback, dithering at 4 linear levels, and the README's onebit
         over the rs exchange (the dense run's launches, plus 3 x 2 x nc
         pack and 3 x 4 x nc unpack launches for onebit over rs).
         topk, randomk and dithering then reduce one step's real
         gradients (fresh weights, step 1) with a fresh plan: the result
         must differ from the dense gradient, and be bit for bit the CPU
         route's on the gradients copied to the host (randomk and
         dithering with both routes' draws injected from one stream; topk
         but for elements at a tied k-th magnitude). Both onebit paths
         (gather and rs) run ``check_onebit_reduction`` instead;
       - BERT-large MLM through the parameter-server path (``bps.init()``
         with ``BPS_ENABLE_PS=1``: the in-process server at world 1),
         once with ``BPS_COMPRESS=int8`` and once with ``fp8_e4m3``, each
         bucket encoded on the card: the BERT launches plus, for the nc
         compressed buckets, 3 x nc int8 quantize and 3 x nc dequantize
         launches (int8, error feedback on) or 3 x nc fp8 launches (fp8).
         Step 1's loss must equal the dense BERT run's (same weights and
         batch), step 2's lie within PS_STEP2_TOL of it, and
         ``ps/d2h_bytes`` must read the payload sizes, under 0.3 x the
         dense gradient bytes. Then one step's real gradient buckets,
         encoded through the kernels and through their plain versions,
         must agree bit for bit: payload, scale and new residual. Those
         runs take the default route (the staged head, the streamed tail,
         the cross-step driver): the push bytes sent before the backward
         ended and the PS_APPLY_CHUNK / PS_XSTEP_GATE spans are printed;
         then, in turn on a fresh server, the monolithic route
         (``BPS_APPLY_CHUNKED=0``) on the same weights and batch must end
         its 3 steps with the same parameters bit for bit, push step 1's
         payloads with the same bytes and launch the same kernels as often;
         each route's steps 2-3 (the last tail drained) are printed beside
         the card. ``bert_large_ps_int8_accum2``: ``backward_passes_per_step
         =2``, 4 micro-steps on two batches, the launches of 4 forwards and
         backwards and 2 rounds of codecs, step 1's loss the dense run's,
         and the exchanged means of two leaves bit for bit numpy's running
         mean (``check_running_mean`` first holds the card's at k 3).
       - T5-small seq2seq (``t5_small()``: 6 + 6 layers x 512 x 8 heads of
         64, vocab 32000, relative position tables, 32 buckets), source
         1024, target 513 (the decoder sees 512): 72 table-form forward
         launches (3 x 2 x (6 encoder + 6 decoder self-attention)), 36
         no-bias forward (cross-attention), 36 table-form dq and dk/dv, 18
         no-bias dq and dk/dv (cross-attention over two 512 blocks of
         source takes the split backward), 0 fused, 0 dense-bias;
         then with ``attn_impl="hybrid"``: no forward kernel, the same
         dq and dk/dv launches, step 1 within HYBRID_TOL of the flash
         run's, printed beside it, and ``check_hybrid`` at the encoder,
         decoder and cross shapes;
       - sequence parallelism through the port's ``ShardedTrainer`` on a
         ``{"seq": 1}`` mesh (a ring of one; ``sp_axis="seq"``):
         BERT-large MLM at seq 512 with the full-sequence head, 144
         fp32-out forward and 72 delta-given fused launches and no other
         flash launch, step 1's loss within 2e-2 of the same config's on
         the naive ring; GPT-2 medium at seq 1024 (one shard of two
         512 blocks: the split backward with delta given), 144 fp32-out
         forward, 72 dq, 72 dk/dv, 0 fused, step 1's loss within 1e-5 of
         this call's dense GPT-2 step 1 (the same weights and batch; a
         ring of one's merge returns the block's partial unchanged), and
         whether it is bit for bit; then GPT-2 medium through
         ``ShardedTrainer`` on ``{"seq": 1}`` with
         ``backward_passes_per_step=2`` and the README's onebit kwargs, 4
         micro-steps on one batch, each counted on its own: the ring's
         launches every micro-step, onebit's pack nc and unpack 2·nc at
         each sync boundary (``gpt2_medium onebit``'s step) and none in
         between; the second micro-step's loss bit for bit the first's
         (no update mid-window), the third's lower;
       - GPT-2 medium at ``examples/long_context_bench.py``'s long context
         (``max_seq`` 32768, batch 1, ``lm_head_chunk=2048``, whole-block
         remat): 144 forward, 72 dq, 72 dk/dv launches, all at s 32768;
         then one step with the full head (the control): its loss within
         LONG_HEAD_TOL of the chunked run's step 1, the chunked run's
         peak memory lower by at least one fp32 [s, vocab] tensor (6.59
         GB);
       - the BytePS API (``bps.init()`` first, world 1), BERT-large at
         the dense run's weights, batch and AdamW: ``bert_large_plugin``,
         the optimizer wrapped by ``byteps_tpu_torch.torch.
         DistributedOptimizer`` after ``broadcast_parameters`` and
         ``broadcast_optimizer_state`` from rank 0 (no hook at world 1),
         its losses the dense run's bit for bit, 144 forward and 72 fused
         launches; ``bert_large_pushpull_int8`` (``BPS_ENABLE_PS=1``,
         ``BPS_COMPRESS=int8``, ``BPS_TELEMETRY_ON=1``): every gradient
         through the plugin's ``push_pull_async_inplace`` in
         ``declare_model_keys`` order, then ``synchronize`` on each;
         ``bert_large_pushpull_fp8`` (``fp8_e4m3``): the gradients as
         trees (the embeddings, each layer's slice of the stacked block
         tensors, the final layer norm) through the top-level
         ``push_pull_async`` / ``synchronize`` (the engine's deferred PS
         hop). Each PS path: step 1's loss the dense run's, step 2 within
         PS_STEP2_TOL, 3 x nc quantize (and dequantize) or fp8 launches
         for the nc compressed partitions the exchange's plan reports,
         ``ps/d2h_bytes`` under 0.3 x the dense bytes, a positive
         ``get_pushpull_speed()`` (int8: each reading within
         x``SPEED_FACTOR`` of ``window_mbps``, the 10 s window modelled per
         exchange), and step 1's exchanged embedding and
         block gradients (``API_CHECK``, ``API_CHECK_TREES``) bit for bit
         the same tensors' CPU copies exchanged through the plain
         versions by a second exchange on its own server, its keys
         declared in the same order. Each prints its step time, samples/s
         and the API's own host time a step (dispatch to the last
         ``synchronize``) beside the card's name and power limit;
       - compression on the PS side, BERT-large at the dense run's
         weights and batch, ``BPS_ENABLE_PS=1``, world 1:
         ``bert_large_ps_onebit``, ``DistributedTrainer(compression=
         README_COMPRESSION)``: the legacy chains on the host, the flash
         launches dense BERT's and no codec kernel, ``ps/push_bytes`` at
         most PS_ONEBIT_BYTES of the dense PS run's (the gradient's bytes),
         step 1's loss the dense run's, and step 1's summed gradient as
         the worker received it bit for bit ``replay_chains``: the same
         dense gradient through fresh worker and server chains in numpy;
         ``bert_large_ps_auto`` (``BPS_COMPRESS=auto``), run (a) on live
         signals and run (b) with nic/stalls injected before each of the
         first AUTO_STALL_ROUNDS rounds under ``BPS_COMPRESS_MAX=
         fp8_e4m3``, each round's backlog sample, verdict and levels
         printed: the level trace equals a fresh controller's replay of
         the recorded signals, each round's int8 quantize / dequantize
         and fp8 SR launches are its buckets at those rungs, the
         ``compress/decisions`` counter is the level changes; (b) must
         climb none -> fp16 -> int8 -> fp8_e4m3; ``bert_large_ps_watchdog``
         (int8, ``BPS_WATCHDOG_SEC=2``): an unwedged run of 5 steps with
         no dump, then 3 steps with no dump and a fourth whose last
         bucket's pull ``PullHold`` (a fault injection) holds 6 s: the
         dump names that key within 4 s and carries its push from the
         flight ring, and the 5 losses are the unwedged run's bit for bit;
       - remote PS: BERT-large PS int8 on the default route through the
         port's standalone server (``python -m
         byteps_tpu_torch.launcher.launch --server`` on port 0, the port
         read from its ``server up on :<port>`` line; the transport of
         ``server/transport.py``). (a) world 1: 3 steps through the
         server, then in turn 3 steps in process from the same seed and
         batch: the same losses and every parameter bit for bit, the same
         launches (BERT's plus 3·nc int8 quantize and dequantize), no
         resend, each arm's steps 2-3 printed beside the card. (b) world 2:
         a server for two workers and two worker processes on ``cuda:0``
         (``--world2-worker``), each from seed 0 on its own batch (seed
         = worker id): both end with the same parameters bit for bit (a
         sha1 of every parameter's bytes), finite losses, each worker's
         launches (those of (a)), ``transport/resends`` 0; each worker's
         steps 2-3 (two processes sharing one card: not a scaling figure)
         and push and pull bytes a step printed. A worker's failure or
         timeout (REMOTE_WAIT) fails the phase; every process it started
         is stopped. (b) runs twice in turn, each arm on a fresh server
         and the same batches: (b0) as above, then (b1) with
         ``BPS_SHARDED_UPDATE=1`` (each worker pulls and applies only the
         bucket groups it owns, publishes their parameters and installs
         the others'): both (b1) workers end with (b0)'s sha1; each
         engaged the sharded state (no fallback line); optimizer state
         exists for its owned groups only, and the two owned sets
         partition the groups; the launches are (b0)'s (every worker
         still encodes every bucket, whose error-feedback fold runs the
         dequantize kernel); the pull sets cover every bucket and share
         only the boundary ones; each worker's ``ps/pull_bytes`` is below
         (1/2 + 0.2) x its (b0) figure; summed over the workers,
         ``ps/param_put_bytes`` and ``ps/param_fetch_bytes`` are each
         ``STEPS`` x the parameters' fp32 bytes; no resend. Optimizer-state
         bytes, peak memory, the plan's balance and each step are printed
         beside (b0)'s. (c) ``bert_large_ps_lag``, bounded staleness:
         BERT-large dense PS (no ``BPS_COMPRESS``) on the default route at
         world 2, two worker processes (``--lag-ps-worker``) and a fresh
         server each arm, the same batches in every arm: (c0) K=1; (c1)
         ``BPS_MAX_LAG=2`` with the server's ``BPS_LAG_GRACE_MS=60000``;
         (c2) K=2, grace 0, under ``LagHold`` (round 1 met by files, then
         worker 1's round-2 pushes held until worker 0 pulled a round-2
         key, and 2 s more). Every arm: both workers the same sha1 of
         their parameters, finite losses, BERT's launches (144 / 72) and
         no codec launch; (c0) no resend; (c1) every verdict complete and
         the server's ``lag/stale_serves`` and ``lag/late_folds`` 0; (c2)
         worker 0 saw a stale verdict, the server's ``lag/stale_serves``
         and ``lag/late_folds`` >= 1 and ``lag/max_streak`` <= 1 (the
         ``server stats`` line its launcher prints when it stops). Each
         arm prints steps 2-3, bytes, verdicts, the largest
         ``xstep/epoch_lag``, peak memory and the server's peak RSS. (d)
         ``bert_large_ps_async``, async PS (``BPS_ENABLE_ASYNC=1``),
         BERT-large dense at full depth: (d0) world 1 in process; (d1)
         world 2, two worker processes (``--async-ps-worker``) against a
         fresh async server, the fp32 wire; (d2) the same at
         ``BPS_ASYNC_WIRE_DTYPE=bfloat16``. Every worker: BERT's launches
         and no codec launch, finite losses with step 3 below step 1,
         each key pushed once a step; each key's round, the engine
         drained, ``STEPS`` x the workers; the store (d0) the fp32 replay
         of init and the deltas in push order, bit for bit, (d1) and (d2)
         within ``async_store_check``'s bound of the float64 sum of init
         and both workers' reported deltas; push bytes 4 x the parameters
         a step ((d2): half), pull bytes 4 x (the store stays fp32); the
         card's bf16 rounding bit for bit the host codec's
         (``check_bf16_card``); every parameter the weights its last
         pull wrote, and at world 2 the other worker's deltas in them;
         (d1)'s server RSS at each step's end, printed (``--async-ps``:
         over 3 + 7 steps). (e) ``bert_large_ps_store_routes``, PS int8
         at world 2 over ``launch --server`` at ``CUT_LAYERS``, two worker
         processes (``--store-routes-worker``) and a fresh server each
         arm: (e0) the default, where ``FusedFront``'s homogeneous store
         owns the fused keys, (e1) ``BPS_FUSED_HOMOG=0``, where the
         engine does; (e2) row-sparse rounds on the vocabulary table
         against (e1)'s server (``train_bert_ps_store_routes`` has the
         gates: one sha1 over both workers and both arms, the servers'
         fused counters, each table bit for bit a numpy reference, the
         push bytes exact). (f) ``bert_large_checkpoint``, world 1 dense
         at ``CUT_LAYERS``:
         ``checkpoint.save_checkpoint`` after step 2, step 3, then a
         fresh trainer from other weights restored and stepped: its step
         3 bit for bit the original's (``train_bert_checkpoint``). (g)
         ``bert_large_ps_transport``, dense PS at world 2 over ``launch
         --server`` at ``CUT_LAYERS``, two worker processes
         (``--transport-worker``), a fresh server an arm: (f0) TCP, (f1)
         the colocated deployment (the server and the workers at
         ``BPS_ENABLE_IPC=1``, the workers at ``BPS_ENABLE_SHM=1``), (f2)
         striping over TCP (``BPS_STRIPE_MIN=1048576``); one sha1 over
         every worker and arm, and the server's frames by op exact from
         the bucket plan (``check_transport_server``); ``/dev/shm``'s
         room checked first (``shm_fit``). (h) ``bert_large_ps_snapshot``,
         (f3): async PS at world 1 and ``CUT_LAYERS`` against a server at
         ``BPS_SERVER_SNAPSHOT``, stopped after 2 steps (its final
         snapshot) and restarted on the same port from the file; the
         worker (``--snapshot-worker``) reconnects, reads every key's
         bits back and takes step 3 (``check_snapshot_restart``). (i)
         ``bert_large_ps_membership``, dense PS at world 2 over ``launch
         --server`` at full depth with ``BPS_SHARDED_UPDATE=1``, two
         worker processes (``--membership-worker``), a fresh server an
         arm: (g0) 3 steps with a sharded checkpoint saved after step 2,
         (g1) a LEAVE of worker 1 after step 1 and its JOIN after step 2
         (``trainer.reshard``), (g2) two fresh workers
         (``--membership-restore-worker``) restoring (g0)'s checkpoint and
         taking step 3: one sha1 and the same losses over every worker and
         arm, the plans and state bytes around each reshard
         (``check_membership_plans``), the slices
         (``check_membership_slices``). The PS
         fp8 routes, the fp8 tree API, PS onebit, PS int8 accumulation,
         PS auto, the PS watchdog, int8 over TCP at world 1, the world-2
         arms (b0)/(b1), the lag arms (c0)-(c2), the async world-2 arms
         (d1)/(d2), the store-route arms (e0)/(e1), the transport arms
         (f0)-(f2), (f3), the full-tree checkpoint and GPT-2 medium's
         topk, randomk, dithering and onebit-over-rs paths run at
         ``CUT_LAYERS`` of the 24 layers, for the
         run's time limit, their losses held against a dense run at that
         depth where they compare losses; every other path runs at full
         depth. Each block of the run (the build, the kernel checks and
         timings, the dense paths by model) and each PS and remote phase
         prints its seconds (``[phase]``), all of them on one ``phase
         seconds`` line; a world-2 phase prints each arm's seconds and
         its server's boot (every arm's server is spawned at the phase's
         start).
     Losses must be finite and falling. BERT (both widths), dense GPT-2
     and T5 repeat step 1 with ``attn_impl="naive"`` (plain attention on
     the card) as the reference for the loss; every run prints step time,
     rates, peak memory and one profiled step's device busy/idle split,
     its device time by kernel group, each codec kernel's device time
     and launches, and the device time of the kernels inside the port's
     profiler ranges (``RANGES``: the hybrid forward, the compressed
     exchange, the LM head's GEMMs). The compressed run then
     holds one step's compressed reduction of real gradients through the
     kernels against the same reduction through their plain versions,
     bit for bit: packed words, scales, decompressed values, error
     feedback, momentum and the reduced gradient.
  5. one JSON line ``{"kernels": [...]}`` (each flash kernel at head dim
     64, with its bias and table forms under ``forms``, the ring's forms
     under ``fp32_out`` (forward) and ``delta`` (fused backward), the
     forward, dq and dk/dv at s 32768 under ``s32768``, its
     ptxas rows, and the same entry at head dim 128 under ``d128``), the
     card's name
     and power limit, and as the last line
     ``{"ok": true, "device": {...}}``.

It exits with code 2, printing no result, when no CUDA device is present
or when the ``byteps_tpu_torch`` package is not beside it.

    python3 chip_smoke.py --host-us PARENT

prints only the host microseconds per call of the four flash wrappers at
both head dims, this checkout's kernels against those of the checkout at
PARENT (built here), in turns in one process, as one JSON line.

    python3 chip_smoke.py --codec-ab PARENT [STEM ...]

prints only the device milliseconds of the codec kernels STEM (default
``onebit_pack fp8_sr_quantize``; also ``int8_quantize``,
``onebit_unpack``, ``int8_dequantize``) on one bucket, this checkout's
against those of the
checkout at PARENT (built here, each called through its own C entry
point with its own launch plan), in turns in one process, the int8
quantize beside ``torch.quantize_per_tensor``, as one JSON line.

    python3 chip_smoke.py --hybrid-check

runs only ``check_hybrid`` for BERT-large and T5-small (the kernels
built first), printing every reading and gating none: the way to read
the controls again before HYBRID_GRAD_TOL moves.

    python3 chip_smoke.py --ps-profile

prints only where the PS API's fp8 tree path spends its time beside the
trainer's exchange of the same BERT-large gradients (``ps_profile``).

    python3 chip_smoke.py --ps-routes [CODEC ...]

runs only BERT-large through ``DistributedTrainer`` in PS mode under each
CODEC (default int8 and fp8_e4m3) on four routes in turns (the default,
``BPS_CROSS_STEP=0``, ``BPS_BWD_STAGED=0``, ``BPS_APPLY_CHUNKED=0``): each
route's steps 2-3 with the last tail drained, its host stage sums, every
thread group's CPU seconds over those steps and a 2 ms stack sampler over
step 3 (``ps_routes``). Prints ``{"ps_routes": ...}``, also written to
``chiprun_out/ps_routes.json``, the card line and the same last line.

    python3 chip_smoke.py --remote-ps
    python3 chip_smoke.py --async-ps
    python3 chip_smoke.py --store-routes
    python3 chip_smoke.py --transport
    python3 chip_smoke.py --membership

runs only phase 4's remote PS runs and (e)-(i) (the kernels and the
server engine built first), or of them only ``bert_large_ps_async`` with
``ASYNC_SOAK`` more (d1) steps for the server's resident set, or only
``bert_large_ps_store_routes`` and ``bert_large_checkpoint``, or only
``bert_large_ps_transport`` and ``bert_large_ps_snapshot``, or only
``bert_large_ps_membership``, and prints
``{"remote_ps": ...}``, the card line and the same last line.

    python3 chip_smoke.py --world2-worker WID DIR
    python3 chip_smoke.py --lag-ps-worker WID DIR
    python3 chip_smoke.py --async-ps-worker WID DIR SOAK
    python3 chip_smoke.py --store-routes-worker WID DIR
    python3 chip_smoke.py --transport-worker WID DIR
    python3 chip_smoke.py --snapshot-worker DIR
    python3 chip_smoke.py --membership-worker WID DIR
    python3 chip_smoke.py --membership-restore-worker WID DIR

is one worker of phase 4's remote PS runs (``world2_worker``,
``lag_ps_worker``, ``async_ps_worker``, ``store_routes_worker``,
``transport_worker``, ``snapshot_worker``, ``membership_worker``); the
phase starts them itself.

    python3 chip_smoke.py --world 2

runs only the BytePS API and the compressed rs exchange over 2 cards (one
process per card, NCCL over ``tcp://localhost``): BERT-large through the
plugin's ``DistributedOptimizer`` (every rank rank 0's weights after it),
``push_pull`` and ``push_pull_async`` of one backward's gradients against
their mean, and one round of the README's onebit over the rs exchange on
those gradients (``world_rs_round``: the kernels and the plain versions
bit for bit, every rank the same bits, the pack and unpack launches). It
prints ``{"world": {...}}``, the card line and the same last line.

    python3 chip_smoke.py --sp 4

runs only the sequence-parallel path over 4 cards of one host instead
(one process per card, NCCL over ``tcp://localhost``): ring attention at
sp 4 (b 2, s 2048, h 16 d 64 and h 8 d 128, causal and full) against
``local_attention`` of the whole sequence and its autograd, and against
``ring_schedule`` on one card; each rank's launches; the ring's forward
and backward timed on each card beside the whole sequence's flash
attention on one; then BERT-large (seq 512) and GPT-2 medium (seq 1024)
through ``ShardedTrainer`` on ``{"seq": 4}`` for 3 steps (losses finite
and falling, step 1 within 2e-2 of the dense model's loss on one card,
every rank the same weights bit for bit, each rank's launches). It
prints ``{"sp": {...}}``, the card line and the same last line.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import hashlib
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM, NVIDIA data sheet: dense bf16 tensor-core peak, fp32 peak
# outside the tensor cores, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# 32-bit integer operations: 64 INT32 lanes a SM (half the fp32 lanes) at
# the boost clock that the fp32 figure assumes (132 · 128 · 2 · 1.98e9)
PEAK_INT32_OPS = 132 * 64 * 1.98e9

KERNELS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
           "onebit_pack", "onebit_unpack", "int8_quantize", "int8_dequantize",
           "fp8_sr_quantize")
FLASH = KERNELS[:4]
# the kernels with bias forms (csrc/flash_bias.cuh), counted per form
FLASH_FORMS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FORMS = ("bias", "rel")
# the head dims the flash kernels are built for, counted per width (the
# wrapper's KERNEL_DS; main checks that they agree)
WIDTHS = (64, 128)
# the forms only ring attention reaches, counted on their own (the
# wrappers' ``variants``): the forward's fp32 out, the fused backward's
# given delta; their names in the kernel line
VARIANTS = (("flash_fwd", "f32"), ("flash_bwd_fused", "delta"))
VARIANT_NAMES = {"f32": "fp32_out", "delta": "delta"}
COUNT_KEYS = (KERNELS + tuple(f"{k}:{f}" for k in FLASH_FORMS for f in FORMS)
              + tuple(f"{k}:d{d}" for k in FLASH for d in WIDTHS)
              + tuple(f"{k}:{f}:d{d}" for k in FLASH_FORMS for f in FORMS
                      for d in WIDTHS)
              + tuple(f"{k}:{v}" for k, v in VARIANTS)
              + tuple(f"{k}:{v}:d{d}" for k, v in VARIANTS for d in WIDTHS))
BITWISE = ("onebit_pack", "onebit_unpack", "int8_quantize", "int8_dequantize",
           "fp8_sr_quantize")
# the Pallas kernels the Hopper kernels replace
REPLACES = {
    "flash_fwd": "byteps_tpu/ops/flash_attention.py:172",
    "flash_bwd_fused": "byteps_tpu/ops/flash_attention.py:489",
    "flash_bwd_dq": "byteps_tpu/ops/flash_attention.py:335",
    "flash_bwd_dkv": "byteps_tpu/ops/flash_attention.py:421",
    "onebit_pack": "byteps_tpu/ops/compression/pallas_kernels.py:39",
    "onebit_unpack": "byteps_tpu/ops/compression/pallas_kernels.py:48",
    "int8_quantize": "byteps_tpu/ops/compression/pallas_kernels.py:120",
    "int8_dequantize": "byteps_tpu/ops/compression/pallas_kernels.py:130",
    "fp8_sr_quantize": "byteps_tpu/ops/compression/pallas_kernels.py:176",
}
SOURCES = {
    "flash_fwd": "byteps_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_fused": "byteps_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dq": "byteps_tpu_torch/csrc/flash_dq.cu",
    "flash_bwd_dkv": "byteps_tpu_torch/csrc/flash_dkv.cu",
    "onebit_pack": "byteps_tpu_torch/csrc/onebit_pack.cu",
    "onebit_unpack": "byteps_tpu_torch/csrc/onebit_unpack.cu",
    "int8_quantize": "byteps_tpu_torch/csrc/int8_quantize.cu",
    "int8_dequantize": "byteps_tpu_torch/csrc/int8_dequantize.cu",
    "fp8_sr_quantize": "byteps_tpu_torch/csrc/fp8_sr_quantize.cu",
}
# max |kernel - plain| <= REL * max |plain| (bf16 outputs: both sides round
# at the same points and differ by fp32 summation order, one bf16 step is
# 2^-8 relative); lse is fp32 and gets an absolute bound. The onebit
# kernels move bits and must agree bit for bit.
REL_TOL = 1e-2
REL_TOL_AUTOGRAD = 3e-2     # vs autograd of the plain forward, whose P and
#                             dS are not rounded to bf16
LSE_TOL = 1e-3
SPIN_CYCLES = 2_000_000     # about 1 ms of device time at H100 clocks
TRAIN_BATCH, STEPS = 8, 3
BERT_SEQ, GPT2_SEQ, HEADS, HEAD_DIM = 512, 1024, 16, 64
# bench.py's dh128 variant of BERT-large: the same hidden, layers and
# FLOPs as 8 heads of 128 instead of 16 of 64
DH128_HEADS, DH128 = 8, 128
# T5-small: the decoder length of examples/long_context_bench.py --t5
# (dec_len 512, fed dec_len + 1 targets) over a source of two 512 blocks;
# 8 heads of 64, the rel table of 32 buckets up to distance 128
T5_SRC, T5_TGT, T5_HEADS, T5_BUCKETS = 1024, 513, 8, 32
# the ring schedule's check: 4 ranks of one 512 shard each
RING_SP, RING_BATCH, RING_SEQ = 4, 2, 2048
# |step-1 loss of GPT-2 on a ring of one - the dense run's| (the same
# weights, batch and kernels' bits: the merge returns the partial as is)
SP_DENSE_TOL = 1e-5
# the trainer's defaults (BPS_PARTITION_BYTES, BPS_MIN_COMPRESS_BYTES)
PARTITION_BYTES, MIN_COMPRESS_BYTES = 4_096_000, 65536
BUCKET_FLOATS = PARTITION_BYTES // 4    # one full gradient bucket
# |step-2 loss of a PS run - the dense run's|: AdamW's first step moves
# every weight by about lr·sign(g), and a gradient quantized to a code of 0
# leaves its weight in place, so the compressed step lowers the loss less
# than the dense one. 0.05 is 8% of the dense BERT run's step-1 decrease
# (10.5543 -> 9.9274 on one H100 80GB HBM3 at 700 W, PERF.md); int8 fell
# 1.7% short of it there, fp8 (stochastic rounding keeps the signs) 0.1%.
PS_STEP2_TOL = 0.05
# get_pushpull_speed() on the PS int8 API path, read just after each
# step's last synchronize, against the window modelled per exchange
# (``window_mbps``): the gradient bytes of the exchanges that started in
# the window's last 10 s over the time since the first of them, each by
# its own dispatch, as the telemetry back-dates it; a step whose
# exchanges straddle the window's edge counts in part. A window that
# loses or double-counts transfers, or reads seconds as milliseconds, is
# off by far more than 1.25.
SPEED_FACTOR = 1.25
# depth of the paths cut for the full run's time limit (of BERT-large's
# 24 layers, full width): the PS fp8 routes, the fp8 tree API, PS auto, the
# PS watchdog, int8 over TCP at world 1, the world-2 int8 arms (b0)/(b1)
# and the bounded-staleness arms (c0)-(c2), and the phases listed in the
# module docstring. Their host costs scale with the parameter bytes;
# every gate stays, its expected counts computed from the cut config, the
# losses held against a dense run at the same depth. The async PS phase
# (d0) and the membership phase run at full depth.
CUT_LAYERS = 6
README_COMPRESSION = {"compressor_type": "onebit",
                      "compressor_onebit_scaling": "true",
                      "ef_type": "vanilla", "momentum_type": "nesterov"}
# GPT-2 medium's compressed paths beyond the README's onebit: the other
# three compressors (k = 1% of a bucket for the sparsifiers, 4 linear
# levels under max normalization for dithering: int8 codes), and onebit
# over the reduce-scatter-shaped exchange
GPT2_COMPRESSION = {
    "topk": {"compressor_type": "topk", "compressor_k": "0.01",
             "ef_type": "vanilla"},
    "randomk": {"compressor_type": "randomk", "compressor_k": "0.01",
                "seed": "7", "ef_type": "vanilla"},
    "dithering": {"compressor_type": "dithering", "compressor_k": "4",
                  "seed": "7"},
    "onebit_rs": dict(README_COMPRESSION, exchange="rs"),
}
# |step-1 loss under attn_impl="hybrid" - the flash path's| (the same
# weights and batch; attention's forward computed two ways)
HYBRID_TOL = 2e-2
# hybrid_fwd against the forward kernel on the same card inputs at the
# hybrid paths' shapes: max |lse difference| over max |lse| (both fp32:
# the same max and sum in another order); out within one bf16 step at
# max |out| (each rounds its probabilities to bf16 at another point)
HYBRID_LSE_TOL = 1e-5
# ||step-1 gradients under hybrid - the flash path's|| / ||the flash
# path's|| over every parameter (fresh weights from seed 0, the path's
# batch), and the same ratio for the attention's own gradients (dq, dk, dv,
# dtable) at the paths' shapes, one set of inputs: each limit lies between
# the sound readings and the gated fault controls' (``HybridControl``).
# All are deterministic: a second flash run reads 0 and two calls read
# the same bits. Readings on an H100 80GB HBM3 at 700 W (PERF.md §6, PR
# 13): step-1 gradients BERT sound 1.357e-2, lse control 1.604e-2; T5
# sound 1.050e-2, no-bias control 1.838e-2; attention gradients BERT
# sound 8.3e-5, bf16 control 1.9e-3; T5 sound at most 2.55e-3, lse
# control at least 5.25e-3, no-bias at least 1.07
HYBRID_GRAD_TOL = 1.5e-2
HYBRID_OP_TOL = {"bert_large_hybrid": 5e-4, "t5_small_hybrid": 4e-3}
# each control, and the levels ("op": the attention's gradients, "grad":
# the step-1 gradients) where it must read above the limit; elsewhere it
# is printed only: TF32 is exact on bf16 operands, bf16 products and a
# one-step lse shift sit inside T5's split-route noise at those levels
HYBRID_CONTROLS = {
    "bert_large_hybrid": {"tf32": (), "bf16": ("op",), "lse": ("op", "grad")},
    "t5_small_hybrid": {"tf32": (), "bf16": (), "lse": ("op",),
                        "no_bias": ("op", "grad")}}
# examples/perf_lab.py's --remat arms of BERT-large beside whole-block
# remat (the bert_large path): (config change, forward launches a layer
# per step). dots recomputes the flash forward, which is no matmul
BERT_REMAT = {"bert_large_remat_none": ({"remat": False}, 1),
              "bert_large_dots": ({"remat_policy": "dots"}, 2),
              "bert_large_mlp_only": ({"remat_policy": "mlp_only"}, 1),
              "bert_large_save_attn": ({"remat_policy": "save_attn"}, 1)}
# |step-1 gradient norm under a policy - whole-block remat's| / the
# latter: a policy keeps or recomputes the same values
GRAD_NORM_TOL = 1e-6
# GPT-2 medium at examples/long_context_bench.py's long context: its 8192
# tokens a step round up to one sample of 32768, and past 16384 it
# chunks the head at 2048
LONG_SEQ, LONG_BATCH, LONG_CHUNK = 32768, 1, 2048
# |step-1 loss, full head - chunked head| / chunked: the same logits in
# chunks, their nll sums added in another order
LONG_HEAD_TOL = 1e-4
# the LM head's bf16 GEMM against the fp32 route on the same inputs:
# logits max err <= HEAD_LOGITS_TOL · max|ref| (the same exact products,
# fp32 sums in another order); dh and dE within REL_TOL (the cotangent
# rounded to bf16); GPT-2's step-1 loss through either route within
# HEAD_LOSS_TOL relative
HEAD_LOGITS_TOL = 1e-5
HEAD_LOSS_TOL = 1e-5
# ShardedTrainer's accumulation path: micro-steps a sync, micro-steps run
SP_ACCUM, SP_ACCUM_STEPS = 2, 4
# rounds of steps_in_turns: BERT's remat arms, GPT-2's two head routes
TURNS = 8
# the port's profiler ranges (``record_function``) whose device time
# phase 4 attributes: the hybrid route's plain forward, the compressed
# exchange, the LM head's GEMMs (forward and backward)
RANGES = ("bps::hybrid_fwd", "bps::compressed_reduce", "bps::lm_head")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def counters():
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops.compression import kernels as ob
    return {"flash_fwd": fa.flash_fwd, "flash_bwd_fused": fa.flash_bwd_fused,
            "flash_bwd_dq": fa.flash_bwd_dq, "flash_bwd_dkv": fa.flash_bwd_dkv,
            "onebit_pack": ob.onebit_pack, "onebit_unpack": ob.onebit_unpack,
            "int8_quantize": ob.int8_quantize,
            "int8_dequantize": ob.int8_dequantize,
            "fp8_sr_quantize": ob.fp8_sr_quantize}


def zero_counts(ctr):
    from byteps_tpu_torch.ops import flash_attention as fa
    for name, fn in ctr.items():
        if name in FLASH:
            fa.zero_counts(fn)
        else:
            fn.launches = 0


def read_counts(ctr):
    """{kernel: launches of every form and width}; for every flash kernel
    {"kernel:d64": .., "kernel:d128": ..}, for the flash kernels with
    bias forms {"kernel:bias": .., "kernel:rel": ..} and the same per
    width, {"kernel:bias:d64": .., ...}, and the ring's forms
    {"flash_fwd:f32": .., "flash_bwd_fused:delta": .., ...:d64, ...}."""
    counts = {name: fn.launches for name, fn in ctr.items()}
    for name in FLASH:
        for d in WIDTHS:
            counts[f"{name}:d{d}"] = ctr[name].launches_d[d]
    for name in FLASH_FORMS:
        fn = ctr[name]
        counts[f"{name}:bias"] = fn.launches_bias
        counts[f"{name}:rel"] = fn.launches_rel
        for d in WIDTHS:
            counts[f"{name}:bias:d{d}"] = fn.launches_bias_d[d]
            counts[f"{name}:rel:d{d}"] = fn.launches_rel_d[d]
    for name, var in VARIANTS:
        fn = ctr[name]
        counts[f"{name}:{var}"] = getattr(fn, f"launches_{var}")
        for d in WIDTHS:
            counts[f"{name}:{var}:d{d}"] = getattr(fn, f"launches_{var}_d")[d]
    return counts


def by_width(w, d):
    """The launch counts ``w`` of a path whose attention runs at head dim
    ``d``: every flash launch at that width, none at the other."""
    for name in FLASH:
        for width in WIDTHS:
            w[f"{name}:d{width}"] = w[name] if width == d else 0
    for name in FLASH_FORMS:
        for f in FORMS:
            for width in WIDTHS:
                w[f"{name}:{f}:d{width}"] = (w[f"{name}:{f}"] if width == d
                                             else 0)
    for name, var in VARIANTS:
        for width in WIDTHS:
            w[f"{name}:{var}:d{width}"] = (w[f"{name}:{var}"] if width == d
                                           else 0)
    return w


# ------------------------------------------------------------- phase 1

def toolchain():
    """Versions and the card; then every kernel (one nvcc each) and the
    parameter server's C++ engine (g++), all built at once."""
    import threading

    from byteps_tpu_torch.ops import _build, _build_host
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = _build.nvcc_path()
    log(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       check=True).stdout.strip().splitlines()[-1])
    log(f"card: {card_line()}")
    t0 = time.perf_counter()
    host_err = []

    def build_host():
        try:
            _build_host.build()
        except BaseException as e:   # noqa: BLE001 — re-raised below
            host_err.append(e)

    host = threading.Thread(target=build_host)
    host.start()
    _build.build_all()
    host.join()
    if host_err:
        raise host_err[0]
    _build_host.load()
    log(f"kernels and the server engine built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({', '.join(sorted(_build.SIGNATURES))}; "
        f"csrc/host/{_build_host.SOURCE.name})")
    rows = ptxas_table() + codec_table()
    tensor_map_us()
    return rows


_FORM_NAMES = ("none", "dense", "table")


def ptxas_table():
    """Every flash kernel instantiation: its registers, stack and spills
    (the ptxas -v log that each build keeps beside its library, a cached
    build's too), its dynamic shared memory (the library's own
    ``bps_flash_smem``) and how many wgmma (HGMMA), TMA tensor load
    (UTMALDG) and bulk copy (UBLKCP) instructions its SASS holds
    (``cuobjdump -sass``); printed and returned. Fails unless each one
    reached the tensor cores through wgmma, loads by TMA and spills
    nothing."""
    from byteps_tpu_torch.ops import _build
    stems = [s for s in sorted(_build.SIGNATURES) if s.startswith("flash_")]
    report = _build.ptxas_report(stems)
    sass = {(r["source"], r["kernel"], tuple(r["args"])): r
            for r in _build.sass_counts(stems)}
    rows, bad = [], []
    for r in report:
        a = r["args"]
        if r["kernel"] == "flash_fwd_kernel":
            d, form = a[0], a[1]
            what = "forward, fp32 out" if a[2] else "forward"
        elif r["kernel"] == "flash_bwd_dq_kernel":
            d, form = a[1], a[2]
            what = "dq (delta given)" if a[0] else "dq + delta (fused bwd)"
        else:
            d, form, what = a[0], a[1], "dk+dv"
        ops = sass.get((r["source"], r["kernel"], tuple(a)),
                       dict.fromkeys(_build.SASS_OPS, 0))
        row = {"source": f"csrc/{r['source']}.cu", "kernel": what, "d": d,
               "form": _FORM_NAMES[form], "registers": r["registers"],
               "stack": r.get("stack", 0),
               "spill_stores": r.get("spill_stores", 0),
               "spill_loads": r.get("spill_loads", 0),
               "smem": _build.smem_bytes(r["source"], r["kernel"], d, form),
               **{op.lower(): ops[op] for op in _build.SASS_OPS}}
        log(f"[ptxas] {row['source']:20s} {what:22s} d{d:<4d} "
            f"{row['form']:6s} {row['registers']:3d} registers, "
            f"stack {row['stack']} B, spill stores {row['spill_stores']} B, "
            f"loads {row['spill_loads']} B; {row['smem']} B dynamic shared "
            f"memory; SASS: {row['hgmma']} HGMMA, {row['utmaldg']} UTMALDG, "
            f"{row['ublkcp']} UBLKCP")
        if (not row["hgmma"] or not row["utmaldg"] or row["spill_stores"]
                or row["spill_loads"]):
            bad.append(f"{row['source']} {what} d{d} {row['form']}")
        rows.append(row)
    if not rows:
        raise AssertionError("ptxas reported no flash kernel")
    if bad:
        raise AssertionError(f"no wgmma or TMA in the SASS, or a spill: "
                             f"{bad}")
    return rows


# the codec kernels (csrc/<stem>.cu) and the 128-bit access (a SASS_OPS
# key) or bulk copy each one's design must hold, in every instance but the
# exempt ones, each with its reason (source, kernel, template arguments)
CODEC_STEMS = ("onebit_pack", "onebit_unpack", "int8_quantize",
               "int8_dequantize", "fp8_sr_quantize")
WIDE_ACCESS = {"int8_quantize": "LDG.E.128", "onebit_unpack": "STG.E.128",
               "onebit_pack": "LDG.E.128", "fp8_sr_quantize": "LDG.E.128",
               "int8_dequantize": "STG.E.128"}
WIDE_EXEMPT = {("onebit_pack", "onebit_pack_kernel", (0,)):
               "x a view at a 4-byte offset: word boundaries are fixed by "
               "x[0], so its float4s would straddle words; 4-byte loads"}


def codec_table():
    """Every codec kernel instance: registers, stack and spills (ptxas -v)
    and its count of 128-bit global loads and stores and bulk copies in
    the SASS; printed and returned. Fails on any spill, and unless each
    instance of a ``WIDE_ACCESS`` kernel holds its 128-bit access or a
    bulk copy (``WIDE_EXEMPT`` named in the report with its reason)."""
    from byteps_tpu_torch.ops import _build
    sass = {(r["source"], r["kernel"], tuple(r["args"])): r
            for r in _build.sass_counts(CODEC_STEMS)}
    rows, bad = [], []
    for r in _build.ptxas_report(CODEC_STEMS):
        ops = sass.get((r["source"], r["kernel"], tuple(r["args"])),
                       dict.fromkeys(_build.SASS_OPS, 0))
        row = {"source": f"csrc/{r['source']}.cu", "kernel": r["kernel"],
               "args": r["args"], "registers": r["registers"],
               "stack": r.get("stack", 0),
               "spill_stores": r.get("spill_stores", 0),
               "spill_loads": r.get("spill_loads", 0),
               **{op.lower(): ops[op] for op in _build.SASS_OPS}}
        log(f"[ptxas] {row['source']:26s} {r['kernel']}{r['args'] or ''}: "
            f"{row['registers']} registers, stack {row['stack']} B, spill "
            f"stores {row['spill_stores']} B, loads {row['spill_loads']} B; "
            f"SASS: {ops['LDG.E.128']} LDG.E.128, {ops['STG.E.128']} "
            f"STG.E.128, {ops['UBLKCP']} UBLKCP")
        wide = WIDE_ACCESS.get(r["source"])
        exempt = WIDE_EXEMPT.get((r["source"], r["kernel"],
                                  tuple(r["args"])))
        if wide and exempt:
            log(f"[ptxas] {row['source']:26s} {r['kernel']}{r['args']}: "
                f"exempt from the {wide} gate ({exempt})")
            wide = None
        if (row["spill_stores"] or row["spill_loads"]
                or (wide and not ops[wide] and not ops["UBLKCP"])):
            bad.append(f"{row['source']} {r['kernel']}{r['args']}")
        rows.append(row)
    missing = set(CODEC_STEMS) - {r["source"][5:-3] for r in rows}
    if missing:
        raise AssertionError(f"ptxas reported no kernel of {sorted(missing)}")
    if bad:
        raise AssertionError(f"a codec kernel spills, or lacks its 128-bit "
                             f"access or bulk copy: {bad}")
    return rows


def tensor_map_us():
    """Host microseconds of one TMA tensor map encode (a BERT-large
    operand's), the cost every flash launch pays per operand."""
    from byteps_tpu_torch.ops import _build
    base = torch.empty(16, dtype=torch.uint8, device="cuda")
    us = _build.tensor_map_us(base.data_ptr())
    log(f"[ptxas] tensor maps: {us:.3f} us per cuTensorMapEncodeTiled on "
        "the host")
    if not us > 0:
        raise AssertionError("the driver refused a BERT-large operand's "
                             "tensor map")
    return us


# ------------------------------------------------------------- phase 2

def _inputs(b, s, h, d, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g).to("cuda", torch.bfloat16)
            for _ in range(4)]


def _rel_err(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def _check(name, tag, got, ref, auto=None):
    """Hold one output against its plain version (and autograd of the
    plain forward); returns the max abs error against the plain one."""
    e, r = _rel_err(got, ref)
    msg = f"[check {tag}] {name} err {e:.3e} (rel {r:.2e})"
    ok = r <= REL_TOL
    if auto is not None:
        ea, ra = _rel_err(got, auto)
        msg += f"; vs autograd of the plain forward {ea:.3e} (rel {ra:.2e})"
        ok = ok and ra <= REL_TOL_AUTOGRAD
    log(msg)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{tag}")
    return e


def _check_fwd(fa, q, k, v, causal, tag, **kw):
    """The forward (``kw``: scale and a bias form) against its plain
    version; returns (out, lse, max abs err of out)."""
    out, lse = fa.flash_fwd(q, k, v, causal, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal, **kw)
    e_lse = (lse - ref_lse).abs().max().item()
    log(f"[check {tag}] lse err {e_lse:.3e}")
    if not e_lse <= LSE_TOL:
        raise AssertionError(f"flash_fwd lse disagrees at {tag}")
    return out, lse, _check("fwd out", tag, out, ref_out)


def _plain_autograd(fa, q, k, v, do, causal):
    qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_fwd_plain(qa, ka, va, causal)[0].backward(do)
    return qa.grad, ka.grad, va.grad


def check_bert_kernels(worst, h=HEADS, d=HEAD_DIM,
                       cases=((4, False), (4, True), (TRAIN_BATCH, False))):
    """The forward and the fused backward at BERT's seq 512 (``cases``:
    batch, causal), the backward also against autograd of the plain
    forward."""
    from byteps_tpu_torch.ops import flash_attention as fa
    for b, causal in cases:
        q, k, v, do = _inputs(b, BERT_SEQ, h, d, seed=b + causal)
        tag = f"b{b} s{BERT_SEQ} h{h} d{d} {'causal' if causal else 'full'}"
        _, lse, e = _check_fwd(fa, q, k, v, causal, tag)
        worst["flash_fwd"] = max(worst["flash_fwd"], e)
        got = fa.flash_bwd_fused(q, k, v, do, lse, causal)
        torch.cuda.synchronize()
        plain = fa.flash_bwd_fused_plain(q, k, v, do, lse, causal)
        auto = _plain_autograd(fa, q, k, v, do, causal)
        for g_, p_, a_, name in zip(got, plain, auto, ("dq", "dk", "dv")):
            worst["flash_bwd_fused"] = max(
                worst["flash_bwd_fused"],
                _check(f"fused bwd {name}", tag, g_, p_, a_))


def check_gpt2_kernels(worst, h=HEADS, d=HEAD_DIM):
    """Forward past one block, the split backward's dq and dk/dv kernels,
    and the split route of the autograd Function, at the GPT-2 context
    (s 1024, b 8)."""
    from byteps_tpu_torch.ops import flash_attention as fa
    b, s = TRAIN_BATCH, GPT2_SEQ
    if fa.backward_route(s, s) != "split":
        raise AssertionError(f"seq {s} should take the split backward")
    for causal in (True, False):
        q, k, v, do = _inputs(b, s, h, d, seed=20 + causal)
        tag = f"b{b} s{s} h{h} d{d} {'causal' if causal else 'full'}"
        out, lse, e = _check_fwd(fa, q, k, v, causal, tag)
        worst["flash_fwd"] = max(worst["flash_fwd"], e)
        delta = fa.bwd_delta(do, out)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], _check(
            "split dq", tag, dq,
            fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)))
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                causal)
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"],
                                     _check("split dk", tag, dk, ref_dk),
                                     _check("split dv", tag, dv, ref_dv))
        # the autograd Function at seq 1024 (default blocks): split route
        qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
        fa.flash_attention(qa, ka, va, causal=causal).backward(do)
        auto = _plain_autograd(fa, q, k, v, do, causal)
        for got, ref, name in zip((qa.grad, ka.grad, va.grad), auto, "qkv"):
            e, r = _rel_err(got, ref)
            log(f"[check {tag}] split route d{name} vs autograd of the plain "
                f"forward {e:.3e} (rel {r:.2e})")
            if not r <= REL_TOL_AUTOGRAD:
                raise AssertionError(f"split route d{name} disagrees at {tag}")
        del auto, qa, ka, va
        torch.cuda.empty_cache()


def _t5_inputs(b, s, seed, d=HEAD_DIM):
    """q, k, v, dO at a T5 shape (h 8, head dim d). q and k are drawn at
    std d^-1/4, so the scores at T5's scale 1.0 have unit variance, as at
    the other shapes' d^-1/2; the table is standard normal, [h, nb]
    fp32."""
    q, k, v, do = _inputs(b, s, T5_HEADS, d, seed)
    q, k = (t * d ** -0.25 for t in (q, k))
    table = torch.randn(T5_HEADS, T5_BUCKETS,
                        generator=torch.Generator().manual_seed(seed + 1))
    return q, k, v, do, table.cuda()


def _same(tag, pairs):
    same = {name: torch.equal(a, b) for name, a, b in pairs}
    log(f"[check {tag}] " + ", ".join(
        f"{k} {'bit-identical' if v else 'DIFFERS'}" for k, v in same.items()))
    if not all(same.values()):
        raise AssertionError(f"{tag}: not bit-identical")


def check_form(fa, worst, form, tag, q, k, v, do, causal, kw):
    """Forward, dq (with dbias or dtable) and dk/dv of one bias form
    against their plain versions; returns the kernels' outputs."""
    out, lse, e = _check_fwd(fa, q, k, v, causal, tag, scale=1.0, **kw)
    worst["flash_fwd", form] = max(worst["flash_fwd", form], e)
    delta = fa.bwd_delta(do, out)
    dq, dgrad = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, 1.0, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, 1.0, **kw)
    torch.cuda.synchronize()
    ref_dq, ref_grad = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                             causal, 1.0, **kw)
    gname = "dtable" if form == "rel" else "dbias"
    worst["flash_bwd_dq", form] = max(
        worst["flash_bwd_dq", form], _check("dq", tag, dq, ref_dq),
        _check(gname, tag, dgrad, ref_grad))
    del ref_dq, ref_grad
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                            1.0, **kw)
    worst["flash_bwd_dkv", form] = max(worst["flash_bwd_dkv", form],
                                       _check("dk", tag, dk, ref_dk),
                                       _check("dv", tag, dv, ref_dv))
    del ref_dk, ref_dv
    torch.cuda.empty_cache()
    return out, lse, dq, dgrad, dk, dv, delta


def check_cross(fa, worst, b, sq, sk, seed, d=HEAD_DIM):
    """The no-bias forward, dq and dk/dv at T5's cross-attention shape (the
    decoder's sq queries over the encoder's sk keys, not causal, scale
    1.0): out, lse, dq, dk and dv against their plain versions."""
    q, k, v, do = _inputs(b, sk, T5_HEADS, d, seed)
    q, do = q[:, :sq].contiguous(), do[:, :sq].contiguous()
    q, k = (t * d ** -0.25 for t in (q, k))
    tag = f"b{b} sq{sq} sk{sk} h{T5_HEADS} d{d} cross, no bias"
    out, lse, e = _check_fwd(fa, q, k, v, False, tag, scale=1.0)
    worst["flash_fwd"] = max(worst["flash_fwd"], e)
    delta = fa.bwd_delta(do, out)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, False, 1.0)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, False, 1.0)
    torch.cuda.synchronize()
    worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], _check(
        "split dq", tag, dq,
        fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, False, 1.0)))
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, False,
                                            1.0)
    worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"],
                                 _check("split dk", tag, dk, ref_dk),
                                 _check("split dv", tag, dv, ref_dv))
    del q, k, v, do, out, lse, delta, dq, dk, dv, ref_dk, ref_dv
    torch.cuda.empty_cache()


def check_t5_kernels(worst, d=HEAD_DIM):
    """The rel-table form at the encoder's and the decoder's self-attention
    shapes, the dense form at the encoder's with the materialized bias of
    the same table; the two forms bit for bit; dtable the same bits on a
    second launch; the no-bias kernels at the cross-attention shape. At
    T5's geometry (h 8, scale 1.0) with head dim d."""
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import relpos
    b = TRAIN_BATCH
    q, k, v, do, table = _t5_inputs(b, T5_SRC, seed=60, d=d)
    tag = f"b{b} s{T5_SRC} h{T5_HEADS} d{d} rel bidirectional"
    rel = {"rel_table": table, "rel_bidirectional": True}
    got_t = check_form(fa, worst, "rel", tag, q, k, v, do, False, rel)
    again = fa.flash_bwd_dq(q, k, v, do, got_t[1], got_t[6], False, 1.0,
                            **rel)
    torch.cuda.synchronize()
    _same(f"{tag} second dq launch", [("dq", got_t[2], again[0]),
                                      ("dtable", got_t[3], again[1])])
    dense = {"bias": relpos.relative_bias(table.T, T5_SRC, T5_SRC, True,
                                          T5_BUCKETS)}
    tag_d = f"b{b} s{T5_SRC} h{T5_HEADS} d{d} dense bias"
    got_d = check_form(fa, worst, "bias", tag_d, q, k, v, do, False, dense)
    _same("dense vs table forms, same bias values", [
        (n, a, c) for n, a, c in zip(("out", "lse", "dq"), got_t, got_d)] + [
        ("dk", got_t[4], got_d[4]), ("dv", got_t[5], got_d[5])])
    del got_t, got_d, again, dense
    torch.cuda.empty_cache()
    s = T5_TGT - 1
    q, k, v, do, table = _t5_inputs(b, s, seed=61, d=d)
    check_form(fa, worst, "rel", f"b{b} s{s} h{T5_HEADS} d{d} rel causal",
               q, k, v, do, True,
               {"rel_table": table, "rel_bidirectional": False})
    del q, k, v, do, table
    torch.cuda.empty_cache()
    check_cross(fa, worst, b, s, T5_SRC, seed=62, d=d)


def check_dh128_kernels(worst):
    """Every flash kernel form at head dim 128, against its plain version:
    the forward and the fused backward at the dh128 BERT shape (b 8, s
    512, h 8), full and causal; the forward, dq and dk/dv past one block
    (b 8, s 1024, h 8), causal and full; the table and dense forms, the
    cross shape and the causal table at T5's geometry."""
    check_bert_kernels(worst, DH128_HEADS, DH128,
                       cases=((TRAIN_BATCH, False), (TRAIN_BATCH, True)))
    check_gpt2_kernels(worst, DH128_HEADS, DH128)
    check_t5_kernels(worst, DH128)


def check_ring_forms(worst):
    """Forms 1f and 2d against their plain versions. 1f at the BERT and
    dh128 shapes, full and causal, and at b 8, s 1024, h 16 causal: out
    and lse, and the fp32 out rounded to bf16 (and lse) bit for bit the
    bf16 launch's. 2d at the BERT and dh128 shapes (one block), delta =
    rowsum(dO∘out): against the plain version and autograd of the plain
    forward, and bit for bit the split dq and dk/dv with that delta.
    ``worst`` is keyed by (form, head dim)."""
    from byteps_tpu_torch.ops import flash_attention as fa
    cases = [(BERT_SEQ, h, d, causal)
             for h, d in ((HEADS, HEAD_DIM), (DH128_HEADS, DH128))
             for causal in (False, True)] + [(GPT2_SEQ, HEADS, HEAD_DIM,
                                               True)]
    for s, h, d, causal in cases:
        b = TRAIN_BATCH
        q, k, v, do = _inputs(b, s, h, d, seed=70 + causal)
        tag = f"b{b} s{s} h{h} d{d} {'causal' if causal else 'full'}"
        out, lse, e = _check_fwd(fa, q, k, v, causal, f"{tag} fp32 out",
                                 out_dtype=torch.float32)
        if out.dtype != torch.float32:
            raise AssertionError(f"fp32 out came back {out.dtype} at {tag}")
        worst["fp32_out", d] = max(worst["fp32_out", d], e)
        out16, lse16 = fa.flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        _same(f"{tag} fp32 out rounded to bf16 vs the bf16 launch",
              [("out", out.to(torch.bfloat16), out16), ("lse", lse, lse16)])
        if s != BERT_SEQ:
            continue
        delta = fa.bwd_delta(do, out16)
        got = fa.flash_bwd_fused(q, k, v, do, lse16, causal, delta=delta)
        torch.cuda.synchronize()
        plain = fa.flash_bwd_fused_plain(q, k, v, do, lse16, causal,
                                         delta=delta)
        auto = _plain_autograd(fa, q, k, v, do, causal)
        for g_, p_, a_, name in zip(got, plain, auto, ("dq", "dk", "dv")):
            worst["delta", d] = max(worst["delta", d], _check(
                f"fused bwd, delta given, {name}", tag, g_, p_, a_))
        split = (fa.flash_bwd_dq(q, k, v, do, lse16, delta, causal),
                 *fa.flash_bwd_dkv(q, k, v, do, lse16, delta, causal))
        torch.cuda.synchronize()
        _same(f"{tag} fused bwd with delta vs split dq + dk/dv",
              [(n, a, c) for n, a, c in zip(("dq", "dk", "dv"), got, split)])
        del q, k, v, do, out, out16, got, plain, auto, split
        torch.cuda.empty_cache()


def check_ring_schedule():
    """The flash ring's schedule at sp 4 in one process
    (``ring_schedule``: every rank's blocks in the ring's order, the
    shards slices of one sequence) against attention over the whole
    sequence and its autograd, at h 16 d 64 and h 8 d 128, causal and
    full. Launch counts of the schedule: (rank + 1) forwards and fused
    backwards per rank causally, sp each without the mask."""
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.parallel import ring
    for h, d in ((HEADS, HEAD_DIM), (DH128_HEADS, DH128)):
        for causal in (True, False):
            q, k, v, do = _inputs(RING_BATCH, RING_SEQ, h, d,
                                  seed=80 + causal)
            tag = (f"ring sp {RING_SP}: b{RING_BATCH} s{RING_SEQ} h{h} d{d} "
                   f"{'causal' if causal else 'full'}")
            n0 = (fa.flash_fwd.launches_f32, fa.flash_bwd_fused.launches_delta)
            out, _, dq, dk, dv = ring.ring_schedule(q, k, v, do, RING_SP,
                                                    causal)
            torch.cuda.synchronize()
            blocks = (RING_SP * (RING_SP + 1) // 2 if causal
                      else RING_SP * RING_SP)
            n = (fa.flash_fwd.launches_f32 - n0[0],
                 fa.flash_bwd_fused.launches_delta - n0[1])
            log(f"[check {tag}] {n[0]} fp32-out forwards, {n[1]} fused "
                f"backwards with delta over the {RING_SP} ranks")
            if n != (blocks, blocks):
                raise AssertionError(f"{tag}: launches {n}, expected "
                                     f"{blocks} each")
            xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            ref = ring.local_attention(*xs, causal=causal)
            ref.backward(do)
            _check("out vs local_attention", tag, out, ref)
            for got, x, name in zip((dq, dk, dv), xs, "qkv"):
                e, r = _rel_err(got, x.grad)
                log(f"[check {tag}] d{name} vs autograd of local_attention "
                    f"{e:.3e} (rel {r:.2e})")
                if not r <= REL_TOL_AUTOGRAD:
                    raise AssertionError(f"{tag}: d{name} disagrees")
            del q, k, v, do, out, dq, dk, dv, xs, ref
            torch.cuda.empty_cache()


def _twice(tag, calls):
    """Launch each of ``calls`` ({name: fn}) twice on the same inputs;
    every output must be the same bits."""
    for name, fn in calls.items():
        first, second = fn(), fn()
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        _same(f"{tag} {name}, two launches",
              [(f"output {i}", a, b) for i, (a, b) in
               enumerate(zip(first, second))])


def check_determinism():
    """Each redesigned flash kernel, launched twice on the same inputs,
    gives the same bits (no atomics anywhere), at head dims 64 and 128:
    the forward (bf16 and fp32 out) and the fused backward (delta computed
    and given) at the BERT shape; dq and dk/dv past one block (b 8, s
    1024, causal); the forward, dq (with dbias or dtable) and dk/dv in
    the dense and table forms at T5's encoder shape."""
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import relpos
    f32 = torch.float32
    for h, d in ((HEADS, HEAD_DIM), (DH128_HEADS, DH128)):
        b, s = TRAIN_BATCH, BERT_SEQ
        q, k, v, do = _inputs(b, s, h, d, seed=41)
        out, lse = fa.flash_fwd(q, k, v)
        delta = fa.bwd_delta(do, out)
        _twice(f"b{b} s{s} h{h} d{d} full", {
            "forward": lambda: fa.flash_fwd(q, k, v),
            "forward, fp32 out": lambda: fa.flash_fwd(q, k, v,
                                                      out_dtype=f32),
            "fused backward": lambda: fa.flash_bwd_fused(q, k, v, do, lse),
            "fused backward, delta given": lambda: fa.flash_bwd_fused(
                q, k, v, do, lse, delta=delta)})
        s = GPT2_SEQ
        q, k, v, do = _inputs(b, s, h, d, seed=42)
        out, lse = fa.flash_fwd(q, k, v, True)
        delta = fa.bwd_delta(do, out)
        _twice(f"b{b} s{s} h{h} d{d} causal", {
            "dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
            "dk/dv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                              True)})
        s = T5_SRC
        q, k, v, do, table = _t5_inputs(b, s, seed=43, d=d)
        for form, kw in (
                ("table", {"rel_table": table}),
                ("dense", {"bias": relpos.relative_bias(
                    table.T, s, s, True, T5_BUCKETS)})):
            out, lse = fa.flash_fwd(q, k, v, False, 1.0, **kw)
            delta = fa.bwd_delta(do, out)
            _twice(f"b{b} s{s} h{T5_HEADS} d{d} {form}", {
                "forward": lambda: fa.flash_fwd(q, k, v, False, 1.0, **kw),
                "dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, False,
                                              1.0, **kw),
                "dk/dv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  False, 1.0, **kw)})
        del q, k, v, do, out, lse, delta, table
        torch.cuda.empty_cache()


def _adversarial():
    f = torch.finfo(torch.float32)
    head = torch.tensor([0.0, -0.0, float("nan"), -float("nan"), float("inf"),
                         -float("inf"), f.tiny / 4, -f.tiny / 4, f.tiny,
                         -f.tiny, 1.0, -1.0])
    tail = torch.randn(77 - head.numel(),
                       generator=torch.Generator().manual_seed(30))
    return torch.cat([head, tail])


def check_onebit(x, tag):
    """Pack and unpack of ``x`` through the kernels and their plain
    versions, bit for bit."""
    from byteps_tpu_torch.ops.compression import kernels as ob
    x = x.to("cuda", torch.float32).contiguous()
    words = ob.onebit_pack(x)
    signs = ob.onebit_unpack(words, x.numel())
    torch.cuda.synchronize()
    plain_words = ob.onebit_pack_plain(x)
    plain_signs = ob.onebit_unpack_plain(words, x.numel())
    same = (torch.equal(words, plain_words)
            and torch.equal(signs.view(torch.int32),
                            plain_signs.view(torch.int32)))
    log(f"[check onebit {tag}] {x.numel()} floats -> {words.numel()} words: "
        f"pack and unpack {'bit-identical' if same else 'DIFFER'} to their "
        f"plain versions")
    if not same:
        raise AssertionError(f"onebit kernels disagree with their plain "
                             f"versions on {tag}")


def _quant_vectors():
    """The device encode's probe vector, one full bucket and two odd
    sizes, each with its codec scale."""
    from byteps_tpu_torch.compress import device as cdev
    g = torch.Generator().manual_seed(32)
    yield "probe vector", torch.from_numpy(cdev.probe_vector())
    yield "bucket", torch.randn(BUCKET_FLOATS, generator=g) * 3
    for n in (1, 128 * 256 + 3):
        yield f"n {n}", torch.randn(n, generator=g) * 3


def check_quant():
    """int8 quantize / dequantize and fp8 SR (E4M3 and E5M2) against their
    plain versions on the card, bit for bit; then the device encode's
    payloads of the probe vector against the numpy codec, byte for
    byte."""
    from byteps_tpu_torch.compress import device as cdev
    from byteps_tpu_torch.ops.compression import fp8sr
    from byteps_tpu_torch.ops.compression import kernels as ob
    for tag, x in _quant_vectors():
        x = x.to("cuda")
        amax = x.abs().max().item()
        q = ob.int8_quantize(x, amax / 127)
        d, d2 = ob.int8_dequantize(q, amax / 127), ob.int8_dequantize(
            q, amax / 127)
        torch.cuda.synchronize()
        same = {"int8 quantize": torch.equal(
                    q, ob.int8_quantize_plain(x, amax / 127)),
                "int8 dequantize": _same_bits(
                    d, ob.int8_dequantize_plain(q, amax / 127)),
                "int8 dequantize relaunch": _same_bits(d, d2)}
        for kind, kname in ((fp8sr.E4M3, "e4m3"), (fp8sr.E5M2, "e5m2")):
            s = amax / fp8sr.fmt_max(kind)
            for seed in (0, 0xFFFFFFFF):
                f = ob.fp8_sr_quantize(x, s, seed, kind)
                torch.cuda.synchronize()
                same[f"fp8 {kname} seed {seed:#x}"] = torch.equal(
                    f, ob.fp8_sr_quantize_plain(x, s, seed, kind))
        log(f"[check quant {tag}] {x.numel()} floats: " + ", ".join(
            f"{k} {'bit-identical' if v else 'DIFFERS'}"
            for k, v in same.items()) + " to the plain versions")
        if not all(same.values()):
            raise AssertionError(f"a quantize kernel disagrees with its plain "
                                 f"version on {tag}")
    cdev.reset_probe()
    cdev._probe(torch.device("cuda"))        # raises on any byte mismatch
    log("[check quant probe vector] device-encode payloads (int8, fp8 e4m3, "
        "fp8 e5m2) byte-identical to the numpy codec's wire.encode")


def check_codec_views():
    """The five one-wave kernels on what their plans peel: int8 quantize,
    fp8 SR (E4M3) and onebit pack of ``x[k:]`` (a head of 4 - k elements
    before the first 16-byte vector, the codes then misaligned; pack's
    4-byte-load instance), onebit unpack of ``words[k:]`` (4-byte loads
    at any offset, a masked tail) and int8 dequantize of ``q[k:]`` (the
    byte-load instance for k > 0), k in 0..3, on one bucket and odd
    sizes; bit for bit their plain versions, and launched twice, the same
    bits."""
    from byteps_tpu_torch.ops.compression import fp8sr
    from byteps_tpu_torch.ops.compression import kernels as ob
    g = torch.Generator().manual_seed(34)
    for n in (BUCKET_FLOATS, 4_096_003, 1025):
        x = (torch.randn(n + 3, generator=g) * 3).cuda()
        s = x.abs().max().item() / 127
        sf = x.abs().max().item() / fp8sr.fmt_max(fp8sr.E4M3)
        words, q = ob.onebit_pack(x), ob.int8_quantize(x, s)
        for k in range(4):
            xk, wk, qk, m = x[k:], words[k:], q[k:], n - 32 * k
            runs = {
                "int8 quantize": (lambda: ob.int8_quantize(xk, s),
                                  lambda: ob.int8_quantize_plain(xk, s)),
                "fp8 quantize": (
                    lambda: ob.fp8_sr_quantize(xk, sf, 77, fp8sr.E4M3),
                    lambda: ob.fp8_sr_quantize_plain(xk, sf, 77,
                                                     fp8sr.E4M3)),
                "onebit pack": (lambda: ob.onebit_pack(xk),
                                lambda: ob.onebit_pack_plain(xk)),
                "onebit unpack": (lambda: ob.onebit_unpack(wk, m),
                                  lambda: ob.onebit_unpack_plain(wk, m)),
                "int8 dequantize": (lambda: ob.int8_dequantize(qk, s),
                                    lambda: ob.int8_dequantize_plain(qk, s))}
            same = {}
            for key, (kernel, plain) in runs.items():
                a, b = kernel(), kernel()
                torch.cuda.synchronize()
                same[key] = _same_bits(a, plain())
                same[f"{key} relaunch"] = _same_bits(a, b)
            log(f"[check codec views n {n} k {k}] int8 and fp8 quantize and "
                f"onebit pack of x[{k}:] ({xk.numel()} floats), onebit "
                f"unpack of words[{k}:] ({m} floats), int8 dequantize of "
                f"q[{k}:] ({qk.numel()} codes): " + ", ".join(
                    f"{key} {'bit-identical' if v else 'DIFFERS'}"
                    for key, v in same.items()))
            if not all(same.values()):
                raise AssertionError(f"a one-wave codec kernel disagrees with "
                                     f"its plain version or itself: n {n}, "
                                     f"view {k}")


def fp8_near_carry(n, s, seed, kind, rng):
    """n floats x whose quotients y = x / s land within one of a carry of
    the stochastic rounding's add: element i's low magnitude bits are
    2^base - (h_i & mask) + (-1, 0 or 1), h_i its noise, in the format's
    normal range below min(MAX, FLT_MAX / 4s); x is RN(y · s), moved by
    -1, 0 or 1 ulp. A quotient one ulp off then flips bytes that random
    vectors leave alone."""
    from byteps_tpu_torch.ops.compression import fp8sr
    mx, mant, base, emin, _, _ = fp8sr.fmt_params(kind)
    u32 = lambda v: np.asarray(v).astype(np.uint32)
    top_y = min(mx, float(np.finfo(np.float32).max) / float(s) / 4)
    e = rng.integers(emin, max(emin, 126 + int(np.floor(np.log2(top_y)))) + 1,
                     n)
    noise = fp8sr.mix32(np.arange(n, dtype=np.uint32), seed) & u32(
        (1 << base) - 1)
    low = (u32(1 << base) - noise + u32(rng.integers(-1, 2, n))) & u32(
        (1 << base) - 1)
    top = u32(rng.integers(0, 1 << mant, n))
    y = ((u32(e) << u32(23)) | (top << u32(base)) | low).view(np.float32)
    y = np.where(rng.integers(0, 2, n) == 1, -y, y)
    with np.errstate(over="ignore", under="ignore"):
        x = (y * np.float32(s)).astype(np.float32)
    step = rng.integers(-1, 2, n)
    inf = np.float32(np.inf)
    return np.where(step > 0, np.nextafter(x, inf),
                    np.where(step < 0, np.nextafter(x, -inf), x))


def fp8_guard_edges(s, kind):
    """x at the edges of the fp8 kernel's divide guard and rounding paths
    for scale s, each with its 3 neighbours on either side, both signs:
    the guard's bounds max(2^-100, 2^-99 s) and min(2^124 s, FLT_MAX),
    2^-100, x / s at the clip (MAX · s) and near fp32 overflow (FLT_MAX ·
    s), FLT_MAX, the formats' smallest normals and subnormal quanta times
    s, FLT_MIN and the least denormal; and ±0, ±inf."""
    from byteps_tpu_torch.ops.compression import fp8sr
    fmax, sd = float(np.finfo(np.float32).max), float(np.float32(s))
    out = [0.0, -0.0, np.inf, -np.inf]
    for b in (max(2.0 ** -100, sd * 2.0 ** -99), min(sd * 2.0 ** 124, fmax),
              2.0 ** -100, fp8sr.fmt_max(kind) * sd, fmax * sd, fmax,
              2.0 ** -6 * sd, 2.0 ** -14 * sd, 2.0 ** -9 * sd, 2.0 ** -16 * sd,
              2.0 ** -126, 2.0 ** -149):
        with np.errstate(over="ignore", under="ignore"):
            v = np.float32(b)
        if not np.isfinite(v) or v == 0:
            continue
        for toward in (np.float32(np.inf), np.float32(0)):
            w = v
            for _ in range(3):
                out += [w, -w]
                with np.errstate(over="ignore"):
                    w = np.nextafter(w, toward)
    return np.array(out, np.float32)


# the near-carry scales: a power of two, an all-ones significand, and two
# without a normal RN(1/s) (every element then takes the divide)
FP8_CARRY_SCALES = (2.0 ** -3, float(np.array([(122 << 23) | 0x7FFFFF],
                                              np.uint32).view(np.float32)[0]),
                    3e38, 1e-40)
# the guard-edge scales: those, and a plain one, tiny and huge ones
FP8_EDGE_SCALES = FP8_CARRY_SCALES + (1.0, 0.37, 2.0 ** -40, 2.0 ** 20, 1e-30)


def check_fp8_edges():
    """fp8 SR (both kinds, three seeds) on near-carry vectors at
    ``FP8_CARRY_SCALES`` (262,144 floats each) and on the guard's edges at
    ``FP8_EDGE_SCALES``, from x[0] and x[1:]: bit for bit its plain
    version, launched twice the same bits. These are the vectors where a
    quotient one ulp off changes bytes."""
    from byteps_tpu_torch.ops.compression import fp8sr
    from byteps_tpu_torch.ops.compression import kernels as ob
    rng = np.random.default_rng(37)
    checked = 0
    for kind in (fp8sr.E4M3, fp8sr.E5M2):
        for seed in (0, 0xFFFFFFFF, 1234):
            vectors = [(f"near-carry s {s:g}", s,
                        fp8_near_carry(1 << 18, s, seed, kind, rng))
                       for s in FP8_CARRY_SCALES]
            vectors += [(f"guard edges s {s:g}", s,
                         np.tile(fp8_guard_edges(s, kind), 3))
                        for s in FP8_EDGE_SCALES]
            for tag, s, xn in vectors:
                for k in (0, 1):
                    # designed for the indices of the view x[k:]
                    x = torch.from_numpy(np.concatenate(
                        [np.zeros(k, np.float32), xn])).cuda()[k:]
                    a = ob.fp8_sr_quantize(x, s, seed, kind)
                    b = ob.fp8_sr_quantize(x, s, seed, kind)
                    torch.cuda.synchronize()
                    ref = ob.fp8_sr_quantize_plain(x, s, seed, kind)
                    if not (torch.equal(a, ref) and torch.equal(a, b)):
                        bad = int((a != ref).sum().item())
                        raise AssertionError(
                            f"fp8 SR kind {kind} seed {seed:#x} {tag} view "
                            f"{k}: {bad} of {x.numel()} bytes differ from "
                            f"the plain version, or a relaunch differs")
                    checked += x.numel()
    log(f"[check fp8 edges] near-carry vectors at scales "
        f"{FP8_CARRY_SCALES} and the divide guard's edges at "
        f"{FP8_EDGE_SCALES}, E4M3 and E5M2, seeds 0, 0xffffffff, 1234, "
        f"views x[0:] and x[1:] ({checked} floats): bit-identical to the "
        "plain version, relaunches the same bits")


# ------------------------------------------------------------- phase 3

def time_ms(fn, n=30, flush=None):
    """Median over n launches of fn, each timed with CUDA events, with the
    L2 cache flushed before each launch (outside the timed span). Before
    the start event the device spins for about a millisecond, so that fn
    is enqueued while it is still busy: the events then bracket device
    time only, not the host's time to reach the launch (tens of
    microseconds, which would swamp a kernel of a few)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def attention_bounds(b, s, h, d, causal):
    """Least time (ms) the card could take: max(FLOPs / peak, bytes /
    rate), each input read once and each output written once. Causal
    counts only the unmasked (q, k) pairs this data needs. Per pair: the
    forward 2 products (S, P·V), the fused backward 5 (S, dP, dV, dQ,
    dK), dq 3 (S, dP, dQ), dk/dv 4 (S, dP, dV, dK); 2·d FLOPs each."""
    pairs = s * (s + 1) / 2 if causal else s * s
    row = b * s * h * d * 2                       # one [b, s, h, d] bf16
    vec = b * h * s * 4                           # lse or delta, fp32
    per = 2 * b * h * d * pairs                   # one product's FLOPs
    return {
        "flash_fwd": _bound(2 * per, 4 * row + vec),       # qkv -> out, lse
        "flash_bwd_fused": _bound(5 * per, 7 * row + vec),  # +dO, lse -> dqkv
        "flash_bwd_dq": _bound(3 * per, 5 * row + 2 * vec),
        "flash_bwd_dkv": _bound(4 * per, 6 * row + 2 * vec),
    }


def onebit_bounds(n):
    """Bytes: the floats and the words, each read or written once. The
    operations (one compare per float to pack, a shift, mask and
    multiply-add per float to unpack) are fp32/int work on the CUDA
    cores, counted against the fp32 peak."""
    words = (n + 31) // 32
    return {"onebit_pack": _bound(n, 4 * n + 4 * words, PEAK_FP32_FLOPS),
            "onebit_unpack": _bound(3 * n, 4 * words + 4 * n,
                                    PEAK_FP32_FLOPS)}


def _log_time(name, shape, r):
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    design = ("" if "design_bytes" not in r else
              f"; the design moves {r['design_bytes'] / 1e6:.2f} MB")
    log(f"[time {name} {shape}] kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} "
        f"ms ({r['bound_by']}: {r['flops'] / 1e9:.3f} G ops, "
        f"{r['bytes'] / 1e6:.2f} MB{design}); kernel at "
        f"{r['bound_ms'] / r['ms']:.1%} of the bound")


def library_attention_ms(q, k, v, do, causal, flush, mask=None, scale=None):
    """Yardstick only: the library's fused attention on the same inputs
    ([b, h, s, d] views), forward and backward (autograd.grad on a retained
    graph: dq, dk and dv together, the yardstick of the fused backward and
    of the dq + dk/dv pair). A float ``mask`` replaces ``is_causal``."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    kw = ({"is_causal": causal} if mask is None else {"attn_mask": mask})
    if scale is not None:
        kw["scale"] = scale
    fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                  flush=flush)
    o = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    dot = do.transpose(1, 2)
    bwd = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                              retain_graph=True), flush=flush)
    return fwd, bwd


def time_kernels(calls, bounds, lib, label, shape, flush):
    """Each of ``calls`` ({name: (kernel, plain)}) timed beside its bound
    and the library's forward or backward time ``lib``."""
    res = {}
    for name, (kernel, plain) in calls.items():
        r = {"ms": time_ms(kernel, flush=flush),
             "plain_ms": time_ms(plain, n=10, flush=flush),
             "library_ms": lib[0] if name == "flash_fwd" else lib[1]}
        r.update(shape)
        r.update(bounds[name])
        b, s, h, d = shape["timed_shape"]
        _log_time(f"{name}{label}", f"b{b} s{s} h{h} d{d} "
                  f"{'causal' if shape['causal'] else 'full'}", r)
        res[name] = r
    return res


def time_attention(b, s, causal, names, h=HEADS, d=HEAD_DIM):
    """Kernels, plain versions and the library's attention at one shape."""
    from byteps_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _inputs(b, s, h, d, seed=99)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.bwd_delta(do, out)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                      lambda: fa.flash_fwd_plain(q, k, v, causal)),
        "flash_bwd_fused": (
            lambda: fa.flash_bwd_fused(q, k, v, do, lse, causal),
            lambda: fa.flash_bwd_fused_plain(q, k, v, do, lse, causal)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)),
    }
    lib = library_attention_ms(q, k, v, do, causal, flush)
    res = time_kernels({n: calls[n] for n in names},
                       attention_bounds(b, s, h, d, causal), lib, "",
                       {"timed_shape": [b, s, h, d], "causal": causal},
                       flush)
    del flush
    torch.cuda.empty_cache()
    return res


def form_bounds(b, s, h, d, causal, form):
    """``attention_bounds`` plus what the function of a bias form must
    move: the dense bias reads h·sq·sk fp32 in each kernel and its dq
    writes dbias, h·sq·sk fp32; the table form reads the [h, nb] table and
    its dq writes dtable, [h, nb] fp32. The dense dq's design moves more
    than its function: it writes dS per batch, b·h·sq·sk fp32, and
    ``torch.sum`` reads that back to write dbias (``design_bytes``). So
    does the table form's: it reads the sq + sk - 1 bucket vector and
    writes [b, h, sq / 64, nb] partials, summed the same way."""
    base = attention_bounds(b, s, h, d, causal)
    if form == "bias":
        extra = dict.fromkeys(FLASH_FORMS, 4 * h * s * s)
        extra["flash_bwd_dq"] += 4 * h * s * s
        design = 4 * h * s * s + 2 * 4 * b * h * s * s + 4 * h * s * s
    else:
        extra = dict.fromkeys(FLASH_FORMS, 4 * h * T5_BUCKETS)
        extra["flash_bwd_dq"] += 4 * h * T5_BUCKETS
        partials = 4 * b * h * (s // 64) * T5_BUCKETS
        design = 2 * 4 * h * T5_BUCKETS + 4 * (2 * s - 1) + 2 * partials
    res = {n: _bound(base[n]["flops"], base[n]["bytes"] + extra[n])
           for n in FLASH_FORMS}
    dq = res["flash_bwd_dq"]
    dq["design_bytes"] = base["flash_bwd_dq"]["bytes"] + design
    return res


def time_forms(b, s, causal, form, d=HEAD_DIM):
    """The forward, dq and dk/dv kernels in one bias form at a T5 shape
    (h 8, head dim d), their plain versions, and the library's attention
    with the materialized bias as its float ``attn_mask`` (built before
    the timed window; forward, and the backward for dq, dk and dv
    together)."""
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import relpos
    h = T5_HEADS
    q, k, v, do, table = _t5_inputs(b, s, seed=98, d=d)
    if form == "rel":
        kw = {"rel_table": table, "rel_bidirectional": not causal}
    else:
        kw = {"bias": relpos.relative_bias(table.T, s, s, True, T5_BUCKETS)}
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out, lse = fa.flash_fwd(q, k, v, causal, 1.0, **kw)
    delta = fa.bwd_delta(do, out)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal, 1.0, **kw),
                      lambda: fa.flash_fwd_plain(q, k, v, causal, 1.0, **kw)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, 1.0,
                                    **kw),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                          1.0, **kw)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, 1.0,
                                     **kw),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                           1.0, **kw)),
    }
    # yardstick only: the library's attention, [b, h, s, d] views, the
    # bias as a float mask (causal folded in as -inf above the diagonal)
    mask = relpos.relative_bias(table.T, s, s, not causal, T5_BUCKETS)
    if causal:
        mask = mask.masked_fill(~torch.ones(s, s, dtype=torch.bool,
                                            device="cuda").tril(),
                                float("-inf"))
    lib = library_attention_ms(q, k, v, do, causal, flush,
                               mask=mask[None].to(torch.bfloat16), scale=1.0)
    res = time_kernels(calls, form_bounds(b, s, h, d, causal, form), lib,
                       f" {form}",
                       {"timed_shape": [b, s, h, d], "causal": causal},
                       flush)
    del flush, mask
    torch.cuda.empty_cache()
    return res


def time_floor():
    """The timing harness's floor: an almost empty launch
    (``torch.cuda._sleep(0)``) timed by ``time_ms``'s events, flush and
    spin. Printed beside the codec kernels, whose times are little more
    than it."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: torch.cuda._sleep(0), flush=flush)
    log(f"[time floor] an empty launch (torch.cuda._sleep(0)): {ms:.4f} ms")
    return ms


def _log_4x(name, kernel, bound, flush):
    """Print (only) a codec kernel's time on four buckets at once."""
    ms = time_ms(kernel, flush=flush)
    log(f"[time {name} n {4 * BUCKET_FLOATS}] kernel {ms:.4f} ms, bound "
        f"{bound['bound_ms']:.4f} ms; kernel at {bound['bound_ms'] / ms:.1%} "
        f"of the bound")


def _time_view(name, what, kernel, bound, flush):
    """A codec kernel's instance for a view at an offset the aligned one
    does not take, timed on one bucket and printed; returned for the
    kernel line's ``view``."""
    ms = time_ms(kernel, flush=flush)
    log(f"[time {name} {what}] kernel {ms:.4f} ms, bound "
        f"{bound['bound_ms']:.4f} ms; kernel at {bound['bound_ms'] / ms:.1%} "
        f"of the bound")
    return {"input": what, "ms": ms, "bound_ms": bound["bound_ms"]}


def time_onebit(n=BUCKET_FLOATS):
    """Pack and unpack of one default-sized bucket (no single PyTorch call
    computes either: library "none"); each kernel also at four buckets,
    printed only; pack also of a view ``x[1:]``, its 4-byte-load
    instance."""
    from byteps_tpu_torch.ops.compression import kernels as ob
    x = torch.randn(n, generator=torch.Generator().manual_seed(31)).cuda()
    x4 = torch.randn(4 * n, generator=torch.Generator().manual_seed(35)).cuda()
    x1 = torch.randn(n + 1, generator=torch.Generator().manual_seed(37)
                     ).cuda()[1:]
    words, words4 = ob.onebit_pack(x), ob.onebit_pack(x4)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    bd, bd4 = onebit_bounds(n), onebit_bounds(4 * n)
    res = {}
    for name, kernel, plain, kernel4 in (
            ("onebit_pack", lambda: ob.onebit_pack(x),
             lambda: ob.onebit_pack_plain(x), lambda: ob.onebit_pack(x4)),
            ("onebit_unpack", lambda: ob.onebit_unpack(words, n),
             lambda: ob.onebit_unpack_plain(words, n),
             lambda: ob.onebit_unpack(words4, 4 * n))):
        r = {"ms": time_ms(kernel, flush=flush),
             "plain_ms": time_ms(plain, n=10, flush=flush),
             "library_ms": None, "timed_shape": [n]}
        r.update(bd[name])
        _log_time(name, f"n {n}", r)
        _log_4x(name, kernel4, bd4[name], flush)
        res[name] = r
    addr = x1.data_ptr() % ob.VEC_BYTES
    if not addr:
        raise AssertionError("x[1:] is 16-byte aligned: no 4-byte instance")
    grid = ob.pack_plan(n, addr, ob._sms(x1.device)).grid
    res["onebit_pack"]["view"] = _time_view(
        "onebit_pack", f"x[1:] n {n} (4-byte-load instance, {grid} CTAs)",
        lambda: ob.onebit_pack(x1), bd["onebit_pack"], flush)
    return res


# fp8 SR's 32-bit integer operations per element that the function needs
# for a quotient in the format's normal range or zero, as this run's data
# is (a gaussian bucket over amax / 448: about 1e-4 of its elements fall
# below the smallest normal, whose few more operations move nothing): the
# hash 10 (the index's multiply, the xor with the seed, three xor-shifts
# of two, two multiplies) and the normal-range code 8 (the magnitude's and
# the noise's masks, their add, the cut, the rebias, the clamp at zero, the
# sign's shift and its and-or). The float clip and the byte packing are
# left out.
FP8_INT_OPS = 10 + 8


def quant_bounds(n):
    """Bytes: the floats and the codes, each read or written once (the
    scale and seed are passed by value). Operations on the CUDA cores:
    int8 quantize a divide, a round and two clamps per float and
    dequantize a convert and a multiply, both counted against the fp32
    peak; fp8 SR the ``FP8_INT_OPS`` integer operations per float of its
    normal-range path against ``PEAK_INT32_OPS``, its float operations
    (the divide, the clip) left out, which keeps the bound a bound. All
    three are bound by their bytes."""
    return {"int8_quantize": _bound(4 * n, 4 * n + n, PEAK_FP32_FLOPS),
            "int8_dequantize": _bound(2 * n, n + 4 * n, PEAK_FP32_FLOPS),
            "fp8_sr_quantize": _bound(FP8_INT_OPS * n, 4 * n + n,
                                      PEAK_INT32_OPS)}


def _library_dequantize(q, s8, want):
    """The library yardstick of int8 dequantize: one ``torch.mul`` of the
    int8 codes by the scale as a 0-dim f32 tensor on the card, which
    promotes to f32 and rounds one multiply. It stands only where it is
    bit-identical to the kernel's output ``want``."""
    from byteps_tpu_torch.ops.compression import kernels as ob
    s_t = ob._scale_on(s8, q.device)
    got = torch.mul(q, s_t)
    same = got.dtype == want.dtype and torch.equal(
        got.view(torch.int32), want.view(torch.int32))
    log(f"[check int8_dequantize library] torch.mul(int8 codes, f32 scale) "
        f"{'bit-identical to' if same else 'DIFFERS from'} the kernel's output")
    return (lambda: torch.mul(q, s_t)) if same else None


def time_quant(n=BUCKET_FLOATS):
    """int8 quantize, dequantize and fp8 E4M3 SR of one default-sized
    bucket at its codec scale. Dequantize has a single PyTorch call
    computing the same function (``torch.mul`` by a 0-dim f32 scale); the
    other two are timed beside the single call nearest to them, which
    counts as their library call only where it gives the kernel's bytes
    on this bucket. Each kernel also at four buckets, printed only;
    dequantize also of a view ``q[1:]``, its byte-load instance."""
    from byteps_tpu_torch.ops.compression import fp8sr
    from byteps_tpu_torch.ops.compression import kernels as ob
    x = torch.randn(n, generator=torch.Generator().manual_seed(33)).cuda()
    x4 = torch.randn(4 * n, generator=torch.Generator().manual_seed(36)).cuda()
    amax = x.abs().max().item()
    s8, sf = amax / 127, amax / fp8sr.fmt_max(fp8sr.E4M3)
    q, q4 = ob.int8_quantize(x, s8), ob.int8_quantize(x4, s8)
    q1 = torch.empty(n + 1, dtype=torch.int8, device="cuda")[1:]
    q1.copy_(q)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    bd, bd4 = quant_bounds(n), quant_bounds(4 * n)
    at_4x = {"int8_quantize": lambda: ob.int8_quantize(x4, s8),
             "int8_dequantize": lambda: ob.int8_dequantize(q4, s8),
             "fp8_sr_quantize": lambda: ob.fp8_sr_quantize(x4, sf, 1234,
                                                           fp8sr.E4M3)}
    library = {"int8_dequantize": _library_dequantize(
        q, s8, ob.int8_dequantize(q, s8))}
    # the single calls nearest to the other two, timed beside them and held
    # against the kernel's bytes (``considered`` in the kernel line): the
    # library time where they give the kernel's bytes on this bucket.
    # quantize_per_tensor multiplies by 1/s where the codec divides by s,
    # which can move a code at a rounding boundary; the fp8 cast rounds to
    # nearest, not stochastically.
    e4m3 = ob.fp8_sr_quantize(x, sf, 1234, fp8sr.E4M3)
    considered = {
        "int8_quantize": (
            "torch.quantize_per_tensor(x, s, 0, torch.qint8)",
            lambda: torch.quantize_per_tensor(x, s8, 0, torch.qint8),
            lambda out: out.int_repr().view(torch.uint8),
            q.view(torch.uint8)),
        "fp8_sr_quantize": (
            "torch.Tensor.to(torch.float8_e4m3fn) of x / s",
            lambda: (x / sf).to(torch.float8_e4m3fn),
            lambda out: out.view(torch.uint8),
            e4m3.view(torch.uint8))}
    res = {}
    for name, kernel, plain in (
            ("int8_quantize", lambda: ob.int8_quantize(x, s8),
             lambda: ob.int8_quantize_plain(x, s8)),
            ("int8_dequantize", lambda: ob.int8_dequantize(q, s8),
             lambda: ob.int8_dequantize_plain(q, s8)),
            ("fp8_sr_quantize",
             lambda: ob.fp8_sr_quantize(x, sf, 1234, fp8sr.E4M3),
             lambda: ob.fp8_sr_quantize_plain(x, sf, 1234, fp8sr.E4M3))):
        lib = library.get(name)
        r = {"ms": time_ms(kernel, flush=flush),
             "plain_ms": time_ms(plain, n=10, flush=flush),
             "library_ms": None if lib is None else time_ms(lib, flush=flush),
             "timed_shape": [n]}
        r.update(bd[name])
        _log_time(name, f"n {n}", r)
        _log_4x(name, at_4x[name], bd4[name], flush)
        if name in considered:
            call, fn, as_bytes, want = considered[name]
            differ = int((as_bytes(fn()) != want).sum().item())
            r["considered"] = {"call": call,
                               "ms": time_ms(fn, flush=flush),
                               "bytes_differ": differ, "of": n}
            if differ == 0:
                r["library_ms"] = r["considered"]["ms"]
            log(f"[time {name} n {n}] considered {call}: "
                f"{r['considered']['ms']:.4f} ms; {differ} of {n} bytes "
                "differ from the kernel's: " + (
                    "the same bytes on this bucket, its library time"
                    if differ == 0 else "not the same function"))
        res[name] = r
    if ob.dequantize_reads_words(q1.data_ptr()):
        raise AssertionError("q[1:] is 4-byte aligned: no byte-load instance")
    res["int8_dequantize"]["view"] = _time_view(
        "int8_dequantize", f"q[1:] n {n} (byte-load instance)",
        lambda: ob.int8_dequantize(q1, s8), bd["int8_dequantize"], flush)
    return res


def ring_form_bounds(b, s, h, d, causal):
    """The bounds of the ring's forms: the forward's FLOPs with out
    written in fp32 (4 bytes an element); the fused backward's FLOPs with
    delta read beside lse."""
    base = attention_bounds(b, s, h, d, causal)
    row = b * s * h * d * 2
    vec = b * h * s * 4
    return {"fp32_out": _bound(base["flash_fwd"]["flops"],
                               3 * row + 2 * row + vec),
            "delta": _bound(base["flash_bwd_fused"]["flops"],
                            7 * row + 2 * vec)}


def time_ring_forms(h=HEADS, d=HEAD_DIM):
    """Forms 1f and 2d at the BERT shape (b 8, s 512, full; h 16 d 64 or
    h 8 d 128), their plain versions, and the library's forward (which
    writes bf16) and backward."""
    from byteps_tpu_torch.ops import flash_attention as fa
    b, s = TRAIN_BATCH, BERT_SEQ
    q, k, v, do = _inputs(b, s, h, d, seed=97)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out, lse = fa.flash_fwd(q, k, v, False)
    delta = fa.bwd_delta(do, out)
    f32 = torch.float32
    lib = library_attention_ms(q, k, v, do, False, flush)
    bounds = ring_form_bounds(b, s, h, d, False)
    res = {}
    for name, kernel, plain, lib_ms in (
            ("fp32_out", lambda: fa.flash_fwd(q, k, v, False, out_dtype=f32),
             lambda: fa.flash_fwd_plain(q, k, v, False, out_dtype=f32),
             lib[0]),
            ("delta",
             lambda: fa.flash_bwd_fused(q, k, v, do, lse, False, delta=delta),
             lambda: fa.flash_bwd_fused_plain(q, k, v, do, lse, False,
                                              delta=delta),
             lib[1])):
        r = {"ms": time_ms(kernel, flush=flush),
             "plain_ms": time_ms(plain, n=10, flush=flush),
             "library_ms": lib_ms, "timed_shape": [b, s, h, d],
             "causal": False}
        r.update(bounds[name])
        _log_time(name, f"b{b} s{s} h{h} d{d} full", r)
        res[name] = r
    del flush
    torch.cuda.empty_cache()
    return res


def host_us(fn, n=50, repeats=5):
    """Host microseconds per call of the wrapper ``fn`` (its checks,
    allocations, tensor maps and launches): ``n`` calls enqueued back to
    back while the card spins ahead of them, so that no call waits for
    the device; the least mean of ``repeats`` such runs (the host is
    shared, and other work only ever adds to a run)."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(repeats):
        torch.cuda._sleep(SPIN_CYCLES * 100)    # about 100 ms of device time
        t = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t) / n * 1e6)
        torch.cuda.synchronize()
    return best


def time_host(h=HEADS, d=HEAD_DIM):
    """Host microseconds per call of each flash wrapper at the BERT shape
    (b 8, s 512, full, h heads of d): the cost a host-bound step pays per
    launch, tensor map encoding included; and of the autograd Function's
    forward (``flash_attention``: the checks and the route before the
    wrapper)."""
    from byteps_tpu_torch.ops import flash_attention as fa
    b, s = TRAIN_BATCH, BERT_SEQ
    q, k, v, do = _inputs(b, s, h, d, seed=99)
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.bwd_delta(do, out)
    res = {name: host_us(fn) for name, fn in (
        ("flash_fwd", lambda: fa.flash_fwd(q, k, v)),
        ("flash_bwd_fused", lambda: fa.flash_bwd_fused(q, k, v, do, lse)),
        ("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta)),
        ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                   delta)),
        ("flash_attention", lambda: fa.flash_attention(q, k, v)))}
    log(f"[host b{b} s{s} h{h} d{d}] us per wrapper call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in res.items()))
    return res


def host_us_ab(parent) -> int:
    """``--host-us PARENT``: host microseconds per call of the four flash
    wrappers at both widths, launching in turns the kernels of this
    checkout and those of the checkout at PARENT (its ``csrc`` flash
    sources built here with the same flags; the C entry points take the
    same arguments), in one process: five rounds of parent, change,
    change, parent. The Python wrappers are this checkout's on both
    sides, so the difference is the entry points' own host cost, tensor
    map encoding included. Prints the least and the median per side as
    one JSON line."""
    from byteps_tpu_torch.ops import _build
    from byteps_tpu_torch.ops import flash_attention as fa
    stems = ("flash_fwd", "flash_bwd", "flash_dq", "flash_dkv")
    src = Path(parent).resolve() / "byteps_tpu_torch" / "csrc"
    out = Path(parent).resolve() / "byteps_tpu_torch" / "_build_host_us"
    out.mkdir(parents=True, exist_ok=True)
    procs = [(stem, subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(out / f"lib{stem}.so"), str(src / f"{stem}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for stem in stems]
    sides = {"parent": {}, "change": {}}
    for stem, proc in procs:
        log_text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src / stem}.cu:\n{log_text}")
        name, argtypes = _build.SIGNATURES[stem]
        fn = getattr(ctypes.CDLL(str(out / f"lib{stem}.so")), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        sides["parent"][stem] = fn
        sides["change"][stem] = _build.entry(stem)
    entry = fa.entry
    runs = {side: {d: {} for d in WIDTHS} for side in sides}
    try:
        for _ in range(5):
            for side in ("parent", "change", "change", "parent"):
                fa.entry = sides[side].__getitem__
                for h, d in ((HEADS, HEAD_DIM), (DH128_HEADS, DH128)):
                    for name, us in time_host(h, d).items():
                        runs[side][d].setdefault(name, []).append(us)
    finally:
        fa.entry = entry
    res = {side: {d: {name: {"least": min(v), "median": statistics.median(v)}
                      for name, v in by_d.items()}
                  for d, by_d in per_d.items()}
           for side, per_d in runs.items()}
    print(json.dumps({"host_us": res, "parent": str(parent)}))
    print(card_line())
    return 0


# the codec entry points before the launch plan, as ``_build.SIGNATURES``
# had them: bps_int8_quantize (x, q, n, scale, stream), bps_onebit_unpack
# (words, out, n, stream), bps_onebit_pack (x, words, n, stream),
# bps_fp8_sr_quantize (x, q, n, scale, seed, kind, stream),
# bps_int8_dequantize (q, out, n, scale, stream)
_P, _L, _F, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, \
    ctypes.c_int
BEFORE_PLAN = {"int8_quantize": ("bps_int8_quantize", [_P, _P, _L, _F, _P]),
               "onebit_unpack": ("bps_onebit_unpack", [_P, _P, _L, _P]),
               "onebit_pack": ("bps_onebit_pack", [_P, _P, _L, _P]),
               "fp8_sr_quantize": ("bps_fp8_sr_quantize",
                                   [_P, _P, _L, _F, ctypes.c_uint, _I, _P]),
               "int8_dequantize": ("bps_int8_dequantize",
                                   [_P, _P, _L, _F, _P])}
# the plan constant of each planned codec kernel in ops/compression/
# kernels.py (float4s a thread), read from each side's own checkout
PLAN_VECS = {"int8_quantize": "QUANT_VECS", "onebit_unpack": "UNPACK_VECS",
             "onebit_pack": "PACK_VECS", "fp8_sr_quantize": "FP8_VECS",
             "int8_dequantize": "DEQUANT_VECS"}
# the planned entries that take no head: their vectors are the output's
NO_HEAD = ("onebit_unpack", "int8_dequantize")
CODEC_AB_STEMS = ("onebit_pack", "fp8_sr_quantize")


def _plan_vecs(root, stem, default):
    """The float4s a thread of ``stem`` in the checkout at ``root``, as
    its kernels.py states them (``default`` where it states none)."""
    src = (root / "byteps_tpu_torch" / "ops" / "compression"
           / "kernels.py").read_text()
    m = re.search(rf"^{PLAN_VECS[stem]} = (\d+)", src, re.M)
    return int(m.group(1)) if m else default


def common_path(sass: str) -> dict:
    """Per kernel instance in the SASS listing ``sass``: the instructions
    a thread runs on its common path through one pass of the main loop
    (from the target of the last backward branch to that branch), or from
    the entry to EXIT where there is no loop. The walk falls through a
    conditional forward branch, and takes it where the block it skips
    holds a call (the correctly rounded divide's slow path), a ``MUFU``
    or an ``I2F`` (the fp8 contract's rare arithmetic), and takes every
    unconditional one. The rule fits the quantize kernels, whose rare
    paths are those."""
    from byteps_tpu_torch.ops import _build
    out = {}
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        kernel = _build._kernel_of(fn.split("\n")[0])
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        if not kernel or not ins:
            continue
        at = {a: i for i, (a, _) in enumerate(ins)}
        target = lambda t: (int(m.group(1), 16) if (m := re.search(
            r"BRA\s+(?:!?U?P\w+,\s*)?0x([0-9a-f]+)", t)) else None)
        back = [(a, target(t)) for a, t in ins
                if target(t) is not None and target(t) < a]
        end, i = (back[-1][0], at[back[-1][1]]) if back else (None, 0)
        n = 0
        while i < len(ins):
            a, t = ins[i]
            if a == end:
                break
            n += 1
            if t.startswith(("EXIT", "RET")):
                break
            tgt = target(t)
            if tgt is not None and tgt > a and (not t.startswith("@") or any(
                    x.startswith("CALL") or "MUFU" in x or "I2F" in x
                    for b, x in ins if a < b < tgt)):
                i = at[tgt]
                continue
            i += 1
        out[(kernel[0], tuple(kernel[1]))] = n
    return out


def codec_ab(parent, stems=CODEC_AB_STEMS) -> int:
    """``--codec-ab PARENT [STEM ...]``: device milliseconds of the codec
    kernels ``stems`` (default the onebit pack and fp8 SR; any of
    ``PLAN_VECS``) of the checkout at PARENT (their ``csrc`` sources built
    here with the same flags) and of this checkout, on one bucket (the
    phase-3 data), in one process: five rounds of parent, change, change,
    parent, each a ``time_ms`` (median of 30 launches, L2 flushed);
    ``torch.quantize_per_tensor`` once a round beside the int8 quantize,
    ``torch.mul`` by the 0-dim scale beside the dequantize. Each side is
    called through its own C entry point with its own plan: this
    checkout's takes the launch plan (``_build.SIGNATURES``), a
    PARENT library without that entry is called as before the plan
    (``BEFORE_PLAN``), and each side's plan takes the float4s a thread its
    own kernels.py states. Both sides must give the same bytes. Prints the
    least and the median per side as one JSON line."""
    from byteps_tpu_torch.ops import _build
    from byteps_tpu_torch.ops.compression import fp8sr
    from byteps_tpu_torch.ops.compression import kernels as ob
    unknown = set(stems) - set(PLAN_VECS)
    if unknown:
        raise ValueError(f"--codec-ab: no such codec kernel {sorted(unknown)}")
    root = Path(parent).resolve()
    out = root / "byteps_tpu_torch" / "_build_codec_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = [(stem, subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(out / f"lib{stem}.so"),
         str(root / "byteps_tpu_torch" / "csrc" / f"{stem}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for stem in stems]
    n = BUCKET_FLOATS
    x = torch.randn(n, generator=torch.Generator().manual_seed(33)).cuda()
    amax = x.abs().max().item()
    s8, sf = amax / 127, amax / fp8sr.fmt_max(fp8sr.E4M3)
    words, q = ob.onebit_pack(x), ob.int8_quantize(x, s8)
    stream = torch.cuda.current_stream().cuda_stream
    sms = ob._sms(x.device)
    xa = x.data_ptr() % ob.VEC_BYTES
    # per stem: its input's address offset, its output, and its arguments
    # before and after the plan (between them the plan's head, vecs, grid
    # and dequantize's instance)
    io = {"int8_quantize": (xa, lambda: torch.empty(n, dtype=torch.int8,
                                                     device="cuda"),
                            lambda o: ((x.data_ptr(), o, n), (s8,))),
          "onebit_unpack": (0, lambda: torch.empty(n, device="cuda"),
                            lambda o: ((words.data_ptr(), o, n), ())),
          "onebit_pack": (xa, lambda: torch.empty(ob.words_for(n),
                                                   dtype=torch.int32,
                                                   device="cuda"),
                          lambda o: ((x.data_ptr(), o, n), ())),
          "fp8_sr_quantize": (xa, lambda: torch.empty(n, dtype=torch.uint8,
                                                      device="cuda"),
                              lambda o: ((x.data_ptr(), o, n),
                                         (sf, 1234, fp8sr.E4M3))),
          "int8_dequantize": (0, lambda: torch.empty(n, device="cuda"),
                              lambda o: ((q.data_ptr(), o, n), (s8,)))}
    outs = {side: {stem: io[stem][1]() for stem in stems}
            for side in ("parent", "change")}

    def call(side, stem, fn, vecs):
        addr, _, args = io[stem]
        lead, rest = args(outs[side][stem].data_ptr())
        if vecs is None:                       # before the plan
            return lambda: fn(*lead, *rest, stream)
        p = ob.stream_plan(n, addr, sms, 4, vecs)
        plan = ((p.vecs, p.grid) if stem in NO_HEAD
                else (p.head, p.vecs, p.grid))
        if stem == "int8_dequantize":
            plan += (int(ob.dequantize_reads_words(q.data_ptr())),)
        return lambda: fn(*lead, *plan, *rest, stream)

    sides = {"parent": {}, "change": {}}
    sass_path = {}
    for stem, proc in procs:
        log_text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {root}'s csrc/{stem}.cu:\n"
                               f"{log_text}")
        lib = ctypes.CDLL(str(out / f"lib{stem}.so"))
        name, argtypes = _build.SIGNATURES[stem]
        own = getattr(ob, PLAN_VECS[stem])
        vecs = _plan_vecs(root, stem, own) if hasattr(lib, name) else None
        if vecs is None:
            name, argtypes = BEFORE_PLAN[stem]
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        sides["parent"][stem] = call("parent", stem, fn, vecs)
        sides["change"][stem] = call("change", stem, _build.entry(stem), own)
        log(f"[codec-ab] {stem}: parent's {name}"
            + ("" if vecs is None else f", {vecs} float4s a thread")
            + f"; this checkout's {own}")
        if stem == "fp8_sr_quantize":   # its SASS, before and after
            for side, sass, v in (
                    ("parent", _build.sass_listing(out / f"lib{stem}.so"),
                     vecs),
                    ("change", _build.sass_of(stem), own)):
                per = 1 if v is None else 4 * v   # elements a thread a pass
                sass_path[side] = {
                    f"{k}{list(args)}": count / per for (k, args), count
                    in sorted(common_path(sass).items())}
                log(f"[codec-ab] {stem} {side}: common-path instructions "
                    f"per element, {per} a thread a pass: {sass_path[side]}")
    for side in sides:
        for stem, fn in sides[side].items():
            _build.raise_on_error(fn(), f"{side} {stem}")
    torch.cuda.synchronize()
    for stem in stems:
        a, b = (outs[side][stem].view(torch.uint8) for side in sides)
        if not torch.equal(a, b):
            raise AssertionError(f"{stem}: the parent's and this checkout's "
                                 "kernels give other bytes")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    runs = {side: {stem: [] for stem in stems} for side in sides}
    s_t = ob._scale_on(s8, x.device)
    library = {stem: fn for stem, fn in (
        ("int8_quantize",
         lambda: torch.quantize_per_tensor(x, s8, 0, torch.qint8)),
        ("int8_dequantize", lambda: torch.mul(q, s_t))) if stem in stems}
    library_runs = {stem: [] for stem in library}
    for _ in range(5):
        for side in ("parent", "change", "change", "parent"):
            for stem in stems:
                runs[side][stem].append(time_ms(sides[side][stem],
                                                flush=flush))
        for stem, fn in library.items():
            library_runs[stem].append(time_ms(fn, flush=flush))
    stat = lambda v: {"least": min(v), "median": statistics.median(v)}
    res = {stem: {side: stat(runs[side][stem]) for side in sides}
           for stem in stems}
    for stem, v in library_runs.items():
        res[stem]["library"] = stat(v)
    if sass_path:
        res["fp8_sr_quantize"]["sass_per_element"] = sass_path
    print(json.dumps({"codec_ab_ms": res, "n": n, "parent": str(parent)}))
    print(card_line())
    return 0


# ------------------------------------------------------------- phase 4

# each codec kernel (a stem of ``CODEC_STEMS``) by its kernel's name, a
# substring of what the profiler reports
CODEC_KERNEL_NAMES = {"onebit_pack": "onebit_pack_kernel",
                      "onebit_unpack": "onebit_unpack_kernel",
                      "int8_quantize": "int8_quantize_kernel",
                      "int8_dequantize": "int8_dequantize_kernel",
                      "fp8_sr_quantize": "fp8_sr_kernel"}
_KERNEL_GROUPS = (      # first match wins; names as the profiler reports them
    ("flash (port)", ("flash_fwd_kernel", "flash_bwd_")),
    ("onebit (port)", tuple(CODEC_KERNEL_NAMES[s] for s in
                            ("onebit_pack", "onebit_unpack"))),
    ("quantize (port)", tuple(CODEC_KERNEL_NAMES[s] for s in
                              ("int8_quantize", "int8_dequantize",
                               "fp8_sr_quantize"))),
    ("topk / draws (library)", ("topk", "radixselect", "philox",
                                "distribution_")),
    ("nccl", ("nccl",)),
    ("matmul", ("gemm", "xmma", "cutlass", "matmul", "nvjet", "sm90_")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("embedding", ("embedding", "index", "scatter", "gather", "sort",
                   "radix", "segment")),
    ("softmax / reductions", ("softmax", "reduce", "norm", "sum", "max",
                              "mean")),
    ("copies", ("copy", "memcpy", "memset", "cat", "fill")),
)


def codec_in_step(kernels):
    """Device ms and launches of each codec kernel among ``kernels`` (the
    (name, µs) pairs of a profiled step's device work), by stem; a kernel
    that did not run is left out."""
    out = {}
    for name, us in kernels:
        for stem, kname in CODEC_KERNEL_NAMES.items():
            if kname in name:
                r = out.setdefault(stem, {"ms": 0.0, "launches": 0})
                r["ms"] += us / 1e3
                r["launches"] += 1
    return out


def profile_step(trainer, data, tag):
    """One more step under torch.profiler: device time by kernel group,
    each codec kernel's device time and launches, and the device's idle
    share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.perf_counter()
        trainer.step(data)
        _drain(trainer)     # the step's own tail, on the cross-step route
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device work only: user annotations ("Optimizer.step#...") also ride
    # the device track and would count their span as one more kernel
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.name]
    if not kernels:
        log(f"[profile {tag}] the profiler recorded no device activity: "
            "device breakdown not measured")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    groups, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        low = e.name.lower()
        g = next((g for g, keys in _KERNEL_GROUPS
                  if any(k in low for k in keys)), "other elementwise")
        groups[g] = groups.get(g, 0.0) + us
    total = sum(groups.values())
    log(f"[profile {tag}] step wall {wall_us / 1e3:.2f} ms, {len(kernels)} "
        f"device ops, device busy {busy / 1e3:.2f} ms (idle share "
        f"{1 - busy / wall_us:.3f}), summed device time {total / 1e3:.2f} ms")
    for g, us in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"[profile {tag}]   {g:24s} {us / 1e3:9.3f} ms  {us / total:6.1%}")
    for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:12]:
        log(f"[profile {tag}]   top {us / 1e3:9.3f} ms  {name[:110]}")
    codec = codec_in_step((e.name, e.time_range.end - e.time_range.start)
                          for e in kernels)
    for stem, r in codec.items():
        log(f"[profile {tag}]   codec {stem:16s} {r['ms']:9.3f} ms over "
            f"{r['launches']} launches ({r['ms'] * 1e3 / r['launches']:.2f} "
            f"µs each)")
    ranges = range_ms(prof.events(), kernels)
    for name in RANGES:
        if name in ranges:
            log(f"[profile {tag}]   range {name:24s} {ranges[name]:9.3f} ms "
                f"{ranges[name] * 1e3 / total:6.1%} of device time")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us, "device_ops": len(kernels),
            "device_ms": total / 1e3, "codec": codec, "ranges": ranges}


def range_ms(events, kernels, names=RANGES):
    """Device ms of the kernels inside each profiler range of ``names``
    (the port's ``record_function`` ranges): the range's spans on the
    device track (the profiler's annotation of a range there runs from
    the first kernel launched inside it to the end of the last), and each
    device kernel of ``kernels`` that starts inside one. A range with no
    span on the device reads nothing: not measured."""
    from torch.autograd import DeviceType
    spans = {}
    for e in events:
        if e.name in names and e.device_type == DeviceType.CUDA:
            spans.setdefault(e.name, []).append((e.time_range.start,
                                                 e.time_range.end))
    out = {}
    for name, sp in spans.items():
        sp.sort()
        starts = [a for a, _ in sp]
        us = 0.0
        for k in kernels:
            i = bisect.bisect_right(starts, k.time_range.start) - 1
            if i >= 0 and k.time_range.start < sp[i][1]:
                us += k.time_range.end - k.time_range.start
        out[name] = us / 1e3
    return out


def _drain(trainer):
    """Join a PS trainer's cross-step tails (a no-op elsewhere)."""
    drain = getattr(trainer, "drain", None)
    if drain is not None:
        drain()


def run_path(tag, cfg, loss_fn, data, flops_per_sample, want,
             compression=None, naive_cfg=None, more_steps=STEPS,
             model_cls=None, tokens_per_sample=None, mesh=None,
             batch=TRAIN_BATCH, setup=None, after_counted=None,
             profile=True):
    """Train ``STEPS`` steps through ``DistributedTrainer`` (with a
    ``mesh``: ``ShardedTrainer`` on it, the global batch ``data``) with
    every launch counter zeroed just before and read just after; check finite
    falling losses and the counts ``want(trainer)``. Then ``more_steps``
    more for steadier times, one profiled step, and (``naive_cfg``) step 1
    of a fresh trainer with plain attention as the loss's reference.
    ``model_cls`` builds the model from ``cfg`` (default the transformer
    core); ``batch`` is the rows of ``data``, for the rates. Returns
    (launches, trainer, losses, metrics): ``metrics`` is the
    port's metrics registry over the counted steps (the parameter-server
    path's byte counters and stage times). The run's step time, rates,
    peak memory and profiled step go to ``SUMMARY[tag]``. ``setup(trainer)``
    runs before the first step, ``after_counted(trainer, times, drain_s)``
    after the counted ones (a PS trainer's cross-step tails drained, in
    ``drain_s`` seconds, before the counts are read)."""
    from byteps_tpu_torch.models.flops import mfu
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.obs.metrics import get_registry
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer, ShardedTrainer

    def make_trainer(c):
        model = (model_cls or Transformer)(
            c, generator=torch.Generator().manual_seed(0))
        if mesh is not None:
            return ShardedTrainer(loss_fn, model,
                                  adamw(model.parameters(), 1e-4), mesh,
                                  partition_bytes=PARTITION_BYTES)
        return DistributedTrainer(loss_fn, model,
                                  adamw(model.parameters(), 1e-4),
                                  partition_bytes=PARTITION_BYTES,
                                  compression=compression,
                                  min_compress_bytes=MIN_COMPRESS_BYTES)

    t0 = time.perf_counter()
    trainer = make_trainer(cfg)     # device=None: the card
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"[{tag}] {n_params / 1e6:.1f}M params on {trainer.device}, built "
        f"in {time.perf_counter() - t0:.1f} s")
    if setup is not None:
        setup(trainer)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctr = counters()
    zero_counts(ctr)
    get_registry().reset()
    losses, times = [], []
    for _ in range(STEPS):
        t = time.perf_counter()
        loss = trainer.step(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
    t = time.perf_counter()
    _drain(trainer)
    drain_s = time.perf_counter() - t
    launches = read_counts(ctr)
    metrics = get_registry().snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if after_counted is not None:
        after_counted(trainer, times, drain_s)

    def rates(step_s):
        sps = batch / step_s
        util = mfu(sps, flops_per_sample)
        toks = ("" if tokens_per_sample is None
                else f"{sps * tokens_per_sample:.0f} tokens/s, ")
        return (f"{step_s * 1e3:.1f} ms = {sps:.2f} samples/s, {toks}"
                f"{sps * flops_per_sample / 1e12:.1f} model TFLOP/s, mfu "
                + ("not known for this card" if util is None
                   else f"{util:.4f}"))

    # a cross-step trainer's step returns before its tail ran, and the
    # next step waits for it: its steps 2-3 count whole, the last tail
    # drained
    piped = getattr(trainer, "_cross_driver", None) is not None
    counted_s = ((sum(times[1:]) + drain_s) / (len(times) - 1) if piped
                 else min(times[1:]))
    log(f"[{tag}] losses {losses}")
    log(f"[{tag}] step times s {times}" + (f", the last tail drained in "
                                           f"{drain_s:.3f} s" if piped else "")
        + f"; peak memory {peak_gb:.2f} GB; "
        + ("steps 2-3 a step: " if piped else "fastest of steps 2-3: ")
        + rates(counted_s))
    log(f"[{tag}] kernel launches in the {STEPS} steps: {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    expected = want(trainer)
    if launches != expected:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"{expected}")

    # past the counted window: steadier step times, then one profiled step
    more = []
    for _ in range(more_steps):
        t = time.perf_counter()
        trainer.step(data)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t)
    _drain(trainer)
    if more:
        log(f"[{tag}] steps {STEPS + 1}-{STEPS + more_steps} s {more}: "
            f"median {rates(statistics.median(more))}")
    step_s = statistics.median(more) if more else counted_s
    SUMMARY[tag] = {"step_ms": step_s * 1e3,
                    "samples_per_s": batch / step_s,
                    "mfu": mfu(batch / step_s, flops_per_sample),
                    "peak_gb": peak_gb, "losses": losses,
                    "profile": (profile_step(trainer, data, tag) if profile
                                else None)}

    if naive_cfg is not None:
        naive = make_trainer(naive_cfg)
        naive_loss = naive.step(data).item()
        del naive
        diff = abs(naive_loss - losses[0])
        log(f"[{tag}] step-1 loss: kernels {losses[0]:.6f}, naive attention "
            f"{naive_loss:.6f}, |diff| {diff:.3e}")
        if not diff <= 2e-2:
            raise AssertionError(f"{tag}: kernel path and naive path "
                                 "disagree on the step-1 loss")
    torch.cuda.empty_cache()
    return launches, trainer, losses, metrics


SUMMARY = {}


def _attention_launches(cfg, backward, forwards=2):
    """``forwards`` launches of the forward a layer per step (2 under
    whole-block remat: the backward's recompute), ``backward`` once."""
    def want(trainer):
        w = dict.fromkeys(COUNT_KEYS, 0)
        w["flash_fwd"] = STEPS * cfg.layers * forwards
        for name in backward:
            w[name] = STEPS * cfg.layers
        return by_width(w, cfg.head_dim)
    return want


def train_bert():
    from byteps_tpu_torch.models import bert
    cfg, loss_fn, data, fps = _bert_setup()
    launches, trainer, losses, _ = run_path(
        "bert_large", cfg, loss_fn, data, fps,
        _attention_launches(cfg, ("flash_bwd_fused",)),
        naive_cfg=bert.bert_large(max_seq=BERT_SEQ, attn_impl="naive"))
    del trainer
    return launches, losses


def train_bert_dh128():
    """bench.py's dh128 variant of BERT-large (8 heads of 128: the same
    hidden, layers and FLOPs): the d-128 forward and fused backward, no
    d-64 launch; step 1's loss against the same config on plain attention.
    Its step time, rates and profile are printed beside the d-64 run's of
    this call."""
    import dataclasses

    from byteps_tpu_torch.models import bert
    cfg, loss_fn, data, fps = _bert_setup(heads=DH128_HEADS)
    if cfg.head_dim != DH128:
        raise AssertionError(f"dh128 config has head_dim {cfg.head_dim}")
    launches, trainer, _, _ = run_path(
        "bert_large_dh128", cfg, loss_fn, data, fps,
        _attention_launches(cfg, ("flash_bwd_fused",)),
        naive_cfg=dataclasses.replace(
            bert.bert_large(max_seq=BERT_SEQ, attn_impl="naive"),
            heads=DH128_HEADS))
    del trainer
    torch.cuda.empty_cache()
    for tag in ("bert_large", "bert_large_dh128"):
        r = SUMMARY[tag]
        p = r["profile"] or {}
        log(f"[dh128 vs d64, this call] {tag}: step {r['step_ms']:.1f} ms "
            f"(median of steps 4-6), {r['samples_per_s']:.2f} samples/s, "
            f"mfu {r['mfu']}, peak {r['peak_gb']:.2f} GB; profiled step "
            f"wall {p.get('wall_ms', float('nan')):.2f} ms, device busy "
            f"{p.get('busy_ms', float('nan')):.2f} ms, idle share "
            f"{p.get('idle_share', float('nan')):.3f}")
    return launches


def _hybrid_vs_flash(tag, flash_tag, losses):
    """Step 1's loss of a hybrid path against its flash path's in this
    call (the same weights and batch), and both paths' step time, peak
    memory and device time beside each other, with the plain forward's
    share of the hybrid path's (the ``bps::hybrid_fwd`` range)."""
    ref = SUMMARY[flash_tag]["losses"][0]
    diff = abs(losses[0] - ref)
    log(f"[{tag}] step-1 loss {losses[0]!r}, the flash path's {ref!r}: "
        f"|diff| {diff:.3e} (tolerance {HYBRID_TOL})")
    for t in (flash_tag, tag):
        r = SUMMARY[t]
        p = r["profile"] or {}
        fwd = (p.get("ranges") or {}).get("bps::hybrid_fwd")
        share = ("" if t == flash_tag else
                 ", plain forward not measured (no bps::hybrid_fwd span)"
                 if fwd is None or not p.get("device_ms") else
                 f", plain forward {fwd:.3f} ms = "
                 f"{fwd / p['device_ms']:.1%} of device time")
        log(f"[hybrid vs flash, this call] {t}: step {r['step_ms']:.1f} ms "
            f"(median of steps 4-6), {r['samples_per_s']:.2f} samples/s, "
            f"peak {r['peak_gb']:.2f} GB; profiled step: wall "
            f"{p.get('wall_ms', float('nan')):.2f} ms, device busy "
            f"{p.get('busy_ms', float('nan')):.2f} ms, summed device time "
            f"{p.get('device_ms', float('nan')):.2f} ms{share}")
    if not diff <= HYBRID_TOL:
        raise AssertionError(f"{tag}: step-1 loss differs from the flash "
                             "path's")


def _bf16_step(x) -> float:
    """The spacing of bf16 at max |x|."""
    m = x.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def _step1_grads(cfg, model_cls, loss_fn, data):
    """(loss, gradients) of one forward and backward of fresh weights from
    seed 0 on the card, as a path's trainer takes its step 1."""
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.training import _to_device
    model = (model_cls or Transformer)(
        cfg, generator=torch.Generator().manual_seed(0)).cuda()
    loss = loss_fn(model, _to_device(data, "cuda"))
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in model.parameters()]
    return loss.item(), grads


def _grad_rel(grads, ref):
    """||grads - ref|| / ||ref|| over all the tensors together, summed in
    fp64."""
    num = sum((g.double() - r.double()).square().sum().item()
              for g, r in zip(grads, ref))
    den = sum(r.double().square().sum().item() for r in ref)
    return math.sqrt(num / den)


def _op_grads(q, k, v, do, causal, scale, rel, hybrid):
    """(dq, dk, dv[, dtable]) of ``flash_attention`` on the card."""
    from byteps_tpu_torch.ops import flash_attention as fa
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    kw = {}
    if rel is not None:
        kw = {"rel_table": rel[0].detach().clone().requires_grad_(),
              "rel_bidirectional": rel[1]}
        leaves.append(kw["rel_table"])
    fa.flash_attention(*leaves[:3], causal=causal, scale=scale,
                       hybrid=hybrid, **kw).backward(do)
    return [t.grad for t in leaves]


def _hybrid_fwd_bf16(q, k, v, causal=False, scale=None, bias=None):
    """``hybrid_fwd`` with the trap it avoids: products of bf16 operands,
    whose result torch rounds to bf16 (the scores, then the output)."""
    from byteps_tpu_torch.ops import flash_attention as fa
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2)).float() * fa._scale(q, scale)
    if bias is not None:
        s = s + bias[None].float()
    if causal:
        s = s.masked_fill(~fa._causal_keep(q.shape[1], k.shape[1], q.device),
                          fa._NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul((p / l).to(v.dtype), vt)
    return out.transpose(1, 2).contiguous(), (m + torch.log(l))[..., 0]


class HybridControl:
    """A deliberately wrong hybrid forward, patched into
    ``flash_attention`` inside the block: ``"bf16"`` multiplies in bf16
    (``_hybrid_fwd_bf16``), ``"lse"`` returns an lse one bf16 step (2^-8)
    high, ``"no_bias"`` drops the bias (T5's table), ``"tf32"`` lets the
    fp32 products run in TF32."""

    def __init__(self, kind):
        from byteps_tpu_torch.ops import flash_attention as fa
        self.fa, self.kind = fa, kind

    def __enter__(self):
        fa, fwd, full = self.fa, self.fa.hybrid_fwd, self.fa._full_fp32
        self.saved = fwd, full
        if self.kind == "bf16":
            fa.hybrid_fwd = _hybrid_fwd_bf16
        elif self.kind == "lse":
            def wrong(*a, **kw):
                out, lse = fwd(*a, **kw)
                return out, lse + 2.0 ** -8
            fa.hybrid_fwd = wrong
        elif self.kind == "no_bias":
            fa.hybrid_fwd = lambda q, k, v, causal=False, scale=None, \
                bias=None: fwd(q, k, v, causal, scale, None)
        else:
            @contextlib.contextmanager
            def tf32():
                prev = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    yield
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = prev
            fa._full_fp32 = tf32
        return self

    def __exit__(self, *exc):
        self.fa.hybrid_fwd, self.fa._full_fp32 = self.saved


def check_hybrid(tag, cfg, flash_cfg, model_cls, loss_fn, data, fwd_cases,
                 gate=True):
    """The hybrid route held on the card beyond its step-1 loss, against
    the flash route on the same inputs, with the fault controls of
    ``HYBRID_CONTROLS[tag]`` beside it (``HybridControl``):

    - at each of ``fwd_cases`` (name, q, k, v, dO, causal, scale, (table,
      bidirectional) or None): ``hybrid_fwd`` against the forward kernel,
      lse within HYBRID_LSE_TOL of max |lse| and out within one bf16 step
      at max |out|; then the attention's gradients (dq, dk, dv and dtable)
      under hybrid against flash's, ||difference|| / ||flash's|| at most
      HYBRID_OP_TOL[tag], the controls gated at "op" above it;
    - the step-1 gradients of fresh weights under ``cfg`` (hybrid)
      against those under ``flash_cfg`` over every parameter,
      ||difference|| / ||flash's|| at most HYBRID_GRAD_TOL, as is a second
      flash run's, the controls gated at "grad" above it.

    Returns the readings. The flash launches here fall outside every
    counted window. ``gate=False`` prints the readings and gates none."""
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import relpos
    controls = HYBRID_CONTROLS[tag]
    out = {"fwd": {}, "op": {}, "grad": {}}
    bad = []

    def gated(what, level, readings, tol):
        """The sound readings at most ``tol``, the controls gated at
        ``level`` above it."""
        for k, v in readings.items():
            if k not in controls and not v <= tol:
                bad.append(f"{what}: the {k} reading over the limit")
            if level in controls.get(k, ()) and not v > tol:
                bad.append(f"{what}: the {k} control at or under the limit")

    for name, q, k, v, do, causal, scale, rel in fwd_cases:
        kw, bias = {}, None
        if rel is not None:
            table, bidir = rel
            kw = {"rel_table": table, "rel_bidirectional": bidir}
            bias = relpos.relative_bias(table.T, q.shape[1], k.shape[1],
                                        bidir, table.shape[1])
        out_h, lse_h = fa.hybrid_fwd(q, k, v, causal, scale, bias)
        out_f, lse_f = fa.flash_fwd(q, k, v, causal, scale, **kw)
        torch.cuda.synchronize()
        e_lse = ((lse_h - lse_f).abs().max() / lse_f.abs().max()).item()
        e_out = (out_h.float() - out_f.float()).abs().max().item()
        step = _bf16_step(out_f)
        out["fwd"][name] = {"lse_rel": e_lse, "out_abs": e_out,
                            "bf16_step": step}
        del out_h, lse_h, out_f, lse_f, bias
        if not (e_lse <= HYBRID_LSE_TOL and e_out <= step):
            bad.append(f"hybrid_fwd at {name}")
        ref = _op_grads(q, k, v, do, causal, scale, rel, False)
        op = {"sound": _grad_rel(_op_grads(q, k, v, do, causal, scale, rel,
                                           True), ref)}
        for kind in controls:
            if kind == "no_bias" and rel is None:   # nothing to drop
                continue
            with HybridControl(kind):
                op[kind] = _grad_rel(_op_grads(q, k, v, do, causal, scale,
                                               rel, True), ref)
        del ref
        out["op"][name] = op
        log(f"[{tag}] hybrid vs flash, {name}: forward lse {e_lse:.3e} of "
            f"max |lse| (tolerance {HYBRID_LSE_TOL}), out {e_out:.3e} (one "
            f"bf16 step at max |out|: {step:.3e}); attention gradients "
            "||difference|| / ||flash's||: " + ", ".join(
                f"{c} {r:.3e}" for c, r in op.items())
            + f" (limit {HYBRID_OP_TOL[tag]})")
        gated(f"attention gradients at {name}", "op", op, HYBRID_OP_TOL[tag])
    torch.cuda.empty_cache()

    loss_f, ref = _step1_grads(flash_cfg, model_cls, loss_fn, data)
    _, grads = _step1_grads(flash_cfg, model_cls, loss_fn, data)
    grad = out["grad"]
    grad["flash_again"] = _grad_rel(grads, ref)
    loss_h, grads = _step1_grads(cfg, model_cls, loss_fn, data)
    grad["sound"] = _grad_rel(grads, ref)
    del grads
    for kind in controls:
        with HybridControl(kind):
            _, grads = _step1_grads(cfg, model_cls, loss_fn, data)
        grad[kind] = _grad_rel(grads, ref)
        del grads
    del ref
    torch.cuda.empty_cache()
    log(f"[{tag}] step-1 loss of fresh weights: flash {loss_f!r}, hybrid "
        f"{loss_h!r}; gradients ||difference|| / ||flash's|| over every "
        "parameter: " + ", ".join(f"{k} {v:.3e}" for k, v in grad.items())
        + f" (limit {HYBRID_GRAD_TOL})")
    gated("step-1 gradients", "grad", grad, HYBRID_GRAD_TOL)
    if gate and bad:
        raise AssertionError(f"{tag}: hybrid against flash: "
                             + "; ".join(bad))
    return out


def _bert_hybrid_check(gate=True):
    import dataclasses
    cfg, loss_fn, data, _ = _bert_setup()
    q, k, v, do = _inputs(TRAIN_BATCH, BERT_SEQ, HEADS, HEAD_DIM, seed=80)
    return check_hybrid(
        "bert_large_hybrid", dataclasses.replace(cfg, attn_impl="hybrid"),
        cfg, None, loss_fn, data,
        [(f"b{TRAIN_BATCH} s{BERT_SEQ} h{HEADS} d{HEAD_DIM} full", q, k, v,
          do, False, None, None)], gate)


def _t5_hybrid_check(gate=True):
    from byteps_tpu_torch.models import t5
    cfg, data, _ = _t5_setup(attn_impl="hybrid")
    b, dec = TRAIN_BATCH, T5_TGT - 1
    enc = _t5_inputs(b, T5_SRC, seed=81)
    causal = _t5_inputs(b, dec, seed=82)
    q, k, v, do = _inputs(b, T5_SRC, T5_HEADS, HEAD_DIM, seed=83)
    q, do = q[:, :dec].contiguous(), do[:, :dec].contiguous()
    q, k = (t * HEAD_DIM ** -0.25 for t in (q, k))
    cases = [(f"b{b} s{T5_SRC} h{T5_HEADS} rel bidirectional", *enc[:4],
              False, 1.0, (enc[4], True)),
             (f"b{b} s{dec} h{T5_HEADS} rel causal", *causal[:4], True, 1.0,
              (causal[4], False)),
             (f"b{b} sq{dec} sk{T5_SRC} h{T5_HEADS} cross", q, k, v, do,
              False, 1.0, None)]
    return check_hybrid("t5_small_hybrid", cfg, t5.t5_small(), t5.T5,
                        t5.seq2seq_loss, data, cases, gate)


def hybrid_check_main() -> int:
    """``--hybrid-check``: build the kernels, then every ``check_hybrid``
    reading, ungated."""
    toolchain()
    readings = {"bert_large_hybrid": _bert_hybrid_check(gate=False),
                "t5_small_hybrid": _t5_hybrid_check(gate=False)}
    print(json.dumps({"hybrid": readings}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _hybrid_launches(cfg, backward):
    """A hybrid path: no forward kernel; ``backward`` once a layer."""
    def want(trainer):
        w = dict.fromkeys(COUNT_KEYS, 0)
        for name in backward:
            w[name] = STEPS * cfg.layers
        return by_width(w, cfg.head_dim)
    return want


def train_bert_hybrid():
    """BERT-large with ``attn_impl="hybrid"``: attention's forward from
    plain products (no forward kernel), the fused backward kernel; step
    1 against the flash path's."""
    import dataclasses
    cfg, loss_fn, data, fps = _bert_setup()
    cfg = dataclasses.replace(cfg, attn_impl="hybrid")
    launches, trainer, losses, _ = run_path(
        "bert_large_hybrid", cfg, loss_fn, data, fps,
        _hybrid_launches(cfg, ("flash_bwd_fused",)))
    del trainer
    torch.cuda.empty_cache()
    _hybrid_vs_flash("bert_large_hybrid", "bert_large", losses)
    _bert_hybrid_check()
    return launches


def _bert_setup(heads=None, layers=None):
    import dataclasses

    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.models.flops import transformer_train_flops_per_sample
    cfg = bert.bert_large(max_seq=BERT_SEQ)
    if heads is not None:          # bench.py:3084's replace(bert_large, heads=8)
        cfg = dataclasses.replace(cfg, heads=heads)
    if layers is not None:         # a cut path (CUT_LAYERS)
        cfg = dataclasses.replace(cfg, layers=layers)
    max_pred = max(1, int(0.2 * BERT_SEQ))
    data = bert.synth_mlm_batch(np.random.RandomState(0), TRAIN_BATCH,
                                BERT_SEQ, cfg.vocab_size)
    return (cfg, lambda m, b: bert.mlm_loss(m, b, max_predictions=max_pred),
            data, transformer_train_flops_per_sample(cfg, BERT_SEQ,
                                                     lm_positions=max_pred))


def check_ps_encode(trainer, loss_fn, data, tag):
    """One step's real gradient buckets encoded on the card through the
    kernels and through their plain versions, with the residuals and fp8
    seeds the 3 steps left: payload (codes and scale) and new residual
    bit for bit, for every compressed bucket."""
    from byteps_tpu_torch.compress import device as cdev
    ex = trainer.ps_exchange
    plane = ex._cplane
    (_, keyed), = ex._plans.values()
    trainer.model.zero_grad(set_to_none=True)
    loss_fn(trainer.model, tuple(torch.from_numpy(x).cuda()
                                 for x in data)).backward()
    grads = [p.grad for _, p in trainer._ps_params]
    n = 0
    for pskey, b in keyed:
        if not plane.active(pskey):
            continue
        st = plane._keys[pskey]
        level = plane.level_of(pskey)
        seed = plane._sr_seed(pskey, st, ex._key_rounds[pskey] + 1, level)
        parts = [(grads[s.leaf_index], s.leaf_offset, s.length)
                 for s in b.segments]
        got, got_r, _ = cdev.encode_bucket(parts, st.size, level, seed,
                                           st.residual, True)
        ref, ref_r, _ = cdev.encode_bucket(parts, st.size, level, seed,
                                           st.residual, True, plain=True)
        if got != ref or not _same_bits(got_r, ref_r):
            raise AssertionError(f"{tag}: bucket {b.index} encoded through "
                                 "the kernels differs from the plain versions")
        n += 1
    trainer.model.zero_grad(set_to_none=True)
    log(f"[{tag}] one step's real gradients, {n} compressed buckets: "
        "payloads (codes and scale) and new residuals bit-identical through "
        "the kernels and through their plain versions")


class _StepOnePayloads:
    """A digest of each PS key's first pushed payload (step 1's) by
    wrapping the backend's pushes; ``by_bucket(ex)`` lists them in bucket
    order, so two trainers' keys compare."""

    def __init__(self, backend):
        self.backend, self.digests = backend, {}
        self.orig = {n: getattr(backend, n)
                     for n in ("push", "push_fused", "push_bytes")
                     if hasattr(backend, n)}
        for name, fn in self.orig.items():
            setattr(self.backend, name, self._wrap(fn))

    def _wrap(self, fn):
        def push(key, data, *a, **kw):
            if key not in self.digests:
                self.digests[key] = hashlib.sha1(memoryview(data)).hexdigest()
            return fn(key, data, *a, **kw)
        return push

    def by_bucket(self, ex):
        (_, keyed), = ex._plans.values()
        return [self.digests.get(pskey) for pskey, _ in keyed]

    def remove(self):
        for name, fn in self.orig.items():
            setattr(self.backend, name, fn)


def _param_digests(trainer):
    """A digest of each parameter's bytes (the tails drained first)."""
    return {n: hashlib.sha1(p.detach().cpu().numpy()).hexdigest()
            for n, p in trainer.model.named_parameters()}


def _route_ms(times, drain_s):
    """Steps 2-3 of a counted run, the last tail drained, a step."""
    return (sum(times[1:]) + drain_s) / (len(times) - 1) * 1e3


def _log_overlap(tag, metrics, steps):
    """The default route's own readings: bytes on the wire before the
    backward ended, the per-group applies and the cross-step gate."""
    stages = {k[6:]: v for k, v in metrics.items() if k.startswith("stage/")}
    inb = metrics.get("ps/push_bytes_in_backward", 0)
    pushed = metrics["ps/push_bytes"]
    log(f"[{tag}] per step: ps/push_bytes_in_backward {inb / steps:.0f} of "
        f"ps/push_bytes {pushed / steps:.0f} ({inb / max(pushed, 1):.4f} of "
        f"the pushed bytes left before the backward ended)")
    for name in ("PS_APPLY_CHUNK", "PS_XSTEP_GATE", "PS_H2D",
                 "PS_PUSH_PULL"):
        v = stages.get(name, {"count": 0, "sum_ms": 0.0})
        log(f"[{tag}] span {name}: {v['count']} over {steps} steps, "
            f"{v['sum_ms']:.1f} ms summed")
    return inb / steps


def train_bert_ps(codec, dense_losses, step2_misses, layers=None):
    """BERT-large through the parameter-server path under ``BPS_COMPRESS=
    codec``: the same model, weights and batch as the dense BERT run (at
    ``layers`` of its layers if given, against a dense run of that
    depth), on the default route (staged head, streamed tail, cross-step
    driver); then in turn the monolithic route (``BPS_APPLY_CHUNKED=0``)
    on the same weights and batch, which must end its counted steps with
    the default route's parameters bit for bit, push step 1's payloads
    with the same bytes, and launch the same kernels as often. Returns
    both routes' launches."""
    import os

    import byteps_tpu_torch as bps
    cfg, loss_fn, data, fps = _bert_setup(layers=layers)
    tag = f"bert_large ps {codec}"
    log(f"[{tag}] {cfg.layers} of 24 layers")
    attn = _attention_launches(cfg, ("flash_bwd_fused",))

    def want(trainer):
        w = attn(trainer)
        nc = trainer.ps_exchange.n_compressed()
        if codec == "int8":
            w["int8_quantize"] = w["int8_dequantize"] = STEPS * nc
        else:
            w["fp8_sr_quantize"] = STEPS * nc
        return w

    turn = {}

    def setup(trainer):
        turn["payloads"] = _StepOnePayloads(trainer.ps_exchange.backend)

    def after_counted(trainer, times, drain_s):
        turn["payloads"].remove()
        turn["payload_digests"] = turn["payloads"].by_bucket(
            trainer.ps_exchange)
        turn["params"] = _param_digests(trainer)
        turn["ms"] = _route_ms(times, drain_s)
        turn["cross"] = trainer._cross_driver is not None

    env = {"BPS_ENABLE_PS": "1", "BPS_COMPRESS": codec}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    bps.init()                  # the in-process server, at world 1
    try:
        # no steps past the counted window but the profiled one: the PS
        # step is host-bound and long (steps 2-3 give its time)
        # fp8's profiled step (15-20 s of host codec) is left out for the
        # full run's time limit; int8's carries the codec kernels' times
        launches, trainer, losses, metrics = run_path(
            tag, cfg, loss_fn, data, fps, want, more_steps=0, setup=setup,
            after_counted=after_counted, profile=codec == "int8")
        ex = trainer.ps_exchange
        nc, nb = ex.n_compressed(), len(next(iter(ex._plans.values()))[1])
        dense_bytes = 4 * sum(p.numel() for p in trainer.model.parameters())
        d2h = metrics["ps/d2h_bytes"] / STEPS
        log(f"[{tag}] plan: {nb} buckets, {nc} compressed; per step "
            f"ps/d2h_bytes {d2h:.0f} = {d2h / dense_bytes:.4f} x the dense "
            f"gradient bytes {dense_bytes}; ps/push_bytes "
            f"{metrics['ps/push_bytes'] / STEPS:.0f}, ps/pull_bytes "
            f"{metrics['ps/pull_bytes'] / STEPS:.0f}")
        stages = {k[6:]: v for k, v in metrics.items()
                  if k.startswith("stage/") and v["count"]}
        log(f"[{tag}] host stage times over the {STEPS} counted steps "
            "(summed over buckets and pipeline threads): " + ", ".join(
                f"{k} {v['sum_ms']:.1f} ms / {v['count']}"
                for k, v in sorted(stages.items())))
        in_bwd = _log_overlap(tag, metrics, STEPS)
        if not turn["cross"] or not trainer._chunked.decomposable:
            raise AssertionError(f"{tag}: the default route did not engage "
                                 "the chunked apply and the cross-step driver")
        if not d2h < 0.3 * dense_bytes:
            raise AssertionError(f"{tag}: {d2h} bytes a step crossed to the "
                                 "host, not the payloads alone")
        log(f"[{tag}] step-1 loss {losses[0]:.6f}, dense run "
            f"{dense_losses[0]:.6f}; step 2 {losses[1]:.6f}, dense run "
            f"{dense_losses[1]:.6f} (|diff| {abs(losses[1] - dense_losses[1]):.3e}"
            f", tolerance {PS_STEP2_TOL})")
        if losses[0] != dense_losses[0]:
            raise AssertionError(f"{tag}: step-1 loss differs from the dense "
                                 "run's on the same weights and batch")
        if not abs(losses[1] - dense_losses[1]) <= PS_STEP2_TOL:
            step2_misses.append(tag)
        check_ps_encode(trainer, loss_fn, data, tag)
        del trainer
        torch.cuda.empty_cache()
        mono = _ps_monolithic_turn(tag, cfg, loss_fn, data, launches, losses,
                                   turn)
        SUMMARY[tag].update({"route_ms": turn["ms"],
                             "monolithic_route_ms": SUMMARY[tag + " =0"],
                             "push_bytes_in_backward": in_bwd})
        return launches, mono
    finally:
        bps.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _ps_monolithic_turn(tag, cfg, loss_fn, data, launches, losses, default):
    """The monolithic route (``BPS_APPLY_CHUNKED=0``) on the weights and
    batch the default route just trained: ``STEPS`` steps with every count
    zeroed before; the launches, the losses, step 1's payload digests and
    the parameters after the steps must be the default route's."""
    import os

    import byteps_tpu_torch as bps
    # a fresh server and registry: the trainer's keys, and with them the
    # fp8 noise seeds, are the default route's
    bps.shutdown()
    bps.init()
    os.environ["BPS_APPLY_CHUNKED"] = "0"
    try:
        trainer = _ps_trainer(cfg, loss_fn)
    finally:
        os.environ.pop("BPS_APPLY_CHUNKED")
    payloads = _StepOnePayloads(trainer.ps_exchange.backend)
    torch.cuda.synchronize()
    ctr = counters()
    zero_counts(ctr)
    got, times = [], []
    try:
        for _ in range(STEPS):
            loss, dt = _timed_step(trainer, data)
            got.append(loss)
            times.append(dt)
    finally:
        payloads.remove()
    mono = read_counts(ctr)
    ms = _route_ms(times, 0.0)
    SUMMARY[tag + " =0"] = ms
    digests = payloads.by_bucket(trainer.ps_exchange)
    params = _param_digests(trainer)
    del trainer
    torch.cuda.empty_cache()
    same_params = params == default["params"]
    same_payloads = digests == default["payload_digests"] \
        and None not in digests
    log(f"[{tag}] routes in turns, steps 2-3 a step (the last tail "
        f"drained): default {default['ms']:.1f} ms, BPS_APPLY_CHUNKED=0 "
        f"{ms:.1f} ms ({card_line()}); =0 losses {got}")
    log(f"[{tag}] after {STEPS} steps the parameters of the two routes: "
        f"{'bit for bit' if same_params else 'DIFFERENT'}; step 1's "
        f"{len(digests)} payloads: "
        f"{'the same bytes' if same_payloads else 'DIFFERENT'}; "
        f"launches {'the same' if mono == launches else 'DIFFERENT'}")
    if not same_params or not same_payloads or got != losses:
        raise AssertionError(f"{tag}: the monolithic route differs from the "
                             "default route on the same weights and batch")
    if mono != launches:
        raise AssertionError(f"{tag}: launches {mono} on the monolithic "
                             f"route, {launches} on the default route")
    return mono


# the running mean of PS accumulation on the card: the JAX package's
# acc + (g - acc) / n, checked at n = 2 and 3 against numpy on the same
# gradients (CUDA divides by a host scalar as a product with its
# reciprocal, which can round apart from numpy's quotient)
ACCUM_K, ACCUM_MICRO = 2, 4


class _Window:
    def __init__(self, k):
        self.backward_passes_per_step, self.step_count, self._accum = k, 0, None


def _running_mean_np(gs):
    acc = gs[0]
    for n, g in enumerate(gs[1:], 2):
        acc = acc + (g - acc) / n
    return acc


def check_running_mean():
    """``DistributedTrainer._accumulate`` on the card at k = 3 (the divisor
    3 is not a power of two) against numpy's running mean, bit for bit."""
    from byteps_tpu_torch.training import DistributedTrainer
    rng = np.random.RandomState(11)
    gs = [(rng.randn(1 << 20) * 10.0 ** e).astype(np.float32)
          for e in (-2, 1, 3)]
    w = _Window(3)
    res = None
    for g in gs:
        res = DistributedTrainer._accumulate(w, [torch.from_numpy(g).cuda()])
    got = res[0].cpu().numpy()
    want = _running_mean_np(gs)
    same = got.tobytes() == want.tobytes()
    log(f"[accumulate] running mean of 3 gradients of 2^20 floats on the "
        f"card vs numpy: {'bit for bit' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the running mean on the card differs from the "
                             "JAX package's order of operations in numpy")


def train_bert_ps_accum(dense_losses, layers=None):
    """BERT-large PS int8 with ``backward_passes_per_step=2``: ACCUM_MICRO
    micro-steps on two batches in turn, one exchange a window through the
    streamed tail (the staged head stays off): the flash launches of every
    micro-step, the codec launches of ACCUM_MICRO / ACCUM_K rounds, step
    1's loss the dense run's, and at each window's end the exchanged mean
    of two leaves bit for bit numpy's running mean of the same
    gradients. ``layers``: the cut depth, ``dense_losses`` the dense run's
    at that depth."""
    from byteps_tpu_torch.models import bert
    cfg, loss_fn, data, _ = _bert_setup(layers=layers)
    tag = "bert_large ps int8 accum2"
    check_running_mean()
    other = bert.synth_mlm_batch(np.random.RandomState(1), TRAIN_BATCH,
                                 BERT_SEQ, cfg.vocab_size)
    attn = _attention_launches(cfg, ("flash_bwd_fused",))
    with _ps_world({"BPS_COMPRESS": "int8"}):
        trainer = _ps_trainer(cfg, loss_fn,
                              backward_passes_per_step=ACCUM_K)
        names = ("embed.pos", "blocks.ln1.scale")
        idx = [i for i, (n, _) in enumerate(trainer._ps_params)
               if n in names]
        seen, accumulate = [], trainer._accumulate

        def recording(grads):
            gin = [grads[i].detach().cpu().numpy() for i in idx]
            out = accumulate(grads)
            seen.append((gin, None if out is None else
                         [out[i].detach().cpu().numpy() for i in idx]))
            return out

        trainer._accumulate = recording
        torch.cuda.synchronize()
        ctr = counters()
        zero_counts(ctr)
        losses, times = [], []
        for i in range(ACCUM_MICRO):
            loss, dt = _timed_step(trainer, data if i % 2 == 0 else other)
            losses.append(loss)
            times.append(dt)
        launches = read_counts(ctr)
        nc = trainer.ps_exchange.n_compressed()
        want = {k: v * ACCUM_MICRO // STEPS
                for k, v in attn(trainer).items()}
        want["int8_quantize"] = want["int8_dequantize"] = \
            ACCUM_MICRO // ACCUM_K * nc
        staged = trainer._staged_route()
        del trainer
    torch.cuda.empty_cache()
    exact = []
    for w in range(ACCUM_MICRO // ACCUM_K):
        window = seen[w * ACCUM_K:(w + 1) * ACCUM_K]
        out = window[-1][1]
        for j in range(len(idx)):
            want_mean = _running_mean_np([g[j] for g, _ in window])
            exact.append(out[j].tobytes() == want_mean.tobytes())
    log(f"[{tag}] losses {losses}; micro-step times s {times} "
        f"({card_line()}); launches {launches}; the exchanged means of "
        f"{names} at each window's end vs numpy: "
        f"{'bit for bit' if all(exact) else 'DIFFERENT'}")
    if staged or not all(exact) or losses[0] != dense_losses[0] \
            or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag}: staged {staged}, exact {exact}, "
                             f"losses {losses}")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    SUMMARY[tag] = {"micro_step_ms": [t * 1e3 for t in times]}
    return launches


# -------------------- compression on the PS side: chains, auto, watchdog

# ps/push_bytes of the onebit chains against a dense PS run's, which pushes
# every bucket dense: the gradient's bytes (onebit is 1/32 a bucket and a
# 4-byte scale; the buckets under BPS_MIN_COMPRESS_BYTES stay dense)
PS_ONEBIT_BYTES = 1 / 25
# the auto run on injected signals: nic/stalls raised by this much before
# each of the first rounds (a fixed schedule), then not at all; the ladder
# capped at fp8_e4m3 (BPS_COMPRESS_MAX)
AUTO_STALLS, AUTO_STALL_ROUNDS, AUTO_MAX = 1, 6, "fp8_e4m3"
AUTO_MAX_ROUNDS = 16        # decay rounds the boundary verdict may add
AUTO_LIVE_ROUNDS = STEPS
# the watchdog path: BPS_WATCHDOG_SEC, and the pull held 3 periods
WATCHDOG_SEC, WATCHDOG_HOLD = 2.0, 3


@contextlib.contextmanager
def _ps_world(env):
    """``env`` set and ``bps.init()`` (the in-process server, world 1) for
    one PS run; ``bps.shutdown()`` and the env restored after it."""
    import os

    import byteps_tpu_torch as bps
    env = dict({"BPS_ENABLE_PS": "1"}, **env)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    bps.init()
    try:
        yield
    finally:
        bps.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _ps_trainer(cfg, loss_fn, compression=None, **kw):
    """BERT-large from seed 0 through ``DistributedTrainer`` in PS mode,
    the metrics registry zeroed just before it is built."""
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.obs.metrics import get_registry
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    get_registry().reset()
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    return DistributedTrainer(loss_fn, model, adamw(model.parameters(), 1e-4),
                              partition_bytes=PARTITION_BYTES,
                              compression=compression,
                              min_compress_bytes=MIN_COMPRESS_BYTES, **kw)


def _timed_step(trainer, data):
    """One whole step: on the cross-step route its tail too, so the
    launches and the metrics read after it are the step's."""
    t = time.perf_counter()
    loss = trainer.step(data)
    _drain(trainer)
    torch.cuda.synchronize()
    return loss.item(), time.perf_counter() - t


def _log_stages(tag, metrics, steps):
    stages = {k[6:]: v for k, v in metrics.items()
              if k.startswith("stage/") and v["count"]}
    log(f"[{tag}] host stage times over the {steps} counted steps (summed "
        "over buckets and pipeline threads): " + ", ".join(
            f"{k} {v['sum_ms']:.1f} ms / {v['count']}"
            for k, v in sorted(stages.items())))


class _FirstExchange:
    """Keeps the first exchange's gradients, copied to the host as they
    reach it, and its summed result: on the monolithic route by wrapping
    ``PSGradientExchange.exchange``, on the default route the first
    ingest round's ``feed`` and ``ready_iter`` (the wrappers add copies to
    step 1 and nothing to later steps)."""

    def __init__(self):
        from byteps_tpu_torch.server import ps_mode
        ex_cls, rnd_cls = ps_mode.PSGradientExchange, ps_mode._Round
        self.orig = [(ex_cls, "exchange", ex_cls.exchange),
                     (ex_cls, "exchange_ingest", ex_cls.exchange_ingest),
                     (rnd_cls, "feed", rnd_cls.feed),
                     (rnd_cls, "ready_iter", rnd_cls.ready_iter)]
        self.grads = self.out = self.first = None
        kept = self
        exchange, ingest, feed, ready_iter = (f for _, _, f in self.orig)

        def exchange_(ex, tree, name=None):
            tree = list(tree)
            first = kept.grads is None
            if first:
                kept.grads = [t.detach().to("cpu", copy=True).numpy()
                              .reshape(-1) for _, t in tree]
            out = exchange(ex, tree, name)
            if first:
                kept.out = [np.array(o, copy=True).reshape(-1) for o in out]
            return out

        def ingest_(ex, template, *a, **kw):
            h = ingest(ex, template, *a, **kw)
            if kept.grads is None:
                kept.first = h.round_state
                kept.grads = [None] * len(template)
                kept.out = [None] * len(template)
            return h

        def feed_(rnd, leaf_ids, values, events=None):
            if rnd is kept.first:      # autograd's thread, its own stream
                for li, v in zip(leaf_ids, values):
                    kept.grads[li] = v.detach().to("cpu", copy=True) \
                        .numpy().reshape(-1)
            return feed(rnd, leaf_ids, values, events)

        def ready_iter_(rnd, timeout=None):
            for li, arr in ready_iter(rnd, timeout):
                if rnd is kept.first:
                    kept.out[li] = np.array(arr, copy=True).reshape(-1)
                yield li, arr
            if rnd is kept.first:
                kept.first = None

        for (cls, name, _), fn in zip(self.orig, (exchange_, ingest_, feed_,
                                                  ready_iter_)):
            setattr(cls, name, fn)

    def restore(self):
        for cls, name, fn in self.orig:
            setattr(cls, name, fn)
        self.first = None


def replay_chains(ex, grads, kwargs):
    """Step 1's summed gradient as the chains give it, in numpy, off the
    exchange (no server, no threads): each bucket packed from the dense
    gradient; a chained bucket through a fresh worker chain, the server
    chain's decompress (the world-1 sum is that one push), its recompress,
    and the worker chain's decompress; the others as they are."""
    import os

    from byteps_tpu_torch.ops.compression.host import (create_host_chain,
                                                       create_server_chain)
    (_, keyed), = ex._plans.values()
    out = [np.empty_like(g) for g in grads]
    old = os.environ.get("BPS_NATIVE_CODEC")
    os.environ["BPS_NATIVE_CODEC"] = "0"         # the numpy route
    try:
        for pskey, b in keyed:
            buf = np.empty(b.size, b.dtype)
            for s in b.segments:
                buf[s.bucket_offset:s.bucket_offset + s.length] = \
                    grads[s.leaf_index][s.leaf_offset:s.leaf_offset + s.length]
            if pskey in ex._chains:
                worker = create_host_chain(kwargs, b.size, b.dtype)
                server = create_server_chain(kwargs, b.size, b.dtype)
                merged = server.decompress(worker.compress(buf))
                buf = worker.decompress(server.compress(merged)).astype(
                    b.dtype, copy=False)
            for s in b.segments:
                out[s.leaf_index][s.leaf_offset:s.leaf_offset + s.length] = \
                    buf[s.bucket_offset:s.bucket_offset + s.length]
    finally:
        if old is None:
            os.environ.pop("BPS_NATIVE_CODEC", None)
        else:
            os.environ["BPS_NATIVE_CODEC"] = old
    return out


def train_bert_ps_onebit(dense_losses, layers=None):
    """BERT-large through the PS path with the README's onebit kwargs in
    the legacy chains (``DistributedTrainer(compression=...)``): each
    bucket at or above the floor copied to the host dense, compressed by
    the worker chain (momentum, error feedback, onebit), decompressed,
    summed and recompressed by the server chain, decompressed by the
    worker. No kernel of the card runs in the exchange: the flash launches
    are dense BERT's. ``layers``: the cut depth, ``dense_losses`` the dense
    run's at that depth."""
    cfg, loss_fn, data, fps = _bert_setup(layers=layers)
    tag = "bert_large ps onebit"
    want = _attention_launches(cfg, ("flash_bwd_fused",))
    first = _FirstExchange()
    with _ps_world({}):
        try:
            launches, trainer, losses, metrics = run_path(
                tag, cfg, loss_fn, data, fps, want,
                compression=README_COMPRESSION, more_steps=0)
        finally:
            first.restore()
        ex = trainer.ps_exchange
        (_, keyed), = ex._plans.values()
        dense_bytes = 4 * sum(p.numel() for p in trainer.model.parameters())
        pushed = metrics["ps/push_bytes"] / STEPS
        log(f"[{tag}] plan: {len(keyed)} buckets, {ex.n_chained()} through "
            f"the chains, {ex.n_compressed()} on the fused plane; per step "
            f"ps/push_bytes {pushed:.0f} = {pushed / dense_bytes:.5f} x the "
            f"dense PS run's {dense_bytes} (limit {PS_ONEBIT_BYTES:.3f}); "
            f"ps/pull_bytes {metrics['ps/pull_bytes'] / STEPS:.0f}, "
            f"ps/d2h_bytes {metrics['ps/d2h_bytes'] / STEPS:.0f}")
        _log_stages(tag, metrics, STEPS)
        if not pushed <= PS_ONEBIT_BYTES * dense_bytes:
            raise AssertionError(f"{tag}: {pushed} bytes pushed a step, over "
                                 f"{PS_ONEBIT_BYTES} of the dense {dense_bytes}")
        if ex.n_chained() < len(keyed) - 2 or ex.n_compressed():
            raise AssertionError(f"{tag}: {ex.n_chained()} of {len(keyed)} "
                                 "buckets took the chains")
        log(f"[{tag}] step-1 loss {losses[0]:.6f}, dense run "
            f"{dense_losses[0]:.6f}")
        if losses[0] != dense_losses[0]:
            raise AssertionError(f"{tag}: step-1 loss differs from the dense "
                                 "run's on the same weights and batch")
        t = time.perf_counter()
        ref = replay_chains(ex, first.grads, README_COMPRESSION)
        same = all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                   for a, b in zip(first.out, ref))
        log(f"[{tag}] step 1's summed gradient as the worker received it vs "
            f"the chains replayed in numpy on the same dense gradient "
            f"({sum(g.size for g in ref)} floats, {time.perf_counter() - t:.1f}"
            f" s): {'bit for bit' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{tag}: the exchange's step-1 sum is not the "
                                 "chains' numpy replay, bit for bit")
        first.grads = first.out = ref = None
        del trainer
        torch.cuda.empty_cache()
    return launches


class _Decisions:
    """Records every decision of an exchange's ``CompressController``: the
    signals it read (the two counters, the backlog gauge, each layer's
    ``ps/push_bytes``) and each layer's level after it."""

    def __init__(self, ctl, reg):
        self.ctl, self.rows = ctl, []
        self.start = (ctl._last_stalls, ctl._last_resends)
        orig = ctl.decide_locked

        def decide_locked():
            sig = {"stalls": reg.counter("nic/stalls").value,
                   "resends": reg.counter("transport/resends").value,
                   "depth": reg.gauge("server/engine_queue_depth").value,
                   "bytes": {n: c.value for n, c in ctl._bytes.items()}}
            orig()
            self.rows.append((sig, dict(ctl._layers)))

        ctl.decide_locked = decide_locked

    def replay(self):
        """The same decisions by a fresh ``CompressController`` over a
        fresh registry fed the recorded signals: (verdicts, levels)."""
        from byteps_tpu_torch.compress.controller import CompressController
        from byteps_tpu_torch.obs.metrics import MetricsRegistry
        live, reg = self.ctl, MetricsRegistry()
        reg.counter("nic/stalls").inc(self.start[0])
        reg.counter("transport/resends").inc(self.start[1])
        rep = CompressController(registry=reg, max_level=wire_name(
            live.max_level), hold=live.hold,
            queue_depth_min=live.queue_depth_min, interval=live.interval)
        for layer in live._layers:
            rep.register_layer(layer)
        verdicts, levels, v0 = [], [], rep._verdict

        def verdict():
            verdicts.append(v0())
            return verdicts[-1]

        rep._verdict = verdict
        for sig, _ in self.rows:
            for name in ("stalls", "resends"):
                c = reg.counter({"stalls": "nic/stalls",
                                 "resends": "transport/resends"}[name])
                c.inc(sig[name] - c.value)
            reg.gauge("server/engine_queue_depth").set(sig["depth"])
            for layer, v in sig["bytes"].items():
                c = reg.counter(f"ps/push_bytes/{layer}")
                c.inc(v - c.value)
            levels.append(rep.decide())
        return verdicts, levels, reg.counter("compress/decisions").value


def wire_name(cid):
    from byteps_tpu_torch.compress import wire
    return wire.LEVELS[cid]


def _level_counts(levels):
    """{level name: layers at it} of one round."""
    out = {}
    for lv in levels.values():
        out[wire_name(lv)] = out.get(wire_name(lv), 0) + 1
    return out


def _auto_run(tag, cfg, loss_fn, data, dense_losses, rounds, inject=None,
              until_back=False):
    """One ``BPS_COMPRESS=auto`` run: ``rounds`` steps (with
    ``until_back``, up to ``AUTO_MAX_ROUNDS``, stopping once the ladder
    has climbed and come back to none), ``inject(r)`` before round ``r``.
    Every count zeroed before the run, read after it and after each round.
    Gates: the level trace is the replay's, each round's codec launches
    are its eligible buckets at that round's rung, the decisions counter
    is the level changes, step 1 the dense run's loss. Returns the run's
    launches and its trace."""
    from byteps_tpu_torch.compress import wire
    from byteps_tpu_torch.obs.metrics import get_registry
    trainer = _ps_trainer(cfg, loss_fn)
    ex = trainer.ps_exchange
    reg = get_registry()
    rec = _Decisions(ex._cplane.controller, reg)
    attn = _attention_launches(cfg, ("flash_bwd_fused",))(trainer)
    per_step = {k: v // STEPS for k, v in attn.items()}
    torch.cuda.synchronize()
    ctr = counters()
    zero_counts(ctr)
    prev, losses, times, per_round = read_counts(ctr), [], [], []
    for r in range(1, AUTO_MAX_ROUNDS + 1 if until_back else rounds + 1):
        if inject is not None:
            inject(r)
        loss, dt = _timed_step(trainer, data)
        losses.append(loss)
        times.append(dt)
        now = read_counts(ctr)
        per_round.append({k: now[k] - prev[k] for k in now})
        prev = now
        top = max(rec.rows[-1][1].values())
        if until_back and r >= rounds and top == wire.CODEC_NONE:
            break
    launches = read_counts(ctr)
    metrics = reg.snapshot()
    verdicts, replayed, rep_decisions = rec.replay()
    trace = [lv for _, lv in rec.rows]
    for r, ((sig, lv), v, dt) in enumerate(zip(rec.rows, verdicts, times), 1):
        log(f"[{tag}] round {r}: queue depth {sig['depth']:g}, nic/stalls "
            f"{sig['stalls']}, transport/resends {sig['resends']}, verdict "
            f"{ {True: 'wire-bound', False: 'idle', None: 'boundary'}[v]}, "
            f"levels {_level_counts(lv)}; step {dt * 1e3:.1f} ms, loss "
            f"{losses[r - 1]:.6f}")
    changes = sum(a != b for prev_lv, cur in
                  zip([dict.fromkeys(trace[0], 0)] + trace, trace)
                  for a, b in ((prev_lv[k], cur[k]) for k in cur))
    decisions = metrics["compress/decisions"]
    log(f"[{tag}] {len(trace)} rounds, level trace equals the replay: "
        f"{trace == replayed}; compress/decisions {decisions}, level "
        f"changes {changes}, replay's counter {rep_decisions}; "
        f"{len(trace[0])} layers")
    _log_stages(tag, metrics, len(trace))
    if trace != replayed:
        raise AssertionError(f"{tag}: the level trace differs from the "
                             "replay of the recorded signals")
    if not decisions == changes == rep_decisions:
        raise AssertionError(f"{tag}: compress/decisions {decisions}, level "
                             f"changes {changes}, replay {rep_decisions}")
    for r, (got, lv) in enumerate(zip(per_round, trace), 1):
        want = dict.fromkeys(COUNT_KEYS, 0)
        want.update(per_step)
        want = by_width(want, cfg.head_dim)
        n_int8 = sum(v == wire.CODEC_INT8 for v in lv.values())
        want["int8_quantize"] = want["int8_dequantize"] = n_int8
        want["fp8_sr_quantize"] = sum(v == wire.CODEC_FP8_E4M3
                                      for v in lv.values())
        if got != want:
            raise AssertionError(f"{tag}: round {r} launches {got}, expected "
                                 f"{want}")
    if losses[0] != dense_losses[0] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag}: losses {losses}, dense step 1 "
                             f"{dense_losses[0]}")
    log(f"[{tag}] launches {launches}")
    del trainer
    torch.cuda.empty_cache()
    return launches, trace, times


def train_bert_ps_auto(dense_losses):
    """``BPS_COMPRESS=auto`` on BERT-large at ``CUT_LAYERS`` through the PS
    path (``dense_losses``: the dense run's at that depth), two runs.
    (a) live signals: at world 1 in one process nothing raises nic/stalls
    or transport/resends, so the backlog gauge alone votes; the trace may
    stay at none. (b) signals injected: nic/stalls raised before each of
    the first AUTO_STALL_ROUNDS rounds, then not, the ladder capped at
    fp8_e4m3: it climbs none -> fp16 -> int8 -> fp8_e4m3 and, where the
    backlog reads 0, decays back."""
    from byteps_tpu_torch.compress import wire
    from byteps_tpu_torch.obs.metrics import get_registry
    cfg, loss_fn, data, _ = _bert_setup(layers=CUT_LAYERS)
    with _ps_world({"BPS_COMPRESS": "auto"}):
        live, _, live_times = _auto_run(
            "bert_large ps auto (a) live signals", cfg, loss_fn, data,
            dense_losses, AUTO_LIVE_ROUNDS)

    def inject(r):
        if r <= AUTO_STALL_ROUNDS:
            get_registry().counter("nic/stalls").inc(AUTO_STALLS)

    tag = "bert_large ps auto (b) signals injected"
    with _ps_world({"BPS_COMPRESS": "auto", "BPS_COMPRESS_MAX": AUTO_MAX}):
        injected, trace, times = _auto_run(tag, cfg, loss_fn, data,
                                           dense_losses, 2 * AUTO_STALL_ROUNDS,
                                           inject=inject, until_back=True)
    tops = [max(lv.values()) for lv in trace]
    climbed = [wire.CODEC_NONE, wire.CODEC_FP16, wire.CODEC_INT8,
               wire.CODEC_FP8_E4M3]
    seen = [lv for i, lv in enumerate(tops) if i == 0 or lv != tops[i - 1]]
    log(f"[{tag}] rungs in order {[wire_name(t) for t in seen]}")
    if seen[:4] != climbed:
        raise AssertionError(f"{tag}: the ladder went {seen}, not none -> fp16"
                             " -> int8 -> fp8_e4m3")
    SUMMARY["bert_large_ps_auto"] = {
        "live_step_ms": [t * 1e3 for t in live_times],
        "injected_step_ms": {wire_name(lv): [t * 1e3 for t, top in
                                             zip(times, tops) if top == lv]
                             for lv in sorted(set(tops))}}
    log(f"[{tag}] step ms by rung: {SUMMARY['bert_large_ps_auto']}")
    return live, injected


class PullHold:
    """Fault injection: the backend's pull of one PS key waits ``hold_s``
    seconds before it is served, once, when armed. It stands for a lost
    or late pull, the wedge the stall watchdog exists to name."""

    def __init__(self, backend, key, hold_s):
        self.backend, self.key, self.hold_s = backend, key, hold_s
        self.armed, self.t_hold = False, None
        self.orig = {n: getattr(backend, n) for n in ("pull", "pull_fused")}
        for name, fn in self.orig.items():
            setattr(backend, name, self._held(fn))

    def _held(self, fn):
        def pull(key, *a, **kw):
            if self.armed and key == self.key:
                self.armed = False
                self.t_hold = time.monotonic()
                time.sleep(self.hold_s)
            return fn(key, *a, **kw)
        return pull

    def remove(self):
        for name, fn in self.orig.items():
            setattr(self.backend, name, fn)


def train_bert_ps_watchdog(dense_losses):
    """BERT-large at ``CUT_LAYERS`` (``dense_losses``: the dense run's at
    that depth) through the PS path under int8 with BPS_WATCHDOG_SEC=2.
    An unwedged run of 5 steps (no dump) is the reference; then the path:
    3 steps (no dump), then step 4 with the pull of the last bucket held
    WATCHDOG_HOLD periods by ``PullHold``: the dump names that key within
    2 periods of the hold, with its push in the flight events, and step 4
    completes; steps 4 and 5 have the unwedged run's losses, bit for bit."""
    from byteps_tpu_torch.common.global_state import GlobalState
    from byteps_tpu_torch.obs.watchdog import implicated_keys
    cfg, loss_fn, data, _ = _bert_setup(layers=CUT_LAYERS)
    tag = "bert_large ps watchdog"
    env = {"BPS_COMPRESS": "int8", "BPS_WATCHDOG_SEC": str(WATCHDOG_SEC)}
    with _ps_world(env):
        ref = _ps_trainer(cfg, loss_fn)
        ref_losses = [_timed_step(ref, data)[0] for _ in range(5)]
        ref_dumps = ref.ps_exchange._watchdog.dumps
        del ref
    log(f"[{tag}] unwedged run: losses {ref_losses}, watchdog dumps "
        f"{ref_dumps}")
    if ref_dumps:
        raise AssertionError(f"{tag}: the unwedged run dumped {ref_dumps}x")
    attn = _attention_launches(cfg, ("flash_bwd_fused",))
    with _ps_world(env):
        trainer = _ps_trainer(cfg, loss_fn)
        ex = trainer.ps_exchange
        torch.cuda.synchronize()
        ctr = counters()
        zero_counts(ctr)
        losses, times = [], []
        for _ in range(STEPS):
            loss, dt = _timed_step(trainer, data)
            losses.append(loss)
            times.append(dt)
        wd = ex._watchdog
        if wd is None or wd.stall_sec != WATCHDOG_SEC or wd.dumps:
            raise AssertionError(f"{tag}: watchdog {wd} after {STEPS} steps")
        dumps = []
        wd._on_dump = lambda state, stalled: dumps.append(
            (time.monotonic(), state, stalled))
        (_, keyed), = ex._plans.values()
        key = keyed[-1][0]
        hold = PullHold(GlobalState.get().ps_backend, key,
                        WATCHDOG_HOLD * WATCHDOG_SEC)
        hold.armed = True
        try:
            for _ in range(2):
                loss, dt = _timed_step(trainer, data)
                losses.append(loss)
                times.append(dt)
        finally:
            hold.remove()
        n = len(losses)
        launches = read_counts(ctr)
        nc = ex.n_compressed()
        want = attn(trainer)
        want = {k: v * n // STEPS for k, v in want.items()}
        want["int8_quantize"] = want["int8_dequantize"] = n * nc
        del trainer
    torch.cuda.empty_cache()
    log(f"[{tag}] losses {losses}; step times s {times}; held key {key} "
        f"for {WATCHDOG_HOLD * WATCHDOG_SEC:.0f} s in step 4")
    if hold.t_hold is None or not dumps:
        raise AssertionError(f"{tag}: hold {hold.t_hold}, dumps {len(dumps)}")
    t_dump, state, stalled = dumps[0]
    after = t_dump - hold.t_hold
    keys = implicated_keys(state)
    wedged = [b for r in state["rounds"] for b in r["buckets"]
              if b["pskey"] == key]
    pushes = [e for e in state["flight"]["events"]
              if e["kind"] == "push" and e.get("key") == key]
    log(f"[{tag}] first dump {after:.2f} s after the hold began (stalled "
        f"{stalled:.2f} s; limit {2 * WATCHDOG_SEC:.0f} s), {len(dumps)} "
        f"dump(s); it names keys {sorted(keys)}, the held bucket "
        f"{wedged[0]['state'] if wedged else 'absent'}, its flight events "
        f"{[(e['kind'], e.get('round'), e.get('stage')) for e in pushes]}")
    if not after <= 2 * WATCHDOG_SEC or key not in keys or not wedged \
            or wedged[0]["state"] != "pushed":
        raise AssertionError(f"{tag}: the dump did not name key {key} "
                             f"within {2 * WATCHDOG_SEC} s")
    if not any(e.get("round") == wedged[0]["round"] for e in pushes):
        raise AssertionError(f"{tag}: the dump's flight events lack key "
                             f"{key}'s push of round {wedged[0]['round']}")
    if losses != ref_losses or losses[0] != dense_losses[0]:
        raise AssertionError(f"{tag}: losses {losses}, unwedged {ref_losses}")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    SUMMARY["bert_large_ps_watchdog"] = {"step_ms": [t * 1e3 for t in times],
                                         "dump_after_s": after}
    return launches


# --------------------------- the BytePS API: the plugin and push_pull paths

# the tensors whose step-1 exchange the int8 push_pull path holds against
# the plain versions: the embedding gradients, the final layer norm, and
# of the stacked [layers, ...] block tensors the attention output and the
# small ones (a block is a slice of each); the fp8 path's trees of them
API_CHECK = ("embed.pos", "embed.tok", "final_ln.bias", "final_ln.scale",
             "blocks.attn_out", "blocks.ln1.bias", "blocks.ln1.scale",
             "blocks.mlp_out_b")
API_CHECK_TREES = ("embed", "block0")


def _api_model(cfg):
    """The dense BERT run's model and optimizer: the same seed-0 weights,
    AdamW(1e-4) made before the move to the card, as the trainer gets
    them."""
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.optim import adamw
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    opt = adamw(model.parameters(), 1e-4)
    return model.to("cuda"), opt


def _api_rates(step_s, fps):
    from byteps_tpu_torch.models.flops import mfu
    sps = TRAIN_BATCH / step_s
    util = mfu(sps, fps)
    return (f"{step_s * 1e3:.1f} ms = {sps:.2f} samples/s, "
            f"{sps * fps / 1e12:.1f} model TFLOP/s, mfu "
            + ("not known for this card" if util is None else f"{util:.4f}"))


def run_api_path(tag, step, want, fps, more_steps=STEPS):
    """``STEPS`` counted steps of ``step(i) -> (loss, api_s)`` (the API's
    own host time of the step) with every launch counter zeroed just
    before and read just after; finite falling losses, the counts
    ``want()``; then ``more_steps`` more for the step time. Returns
    (launches, losses, metrics)."""
    from byteps_tpu_torch.obs.metrics import get_registry
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctr = counters()
    zero_counts(ctr)
    get_registry().reset()
    losses, times, api = [], [], []
    for i in range(STEPS):
        t = time.perf_counter()
        loss, a = step(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
        api.append(a)
    launches = read_counts(ctr)
    metrics = get_registry().snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{tag}] losses {losses}")
    log(f"[{tag}] step times s {times}; API host s a step {api}; peak "
        f"memory {peak_gb:.2f} GB; fastest of steps 2-3: "
        f"{_api_rates(min(times[1:]), fps)}")
    log(f"[{tag}] kernel launches in the {STEPS} steps: {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    expected = want()
    if launches != expected:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"{expected}")
    more, more_api = [], []
    for i in range(more_steps):
        t = time.perf_counter()
        _, a = step(STEPS + i)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t)
        more_api.append(a)
    if more:
        log(f"[{tag}] steps {STEPS + 1}-{STEPS + more_steps} s {more}, API "
            f"host s {more_api}: median {_api_rates(statistics.median(more), fps)}")
    step_s = statistics.median(more) if more else min(times[1:])
    api_s = statistics.median(more_api) if more else min(api[1:])
    SUMMARY[tag] = {"step_ms": step_s * 1e3,
                    "samples_per_s": TRAIN_BATCH / step_s,
                    "api_host_ms": api_s * 1e3, "peak_gb": peak_gb,
                    "losses": losses}
    log(f"[{tag}] step {step_s * 1e3:.1f} ms, {TRAIN_BATCH / step_s:.2f} "
        f"samples/s, the API's host time {api_s * 1e3:.1f} ms a step "
        f"(dispatch to the last synchronize), on {card_line()}")
    return launches, losses, metrics


def train_bert_plugin(dense_losses):
    """BERT-large through the torch plugin, the reference's way: the
    optimizer wrapped by ``byteps_tpu_torch.torch.DistributedOptimizer``,
    parameters and optimizer state broadcast from rank 0 first. At world 1
    no hook is registered: the losses must be the dense run's, bit for
    bit (the same kernels and AdamW on the same weights and batch)."""
    import byteps_tpu_torch.torch as bt
    from byteps_tpu_torch.training import _to_device
    cfg, loss_fn, data, fps = _bert_setup()
    tag = "bert_large_plugin"
    bt.init()
    try:
        model, inner = _api_model(cfg)
        opt = bt.DistributedOptimizer(
            inner, named_parameters=model.named_parameters())
        bt.broadcast_parameters(model.state_dict(), 0)
        bt.broadcast_optimizer_state(opt, 0)
        batch = _to_device(data, "cuda")

        def step(i):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model, batch)
            loss.backward()
            t = time.perf_counter()
            opt.synchronize()
            api = time.perf_counter() - t
            with opt.skip_synchronize():
                opt.step()
            return loss.detach(), api

        launches, losses, _ = run_api_path(
            tag, step, lambda: _attention_launches(
                cfg, ("flash_bwd_fused",))(None), fps)
        log(f"[{tag}] losses {losses}, dense run {dense_losses}: "
            + ("bit for bit" if losses == dense_losses else "DIFFERENT"))
        if losses != dense_losses:
            raise AssertionError(f"{tag}: losses differ from the dense "
                                 "DistributedTrainer run's")
        del model, opt, inner
        torch.cuda.empty_cache()
        return launches
    finally:
        bt.shutdown()


def _layer_trees(model, layers):
    """The gradients as trees for the push_pull path: ``embed``, one per
    layer (``block{i}``: that layer's slice of every stacked block
    tensor) and ``final_ln``, in the forward's order."""
    trees = {}
    for n, p in model.named_parameters():
        head, rest = n.split(".", 1)
        if head == "blocks":
            for i in range(layers):
                trees.setdefault(f"block{i}", {})[rest] = p.grad[i]
        else:
            trees.setdefault(head, {})[rest] = p.grad
    first = [k for k in ("embed",) if k in trees]
    blocks = [f"block{i}" for i in range(layers)]
    return {k: trees[k] for k in first + blocks
            + sorted(set(trees) - set(first) - set(blocks))}


def _reference_exchange(codec, registry):
    """A second exchange on its own in-process server, its registry
    declared in the main one's order, encoding CPU tensors with the
    kernels' plain versions."""
    from byteps_tpu_torch.common.naming import NameRegistry
    from byteps_tpu_torch.server.engine import HostPSBackend
    from byteps_tpu_torch.server.ps_mode import PSGradientExchange
    reg = NameRegistry()
    for n in registry.declared_names():
        reg.declare(n)
    backend = HostPSBackend(num_servers=1, num_workers=1)
    ex = PSGradientExchange(backend, partition_bytes=PARTITION_BYTES,
                            registry=reg,
                            min_compress_bytes=MIN_COMPRESS_BYTES,
                            compress=codec, device=torch.device("cpu"))
    return backend, ex


def window_mbps(exchanges, now, window=None):
    """``get_pushpull_speed()`` at ``now``, modelled per exchange as
    ``telemetry.PushPullSpeed`` counts one: ``exchanges`` holds (start,
    done, bytes) of each, recorded at ``done`` and back-dated to its start
    (by at most 0.99 of the window); the reading is the bytes of those
    within the window of ``now`` over the time since the earliest of them.
    Returns (MB/s, how many exchanges are in the window)."""
    from byteps_tpu_torch.telemetry import WINDOW_SEC
    w = WINDOW_SEC if window is None else window
    ts = [(done - min(max(done - start, 0.0), 0.99 * w), n)
          for start, done, n in exchanges if done <= now]
    inside = [(t, n) for t, n in ts if now - t <= w]
    if not inside:
        return 0.0, 0
    span = max(now - min(t for t, _ in inside), 1e-6)
    return sum(n for _, n in inside) / span / 1e6, len(inside)


def _dense_losses(layers):
    """Two dense steps of BERT-large at ``layers`` layers (seed 0, the
    path's batch): the reference losses of a cut PS path."""
    cfg, loss_fn, data, _ = _bert_setup(layers=layers)
    trainer = _trainer(cfg, loss_fn)
    losses = [trainer.step(data).item() for _ in range(2)]
    log(f"[bert_large dense, {layers} of 24 layers] losses {losses}")
    del trainer
    torch.cuda.empty_cache()
    return losses


def train_bert_pushpull(codec, dense_losses, step2_misses, layers=None):
    """BERT-large through the BytePS API in PS mode (``BPS_ENABLE_PS=1``,
    ``BPS_COMPRESS=codec``, telemetry on). int8: every gradient through
    the plugin's ``push_pull_async_inplace`` in ``declare_model_keys``
    order, then ``synchronize`` on every handle. fp8: the gradients as
    trees through the top-level ``push_pull_async`` (the engine's
    deferred PS hop), then ``synchronize``. Then AdamW."""
    import os

    import byteps_tpu_torch as bps
    import byteps_tpu_torch.torch as bt
    from byteps_tpu_torch.common.global_state import GlobalState
    from byteps_tpu_torch.parallel.collectives import tree_flatten
    from byteps_tpu_torch.training import _to_device
    cfg, loss_fn, data, fps = _bert_setup(layers=layers)
    tag = f"bert_large_pushpull_{codec.split('_')[0]}"
    log(f"[{tag}] {cfg.layers} of 24 layers")
    env = {"BPS_ENABLE_PS": "1", "BPS_COMPRESS": codec,
           "BPS_TELEMETRY_ON": "1", "BPS_COMPRESS_DEVICE": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    bps.init()                  # the in-process server, at world 1
    try:
        gs = GlobalState.get()
        ex = gs.engine.ps_exchange
        model, opt = _api_model(cfg)
        params = dict(model.named_parameters())
        forward_pos = {n: i for i, n in enumerate(params)}
        if codec == "int8":
            bt.ops.declare_model_keys(params)
        batch = _to_device(data, "cuda")
        sent, got = {}, {}

        def exchange_tensors(first):
            names = [n for n in sorted(params) if params[n].grad is not None]
            if first:
                sent.update({n: params[n].grad.to("cpu", copy=True)
                             for n in API_CHECK})
            t = time.perf_counter()
            hs = []
            for n in names:
                # each exchange's own start and bytes, as the telemetry
                # counts it: it back-dates each to its handle's dispatch
                starts.append(time.time())
                hs.append(bt.push_pull_async_inplace(
                    params[n].grad, name="Gradient." + n,
                    priority=forward_pos[n]))
            for n, h in zip(names, hs):
                bt.synchronize(h)
                exchanges.append((starts[len(exchanges)], time.time(),
                                  params[n].grad.nbytes))
            api = time.perf_counter() - t
            if first:
                got.update({n: params[n].grad.to("cpu", copy=True)
                            for n in API_CHECK})
            return api

        def exchange_trees(first):
            trees = _layer_trees(model, cfg.layers)
            if first:
                sent.update({k: {n: g.to("cpu", copy=True)
                                 for n, g in trees[k].items()}
                             for k in API_CHECK_TREES})
            t = time.perf_counter()
            hs = [(k, bps.push_pull_async(tree, name="Gradient." + k))
                  for k, tree in trees.items()]
            outs = {k: bps.synchronize(h) for k, h in hs}
            api = time.perf_counter() - t
            with torch.no_grad():
                for k, out in outs.items():
                    for n, g in trees[k].items():
                        g.copy_(out[n])
            if first:
                got.update({k: {n: v.to("cpu", copy=True)
                                for n, v in outs[k].items()}
                            for k in API_CHECK_TREES})
            return api

        exchange = exchange_tensors if codec == "int8" else exchange_trees

        speed, read_at, starts, exchanges = [], [], [], []

        def step(i):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model, batch)
            loss.backward()
            api = exchange(i == 0)
            # read at once: a step longer than the 10 s window leaves
            # nothing in it a moment later
            speed.append(bps.get_pushpull_speed())
            read_at.append(time.time())
            opt.step()
            return loss.detach(), api

        attn = _attention_launches(cfg, ("flash_bwd_fused",))

        def want():
            w = attn(None)
            nc = ex.n_compressed()
            if codec == "int8":
                w["int8_quantize"] = w["int8_dequantize"] = STEPS * nc
            else:
                w["fp8_sr_quantize"] = STEPS * nc
            return w

        # the PS step is host-bound and long: steps 2-3 give its time
        launches, losses, metrics = run_api_path(tag, step, want, fps,
                                                 more_steps=0)
        nc, nb = ex.n_compressed(), sum(len(k) for _, k in ex._plans.values())
        key = "int8_quantize" if codec == "int8" else "fp8_sr_quantize"
        log(f"[{tag}] plan: {len(ex._plans)} exchanged trees, {nb} "
            f"partitions, {nc} compressed; {key} launches "
            f"{launches[key]} = {STEPS} x {nc}")
        dense_bytes = 4 * sum(p.numel() for p in model.parameters())
        d2h = metrics["ps/d2h_bytes"] / STEPS
        log(f"[{tag}] per step ps/d2h_bytes {d2h:.0f} = "
            f"{d2h / dense_bytes:.4f} x the dense gradient bytes "
            f"{dense_bytes}; ps/push_bytes "
            f"{metrics['ps/push_bytes'] / STEPS:.0f}, ps/pull_bytes "
            f"{metrics['ps/pull_bytes'] / STEPS:.0f}")
        stages = {k[6:]: v for k, v in metrics.items()
                  if k.startswith("stage/") and v["count"]}
        log(f"[{tag}] host stage times over the {STEPS} counted steps "
            "(summed over buckets and threads): " + ", ".join(
                f"{k} {v['sum_ms']:.1f} ms / {v['count']}"
                for k, v in sorted(stages.items())))
        log(f"[{tag}] get_pushpull_speed() after each step's last "
            f"synchronize: {[round(x, 1) for x in speed]} MB/s (10 s window)")
        if not min(speed) > 0:
            raise AssertionError(f"{tag}: get_pushpull_speed() {speed} with "
                                 "BPS_TELEMETRY_ON=1")
        if codec == "int8":
            # each reading against the window modelled per exchange, each
            # by its own start and bytes (a step's exchanges may straddle
            # the window's edge)
            for k, (got_mbps, now) in enumerate(zip(speed, read_at)):
                want_mbps, inside = window_mbps(exchanges, now)
                log(f"[{tag}] after step {k + 1}: {got_mbps:.1f} MB/s, the "
                    f"{inside} exchanges' gradient bytes in the window over "
                    f"their time {want_mbps:.1f} MB/s (ratio "
                    f"{got_mbps / want_mbps:.3f}, held within "
                    f"x{SPEED_FACTOR})")
                if not 1 / SPEED_FACTOR <= got_mbps / want_mbps \
                        <= SPEED_FACTOR:
                    raise AssertionError(
                        f"{tag}: get_pushpull_speed() {got_mbps} MB/s after "
                        f"step {k + 1} against {want_mbps} MB/s")
        if not d2h < 0.3 * dense_bytes:
            raise AssertionError(f"{tag}: {d2h} bytes a step crossed to the "
                                 "host, not the payloads alone")
        log(f"[{tag}] step-1 loss {losses[0]:.6f}, dense run "
            f"{dense_losses[0]:.6f}; step 2 {losses[1]:.6f}, dense run "
            f"{dense_losses[1]:.6f} (|diff| "
            f"{abs(losses[1] - dense_losses[1]):.3e}, tolerance "
            f"{PS_STEP2_TOL})")
        if losses[0] != dense_losses[0]:
            raise AssertionError(f"{tag}: step-1 loss differs from the dense "
                                 "run's on the same weights and batch")
        if not abs(losses[1] - dense_losses[1]) <= PS_STEP2_TOL:
            step2_misses.append(tag)
        # step 1's exchange again on CPU copies, through the plain versions
        t = time.perf_counter()
        backend, ref = _reference_exchange(codec, gs.registry)
        try:
            n = 0
            for name, x in sent.items():
                if codec == "int8":
                    (want_x,) = ref.exchange([("['t']", x)],
                                             name="Gradient." + name)
                    pairs = [(name, got[name], want_x)]
                else:
                    paths, leaves, _ = tree_flatten(x)
                    outs = ref.exchange(list(zip(paths, leaves)),
                                        name="Gradient." + name)
                    pairs = [(f"{name}{p}", got[name][p[2:-2]], o)
                             for p, o in zip(paths, outs)]
                for what, g, w in pairs:
                    if g.numpy().tobytes() != np.ascontiguousarray(
                            w).tobytes():
                        raise AssertionError(
                            f"{tag}: step 1's exchanged {what} differs from "
                            "its CPU copy's through the plain versions")
                    n += 1
        finally:
            ref.close()
            backend.close()
        log(f"[{tag}] step 1: {n} exchanged gradients bit for bit their CPU "
            f"copies' through the plain versions (a second exchange, "
            f"{time.perf_counter() - t:.1f} s)")
        del model, opt
        torch.cuda.empty_cache()
        return launches
    finally:
        bt.shutdown()           # the plugin's pool, then the runtime
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _gpt2_setup(layers=None):
    import dataclasses

    from byteps_tpu_torch.models import gpt2
    from byteps_tpu_torch.models.flops import transformer_train_flops_per_sample
    cfg = gpt2.gpt2_medium()
    if layers is not None:         # a cut path (CUT_LAYERS)
        cfg = dataclasses.replace(cfg, layers=layers)
    data = gpt2.synth_lm_batch(np.random.RandomState(0), TRAIN_BATCH,
                               GPT2_SEQ, cfg.vocab_size)
    return (cfg, gpt2.causal_lm_loss, data,
            transformer_train_flops_per_sample(cfg, GPT2_SEQ))


def train_gpt2_dense():
    from byteps_tpu_torch.models import gpt2
    cfg, loss_fn, data, fps = _gpt2_setup()
    launches, trainer, _, _ = run_path(
        "gpt2_medium dense", cfg, loss_fn, data, fps,
        _attention_launches(cfg, ("flash_bwd_dq", "flash_bwd_dkv")),
        naive_cfg=gpt2.gpt2_medium(attn_impl="naive"))
    del trainer
    return launches


def _sp_launches(cfg, backward):
    """A sequence-parallel path on a ring of one: every forward in fp32
    out (remat: twice a layer), and ``backward`` once a layer, the fused
    one with delta given."""
    def want(trainer):
        w = dict.fromkeys(COUNT_KEYS, 0)
        w["flash_fwd"] = w["flash_fwd:f32"] = STEPS * cfg.layers * 2
        for name in backward:
            w[name] = STEPS * cfg.layers
        if "flash_bwd_fused" in backward:
            w["flash_bwd_fused:delta"] = STEPS * cfg.layers
        return by_width(w, cfg.head_dim)
    return want


def train_bert_sp():
    """BERT-large MLM with ``sp_axis="seq"`` through ``ShardedTrainer`` on a
    ``{"seq": 1}`` mesh: the full-sequence head, the flash ring (fp32-out
    forward, fused backward with delta given); step 1 against the naive
    ring's."""
    import dataclasses

    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.models.flops import transformer_train_flops_per_sample
    from byteps_tpu_torch.parallel.mesh import make_mesh
    cfg = bert.bert_large(max_seq=BERT_SEQ, sp_axis="seq")
    data = bert.synth_mlm_batch(np.random.RandomState(0), TRAIN_BATCH,
                                BERT_SEQ, cfg.vocab_size)
    launches, trainer, _, _ = run_path(
        "bert_large_sp", cfg, bert.mlm_loss, data,
        transformer_train_flops_per_sample(cfg, BERT_SEQ),
        _sp_launches(cfg, ("flash_bwd_fused",)),
        naive_cfg=dataclasses.replace(cfg, attn_impl="naive"),
        mesh=make_mesh({"seq": 1}))
    del trainer
    torch.cuda.empty_cache()
    return launches


def train_gpt2_sp():
    """GPT-2 medium with ``sp_axis="seq"`` through ``ShardedTrainer`` on a
    ``{"seq": 1}`` mesh: one shard of two 512 blocks, so the split
    backward with delta given; step 1 against this call's dense GPT-2
    run (the same weights and batch)."""
    from byteps_tpu_torch.models import gpt2
    from byteps_tpu_torch.parallel.mesh import make_mesh
    _, loss_fn, data, fps = _gpt2_setup()
    cfg = gpt2.gpt2_medium(sp_axis="seq")
    launches, trainer, losses, _ = run_path(
        "gpt2_medium_sp", cfg, loss_fn, data, fps,
        _sp_launches(cfg, ("flash_bwd_dq", "flash_bwd_dkv")),
        mesh=make_mesh({"seq": 1}))
    del trainer
    torch.cuda.empty_cache()
    dense = SUMMARY["gpt2_medium dense"]["losses"][0]
    diff = abs(losses[0] - dense)
    log(f"[gpt2_medium_sp] step-1 loss {losses[0]!r}, dense run {dense!r}: "
        f"|diff| {diff:.3e} ({'bit for bit' if losses[0] == dense else 'not bit for bit'}"
        f"; tolerance {SP_DENSE_TOL})")
    if not diff <= SP_DENSE_TOL:
        raise AssertionError("gpt2_medium_sp: step-1 loss differs from the "
                             "dense run's on the same weights and batch")
    return launches


# ------------------------------------------ the model options (remat
# policies, the chunked LM head, the head's GEMM, ShardedTrainer's
# accumulation and compression)

def _grad_norm(grads) -> float:
    return math.sqrt(sum(g.double().square().sum().item() for g in grads))


def _trainer(cfg, loss_fn):
    """A ``DistributedTrainer`` of the transformer core on the card, fresh
    weights from seed 0, AdamW(1e-4)."""
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    return DistributedTrainer(loss_fn, model, adamw(model.parameters(), 1e-4),
                              partition_bytes=PARTITION_BYTES)


def steps_in_turns(tag, arms, data, rounds=TURNS):
    """Step time of each arm (``arms``: {name: (trainer, context)}, the
    context entered around that arm's steps, or None) in turns: one warm
    step each, then ``rounds`` rounds of one step each, each timed on
    the host clock to its synchronize. Host-bound steps move by tens of
    ms between calls and phases, so two arms compare only in turns.
    Returns {name: median ms} and prints each arm's ratio to the
    first's."""
    times = {name: [] for name in arms}
    for r in range(rounds + 1):
        for name, (trainer, context) in arms.items():
            with context() if context is not None else contextlib.nullcontext():
                torch.cuda.synchronize()
                t = time.perf_counter()
                trainer.step(data)
                torch.cuda.synchronize()
            if r:
                times[name].append((time.perf_counter() - t) * 1e3)
    med = {name: statistics.median(v) for name, v in times.items()}
    first = next(iter(med.values()))
    log(f"[{tag} in turns, {rounds} rounds, this call] " + "; ".join(
        f"{name} {m:.1f} ms ({m / first:.3f}x; quartiles "
        f"{statistics.quantiles(times[name], n=4)[0]:.1f}-"
        f"{statistics.quantiles(times[name], n=4)[2]:.1f})"
        for name, m in med.items()))
    return med


def train_bert_remat():
    """BERT-large under ``examples/perf_lab.py``'s other ``--remat`` arms
    (``BERT_REMAT``) beside this call's whole-block run (``bert_large``):
    step 1's loss bit for bit (the forward is the same computation), the
    step-1 gradients' norm of fresh weights within GRAD_NORM_TOL relative
    (printed whether every gradient is bit for bit the whole-block
    run's), each path's forward and fused launches, its peak memory
    beside whole-block remat's."""
    import dataclasses
    cfg0, loss_fn, data, fps = _bert_setup()
    base = SUMMARY["bert_large"]
    _, ref = _step1_grads(cfg0, None, loss_fn, data)
    ref_norm = _grad_norm(ref)
    paths = {}
    for tag, (change, forwards) in BERT_REMAT.items():
        cfg = dataclasses.replace(cfg0, **change)
        launches, trainer, losses, _ = run_path(
            tag, cfg, loss_fn, data, fps,
            _attention_launches(cfg, ("flash_bwd_fused",), forwards),
            more_steps=2)
        del trainer
        torch.cuda.empty_cache()
        _, grads = _step1_grads(cfg, None, loss_fn, data)
        norm = _grad_norm(grads)
        bitwise = all(_same_bits(g, r) for g, r in zip(grads, ref))
        del grads
        torch.cuda.empty_cache()
        rel = abs(norm - ref_norm) / ref_norm
        r = SUMMARY[tag]
        log(f"[{tag} vs whole-block remat, this call] step-1 loss "
            f"{losses[0]!r} vs {base['losses'][0]!r} "
            f"({'bit for bit' if losses[0] == base['losses'][0] else 'differs'}); "
            f"step-1 gradient norm {norm!r} vs {ref_norm!r}, rel "
            f"{rel:.3e} (tolerance {GRAD_NORM_TOL}), gradients "
            f"{'bit for bit' if bitwise else 'not bit for bit'}; peak "
            f"{r['peak_gb']:.2f} GB vs {base['peak_gb']:.2f} GB; step "
            f"{r['step_ms']:.1f} ms vs {base['step_ms']:.1f} ms")
        if losses[0] != base["losses"][0]:
            raise AssertionError(f"{tag}: step-1 loss is not the whole-block "
                                 "run's bit for bit")
        if not rel <= GRAD_NORM_TOL:
            raise AssertionError(f"{tag}: step-1 gradient norm differs from "
                                 "the whole-block run's")
        paths[tag] = launches
    del ref
    torch.cuda.empty_cache()
    arms = {"whole-block": (_trainer(cfg0, loss_fn), None)}
    for tag, (change, _) in BERT_REMAT.items():
        arms[tag] = (_trainer(dataclasses.replace(cfg0, **change), loss_fn),
                     None)
    SUMMARY["bert_remat_turns"] = steps_in_turns("bert_large remat arms",
                                                 arms, data)
    del arms
    torch.cuda.empty_cache()
    return paths


def _head_plain(hidden, emb, dt):
    """The head's route before the bf16 GEMM: both operands rounded to
    ``dt``, multiplied in fp32 (TF32 is off in this script)."""
    return hidden.to(dt).float() @ emb.to(dt).float().t()


def check_head_gemm():
    """The LM head at GPT-2 medium's shape (b 8, s 1024, hidden 1024,
    vocab 50257): logits and their gradients through the bf16 GEMM
    (``transformer.head_logits`` on the card) against the fp32 route on
    the same inputs, with the cotangent a mean cross-entropy gives;
    logits within HEAD_LOGITS_TOL · max|ref|, dh and dE within REL_TOL ·
    max|ref|. Then both routes' forward and forward + backward times
    beside the bound."""
    from byteps_tpu_torch.models import gpt2
    from byteps_tpu_torch.models import transformer as tr
    cfg = gpt2.gpt2_medium()
    n, hid, vocab = TRAIN_BATCH * GPT2_SEQ, cfg.hidden, cfg.vocab_size
    g = torch.Generator().manual_seed(41)
    h = torch.randn(n, hid, generator=g).to(torch.bfloat16).cuda()
    emb = (torch.randn(vocab, hid, generator=g) * 0.02).cuda()
    tgt = torch.randint(0, vocab, (n,), generator=g).cuda()
    bf16 = torch.bfloat16
    with torch.no_grad():
        ct = torch.softmax(_head_plain(h, emb, bf16), -1)
        ct[torch.arange(n, device=ct.device), tgt] -= 1.0
        ct /= n
    res = {}
    for route, fn in (("bf16_gemm", tr.head_logits), ("fp32", _head_plain)):
        ha, ea = h.clone().requires_grad_(), emb.clone().requires_grad_()
        lg = fn(ha, ea, bf16)
        lg.backward(ct)
        torch.cuda.synchronize()
        res[route] = (lg.detach(), ha.grad, ea.grad)
        del lg
    worst = {}
    for name, got, ref, tol in zip(
            ("logits", "dh", "dE"), res["bf16_gemm"], res["fp32"],
            (HEAD_LOGITS_TOL, REL_TOL, REL_TOL)):
        e, r = _rel_err(got, ref)
        worst[name] = r
        log(f"[check lm head b{TRAIN_BATCH} s{GPT2_SEQ} h{hid} v{vocab}] "
            f"{name}: bf16 GEMM vs fp32 route err {e:.3e} (rel {r:.2e}, "
            f"tolerance {tol})")
        if not r <= tol:
            raise AssertionError(f"lm head {name}: the bf16 GEMM disagrees "
                                 "with the fp32 route")
    del res
    torch.cuda.empty_cache()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ha, ea = h.clone().requires_grad_(), emb.clone().requires_grad_()
    flops = 2 * n * hid * vocab
    nbytes = n * hid * 2 + vocab * hid * 4 + n * vocab * 4
    times = {}
    for route, fn in (("bf16_gemm", tr.head_logits), ("fp32", _head_plain)):
        times[route] = {
            "fwd_ms": time_ms(lambda: fn(h, emb, bf16), n=10, flush=flush),
            "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                fn(ha, ea, bf16), (ha, ea), ct), n=10, flush=flush)}
    # forward: h and E read, the logits written; the backward also reads
    # the cotangent, h and E and writes dh and dE
    bound = {"fwd": _bound(flops, nbytes),
             "fwd_bwd": _bound(3 * flops, nbytes + n * vocab * 4
                               + 2 * (n * hid * 2 + vocab * hid * 4))}
    log(f"[time lm head b{TRAIN_BATCH} s{GPT2_SEQ} v{vocab}] " + "; ".join(
        f"{r}: forward {t['fwd_ms']:.4f} ms, forward + backward "
        f"{t['fwd_bwd_ms']:.4f} ms" for r, t in times.items())
        + f"; bound forward {bound['fwd']['bound_ms']:.4f} ms "
        f"({bound['fwd']['bound_by']}), forward + backward "
        f"{bound['fwd_bwd']['bound_ms']:.4f} ms")
    del flush, ha, ea, ct
    torch.cuda.empty_cache()
    SUMMARY["lm_head"] = {"rel_err": worst, "times": times,
                          "bound_ms": {k: v["bound_ms"]
                                       for k, v in bound.items()}}


@contextlib.contextmanager
def _fp32_head():
    """The head's route before the bf16 GEMM, inside the block."""
    from byteps_tpu_torch.models import transformer as tr
    head, tr.head_logits = tr.head_logits, _head_plain
    try:
        yield
    finally:
        tr.head_logits = head


def train_gpt2_fp32_head():
    """GPT-2 medium dense again with the head's route before the bf16 GEMM
    (``_head_plain``), for its step beside the bf16 GEMM's in this call:
    step 1's loss within HEAD_LOSS_TOL relative of the dense run's (the
    forward's logits differ only in summation order)."""
    cfg, loss_fn, data, fps = _gpt2_setup()
    with _fp32_head():
        launches, trainer, losses, _ = run_path(
            "gpt2_medium dense fp32 head", cfg, loss_fn, data, fps,
            _attention_launches(cfg, ("flash_bwd_dq", "flash_bwd_dkv")))
    del trainer
    torch.cuda.empty_cache()
    SUMMARY["head_turns"] = steps_in_turns(
        "gpt2_medium dense head routes",
        {"bf16 GEMM": (_trainer(cfg, loss_fn), None),
         "fp32 route": (_trainer(cfg, loss_fn), _fp32_head)}, data)
    torch.cuda.empty_cache()
    dense = SUMMARY["gpt2_medium dense"]
    rel = abs(losses[0] - dense["losses"][0]) / abs(dense["losses"][0])
    old = SUMMARY["gpt2_medium dense fp32 head"]
    log(f"[lm head, this call] gpt2_medium dense step-1 loss: bf16 GEMM "
        f"{dense['losses'][0]!r}, fp32 route {losses[0]!r} (rel {rel:.3e}, "
        f"tolerance {HEAD_LOSS_TOL}); step {dense['step_ms']:.1f} ms vs "
        f"{old['step_ms']:.1f} ms; profiled device busy "
        f"{(dense['profile'] or {}).get('busy_ms', float('nan')):.2f} ms vs "
        f"{(old['profile'] or {}).get('busy_ms', float('nan')):.2f} ms")
    if not rel <= HEAD_LOSS_TOL:
        raise AssertionError("gpt2_medium: the bf16 head's step-1 loss "
                             "differs from the fp32 route's")
    return launches


def train_gpt2_long():
    """GPT-2 medium at ``LONG_SEQ`` (batch ``LONG_BATCH``) with the head
    chunked at ``LONG_CHUNK``, whole-block remat, through
    ``DistributedTrainer``: every attention launch at s 32768 (the one
    attention of a [1, 32768] batch), the split backward; then one step
    of the same model with the full head (the control): its step-1 loss
    within LONG_HEAD_TOL relative, and the chunked run's peak memory
    lower by at least one fp32 [s, vocab] tensor."""
    import dataclasses

    from byteps_tpu_torch.models import gpt2
    from byteps_tpu_torch.models.flops import transformer_train_flops_per_sample
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    cfg = gpt2.gpt2_medium(max_seq=LONG_SEQ, lm_head_chunk=LONG_CHUNK)
    data = gpt2.synth_lm_batch(np.random.RandomState(0), LONG_BATCH,
                               LONG_SEQ, cfg.vocab_size)
    fps = transformer_train_flops_per_sample(cfg, LONG_SEQ)
    launches, trainer, losses, _ = run_path(
        "gpt2_medium_32k", cfg, gpt2.causal_lm_loss, data, fps,
        _attention_launches(cfg, ("flash_bwd_dq", "flash_bwd_dkv")),
        more_steps=2, tokens_per_sample=LONG_SEQ, batch=LONG_BATCH)
    del trainer
    torch.cuda.empty_cache()
    full = dataclasses.replace(cfg, lm_head_chunk=0)
    model = Transformer(full, generator=torch.Generator().manual_seed(0))
    trainer = DistributedTrainer(gpt2.causal_lm_loss, model,
                                 adamw(model.parameters(), 1e-4),
                                 partition_bytes=PARTITION_BYTES)
    ctr = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ctr)
    t = time.perf_counter()
    loss = trainer.step(data).item()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    full_launches = read_counts(ctr)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del trainer, model
    torch.cuda.empty_cache()
    want = _attention_launches(full, ("flash_bwd_dq", "flash_bwd_dkv"))(None)
    want = {k: v // STEPS for k, v in want.items()}    # one step
    chunked = SUMMARY["gpt2_medium_32k"]["peak_gb"]
    one = LONG_SEQ * cfg.vocab_size * 4 / 1e9
    rel = abs(loss - losses[0]) / abs(losses[0])
    log(f"[gpt2_medium_32k_full_head] step-1 loss {loss!r}, chunked "
        f"{losses[0]!r}: rel {rel:.3e} (tolerance {LONG_HEAD_TOL}); step "
        f"{step_s * 1e3:.1f} ms (step 1, cold); peak memory {peak:.2f} GB, "
        f"chunked {chunked:.2f} GB: {peak - chunked:.2f} GB saved, one fp32 "
        f"[s, vocab] tensor {one:.2f} GB; launches {full_launches}")
    SUMMARY["gpt2_medium_32k_full_head"] = {"peak_gb": peak,
                                            "loss": loss,
                                            "step1_ms": step_s * 1e3}
    if full_launches != want:
        raise AssertionError(f"gpt2_medium_32k_full_head: launches "
                             f"{full_launches}, expected {want}")
    if not rel <= LONG_HEAD_TOL:
        raise AssertionError("gpt2_medium_32k: the chunked head's step-1 "
                             "loss differs from the full head's")
    if not peak - chunked >= one:
        raise AssertionError("gpt2_medium_32k: the chunked head saved less "
                             "than one fp32 [s, vocab] tensor of memory")
    return launches, full_launches


def train_gpt2_sp_accum(onebit_launches):
    """GPT-2 medium through ``ShardedTrainer`` on ``{"seq": 1}`` with
    ``backward_passes_per_step=SP_ACCUM`` and the README's onebit
    compression, ``SP_ACCUM_STEPS`` micro-steps on one batch, each
    counted on its own: the ring's launches every micro-step (fp32-out
    forward twice a layer, dq and dk/dv once); at each sync boundary
    onebit's pack and unpack launches of one ``gpt2_medium_onebit`` step
    (``onebit_launches``: that path's counts over its STEPS), none in
    between. The micro-step after a window's first sees unchanged
    weights: the same loss bit for bit; the next window's first a lower
    one."""
    from byteps_tpu_torch.models import gpt2
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.parallel.mesh import make_mesh
    from byteps_tpu_torch.training import ShardedTrainer
    _, loss_fn, data, _ = _gpt2_setup()
    cfg = gpt2.gpt2_medium(sp_axis="seq")
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    trainer = ShardedTrainer(loss_fn, model, adamw(model.parameters(), 1e-4),
                             make_mesh({"seq": 1}),
                             partition_bytes=PARTITION_BYTES,
                             compression=README_COMPRESSION,
                             min_compress_bytes=MIN_COMPRESS_BYTES,
                             backward_passes_per_step=SP_ACCUM)
    nc = trainer.tx.plan.n_compressed
    per_sync = {k: onebit_launches[k] // STEPS
                for k in ("onebit_pack", "onebit_unpack")}
    if per_sync != {"onebit_pack": nc, "onebit_unpack": 2 * nc}:
        raise AssertionError(f"gpt2_medium_sp_accum: {nc} compressed "
                             f"buckets, gpt2_medium_onebit's step {per_sync}")
    ring = _sp_launches(cfg, ("flash_bwd_dq", "flash_bwd_dkv"))(None)
    ring = {k: v // STEPS for k, v in ring.items()}     # one micro-step
    ctr = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = dict.fromkeys(COUNT_KEYS, 0)
    losses, times = [], []
    for i in range(SP_ACCUM_STEPS):
        zero_counts(ctr)
        t = time.perf_counter()
        loss = trainer.step(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
        got = read_counts(ctr)
        want = dict(ring)
        if (i + 1) % SP_ACCUM == 0:
            want.update(per_sync)
        log(f"[gpt2_medium_sp_accum] micro-step {i + 1}: loss {losses[-1]!r}, "
            f"{times[-1] * 1e3:.1f} ms, onebit pack "
            f"{got['onebit_pack']}, unpack {got['onebit_unpack']}")
        if got != want:
            raise AssertionError(f"gpt2_medium_sp_accum micro-step {i + 1}: "
                                 f"launches {got}, expected {want}")
        total = {k: total[k] + got[k] for k in total}
    peak = torch.cuda.max_memory_allocated() / 1e9
    del trainer, model
    torch.cuda.empty_cache()
    log(f"[gpt2_medium_sp_accum] losses {losses}; micro-step times s "
        f"{times}; peak memory {peak:.2f} GB; {nc} compressed buckets")
    SUMMARY["gpt2_medium_sp_accum"] = {"losses": losses, "peak_gb": peak,
                                       "times_ms": [x * 1e3 for x in times]}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"gpt2_medium_sp_accum: non-finite loss: "
                             f"{losses}")
    if losses[1] != losses[0] or not losses[SP_ACCUM] < losses[0]:
        raise AssertionError("gpt2_medium_sp_accum: the weights moved "
                             "mid-window or not at the sync boundary: "
                             f"{losses}")
    return total


def check_long_kernels(worst):
    """The forward, dq and dk/dv kernels at GPT-2's long context (b 1, s
    ``LONG_SEQ``, h 16, d 64, causal) on all 16 heads; heads 0 and 15
    held against the plain versions run on that head alone (the plain
    version's fp32 scores of all 16 heads would be 68.7 GB)."""
    from byteps_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _inputs(LONG_BATCH, LONG_SEQ, HEADS, HEAD_DIM, seed=60)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.bwd_delta(do, out)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    for hd in (0, HEADS - 1):
        sl = slice(hd, hd + 1)
        tag = (f"b{LONG_BATCH} s{LONG_SEQ} head {hd} of {HEADS} d{HEAD_DIM} "
               "causal")
        qh, kh, vh, doh = (t[:, :, sl] for t in (q, k, v, do))
        ref_out, ref_lse = fa.flash_fwd_plain(qh, kh, vh, True)
        e_lse = (lse[:, sl] - ref_lse).abs().max().item()
        log(f"[check {tag}] lse err {e_lse:.3e}")
        if not e_lse <= LSE_TOL:
            raise AssertionError(f"flash_fwd lse disagrees at {tag}")
        worst["flash_fwd"] = max(worst["flash_fwd"], _check(
            "fwd out", tag, out[:, :, sl], ref_out))
        del ref_out, ref_lse
        args = (qh, kh, vh, doh, lse[:, sl], delta[:, sl], True)
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], _check(
            "split dq", tag, dq[:, :, sl], fa.flash_bwd_dq_plain(*args)))
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*args)
        worst["flash_bwd_dkv"] = max(
            worst["flash_bwd_dkv"],
            _check("split dk", tag, dk[:, :, sl], ref_dk),
            _check("split dv", tag, dv[:, :, sl], ref_dv))
        del ref_dk, ref_dv
        torch.cuda.empty_cache()
    del q, k, v, do, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()


def time_long_attention():
    """The forward, dq and dk/dv kernels at (b 1, s ``LONG_SEQ``, h 16, d
    64, causal) beside their bounds and the library's attention; the
    plain versions run head by head over the 16 heads (median of 3)."""
    from byteps_tpu_torch.ops import flash_attention as fa
    b, s, h, d = LONG_BATCH, LONG_SEQ, HEADS, HEAD_DIM
    q, k, v, do = _inputs(b, s, h, d, seed=61)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.bwd_delta(do, out)

    def heads(fn):
        def run():
            for i in range(h):
                sl = slice(i, i + 1)
                fn(*(t[:, :, sl] for t in (q, k, v, do)), lse[:, sl],
                   delta[:, sl])
        return run

    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, True),
                      heads(lambda qh, kh, vh, doh, l_, d_:
                            fa.flash_fwd_plain(qh, kh, vh, True))),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
            heads(lambda *a: fa.flash_bwd_dq_plain(*a, True))),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
            heads(lambda *a: fa.flash_bwd_dkv_plain(*a, True))),
    }
    lib = library_attention_ms(q, k, v, do, True, flush)
    bounds = attention_bounds(b, s, h, d, True)
    res = {}
    for name, (kernel, plain) in calls.items():
        r = {"ms": time_ms(kernel, flush=flush),
             "plain_ms": time_ms(plain, n=3, flush=flush),
             "plain": "one head at a time, all 16",
             "library_ms": lib[0] if name == "flash_fwd" else lib[1],
             "timed_shape": [b, s, h, d], "causal": True}
        r.update(bounds[name])
        _log_time(name, f"b{b} s{s} h{h} d{d} causal", r)
        res[name] = r
    del q, k, v, do, out, lse, delta, flush
    torch.cuda.empty_cache()
    return res


def _same_bits(a, b):
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _state_leaves(st):
    """The tensors of a compressor state tree, in order."""
    if torch.is_tensor(st):
        return [st]
    if isinstance(st, dict):
        return [t for k in sorted(st) for t in _state_leaves(st[k])]
    if isinstance(st, (tuple, list)):
        return [t for x in st for t in _state_leaves(x)]
    return []


def check_onebit_reduction(tag, trainer, loss_fn, data, kwargs):
    """One step's compressed reduction of real gradients (the trained
    weights' next backward) from the compressor states the path's steps
    left, so error feedback and momentum are live, through the kernels
    and through their plain versions on the card
    (``compressor_backend="jnp"``), for either exchange: the reduced
    gradient and every leaf of the new states (for rs, each shard's chain
    and the merge chain's) bit for bit, and the reduction off the
    gradient on the compressed buckets. Also ``check_onebit`` on the
    largest compressed bucket of that gradient."""
    from byteps_tpu_torch.ops.compression.reducer import CompressionPlan
    from byteps_tpu_torch.parallel.collectives import _pack_bucket
    from byteps_tpu_torch.training import _to_device
    plan, states = trainer.tx.plan, trainer.tx.comp_states
    log(f"[{tag}] plan: {len(plan.buckets)} buckets, {plan.n_compressed} "
        f"compressed, exchange {plan.exchange}, "
        f"{sum(b.size for b in plan.buckets)} gradient floats")
    plain = CompressionPlan(plan.specs, PARTITION_BYTES,
                            dict(kwargs, compressor_backend="jnp"),
                            MIN_COMPRESS_BYTES, world=plan.world)
    if [c is None for c in plain.compressors] != \
            [c is None for c in plan.compressors]:
        raise AssertionError(f"{tag}: the plain plan compresses other "
                             "buckets")
    old = _state_leaves(states)
    live = sum(bool(t.any()) for t in old)
    if not live:
        raise AssertionError(f"{tag}: the trained compressor states are "
                             "all zero")

    named = dict(trainer.model.named_parameters())
    trainer.model.zero_grad(set_to_none=True)
    loss_fn(trainer.model, _to_device(data, "cuda")).backward()
    grads = [named[s.name].grad for s in plan.specs]
    flat = [g.view(-1) for g in grads]
    full = max((b for b, c in zip(plan.buckets, plan.compressors)
                if c is not None), key=lambda b: b.size)
    check_onebit(_pack_bucket(flat, full),
                 f"bucket {full.index} of a real gradient")
    red_k = [g.clone() for g in grads]
    red_p = [g.clone() for g in grads]
    new_k = _state_leaves(plan.reduce(red_k, states))
    new_p = _state_leaves(plain.reduce(red_p, states))
    if not all(_same_bits(a, c) for a, c in zip(red_k, red_p)):
        raise AssertionError(f"{tag}: the compressed reduction through the "
                             "kernels differs from the one through the "
                             "plain versions")
    if not (len(new_k) == len(new_p) == len(old) and all(
            _same_bits(a, c) for a, c in zip(new_k, new_p))):
        raise AssertionError(f"{tag}: the new compressor states through "
                             "the kernels differ from the plain versions'")
    red = [t.view(-1) for t in red_k]
    moved = sum(not torch.equal(_pack_bucket(red, b), _pack_bucket(flat, b))
                for b, c in zip(plan.buckets, plan.compressors)
                if c is not None)
    if not moved:
        raise AssertionError(f"{tag}: the compressed buckets' reduction is "
                             "the gradient itself")
    log(f"[{tag}] one step's compressed reduction of real gradients from "
        f"the trained states ({live} of {len(old)} state tensors non-zero): "
        f"the reduced gradient and all {len(new_k)} new state tensors "
        f"bit-identical through the kernels and through their plain "
        f"versions; {moved} of {plan.n_compressed} compressed buckets moved "
        f"off the gradient")
    del grads, red_k, red_p, new_k, new_p
    trainer.model.zero_grad(set_to_none=True)


def train_gpt2_onebit():
    """The README's compression, then ``check_onebit_reduction``."""
    cfg, loss_fn, data, fps = _gpt2_setup()
    attn = _attention_launches(cfg, ("flash_bwd_dq", "flash_bwd_dkv"))

    def want(trainer):
        w = attn(trainer)
        nc = trainer.tx.plan.n_compressed
        w["onebit_pack"] = STEPS * nc
        w["onebit_unpack"] = STEPS * 2 * nc     # EF's decompress + 1 payload
        return w

    launches, trainer, _, _ = run_path("gpt2_medium onebit", cfg, loss_fn,
                                       data, fps, want,
                                       compression=README_COMPRESSION)
    check_onebit_reduction("gpt2_medium onebit", trainer, loss_fn, data,
                           README_COMPRESSION)
    del trainer
    torch.cuda.empty_cache()
    return launches


class InjectedDraws:
    """randomk's indices or dithering's uniforms (``kind``) drawn from one
    numpy stream keyed by the bucket's size, on every device alike: the
    compressor class's ``draw`` is patched inside the block."""

    def __init__(self, kind):
        from byteps_tpu_torch.ops.compression import dithering, randomk
        self.cls = {"randomk": randomk.RandomkCompressor,
                    "dithering": dithering.DitheringCompressor}.get(kind)
        self.kind, self.cache = kind, {}

    def draw(self, comp, state, device):
        if comp.size not in self.cache:
            rng = np.random.RandomState(comp.size)
            self.cache[comp.size] = torch.from_numpy(
                rng.randint(0, comp.size, comp.k).astype(np.int32)
                if self.kind == "randomk"
                else rng.uniform(size=comp.size).astype(np.float32))
        return self.cache[comp.size].to(device), state

    def __enter__(self):
        if self.cls is not None:
            self.orig = self.cls.draw
            inj = self
            self.cls.draw = lambda comp, state, device: inj.draw(
                comp, state, device)
        return self

    def __exit__(self, *exc):
        if self.cls is not None:
            self.cls.draw = self.orig


def _innermost(comp):
    while hasattr(comp, "inner"):
        comp = comp.inner
    return comp


def check_step1_reduction(tag, name, cfg, loss_fn, data, specs):
    """Step 1's gradients of a compressed path (fresh weights from seed 0,
    the path's batch), reduced by a fresh plan of its kwargs on the card,
    must differ from the dense gradient (at world 1 the gradient itself)
    on the compressed buckets, and be bit for bit the same plan's
    reduction of the gradients copied to the host (the CPU route): for
    randomk and dithering with both routes' draws injected from one
    stream; for topk except where the bucket's k-th magnitude is tied
    (``torch.topk`` on the card promises no order among ties)."""
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.ops.compression.reducer import CompressionPlan
    from byteps_tpu_torch.parallel.collectives import _pack_bucket
    kw = GPT2_COMPRESSION[name]
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0)).cuda()
    loss_fn(model, torch.from_numpy(data).cuda()).backward()
    named = dict(model.named_parameters())
    grads = [named[s.name].grad if named[s.name].grad is not None
             else torch.zeros_like(named[s.name]) for s in specs]
    del model, named
    plan = CompressionPlan(specs, PARTITION_BYTES, kw, MIN_COMPRESS_BYTES)
    with InjectedDraws(name):
        red = [g.clone() for g in grads]
        plan.reduce(red, plan.init_state(grads[0].device))
        torch.cuda.synchronize()
        ref = [g.to("cpu", copy=True) for g in grads]
        plan.reduce(ref, plan.init_state(torch.device("cpu")))
    flat = [[t.view(-1) for t in ts] for ts in (grads, red, ref)]
    moved = ties = 0
    for b, comp in zip(plan.buckets, plan.compressors):
        g, got, want = (_pack_bucket(f, b).cpu() for f in flat)
        if comp is not None:
            moved += int(not torch.equal(got, g))
        bad = got.view(torch.int32) != want.view(torch.int32)
        if not bool(bad.any()):
            continue
        k = getattr(_innermost(comp), "k", None)
        if name != "topk" or comp is None or not bool(
                (g.abs()[bad] == torch.topk(g.abs(), k).values.min()).all()):
            raise AssertionError(
                f"{tag}: bucket {b.index}'s step-1 reduction through the "
                f"card differs from the CPU route's at {int(bad.sum())} "
                "elements")
        ties += int(bad.sum())
    if not moved:
        raise AssertionError(f"{tag}: the compressed buckets' step-1 "
                             "reduction is the dense gradient")
    log(f"[{tag}] step 1's reduced gradient: {moved} of "
        f"{plan.n_compressed} compressed buckets moved off the dense "
        f"gradient; bit for bit the CPU route"
        + ("" if name not in ("randomk", "dithering")
           else " (draws injected on both routes)")
        + (f", but for {ties} elements at a tied k-th magnitude"
           if name == "topk" else ""))


def train_gpt2_compressed(name):
    """GPT-2 medium through ``DistributedTrainer(compression=
    GPT2_COMPRESSION[name])``: finite falling losses, the flash launches
    (onebit over rs also 2·nc pack and 4·nc unpack launches a step), then
    ``check_onebit_reduction`` (onebit over rs) or
    ``check_step1_reduction`` (the others). At ``CUT_LAYERS`` for the
    full run's time limit: the launches follow the cut config, and the
    reductions keep every bucket of the cut model's plan."""
    cfg, loss_fn, data, fps = _gpt2_setup(layers=CUT_LAYERS)
    attn = _attention_launches(cfg, ("flash_bwd_dq", "flash_bwd_dkv"))
    tag = f"gpt2_medium {name}"

    def want(trainer):
        w = attn(trainer)
        if name == "onebit_rs":
            # world 1: the one shard and the merge each pack once; the
            # shard's and the merge's error feedback, the received shard
            # and the gathered merge each unpack once
            nc = trainer.tx.plan.n_compressed
            w["onebit_pack"] = STEPS * 2 * nc
            w["onebit_unpack"] = STEPS * 4 * nc
        return w

    launches, trainer, _, _ = run_path(tag, cfg, loss_fn, data, fps, want,
                                       compression=GPT2_COMPRESSION[name])
    plan = trainer.tx.plan
    log(f"[{tag}] payload "
        f"{sum(c.payload_nbytes() for c in plan.compressors if c)} bytes "
        f"of {sum(b.size * 4 for b, c in zip(plan.buckets, plan.compressors) if c)}"
        " compressed-bucket bytes")
    if name == "onebit_rs":
        check_onebit_reduction(tag, trainer, loss_fn, data,
                               GPT2_COMPRESSION[name])
    specs = plan.specs
    del trainer, plan
    torch.cuda.empty_cache()
    if name != "onebit_rs":
        check_step1_reduction(tag, name, cfg, loss_fn, data, specs)
        torch.cuda.empty_cache()
    return launches


def t5_train_flops_per_sample(cfg, src, tgt):
    """Model FLOPs of one T5 training sample (3 x forward), the convention
    of ``models/flops.py``, which has no T5 formula: per encoder layer the
    transformer layer at s = src (8·s·h² + 4·s·h·m + 4·s²·h); per decoder
    layer the same at s = tgt plus cross-attention (q and out projections
    4·tgt·h², the kv projection 4·src·h², scores and AV 4·tgt·src·h); the
    tied head 2·tgt·h·vocab."""
    h, m = cfg.hidden, cfg.mlp_dim

    def layer(s):
        return 8 * s * h * h + 4 * s * h * m + 4 * s * s * h
    cross = 4 * tgt * h * h + 4 * src * h * h + 4 * tgt * src * h
    fwd = (cfg.enc_layers * layer(src) + cfg.dec_layers * (layer(tgt) + cross)
           + 2 * tgt * h * cfg.vocab_size)
    return 3.0 * fwd


def _t5_setup(**kw):
    from byteps_tpu_torch.models import t5
    cfg = t5.t5_small(**kw)
    data = t5.synth_seq2seq_batch(np.random.RandomState(0), TRAIN_BATCH,
                                  T5_SRC, T5_TGT, cfg.vocab_size)
    return cfg, data, t5_train_flops_per_sample(cfg, T5_SRC, T5_TGT - 1)


def train_t5_hybrid():
    """T5-small with ``attn_impl="hybrid"``: no forward kernel; the table
    forms' split backward for self-attention (the table materialized for
    the plain forward only), the no-bias split backward for
    cross-attention; step 1 against the flash path's."""
    from byteps_tpu_torch.models import t5
    cfg, data, fps = _t5_setup(attn_impl="hybrid")
    n_self = cfg.enc_layers + cfg.dec_layers

    def want(trainer):
        w = dict.fromkeys(COUNT_KEYS, 0)
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            w[f"{name}:rel"] = STEPS * n_self
            w[name] = w[f"{name}:rel"] + STEPS * cfg.dec_layers
        return by_width(w, cfg.head_dim)

    launches, trainer, losses, _ = run_path(
        "t5_small_hybrid", cfg, t5.seq2seq_loss, data, fps, want,
        model_cls=t5.T5, tokens_per_sample=T5_SRC + T5_TGT - 1)
    del trainer
    torch.cuda.empty_cache()
    _hybrid_vs_flash("t5_small_hybrid", "t5_small", losses)
    _t5_hybrid_check()
    return launches


def train_t5():
    """T5-small seq2seq: self-attention through the rel-table forms
    (bidirectional encoder, causal decoder), cross-attention (512 queries
    over 1024 keys, two blocks: the split backward) with no bias."""
    from byteps_tpu_torch.models import t5
    cfg, data, fps = _t5_setup()
    dec = T5_TGT - 1
    log(f"[t5_small] model FLOPs {fps / 1e9:.2f} G a sample "
        f"({fps / 3e9:.2f} G forward), {TRAIN_BATCH * fps / 1e12:.3f} T a step")
    n_self = cfg.enc_layers + cfg.dec_layers

    def want(trainer):
        w = dict.fromkeys(COUNT_KEYS, 0)
        w["flash_fwd:rel"] = STEPS * 2 * n_self          # remat: twice
        w["flash_fwd"] = w["flash_fwd:rel"] + STEPS * 2 * cfg.dec_layers
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            w[f"{name}:rel"] = STEPS * n_self
            w[name] = w[f"{name}:rel"] + STEPS * cfg.dec_layers
        return by_width(w, cfg.head_dim)

    launches, trainer, _, _ = run_path(
        "t5_small", cfg, t5.seq2seq_loss, data, fps, want,
        naive_cfg=t5.t5_small(attn_impl="naive"), model_cls=t5.T5,
        tokens_per_sample=T5_SRC + dec)
    del trainer
    torch.cuda.empty_cache()
    return launches


def form_entry(name, form, paths, worst, timing, d=HEAD_DIM):
    """The ``forms`` entry of a flash kernel at head dim ``d``: its
    launches in each path, its worst error against the plain version at
    the T5 shapes, its time beside its bound, plain and library times (the
    table form at the encoder's shape, and where timed at the decoder's
    under ``decoder``)."""
    key = f"{name}:{form}"
    t = timing[form, "encoder"][name]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "timed_shape", "causal") + (("design_bytes",)
                                        if "design_bytes" in t else ())
    by_path = {k: p[f"{key}:d{d}"] for k, p in paths.items()}
    entry = {"launches": sum(by_path.values()), "launches_by_path": by_path,
             "max_abs_err": worst[name, form], **{k: t[k] for k in keys}}
    if form == "rel" and ("rel", "decoder") in timing:
        dec = timing["rel", "decoder"][name]
        entry["decoder"] = {k: dec[k] for k in keys}
    return entry


def variant_entry(name, var, paths, worst, timing, d):
    """The entry of a ring form (``var``: "f32" under the forward, "delta"
    under the fused backward) at head dim ``d``: its launches in each
    path, its worst error against the plain version, its time at the
    BERT shape beside its bound, plain and library times."""
    vname = VARIANT_NAMES[var]
    t = timing[d][vname]
    by_path = {k: p[f"{name}:{var}:d{d}"] for k, p in paths.items()}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": worst[vname, d],
            "tolerance": f"max err <= {REL_TOL} * max|plain|",
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "timed_shape", "causal")}}


def kernel_entry(name, paths, worst, timing, card, ptxas, d=None):
    """One kernel's entry of the ``{"kernels": [...]}`` line. A flash
    kernel has one per head dim ``d`` (the d-128 one nested in the d-64
    one), with the launches and ptxas rows of that width."""
    t = timing[name]
    key = name if d is None else f"{name}:d{d}"
    entry = {
        "name": name if d in (None, HEAD_DIM) else f"{name}_d{d}",
        "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": sum(p[key] for p in paths.values()),
        "launches_by_path": {k: p[key] for k, p in paths.items()},
        "max_abs_err": worst[name], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "ok": True, "timed_shape": t["timed_shape"], "card": card,
        "tolerance": ("bit for bit" if name in BITWISE
                      else f"max err <= {REL_TOL} * max|plain|"),
    }
    for key in ("considered", "view"):
        if key in t:
            entry[key] = t[key]
    source = SOURCES[name].split("/", 1)[1]
    if d is not None:
        entry["head_dim"] = d
        entry["ptxas"] = [r for r in ptxas if r.get("d") == d
                          and r["source"] == source]
    else:
        entry["ptxas"] = [r for r in ptxas if r["source"] == source]
    return entry


# ----------------------------- remote PS: standalone servers over TCP

REMOTE_WAIT = 600       # seconds a server or worker process may take


def spawn_ps_server(workers, env=None):
    """Start ``python -m byteps_tpu_torch.launcher.launch --server`` on
    port 0 (or ``env``'s ``BPS_SERVER_PORT``: a restart on the port it
    had) for ``workers`` workers (``env``: more variables for it) without
    waiting for it; returns (process, its stderr lines), the lines read on
    a thread to the end."""
    import os
    import threading
    # env may name the port: a restart's
    env = {**os.environ, "BPS_SERVER_PORT": "0",
           "BPS_NUM_WORKER": str(workers), **(env or {})}
    proc = subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
         "--server"], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    lines = []

    def read():                 # drained to the end: the pipe never fills
        for line in proc.stderr:
            lines.append(line.rstrip())

    threading.Thread(target=read, daemon=True).start()
    return proc, lines


def await_ps_server(proc, lines):
    """The address of a spawned server once it printed ``server up on
    :<port>`` (it is stopped, and this raises, if it exits or takes more
    than 120 s)."""
    deadline = time.time() + 120
    while not any("server up on :" in x for x in lines):
        if proc.poll() is not None or time.time() > deadline:
            stop_ps_server(proc)
            raise AssertionError("the PS server did not come up:\n"
                                 + "\n".join(lines[-20:]))
        time.sleep(0.05)
    line = next(x for x in lines if "server up on :" in x)
    port = int(line.split("server up on :", 1)[1].split()[0])
    log(f"[remote ps] {line}")
    return f"127.0.0.1:{port}"


def start_ps_server(workers, env=None):
    """``spawn_ps_server`` and ``await_ps_server``: (process, its stderr
    lines, address)."""
    proc, lines = spawn_ps_server(workers, env)
    return proc, lines, await_ps_server(proc, lines)


def stop_ps_server(proc):
    """SIGTERM, then SIGKILL after 15 s; returns the exit code."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return proc.returncode


def _remote_want(cfg):
    """BERT-large's launches under PS int8 for one worker."""
    attn = _attention_launches(cfg, ("flash_bwd_fused",))

    def want(trainer):
        w = attn(trainer)
        nc = trainer.ps_exchange.n_compressed()
        w["int8_quantize"] = w["int8_dequantize"] = STEPS * nc
        return w
    return want


def _counted_ps_steps(trainer, data):
    """``STEPS`` steps with every launch counter and the metrics registry
    zeroed just before and read just after (the last cross-step tail
    drained first)."""
    from byteps_tpu_torch.obs.metrics import get_registry
    torch.cuda.synchronize()
    ctr = counters()
    zero_counts(ctr)
    get_registry().reset()
    losses, times = [], []
    for _ in range(STEPS):
        t = time.perf_counter()
        loss = trainer.step(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
    t = time.perf_counter()
    _drain(trainer)
    drain_s = time.perf_counter() - t
    return {"losses": losses, "launches": read_counts(ctr),
            "ms": _route_ms(times, drain_s),
            "metrics": get_registry().snapshot(),
            "params": _param_digests(trainer)}


def _ps_bytes(metrics):
    return (metrics["ps/push_bytes"] / STEPS, metrics["ps/pull_bytes"] / STEPS,
            metrics.get("transport/resends", 0))


def train_bert_ps_tcp():
    """Phase "remote PS" (a), world 1: BERT-large at ``CUT_LAYERS``, PS int8
    on the default route through the port's standalone server (``launch --server``, port
    0) and, in turn, in process, from the same seed and batch: the same
    losses, launches and parameters bit for bit (the transport changes no
    number), each arm's steps 2-3 printed beside the card."""
    cfg, loss_fn, data, _ = _bert_setup(layers=CUT_LAYERS)
    want = _remote_want(cfg)
    tag = "bert_large ps int8 tcp"
    arms = {}
    server, lines, addr = start_ps_server(1)
    try:
        for arm, env in (("tcp", {"BPS_SERVER_ADDRS": addr}),
                         ("in-process", {})):
            with _ps_world(dict(env, BPS_COMPRESS="int8")):
                trainer = _ps_trainer(cfg, loss_fn)
                r = arms[arm] = _counted_ps_steps(trainer, data)
                r["want"] = want(trainer)
                del trainer
                torch.cuda.empty_cache()
            push, pull, resends = _ps_bytes(r["metrics"])
            log(f"[{tag}] {arm}: losses {r['losses']}, steps 2-3 "
                f"{r['ms']:.1f} ms a step, ps/push_bytes {push:.0f} and "
                f"ps/pull_bytes {pull:.0f} a step, transport/resends "
                f"{resends}; launches {r['launches']}")
    finally:
        rc = stop_ps_server(server)
    tcp, local = arms["tcp"], arms["in-process"]
    log(f"[{tag}] in turns: tcp {tcp['ms']:.1f} ms, in-process "
        f"{local['ms']:.1f} ms a step ({card_line()}); server exit {rc}")
    for arm, r in arms.items():
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"{tag} {arm}: non-finite losses")
        if r["launches"] != r["want"]:
            raise AssertionError(f"{tag} {arm}: launches {r['launches']}, "
                                 f"expected {r['want']}")
    if tcp["losses"] != local["losses"] or tcp["params"] != local["params"]:
        raise AssertionError(f"{tag}: the TCP run's losses or parameters "
                             "differ from the in-process run's")
    if tcp["metrics"].get("transport/resends", 0):
        raise AssertionError(f"{tag}: transport/resends is not 0")
    if rc != 0:
        raise AssertionError(f"{tag}: the server exited {rc}:\n"
                             + "\n".join(lines[-20:]))
    log(f"[{tag}] losses and all {len(tcp['params'])} parameters bit for "
        "bit the in-process run's")
    SUMMARY[tag] = {"tcp_ms": tcp["ms"], "in_process_ms": local["ms"]}
    return tcp["launches"]


class _FallbackLines(logging.Handler):
    """The port logger's lines that say the sharded update fell back."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if "BPS_SHARDED_UPDATE falls back" in msg:
            self.lines.append(msg)


def _sharded_report(trainer):
    """What the (b1) gates read off a worker's trainer: the plan (owned
    groups, pull set, the groups covering each bucket, balance) and the
    groups whose parameters hold optimizer state."""
    st = trainer._sharded
    if st is None:
        return {"engaged": False}
    plan = st.plan
    return {"engaged": True, "owned": sorted(plan.owned),
            "groups": len(plan.groups),
            "with_state": trainer._chunked.groups_with_state(),
            "pull_buckets": sorted(plan.pull_buckets),
            "bucket_groups": [sorted(gi for gi, n in enumerate(plan.needed)
                                     if bi in n)
                              for bi in range(len(plan.bucket_labels))],
            "owner": plan.owner, "balance": plan.balance_ratio(),
            "load": plan.load}


WORLD2_ARMS = ("unsharded", "sharded")


def world2_worker(wid, where) -> int:
    """``--world2-worker WID DIR``: one of the two world-2 worker processes
    of phase "remote PS" (b) on ``cuda:0``, for both arms in turn: for
    each it waits for ``DIR/<arm>.addr``, the address of the arm's fresh
    server, runs the arm (``_world2_worker_arm``) and writes
    ``DIR/<arm>.w<WID>.json``."""
    import gc
    where = Path(where)
    for arm in WORLD2_ARMS:
        _await_file(where / f"{arm}.addr", f"server address for arm {arm}")
        report = _world2_worker_arm(wid, arm,
                                    (where / f"{arm}.addr").read_text())
        _write_json(where / f"{arm}.w{wid}.json", report)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def _world2_worker_arm(wid, arm, addr) -> dict:
    """One arm of ``world2_worker``: BERT-large PS int8 from seed 0 on its
    own batch (seed WID), ``STEPS`` counted steps, ``unsharded`` (b0) or
    ``sharded`` (b1, ``BPS_SHARDED_UPDATE=1``); its report: the losses,
    launches, wanted launches, bytes, resends, step time, a digest of
    every parameter's bytes, the optimizer state's bytes, the peak memory
    and, under (b1), the sharded plan and any fallback line."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.logging import get_logger
    from byteps_tpu_torch.models import bert
    for name in ("BPS_MAX_LAG", "BPS_ENABLE_ASYNC",
                 "BPS_FUSED_HOMOG") + TRANSPORT_KNOBS:
        os.environ.pop(name, None)
    os.environ.update(BPS_ENABLE_PS="1", BPS_COMPRESS="int8",
                      BPS_NUM_WORKER="2", BPS_WORKER_ID=str(wid),
                      BPS_LOCAL_RANK="0", BPS_SERVER_ADDRS=addr,
                      BPS_SHARDED_UPDATE="1" if arm == "sharded" else "0")
    fallbacks = _FallbackLines()
    get_logger().addHandler(fallbacks)
    bps.init()
    try:
        cfg, loss_fn, _, _ = _bert_setup(layers=CUT_LAYERS)
        data = bert.synth_mlm_batch(np.random.RandomState(wid), TRAIN_BATCH,
                                    BERT_SEQ, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        trainer = _ps_trainer(cfg, loss_fn)
        r = _counted_ps_steps(trainer, data)
        push, pull, resends = _ps_bytes(r["metrics"])
        digest = hashlib.sha1()
        param_bytes = 0
        for _, p in sorted(trainer.model.named_parameters()):
            digest.update(p.detach().cpu().numpy().tobytes())
            param_bytes += p.numel() * p.element_size()
        opt_bytes = sum(t.numel() * t.element_size()
                        for st in trainer.tx.state.values()
                        for t in st.values() if torch.is_tensor(t))
        (_, keyed), = trainer.ps_exchange._plans.values()
        plane = trainer.ps_exchange._cplane
        report = {
            "arm": arm, "losses": r["losses"], "launches": r["launches"],
            "want": _remote_want(cfg)(trainer), "ms": r["ms"],
            "push_bytes": push, "pull_bytes": pull, "resends": resends,
            "param_put_bytes": r["metrics"].get("ps/param_put_bytes", 0),
            "param_fetch_bytes": r["metrics"].get("ps/param_fetch_bytes", 0),
            "params": digest.hexdigest(), "param_bytes": param_bytes,
            "opt_state_bytes": opt_bytes,
            "peak_mem": torch.cuda.max_memory_allocated(),
            "buckets": len(keyed),
            "compressed": trainer.ps_exchange.n_compressed(),
            "compressed_buckets": [bi for bi, (k, _) in enumerate(keyed)
                                   if plane.active(k)],
            "sharded": _sharded_report(trainer),
            "fallbacks": fallbacks.lines}
        trainer.close()
        return report
    finally:
        get_logger().removeHandler(fallbacks)
        bps.shutdown()


def train_bert_ps_world2():
    """Phase "remote PS" (b), world 2, two arms in turn, each on its own
    server (``BPS_NUM_WORKER=2``) with two worker processes on ``cuda:0``
    (``world2_worker``), each worker from seed 0 on its own batch.

    (b0), unsharded: both workers end with the same parameters bit for bit
    (two arrivals sum alike in either order), finite losses, the launches
    their path makes and no resend.

    (b1), ``BPS_SHARDED_UPDATE=1``: each worker pulls and applies only the
    bucket groups it owns and installs the others from their owner's
    param frames. Both workers end with (b0)'s parameters bit for bit: at
    two workers the server's sums are (b0)'s, and an owner's frame is the
    bytes its apply made. That gate also holds the error feedback: a
    non-owner commits a skipped bucket's int8 residual when the bucket's
    frames land, and a missed commit would change its next push, the sum
    and so the parameters. Each worker engaged the sharded state (no
    fallback line); its optimizer state covers exactly its owned groups,
    and the two owned sets partition the groups; its launches are (b0)'s
    (every bucket is still encoded, and the dequantize kernel runs in the
    encode's error-feedback fold; a pulled payload is decoded on the
    host); the pull sets cover every bucket and share only the boundary
    buckets; its ``ps/pull_bytes`` is below (1/2 + 0.2) x its (b0) figure
    (the JAX test's bound); the put and the fetched param bytes, summed
    over the workers, are each ``STEPS`` x the parameters' fp32 bytes; no
    resend.

    The step times are two processes sharing one card, not a scaling
    figure. Both arms run in the same two worker processes
    (``_arms_over_servers``). Returns each arm's launches summed over its
    workers."""
    card = card_line()
    arms = {arm: res for arm, (res, _) in _arms_over_servers(
        "int8 world 2", "--world2-worker",
        dict.fromkeys(WORLD2_ARMS, {})).items()}
    for arm, res in arms.items():
        _check_world2(arm, res, card)
    _check_sharded(arms["unsharded"], arms["sharded"], card)
    SUMMARY["bert_large ps int8 world 2"] = {
        arm: {"ms": [r["ms"] for r in res]} for arm, res in arms.items()}
    return tuple({k: res[0]["launches"][k] + res[1]["launches"][k]
                  for k in res[0]["launches"]}
                 for res in (arms["unsharded"], arms["sharded"]))


def _check_world2(arm, res, card):
    """(b0)'s gates, which (b1) keeps."""
    tag = f"bert_large ps int8 world 2 {arm}"
    for wid, r in enumerate(res):
        log(f"[{tag}] worker {wid}: losses {r['losses']}, steps 2-3 "
            f"{r['ms']:.1f} ms a step (two worker processes share one "
            f"card), ps/push_bytes {r['push_bytes']:.0f} and ps/pull_bytes "
            f"{r['pull_bytes']:.0f} a step, transport/resends "
            f"{r['resends']}, {r['compressed']} of {r['buckets']} buckets "
            f"compressed; {card}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"{tag} worker {wid}: non-finite losses")
        if r["launches"] != r["want"]:
            raise AssertionError(f"{tag} worker {wid}: launches "
                                 f"{r['launches']}, expected {r['want']}")
        if r["resends"]:
            raise AssertionError(f"{tag} worker {wid}: transport/resends "
                                 f"{r['resends']}")
    if res[0]["params"] != res[1]["params"]:
        raise AssertionError(f"{tag}: the workers' parameters differ")
    if res[0]["losses"] == res[1]["losses"]:
        raise AssertionError(f"{tag}: both workers read the same batch")
    log(f"[{tag}] both workers' parameters bit for bit the same "
        f"(sha1 {res[0]['params']}); optimizer state "
        f"{[r['opt_state_bytes'] for r in res]} bytes, peak memory "
        f"{[r['peak_mem'] for r in res]} bytes")


def _check_sharded(b0, b1, card):
    """(b1)'s own gates, against (b0)."""
    tag = "bert_large ps int8 world 2 sharded"
    if b1[0]["params"] != b0[0]["params"]:
        raise AssertionError(f"{tag}: the parameters differ from the "
                             f"unsharded run's")
    for wid, r in enumerate(b1):
        sh = r["sharded"]
        if not sh["engaged"] or r["fallbacks"]:
            raise AssertionError(f"{tag} worker {wid}: the sharded update "
                                 f"fell back: {r['fallbacks']}")
        if sh["with_state"] != sh["owned"]:
            raise AssertionError(
                f"{tag} worker {wid}: optimizer state for groups "
                f"{sh['with_state']}, owned {sh['owned']}")
    groups = b1[0]["sharded"]["groups"]
    owned = [set(r["sharded"]["owned"]) for r in b1]
    if owned[0] & owned[1] or owned[0] | owned[1] != set(range(groups)):
        raise AssertionError(f"{tag}: owned groups {owned} do not partition "
                             f"the {groups} groups")
    pulls = [set(r["sharded"]["pull_buckets"]) for r in b1]
    owner = b1[0]["sharded"]["owner"]
    boundary = {bi for bi, gs in enumerate(b1[0]["sharded"]["bucket_groups"])
                if len({owner[g] for g in gs}) > 1}
    if pulls[0] | pulls[1] != set(range(b1[0]["buckets"])) \
            or pulls[0] & pulls[1] != boundary:
        raise AssertionError(f"{tag}: the pull sets do not cover every "
                             f"bucket once but the boundary ones {boundary}")
    for wid, (r0, r1) in enumerate(zip(b0, b1)):
        if not r1["pull_bytes"] < (0.5 + 0.2) * r0["pull_bytes"]:
            raise AssertionError(
                f"{tag} worker {wid}: ps/pull_bytes {r1['pull_bytes']} a "
                f"step, not below 0.7 x the unsharded {r0['pull_bytes']}")
    want = STEPS * b1[0]["param_bytes"]
    for key in ("param_put_bytes", "param_fetch_bytes"):
        got = b1[0][key] + b1[1][key]
        if got != want:
            raise AssertionError(f"{tag}: ps/{key} {got} summed over the "
                                 f"workers, expected {want}")
    comp = set(b1[0]["compressed_buckets"])
    log(f"[{tag}] balance_ratio {b1[0]['sharded']['balance']:.4f}, owned "
        f"bytes {b1[0]['sharded']['load']}, {groups} groups; owned "
        f"{[sorted(o) for o in owned]}; pull sets "
        f"{[len(p) for p in pulls]} of {b1[0]['buckets']} buckets "
        f"({len(boundary)} boundary), compressed buckets in each pull set "
        f"(decoded on the host) {[len(comp & p) for p in pulls]}")
    for wid, (r0, r1) in enumerate(zip(b0, b1)):
        log(f"[{tag}] worker {wid}: steps 2-3 {r1['ms']:.1f} ms a step "
            f"(unsharded {r0['ms']:.1f}), ps/pull_bytes "
            f"{r1['pull_bytes']:.0f} a step (unsharded "
            f"{r0['pull_bytes']:.0f}: {r1['pull_bytes'] / r0['pull_bytes']:.4f}), "
            f"ps/param_put_bytes {r1['param_put_bytes']} and "
            f"ps/param_fetch_bytes {r1['param_fetch_bytes']} in {STEPS} "
            f"steps, AdamW state {r1['opt_state_bytes']} bytes (unsharded "
            f"{r0['opt_state_bytes']}), peak memory {r1['peak_mem']} bytes "
            f"(unsharded {r0['peak_mem']}); {card}")
    log(f"[{tag}] both workers' parameters bit for bit the unsharded run's "
        f"(sha1 {b1[0]['params']}); optimizer state for owned groups only; "
        f"every gate held")


# ------------------ remote PS: bounded staleness at world 2 (dense PS)

# arm -> (BPS_MAX_LAG, the server's BPS_LAG_GRACE_MS, worker 1 held)
LAG_ARMS = {"c0": (1, 0, False), "c1": (2, 60000, False),
            "c2": (2, 0, True)}
LAG_HOLD_S = 2.0        # worker 1's hold before its step-2 push, (c2)


class LagHold:
    """Fault injection of arm (c2), on a worker's backend: each worker's
    round-1 pulls wait until the other worker pushed its whole round 1
    (files in ``where``), so round 1 completes: at grace 0 a round-1 pull
    that sealed before the other worker's first push of that key would
    make that worker seed its round from the server (the rejoin adopt)
    and join at round 2, and the two would apply different sums. Worker 1
    then holds every round-2 push until worker 0 has pulled a round-2 key
    (which the server therefore sealed without worker 1), and LAG_HOLD_S
    more."""

    def __init__(self, backend, wid, nkeys, where):
        import threading
        self.backend, self.wid, self.nkeys = backend, wid, nkeys
        self.where = Path(where)
        self.lock = threading.Lock()
        self.pushed, self.held = 0, False
        self.released = threading.Event()
        self.orig = (backend.push_lag, backend.pull_lag)
        backend.push_lag, backend.pull_lag = self._push, self._pull

    def _wait(self, name, timeout=REMOTE_WAIT):
        deadline = time.time() + timeout
        while not (self.where / name).exists():
            if time.time() > deadline:
                raise AssertionError(f"LagHold: {name} never appeared")
            time.sleep(0.005)

    def _push(self, key, worker, rnd, data):
        if self.wid == 1 and rnd == 2:
            with self.lock:
                first, self.held = not self.held, True
            if first:
                self._wait("w0.pulled2")
                time.sleep(LAG_HOLD_S)
                self.released.set()
            elif not self.released.wait(REMOTE_WAIT):
                raise AssertionError("LagHold: never released")
        self.orig[0](key, worker, rnd, data)
        if rnd == 1:
            with self.lock:
                self.pushed += 1
                done = self.pushed == self.nkeys
            if done:
                (self.where / f"w{self.wid}.pushed1").touch()

    def _pull(self, key, worker, rnd, out, timeout_ms=None):
        if rnd == 1:
            self._wait(f"w{1 - self.wid}.pushed1")
        flags = self.orig[1](key, worker, rnd, out, timeout_ms)
        if rnd == 2 and self.wid == 0:
            (self.where / "w0.pulled2").touch()
        return flags


def lag_ps_worker(wid, where) -> int:
    """``--lag-ps-worker WID DIR``: one of the two worker processes of the
    phase ``bert_large_ps_lag`` on ``cuda:0``, for every arm in turn (one
    process for the three arms: a process takes seconds to reach the
    card). For each arm it waits for ``DIR/<arm>.addr``, the address of the
    arm's fresh server, trains BERT-large dense PS (no ``BPS_COMPRESS``)
    on the default route from seed 0 on its own batch (seed WID) at the
    arm's ``BPS_MAX_LAG`` for ``STEPS`` counted steps ((c2) under
    ``LagHold``, its files in ``DIR/<arm>``), writes
    ``DIR/<arm>.w<WID>.json`` (losses, launches, wanted launches, bytes,
    resends, the lag verdicts it counted, the largest ``xstep/epoch_lag``,
    step time, a digest of every parameter's bytes, peak memory) and shuts
    its PS state down."""
    import gc
    where = Path(where)
    for arm in LAG_ARMS:
        addr_f = where / f"{arm}.addr"
        deadline = time.time() + REMOTE_WAIT
        while not addr_f.exists():
            if time.time() > deadline:
                raise AssertionError(f"no server address for arm {arm}")
            time.sleep(0.05)
        report = _lag_worker_arm(wid, arm, addr_f.read_text(), where)
        tmp = where / f"{arm}.w{wid}.json.tmp"
        tmp.write_text(json.dumps(report))
        tmp.rename(where / f"{arm}.w{wid}.json")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def _lag_worker_arm(wid, arm, addr, where) -> dict:
    """One arm of ``lag_ps_worker``: its report."""
    import os

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.obs.metrics import get_registry
    lag, _, hold = LAG_ARMS[arm]
    os.environ.pop("BPS_COMPRESS", None)
    os.environ.update(BPS_ENABLE_PS="1", BPS_NUM_WORKER="2",
                      BPS_WORKER_ID=str(wid), BPS_LOCAL_RANK="0",
                      BPS_SERVER_ADDRS=addr, BPS_MAX_LAG=str(lag),
                      BPS_SHARDED_UPDATE="0")
    bps.init()
    try:
        cfg, loss_fn, _, _ = _bert_setup(layers=CUT_LAYERS)
        data = bert.synth_mlm_batch(np.random.RandomState(wid), TRAIN_BATCH,
                                    BERT_SEQ, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        trainer = _ps_trainer(cfg, loss_fn)
        ex = trainer.ps_exchange
        ex.leaf_groups(trainer._ps_params, name=trainer._name)   # the plan
        (_, keyed), = ex._plans.values()
        if hold:
            (where / arm).mkdir(exist_ok=True)
            LagHold(ex.backend, wid, len(keyed), where / arm)
        torch.cuda.synchronize()
        ctr = counters()
        zero_counts(ctr)
        reg = get_registry()
        reg.reset()
        losses, times, epoch_lag = [], [], 0
        for _ in range(STEPS):
            t = time.perf_counter()
            loss = trainer.step(data)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(loss.item())
            epoch_lag = max(epoch_lag, reg.gauge("xstep/epoch_lag").value)
        t = time.perf_counter()
        _drain(trainer)
        drain_s = time.perf_counter() - t
        metrics = reg.snapshot()
        push, pull, resends = _ps_bytes(metrics)
        digest = hashlib.sha1()
        for _, p in sorted(trainer.model.named_parameters()):
            digest.update(p.detach().cpu().numpy().tobytes())
        report = {
            "arm": arm, "losses": losses, "launches": read_counts(ctr),
            "want": _attention_launches(cfg, ("flash_bwd_fused",))(trainer),
            "ms": _route_ms(times, drain_s), "push_bytes": push,
            "pull_bytes": pull, "resends": resends,
            "verdicts": {v: metrics.get(f"ps/lag_{v}", 0)
                         for v in ("complete", "stale", "barrier")},
            "lag_keys": sum(1 for k, _ in keyed if ex._lag_routes(k)),
            "buckets": len(keyed), "epoch_lag": epoch_lag,
            "params": digest.hexdigest(),
            "peak_mem": torch.cuda.max_memory_allocated()}
        trainer.close()
        return report
    finally:
        bps.shutdown()


def _await_reports(procs, reports, deadline):
    """Wait until every worker wrote its report (``reports[i]`` is worker
    ``i``'s); None then, else why not. A worker that exited after writing
    its report is done, not dead: after the last arm each exits as soon
    as its own report is out, maybe before its peer's. One that exited
    without it failed, and would wedge its peer."""
    while not all(f.exists() for f in reports):
        gone = [i for i, (p, f) in enumerate(zip(procs, reports))
                if p.poll() is not None and not f.exists()]
        if gone:
            return (f"worker {gone[0]} exited "
                    f"{procs[gone[0]].returncode} without its report")
        if time.time() > deadline:
            return "a worker timed out"
        time.sleep(0.2)
    return None


def _arms_over_servers(what, flag, server_env, where=None):
    """The arms of a world-2 phase in turn: for each arm of ``server_env``
    ({arm: the server's extra environment}) a fresh ``launch --server``
    (``BPS_NUM_WORKER=2``), served to the same two worker processes
    (``chip_smoke.py FLAG WID DIR``, which read ``DIR/<arm>.addr`` and
    write ``DIR/<arm>.w<WID>.json``); returns {arm: (the workers' reports,
    the server's stop-time stats)}. A worker's death or a timeout fails
    the phase (``bert_large ps WHAT``); every process is stopped. DIR is
    a fresh temporary directory, removed after, or ``where``, kept (the
    caller's, shared by two calls). Every arm's server is spawned at the
    start, so each boots while the arms before it run."""
    import os
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp()) if where is None else Path(where)
    procs, logs, out, servers = [], [], {}, {}
    failed = None
    try:
        for wid in (0, 1):
            logf = open(tmp / f"worker{wid}.log", "w")
            logs.append(logf)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, flag, str(wid), str(tmp)],
                cwd=ROOT, env=dict(os.environ), stdout=logf,
                stderr=subprocess.STDOUT))
        for arm, env in server_env.items():
            servers[arm] = spawn_ps_server(2, env)
        for arm in server_env:
            t = time.perf_counter()
            server, lines = servers[arm]
            try:
                addr = await_ps_server(server, lines)
                up = time.perf_counter() - t
                reports = [tmp / f"{arm}.w{w}.json" for w in (0, 1)]
                (tmp / f"{arm}.addr.tmp").write_text(addr)
                (tmp / f"{arm}.addr.tmp").rename(tmp / f"{arm}.addr")
                failed = _await_reports(procs, reports,
                                        time.time() + REMOTE_WAIT)
            finally:
                rc = stop_ps_server(server)
            stats = [json.loads(x.split("server stats ", 1)[1])
                     for x in lines if "server stats " in x]
            if failed is not None:
                failed = f"arm {arm}: {failed}"
                break
            if rc != 0 or len(stats) != 1:
                failed = (f"arm {arm}: the server exited {rc} with "
                          f"{len(stats)} stats lines:\n"
                          + "\n".join(lines[-20:]))
                break
            out[arm] = ([json.loads(f.read_text()) for f in reports],
                        stats[0])
            log(f"[{what}] arm {arm}: {time.perf_counter() - t:.1f} s, its "
                f"server up in {up:.1f} s")
        deadline = time.time() + 60
        while failed is None and any(p.poll() is None for p in procs) \
                and time.time() < deadline:
            time.sleep(0.2)
    finally:
        for server, _ in servers.values():
            stop_ps_server(server)      # an arm's that never ran
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for f in logs:
            f.close()
    for wid, p in enumerate(procs):
        text = (tmp / f"worker{wid}.log").read_text()
        log(f"----- {what} PS worker {wid} (exit {p.returncode})")
        log(text if failed or p.returncode else text[-1500:])
        if failed or p.returncode:
            # the error's end on stderr too, where a caller that keeps
            # only that stream still sees why
            print(f"----- {what} PS worker {wid} (exit {p.returncode}), its "
                  f"log's end:\n{text[-6000:]}", file=sys.stderr, flush=True)
    if where is None:
        shutil.rmtree(tmp, ignore_errors=True)
    if failed is None and any(p.returncode for p in procs):
        failed = "a worker exited with an error"
    if failed is not None:
        raise AssertionError(f"bert_large ps {what}: {failed}")
    return out


def train_bert_ps_lag():
    """Phase ``bert_large_ps_lag``: bounded staleness at world 2, BERT-large
    dense PS on the default route, two worker processes on ``cuda:0``
    (``lag_ps_worker``) and a fresh server for each arm, the same batches
    in every arm, the arms in turn:

    (c0) K=1: both workers end with the same sha1 of every parameter's
    bytes; finite losses; each worker's launches are BERT's (144 flash
    forwards, 72 fused backwards) and no codec kernel; no resend.

    (c1) K=2, the server's ``BPS_LAG_GRACE_MS=60000``: the same sha1 on
    both workers; every pull's verdict complete (no stale, no barrier
    counted by a worker); the server's ``lag/stale_serves`` and
    ``lag/late_folds`` 0; (c0)'s launches; the largest
    ``xstep/epoch_lag`` printed, and the sha1 beside (c0)'s (not gated: a
    forward may read epoch e-2).

    (c2) K=2, grace 0, ``LagHold`` on worker 1's step-2 push: the same
    sha1 on both workers (published sums are immutable snapshots); worker
    0 counted at least one stale verdict; the server's
    ``lag/stale_serves`` >= 1, ``lag/late_folds`` >= 1 and
    ``lag/max_streak`` <= 1 (its stop-time stats line: the stats scrape,
    op 23, is not ported); finite losses; (c0)'s launches.

    Each arm prints each worker's steps 2-3, push and pull bytes a step
    and peak memory, and the server's peak RSS, beside the card; none is
    gated (two processes share one card). Returns each arm's launches
    summed over its workers."""
    card = card_line()
    arms = _arms_over_servers(
        "lag", "--lag-ps-worker",
        {arm: {"BPS_LAG_GRACE_MS": str(grace)}
         for arm, (_, grace, _) in LAG_ARMS.items()})
    for arm, (res, stats) in arms.items():
        tag = f"bert_large ps lag {arm}"
        lag, grace, hold = LAG_ARMS[arm]
        # the store's own counters and gauge (not its per-key streaks)
        lag_stats = {k: v for k, v in stats.items()
                     if k.startswith("lag/") and k.count("/") == 1}
        for wid, r in enumerate(res):
            log(f"[{tag}] K={lag}, grace {grace} ms{', held' if hold else ''}"
                f"; worker {wid}: losses {r['losses']}, steps 2-3 "
                f"{r['ms']:.1f} ms a step (two worker processes share one "
                f"card), ps/push_bytes {r['push_bytes']:.0f} and "
                f"ps/pull_bytes {r['pull_bytes']:.0f} a step, "
                f"transport/resends {r['resends']}, verdicts "
                f"{r['verdicts']}, {r['lag_keys']} of {r['buckets']} "
                f"buckets on the lag store, largest xstep/epoch_lag "
                f"{r['epoch_lag']}, peak memory {r['peak_mem']} bytes; "
                f"{card}")
        log(f"[{tag}] server: peak RSS {stats['peak_rss_bytes']} bytes "
            f"({stats['peak_rss_source']}), "
            f"{lag_stats}; workers' sha1 {res[0]['params']} / "
            f"{res[1]['params']}")
        for wid, r in enumerate(res):
            if not all(math.isfinite(x) for x in r["losses"]):
                raise AssertionError(f"{tag} worker {wid}: non-finite losses")
            if r["launches"] != r["want"]:
                raise AssertionError(f"{tag} worker {wid}: launches "
                                     f"{r['launches']}, expected {r['want']}")
            if r["lag_keys"] != (r["buckets"] if lag > 1 else 0):
                raise AssertionError(f"{tag} worker {wid}: {r['lag_keys']} "
                                     f"of {r['buckets']} buckets on the lag "
                                     f"store")
        if res[0]["params"] != res[1]["params"]:
            raise AssertionError(f"{tag}: the workers' parameters differ")
        if res[0]["losses"] == res[1]["losses"]:
            raise AssertionError(f"{tag}: both workers read the same batch")
        if arm == "c0" and any(r["resends"] for r in res):
            raise AssertionError(f"{tag}: transport/resends is not 0")
        if arm == "c1":
            if any(r["verdicts"]["stale"] or r["verdicts"]["barrier"]
                   or r["verdicts"]["complete"] != STEPS * r["buckets"]
                   for r in res):
                raise AssertionError(f"{tag}: a pull's verdict was not "
                                     f"complete: {[r['verdicts'] for r in res]}")
            if stats["lag/stale_serves"] or stats["lag/late_folds"]:
                raise AssertionError(f"{tag}: the server sealed or folded "
                                     f"late: {lag_stats}")
        if arm == "c2":
            if res[0]["verdicts"]["stale"] < 1:
                raise AssertionError(f"{tag}: worker 0 saw no stale verdict")
            if stats["lag/stale_serves"] < 1 or stats["lag/late_folds"] < 1 \
                    or stats["lag/max_streak"] > 1:
                raise AssertionError(f"{tag}: server {lag_stats}")
    log(f"[bert_large ps lag] sha1 (c0) {arms['c0'][0][0]['params']}, (c1) "
        f"{arms['c1'][0][0]['params']} (not gated: a forward may read epoch "
        f"e-2), (c2) {arms['c2'][0][0]['params']}; every gate held")
    SUMMARY["bert_large ps lag"] = {
        arm: {"ms": [r["ms"] for r in res],
              "epoch_lag": [r["epoch_lag"] for r in res],
              "peak_mem": [r["peak_mem"] for r in res],
              "server_peak_rss": stats["peak_rss_bytes"],
              "lag": {k: v for k, v in stats.items()
                      if k.startswith("lag/") and k.count("/") == 1}}
        for arm, (res, stats) in arms.items()}
    return tuple({k: res[0]["launches"][k] + res[1]["launches"][k]
                  for k in res[0]["launches"]}
                 for res, _ in arms.values())


# ------------- async PS: BERT-large dense at world 1 and 2, an fp32 store

# arm -> BPS_ASYNC_WIRE_DTYPE of the world-2 arms (d1) and (d2); (d0) is
# world 1 in process at the fp32 wire
ASYNC_ARMS = {"d1": None, "d2": "bfloat16"}
ASYNC_FOLD_WAIT = 120       # seconds the engine may take for its last folds
# the arm whose server's resident set the parent samples, and where
# ``--async-ps`` has the workers, the store checked, take ASYNC_SOAK more
# steps: 3 + 7 steps show whether it levels off or grows with the pushes
# (the full run leaves the soak out, for its time limit)
ASYNC_SOAK_ARM, ASYNC_SOAK = "d1", 7
# glibc's HEAP_MAX_SIZE on 64-bit: each thread arena's heap is a mapping
# aligned to it
ARENA_ALIGN = 64 << 20


class RssSampler:
    """Another process's resident set (``/proc/<pid>/statm``) every
    ``interval`` s on a thread; ``stop()`` returns [(wall time, bytes)]."""

    def __init__(self, pid, interval=1.0):
        import threading
        self.samples = []
        self._done = threading.Event()
        page = os.sysconf("SC_PAGE_SIZE")

        def run():
            while True:
                try:
                    with open(f"/proc/{pid}/statm") as f:
                        n = int(f.read().split()[1]) * page
                except (OSError, ValueError, IndexError):
                    return
                self.samples.append((time.time(), n))
                if self._done.wait(interval):
                    return

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        self._done.set()
        self._thread.join()
        return self.samples


def memory_map(pid=None, text=None):
    """A process's resident set by kind of mapping, in bytes, from
    ``/proc/<pid>/smaps`` (or its ``text``): ``brk`` (the main malloc
    arena), ``arenas`` (anonymous mappings aligned to ``ARENA_ALIGN``: the
    heaps of glibc's thread arenas), ``anon`` (other anonymous mappings:
    the blocks malloc maps on their own, the store's among them),
    ``files`` (libraries and other files); None where it cannot be
    read."""
    if text is None:
        try:
            with open(f"/proc/{pid}/smaps") as f:
                text = f.read()
        except OSError:
            return None
    out = dict.fromkeys(("brk", "arenas", "anon", "files"), 0)
    kind = None
    for line in text.splitlines():
        head = line.split()
        if not head:
            continue
        if not head[0].endswith(":"):           # a mapping's first line
            path = head[5] if len(head) > 5 else ""
            start = int(head[0].split("-")[0], 16)
            kind = ("brk" if path == "[heap]" else
                    "files" if path.startswith("/") else
                    "arenas" if not path and start % ARENA_ALIGN == 0 else
                    "anon")
        elif head[0] == "Rss:" and kind is not None:
            out[kind] += int(head[1]) * 1024
    return out if kind is not None else None


def rss_at(samples, ends):
    """The largest sample taken up to each of ``ends`` (bytes)."""
    return [max((n for t, n in samples if t <= end), default=0)
            for end in ends]


class DeltaLog:
    """On a worker's PS backend: the host copy of every delta it pushed, a
    list a key in push order (the arrays the backend was given: fp32, or
    the bf16 bits under the bf16 wire)."""

    def __init__(self, backend):
        self.pushed = {}
        self._backend = backend
        real = backend.push

        def push(key, data):
            real(key, data)
            self.pushed.setdefault(key, []).append(np.array(data, copy=True))

        backend.push = push

    def stop(self):
        """The backend's own ``push`` again."""
        del self._backend.push


class PullRounds:
    """On a worker's async PS backend, while ``on``: each key's round read
    just before its pull. The engine bumps a key's round under the lock
    that its fold and every pull take, so the pull saw at least that many
    folds."""

    def __init__(self, backend):
        self.on, self.seen = False, {}
        self._backend = backend
        real = backend.pull

        def pull(key, out, *args, **kwargs):
            if self.on:
                self.seen[key] = backend.round(key)
            real(key, out, *args, **kwargs)

        backend.pull = pull

    def stop(self):
        """The backend's own ``pull`` again."""
        del self._backend.pull


def async_installed(trainer):
    """The leaves of an async PS trainer whose parameter is not, bit for
    bit, the host buffer its last pull wrote: the store's weights that
    the step must have installed (fp32 pulls into fp32 parameters)."""
    hosts, _ = trainer._pulled
    bad = 0
    for (_, p), h in zip(trainer._ps_params, hosts):
        got = p.detach().reshape(-1).to("cpu", copy=True)
        bad += got.dtype != h.dtype or not torch.equal(
            got.view(torch.int32), h.view(torch.int32))
    return bad


def async_own_only(init, pushed, seen, keys, hosts, own):
    """At world 2: (the keys whose last pull began after the other
    worker's folds, its round before the pull above ``own``, this worker's
    pushes; those of them whose pulled weights are still init plus this
    worker's own deltas alone, folded in push order in fp32, bit for
    bit). ``pushed``: a key's deltas as pushed (bf16 bits widened)."""
    from byteps_tpu_torch.common import bf16
    other = same = 0
    for k, key in enumerate(keys):
        if seen.get(key, 0) <= own:
            continue
        other += 1
        want = init[k]
        for d in pushed[key]:
            want = want + bf16.cast(d, "float32")
        same += np.asarray(hosts[k]).tobytes() == want.tobytes()
    return other, same


def async_store_check(init, deltas, store, folds, device="cpu"):
    """The async store against the float64 sum of ``init`` and every delta
    (fp32 host arrays, folded by the server in an order nobody defined),
    within the bound of ``folds`` fp32 folds: each rounds to nearest, so it
    adds at most 2^-24 of its running value, and no running value exceeds
    |init| + sum |delta|; one fold more covers the float64 sum and the
    second-order terms. The float64 sums run on ``device`` (IEEE float64
    there as on the host: the same result, faster on the card). Returns
    (elements over the bound, the largest |store - sum| / bound)."""
    def f64(x):
        return torch.from_numpy(np.asarray(x)).to(device, torch.float64)

    s = f64(init)
    a = s.abs()
    for d in deltas:
        d = f64(d)
        s += d
        a += d.abs()
    bound = a.mul_((folds + 1) * 2.0 ** -24)
    err = (f64(store) - s).abs_()
    over = int((err > bound).sum())
    ratio = torch.where(bound > 0, err / bound, torch.zeros_like(err))
    return over, float(ratio.max()) if ratio.numel() else 0.0


def _await_folds(backend, keys, want, timeout=ASYNC_FOLD_WAIT):
    """Every key's round (the pushes its async store folded) once each is
    ``want``, or at the deadline."""
    deadline = time.time() + timeout
    while True:
        rounds = [backend.round(k) for k in keys]
        if all(r >= want for r in rounds) or time.time() > deadline:
            return rounds
        time.sleep(0.05)


def _async_counted(trainer, data, rounds=None):
    """``STEPS`` counted steps of an async PS trainer, every launch count
    and the metrics registry zeroed just before: losses, launches, steps
    2-3 a step, ``ps/push_bytes`` and ``ps/pull_bytes`` a step, each
    step's end on the wall clock. ``rounds`` (a ``PullRounds``) records
    the last step's pulls."""
    from byteps_tpu_torch.obs.metrics import get_registry
    torch.cuda.synchronize()
    ctr = counters()
    zero_counts(ctr)
    reg = get_registry()
    reg.reset()
    losses, times, ends = [], [], []
    for i in range(STEPS):
        if rounds is not None:
            rounds.on = i == STEPS - 1
        t = time.perf_counter()
        loss = trainer.step(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        ends.append(time.time())
        losses.append(loss.item())
    if rounds is not None:
        rounds.on = False
    m = reg.snapshot()
    return {"losses": losses, "launches": read_counts(ctr),
            "ms": _route_ms(times, 0.0), "ends": ends,
            "push_bytes": m["ps/push_bytes"] / STEPS,
            "pull_bytes": m["ps/pull_bytes"] / STEPS}


def _async_init(cfg):
    """The initial weights every worker seeds the store with (seed 0), a
    flat fp32 array a leaf in the trainer's key order (the JAX tree's)."""
    from byteps_tpu_torch.models.transformer import Transformer
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    named = sorted(model.named_parameters(), key=lambda kv: kv[0].split("."))
    return [p.detach().reshape(-1).numpy() for _, p in named]


def _async_d0():
    """Arm (d0): world 1, the in-process async server, the fp32 wire. The
    engine folds one pusher's pushes of a key in the order they were
    queued (a key sticks to one engine thread, whose queue is FIFO), so
    the store must be the fp32 replay of init and the pushed deltas in
    push order, bit for bit."""
    cfg, loss_fn, data, _ = _bert_setup()
    with _ps_world({"BPS_ENABLE_ASYNC": "1"}):
        torch.cuda.reset_peak_memory_stats()
        trainer = _ps_trainer(cfg, loss_fn)
        w = trainer._async_worker
        init = [p.detach().reshape(-1).to("cpu", copy=True).numpy()
                for _, p in trainer._ps_params]
        dlog = DeltaLog(w.backend)
        r = _async_counted(trainer, data)
        r["peak_mem"] = torch.cuda.max_memory_allocated()
        r["want"] = _attention_launches(cfg, ("flash_bwd_fused",))(trainer)
        r["rounds"] = sorted(set(_await_folds(w.backend, w.keys, STEPS)))
        r["pushes"] = sorted({len(v) for v in dlog.pushed.values()})
        r["wire"] = sorted({str(a.dtype) for v in dlog.pushed.values()
                            for a in v})
        bad = 0
        for k, key in enumerate(w.keys):
            want = init[k]
            for d in dlog.pushed[key]:
                want = want + d            # fp32, in push order
            got = np.empty(want.size, np.float32)
            w.backend.pull(key, got)
            bad += got.tobytes() != want.tobytes()
        r["store_bad"] = bad
        r["installed_bad"] = async_installed(trainer)
        r["n_params"] = sum(w.sizes)
        trainer.close()
    del trainer, dlog, init
    torch.cuda.empty_cache()
    return r


def _await_file(path, what):
    """Wait for ``path`` (written by the phase's parent process)."""
    deadline = time.time() + REMOTE_WAIT
    while not path.exists():
        if time.time() > deadline:
            raise AssertionError(f"no {what}")
        time.sleep(0.05)


def _write_json(path, obj):
    """``obj`` as JSON at ``path``, whole or not at all."""
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj))
    tmp.rename(path)


def async_ps_worker(wid, where, soak=0) -> int:
    """``--async-ps-worker WID DIR SOAK``: one of the two worker processes
    of the arms (d1) and (d2) of ``bert_large_ps_async`` on ``cuda:0``, for each
    arm in turn (one process for both: a process takes seconds to reach
    the card). For each arm it waits for ``DIR/<arm>.addr``, the address
    of the arm's fresh async server, trains BERT-large dense async PS from
    seed 0 on its own batch (seed WID) at the arm's
    ``BPS_ASYNC_WIRE_DTYPE`` for ``STEPS`` counted steps, writes the host
    copy of every delta it pushed, a file a step
    (``DIR/<arm>.w<WID>.s<step>.bin``: the keys' deltas in key order),
    then ``DIR/<arm>.w<WID>.json`` (losses, launches, wanted launches,
    bytes a step, step times and ends, keys and sizes, the wire's dtype,
    peak memory, the install and own-only checks). In arm
    ``ASYNC_SOAK_ARM``, if ``soak``, it then waits for ``DIR/<arm>.checked``
    (the store checked) and takes ``soak`` more steps, their ends in
    ``DIR/<arm>.w<WID>.soak.json``. Then it shuts its PS state down."""
    import gc
    where = Path(where)
    for arm in ASYNC_ARMS:
        _await_file(where / f"{arm}.addr", f"server address for arm {arm}")
        _async_worker_arm(wid, arm, (where / f"{arm}.addr").read_text(),
                          where, soak)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def _async_worker_arm(wid, arm, addr, where, soak) -> None:
    """One arm of ``async_ps_worker``."""
    import os

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common import bf16
    from byteps_tpu_torch.models import bert
    for name in ("BPS_COMPRESS", "BPS_MAX_LAG", "BPS_ASYNC_WIRE_DTYPE",
                 "BPS_ASYNC_PULL_DTYPE"):
        os.environ.pop(name, None)
    if ASYNC_ARMS[arm]:
        os.environ["BPS_ASYNC_WIRE_DTYPE"] = ASYNC_ARMS[arm]
    os.environ.update(BPS_ENABLE_PS="1", BPS_ENABLE_ASYNC="1",
                      BPS_NUM_WORKER="2", BPS_WORKER_ID=str(wid),
                      BPS_LOCAL_RANK="0", BPS_SERVER_ADDRS=addr,
                      BPS_SHARDED_UPDATE="0")
    bps.init()
    try:
        cfg, loss_fn, _, _ = _bert_setup(layers=CUT_LAYERS)
        data = bert.synth_mlm_batch(np.random.RandomState(wid), TRAIN_BATCH,
                                    BERT_SEQ, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        trainer = _ps_trainer(cfg, loss_fn)
        w = trainer._async_worker
        init = [p.detach().reshape(-1).to("cpu", copy=True).numpy()
                for _, p in trainer._ps_params]
        dlog, rounds = DeltaLog(w.backend), PullRounds(w.backend)
        r = _async_counted(trainer, data, rounds)
        dlog.stop()
        rounds.stop()
        r["peak_mem"] = torch.cuda.max_memory_allocated()
        r["want"] = _attention_launches(cfg, ("flash_bwd_fused",))(trainer)
        r["keys"], r["sizes"] = list(w.keys), list(w.sizes)
        r["pushes"] = sorted({len(v) for v in dlog.pushed.values()})
        r["wire"] = sorted({bf16.dtype_name(a) for v in dlog.pushed.values()
                            for a in v})
        r["installed_bad"] = async_installed(trainer)
        r["saw_other"], r["own_only"] = async_own_only(
            init, dlog.pushed, rounds.seen, w.keys, trainer._pulled[1],
            STEPS)
        del init
        for step in range(min(r["pushes"])):
            with open(where / f"{arm}.w{wid}.s{step}.bin", "wb") as f:
                for key in w.keys:
                    f.write(memoryview(
                        np.ascontiguousarray(dlog.pushed[key][step]))
                        .cast("B"))
        del dlog
        _write_json(where / f"{arm}.w{wid}.json", r)
        if arm == ASYNC_SOAK_ARM and soak:
            _await_file(where / f"{arm}.checked", f"store check of {arm}")
            ends = []
            for _ in range(soak):
                trainer.step(data)
                torch.cuda.synchronize()
                ends.append(time.time())
            _write_json(where / f"{arm}.w{wid}.soak.json", ends)
        trainer.close()
    finally:
        bps.shutdown()


def _async_arm_store(addr, res, where, arm, init):
    """An arm's store after both workers stopped: the folds awaited (each
    key's round at ``STEPS`` x 2), then every key pulled and held against
    the float64 sum of init and both workers' reported deltas
    (``async_store_check``). Returns (rounds seen, elements over the
    bound, the largest error over bound)."""
    from byteps_tpu_torch.common import bf16
    from byteps_tpu_torch.server.transport import RemotePSBackend
    keys, sizes = res[0]["keys"], res[0]["sizes"]
    if res[1]["keys"] != keys or sizes != [a.size for a in init]:
        raise AssertionError(f"arm {arm}: the workers' keys or sizes differ")
    wide = ASYNC_ARMS[arm] is None
    files = [np.memmap(where / f"{arm}.w{wid}.s{step}.bin", mode="c",
                       dtype=np.float32 if wide else np.uint16)
             for wid in (0, 1) for step in range(STEPS)]
    client = RemotePSBackend([addr], async_mode=True)
    try:
        rounds = _await_folds(client, keys, 2 * STEPS)
        over, worst, off = 0, 0.0, 0
        for key, n, x0 in zip(keys, sizes, init):
            parts = [f[off:off + n] for f in files]
            deltas = parts if wide else [bf16.widen(p) for p in parts]
            store = np.empty(n, np.float32)
            client.pull(key, store)
            o, r = async_store_check(x0, deltas, store, 2 * STEPS, "cuda")
            over, worst, off = over + o, max(worst, r), off + n
    finally:
        client.close()
        del files
    return sorted(set(rounds)), over, worst


def _async_world2(init, soak):
    """Arms (d1) and (d2) in turn: for each a fresh async server
    (``BPS_NUM_WORKER=2 BPS_ENABLE_ASYNC=1``), served to the same two
    worker processes (``async_ps_worker``); after both reported, the
    store is checked against their deltas (then in ``ASYNC_SOAK_ARM``
    the workers take ``soak`` more steps), then the server stops. Returns
    {arm: (the workers' reports, the server's stop-time stats, (rounds,
    over, worst), in ``ASYNC_SOAK_ARM`` (the server's resident set
    sampled, its ``memory_map`` after the last step, each worker's step
    ends))}. Every process is stopped."""
    import os
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp())
    procs, logs, out = [], [], {}
    failed = None
    try:
        for wid in (0, 1):
            logf = open(tmp / f"worker{wid}.log", "w")
            logs.append(logf)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--async-ps-worker", str(wid),
                 str(tmp), str(soak)], cwd=ROOT, env=dict(os.environ), stdout=logf,
                stderr=subprocess.STDOUT))
        for arm in ASYNC_ARMS:
            server, lines, addr = start_ps_server(2, {"BPS_ENABLE_ASYNC": "1"})
            reports = [tmp / f"{arm}.w{w}.json" for w in (0, 1)]
            check = mem = None
            rss = RssSampler(server.pid) if arm == ASYNC_SOAK_ARM else None
            try:
                (tmp / f"{arm}.addr.tmp").write_text(addr)
                (tmp / f"{arm}.addr.tmp").rename(tmp / f"{arm}.addr")
                failed = _await_reports(procs, reports,
                                        time.time() + REMOTE_WAIT)
                if failed is None:
                    res = [json.loads(f.read_text()) for f in reports]
                    check = _async_arm_store(addr, res, tmp, arm, init)
                ends = [r["ends"] for r in res] if failed is None else None
                if failed is None and rss is not None and soak:
                    _write_json(tmp / f"{arm}.checked", True)
                    soaks = [tmp / f"{arm}.w{w}.soak.json" for w in (0, 1)]
                    failed = _await_reports(procs, soaks,
                                            time.time() + REMOTE_WAIT)
                    if failed is None:
                        ends = [e + json.loads(f.read_text())
                                for e, f in zip(ends, soaks)]
                if failed is None and rss is not None:
                    mem = (rss.stop(), memory_map(server.pid), ends)
            finally:
                if rss is not None:
                    rss.stop()
                rc = stop_ps_server(server)
                for f in tmp.glob(f"{arm}.w*.s*.bin"):
                    f.unlink()
            stats = [json.loads(x.split("server stats ", 1)[1])
                     for x in lines if "server stats " in x]
            if failed is not None:
                failed = f"arm {arm}: {failed}"
                break
            if rc != 0 or len(stats) != 1:
                failed = (f"arm {arm}: the server exited {rc} with "
                          f"{len(stats)} stats lines:\n"
                          + "\n".join(lines[-20:]))
                break
            out[arm] = (res, stats[0], check, mem)
        deadline = time.time() + 60
        while failed is None and any(p.poll() is None for p in procs) \
                and time.time() < deadline:
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for f in logs:
            f.close()
    for wid, p in enumerate(procs):
        text = (tmp / f"worker{wid}.log").read_text()
        log(f"----- async PS worker {wid} (exit {p.returncode})")
        log(text if failed or p.returncode else text[-1500:])
        if failed or p.returncode:
            print(f"----- async PS worker {wid} (exit {p.returncode}), its "
                  f"log's end:\n{text[-6000:]}", file=sys.stderr, flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    if failed is None and any(p.returncode for p in procs):
        failed = "a worker exited with an error"
    if failed is not None:
        raise AssertionError(f"bert_large ps async: {failed}")
    return out


def check_bf16_card():
    """The card's float32 -> bfloat16 conversion (torch's ``.to``, which
    rounds the (d2) deltas) against the host codec (``common/bf16.py``,
    ``ml_dtypes``' bytes in the CPU tests) on every value class and on
    delta-like values at every magnitude: bit for bit but NaN, where each
    writes a NaN of its own bits."""
    from byteps_tpu_torch.common import bf16
    rng = np.random.RandomState(0)
    special = np.array(
        [0x00000000, 0x80000000, 0x3F808000, 0x3F818000, 0x3F807FFF,
         0x00000001, 0x00008000, 0x00018000, 0x007FFFFF, 0x807FFFFF,
         0x00800000, 0x7F800000, 0xFF800000, 0x7F7F7FFF, 0x7F7F8000,
         0xFF7FFFFF, 0x7F800001, 0xFFC12345], np.uint32)
    x = np.concatenate([
        special.view(np.float32),
        rng.randint(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(
            np.uint32).view(np.float32),
        (rng.randn(1 << 20) * 10.0 ** rng.randint(-12, 3, 1 << 20)).astype(
            np.float32)])
    card = (torch.from_numpy(x).cuda().to(torch.bfloat16)
            .view(torch.int16).cpu().numpy().view(np.uint16))
    with np.errstate(invalid="ignore"):
        host = bf16.narrow(x).view(np.uint16)
    nan = np.isnan(x)
    bad = int(np.count_nonzero(card[~nan] != host[~nan]))
    log(f"[bert_large ps async] bf16 rounding on the card vs the host "
        f"codec: {x.size - int(nan.sum())} values, {bad} differ; "
        f"{int(nan.sum())} NaN inputs, card writes "
        f"{sorted({hex(v) for v in card[nan]})}")
    if bad or not np.isnan(bf16.widen(card[nan])).all():
        raise AssertionError("bert_large ps async: the card's bf16 rounding "
                             "differs from the host codec's")


def train_bert_ps_async(soak=0):
    """Phase ``bert_large_ps_async``: async PS (``BPS_ENABLE_ASYNC=1``),
    BERT-large dense at full width, batch 8, ``STEPS`` counted steps,
    three arms: (d0) world 1 in process, at full depth; (d1) world 2, two
    worker processes on ``cuda:0`` on their own batches against a fresh
    ``launch --server`` with ``BPS_ENABLE_ASYNC=1``, the fp32 wire; (d2)
    the same at ``BPS_ASYNC_WIRE_DTYPE=bfloat16`` (one pair of workers for
    both, a fresh server each); (d1) and (d2) at ``CUT_LAYERS``, for the
    full run's time limit.

    Gates, every worker of every arm: the launches of BERT's path (144
    flash forwards, 72 fused backwards, all d 64) and no codec kernel;
    finite losses, step 3 below step 1; every key pushed once a step. Each
    key's round, once the engine drained, is the pushes folded into it:
    ``STEPS`` x the workers. The store: (d0) the fp32 replay of init and
    its deltas in push order, bit for bit; (d1) and (d2) within
    ``async_store_check``'s bound of the float64 sum of init and both
    workers' reported deltas (the bf16 ones as pushed); before the arms,
    the card's bf16 rounding bit for bit the host codec's. Bytes a step:
    (d0) and (d1) push 4 x the parameters, (d2) exactly half; every arm
    pulls 4 x the parameters (the store stays fp32). After the counted
    steps every parameter is, bit for bit, the weights the last pull
    wrote (``async_installed``); at world 2, a key whose last pull began
    after the other worker's folds was not pulled as init plus the
    worker's own deltas alone, and there is such a key
    (``async_own_only``).

    Printed, not gated: steps 2-3 and peak memory per worker, the
    servers' peak RSS, beside the card; in (d1) the server's resident set
    at the end of each of ``STEPS`` + ``soak`` steps (the soak steps
    taken after the store check: ``--async-ps`` takes ``ASYNC_SOAK``, the
    full run none) and by mapping after them (``memory_map``). Returns
    each arm's launches summed over its workers."""
    card = card_line()
    check_bf16_card()
    d0 = _async_d0()
    cfg, _, _, _ = _bert_setup(layers=CUT_LAYERS)
    init = _async_init(cfg)
    n_cut = sum(a.size for a in init)
    arms = _async_world2(init, soak)
    del init
    rows = [("d0", 0, d0)] + [(arm, wid, r) for arm, (res, *_)
                               in arms.items() for wid, r in enumerate(res)]
    for arm, wid, r in rows:
        tag = f"bert_large ps async {arm}"
        n = d0["n_params"] if arm == "d0" else n_cut
        log(f"[{tag}] worker {wid}: losses {r['losses']}, steps 2-3 "
            f"{r['ms']:.1f} ms a step, ps/push_bytes {r['push_bytes']:.0f} "
            f"and ps/pull_bytes {r['pull_bytes']:.0f} a step ({n} "
            f"parameters), wire {r['wire']}, peak memory {r['peak_mem']} "
            f"bytes; {card}")
        if not all(math.isfinite(x) for x in r["losses"]) \
                or not r["losses"][2] < r["losses"][0]:
            raise AssertionError(f"{tag} worker {wid}: losses {r['losses']}")
        if r["launches"] != r["want"]:
            raise AssertionError(f"{tag} worker {wid}: launches "
                                 f"{r['launches']}, expected {r['want']}")
        if r["pushes"] != [STEPS]:
            raise AssertionError(f"{tag} worker {wid}: pushes a key "
                                 f"{r['pushes']}, expected {STEPS}")
        if r["installed_bad"]:
            raise AssertionError(f"{tag} worker {wid}: {r['installed_bad']} "
                                 f"parameters are not the weights the last "
                                 f"pull wrote")
        narrow = ASYNC_ARMS.get(arm) == "bfloat16"
        if r["wire"] != (["bfloat16"] if narrow else ["float32"]) \
                or r["push_bytes"] != (2 if narrow else 4) * n \
                or r["pull_bytes"] != 4 * n:
            raise AssertionError(f"{tag} worker {wid}: wire {r['wire']}, "
                                 f"push {r['push_bytes']} and pull "
                                 f"{r['pull_bytes']} bytes a step")
    if d0["rounds"] != [STEPS] or d0["store_bad"]:
        raise AssertionError(f"bert_large ps async d0: rounds {d0['rounds']}"
                             f", {d0['store_bad']} keys off the replay")
    log(f"[bert_large ps async d0] every key's round {STEPS}; the store is "
        f"the fp32 replay of init and the deltas in push order, bit for bit")
    log(f"[bert_large ps async d0] every parameter is, bit for bit, the "
        f"weights the last pull wrote")
    for arm, (res, stats, (rounds, over, worst), mem) in arms.items():
        tag = f"bert_large ps async {arm}"
        log(f"[{tag}] rounds {rounds}; the store against the float64 sum of "
            f"init and both workers' deltas: {over} elements over the bound "
            f"of {2 * STEPS + 1} fp32 folds, the largest error "
            f"{worst:.4f} of it; server peak RSS {stats['peak_rss_bytes']} "
            f"bytes ({stats['peak_rss_source']}); {card}")
        if rounds != [2 * STEPS] or over:
            raise AssertionError(f"{tag}: rounds {rounds}, {over} elements "
                                 f"over the bound")
        if res[0]["losses"] == res[1]["losses"]:
            raise AssertionError(f"{tag}: both workers read the same batch")
        seen = [r["saw_other"] for r in res]
        log(f"[{tag}] keys whose last pull began after the other worker's "
            f"folds: {seen} of {len(res[0]['keys'])} (workers 0, 1); of "
            f"them pulled as init plus the worker's own deltas alone: "
            f"{[r['own_only'] for r in res]}")
        if not sum(seen) or any(r["own_only"] for r in res):
            raise AssertionError(f"{tag}: the pulled weights do not hold the "
                                 f"other worker's deltas")
        if mem is not None:
            samples, mmap, ends = mem
            log(f"[{tag}] server RSS, the largest sample (every 1 s) up to "
                f"the end of each of {STEPS} + {soak} steps, bytes: "
                f"worker 0 {rss_at(samples, ends[0])}, worker 1 "
                f"{rss_at(samples, ends[1])}; after them by mapping "
                f"{mmap}; {card}")
    log("[bert_large ps async] every gate held")
    SUMMARY["bert_large ps async"] = {
        "d0": {"ms": d0["ms"], "peak_mem": d0["peak_mem"]},
        **{arm: {"ms": [r["ms"] for r in res],
                 "peak_mem": [r["peak_mem"] for r in res],
                 "server_peak_rss": stats["peak_rss_bytes"],
                 "store_worst": check[2]}
           for arm, (res, stats, check, _) in arms.items()}}
    return (d0["launches"],) + tuple(
        {k: res[0]["launches"][k] + res[1]["launches"][k]
         for k in res[0]["launches"]} for res, *_ in arms.values())


# ------- the PS store's routes at world 2: the engine-side fused route and
# row-sparse rounds; full-tree checkpoints at world 1

# arm -> the server's BPS_FUSED_HOMOG: (e0) unset, the homogeneous store
# owns the fused keys; (e1) 0, the summation engine does
ROUTE_ARMS = {"e0": None, "e1": "0"}
# (e2): row-sparse rounds on BERT-large's vocabulary table against (e1)'s
# server, after (e1)'s steps, under one name
RS_ARM, RS_ROUNDS, RS_NAME = "e1", 3, "bert.embed.tok"


def _rs_ids(wid, vocab):
    """Worker ``wid``'s token ids, its training batch's (duplicates kept)."""
    from byteps_tpu_torch.models import bert
    return bert.synth_mlm_batch(np.random.RandomState(wid), TRAIN_BATCH,
                                BERT_SEQ, vocab)[0].reshape(-1)


def _rs_rows(wid, rnd, cols):
    """Worker ``wid``'s rows of round ``rnd``, drawn on the card from a
    generator seeded by (worker, round)."""
    g = torch.Generator(device="cuda").manual_seed(1000 * (wid + 1) + rnd)
    return torch.randn(TRAIN_BATCH * BERT_SEQ, cols, generator=g,
                       device="cuda")


def rowsparse_rounds(wid, cfg):
    """(e2) on one worker: ``RS_ROUNDS`` rounds of ``bps.push_pull_rowsparse``
    on the ``[vocab, hidden]`` fp32 table, ``average`` in the last. Each
    round's returned table against the numpy reference (both workers'
    ``np.add.at`` scatters, in push order, summed in fp32, halved in the
    last round), its sha1, whether it differs from the round before, its
    device and shape, the round's ``ps/push_bytes`` and ``ps/pull_bytes``
    and seconds; the kernel launches over the rounds."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.obs.metrics import get_registry
    from byteps_tpu_torch.server.rowsparse import scatter_dense
    vocab, cols = cfg.vocab_size, cfg.hidden
    ids = {w: _rs_ids(w, vocab) for w in (0, 1)}
    reg = get_registry()
    ctr = counters()
    torch.cuda.synchronize()
    zero_counts(ctr)
    reg.reset()
    rounds, prev = [], None
    for rnd in range(1, RS_ROUNDS + 1):
        rows = _rs_rows(wid, rnd, cols)
        idx = torch.from_numpy(ids[wid]).cuda()
        push0 = reg.counter("ps/push_bytes").value
        pull0 = reg.counter("ps/pull_bytes").value
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = bps.push_pull_rowsparse(idx, rows, vocab,
                                      average=rnd == RS_ROUNDS, name=RS_NAME)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = out.cpu().numpy()
        ref = None
        for w in (0, 1):
            part = scatter_dense(ids[w], _rs_rows(w, rnd, cols).cpu().numpy(),
                                 vocab, "float32")
            ref = part if ref is None else ref + part
        if rnd == RS_ROUNDS:
            ref = ref / 2
        rounds.append({
            "ok": got.tobytes() == ref.tobytes(),
            "sha1": hashlib.sha1(got.tobytes()).hexdigest(),
            "fresh": prev is None or got.tobytes() != prev,
            "device": out.device.type, "shape": list(out.shape),
            "dtype": str(out.dtype),
            "push_bytes": reg.counter("ps/push_bytes").value - push0,
            "pull_bytes": reg.counter("ps/pull_bytes").value - pull0,
            "s": secs})
        prev = got.tobytes()
        del out, got, ref, rows
    return {"rounds": rounds, "launches": read_counts(ctr)}


def store_routes_worker(wid, where) -> int:
    """``--store-routes-worker WID DIR``: one of the two worker processes of
    ``bert_large_ps_store_routes`` on ``cuda:0``, for every arm in turn (one
    process for both). For each arm it waits for ``DIR/<arm>.addr``, the
    address of the arm's fresh server, trains BERT-large PS int8 on the
    default route at ``CUT_LAYERS`` from seed 0 on its own batch (seed WID)
    for ``STEPS`` counted steps, then in ``RS_ARM`` the row-sparse rounds
    (``rowsparse_rounds``), and writes ``DIR/<arm>.w<WID>.json``."""
    import gc
    where = Path(where)
    for arm in ROUTE_ARMS:
        _await_file(where / f"{arm}.addr", f"server address for arm {arm}")
        report = _route_worker_arm(wid, arm,
                                   (where / f"{arm}.addr").read_text())
        _write_json(where / f"{arm}.w{wid}.json", report)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def _route_worker_arm(wid, arm, addr) -> dict:
    """One arm of ``store_routes_worker``: its report."""
    import os

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import bert
    for name in ("BPS_MAX_LAG", "BPS_ENABLE_ASYNC", "BPS_FUSED_HOMOG"):
        os.environ.pop(name, None)
    os.environ.update(BPS_ENABLE_PS="1", BPS_COMPRESS="int8",
                      BPS_NUM_WORKER="2", BPS_WORKER_ID=str(wid),
                      BPS_LOCAL_RANK="0", BPS_SERVER_ADDRS=addr,
                      BPS_SHARDED_UPDATE="0")
    bps.init()
    try:
        cfg, loss_fn, _, _ = _bert_setup(layers=CUT_LAYERS)
        data = bert.synth_mlm_batch(np.random.RandomState(wid), TRAIN_BATCH,
                                    BERT_SEQ, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        trainer = _ps_trainer(cfg, loss_fn)
        r = _counted_ps_steps(trainer, data)
        push, pull, resends = _ps_bytes(r["metrics"])
        digest = hashlib.sha1()
        for _, p in sorted(trainer.model.named_parameters()):
            digest.update(p.detach().cpu().numpy().tobytes())
        (_, keyed), = trainer.ps_exchange._plans.values()
        report = {"arm": arm, "losses": r["losses"],
                  "launches": r["launches"],
                  "want": _remote_want(cfg)(trainer), "ms": r["ms"],
                  "push_bytes": push, "pull_bytes": pull,
                  "resends": resends, "params": digest.hexdigest(),
                  "peak_mem": torch.cuda.max_memory_allocated(),
                  "nc": trainer.ps_exchange.n_compressed(),
                  "buckets": len(keyed)}
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
        if arm == RS_ARM:
            report["rowsparse"] = rowsparse_rounds(wid, cfg)
        return report
    finally:
        bps.shutdown()


def train_bert_ps_store_routes():
    """Phase ``bert_large_ps_store_routes``: BERT-large at full width and
    ``CUT_LAYERS`` (the world-2 dense path at full depth is
    ``bert_large_ps_membership``'s (g0)), PS int8 (``BPS_COMPRESS=int8``) on
    the default route at world
    2, two worker processes on ``cuda:0`` (``store_routes_worker``) on
    their own batches, the same batches in every arm, a fresh ``launch
    --server`` an arm: (e0) at the default, where ``FusedFront``'s
    homogeneous store owns the fused keys; (e1) at
    ``BPS_FUSED_HOMOG=0``, where the engine owns them (a fused push is
    decoded into its sum, a fused pull is its merged round re-encoded);
    (e2) ``RS_ROUNDS`` row-sparse rounds against (e1)'s server after (e1)'s
    steps.

    (e0), (e1): both workers end on one sha1 of their parameters, the same
    in both arms (the engine copies the first arrival and adds the
    second, the store widens each payload, copies the first and adds the
    second; two fp32 arrivals sum alike in either order, and both routes
    re-encode with ``wire.encode``); finite losses with step 3 below step
    1, (e1)'s equal to (e0)'s; each worker's launches BERT's at that depth
    (36 forward, 18 fused backward, all d 64) and 3·nc int8 quantize and
    dequantize,
    nothing else; no resend; ``ps/push_bytes`` equal in both arms; the
    server's stop line: (e0) ``server/fused_dense_decodes`` 0 and
    ``server/fused_rounds_homog`` ``STEPS`` x nc, (e1) 0 and 2 x ``STEPS``
    x nc.

    (e2): each worker pushes its batch's 4096 token ids and ``[4096,
    1024]`` rows drawn on the card a round, ``average`` in the last; each
    round's returned table lies on the card, is on both workers bit for
    bit the numpy reference (``rowsparse_rounds``) and differs from the
    round before; a round pushes exactly 4 + 4·4096 + 4·4096·1024 bytes a
    worker (the worker's ``ps/push_bytes`` and, over both workers and
    every round, the server's ``server/rowsparse_push_bytes``) and pulls
    the dense table's bytes; the server counted 2 x ``RS_ROUNDS`` pushes;
    no kernel launches during the rounds. The seconds a round are
    printed, not gated. Returns each arm's launches summed over its
    workers."""
    card = card_line()
    arms = _arms_over_servers(
        "store routes", "--store-routes-worker",
        {arm: {} if homog is None else {"BPS_FUSED_HOMOG": homog}
         for arm, homog in ROUTE_ARMS.items()})
    cfg, _, _, _ = _bert_setup()
    for arm, (res, stats) in arms.items():
        tag = f"bert_large ps store routes {arm}"
        nc = res[0]["nc"]
        for wid, r in enumerate(res):
            log(f"[{tag}] worker {wid}: losses {r['losses']}, steps 2-3 "
                f"{r['ms']:.1f} ms a step (two worker processes share one "
                f"card), ps/push_bytes {r['push_bytes']:.0f} and "
                f"ps/pull_bytes {r['pull_bytes']:.0f} a step, "
                f"transport/resends {r['resends']}, {r['nc']} of "
                f"{r['buckets']} buckets compressed, peak memory "
                f"{r['peak_mem']} bytes; {card}")
            if not all(math.isfinite(x) for x in r["losses"]) \
                    or not r["losses"][2] < r["losses"][0]:
                raise AssertionError(f"{tag} worker {wid}: losses "
                                     f"{r['losses']}")
            if r["launches"] != r["want"]:
                raise AssertionError(f"{tag} worker {wid}: launches "
                                     f"{r['launches']}, expected {r['want']}")
            if r["resends"] or r["nc"] != nc:
                raise AssertionError(f"{tag} worker {wid}: resends "
                                     f"{r['resends']}, nc {r['nc']}")
        fused = {k: stats[k] for k in ("server/fused_rounds_homog",
                                       "server/fused_dense_decodes")}
        log(f"[{tag}] server: {fused}, peak RSS {stats['peak_rss_bytes']} "
            f"bytes ({stats['peak_rss_source']}); workers' sha1 "
            f"{res[0]['params']} / {res[1]['params']}")
        want = ({"server/fused_rounds_homog": STEPS * nc,
                 "server/fused_dense_decodes": 0} if arm == "e0" else
                {"server/fused_rounds_homog": 0,
                 "server/fused_dense_decodes": 2 * STEPS * nc})
        if fused != want:
            raise AssertionError(f"{tag}: server {fused}, expected {want}")
        if res[0]["params"] != res[1]["params"]:
            raise AssertionError(f"{tag}: the workers' parameters differ")
        if res[0]["losses"] == res[1]["losses"]:
            raise AssertionError(f"{tag}: both workers read the same batch")
    (e0, _), (e1, s1) = arms["e0"], arms["e1"]
    if e0[0]["params"] != e1[0]["params"]:
        raise AssertionError("bert_large ps store routes: (e1)'s parameters "
                             "differ from (e0)'s")
    for wid in (0, 1):
        if e0[wid]["losses"] != e1[wid]["losses"] \
                or e0[wid]["push_bytes"] != e1[wid]["push_bytes"]:
            raise AssertionError(f"bert_large ps store routes: worker {wid}'s"
                                 f" losses or push bytes differ between the "
                                 f"arms")
    log(f"[bert_large ps store routes] (e0) and (e1): every parameter of "
        f"both workers in both arms one sha1 ({e0[0]['params']}), the "
        f"losses and push bytes the same")
    tag = "bert_large ps store routes e2"
    n = TRAIN_BATCH * BERT_SEQ
    push = 4 + 4 * n + 4 * n * cfg.hidden
    pull = 4 * cfg.vocab_size * cfg.hidden
    for wid, r in enumerate(e1):
        rs = r["rowsparse"]
        for i, x in enumerate(rs["rounds"], 1):
            log(f"[{tag}] worker {wid} round {i}: {x['s']:.3f} s, push "
                f"{x['push_bytes']} B ({x['push_bytes'] / pull:.4f} of the "
                f"dense table), pull {x['pull_bytes']} B, table on "
                f"{x['device']} {x['shape']} {x['dtype']}, sha1 {x['sha1']},"
                f" the numpy reference's bits: {x['ok']}; {card}")
            if not (x["ok"] and x["fresh"] and x["device"] == "cuda"
                    and x["shape"] == [cfg.vocab_size, cfg.hidden]
                    and x["push_bytes"] == push and x["pull_bytes"] == pull):
                raise AssertionError(f"{tag} worker {wid} round {i}: {x}")
        if any(rs["launches"].values()):
            raise AssertionError(f"{tag} worker {wid}: launches during the "
                                 f"rounds {rs['launches']}")
    if [x["sha1"] for x in e1[0]["rowsparse"]["rounds"]] \
            != [x["sha1"] for x in e1[1]["rowsparse"]["rounds"]]:
        raise AssertionError(f"{tag}: the workers' tables differ")
    rs_stats = {k: s1[k] for k in ("server/rowsparse_pushes",
                                   "server/rowsparse_push_bytes")}
    log(f"[{tag}] server: {rs_stats}")
    if rs_stats != {"server/rowsparse_pushes": 2 * RS_ROUNDS,
                    "server/rowsparse_push_bytes": 2 * RS_ROUNDS * push}:
        raise AssertionError(f"{tag}: server {rs_stats}")
    log(f"[{tag}] every round's table bit for bit the numpy reference on "
        f"both workers, {push} B pushed a round a worker; every gate held")
    SUMMARY["bert_large ps store routes"] = {
        **{arm: {"ms": [r["ms"] for r in res],
                 "peak_mem": [r["peak_mem"] for r in res],
                 "server_peak_rss": stats["peak_rss_bytes"]}
           for arm, (res, stats) in arms.items()},
        "e2": {"s": [[x["s"] for x in r["rowsparse"]["rounds"]]
                     for r in e1]}}
    return tuple({k: res[0]["launches"][k] + res[1]["launches"][k]
                  for k in res[0]["launches"]} for res, _ in arms.values())


def _tensors(state, prefix=""):
    """{path: tensor} of every tensor in a ``state_dict()`` tree."""
    out = {}
    if torch.is_tensor(state):
        out[prefix] = state
    elif isinstance(state, dict):
        for k, v in state.items():
            out.update(_tensors(v, f"{prefix}.{k}"))
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            out.update(_tensors(v, f"{prefix}[{i}]"))
    return out


def _sha1s(state):
    return {k: hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()
            for k, t in _tensors(state).items()}


def _same_state(ta, tb):
    """Whether two {path: tensor} maps hold the same tensors bit for bit
    (compared on the first one's devices)."""
    if ta.keys() != tb.keys():
        return False
    for k, x in ta.items():
        y = tb[k].to(x.device)
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if not torch.equal(x.reshape(-1).contiguous().view(torch.uint8),
                           y.reshape(-1).contiguous().view(torch.uint8)):
            return False
    return True


CKPT_DISK_MARGIN = 1 << 30      # bytes free beyond the checkpoint's own


def train_bert_checkpoint():
    """Phase ``bert_large_checkpoint``: world 1, dense ``DistributedTrainer``,
    BERT-large at full width and ``CUT_LAYERS`` (the full-depth
    checkpoint is ``bert_large_ps_membership``'s sharded one), batch 8.
    Steps 1 and 2;
    ``checkpoint.save_checkpoint`` of ``state_dict()`` to a temporary
    directory with the step count and the name registry (which holds a
    declaration a parameter, as a caller pins its keys); step 3, its loss
    and the sha1 of every parameter and optimizer-state tensor recorded
    (A). Then a fresh trainer from other weights (seed 1), so that a
    restore that did nothing fails: ``restore_checkpoint`` into its
    templates, ``load_state_dict``, and step 3 on the same batch.

    Gates: the restored trainer's step count is 2 before its step and its
    state bit for bit the saved one; after its step 3 every sha1 equals
    (A) and the loss is bit for bit step 3's; the restored declarations
    name every declaration of the registry; each step, the replayed one
    too, launches 2 forwards and 1 fused backward a layer, all d 64. Printed,
    not gated: the checkpoint's bytes on disk and the save and restore
    seconds. The directory is removed after; a disk too short for it
    fails the phase and says so. Returns the launches of the 4 steps."""
    import shutil
    import tempfile

    import byteps_tpu_torch as bps
    from byteps_tpu_torch import checkpoint as ckpt
    from byteps_tpu_torch.common.global_state import GlobalState
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    tag = "bert_large checkpoint"
    cfg, loss_fn, data, _ = _bert_setup(layers=CUT_LAYERS)
    per_step = dict.fromkeys(COUNT_KEYS, 0)
    per_step["flash_fwd"], per_step["flash_bwd_fused"] = \
        2 * cfg.layers, cfg.layers
    per_step = by_width(per_step, cfg.head_dim)
    ctr = counters()
    total = dict.fromkeys(per_step, 0)

    def step(trainer):
        torch.cuda.synchronize()
        zero_counts(ctr)
        loss = trainer.step(data).item()
        torch.cuda.synchronize()
        got = read_counts(ctr)
        if got != per_step:
            raise AssertionError(f"{tag}: launches {got}, expected "
                                 f"{per_step}")
        for k, v in got.items():
            total[k] += v
        return loss

    def make(seed):
        model = Transformer(cfg, generator=torch.Generator().manual_seed(seed))
        return DistributedTrainer(loss_fn, model,
                                  adamw(model.parameters(), 1e-4),
                                  partition_bytes=PARTITION_BYTES)

    bps.init()
    tmp = Path(tempfile.mkdtemp())
    try:
        reg = GlobalState.get().registry
        trainer = make(0)
        for name, _ in trainer.model.named_parameters():
            bps.declare_tensor(name)
        losses = [step(trainer) for _ in range(2)]
        st = trainer.state_dict()
        need = sum(t.numel() * t.element_size()
                   for t in _tensors(st).values())
        free = shutil.disk_usage(tmp).free
        if free < need + CKPT_DISK_MARGIN:
            raise AssertionError(f"{tag}: {free} bytes free at {tmp}, the "
                                 f"checkpoint needs {need} and "
                                 f"{CKPT_DISK_MARGIN} to spare")
        saved = {k: t.detach().clone() for k, t in _tensors(st).items()}
        t = time.perf_counter()
        ckpt.save_checkpoint(str(tmp), st["model"], st["optimizer"],
                             step=st["step_count"], registry=reg)
        save_s = time.perf_counter() - t
        on_disk = {p.name: p.stat().st_size for p in tmp.iterdir()}
        losses.append(step(trainer))
        a = _sha1s(trainer.state_dict())
        del trainer, st
        torch.cuda.empty_cache()
        fresh = make(1)
        t = time.perf_counter()
        tmpl = fresh.state_dict()
        params, opt, ck_step, declared = ckpt.restore_checkpoint(
            str(tmp), tmpl["model"], tmpl["optimizer"])
        fresh.load_state_dict({"model": params, "optimizer": opt,
                               "step_count": ck_step})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        del params, opt, tmpl
        state = fresh.state_dict()
        if fresh.step_count != 2 or not _same_state(_tensors(state), saved):
            raise AssertionError(f"{tag}: the restored state is not the "
                                 f"saved one (step count "
                                 f"{fresh.step_count})")
        del state, saved
        replay = step(fresh)
        b = _sha1s(fresh.state_dict())
        names = reg.declared_names()
        del fresh
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        bps.shutdown()
    off = [k for k in a if a[k] != b.get(k)]
    log(f"[{tag}] losses {losses}, the restored trainer's step 3 "
        f"{replay}; {len(a)} tensors, {len(off)} off (A); checkpoint "
        f"{sum(on_disk.values())} bytes on disk ({on_disk}), save "
        f"{save_s:.2f} s, restore {restore_s:.2f} s; {card_line()}")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[2] < losses[0]:
        raise AssertionError(f"{tag}: losses {losses}")
    if off or a.keys() != b.keys() or replay != losses[2]:
        raise AssertionError(f"{tag}: the replayed step 3 differs: loss "
                             f"{replay} against {losses[2]}, tensors {off}")
    if [d["name"] for d in declared] != names or not names:
        raise AssertionError(f"{tag}: declarations {declared} against the "
                             f"registry's {names}")
    log(f"[{tag}] the restored trainer's step 3 bit for bit the original's "
        f"in every parameter, optimizer-state tensor and the loss; every "
        f"gate held")
    SUMMARY[tag] = {"bytes_on_disk": sum(on_disk.values()),
                    "save_s": save_s, "restore_s": restore_s}
    return total


# ------ the transport's rest at world 2: the colocated deployment (the Unix
# socket and the shared-memory data plane), striping over TCP; a snapshot
# restart under async PS at world 1

# arm -> (the server's extra environment, the workers' client knobs): (f0)
# TCP, the control; (f1) the colocated deployment; (f2) striping over TCP,
# four parts of 1,024,000 bytes for a full bucket on the default 4 channels
TRANSPORT_ARMS = {
    "f0": ({}, {}),
    "f1": ({"BPS_ENABLE_IPC": "1"},
           {"BPS_ENABLE_IPC": "1", "BPS_ENABLE_SHM": "1"}),
    "f2": ({}, {"BPS_STRIPE_MIN": "1048576"}),
}
TRANSPORT_KNOBS = ("BPS_ENABLE_IPC", "BYTEPS_ENABLE_IPC", "BPS_ENABLE_SHM",
                   "BPS_STRIPE_MIN")
SHM_SEGMENT_MIN = 1 << 20       # a channel's segment holds at least this
SNAPSHOT_STEPS = 2              # (f3)'s steps before the restart
# a Unix socket's path holds at most this many bytes
UDS_PATH_MAX = 107


def ipc_dir():
    """A fresh directory of this user's, mode 0700, for the servers' Unix
    sockets: under the temporary directory where a socket's path there
    fits ``UDS_PATH_MAX``, else under ``/tmp``."""
    import tempfile
    d = tempfile.mkdtemp(prefix="bps-")
    if len(os.path.join(d, "bps-ipc-65535.sock")) > UDS_PATH_MAX:
        os.rmdir(d)
        d = tempfile.mkdtemp(prefix="bps-", dir="/tmp")
    os.chmod(d, 0o700)
    return d


def shm_fit(free, workers, conns, largest):
    """(the bytes the shm arm's segments take, None or why they cannot fit
    in ``free`` bytes of ``/dev/shm``): one segment a channel of each
    worker, each the largest op's bytes and at least ``SHM_SEGMENT_MIN``.
    The port reserves a segment's pages when it makes one, so a segment
    that does not fit falls back to the socket (the arm's fallback gate
    fails), never a ``SIGBUS``; this says why before the arm runs."""
    need = workers * conns * max(int(largest), SHM_SEGMENT_MIN)
    if need > free:
        return need, (f"/dev/shm has {free} bytes free and the shm arm's "
                      f"segments take {need} ({workers} workers x {conns} "
                      f"channels x {max(int(largest), SHM_SEGMENT_MIN)} "
                      f"bytes): give the machine a larger /dev/shm")
    return need, None


def transport_frames_want(arm, plan, workers=2, steps=STEPS):
    """The server's counts of arm ``arm`` ((f0)-(f2)) from the exchange's
    bucket plan ``plan`` (each bucket's parts under the workers'
    ``_stripe_ranges``, 0 for a bucket it leaves whole): ({counter: the
    exact count}, {counter: the least count}). A pull waits on the server
    in slices of 2 s, each slice a frame, so the pulls' counts are lower
    bounds."""
    n, nb = workers * steps, len(plan)
    parts, whole = sum(plan), sum(1 for p in plan if not p)
    if arm == "f1":
        return ({"server/shm_pushes": n * nb, "server/push_frames": 0,
                 "server/pull_frames": 0, "server/part_pushes": 0,
                 "server/part_pulls": 0, "server/tcp_conns": 0},
                {"server/shm_pulls": n * nb, "server/ipc_conns": 1})
    exact = {"server/shm_pushes": 0, "server/shm_pulls": 0,
             "server/ipc_conns": 0}
    if arm == "f0":
        exact.update({"server/push_frames": n * nb, "server/part_pushes": 0,
                      "server/part_pulls": 0})
        return exact, {"server/pull_frames": n * nb, "server/tcp_conns": 1}
    exact.update({"server/part_pushes": n * parts,
                  "server/push_frames": n * whole})
    return exact, {"server/part_pulls": n * parts,
                   "server/pull_frames": n * whole, "server/tcp_conns": 1}


def check_transport_server(arm, stats, plan):
    """What is wrong with an arm's server counts (``server stats``), by
    ``transport_frames_want``; empty when nothing is."""
    exact, least = transport_frames_want(arm, plan)
    bad = [f"{k} {stats.get(k)}, expected {v}" for k, v in exact.items()
           if stats.get(k) != v]
    bad += [f"{k} {stats.get(k)}, expected at least {v}"
            for k, v in least.items() if (stats.get(k) or 0) < v]
    return bad


def transport_worker(wid, where) -> int:
    """``--transport-worker WID DIR``: one of the two worker processes of
    ``bert_large_ps_transport`` on ``cuda:0``, for every arm in turn. For
    each arm it waits for ``DIR/<arm>.addr``, the address of the arm's
    fresh server, trains BERT-large dense PS on the default route at
    ``CUT_LAYERS`` from seed 0 on its own batch (seed WID) with the arm's client
    knobs set (and cleared after), ``STEPS`` counted steps, and writes
    ``DIR/<arm>.w<WID>.json``."""
    import gc
    where = Path(where)
    for arm in TRANSPORT_ARMS:
        _await_file(where / f"{arm}.addr", f"server address for arm {arm}")
        report = _transport_worker_arm(wid, arm,
                                       (where / f"{arm}.addr").read_text())
        _write_json(where / f"{arm}.w{wid}.json", report)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def _channels(backend):
    """(the address families of a remote backend's dialed data channels,
    the bytes of their shm segments), with no op in flight."""
    fams, seg = set(), 0
    for pool in backend._pools:
        chans = [pool.get() for _ in range(backend._nconns)]
        for ch in chans:
            if ch.sock is not None:
                fams.add(ch.sock.family.name)
            if ch.shm is not None:
                seg += ch.shm.size
            pool.put(ch)
    return sorted(fams), seg


def _transport_worker_arm(wid, arm, addr) -> dict:
    """One arm of ``transport_worker``: its report."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import bert
    knobs = TRANSPORT_ARMS[arm][1]
    for name in ("BPS_COMPRESS", "BPS_MAX_LAG", "BPS_ENABLE_ASYNC",
                 "BPS_FUSED_HOMOG") + TRANSPORT_KNOBS:
        os.environ.pop(name, None)
    os.environ.update(BPS_ENABLE_PS="1", BPS_NUM_WORKER="2",
                      BPS_WORKER_ID=str(wid), BPS_LOCAL_RANK="0",
                      BPS_SERVER_ADDRS=addr, BPS_SHARDED_UPDATE="0",
                      **knobs)
    bps.init()
    try:
        cfg, loss_fn, _, _ = _bert_setup(layers=CUT_LAYERS)
        data = bert.synth_mlm_batch(np.random.RandomState(wid), TRAIN_BATCH,
                                    BERT_SEQ, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        trainer = _ps_trainer(cfg, loss_fn)
        r = _counted_ps_steps(trainer, data)
        push, pull, resends = _ps_bytes(r["metrics"])
        m = r["metrics"]
        be = trainer.ps_exchange.backend
        (_, keyed), = trainer.ps_exchange._plans.values()
        sizes = [b.size * np.dtype(b.dtype).itemsize for _, b in keyed]
        families, seg_bytes = _channels(be)
        digest = hashlib.sha1()
        for _, p in sorted(trainer.model.named_parameters()):
            digest.update(p.detach().cpu().numpy().tobytes())
        report = {
            "arm": arm, "losses": r["losses"], "launches": r["launches"],
            "want": _attention_launches(cfg, ("flash_bwd_fused",))(trainer),
            "ms": r["ms"], "push_bytes": push, "pull_bytes": pull,
            "resends": resends,
            "reconnects": m.get("transport/reconnects", 0),
            "shm_fallbacks": m.get("transport/shm_fallbacks", 0),
            "tcp_dials": m.get("transport/tcp_dials", 0),
            "ipc_dials": m.get("transport/ipc_dials", 0),
            "families": families, "shm_segment_bytes": seg_bytes,
            "plan": [len(be._stripe_ranges(n) or ()) for n in sizes],
            "largest": max(sizes), "params": digest.hexdigest(),
            "peak_mem": torch.cuda.max_memory_allocated()}
        trainer.close()
        return report
    finally:
        bps.shutdown()
        for name in knobs:
            os.environ.pop(name, None)


def train_bert_ps_transport():
    """Phase ``bert_large_ps_transport``: BERT-large at full width and
    ``CUT_LAYERS`` (the world-2 dense path at full depth is
    ``bert_large_ps_membership``'s (g0)), dense PS (no ``BPS_COMPRESS``)
    on the default route at world 2,
    two worker processes on ``cuda:0`` (``transport_worker``) on their own
    batches, the same batches in every arm, a fresh ``launch --server``
    (``BPS_NUM_WORKER=2``) an arm: (f0) TCP; (f1) the colocated deployment,
    the server at ``BPS_ENABLE_IPC=1`` and the workers at
    ``BPS_ENABLE_IPC=1 BPS_ENABLE_SHM=1``; (f2) ``BPS_STRIPE_MIN=1048576``
    over TCP. ``/dev/shm``'s size and room are printed first and must fit
    the segments (``shm_fit``).

    Gates: both workers of all three arms end on one sha1 of every
    parameter (the transport moves bytes; two fp32 arrivals sum alike in
    either order); each worker's launches BERT's (144 forward, 72 fused
    backward, all d 64, at full depth; 36 and 18 at ``CUT_LAYERS``) and
    no codec kernel; finite losses, step 3 below
    step 1; ``transport/resends``, ``transport/reconnects`` and
    ``transport/shm_fallbacks`` 0; the server's frames by op exact from
    the bucket plan (``check_transport_server``): (f1) ``server/shm_pushes``
    2 x ``STEPS`` x the buckets, ``server/shm_pulls`` at least that, no op
    2 or 3 frame and no TCP connection, and every worker's data channels
    on ``AF_UNIX`` with no TCP dial; (f2) ``server/part_pushes`` 2 x
    ``STEPS`` x the parts ``_stripe_ranges`` makes of the buckets and the
    op-2 frames 2 x ``STEPS`` x the buckets it leaves whole.

    Printed, not gated: each worker's steps 2-3 (the arms run in turn in
    this call), push and pull bytes, peak memory and shm segments' bytes,
    and each server's peak RSS, beside the card. Returns each arm's
    launches summed over its workers."""
    import shutil
    card = card_line()
    tag = "bert_large ps transport"
    st = os.statvfs("/dev/shm")
    size, free = st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize
    conns = int(os.environ.get("BPS_PS_CONNS", "4") or 4)
    need, why = shm_fit(free, 2, conns, PARTITION_BYTES)
    log(f"[{tag}] /dev/shm: {size} bytes, {free} free; (f1)'s segments "
        f"take at most {need} bytes (2 workers x {conns} channels, the "
        f"largest bucket at most {PARTITION_BYTES} bytes); {card}")
    if why:
        raise AssertionError(f"{tag}: {why}")
    old = os.environ.get("BPS_IPC_DIR")
    os.environ["BPS_IPC_DIR"] = d = ipc_dir()
    try:
        arms = _arms_over_servers(
            "transport", "--transport-worker",
            {arm: env for arm, (env, _) in TRANSPORT_ARMS.items()})
    finally:
        if old is None:
            os.environ.pop("BPS_IPC_DIR", None)
        else:
            os.environ["BPS_IPC_DIR"] = old
        shutil.rmtree(d, ignore_errors=True)
    sha = arms["f0"][0][0]["params"]
    for arm, (res, stats) in arms.items():
        atag = f"{tag} {arm}"
        plan = res[0]["plan"]
        for wid, r in enumerate(res):
            log(f"[{atag}] worker {wid}: losses {r['losses']}, steps 2-3 "
                f"{r['ms']:.1f} ms a step (two worker processes share one "
                f"card), ps/push_bytes {r['push_bytes']:.0f} and "
                f"ps/pull_bytes {r['pull_bytes']:.0f} a step, resends "
                f"{r['resends']}, reconnects {r['reconnects']}, shm "
                f"fallbacks {r['shm_fallbacks']}, dials tcp "
                f"{r['tcp_dials']} ipc {r['ipc_dials']}, channels "
                f"{r['families']}, shm segments {r['shm_segment_bytes']} "
                f"bytes, peak memory {r['peak_mem']} bytes; {card}")
            if not all(math.isfinite(x) for x in r["losses"]) \
                    or not r["losses"][2] < r["losses"][0]:
                raise AssertionError(f"{atag} worker {wid}: losses "
                                     f"{r['losses']}")
            if r["launches"] != r["want"]:
                raise AssertionError(f"{atag} worker {wid}: launches "
                                     f"{r['launches']}, expected {r['want']}")
            if r["resends"] or r["reconnects"] or r["shm_fallbacks"]:
                raise AssertionError(f"{atag} worker {wid}: resends "
                                     f"{r['resends']}, reconnects "
                                     f"{r['reconnects']}, shm fallbacks "
                                     f"{r['shm_fallbacks']}")
            if r["plan"] != plan or r["params"] != sha:
                raise AssertionError(f"{atag} worker {wid}: its bucket plan "
                                     f"or parameters differ")
            if arm == "f1" and (r["families"] != ["AF_UNIX"]
                                or r["tcp_dials"]):
                raise AssertionError(f"{atag} worker {wid}: channels "
                                     f"{r['families']}, {r['tcp_dials']} "
                                     f"TCP dials")
        frames = {k: v for k, v in stats.items()
                  if k.startswith("server/") and k.split("/")[1] in (
                      "push_frames", "pull_frames", "shm_pushes",
                      "shm_pulls", "part_pushes", "part_pulls", "tcp_conns",
                      "ipc_conns")}
        log(f"[{atag}] server: {frames}, peak RSS {stats['peak_rss_bytes']} "
            f"bytes ({stats['peak_rss_source']}); {len(plan)} buckets, "
            f"{sum(plan)} parts in {sum(1 for p in plan if p)} striped; "
            f"{card}")
        bad = check_transport_server(arm, stats, plan)
        if bad:
            raise AssertionError(f"{atag}: server {bad}")
        if res[0]["losses"] == res[1]["losses"]:
            raise AssertionError(f"{atag}: both workers read the same batch")
    log(f"[{tag}] every parameter of both workers in (f0), (f1), (f2) one "
        f"sha1 ({sha}); every gate held")
    SUMMARY[tag] = {arm: {"ms": [r["ms"] for r in res],
                          "peak_mem": [r["peak_mem"] for r in res],
                          "shm_segment_bytes": [r["shm_segment_bytes"]
                                                for r in res],
                          "server_peak_rss": stats["peak_rss_bytes"]}
                    for arm, (res, stats) in arms.items()}
    SUMMARY[tag]["dev_shm"] = {"size": size, "free": free}
    return tuple({k: res[0]["launches"][k] + res[1]["launches"][k]
                  for k in res[0]["launches"]} for res, _ in arms.values())


_SNAP_RE = {"final": re.compile(r"final snapshot: (\d+) PS keys, (\d+) "
                                r"bytes in ([\d.]+) s"),
            "restored": re.compile(r"restored (\d+) PS keys from \S+ "
                                   r"\((\d+) bytes in ([\d.]+) s\)")}


def snapshot_lines(lines):
    """{"final": (keys, bytes, s), "restored": (keys, bytes, s)} from a
    server's stderr lines (``launch --server``), None for one it did not
    print."""
    out = dict.fromkeys(_SNAP_RE)
    for line in lines:
        for k, rx in _SNAP_RE.items():
            m = rx.search(line)
            if m:
                out[k] = (int(m.group(1)), int(m.group(2)),
                          float(m.group(3)))
    return out


def check_snapshot_restart(before, report, first, second, stats):
    """What is wrong with (f3); empty when nothing is. ``before``: the
    worker's report before the stop (its keys, their rounds and each
    key's round-0 sha1); ``report``: its report after step 3;
    ``first``/``second``: ``snapshot_lines`` of the first and the
    restarted server; ``stats``: the restarted server's stop line."""
    n = before["keys"]
    bad = []
    if before["rounds"] != [SNAPSHOT_STEPS]:
        bad.append(f"rounds before the stop {before['rounds']}, expected "
                   f"[{SNAPSHOT_STEPS}]")
    if first["final"] is None or first["final"][0] != n:
        bad.append(f"the first server's final snapshot {first['final']}, "
                   f"expected {n} keys")
    if second["restored"] is None or second["restored"][0] != n:
        bad.append(f"the restarted server restored {second['restored']}, "
                   f"expected {n} keys")
    if stats.get("server/restored_keys") != n:
        bad.append(f"server/restored_keys {stats.get('server/restored_keys')}"
                   f", expected {n}")
    diff = [k for k, (a, b) in enumerate(zip(before["sha1"], report["sha1"]))
            if a != b]
    if len(report["sha1"]) != n or diff:
        bad.append(f"{len(diff)} keys' round-0 pulls after the restore "
                   f"differ from before the stop (of {len(report['sha1'])})")
    if report["reconnects"] < 1:
        bad.append("transport/reconnects 0: the worker never reconnected")
    if not math.isfinite(report["loss3"]):
        bad.append(f"step 3's loss {report['loss3']}")
    if report["rounds"] != [1]:
        bad.append(f"rounds after step 3 {report['rounds']}, expected [1]")
    if report["over"]:
        bad.append(f"{report['over']} elements of the store after step 3 "
                   f"off the restored store plus its delta")
    return bad


def snapshot_worker(where) -> int:
    """``--snapshot-worker DIR``: the worker of (f3), world 1 on ``cuda:0``.
    It waits for ``DIR/f3.addr``, trains BERT-large dense async PS at
    ``CUT_LAYERS`` from seed 0 for ``SNAPSHOT_STEPS`` steps, waits until
    the store folded them (each key's round), writes each key's round-0
    sha1 to ``DIR/f3.before.json``, waits for ``DIR/f3.restarted`` (the
    server stopped and restarted from its snapshot), pulls every key
    again (its first ops reconnect and replay the inits), takes step 3
    with its deltas logged, and writes ``DIR/f3.json``: the sha1s after
    the restore, the reconnects, the losses and launches of the three
    steps, the rounds after step 3 and the store against the restored one
    plus the deltas (``async_store_check``, one fold)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.obs.metrics import get_registry
    where = Path(where)
    _await_file(where / "f3.addr", "server address for arm f3")
    for name in ("BPS_COMPRESS", "BPS_MAX_LAG", "BPS_ASYNC_WIRE_DTYPE",
                 "BPS_ASYNC_PULL_DTYPE", "BPS_FUSED_HOMOG") + TRANSPORT_KNOBS:
        os.environ.pop(name, None)
    os.environ.update(BPS_ENABLE_PS="1", BPS_ENABLE_ASYNC="1",
                      BPS_NUM_WORKER="1", BPS_WORKER_ID="0",
                      BPS_LOCAL_RANK="0",
                      BPS_SERVER_ADDRS=(where / "f3.addr").read_text(),
                      BPS_SHARDED_UPDATE="0")
    bps.init()
    try:
        cfg, loss_fn, data, _ = _bert_setup(layers=CUT_LAYERS)
        trainer = _ps_trainer(cfg, loss_fn)
        w = trainer._async_worker
        torch.cuda.synchronize()
        ctr = counters()
        zero_counts(ctr)
        losses = []
        for _ in range(SNAPSHOT_STEPS):
            losses.append(trainer.step(data).item())
        rounds = _await_folds(w.backend, w.keys, SNAPSHOT_STEPS)

        def store():
            for key, n in zip(w.keys, w.sizes):
                out = np.empty(n, np.float32)
                w.backend.pull(key, out)
                yield out

        _write_json(where / "f3.before.json", {
            "keys": len(w.keys), "rounds": sorted(set(rounds)),
            "sha1": [hashlib.sha1(a.tobytes()).hexdigest()
                     for a in store()]})
        _await_file(where / "f3.restarted", "the restarted server")
        reconnects = get_registry().counter("transport/reconnects")
        r0 = reconnects.value
        restored = list(store())
        sha1 = [hashlib.sha1(a.tobytes()).hexdigest() for a in restored]
        dlog = DeltaLog(w.backend)
        losses.append(trainer.step(data).item())
        torch.cuda.synchronize()
        dlog.stop()
        launches = read_counts(ctr)
        rounds3 = _await_folds(w.backend, w.keys, 1)
        over, worst = 0, 0.0
        for x0, now, key in zip(restored, store(), w.keys):
            o, q = async_store_check(x0, dlog.pushed[key], now, 1, "cuda")
            over, worst = over + o, max(worst, q)
        _write_json(where / "f3.json", {
            "sha1": sha1, "reconnects": reconnects.value - r0,
            "losses": losses, "loss3": losses[-1], "launches": launches,
            "want": _attention_launches(cfg, ("flash_bwd_fused",))(trainer),
            "rounds": sorted(set(rounds3)), "over": over, "worst": worst,
            "n_params": sum(w.sizes)})
        trainer.close()
    finally:
        bps.shutdown()
    return 0


def train_bert_ps_snapshot():
    """Phase ``bert_large_ps_snapshot``, (f3): a snapshot restart under
    async PS at world 1, BERT-large at ``CUT_LAYERS`` (a snapshot holds the
    store, which under async PS is the weights). The first ``launch
    --server`` runs at ``BPS_ENABLE_ASYNC=1`` and ``BPS_SERVER_SNAPSHOT``;
    the worker (``snapshot_worker``) takes ``SNAPSHOT_STEPS`` steps and
    quiesces; SIGTERM makes the server write its final snapshot and stop;
    a fresh server on the same port restores the file before it accepts;
    the worker reconnects and takes step 3. Gates
    (``check_snapshot_restart``): the restarted server restored every key;
    every key's round-0 pull after the restore is bit for bit its pull
    before the stop; the worker reconnected; step 3's loss is finite; the
    store after step 3 is the restored store plus the step-3 delta
    (``async_store_check``); the three steps' launches BERT's at that
    depth. Printed: the snapshot's bytes and the seconds to write it and
    to restore it, beside the card. Returns the worker's launches."""
    import shutil
    import tempfile
    card = card_line()
    tag = "bert_large ps snapshot f3"
    tmp = Path(tempfile.mkdtemp())
    env = {"BPS_ENABLE_ASYNC": "1",
           "BPS_SERVER_SNAPSHOT": str(tmp / "ps.npz")}
    logf = open(tmp / "worker.log", "w")
    proc = subprocess.Popen(
        [sys.executable, __file__, "--snapshot-worker", str(tmp)], cwd=ROOT,
        env=dict(os.environ), stdout=logf, stderr=subprocess.STDOUT)
    servers, failed = [], None
    try:
        server, lines1, addr = start_ps_server(1, env)
        servers.append(server)
        (tmp / "f3.addr.tmp").write_text(addr)
        (tmp / "f3.addr.tmp").rename(tmp / "f3.addr")
        failed = _await_reports([proc], [tmp / "f3.before.json"],
                                time.time() + REMOTE_WAIT)
        if failed is None:
            rc1 = stop_ps_server(server)      # SIGTERM: the final snapshot
            server, lines2, _ = start_ps_server(
                1, dict(env, BPS_SERVER_PORT=addr.rsplit(":", 1)[1]))
            servers.append(server)
            _write_json(tmp / "f3.restarted", True)
            failed = _await_reports([proc], [tmp / "f3.json"],
                                    time.time() + REMOTE_WAIT)
    finally:
        rcs = [stop_ps_server(s) for s in servers]
        if proc.poll() is None and failed is not None:
            proc.kill()
        proc.wait(timeout=60)
        logf.close()
    text = (tmp / "worker.log").read_text()
    log(f"----- snapshot worker (exit {proc.returncode})")
    log(text if failed or proc.returncode else text[-1500:])
    if failed or proc.returncode:
        print(f"----- snapshot worker (exit {proc.returncode}), its log's "
              f"end:\n{text[-6000:]}", file=sys.stderr, flush=True)
        shutil.rmtree(tmp, ignore_errors=True)
        raise AssertionError(f"{tag}: {failed or 'the worker failed'}")
    before = json.loads((tmp / "f3.before.json").read_text())
    report = json.loads((tmp / "f3.json").read_text())
    shutil.rmtree(tmp, ignore_errors=True)
    stats = [json.loads(x.split("server stats ", 1)[1])
             for x in lines2 if "server stats " in x]
    first, second = snapshot_lines(lines1), snapshot_lines(lines2)
    log(f"[{tag}] {before['keys']} keys, {report['n_params']} parameters; "
        f"the first server's final snapshot (keys, bytes, s) "
        f"{first['final']}, exit {rc1}; the restarted server restored "
        f"{second['restored']}, its final snapshot {second['final']}, "
        f"exit {rcs[-1]}; reconnects {report['reconnects']}; losses "
        f"{report['losses']}; the store after step 3 against the restored "
        f"one plus the delta: {report['over']} elements over the bound, "
        f"the largest error {report['worst']:.4f} of it; {card}")
    bad = check_snapshot_restart(before, report, first, second,
                                 stats[0] if len(stats) == 1 else {})
    if rc1 or rcs[-1]:
        bad.append(f"the servers exited {rc1} and {rcs[-1]}")
    if report["launches"] != report["want"]:
        bad.append(f"launches {report['launches']}, expected "
                   f"{report['want']}")
    if bad:
        raise AssertionError(f"{tag}: {bad}")
    log(f"[{tag}] every key's bits restored; every gate held")
    SUMMARY["bert_large ps snapshot"] = {
        "final": first["final"], "restored": second["restored"],
        "keys": before["keys"]}
    return report["launches"]


# -------- the sharded update's membership change and sharded checkpoints:
# BERT-large dense PS at world 2, full depth, BPS_SHARDED_UPDATE=1

# (g0) the control, saved after MEMBERSHIP_SAVE_AT; (g1) a LEAVE of worker 1
# after step 1 and its JOIN after step 2; (g2) two fresh worker processes
# restoring (g0)'s checkpoint, then step 3
MEMBERSHIP_LIVE = {1: (0,), 2: (0, 1)}     # (g1): after step k, reshard(live)
MEMBERSHIP_SAVE_AT = 2


class _MembershipLines(logging.Handler):
    """The port logger's lines that say a membership phase lost state: the
    sharded update's fallback, a handoff frame never published, an owned
    group without its slice."""

    SAY = ("BPS_SHARDED_UPDATE falls back", "never published",
           "no slice for owned group")

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if any(s in msg for s in self.SAY):
            self.lines.append(msg)


def membership_batch(wid, step, cfg):
    """Worker ``wid``'s batch of step ``step`` (1-based) in every arm."""
    from byteps_tpu_torch.models import bert
    return bert.synth_mlm_batch(np.random.RandomState(100 * wid + step),
                                TRAIN_BATCH, BERT_SEQ, cfg.vocab_size)


def membership_worker(wid, where, arms) -> int:
    """``--membership-worker WID DIR`` (arms (g0), (g1)) and
    ``--membership-restore-worker WID DIR`` ((g2)): one of the two worker
    processes of ``bert_large_ps_membership`` on ``cuda:0``. For each arm
    it waits for ``DIR/<arm>.addr``, runs the arm (``_membership_arm``;
    the checkpoint is ``DIR/ck``) and writes ``DIR/<arm>.w<WID>.json``."""
    import gc
    where = Path(where)
    for arm in arms:
        _await_file(where / f"{arm}.addr", f"server address for arm {arm}")
        report = _membership_arm(wid, arm,
                                 (where / f"{arm}.addr").read_text(),
                                 where / "ck")
        _write_json(where / f"{arm}.w{wid}.json", report)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def _state_report(trainer):
    """A worker's optimizer state now: the groups with state, the bytes of
    all its state tensors and of the moments (on the card)."""
    st = trainer._tx.state
    return {"owned": sorted(trainer._sharded.plan.owned),
            "with_state": trainer._chunked.groups_with_state(),
            "state_bytes": sum(t.numel() * t.element_size()
                               for s in st.values() for t in s.values()
                               if torch.is_tensor(t)),
            "moment_bytes": sum(t.numel() * t.element_size()
                                for s in st.values() for k, t in s.items()
                                if k in ("exp_avg", "exp_avg_sq")),
            "owner": list(trainer._sharded.plan.owner),
            "member_epoch": trainer._sharded.member_epoch}


def _plan_inputs(trainer):
    """What ``ShardedUpdatePlan`` is made of on this worker: each bucket's
    key, label and leaves, the groups and the leaves' meta."""
    (_, keyed), = trainer.ps_exchange._plans.values()
    plan = trainer._sharded.plan
    return {"keyed": [[k, b.index, [sg.leaf_index for sg in b.segments]]
                      for k, b in keyed],
            "groups": [list(g) for g in plan.groups],
            "leaf_meta": [[list(sh), dt, n] for sh, dt, n in plan.leaf_meta]}


def _membership_arm(wid, arm, addr, ck) -> dict:
    """One arm of ``membership_worker``: its report."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch import checkpoint as ckpt
    from byteps_tpu_torch.common.logging import get_logger
    from byteps_tpu_torch.obs.metrics import get_registry
    from byteps_tpu_torch.optim import ChunkedApply
    from byteps_tpu_torch.sharded_update import (STATE_KEY_BASE,
                                                 live_group_weights)
    for name in ("BPS_COMPRESS", "BPS_MAX_LAG", "BPS_ENABLE_ASYNC",
                 "BPS_FUSED_HOMOG") + TRANSPORT_KNOBS:
        os.environ.pop(name, None)
    os.environ.update(BPS_ENABLE_PS="1", BPS_NUM_WORKER="2",
                      BPS_WORKER_ID=str(wid), BPS_LOCAL_RANK="0",
                      BPS_SERVER_ADDRS=addr, BPS_SHARDED_UPDATE="1")
    lines = _MembershipLines()
    get_logger().addHandler(lines)
    adopted = []
    real_adopt = ChunkedApply.adopt_group

    def adopt(self, gi, state):
        adopted.append(gi)
        return real_adopt(self, gi, state)

    ChunkedApply.adopt_group = adopt
    bps.init()
    try:
        cfg, loss_fn, _, _ = _bert_setup()
        first = 1 if arm != "g2" else STEPS
        batches = {s: membership_batch(wid, s, cfg)
                   for s in range(first, STEPS + 1)}
        torch.cuda.reset_peak_memory_stats()
        trainer = _ps_trainer(cfg, loss_fn)
        report = {"arm": arm, "losses": [], "step_ms": []}
        puts = []
        if arm == "g2":
            t = time.perf_counter()
            meta = trainer.restore_sharded(str(ck))
            report["restore"] = {
                "seconds": time.perf_counter() - t,
                "step": meta["step"], "owner": meta["sharded"]["owner"],
                "member_epoch": meta["sharded"]["member_epoch"],
                "slices": {p.name: p.stat().st_size for p in sorted(
                    (ck / "opt_shard" / f"s{meta['step']}").iterdir())},
                "state_pt": (ck / "state.pt").stat().st_size,
                "optimizer_before_step": len(trainer._tx.state)}
        be = trainer.ps_exchange.backend
        real_put = be.param_put

        def put(key, seq, payload):
            if key & STATE_KEY_BASE:
                puts.append(key & 0xFFFF)
            return real_put(key, seq, payload)

        be.param_put = put
        ctr = counters()
        torch.cuda.synchronize()
        zero_counts(ctr)
        reshards = []
        for s in range(first, STEPS + 1):
            t = time.perf_counter()
            loss = trainer.step(batches[s])
            torch.cuda.synchronize()
            report["step_ms"].append((time.perf_counter() - t) * 1e3)
            report["losses"].append(loss.item())
            if s == 1:
                report["plan"] = _plan_inputs(trainer)
                report["start"] = _state_report(trainer)
            if arm == "g0" and s == MEMBERSHIP_SAVE_AT:
                _drain(trainer)
                t = time.perf_counter()
                ckpt.save_sharded_checkpoint(str(ck), trainer)
                sdir = ck / "opt_shard" / f"s{s}"
                report["save"] = {
                    "seconds": time.perf_counter() - t,
                    "slices": {f"g{gi}.bin": (sdir / f"g{gi}.bin")
                               .stat().st_size
                               for gi in trainer._sharded.plan.owned},
                    "state_pt": ((ck / "state.pt").stat().st_size
                                 if wid == 0 else None),
                    **_state_report(trainer)}
            if arm == "g1" and s in MEMBERSHIP_LIVE:
                live = list(MEMBERSHIP_LIVE[s])
                _drain(trainer)
                before = _state_report(trainer)
                weights = live_group_weights(trainer._sharded.plan,
                                             trainer._name)
                m = get_registry().snapshot()
                del puts[:], adopted[:]
                t = time.perf_counter()
                out = trainer.reshard(live)
                sec = time.perf_counter() - t
                after = get_registry().snapshot()
                reshards.append({
                    "live": live, "weights": weights, "seconds": sec,
                    "member_epoch": out["member_epoch"],
                    "gained": list(out["gained"]), "lost": list(out["lost"]),
                    "puts": sorted(puts), "adopted": sorted(adopted),
                    "put_bytes": after.get("ps/state_put_bytes", 0)
                    - m.get("ps/state_put_bytes", 0),
                    "fetch_bytes": after.get("ps/state_fetch_bytes", 0)
                    - m.get("ps/state_fetch_bytes", 0),
                    "before": before, "after": _state_report(trainer)})
        t = time.perf_counter()
        _drain(trainer)
        drain_s = time.perf_counter() - t
        report["step_ms"][-1] += drain_s * 1e3
        m = get_registry().snapshot()
        digest = hashlib.sha1()
        for _, p in sorted(trainer.model.named_parameters()):
            digest.update(p.detach().cpu().numpy().tobytes())
        steps = STEPS - first + 1
        want = dict.fromkeys(COUNT_KEYS, 0)
        want["flash_fwd"] = 2 * cfg.layers * steps
        want["flash_bwd_fused"] = cfg.layers * steps
        report.update({
            "launches": read_counts(ctr), "want": by_width(want, cfg.head_dim),
            "params": digest.hexdigest(), "reshards": reshards,
            "end": _state_report(trainer),
            "adopted_at_start": sorted(adopted) if arm == "g2" else None,
            "group_bytes": list(trainer._sharded.plan.group_bytes),
            "resends": m.get("transport/resends", 0),
            "reconnects": m.get("transport/reconnects", 0),
            "lines": lines.lines, "peak_mem": torch.cuda.max_memory_allocated()})
        trainer.close()
        return report
    finally:
        ChunkedApply.adopt_group = real_adopt
        get_logger().removeHandler(lines)
        bps.shutdown()


def _plan_from(inputs, rank=0, world=2):
    """A ``ShardedUpdatePlan`` from a worker's ``_plan_inputs``."""
    from types import SimpleNamespace

    from byteps_tpu_torch.sharded_update import ShardedUpdatePlan
    keyed = [(k, SimpleNamespace(index=i, segments=[
        SimpleNamespace(leaf_index=li) for li in leaves]))
        for k, i, leaves in inputs["keyed"]]
    meta = [(tuple(sh), dt, n) for sh, dt, n in inputs["leaf_meta"]]
    return ShardedUpdatePlan(keyed, inputs["groups"], meta, rank, world)


def check_membership_plans(res):
    """What is wrong with (g1)'s two workers' reports ``res``; empty when
    nothing is. After each reshard both owner maps equal the port's own
    ``ShardedUpdatePlan.reshard`` of the plan before on the weights the
    workers used; after the LEAVE worker 1 owns nothing and holds no
    state, worker 0 owns every group and holds both moments of every
    parameter; after the JOIN each worker's state covers exactly its
    owned groups; the member epoch ends at 3; the state frames a worker
    put are the groups it lost, the groups it adopted those it gained."""
    bad = []
    plan = _plan_from(res[0]["plan"])
    n, total = len(plan.groups), sum(plan.group_bytes)
    if [r["start"]["owner"] for r in res] != [plan.owner] * 2:
        bad.append("the starting owner maps are not the plan's")
    for k, live in enumerate(MEMBERSHIP_LIVE.values()):
        rs = [r["reshards"][k] for r in res]
        weights = rs[0]["weights"]
        if rs[1]["weights"] != weights:
            bad.append(f"reshard {k + 1}: the workers' weights differ")
        plan = plan.reshard(live, weights=weights)
        for wid, x in enumerate(rs):
            a = x["after"]
            if a["owner"] != plan.owner:
                bad.append(f"reshard {k + 1} worker {wid}: owner map "
                           f"{a['owner']}, the plan's {plan.owner}")
            mine = sorted(gi for gi, o in enumerate(plan.owner) if o == wid)
            if a["owned"] != mine or a["with_state"] != mine:
                bad.append(f"reshard {k + 1} worker {wid}: owns "
                           f"{a['owned']}, state for {a['with_state']}, "
                           f"the plan gives it {mine}")
            owned_bytes = sum(plan.group_bytes[gi] for gi in mine)
            if a["moment_bytes"] != 2 * owned_bytes:
                bad.append(f"reshard {k + 1} worker {wid}: moments "
                           f"{a['moment_bytes']} bytes, its groups' "
                           f"{2 * owned_bytes}")
            if not mine and a["state_bytes"]:
                bad.append(f"reshard {k + 1} worker {wid}: owns nothing and "
                           f"holds {a['state_bytes']} bytes of state")
            if x["puts"] != x["lost"] or x["adopted"] != x["gained"]:
                bad.append(f"reshard {k + 1} worker {wid}: put {x['puts']} "
                           f"for lost {x['lost']}, adopted {x['adopted']} "
                           f"for gained {x['gained']}")
            before = set(x["before"]["owned"])
            if x["lost"] != sorted(before - set(mine)) \
                    or x["gained"] != sorted(set(mine) - before):
                bad.append(f"reshard {k + 1} worker {wid}: lost "
                           f"{x['lost']} and gained {x['gained']} from "
                           f"{sorted(before)} to {mine}")
        if k == 0 and ([x["after"]["owned"] for x in rs]
                       != [list(range(n)), []]
                       or rs[0]["after"]["moment_bytes"] != 2 * total):
            bad.append("after the LEAVE worker 0 does not own and hold "
                       "every group, or worker 1 still owns one")
    if [r["end"]["member_epoch"] for r in res] != [3, 3]:
        bad.append(f"member epochs {[r['end']['member_epoch'] for r in res]}"
                   f", expected 3 on both")
    return bad


def check_membership_slices(g0, g2):
    """What is wrong with the checkpoint between (g0)'s reports (the save)
    and (g2)'s (the restore); empty when nothing is. The restored meta has
    (g0)'s owner map and member epoch; the step's slice directory holds
    one slice a group, the two workers' saved slices together; each (g2)
    worker adopted exactly its owned groups, holds state for them only,
    and left the optimizer untouched until its first step."""
    bad = []
    n = len(g0[0]["save"]["owner"])
    saved = {}
    for r in g0:
        saved.update(r["save"]["slices"])
    want = sorted(f"g{gi}.bin" for gi in range(n))
    if sorted(saved) != want:
        bad.append(f"(g0) saved slices {sorted(saved)}, one a group wanted")
    for wid, r in enumerate(g2):
        rs = r["restore"]
        if rs["owner"] != g0[0]["save"]["owner"] \
                or rs["member_epoch"] != g0[0]["save"]["member_epoch"]:
            bad.append(f"(g2) worker {wid}: meta owner map or member epoch "
                       f"not (g0)'s")
        if sorted(rs["slices"]) != want or rs["slices"] != saved:
            bad.append(f"(g2) worker {wid}: slices {sorted(rs['slices'])}")
        mine = sorted(gi for gi, o in enumerate(rs["owner"]) if o == wid)
        if r["adopted_at_start"] != mine or r["end"]["with_state"] != mine \
                or r["end"]["owned"] != mine:
            bad.append(f"(g2) worker {wid}: adopted "
                       f"{r['adopted_at_start']}, state for "
                       f"{r['end']['with_state']}, owns {mine}")
        if rs["optimizer_before_step"]:
            bad.append(f"(g2) worker {wid}: the restore touched the "
                       f"optimizer before the first step")
    return bad


def check_one_sha1(arms):
    """What is wrong across the arms {arm: the two workers' reports}: every
    worker of every arm ends on one sha1 of its parameters, and every
    worker's loss of a step is that step's loss in every arm."""
    bad = []
    shas = {(arm, w): r["params"] for arm, res in arms.items()
            for w, r in enumerate(res)}
    if len(set(shas.values())) != 1:
        bad.append(f"parameters differ: {shas}")
    ref = arms["g0"]
    for arm, res in arms.items():
        for wid, r in enumerate(res):
            want = ref[wid]["losses"][STEPS - len(r["losses"]):]
            if r["losses"] != want:
                bad.append(f"({arm}) worker {wid}: losses {r['losses']}, "
                           f"(g0)'s {want}")
    return bad


def train_bert_ps_membership():
    """Phase ``bert_large_ps_membership``: BERT-large at full width and
    depth, dense PS (no ``BPS_COMPRESS``) on the default route at world 2
    with ``BPS_SHARDED_UPDATE=1``, two worker processes on ``cuda:0`` from
    seed-0 weights, each on its own batches (``membership_batch``), a
    fresh ``launch --server`` an arm, ``STEPS`` counted steps:

    (g0) the control, steps 1-3; after step 2 both workers call
    ``save_sharded_checkpoint(DIR/ck, trainer)``. (g1) step 1; both call
    ``trainer.reshard([0])`` (worker 1 leaves the ownership plan, its
    groups' AdamW state handed to worker 0 through the server); step 2;
    ``reshard([0, 1])`` (worker 1 rejoins); step 3. (g2) two fresh worker
    processes each call ``restore_sharded(DIR/ck)`` before their first
    step, then take step 3 on (g0)'s third batches.

    Gates, each exact: one sha1 of every parameter and the same losses
    step by step on every worker of every arm (``check_one_sha1``: a
    handoff and a slice move the optimizer state's bytes, and each
    group's owner applies the same operations to them); no fallback,
    "never published" or "no slice" line; the plans, the state bytes and
    the frames around each reshard (``check_membership_plans``); the
    checkpoint (``check_membership_slices``); 48 forward and 24 fused
    backward launches a step at d 64 and no codec launch on every worker;
    ``transport/resends`` and ``transport/reconnects`` 0.

    Printed, not gated: each arm's steps (the arms in turn in this call),
    each reshard's seconds and bytes handed off, each worker's state bytes
    around each reshard, the checkpoint's bytes and its save and restore
    seconds, each server's peak RSS, beside the card. Returns each arm's
    launches summed over its workers."""
    import shutil
    import tempfile
    card = card_line()
    tag = "bert_large ps membership"
    where = Path(tempfile.mkdtemp())
    try:
        # the checkpoint: fp32 params and AdamW's two moments
        need = 3 * 4 * _bert_params()
        free = shutil.disk_usage(where).free
        if free < need + CKPT_DISK_MARGIN:
            raise AssertionError(f"{tag}: {free} bytes free at {where}, the "
                                 f"checkpoint needs {need} and "
                                 f"{CKPT_DISK_MARGIN} to spare")
        arms = _arms_over_servers("membership", "--membership-worker",
                                  {"g0": {}, "g1": {}}, where)
        arms.update(_arms_over_servers(
            "membership restore", "--membership-restore-worker", {"g2": {}},
            where))
    finally:
        shutil.rmtree(where, ignore_errors=True)
    res = {arm: r for arm, (r, _) in arms.items()}
    bad = []
    for arm, (rs, stats) in arms.items():
        atag = f"{tag} {arm}"
        for wid, r in enumerate(rs):
            log(f"[{atag}] worker {wid}: losses {r['losses']}, steps "
                f"{[round(x, 1) for x in r['step_ms']]} ms (the last with "
                f"its tail drained; two worker processes share one card), "
                f"peak memory {r['peak_mem']} bytes, state "
                f"{r['end']['state_bytes']} bytes for groups "
                f"{r['end']['with_state']}; {card}")
            for x in r["reshards"]:
                log(f"[{atag}] worker {wid}: reshard({x['live']}) in "
                    f"{x['seconds']:.3f} s, member epoch "
                    f"{x['member_epoch']}, lost {x['lost']} ({x['put_bytes']}"
                    f" bytes put), gained {x['gained']} ({x['fetch_bytes']} "
                    f"bytes fetched); state {x['before']['state_bytes']} -> "
                    f"{x['after']['state_bytes']} bytes (moments "
                    f"{x['before']['moment_bytes']} -> "
                    f"{x['after']['moment_bytes']}); {card}")
            if "save" in r:
                log(f"[{atag}] worker {wid}: save in "
                    f"{r['save']['seconds']:.3f} s, slices "
                    f"{sum(r['save']['slices'].values())} bytes in "
                    f"{len(r['save']['slices'])} files, state.pt "
                    f"{r['save']['state_pt']} bytes; {card}")
            if "restore" in r:
                log(f"[{atag}] worker {wid}: restore_sharded in "
                    f"{r['restore']['seconds']:.3f} s (the slices install "
                    f"in the first step), {len(r['restore']['slices'])} "
                    f"slices, adopted {r['adopted_at_start']}; {card}")
            if not all(math.isfinite(x) for x in r["losses"]):
                bad.append(f"({arm}) worker {wid}: losses {r['losses']}")
            if r["launches"] != r["want"]:
                bad.append(f"({arm}) worker {wid}: launches "
                           f"{r['launches']}, expected {r['want']}")
            if r["resends"] or r["reconnects"]:
                bad.append(f"({arm}) worker {wid}: resends {r['resends']}, "
                           f"reconnects {r['reconnects']}")
            if r["lines"]:
                bad.append(f"({arm}) worker {wid}: {r['lines']}")
        log(f"[{atag}] server peak RSS {stats['peak_rss_bytes']} bytes "
            f"({stats['peak_rss_source']}); {card}")
    bad += check_membership_plans(res["g1"])
    bad += check_membership_slices(res["g0"], res["g2"])
    bad += check_one_sha1(res)
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))
    log(f"[{tag}] every parameter of both workers in (g0), (g1), (g2) one "
        f"sha1 ({res['g0'][0]['params']}), the losses step by step the "
        f"same; every gate held")
    SUMMARY[tag] = {
        arm: {"step_ms": [r["step_ms"] for r in rs],
              "server_peak_rss": stats["peak_rss_bytes"],
              "reshards": [[{k: x[k] for k in ("live", "seconds",
                                                "put_bytes", "fetch_bytes")}
                            | {"state_bytes": [x["before"]["state_bytes"],
                                               x["after"]["state_bytes"]]}
                            for x in r["reshards"]] for r in rs],
              "save": [r.get("save", {}).get("seconds") for r in rs],
              "restore": [r.get("restore", {}).get("seconds") for r in rs]}
        for arm, (rs, stats) in arms.items()}
    return tuple({k: rs[0]["launches"][k] + rs[1]["launches"][k]
                  for k in rs[0]["launches"]} for rs, _ in arms.values())


def _bert_params():
    """BERT-large's parameter count at full depth (from its config)."""
    from byteps_tpu_torch.models.transformer import Transformer
    cfg, _, _, _ = _bert_setup()
    with torch.device("meta"):
        return sum(p.numel() for p in Transformer(cfg).parameters())


PHASE_S = {}


@contextlib.contextmanager
def _phase(name):
    """The block's seconds, logged and kept in ``PHASE_S``."""
    t = time.perf_counter()
    try:
        yield
    finally:
        PHASE_S[name] = round(time.perf_counter() - t, 1)
        log(f"[phase] {name}: {PHASE_S[name]} s")


def _timed(name, fn, *args):
    """``fn(*args)``, its seconds logged and kept in ``PHASE_S``."""
    with _phase(name):
        return fn(*args)


def _remote_phases(paths):
    """The phases over ``launch --server``: int8 over TCP at world 1, the
    world-2 int8 arms, the bounded-staleness arms, async PS."""
    paths["bert_large_ps_int8_tcp"] = _timed("bert_large_ps_int8_tcp (cut)",
                                             train_bert_ps_tcp)
    paths["bert_large_ps_int8_world2"], \
        paths["bert_large_ps_int8_world2_sharded"] = _timed(
            "bert_large_ps_int8_world2 (cut)", train_bert_ps_world2)
    (paths["bert_large_ps_lag_c0"], paths["bert_large_ps_lag_c1"],
     paths["bert_large_ps_lag_c2"]) = _timed("bert_large_ps_lag (cut)",
                                             train_bert_ps_lag)
    (paths["bert_large_ps_async_d0"], paths["bert_large_ps_async_d1"],
     paths["bert_large_ps_async_d2"]) = _timed("bert_large_ps_async",
                                               train_bert_ps_async)


def _store_phases(paths):
    """The PS store's routes at world 2 over ``launch --server``, and the
    full-tree checkpoint at world 1."""
    (paths["bert_large_ps_store_routes_e0"],
     paths["bert_large_ps_store_routes_e1"]) = _timed(
        "bert_large_ps_store_routes (cut)", train_bert_ps_store_routes)
    paths["bert_large_checkpoint"] = _timed("bert_large_checkpoint (cut)",
                                            train_bert_checkpoint)


def _transport_phases(paths):
    """The transport's routes at world 2 over ``launch --server`` (TCP,
    the colocated deployment, striping) and the snapshot restart."""
    (paths["bert_large_ps_transport_f0"], paths["bert_large_ps_transport_f1"],
     paths["bert_large_ps_transport_f2"]) = _timed(
        "bert_large_ps_transport (cut)", train_bert_ps_transport)
    paths["bert_large_ps_snapshot_f3"] = _timed(
        "bert_large_ps_snapshot (cut)", train_bert_ps_snapshot)


def _membership_phases(paths):
    """The sharded update's membership change and sharded checkpoints at
    world 2 over ``launch --server``."""
    (paths["bert_large_ps_membership_g0"],
     paths["bert_large_ps_membership_g1"],
     paths["bert_large_ps_membership_g2"]) = _timed(
        "bert_large_ps_membership", train_bert_ps_membership)


def remote_ps_main(only=None) -> int:
    """``--remote-ps``: the toolchain, then only phase 4's remote PS runs,
    the store's phases and the transport's; ``--async-ps``: only
    ``bert_large_ps_async`` of them; ``--store-routes``: only
    ``bert_large_ps_store_routes`` and ``bert_large_checkpoint``;
    ``--transport``: only ``bert_large_ps_transport`` and
    ``bert_large_ps_snapshot``; ``--membership``: only
    ``bert_large_ps_membership``."""
    t = time.perf_counter()
    toolchain()
    paths = {}
    if only == "async":
        (paths["bert_large_ps_async_d0"], paths["bert_large_ps_async_d1"],
         paths["bert_large_ps_async_d2"]) = _timed("bert_large_ps_async",
                                                   train_bert_ps_async,
                                                   ASYNC_SOAK)
    elif only == "store":
        _store_phases(paths)
    elif only == "transport":
        _transport_phases(paths)
    elif only == "membership":
        _membership_phases(paths)
    else:
        _remote_phases(paths)
        _store_phases(paths)
        _transport_phases(paths)
        _membership_phases(paths)
    log(f"phase seconds {json.dumps(PHASE_S)}")
    log(f"remote PS in {time.perf_counter() - t:.1f} s")
    print(json.dumps({"remote_ps": {
        "launches": {p: {k: v for k, v in c.items() if v and ":" not in k}
                     for p, c in paths.items()}, **SUMMARY}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------------------------- --sp N: the ring over N cards

SP_TRAIN_TOL = 2e-2     # |step-1 loss over the ring - the dense model's|


def _sp_inputs(b, s, h, d, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g).to(dev, torch.bfloat16)
            for _ in range(4)]


def _events_ms(fn, dist, iters=10):
    """Each rank's mean time of ``fn`` over ``iters`` runs (CUDA events,
    after a warm-up and a barrier); the slowest rank's."""
    fn()
    dist.barrier()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    t = torch.tensor([start.elapsed_time(end) / iters], device="cuda")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.item()


def sp_ring_checks(rank, n, mesh, dev, dist):
    """Ring attention over the ``seq`` ranks against the whole sequence on
    one card. Returns rank 0's results (None elsewhere)."""
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.parallel import ring
    from byteps_tpu_torch.parallel.mesh import use_mesh
    res = []
    for h, d in ((HEADS, HEAD_DIM), (DH128_HEADS, DH128)):
        for causal in (True, False):
            b, S = RING_BATCH, RING_SEQ
            q, k, v, do = _sp_inputs(b, S, h, d, 90 + causal, dev)
            s = S // n
            sl = slice(rank * s, (rank + 1) * s)
            tag = (f"ring over {n} cards: b{b} s{S} h{h} d{d} "
                   f"{'causal' if causal else 'full'}")
            xs = [t[:, sl].clone().requires_grad_() for t in (q, k, v)]
            fa.zero_counts(fa.flash_fwd)
            fa.zero_counts(fa.flash_bwd_fused)
            with use_mesh(mesh):
                out = ring.ring_attention(*xs, "seq", causal=causal)
                out.backward(do[:, sl])
            torch.cuda.synchronize()
            got = (fa.flash_fwd.launches_f32, fa.flash_bwd_fused.launches_delta,
                   fa.flash_fwd.launches, fa.flash_bwd_fused.launches)
            want = rank + 1 if causal else n
            if got != (want,) * 4:
                raise AssertionError(f"{tag}: rank {rank} launched {got}, "
                                     f"expected {want} of each form")
            parts = []          # out, dq, dk, dv of the whole sequence
            for t in (out, *(x.grad for x in xs)):
                every = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(every, t.detach().contiguous())
                parts.append(torch.cat(every, 1))
            # the ring's forward and backward on each card, the slowest's
            def step():
                ys = [t.detach().requires_grad_() for t in xs]
                with use_mesh(mesh):
                    ring.ring_attention(*ys, "seq", causal=causal).backward(
                        do[:, sl])
            ring_ms = _events_ms(step, dist)
            if rank == 0:
                out_w, dq, dk, dv = parts
                sched = ring.ring_schedule(q, k, v, do, n, causal)
                same = [torch.equal(a, c) for a, c in
                        zip((out_w, dq, dk, dv), (sched[0], *sched[2:]))]
                ref_x = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                ref = ring.local_attention(*ref_x, causal=causal)
                ref.backward(do)
                _check("out vs local_attention", tag, out_w, ref)
                errs = {}
                for g_, x, name in zip((dq, dk, dv), ref_x, "qkv"):
                    e, r = _rel_err(g_, x.grad)
                    errs[f"d{name}"] = r
                    log(f"[check {tag}] d{name} vs autograd of local_attention "
                        f"{e:.3e} (rel {r:.2e})")
                    if not r <= REL_TOL_AUTOGRAD:
                        raise AssertionError(f"{tag}: d{name} disagrees")
                log(f"[check {tag}] vs ring_schedule on one card: " + ", ".join(
                    f"{nm} {'bit-identical' if sm else 'differs'}"
                    for nm, sm in zip(("out", "dq", "dk", "dv"), same)))
                qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
                one_ms = time_ms(lambda: fa.flash_attention(
                    qa, ka, va, causal=causal).backward(do), n=10)
                log(f"[time {tag}] ring forward + backward {ring_ms:.4f} ms "
                    f"(slowest card, mean of 10); the whole sequence's flash "
                    f"attention forward + backward on one card {one_ms:.4f} ms")
                res.append({"shape": [b, S, h, d], "causal": causal,
                            "rel_err": errs, "bit_for_bit_vs_schedule": same,
                            "ring_ms": ring_ms, "one_card_ms": one_ms})
            del q, k, v, do, xs, out, parts
            torch.cuda.empty_cache()
    return res if rank == 0 else None


def sp_train(rank, n, mesh, dev, dist):
    """BERT-large and GPT-2 medium through ShardedTrainer on the ``seq``
    ranks; rank 0 holds step 1 against the dense model's loss."""
    import dataclasses

    from byteps_tpu_torch.models import bert, gpt2
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import ShardedTrainer
    ctr = counters()
    res = {}
    bert_cfg = bert.bert_large(max_seq=BERT_SEQ, sp_axis="seq")
    gpt2_cfg = gpt2.gpt2_medium(sp_axis="seq")
    for tag, cfg, loss_fn, data in (
            ("bert_large_sp", bert_cfg, bert.mlm_loss, bert.synth_mlm_batch(
                np.random.RandomState(0), TRAIN_BATCH, BERT_SEQ,
                bert_cfg.vocab_size)),
            ("gpt2_medium_sp", gpt2_cfg, gpt2.causal_lm_loss,
             gpt2.synth_lm_batch(np.random.RandomState(0), TRAIN_BATCH,
                                 GPT2_SEQ, gpt2_cfg.vocab_size))):
        tag = f"{tag} over {n} cards"
        model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
        tr = ShardedTrainer(loss_fn, model, adamw(model.parameters(), 1e-4),
                            mesh, partition_bytes=PARTITION_BYTES, device=dev)
        zero_counts(ctr)
        losses, times = [], []
        for _ in range(STEPS):
            t = time.perf_counter()
            losses.append(tr.step(data).item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        got = read_counts(ctr)
        blocks = rank + 1 if cfg.causal else n
        want = {"flash_fwd:f32": STEPS * cfg.layers * 2 * blocks,
                "flash_bwd_fused:delta": STEPS * cfg.layers * blocks}
        want["flash_fwd"] = want["flash_fwd:f32"]
        want["flash_bwd_fused"] = want["flash_bwd_fused:delta"]
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            want[name] = 0
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"{tag}: rank {rank} launched "
                                 f"{ {k: got[k] for k in want} }, expected {want}")
        sums = torch.tensor([p.detach().double().sum().item()
                             for p in model.parameters()], device=dev)
        every = [torch.empty_like(sums) for _ in range(n)]
        dist.all_gather(every, sums)
        del tr, model
        torch.cuda.empty_cache()
        if rank != 0:
            continue
        same = all(torch.equal(every[0], e) for e in every[1:])
        dense_cfg = dataclasses.replace(cfg, sp_axis=None)
        dense = Transformer(dense_cfg,
                            generator=torch.Generator().manual_seed(0)).to(dev)
        batch = (tuple(torch.from_numpy(x).to(dev) for x in data)
                 if isinstance(data, tuple) else torch.from_numpy(data).to(dev))
        with torch.no_grad():
            ref = loss_fn(dense, batch).item()
        del dense
        torch.cuda.empty_cache()
        diff = abs(losses[0] - ref)
        log(f"[{tag}] losses {losses}; step times s {times}; launches on rank "
            f"0 { {k: got[k] for k in want} }; step-1 loss vs the dense "
            f"model's on one card {ref:.6f}: |diff| {diff:.3e}; every rank "
            f"the same weights: {same}")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"{tag}: losses {losses}")
        if not (diff <= SP_TRAIN_TOL and same):
            raise AssertionError(f"{tag}: step-1 loss or replicas disagree")
        res[tag] = {"losses": losses, "step_s": times, "dense_step1": ref,
                    "same_weights": same,
                    "launches_rank0": {k: got[k] for k in want}}
    return res


def sp_rank(rank, n, port, out, device="cuda"):
    """One rank of ``--sp n``: its card, the NCCL group, the mesh, the
    checks; rank 0 writes the results to ``out``."""
    import datetime

    import torch.distributed as dist

    from byteps_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device(device, rank) if device == "cuda" else torch.device(device)
    if device == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh({"seq": n})
        res = {"ring": sp_ring_checks(rank, n, mesh, dev, dist),
               "train": sp_train(rank, n, mesh, dev, dist)}
        dist.barrier()
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


def sp_main(n) -> int:
    """``--sp n``: build the kernels once, then one process per card."""
    import os
    import socket
    import tempfile
    if torch.cuda.device_count() < n:
        print(f"chip_smoke --sp {n}: {torch.cuda.device_count()} CUDA "
              f"device(s), {n} needed", file=sys.stderr)
        return 2
    toolchain()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = Path(tempfile.mkdtemp()) / "sp.json"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--sp-rank", str(r), str(n), str(port),
         str(out)], env=dict(os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    for r, (p, text) in enumerate(zip(procs, logs)):
        log(f"----- rank {r} (exit {p.returncode})")
        log(text if r == 0 or p.returncode else text[-2000:])
    if any(p.returncode for p in procs):
        raise AssertionError("a rank of the sequence-parallel run failed")
    print(json.dumps({"sp": {"cards": n, **json.loads(out.read_text())}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------------- --world N: the plugin and engine over NCCL

def _world_setup(tiny):
    import dataclasses

    from byteps_tpu_torch.models import bert
    cfg, loss_fn, data, fps = _bert_setup()
    if tiny:           # a CPU rehearsal over gloo
        cfg = dataclasses.replace(bert.bert_tiny(attn_impl="naive"),
                                  max_seq=BERT_SEQ)
        data = bert.synth_mlm_batch(np.random.RandomState(0), 2, BERT_SEQ,
                                    cfg.vocab_size)
    return cfg, loss_fn, data, fps


def world_rank(rank, n, port, out, device="cuda", tiny=False):
    """One rank of ``--world n``: ``bps.init()`` over NCCL (gloo on the
    CPU), BERT-large through the plugin's ``DistributedOptimizer`` (its
    hooks reduce every gradient as backward produces it) for 3 steps on
    this rank's batch, then one backward's gradients through the
    top-level ``push_pull`` and ``push_pull_async``, each held bit for bit
    against the mean of the ranks' gradients gathered with ``all_gather``;
    rank 0 writes the results to ``out``."""
    import datetime
    import os

    import torch.distributed as dist

    import byteps_tpu_torch as bps
    import byteps_tpu_torch.torch as bt
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.models.transformer import Transformer
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import _to_device
    os.environ.update(BPS_NUM_WORKER=str(n), BPS_WORKER_ID=str(rank),
                      BPS_LOCAL_RANK=str(rank), BPS_LOCAL_SIZE=str(n),
                      BPS_COORDINATOR_ADDRESS=f"localhost:{port}")
    bps.init(device=device, timeout=datetime.timedelta(seconds=300))
    cuda = device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    try:
        cfg, loss_fn, _, fps = _world_setup(tiny)
        rows = 2 if tiny else TRAIN_BATCH
        batch = _to_device(bert.synth_mlm_batch(
            np.random.RandomState(100 + rank), rows, BERT_SEQ,
            cfg.vocab_size), dev)
        model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
        opt = bt.DistributedOptimizer(adamw(model.parameters(), 1e-4),
                                      named_parameters=model.named_parameters())
        model.to(dev)
        bt.broadcast_parameters(model.state_dict(), 0)
        bt.broadcast_optimizer_state(opt, 0)
        first = []
        dispatch = opt._push_pull_grad_async

        def timed_dispatch(p):
            if not first:
                first.append(time.perf_counter())
            return dispatch(p)
        opt._push_pull_grad_async = timed_dispatch
        ctr = counters()
        zero_counts(ctr)
        losses, times, api = [], [], []
        for i in range(2 * STEPS):
            if i == STEPS:
                launches = read_counts(ctr)
            first.clear()
            sync()
            t = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model, batch)
            loss.backward()
            opt.step()
            sync()
            times.append(time.perf_counter() - t)
            api.append(time.perf_counter() - first[0])
            losses.append(loss.item())
        if not (all(math.isfinite(x) for x in losses)
                and losses[STEPS - 1] < losses[0]):
            raise AssertionError(f"rank {rank}: losses {losses}")
        want = _attention_launches(cfg, ("flash_bwd_fused",))(None)
        if cuda and launches != want:
            raise AssertionError(f"rank {rank}: launches {launches}, "
                                 f"expected {want}")
        # every rank holds rank 0's parameters, bit for bit
        differ = 0
        for p in model.parameters():
            ref = p.detach().clone()
            dist.broadcast(ref, 0)
            differ += int(not torch.equal(ref, p.detach()))
        if differ:
            raise AssertionError(f"rank {rank}: {differ} parameters differ "
                                 "from rank 0's")
        # the engine: one backward's gradients as a tree
        opt.zero_grad(set_to_none=True)
        loss_fn(model, batch).backward()
        grads = {k: p.grad.detach().clone()
                 for k, p in model.named_parameters()}
        res = {}
        for how in ("push_pull", "push_pull_async"):
            sync()
            t = time.perf_counter()
            if how == "push_pull":
                got = bps.push_pull(grads, name="world.grads")
            else:
                got = bps.synchronize(bps.push_pull_async(
                    grads, name="world.grads.async"))
            sync()
            res[f"{how}_ms"] = (time.perf_counter() - t) * 1e3
            for k, g in grads.items():
                parts = [torch.empty_like(g) for _ in range(n)]
                dist.all_gather(parts, g)
                mean = parts[0]
                for q in parts[1:]:
                    mean = mean + q
                if not torch.equal(got[k], mean / n):
                    raise AssertionError(f"rank {rank}: {how} of {k} is not "
                                         "the mean of the ranks' gradients")
        res.update(world_rs_round(n, grads, ctr, sync, cuda, dist))
        nbytes = sum(g.nbytes for g in grads.values())
        res.update({"losses": losses, "step_ms": [x * 1e3 for x in times],
                    "api_host_ms": [x * 1e3 for x in api],
                    "grad_bytes": nbytes, "fps": fps,
                    "launches": {k: v for k, v in
                                 (launches if cuda else {}).items() if v}})
        gathered = [None] * n
        dist.all_gather_object(gathered, res)
        if rank == 0:
            Path(out).write_text(json.dumps(gathered))
    finally:
        bt.shutdown()
    return 0


def world_rs_round(n, grads, ctr, sync, cuda, dist):
    """One round of the README's onebit over the rs exchange on this
    rank's gradients ``grads`` at world ``n``: through the kernels and
    through their plain versions (``compressor_backend="jnp"``) from fresh
    states, which must agree bit for bit, be finite and be the same on
    every rank; (n + 1)·nc pack and (3n + 1)·nc unpack launches (n shard
    packs and their error feedback's unpacks, n received shards, the
    merge's pack and unpack, n gathered merges)."""
    from byteps_tpu_torch.ops.compression.reducer import CompressionPlan
    from byteps_tpu_torch.parallel.collectives import leaf_specs
    names = sorted(grads)
    specs = leaf_specs([grads[k] for k in names], names)
    kw = GPT2_COMPRESSION["onebit_rs"]
    outs = {}
    for backend in ("auto", "jnp"):
        plan = CompressionPlan(specs, PARTITION_BYTES,
                               dict(kw, compressor_backend=backend),
                               MIN_COMPRESS_BYTES, world=n)
        red = [grads[k].clone() for k in names]
        state = plan.init_state(red[0].device)
        zero_counts(ctr)
        sync()
        t = time.perf_counter()
        plan.reduce(red, state, group=dist.group.WORLD)
        sync()
        outs[backend] = (red, (time.perf_counter() - t) * 1e3,
                         read_counts(ctr))
    (red, ms, counts), (plain, _, _) = outs["auto"], outs["jnp"]
    nc = plan.n_compressed
    if cuda and (counts["onebit_pack"], counts["onebit_unpack"]) != \
            ((n + 1) * nc, (3 * n + 1) * nc):
        raise AssertionError(f"rs round: {counts['onebit_pack']} pack, "
                             f"{counts['onebit_unpack']} unpack launches "
                             f"for {nc} compressed buckets at world {n}")
    for k, a, b in zip(names, red, plain):
        if not (torch.isfinite(a).all() and _same_bits(a, b)):
            raise AssertionError(f"rs round: {k} through the kernels is not "
                                 "the plain versions' bit for bit")
        ref = a.clone()
        dist.broadcast(ref, 0)
        if not _same_bits(ref, a):
            raise AssertionError(f"rs round: {k} differs from rank 0's")
    return {"rs_ms": ms, "rs_compressed_buckets": nc,
            "rs_launches": {k: counts[k] for k in ("onebit_pack",
                                                   "onebit_unpack")}}


def world_main(n) -> int:
    """``--world n``: build the kernels once, then one process per card."""
    import os
    import socket
    import tempfile
    if torch.cuda.device_count() < n:
        print(f"chip_smoke --world {n}: {torch.cuda.device_count()} CUDA "
              f"device(s), {n} needed", file=sys.stderr)
        return 2
    toolchain()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = Path(tempfile.mkdtemp()) / "world.json"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--world-rank", str(r), str(n), str(port),
         str(out)], env=dict(os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    for r, (p, text) in enumerate(zip(procs, logs)):
        log(f"----- rank {r} (exit {p.returncode})")
        log(text if r == 0 or p.returncode else text[-2000:])
    if any(p.returncode for p in procs):
        raise AssertionError("a rank of the --world run failed")
    ranks = json.loads(out.read_text())
    card = card_line()
    for r, res in enumerate(ranks):
        steps = res["step_ms"][STEPS:]
        log(f"[world {n} rank {r}] plugin step (median of steps 4-6) "
            f"{statistics.median(steps):.1f} ms = "
            f"{TRAIN_BATCH / statistics.median(steps) * 1e3:.2f} samples/s a "
            f"rank; the API's host time (first dispatch to the last "
            f"synchronize) {statistics.median(res['api_host_ms'][STEPS:]):.1f}"
            f" ms; engine push_pull of {res['grad_bytes']} bytes "
            f"{res['push_pull_ms']:.1f} ms, push_pull_async + synchronize "
            f"{res['push_pull_async_ms']:.1f} ms; onebit over rs "
            f"{res['rs_ms']:.1f} ms ({res['rs_compressed_buckets']} "
            f"compressed buckets, launches {res['rs_launches']}); on {card}")
    print(json.dumps({"world": {"cards": n, "ranks": ranks}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _thread_cpu() -> dict:
    """CPU seconds of every thread of this process by group (the pool's
    name prefix, ``main``, or the kernel's name for threads Python did not
    start, such as the server engine's), from ``/proc/self/task``."""
    import os
    import threading
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
            with open(f"/proc/self/task/{tid}/comm") as f:
                comm = f.read().strip()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        cpu = (int(fields[11]) + int(fields[12])) / tick
        name = names.get(int(tid), comm)
        group = ("main" if name == "MainThread"
                 else re.sub(r"[_-]?\d+(_\d+)?$", "", name))
        out[group] = out.get(group, 0.0) + cpu
    return out


class _Sampler:
    """A stack sampler of every Python thread (``sys._current_frames``
    every ``period`` s): counts, per thread group, the innermost frame
    in this repository's code, as ``file:function:line``."""

    def __init__(self, period: float = 0.002) -> None:
        import threading
        self.period = period
        self.counts: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ps-profile-sampler")

    def _run(self) -> None:
        import threading
        me = threading.get_ident()
        root = str(ROOT)
        while not self._stop.wait(self.period):
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                name = names.get(ident, "?")
                group = ("main" if name == "MainThread"
                         else re.sub(r"[_-]?\d+(_\d+)?$", "", name))
                f = frame
                while f is not None and not f.f_code.co_filename.startswith(
                        root):
                    f = f.f_back
                if f is None:
                    where = f"(outside the repo) {frame.f_code.co_name}"
                else:
                    where = (f"{Path(f.f_code.co_filename).name}:"
                             f"{f.f_code.co_name}:{f.f_lineno}")
                g = self.counts.setdefault(group, {})
                g[where] = g.get(where, 0) + 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def top(self, n: int = 12) -> dict:
        return {g: sorted(c.items(), key=lambda kv: -kv[1])[:n]
                for g, c in self.counts.items()}


PS_ROUTES = (("default", {}), ("draining", {"BPS_CROSS_STEP": "0"}),
             ("unstaged", {"BPS_BWD_STAGED": "0"}),
             ("monolithic", {"BPS_APPLY_CHUNKED": "0"}))


def ps_routes(codecs=("int8", "fp8_e4m3")) -> int:
    """``--ps-routes``: the PS step's routes in turns, per codec, on
    BERT-large at the dense run's weights and batch (each route a fresh
    server, so its keys and fp8 noise are the others'): 3 steps, the
    first one warm; over steps 2-3 (the last tail drained) the wall time,
    the host stage sums (``stage/PS_*``) and each thread group's CPU
    seconds (``/proc/self/task``); step 3 again under a 2 ms stack
    sampler."""
    import os

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.obs.metrics import get_registry
    cfg, loss_fn, data, _ = _bert_setup()
    out = {}
    for codec in codecs:
        for route, env in PS_ROUTES:
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            with _ps_world({"BPS_COMPRESS": codec}):
                try:
                    trainer = _ps_trainer(cfg, loss_fn)
                finally:
                    for k, v in old.items():
                        if v is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = v
                _timed_step(trainer, data)
                get_registry().reset()
                cpu0, t0 = _thread_cpu(), time.perf_counter()
                for _ in range(2):
                    trainer.step(data)
                _drain(trainer)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                cpu1 = _thread_cpu()
                stages = {k[6:]: round(v["sum_ms"], 1) for k, v in
                          get_registry().snapshot().items()
                          if k.startswith("stage/") and v["count"]}
                with _Sampler() as smp:
                    _timed_step(trainer, data)
                del trainer
            torch.cuda.empty_cache()
            r = out.setdefault(codec, {})[route] = {
                "step_ms": wall / 2 * 1e3, "stages_ms": stages,
                "cpu_s": {g: round(cpu1[g] - cpu0.get(g, 0.0), 2)
                          for g in cpu1 if cpu1[g] - cpu0.get(g, 0.0) > 0.05},
                "sampler": smp.top(8)}
            log(f"[ps routes {codec}] {route}: {r['step_ms']:.1f} ms a step "
                f"(steps 2-3, the last tail drained; {card_line()}); "
                f"CPU s by thread group {r['cpu_s']}; stages {stages}")
            for g, top in r["sampler"].items():
                log(f"[ps routes {codec}] {route} sampler {g}: {top[:4]}")
    line = json.dumps({"ps_routes": out})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "ps_routes.json").write_text(line + "\n")
    print(line)
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def ps_profile(reps: int = 3, device: str = "cuda") -> int:
    """``--ps-profile``: where the PS API's fp8 tree path spends its time,
    beside the trainer's exchange, in one process on one card. BERT-large
    at the dense run's weights and batch, ``BPS_ENABLE_PS=1``,
    ``BPS_COMPRESS=fp8_e4m3``, one backward; then the same gradients go
    ``reps`` times, the variants in turns (forward, then backward order
    on alternate turns), through five routes, each ending with the
    summed gradients in the model's ``.grad``:

      trainer       ``PSGradientExchange.exchange`` of every gradient in
                    one tree, copied back (``DistributedTrainer._ps_step``
                    without the optimizer);
      engine_trees  the ``bert_large_pushpull_fp8`` path: the 26 trees of
                    ``_layer_trees`` through ``bps.push_pull_async``,
                    then ``bps.synchronize`` of each;
      direct_trees  the same 26 trees through ``exchange`` one after
                    another, without the engine;
      async_trees   the same 26 trees through ``exchange_async``, all
                    started before the first ``result``;
      engine_whole  every gradient in one tree through ``bps.push_pull``.

    For each route and turn: the wall time, the summed host stage times
    per bucket (``stage/PS_*``), the process's CPU seconds and each
    thread group's (``/proc/self/task``). Then one more turn of
    ``trainer`` and ``engine_trees`` under a 2 ms stack sampler. Prints
    one JSON line ``{"ps_profile": ...}``, also written to
    ``chiprun_out/ps_profile.json``, the card line and the last line.
    ``device="cpu"`` (with the helpers replaced by tiny ones) rehearses
    it on the CPU."""
    import os

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.global_state import GlobalState
    from byteps_tpu_torch.obs.metrics import get_registry
    from byteps_tpu_torch.parallel.collectives import tree_flatten
    from byteps_tpu_torch.training import _to_device
    os.environ.update({"BPS_ENABLE_PS": "1", "BPS_COMPRESS": "fp8_e4m3",
                       "BPS_COMPRESS_DEVICE": "1",
                       "BPS_PARTITION_BYTES": str(PARTITION_BYTES),
                       "BPS_MIN_COMPRESS_BYTES": str(MIN_COMPRESS_BYTES)})
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    log(card_line())
    cfg, loss_fn, data, _ = _bert_setup()
    bps.init(device=device)
    try:
        ex = GlobalState.get().engine.ps_exchange
        model, _ = _api_model(cfg)
        loss_fn(model, _to_device(data, device)).backward()
        sync()
        whole = sorted(model.named_parameters(),
                       key=lambda kv: kv[0].split("."))
        trees = _layer_trees(model, cfg.layers)
        flat = {k: tree_flatten(t)[:2] for k, t in trees.items()}

        def land(pairs):
            with torch.no_grad():
                for g, s in pairs:
                    g.copy_(s if torch.is_tensor(s)
                            else torch.from_numpy(np.ascontiguousarray(s))
                            .view_as(g))

        def trainer():
            grads = [(n, p.grad) for n, p in whole]
            land(zip([g for _, g in grads],
                     ex.exchange(grads, name="profile-whole")))

        def engine_trees():
            hs = [(k, bps.push_pull_async(t, name="Gradient." + k))
                  for k, t in trees.items()]
            for k, h in hs:
                out = bps.synchronize(h)
                land((g, out[n]) for n, g in trees[k].items())

        def direct_trees():
            for k, (paths, leaves) in flat.items():
                land(zip(leaves, ex.exchange(list(zip(paths, leaves)),
                                             name="Gradient." + k)))

        def async_trees():
            pend = [(leaves, ex.exchange_async(list(zip(paths, leaves)),
                                               name="Gradient." + k))
                    for k, (paths, leaves) in flat.items()]
            for leaves, p in pend:
                land(zip(leaves, p.result()))

        def engine_whole():
            grads = {n: p.grad for n, p in whole}
            out = bps.push_pull(grads, name="profile-engine-whole")
            land((g, out[n]) for n, g in grads.items())

        routes = {"trainer": trainer, "engine_trees": engine_trees,
                  "direct_trees": direct_trees, "async_trees": async_trees,
                  "engine_whole": engine_whole}
        for fn in routes.values():          # plans, keys, first rounds
            fn()
        sync()

        def measure(fn):
            snap0 = get_registry().snapshot()
            cpu0, thr0 = time.process_time(), _thread_cpu()
            t = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t
            cpu, thr1 = time.process_time() - cpu0, _thread_cpu()
            snap = get_registry().snapshot()
            stages = {}
            for k, v in snap.items():
                if k.startswith("stage/PS") and isinstance(v, dict):
                    n = v["count"] - snap0.get(k, {"count": 0})["count"]
                    ms = v["sum_ms"] - snap0.get(k, {"sum_ms": 0.0})["sum_ms"]
                    if n:
                        stages[k[6:]] = {"n": n, "ms_sum": ms,
                                         "ms_each": ms / n}
            return {"wall_ms": wall * 1e3, "cpu_s": cpu,
                    "threads_cpu_s": {g: thr1[g] - thr0.get(g, 0.0)
                                      for g in thr1
                                      if thr1[g] - thr0.get(g, 0.0) > 0.01},
                    "stages": stages}

        runs = {k: [] for k in routes}
        for r in range(reps):
            order = list(routes) if r % 2 == 0 else list(routes)[::-1]
            for k in order:
                m = measure(routes[k])
                runs[k].append(m)
                log(f"[ps_profile] turn {r + 1} {k}: {m['wall_ms']:.1f} ms, "
                    f"process CPU {m['cpu_s']:.2f} s, threads "
                    + ", ".join(f"{g} {s:.2f}" for g, s in
                                sorted(m["threads_cpu_s"].items()))
                    + "; " + ", ".join(
                        f"{s} {v['ms_each']:.2f} ms x {v['n']}"
                        for s, v in sorted(m["stages"].items())))
        sampled = {}
        for k in ("trainer", "engine_trees"):
            with _Sampler() as smp:
                m = measure(routes[k])
            sampled[k] = {"wall_ms": m["wall_ms"], "top": smp.top()}
            for g, rows in sorted(smp.top().items()):
                log(f"[ps_profile] sampled {k} ({m['wall_ms']:.1f} ms) "
                    f"{g}: " + "; ".join(f"{w} {c}" for w, c in rows))
        med = {k: statistics.median(m["wall_ms"] for m in v)
               for k, v in runs.items()}
        log(f"[ps_profile] median wall ms: {med}; engine_trees / trainer "
            f"{med['engine_trees'] / med['trainer']:.3f}, on {card_line()}")
        result = {"ps_profile": {"card": card_line(), "median_wall_ms": med,
                                 "runs": runs, "sampled": sampled}}
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "ps_profile.json").write_text(json.dumps(result, indent=1))
        print(json.dumps({"ps_profile": {"median_wall_ms": med}}))
    finally:
        bps.shutdown()
    if device == "cuda":
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    args = sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "byteps_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: byteps_tpu_torch not found beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args[:1] == ["--host-us"] and len(args) == 2:
        return host_us_ab(args[1])
    if args[:1] == ["--codec-ab"] and len(args) >= 2:
        return codec_ab(args[1], tuple(args[2:]) or CODEC_AB_STEMS)
    from byteps_tpu_torch.ops.flash_attention import KERNEL_DS
    if WIDTHS != KERNEL_DS:
        raise AssertionError(f"WIDTHS {WIDTHS} != the kernels' {KERNEL_DS}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    if args[:1] == ["--sp-rank"]:
        return sp_rank(int(args[1]), int(args[2]), int(args[3]), args[4])
    if args[:1] == ["--sp"]:
        return sp_main(int(args[1]))
    if args[:1] == ["--world-rank"]:
        return world_rank(int(args[1]), int(args[2]), int(args[3]), args[4])
    if args[:1] == ["--world"]:
        return world_main(int(args[1]))
    if args[:1] == ["--world2-worker"]:
        return world2_worker(int(args[1]), args[2])
    if args[:1] == ["--lag-ps-worker"]:
        return lag_ps_worker(int(args[1]), args[2])
    if args[:1] == ["--async-ps-worker"]:
        return async_ps_worker(int(args[1]), args[2], int(args[3]))
    if args[:1] == ["--store-routes-worker"]:
        return store_routes_worker(int(args[1]), args[2])
    if args[:1] == ["--transport-worker"]:
        return transport_worker(int(args[1]), args[2])
    if args[:1] == ["--snapshot-worker"]:
        return snapshot_worker(args[1])
    if args[:1] == ["--membership-worker"]:
        return membership_worker(int(args[1]), args[2], ("g0", "g1"))
    if args[:1] == ["--membership-restore-worker"]:
        return membership_worker(int(args[1]), args[2], ("g2",))
    if args == ["--remote-ps"]:
        return remote_ps_main()
    if args == ["--async-ps"]:
        return remote_ps_main("async")
    if args == ["--store-routes"]:
        return remote_ps_main("store")
    if args == ["--transport"]:
        return remote_ps_main("transport")
    if args == ["--membership"]:
        return remote_ps_main("membership")
    if args[:1] == ["--ps-routes"]:
        toolchain()
        return ps_routes(tuple(args[1:]) or ("int8", "fp8_e4m3"))
    if args == ["--ps-profile"]:
        return ps_profile()
    if args == ["--hybrid-check"]:
        return hybrid_check_main()
    if args:
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    with _phase("toolchain and build"):
        ptxas = toolchain()
    worst = dict.fromkeys(KERNELS, 0.0)
    worst.update({(k, f): 0.0 for k in FLASH_FORMS for f in FORMS})
    worst128 = dict(worst)
    ring_worst = {(v, d): 0.0 for v in VARIANT_NAMES.values() for d in WIDTHS}
    with _phase("kernel checks"):
        check_bert_kernels(worst)
        check_gpt2_kernels(worst)
        check_t5_kernels(worst)
        check_dh128_kernels(worst128)
        check_ring_forms(ring_worst)
        check_ring_schedule()
        check_long_kernels(worst)
        check_determinism()
        check_onebit(_adversarial(), "adversarial vector")
        check_quant()
        check_codec_views()
        check_fp8_edges()
    with _phase("kernel timing"):
        timing = time_attention(TRAIN_BATCH, BERT_SEQ, False,
                                ("flash_fwd", "flash_bwd_fused"))
        gpt2_timing = time_attention(TRAIN_BATCH, GPT2_SEQ, True,
                                     ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv"))
        timing["flash_bwd_dq"] = gpt2_timing.pop("flash_bwd_dq")
        timing["flash_bwd_dkv"] = gpt2_timing.pop("flash_bwd_dkv")
        time_floor()
        timing.update(time_onebit())
        timing.update(time_quant())
        form_timing = {
            ("rel", "encoder"): time_forms(TRAIN_BATCH, T5_SRC, False,
                                           "rel"),
            ("rel", "decoder"): time_forms(TRAIN_BATCH, T5_TGT - 1, True,
                                           "rel"),
            ("bias", "encoder"): time_forms(TRAIN_BATCH, T5_SRC, False,
                                            "bias")}
        # d 128: the forward and fused backward at the dh128 BERT shape, the
        # split backward past one block, the forms at T5's encoder geometry
        timing128 = time_attention(TRAIN_BATCH, BERT_SEQ, False,
                                   ("flash_fwd", "flash_bwd_fused"),
                                   DH128_HEADS, DH128)
        split128 = time_attention(TRAIN_BATCH, GPT2_SEQ, True,
                                  ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"), DH128_HEADS, DH128)
        timing128["flash_bwd_dq"] = split128.pop("flash_bwd_dq")
        timing128["flash_bwd_dkv"] = split128.pop("flash_bwd_dkv")
        form_timing128 = {
            (f, "encoder"): time_forms(TRAIN_BATCH, T5_SRC, False, f, DH128)
            for f in FORMS}
        long_timing = time_long_attention()
        ring_timing = {HEAD_DIM: time_ring_forms(),
                       DH128: time_ring_forms(DH128_HEADS, DH128)}
        host = {HEAD_DIM: time_host(), DH128: time_host(DH128_HEADS, DH128)}
    with _phase("bert_large dense paths"):
        bert_launches, bert_losses = train_bert()
        paths = {"bert_large": bert_launches}
        paths.update(train_bert_remat())
        paths.update({"bert_large_hybrid": train_bert_hybrid(),
                      "bert_large_dh128": train_bert_dh128()})
    with _phase("gpt2_medium dense and compressed paths"):
        paths["gpt2_medium_dense"] = train_gpt2_dense()
        check_head_gemm()
        paths["gpt2_medium_dense_fp32_head"] = train_gpt2_fp32_head()
        paths["gpt2_medium_onebit"] = train_gpt2_onebit()
        for name in GPT2_COMPRESSION:
            paths[f"gpt2_medium_{name}"] = train_gpt2_compressed(name)
    with _phase("t5 and sp paths"):
        paths.update({"t5_small": train_t5(),
                      "t5_small_hybrid": train_t5_hybrid(),
                      "bert_large_sp": train_bert_sp(),
                      "gpt2_medium_sp": train_gpt2_sp()})
        paths["gpt2_medium_sp_accum"] = train_gpt2_sp_accum(
            paths["gpt2_medium_onebit"])
    with _phase("gpt2_medium_32k"):
        paths["gpt2_medium_32k"], paths["gpt2_medium_32k_full_head"] = \
            train_gpt2_long()
    step2_misses = []
    cut_losses = _timed("bert_large dense cut", _dense_losses, CUT_LAYERS)
    paths["bert_large_ps_int8"], paths["bert_large_ps_int8_monolithic"] = \
        _timed("bert_large_ps_int8", train_bert_ps, "int8", bert_losses,
               step2_misses)
    paths["bert_large_ps_fp8_e4m3"], \
        paths["bert_large_ps_fp8_e4m3_monolithic"] = _timed(
            "bert_large_ps_fp8_e4m3 (cut)", train_bert_ps, "fp8_e4m3",
            cut_losses, step2_misses, CUT_LAYERS)
    paths["bert_large_ps_int8_accum2"] = _timed(
        "bert_large_ps_int8_accum2 (cut)", train_bert_ps_accum, cut_losses,
        CUT_LAYERS)
    paths["bert_large_ps_onebit"] = _timed(
        "bert_large_ps_onebit (cut)", train_bert_ps_onebit, cut_losses,
        CUT_LAYERS)
    paths["bert_large_ps_auto_live"], paths["bert_large_ps_auto_injected"] = \
        _timed("bert_large_ps_auto (cut)", train_bert_ps_auto, cut_losses)
    paths["bert_large_ps_watchdog"] = _timed(
        "bert_large_ps_watchdog (cut)", train_bert_ps_watchdog, cut_losses)
    _remote_phases(paths)
    _store_phases(paths)
    _transport_phases(paths)
    _membership_phases(paths)
    paths["bert_large_plugin"] = _timed("bert_large_plugin",
                                        train_bert_plugin, bert_losses)
    paths["bert_large_pushpull_int8"] = _timed(
        "bert_large_pushpull_int8", train_bert_pushpull, "int8", bert_losses,
        step2_misses)
    paths["bert_large_pushpull_fp8"] = _timed(
        "bert_large_pushpull_fp8 (cut)", train_bert_pushpull, "fp8_e4m3",
        cut_losses, step2_misses, CUT_LAYERS)
    if step2_misses:
        raise AssertionError(f"step-2 loss beyond {PS_STEP2_TOL} of the dense "
                             f"run's: {step2_misses}")
    log(f"phase seconds {json.dumps(PHASE_S)}")
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")

    card = card_line()
    kernels = []
    for name in KERNELS:
        if name not in FLASH:
            kernels.append(kernel_entry(name, paths, worst, timing, card,
                                        ptxas))
            continue
        # the d-64 figures at the top, as the kernel line has carried
        # them; the d-128 instantiation's, every key, under "d128"
        by_d = {}
        for d, w, tm, ft, other in (
                (HEAD_DIM, worst, timing, form_timing, gpt2_timing),
                (DH128, worst128, timing128, form_timing128, split128)):
            entry = kernel_entry(name, paths, w, tm, card, ptxas, d)
            entry["host_us"] = host[d][name]
            if name == "flash_fwd":
                entry["host_us_function"] = host[d]["flash_attention"]
            if d == HEAD_DIM and name in long_timing:   # GPT-2 at 32k
                entry[f"s{LONG_SEQ}"] = long_timing[name]
            if name == "flash_fwd":    # also timed past one block
                g = other["flash_fwd"]
                entry["gpt2" if d == HEAD_DIM else "s1024"] = {
                    k: g[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "timed_shape", "causal")}
            if name in FLASH_FORMS:    # the bias forms, at the T5 shapes
                entry["forms"] = {f: form_entry(name, f, paths, w, ft, d)
                                  for f in FORMS}
            for kname, var in VARIANTS:  # the ring's forms
                if kname == name:
                    entry[VARIANT_NAMES[var]] = variant_entry(
                        name, var, paths, ring_worst, ring_timing, d)
            by_d[d] = entry
        by_d[HEAD_DIM]["d128"] = by_d[DH128]
        kernels.append(by_d[HEAD_DIM])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
