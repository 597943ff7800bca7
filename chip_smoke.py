"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PART [ROOT]

from the root of a checkout. The second form times one part with the
package of the checkout at ROOT (default: this one; an unpacked ``git
archive`` of another commit, run in turns with this one, compares two
trees on one card) and prints one JSON line. PART is one of:

- ``moe-forward``: only phase 11's bf16 MoE full forward;
- ``fused-gelu``: phase 9's GELU kernels (forward and backward, with and
  without the bias, fp32 and bf16) at [8192, 6144] beside their bounds
  and library calls, then the fused bf16 flagship step profiled (GELU
  device time, busy share);
- ``paged-walks``: rows 1 and 13 (the ragged and mega attention kernels)
  at the table shapes and GPT-125M's decode round, rows 4 and 14
  (controls) at the table shapes, then the bf16 per-op and mega serving
  steps (wall and profiled device busy);
- ``mlp-gemms``: rows 14 and 9 (the mega MLP at a served round, a decode
  round and the dense block; the int8 weight-only GEMM's four serving
  GEMMs) beside the controls (rows 10, 11 and 13) and the tensor-core
  route's other K splits, then the bf16 mega and int8 per-op serving
  steps;
- ``moe-gemms``: rows 16 and 17 (the grouped GEMM with int8 and int4
  expert stacks at the serving rows, fp32 on both routes where the
  package has the skinny one) beside the controls (rows 9, 10, 13, 14 and
  15) and the skinny route's other K splits, then the bf16 int8 and int4
  g128 MoE serving steps;
- ``int4-decode``: rows 10 and 4 (the int4 g128 weight-only GEMM's four
  serving GEMMs at M 24 and 8; the paged decode kernel at the serving
  pools beside the ragged kernel at chunk 1) beside the controls (rows 1,
  9, 13 and 17), then the bf16 int4 g128 per-op and legacy serving steps
  of GPT-125M;
- ``flash``: rows 2 and 3 (the flash kernels) in bf16 without a mask at
  phase 4's, the training and the long shapes causal and BERT-base's [16,
  512, 12, 64] non-causal, and with BERT's key-padding mask where ROOT's
  package has the branch;
- ``ln-bwd``: row 6 (the LN backward) at phase 9's three LN shapes in
  fp32, bf16 and fp16, with and without dso, beside its bound and
  ``native_layer_norm_backward``; one call at the flagship shape profiled
  (its kernels); then the fused bf16 flagship step profiled (the LN
  backward's device time, kernels a step, busy share);
- ``qmm-dx``: rows 11 and 12 (the weight-only GEMM's dx, four serving
  GEMMs at M 8, 24 and 256, fp32 / bf16 / fp16, int8 per channel, int8
  g128, int4 g128) beside the controls rows 9 and 10 (the forwards at M
  24, with digests of their outputs), the dx route's split plans swept
  where ROOT's package has the route, then the dx kernels' device time in
  one profiled backward of the bf16 input-gradient drives;
- ``moe-dx``: row 19 (the grouped GEMM's dx with int8 expert stacks, w1 +
  w2 at the serving rows (a) and the prefill rows (b), fp32 / bf16 /
  fp16, per channel and g128) beside the controls row 16 (the int8
  forward at (a)) and rows 11 and 12 (the weight-only GEMM's dx at M 24),
  with digests of every output, the dx route's split plans swept where
  ROOT's package has the route, then the dx kernels' device time in one
  profiled backward of phase 11's bf16 input-gradient drives (int8
  stacks through both layers; fp stacks through layer 0);
- ``capture``: only phase 15 (every unified form served on the captured
  step with the async engine beside the eager step with the synchronous
  engine, then the bf16 per-op, mega and MoE timings in turns); ROOT's
  package must have the captured step;
- ``serve-steps``: the bf16 per-op, mega and MoE serving steps of
  GPT-125M on ROOT's package's defaults (and, where it has the captured
  step, on the eager step with the synchronous engine), timed in turns
  from the end of each run's first step, with a digest of the streams:
  run it for a parent and a change as parent, change, change, parent;
- ``spec``: only phase 16 (speculative decoding on the captured step and
  the async engine); ROOT's package must have speculation.
- ``moe-profile``: phase 11's three profiled bf16 MoE windows, 5 times
  each with and without the profiler's idle margin, each window's
  kernels by graph launch logged and a short window counted.
- ``resilience``: phase 17 (e): the bf16 per-op and mega serving steps
  of GPT-125M with the resilience and observability layers disarmed,
  timed in turns, then once each with a host recording window open where
  ROOT's package has the profiler: run it for a parent and a change as
  parent, change, change, parent.

Phases (each failure ends the run non-zero). Every kernel is built for
fp32, bf16 and fp16; the phases that hold kernels against their plain
versions and time them (3, 4, 7, 8, 9, 10, 11, 12 (a), 13 (d)) run each of
the three types where they say fp32 and bf16 (fp16 to ``KERNEL_TOL``'s
2e-3 per row), and phase 14 drives the fp16 paths:

1. device: the card's name and power limit;
2. build: the nine kernel sources from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), with ``ptxas -v``
   registers and spills (an ``ln_bwd_kernel``, ``qmm_dx_kernel`` or
   ``gmm_dx_kernel`` instance that spills fails the run);
3. ragged paged attention vs its plain version at the serving shapes
   (b 8, chunk 16, 12 heads, d 64, page 64, 16 pages per sequence),
   fp32 and bf16, with kernel / plain / bound times; then its split walk
   at GPT-125M's decode round (8 lanes of one row over 1,024 tokens) and
   gpt3-1.3b's 32 heads at 2,048-token contexts, fp and int8 KV, fp32 and
   bf16, timed; every case launched twice, the second result bitwise equal
   to the first;
4. flash attention forward vs its plain version at the full-forward
   shape [4, 512, 12, 64] causal, plus ``sq != sk`` and a ragged tail, fp32
   and bf16; the bf16 tensor-core kernel at head_dim 32 / 80 / 96 / 128
   (``FLASH_TC_CASES``: GQA, the causal offset, ragged tails, rows that see
   no key, non-causal) and at [1, 4096, 16, 128] causal; times with the
   achieved TFLOP/s and share of the bound beside plain and SDPA;
5. full forward: GPT-125M logits on ids [4, 512] with the flash kernel
   against the same model with plain attention;
6. serving: ``ServingPredictor`` on GPT-125M in fp32 (TF32 off), 8
   requests of 5-300 prompt tokens and 32 new tokens, two sharing a
   prefix past one page (one of them forcing a copy-on-write); every
   greedy token and the step's logits row behind it are checked against
   the full forward over the served context, the streams must hold at
   least ``MIN_DISTINCT`` distinct tokens, and every step must run the
   ragged kernel once per layer. Then the same requests in bf16, timed
   (median of ``BF16_RUNS`` runs after a warm-up);
7. train: the flash backward kernel vs its plain version at the training
   shape [8, 1024, 12, 128] causal and at odd shapes (``sq != sk``, GQA,
   ragged tails, non-causal), fp32 and bf16, the bf16 kernel at
   ``FLASH_TC_CASES`` and [1, 4096, 16, 128], with kernel / plain / bound
   times, TFLOP/s and SDPA's backward as the library yardstick, and the
   forward kernel vs its plain version at the training shape; the eager
   GPT-125M forward and backward with flash vs plain attention (every parameter
   gets the same gradient, none is ``None``); ``build_spmd_train_step`` in
   fp32 (TF32 off) at gpt3-760m's width and 2 layers, flash vs plain
   attention for the loss, every gradient leaf and 3 steps' losses; the
   same in bf16 at 12 heads of 128 and at 16 heads of 96 (2 layers, loss
   and every leaf, 2 + 2 flash launches); then the flagship training
   configuration (``bench.py``'s gpt3-760m: h 1536,
   24 layers, 12 heads, vocab 50304, batch 8, seq 1024, bf16, recompute
   with the flash outputs saved, num_micro 1, momentum SGD at lr 1e-4),
   timed: step ms, tokens/s and MFU, with 24 forward and 24 backward flash
   launches per step.
8. quantized serving (run between phases 6 and 7, while the GPT-125M
   model is on the card): the weight-only GEMM kernels (int8 per channel,
   int8 and int4 with groups of 128) forward and dx vs their plain
   versions at the four serving shapes [24, K] x [K, N] and an odd shape,
   fp32 and bf16, with kernel / plain / bound times, ``_weight_int8pack_mm``
   as the int8 yardstick where the card's torch has it, and cuBLAS on a
   pre-dequantized weight logged beside them; the int8 and int4 forwards
   and dx at the serving shapes must take the tensor-core routes in bf16
   and fp16 (one ``tc_launches`` of each wrapper a call, none in fp32 or
   at the odd shape), every forward and dx launched twice and bitwise
   equal, and the int8 and int4 four GEMMs are timed at a decode round (M
   8) too, their dx at M 8 and at 256 rows (beside the bound and cuBLAS
   on the pre-dequantized weight); every config's four GEMMs are held
   and timed at M 56, phase 16's verify budget; the ragged kernel's int8-KV
   branch vs its plain version; then ``ServingPredictor`` on GPT-125M with
   (a) int8 weights, (b) int4 weights in groups of 128, (c) int8 weights
   and an int8 KV cache, the phase-6 requests in fp32: every greedy token
   and its logits row against a plain quantized forward over the served
   context (the same quantized params through the plain GEMM; in (c) K
   and V through the int8 write's quantize-dequantize), 12 ragged and 48
   weight-only GEMM launches per step (fp32 on the CUDA-core kernel); the
   gradient of a loss with
   respect to the input embeddings through the 12 quantized layers (the
   backward kernels, fp32: the CUDA-core kernel) vs the plain versions;
   token agreement with phase 6, weight and KV bytes; the same gradient
   through bf16 weights (every one
   of its 48 dx on the tensor-core dx route, ``BF16_GRAD_TOL``); then (a),
   (b) and (c) served in bf16 in turns
   (every one of the 48 weight-only GEMMs a step on the tensor-core route,
   well-formed streams, the median wall and mean step of ``BF16_RUNS``
   runs after a warm-up) and one profiled run of (a) and of (b) (device busy a step and
   the weight-only GEMM's device time).
9. fused MLP (its steps run beside their phase-7 twins): the LN forward
   (with and without the residual), LN backward (with and without dso),
   GELU forward and backward (with and without the bias) kernels vs their
   plain versions at the flagship shapes LN [8192, 1536] and GELU
   [8192, 6144], GPT-125M's [2048, 768] / [2048, 3072] and an odd
   [77, 200], fp32 and bf16, with kernel / plain / bound times and
   ``F.layer_norm``, ``native_layer_norm_backward``, ``F.gelu`` and
   ``gelu_backward`` as the yardsticks of the variants they compute; the
   eager GPT-125M with ``fused_mlp`` on ids [4, 512] against the same
   weights unfused (logits and every gradient, fp32); the fp32 760M-width
   2-layer step with recompute, fused with and without ``remat_save_ln``
   against unfused (loss, every gradient leaf, 3 steps' losses); then the
   flagship bf16 step with ``fused_mlp=True``, timed beside phase 7's
   unfused step, with 96 LN forward, 48 LN backward, 48 GELU forward and
   24 GELU backward launches a step, and one profiled step (the LN and
   GELU kernels' device time apart). The GELU kernels also meet inputs in
   +-30 with +-1e4, +-inf and NaN in every row at the GPT-125M and odd
   shapes (NaN / +-inf at the plain version's places, the finite entries
   held as ``FUSED_TOL``), and every GELU and LN backward case is launched
   twice: the second result must be bitwise equal. The LN kernels are timed
   at the GPT-125M shape too; one LN backward call must be one CUDA kernel
   under ``torch.profiler`` and leave its arrival counters at zero, and
   phase 2 fails if any ``ln_bwd_kernel`` instance spills.

10. mega serving (run after phase 8, while GPT-125M is on the card): the
   mega attention and mega MLP kernels vs their plain versions at the
   serving shapes (8 lanes of chunk 16 with an idle lane, a first chunk
   and contexts to 1024 tokens, h 768, 12 heads of 64, page 64; MLP 128 x
   768 x 3072) and an odd shape (5 lanes of chunk 3, 4 heads, ffn 640,
   int8 in groups of 64), fp32 and bf16, fp / int8 per channel / int8 g128
   weights, fp / int8 KV, with and without the fused epilogue (int8
   payloads one step apart counted and held under 1%; the MLP dense and
   on the rows the lanes feed, each launched twice and bitwise equal), with
   kernel / plain / bound times and the one-layer per-op step on the same
   inputs; the MLP at ``MLP_ROUNDS`` (a served round of 24 live rows, a
   decode round of 8, the dense block; fp and int8 g128 weights) timed;
   then ``ServingPredictor(mega_decode=True)`` with the phase-6 requests
   in fp32: (i) fp weights against phase 6's streams and the full-forward
   oracle, (ii) int8 weights and (iii) int8 g128 weights with an int8 KV
   cache against their per-op streams and the plain quantized forward,
   12 launches of each mega kernel a step and none of the ragged kernel
   or the weight-only GEMM; bf16 step times of (i) and (iii) beside their
   per-op twins (median of ``BF16_RUNS`` runs each, in turns) and one
   profiled mega run of each. The split-walk kernel also at GPT-125M's
   decode round (timed) and at head dims 32 / 80 / 96 at gpt3-tiny's,
   gpt3-2.7b's and gpt3-760m's widths (fp, and int8 g64 weights with int8
   KV, the fused epilogue), every case launched twice and bitwise equal;
   then
   ``mega_decode=True`` serving at gpt3-760m's and gpt3-2.7b's widths (2
   layers, fp32): streams equal to the per-op streams and the full
   forward, 2 launches of each mega kernel a step. Before the training
   phases no call has run a plain twin (``.twin_routes`` 0).

11. MoE serving (run after phase 10): the five grouped-GEMM kernels
   (fp, int8 per channel, int8 and int4 in groups of 128; forward and dx)
   vs their plain versions at (a) the serving rows (48 over 4 experts, one
   empty; w1 768 x 3072, w2 3072 x 768), (b) the prefill rows (4,096,
   skewed, one empty) and (c) an odd shape (5 experts, K 136, N 72, groups
   of 8, an empty and a 1-row expert), fp32 and bf16, the empty experts'
   weights NaN; bf16 fp weights run the tensor-core kernel at all three
   (one ``tc_launches`` each for the forward and dx, none elsewhere), the
   int8 / int4 forwards at (a) the skinny route in bf16 (one
   ``sk_launches`` each, none in fp32, at (b) or at (c)), the int8 dx at
   (a) and (b) the dx route in bf16 (one ``dx_launches`` each, none in
   fp32 or at (c)), and a second
   launch at (a) and (b) must be bitwise equal to the first; kernel /
   plain / bound times at (a) and (b) with ``torch._grouped_mm``
   as the yardstick of bf16 fp weights (and, not a port path, on the
   pre-dequantized stack's transpose beside the int8 dx); bf16 fp
   weights at K 136, N 76
   (a width the 16-byte copies cannot take) on the CUDA-core kernel; then
   ``ServingPredictor`` on GPT-125M with 4 experts, top-2, and the phase-6
   requests in fp32: (i) capacity factor 4.0 against the full-forward
   oracle, (ii) 1.25 against the same step with the plain grouped GEMM
   (router flips of one step counted), (iii) int8 and (iv) int4 g128
   weights at 4.0 against the full forward over the dequantized weights;
   24 grouped-GEMM and 12 ragged launches a step (and 24 weight-only GEMM
   launches with (iii) / (iv)), none of the mega kernels; the router's
   load imbalance and drop rate on an eager probe; the bf16 MoE step at
   cf 1.25 (every grouped GEMM on the tensor-core kernel) beside phase 6's
   dense step, one profiled run; then (v) int8 and (vi) int4 g128 stacks
   served in bf16 at cf 1.25, every grouped GEMM on the skinny route (24
   a step): step 20 against the same step with the plain grouped GEMM
   (``MOE_BF16_STEP_TOL``, router flips counted), the 24 weight-only
   GEMMs a step (wqkv, wo) on the tensor-core route, the mean step and
   one profiled run each; and the weight bytes; the bf16 MoE
   full forward on ids [4, 512] at cf 1.25 (24 tensor-core launches a
   forward, median of ``BF16_RUNS`` after a warm-up, one profiled
   forward: the
   grouped GEMM's device time and share); the eager 2-layer MoE model's
   gradients, kernel vs plain (4 dx launches), an input gradient through
   both layers' int8 expert stacks in fp32 (4 dx on ``gmm_kernel``) and in
   bf16 on the fp32 drive's routing (4 on the dx route, ``BF16_GRAD_TOL``)
   and a bf16 one through layer 0's fp stacks (the tensor-core dx); last, the
   attention routing: a 2-layer gpt3-760m-width model (head_dim 96) in fp32 and
   an fp64 GPT-125M forward (no kernel takes fp64) equal to the plain path's
   logits with no flash launch, and one d 96 ``gpt_spmd`` training step; bf16 d
   64 attention calls non-causal, causal, with a key-padding mask and a bool
   mask (to the kernels), with a mask that does not stream and with dropout (to
   ``_sdpa_ref``, equal to it).

12. legacy serving (run after phase 11): (a) the paged decode kernel (the
   split walk) vs its plain version and vs the ragged kernel at chunk 1 on
   the same pools, at phase 3's serving pools (8 slots, 12 heads of 64,
   page 64, lengths 0, 1, 64, 65 and up to 1,024, -1 entries past each
   context) and at GQA 16/2 and 12/4, MQA 8/1, pages 16 and 8, head dims
   32 / 64 / 80 / 96 / 128, fp32 and bf16, each launched twice and bitwise
   equal, with kernel / plain / bound / ragged-at-chunk-1 times at the
   serving pools; (b)
   the ragged kernel vs its plain version at head dims 32 / 80 / 96 with
   fp and int8 KV; (c) ``ServingPredictor(unified=False)`` on GPT-125M
   with the phase-6 requests in fp32: (i) fp weights against the
   full-forward oracle and phase 6's unified streams, (ii) int8 weights
   against the plain quantized forward and phase 8 (a)'s streams, 12
   decode-kernel launches a decode step and none of the ragged kernel (48
   weight-only GEMM launches a program run in (ii)); bf16 legacy and
   unified runs in turns (medians of 5: the generate wall and the mean
   step) and one profiled legacy run; (d) gpt3-760m's width at 2 layers
   (16 heads of 96) served fp32 through the per-op unified step and the
   legacy path, both against the full forward.

13. BERT (run after phase 9): ``BERT_CONFIGS["bert-base"]`` at full depth
   (12 layers, h 768, 12 heads of 64, vocab 30522), random weights from
   numpy seed 0 in bf16, dropout 0, batch 16 at seq 512 with per-sequence
   lengths from the seed in 64-512 (one of 512) and the 1/0
   ``attention_mask`` built from them: (a) the MLM + NSP loss's gradients
   through the masked flash kernels held per leaf against the same step
   with attention pinned to ``_sdpa_ref``, then momentum SGD (0.9, lr
   1e-4, as ``bench.py``), one warm-up and three timed steps with 12
   masked forward and 12 masked backward launches a step, and one profiled
   step; (b) ``BertForSequenceClassification``'s logits on the same batch
   in fp32 and bf16 against the plain route; (c) ``flash_attn_unpadded``
   at BERT-base widths on the same lengths packed, causal and not, forward
   and backward, against its segment-masked plain version; (d) each
   branch alone against its plain version, fp32 and bf16, at [16, 512,
   12, 64]: masks [b, 1, 1, s], [b, hq, s, s], [1, 1, s, s] and a bool
   mask, causal and not, and lengths with a 0 and q_len != kv_len (alone
   and with the key-padding mask), with kernel / plain / bound times of
   the key-padding mask and of the batch's lengths beside
   ``F.scaled_dot_product_attention(attn_mask=)``.

14. fp16 (run after phase 9, before the training phases): every path in
   fp16 on the fp16 kernels with ``ops.twin_routes()`` 0 and launches of
   each kernel row, each held against the same path on the twins (every
   family's ``kernel_takes`` answering no; ``twins()``): (a) GPT-125M
   served per-op, with int4 g128 weights, with int8 weights and an int8
   KV cache, on the mega step and on the legacy path, and the MoE
   GPT-125M (4 experts, top-2, cf 4.0) with fp, int8 and int4 g128 expert
   stacks: greedy streams and logits rows against the twin route's
   (``F16_STEP_TOL``, near ties, router flips counted); the fp16 full
   forward on ids [4, 512] against plain attention; (b) the fused LN +
   residual and bias + GELU forward against the fp16 twins, then the
   ``gpt_spmd`` step at gpt3-760m's width (16 heads of 96), 2 layers, b 2,
   s 1024, unfused and ``fused_mlp``, no loss scaling: loss and gradients
   against the plain route and the exact fp32 gradients, 4 SGD steps with
   finite falling losses; (c) BERT at bert-base width, 2 layers, the
   padded batch of phase 13, gradients through the masked kernels the
   same way, and ``flash_attn_unpadded`` on its lengths; (d) input
   gradients through 12 int8 / int4 g128 layers and through a MoE FFN
   with fp / int8 expert stacks. Each kernel row of the JSON line gains
   an ``fp16`` record: route, fp16 launches, time, plain, bound, library
   and error, and the bf16 leg's time beside it.
15. captured step and async engine (run after phase 11): every unified
   form — per-op fp32 / bf16 / fp16, int8 and int4 g128 weights with an
   int8 KV cache, mega and MoE (4 experts, top-2, cf 1.25), all but the
   first two in bf16 — served with the predictor's defaults (one CUDA
   graph per step geometry, replayed every round; the async
   dispatch-ahead engine) beside the synchronous engine on the eager step
   (``EagerStep``), the phase-6 requests in ``CAPTURE_PAGES`` pages (two
   preemptions, one copy-on-write copy): streams equal token for token,
   ``decode_trace_count`` 1, every step's launches counted once (ragged =
   steps x 12 on the per-op forms, mega 12 + 12, grouped GEMM 24, the
   weight-only GEMM 48), ``ops.twin_routes()`` 0, and what one replay
   launches. Then the bf16 per-op, mega and MoE runs timed in turns
   (``CAPTURE_RUNS`` each way, from the end of the first step, which
   holds the capture): mean step, tokens/s, ``step_gap_frac``,
   ``host_ms_per_step``, and one profiled run of each engine (device busy
   and idle share; the launches of each kernel group the trace holds
   must be the window's steps times what a step launches). The kernel
   rows run inside the captured step gain ``captured_replay``: launches
   one replay holds, by form.
16. speculative decoding (run after phase 15): GPT-125M at max_batch 8,
   page 64, chunk 16 over phase 6's requests with every prompt tiled from
   a 4-token motif, on the captured step and the async engine. Per form
   (per-op fp32 and bf16, mega bf16, int8 and int4 g128 weights with an
   int8 KV cache in bf16) spec off, then in turns ``SPEC_RUNS`` timed
   runs each of spec off and its spec runs: n-gram drafts at k 1 / 2 / 4
   (per-op), k 4 (mega, quantized), and the model self-draft of its first
   3 layers at k 4 (per-op, and on the mega chain). Every stream is held
   token for token to the plain forward of the served params, a token
   other than its argmax allowed only at a near tie (the fp32 forms'
   ``TIE_MARGIN``; the others twice the spec-off run's largest logits
   error against that forward); every n-gram run must accept drafts, and
   the self-draft's drafts must be the greedy tokens of the plain forward
   of its 3-layer params (the first layers of random weights need not
   agree with the whole stack); after a run the pool and the prefix
   registry equal spec off's (rejected drafts' pages went back); the verify step and each draft program captured
   once; no twin route; per form one more n-gram k 4 run in which the
   verify step runs eagerly on the kernels and on the twins at the inputs
   of each call with more drafts than any before, every verify row's
   logits and token held (a token off only at a near tie); four profiled
   windows' launches equal the counters'. Logged per run: the mean step and
   tokens/s (medians from the end of the first step),
   ``accepted_tokens_per_step``, ``draft_acceptance_rate``,
   ``draft_overhead_frac``, hard syncs and captures. The rows of the
   ragged kernel, the int8 and int4 weight-only GEMMs and the mega
   kernels count the phase's launches (``spec_launches``).
17. the resilience and observability layers (run after phase 16):
   GPT-125M bf16 over phase 6's requests on the captured step and the
   async engine. (a) per-op and mega bf16, and per-op fp32, under a
   seeded ``FaultPlan`` with the dispatch, reconcile, h2d, slow_step and
   pool-squeeze seams armed (``RES_PLAN``, a pool of ``RES_PAGES``
   pages): every request ends with the fault-free run's tokens or FAILED
   with a named code (in bf16 a replayed stream may leave them only at a
   near tie of its own plain forward: the replay's chunked recompute of
   its context rounds otherwise than the decode steps did), the drained
   pool (available pages, free slots, references, withheld pages) and
   the captures equal the fault-free run's, launches are steps x 12 and
   every raised fault is counted; a bf16 control with no seam armed
   preempts every running lane twice (``RES_PREEMPT_AT``), holds its
   streams the same way and reports which departed, replayed or not; (b) int4 g128 weights with
   ``SLOConfig(max_waiting=6)``: a burst of 12 (6 shed, 3 past their
   deadlines, two queued and one running), ``healthz()`` and the counters
   match; (c) bf16 and int8 weights + int8 KV through a host tier under
   a ``TIER_PAGES`` pool, phase 6's prompts twice, under the drop and
   corruption seams: spills, restores, detected corruption, the pools
   unmoved, one capture, a chain evicted through the tier back bitwise,
   the spills' stream waits logged; (d) one ``Profiler`` window (GPU
   target): the exported trace's spans, matched request lanes, counter
   track and device kernels, the kernels by group equal to the counters;
   (e) the disarmed per-op and mega steps (``RES_RUNS`` runs each in
   turns) and once with a host recording window open: mean step and
   ``host_ms_per_step``. The rows of the ragged kernel, the int8 and
   int4 weight-only GEMMs and the mega kernels count the phase's
   launches (``resilience_launches``).

Every serving phase runs the predictor's defaults, so phases 6, 8, 10, 11
and 14 serve on the captured step and the async engine too. Their bf16
times, like phase 15's, run from the end of each run's first step (which
holds the capture) to the end of its flush (``timed_serve``), and every
profiled serving run (``profile_serve``) covers the same window and fails
unless the launches the trace holds in each kernel group equal what the
wrappers' counters gained over it (a replay adds its capture's launches
to the counters). ``serve()`` flushes the ring, and ``StepRecord`` runs a
call eagerly where it records the router's choices.

Kernel times are device times: the calls are captured in a CUDA graph and
the graph is replayed between CUDA events.

Weights are random, drawn from a numpy seed. The last three lines are the
per-kernel JSON summary, the ``nvidia-smi`` card line and ``{"ok": true,
"device": ...}``. Without a
CUDA device, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import copy
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12,     # fp32 outside the tensor cores
            torch.bfloat16: 989e12,   # dense bf16 tensor cores
            torch.float16: 989e12}    # dense fp16 tensor cores
# every kernel family is built for these activation types (phases that
# hold kernels against their plain versions run each)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
RAGGED_GEOM = dict(b=8, chunk=16, hq=12, hkv=12, d=64, ps=64, pps=16)
FLASH_SHAPE = (4, 512, 12, 64)
# phases 4 and 7: the bf16 tensor-core kernels at every head dim of the
# reference's configs, (b, sq, sk, hq, hkv, d, causal): d 32 with sq < sk
# (causal offset) and GQA 3, d 80 with a ragged tail, gpt3-760m's 16 heads
# of 96, rows that see no key (sq > sk causal), d 128 with GQA 8 and ragged
# tails, non-causal with sq > sk; then a long sequence, [b, s, heads, d]
FLASH_TC_CASES = ((2, 200, 456, 12, 4, 32, True),
                  (2, 333, 333, 8, 8, 80, True),
                  (2, 1024, 1024, 16, 16, 96, True),
                  (1, 300, 100, 6, 2, 96, True),
                  (2, 515, 515, 16, 2, 128, True),
                  (2, 130, 77, 4, 4, 80, False))
FLASH_LONG = (1, 4096, 16, 128)
# fp32: another summation order and expf, held as max abs error. bf16: both
# sides round an fp32 result to 8 mantissa bits once, so an element may
# differ by one bf16 step (<= 2^-7 of it); held as each row's max abs error
# over the row's max |value|, so a row of small values is held to its scale.
# fp16 the same way: 10 mantissa bits, one step <= 2^-10 (4.9e-4 unit
# roundoff), so 2e-3 admits about two steps (the flash forward also rounds
# each key tile's p to fp16, where the plain version keeps fp32) and is
# tighter than bf16's one step.
F16_TOL = 2e-3
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2,
              torch.float16: F16_TOL}
LOGIT_TOL = 1e-3      # fp32 logits after 12 layers, flash vs plain
TIE_MARGIN = 1e-4     # greedy mismatches allowed only below this margin
MAX_NEW = 32
# served fp32 streams must vary: at least this many distinct tokens among
# the 256 (8 constant streams give at most 8), and no constant stream
MIN_DISTINCT = 32
BF16_RUNS = 3
# phase 7. The flagship training configuration (bench.py's gpt3-760m leg)
TRAIN = dict(vocab_size=50304, hidden_size=1536, num_layers=24, num_heads=12,
             max_seq_len=1024, recompute=True, remat_save_attn=True)
TRAIN_BATCH, TRAIN_STEPS = 8, 4          # one warm-up step, three timed
BWD_SHAPE = (8, 1024, 12, 128)           # its attention: [b, s, heads, d]
# backward kernel vs plain: fp32 held as max abs error over the tensor's
# max |value| (atomics and another summation order; seen <= 1.2e-6). bf16
# per row as in KERNEL_TOL: dq, dk, dv each round an fp32 sum to bf16 once,
# so a row may differ by one bf16 step of its max (<= 2^-7, seen 7.7e-3);
# 1e-2 admits one step and not two
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
           torch.float16: F16_TOL}
# a gradient row that is zero in exact arithmetic (the dq of a query that
# sees one key) holds fp32 noise on both sides: held over the tensor's max
# |value|. bf16's 16-bit products mostly sum exactly in fp32; fp16's 22-bit
# products are rounded by the fp32 sums of dp and delta, which leaves more
# noise (seen 1.7e-5 in the card tests): 1e-4 in fp16
ZERO_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5,
                torch.float16: 1e-4}
# flash vs plain attention through whole models in fp32: per gradient leaf,
# max abs error over the leaf's max |value| (seen <= 1.8e-6); losses
# relative (seen 0)
GRAD_TOL = 1e-5
LOSS_TOL = 1e-6
# flash vs plain attention through the bf16 training step (2 layers, b 2,
# s 1024): the kernels round P and dS to bf16 per tile, the plain path its
# scores, probabilities and products where cuBLAS and softmax return them,
# and every gradient leaf is rounded to bf16 (one step <= 2^-7 of it): per
# leaf, max abs error over the leaf's max |grad|; the loss relative
BF16_GRAD_TOL = 2e-2
BF16_LOSS_TOL = 1e-2
# phase 8. The weight-only GEMM splits its fp32 sums across blocks in
# another order than cuBLAS: fp32 held as max abs error over the tensor's
# max |value| (as BWD_TOL); bf16 per row as in KERNEL_TOL (both sides
# dequantize with the same rounding, then round one fp32 sum).
QMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
           torch.float16: F16_TOL}
QMM_SHAPES = {"wqkv": (768, 2304), "wo": (768, 768), "w1": (768, 3072),
              "w2": (3072, 768)}          # GPT-125M's [K, N] projections
QMM_ROWS = 24                             # the serving token budget
QMM_DECODE_ROWS = 8                       # a decode round of 8 lanes
QMM_SPEC_ROWS = 56                        # the spec budget: 8 (1 + 4) + 16
QMM_DX_ROWS = 256                         # the input-gradient drives' rows
QMM_CONFIGS = (("int8", -1), ("int8", 128), ("int4", 128))
# (label, config fields, logits tolerance). Served logits vs the plain
# quantized forward in fp32: the GEMMs sum in another order (seen 4.3e-6);
# with int8 KV the step quantizes K and V computed by the kernel and the
# oracle those computed by the plain GEMM, so an entry at a rounding
# boundary may land one int8 step (1/127 of its row's absmax) apart, and
# a few such entries move the logits by more (seen 4.5e-3)
# phase 9. The fused LN / GELU kernels vs their plain versions: fp32 held
# as max abs error over the tensor's max |value| (another summation order,
# rsqrtf / tanhf), bf16 per row as in KERNEL_TOL (one rounding of an fp32
# result each side); the fp32 parameter sums as fp32.
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
             torch.float16: F16_TOL}
FUSED_LN_SHAPES = ((8192, 1536), (2048, 768), (77, 200))   # flagship,
FUSED_GELU_SHAPES = ((8192, 6144), (2048, 3072), (77, 200))  # 125M, odd
# the GELU kernels' extreme inputs, in every row beside values in +-30:
# NaN, +inf and -inf must land where the plain version puts them
GELU_SPECIAL = (1e4, -1e4, float("inf"), float("-inf"), float("nan"))
# operations an element: LN forward 8 (+1 with the residual), backward 14
# (+1 with dso), GELU forward 20 and backward 32, a tanh counted as 10;
# all fp32 on the CUDA cores (PEAK_OPS[float32]), whatever the input type
FUSED_OPS = {"ln_fwd": 8, "ln_bwd": 14, "gelu_fwd": 20, "gelu_bwd": 32}
# fused vs unfused fp32 training: the fused LN takes its variance by the
# two-pass formula, the unfused by torch.var, so activations differ in the
# last bits and three SGD steps carry that into the losses
FUSED_LOSS_TOL = 1e-5
# phase 10. The mega kernels keep every rounding of their plain versions
# and sum in another order (heads and ffn tiles in a fixed order, not
# cuBLAS's): fp32 held as max abs error over the tensor's max |value|, bf16
# per row as in KERNEL_TOL, on the rows each lane feeds. An int8 K / V
# payload may land one step apart where its fp32 row sits on a rounding
# boundary (allowed in under MEGA_FLIP_FRAC of the entries); what attends
# it then moves, and the fp32 outputs are held to MEGA_KV_TOL instead.
MEGA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
            torch.float16: F16_TOL}
MEGA_KV_TOL = 1e-3
MEGA_FLIP_FRAC = 0.01
# (b, chunk, h, heads, head_dim, page, pages a lane, ffn), q_lens, and the
# contexts already in the pool: an idle lane, a first full chunk (ctx 0), a
# full chunk on a context, decode rows and ragged chunks up to 1024 tokens
MEGA_SERVING = ((8, 16, 768, 12, 64, 64, 16, 3072),
                [0, 1, 16, 7, 1, 16, 12, 1],
                [0, 1008, 984, 326, 63, 0, 688, 516])
MEGA_ODD = ((5, 3, 256, 4, 64, 16, 4, 640), [0, 3, 2, 1, 3],
            [0, 0, 37, 50, 12])
MEGA_WEIGHTS = ((None, -1), ("int8", -1), ("int8", 128))
# the mega MLP's rows at GPT-125M's [8 lanes x chunk 16, 768] block: a
# served round (24 live rows: one prefill chunk, a two-token chunk, decode
# rows), a decode round (8 live rows) and the dense block (no q_lens, every
# row); the kernel computes the live rows and writes zeros in the rest
MLP_ROUNDS = {"served round": [16, 2, 1, 1, 1, 1, 1, 1],
              "decode round": [1] * 8, "dense": None}
MEGA_SERVE = (("i fp", {}, None),
              ("ii int8", dict(weight_dtype="int8"), 1e-4),
              ("iii int8 g128 + int8 KV",
               dict(weight_dtype="int8", weight_quant_group_size=128,
                    kv_cache_dtype="int8"), 2e-2))
# phase 11. MoE serving: GPT-125M with 4 experts, top-2 (the reference's
# bench_serving_moe_ab). The grouped GEMM is the weight-only GEMM per
# expert (the same tiles, dequantization and split sums): held as QMM_TOL;
# on the tensor cores (bf16 fp weights) the bf16 products are exact in
# fp32 and summed in another order, and each side rounds one fp32 sum per
# element: held per row as QMM_TOL[bf16].
MOE = dict(moe_experts=4, moe_top_k=2)
GMM_TOL = QMM_TOL
GMM_SHAPES = {"w1": (768, 3072), "w2": (3072, 768)}   # an expert's [K, N]
GMM_ROWS = [30, 0, 11, 7]          # (a) 24 tokens x top-2, one expert empty
GMM_PREFILL = [2400, 0, 900, 796]  # (b) 2 x 4 x 512 rows, skewed
GMM_ODD = (136, 72, [5, 0, 1, 9, 3], 8)   # (c) K, N, rows, scale group
# bf16 fp weights at widths the tensor-core kernel's 16-byte copies cannot
# take (N not a multiple of 8): the CUDA-core kernel, with (c)'s rows
GMM_OFF_COPIES = (136, 76)
# the bf16 MoE full forward: GPTForCausalLM on ids [4, 512] (2,048 tokens
# x top-2 = 4,096 rows through each layer's two grouped GEMMs), cf 1.25
MOE_FWD_IDS = (4, 512)
GMM_WEIGHTS = (("fp", None, -1), ("int8", "int8", -1),
               ("int8 g128", "int8", 128), ("int4 g128", "int4", 128))
# (label, capacity factor, quantization): cf 4.0 drops nothing, so the
# full forward is an exact oracle; 1.25 is the reference's production
# setting, held against the same step with the plain grouped GEMM
MOE_SERVE = (("i cf 4.0", 4.0, {}), ("ii cf 1.25", 1.25, {}),
             ("iii int8 cf 4.0", 4.0, dict(weight_dtype="int8")),
             ("iv int4 g128 cf 4.0", 4.0,
              dict(weight_dtype="int4", weight_quant_group_size=128)))
# bf16 MoE serving with int8 / int4 g128 expert stacks at cf 1.25 (every
# grouped GEMM on the skinny route), held at one step against the same step
# with the plain grouped GEMM: both round each expert output to bf16, the
# kernel after summing in another order, so an output may sit one bf16 step
# (2^-8 of it) apart and 12 layers carry that into the logits. Each emitting
# lane's logits row is held as its max abs error over its max |logit| to
# MOE_BF16_STEP_TOL, the lanes whose tokens took other experts in some
# layer left out (counted); the greedy token must be the twin's argmax
# unless the twin's top-2 margin is within twice that row's error. Then
# MOE_QUANT_RUNS timed runs (the checked and the twin runs before them warm
# up) and one profiled run.
MOE_SERVE_BF16 = (("v int8 cf 1.25", dict(weight_dtype="int8")),
                  ("vi int4 g128 cf 1.25",
                   dict(weight_dtype="int4", weight_quant_group_size=128)))
MOE_BF16_STEP_TOL = 5e-2
MOE_QUANT_RUNS = 1
QUANT_SERVE = (("a int8", dict(weight_dtype="int8"), 1e-4),
               ("b int4 g128", dict(weight_dtype="int4",
                                    weight_quant_group_size=128), 1e-4),
               ("c int8 + int8 KV", dict(weight_dtype="int8",
                                         kv_cache_dtype="int8"), 2e-2))
# phase 12. The paged decode kernel (row 4) and the legacy two-program path.
# ((b, hq, hkv, d, page, pages a slot), the slots' lengths): phase 3's
# serving pools with an empty slot, one token, one page, one past it and
# 1,024 tokens; then GQA 16/2 and 12/4 and MQA 8/1 at page 16, across the
# head dims the reference's configs use. Held as KERNEL_TOL, against the
# plain version and against the ragged kernel at chunk 1 (another kernel
# summing in another order: the same tolerance)
DECODE_SERVING = ((8, 12, 12, 64, 64, 16), [0, 1, 64, 65, 1024, 1000, 700,
                                            517])
DECODE_ODD = (((5, 16, 2, 128, 16, 9), [0, 1, 16, 17, 144]),
              ((5, 12, 4, 96, 16, 9), [0, 1, 16, 17, 140]),
              ((4, 8, 1, 80, 16, 9), [0, 1, 33, 144]),
              ((4, 4, 4, 32, 16, 9), [0, 7, 16, 130]),
              ((6, 12, 4, 64, 8, 12), [0, 1, 8, 9, 96, 50]))
# the ragged kernel at gpt3-tiny's, gpt3-2.7b's and gpt3-760m's head dims:
# phase 3's lanes with gpt3-760m's 16 heads
RAGGED_DIMS = (32, 80, 96)
# served through both paths at d 96: gpt3-760m's width at 2 layers
LEGACY_D96_LAYERS = 2
# phase 14. The fp16 paths on the fp16 kernels, each held against the same
# path on the twins (every family's plain version, on the card). Served
# logits rows, kernel vs twin route: max abs error over the row's max
# |logit|, to F16_STEP_TOL (fp16 rounds every activation to 2^-11 at other
# places on the two routes through 12 layers: bf16's MOE_BF16_STEP_TOL
# scaled by fp16's 8x finer step); a greedy token may differ only at a
# near tie (the twin's top-2 margin within twice that row's error), and a
# stream is compared up to there. The full forward's logits, flash vs
# plain attention, likewise.
F16_STEP_TOL = 1e-2
# (label, config fields, predictor options) served in fp16: the per-op
# step, int4 g128 weights, int8 weights with an int8 KV cache, the mega
# step and the legacy two-program path
F16_SERVE = (("fp16 per-op", {}, {}),
             ("fp16 int4 g128", dict(weight_dtype="int4",
                                     weight_quant_group_size=128), {}),
             ("fp16 int8 + int8 KV", dict(weight_dtype="int8",
                                          kv_cache_dtype="int8"), {}),
             ("fp16 mega", {}, dict(mega_decode=True)),
             ("fp16 legacy", {}, dict(unified=False)))
# the MoE GPT-125M (4 experts, top-2, cf 4.0) served in fp16 with fp, int8
# and int4 g128 expert stacks
F16_MOE = (("fp16 MoE fp", {}),
           ("fp16 MoE int8", dict(weight_dtype="int8")),
           ("fp16 MoE int4 g128", dict(weight_dtype="int4",
                                       weight_quant_group_size=128)))
# fp16 training (gpt_spmd at gpt3-760m's width, 2 layers) and BERT (2
# layers at bert-base width), no loss scaling: the loss relative to the
# plain route's; per gradient leaf, kernel vs plain route over the leaf's
# max |grad| to F16_GRAD_TOL (a few fp16 steps: the kernels round P and dS
# to fp16 per tile, the plain route where cuBLAS and softmax return them);
# a leaf past it (an fp16 gradient near its underflow: the loss is not
# scaled) is held by its distance from the exact fp32 gradients of the
# same weights, the kernel route's worst within BERT_NOISE_MARGIN x the
# plain route's; every leaf within F16_GRAD_CAP of exact unless the plain
# route's leaf is as far (BERT's MLM-head LN read 0.11 of its max from
# exact on both routes: its gradient underflows in fp16)
F16_LOSS_TOL = 5e-3
F16_GRAD_TOL = 1e-2
F16_GRAD_CAP = 5e-2
F16_TRAIN_STEPS = 4
F16_BERT_LAYERS = 2
# (d) input gradients through frozen layers, kernel vs plain, over the
# gradient's max: a few fp16 steps through 12 layers (bf16's drives are
# held to BF16_GRAD_TOL; fp16's step is 8x finer)
F16_DRIVE_TOL = 5e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# wall seconds by phase, summed over its calls (main logs them at the end)
PHASE_S: dict = {}


def timed(fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds added to ``PHASE_S`` under
    its name."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_S[fn.__name__] = (PHASE_S.get(fn.__name__, 0.0)
                                + time.perf_counter() - t0)


def time_ms(fn, iters=50, replays=4) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's launch cost is not in the figure (warm L2, as inside a serving
    step)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def kernel_error(got, want, dtype):
    """(max abs error, the error held against ``KERNEL_TOL[dtype]``): the
    max abs error in fp32; in bf16 the largest over rows (the last axis) of
    the row's max abs error over its max |want|."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if dtype == torch.float32:
        return err, err
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    return err, (diff.amax(-1) / scale).max().item()


def bound_ms(nbytes: float, ops: float, dtype) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])


def ptxas_summary(name: str, text: str):
    """One line per compiled instantiation (kernel, element type, its other
    template values: weight or KV type, head_dim, flags) with its
    registers and spills, from the ``ptxas -v`` report."""
    types = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}
    ty = "(13__nv_bfloat16|6__half|f)"
    inst, spills = None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '.*?\d([a-z_]+_kernel)I" + ty
                      + r"((?:L[ib]\d+E|S\d*_|[ah])*)", line)
        if m:
            args = re.findall(r"L[ib](\d+)E|(S\d*_)|([ah])", m.group(3))
            inst = (m.group(1), types[m.group(2)], ", ".join(
                n or ("T" if sub else {"a": "int8", "h": "int4"}[w])
                for n, sub, w in args) or "-")
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line and inst:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            yield (f"{name} {inst[0]}<{inst[1]}, {inst[2]}>: {regs} "
                   f"registers, {spills}")
            inst = None


# -- phase 3 ----------------------------------------------------------------


def ragged_inputs(dtype, dev, g=RAGGED_GEOM):
    b, chunk, hq, hkv, d, ps, pps = (g[k] for k in
                                     ("b", "chunk", "hq", "hkv", "d", "ps",
                                      "pps"))
    rng = np.random.RandomState(SEED)
    num_pages = b * pps + 1
    q = rng.standard_normal((b, chunk, hq, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    q_lens = np.array([0, 1, 16, 7, 1, 16, 12, 1], np.int32)
    kv_lens = np.array([0, 1024, 1000, 333, 64, 16, 700, 517], np.int32)
    for i in range(b):                 # unallocated past each context
        pt[i, (kv_lens[i] + ps - 1) // ps:] = -1
    to = lambda a, t: torch.from_numpy(a).to(dev, t)  # noqa: E731
    return (to(q, dtype), to(kp, dtype), to(vp, dtype), to(pt, torch.int32),
            to(kv_lens, torch.int32), to(q_lens, torch.int32))


def ragged_work(args):
    """(bytes, ops) the function needs on these inputs: the valid q rows
    read, every output row written (rows past q_len as zeros), the K and V
    rows of each lane that has queries read once, the page-table entries
    that cover those contexts and both length vectors read; 2 x 2 x d ops
    per (valid row, visible key)."""
    q, k_pages, _, _, kv_lens, q_lens = args
    b, chunk, hq, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    elt = q.element_size()
    # int8 pools: one byte a value and one fp32 scale a (row, head)
    kv_row_bytes = hkv * (d * k_pages.element_size()
                          + (4 if k_pages.dtype == torch.int8 else 0))
    lanes = [(kv, ql) for kv, ql in zip(kv_lens.tolist(), q_lens.tolist())
             if ql > 0]
    kv_rows = sum(kv for kv, _ in lanes)
    pages = sum(-(-kv // ps) for kv, _ in lanes)
    nbytes = ((sum(ql for _, ql in lanes) + b * chunk) * hq * d * elt
              + 2 * kv_rows * kv_row_bytes + 4 * (pages + 2 * b))
    pairs = sum(min(kv - ql + i + 1, kv) for kv, ql in lanes
                for i in range(ql))
    return nbytes, 4.0 * d * pairs * hq


def phase_ragged(dev):
    from paddle_tpu_torch.ops.paged_attention import (
        ragged_paged_attention as kern,
        ragged_paged_attention_reference as plain)

    stats = {}
    for dtype in DTYPES:
        args = ragged_inputs(dtype, dev)
        got = kern(*args)
        again = kern(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"ragged kernel {dtype}: a second launch "
                                 "differs from the first")
        want = plain(*args)
        q_lens = args[5]
        valid = (torch.arange(got.shape[1], device=dev)[None]
                 < q_lens[:, None])
        err, held = kernel_error(got[valid], want[valid], dtype)
        if not held <= KERNEL_TOL[dtype]:
            raise AssertionError(f"ragged kernel {dtype}: error {held} > "
                                 f"{KERNEL_TOL[dtype]} (max abs {err})")
        if torch.count_nonzero(got[~valid]).item():
            raise AssertionError("ragged kernel: rows past q_len not zero")
        nbytes, nops = ragged_work(args)
        s = dict(max_abs_err=err, ms=time_ms(lambda: kern(*args)),
                 plain_ms=time_ms(lambda: plain(*args), iters=5),
                 bound_ms=bound_ms(nbytes, nops, dtype), library_ms=None,
                 bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                 >= nops / PEAK_OPS[dtype] else "operations")
        stats[dtype] = s
        log(f"[ragged] {str(dtype)[6:]}: max_abs_err {err:.3e}, held "
            f"{held:.3e} (tol {KERNEL_TOL[dtype]}) kernel {s['ms']:.4f} ms, plain "
            f"{s['plain_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
            f"({s['bound_by']}: {nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} "
            "GFLOP), library_ms null (no single PyTorch call reads a paged "
            "pool)")
    return stats


# -- phase 4 ----------------------------------------------------------------


def flash_work(b, sq, sk, hq, hkv, d, causal, elt):
    pairs = sum(min(max(r + sk - sq + 1, 0), sk) for r in range(sq)) \
        if causal else sq * sk
    nbytes = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * elt \
        + 4 * b * hq * sq
    return nbytes, 4.0 * d * pairs * b * hq


def flash_rate(ms, nbytes, nops, dtype) -> str:
    """Achieved TFLOP/s of a call of ``ms`` and the share of the bound it
    reaches."""
    return (f"{nops / ms / 1e9:.1f} TFLOP/s, "
            f"{bound_ms(nbytes, nops, dtype) / ms:.3f} of the bound")


def flash_inputs(shape, dtype, dev, seed):
    """q, k, v of one ``(b, sq, sk, hq, hkv, d, causal)`` case, drawn from
    a numpy seed."""
    b, sq, sk, hq, hkv, d, _ = shape
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev, dtype) for s in
        ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))


def check_flash_fwd(args, shape, dtype, tag):
    """The forward kernel vs its plain version on one case: out held as
    ``KERNEL_TOL``, lse to 1e-3. Returns the max abs error of out."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_fwd as kern, flash_attention_reference as plain)

    b, sq, sk, hq, hkv, d, causal = shape
    out, lse = kern(*args, causal=causal)
    torch.cuda.synchronize()
    want, want_lse = plain(*args, causal=causal)
    err, held = kernel_error(out, want, dtype)
    lse_err = (lse - want_lse).abs().max().item()
    label = (f"{str(dtype)[6:]} b{b} sq{sq} sk{sk} hq{hq} hkv{hkv} d{d} "
             f"{'causal' if causal else 'non-causal'}")
    if not (held <= KERNEL_TOL[dtype] and lse_err <= 1e-3):
        raise AssertionError(
            f"flash kernel {label}: error {held} (tol {KERNEL_TOL[dtype]}, "
            f"max abs {err}), lse err {lse_err}")
    log(f"{tag} flash fwd {label}: max_abs_err {err:.3e}, held {held:.3e} "
        f"(tol {KERNEL_TOL[dtype]}), lse err {lse_err:.3e}")
    return err


def flash_fwd_times(args, shape, dtype, err, tag, iters, replays,
                    plain_iters, plain_replays):
    """Kernel, plain and SDPA times of one case with its bound, logged with
    the achieved rates; returns the kernels-line fields."""
    import torch.nn.functional as tnf

    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_fwd as kern, flash_attention_reference as plain)

    b, sq, sk, hq, hkv, d, causal = shape
    q = args[0]
    nbytes, nops = flash_work(*shape, q.element_size())
    qt, kt, vt = (x.transpose(1, 2) for x in args)
    st = dict(max_abs_err=err,
              ms=time_ms(lambda: kern(*args, causal=causal), iters=iters,
                         replays=replays),
              plain_ms=time_ms(lambda: plain(*args, causal=causal),
                               iters=plain_iters, replays=plain_replays),
              library_ms=time_ms(lambda: tnf.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=causal), iters=iters,
                  replays=replays),
              bound_ms=bound_ms(nbytes, nops, dtype),
              bound_by="bytes" if nbytes / HBM_BYTES_PER_S
              >= nops / PEAK_OPS[dtype] else "operations")
    log(f"{tag} flash fwd {str(dtype)[6:]} {[b, sq, hq, d]} "
        f"{'causal' if causal else 'non-causal'}: kernel {st['ms']:.4f} ms "
        f"({flash_rate(st['ms'], nbytes, nops, dtype)}), plain "
        f"{st['plain_ms']:.4f} ms, library (torch sdpa) "
        f"{st['library_ms']:.4f} ms "
        f"({flash_rate(st['library_ms'], nbytes, nops, dtype)}), bound "
        f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {nbytes / 1e6:.2f} MB, "
        f"{nops / 1e9:.3f} GFLOP)")
    return st


def phase_flash(dev):
    """The forward kernel vs its plain version: the full-forward shape
    (timed), ``sq != sk`` with GQA and a ragged tail in fp32 and bf16; the
    bf16 tensor-core kernel at every head dim of ``FLASH_TC_CASES`` and at
    ``FLASH_LONG`` (timed)."""
    stats = {}
    cases = [(*FLASH_SHAPE[:2], FLASH_SHAPE[1], FLASH_SHAPE[2],
              FLASH_SHAPE[2], FLASH_SHAPE[3], True),
             (2, 200, 456, 12, 4, 64, True),      # sq != sk, GQA
             (2, 333, 333, 12, 12, 64, True)]     # tail not a tile multiple
    for dtype in DTYPES:
        for ci, shape in enumerate(cases):
            args = flash_inputs(shape, dtype, dev, SEED + ci)
            err = check_flash_fwd(args, shape, dtype, "[flash]")
            if not ci:
                stats[dtype] = flash_fwd_times(args, shape, dtype, err,
                                               "[flash]", 50, 4, 5, 4)
    for dtype in (torch.bfloat16, torch.float16):
        for ci, shape in enumerate(FLASH_TC_CASES):
            check_flash_fwd(flash_inputs(shape, dtype, dev, SEED + 10 + ci),
                            shape, dtype, "[flash]")
    b, s, h, d = FLASH_LONG
    shape = (b, s, s, h, h, d, True)
    args = flash_inputs(shape, torch.bfloat16, dev, SEED)
    err = check_flash_fwd(args, shape, torch.bfloat16, "[flash]")
    stats["long"] = flash_fwd_times(args, shape, torch.bfloat16, err,
                                    "[flash]", 10, 2, 2, 2)
    return stats


# -- phases 5 and 6 ---------------------------------------------------------


def reset_counts():
    from paddle_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                      flash_attention_fwd)
    from paddle_tpu_torch.ops.paged_attention import (paged_attention,
                                                      ragged_paged_attention)
    from paddle_tpu_torch.ops.quant_matmul import (quant_matmul_bwd,
                                                   quant_matmul_fwd)

    from paddle_tpu_torch.ops import fused_mlp, grouped_matmul, mega_decode

    grouped_matmul.grouped_matmul_fwd.launches = {"fp": 0, "int8": 0,
                                                  "int4": 0}
    grouped_matmul.grouped_matmul_bwd.launches = {"fp": 0, "int8": 0}
    grouped_matmul.grouped_matmul_fwd.tc_launches = 0
    grouped_matmul.grouped_matmul_fwd.sk_launches = 0
    grouped_matmul.grouped_matmul_bwd.tc_launches = 0
    grouped_matmul.grouped_matmul_bwd.dx_launches = 0
    mega_decode.mega_attn_layer.launches = 0
    mega_decode.mega_mlp.launches = 0
    for fn in (flash_attention_fwd, flash_attention_bwd):
        fn.launches = fn.mask_launches = fn.lens_launches = 0
    ragged_paged_attention.launches = 0
    paged_attention.launches = 0
    for fn in (quant_matmul_fwd, quant_matmul_bwd):
        fn.launches = {"int8": 0, "int4": 0}
        fn.tc_launches = 0
    for fn in (fused_mlp.ln_fwd, fused_mlp.ln_bwd, fused_mlp.gelu_fwd,
               fused_mlp.gelu_bwd):
        fn.launches = 0


def fused_counts():
    """(LN forward, LN backward, GELU forward, GELU backward) launches
    since :func:`reset_counts`."""
    from paddle_tpu_torch.ops import fused_mlp

    return (fused_mlp.ln_fwd.launches, fused_mlp.ln_bwd.launches,
            fused_mlp.gelu_fwd.launches, fused_mlp.gelu_bwd.launches)


def qmm_counts() -> dict:
    """Weight-only GEMM launches since :func:`reset_counts`, by kernel."""
    from paddle_tpu_torch.ops.quant_matmul import (quant_matmul_bwd,
                                                   quant_matmul_fwd)

    out = dict(quant_matmul_fwd.launches)
    out.update({f"{k}_bwd": v for k, v in quant_matmul_bwd.launches.items()})
    return out


def qmm_tc_count() -> int:
    """Weight-only GEMM forwards on the tensor-core route since
    :func:`reset_counts`."""
    from paddle_tpu_torch.ops.quant_matmul import quant_matmul_fwd

    return quant_matmul_fwd.tc_launches


def qmm_dx_tc_count() -> int:
    """Weight-only GEMM dx launches on the tensor-core route
    (``qmm_dx_kernel``) since :func:`reset_counts`."""
    from paddle_tpu_torch.ops.quant_matmul import quant_matmul_bwd

    return quant_matmul_bwd.tc_launches


def read_counts():
    """(flash forward, ragged) launches since :func:`reset_counts`."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.ops.paged_attention import ragged_paged_attention

    return flash_attention_fwd.launches, ragged_paged_attention.launches


def bwd_count():
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bwd

    return flash_attention_bwd.launches


def phase_forward(model, cfg, dev):
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (4, 512))).to(dev)
    with torch.no_grad():
        reset_counts()
        logits = model(ids)
        torch.cuda.synchronize()
        flash_n, ragged_n = read_counts()
        cfg.use_flash_attention = False
        plain = model(ids)
        cfg.use_flash_attention = True
    err = (logits - plain).abs().max().item()
    log(f"[forward] GPT-125M ids [4, 512]: logits {tuple(logits.shape)}, "
        f"flash vs plain attention max_abs_err {err:.3e} (tol {LOGIT_TOL}); "
        f"flash launches {flash_n}, ragged launches {ragged_n}")
    if not torch.isfinite(logits).all() or not err <= LOGIT_TOL:
        raise AssertionError(f"full forward: flash vs plain err {err}")
    if flash_n != cfg.num_layers or ragged_n or bwd_count() or any(
            qmm_counts().values()):
        raise AssertionError(f"full forward ran flash {flash_n} times "
                             f"(want {cfg.num_layers}), ragged {ragged_n}, "
                             f"flash backward {bwd_count()}")
    return flash_n


def requests(cfg):
    """Eight prompts of 5-300 tokens. ``late`` ones arrive once the first
    prompt has emitted: ``a + 20 tokens`` attaches all of ``a``'s pages and
    writes into its shared partial page (copy-on-write); the other shares
    ``a``'s first full page, then diverges."""
    rng = np.random.RandomState(SEED + 1)
    draw = lambda n: [int(t) for t in rng.randint(0, cfg.vocab_size, n)]  # noqa: E731
    a = draw(100)
    early = [a, draw(5), draw(37), draw(150), draw(300), draw(64)]
    late = [a + draw(20), a[:80] + draw(40)]
    return early, late


def dispatched(req):
    """Tokens of ``req`` landed or in flight (a package without the async
    engine has none in flight)."""
    return len(req.output_ids) + getattr(req, "_pending_n", 0)


def serve(sp, early, late, after_first=None, failed_ok=False,
          every_step=None):
    """``early`` at once, ``late`` once the first request has emitted (a
    token dispatched counts, landed or not, so the synchronous and the
    async engine see one schedule), stepped until every request finished,
    then flushed. ``after_first(reqs)`` runs after the first step,
    ``every_step(reqs, n)`` after the ``n``-th (from 1). A FAILED request
    raises unless ``failed_ok``."""
    from paddle_tpu_torch.inference.serving import FAILED, FINISHED

    reqs = [sp.add_request(p, MAX_NEW) for p in early]
    first = reqs[0]
    pending = list(late)
    for _ in range(10_000):
        if pending and dispatched(first):
            reqs += [sp.add_request(p, MAX_NEW) for p in pending]
            pending = []
        if not pending and all(r.state in (FINISHED, FAILED) for r in reqs):
            break
        sp.step()
        if after_first is not None:
            after_first(reqs)
            after_first = None
        if every_step is not None:
            every_step(reqs, sp.steps)
    else:
        raise AssertionError("serving did not finish")
    if hasattr(sp, "flush"):
        sp.flush()
    failed = [r.error for r in reqs if r.state == FAILED]
    if failed and not failed_ok:
        raise AssertionError(f"requests failed: {failed}")
    return reqs


def timed_serve(sp, early, late):
    """One :func:`serve` run clocked from the end of its first step (which
    holds the capture of a captured step) to the end of its flush: a dict
    of the requests, the wall (s), the steps after the first, their mean
    step (ms) and tokens a second (the tokens dispatched after the first
    step), and the engine's ``step_gap_frac`` / ``host_ms_per_step`` over
    those steps (None for a package without them)."""
    mark = {}

    def begin(reqs):
        torch.cuda.synchronize()
        if hasattr(sp, "reset_perf_stats"):
            sp.reset_perf_stats()
        mark.update(t=time.perf_counter(), steps=sp.steps,
                    tokens=sum(map(dispatched, reqs)))

    reqs = serve(sp, early, late, after_first=begin)
    torch.cuda.synchronize()
    wall = time.perf_counter() - mark["t"]
    steps = sp.steps - mark["steps"]
    ntok = sum(len(r.output_ids) for r in reqs) - mark["tokens"]
    return dict(reqs=reqs, wall=wall, steps=steps, step_ms=1e3 * wall / steps,
                tok_s=ntok / wall, gap=getattr(sp, "step_gap_frac", None),
                host_ms=getattr(sp, "host_ms_per_step", None))


def median_run(runs):
    """The :func:`timed_serve` run of median mean step."""
    return sorted(runs, key=lambda r: r["step_ms"])[len(runs) // 2]


def step_list(runs):
    """The mean steps of :func:`timed_serve` runs, for a log line."""
    return ", ".join(f"{r['step_ms']:.3f}" for r in runs)


def unified_of(step):
    """The ``UnifiedStep`` under any stand-ins (``StepRecord``,
    ``RouterFlips``, ``EagerStep``)."""
    while not hasattr(step, "eager"):
        step = step.step
    return step


class StepRecord:
    """Stands in for a predictor's unified step (or, with ``legacy``, its
    decode step) and records every call: the logits row of each lane that
    emits, keyed ``(req_id, index of the token in output_ids)`` (tokens the
    async engine has in flight count); with ``routes`` the MoE router's
    choices of every layer and the request of each token row, which runs
    each call eagerly (a captured graph runs no Python to record them)."""

    def __init__(self, sp, legacy=False, routes=False):
        self.sp, self.legacy, self.routes = sp, legacy, routes
        self.step = sp._decode if legacy else sp._unified
        params = (list(inspect.signature(self.step.__call__).parameters)
                  if legacy else list(unified_of(self.step).arg_names))
        self.emit_at = None if legacy else params.index("emit_mask")
        self.slot_at = None if legacy else params.index("tok_slot")
        self.rows, self.calls, self.n = {}, [], 0
        if legacy:
            sp._decode = self
        else:
            sp._unified = self

    def __call__(self, *args, **kw):
        self.n += 1
        with record_routes() if self.routes else contextlib.nullcontext(
                []) as seen:
            out = (unified_of(self.step).eager(*args, **kw) if self.routes
                   else self.step(*args, **kw))
        emit = (None if self.legacy else args[self.emit_at].tolist())
        at = {}
        for slot, req in self.sp.running.items():
            at[slot] = (req.req_id, len(req.output_ids) + req._pending_n)
            if emit is None or emit[slot]:
                self.rows[at[slot]] = out[1][slot].float().clone()
        if self.routes:
            self.calls.append((at, args[self.slot_at].clone(),
                               [s.clone() for s in seen]))
        return out


def check_against_oracle(model, reqs, rows, dev):
    """Teacher-forced greedy oracle: one full forward over prompt + served
    tokens. The step's logits row for each served token must match the
    forward's at that position within ``LOGIT_TOL``, and the token must be
    the argmax there unless the top-2 margin is below ``TIE_MARGIN``.
    Returns (near ties, max abs logit error)."""
    near_ties, logit_err = 0, 0.0
    with torch.no_grad():
        for i, r in enumerate(reqs):
            p, o = list(r.prompt_ids), list(r.output_ids)
            if len(o) != MAX_NEW:
                raise AssertionError(f"request {i}: {len(o)} tokens")
            ids = torch.tensor([p + o[:-1]], device=dev)
            logits = model(ids)[0, len(p) - 1:].float()
            served = torch.stack([rows[(r.req_id, j)] for j in range(len(o))])
            logit_err = max(logit_err,
                            (served - logits).abs().max().item())
            top2 = logits.topk(2, dim=-1)
            want = top2.indices[:, 0].tolist()
            margin = (top2.values[:, 0] - top2.values[:, 1]).tolist()
            for j, (w, g) in enumerate(zip(want, o)):
                if w == g:
                    continue
                if margin[j] < TIE_MARGIN:
                    near_ties += 1
                    log(f"[serve] request {i} token {j}: served {g}, oracle "
                        f"{w}, top-2 margin {margin[j]:.2e} < {TIE_MARGIN}")
                    continue
                raise AssertionError(
                    f"request {i} token {j}: served {g}, oracle {w} "
                    f"(margin {margin[j]:.3e})")
    if not logit_err <= LOGIT_TOL:
        raise AssertionError(f"served logits differ from the full forward's "
                             f"by {logit_err} > {LOGIT_TOL}")
    return near_ties, logit_err


def phase_serve(model, cfg, dev, card):
    from paddle_tpu_torch.inference import ServingPredictor

    early, late = requests(cfg)
    sp = ServingPredictor(model, max_batch=8, device=dev)
    served_logits = StepRecord(sp)
    reset_counts()
    t0 = time.perf_counter()
    reqs = serve(sp, early, late)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash_n, ragged_n = read_counts()
    tel = sp.telemetry()
    steps = sp.steps
    outs = [list(r.output_ids) for r in reqs]
    log(f"[serve] fp32: {len(outs)} requests, {steps} steps, ragged "
        f"launches {ragged_n} (= steps x {cfg.num_layers}: "
        f"{ragged_n == steps * cfg.num_layers}), flash launches {flash_n}, "
        f"prefix-hit tokens {tel['kv_prefix_hit_tokens']:.0f}, CoW copies "
        f"{tel['kv_cow_copies']:.0f}, preemptions "
        f"{tel['serving_preemptions']:.0f}, {wall:.3f} s wall")
    if ragged_n != steps * cfg.num_layers or ragged_n == 0:
        raise AssertionError(f"ragged launches {ragged_n} != steps {steps} "
                             f"x {cfg.num_layers}")
    if tel["kv_cow_copies"] < 1 or tel["kv_prefix_hit_tokens"] < 1:
        raise AssertionError("the shared-prefix requests hit no prefix page "
                             "or made no copy-on-write copy")
    ties, logit_err = check_against_oracle(model, reqs, served_logits.rows,
                                           dev)
    distinct = len({t for o in outs for t in o})
    log(f"[serve] fp32 greedy streams match the full-forward oracle "
        f"({sum(map(len, outs))} tokens, {ties} near-tie positions); served "
        f"logits vs the forward's: max_abs_err {logit_err:.3e} (tol "
        f"{LOGIT_TOL}); {distinct} distinct tokens (floor {MIN_DISTINCT}), "
        f"per request {[len(set(o)) for o in outs]}")
    if distinct < MIN_DISTINCT or min(len(set(o)) for o in outs) < 2:
        raise AssertionError(f"served streams hold only {distinct} distinct "
                             f"tokens (< {MIN_DISTINCT}): too uniform to "
                             "test the step's plumbing")
    # the same requests in bf16: one warm-up run, then BF16_RUNS timed
    # runs, each from the end of its first step (the capture)
    runs = []
    for run in range(1 + BF16_RUNS):
        sp16 = ServingPredictor(model, max_batch=8, device=dev,
                                dtype=torch.bfloat16)
        got = timed_serve(sp16, early, late)
        outs16 = [list(r.output_ids) for r in got["reqs"]]
        if run:
            runs.append(got)
    ntok = sum(map(len, outs16))
    if ntok != MAX_NEW * len(outs16) or not all(
            0 <= t < cfg.vocab_size for o in outs16 for t in o):
        raise AssertionError("bf16 serving produced malformed streams")
    med = median_run(runs)
    log(f"[serve] bf16: {ntok} tokens, {sp16.steps} steps per run; median "
        f"of {BF16_RUNS} runs from the end of the first step: "
        f"{med['tok_s']:.1f} tokens/s, mean step {med['step_ms']:.3f} ms "
        f"(runs: {step_list(runs)} ms) ({card})")
    return ragged_n, outs, med["step_ms"]


# -- phase 8 ----------------------------------------------------------------


def qmm_work(m, k, n, bits, groups, elt):
    """(bytes, ops) of one weight-only GEMM, forward or dx (the same
    traffic): the activations read and the output written once in their
    type, the int8 / packed int4 weight and its fp32 scales read once;
    2 m k n operations."""
    nbytes = (m * k + m * n) * elt + k * n * bits // 8 + 4 * groups * n
    return nbytes, 2.0 * m * k * n


def qmm_case(m, k, n, weight_dtype, gs, dtype, dev, seed):
    """Seeded x [m, k], dy [m, n] and a quantized [k, n] weight (N(0, 0.05)
    cast to ``dtype`` first, as a served model's are)."""
    from paddle_tpu_torch.inference.quantize import quantize_weight

    rng = np.random.RandomState(seed)
    w = torch.from_numpy(0.05 * rng.standard_normal((k, n)).astype(
        np.float32)).to(dev, dtype)
    qw = quantize_weight(w, weight_dtype, gs)
    x, dy = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(
        dev, dtype) for sh in ((m, k), (m, n)))
    return x, dy, qw["q"], qw["s"]


def int8pack_ms(x, q, s):
    """``torch._weight_int8pack_mm`` (int8 per channel, weight [N, K]) on
    the same values, timed and never used; None where the card's torch has
    no CUDA kernel for it."""
    wt = q.t().contiguous()
    sc = s.reshape(-1).to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, str(e).splitlines()[0][:120]
    return time_ms(lambda: torch._weight_int8pack_mm(x, wt, sc)), None


def phase_qmm(dev):
    """The four weight-only GEMM kernels vs their plain versions; per
    (config, dtype) the summed times of the four serving shapes (at M
    ``QMM_ROWS``, ``QMM_DECODE_ROWS`` and ``QMM_SPEC_ROWS``)."""
    from paddle_tpu_torch.ops.quant_matmul import (
        dequantize_weight, quant_matmul_bwd, quant_matmul_dx_reference,
        quant_matmul_fwd, quant_matmul_reference)

    stats = {}
    for wd, gs in QMM_CONFIGS:
        bits = int(wd[3:])
        for dtype in DTYPES:
            tot = {key: 0.0 for key in ("ms", "plain_ms", "bwd_ms",
                                        "bwd_plain_ms", "bound_ms",
                                        "cublas_ms", "bwd_cublas_ms",
                                        "library_ms")}
            errs, lib_note, work = [0.0, 0.0], None, [0.0, 0.0]
            cases = [(QMM_ROWS, *QMM_SHAPES[name], name)
                     for name in QMM_SHAPES] + [(5, 200, 130, "odd")]
            for ci, (m, k, n, name) in enumerate(cases):
                g = gs if name != "odd" or gs < 0 else 40
                x, dy, q, sc = qmm_case(m, k, n, wd, g, dtype, dev,
                                        SEED + ci)
                tc0, dx0 = qmm_tc_count(), qmm_dx_tc_count()
                got = quant_matmul_fwd(x, q, sc)
                tc_route = qmm_tc_count() - tc0
                again = quant_matmul_fwd(x, q, sc)
                dx = quant_matmul_bwd(dy, q, sc, k, dtype)
                dx_route = qmm_dx_tc_count() - dx0
                dx_again = quant_matmul_bwd(dy, q, sc, k, dtype)
                torch.cuda.synchronize()
                on_route = name != "odd" and dtype != torch.float32
                if tc_route != on_route or dx_route != on_route:
                    raise AssertionError(
                        f"quant_matmul {wd} g{g} {name}: {tc_route} forward "
                        f"and {dx_route} dx tensor-core launches (the bf16 / "
                        "fp16 int8 / int4 forward at M <= 64 and dx on "
                        "aligned widths take those routes, nothing else)")
                if not (torch.equal(got, again)
                        and torch.equal(dx, dx_again)):
                    raise AssertionError(f"quant_matmul {wd} g{g} {dtype} "
                                         f"{name}: a second launch differs")
                want = quant_matmul_reference(x, q, sc)
                want_dx = quant_matmul_dx_reference(dy, q, sc, k, dtype)
                held = []
                for i, (a, b) in enumerate(((got, want), (dx, want_dx))):
                    err, h = kernel_error(a, b, dtype)
                    if dtype == torch.float32:
                        h = err / b.abs().max().item()
                    errs[i] = max(errs[i], err)
                    held.append(h)
                if not max(held) <= QMM_TOL[dtype]:
                    raise AssertionError(
                        f"quant_matmul {wd} g{g} {dtype} {name} [{m}, {k}] x "
                        f"[{k}, {n}]: held errors fwd {held[0]}, dx {held[1]} "
                        f"> {QMM_TOL[dtype]}")
                if name == "odd":
                    log(f"[quant] qmm {wd} g{g} {str(dtype)[6:]} odd [5, 200] "
                        f"x [200, 130]: held fwd {held[0]:.3e}, dx "
                        f"{held[1]:.3e} (tol {QMM_TOL[dtype]})")
                    continue
                nbytes, nops = qmm_work(m, k, n, bits, sc.shape[0],
                                        x.element_size())
                work = [work[0] + nbytes, work[1] + nops]
                w_fp = dequantize_weight(q, sc, k=k, out_dtype=dtype)
                t = dict(ms=time_ms(lambda: quant_matmul_fwd(x, q, sc)),
                         plain_ms=time_ms(lambda: quant_matmul_reference(
                             x, q, sc), iters=10),
                         bwd_ms=time_ms(lambda: quant_matmul_bwd(
                             dy, q, sc, k, dtype)),
                         bwd_plain_ms=time_ms(
                             lambda: quant_matmul_dx_reference(
                                 dy, q, sc, k, dtype), iters=10),
                         bound_ms=bound_ms(nbytes, nops, dtype),
                         cublas_ms=time_ms(lambda: x @ w_fp),
                         bwd_cublas_ms=time_ms(lambda: dy @ w_fp.T))
                lib = None
                if wd == "int8" and gs < 0:
                    lib, lib_note = int8pack_ms(x, q, sc)
                t["library_ms"] = lib
                for key, v in t.items():
                    tot[key] = None if v is None or tot[key] is None \
                        else tot[key] + v
                log(f"[quant] qmm {wd} g{g} {str(dtype)[6:]} {name} [{m}, {k}]"
                    f" x [{k}, {n}] ({'tensor cores' if tc_route else 'CUDA cores'}"
                    f" routes, forward and dx repeat bitwise equal): held fwd "
                    f"{held[0]:.3e}, dx "
                    f"{held[1]:.3e}; kernel {t['ms']:.4f} ms (dx "
                    f"{t['bwd_ms']:.4f}), plain {t['plain_ms']:.4f} (dx "
                    f"{t['bwd_plain_ms']:.4f}), bound {t['bound_ms']:.4f} "
                    f"({nbytes / 1e6:.3f} MB, {nops / 1e9:.4f} GFLOP), cuBLAS "
                    f"on the pre-dequantized weight (the fp product this "
                    f"replaces) {t['cublas_ms']:.4f} (dx "
                    f"{t['bwd_cublas_ms']:.4f}), library "
                    + (f"{lib:.4f}" if lib is not None else "null"))
            if (wd, gs) != ("int8", 128):
                tot.update(qmm_decode(wd, gs, dtype, dev))
            # the speculative verify step's budget (phase 16)
            tot["spec_ms"], tot["spec_bound_ms"] = qmm_rows(
                wd, gs, dtype, dev, QMM_SPEC_ROWS, SEED + 30)
            log(f"[quant] qmm {wd} g{gs} {str(dtype)[6:]}, the four GEMMs at "
                f"M {QMM_SPEC_ROWS} (the spec verify step's budget, "
                f"{'tensor-core' if dtype != torch.float32 else 'CUDA-core'}"
                f" route, held to quant_matmul_reference, repeat bitwise "
                f"equal): kernel {tot['spec_ms']:.4f} ms, bound "
                f"{tot['spec_bound_ms']:.4f} ms")
            tot.update(qmm_dx_rows(wd, gs, dtype, dev, QMM_DX_ROWS))
            tot["bound_by"] = ("bytes" if work[0] / HBM_BYTES_PER_S
                               >= work[1] / PEAK_OPS[dtype] else "operations")
            tot["max_abs_err"], tot["bwd_max_abs_err"] = errs
            stats[(wd, gs, dtype)] = tot
            log(f"[quant] qmm {wd} g{gs} {str(dtype)[6:]}, one layer's four "
                f"GEMMs at M {QMM_ROWS}: kernel {tot['ms']:.4f} ms (dx "
                f"{tot['bwd_ms']:.4f}), plain {tot['plain_ms']:.4f} (dx "
                f"{tot['bwd_plain_ms']:.4f}), bound {tot['bound_ms']:.4f} "
                f"({tot['bound_by']}: {work[0] / 1e6:.2f} MB, "
                f"{work[1] / 1e9:.3f} GFLOP), cuBLAS "
                f"fp product replaced {tot['cublas_ms']:.4f} (dx "
                f"{tot['bwd_cublas_ms']:.4f}), library "
                + (f"(torch._weight_int8pack_mm) {tot['library_ms']:.4f}"
                   if tot["library_ms"] is not None else
                   f"null ({lib_note or 'no PyTorch call computes it'})"))
    return stats


def qmm_dx_rows(wd, gs, dtype, dev, m):
    """The four serving GEMMs' dx at ``m`` dy rows on the route the plan
    picks (the tensor-core dx in bf16 and fp16, one ``tc_launches`` each;
    fp32 the CUDA-core kernel): held as phase 8 holds them, launched twice
    (bitwise equal); the summed kernel, bound and cuBLAS (``dy @ w_fp.T`` on
    the pre-dequantized weight, not a port path) times."""
    from paddle_tpu_torch.ops.quant_matmul import (
        dequantize_weight, quant_matmul_bwd, quant_matmul_dx_reference)

    t, work = dict(ms=0.0, cublas_ms=0.0), [0.0, 0.0]
    for ci, (k, n) in enumerate(QMM_SHAPES.values()):
        _, dy, q, sc = qmm_case(m, k, n, wd, gs, dtype, dev, SEED + 20 + ci)
        n0 = qmm_dx_tc_count()
        got = quant_matmul_bwd(dy, q, sc, k, dtype)
        route = qmm_dx_tc_count() - n0
        again = quant_matmul_bwd(dy, q, sc, k, dtype)
        want = quant_matmul_dx_reference(dy, q, sc, k, dtype)
        err, held = kernel_error(got, want, dtype)
        if dtype == torch.float32:
            held = err / want.abs().max().item()
        if (not held <= QMM_TOL[dtype] or not torch.equal(got, again)
                or route != (dtype != torch.float32)):
            raise AssertionError(f"quant_matmul dx {wd} g{gs} {dtype} [{m}, "
                                 f"{n}] x [{n}, {k}]: held error {held} (tol "
                                 f"{QMM_TOL[dtype]}), bitwise repeat "
                                 f"{torch.equal(got, again)}, {route} "
                                 "tensor-core launches")
        w_fp = dequantize_weight(q, sc, k=k, out_dtype=dtype)
        t["ms"] += time_ms(lambda: quant_matmul_bwd(dy, q, sc, k, dtype))
        t["cublas_ms"] += time_ms(lambda: dy @ w_fp.T)
        nbytes, nops = qmm_work(m, k, n, int(wd[3:]), sc.shape[0],
                                dy.element_size())
        work = [work[0] + nbytes, work[1] + nops]
    t["bound_ms"] = bound_ms(*work, dtype)
    log(f"[quant] qmm dx {wd} g{gs} {str(dtype)[6:]}, the four GEMMs at M "
        f"{m} ({'CUDA-core' if dtype == torch.float32 else 'tensor-core'} "
        f"route, repeat bitwise equal): kernel {t['ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms, cuBLAS on the pre-dequantized weight "
        f"{t['cublas_ms']:.4f} ms")
    return {f"dx{m}_{key}": v for key, v in t.items()}


def qmm_rows(wd, gs, dtype, dev, m, seed):
    """The four serving GEMMs at ``m`` tokens on the route the plan picks
    (the tensor cores in bf16 and fp16 up to M 64, one ``tc_launches``
    each; fp32 the CUDA-core kernel): held as phase 8 holds them, launched
    twice (bitwise equal); returns the summed kernel time and bound."""
    from paddle_tpu_torch.ops.quant_matmul import (quant_matmul_fwd,
                                                   quant_matmul_reference)

    ms, work = 0.0, [0.0, 0.0]
    for ci, (k, n) in enumerate(QMM_SHAPES.values()):
        x, _, q, sc = qmm_case(m, k, n, wd, gs, dtype, dev, seed + ci)
        n0 = qmm_tc_count()
        got = quant_matmul_fwd(x, q, sc)
        route = qmm_tc_count() - n0
        again = quant_matmul_fwd(x, q, sc)
        want = quant_matmul_reference(x, q, sc)
        err, held = kernel_error(got, want, dtype)
        if dtype == torch.float32:
            held = err / want.abs().max().item()
        if (not held <= QMM_TOL[dtype] or not torch.equal(got, again)
                or route != (dtype != torch.float32)):
            raise AssertionError(f"quant_matmul {wd} g{gs} {dtype} [{m}, {k}]"
                                 f" x [{k}, {n}]: held error {held} (tol "
                                 f"{QMM_TOL[dtype]}), bitwise repeat "
                                 f"{torch.equal(got, again)}, {route} "
                                 "tensor-core launches")
        ms += time_ms(lambda: quant_matmul_fwd(x, q, sc))
        nbytes, nops = qmm_work(m, k, n, int(wd[3:]), sc.shape[0],
                                x.element_size())
        work = [work[0] + nbytes, work[1] + nops]
    return ms, bound_ms(*work, dtype)


def qmm_decode(wd, gs, dtype, dev):
    """The four serving GEMMs at a decode round (``QMM_DECODE_ROWS``
    tokens, :func:`qmm_rows`); their dx the same way
    (:func:`qmm_dx_rows`)."""
    ms, bound = qmm_rows(wd, gs, dtype, dev, QMM_DECODE_ROWS, SEED + 10)
    out = dict(decode_ms=ms, decode_bound_ms=bound)
    log(f"[quant] qmm {wd} g{gs} {str(dtype)[6:]}, the four GEMMs at M "
        f"{QMM_DECODE_ROWS} (a decode round, "
        f"{'tensor-core' if dtype != torch.float32 else 'CUDA-core'} "
        "route): "
        "kernel "
        f"{ms:.4f} ms, bound {out['decode_bound_ms']:.4f} ms")
    out.update(qmm_dx_rows(wd, gs, dtype, dev, QMM_DECODE_ROWS))
    return out


def phase_ragged_int8(dev):
    """The ragged kernel's int8-KV branch at the phase-3 geometry: pages
    quantized by the KV write's formula."""
    from paddle_tpu_torch.inference.kv_cache import quantize_kv_rows
    from paddle_tpu_torch.ops.paged_attention import (
        ragged_paged_attention as kern,
        ragged_paged_attention_reference as plain)

    stats = {}
    for dtype in DTYPES:
        q, kp, vp, pt, kv_lens, q_lens = ragged_inputs(torch.float32, dev)
        hkv, d = kp.shape[2], kp.shape[3]
        (kq, ks), (vq, vs) = (quantize_kv_rows(t.reshape(-1, hkv, d))
                              for t in (kp, vp))
        args = (q.to(dtype), kq.reshape(kp.shape), vq.reshape(vp.shape), pt,
                kv_lens, q_lens)
        sc = dict(k_scales=ks.reshape(kp.shape[:3]),
                  v_scales=vs.reshape(vp.shape[:3]))
        got = kern(*args, **sc)
        again = kern(*args, **sc)
        torch.cuda.synchronize()
        want = plain(*args, **sc)
        valid = (torch.arange(got.shape[1], device=dev)[None]
                 < q_lens[:, None])
        err, held = kernel_error(got[valid], want[valid], dtype)
        if not torch.equal(got, again):
            raise AssertionError(f"ragged int8-KV kernel {dtype}: a second "
                                 "launch differs from the first")
        if not held <= KERNEL_TOL[dtype] or torch.count_nonzero(
                got[~valid]).item():
            raise AssertionError(f"ragged int8-KV kernel {dtype}: error "
                                 f"{held} > {KERNEL_TOL[dtype]} or rows past "
                                 "q_len not zero")
        nbytes, nops = ragged_work(args)
        st = dict(max_abs_err=err, ms=time_ms(lambda: kern(*args, **sc)),
                  plain_ms=time_ms(lambda: plain(*args, **sc), iters=5),
                  bound_ms=bound_ms(nbytes, nops, dtype))
        stats[dtype] = st
        log(f"[quant] ragged int8 KV {str(dtype)[6:]}: max_abs_err {err:.3e},"
            f" held {held:.3e} (tol {KERNEL_TOL[dtype]}); kernel "
            f"{st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, bound "
            f"{st['bound_ms']:.4f} ms (bytes: {nbytes / 1e6:.2f} MB, "
            f"{nops / 1e9:.3f} GFLOP)")
    return stats


def quant_forward(params, x, cfg, kv_int8, mm):
    """Plain forward of the serving params over one sequence's embedded
    tokens ``x [s, h]`` -> logits ``[s, vocab]``: ``mm(y, q, s)`` for the
    quantized projections, the serving step's association of the bias
    adds, plain causal attention in fp32, and with ``kv_int8`` K and V
    through the int8 KV write's quantize and dequantize."""
    import torch.nn.functional as tnf

    from paddle_tpu_torch.inference.kv_cache import quantize_kv_rows

    s, nh, hd = x.shape[0], cfg.num_heads, cfg.head_dim
    eps = cfg.layer_norm_eps

    def ln(v, g, b):
        return tnf.layer_norm(v.float(), v.shape[-1:], g.float(), b.float(),
                              eps).to(v.dtype)

    def mm_(y, w):
        return mm(y, w["q"], w["s"]) if isinstance(w, dict) else y @ w

    def deq(t):
        qv, sv = quantize_kv_rows(t)
        return qv.float() * sv[..., None]

    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    lay = params["layers"]
    for i in range(cfg.num_layers):
        p = {k: ({n: t[i] for n, t in w.items()} if isinstance(w, dict)
                 else w[i]) for k, w in lay.items()}
        qkv = (mm_(ln(x, p["ln1_g"], p["ln1_b"]), p["wqkv"]) + p["bqkv"]
               ).reshape(s, 3, nh, hd)
        q, k, v = qkv[:, 0].float(), qkv[:, 1].float(), qkv[:, 2].float()
        if kv_int8:
            k, v = deq(k), deq(v)
        sc = torch.einsum("qhd,khd->hqk", q, k) / float(np.sqrt(hd))
        pr = torch.softmax(sc.masked_fill(~causal, -1e30), dim=-1)
        a = torch.einsum("hqk,khd->qhd", pr, v).to(x.dtype).reshape(s, -1)
        x = x + mm_(a, p["wo"]) + p["bo"]
        hid = tnf.gelu(mm_(ln(x, p["ln2_g"], p["ln2_b"]), p["w1"]) + p["b1"],
                       approximate="tanh")
        x = x + (mm_(hid, p["w2"]) + p["b2"])
    x = ln(x, params["lnf_g"], params["lnf_b"])
    return x @ params["tok_emb"].T


def embed(params, ids):
    return params["tok_emb"][ids] + params["pos_emb"][:ids.shape[0]]


def check_quant_oracle(sp, cfg, reqs, rows, kv_int8, tol):
    """Every served token and its logits row against the plain quantized
    forward over the served context. Returns (near ties, max abs logit
    error)."""
    from paddle_tpu_torch.ops.quant_matmul import quant_matmul_reference

    near_ties, logit_err = 0, 0.0
    with torch.no_grad():
        for i, r in enumerate(reqs):
            p, o = list(r.prompt_ids), list(r.output_ids)
            if len(o) != MAX_NEW:
                raise AssertionError(f"request {i}: {len(o)} tokens")
            ids = torch.tensor(p + o[:-1], device=sp.device)
            logits = quant_forward(sp.params, embed(sp.params, ids), cfg,
                                   kv_int8, quant_matmul_reference)
            logits = logits[len(p) - 1:].float()
            served = torch.stack([rows[(r.req_id, j)] for j in range(len(o))])
            logit_err = max(logit_err, (served - logits).abs().max().item())
            top2 = logits.topk(2, dim=-1)
            margin = (top2.values[:, 0] - top2.values[:, 1]).tolist()
            for j, (w, g) in enumerate(zip(top2.indices[:, 0].tolist(), o)):
                if w == g:
                    continue
                if margin[j] < TIE_MARGIN:
                    near_ties += 1
                    continue
                raise AssertionError(
                    f"request {i} token {j}: served {g}, quantized oracle {w}"
                    f" (margin {margin[j]:.3e})")
    if not logit_err <= tol:
        raise AssertionError(f"served logits differ from the quantized "
                             f"forward's by {logit_err} > {tol}")
    return near_ties, logit_err


def quant_predictor(model, cfg, quant, dev, dtype=None, mega_decode=None,
                    unified=None, **kw):
    """A ServingPredictor of ``model`` with the config fields ``quant`` set
    while it is built (it quantizes at construction); ``kw`` goes to the
    predictor."""
    from paddle_tpu_torch.inference import ServingPredictor

    saved = {k: getattr(cfg, k) for k in quant}
    for k, v in quant.items():
        setattr(cfg, k, v)
    try:
        return ServingPredictor(model, max_batch=8, device=dev, dtype=dtype,
                                mega_decode=mega_decode, unified=unified,
                                **kw)
    finally:
        for k, v in saved.items():
            setattr(cfg, k, v)


def quant_grad_drive(params, cfg, dev):
    """d(loss)/d(input embeddings) through the 12 quantized layers (frozen
    weights) of ``params`` in their dtype, the weight-only GEMM op against
    the same forward with the plain GEMM. Returns the error over the plain
    gradient's max, the kernel run's launches and its tensor-core dx
    launches."""
    from paddle_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                   quant_matmul_reference)

    ids = torch.from_numpy(np.random.RandomState(SEED + 3).randint(
        0, cfg.vocab_size, 257)).to(dev)
    grads, counts, tc = {}, None, None
    for name, mm in (("kernel", quant_matmul),
                     ("plain", quant_matmul_reference)):
        x = embed(params, ids[:-1]).detach().requires_grad_()
        reset_counts()
        logits = quant_forward(params, x, cfg, False, mm)
        torch.nn.functional.cross_entropy(logits.float(), ids[1:]).backward()
        torch.cuda.synchronize()
        if name == "kernel":
            counts, tc = qmm_counts(), qmm_dx_tc_count()
        grads[name] = x.grad.float()
    err = ((grads["kernel"] - grads["plain"]).abs().max()
           / grads["plain"].abs().max()).item()
    return err, counts, tc


def phase_quant_grad(model, cfg, dev, bits, quant, params):
    """The input-gradient drives through the backward kernels, 48 dx a
    drive: fp32 with the fp32 served ``params`` (the CUDA-core kernel) to
    ``GRAD_TOL``, then bf16 with the same weights served in bf16 (every dx
    on the tensor-core route) to ``BF16_GRAD_TOL``. Returns the dx launches
    of each."""
    want, out = cfg.num_layers * 4, []
    for dtype, tol in ((torch.float32, GRAD_TOL),
                       (torch.bfloat16, BF16_GRAD_TOL)):
        if dtype != torch.float32:
            params = quant_predictor(model, cfg, quant, dev,
                                     dtype=dtype).params
        err, counts, tc = quant_grad_drive(params, cfg, dev)
        on_route = want if dtype != torch.float32 else 0
        log(f"[quant] int{bits} gradient wrt the input embeddings ([256, "
            f"768], {str(dtype)[6:]}) through {cfg.num_layers} quantized "
            f"layers: kernel vs plain {err:.3e} of its max |grad| (tol "
            f"{tol}); launches {counts}, {tc} dx on the tensor-core route")
        if not err <= tol:
            raise AssertionError(f"int{bits} {dtype} input gradient: kernel "
                                 f"vs plain {err} > {tol}")
        if (counts[f"int{bits}"] != want or counts[f"int{bits}_bwd"] != want
                or tc != on_route):
            raise AssertionError(f"int{bits} {dtype} gradient drive launched"
                                 f" {counts}, {tc} dx on the tensor-core "
                                 f"route (want {want} forward and backward,"
                                 f" {on_route} on the route)")
        out.append(counts[f"int{bits}_bwd"])
    return out


def phase_quant_serve(model, cfg, dev, card, fp_outs, fp16_step_ms):
    """Quantized serving on GPT-125M: three configurations in fp32 against
    the plain quantized forward, the gradient drive through the backward
    kernels, then bf16 step times."""
    from paddle_tpu_torch.inference.quantize import serving_weight_bytes
    from paddle_tpu_torch.models.gpt import serving_params

    early, late = requests(cfg)
    launches = {"ragged": 0, "int8": 0, "int4": 0, "int8_bwd": 0,
                "int4_bwd": 0}
    preds, streams = {}, {}
    for label, quant, tol in QUANT_SERVE:
        sp = quant_predictor(model, cfg, quant, dev)
        preds[label] = sp
        served_logits = StepRecord(sp)
        reset_counts()
        t0 = time.perf_counter()
        reqs = serve(sp, early, late)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ragged_n, counts = read_counts()[1], qmm_counts()
        tc_n = qmm_tc_count()
        tel, steps = sp.telemetry(), sp.steps
        bits = quant["weight_dtype"]
        kv_int8 = quant.get("kv_cache_dtype") == "int8"
        outs = [list(r.output_ids) for r in reqs]
        streams[label] = outs
        log(f"[quant] serve ({label}) fp32: {steps} steps, ragged launches "
            f"{ragged_n}, weight-only GEMM launches {counts} ({tc_n} on the "
            f"tensor-core route), prefix-hit "
            f"tokens {tel['kv_prefix_hit_tokens']:.0f}, CoW copies "
            f"{tel['kv_cow_copies']:.0f}, KV pool {sp.cache.k_pool.dtype}, "
            f"{wall:.3f} s wall")
        others = sum(v for k, v in counts.items() if k != bits)
        if (ragged_n != steps * cfg.num_layers or steps == 0
                or counts[bits] != 4 * steps * cfg.num_layers or others
                or tc_n):
            raise AssertionError(f"({label}) launches: ragged {ragged_n}, "
                                 f"GEMM {counts} ({tc_n} tensor-core) over "
                                 f"{steps} steps")
        if tel["kv_cow_copies"] < 1 or tel["kv_prefix_hit_tokens"] < 1:
            raise AssertionError(f"({label}) no prefix hit or CoW copy")
        if kv_int8 != (sp.cache.k_pool.dtype == torch.int8):
            raise AssertionError(f"({label}) KV pool {sp.cache.k_pool.dtype}")
        launches["ragged"] += ragged_n
        launches[bits] += counts[bits]
        ties, logit_err = check_quant_oracle(sp, cfg, reqs,
                                             served_logits.rows, kv_int8, tol)
        agree = np.mean([a == b for o, f in zip(outs, fp_outs)
                         for a, b in zip(o, f)])
        log(f"[quant] serve ({label}) fp32: greedy streams match the plain "
            f"quantized forward ({sum(map(len, outs))} tokens, {ties} near "
            f"ties); logits max_abs_err {logit_err:.3e} (tol {tol}); token "
            "agreement with the fp32 streams of "
            f"phase 6: {agree:.4f}; {len({t for o in outs for t in o})} "
            "distinct tokens")
    for (label, quant, _), bits in zip(QUANT_SERVE[:2], (8, 4)):
        n32, n16 = phase_quant_grad(model, cfg, dev, bits, quant,
                                    preds[label].params)
        launches[f"int{bits}_bwd"] += n32
        launches[f"int{bits}_bwd_bf16"] = n16
    fp_bytes = serving_weight_bytes(serving_params(model))
    kv = {label: sum(t.numel() * t.element_size()
                     for t in preds[label].cache.pools())
          for label in ("a int8", "c int8 + int8 KV")}
    log(f"[quant] serving_weight_bytes fp32 {fp_bytes / 1e6:.2f} MB, int8 "
        f"{serving_weight_bytes(preds['a int8'].params) / 1e6:.2f} MB, int4 "
        f"g128 {serving_weight_bytes(preds['b int4 g128'].params) / 1e6:.2f}"
        f" MB; KV pools fp32 {kv['a int8'] / 1e6:.2f} MB, int8 + scales "
        f"{kv['c int8 + int8 KV'] / 1e6:.2f} MB")
    del preds
    # bf16: (a), (b) and (c) in turns, every forward on the tensor-core
    # route (48 a step); then one profiled run of (a) and of (b)
    bf16_labels = [label for label, _, _ in QUANT_SERVE]
    walls = {label: [] for label in bf16_labels}
    for run in range(1 + BF16_RUNS):
        for label, quant, _ in (QUANT_SERVE if run % 2
                                else QUANT_SERVE[::-1]):
            sp16 = quant_predictor(model, cfg, quant, dev,
                                   dtype=torch.bfloat16)
            reset_counts()
            got = timed_serve(sp16, early, late)
            outs16 = [list(r.output_ids) for r in got["reqs"]]
            bits, tc_n = quant["weight_dtype"], qmm_tc_count()
            counts = qmm_counts()
            if sum(map(len, outs16)) != MAX_NEW * len(outs16):
                raise AssertionError(f"bf16 ({label}) malformed streams")
            if not (tc_n == counts[bits] == sum(counts.values())
                    == 4 * cfg.num_layers * sp16.steps > 0):
                raise AssertionError(f"bf16 ({label}): {tc_n} tensor-core "
                                     f"GEMM launches, {counts} in all over "
                                     f"{sp16.steps} steps (want 48 a step, "
                                     "all on the route)")
            launches[f"{bits}_bf16"] = launches.get(f"{bits}_bf16", 0) + tc_n
            if run:
                walls[label].append(got)
    bf16_stats = {}
    for label, quant, _ in QUANT_SERVE:
        rs = walls[label]
        med = median_run(rs)
        st = dict(step_ms=[r["step_ms"] for r in rs], steps=sp16.steps)
        log(f"[quant] serve ({label}) bf16: {MAX_NEW * 8} tokens, "
            f"{sp16.steps} steps per run; median of {BF16_RUNS} runs (in "
            f"turns with the other configurations) from the end of the "
            f"first step: {med['tok_s']:.1f} tokens/s, mean step "
            f"{med['step_ms']:.3f} ms (fp bf16 step of phase 6: "
            f"{fp16_step_ms:.3f} ms; runs: "
            f"{step_list(rs)} ms; 48 "
            f"tensor-core GEMM launches a step) ({card})")
        if label != QUANT_SERVE[2][0]:
            sp16 = quant_predictor(model, cfg, quant, dev,
                                   dtype=torch.bfloat16)
            prof = profile_serve(sp16, early, late, card,
                                 f"[quant] ({label})")
            if prof is not None:
                groups, busy, steps = prof
                st.update(busy_ms=busy / 1e3 / steps,
                          gemm_ms=groups["weight-only GEMM"][0] / 1e3
                          / steps)
                log(f"[quant] serve ({label}) bf16: device busy "
                    f"{st['busy_ms']:.4f} ms a step, the weight-only GEMM "
                    f"{st['gemm_ms']:.4f} ms of it ({card})")
        bf16_stats[label] = st
    launches["serve_bf16"] = bf16_stats
    return launches, streams


# -- phase 10 ---------------------------------------------------------------


def mega_inputs(case, weights, group, kv_int8, dtype, dev, seed=SEED):
    """One layer's lane blocks ``xb``, weights (``weights`` None or "int8"
    in groups of ``group``), pools (fp, or int8 through the KV write's
    quantizer), page table, contexts and q_lens of a ``MEGA_*`` case, plus
    the MLP's inputs on the ``b * chunk`` rows."""
    from paddle_tpu_torch.inference.kv_cache import quantize_kv_rows
    from paddle_tpu_torch.inference.quantize import quantize_weight

    (b, chunk, h, nh, d, ps, pps, f), q_lens, ctx = case
    rng = np.random.RandomState(seed)
    hq = nh * d

    def to(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    p = {"ln1_g": to(1 + 0.1 * rng.randn(h)), "ln1_b": to(0.1 * rng.randn(h)),
         "ln2_g": to(1 + 0.1 * rng.randn(h)), "ln2_b": to(0.1 * rng.randn(h)),
         "bqkv": to(0.1 * rng.randn(3 * hq)), "bo": to(0.1 * rng.randn(h)),
         "b1": to(0.1 * rng.randn(f)), "b2": to(0.1 * rng.randn(h))}
    for name, (k, n) in (("wqkv", (h, 3 * hq)), ("wo", (hq, h)),
                         ("w1", (h, f)), ("w2", (f, h))):
        w = to(rng.randn(k, n) / np.sqrt(k), torch.float32)
        p[name] = (quantize_weight(w, weights, group) if weights
                   else w.to(dtype))
    num_pages = b * pps + 1
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    for i in range(b):                 # unallocated past each context
        pt[i, (ctx[i] + q_lens[i] + ps - 1) // ps:] = -1
    kp, vp = (rng.standard_normal((num_pages, ps, nh, d)) for _ in range(2))
    pools = dict(k_pages=to(kp), v_pages=to(vp))
    if kv_int8:
        (kq, ks), (vq, vs) = (quantize_kv_rows(to(t, torch.float32))
                              for t in (kp, vp))
        pools = dict(k_pages=kq, v_pages=vq, k_scales=ks, v_scales=vs)

    def ints(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    mlp = (to(rng.randn(b * chunk, h)), to(rng.randn(b * chunk, h)))
    return (to(rng.randn(b, chunk, h)), p, pools, ints(pt), ints(ctx),
            ints(q_lens)), mlp


def mega_held(got, want, q_lens, dtype, flips):
    """(max abs error, held error, tolerance) of one fp output on the rows
    each lane feeds (``q_lens`` None: every row)."""
    if q_lens is not None:
        valid = (torch.arange(got.shape[1], device=got.device)[None]
                 < q_lens[:, None].long())
        got, want = got[valid], want[valid]
    err, held = kernel_error(got, want, dtype)
    if dtype == torch.float32:
        held = err / max(want.abs().max().item(), 1e-30)
    tol = MEGA_KV_TOL if flips and dtype == torch.float32 else MEGA_TOL[dtype]
    return err, held, tol


def mega_check_attn(got, want, q_lens, dtype, label):
    """Hold one attention call against its plain version: the int8
    payloads by steps, then every other output. Returns (max abs error,
    payload flips, payloads compared)."""
    assert len(got) == len(want), label
    valid = (torch.arange(got[0].shape[1], device=got[0].device)[None]
             < q_lens[:, None].long())
    flips = total = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: {g.dtype} {tuple(g.shape)} vs "
                                 f"{w.dtype} {tuple(w.shape)}")
        if g.dtype == torch.int8:
            diff = (g[valid].int() - w[valid].int()).abs()
            if diff.numel() and diff.max().item() > 1:
                raise AssertionError(f"{label}: an int8 payload "
                                     f"{diff.max().item()} steps off")
            flips += int((diff > 0).sum())
            total += diff.numel()
    if total and flips > MEGA_FLIP_FRAC * total:
        raise AssertionError(f"{label}: {flips} of {total} int8 payloads "
                             f"one step off (> {MEGA_FLIP_FRAC})")
    worst = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.int8:
            continue
        err, held, tol = mega_held(g, w, q_lens, dtype, flips)
        if not held <= tol:
            raise AssertionError(f"{label}: error {held} > {tol} (max abs "
                                 f"{err}, {flips} payload flips)")
        worst = max(worst, err)
    if torch.count_nonzero(got[0][q_lens == 0]).item():
        raise AssertionError(f"{label}: the idle lanes' rows are not zero")
    return worst, flips, total


def mega_attn_work(args, fuse):
    """(bytes, ops) of one attention call on these inputs: x's valid rows,
    the vectors and both weights (int8 with their scales) read once, the
    K and V rows of each active lane's context read once, every output row
    written once; operations of the QKV product, the attention over each
    valid row's keys and the output projection."""
    xb, p, pools, pt, ctx, q_lens = args
    b, chunk, h = xb.shape
    _, ps, nh, d = pools["k_pages"].shape
    elt, hq = xb.element_size(), nh * d

    def wbytes(w):
        if isinstance(w, dict):
            return w["q"].numel() + 4 * w["s"].numel()
        return w.numel() * w.element_size()

    kv_int8 = "k_scales" in pools
    kv_row = nh * (d * (1 if kv_int8 else elt) + (4 if kv_int8 else 0))
    lanes = [(c, q) for c, q in zip(ctx.tolist(), q_lens.tolist()) if q]
    rows = sum(q for _, q in lanes)
    nbytes = (rows * h * elt + (5 * h + 3 * hq) * elt + wbytes(p["wqkv"])
              + wbytes(p["wo"]) + 2 * kv_row * sum(c for c, _ in lanes)
              + b * chunk * h * elt * (2 if fuse else 1)
              + 2 * b * chunk * kv_row
              + 4 * (sum(-(-(c + q) // ps) for c, q in lanes) + 2 * b))
    keys = sum(c + r + 1 for c, q in lanes for r in range(q))
    nops = 2 * rows * h * 3 * hq + 4 * d * nh * keys + 2 * rows * hq * h
    return nbytes, float(nops)


def mega_mlp_work(y2, p, fuse, live=None):
    """(bytes, ops) of one MLP call: y2 (and s_res) read on the ``live``
    rows (all when None), both weights (int8 with their scales) and biases
    read once, every output row written once; 4 live h f operations."""
    t, h = y2.shape
    live = t if live is None else live
    elt = y2.element_size()
    f = p["b1"].shape[0]
    w = sum((p[k]["q"].numel() + 4 * p[k]["s"].numel())
            if isinstance(p[k], dict) else p[k].numel() * elt
            for k in ("w1", "w2"))
    nbytes = (live * h * elt * (2 if fuse else 1) + t * h * elt + w
              + (f + h) * elt)
    return nbytes, 4.0 * live * h * f


def one_layer_step(case, p, pools, pt, ctx, q_lens, mega):
    """A one-layer ``UnifiedStep`` on the case's lanes, its stacked params
    and ``[1, pages + 1, ...]`` pools (spare page last), and the packed
    plumbing the step computes for them: its ``_mega_layers`` /
    ``_per_op_layers`` is the layer the pair replaces, through the port's
    own code. Returns (a callable running the layer on packed rows, the
    packed rows)."""
    import dataclasses

    from paddle_tpu_torch.inference.kv_cache import packed_dest
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, UnifiedStep

    (b, chunk, h, nh, d, ps, pps, f), ql, cx = case
    kv_int8 = "k_scales" in pools
    cfg = dataclasses.replace(GPT_CONFIGS["gpt3-125m"], num_layers=1,
                              hidden_size=h, num_heads=nh,
                              intermediate_size=f)
    step = UnifiedStep(cfg, ps, chunk, kv_quant=kv_int8, mega=mega)
    params = {"layers": {k: ({n: t[None] for n, t in v.items()}
                             if isinstance(v, dict) else v[None])
                         for k, v in p.items()}}
    ext = [torch.cat([t, t[:1]])[None] for t in
           [pools[k] for k in ("k_pages", "v_pages", "k_scales", "v_scales")
            if k in pools]]
    slot = torch.tensor([i for i, q in enumerate(ql) for _ in range(q)],
                        device=pt.device)
    pos = torch.tensor([c + r for c, q in zip(cx, ql) for r in range(q)],
                       device=pt.device)
    off = pos - ctx[slot].long()
    rows = slot * chunk + off
    dest = packed_dest(pt, slot, pos, ps, ext[0].shape[1] - 1)
    layers = step._mega_layers if mega else step._per_op_layers

    def run(x):
        return layers(params, x, ext, pt, q_lens, ctx, rows, rows, dest)

    return run, rows


def phase_mega_kernels(dev, card):
    """Both mega kernels vs their plain versions at the serving shapes and
    an odd shape, fp32 and bf16, fp / int8 weights, fp / int8 KV, with and
    without the fused epilogue; kernel / plain / bound times of both, and
    the per-op layer they replace, on the same inputs."""
    from paddle_tpu_torch.ops.mega_decode import (
        mega_attn_layer, mega_attn_layer_reference, mega_mlp,
        mega_mlp_reference)

    stats = {}
    for cname, case, weight_list in (("serving", MEGA_SERVING, MEGA_WEIGHTS),
                                     ("odd", MEGA_ODD, (("int8", 64),))):
        for dtype in DTYPES:
            for wd, gs in weight_list:
                for kv_int8 in (False, True):
                    args, (y2, s_res) = mega_inputs(case, wd, gs, kv_int8,
                                                    dtype, dev)
                    xb, p, pools, pt, ctx, q_lens = args
                    pos = (xb, p, pools["k_pages"], pools["v_pages"], pt,
                           ctx, q_lens)
                    label = (f"{cname} {str(dtype)[6:]} weights "
                             f"{wd or 'fp'}{'' if gs < 0 else f' g{gs}'}, "
                             f"{'int8' if kv_int8 else 'fp'} KV")
                    errs, flips = [], []
                    for fuse in (True, False):
                        kw = dict(k_scales=pools.get("k_scales"),
                                  v_scales=pools.get("v_scales"),
                                  fuse_epilogue=fuse)
                        got = mega_attn_layer(*pos, **kw)
                        torch.cuda.synchronize()
                        want = mega_attn_layer_reference(*pos, **kw)
                        err, n, total = mega_check_attn(
                            got, want, q_lens, dtype,
                            f"mega attention {label} fuse {fuse}")
                        errs.append(err)
                        flips.append(f"{n}/{total}")
                        err = 0.0
                        for ql in (None, q_lens):   # dense, then live rows
                            kw = dict(fuse_epilogue=fuse, q_lens=ql,
                                      chunk=case[0][1])
                            got = mega_mlp(y2, s_res if fuse else None, p,
                                           **kw)
                            again = mega_mlp(y2, s_res if fuse else None, p,
                                             **kw)
                            torch.cuda.synchronize()
                            want = mega_mlp_reference(y2, s_res, p, **kw)
                            e, held, tol = mega_held(got, want, None, dtype,
                                                     0)
                            if not held <= tol or not torch.equal(got,
                                                                  again):
                                raise AssertionError(
                                    f"mega MLP {label} fuse {fuse} q_lens "
                                    f"{ql is not None}: error {held} > {tol}"
                                    f" (max abs {e}) or a second launch "
                                    "differs")
                            err = max(err, e)
                        errs.append(err)
                    log(f"[mega] {label}: attention max_abs_err fused "
                        f"{errs[0]:.3e} / partial {errs[2]:.3e} (int8 "
                        f"payloads one step off: {', '.join(flips)}), MLP "
                        f"(dense and live rows, repeats bitwise equal) "
                        f"{errs[1]:.3e} / {errs[3]:.3e} (tol "
                        f"{MEGA_TOL[dtype]}; {MEGA_KV_TOL} fp32 after a "
                        "payload flip)")
                    # timed: the rows' fp weights and KV, and bf16 / fp32
                    # int8 g128 weights with int8 KV for row 13's note
                    if cname != "serving" or (wd, kv_int8) not in (
                            (None, False), ("int8", True)) or (
                            wd and gs < 0) or (
                            wd and dtype == torch.float16):
                        continue
                    stats[(wd, kv_int8, dtype)] = mega_times(
                        case, args, (y2, s_res), max(errs[0], errs[2]),
                        max(errs[1], errs[3]), dtype, label, card)
    return stats


def phase_mlp_rounds(dev, card):
    """The mega MLP on GPT-125M's lane block at ``MLP_ROUNDS`` (a served
    round, a decode round, the dense block), fp32 and bf16, fp and int8 g128
    weights: against its plain version (``MEGA_TOL``, zeros in the rows no
    lane feeds), a second launch bitwise equal, kernel / plain / bound
    times."""
    from paddle_tpu_torch.ops.mega_decode import mega_mlp, mega_mlp_reference

    stats = {}
    chunk = MEGA_SERVING[0][1]
    for dtype in DTYPES:
        for wd, gs in ((None, -1), ("int8", 128)):
            args, (y2, s_res) = mega_inputs(MEGA_SERVING, wd, gs, False,
                                            dtype, dev)
            p = args[1]
            for rname, ql in MLP_ROUNDS.items():
                q_lens = None if ql is None else torch.tensor(
                    ql, dtype=torch.int32, device=dev)
                kw = dict(q_lens=q_lens, chunk=chunk)
                got = mega_mlp(y2, s_res, p, **kw)
                again = mega_mlp(y2, s_res, p, **kw)
                torch.cuda.synchronize()
                want = mega_mlp_reference(y2, s_res, p, **kw)
                err, held, tol = mega_held(got, want, None, dtype, 0)
                label = (f"{rname} {str(dtype)[6:]} weights "
                         f"{wd or 'fp'}{'' if gs < 0 else f' g{gs}'}")
                if not held <= tol or not torch.equal(got, again):
                    raise AssertionError(f"mega MLP {label}: error {held} > "
                                         f"{tol} or a second launch differs")
                live = None if ql is None else sum(ql)
                nbytes, nops = mega_mlp_work(y2, p, True, live)
                st = dict(max_abs_err=err,
                          ms=time_ms(lambda: mega_mlp(y2, s_res, p, **kw)),
                          plain_ms=time_ms(lambda: mega_mlp_reference(
                              y2, s_res, p, **kw), iters=5),
                          bound_ms=bound_ms(nbytes, nops, dtype),
                          bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                          >= nops / PEAK_OPS[dtype] else "operations",
                          library_ms=None, mb=nbytes / 1e6,
                          rows=live or y2.shape[0])
                stats[(rname, wd, dtype)] = st
                log(f"[mega] MLP {label} ({st['rows']} live rows of "
                    f"{y2.shape[0]}): max_abs_err {err:.3e} (tol {tol}), "
                    f"repeat bitwise equal; kernel {st['ms']:.4f} ms, plain "
                    f"{st['plain_ms']:.4f}, bound {st['bound_ms']:.6f} "
                    f"({st['bound_by']}: {st['mb']:.2f} MB) ({card})")
    return stats


def mega_times(case, args, mlp_args, attn_err, mlp_err, dtype, label, card):
    """Kernel, plain and bound times of both kernels on these inputs, and
    device times of the one-layer mega step against the per-op layer."""
    from paddle_tpu_torch.ops.mega_decode import (
        mega_attn_layer, mega_attn_layer_reference, mega_mlp,
        mega_mlp_reference)

    xb, p, pools, pt, ctx, q_lens = args
    y2, s_res = mlp_args
    pos = (xb, p, pools["k_pages"], pools["v_pages"], pt, ctx, q_lens)
    kw = dict(k_scales=pools.get("k_scales"), v_scales=pools.get("v_scales"))
    out = {}
    for name, kern, plain, work, err in (
            ("attn", lambda: mega_attn_layer(*pos, **kw),
             lambda: mega_attn_layer_reference(*pos, **kw),
             mega_attn_work(args, True), attn_err),
            ("mlp", lambda: mega_mlp(y2, s_res, p),
             lambda: mega_mlp_reference(y2, s_res, p),
             mega_mlp_work(y2, p, True), mlp_err)):
        nbytes, nops = work
        out[name] = dict(
            max_abs_err=err, ms=time_ms(kern), plain_ms=time_ms(plain,
                                                                iters=5),
            bound_ms=bound_ms(nbytes, nops, dtype), library_ms=None,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S
            >= nops / PEAK_OPS[dtype] else "operations",
            mb=nbytes / 1e6, gflop=nops / 1e9)
    layer = {}
    for mega in (True, False):
        run, rows = one_layer_step(case, p, pools, pt, ctx, q_lens, mega)
        x = xb.reshape(-1, xb.shape[-1])[rows]
        layer[mega] = time_ms(lambda: run(x), iters=10)
    out["layer_ms"], out["per_op_layer_ms"] = layer[True], layer[False]
    a, m = out["attn"], out["mlp"]
    log(f"[mega] {label} times: attention kernel {a['ms']:.4f} ms, plain "
        f"{a['plain_ms']:.4f}, bound {a['bound_ms']:.6f} ({a['bound_by']}: "
        f"{a['mb']:.2f} MB, {a['gflop']:.3f} GFLOP); MLP [{y2.shape[0]}, "
        f"{y2.shape[1]}] x {p['b1'].shape[0]} kernel {m['ms']:.4f} ms, plain "
        f"{m['plain_ms']:.4f}, bound {m['bound_ms']:.6f} ({m['bound_by']}: "
        f"{m['mb']:.2f} MB, {m['gflop']:.3f} GFLOP); library null (no "
        "PyTorch call computes either); one mega layer (both kernels and the "
        f"K / V scatters) {out['layer_ms']:.4f} ms vs the per-op layer it "
        f"replaces {out['per_op_layer_ms']:.4f} ms on the same "
        f"{int(q_lens.sum())} rows (device time, {card})")
    return out


def mega_counts():
    """(mega attention, mega MLP) launches since :func:`reset_counts`."""
    from paddle_tpu_torch.ops.mega_decode import mega_attn_layer, mega_mlp

    return mega_attn_layer.launches, mega_mlp.launches


# idle host time after a profiler starts and before it stops: without it
# a trace lost the records of kernels launched just after the start (all
# of a short session's) and of a long window's last replays (PERF.md, PR
# 21; ``profile_margin.py``)
PROFILE_MARGIN_S = 0.2


def profile_run(fn, card, tag, what):
    """``fn()`` once under ``torch.profiler``: logs (``what()`` naming the
    run) the device busy and idle share of its wall time and the device
    time by kernel group; returns ``{group: (device us, launches)}`` and
    the busy us, or None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
        time.sleep(PROFILE_MARGIN_S)
    return trace_report(prof, wall_us, card, tag, what)


def group_launches() -> dict:
    """The wrappers' launch counters summed by :func:`trace_report`'s
    kernel groups (every wrapper in a group launches one kernel of the
    group a counted call). Read off the wrappers, so a package from
    before ``ops.counters`` reads the same."""
    from paddle_tpu_torch.ops import (grouped_matmul, mega_decode,
                                      paged_attention, quant_matmul)

    def total(*fns):
        return sum(sum(f.launches.values()) if isinstance(f.launches, dict)
                   else f.launches for f in fns)

    return {"ragged kernel": total(paged_attention.ragged_paged_attention),
            "paged decode kernel": total(paged_attention.paged_attention),
            "mega kernels": total(mega_decode.mega_attn_layer,
                                  mega_decode.mega_mlp),
            "weight-only GEMM": total(quant_matmul.quant_matmul_fwd,
                                      quant_matmul.quant_matmul_bwd),
            "grouped GEMM": total(grouped_matmul.grouped_matmul_fwd,
                                  grouped_matmul.grouped_matmul_bwd)}


def profile_serve(sp, early, late, card, tag, top=0, need=False,
                  detail=False, margin=PROFILE_MARGIN_S):
    """One served run with ``torch.profiler`` on from the end of its first
    step (which holds the capture of a captured step) to the end of its
    flush: as :func:`profile_run`, plus the ``top`` kernels by device time.
    The launches the trace holds in each kernel group of
    :func:`group_launches` must equal what the wrappers' counters gained
    over the window (on the captured step the counters add a capture's
    launches a replay: the trace sees the replays' kernels), or it raises.
    Returns (groups, busy us, steps in the window), or None when the trace
    holds no device time (``need``: raises then). A mismatch, and every
    window with ``detail``, logs :func:`launch_detail`. The profiler runs
    ``margin`` seconds of idle host time before and after the window (not
    in its wall time; see ``PROFILE_MARGIN_S``)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    mark = {}

    def begin(_):
        torch.cuda.synchronize()
        prof.start()
        time.sleep(margin)
        mark.update(t=time.perf_counter(), steps=sp.steps,
                    counted=group_launches())

    serve(sp, early, late, after_first=begin)
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - mark["t"])
    time.sleep(margin)
    prof.stop()
    steps = sp.steps - mark["steps"]
    out = trace_report(prof, wall_us, card, tag,
                       lambda: f"{steps} steps after the first", top)
    if out is None:
        if need:
            raise AssertionError(f"{tag}: the profiler saw no device time")
        return None
    counted = {g: n - mark["counted"][g] for g, n in group_launches().items()}
    seen = {g: out[0][g][1] for g in counted}
    if detail or seen != counted:
        log(f"{tag} launches by graph launch: "
            + launch_detail(prof, [g for g, n in counted.items() if n]))
    if seen != counted:
        raise AssertionError(f"{tag}: the trace's launches by kernel group "
                             f"{seen} differ from the counters' {counted} "
                             f"over {steps} steps")
    log(f"{tag} the trace's launches by kernel group equal the counters' "
        f"over the window: { {g: n for g, n in seen.items() if n} }")
    return out + (steps,)


TRACE_GROUPS = {"mega kernels": ("mega_attn", "mega_mlp"),
                "ragged kernel": ("ragged",),
                "paged decode kernel": ("paged_decode",),
                "weight-only GEMM": ("qmm_kernel", "qmm_tc_kernel",
                                     "qmm_dx_kernel"),
                "grouped GEMM": ("gmm_kernel", "gmm_tc_kernel",
                                 "gmm_wg_kernel", "gmm_sk_kernel",
                                 "gmm_dx_kernel"),
                "cuBLAS": ("gemm", "nvjet", "cutlass")}


def trace_group(name: str) -> str:
    """The :data:`TRACE_GROUPS` group of a kernel's name."""
    key = name.lower()
    return next((n for n, marks in TRACE_GROUPS.items()
                 if any(m in key for m in marks)), "other PyTorch kernels")


def launch_detail(prof, groups) -> str:
    """Per kernel group of ``groups``, how many of the trace's launches
    (one correlation id: a CUDA graph replay's kernels share its
    ``cudaGraphLaunch``'s) held how many of the group's kernels; the
    trace's ``cudaGraphLaunch`` calls and device events of no duration;
    and each launch short of the commonest count, by its place among the
    launches (first kernel's start) and its kernels of any kind: a launch
    short of kernels is a lost profiler record (a graph runs whole), a
    launch missing a replay the counters charged that never ran."""
    from collections import Counter

    from torch.autograd import DeviceType

    from paddle_tpu_torch.profiler.profiler import is_annotation

    per = {g: Counter() for g in groups}
    every, first = Counter(), {}
    graph_launches = no_time = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and is_annotation(ev):
            continue
        if ev.device_type() == DeviceType.CUDA:
            if ev.duration_ns() <= 0:
                no_time += 1
                continue
            c = ev.correlation_id()
            every[c] += 1
            first[c] = min(first.get(c, ev.start_ns()), ev.start_ns())
            g = trace_group(ev.name())
            if g in per:
                per[g][c] += 1
        elif "cudaGraphLaunch" in ev.name():
            graph_launches += 1
    order = {c: i for i, c in enumerate(sorted(
        set().union(*per.values()), key=first.get))}
    out = [f"cudaGraphLaunch calls {graph_launches}, device events of no "
           f"duration {no_time}"]
    for g, ids in per.items():
        hist = Counter(ids.values())
        if not hist:
            continue
        common = hist.most_common(1)[0][0]
        short = sorted((order[c], every[c]) for c, n in ids.items()
                       if n < common)
        full = Counter(every[c] for c, n in ids.items() if n == common)
        out.append(f"{g}: {len(ids)} launches, kernels a launch "
                   f"{dict(sorted(hist.items()))}; short launches (place, "
                   f"kernels of any kind) {short} of {len(order)}, a full "
                   f"launch's kernels {dict(full)}")
    return "; ".join(out)


def trace_report(prof, wall_us, card, tag, what, top=0):
    """The device time of a finished ``torch.profiler`` trace by kernel
    group against ``wall_us`` (see :func:`profile_run`), and with ``top``
    the longest kernels by name."""
    from paddle_tpu_torch.profiler.profiler import is_device_work

    times = {name: 0.0 for name in TRACE_GROUPS}
    times["other PyTorch kernels"] = 0.0
    counts = dict.fromkeys(times, 0)
    by_name: dict = {}
    # the trace's raw device events (kernels, copies, fills) give the device
    # times key_averages() would, without the event tree it builds first:
    # tens of seconds for the ~10^5 kernels of a served MoE run
    for ev in prof.profiler.kineto_results.events():
        if not is_device_work(ev):
            continue
        name = trace_group(ev.name())
        times[name] += ev.duration_ns() / 1e3
        counts[name] += 1
        if top:
            t, c = by_name.get(ev.name(), (0.0, 0))
            by_name[ev.name()] = (t + ev.duration_ns() / 1e3, c + 1)
    busy = sum(times.values())
    if busy <= 0:
        log(f"{tag} profiler: no device time in the trace (not measured)")
        return None
    log(f"{tag} profiled bf16 run: {what()}, wall {wall_us / 1e3:.1f}"
        f" ms under the profiler, device busy {busy / 1e3:.3f} ms = "
        f"{busy / wall_us:.3f}, idle {1 - busy / wall_us:.3f}; "
        f"{sum(counts.values())} kernels; " + ", ".join(
            f"{n} {t / 1e3:.3f} ms ({t / busy:.3f}, {counts[n]} launches)"
            for n, t in times.items() if t) + f" ({card})")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        log(f"{tag} kernel {t / 1e3:8.3f} ms ({t / busy:.3f}) x{c:<6d} "
            f"{name[:100]}")
    return {n: (t, counts[n]) for n, t in times.items()}, busy


def phase_mega_serve(model, cfg, dev, card, fp_outs, quant_streams):
    """``ServingPredictor(mega_decode=True)`` on GPT-125M with the phase-6
    requests in fp32: (i) fp weights against phase 6's per-op streams and
    the full-forward oracle, (ii) int8 weights against phase 8's per-op
    streams of the same config and the plain quantized forward, (iii) int8
    g128 weights with an int8 KV cache against a per-op run of the same
    config and the plain quantized forward; then bf16 step times of (i)
    and (iii) beside their per-op twins, and one profiled mega run of each.
    Returns the fp32 runs' (attention, MLP) launches."""
    early, late = requests(cfg)
    total = [0, 0]
    for label, quant, tol in MEGA_SERVE:
        if not quant:
            want = fp_outs
        elif label.startswith("ii "):
            want = quant_streams["a int8"]      # the same config
        else:
            want = [list(r.output_ids) for r in serve(
                quant_predictor(model, cfg, quant, dev), early, late)]
        sp = quant_predictor(model, cfg, quant, dev, mega_decode=True)
        served_logits = StepRecord(sp)
        reset_counts()
        t0 = time.perf_counter()
        reqs = serve(sp, early, late)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        attn_n, mlp_n = mega_counts()
        ragged_n, qmm = read_counts()[1], qmm_counts()
        steps, tel = sp.steps, sp.telemetry()
        outs = [list(r.output_ids) for r in reqs]
        kv_int8 = quant.get("kv_cache_dtype") == "int8"
        log(f"[mega] serve ({label}) fp32: {steps} steps, mega launches "
            f"attention {attn_n} / MLP {mlp_n} (steps x {cfg.num_layers} = "
            f"{steps * cfg.num_layers}), ragged {ragged_n}, weight-only GEMM "
            f"{qmm}, prefix-hit tokens {tel['kv_prefix_hit_tokens']:.0f}, CoW "
            f"copies {tel['kv_cow_copies']:.0f}, KV pool "
            f"{sp.cache.k_pool.dtype}, {wall:.3f} s wall")
        if not (attn_n == mlp_n == steps * cfg.num_layers and steps
                and ragged_n == 0 and not any(qmm.values())):
            raise AssertionError(f"({label}) launches: mega {attn_n} / "
                                 f"{mlp_n}, ragged {ragged_n}, GEMM {qmm} "
                                 f"over {steps} steps")
        if tel["kv_cow_copies"] < 1 or tel["kv_prefix_hit_tokens"] < 1:
            raise AssertionError(f"({label}) no prefix hit or CoW copy")
        if kv_int8 != (sp.cache.k_pool.dtype == torch.int8):
            raise AssertionError(f"({label}) KV pool {sp.cache.k_pool.dtype}")
        if tol is None:
            ties, logit_err = check_against_oracle(model, reqs,
                                                   served_logits.rows, dev)
            oracle = "the full forward"
        else:
            ties, logit_err = check_quant_oracle(
                sp, cfg, reqs, served_logits.rows, kv_int8, tol)
            oracle = "the plain quantized forward"
        same = sum(a == b for o, w in zip(outs, want) for a, b in zip(o, w))
        log(f"[mega] serve ({label}) fp32: greedy streams match {oracle} "
            f"({sum(map(len, outs))} tokens, {ties} near ties), logits "
            f"max_abs_err {logit_err:.3e} (tol {tol or LOGIT_TOL}); equal to "
            f"the per-op streams in {same} of {sum(map(len, want))} tokens")
        if outs != want:
            raise AssertionError(f"({label}) mega streams differ from the "
                                 "per-op streams")
        total[0] += attn_n
        total[1] += mlp_n
    # bf16 step times, mega beside per-op in turns (median of BF16_RUNS
    # each, from the end of the first step: the capture)
    for label, quant, _ in (MEGA_SERVE[0], MEGA_SERVE[2]):
        walls = {False: [], True: []}
        for run in range(1 + BF16_RUNS):
            for mega in ((False, True) if run % 2 else (True, False)):
                sp16 = quant_predictor(model, cfg, quant, dev,
                                       dtype=torch.bfloat16, mega_decode=mega)
                got = timed_serve(sp16, early, late)
                if run:
                    walls[mega].append(got)
                outs16 = [list(r.output_ids) for r in got["reqs"]]
                if sum(map(len, outs16)) != MAX_NEW * len(outs16):
                    raise AssertionError(f"bf16 ({label}) malformed streams")
        ms = {}
        for mega, runs in walls.items():
            ms[mega] = median_run(runs)["step_ms"]
            log(f"[mega] serve ({label}) bf16 {'mega' if mega else 'per-op'}"
                f": {sp16.steps} steps per run; median of {BF16_RUNS} runs "
                f"from the end of the first step: mean step {ms[mega]:.3f} "
                f"ms (runs: {step_list(runs)} ms) ({card})")
        log(f"[mega] serve ({label}) bf16 mean step mega {ms[True]:.3f} ms "
            f"vs per-op {ms[False]:.3f} ms: {ms[False] / ms[True]:.2f}x "
            f"({card})")
        profile_serve(
            quant_predictor(model, cfg, quant, dev, dtype=torch.bfloat16,
                            mega_decode=True), early, late,
            card, f"[mega] ({label}, mega)")
    return total


# -- phase 11 ---------------------------------------------------------------


def gmm_counts() -> dict:
    """Grouped-GEMM launches since :func:`reset_counts`, by kernel."""
    from paddle_tpu_torch.ops.grouped_matmul import (grouped_matmul_bwd,
                                                     grouped_matmul_fwd)

    out = dict(grouped_matmul_fwd.launches)
    out.update({f"{k}_bwd": v for k, v in grouped_matmul_bwd.launches.items()})
    return out


def gmm_tc_counts() -> list:
    """[forward, dx] launches of the tensor-core grouped GEMM since
    :func:`reset_counts` (0 for a package that has none)."""
    from paddle_tpu_torch.ops.grouped_matmul import (grouped_matmul_bwd,
                                                     grouped_matmul_fwd)

    return [getattr(grouped_matmul_fwd, "tc_launches", 0),
            getattr(grouped_matmul_bwd, "tc_launches", 0)]


def gmm_sk_count() -> int:
    """Grouped-GEMM forwards on the skinny route (int8 / int4 stacks at
    the serving rows) since :func:`reset_counts` (0 for a package that has
    none)."""
    from paddle_tpu_torch.ops.grouped_matmul import grouped_matmul_fwd

    return getattr(grouped_matmul_fwd, "sk_launches", 0)


def gmm_dx_count() -> int:
    """Grouped-GEMM dx launches on the dx route (int8 stacks,
    ``gmm_dx_kernel``) since :func:`reset_counts` (0 for a package that has
    none)."""
    from paddle_tpu_torch.ops.grouped_matmul import grouped_matmul_bwd

    return getattr(grouped_matmul_bwd, "dx_launches", 0)


@contextlib.contextmanager
def moe_twins():
    """Every grouped GEMM the MoE FFN runs takes its plain version (on the
    card) while the block is open: the same step or model built from the
    twins, for the comparisons; their launches are not counted."""
    from paddle_tpu_torch.models import moe

    kernel_mm = moe._grouped_mm
    moe._grouped_mm = lambda xs, w, offs, use_kernel: kernel_mm(
        xs, w, offs, False)
    try:
        yield
    finally:
        moe._grouped_mm = kernel_mm


@contextlib.contextmanager
def record_routes():
    """The router's expert choices ``idx [N, k]`` of every MoE layer run
    while the block is open, in order."""
    from paddle_tpu_torch.models import moe

    route, seen = moe.route_topk, []

    def recording(logits, top_k):
        out = route(logits, top_k)
        seen.append(out[1])
        return out

    moe.route_topk = recording
    try:
        yield seen
    finally:
        moe.route_topk = route


@contextlib.contextmanager
def replay_routes(seen):
    """Every MoE layer run while the block is open takes the expert choices
    ``seen`` (``idx [N, k]`` of :func:`record_routes`, in order, cycled):
    the gates are the router's own probabilities at those choices,
    renormalized, as ``route_topk`` makes them. Two runs in another dtype
    then route alike."""
    from paddle_tpu_torch.models import moe

    route, at = moe.route_topk, [0]

    def replaying(logits, top_k):
        idx = seen[at[0] % len(seen)]
        at[0] += 1
        probs = torch.softmax(logits.float(), dim=-1)
        raw = probs.gather(1, idx.long())
        gates = raw / raw.sum(1, keepdim=True).clamp_min(1e-9)
        masks = [torch.nn.functional.one_hot(
            idx[:, j].long(), logits.shape[-1]).to(torch.float32)
            for j in range(idx.shape[1])]
        return gates, idx, probs, masks

    moe.route_topk = replaying
    try:
        yield
    finally:
        moe.route_topk = route


def gmm_case(counts, k, n, weights, gs, dtype, dev, seed):
    """Seeded x [M, K], dy [M, N], an expert stack (N(0, 0.05), cast to
    ``dtype`` first, quantized per expert) whose EMPTY experts hold NaN
    weights (fp) or NaN scales, its scales or None, and the offsets."""
    from paddle_tpu_torch.inference.quantize import quantize_weight

    rng = np.random.RandomState(seed)
    m, e = sum(counts), len(counts)
    x, dy = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(
        dev, dtype) for sh in ((m, k), (m, n)))
    w = torch.from_numpy(0.05 * rng.standard_normal((e, k, n)).astype(
        np.float32)).to(dev, dtype)
    empty = [i for i, c in enumerate(counts) if c == 0]
    scales = None
    if weights is None:
        w[empty] = float("nan")
    else:
        qw = quantize_weight(w, weights, gs)
        w, scales = qw["q"], qw["s"]
        scales[empty] = float("nan")
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=dev)
    return x, dy, w, scales, offs


def gmm_work(counts, k, n, bits, groups, elt):
    """(bytes, ops) of one grouped GEMM, forward or dx (the same traffic):
    the activations read and the output written once in their type, the
    weights (and fp32 scales) of the NON-EMPTY experts read once, the
    offsets; 2 M K N operations."""
    m, live = sum(counts), sum(1 for c in counts if c)
    wbytes = k * n * (elt if bits == 0 else bits / 8) + 4 * groups * n
    nbytes = (m * k + m * n) * elt + live * wbytes + 4 * (len(counts) + 1)
    return nbytes, 2.0 * m * k * n


def grouped_mm_ms(a, b, offs, want):
    """``torch._grouped_mm`` on the same values (bf16 or fp16, ``b`` as
    given or in column-major layout), timed and never used: (ms, None), or
    (None, why) where the card's torch refuses both layouts or disagrees
    with ``want``. fp16 is timed eagerly between CUDA events
    (``events_ms``): the card's torch copies the offsets to the host for
    it, which a CUDA graph cannot capture."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "this torch has no torch._grouped_mm"
    ends = offs[1:].contiguous()
    why = None
    for mat in (b.contiguous(),
                b.transpose(-2, -1).contiguous().transpose(-2, -1)):
        try:
            got = fn(a, mat, offs=ends)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError) as e:
            why = str(e).splitlines()[0][:120]
            continue
        err = kernel_error(got, want, a.dtype)[1]
        if not err <= GMM_TOL[a.dtype]:
            return None, f"torch._grouped_mm disagrees ({err:.3e})"
        timer = time_ms if a.dtype == torch.bfloat16 else events_ms
        return timer(lambda: fn(a, mat, offs=ends)), None
    return None, why


def phase_gmm(dev, card):
    """The five grouped-GEMM kernels vs their plain versions at the three
    shapes; per (kernel, dtype, shape set) the summed times of w1 and w2
    (one MoE layer's two GEMMs) at (a) the serving and (b) the prefill
    rows."""
    from paddle_tpu_torch.ops.grouped_matmul import (
        dequantize_grouped_weight, grouped_matmul_bwd,
        grouped_matmul_dx_reference, grouped_matmul_fwd,
        grouped_matmul_reference)

    stats, notes = {}, {}
    for label, wd, gs in GMM_WEIGHTS:
        bits = int(wd[3:]) if wd else 0
        fwd_name = {0: "gmm", 8: "gmm_q", 4: "gmm_q4"}[bits]
        bwd_name = {0: "gmm_bwd", 8: "gmm_q_bwd"}.get(bits)
        for dtype in DTYPES:
            k_odd, n_odd, c_odd, g_odd = GMM_ODD
            cases = [(c, *GMM_SHAPES[name], name, rows, gs)
                     for rows, c in (("a", GMM_ROWS), ("b", GMM_PREFILL))
                     for name in GMM_SHAPES]
            cases.append((c_odd, k_odd, n_odd, "odd", "c",
                          g_odd if gs > 0 else -1))
            for ci, (counts, k, n, name, rows, g) in enumerate(cases):
                x, dy, w, sc, offs = gmm_case(counts, k, n, wd, g, dtype,
                                              dev, SEED + ci)
                tag = (f"[moe] {fwd_name} {label} {str(dtype)[6:]} {name} "
                       f"({rows}) M {sum(counts)} {counts} x [{k}, {n}] g{g}")
                tc0, sk0, dx0 = gmm_tc_counts(), gmm_sk_count(), \
                    gmm_dx_count()
                pairs = [(grouped_matmul_fwd(x, w, offs, sc),
                          grouped_matmul_reference(x, w, offs, sc))]
                if bwd_name:
                    pairs.append((
                        grouped_matmul_bwd(dy, w, offs, sc, k, dtype),
                        grouped_matmul_dx_reference(dy, w, offs, sc, k,
                                                    dtype)))
                torch.cuda.synchronize()
                # bf16 / fp16 fp weights at these widths run the
                # tensor-core kernel, everything else the CUDA-core one
                tc = int(bits == 0 and dtype != torch.float32)
                ran = [a - b for a, b in zip(gmm_tc_counts(), tc0)]
                if ran != [tc, tc if bwd_name else 0]:
                    raise AssertionError(f"{tag}: tensor-core launches {ran}"
                                         f", want {tc} each")
                # int8 / int4 stacks at the serving rows (a) take the
                # skinny route in bf16 / fp16; fp32, the prefill rows (b)
                # and the odd widths (c) gmm_kernel
                sk = int(bits != 0 and rows == "a"
                         and dtype != torch.float32)
                if gmm_sk_count() - sk0 != sk:
                    raise AssertionError(f"{tag}: skinny-route launches "
                                         f"{gmm_sk_count() - sk0}, want {sk}")
                # the int8 dx at (a) and (b) takes the dx route in bf16 /
                # fp16; fp32 and the odd widths (c) gmm_kernel
                dxr = int(bits == 8 and rows != "c"
                          and dtype != torch.float32)
                if gmm_dx_count() - dx0 != dxr:
                    raise AssertionError(f"{tag}: dx-route launches "
                                         f"{gmm_dx_count() - dx0}, want "
                                         f"{dxr}")
                if rows != "c":   # a second launch gives the same bits
                    again = [grouped_matmul_fwd(x, w, offs, sc)] + (
                        [grouped_matmul_bwd(dy, w, offs, sc, k, dtype)]
                        if bwd_name else [])
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, got) for a, (got, _) in
                               zip(again, pairs)):
                        raise AssertionError(f"{tag}: a second launch is not"
                                             " bitwise equal to the first")
                held, errs = [], []
                for got, want in pairs:
                    err, h = kernel_error(got, want, dtype)
                    if dtype == torch.float32:
                        h = err / want.abs().max().item()
                    if not bool(torch.isfinite(got).all()):
                        h = float("inf")   # an empty expert's NaN was read
                    held.append(h)
                    errs.append(err)
                if not max(held) <= GMM_TOL[dtype]:
                    raise AssertionError(f"{tag}: held errors {held} > "
                                         f"{GMM_TOL[dtype]}")
                route = ("tensor cores" if tc else "skinny route" if sk
                         else "CUDA cores")
                bwd_route = ("tensor cores" if tc else "dx route" if dxr
                             else "CUDA cores")
                # fp16 is timed at the serving rows (a), its rows'
                # figures; (b) checked only
                if rows == "c" or (rows == "b" and dtype == torch.float16):
                    log(f"{tag}: held fwd / dx {held} (tol "
                        f"{GMM_TOL[dtype]}; {route} / {bwd_route}); NaN "
                        "weights of the empty expert absent from the output")
                    continue
                nbytes, nops = gmm_work(counts, k, n, bits,
                                        1 if sc is None else sc.shape[1],
                                        x.element_size())
                it = 50 if rows == "a" else 10
                t = {fwd_name: dict(
                    ms=time_ms(lambda: grouped_matmul_fwd(x, w, offs, sc),
                               iters=it),
                    plain_ms=time_ms(lambda: grouped_matmul_reference(
                        x, w, offs, sc), iters=10),
                    max_abs_err=errs[0])}
                lib, why = (grouped_mm_ms(x, w, offs, pairs[0][1])
                            if bits == 0 and dtype != torch.float32
                            else (None, "no PyTorch call takes this type"
                                  if bits == 0 else "no PyTorch call takes "
                                  "quantized expert stacks"))
                t[fwd_name]["library_ms"] = lib
                notes[(fwd_name, dtype)] = why
                if bwd_name:
                    wt = w.transpose(1, 2)
                    lib, why = (grouped_mm_ms(dy, wt, offs, pairs[1][1])
                                if bits == 0 and dtype != torch.float32
                                else (None, notes[(fwd_name, dtype)]))
                    t[bwd_name] = dict(
                        ms=time_ms(lambda: grouped_matmul_bwd(
                            dy, w, offs, sc, k, dtype), iters=it),
                        plain_ms=time_ms(lambda: grouped_matmul_dx_reference(
                            dy, w, offs, sc, k, dtype), iters=10),
                        max_abs_err=errs[1], library_ms=lib, deq_ms=None)
                    notes[(bwd_name, dtype)] = why
                    if bits == 8 and dtype != torch.float32:
                        # a reference figure, not a port path: the grouped
                        # product on the pre-dequantized stack's transpose
                        wfp = dequantize_grouped_weight(w, sc, k=k,
                                                        out_dtype=dtype)
                        t[bwd_name]["deq_ms"] = grouped_mm_ms(
                            dy, wfp.transpose(1, 2), offs, pairs[1][1])[0]
                        del wfp
                for kname, st in t.items():
                    key = (kname, label, dtype, rows)
                    tot = stats.setdefault(key, dict(
                        ms=0.0, plain_ms=0.0, library_ms=0.0, deq_ms=0.0,
                        max_abs_err=0.0, work=[0.0, 0.0]))
                    for f in ("ms", "plain_ms", "library_ms", "deq_ms"):
                        tot[f] = (None if tot[f] is None or st.get(f) is None
                                  else tot[f] + st[f])
                    tot["max_abs_err"] = max(tot["max_abs_err"],
                                             st["max_abs_err"])
                    tot["work"] = [tot["work"][0] + nbytes,
                                   tot["work"][1] + nops]
                    log(f"[moe] {kname} {label} {str(dtype)[6:]} {name} "
                        f"({rows}) M {sum(counts)} x [{k}, {n}] ("
                        + (route if kname == fwd_name else bwd_route)
                        + ", repeat bitwise equal): held "
                        f"{held[0 if kname == fwd_name else 1]:.3e}; kernel "
                        f"{st['ms']:.4f} ms, plain {st['plain_ms']:.4f}, "
                        f"bound {bound_ms(nbytes, nops, dtype):.6f} "
                        f"({nbytes / 1e6:.3f} MB, {nops / 1e9:.4f} GFLOP), "
                        "library (torch._grouped_mm) " + (
                            f"{st['library_ms']:.4f}"
                            if st["library_ms"] is not None else
                            f"null ({notes[(kname, dtype)]})"))
    for key, tot in stats.items():
        nbytes, nops = tot.pop("work")
        dtype = key[2]
        tot["bound_ms"] = bound_ms(nbytes, nops, dtype)
        tot["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                           >= nops / PEAK_OPS[dtype] else "operations")
        tot["library_note"] = notes[(key[0], dtype)]
        log(f"[moe] {key[0]} {key[1]} {str(dtype)[6:]} ({key[3]}: w1 + w2, "
            f"{'serving' if key[3] == 'a' else 'prefill'} rows): kernel "
            f"{tot['ms']:.4f} ms ({nops / tot['ms'] / 1e9:.1f} TFLOP/s, "
            f"{nbytes / tot['ms'] / 1e9:.3f} TB/s), plain "
            f"{tot['plain_ms']:.4f}, bound "
            f"{tot['bound_ms']:.6f} ({tot['bound_by']}: {nbytes / 1e6:.2f} MB"
            f", {nops / 1e9:.3f} GFLOP), library "
            + (f"{tot['library_ms']:.4f}" if tot["library_ms"] is not None
               else f"null ({tot['library_note']})")
            + (f"; torch._grouped_mm on the pre-dequantized stack's "
               f"transpose (not a port path) {tot['deq_ms']:.4f}"
               if tot["deq_ms"] is not None else "") + f" ({card})")
    # bf16 fp weights at a width the 16-byte copies cannot take: the
    # CUDA-core kernel, held like the rest
    k, n = GMM_OFF_COPIES
    counts = GMM_ODD[2]
    x, dy, w, _, offs = gmm_case(counts, k, n, None, -1, torch.bfloat16,
                                 dev, SEED + 9)
    tc0 = gmm_tc_counts()
    got = grouped_matmul_fwd(x, w, offs)
    dx = grouped_matmul_bwd(dy, w, offs, None, k, torch.bfloat16)
    torch.cuda.synchronize()
    held = [kernel_error(a, b, torch.bfloat16)[1] if bool(
        torch.isfinite(a).all()) else float("inf") for a, b in (
        (got, grouped_matmul_reference(x, w, offs)),
        (dx, grouped_matmul_dx_reference(dy, w, offs, None, k,
                                         torch.bfloat16)))]
    log(f"[moe] gmm fp bf16 at K {k}, N {n} (rows {counts}): CUDA-core "
        f"kernel (tensor-core launches {gmm_tc_counts()} before "
        f"{tc0}); held fwd / dx {held} (tol {GMM_TOL[torch.bfloat16]})")
    if gmm_tc_counts() != tc0 or not max(held) <= GMM_TOL[torch.bfloat16]:
        raise AssertionError(f"bf16 grouped GEMM at K {k}, N {n}: "
                             f"tensor-core launches {gmm_tc_counts()} vs "
                             f"{tc0}, held {held}")
    return stats


def moe_model(cfg, dev, dtype=torch.float32):
    """``cfg``'s model on the card with numpy-seeded weights, in eval."""
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)

    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev,
                                 dtype=dtype)
    model.eval()
    return model


def dequantized_clone(model, weight_dtype, group_size):
    """The reference's ``_dequantized_clone``: a copy of ``model`` whose
    stacks the serving conversion quantizes (qkv and output projections,
    the expert stacks) hold their quantize -> dequantize image, so its
    full forward computes what the quantized step computes."""
    from paddle_tpu_torch.inference.quantize import quantize_weight
    from paddle_tpu_torch.ops.grouped_matmul import dequantize_grouped_weight
    from paddle_tpu_torch.ops.quant_matmul import dequantize_weight

    clone = copy.deepcopy(model)
    with torch.no_grad():
        for layer in clone.gpt.layers:
            for p in (layer.attn.qkv_proj.weight, layer.attn.out_proj.weight):
                qw = quantize_weight(p, weight_dtype, group_size)
                p.copy_(dequantize_weight(qw["q"], qw["s"], k=p.shape[0]))
            for p in (layer.mlp.w1, layer.mlp.w2):
                qw = quantize_weight(p, weight_dtype, group_size)
                p.copy_(dequantize_grouped_weight(qw["q"], qw["s"],
                                                  k=p.shape[1]))
    return clone


class RouterFlips:
    """Stands in for a predictor's unified step. At call ``at`` it runs the
    step once more with the plain grouped GEMMs on copies of the pools
    first, and counts the router choices (valid token, choice, layer) in
    which the kernel run and the twin run differ; ``rows`` keeps both
    runs' logits rows (fp32) of the lanes that emit a token and whose
    tokens took the same experts in every layer, and the number of lanes
    left out for a flip. Both runs of call ``at`` are eager (the router's
    choices are recorded in Python)."""

    def __init__(self, sp, at):
        self.sp, self.step, self.at, self.calls = sp, sp._unified, at, 0
        self.flips = self.choices = self.rows = None
        # the unified step, under any StepRecord
        self.emit_at = unified_of(self.step).arg_names.index("emit_mask")
        sp._unified = self

    def __call__(self, *args, **kw):
        self.calls += 1
        if self.calls != self.at:
            return self.step(*args, **kw)
        from paddle_tpu_torch.ops import paged_attention

        n_pool = 4 if self.sp.kv_quant else 2
        twin_args = list(args)
        twin_args[11:11 + n_pool] = [p.clone() for p in args[11:11 + n_pool]]
        ragged = paged_attention.ragged_paged_attention
        before = ragged.launches
        eager = unified_of(self.step).eager
        with record_routes() as twin, moe_twins():
            twin_out = eager(*twin_args, **kw)
        ragged.launches = before       # the comparison's launches
        with record_routes() as kern:
            out = eager(*args, **kw)
        tok_slot = args[2]
        valid = (tok_slot >= 0)[:, None]
        diff = [(a != b) & valid for a, b in zip(kern, twin)]
        self.flips = sum(int(d.sum()) for d in diff)
        self.choices = int(valid.sum()) * kern[0].shape[1] * len(kern)
        moved = set(tok_slot[torch.stack([d.any(-1) for d in diff]).any(
            0)].tolist())
        emit = args[self.emit_at].tolist()
        slots = [i for i, e in enumerate(emit) if e and i not in moved]
        self.rows = (out[1][slots].float(), twin_out[1][slots].float(),
                     len(moved))
        return out


def phase_moe_serve(cfg, dev, card, dense_step_ms):
    """``ServingPredictor`` on GPT-125M with 4 experts, top-2, the phase-6
    requests in fp32: (i) cf 4.0 against the full-forward oracle, (ii) cf
    1.25 against the same step built from the plain grouped GEMM (router
    flips of one step counted), (iii) int8 and (iv) int4 g128 weights (the
    expert stacks and the qkv / output projections) at cf 4.0 against the
    full forward over the dequantized weights; launches a step; the router
    stats of one eager probe; then bf16 step times beside phase 6's dense
    step, one profiled run, and the weight bytes. Returns the served runs'
    grouped-GEMM launches by weight type."""
    from paddle_tpu_torch.inference.quantize import serving_weight_bytes
    from paddle_tpu_torch.models.gpt import serving_params

    early, late = requests(cfg)
    model = moe_model(cfg, dev)
    mcfg = model.config
    launches = {"fp": 0, "int8": 0, "int4": 0}
    for label, cf, quant in MOE_SERVE:
        mcfg.moe_capacity_factor = cf
        sp = quant_predictor(model, mcfg, quant, dev)
        served_logits = StepRecord(sp)
        flips = RouterFlips(sp, at=20) if label.startswith("ii ") else None
        reset_counts()
        t0 = time.perf_counter()
        reqs = serve(sp, early, late)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ragged_n, qmm, gmm = read_counts()[1], qmm_counts(), gmm_counts()
        mega_n = sum(mega_counts())
        steps = sp.steps
        bits = quant.get("weight_dtype", "fp")
        outs = [list(r.output_ids) for r in reqs]
        sk_n = gmm_sk_count()
        log(f"[moe] serve ({label}) fp32: {steps} steps, grouped-GEMM "
            f"launches {gmm} ({sk_n} on the skinny route), ragged "
            f"{ragged_n}, weight-only GEMM {qmm}, mega {mega_n}, {wall:.3f} "
            "s wall")
        per_step = 2 * cfg.num_layers
        want_qmm = per_step * steps if quant else 0
        if not (steps and gmm[bits] == per_step * steps
                and sum(gmm.values()) == gmm[bits] and sk_n == 0
                and ragged_n == steps * cfg.num_layers and mega_n == 0
                and sum(qmm.values()) == want_qmm
                and (not quant or qmm[bits] == want_qmm)):
            raise AssertionError(f"({label}) launches: grouped {gmm}, ragged "
                                 f"{ragged_n}, GEMM {qmm}, mega {mega_n} "
                                 f"over {steps} steps")
        launches[bits] += gmm[bits]
        if flips is not None:
            with moe_twins():
                want = [list(r.output_ids) for r in serve(
                    quant_predictor(model, mcfg, quant, dev), early, late)]
            same = sum(a == b for o, w in zip(outs, want)
                       for a, b in zip(o, w))
            log(f"[moe] serve ({label}) fp32: equal to the streams of the "
                f"step built from the plain grouped GEMM in {same} of "
                f"{sum(map(len, want))} tokens; router choices of step "
                f"{flips.at}, kernel vs plain: {flips.flips} flips in "
                f"{flips.choices}")
            if outs != want:
                raise AssertionError(f"({label}) kernel streams differ from "
                                     "the plain grouped GEMM's")
            continue
        oracle = (dequantized_clone(model, quant["weight_dtype"],
                                    quant.get("weight_quant_group_size", -1))
                  if quant else model)
        ties, logit_err = check_against_oracle(oracle, reqs,
                                               served_logits.rows, dev)
        log(f"[moe] serve ({label}) fp32: greedy streams match the full "
            f"forward{' over the dequantized weights' if quant else ''} "
            f"({sum(map(len, outs))} tokens, {ties} near ties), logits "
            f"max_abs_err {logit_err:.3e} (tol {LOGIT_TOL}); "
            f"{len({t for o in outs for t in o})} distinct tokens")
        del oracle
    # the router's stats on one eager probe (request 0's prompt)
    ids = torch.tensor([early[0]], device=dev)
    for cf in (4.0, 1.25):
        mcfg.moe_capacity_factor = cf
        with torch.no_grad():
            model(ids)
        st = [layer.mlp.router_stats for layer in model.gpt.layers]
        log(f"[moe] router stats, eager probe on {ids.shape[1]} tokens at cf "
            f"{cf}: load imbalance (largest expert share x E) per layer "
            f"{[round(float(s['load'].max()) * 4, 3) for s in st]}, drop "
            f"rate per layer {[round(float(s['drop_rate']), 4) for s in st]}")
    # bf16 at cf 1.25: the MoE step beside phase 6's dense step, one
    # profiled run, and the weight bytes per configuration; every grouped
    # GEMM of these runs on the tensor-core kernel
    walls = []
    reset_counts()
    for run in range(1 + BF16_RUNS):
        sp16 = quant_predictor(model, mcfg, {}, dev, dtype=torch.bfloat16)
        got = timed_serve(sp16, early, late)
        outs16 = [list(r.output_ids) for r in got["reqs"]]
        if run:
            walls.append(got)
        if sum(map(len, outs16)) != MAX_NEW * len(outs16):
            raise AssertionError("bf16 MoE serving: malformed streams")
    gmm, tc = gmm_counts(), gmm_tc_counts()
    want = 2 * cfg.num_layers * sp16.steps * (1 + BF16_RUNS)
    if gmm["fp"] != want or tc != [want, 0] or sum(gmm.values()) != want:
        raise AssertionError(f"bf16 MoE serving: grouped-GEMM launches {gmm}"
                             f", tensor-core {tc}, want {want}")
    log(f"[moe] serve (cf 1.25) bf16: {sp16.steps} steps per run, "
        f"{tc[0]} grouped-GEMM launches in {1 + BF16_RUNS} runs, all on the "
        f"tensor-core kernel; median of {BF16_RUNS} runs from the end of "
        f"the first step: mean step {median_run(walls)['step_ms']:.3f} ms "
        f"beside the dense GPT-125M bf16 step of phase 6, "
        f"{dense_step_ms:.3f} ms (runs: {step_list(walls)} ms) ({card})")
    profile_serve(quant_predictor(model, mcfg, {}, dev, dtype=torch.bfloat16),
                  early, late, card, "[moe] (cf 1.25)")
    launches["tc"] = tc[0]
    launches["serve_bf16"] = timed(moe_serve_quant_bf16, model, mcfg, cfg,
                                   dev, card, launches)
    sizes = {"fp32": serving_weight_bytes(serving_params(model)),
             "bf16": serving_weight_bytes(sp16.params)}
    del sp16
    for name, quant in (("int8", dict(weight_dtype="int8")),
                        ("int4 g128", dict(weight_dtype="int4",
                                           weight_quant_group_size=128))):
        sizes[name] = serving_weight_bytes(quant_predictor(
            model, mcfg, quant, dev).params)
    log("[moe] serving_weight_bytes: " + ", ".join(
        f"{k} {v / 1e6:.2f} MB" for k, v in sizes.items())
        + f" ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        "parameters)")
    return launches


def moe_serve_quant_bf16(model, mcfg, cfg, dev, card, launches):
    """``MOE_SERVE_BF16``: the MoE GPT-125M served in bf16 at cf 1.25 with
    int8 and int4 g128 expert stacks, every grouped GEMM on the skinny
    route (24 a step); one step held against the same step with the plain
    grouped GEMM (router flips counted), the mean step of
    ``MOE_QUANT_RUNS`` runs and one profiled run.
    Adds the launches to ``launches``; returns the figures by label."""
    early, late = requests(cfg)
    bf16, out = torch.bfloat16, {}
    mcfg.moe_capacity_factor = 1.25
    for label, quant in MOE_SERVE_BF16:
        bits = quant["weight_dtype"]
        sp = quant_predictor(model, mcfg, quant, dev, dtype=bf16)
        cmp = RouterFlips(sp, at=20)
        reset_counts()
        outs = [list(r.output_ids) for r in serve(sp, early, late)]
        torch.cuda.synchronize()
        gmm, sk, steps = gmm_counts(), gmm_sk_count(), sp.steps
        qmm, qtc = qmm_counts(), qmm_tc_count()
        want = 2 * cfg.num_layers * steps
        if not (steps and gmm[bits] == want == sum(gmm.values()) == sk
                and sum(map(len, outs)) == MAX_NEW * len(outs)):
            raise AssertionError(f"bf16 MoE ({label}): grouped-GEMM launches "
                                 f"{gmm}, skinny {sk}, want {want} over "
                                 f"{steps} steps")
        # wqkv and wo quantize too: 24 weight-only GEMMs a step, every one
        # on the tensor-core route (int8 and int4 alike); the step
        # RouterFlips replays with the plain grouped GEMM runs them once more
        if not (qtc == qmm[bits] == sum(qmm.values())
                == want + 2 * cfg.num_layers):
            raise AssertionError(f"bf16 MoE ({label}): weight-only GEMM "
                                 f"launches {qmm}, {qtc} on the tensor-core "
                                 f"route, want {want} over {steps} steps "
                                 "and 24 for the replayed step")
        got, ref, moved = cmp.rows
        err = (got - ref).abs().amax(-1)
        held = (err / ref.abs().amax(-1).clamp_min(1e-30)).max().item() \
            if len(got) else float("inf")
        top2 = ref.topk(2, -1).values
        off = int(((got.argmax(-1) != ref.argmax(-1))
                   & (top2[:, 0] - top2[:, 1] > 2 * err)).sum())
        log(f"[moe] serve ({label}) bf16: {steps} steps, {sk} grouped-GEMM "
            f"launches, all on the skinny route, {qtc} weight-only GEMM "
            f"launches (wqkv, wo), all on the tensor-core route; step "
            f"{cmp.at} vs the same "
            f"step with the plain grouped GEMM: router {cmp.flips} flips in "
            f"{cmp.choices}, {len(got)} emitting lanes held (logits error "
            f"{held:.3e} of the row's max, tol {MOE_BF16_STEP_TOL}; greedy "
            f"token off the twin's argmax past a near tie in {off}), {moved}"
            " lanes left out for a flip")
        if not held <= MOE_BF16_STEP_TOL or off:
            raise AssertionError(f"bf16 MoE ({label}): step {cmp.at} logits "
                                 f"{held} of the row's max (tol "
                                 f"{MOE_BF16_STEP_TOL}), {off} greedy tokens "
                                 "off the plain step's argmax")
        launches[bits] += gmm[bits]
        walls = []
        reset_counts()
        for _ in range(MOE_QUANT_RUNS):
            sp = quant_predictor(model, mcfg, quant, dev, dtype=bf16)
            walls.append(timed_serve(sp, early, late)["step_ms"])
        gmm, qmm = gmm_counts(), qmm_counts()
        if not (gmm[bits] == sum(gmm.values()) == gmm_sk_count()
                and qmm[bits] == sum(qmm.values()) == qmm_tc_count()):
            raise AssertionError(f"bf16 MoE ({label}) timed runs: "
                                 f"grouped-GEMM launches {gmm}, skinny "
                                 f"{gmm_sk_count()}; weight-only GEMM {qmm}, "
                                 f"tensor-core {qmm_tc_count()}")
        launches[bits] += gmm[bits]
        sp = quant_predictor(model, mcfg, quant, dev, dtype=bf16)
        prof = profile_serve(sp, early, late, card, f"[moe] ({label})")
        st = dict(step_ms=walls, steps=sp.steps, held=held, flips=cmp.flips)
        if prof is not None:
            groups, busy, steps = prof
            st.update(busy_ms=busy / 1e3 / steps,
                      gmm_ms=groups["grouped GEMM"][0] / 1e3 / steps,
                      qmm_ms=groups["weight-only GEMM"][0] / 1e3 / steps)
        log(f"[moe] serve ({label}) bf16: mean step (from the end of the "
            "first step) "
            + " / ".join(f"{w:.3f}" for w in walls) + " ms; device busy "
            + (f"{st['busy_ms']:.4f} ms a step, the grouped GEMM "
               f"{st['gmm_ms']:.4f} and the weight-only GEMM "
               f"{st['qmm_ms']:.4f} of it" if prof else "not measured")
            + f" ({card})")
        out[label] = st
    return out


def phase_moe_forward(cfg, dev, card):
    """The bf16 MoE GPT-125M full forward (``GPTForCausalLM``, eval, cf
    1.25) on ids ``MOE_FWD_IDS``: 24 grouped-GEMM launches a forward (all
    on the tensor-core kernel where the package has one), finite logits of
    the expected shape, layer 0's MoE FFN on the embedded ids against its
    plain version (the same routes: held as ``BF16_GRAD_TOL`` of the
    output's max), the router choices of every layer against the same
    forward with the plain grouped GEMM (none may differ in layer 0, whose
    input is the same) and the share of next-token argmaxes the two
    forwards share, the median wall of ``BF16_RUNS`` forwards after a
    warm-up, and one profiled forward (device time by kernel group).
    Returns the figures."""
    from paddle_tpu_torch.models.moe import moe_ffn
    from paddle_tpu_torch.ops import grouped_matmul

    model = moe_model(cfg, dev, dtype=torch.bfloat16)
    ids = torch.from_numpy(np.random.RandomState(SEED + 6).randint(
        0, cfg.vocab_size, MOE_FWD_IDS)).to(dev)
    walls = []
    with torch.no_grad():
        model(ids)                     # warm-up: builds and caches
        torch.cuda.synchronize()
        reset_counts()
        for _ in range(BF16_RUNS):
            t0 = time.perf_counter()
            logits = model(ids)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        gmm, tc = gmm_counts(), gmm_tc_counts()
        prof = profile_run(lambda: model(ids), card, "[moe] full forward",
                           lambda: f"ids {list(MOE_FWD_IDS)}")
        with record_routes() as kern_routes:
            model(ids)
        with record_routes() as plain_routes, moe_twins():
            plain = model(ids)
        mlp = model.gpt.layers[0].mlp
        x0 = model.gpt.embeddings(ids).reshape(-1, cfg.hidden_size)
        x0 = torch.nn.functional.layer_norm(x0, x0.shape[-1:])
        ffn = [moe_ffn(x0, mlp.gate_weight, mlp.w1, mlp.b1, mlp.w2, mlp.b2,
                       top_k=cfg.moe_top_k,
                       capacity_factor=cfg.moe_capacity_factor,
                       use_kernel=use)[0].float() for use in (None, False)]
    ffn_err = ((ffn[0] - ffn[1]).abs().max() / ffn[1].abs().max()).item()
    flips = [int((a != b).sum()) for a, b in zip(kern_routes, plain_routes)]
    per = 2 * cfg.num_layers
    # a package from before the tensor-core kernel (``--ab moe-forward`` on
    # an older checkout) counts none
    want_tc = ([per * BF16_RUNS, 0] if hasattr(grouped_matmul, "TC_TILES")
               else [0, 0])
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    wall = sorted(walls)[len(walls) // 2]
    shape = (*MOE_FWD_IDS, cfg.vocab_size)
    out = dict(ms=1e3 * wall, runs_ms=[1e3 * w for w in walls],
               launches=gmm["fp"] // BF16_RUNS, tc_launches=tc[0] // BF16_RUNS,
               argmax_agree=agree, layer0_ffn_err=ffn_err,
               route_flips=flips)
    if prof is not None:
        times, busy = prof
        out.update(busy_ms=busy / 1e3, gmm_ms=times["grouped GEMM"][0] / 1e3,
                   gmm_share=times["grouped GEMM"][0] / busy,
                   gmm_profiled_launches=times["grouped GEMM"][1])
    log(f"[moe] full forward bf16 ids {list(MOE_FWD_IDS)} (cf "
        f"{cfg.moe_capacity_factor}): logits {tuple(logits.shape)}, median "
        f"of {BF16_RUNS} {out['ms']:.3f} ms (runs: "
        f"{', '.join(f'{w:.3f}' for w in out['runs_ms'])}); grouped-GEMM "
        f"launches a forward {out['launches']} (tensor cores "
        f"{out['tc_launches']}); layer 0's MoE FFN vs plain {ffn_err:.3e} "
        f"of its max (tol {BF16_GRAD_TOL}); router choices differing from "
        f"the plain grouped GEMM's forward, per layer, of "
        f"{kern_routes[0].numel()}: {flips}; next-token argmax equal to it "
        f"in {agree:.4f} of positions" + (
            f"; profiled: grouped GEMM {out['gmm_ms']:.3f} ms of "
            f"{out['busy_ms']:.3f} ms device time ({out['gmm_share']:.3f}, "
            f"{out['gmm_profiled_launches']} launches)" if prof else "")
        + f" ({card})")
    if (tuple(logits.shape) != shape or not bool(torch.isfinite(
            logits).all()) or gmm["fp"] != per * BF16_RUNS
            or sum(gmm.values()) != gmm["fp"] or tc != want_tc
            or not ffn_err <= BF16_GRAD_TOL or flips[0]):
        raise AssertionError(f"MoE full forward: logits {tuple(logits.shape)}"
                             f", launches {gmm}, tensor-core {tc}, layer 0 "
                             f"FFN error {ffn_err}, router flips {flips}")
    return out


def phase_moe_grads(cfg, dev):
    """``loss.backward()`` through a 2-layer GPT-125M-width MoE model in
    fp32, the grouped-GEMM kernels against the plain versions for every
    gradient leaf (4 backward launches: two GEMMs a layer); then the input
    gradient through the two layers' MoE FFNs with int8 expert stacks in
    fp32 (``ptt_gmm_q_bwd``, 4 launches) and in bf16 (the dx route, 4
    launches; the fp32 drive's routing replayed), and the bf16 input
    gradient through layer 0's MoE FFN with fp stacks (the tensor-core dx).
    Returns (fp, int8) backward launches."""
    from dataclasses import replace

    from paddle_tpu_torch.inference.quantize import quantize_weight
    from paddle_tpu_torch.models.moe import moe_ffn

    mcfg = replace(cfg, num_layers=2)
    model = moe_model(mcfg, dev)
    model.train()
    ids = torch.from_numpy(np.random.RandomState(SEED + 4).randint(
        0, cfg.vocab_size, (2, 129))).to(dev)
    grads, counts = {}, None
    for kernel in (True, False):
        model.zero_grad(set_to_none=True)
        reset_counts()
        with contextlib.ExitStack() as stack:
            if not kernel:
                stack.enter_context(moe_twins())
            loss = _lm_loss(model, ids)
            loss.backward()
        torch.cuda.synchronize()
        if kernel:
            counts = gmm_counts()
        grads[kernel] = {n: p.grad for n, p in model.named_parameters()}
    errs = _grad_errors(grads[True], grads[False])
    worst = max(errs, key=errs.get)
    log(f"[moe] eager 2-layer GPT-125M-width MoE, ids [2, 128], fp32: "
        f"grouped-GEMM launches {counts}; kernel vs plain gradients: "
        f"{len(errs)} leaves, none None, worst {worst} {errs[worst]:.3e} of "
        f"its max |grad| (tol {GRAD_TOL}); expert w1 of layer 0 "
        f"{errs['gpt.layers.0.mlp.w1']:.3e}")
    if counts["fp_bwd"] != 4 or counts["fp"] != 4 or not errs[worst] <= \
            GRAD_TOL:
        raise AssertionError(f"MoE eager gradients: launches {counts}, "
                             f"worst error {errs[worst]}")
    layers = [layer.mlp for layer in model.gpt.layers]
    quant = [(quantize_weight(m.w1.detach(), "int8"),
              quantize_weight(m.w2.detach(), "int8")) for m in layers]
    x0 = model.gpt.embeddings(ids[:, :-1]).detach().reshape(
        -1, cfg.hidden_size)
    r = torch.from_numpy(np.random.RandomState(SEED + 5).standard_normal(
        x0.shape).astype(np.float32)).to(dev)
    dx, routes = {}, None
    for use_kernel in (None, False):
        x = x0.clone().requires_grad_()
        reset_counts()
        with record_routes() as seen:
            (int8_drive(x, layers, quant, cfg, use_kernel) * r).sum(
            ).backward()
        torch.cuda.synchronize()
        if use_kernel is None:
            counts, routes, n_dx = gmm_counts(), seen, gmm_dx_count()
        dx[use_kernel] = x.grad
    err = ((dx[None] - dx[False]).abs().max()
           / dx[False].abs().max()).item()
    log(f"[moe] input gradient through 2 layers of int8 expert stacks "
        f"({list(x0.shape)}, fp32): kernel vs plain {err:.3e} of its max "
        f"|grad| (tol {GRAD_TOL}); launches {counts}, on the dx route "
        f"{n_dx}")
    if (counts["int8_bwd"] != 4 or counts["int8"] != 4 or n_dx
            or not err <= GRAD_TOL):
        raise AssertionError(f"int8 MoE input gradient: launches {counts}, "
                             f"dx route {n_dx}, error {err}")
    int8_bwd = counts["int8_bwd"]
    # bf16: the same input gradient through int8 stacks quantized from the
    # bf16 weights, the fp32 drive's routing replayed in both runs: dx on
    # the dx route against the plain version
    err, counts, n_dx = bf16_int8_drive(x0, r, layers, cfg, routes)
    log(f"[moe] bf16 input gradient through 2 layers of int8 expert stacks "
        f"({list(x0.shape)}; the fp32 drive's routing): kernel vs plain "
        f"{err:.3e} of its max |grad| (tol {BF16_GRAD_TOL}); launches "
        f"{counts}, on the dx route {n_dx}")
    if (counts["int8_bwd"] != 4 or n_dx != 4
            or not err <= BF16_GRAD_TOL):
        raise AssertionError(f"bf16 int8 MoE input gradient: launches "
                             f"{counts}, dx route {n_dx}, error {err}")
    int8_bwd += counts["int8_bwd"]
    # bf16: the input gradient through layer 0's MoE FFN (its weights in
    # bf16; the routes are the same in both runs, computed from the same
    # x): dx through the tensor-core kernel against the plain version
    bf16, m = torch.bfloat16, layers[0]
    dx = {}
    for use_kernel in (None, False):
        x = x0.to(bf16).requires_grad_()
        reset_counts()
        out, _ = moe_ffn(x, *(t.detach().to(bf16) for t in (
            m.gate_weight, m.w1, m.b1, m.w2, m.b2)), top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, use_kernel=use_kernel)
        (out.float() * r).sum().backward()
        torch.cuda.synchronize()
        if use_kernel is None:
            counts, tc = gmm_counts(), gmm_tc_counts()
        dx[use_kernel] = x.grad.float()
    err = ((dx[None] - dx[False]).abs().max()
           / dx[False].abs().max()).item()
    log(f"[moe] bf16 input gradient through layer 0's MoE FFN "
        f"({list(x0.shape)}): kernel vs plain {err:.3e} of its max |grad| "
        f"(tol {BF16_GRAD_TOL}); launches {counts}, tensor-core {tc}")
    if tc != [2, 2] or counts["fp_bwd"] != 2 or not err <= BF16_GRAD_TOL:
        raise AssertionError(f"bf16 MoE input gradient: launches {counts}, "
                             f"tensor-core {tc}, error {err}")
    return 4 + tc[1], int8_bwd


def int8_drive(x, layers, quant, cfg, use_kernel):
    """``x`` through the MoE FFNs of ``layers`` (pre-LN residual blocks)
    with the int8 stacks ``quant`` [(w1, w2), ...], in ``x``'s dtype (the
    gate and biases cast to it); returns the output in fp32."""
    from paddle_tpu_torch.models.moe import moe_ffn

    y = x
    for m, (q1, q2) in zip(layers, quant):
        out, _ = moe_ffn(torch.nn.functional.layer_norm(y, y.shape[-1:]),
                         m.gate_weight.detach().to(x.dtype), q1,
                         m.b1.detach().to(x.dtype), q2,
                         m.b2.detach().to(x.dtype), top_k=cfg.moe_top_k,
                         capacity_factor=cfg.moe_capacity_factor,
                         use_kernel=use_kernel)
        y = y + out
    return y.float()


def bf16_int8_drive(x0, r, layers, cfg, routes):
    """The bf16 input gradient of ``(y * r).sum()`` through ``layers``' MoE
    FFNs with int8 stacks quantized from their bf16 weights, kernel route
    against ``use_kernel=False``, both on the expert choices ``routes``:
    (error over the plain gradient's max, grouped-GEMM launches of the
    kernel run, its dx-route launches)."""
    from paddle_tpu_torch.inference.quantize import quantize_weight

    bf16 = torch.bfloat16
    quant = [(quantize_weight(m.w1.detach().to(bf16), "int8"),
              quantize_weight(m.w2.detach().to(bf16), "int8"))
             for m in layers]
    dx = {}
    for use_kernel in (None, False):
        x = x0.to(bf16).requires_grad_()
        reset_counts()
        with replay_routes(routes):
            (int8_drive(x, layers, quant, cfg, use_kernel) * r).sum(
            ).backward()
        torch.cuda.synchronize()
        if use_kernel is None:
            counts, n_dx = gmm_counts(), gmm_dx_count()
        dx[use_kernel] = x.grad.float()
    err = ((dx[None] - dx[False]).abs().max()
           / dx[False].abs().max()).item()
    return err, counts, n_dx


def phase_attention_routing(dev):
    """The repaired routing on the card: attention the flash kernels are
    not built for runs plain ``_sdpa_ref`` instead of raising — an eager
    2-layer model at gpt3-760m's width (16 heads of 96) in fp32 and an fp64
    GPT-125M forward (no kernel is built for fp64), each equal to the plain
    path's logits, with no flash launch; one d 96 ``gpt_spmd`` training
    step; then
    ``scaled_dot_product_attention``'s routes since the mask branch: those
    to the kernels held against their plain twin, those to plain
    attention equal to ``_sdpa_ref``."""
    from dataclasses import replace

    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS

    ids = torch.from_numpy(np.random.RandomState(SEED + 6).randint(
        0, 50304, (2, 256))).to(dev)
    for label, cfg, dtype in (
            ("gpt3-760m width, 2 layers (d 96), fp32",
             replace(GPT_CONFIGS["gpt3-760m"], num_layers=2), torch.float32),
            ("GPT-125M fp64", GPT_CONFIGS["gpt3-125m"], torch.float64)):
        cfg = replace(cfg)
        model = moe_model(cfg, dev, dtype)
        with torch.no_grad():
            reset_counts()
            logits = model(ids)
            torch.cuda.synchronize()
            flash_n = read_counts()[0]
            cfg.use_flash_attention = False
            plain = model(ids)
        same = bool(torch.equal(logits, plain))
        log(f"[moe] routing: {label} eager forward on ids [2, 256]: logits "
            f"{tuple(logits.shape)} {logits.dtype}, finite "
            f"{bool(torch.isfinite(logits).all())}, equal to the plain "
            f"path's {same}, flash launches {flash_n}")
        if flash_n or not same or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"routing ({label}): flash {flash_n}, "
                                 f"equal {same}")
        del model
    cfg = replace(GPT_CONFIGS["gpt3-760m"], num_layers=2)
    step, params, mom, (sid, labels) = gpt_spmd.build_spmd_train_step(
        cfg, batch_size=2, seq_len=256, num_micro=1, lr=1e-3, device=dev)
    reset_counts()
    params, mom, loss = step(params, mom, sid, labels)
    torch.cuda.synchronize()
    log(f"[moe] routing: gpt_spmd step at gpt3-760m width (d 96), 2 layers, "
        f"b 2, s 256, fp32: loss {loss.item():.6f}, flash launches fwd/bwd "
        f"{read_counts()[0]}/{bwd_count()}")
    if not np.isfinite(loss.item()) or read_counts()[0] or bwd_count():
        raise AssertionError("d 96 training step did not run plain attention")
    # the routes of the mask branch: bf16 d 64 calls the kernels take go to
    # them causal or not, unmasked or with a mask that streams; a mask that
    # does not, and dropout, go to _sdpa_ref
    from paddle_tpu_torch.nn.functional import (
        scaled_dot_product_attention as sdpa)
    from paddle_tpu_torch.nn.functional.attention import _sdpa_ref
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_reference, normalize_mask)

    shape = (2, 256, 256, 12, 12, 64, False)
    q, k, v = flash_inputs(shape, torch.bfloat16, dev, SEED + 7)
    pad = torch.zeros(2, 1, 1, 256, device=dev)
    pad[1, ..., 100:] = -1e9
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, kw, want in (
            ("non-causal", {}, (1, 0)),
            ("causal", dict(is_causal=True), (1, 0)),
            ("key-padding mask [b, 1, 1, s]", dict(attn_mask=pad), (1, 1)),
            ("bool mask [s, s]", dict(attn_mask=torch.ones(
                256, 256, dtype=torch.bool, device=dev).tril()), (1, 1)),
            ("mask [b, hq, s, 1]", dict(attn_mask=torch.zeros(
                2, 12, 256, 1, device=dev)), (0, 0)),
            ("dropout 0.1", dict(dropout_p=0.1, generator=gen), (0, 0))):
        reset_counts()
        with torch.no_grad():
            out = sdpa(q, k, v, **kw)
            torch.cuda.synchronize()
            got = (read_counts()[0], branch_counts()["fwd_mask"])
            mask, causal = kw.get("attn_mask"), kw.get("is_causal", False)
            if want[0]:     # the kernels: held against their plain twin
                ref = flash_attention_reference(
                    q, k, v, causal=causal, mask=None if mask is None
                    else normalize_mask(mask, q, 256))[0]
                err = kernel_error(out, ref, torch.bfloat16)[1]
            elif "dropout_p" not in kw:     # plain attention: the same op
                err = 0.0 if torch.equal(out, _sdpa_ref(
                    q, k, v, mask=mask, causal=causal)) else float("inf")
            else:
                err = 0.0
        log(f"[moe] routing: sdpa bf16 d 64 {label}: flash launches "
            f"{got[0]} (masked {got[1]}), want {want}; held against "
            + ("the kernels' plain twin" if want[0] else "_sdpa_ref (equal)")
            + f" {err:.3e} (tol {KERNEL_TOL[torch.bfloat16]})")
        if got != want or not err <= KERNEL_TOL[torch.bfloat16] or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"routing ({label}): launches {got}, "
                                 f"err {err}")


# -- phase 15 ---------------------------------------------------------------

# the phase-6 requests in 14 pages of 64 tokens: two preemptions and one
# copy-on-write copy (the schedule is count-driven, the same for every form)
CAPTURE_PAGES = 14
# (label, config fields, predictor fields, dtype): every unified form
CAPTURE_FORMS = (
    ("per-op fp32", {}, {}, torch.float32),
    ("per-op bf16", {}, {}, torch.bfloat16),
    ("per-op fp16", {}, {}, torch.float16),
    ("int8 + int8 KV (bf16)", dict(weight_dtype="int8"),
     dict(kv_cache_dtype="int8"), torch.bfloat16),
    ("int4 g128 + int8 KV (bf16)", dict(weight_dtype="int4",
                                 weight_quant_group_size=128),
     dict(kv_cache_dtype="int8"), torch.bfloat16),
    ("mega (bf16)", {}, dict(mega_decode=True), torch.bfloat16),
    ("MoE (bf16)", dict(MOE, moe_capacity_factor=1.25), {},
     torch.bfloat16))
CAPTURE_TIMED = ("per-op bf16", "mega (bf16)", "MoE (bf16)")
CAPTURE_RUNS = 5


class EagerStep:
    """Stands in for a predictor's unified step and runs every call op by
    op (``UnifiedStep.eager``, never captured): phase 15's baseline."""

    def __init__(self, sp):
        self.step = sp._unified
        sp._unified = self

    @property
    def trace_count(self):
        return self.step.trace_count

    def __call__(self, *args):
        return self.step.eager(*args)


def capture_form_predictor(label, models, dev, engine, **kw):
    """Form ``label``'s predictor: ``engine`` "captured" is the default
    (the captured step, the async engine), "eager" the synchronous engine
    on :class:`EagerStep`."""
    _, quant, fields, dtype = next(f for f in CAPTURE_FORMS
                                   if f[0] == label)
    model = models["moe" if "moe_experts" in quant else "dense"]
    quant = {k: v for k, v in quant.items() if k not in MOE}
    sp = quant_predictor(model, model.config, quant, dev, dtype=dtype,
                         async_engine=engine == "captured", **fields, **kw)
    if engine == "eager":
        EagerStep(sp)
    return sp


def capture_launch_check(label, sp, cfg, bits):
    """The launches one served run of form ``label`` (weights ``bits``,
    ``None`` for fp) must have made, every step's counted once, replays
    included: returns them, raises if off."""
    from paddle_tpu_torch.ops import fused_mlp

    steps, n = sp.steps, sp.steps * cfg.num_layers
    ragged_n, qmm, gmm = read_counts()[1], qmm_counts(), gmm_counts()
    attn_n, mlp_n = mega_counts()
    fused = sum(f.launches for f in (fused_mlp.ln_fwd, fused_mlp.gelu_fwd))
    want = dict(ragged=0 if sp.mega_decode else n,
                mega=(n, n) if sp.mega_decode else (0, 0),
                gmm=2 * n if sp.config.moe_experts else 0,
                qmm=0)
    if bits:
        want["qmm"] = (2 if sp.config.moe_experts else 4) * n
    got = dict(ragged=ragged_n, mega=(attn_n, mlp_n),
               gmm=sum(gmm.values()), qmm=sum(qmm.values()))
    if got != want or not steps or fused or (bits and qmm[bits] != want[
            "qmm"]):
        raise AssertionError(f"({label}) launches {got}, want {want} over "
                             f"{steps} steps (fused {fused})")
    return got


def step_launches(sp) -> dict:
    """The launches one unified step of ``sp`` makes by kernel group
    (:func:`group_launches`): the attention kernels 12, the mega pair 24,
    the grouped GEMM 24 (MoE), the weight-only GEMM 48 (24 with MoE)."""
    cfg, n = sp.config, sp.config.num_layers
    quant = isinstance(sp.params["layers"]["wqkv"], dict)
    return {"ragged kernel": 0 if sp.mega_decode else n,
            "paged decode kernel": 0,
            "mega kernels": 2 * n if sp.mega_decode else 0,
            "grouped GEMM": 2 * n if cfg.moe_experts else 0,
            "weight-only GEMM": ((2 if cfg.moe_experts else 4) * n
                                 if quant else 0)}


def phase_captured(model, cfg, moe_cfg, dev, card):
    """15. Every unified form served on the captured step with the async
    engine (the defaults) beside the synchronous engine on the eager step
    (:class:`EagerStep`): the phase-6 requests in ``CAPTURE_PAGES`` pages
    (two preemptions, one copy-on-write copy); the streams equal token for
    token, one capture over the run, the launches of every step counted
    once (ragged launches = steps x 12 on the per-op forms), no twin route.
    Then the bf16 per-op, mega and MoE runs timed in turns (median of
    ``CAPTURE_RUNS`` each, from the end of the first step: the capture
    happens in it) and one profiled run of each engine. Returns the
    captured runs' launches by form and the timings."""
    from dataclasses import replace

    from paddle_tpu_torch import ops

    early, late = requests(cfg)
    models = {"dense": model, "moe": moe_model(
        replace(moe_cfg, moe_capacity_factor=1.25), dev)}
    launches, timing = {}, {}
    for label, *_ in CAPTURE_FORMS:
        runs = {}
        for engine in ("captured", "eager"):
            if ops.twin_routes():
                raise AssertionError(f"{ops.twin_routes()} twin routes")
            sp = capture_form_predictor(label, models, dev, engine,
                                        num_pages=CAPTURE_PAGES)
            reset_counts()
            reqs = serve(sp, early, late)
            torch.cuda.synchronize()
            got = capture_launch_check(label, sp, sp.config, next(
                f[1].get("weight_dtype") for f in CAPTURE_FORMS
                if f[0] == label))
            tel = sp.telemetry()
            runs[engine] = (sp, [list(r.output_ids) for r in reqs], tel, got)
            if ops.twin_routes():
                raise AssertionError(f"({label}, {engine}) ran "
                                     f"{ops.twin_routes()} plain twins")
        (sp, outs, tel, got), (sp_e, outs_e, tel_e, _) = (runs["captured"],
                                                          runs["eager"])
        same = sum(a == b for o, w in zip(outs, outs_e) for a, b in zip(o, w))
        log(f"[capture] {label}: {sp.steps} steps ({sp_e.steps} eager), "
            f"captures {sp.decode_trace_count} (eager step "
            f"{sp_e.decode_trace_count}), launches {got}, preemptions "
            f"{tel['serving_preemptions']:.0f}, CoW copies "
            f"{tel['kv_cow_copies']:.0f}, prefix-hit tokens "
            f"{tel['kv_prefix_hit_tokens']:.0f}, hard syncs "
            f"{sp.hard_syncs} ({sp_e.hard_syncs} sync), steady hits "
            f"{sp.steady_hits}, step_gap_frac {sp.step_gap_frac:.3f} "
            f"({sp_e.step_gap_frac:.3f} sync), host_ms_per_step "
            f"{sp.host_ms_per_step:.3f} ({sp_e.host_ms_per_step:.3f} sync); "
            f"streams equal to the eager sync engine's in {same} of "
            f"{sum(map(len, outs_e))} tokens")
        if outs != outs_e or sum(map(len, outs)) != MAX_NEW * len(outs):
            raise AssertionError(f"({label}) captured async streams differ "
                                 "from the eager sync engine's")
        if sp.decode_trace_count != 1 or sp_e.decode_trace_count != 0:
            raise AssertionError(f"({label}) captures {sp.decode_trace_count}"
                                 f" (eager {sp_e.decode_trace_count})")
        if (sp.steps != sp_e.steps or tel["serving_preemptions"] < 1
                or tel["kv_cow_copies"] < 1
                or tel["serving_preemptions"] != tel_e["serving_preemptions"]):
            raise AssertionError(f"({label}) churn: {sp.steps} / "
                                 f"{sp_e.steps} steps, preemptions "
                                 f"{tel['serving_preemptions']}, CoW "
                                 f"{tel['kv_cow_copies']}")
        counts = unified_of(sp._unified).replay_counts
        replay = {k: v for k, v in (counts[0] if counts else {}).items()
                  if v}
        log(f"[capture] {label}: one replay launches {replay}")
        launches[label] = dict(got, replay=replay)
        del sp, sp_e, runs
    # the bf16 A/B: captured + async vs eager + sync, in turns, each run a
    # fresh predictor on the default pool (phase 6's runs)
    for label in CAPTURE_TIMED:
        walls = {"captured": [], "eager": []}
        for run in range(CAPTURE_RUNS):
            for engine in (("captured", "eager") if run % 2
                           else ("eager", "captured")):
                sp = capture_form_predictor(label, models, dev, engine)
                walls[engine].append(timed_serve(sp, early, late))
        st = {}
        for engine, rows in walls.items():
            med = median_run(rows)
            st[engine] = dict(step_ms=med["step_ms"], tok_s=med["tok_s"],
                              gap=med["gap"], host_ms=med["host_ms"],
                              runs=[r["step_ms"] for r in rows])
            log(f"[capture] {label} {engine}: mean step "
                f"{med['step_ms']:.3f} ms (median of {CAPTURE_RUNS}; runs "
                f"{step_list(rows)} ms), {med['tok_s']:.1f} tokens/s, "
                f"step_gap_frac {med['gap']:.3f}, host_ms_per_step "
                f"{med['host_ms']:.3f} ({card})")
        for engine in ("captured", "eager"):
            sp = capture_form_predictor(label, models, dev, engine)
            groups, busy, steps = profile_serve(
                sp, early, late, card, f"[capture] ({label}, {engine})",
                top=10, need=True)
            seen = {g: c for g, (_, c) in groups.items() if c}
            # every step of the window launches what one replay holds
            want = {g: steps * n for g, n in step_launches(sp).items()}
            got = {g: groups[g][1] for g in want}
            if got != want:
                raise AssertionError(f"({label}, {engine}) the trace's "
                                     f"launches {got} over {steps} steps, "
                                     f"want {want}")
            st[engine].update(busy_ms=busy / 1e3 / steps, prof_steps=steps,
                              kernels=seen)
            log(f"[capture] ({label}, {engine}) the profiler's kernel "
                f"groups over {steps} steps ({steps * cfg.num_layers} "
                f"layer-steps): {seen}, as many as the steps launch; device"
                f" busy {busy / 1e3 / steps:.4f} ms a step")
        log(f"[capture] {label}: captured + async {st['captured']['step_ms']:.3f}"
            f" ms a step vs eager + sync {st['eager']['step_ms']:.3f} ms: "
            f"{st['eager']['step_ms'] / st['captured']['step_ms']:.2f}x "
            f"({card})")
        timing[label] = st
    return launches, timing


# -- phase 16 ---------------------------------------------------------------

# (label, config fields, predictor fields, dtype, the spec runs of the form:
# (label, predictor fields)) served on GPT-125M at max_batch 8, page 64,
# chunk 16 over the motif requests; draft_layers 3 = 12 // 4 (the
# reference's bench_serve spec leg)
SPEC_DRAFT_LAYERS = 3
SPEC_MODEL = dict(draft_source="model", draft_layers=SPEC_DRAFT_LAYERS)
SPEC_FORMS = (
    ("per-op fp32", {}, {}, torch.float32,
     tuple((f"n-gram k {k}", dict(spec_decode_k=k)) for k in (1, 2, 4))),
    ("per-op bf16", {}, {}, torch.bfloat16,
     tuple((f"n-gram k {k}", dict(spec_decode_k=k)) for k in (1, 2, 4))
     + (("model k 4", dict(spec_decode_k=4, **SPEC_MODEL)),)),
    ("mega bf16", {}, dict(mega_decode=True), torch.bfloat16,
     (("n-gram k 4", dict(spec_decode_k=4)),
      ("model k 4", dict(spec_decode_k=4, **SPEC_MODEL)))),
    ("int8 g128 + int8 KV bf16", dict(weight_dtype="int8",
                                      weight_quant_group_size=128),
     dict(kv_cache_dtype="int8"), torch.bfloat16,
     (("n-gram k 4", dict(spec_decode_k=4)),)),
    ("int4 g128 + int8 KV bf16", dict(weight_dtype="int4",
                                      weight_quant_group_size=128),
     dict(kv_cache_dtype="int8"), torch.bfloat16,
     (("n-gram k 4", dict(spec_decode_k=4)),)),
)
SPEC_RUNS = 3
# the runs profiled: a window's launches by kernel group must equal the
# counters' gain
SPEC_PROFILED = (("per-op bf16", "n-gram k 4"), ("per-op bf16", "model k 4"),
                 ("mega bf16", "n-gram k 4"), ("mega bf16", "model k 4"))


def motif_requests(cfg):
    """Phase 6's eight requests (the same lengths, the late ones sharing
    the first one's pages) with every prompt tiled from a 4-token motif
    (the reference's ``bench_serve`` spec workload)."""
    rng = np.random.RandomState(SEED + 2)

    def tile(n):
        return np.tile(rng.randint(0, cfg.vocab_size, 4),
                       (n + 3) // 4)[:n].tolist()

    a = tile(100)
    early = [a, tile(5), tile(37), tile(150), tile(300), tile(64)]
    late = [a + tile(20), a[:80] + tile(40)]
    return early, late


def spec_predictor(model, cfg, form, dev, fields=None):
    """The predictor of ``form`` (a ``SPEC_FORMS`` label) with the spec
    ``fields`` (none: spec off), on the defaults otherwise (captured step,
    async engine, page 64, chunk 16)."""
    _, quant, pfields, dtype, _ = next(f for f in SPEC_FORMS
                                       if f[0] == form)
    return quant_predictor(model, cfg, quant, dev, dtype=dtype,
                           **pfields, **(fields or {}))


def served_oracle(sp, cfg, reqs):
    """Per request, the logits of the plain forward of ``sp``'s params (in
    its dtype, plain fp32 attention, int8 KV through the write's quantizer
    when the pool is int8) over prompt + stream, at the stream's
    positions."""
    from paddle_tpu_torch.ops.quant_matmul import quant_matmul_reference

    out = []
    with torch.no_grad():
        for r in reqs:
            p, o = list(r.prompt_ids), list(r.output_ids)
            ids = torch.tensor(p + o[:-1], device=sp.device)
            logits = quant_forward(sp.params, embed(sp.params, ids), cfg,
                                   sp.kv_quant, quant_matmul_reference)
            out.append(logits[len(p) - 1:].float())
    return out


def hold_to_oracle(label, reqs, oracle, bar):
    """Every emitted token is the oracle's argmax, unless the oracle's top-2
    margin there is below ``bar`` or zero (a near tie, counted). Returns
    the near ties."""
    ties = 0
    for i, (r, logits) in enumerate(zip(reqs, oracle)):
        o = list(r.output_ids)
        if len(o) != MAX_NEW:
            raise AssertionError(f"({label}) request {i}: {len(o)} tokens")
        top2 = logits.topk(2, dim=-1)
        want = top2.indices[:, 0].tolist()
        margin = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        for j, (w, g) in enumerate(zip(want, o)):
            if w == g:
                continue
            if margin[j] < bar or margin[j] == 0:    # an exact tie too
                ties += 1
                continue
            raise AssertionError(
                f"({label}) request {i} token {j}: served {g}, oracle {w} "
                f"(top-2 margin {margin[j]:.3e} >= {bar:.3e})")
    return ties


def equal_prefix(outs, want):
    """Tokens equal to ``want``'s, per request up to its first difference."""
    n = 0
    for o, w in zip(outs, want):
        for a, b in zip(o, w):
            if a != b:
                break
            n += 1
    return n


def registered_prefixes(sp):
    """The prefix registry's chain keys and the pool's page counts once a
    run has drained (every page free or on the LRU)."""
    c = sp.cache
    if c.available_page_count != c.num_pages:
        raise AssertionError(f"{c.num_pages - c.available_page_count} pages "
                             "still held after the run")
    return frozenset(c._prefix_pages), c.free_page_count


class SpecProbe:
    """Stands in for a speculative predictor's unified step. Before each
    call that verifies more drafts than every call before it, runs the step
    eagerly on the call's own inputs (the pools cloned), once on the kernels
    and once on the twins, with every verify row's logits; keeps both
    results, the lanes' ``q_lens`` and ``spec_len``. The comparison's
    launches and twin routes are taken off the counters again."""

    def __init__(self, sp):
        self.sp, self.step = sp, sp._unified
        sp._unified = self
        self.drafts, self.calls = 0, []

    @property
    def trace_count(self):
        return self.step.trace_count

    def __call__(self, params, *arrays):
        from paddle_tpu_torch import ops

        n = int(self.sp._feed.host["spec_len"].sum())
        if n > self.drafts:
            self.drafts = n
            step = unified_of(self.step)
            lead, pools, tail = step._split(arrays)
            names = step.arg_names[1:]
            counted = ops.counters()
            outs = []
            for ctx in (contextlib.nullcontext(), twins()):
                with ctx:
                    outs.append(step.eager(
                        params, *lead, *[p.clone() for p in pools], *tail,
                        all_rows=True)[:4])
            self.calls.append((outs, lead[names.index("q_lens")].tolist(),
                               lead[names.index("spec_len")].tolist()))
            ops.set_counters(counted)
        return self.step(params, *arrays)


class DraftProbe:
    """Stands in for a model draft engine's ``propose`` and keeps the
    contexts and drafts of its first ``calls`` calls that drafted."""

    def __init__(self, eng, calls=3):
        self.propose, self.calls, self.seen = eng.propose, calls, []
        eng.propose = self

    def __call__(self, lanes):
        out = self.propose(lanes)
        if len(self.seen) < self.calls and any(out.values()):
            self.seen.append([(list(lanes[key][1]), d)
                              for key, d in out.items() if d])
        return out


def hold_drafts(sp, probe, cfg, bar, label):
    """Each kept draft is the greedy token of the plain forward of the
    draft's truncated params over the context and the drafts before it,
    unless that forward's top-2 margin is below ``bar`` or zero (a near
    tie: the lane's later drafts are not held). Returns (drafts held,
    near ties)."""
    from paddle_tpu_torch.models.gpt import draft_config
    from paddle_tpu_torch.ops.quant_matmul import quant_matmul_reference

    eng = sp._draft_engine
    dcfg = draft_config(cfg, eng.draft_layers)
    held = ties = 0
    with torch.no_grad():
        for call in probe.seen:
            for ctx, drafts in call:
                seq = list(ctx)
                for d in drafts:
                    ids = torch.tensor(seq, device=sp.device)
                    logits = quant_forward(
                        eng.params, embed(eng.params, ids), dcfg,
                        sp.kv_quant, quant_matmul_reference)[-1].float()
                    top2 = logits.topk(2)
                    want = int(top2.indices[0])
                    if want != d:
                        margin = (top2.values[0] - top2.values[1]).item()
                        if margin < bar or margin == 0:
                            ties += 1
                            break
                        raise AssertionError(
                            f"({label}) draft {d} after {len(seq)} tokens: "
                            f"the truncated forward's greedy token is {want}"
                            f" (top-2 margin {margin:.3e})")
                    held += 1
                    seq.append(d)
    if not held:
        raise AssertionError(f"({label}) no draft held")
    return held, ties


def hold_verify_step(probe, fp32, label):
    """Every call ``probe`` compared: in each lane that feeds rows, each
    verify row up to its drafts (``spec_len``) holds its logits against
    the twins' (fp32 ``LOGIT_TOL``; bf16 ``MOE_BF16_STEP_TOL`` of the row's
    max) and its token to the twins', unless the twins' top-2 margin there
    is within twice the row's error (a near tie, counted); a lane with no
    near tie emits what the twins emit (``n_emit`` and the tokens). Returns
    (rows held, logits error, near ties)."""
    rows = ties = 0
    err = 0.0
    for ((ids, ne, _, lg), (ids_t, ne_t, _, lg_t)), q_lens, spec_len in \
            probe.calls:
        abs_err = (lg - lg_t).abs().amax(-1)                   # [b, k + 1]
        row_err = abs_err if fp32 else \
            abs_err / lg_t.abs().amax(-1).clamp_min(1e-30)
        top2 = lg_t.topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) <= 2 * abs_err
        same = ids == ids_t
        for b, (q, s) in enumerate(zip(q_lens, spec_len)):
            if not q:
                continue
            rows += s + 1
            err = max(err, row_err[b, :s + 1].max().item())
            off = [j for j in range(s + 1) if not same[b, j]]
            if any(not tie[b, j] for j in off):
                raise AssertionError(
                    f"({label}) verify step lane {b} (spec_len {s}): tokens "
                    f"{ids[b, :s + 1].tolist()} vs the twins' "
                    f"{ids_t[b, :s + 1].tolist()} past a near tie")
            ties += len(off)
            if not off and (ne[b] != ne_t[b] or not torch.equal(
                    ids[b, :int(ne[b])], ids_t[b, :int(ne[b])])):
                raise AssertionError(f"({label}) verify step lane {b}: "
                                     f"n_emit {int(ne[b])} vs the twins' "
                                     f"{int(ne_t[b])}")
    tol = LOGIT_TOL if fp32 else MOE_BF16_STEP_TOL
    log(f"[spec] ({label}) the verify step on the kernels vs the twins, "
        f"eagerly on the inputs of {len(probe.calls)} calls (each verifying "
        f"more drafts than the calls before it, up to {probe.drafts}): "
        f"{rows} verify rows, logits error {err:.3e} "
        f"({'abs' if fp32 else 'of the row max'}, tol {tol}), tokens "
        f"equal but for {ties} near ties, emissions equal")
    if not probe.drafts or not err <= tol:
        raise AssertionError(f"({label}) verify step kernels vs twins: "
                             f"error {err} (tol {tol}), drafts "
                             f"{probe.drafts}")
    return rows, err, ties


def phase_spec(model, cfg, dev, card):
    """16. Speculative decoding on the captured step and the async engine:
    every ``SPEC_FORMS`` form over the motif requests, spec off and each
    spec run (n-gram at k 1 / 2 / 4, the model self-draft of
    ``SPEC_DRAFT_LAYERS`` layers per-op and on the mega chain, the
    quantized forms) in turns, ``SPEC_RUNS`` timed runs each. Every
    stream is held to the plain forward of the served params (``bar``: the
    fp32 forms' ``TIE_MARGIN``; the others twice the largest logits error
    of the spec-off run's rows against that forward); drafts must be
    accepted; the prefix registry and the pool after a spec run equal the
    spec-off run's; one capture of the verify step and of each draft
    program; no twin route; the verify step of each form at k 4 is held
    against its twins at every verify row (:class:`SpecProbe`,
    :func:`hold_verify_step`); the profiled windows' launches equal the
    counters'. Returns the phase's launches by kernel."""
    from paddle_tpu_torch import ops

    early, late = motif_requests(cfg)
    reset_counts()
    summary = {}
    for form, _, _, _, runs in SPEC_FORMS:
        # spec off, recorded: the oracle's bar and the streams to compare
        sp = spec_predictor(model, cfg, form, dev)
        rec = StepRecord(sp)
        reqs = serve(sp, early, late)
        torch.cuda.synchronize()
        oracle = served_oracle(sp, cfg, reqs)
        err = max((torch.stack([rec.rows[(r.req_id, j)] for j in range(
            len(r.output_ids))]) - o).abs().max().item()
            for r, o in zip(reqs, oracle))
        fp32 = sp.params["tok_emb"].dtype == torch.float32
        if fp32 and not err <= LOGIT_TOL:
            raise AssertionError(f"({form}) spec-off logits {err} from the "
                                 "plain forward's")
        bar = TIE_MARGIN if fp32 else 2 * err
        ties = hold_to_oracle(f"{form}, spec off", reqs, oracle, bar)
        off = [list(r.output_ids) for r in reqs]
        off_pages = registered_prefixes(sp)
        log(f"[spec] {form} spec off: logits within {err:.3e} of the plain "
            f"forward over the served params; the streams' bar {bar:.3e} "
            f"({ties} near ties); {sp.steps} steps, captures "
            f"{unified_of(sp._unified).trace_count}")
        del sp, rec
        timing = {"off": []}
        for label, fields in runs:
            timing[label] = []
        for run in range(SPEC_RUNS):
            order = [("off", {})] + list(runs)
            for label, fields in (order if run % 2 else order[::-1]):
                sp = spec_predictor(model, cfg, form, dev, fields)
                drafts = (DraftProbe(sp._draft_engine)
                          if run == 0 and sp._draft_engine is not None
                          else None)
                got = timed_serve(sp, early, late)
                torch.cuda.synchronize()
                timing[label].append(dict(
                    got, reqs=None, outs=[list(r.output_ids)
                                          for r in got["reqs"]],
                    aps=sp.accepted_tokens_per_step,
                    rate=sp.draft_acceptance_rate,
                    overhead=sp.draft_overhead_frac,
                    accepted=sp.spec_accepted, proposed=sp.spec_proposed,
                    captures=sp.decode_trace_count,
                    draft_captures=sp.draft_trace_count,
                    trimmed=sp.telemetry()["kv_pages_trimmed"],
                    syncs=sp.hard_syncs, steps=sp.steps))
                if ops.twin_routes():
                    raise AssertionError(f"({form}, {label}) ran "
                                         f"{ops.twin_routes()} plain twins")
                if label == "off":
                    del sp
                    continue
                # the gate on the first run of each spec form
                if run == 0:
                    ties = hold_to_oracle(f"{form}, {label}", got["reqs"],
                                          served_oracle(sp, cfg,
                                                        got["reqs"]), bar)
                    pages = registered_prefixes(sp)
                    if pages != off_pages:
                        raise AssertionError(
                            f"({form}, {label}) after the run: "
                            f"{len(pages[0])} registered pages and "
                            f"{pages[1]} free vs spec off's "
                            f"{len(off_pages[0])} and {off_pages[1]}")
                    # the n-gram table must accept on motif prompts; the
                    # self-draft's first layers of random weights need not
                    # agree with the whole stack, so its drafts are held to
                    # the truncated stack's own greedy tokens instead
                    if drafts is not None:
                        n, dties = hold_drafts(sp, drafts, cfg, bar,
                                               f"{form}, {label}")
                        log(f"[spec] {form} {label}: {n} drafts of "
                            f"{len(drafts.seen)} draft passes equal the "
                            f"greedy tokens of the plain forward of the "
                            f"{sp.draft_layers}-layer draft params ({dties}"
                            " near ties)")
                    elif not sp.spec_accepted:
                        raise AssertionError(f"({form}, {label}) accepted no "
                                             "draft on the motif requests")
                    eng = sp._draft_engine
                    owners = [] if eng is None else (
                        [eng._catchup] + list(eng._chains.values()))
                    if sp.decode_trace_count != 1 or any(
                            o.trace_count > 1 for o in owners):
                        raise AssertionError(
                            f"({form}, {label}) captures: verify "
                            f"{sp.decode_trace_count}, draft "
                            f"{[o.trace_count for o in owners]}")
                    outs = timing[label][-1]["outs"]
                    log(f"[spec] {form} {label}: streams held to the plain "
                        f"forward ({ties} near ties), equal to spec off's in"
                        f" {equal_prefix(outs, off)} of "
                        f"{sum(map(len, off))} tokens up to each request's "
                        f"first difference; {sp.spec_accepted} of "
                        f"{sp.spec_proposed} drafts accepted, "
                        f"{timing[label][-1]['trimmed']:.0f} pages trimmed,"
                        f" the pool and the prefix registry as spec off's;"
                        f" captures: verify {sp.decode_trace_count}, draft "
                        f"programs {sp.draft_trace_count} "
                        f"({[o.trace_count for o in owners]})")
                del sp
        # the verify step on the kernels vs the twins at every verify row,
        # in a run of its own (its comparisons would hold up a timed run)
        sp = spec_predictor(model, cfg, form, dev, dict(spec_decode_k=4))
        probe = SpecProbe(sp)
        serve(sp, early, late)
        torch.cuda.synchronize()
        verify = hold_verify_step(probe, fp32, f"{form}, n-gram k 4")
        del sp, probe
        st = {}
        for label, rows in timing.items():
            med = median_run(rows)
            st[label] = {k: med[k] for k in (
                "step_ms", "tok_s", "steps", "aps", "rate", "overhead",
                "captures", "draft_captures", "syncs", "gap", "host_ms")}
            st[label]["runs"] = [r["step_ms"] for r in rows]
            log(f"[spec] {form} {label}: mean step {med['step_ms']:.3f} ms "
                f"(median of {SPEC_RUNS}; runs {step_list(rows)} ms), "
                f"{med['tok_s']:.1f} tokens/s, {med['steps']} steps after "
                f"the first, accepted_tokens_per_step {med['aps']:.3f}, "
                f"draft_acceptance_rate {med['rate']:.3f}, "
                f"draft_overhead_frac {med['overhead']:.3f}, hard syncs "
                f"{med['syncs']}, step_gap_frac {med['gap']:.3f}, "
                f"host_ms_per_step {med['host_ms']:.3f}, captures "
                f"{med['captures']} + {med['draft_captures']} draft "
                f"({card})")
        st["n-gram k 4"]["verify"] = dict(zip(("rows", "err", "ties"),
                                               verify))
        summary[form] = st
    for form, label in SPEC_PROFILED:
        fields = dict(next(f for f in SPEC_FORMS if f[0] == form)[4])[label]
        sp = spec_predictor(model, cfg, form, dev, fields)
        groups, busy, steps = profile_serve(
            sp, early, late, card, f"[spec] ({form}, {label})", top=8,
            need=True)
        summary[form][label]["busy_ms"] = busy / 1e3 / steps
        summary[form][label]["kernels"] = {g: c for g, (_, c) in
                                           groups.items() if c}
        del sp
    ragged_n, qmm, (attn_n, mlp_n) = read_counts()[1], qmm_counts(), \
        mega_counts()
    launches = dict(ragged=ragged_n, int8=qmm["int8"], int4=qmm["int4"],
                    mega_attn=attn_n, mega_mlp=mlp_n)
    log(f"[spec] launches over the phase's runs: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the spec path never ran: "
                             f"{launches}")
    return launches, summary


# -- phase 12 ---------------------------------------------------------------


def decode_inputs(geom, lengths, dtype, dev, seed):
    b, hq, hkv, d, ps, pps = geom
    rng = np.random.RandomState(seed)
    num_pages = b * pps + 1
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    lens = np.array(lengths, np.int32)
    for i in range(b):                 # unallocated past each context
        pt[i, (lens[i] + ps - 1) // ps:] = -1
    to = lambda a, t: torch.from_numpy(a).to(dev, t)  # noqa: E731
    return (to(q, dtype), to(kp, dtype), to(vp, dtype), to(pt, torch.int32),
            to(lens, torch.int32))


def decode_work(args):
    """(bytes, ops) the function needs on these inputs: the q rows of the
    slots with a context read, every output row written (empty slots as
    zeros), each slot's K and V rows read once, the page-table entries that
    cover the contexts and the lengths read; 2 x 2 x d ops per (q row,
    visible key)."""
    q, k_pages, _, pt, lengths = args
    b, hq, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    elt = q.element_size()
    lens = [min(max(n, 0), pt.shape[1] * ps) for n in lengths.tolist()]
    active = sum(1 for n in lens if n)
    nbytes = ((active + b) * hq * d * elt + 2 * sum(lens) * hkv * d * elt
              + 4 * (sum(-(-n // ps) for n in lens) + b))
    return nbytes, 4.0 * d * hq * sum(lens)


def phase_decode_kernel(dev):
    """(a) The split-walk decode kernel against its plain version and
    against the ragged kernel at chunk 1 on the same pools, at phase 3's
    serving pools and the odd shapes (GQA, MQA, page 16 and 8), fp32 and
    bf16, every case launched twice and bitwise equal; kernel / plain /
    bound / ragged-at-chunk-1 times at the serving pools."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention as kern, paged_attention_reference as plain,
        ragged_paged_attention as ragged)

    stats = {}
    for dtype in DTYPES:
        for ci, (geom, lengths) in enumerate((DECODE_SERVING,) + DECODE_ODD):
            args = decode_inputs(geom, lengths, dtype, dev, SEED + ci)
            lens = args[4]
            got = kern(*args)
            again = kern(*args)
            lane = ragged(args[0][:, None].contiguous(), *args[1:4], lens,
                          (lens > 0).to(torch.int32))[:, 0]
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"decode kernel {dtype} {geom}: a "
                                     "second launch differs")
            want = plain(*args)
            active = lens > 0
            err, held = kernel_error(got[active], want[active], dtype)
            r_err, r_held = kernel_error(got[active], lane[active], dtype)
            b, hq, hkv, d, ps, pps = geom
            log(f"[legacy] decode kernel {str(dtype)[6:]} b{b} hq{hq} "
                f"hkv{hkv} d{d} page {ps} lengths {lengths} (repeat bitwise "
                f"equal): vs plain "
                f"max_abs_err {err:.3e} (held {held:.3e}), vs the ragged "
                f"kernel at chunk 1 {r_err:.3e} (held {r_held:.3e}); tol "
                f"{KERNEL_TOL[dtype]}")
            if not (held <= KERNEL_TOL[dtype] and r_held <= KERNEL_TOL[dtype]):
                raise AssertionError(f"decode kernel {dtype} {geom}: error "
                                     f"{held} / vs ragged {r_held}")
            if torch.count_nonzero(got[~active]).item():
                raise AssertionError("decode kernel: an empty slot's rows "
                                     "are not zero")
            if ci:
                continue
            nbytes, nops = decode_work(args)
            st = dict(max_abs_err=err, ms=time_ms(lambda: kern(*args)),
                      plain_ms=time_ms(lambda: plain(*args), iters=5),
                      bound_ms=bound_ms(nbytes, nops, dtype), library_ms=None,
                      bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                      >= nops / PEAK_OPS[dtype] else "operations",
                      ragged_ms=time_ms(lambda: ragged(
                          args[0][:, None].contiguous(), *args[1:4], lens,
                          (lens > 0).to(torch.int32))))
            stats[dtype] = st
            log(f"[legacy] decode kernel {str(dtype)[6:]} at the serving "
                f"pools: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f}"
                f" ms, bound {st['bound_ms']:.6f} ms ({st['bound_by']}: "
                f"{nbytes / 1e6:.2f} MB, {nops / 1e9:.4f} GFLOP), the ragged "
                f"kernel at chunk 1 {st['ragged_ms']:.4f} ms, library_ms "
                "null (no single PyTorch call reads a paged pool)")
    return stats


def phase_ragged_dims(dev):
    """(b) The ragged kernel against its plain version at head dims 32, 80
    and 96 (phase 3's lanes, 16 heads), fp and int8 KV, fp32 and bf16."""
    from paddle_tpu_torch.inference.kv_cache import quantize_kv_rows
    from paddle_tpu_torch.ops.paged_attention import (
        ragged_paged_attention as kern,
        ragged_paged_attention_reference as plain, smem_bytes)

    for d in RAGGED_DIMS:
        g = dict(RAGGED_GEOM, hq=16, hkv=16, d=d)
        for dtype in (torch.float32, torch.bfloat16):
            for kv in ("fp", "int8"):
                q, kp, vp, pt, kv_lens, q_lens = ragged_inputs(
                    torch.float32, dev, g)
                sc = {}
                if kv == "int8":
                    (kp, ks), (vp, vs) = (quantize_kv_rows(
                        t.reshape(-1, 16, d)) for t in (kp, vp))
                    shape = (-1, g["ps"], 16)
                    kp, vp = kp.reshape(*shape, d), vp.reshape(*shape, d)
                    sc = dict(k_scales=ks.reshape(shape),
                              v_scales=vs.reshape(shape))
                else:
                    kp, vp = kp.to(dtype), vp.to(dtype)
                args = (q.to(dtype), kp, vp, pt, kv_lens, q_lens)
                got = kern(*args, **sc)
                torch.cuda.synchronize()
                want = plain(*args, **sc)
                valid = (torch.arange(got.shape[1], device=dev)[None]
                         < q_lens[:, None])
                err, held = kernel_error(got[valid], want[valid], dtype)
                log(f"[legacy] ragged kernel d {d} {str(dtype)[6:]} {kv} KV: "
                    f"max_abs_err {err:.3e}, held {held:.3e} (tol "
                    f"{KERNEL_TOL[dtype]}); shared memory "
                    f"{smem_bytes(g['chunk'], d, kp.dtype)} B a block")
                if not held <= KERNEL_TOL[dtype] or torch.count_nonzero(
                        got[~valid]).item():
                    raise AssertionError(f"ragged kernel d {d} {dtype} {kv}:"
                                         f" error {held}")


def legacy_counts():
    """(decode kernel, ragged) launches since :func:`reset_counts`."""
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    return paged_attention.launches, read_counts()[1]


def serve_legacy(sp, cfg, early, late, label, qmm_kind=None):
    """One fp32 served run of a legacy predictor: its launches (one decode
    kernel per layer and decode step, no ragged kernel; with ``qmm_kind``
    four weight-only GEMMs per layer and program run) and the logits rows
    behind its tokens. Returns (requests, rows)."""
    rows = StepRecord(sp, legacy=True)
    reset_counts()
    t0 = time.perf_counter()
    reqs = serve(sp, early, late)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_n, ragged_n = legacy_counts()
    qmm = qmm_counts()
    steps, tel = sp.steps, sp.telemetry()
    prefills = int(tel["serving_requests_admitted"])
    L = cfg.num_layers
    want_qmm = {k: (4 * L * (steps + prefills) if k == qmm_kind else 0)
                for k in qmm}
    log(f"[legacy] serve ({label}) fp32: {steps} decode steps, {prefills} "
        f"prefills ({sp.prefill_trace_count} bucket shapes), decode-kernel "
        f"launches {decode_n} (steps x {L} = {steps * L}), ragged "
        f"{ragged_n}, weight-only GEMM {qmm}, preemptions "
        f"{tel['serving_preemptions']:.0f}, {wall:.3f} s wall")
    if decode_n != steps * L or not steps or ragged_n or qmm != want_qmm:
        raise AssertionError(f"({label}) launches: decode {decode_n}, ragged "
                             f"{ragged_n}, GEMM {qmm} (want {want_qmm}) over "
                             f"{steps} steps")
    return reqs, rows.rows


def phase_legacy_serve(model, cfg, dev, card, fp_outs, quant_streams,
                       fp16_step_ms):
    """(c) ``ServingPredictor(unified=False)`` on GPT-125M with the phase-6
    requests in fp32: (i) fp weights against the full-forward oracle and
    phase 6's unified streams, (ii) int8 weights against the plain
    quantized forward and phase 8 (a)'s streams; then bf16 legacy and
    unified runs in turns (medians of BF16_RUNS) and one profiled legacy
    run. Returns the fp32 runs' decode-kernel launches."""
    from paddle_tpu_torch.inference import ServingPredictor

    early, late = requests(cfg)
    total = 0
    for label, quant, want, kind in (
            ("i fp", {}, fp_outs, None),
            ("ii int8", dict(weight_dtype="int8"), quant_streams["a int8"],
             "int8")):
        sp = quant_predictor(model, cfg, quant, dev, unified=False)
        reqs, rows = serve_legacy(sp, cfg, early, late, label, kind)
        total += sp.steps * cfg.num_layers
        outs = [list(r.output_ids) for r in reqs]
        if kind is None:
            ties, logit_err = check_against_oracle(model, reqs, rows, dev)
            oracle, tol = "the full forward", LOGIT_TOL
        else:
            ties, logit_err = check_quant_oracle(sp, cfg, reqs, rows, False,
                                                 QUANT_SERVE[0][2])
            oracle, tol = "the plain quantized forward", QUANT_SERVE[0][2]
        same = sum(a == b for o, w in zip(outs, want) for a, b in zip(o, w))
        log(f"[legacy] serve ({label}) fp32: greedy streams match {oracle} "
            f"({sum(map(len, outs))} tokens, {ties} near ties), logits "
            f"max_abs_err {logit_err:.3e} (tol {tol}); equal to the unified "
            f"step's streams in {same} of {sum(map(len, want))} tokens")
        if outs != want:
            raise AssertionError(f"({label}) legacy streams differ from the "
                                 "unified step's")
    # bf16: the reference's legacy-two-jit / unified-step A/B, in turns
    runs = {False: [], True: []}
    for run in range(1 + BF16_RUNS):
        for unified in ((False, True) if run % 2 else (True, False)):
            sp16 = ServingPredictor(model, max_batch=8, device=dev,
                                    dtype=torch.bfloat16, unified=unified)
            got = timed_serve(sp16, early, late)
            outs16 = [list(r.output_ids) for r in got["reqs"]]
            if run:
                runs[unified].append(got)
            if sum(map(len, outs16)) != MAX_NEW * len(outs16):
                raise AssertionError("bf16 legacy / unified: malformed "
                                     "streams")
    ms = {}
    for unified, rs in runs.items():
        med = median_run(rs)
        ms[unified] = (med["wall"], med["step_ms"])
        log(f"[legacy] serve bf16 {'unified' if unified else 'legacy'}: "
            f"{med['steps'] + 1} steps per run; median of {BF16_RUNS} runs "
            f"from the end of the first step {med['wall']:.3f} s = "
            f"{med['tok_s']:.1f} tokens/s, mean step {med['step_ms']:.3f} ms"
            f" (runs: {step_list(rs)} ms) ({card})")
    log(f"[legacy] serve bf16 wall after the first step legacy "
        f"{ms[False][0]:.3f} s vs unified {ms[True][0]:.3f} s; mean step "
        f"legacy {ms[False][1]:.3f} ms vs unified {ms[True][1]:.3f} ms "
        f"(phase 6: {fp16_step_ms:.3f} ms) ({card})")
    profile_serve(ServingPredictor(model, max_batch=8, device=dev,
                                   dtype=torch.bfloat16, unified=False),
                  early, late, card, "[legacy] (legacy)")
    return total


def phase_legacy_d96(dev):
    """(d) gpt3-760m's width at 2 layers (h 1536, 16 heads of 96), fp32,
    random weights: the per-op unified step (the ragged kernel at d 96) and
    the legacy path (the decode kernel at d 96) against the full forward.
    Returns the legacy run's decode-kernel launches."""
    from dataclasses import replace

    from paddle_tpu_torch.inference import ServingPredictor
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS

    cfg = replace(GPT_CONFIGS["gpt3-760m"], num_layers=LEGACY_D96_LAYERS)
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    early, late = requests(cfg)
    sp = ServingPredictor(model, max_batch=8, device=dev)
    rows = StepRecord(sp)
    reset_counts()
    reqs = serve(sp, early, late)
    torch.cuda.synchronize()
    ragged_n = read_counts()[1]
    ties, err = check_against_oracle(model, reqs, rows.rows, dev)
    unified = [list(r.output_ids) for r in reqs]
    log(f"[legacy] d 96 (gpt3-760m width, {cfg.num_layers} layers) unified "
        f"per-op fp32: {sp.steps} steps, ragged launches {ragged_n}; streams "
        f"match the full forward ({ties} near ties, logits max_abs_err "
        f"{err:.3e}); {len({t for o in unified for t in o})} distinct tokens")
    if ragged_n != sp.steps * cfg.num_layers or not ragged_n:
        raise AssertionError(f"d 96 unified: ragged launches {ragged_n}")
    leg = ServingPredictor(model, max_batch=8, device=dev, unified=False)
    reqs, rows = serve_legacy(leg, cfg, early, late, "d 96")
    ties, err = check_against_oracle(model, reqs, rows, dev)
    outs = [list(r.output_ids) for r in reqs]
    log(f"[legacy] d 96 legacy fp32: streams match the full forward ({ties} "
        f"near ties, logits max_abs_err {err:.3e}); equal to the unified "
        f"streams: {outs == unified}")
    if outs != unified:
        raise AssertionError("d 96: legacy and unified streams differ")
    return leg.steps * cfg.num_layers


# -- phase 7 ----------------------------------------------------------------


def bwd_work(b, sq, sk, hq, hkv, d, causal, elt):
    """(bytes, ops) of the backward on these shapes: q, k, v, do read and
    dq, dk, dv written once in the input type, lse and delta read in fp32;
    five products of 2 x d ops per visible (row, key) pair."""
    pairs = sum(min(max(r + sk - sq + 1, 0), sk) for r in range(sq)) \
        if causal else sq * sk
    nbytes = (3 * b * sq * hq * d + 4 * b * sk * hkv * d) * elt \
        + 8 * b * hq * sq
    return nbytes, 10.0 * d * pairs * b * hq


def bwd_inputs(shape, dtype, dev, seed):
    """q, k, v, do drawn from a numpy seed, and the plain forward's lse and
    delta = rowsum(do * out) on them (what the custom op hands the kernel)."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_reference

    b, sq, sk, hq, hkv, d, causal = shape
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev, dtype) for s in
        ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d)))
    out, lse = flash_attention_reference(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    return q, k, v, do, lse, delta.reshape(b * hq, 1, sq).contiguous()


def events_ms(fn, iters=10, repeats=5) -> float:
    """Device milliseconds per call from CUDA events around ``iters`` eager
    calls (for calls that run autograd, which a CUDA graph does not capture
    here), the least of ``repeats`` runs after 3 warm-up calls: a host
    stall can only add to a run."""
    for _ in range(3):
        fn()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return min(runs)


def sdpa_bwd_ms(q, k, v, do) -> float:
    """SDPA's backward (the aten backward PyTorch picks for these inputs)
    on the same tensors, timed, never used."""
    import torch.nn.functional as tnf

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = tnf.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    return events_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                 retain_graph=True))


def one_key_rows(sq, sk, causal, dev):
    """[sq] bool: the queries that see exactly one key. Their dq is zero in
    exact arithmetic (ds = p (dp - delta) with p = 1 and dp = delta)."""
    r = torch.arange(sq, device=dev)
    seen = (r + sk - sq + 1).clamp(0, sk) if causal else torch.full_like(
        r, sk)
    return seen == 1


def bwd_error(got, want, dtype, zero_rows=None):
    """(max abs error, held error, zero-row error) of one gradient
    ``[b, s, h, d]``. fp32: held over the tensor's max |want|. bf16: held
    per row as ``kernel_error``, except the ``zero_rows`` (dq of the
    queries that see one key), whose exact value is zero: both sides
    return fp32 rounding noise there (the tensor cores sum dp in another
    rounding than the plain GEMM and delta), so such a row has no scale of
    its own and is held as an fp32 gradient, over the tensor's max |want|,
    to ``ZERO_ROW_TOL`` (the zero-row error; 0 where there is none)."""
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        err = (got - want).abs().max().item()
        return err, err / scale, 0.0
    if zero_rows is None or not zero_rows.any():
        return (*kernel_error(got, want, dtype), 0.0)
    zero = zero_rows.view(1, -1, 1).expand(got.shape[:-1])
    err, held = kernel_error(got[~zero], want[~zero], dtype)
    zero_err = (got[zero].float() - want[zero].float()).abs().max().item()
    return max(err, zero_err), held, zero_err / scale


def check_flash_bwd(args, shape, dtype, tag):
    """The backward kernel vs its plain version on one case, held as
    ``bwd_error``. Returns the max abs error over dq, dk, dv."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd as kern, flash_attention_bwd_reference as plain)

    b, sq, sk, hq, hkv, d, causal = shape
    got = kern(*args, causal=causal)
    torch.cuda.synchronize()
    want = plain(*args, causal=causal)
    zero_rows = one_key_rows(sq, sk, causal, got[0].device)
    errs = {name: bwd_error(g, w, dtype, zero_rows if name == "dq" else None)
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    worst = max(h for _, h, _ in errs.values())
    worst_zero = max(z for _, _, z in errs.values())
    label = (f"{str(dtype)[6:]} b{b} sq{sq} sk{sk} hq{hq} hkv{hkv} d{d} "
             f"{'causal' if causal else 'non-causal'}")
    log(f"{tag} flash bwd {label}: " + ", ".join(
        f"{n} max_abs_err {e:.3e} held {hd:.3e}"
        + (f" zero rows {z:.3e}" if z else "")
        for n, (e, hd, z) in errs.items())
        + f" (tol {BWD_TOL[dtype]}; zero rows {ZERO_ROW_TOL[dtype]})")
    if not (worst <= BWD_TOL[dtype]
            and worst_zero <= ZERO_ROW_TOL[dtype]):
        raise AssertionError(f"flash bwd kernel {label}: held error {worst} "
                             f"> {BWD_TOL[dtype]} or zero-row error "
                             f"{worst_zero} > {ZERO_ROW_TOL[dtype]}")
    return max(e for e, _, _ in errs.values())


def flash_bwd_times(args, shape, dtype, err, tag, iters, plain_iters):
    """Kernel, plain and SDPA-backward times of one case with its bound,
    logged with the achieved rates; returns the kernels-line fields."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd as kern, flash_attention_bwd_reference as plain)

    b, sq, sk, hq, hkv, d, causal = shape
    nbytes, nops = bwd_work(*shape, args[0].element_size())
    st = dict(max_abs_err=err,
              ms=time_ms(lambda: kern(*args, causal=causal), iters=iters,
                         replays=2),
              plain_ms=time_ms(lambda: plain(*args, causal=causal),
                               iters=plain_iters, replays=2),
              library_ms=sdpa_bwd_ms(*args[:4]),
              bound_ms=bound_ms(nbytes, nops, dtype),
              bound_by="bytes" if nbytes / HBM_BYTES_PER_S
              >= nops / PEAK_OPS[dtype] else "operations")
    log(f"{tag} flash bwd {str(dtype)[6:]} {[b, sq, hq, d]} causal: kernel "
        f"{st['ms']:.4f} ms ({flash_rate(st['ms'], nbytes, nops, dtype)}), "
        f"plain {st['plain_ms']:.4f} ms, library (torch sdpa backward) "
        f"{st['library_ms']:.4f} ms "
        f"({flash_rate(st['library_ms'], nbytes, nops, dtype)}), bound "
        f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {nbytes / 1e6:.2f} MB, "
        f"{nops / 1e9:.3f} GFLOP)")
    return st


def phase_flash_bwd(dev):
    """The backward kernel vs its plain version at the training shape
    (timed) and odd shapes in fp32 and bf16; the bf16 tensor-core kernel at
    every head dim of ``FLASH_TC_CASES`` and at ``FLASH_LONG`` (timed); the
    forward kernel at the training shape (timed: the kernels line's
    flash_attention_fwd row in bf16)."""
    b, s, h, d = BWD_SHAPE
    cases = [(b, s, s, h, h, d, True),
             (2, 200, 456, 12, 4, 64, True),      # sq != sk, GQA
             (2, 333, 333, 12, 12, 64, True),     # tail not a tile multiple
             (1, 300, 100, 4, 1, 128, True),      # rows that see no key
             (2, 130, 77, 6, 3, 64, False)]       # non-causal, sq > sk
    stats = {}
    for dtype in DTYPES:
        for ci, shape in enumerate(cases):
            args = bwd_inputs(shape, dtype, dev, SEED + ci)
            err = check_flash_bwd(args, shape, dtype, "[train]")
            if not ci:
                stats[dtype] = flash_bwd_times(args, shape, dtype, err,
                                               "[train]", 10, 2)
    for dtype in (torch.bfloat16, torch.float16):
        for ci, shape in enumerate(FLASH_TC_CASES):
            check_flash_bwd(bwd_inputs(shape, dtype, dev, SEED + 10 + ci),
                            shape, dtype, "[train]")
    bl, sl, hl, dl = FLASH_LONG
    shape = (bl, sl, sl, hl, hl, dl, True)
    args = bwd_inputs(shape, torch.bfloat16, dev, SEED)
    err = check_flash_bwd(args, shape, torch.bfloat16, "[train]")
    stats["long"] = flash_bwd_times(args, shape, torch.bfloat16, err,
                                    "[train]", 5, 1)
    del args
    # the forward kernel at the same shape: held against its plain version,
    # and timed for the step's breakdown and the kernels line
    for dtype in DTYPES:
        args = bwd_inputs(cases[0], dtype, dev, SEED)[:3]
        err = check_flash_fwd(args, cases[0], dtype, "[train]")
        fwd = flash_fwd_times(args, cases[0], dtype, err, "[train]", 10, 2,
                              2, 2)
        stats[dtype]["fwd"] = fwd
        stats[dtype]["fwd_ms"] = fwd["ms"]
    return stats


def _lm_loss(model, ids):
    logits = model(ids[:, :-1]).float()
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1))


def _grad_errors(got: dict, want: dict):
    """{name: max abs error over the leaf's max |want|}; raises when a
    gradient is missing on either side."""
    missing = sorted(n for n in want if got.get(n) is None
                     or want[n] is None)
    if missing or set(got) != set(want):
        raise AssertionError(f"gradients missing for {missing}")
    return {n: ((got[n].float() - want[n].float()).abs().max()
                / want[n].float().abs().max().clamp_min(1e-30)).item()
            for n in want}


def phase_eager_grads(model, cfg, dev):
    """The eager GPT's backward through the flash kernels: the regression
    test of the fault where flash attention had no gradient on the card."""
    ids = torch.from_numpy(np.random.RandomState(SEED + 2).randint(
        0, cfg.vocab_size, (2, 257))).to(dev)
    grads = {}
    for flash in (True, False):
        cfg.use_flash_attention = flash
        model.zero_grad(set_to_none=True)
        reset_counts()
        loss = _lm_loss(model, ids)
        loss.backward()
        torch.cuda.synchronize()
        fwd_n, bwd_n = read_counts()[0], bwd_count()
        grads[flash] = {n: p.grad for n, p in model.named_parameters()}
        log(f"[train] eager GPT-125M ids [2, 256] "
            f"{'flash' if flash else 'plain'} attention: loss "
            f"{loss.item():.6f}, flash launches fwd {fwd_n}"
            f" bwd {bwd_n}")
        want_n = cfg.num_layers if flash else 0
        if fwd_n != want_n or bwd_n != want_n:
            raise AssertionError(f"eager backward ran flash fwd {fwd_n}, bwd "
                                 f"{bwd_n} times (want {want_n})")
    cfg.use_flash_attention = True
    model.zero_grad(set_to_none=True)
    errs = _grad_errors(grads[True], grads[False])
    worst = max(errs, key=errs.get)
    log(f"[train] eager gradients, flash vs plain: {len(errs)} parameters, "
        f"none None; worst {worst} {errs[worst]:.3e} of its max |grad| (tol "
        f"{GRAD_TOL}); qkv_proj.weight of layer 0 "
        f"{errs['gpt.layers.0.attn.qkv_proj.weight']:.3e}")
    if not errs[worst] <= GRAD_TOL:
        raise AssertionError(f"eager gradient {worst}: flash vs plain "
                             f"{errs[worst]} > {GRAD_TOL}")


def phase_train_fp32(dev):
    """gpt3-760m's width at 2 layers in fp32 (TF32 off): flash vs plain
    attention for the first step's loss and every gradient leaf, and for
    three steps' losses at lr 0.05."""
    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.convert import random_train_params
    from paddle_tpu_torch.models.gpt import GPTConfig

    base = dict(TRAIN, num_layers=2)
    weights = random_train_params(GPTConfig(**base), SEED)
    runs = {}
    for flash in (True, False):
        cfg = GPTConfig(**base, use_flash_attention=flash)
        step, params, mom, (ids, labels) = gpt_spmd.build_spmd_train_step(
            cfg, batch_size=2, seq_len=1024, num_micro=1, lr=0.05,
            device=dev, params=weights)
        reset_counts()
        loss0, grads = gpt_spmd.value_and_grad(params, ids, labels, cfg, 1)
        torch.cuda.synchronize()
        counts = (read_counts()[0], bwd_count())
        grads = dict(gpt_spmd.leaves(grads))
        losses = []
        for _ in range(3):
            params, mom, loss = step(params, mom, ids, labels)
            losses.append(loss.item())
        runs[flash] = (loss0.item(), grads, losses, counts)
        log(f"[train] fp32 760M-width 2 layers b2 s1024 "
            f"{'flash' if flash else 'plain'}: first loss {loss0.item():.6f},"
            f" flash launches fwd/bwd {counts}, 3 steps at lr 0.05: "
            f"{', '.join(f'{x:.6f}' for x in losses)}")
        if not losses[2] < losses[0] or not np.isfinite(losses).all():
            raise AssertionError(f"fp32 training loss did not fall: {losses}")
        del step, params, mom, grads
    if runs[True][3] != (2, 2) or runs[False][3] != (0, 0):
        raise AssertionError(f"flash launches {runs[True][3]} / "
                             f"{runs[False][3]} (want (2, 2) / (0, 0))")
    errs = _grad_errors(runs[True][1], runs[False][1])
    worst = max(errs, key=errs.get)
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip([runs[True][0]] + runs[True][2],
                       [runs[False][0]] + runs[False][2]))
    log(f"[train] fp32 flash vs plain: {len(errs)} gradient leaves, worst "
        f"{worst} {errs[worst]:.3e} of its max |grad| (tol {GRAD_TOL}); "
        f"losses rel err {loss_err:.3e} (tol {LOSS_TOL})")
    if not (errs[worst] <= GRAD_TOL and loss_err <= LOSS_TOL):
        raise AssertionError("fp32 training: flash and plain disagree")


def phase_train_bf16_parity(dev):
    """bf16 ``build_spmd_train_step`` with flash vs plain attention at the
    flagship width (12 heads of 128) and at gpt3-760m's ``GPT_CONFIGS``
    width (16 heads of 96), both cut to 2 layers, b 2, s 1024, recompute
    with the flash outputs saved: the loss, every gradient leaf and the
    flash launches (2 forward and 2 backward a step; none on the plain
    path)."""
    from dataclasses import replace

    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.convert import random_train_params
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTConfig

    for label, base in (
            ("flagship width, 12 heads of 128",
             GPTConfig(**dict(TRAIN, num_layers=2))),
            ("gpt3-760m width, 16 heads of 96", replace(
                GPT_CONFIGS["gpt3-760m"], num_layers=2, recompute=True,
                remat_save_attn=True))):
        weights = random_train_params(base, SEED)
        runs = {}
        for flash in (True, False):
            cfg = replace(base, use_flash_attention=flash)
            step, params, mom, (ids, labels) = gpt_spmd.build_spmd_train_step(
                cfg, batch_size=2, seq_len=1024, num_micro=1, lr=0.05,
                device=dev, params=weights, dtype=torch.bfloat16)
            reset_counts()
            loss, grads = gpt_spmd.value_and_grad(params, ids, labels, cfg, 1)
            torch.cuda.synchronize()
            runs[flash] = (loss.item(), dict(gpt_spmd.leaves(grads)),
                           (read_counts()[0], bwd_count()))
            del step, params, mom, grads
        errs = _grad_errors(runs[True][1], runs[False][1])
        worst = max(errs, key=errs.get)
        loss_err = abs(runs[True][0] - runs[False][0]) / abs(runs[False][0])
        log(f"[train] bf16 {label}, 2 layers b2 s1024 recompute+save_attn, "
            f"flash vs plain: loss {runs[True][0]:.6f} vs "
            f"{runs[False][0]:.6f} (rel err {loss_err:.3e}, tol "
            f"{BF16_LOSS_TOL}); {len(errs)} gradient leaves, worst {worst} "
            f"{errs[worst]:.3e} of its max |grad| (tol {BF16_GRAD_TOL}); "
            f"flash launches fwd/bwd {runs[True][2]} / {runs[False][2]}")
        if runs[True][2] != (2, 2) or runs[False][2] != (0, 0):
            raise AssertionError(f"bf16 {label}: flash launches "
                                 f"{runs[True][2]} / {runs[False][2]} (want "
                                 "(2, 2) / (0, 0))")
        if not (errs[worst] <= BF16_GRAD_TOL and loss_err <= BF16_LOSS_TOL):
            raise AssertionError(f"bf16 training ({label}): flash and plain "
                                 "disagree")


def phase_train_bf16(dev, card, bwd_stats, fused=False, unfused=None):
    """The flagship configuration: full-width gpt3-760m, bf16, timed, and
    one profiled step; with ``fused`` the ``fused_mlp`` step (phase 9),
    logged beside ``unfused``, the result of the unfused run of the same
    call. ``bwd_stats``: phase 7's flash times, or None."""
    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.convert import random_train_params
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(**TRAIN, fused_mlp=fused)
    tag = "[fused]" if fused else "[train]"
    label = "fused_mlp" if fused else "unfused"
    b, s, L = TRAIN_BATCH, cfg.max_seq_len, cfg.num_layers
    t0 = time.perf_counter()
    step, params, mom, (ids, labels) = gpt_spmd.build_spmd_train_step(
        cfg, batch_size=b, seq_len=s, num_micro=1, lr=1e-4, momentum=0.9,
        device=dev, params=random_train_params(cfg, SEED),
        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"{tag} bf16 gpt3-760m {label}: {cfg.num_params() / 1e6:.1f} M "
        f"params, set up in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, mom, loss = step(params, mom, ids, labels)
        losses.append(loss.item())          # synchronizes
        walls.append(time.perf_counter() - t0)
    fwd_n, bwd_n = read_counts()[0], bwd_count()
    fused_n = fused_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not np.isfinite(losses).all():
        raise AssertionError(f"bf16 training loss not finite: {losses}")
    if fwd_n != L * TRAIN_STEPS or bwd_n != L * TRAIN_STEPS:
        raise AssertionError(f"flash launches fwd {fwd_n}, bwd {bwd_n} over "
                             f"{TRAIN_STEPS} steps (want {L} each per step)")
    # a step: two LNs a layer, each run again by the recompute; one GELU a
    # layer, run again too; one backward each
    per_step = (4 * L, 2 * L, 2 * L, L) if fused else (0, 0, 0, 0)
    if fused_n != tuple(TRAIN_STEPS * n for n in per_step):
        raise AssertionError(f"fused launches {fused_n} over {TRAIN_STEPS} "
                             f"steps (want {per_step} per step)")
    timed = walls[1:]
    step_s = sum(timed) / len(timed)
    tps = b * s / step_s
    flops_per_token = 6 * cfg.num_params() + 6 * L * cfg.hidden_size * s
    mfu = tps * flops_per_token / PEAK_OPS[torch.bfloat16]
    flash_txt = "" if bwd_stats is None else (
        f"flash kernels alone "
        f"{L * (bwd_stats['ms'] + bwd_stats['fwd_ms']):.1f} ms a step ({L} x"
        f" (bwd {bwd_stats['ms']:.3f} + fwd {bwd_stats['fwd_ms']:.3f}) ms, "
        "phase-7 kernel times); ")
    log(f"{tag} bf16 gpt3-760m {label} b{b} s{s} recompute+save_attn: "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; flash launches fwd "
        f"{fwd_n} bwd {bwd_n} ({L} each per step); fused launches LN fwd/bwd"
        f", GELU fwd/bwd {fused_n} ({per_step} per step); step "
        f"{1e3 * step_s:.1f} ms (mean of {len(timed)} after 1 warm-up: "
        f"{', '.join(f'{1e3 * w:.1f}' for w in timed)}), {tps:.1f} tokens/s,"
        f" MFU {mfu:.4f} ({flops_per_token / 1e9:.3f} GFLOP/token over "
        f"989 TFLOP/s bf16); {flash_txt}peak device memory {peak_gb:.2f} GB "
        f"({card})")
    result = dict(fwd_n=fwd_n, bwd_n=bwd_n, fused_n=fused_n,
                  step_ms=1e3 * step_s, tps=tps, mfu=mfu, peak_gb=peak_gb)
    if unfused is not None:
        log(f"{tag} bf16 gpt3-760m fused_mlp vs unfused, same call: step "
            f"{result['step_ms']:.1f} vs {unfused['step_ms']:.1f} ms, "
            f"tokens/s {tps:.1f} vs {unfused['tps']:.1f}, MFU {mfu:.4f} vs "
            f"{unfused['mfu']:.4f}, peak {peak_gb:.2f} vs "
            f"{unfused['peak_gb']:.2f} GB (one run each, not a benchmark)")
    prof = result["profile"] = profile_step(step, params, mom, ids, labels,
                                            card, tag)
    if fused and prof is not None:
        gelu_ms, ln_fwd_ms, ln_bwd_ms = (prof["groups_ms"][g] for g in (
            "fused GELU", "fused LN fwd", "fused LN bwd"))
        log(f"{tag} profiled fused step: GELU kernels {gelu_ms:.3f} ms "
            f"({per_step[2]} forward + {per_step[3]} backward launches, "
            f"{gelu_ms / prof['busy_ms']:.3f} of device busy "
            f"{prof['busy_ms']:.1f} ms), LN kernels forward "
            f"{ln_fwd_ms:.3f} ms ({per_step[0]} launches), backward "
            f"{ln_bwd_ms:.3f} ms ({per_step[1]} launches); device busy "
            f"share {prof['busy_share']:.3f} ({card})")
    return result


# -- phase 13: BERT-base pretraining through the mask branch -----------------

# bench.py's bench_bert_jit configuration (BASELINE config 2) at BERT-base's
# max_position_embeddings: batch 16 of per-sequence lengths 64-512 (one of
# 512), dropout 0, momentum SGD at lr 1e-4 (bench.py:359-363)
BERT_BATCH, BERT_SEQ, BERT_STEPS = 16, 512, 4     # one warm-up, three timed
BERT_MLM_FRAC = 0.15
# classifier logits, flash vs plain route, over the max |logit|: fp32 sums
# in another order (seen in the GPT forward: <= 1e-6 relative); bf16 rounds
# every activation to bf16 (2^-8) at other places in 12 post-LN layers on
# the two routes, so only a gross error (a wrong bias, a dropped row)
# shows: 5e-2
BERT_LOGIT_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# bf16 gradients through 12 layers sit at bf16's own noise: on an H100 the
# plain route read up to 5.2e-2 of a leaf's max |grad| from the exact fp32
# gradients of the same weights, the kernel route up to 3.9e-2, and the
# two 3.4e-2 apart (4 seeds; per leaf the kernel / plain distance ratio
# scattered 0.57-1.35). So in bf16 every leaf of the kernel route must be
# within BERT_GRAD_CAP of exact, and where a leaf is past BF16_GRAD_TOL
# from the plain route, the kernel route's worst leaf distance from exact
# within BERT_NOISE_MARGIN x the plain route's (read 0.76-1.13). The fp32
# step holds the masked kernels to GRAD_TOL
BERT_GRAD_CAP = 5e-2
BERT_NOISE_MARGIN = 1.25
BERT_GRAD_SEEDS = 4     # weights and batch from SEED + i; i = 0 then trains
# (d): the masks the branch is held with at [16, 512, 12, 64]
BERT_MASKS = ("key padding [b, 1, 1, s]", "dense bias [b, hq, s, s]",
              "shared holes [1, 1, s, s]", "bool [b, 1, s, s]")


def bert_batch(cfg, dev, seed=SEED):
    """The pretraining batch from ``seed``: lengths in 64-512 (one of
    512), the 1/0 attention mask built from them, ids, segment B from the
    middle of each sequence, MLM labels at 15% of the valid positions
    (-100 elsewhere), NSP labels."""
    rng = np.random.RandomState(seed + 13)
    b, s = BERT_BATCH, BERT_SEQ
    lens = rng.randint(64, s + 1, b)
    lens[rng.randint(b)] = s
    pos = np.arange(s)[None]
    valid = pos < lens[:, None]
    ids = rng.randint(0, cfg.vocab_size, (b, s))
    types = (pos >= lens[:, None] // 2) & valid
    labels = np.where(valid & (rng.rand(b, s) < BERT_MLM_FRAC), ids, -100)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return dict(lens=lens, input_ids=to(ids.astype(np.int64)),
                token_type_ids=to(types.astype(np.int64)),
                attention_mask=to(valid.astype(np.int64)),
                masked_lm_labels=to(labels.astype(np.int64)),
                next_sentence_label=to(rng.randint(0, 2, b).astype(np.int64)))


def branch_counts():
    """Forward and backward launches with the mask branch and with the
    lens branch since :func:`reset_counts`."""
    from paddle_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                      flash_attention_fwd)

    return dict(fwd_mask=flash_attention_fwd.mask_launches,
                bwd_mask=flash_attention_bwd.mask_launches,
                fwd_lens=flash_attention_fwd.lens_launches,
                bwd_lens=flash_attention_bwd.lens_launches)


def bert_route_grads(model, batch, flash, L):
    """(loss, {name: grad}) of one pretraining step of ``model`` on the
    masked kernels (``flash``: L masked forward and backward launches) or
    under ``plain_attention()`` (none)."""
    from paddle_tpu_torch.nn.functional.attention import plain_attention

    model.zero_grad(set_to_none=True)
    reset_counts()
    with contextlib.nullcontext() if flash else plain_attention():
        loss = model(**batch)
        loss.backward()
    torch.cuda.synchronize()
    n = branch_counts()
    fwd_n, bwd_n = read_counts()[0], bwd_count()
    want = (L, L) if flash else (0, 0)
    if (fwd_n, bwd_n) != want or (n["fwd_mask"], n["bwd_mask"]) != want:
        raise AssertionError(f"bert {'flash' if flash else 'plain'}: "
                             f"launches {fwd_n}/{bwd_n}, masked {n}")
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def bert_grad_check(cfg, dev, seed):
    """The MLM + NSP loss's gradients at bert-base with the weights and
    batch of ``seed``, through the masked kernels against the same step
    under ``plain_attention()`` (``_sdpa_ref``): in fp32 (the bf16 weights
    upcast, TF32 off) every leaf within ``GRAD_TOL``; in bf16 every leaf
    within ``BERT_GRAD_CAP`` of the exact gradients (the fp32 plain
    route), and within ``BF16_GRAD_TOL`` of the plain route unless the
    kernel route's worst leaf distance from exact is within
    ``BERT_NOISE_MARGIN`` x the plain route's. Returns the bf16 model, the
    batch, its lengths and the readings."""
    from paddle_tpu_torch.models.convert import (bert_from_jax_numpy,
                                                 bert_to_numpy,
                                                 random_bert_state)

    t0 = time.perf_counter()
    model = bert_from_jax_numpy(random_bert_state(cfg, seed), cfg,
                                device=dev, dtype=torch.bfloat16)
    batch = bert_batch(cfg, dev, seed)
    lens = batch.pop("lens")
    L, (b, s) = cfg.num_layers, (BERT_BATCH, BERT_SEQ)
    log(f"[bert] bert-base bf16 seed {seed}: {cfg.num_params() / 1e6:.1f} M "
        f"params, batch {b} x {s}, lengths {lens.tolist()} ({lens.sum()} "
        f"valid tokens of {b * s}); set up in "
        f"{time.perf_counter() - t0:.1f} s")
    losses, grads = zip(*(bert_route_grads(model, batch, flash, L)
                          for flash in (True, False)))
    f32 = bert_from_jax_numpy(bert_to_numpy(model.state_dict()), cfg,
                              device=dev)
    losses32, grads32 = zip(*(bert_route_grads(f32, batch, flash, L)
                              for flash in (True, False)))
    del f32
    exact = grads32[1]
    e32 = _grad_errors(grads32[0], exact)
    errs = _grad_errors(*grads)
    ek, ep = (_grad_errors(g, exact) for g in grads)
    del grads, grads32, exact
    worst, worst32 = max(errs, key=errs.get), max(e32, key=e32.get)
    noisy = sorted(n for n in errs if errs[n] > BF16_GRAD_TOL)
    far = sorted(n for n in ek if not ek[n] <= BERT_GRAD_CAP)
    ratio = max(ek.values()) / max(ep.values())
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    loss32_err = abs(losses32[0] - losses32[1]) / abs(losses32[1])
    log(f"[bert] seed {seed} gradients, masked kernels vs plain _sdpa_ref: "
        f"fp32 loss rel err {loss32_err:.3e} (tol {LOSS_TOL}), worst leaf "
        f"{worst32} {e32[worst32]:.3e} of its max |grad| (tol {GRAD_TOL}); "
        f"bf16 loss {losses[0]:.6f} vs {losses[1]:.6f} (rel err "
        f"{loss_err:.3e}, tol {BF16_LOSS_TOL}), worst leaf {worst} "
        f"{errs[worst]:.3e} (tol {BF16_GRAD_TOL}), {len(noisy)} of "
        f"{len(errs)} leaves past it; from the exact gradients, worst leaf:"
        f" kernel route {max(ek.values()):.3e} (cap {BERT_GRAD_CAP}), plain"
        f" route {max(ep.values()):.3e}, ratio {ratio:.3f} (margin "
        f"{BERT_NOISE_MARGIN}" + (f" held: {len(noisy)} leaves past "
                                  f"{BF16_GRAD_TOL})" if noisy else
                                  " not needed)")
        + ("; per leaf past it, kernel / plain distance from exact "
           f"{min(ek[n] / ep[n] for n in noisy):.3f}-"
           f"{max(ek[n] / ep[n] for n in noisy):.3f} x" if noisy else ""))
    if not (e32[worst32] <= GRAD_TOL and loss32_err <= LOSS_TOL):
        raise AssertionError(f"bert fp32 seed {seed}: masked kernels and "
                             f"plain disagree ({worst32} {e32[worst32]})")
    if far or (noisy and ratio > BERT_NOISE_MARGIN) or not (
            loss_err <= BF16_LOSS_TOL and np.isfinite(losses[0])):
        raise AssertionError(f"bert bf16 seed {seed}: masked kernels and "
                             f"plain disagree: past the cap {far}, worst-"
                             f"leaf ratio {ratio} on {noisy}, loss "
                             f"{loss_err}")
    return model, batch, lens, dict(
        seed=seed, worst=errs[worst], worst32=e32[worst32], noisy=len(noisy),
        ratio=ratio, kernel_max=max(ek.values()),
        plain_max=max(ep.values()))


def phase_bert_train(dev, card):
    """(a) BERT-base pretraining in bf16 at batch 16, seq 512, full depth:
    :func:`bert_grad_check` on ``BERT_GRAD_SEEDS`` seeds; then, on the
    first seed's weights and batch, momentum SGD, one warm-up and three
    timed steps (12 masked forward and 12 masked backward launches a step,
    none unmasked), one profiled."""
    from dataclasses import replace

    from paddle_tpu_torch.models.bert import BERT_CONFIGS

    cfg = replace(BERT_CONFIGS["bert-base"], hidden_dropout=0.0,
                  attn_dropout=0.0)
    L, (b, s) = cfg.num_layers, (BERT_BATCH, BERT_SEQ)
    readings = []
    for i in reversed(range(BERT_GRAD_SEEDS)):      # SEED's model kept last
        model, batch, lens, r = bert_grad_check(cfg, dev, SEED + i)
        readings.append(r)
    log(f"[bert] gradient readings over {BERT_GRAD_SEEDS} seeds: "
        + "; ".join(f"seed {r['seed']}: fp32 {r['worst32']:.3e}, bf16 "
                    f"{r['worst']:.3e} ({r['noisy']} past), kernel / plain "
                    f"from exact {r['kernel_max']:.3e} / "
                    f"{r['plain_max']:.3e} ({r['ratio']:.3f})"
                    for r in readings))
    model.zero_grad(set_to_none=True)
    params = [p for p in model.parameters()]
    mom = [torch.zeros_like(p) for p in params]

    def step():
        loss = model(**batch)
        loss.backward()
        with torch.no_grad():   # bench.py: mom = 0.9 mom + g; p -= lr mom
            torch._foreach_mul_(mom, 0.9)
            torch._foreach_add_(mom, [p.grad for p in params])
            torch._foreach_add_(params, mom, alpha=-1e-4)
        for p in params:
            p.grad = None
        return loss

    reset_counts()
    walls, step_losses = [], []
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        step_losses.append(step().item())   # synchronizes
        walls.append(time.perf_counter() - t0)
    n = branch_counts()
    launches = dict(fwd=n["fwd_mask"], bwd=n["bwd_mask"])
    if not np.isfinite(step_losses).all():
        raise AssertionError(f"bert loss not finite: {step_losses}")
    if (read_counts()[0], bwd_count()) != (L * BERT_STEPS,) * 2 or (
            n["fwd_mask"], n["bwd_mask"]) != (L * BERT_STEPS,) * 2:
        raise AssertionError(f"bert steps: launches {read_counts()[0]}/"
                             f"{bwd_count()}, branches {n} (want {L} masked"
                             " forward and backward a step)")
    timed_s = walls[1:]
    step_s = sum(timed_s) / len(timed_s)
    flops = 6 * cfg.num_params() + 6 * L * cfg.hidden_size * s
    mfu = b * s / step_s * flops / PEAK_OPS[torch.bfloat16]
    log(f"[bert] bf16 pretraining steps: losses "
        f"{', '.join(f'{x:.4f}' for x in step_losses)}; masked flash "
        f"launches fwd {n['fwd_mask']} bwd {n['bwd_mask']} ({L} each a "
        f"step); step {1e3 * step_s:.1f} ms (mean of {len(timed_s)} after 1 "
        f"warm-up: {', '.join(f'{1e3 * w:.1f}' for w in timed_s)}), "
        f"{b * s / step_s:.1f} tokens/s ({lens.sum() / step_s:.1f} valid), "
        f"MFU {mfu:.4f} (padding counted; {flops / 1e9:.3f} GFLOP/token "
        f"over 989 TFLOP/s bf16) ({card})")
    prof = profile_step(lambda *_: (None, None, step()), None, None, None,
                        None, card, "[bert]")
    return dict(launches=launches, step_ms=1e3 * step_s, mfu=mfu,
                profile=prof, lens=lens)


def phase_bert_classify(dev):
    """(b) ``BertForSequenceClassification`` forward on the phase's batch
    at bert-base, fp32 (TF32 off) and bf16: logits through the masked
    kernels (12 masked forward launches) against the plain route."""
    from dataclasses import replace

    from paddle_tpu_torch.models.bert import BERT_CONFIGS
    from paddle_tpu_torch.models.convert import (bert_from_jax_numpy,
                                                 random_bert_state)
    from paddle_tpu_torch.nn.functional.attention import plain_attention

    cfg = replace(BERT_CONFIGS["bert-base"], hidden_dropout=0.0,
                  attn_dropout=0.0)
    batch = bert_batch(cfg, dev)
    kw = {k: batch[k] for k in ("input_ids", "token_type_ids",
                                "attention_mask")}
    named = random_bert_state(cfg, SEED + 1, num_classes=2)
    launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        model = bert_from_jax_numpy(named, cfg, device=dev, dtype=dtype)
        model.eval()
        with torch.no_grad():
            reset_counts()
            logits = model(**kw)
            torch.cuda.synchronize()
            n = branch_counts()["fwd_mask"]
            with plain_attention():
                plain = model(**kw)
        err = ((logits.float() - plain.float()).abs().max()
               / plain.float().abs().max()).item()
        log(f"[bert] classifier {str(dtype)[6:]} logits "
            f"{tuple(logits.shape)}: masked kernels vs plain route "
            f"{err:.3e} of max |logit| (tol {BERT_LOGIT_TOL[dtype]}), "
            f"masked forward launches {n}")
        if (n != cfg.num_layers or not err <= BERT_LOGIT_TOL[dtype]
                or not torch.isfinite(logits).all()):
            raise AssertionError(f"bert classifier {dtype}: err {err}, "
                                 f"launches {n}")
        launches += n
        del model
    return launches


def varlen_grad_error(name, got, want, lens):
    """(max abs error, held error, zero error) of one packed bf16 gradient
    ``[total, h, d]`` against the fp32 plain one, per sequence: each
    sequence's rows over that sequence's max |want| (the kernels form
    delta from the bf16 out, and a query that sees a few keys cancels in
    dp - delta, so a row's own scale does not bound its error against
    exact gradients; its sequence's does). dq and dk of a length-1
    sequence are zero in exact arithmetic (p = 1, so ds = 0): held as an
    fp32 gradient over the tensor's max |want| (the zero error), as
    ``bwd_error`` holds its zero rows."""
    scale = want.abs().max().item()
    err = held = zero = 0.0
    start = 0
    for n in (int(x) for x in lens):
        g, w = got[start:start + n].float(), want[start:start + n]
        start += n
        e = (g - w).abs().max().item()
        err = max(err, e)
        if n == 1 and name != "dv":
            zero = max(zero, e / scale)
        else:
            held = max(held, e / w.abs().max().item())
    return err, held, zero


def phase_bert_varlen(dev, lens, dt=torch.bfloat16):
    """(c) ``flash_attn_unpadded`` at BERT-base widths (12 heads of 64) in
    ``dt`` (bf16; fp16 in phase 14) on the phase's lengths packed, causal
    and not: the kernel route
    (one lens-branch forward and backward launch a call) against the plain
    segment-masked version on the same values in fp32: out per row as
    ``KERNEL_TOL``, dq / dk / dv per sequence (``varlen_grad_error``) to
    ``BWD_TOL``."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    from paddle_tpu_torch.nn.functional.attention import _unpadded_ref

    cu = torch.tensor(np.cumsum([0, *lens]), device=dev)
    total, h, d, s = int(cu[-1]), 12, 64, BERT_SEQ
    rng = np.random.RandomState(SEED + 14)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((total, h, d))
                                    .astype(np.float32)).to(dev, dt)
                   for _ in range(4))
    stats, launches = {}, dict(fwd=0, bwd=0)
    for causal in (False, True):
        outs = {}
        for route in ("kernel", "plain"):
            # the plain version on the same 16-bit values in fp32: it scores
            # in its input dtype, which in bf16 or fp16 alone would round
            # every score before the softmax
            args = [(x if route == "kernel" else x.float()).clone()
                    .requires_grad_() for x in (q, k, v)]
            reset_counts()
            out = (flash_attn_unpadded(*args, cu, cu, s, s, causal=causal)[0]
                   if route == "kernel" else
                   _unpadded_ref(*args, cu, cu, causal=causal))
            out.backward(do if route == "kernel" else do.float())
            torch.cuda.synchronize()
            n = branch_counts()
            if route == "kernel":
                launches["fwd"] += n["fwd_lens"]
                launches["bwd"] += n["bwd_lens"]
                if (n["fwd_lens"], n["bwd_lens"]) != (1, 1):
                    raise AssertionError(f"flash_attn_unpadded: {n}")
            outs[route] = (out.detach(), *(a.grad for a in args))
        err, held = kernel_error(outs["kernel"][0], outs["plain"][0], dt)
        grads = [varlen_grad_error(name, g, w, lens) for name, g, w in zip(
            ("dq", "dk", "dv"), outs["kernel"][1:], outs["plain"][1:])]
        bheld = max(x[1] for x in grads)
        bzero = max(x[2] for x in grads)
        log(f"[bert] flash_attn_unpadded {'causal' if causal else 'non-causal'}"
            f" total {total} x {h} x {d} {str(dt)[6:]}: out held {held:.3e} "
            f"per row (tol {KERNEL_TOL[dt]}), dq / dk / dv "
            + ", ".join(f"{x[1]:.3e}" for x in grads)
            + f" of their sequence's max |grad| (tol {BWD_TOL[dt]}; length-1"
            f" sequences {bzero:.3e}, tol {ZERO_ROW_TOL[dt]})")
        if not (held <= KERNEL_TOL[dt] and bheld <= BWD_TOL[dt]
                and bzero <= ZERO_ROW_TOL[dt]):
            raise AssertionError(f"flash_attn_unpadded causal={causal}: out "
                                 f"{held}, gradients {bheld}, zero {bzero}")
        stats[causal] = max(err, *(x[0] for x in grads))
    return launches, stats[False]


def branch_inputs(dtype, dev, seed):
    b, s, h, d = BERT_BATCH, BERT_SEQ, 12, 64
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(4))


def branch_mask(kind, lens, dev):
    """The normalized masks of (d) at [16, 512, 12 heads]."""
    b, s, h = BERT_BATCH, BERT_SEQ, 12
    rng = np.random.RandomState(SEED + 15)
    if kind.startswith("key padding"):      # BERT's (1 - m) * -1e9
        m = (np.arange(s)[None] >= np.asarray(lens)[:, None]) * -1e9
        m = m.reshape(b, 1, 1, s)
    elif kind.startswith("dense"):
        m = rng.standard_normal((b, h, s, s))
    elif kind.startswith("shared"):
        m = np.where(rng.rand(1, 1, s, s) < 0.2, -1e30, 0.0)
    else:
        return torch.from_numpy(rng.rand(b, 1, s, s) >= 0.2).to(dev)
    return torch.from_numpy(m.astype(np.float32)).to(dev)


def branch_zero_rows(b, s, h, causal, mask, lens, dev):
    """The gradient rows that are zero in exact arithmetic (both sides
    return fp32 rounding noise there): ``{"dq": [b, s, h], "dk": [b, s,
    h]}`` bool, the queries that see exactly one key (p = 1, so ds = 0)
    and the keys seen only by such queries. A bias below -1e6 hides a
    key."""
    from paddle_tpu_torch.ops.flash_attention import _scores_masked

    s0, dead = _scores_masked(torch.zeros(b, h, s, s, device=dev), b, s, s,
                              causal, mask, lens)
    seen = s0 > -1e6
    if dead is not None:
        seen = seen & ~dead
    one = seen.sum(-1) == 1
    lone = ~(seen & ~one[..., None]).any(-2)
    return dict(dq=one.transpose(1, 2), dk=lone.transpose(1, 2))


def check_branch(args, dtype, causal, mask, lens, label):
    """Forward and backward kernels against their plain versions with one
    mask and / or lens at [16, 512, 12, 64]; returns the max abs errors
    and the plain forward's lse and delta."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_reference)

    q, k, v, do = args
    kw = dict(causal=causal, mask=mask, lens=lens)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want, want_lse = flash_attention_reference(q, k, v, **kw)
    err, held = kernel_error(out, want, dtype)
    lse_err = (lse - want_lse).abs().max().item()
    delta = (do.float() * want.float()).sum(-1).transpose(1, 2)
    delta = delta.reshape(lse.shape).contiguous()
    got = flash_attention_bwd(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    ref = flash_attention_bwd_reference(q, k, v, do, want_lse, delta, **kw)
    b, s, h, _ = q.shape
    zero = branch_zero_rows(b, s, h, causal, mask, lens, q.device)
    berrs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, ref):
        one = zero.get(name)
        if dtype == torch.float32 or one is None or not one.any():
            berrs[name] = bwd_error(g, w, dtype)
        else:       # bwd_error's zero rows, per (batch, row, head)
            e, hd = kernel_error(g[~one], w[~one], dtype)
            z = (g[one].float() - w[one].float()).abs().max().item()
            berrs[name] = (max(e, z), hd, z / w.float().abs().max().item())
    bheld = max(x[1] for x in berrs.values())
    bzero = max(x[2] for x in berrs.values())
    log(f"[bert] branch {str(dtype)[6:]} {label} "
        f"{'causal' if causal else 'non-causal'}: fwd max_abs_err {err:.3e} "
        f"held {held:.3e} (tol {KERNEL_TOL[dtype]}), lse err {lse_err:.3e}; "
        + ", ".join(f"{n} held {x[1]:.3e}" for n, x in berrs.items())
        + f" (tol {BWD_TOL[dtype]}; zero rows {bzero:.3e}, tol "
        f"{ZERO_ROW_TOL[dtype]})")
    if not (held <= KERNEL_TOL[dtype] and lse_err <= 1e-3
            and bheld <= BWD_TOL[dtype]
            and bzero <= ZERO_ROW_TOL[dtype]):
        raise AssertionError(f"flash branch {dtype} {label} causal={causal}")
    return err, max(x[0] for x in berrs.values()), want_lse, delta


def masked_sdpa_bwd_ms(q, k, v, do, mask) -> float:
    """SDPA's backward with the same additive mask, timed, never used."""
    import torch.nn.functional as tnf

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = tnf.scaled_dot_product_attention(qt, kt, vt,
                                           attn_mask=mask.to(q.dtype))
    dot = do.transpose(1, 2)
    return events_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                 retain_graph=True))


def branch_times(args, dtype, mask, lens, lse, delta, errs):
    """Kernel, plain and library times of the forward and backward at one
    branch (non-causal), with their bounds: the work this run's data needs
    (under lens only the valid rows and keys and their pairs). The library
    call is torch's SDPA with the same ``attn_mask``; under lens (q_len =
    kv_len) with the key-padding mask built from the lengths, which gives
    the same valid rows and computes the padded rows too."""
    import torch.nn.functional as tnf

    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_reference)

    q, k, v, do = args
    b, s, h, d = q.shape
    elt = q.element_size()
    kw = dict(causal=False, mask=mask, lens=lens)
    if lens is None:
        rows = keys = b * s
        pairs = b * s * s
    else:
        ql, kl = (lens[i].long().cpu().numpy() for i in (0, 1))
        rows, keys, pairs = int(ql.sum()), int(kl.sum()), int((ql * kl).sum())
    mbytes = 0 if mask is None else 4 * mask.numel()
    lib_mask = mask
    if lens is not None:
        cols = torch.arange(s, device=q.device)
        lib_mask = torch.where(cols[None] < lens[1, :, None].long(), 0.0,
                               -1e9).reshape(b, 1, 1, s)
    lib_mask = lib_mask.to(dtype)
    # forward: valid q, k, v rows read, out and lse written in full
    fb = (rows * h + 2 * keys * h) * d * elt + b * s * h * (d * elt + 4) \
        + mbytes
    fo = 4.0 * d * pairs * h
    # backward: q, do, lse, delta of the valid rows and k, v read; dq, dk,
    # dv written in full
    bb = (2 * rows * h * d + 2 * keys * h * d) * elt + 8 * rows * h \
        + (b * s * h * d * 3) * elt + mbytes
    bo = 10.0 * d * pairs * h
    out = {}
    for part, nb, no in (("fwd", fb, fo), ("bwd", bb, bo)):
        st = dict(max_abs_err=errs[part == "bwd"],
                  bound_ms=bound_ms(nb, no, dtype),
                  bound_by="bytes" if nb / HBM_BYTES_PER_S
                  >= no / PEAK_OPS[dtype] else "operations")
        if part == "fwd":
            st["ms"] = time_ms(lambda: flash_attention_fwd(q, k, v, **kw),
                               iters=20, replays=2)
            st["plain_ms"] = time_ms(
                lambda: flash_attention_reference(q, k, v, **kw), iters=2,
                replays=2)
            st["library_ms"] = time_ms(
                lambda: tnf.scaled_dot_product_attention(
                    *(x.transpose(1, 2) for x in (q, k, v)),
                    attn_mask=lib_mask), iters=20, replays=2)
        else:
            st["ms"] = time_ms(lambda: flash_attention_bwd(
                q, k, v, do, lse, delta, **kw), iters=10, replays=2)
            st["plain_ms"] = time_ms(lambda: flash_attention_bwd_reference(
                q, k, v, do, lse, delta, **kw), iters=2, replays=2)
            st["library_ms"] = masked_sdpa_bwd_ms(q, k, v, do, lib_mask)
        log(f"[bert] {'mask' if lens is None else 'varlen'} {part} "
            f"{str(dtype)[6:]} [{b}, {s}, {h}, {d}] non-causal: kernel "
            f"{st['ms']:.4f} ms ({flash_rate(st['ms'], nb, no, dtype)}), "
            f"plain {st['plain_ms']:.4f} ms, library (torch sdpa "
            f"attn_mask{'' if lens is None else ' from the lengths'}) "
            f"{st['library_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms "
            f"({st['bound_by']}: {nb / 1e6:.2f} MB, {no / 1e9:.3f} GFLOP)")
        out[part] = st
    return out


def phase_bert_branches(dev, lens):
    """(d) each branch alone against its plain version, fp32 and bf16, at
    [16, 512, 12, 64]: the masks of ``BERT_MASKS`` causal and not; lens with
    a 0 and q_len != kv_len (causal and not, and with the key-padding mask);
    BERT's key-padding mask and the phase's lengths timed non-causal."""
    from paddle_tpu_torch.ops.flash_attention import normalize_mask

    b, s = BERT_BATCH, BERT_SEQ
    stats = {}
    ql = np.asarray(lens).copy()
    kl = np.asarray(lens).copy()
    ql[1], kl[2], ql[3], kl[3] = 0, 0, 77, 400     # zeros, q_len != kv_len
    lens_odd = torch.tensor(np.stack([ql, kl]), dtype=torch.int32, device=dev)
    lens_same = torch.tensor(np.stack([lens, lens]), dtype=torch.int32,
                             device=dev)
    for dtype in DTYPES:
        args = branch_inputs(dtype, dev, SEED + 16)
        for kind in BERT_MASKS:
            mask = normalize_mask(branch_mask(kind, lens, dev), args[0], s)
            res = [check_branch(args, dtype, causal, mask, None, kind)
                   for causal in (False, True)][0]
            if kind == BERT_MASKS[0]:
                stats[("mask", dtype)] = branch_times(
                    args, dtype, mask, None, res[2], res[3], res[:2])
        pad = normalize_mask(branch_mask(BERT_MASKS[0], lens, dev), args[0],
                             s)
        for label, lz, mask in (("lens with 0, q != kv", lens_odd, None),
                                ("lens + key padding", lens_odd, pad)):
            for causal in (False, True):
                check_branch(args, dtype, causal, mask, lz, label)
        res = check_branch(args, dtype, False, None, lens_same,
                           "lens (the batch's lengths)")
        stats[("lens", dtype)] = branch_times(args, dtype, None, lens_same,
                                              res[2], res[3], res[:2])
        del args
    return stats


# -- phase 9 ----------------------------------------------------------------


def fused_inputs(kind, shape, dtype, dev, seed):
    """The inputs of one fused kernel at ``shape``, drawn on the card from
    a seeded generator: LN ``x, r, dy, dso [rows, h]`` and ``g, b [h]``;
    GELU ``u`` (the GEMM output), ``dy [rows, n]`` and ``b [n]``."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shp, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shp, generator=gen, device=dev)
                ).to(dtype)

    h = shape[-1]
    if kind.startswith("ln"):
        return dict(x=draw(shape), r=draw(shape), dy=draw(shape),
                    dso=draw(shape), g=draw((h,), 0.1, 1.0),
                    b=draw((h,), 0.1))
    return dict(u=draw(shape, 2.0), dy=draw(shape), b=draw((h,), 0.5))


def fused_work(kind, variant, rows, h, elt):
    """(bytes, ops) of one call: every input read once and every output
    written once (the statistics and parameter sums in fp32), and
    ``FUSED_OPS`` operations an element (+1 for the residual, dso or
    bias)."""
    extra = variant != "plain"
    n = rows * h
    nbytes = {"ln_fwd": (2 + 2 * extra) * n * elt + 2 * h * elt + 8 * rows,
              "ln_bwd": (3 + extra) * n * elt + 8 * rows + h * elt + 8 * h,
              "gelu_fwd": 2 * n * elt + extra * h * elt,
              "gelu_bwd": 3 * n * elt + extra * (h * elt + 4 * h)}[kind]
    return nbytes, (FUSED_OPS[kind] + extra) * float(n)


def fused_held(got, want, dtype):
    """(max abs error, held error): fp32 tensors over the tensor's max
    |want|, bf16 tensors per row (``kernel_error``)."""
    if got.dtype == torch.float32:
        err = (got - want).abs().max().item()
        return err, err / max(want.abs().max().item(), 1e-30)
    return kernel_error(got, want, dtype)


def fused_calls(kind, variant, t):
    """(kernel, plain, library or None) callables of one case on the
    inputs ``t``; the library call computes the same function in one
    PyTorch call (only the variants without residual, dso or bias have
    one)."""
    import torch.nn.functional as tnf

    from paddle_tpu_torch.ops import fused_mlp as fm

    eps, extra = 1e-5, variant != "plain"
    if kind == "ln_fwd":
        r = t["r"] if extra else None
        args = (t["x"], r, t["g"], t["b"], eps)
        lib = (None if extra else lambda: tnf.layer_norm(
            t["x"], t["x"].shape[-1:], t["g"], t["b"], eps))
        return (lambda: fm.ln_fwd(*args), lambda: fm.ln_fwd_reference(*args),
                lib)
    if kind == "ln_bwd":
        # the statistics and s of the plain forward on the same inputs
        r = t["r"] if extra else None
        fwd = fm.ln_fwd_reference(t["x"], r, t["g"], t["b"], eps)
        s = fwd[1] if extra else t["x"]
        args = (t["dy"], t["dso"] if extra else None, s, fwd[-2], fwd[-1],
                t["g"])
        lib = None
        if not extra:
            h = t["x"].shape[-1]
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                t["x"], [h], t["g"], t["b"], eps)
            lib = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa
                t["dy"], t["x"], [h], mean, rstd, t["g"], t["b"],
                [True, True, True])
        return (lambda: fm.ln_bwd(*args), lambda: fm.ln_bwd_reference(*args),
                lib)
    bias = t["b"] if extra else None
    if kind == "gelu_fwd":
        lib = (None if extra else lambda: tnf.gelu(t["u"],
                                                   approximate="tanh"))
        return (lambda: fm.gelu_fwd(t["u"], bias),
                lambda: fm.gelu_fwd_reference(t["u"], bias), lib)
    lib = (None if extra else lambda: torch.ops.aten.gelu_backward(
        t["dy"], t["u"], approximate="tanh"))
    return (lambda: fm.gelu_bwd(t["dy"], t["u"], bias),
            lambda: fm.gelu_bwd_reference(t["dy"], t["u"], bias), lib)


FUSED_KINDS = (("ln_fwd", ("plain", "residual")),
               ("ln_bwd", ("plain", "dso")),
               ("gelu_fwd", ("plain", "bias")),
               ("gelu_bwd", ("plain", "bias")))


def phase_fused_kernels(dev):
    """Each fused kernel and variant against its plain version at the
    flagship, GPT-125M and an odd shape, fp32, bf16 and fp16; kernel /
    plain / library times and the bound at the flagship shape (and, for the
    LN kernels, at GPT-125M's, under ``(kind, variant, dtype, 1)``); every
    GELU and LN backward case launched twice, bitwise equal; one LN
    backward call one CUDA kernel, its arrival counters left at zero."""
    stats = {}
    for kind, variants in FUSED_KINDS:
        shapes = FUSED_LN_SHAPES if kind.startswith("ln") \
            else FUSED_GELU_SHAPES
        for dtype in DTYPES:
            for variant in variants:
                for si, shape in enumerate(shapes):
                    t = fused_inputs(kind, shape, dtype, dev, SEED + si)
                    kern, plain, lib = fused_calls(kind, variant, t)
                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                    got = [g for g in (got if isinstance(got, tuple)
                                       else (got,)) if g is not None]
                    want = [w for w in (want if isinstance(want, tuple)
                                        else (want,)) if w is not None]
                    errs = [fused_held(g, w, dtype) for g, w in zip(got, want)]
                    max_err = max(e for e, _ in errs)
                    held = max(hd for _, hd in errs)
                    tol = FUSED_TOL[dtype]
                    log(f"[fused] {kind} {variant} {str(dtype)[6:]} "
                        f"{list(shape)}: {len(errs)} outputs, max_abs_err "
                        f"{max_err:.3e}, held {held:.3e} (tol {tol})")
                    if not (len(got) == len(want) and held <= tol):
                        raise AssertionError(
                            f"fused {kind} {variant} {dtype} {shape}: held "
                            f"error {held} > {tol}")
                    if kind == "ln_fwd" and variant == "residual" and \
                            not torch.equal(got[1], want[1]):
                        raise AssertionError("ln_fwd: s is not the plain "
                                             "version's rounding of x + r")
                    if kind.startswith("gelu") or kind == "ln_bwd":
                        bitwise_repeat(kern, got, f"{kind} {variant} "
                                       f"{str(dtype)[6:]} {list(shape)}")
                    if si > (1 if kind.startswith("ln") else 0):
                        continue
                    nbytes, nops = fused_work(kind, variant, *shape,
                                              t["dy"].element_size())
                    st = dict(
                        max_abs_err=max_err, ms=time_ms(kern, iters=20,
                                                        replays=3),
                        plain_ms=time_ms(plain, iters=5, replays=2),
                        library_ms=None if lib is None else time_ms(
                            lib, iters=20, replays=3),
                        bound_ms=bound_ms(nbytes, nops, torch.float32),
                        bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                        >= nops / PEAK_OPS[torch.float32]
                        else "operations")
                    stats[(kind, variant, dtype) + ((si,) if si else ())] = st
                    lib_txt = ("null (no single PyTorch call computes it)"
                               if lib is None else
                               f"{st['library_ms']:.4f} ms")
                    log(f"[fused] {kind} {variant} {str(dtype)[6:]} "
                        f"{list(shape)}: kernel {st['ms']:.4f} ms, plain "
                        f"{st['plain_ms']:.4f} ms, library {lib_txt}, bound "
                        f"{st['bound_ms']:.4f} ms ({st['bound_by']}: "
                        f"{nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} GFLOP), "
                        f"{st['bound_ms'] / st['ms']:.3f} of the bound")
                    del t
    ln_bwd_one_kernel(dev)
    gelu_extremes(dev)
    return stats


def call_kernels(fn):
    """``(kernels, device ms, {kernel name: [launches, device ms]})`` of
    one call of ``fn`` under ``torch.profiler`` (after a call outside it,
    so nothing is built or first allocated in the window), from the
    trace's raw device events as ``profile_run`` reads them (late in a
    long run ``key_averages()`` has returned none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    names = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0:
            n, ms = names.get(ev.name(), (0, 0.0))
            names[ev.name()] = [n + 1, ms + ev.duration_ns() / 1e6]
    return (sum(n for n, _ in names.values()),
            sum(ms for _, ms in names.values()), names)


def ln_bwd_one_kernel(dev):
    """One LN backward call at the flagship shape, bf16 with dso: one CUDA
    kernel under ``torch.profiler`` (dgamma and dbeta summed inside it),
    and its arrival counters zero after it."""
    from paddle_tpu_torch.ops import _build

    t = fused_inputs("ln_bwd", FUSED_LN_SHAPES[0], torch.bfloat16, dev, SEED)
    kern = fused_calls("ln_bwd", "dso", t)[0]
    n, ms, names = call_kernels(kern)
    zero = bool((_build.kept(dev, "ln_bwd", 1) == 0).all())
    log(f"[fused] ln_bwd dso bf16 {list(FUSED_LN_SHAPES[0])} under the "
        f"profiler: {n} CUDA kernel(s) {names}, {ms:.4f} ms; arrival "
        f"counters zero after it: {zero}" + (
            " (no device events in the trace: kernels a call not "
            "measured)" if not n else ""))
    if n > 1 or not zero:
        raise AssertionError(f"ln_bwd: {n} kernels a call, counters zero "
                             f"{zero}")


def bits(t):
    """``t``'s bits as integers, so equal NaNs compare equal."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def bitwise_repeat(kern, got, label):
    """A second launch of a GELU or LN backward kernel on the same inputs
    must be bitwise equal to the first (dx, and dbias, dgamma and dbeta
    summed in a fixed order)."""
    again = kern()
    torch.cuda.synchronize()
    again = [a for a in (again if isinstance(again, tuple) else (again,))
             if a is not None]
    if not all(torch.equal(bits(a), bits(g)) for a, g in zip(again, got)):
        raise AssertionError(f"fused {label}: a second launch differs")


def gelu_special(shape, dtype, dev, seed):
    """``u`` uniform in +-30 with +-1e4, +-inf and NaN in every row."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(-30, 30, shape).astype(np.float32)
    special = np.array(GELU_SPECIAL, np.float32)
    cols = np.argsort(rng.random_sample(shape), axis=1)[:, :special.size]
    np.put_along_axis(u, cols, special[None], axis=1)
    return torch.from_numpy(u).to(dev, dtype)


def gelu_extremes(dev):
    """The four GELU variants at GPT-125M's and the odd shape on inputs in
    +-30 with +-1e4, +-inf and NaN in every row: NaN, +inf and -inf at the
    same places as the plain version's, the finite entries held as
    ``FUSED_TOL``; and a bitwise-equal second launch."""
    for kind in ("gelu_fwd", "gelu_bwd"):
        for dtype in DTYPES:
            for variant in ("plain", "bias"):
                for si, shape in enumerate(FUSED_GELU_SHAPES[1:]):
                    t = fused_inputs(kind, shape, dtype, dev, SEED + 7 + si)
                    t["u"] = gelu_special(shape, dtype, dev, SEED + 7 + si)
                    kern, plain, _ = fused_calls(kind, variant, t)
                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                    got, want = ([g for g in (o if isinstance(o, tuple)
                                              else (o,)) if g is not None]
                                 for o in (got, want))
                    label = (f"{kind} {variant} {str(dtype)[6:]} "
                             f"{list(shape)} extremes")
                    held, counts = 0.0, []
                    for g, w in zip(got, want):
                        for test in (torch.isnan, torch.isposinf,
                                     torch.isneginf):
                            if not torch.equal(test(g), test(w)):
                                raise AssertionError(
                                    f"fused {label}: {test.__name__} at "
                                    "other places than the plain version's")
                            counts.append(int(test(w).sum()))
                        fin = torch.isfinite(w)
                        held = max(held, fused_held(
                            torch.where(fin, g, 0), torch.where(fin, w, 0),
                            dtype)[1])
                    bitwise_repeat(kern, got, label)
                    tol = FUSED_TOL[dtype]
                    log(f"[fused] {label}: NaN / +inf / -inf at the same "
                        f"places ({' / '.join(map(str, counts))} over "
                        f"{len(got)} outputs), finite held {held:.3e} (tol "
                        f"{tol}), second launch bitwise equal")
                    if not held <= tol:
                        raise AssertionError(f"fused {label}: held error "
                                             f"{held} > {tol}")


def phase_fused_eager(model, cfg, dev):
    """The eager GPT-125M with ``fused_mlp`` on ids [4, 512], fp32: logits
    and every parameter's gradient against the same weights unfused."""
    ids = torch.from_numpy(np.random.RandomState(SEED + 3).randint(
        0, cfg.vocab_size, (4, 513))).to(dev)
    runs = {}
    for fused in (True, False):
        cfg.fused_mlp = fused
        model.zero_grad(set_to_none=True)
        reset_counts()
        logits = model(ids[:, :-1]).float()
        torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), ids[:, 1:].reshape(-1)
        ).backward()
        torch.cuda.synchronize()
        runs[fused] = (logits.detach(), {n: p.grad for n, p in
                                         model.named_parameters()},
                       fused_counts())
    cfg.fused_mlp = False
    model.zero_grad(set_to_none=True)
    L = cfg.num_layers
    want = (2 * L, 2 * L, L, L)
    if runs[True][2] != want or any(runs[False][2]):
        raise AssertionError(f"eager fused launches {runs[True][2]} (want "
                             f"{want}), unfused {runs[False][2]}")
    logit_err = ((runs[True][0] - runs[False][0]).abs().max()
                 / runs[False][0].abs().max()).item()
    errs = _grad_errors(runs[True][1], runs[False][1])
    worst = max(errs, key=errs.get)
    log(f"[fused] eager GPT-125M ids [4, 512] fp32, fused vs unfused: "
        f"logits {logit_err:.3e} of the max |logit|, {len(errs)} parameter "
        f"gradients, none None, worst {worst} {errs[worst]:.3e} of its max "
        f"|grad| (tol {GRAD_TOL}); fused launches LN fwd/bwd, GELU fwd/bwd "
        f"{runs[True][2]}")
    if not (logit_err <= GRAD_TOL and errs[worst] <= GRAD_TOL):
        raise AssertionError("eager fused vs unfused disagree")


def phase_fused_train_fp32(dev):
    """gpt3-760m's width at 2 layers in fp32 (TF32 off), recompute: the
    fused step, with and without ``remat_save_ln``, against the unfused
    one for the first loss, every gradient leaf and three steps' losses."""
    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.convert import random_train_params
    from paddle_tpu_torch.models.gpt import GPTConfig

    base = dict(TRAIN, num_layers=2)
    weights = random_train_params(GPTConfig(**base), SEED)
    L = base["num_layers"]
    runs = {}
    for label, over, want in (
            ("unfused", {}, (0, 0, 0, 0)),
            ("fused", dict(fused_mlp=True), (4 * L, 2 * L, 2 * L, L)),
            ("fused+save_ln", dict(fused_mlp=True, remat_save_ln=True),
             (2 * L, 2 * L, 2 * L, L))):
        cfg = GPTConfig(**base, **over)
        step, params, mom, (ids, labels) = gpt_spmd.build_spmd_train_step(
            cfg, batch_size=2, seq_len=1024, num_micro=1, lr=0.05,
            device=dev, params=weights)
        reset_counts()
        loss0, grads = gpt_spmd.value_and_grad(params, ids, labels, cfg, 1)
        torch.cuda.synchronize()
        counts = fused_counts()
        grads = dict(gpt_spmd.leaves(grads))
        losses = []
        for _ in range(3):
            params, mom, loss = step(params, mom, ids, labels)
            losses.append(loss.item())
        runs[label] = (loss0.item(), grads, losses)
        log(f"[fused] fp32 760M-width 2 layers b2 s1024 recompute {label}: "
            f"first loss {loss0.item():.6f}, launches LN fwd/bwd, GELU "
            f"fwd/bwd {counts} (want {want}), 3 steps at lr 0.05: "
            f"{', '.join(f'{x:.6f}' for x in losses)}")
        if counts != want:
            raise AssertionError(f"{label}: fused launches {counts}, want "
                                 f"{want}")
        if not losses[2] < losses[0] or not np.isfinite(losses).all():
            raise AssertionError(f"fp32 training loss did not fall: {losses}")
        del step, params, mom, grads
    for label in ("fused", "fused+save_ln"):
        errs = _grad_errors(runs[label][1], runs["unfused"][1])
        worst = max(errs, key=errs.get)
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip([runs[label][0]] + runs[label][2],
                           [runs["unfused"][0]] + runs["unfused"][2]))
        log(f"[fused] fp32 {label} vs unfused: {len(errs)} gradient leaves,"
            f" worst {worst} {errs[worst]:.3e} of its max |grad| (tol "
            f"{GRAD_TOL}); losses rel err {loss_err:.3e} (tol "
            f"{FUSED_LOSS_TOL})")
        if not (errs[worst] <= GRAD_TOL and loss_err <= FUSED_LOSS_TOL):
            raise AssertionError(f"fp32 training: {label} and unfused "
                                 "disagree")


KERNEL_GROUPS = (("flash fwd", ("flash_fwd_kernel", "flash_fwd_tc_kernel",
                                 "flash_fwd_wg_kernel")),
                 ("flash bwd", ("flash_bwd_kernel", "flash_bwd_tc_kernel")),
                 ("fused LN fwd", ("ln_fwd_kernel",)),
                 ("fused LN bwd", ("ln_bwd_kernel",)),
                 ("fused GELU", ("gelu_kernel",)),
                 ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas",
                                    "nvjet")),
                 ("copies and fills", ("memcpy", "memset")))


def profile_step(step, params, mom, ids, labels, card, tag="[train]"):
    """One more training step under ``torch.profiler``: device time by
    kernel group, and the device's busy and idle share of the step's wall
    time (one stream, so kernels do not overlap). Returns them (None when
    the trace holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        step(params, mom, ids, labels)[2].item()
        wall_us = 1e6 * (time.perf_counter() - t0)
        time.sleep(PROFILE_MARGIN_S)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other PyTorch kernels"] = 0.0
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    for ev in kernels:
        key = ev.key.lower()
        name = next((n for n, marks in KERNEL_GROUPS
                     if any(m in key for m in marks)),
                    "other PyTorch kernels")
        groups[name] += ev.self_device_time_total
    launches = sum(ev.count for ev in kernels)
    busy = sum(groups.values())
    if busy <= 0:
        log(f"{tag} profiler: no device time in the trace (device "
            "breakdown not measured)")
        return None
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"{tag} profiled kernel {ev.self_device_time_total / 1e3:8.2f} "
            f"ms x{ev.count:<4d} {ev.key[:90]}")
    flash = groups["flash fwd"] + groups["flash bwd"]
    log(f"{tag} profiled bf16 step: wall {wall_us / 1e3:.1f} ms (under the "
        f"profiler), device busy {busy / 1e3:.1f} ms = "
        f"{busy / wall_us:.3f} of it, idle {1 - busy / wall_us:.3f}; "
        f"{launches} kernels; flash share of device time "
        f"{flash / busy:.3f}; " + ", ".join(
            f"{n} {t / 1e3:.3f} ms ({t / busy:.3f})"
            for n, t in groups.items()) + f" ({card})")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / wall_us, kernels=launches,
                groups_ms={n: t / 1e3 for n, t in groups.items()})


# -- the split page walks (rows 1 and 13) -------------------------------------

# (b, chunk, hq, hkv, d, page, pages a lane, kv_lens, q_lens): GPT-125M's
# decode round (8 lanes of one row at max_seq_len 1,024; the step's chunk 16)
# and gpt3-1.3b's 32 heads of 64 at 2,048-token contexts with prefill chunks
RAGGED_WALKS = {
    "decode round": (8, 16, 12, 12, 64, 64, 16, [1024] * 8, [1] * 8),
    "gpt3-1.3b 2,048": (8, 16, 32, 32, 64, 64, 32, [2048] * 8,
                        [1, 16, 1, 7, 1, 1, 16, 1]),
}
# mega attention at GPT-125M's decode round (one row a lane over 1,023
# tokens already in the pool) and at the head dims the split-walk kernel
# added, at their configs' widths: gpt3-tiny (h 128, 4 heads of 32),
# gpt3-2.7b (h 2560, 32 heads of 80), gpt3-760m (h 1536, 16 heads of 96)
MEGA_DECODE_ROUND = ((8, 16, 768, 12, 64, 64, 16, 3072), [1] * 8, [1023] * 8)
MEGA_DIMS = {
    32: ((5, 4, 128, 4, 32, 16, 6, 512), [0, 4, 1, 3, 2], [0, 0, 37, 50, 12]),
    80: ((8, 16, 2560, 32, 80, 64, 16, 10240), MEGA_SERVING[1],
         MEGA_SERVING[2]),
    96: ((8, 16, 1536, 16, 96, 64, 16, 6144), MEGA_SERVING[1],
         MEGA_SERVING[2]),
}
# --ab paged-walks: the split plans timed beside the chosen ones (waves of
# blocks a plan aims for: ops/paged_attention.py SPLIT_WAVES for row 1,
# ops/mega_decode.py MEGA_WAVES for row 13; rows a QKV producer takes:
# MEGA_ROWS)
PLAN_WAVES = (2, 4, 8, 16)
PLAN_ROWS = (16, 32, 64)
# mega serving at full width, 2 layers: gpt3-760m (d 96) and gpt3-2.7b (d 80)
MEGA_WIDE = ("gpt3-760m", "gpt3-2.7b")
MEGA_WIDE_LAYERS = 2


def walk_inputs(geom, dtype, kv, dev, seed=SEED):
    """Ragged-kernel inputs of a ``RAGGED_WALKS`` geometry: fp pools in
    ``dtype``, or int8 pools through the KV write's quantizer (``kv ==
    "int8"``) with their scale planes in the returned kwargs."""
    from paddle_tpu_torch.inference.kv_cache import quantize_kv_rows

    b, chunk, hq, hkv, d, ps, pps, kv_lens, q_lens = geom
    rng = np.random.RandomState(seed)
    num_pages = b * pps + 1
    q = rng.standard_normal((b, chunk, hq, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32)
              for _ in range(2))
    pt = rng.permutation(num_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    for i in range(b):
        pt[i, (kv_lens[i] + ps - 1) // ps:] = -1
    to = lambda a, t: torch.from_numpy(np.asarray(a)).to(dev, t)  # noqa: E731
    kp, vp = to(kp, torch.float32), to(vp, torch.float32)
    kw = {}
    if kv == "int8":
        (kp, ks), (vp, vs) = (quantize_kv_rows(t.reshape(-1, hkv, d))
                              for t in (kp, vp))
        shape = (num_pages, ps, hkv)
        kp, vp = kp.reshape(*shape, d), vp.reshape(*shape, d)
        kw = dict(k_scales=ks.reshape(shape), v_scales=vs.reshape(shape))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return (to(q, dtype), kp, vp, to(pt, torch.int32),
            to(kv_lens, torch.int32), to(q_lens, torch.int32)), kw


def ragged_case(args, kw, dtype, label, timed=True):
    """One ragged call against its plain version (``KERNEL_TOL``, rows
    past q_len zero) and a second launch bitwise equal to the first;
    kernel / plain / bound times when ``timed``."""
    from paddle_tpu_torch.ops.paged_attention import (
        ragged_paged_attention as kern,
        ragged_paged_attention_reference as plain)

    got = kern(*args, **kw)
    again = kern(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"ragged {label}: a second launch differs")
    want = plain(*args, **kw)
    q_lens = args[5]
    valid = torch.arange(got.shape[1], device=got.device)[None] \
        < q_lens[:, None]
    err, held = kernel_error(got[valid], want[valid], dtype)
    if not held <= KERNEL_TOL[dtype] or torch.count_nonzero(
            got[~valid]).item():
        raise AssertionError(f"ragged {label}: error {held} > "
                             f"{KERNEL_TOL[dtype]} or rows past q_len not "
                             "zero")
    out = dict(max_abs_err=err, held=held)
    if timed:
        nbytes, nops = ragged_work(args)
        out.update(ms=time_ms(lambda: kern(*args, **kw)),
                   plain_ms=time_ms(lambda: plain(*args, **kw), iters=5),
                   bound_ms=bound_ms(nbytes, nops, dtype), mb=nbytes / 1e6)
    return out


def phase_ragged_walks(dev):
    """The split walk at the decode round and at gpt3-1.3b's long
    contexts: fp and int8 KV, fp32 and bf16, against the plain version,
    bitwise repeats, kernel / plain / bound times and the walk's plan."""
    from paddle_tpu_torch.ops.paged_attention import walk_plan

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stats = {}
    for name, geom in RAGGED_WALKS.items():
        b, chunk, hq, hkv, d, ps, pps = geom[:7]
        for kv in ("fp", "int8"):
            for dtype in (torch.float32, torch.bfloat16):
                args, kw = walk_inputs(geom, dtype, kv, dev)
                st = ragged_case(args, kw, dtype, f"{name} {kv} {dtype}")
                plan = walk_plan(b, hkv, pps, ps, d, chunk * hq // hkv,
                                 args[1].element_size(), sms)
                stats[(name, kv, dtype)] = st
                log(f"[ragged] {name} {kv} KV {str(dtype)[6:]}: max_abs_err "
                    f"{st['max_abs_err']:.3e} (held {st['held']:.3e}), "
                    f"repeat bitwise equal; kernel {st['ms']:.4f} ms, plain "
                    f"{st['plain_ms']:.4f}, bound {st['bound_ms']:.6f} "
                    f"({st['mb']:.2f} MB); {plan.splits} splits of "
                    f"{plan.pages} pages, {plan.blocks} blocks "
                    f"({plan.waves:.2f} waves)")
    return stats


def mega_case(args, dtype, label, timed=True):
    """One mega attention call (the fused epilogue) against its plain
    version (as phase 10 holds it) and a second launch bitwise equal to
    the first; kernel / plain / bound times when ``timed``."""
    from paddle_tpu_torch.ops.mega_decode import (mega_attn_layer,
                                                  mega_attn_layer_reference)

    xb, p, pools, pt, ctx, q_lens = args
    pos = (xb, p, pools["k_pages"], pools["v_pages"], pt, ctx, q_lens)
    kw = dict(k_scales=pools.get("k_scales"), v_scales=pools.get("v_scales"))
    got = mega_attn_layer(*pos, **kw)
    again = mega_attn_layer(*pos, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"mega attention {label}: a second launch "
                             "differs")
    want = mega_attn_layer_reference(*pos, **kw)
    err, flips, total = mega_check_attn(got, want, q_lens, dtype, label)
    out = dict(max_abs_err=err, flips=f"{flips}/{total}")
    if timed:
        nbytes, nops = mega_attn_work(args, True)
        out.update(ms=time_ms(lambda: mega_attn_layer(*pos, **kw)),
                   plain_ms=time_ms(lambda: mega_attn_layer_reference(
                       *pos, **kw), iters=5),
                   bound_ms=bound_ms(nbytes, nops, dtype), mb=nbytes / 1e6)
    return out


def phase_mega_walks(dev):
    """The mega attention kernel at GPT-125M's decode round (fp32 and bf16,
    fp and int8 KV, timed) and at head dims 32 / 80 / 96 at their configs'
    widths (fp weights and KV, int8 g64 weights with int8 KV, the fused
    epilogue; phase 10 runs both at the serving shapes), against its plain
    version, with bitwise repeats."""
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kv in (False, True):
            args, _ = mega_inputs(MEGA_DECODE_ROUND, None, -1, kv, dtype, dev)
            label = (f"decode round {str(dtype)[6:]} "
                     f"{'int8' if kv else 'fp'} KV")
            st = mega_case(args, dtype, label)
            stats[("decode round", kv, dtype)] = st
            log(f"[mega] {label}: max_abs_err {st['max_abs_err']:.3e} "
                f"(payload flips {st['flips']}), repeat bitwise equal; "
                f"kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f}, "
                f"bound {st['bound_ms']:.6f} ({st['mb']:.2f} MB)")
    for d, case in MEGA_DIMS.items():
        for dtype in (torch.float32, torch.bfloat16):
            for wd, gs, kv in ((None, -1, False), ("int8", 64, True)):
                args, _ = mega_inputs(case, wd, gs, kv, dtype, dev)
                label = (f"d {d} (h {case[0][2]}) {str(dtype)[6:]} weights "
                         f"{wd or 'fp'}, {'int8' if kv else 'fp'} KV")
                st = mega_case(args, dtype, label, timed=False)
                log(f"[mega] {label}: max_abs_err {st['max_abs_err']:.3e} "
                    f"(payload flips {st['flips']}), repeat bitwise equal")
    return stats


def phase_mega_wide(dev):
    """``ServingPredictor(mega_decode=True)`` at gpt3-760m's (16 heads of
    96) and gpt3-2.7b's (32 heads of 80) widths, 2 layers, fp32, random
    weights from the numpy seed: the mega streams equal the per-op streams
    and the full-forward oracle, 2 launches of each mega kernel a step and
    none of the ragged kernel. Returns the mega attention and MLP launches
    (this path's own, reported apart from the main path's)."""
    from dataclasses import replace

    from paddle_tpu_torch.inference import ServingPredictor
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS

    total = [0, 0]
    for name in MEGA_WIDE:
        cfg = replace(GPT_CONFIGS[name], num_layers=MEGA_WIDE_LAYERS)
        model = state_from_jax_numpy(random_state(cfg, SEED), cfg,
                                     device=dev)
        model.eval()
        early, late = requests(cfg)
        per_op = [list(r.output_ids) for r in serve(
            ServingPredictor(model, max_batch=8, device=dev), early, late)]
        sp = ServingPredictor(model, max_batch=8, device=dev,
                              mega_decode=True)
        rows = StepRecord(sp)
        reset_counts()
        reqs = serve(sp, early, late)
        torch.cuda.synchronize()
        attn_n, mlp_n = mega_counts()
        ragged_n = read_counts()[1]
        ties, err = check_against_oracle(model, reqs, rows.rows, dev)
        outs = [list(r.output_ids) for r in reqs]
        log(f"[mega] serve {name} width (h {cfg.hidden_size}, "
            f"{cfg.num_heads} heads of {cfg.head_dim}, {cfg.num_layers} "
            f"layers) fp32: {sp.steps} steps, mega launches {attn_n} / "
            f"{mlp_n}, ragged {ragged_n}; streams match the full forward "
            f"({ties} near ties, logits max_abs_err {err:.3e}); equal to "
            f"the per-op streams: {outs == per_op}; "
            f"{len({t for o in outs for t in o})} distinct tokens")
        if not (attn_n == mlp_n == sp.steps * cfg.num_layers and attn_n
                and ragged_n == 0):
            raise AssertionError(f"{name} mega launches {attn_n} / {mlp_n},"
                                 f" ragged {ragged_n}, {sp.steps} steps")
        if outs != per_op:
            raise AssertionError(f"{name}: mega streams differ from the "
                                 "per-op streams")
        total[0] += attn_n
        total[1] += mlp_n
        del model, sp
    return total


def twin_route_count() -> int:
    """Calls routed to a plain twin on the card (a dtype no kernel is built
    for), summed over every kernel family's wrappers."""
    from paddle_tpu_torch.ops import twin_routes

    return twin_routes()


@contextlib.contextmanager
def twins():
    """Every kernel family takes its plain twin on the card while the block
    is open (each family's ``kernel_takes`` answers no, as it does for a
    dtype no kernel is built for; flash attention's callers then run plain
    attention): the twin route the fp16 paths are held against. Its calls
    count in ``.twin_routes``; no kernel launches."""
    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.nn.functional import attention
    from paddle_tpu_torch.ops import (fused_mlp, grouped_matmul, mega_decode,
                                      paged_attention, quant_matmul)

    saved = []
    for mod, fn in ((paged_attention, lambda dtype: False),
                    (fused_mlp, lambda dtype: False),
                    (quant_matmul, lambda dtype: False),
                    (grouped_matmul, lambda dtype: False),
                    (mega_decode, lambda dtype: False),
                    (attention, lambda q, k: False),
                    (gpt_spmd, lambda q, k: False)):
        saved.append((mod, mod.kernel_takes))
        mod.kernel_takes = fn
    try:
        yield
    finally:
        for mod, fn in saved:
            mod.kernel_takes = fn


def hold_streams(label, kern, twin, reqs, twin_reqs):
    """The fp16 kernel route's greedy streams against the twin route's, by
    the tie-margin rule the bf16 steps are held to: per request, every
    emitted position up to the first token that differs has its logits row
    within ``F16_STEP_TOL`` of the twin's (max abs error over the row's
    max |logit|); at that token the twin's top-2 margin must be within
    twice the row's error (a near tie), and the streams are not compared
    past it (their contexts differ). A position from which a token of the
    request took other experts in some layer (MoE) ends the comparison
    too, counted. Returns (tokens equal, near ties, router flips)."""
    flipped = {}
    for (at_k, slots, seen_k), (_, _, seen_t) in zip(kern.calls, twin.calls):
        diff = torch.zeros_like(slots, dtype=torch.bool)
        for a, b in zip(seen_k, seen_t):
            diff |= (a != b).any(-1) & (slots >= 0)
        for slot in set(slots[diff].tolist()):
            req_id, j = at_k[slot]
            flipped.setdefault(req_id, j)
    same = ties = 0
    worst = 0.0
    outs = [list(r.output_ids) for r in reqs]
    for i, (rk, rt) in enumerate(zip(reqs, twin_reqs)):
        o, w = outs[i], list(rt.output_ids)
        stop = flipped.get(rk.req_id, len(o))
        for j, (a, b) in enumerate(zip(o, w)):
            if j >= stop:
                break
            row_k = kern.rows.get((rk.req_id, j))
            row_t = twin.rows.get((rt.req_id, j))
            if row_k is None or row_t is None:   # emitted by a prefill
                if a != b:
                    raise AssertionError(f"fp16 ({label}) request {i} token "
                                         f"{j}: {a} vs the twin's {b} with "
                                         "no logits row to hold them")
                same += 1
                continue
            err = (row_k - row_t).abs().max().item()
            held = err / row_t.abs().max().clamp_min(1e-30).item()
            worst = max(worst, held)
            if not held <= F16_STEP_TOL:
                raise AssertionError(f"fp16 ({label}) request {i} token {j}:"
                                     f" logits {held:.3e} of the row's max "
                                     f"from the twin's (tol {F16_STEP_TOL})")
            if a == b:
                same += 1
                continue
            top2 = row_t.topk(2).values
            margin = (top2[0] - top2[1]).item()
            if margin > 2 * err:
                raise AssertionError(f"fp16 ({label}) request {i} token {j}:"
                                     f" {a} vs the twin's {b}, top-2 margin "
                                     f"{margin:.3e} > 2 x {err:.3e}")
            ties += 1
            break
    log(f"[fp16] serve ({label}): kernel vs twin route, logits rows within "
        f"{worst:.3e} of their max (tol {F16_STEP_TOL}); {same} of "
        f"{sum(map(len, outs))} tokens equal before a near tie ({ties}) or a"
        f" router flip ({len(flipped)} requests)")
    return same, ties, len(flipped)


def serve16(label, make, cfg, early, late, legacy=False, routes=False):
    """One fp16 served run of ``make()`` on the kernels and one on the twins,
    held by :func:`hold_streams`. Returns the kernel run's launch counts
    (read right after it) and its step count."""
    sp = make()
    rec = StepRecord(sp, legacy, routes)
    reset_counts()
    n0 = twin_route_count()
    reqs = serve(sp, early, late)
    outs = [list(r.output_ids) for r in reqs]
    torch.cuda.synchronize()
    counts = dict(routes=twin_route_count() - n0, ragged=read_counts()[1],
                  decode=legacy_counts()[0], qmm=qmm_counts(),
                  qmm_tc=qmm_tc_count(), mega=mega_counts(),
                  gmm=gmm_counts(), gmm_tc=gmm_tc_counts(),
                  gmm_sk=gmm_sk_count(), steps=sp.steps,
                  kv=str(sp.cache.k_pool.dtype)[6:], calls=rec.n)
    if sum(map(len, outs)) != MAX_NEW * len(outs) or not all(
            0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError(f"fp16 ({label}): malformed streams")
    with twins():
        sp_t = make()
        rec_t = StepRecord(sp_t, legacy, routes)
        n1 = twin_route_count()
        twin_reqs = serve(sp_t, early, late)
        torch.cuda.synchronize()
        if twin_route_count() == n1:
            raise AssertionError(f"fp16 ({label}): the twin route ran no "
                                 "twin")
    counts["held"] = hold_streams(label, rec, rec_t, reqs, twin_reqs)
    return counts


def f16_grads_held(label, kern, plain, exact, tol):
    """Per gradient leaf, the fp16 kernel route against the fp16 plain
    route: within ``tol`` of the leaf's max |grad|; where a leaf is past it,
    the kernel route's worst leaf distance from the exact gradients (the
    fp32 plain route on the same weights) within ``BERT_NOISE_MARGIN`` x
    the plain route's; and every kernel leaf within ``F16_GRAD_CAP`` of
    exact, or no farther from it than ``BERT_NOISE_MARGIN`` x the plain
    route's leaf (fp16 without loss scaling loses gradient on leaves no
    kernel touches, BERT's MLM head among them, on both routes alike).
    Returns the readings."""
    errs = _grad_errors(kern, plain)
    ek, ep = (_grad_errors(g, exact) for g in (kern, plain))
    worst = max(errs, key=errs.get)
    noisy = sorted(n for n in errs if errs[n] > tol)
    far = sorted(n for n in ek if not (ek[n] <= F16_GRAD_CAP
                                       or ek[n] <= BERT_NOISE_MARGIN * ep[n]))
    ratio = max(ek.values()) / max(max(ep.values()), 1e-30)
    log(f"[fp16] {label}: {len(errs)} gradient leaves, kernel vs plain "
        f"route worst {worst} {errs[worst]:.3e} of its max |grad| (tol "
        f"{tol}), {len(noisy)} past it; from the exact fp32 gradients, "
        f"worst leaf kernel route {max(ek.values()):.3e} (cap "
        f"{F16_GRAD_CAP}), plain route {max(ep.values()):.3e}, ratio "
        f"{ratio:.3f} (margin {BERT_NOISE_MARGIN}"
        + (" held)" if noisy else " not needed)"))
    if far or (noisy and ratio > BERT_NOISE_MARGIN):
        raise AssertionError(f"fp16 {label}: kernel and plain routes "
                             f"disagree: past the cap {far}, worst-leaf "
                             f"ratio {ratio} on {noisy}")
    return dict(worst=errs[worst], noisy=len(noisy), ratio=ratio)


def f16_serving(model, cfg, dev):
    """(a) GPT-125M served in fp16, each config on the kernels and then on
    the twins (:func:`serve16`), the kernel runs' launches checked; then
    the fp16 full forward on ids [4, 512] against plain attention.
    Returns the fp16 launches by kernel row."""
    from dataclasses import replace

    from paddle_tpu_torch.inference import ServingPredictor
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)

    f16, L = torch.float16, cfg.num_layers
    early, late = requests(cfg)
    n = dict.fromkeys(("ragged", "decode", "flash_fwd", "qmm_int8",
                       "qmm_int4", "mega_attn", "mega_mlp", "gmm_fp",
                       "gmm_int8", "gmm_int4"), 0)
    for label, quant, kw in F16_SERVE:
        c = serve16(label, lambda: quant_predictor(model, cfg, quant, dev,
                                                   dtype=f16, **kw),
                    cfg, early, late, legacy=kw.get("unified") is False)
        steps, bits = c["steps"], quant.get("weight_dtype")
        mega = kw.get("mega_decode", False)
        legacy = kw.get("unified") is False
        want = dict(ragged=0 if mega or legacy else L * steps,
                    decode=L * c["calls"] if legacy else 0,
                    mega=(L * steps,) * 2 if mega else (0, 0))
        got = dict(ragged=c["ragged"], decode=c["decode"], mega=c["mega"])
        qmm = c["qmm"].get(bits, 0) if bits else 0
        log(f"[fp16] serve ({label}): {steps} steps, twin routes "
            f"{c['routes']}, launches ragged {c['ragged']}, decode "
            f"{c['decode']}, mega {c['mega']}, weight-only GEMM {c['qmm']} "
            f"({c['qmm_tc']} on the tensor-core route), KV pool {c['kv']}")
        if (c["routes"] or got != want or (bits and (
                qmm != 4 * L * (steps if not legacy else c["calls"]) or
                (not legacy and c["qmm_tc"] != qmm)))
                or (quant.get("kv_cache_dtype") == "int8") != (
                    c["kv"] == "int8")):
            raise AssertionError(f"fp16 ({label}): routes {c['routes']}, "
                                 f"launches {got} (want {want}), GEMM "
                                 f"{c['qmm']} / tc {c['qmm_tc']}")
        n["ragged"] += c["ragged"]
        n["decode"] += c["decode"]
        n["mega_attn"] += c["mega"][0]
        n["mega_mlp"] += c["mega"][1]
        if bits:
            n[f"qmm_{bits}"] += qmm
    # MoE, 4 experts top-2 at cf 4.0 (nothing dropped), fp / int8 / int4
    # g128 expert stacks (the qkv and output projections quantized too)
    mcfg = replace(cfg, **MOE, moe_capacity_factor=4.0)
    moe = moe_model(mcfg, dev)
    for label, quant in F16_MOE:
        c = serve16(label, lambda: quant_predictor(moe, mcfg, quant, dev,
                                                   dtype=f16),
                    mcfg, early, late, routes=True)
        steps, bits = c["steps"], quant.get("weight_dtype")
        kind = bits or "fp"
        want = 2 * L * steps
        ok = (not c["routes"] and c["ragged"] == L * steps
              and c["gmm"][kind] == want == sum(c["gmm"].values())
              and (c["gmm_tc"][0] == want if kind == "fp"
                   else c["gmm_sk"] == want)
              and (not bits or c["qmm"][bits] == c["qmm_tc"] == want))
        log(f"[fp16] serve ({label}): {steps} steps, twin routes "
            f"{c['routes']}, grouped GEMM {c['gmm']} (tensor cores "
            f"{c['gmm_tc'][0]}, skinny {c['gmm_sk']}), weight-only GEMM "
            f"{c['qmm']} ({c['qmm_tc']} tensor-core), ragged {c['ragged']}")
        if not ok:
            raise AssertionError(f"fp16 ({label}): launches {c}")
        n[f"gmm_{kind}"] += c["gmm"][kind]
        n["ragged"] += c["ragged"]
        if bits:
            n[f"qmm_{bits}"] += c["qmm"][bits]
    del moe
    # the fp16 full forward on ids [4, 512]: flash against plain attention
    m16 = state_from_jax_numpy(random_state(cfg, SEED), replace(cfg),
                               device=dev, dtype=f16)
    m16.eval()
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (4, 512))).to(dev)
    with torch.no_grad():
        reset_counts()
        n0 = twin_route_count()
        logits = m16(ids).float()
        torch.cuda.synchronize()
        flash_n, routes = read_counts()[0], twin_route_count() - n0
        m16.config.use_flash_attention = False
        plain = m16(ids).float()
    held = ((logits - plain).abs().amax(-1)
            / plain.abs().amax(-1).clamp_min(1e-30)).max().item()
    log(f"[fp16] GPT-125M fp16 full forward on ids [4, 512]: flash "
        f"launches {flash_n}, twin routes {routes}; logits vs plain "
        f"attention {held:.3e} of each row's max (tol {F16_STEP_TOL})")
    if flash_n != L or routes or not held <= F16_STEP_TOL or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"fp16 full forward: flash {flash_n}, routes "
                             f"{routes}, logits {held}")
    n["flash_fwd"] += flash_n
    del m16
    return n


def f16_training(dev):
    """(b) the fused LN + residual and bias + GELU forward at GPT-125M's
    widths against the fp16 twins; the ``gpt_spmd`` training step in fp16
    at gpt3-760m's width (16 heads of 96), 2 layers, b 2, s 1024, unfused
    and ``fused_mlp``, no loss scaling: gradients on the kernels against
    the plain route and the exact fp32 gradients (:func:`f16_grads_held`),
    then ``F16_TRAIN_STEPS`` momentum-SGD steps with finite, falling
    losses. Returns the launches by kernel row."""
    from dataclasses import replace

    from paddle_tpu_torch.models import gpt_spmd
    from paddle_tpu_torch.models.convert import random_train_params
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops.fused_mlp import (fused_bias_gelu,
                                                fused_ln_residual)

    f16 = torch.float16
    n = dict.fromkeys(("flash_fwd", "flash_bwd", "ln_fwd", "ln_bwd",
                       "gelu_fwd", "gelu_bwd"), 0)
    rng = np.random.RandomState(SEED)
    h16 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev, f16)
    x, res, h1 = h16(2048, 768), h16(2048, 768), h16(2048, 3072)
    g, bt, bias = 1 + 0.1 * h16(768), 0.1 * h16(768), 0.1 * h16(3072)
    reset_counts()
    n0 = twin_route_count()
    outs = (*fused_ln_residual(x, res, g, bt), fused_bias_gelu(h1, bias))
    torch.cuda.synchronize()
    counts, routes = fused_counts(), twin_route_count() - n0
    with twins():
        want = (*fused_ln_residual(x, res, g, bt), fused_bias_gelu(h1, bias))
    errs = [kernel_error(a, b, f16)[1] for a, b in zip(outs, want)]
    log(f"[fp16] fused LN + residual (y, s) / bias + GELU forward at [2048, "
        f"768] / [2048, 3072]: launches {counts[0]} / {counts[2]}, twin "
        f"routes {routes}; row errors vs the fp16 twins "
        + " / ".join(f"{e:.3e}" for e in errs) + f" (tol {F16_TOL})")
    if routes or counts[0] != 1 or counts[2] != 1 or not max(errs) <= F16_TOL:
        raise AssertionError(f"fp16 fused forward: routes {routes}, "
                             f"launches {counts}, errors {errs}")
    n["ln_fwd"] += counts[0]
    n["gelu_fwd"] += counts[2]
    base = replace(GPT_CONFIGS["gpt3-760m"], num_layers=2, recompute=True,
                   remat_save_attn=True)
    weights = random_train_params(base, SEED)
    # the exact route's fp32 weights: the fp16 ones, widened
    weights32 = gpt_spmd.unflatten(
        (path, a.astype(np.float16).astype(np.float32))
        for path, a in gpt_spmd.leaves(weights))
    exact = None   # the fp32 plain route: one function, fused or not
    for fused in (False, True):
        cfg = replace(base, fused_mlp=fused)
        tag = f"gpt_spmd fp16 {'fused_mlp' if fused else 'unfused'}"
        grads = {} if exact is None else dict(exact=exact)
        for route in ("kernel", "plain", "exact")[:3 if exact is None else 2]:
            with twins() if route != "kernel" else contextlib.nullcontext():
                step, params, mom, (ids, labels) = \
                    gpt_spmd.build_spmd_train_step(
                        cfg, batch_size=2, seq_len=1024, num_micro=1,
                        lr=0.05, device=dev,
                        params=weights32 if route == "exact" else weights,
                        dtype=torch.float32 if route == "exact" else f16)
                reset_counts()
                n0 = twin_route_count()
                loss, g = gpt_spmd.value_and_grad(params, ids, labels, cfg, 1)
                torch.cuda.synchronize()
                grads[route] = (loss.item(), dict(gpt_spmd.leaves(g)))
            if route == "kernel":
                launches = (read_counts()[0], bwd_count(), *fused_counts())
                routes = twin_route_count() - n0
                losses = []
                for _ in range(F16_TRAIN_STEPS):
                    params, mom, loss = step(params, mom, ids, labels)
                    losses.append(loss.item())
                torch.cuda.synchronize()
                total = (read_counts()[0], bwd_count(), *fused_counts())
            del step, params, mom, g
        exact = grads["exact"]
        loss_err = abs(grads["kernel"][0] - grads["plain"][0]) / abs(
            grads["plain"][0])
        log(f"[fp16] {tag}, 2 layers b2 s1024 recompute+save_attn: loss "
            f"{grads['kernel'][0]:.6f} vs plain {grads['plain'][0]:.6f} "
            f"(rel err {loss_err:.3e}, tol {F16_LOSS_TOL}), exact fp32 "
            f"{grads['exact'][0]:.6f}; launches flash fwd/bwd, LN fwd/bwd, "
            f"GELU fwd/bwd {launches}, twin routes {routes}; "
            f"{F16_TRAIN_STEPS} steps at lr 0.05: "
            + ", ".join(f"{x:.6f}" for x in losses))
        f16_grads_held(tag, grads["kernel"][1], grads["plain"][1],
                       grads["exact"][1], F16_GRAD_TOL)
        want = (2, 2) + ((2, 2, 2, 2) if fused else (0, 0, 0, 0))
        if (routes or launches[:2] != want[:2] or (fused and not all(
                launches[2:])) or (not fused and any(launches[2:]))
                or not loss_err <= F16_LOSS_TOL
                or not np.isfinite(losses).all()
                or not losses[-1] < losses[0]):
            raise AssertionError(f"{tag}: routes {routes}, launches "
                                 f"{launches} (want {want[:2]} flash), loss "
                                 f"{loss_err}, steps {losses}")
        for key, v in zip(("flash_fwd", "flash_bwd", "ln_fwd", "ln_bwd",
                           "gelu_fwd", "gelu_bwd"), total):
            n[key] += v
    return n


def f16_bert(dev):
    """(c) BERT in fp16 at bert-base width (12 heads of 64), 2 layers, the
    padded batch of phase 13 (16 x 512, lengths 64-512): the MLM + NSP
    gradients through the masked kernels against ``plain_attention()`` and
    the exact fp32 gradients (:func:`f16_grads_held`); then
    ``flash_attn_unpadded`` on the batch's lengths (phase 13 (c) in fp16).
    Returns the mask and lens launches."""
    from dataclasses import replace

    from paddle_tpu_torch.models.bert import BERT_CONFIGS
    from paddle_tpu_torch.models.convert import (bert_from_jax_numpy,
                                                 bert_to_numpy,
                                                 random_bert_state)

    cfg = replace(BERT_CONFIGS["bert-base"], hidden_dropout=0.0,
                  attn_dropout=0.0, num_layers=F16_BERT_LAYERS)
    L = cfg.num_layers
    state = random_bert_state(cfg, SEED)
    batch = bert_batch(cfg, dev, SEED)
    lens = batch.pop("lens")
    n0 = twin_route_count()
    model = bert_from_jax_numpy(state, cfg, device=dev, dtype=torch.float16)
    losses, grads = zip(*(bert_route_grads(model, batch, flash, L)
                          for flash in (True, False)))
    routes = twin_route_count() - n0
    # exact: the fp32 plain route on the fp16 weights, widened
    exact = bert_route_grads(bert_from_jax_numpy(
        bert_to_numpy(model.state_dict()), cfg, device=dev), batch, False, L)
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    log(f"[fp16] bert-base width fp16, {L} layers, batch {BERT_BATCH} x "
        f"{BERT_SEQ} (lengths {lens.tolist()}): masked flash launches "
        f"{L} / {L}, twin routes {routes}; loss {losses[0]:.6f} vs plain "
        f"{losses[1]:.6f} (rel err {loss_err:.3e}, tol {F16_LOSS_TOL}), "
        f"exact fp32 {exact[0]:.6f}")
    f16_grads_held(f"bert fp16 {L} layers", grads[0], grads[1], exact[1],
                   F16_GRAD_TOL)
    if routes or not loss_err <= F16_LOSS_TOL or not np.isfinite(losses[0]):
        raise AssertionError(f"bert fp16: routes {routes}, loss {loss_err}")
    del model, grads, exact
    varlen, _ = phase_bert_varlen(dev, lens, torch.float16)
    return dict(mask_fwd=L, mask_bwd=L, lens_fwd=varlen["fwd"],
                lens_bwd=varlen["bwd"])


def f16_grad_drives(model, cfg, dev):
    """(d) the input-gradient drives in fp16: d(loss)/d(input embeddings)
    through GPT-125M's 12 layers with int8 and int4 g128 weights (rows 11
    and 12 under the custom op's backward), and through layer 0 of the
    2-layer MoE model's FFN with fp and int8 expert stacks (rows 18 and
    19), each against the same drive on the plain versions, to
    ``F16_DRIVE_TOL`` of its max |grad|. Returns the backward launches."""
    from dataclasses import replace

    from paddle_tpu_torch.inference.quantize import quantize_weight
    from paddle_tpu_torch.models.moe import moe_ffn
    from paddle_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                   quant_matmul_reference)

    f16, n = torch.float16, {}
    ids = torch.from_numpy(np.random.RandomState(SEED + 3).randint(
        0, cfg.vocab_size, 257)).to(dev)
    for bits, quant in (("int8", dict(weight_dtype="int8")),
                        ("int4", dict(weight_dtype="int4",
                                      weight_quant_group_size=128))):
        params = quant_predictor(model, cfg, quant, dev, dtype=f16).params
        grads, counts = {}, None
        for name, mm in (("kernel", quant_matmul),
                         ("plain", quant_matmul_reference)):
            x = embed(params, ids[:-1]).detach().requires_grad_()
            reset_counts()
            n0 = twin_route_count()
            logits = quant_forward(params, x, cfg, False, mm)
            torch.nn.functional.cross_entropy(logits.float(),
                                              ids[1:]).backward()
            torch.cuda.synchronize()
            if name == "kernel":
                counts, routes = qmm_counts(), twin_route_count() - n0
                tc = qmm_dx_tc_count()
            grads[name] = x.grad.float()
        err = ((grads["kernel"] - grads["plain"]).abs().max()
               / grads["plain"].abs().max()).item()
        want = 4 * cfg.num_layers
        log(f"[fp16] {bits} gradient wrt the input embeddings ([256, 768]) "
            f"through {cfg.num_layers} quantized layers: kernel vs plain "
            f"{err:.3e} of its max |grad| (tol {F16_DRIVE_TOL}); launches "
            f"{counts} ({tc} dx on the tensor-core route), twin routes "
            f"{routes}")
        if (routes or not err <= F16_DRIVE_TOL or counts[bits] != want
                or counts[f"{bits}_bwd"] != want or tc != want):
            raise AssertionError(f"fp16 {bits} input gradient: {err}, "
                                 f"launches {counts}, {tc} dx on the "
                                 f"tensor-core route, routes {routes}")
        n[f"qmm_{bits}_bwd"] = counts[f"{bits}_bwd"]
    mcfg = replace(cfg, **MOE, num_layers=2)
    moe = moe_model(mcfg, dev)
    m = moe.gpt.layers[0].mlp
    x0 = moe.gpt.embeddings(ids[None, :-1]).detach().reshape(
        -1, cfg.hidden_size).to(f16)
    r = torch.from_numpy(np.random.RandomState(SEED + 5).standard_normal(
        x0.shape).astype(np.float32)).to(dev)
    w16 = [t.detach().to(f16) for t in (m.gate_weight, m.w1, m.b1, m.w2,
                                        m.b2)]
    for kind in ("fp", "int8"):
        w1, w2 = w16[1], w16[3]
        if kind == "int8":
            w1, w2 = (quantize_weight(w, "int8") for w in (w1, w2))
        dx = {}
        for use_kernel in (None, False):
            x = x0.clone().requires_grad_()
            reset_counts()
            n0 = twin_route_count()
            out, _ = moe_ffn(x, w16[0], w1, w16[2], w2, w16[4],
                             top_k=mcfg.moe_top_k,
                             capacity_factor=mcfg.moe_capacity_factor,
                             use_kernel=use_kernel)
            (out.float() * r).sum().backward()
            torch.cuda.synchronize()
            if use_kernel is None:
                counts, tc = gmm_counts(), gmm_tc_counts()
                routes, n_dx = twin_route_count() - n0, gmm_dx_count()
            dx[use_kernel] = x.grad.float()
        err = ((dx[None] - dx[False]).abs().max()
               / dx[False].abs().max()).item()
        log(f"[fp16] input gradient through layer 0's MoE FFN ({kind} "
            f"expert stacks, {list(x0.shape)}): kernel vs plain {err:.3e} of "
            f"its max |grad| (tol {F16_DRIVE_TOL}); launches {counts}, "
            f"tensor-core {tc}, dx route {n_dx}, twin routes {routes}")
        if (routes or not err <= F16_DRIVE_TOL
                or counts[f"{kind}_bwd"] != 2
                or n_dx != (2 if kind == "int8" else 0)
                or (kind == "fp" and tc != [2, 2])):
            raise AssertionError(f"fp16 MoE {kind} input gradient: {err}, "
                                 f"launches {counts}, tc {tc}, dx route "
                                 f"{n_dx}")
        n[f"gmm_{kind}_bwd"] = counts[f"{kind}_bwd"]
    del moe
    return n


def phase_fp16(model, cfg, dev):
    """Phase 14: the fp16 paths on the fp16 kernels, ``ops.twin_routes()``
    0 on each: (a) serving, (b) the fused-MLP forward and the training
    step, (c) BERT, (d) the input-gradient drives. Returns the fp16
    launches by kernel row."""
    n = {}
    for part in (f16_serving(model, cfg, dev), f16_training(dev),
                 f16_bert(dev), f16_grad_drives(model, cfg, dev)):
        for k, v in part.items():
            n[k] = n.get(k, 0) + v
    log(f"[fp16] launches on the fp16 paths by kernel row: {n}")
    return n


def paged_walks_only(root: Path) -> int:
    """``--ab paged-walks [ROOT]``: rows 1 and 13 (the ragged and the mega
    attention kernels) at the table shapes and GPT-125M's decode round, and
    rows 4 and 14 (the paged decode kernel and the mega MLP, unchanged
    controls) at the table shapes, fp32 and bf16, with the
    ``paddle_tpu_torch`` package of the checkout at ``ROOT`` (default:
    this one); then the bf16 per-op and mega serving steps of GPT-125M
    (wall, one profiled run each: device busy); prints one JSON line. Run
    it with two trees in turns to compare them on one card."""
    sys.path.insert(0, str(root))
    import paddle_tpu_torch
    from paddle_tpu_torch.inference import ServingPredictor
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops.mega_decode import mega_mlp
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    rows = {}
    decode = RAGGED_WALKS["decode round"]
    for dtype in (torch.float32, torch.bfloat16):
        t = str(dtype)[6:]
        for kv in ("fp", "int8"):
            args, kw = walk_inputs((8, 16, 12, 12, 64, 64, 16,
                                    [0, 1024, 1000, 333, 64, 16, 700, 517],
                                    [0, 1, 16, 7, 1, 16, 12, 1]), dtype, kv,
                                   dev)
            rows[f"1 table {kv} KV {t}"] = ragged_case(args, kw, dtype, kv)
            args, kw = walk_inputs(decode, dtype, kv, dev)
            rows[f"1 decode round {kv} KV {t}"] = ragged_case(args, kw,
                                                              dtype, kv)
        for wd, gs, kv in ((None, -1, False), ("int8", 128, True)):
            label = ("fp" if wd is None else "int8 g128 + int8 KV")
            args, (y2, s_res) = mega_inputs(MEGA_SERVING, wd, gs, kv, dtype,
                                            dev)
            rows[f"13 table {label} {t}"] = mega_case(args, dtype, label)
            if wd is None:
                p = args[1]
                nbytes, nops = mega_mlp_work(y2, p, True)
                rows[f"14 table {t}"] = dict(
                    ms=time_ms(lambda: mega_mlp(y2, s_res, p)),
                    bound_ms=bound_ms(nbytes, nops, dtype))
        args, _ = mega_inputs(MEGA_DECODE_ROUND, None, -1, False, dtype, dev)
        rows[f"13 decode round {t}"] = mega_case(args, dtype, "decode round")
        dargs = decode_inputs(DECODE_SERVING[0], DECODE_SERVING[1], dtype,
                              dev, SEED)
        nbytes, nops = decode_work(dargs)
        rows[f"4 table {t}"] = dict(ms=time_ms(lambda: paged_attention(
            *dargs)), bound_ms=bound_ms(nbytes, nops, dtype))
    plans = {}
    from paddle_tpu_torch.ops import paged_attention as pa
    if hasattr(pa, "SPLIT_WAVES"):   # the split walk: other plans, timed
        chosen = pa.SPLIT_WAVES
        table = (8, 16, 12, 12, 64, 64, 16,
                 [0, 1024, 1000, 333, 64, 16, 700, 517],
                 [0, 1, 16, 7, 1, 16, 12, 1])
        from paddle_tpu_torch.ops import mega_decode as md
        chosen_mega, chosen_rows = md.MEGA_WAVES, md.MEGA_ROWS
        mega_cases = (("table", MEGA_SERVING),
                      ("decode round", MEGA_DECODE_ROUND))
        for waves in PLAN_WAVES:
            pa.SPLIT_WAVES = md.MEGA_WAVES = waves
            for dtype in (torch.float32, torch.bfloat16):
                t = str(dtype)[6:]
                for name, geom in (("table", table), ("decode round",
                                                      decode)):
                    args, kw = walk_inputs(geom, dtype, "fp", dev)
                    plans[f"1 {name} {t} waves {waves}"] = ragged_case(
                        args, kw, dtype, name)["ms"]
                for name, case in mega_cases:
                    args, _ = mega_inputs(case, None, -1, False, dtype, dev)
                    plans[f"13 {name} {t} waves {waves}"] = mega_case(
                        args, dtype, name)["ms"]
        pa.SPLIT_WAVES, md.MEGA_WAVES = chosen, chosen_mega
        for mrows in PLAN_ROWS if hasattr(md, "MEGA_ROWS") else ():
            md.MEGA_ROWS = mrows
            for dtype in (torch.float32, torch.bfloat16):
                for name, case in mega_cases:
                    args, _ = mega_inputs(case, None, -1, False, dtype, dev)
                    plans[f"13 {name} {str(dtype)[6:]} rows {mrows}"] = \
                        mega_case(args, dtype, name)["ms"]
            md.MEGA_ROWS = chosen_rows
        for label, ms in plans.items():
            log(f"[paged-walks] plan: row {label}: {ms:.4f} ms ({card})")
    for label, st in rows.items():
        log(f"[paged-walks] row {label}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in st.items()) + f" ({card})")
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    early, late = requests(cfg)
    steps = {}
    for mega in (False, True):
        name = "mega" if mega else "per-op"
        walls = []
        for run in range(3):
            sp = ServingPredictor(model, max_batch=8, device=dev,
                                  dtype=torch.bfloat16, mega_decode=mega)
            ms = timed_serve(sp, early, late)["step_ms"]
            if run:
                walls.append(ms)
        sp = ServingPredictor(model, max_batch=8, device=dev,
                              dtype=torch.bfloat16, mega_decode=mega)
        prof = profile_serve(sp, early, late, card, f"[paged-walks] {name}")
        busy = None if prof is None else prof[1] / 1e3 / prof[2]
        steps[name] = dict(step_ms=walls, busy_ms_per_step=busy,
                           steps=sp.steps)
        log(f"[paged-walks] serve {name} bf16: mean step "
            + " / ".join(f"{w:.3f}" for w in walls) + " ms; device busy "
            + ("not measured" if busy is None else f"{busy:.4f} ms")
            + f" a step ({sp.steps} steps; {card})")
    print(json.dumps({"paged_walks": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        rows=rows, plans=plans, serve=steps)}), flush=True)
    return 0


def qmm_four(bits, gs, dtype, dev, m=QMM_ROWS, bwd=False, digest=False):
    """Summed kernel and bound times of one layer's four serving GEMMs
    (forward, or dx with ``bwd``) at ``m`` tokens; with ``digest`` also each
    GEMM's time and a digest of the four outputs' bytes (equal digests:
    bitwise-equal outputs)."""
    import hashlib

    from paddle_tpu_torch.ops.quant_matmul import (quant_matmul_bwd,
                                                   quant_matmul_fwd)

    ms, work, each, h = 0.0, [0.0, 0.0], [], hashlib.sha1()
    for ci, (k, n) in enumerate(QMM_SHAPES.values()):
        x, dy, q, sc = qmm_case(m, k, n, f"int{bits}", gs, dtype, dev,
                                SEED + ci)
        if bwd:
            fn = lambda: quant_matmul_bwd(dy, q, sc, k, dtype)  # noqa: E731
        else:
            fn = lambda: quant_matmul_fwd(x, q, sc)  # noqa: E731
        each.append(time_ms(fn))
        ms += each[-1]
        if digest:   # fp32 holds every bf16 / fp16 value exactly
            h.update(fn().float().cpu().numpy().tobytes())
        nbytes, nops = qmm_work(m, k, n, bits, sc.shape[0], x.element_size())
        work = [work[0] + nbytes, work[1] + nops]
    out = dict(ms=ms, bound_ms=bound_ms(*work, dtype))
    if digest:
        out.update(each=each, digest=h.hexdigest()[:16])
    return out


# --ab qmm-dx: the dx route's split plans swept (stages of N a split,
# forced into the plan; the plan's own choice is timed beside them)
DX_SWEEP_PER = (1, 2, 3, 4, 6, 8, 12)


def dx_backward_profile(params, cfg, dev, card, tag):
    """The input-gradient drive's backward profiled by
    :func:`backward_profile`: its weight-only GEMM dx kernels
    (``qmm_dx_kernel``, or ``qmm_kernel<.., true>`` where the package has
    no dx route)."""
    from paddle_tpu_torch.ops.quant_matmul import quant_matmul

    ids = torch.from_numpy(np.random.RandomState(SEED + 3).randint(
        0, cfg.vocab_size, 257)).to(dev)

    def loss_fn():
        x = embed(params, ids[:-1]).detach().requires_grad_()
        return torch.nn.functional.cross_entropy(
            quant_forward(params, x, cfg, False, quant_matmul).float(),
            ids[1:])

    return backward_profile(
        loss_fn, r"qmm_dx_kernel|qmm_kernel<[^>]*, true>", card, tag)


def backward_profile(loss_fn, pattern, card, tag):
    """One backward of ``loss_fn()`` (a warm-up drive first; the forward
    outside the window) under ``torch.profiler``: device time of the
    kernels whose names match ``pattern``, their count and the whole
    backward's device time; None when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loss_fn().backward()
    loss = loss_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        loss.backward()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    dx_us = all_us = 0.0
    n = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.duration_ns() <= 0:
            continue
        all_us += ev.duration_ns() / 1e3
        if re.search(pattern, ev.name()):
            dx_us += ev.duration_ns() / 1e3
            n += 1
    if all_us <= 0:
        log(f"{tag} profiler: no device time in the trace (not measured)")
        return None
    log(f"{tag} one profiled backward: dx kernels {dx_us / 1e3:.4f} ms "
        f"device ({n} launches) of {all_us / 1e3:.4f} ms ({card})")
    return dict(dx_ms=dx_us / 1e3, backward_ms=all_us / 1e3, dx_launches=n)


def qmm_dx_only(root: Path) -> int:
    """``--ab qmm-dx [ROOT]``: rows 11 and 12 (the weight-only GEMM's dx:
    one layer's four serving GEMMs at M 8, 24 and 256 in fp32, bf16 and
    fp16, int8 per channel, int8 g128 and int4 g128), the controls rows 9
    and 10 (the int8 and int4 g128 forwards at M 24 in bf16 and fp16, each
    GEMM's time and a digest of the outputs), where ROOT's package has the
    tensor-core dx route its split plans swept (``DX_SWEEP_PER`` stages a
    split, bf16, M 8, 24 and 256), then the bf16 input-gradient drives (GPT-125M,
    [256, 768] through 12 int8 / int4 g128 layers): the dx kernels' device
    time in one profiled backward; all with the ``paddle_tpu_torch``
    package of the checkout at ``ROOT`` (default: this one). Prints one
    JSON line; run it with two trees in turns to compare them on one
    card."""
    sys.path.insert(0, str(root))
    import paddle_tpu_torch
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops import quant_matmul as qm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    rows = {}
    for wd, gs in QMM_CONFIGS:
        bits = int(wd[3:])
        for dtype in DTYPES:
            for m in (QMM_DECODE_ROWS, QMM_ROWS, QMM_DX_ROWS):
                rows[f"{11 if bits == 8 else 12} dx {wd} g{gs} M {m} "
                     f"{str(dtype)[6:]}"] = qmm_four(bits, gs, dtype, dev,
                                                     m=m, bwd=True,
                                                     digest=True)
    for bits, gs in ((8, -1), (4, 128)):
        for dtype in (torch.bfloat16, torch.float16):
            rows[f"{9 if bits == 8 else 10} fwd int{bits} g{gs} M "
                 f"{QMM_ROWS} {str(dtype)[6:]}"] = qmm_four(
                     bits, gs, dtype, dev, digest=True)
    for label, st in rows.items():
        log(f"[qmm-dx] row {label}: ms {st['ms']:.4f} (each " + ", ".join(
            f"{v:.4f}" for v in st["each"]) + f"), bound "
            f"{st['bound_ms']:.4f}, digest {st['digest']} ({card})")
    sweep = {}
    if hasattr(qm.quant_matmul_bwd, "tc_launches"):
        plan = qm.qmm_plan
        for per in DX_SWEEP_PER:
            def forced(m, k, n, groups, dtype, packed, bwd, aligned, sms,
                       per=per):
                p = plan(m, k, n, groups, dtype, packed, bwd, aligned, sms)
                if p.route != "tc" or not bwd:
                    return p
                stages = -(-n // qm.TC_STAGE)
                return p._replace(splits=-(-stages // min(per, stages)),
                                  per=min(per, stages))
            qm.qmm_plan = forced
            try:
                for wd, gs in (("int8", -1), ("int4", 128)):
                    for m in (QMM_DECODE_ROWS, QMM_ROWS, QMM_DX_ROWS):
                        st = qmm_four(int(wd[3:]), gs, torch.bfloat16, dev,
                                      m=m, bwd=True, digest=True)
                        sweep[f"{wd} g{gs} M {m} per {per}"] = st
                        log(f"[qmm-dx] sweep {wd} g{gs} bf16 M {m}, {per} "
                            f"stages a split: ms {st['ms']:.4f} (each "
                            + ", ".join(f"{v:.4f}" for v in st["each"])
                            + f") ({card})")
            finally:
                qm.qmm_plan = plan
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    drive = {}
    for (label, quant, _) in QUANT_SERVE[:2]:
        params = quant_predictor(model, cfg, quant, dev,
                                 dtype=torch.bfloat16).params
        drive[label] = dx_backward_profile(params, cfg, dev, card,
                                           f"[qmm-dx] bf16 drive ({label})")
    print(json.dumps({"qmm_dx": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        rows=rows, sweep=sweep, drive=drive)}), flush=True)
    return 0


def mlp_gemms_only(root: Path) -> int:
    """``--ab mlp-gemms [ROOT]``: rows 14 and 9 (the mega MLP at
    ``MLP_ROUNDS``, fp and int8 g128 weights; the int8 weight-only GEMM's
    four serving GEMMs at M 24 and 8) and the controls (row 10: the int4
    forward, row 11: the int8 dx, row 13: the mega attention kernel at the
    table shape), fp32 and bf16, with the ``paddle_tpu_torch`` package of
    the checkout at ``ROOT`` (default: this one; a package whose
    ``mega_mlp`` takes no ``q_lens`` computes every row at each round);
    then the bf16 mega step and the bf16 int8-weight per-op step of GPT-125M
    (wall, one profiled run each: device busy); prints one JSON line. Run it
    with two trees in turns to compare them on one card."""
    sys.path.insert(0, str(root))
    import paddle_tpu_torch
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops.mega_decode import mega_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    takes_q = "q_lens" in inspect.signature(mega_mlp).parameters
    chunk = MEGA_SERVING[0][1]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = str(dtype)[6:]
        for wd, gs in ((None, -1), ("int8", 128)):
            args, (y2, s_res) = mega_inputs(MEGA_SERVING, wd, gs, False,
                                            dtype, dev)
            p = args[1]
            for rname, ql in MLP_ROUNDS.items():
                kw = {}
                if ql is not None and takes_q:
                    kw = dict(q_lens=torch.tensor(ql, dtype=torch.int32,
                                                  device=dev), chunk=chunk)
                nbytes, nops = mega_mlp_work(y2, p, True,
                                             None if ql is None else sum(ql))
                rows[f"14 {rname} {wd or 'fp'} {t}"] = dict(
                    ms=time_ms(lambda: mega_mlp(y2, s_res, p, **kw)),
                    bound_ms=bound_ms(nbytes, nops, dtype))
            if wd is None:
                rows[f"13 table fp {t}"] = {
                    k: v for k, v in mega_case(args, dtype, "table").items()
                    if k in ("ms", "bound_ms")}
        rows[f"9 four GEMMs M {QMM_ROWS} {t}"] = qmm_four(8, -1, dtype, dev)
        rows[f"9 four GEMMs M {QMM_DECODE_ROWS} {t}"] = qmm_four(
            8, -1, dtype, dev, m=QMM_DECODE_ROWS)
        rows[f"9 g128 four GEMMs M {QMM_ROWS} {t}"] = qmm_four(8, 128, dtype,
                                                              dev)
        rows[f"10 four GEMMs M {QMM_ROWS} {t}"] = qmm_four(4, 128, dtype,
                                                          dev)
        rows[f"11 four dx M {QMM_ROWS} {t}"] = qmm_four(8, -1, dtype, dev,
                                                       bwd=True)
    for label, st in rows.items():
        log(f"[mlp-gemms] row {label}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in st.items()) + f" ({card})")
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    early, late = requests(cfg)
    steps = {}
    for name, quant, mega in (("mega", {}, True),
                              ("int8 per-op", dict(weight_dtype="int8"),
                               False)):
        walls = []
        for run in range(3):
            sp = quant_predictor(model, cfg, quant, dev,
                                 dtype=torch.bfloat16, mega_decode=mega)
            ms = timed_serve(sp, early, late)["step_ms"]
            if run:
                walls.append(ms)
        sp = quant_predictor(model, cfg, quant, dev, dtype=torch.bfloat16,
                             mega_decode=mega)
        prof = profile_serve(sp, early, late, card, f"[mlp-gemms] {name}")
        busy = None if prof is None else prof[1] / 1e3 / prof[2]
        groups = None if prof is None else {
            g: round(us / 1e3 / prof[2], 4) for g, (us, _) in
            prof[0].items() if us}
        steps[name] = dict(step_ms=walls, busy_ms_per_step=busy,
                           groups_ms_per_step=groups, steps=sp.steps)
        log(f"[mlp-gemms] serve {name} bf16: mean step "
            + " / ".join(f"{w:.3f}" for w in walls) + " ms; device busy "
            + ("not measured" if busy is None else f"{busy:.4f} ms")
            + f" a step ({sp.steps} steps; {card})")
    print(json.dumps({"mlp_gemms": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        rows=rows, serve=steps)}), flush=True)
    return 0


def gmm_pair(wd, gs, dtype, dev, counts=GMM_ROWS, bwd=False):
    """w1 + w2 of one MoE layer at ``counts`` rows (default the serving rows
    (a)), forward or dx (``bwd``): the summed kernel time, each GEMM's, the
    bound, the route the package's plan took (``"sk"``, ``"dx"``, ``"tc"``
    or ``"cc"``) and a digest of the two outputs' bytes (equal digests:
    bitwise-equal outputs)."""
    import hashlib

    from paddle_tpu_torch.ops.grouped_matmul import (grouped_matmul_bwd,
                                                     grouped_matmul_fwd)

    bits = 0 if wd is None else int(wd[3:])
    ms, work, routes, each, h = 0.0, [0.0, 0.0], set(), [], hashlib.sha1()
    for ci, (k, n) in enumerate(GMM_SHAPES.values()):
        x, dy, w, sc, offs = gmm_case(counts, k, n, wd, gs, dtype, dev,
                                      SEED + ci)
        if bwd:
            fn = lambda: grouped_matmul_bwd(  # noqa: E731
                dy, w, offs, sc, k, dtype)
        else:
            fn = lambda: grouped_matmul_fwd(x, w, offs, sc)  # noqa: E731
        tc0, sk0, dx0 = gmm_tc_counts(), gmm_sk_count(), gmm_dx_count()
        h.update(fn().float().cpu().numpy().tobytes())
        routes.add("sk" if gmm_sk_count() > sk0 else
                   "dx" if gmm_dx_count() > dx0 else
                   "tc" if gmm_tc_counts() != tc0 else "cc")
        each.append(time_ms(fn, iters=50 if counts is GMM_ROWS else 10))
        ms += each[-1]
        nbytes, nops = gmm_work(counts, k, n, bits,
                                1 if sc is None else sc.shape[1],
                                x.element_size())
        work = [work[0] + nbytes, work[1] + nops]
    return dict(ms=ms, each=each, bound_ms=bound_ms(*work, dtype),
                route="/".join(sorted(routes)), digest=h.hexdigest()[:16])


def moe_gemms_only(root: Path) -> int:
    """``--ab moe-gemms [ROOT]``: rows 16 and 17 (the grouped GEMM with int8
    per-channel, int8 g128 and int4 g128 expert stacks, w1 + w2 at the
    serving rows (a)) in fp32 and bf16; the controls: row 15 (fp weights
    at (a)), row 9 (the int8 weight-only GEMM's four serving GEMMs at M
    24), row 10 (the int4 ones), row 13 (the mega attention kernel at the
    table shape) and row 14 (the mega MLP at a served round); then the
    bf16 MoE
    GPT-125M served at cf 1.25 with int8 and int4 g128 stacks (mean step of
    2 runs after a warm-up, one profiled run: device busy and the grouped
    GEMM's device time a step), all with the ``paddle_tpu_torch`` package
    of the checkout at ``ROOT`` (default: this one); prints one JSON line.
    Run it with two trees in turns to compare them on one card."""
    sys.path.insert(0, str(root))
    from dataclasses import replace

    import paddle_tpu_torch
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops.mega_decode import mega_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {}
    for dtype in (f32, bf16):
        t = str(dtype)[6:]
        for label, wd, gs in (("16 int8", "int8", -1),
                              ("16 int8 g128", "int8", 128),
                              ("17 int4 g128", "int4", 128)):
            rows[f"{label} (a) {t}"] = gmm_pair(wd, gs, dtype, dev)
        rows[f"15 fp (a) {t}"] = gmm_pair(None, -1, dtype, dev)
        rows[f"9 four GEMMs M {QMM_ROWS} {t}"] = qmm_four(8, -1, dtype, dev)
        rows[f"10 four GEMMs M {QMM_ROWS} {t}"] = qmm_four(4, 128, dtype,
                                                          dev)
        args, (y2, s_res) = mega_inputs(MEGA_SERVING, None, -1, False, dtype,
                                        dev)
        rows[f"13 table fp {t}"] = {
            k: v for k, v in mega_case(args, dtype, "table").items()
            if k in ("ms", "bound_ms")}
        ql = MLP_ROUNDS["served round"]
        kw = dict(q_lens=torch.tensor(ql, dtype=torch.int32, device=dev),
                  chunk=MEGA_SERVING[0][1])
        nbytes, nops = mega_mlp_work(y2, args[1], True, sum(ql))
        rows[f"14 served round fp {t}"] = dict(
            ms=time_ms(lambda: mega_mlp(y2, s_res, args[1], **kw)),
            bound_ms=bound_ms(nbytes, nops, dtype))
    for label, st in rows.items():
        log(f"[moe-gemms] row {label}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in st.items()) + f" ({card})")
    cfg = replace(GPT_CONFIGS["gpt3-125m"], **MOE, moe_capacity_factor=1.25)
    model = moe_model(cfg, dev)
    early, late = requests(cfg)
    steps = {}
    for name, quant in (("int8", dict(weight_dtype="int8")),
                        ("int4 g128", dict(weight_dtype="int4",
                                           weight_quant_group_size=128))):
        walls = []
        for run in range(3):
            sp = quant_predictor(model, cfg, quant, dev, dtype=bf16)
            ms = timed_serve(sp, early, late)["step_ms"]
            if run:
                walls.append(ms)
        sp = quant_predictor(model, cfg, quant, dev, dtype=bf16)
        prof = profile_serve(sp, early, late, card, f"[moe-gemms] {name}")
        busy = None if prof is None else prof[1] / 1e3 / prof[2]
        groups = None if prof is None else {
            g: round(us / 1e3 / prof[2], 4) for g, (us, _) in
            prof[0].items() if us}
        steps[name] = dict(step_ms=walls, busy_ms_per_step=busy,
                           groups_ms_per_step=groups, steps=sp.steps)
        log(f"[moe-gemms] serve MoE {name} bf16: mean step "
            + " / ".join(f"{w:.3f}" for w in walls) + " ms; device busy "
            + ("not measured" if busy is None else f"{busy:.4f} ms")
            + f" a step ({sp.steps} steps; {card})")
    print(json.dumps({"moe_gemms": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        rows=rows, serve=steps)}), flush=True)
    return 0


# --ab moe-dx: the dx route's split plans swept at the serving rows (a)
# (stages of N a split forced into the plan, 48: one split for w1's N; the
# plan's own choice is timed beside them)
GMM_DX_SWEEP_PER = (1, 2, 3, 4, 6, 8, 12, 48)


def moe_dx_only(root: Path) -> int:
    """``--ab moe-dx [ROOT]``: row 19 (the grouped GEMM's dx with int8
    expert stacks, per channel and g128, w1 + w2 at the serving rows (a)
    and the prefill rows (b), fp32, bf16 and fp16, each GEMM's time and a
    digest of the outputs); the controls row 16 (the int8 forward at (a) in
    bf16 and fp16) and rows 11 and 12 (the weight-only GEMM's int8 and int4
    g128 dx, four GEMMs at M 24), with digests; where ROOT's package has the
    dx route, its split plans swept (``GMM_DX_SWEEP_PER`` stages a split,
    bf16 at (a)); then the bf16 input-gradient drives of phase 11 (the
    2-layer GPT-125M-width MoE model, [256, 768]: through both layers' int8
    stacks, and through layer 0's fp stacks, row 18): the dx kernels'
    device time in one profiled backward each; all with the
    ``paddle_tpu_torch`` package of the checkout at ``ROOT`` (default: this
    one). Prints one JSON line; run it with two trees in turns to compare
    them on one card."""
    sys.path.insert(0, str(root))
    from dataclasses import replace

    import paddle_tpu_torch
    from paddle_tpu_torch.inference.quantize import quantize_weight
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.models.moe import moe_ffn
    from paddle_tpu_torch.ops import grouped_matmul as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    bf16 = torch.bfloat16
    rows = {}
    for gs in (-1, 128):
        for dtype in DTYPES:
            for label, counts in (("a", GMM_ROWS), ("b", GMM_PREFILL)):
                rows[f"19 dx int8 g{gs} ({label}) {str(dtype)[6:]}"] = \
                    gmm_pair("int8", gs, dtype, dev, counts, bwd=True)
    for dtype in (bf16, torch.float16):
        t = str(dtype)[6:]
        rows[f"16 fwd int8 (a) {t}"] = gmm_pair("int8", -1, dtype, dev)
        for bits, gs in ((8, -1), (4, 128)):
            rows[f"{11 if bits == 8 else 12} dx int{bits} g{gs} M "
                 f"{QMM_ROWS} {t}"] = qmm_four(bits, gs, dtype, dev,
                                               bwd=True, digest=True)
    for label, st in rows.items():
        log(f"[moe-dx] row {label}: ms {st['ms']:.4f} (each " + ", ".join(
            f"{v:.4f}" for v in st["each"]) + f"), bound "
            f"{st['bound_ms']:.6f}"
            + (f", route {st['route']}" if "route" in st else "")
            + f", digest {st['digest']} ({card})")
    sweep = {}
    if hasattr(gm.grouped_matmul_bwd, "dx_launches"):
        plan = gm._plan
        for per in GMM_DX_SWEEP_PER:
            def forced(m, e, k, n, bits, bwd, dtype, aligned, sms, groups=1,
                       per=per):
                p = plan(m, e, k, n, bits, bwd, dtype, aligned, sms, groups)
                if p.route != "dx":
                    return p
                stages = -(-n // gm.DX_STAGE)
                return p._replace(splits=-(-stages // min(per, stages)),
                                  per=min(per, stages))
            gm._plan = forced
            try:
                for gs in (-1, 128):
                    st = gmm_pair("int8", gs, bf16, dev, bwd=True)
                    sweep[f"int8 g{gs} (a) per {per}"] = st
                    log(f"[moe-dx] sweep int8 g{gs} bf16 (a), {per} stages "
                        f"a split: ms {st['ms']:.4f} (each " + ", ".join(
                            f"{v:.4f}" for v in st["each"]) + f") ({card})")
            finally:
                gm._plan = plan
    cfg = replace(GPT_CONFIGS["gpt3-125m"], **MOE, num_layers=2,
                  moe_capacity_factor=1.25)
    layers = [layer.mlp for layer in moe_model(cfg, dev).gpt.layers]
    rng = np.random.RandomState(SEED + 4)
    x0 = torch.from_numpy(rng.standard_normal((256, cfg.hidden_size)).astype(
        np.float32)).to(dev, bf16)
    r = torch.from_numpy(rng.standard_normal(x0.shape).astype(
        np.float32)).to(dev)
    quant = [(quantize_weight(m.w1.detach().to(bf16), "int8"),
              quantize_weight(m.w2.detach().to(bf16), "int8"))
             for m in layers]
    m0 = layers[0]

    def int8_loss():
        x = x0.clone().requires_grad_()
        return (int8_drive(x, layers, quant, cfg, None) * r).sum()

    def fp_loss():
        x = x0.clone().requires_grad_()
        out, _ = moe_ffn(x, *(t.detach().to(bf16) for t in (
            m0.gate_weight, m0.w1, m0.b1, m0.w2, m0.b2)),
            top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor)
        return (out.float() * r).sum()

    drive = {
        "int8, 2 layers": backward_profile(
            int8_loss, r"gmm_dx_kernel|gmm_kernel<[^>]*, 8, true>", card,
            "[moe-dx] bf16 int8 drive (2 layers)"),
        "fp, layer 0 (row 18)": backward_profile(
            fp_loss, r"gmm_(tc|wg)_kernel<[^>]*, true>", card,
            "[moe-dx] bf16 fp drive (layer 0)")}
    print(json.dumps({"moe_dx": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        rows=rows, sweep=sweep, drive=drive)}), flush=True)
    return 0


def int4_decode_only(root: Path) -> int:
    """``--ab int4-decode [ROOT]``: row 10 (the int4 g128 weight-only GEMM's
    four serving GEMMs at M 24 and M 8) and row 4 (the paged decode kernel
    at the serving pools, beside the ragged kernel at chunk 1 on the same
    pools) in fp32 and bf16; the controls: row 1 (the ragged kernel at the
    table shape), row 9 (the int8 four GEMMs at M 24), row 13 (the mega
    attention kernel at the table shape) and row 17 (the grouped GEMM with
    int4 g128 stacks at the serving rows (a)); then GPT-125M served in bf16
    with int4 g128 weights (the per-op step) and through the legacy path
    (mean step of 2 runs after a warm-up, one profiled run each: device
    busy, the weight-only GEMM's and the decode kernel's device time a
    step), all with the ``paddle_tpu_torch`` package of the checkout at
    ``ROOT`` (default: this one); prints one JSON line. Run it with two
    trees in turns to compare them on one card."""
    sys.path.insert(0, str(root))
    import paddle_tpu_torch
    from paddle_tpu_torch.inference import ServingPredictor
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops.paged_attention import (paged_attention,
                                                      ragged_paged_attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    rows = {}
    table = (8, 16, 12, 12, 64, 64, 16, [0, 1024, 1000, 333, 64, 16, 700, 517],
             [0, 1, 16, 7, 1, 16, 12, 1])
    for dtype in (torch.float32, torch.bfloat16):
        t = str(dtype)[6:]
        rows[f"10 four GEMMs M {QMM_ROWS} {t}"] = qmm_four(4, 128, dtype, dev)
        rows[f"10 four GEMMs M {QMM_DECODE_ROWS} {t}"] = qmm_four(
            4, 128, dtype, dev, m=QMM_DECODE_ROWS)
        dargs = decode_inputs(DECODE_SERVING[0], DECODE_SERVING[1], dtype,
                              dev, SEED)
        lens = dargs[4]
        nbytes, nops = decode_work(dargs)
        rows[f"4 serving pools {t}"] = dict(
            ms=time_ms(lambda: paged_attention(*dargs)),
            bound_ms=bound_ms(nbytes, nops, dtype),
            ragged_chunk1_ms=time_ms(lambda: ragged_paged_attention(
                dargs[0][:, None].contiguous(), *dargs[1:4], lens,
                (lens > 0).to(torch.int32))))
        args, kw = walk_inputs(table, dtype, "fp", dev)
        rows[f"1 table {t}"] = {k: v for k, v in ragged_case(
            args, kw, dtype, "table").items() if k in ("ms", "bound_ms")}
        rows[f"9 four GEMMs M {QMM_ROWS} {t}"] = qmm_four(8, -1, dtype, dev)
        margs, _ = mega_inputs(MEGA_SERVING, None, -1, False, dtype, dev)
        rows[f"13 table fp {t}"] = {
            k: v for k, v in mega_case(margs, dtype, "table").items()
            if k in ("ms", "bound_ms")}
        rows[f"17 int4 g128 (a) {t}"] = gmm_pair("int4", 128, dtype, dev)
    for label, st in rows.items():
        log(f"[int4-decode] row {label}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in st.items()) + f" ({card})")
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    early, late = requests(cfg)
    steps = {}
    for name, make in (
            ("int4 g128 per-op", lambda: quant_predictor(
                model, cfg, QUANT_SERVE[1][1], dev, dtype=torch.bfloat16)),
            ("legacy", lambda: ServingPredictor(
                model, max_batch=8, device=dev, dtype=torch.bfloat16,
                unified=False))):
        walls = []
        for run in range(3):
            sp = make()
            ms = timed_serve(sp, early, late)["step_ms"]
            if run:
                walls.append(ms)
        sp = make()
        prof = profile_serve(sp, early, late, card, f"[int4-decode] {name}")
        busy = None if prof is None else prof[1] / 1e3 / prof[2]
        groups = None if prof is None else {
            g: round(us / 1e3 / prof[2], 4) for g, (us, _) in
            prof[0].items() if us}
        steps[name] = dict(step_ms=walls, busy_ms_per_step=busy,
                           groups_ms_per_step=groups, steps=sp.steps)
        log(f"[int4-decode] serve {name} bf16: mean step "
            + " / ".join(f"{w:.3f}" for w in walls) + " ms; device busy "
            + ("not measured" if busy is None else f"{busy:.4f} ms")
            + f" a step ({sp.steps} steps; {card})")
    print(json.dumps({"int4_decode": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        rows=rows, serve=steps)}), flush=True)
    return 0


# -- phase 17: the resilience and observability layers ----------------------

#: phase 17 (a)'s seeded plan: every serving seam non-zero
RES_PLAN = dict(seed=5, dispatch=0.02, reconcile=0.02, h2d=0.015,
                slow_step=0.05, slow_step_s=0.002, pool_squeeze=0.15,
                squeeze_pages=6, squeeze_steps=2)
#: (a)'s bf16 control: no seam armed; after these steps every running
#: lane is preempted (the replay a failure requeue sends it through)
RES_PREEMPT_AT = (8, 24)
#: a failure requeues every running lane, each a retry of its request
RES_RETRIES = 12
#: (a)'s pool: room for phase 6's requests with little to spare, so a
#: squeeze preempts
RES_PAGES = 24
#: (c)'s pool: phase 6's prompts served twice through it evict their
#: prefixes, which the host tier keeps
TIER_PAGES = 12
TIER_BYTES = 256 << 20
TIER_PLAN = dict(seed=1, host_spill_drop=0.2, tier_restore_corrupt=0.3)
#: (e): timed runs of each form each way, in turns
RES_RUNS = 3


def pool_state(sp):
    """The accounting a drained run must leave: pages available of the
    pool, free slots, references held (prefix pins included), pages
    withheld."""
    c = sp.cache
    return dict(available=c.available_page_count, of=c.num_pages,
                free_slots=c.free_slot_count,
                refs=int(c._refcount.sum()), withheld=c.withheld_page_count)


def departures(reqs, want):
    """The finished requests whose tokens are not ``want``'s: (index, first
    token that differs, preemptions, failure retries) each."""
    off = []
    for i, r in enumerate(reqs):
        if r.state == "finished" and list(r.output_ids) != want[i]:
            j = next(k for k, (a, b) in enumerate(zip(r.output_ids, want[i]))
                     if a != b)
            off.append((i, j, r.preempt_count, r.retry_count))
    return off


def replay_split(reqs, off):
    """How many requests replayed (a preemption or a failure retry), and
    of the departures, how many had replayed and how many had not."""
    replayed = {i for i, r in enumerate(reqs)
                if r.preempt_count or r.retry_count}
    gone = {i for i, *_ in off}
    return dict(replayed=len(replayed), off_replayed=len(gone & replayed),
                off_not_replayed=len(gone - replayed))


def launch_count(sp):
    """The attention launches a served form's steps make: the ragged
    kernel's (per-op) or the mega pair's."""
    attn, mlp = mega_counts()
    return (attn, mlp) if sp.mega_decode else read_counts()[1]


def phase_resilience(model, cfg, dev, card):
    """17. The resilience and observability layers on GPT-125M (bf16,
    phase 6's requests, the captured step and the async engine): (a)
    chaos, (b) deadlines and SLO shedding, (c) the host tier, (d) one
    GPU-target profiler window, (e) the cost of the disarmed layers.
    Returns the phase's launches by kernel and (e)'s timings."""
    from paddle_tpu_torch.inference import FaultPlan

    bf16 = torch.bfloat16
    early, late = requests(cfg)
    reset_counts()
    out = {}

    # (a) chaos: every request ends with the fault-free tokens or FAILS
    # with a named code; the drained pool and the captures are the
    # fault-free run's. A replay recomputes its context in prefill chunks,
    # whose attention splits the keys between the page walk and the
    # in-chunk block otherwise than the decode steps that first wrote
    # them: the recomputed K / V may differ in the last bits, so a
    # replayed stream may leave the fault-free one at a near tie of its
    # own plain forward (held as phase 16 holds its streams); in fp32
    # every finished stream must be the fault-free one
    fired_all = {}
    for form, mega, dtype in (("per-op", None, bf16), ("mega", True, bf16),
                              ("per-op fp32", None, torch.float32)):
        kw = dict(dtype=dtype, mega_decode=mega, num_pages=RES_PAGES,
                  max_step_retries=RES_RETRIES, retry_backoff_s=0.0)
        sp = quant_predictor(model, cfg, {}, dev, **kw)
        rec = StepRecord(sp)
        base = serve(sp, early, late)
        torch.cuda.synchronize()
        want = [list(r.output_ids) for r in base]
        oracle = served_oracle(sp, cfg, base)
        err = max((torch.stack([rec.rows[(r.req_id, j)] for j in range(
            len(r.output_ids))]) - o).abs().max().item()
            for r, o in zip(base, oracle))
        bar = TIE_MARGIN if dtype == torch.float32 else 2 * err
        hold_to_oracle(f"(a) {form} fault-free", base, oracle, bar)
        want_pool = pool_state(sp)
        want_captures = unified_of(sp._unified).trace_count
        del sp, rec
        sp = quant_predictor(model, cfg, {}, dev, **kw)
        n0 = launch_count(sp)
        with FaultPlan(**RES_PLAN) as plan:
            reqs = serve(sp, early, late, failed_ok=True)
        torch.cuda.synchronize()
        failed, ties = 0, 0
        for i, r in enumerate(reqs):
            if r.state == "failed" and r.error and r.error.get("code"):
                failed += 1
            elif r.state != "finished":
                raise AssertionError(f"(a) {form}: request {i} ended "
                                     f"{r.state} without a named error")
        off = departures(reqs, want)
        same = len(reqs) - failed - len(off)
        if off and dtype == torch.float32:
            # fp32 replays recompute bitwise enough: no departure at all
            raise AssertionError(f"(a) {form}: requests {off} (index, first "
                                 "token, preemptions, retries) left the "
                                 "fault-free tokens")
        if off:
            held = [reqs[i] for i, *_ in off]
            ties = hold_to_oracle(f"(a) {form} chaos", held,
                                  served_oracle(sp, cfg, held), bar)
        if pool_state(sp) != want_pool:
            raise AssertionError(f"(a) {form}: pool {pool_state(sp)} after "
                                 f"the chaos run, {want_pool} fault-free")
        if sp.decode_trace_count != want_captures:
            raise AssertionError(f"(a) {form}: {sp.decode_trace_count} "
                                 f"captures, {want_captures} fault-free")
        n = sp.steps * cfg.num_layers
        got = launch_count(sp)
        want_n = (n0[0] + n, n0[1] + n) if mega else n0 + n
        if got != want_n:
            raise AssertionError(f"(a) {form}: launches {got}, want "
                                 f"{want_n} over {sp.steps} steps")
        flat = sp.telemetry()
        raised = sum(plan.fired[s] for s in ("dispatch", "h2d", "reconcile"))
        if flat["serving_step_failures"] != raised:
            raise AssertionError(f"(a) {form}: {flat['serving_step_failures']}"
                                 f" step failures, {raised} faults raised")
        for seam, k in plan.fired.items():
            fired_all[seam] = fired_all.get(seam, 0) + k
        codes = sorted({r.error["code"] for r in reqs if r.error})
        split = replay_split(reqs, off)
        log(f"[resilience] (a) {form}: {same} finished with the fault-free "
            f"tokens, {len(off)} finished off them from a near tie of "
            f"their plain forward (request, first token, preemptions, "
            f"retries: {off}; {ties} near ties, bar {bar:.3e}; {split}), "
            f"{failed} failed {codes}; fired "
            f"{ {k: v for k, v in plan.fired.items() if v} }; "
            f"{sp.steps} steps, retries "
            f"{int(flat['serving_step_retries'])}, preemptions "
            f"{int(flat['serving_preemptions'])}; pool {pool_state(sp)}, "
            f"captures {sp.decode_trace_count} ({card})")
        out[f"chaos {form}"] = dict(same=same, off=off, failed=failed,
                                    codes=codes, steps=sp.steps,
                                    fired=dict(plan.fired), **split)
        del sp
        if dtype != torch.float32:
            out[f"preemption only {form}"] = preempt_only(
                model, cfg, dev, kw, early, late, want, bar, form, card)
    missing = [s for s in ("dispatch", "h2d", "reconcile", "slow_step",
                           "pool") if not fired_all.get(s)]
    if missing:
        raise AssertionError(f"(a) seams that never fired: {missing}")
    out["deadlines"] = resilience_deadlines(model, cfg, dev, early, late,
                                            card)
    out["tier"] = resilience_tier(model, cfg, dev, early, late, card)
    out["trace"] = resilience_trace(model, cfg, dev, early, late, card)
    ragged_n, qmm, (attn_n, mlp_n) = read_counts()[1], qmm_counts(), \
        mega_counts()
    launches = dict(ragged=ragged_n, int8=qmm["int8"], int4=qmm["int4"],
                    mega_attn=attn_n, mega_mlp=mlp_n)
    log(f"[resilience] launches over (a)-(d): {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of phase 17 never ran: {launches}")
    out["cost"] = resilience_cost(model, cfg, dev, early, late, card)
    return launches, out


def preempt_only(model, cfg, dev, kw, early, late, want, bar, form, card):
    """(a)'s control for a bf16 form: the same requests with no seam armed,
    every running lane preempted after each step of ``RES_PREEMPT_AT``
    once the ring has landed (youngest first, as a failure requeues
    them). No step fails, so the recovery paths never run: the replays
    are the plain preemption replay, which a chaos run's failure requeues
    go through too. A stream that leaves the fault-free tokens here does
    so without the recovery code, and is held to its plain forward as the
    chaos run's are. Raises unless the preemptions happened and no step
    failed."""
    sp = quant_predictor(model, cfg, {}, dev, **kw)

    def preempt_all(reqs, n):
        if n in RES_PREEMPT_AT:
            sp.flush()      # lands and retires: every lane left has work
            assert not any(r.done for r in sp.running.values())
            while sp.running:
                sp._preempt_youngest()

    reqs = serve(sp, early, late, every_step=preempt_all)
    torch.cuda.synchronize()
    flat = sp.telemetry()
    preempted = int(flat["serving_preemptions"])
    if flat["serving_step_failures"] or not preempted:
        raise AssertionError(
            f"(a) {form} preemption only: {flat['serving_step_failures']} "
            f"step failures, {preempted} preemptions (want 0 and > 0)")
    off = departures(reqs, want)
    held = [reqs[i] for i, *_ in off]
    ties = (hold_to_oracle(f"(a) {form} preemption only", held,
                           served_oracle(sp, cfg, held), bar) if off else 0)
    split = replay_split(reqs, off)
    log(f"[resilience] (a) {form} preemption only (no seam armed, every "
        f"running lane preempted after steps {RES_PREEMPT_AT}; recovery "
        f"never ran): {len(reqs) - len(off)} finished with the fault-free "
        f"tokens, {len(off)} off them (request, first token, preemptions, "
        f"retries: {off}; {ties} near ties, bar {bar:.3e}; {split}); "
        f"preemptions {preempted}, {sp.steps} steps ({card})")
    return dict(off=off, ties=ties, preemptions=preempted, steps=sp.steps,
                **split)


def resilience_deadlines(model, cfg, dev, early, late, card):
    """(b): int4 g128 weights, ``SLOConfig(max_waiting=6)``. A burst of
    12 requests before the first step: 6 queue, 6 shed ``queue_full``;
    of the queued, two carry a deadline of 0 s (shed from the queue) and
    the 300-token prompt one of 20 ms (it retires running). The shed and
    deadline counters and ``healthz()`` must show exactly that."""
    from paddle_tpu_torch.inference import SLOConfig

    sp = quant_predictor(model, cfg, {"weight_dtype": "int4",
                                      "weight_quant_group_size": 128}, dev,
                         dtype=torch.bfloat16,
                         slo=SLOConfig(max_waiting=6))
    prompts = early + late + early[:4]
    deadlines = [None, 0.0, None, None, 0.02, 0.0] + [None] * 6
    reqs = [sp.add_request(p, MAX_NEW, deadline_s=d)
            for p, d in zip(prompts, deadlines)]
    burst = sp.healthz()
    want_burst = dict(status="shedding", shed_reason="queue_full",
                      waiting=6, requests_shed=6, requests_failed=6)
    if {k: burst[k] for k in want_burst} != want_burst:
        raise AssertionError(f"(b) healthz after the burst {burst}")
    while sp.has_work():
        sp.step()
    sp.flush()
    torch.cuda.synchronize()
    codes = [r.error["code"] if r.error else r.state for r in reqs]
    want_codes = (["finished", "deadline_exceeded", "finished", "finished",
                   "deadline_exceeded", "deadline_exceeded"]
                  + ["shed_queue_full"] * 6)
    if codes != want_codes:
        raise AssertionError(f"(b) outcomes {codes}, want {want_codes}")
    if "running" not in reqs[4].error["message"]:
        raise AssertionError(f"(b) the 20 ms request: {reqs[4].error}")
    if any(len(r.output_ids) != MAX_NEW for r in reqs
           if r.state == "finished"):
        raise AssertionError("(b) a finished stream is short")
    hz, flat = sp.healthz(), sp.telemetry()
    want_hz = dict(status="ok", shed_reason=None, waiting=0, running=0,
                   inflight_steps=0, requests_shed=6, deadline_misses=3,
                   requests_failed=9, step_failures=0, free_slots=8)
    if {k: hz[k] for k in want_hz} != want_hz or (
            flat["serving_fail_reasons{reason=shed_queue_full}"] != 6
            or flat["serving_fail_reasons{reason=deadline_exceeded}"] != 3):
        raise AssertionError(f"(b) healthz {hz}")
    log(f"[resilience] (b) int4 g128: 12 sent, 6 shed queue_full, 3 past "
        f"their deadlines (2 queued, 1 running after "
        f"{len(reqs[4].output_ids)} tokens), 3 finished; healthz "
        f"{json.dumps(hz)} ({card})")
    return dict(healthz=hz)


def resilience_tier(model, cfg, dev, early, late, card):
    """(c): phase 6's prompts served twice through a pool too small to
    keep their prefixes, with a host tier, fp (bf16) and int8 weights with
    an int8 KV cache, under the tier's seeded drop and corruption seams:
    every request finishes, pages spill and land back, corrupt entries
    are detected and dropped (recompute), the pools keep their addresses
    and one capture serves. Then, seams off, a chain evicted through the
    tier lands back bitwise equal. Logs the spills' stream waits."""
    from paddle_tpu_torch.inference import FaultPlan

    res = {}
    prompts = early + late
    for form, quant, kv in (("bf16", {}, None),
                            ("int8 + int8 KV", {"weight_dtype": "int8"},
                             "int8")):
        sp = quant_predictor(model, cfg, quant, dev, dtype=torch.bfloat16,
                             kv_cache_dtype=kv, num_pages=TIER_PAGES,
                             host_tier_bytes=TIER_BYTES)
        ptrs = [p.data_ptr() for p in sp.cache.pools()]
        with FaultPlan(**TIER_PLAN) as plan:
            serve(sp, prompts, [])
            serve(sp, prompts, [])
        torch.cuda.synchronize()
        flat = sp.telemetry()
        need = ("kv_tier_spills", "kv_tier_restores", "kv_tier_spill_drops",
                "kv_tier_restore_corrupt")
        if not all(flat[k] for k in need):
            raise AssertionError(f"(c) {form}: tier counters "
                                 f"{ {k: flat[k] for k in need} }")
        if [p.data_ptr() for p in sp.cache.pools()] != ptrs:
            raise AssertionError(f"(c) {form}: the pools moved")
        if sp.decode_trace_count != 1:
            raise AssertionError(f"(c) {form}: {sp.decode_trace_count} "
                                 "captures")
        # seams off: the first prompt's chain through the tier, bitwise
        # (the longest chain the seams left whole)
        c = sp.cache
        toks = max(prompts, key=lambda t: sum(
            n for _, _, n in c.prefix_page_records(t)))
        recs = c.prefix_page_records(toks)
        before = {k: c.read_page_payload(pg, n) for k, pg, n in recs}
        c.reserve_import_room(c.num_pages)
        if c._prefix_pages:
            raise AssertionError(f"(c) {form}: pages left registered")
        restores = int(c._m_tier_restores.value)
        slot, hit = c.admit_prefix(toks)
        after = {k: c.read_page_payload(pg, n)
                 for k, pg, n in c.prefix_page_records(toks)}
        c.free(slot)
        same = before.keys() == after.keys() and all(
            np.array_equal(before[k][n], after[k][n])
            for k in before for n in before[k])
        want_hit = min(sum(n for _, _, n in recs), len(toks) - 1)
        if len(before) < 2 or not same or hit != want_hit:
            raise AssertionError(f"(c) {form}: restored chain of "
                                 f"{len(before)} pages differs (hit {hit}"
                                 f" of {want_hit})")
        syncs = int(flat["kv_tier_payload_syncs"])
        log(f"[resilience] (c) {form}: {int(flat['kv_tier_spills'])} "
            f"spills, {int(flat['kv_tier_restores'])} restores, "
            f"{int(flat['kv_tier_spill_drops'])} dropped spills, "
            f"{int(flat['kv_tier_restore_corrupt'])} corrupt entries "
            f"detected (fired {plan.fired['host_spill_drop']} / "
            f"{plan.fired['tier_restore_corrupt']}); a {len(toks)}-token "
            f"prompt's {len(before)} pages back bitwise ({int(c._m_tier_restores.value) - restores}"
            f" restored); spill stream waits {syncs} over {sp.steps} steps "
            f"({syncs / sp.steps:.3f} a step); tier "
            f"{c.host_tier_bytes_used} B; pools unmoved, 1 capture ({card})")
        res[form] = dict(spills=int(flat["kv_tier_spills"]),
                         restores=int(flat["kv_tier_restores"]),
                         syncs=syncs, steps=sp.steps)
        del sp
    return res


def resilience_trace(model, cfg, dev, early, late, card):
    """(d): one ``Profiler`` window (GPU target) over the served steps
    after the first: the exported trace holds the host spans, a matched
    lane a request (admit and eos instants), the in-flight counter track
    and the device kernels, and its kernels by group equal what the
    wrappers' counters gained over the window (the spans' device-side
    annotation ranges are not among the device events)."""
    from paddle_tpu_torch.profiler import (Profiler, ProfilerTarget,
                                           export_chrome_tracing,
                                           load_profiler_result)

    sp = quant_predictor(model, cfg, {}, dev, dtype=torch.bfloat16)
    prof = Profiler(targets=[ProfilerTarget.GPU],
                    on_trace_ready=export_chrome_tracing(
                        str(ROOT / "build" / "phase17"), "serve"))
    mark = {}

    def begin(_):
        torch.cuda.synchronize()
        prof.start()
        time.sleep(PROFILE_MARGIN_S)
        mark.update(steps=sp.steps, counted=group_launches())

    serve(sp, early, late, after_first=begin)
    torch.cuda.synchronize()
    time.sleep(PROFILE_MARGIN_S)
    prof.stop()
    events = load_profiler_result(prof._last_export)
    spans = {e["name"] for e in events if e["ph"] == "X"
             and e["pid"] != "device"}
    begins = {e["id"] for e in events if e["ph"] == "b"}
    ends = {e["id"] for e in events if e["ph"] == "e"}
    instants = {}
    for e in events:
        if e["ph"] == "n":
            instants.setdefault(e["id"], set()).add(e["name"])
    track = [e for e in events if e["ph"] == "C"
             and e["name"] == "inflight_steps"]
    device = [e for e in events if e.get("pid") == "device"
              and e["ph"] == "X"]
    kernels = [e for e in device if "kernel" in e["cat"].lower()]
    seen = {g: 0 for g in mark["counted"]}
    for e in kernels:
        g = trace_group(e["name"])
        if g in seen:
            seen[g] += 1
    counted = {g: n - mark["counted"][g] for g, n in group_launches().items()}
    bad = []
    if not {"pack_dispatch", "dispatch", "reconcile", "flush"} <= spans:
        bad.append(f"spans {sorted(spans)}")
    if not begins or begins != ends or any(
            not {"eos"} <= instants.get(i, set()) for i in begins):
        bad.append(f"lanes: {len(begins)} begun, {len(ends)} ended")
    if not track:
        bad.append("no inflight_steps track")
    if seen != counted or not counted["ragged kernel"]:
        bad.append(f"kernels by group {seen}, counters {counted}")
    if spans & {e["name"] for e in device}:
        bad.append("span ranges among the device events")
    if bad:
        raise AssertionError("(d) the exported trace: " + "; ".join(bad))
    steps = sp.steps - mark["steps"]
    log(f"[resilience] (d) one GPU-target window over {steps} steps: "
        f"{len(events)} events in {Path(prof._last_export).name} "
        f"({Path(prof._last_export).stat().st_size} B): spans "
        f"{sorted(spans)}, {len(begins)} matched request lanes, "
        f"{len(track)} inflight_steps samples, {len(device)} device events "
        f"({len(kernels)} kernels); kernels by group equal the counters' "
        f"{ {g: n for g, n in counted.items() if n} } ({card})")
    return dict(steps=steps, events=len(events), kernels=len(kernels),
                lanes=len(begins))


def resilience_cost(model, cfg, dev, early, late, card, runs=RES_RUNS):
    """(e): the bf16 per-op and mega steps with every layer disarmed (no
    plan, no deadline, no SLO, no window), ``runs`` timed runs of each in
    turns from the end of their first step, then one run of each with a
    host recording window open (the port's ``Profiler``, CPU target:
    spans, lanes and the counter track recorded) where the package has
    it. Logs and returns the median mean step and ``host_ms_per_step``."""
    try:
        from paddle_tpu_torch.profiler import Profiler
    except ImportError:
        Profiler = None
    forms = {"per-op": None, "mega": True}

    def run(form, window=False):
        sp = quant_predictor(model, cfg, {}, dev, dtype=torch.bfloat16,
                             mega_decode=forms[form])
        if not window:
            return timed_serve(sp, early, late)
        with Profiler():
            return timed_serve(sp, early, late)

    for form in forms:
        run(form)
    rows = {form: [] for form in forms}
    for i in range(runs):
        for form in (forms if i % 2 else list(forms)[::-1]):
            rows[form].append(run(form))
    res = {}
    for form, rs in rows.items():
        med = median_run(rs)
        res[form] = dict(step_ms=med["step_ms"], host_ms=med["host_ms"],
                         runs=[r["step_ms"] for r in rs],
                         host_runs=[r["host_ms"] for r in rs])
        line = (f"[resilience] (e) {form} bf16, layers disarmed: mean step "
                f"{med['step_ms']:.4f} ms (median of {runs}; runs "
                f"{step_list(rs)}), host_ms_per_step {med['host_ms']:.4f}")
        if Profiler is not None:
            w = run(form, window=True)
            res[form].update(window_step_ms=w["step_ms"],
                             window_host_ms=w["host_ms"])
            line += (f"; with a recording window open {w['step_ms']:.4f} ms,"
                     f" host_ms_per_step {w['host_ms']:.4f}")
        log(line + f" ({card})")
    return res


def resilience_only(root: Path) -> int:
    """``--ab resilience [ROOT]``: phase 17 (e) with the
    ``paddle_tpu_torch`` package at ``ROOT``: the bf16 per-op and mega
    steps of GPT-125M over phase 6's requests with every resilience and
    observability layer disarmed, ``RES_RUNS`` runs each in turns, then
    one run of each with a recording window open where the package has
    the profiler. Run it for a parent and a change as parent, change,
    change, parent; prints one JSON line."""
    sys.path.insert(0, str(root))
    import paddle_tpu_torch
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build(["ragged_paged_attention", "mega_decode"])
    log(f"[build] two kernel sources in {time.perf_counter() - t0:.1f} s")
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    early, late = requests(cfg)
    res = resilience_cost(model, cfg, dev, early, late, card,
                          runs=CAPTURE_RUNS)
    print(json.dumps({"resilience": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        steps=res)}), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def flash_ab_only(root: Path) -> int:
    """``--ab flash [ROOT]``: rows 2 and 3 (the flash forward and backward
    kernels) in bf16 without a mask at phase 4's [4, 512, 12, 64] causal,
    the training shape [8, 1024, 12, 128] causal, ``FLASH_LONG`` causal and
    BERT-base's [16, 512, 12, 64] non-causal, and with BERT's key-padding
    mask at the last where ROOT's package has the mask branch, all with the
    ``paddle_tpu_torch`` package of the checkout at ``ROOT`` (default: this
    one); prints one JSON line. Run it with two trees in turns to compare
    them on one card."""
    sys.path.insert(0, str(root))
    import paddle_tpu_torch
    from paddle_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    card = card_line()
    bf16 = torch.bfloat16
    b, s = BERT_BATCH, BERT_SEQ
    pad = torch.zeros(b, 1, 1, s, device=dev)
    pad[1:, ..., s // 2:] = -1e9
    rows = {}
    for label, shape, masked in (
            ("[4, 512, 12, 64] causal", (4, 512, 512, 12, 12, 64, True),
             False),
            ("[8, 1024, 12, 128] causal", (*BWD_SHAPE[:2], BWD_SHAPE[1],
                                           BWD_SHAPE[2], BWD_SHAPE[2],
                                           BWD_SHAPE[3], True), False),
            ("[1, 4096, 16, 128] causal", (1, 4096, 4096, 16, 16, 128, True),
             False),
            ("[16, 512, 12, 64] non-causal", (b, s, s, 12, 12, 64, False),
             False),
            ("[16, 512, 12, 64] key-padding mask", (b, s, s, 12, 12, 64,
                                                   False), True)):
        if masked and not hasattr(fa.flash_attention_fwd, "mask_launches"):
            continue
        q, k, v, do, lse, delta = bwd_inputs(shape, bf16, dev, SEED)
        kw = dict(causal=shape[-1], **(dict(mask=pad) if masked else {}))
        if masked:      # the masked twin's lse and delta
            out, lse = fa.flash_attention_reference(q, k, v, **kw)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
            delta = delta.reshape(lse.shape).contiguous()
        rows[label] = dict(
            fwd_ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                           iters=20, replays=3),
            bwd_ms=time_ms(lambda: fa.flash_attention_bwd(
                q, k, v, do, lse, delta, **kw), iters=10, replays=3))
        log(f"[flash-ab] {label} bf16: fwd {rows[label]['fwd_ms']:.4f} ms, "
            f"bwd {rows[label]['bwd_ms']:.4f} ms ({card})")
        del q, k, v, do, lse, delta
    print(json.dumps({"flash_ab": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        rows=rows)}), flush=True)
    return 0


def moe_forward_only(root: Path) -> int:
    """``--ab moe-forward [ROOT]``: only phase 11's bf16 MoE full forward,
    with the ``paddle_tpu_torch`` package of the checkout at ``ROOT``
    (default: this one), for example a ``git archive`` copy of an earlier
    commit, so two trees are compared on one card; prints one JSON line."""
    sys.path.insert(0, str(root))
    from dataclasses import replace

    import paddle_tpu_torch
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    cfg = replace(GPT_CONFIGS["gpt3-125m"], **MOE, moe_capacity_factor=1.25)
    out = phase_moe_forward(cfg, torch.device("cuda", 0), card)
    print(json.dumps({"moe_forward": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        **out)}), flush=True)
    return 0


def capture_only(root: Path) -> int:
    """``--ab capture [ROOT]``: only phase 15 (every unified form on the
    captured step and the async engine beside the eager step and the
    synchronous engine; the bf16 A/B in turns) on GPT-125M, with the
    ``paddle_tpu_torch`` package at ``ROOT`` (it must have the captured
    step); builds the four kernel sources serving runs first, in parallel;
    prints one JSON line."""
    sys.path.insert(0, str(root))
    from dataclasses import replace

    import paddle_tpu_torch
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build(["ragged_paged_attention", "quant_matmul", "mega_decode",
                  "grouped_matmul"])
    log(f"[build] four kernel sources in {time.perf_counter() - t0:.1f} s")
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    launches, timing = phase_captured(model, cfg, replace(cfg, **MOE), dev,
                                      card)
    print(json.dumps({"capture": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        launches={k: {n: v for n, v in st.items() if n != "replay"}
                  for k, st in launches.items()},
        timing=timing)}, default=str), flush=True)
    return 0


def spec_only(root: Path) -> int:
    """``--ab spec [ROOT]``: only phase 16 (speculative decoding on the
    captured step and the async engine) on GPT-125M, with the
    ``paddle_tpu_torch`` package at ``ROOT`` (it must have speculation);
    builds the three kernel sources the serving forms run first, in
    parallel; prints one JSON line."""
    sys.path.insert(0, str(root))
    import paddle_tpu_torch
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build(["ragged_paged_attention", "quant_matmul", "mega_decode"])
    log(f"[build] three kernel sources in {time.perf_counter() - t0:.1f} s")
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    t0 = time.perf_counter()
    launches, summary = phase_spec(model, cfg, dev, card)
    log(f"[spec] phase 16 in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"spec": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        launches=launches, timing=summary)}, default=str), flush=True)
    return 0


MOE_PROFILE_REPS = 5


def moe_profile_only(root: Path) -> int:
    """``--ab moe-profile [ROOT]``: phase 11's three profiled bf16 MoE
    windows (cf 1.25; int8 and int4 g128 expert stacks) on GPT-125M with 4
    experts, top-2, ``MOE_PROFILE_REPS`` times each in turns, with the
    ``paddle_tpu_torch`` package at ``ROOT``; each window's launches by
    graph launch logged (:func:`launch_detail`), a window whose trace
    differs from the counters counted, not raised; each window with no
    idle margin around it and with ``PROFILE_MARGIN_S``, in turns; prints one
    JSON line."""
    sys.path.insert(0, str(root))
    from dataclasses import replace

    import paddle_tpu_torch
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build(["ragged_paged_attention", "quant_matmul", "grouped_matmul"])
    log(f"[build] three kernel sources in {time.perf_counter() - t0:.1f} s")
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = moe_model(replace(cfg, **MOE), dev)
    mcfg = model.config
    mcfg.moe_capacity_factor = 1.25
    early, late = requests(cfg)
    windows = (("cf 1.25", {}),) + MOE_SERVE_BF16
    differ = {f"{label}, margin {m}": [] for label, _ in windows
              for m in (0.0, PROFILE_MARGIN_S)}
    for rep in range(MOE_PROFILE_REPS):
        for label, quant in windows:
            for m in (0.0, PROFILE_MARGIN_S)[::1 if rep % 2 else -1]:
                sp = quant_predictor(model, mcfg, quant, dev,
                                     dtype=torch.bfloat16)
                tag = f"[moe-profile] ({label}, margin {m}, window {rep})"
                try:
                    profile_serve(sp, early, late, card, tag, need=True,
                                  detail=True, margin=m)
                except AssertionError as e:
                    log(f"{tag} {e}")
                    differ[f"{label}, margin {m}"].append(rep)
                del sp
    print(json.dumps({"moe_profile": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        reps=MOE_PROFILE_REPS, differ=differ)}), flush=True)
    return 0


def serve_steps_only(root: Path) -> int:
    """``--ab serve-steps [ROOT]``: GPT-125M bf16 served with the
    ``paddle_tpu_torch`` package at ``ROOT`` on its defaults, per-op, mega
    and MoE (4 experts, top-2, cf 1.25), over phase 6's requests: one
    warm-up run, then ``CAPTURE_RUNS`` runs of each in turns, each from
    the end of its first step (:func:`timed_serve`). Where the package has
    the captured step, the same forms also run on the eager step with the
    synchronous engine (:class:`EagerStep`). A step A/B with another
    package runs this part for both as parent, change, change, parent.
    Prints one JSON line: by form and engine, the median mean step,
    tokens/s, the runs and a digest of the streams."""
    sys.path.insert(0, str(root))
    import hashlib
    from dataclasses import replace

    import paddle_tpu_torch
    from paddle_tpu_torch.models.convert import (random_state,
                                                 state_from_jax_numpy)
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, UnifiedStep
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build(["ragged_paged_attention", "quant_matmul", "mega_decode",
                  "grouped_matmul"])
    log(f"[build] four kernel sources in {time.perf_counter() - t0:.1f} s")
    cfg = GPT_CONFIGS["gpt3-125m"]
    dense = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    dense.eval()
    moe = moe_model(replace(cfg, moe_capacity_factor=1.25, **MOE), dev)
    early, late = requests(cfg)
    forms = {"per-op": (dense, None), "mega": (dense, True),
             "MoE": (moe, None)}
    engines = ["default"] + (["eager"] if hasattr(UnifiedStep, "eager")
                             else [])

    def run(form, engine):
        model, mega = forms[form]
        kw = {"async_engine": False} if engine == "eager" else {}
        sp = quant_predictor(model, model.config, {}, dev,
                             dtype=torch.bfloat16, mega_decode=mega, **kw)
        if engine == "eager":
            EagerStep(sp)
        got = timed_serve(sp, early, late)
        outs = [list(r.output_ids) for r in got["reqs"]]
        if sum(map(len, outs)) != MAX_NEW * len(outs):
            raise AssertionError(f"({form}, {engine}) malformed streams")
        got["digest"] = hashlib.sha1(json.dumps(outs).encode()).hexdigest()
        return got

    cells = [(f, e) for f in forms for e in engines]
    for cell in cells:
        run(*cell)
    rows = {cell: [] for cell in cells}
    for i in range(CAPTURE_RUNS):
        for cell in (cells if i % 2 else cells[::-1]):
            rows[cell].append(run(*cell))
    out = {}
    for (form, engine), rs in rows.items():
        med = median_run(rs)
        out[f"{form} {engine}"] = dict(
            step_ms=med["step_ms"], tok_s=med["tok_s"],
            runs=[r["step_ms"] for r in rs], steps=med["steps"] + 1,
            digest=sorted({r["digest"] for r in rs}))
        log(f"[serve-steps] {form} {engine}: mean step {med['step_ms']:.3f}"
            f" ms (median of {CAPTURE_RUNS}; runs {step_list(rs)} ms), "
            f"{med['tok_s']:.1f} tokens/s, {med['steps'] + 1} steps, "
            f"streams {out[f'{form} {engine}']['digest']} ({card})")
    print(json.dumps({"serve_steps": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        steps=out)}), flush=True)
    return 0


def gelu_sass(root: Path) -> dict:
    """Static SASS of ROOT's GELU kernels (``cuobjdump -sass`` of its built
    ``fused_mlp`` library): per instantiation the instructions and MUFU
    instructions in all and in the hottest loop (the backward branch that
    spans the most instructions), and that loop's instructions per element
    (rows a trip from the source's constants, times the elements of a
    16-byte chunk). Empty when the toolkit has no ``cuobjdump``."""
    import shutil

    from paddle_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    src = (root / "paddle_tpu_torch" / "csrc" / "fused_mlp.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kGelu\w+) = (\d+);", src))
    rows_a_trip = {False: int(consts.get("kGeluFwdDepth",
                                         consts.get("kGeluUnroll", 1))),
                   True: int(consts.get("kGeluBwdDepth",
                                        consts.get("kGeluUnroll", 1)))}
    text = subprocess.run([tool, "-sass", str(_build._target("fused_mlp")[1])],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out, name, code = {}, None, []
    for line in text.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if name and "gelu_kernel" in name:
                out.update(sass_loop(name, code, rows_a_trip))
            name, code = line.split("Function :")[1].strip(), []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                      r"([^;]*);", line)
        if m:
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def sass_loop(name, code, rows_a_trip):
    """{label: counts} of one GELU instantiation's SASS (``gelu_sass``)."""
    flags = re.findall(r"L[ib](\d+)E", name)
    bf16 = "13__nv_bfloat16" in name
    bwd = flags[:1] == ["1"]
    label = (f"{'bf16' if bf16 else 'fp32'} {'bwd' if bwd else 'fwd'} "
             f"flags {','.join(flags)}")
    lo = hi = None
    for addr, op, rest in code:
        tgt = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and tgt and int(tgt.group(1), 16) < addr and (
                lo is None or addr - int(tgt.group(1), 16) > hi - lo):
            lo, hi = int(tgt.group(1), 16), addr
    body = [op for addr, op, _ in code
            if lo is not None and lo <= addr <= hi]
    elems = rows_a_trip[bwd] * (8 if bf16 else 4)
    return {label: dict(
        instructions=len(code),
        mufu=sum(op.startswith("MUFU") for _, op, _ in code),
        loop_instructions=len(body),
        loop_mufu=sum(op.startswith("MUFU") for op in body),
        loop_per_element=len(body) / elems)}


def fused_gelu_only(root: Path) -> int:
    """``--ab fused-gelu [ROOT]``: the four GELU variants (forward and
    backward, with and without the bias) at the flagship shape in fp32 and
    bf16 with the ``paddle_tpu_torch`` package of the checkout at ``ROOT``
    (default: this one), each beside its bound and its library call, then
    the fused bf16 flagship step with its profile (the GELU kernels' device
    time and the device's busy share); prints one JSON line. Run it with
    two trees in turns to compare them on one card."""
    sys.path.insert(0, str(root))
    import paddle_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    shape = FUSED_GELU_SHAPES[0]
    variants = {}
    for kind in ("gelu_fwd", "gelu_bwd"):
        for dtype in (torch.float32, torch.bfloat16):
            for variant in ("plain", "bias"):
                t = fused_inputs(kind, shape, dtype, dev, SEED)
                kern, plain, lib = fused_calls(kind, variant, t)
                got, want = kern(), plain()
                got, want = ([g for g in (o if isinstance(o, tuple) else (o,))
                              if g is not None] for o in (got, want))
                held = max(fused_held(g, w, dtype)[1]
                           for g, w in zip(got, want))
                if not held <= FUSED_TOL[dtype]:
                    raise AssertionError(f"{kind} {variant} {dtype}: held "
                                         f"error {held}")
                nbytes, nops = fused_work(kind, variant, *shape,
                                          t["dy"].element_size())
                ms = time_ms(kern, iters=20, replays=3)
                lib_ms = None if lib is None else time_ms(lib, iters=20,
                                                          replays=3)
                bnd = bound_ms(nbytes, nops, torch.float32)
                label = f"{kind} {variant} {str(dtype)[6:]}"
                variants[label] = dict(ms=ms, bound_ms=bnd, library_ms=lib_ms,
                                       held=held)
                log(f"[fused-gelu] {label} {list(shape)}: kernel {ms:.4f} ms"
                    f", bound {bnd:.4f} ms ({bnd / ms:.3f} of it), library "
                    + ("null" if lib_ms is None else f"{lib_ms:.4f} ms")
                    + f"; held error {held:.3e}")
                del t
    sass = gelu_sass(root)
    for label, c in sass.items():
        log(f"[fused-gelu] SASS {label}: {c['instructions']} instructions "
            f"({c['mufu']} MUFU); hottest loop {c['loop_instructions']} "
            f"({c['loop_mufu']} MUFU), {c['loop_per_element']:.1f} an "
            "element")
    step = phase_train_bf16(dev, card, None, fused=True)
    print(json.dumps({"fused_gelu": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        shape=list(shape), variants=variants, sass=sass,
        step=dict(step_ms=step["step_ms"], fused_n=step["fused_n"],
                  profile=step["profile"]))}), flush=True)
    return 0


def ln_bwd_only(root: Path) -> int:
    """``--ab ln-bwd [ROOT]``: row 6 (the LN backward) at
    ``FUSED_LN_SHAPES`` in fp32, bf16 and fp16, with and without dso, with
    the ``paddle_tpu_torch`` package of the checkout at ``ROOT`` (default:
    this one), each held against its plain version and timed beside its
    bound and ``native_layer_norm_backward``; one call at the flagship shape
    under the profiler (its kernels and device time); then the fused bf16
    flagship step profiled: the LN backward's
    device time a step (its kernels' time in the step's profile, plus, for
    kernels of the call other than ``ln_bwd_kernel``, their time in the
    one-call profile times the step's launches), kernels a step and the
    busy share. Prints one JSON line; run it with two trees in turns to
    compare them on one card."""
    sys.path.insert(0, str(root))
    import paddle_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    cases = {}
    for si, shape in enumerate(FUSED_LN_SHAPES):
        for dtype in DTYPES:
            for variant in ("plain", "dso"):
                t = fused_inputs("ln_bwd", shape, dtype, dev, SEED + si)
                kern, plain, lib = fused_calls("ln_bwd", variant, t)
                got, want = kern(), plain()
                held = max(fused_held(g, w, dtype)[1]
                           for g, w in zip(got, want))
                if not held <= FUSED_TOL[dtype]:
                    raise AssertionError(f"ln_bwd {variant} {dtype} {shape}:"
                                         f" held error {held}")
                nbytes, nops = fused_work("ln_bwd", variant, *shape,
                                          t["dy"].element_size())
                ms = time_ms(kern, iters=20, replays=3)
                lib_ms = None if lib is None else time_ms(lib, iters=20,
                                                          replays=3)
                bnd = bound_ms(nbytes, nops, torch.float32)
                label = f"{variant} {str(dtype)[6:]} {list(shape)}"
                cases[label] = dict(ms=ms, bound_ms=bnd, library_ms=lib_ms,
                                    held=held)
                log(f"[ln-bwd] {label}: kernel {ms:.4f} ms, bound {bnd:.4f} "
                    f"ms ({bnd / ms:.3f} of it), library "
                    + ("null" if lib_ms is None else f"{lib_ms:.4f} ms")
                    + f"; held error {held:.3e}")
                del t
    shape, bf16 = FUSED_LN_SHAPES[0], torch.bfloat16
    t = fused_inputs("ln_bwd", shape, bf16, dev, SEED)
    kern = fused_calls("ln_bwd", "plain", t)[0]
    n_call, call_ms, names = call_kernels(kern)
    # the call's kernels other than ln_bwd_kernel (the parent's partial sums)
    other_ms = sum(ms for key, (_, ms) in names.items()
                   if "ln_bwd_kernel" not in key)
    log(f"[ln-bwd] one call, plain bf16 {list(shape)}: {n_call} kernel(s) "
        f"{names}, {call_ms:.4f} ms device (other than ln_bwd_kernel "
        f"{other_ms:.4f} ms)")
    del t
    step = phase_train_bf16(dev, card, None, fused=True)
    prof = step["profile"] or {}
    per_step = step["fused_n"][1] // TRAIN_STEPS
    ln_step = None
    if prof:
        ln_step = prof["groups_ms"]["fused LN bwd"] + per_step * other_ms
        log(f"[ln-bwd] fused bf16 flagship step: LN backward device time "
            f"{ln_step:.3f} ms a step ({per_step} calls: ln_bwd_kernel "
            f"{prof['groups_ms']['fused LN bwd']:.3f} ms + {per_step} x "
            f"{other_ms:.4f} ms of the call's other kernels), "
            f"{prof['kernels']} kernels a step, busy share "
            f"{prof['busy_share']:.3f}, step {step['step_ms']:.1f} ms "
            f"({card})")
    print(json.dumps({"ln_bwd": dict(
        package=str(Path(paddle_tpu_torch.__file__).parent), card=card,
        cases=cases, call=dict(kernels=n_call, ms=call_ms, names=names,
                               other_ms=other_ms),
        step=dict(step_ms=step["step_ms"],
                               fused_n=step["fused_n"],
                               ln_bwd_ms=ln_step, profile=prof))}),
          flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs on a CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    root = ROOT
    parts = {"moe-forward": moe_forward_only, "fused-gelu": fused_gelu_only,
             "paged-walks": paged_walks_only, "mlp-gemms": mlp_gemms_only,
             "moe-gemms": moe_gemms_only, "int4-decode": int4_decode_only,
             "flash": flash_ab_only, "ln-bwd": ln_bwd_only,
             "qmm-dx": qmm_dx_only, "moe-dx": moe_dx_only,
             "capture": capture_only, "serve-steps": serve_steps_only,
             "spec": spec_only, "moe-profile": moe_profile_only,
             "resilience": resilience_only}
    if args[:1] == ["--ab"] and 2 <= len(args) <= 3 and args[1] in parts:
        root = Path(args[2]).resolve() if len(args) == 3 else ROOT
    elif args:
        print(f"chip_smoke: unknown arguments {args} (none, or --ab PART "
              f"[ROOT] with PART one of {', '.join(parts)})",
              file=sys.stderr)
        return 2
    if not (root / "paddle_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no paddle_tpu_torch package in {root}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    if args:
        return parts[args[1]](root)
    sys.path.insert(0, str(ROOT))
    from dataclasses import replace

    from paddle_tpu_torch.models.convert import random_state, state_from_jax_numpy
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.flash_attention import bwd_smem_bytes
    from paddle_tpu_torch.ops.flash_attention import smem_bytes as flash_smem
    from paddle_tpu_torch.ops.mega_decode import smem_bytes as mega_smem
    from paddle_tpu_torch.ops.paged_attention import smem_bytes as ragged_smem
    from paddle_tpu_torch.ops.paged_attention import walk_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {kind}; nvidia-smi: {card}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build(["ragged_paged_attention", "flash_attention_fwd",
                          "flash_attention_bwd", "quant_matmul",
                          "fused_mlp", "mega_decode", "mega_decode_f16",
                          "grouped_matmul", "paged_decode_attention"])
    PHASE_S["build"] = time.perf_counter() - t0
    log(f"[build] nine kernel sources for sm_90a in "
        f"{PHASE_S['build']:.1f} s")
    for name, text in logs.items():
        for line in ptxas_summary(name, text):
            log(f"[build] {line}")
    ln_bwd = [line for line in ptxas_summary("fused_mlp", logs["fused_mlp"])
              if "ln_bwd_kernel" in line]
    spilled = [line for line in ln_bwd
               if re.search(r"[1-9]\d* bytes spill", line)]
    log(f"[build] ln_bwd_kernel: {len(ln_bwd)} instances, "
        f"{len(spilled)} with spills")
    if not ln_bwd or spilled:
        raise AssertionError(f"ln_bwd_kernel spills: {spilled}")
    dx = [line for line in ptxas_summary("quant_matmul",
                                         logs["quant_matmul"])
          if "qmm_dx_kernel" in line]
    spilled = [line for line in dx
               if re.search(r"[1-9]\d* bytes spill", line)]
    log(f"[build] qmm_dx_kernel: {len(dx)} instances, {len(spilled)} with "
        "spills")
    if len(dx) != 4 or spilled:
        raise AssertionError(f"qmm_dx_kernel: {dx}")
    gdx = [line for line in ptxas_summary("grouped_matmul",
                                          logs["grouped_matmul"])
           if "gmm_dx_kernel" in line]
    spilled = [line for line in gdx
               if re.search(r"[1-9]\d* bytes spill", line)]
    log(f"[build] gmm_dx_kernel: {len(gdx)} instances, {len(spilled)} with "
        "spills")
    if len(gdx) != 2 or spilled:
        raise AssertionError(f"gmm_dx_kernel: {gdx}")
    g = RAGGED_GEOM
    log(f"[build] dynamic shared memory per block: ragged_paged_attention "
        f"{ragged_smem(g['chunk'] * g['hq'] // g['hkv'], g['d'])} B"
        f" (chunk {g['chunk']}, d {g['d']}, fp32 pools) / "
        f"{ragged_smem(g['chunk'], g['d'], torch.int8)} B (int8 pools), "
        "flash_attention_fwd bf16 " + " / ".join(
            f"{flash_smem(d)} B (d {d})" for d in (32, 64, 80, 96, 128))
        + f", fp32 {flash_smem(64, torch.float32)} / "
        f"{flash_smem(128, torch.float32)} B (d 64 / 128), "
        "flash_attention_bwd bf16 " + " / ".join(
            f"{bwd_smem_bytes(d)} B (d {d})" for d in (32, 64, 80, 96, 128))
        + f", fp32 {bwd_smem_bytes(64, torch.float32)} / "
        f"{bwd_smem_bytes(128, torch.float32)} B (d 64 / 128), mega attention "
        f"{mega_smem(MEGA_SERVING[0][1], 64)} B (chunk "
        f"{MEGA_SERVING[0][1]}, d 64, fp32) / {mega_smem(64, 128)} B "
        f"(chunk 64, d 128, fp32) / " + " / ".join(
            f"{mega_smem(16, d, torch.bfloat16)} B (d {d})"
            for d in (32, 80, 96)) + " (chunk 16, bf16)")
    b, hq, hkv, d, ps, pps = DECODE_SERVING[0]
    plan = walk_plan(b, hkv, pps, ps, d, hq // hkv, 4,
                     torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"[build] paged decode split walk at the serving pools ({b} slots x "
        f"{hkv} heads, {pps} pages of {ps}): {plan.splits} splits of "
        f"{plan.pages} pages a pair, {plan.blocks} blocks = "
        f"{plan.waves:.2f} waves, {plan.partial_bytes} B of partials")

    # 3, 4. kernels vs plain versions
    ragged = timed(phase_ragged, dev)
    ragged_walks = timed(phase_ragged_walks, dev)
    flash = timed(phase_flash, dev)

    # 5, 6. the main path on GPT-125M (random weights from a numpy seed)
    cfg = GPT_CONFIGS["gpt3-125m"]
    model = state_from_jax_numpy(random_state(cfg, SEED), cfg, device=dev)
    model.eval()
    flash_launches = timed(phase_forward, model, cfg, dev)
    ragged_launches, fp_outs, fp16_step_ms = timed(phase_serve, model, cfg,
                                                   dev, card)

    # 8. quantized serving, while GPT-125M is on the card
    qmm = timed(phase_qmm, dev)
    ragged8 = timed(phase_ragged_int8, dev)
    quant_launches, quant_streams = timed(
        phase_quant_serve, model, cfg, dev, card, fp_outs, fp16_step_ms)

    # 10. mega-kernel serving, while GPT-125M is on the card
    mega = timed(phase_mega_kernels, dev, card)
    mlp_rounds = timed(phase_mlp_rounds, dev, card)
    mega_walks = timed(phase_mega_walks, dev)
    mega_launches = timed(phase_mega_serve, model, cfg, dev, card, fp_outs,
                          quant_streams)
    wide_launches = timed(phase_mega_wide, dev)

    # 11. MoE serving (GPT-125M, 4 experts, top-2), its kernels and its
    # gradients; the attention routing of what the flash kernels do not take
    gmm = timed(phase_gmm, dev, card)
    moe_cfg = replace(cfg, **MOE)
    gmm_launches = timed(phase_moe_serve, moe_cfg, dev, card, fp16_step_ms)

    # 15. every unified form on the captured step and the async engine,
    # beside the eager step and the synchronous engine
    capture_launches = timed(phase_captured, model, cfg, moe_cfg, dev,
                             card)[0]
    moe_fwd = timed(phase_moe_forward,
                    replace(moe_cfg, moe_capacity_factor=1.25), dev, card)
    gmm_bwd_launches = timed(phase_moe_grads,
                             replace(moe_cfg, moe_capacity_factor=1.25), dev)
    timed(phase_attention_routing, dev)

    # 16. speculative decoding on the captured step and the async engine
    spec_launches = timed(phase_spec, model, cfg, dev, card)[0]

    # 17. the resilience and observability layers on the captured step
    res_launches = timed(phase_resilience, model, cfg, dev, card)[0]

    # 12. the legacy two-program path: the paged decode kernel, the ragged
    # kernel's new head dims, GPT-125M served legacy, a d 96 model
    decode = timed(phase_decode_kernel, dev)
    timed(phase_ragged_dims, dev)
    decode_launches = timed(phase_legacy_serve, model, cfg, dev, card,
                            fp_outs, quant_streams, fp16_step_ms)
    decode_launches += timed(phase_legacy_d96, dev)

    # 7. training: the backward kernel, then the training path; 9. the
    # fused-MLP kernels and their paths, each beside its phase-7 twin
    bwd = timed(phase_flash_bwd, dev)
    model.train()
    timed(phase_eager_grads, model, cfg, dev)
    fused = timed(phase_fused_kernels, dev)
    timed(phase_fused_eager, model, cfg, dev)
    # every path so far ran the kernels; 14. the fp16 paths run the fp16
    # kernels (each held against the same path on the twins, whose calls
    # count as twin routes: read the count after it)
    if twin_route_count():
        raise AssertionError(f"{twin_route_count()} fp32 / bf16 / fp16 calls"
                             " ran a plain twin on the card")
    n16 = timed(phase_fp16, model, cfg, dev)
    twin_n = twin_route_count()
    del model
    timed(phase_train_fp32, dev)
    timed(phase_train_bf16_parity, dev)
    timed(phase_fused_train_fp32, dev)
    train = timed(phase_train_bf16, dev, card, bwd[torch.bfloat16])
    fused_train = timed(phase_train_bf16, dev, card, bwd[torch.bfloat16],
                        fused=True, unfused=train)
    train_fwd = train["fwd_n"] + fused_train["fwd_n"]
    train_bwd = train["bwd_n"] + fused_train["bwd_n"]

    # 13. BERT-base pretraining through the mask branch; its classifier,
    # the varlen entry and each branch alone against its plain version
    bert = timed(phase_bert_train, dev, card)
    bert_cls = timed(phase_bert_classify, dev)
    varlen_launches = timed(phase_bert_varlen, dev, bert["lens"])[0]
    branches = timed(phase_bert_branches, dev, bert["lens"])

    if twin_route_count() != twin_n:
        raise AssertionError(f"{twin_route_count() - twin_n} fp32 / bf16 "
                             "training calls ran a plain twin")
    kernels = []
    bf16 = torch.bfloat16
    qmm_rows = []
    for bits, gs, line in ((8, -1, 154), (4, 128, 170)):
        st = qmm[(f"int{bits}", gs, bf16)]
        qmm_rows.append((f"quant_matmul_int{bits}", line,
                         quant_launches[f"int{bits}"]
                         + quant_launches[f"int{bits}_bf16"]
                         + spec_launches[f"int{bits}"]
                         + res_launches[f"int{bits}"], st))
    for bits, gs, line in ((8, -1, 194), (4, 128, 210)):
        st = qmm[(f"int{bits}", gs, bf16)]
        qmm_rows.append((f"quant_matmul_int{bits}_bwd", line,
                         quant_launches[f"int{bits}_bwd"]
                         + quant_launches[f"int{bits}_bwd_bf16"],
                         dict(st, ms=st["bwd_ms"],
                              plain_ms=st["bwd_plain_ms"],
                              max_abs_err=st["bwd_max_abs_err"],
                              library_ms=None)))
    for name, src, replaces, launches, s in (
            ("ragged_paged_attention",
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:264",
             ragged_launches + quant_launches["ragged"]
             + spec_launches["ragged"] + res_launches["ragged"],
             ragged[torch.float32]),
            ("paged_decode_attention",
             "paddle_tpu_torch/csrc/paged_decode_attention.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:90",
             decode_launches, decode[torch.float32]),
            ("flash_attention_fwd",
             "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:262",
             flash_launches + train_fwd, bwd[bf16]["fwd"]),
            ("flash_attention_bwd",
             "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:419",
             train_bwd, bwd[torch.bfloat16]),
            *((name, "paddle_tpu_torch/csrc/quant_matmul.cu",
               f"paddle_tpu/ops/pallas/quant_matmul.py:{line}", n, st)
              for name, line, n, st in qmm_rows),
            *((f"fused_mlp_{fkind}", "paddle_tpu_torch/csrc/fused_mlp.cu",
               f"paddle_tpu/ops/pallas/fused_mlp.py:{line}",
               fused_train["fused_n"][i], fused[(fkind, "plain", bf16)])
              for i, ((fkind, _), line) in enumerate(
                  zip(FUSED_KINDS, (105, 128, 281, 293)))),
            *((f"mega_{part}", "paddle_tpu_torch/csrc/mega_decode.cu",
               f"paddle_tpu/ops/pallas/mega_decode.py:{line}",
               mega_launches[i] + spec_launches[f"mega_{part}"]
               + res_launches[f"mega_{part}"], st)
              for i, (part, line, st) in enumerate((
                  ("attn", 224, mega[(None, False, torch.float32)]["attn"]),
                  ("mlp", 677, mlp_rounds[("served round", None,
                                           torch.float32)])))),
            *((f"grouped_matmul_{name}",
               "paddle_tpu_torch/csrc/grouped_matmul.cu",
               f"paddle_tpu/ops/pallas/grouped_matmul.py:{line}", n,
               gmm[(kname, label, bf16, "a")])
              for name, kname, label, line, n in (
                  ("fp", "gmm", "fp", 192, gmm_launches["fp"]
                   + gmm_launches["tc"] + moe_fwd["tc_launches"] * BF16_RUNS),
                  ("int8", "gmm_q", "int8", 210, gmm_launches["int8"]),
                  ("int4", "gmm_q4", "int4 g128", 226, gmm_launches["int4"]),
                  ("fp_bwd", "gmm_bwd", "fp", 251, gmm_bwd_launches[0]),
                  ("int8_bwd", "gmm_q_bwd", "int8", 268,
                   gmm_bwd_launches[1])))):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"]})
    for part, line in (("fwd", 262), ("bwd", 419)):
        for branch, key, n in (("mask", "mask", bert["launches"][part]),
                               ("varlen", "lens", varlen_launches[part])):
            st = branches[(key, bf16)][part]
            f32 = branches[(key, torch.float32)][part]
            kernels.append({
                "name": f"flash_attention_{part}_{branch}", "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/flash_attention_{part}.cu",
                "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
                "launches": n,
                **{k: st[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")},
                "note": (
                    f"bf16 at [{BERT_BATCH}, {BERT_SEQ}, 12, 64] non-causal "
                    + ("with BERT's key-padding mask [b, 1, 1, s]; library: "
                       "torch sdpa with the same attn_mask"
                       if branch == "mask" else
                       "with the batch's lengths (lens = q_len = kv_len); "
                       "library: torch sdpa with the key-padding attn_mask "
                       "[b, 1, 1, s] built from the lengths (it computes "
                       "the padded rows too)")
                    + f"; fp32: ms {f32['ms']:.4f}, plain_ms "
                    f"{f32['plain_ms']:.4f}, bound_ms {f32['bound_ms']:.6f}; "
                    + (f"launches: the {BERT_STEPS} bert-base pretraining "
                       f"steps ({bert_cls} more in the classifier forwards)"
                       if branch == "mask" else
                       "launches: the flash_attn_unpadded calls of phase 13 "
                       "(c)"))})
    row_of = {k["name"]: k for k in kernels}
    # the rows phase 15 runs inside the captured step: launches one replay
    # of each form's capture holds
    for name, key in (
            ("ragged_paged_attention", ("ragged_paged_attention",
                                        "launches", None)),
            ("quant_matmul_int8", ("quant_matmul_fwd", "launches", "int8")),
            ("quant_matmul_int4", ("quant_matmul_fwd", "launches", "int4")),
            ("mega_attn", ("mega_attn_layer", "launches", None)),
            ("mega_mlp", ("mega_mlp", "launches", None)),
            ("grouped_matmul_fp", ("grouped_matmul_fwd", "launches", "fp"))):
        row_of[name]["captured_replay"] = {
            label: st["replay"][key] for label, st in capture_launches.items()
            if st["replay"].get(key)}
        # the main path's steps replay captures: the wrapper adds a
        # capture's launches a replay, and phase 15 held that to the
        # profiler's count of the kernels the replays ran
        row_of[name]["launches_from"] = ("counters; on the captured step a "
                                         "replay adds its capture's launches")
    for i, part in enumerate(("attn", "mlp")):   # gpt3-760m / 2.7b widths
        row_of[f"mega_{part}"]["wide_launches"] = wide_launches[i]
    # phase 16's speculative runs, counted in the rows' launches
    for name, key in (("ragged_paged_attention", "ragged"),
                      ("quant_matmul_int8", "int8"),
                      ("quant_matmul_int4", "int4"),
                      ("mega_attn", "mega_attn"), ("mega_mlp", "mega_mlp")):
        row_of[name]["spec_launches"] = spec_launches[key]
        row_of[name]["resilience_launches"] = res_launches[key]
    serving, long_fwd, long_bwd = flash[bf16], flash["long"], bwd["long"]
    row_of["flash_attention_fwd"]["serving_shape"] = dict(
        shape=list(FLASH_SHAPE), dtype="bf16",
        **{k: serving[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")})
    for name, st in (("flash_attention_fwd", long_fwd),
                     ("flash_attention_bwd", long_bwd)):
        row_of[name]["long"] = dict(
            shape=list(FLASH_LONG), dtype="bf16",
            **{k: st[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")})
    f32 = flash[torch.float32]
    row_of["flash_attention_fwd"]["note"] = (
        f"bf16 at the training shape {list(BWD_SHAPE)} causal (tensor "
        "cores); serving_shape: bf16 at the full-forward shape; long: bf16 "
        f"at {list(FLASH_LONG)}; fp32 (CUDA cores) at {list(FLASH_SHAPE)}: "
        f"ms {f32['ms']:.4f}, plain_ms {f32['plain_ms']:.4f}, bound_ms "
        f"{f32['bound_ms']:.6f}, library_ms {f32['library_ms']:.4f}; at the "
        f"training shape ms {bwd[torch.float32]['fwd_ms']:.4f}; launches: "
        "phase 5's full forward and both flagship runs")
    b32 = bwd[torch.float32]
    row_of["flash_attention_bwd"]["note"] = (
        f"bf16 at the training shape {list(BWD_SHAPE)} causal (tensor "
        f"cores); long: bf16 at {list(FLASH_LONG)}; fp32 (CUDA cores) at the"
        f" training shape: ms {b32['ms']:.4f}, plain_ms "
        f"{b32['plain_ms']:.4f}, bound_ms {b32['bound_ms']:.6f}, library_ms"
        f" {b32['library_ms']:.4f}; launches: both flagship runs")
    for fkind, variants in FUSED_KINDS:
        row = row_of[f"fused_mlp_{fkind}"]
        other = fused[(fkind, variants[1], bf16)]
        shape = (FUSED_LN_SHAPES if fkind.startswith("ln")
                 else FUSED_GELU_SHAPES)[0]
        row["note"] = (
            f"bf16 at {list(shape)}"
            f" without {variants[1]}; with {variants[1]}: ms "
            f"{other['ms']:.4f}, plain_ms {other['plain_ms']:.4f}, bound_ms "
            f"{other['bound_ms']:.6f}, max_abs_err {other['max_abs_err']:.3e}"
            ", library_ms null (no single PyTorch call); launches: the "
            f"{TRAIN_STEPS} fused bf16 flagship steps")
        if fkind.startswith("ln"):
            small = fused[(fkind, "plain", bf16, 1)]
            row["gpt3_125m_shape"] = dict(
                shape=list(FUSED_LN_SHAPES[1]), dtype="bf16",
                **{k: small[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")})
        if fkind.startswith("gelu"):
            row["variants"] = {
                f"{v} {str(t)[6:]}": {k: fused[(fkind, v, t)][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err")}
                for t in (torch.float32, bf16) for v in variants}
    fp32, b16 = (mega[(None, False, t)] for t in (torch.float32, bf16))
    q8 = mega[("int8", True, bf16)]
    for part in ("attn",):
        row_of[f"mega_{part}"]["note"] = (
            f"fp32, fp weights and KV, at the serving shapes; bf16: ms "
            f"{b16[part]['ms']:.4f}, plain_ms {b16[part]['plain_ms']:.4f}, "
            f"bound_ms {b16[part]['bound_ms']:.6f}; bf16 int8 g128 weights "
            f"+ int8 KV: ms {q8[part]['ms']:.4f}, bound_ms "
            f"{q8[part]['bound_ms']:.6f}; one mega layer vs the per-op layer"
            f" it replaces: fp32 {fp32['layer_ms']:.4f} vs "
            f"{fp32['per_op_layer_ms']:.4f} ms, bf16 {b16['layer_ms']:.4f} vs"
            f" {b16['per_op_layer_ms']:.4f} ms; " + (
                "decode round (8 lanes x 1 row, 1,023 tokens): " + ", ".join(
                    f"{str(t)[6:]} {'int8' if kv else 'fp'} KV ms "
                    f"{mega_walks[('decode round', kv, t)]['ms']:.4f} "
                    f"(bound {mega_walks[('decode round', kv, t)]['bound_ms']:.6f})"
                    for t in (torch.float32, bf16) for kv in (False, True))
                + "; " if part == "attn" else "")
            + "launches: phase 10's three fp32 served runs and the "
            + f"{' / '.join(MEGA_WIDE)} runs (2 a step)")
    dense = mlp_rounds[("dense", None, torch.float32)]
    row_of["mega_mlp"]["dense"] = dict(   # every row of the lane block
        shape=[MEGA_SERVING[0][0] * MEGA_SERVING[0][1], MEGA_SERVING[0][2]],
        dtype="fp32", **{k: dense[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
    row_of["mega_mlp"]["note"] = (
        f"fp32, fp weights, at the served round (q_lens "
        f"{MLP_ROUNDS['served round']} of chunk {MEGA_SERVING[0][1]}: 24 live "
        "rows of 128; the others written as zeros); dense: every row of the "
        "block, the shape this row measured before; " + "; ".join(
            f"{r} {str(t)[6:]} {wd or 'fp'}{'' if wd is None else ' g128'}: "
            f"ms {st['ms']:.4f}, plain_ms {st['plain_ms']:.4f}, bound_ms "
            f"{st['bound_ms']:.6f}"
            for (r, wd, t), st in mlp_rounds.items()
            if (r, wd, t) != ("served round", None, torch.float32))
        + f"; one mega layer vs the per-op layer it replaces (phase 10's "
        f"serving lanes): fp32 {fp32['layer_ms']:.4f} vs "
        f"{fp32['per_op_layer_ms']:.4f} ms, bf16 {b16['layer_ms']:.4f} vs "
        f"{b16['per_op_layer_ms']:.4f} ms; launches: phase 10's three fp32 "
        f"served runs and the {' / '.join(MEGA_WIDE)} runs (2 a step)")
    q8r = qmm[("int8", -1, bf16)]
    row_of["quant_matmul_int8"]["note"] = (
        "bf16, the sum of one layer's four GEMMs at M "
        f"{QMM_ROWS} on the tensor-core route (qmm_tc_kernel); cuBLAS on "
        f"the pre-dequantized weight (the fp product it replaces, reading "
        f"twice the bytes): {q8r['cublas_ms']:.4f} ms; at M "
        f"{QMM_DECODE_ROWS}: ms {q8r['decode_ms']:.4f}, bound_ms "
        f"{q8r['decode_bound_ms']:.6f}; at M {QMM_SPEC_ROWS} (phase 16's "
        f"verify budget): ms {q8r['spec_ms']:.4f}, bound_ms "
        f"{q8r['spec_bound_ms']:.6f}; fp32: ms "
        f"{qmm[('int8', -1, torch.float32)]['ms']:.4f}, bound_ms "
        f"{qmm[('int8', -1, torch.float32)]['bound_ms']:.6f}; int8 g128 "
        f"bf16: ms {qmm[('int8', 128, bf16)]['ms']:.4f}; launches: phase 8's "
        "fp32 served runs (a) and (c), on the CUDA-core kernel (qmm_kernel), "
        "and its bf16 served runs (a) and (c), on the tensor-core route")
    q4r, q4f = qmm[("int4", 128, bf16)], qmm[("int4", 128, torch.float32)]
    s4 = quant_launches["serve_bf16"][QUANT_SERVE[1][0]]
    row_of["quant_matmul_int4"]["note"] = (
        "bf16 g128, the sum of one layer's four GEMMs at M "
        f"{QMM_ROWS} on the tensor-core route (qmm_tc_kernel<uint8_t>); at "
        f"M {QMM_DECODE_ROWS}: ms {q4r['decode_ms']:.4f}, bound_ms "
        f"{q4r['decode_bound_ms']:.6f}; at M {QMM_SPEC_ROWS}: ms "
        f"{q4r['spec_ms']:.4f}, bound_ms {q4r['spec_bound_ms']:.6f}; fp32 "
        f"(qmm_kernel, the CUDA-core "
        f"kernel): ms {q4f['ms']:.4f}, plain_ms {q4f['plain_ms']:.4f}, "
        f"bound_ms {q4f['bound_ms']:.6f}; bf16 serving (b): mean step "
        + " / ".join(f"{w:.3f}" for w in s4["step_ms"]) + " ms"
        + (f", device busy {s4['busy_ms']:.4f} ms a step (weight-only GEMM "
           f"{s4['gemm_ms']:.4f})" if "busy_ms" in s4 else "")
        + "; launches: phase 8's fp32 served run (b) on qmm_kernel and its "
        "bf16 served runs (b) on the tensor-core route")
    for bits, gs in ((8, -1), (4, 128)):
        b, f = qmm[(f"int{bits}", gs, bf16)], qmm[(f"int{bits}", gs,
                                                    torch.float32)]
        row_of[f"quant_matmul_int{bits}_bwd"]["note"] = (
            f"bf16{' g128' if gs > 0 else ''}, the sum of one layer's four dx"
            f" GEMMs at M {QMM_ROWS} on the tensor-core dx route "
            f"(qmm_dx_kernel); at M {QMM_DECODE_ROWS}: ms "
            f"{b['dx8_ms']:.4f}, bound_ms {b['dx8_bound_ms']:.6f}; at M "
            f"{QMM_DX_ROWS}: ms {b[f'dx{QMM_DX_ROWS}_ms']:.4f}, bound_ms "
            f"{b[f'dx{QMM_DX_ROWS}_bound_ms']:.6f}; cuBLAS on the "
            f"pre-dequantized weight (dy @ w_fp.T, not a port path): "
            f"{b['bwd_cublas_ms']:.4f} ms at M {QMM_ROWS}, "
            f"{b[f'dx{QMM_DX_ROWS}_cublas_ms']:.4f} at M {QMM_DX_ROWS}; fp32"
            f" (qmm_kernel, the CUDA-core kernel): ms {f['bwd_ms']:.4f}, "
            f"plain_ms {f['bwd_plain_ms']:.4f}, bound_ms "
            f"{f['bound_ms']:.6f}; launches: phase 8's fp32 input-gradient "
            f"drive ({quant_launches[f'int{bits}_bwd']} on qmm_kernel) and "
            f"its bf16 drive ({quant_launches[f'int{bits}_bwd_bf16']} on "
            "qmm_dx_kernel)")
    for name, kname, label in (
            ("fp", "gmm", "fp"), ("int8", "gmm_q", "int8"),
            ("int4", "gmm_q4", "int4 g128"), ("fp_bwd", "gmm_bwd", "fp"),
            ("int8_bwd", "gmm_q_bwd", "int8")):
        row = row_of[f"grouped_matmul_{name}"]
        f32, pre = (gmm[(kname, label, t, r)] for t, r in
                    ((torch.float32, "a"), (bf16, "b")))
        extra = ""
        if kname == "gmm_q":
            g = gmm[(kname, "int8 g128", bf16, "a")]
            extra = (f"; int8 g128: ms {g['ms']:.4f}, bound_ms "
                     f"{g['bound_ms']:.6f}")
        if kname in ("gmm_q", "gmm_q4"):
            served = gmm_launches["serve_bf16"][MOE_SERVE_BF16[
                kname == "gmm_q4"][0]]
            row["serve_bf16"] = served
            extra += ("; at the serving rows bf16 on the skinny route "
                      "(gmm_sk_kernel), prefill rows and fp32 on gmm_kernel"
                      "; bf16 MoE serving at cf 1.25: mean step "
                      + " / ".join(f"{w:.3f}" for w in served["step_ms"])
                      + " ms" + (f", device busy {served['busy_ms']:.4f} ms"
                                 f" a step (grouped GEMM "
                                 f"{served['gmm_ms']:.4f})"
                                 if "busy_ms" in served else ""))
        if kname == "gmm_q_bwd":
            g = gmm[(kname, "int8 g128", bf16, "a")]
            a16 = gmm[(kname, label, bf16, "a")]
            row["prefill_shape"] = dict(
                rows=GMM_PREFILL, dtype="bf16",
                **{k: pre[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")})
            extra = (f"; int8 g128: ms {g['ms']:.4f}, bound_ms "
                     f"{g['bound_ms']:.6f}; bf16 on the dx route "
                     "(gmm_dx_kernel, the dx tile of csrc/dx_tile.cuh) at "
                     "the serving and the prefill rows, fp32 on gmm_kernel"
                     "; torch._grouped_mm on the pre-dequantized stack's "
                     "transpose (not a port path): "
                     + " / ".join("null" if v is None else f"{v:.4f}"
                                  for v in (a16["deq_ms"], pre["deq_ms"]))
                     + " ms at the serving / prefill rows; launches: the "
                     "fp32 drive's 4 on gmm_kernel and the bf16 drive's 4 "
                     "on the dx route")
        if kname in ("gmm", "gmm_bwd"):
            row["prefill_shape"] = dict(
                rows=GMM_PREFILL, dtype="bf16",
                **{k: pre[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")})
            extra = ("; bf16 on the tensor cores (gmm_tc_kernel at the "
                     "serving rows, gmm_wg_kernel at the prefill rows), fp32 "
                     "on the CUDA cores")
        row["note"] = (
            f"bf16, w1 + w2 at the serving rows {GMM_ROWS}; fp32: ms "
            f"{f32['ms']:.4f}, plain_ms {f32['plain_ms']:.4f}, bound_ms "
            f"{f32['bound_ms']:.6f}; bf16 prefill rows {GMM_PREFILL}: ms "
            f"{pre['ms']:.4f}, plain_ms {pre['plain_ms']:.4f}, bound_ms "
            f"{pre['bound_ms']:.6f} ({pre['bound_by']}), library_ms "
            + (f"{pre['library_ms']:.4f}" if pre["library_ms"] is not None
               else "null") + extra + "; library: torch._grouped_mm"
            + ("" if row["library_ms"] is not None else
               f" null ({gmm[(kname, label, bf16, 'a')]['library_note']})")
            + ("; launches: phase 11's fp32 served runs" + (
                f", its {1 + BF16_RUNS} bf16 served runs and {BF16_RUNS} bf16"
                " full forwards" if kname == "gmm" else
                f" and its {1 + MOE_QUANT_RUNS} bf16 served runs")
               if "bwd" not in kname
               else "; launches: phase 11's gradient drives"))
    row_of["ragged_paged_attention"]["note"] = (
        "int8-KV branch checked too: max_abs_err "
        f"{ragged8[torch.float32]['max_abs_err']:.3e} fp32, "
        f"{ragged8[torch.float32]['ms']:.4f} ms vs bound "
        f"{ragged8[torch.float32]['bound_ms']:.6f} ms; split walks: " + ", ".join(
            f"{name} {kv} KV {str(t)[6:]} ms {st['ms']:.4f} (bound "
            f"{st['bound_ms']:.6f})"
            for (name, kv, t), st in ragged_walks.items())
        + "; launches include the quantized serving runs; head dims 32 / "
        "80 / 96 checked in phase 12")
    row_of["mega_attn"]["note"] += (
        "; head dims 32 / 80 / 96 checked against the plain version in "
        "phase 10")
    d16 = decode[bf16]
    row_of["paged_decode_attention"]["note"] = (
        "the split walk (paged_decode_split_kernel); fp32 at phase 3's "
        f"serving pools (lengths {DECODE_SERVING[1]}); "
        f"bf16: ms {d16['ms']:.4f}, plain_ms {d16['plain_ms']:.4f}, "
        f"bound_ms {d16['bound_ms']:.6f}; the ragged kernel at chunk 1 on "
        f"the same pools: fp32 {decode[torch.float32]['ragged_ms']:.4f} ms, "
        f"bf16 {d16['ragged_ms']:.4f} ms; launches: phase 12's fp32 legacy "
        "served runs (GPT-125M fp and int8, the d 96 model)")
    # each row's fp16 instance: launches on the fp16 paths of phase 14, its
    # route, and the same figures as the row's, from the fp16 legs of the
    # phases that time the row (beside the bf16 leg's time)
    f16, keys = torch.float16, ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")

    def qmm_leg(bits, gs, t, bwd):
        st = qmm[(f"int{bits}", gs, t)]
        return (dict(st, ms=st["bwd_ms"], plain_ms=st["bwd_plain_ms"],
                     max_abs_err=st["bwd_max_abs_err"], library_ms=None)
                if bwd else st)

    legs = {   # row: (fp16 stats, bf16 stats, fp16 route, fp16 launches)
        "ragged_paged_attention": (
            ragged[f16], ragged[bf16], "CUDA cores: the split page walk "
            "(fp32 FMA over fp16 pages)", n16["ragged"]),
        "paged_decode_attention": (
            decode[f16], decode[bf16], "CUDA cores: the split page walk",
            n16["decode"]),
        "flash_attention_fwd": (
            bwd[f16]["fwd"], bwd[bf16]["fwd"], "tensor cores: wgmma "
            "(d 128, this shape), mma.sync below", n16["flash_fwd"]),
        "flash_attention_bwd": (bwd[f16], bwd[bf16], "tensor cores: "
                                "mma.sync", n16["flash_bwd"]),
        **{f"quant_matmul_int{bits}{sfx}": (
            qmm_leg(bits, gs, f16, sfx), qmm_leg(bits, gs, bf16, sfx),
            "tensor cores: qmm_dx_kernel (mma.sync, dequantized in "
            "registers)" if sfx else
            "tensor cores: qmm_tc_kernel (mma.sync, dequantized in "
            "registers)", n16[f"qmm_int{bits}{sfx}"])
           for bits, gs in ((8, -1), (4, 128)) for sfx in ("", "_bwd")},
        **{f"fused_mlp_{fkind}": (
            fused[(fkind, "plain", f16)], fused[(fkind, "plain", bf16)],
            "CUDA cores: streaming, fp32 math", n16[fkind])
           for fkind, _ in FUSED_KINDS},
        "mega_attn": (mega[(None, False, f16)]["attn"],
                      mega[(None, False, bf16)]["attn"],
                      "tensor cores: mma.sync (QKV, projection), the page "
                      "walk on the CUDA cores", n16["mega_attn"]),
        "mega_mlp": (mlp_rounds[("served round", None, f16)],
                     mlp_rounds[("served round", None, bf16)],
                     "tensor cores: the skinny tile (mma.sync)",
                     n16["mega_mlp"]),
        **{f"grouped_matmul_{name}": (
            gmm[(kname, label, f16, "a")], gmm[(kname, label, bf16, "a")],
            route, n16[f"gmm_{name}"]) for name, kname, label, route in (
            ("fp", "gmm", "fp", "tensor cores: gmm_tc_kernel (mma.sync)"),
            ("int8", "gmm_q", "int8", "tensor cores: gmm_sk_kernel"),
            ("int4", "gmm_q4", "int4 g128", "tensor cores: gmm_sk_kernel"),
            ("fp_bwd", "gmm_bwd", "fp", "tensor cores: gmm_tc_kernel dx"),
            ("int8_bwd", "gmm_q_bwd", "int8", "tensor cores: gmm_dx_kernel "
             "(the dx tile, mma.sync, dequantized in registers)"))},
        **{f"flash_attention_{part}_{branch}": (
            branches[(key, f16)][part], branches[(key, bf16)][part],
            "tensor cores: mma.sync", n16[f"{key}_{part}"])
           for part in ("fwd", "bwd")
           for branch, key in (("mask", "mask"), ("varlen", "lens"))},
    }
    for row in kernels:
        st, b16, route, n = legs[row["name"]]
        row["fp16"] = dict(route=route, launches=n, bf16_ms=b16["ms"],
                           **{k: st[k] for k in keys})
        if not n:
            raise AssertionError(f"{row['name']}: no fp16 launch on the "
                                 "fp16 paths")
    log("[fp16] by kernel row, fp16 vs bf16 ms (" + card + "): " + "; ".join(
        f"{r['name']} {r['fp16']['ms']:.4f} vs {r['fp16']['bf16_ms']:.4f} "
        f"({r['fp16']['ms'] / r['fp16']['bf16_ms'] - 1:+.1%}), bound "
        f"{r['fp16']['bound_ms']:.6f}, launches {r['fp16']['launches']}"
        for r in kernels))
    log("[time] wall seconds by phase (moe_serve_quant_bf16 inside "
        "phase_moe_serve): " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in PHASE_S.items()))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        "(summary: ragged times in fp32 at the serving shapes of phase 3, "
        "launches on the main paths of phases 5-8, 16 and 17; "
        "flash_attention_fwd and "
        f"_bwd in bf16 at the training shape {list(BWD_SHAPE)}, launches in "
        "phase 5 and the bf16 training runs; "
        "quant_matmul_* in bf16, the sum of one layer's four GEMMs at M "
        f"{QMM_ROWS}, launches in phase 8's fp32 and bf16 serving runs "
        "(forward) and gradient drives (backward); fused_mlp_* in bf16 at "
        "the flagship "
        "shapes, launches in phase 9's bf16 flagship run; flash launches "
        "count both flagship runs; grouped_matmul_* in bf16, the sum of "
        "one MoE layer's two GEMMs at the serving rows, launches in phase "
        "11's fp32 served runs, its bf16 int8 / int4 served runs (v) / (vi) "
        "and gradient drives; paged_decode_attention "
        "in fp32 at phase 3's pools, launches in phase 12's fp32 legacy "
        "runs; flash_attention_*_mask and _varlen in bf16 at [16, 512, 12, "
        "64], launches in phase 13's bert-base steps and varlen calls)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
