"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out results.json]
                          [--only kernels|conv|serve|obs|moe|ssm|encdec|vlm|mla|tune|shard|
                                  sserve|ep]

Phases, in order; any failure exits nonzero:

1. device   — require CUDA, print the card's name and power limit, set the
              float32/TF32/bf16-reduction flags of every comparison below;
2. build    — compile the hand-written kernels from ``src/repro_torch``;
3. kernels  — each kernel at every shape the serve, flash serve and
              train paths launch it at, against its plain version
              (``kernels/ref.py``) on the same inputs, timed with CUDA
              events beside its plain version and one library call; K1-K5
              rows also print their TFLOP/s and share of the bound (K1 and
              K5 run their large-M design from ``LARGE_M`` rows, K1's by its
              table ``large_m``); K1/K5 rows in the decode design also print
              both launches' CTA counts and structure and a copy floor (one
              ``copy_`` of the factors' bytes, timed the same way: the floor
              of one launch under this method); K2, K3, K4 and the decode
              design of K1/K5 must give the same bits on a second call (K2
              splits nothing; K3/K4's split sum over M and the decode
              design's cluster partials are added in a fixed order);
4. serve    — ``repro_torch.launch.serve.main`` on full-width smollm-360m
              with LRD (16 requests through 8 slots), with the kernels'
              launch counters zeroed before and read after, and its
              telemetry on (``--obs``: phase 68 reads the trace);
5. parity   — one full-width prefill through the kernels against the same
              prefill through the plain versions; 8 greedy tokens each way,
              a parting held to a rounding tie (the plain run's top-2 gap
              below the two runs' largest |logit difference| there);
6. profile  — where a full-width decode step's time goes (wall time,
              device time by kernel, the device's idle share);
6b. decompose — dense full-width smollm-360m (seeded, no LRD) through
              ``core.decompose.apply_lrd`` at Eq.-5 and at Algorithm-1
              ranks, each timed (the paper's decomposition time, Table 2):
              the plan equal to the init-time ``Decomposer`` plan, layer 0
              of each projection's ``u @ v`` against a float64 truncated
              SVD on the CPU, ``randomized_svd`` against ``svd_decompose``
              on one (960, 2560) slice; then the Eq.-5 tree served (8
              requests, 8 slots, K1/K5 launches exact) and held against
              the plain path as in phase 5;
7. train    — ``repro_torch.launch.train.main`` on full-width smollm-360m
              with LRD and sequential freezing, 6 steps of 8 x 256 tokens
              (phases 0,0,1,1,0,0), with the launch counters zeroed before
              and read after every step: exactly 224 K1, 32 K5 and 224 K2 a
              step, 224 K3 at phase 1 and none at phase 0, 224 K4 at phase 0
              and none at phase 1; its telemetry on (``--obs``) and step 2
              (the first at phase 1) profiled (``--profile-steps 2:3``);
68. telemetry — (run right after phase 7) both traces validated with the
              port's validator and read with ``obs_report``: serve — one
              ``request_queued`` / ``request_prefill`` /
              ``request_first_token`` / ``request_retired`` a request, a
              ``serve_step`` a decode forward, ``run_end`` equal to
              ``latency_stats()``, the report's token count the stats'; the
              tok/s, TTFT and latency p50 / p95, and an emit's host µs
              beside a forward's wall; train — 6 ``train_step`` records
              whose losses are the ``on_step`` losses bit for bit, phases
              0,0,1,1,0,0, phase swaps at epochs 1 and 2, partition bytes
              and rank maps ``steps.partition_bytes``'s; the profile
              window's Chrome trace holds K1, K2, K3 and K5 kernels and no
              ``k4_`` kernel (the frozen factor's gradient, read from the
              device side); ``kernel_fallbacks`` empty in both runs (no
              plain path on the card);
8. grads    — one full-width train step's loss and gradients at phases -1,
              0 and 1 through the kernels against the same step through the
              plain versions;
9. train profile — wall time, device time and idle share of one train
              step per phase, with tokens/s and K1, K5, K2, K3 and K4
              device ms apart;
69. autotune — (run right after phase 9) ``python -m
              repro_torch.kernels.autotune`` twice on a fresh table over
              smollm-360m's serve and train geometries (K1/K5 at M 8, 128,
              256, 320, 2048; K2-K4 at 2048; K8 at the 2016-token prefill):
              run 1 measures every entry on this card, run 2 is all cache
              hits; each tuned choice beside the hand-set one, both timed,
              and the predicted time; phase 7's train CLI with
              ``pallas_autotune`` and the table (launches exactly phase 7's,
              losses within LOSS_RTOL of phase 7's, bit for bit where every
              choice is the hand-set one, no fallback); a 2016-token flash
              prefill under the table against the plain path;
70. dry-run — phase 7's step as a meta cell (``launch/dryrun.py``) at
              phases -1 / 0 / 1 against the same step counted on the card:
              argument bytes, FLOPs and bytes equal exactly; the H100
              roofline's step bound beside phase 9's device ms, the meta peak
              beside ``max_memory_allocated``; the dry-run CLI at train_4k
              and decode_32k and ``analysis.report`` over both cells;
71-73. sharded — (run last) two ranks on the one card over gloo
              (``chip_smoke.py --shard-worker``, started by ``python -m
              torch.distributed.run --standalone``), full-width smollm-360m
              at SHARD_LAYERS (8) of its 32 layers with LRD at Eq.-5 ranks
              on phase 7's 8 x 256 batch, a step a cell at learning rate
              SHARD_CHECK_LR: (a) pure data
              parallelism on mesh (2, 1) at phase -1 / 0 / 1, K1-K5 launched
              at M 1024 with K3 = 0 at phase 0 and K4 = 0 at phase 1 (exact
              by shape, each rank), no collective at a frozen leaf's path,
              the sync bytes of phases 0 and 1 below phase -1's and equal to
              what the placements imply; the loss within SHARD_LOSS_RTOL, the
              grad norm, the momentum (the synced gradient) and the update
              of the trainable params (gathered) within SHARD_NORM_RTOL /
              SHARD_MU_RTOL / SHARD_UPDATE_RTOL of one rank's step on the
              same batch and params; (b) the int8 sync on (2, 1) at phases 0
              and 1: K1-K5 at M 1024 exact by shape as in (a), int8 on the
              wire at every trainable path and at no frozen one, the loss
              within SHARD_LOSS_RTOL and the rest within the SHARD_INT8_*
              limits of (a)'s; (c) TP on (1, 2): K1-K5 at v's local columns
              (480 / 160 / 1280), held to one rank's as (a).  Each rank's
              wall and CUDA-event ms and its sync bytes by op and dtype are
              printed; a failed rank fails the phase.  Then a one-rank NCCL
              group takes a control flag where
              ``collectives.control_device`` puts it (and refuses a CPU one);
74-76. sharded serving — (run last) TP-sharded serving on gloo ranks of
              the one card (``chip_smoke.py --serve-worker``, started by
              ``python -m torch.distributed.run --standalone``):
              ``ServeEngine(mesh=(1, N))`` on full-width smollm-360m at
              SSERVE_LAYERS of its layers, LRD at Eq.-5 ranks, params from
              ``steps.init_params(run, "cuda")`` on every rank (the engine
              checks them by digest), 8 requests sharing a 64-token prefix
              through 8 slots, 12 new tokens.  74: (1, 2), bf16 factors,
              the paged pool with the prefix cache (5 KV heads do not
              divide 2: the pool is replicated), then the speculative draft
              (k = 2) with a different rank in every factor group; 75: (1,
              2), the int8 export, analytic then measured (decided on rank
              0); 76: (1, 5), one KV head and three query heads a rank.
              Each rank: K1 / K5 / K6 / K7 launches exact by shape at the
              local columns (PERF.md's prediction), no ``kernel_fallbacks``
              entry, no collective at a param path, its pool bytes (at (1,
              5) a fifth of one rank's), its wall time; rank 0 serves every
              trace on one rank with the same params: greedy tokens
              identical or parting at rounding ties, the first decode step's
              logits within SSERVE_LOGIT_RTOL.  Then K1/K5/K6/K7 rows at the
              local shapes these phases launched, in the kernels line;
77-79. expert parallelism — (run last) four gloo ranks on the one card
              (``chip_smoke.py --ep-worker``, started by ``python -m
              torch.distributed.run --standalone``), full-width OLMoE-1B-7B
              (d 2048, 64 experts of 1024, top-8; LRD at Eq.-5 ranks 512 /
              341), its MoE layer over (1, model) meshes through
              ``collectives.all_to_all``.  77 layer: one layer's MoE forward
              and backward on 4 x 256 bf16 tokens at (1, 2) and (1, 4), at
              the config's capacity 1.25 and at EP_NODROP_CF (no pair
              dropped, checked on the routing): y, aux and the gradients of
              x, the router and the rank's expert factors within
              EP_PLAIN_RTOL of ``moe.moe_ep_plain`` (the one-process N-rank
              version; bit for bit reported), at no drop within EP_ONE_RTOL
              of one rank's ``ep``, and the all_to_all bytes equal to the
              capacities' arithmetic (``moe.ep_exchange_bytes``); 78 train:
              EP_TRAIN_LAYERS of 16 layers, sequential freezing at phases
              -1 / 0 / 1 on (1, 2) and (2, 2), phase 0 on (2, 2) with 2
              microbatches and phase 1 on (1, 2) under ``--remat full``:
              K1-K4 exact by shape at the attention's column blocks (M,
              2048, 512, 1024) each rank (no K3 at phase 0, no K4 at phase
              1; K1 twice under remat), no ``kernel_fallbacks`` entry, no
              collective over data at a frozen leaf, the expert gradients
              synced over data only, the router's momentum the same on
              every rank, the loss and grad norm within EP_LOSS_RTOL /
              EP_NORM_RTOL and rank 0's momentum, leaf by leaf on its
              blocks, within EP_MU_RTOL (router, expert factors, the rest;
              EP_MU_MB_RTOL with 2 microbatches)
              of the one-device step with every MoE layer run by
              ``moe_ep_plain`` over the same mesh; 79 serve: EP_SERVE_LAYERS layers at
              capacity EP_SERVE_CF over (1, 2) with the prefix cache (phase
              74's trace): K1 exact by shape at (M, 2048, 512, 1024), 32
              experts and 8 KV heads a rank (the pool half of one rank's),
              a decode step's experts' outputs all-gathered (gshard), the
              prefill's pairs exchanged; tokens, every agreeing step's and
              the first decode step's logits (the padded vocab's -1e30 tail
              left out) within EP_SERVE_LOGIT_RTOL of one rank's, partings
              only at rounding ties.  Then K1-K4
              rows at the shapes these phases launched, in the kernels line;
9b. rank-adapt train — phase 7 with ``--rank-schedule decay``: the ranks
              shrink at each phase swap (240/120/349 -> 128/90/256 ->
              96/67/128), launches counted per step by name and by shape,
              the partition bytes and ``torch.cuda.memory_allocated()``
              falling at each boundary to what the rank map implies; a
              train step profiled as in phase 9 at each shrunk rank map;
              then one ``--rank-schedule energy`` boundary and its rank map;
10. export serve — the serve CLI with ``--export analytic --export-int8``
              and then ``--export measured --export-int8`` (the rank-quantized
              int8 artifact): the export report (ranks per geometry, merged
              groups; the measured backend's t(r) sweep on this card), and
              exactly 7 x 32 = 224 int8 launches a forward, K7 for every kept
              factor pair and K6 for every group the guard merged, all
              through the serving entries that quantize x in the kernel
              (``int8_linear`` / ``int8_lowrank_linear``), none through the
              int8-operand entries;
11. int8 parity — the int8 trees' last-position prefill logits and greedy
              tokens through K6/K7 against the same run through their plain
              versions, and the gap of native int8 decode to the bf16 round
              trip of the same tree;
12. int8 profile — a decode step of each int8 export, as in phase 6, with
              its device launches, K6 / K7 ms and torch quantizer ops (none)
              a step; then the device launches of one ``ops.int8_apply`` and
              one ``ops.int8_lowrank_apply`` call (at most 3 each);
13. Algorithm-1 train — the training CLI without ``--no-rank-opt`` (ranks
              239/80/256/256), launches counted per step, and a train step
              profiled at phases -1 and 1 as in phase 9;
14. int8 kernels — K6 and K7 at every shape phases 10 launched them at
              (bitwise / 1e-6 against their plain versions), timed as in
              phase 3 beside one library call: the serving entries (beside
              the torch quantizer, ``torch._int_mm`` and the scaling) and
              the int8-operand entries at the same shapes (beside
              ``torch._int_mm``), which no main path launches;
15. flash serve — ``ServeEngine.serve`` on full-width smollm-360m with LRD
              and ``attention_impl="flash"``: 16 Poisson requests of up to
              2016 tokens, every prefill padded to 2016, 32 new tokens each
              in a 2048-token window, through 8 slots; exactly 32 K8
              launches a prefill forward and none a decode forward, K1 and
              K5 as in phase 4;
16. flash parity — one 2016-token prefill's last-position logits, flash
              against the model's default (``"blockwise"``, which falls to
              dense attention at 2016 tokens), and for three prompts 8
              greedy tokens through K8, through K8's plain version on the
              card and blockwise, each pair's logits held together while
              its histories agree;
17. flash prefill profile — wall time, device time by kernel (K8's share,
              K1 and K5 ms) and idle share of one 2016-token prefill, flash
              and blockwise;
18. flash kernels — K8 at every shape phase 15 launched it at, and at
              ragged, non-causal, batched and head-dim-128 shapes, against
              its plain version, timed as in phase 3 beside
              ``F.scaled_dot_product_attention``;
19. designs — both K1/K5 designs (decode and large-M) at M in
              DESIGN_SWEEP_M and on both sides of each geometry's LARGE_M,
              for every train-path geometry and OLMoE's attention (2048,
              512, 2048), against the plain version and timed in turns:
              where the thresholds come from (the LARGE_M each wrapper uses
              is printed, and the worst ratio of the taken design's time to
              the other's); then the decode design under other plans at
              PLAN_ROWS: where decode_plan's choices come from.  Reported
              beside the flash extras, not in the kernels line (no main
              path launches the other design or plans);
20. conv decompose — the paper's Table 2: ``apply_lrd`` of dense
              ResNet-50/101/152 (1000 classes, float32, seeded) at the
              ladder's LRD (Eq. 5) and RankOpt (Algorithm 1) policies, timed;
              the plan equal to the init-time ``Decomposer``'s, Tucker / SVD /
              kept-dense counts, each stage's 3x3 r1 (Eq. 5: 38, 77, 154,
              309), and one 3x3 conv a stage's Tucker-2 error against a
              float64 HOSVD on the CPU;
21. resnet parity — ResNet-50 at 224 x 224, batch 4, card against the
              port's CPU run: dense and Eq.-5 logits, and a train step's loss
              and gradients at phases -1 and 0 (no gradient on u, first,
              last at phase 0); at phase -1 the card's and the CPU's float32
              gradients against the same step in float64 on the CPU;
22. table1 — ResNet-50, 224 x 224, batch 64, float32, over org / lrd /
              rankopt / freeze / combined (and phase 1 of freeze and
              combined): train and inference images/s from the median of 10
              steps, wall and device time, idle share;
23. sequential — 6 steps of ResNet-50 combined at batch 64, phases
              0,0,1,1,0,0, on ``SyntheticClassification(img=224)``: finite
              losses, no gradient on each step's frozen group;
24. table4 — ViT-B/16 (224 x 224, batch 64, 10 classes, float32) with the
              ViT policy over the same ladder.

25. spec serve — (phases 25-28 at 4 of smollm-360m's 32 layers, full
              width) phase 4's 16-request trace with 47 new tokens (prime:
              every k retires mid-chunk), plain and self-speculative at k =
              1, 2, 4 with the draft = the params (acceptance 1.0) and at
              k = 2, 4 with the draft ``draft_rank_map`` derives (fraction
              0.5; its ranks printed): K1/K5 launches exact by M (k draft
              forwards at M = 8 and one verify at M = 8 (k + 1) a step, no
              plain decode), tokens held to the plain run's (a parting must
              be a rounding tie: the top-2 gap below the two runs' largest
              |logit difference| there), tok/s and wall / device ms of a
              speculative step beside a decode step; first, whether K1/K5's
              decode design gives a row the same bits at M = 8 and inside
              M = 16/24/40;
26. prefix serve — ``shared_prefix_trace`` (16 requests, a 1024-token
              prefix, 1-64-token suffixes, 16-position blocks, prompts padded
              to 1088, 32 new tokens) uncached and with the radix prefix
              cache: fewer prefilled tokens, hits in whole blocks, the extend
              step's K1/K5 at M = 1088, tokens held as in phase 25, TTFT p50;
27. int8 KV — ``kv_cache_dtype="int8"`` pools in both ``int8_decode``
              modes: pool bytes exactly (hd + 2) / (2 hd) of bf16's, 8
              teacher-forced decode steps' logits within 5% of the bf16
              pools', phase 4's trace served, a decode step profiled as in
              phase 6;
28. fixed batch — ``ServeEngine(num_slots=0).generate`` on 8 x 128 prompts,
              32 new tokens (prefill K1/K5 at M = 1024, decode at M = 8),
              bf16 and int8 configs, held against the same path through the
              plain versions as in phase 5; 8 teacher-forced steps through an
              int8 ``lm.init_cache`` cache against a bf16 one.

29. moe serve — the serve CLI on full-width OLMoE-1B-7B (16 layers, d 2048,
              64 experts of d_ff 1024, top-8, qk-norm, ``moe_impl="ep"``) with
              LRD at Eq.-5 ranks (attention 512, experts 341), phase 4's
              trace: exactly 64 K1 and no K5 launches a forward, by shape;
              tok/s and the pool bytes;
30. moe parity — a 128-token prefill and an 8-slot decode step (cap2 = 1)
              through the kernels against the plain path with routing
              pinned (``routing``: the plain run replays the kernel run's
              expert ids, in this script only), within PATH_RTOL; the plain
              run unpinned, each routing flip's top-k margin against its
              router-logit difference (a flip wider than twice that fails);
31. moe profile — a decode step as in phase 6, with the experts' ``bmm`` ms;
32. moe train — the training CLI at full width, 6 steps of 8 x 256 tokens,
              phases 0,0,1,1,0,0: exactly 64 K1 and K2 a step, 64 K3 at
              phase 1 only, 64 K4 at phase 0 only, no K5; TF32 off;
33. moe grads — a train step's loss and gradients, kernels against plain,
              routing pinned, at phases -1, 0 and 1 (GRAD_RTOL), and the
              unpinned run's flips;
34. moe train profile — phase 9 on OLMoE, with the experts' ``bmm`` ms and
              ``max_memory_allocated`` per phase;
35. remat — one batch at phase -1 under remat none (twice), full, dots and
              sqrt: loss and gradients bit-identical to none's wherever the
              two none runs agree, K1 64 / 128 / 128 / 176 (the recomputed
              forwards; K2-K4 64 each), peak memory below none's; then
              8 x 1024 tokens' loss and gradients under full (peak memory)
              and the training CLI for one 8 x 1024-token step under
              ``--remat full`` (the ep path at t = 8192).

36-39. xLSTM-350M (24 mLSTM layers, d 1024, 4 heads; Eq.-5 rank 256) and
40-43. Zamba2-1.2B (38 Mamba2 layers in 6 groups of 6 and a tail of 2,
              the shared attention + GELU-FFN block at 2d = 4096 after each
              group; Eq.-5 ranks 682-1365, past the old ceiling of 512), each
              at full width, Zamba2 at full depth and xLSTM at
              SSM_SERVE_LAYERS (6) of its 24 layers: serve — the serve CLI's fixed-batch
              path, 8 x 512-token prompts (two 256-token SSD chunks), 32 new
              tokens, K1 launches exact by shape (Zamba2's xbc_tail at M =
              24 too), no other kernel; parity — 8 greedy tokens and the
              prefill logits through the kernels against the plain
              versions on the card, a parting held to a rounding tie;
              profile — a fixed-batch decode step and the 8 x 512 prefill
              (wall, device, idle, K1 ms); train — the training CLI, 6 steps
              of 8 x 256 at phases 0,0,1,1,0,0 (xLSTM under ``--remat
              full`` at 2 of its 24 layers, a depth cut for the script's
              time limit), K1-K4 launches exact per step, then a step profiled
              at phases 0 and 1 with K1-K4 ms and ``max_memory_allocated``;
              then K1-K4 at r = 513, 2048 and 4096 (the first rank past 512,
              the old ceiling, the ceiling), checked and timed as in phase 3
              beside the kernels line (no main path runs them).

44-49. seamless-m4t-medium (enc-dec: 12 encoder and 12 decoder layers, d
              1024, 16 heads, GELU FFN 4096, vocab 256206, 1024 stub frames)
              at full width and depth; the encoder runs with the kernels off,
              as the reference's.  44 serve — the serve CLI (Eq.-5 ranks 256
              / 409) on the fixed-batch path, 8 x 256 prompts with 8 x 1024
              frames, 32 new tokens: K1 launches exact by shape (10 a decoder
              layer in the prefill, the cross k/v at M = 8 x 1024; 8 a layer a
              decode step), no other kernel; 45 parity — every cross gate set
              to a seeded non-zero value in both runs (at the init's zeros the
              check would not reach cross-attention), prefill logits and 8
              greedy tokens through the kernels against the plain versions on
              the card, a parting held to a rounding tie; 46 flash — the same
              prefill with attention_impl="flash" through the engine: K8
              launches exact (the encoder's non-causal 1024 x 1024, the cross
              blocks' non-causal 256 x 1024, the decoder's causal 256 x 256),
              logits held to K1's and K8's plain versions; 47 profile — a
              decode step, the prefill (blockwise, flash) and the encoder
              alone: wall, device, idle, K1, K8 and cuBLAS ms; 48 train — the
              training CLI at Algorithm-1 ranks (255 / 384), 6 steps of 8 x
              256 tokens with 8 x 1024 frames at phases 0,0,1,1,0,0, K1-K4
              launches exact by shape each step (K2 at M = 8 x 1024 for the
              cross k/v), then a step profiled at phases 0 and 1 with
              ``max_memory_allocated`` and the gradients, gates seeded, against
              the plain versions at phases -1, 0 and 1; 49 — K8 at the flash
              path's shapes held row by row and timed beside SDPA (in the
              kernels line), and K1's decode design at the Algorithm-1 ranks
              beside it (no main path runs them).

50-56. llama-3.2-vision-90b (VLM: d 8192, 64 heads of 128, 8 KV heads,
              SwiGLU 28672, vocab 128256, a tanh-gated cross block over 4096
              stub image tokens after every 4 self layers) at full width,
              depth cut from 100 layers to 1 group (5) to serve and to
              train (the script's time limit); LRD at Eq.-5 ranks 2048 / 455 / 3185, past K1's
              old ceiling of 2048 and K5's of 512.  50 serve — the serve CLI
              on the fixed-batch path, 8 x 256 prompts with 8 x 4096 image
              tokens, 32 new tokens: K1 and K5 launches exact by shape (the
              cross k/v at M = 8 x 4096 in the prefill; a decode step's cross
              blocks project q and wo alone), no other kernel; 51 parity —
              gates seeded, prefill logits and 8 greedy tokens through the
              kernels against the plain versions on the card; 52 flash — the
              prefill with attention_impl="flash": K8 launches exact (8 self
              causal 256 x 256, 2 cross non-causal 256 x 4096, D 128), logits
              held to K1's, K5's and K8's plain versions; 53 profile — a
              decode step and the prefill (blockwise, flash): wall, device,
              idle, K1, K5, K8 and cuBLAS ms, ``max_memory_allocated``; 54
              train — the training CLI, 4 steps of 8 x 256 tokens with 8 x
              4096 stub embeddings at phases 0,0,1,1, K1-K5 launches exact by
              shape each step (no K2 on the cross k/v: the embeddings take no
              gradient; K3 / K4 never at phase 0 / 1); 55 — a step profiled
              at phases -1, 0 and 1 with ``max_memory_allocated``; 56 — the
              gradients, gates seeded, against the plain versions at phases
              -1, 0 and 1; then K8 at the flash path's shapes, and K5 and K1
              at the large dense configs' FFN geometries (qwen3-32b,
              deepseek-coder-33b, qwen2-72b, DeepSeek-V3's dense layers at
              Eq.-5 ranks 2133-3207; on no main path, 0 launches) in the
              kernels line.

57-63. deepseek-v3-671b (MLA and MTP: d 7168, 128 heads, q / kv latents
              1536 / 512, nope / rope / v head dims 128 / 64 / 128, 256
              experts of 2048 top-8 with a shared expert, vocab 129280) at
              full width, depth cut from 61 layers to the 3 dense and 2 MoE
              layers to serve and to the 1 dense layer with the MTP layer to
              train; LRD at Eq.-5 ranks (q_up 722, kv_up 252, wo 2493, FFN
              2580, experts 796, mtp/proj 2389).  57 serve — ``ServeEngine``
              through the scheduler's slot layout, 8 x 256-token prompts, 32
              new tokens: 8 prefills at M = 256, 31 decode steps at M = 8
              (the absorbed decode: no kv_up launch), K1 and K5 exact by
              shape; 58 parity — routing pinned: prefill and decode logits
              through the kernels against the plain versions, the absorbed
              decode against a full forward (moe dense), 8 greedy tokens; 59
              flash — the batched prefill with attention_impl="flash": K8 at
              q/k head dim 192 and v head dim 128, 5 causal 256 x 256
              launches over 128 heads, logits held to the blockwise
              prefill's; 60 speculative — k = 2 and 4, draft = the params,
              moe dense, tokens held to plain decoding's; 61 profile — a
              decode step, the scheduler's and the batched prefill: wall,
              device, idle, K1, K5, K8, cuBLAS and the experts' bmm;
              62 train — the training CLI, 4 steps of 8 x 256 tokens at
              phases 0,0,1,1 with the MTP loss, launches exact by shape (the
              MTP layer's pairs: no K3 at phase 0, no K4 at phase 1); 63 — a
              step profiled at phases -1, 0 and 1 with
              ``max_memory_allocated``, the gradients against the plain
              versions with routing pinned; then K8 at (192, 128) at the
              prefill's shape and five more (2048 x 2048 causal, 256 x 2048
              not, B 2, ragged) beside SDPA in the kernels line.

64-67. The int8 export of xLSTM-350M and Zamba2-1.2B (in the ``ssm``
              group), seamless-m4t-medium (``encdec``) and
              llama-3.2-vision-90b (``vlm``, at its 2 served groups), each
              run on the params its group built (cross gates seeded): the
              analytic int8 export, timed, its serve ranks held to the
              reference's (Zamba2 640-1280, the VLM 384-3072: K7 past its
              old ceiling of 512; every group factorised at full width, so
              K6 is not reached); the fixed-batch serve of 8 x 256 prompts
              (1024 frames / 4096 image tokens a row), 32 new tokens, K7
              launches exact by shape (a decode step's: every factorised
              projection of every layer) and no other kernel; the prefill's
              logits and 8 greedy tokens through K7 against its plain
              version on the card (INT8_PATH_RTOL, identical tokens); the
              gaps to the bf16 round trip of the tree and to the family's
              bf16 serve, reported; a prefill and 5 decode steps profiled
              with K7 ms.  Then K7, both entries, at every shape these
              paths launched (M 8, 24, 2048, 8192, 32768) and at its
              ceiling (4096, 4096, 4096; on no main path) in the kernels
              line.

Phases 20-24 run with TF32 off and the port's seeded init, through plain
PyTorch (cuDNN convs, ``torch.matmul``): the JAX package computes them
outside any Pallas kernel, so no hand-written kernel is on their path.

Phase 3 also holds K1-K5 at the Algorithm-1 training shapes and at the
decay schedule's ranks; the energy boundary's ranks are decided on the
card, and the shapes it launched that phase 3 did not check are checked
and timed after it.  ``--only kernels`` runs phases 1-3, the K6-K8 checks
and phase 19; ``--only conv`` runs phases 1 and 20-24; ``--only serve`` runs
phases 1-3 (at the serve and serving-feature shapes) and 25-28; ``--only
moe`` runs phases 1-3 at the MoE shapes and 29-35; ``--only ssm`` phases
1-3 at the SSM and hybrid shapes, 36-43 and 64-65; ``--only encdec`` phases
1-3 at the enc-dec shapes, 44-49 and 66; ``--only vlm`` phases 1-3 at the
VLM shapes, 50-56, 67 and the large dense configs' rows; ``--only mla``
phases 1-3 at DeepSeek-V3's shapes and 57-63; ``--only obs`` phases 1, 2,
4, 7 and 68 (its kernels line is empty); ``--only tune`` phases 1, 2, 69
and 70 (its kernels line is empty); ``--only shard`` phases 1-3 at the
sharded path's shapes and 71-73; ``--only sserve`` phases 1, 2, 74-76 and
the kernel rows at their shapes; ``--only ep`` phases 1, 2, 77-79 and the
kernel rows at their shapes.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit, and the ``{"kernels": [...]}`` line
comes before that.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# the card's peaks (roofline.H100_SPECS: the data sheet's), each kernel's
# work (roofline.kernel_cost) and the timer (autotune.time_fn: L2 flush,
# sleep kernel, CUDA events, median), shared with the autotuner so a tuned
# µs and a kernel row's µs are one measurement
from repro_torch.analysis.roofline import H100_SPECS, kernel_cost  # noqa: E402
from repro_torch.kernels.autotune import time_fn as cuda_time_ms  # noqa: E402

# Relative tolerances (max |kernel - plain| / max |plain|) of the bf16
# kernels.  K1 rounds t and y at the same points as its plain version, so
# they differ only where float32 sums taken in another order flip a bf16
# rounding: a flip of y costs at most one bf16 ulp of max |y| (2**-7
# relative), a flip of t one ulp of t carried through V (about 2**-8 / sqrt(r)
# relative), so 1e-2 holds both.  K5 also keeps g and u in float32 where the
# plain version rounds each branch to bf16 (two more 2**-9 roundings,
# carried through silu(g) * u).
# K2-K4 round dt (or t) and their output at the same points as their plain
# versions, and split sums over M only add float32 partials in a fixed
# order, so K1's reasoning and bound hold for them.
# K8 is held row by row (``row_rel_err``): the largest over query rows of
# max |kernel - plain| / max |plain| in that row, since in causal attention
# max |plain| over the whole output is row 0's (= v_0) and later rows,
# averaging over many keys, are several times smaller.  K8 rounds p to
# bf16 relative to the running max of each 64-key tile, where its plain
# version takes one max over all keys: each p's rounding moves by up to
# 2**-9 relative, with random signs over the keys, so the float32 outputs
# before their one bf16 rounding differ by well under a bf16 ulp, and the
# rounded ones by at most one ulp of an element: up to 2**-7 = 7.8e-3 of
# the row's max, where that max is a power of two.  1e-2 holds that and
# fails a row a few percent off.
# K6 sums int8 products exactly in int32, so it must equal its plain version
# bit for bit (0).  Every step of K7 is an exact integer sum or one IEEE
# float32 operation in the plain version's order, so it should too; 1e-6
# of max |plain| leaves room for nothing more than a last-bit difference.
# Their serving entries add the quantizer and the scales, each step one IEEE
# float32 operation in the plain version's order: the same bounds.
KERNEL_RTOL = {"lowrank_matmul": 1e-2, "lowrank_gated_ffn": 2e-2, "lowrank_matmul_dx": 1e-2,
               "lowrank_matmul_du": 1e-2, "lowrank_matmul_dv": 1e-2, "int8_matmul": 0.0,
               "int8_lowrank_matmul": 1e-6, "int8_linear": 0.0, "int8_lowrank_linear": 1e-6,
               "flash_attention": 1e-2}
# Bound on the full-width prefill's last-position logits, kernels vs plain,
# relative to max |logit|: the per-call differences above, carried through
# 32 residual layers.
PATH_RTOL = 5e-2
SERVE_ARGV = ["--arch", "smollm-360m", "--lrd", "--slots", "8", "--requests", "16",
              "--rate", "1000", "--prompt-len", "128", "--max-new", "32",
              "--block-size", "16"]
PREFILL_M, DECODE_M = 128, 8  # --prompt-len, --slots
TRAIN_ARGV = ["--arch", "smollm-360m", "--lrd", "--no-rank-opt", "--use-pallas",
              "--freeze", "sequential", "--steps", "6", "--steps-per-epoch", "2",
              "--global-batch", "8", "--seq-len", "256", "--save-every", "1000",
              "--log-every", "1"]
TRAIN_M = 8 * 256  # --global-batch x --seq-len
# in-training rank adaptation on the same run: decay 0.75 at each phase
# swap (steps 2 and 4), and one energy boundary (step 2 of 3)
DECAY_ARGV = TRAIN_ARGV + ["--rank-schedule", "decay"]
ENERGY_ARGV = TRAIN_ARGV + ["--rank-schedule", "energy", "--steps", "3"]
# bound on u @ v of apply_lrd's bf16 factors against a float64 truncated
# SVD of the same bf16 weight, relative to max |W_r|: rounding u and v to
# bf16 (2**-9 relative each) moves an entry of the product by about 2**-9
# of its size, with random signs over r terms, so the largest error over
# the matrix is about 2.5e-3 of its max (a CPU run at these shapes)
DECOMP_RTOL = 1e-2
# launches a train step makes at full width (32 layers): K1 on the 5 plain
# factorised projections forward and the 2 FFN branches recomputed
# backward; K5 once a layer; K2 on all 7 factor pairs; K3 (dU) and K4 (dV)
# on the 7 pairs unless their factor is frozen (u at phase 0, v at phase 1)
TRAIN_LAUNCHES = {"lowrank_matmul": 224, "lowrank_gated_ffn": 32, "lowrank_matmul_dx": 224,
                  "lowrank_matmul_du": {0: 0, 1: 224}, "lowrank_matmul_dv": {0: 224, 1: 0}}
# Bound on each trainable leaf's gradient, kernels vs plain, relative to
# that leaf's max |grad|: the forward differs by up to PATH_RTOL at the
# logits (K5's float32 branches against the plain version's bf16 ones,
# and bf16 rounding flips, through 32 layers), and a gradient is a
# forward activation times a backward cotangent, each carrying that
# difference, so twice PATH_RTOL.  The mean loss over 2048 tokens averages
# the per-token differences: LOSS_RTOL.
GRAD_RTOL = 2 * PATH_RTOL
LOSS_RTOL = 1e-2
# CUDA-event timings a kernel row takes its median of (15: first 50, then
# 30 until a whole run took 1,198 s of its 1,200 on a slow host; the
# timings are ~5% of the script)
KERNEL_ITERS = 15
# The int8 export: the serve CLI's flags, the int8 launches a forward and
# layer (7 projections), and the bound on the int8 trees' prefill logits,
# kernels vs plain versions, relative to max |logit| (K6 and K7 match their
# plain versions bit for bit, so the logits should too)
EXPORTS = ("analytic", "measured")
INT8_PER_LAYER = 7
INT8_PATH_RTOL = 1e-3
# The training CLI at Algorithm-1 ranks (no --no-rank-opt): two steps, one
# at phase 0 and one at phase 1, and the ranks JAX's RankResolver builds
ALG1_ARGV = ["--arch", "smollm-360m", "--lrd", "--use-pallas", "--freeze", "sequential",
             "--steps", "2", "--steps-per-epoch", "1", "--global-batch", "8",
             "--seq-len", "256", "--save-every", "1000", "--log-every", "1"]
ALG1_RANKS = {"wq": 239, "wo": 239, "wk": 80, "wv": 80, "gate": 256, "up": 256, "down": 256}
# The long-prompt flash serve: prompts of up to 2016 tokens, each padded to
# 2016, and 32 new tokens fill SmolLM's 2048-token context
# (max_position_embeddings); 8 slots, 16 requests at 1000 req/s, 16-position
# blocks, the pool fully provisioned
FLASH_PROMPT, FLASH_MAX_LEN, FLASH_NEW = 2016, 2048, 32
# prompt seeds of the flash parity phase's greedy runs
FLASH_PARITY_SEEDS = (1, 4, 5)
FLASH_SERVE_SHAPE = dict(B=1, Sq=FLASH_PROMPT, Sk=FLASH_PROMPT, H=15, KV=5, D=64, causal=True)
# K8 beyond the serve's shape: ragged Sq = Sk, Sq < Sk without the causal
# mask, two batch rows, and D 128 with g = 8 (qwen2-72b's 64 / 8 heads)
# Serving features at full width (phases 25-28).  Speculative: phase 4's
# trace with 47 new tokens (prime, so every k retires mid-chunk), k = 1, 2, 4
# with the draft = params and k = 2, 4 with the derived draft (half the
# Algorithm-1 sweep's rank).  Prefix: 16 requests sharing a 1024-token
# prefix, suffixes of 1-64 tokens, every prompt padded to 1088, 32 new
# tokens.  Fixed batch: 8 x 128 prompts, 32 new tokens.  int8 KV: 8
# teacher-forced decode steps, logits within 5% of max |logit| of the bf16
# cache's (the reference's bound, tests/test_kvcache.py).
SPEC_NEW, SPEC_KS, SPEC_DRAFT_KS, SPEC_FRACTION = 47, (1, 2, 4), (2, 4), 0.5
# phases 25-28 run smollm-360m at full width and an eighth of its depth
# (half until DeepSeek-V3's phases 57-63 joined, a quarter until a whole
# run took 1100 s of its 1200 on a slow host), so the whole script stays
# inside its time limit: their host-bound steps cost time in proportion to
# the layers (each phase's launch checks read the depth from the run)
SERVING_LAYERS = 4
PREFIX_LEN, PREFIX_SUFFIX, PREFIX_PREFILL, PREFIX_NEW = 1024, 64, 1088, 32
FIXED_B, FIXED_T, FIXED_NEW = 8, 128, 32
KV_STEPS, KV_RTOL = 8, 0.05
FLASH_EXTRA = [dict(FLASH_SERVE_SHAPE, Sq=1, Sk=1), dict(FLASH_SERVE_SHAPE, Sq=17, Sk=17),
               dict(FLASH_SERVE_SHAPE, Sq=500, causal=False), dict(FLASH_SERVE_SHAPE, B=2),
               dict(B=1, Sq=512, Sk=512, H=64, KV=8, D=128, causal=True)]


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def row_rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, the largest over rows of the last axis of max
    |got - want| / max |want| in that row)."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(dim=-1).clamp_min(1e-30)
    return diff.max().item(), (diff.amax(dim=-1) / scale).max().item()


def _precision_flags():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    _precision_flags()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"tf32 off, bf16 reduced-precision reduction off, float32 matmul 'highest'")
    return smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {', '.join(sorted(libs))} in {dt:.1f}s -> {build.build_dir()}")
    for name in build.SOURCES:
        for line in (build.build_dir() / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return dt


# (C, r, S) of the factorised projections of full-width smollm-360m with
# LRD at Eq.-5 ranks; gate/up run as K5 forward and as K1 in the FFN
# backward's recompute
PROJ = {"wq/wo": (960, 240, 960), "wk/wv": (960, 120, 320), "gate/up": (960, 349, 2560),
        "down": (2560, 349, 960)}
# the same at the Algorithm-1 ranks of the training CLI
PROJ_ALG1 = {"wq/wo": (960, 239, 960), "wk/wv": (960, 80, 320), "gate/up": (960, 256, 2560),
             "down": (2560, 256, 960)}
# the Eq.-5 train run's ranks after each boundary of --rank-schedule decay
# (JAX's _decay_target: floor(0.75 r), floored to the 128 tile, ranks under
# one tile kept)
PROJ_DECAY = ({"wq/wo": (960, 128, 960), "wk/wv": (960, 90, 320), "gate/up": (960, 256, 2560),
               "down": (2560, 256, 960)},
              {"wq/wo": (960, 96, 960), "wk/wv": (960, 67, 320), "gate/up": (960, 128, 2560),
               "down": (2560, 128, 960)})
# (C, S) of each factorised projection of smollm-360m, by its path's leaf
GEOM = {"wq": (960, 960), "wo": (960, 960), "wk": (960, 320), "wv": (960, 320),
        "gate": (960, 2560), "up": (960, 2560), "down": (2560, 960)}
BWD = ("lowrank_matmul_dx", "lowrank_matmul_du", "lowrank_matmul_dv")
LOWRANK_FWD = ("lowrank_matmul", "lowrank_gated_ffn")
# kernels that must give the same bits on every call (no atomics; K3/K4's
# split sums are added in a fixed order), and K1/K5 rows in their decode
# design (the cluster's partials meet in rank order): repeatable(name, d)
REPEATABLE = ("lowrank_matmul_dx", "lowrank_matmul_du", "lowrank_matmul_dv")
# the M at which both K1/K5 designs are timed, to place LARGE_M; the
# threshold's two sides are added from the wrappers' constants
DESIGN_SWEEP_M = (128, 256, 512, 2016)
# decode rows at which phase 19 times decode_plan's choice against other
# cluster sizes and tile widths
PLAN_ROWS = (("lowrank_matmul", 8, (960, 240, 960)), ("lowrank_matmul", 8, (2048, 512, 2048)),
             ("lowrank_gated_ffn", 8, (960, 349, 2560)))


def large_m(name, d):
    """The M from which K1 (``lowrank_matmul``, by its depth and rank) or K5
    takes its large-M design at ``d``."""
    from repro_torch.kernels import lowrank_ffn, lowrank_matmul

    if name == "lowrank_matmul":
        return lowrank_matmul.large_m(d["C"], d["r"])
    return lowrank_ffn.LARGE_M


def decode_row(name, d) -> bool:
    """Whether a K1/K5 row runs the decode design (M below its LARGE_M)."""
    return name in LOWRANK_FWD and d["M"] < large_m(name, d)


def repeatable(name, d) -> bool:
    return name in REPEATABLE or decode_row(name, d)


def decode_layout(name, d):
    """The decode design's launch at ``d`` (one row block: M <= 128 here):
    (rank-kernel CTAs, out-kernel CTAs, a description of both)."""
    from repro_torch.kernels.lowrank_matmul import decode_plan

    nb = 1 if name == "lowrank_matmul" else 2
    s = d["S"] if nb == 1 else d["F"]
    cs, kc, per, w1, w2 = decode_plan(d["C"], d["r"], s, torch.cuda.get_device_properties(
        0).multi_processor_count, nb=nb)
    from repro_torch.kernels.lowrank_matmul import decode_kp

    tiles, cols = nb * -(-d["r"] // w1), -(-s // w2)
    pieces = -(-(-(-d["r"] // 16) * 16) // decode_kp(d["r"]))
    return cs * tiles, cols, (f"rank kernel {cs * tiles} CTAs ({tiles} tiles of {w1} rank "
                              f"columns x clusters of {cs} splitting C in {per} x {kc} rows), "
                              f"out kernel {cols} CTAs ({w2} columns each"
                              + (f", the rank in {pieces} pieces of {decode_kp(d['r'])}"
                                 if pieces > 1 else "") + ")")


def kernel_shapes(serve_only: bool = False):
    """(name, dims) of every K1-K5 call on the serve, flash serve, serving
    features' and train paths (``serve_only``: the serve and serving
    features' only)."""
    out = []
    for m in (DECODE_M, PREFILL_M) + (() if serve_only else (FLASH_PROMPT,)):
        for proj in ("wq/wo", "wk/wv", "down"):
            c, r, s = PROJ[proj]
            out.append(("lowrank_matmul", dict(M=m, C=c, r=r, S=s)))
        out.append(("lowrank_gated_ffn", dict(M=m, C=960, r=349, F=2560)))
    out += serving_shapes()
    if serve_only:
        return out
    # the decay run trains at its first shrunk map in phase 1 (no K4) and
    # at its second in phase 0 (no K3)
    for proj, bwd in ((PROJ, BWD), (PROJ_ALG1, BWD),
                      (PROJ_DECAY[0], ("lowrank_matmul_dx", "lowrank_matmul_du")),
                      (PROJ_DECAY[1], ("lowrank_matmul_dx", "lowrank_matmul_dv"))):
        for c, r, s in proj.values():
            out.append(("lowrank_matmul", dict(M=TRAIN_M, C=c, r=r, S=s)))
        c, r, f = proj["gate/up"]
        out.append(("lowrank_gated_ffn", dict(M=TRAIN_M, C=c, r=r, F=f)))
        for name in bwd:
            for c, r, s in proj.values():
                out.append((name, dict(M=TRAIN_M, C=c, r=r, S=s)))
    out += shard_kernel_shapes()
    unique = []  # a shape two rank sets share is checked once
    for name, d in out:
        if (name, d) not in unique:
            unique.append((name, d))
    return unique


def kernel_case(name, d, gen):
    """Inputs, kernel, plain version, library call, bytes and flops."""
    from repro_torch.kernels import lowrank_bwd as kb
    from repro_torch.kernels import ref
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    m, c, r = d["M"], d["C"], d["r"]
    x = rnd(m, c)
    if name == "lowrank_gated_ffn":
        f = d["F"]
        gu, gv = rnd(c, r, scale=c ** -0.5), rnd(r, f, scale=r ** -0.5)
        uu, uv = rnd(c, r, scale=c ** -0.5), rnd(r, f, scale=r ** -0.5)
        args = (x, gu, gv, uu, uv)
        return dict(args=args, kernel=lambda: lowrank_gated_ffn(*args),
                    plain=lambda: ref.lowrank_gated_ffn_ref(*args),
                    library=lambda: F.silu(torch.matmul(torch.matmul(x, gu), gv))
                    * torch.matmul(torch.matmul(x, uu), uv),
                    flops=kernel_cost(name, d)[0], bytes=kernel_cost(name, d)[1])
    s = d["S"]
    u, v = rnd(c, r, scale=c ** -0.5), rnd(r, s, scale=r ** -0.5)
    flops, bytes_ = kernel_cost(name, d)
    if name == "lowrank_matmul":
        return dict(args=(x, u, v), kernel=lambda: lowrank_matmul(x, u, v),
                    plain=lambda: ref.lowrank_matmul_ref(x, u, v),
                    library=lambda: torch.matmul(torch.matmul(x, u), v),
                    bytes=bytes_, flops=flops)
    dy = rnd(m, s)
    if name == "lowrank_matmul_dx":
        return dict(kernel=lambda: kb.lowrank_matmul_dx(dy, u, v),
                    plain=lambda: ref.lowrank_matmul_dx_ref(dy, u, v),
                    library=lambda: torch.matmul(torch.matmul(dy, v.T), u.T),
                    bytes=bytes_, flops=flops)
    if name == "lowrank_matmul_du":
        return dict(kernel=lambda: kb.lowrank_matmul_du(x, dy, v),
                    plain=lambda: ref.lowrank_matmul_du_ref(x, dy, v),
                    library=lambda: torch.matmul(x.T, torch.matmul(dy, v.T)),
                    bytes=bytes_, flops=flops)
    return dict(kernel=lambda: kb.lowrank_matmul_dv(x, u, dy),
                plain=lambda: ref.lowrank_matmul_dv_ref(x, u, dy),
                library=lambda: torch.matmul(torch.matmul(x, u).T, dy),
                bytes=bytes_, flops=flops)


def _pad(a, rows: int, cols: int):
    """``a`` zero-padded to at least ``rows`` rows and ``cols`` columns."""
    return F.pad(a, (0, max(0, cols - a.shape[1]), 0, max(0, rows - a.shape[0])))


# the int8 kernels' serving entries and their int8-operand twins
INT8_FUSED = {"int8_linear": "int8_matmul", "int8_lowrank_linear": "int8_lowrank_matmul"}


def int8_kernel_case(name, d, gen):
    """Inputs, kernel, plain version, library call, bytes and int8 operations
    of K6 (``int8_matmul``, serving entry ``int8_linear``) or K7
    (``int8_lowrank_matmul``, ``int8_lowrank_linear``) at ``d``.

    The library yardstick is ``torch._int_mm``, whose CUDA path wants more
    than 16 rows and a depth and width that are multiples of 8: its operands
    are zero-padded to that once, outside the timing (zero rows and ranks
    add nothing), and the result is sliced back.  For a serving entry the
    yardstick also quantizes x with the torch quantizer (into the padded
    buffer) and applies the scales, as the port did before its kernels
    took them in."""
    from repro_torch.kernels import int8_matmul as k8
    from repro_torch.kernels import ref

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)

    def scales(n):
        return (torch.rand((1, n), generator=gen, device="cuda") + 0.5) * 1e-2

    def up8(n):
        return -(-n // 8) * 8

    m, c, s = d["M"], d["C"], d["S"]
    fused = name in INT8_FUSED
    if fused:  # x as the serve path hands it over: bf16 activations
        x = torch.randn((m, c), generator=gen, device="cuda").to(torch.bfloat16)
        xp = torch.zeros((max(32, m), up8(c)), dtype=torch.int8, device="cuda")
    else:
        x = i8(m, c)
        xp = _pad(x, 32, up8(c))

    def x_q():  # the yardstick's quantizer: torch ops into the padded buffer
        q, xs = ref.quantize_rowwise(x)
        xp[:m, :c].copy_(q)
        return xs

    ops, bytes_ = kernel_cost(name, d)
    if name in ("int8_matmul", "int8_linear"):
        w = i8(c, s)
        wp = _pad(w, up8(c), up8(s))
        if not fused:
            return dict(kernel=lambda: k8.int8_matmul(x, w),
                        plain=lambda: ref.int8_matmul_ref(x, w),
                        library=lambda: torch._int_mm(xp, wp)[:m, :s],
                        bytes=bytes_, ops=ops)
        ws = scales(s)

        def library():
            xs = x_q()
            return (torch._int_mm(xp, wp)[:m, :s].float() * xs * ws).to(x.dtype)

        return dict(kernel=lambda: k8.int8_linear(x, w, ws),
                    plain=lambda: ref.int8_linear_ref(x, w, ws), library=library,
                    bytes=bytes_, ops=ops)
    r = d["r"]
    u, us, v, vs = i8(c, r), scales(r), i8(r, s), scales(s)
    up_, usp, vp = _pad(u, up8(c), up8(r)), _pad(us, 1, up8(r)), _pad(v, up8(r), up8(s))
    vsp = _pad(vs, 1, up8(s))

    def lowrank():  # the same algebra around two library products
        t = torch._int_mm(xp, up_).float() * usp
        ts = torch.clamp(torch.amax(torch.abs(t), dim=1, keepdim=True), min=1e-8) / 127.0
        tq = torch.clamp(torch.round(t / ts), -127, 127).to(torch.int8)
        return (torch._int_mm(tq, vp).float() * ts * vsp)[:m, :s]

    def library():
        xs = x_q()
        return (lowrank() * xs).to(x.dtype)

    args = (x, u, us, v, vs)
    kernel = k8.int8_lowrank_linear if fused else k8.int8_lowrank_matmul
    plain = ref.int8_lowrank_linear_ref if fused else ref.int8_lowrank_matmul_ref
    return dict(kernel=lambda: kernel(*args), plain=lambda: plain(*args),
                library=library if fused else lowrank, bytes=bytes_, ops=ops)


def check_and_time(name, d, case, iters, flush, peak):
    """Hold a kernel against its plain version, then time kernel, plain
    version and library call; returns the kernel's row."""
    got = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    err, rel = case.get("err", rel_err)(got, want)
    _, rel_all = rel_err(got, want)
    rtol = KERNEL_RTOL[name]
    if not math.isfinite(err) or rel > rtol or (rtol == 0 and not torch.equal(got, want)):
        raise AssertionError(f"{name} {d}: max_abs_err {err:.3e}, relative error {rel:.3e} "
                             f"> {rtol}")
    if repeatable(name, d) and not torch.equal(case["kernel"](), got):
        raise AssertionError(f"{name} {d}: a second call on the same inputs gave other bits")
    ms = cuda_time_ms(case["kernel"], iters, flush)
    plain_ms = cuda_time_ms(case["plain"], iters, flush)
    try:
        lib_ms = cuda_time_ms(case["library"], iters, flush)
    except RuntimeError as e:  # a shape the library call does not take
        log(f"[kernels] {name} {d}: library call not timed ({str(e).splitlines()[0]})")
        lib_ms = None
    t_bytes = case["bytes"] / H100_SPECS.hbm_bw * 1e3
    t_ops = case["ops"] / peak * 1e3
    row = dict(name=name, shape=d, max_abs_err=err, rel_err=rel, rel_err_of_max=rel_all,
               rtol=rtol, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               tflops=case["ops"] / ms * 1e-9)
    row["bound_share"] = row["bound_ms"] / ms
    decode = ""
    if decode_row(name, d):
        # one copy_ of the factors' bytes, timed the same way: the floor of
        # one launch under this method
        n = sum(a.numel() for a in case["args"][1:])
        src = torch.empty(n, dtype=torch.bfloat16, device="cuda")
        dst = torch.empty_like(src)
        row["copy_ms"] = cuda_time_ms(lambda: dst.copy_(src), iters, flush)
        row["ctas"], row["out_ctas"], layout = decode_layout(name, d)
        decode = (f"; decode design: {layout}; copy floor {row['copy_ms'] * 1e3:.1f}us "
                  f"(one copy_ of its factors' bytes)")
    log(f"[kernels] {name} {d}: err {err:.3e} (rel {rel:.2e}"
        + (f" by row, {rel_all:.2e} of max |plain|" if "err" in case else "") + "), kernel "
        f"{ms * 1e3:.1f}us, plain {plain_ms * 1e3:.1f}us, library "
        + (f"{lib_ms * 1e3:.1f}us" if lib_ms is not None else "n/a")
        + f", bound {row['bound_ms'] * 1e3:.2f}us ({row['bound_by']})"
        + (f"; {row['tflops']:.1f} TFLOP/s, {row['bound_share']:.1%} of the bound"
           if name in LOWRANK_FWD + BWD else "")
        + ("; bitwise repeatable" if repeatable(name, d) else "") + decode)
    return row


def _flush_buffer():
    return torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2


def phase_kernels(shapes=None, iters: int = KERNEL_ITERS):
    """K1-K5 at ``shapes`` ((name, dims) pairs; every main-path shape known
    before the run by default)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = _flush_buffer()
    rows = []
    for name, d in kernel_shapes() if shapes is None else shapes:
        case = kernel_case(name, d, gen)
        case["ops"] = case.pop("flops")
        rows.append(check_and_time(name, d, case, iters, flush, H100_SPECS.peak_flops))
    zero_counts()  # launches made to compare and time are not the main path's
    return rows


def phase_designs(iters: int = KERNEL_ITERS):
    """Both K1/K5 designs (decode and large-M, through the wrappers'
    ``_launch``) against the plain version and timed, at DESIGN_SWEEP_M and
    on both sides of each wrapper's LARGE_M, for every K1 geometry of the
    train paths and OLMoE's attention, and K5 at both rank sets; then the
    decode design under other plans at three decode rows (PLAN_ROWS: where
    decode_plan's choices come from).  Reported beside ``flash_extra``, not
    in the kernels line: no main path launches these shapes."""
    from repro_torch.kernels import lowrank_ffn as k5m
    from repro_torch.kernels import lowrank_matmul as k1m
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = _flush_buffer()

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def case(name, m, c, r, s_):
        x = rnd(m, c)
        if name == "lowrank_matmul":
            return (x, rnd(c, r, scale=c ** -0.5), rnd(r, s_, scale=r ** -0.5)), k1m, \
                ref.lowrank_matmul_ref
        return (x, rnd(c, r, scale=c ** -0.5), rnd(r, s_, scale=r ** -0.5),
                rnd(c, r, scale=c ** -0.5), rnd(r, s_, scale=r ** -0.5)), k5m, \
            ref.lowrank_gated_ffn_ref

    log(f"[designs] LARGE_M: lowrank_matmul (K1) {k1m.LARGE_M_WIDE_C} where C >= 2048, "
        f"{k1m.LARGE_M_LOW_RANK} where r <= 128, else {k1m.LARGE_M}; lowrank_gated_ffn (K5) "
        f"{k5m.LARGE_M}")
    geoms = sorted(set(PROJ.values()) | set(PROJ_ALG1.values())
                   | {(MOE_ATTN["C"], MOE_ATTN["r"], MOE_ATTN["S"])})
    points = []  # (name, M, geometry): DESIGN_SWEEP_M and each geometry's LARGE_M - 1, LARGE_M
    for name, cases in (("lowrank_matmul", geoms),
                        ("lowrank_gated_ffn", sorted({PROJ["gate/up"], PROJ_ALG1["gate/up"]}))):
        for c, r, s_ in cases:
            lm = large_m(name, dict(C=c, r=r))
            points += [(name, m, (c, r, s_)) for m in sorted(set(DESIGN_SWEEP_M) | {lm - 1, lm})]
    out = []
    for name, m, (c, r, s_) in sorted(points, key=lambda p: (p[0] != "lowrank_matmul", p[1], p[2])):
        lm = large_m(name, dict(C=c, r=r))
        args, mod, plain = case(name, m, c, r, s_)
        want = plain(*args)
        row = dict(name=name, M=m, C=c, r=r, S=s_, large_m=lm)
        fns = {}
        for design in ("decode", "large"):
            fns[design] = fn = lambda large=design == "large": mod._launch(*args, large=large)
            got = fn()
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            if not math.isfinite(err) or rel > KERNEL_RTOL[name]:
                raise AssertionError(f"designs: {name} {design} at M {m}, ({c}, {r}, "
                                     f"{s_}): relative error {rel:.3e} > "
                                     f"{KERNEL_RTOL[name]}")
            row[design] = dict(max_abs_err=err, rel_err=rel)
        # in turns (decode, large, large, decode), each design's the mean of its two
        ts = [cuda_time_ms(fns[dn], iters, flush)
              for dn in ("decode", "large", "large", "decode")]
        row["decode"]["ms"], row["large"]["ms"] = (ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2
        taken = "large" if m >= lm else "decode"
        other = "decode" if taken == "large" else "large"
        row["taken_over_other"] = row[taken]["ms"] / row[other]["ms"]
        log(f"[designs] {name} M {m} ({c}, {r}, {s_}): decode "
            f"{row['decode']['ms'] * 1e3:.1f}us (rel {row['decode']['rel_err']:.1e}), "
            f"large {row['large']['ms'] * 1e3:.1f}us (rel "
            f"{row['large']['rel_err']:.1e}); the wrapper takes {taken} (LARGE_M {lm}), "
            f"{row['taken_over_other']:.2f}x the other's time")
        out.append(row)
    worst = max(out, key=lambda row: row["taken_over_other"])
    log(f"[designs] the wrapper's design takes at most {worst['taken_over_other']:.2f}x the "
        f"other's time over the sweep ({worst['name']} M {worst['M']}, ({worst['C']}, "
        f"{worst['r']}, {worst['S']}))")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = []
    for name, m, (c, r, s_) in PLAN_ROWS:
        args, mod, _ = case(name, m, c, r, s_)
        nb = 1 if name == "lowrank_matmul" else 2
        cs0, kc0, per0, w10, w20 = k1m.decode_plan(c, r, s_, sms, nb=nb)
        variants = {(cs0, kc0, per0, w1, w2) for w2 in (8, w20)
                    for w1 in (max(8, w10 // 16 * 8), w10, min(64, 2 * w10))}
        for cs in (2, 8):  # other cluster sizes at the plan's widths
            kc = -(-c // cs // 16) * 16
            if kc <= k1m.KC_MAX:
                variants.add((-(-c // kc), kc, 1, w10, w20))
        for plan in sorted(variants):
            ms = cuda_time_ms(lambda: mod._launch(*args, large=False, plan=plan), iters, flush)
            ctas = plan[0] * nb * -(-r // plan[3])
            tag = " (decode_plan)" if plan == (cs0, kc0, per0, w10, w20) else ""
            log(f"[plans] {name} M {m} ({c}, {r}, {s_}) plan (cs, kc, per, w1, w2) {plan}{tag}: "
                f"{ms * 1e3:.1f}us, rank kernel {ctas} CTAs, out kernel {-(-s_ // plan[4])}")
            plans.append(dict(name=name, M=m, C=c, r=r, S=s_, plan=plan, ms=ms))
    zero_counts()
    return dict(sweep=out, plans=plans)


def lowrank_device_ms(by_name):
    """(K1 ms, K5 ms) of a profile's device time by kernel name, both
    designs: the decode design's two phases are ``lowrank_*_rank_kernel``
    and ``lowrank_*_out_kernel``, the large-M design ``lowrank_*_large_kernel``."""
    def of(op):
        return sum(ms for n, ms in by_name.items()
                   if any(f"{op}_{k}_kernel" in n for k in ("rank", "out", "large")))
    return of("lowrank_matmul"), of("lowrank_ffn")


def bwd_device_ms(by_name):
    """(K2 ms, K3 ms, K4 ms) of a profile's device time by kernel name:
    K2's launches are named ``bwd::k2_*``, K3's ``bwd::k3_*`` and K4's
    ``bwd::k4_*`` (csrc/lowrank_bwd.cu)."""
    return tuple(sum(ms for n, ms in by_name.items() if key in n)
                 for key in ("bwd::k2_", "bwd::k3_", "bwd::k4_"))


def phase_int8_kernels(shapes, iters: int = KERNEL_ITERS):
    """K6 and K7 at every (M, C[, r], S) the export serve runs launched:
    the serving entry there, then its int8-operand twin at the same shape."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = _flush_buffer()
    rows = []
    for fused, key in shapes:
        for name in (fused, INT8_FUSED[fused]):
            d = (dict(M=key[0], C=key[1], S=key[2]) if name in ("int8_matmul", "int8_linear")
                 else dict(M=key[0], C=key[1], r=key[2], S=key[3]))
            rows.append(check_and_time(name, d, int8_kernel_case(name, d, gen), iters, flush,
                                       H100_SPECS.int8_flops))
    zero_counts()
    return rows


def int8_device_ms(by_name):
    """(K6 ms, K7 ms) of a profile's device time by kernel name: K6 is
    ``i8::k6_kernel``, K7 ``i8::k7_rank_kernel`` and ``i8::k7_out_kernel``
    (csrc/int8_matmul.cu)."""
    return tuple(sum(ms for n, ms in by_name.items() if any(k in n for k in keys))
                 for keys in (("i8::k6_kernel",), ("i8::k7_rank_kernel", "i8::k7_out_kernel")))


def phase_int8_launches():
    """The device launches of one ``ops.int8_apply`` and one
    ``ops.int8_lowrank_apply`` call at decode (M = 8, bf16 x) on random int8
    leaves of the wq / wo geometry (C 960, S 960, r 128): the distinct
    device operations (kernels, memsets, copies) the profiler sees over 20
    calls, at most 3 each."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((DECODE_M, 960), generator=gen, device="cuda").to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (960, 960), generator=gen, device="cuda",
                        dtype=torch.int32).to(torch.int8)
    ws = (torch.rand((1, 960), generator=gen, device="cuda") + 0.5) * 1e-2
    u_q, us, v_q, vs = w_q[:, :128].contiguous(), ws[:, :128].contiguous(), w_q[:128], ws
    calls = {"int8_apply": lambda: ops.int8_apply(x, w_q, ws, use_kernel=True),
             "int8_lowrank_apply": lambda: ops.int8_lowrank_apply(x, u_q, us, v_q, vs,
                                                                  use_kernel=True)}
    out, reps = {}, 20
    def run(fn):
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        prof = profiled(lambda: run(fn))
        # the distinct device operations a call runs (the profiler can drop
        # some of a run's events, so they are not counted one by one); any
        # other kernel, memset or copy would show here
        names = sorted({ev.name() for ev in device_events(prof)})
        out[name] = dict(launches=len(names), kernels=names)
        if not names or len(names) > 3:
            raise AssertionError(f"int8 launches: ops.{name} runs {len(names)} distinct device "
                                 f"operations a call, want 1 to 3: {names}")
    zero_counts()
    log(f"[int8 launches] one decode call (M {DECODE_M}, bf16 x): ops.int8_apply "
        f"{out['int8_apply']['launches']} device launches a call (parent: ~16), "
        f"ops.int8_lowrank_apply {out['int8_lowrank_apply']['launches']} (parent: ~13): "
        + "; ".join(f"{k}: {', '.join(n[:48] for n in v['kernels'])}" for k, v in out.items()))
    return out


def wrappers():
    """name -> kernel wrapper (each carries ``launches`` and
    ``launches_by_shape``)."""
    from repro_torch.analysis.cost import kernel_wrappers

    return kernel_wrappers()


def zero_counts():
    for fn in wrappers().values():
        fn.launches = 0
        fn.launches_by_shape.clear()


def counts_by_shape():
    return {name: dict(fn.launches_by_shape) for name, fn in wrappers().items()}


# K8's ``launches_by_shape`` key; a shape dict without "Dv" has Dv = D
FLASH_KEYS = ("B", "Sq", "Sk", "H", "KV", "D", "Dv", "causal")


def flash_dims(key):
    """A K8 row's shape dict from its launch key."""
    return dict(zip(FLASH_KEYS, key))


def shape_key(name, d):
    """The wrapper's ``launches_by_shape`` key of a kernel row's shape."""
    if name == "lowrank_gated_ffn":
        return d["M"], d["C"], d["r"], d["r"], d["F"]
    if name in ("int8_matmul", "int8_linear"):
        return d["M"], d["C"], d["S"]
    if name == "flash_attention":
        return tuple(d.get(k, d["D"]) if k == "Dv" else d[k] for k in FLASH_KEYS)
    return d["M"], d["C"], d["r"], d["S"]


@contextlib.contextmanager
def telemetry_capture():
    """A fresh default metrics registry and a fallback capture for one run:
    yields ``(registry, fallbacks)``."""
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry, set_default_registry

    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        with ops.capture_fallbacks() as sink:
            yield reg, sink
    finally:
        set_default_registry(prev)


def phase_serve(obs_dir: Path):
    """Phase 4, with the serve CLI's telemetry on (``--obs``, events in
    ``obs_dir``); phase 68 reads the trace."""
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul
    from repro_torch.launch import serve

    zero_counts()
    with telemetry_capture() as (reg, fallbacks):
        t0 = time.perf_counter()
        engine, outs = serve.main(SERVE_ARGV + ["--obs", "--obs-dir", str(obs_dir)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    k1, k5 = lowrank_matmul.launches, lowrank_gated_ffn.launches
    by_shape = counts_by_shape()
    sched = engine.scheduler
    fwd = sched.forward_stats
    n_fwd = fwd["prefill"] + fwd["decode"]
    n_layers = engine.run.model.num_layers
    if len(outs) != 16 or any(len(o) != 32 for o in outs):
        raise AssertionError(f"serve: want 16 requests x 32 tokens, got "
                             f"{[len(o) for o in outs]}")
    if fwd["nonfinite"]:
        raise AssertionError(f"serve: {fwd['nonfinite']} forwards with non-finite logits")
    if n_fwd == 0 or k1 != 5 * n_layers * n_fwd or k5 != n_layers * n_fwd:
        raise AssertionError(f"serve: {n_fwd} forwards but {k1} K1 / {k5} K5 launches "
                             f"(want {5 * n_layers} / {n_layers} per forward)")
    stats = sched.latency_stats()
    log(f"[serve] {len(outs)} requests, {int(stats['generated_tokens'])} tokens, "
        f"{stats['tok_per_s']:.1f} tok/s on {torch.cuda.get_device_name(0)}; "
        f"{fwd['prefill']} prefill + {fwd['decode']} decode forwards; "
        f"{k1} K1 + {k5} K5 launches = {k1 // n_fwd} + {k5 // n_fwd} per forward; "
        f"{dt:.1f}s incl. init")
    return engine, by_shape, dict(fwd=dict(fwd), k1=k1, k5=k5, stats=stats, wall_s=dt,
                                  n_layers=n_layers, events=str(obs_dir / "events.jsonl"),
                                  registry=reg.snapshot(), fallbacks=list(fallbacks))


def device_events(prof):
    """The profile's raw device-side events (kernels, memcpy, memset):
    building its Python event tree takes minutes for a step of ~10^5
    launches (an xLSTM train step)."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA]


PROFILE_TRIES = 3


def profiled(run, record_shapes: bool = False):
    """``torch.profiler`` (host and device activity) over ``run()``, which
    synchronises the device before it returns.  CUPTI can hand back a
    session with none of its device records; such a session says nothing
    of what ran, so it is taken again, up to PROFILE_TRIES times, and the
    last one is returned whatever it holds."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=record_shapes) as prof:
            run()
        if device_events(prof):
            break
    return prof


def device_ms_by_kernel(prof, steps: int):
    """Device time per call by kernel name, from the profiler's device-side
    events only (kernels, memcpy, memset; the CPU ops that launched them
    carry the same time).  Each event counts only the time after the
    events that started before it ended: a kernel launched as a
    programmatic dependent (K3/K4's later launches) starts while the one
    before it runs and waits, and that overlap is counted once, so the sum
    is the time the device was busy."""
    evs = sorted((ev.start_ns(), ev.end_ns(), ev.name()) for ev in device_events(prof))
    by_name, busy_until = {}, float("-inf")
    for start, end, name in evs:
        ms = max(0.0, end - max(start, busy_until)) / steps / 1e6
        busy_until = max(busy_until, end)
        by_name[name] = by_name.get(name, 0.0) + ms
    return by_name


def phase_profile(engine, steps: int = 5, label: str = "decode step", int8: bool = False,
                  moe: bool = False):
    """Where a full-width decode step's time goes: wall time per step (host
    clock around synchronised steps), device time per step by kernel
    (``torch.profiler``), K1 and K5 ms (both launches of their decode
    design), and the device's idle share of the step; for an int8 tree also
    its device launches, K6 / K7 ms and torch quantizer ops a step (none may
    run); for a MoE model the experts' ``bmm`` ms."""
    from repro_torch.launch import steps as steps_mod

    sched = engine.scheduler
    step = steps_mod.build_serve_step(engine.run)
    # all slots at position 0 of the sink block: the step's fixed shapes
    tokens = torch.zeros((sched.num_slots, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros((sched.num_slots,), dtype=torch.int32, device="cuda")
    step(engine.params, sched.cache, tokens, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(engine.params, sched.cache, tokens, pos)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3

    def run():
        for _ in range(steps):
            step(engine.params, sched.cache, tokens, pos)
        torch.cuda.synchronize()

    prof = profiled(run, record_shapes=moe)
    by_name = device_ms_by_kernel(prof, steps)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    k1_ms, k5_ms = lowrank_device_ms(by_name)
    out = dict(wall_ms=wall_ms, device_ms=device_ms if device_ms else None,
               idle_share=(1 - device_ms / wall_ms) if device_ms else None,
               k1_ms=k1_ms, k5_ms=k5_ms, top=[dict(name=k[:80], ms=v) for k, v in top])
    shown = (f"K1 {k1_ms:.2f} ms, K5 {k5_ms:.2f} ms; top: "
             + ", ".join(f"{k[:40]} {v * 1e3:.0f}us" for k, v in top[:5]))
    extra = ""
    if int8:
        from torch.autograd import DeviceType

        out["device_launches"] = sum(1 for ev in prof.events()
                                     if ev.device_type == DeviceType.CUDA) / steps
        # the torch quantizer's mark: no other op of a decode step rounds
        out["quantizer_ops"] = sum(1 for ev in prof.events()
                                   if ev.device_type == DeviceType.CPU
                                   and ev.name == "aten::round") / steps
        out["k6_ms"], out["k7_ms"] = int8_device_ms(by_name)
        extra = (f"; {out['device_launches']:.0f} device launches a step, K6 "
                 f"{out['k6_ms']:.2f} ms, K7 {out['k7_ms']:.2f} ms, torch quantizer ops "
                 f"(aten::round) {out['quantizer_ops']:.0f}")
        if out["quantizer_ops"]:
            raise AssertionError(f"{label}: {out['quantizer_ops']} torch quantizer ops a step")
    if moe:
        out["expert_bmm_ms"] = expert_bmm_ms(prof, steps)
        extra = f"; experts' bmm {out['expert_bmm_ms']:.2f} ms"
    log(f"[profile] {label} ({sched.num_slots} slots, {engine.run.model.num_layers} layers): "
        f"wall {wall_ms:.2f} ms, device "
        + (f"{device_ms:.2f} ms, idle {out['idle_share']:.1%}; {shown}"
           if device_ms else "time not measured (profiler saw no device events)") + extra)
    return out


def phase_parity(engine):
    import dataclasses

    from repro_torch.launch import steps

    run = engine.run
    plain_run = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, use_pallas_kernel=False))
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, run.model.vocab_size, (1, PREFILL_M), generator=gen,
                           device="cuda", dtype=torch.int32)
    last = torch.tensor([PREFILL_M - 1], device="cuda")
    got, _ = steps.build_slot_prefill_step(run)(engine.params, {"tokens": tokens}, last)
    want, _ = steps.build_slot_prefill_step(plain_run)(engine.params, {"tokens": tokens}, last)
    err, rel = rel_err(got, want)
    if not torch.isfinite(got).all() or rel > PATH_RTOL:
        raise AssertionError(f"parity: last-position logits differ by {err:.3e} "
                             f"({rel:.3e} of max |logit|) > {PATH_RTOL}")
    # greedy agreement of a short decode: 8 tokens each way through a fresh
    # one-slot engine, with the logits each token was picked from; where the
    # tokens part, the plain path's top-2 gap there must be below the two
    # runs' largest |logit difference| (a rounding tie), or the phase fails
    from repro_torch.serving import ServeConfig, ServeEngine

    prompt = tokens[0, :64].cpu().numpy()
    toks, logits = [], []
    for r in (run, plain_run):
        eng = ServeEngine(r, engine.params, device="cuda",
                          config=ServeConfig(num_slots=1, max_len=80, prefill_len=64))
        rec = _record_logits(eng.scheduler)
        out = eng.serve([{"prompt": prompt, "max_new": 8}])[0]
        toks.append(out.tokens.tolist())
        logits.append(rec[out.rid])
    cmp = _compare_greedy([toks[1]], [logits[1]], [toks[0]], [logits[0]], "parity")
    agree = next((p["token"] for p in cmp["parted"]), 8)
    log(f"[parity] prefill last-position logits: max_abs_diff {err:.3e} "
        f"({rel:.3e} of max |logit| {want.abs().max().item():.3f}; bound {PATH_RTOL}); "
        f"greedy decode agreement {agree}/8 (kernels {toks[0]} vs plain {toks[1]}); "
        + ("".join(f"parts at token {p['token']}: plain top-2 gap {p['gap']:.3e} < card-vs-"
                   f"plain max |logit diff| {p['max_abs_diff']:.3e} there, a rounding tie"
                   for p in cmp["parted"]) or "no parting"))
    return dict(max_abs_diff=err, rel=rel, agree=agree, compare=cmp)


def _at(tree, path: str):
    """The subtree of ``tree`` at a '/'-joined path."""
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _shape_tree(tree):
    from repro_torch.core.freezing import tree_map

    return tree_map(lambda t: (tuple(t.shape), t.dtype), tree)


def phase_decompose():
    """Dense full-width smollm-360m from a seeded generator through
    ``apply_lrd`` at Eq.-5 and Algorithm-1 ranks (timed, checked against the
    init-time plan and a float64 SVD), ``randomized_svd`` against
    ``svd_decompose`` on one slice, then the Eq.-5 tree served through the
    kernels with K1/K5 launches counted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import svd
    from repro_torch.core.decompose import apply_lrd, iter_factor_groups
    from repro_torch.core.freezing import tree_leaves
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul
    from repro_torch.launch import serve, steps
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServeEngine

    run = serve.serve_run(get_config("smollm-360m"), max_len=PREFILL_M + 32, slots=DECODE_M,
                          lrd=True, device=torch.device("cuda"), seed=0)
    dense_run = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, enabled=False))
    dense, dense_plan = steps.init_params(dense_run, "cuda")
    n_dense = sum(t.numel() for t in tree_leaves(dense))
    if dense_plan.layers or any(t.dtype != torch.bfloat16 for t in tree_leaves(dense)):
        raise AssertionError("decompose: the dense init is not a bf16 tree without LRD")
    torch.linalg.svd(torch.ones((64, 64), device="cuda"))  # cuSOLVER's set-up, untimed
    torch.cuda.synchronize()
    exact = {}  # path -> float64 SVD of layer 0 (CPU)
    out, trees = dict(dense_params=n_dense), {}
    for name, quantize in (("eq5", False), ("alg1", True)):
        r_run = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, rank_quantize=quantize))
        dec = steps.make_decomposer(r_run, device="meta")
        layout = lm.lm_init(r_run.model, dec)  # the init-time plan and shapes, no data
        t0 = time.perf_counter()
        tree, plan = apply_lrd(dense, dec.policy)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        # the init names the stacked layers "layers", the tree keeps them under "stack"
        want = {p.replace("layers/", "stack/", 1):
                dataclasses.replace(lp, path=p.replace("layers/", "stack/", 1))
                for p, lp in dec.plan.layers.items()}
        if plan.layers != want or _shape_tree(tree) != _shape_tree(layout):
            raise AssertionError(f"decompose ({name}): plan or layout differs from the "
                                 f"init-time Decomposer's: {plan.to_json()}")
        errs = {}
        for path, g in iter_factor_groups(tree):
            if path not in exact:
                w64 = _at(dense, path)["kernel"][0].double().cpu()
                exact[path] = (w64, torch.linalg.svd(w64, full_matrices=False))
            w64, (u64, s64, vh64) = exact[path]
            r = g["u"].shape[-1]
            w_r = (u64[:, :r] * s64[:r]) @ vh64[:r]
            got = (g["u"][0].double() @ g["v"][0].double()).cpu()
            _, rel = rel_err(got, w_r)
            errs[path.rsplit("/", 1)[-1]] = dict(
                rank=r, rel_err=rel,
                eq3=((torch.sum((w64 - w_r) ** 2) / torch.sum(w64 ** 2)) ** 0.5).item())
            if not math.isfinite(rel) or rel > DECOMP_RTOL:
                raise AssertionError(f"decompose ({name}): {path} layer 0 u @ v is {rel:.3e} "
                                     f"of max |W_r| off the float64 truncated SVD "
                                     f"(bound {DECOMP_RTOL})")
        out[name] = dict(seconds=secs, summary=plan.summary(), layers=errs)
        log(f"[decompose] apply_lrd ({name}, {plan.summary()}) on dense smollm-360m "
            f"({n_dense / 1e6:.1f} M params, bf16, 32 layers): {secs:.2f} s on "
            f"{torch.cuda.get_device_name(0)}; layer 0 u @ v against a float64 truncated SVD "
            f"(max |diff| / max |W_r|, bound {DECOMP_RTOL}; Eq. 3 ||W - W_r|| / ||W||): "
            + ", ".join(f"{k} r {e['rank']} {e['rel_err']:.2e} ({e['eq3']:.3f})"
                        for k, e in errs.items()))
        trees[name] = tree
    # randomized against exact SVD on one (960, 2560) slice at its Eq.-5 rank
    w = _at(dense, "stack/ffn/gate")["kernel"][0]
    r = trees["eq5"]["stack"]["ffn"]["gate"]["u"].shape[-1]
    cmp = {}
    for fn in (svd.svd_decompose, svd.randomized_svd):
        fn(w, r)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, v = fn(w, r)
        torch.cuda.synchronize()
        cmp[fn.__name__] = dict(ms=(time.perf_counter() - t0) * 1e3,
                                err=(svd.reconstruction_error(w, u, v)
                                     / torch.sum(w.float() ** 2)).item())
    if not cmp["svd_decompose"]["err"] <= cmp["randomized_svd"]["err"]:
        raise AssertionError(f"decompose: the exact truncated SVD's error exceeds the "
                             f"randomized one's (Eckart-Young): {cmp}")
    out["svd_vs_randomized"] = dict(shape=[960, 2560], rank=r, **cmp)
    log(f"[decompose] (960, 2560) slice at r {r}: svd_decompose "
        f"{cmp['svd_decompose']['ms']:.1f} ms, ||W - UV||^2 / ||W||^2 "
        f"{cmp['svd_decompose']['err']:.4f}; randomized_svd {cmp['randomized_svd']['ms']:.1f} ms, "
        f"{cmp['randomized_svd']['err']:.4f}")
    del trees["alg1"], exact
    # serve the Eq.-5 tree
    engine = ServeEngine(run, trees.pop("eq5"), device="cuda",
                         config=ServeConfig(num_slots=DECODE_M, max_len=PREFILL_M + 32,
                                            prefill_len=PREFILL_M, block_size=16))
    trace = serve.poisson_trace(8, 1000.0, PREFILL_M, run.model.vocab_size, seed=3)
    for req in trace:
        req["max_new"] = 16
    zero_counts()
    t0 = time.perf_counter()
    outs = engine.serve(trace)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers().items()}
    by_shape = counts_by_shape()
    fwd = engine.scheduler.forward_stats
    n_fwd, n_layers = fwd["prefill"] + fwd["decode"], run.model.num_layers
    want = {"lowrank_matmul": 5 * n_layers * n_fwd, "lowrank_gated_ffn": n_layers * n_fwd}
    got = {k: n for k, n in counts.items() if n or k in want}
    if len(outs) != 8 or any(len(o) != 16 for o in outs) or fwd["nonfinite"] or got != want:
        raise AssertionError(f"decompose serve: {[len(o) for o in outs]} tokens, "
                             f"{fwd['nonfinite']} non-finite forwards, launches {got}, want {want}")
    log(f"[decompose] served the Eq.-5 tree: 8 requests x 16 tokens, {fwd['prefill']} prefill "
        f"+ {fwd['decode']} decode forwards, {lowrank_matmul.launches} K1 + "
        f"{lowrank_gated_ffn.launches} K5 launches = {5 * n_layers} + {n_layers} per forward; "
        f"{dt:.1f}s")
    out["serve"] = dict(fwd=dict(fwd), counts=got, wall_s=dt)
    return engine, by_shape, out


def _train_run():
    from repro_torch.launch import train

    return train.build_run(train._parser().parse_args(TRAIN_ARGV))


def _train_batch(run, seed: int):
    """One batch of the synthetic stream (an enc-dec run's with the train
    CLI's stub frames of step ``seed``, a VLM run's with its stub vision
    embeddings)."""
    from repro_torch.data import LMBatchIterator
    from repro_torch.launch import train

    batch = next(iter(LMBatchIterator(run.model.vocab_size, run.shape.seq_len,
                                      run.shape.global_batch, seed=seed)))
    if run.model.family == "encdec":
        batch["frames"] = train.stub_frames(run, seed, 0)
    elif run.model.family == "vlm":
        batch["vision_embeddings"] = train.stub_vision_embeddings(run, seed, 0)
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def phase_train(obs_dir: Path):
    """The training CLI at full width, launches counted per step, with its
    telemetry on (``--obs``, events in ``obs_dir``) and step 2 (phase 1)
    profiled (``--profile-steps``); phase 68 reads both."""
    with telemetry_capture() as (reg, fallbacks):
        state, per_step, by_shape, dt = _counted_train(TRAIN_ARGV + train_obs_argv(obs_dir))
    phases = [r["phase"] for r in per_step]
    if phases != [0, 0, 1, 1, 0, 0]:
        raise AssertionError(f"train: phases {phases}, want [0, 0, 1, 1, 0, 0]")
    for r in per_step:
        _check_step("train", r, _leaf_ranks(PROJ))
        log(f"[train] step {r['step']} phase {r['phase']}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms; launches "
            + ", ".join(f"{k.replace('lowrank_', '')} {n}" for k, n in r["launches"].items()
                        if n))
    log(f"[train] 6 steps of {TRAIN_M} tokens on {torch.cuda.get_device_name(0)}: loss "
        f"{per_step[0]['loss']:.4f} -> {per_step[-1]['loss']:.4f}; {dt:.1f}s incl. init")
    return state.params, by_shape, dict(steps=_without_shapes(per_step), wall_s=dt,
                                        events=str(obs_dir / "events.jsonl"),
                                        registry=reg.snapshot(), fallbacks=list(fallbacks))


# phase 68: the train run profiles step 2, the first step of phase 1
TRAIN_PROFILE_STEPS = (2, 3)
# kernel-name pieces of K1-K5's launches (both K1/K5 designs; K2-K4's
# ``bwd::k*_`` kernels), as ``lowrank_device_ms`` / ``bwd_device_ms`` read them
TRACE_KERNELS = {"K1": ("lowrank_matmul_rank_kernel", "lowrank_matmul_out_kernel",
                        "lowrank_matmul_large_kernel"),
                 "K5": ("lowrank_ffn_rank_kernel", "lowrank_ffn_out_kernel",
                        "lowrank_ffn_large_kernel"),
                 "K2": ("bwd::k2_",), "K3": ("bwd::k3_",), "K4": ("bwd::k4_",)}


def train_obs_argv(obs_dir: Path):
    """The train CLI's telemetry flags of phase 7."""
    return ["--obs", "--obs-dir", str(obs_dir),
            "--profile-steps", "%d:%d" % TRAIN_PROFILE_STEPS]


def _trace_kernels(trace_dir):
    """The device kernels of a train CLI's profile window: (name, µs) from
    its Chrome trace."""
    trace = json.loads((Path(trace_dir) / "trace.json").read_text())
    return [(e["name"], float(e.get("dur", 0.0))) for e in trace["traceEvents"]
            if e.get("cat") == "kernel"]


def _profile_window_kernels(events, obs_dir: Path):
    """The kernels of the train run's ``profile_window``.  CUPTI can hand
    back a session with no device record (``profiled``); such a window
    says nothing of what ran, so it is taken again by a 3-step run of the
    same CLI (steps 0-1 at phase 0, step 2 profiled at phase 1), up to
    PROFILE_TRIES windows in all; the last is used whatever it holds."""
    from repro_torch.launch import train

    windows = [e for e in events if e["type"] == "profile_window"]
    want = dict(start_step=TRAIN_PROFILE_STEPS[0], stop_step=TRAIN_PROFILE_STEPS[1],
                trace_dir=str(obs_dir / "profile"))
    if len(windows) != 1 or {k: windows[0][k] for k in want} != want:
        raise AssertionError(f"telemetry: profile_window events {windows}, want one with {want}")
    kernels = _trace_kernels(windows[0]["trace_dir"])
    for i in range(1, PROFILE_TRIES):
        if kernels:
            break
        log(f"[telemetry] the profile window held no device kernel: taking it again ({i})")
        again = obs_dir / f"again{i}"
        with tempfile.TemporaryDirectory() as ckpt_dir:
            train.main(TRAIN_ARGV + ["--steps", "3", "--ckpt-dir", ckpt_dir]
                       + train_obs_argv(again))
        kernels = _trace_kernels(again / "profile")
    return kernels


def _check_fallbacks(what: str, out) -> dict:
    """No plain-path decision with a ``platform`` reason on the card (a
    CUDA tensor never takes the plain path), none ``disabled`` either (the
    path runs every factorised projection with the kernels on); the
    counter's series are returned."""
    series = out["registry"].get("kernel_fallbacks", {}).get("series", {})
    taken = sorted({(f.op, f.reason, f.shape) for f in out["fallbacks"]})
    for op, reason, shape in taken:
        log(f"[telemetry] {what}: plain path op={op} reason={reason} shape={shape}")
    if series or taken:
        raise AssertionError(f"telemetry: {what} took the plain path: kernel_fallbacks "
                             f"{series}, {taken}")
    return series


def _emit_us(events, n: int = 3) -> float:
    """Host µs an ``EventLog.emit`` takes, replaying ``events`` into a new
    log file (the serialisation, the write and the flush), best of ``n``."""
    from repro_torch.obs import EventLog

    best = float("inf")
    with tempfile.TemporaryDirectory() as d:
        for _ in range(n):
            with EventLog(Path(d) / "events.jsonl") as obs:
                t0 = time.perf_counter()
                for e in events:
                    obs.emit(e["type"], **{k: v for k, v in e.items()
                                           if k not in ("schema", "ts", "type")})
                best = min(best, time.perf_counter() - t0)
    return best / len(events) * 1e6


def phase_telemetry(serve_out, train_out, smi: str):
    """Phase 68: the traces phases 4 and 7 wrote with their CLIs'
    ``--obs``, validated with the port's validator and read with
    ``obs_report``, held to the runs' own stats, losses and partition
    bytes; the train run's profile window (step 2, phase 1) read from the
    device side: K1, K2, K3 and K5 kernels, no ``k4_`` kernel (the frozen
    factor's gradient is never launched); no plain-path decision in either
    run (``kernel_fallbacks``)."""
    import numpy as np

    from repro_torch.analysis import obs_report
    from repro_torch.obs import validate_file

    out = {}
    # serve: one lifecycle of each kind a request, a serve_step a decode forward
    n_ev = validate_file(serve_out["events"])
    events = obs_report.load_events(serve_out["events"])
    stats, fwd = serve_out["stats"], serve_out["fwd"]
    kinds = [e["type"] for e in events]
    if (kinds[0], kinds[-1]) != ("run_start", "run_end"):
        raise AssertionError(f"telemetry: serve trace runs {kinds[0]} .. {kinds[-1]}")
    rids = list(range(int(stats["requests"])))
    for t in ("request_queued", "request_prefill", "request_first_token", "request_retired"):
        got = sorted(e["rid"] for e in events if e["type"] == t)
        if got != rids:
            raise AssertionError(f"telemetry: serve {t} for requests {got}, want {rids}")
    if kinds.count("serve_step") != fwd["decode"]:
        raise AssertionError(f"telemetry: {kinds.count('serve_step')} serve_step events, "
                             f"{fwd['decode']} decode forwards")
    run_end = {k: events[-1].get(k) for k in stats}
    if run_end != stats:
        raise AssertionError(f"telemetry: run_end {run_end} != latency_stats() {stats}")
    summary = obs_report.serve_summary(events)
    if summary["generated_tokens"] != stats["generated_tokens"] or summary["compiles"]:
        raise AssertionError(f"telemetry: serve_summary {summary} against {stats}")
    ttft = [e["ttft_s"] for e in events if e["type"] == "request_first_token"]
    lat = [e["latency_s"] for e in events if e["type"] == "request_retired"]
    emit_us = _emit_us(events)
    step_ms = serve_out["wall_s"] * 1e3 / max(fwd["prefill"] + fwd["decode"], 1)
    per_step = n_ev / max(fwd["decode"], 1)
    serve = dict(events=n_ev, tok_per_s=stats["tok_per_s"],
                 p50_ttft_ms=summary["p50_ttft_s"] * 1e3,
                 p95_ttft_ms=float(np.percentile(ttft, 95)) * 1e3,
                 p50_latency_ms=summary["p50_latency_s"] * 1e3,
                 p95_latency_ms=float(np.percentile(lat, 95)) * 1e3,
                 max_active_slots=summary["max_active_slots"],
                 pool_high_water_blocks=summary["pool_high_water_blocks"],
                 emit_us=emit_us, events_per_decode_step=per_step,
                 emit_share_of_forward=per_step * emit_us / 1e3 / step_ms,
                 fallbacks=_check_fallbacks("serve", serve_out))
    log(f"[telemetry] serve trace: {n_ev} events valid; one queued / prefill / first token / "
        f"retired a request for {len(rids)}; {fwd['decode']} serve_step = decode forwards; "
        f"run_end = latency_stats(); {summary['generated_tokens']} tokens, "
        f"{serve['tok_per_s']:.1f} tok/s, TTFT p50 / p95 {serve['p50_ttft_ms']:.1f} / "
        f"{serve['p95_ttft_ms']:.1f} ms, latency p50 / p95 {serve['p50_latency_ms']:.1f} / "
        f"{serve['p95_latency_ms']:.1f} ms (obs_report); an emit {emit_us:.1f} us on the host, "
        f"{per_step:.1f} a decode step: {100 * serve['emit_share_of_forward']:.3f}% of a "
        f"forward's {step_ms:.1f} ms wall; on {smi}")
    out["serve"] = serve

    # train: the on_step losses bit for bit, phases, swaps, partition bytes
    n_ev = validate_file(train_out["events"])
    events = obs_report.load_events(train_out["events"])
    steps = [e for e in events if e["type"] == "train_step"]
    want = train_out["steps"]
    parts = ("trainable_bytes", "frozen_bytes", "opt_bytes")
    if ([e["loss"] for e in steps] != [r["loss"] for r in want]
            or [e["phase"] for e in steps] != [0, 0, 1, 1, 0, 0]
            or [{k: e[k] for k in parts} for e in steps] != [{k: r[k] for k in parts}
                                                            for r in want]
            or [e["rank_map"] for e in steps] != [r["rank_map"] for r in want]):
        raise AssertionError(f"telemetry: train_step records {steps} against the run's {want}")
    swaps = [e["epoch"] for e in events if e["type"] == "phase_swap"]
    if swaps != [1, 2] or any(e["sync_bytes_per_step"] for e in steps):
        raise AssertionError(f"telemetry: phase swaps at epochs {swaps}, want [1, 2]")
    rows = obs_report.train_attribution(events)
    if [r["phase"] for r in rows] != [0, 1, 0]:
        raise AssertionError(f"telemetry: attribution rows {rows}")
    kernels = _profile_window_kernels(events, Path(train_out["events"]).parent)
    by = {k: sum(dur for name, dur in kernels if any(p in name for p in pieces))
          for k, pieces in TRACE_KERNELS.items()}
    k4 = sorted({name for name, _ in kernels if re.search(r"(?<![A-Za-z0-9_])k4_", name)})
    missing = [k for k in ("K1", "K2", "K3", "K5") if not by[k]]
    if missing or k4 or by["K4"]:
        raise AssertionError(f"telemetry: the phase-1 window launched {missing} none, k4_ "
                             f"kernels {k4}")
    times = [e["step_time_s"] * 1e3 for e in steps]
    prof = TRAIN_PROFILE_STEPS[0]
    train = dict(events=n_ev, step_ms=times, profiled_step=prof,
                 profiled_over_next=times[prof] / times[prof + 1],
                 window_kernels=len(kernels), window_kernel_ms=sum(d for _, d in kernels) / 1e3,
                 window_ms_by_kernel={k: v / 1e3 for k, v in by.items()},
                 fallbacks=_check_fallbacks("train", train_out))
    log(obs_report.render_train(rows))
    log(f"[telemetry] train trace: {n_ev} events valid; 6 train_step losses = on_step's bit "
        f"for bit, phases 0,0,1,1,0,0, swaps at epochs 1 and 2, partition bytes = "
        f"steps.partition_bytes; step ms " + ", ".join(f"{t:.1f}" for t in times)
        + f"; profiled step {prof} (phase 1) {train['profiled_over_next']:.2f}x step "
        f"{prof + 1}; its window {len(kernels)} kernels, {train['window_kernel_ms']:.2f} ms: "
        + ", ".join(f"{k} {v / 1e3:.2f}" for k, v in by.items())
        + " ms, no k4_ kernel; kernel_fallbacks empty in both runs; on " + smi)
    out["train"] = train
    return out


def _grad_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _grad_paths(v, f"{path}/{k}")
    elif tree is not None:
        yield path, tree


def phase_grads(params, run=None, label: str = "grads"):
    """One train step's loss and gradients through the kernels against the
    same step through the plain versions, at phases -1, 0 and 1 (of
    ``run``, by default phase 7's)."""
    import dataclasses

    from repro_torch.core import freezing
    from repro_torch.launch import steps

    run = run or _train_run()
    plain = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, use_pallas_kernel=False))
    batch = _train_batch(run, seed=99)
    out = {}
    for phase in (-1, 0, 1):
        trainable, frozen = freezing.partition(params, phase)
        lk, gk = steps._value_and_grad(trainable, frozen, batch, run, phase)
        lp, gp = steps._value_and_grad(trainable, frozen, batch, plain, phase)
        loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
        worst, n = (0.0, ""), 0
        for (path, a), (_, b) in zip(_grad_paths(gk), _grad_paths(gp)):
            diff = (a.float() - b.float()).abs().max().item()
            rel = diff / max(b.float().abs().max().item(), 1e-30)
            if not (math.isfinite(diff) and torch.isfinite(a).all()):
                raise AssertionError(f"{label}: phase {phase} {path} not finite")
            worst, n = max(worst, (rel, path)), n + 1
        log(f"[{label}] phase {phase}: loss kernels {lk.item():.5f} vs plain {lp.item():.5f} "
            f"(rel {loss_rel:.2e}, bound {LOSS_RTOL}); {n} trainable leaves, worst "
            f"max |dgrad| / max |grad| {worst[0]:.2e} at {worst[1]} (bound {GRAD_RTOL})")
        if loss_rel > LOSS_RTOL or worst[0] > GRAD_RTOL:
            raise AssertionError(f"{label}: phase {phase} loss rel {loss_rel:.3e}, worst leaf "
                                 f"{worst[1]} rel {worst[0]:.3e}")
        out[phase] = dict(loss_kernels=lk.item(), loss_plain=lp.item(), loss_rel=loss_rel,
                          leaves=n, worst_rel=worst[0], worst_leaf=worst[1])
    return out


def phase_train_profile(params, steps_n: int = 2, run=None, phases=(-1, 0, 1),
                        label: str = "train profile", moe: bool = False, warmup: bool = True,
                        donate: bool = False):
    """Wall time (host clock around synchronised steps), device time
    (``torch.profiler``, device-side events only) and idle share of a
    full-width train step at each freezing phase, with tokens/s and
    ``torch.cuda.max_memory_allocated`` over the phase's steps; for a MoE
    model also the experts' ``bmm`` ms.  With ``donate`` the steps update
    the state in place, as the train CLI's do (``params`` then take the
    steps' updates)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    run = run or _train_run()
    batch = _train_batch(run, seed=98)
    out = {}
    for phase in phases:
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        state, _ = steps.make_train_state(run.optim, params, phase)
        step = steps.build_train_step(run, "cuda", donate=donate)
        if warmup:
            state, _ = step(state, batch, phase=phase)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps_n):
            state, _ = step(state, batch, phase=phase)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps_n * 1e3
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=moe) as prof:
            for _ in range(steps_n):
                state, _ = step(state, batch, phase=phase)
            torch.cuda.synchronize()
        by_name = device_ms_by_kernel(prof, steps_n)
        device_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        k1_ms, k5_ms = lowrank_device_ms(by_name)
        k2_ms, k3_ms, k4_ms = bwd_device_ms(by_name)
        out[phase] = dict(wall_ms=wall_ms, tok_per_s=TRAIN_M / wall_ms * 1e3,
                          device_ms=device_ms if device_ms else None,
                          idle_share=(1 - device_ms / wall_ms) if device_ms else None,
                          k1_ms=k1_ms, k5_ms=k5_ms, k2_ms=k2_ms, k3_ms=k3_ms, k4_ms=k4_ms,
                          max_memory_allocated=peak,
                          top=[dict(name=k[:80], ms=v) for k, v in top])
        if moe:
            out[phase]["expert_bmm_ms"] = expert_bmm_ms(prof, steps_n, run.model.num_experts)
        shown = ", ".join(f"{k[:40]} {v:.2f}ms" for k, v in top[:6])
        log(f"[{label}] phase {phase} step ({TRAIN_M} tokens, {run.model.num_layers} layers): "
            f"max_memory_allocated {peak / 2 ** 30:.2f} GiB"
            + (f", experts' bmm {out[phase]['expert_bmm_ms']:.2f} ms" if moe else "")
            + "; wall "
            f"{wall_ms:.1f} ms ({TRAIN_M / wall_ms * 1e3:.0f} tok/s), device "
            + (f"{device_ms:.1f} ms, idle {out[phase]['idle_share']:.1%}; K1 {k1_ms:.2f} ms, "
               f"K5 {k5_ms:.2f} ms, K2 {k2_ms:.2f} ms, K3 {k3_ms:.2f} ms, K4 {k4_ms:.2f} ms; "
               f"top: {shown}"
               if device_ms else "time not measured (profiler saw no device events)"))
        del state
    return out


# --------------------------------------------------------------------------
# In-training rank adaptation
# --------------------------------------------------------------------------

# memory_allocated after two steps at the same ranks and phase differs by
# up to 3.0 MiB on the H100 (the allocator's 512-byte rounding of each
# tensor, library workspaces); an untruncated tree of factors or moments
# left alive is at least 54 MiB (the frozen u at 96/67/128)
MEM_SLACK = 8 << 20


def _leaf_ranks(proj):
    """{projection leaf: rank} of a PROJ-style table."""
    pairs = {"wq": "wq/wo", "wo": "wq/wo", "wk": "wk/wv", "wv": "wk/wv", "gate": "gate/up",
             "up": "gate/up", "down": "down"}
    return {leaf: proj[key][1] for leaf, key in pairs.items()}


def _by_leaf(rank_map):
    return {path.rsplit("/", 1)[-1]: r for path, r in rank_map.items()}


def _expected_keys(ranks):
    """Each K1-K5 wrapper's ``launches_by_shape`` keys in a train step at
    ``ranks`` ({leaf: rank}): K1, K2, K3 and K4 on every factor pair, K5 on
    the gate/up pair."""
    pairs = {(TRAIN_M, c, ranks[leaf], s_) for leaf, (c, s_) in GEOM.items()}
    return {"lowrank_matmul": pairs, "lowrank_matmul_dx": pairs, "lowrank_matmul_du": pairs,
            "lowrank_matmul_dv": pairs,
            "lowrank_gated_ffn": {(TRAIN_M, 960, ranks["gate"], ranks["up"], 2560)}}


def _factor_bytes(rank_map, phase, n_layers):
    """(param bytes, optimizer bytes) of the factor pairs at ``rank_map``:
    bf16 (L, C, r) and (L, r, S) factors, and sgdm's one float32 moment for
    the trainable factor (v at phase 0, u at phase 1)."""
    params = opt = 0
    for path, r in rank_map.items():
        c, s_ = GEOM[path.rsplit("/", 1)[-1]]
        params += 2 * n_layers * r * (c + s_)
        opt += 4 * n_layers * r * (s_ if phase == 0 else c)
    return params, opt


def _counted_train(argv):
    """``train.main(argv)`` with each step's metrics, its launches by kernel
    and the shapes each kernel launched at, and
    ``torch.cuda.memory_allocated()`` after it."""
    import tempfile

    from repro_torch.launch import train

    per_step, prev, prev_shape = [], {}, {}

    def on_step(step, phase, metrics):
        now = {name: fn.launches for name, fn in wrappers().items()}
        shapes = counts_by_shape()
        gc.collect()  # tensors in reference cycles count until collected
        per_step.append(dict(
            step=step, phase=phase, **metrics, mem=torch.cuda.memory_allocated(),
            launches={k: n - prev.get(k, 0) for k, n in now.items()},
            shapes={k: {key for key, n in by.items() if n > prev_shape.get(k, {}).get(key, 0)}
                    for k, by in shapes.items()},
            shape_counts={k: {key: n - prev_shape.get(k, {}).get(key, 0) for key, n in by.items()
                              if n > prev_shape.get(k, {}).get(key, 0)}
                          for k, by in shapes.items()}))
        prev.update(now)
        prev_shape.update(shapes)

    zero_counts()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        state, _ = train.main(argv + ["--ckpt-dir", ckpt_dir], on_step=on_step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return state, per_step, counts_by_shape(), dt


def _without_shapes(per_step):
    return [{k: v for k, v in r.items() if k not in ("shapes", "shape_counts")}
            for r in per_step]


def _check_step(path: str, r, ranks):
    """A counted train step at ``ranks``: TRAIN_LAUNCHES by name, the
    expected shapes, finite loss and grad norm."""
    want = {k: (v[r["phase"]] if isinstance(v, dict) else v) for k, v in TRAIN_LAUNCHES.items()}
    got = {k: n for k, n in r["launches"].items() if n or k in want}
    shapes = {k: keys for k, keys in _expected_keys(ranks).items() if want[k]}
    seen = {k: keys for k, keys in r["shapes"].items() if keys}
    if got != want or seen != shapes:
        raise AssertionError(f"{path}: step {r['step']} (phase {r['phase']}) launched {got} at "
                             f"{seen}, want {want} at {shapes}")
    if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
        raise AssertionError(f"{path}: step {r['step']} loss {r['loss']} grad norm "
                             f"{r['grad_norm']}")


def phase_rank_adapt_train():
    """The training CLI with ``--rank-schedule decay`` (6 steps, swaps at
    steps 2 and 4), then one ``--rank-schedule energy`` boundary (3 steps)."""
    state, per_step, by_shape, dt = _counted_train(DECAY_ARGV)
    n_layers = 32
    if [r["phase"] for r in per_step] != [0, 0, 1, 1, 0, 0]:
        raise AssertionError(f"rank adapt: phases {[r['phase'] for r in per_step]}")
    want_ranks = [_leaf_ranks(p) for p in (PROJ, PROJ, PROJ_DECAY[0], PROJ_DECAY[0],
                                           PROJ_DECAY[1], PROJ_DECAY[1])]
    step0 = per_step[0]
    fp, fo = _factor_bytes(step0["rank_map"], step0["phase"], n_layers)
    base = (step0["trainable_bytes"] + step0["frozen_bytes"] - fp, step0["opt_bytes"] - fo)
    for r, want in zip(per_step, want_ranks):
        ranks = _by_leaf(r["rank_map"])
        if ranks != want:
            raise AssertionError(f"rank adapt: step {r['step']} ranks {ranks}, want {want}")
        _check_step("rank adapt", r, ranks)
        fp, fo = _factor_bytes(r["rank_map"], r["phase"], n_layers)
        r["implied_bytes"] = (base[0] + fp, base[1] + fo)
        if (r["trainable_bytes"] + r["frozen_bytes"], r["opt_bytes"]) != r["implied_bytes"]:
            raise AssertionError(f"rank adapt: step {r['step']} params + opt bytes "
                                 f"{r['trainable_bytes'] + r['frozen_bytes']} + {r['opt_bytes']}, "
                                 f"the rank map implies {r['implied_bytes']}")
        log(f"[rank adapt] step {r['step']} phase {r['phase']} ranks wq/wo {ranks['wq']}, wk/wv "
            f"{ranks['wk']}, gate/up {ranks['gate']}, down {ranks['down']}: loss {r['loss']:.4f}, "
            f"grad norm {r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms; trainable "
            f"{r['trainable_bytes'] / 2 ** 20:.1f} MiB, frozen {r['frozen_bytes'] / 2 ** 20:.1f} MiB, "
            f"opt {r['opt_bytes'] / 2 ** 20:.1f} MiB, memory_allocated {r['mem'] / 2 ** 20:.1f} MiB; "
            f"launches " + ", ".join(f"{k.replace('lowrank_', '')} {n}"
                                     for k, n in r["launches"].items() if n))
    drops = []
    for b in (2, 4):
        before, after = per_step[b - 1], per_step[b]
        total = lambda r: r["trainable_bytes"] + r["frozen_bytes"] + r["opt_bytes"]  # noqa: E731
        d_bytes, d_mem = total(after) - total(before), after["mem"] - before["mem"]
        drops.append(dict(step=b, bytes=d_bytes, memory_allocated=d_mem))
        if not (d_bytes < 0 and d_mem < 0 and abs(d_mem - d_bytes) <= MEM_SLACK):
            raise AssertionError(f"rank adapt: boundary at step {b}: partition bytes moved by "
                                 f"{d_bytes}, memory_allocated by {d_mem} (slack {MEM_SLACK})")
        log(f"[rank adapt] boundary at step {b}: params + opt bytes {d_bytes / 2 ** 20:+.2f} MiB, "
            f"torch.cuda.memory_allocated {d_mem / 2 ** 20:+.2f} MiB")
    log(f"[rank adapt] 6 steps of {TRAIN_M} tokens with --rank-schedule decay: {dt:.1f}s "
        f"incl. init")
    e_state, e_steps, e_by_shape, e_dt = _counted_train(ENERGY_ARGV)
    if [r["phase"] for r in e_steps] != [0, 0, 1]:
        raise AssertionError(f"rank energy: phases {[r['phase'] for r in e_steps]}")
    start = _leaf_ranks(PROJ)
    for r in e_steps:
        ranks = _by_leaf(r["rank_map"])
        if any(ranks[k] > start[k] for k in start) or (r["step"] < 2 and ranks != start):
            raise AssertionError(f"rank energy: step {r['step']} ranks {ranks}")
        _check_step("rank energy", r, ranks)
    energy = _by_leaf(e_steps[-1]["rank_map"])
    log(f"[rank energy] --rank-schedule energy (0.98 of the squared singular mass, spectra "
        f"read on the card) after 2 steps: " + ", ".join(f"{k} {start[k]}->{energy[k]}"
                                                         for k in start)
        + f"; step 2 loss {e_steps[-1]['loss']:.4f}; {e_dt:.1f}s incl. init")
    return state.params, by_shape, e_by_shape, dict(
        steps=_without_shapes(per_step), drops=drops, wall_s=dt,
        energy_steps=_without_shapes(e_steps), energy_ranks=energy)


def phase_rank_map_profiles(params, final):
    """Train steps profiled as in phase 9 at the decay schedule's two shrunk
    rank maps: ``params`` (Eq.-5 ranks) truncated to the first, and the
    decay run's final params (the second)."""
    from repro_torch.core import rank_adapt

    first = {p: _leaf_ranks(PROJ_DECAY[0])[p.rsplit("/", 1)[-1]]
             for p in rank_adapt.live_rank_map(params)}
    out = {}
    for label, p in (("map 1", rank_adapt.truncate_params(params, first)), ("map 2", final)):
        ranks = _by_leaf(rank_adapt.live_rank_map(p))
        out[label] = dict(ranks=ranks, profile=phase_train_profile(
            p, label=f"rank {label} train profile ({ranks['wq']}/{ranks['wk']}/{ranks['gate']})"))
    return out


def shape_dims(name, key):
    """Inverse of :func:`shape_key` for K1-K5."""
    if name == "lowrank_gated_ffn":
        m, c, r, _, f = key
        return dict(M=m, C=c, r=r, F=f)
    m, c, r, s_ = key
    return dict(M=m, C=c, r=r, S=s_)


# --------------------------------------------------------------------------
# The Algorithm-1 int8 export (K6, K7) and Algorithm-1 training
# --------------------------------------------------------------------------

# K6/K7 shapes checked by ``--only kernels`` (no serve run to read them
# from): the analytic export's K7 shapes and every geometry as K6 (serving
# entries; phase 14 adds the int8-operand twins)
INT8_DEFAULT_SHAPES = (
    [("int8_lowrank_linear", (m, c, r, s)) for m in (DECODE_M, PREFILL_M)
     for c, r, s in ((960, 128, 960), (960, 119, 320), (960, 256, 2560), (2560, 256, 960))]
    + [("int8_linear", (m, c, s)) for m in (DECODE_M, PREFILL_M)
       for c, s in ((960, 960), (960, 320), (960, 2560), (2560, 960))])


def _geometries(report):
    """(C, S) -> [(path, LayerExport)] of an export report, in path order."""
    out = {}
    for path, lay in sorted(report.layers.items()):
        out.setdefault(tuple(lay.shape), []).append((path, lay))
    return out


def phase_export_serve(kind: str):
    """The serve CLI on the int8 artifact of the ``kind`` export, launches
    counted: every forward makes 224 int8 launches, K7 for each kept factor
    pair and K6 for each merged group, and no K1/K5."""
    from repro_torch.launch import serve

    zero_counts()
    t0 = time.perf_counter()
    engine, outs = serve.main(SERVE_ARGV + ["--export", kind, "--export-int8"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers().items()}
    by_shape = counts_by_shape()
    report = engine.export_report
    sched = engine.scheduler
    fwd = sched.forward_stats
    n_fwd = fwd["prefill"] + fwd["decode"]
    n_layers = engine.run.model.num_layers
    if len(outs) != 16 or any(len(o) != 32 for o in outs):
        raise AssertionError(f"export serve ({kind}): want 16 requests x 32 tokens, got "
                             f"{[len(o) for o in outs]}")
    if fwd["nonfinite"]:
        raise AssertionError(f"export serve ({kind}): {fwd['nonfinite']} forwards with "
                             f"non-finite logits")
    merged = sorted(p for p, lay in report.layers.items() if lay.merged)
    kept = len(report.layers) - len(merged)
    per_layer_merged = sum(1 for p in merged if p.startswith("stack/"))
    k6, k7 = counts["int8_linear"], counts["int8_lowrank_linear"]
    # nothing else: no K1/K5 and no int8-operand entry (x is quantized in the kernels)
    others = {k: n for k, n in counts.items() if n and k not in INT8_FUSED}
    want_k6 = n_layers * per_layer_merged * n_fwd
    per_forward = INT8_PER_LAYER * n_layers
    if (n_fwd == 0 or others or k6 + k7 != per_forward * n_fwd or k6 != want_k6
            or len(report.layers) != INT8_PER_LAYER):
        raise AssertionError(f"export serve ({kind}): {n_fwd} forwards, {len(report.layers)} "
                             f"groups ({len(merged)} merged) but {k6} K6 + {k7} K7 launches "
                             f"(want {want_k6} K6 and {per_forward} a forward in all) and "
                             f"other kernels {others}")
    if kind == "analytic" and k6:
        raise AssertionError(f"export serve (analytic): {k6} K6 launches, want 0")
    log(f"[export {kind}] {report.summary()}")
    for (c, s_), groups in _geometries(report).items():
        lay = groups[0][1]
        log(f"[export {kind}]   (C {c}, S {s_}): {', '.join(p.split('/')[-1] for p, _ in groups)}"
            f" r_train {lay.rank_train} -> r_serve {lay.rank_serve}, "
            f"{'merged dense (K6)' if lay.merged else 'factorised (K7)'}; t_dense "
            f"{lay.original_time * 1e6:.2f}us, t_decomposed {lay.decomposed_time * 1e6:.2f}us"
            f" ({'v5e roofline model, not this card' if kind == 'analytic' else 'this card'})")
    if kind == "measured":
        for (c, s_, r), dec in sorted(report.decisions.items()):
            sweep = " ".join(f"{r_}:{t * 1e6:.1f}" for r_, t in zip(dec.searched, dec.times))
            log(f"[export measured] t(r) us at m {DECODE_M}, (C {c}, S {s_}), dense "
                f"{dec.original_time * 1e6:.1f}: {sweep}")
        log(f"[export measured] the guard merged {len(merged)} of {INT8_PER_LAYER} groups"
            + (f": {', '.join(p.split('/')[-1] for p in merged)}" if merged else
               " — K6 is reached only by the kernel phase in this run"))
    stats = sched.latency_stats()
    log(f"[export {kind}] {len(outs)} requests, {int(stats['generated_tokens'])} tokens, "
        f"{stats['tok_per_s']:.1f} tok/s; {fwd['prefill']} prefill + {fwd['decode']} decode "
        f"forwards; {k6} K6 + {k7} K7 launches = {k6 // n_fwd} + {k7 // n_fwd} per forward; "
        f"{dt:.1f}s incl. init and export")
    decisions = {f"{c}x{s_}@{r}": dict(rank=d.rank, use_decomposed=d.use_decomposed,
                                       searched=list(d.searched), times=list(d.times),
                                       original_time=d.original_time)
                 for (c, s_, r), d in report.decisions.items()}
    return engine, by_shape, dict(fwd=dict(fwd), k6=k6, k7=k7, stats=stats, wall_s=dt,
                                  merged=merged, kept=kept, decisions=decisions,
                                  layers={p: dict(shape=list(l.shape), rank_train=l.rank_train,
                                                  rank_serve=l.rank_serve, merged=l.merged)
                                          for p, l in report.layers.items()})


@contextlib.contextmanager
def plain_versions(**swaps):
    """Route the dispatchers' calls of the named kernel wrappers (names in
    ``kernels.ops``) to the given plain versions, on the card's tensors, for
    a reference run to hold the kernels against."""
    from repro_torch.kernels import ops

    saved = {name: getattr(ops, name) for name in swaps}
    for name, fn in swaps.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def plain_int8():
    from repro_torch.kernels import ref

    return plain_versions(int8_linear=ref.int8_linear_ref,
                          int8_lowrank_linear=ref.int8_lowrank_linear_ref)


def phase_int8_parity(engine, kind: str):
    """The int8 tree's last-position prefill logits and an 8-token greedy
    decode through K6/K7 against the same through their plain versions, and
    the gap of native int8 decode to the bf16 round trip of the tree."""
    import dataclasses

    from repro_torch.launch import steps
    from repro_torch.serving import ServeConfig, ServeEngine

    run = engine.run
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, run.model.vocab_size, (1, PREFILL_M), generator=gen,
                           device="cuda", dtype=torch.int32)
    last = torch.tensor([PREFILL_M - 1], device="cuda")
    batch = {"tokens": tokens}
    got, _ = steps.build_slot_prefill_step(run)(engine.params, batch, last)
    with plain_int8():
        want, _ = steps.build_slot_prefill_step(run)(engine.params, batch, last)
    bf16_run = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, int8_decode="bf16"))
    bf16, _ = steps.build_slot_prefill_step(bf16_run)(engine.params, batch, last)
    err, rel = rel_err(got, want)
    gap, gap_rel = rel_err(got, bf16)
    if not torch.isfinite(got).all() or rel > INT8_PATH_RTOL:
        raise AssertionError(f"int8 parity ({kind}): last-position logits differ by "
                             f"{err:.3e} ({rel:.3e} of max |logit|) > {INT8_PATH_RTOL}")
    prompt = tokens[0, :64].cpu().numpy()
    toks = []
    for plain in (False, True):
        eng = ServeEngine(run, engine.params, device="cuda",
                          config=ServeConfig(num_slots=1, max_len=80, prefill_len=64))
        with plain_int8() if plain else contextlib.nullcontext():
            toks.append(eng.generate(prompt[None], max_new=8)[0].tolist())
    if toks[0] != toks[1]:
        raise AssertionError(f"int8 parity ({kind}): greedy tokens differ: kernels "
                             f"{toks[0]} vs plain {toks[1]}")
    log(f"[int8 parity {kind}] prefill last-position logits, kernels vs plain: max_abs_diff "
        f"{err:.3e} ({rel:.3e} of max |logit| {want.abs().max().item():.3f}; bound "
        f"{INT8_PATH_RTOL}); greedy 8/8 identical {toks[0]}; native int8 vs bf16 round trip "
        f"of the same tree: max_abs_diff {gap:.3e} ({gap_rel:.3e} of max |logit|)")
    return dict(max_abs_diff=err, rel=rel, greedy=toks[0], bf16_gap=gap, bf16_gap_rel=gap_rel)


def phase_alg1_train():
    """The training CLI at Algorithm-1 ranks: the plan, then two steps
    (phases 0 and 1) with the launches counted per step."""
    from repro_torch.launch import steps, train

    run = train.build_run(train._parser().parse_args(ALG1_ARGV))
    _, plan = steps.init_params(run, "cuda")
    ranks = {p.split("/")[-1]: (lp.rank, lp.eq5_rank, lp.use_decomposed)
             for p, lp in plan.layers.items()}
    log(f"[alg1 train] {plan.summary()}; rank (Eq.-5 rank) per projection: "
        + ", ".join(f"{k} {r} ({e}){'' if d else ' dense'}" for k, (r, e, d) in ranks.items()))
    if {k: r for k, (r, _, d) in ranks.items() if d} != ALG1_RANKS:
        raise AssertionError(f"alg1 train: plan {ranks}, want {ALG1_RANKS}")
    state, per_step, by_shape, dt = _counted_train(ALG1_ARGV)
    if [r["phase"] for r in per_step] != [0, 1]:
        raise AssertionError(f"alg1 train: phases {[r['phase'] for r in per_step]}, want [0, 1]")
    for r in per_step:
        _check_step("alg1 train", r, _leaf_ranks(PROJ_ALG1))
        log(f"[alg1 train] step {r['step']} phase {r['phase']}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms; launches "
            + ", ".join(f"{k.replace('lowrank_', '')} {n}" for k, n in r["launches"].items()
                        if n))
    log(f"[alg1 train] 2 steps of {TRAIN_M} tokens: {dt:.1f}s incl. init")
    return state.params, run, by_shape, dict(steps=_without_shapes(per_step), wall_s=dt,
                                             ranks={k: list(v) for k, v in ranks.items()})


# --------------------------------------------------------------------------
# Flash attention (K8): the long-prompt flash serve
# --------------------------------------------------------------------------

def flash_kernel_case(d, gen):
    """Inputs, K8, its plain version, the library call, bytes and flops at
    ``d``, with q pre-scaled by D**-0.5 and multiplied back by sqrt(D) as
    on the model path.  Bytes: q and o over H heads, k and v over KV heads;
    flops: both products over the keys each query sees."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    b, sq, sk, h, kv, dh, dv, causal = shape_key("flash_attention", d)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    q, k, v = rnd(b, sq, h, dh, scale=dh ** -0.5), rnd(b, sk, kv, dh), rnd(b, sk, kv, dv)
    q_scale = dh ** 0.5
    # the library call takes (B, heads, S, D); the same function with K8's
    # q multiplier folded into its scale
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_scale = float(torch.tensor(q_scale, dtype=torch.bfloat16)) * dh ** -0.5
    ops, bytes_ = kernel_cost("flash_attention", flash_dims(shape_key("flash_attention", d)))
    return dict(kernel=lambda: flash_attention(q, k, v, causal=causal, q_scale=q_scale),
                plain=lambda: ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                          q_scale=q_scale),
                library=lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=lib_scale, enable_gqa=True),
                bytes=bytes_, ops=ops, err=row_rel_err)


def phase_flash_kernels(shapes, iters: int = KERNEL_ITERS):
    """K8 at each shape against its plain version, timed beside it and
    ``F.scaled_dot_product_attention`` (a yardstick the port never calls)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = _flush_buffer()
    rows = [check_and_time("flash_attention", d, flash_kernel_case(d, gen), iters, flush,
                           H100_SPECS.peak_flops) for d in shapes]
    zero_counts()
    return rows


def phase_flash_serve():
    """``ServeEngine.serve`` of a Poisson trace of long prompts with
    ``attention_impl="flash"``; K8 launches counted per prefill and decode
    forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve, steps
    from repro_torch.serving import ServeConfig, ServeEngine

    run = _with_impl(serve.serve_run(get_config("smollm-360m"), max_len=FLASH_MAX_LEN, slots=8,
                                     lrd=True, device=torch.device("cuda"), seed=0), "flash")
    params, _ = steps.init_params(run, "cuda")
    engine = ServeEngine(run, params, device="cuda",
                         config=ServeConfig(num_slots=8, max_len=FLASH_MAX_LEN,
                                            prefill_len=FLASH_PROMPT, block_size=16))
    sched = engine.scheduler
    k8_per = {"prefill": [], "decode": []}

    def counted(kind, step):
        def call(*args, **kw):
            before = flash_attention.launches
            out = step(*args, **kw)
            k8_per[kind].append(flash_attention.launches - before)
            return out
        return call

    sched._prefill = counted("prefill", sched._prefill)
    sched._decode = counted("decode", sched._decode)
    trace = serve.poisson_trace(16, 1000.0, FLASH_PROMPT, run.model.vocab_size, seed=0)
    for r in trace:
        r["max_new"] = FLASH_NEW
    zero_counts()
    t0 = time.perf_counter()
    outs = engine.serve(trace)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers().items()}
    by_shape = counts_by_shape()
    fwd = sched.forward_stats
    n_fwd = fwd["prefill"] + fwd["decode"]
    n_layers = run.model.num_layers
    if len(outs) != 16 or any(len(o) != FLASH_NEW for o in outs):
        raise AssertionError(f"flash serve: want 16 requests x {FLASH_NEW} tokens, got "
                             f"{[len(o) for o in outs]}")
    if fwd["nonfinite"]:
        raise AssertionError(f"flash serve: {fwd['nonfinite']} forwards with non-finite logits")
    want = {"lowrank_matmul": 5 * n_layers * n_fwd, "lowrank_gated_ffn": n_layers * n_fwd,
            "flash_attention": n_layers * fwd["prefill"]}
    got = {k: n for k, n in counts.items() if n or k in want}
    if (n_fwd == 0 or got != want or len(k8_per["prefill"]) != fwd["prefill"]
            or set(k8_per["prefill"]) != {n_layers} or set(k8_per["decode"]) != {0}):
        raise AssertionError(f"flash serve: {fwd['prefill']} prefill + {fwd['decode']} decode "
                             f"forwards launched {got}, want {want}; K8 per prefill "
                             f"{sorted(set(k8_per['prefill']))}, per decode "
                             f"{sorted(set(k8_per['decode']))} (want {n_layers} and 0)")
    if set(by_shape["flash_attention"]) != {shape_key("flash_attention", FLASH_SERVE_SHAPE)}:
        raise AssertionError(f"flash serve: K8 shapes {sorted(by_shape['flash_attention'])}")
    stats = sched.latency_stats()
    log(f"[flash serve] {len(outs)} requests (prompts {min(len(r['prompt']) for r in trace)}-"
        f"{max(len(r['prompt']) for r in trace)} tokens, padded to {FLASH_PROMPT}), "
        f"{int(stats['generated_tokens'])} tokens, {stats['tok_per_s']:.1f} tok/s on "
        f"{torch.cuda.get_device_name(0)}; {fwd['prefill']} prefill + {fwd['decode']} decode "
        f"forwards; K8 {n_layers} per prefill, 0 per decode forward; {counts['lowrank_matmul']} "
        f"K1 + {counts['lowrank_gated_ffn']} K5 = {5 * n_layers} + {n_layers} per forward; "
        f"latency p50 {stats['p50_latency_s'] * 1e3:.0f} ms, p95 "
        f"{stats['p95_latency_s'] * 1e3:.0f} ms, first-token p50 "
        f"{stats['p50_first_token_s'] * 1e3:.0f} ms; {dt:.1f}s")
    return engine, by_shape, dict(fwd=dict(fwd), counts=counts, stats=stats, wall_s=dt)


def _long_prompt(run, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, run.model.vocab_size, (1, FLASH_PROMPT), generator=gen,
                         device="cuda", dtype=torch.int32)


def _with_impl(run, impl: str):
    import dataclasses

    return dataclasses.replace(run, model=dataclasses.replace(run.model, attention_impl=impl))


def _greedy_with_logits(run, params, prompt, n: int):
    """n greedy tokens of ``prompt`` (1, L) through a fresh one-slot engine,
    with the logits each token was picked from (the prefill's last position,
    then each decode step's)."""
    from repro_torch.serving import ServeConfig, ServeEngine

    eng = ServeEngine(run, params, device="cuda",
                      config=ServeConfig(num_slots=1, max_len=FLASH_MAX_LEN,
                                         prefill_len=FLASH_PROMPT))
    sched, seen = eng.scheduler, []

    def keep(step, pick):
        def call(*args, **kw):
            out = step(*args, **kw)
            seen.append(pick(out).float().reshape(-1).clone())
            return out
        return call

    sched._prefill = keep(sched._prefill, lambda out: out[0])
    sched._decode = keep(sched._decode, lambda out: out[0][:, -1])
    return eng.generate(prompt, max_new=n)[0].tolist(), seen


def _held_while_agreeing(a_toks, a_logits, b_toks, b_logits, what: str):
    """Hold two greedy runs' logits within PATH_RTOL while their token
    histories agree; returns the steps agreed, the worst step's relative
    difference and the first parting step (None if all agree) with b's
    top-2 gap there: a perturbation within the bound can flip the argmax
    only where that gap is below twice the perturbation."""
    agree, worst, flip = 0, 0.0, None
    for i, (a, b) in enumerate(zip(a_toks, b_toks)):
        e_i, r_i = rel_err(a_logits[i], b_logits[i])
        worst = max(worst, r_i)
        if not torch.isfinite(a_logits[i]).all() or r_i > PATH_RTOL:
            raise AssertionError(f"flash parity: {what} greedy step {i} logits on the same "
                                 f"history differ by {e_i:.3e} ({r_i:.3e} of max |logit|) "
                                 f"> {PATH_RTOL}")
        if a != b:
            top2 = torch.topk(b_logits[i], 2).values
            flip = dict(step=i, gap=(top2[0] - top2[1]).item(), max_abs_diff=e_i)
            break
        agree += 1
    return dict(agree=agree, worst_step_rel=worst, flip=flip)


def phase_flash_parity(engine):
    """One 2016-token prefill through K8 against the model's default
    attention (the port's torch code, not K8's plain version), and 8 greedy
    tokens through a one-slot engine for each of FLASH_PARITY_SEEDS' prompts
    three ways: through K8, through the same flash path with K8 swapped for
    its plain version on the card (a second witness: the TPU kernel's
    arithmetic without the kernel), and blockwise.  Each pair's logits must
    agree within PATH_RTOL while their token histories agree; where the
    tokens part, the step and the reference's top-2 gap are reported (random
    weights make near-ties common)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps

    run = engine.run
    base = _with_impl(run, "blockwise")
    tokens = _long_prompt(run, seed=FLASH_PARITY_SEEDS[0])
    last = torch.tensor([FLASH_PROMPT - 1], device="cuda")
    got, _ = steps.build_slot_prefill_step(run)(engine.params, {"tokens": tokens}, last)
    want, _ = steps.build_slot_prefill_step(base)(engine.params, {"tokens": tokens}, last)
    err, rel = rel_err(got, want)
    if not torch.isfinite(got).all() or rel > PATH_RTOL:
        raise AssertionError(f"flash parity: last-position logits differ by {err:.3e} "
                             f"({rel:.3e} of max |logit|) > {PATH_RTOL}")
    log(f"[flash parity] {FLASH_PROMPT}-token prefill, last-position logits flash vs "
        f"blockwise: max_abs_diff {err:.3e} ({rel:.3e} of max |logit| "
        f"{want.abs().max().item():.3f}; bound {PATH_RTOL})")
    out = dict(max_abs_diff=err, rel=rel, seeds={})
    for seed in FLASH_PARITY_SEEDS:
        prompt = _long_prompt(run, seed=seed).cpu().numpy()
        ft, fl = _greedy_with_logits(run, engine.params, prompt, 8)
        before = flash_attention.launches
        with plain_versions(flash_attention=ref.flash_attention_fwd_ref):
            pt, pl = _greedy_with_logits(run, engine.params, prompt, 8)
        if flash_attention.launches != before:
            raise AssertionError("flash parity: the plain-version run launched K8")
        bt, bl = _greedy_with_logits(base, engine.params, prompt, 8)
        if {len(fl), len(pl), len(bl)} != {8}:
            raise AssertionError(f"flash parity: {len(fl)} / {len(pl)} / {len(bl)} forwards "
                                 f"for 8 tokens")
        pairs = {"K8 vs blockwise": (ft, fl, bt, bl), "plain vs blockwise": (pt, pl, bt, bl),
                 "K8 vs plain": (ft, fl, pt, pl)}
        res = {what: _held_while_agreeing(*args, what) for what, args in pairs.items()}
        out["seeds"][seed] = dict(res, greedy=ft, greedy_plain=pt, greedy_blockwise=bt)
        log(f"[flash parity] prompt seed {seed}: " + "; ".join(
            f"{what} {r['agree']}/8 agree, logits within {r['worst_step_rel']:.3e} of max "
            f"|logit| on the same history"
            + (f", part at step {r['flip']['step']} (top-2 gap {r['flip']['gap']:.3e}, "
               f"max_abs_diff {r['flip']['max_abs_diff']:.3e})" if r["flip"] else "")
            for what, r in res.items()) + f" (K8 {ft}, plain {pt}, blockwise {bt})")
    return out


def phase_prefill_profile(engine, steps_n: int = 3):
    """Wall time, device time by kernel and idle share of one full-width
    2016-token prefill, flash (K8) and blockwise."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    tokens = _long_prompt(engine.run, seed=2)
    batch, last = {"tokens": tokens}, torch.tensor([FLASH_PROMPT - 1], device="cuda")
    out = {}
    for impl in ("flash", "blockwise"):
        step = steps.build_slot_prefill_step(_with_impl(engine.run, impl))
        step(engine.params, batch, last)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps_n):
            step(engine.params, batch, last)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps_n * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps_n):
                step(engine.params, batch, last)
            torch.cuda.synchronize()
        by_name = device_ms_by_kernel(prof, steps_n)
        device_ms = sum(by_name.values())
        k8_ms = sum(ms for name, ms in by_name.items() if "flash_wgmma_kernel" in name)
        k1_ms, k5_ms = lowrank_device_ms(by_name)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[impl] = dict(wall_ms=wall_ms, device_ms=device_ms if device_ms else None,
                         idle_share=(1 - device_ms / wall_ms) if device_ms else None,
                         k8_ms=k8_ms, k8_share=k8_ms / device_ms if device_ms else None,
                         k1_ms=k1_ms, k5_ms=k5_ms,
                         top=[dict(name=k[:80], ms=v) for k, v in top])
        shown = ", ".join(f"{k[:40]} {v:.2f}ms" for k, v in top[:6])
        log(f"[prefill profile] {impl}, {FLASH_PROMPT} tokens, {engine.run.model.num_layers} "
            f"layers: wall {wall_ms:.2f} ms, "
            + (f"device {device_ms:.2f} ms, idle {out[impl]['idle_share']:.1%}, K8 "
               f"{k8_ms:.2f} ms ({out[impl]['k8_share']:.1%} of device), K1 {k1_ms:.2f} ms, "
               f"K5 {k5_ms:.2f} ms; top: {shown}"
               if device_ms else "device time not measured (profiler saw no device events)"))
    return out


# --------------------------------------------------------------------------
# The paper's conv and ViT path (Tables 1, 2 and 4)
# --------------------------------------------------------------------------

RESNETS = ("resnet50", "resnet101", "resnet152")
RESNET_CLASSES, IMG = 1000, 224
STAGE_C = (64, 128, 256, 512)
# Eq.-5 r1 of each stage's 3x3 conv (C = S = 64, 128, 256, 512) at alpha 2
STAGE_R1 = (38, 77, 154, 309)
# |the card's float32 Tucker-2 error - a float64 HOSVD's| / ||W||^2 of one
# 3x3 conv a stage: float32 Gram matrices, eigh and sums differ from float64
# by ~4e-8 of ||W||^2 on the CPU at these shapes, while keeping a wrong
# direction at the cut moves the error by ~1e-3
TUCKER_ERR_TOL = 1e-5
# ResNet-50 at 224 x 224, batch 4, the card against the port's own CPU run,
# both float32 (TF32 off): cuDNN's algorithms (implicit GEMM, Winograd, FFT)
# round otherwise than oneDNN's, by ~1e-5 of a conv's output at most, and
# 53 convs carry it; logits relative to max |logit|, the mean loss relative.
# Gradients: each trainable leaf by ||diff|| / ||grad||.  At random init a
# leaf's gradient sums B x H x W products that nearly cancel, which
# amplifies the per-op float32 differences (each conv's output and
# gradients within ~2e-5 of float64 on the H100; test_torch_conv_gpu.py
# holds them to 1e-4 of the CPU's, TF32 on around the call) to a few 1e-3
# of a leaf's largest entry (the stem kernel's, H100); 1e-2 of its norm
# fails a wrong or missing gradient
RESNET_LOGITS_RTOL = 1e-3
RESNET_LOSS_RTOL = 1e-4
RESNET_GRAD_RTOL = 1e-2
PARITY_B = 4
# the Table-1 and Table-4 ladders: batch, timed steps (median), warm-up
# steps (cuDNN's autotuning included), profiled steps
LADDER_B, LADDER_STEPS, LADDER_WARM, PROFILE_STEPS = 64, 10, 3, 3
# SGD step sizes of benchmarks/table1_resnet_throughput.py and table4_vit.py
RESNET_LR, VIT_LR = 1e-3, 3e-3
# ViT-B/16: vit_init's defaults (10 classes)
VIT_B16 = dict(num_layers=12, d=768, heads=12, d_ff=3072, patch=16, img=224,
               num_classes=10)
SEQ_PHASES = (0, 0, 1, 1, 0, 0)
# the ladder's methods also trained at phase 1 (their other frozen group)
PHASE1_METHODS = ("freeze", "combined")


# the benchmarks' method ladder (benchmarks/common.py:18-27): method ->
# (tree: dense, or decomposed by the lrd or rankopt policy of
# ``_ladder_policies``; freezing phase)
LADDER = {"org": ("org", -1), "lrd": ("lrd", -1), "rankopt": ("rankopt", -1),
          "freeze": ("lrd", 0), "combined": ("rankopt", 0)}


def _ladder_policies(base):
    """The ladder's policies at alpha 2: Eq.-5 ranks (lrd) and Algorithm 1
    (rankopt)."""
    return {"lrd": base.with_alpha(2.0).with_quantize(False).with_min_dim(32),
            "rankopt": base.with_alpha(2.0).with_quantize(True).with_min_dim(32)}


def _vit_policy():
    """The ViT policy of benchmarks/table4_vit.py:19-26: the FFN FC layers
    and the patch embedding, SVD."""
    from repro_torch.core.policy import DecompositionPolicy, Rule

    return DecompositionPolicy(name="vit-ffn", rules=(
        Rule(r"(norm|bias|pos_emb|cls|head)", "none"),
        Rule(r"(wi|down|patch_embed)", "svd", min_dim=32),
        Rule(r".*", "none")))


def _live(params):
    """Copies of ``params`` that autograd differentiates."""
    from repro_torch.core.freezing import tree_map

    return tree_map(lambda t: t.detach().clone().requires_grad_(), params)


def _cls_step(live, apply, phase: int, lr: float):
    """The benchmarks' classification train step
    (benchmarks/table1_resnet_throughput.py:25-36, table4_vit.py:30-39) on
    the ``_live`` tree: cross-entropy of ``apply(params, x)``; at phase >= 0
    ``apply_freeze`` detaches the frozen factor group, so autograd computes
    no gradient for it (cuDNN is never asked for a frozen conv's weight
    gradient); SGD ``p - lr g`` in place on the rest.  ``step(x, y)``
    returns (loss, {path: grad or None})."""
    from repro_torch.core import freezing
    from repro_torch.models.common import cross_entropy
    from repro_torch.models.resnet import fp32_convs

    view = freezing.apply_freeze(live, freezing.freeze_mask(live, phase)) if phase >= 0 else live
    leaves = dict(_grad_paths(live))

    def step(x, y):
        with fp32_convs():  # a conv's backward reads the flag when it runs
            loss = cross_entropy(apply(view, x), y)
            loss.backward()
        grads = {path: t.grad for path, t in leaves.items()}
        got = [t for t in leaves.values() if t.grad is not None]
        with torch.no_grad():
            torch._foreach_add_(got, [t.grad for t in got], alpha=-lr)
        for t in got:
            t.grad = None
        return loss.detach(), grads

    return step


def _frozen_paths(tree, phase: int):
    from repro_torch.core.freezing import freeze_mask

    return {path for path, keep in _grad_paths(freeze_mask(tree, phase)) if not keep}


def _check_frozen(label: str, tree, phase: int, grads) -> int:
    """Every leaf of the frozen group without a gradient and every other
    leaf with one; returns the number of frozen leaves."""
    frozen = _frozen_paths(tree, phase)
    for path, g in grads.items():
        if (g is None) != (path in frozen):
            raise AssertionError(f"{label}: phase {phase} {path} "
                                 + ("frozen but has a gradient" if g is not None
                                    else "trainable but has no gradient"))
    return len(frozen)


def _hosvd64_error(w, r1: int, r2: int) -> float:
    """||W - HOSVD(W)||^2 in float64 (numpy) of a (C, S, k, k) weight."""
    import numpy as np

    c, s = w.shape[:2]
    m0, m1 = w.reshape(c, -1), np.moveaxis(w, 1, 0).reshape(s, -1)
    u = np.linalg.eigh(m0 @ m0.T)[1][:, ::-1][:, :r1]
    v = np.linalg.eigh(m1 @ m1.T)[1][:, ::-1][:, :r2]
    core = np.einsum("cskl,cp,sq->pqkl", w, u, v, optimize=True)
    rec = np.einsum("cp,pqkl,sq->cskl", u, core, v, optimize=True)
    return float(np.sum((w - rec) ** 2))


def _init_path(path: str) -> str:
    """The init-time plan's name of a ResNet tree path (``s1b0/conv3x3`` ->
    ``stage1/block0/conv3x3``)."""
    head, _, rest = path.partition("/")
    if head[0] == "s" and "b" in head and rest:
        si, bi = head[1:].split("b")
        return f"stage{si}/block{bi}/{rest}"
    return path


def _seeded(seed: int, device="cuda"):
    return torch.Generator(device=device).manual_seed(seed)


def phase_conv_decompose():
    """Paper Table 2: ``apply_lrd`` of dense ResNet-50/101/152 (1000
    classes, float32, seeded) under ``RESNET_DEFAULT`` at the ladder's LRD
    (Eq. 5) and RankOpt (Algorithm 1) policies, timed on the card; the plan
    equal to the init-time ``Decomposer``'s, layer counts, each stage's 3x3
    r1, and ResNet-50's Tucker-2 error on one 3x3 conv a stage against a
    float64 HOSVD on the CPU.  Returns (results, ResNet-50's dense tree,
    its decomposed trees by method)."""
    import dataclasses

    from repro_torch.core import tucker
    from repro_torch.core.decompose import Decomposer, apply_lrd
    from repro_torch.core.freezing import tree_leaves
    from repro_torch.core.policy import NO_LRD, RESNET_DEFAULT
    from repro_torch.models import resnet

    policies = _ladder_policies(RESNET_DEFAULT)
    eq5_r1 = tuple(tucker.tucker_rank_for_compression(c, c, 3, 2.0)[0] for c in STAGE_C)
    if eq5_r1 != STAGE_R1:
        raise AssertionError(f"conv decompose: Eq.-5 r1 {eq5_r1}, expected {STAGE_R1}")
    torch.linalg.svd(torch.ones((64, 64), device="cuda"))  # cuSOLVER's set-up, untimed
    torch.linalg.eigh(torch.eye(64, device="cuda"))
    torch.cuda.synchronize()
    out, dense50, trees50 = {}, None, {}
    for variant in RESNETS:
        dense = resnet.resnet_init(variant, RESNET_CLASSES,
                                   Decomposer(NO_LRD, dtype=torch.float32, device="cuda",
                                              generator=_seeded(0)))
        n_params = sum(t.numel() for t in tree_leaves(dense))
        out[variant] = dict(params=n_params)
        for name, policy in policies.items():
            layout = Decomposer(policy, dtype=torch.float32, device="meta")
            resnet.resnet_init(variant, RESNET_CLASSES, layout)  # the init-time plan, no data
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, plan = apply_lrd(dense, policy)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            renamed = {_init_path(p): dataclasses.replace(lp, path=_init_path(p))
                       for p, lp in plan.layers.items()}
            if renamed != layout.plan.layers:
                raise AssertionError(f"conv decompose: {variant} {name} plan differs from the "
                                     f"init-time Decomposer's")
            kept = [lp for lp in plan.layers.values() if lp.use_decomposed]
            counts = {m: sum(lp.method == m for lp in kept) for m in ("tucker", "svd")}
            stage = [plan.layers[f"s{si}b0/conv3x3"] for si in range(4)]
            if tuple(lp.eq5_rank for lp in stage) != STAGE_R1:
                raise AssertionError(f"conv decompose: {variant} {name} stage r1 "
                                     f"{[lp.eq5_rank for lp in stage]}, expected {STAGE_R1}")
            n_tree = sum(t.numel() for t in tree_leaves(tree))
            out[variant][name] = dict(seconds=secs, **counts,
                                      dense_kept=len(plan.layers) - len(kept),
                                      stage_r1=[lp.rank for lp in stage], params=n_tree)
            log(f"[conv decompose] {variant} ({n_params / 1e6:.1f} M params, float32) "
                f"apply_lrd at {name} ({'Algorithm 1' if name == 'rankopt' else 'Eq. 5'}): "
                f"{secs:.3f} s; {counts['tucker']} Tucker, {counts['svd']} SVD, "
                f"{len(plan.layers) - len(kept)} kept dense by the guard; stage 3x3 r1 "
                f"{[lp.rank for lp in stage]} (Eq. 5: {list(STAGE_R1)}); "
                f"{n_tree / 1e6:.1f} M params after")
            if variant == "resnet50":
                trees50[name] = tree
            del tree
        if variant == "resnet50":
            dense50 = dense
        del dense
    errs = []
    for si, c in enumerate(STAGE_C):
        g = trees50["lrd"][f"s{si}b0"]["conv3x3"]
        w = dense50[f"s{si}b0"]["conv3x3"]["kernel"].permute(2, 3, 0, 1)  # (C, S, k, k)
        r1, r2 = g["first"].shape[1], g["last"].shape[0]
        card = tucker.tucker_reconstruction_error(w, g["first"], g["core"].permute(2, 3, 0, 1),
                                                  g["last"]).item()
        ref = _hosvd64_error(w.double().cpu().numpy(), r1, r2)
        norm = torch.sum(w.double() ** 2).item()
        diff = abs(card - ref) / norm
        errs.append(dict(c=c, r1=r1, err=card / norm, err64=ref / norm, diff=diff))
        if not diff <= TUCKER_ERR_TOL:
            raise AssertionError(f"conv decompose: stage {si} 3x3 Tucker-2 error {card / norm:.6f} "
                                 f"of ||W||^2 against float64 {ref / norm:.6f} (bound "
                                 f"{TUCKER_ERR_TOL})")
    out["tucker_error"] = errs
    log("[conv decompose] resnet50 one 3x3 a stage, ||W - first.core.last||^2 / ||W||^2 on the "
        f"card against a float64 HOSVD on the CPU (bound {TUCKER_ERR_TOL} on the difference): "
        + ", ".join(f"C {e['c']} r1 {e['r1']}: {e['err']:.6f} vs {e['err64']:.6f} "
                    f"({e['diff']:.1e})" for e in errs))
    return out, dense50, trees50


def phase_resnet_parity(dense, eq5):
    """ResNet-50 at 224 x 224, batch 4, on the card against the port's own
    CPU run: logits of the dense and Eq.-5 trees; one train step of the
    Eq.-5 tree at phases -1 and 0 (loss, every trainable leaf's gradient,
    no gradient on group 0: u, first, last)."""
    import functools

    from repro_torch.core.freezing import tree_map
    from repro_torch.models import resnet

    apply = functools.partial(resnet.resnet_apply, variant="resnet50")
    x = torch.randn((PARITY_B, IMG, IMG, 3), generator=_seeded(11, "cpu"))
    y = torch.randint(0, RESNET_CLASSES, (PARITY_B,), generator=_seeded(12, "cpu"))
    out = {}
    for name, tree in (("dense", dense), ("eq5", eq5)):
        host = tree_map(lambda t: t.cpu(), tree)
        with torch.no_grad():
            got = apply(tree, x.cuda()).cpu()
            want = apply(host, x)
        diff, rel = rel_err(got, want)
        out[name] = dict(max_abs=diff, rel=rel, max_logit=want.abs().max().item())
        log(f"[resnet parity] resnet50 {name} logits ({IMG} x {IMG}, batch {PARITY_B}): card vs "
            f"CPU max |diff| {diff:.3e}, {rel:.2e} of max |logit| (bound {RESNET_LOGITS_RTOL})")
        if not rel <= RESNET_LOGITS_RTOL:
            raise AssertionError(f"resnet parity: {name} logits {rel:.3e} of max |logit| apart")
    host = tree_map(lambda t: t.cpu(), eq5)
    host64 = tree_map(lambda t: t.double(), host)
    for phase in (-1, 0):
        loss_c, grads_c = _cls_step(_live(eq5), apply, phase, RESNET_LR)(x.cuda(), y.cuda())
        loss_h, grads_h = _cls_step(_live(host), apply, phase, RESNET_LR)(x, y)
        n_frozen = _check_frozen("resnet parity (card)", eq5, phase, grads_c)
        _check_frozen("resnet parity (CPU)", eq5, phase, grads_h)
        if phase == -1:  # every leaf has a gradient; the float64 step is slow on the CPU
            _, grads_64 = _cls_step(_live(host64), apply, phase, RESNET_LR)(x.double(), y)
            out["float64"] = _float64_distances(phase, grads_c, grads_h, grads_64)
        loss_rel = abs(loss_c.item() - loss_h.item()) / abs(loss_h.item())
        worst, worst_path, worst_max = 0.0, "", 0.0  # by norm; the largest entry's too
        for path, g in grads_c.items():
            if g is None:
                continue
            want = grads_h[path].double()
            diff = g.cpu().double() - want
            rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
            worst_max = max(worst_max, (diff.abs().max() / want.abs().max()).item())
            if not rel <= worst:
                worst, worst_path = rel, path
        out[f"phase{phase}"] = dict(loss_card=loss_c.item(), loss_cpu=loss_h.item(),
                                    loss_rel=loss_rel, worst_grad_rel=worst,
                                    worst_leaf=worst_path, worst_grad_max_rel=worst_max,
                                    frozen_leaves=n_frozen)
        log(f"[resnet parity] eq5 train step phase {phase}: loss card {loss_c.item():.6f} vs "
            f"CPU {loss_h.item():.6f} ({loss_rel:.1e}, bound {RESNET_LOSS_RTOL}); worst leaf "
            f"grad ||diff|| / ||grad|| {worst:.2e} ({worst_path}, bound {RESNET_GRAD_RTOL}; "
            f"largest entry's max |diff| / max |grad| {worst_max:.2e}); {n_frozen} frozen "
            f"leaves without a gradient")
        if not (loss_rel <= RESNET_LOSS_RTOL and worst <= RESNET_GRAD_RTOL):
            raise AssertionError(f"resnet parity: phase {phase} loss {loss_rel:.3e} or "
                                 f"{worst_path} grad {worst:.3e} apart")
    return out


def _float64_distances(phase: int, grads_c, grads_h, grads_64):
    """The card's and the CPU's float32 gradients, each against the same
    step in float64 on the CPU: ||g - g64|| / ||g64|| and max |g - g64| /
    max |g64|, for the stem kernel and for the leaf farthest from float64
    on the card.  Which side the card-vs-CPU difference comes from."""
    def dist(g, want):
        d = g.cpu().double() - want
        return ((d.norm() / want.norm().clamp_min(1e-300)).item(),
                (d.abs().max() / want.abs().max().clamp_min(1e-300)).item())

    rows = {path: dict(card=dist(g, grads_64[path]), cpu=dist(grads_h[path], grads_64[path]))
            for path, g in grads_c.items() if g is not None}
    stem = next(p for p in rows if "conv_stem" in p)
    worst = max(rows, key=lambda p: rows[p]["card"][0])
    for label, path in (("stem", stem), ("worst on the card", worst)):
        r = rows[path]
        log(f"[resnet parity] phase {phase} {label} gradient ({path}) against float64 on the "
            f"CPU: card ||diff||/||g64|| {r['card'][0]:.3e} (max entry {r['card'][1]:.3e}), "
            f"CPU float32 {r['cpu'][0]:.3e} (max entry {r['cpu'][1]:.3e})")
    return dict(stem=stem, stem_dist=rows[stem], worst_leaf=worst, worst_dist=rows[worst])


# device kernels of cuDNN's convs and cuBLAS / CUTLASS GEMMs, by name; the
# rest of a conv or ViT step is torch's elementwise and reduction kernels
# (folded BN, ReLU, residual adds, softmax, norms, the SGD update)
LIBRARY_KERNELS = ("cudnn", "xmma", "gemm", "cutlass", "wgrad", "dgrad", "fprop", "winograd",
                   "convolve")


def _measure(fn):
    """``fn()`` as one step: the median host time over LADDER_STEPS
    synchronised steps after LADDER_WARM, the device time per step
    (``torch.profiler``, device-side events) over PROFILE_STEPS, its part in
    convs and GEMMs (``LIBRARY_KERNELS``), and the device's idle share of
    the median step."""

    for _ in range(LADDER_WARM):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(LADDER_STEPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall_ms = sorted(times)[len(times) // 2] * 1e3

    def run():
        for _ in range(PROFILE_STEPS):
            fn()
        torch.cuda.synchronize()

    prof = profiled(run)
    by_name = device_ms_by_kernel(prof, PROFILE_STEPS)
    device_ms = sum(by_name.values())
    if not device_ms:
        raise AssertionError("the profiler saw no device events")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    library_ms = sum(ms for name, ms in by_name.items()
                     if any(key in name.lower() for key in LIBRARY_KERNELS))
    return dict(wall_ms=wall_ms, device_ms=device_ms, idle_share=1 - device_ms / wall_ms,
                conv_gemm_ms=library_ms, top=[dict(name=k[:80], ms=v) for k, v in top])


def phase_ladder(label: str, trees, apply, x, y, lr: float):
    """One table's method ladder (``LADDER``): each method's tree (``trees``
    by org / lrd / rankopt) trained at its phase (``_cls_step``) and run
    forward (no grad), each ``_measure``d; images/s from the median step.
    PHASE1_METHODS are also trained at phase 1.  cuDNN picks its
    algorithms by timing them (``cudnn.benchmark``), as a user training a
    conv net would set it."""
    from repro_torch.models.resnet import fp32_convs

    b = x.shape[0]
    methods = [(m, tree_name, phase) for m, (tree_name, phase) in LADDER.items()]
    methods += [(f"{m} (phase 1)", LADDER[m][0], 1) for m in PHASE1_METHODS]
    rows, base = [], None
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for method, tree_name, phase in methods:
            params = trees[tree_name]
            step = _cls_step(_live(params), apply, phase, lr)
            train = _measure(lambda: step(x, y))
            row = dict(method=method, tree=tree_name, phase=phase, train=train,
                       train_img_s=b / train["wall_ms"] * 1e3)
            if phase != 1:
                def infer():
                    with torch.no_grad(), fp32_convs():
                        apply(params, x)
                row["infer"] = _measure(infer)
                row["infer_img_s"] = b / row["infer"]["wall_ms"] * 1e3
            if base is None:
                base = row
            row["train_vs_org"] = row["train_img_s"] / base["train_img_s"] - 1
            if "infer" in row:
                row["infer_vs_org"] = row["infer_img_s"] / base["infer_img_s"] - 1
            rows.append(row)
            t, i = row["train"], row.get("infer")
            log(f"[{label}] {method:<19} tree {tree_name:<7} phase {phase:>2}: train "
                f"{row['train_img_s']:7.1f} img/s ({row['train_vs_org']:+.1%}; wall "
                f"{t['wall_ms']:.2f} ms, device {t['device_ms']:.2f} ms of which convs and "
                f"GEMMs {t['conv_gemm_ms']:.2f}, idle {t['idle_share']:.1%})"
                + (f"; inference {row['infer_img_s']:7.1f} img/s ({row['infer_vs_org']:+.1%}; "
                   f"wall {i['wall_ms']:.2f} ms, device {i['device_ms']:.2f} ms of which convs "
                   f"and GEMMs {i['conv_gemm_ms']:.2f}, idle {i['idle_share']:.1%})"
                   if i else "")
                + "; train top: " + ", ".join(f"{k['name'][:40]} {k['ms']:.2f}ms"
                                            for k in t["top"][:3]))
            del step
    finally:
        torch.backends.cudnn.benchmark = prev
    return rows


def _resnet_macs(tree, variant: str, img: int):
    """(multiply-adds, activation elements written) an image by the convs
    of a ResNet tree as ``conv_apply`` computes them (a Tucker triple's
    first factor at the input's resolution, an SVD pair after the
    subsampling); the fc is left out."""
    from repro_torch.models.resnet import STAGES

    macs = act = 0

    def conv(p, h, stride):
        nonlocal macs, act
        out = -(-h // stride)
        if "kernel" in p:
            kh, kw, c, s = p["kernel"].shape
            macs, act = macs + out * out * kh * kw * c * s, act + out * out * s
        elif "first" in p:
            (c, r1), (kh, kw, _, r2), s = p["first"].shape, p["core"].shape, p["last"].shape[1]
            macs += h * h * c * r1 + out * out * (kh * kw * r1 * r2 + r2 * s)
            act += h * h * r1 + out * out * (r2 + s)
        else:
            (c, r), s = p["u"].shape, p["v"].shape[1]
            macs, act = macs + out * out * r * (c + s), act + out * out * (r + s)
        return out

    h = -(-conv(tree["conv_stem"], img, 2) // 2)  # the stem, then the 3x3/2 max-pool
    for si, blocks in enumerate(STAGES[variant]):
        for bi in range(blocks):
            p, stride = tree[f"s{si}b{bi}"], (2 if bi == 0 and si > 0 else 1)
            conv(p["conv1x1_a"], h, 1)
            out = conv(p["conv3x3"], h, stride)
            conv(p["conv1x1_b"], out, 1)
            if "shortcut" in p:
                conv(p["shortcut"], h, stride)
            h = out
    return macs, act


def _vit_macs(tree, img: int, patch: int):
    """(multiply-adds an image, the FFNs' share) of a ViT tree: every
    projection (dense or SVD pair), the attention products, the head."""
    n = (img // patch) ** 2 + 1

    def proj(p):
        if "kernel" in p:
            return p["kernel"].shape[-2] * p["kernel"].shape[-1]
        return p["u"].shape[-1] * (p["u"].shape[-2] + p["v"].shape[-1])

    blocks = tree["blocks"]
    n_layers, d = blocks["norm1"]["scale"].shape
    ffn = n * (proj(blocks["wi"]) + proj(blocks["down"]))
    attn = n * (sum(proj(blocks[k]) for k in ("wq", "wk", "wv", "wo")) + 2 * n * d)
    macs = (n - 1) * proj(tree["patch_embed"]) + n_layers * (ffn + attn) + proj(tree["head"])
    return macs, n_layers * ffn / macs


def phase_table1(dense, trees):
    """Paper Table 1: ResNet-50 (224 x 224, batch 64, 1000 classes,
    float32) over org / lrd / rankopt / freeze / combined, on the trees of
    ``phase_conv_decompose``."""
    import functools

    from repro_torch.models import resnet

    counts = {k: _resnet_macs(t, "resnet50", IMG) for k, t in dict(org=dense, **trees).items()}
    (m0, a0) = counts["org"]
    log(f"[table1 resnet50] convs a {IMG} x {IMG} image: " + ", ".join(
        f"{k} {m / 1e9:.3f} GMAC ({m / m0:.3f}x), activations {a / a0:.2f}x"
        for k, (m, a) in counts.items()))
    x = torch.randn((LADDER_B, IMG, IMG, 3), generator=_seeded(21), device="cuda")
    y = torch.randint(0, RESNET_CLASSES, (LADDER_B,), generator=_seeded(22), device="cuda")
    return phase_ladder("table1 resnet50", dict(org=dense, **trees),
                        functools.partial(resnet.resnet_apply, variant="resnet50"), x, y,
                        RESNET_LR)


def phase_table4():
    """Paper Table 4: ViT-B/16 (12 layers, d 768, 12 heads, d_ff 3072, patch
    16, 224 x 224, 10 classes, float32) at batch 64, the ViT policy, over the
    same ladder."""
    import functools

    from repro_torch.core.decompose import Decomposer, apply_lrd
    from repro_torch.core.freezing import tree_leaves
    from repro_torch.core.policy import NO_LRD
    from repro_torch.models import vit

    cfg = dict(VIT_B16)
    dense = vit.vit_init(Decomposer(NO_LRD, dtype=torch.float32, device="cuda",
                                    generator=_seeded(1)), **cfg)
    trees = dict(org=dense)
    for name, policy in _ladder_policies(_vit_policy()).items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trees[name], plan = apply_lrd(dense, policy)
        torch.cuda.synchronize()
        log(f"[table4 vit-b/16] apply_lrd at {name}: {time.perf_counter() - t0:.3f} s, "
            f"{plan.summary()}, ranks "
            + ", ".join(f"{p} {lp.rank}" for p, lp in plan.layers.items()))
    log("[table4 vit-b/16] params: " + ", ".join(
        f"{k} {sum(t.numel() for t in tree_leaves(v)) / 1e6:.1f} M" for k, v in trees.items()))
    counts = {k: _vit_macs(t, cfg["img"], cfg["patch"]) for k, t in trees.items()}
    log(f"[table4 vit-b/16] an image: " + ", ".join(
        f"{k} {m / 1e9:.3f} GMAC ({m / counts['org'][0]:.3f}x, FFNs {share:.0%})"
        for k, (m, share) in counts.items()))
    x = torch.randn((LADDER_B, cfg["img"], cfg["img"], 3), generator=_seeded(31), device="cuda")
    y = torch.randint(0, cfg["num_classes"], (LADDER_B,), generator=_seeded(32), device="cuda")
    return phase_ladder("table4 vit-b/16", trees,
                        functools.partial(vit.vit_apply, heads=cfg["heads"],
                                          patch=cfg["patch"]), x, y, VIT_LR)


def phase_sequential(tree):
    """Algorithm 2 on ResNet-50 combined: 6 steps at batch 64, phases
    0,0,1,1,0,0, on ``SyntheticClassification(img=224)``: finite losses, and
    at each step no gradient on the frozen group."""
    import functools

    from repro_torch.data import SyntheticClassification
    from repro_torch.models import resnet

    apply = functools.partial(resnet.resnet_apply, variant="resnet50")
    data = SyntheticClassification(img=IMG, batch=LADDER_B)
    live = _live(tree)
    losses, frozen = [], []
    t0 = time.perf_counter()
    for i, phase in enumerate(SEQ_PHASES):
        xb, yb = data.next_batch()
        loss, grads = _cls_step(live, apply, phase, RESNET_LR)(
            torch.from_numpy(xb).cuda(), torch.from_numpy(yb).cuda())
        frozen.append(_check_frozen(f"sequential step {i}", live, phase, grads))
        losses.append(loss.item())
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"sequential: step {i} loss {losses[-1]}")
    torch.cuda.synchronize()
    log(f"[sequential] resnet50 combined, batch {LADDER_B}, phases {list(SEQ_PHASES)}: losses "
        + ", ".join(f"{l:.4f}" for l in losses) + f"; frozen leaves without a gradient per "
        f"step {frozen}; {time.perf_counter() - t0:.1f} s incl. data")
    return dict(phases=list(SEQ_PHASES), losses=losses, frozen_leaves=frozen)


def phase_conv():
    """The conv and ViT phases, in order; returns their results."""
    out = {}
    out["conv_decompose"], dense50, trees50 = phase_conv_decompose()
    out["resnet_parity"] = phase_resnet_parity(dense50, trees50["lrd"])
    out["table1"] = phase_table1(dense50, trees50)
    out["sequential"] = phase_sequential(trees50["rankopt"])
    del dense50, trees50
    out["table4"] = phase_table4()
    return out


# --------------------------------------------------------------------------
# Serving features (phases 25-28): speculative decoding, the radix prefix
# cache, int8 KV pools and the fixed-batch path
# --------------------------------------------------------------------------


def draft_projections():
    """(C, r, S) by projection of the draft ``draft_rank_map`` derives from
    the Eq.-5 tree at SPEC_FRACTION (it reads shapes only: a meta tree)."""
    from repro_torch.serving import speculative

    tree = {"stack": {leaf: {"u": torch.empty((1, c, r), device="meta"),
                             "v": torch.empty((1, r, s_), device="meta")}
                      for proj, (c, r, s_) in PROJ.items() for leaf in proj.split("/")}}
    ranks = speculative.draft_rank_map(tree, fraction=SPEC_FRACTION)
    return {proj: (c, ranks[f"stack/{proj.split('/')[0]}"], s_)
            for proj, (c, r, s_) in PROJ.items()}


def serving_shapes():
    """(name, dims) of the K1/K5 calls phases 25-28 add: the verify chunk at
    M = 8 (k + 1), the derived draft's ranks at M = 8, the extend step and
    the prefix trace's prefill at M = PREFIX_PREFILL, and the fixed-batch
    prefill at M = FIXED_B x FIXED_T."""
    out = []
    full_ms = [DECODE_M * (k + 1) for k in SPEC_KS] + [PREFIX_PREFILL, FIXED_B * FIXED_T]
    for proj, ms in ((PROJ, full_ms), (draft_projections(), [DECODE_M])):
        for m in ms:
            for name in ("wq/wo", "wk/wv", "down"):
                c, r, s_ = proj[name]
                out.append(("lowrank_matmul", dict(M=m, C=c, r=r, S=s_)))
            c, r, f = proj["gate/up"]
            out.append(("lowrank_gated_ffn", dict(M=m, C=c, r=r, F=f)))
    return out


def phase_row_bits():
    """Whether K1 and K5's decode design give a row the same bits at M = 8
    and inside the verify chunk's M = 8 (k + 1): the 8 rows first, then the
    same 8 rows last among random others.  Reported, not required: it says
    whether a verify can part from plain decode through K1/K5 at all."""
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    gen = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    out = {}
    for proj, (c, r, s_) in PROJ.items():
        x8 = rnd(DECODE_M, c)
        if proj == "gate/up":
            w = (rnd(c, r, scale=c ** -0.5), rnd(r, s_, scale=r ** -0.5),
                 rnd(c, r, scale=c ** -0.5), rnd(r, s_, scale=r ** -0.5))
            fn = lambda x, w=w: lowrank_gated_ffn(x, *w)  # noqa: E731
        else:
            w = (rnd(c, r, scale=c ** -0.5), rnd(r, s_, scale=r ** -0.5))
            fn = lambda x, w=w: lowrank_matmul(x, *w)  # noqa: E731
        want = fn(x8)
        for k in SPEC_KS:
            other = rnd(DECODE_M * k, c)
            first = fn(torch.cat([x8, other]))[:DECODE_M]
            last = fn(torch.cat([other, x8]))[-DECODE_M:]
            out[f"{proj} M {DECODE_M * (k + 1)}"] = (torch.equal(first, want)
                                                     and torch.equal(last, want))
    zero_counts()
    same = sorted(k for k, v in out.items() if v)
    log(f"[row bits] K1/K5 decode design, a row at M {DECODE_M} against the same row inside "
        f"M {', '.join(str(DECODE_M * (k + 1)) for k in SPEC_KS)} (first and last rows): "
        f"bitwise equal at {len(same)}/{len(out)}"
        + (f"; differ at {sorted(set(out) - set(same))}" if len(same) < len(out) else ""))
    # the verify's other row-wise ops at its shapes: decode attention over
    # a 176-position cache (query 0 of a k+1 chunk against the one-query
    # step) and the tied float32 unembedding (M = 8 rows inside 8 (k + 1))
    from repro_torch.models.attention import dense_attention
    from repro_torch.models.common import dot32

    t, emb = PREFILL_M + SPEC_NEW + 1, rnd(_vocab(), 960)
    q1 = rnd(DECODE_M, max(SPEC_KS) + 1, 15, 64)
    kv = (rnd(DECODE_M, t, 5, 64), rnd(DECODE_M, t, 5, 64))
    lens = torch.randint(1, t - max(SPEC_KS), (DECODE_M,), generator=gen, device="cuda")
    h8 = rnd(DECODE_M, 960)
    ops = {}
    for k in SPEC_KS:
        chunk = lens[:, None] + torch.arange(k + 1, device="cuda")[None, :]
        one = dense_attention(q1[:, :1], *kv, causal=False, kv_len=lens[:, None])
        ops[f"attention Sq {k + 1}"] = torch.equal(
            dense_attention(q1[:, :k + 1], *kv, causal=False, kv_len=chunk)[:, :1], one)
        ops[f"unembedding M {DECODE_M * (k + 1)}"] = torch.equal(
            dot32(torch.cat([h8, rnd(DECODE_M * k, 960)]), emb.T)[:DECODE_M], dot32(h8, emb.T))
    log("[row bits] a row's bits against the plain decode step's: "
        + ", ".join(f"{name} {'equal' if ok else 'differ'}" for name, ok in ops.items()))
    out.update(ops)
    return out


def _full_run(max_len: int, kv_dtype: str = "bfloat16", int8_decode: str = "native"):
    """The serve CLI's run (full-width smollm-360m at SERVING_LAYERS of its
    32 layers, LRD at Eq.-5 ranks, kernels on, 8 slots) with a ``max_len``
    window and a KV dtype."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    run = serve.serve_run(get_config("smollm-360m"), max_len=max_len, slots=DECODE_M,
                          lrd=True, device=torch.device("cuda"), seed=0)
    return dataclasses.replace(
        run, model=dataclasses.replace(run.model, kv_cache_dtype=kv_dtype,
                                       num_layers=SERVING_LAYERS),
        lrd=dataclasses.replace(run.lrd, int8_decode=int8_decode))


def _vocab() -> int:
    from repro_torch.configs import get_config

    return get_config("smollm-360m").vocab_size


def _plain(run):
    import dataclasses

    return dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, use_pallas_kernel=False))


def _record_logits(sched):
    """Keep, for every token the scheduler emits, the logits it was picked
    from (float32, on the card): rid -> list of (V,) tensors.  Also keeps,
    for every draft token a verify rejects in an active slot, the verify's
    logit margin of its own token over the draft's there (``rec[None]``)."""
    from repro_torch.serving import speculative

    rec, cur = {None: []}, {}

    def wrap(step, kind):
        def call(*args, **kw):
            out = step(*args, **kw)
            cur.update(kind=kind, out=out, n={})
            if kind == "verify":
                chunk, nxt, logits = args[2], out[1], out[2]
                ns = speculative.accept_lengths(chunk.cpu().numpy(), nxt.cpu().numpy())
                for i, n in enumerate(ns.tolist()):
                    if sched.slots[i].active and n < chunk.shape[1] - 1:
                        row = logits[i, n].float()
                        rec[None].append((row[nxt[i, n]] - row[chunk[i, n + 1]]).item())
            return out
        return call

    for name in ("_prefill", "_decode", "_verify", "_extend"):
        if getattr(sched, name) is not None:
            setattr(sched, name, wrap(getattr(sched, name), name[1:]))
    emit = sched._emit

    def recording_emit(slot, tok):
        idx = next(i for i, s in enumerate(sched.slots) if s is slot)
        n = cur["n"].get(idx, 0)
        cur["n"][idx] = n + 1
        out, req = cur["out"], slot.req
        pick = {"prefill": lambda: out[0][0], "decode": lambda: out[0][idx, -1],
                "verify": lambda: out[2][idx, n],
                "extend": lambda: out[2][0, req.prompt.size - req.prefix_hit_len - 1]}
        rec.setdefault(req.rid, []).append(pick[cur["kind"]]().float().clone())
        emit(slot, tok)

    sched._emit = recording_emit
    return rec


def _compare_greedy(ref_toks, ref_logits, toks, logits, what: str, tie_rule: bool = True,
                    rtol=PATH_RTOL):
    """Hold a run's greedy tokens to a reference run's, request by request:
    while their histories agree the logits must lie within ``rtol`` of the
    reference's (None: only reported), and where tokens part, the
    reference's top-2 gap there must be below the largest |logit
    difference| of the two runs at that position (a rounding tie), unless
    ``tie_rule`` is off (then the parting is only reported).  Returns a
    summary."""
    parted, worst, worst_abs = [], 0.0, 0.0
    for rid, (a, b) in enumerate(zip(ref_toks, toks)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: request {rid} has {len(b)} tokens, want {len(a)}")
        for j, (ta, tb) in enumerate(zip(a, b)):
            diff, rel = rel_err(logits[rid][j], ref_logits[rid][j])
            if not torch.isfinite(logits[rid][j]).all() or (rtol is not None and rel > rtol):
                raise AssertionError(f"{what}: request {rid} token {j} logits on the same "
                                     f"history differ by {diff:.3e} ({rel:.3e} of max |logit|)")
            if ta != tb:
                top2 = torch.topk(ref_logits[rid][j], 2).values
                gap = (top2[0] - top2[1]).item()
                parted.append(dict(request=rid, token=j, gap=gap, max_abs_diff=diff))
                if tie_rule and not gap < diff:
                    raise AssertionError(f"{what}: request {rid} parts at token {j} with a "
                                         f"top-2 gap {gap:.3e} >= the runs' max |logit "
                                         f"difference| {diff:.3e} there: not a rounding tie")
                break
            worst, worst_abs = max(worst, rel), max(worst_abs, diff)
    return dict(identical=len(ref_toks) - len(parted), requests=len(ref_toks), parted=parted,
                worst_logit_rel=worst, worst_logit_abs=worst_abs)


def _parted_text(cmp):
    return (f"tokens identical in {cmp['identical']}/{cmp['requests']} requests"
            + "".join(f"; request {p['request']} parts at token {p['token']} (top-2 gap "
                      f"{p['gap']:.3e}, max |logit diff| {p['max_abs_diff']:.3e})"
                      for p in cmp["parted"])
            + f"; logits within {cmp['worst_logit_abs']:.3e} ({cmp['worst_logit_rel']:.2e} of "
              f"max |logit|) on agreeing histories")


def _by_m(by_shape, name):
    """Launches of one kernel by M."""
    out = {}
    for key, n in by_shape[name].items():
        out[key[0]] = out.get(key[0], 0) + n
    return out


def _wall_device(fn, steps: int = 5):
    """Wall ms per call (host clock around synchronised calls), device ms
    per call (``torch.profiler`` device events) and idle share of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    device_ms = sum(device_ms_by_kernel(prof, steps).values()) or None
    zero_counts()
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=(1 - device_ms / wall_ms) if device_ms else None)


def _ms_text(prof):
    return (f"wall {prof['wall_ms']:.2f} ms, device "
            + (f"{prof['device_ms']:.2f} ms (idle {prof['idle_share']:.1%})"
               if prof["device_ms"] else "not measured"))


def _serve_trace(engine, trace):
    """Serve ``trace`` with the launch counters zeroed before; returns
    (tokens per request, logits per request, launches by shape, stats,
    forward counts, seconds, the verify's margins over rejected draft
    tokens)."""
    sched = engine.scheduler
    rec = _record_logits(sched)
    zero_counts()
    t0 = time.perf_counter()
    outs = engine.serve(trace)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_shape = counts_by_shape()
    fwd = dict(sched.forward_stats)
    if fwd["nonfinite"]:
        raise AssertionError(f"serve: {fwd['nonfinite']} forwards with non-finite logits")
    toks = [o.tokens.tolist() for o in outs]
    if any(len(t) != r["max_new"] for t, r in zip(toks, trace)):
        raise AssertionError(f"serve: token counts {[len(t) for t in toks]}")
    return (toks, [rec[o.rid] for o in outs], by_shape, sched.latency_stats(), fwd, dt,
            rec[None])


def _check_forward_launches(what, by_shape, n_layers, per_m):
    """Exactly 5 K1 and 1 K5 launches a layer for each forward, by M:
    ``per_m`` maps M -> forwards at that M; no launch at any other M."""
    want1 = {m: 5 * n_layers * n for m, n in per_m.items() if n}
    want5 = {m: n_layers * n for m, n in per_m.items() if n}
    got1, got5 = _by_m(by_shape, "lowrank_matmul"), _by_m(by_shape, "lowrank_gated_ffn")
    if got1 != want1 or got5 != want5:
        raise AssertionError(f"{what}: K1 launches by M {got1}, want {want1}; K5 {got5}, "
                             f"want {want5}")


def phase_spec_serve(params):
    """Phase 25: phase 4's 16-request trace with SPEC_NEW new tokens, plain
    and self-speculative at k in SPEC_KS with the draft = the params
    (acceptance 1.0) and at SPEC_DRAFT_KS with the draft ``draft_rank_map``
    derives; tokens held to the plain run's, K1/K5 launches exact by M,
    and wall and device ms of a speculative step beside a plain one."""
    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_mod
    from repro_torch.serving import ServeConfig, ServeEngine

    run = _full_run(PREFILL_M + SPEC_NEW)
    n_layers = run.model.num_layers
    trace = serve.poisson_trace(16, 1000.0, PREFILL_M, run.model.vocab_size, seed=0)
    for r in trace:
        r["max_new"] = SPEC_NEW
    base = dict(num_slots=DECODE_M, max_len=PREFILL_M + SPEC_NEW, prefill_len=PREFILL_M,
                block_size=16)
    zeros_t = torch.zeros((DECODE_M, 1), dtype=torch.int32, device="cuda")
    zeros_p = torch.zeros((DECODE_M,), dtype=torch.int32, device="cuda")
    out = dict(row_bits=phase_row_bits())
    engine = ServeEngine(run, params, device="cuda", config=ServeConfig(**base))
    ref_toks, ref_logits, by_shape, stats, fwd, dt, _ = _serve_trace(engine, trace)
    _check_forward_launches("spec serve (plain)", by_shape, n_layers,
                            {PREFILL_M: fwd["prefill"], DECODE_M: fwd["decode"]})
    decode = steps_mod.build_serve_step(run)
    prof = _wall_device(lambda: decode(params, engine.scheduler.cache, zeros_t, zeros_p))
    out["plain"] = dict(tok_per_s=stats["tok_per_s"], wall_s=dt, fwd=fwd, step=prof)
    log(f"[spec serve] plain: 16 requests x {SPEC_NEW} tokens, {stats['tok_per_s']:.1f} tok/s "
        f"on {torch.cuda.get_device_name(0)}; {fwd['decode']} decode steps; a decode step "
        f"{_ms_text(prof)}; {dt:.1f}s")
    del engine
    paths = {"spec serve plain": by_shape}
    for k, draft in [(k, "params") for k in SPEC_KS] + [(k, "derived") for k in SPEC_DRAFT_KS]:
        label = f"k={k}, draft={draft}"
        engine = ServeEngine(run, params, device="cuda",
                             config=ServeConfig(**base, speculative_k=k,
                                                spec_fraction=SPEC_FRACTION),
                             draft_params=params if draft == "params" else None)
        sched = engine.scheduler
        if draft == "derived":
            rep, by_geom = engine.draft_report, {}
            for path, ranks in sorted(rep.layers.items()):
                by_geom.setdefault(path.split("/")[-1], ranks)
            out[f"draft ranks k={k}"] = by_geom
            log(f"[spec serve] derived draft (fraction {SPEC_FRACTION}): "
                + ", ".join(f"{g} {r0}->{r1}" for g, (r0, r1) in by_geom.items())
                + f"; {rep.truncated} groups truncated, {rep.shared} shared")
        toks, logits, by_shape, stats, fwd, dt, margins = _serve_trace(engine, trace)
        if fwd["decode"] or fwd["draft"] != k * fwd["verify"]:
            raise AssertionError(f"spec serve {label}: forwards {fwd}")
        _check_forward_launches(f"spec serve {label}", by_shape, n_layers,
                                {PREFILL_M: fwd["prefill"], DECODE_M: fwd["draft"],
                                 DECODE_M * (k + 1): fwd["verify"]})
        acc = sched.acceptance_rate()
        cmp = _compare_greedy(ref_toks, ref_logits, toks, logits, f"spec serve {label}")
        # the draft = the params: a draft step is a decode step, so a
        # rejection can only be a rounding tie between the draft's M = 8
        # forward and the verify's M = 8 (k + 1) one: the verify's margin of
        # its token over the draft's below the runs' largest |logit diff|
        if draft == "params" and any(not m < cmp["worst_logit_abs"] for m in margins):
            raise AssertionError(f"spec serve {label}: acceptance {acc}; rejected draft "
                                 f"tokens with verify margins {sorted(margins)[-3:]} >= "
                                 f"{cmp['worst_logit_abs']:.3e}: not rounding ties")
        draft_chain = steps_mod.build_draft_chain(run, k)
        verify = steps_mod.build_verify_step(run)

        def spec_step():
            cache, chunk = draft_chain(sched.draft_params, sched.cache, zeros_t, zeros_p)
            return verify(params, cache, chunk, zeros_p)

        prof = _wall_device(spec_step, steps=3)
        st = dict(sched.spec_stats)
        out[label] = dict(tok_per_s=stats["tok_per_s"], wall_s=dt, fwd=fwd, acceptance=acc,
                          spec_stats=st, step=prof, compare=cmp, reject_margins=margins,
                          tokens_per_slot_step=st["emitted"] * k / max(st["drafted"], 1))
        paths[f"spec serve {label}"] = by_shape
        log(f"[spec serve] {label}: {stats['tok_per_s']:.1f} tok/s (plain "
            f"{out['plain']['tok_per_s']:.1f}); acceptance {acc:.4f} ({len(margins)} "
            f"slot-steps rejected a draft"
            + (f", verify margins {min(margins):.3e}-{max(margins):.3e}" if margins else "")
            + f"), {st['spec_steps']} "
            f"speculative steps, {out[label]['tokens_per_slot_step']:.2f} tokens a slot a "
            f"step; a speculative step (k drafts + verify) {_ms_text(prof)}; K1 launches by M "
            f"{_by_m(by_shape, 'lowrank_matmul')}; {_parted_text(cmp)}; {dt:.1f}s")
        del engine, sched
    return paths, out


def phase_prefix_serve(params):
    """Phase 26: ``shared_prefix_trace`` (16 requests, a PREFIX_LEN-token
    prefix, 1..PREFIX_SUFFIX-token suffixes, 16-position blocks) with
    PREFIX_NEW new tokens, uncached and cached: fewer prefilled tokens with
    the cache, hits in whole blocks, the extend step's K1/K5 at M =
    PREFIX_PREFILL, tokens held to the uncached run's; TTFT p50 of both."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServeConfig, ServeEngine

    run = _full_run(PREFIX_PREFILL + PREFIX_NEW)
    n_layers = run.model.num_layers
    trace = serve.shared_prefix_trace(16, 1000.0, PREFIX_LEN, PREFIX_SUFFIX,
                                      run.model.vocab_size, seed=0)
    for r in trace:
        r["max_new"] = PREFIX_NEW
    out, paths, runs = {}, {}, {}
    for cached in (False, True):
        name = "cached" if cached else "uncached"
        engine = ServeEngine(run, params, device="cuda", config=ServeConfig(
            num_slots=DECODE_M, max_len=PREFIX_PREFILL + PREFIX_NEW,
            prefill_len=PREFIX_PREFILL, block_size=16, prefix_cache=cached))
        toks, logits, by_shape, stats, fwd, dt, _ = _serve_trace(engine, trace)
        _check_forward_launches(f"prefix serve ({name})", by_shape, n_layers,
                                {PREFIX_PREFILL: fwd["prefill"] + fwd["extend"],
                                 DECODE_M: fwd["decode"]})
        if fwd["extend"] > stats["prefix_hits"] or (fwd["extend"] == 0) == cached:
            raise AssertionError(f"prefix serve ({name}): {fwd['extend']} extend forwards, "
                                 f"{stats['prefix_hits']} hits")
        runs[name] = (toks, logits)
        paths[f"prefix serve {name}"] = by_shape
        out[name] = dict(stats=stats, fwd=fwd, wall_s=dt)
        log(f"[prefix serve] {name}: {int(stats['prefix_hits'])}/"
            f"{int(stats['prefix_lookups'])} hits, {int(stats['prefix_hit_tokens'])} prompt "
            f"tokens reused, {int(stats['prefill_tokens'])} prefilled; {fwd['prefill']} prefill "
            f"+ {fwd['extend']} extend forwards at M {PREFIX_PREFILL}; TTFT p50 "
            f"{stats['p50_first_token_s'] * 1e3:.1f} ms, p95 "
            f"{stats['p95_first_token_s'] * 1e3:.1f} ms; {stats['tok_per_s']:.1f} tok/s on "
            f"{torch.cuda.get_device_name(0)}; {dt:.1f}s")
        del engine
    on, off = out["cached"]["stats"], out["uncached"]["stats"]
    if not (on["prefill_tokens"] < off["prefill_tokens"] and on["prefix_hits"] > 0
            and on["prefix_hit_tokens"] % 16 == 0):
        raise AssertionError(f"prefix serve: cached {on['prefill_tokens']} prefilled tokens "
                             f"against {off['prefill_tokens']}, {on['prefix_hits']} hits, "
                             f"{on['prefix_hit_tokens']} hit tokens")
    out["compare"] = _compare_greedy(*runs["uncached"], *runs["cached"], "prefix serve")
    log(f"[prefix serve] cached against uncached: {_parted_text(out['compare'])}")
    return paths, out


def _pool_bytes(cache):
    """Bytes of a paged cache's pools (every stack's), page tables left out."""
    return sum(t.numel() * t.element_size() for stack in cache.values()
               for n, t in stack.items() if n != "page_table")


def _teacher_forced(run, params, prompts, teacher, contiguous: bool = False):
    """Last-position logits of KV_STEPS decode steps fed ``teacher``'s
    tokens after a prefill of ``prompts`` (B, T): through B paged slots (a
    pool of ``run.model.kv_cache_dtype``), or through one contiguous
    ``lm.init_cache`` cache with the prefill's KV written in (quantized for
    int8) and one position for every row.  Returns (logits, cache)."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import kvcache as kvq
    from repro_torch.models import lm
    from repro_torch.serving import paged_cache as pc

    cfg = run.model
    b, t = prompts.shape
    decode = steps_mod.build_serve_step(run)
    if contiguous:
        _, pre = steps_mod.build_prefill_step(run)(params, {"tokens": prompts})
        cache = lm.init_cache(cfg, b, t + KV_STEPS, device="cuda")
        for layer in range(cfg.num_layers):
            view = {n: leaf[layer] for n, leaf in cache["stack"].items()}
            k_pre, v_pre = pre["stack"]["k"][layer], pre["stack"]["v"][layer]
            if "k_scale" in view:
                kvq.update_quantized_kv(view, k_pre, v_pre, torch.zeros((), dtype=torch.long))
            else:
                view["k"][:, :t] = k_pre
                view["v"][:, :t] = v_pre
        positions = [torch.tensor(t + i, device="cuda") for i in range(KV_STEPS)]
    else:
        mb = pc.blocks_for(t + KV_STEPS, 16)
        cache = pc.init_paged_cache(cfg, b, 1 + b * mb, 16, mb, "cuda")
        table = (1 + torch.arange(b * mb, dtype=torch.int32)).reshape(b, mb).numpy()
        pc.with_page_table(cache, table)
        prefill = steps_mod.build_slot_prefill_step(run)
        for i in range(b):
            _, pre = prefill(params, {"tokens": prompts[i:i + 1]},
                             torch.tensor([t - 1], device="cuda"))
            pc.insert_prefill_paged(cache, pre, torch.from_numpy(table[i]).to("cuda"))
        positions = [torch.full((b,), t + i, dtype=torch.int32, device="cuda")
                     for i in range(KV_STEPS)]
    out = []
    for i in range(KV_STEPS):
        logits, cache, _ = decode(params, cache, teacher[:, i:i + 1], positions[i])
        out.append(logits[:, -1].float())
    zero_counts()
    return out, cache


def phase_int8_kv(params):
    """Phase 27: int8 KV pools (``kv_cache_dtype="int8"``) in both
    ``int8_decode`` modes: pool bytes exactly (hd + 2) / (2 hd) of bf16's,
    KV_STEPS teacher-forced decode steps' logits within KV_RTOL of the bf16
    pools', phase 4's trace served (K1/K5 exact), and a decode step
    profiled as in phase 6."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServeConfig, ServeEngine

    gen = torch.Generator(device="cuda").manual_seed(9)
    vocab = _vocab()
    prompts = torch.randint(0, vocab, (DECODE_M, PREFILL_M), generator=gen, device="cuda",
                            dtype=torch.int32)
    teacher = torch.randint(0, vocab, (DECODE_M, KV_STEPS), generator=gen, device="cuda",
                            dtype=torch.int32)
    bf16_run = _full_run(PREFILL_M + 32)
    want, bf16_cache = _teacher_forced(bf16_run, params, prompts, teacher)
    bf16_bytes = _pool_bytes(bf16_cache)
    del bf16_cache
    hd = bf16_run.model.resolved_head_dim
    trace = serve.poisson_trace(16, 1000.0, PREFILL_M, vocab, seed=0)
    for r in trace:
        r["max_new"] = 32
    out, paths = {}, {}
    for mode in ("native", "bf16"):
        run = _full_run(PREFILL_M + 32, kv_dtype="int8", int8_decode=mode)
        got, cache = _teacher_forced(run, params, prompts, teacher)
        n_bytes = _pool_bytes(cache)
        if n_bytes * 2 * hd != bf16_bytes * (hd + 2):
            raise AssertionError(f"int8 kv: pool bytes {n_bytes} against bf16 {bf16_bytes}, "
                                 f"want exactly {hd + 2}/{2 * hd}")
        del cache
        rels = [rel_err(g, w)[1] for g, w in zip(got, want)]
        if not all(math.isfinite(r) and r < KV_RTOL for r in rels):
            raise AssertionError(f"int8 kv ({mode}): teacher-forced logits {rels} of max "
                                 f"|logit| from the bf16 pools' (bound {KV_RTOL})")
        engine = ServeEngine(run, params, device="cuda", config=ServeConfig(
            num_slots=DECODE_M, max_len=PREFILL_M + 32, prefill_len=PREFILL_M, block_size=16))
        toks, _, by_shape, stats, fwd, dt, _ = _serve_trace(engine, trace)
        _check_forward_launches(f"int8 kv ({mode})", by_shape, run.model.num_layers,
                                {PREFILL_M: fwd["prefill"], DECODE_M: fwd["decode"]})
        if engine.scheduler.cache["stack"]["k"].dtype != torch.int8:
            raise AssertionError("int8 kv: the served pools are not int8")
        prof = phase_profile(engine, label=f"int8 KV ({mode}) decode step")
        paths[f"int8 kv {mode}"] = by_shape
        out[mode] = dict(pool_bytes=n_bytes, bf16_pool_bytes=bf16_bytes,
                         pool_ratio=n_bytes / bf16_bytes, teacher_rel=rels,
                         tok_per_s=stats["tok_per_s"], wall_s=dt, profile=prof, tokens=toks)
        log(f"[int8 kv] {mode}: pools {n_bytes / 2 ** 20:.2f} MiB = {n_bytes / bf16_bytes:.6f} "
            f"of bf16's {bf16_bytes / 2 ** 20:.2f} MiB ({hd + 2}/{2 * hd}); {KV_STEPS} "
            f"teacher-forced steps' logits within {max(rels):.3e} of max |logit| of the bf16 "
            f"pools' (last step {rels[-1]:.3e}, bound {KV_RTOL}); serve "
            f"{stats['tok_per_s']:.1f} tok/s on {torch.cuda.get_device_name(0)}, {dt:.1f}s")
        del engine
    agree = sum(a == b for a, b in zip(out["native"]["tokens"], out["bf16"]["tokens"]))
    log(f"[int8 kv] native and bf16 modes: {agree}/16 requests with identical tokens")
    return paths, out


def _generate_with_logits(run, params, prompts, n: int, extras=None):
    """``ServeEngine(num_slots=0).generate`` of ``prompts`` (with an enc-dec
    model's ``extras``) with the logits each row's tokens were picked from:
    (tokens, per row a list of (V,))."""
    from repro_torch.serving import ServeConfig, ServeEngine

    engine = ServeEngine(run, params, device="cuda",
                         config=ServeConfig(num_slots=0, max_len=prompts.shape[1] + n))
    seen = []
    prefill, step = engine._prefill, engine._step

    def keep_prefill(*args):
        out = prefill(*args)
        seen.append(out[0].float().clone())
        return out

    def keep_step(*args):
        out = step(*args)
        seen.append(out[0][:, -1].float().clone())
        return out

    engine._prefill, engine._step = keep_prefill, keep_step
    toks = engine.generate(prompts.cpu().numpy(), max_new=n, extras=extras)
    return toks.tolist(), [[s[i] for s in seen] for i in range(prompts.shape[0])]


def phase_fixed_batch(params):
    """Phase 28: ``ServeEngine(num_slots=0).generate`` on FIXED_B x FIXED_T
    prompts, FIXED_NEW new tokens, with bf16 and with int8 KV configs (the
    fixed path keeps the prefill's own cache, as the reference does): the
    prefill's K1 at M = FIXED_B x FIXED_T, decode at M = FIXED_B, held
    against the same path through the plain versions on the card as in
    phase 5; then KV_STEPS teacher-forced steps through an int8
    ``lm.init_cache`` cache (both modes) within KV_RTOL of a bf16 one."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    prompts = torch.randint(0, _vocab(), (FIXED_B, FIXED_T), generator=gen, device="cuda",
                            dtype=torch.int32)
    out, paths = {}, {}
    for kv in ("bfloat16", "int8"):
        run = _full_run(FIXED_T + FIXED_NEW, kv_dtype=kv)
        zero_counts()
        t0 = time.perf_counter()
        toks, logits = _generate_with_logits(run, params, prompts, FIXED_NEW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        by_shape = counts_by_shape()
        _check_forward_launches(f"fixed batch ({kv})", by_shape, run.model.num_layers,
                                {FIXED_B * FIXED_T: 1, FIXED_B: FIXED_NEW - 1})
        ptoks, plogits = _generate_with_logits(_plain(run), params, prompts, FIXED_NEW)
        zero_counts()
        diff, rel = rel_err(torch.stack([r[0] for r in logits]),
                            torch.stack([r[0] for r in plogits]))
        if rel > PATH_RTOL:
            raise AssertionError(f"fixed batch ({kv}): prefill logits {rel:.3e} of max |logit| "
                                 f"from the plain versions'")
        cmp = _compare_greedy(ptoks, plogits, toks, logits, f"fixed batch ({kv})",
                              tie_rule=False)
        paths[f"fixed batch {kv}"] = by_shape
        out[kv] = dict(prefill_max_abs=diff, prefill_rel=rel, compare=cmp, wall_s=dt,
                       tok_per_s=FIXED_B * FIXED_NEW / dt)
        log(f"[fixed batch] {kv}: {FIXED_B} x {FIXED_T} prompts, {FIXED_NEW} tokens in "
            f"{dt:.2f}s ({out[kv]['tok_per_s']:.1f} tok/s on {torch.cuda.get_device_name(0)}); "
            f"K1 launches by M {_by_m(by_shape, 'lowrank_matmul')}; kernels against plain "
            f"versions: prefill logits {rel:.2e} of max |logit|, {_parted_text(cmp)}")
    teacher = prompts[:, :KV_STEPS]
    want, _ = _teacher_forced(_full_run(FIXED_T + KV_STEPS), params, prompts, teacher,
                              contiguous=True)
    for mode in ("native", "bf16"):
        got, cache = _teacher_forced(_full_run(FIXED_T + KV_STEPS, kv_dtype="int8",
                                               int8_decode=mode),
                                     params, prompts, teacher, contiguous=True)
        if cache["stack"]["k"].dtype != torch.int8:
            raise AssertionError("fixed batch: the contiguous cache is not int8")
        rels = [rel_err(g, w)[1] for g, w in zip(got, want)]
        if not all(math.isfinite(r) and r < KV_RTOL for r in rels):
            raise AssertionError(f"fixed batch: int8 contiguous cache ({mode}) logits {rels}")
        out[f"int8 contiguous {mode}"] = dict(teacher_rel=rels)
        log(f"[fixed batch] int8 contiguous cache ({mode}), {KV_STEPS} teacher-forced steps: "
            f"logits within {max(rels):.3e} of max |logit| of the bf16 cache's (bound "
            f"{KV_RTOL})")
    return paths, out


def phase_serving_features():
    """Phases 25-28 on one seeded full-width Eq.-5 tree; returns (launches
    by kernel and shape per main path, results)."""
    from repro_torch.launch import steps as steps_mod

    params, _ = steps_mod.init_params(_full_run(PREFILL_M + 32), "cuda")
    paths, result = {}, {}
    for key, phase in (("spec_serve", phase_spec_serve), ("prefix_serve", phase_prefix_serve),
                       ("int8_kv", phase_int8_kv), ("fixed_batch", phase_fixed_batch)):
        p, result[key] = phase(params)
        paths.update(p)
    return paths, result


# --------------------------------------------------------------------------
# The MoE family: full-width OLMoE-1B-7B (phases 29-35)
# --------------------------------------------------------------------------

# OLMoE-1B-7B at full width and depth (16 layers, d 2048, 16 heads of 128,
# 64 experts of d_ff 1024, top-8, qk-norm, moe_impl "ep"), LRD at Eq.-5
# ranks: attention 512, experts 341.  Serve: phase 4's trace (16 requests,
# 8 slots, prompts padded to 128, 32 new tokens).  Train: phase 7's run,
# sequential freezing at phases 0,0,1,1,0,0 over 8 x 256 tokens.  The
# remat step: 8 x 1024 tokens with remat "full" and no freezing.
MOE_ARCH, MOE_LAYERS, MOE_EXPERTS = "olmoe-1b-7b", 16, 64
MOE_ATTN = dict(C=2048, r=512, S=2048)
MOE_SERVE_ARGV = ["--arch", MOE_ARCH] + SERVE_ARGV[2:]
MOE_TRAIN_ARGV = ["--arch", MOE_ARCH] + TRAIN_ARGV[2:]
MOE_LONG_SEQ = 1024
MOE_LONG_ARGV = ["--arch", MOE_ARCH, "--lrd", "--no-rank-opt", "--use-pallas", "--freeze",
                 "none", "--remat", "full", "--steps", "1", "--global-batch", "8",
                 "--seq-len", str(MOE_LONG_SEQ), "--save-every", "1000", "--log-every", "1"]
# K1-K4 a train step: q, k, v and o of 16 layers forward (K1) and backward
# (K2 always, K3 unless u is frozen, K4 unless v is); no K5 (no dense FFN)
MOE_TRAIN_LAUNCHES = {"lowrank_matmul": 64, "lowrank_matmul_dx": 64,
                      "lowrank_matmul_du": {-1: 64, 0: 0, 1: 64},
                      "lowrank_matmul_dv": {-1: 64, 0: 64, 1: 0}}


def moe_kernel_shapes():
    """(name, dims) of every K1-K4 call on the MoE paths: K1 at the decode,
    prefill, train and remat-step M; K2-K4 at the train and remat-step M."""
    out = [("lowrank_matmul", dict(M=m, **MOE_ATTN))
           for m in (DECODE_M, PREFILL_M, TRAIN_M, 8 * MOE_LONG_SEQ)]
    out += [(name, dict(M=m, **MOE_ATTN)) for name in BWD for m in (TRAIN_M, 8 * MOE_LONG_SEQ)]
    return out


def _moe_key(m):
    return m, MOE_ATTN["C"], MOE_ATTN["r"], MOE_ATTN["S"]


@contextlib.contextmanager
def routing(record=None, replay=None):
    """Patch the port's MoE router (here only, never on the main path):
    with ``record`` every call appends its (ids, float32 logits); with
    ``replay`` (a list of such pairs) call i routes to the recorded ids of
    call i, its weights and aux computed from this run's own logits."""
    import torch.nn.functional as Fn

    from repro_torch.models import moe
    from repro_torch.models.common import dot32

    orig = moe._router
    calls = iter(replay) if replay is not None else None

    def router(p, xf, cfg):
        if calls is None:
            topw, topi, aux = orig(p, xf, cfg)
            if record is not None:
                with torch.no_grad():
                    record.append((topi.clone(), dot32(xf, p["router"]["kernel"]).float()))
            return topw, topi, aux
        ids = next(calls)[0]
        probs = torch.softmax(dot32(xf, p["router"]["kernel"]), dim=-1)
        topw = torch.gather(probs, 1, ids)
        topw = topw / torch.clamp(torch.sum(topw, dim=-1, keepdim=True), min=1e-9)
        e = cfg.num_experts
        ce = torch.mean(torch.sum(Fn.one_hot(ids[:, 0], e).to(probs.dtype), dim=0)
                        / max(xf.shape[0], 1), dim=0)
        return topw, ids, e * torch.sum(torch.mean(probs, dim=0) * ce)

    moe._router = router
    try:
        yield
    finally:
        moe._router = orig


def routing_flips(kernel_calls, plain_calls, k: int):
    """Tokens whose ordered top-k ids differ between two runs' router calls,
    each with its top-k margin in the kernel run (the smallest gap between
    consecutive logits down to the (k+1)-th) against the largest router-logit
    difference of that token between the runs.  A flip whose margin exceeds
    twice that difference cannot come from rounding: it fails."""
    flips = []
    for layer, ((ik, lk), (ip, lp)) in enumerate(zip(kernel_calls, plain_calls)):
        rows = torch.nonzero((ik != ip).any(dim=1)).reshape(-1).tolist()
        if not rows:
            continue
        top = torch.topk(lk[rows], k + 1, dim=-1).values
        margin = (top[:, :-1] - top[:, 1:]).min(dim=-1).values
        diff = (lk[rows] - lp[rows]).abs().max(dim=-1).values
        for t, m, dl in zip(rows, margin.tolist(), diff.tolist()):
            flips.append(dict(call=layer, token=t, margin=m, logit_diff=dl))
    bad = [f for f in flips if f["margin"] > 2 * f["logit_diff"]]
    if bad:
        raise AssertionError(f"routing: {len(bad)} top-k flips wider than the logit "
                             f"difference: {bad[:5]}")
    return flips


def _flip_summary(flips):
    if not flips:
        return "no routing flips"
    calls = sorted({f["call"] for f in flips})
    worst = max(flips, key=lambda f: f["margin"])
    return (f"{len(flips)} flipped tokens in router calls {calls[:6]}"
            f"{'...' if len(calls) > 6 else ''}; first in call {flips[0]['call']} (margin "
            f"{flips[0]['margin']:.3e} against a logit difference {flips[0]['logit_diff']:.3e}); "
            f"widest margin {worst['margin']:.3e} against {worst['logit_diff']:.3e}")


def phase_moe_serve():
    """Phase 29: the serve CLI on full-width OLMoE-1B-7B, LRD at Eq.-5
    ranks: exactly 64 K1 and 0 K5 (or any other kernel) launches a forward,
    by shape; tok/s and the pool bytes."""
    from repro_torch.launch import serve

    zero_counts()
    t0 = time.perf_counter()
    engine, outs = serve.main(MOE_SERVE_ARGV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers().items()}
    by_shape = counts_by_shape()
    sched = engine.scheduler
    fwd = sched.forward_stats
    cfg = engine.run.model
    if (cfg.num_layers, cfg.num_experts, cfg.moe_impl) != (MOE_LAYERS, MOE_EXPERTS, "ep"):
        raise AssertionError(f"moe serve: {cfg.num_layers} layers, {cfg.num_experts} experts, "
                             f"moe_impl {cfg.moe_impl!r}")
    if len(outs) != 16 or any(len(o) != 32 for o in outs) or fwd["nonfinite"]:
        raise AssertionError(f"moe serve: {[len(o) for o in outs]} tokens, "
                             f"{fwd['nonfinite']} non-finite forwards")
    want = {"lowrank_matmul": {_moe_key(PREFILL_M): 4 * MOE_LAYERS * fwd["prefill"],
                               _moe_key(DECODE_M): 4 * MOE_LAYERS * fwd["decode"]}}
    got = {k: v for k, v in by_shape.items() if v}
    if got != want or counts["lowrank_gated_ffn"]:
        raise AssertionError(f"moe serve: launches {got}, want {want} (64 K1 and 0 K5 a "
                             f"forward)")
    stats = sched.latency_stats()
    pool = sched.cache_bytes()
    log(f"[moe serve] olmoe-1b-7b (16 layers, 64 experts top-8, ep) with LRD: {len(outs)} "
        f"requests, {int(stats['generated_tokens'])} tokens, {stats['tok_per_s']:.1f} tok/s on "
        f"{torch.cuda.get_device_name(0)}; {fwd['prefill']} prefill + {fwd['decode']} decode "
        f"forwards, {counts['lowrank_matmul']} K1 = 64 a forward, 0 K5; pools "
        f"{pool / 2 ** 20:.1f} MiB; {dt:.1f}s incl. init")
    return engine, by_shape, dict(fwd=dict(fwd), k1=counts["lowrank_matmul"], stats=stats,
                                  pool_bytes=pool, wall_s=dt)


def phase_moe_parity(engine):
    """Phase 30: the kernels against the plain path on the card with
    routing pinned (the plain run replays the kernel run's expert ids):
    one 128-token prefill's last-position logits and one 8-slot decode
    step's logits (cap2 = 1) within PATH_RTOL of max |logit|; then the
    plain run unpinned, its routing flips reported with their margins."""
    import dataclasses

    from repro_torch.launch import steps

    run = engine.run
    plain = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, use_pallas_kernel=False))
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, run.model.vocab_size, (1, PREFILL_M), generator=gen,
                           device="cuda", dtype=torch.int32)
    last = torch.tensor([PREFILL_M - 1], device="cuda")
    # the retired slots' tables all point at the sink block: give each slot
    # a block of its own, or the 8 rows would write one position
    import numpy as np

    from repro_torch.serving import paged_cache as pc

    sched = engine.scheduler
    cache = pc.with_page_table(sched.cache, 1 + np.arange(
        sched.num_slots * sched.pages.max_blocks, dtype=np.int32).reshape(sched.num_slots, -1))
    dec_tok = torch.randint(0, run.model.vocab_size, (DECODE_M, 1), generator=gen,
                            device="cuda", dtype=torch.int32)
    dec_pos = torch.zeros((DECODE_M,), dtype=torch.int32, device="cuda")

    def both(r):
        pre, _ = steps.build_slot_prefill_step(r)(engine.params, {"tokens": tokens}, last)
        dec, _, _ = steps.build_serve_step(r)(engine.params, cache, dec_tok, dec_pos)
        return pre, dec[:, -1]

    kcalls, ucalls = [], []
    with routing(record=kcalls):
        kpre, kdec = both(run)
    with routing(replay=kcalls):
        ppre, pdec = both(plain)
    with routing(record=ucalls):
        upre, udec = both(plain)
    zero_counts()
    # the padded vocab tail holds -1e30 in every run: compare the true vocab
    v = run.model.vocab_size
    kpre, kdec, ppre, pdec, upre, udec = (t[..., :v] for t in (kpre, kdec, ppre, pdec, upre,
                                                               udec))
    out = {}
    for what, got, want, free in (("prefill", kpre, ppre, upre), ("decode", kdec, pdec, udec)):
        err, rel = rel_err(got, want)
        if not torch.isfinite(got).all() or rel > PATH_RTOL:
            raise AssertionError(f"moe parity ({what}, routing pinned): logits differ by "
                                 f"{err:.3e} ({rel:.3e} of max |logit|) > {PATH_RTOL}")
        out[what] = dict(max_abs_diff=err, rel=rel, unpinned_rel=rel_err(got, free)[1])
    flips = routing_flips(kcalls, ucalls, run.model.num_experts_per_tok)
    out["flips"] = flips
    log(f"[moe parity] routing pinned: prefill last-position logits {out['prefill']['rel']:.3e} "
        f"and decode-step logits {out['decode']['rel']:.3e} of max |logit| (bound {PATH_RTOL}); "
        f"unpinned: {out['prefill']['unpinned_rel']:.3e} / {out['decode']['unpinned_rel']:.3e}, "
        f"{_flip_summary(flips)}")
    return out


def expert_bmm_ms(prof, steps_n: int, experts: int = MOE_EXPERTS):
    """Device ms a step of the experts' products: the ``aten::bmm`` ops whose
    batch dim is the expert count (attention's batch dims are B x heads)."""
    total = 0.0
    for ev in prof.key_averages(group_by_input_shape=True):
        shapes = ev.input_shapes or []
        if ev.key == "aten::bmm" and shapes and shapes[0] and shapes[0][0] == experts:
            total += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
    return total / steps_n / 1e3


def phase_moe_train():
    """Phase 32: the training CLI on full-width OLMoE-1B-7B, 6 steps with
    sequential freezing, launches counted per step by name and shape."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("moe train: TF32 is on; the router's float32 matmul must not "
                             "use it")
    state, per_step, by_shape, dt = _counted_train(MOE_TRAIN_ARGV)
    phases = [r["phase"] for r in per_step]
    if phases != [0, 0, 1, 1, 0, 0]:
        raise AssertionError(f"moe train: phases {phases}, want [0, 0, 1, 1, 0, 0]")
    for r in per_step:
        want = {k: (v[r["phase"]] if isinstance(v, dict) else v)
                for k, v in MOE_TRAIN_LAUNCHES.items()}
        got = {k: n for k, n in r["launches"].items() if n or k in want}
        seen = {k: keys for k, keys in r["shapes"].items() if keys}
        shapes = {k: {_moe_key(TRAIN_M)} for k, n in want.items() if n}
        if got != want or seen != shapes:
            raise AssertionError(f"moe train: step {r['step']} (phase {r['phase']}) launched "
                                 f"{got} at {seen}, want {want} at {shapes}")
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"moe train: step {r['step']} loss {r['loss']}")
        log(f"[moe train] step {r['step']} phase {r['phase']}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms, memory_allocated "
            f"{r['mem'] / 2 ** 30:.2f} GiB; launches "
            + ", ".join(f"{k.replace('lowrank_', '')} {n}" for k, n in r["launches"].items()
                        if n))
    log(f"[moe train] 6 steps of {TRAIN_M} tokens on {torch.cuda.get_device_name(0)}: loss "
        f"{per_step[0]['loss']:.4f} -> {per_step[-1]['loss']:.4f}; {dt:.1f}s incl. init; "
        f"TF32 off (router float32 matmul at 'highest')")
    return state.params, by_shape, dict(steps=_without_shapes(per_step), wall_s=dt)


def _moe_run(remat: str = "none"):
    import dataclasses

    from repro_torch.launch import train

    run = train.build_run(train._parser().parse_args(MOE_TRAIN_ARGV))
    return dataclasses.replace(run, dist=dataclasses.replace(run.dist, remat=remat))


def _split_grads(trainable, frozen, batch, run, phase: int, calls):
    """path -> (gradient of the cross entropy (plus an MTP model's weighted
    MTP cross entropy), max |gradient of 0.01 * aux|) for every trainable
    leaf, routing replayed from ``calls``."""
    from repro_torch.core import freezing
    from repro_torch.core.freezing import tree_leaves, tree_map
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.common import cross_entropy

    live = [t.detach().requires_grad_(True) for t in tree_leaves(trainable)]
    it = iter(live)
    params = freezing.merge(tree_map(lambda _: next(it), trainable), frozen)
    cfg, policy = run.model, steps.kernel_policy(run, phase)
    with torch.enable_grad(), routing(replay=calls):
        logits, _, aux, hidden = lm.lm_apply(params, batch["tokens"], cfg, mode="train",
                                             policy=policy, return_hidden=True)
        loss = cross_entropy(logits, batch["labels"])
        if cfg.use_mtp:
            mtp = lm.mtp_logits(params, hidden, batch["tokens"], cfg, policy=policy)
            loss = loss + cfg.mtp_loss_weight * cross_entropy(
                mtp, torch.roll(batch["labels"], -1, dims=1),
                mask=lm.mtp_loss_mask(batch["tokens"]))
        g_ce = torch.autograd.grad(loss, live, retain_graph=True, allow_unused=True)
        # with no MoE layer in the stacks (DeepSeek-V3 cut to its dense
        # layer) aux is a constant zero: the MTP layer's is dropped
        g_aux = (torch.autograd.grad(0.01 * aux, live, allow_unused=True) if aux.requires_grad
                 else [None] * len(live))
    out = {}
    for (path, t), ce, ax in zip(_grad_paths(trainable), g_ce, g_aux):
        out[path] = (torch.zeros_like(t) if ce is None else ce,
                     0.0 if ax is None else ax.abs().max().item())
    return out


def phase_moe_grads(params, run=None, label: str = "moe grads"):
    """Phase 33: one full-width train step's loss and gradients through the
    kernels against the plain path at phases -1, 0 and 1 (of ``run``, by
    default OLMoE's), routing pinned; the unpinned plain run's routing
    flips reported.

    A leaf's gradient is the sum of a cross-entropy part and an aux part.
    The aux part is the gradient of a constant (the reference's ``aux`` is
    1 up to rounding), so what autograd returns for it is the float32
    rounding of the softmax's sum, which differs between any two runs whose
    router logits differ; it reaches the router and, through the router's
    input, the MoE's norm and everything before it.  Where the experts'
    outputs are tiny (the reference scales a 4-D factor by (L E C)^-1/2 at
    init), the router's and that norm's cross-entropy parts are of the same
    size.  So every leaf is held twice: its cross-entropy part within
    GRAD_RTOL of its max, and its full train-step gradient within GRAD_RTOL
    of its max plus the two runs' aux parts, whose true value is 0."""
    import dataclasses

    from repro_torch.core import freezing
    from repro_torch.launch import steps

    run = run or _moe_run()
    plain = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, use_pallas_kernel=False))
    batch = _train_batch(run, seed=99)
    out = {}
    for phase in (-1, 0, 1):
        trainable, frozen = freezing.partition(params, phase)
        kcalls, ucalls = [], []
        with routing(record=kcalls):
            lk, gk = steps._value_and_grad(trainable, frozen, batch, run, phase)
        with routing(replay=kcalls):
            lp, gp = steps._value_and_grad(trainable, frozen, batch, plain, phase)
        full = {}  # path -> (max |dgrad|, max |grad|); an empty stack's leaves hold nothing
        for (path, a), (_, b) in zip(_grad_paths(gk), _grad_paths(gp)):
            if not a.numel():
                continue
            if not torch.isfinite(a).all():
                raise AssertionError(f"{label}: phase {phase} {path} not finite")
            full[path] = ((a.float() - b.float()).abs().max().item(),
                          b.float().abs().max().item())
        del gk, gp
        split_k = _split_grads(trainable, frozen, batch, run, phase, kcalls)
        split_p = _split_grads(trainable, frozen, batch, plain, phase, kcalls)
        rows = []  # (full rel, path, ce rel, aux floor, within both bounds)
        for path, (diff, gmax) in full.items():
            (ce_k, aux_k), (ce_p, aux_p) = split_k[path], split_p[path]
            ce_rel = rel_err(ce_k, ce_p)[1]
            floor = aux_k + aux_p
            rows.append((diff / max(gmax, 1e-30), path, ce_rel, floor,
                         ce_rel <= GRAD_RTOL and diff <= GRAD_RTOL * gmax + floor))
        del split_k, split_p
        with routing(record=ucalls):
            lu, _ = steps._value_and_grad(trainable, frozen, batch, plain, phase)
        flips = routing_flips(kcalls, ucalls, run.model.num_experts_per_tok)
        zero_counts()
        loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
        rows.sort(reverse=True)
        by_ce = sorted(rows, key=lambda r: -r[2])
        log(f"[{label}] phase {phase}, routing pinned: loss kernels {lk.item():.5f} vs plain "
            f"{lp.item():.5f} (rel {loss_rel:.2e}, bound {LOSS_RTOL}); {len(rows)} trainable "
            f"leaves; worst max |dgrad| / max |grad|: "
            + ", ".join(f"{r[0]:.2e} at {r[1]} (aux parts {r[3]:.2e}, max |grad| "
                        f"{full[r[1]][1]:.2e})" for r in rows[:3])
            + "; worst cross-entropy part: "
            + ", ".join(f"{r[2]:.2e} at {r[1]}" for r in by_ce[:3])
            + f" (bound {GRAD_RTOL} of max |grad|, plus the aux parts for the full gradient); "
            f"unpinned plain loss {lu.item():.5f}, {_flip_summary(flips)}")
        bad = [r[1] for r in rows if not r[4]]
        if loss_rel > LOSS_RTOL or bad:
            raise AssertionError(f"{label}: phase {phase} loss rel {loss_rel:.3e}, leaves "
                                 f"over the bound {bad}")
        out[phase] = dict(loss_kernels=lk.item(), loss_plain=lp.item(), loss_rel=loss_rel,
                          leaves=len(rows), worst_rel=rows[0][0], worst_leaf=rows[0][1],
                          worst_aux_floor=rows[0][3], worst_ce_rel=by_ce[0][2],
                          worst_ce_leaf=by_ce[0][1], loss_unpinned=lu.item(),
                          flips=flips)
    return out


def phase_remat(params):
    """Phase 35: one 8 x 256 batch at phase -1 under each remat policy
    (``none`` twice first): losses and gradients equal to ``none``'s bit for
    bit wherever the two ``none`` runs agree; K1 launches 64 plus the
    recomputed forwards, K2-K4 64 each; peak memory below ``none``'s.  Then
    8 x 1024 tokens' loss and gradients under ``full`` (their peak memory)
    and the training CLI for one step of 8 x 1024 tokens under ``--remat
    full`` (t = 8192 through the ep path)."""
    import dataclasses

    from repro_torch.core import freezing
    from repro_torch.launch import steps
    from repro_torch.models import lm

    batch = _train_batch(_moe_run(), seed=97)
    trainable, frozen = freezing.partition(params, -1)
    # K1 forwards a step: 64, the recompute of every layer (full, dots: the
    # kernels are no aten ops, so dots recomputes them too), and under sqrt
    # also the groups' recompute of all but each group's last layer
    g = lm._best_divisor(MOE_LAYERS)
    per = MOE_LAYERS // g
    want_k1 = {"none": 64, "full": 128, "dots": 128, "sqrt": 128 + 4 * g * (per - 1)}
    ref, out, nondet = None, {}, []
    for i, policy in enumerate(("none",) + lm.REMAT_POLICIES):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        loss, grads = steps._value_and_grad(trainable, frozen, batch, _moe_run(policy), -1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        counts = {name: fn.launches for name, fn in wrappers().items() if fn.launches}
        leaves = list(_grad_paths(grads))
        if i == 0:
            ref = (loss, leaves)
        elif i == 1:
            nondet = [p for (p, a), (_, b) in zip(ref[1], leaves) if not torch.equal(a, b)]
            if not torch.equal(loss, ref[0]):
                raise AssertionError("remat: two runs of 'none' gave different losses")
        else:
            differ = [p for (p, a), (_, b) in zip(ref[1], leaves)
                      if p not in nondet and not torch.equal(a, b)]
            if not torch.equal(loss, ref[0]) or differ:
                raise AssertionError(f"remat {policy}: loss {loss.item()} vs none "
                                     f"{ref[0].item()}, gradients differ at {differ[:5]}")
        want = {"lowrank_matmul": want_k1[policy], "lowrank_matmul_dx": 64,
                "lowrank_matmul_du": 64, "lowrank_matmul_dv": 64}
        if counts != want:
            raise AssertionError(f"remat {policy}: launches {counts}, want {want}")
        key = policy if i else "none (first)"
        out[key] = dict(loss=loss.item(), peak_bytes=peak, seconds=secs, launches=counts)
        log(f"[remat] {policy}: loss {loss.item():.6f}, K1 {counts['lowrank_matmul']} + K2/K3/K4 "
            f"64 each, peak {peak / 2 ** 30:.2f} GiB above the {base / 2 ** 30:.2f} GiB held, "
            f"{secs * 1e3:.0f} ms"
            + (f"; bit-identical to none ({len(ref[1]) - len(nondet)} of {len(ref[1])} leaves "
               f"deterministic)" if i > 1 else ""))
        del grads, leaves
    for policy in lm.REMAT_POLICIES[1:]:
        if not out[policy]["peak_bytes"] < out["none"]["peak_bytes"]:
            raise AssertionError(f"remat {policy}: peak {out[policy]['peak_bytes']} not below "
                                 f"none's {out['none']['peak_bytes']}")
    out["nondeterministic_without_remat"] = nondet
    log(f"[remat] leaves whose backward differs between two runs of none: {nondet or 'none'}")
    del ref
    # the loss and gradients of 8 x 1024 tokens under full, as above
    long_run = dataclasses.replace(_moe_run("full"), shape=dataclasses.replace(
        _moe_run().shape, seq_len=MOE_LONG_SEQ))
    long_batch = _train_batch(long_run, seed=96)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss, grads = steps._value_and_grad(trainable, frozen, long_batch, long_run, -1)
    torch.cuda.synchronize()
    out["long_full_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    log(f"[remat] full, 8 x {MOE_LONG_SEQ} tokens, loss and gradients: peak "
        f"{out['long_full_peak_bytes'] / 2 ** 30:.2f} GiB above the {base / 2 ** 30:.2f} GiB "
        f"held (none at 8 x 256 tokens: {out['none']['peak_bytes'] / 2 ** 30:.2f} GiB)")
    del trainable, frozen, grads, loss, long_batch
    zero_counts()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    state, per_step, by_shape, dt = _counted_train(MOE_LONG_ARGV)
    r = per_step[0]
    m = 8 * MOE_LONG_SEQ
    want = {"lowrank_matmul": 128, "lowrank_matmul_dx": 64, "lowrank_matmul_du": 64,
            "lowrank_matmul_dv": 64}
    got = {k: n for k, n in r["launches"].items() if n}
    seen = {k: keys for k, keys in r["shapes"].items() if keys}
    if got != want or seen != {k: {_moe_key(m)} for k in want} or not math.isfinite(r["loss"]):
        raise AssertionError(f"remat long step: loss {r['loss']}, launched {got} at {seen}, "
                             f"want {want} at M = {m}")
    peak = torch.cuda.max_memory_allocated()
    out["long_step"] = dict(tokens=m, loss=r["loss"], step_time_s=r["step_time_s"],
                            max_memory_allocated=peak, launches=got)
    log(f"[remat] train CLI, --remat full, 8 x {MOE_LONG_SEQ} tokens (ep at t = {m}, cap2 "
        f"{_cap2(m)}): loss {r['loss']:.4f}, {r['step_time_s'] * 1e3:.0f} ms, "
        f"max_memory_allocated {peak} B = {peak / 2 ** 30:.2f} GiB (params, grads, momentum "
        f"and the optimizer update's temporaries included), K1 128 + K2/K3/K4 64 each at "
        f"M = {m}")
    del state
    return by_shape, out


def _cap2(t: int) -> int:
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    return moe.ep_capacity(t, get_config(MOE_ARCH))


def phase_moe():
    """Phases 29-35; returns (launches by kernel and shape per main path,
    results)."""
    paths, result = {}, {}
    engine, paths["moe serve"], result["moe_serve"] = phase_moe_serve()
    result["moe_parity"] = phase_moe_parity(engine)
    result["moe_profile"] = phase_profile(engine, label="MoE decode step", moe=True)
    del engine
    gc.collect()
    params, paths["moe train"], result["moe_train"] = phase_moe_train()
    result["moe_grads"] = phase_moe_grads(params)
    # one profiled step a phase (two until a whole run took 1,198 s of its
    # 1,200 on a slow host: each step's trace with shapes is ~10 s of host)
    result["moe_train_profile"] = phase_train_profile(
        params, steps_n=1, run=_moe_run(), label="moe train profile", moe=True)
    paths["moe remat"], result["remat"] = phase_remat(params)
    del params
    gc.collect()
    return paths, result


# --------------------------------------------------------------------------
# The SSM and hybrid families: full-width xLSTM-350M and Zamba2-1.2B
# (phases 36-43)
# --------------------------------------------------------------------------

# xLSTM-350M (24 mLSTM layers, d 1024, 4 heads) and Zamba2-1.2B (38 Mamba2
# layers in 6 groups of 6 and a tail of 2, d 2048, the shared attention +
# GELU-FFN block at 2d = 4096 after each group) at full width, LRD at Eq.-5
# ranks; Zamba2 at full depth, xLSTM at SSM_SERVE_LAYERS / SSM_TRAIN_LAYERS.
# Serve: the serve CLI's fixed-batch path, 8 rows of
# 512-token prompts and 32 new tokens (two 256-token SSD chunks a prompt).
# Train: 6 steps of 8 x 256 tokens, phases 0,0,1,1,0,0; xLSTM under
# --remat full (its step recurrence keeps an (8, 4, 256, 256) float32
# memory a position for the backward: ~2 GB a layer a saved tensor).
SSM_ARCHS = ("xlstm-350m", "zamba2-1.2b")
SSM_SLOTS, SSM_PROMPT, SSM_NEW, SSM_PARITY_NEW = 8, 512, 32, 8
SSM_REMAT = {"xlstm-350m": "full", "zamba2-1.2b": "none"}
# xLSTM trains at a twelfth of its 24 layers (the whole script's time
# limit: its mLSTM steps through the 256 positions one by one, host-bound,
# ~21 s a step at full depth; 6 layers until DeepSeek-V3's phases joined,
# 3 until a whole run took 1100 s of its 1200 on a slow host); Zamba2 at
# full depth
SSM_TRAIN_LAYERS = {"xlstm-350m": 2, "zamba2-1.2b": None}
# xLSTM serves (and its int8 export serves) at a quarter of its 24 layers:
# the same host-bound steps through the positions, ~117 s of the script at
# full depth on a host where a whole run took 1,198 s of its 1,200 (PERF.md);
# Zamba2 at full depth
SSM_SERVE_LAYERS = {"xlstm-350m": 6, "zamba2-1.2b": None}
# (C, r, S) of each factorised projection at Eq.-5 ranks -> its K1 launches
# a forward: xLSTM wq, wk, wv, wo_gate and wo of its serve layers; Zamba2 in_proj
# and out_proj of 38 Mamba2 layers, and the shared block's wq/wk/wv/wo, FFN
# wi and down and down_proj after each of 6 groups (down_proj has
# out_proj's geometry)
SSM_GEOMS = {"xlstm-350m": {(1024, 256, 1024): 5 * SSM_SERVE_LAYERS["xlstm-350m"]},
             "zamba2-1.2b": {(2048, 822, 8384): 38, (4096, 682, 2048): 38 + 6,
                             (4096, 1024, 4096): 4 * 6, (4096, 1365, 8192): 6,
                             (8192, 1365, 4096): 6}}
# a prefill also runs each Mamba2 layer's in_proj on its last 3 positions
# (xbc_tail, the decode conv state): M = 8 x 3
SSM_TAIL = {"xlstm-350m": {}, "zamba2-1.2b": {(2048, 822, 8384): 38}}
SSM_TAIL_M = SSM_SLOTS * 3


def _ssm_serve_argv(arch):
    return ["--arch", arch, "--lrd", "--slots", str(SSM_SLOTS), "--prompt-len",
            str(SSM_PROMPT), "--max-new", str(SSM_NEW)]


def _ssm_train_argv(arch):
    return (["--arch", arch] + TRAIN_ARGV[2:]
            + (["--remat", SSM_REMAT[arch]] if SSM_REMAT[arch] != "none" else []))


def _cli_run(argv):
    """The training CLI's RunConfig for ``argv``."""
    from repro_torch.launch import train

    return train.build_run(train._parser().parse_args(argv))


@contextlib.contextmanager
def at_depth(layers=None, **cut):
    """Inside, the serve and train CLIs build ``--arch``'s full-width
    config with ``num_layers`` cut to ``layers`` (a depth cut; None keeps
    the config as it is), and any other depth field in ``cut`` (DeepSeek-V3's
    ``first_k_dense``).  Every launch check reads the depth from the
    run."""
    import dataclasses

    from repro_torch.launch import serve, train

    full = serve.get_config
    if layers is not None:
        serve.get_config = train.get_config = (
            lambda arch: dataclasses.replace(full(arch), num_layers=layers, **cut))
    try:
        yield
    finally:
        serve.get_config = train.get_config = full


# K1-K4 at the first rank past 512, at the old ceiling of 2048 and at the
# ceiling of 4096, checked and timed beside the kernels line (no main path
# runs them): K1 in both designs, K2-K4 at the train M
RANK_EDGES = ((960, 513, 960), (4096, 2048, 4096), (4096, 4096, 4096))
RANK_EDGE_SHAPES = ([("lowrank_matmul", dict(M=m, C=c, r=r, S=s))
                     for c, r, s in RANK_EDGES for m in (DECODE_M, TRAIN_M)]
                    + [(name, dict(M=TRAIN_M, C=c, r=r, S=s)) for name in BWD
                       for c, r, s in RANK_EDGES])


def ssm_kernel_shapes(archs=SSM_ARCHS):
    """(name, dims) of every K1-K4 call on the two families' paths: K1 at
    the decode, prefill, xbc_tail and train M; K2-K4 at the train M."""
    out = []
    for arch in archs:
        for (c, r, s) in SSM_GEOMS[arch]:
            out += [("lowrank_matmul", dict(M=m, C=c, r=r, S=s))
                    for m in (SSM_SLOTS, SSM_SLOTS * SSM_PROMPT, TRAIN_M)]
            out += [(name, dict(M=TRAIN_M, C=c, r=r, S=s)) for name in BWD]
        out += [("lowrank_matmul", dict(M=SSM_TAIL_M, C=c, r=r, S=s))
                for (c, r, s) in SSM_TAIL[arch]]
    return out


def _ssm_want(arch, per_m):
    """K1 launches by (M, C, r, S) of forwards at M -> count (``per_m``)."""
    want = {}
    for m, n in per_m.items():
        for (c, r, s), k in SSM_GEOMS[arch].items():
            want[(m, c, r, s)] = want.get((m, c, r, s), 0) + k * n
    return want


def phase_ssm_serve(arch):
    """Phases 36 / 40: the serve CLI on the family's full-width model, the
    fixed-batch path: K1 launches exact by shape (a prefill at M = 8 x 512
    with xbc_tail's at M = 8 x 3, then 31 decode forwards at M = 8), no
    other kernel, finite tokens."""
    from repro_torch.launch import serve

    zero_counts()
    t0 = time.perf_counter()
    with at_depth(SSM_SERVE_LAYERS[arch]):
        engine, out = serve.main(_ssm_serve_argv(arch))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_shape = counts_by_shape()
    want = _ssm_want(arch, {SSM_SLOTS * SSM_PROMPT: 1, SSM_SLOTS: SSM_NEW - 1})
    for (c, r, s), k in SSM_TAIL[arch].items():
        want[(SSM_TAIL_M, c, r, s)] = k
    got = by_shape["lowrank_matmul"]
    others = {k: v for k, v in by_shape.items() if v and k != "lowrank_matmul"}
    if got != want or others or out.shape != (SSM_SLOTS, SSM_NEW):
        raise AssertionError(f"{arch} serve: K1 launches {got}, want {want}; other kernels "
                             f"{others}; tokens {out.shape}")
    if engine._scheduler is not None:
        raise AssertionError(f"{arch} serve: the fixed-batch path built a scheduler")
    tok_s = out.size / dt
    log(f"[{arch} serve] fixed batch {SSM_SLOTS} x {SSM_PROMPT} prompts, {SSM_NEW} new tokens "
        f"on {torch.cuda.get_device_name(0)}: {dt:.2f}s incl. init ({tok_s:.1f} tok/s); "
        f"{sum(got.values())} K1 launches, exact by shape (ranks "
        f"{sorted({k[2] for k in got})}); no other kernel")
    return engine, by_shape, dict(wall_s=dt, tok_per_s=tok_s, k1=sum(got.values()),
                                  sample=out[0].tolist())


@contextlib.contextmanager
def _recurrent_inputs(family, record):
    """Patch the family's recurrent block (``ssm.mlstm_apply`` or
    ``ssm.mamba2_apply``; here only) so each call appends its input."""
    from repro_torch.models import ssm

    name = "mlstm_apply" if family == "ssm" else "mamba2_apply"
    orig = getattr(ssm, name)

    def wrapped(p, x, cfg, **kw):
        record.append(x)
        return orig(p, x, cfg, **kw)

    setattr(ssm, name, wrapped)
    try:
        yield orig
    finally:
        setattr(ssm, name, orig)


def _layer_parity(run, params, prompts):
    """Each recurrent layer (24 mLSTM, or 38 Mamba2) on the same input, the
    plain path's own at that layer, through the kernels and through the
    plain versions: max |difference| / max |plain| of each layer's output."""
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg, inputs = run.model, []
    with _recurrent_inputs(cfg.family, inputs) as apply_fn:
        steps.build_prefill_step(_plain(run))(params, {"tokens": prompts})
    if cfg.family == "ssm":
        layers = [lm._layer(params["stack"], l) for l in range(cfg.num_layers)]
    else:
        n_grp, per, tail = lm._hybrid_split(cfg)
        layers = [lm._layer(lm._layer(params["mamba_groups"], g), l)
                  for g in range(n_grp) for l in range(per)]
        layers += [lm._layer(params["mamba_tail"], l) for l in range(tail)]
    rels = []
    with torch.inference_mode():
        for lp, x in zip(layers, inputs):
            got, _ = apply_fn(lp, x, cfg, policy=steps.kernel_policy(run))
            want, _ = apply_fn(lp, x, cfg, policy=steps.kernel_policy(_plain(run)))
            rels.append(rel_err(got, want)[1])
    zero_counts()
    return rels


def phase_ssm_parity(engine, arch):
    """Phases 37 / 41: one batch of 8 x 512 prompts and 8 new tokens through
    the kernels against the same fixed-batch path through the plain versions
    on the card.  Each recurrent layer on the same input (the plain path's
    at that layer) within PATH_RTOL of max |plain output|.  End to end, the
    model's own conditioning first: the plain path again from an embedding
    table with 1% of its entries one bf16 ulp up.  Where that alone moves
    the prefill logits by more than PATH_RTOL of max |logit| (xLSTM-350M's
    random weights amplify a 1-ulp change through its 24 layers), end-to-end
    logits are reported and not bounded; else the prefill's last-position
    logits within PATH_RTOL, and greedy tokens held to the plain run's on
    agreeing histories as in phase 25.  Either way a parting must be a
    rounding tie (the plain run's top-2 gap below the two runs' largest
    |logit difference| there)."""
    from repro_torch.launch import steps

    run, params = engine.run, engine.params
    vocab = run.model.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(36)
    prompts = torch.randint(0, vocab, (SSM_SLOTS, SSM_PROMPT), generator=gen, device="cuda",
                            dtype=torch.int32)
    layer_rels = _layer_parity(run, params, prompts)
    if not all(math.isfinite(r) and r <= PATH_RTOL for r in layer_rels):
        raise AssertionError(f"{arch} parity: a recurrent layer's output, kernels vs plain on "
                             f"the same input, {max(layer_rels):.3e} of max |plain| > "
                             f"{PATH_RTOL}: {layer_rels}")
    toks, logits = _generate_with_logits(run, params, prompts, SSM_PARITY_NEW)
    ptoks, plogits = _generate_with_logits(_plain(run), params, prompts, SSM_PARITY_NEW)
    logits = [[t[:vocab] for t in r] for r in logits]
    plogits = [[t[:vocab] for t in r] for r in plogits]
    emb = params["embed"]["embedding"]
    nudged = emb.clone()
    nudged.view(-1)[::100] = (nudged.view(-1)[::100].float() * (1 + 2 ** -7)).to(emb.dtype)
    with torch.inference_mode():
        cond, _ = steps.build_prefill_step(_plain(run))(dict(params, embed={"embedding": nudged}),
                                                        {"tokens": prompts})
    zero_counts()
    want = torch.stack([r[0] for r in plogits])
    cond_diff, cond_rel = rel_err(cond[:, :vocab], want)
    diff, rel = rel_err(torch.stack([r[0] for r in logits]), want)
    bounded = cond_rel <= PATH_RTOL
    if not all(torch.isfinite(r[0]).all() for r in logits) or (bounded and rel > PATH_RTOL):
        raise AssertionError(f"{arch} parity: prefill logits {diff:.3e} ({rel:.3e} of max "
                             f"|logit|) from the plain versions'")
    cmp = _compare_greedy(ptoks, plogits, toks, logits, f"{arch} parity",
                          rtol=PATH_RTOL if bounded else None)
    log(f"[{arch} parity] each of {len(layer_rels)} recurrent layers on the plain path's input, "
        f"kernels vs plain: worst {max(layer_rels):.3e} of max |output| (bound {PATH_RTOL}); "
        f"prefill last-position logits, kernels vs plain on the card: max_abs_diff {diff:.3e} "
        f"({rel:.3e} of max |logit|; "
        + (f"bound {PATH_RTOL}" if bounded else "reported, not bounded") + f"); the plain "
        f"path from an embedding 1% one ulp up: {cond_diff:.3e} ({cond_rel:.3e}); "
        f"{SSM_PARITY_NEW} greedy tokens: {_parted_text(cmp)}")
    return dict(layer_rel=layer_rels, max_abs_diff=diff, rel=rel, bounded=bounded,
                conditioning_abs=cond_diff, conditioning_rel=cond_rel, compare=cmp)


def profile_calls(tag: str, where: str, calls, extra=()):
    """Wall (host clock around ``n`` synchronised calls after a warm one)
    and device ms (``torch.profiler``, ``n`` more calls) of each ``(label,
    n, fn)`` of ``calls``, a call's idle share and K1 ms, and each ``(key,
    name, fn)`` of ``extra`` as ``key: fn(device ms by kernel)``; logged as
    ``[tag] label (where)``."""

    out = {}
    for label, n, fn in calls:
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / n * 1e3

            def run():
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()

            prof = profiled(run)
        by_name = device_ms_by_kernel(prof, n)
        device_ms = sum(by_name.values())
        k1_ms, _ = lowrank_device_ms(by_name)
        more = {key: f(by_name) for key, _, f in extra}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out[label] = dict(wall_ms=wall_ms, device_ms=device_ms or None,
                          idle_share=(1 - device_ms / wall_ms) if device_ms else None,
                          k1_ms=k1_ms, **more, top=[dict(name=k[:80], ms=v) for k, v in top])
        log(f"[{tag}] {label} ({where}): wall {wall_ms:.2f} ms, device "
            + (f"{device_ms:.2f} ms, idle {out[label]['idle_share']:.1%}; K1 {k1_ms:.2f} ms"
               + "".join(f", {name} {more[key]:.2f} ms" for key, name, _ in extra)
               + "; top: " + ", ".join(f"{k[:40]} {v * 1e3:.0f}us" for k, v in top[:5])
               if device_ms else "time not measured (profiler saw no device events)"))
    zero_counts()
    return out


def phase_fixed_profile(engine, arch, steps_n: int = 5):
    """Phases 38 / 42: a fixed-batch decode step (8 rows at position 512,
    the prefill's cache padded to the window) as in phase 6: wall and device
    ms, idle share, K1 ms; then the prefill itself the same way."""
    from repro_torch.serving.engine import pad_cache

    run = engine.run
    gen = torch.Generator(device="cuda").manual_seed(38)
    prompts = torch.randint(0, run.model.vocab_size, (SSM_SLOTS, SSM_PROMPT), generator=gen,
                            device="cuda", dtype=torch.int32)
    last, cache = engine._prefill(engine.params, {"tokens": prompts})
    cache = pad_cache(cache, SSM_PROMPT + SSM_NEW)
    token = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    pos = torch.tensor(SSM_PROMPT, dtype=torch.int32, device="cuda")
    calls = (("decode step", steps_n, lambda: engine._step(engine.params, cache, token, pos)),
             ("prefill", 1, lambda: engine._prefill(engine.params, {"tokens": prompts})))
    return profile_calls(f"{arch} profile", f"{SSM_SLOTS} rows, {run.model.num_layers} layers",
                         calls)


def phase_ssm_train(arch):
    """Phases 39 / 43: the training CLI on the family's full-width model, 6
    steps of 8 x 256 tokens at phases 0,0,1,1,0,0: per step exactly one K1
    and one K2 a factorised projection's forward (two K1 under remat full:
    the recomputed forward), K3 at phase 1 only, K4 at phase 0 only, all at
    M = 2048 and the projection's rank, no K5; finite losses.  xLSTM at
    SSM_TRAIN_LAYERS of its layers."""
    with at_depth(SSM_TRAIN_LAYERS[arch]):
        state, per_step, by_shape, dt = _counted_train(_ssm_train_argv(arch))
    phases = [r["phase"] for r in per_step]
    if phases != [0, 0, 1, 1, 0, 0]:
        raise AssertionError(f"{arch} train: phases {phases}, want [0, 0, 1, 1, 0, 0]")
    n = sum(SSM_GEOMS[arch].values())
    layers = SSM_TRAIN_LAYERS[arch]
    if layers is not None:  # xLSTM: every geometry is a layer's
        n = n * layers // SSM_SERVE_LAYERS[arch]
    keys = {(TRAIN_M, c, r, s) for (c, r, s) in SSM_GEOMS[arch]}
    for r in per_step:
        want = {"lowrank_matmul": n * (2 if SSM_REMAT[arch] == "full" else 1),
                "lowrank_matmul_dx": n, "lowrank_matmul_du": n if r["phase"] == 1 else 0,
                "lowrank_matmul_dv": n if r["phase"] == 0 else 0}
        got = {k: v for k, v in r["launches"].items() if v or k in want}
        seen = {k: v for k, v in r["shapes"].items() if v}
        if got != want or any(v != keys for v in seen.values()):
            raise AssertionError(f"{arch} train: step {r['step']} (phase {r['phase']}) "
                                 f"launched {got} at {seen}, want {want} at {keys}")
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"{arch} train: step {r['step']} loss {r['loss']}")
        log(f"[{arch} train] step {r['step']} phase {r['phase']}: loss {r['loss']:.4f}, grad "
            f"norm {r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms, memory_allocated "
            f"{r['mem'] / 2 ** 30:.2f} GiB; launches "
            + ", ".join(f"{k.replace('lowrank_', '')} {v}" for k, v in r["launches"].items()
                        if v))
    log(f"[{arch} train] 6 steps of {TRAIN_M} tokens (remat {SSM_REMAT[arch]}, "
        f"{layers or 'all'} layers) on "
        f"{torch.cuda.get_device_name(0)}: loss {per_step[0]['loss']:.4f} -> "
        f"{per_step[-1]['loss']:.4f}; {dt:.1f}s incl. init")
    return state.params, by_shape, dict(steps=_without_shapes(per_step), wall_s=dt)


def phase_ssm(archs=SSM_ARCHS):
    """Phases 36-43; returns (launches by kernel and shape per main path,
    results)."""
    paths, result = {}, {}
    for arch in archs:
        out = result[arch] = {}
        engine, paths[f"{arch} serve"], out["serve"] = phase_ssm_serve(arch)
        out["parity"] = phase_ssm_parity(engine, arch)
        out["profile"] = phase_fixed_profile(engine, arch)
        paths[f"{arch} int8 serve"], out["int8"] = phase_family_int8(
            arch, engine, seed=64 + SSM_ARCHS.index(arch))
        del engine
        gc.collect()
        params, paths[f"{arch} train"], out["train"] = phase_ssm_train(arch)
        # the training CLI's steps have warmed the kernels and the allocator
        with at_depth(SSM_TRAIN_LAYERS[arch]):
            run = _cli_run(_ssm_train_argv(arch))
        out["train_profile"] = phase_train_profile(
            params, steps_n=1, run=run, phases=(0, 1), label=f"{arch} train profile",
            warmup=False)
        del params
        gc.collect()
    return paths, result


# --------------------------------------------------------------------------
# The enc-dec family: full-width seamless-m4t-medium (phases 44-49)
# --------------------------------------------------------------------------

# seamless-m4t-medium at full width and depth: 12 encoder and 12 decoder
# layers, d 1024, 16 heads of 64 (KV 16), GELU FFN 4096, a dense 1024 x
# 256256 unembedding (vocab 256206), a stub frontend of 1024 frames.  The
# serve CLI (LRD at Eq.-5 ranks 256 / 409) on its fixed-batch path: 8 rows of
# 256-token prompts and 1024 frames, 32 new tokens.  The train CLI at its
# default Algorithm-1 ranks (255 / 384: Eq. 5 snapped by rank quantization),
# 6 steps of 8 x 256 tokens with 8 x 1024 frames, phases 0,0,1,1,0,0.  The
# encoder runs with the kernels off (the reference's encode is given no
# kernel policy); K1-K4 run on the decoder's factorised projections, the
# cross k/v ones on the memory at M = 8 x 1024; K8 runs every prefill
# attention under attention_impl="flash", the encoder's and the cross
# blocks' not causal.
ED_ARCH = "seamless-m4t-medium"
ED_SLOTS, ED_PROMPT, ED_NEW, ED_PARITY_NEW = 8, 256, 32, 8
ED_LAYERS, ED_FRAMES = 12, 1024
ED_SERVE_ARGV = ["--arch", ED_ARCH, "--lrd", "--slots", str(ED_SLOTS), "--prompt-len",
                 str(ED_PROMPT), "--max-new", str(ED_NEW)]
ED_TRAIN_ARGV = ["--arch", ED_ARCH, "--lrd", "--use-pallas", "--freeze", "sequential",
                 "--steps", "6", "--steps-per-epoch", "2", "--global-batch", str(ED_SLOTS),
                 "--seq-len", str(ED_PROMPT), "--save-every", "1000", "--log-every", "1"]
ED_TOK_M, ED_MEM_M = ED_SLOTS * ED_PROMPT, ED_SLOTS * ED_FRAMES
# (C, r, S) of the decoder's projections: attention (self and cross wq, wk,
# wv, wo), FFN wi and down, at the serve path's Eq.-5 and the train path's
# Algorithm-1 ranks
ED_SERVE_GEOMS = {"attn": (1024, 256, 1024), "wi": (1024, 409, 4096), "down": (4096, 409, 1024)}
ED_TRAIN_GEOMS = {"attn": (1024, 255, 1024), "wi": (1024, 384, 4096), "down": (4096, 384, 1024)}
# K8 launches of one flash prefill: (B, Sq, Sk, H, KV, D, Dv, causal) -> count
ED_FLASH = {(ED_SLOTS, ED_FRAMES, ED_FRAMES, 16, 16, 64, 64, False): ED_LAYERS,
            (ED_SLOTS, ED_PROMPT, ED_FRAMES, 16, 16, 64, 64, False): ED_LAYERS,
            (ED_SLOTS, ED_PROMPT, ED_PROMPT, 16, 16, 64, 64, True): ED_LAYERS}
# checked and timed beside the kernels line, on no main path: K1 in its
# decode design at the train path's Algorithm-1 ranks
ENCDEC_EXTRA_SHAPES = [("lowrank_matmul", dict(M=ED_SLOTS, C=c, r=r, S=s))
                       for c, r, s in ED_TRAIN_GEOMS.values()]


def encdec_kernel_shapes():
    """(name, dims) of every K1-K4 call on the enc-dec paths: K1 at the
    decode, prefill and memory M of the serve geometries, at the train M
    and memory M of the train geometries; K2-K4 at the latter."""
    out = [("lowrank_matmul", dict(M=m, C=c, r=r, S=s))
           for m in (ED_SLOTS, ED_TOK_M) for c, r, s in ED_SERVE_GEOMS.values()]
    c, r, s = ED_SERVE_GEOMS["attn"]
    out.append(("lowrank_matmul", dict(M=ED_MEM_M, C=c, r=r, S=s)))
    for name in ("lowrank_matmul",) + BWD:
        out += [(name, dict(M=ED_TOK_M, C=c, r=r, S=s)) for c, r, s in ED_TRAIN_GEOMS.values()]
        c, r, s = ED_TRAIN_GEOMS["attn"]
        out.append((name, dict(M=ED_MEM_M, C=c, r=r, S=s)))
    return out


def _ed_want(geoms, m_tok: int, m_mem: int = 0, n: int = 1, want=None):
    """Add the K1 launches of ``n`` decoder forwards at ``m_tok`` rows to
    ``want`` ((M, C, r, S) -> count): a layer runs self wq/wk/wv/wo, cross
    wq/wo and FFN wi/down on the decoder's rows, and (in a prefill or train
    step, ``m_mem``) the cross wk/wv on the memory's."""
    want = {} if want is None else want
    attn, wi, down = geoms["attn"], geoms["wi"], geoms["down"]
    for key, k in (((m_tok,) + attn, 6), ((m_tok,) + wi, 1), ((m_tok,) + down, 1),
                   ((m_mem,) + attn, 2 if m_mem else 0)):
        if k:
            want[key] = want.get(key, 0) + k * ED_LAYERS * n
    return want


def _gated(params, seed: int):
    """``params`` with every cross-attention gate (the enc-dec decoder's
    ``dec_stack/cross_attn``, the VLM's ``cross_stack/attn``) a seeded draw
    of +-U(0.3, 1.2) in the param dtype: the init's zeros make tanh(gate)
    zero, so a parity check there would not reach cross-attention (nor the
    encoder's gradients)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    outer, inner = ("dec_stack", "cross_attn") if "dec_stack" in params else ("cross_stack",
                                                                              "attn")
    cross = params[outer][inner]
    gate = cross["gate"]
    mag = torch.rand(gate.shape, generator=gen, device="cuda") * 0.9 + 0.3
    sign = torch.randint(0, 2, gate.shape, generator=gen, device="cuda") * 2 - 1
    return dict(params, **{outer: dict(params[outer],
                                       **{inner: dict(cross, gate=(mag * sign).to(gate.dtype))})})


def _ed_inputs(run, seed: int):
    """Seeded 8 x 256 prompts (on the card) and the serve CLI's extras of 8 x
    1024 frames (``serve.encdec_extras``)."""
    import numpy as np

    from repro_torch.launch import serve

    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, run.model.vocab_size, (ED_SLOTS, ED_PROMPT),
                                           dtype=np.int32), device="cuda")
    return prompts, serve.encdec_extras(run, rng, ED_SLOTS, torch.device("cuda"))


def phase_encdec_serve():
    """Phase 44: the serve CLI on full-width seamless-m4t-medium, the
    fixed-batch path: K1 launches exact by shape (a prefill with the cross
    k/v at M = 8 x 1024, then 31 decode steps at M = 8, whose cross blocks
    project q alone), no other kernel, no scheduler, finite tokens."""
    from repro_torch.launch import serve

    zero_counts()
    t0 = time.perf_counter()
    engine, out = serve.main(ED_SERVE_ARGV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_shape = counts_by_shape()
    want = _ed_want(ED_SERVE_GEOMS, ED_TOK_M, ED_MEM_M)
    _ed_want(ED_SERVE_GEOMS, ED_SLOTS, n=ED_NEW - 1, want=want)
    got = by_shape["lowrank_matmul"]
    others = {k: v for k, v in by_shape.items() if v and k != "lowrank_matmul"}
    cfg = engine.run.model
    if (got != want or others or out.shape != (ED_SLOTS, ED_NEW)
            or engine._scheduler is not None or cfg.vocab_size != 256206
            or cfg.num_layers + cfg.num_encoder_layers != 2 * ED_LAYERS):
        raise AssertionError(f"encdec serve: K1 launches {got}, want {want}; other kernels "
                             f"{others}; tokens {out.shape}; scheduler {engine._scheduler}")
    tok_s = out.size / dt
    log(f"[encdec serve] fixed batch {ED_SLOTS} x {ED_PROMPT} prompts with {ED_FRAMES} frames, "
        f"{ED_NEW} new tokens on {torch.cuda.get_device_name(0)}: {dt:.2f}s incl. init "
        f"({tok_s:.1f} tok/s); {sum(got.values())} K1 launches, exact by shape; no other "
        f"kernel")
    return engine, by_shape, dict(wall_s=dt, tok_per_s=tok_s, k1=sum(got.values()),
                                  sample=out[0].tolist())


def phase_encdec_parity(engine):
    """Phase 45: with every cross gate set to a seeded non-zero value in
    both runs, the prefill's last-position logits through the kernels
    against the plain versions on the card (PATH_RTOL of max |logit|), then
    8 greedy tokens each way, a parting held to a rounding tie."""
    from repro_torch.launch import steps

    run, params = engine.run, _gated(engine.params, seed=45)
    vocab = run.model.vocab_size
    prompts, extras = _ed_inputs(run, seed=45)
    batch = dict(extras, tokens=prompts)
    got, _ = steps.build_prefill_step(run)(params, batch)
    want, _ = steps.build_prefill_step(_plain(run))(params, batch)
    diff, rel = rel_err(got[:, :vocab], want[:, :vocab])
    if not torch.isfinite(got[:, :vocab]).all() or rel > PATH_RTOL:
        raise AssertionError(f"encdec parity: prefill logits {diff:.3e} ({rel:.3e} of max "
                             f"|logit|) from the plain versions'")
    toks, logits = _generate_with_logits(run, params, prompts, ED_PARITY_NEW, extras)
    ptoks, plogits = _generate_with_logits(_plain(run), params, prompts, ED_PARITY_NEW, extras)
    logits = [[t[:vocab] for t in r] for r in logits]
    plogits = [[t[:vocab] for t in r] for r in plogits]
    cmp = _compare_greedy(ptoks, plogits, toks, logits, "encdec parity")
    zero_counts()
    log(f"[encdec parity] cross gates seeded non-zero in both runs; prefill last-position "
        f"logits, kernels vs plain on the card: max_abs_diff {diff:.3e} ({rel:.3e} of max "
        f"|logit|; bound {PATH_RTOL}); {ED_PARITY_NEW} greedy tokens: {_parted_text(cmp)}")
    return dict(max_abs_diff=diff, rel=rel, compare=cmp)


def phase_encdec_flash(engine):
    """Phase 46: the same prefill with ``attention_impl="flash"`` through
    the engine (``generate`` of one token): K8 launches exact (the encoder's
    non-causal 1024 x 1024, the cross blocks' non-causal 256 x 1024, the
    decoder's causal 256 x 256, 12 each), K1 as in a prefill; the
    last-position logits, gates seeded, held to the same prefill through
    the plain versions on the card (K1's and K8's)."""
    from repro_torch.kernels import ref
    from repro_torch.launch import steps
    from repro_torch.serving import ServeConfig, ServeEngine

    run = _with_impl(engine.run, "flash")
    params = _gated(engine.params, seed=46)
    prompts, extras = _ed_inputs(run, seed=46)
    zero_counts()
    eng = ServeEngine(run, params, device="cuda", config=ServeConfig(num_slots=0))
    first = eng.generate(prompts.cpu().numpy(), max_new=1, extras=extras)
    torch.cuda.synchronize()
    by_shape = counts_by_shape()
    want_k1 = _ed_want(ED_SERVE_GEOMS, ED_TOK_M, ED_MEM_M)
    got_k8, got_k1 = by_shape["flash_attention"], by_shape["lowrank_matmul"]
    others = {k: v for k, v in by_shape.items()
              if v and k not in ("lowrank_matmul", "flash_attention")}
    if got_k8 != ED_FLASH or got_k1 != want_k1 or others or first.shape != (ED_SLOTS, 1):
        raise AssertionError(f"encdec flash: K8 {got_k8}, want {ED_FLASH}; K1 {got_k1}, want "
                             f"{want_k1}; others {others}")
    batch = dict(extras, tokens=prompts)
    got, _ = steps.build_prefill_step(run)(params, batch)
    with plain_versions(flash_attention=ref.flash_attention_fwd_ref):
        want, _ = steps.build_prefill_step(_plain(run))(params, batch)
    vocab = run.model.vocab_size
    diff, rel = rel_err(got[:, :vocab], want[:, :vocab])
    zero_counts()
    if not torch.isfinite(got[:, :vocab]).all() or rel > PATH_RTOL:
        raise AssertionError(f"encdec flash: prefill logits {diff:.3e} ({rel:.3e} of max "
                             f"|logit|) from the plain versions'")
    log(f"[encdec flash] prefill through the engine: K8 launches exact "
        + ", ".join(f"{k[1]}x{k[2]} {'causal' if k[7] else 'non-causal'} {n}"
                    for k, n in got_k8.items())
        + f", K1 {sum(got_k1.values())}; cross gates seeded non-zero; last-position logits "
        f"vs K1 and K8 plain on the card: max_abs_diff {diff:.3e} ({rel:.3e} of max |logit|;"
        f" bound {PATH_RTOL})")
    return by_shape, dict(max_abs_diff=diff, rel=rel, k8=sum(got_k8.values()))


def _gemm_ms(by_name):
    """Device ms of cuBLAS / CUTLASS GEMMs in a profile (none of the port's
    kernels has these marks in its name)."""
    marks = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
    return sum(ms for n, ms in by_name.items() if any(k in n.lower() for k in marks))


def phase_encdec_profile(engine, steps_n: int = 5):
    """Phase 47: a fixed-batch decode step (8 rows at position 256, the
    prefill's cache padded to the window), the prefill (blockwise and
    flash) and the encoder alone (which the prefill runs): wall and device
    ms, idle share, K1 and K8 ms, and the cuBLAS GEMMs' ms (the encoder's
    products, which run with the kernels off)."""
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    from repro_torch.serving.engine import pad_cache_preserving_cross

    run, params = engine.run, engine.params
    prompts, extras = _ed_inputs(run, seed=47)
    batch = dict(extras, tokens=prompts)
    last, cache = engine._prefill(params, batch)
    cache = pad_cache_preserving_cross(cache, ED_PROMPT + ED_NEW)
    token = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    pos = torch.tensor(ED_PROMPT, dtype=torch.int32, device="cuda")
    flash = steps.build_prefill_step(_with_impl(run, "flash"))
    calls = (("decode step", steps_n, lambda: engine._step(params, cache, token, pos)),
             ("prefill", 1, lambda: engine._prefill(params, batch)),
             ("flash prefill", 1, lambda: flash(params, batch)),
             ("encoder", 1, lambda: encdec.encode(params, extras["frames"], run.model)))
    k8 = ("k8_ms", "K8", lambda by_name: sum(ms for name, ms in by_name.items()
                                             if "flash_wgmma_kernel" in name))
    return profile_calls("encdec profile", f"{ED_SLOTS} rows", calls,
                         extra=(k8, ("gemm_ms", "cuBLAS GEMMs", _gemm_ms)))


def phase_encdec_train():
    """Phase 48: the training CLI on full-width seamless-m4t-medium at its
    Algorithm-1 ranks, 6 steps of 8 x 256 tokens with 8 x 1024 stub frames
    at phases 0,0,1,1,0,0: per step exactly the K1 of one forward by shape
    (no remat), the same K2, K3 at phase 1 only and K4 at phase 0 only, no
    K5-K8; finite losses."""
    state, per_step, by_shape, dt = _counted_train(ED_TRAIN_ARGV)
    phases = [r["phase"] for r in per_step]
    if phases != [0, 0, 1, 1, 0, 0]:
        raise AssertionError(f"encdec train: phases {phases}, want [0, 0, 1, 1, 0, 0]")
    fwd = _ed_want(ED_TRAIN_GEOMS, ED_TOK_M, ED_MEM_M)
    for r in per_step:
        want = {"lowrank_matmul": fwd, "lowrank_matmul_dx": fwd,
                "lowrank_matmul_du": fwd if r["phase"] == 1 else {},
                "lowrank_matmul_dv": fwd if r["phase"] == 0 else {}}
        got = {k: r["shape_counts"].get(k, {}) for k in want}
        others = {k: v for k, v in r["launches"].items() if v and k not in want}
        if got != want or others:
            raise AssertionError(f"encdec train: step {r['step']} (phase {r['phase']}) "
                                 f"launched {got} and {others}, want {want}")
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"encdec train: step {r['step']} loss {r['loss']}")
        log(f"[encdec train] step {r['step']} phase {r['phase']}: loss {r['loss']:.4f}, grad "
            f"norm {r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms, memory_allocated "
            f"{r['mem'] / 2 ** 30:.2f} GiB; launches "
            + ", ".join(f"{k.replace('lowrank_', '')} {v}" for k, v in r["launches"].items()
                        if v))
    log(f"[encdec train] 6 steps of {ED_TOK_M} tokens and {ED_MEM_M} frames at Algorithm-1 "
        f"ranks on {torch.cuda.get_device_name(0)}: loss {per_step[0]['loss']:.4f} -> "
        f"{per_step[-1]['loss']:.4f}; launches exact by shape each step; {dt:.1f}s incl. init")
    return state.params, by_shape, dict(steps=_without_shapes(per_step), wall_s=dt)


def phase_encdec():
    """Phases 44-49; returns (launches by kernel and shape per main path,
    results, K8's rows at the flash path's shapes)."""
    paths, result = {}, {}
    engine, paths["encdec serve"], result["serve"] = phase_encdec_serve()
    result["parity"] = phase_encdec_parity(engine)
    paths["encdec flash prefill"], result["flash"] = phase_encdec_flash(engine)
    result["profile"] = phase_encdec_profile(engine)
    paths["encdec int8 serve"], result["int8"] = phase_family_int8(ED_ARCH, engine, seed=66)
    del engine
    gc.collect()
    params, paths["encdec train"], result["train"] = phase_encdec_train()
    run = _cli_run(ED_TRAIN_ARGV)
    # the training CLI's steps have warmed the kernels and the allocator
    result["train_profile"] = phase_train_profile(params, steps_n=1, run=run, phases=(0, 1),
                                                  label="encdec train profile", warmup=False)
    result["grads"] = phase_grads(_gated(params, seed=48), run=run, label="encdec grads")
    del params
    gc.collect()
    launched = [flash_dims(key)
                for key in sorted(paths["encdec flash prefill"]["flash_attention"])]
    return paths, result, phase_flash_kernels(launched)


# --------------------------------------------------------------------------
# The VLM family: full-width llama-3.2-vision-90b (phases 50-56)
# --------------------------------------------------------------------------

# llama-3.2-vision-90b at full width: d 8192, 64 heads of 128 (8 KV heads),
# SwiGLU FFN 28672, vocab 128256 (an untied dense unembedding), a cross
# block (tanh-gated cross-attention over 4096 stub image tokens a row, then
# a SwiGLU FFN) after every 4 self layers: 20 groups, 100 layers.  Depth
# cut (the card's 80 GB and the script's time limit): the serve CLI at 2
# groups (8 self + 2 cross layers), the train CLI at 1 group (4 + 1; phase
# -1 of two groups would need ~77 GB before activations).  LRD at Eq.-5
# ranks: wq / wo 2048, wk / wv 455, the FFN 3185, past K1's old ceiling of
# 2048 and K5's of 512.  The serve CLI on its fixed-batch path: 8 rows of
# 256-token prompts, 32 new tokens; the train CLI 4 steps of 8 x 256 tokens
# (phases 0,0,1,1).  K1 and K5 run every factorised projection, the cross
# k/v ones on the image tokens at M = 8 x 4096; K8 runs the prefill's
# attention under attention_impl="flash", the cross blocks' not causal.
VLM_ARCH = "llama-3.2-vision-90b"
VLM_SLOTS, VLM_PROMPT, VLM_NEW, VLM_PARITY_NEW, VLM_IMG = 8, 256, 32, 8, 4096
VLM_EVERY, VLM_SERVE_GROUPS, VLM_TRAIN_GROUPS = 4, 1, 1
VLM_SERVE_ARGV = ["--arch", VLM_ARCH, "--lrd", "--slots", str(VLM_SLOTS), "--prompt-len",
                  str(VLM_PROMPT), "--max-new", str(VLM_NEW)]
VLM_TRAIN_ARGV = ["--arch", VLM_ARCH, "--lrd", "--no-rank-opt", "--use-pallas", "--freeze",
                  "sequential", "--steps", "4", "--steps-per-epoch", "2", "--global-batch",
                  str(VLM_SLOTS), "--seq-len", str(VLM_PROMPT), "--save-every", "1000",
                  "--log-every", "1"]
VLM_TOK_M, VLM_IMG_M = VLM_SLOTS * VLM_PROMPT, VLM_SLOTS * VLM_IMG
# (C, r, S) of the factorised projections at Eq.-5 ranks; gate/up run as K5
# forward and as K1 in the FFN backward's recompute
VLM_GEOMS = {"wq/wo": (8192, 2048, 8192), "wk/wv": (8192, 455, 1024),
             "gate/up": (8192, 3185, 28672), "down": (28672, 3185, 8192)}
# K8 launches of one flash prefill at 2 groups: (B, Sq, Sk, H, KV, D, Dv,
# causal) -> count
VLM_FLASH = {(VLM_SLOTS, VLM_PROMPT, VLM_PROMPT, 64, 8, 128, 128, True):
             VLM_EVERY * VLM_SERVE_GROUPS,
             (VLM_SLOTS, VLM_PROMPT, VLM_IMG, 64, 8, 128, 128, False): VLM_SERVE_GROUPS}
# Item 13's gate, on no main path: the large dense configs' FFNs at their
# Eq.-5 ranks (qwen3-32b, deepseek-coder-33b, qwen2-72b, DeepSeek-V3's dense
# layers), K5 on gate/up and K1 on down, at decode and train M; in the
# kernels line with 0 launches
DENSE_FFN = {"qwen3-32b": (5120, 2133, 25600), "deepseek-coder-33b": (7168, 2609, 19200),
             "qwen2-72b": (8192, 3207, 29568), "deepseek-v3 dense": (7168, 2580, 18432)}
RANK_GATE_SHAPES = ([("lowrank_gated_ffn", dict(M=m, C=c, r=r, F=f))
                     for c, r, f in DENSE_FFN.values() for m in (DECODE_M, TRAIN_M)]
                    + [("lowrank_matmul", dict(M=m, C=f, r=r, S=c))
                       for c, r, f in DENSE_FFN.values() for m in (DECODE_M, TRAIN_M)])


def vlm_kernel_shapes():
    """(name, dims) of every K1-K5 call on the VLM paths: K1 at the decode
    and prefill M of wq/wo, wk/wv and down, at the image tokens' M of the
    cross wk/wv and at the train M of gate/up (the FFN backward's
    recompute); K5 at the decode and prefill M; K2 at the train M of every
    geometry, K3/K4 also at the image tokens' M of wk/wv (the cross k/v
    take no dx: the embeddings need no gradient)."""
    out = []
    for m in (VLM_SLOTS, VLM_TOK_M):
        out += [("lowrank_matmul", dict(M=m, C=c, r=r, S=s))
                for proj, (c, r, s) in VLM_GEOMS.items() if proj != "gate/up"]
        c, r, f = VLM_GEOMS["gate/up"]
        out.append(("lowrank_gated_ffn", dict(M=m, C=c, r=r, F=f)))
    c, r, s = VLM_GEOMS["wk/wv"]
    out.append(("lowrank_matmul", dict(M=VLM_IMG_M, C=c, r=r, S=s)))
    c, r, s = VLM_GEOMS["gate/up"]
    out.append(("lowrank_matmul", dict(M=TRAIN_M, C=c, r=r, S=s)))
    for name in BWD:
        out += [(name, dict(M=TRAIN_M, C=c, r=r, S=s)) for c, r, s in VLM_GEOMS.values()]
    c, r, s = VLM_GEOMS["wk/wv"]
    out += [(name, dict(M=VLM_IMG_M, C=c, r=r, S=s))
            for name in ("lowrank_matmul_du", "lowrank_matmul_dv")]
    return out


def _vlm_fwd(groups: int, m_tok: int, m_img: int = 0, n: int = 1):
    """(K1, K5) launches by shape key of ``n`` forwards of ``groups``
    groups at ``m_tok`` rows: a self layer runs wq/wk/wv/wo and down
    through K1 and gate/up through K5; a cross block the same, its wk/wv on
    the image tokens' ``m_img`` rows (a prefill or train step; none in
    decode, which reads the cross cache)."""
    every = VLM_EVERY
    k1 = {(m_tok,) + VLM_GEOMS["wq/wo"]: 2 * (every + 1), (m_tok,) + VLM_GEOMS["wk/wv"]: 2 * every,
          (m_tok,) + VLM_GEOMS["down"]: every + 1}
    if m_img:
        k1[(m_img,) + VLM_GEOMS["wk/wv"]] = 2
    c, r, f = VLM_GEOMS["gate/up"]
    k5 = {(m_tok, c, r, r, f): every + 1}
    scale = groups * n
    return ({k: v * scale for k, v in k1.items()}, {k: v * scale for k, v in k5.items()})


def _add(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def _vlm_inputs(run, seed: int):
    """Seeded 8 x 256 prompts (on the card) and the serve CLI's extras of 8 x
    4096 stub image embeddings (``serve.vlm_extras``)."""
    import numpy as np

    from repro_torch.launch import serve

    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, run.model.vocab_size, (VLM_SLOTS, VLM_PROMPT),
                                           dtype=np.int32), device="cuda")
    return prompts, serve.vlm_extras(run, rng, VLM_SLOTS, torch.device("cuda"))


def phase_vlm_serve(smi: str):
    """Phase 50: the serve CLI on full-width llama-3.2-vision-90b at 2
    groups, the fixed-batch path: K1 and K5 launches exact by shape (a
    prefill with the cross k/v at M = 8 x 4096, then 31 decode steps at M =
    8, whose cross blocks project q and wo alone), no other kernel, no
    scheduler, finite tokens."""
    from repro_torch.launch import serve

    layers = VLM_SERVE_GROUPS * (VLM_EVERY + 1)
    zero_counts()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with at_depth(layers):
        engine, out = serve.main(VLM_SERVE_ARGV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    by_shape = counts_by_shape()
    k1, k5 = _vlm_fwd(VLM_SERVE_GROUPS, VLM_TOK_M, VLM_IMG_M)
    d1, d5 = _vlm_fwd(VLM_SERVE_GROUPS, VLM_SLOTS, n=VLM_NEW - 1)
    want = {"lowrank_matmul": _add(k1, d1), "lowrank_gated_ffn": _add(k5, d5)}
    got = {k: by_shape[k] for k in want}
    others = {k: v for k, v in by_shape.items() if v and k not in want}
    cfg = engine.run.model
    tokens_ok = bool(((out >= 0) & (out < cfg.vocab_size)).all())
    if (got != want or others or out.shape != (VLM_SLOTS, VLM_NEW) or not tokens_ok
            or engine._scheduler is not None or cfg.num_layers != layers
            or cfg.d_model != 8192 or cfg.vocab_size != 128256):
        raise AssertionError(f"vlm serve: launches {got}, want {want}; other kernels {others}; "
                             f"tokens {out.shape}; scheduler {engine._scheduler}")
    tok_s = out.size / dt
    log(f"[vlm serve] {VLM_ARCH} (d 8192, {layers} of 100 layers: {VLM_SERVE_GROUPS} groups of "
        f"{VLM_EVERY} self + 1 cross) fixed batch {VLM_SLOTS} x {VLM_PROMPT} prompts with "
        f"{VLM_IMG} image tokens, {VLM_NEW} new tokens on {smi}: {dt:.2f}s incl. init "
        f"({tok_s:.1f} tok/s); {sum(got['lowrank_matmul'].values())} K1 + "
        f"{sum(got['lowrank_gated_ffn'].values())} K5 launches, exact by shape (ranks 2048 / "
        f"455 / 3185); no other kernel; max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    return engine, by_shape, dict(wall_s=dt, tok_per_s=tok_s, max_memory_allocated=peak,
                                  k1=sum(got["lowrank_matmul"].values()),
                                  k5=sum(got["lowrank_gated_ffn"].values()),
                                  sample=out[0].tolist())


def phase_vlm_parity(engine):
    """Phase 51: with every cross gate seeded non-zero in both runs, the
    prefill's last-position logits through the kernels against the plain
    versions on the card (PATH_RTOL of max |logit|), then 8 greedy tokens
    each way, a parting held to a rounding tie."""
    from repro_torch.launch import steps

    run, params = engine.run, _gated(engine.params, seed=51)
    vocab = run.model.vocab_size
    prompts, extras = _vlm_inputs(run, seed=51)
    batch = dict(extras, tokens=prompts)
    got, _ = steps.build_prefill_step(run)(params, batch)
    want, _ = steps.build_prefill_step(_plain(run))(params, batch)
    diff, rel = rel_err(got[:, :vocab], want[:, :vocab])
    if not torch.isfinite(got[:, :vocab]).all() or rel > PATH_RTOL:
        raise AssertionError(f"vlm parity: prefill logits {diff:.3e} ({rel:.3e} of max "
                             f"|logit|) from the plain versions'")
    toks, logits = _generate_with_logits(run, params, prompts, VLM_PARITY_NEW, extras)
    ptoks, plogits = _generate_with_logits(_plain(run), params, prompts, VLM_PARITY_NEW, extras)
    logits = [[t[:vocab] for t in r] for r in logits]
    plogits = [[t[:vocab] for t in r] for r in plogits]
    cmp = _compare_greedy(ptoks, plogits, toks, logits, "vlm parity")
    zero_counts()
    log(f"[vlm parity] cross gates seeded non-zero in both runs; prefill last-position logits, "
        f"kernels vs plain on the card: max_abs_diff {diff:.3e} ({rel:.3e} of max |logit|; "
        f"bound {PATH_RTOL}); {VLM_PARITY_NEW} greedy tokens: {_parted_text(cmp)}")
    return dict(max_abs_diff=diff, rel=rel, compare=cmp)


def phase_vlm_flash(engine):
    """Phase 52: the same prefill with ``attention_impl="flash"`` through
    the engine (``generate`` of one token): K8 launches exact (8 self
    causal 256 x 256, 2 cross non-causal 256 x 4096, D 128), K1 and K5 as
    in a prefill; the last-position logits, gates seeded, held to the same
    prefill through the plain versions on the card (K1's, K5's and K8's)."""
    from repro_torch.kernels import ref
    from repro_torch.launch import steps
    from repro_torch.serving import ServeConfig, ServeEngine

    run = _with_impl(engine.run, "flash")
    params = _gated(engine.params, seed=52)
    prompts, extras = _vlm_inputs(run, seed=52)
    zero_counts()
    eng = ServeEngine(run, params, device="cuda", config=ServeConfig(num_slots=0))
    first = eng.generate(prompts.cpu().numpy(), max_new=1, extras=extras)
    torch.cuda.synchronize()
    by_shape = counts_by_shape()
    k1, k5 = _vlm_fwd(VLM_SERVE_GROUPS, VLM_TOK_M, VLM_IMG_M)
    got = {k: by_shape[k] for k in ("flash_attention", "lowrank_matmul", "lowrank_gated_ffn")}
    want = {"flash_attention": VLM_FLASH, "lowrank_matmul": k1, "lowrank_gated_ffn": k5}
    others = {k: v for k, v in by_shape.items() if v and k not in want}
    if got != want or others or first.shape != (VLM_SLOTS, 1):
        raise AssertionError(f"vlm flash: launches {got}, want {want}; others {others}")
    batch = dict(extras, tokens=prompts)
    out, _ = steps.build_prefill_step(run)(params, batch)
    with plain_versions(flash_attention=ref.flash_attention_fwd_ref):
        plain, _ = steps.build_prefill_step(_plain(run))(params, batch)
    vocab = run.model.vocab_size
    diff, rel = rel_err(out[:, :vocab], plain[:, :vocab])
    zero_counts()
    if not torch.isfinite(out[:, :vocab]).all() or rel > PATH_RTOL:
        raise AssertionError(f"vlm flash: prefill logits {diff:.3e} ({rel:.3e} of max "
                             f"|logit|) from the plain versions'")
    log(f"[vlm flash] prefill through the engine: K8 launches exact "
        + ", ".join(f"{k[1]}x{k[2]} {'causal' if k[7] else 'non-causal'} {n}"
                    for k, n in got["flash_attention"].items())
        + f", K1 {sum(k1.values())}, K5 {sum(k5.values())}; cross gates seeded non-zero; "
        f"last-position logits vs K1, K5 and K8 plain on the card: max_abs_diff {diff:.3e} "
        f"({rel:.3e} of max |logit|; bound {PATH_RTOL})")
    return by_shape, dict(max_abs_diff=diff, rel=rel, k8=sum(VLM_FLASH.values()))


def phase_vlm_profile(engine, smi: str, steps_n: int = 5):
    """Phase 53: a fixed-batch decode step (8 rows at position 256, the
    prefill's cache padded to the window, the cross k/v at 4096 image
    tokens), the prefill (blockwise and flash): wall and device ms, idle
    share, K1, K5 and K8 ms, and ``max_memory_allocated`` over the calls."""
    from repro_torch.launch import steps
    from repro_torch.serving.engine import pad_cache_preserving_cross

    run, params = engine.run, engine.params
    prompts, extras = _vlm_inputs(run, seed=53)
    batch = dict(extras, tokens=prompts)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    last, cache = engine._prefill(params, batch)
    cache = pad_cache_preserving_cross(cache, VLM_PROMPT + VLM_NEW)
    token = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    pos = torch.tensor(VLM_PROMPT, dtype=torch.int32, device="cuda")
    flash = steps.build_prefill_step(_with_impl(run, "flash"))
    calls = (("decode step", steps_n, lambda: engine._step(params, cache, token, pos)),
             ("prefill", 1, lambda: engine._prefill(params, batch)),
             ("flash prefill", 1, lambda: flash(params, batch)))
    k5 = ("k5_ms", "K5", lambda by_name: lowrank_device_ms(by_name)[1])
    k8 = ("k8_ms", "K8", lambda by_name: sum(ms for name, ms in by_name.items()
                                             if "flash_wgmma_kernel" in name))
    out = profile_calls("vlm profile", f"{VLM_SLOTS} rows, {run.model.num_layers} layers, {smi}",
                        calls, extra=(k5, k8, ("gemm_ms", "cuBLAS GEMMs", _gemm_ms)))
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"[vlm profile] max_memory_allocated over the prefill and the calls "
        f"{out['max_memory_allocated'] / 2 ** 30:.2f} GiB ({smi})")
    return out


def phase_vlm_train(smi: str):
    """Phase 54: the training CLI on full-width llama-3.2-vision-90b at 1
    group (4 self + 1 cross layer), Eq.-5 ranks, 4 steps of 8 x 256 tokens
    with 8 x 4096 stub image embeddings at phases 0,0,1,1: per step exactly
    the K1 and K5 of one forward by shape, K1 on gate/up again (the FFN
    backward's recompute), K2 on every factor pair but the cross wk/wv
    (their input, the embeddings, takes no gradient), K3 at phase 1 only
    and K4 at phase 0 only, on every pair; no K6-K8; finite losses."""
    layers = VLM_TRAIN_GROUPS * (VLM_EVERY + 1)
    torch.cuda.reset_peak_memory_stats()
    with at_depth(layers):
        state, per_step, by_shape, dt = _counted_train(VLM_TRAIN_ARGV)
    peak = torch.cuda.max_memory_allocated()
    phases = [r["phase"] for r in per_step]
    if phases != [0, 0, 1, 1]:
        raise AssertionError(f"vlm train: phases {phases}, want [0, 0, 1, 1]")
    k1, k5 = _vlm_fwd(VLM_TRAIN_GROUPS, TRAIN_M, VLM_IMG_M)
    recompute = {(TRAIN_M,) + VLM_GEOMS["gate/up"]: 2 * (VLM_EVERY + 1) * VLM_TRAIN_GROUPS}
    pairs = _add(k1, recompute)
    dx = {k: v for k, v in pairs.items() if k[0] != VLM_IMG_M}
    for r in per_step:
        want = {"lowrank_matmul": pairs, "lowrank_gated_ffn": k5, "lowrank_matmul_dx": dx,
                "lowrank_matmul_du": pairs if r["phase"] == 1 else {},
                "lowrank_matmul_dv": pairs if r["phase"] == 0 else {}}
        got = {k: r["shape_counts"].get(k, {}) for k in want}
        others = {k: v for k, v in r["launches"].items() if v and k not in want}
        if got != want or others:
            raise AssertionError(f"vlm train: step {r['step']} (phase {r['phase']}) launched "
                                 f"{got} and {others}, want {want}")
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"vlm train: step {r['step']} loss {r['loss']}")
        log(f"[vlm train] step {r['step']} phase {r['phase']}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms, memory_allocated "
            f"{r['mem'] / 2 ** 30:.2f} GiB; launches "
            + ", ".join(f"{k.replace('lowrank_', '')} {v}" for k, v in r["launches"].items()
                        if v))
    log(f"[vlm train] 4 steps of {TRAIN_M} tokens and {VLM_IMG_M} image tokens at Eq.-5 ranks, "
        f"{layers} of 100 layers ({VLM_TRAIN_GROUPS} group), on {smi}: loss "
        f"{per_step[0]['loss']:.4f} -> {per_step[-1]['loss']:.4f}; launches exact by shape each "
        f"step; max_memory_allocated {peak / 2 ** 30:.2f} GiB; {dt:.1f}s incl. init")
    return state.params, by_shape, dict(steps=_without_shapes(per_step), wall_s=dt,
                                        max_memory_allocated=peak)


@contextlib.contextmanager
def expandable_segments():
    """Inside, the caching allocator grows its segments in place (PyTorch's
    ``expandable_segments``), so the VLM train step's multi-GiB blocks (the
    float32 unembedding and its gradient, 3.9 GiB each) do not strand
    reserved memory between them: without it phase 55's phase -1 step
    failed with 13.5 GiB reserved but unallocated.  The phases before keep
    the default allocator."""
    # the setter's name moved between PyTorch releases
    setter = (getattr(torch._C, "_accelerator_setAllocatorSettings", None)
              or torch.cuda.memory._set_allocator_settings)
    gc.collect()
    torch.cuda.empty_cache()
    setter("expandable_segments:True")
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        setter("expandable_segments:False")


def phase_vlm(smi: str):
    """Phases 50-56; returns (launches by kernel and shape per main path,
    results, K8's rows at the flash path's shapes).  The train phases run
    under :func:`expandable_segments`."""
    paths, result = {}, {}
    engine, paths["vlm serve"], result["serve"] = phase_vlm_serve(smi)
    result["parity"] = phase_vlm_parity(engine)
    paths["vlm flash prefill"], result["flash"] = phase_vlm_flash(engine)
    result["profile"] = phase_vlm_profile(engine, smi)
    paths["vlm int8 serve"], result["int8"] = phase_family_int8(VLM_ARCH, engine, seed=67,
                                                                smi=smi)
    del engine
    with expandable_segments():
        params, paths["vlm train"], result["train"] = phase_vlm_train(smi)
        with at_depth(VLM_TRAIN_GROUPS * (VLM_EVERY + 1)):
            run = _cli_run(VLM_TRAIN_ARGV)
        # phase 55: a step profiled at phases -1, 0 and 1 (max_memory_allocated
        # each); phase 56: the gradients, gates seeded, against the plain versions
        result["train_profile"] = phase_train_profile(params, steps_n=1, run=run,
                                                      label="vlm train profile")
        result["grads"] = phase_grads(_gated(params, seed=56), run=run, label="vlm grads")
        del params
    launched = [flash_dims(key)
                for key in sorted(paths["vlm flash prefill"]["flash_attention"])]
    return paths, result, phase_flash_kernels(launched)


# --------------------------------------------------------------------------
# The int8 export of the SSM, hybrid, enc-dec and VLM families (phases
# 64-67, each inside its family's group)
# --------------------------------------------------------------------------

# Each family's fixed-batch serve from its analytic int8 export, built on
# the params its group already made (the same widths and depth cuts; the
# enc-dec and VLM cross gates seeded non-zero): 8 x 256 prompts (with 1024
# stub frames, or 4096 stub image tokens, a row), 32 new tokens.  At full
# width the analytic export keeps every group factorised, truncated to the
# serve ranks below, so every projection of the decoder runs K7, Zamba2's
# and the VLM's past rank 512; no group merges, so K6 is not reached.  The
# enc-dec encoder runs with the kernels off, as the reference's encode: its
# int8 groups take the weight-only formula and launch nothing.
INT8_FAM_SLOTS, INT8_FAM_PROMPT, INT8_FAM_NEW, INT8_FAM_PARITY_NEW = 8, 256, 32, 8
INT8_FAM_TOK_M = INT8_FAM_SLOTS * INT8_FAM_PROMPT
INT8_FAM_ITERS = 20  # timing iterations of the family rows (their plain versions are slow)
# family -> (C, S) -> the analytic export's serve rank at full width (the
# JAX export's, at probe_tokens 1: the fixed-batch engine's)
INT8_FAM_RANKS = {
    "xlstm-350m": {(1024, 1024): 128},
    "zamba2-1.2b": {(2048, 8384): 768, (4096, 2048): 640, (4096, 4096): 896,
                    (4096, 8192): 1280, (8192, 4096): 1280},
    ED_ARCH: {(1024, 1024): 128, (1024, 4096): 384, (4096, 1024): 384},
    VLM_ARCH: {(8192, 8192): 1920, (8192, 1024): 384, (8192, 28672): 3072,
               (28672, 8192): 3072}}
# family -> (applications of each (C, S) a forward runs on its token rows,
# (M, C, S) -> applications a prefill also runs on other rows): as the K1
# tables above, with a SwiGLU's gate and up two applications (int8 groups
# skip K5) and (VLM) at its serve depth of VLM_SERVE_GROUPS groups
_VLM_G = VLM_SERVE_GROUPS
INT8_FAM_APPS = {
    "xlstm-350m": ({(c, s): n for (c, _, s), n in SSM_GEOMS["xlstm-350m"].items()}, {}),
    "zamba2-1.2b": ({(c, s): n for (c, _, s), n in SSM_GEOMS["zamba2-1.2b"].items()},
                    {(SSM_TAIL_M, c, s): n for (c, _, s), n in SSM_TAIL["zamba2-1.2b"].items()}),
    ED_ARCH: ({(1024, 1024): 6 * ED_LAYERS, (1024, 4096): ED_LAYERS, (4096, 1024): ED_LAYERS},
              {(ED_MEM_M, 1024, 1024): 2 * ED_LAYERS}),
    VLM_ARCH: ({(8192, 8192): 2 * (VLM_EVERY + 1) * _VLM_G, (8192, 1024): 2 * VLM_EVERY * _VLM_G,
                (8192, 28672): 2 * (VLM_EVERY + 1) * _VLM_G,
                (28672, 8192): (VLM_EVERY + 1) * _VLM_G},
               {(VLM_IMG_M, 8192, 1024): 2 * _VLM_G})}
# K7 at its ceiling, checked and timed beside the family rows (no main path
# runs it)
INT8_CEILING_SHAPES = [("int8_lowrank_linear", (m, 4096, 4096, 4096))
                       for m in (INT8_FAM_SLOTS, INT8_FAM_TOK_M)]
# K7 past rank 512 checked by ``--only kernels``: every Zamba2 and VLM serve
# geometry at M 8 and 2048, and the ceiling
INT8_WIDE_SHAPES = ([("int8_lowrank_linear", (m, c, r, s_))
                     for arch in ("zamba2-1.2b", VLM_ARCH)
                     for (c, s_), r in INT8_FAM_RANKS[arch].items()
                     for m in (INT8_FAM_SLOTS, INT8_FAM_TOK_M)] + INT8_CEILING_SHAPES)


def _int8_fam_want(arch):
    """K7 launches by (M, C, r, S) of one fixed-batch generate: a prefill
    at M = 8 x 256 (and its other rows), then INT8_FAM_NEW - 1 decode
    steps at M = 8."""
    tok, extra = INT8_FAM_APPS[arch]
    ranks = INT8_FAM_RANKS[arch]
    want = {}
    for m, n in ((INT8_FAM_TOK_M, 1), (INT8_FAM_SLOTS, INT8_FAM_NEW - 1)):
        for (c, s_), k in tok.items():
            want[(m, c, ranks[(c, s_)], s_)] = k * n
    for (m, c, s_), k in extra.items():
        key = (m, c, ranks[(c, s_)], s_)
        want[key] = want.get(key, 0) + k
    return want


def _int8_fam_inputs(run, seed: int):
    """The family's 8 x 256 prompts (on the card) and its ``generate``
    extras: the enc-dec frames or the VLM's image embeddings as the serve
    CLI draws them, else None."""
    import numpy as np

    if run.model.family == "encdec":
        return _ed_inputs(run, seed)
    if run.model.family == "vlm":
        return _vlm_inputs(run, seed)
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, run.model.vocab_size,
                                        (INT8_FAM_SLOTS, INT8_FAM_PROMPT), dtype=np.int32),
                           device="cuda"), None


def phase_family_int8(arch, engine, seed: int, smi: str = ""):
    """Phases 64-67: the family's analytic int8 export of ``engine``'s
    params (cross gates seeded), timed, its ranks held to INT8_FAM_RANKS;
    a fixed-batch generate of 8 x 256 prompts and 32 new tokens with K7's
    launches exact by shape (every factorised projection of every layer, a
    decode step's at M = 8) and no other kernel; the prefill's last-position
    logits through K7 against its plain version on the card (INT8_PATH_RTOL)
    and 8 greedy tokens each way, identical; the gap to the bf16 round trip
    of the same tree and to the family's bf16 serve of the same params
    (reported, not bounded: xLSTM-350M's random weights are chaotic); one
    prefill and 5 decode steps profiled with K7 ms."""
    import dataclasses

    import numpy as np

    from repro_torch.launch import steps
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.serving.engine import pad_cache_preserving_cross

    run = engine.run
    cfg, tag = run.model, f"{arch} int8"
    params = _gated(engine.params, seed) if cfg.family in ("encdec", "vlm") else engine.params
    prompts, extras = _int8_fam_inputs(run, seed)
    batch = dict(extras or {}, tokens=prompts)
    vocab = cfg.vocab_size
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ieng = ServeEngine(run, params, device="cuda",
                       config=ServeConfig(export="analytic", export_int8=True))
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    report, ranks = ieng.export_report, INT8_FAM_RANKS[arch]
    bad = {p: (tuple(l.shape), l.rank_serve, l.merged) for p, l in report.layers.items()
           if l.merged or not l.quantized or l.rank_serve != ranks.get(tuple(l.shape))}
    if bad:
        raise AssertionError(f"{tag}: export groups off the expected serve ranks {ranks}: {bad}")
    log(f"[{tag}] analytic int8 export of {cfg.num_layers} layers in {export_s:.1f} s on "
        f"{smi or torch.cuda.get_device_name(0)}: {report.summary()}")
    for (c, s_), groups in _geometries(report).items():
        lay = groups[0][1]
        log(f"[{tag}]   (C {c}, S {s_}): {len(groups)} groups "
            f"({', '.join(p for p, _ in groups)}), r_train {lay.rank_train} -> r_serve "
            f"{lay.rank_serve}, int8 factors (K7)")
    zero_counts()
    t0 = time.perf_counter()
    out = ieng.generate(prompts.cpu().numpy(), max_new=INT8_FAM_NEW, extras=extras)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_shape = counts_by_shape()
    want = _int8_fam_want(arch)
    got = by_shape["int8_lowrank_linear"]
    others = {k: v for k, v in by_shape.items() if v and k != "int8_lowrank_linear"}
    tokens_ok = bool(((out >= 0) & (out < vocab)).all())
    if (got != want or others or out.shape != (INT8_FAM_SLOTS, INT8_FAM_NEW) or not tokens_ok
            or ieng._scheduler is not None):
        raise AssertionError(f"{tag} serve: K7 launches {got}, want {want}; other kernels "
                             f"{others}; tokens {out.shape} (in range: {tokens_ok})")
    per_step = sum(INT8_FAM_APPS[arch][0].values())
    past = sorted({k[2] for k in got if k[2] > 512})
    log(f"[{tag} serve] fixed batch {INT8_FAM_SLOTS} x {INT8_FAM_PROMPT} prompts"
        + (f" with {', '.join(f'{v.shape[1]} {k}' for k, v in extras.items())} a row"
           if extras else "")
        + f", {INT8_FAM_NEW} new tokens from the int8 export: {dt:.2f}s "
        f"({out.size / dt:.1f} tok/s); {sum(got.values())} K7 launches, exact by shape, "
        f"{per_step} a decode step (every factorised projection of {cfg.num_layers} layers)"
        + (f", ranks past 512: {past}" if past else "") + "; no other kernel")
    # parity: the same tree through K7's plain version on the card
    got_l, _ = ieng._prefill(ieng.params, batch)
    with plain_int8():
        want_l, _ = ieng._prefill(ieng.params, batch)
        ptoks = ieng.generate(prompts.cpu().numpy(), max_new=INT8_FAM_PARITY_NEW, extras=extras)
    zero_counts()
    err, rel = rel_err(got_l[:, :vocab], want_l[:, :vocab])
    if not torch.isfinite(got_l[:, :vocab]).all() or rel > INT8_PATH_RTOL:
        raise AssertionError(f"{tag} parity: last-position logits differ by {err:.3e} "
                             f"({rel:.3e} of max |logit|) > {INT8_PATH_RTOL}")
    if not np.array_equal(ptoks, out[:, :INT8_FAM_PARITY_NEW]):
        raise AssertionError(f"{tag} parity: greedy tokens differ: kernels "
                             f"{out[:, :INT8_FAM_PARITY_NEW].tolist()} vs plain {ptoks.tolist()}")
    # reported, not bounded: the bf16 round trip of the same tree, and the
    # family's bf16 serve of the same params
    rt_run = dataclasses.replace(run, lrd=dataclasses.replace(run.lrd, int8_decode="bf16"))
    rt_l, _ = steps.build_prefill_step(rt_run)(ieng.params, batch)
    bf_l, _ = engine._prefill(params, batch)
    bf_toks = ServeEngine(run, params, device="cuda").generate(
        prompts.cpu().numpy(), max_new=INT8_FAM_PARITY_NEW, extras=extras)
    zero_counts()
    rt_gap, rt_rel = rel_err(got_l[:, :vocab], rt_l[:, :vocab])
    bf_gap, bf_rel = rel_err(got_l[:, :vocab], bf_l[:, :vocab])
    same = out[:, :INT8_FAM_PARITY_NEW] == bf_toks
    agree = [int(row.argmin()) if not row.all() else INT8_FAM_PARITY_NEW for row in same]
    log(f"[{tag} parity] prefill last-position logits, K7 vs its plain version on the card: "
        f"max_abs_diff {err:.3e} ({rel:.3e} of max |logit| {want_l[:, :vocab].abs().max().item():.3f};"
        f" bound {INT8_PATH_RTOL}); greedy {INT8_FAM_PARITY_NEW}/{INT8_FAM_PARITY_NEW} identical "
        f"in all {INT8_FAM_SLOTS} rows; reported, not bounded: vs the bf16 round trip of the "
        f"same tree {rt_gap:.3e} ({rt_rel:.3e}), vs the bf16 serve of the same params at their "
        f"Eq.-5 ranks {bf_gap:.3e} ({bf_rel:.3e}), greedy tokens agreeing with the bf16 "
        f"serve's for the first {agree} of {INT8_FAM_PARITY_NEW} (by row)")
    # profile: one prefill and 5 decode steps at position 256
    last, cache = ieng._prefill(ieng.params, batch)
    cache = pad_cache_preserving_cross(cache, INT8_FAM_PROMPT + INT8_FAM_NEW)
    token = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    pos = torch.tensor(INT8_FAM_PROMPT, dtype=torch.int32, device="cuda")
    calls = (("decode step", 5, lambda: ieng._step(ieng.params, cache, token, pos)),
             ("prefill", 1, lambda: ieng._prefill(ieng.params, batch)))
    k7 = ("k7_ms", "K7", lambda by_name: int8_device_ms(by_name)[1])
    prof = profile_calls(f"{tag} profile", f"{INT8_FAM_SLOTS} rows, {cfg.num_layers} layers"
                         + (f", {smi}" if smi else ""), calls, extra=(k7,))
    del ieng, cache
    gc.collect()
    return by_shape, dict(
        export_s=export_s, summary=report.summary(),
        ranks={f"{c}x{s_}": r for (c, s_), r in ranks.items()}, wall_s=dt,
        tok_per_s=out.size / dt, k7=sum(got.values()), k7_per_decode_step=per_step,
        max_abs_diff=err, rel=rel, bf16_round_trip_gap=rt_gap, bf16_round_trip_rel=rt_rel,
        bf16_serve_gap=bf_gap, bf16_serve_rel=bf_rel, bf16_agree=agree, profile=prof)


def phase_family_int8_kernels(rows, paths, extra=()):
    """K7 rows, both entries, at every int8 shape ``paths`` launched that
    ``rows`` does not hold yet (the serving entry, then its int8-operand
    twin), and at ``extra`` (on no main path), timed with INT8_FAM_ITERS
    iterations."""
    held = {(r["name"], shape_key(r["name"], r["shape"])) for r in rows}
    shapes = sorted({(name, key) for by in paths.values() for name in INT8_FUSED
                     for key in by.get(name, {}) if (name, key) not in held})
    out = phase_int8_kernels(shapes, iters=INT8_FAM_ITERS)
    more = phase_int8_kernels([sk for sk in extra if sk not in held], iters=INT8_FAM_ITERS)
    for row in more:
        row["on_main_path"] = False
    return out + more


# --------------------------------------------------------------------------
# MLA and MTP: full-width DeepSeek-V3 (phases 57-63)
# --------------------------------------------------------------------------

# deepseek-v3-671b at full width: d 7168, 128 heads, MLA (q latent 1536, kv
# latent 512, nope / rope / v head dims 128 / 64 / 128), 3 dense layers
# (SwiGLU 18432) then 58 MoE layers (256 experts of 2048, top-8, a shared
# expert, moe_impl "ep"), an untied vocab of 129280, an MTP layer (itself a
# MoE layer).  LRD at Eq.-5 ranks: q_up 722, kv_up 252, wo 2493, the dense
# FFN 2580, experts and shared expert 796, mtp/proj 2389 (q_down / kv_down
# stay dense: the policy keeps MLA's latent projections).  Depth cut (the
# card's 80 GB): serve at the 3 dense and 2 of the 58 MoE layers (about 28
# GB of bf16 parameters), train at 1 dense layer with the MTP layer as the
# one MoE layer (about 15 GB, 60 GB at phase -1 before activations).
# Serving: 8 slots, 8 prompts of 256 tokens, 32 new tokens, the scheduler's
# slot layout; the prefill's attention through K8 at q/k head dim 192 and v
# head dim 128 under attention_impl="flash".
DS_ARCH = "deepseek-v3-671b"
DS_SLOTS, DS_PROMPT, DS_NEW, DS_PARITY_NEW = 8, 256, 32, 8
DS_DENSE, DS_SERVE_LAYERS, DS_TRAIN_LAYERS = 3, 5, 1
DS_SPEC_KS = (2, 4)
DS_TOK_M = DS_SLOTS * DS_PROMPT
DS_TRAIN_ARGV = ["--arch", DS_ARCH, "--lrd", "--no-rank-opt", "--use-pallas", "--freeze",
                 "sequential", "--steps", "4", "--steps-per-epoch", "2", "--global-batch",
                 str(DS_SLOTS), "--seq-len", str(DS_PROMPT), "--save-every", "1000",
                 "--log-every", "1"]
# (C, r, S) of each factorised projection at Eq.-5 ranks; "ffn" and "shared"
# are the dense FFN's and the shared expert's gate/up (K5 forward, K1 in the
# FFN backward's recompute)
DS_GEOMS = {"q_up": (1536, 722, 24576), "kv_up": (512, 252, 32768),
            "wo": (16384, 2493, 7168), "ffn": (7168, 2580, 18432),
            "ffn down": (18432, 2580, 7168), "shared": (7168, 796, 2048),
            "shared down": (2048, 796, 7168), "mtp proj": (14336, 2389, 7168)}
DS_K8 = dict(H=128, KV=128, D=192, Dv=128)
# K8 launches of one flash prefill: (B, Sq, Sk, H, KV, D, Dv, causal) -> count
DS_FLASH = {(DS_SLOTS, DS_PROMPT, DS_PROMPT, 128, 128, 192, 128, True): DS_SERVE_LAYERS}
# K8 at (192, 128) beyond the prefill's shape, in the kernels line with 0
# launches: a 2048-token causal prefill, 256 queries over 2048 keys without
# the mask, two batch rows, ragged lengths
DS_FLASH_EXTRA = [dict(B=1, Sq=2048, Sk=2048, causal=True, **DS_K8),
                  dict(B=1, Sq=256, Sk=2048, causal=False, **DS_K8),
                  dict(B=2, Sq=256, Sk=256, causal=True, **DS_K8),
                  dict(B=1, Sq=333, Sk=333, causal=True, **DS_K8),
                  dict(B=1, Sq=200, Sk=333, causal=False, **DS_K8)]


def _ds_fwd(m: int, layers: int, *, decode: bool = False, mtp: bool = False, n: int = 1):
    """(K1, K5) launches by shape key of ``n`` forwards at ``m`` rows of a
    cut of ``layers`` layers (the first DS_DENSE dense), with the MTP layer
    (a MoE layer) and mtp/proj under ``mtp``: each layer's q_up, kv_up and wo
    (no kv_up in decode: the absorbed decode reads kv_up's factors through
    one library product), the dense FFN's down and the shared expert's down
    through K1, their gate/up through K5."""
    g = DS_GEOMS
    dense = min(layers, DS_DENSE)
    moe = layers - dense + int(mtp)
    attn = layers + int(mtp)
    k1 = {g["q_up"]: attn, g["kv_up"]: 0 if decode else attn, g["wo"]: attn,
          g["ffn down"]: dense, g["shared down"]: moe, g["mtp proj"]: int(mtp)}
    k5 = {g["ffn"]: dense, g["shared"]: moe}
    return ({(m,) + geom: c * n for geom, c in k1.items() if c},
            {(m, c, r, r, f): k * n for (c, r, f), k in k5.items() if k})


def mla_kernel_shapes():
    """(name, dims) of every K1-K5 call on the DeepSeek-V3 paths: K1 and K5
    at a scheduler prefill's M (one 256-token prompt), the 8-slot decode and
    draft M, the speculative verify's M at k = 2 and 4 (no kv_up in
    decode), and the batched prefill's and train step's M (with mtp/proj
    and the FFN backward's recompute of gate/up); K2-K4 at the train M on
    every factor pair."""
    g, out = DS_GEOMS, []
    serve = ("q_up", "kv_up", "wo", "ffn down", "shared down")
    for m in (DS_SLOTS, *(DS_SLOTS * (k + 1) for k in DS_SPEC_KS), DS_PROMPT, DS_TOK_M):
        decode = m < DS_PROMPT
        out += [("lowrank_matmul", dict(M=m, C=c, r=r, S=s)) for name, (c, r, s) in g.items()
                if name in serve and not (decode and name == "kv_up")]
        out += [("lowrank_gated_ffn", dict(M=m, C=c, r=r, F=f))
                for c, r, f in (g["ffn"], g["shared"])]
    out += [("lowrank_matmul", dict(M=TRAIN_M, C=c, r=r, S=s))
            for c, r, s in (g["mtp proj"], g["ffn"], g["shared"])]
    for name in BWD:
        out += [(name, dict(M=TRAIN_M, C=c, r=r, S=s)) for c, r, s in g.values()]
    return out


def _ds_run(moe_impl: str = "ep"):
    """The serve run: full-width DeepSeek-V3 at DS_SERVE_LAYERS layers, LRD
    at Eq.-5 ranks on the card (``serve.serve_run``, the serve CLI's)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config(DS_ARCH), num_layers=DS_SERVE_LAYERS, moe_impl=moe_impl)
    return serve.serve_run(cfg, max_len=DS_PROMPT + DS_NEW, slots=DS_SLOTS, lrd=True,
                           device=torch.device("cuda"), seed=0)


def _ds_prompts(seed: int):
    """8 seeded prompts of 256 tokens, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 129280, (DS_SLOTS, DS_PROMPT), generator=gen, device="cuda",
                         dtype=torch.int32)


def _ds_engine(run, params, **kw):
    from repro_torch.serving import ServeConfig, ServeEngine

    return ServeEngine(run, params, device="cuda",
                       config=ServeConfig(num_slots=DS_SLOTS, max_len=DS_PROMPT + DS_NEW,
                                          prefill_len=DS_PROMPT, **kw),
                       draft_params=params if kw.get("speculative_k") else None)


def _ds_trace(prompts):
    return [{"prompt": p, "max_new": DS_NEW} for p in prompts.cpu().numpy()]


def phase_mla_serve(smi: str):
    """Phase 57: ``ServeEngine.serve`` of 8 prompts of 256 tokens, 32 new
    tokens each, through the scheduler on full-width DeepSeek-V3 at 5
    layers: the slot layout (no page table), 8 prefill forwards at M = 256
    and 31 decode forwards at M = 8, K1 and K5 launches exact by shape, no
    other kernel, tokens in the vocabulary; the Eq.-5 ranks of the plan."""
    from repro_torch.launch import steps

    run = _ds_run()
    zero_counts()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, plan = steps.init_params(run, "cuda")
    init_s = time.perf_counter() - t0
    engine = _ds_engine(run, params)
    trace = _ds_trace(_ds_prompts(57))
    toks, logits, by_shape, stats, fwd, dt, _ = _serve_trace(engine, trace)
    peak = torch.cuda.max_memory_allocated()
    sched, cfg = engine.scheduler, run.model
    ranks = {path.split("/", 2)[-1]: lp.rank for path, lp in plan.layers.items()}
    want_ranks = {"attn/q_up": 722, "attn/kv_up": 252, "attn/wo": 2493}
    k1, k5 = _ds_fwd(DS_PROMPT, DS_SERVE_LAYERS, n=fwd["prefill"])
    d1, d5 = _ds_fwd(DS_SLOTS, DS_SERVE_LAYERS, decode=True, n=fwd["decode"])
    want = {"lowrank_matmul": _add(k1, d1), "lowrank_gated_ffn": _add(k5, d5)}
    got = {k: by_shape[k] for k in want}
    others = {k: v for k, v in by_shape.items() if v and k not in want}
    vocab_ok = all(0 <= t < cfg.vocab_size for row in toks for t in row)
    if (sched.layout != "slots" or sched.pages is not None or got != want or others
            or (fwd["prefill"], fwd["decode"]) != (DS_SLOTS, DS_NEW - 1) or not vocab_ok
            or (cfg.d_model, cfg.num_heads, cfg.vocab_size, cfg.num_experts) !=
            (7168, 128, 129280, 256) or any(ranks.get(k) != v for k, v in want_ranks.items())):
        raise AssertionError(f"mla serve: layout {sched.layout}, forwards {fwd}, launches "
                             f"{got}, want {want}; others {others}; ranks {ranks}")
    log(f"[mla serve] {DS_ARCH} (d 7168, 128 heads, MLA, {DS_SERVE_LAYERS} of 61 layers: "
        f"{DS_DENSE} dense + {DS_SERVE_LAYERS - DS_DENSE} MoE of 256 experts top-8, ep) on "
        f"{smi}: {DS_SLOTS} requests x {DS_PROMPT}-token prompts, {DS_NEW} new tokens, layout "
        f"{sched.layout} (cache {sched.cache_bytes() / 2 ** 20:.1f} MiB); "
        f"{stats['tok_per_s']:.1f} tok/s, {dt:.2f}s serve + {init_s:.1f}s init; "
        f"{fwd['prefill']} prefill + {fwd['decode']} decode forwards, "
        f"{sum(got['lowrank_matmul'].values())} K1 + {sum(got['lowrank_gated_ffn'].values())} "
        f"K5 launches exact by shape (ranks q_up 722, kv_up 252, wo 2493, FFN 2580, shared "
        f"796); no other kernel; max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    return engine, by_shape, dict(wall_s=dt, init_s=init_s, tok_per_s=stats["tok_per_s"],
                                  fwd=dict(fwd), max_memory_allocated=peak,
                                  k1=sum(got["lowrank_matmul"].values()),
                                  k5=sum(got["lowrank_gated_ffn"].values()),
                                  tokens=toks, logits=logits, stats=stats)


def _ds_pinned(fn_k, fn_p):
    """``fn_k()`` with the router recorded, then ``fn_p()`` replaying its
    expert ids (MoE capacity drops follow the ids, so both runs route and
    drop alike); returns both results and the recorded calls."""
    calls = []
    with routing(record=calls):
        a = fn_k()
    with routing(replay=calls):
        b = fn_p()
    return a, b, calls


def phase_mla_parity(engine):
    """Phase 58, routing pinned in every comparison: the batched prefill's
    last-position logits (8 x 256, M = 2048) and one absorbed decode step's
    (8 rows at position 256) through the kernels against the plain versions
    on the card (PATH_RTOL of max |logit|); the absorbed decode of token 16
    after a 16-token prefill against the full-mode forward over the 17
    tokens, with moe_impl "dense" (ep's capacity depends on the token count,
    so the two would drop different pairs); 8 greedy tokens of the
    fixed-batch path both ways, a parting held to a rounding tie."""
    import dataclasses

    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serving.engine import pad_cache

    run, params = engine.run, engine.params
    plain = _plain(run)
    vocab = run.model.vocab_size
    prompts = _ds_prompts(58)
    batch = {"tokens": prompts}
    pos = torch.full((DS_SLOTS,), DS_PROMPT, dtype=torch.int32, device="cuda")

    def prefill_decode(r):
        last, cache = steps.build_prefill_step(r)(params, batch)
        cache = pad_cache(cache, DS_PROMPT + DS_NEW)
        token = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        logits, _, _ = steps.build_serve_step(r)(params, cache, token, pos)
        return last[:, :vocab], logits[:, -1, :vocab]

    (kpre, kdec), (ppre, pdec), _ = _ds_pinned(lambda: prefill_decode(run),
                                               lambda: prefill_decode(plain))
    out = {}
    for what, got, want in (("prefill", kpre, ppre), ("decode", kdec, pdec)):
        diff, rel = rel_err(got, want)
        if not torch.isfinite(got).all() or rel > PATH_RTOL:
            raise AssertionError(f"mla parity ({what}): logits {diff:.3e} ({rel:.3e} of max "
                                 f"|logit|) from the plain versions'")
        out[what] = dict(max_abs_diff=diff, rel=rel)
    del kpre, kdec, ppre, pdec
    # absorbed decode against the full forward, routing of the full run
    # replayed (the prefill's rows, then the decoded position's)
    dense = dataclasses.replace(run.model, moe_impl="dense")
    toks = prompts[:, :17]
    with torch.inference_mode():
        calls = []
        with routing(record=calls):
            full, _, _ = lm.lm_apply(params, toks, dense, mode="full", policy=True)
        k = run.model.num_experts_per_tok
        ids = [c[0].reshape(DS_SLOTS, 17, k) for c in calls]
        replay = ([(i[:, :16].reshape(-1, k), None) for i in ids]
                  + [(i[:, 16].reshape(-1, k), None) for i in ids])
        with routing(replay=replay):
            _, cache, _ = lm.lm_apply(params, toks[:, :16], dense, mode="full", policy=True)
            cache = pad_cache(cache, 17)
            dec, _, _ = lm.lm_apply(params, toks[:, 16:], dense, mode="decode", cache=cache,
                                    pos=torch.full((DS_SLOTS,), 16, device="cuda"),
                                    policy=True)
    diff, rel = rel_err(dec[:, 0, :vocab], full[:, 16, :vocab])
    if not torch.isfinite(dec).all() or rel > PATH_RTOL:
        raise AssertionError(f"mla parity: absorbed decode {diff:.3e} ({rel:.3e} of max "
                             f"|logit|) from the full forward")
    out["decode_vs_full"] = dict(max_abs_diff=diff, rel=rel)
    del full, dec, cache
    (toks_k, logits_k), (toks_p, logits_p), _ = _ds_pinned(
        lambda: _generate_with_logits(run, params, prompts, DS_PARITY_NEW),
        lambda: _generate_with_logits(plain, params, prompts, DS_PARITY_NEW))
    logits_k = [[t[:vocab] for t in r] for r in logits_k]
    logits_p = [[t[:vocab] for t in r] for r in logits_p]
    cmp = _compare_greedy(toks_p, logits_p, toks_k, logits_k, "mla parity")
    out["greedy"] = cmp
    zero_counts()
    log(f"[mla parity] routing pinned; kernels vs plain on the card: batched prefill "
        f"last-position logits {out['prefill']['rel']:.3e} and absorbed-decode logits "
        f"{out['decode']['rel']:.3e} of max |logit| (bound {PATH_RTOL}); absorbed decode of "
        f"token 16 vs the full forward over 17 tokens (moe dense): {rel:.3e}; "
        f"{DS_PARITY_NEW} greedy tokens: {_parted_text(cmp)}")
    return out


def phase_mla_flash(engine):
    """Phase 59: the batched prefill with ``attention_impl="flash"`` through
    the engine (``generate`` of one token, the fixed-batch path): K8 at
    (192, 128) exact (5 causal 256 x 256 launches over 128 heads), K1 and
    K5 as in a prefill at M = 2048; its last-position logits against the
    blockwise prefill's (the same kernels otherwise), routing pinned."""
    from repro_torch.launch import steps
    from repro_torch.serving import ServeConfig, ServeEngine

    run = _with_impl(engine.run, "flash")
    params = engine.params
    prompts = _ds_prompts(59)
    zero_counts()
    eng = ServeEngine(run, params, device="cuda", config=ServeConfig(num_slots=0))
    first = eng.generate(prompts.cpu().numpy(), max_new=1)
    torch.cuda.synchronize()
    by_shape = counts_by_shape()
    k1, k5 = _ds_fwd(DS_TOK_M, DS_SERVE_LAYERS)
    got = {k: by_shape[k] for k in ("flash_attention", "lowrank_matmul", "lowrank_gated_ffn")}
    want = {"flash_attention": DS_FLASH, "lowrank_matmul": k1, "lowrank_gated_ffn": k5}
    others = {k: v for k, v in by_shape.items() if v and k not in want}
    if got != want or others or first.shape != (DS_SLOTS, 1):
        raise AssertionError(f"mla flash: launches {got}, want {want}; others {others}")
    batch = {"tokens": prompts}
    (out, _), (block, _), _ = _ds_pinned(
        lambda: steps.build_prefill_step(run)(params, batch),
        lambda: steps.build_prefill_step(engine.run)(params, batch))
    vocab = run.model.vocab_size
    diff, rel = rel_err(out[:, :vocab], block[:, :vocab])
    zero_counts()
    if not torch.isfinite(out[:, :vocab]).all() or rel > PATH_RTOL:
        raise AssertionError(f"mla flash: prefill logits {diff:.3e} ({rel:.3e} of max "
                             f"|logit|) from the blockwise prefill's")
    log(f"[mla flash] prefill through the engine: K8 at (192, 128) "
        + ", ".join(f"{k[1]}x{k[2]} x {k[3]} heads {'causal' if k[7] else 'non-causal'} {n}"
                    for k, n in got["flash_attention"].items())
        + f", K1 {sum(k1.values())}, K5 {sum(k5.values())}; last-position logits vs the "
        f"blockwise prefill (routing pinned): max_abs_diff {diff:.3e} ({rel:.3e} of max "
        f"|logit|; bound {PATH_RTOL})")
    return by_shape, dict(max_abs_diff=diff, rel=rel, k8=sum(DS_FLASH.values()))


def phase_mla_spec(params):
    """Phase 60: the same 8 requests plain and self-speculative at k = 2 and
    4 with the draft = the params (no second tree), all three with moe_impl
    "dense": under "ep" a step's capacity depends on its token count, so a
    (B, k + 1) verify chunk would drop other pairs than a plain decode step
    and part from it for that reason alone.  Tokens held to the plain
    run's (a parting must be a rounding tie), a rejected draft to the
    verify's margin; forwards and K1 / K5 launches exact by shape;
    acceptance and a speculative step's wall and device ms."""
    run = _ds_run(moe_impl="dense")
    trace = _ds_trace(_ds_prompts(60))
    engine = _ds_engine(run, params)
    ref_toks, ref_logits, by_shape, stats, fwd, dt, _ = _serve_trace(engine, trace)
    del engine
    paths, out = {"mla spec plain": by_shape}, dict(plain=dict(tok_per_s=stats["tok_per_s"],
                                                                 fwd=fwd, wall_s=dt))
    for k in DS_SPEC_KS:
        engine = _ds_engine(run, params, speculative_k=k)
        sched = engine.scheduler
        toks, logits, by_shape, stats, fwd, dt, margins = _serve_trace(engine, trace)
        p1, p5 = _ds_fwd(DS_PROMPT, DS_SERVE_LAYERS, n=fwd["prefill"])
        d1, d5 = _ds_fwd(DS_SLOTS, DS_SERVE_LAYERS, decode=True, n=fwd["draft"])
        v1, v5 = _ds_fwd(DS_SLOTS * (k + 1), DS_SERVE_LAYERS, decode=True, n=fwd["verify"])
        want = {"lowrank_matmul": _add(_add(p1, d1), v1),
                "lowrank_gated_ffn": _add(_add(p5, d5), v5)}
        got = {name: by_shape[name] for name in want}
        others = {name: v for name, v in by_shape.items() if v and name not in want}
        if (fwd["decode"] or fwd["draft"] != k * fwd["verify"] or got != want or others
                or sched.layout != "slots"):
            raise AssertionError(f"mla spec k={k}: forwards {fwd}, launches {got}, want "
                                 f"{want}; others {others}")
        cmp = _compare_greedy(ref_toks, ref_logits, toks, logits, f"mla spec k={k}")
        acc = sched.acceptance_rate()
        if any(not m < cmp["worst_logit_abs"] for m in margins):
            raise AssertionError(f"mla spec k={k}: rejected drafts with verify margins "
                                 f"{sorted(margins)[-3:]} >= {cmp['worst_logit_abs']:.3e}")
        st = dict(sched.spec_stats)
        out[f"k={k}"] = dict(tok_per_s=stats["tok_per_s"], wall_s=dt, fwd=fwd, acceptance=acc,
                             spec_stats=st, compare=cmp, reject_margins=margins)
        paths[f"mla spec k={k}"] = by_shape
        log(f"[mla spec] k={k}, draft = the params (moe dense): acceptance {acc:.4f} "
            f"({len(margins)} slot-steps rejected a draft), {st['spec_steps']} steps, "
            f"{fwd['draft']} draft + {fwd['verify']} verify forwards (K1 by M "
            f"{_by_m(by_shape, 'lowrank_matmul')}); {stats['tok_per_s']:.1f} tok/s (plain "
            f"{out['plain']['tok_per_s']:.1f}); {_parted_text(cmp)}; {dt:.1f}s")
        del engine, sched
    return paths, out


def phase_mla_profile(engine, smi: str, steps_n: int = 5):
    """Phase 61: a decode step of the scheduler's step function on its slot
    cache (8 rows at position 256), the scheduler's one-prompt prefill (M =
    256) and the batched prefill (8 x 256, blockwise and flash): wall and
    device ms, idle share, K1, K5 and K8 ms, cuBLAS GEMMs and the experts'
    bmm; ``max_memory_allocated`` over the calls."""
    from repro_torch.launch import steps

    run, params, sched = engine.run, engine.params, engine.scheduler
    prompts = _ds_prompts(61)
    token = torch.zeros((DS_SLOTS, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((DS_SLOTS,), DS_PROMPT, dtype=torch.int32, device="cuda")
    one = {"tokens": prompts[:1]}
    last = torch.tensor([DS_PROMPT - 1], device="cuda")
    batch = {"tokens": prompts}
    flash = steps.build_prefill_step(_with_impl(run, "flash"))
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    calls = (("decode step", steps_n, lambda: sched._decode(params, sched.cache, token, pos)),
             ("scheduler prefill", 3, lambda: sched._prefill(params, one, last)),
             ("batched prefill", 1, lambda: engine._prefill(params, batch)),
             ("flash prefill", 1, lambda: flash(params, batch)))
    k5 = ("k5_ms", "K5", lambda by_name: lowrank_device_ms(by_name)[1])
    k8 = ("k8_ms", "K8", lambda by_name: sum(ms for name, ms in by_name.items()
                                             if "flash_wgmma_kernel" in name))
    out = profile_calls("mla profile", f"{DS_SLOTS} slots, {run.model.num_layers} layers, {smi}",
                        calls, extra=(k5, k8, ("gemm_ms", "cuBLAS GEMMs", _gemm_ms)))
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"[mla profile] max_memory_allocated over the calls "
        f"{out['max_memory_allocated'] / 2 ** 30:.2f} GiB ({smi})")
    return out


def phase_mla_train(smi: str):
    """Phase 62: the training CLI on full-width DeepSeek-V3 at 1 dense layer
    with its MTP layer (the one MoE layer; the main MoE stack empty), Eq.-5
    ranks, 4 steps of 8 x 256 tokens at phases 0,0,1,1: per step exactly the
    K1 and K5 of one forward by shape with mtp/proj, K1 on gate/up again (the
    FFN backward's recompute), K2 on every factor pair, K3 at phase 1 only
    and K4 at phase 0 only, the MTP layer's pairs included; no K6-K8;
    finite losses."""
    torch.cuda.reset_peak_memory_stats()
    with at_depth(DS_TRAIN_LAYERS, first_k_dense=DS_TRAIN_LAYERS):
        state, per_step, by_shape, dt = _counted_train(DS_TRAIN_ARGV)
    peak = torch.cuda.max_memory_allocated()
    phases = [r["phase"] for r in per_step]
    if phases != [0, 0, 1, 1]:
        raise AssertionError(f"mla train: phases {phases}, want [0, 0, 1, 1]")
    if tuple(state.params["moe_stack"]["norm1"]["scale"].shape) != (0, 7168):
        raise AssertionError("mla train: the MoE stack is not empty")
    k1, k5 = _ds_fwd(TRAIN_M, DS_TRAIN_LAYERS, mtp=True)
    recompute = {(m, c, r, f): 2 * n for (m, c, r, _, f), n in k5.items()}
    pairs = _add(k1, recompute)
    for r in per_step:
        want = {"lowrank_matmul": pairs, "lowrank_gated_ffn": k5, "lowrank_matmul_dx": pairs,
                "lowrank_matmul_du": pairs if r["phase"] == 1 else {},
                "lowrank_matmul_dv": pairs if r["phase"] == 0 else {}}
        got = {k: r["shape_counts"].get(k, {}) for k in want}
        others = {k: v for k, v in r["launches"].items() if v and k not in want}
        if got != want or others:
            raise AssertionError(f"mla train: step {r['step']} (phase {r['phase']}) launched "
                                 f"{got} and {others}, want {want}")
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"mla train: step {r['step']} loss {r['loss']}")
        log(f"[mla train] step {r['step']} phase {r['phase']}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.3f}, {r['step_time_s'] * 1e3:.1f} ms, memory_allocated "
            f"{r['mem'] / 2 ** 30:.2f} GiB; launches "
            + ", ".join(f"{k.replace('lowrank_', '')} {v}" for k, v in r["launches"].items()
                        if v))
    log(f"[mla train] 4 steps of {TRAIN_M} tokens at Eq.-5 ranks (loss + 0.3 MTP + 0.01 aux), "
        f"1 dense layer + the MTP layer (256 experts), on {smi}: loss "
        f"{per_step[0]['loss']:.4f} -> {per_step[-1]['loss']:.4f}; launches exact by shape each "
        f"step, K3 absent at phase 0 and K4 at phase 1 on the MTP pairs too; "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; {dt:.1f}s incl. init")
    return state.params, by_shape, dict(steps=_without_shapes(per_step), wall_s=dt,
                                        max_memory_allocated=peak)


def phase_mla(smi: str):
    """Phases 57-63; returns (launches by kernel and shape per main path,
    results, K8's rows at (192, 128)).  The train phases run under
    :func:`expandable_segments`."""
    paths, result, secs = {}, {}, {}
    t = [time.perf_counter()]

    def lap(what):
        secs[what] = time.perf_counter() - t[0]
        t[0] = time.perf_counter()

    engine, paths["mla serve"], result["serve"] = phase_mla_serve(smi)
    lap("serve")
    result["parity"] = phase_mla_parity(engine)
    lap("parity")
    paths["mla flash prefill"], result["flash"] = phase_mla_flash(engine)
    result["profile"] = phase_mla_profile(engine, smi)
    lap("flash and profile")
    params = engine.params
    del engine
    more, result["spec"] = phase_mla_spec(params)
    paths.update(more)
    lap("speculative")
    del params
    gc.collect()
    with expandable_segments():
        params, paths["mla train"], result["train"] = phase_mla_train(smi)
        with at_depth(DS_TRAIN_LAYERS, first_k_dense=DS_TRAIN_LAYERS):
            run = _cli_run(DS_TRAIN_ARGV)
        lap("train")
        # phase 63: a step profiled at phases -1, 0 and 1 (max_memory_allocated
        # each), then the gradients against the plain versions, routing pinned
        result["train_profile"] = phase_train_profile(params, steps_n=1, run=run, moe=True,
                                                      label="mla train profile", donate=True)
        result["grads"] = phase_moe_grads(params, run=run, label="mla grads")
        lap("train profile and grads")
        del params
    launched = [flash_dims(key) for key in sorted(paths["mla flash prefill"]["flash_attention"])]
    extra = phase_flash_kernels(DS_FLASH_EXTRA)
    for row in extra:
        row["on_main_path"] = False
    rows = phase_flash_kernels(launched) + extra
    lap("K8 rows")
    result["seconds"] = secs
    log("[mla] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return paths, result, rows


# --------------------------------------------------------------------------
# Phases 69-70: the autotuner, the meta dry-run and the roofline
# --------------------------------------------------------------------------

# phase 69's tuning keys, smollm-360m's serve and train geometries: K1 at the
# decode step (8), the prefill (128), either side of its large_m thresholds
# (256, 320) and the train step / flash prefill (2048 bucket); K5 at the
# same M; K2-K4 at the train step; K8 at the 2016-token flash prefill (M
# Sq, C the heads of a batch row, r the head dim, S Sk).  Each entry goes
# under freeze phases -1, 0 and 1 (the serve path and both train phases).
TUNE_M = (DECODE_M, PREFILL_M, 256, 320, TRAIN_M)
TUNE_CALLS = (
    (("lowrank_fwd",), [(m, *g) for m in TUNE_M for g in sorted(set(PROJ.values()))]),
    (("lowrank_ffn",), [(m, *PROJ["gate/up"]) for m in TUNE_M]),
    (("lowrank_dx", "lowrank_du", "lowrank_dv"),
     [(TRAIN_M, *g) for g in sorted(set(PROJ.values()))]),
    (("flash",), [(FLASH_PROMPT, FLASH_SERVE_SHAPE["H"], FLASH_SERVE_SHAPE["D"],
                   FLASH_PROMPT)]),
)
# the keys a phase-7 train step looks up (M TRAIN_M): K1 on every
# geometry (gate/up in the FFN backward's recompute), K5, K2-K4
TUNE_TRAIN_KEYS = ([("lowrank_fwd", (TRAIN_M, *g)) for g in set(PROJ.values())]
                   + [("lowrank_ffn", (TRAIN_M, *PROJ["gate/up"]))]
                   + [(op, (TRAIN_M, *g)) for op in ("lowrank_dx", "lowrank_du", "lowrank_dv")
                      for g in set(PROJ.values())])


def _tune_argv(table: Path, ops, shapes):
    return (["--table", str(table), "--ops", *ops, "--shapes"]
            + ["x".join(map(str, s)) for s in shapes] + ["--freeze-phase", "-1", "0", "1"])


@contextlib.contextmanager
def autotuned_train_cli(table: Path):
    """The train CLI's runs with ``lrd.pallas_autotune`` on and ``table``
    as ``lrd.pallas_autotune_table`` (the CLI has no flag for them, as the
    reference's has none): its ``build_run`` wrapped while open."""
    import dataclasses

    from repro_torch.launch import train

    build = train.build_run

    def tuned(args):
        run = build(args)
        return dataclasses.replace(run, lrd=dataclasses.replace(
            run.lrd, pallas_autotune=True, pallas_autotune_table=str(table)))

    train.build_run = tuned
    try:
        yield
    finally:
        train.build_run = build


def phase_autotune(train_off=None):
    """Phase 69: the autotune CLI twice on a fresh table over TUNE_CALLS
    (run 1: every entry measured on this card, no fallback reason; run 2:
    every key a cache hit, nothing measured), each tuned choice printed
    beside the hand-set one; then phase 7's train CLI with the table
    (launches exactly phase 7's, losses within LOSS_RTOL of ``train_off``,
    phase 7's per-step records (a run of its own when None), bit for bit
    where every choice it looks up is the hand-set one; no fallback), and
    one full-width 2016-token flash prefill under the table against the
    plain path (kernels off, blockwise attention) at phase 5's bound."""
    import dataclasses

    from repro_torch.kernels import autotune
    from repro_torch.launch import steps

    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kind = torch.cuda.get_device_name(0)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        table_path = Path(tmp) / "tune.json"
        autotune.set_table(None)
        for call, (ops, shapes) in enumerate(TUNE_CALLS):
            autotune.main(_tune_argv(table_path, ops, shapes))
        run1 = autotune.TuningTable.load(str(table_path))
        bad = {k: e for k, e in run1.entries.items()
               if e.source != "measured" or e.device_kind != kind or e.fallback_reason}
        if bad or not run1.entries:
            raise AssertionError(f"autotune run 1: {len(bad)} of {len(run1)} entries not "
                                 f"measured on {kind}: {list(bad.items())[:3]}")
        t_run1 = time.perf_counter() - t0
        hits = 0
        for ops, shapes in TUNE_CALLS:
            autotune.set_table(None)
            run2 = autotune.main(_tune_argv(table_path, ops, shapes))
            hits += run2.stats["hit"]
            if run2.stats["miss"] or run2.stats["stale"] or run2.entries != run1.entries:
                raise AssertionError(f"autotune run 2 ({ops}): lookups {run2.stats}, "
                                     f"{len(run2)} entries against run 1's {len(run1)}")
        log(f"[autotune] run 1: {len(run1)} entries, all measured on {kind}, in "
            f"{t_run1:.1f}s; run 2: {hits} cache hits, nothing measured")
        rows, same = [], {}
        for ops, shapes in TUNE_CALLS:
            for op in ops:
                for m, c, r, s in shapes:
                    e = run1.lookup(op, m, c, r, s, torch.bfloat16, kind=kind)
                    hand = autotune.hand_choice(op, m, c, r, s, sms)
                    same[(op, (m, c, r, s))] = e.choice == hand
                    rows.append(dict(op=op, M=m, C=c, r=r, S=s, tuned=e.choice.text(),
                                     tuned_us=e.us, hand=hand.text(), hand_us=e.hand_us,
                                     predicted_us=e.predicted_us))
                    log(f"[autotune] {op} {m}x{c}x{r}x{s}: tuned {e.choice.text()} "
                        f"{e.us:.1f}us (predicted {e.predicted_us:.1f}us); hand-set "
                        f"{hand.text()} {e.hand_us:.1f}us; tuned/hand "
                        f"{e.us / e.hand_us:.3f}")
        out["entries"] = rows
        zero_counts()  # the tuner's timing launches are not the main path's
        if train_off is None:
            _, train_off, _, _ = _counted_train(TRAIN_ARGV)
        autotune.set_table(None)  # kernel_policy loads it from lrd.pallas_autotune_table
        with telemetry_capture() as (reg, fallbacks), autotuned_train_cli(table_path):
            _, per_step, by_shape, dt = _counted_train(TRAIN_ARGV)
        lookups = reg.snapshot().get("autotune_lookups", {}).get("series", {})
        if not lookups or any(not k.endswith("result=hit") for k in lookups):
            raise AssertionError(f"autotune train: lookups {lookups}, want hits only")
        all_hand = all(same[k] for k in TUNE_TRAIN_KEYS)
        for r, off in zip(per_step, train_off):
            _check_step("autotune train", r, _leaf_ranks(PROJ))
            rel = abs(r["loss"] - off["loss"]) / abs(off["loss"])
            if rel > LOSS_RTOL or (all_hand and r["loss"] != off["loss"]):
                raise AssertionError(f"autotune train: step {r['step']} loss {r['loss']!r} "
                                     f"against {off['loss']!r} untuned (every choice "
                                     f"hand-set: {all_hand})")
        if fallbacks:
            raise AssertionError(f"autotune train: kernel_fallbacks {list(fallbacks)[:3]}")
        log(f"[autotune] train (phase 7's CLI, pallas_autotune on): launches exactly phase "
            f"7's; losses {[round(r['loss'], 5) for r in per_step]} against "
            f"{[round(r['loss'], 5) for r in train_off]} untuned ("
            + ("bit for bit: every choice looked up is the hand-set one" if all_hand else
               f"within {LOSS_RTOL}") + f"); no fallback; lookups {lookups}; {dt:.1f}s")
        out["train"] = dict(steps=_without_shapes(per_step), all_hand=all_hand,
                            lookups=lookups, wall_s=dt)
        # one 2016-token flash prefill under the table against the plain path,
        # at full width and depth (the serve CLI's run)
        from repro_torch.configs import get_config
        from repro_torch.launch import serve

        run = serve.serve_run(get_config("smollm-360m"), max_len=FLASH_MAX_LEN, slots=DECODE_M,
                              lrd=True, device=torch.device("cuda"), seed=0)
        tuned = dataclasses.replace(run, model=dataclasses.replace(
            run.model, attention_impl="flash"), lrd=dataclasses.replace(
                run.lrd, pallas_autotune=True, pallas_autotune_table=str(table_path)))
        plain = _plain(run)
        params, _ = steps.init_params(run, "cuda")
        tokens = _long_prompt(run, 1)
        zero_counts()
        got = steps.build_prefill_step(tuned)(params, {"tokens": tokens})[0]
        launched = counts_by_shape()
        want = steps.build_prefill_step(plain)(params, {"tokens": tokens})[0]
        err, rel = rel_err(got, want)
        n_layers = run.model.num_layers
        counts = {k: sum(v.values()) for k, v in launched.items() if v}
        if (not torch.isfinite(got).all() or rel > PATH_RTOL
                or counts != {"lowrank_matmul": 5 * n_layers, "lowrank_gated_ffn": n_layers,
                              "flash_attention": n_layers}):
            raise AssertionError(f"autotune prefill: {rel:.3e} of max |logit| (bound "
                                 f"{PATH_RTOL}), launches {counts}")
        log(f"[autotune] flash prefill 1 x {tokens.shape[1]} under the table: last-position "
            f"logits {err:.3e} ({rel:.3e} of max |logit|; bound {PATH_RTOL}) from the plain "
            f"path; launches {counts}")
        out["prefill"] = dict(max_abs_diff=err, rel=rel, launches=counts)
        del params
    autotune.set_table(None)
    out["seconds"] = time.perf_counter() - t0
    log(f"[run] phase 69 (autotune) {out['seconds']:.1f} s")
    return {"tuned train": by_shape, "tuned prefill": launched}, out


def _train_batch_cuda(run):
    """The phase-7 shape's int32 tokens and labels, on the card."""
    b, s = run.shape.global_batch, run.shape.seq_len
    gen = torch.Generator(device="cuda").manual_seed(7)
    return {k: torch.randint(0, run.model.vocab_size, (b, s), generator=gen, device="cuda",
                             dtype=torch.int32) for k in ("tokens", "labels")}


def phase_dryrun(train_profile=None):
    """Phase 70: phase 7's train step as a meta dry-run cell at phases -1 /
    0 / 1 against the same step counted on the card: argument bytes (the
    live TrainState plus the batch), FLOPs (by dtype), bytes and kernel
    launches equal exactly; the roofline's step bound beside phase 9's
    device ms (``train_profile``), the meta peak beside
    ``max_memory_allocated``.  Then the dry-run CLI for smollm-360m at
    train_4k and decode_32k, and ``analysis.report`` over both cells."""
    from repro_torch.analysis import report
    from repro_torch.analysis.cost import counting
    from repro_torch.analysis.roofline import model_flops_per_device, roofline_terms
    from repro_torch.launch import dryrun, steps

    t0 = time.perf_counter()
    run = _train_run()
    params, _ = steps.init_params(run, "cuda")
    mf = model_flops_per_device(run.model.active_params(), TRAIN_M, 1)
    out, paths = {}, {}
    for phase in (-1, 0, 1):
        fn, args, donate = dryrun.cell(run, phase)
        meta = dryrun.measure_cell(fn, args, donate)
        state = steps.make_train_state(run.optim, params, phase)[0]
        batch = _train_batch_cuda(run)
        arg_bytes = dryrun._tree_bytes((state, batch))
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with counting() as card:
            dryrun.train_fn(run, phase, "cuda")(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        paths[f"dry-run card step {phase}"] = counts_by_shape()
        mc = meta["step_cost"]
        got = dict(argument_bytes=arg_bytes, flops=card.flops, bytes=card.bytes,
                   flops_by_dtype=card.flops_by_dtype, kernel_launches=card.kernel_launches)
        want = dict(argument_bytes=meta["memory_per_device"]["argument_bytes"],
                    flops=mc["flops"], bytes=mc["bytes"], flops_by_dtype=mc["flops_by_dtype"],
                    kernel_launches=mc["kernel_launches"])
        if got != want:
            diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
            byop = {k: (card.bytes_by_op.get(k), mc["bytes_by_op"].get(k))
                    for k in set(card.bytes_by_op) | set(mc["bytes_by_op"])
                    if card.bytes_by_op.get(k) != mc["bytes_by_op"].get(k)}
            raise AssertionError(f"dry-run phase {phase}: card {diff} (card, meta); bytes by "
                                 f"op {byop}")
        rl = roofline_terms(card, model_flops=mf, specs=H100_SPECS)
        measured = (train_profile or {}).get(phase, {}).get("device_ms")
        share = (f"{rl.step_s * 1e3 / measured:.1%} of phase 9's {measured:.2f} ms of device "
                 f"time" if measured else "phase 9 not run")
        row = dict(argument_bytes=arg_bytes, flops=card.flops, bytes=card.bytes,
                   flops_by_dtype=card.flops_by_dtype, kernel_launches=card.kernel_launches,
                   meta_peak_bytes=meta["memory_per_device"]["temp_bytes"],
                   max_memory_allocated=peak, compute_ms=rl.compute_s * 1e3,
                   memory_ms=rl.memory_s * 1e3, bound_ms=rl.step_s * 1e3,
                   device_ms=measured, model_flops=mf)
        out[phase] = row
        log(f"[dryrun] phase {phase}: meta = card exactly: argument bytes {arg_bytes}, "
            f"FLOPs {card.flops:.6e} ({', '.join(f'{k} {v:.4e}' for k, v in sorted(card.flops_by_dtype.items()))}), "
            f"bytes {card.bytes:.6e}, launches {card.kernel_launches}; roofline "
            f"({H100_SPECS.name}) compute {rl.compute_s * 1e3:.2f} ms, memory "
            f"{rl.memory_s * 1e3:.2f} ms, bound {rl.step_s * 1e3:.2f} ms ({rl.dominant}): "
            f"{share}; meta peak {row['meta_peak_bytes'] / 2 ** 30:.2f} GiB, card "
            f"max_memory_allocated {peak / 2 ** 30:.2f} GiB above the state")
        del state, batch
    del params
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        cells = {}
        for argv in (["--shape", "train_4k", "--microbatches", "2", "--attn-blocks",
                      "4096,4096"], ["--shape", "decode_32k"]):
            t1 = time.perf_counter()
            res = dryrun.main(["--arch", "smollm-360m", "--out", tmp] + argv)
            cells[argv[1]] = dict(seconds=time.perf_counter() - t1,
                                  memory=res["memory_per_device"],
                                  cost=res["cost_analysis_per_device"])
        rows = report.main(["--dir", tmp, "--json", str(Path(tmp) / "roofline.json")])
        if len(rows) != 2 or not all(math.isfinite(r["step_lower_bound_s"]) for r in rows):
            raise AssertionError(f"report: {rows}")
        out["cells"], out["report"] = cells, rows
        log("[dryrun] CLI cells " + "; ".join(
            f"{k} {v['seconds']:.1f}s, {v['cost']['flops']:.3e} FLOPs" for k, v in cells.items()))
    out["seconds"] = time.perf_counter() - t0
    log(f"[run] phase 70 (dry-run and roofline) {out['seconds']:.1f} s")
    return paths, out


def phase_rank_gate_kernels(skip=()):
    """K5 and K1 at the large dense configs' FFN geometries (item 13's
    gate, on no main path), for the kernels line; shapes in ``skip`` have
    rows of their own already (DeepSeek-V3's dense FFN is on its path)."""
    rows = phase_kernels([sd for sd in RANK_GATE_SHAPES if sd not in skip])
    for row in rows:
        row["on_main_path"] = False
    return rows


# --------------------------------------------------------------------------
# Phases 71-73: sharded training on two gloo ranks of the one card
# --------------------------------------------------------------------------
#
# Two processes share cuda:0 over gloo (NCCL refuses two ranks on one GPU):
# (a) pure data parallelism on mesh (2, 1), two steps at phase -1 / 0 / 1;
# (b) the int8 gradient sync on (2, 1) at phases 0 and 1; (c) TP on (1, 2)
# at phase -1 / 0 / 1.  Full-width smollm-360m with LRD at Eq.-5 ranks, the
# 8 x 256 batch of phase 7, at SHARD_LAYERS of its layers.  Times from two ranks on one card are no
# data-parallel speed-up: the phases record bytes, launches and parity.

SHARD_RANKS = 2
# 8 of smollm-360m's 32 layers at full width (a depth cut, to keep the
# script inside its time: gloo stages every collective through the host;
# 16 until the whole script took 1,101 s on a slower host, PERF.md)
SHARD_LAYERS = 8
# each rank's rows on (2, 1); v's local columns on (1, 2)
SHARD_DP_M = TRAIN_M // SHARD_RANKS
PROJ_TP = {k: (c, r, s_ // SHARD_RANKS) for k, (c, r, s_) in PROJ.items()}
# (a) and (c) against one rank's step on the same batch and params: the
# same kernels on the same rows (DP) or columns (TP), the mean taken over
# the ranks' halves.  The loss (computed before any sync) within
# SHARD_LOSS_RTOL; what the sync and the update make of the step within
# limits set from readings (PERF.md; 32 layers, NVIDIA H100 80GB
# HBM3, 700 W): the grad norm (read 3.7e-5 to 2.1e-4), the momentum after
# the step (sgdm from zero momentum: the synced gradient; read 1.9e-2 to
# 2.1e-2) and the update of the trainable params (read 4.8e-2 to 5.3e-2),
# each leaf's L2 error over its L2 norm, the worst leaf.  DP's and TP's
# gradients are sums of two bf16-rounded halves where one rank rounds the
# whole sum once; the update is then rounded to bf16 params.  The step's
# learning rate is SHARD_CHECK_LR, a power of two large enough that bf16
# params keep the update (the CLI's first warm-up step, 1e-3, moves almost
# no param by a bf16 ulp)
SHARD_CHECK_LR = 64.0
SHARD_LOSS_RTOL = 1e-5
SHARD_NORM_RTOL = 1e-3
SHARD_MU_RTOL = 5e-2
SHARD_UPDATE_RTOL = 1e-1
# (b) against (a): the int8 sync quantizes each rank's gradient to 63 steps
# of the leaf's max (127 // 2, one scale for a whole stacked leaf), which
# loses a quarter of the L2 of the stacked FFN leaves (read: grad norm
# 1.7e-2 to 1.8e-2, momentum and update 2.4e-1 to 3.0e-1); the loss
# precedes the sync and is (a)'s
SHARD_INT8_NORM_RTOL = 5e-2
SHARD_INT8_MU_RTOL = 0.5
SHARD_INT8_UPDATE_RTOL = 0.5
SHARD_TIMEOUT = 600
SHARD_CELLS = (("dp", (SHARD_RANKS, 1), (-1, 0, 1)), ("int8", (SHARD_RANKS, 1), (0, 1)),
               ("tp", (1, SHARD_RANKS), (-1, 0, 1)))


def shard_kernel_shapes():
    """K1-K5 at the sharded path's local shapes: M 1024 (DP and the int8
    sync) and v's local columns (TP)."""
    out = []
    for m, proj in ((SHARD_DP_M, PROJ), (TRAIN_M, PROJ_TP)):
        for c, r, s_ in proj.values():
            out.append(("lowrank_matmul", dict(M=m, C=c, r=r, S=s_)))
        c, r, f = proj["gate/up"]
        out.append(("lowrank_gated_ffn", dict(M=m, C=c, r=r, F=f)))
        for name in BWD:
            for c, r, s_ in proj.values():
                out.append((name, dict(M=m, C=c, r=r, S=s_)))
    return out


def _shard_expected(m, proj, phase):
    """{kernel: {launch key: count}} of one sharded train step on a rank."""
    per = {}
    for leaf, (c, s_) in GEOM.items():
        key = next((m, cc, r, ss) for cc, r, ss in proj.values()
                   if (cc, ss * (SHARD_RANKS if proj is PROJ_TP else 1)) == (c, s_))
        per[key] = per.get(key, 0) + SHARD_LAYERS
    out = {"lowrank_matmul": dict(per), "lowrank_matmul_dx": dict(per)}
    if phase != 0:
        out["lowrank_matmul_du"] = dict(per)
    if phase != 1:
        out["lowrank_matmul_dv"] = dict(per)
    c, r, f = proj["gate/up"]
    out["lowrank_gated_ffn"] = {(m, c, r, r, f): SHARD_LAYERS}
    return out


def _shard_run():
    """Phase 7's run at SHARD_LAYERS layers and learning rate SHARD_CHECK_LR
    from the first step."""
    import dataclasses

    run = _train_run()
    return dataclasses.replace(
        run, model=dataclasses.replace(run.model, num_layers=SHARD_LAYERS),
        optim=dataclasses.replace(run.optim, lr=SHARD_CHECK_LR, warmup_steps=1))


def _rel_l2(got, want, base=None):
    """(worst leaf, its L2 error over its L2 norm) of two {path: tensor}
    maps, each taken as its change from ``base`` where one is given."""
    errs = {}
    for p, w in want.items():
        g, w = got[p].float(), w.float()
        if base is not None:
            g, w = g - base[p].float(), w - base[p].float()
        errs[p] = float(torch.linalg.vector_norm(g - w)
                        / torch.linalg.vector_norm(w).clamp_min(1e-30))
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def shard_worker(out: Path) -> int:
    """One rank of phases 71-73 (``chip_smoke.py --shard-worker DIR``, started
    by ``torch.distributed.run`` from ``phase_sharded``): a step of each
    cell, its loss, grad norm, launches by shape, collectives and times, to
    ``DIR/rank<r>.json``.  Rank 0 also steps the whole batch on one rank and
    holds each cell's momentum and updated params against that step's (the
    int8 cell's against (a)'s).  Any failed check raises, which fails the
    rank."""
    import dataclasses
    import os

    from repro_torch.distributed import collectives
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    _precision_flags()
    collectives.init_process_group("gloo", "env://", rank, world)
    run = _shard_run()
    params, _ = steps.init_params(run, "cuda")
    batch = _train_batch(run, 0)
    runs = {"dp": run, "tp": run, "int8": dataclasses.replace(
        run, dist=dataclasses.replace(run.dist, grad_compression="int8"))}
    res = {}
    base = {}  # rank 0: (cell, phase) -> ({path: momentum}, {path: updated param})
    if rank == 0:
        # the same global batch and params on one rank
        p0 = dict(_leaf_paths(params))
        one = steps.build_train_step(run, "cuda")
        res["one"] = {}
        for phase in (-1, 0, 1):
            st1, _ = steps.make_train_state(run.optim, params, phase)
            st1, m1 = one(st1, batch, phase=phase)
            res["one"][str(phase)] = dict(loss=float(m1["loss"]),
                                          grad_norm=float(m1["grad_norm"]))
            base["one", phase] = (dict(_leaf_paths(st1.opt.mu)),
                                  dict(_leaf_paths(st1.trainable)))
            del st1, m1
    for label, shape, phases in SHARD_CELLS:
        mesh = make_host_mesh(*shape)
        train = steps.build_train_step(runs[label], "cuda", mesh=mesh)
        res[label] = {}
        for phase in phases:
            st, parked = steps.make_sharded_train_state(runs[label], params, phase, mesh)
            steps.check_state_placement(runs[label], mesh, st)
            zero_counts()
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            with collectives.recording() as rec:
                st, m = train(st, batch, phase=phase)
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            e1.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = {name: [[list(k), n] for k, n in by.items()]
                      for name, by in counts_by_shape().items() if by}
            steps.check_state_placement(runs[label], mesh, st)
            whole, _ = steps.gather_state(st, parked, runs[label], mesh)
            cell = dict(loss=loss, grad_norm=gnorm, wall_ms=wall, event_ms=e0.elapsed_time(e1),
                        log=[[c.op, c.dtype, c.bytes, c.path, list(c.axes)] for c in rec],
                        counts=counts,
                        frozen=sorted(p for p, _ in _leaf_paths(st.frozen)),
                        trainable=sorted(p for p, _ in _leaf_paths(st.trainable)))
            if rank == 0:
                mu, upd = dict(_leaf_paths(whole.opt.mu)), dict(_leaf_paths(whole.trainable))
                ref_mu, ref_upd = base["dp" if label == "int8" else "one", phase]
                if set(mu) != set(ref_mu) or set(upd) != set(ref_upd):
                    raise AssertionError(f"sharded {label} phase {phase}: trainable paths "
                                         f"differ from the reference's")
                cell["mu_worst"], cell["mu_err"] = _rel_l2(mu, ref_mu)
                cell["update_worst"], cell["update_err"] = _rel_l2(upd, ref_upd, p0)
                if label == "dp":
                    base["dp", phase] = mu, upd
            res[label][str(phase)] = cell
            del st, m, whole
            torch.cuda.empty_cache()
    zero_counts()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    collectives.destroy_process_group()
    return 0


def _leaf_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{path}/{k}" if path else k)
    elif tree is not None:
        yield path, tree


def _implied_dp_bytes(run, phase):
    """{trainable path: bytes} a (2, 1) step's placements imply: a leaf
    storage-sharded over data is all-gathered once (its block's bytes),
    and every trainable leaf's whole gradient, in its own dtype, is
    all-reduced over data once (a factor's a layer at a time)."""
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.core import freezing
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps

    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((SHARD_RANKS, 1), object))
    tr, _ = freezing.partition(steps.abstract_params(run), phase)
    specs = dict(_leaf_paths(sharding.param_specs(tr, mesh, sharding.PARAM_RULES_NO_FSDP)))
    out = {}
    for path, t in _leaf_paths(tr):
        whole = t.numel() * t.element_size()
        sharded = "data" in specs[path]
        out[path] = (whole // SHARD_RANKS if sharded else 0) + whole
    return out


def _nccl_control_flag():
    """The sharded CLI's control flags (``collectives.any_rank``) under
    NCCL, on a one-rank group (NCCL refuses two ranks on one card, so no
    multi-rank NCCL run is made): a flag where ``control_device("nccl")``
    puts it goes through, a CPU one is refused."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives

    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        collectives.init_process_group("nccl", f"file://{tmp}/store", 0, 1)
        try:
            flag = torch.tensor([1], dtype=torch.int32,
                                device=collectives.control_device("nccl"))
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            torch.cuda.synchronize()
            try:
                dist.all_reduce(torch.tensor([1], dtype=torch.int32), op=dist.ReduceOp.MAX)
                cpu_refused = False
            except RuntimeError:
                cpu_refused = True
        finally:
            collectives.destroy_process_group()
    if flag.device.type != "cuda" or int(flag.item()) != 1 or not cpu_refused:
        raise AssertionError(f"nccl control flag on {flag.device}: {flag.tolist()}, "
                             f"a CPU flag refused: {cpu_refused}")
    log(f"[sharded] nccl (one rank): a control flag on {flag.device} all-reduced; a CPU "
        f"flag refused")


def phase_sharded():
    """Phases 71-73: two gloo ranks on the one card (``shard_worker``),
    started by ``torch.distributed.run``."""
    import os

    t0 = time.perf_counter()
    here = Path(__file__).resolve()
    # the host's cores shared between the ranks (the launcher's default is 1)
    threads = str(max(1, (os.cpu_count() or 1) // SHARD_RANKS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={SHARD_RANKS}", "--tee=3", str(here), "--shard-worker", tmp],
            cwd=str(here.parent), env=dict(os.environ, OMP_NUM_THREADS=threads),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            _, err = proc.communicate(timeout=SHARD_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.terminate()  # the launcher stops its ranks
            _, err = proc.communicate()
            raise AssertionError(f"sharded: ranks still running after {SHARD_TIMEOUT} s:\n"
                                 f"{err[-4000:]}")
        if proc.returncode != 0:
            raise AssertionError(f"sharded: a rank failed (launcher exit {proc.returncode}):\n"
                                 f"{err[-6000:]}")
        outs = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(SHARD_RANKS)]
    run = _shard_run()
    paths = {f"sharded {label}": {} for label, _, _ in SHARD_CELLS}
    result = dict(wall_s=time.perf_counter() - t0, cells={})
    for label, shape, phases in SHARD_CELLS:
        for phase in phases:
            cell = [o[label][str(phase)] for o in outs]
            frozen, trainable = set(cell[0]["frozen"]), set(cell[0]["trainable"])
            for r, c in enumerate(cell):
                by_dtype = {}
                for op, dt, nb, path, axes in c["log"]:
                    by_dtype[f"{op} {dt}"] = by_dtype.get(f"{op} {dt}", 0) + nb
                got = {name: {tuple(k): n for k, n in pairs} for name, pairs in c["counts"].items()}
                log(f"[sharded] {label} mesh {shape} phase {phase} rank {r}: loss "
                    f"{c['loss']:.5f}, grad norm {c['grad_norm']:.4f}, wall {c['wall_ms']:.1f} ms, "
                    f"CUDA-event span {c['event_ms']:.1f} ms (both ranks share the card: no "
                    f"speed-up measured); sync bytes {by_dtype}; launches "
                    + ", ".join(f"{k.replace('lowrank_', '')} {sum(v.values())}"
                                for k, v in got.items()))
                if label == "int8":
                    int8 = {p for op, dt, nb, p, axes in c["log"] if dt == "int8"}
                    if int8 != trainable:
                        raise AssertionError(f"sharded int8 phase {phase}: int8 at {int8 ^ trainable}")
                want = _shard_expected(TRAIN_M if label == "tp" else SHARD_DP_M,
                                       PROJ_TP if label == "tp" else PROJ, phase)
                if got != want:
                    raise AssertionError(f"sharded {label} phase {phase} rank {r}: "
                                         f"launched {got}, want {want}")
                by = paths[f"sharded {label}"]
                for name, keys in got.items():
                    for k, n in keys.items():
                        by.setdefault(name, {})[k] = by.get(name, {}).get(k, 0) + n
                for op, dt, nb, p, axes in c["log"]:
                    if p in frozen and not (label == "tp" and op == "all-gather"
                                            and axes == ["model"]
                                            and p.endswith(("wo/u", "down/u"))):
                        raise AssertionError(f"sharded {label} phase {phase}: {op} {axes} at the "
                                             f"frozen leaf {p}")
                for key in ("loss", "grad_norm"):
                    if c[key] != cell[0][key]:
                        raise AssertionError(f"sharded {label} phase {phase}: ranks' {key} "
                                             f"differ {c[key]} {cell[0][key]}")
            c = cell[0]
            if label == "int8":
                ref, against = outs[0]["dp"][str(phase)], "(a)"
                rtols = dict(loss=SHARD_LOSS_RTOL, grad_norm=SHARD_INT8_NORM_RTOL,
                             mu=SHARD_INT8_MU_RTOL, update=SHARD_INT8_UPDATE_RTOL)
            else:
                ref, against = outs[0]["one"][str(phase)], "one rank"
                rtols = dict(loss=SHARD_LOSS_RTOL, grad_norm=SHARD_NORM_RTOL,
                             mu=SHARD_MU_RTOL, update=SHARD_UPDATE_RTOL)
            diffs = {key: abs(c[key] - ref[key]) / abs(ref[key]) for key in ("loss", "grad_norm")}
            diffs.update(mu=c["mu_err"], update=c["update_err"])
            param = {}
            for op, dt, nb, p, axes in c["log"]:
                if p not in ("activation", "loss", "grad_norm"):
                    param[p] = param.get(p, 0) + nb
            total = sum(e[2] for e in c["log"])
            log(f"[sharded] {label} phase {phase} against {against}: loss {c['loss']:.6f} vs "
                f"{ref['loss']:.6f}, grad norm {c['grad_norm']:.6f} vs {ref['grad_norm']:.6f}; "
                f"relative differences loss {diffs['loss']:.2e}, grad norm "
                f"{diffs['grad_norm']:.2e}, momentum {diffs['mu']:.2e} (worst leaf "
                f"{c['mu_worst']}), update {diffs['update']:.2e} (worst leaf "
                f"{c['update_worst']}); rtols {rtols}; {total} sync bytes a step, "
                f"{sum(param.values())} at param paths")
            for key, rtol in rtols.items():
                if not (math.isfinite(diffs[key]) and diffs[key] <= rtol):
                    raise AssertionError(f"sharded {label} phase {phase}: {key} {diffs[key]:.3e} "
                                         f"from {against}'s, rtol {rtol}")
            if label == "dp" and param != _implied_dp_bytes(run, phase):
                raise AssertionError(f"sharded dp phase {phase}: sync bytes {param} != the "
                                     f"placements' {_implied_dp_bytes(run, phase)}")
            result["cells"][f"{label}/{phase}"] = dict(
                ref=ref, rel_diff=diffs, sync_bytes=total, param_bytes=sum(param.values()),
                ranks=cell)
    dp = {p: result["cells"][f"dp/{p}"]["sync_bytes"] for p in (-1, 0, 1)}
    if not (dp[0] < dp[-1] and dp[1] < dp[-1]):
        raise AssertionError(f"sharded dp: sync bytes {dp}: a frozen phase not below -1")
    log(f"[sharded] dp sync bytes a step by phase {dp}: frozen phases below phase -1")
    _nccl_control_flag()
    log(f"[sharded] {time.perf_counter() - t0:.1f} s with the ranks' start")
    return paths, result


# --------------------------------------------------------------------------
# Phases 74-76: TP-sharded serving on gloo ranks of the one card
# --------------------------------------------------------------------------
#
# The serving path of ``python -m torch.distributed.run ... -m
# repro_torch.launch.serve --mesh-model N``: ServeEngine(mesh=(1, N)), the
# scheduler's pools of each rank's KV heads and K1/K5/K6/K7 on each rank's
# column blocks, on gloo ranks sharing cuda:0 (NCCL refuses two ranks on one
# card).  Two ranks share the card and the host: no speed-up is claimed;
# the phases record launches, collectives, pool bytes, parity and wall time.

# 8 of smollm-360m's 32 layers at full width, and 8 requests of 12 new
# tokens (a cut, to keep the script inside its time: at 32 layers, 16
# requests and 16 new tokens the phases took 335 s, PERF.md, since a gloo
# gather between processes sharing the card costs ~4 ms and a forward
# makes six or seven a layer; 16 layers until the whole script took 1,101 s
# on a slower host)
SSERVE_LAYERS = 8
SSERVE_SLOTS, SSERVE_BLOCK, SSERVE_SPEC_K = 8, 16, 2
# 8 requests sharing a 64-token prefix with 1-32-token suffixes, each padded
# to 96, all arriving at once, so the sharded and the one-rank runs admit
# alike, step for step
SSERVE_PREFIX, SSERVE_SUFFIX, SSERVE_PREFILL, SSERVE_NEW = 64, 32, 96, 12
SSERVE_REQUESTS = 8
# the heterogeneous draft: a different rank in every factor group (gate and
# up share one: K5 takes both branches at one shape here)
SSERVE_DRAFT = {"wq": 120, "wk": 58, "wv": 56, "wo": 114, "gate": 166, "up": 166,
                "down": 162}
# (phase, cell, model axis)
SSERVE_CELLS = ((74, "bf16", 2), (75, "int8", 2), (76, "heads", 5))
# The sharded first decode step's logits against the one-rank step's on
# the same params, relative to max |logit|: K6/K7 give each column the
# unsharded kernel's bits, and at (1, 2) attention runs whole, so the int8
# cell should agree bit for bit; K1/K5's decode plan depends on S, so a
# column block can round t to bf16 otherwise than the whole call (one ulp,
# 2**-8), carried through the layers as phase 5 carries the kernels'
# differences: PATH_RTOL bounds that there
SSERVE_LOGIT_RTOL = PATH_RTOL
SSERVE_TIMEOUT = 600
# paths a serving run's collectives carry besides "activation": the
# scheduling clock, the end-of-serve token check, the engine's tree checks
# and the measured export's decisions
SSERVE_CONTROL = ("serve/clock", "serve/tokens", "serve/check", "serve/export")


def _sserve_run():
    import dataclasses

    run = _full_run(SSERVE_PREFILL + SSERVE_NEW)
    return dataclasses.replace(run, model=dataclasses.replace(run.model,
                                                              num_layers=SSERVE_LAYERS))


def _sserve_trace(vocab: int):
    from repro_torch.launch import serve

    trace = serve.shared_prefix_trace(SSERVE_REQUESTS, 1000.0, SSERVE_PREFIX, SSERVE_SUFFIX,
                                      vocab, seed=0)
    for r in trace:
        r.update(max_new=SSERVE_NEW, arrival=0.0)
    return trace


def _sserve_config(model: int, **kw):
    from repro_torch.serving import ServeConfig

    return ServeConfig(num_slots=SSERVE_SLOTS, max_len=SSERVE_PREFILL + SSERVE_NEW,
                       prefill_len=SSERVE_PREFILL, block_size=SSERVE_BLOCK, mesh_model=model,
                       **kw)


def _factor_shapes(tree):
    """{projection: (kind, C, r, S)} of a served tree: kind ``lowrank``
    (bf16 factors), ``int8_lowrank`` (an int8 pair) or ``int8_dense`` (a
    merged int8 group, r None)."""
    out = {}
    for grp in ("attn", "ffn"):
        for name, g in tree["stack"][grp].items():
            if "u" in g:
                out[name] = ("lowrank", g["u"].shape[-2], g["u"].shape[-1], g["v"].shape[-1])
            elif "u_q" in g:
                out[name] = ("int8_lowrank", g["u_q"].shape[-2], g["u_q"].shape[-1],
                             g["v_q"].shape[-1])
            elif "kernel_q" in g:
                out[name] = ("int8_dense", g["kernel_q"].shape[-2], None,
                             g["kernel_q"].shape[-1])
    return out


_KIND_KERNEL = {"lowrank": "lowrank_matmul", "int8_lowrank": "int8_lowrank_linear",
                "int8_dense": "int8_linear"}


def _sserve_want(shapes, model: int, layers: int, per_m, want=None):
    """PERF.md's prediction of a sharded serve's launches on a rank,
    {kernel: {launch key: count}}: each forward at M (``per_m``: M ->
    forwards), a layer, launches K1 on wq, wk, wv, wo and down and K5 on
    gate/up (bf16 factors), or one int8 launch a projection (K7 a pair, K6
    a merged group), each at its columns / ``model``."""
    want = {} if want is None else want

    def add(name, key, n):
        by = want.setdefault(name, {})
        by[key] = by.get(key, 0) + n

    fused = shapes["gate"][0] == shapes["up"][0] == "lowrank"
    for m, n in per_m.items():
        if not n:
            continue
        for name, (kind, c, r, s_) in shapes.items():
            if fused and name in ("gate", "up"):
                continue
            key = (m, c, s_ // model) if r is None else (m, c, r, s_ // model)
            add(_KIND_KERNEL[kind], key, layers * n)
        if fused:
            _, c, rg, f = shapes["gate"]
            add("lowrank_gated_ffn", (m, c, rg, shapes["up"][2], f // model), layers * n)
    return want


def _sserve_serve(label, engine, trace):
    """Serve ``trace`` on ``engine``, the launch counters zeroed before:
    tokens, per-token logits, the first decode step's logits, launches by
    shape, collectives by path, dispatcher fallbacks, forwards, stats and
    seconds."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import ops

    sched = engine.scheduler
    rec = _record_logits(sched)
    first = {}
    decode = sched._decode

    def keep_first(*a):
        out = decode(*a)
        first.setdefault("logits", out[0][:, -1].float().clone())
        return out

    sched._decode = keep_first
    zero_counts()
    torch.cuda.synchronize()
    with ops.capture_fallbacks() as fb, collectives.recording() as coll:
        t0 = time.perf_counter()
        outs = engine.serve(trace)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    sched._decode = decode
    fwd = dict(sched.forward_stats)
    toks = [o.tokens.tolist() for o in outs]
    if fwd["nonfinite"] or any(len(t) != r["max_new"] for t, r in zip(toks, trace)):
        raise AssertionError(f"sharded serve {label}: {fwd['nonfinite']} non-finite forwards, "
                             f"token counts {[len(t) for t in toks]}")
    paths = {}
    for c in coll:
        n_b = paths.setdefault(c.path, [0, 0])
        n_b[0] += 1
        n_b[1] += c.bytes
    return dict(toks=toks, logits=[rec[o.rid] for o in outs], first=first.get("logits"),
                by_shape={n: dict(v) for n, v in counts_by_shape().items() if v},
                paths=paths, fallbacks=[[f.op, f.reason, list(f.shape)] for f in fb], fwd=fwd,
                stats=sched.latency_stats(), wall_s=dt)


def _sserve_cell(label, model, mesh, params, run, trace, rank, draft=None, **cfg):
    """One sharded serve of a cell on this rank, checked against the
    prediction; on rank 0 also the same trace on one rank with the same
    (exported) params and draft, and the comparison.  Returns the rank's
    record."""
    from repro_torch.serving import ServeEngine

    t0 = time.perf_counter()
    engine = ServeEngine(run, params, device="cuda", mesh=mesh, draft_params=draft,
                         config=_sserve_config(model, **cfg))
    sched = engine.scheduler
    build_s = time.perf_counter() - t0
    got = _sserve_serve(label, engine, trace)
    fwd, k, layers = got["fwd"], SSERVE_SPEC_K, run.model.num_layers
    want = _sserve_want(_factor_shapes(engine.params), model, layers,
                        {SSERVE_PREFILL: fwd["prefill"] + fwd["extend"],
                         SSERVE_SLOTS: fwd["decode"], SSERVE_SLOTS * (k + 1): fwd["verify"]})
    if draft is not None:
        _sserve_want(_factor_shapes(draft), model, layers, {SSERVE_SLOTS: fwd["draft"]}, want)
    if got["by_shape"] != want:
        raise AssertionError(f"sharded serve {label} rank {rank}: launched {got['by_shape']}, "
                             f"want {want}")
    if got["fallbacks"]:
        raise AssertionError(f"sharded serve {label} rank {rank}: plain paths on the card "
                             f"{got['fallbacks'][:4]}")
    bad = set(got["paths"]) - {"activation", *SSERVE_CONTROL}
    if bad:
        raise AssertionError(f"sharded serve {label} rank {rank}: collectives at {sorted(bad)}")
    rec = dict(label=label, model=model, fwd=fwd, wall_s=got["wall_s"], build_s=build_s,
               launched={n: [[list(key), c] for key, c in v.items()]
                         for n, v in got["by_shape"].items()},
               paths=got["paths"], tok_per_s=got["stats"]["tok_per_s"],
               prefix_hits=got["stats"]["prefix_hits"], pool_bytes=sched.cache_bytes(),
               kv_pool_bytes=_pool_bytes(sched.cache), toks=got["toks"],
               export=engine.export_report.summary() if engine.export_report else None)
    if rank == 0:
        t0 = time.perf_counter()
        one = ServeEngine(run, engine.params, device="cuda", draft_params=draft,
                          config=_sserve_config(1, **dict(cfg, export="none",
                                                          export_int8=False)))
        ref = _sserve_serve(f"{label} one rank", one, trace)
        rec["one_wall_s"] = time.perf_counter() - t0
        rec["one_kv_pool_bytes"] = _pool_bytes(one.scheduler.cache)
        rec["compare"] = _compare_greedy(ref["toks"], ref["logits"], got["toks"],
                                         got["logits"], f"sharded serve {label}", rtol=None)
        if got["first"] is not None:
            diff, rel = rel_err(got["first"], ref["first"])
            rec["first_decode"] = dict(max_abs=diff, rel=rel,
                                       bitwise=bool(torch.equal(got["first"], ref["first"])))
            if not rel <= SSERVE_LOGIT_RTOL:
                raise AssertionError(f"sharded serve {label}: the first decode step's logits "
                                     f"lie {rel:.3e} of max |logit| from one rank's")
        del one
    del engine, sched
    torch.cuda.empty_cache()
    return rec


def sserve_worker(out: Path) -> int:
    """One rank of phases 74-76 (``chip_smoke.py --serve-worker DIR``,
    started by ``torch.distributed.run`` from ``phase_sharded_serving``):
    two ranks serve cells 74 and 75, five cell 76; each cell's record to
    ``DIR/rank<r>.json``.  Any failed check raises, which fails the rank
    and, through the launcher, the others."""
    import os

    from repro_torch.distributed import collectives
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import speculative

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    _precision_flags()
    collectives.init_process_group("gloo", "env://", rank, world)
    mesh = make_host_mesh(1, world)
    run = _sserve_run()
    params, _ = steps.init_params(run, "cuda")
    trace = _sserve_trace(run.model.vocab_size)
    res = {}
    if world == 2:
        res["bf16"] = _sserve_cell("bf16", world, mesh, params, run, trace, rank,
                                   prefix_cache=True)
        draft, _ = speculative.make_draft_params(
            params, {f"stack/{'attn' if p.startswith('w') else 'ffn'}/{p}": r
                     for p, r in SSERVE_DRAFT.items()})
        res["spec"] = _sserve_cell("spec", world, mesh, params, run, trace, rank, draft=draft,
                                   speculative_k=SSERVE_SPEC_K)
        del draft
        for kind in EXPORTS:
            res[f"int8 {kind}"] = _sserve_cell(f"int8 {kind}", world, mesh, params, run, trace,
                                               rank, prefix_cache=True, export=kind,
                                               export_int8=True)
    else:
        res["heads"] = _sserve_cell("heads", world, mesh, params, run, trace, rank,
                                    prefix_cache=True)
    zero_counts()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    collectives.destroy_process_group()
    return 0


def _sserve_launch(n: int):
    """``n`` serve workers over gloo, started by ``torch.distributed.run``;
    their records, rank by rank."""
    import os

    here = Path(__file__).resolve()
    threads = str(max(1, (os.cpu_count() or 1) // n))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sserve_") as tmp:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={n}", "--tee=3", str(here), "--serve-worker", tmp],
            cwd=str(here.parent), env=dict(os.environ, OMP_NUM_THREADS=threads),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            _, err = proc.communicate(timeout=SSERVE_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.terminate()  # the launcher stops its ranks
            _, err = proc.communicate()
            raise AssertionError(f"sharded serving: ranks still running after "
                                 f"{SSERVE_TIMEOUT} s:\n{err[-4000:]}")
        if proc.returncode != 0:
            raise AssertionError(f"sharded serving: a rank failed (launcher exit "
                                 f"{proc.returncode}):\n{err[-6000:]}")
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(n)]


def phase_sharded_serving(smi: str):
    """Phases 74-76: two gloo ranks serve cells 74 and 75, then five cell
    76 (``sserve_worker``).  Returns (launches by path, results)."""
    t0 = time.perf_counter()
    outs = {2: _sserve_launch(2)}
    t2 = time.perf_counter() - t0
    outs[5] = _sserve_launch(5)
    paths, result = {}, dict(wall_s=time.perf_counter() - t0, two_ranks_s=t2, smi=smi,
                             layers=SSERVE_LAYERS, cells={})
    for phase, cell, model in SSERVE_CELLS:
        labels = ("bf16", "spec") if cell == "bf16" else (
            tuple(f"int8 {k}" for k in EXPORTS) if cell == "int8" else ("heads",))
        for label in labels:
            recs = [o[label] for o in outs[model]]
            for r, c in enumerate(recs):
                if c["toks"] != recs[0]["toks"]:
                    raise AssertionError(f"sharded serve {label}: rank {r}'s tokens differ")
                paths.setdefault(f"sharded serve {label}", {})
                for name, pairs in c["launched"].items():
                    by = paths[f"sharded serve {label}"].setdefault(name, {})
                    for key, n in pairs:
                        by[tuple(key)] = by.get(tuple(key), 0) + n
                act = c["paths"].get("activation", [0, 0])
                log(f"[sharded serve] {phase} {label} mesh (1, {model}) rank {r}: "
                    f"{c['fwd']['prefill']} prefill + {c['fwd']['extend']} extend + "
                    f"{c['fwd']['decode']} decode + {c['fwd']['draft']} draft + "
                    f"{c['fwd']['verify']} verify forwards; launches "
                    + ", ".join(f"{n} {sum(v for _, v in p)}" for n, p in c["launched"].items())
                    + f" (as predicted); {act[0]} activation gathers, {act[1]} bytes; "
                    f"control {{{', '.join(f'{p}: {v[0]}' for p, v in c['paths'].items() if p != 'activation')}}}; "
                    f"pool {c['kv_pool_bytes']} B k/v + page tables = {c['pool_bytes']} B; "
                    f"wall {c['wall_s']:.2f} s ({c['tok_per_s']:.1f} tok/s; the ranks share "
                    f"the card: no speed-up measured), engine built in {c['build_s']:.1f} s"
                    + (f"; {c['export']}" if c["export"] else ""))
            c0 = recs[0]
            cmp = c0["compare"]
            first = c0.get("first_decode")
            log(f"[sharded serve] {phase} {label} against one rank ({c0['one_wall_s']:.2f} s): "
                f"{_parted_text(cmp)}"
                + (f"; first decode step's logits within {first['max_abs']:.3e} "
                   f"({first['rel']:.2e} of max |logit|, bound {SSERVE_LOGIT_RTOL}"
                   f"{', bit for bit' if first['bitwise'] else ''})" if first else ""))
            if model == 5 and c0["kv_pool_bytes"] * model != c0["one_kv_pool_bytes"]:
                raise AssertionError(f"sharded serve {label}: a rank's pool "
                                     f"{c0['kv_pool_bytes']} B is not a fifth of one "
                                     f"rank's {c0['one_kv_pool_bytes']} B")
            if model == 2 and c0["kv_pool_bytes"] != c0["one_kv_pool_bytes"]:
                raise AssertionError(f"sharded serve {label}: 5 KV heads on 2 ranks must "
                                     f"replicate the pool")
            result["cells"][label] = dict(phase=phase, ranks=recs)
    log(f"[sharded serve] {time.perf_counter() - t0:.1f} s with the ranks' start "
        f"({t2:.1f} s for the two-rank cells)")
    return paths, result


# --------------------------------------------------------------------------
# Phases 77-79: expert parallelism on gloo ranks of the one card
# --------------------------------------------------------------------------
#
# Full-width OLMoE-1B-7B (d 2048, 64 experts of 1024, top-8; LRD at Eq.-5
# ranks 512 / 341) over (data, model) meshes, one process a rank, the ranks
# sharing cuda:0 over gloo (NCCL refuses two ranks on one card): the MoE
# layer's tokens split over model, each rank holding E / model experts,
# pairs exchanged by ``collectives.all_to_all``.  No speed-up is claimed:
# the phases record launches, exchanges, parity and wall time.

EP_RANKS = 4
# depth cuts (the width stays full): one layer for the layer phase, 2 of 16
# layers to train, 4 to serve, to keep the script inside its time
EP_TRAIN_LAYERS, EP_SERVE_LAYERS = 2, 4
# the layer's and the train step's batch: 4 x 256 tokens
EP_B, EP_S = 4, 256
EP_LAYER_MESHES = ((1, 2), (1, 4))
# (label, mesh, phases, microbatches, remat): remat recomputes each layer
# in the backward, on autograd's device thread
EP_TRAIN_CELLS = (("1x2", (1, 2), (-1, 0, 1), 1, "none"),
                  ("2x2", (2, 2), (-1, 0, 1), 1, "none"),
                  ("2x2 mb2", (2, 2), (0,), 2, "none"),
                  ("1x2 remat", (1, 2), (1,), 1, "full"))
# a capacity at which these shapes drop no pair (checked on the routing):
# the layer's at cf 2 (an expert takes at most 2 x its mean load), the
# serve's at cf 8 (a decode step's gshard capacity then holds all 8 slots)
EP_NODROP_CF, EP_SERVE_CF = 2.0, 8.0
# Limits set from readings (PERF.md; NVIDIA H100 80GB HBM3, 700 W), each
# of max |reference|.  EP against the one-process N-rank version
# (``moe.moe_ep_plain``): the same exchange done by indexing and the same
# expert products at the same shapes, so bit for bit but for the router's
# float32 gradient, summed over four ranks in another order at (1, 4)
# (read 1.0e-7).  At the no-drop capacity against one rank's ``ep``: its
# expert buffers have other shapes and its pairs another order within an
# expert's rows, and x's gradient sums the ranks' halves (read 6.0e-7 for
# the router, 8.2e-4 to 3.4e-3 for the rest)
EP_PLAIN_RTOL = 3e-7
EP_ONE_RTOL = 1e-2
# the train step against the one-process version of the same mesh (the
# one-device step with every MoE layer run by ``moe_ep_plain``): the loss
# (read 0 to 5.0e-7), the grad norm (read 9.6e-6 to 1.7e-4, the most with
# 2 microbatches) and rank 0's momentum after the step (sgdm from zero
# momentum: the synced gradient), each leaf's L2 error over its L2 norm,
# the worst leaf of the router, of the expert factors and of the rest
# (K1-K4 on column blocks, the gradients summed over two halves in bf16;
# read 6.1e-3 / 7.3e-3 / 9.2e-3 with one microbatch).  With 2 microbatches
# a rank's K1-K4 run at M 256, in K1's decode design, while the
# one-process version's run at M 512 in the large-M design: the bf16
# activations part further and the momentum reads 7.6e-2 to 9.0e-2 (the
# loss still 5.0e-7 off), so that cell takes EP_MU_MB_RTOL.  A router
# gradient not summed over ``model``, or an expert's summed over it, is
# off by 0.5 to 1 of its norm
EP_LOSS_RTOL, EP_NORM_RTOL = 1.5e-6, 5e-4
EP_MU_RTOL = {"router": 1.5e-2, "experts": 1.5e-2, "rest": 2e-2}
EP_MU_MB_RTOL = 0.2
# serving against one rank at the no-drop capacity, of max |real logit|
# (read 4.7e-3 at the first decode step, 6.8e-3 over the trace)
EP_SERVE_LOGIT_RTOL = 2e-2
EP_TIMEOUT = 900
EP_PATHS = ("moe/dispatch", "moe/dispatch_ids", "moe/combine")


def _ep_run(layers: int, cf: float = None, serve: bool = False):
    """Full-width OLMoE-1B-7B at ``layers`` layers (the train CLI's run:
    LRD at Eq.-5 ranks, kernels on, sequential freezing, sgdm at a learning
    rate that moves bf16 params), or the serve CLI's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    if serve:
        run = serve.serve_run(get_config(MOE_ARCH), max_len=SSERVE_PREFILL + SSERVE_NEW,
                              slots=SSERVE_SLOTS, lrd=True, device=torch.device("cuda"), seed=0)
    else:
        run = _moe_run()
        run = dataclasses.replace(run, optim=dataclasses.replace(
            run.optim, name="sgdm", lr=SHARD_CHECK_LR, warmup_steps=1))
    model = dataclasses.replace(run.model, num_layers=layers)
    if cf is not None:
        model = dataclasses.replace(model, capacity_factor=cf)
    return dataclasses.replace(run, model=model)


def _ep_batch(run):
    g = torch.Generator(device="cpu").manual_seed(5)
    v = run.model.vocab_size
    return {"tokens": torch.randint(0, v, (EP_B, EP_S), generator=g, dtype=torch.int32),
            "labels": torch.randint(0, v, (EP_B, EP_S), generator=g, dtype=torch.int32)}


def _ep_grads(lp, x):
    out = {"x": x.grad, "router": lp["router"]["kernel"].grad}
    for grp, leaves in lp["experts"].items():
        for k, t in leaves.items():
            out[f"{grp}/{k}"] = t.grad
    return out


def _ep_leaf(lp):
    """A layer's params as fresh leaves that require grad."""
    return {"router": {"kernel": lp["router"]["kernel"].detach().clone().requires_grad_(True)},
            "experts": {g: {k: t.detach().clone().requires_grad_(True) for k, t in v.items()}
                        for g, v in lp["experts"].items()}}


def _ep_drops(lp, x, cfg, ep: int):
    """(pairs dropped at stage 1, at stage 2) of the ``ep`` rule over ``ep``
    ranks on x (B, S, d), counted from the routing."""
    from repro_torch.models import moe

    b, s, d = x.shape
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    logits = (x.reshape(-1, d).float() @ lp["router"]["kernel"].float()).reshape(b, s, e)
    ids = torch.topk(torch.softmax(logits, -1), k, dim=-1).indices
    t = b * (s // ep)
    cap1, cap2 = moe.ep_send_capacity(t, cfg, ep), moe.ep_capacity(t, cfg, ep)
    d1 = d2 = 0
    per_expert = torch.zeros(e, dtype=torch.long, device=x.device)
    for m in range(ep):
        mine = ids[:, m * (s // ep):(m + 1) * (s // ep)].reshape(-1)
        d1 += int(torch.clamp(torch.bincount(mine // (e // ep), minlength=ep) - cap1,
                              min=0).sum())
        per_expert += torch.bincount(mine, minlength=e)
    d2 = int(torch.clamp(per_expert - cap2, min=0).sum())
    return d1, d2


def _ep_layer(mesh, shape, lp0, x, ct, cfg, rank):
    """Phase 77 on one mesh and capacity: the EP layer forward and backward
    on this rank, against ``moe_ep_plain`` (every rank holds it whole) and,
    at the no-drop capacity, one rank's ``ep``; the exchange bytes against
    the capacities' arithmetic."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.models import moe

    ep, e = shape[1], cfg.num_experts
    mi = collectives.coordinate(mesh, ("model",))
    blk = slice(mi * (e // ep), (mi + 1) * (e // ep))
    lp = _ep_leaf(lp0)
    xl = x.detach().clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with axis_rules(mesh, rows=()), collectives.recording() as log:
        y, aux = moe.moe_apply(lp, xl, cfg)
        (torch.sum(y.float() * ct) + aux).backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _ep_grads(lp, xl)
    lw = _ep_leaf(lp0)
    xw = x.detach().clone().requires_grad_(True)
    yw, auxw = moe.moe_ep_plain(lw, xw, cfg, 1, ep)
    (torch.sum(yw.float() * ct) + auxw).backward()
    want = _ep_grads(lw, xw)
    errs = {"y": rel_err(y, yw)[1], "aux": abs(float(aux) - float(auxw))}
    bitwise = {"y": bool(torch.equal(y, yw))}
    for k, g in got.items():
        w = want[k]
        if k not in ("x", "router"):
            g, w = g[blk], w[blk]
        errs[k] = rel_err(g, w)[1]
        bitwise[k] = bool(torch.equal(g, w))
    t = x.shape[0] * (x.shape[1] // ep)
    per = moe.ep_exchange_bytes(t, cfg.d_model, cfg, ep, x.element_size())
    a2a = {k.split(" ", 1)[1]: nb for k, nb in collectives.by_op_path(log).items()
           if k.startswith("all-to-all ")}
    want_a2a = {p: nb * (1 if p.endswith("ids") else 2) for p, nb in per.items()}
    if a2a != want_a2a:
        raise AssertionError(f"ep layer {shape}: all_to_all bytes {a2a}, want {want_a2a}")
    bad = {k: v for k, v in errs.items() if not v <= EP_PLAIN_RTOL}
    if bad:
        raise AssertionError(f"ep layer {shape} cf {cfg.capacity_factor}: against the "
                             f"one-process version {bad} (bound {EP_PLAIN_RTOL})")
    rec = dict(shape=list(shape), cf=cfg.capacity_factor, errs=errs, bitwise=bitwise,
               a2a=a2a, wall_s=wall, drops=_ep_drops(lp0, x, cfg, ep),
               caps=[moe.ep_send_capacity(t, cfg, ep), moe.ep_capacity(t, cfg, ep)],
               collectives=sorted({(c.op, c.path) for c in log}))
    if cfg.capacity_factor == EP_NODROP_CF:
        if rec["drops"] != (0, 0) or _ep_drops(lp0, x, cfg, 1) != (0, 0):
            raise AssertionError(f"ep layer {shape}: pairs dropped at cf {EP_NODROP_CF}: "
                                 f"{rec['drops']}")
        lo = _ep_leaf(lp0)
        xo = x.detach().clone().requires_grad_(True)
        yo, auxo = moe.moe_apply(lo, xo, cfg)  # no mesh: one rank's ep
        (torch.sum(yo.float() * ct) + auxo).backward()
        one = _ep_grads(lo, xo)
        rec["one"] = {"y": rel_err(y, yo)[1]}
        for k, g in got.items():
            w = one[k]
            if k not in ("x", "router"):
                g, w = g[blk], w[blk]
            rec["one"][k] = rel_err(g, w)[1]
        bad = {k: v for k, v in rec["one"].items() if not v <= EP_ONE_RTOL}
        if bad:
            raise AssertionError(f"ep layer {shape}: against one rank's ep at no drop {bad} "
                                 f"(bound {EP_ONE_RTOL})")
    return rec


@contextlib.contextmanager
def _moe_plain_mesh(data: int, model: int):
    """Run every MoE layer of a one-device step as ``moe_ep_plain`` over a
    (data, model) mesh: the one-process version of the sharded step."""
    from repro_torch.models import lm, moe

    real = lm.moe_apply
    lm.moe_apply = lambda p, x, cfg, policy=False: moe.moe_ep_plain(p, x, cfg, data, model)
    try:
        yield
    finally:
        lm.moe_apply = real


def _ep_train_want(m: int, model: int, layers: int, phase: int, n: int = 1,
                   remat: str = "none"):
    """K1-K4 launches of a sharded OLMoE step on a rank: q, k, v and o of
    each layer at (M, 2048, 512, 2048 / model), K3 unless u is frozen, K4
    unless v is; ``n`` microbatches; K1 again in each layer's recompute
    under remat."""
    key = (m, MOE_ATTN["C"], MOE_ATTN["r"], MOE_ATTN["S"] // model)
    fwd = 2 if remat != "none" else 1
    want = {"lowrank_matmul": {key: 4 * layers * n * fwd},
            "lowrank_matmul_dx": {key: 4 * layers * n}}
    if phase != 0:
        want["lowrank_matmul_du"] = {key: 4 * layers * n}
    if phase != 1:
        want["lowrank_matmul_dv"] = {key: 4 * layers * n}
    return want


def _ep_mu_errs(run, mesh, st, mu1):
    """Rank 0's momentum after a sharded step against the one-process
    version's, leaf by leaf on this rank's blocks (each leaf's L2 error over
    its L2 norm): {group: [worst leaf, its error]} for the router, the
    expert factors and the rest."""
    from repro_torch.launch import steps

    shs = dict(_leaf_paths(steps.state_shardings(run, mesh, st).opt.mu))
    got, want = dict(_leaf_paths(st.opt.mu)), dict(_leaf_paths(mu1))
    if set(got) != set(want):
        raise AssertionError("ep train: the momentum's paths differ from the one-process "
                             "version's")
    out = {}
    for path, w in want.items():
        group = ("router" if "/router/" in path else
                 "experts" if "/experts/" in path else "rest")
        _, err = _rel_l2({path: got[path]}, {path: shs[path].block(w)})
        if err >= out.get(group, ["", -1.0])[1]:
            out[group] = [path, err]
    return out


def _ep_train(meshes, rank):
    """Phase 78 on this rank: each cell's steps, launches, collectives and
    times; rank 0 also the one-process version of each mesh, and its
    momentum against it leaf by leaf."""
    import dataclasses

    from repro_torch.distributed import collectives
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    run = _ep_run(EP_TRAIN_LAYERS)
    params, _ = steps.init_params(run, "cuda")
    batch = _ep_batch(run)
    out = {}
    for label, shape, phases, mb, remat in EP_TRAIN_CELLS:
        mesh = meshes[shape]
        if mesh.get_coordinate() is None:
            continue
        run_c = dataclasses.replace(run, dist=dataclasses.replace(run.dist, microbatches=mb,
                                                                  remat=remat))
        train = steps.build_train_step(run_c, "cuda", mesh=mesh)
        cell = {}
        for phase in phases:
            st, parked = steps.make_sharded_train_state(run_c, params, phase, mesh)
            steps.check_state_placement(run_c, mesh, st)
            zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with collectives.recording() as rec, ops.capture_fallbacks() as fb:
                st, m = train(st, batch, phase=phase)
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            counts = {name: {k: n for k, n in by.items()}
                      for name, by in counts_by_shape().items() if by}
            steps.check_state_placement(run_c, mesh, st)
            m_tok = EP_B * EP_S // shape[0] // mb
            want = _ep_train_want(m_tok, shape[1], EP_TRAIN_LAYERS, phase, mb, remat)
            if counts != want:
                raise AssertionError(f"ep train {label} phase {phase} rank {rank}: launched "
                                     f"{counts}, want {want}")
            if fb:
                raise AssertionError(f"ep train {label}: kernel_fallbacks "
                                     f"{[(f.op, f.reason) for f in fb][:4]}")
            frozen = {p for p, _ in _leaf_paths(st.frozen)}
            for c in rec:
                if c.path in frozen and set(c.axes) & {"data", "pod"}:
                    raise AssertionError(f"ep train {label} phase {phase}: {c.op} {c.axes} "
                                         f"at the frozen leaf {c.path}")
            experts = {}  # an expert leaf's gradient syncs (its storage gathers apart)
            for c in rec:
                if "/experts/" in c.path and c.op in ("all-reduce", "reduce-scatter"):
                    experts.setdefault(c.path, set()).add(f"{c.op} {'/'.join(c.axes)}")
            by_path = collectives.by_op_path(rec)
            rmu = st.opt.mu["moe_stack"]["moe"]["router"]["kernel"]
            cell[str(phase)] = dict(
                loss=loss, grad_norm=gnorm, wall_s=wall,
                launched={n: [[list(k), v] for k, v in by.items()] for n, by in counts.items()},
                expert_sync={p: sorted(v) for p, v in experts.items()}, by_path=by_path,
                router_digest=steps.tree_digest({"r": rmu}),
                mem_gib=peak)
            if rank == 0:
                st1, _ = steps.make_train_state(run_c.optim, params, phase)
                with _moe_plain_mesh(*shape):
                    st1, m1 = steps.build_train_step(run_c, "cuda")(st1, batch, phase=phase)
                cell[str(phase)]["one"] = dict(loss=float(m1["loss"]),
                                               grad_norm=float(m1["grad_norm"]),
                                               mu=_ep_mu_errs(run_c, mesh, st, st1.opt.mu))
                del st1, m1
            del st, m, parked
            torch.cuda.empty_cache()
        out[label] = cell
    zero_counts()
    return out


def _ep_serve(mesh, rank):
    """Phase 79 on this rank: OLMoE at EP_SERVE_LAYERS layers and the
    no-drop capacity served over (1, 2) with the prefix cache; rank 0 also
    on one rank with the same params."""
    from repro_torch.launch import steps
    from repro_torch.serving import ServeEngine

    run = _ep_run(EP_SERVE_LAYERS, cf=EP_SERVE_CF, serve=True)
    params, _ = steps.init_params(run, "cuda")
    trace = _sserve_trace(run.model.vocab_size)
    t0 = time.perf_counter()
    engine = ServeEngine(run, params, device="cuda", mesh=mesh,
                         config=_sserve_config(2, prefix_cache=True))
    build_s = time.perf_counter() - t0
    got = _sserve_serve("ep", engine, trace)
    fwd = got["fwd"]
    key = lambda m: (m, MOE_ATTN["C"], MOE_ATTN["r"], MOE_ATTN["S"] // 2)  # noqa: E731
    n_pre = fwd["prefill"] + fwd["extend"]
    want = {"lowrank_matmul": {key(SSERVE_PREFILL): 4 * EP_SERVE_LAYERS * n_pre,
                               key(SSERVE_SLOTS): 4 * EP_SERVE_LAYERS * fwd["decode"]}}
    want["lowrank_matmul"] = {k: v for k, v in want["lowrank_matmul"].items() if v}
    if got["by_shape"] != want:
        raise AssertionError(f"ep serve rank {rank}: launched {got['by_shape']}, want {want}")
    if got["fallbacks"]:
        raise AssertionError(f"ep serve rank {rank}: kernel_fallbacks {got['fallbacks'][:4]}")
    allowed = {"activation", "moe/aux", "moe/expert_out", *EP_PATHS, *SSERVE_CONTROL}
    if set(got["paths"]) - allowed:
        raise AssertionError(f"ep serve rank {rank}: collectives at "
                             f"{sorted(set(got['paths']) - allowed)}")
    sched = engine.scheduler
    local = sched.params["moe_stack"]["moe"]["experts"]["gate"]["u"].shape
    rec = dict(fwd=fwd, wall_s=got["wall_s"], build_s=build_s, toks=got["toks"],
               launched={n: [[list(k), c] for k, c in v.items()]
                         for n, v in got["by_shape"].items()},
               paths=got["paths"], kv_pool_bytes=_pool_bytes(sched.cache),
               local_experts=list(local), tok_per_s=got["stats"]["tok_per_s"],
               prefix_hits=got["stats"]["prefix_hits"])
    if rank == 0:
        t0 = time.perf_counter()
        one = ServeEngine(run, params, device="cuda", config=_sserve_config(1, prefix_cache=True))
        ref = _sserve_serve("ep one rank", one, trace)
        rec["one_wall_s"] = time.perf_counter() - t0
        rec["one_kv_pool_bytes"] = _pool_bytes(one.scheduler.cache)
        # OLMoE's padded vocab tail holds -1e30: the bounds read the real
        # logits
        real = (ref["first"] > -1e29).all(0)
        strip = lambda rows: [[t[real] for t in r] for r in rows]  # noqa: E731
        rec["compare"] = _compare_greedy(ref["toks"], strip(ref["logits"]), got["toks"],
                                         strip(got["logits"]), "ep serve",
                                         rtol=EP_SERVE_LOGIT_RTOL)
        diff, rel = rel_err(got["first"][:, real], ref["first"][:, real])
        rec["first_decode"] = dict(max_abs=diff, rel=rel,
                                   bitwise=bool(torch.equal(got["first"], ref["first"])))
        if not rel <= EP_SERVE_LOGIT_RTOL:
            raise AssertionError(f"ep serve: the first decode step's logits lie {rel:.3e} of "
                                 f"max |logit| from one rank's")
        del one
    del engine, sched
    torch.cuda.empty_cache()
    return rec


def ep_worker(out: Path) -> int:
    """One rank of phases 77-79 (``chip_smoke.py --ep-worker DIR``, started
    by ``torch.distributed.run`` from ``phase_ep``): the EP layer, the
    sharded train step and the serve, each record to ``DIR/rank<r>.json``.
    Any failed check raises, which fails the rank and, through the
    launcher, the others."""
    import dataclasses
    import os

    from repro_torch.distributed import collectives
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    _precision_flags()
    collectives.init_process_group("gloo", "env://", rank, world)
    meshes = {s: make_host_mesh(*s) for s in ((1, 2), (2, 2), (1, 4))}
    res = {"layer": [], "rank": rank}
    t0 = time.perf_counter()
    run = _ep_run(1)
    params, _ = steps.init_params(run, "cuda")
    lp0 = {k: {g: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
               for g, v in grp.items()}
           for k, grp in params["moe_stack"]["moe"].items()}
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(EP_B, EP_S, run.model.d_model, generator=g, device="cuda").to(torch.bfloat16)
    ct = torch.randn(EP_B, EP_S, run.model.d_model, generator=g, device="cuda")
    for shape in EP_LAYER_MESHES:
        mesh = meshes[shape]
        if mesh.get_coordinate() is None:
            continue
        for cf in (run.model.capacity_factor, EP_NODROP_CF):
            cfg = dataclasses.replace(run.model, capacity_factor=cf)
            res["layer"].append(_ep_layer(mesh, shape, lp0, x, ct, cfg, rank))
    del params, lp0
    torch.cuda.empty_cache()
    res["layer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["train"] = _ep_train(meshes, rank)
    res["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if meshes[(1, 2)].get_coordinate() is not None:
        res["serve"] = _ep_serve(meshes[(1, 2)], rank)
    res["serve_s"] = time.perf_counter() - t0
    collectives.any_rank(False, meshes[(2, 2)])  # every rank past the serve
    zero_counts()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    collectives.destroy_process_group()
    return 0


def phase_ep(smi: str):
    """Phases 77-79: four gloo ranks on the card (``ep_worker``).  Returns
    (launches by path, results)."""
    import os

    t0 = time.perf_counter()
    here = Path(__file__).resolve()
    threads = str(max(1, (os.cpu_count() or 1) // EP_RANKS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep_") as tmp:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={EP_RANKS}", "--tee=3", str(here), "--ep-worker", tmp],
            cwd=str(here.parent), env=dict(os.environ, OMP_NUM_THREADS=threads),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            _, err = proc.communicate(timeout=EP_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.terminate()  # the launcher stops its ranks
            _, err = proc.communicate()
            raise AssertionError(f"ep: ranks still running after {EP_TIMEOUT} s:\n{err[-4000:]}")
        if proc.returncode != 0:
            raise AssertionError(f"ep: a rank failed (launcher exit {proc.returncode}):\n"
                                 f"{err[-6000:]}")
        outs = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(EP_RANKS)]
    paths = {}
    result = dict(wall_s=time.perf_counter() - t0, smi=smi, ranks=outs,
                  layers=dict(train=EP_TRAIN_LAYERS, serve=EP_SERVE_LAYERS))
    # 77: the layer
    for o in outs:
        for r in o["layer"]:
            log(f"[ep layer] mesh {tuple(r['shape'])} cf {r['cf']} rank {o['rank']}: caps "
                f"{r['caps']}, drops (stage 1, 2) {tuple(r['drops'])}; against the "
                f"one-process version: " + ", ".join(
                    f"{k} {v:.2e}{' (bits)' if r['bitwise'].get(k) else ''}"
                    for k, v in r["errs"].items())
                + (f"; against one rank's ep at no drop: "
                   + ", ".join(f"{k} {v:.2e}" for k, v in r["one"].items()) if "one" in r else "")
                + f"; all_to_all bytes {r['a2a']} (the capacities' arithmetic); wall "
                  f"{r['wall_s'] * 1e3:.1f} ms fwd+bwd (ranks share the card)")
    # 78: the train step
    for label, shape, phases, mb, remat in EP_TRAIN_CELLS:
        ranks = [o for o in outs if label in o["train"]]
        for phase in phases:
            cells = [o["train"][label][str(phase)] for o in ranks]
            for o, c in zip(ranks, cells):
                for key in ("loss", "grad_norm", "router_digest"):
                    if c[key] != cells[0][key]:
                        raise AssertionError(f"ep train {label} phase {phase}: rank "
                                             f"{o['rank']}'s {key} differs")
                by = paths.setdefault(f"ep train {label}", {})
                for name, pairs in c["launched"].items():
                    for k, n in pairs:
                        by.setdefault(name, {})[tuple(k)] = by.get(name, {}).get(tuple(k), 0) + n
            c = cells[0]
            one = c["one"]
            d_loss = abs(c["loss"] - one["loss"]) / abs(one["loss"])
            d_norm = abs(c["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
            a2a = {k: v for k, v in c["by_path"].items() if k.startswith("all-to-all")}
            sync = sorted({s for v in c["expert_sync"].values() for s in v})
            mu = one["mu"]
            lim = EP_MU_RTOL if mb == 1 else dict.fromkeys(EP_MU_RTOL, EP_MU_MB_RTOL)
            log(f"[ep train] {label} mesh {shape} phase {phase} x{mb} microbatch(es), remat "
                f"{remat}: loss "
                f"{c['loss']:.6f} vs {one['loss']:.6f} one-process ({d_loss:.2e}, bound "
                f"{EP_LOSS_RTOL}), grad norm {c['grad_norm']:.5f} vs {one['grad_norm']:.5f} "
                f"({d_norm:.2e}, bound {EP_NORM_RTOL}); rank 0's momentum, worst leaf: "
                + ", ".join(f"{g} {mu[g][1]:.2e} at {mu[g][0]} (bound {lim[g]})"
                            for g in sorted(mu))
                + "; launches "
                + ", ".join(f"{k.replace('lowrank_', '')} {sum(n for _, n in v)}"
                            for k, v in c["launched"].items())
                + f" (as predicted, each rank); expert grads synced by {sync}; all_to_all "
                  f"bytes {a2a}; {sum(c['by_path'].values())} collective bytes; wall "
                  + ", ".join(f"{x['wall_s']:.2f}" for x in cells)
                + f" s; peak {max(x['mem_gib'] for x in cells):.2f} GiB a rank")
            bad_mu = {g: v for g, v in mu.items() if not v[1] <= lim[g]}
            if not (d_loss <= EP_LOSS_RTOL and d_norm <= EP_NORM_RTOL) or bad_mu:
                raise AssertionError(f"ep train {label} phase {phase}: loss {d_loss:.3e} / "
                                     f"grad norm {d_norm:.3e} / momentum {bad_mu} from the "
                                     f"one-process version")
            if set(mu) != {"router", "experts", "rest"}:
                raise AssertionError(f"ep train {label} phase {phase}: momentum of {sorted(mu)}")
            if any(s.split(" ", 1)[1] not in ("data", "") for s in sync):
                raise AssertionError(f"ep train {label}: expert grads synced by {sync}")
    # 79: the serve
    served = [o for o in outs if "serve" in o]
    for o in served:
        s = o["serve"]
        if s["toks"] != served[0]["serve"]["toks"]:
            raise AssertionError(f"ep serve: rank {o['rank']}'s tokens differ")
        by = paths.setdefault("ep serve", {})
        for name, pairs in s["launched"].items():
            for k, n in pairs:
                by.setdefault(name, {})[tuple(k)] = by.get(name, {}).get(tuple(k), 0) + n
        log(f"[ep serve] mesh (1, 2) rank {o['rank']}: {s['fwd']['prefill']} prefill + "
            f"{s['fwd']['extend']} extend + {s['fwd']['decode']} decode forwards; launches "
            + ", ".join(f"{n} {sum(v for _, v in p)}" for n, p in s["launched"].items())
            + f" (as predicted); experts a rank {s['local_experts']}; collectives "
              f"{{{', '.join(f'{p}: {v[0]} / {v[1]} B' for p, v in s['paths'].items())}}}; "
              f"pool {s['kv_pool_bytes']} B; wall {s['wall_s']:.2f} s, engine built in "
              f"{s['build_s']:.1f} s")
    s0 = served[0]["serve"]
    if s0["kv_pool_bytes"] * 2 != s0["one_kv_pool_bytes"]:
        raise AssertionError(f"ep serve: a rank's pool {s0['kv_pool_bytes']} B is not half of "
                             f"one rank's {s0['one_kv_pool_bytes']} B")
    if "moe/expert_out" not in s0["paths"] or "moe/dispatch" not in s0["paths"]:
        raise AssertionError(f"ep serve: no expert-output gather or no exchange: "
                             f"{sorted(s0['paths'])}")
    first = s0["first_decode"]
    log(f"[ep serve] against one rank ({s0['one_wall_s']:.2f} s) at cf {EP_SERVE_CF}: "
        f"{_parted_text(s0['compare'])} (of max |real logit|, bound {EP_SERVE_LOGIT_RTOL}); "
        f"first decode step's logits within "
        f"{first['max_abs']:.3e} ({first['rel']:.2e} of max |real logit|, bound "
        f"{EP_SERVE_LOGIT_RTOL}{', bit for bit' if first['bitwise'] else ''})")
    log(f"[ep] {result['wall_s']:.1f} s with the ranks' start (rank 0: layer "
        f"{outs[0]['layer_s']:.1f} s, train {outs[0]['train_s']:.1f} s, serve "
        f"{outs[0]['serve_s']:.1f} s; {EP_TRAIN_LAYERS} / {EP_SERVE_LAYERS} of "
        f"{MOE_LAYERS} layers)")
    return paths, result


def ep_kernel_rows(rows, paths):
    """K1-K4 rows at every shape the EP phases launched that no row checked
    yet."""
    checked = {(r["name"], shape_key(r["name"], r["shape"])) for r in rows}
    new = {(name, key) for by in paths.values() for name, keys in by.items() for key in keys}
    return phase_kernels([(n, shape_dims(n, k)) for n, k in sorted(new - checked)])


def sserve_kernel_rows(rows, paths):
    """K1 / K5 rows, and K6 / K7 rows with their int8-operand twins, at every
    shape the sharded serving paths launched that no row checked yet."""
    checked = {(r["name"], shape_key(r["name"], r["shape"])) for r in rows}
    new = {(name, key) for by in paths.values() for name, keys in by.items() for key in keys}
    new -= checked
    lowrank = sorted((n, k) for n, k in new if n in LOWRANK_FWD)
    int8 = sorted((n, k) for n, k in new if n in INT8_FUSED)
    return (phase_kernels([(n, shape_dims(n, k)) for n, k in lowrank])
            + phase_int8_kernels(int8))


def check_launched_shapes(path: str, rows, by_shape) -> None:
    """Fail if ``path`` launched a kernel at a shape the kernel phase did
    not check."""
    for name, counts in by_shape.items():
        unchecked = set(counts) - {shape_key(r["name"], r["shape"])
                                   for r in rows if r["name"] == name}
        if unchecked:
            raise AssertionError(f"{path}: {name} launched at shapes the kernel phase "
                                 f"did not check: {sorted(unchecked)}")


def count_launches(rows, paths) -> None:
    """Each row's launches on the main paths; fail on a shape a path
    launched that no row checked, or a row no path launched."""
    for path, by in paths.items():
        check_launched_shapes(path, rows, by)
    for row in rows:
        key = shape_key(row["name"], row["shape"])
        row["launches"] = sum(by.get(row["name"], {}).get(key, 0) for by in paths.values())
        # the int8-operand entries are the TPU kernels' contract, which
        # no main path calls since the serving entries quantize x inside;
        # the rank-gate rows are on no main path by design
        if (not row["launches"] and row["name"] not in INT8_FUSED.values()
                and row["name"] != "int8_linear" and row.get("on_main_path", True)):
            raise AssertionError(f"{row['name']} {row['shape']} never launched on "
                                 f"a main path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write every result as JSON here")
    ap.add_argument("--only", choices=("kernels", "conv", "serve", "obs", "moe", "ssm",
                                       "encdec", "vlm", "mla", "tune", "shard", "sserve", "ep"),
                    default=None,
                    help="kernels: stop after the kernel phase (a first check of a build); "
                         "conv: run only the conv and ViT phases; serve: phases 1-3 at the "
                         "serving shapes and the serving features' phases 25-28 (phase 4's "
                         "serve with telemetry and its phase-68 checks run in the full run "
                         "and under obs); obs: phases 1, 2, 4 and 7 with their CLIs' "
                         "telemetry on and phase 68, which reads their traces; moe: "
                         "phases 1-3 at the MoE shapes and the MoE phases 29-35; ssm: "
                         "phases 1-3 at the SSM and hybrid shapes, phases 36-43 and their "
                         "int8 export's 64-65; encdec: phases 1-3 at the enc-dec shapes, "
                         "phases 44-49 and 66; vlm: phases 1-3 at the VLM shapes, phases "
                         "50-56, 67 and the rank-gate and K7-ceiling rows; mla: "
                         "phases 1-3 at DeepSeek-V3's shapes and phases 57-63; tune: "
                         "phases 1, 2, 69 (autotune) and 70 (dry-run and roofline); shard: "
                         "phases 1-3 at the sharded path's shapes and 71-73; sserve: phases "
                         "1, 2, 74-76 and the kernel rows at their shapes; ep: phases 1, 2, "
                         "77-79 (expert parallelism) and the kernel rows at their shapes")
    ap.add_argument("--shard-worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--serve-worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--ep-worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.shard_worker:
        return shard_worker(Path(args.shard_worker))
    if args.serve_worker:
        return sserve_worker(Path(args.serve_worker))
    if args.ep_worker:
        return ep_worker(Path(args.ep_worker))

    t_start = time.perf_counter()

    def mark(what: str) -> None:
        log(f"[run] {time.perf_counter() - t_start:.1f} s after {what}")

    smi = phase_device()
    # phases 4 and 7 write their telemetry here, phase 68 reads it
    obs_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_obs_")
    obs_root = Path(obs_tmp.name)
    if args.only == "conv":
        result = dict(smi=smi, **phase_conv())
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1, default=str))
        log(f"[run] {time.perf_counter() - t_start:.1f} s")
        print(smi, flush=True)
        return 0
    build_s = phase_build()
    if args.only == "obs":
        result = dict(smi=smi, build_s=build_s)
        engine, _, result["serve"] = phase_serve(obs_root / "serve")
        del engine
        _, _, result["train"] = phase_train(obs_root / "train")
        result["telemetry"] = phase_telemetry(result["serve"], result["train"], smi)
        mark("telemetry")
        obs_tmp.cleanup()
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1, default=str))
        print(json.dumps({"kernels": []}), flush=True)
        print(smi, flush=True)
        return 0
    if args.only == "tune":
        result = dict(smi=smi, build_s=build_s)
        _, result["autotune"] = phase_autotune()
        _, result["dryrun"] = phase_dryrun()
        mark("autotune and dry-run")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1, default=str))
        print(json.dumps({"kernels": []}), flush=True)
        print(smi, flush=True)
        return 0
    if args.only == "moe":
        shapes = moe_kernel_shapes()
    elif args.only == "serve":
        shapes = kernel_shapes(serve_only=True)
    elif args.only == "ssm":
        shapes = ssm_kernel_shapes()
    elif args.only == "encdec":
        shapes = encdec_kernel_shapes()
    elif args.only == "vlm":
        shapes = vlm_kernel_shapes()
    elif args.only == "mla":
        shapes = mla_kernel_shapes()
    elif args.only == "shard":
        shapes = shard_kernel_shapes()
    elif args.only in ("sserve", "ep"):
        shapes = []  # the rows follow the phases, at the shapes they launched
    else:
        shapes = (kernel_shapes() + moe_kernel_shapes() + ssm_kernel_shapes()
                  + encdec_kernel_shapes() + vlm_kernel_shapes() + mla_kernel_shapes())
    # a shape two families share is checked once (xLSTM's attention and the
    # enc-dec serve path's are both (1024, 256, 1024))
    shapes = [sd for i, sd in enumerate(shapes) if sd not in shapes[:i]]
    rows = phase_kernels(shapes)
    mark("kernels")
    result = dict(smi=smi, build_s=build_s, kernels=rows)
    paths = {}  # main path -> launches by kernel and shape
    if args.only == "serve":
        paths, result["serving"] = phase_serving_features()
        count_launches(rows, paths)
    elif args.only == "moe":
        paths, result["moe"] = phase_moe()
        count_launches(rows, paths)
    elif args.only == "ssm":
        paths, result["ssm"] = phase_ssm()
        rows += phase_family_int8_kernels(rows, paths)
        count_launches(rows, paths)
        result["rank_edges"] = phase_kernels(RANK_EDGE_SHAPES)
    elif args.only == "encdec":
        paths, result["encdec"], flash_rows = phase_encdec()
        rows += flash_rows + phase_family_int8_kernels(rows, paths)
        count_launches(rows, paths)
        result["encdec_extra"] = phase_kernels(ENCDEC_EXTRA_SHAPES)
    elif args.only == "vlm":
        paths, result["vlm"], flash_rows = phase_vlm(smi)
        rows += (flash_rows + phase_rank_gate_kernels()
                 + phase_family_int8_kernels(rows, paths, INT8_CEILING_SHAPES))
        mark("vlm")
        count_launches(rows, paths)
    elif args.only == "mla":
        paths, result["mla"], flash_rows = phase_mla(smi)
        rows += flash_rows
        mark("mla")
        count_launches(rows, paths)
    elif args.only == "shard":
        paths, result["sharded"] = phase_sharded()
        mark("sharded")
        count_launches(rows, paths)
    elif args.only == "sserve":
        paths, result["sharded_serving"] = phase_sharded_serving(smi)
        rows += sserve_kernel_rows(rows, paths)
        mark("sharded serving")
        count_launches(rows, paths)
    elif args.only == "ep":
        paths, result["ep"] = phase_ep(smi)
        rows += ep_kernel_rows(rows, paths)
        mark("expert parallelism")
        count_launches(rows, paths)
    elif args.only is None:
        engine, paths["serve"], result["serve"] = phase_serve(obs_root / "serve")
        result["parity"] = phase_parity(engine)
        result["profile"] = phase_profile(engine)
        del engine
        mark("serve")
        engine, paths["decompose serve"], result["decompose"] = phase_decompose()
        result["decompose"]["parity"] = phase_parity(engine)
        del engine
        for kind in EXPORTS:
            engine, paths[f"export {kind}"], result[f"export_{kind}"] = phase_export_serve(kind)
            result[f"int8_parity_{kind}"] = phase_int8_parity(engine, kind)
            result[f"int8_profile_{kind}"] = phase_profile(
                engine, label=f"int8 {kind} export decode step", int8=True)
            del engine
        result["int8_launches"] = phase_int8_launches()
        mark("decompose and export")
        params, paths["train"], result["train"] = phase_train(obs_root / "train")
        result["telemetry"] = phase_telemetry(result["serve"], result["train"], smi)
        obs_tmp.cleanup()
        result["grads"] = phase_grads(params)
        result["train_profile"] = phase_train_profile(params)
        # the autotuner, and phase 7's step as a meta dry-run cell against the card
        more, result["autotune"] = phase_autotune(result["train"]["steps"])
        paths.update(more)
        more, result["dryrun"] = phase_dryrun(result["train_profile"])
        paths.update(more)
        mark("autotune and dry-run")
        final, paths["rank decay"], paths["rank energy"], result["rank_adapt"] = \
            phase_rank_adapt_train()
        result["rank_adapt_profile"] = phase_rank_map_profiles(params, final)
        del params, final
        # the energy boundary's ranks are the card's: check what it launched
        checked = {(r["name"], shape_key(r["name"], r["shape"])) for r in rows}
        rows += phase_kernels([(name, shape_dims(name, key))
                               for name, keys in sorted(paths["rank energy"].items())
                               for key in sorted(keys) if (name, key) not in checked])
        params, alg1_run, paths["alg1 train"], result["alg1_train"] = phase_alg1_train()
        result["alg1_train_profile"] = phase_train_profile(
            params, run=alg1_run, phases=(-1, 1), label="alg1 train profile")
        del params
        int8_shapes = sorted({(name, key) for by in paths.values() for name in INT8_FUSED
                              for key in by[name]})
        if not any(name == "int8_linear" for name, _ in int8_shapes):
            # the measured export kept every group factorised on this card
            int8_shapes += [sk for sk in INT8_DEFAULT_SHAPES if sk[0] == "int8_linear"]
        rows += phase_int8_kernels(int8_shapes)
        engine, paths["flash serve"], result["flash_serve"] = phase_flash_serve()
        result["flash_parity"] = phase_flash_parity(engine)
        result["prefill_profile"] = phase_prefill_profile(engine)
        del engine
        launched = [flash_dims(key)
                    for key in sorted(paths["flash serve"]["flash_attention"])]
        rows += phase_flash_kernels(launched)
        # checked, not in the kernels line: no main path launches them
        result["flash_extra"] = phase_flash_kernels([d for d in FLASH_EXTRA
                                                     if d not in launched])
        mark("train, int8 and flash")
        result["designs"] = phase_designs()
        mark("designs")
        # the paper's conv and ViT path: no hand-written kernel runs on it
        result.update(phase_conv())
        mark("conv")
        # speculative decoding, the prefix cache, int8 KV and the fixed batch
        more, result["serving"] = phase_serving_features()
        paths.update(more)
        mark("serving features")
        # the MoE family: full-width OLMoE-1B-7B served, trained, rematerialised
        more, result["moe"] = phase_moe()
        paths.update(more)
        mark("moe")
        # the SSM and hybrid families: full-width xLSTM-350M and Zamba2-1.2B
        more, result["ssm"] = phase_ssm()
        paths.update(more)
        rows += phase_family_int8_kernels(rows, more)
        # checked, not in the kernels line: no main path launches them
        result["rank_edges"] = phase_kernels(RANK_EDGE_SHAPES)
        mark("ssm")
        # the enc-dec family: full-width seamless-m4t-medium, K8's
        # non-causal path on a main path
        more, result["encdec"], flash_rows = phase_encdec()
        paths.update(more)
        rows += flash_rows
        rows += phase_family_int8_kernels(rows, more)
        result["encdec_extra"] = phase_kernels(ENCDEC_EXTRA_SHAPES)
        mark("encdec")
        # the VLM family: full-width llama-3.2-vision-90b, K1-K5 past the
        # old rank ceilings on a main path; item 13's rows beside it
        more, result["vlm"], flash_rows = phase_vlm(smi)
        paths.update(more)
        rows += flash_rows + phase_rank_gate_kernels(skip=mla_kernel_shapes())
        rows += phase_family_int8_kernels(rows, more, INT8_CEILING_SHAPES)
        mark("vlm")
        # MLA and MTP: full-width DeepSeek-V3, K8 at q/k head dim 192 and v
        # head dim 128 on a main path
        more, result["mla"], flash_rows = phase_mla(smi)
        paths.update(more)
        rows += flash_rows
        mark("mla")
        # sharded training: two gloo ranks on the card, K1-K5 at local shapes
        more, result["sharded"] = phase_sharded()
        paths.update(more)
        mark("sharded")
        # sharded serving: gloo ranks on the card, K1/K5/K6/K7 at local columns
        more, result["sharded_serving"] = phase_sharded_serving(smi)
        paths.update(more)
        rows += sserve_kernel_rows(rows, more)
        mark("sharded serving")
        # expert parallelism: four gloo ranks on the card, OLMoE over meshes
        more, result["ep"] = phase_ep(smi)
        paths.update(more)
        rows += ep_kernel_rows(rows, more)
        mark("expert parallelism")
        count_launches(rows, paths)
        if not any(r["launches"] for r in rows if r["name"] == "int8_linear"):
            log("[kernels] int8_linear (K6) was launched on no main path in this run: the "
                "measured export merged no group on this card")
    else:
        rows += phase_int8_kernels(INT8_DEFAULT_SHAPES)
        rows += phase_int8_kernels(INT8_WIDE_SHAPES, iters=INT8_FAM_ITERS)
        rows += phase_flash_kernels([FLASH_SERVE_SHAPE] + FLASH_EXTRA
                                    + [flash_dims(k)
                                       for k in ED_FLASH])
        rows += phase_kernels(RANK_EDGE_SHAPES) + phase_rank_gate_kernels()
        rows += phase_flash_kernels([flash_dims(k) for k in VLM_FLASH]
                                    + [flash_dims(k) for k in DS_FLASH] + DS_FLASH_EXTRA)
        result["designs"] = phase_designs()
        for row in rows:
            row["launches"] = 0
    bwd_cu = "src/repro_torch/kernels/csrc/lowrank_bwd.cu"
    int8_cu = "src/repro_torch/kernels/csrc/int8_matmul.cu"
    src = {"lowrank_matmul": ("src/repro_torch/kernels/csrc/lowrank_matmul.cu",
                              "src/repro/kernels/lowrank_matmul.py:107"),
           "lowrank_gated_ffn": ("src/repro_torch/kernels/csrc/lowrank_ffn.cu",
                                 "src/repro/kernels/lowrank_ffn.py:52"),
           "lowrank_matmul_dx": (bwd_cu, "src/repro/kernels/lowrank_bwd.py:116"),
           "lowrank_matmul_du": (bwd_cu, "src/repro/kernels/lowrank_bwd.py:215"),
           "lowrank_matmul_dv": (bwd_cu, "src/repro/kernels/lowrank_bwd.py:298"),
           "int8_matmul": (int8_cu, "src/repro/kernels/int8_matmul.py:86"),
           "int8_lowrank_matmul": (int8_cu, "src/repro/kernels/int8_matmul.py:142"),
           "int8_linear": (int8_cu, "src/repro/kernels/int8_matmul.py:86"),
           "int8_lowrank_linear": (int8_cu, "src/repro/kernels/int8_matmul.py:142"),
           "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:81")}
    line = {"kernels": [dict(name=r["name"], shape=r["shape"], route="cuda",
                             source=src[r["name"]][0], replaces=src[r["name"]][1],
                             launches=r["launches"], max_abs_err=r["max_abs_err"],
                             ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                             bound_by=r["bound_by"], library_ms=r["library_ms"])
                        for r in rows]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    log(f"[run] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    if args.only:
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
