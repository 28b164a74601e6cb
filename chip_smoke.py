#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sgl_kernel_npu_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases (any failure raises and the script exits non-zero without a result):

1. Build the hand-written kernels from ``sgl_kernel_npu_tpu_torch/csrc`` with
   nvcc for sm_90a; print the build time and the card's name and power limit;
   time an empty kernel's launch (the launch floor of the kernels' times).
2. Weights (after a one-rank NCCL group is made for [4i] / [4j]):
   DeepSeek-V3 at its published widths (depth cut from 61 to 2
   layers, random weights from a seed) with DeepSeek-V3.2's indexer
   projections (drawn last: the other weights are DeepSeek-V3's), W8A8
   routed experts, the fused
   prologue's W8A8 weights (calibrated on the embeddings of the prompts
   below) and the W8A8 dense weights.
3. Hold each kernel (decode_mla, mla_prefill_pallas, gmm1_ring,
   gmm2_combine_ring, quant_matmul, quant_per_token, swiglu_quant,
   grouped_matmul, lightning_indexer_scores_prefill_pallas,
   mla_prefill_block_sparse) against its plain PyTorch version on the card, at the
   main path's full-width shapes and at small ragged cases, decode_mla and
   mla_prefill_pallas also on an int8 latent cache (there also at the shapes
   of phase 4c: decode contexts of 916-4016 keys on a 33-page table, a
   2048-row chunk at context 4096), decode_mla also across many of its key
   splits (those contexts with a row of context 1 and a pad row, bf16 and
   int8) and with its in-kernel int8 fold bit-equal to the wrapper fold
   around the same kernel, quant_per_token bit-equal to its plain version
   at a decode step's two widths, at [4k]'s 64-token and a 2048-token
   chunk's rows, in f32 and on the element path, quant_matmul also at a
   64-row chunk's wo
   and at a 2048-row chunk's wdqkv and wuq (its wgmma path; exact at 17, 65
   and 2047 rows too), grouped_matmul at 2048 and 4096 tokens
   of top-8 routing, the DSA kernels on a 2048-token chunk at context 4096
   (K9b on pages selected from K10's scores) and small ragged cases (K9b
   also at 64 heads); time
   the kernel, the plain version and,
   where one exists, a single PyTorch call computing the same function (CUDA
   events, L2 flushed before each launch); compute each kernel's bound from
   the bytes and operations of its inputs.
4. Serve through ``Engine`` + ``deepseek_adapter``: 6 requests of 96-700
   prompt tokens (two share a 256-token prefix, served so that the second
   reuses it from the radix cache), 16 new tokens each; first with the float
   MLA prologue (``moe_weights_q``), then with the fused W8A8 prologue
   (``mla_wq`` too).  Launch counts are reset just before each run and read
   just after; every kernel of the path must have run, every request
   finished and every page come back.  After each run one decode step on a
   live batch runs through the kernels and through the plain versions, and
   their logits are compared with the routing replayed.
4b. The fully W8A8 layer (``mla_wq`` + ``dense_wq`` + ``moe_weights_q``)
   through ``decode_step`` on the live batch and ``prefill_step`` on one
   64-token chunk, each against its plain versions; K1, K5 and K7a must
   have launched.
4c. Long prompts on the int8 latent cache: ``Engine`` with
   ``prefill_chunk=2048`` over ``deepseek_adapter`` on
   ``kv_cache_dtype="int8"`` with the fused prologue (``mla_wq`` calibrated
   with its per-head q scales): 5 prompts of 900-4000 tokens (two share a
   2048-token prefix, served so that the second reuses it), 16 new tokens
   each.  Every prefill call is 2048 rows, so its MoE runs on grouped_matmul
   (2 a layer); decode runs the ring GEMMs.  Launch counts, page release,
   radix reuse and the int8 cache are checked; then one decode step and one
   2048-row prefill chunk (at context 4096) are held to their plain
   versions with the routing replayed.
4d. DeepSeek-V3.2's sparse attention (DSA) in page mode on 4c's setup: the
   same prompts through ``Engine(prefill_chunk=2048)``; each prefill call
   scores its chunks with the lightning indexer (K10) and attends 16 selected
   pages a 64-token chunk (K9b, never K9a), each decode row 16 selected pages
   (K2 over a pruned block table).  Launch counts, pages, radix reuse and
   real pruning are checked; one decode step and one 2048-row chunk are held
   to their plain versions with the routing and the page selections
   replayed; then a decode step in token mode (K10 through
   ``lightning_indexer``), its token selections replayed.
4e. GPT-OSS-20B at its published widths (2 of 24 layers, random bf16
   weights from a seed, nonzero biases, untied head): rms_norm (K6a, also
   bit-equal to its CPU mirror ``rms_norm_rows_plain``; at Llama's width in
   [4f]), swiglu_oai (K7b), attention_sinks (K12a) and, over the packed cache,
   attention_sinks_packed (K12b / K12c), attention_sinks_prefill_pallas
   (K12d) held to their plain versions over bf16, int8, packed and packed
   int8 caches at the shapes the serve gives them and on ragged cases (ctx
   1, windows starting inside a page, pad rows, dead rows of a q-block, no
   sinks), timed beside their bounds, their plain versions and a library
   call (``F.rms_norm``; SDPA over the gathered, dequantized keys with one
   extra zero key whose mask is the sink logit); then
   ``Engine(prefill_chunk=512)`` + ``gpt_oss_adapter`` with its defaults
   serves 5 prompts of 300-2000 tokens (two share a 512-token prefix), 16
   new tokens each, with exact launch counts, page release and radix reuse
   checked; one decode step and one 512-row chunk at context 1024 held to
   ``plain=True``, the routing replayed; the same serve on the int8 cache
   (``kv_scale`` from ``calibrate_kv_scales`` over the bf16 serve's caches)
   and on the packed cache (K12b / K12c once a layer a decode call); a decode
   step and a 512-row chunk on the packed int8 cache with per-kv-head
   ``kv_scales``, and with W8A8 projections (``weights_q``: K1, K5), held to
   ``plain=True``.
4f. Llama-3.1-8B at its published widths (2 of 32 layers, random bf16
   weights, untied head, page 16): decode_gqa (K11a, which K11b's wrapper
   also launches) at its heads, bf16 and int8, and on ragged cases (a group
   of 16 at head_dim 32 and 64), and K12d without sinks or window, held to
   their plain versions and timed, K11a also with one row at 32768 keys
   beside [4e]'s rows on a 2048-page table (its keys split across 16
   blocks); swiglu_quant (K7a) at its W8A8 MLP's gate || up [8 / 512,
   28672], also with rows past a group total; one int8 decode_gqa and one
   bf16 attention_sinks call, each captured into a CUDA graph, must enqueue
   the decode kernel and nothing else (the int8 scales fold inside it), and a bf16 and an int8 K12d call its
   prefill kernel once and nothing else; ``Engine(prefill_chunk=512)`` +
   ``llama_adapter`` serves [4e]'s prompt lengths, float, then W8A8 on the
   int8 cache (its ``kv_scale`` calibrated), with exact launch counts
   (K11a, K12d, K6a; K1, K5, K7a), pages and radix reuse checked and a
   decode step and a 512-row chunk of each held to ``plain=True``.
4g. Multi-LoRA on [4f]'s Llama, and the add-RMSNorm ops: add_rms_norm_bias
   (K6b, with and without its static int8 quant), add_gemma_rms_norm (K6c,
   on K6b's kernel) and l1_norm (K6d, bf16 and f32) at [512, 4096] and [8,
   4096], K6b / K6c also bit-equal to their CPU mirror
   add_rms_norm_rows_plain, K6d to l1_norm_rows_plain; bgmv_fused (K13a) at H = D = 4096, rank 16, over 4 adapters at 8
   and 512 tokens, over 64 at 8, and with ids outside the pool;
   sgmv_fused (K13b) over a 512-row chunk of 4 sequences (one empty, a
   tail), ranks 16 / 8 / 4 / 16 and mixed scalings: each held to its plain
   version, two CUDA kernels a call, the shrink and the expand (a CUDA
   graph capture), two calls bit-identical, and timed; then the ops that no model calls (K6b-d, K13b) once
   through their entry points with their launches counted.  Then
   ``Engine(prefill_chunk=512)`` + ``llama_adapter(lora=...)`` (4 random
   adapters of rank 16 on q and o, adapter 0 zero) serves [4f]'s prompts
   under adapters 0-3 and two more requests on one prompt under adapters 1
   and 2: exact launch counts (K13a twice a layer a model call), pages,
   radix reuse among adapter-0 requests only (the LoRA requests on a cached
   prompt find 0 cached tokens), different tokens from the two adapters; a
   decode step of rows under adapters 0-3 and a 512-row chunk held to
   ``plain=True``, float and with W8A8 ``weights_q``.
5. ``torch.profiler`` breakdowns of a decode step, a mixed tick, the fully
   W8A8 decode step, one 2048-token prefill call on the int8 cache, one
   DSA prefill call and DSA decode step, a GPT-OSS decode step and 512-row
   prefill call, a Llama decode step and 512-row prefill call, and a Llama
   decode step under LoRA.
4h. DeepSeek-V3 training on one GPU, once every weight, engine and cache of
   the phases above is dropped (the memory on the card printed at the
   start, the peak at the end): mla_flash_fwd (K14a), mla_flash_bwd_dq
   (K14b) and mla_flash_bwd_dk (K14c) held to their plain versions at B 2 x
   S 520 x 128 heads and at ``TRAIN_SMALL``'s shapes (S 1-129, 4-128 heads,
   B 1-3), each also to its tiled mirror (the kernel's own walk) and
   bit-identical over two calls, timed beside their bounds, plain versions
   and SDPA; DeepSeek-V3's published widths cut to
   1 of 61 layers, bf16, with the float routed experts, served through
   ``Engine`` + ``deepseek_adapter`` without ``moe_weights_q`` (the dense
   float MoE) on [4]'s three shortest prompts (exact K2 / K9a counts, a
   decode step held to ``plain=True``); one training step's loss and every
   gradient leaf held to the ``plain=True`` and the dense-attention runs,
   the routing replayed; three SGD steps of ``make_train_step(flash=True)``
   on tokens [2, 520] with K14a-c exactly 3 launches each and finite
   losses; a step profiled, with no copy operator on a tensor of an expert
   weight's shape.
4i. GPT-OSS-20B expert parallel, after [4e] (its weights, prompts and
   512-token chunks) and before [5]: grouped_matmul_float (K8a's bf16
   ``none`` mode) held to its plain version at a chunk's two expert
   products (2048 rows of top-4 routing over 32 experts), and both bf16
   modes on ragged cases (an empty group, a group of one row, groups of
   one and of two or three 128-row work items, N = 2880, a total below S),
   timed beside the bound, the plain version and ``torch._grouped_mm``
   (or a loop of ``torch.matmul``); then ``Engine(prefill_chunk=512)`` +
   ``gpt_oss_adapter(ep_buffer=Buffer(...))`` on a one-rank NCCL group
   (``EPConfig()``: exact capacities) serves [4e]'s prompts: K8a ``none``
   exactly twice a layer a model call, K7b never, every all-to-all counted
   (four a MoE call), no row dropped, pages back, radix reuse; a decode step
   and a 512-row chunk held to ``plain=True`` and to [4e]'s all-experts
   path, the routing replayed, within 5e-2 of a row's largest.
4j. DeepSeek-V3 training expert parallel, after [4h] on its weights and
   tokens: grouped_matmul_float at a layer's three forward products and
   grouped_matmul_dx (K8a's ``rhs_contract_last``) at its three dx
   products (8320 rows of top-8 routing over 256 experts) held to their
   plain versions and timed; one step of ``loss_and_grads(mesh=<one-rank
   ("dp", "ep") DeviceMesh>, flash=True)`` held to the same step on the
   dense MoE (``mesh=None``), the routing replayed, within 1e-1 of a leaf's
   largest |g|; three SGD steps of ``make_train_step(CFG_TRAIN, mesh,
   flash=True)``: finite losses, K8a ``none`` and ``rhs_contract_last`` 3
   launches a layer a step, K14a-c one, all-to-alls counted; a step
   profiled, no expert weight copied, the peak memory.
4k. DeepSeek-V3 W8A8 expert parallel on the one-sided window transport,
   after [4i] while [4]'s weights are alive: pallas_ragged_all_to_all (K15b)
   bit-exact against its plain version (``all_to_all_single``) on a
   2048-token chunk's dispatch ([1, 16384, 7168] int8 and its [1, 16384, 2]
   int32 blob) and a decode step's, counts 0 to full; pallas_all_to_all
   (K15a) on the per-expert counts (one block), just past one block and on a
   chunk's payload; the monitored
   form (K15c) without a fault and with this rank muted (returns with its
   timeout flags); each timed beside its bound (live bytes read and written
   once), its plain version and ``all_to_all_single``.  fused_deep_moe_full_rank
   (K16b) at a decode step's rows, a 64-row chunk's, 512 and 2048 tokens
   against its plain version (1e-2 of a row's largest) and the unfused
   ``fused_deep_moe`` (relative mean difference < 4e-4), two calls on the
   same rows around one on other rows bit-identical (the other call held to
   its plain version), at 8 and 64 tokens bit-equal to its tiled walk
   (``fused_full.fused_deep_moe_full_tiled_plain``), timed beside the
   unfused form and ``_gmm_moe``.  Then ``Engine`` + ``deepseek_adapter(moe_weights_q=...,
   mla_wq=..., ep_buffer=Buffer(<one-rank NCCL group>, 256,
   EPConfig(comm_backend="pallas_ragged")))`` serves [4]'s prompts: a MoE
   call launches K15b 3 times, K15a and K5 once, K8a twice, never K3 / K4;
   no row dropped; tok/s beside [4]'s; a decode step and a 64-row chunk held
   to ``plain=True`` and to [4]'s single-GPU W8A8 path, the routing
   replayed, within 5e-2 of a row's largest; the decode step bit-identical
   on the ``"pallas_ragged"``, ``"pallas"`` and ``"xla"`` transports; a
   monitored ``Buffer.dispatch`` (K15c once); the decode step with
   ``single_kernel=True`` (K16b once a layer) held to its plain version;
   the four steps profiled (device busy share, launches a step).
4l. The last TPU kernels' paths, after [4k] while [4]'s experts and [4k]'s
   one-rank NCCL group are alive, at DeepSeek-V3's widths on layer 0's
   experts: grouped_matmul's remaining modes at a 2048-token chunk's 16384
   rows (``dequant_swiglu`` on the experts repacked at gate / up width 1024
   by a column permutation, ``dequant`` to f32, ``none`` on int8 rows, bf16
   ``none`` to bf16 beside ``torch._grouped_mm``) and on ragged cases, held
   to their plain versions and timed, the modes no caller reaches once
   through their entry point; ``_gmm_moe``'s dispatch_p + K8b branch
   (``deepseek_v3._gmm_moe_dispatch``) at 8, 64 and 512 tokens (each timed): K8a
   ``dispatch_p`` and grouped_matmul_combine (K8b) once a call, the output
   held to its plain version and to the ring branch (K3 + K4), ``dispatch_p``
   bit-equal to the gathered rows, K8b to its plain version, its rows d
   bit-equal to K8a ``dequant``, a call's CUDA graph holding K8b's three
   kernels once each and nothing else, timed beside K4;
   ``Buffer.fused_deep_moe(pack_tn=1024)`` on the ``"xla"`` and
   ``"pallas_ragged"`` transports at 8, 512 and 2048 tokens (K8a
   ``dequant_swiglu`` and ``dequant`` once a call, held to the full-width
   call and to ``plain=True``; with ``single_kernel=True`` K16b once a call,
   pairing gate and up by the pack width, held to the unfused call, to its
   plain version and at 8 tokens bit-equal to its tiled walk);
   fused_dispatch_gmm1 (K16a) at 8 tokens and a 64-row chunk on the group's
   window, held to its plain version and to K8a on the placed rows, a
   call's CUDA graph holding its one kernel alone, then through K7a, K8a
   and ``ep_core.combine_core`` to ``_gmm_moe``, timed beside K15b + K8a;
   gmm1_ring on bf16 tokens (K3's float-input mode)
   bit-equal to K5 + K3 and timed.
4p. The rest of DeepEP's ``Buffer``, after [4l] while [4]'s experts and
   [4k]'s one-rank NCCL group are alive, at the reference's low-latency
   default: 128 tokens, H 7168, top-8 of 256 experts, about 25 % of the
   (token, k) slots at -1.  (a) ``low_latency_dispatch`` (int8, validated;
   monitored on ``"pallas_ragged"``: K15c) → y = dequant(recv_x) · (global
   expert id + 1) → ``low_latency_combine`` (bf16) on the ``"xla"``,
   ``"pallas"`` and ``"pallas_ragged"`` transports: the packed ``[256, 128,
   7168]`` rows, scales, counts, drops and output bit-identical to
   ``"xla"``, the flags zero, ``calc_diff`` to the dense golden below 1e-4.
   (b) The decode MoE on that path: LL dispatch → the live rows gathered by
   the counts on the device → K8a ``dequant_swiglu_quant`` → K8a ``dequant``
   → LL combine, on layer 0's experts, held to
   ``Buffer.fused_deep_moe(single_kernel=True)`` (K16b) and to the unfused
   normal-mode form (relative mean below 4e-4), counts and drops exact.
   (c) A 2048-token chunk with ``EPConfig(normal_round_tokens=512)`` (4
   rounds) on ``"pallas_ragged"`` → K8a → combine, bit-identical to one
   round, both timed.  (d) On one-rank groups: ``dispatch_tp_allgather`` /
   ``combine_tp_reduce`` on the LL path, and ``dispatch_layered`` /
   ``combine_layered`` and their normal forms (int8, node hop
   ``dcn_transport="monitored"``: K15c), each equal to the EP path.
   (e) Every path's launch counts reset just before it and held exactly
   just after.  (f) LL dispatch and combine timed on each transport beside
   ``Buffer.dispatch`` / ``combine`` on the same tokens and each call's
   bytes bound, with the card's name and power limit.
4m. The engine's features on [4]'s setup (fused prologue, W8A8 experts,
   after [4l], [4]'s weights alive): [4]'s prompts served greedy (the
   reference), then with half the requests sampled (temperature 0.8, top-k
   50, top-p 0.9, min-p 0.05, repetition 1.1, presence 0.2, frequency 0.1,
   a seed each) and one greedy request ending at a stop token, twice (the
   same tokens), and prefill-first (``mixed=False``): the greedy rows and the
   stop request as the reference's, the sampled rows reproducible, pages
   returned; ``sample_tokens`` on a head's f32 logits on the card equal to
   the CPU's on a copy (the PRNG's bits bit-equal); the host copy of the
   penalties' counts timed.  Then chain (``spec_k=2``: the tree round at
   width 1) and tree (``spec_tree_width=2``) speculative decoding with a
   1-layer draft that shares the target's embedding, head and first layer:
   verify and decode run different kernels, so a bf16 near-tie of the head
   or of a router may flip a token and the run diverge from greedy; every
   emitted token's verify row is held to the decode path run on the same
   tokens with the routing forced to the verify's ([4]'s step rule); a row
   whose own routing differs must sit at a router near-tie (the decode
   router's margin for its choice within 5e-2 of its largest score at the
   first differing layer); at each request's first token that differs from
   the reference with the routing agreeing, the decode path's top-2 gap
   must be within 5e-2 of the row's largest |logit|; no page leaks; K1, K2, K9a, K3 and K4 counted exactly from each part's
   model calls; rounds, drafts accepted a round and decode tok/s beside the
   reference's.
4n. The host KV tier on [4c]'s setup (int8 latent cache, fused prologue,
   W8A8 experts, 2048-token chunks, its five prompts), after [4m]: a prefill
   engine P and a decode engine D over one ``HostKVPool`` (128 pinned host
   pages).  P serves the prompts for one token each and offloads their 83
   distinct full pages; P's caches, every tensor registered in a
   ``MemorySaver``, are paused with ``cpu_backup=True`` (at least 90 % of
   their bytes released to CUDA by ``torch.cuda.mem_get_info``, ``pause``
   returning exactly their bytes) and resumed (digests equal); P serves them
   again with 16 new tokens (device radix hits), and D serves them,
   restoring every full page from the host pool: D's tokens equal P's
   second serve's, its restored pages bit-equal to P's, its stats exact
   (the prefix two prompts share restored once), K1, K2, K9a, K8a, K3 and
   K4 counted exactly from its model calls, every page returned; offload
   and restore GB/s, pause / resume ms and time to first token of P and D.
   Then ``transfer_kv_dim_exchange`` over DeepSeek-V3's 61 layers of that
   cache (256 pages, 1.28 GB) both ways, bit-equal, sentinel host pages and
   unnamed device pages untouched, each direction timed beside a plain
   pinned ``copy_`` of the same bytes; and the slot and cache-location ops
   (``ops/mem_cache``) once on the card, each equal to its CPU result.
4o. Qwen3-Next-80B-A3B at its published widths (4 of 48 layers: three
   gated-delta-rule layers and one gated attention layer at head_dim 256,
   512 experts top-10 on every layer; bf16 weights from a seed), once [2]-[5]'s
   weights are dropped and before [4h]: K11a (decode_gqa) and K12d at head_dim
   256 held to their plain versions at [4o]'s decode contexts and a 512-row
   chunk at context 2048 (timed beside SDPA and the bound) and on ragged cases
   (context 1, a pad row, rows straddling pages, pad rows); then ``Engine(
   prefill_chunk=512, max_batch=4)`` + ``qwen3_hybrid_adapter`` serves six
   prompts of 300-2000 tokens (the last repeats the first), 16 new tokens
   each: state slots reused, every page and slot back, no radix reuse (the
   repeated prompt finds 0 cached tokens and gives its first serve's tokens),
   exact launch counts (K12d once a prefill call, K11a once a decode call: the
   one attention layer); a decode step and a 512-row chunk held to
   ``plain=True`` with the routing replayed, each run from the same restored
   state; a 700-token prompt prefilled in 512-row chunks then 4 tokens decoded
   against one prefill over the sequence (the routing replayed); the same
   serve with W8A8 ``weights_q`` (K1 and K5 counted exactly) and its steps
   held by ``w8a8_verdict``; device time of a decode step and a 512-row
   prefill call by region (GDN chunk loop, recurrent update, conv, dense MoE,
   K11a / K12d), the busy share and the chunk loop's launches.  Then chain
   speculation (``spec_k=2``) of the float target with a 1-layer
   Llama-shaped draft at Qwen3-Next's vocabulary on the first four prompts,
   against the plain greedy run, both serves' launches exact (K12d once an
   attention layer a target prefill call, verifies and catch-ups included,
   and once a draft prefill call; K11a once a decode call of either; K6a
   three times a draft call; nothing else): every emitted token's verify
   row (a one-request prefill) held to the decode path on the same tokens
   with the routing forced ([4m]'s ``spec_rule``: router near-ties and head
   near-ties within 5e-2 of a row's largest); from the same restored state
   with the routing replayed, every verify held to the same verify on the
   plain path (``routing_rule``) and the recurrent state after every
   rolled-back round (restore + catch-up) to the same catch-up on the plain
   path (2e-2) and to plain decoding of the same tokens (5e-2); rounds,
   drafts accepted a round and decode tok/s beside plain.  Last,
   the expert-parallel MoE: the layers' W8A8 experts
   (``quantize_hybrid_moe_weights``) and the float experts dropped (no dense
   MoE can run after); K5, K15b, K8a (GMM1 ``dequant_swiglu_quant`` at 512
   groups, N 1024; GMM2 ``dequant``, K 512) and K16b (``E_local`` 512) held
   to their plain versions at a decode step's 4 tokens and a 512-row chunk
   (K16b at 4 tokens also bit-equal to its tiled walk), K15a on the counts
   ``[1, 512]``, each timed beside its bound; the six prompts served through
   ``qwen3_hybrid_adapter(weights_q=..., moe_weights_q=..., ep_buffer=Buffer(
   <one-rank NCCL group>, 512, EPConfig(comm_backend="pallas_ragged")))``
   with exact launch counts (a MoE call: K15b 3, K15a 1, K5 1, K8a 2, GMM1
   once), no row dropped, pages and slots back, tok/s beside the dense-MoE
   W8A8 serve's; a decode step and a 512-row chunk held to ``plain=True``
   from a restored state, the routing replayed (5e-2 of a row's largest);
   the decode step bit-identical on the ``"pallas_ragged"``, ``"pallas"``
   and ``"xla"`` transports and with ``single_kernel=True`` (K16b once a
   layer) held to its plain version; the region profile with the EP
   kernels by name (the MoE's device ms, launches, busy share); chain
   speculation of this W8A8 + EP target as of the float one (its launches
   with the EP MoE's, every verify and catch-up a MoE call a layer), its
   verifies and rolled-back states held to the plain path's, and against
   the decode path (``spec_rule``, plain decoding) only printed: the chunk
   rule's bf16 roundings move the int8 levels of the next layer's input, so
   the two recurrences part by more than 5e-2 (PERF.md §6).
6. The multi-rank serving layouts (after [4h] / [4j], every earlier weight
   freed): each phase starts this script twice in its rank mode
   (``python3 chip_smoke.py --rank <task> <dir> <r>``), two processes on
   the one card in a gloo group over a ``FileStore`` in a temporary
   directory (the exchanges staged through the host,
   ``parallel/collectives.py``); the kernels are loaded, not rebuilt.  The
   parent prints both logs, checks both return codes (a failing child stops
   the other; its last lines are printed) and holds what they report.
   [4q] DeepSeek-V3 head-parallel decode: CFG's widths cut to 1 layer
   (bf16, the float experts, 23.3 GiB a process), each rank its 64 of 128
   heads (``tp_shard_layer``), [4]'s batch of 8 at [3]'s decode contexts on
   a bf16 cache of random history: ``decode_step_tp`` with K2 exactly once
   a layer a step on each rank and nothing else counted, the two ranks'
   outputs and caches bit-equal, each within 5e-2 of a row's largest of the
   one-rank ``decode_step`` on the same card and inputs (the routing
   replayed) and its caches bit-equal to that step's; K2 at 128, 64 and 16
   heads (a rank's share at tp 2 and 8) held to its plain version and
   timed; the step's wall and device busy beside the one-rank step's, the
   all-reduce alone, the bytes staged.  [4r] Llama-3.1-8B ([4f]'s
   weights): rank 0 alone serves [4f]'s prompts through ``llama_adapter``;
   then ``Engine(llama_pp_adapter)`` on 2 stages of 1 layer (the ranks'
   tokens equal each other and rank 0's serve, a stage's cache half the
   one-rank cache, K11a / K12d / K6a exact); rank 0 alone serves [4f]'s
   prompts and one of 8000 tokens at ``prefill_chunk`` 8192 in [4f]'s
   arrival order, then ``Engine(llama_cp_adapter)`` on the ring of 2 serves
   them so (no prefix matched: the CP prefill starts every prompt at 0;
   the ranks' tokens and prefill logits bit-equal; each prefill's last-row
   logits within 5e-2 of the row's largest of the one-rank serve's; the
   greedy tokens equal up to a near-tie, [4m]'s rule; K11a / K6a exact,
   K12d never); the 8000-token prefill's cache from ``prefill_step_cp``
   against the one-rank ``prefill_step``'s (2e-2) and bit-equal across
   ranks; the CP prefill's attention (``gathered_attention``) held to JAX's
   ring (``ring_attention``, 1e-2) and both timed against K12d;
   ``pipeline_forward`` with [4f]'s SwiGLU MLP as the stage, 8
   microbatches, forward and gradient against the sequential stages; tok/s
   of every serve.
7. Print the kernels' JSON line (41 rows for the 32 TPU kernel sites, K8a's
   modes, K3's float-input mode, K11a / K12d at head_dim 256 and K2 at a
   tp-2 rank's 64 heads in rows of their own, each from its own result; and
   ``launch_floor_ms``, the empty kernel's time), the card line, and last
   the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device is available")

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from sgl_kernel_npu_tpu_torch.config import EPConfig  # noqa: E402
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as m  # noqa: E402
from sgl_kernel_npu_tpu_torch.models import gpt_oss as g  # noqa: E402
from sgl_kernel_npu_tpu_torch.models import llama as lm  # noqa: E402
from sgl_kernel_npu_tpu_torch.models import qwen3_next as qn  # noqa: E402
from sgl_kernel_npu_tpu_torch.models import w8a8  # noqa: E402
from sgl_kernel_npu_tpu_torch.ops import (  # noqa: E402
    activation,
    gmm_ring,
    grouped_matmul,
    lora,
    lora_pallas,
    matmul,
    norm,
    quant,
    row_reduce,
)
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as da  # noqa: E402
from sgl_kernel_npu_tpu_torch.ops.attention import lightning_indexer as li  # noqa: E402
from sgl_kernel_npu_tpu_torch.ops.attention import mla_prefill as mp  # noqa: E402
from sgl_kernel_npu_tpu_torch.ops.attention import mla_train as mt  # noqa: E402
from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa  # noqa: E402
from sgl_kernel_npu_tpu_torch.parallel import (  # noqa: E402
    collectives,
    ep_core,
    fused_full,
    layered,
    pallas_a2a,
)
from sgl_kernel_npu_tpu_torch.parallel.pipeline import pipeline_forward  # noqa: E402
from sgl_kernel_npu_tpu_torch.parallel.ring_attention import (  # noqa: E402
    gathered_attention,
    ring_attention,
)
from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer  # noqa: E402
from sgl_kernel_npu_tpu_torch.ops import mem_cache, sampling  # noqa: E402
from sgl_kernel_npu_tpu_torch.runtime.engine import (  # noqa: E402
    Engine,
    HostKVPool,
    cache_tensors,
    SamplingParams,
    deepseek_adapter,
    gpt_oss_adapter,
    llama_adapter,
    llama_cp_adapter,
    llama_pp_adapter,
    qwen3_hybrid_adapter,
)
from sgl_kernel_npu_tpu_torch.utils import counters, cuda_lib, kvcacheio, prng, trace_profile  # noqa: E402
from sgl_kernel_npu_tpu_torch.utils.memory_saver import MemorySaver  # noqa: E402

SEED = 0
DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense tensor-core peaks, H100 SXM data sheet
INT8_OPS = 1979e12
F32_FLOPS = 67e12              # f32 outside the tensor cores

# deepseek-ai/DeepSeek-V3 config.json: hidden 7168, 128 heads, kv_lora_rank 512,
# q_lora_rank 1536, qk_nope 128, qk_rope 64, v_head 128, vocab 129280, 256 routed
# experts top-8, moe_intermediate 2048, 1 shared expert, sigmoid routing with
# e_score_correction_bias, n_group 8, topk_group 4, routed_scaling_factor 2.5,
# norm_topk_prob true, rope_theta 10000 (the default of ops/rope.py).  Cut: 61
# layers -> 2 (and every layer is MoE, as in the JAX model).  bf16 weights and
# caches, page 128.
FULL_LAYERS = 61
CFG = m.DeepSeekV3Config(
    vocab_size=129280, hidden=7168, num_layers=2, num_heads=128, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, q_lora_rank=1536, v_head_dim=128,
    num_experts=256, num_shared_experts=1, topk=8, moe_intermediate=2048,
    page_size=128, router_scoring="sigmoid_v3", n_group=8,
    topk_group=4, routed_scaling_factor=2.5, norm_topk_prob=True)

MAX_BATCH, PREFILL_CHUNK, MAX_PAGES_PER_REQ, NUM_PAGES = 8, 64, 8, 64
PROMPT_LENS = [96, 700, 150, 450, 520, 300]     # the 2nd and 6th share 256 tokens
SHARED_PREFIX = 256
NEW_TOKENS = 16
BASE_KERNELS = ("decode_mla", "mla_prefill_pallas", "gmm1_ring", "gmm2_combine_ring")  # every path

# [4c] long prompts on the int8 latent cache (the JAX config's ctkv_scale 1/32)
CFG_INT8 = dataclasses.replace(CFG, kv_cache_dtype="int8")
LONG_CHUNK, LONG_PAGES_PER_REQ, LONG_NUM_PAGES = 2048, 33, 256
LONG_PROMPT_LENS = [3500, 1800, 4000, 900, 2600]  # the 1st and 5th share 2048 tokens
LONG_SHARED = 2048

# [4d] deepseek-ai/DeepSeek-V3.2-Exp config.json: index_n_heads 64,
# index_head_dim 128, index_topk 2048, every other width DeepSeek-V3's; DSA in
# page mode (2048 keys = 16 pages of 128 a decode row or 64-token chunk) on
# [4c]'s int8 cache, fused prologue, chunks, prompts and 33-page tables
CFG_DSA = dataclasses.replace(CFG_INT8, sparse_count=2048, idx_heads=64, idx_dim=128,
                              sparse_granularity="page")
DSA_PAGES = -(-CFG_DSA.sparse_count // CFG_DSA.page_size)
DSA_KERNELS = ("lightning_indexer_scores_prefill_pallas", "mla_prefill_block_sparse")

# [4e] openai/gpt-oss-20b config.json: hidden 2880, 64 q heads and 8 kv heads
# of 64, 32 local experts top-4, intermediate 2880 a half, sliding window 128
# on the even layers (layer_types), vocab 201088, rms_norm_eps 1e-5,
# rope_theta 150000 (its YaRN scaling is not made: standard tables),
# attention_bias, an untied lm_head.  Cut: 24 layers -> 2 (one sliding, one
# full), bf16 weights from a seed with biases N(0, 0.02^2), page 16.
GPT_FULL_LAYERS = 24
CFG_GPT = g.GptOssConfig(
    vocab_size=201088, hidden=2880, num_layers=2, num_heads=64, num_kv_heads=8, head_dim=64,
    intermediate=2880, sliding_window=128, page_size=16, rope_theta=150000.0, rms_eps=1e-5,
    num_experts=32, topk=4, attention_bias=True)
GPT_CHUNK, GPT_PAGES_PER_REQ, GPT_NUM_PAGES = 512, 128, 1024
GPT_PROMPT_LENS = [1100, 300, 2000, 700, 1500]  # the 1st and 5th share 512 tokens
GPT_SHARED = 512
GPT_KERNELS = ("rms_norm", "swiglu_oai", "attention_sinks", "attention_sinks_prefill_pallas")

# [4f] meta-llama/Llama-3.1-8B config.json: hidden 4096, 32 q heads and 8 kv
# heads of 128, intermediate 14336, vocab 128256, rope_theta 500000 (its
# llama3 rope_scaling is not made: standard tables, as the JAX model),
# rms_norm_eps 1e-5, an untied lm_head.  Cut: 32 layers -> 2, bf16 weights
# from a seed, page 16; [4e]'s prompts, chunks and tables.
LLAMA_FULL_LAYERS = 32
LONG_DECODE_KEYS = 32768   # a long-context decode row beside [4e]'s, for K11a
CFG_LLAMA = lm.LlamaConfig(
    vocab_size=128256, hidden=4096, num_layers=2, num_heads=32, num_kv_heads=8, head_dim=128,
    intermediate=14336, page_size=16, rope_theta=500000.0, rms_eps=1e-5)

# [4g] multi-LoRA on [4f]'s Llama: 4 adapters of rank 16 on q and o (adapter
# 0 zero, as JAX's init_lora), random from a seed; the prompts' adapters (the
# 1st and 5th, which share 512 tokens, under adapter 0)
LORA_ADAPTERS, LORA_RANK = 4, 16
LORA_IDS = [0, 1, 2, 3, 0]

# [4h] DeepSeek-V3 training on one GPU: CFG's published widths cut to 1 of 61
# layers, bf16 weights with the float routed experts (12.43 B parameters,
# 24.9 GB; f32 would not fit beside the gradients), B x S = 2 x 520 tokens;
# SGD steps of make_train_step(flash=True) on K14a-c; the dense float MoE
# served on [4]'s three shortest prompts
CFG_TRAIN = dataclasses.replace(CFG, num_layers=1)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_NEW_TOKENS = 2, 520, 3, 8
TRAIN_KERNELS = ("mla_flash_fwd", "mla_flash_bwd_dq", "mla_flash_bwd_dk")
# (B, S, H) beside [2, 520] x 128 heads: one token, rows spanning tokens (4,
# 16, 20 heads; a K14a block boundary inside a token at 20), K14a's 64-key
# chunk edges at 128 heads, three batch rows (tests/test_torch_cuda_kernels
# TRAIN_CASES and more)
TRAIN_SMALL = ((2, 1, 128), (2, 17, 128), (1, 1, 16), (1, 40, 16), (2, 33, 4), (1, 70, 20),
               (1, 64, 128), (1, 65, 128), (1, 129, 128), (3, 65, 20))
# max |g_flash - g| / max |g| per gradient leaf, against the step with K14a-c's
# plain versions (the same arithmetic: bf16 rounding flips) and against the
# dense einsum attention (bf16 scores and probabilities), the routing replayed
TRAIN_TOL_PLAIN, TRAIN_TOL_DENSE = 5e-2, 1e-1

# [4i] GPT-OSS-20B served expert parallel: [4e]'s configuration, prompts and
# chunks, the MoE through Buffer.fused_oai_moe on a one-rank NCCL group
# (EPConfig(): exact capacities, no drops).  [4j] DeepSeek-V3 trained expert
# parallel: [4h]'s widths, weights and tokens through make_train_step(CFG_TRAIN,
# mesh, flash=True) on a one-rank ("dp", "ep") DeviceMesh.  K8a's bf16 modes
# against their plain versions: f32 outputs within 1e-2 of the largest |value|
EP_KERNELS = ("grouped_matmul_float", "grouped_matmul_dx")
EP_TOL = 1e-2

# [4o] Qwen/Qwen3-Next-80B-A3B-Instruct config.json: hidden 2048, vocab
# 151936, 48 layers (full_attention_interval 4: three gated-delta-rule layers,
# then a gated attention layer), 16 q heads and 2 kv heads of 256
# (partial_rotary_factor 0.25: rotary 64; rope_theta 1e7; the output gate and
# q / k norms), linear attention 16 k heads and 32 v heads of 128 with conv
# kernel 4, 512 experts top-10 (norm_topk_prob) of 512 and a shared expert of
# 512 on every layer, rms_norm_eps 1e-6, an untied lm_head.  Cut: 48 layers
# -> 4 (one interleave); the GDN chunk 16 (the JAX config's); bf16 weights
# from a seed; page 16.  Six prompts of 300-2000 tokens on 4 state slots (the
# last repeats the first), 512-token chunks.
QWEN_FULL_LAYERS = 48
CFG_QWEN = qn.Qwen3NextHybridConfig(
    vocab_size=151936, hidden=2048, num_layers=4, attn_every=4, num_k_heads=16, num_v_heads=32,
    head_k_dim=128, head_v_dim=128, conv_width=4, chunk_size=16, num_heads=16, num_kv_heads=2,
    head_dim=256, page_size=16, rope_theta=1e7, mlp_intermediate=5120, rotary_dim=64,
    attn_gate=True, qk_norm=True, rms_eps=1e-6, moe_experts=512, moe_topk=10,
    moe_intermediate=512, shared_expert_intermediate=512, norm_topk_prob=True)
QWEN_CHUNK, QWEN_BATCH, QWEN_PAGES_PER_REQ, QWEN_NUM_PAGES = 512, 4, 128, 640
QWEN_PROMPT_LENS = [300, 1200, 2000, 700, 1500]     # then the first prompt again
QWEN_NEW_TOKENS = NEW_TOKENS
QWEN_KERNELS = ("decode_gqa", "attention_sinks_prefill_pallas")

_flush_buf = None
SPIN_CYCLES = 1_000_000        # ~500 us at the H100's 1.98 GHz boost clock


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, spin: int = SPIN_CYCLES) -> float:
    """Median device time of ``fn`` over ``iters`` launches.  Before each: a
    64 MB read that evicts the 50 MB L2 and leaves it clean (the main path
    finds these inputs cold: a layer's weights and cache were last touched a
    layer ago; a write would leave dirty lines whose write-back the timed
    kernel would pay), then a device spin of ``spin`` cycles (~500 us by
    default), so that the host has
    enqueued ``fn``'s launches before the start event runs and the events time
    the device's work, not the host's Python overhead before the launch (a
    wrapper that folds int8 scales enqueues ~20 operations, which outlast a
    100 us spin)."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.ones(16 << 20, dtype=torch.int32, device=DEV)
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        _flush_buf.sum()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def rel_mean(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean |a - b| over mean |b|: the reference's fused-MoE bar."""
    return float((a.float() - b.float()).abs().mean() / b.float().abs().mean())


def attention_close(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """Max |err| and whether |err| <= 2e-2 + 2e-2 |plain| everywhere: the
    kernels round the output and the softmax probabilities (for P @ V) to
    bf16, the plain versions compute in f32 and round the output."""
    diff = (got.float() - want.float()).abs()
    return max_abs(got, want), bool((diff <= 2e-2 + 2e-2 * want.float().abs()).all())


def randn(gen, shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_cache(gen, n_pages, page, int8=False):
    """Random latent and rope caches; ``int8``: the latent as levels
    round(k / ctkv_scale) of the same N(0, 1) values (k_scale = ctkv_scale)."""
    kn = randn(gen, (n_pages, 1, page, 512))
    kr = randn(gen, (n_pages, 1, 64, page))
    if int8:
        kn = torch.clamp(torch.round(kn.float() / CFG.ctkv_scale), -128, 127).to(torch.int8)
    return kn, kr


def check_decode_mla(gen, b, heads, page, ctx_list, pad_rows, timed, int8=False,
                     table_pages=None):
    """``table_pages``: block-table width (the engine's ``max_pages_per_req``;
    the pages the contexts need by default)."""
    max_pages = max(-(-c // page) for c in ctx_list)
    n_pages = b * max_pages + 1
    kn, kr = paged_cache(gen, n_pages, page, int8)
    ks = CFG.ctkv_scale if int8 else None
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(b)) + 1
    bt = torch.zeros((b + pad_rows, table_pages or max_pages), dtype=torch.int32)
    bt[:b, :max_pages] = perm[: b * max_pages].reshape(b, max_pages)
    bt = bt.to(DEV)
    ctx = torch.tensor(ctx_list + [1] * pad_rows, dtype=torch.int32, device=DEV)
    q = randn(gen, (b + pad_rows, heads, 576))
    scale = CFG.sm_scale
    args = (q, kn, kr, ctx, scale, bt)
    got, want = da.decode_mla(*args, k_scale=ks), da.decode_mla_ref(*args, k_scale=ks)
    torch.cuda.synchronize()
    err, ok = attention_close(got, want)
    log(f"  decode_mla B={b}+{pad_rows} pad H={heads} page={page} ctx={ctx_list} "
        f"table {bt.shape[1]} pages, {'int8' if int8 else 'bf16'} latent: max|err| {err:.3e} "
        f"(tol 2e-2 + 2e-2 |plain|)")
    if not ok:
        raise AssertionError(f"decode_mla disagrees with its plain version: {err}")
    if not timed:
        return None
    ms = time_ms(lambda: da.decode_mla(*args, k_scale=ks), 50)
    plain_ms = time_ms(lambda: da.decode_mla_ref(*args, k_scale=ks), 10)
    # one PyTorch call for the same function: SDPA over the cache gathered to
    # dense [B, 1, L, 576] (and an int8 latent dequantized) beforehand, not timed
    max_len = max_pages * page
    kd = da._gather_pages(kn, bt, max_len)                           # [B, 1, L, 512]
    if int8:
        kd = (kd.float() * ks).to(torch.bfloat16)
    krd = da._gather_pages(kr.transpose(-1, -2), bt, max_len)
    kcat = torch.cat([kd, krd], dim=-1)
    mask = (torch.arange(max_len, device=DEV)[None, :] < ctx[:, None])[:, None, None, :]
    lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None, :], kcat, kd, attn_mask=mask, scale=scale, enable_gqa=True)
    library_ms = time_ms(lib_fn, 50)
    keys = sum(ctx_list)
    key_bytes = (512 if int8 else 1024) + 128                        # latent + bf16 rope
    nbytes = q.numel() * 2 + keys * key_bytes + got.numel() * 2 + bt.numel() * 4 + ctx.numel() * 4
    t_bound, by = bound(nbytes, keys * heads * (576 + 512) * 2, BF16_FLOPS)
    log(f"    {'int8' if int8 else 'bf16'} latent: {ms:.4f} ms (plain {plain_ms:.4f}, SDPA "
        f"{library_ms:.4f}, bound {t_bound:.4f} {by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=t_bound,
                bound_by=by)


def check_decode_mla_fold(gen, ctx_list, table_pages):
    """K2's int8 fold inside the kernel, bit for bit: ``decode_mla`` on int8
    levels with ``k_scale`` against the old wrapper path around the same
    kernel, ``unfold_out_scale(decode_mla(fold_q_scale(q, ks), levels,
    k_scale=1), ks)`` (the same splits, products and roundings)."""
    page, b = CFG.page_size, len(ctx_list)
    kn, kr = paged_cache(gen, b * table_pages + 1, page, True)
    bt = (torch.randperm(b * table_pages, generator=torch.Generator().manual_seed(b)) + 1).to(
        DEV, torch.int32).reshape(b, table_pages)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=DEV)
    q = randn(gen, (b, CFG.num_heads, 576))
    ks = CFG.ctkv_scale
    got = da.decode_mla(q, kn, kr, ctx, CFG.sm_scale, bt, k_scale=ks)
    inner = da.decode_mla(da.fold_q_scale(q, ks), kn, kr, ctx, CFG.sm_scale, bt, k_scale=1.0)
    same = bool(torch.equal(got, da.unfold_out_scale(inner, ks)))
    log(f"  decode_mla int8 fold inside the kernel, ctx {ctx_list} on a {table_pages}-page "
        f"table: bit-equal to the wrapper fold around the kernel: {same}")
    if not same:
        raise AssertionError("decode_mla's in-kernel int8 fold differs from the wrapper fold")


def check_mla_prefill(gen, heads, page, seq_list, ctx_list, pad_rows, timed, int8=False,
                      table_pages=None):
    bsz = len(seq_list)
    max_pages = max(-(-c // page) for c in ctx_list)
    n_pages = bsz * max_pages
    kn, kr = paged_cache(gen, n_pages, page, int8)
    ks = CFG.ctkv_scale if int8 else None
    bt = torch.zeros((bsz, table_pages or max_pages), dtype=torch.int32, device=DEV)
    bt[:, :max_pages] = torch.arange(n_pages, dtype=torch.int32, device=DEV).reshape(bsz,
                                                                                      max_pages)
    seq = torch.tensor(seq_list, dtype=torch.int32, device=DEV)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=DEV)
    s = sum(seq_list) + pad_rows
    q = randn(gen, (s, heads, 576))
    scale = CFG.sm_scale
    got = mp.mla_prefill_pallas(q, kn, kr, seq, bt, ctx, scale, max_q=max(seq_list),
                                k_scale=ks)
    want = mp.mla_prefill_ref(q, kn, kr, seq, bt, ctx, scale, k_scale=ks)
    torch.cuda.synchronize()
    err, ok = attention_close(got, want)
    log(f"  mla_prefill H={heads} page={page} seq={seq_list} ctx={ctx_list} +{pad_rows} "
        f"pad rows, table {bt.shape[1]} pages, {'int8' if int8 else 'bf16'} latent: max|err| "
        f"{err:.3e} (tol 2e-2 + 2e-2 |plain|)")
    if not ok:
        raise AssertionError(f"mla_prefill disagrees with its plain version: {err}")
    if pad_rows and not bool((got[-pad_rows:] == 0).all()):
        raise AssertionError("mla_prefill pad rows are not zero")
    if not timed:
        return None
    ms = time_ms(lambda: mp.mla_prefill_pallas(q, kn, kr, seq, bt, ctx, scale,
                                               max_q=max(seq_list), k_scale=ks), 20)
    plain_ms = time_ms(lambda: mp.mla_prefill_ref(q, kn, kr, seq, bt, ctx, scale,
                                                  k_scale=ks), 5)
    # one request: SDPA over its dense cache (an int8 latent dequantized
    # beforehand, not timed) with the causal offset mask
    library_ms = None
    if bsz == 1:
        sl, cl = seq_list[0], ctx_list[0]
        kd = da._gather_pages(kn, bt[:1], cl)
        if int8:
            kd = (kd.float() * ks).to(torch.bfloat16)
        kcat = torch.cat([kd, da._gather_pages(kr.transpose(-1, -2), bt[:1], cl)], dim=-1)
        qpos = cl - sl + torch.arange(sl, device=DEV)
        mask = (torch.arange(cl, device=DEV)[None, :] <= qpos[:, None])[None, None]
        qh = q[:sl].transpose(0, 1)[None]                                  # [1, H, S, 576]
        lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kcat, kd, attn_mask=mask, scale=scale, enable_gqa=True)
        library_ms = time_ms(lib_fn, 20)
        del kd, kcat, mask
    ops = sum(heads * (c - sq + j + 1) * (576 + 512) * 2
              for sq, c in zip(seq_list, ctx_list) for j in range(sq))
    key_bytes = (512 if int8 else 1024) + 128                            # latent + bf16 rope
    nbytes = q.numel() * 2 + got.numel() * 2 + sum(ctx_list) * key_bytes + bt.numel() * 4
    t_bound, by = bound(nbytes, ops, BF16_FLOPS)
    log(f"    {'int8' if int8 else 'bf16'} latent: {ms:.4f} ms (plain {plain_ms:.4f}, SDPA "
        f"{library_ms}, bound {t_bound:.4f} {by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=t_bound,
                bound_by=by)


def routing(gen, n_tok, topk, n_exp):
    """Distinct experts per token, uniformly at random (what a random router gives)."""
    scores = torch.rand((n_tok, n_exp), generator=gen, device=DEV)
    idx = torch.topk(scores, topk, dim=-1).indices
    flat = idx.reshape(-1)
    gsizes = torch.bincount(flat, minlength=n_exp).to(torch.int32)
    src = torch.argsort(flat, stable=True).to(torch.int32)
    dest = torch.empty_like(src)
    dest[src.long()] = torch.arange(flat.numel(), dtype=torch.int32, device=DEV)
    return gsizes, src // topk, dest.reshape(n_tok, topk)


def check_gmm(gen, moe, n_tok, topk, timed, label):
    """gmm1_ring then gmm2_combine_ring on one layer's experts."""
    w1, s1, w2, s2 = moe
    n_exp, k, n = w1.shape
    gsizes, tok_of_row, dest = routing(gen, n_tok, topk, n_exp)
    x = randn(gen, (n_tok, k), torch.float32)
    sx = torch.clamp_min(x.abs().amax(-1) / 127.0, 1e-12)
    xq = torch.clamp(torch.round(x / sx[:, None]), -128, 127).to(torch.int8)
    topw = torch.rand((n_tok, topk), generator=gen, device=DEV)
    h1, hs = gmm_ring.gmm1_ring(xq, tok_of_row, w1, gsizes, sx, s1)
    h1_p, hs_p = gmm_ring.gmm1_ring_ref(xq, tok_of_row, w1, gsizes, sx, s1)
    out = gmm_ring.gmm2_combine_ring(h1_p, w2, gsizes, hs_p, s2, dest, topw)
    out_p = gmm_ring.gmm2_combine_ring_ref(h1_p, w2, gsizes, hs_p, s2, dest, topw)
    torch.cuda.synchronize()
    err1 = max_abs(h1, h1_p)
    err_s = float(((hs - hs_p).abs() / hs_p.abs().clamp_min(1e-30)).max())
    err2 = max_abs(out, out_p)
    tol2 = 1e-5 * float(out_p.abs().max())
    touched = int((gsizes > 0).sum())
    log(f"  {label}: {n_tok} tokens x top-{topk} = {tok_of_row.numel()} rows over "
        f"{touched} experts: gmm1 max|h1 err| {err1:.0f} int8 levels (tol 1), hs rel err "
        f"{err_s:.2e} (tol 1e-5); gmm2 max|err| {err2:.3e} (tol {tol2:.3e}: f32 sums "
        f"in another order)")
    if not (err1 <= 1 and err_s <= 1e-5 and err2 <= tol2):
        raise AssertionError(f"gmm ring kernels disagree: {err1}, {err_s}, {err2}")
    if not timed:
        return None
    s_rows = tok_of_row.numel()
    i = n // 2
    r1 = dict(
        ms=time_ms(lambda: gmm_ring.gmm1_ring(xq, tok_of_row, w1, gsizes, sx, s1), 20),
        plain_ms=time_ms(lambda: gmm_ring.gmm1_ring_ref(xq, tok_of_row, w1, gsizes, sx,
                                                        s1), 3),
        err=err1, library_ms=None)
    r1["bound_ms"], r1["bound_by"] = bound(
        touched * k * n + touched * n * 4 + xq.numel() + n_tok * 4 + s_rows * 4
        + s_rows * i + s_rows * 4, 2 * s_rows * k * n, INT8_OPS)
    r2 = dict(
        ms=time_ms(lambda: gmm_ring.gmm2_combine_ring(h1_p, w2, gsizes, hs_p, s2, dest,
                                                      topw), 20),
        plain_ms=time_ms(lambda: gmm_ring.gmm2_combine_ring_ref(h1_p, w2, gsizes, hs_p, s2,
                                                                dest, topw), 3),
        err=err2, library_ms=None)
    h = w2.shape[2]
    r2["bound_ms"], r2["bound_by"] = bound(
        touched * i * h + touched * h * 4 + h1_p.numel() + s_rows * 4 + dest.numel() * 8
        + n_tok * h * 4, 2 * s_rows * i * h, INT8_OPS)
    return r1, r2


def check_gmm_small(gen):
    """Ragged: 8 experts with empty groups, 6 rows (far below any tile) and a
    pad row whose token id is n_tok."""
    g, k, n, h = 8, 256, 512, 256
    w1 = torch.randint(-127, 128, (g, k, n), generator=gen, device=DEV, dtype=torch.int8)
    w2 = torch.randint(-127, 128, (g, n // 2, h), generator=gen, device=DEV,
                       dtype=torch.int8)
    s1 = torch.rand((g, n), generator=gen, device=DEV) / 100
    s2 = torch.rand((g, h), generator=gen, device=DEV) / 100
    gsizes = torch.tensor([0, 2, 0, 0, 3, 0, 1, 0], dtype=torch.int32, device=DEV)
    tok = torch.tensor([0, 2, 1, 3, 0, 2], dtype=torch.int32, device=DEV)   # 3 = pad (n_tok)
    xq = torch.randint(-127, 128, (3, k), generator=gen, device=DEV, dtype=torch.int8)
    sx = torch.rand(3, generator=gen, device=DEV) / 50
    h1, hs = gmm_ring.gmm1_ring(xq, tok, w1, gsizes, sx, s1)
    h1_p, hs_p = gmm_ring.gmm1_ring_ref(xq, tok, w1, gsizes, sx, s1)
    dest = torch.tensor([[0, 4], [2, 5], [1, 3]], dtype=torch.int32, device=DEV)
    topw = torch.rand((3, 2), generator=gen, device=DEV)
    init = torch.randn((3, h), generator=gen, device=DEV)
    out = gmm_ring.gmm2_combine_ring(h1_p, w2, gsizes, hs_p, s2, dest, topw, init=init)
    out_p = gmm_ring.gmm2_combine_ring_ref(h1_p, w2, gsizes, hs_p, s2, dest, topw, init=init)
    torch.cuda.synchronize()
    err1, err2 = max_abs(h1, h1_p), max_abs(out, out_p)
    log(f"  gmm small ragged (groups {gsizes.tolist()}, pad row, init): gmm1 max|h1 err| "
        f"{err1:.0f} (tol 1), gmm2 max|err| {err2:.3e} (tol 1e-4)")
    if not (err1 <= 1 and bool((h1[3] == 0).all()) and err2 <= 1e-4):
        raise AssertionError(f"gmm small case disagrees: {err1}, {err2}")


def check_grouped_matmul(gen, moe, n_tok, topk, timed):
    """K8a on one layer's experts at a prefill batch of ``n_tok`` tokens of
    random top-k routing: GMM1 (``dequant_swiglu_quant``) on the gathered
    token rows, then GMM2 (``dequant``, bf16 out) on the plain GMM1's output.
    Tolerances: int8 within one level (the SiLU's exp), scales rtol 1e-6,
    GMM2 within one bf16 ulp (2^-7 |plain|: the same f32 operations)."""
    w1, s1, w2, s2 = moe
    n_exp, k, n = w1.shape
    i, h = n // 2, w2.shape[2]
    gsizes, tok_of_row, _ = routing(gen, n_tok, topk, n_exp)
    x = randn(gen, (n_tok, k), torch.float32)
    sx_tok = torch.clamp_min(quant.row_scale(x), 1e-12)
    xq = quant.saturate_int8(x / sx_tok[:, None])
    rows = tok_of_row.long()
    xg, sxg = xq[rows], sx_tok[rows]
    gm, gm_p = grouped_matmul.grouped_matmul, grouped_matmul.grouped_matmul_plain
    kw1 = dict(epilogue="dequant_swiglu_quant")
    kw2 = dict(epilogue="dequant")
    h1, hs = gm(xg, w1, gsizes, sxg, s1, **kw1)
    h1_p, hs_p = gm_p(xg, w1, gsizes, sxg, s1, **kw1)
    y = gm(h1_p, w2, gsizes, hs_p, s2, **kw2)
    y_p = gm_p(h1_p, w2, gsizes, hs_p, s2, **kw2)
    torch.cuda.synchronize()
    err1 = max_abs(h1, h1_p)
    err_s = float(((hs - hs_p).abs() / hs_p.abs().clamp_min(1e-30)).max())
    err2 = max_abs(y, y_p)
    rel2 = float(((y.float() - y_p.float()).abs() / y_p.float().abs().clamp_min(1e-30)).max())
    s_rows = rows.numel()
    touched = int((gsizes > 0).sum())
    log(f"  grouped_matmul {n_tok} tokens x top-{topk} = {s_rows} rows over {touched} experts: "
        f"GMM1 max|h1 err| {err1:.0f} int8 levels (tol 1), scale rel err {err_s:.2e} "
        f"(tol 1e-6); GMM2 max|err| {err2:.3e}, max rel {rel2:.2e} (tol 2^-7: a bf16 ulp)")
    if not (err1 <= 1 and err_s <= 1e-6 and rel2 <= 2 ** -7):
        raise AssertionError(f"grouped_matmul disagrees with its plain version: {err1}, "
                             f"{err_s}, {rel2}")
    if not timed:
        return None
    r1 = dict(err=err1, library_ms=None,
              ms=time_ms(lambda: gm(xg, w1, gsizes, sxg, s1, **kw1), 10),
              plain_ms=time_ms(lambda: gm_p(xg, w1, gsizes, sxg, s1, **kw1), 2))
    r1["bound_ms"], r1["bound_by"] = bound(
        s_rows * k + touched * k * n + touched * n * 4 + s_rows * 4 + s_rows * i + s_rows * 4,
        2 * s_rows * k * n, INT8_OPS)
    r2 = dict(err=err2, library_ms=None,
              ms=time_ms(lambda: gm(h1_p, w2, gsizes, hs_p, s2, **kw2), 10),
              plain_ms=time_ms(lambda: gm_p(h1_p, w2, gsizes, hs_p, s2, **kw2), 2))
    r2["bound_ms"], r2["bound_by"] = bound(
        s_rows * i + touched * i * h + touched * h * 4 + s_rows * 4 + s_rows * h * 2,
        2 * s_rows * i * h, INT8_OPS)
    for name, r in (("GMM1", r1), ("GMM2", r2)):
        log(f"    {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} {r['bound_by']})")
    return r1, r2


def check_grouped_matmul_small(gen):
    """K8a on ragged cases: empty groups and rows past the total, a single
    row, K not a multiple of the kernel's 128-byte stage (nor of 32), groups
    of more than one 128-row work item; both epilogues."""
    cases = [((0, 5, 0, 17, 1, 0, 40, 1), 80, 1024, 256), ((0, 1, 0, 0), 1, 256, 128),
             ((3, 0, 70, 9), 100, 336, 160), ((130, 64, 65, 0, 200), 500, 512, 512)]
    gm, gm_p = grouped_matmul.grouped_matmul, grouped_matmul.grouped_matmul_plain
    for sizes, s, k, i in cases:
        g = len(sizes)
        gs = torch.tensor(sizes, dtype=torch.int32, device=DEV)
        x = torch.randint(-127, 128, (s, k), generator=gen, device=DEV, dtype=torch.int8)
        w1 = torch.randint(-127, 128, (g, k, 2 * i), generator=gen, device=DEV, dtype=torch.int8)
        w2 = torch.randint(-127, 128, (g, i, k), generator=gen, device=DEV, dtype=torch.int8)
        sx = torch.rand(s, generator=gen, device=DEV) / 50 + 1e-3
        s1 = torch.rand((g, 2 * i), generator=gen, device=DEV) / 500 + 1e-4
        s2 = torch.rand((g, k), generator=gen, device=DEV) / 500 + 1e-4
        total = sum(sizes)
        kw1 = dict(epilogue="dequant_swiglu_quant")
        h1, hs = gm(x, w1, gs, sx, s1, **kw1)
        h1_p, hs_p = gm_p(x, w1, gs, sx, s1, **kw1)
        ok = max_abs(h1, h1_p) <= 1 and bool(torch.allclose(hs, hs_p, rtol=1e-6, atol=0))
        ok = ok and not h1[total:].any() and not hs[total:].any()
        kw2 = dict(epilogue="dequant")
        y, y_p = gm(h1_p, w2, gs, hs_p, s2, **kw2), gm_p(h1_p, w2, gs, hs_p, s2, **kw2)
        rel = float(((y.float() - y_p.float()).abs()
                     / y_p.float().abs().clamp_min(1e-30))[:total].max()) if total else 0.0
        ok = ok and rel <= 2 ** -7 and not y[total:].any()
        torch.cuda.synchronize()
        log(f"  grouped_matmul ragged (groups {list(sizes)}, S={s}, K={k}, I={i}): GMM1 max|h1 "
            f"err| {max_abs(h1, h1_p):.0f} (tol 1), GMM2 max rel err {rel:.2e} (tol 2^-7: a "
            f"bf16 ulp), rows past the total zero: {ok}")
        if not ok:
            raise AssertionError(f"grouped_matmul small case disagrees: {sizes}")


def check_indexer(gen, label, lens_q, lens_k, max_q, page, table_pages, timed, q_chunk=64,
                  heads=64, dim=128):
    """K10 on random bf16 index queries and keys (f32 weights) for requests
    of ``lens_q`` new tokens at contexts ``lens_k`` on ``table_pages``-page
    tables: -inf at the same positions as the plain version and the finite
    scores within 1e-4 of each row's largest |score| (f32 sums of exact bf16
    products, in another order).  Returns the kernel's scores (and the
    inputs) and, timed, the JSON numbers."""
    b = len(lens_q)
    n_pages = b * table_pages + 1
    key = randn(gen, (n_pages, 1, page, dim))
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(b)) + 1
    bt = perm[: b * table_pages].reshape(b, table_pages).to(torch.int32).to(DEV)
    q = randn(gen, (b, max_q, heads, dim))
    w = randn(gen, (b, max_q, heads), torch.float32)
    lq = torch.tensor(lens_q, dtype=torch.int32, device=DEV)
    lk = torch.tensor(lens_k, dtype=torch.int32, device=DEV)
    args = (q, w, key, lq, lk, bt)
    got = li.lightning_indexer_scores_prefill_pallas(*args, q_chunk=q_chunk)
    want = li.lightning_indexer_scores_prefill_ref(*args, q_chunk=q_chunk)
    torch.cuda.synchronize()
    dead = torch.isinf(want)
    same_dead = bool((torch.isinf(got) == dead).all()) and bool((got[dead] < 0).all())
    diff = (torch.where(dead, 0.0, got) - torch.where(dead, 0.0, want)).abs()
    err = float(diff.max())
    rel = float((diff / torch.where(dead, 0.0, want).abs().amax(-1, keepdim=True)
                 .clamp_min(1e-30)).max())
    log(f"  lightning_indexer_scores_prefill {label}: {heads} heads x {dim}, page {page}, "
        f"lens_q {lens_q}, lens_k {lens_k}, max_q {max_q} (chunk {min(q_chunk, max(8, max_q))}), "
        f"table {table_pages} pages: -inf positions equal: {same_dead}; max|err| {err:.3e}, "
        f"max err / row's max|score| {rel:.2e} (tol 1e-4)")
    if not (same_dead and rel <= 1e-4):
        raise AssertionError(f"the indexer kernel disagrees with its plain version: {rel}")
    if not timed:
        return got, args, None
    r = dict(err=err, library_ms=None,
             ms=time_ms(lambda: li.lightning_indexer_scores_prefill_pallas(*args), 20),
             plain_ms=time_ms(lambda: li.lightning_indexer_scores_prefill_ref(*args), 3))
    # this run's (token, key) pairs: each live token against its causal keys
    pairs = sum(lk_ - lq_ + t + 1 for lq_, lk_ in zip(lens_q, lens_k) for t in range(lq_))
    nbytes = (q.numel() * 2 + w.numel() * 4 + sum(lens_k) * dim * 2 + got.numel() * 4
              + bt.numel() * 4 + 8 * b)
    r["bound_ms"], r["bound_by"] = bound(nbytes, pairs * heads * (2 * dim + 2), BF16_FLOPS)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, no single PyTorch call, bound "
        f"{r['bound_ms']:.4f} {r['bound_by']})")
    return got, args, r


def check_block_sparse(gen, label, heads, page, seq_list, ctx_list, table_pages, pos_sel,
                       q_chunk, timed, int8=False):
    """K9b on random queries and caches over the pages ``pos_sel`` names,
    against its plain version (``attention_close``), pad rows zero.  Timed
    (one request): the kernel, the plain version and one SDPA call over each
    chunk's selected pages gathered (and, for int8, dequantized) beforehand,
    not timed; the bound counts each selected page once and each row's
    visible keys among its chunk's pages."""
    bsz = len(seq_list)
    kn, kr = paged_cache(gen, bsz * table_pages, page, int8)
    ks = CFG.ctkv_scale if int8 else None
    bt = torch.arange(bsz * table_pages, dtype=torch.int32, device=DEV).reshape(bsz,
                                                                                table_pages)
    seq = torch.tensor(seq_list, dtype=torch.int32, device=DEV)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=DEV)
    pad_rows = 2
    q = randn(gen, (sum(seq_list) + pad_rows, heads, 576))
    scale = CFG.sm_scale
    kw = dict(max_q=max(seq_list), q_chunk=q_chunk, k_scale=ks)
    args = (q, kn, kr, seq, bt, ctx, scale, pos_sel)
    got = mp.mla_prefill_block_sparse(*args, **kw)
    want = mp.mla_prefill_block_sparse_ref(*args, **kw)
    torch.cuda.synchronize()
    err, ok = attention_close(got, want)
    live = (pos_sel >= 0).sum(-1)
    log(f"  mla_prefill_block_sparse {label}: H={heads} page={page} seq={seq_list} "
        f"ctx={ctx_list}, {pos_sel.shape[1]} chunks of {min(q_chunk, max(8, max(seq_list)))}, "
        f"{int(live.min())}-{int(live.max())} live of {pos_sel.shape[2]} slots, "
        f"{'int8' if int8 else 'bf16'} latent: max|err| {err:.3e} (tol 2e-2 + 2e-2 |plain|)")
    if not ok or not bool((got[-pad_rows:] == 0).all()):
        raise AssertionError(f"mla_prefill_block_sparse disagrees with its plain version: {err}")
    if not timed:
        return None
    r = dict(err=err, ms=time_ms(lambda: mp.mla_prefill_block_sparse(*args, **kw), 20),
             plain_ms=time_ms(lambda: mp.mla_prefill_block_sparse_ref(*args, **kw), 3))
    sl, cl = seq_list[0], ctx_list[0]
    cq = min(q_chunk, max(8, sl))
    sel = pos_sel[0].tolist()
    n_sel = max(len([p for p in c if p >= 0]) for c in sel)
    qs, ks_, vs, masks, ops = [], [], [], [], 0
    for c in range(-(-sl // cq)):
        pages = [p for p in sel[c] if p >= 0]
        kpos = (torch.tensor(pages, device=DEV)[:, None] * page
                + torch.arange(page, device=DEV)[None, :]).reshape(-1)
        kd = da._gather_pages(kn, bt[:1, pages], len(pages) * page)[0, 0]
        if int8:
            kd = (kd.float() * ks).to(torch.bfloat16)
        krd = da._gather_pages(kr.transpose(-1, -2), bt[:1, pages], len(pages) * page)[0, 0]
        rows = torch.arange(c * cq, min((c + 1) * cq, sl), device=DEV)
        mask = kpos[None, :] <= (cl - sl + rows)[:, None]
        ops += int(mask.sum()) * heads * (576 + 512) * 2
        extra = (n_sel - len(pages)) * page
        kcat = torch.nn.functional.pad(torch.cat([kd, krd], dim=-1), (0, 0, 0, extra))
        ks_.append(kcat)
        vs.append(torch.nn.functional.pad(kd, (0, 0, 0, extra)))
        masks.append(torch.nn.functional.pad(mask, (0, extra, 0, cq - len(rows))))
        qs.append(torch.nn.functional.pad(q[rows], (0, 0, 0, 0, 0, cq - len(rows))))
    # the chunks as the batch, each chunk's (token, head) rows as one query
    # sequence against its single latent head (no GQA expansion of K and V)
    n_c = len(qs)
    qh = torch.stack(qs).reshape(n_c, 1, cq * heads, 576)
    kh, vh = torch.stack(ks_)[:, None], torch.stack(vs)[:, None]           # [C, 1, L, .]
    mh = torch.stack(masks).repeat_interleave(heads, dim=1)[:, None]       # [C, 1, cq H, L]
    r["library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mh, scale=scale), 20)
    del qh, kh, vh, mh
    distinct = {p for c in sel for p in c if p >= 0}
    key_bytes = (512 if int8 else 1024) + 128
    nbytes = (q.numel() * 2 + got.numel() * 2 + len(distinct) * page * key_bytes
              + pos_sel.numel() * 4 + bt.numel() * 4)
    r["bound_ms"], r["bound_by"] = bound(nbytes, ops, BF16_FLOPS)
    log(f"    {'int8' if int8 else 'bf16'} latent: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
        f"SDPA {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} {r['bound_by']})")
    return r


def check_dsa_kernels(gen):
    """Phase [3] for DSA: K10 at full width on a 2048-token chunk at context
    4096 (a 33-page table), on ragged requests (page 16; 1, 5 and 40 new
    tokens after earlier context; pad rows; max_q 45 in chunks of 16) and at
    the decode shape (one token in each of 8 rows: [4c]'s five contexts and
    three engine pad rows); K9b on that chunk over the pages
    select_prefill_pages takes from K10's scores (16 of each 64-token
    chunk's 17-32 causal pages), bf16 and int8 latent, and on a small case
    with dead slots, a dead page before the live ones and a chunk straddling
    two pages.  Returns the two kernels' JSON numbers."""
    page, pages = CFG.page_size, LONG_PAGES_PER_REQ
    scores, (_, _, _, lq, lk, _), r10 = check_indexer(
        gen, "full width", [LONG_CHUNK], [2 * LONG_CHUNK], LONG_CHUNK, page, pages, True)
    check_indexer(gen, "ragged", [1, 5, 40], [30, 70, 40], 45, 16, 5, False, q_chunk=16)
    long_ctx = [n + NEW_TOKENS for n in LONG_PROMPT_LENS]
    check_indexer(gen, "decode shape", [1] * MAX_BATCH,
                  long_ctx + [1] * (MAX_BATCH - len(long_ctx)), 1, page, pages, False)
    page_scores = scores.reshape(1, LONG_CHUNK, pages, page).amax(-1)
    pos_sel = mp.select_prefill_pages(page_scores, lq, lk, cq=64, page_size=page,
                                      num_sel=DSA_PAGES)
    r9b = check_block_sparse(gen, "2048-row chunk at context 4096, pages from K10", CFG.num_heads,
                             page, [LONG_CHUNK], [2 * LONG_CHUNK], pages, pos_sel, 64, True)
    r9b8 = check_block_sparse(gen, "2048-row chunk at context 4096, pages from K10",
                              CFG.num_heads, page, [LONG_CHUNK], [2 * LONG_CHUNK], pages, pos_sel,
                              64, True, int8=True)
    small = torch.tensor([[[3, 2, 1, 0], [3, -1, 0, -1]], [[1, -1, -1, 1], [-1, -1, -1, -1]]],
                         dtype=torch.int32, device=DEV)
    for int8 in (False, True):
        check_block_sparse(gen, "small (dead slots, dead page first, straddling chunk)",
                           CFG.num_heads, 16, [16, 5], [60, 17], 4, small, 8, False, int8)
        check_block_sparse(gen, "small at 64 heads (a model with fewer heads)", 64, 16,
                           [16, 5], [60, 17], 4, small, 8, False, int8)
    return r10, r9b, r9b8


def check_quant_matmul(gen, label, w, ds, bias, m, out_dtype=torch.float32, timed=False):
    """K1 at ``w [N, K]`` (a path weight or a random one) on ``m`` random int8
    rows: exact equality in f32 and bf16 out (exact integer sums, the same f32
    epilogue).  Timed: the kernel, its plain version, and ``torch._int_mm``
    (cuBLASLt int8 -> int32, rows padded to 32 as it refuses 16 or fewer; its
    epilogue, + bias and x descale, is not timed)."""
    n, k = w.shape
    x = torch.randint(-128, 128, (m, k), generator=gen, device=DEV, dtype=torch.int8)
    got = matmul.quant_matmul(x, w, ds, bias, out_dtype=out_dtype)
    want = matmul.quant_matmul_ref(x, w, ds, bias, out_dtype=out_dtype)
    torch.cuda.synchronize()
    err = max_abs(got, want)
    log(f"  quant_matmul {label}: M={m} N={n} K={k} bias={bias is not None} "
        f"out={str(out_dtype)[6:]}: max|err| {err:.3e} (tol 0: exact)")
    if err != 0:
        raise AssertionError(f"quant_matmul disagrees with its plain version: {err}")
    if not timed:
        return None
    r = dict(err=err,
             ms=time_ms(lambda: matmul.quant_matmul(x, w, ds, bias, out_dtype=out_dtype), 50),
             plain_ms=time_ms(lambda: matmul.quant_matmul_ref(x, w, ds, bias,
                                                              out_dtype=out_dtype), 5))
    xp = torch.zeros((max(32, -(-m // 8) * 8), k), dtype=torch.int8, device=DEV)
    xp[:m] = x
    wt = w.t()
    r["library_ms"] = time_ms(lambda: torch._int_mm(xp, wt), 50)
    nbytes = (m * k + n * k + 4 * n + (0 if bias is None else 4 * n)
              + m * n * got.element_size())
    r["bound_ms"], r["bound_by"] = bound(nbytes, 2 * m * n * k, INT8_OPS)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, torch._int_mm {r['library_ms']:.4f}, "
        f"bound {r['bound_ms']:.4f} {r['bound_by']})")
    return r


def check_quant_per_token(gen, rows, hidden, timed, dtype=torch.bfloat16):
    """K5 on ``[rows, hidden]`` with a zero row: q and the scales bit-equal to
    its plain version (the row's max does not depend on the order; IEEE
    division, round half to even, saturate)."""
    x = randn(gen, (rows, hidden), dtype, scale=3.0)
    x[rows // 2] = 0
    q, s = quant.quant_per_token(x)
    q_p, s_p = quant.quant_per_token_ref(x)
    torch.cuda.synchronize()
    err = max_abs(q, q_p)
    same = bool(torch.equal(q, q_p) and torch.equal(s, s_p))
    log(f"  quant_per_token [{rows}, {hidden}] {str(dtype)[6:]}, zero row "
        f"({row_reduce.launch_plan(x, q)}): q and scales bit-equal to plain {same} (max|q err| "
        f"{err:.0f} level)")
    if not same:
        raise AssertionError(f"quant_per_token disagrees with its plain version: {err}")
    if not timed:
        return None
    r = dict(err=err, ms=time_ms(lambda: quant.quant_per_token(x), 50),
             plain_ms=time_ms(lambda: quant.quant_per_token_ref(x), 20), library_ms=None)
    r["bound_ms"], r["bound_by"] = bound(
        (x.element_size() + 1) * rows * hidden + 4 * rows, 4 * rows * hidden, F32_FLOPS)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} "
        f"{r['bound_by']})")
    return r


def check_swiglu_quant(gen, rows, width, group, timed):
    """K7a on bf16 ``[rows, width]`` (gate || up) with a zero row and, for a
    group list, rows past its total: int8 within one level (the SiLU's exp
    differs by ulps), scales rtol 1e-6, zero rows scale 0."""
    x = randn(gen, (rows, width), scale=2.0)
    x[0] = 0
    gl = None if group is None else torch.tensor([2, 0, rows - 5], dtype=torch.int32,
                                                 device=DEV)
    kw = dict(group_list_type=1)
    q, s = activation.swiglu_quant(x, gl, **kw)
    q_p, s_p = activation.swiglu_quant_ref(x, gl, **kw)
    torch.cuda.synchronize()
    live = rows if gl is None else rows - 3
    err = max_abs(q, q_p)
    rel = float(((s[1:live] - s_p[1:live]).abs() / s_p[1:live]).max())
    log(f"  swiglu_quant [{rows}, {width}] bf16, group_list {None if gl is None else 'type 1'}"
        f" ({live} live rows, row 0 zero): max|q err| {err:.0f} level (tol 1), scale rel err "
        f"{rel:.2e} (tol 1e-6)")
    if not (err <= 1 and rel <= 1e-6 and float(s[0]) == 0 and not s[live:].any()
            and not q[live:].any()):
        raise AssertionError(f"swiglu_quant disagrees with its plain version: {err}, {rel}")
    if not timed:
        return None
    r = dict(err=err, ms=time_ms(lambda: activation.swiglu_quant(x, gl, **kw), 50),
             plain_ms=time_ms(lambda: activation.swiglu_quant_ref(x, gl, **kw), 20),
             library_ms=None)
    r["bound_ms"], r["bound_by"] = bound(2 * rows * width + rows * width // 2 + 4 * rows,
                                         8 * rows * width // 2, F32_FLOPS)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} "
        f"{r['bound_by']})")
    return r


def summed(label, rows):
    """One JSON row for a kernel called several times a layer: the sums of
    the calls' times and bounds, the largest error."""
    out = dict(err=max(r["err"] for r in rows),
               ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
               bound_ms=sum(r["bound_ms"] for r in rows),
               bound_by="/".join(sorted({r["bound_by"] for r in rows})))
    libs = [r["library_ms"] for r in rows]
    out["library_ms"] = None if None in libs else sum(libs)
    log(f"  {label}: {out['ms']:.4f} ms (plain {out['plain_ms']:.4f}, library "
        f"{out['library_ms']}, bound {out['bound_ms']:.4f} {out['bound_by']})")
    return out


def check_w8a8_kernels(gen, mla_wq, dense_wq):
    """K1, K5 and K7a at the shapes one layer of the fully W8A8 path gives
    them at decode (8 rows), ``wo`` also at a prefill chunk's 64 rows, K1's
    ``wdqkv`` and ``wuq`` at a long chunk's 2048 rows, and ragged cases
    (K1 at 17, 65 and 2047 rows, untimed).  Returns the JSON rows
    (per-layer sums at decode)."""
    mw, dq = mla_wq[0], dense_wq[0]
    gemms = [("wdqkv", mw.wdqkv, mw.descale1, mw.bias1), ("wuq", mw.wuq, mw.descale2, mw.bias2),
             ("wo", *dq["wo"], None), ("ws_gate_up", *dq["ws_gate_up"], None),
             ("ws_down", *dq["ws_down"], None)]
    k1 = [check_quant_matmul(gen, name, w, ds, b, MAX_BATCH, timed=True)
          for name, w, ds, b in gemms]
    check_quant_matmul(gen, "wo (prefill chunk)", *dq["wo"], None, PREFILL_CHUNK, timed=True)
    # the fused prologue's two at a long prefill chunk ([4c] / [4d]), on the
    # wgmma path; then its ragged row counts (a tile of 17 rows, one row past a
    # warpgroup's 64, one short of 16 tiles)
    summed(f"quant_matmul, the prologue's wdqkv + wuq at {LONG_CHUNK} rows",
           [check_quant_matmul(gen, f"{name} (long prefill chunk)", w, ds, b, LONG_CHUNK,
                               timed=True) for name, w, ds, b in gemms[:2]])
    for rows, (name, w, ds, b) in ((17, gemms[0]), (65, gemms[1]), (LONG_CHUNK - 1, gemms[0])):
        check_quant_matmul(gen, name, w, ds, b, rows, torch.bfloat16)
    pad = torch.zeros((64, mw.wdqkv.shape[1]), dtype=torch.int8, device=DEV)
    check_quant_matmul(gen, "wdqkv lane-padded (the JAX layout)",
                       torch.cat([mw.wdqkv, pad]), torch.cat([mw.descale1, mw.descale1[:64]]),
                       torch.cat([mw.bias1, mw.bias1[:64]]), MAX_BATCH)
    w_small = torch.randint(-128, 128, (100, 64), generator=gen, device=DEV, dtype=torch.int8)
    ds_small = torch.rand(100, generator=gen, device=DEV) / 1000
    b_small = torch.randint(-1000, 1000, (100,), generator=gen, device=DEV, dtype=torch.int32)
    for b in (None, b_small):
        for dt in (torch.float32, torch.bfloat16):
            check_quant_matmul(gen, "small ragged", w_small, ds_small, b, 1, dt)
    k5 = [check_quant_per_token(gen, MAX_BATCH, h, True)
          for h in (dq["wo"][0].shape[1], dq["ws_gate_up"][0].shape[1])]
    # K5 as the expert-parallel wire quant ([4k]'s 64-token chunk) and at a
    # long chunk's rows; f32 rows, and a width that takes the element path
    for rows in (PREFILL_CHUNK, LONG_CHUNK):
        check_quant_per_token(gen, rows, CFG.hidden, True)
    check_quant_per_token(gen, MAX_BATCH, dq["wo"][0].shape[1], False, torch.float32)
    check_quant_per_token(gen, 3, 100, False)
    k7 = check_swiglu_quant(gen, MAX_BATCH, dq["ws_gate_up"][0].shape[0], None, True)
    check_swiglu_quant(gen, MAX_BATCH, dq["ws_gate_up"][0].shape[0], 1, False)
    return (summed("quant_matmul, a layer's 5 GEMMs at decode", k1),
            summed("quant_per_token, a layer's 2 calls at decode", k5), k7)


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

class StepTimer:
    """Wall time and count of the adapter's prefill, decode and lm_head calls
    (synchronized)."""

    def __init__(self, adapter):
        self.t = {"prefill": 0.0, "decode": 0.0, "lm_head": 0.0}
        self.calls = {"prefill": 0, "decode": 0, "lm_head": 0}
        for name, attr in (("prefill", "prefill_step"), ("decode", "decode_step"),
                           ("lm_head", "lm_head")):
            setattr(adapter, attr, self._wrap(name, getattr(adapter, attr)))

    def _wrap(self, name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.t[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out
        return run


def prompts(gen, lens=PROMPT_LENS, share=(1, SHARED_PREFIX), vocab=CFG.vocab_size):
    """Random prompts of ``lens`` tokens; the last shares its first ``share[1]``
    tokens with prompt ``share[0]``."""
    ids = [torch.randint(0, vocab, (n,), generator=gen).tolist() for n in lens]
    i, n = share
    ids[-1][:n] = ids[i][:n]
    return ids


def serve(params, moe, mla_wq=None, *, cfg=CFG, ps=None, share=(1, SHARED_PREFIX),
          chunk=PREFILL_CHUNK, num_pages=NUM_PAGES, pages_per_req=MAX_PAGES_PER_REQ):
    """Serve the prompts ``ps`` (the 6-request mix by default) through
    ``Engine(prefill_chunk=chunk)``; with ``mla_wq`` through the fused W8A8
    prologue, on ``cfg``'s latent cache.  The last prompt shares a prefix with
    prompt ``share[0]`` and arrives once that one is through prefill, so its
    admission finds the shared pages in the radix cache.  Checks outputs,
    page release, radix reuse, the cache type and the launch counts: every
    MoE of a prefill call runs K8a when the chunk is above 512 tokens, the
    ring GEMMs otherwise; K2 runs once a layer a decode step; under DSA in
    page mode every prefill call runs K10 and K9b once a layer and K9a
    never, and the index-key cache exists.  Returns the engine, the prompts
    and the counts."""
    adapter = deepseek_adapter(cfg, params, torch.bfloat16, moe_weights_q=moe, mla_wq=mla_wq)
    timer = StepTimer(adapter)
    eng = Engine(adapter, num_pages, max_batch=MAX_BATCH, max_pages_per_req=pages_per_req,
                 prefill_chunk=chunk)
    want_nope = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    if eng.caches[0]["nope"].dtype != want_nope:
        raise AssertionError(f"the latent cache is {eng.caches[0]['nope'].dtype}, not {want_nope}")
    dsa = cfg.sparse_count > 0
    if dsa != ("kidx" in eng.caches[0]):
        raise AssertionError(f"index-key cache present: {'kidx' in eng.caches[0]}, DSA: {dsa}")
    ps = ps or prompts(torch.Generator().manual_seed(SEED))
    rids, wall, launches = run_requests(eng, ps, share, num_pages, CFG.vocab_size)
    long = chunk > 512
    prefill_attn = DSA_KERNELS if dsa else ("mla_prefill_pallas",)
    expected = (("decode_mla", "gmm1_ring", "gmm2_combine_ring") + prefill_attn
                + (() if mla_wq is None else ("quant_matmul",))
                + (("grouped_matmul",) if long else ()))
    missing = [k for k in expected if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    n_pre, n_dec = timer.calls["prefill"], timer.calls["decode"]
    layers = cfg.num_layers
    want = {"quant_matmul": 0 if mla_wq is None else 2 * layers * (n_pre + n_dec),
            "grouped_matmul": 2 * layers * n_pre if long else 0,
            "gmm1_ring": layers * (n_dec + (0 if long else n_pre)),
            "decode_mla": layers * n_dec,
            "mla_prefill_pallas": 0 if dsa else layers * n_pre,
            **{k: layers * n_pre if dsa else 0 for k in DSA_KERNELS}}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"launches {launches} over {n_pre} prefill and {n_dec} decode "
                             f"calls; want {want}")
    dec_tokens = len(rids) * (NEW_TOKENS - 1)      # the first token comes from prefill
    eng.rates = (eng.stats["prefill_tokens"] / timer.t["prefill"], dec_tokens / timer.t["decode"])
    log(f"  served {len(rids)} requests (prompts {[len(p) for p in ps]}, {NEW_TOKENS} new tokens "
        f"each, {cfg.kv_cache_dtype} latent cache{', DSA' if dsa else ''}) in {wall:.2f} s "
        f"wall; prefill "
        f"{eng.stats['prefill_tokens']} tokens in {n_pre} calls of {chunk} rows, "
        f"{timer.t['prefill']:.3f} s = {eng.stats['prefill_tokens'] / timer.t['prefill']:.1f} "
        f"tok/s; decode {dec_tokens} tokens in {n_dec} steps, "
        f"{timer.t['decode']:.3f} s = {dec_tokens / timer.t['decode']:.1f} tok/s; "
        f"radix cached tokens {eng.stats['cached_tokens']}; all pages returned")
    log(f"  launches on the main path: {json.dumps(launches)}")
    return eng, ps, launches


def run_requests(eng, ps, share, num_pages, vocab, reuse: bool = True):
    """Serve ``ps`` through ``eng``, 16 new tokens each, the last prompt
    arriving once prompt ``share[0]`` is through prefill (so its admission
    finds their ``share[1]`` shared tokens in the radix cache), with the
    launch counts reset just before and read just after.  Checks that every
    request finished with valid tokens, every page came back and the prefix
    was reused (``reuse=False``: that no prefix was matched, as an adapter
    that prefills whole prompts does).  Returns the request ids, the wall
    time and the counts."""
    counters.reset()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, NEW_TOKENS) for p in ps[:-1]]
    first = rids[share[0]]
    while not any(r.rid == first and r.pos >= r.prompt_len for r in eng.running) \
            and first not in eng.finished:
        eng.step()
    rids.append(eng.add_request(ps[-1], NEW_TOKENS))
    while eng.waiting or eng.running:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    outs = [eng.finished[r] for r in rids]
    if not all(len(o) == NEW_TOKENS and all(0 <= t < vocab for t in o) for o in outs):
        raise AssertionError(f"unfinished or invalid outputs: {[len(o) for o in outs]}")
    if eng.cm.free_pages + eng.cm.cached_pages != num_pages:
        raise AssertionError("KV pages leaked")
    if reuse and eng.stats["cached_tokens"] < share[1]:
        raise AssertionError(f"radix reuse missed: {eng.stats['cached_tokens']} cached tokens")
    if not reuse and eng.stats["cached_tokens"]:
        raise AssertionError(f"{eng.stats['cached_tokens']} tokens matched in the radix by an "
                             "engine that takes no prefix")
    return rids, wall, launches


class Record(list):
    """A model call's discrete choices: each layer's routing ``(ids,
    weights)`` (the list) and each DSA selection (``.sel``: pages of the
    prefill chunks or decode rows, or tokens); where asked, each layer's
    router selection scores (``.scores``, :func:`router_choice`)."""

    def __init__(self):
        super().__init__()
        self.sel = []
        self.scores = []


def router_choice(cfg, lw, x):
    """A router's selection scores ``[n, E]`` in f32: DeepSeek-V3's
    ``sigmoid(x W) + bias``, what ``models/deepseek_v3._router`` ranks (by
    group, then by expert) before it masks the groups; Qwen3-Next's softmax
    over all experts (a layer with ``moe_router``), what
    ``models/qwen3_next._router`` takes the top-k of."""
    if "moe_router" in lw:
        return torch.softmax((x @ lw["moe_router"]).float(), dim=-1)
    return torch.sigmoid(x.float() @ lw["router"].float()) + lw["router_bias"].float()[None, :]


def with_routes(fn, forced=None, model=m, scores=False):
    """Run ``fn()`` recording each layer's routing and DSA selection →
    ``(fn(), record)``.  With ``forced`` (another run's :class:`Record`) the
    router and the selection hand out that run's choices, layer by layer,
    instead of choosing (``model._router`` / ``_selected``: DeepSeek's by
    default; GPT-OSS has a router only).  ``scores``: also record each
    layer's :func:`router_choice` (DeepSeek-V3's router)."""
    record, router = Record(), model._router
    selected = getattr(model, "_selected", None)
    replay = None if forced is None else iter(forced)
    replay_sel = None if forced is None else iter(forced.sel)

    def recording_router(cfg, lw, x):
        ids, w = router(cfg, lw, x) if replay is None else next(replay)
        record.append((ids, w))
        if scores:
            record.scores.append(router_choice(cfg, lw, x))
        return ids, w

    def recording_selected(sel):
        sel = sel if replay_sel is None else next(replay_sel)
        record.sel.append(sel)
        return sel

    model._router = recording_router
    if selected is not None:
        model._selected = recording_selected
    try:
        return fn(), record
    finally:
        model._router = router
        if selected is not None:
            model._selected = selected


def same_routing(rec_a, rec_b, n):
    """Which of the first ``n`` rows chose the same expert set in every layer."""
    def ids(r):
        return torch.sort(r[0][:n], dim=-1).values
    return torch.stack([(ids(a) == ids(b)).all(-1) for a, b in zip(rec_a, rec_b)]).all(0)


def routing_rule(label, got, want, same, logits: bool, *, forced: bool = False,
                 vs: str = "plain versions"):
    """Kernels vs plain versions on one model call, rows relative to their
    largest value (tol 5e-2: bf16 activations, int8 requant flips); on
    logits, top-1 must agree wherever the top-2 margin exceeds twice the
    row's error.  Routing is discrete: a row whose top-k expert set differs
    between the two runs in any layer (a near-tie moved by one bf16 rounding
    or one int8 level) takes other experts and moves by far more than
    rounding.  Without ``forced`` the check compares the rows whose routing
    agrees in every layer (``same``), and at least half must be such rows.
    With ``forced`` the plain run took the kernel run's routing (expert ids
    and weights) layer by layer, so every row is compared; ``same`` then
    counts the rows whose own choice agreed, which is reported only.
    ``same`` None: a model without routing, every row compared."""
    n = got.shape[0]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: kernel-path output is not finite")
    routed = same is not None
    forced = forced or not routed
    same = same if routed else torch.ones(n, dtype=torch.bool, device=got.device)
    cmp = torch.ones_like(same) if forced else same
    err_row = (got - want).abs().amax(-1)
    rel_row = err_row / want.abs().amax(-1)
    rel_cmp = float(rel_row[cmp].max()) if bool(cmp.any()) else float("nan")
    tol = 5e-2
    rows = ("every row (no routing)" if not routed else "every row (routing replayed)" if forced
            else "the routing-agreeing rows")
    msg = (f"  {label} on {n} rows, kernels vs {vs}: "
           + (f"routing agrees in every layer on {int(same.sum())}/{n} rows; " if routed else "")
           + f"on {rows}, max rel err {rel_cmp:.3e} (tol {tol}); "
           f"all rows {float(rel_row.max()):.3e}")
    ok = (forced or 2 * int(same.sum()) >= n) and rel_cmp <= tol
    if logits:
        top2 = torch.topk(want, 2, dim=-1).values
        clear = cmp & ((top2[:, 0] - top2[:, 1]) > 2 * err_row)
        agree = got.argmax(-1) == want.argmax(-1)
        msg += (f"; top-1 agrees on {int(agree.sum())}/{n} rows, required on the "
                f"{int(clear.sum())} compared rows whose top-2 margin exceeds 2x their error")
        ok = ok and bool(agree[clear].all())
    log(msg)
    return ok


def compare_runs(label, run_kernel, run_plain, n, *, logits: bool, forced: bool, model=m,
                 vs: str = "plain versions", after_kernel=lambda: None):
    """Run one model call through the kernels and through the plain versions
    (each run writes the same KV rows itself before it reads) and hold them
    to :func:`routing_rule`; with ``forced`` the plain versions run a second
    time on the kernel run's routing.  ``after_kernel()`` runs between the
    kernel run and the plain ones.  Returns whether the rule held."""
    got, rec_k = with_routes(lambda: run_kernel()[:n].float(), model=model)
    after_kernel()
    want, rec_p = with_routes(lambda: run_plain()[:n].float(), model=model)
    if got.shape != want.shape:
        raise AssertionError(f"{label}: kernel path {tuple(got.shape)} vs plain "
                             f"{tuple(want.shape)}")
    same = same_routing(rec_k, rec_p, n)
    if forced:
        want, _ = with_routes(lambda: run_plain()[:n].float(), rec_k, model=model)
    return routing_rule(label, got, want, same, logits, forced=forced, vs=vs)


def live_batch(eng, ps, lora_ids=None):
    """Re-admit the prompts (prefixes from the radix cache; with ``lora_ids``
    each under its adapter) and prefill them: a decode batch of live rows."""
    for i, p in enumerate(ps):
        eng.add_request(p, 32, lora_id=lora_ids[i] if lora_ids else 0)
    while any(r.pos < r.prompt_len for r in eng.running) or eng.waiting:
        eng.step()
    live = [r for r in eng.running if not r.done]
    return eng.decode_inputs(live), len(live)


def decode_step_fn(params, moe, cfg=CFG, **kw):
    return lambda x, pos, c, bt, ctx, slots, state_idx, lora_idx: m.decode_step(
        cfg, params, x, pos, c, bt, ctx, slots, moe_weights_q=moe, **kw)


def compare_plain_decode(eng, ps, params, moe, mla_wq=None):
    """One decode step on a live batch through the engine's own switches,
    through the kernels and through the plain versions; logits held to
    :func:`routing_rule` with the routing replayed (the plain run takes the
    kernel run's expert choices, so every row is compared; the count of rows
    whose own routing agreed is printed as a figure)."""
    batch, n = live_batch(eng, ps)
    ok = compare_runs(
        "decode step" + (" (fused W8A8 prologue)" if mla_wq else ""),
        lambda: eng.decode_logits(batch),
        lambda: eng.decode_logits(batch, decode_step_fn(params, moe, mla_wq=mla_wq,
                                                        plain=True)),
        n, logits=True, forced=True)
    if not ok:
        raise AssertionError("kernel decode disagrees with the plain path")
    return batch, n


@contextlib.contextmanager
def swapped(module, swaps: dict):
    """``module``'s names in ``swaps`` bound to the functions given there,
    the old bindings restored on exit."""
    old = {name: getattr(module, name) for name in swaps}
    for name, fn in swaps.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in old.items():
            setattr(module, name, fn)


def base_kernels():
    """The plain path with the attention kernels (K2, K9a, and DSA's K10 and
    K9b) and the ring GEMMs (K3, K4) in place of their plain versions: only
    K1, K5, K7a and K8a stay plain."""
    return swapped(m, {"decode_mla_ref": m.decode_mla, "mla_prefill_ref": m.mla_prefill_pallas,
                       "gmm1_ring_ref": m.gmm1_ring, "gmm2_combine_ring_ref": m.gmm2_combine_ring,
                       "lightning_indexer_scores_prefill_ref":
                           m.lightning_indexer_scores_prefill_pallas,
                       "mla_prefill_block_sparse_ref": m.mla_prefill_block_sparse})


def llama_base_kernels():
    """Llama's plain path with K11a, K12d, K6a and K13a in place of their
    plain versions: only K1, K5 and K7a stay plain."""
    return swapped(lm, {"decode_gqa_plain": lm.decode_gqa,
                        "attention_sinks_prefill_plain": lm.attention_sinks_prefill_pallas,
                        "rms_norm_ref": lm.rms_norm, "bgmv_fused_plain": lora_pallas.bgmv_fused})


def w8a8_rule(label, kernel_run, run_plain, n, logits: bool, plain_set="K1, K5 and K7a"):
    """A W8A8 call through the kernels (``kernel_run``: its output and
    routing record) against its plain versions, the routing replayed.  This
    layer's int8 steps (a static per-tensor quant before each prologue GEMM,
    five requantizations a layer) turn rounding-level differences upstream
    into whole int8 levels: the attention kernels and ring GEMMs differ from
    their plain versions by bf16 rounding and f32 summation order, and the
    plain path itself moves by several percent when they replace their plain
    versions.  So two rules, row by row, relative to each row's
    largest value:
    - against the path with only ``plain_set`` plain (K1, K5, K7a, K8a):
      within 1e-2 (K1 is exact, K8a's dequant does the same f32 operations,
      and the plain K5 / K7a / K8a requant do the same IEEE operations), and
      on logits top-1 equal wherever the top-2 margin exceeds twice the
      row's error;
    - against the all-plain path: no further than that path itself moves
      when the attention kernels and ring GEMMs replace their plain
      versions, + 1e-2; and that move itself at most 1e-1 (the rounding
      above moves it by a few percent, a wrong kernel by the order of the
      values).  Phase [3] holds those kernels to their plain versions
      directly at the shapes these calls give them.
    Returns whether both held."""
    got, rec_k = kernel_run
    _, rec_p = with_routes(lambda: run_plain()[:n].float())
    same = same_routing(rec_k, rec_p, n)
    want, _ = with_routes(lambda: run_plain()[:n].float(), rec_k)
    with base_kernels():
        want_base, _ = with_routes(lambda: run_plain()[:n].float(), rec_k)
    routing = (f"routing agrees in every layer on {int(same.sum())}/{n} rows on its own, "
               f"replayed for the comparisons; ")
    return w8a8_verdict(label, got, want, want_base, n, logits, plain_set, routing)


def w8a8_verdict(label, got, want, want_base, n, logits: bool, plain_set: str, routing=""):
    """:func:`w8a8_rule`'s two rules on a kernel run ``got``, the all-plain
    run ``want`` and the run with only ``plain_set`` plain (``want_base``)."""
    if not (got.shape == want.shape == want_base.shape and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{label}: kernel-path output mis-shaped or not finite")

    def rel(a, b):
        return (a - b).abs().amax(-1) / b.abs().amax(-1)

    rel_new, rel_plain, base_move = rel(got, want_base), rel(got, want), rel(want_base, want)
    ok = (bool((rel_new <= 1e-2).all()) and bool((rel_plain <= base_move + 1e-2).all())
          and float(base_move.max()) <= 1e-1)
    msg = (f"  {label} on {n} rows: {routing}vs {plain_set} plain: max rel "
           f"err {float(rel_new.max()):.3e} (tol 1e-2); vs all plain: "
           f"{float(rel_plain.max()):.3e}, where the other kernels alone "
           f"move the plain path by {float(base_move.max()):.3e} (tol 1e-1; the former: that "
           f"+ 1e-2, row by row)")
    if logits:
        err_row = (got - want_base).abs().amax(-1)
        top2 = torch.topk(want_base, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * err_row
        agree = got.argmax(-1) == want_base.argmax(-1)
        msg += (f"; top-1 agrees on {int(agree.sum())}/{n} rows, required on the "
                f"{int(clear.sum())} rows whose top-2 margin exceeds 2x their error")
        ok = ok and bool(agree[clear].all())
    log(msg)
    return ok


def fully_w8a8(eng, batch, n, params, moe, mla_wq, dense_wq, ps):
    """Phase 4b: the fully W8A8 layer through ``decode_step`` on the engine's
    live batch and ``prefill_step`` on one 64-token chunk (the second chunk of
    a 128-token prompt, at context 128), held to :func:`w8a8_rule`.  Launch
    counts are reset just before the two kernel runs and read just after,
    before any comparison run."""
    kw = dict(mla_wq=mla_wq, dense_wq=dense_wq)
    pages = eng.cm.alloc(-(-2 * PREFILL_CHUNK // CFG.page_size))
    ids = torch.tensor(ps[3][:2 * PREFILL_CHUNK], dtype=torch.int32, device=DEV)
    bt = torch.zeros((1, MAX_PAGES_PER_REQ), dtype=torch.int32, device=DEV)
    bt[0, : len(pages)] = torch.tensor([int(p) for p in pages], dtype=torch.int32)
    pos = torch.arange(2 * PREFILL_CHUNK, device=DEV)
    slots = (bt[0, pos // CFG.page_size] * CFG.page_size + pos % CFG.page_size).to(torch.int32)
    sl = torch.tensor([PREFILL_CHUNK], dtype=torch.int32, device=DEV)

    def chunk(c, plain):
        rows = slice(c * PREFILL_CHUNK, (c + 1) * PREFILL_CHUNK)
        ctx = torch.tensor([(c + 1) * PREFILL_CHUNK], dtype=torch.int32, device=DEV)
        h, _ = m.prefill_step(CFG, params, m.embed(params, ids[rows]), sl, eng.caches, bt, ctx,
                              slots[rows], max_q=PREFILL_CHUNK, moe_weights_q=moe,
                              plain=plain, **kw)
        return h

    def decode(plain):
        return eng.decode_logits(batch, decode_step_fn(params, moe, plain=plain, **kw))

    chunk(0, False)                                 # the chunk's context, written once
    counters.reset()
    dec_k = with_routes(lambda: decode(False)[:n].float())
    pre_k = with_routes(lambda: chunk(1, False).float())
    torch.cuda.synchronize()
    launches = counters.read()
    log(f"  launches on the fully W8A8 path (1 decode step + 1 prefill chunk): "
        f"{json.dumps(launches)}")
    ok_d = w8a8_rule("fully W8A8 decode step (logits)", dec_k, lambda: decode(True), n, True)
    ok_p = w8a8_rule("fully W8A8 prefill chunk (hidden)", pre_k, lambda: chunk(1, True),
                     PREFILL_CHUNK, False)
    eng.cm.free(pages)
    if not (ok_d and ok_p):
        raise AssertionError("the fully W8A8 kernels disagree with the plain path")
    missing = [k for k in BASE_KERNELS + ("quant_matmul", "quant_per_token", "swiglu_quant")
               if launches[k] == 0]
    if missing or launches["grouped_matmul"]:
        raise AssertionError(f"kernels never launched on the fully W8A8 path: {missing} (or "
                             f"grouped_matmul at {PREFILL_CHUNK} rows: {launches})")
    layers = CFG.num_layers
    want_counts = {"quant_matmul": 2 * 5 * layers, "quant_per_token": 2 * 2 * layers,
                   "swiglu_quant": 2 * layers}
    if any(launches[k] != v for k, v in want_counts.items()):
        raise AssertionError(f"W8A8 launches {launches} are not {want_counts}")
    return launches


def long_prompt_checks(eng, params, moe, mla_wq8, ps, cfg=CFG_INT8):
    """Phase [4c] (and, on ``CFG_DSA``, [4d]) continued: one decode step on a
    live batch of the long prompts and one 2048-row prefill chunk at context
    4096 (the second chunk of a 4096-token sequence; the plain attention at
    2048 x 4096 x 128 heads in f32 takes ~13 GB), through the kernels and
    through the plain versions, the routing (and DSA's page selections)
    replayed, held to :func:`w8a8_rule` with K1 and K8a plain.  Returns the
    kernel-path chunk and decode step for the profile, and the live batch."""
    dsa = cfg.sparse_count > 0
    what = "DSA " if dsa else "long-prompt "
    batch, n = live_batch(eng, ps)
    counters.reset()
    dec_k = with_routes(lambda: eng.decode_logits(batch)[:n].float())
    torch.cuda.synchronize()
    dec_launches = counters.read()
    ok_d = w8a8_rule(
        f"{what}decode step, int8 cache (logits)", dec_k,
        lambda: eng.decode_logits(batch, decode_step_fn(params, moe, cfg=cfg,
                                                        mla_wq=mla_wq8, plain=True)),
        n, True, plain_set="K1")
    if dsa:
        pruned = [int(((s_.long() * cfg.page_size) < sl).sum()) for s_, sl in
                  zip(dec_k[1].sel[0], batch.ctx.tolist())]
        log(f"  that decode step: launches {json.dumps(dec_launches)}; layer 0's rows attend "
            f"{pruned} pages of contexts {batch.ctx.tolist()[:n]} (replayed in the plain runs)")
        if dec_launches["decode_mla"] != cfg.num_layers or any(
                dec_launches[k] for k in DSA_KERNELS + ("mla_prefill_pallas",)):
            raise AssertionError(f"DSA decode step launches: {dec_launches}")
    seq = (ps[2] + ps[3])[: 2 * LONG_CHUNK]
    pages = eng.cm.alloc(-(-2 * LONG_CHUNK // CFG.page_size))
    ids = torch.tensor(seq, dtype=torch.int32, device=DEV)
    bt = torch.zeros((1, LONG_PAGES_PER_REQ), dtype=torch.int32, device=DEV)
    bt[0, : len(pages)] = torch.tensor([int(p) for p in pages], dtype=torch.int32)
    pos = torch.arange(2 * LONG_CHUNK, device=DEV)
    slots = (bt[0, pos // CFG.page_size] * CFG.page_size + pos % CFG.page_size).to(torch.int32)
    sl = torch.tensor([LONG_CHUNK], dtype=torch.int32, device=DEV)

    def chunk(c, plain):
        rows = slice(c * LONG_CHUNK, (c + 1) * LONG_CHUNK)
        ctx = torch.tensor([(c + 1) * LONG_CHUNK], dtype=torch.int32, device=DEV)
        h, _ = m.prefill_step(cfg, params, m.embed(params, ids[rows]), sl, eng.caches, bt,
                              ctx, slots[rows], max_q=LONG_CHUNK, moe_weights_q=moe,
                              mla_wq=mla_wq8, plain=plain)
        return h

    chunk(0, False)                                 # the chunk's context, written once
    counters.reset()
    pre_k = with_routes(lambda: chunk(1, False).float())
    torch.cuda.synchronize()
    launches = counters.read()
    ok_p = w8a8_rule(f"{what}prefill chunk of {LONG_CHUNK} rows at context "
                     f"{2 * LONG_CHUNK}, int8 cache (hidden)", pre_k, lambda: chunk(1, True),
                     LONG_CHUNK, False, plain_set="K1 and K8a")
    log(f"  launches in that {LONG_CHUNK}-row prefill chunk: {json.dumps(launches)}")
    if not (ok_d and ok_p):
        raise AssertionError(f"the {what}kernels disagree with the plain path")
    layers = cfg.num_layers
    want = {"grouped_matmul": 2 * layers, "mla_prefill_pallas": 0 if dsa else layers,
            **{k: layers if dsa else 0 for k in DSA_KERNELS}}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"the {LONG_CHUNK}-row chunk's launches {launches}; want {want}")
    if dsa:
        pos_sel, cq = pre_k[1].sel[0][0], 64
        live = (pos_sel >= 0).sum(-1)
        causal = [(LONG_CHUNK + (c + 1) * cq - 1) // cfg.page_size + 1
                  for c in range(pos_sel.shape[0])]
        log(f"  its {pos_sel.shape[0]} chunks attend {int(live.min())}-{int(live.max())} pages "
            f"of their {min(causal)}-{max(causal)} causal ones (layer 0; replayed in the plain "
            f"runs)")
    return (lambda: chunk(1, False)), (lambda: eng.decode_logits(batch)), batch, n


def dsa_serve(params, moe, mla_wq8, ps):
    """Phase [4d]: :func:`serve` on ``CFG_DSA`` with [4c]'s prompts, every
    page selection recorded (``select_prefill_pages`` /
    ``select_decode_pages`` wrapped, the model looks them up at each call).
    Pruning must have happened: at least one prefill chunk and one decode
    row attended fewer pages than their causal range.  Returns the engine and
    the launch counts."""
    seen = {"prefill": [], "decode": []}
    select_p, select_d = m.select_prefill_pages, m.select_decode_pages

    def prefill_pages(page_scores, seq_lens, context_lens, *, cq, page_size, num_sel):
        out = select_p(page_scores, seq_lens, context_lens, cq=cq, page_size=page_size,
                       num_sel=num_sel)
        seen["prefill"].append((seq_lens, context_lens, cq, out))
        return out

    def decode_pages(scores, seq_lens, page_size, num_sel):
        out = select_d(scores, seq_lens, page_size, num_sel)
        seen["decode"].append((seq_lens, out))
        return out

    m.select_prefill_pages, m.select_decode_pages = prefill_pages, decode_pages
    try:
        eng, _, launches = serve(params, moe, mla_wq8, cfg=CFG_DSA, ps=ps, share=(0, LONG_SHARED),
                                 chunk=LONG_CHUNK, num_pages=LONG_NUM_PAGES,
                                 pages_per_req=LONG_PAGES_PER_REQ)
    finally:
        m.select_prefill_pages, m.select_decode_pages = select_p, select_d
    page = CFG_DSA.page_size
    chunks = pruned_chunks = 0
    for seq_lens, ctx_lens, cq, pos_sel in seen["prefill"]:
        for b, (sl, cl) in enumerate(zip(seq_lens.tolist(), ctx_lens.tolist())):
            for qc in range(-(-sl // cq)):
                causal = (cl - sl + min((qc + 1) * cq, sl) - 1) // page + 1
                attended = int((pos_sel[b, qc] >= 0).sum())
                if attended > min(causal, DSA_PAGES):
                    raise AssertionError(f"a chunk attends {attended} of {causal} causal pages")
                chunks += 1
                pruned_chunks += attended < causal
    rows = pruned_rows = 0
    for seq_lens, sel in seen["decode"]:
        for sl, pages in zip(seq_lens.tolist(), sel.tolist()):
            attended = sum(p * page < sl for p in pages)
            rows += 1
            pruned_rows += attended < -(-sl // page)
    log(f"  pruning: {pruned_chunks} of {chunks} (prefill chunk, layer) pairs and "
        f"{pruned_rows} of {rows} (decode row, layer) pairs attended fewer pages than their "
        f"causal range (at most {DSA_PAGES} of up to {LONG_PAGES_PER_REQ})")
    if not (pruned_chunks and pruned_rows):
        raise AssertionError("DSA pruned no prefill chunk or no decode row")
    return eng, launches


def dsa_token_decode(eng, batch, n, params, moe, mla_wq8):
    """Phase [4d], token mode: one decode step on the DSA engine's live batch
    with ``sparse_granularity="token"`` (the same caches: the index keys are
    the page mode's): K10 once a layer through ``lightning_indexer``, K2
    never; held to :func:`w8a8_rule` with the routing and the token
    selections replayed."""
    cfg = dataclasses.replace(CFG_DSA, sparse_granularity="token")
    counters.reset()
    dec_k = with_routes(lambda: eng.decode_logits(
        batch, decode_step_fn(params, moe, cfg=cfg, mla_wq=mla_wq8))[:n].float())
    torch.cuda.synchronize()
    launches = counters.read()
    sel = dec_k[1].sel[0]
    log(f"  token-mode decode step: launches {json.dumps(launches)}; layer 0's rows select "
        f"{(sel.reshape(sel.shape[0], -1) >= 0).sum(-1).tolist()} tokens (sparse_count "
        f"{cfg.sparse_count})")
    ok = w8a8_rule("DSA token-mode decode step, int8 cache (logits)", dec_k,
                   lambda: eng.decode_logits(batch, decode_step_fn(params, moe, cfg=cfg,
                                                                   mla_wq=mla_wq8, plain=True)),
                   n, True, plain_set="K1")
    want = {"lightning_indexer_scores_prefill_pallas": cfg.num_layers, "decode_mla": 0,
            "mla_prefill_block_sparse": 0}
    if not ok or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"the token-mode decode step: rule held {ok}, launches {launches}, "
                             f"want {want}")


# ---------------------------------------------------------------------------
# phase 4e: GPT-OSS
# ---------------------------------------------------------------------------

def ulp_close(got, want):
    """Max |err| and whether it is within one bf16 ulp of the output's
    largest value: both compute in f32 and round once to bf16, so an element
    moves at most by a rounding flip (K6a, K7b)."""
    err = max_abs(got, want)
    return err, err <= 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)


def check_rms_norm(gen, rows, timed, h=CFG_GPT.hidden):
    """K6a at ``[rows, h]`` bf16 (bf16 weight, eps 1e-5) against its plain
    version within a bf16 ulp, and bit-equal to its CPU mirror
    ``rms_norm_rows_plain`` (the kernel's order of operations); timed with
    ``torch.nn.functional.rms_norm`` as the library call."""
    x = randn(gen, (rows, h), scale=3.0)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=DEV)).to(torch.bfloat16)
    eps = CFG_GPT.rms_eps
    got = norm.rms_norm(x, w, eps)
    err, ok = ulp_close(got, norm.rms_norm_ref(x, w, eps))
    plan = row_reduce.launch_plan(x, w)
    mirror = bool(torch.equal(got.cpu(), norm.rms_norm_rows_plain(x.cpu(), w.cpu(), eps, plan)))
    log(f"  rms_norm [{rows}, {h}] bf16 ({plan}): max|err| {err:.3e} (tol one bf16 ulp of the "
        f"largest output); bit-equal to rms_norm_rows_plain {mirror}")
    if not (ok and mirror):
        raise AssertionError(f"rms_norm disagrees with its plain version: {err}, mirror {mirror}")
    if not timed:
        return None
    r = dict(err=err, ms=time_ms(lambda: norm.rms_norm(x, w, eps), 50),
             plain_ms=time_ms(lambda: norm.rms_norm_ref(x, w, eps), 20),
             library_ms=time_ms(lambda: torch.nn.functional.rms_norm(x, (h,), w, eps), 50))
    r["bound_ms"], r["bound_by"] = bound(2 * 2 * rows * h + 2 * h, 4 * rows * h, F32_FLOPS)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, F.rms_norm {r['library_ms']:.4f}, "
        f"bound {r['bound_ms']:.5f} {r['bound_by']})")
    return r


def check_swiglu_oai(gen, rows, timed):
    """K7b on bf16 ``[rows, 2 x 2880]`` interleaved gate / up, N(0, 4²) so that
    values lie past ±limit, within a bf16 ulp of its plain version."""
    i = CFG_GPT.intermediate
    x = randn(gen, (rows, 2 * i), scale=4.0)
    a, lim = CFG_GPT.alpha, CFG_GPT.limit
    err, ok = ulp_close(activation.swiglu_oai(x, a, lim), activation.swiglu_oai_ref(x, a, lim))
    torch.cuda.synchronize()
    past = float((x.float().abs() > lim).float().mean())
    log(f"  swiglu_oai [{rows}, {2 * i}] bf16 ({100 * past:.1f} % of values past ±{lim}): "
        f"max|err| {err:.3e} (tol one bf16 ulp of the largest output)")
    if not ok:
        raise AssertionError(f"swiglu_oai disagrees with its plain version: {err}")
    if not timed:
        return None
    r = dict(err=err, ms=time_ms(lambda: activation.swiglu_oai(x, a, lim), 20),
             plain_ms=time_ms(lambda: activation.swiglu_oai_ref(x, a, lim), 5), library_ms=None)
    r["bound_ms"], r["bound_by"] = bound(3 * rows * i * 2, 8 * rows * i, F32_FLOPS)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, no single PyTorch call, bound "
        f"{r['bound_ms']:.4f} {r['bound_by']})")
    return r


GPT_HEADS = (CFG_GPT.num_heads, CFG_GPT.num_kv_heads, CFG_GPT.head_dim)
KINDS = ("bf16", "int8", "packed", "packed_int8")   # the caches the attention kernels read


def attn_caches(gen, n_pages, hkv, d, kind):
    """Random K and V caches of N(0, 1) values at ``hkv`` kv heads x ``d``,
    page 16, in ``kind``'s form: bf16; int8 levels at scale 1/32 with
    per-kv-head scales about it; the packed layout (``pack_kv_sinks``); or
    both → ``(k, v, {k_scale, v_scale} or {})``."""
    shape = (n_pages, hkv, 16, d)
    kc, vc = randn(gen, shape), randn(gen, shape)
    sc = {}
    if "int8" in kind:
        kc, vc = (torch.clamp(torch.round(c.float() * 32), -128, 127).to(torch.int8)
                  for c in (kc, vc))
        ramp = (1 + 0.1 * torch.arange(hkv, device=DEV)) / 32
        sc = dict(k_scale=ramp, v_scale=ramp.flip(0))
    if "packed" in kind:
        kc, vc = sa.pack_kv_sinks(kc), sa.pack_kv_sinks(vc)
    return kc, vc, sc


def dense_kv(cache, bt, max_len, kind, scale):
    """A cache's keys gathered to dense ``[B, Hkv, L, D]`` bf16 (int8 levels
    dequantized): the library yardstick's input, made before it is timed."""
    x = da._gather_pages(cache, bt, max_len, 2 if "packed" in kind else 1)
    if "int8" in kind:
        x = (x.float() * scale[None, :, None, None]).to(torch.bfloat16)
    return x


def sdpa_yardstick(q, k, v, mask, sinks, scale):
    """SDPA over dense keys, q ``[B, Hq, T, D]``, k / v ``[B, Hkv, L, D]``,
    bool mask ``[B, 1, T, L]``; with ``sinks`` one more all-zero key and
    value whose additive mask is each head's sink logit (the mask in the
    queries' dtype, as SDPA takes it): the yardstick of K11a / K12."""
    if sinks is None:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)
    b, hq, t, _ = q.shape
    zero = k.new_zeros((*k.shape[:2], 1, k.shape[3]))
    kz, vz = torch.cat([k, zero], dim=2), torch.cat([v, zero], dim=2)
    add = torch.zeros(mask.shape[:-1] + (mask.shape[-1] + 1,), dtype=q.dtype, device=DEV)
    add = add.expand(b, hq, t, -1).clone()
    add[..., :-1].masked_fill_(~mask, float("-inf"))
    add[..., -1] = sinks.to(q.dtype)[None, :, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kz, vz, attn_mask=add, scale=scale, enable_gqa=True)


def check_paged_decode(gen, ctx_list, window, pad_rows, timed, *, heads=GPT_HEADS, kind="bf16",
                       with_sinks=True, table_pages=GPT_PAGES_PER_REQ):
    """The decode kernel of ``csrc/sinks_attention.cu`` through the wrapper
    of its mode: K12a ``attention_sinks`` (``kind`` bf16 / int8), K12b / K12c
    ``attention_sinks_packed`` (packed / packed_int8) or, without sinks,
    K11a ``decode_gqa``; at ``heads`` = (q heads, kv heads, head_dim) over
    ``ctx_list`` contexts (page 16, permuted pages, a ``table_pages``-page
    table) and ``pad_rows`` engine pad rows (ctx 1, a table of zeros),
    against its plain version (``attention_close``).  Timed: the kernel, the
    plain version, SDPA over the gathered (dequantized) keys, and the bound:
    the bytes of the keys each row reads (its window's, else its context)
    in the cache's type."""
    hq, hkv, d = heads
    page = 16
    b = len(ctx_list)
    max_pages = max(-(-c // page) for c in ctx_list)
    n_pages = b * max_pages + 1
    kc, vc, sc = attn_caches(gen, n_pages, hkv, d, kind)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(b)) + 1
    bt = torch.zeros((b + pad_rows, table_pages), dtype=torch.int32)
    bt[:b, :max_pages] = perm[: b * max_pages].reshape(b, max_pages)
    bt = bt.to(DEV)
    ctx = torch.tensor(ctx_list + [1] * pad_rows, dtype=torch.int32, device=DEV)
    q = randn(gen, (b + pad_rows, hq * d))
    sinks = torch.randn(hq, generator=gen, device=DEV) * 2 if with_sinks else None
    packed, scale = "packed" in kind, d ** -0.5
    if with_sinks:
        fn = sa.attention_sinks_packed if packed else sa.attention_sinks
        args = (q, kc, vc, sinks, bt, ctx, scale, window, hq, hkv)
        kernel = lambda: fn(*args, **sc)  # noqa: E731
        plain = lambda: sa.attention_sinks_plain(*args, packed=packed, **sc)  # noqa: E731
    else:
        fn, q3 = da.decode_gqa, q.reshape(-1, hq, d)
        kernel = lambda: da.decode_gqa(q3, kc, vc, ctx, scale, bt, **sc)  # noqa: E731
        plain = lambda: da.decode_gqa_plain(q3, kc, vc, ctx, scale, bt, **sc)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, ok = attention_close(got, want)
    log(f"  {fn.__name__} ({kind} cache) B={b}+{pad_rows} pad, {hq}/{hkv} heads x {d}, page "
        f"{page}, ctx {ctx_list}, window {window}: max|err| {err:.3e} (tol 2e-2 + 2e-2 |plain|)")
    if not ok:
        raise AssertionError(f"{fn.__name__} ({kind}) disagrees with its plain version: {err}")
    if not timed:
        return None
    r = dict(err=err, ms=time_ms(kernel, 50), plain_ms=time_ms(plain, 10))
    max_len = table_pages * page
    kd = dense_kv(kc, bt, max_len, kind, sc.get("k_scale"))
    vd = dense_kv(vc, bt, max_len, kind, sc.get("v_scale"))
    pos = torch.arange(max_len, device=DEV)[None, :]
    mask = (pos < ctx[:, None]) & ((pos >= ctx[:, None] - window) if window else True)
    r["library_ms"] = time_ms(sdpa_yardstick(q.reshape(-1, hq, 1, d), kd, vd,
                                             mask[:, None, None, :], sinks, scale), 50)
    keys = sum(min(c, window) if window else c for c in ctx.tolist())
    key_bytes = hkv * 2 * d * (1 if "int8" in kind else 2)
    nbytes = (2 * q.numel() * 2 + keys * key_bytes + bt.numel() * 4 + ctx.numel() * 4
              + (hq * 4 if with_sinks else 0))
    r["bound_ms"], r["bound_by"] = bound(nbytes, keys * hq * 4 * d, BF16_FLOPS)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, bound "
        f"{r['bound_ms']:.5f} {r['bound_by']})")
    return r


def check_paged_prefill(gen, seq_list, ctx_list, window, pad_rows, timed, *, heads=GPT_HEADS,
                        kind="bf16", with_sinks=True, table_pages=GPT_PAGES_PER_REQ):
    """K12d at ``heads`` on packed requests (page 16) and ``pad_rows`` rows
    past them, over ``kind``'s cache, against its plain version
    (``attention_close``), the pad rows exactly 0.  Timed (one request): the
    kernel, the plain version and SDPA (with the sink key when there are
    sinks) over the request's gathered (dequantized) keys; the bound counts
    each visible (row, key) pair and each key of the walked range once."""
    hq, hkv, d = heads
    page = 16
    bsz = len(seq_list)
    max_pages = max(-(-c // page) for c in ctx_list)
    kc, vc, sc = attn_caches(gen, bsz * max_pages, hkv, d, kind)
    bt = torch.zeros((bsz, table_pages), dtype=torch.int32, device=DEV)
    bt[:, :max_pages] = torch.arange(bsz * max_pages, dtype=torch.int32,
                                     device=DEV).reshape(bsz, max_pages)
    seq = torch.tensor(seq_list, dtype=torch.int32, device=DEV)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=DEV)
    q = randn(gen, (sum(seq_list) + pad_rows, hq * d))
    sinks = torch.randn(hq, generator=gen, device=DEV) * 2 if with_sinks else None
    scale = d ** -0.5
    args = (q, kc, vc, sinks, seq, bt, ctx, scale, window, hq, hkv)
    kw = dict(max_q=max(seq_list), packed="packed" in kind, **sc)
    kernel = lambda: sa.attention_sinks_prefill_pallas(*args, **kw)  # noqa: E731
    plain = lambda: sa.attention_sinks_prefill_plain(*args, **kw)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, ok = attention_close(got, want)
    log(f"  attention_sinks_prefill ({kind} cache) seq={seq_list} ctx={ctx_list} +{pad_rows} pad "
        f"rows, {hq}/{hkv} heads x {d}, page {page}, window {window}, sinks {with_sinks}: "
        f"max|err| {err:.3e} (tol 2e-2 + 2e-2 |plain|)")
    if not ok or (pad_rows and bool(got[-pad_rows:].any())):
        raise AssertionError(f"attention_sinks_prefill ({kind}) disagrees with its plain "
                             f"version: {err}")
    if not timed:
        return None
    r = dict(err=err, ms=time_ms(kernel, 20), plain_ms=time_ms(plain, 5))
    sl, cl = seq_list[0], ctx_list[0]
    kd = dense_kv(kc, bt[:1], cl, kind, sc.get("k_scale"))
    vd = dense_kv(vc, bt[:1], cl, kind, sc.get("v_scale"))
    qpos = cl - sl + torch.arange(sl, device=DEV)[:, None]
    kpos = torch.arange(cl, device=DEV)[None, :]
    mask = (kpos <= qpos) & ((kpos > qpos - window) if window else True)
    r["library_ms"] = time_ms(sdpa_yardstick(q[:sl].reshape(1, sl, hq, d).transpose(1, 2), kd,
                                             vd, mask[None, None], sinks, scale), 20)
    pairs = int(mask.sum())
    keys = cl - max(cl - sl - window + 1, 0) if window else cl
    key_bytes = hkv * 2 * d * (1 if "int8" in kind else 2)
    nbytes = 2 * sl * hq * d * 2 + keys * key_bytes + bt.numel() * 4 + (hq * 4 if with_sinks else 0)
    r["bound_ms"], r["bound_by"] = bound(nbytes, pairs * hq * 4 * d, BF16_FLOPS)
    log(f"    {kind} {hq}/{hkv} x {d}, window {window}: {r['ms']:.4f} ms (plain "
        f"{r['plain_ms']:.4f}, SDPA{' + sink key' if with_sinks else ''} "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} {r['bound_by']})")
    return r


def check_gpt_oss_kernels(gen):
    """K6a, K7b, and K12a-d over each cache (bf16, int8, packed, packed
    int8) at the shapes [4e] gives them and on small ragged cases (ctx 1, a
    window whose first key lies inside a page, pad rows, dead rows of a
    q-block, no sinks).  Returns the JSON numbers: K6a and K7b at a 512-row
    prefill call's shapes; K12a (bf16), K12b / K12c (packed bf16) and K12d
    (bf16) summed over a step's two layers (window 128, then full); the int8
    figures are logged."""
    r6 = check_rms_norm(gen, GPT_CHUNK, True)
    check_rms_norm(gen, MAX_BATCH, True)
    check_rms_norm(gen, 1, False)
    n_exp = CFG_GPT.num_experts
    r7 = check_swiglu_oai(gen, GPT_CHUNK * n_exp, True)
    check_swiglu_oai(gen, MAX_BATCH * n_exp, True)
    dec_ctx = [n + NEW_TOKENS for n in GPT_PROMPT_LENS]
    pads = MAX_BATCH - len(dec_ctx)
    windows = (CFG_GPT.sliding_window, 0)
    dec, pre = {}, {}
    for kind in KINDS:
        name = "attention_sinks_packed" if "packed" in kind else "attention_sinks"
        dec[kind] = summed(f"{name} ({kind} cache), a decode step's two layers",
                           [check_paged_decode(gen, dec_ctx, w, pads, True, kind=kind)
                            for w in windows])
        for w in (8, 0):
            check_paged_decode(gen, [1, 16, 17, 37, 40], w, 2, False, kind=kind, table_pages=4)
        pre[kind] = summed(f"attention_sinks_prefill ({kind} cache), a {GPT_CHUNK}-row chunk's "
                           "two layers",
                           [check_paged_prefill(gen, [GPT_CHUNK], [2 * GPT_CHUNK], w, 0, True,
                                                kind=kind) for w in windows])
        for w, with_sinks in ((8, True), (0, True), (8, False)):
            check_paged_prefill(gen, [1, 5, 40], [1, 30, 70], w, 3, False, kind=kind,
                                with_sinks=with_sinks, table_pages=5)
    return r6, r7, dec["bf16"], dec["packed"], pre["bf16"]


def check_llama_kernels(gen):
    """K11a ``decode_gqa`` at Llama-3.1-8B's heads (32 / 8 x 128) over [4e]'s
    decode contexts and pad rows, bf16 and int8, with one more row at
    ``LONG_DECODE_KEYS`` keys on a table that holds them (bf16), and on
    ragged cases (a group of 16 at head_dim 32 and 64); K12d without sinks
    or window at those heads (a 512-row chunk at context 1024, and ragged
    requests with pad rows), and at head_dim 32; K6a at Llama's width and K7a
    at its gate || up (a decode step's and a chunk's rows, timed).  Returns
    K11a's bf16 numbers (one layer's call at [4e]'s contexts)."""
    for rows in (MAX_BATCH, GPT_CHUNK):                 # K6a at Llama's width
        check_rms_norm(gen, rows, True, CFG_LLAMA.hidden)
    # K7a at the W8A8 serve's gate || up (2 x 14336): a decode step's rows (a
    # cluster of 8 a row) and a chunk's, then with rows past a group total
    for rows in (MAX_BATCH, GPT_CHUNK):
        check_swiglu_quant(gen, rows, 2 * CFG_LLAMA.intermediate, None, True)
        check_swiglu_quant(gen, rows, 2 * CFG_LLAMA.intermediate, 1, False)
    heads = (CFG_LLAMA.num_heads, CFG_LLAMA.num_kv_heads, CFG_LLAMA.head_dim)
    dec_ctx = [n + NEW_TOKENS for n in GPT_PROMPT_LENS]
    pads = MAX_BATCH - len(dec_ctx)
    check_paged_decode(gen, dec_ctx + [LONG_DECODE_KEYS], 0, pads, True, heads=heads,
                       with_sinks=False, table_pages=LONG_DECODE_KEYS // 16)
    r11 = {}
    for kind in ("bf16", "int8"):
        r11[kind] = check_paged_decode(gen, dec_ctx, 0, pads, True, heads=heads, kind=kind,
                                       with_sinks=False)
        check_paged_decode(gen, [1, 16, 17, 37, 40], 0, 2, False, heads=heads, kind=kind,
                           with_sinks=False, table_pages=4)
        for h in ((32, 2, 32), (64, 4, 64)):
            check_paged_decode(gen, [1, 17, 300, 2000], 0, 2, False, heads=h, kind=kind,
                               with_sinks=False)
        check_paged_prefill(gen, [GPT_CHUNK], [2 * GPT_CHUNK], 0, 0, True, heads=heads, kind=kind,
                            with_sinks=False)
        for h in (heads, (32, 2, 32)):
            check_paged_prefill(gen, [1, 5, 40], [1, 30, 70], 0, 3, False, heads=h, kind=kind,
                                with_sinks=False, table_pages=5)
    return r11["bf16"]


def decode_kernels_only(gen):
    """One int8 ``decode_gqa`` call at [4f]'s shapes (per-kv-head scales) and
    one bf16 ``attention_sinks`` call at [4e]'s full layer, each captured
    into a CUDA graph after a warm-up (``enqueued``): the wrapper enqueues
    the decode kernel and nothing else (no fold of the int8 scales, no cast
    of the sinks or the lengths), else the run fails.  Then K12d on a
    512-row chunk at [4f]'s heads, bf16 and int8 (per-kv-head scales): each
    call launches the prefill kernel once and nothing else."""
    dec_ctx = [n + NEW_TOKENS for n in GPT_PROMPT_LENS] + [1] * (MAX_BATCH - len(GPT_PROMPT_LENS))
    ctx = torch.tensor(dec_ctx, dtype=torch.int32, device=DEV)
    bt = torch.arange(MAX_BATCH * GPT_PAGES_PER_REQ, dtype=torch.int32,
                      device=DEV).reshape(MAX_BATCH, GPT_PAGES_PER_REQ)
    n_pages = MAX_BATCH * GPT_PAGES_PER_REQ
    hq, hkv, d = CFG_LLAMA.num_heads, CFG_LLAMA.num_kv_heads, CFG_LLAMA.head_dim
    kc, vc, sc = attn_caches(gen, n_pages, hkv, d, "int8")
    q = randn(gen, (MAX_BATCH, hq, d))
    calls = [("decode_gqa, int8 cache", lambda: da.decode_gqa(q, kc, vc, ctx, d ** -0.5, bt, **sc))]
    hq, hkv, d = GPT_HEADS
    kg, vg, _ = attn_caches(gen, n_pages, hkv, d, "bf16")
    qg = randn(gen, (MAX_BATCH, hq * d))
    sinks = torch.randn(hq, generator=gen, device=DEV)
    calls.append(("attention_sinks, bf16 cache", lambda: sa.attention_sinks(
        qg, kg, vg, sinks, bt, ctx, d ** -0.5, 0, hq, hkv)))
    for label, fn in calls:
        rows = enqueued(label, fn)
        if [c for n, c in rows if "decode_kernel" in n] != [1] or len(rows) != 1:
            raise AssertionError(f"{label} launched more than the decode kernel: {rows}")
    # K12d at [4f]'s chunk, bf16 and int8: the prefill kernel once and nothing
    # else (the scales fold inside it, it zeroes the rows past the requests)
    hq, hkv, d = CFG_LLAMA.num_heads, CFG_LLAMA.num_kv_heads, CFG_LLAMA.head_dim
    seq = torch.tensor([GPT_CHUNK], dtype=torch.int32, device=DEV)
    pctx = torch.tensor([2 * GPT_CHUNK], dtype=torch.int32, device=DEV)
    qp = randn(gen, (GPT_CHUNK, hq * d))
    kinds = {}
    for kind in ("bf16", "int8"):
        kp, vp, psc = attn_caches(gen, 2 * GPT_CHUNK // 16, hkv, d, kind)
        args = (qp, kp, vp, None, seq, bt[:1], pctx, d ** -0.5, 0, hq, hkv)
        kinds[kind] = enqueued(
            f"attention_sinks_prefill_pallas, {kind} cache",
            lambda: sa.attention_sinks_prefill_pallas(*args, max_q=GPT_CHUNK, **psc))
    for kind, rows in kinds.items():
        if len(rows) != 1 or not has_symbol(rows[0][0], "pre::prefill_kernel") or rows[0][1] != 1:
            raise AssertionError(f"a {kind} K12d call launched more than the prefill kernel: "
                                 f"{rows}")


NORM_HIDDEN = CFG_LLAMA.hidden     # the add-RMSNorm ops at Llama-3.1-8B's width


def check_add_rms_norm(gen, rows, mode, timed):
    """K6b (``mode`` "bias", or "quant": a static per-channel int8 scale of
    20-40 and offset in ±2) or K6c ("gemma", on K6b's kernel) at ``[rows,
    4096]`` bf16, bf16 weight and bias, eps 1e-5: the residual sum bit-equal
    to the plain version's, the output within one bf16 ulp of its largest
    value (int8: one level, and equal on 99 % of elements: 1 / sqrt against
    rsqrt can move a value at a rounding tie), and both bit-equal to the CPU
    mirror ``add_rms_norm_rows_plain`` on the launch's plan (the kernel's
    order of operations).  No single PyTorch call computes either
    function."""
    h = NORM_HIDDEN
    x = randn(gen, (rows, h), scale=2.0)
    res = randn(gen, (rows, h))
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=DEV)).to(torch.bfloat16)
    b = randn(gen, (h,), scale=0.1)
    q = {}
    if mode == "quant":
        q = {"quant_scale": 20 + 20 * torch.rand(h, generator=gen, device=DEV),
             "quant_offset": 4 * torch.rand(h, generator=gen, device=DEV) - 2}
    if mode == "gemma":
        name, fn = "add_gemma_rms_norm", lambda: norm.add_gemma_rms_norm(x, w, res, 1e-5)
        ref = lambda: norm.add_gemma_rms_norm_ref(x, w, res, 1e-5)  # noqa: E731
    else:
        name, fn = "add_rms_norm_bias", lambda: norm.add_rms_norm_bias(x, res, w, b, 1e-5, **q)
        ref = lambda: norm.add_rms_norm_bias_ref(x, res, w, b, 1e-5, **q)  # noqa: E731
    (got, added), (want, want_added) = fn(), ref()
    torch.cuda.synchronize()
    if mode == "quant":
        diff = (got.int() - want.int()).abs()
        err = float(diff.max())
        ok = err <= 1 and float((diff == 0).float().mean()) >= 0.99
        tol = "int8 within one level, equal on 99 %"
    else:
        err, ok = ulp_close(got, want)
        tol = "one bf16 ulp of the largest output"
    plan = row_reduce.launch_plan(x, res, w, inputs=2)
    qm = (q["quant_scale"].cpu(), q["quant_offset"].cpu()) if q else (None, None)
    m_out, m_added = norm.add_rms_norm_rows_plain(x.cpu(), res.cpu(), w.cpu(), b.cpu(), *qm, mode,
                                                  1e-5, plan)
    mirror = bool(torch.equal(got.cpu(), m_out) and torch.equal(added.cpu(), m_added))
    log(f"  {name} ({mode}) [{rows}, {h}] bf16 ({plan}): max|err| {err:.3e} ({tol}); residual "
        f"sum bit-equal: {torch.equal(added, want_added)}; bit-equal to add_rms_norm_rows_plain "
        f"{mirror}")
    if not ok or not torch.equal(added, want_added) or not mirror:
        raise AssertionError(f"{name} ({mode}) disagrees with its plain version: {err}, mirror "
                             f"{mirror}")
    if not timed:
        return None
    r = dict(err=err, ms=time_ms(fn, 50), plain_ms=time_ms(ref, 20), library_ms=None)
    out_bytes = 1 if mode == "quant" else 2
    vec_bytes = 2 * h * (2 if mode != "gemma" else 1) + (8 * h if mode == "quant" else 0)
    r["bound_ms"], r["bound_by"] = bound(rows * h * (3 * 2 + out_bytes) + vec_bytes,
                                         8 * rows * h, F32_FLOPS)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, no single PyTorch call, bound "
        f"{r['bound_ms']:.5f} {r['bound_by']})")
    return r


def check_l1_norm(gen, rows, dtype, timed):
    """K6d at ``[rows, 4096]``: N(0.5, 1) rows (signed sums far from 0)
    within 1e-5 of the largest output (f32 sums in another order, IEEE
    division on both sides) and bit-equal to ``l1_norm_rows_plain`` on the
    launch's plan.  ``F.normalize(p=1)`` divides by Σ|x|, another function:
    no library call."""
    h = NORM_HIDDEN
    x = (torch.randn((rows, h), generator=gen, device=DEV) + 0.5).to(dtype)
    got, want = norm.l1_norm(x), norm.l1_norm_ref(x)
    torch.cuda.synchronize()
    err = max_abs(got, want)
    scale = float(want.abs().max())
    plan = norm.l1_launch_plan(x, got)
    same = torch.equal(got.cpu(), norm.l1_norm_rows_plain(x.cpu(), plan))
    log(f"  l1_norm [{rows}, {h}] {str(dtype)[6:]} ({plan}): max|err| {err:.3e} (tol 1e-5 x "
        f"{scale:.3e}), bit-equal to l1_norm_rows_plain {same}")
    if got.dtype != torch.float32 or err > 1e-5 * scale or not same:
        raise AssertionError(f"l1_norm disagrees with its plain version: {err}, {same}")
    if not timed:
        return None
    r = dict(err=err, ms=time_ms(lambda: norm.l1_norm(x), 50),
             plain_ms=time_ms(lambda: norm.l1_norm_ref(x), 20), library_ms=None)
    r["bound_ms"], r["bound_by"] = bound(rows * h * (x.element_size() + 4), 2 * rows * h,
                                         F32_FLOPS)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} "
        f"{r['bound_by']})")
    return r


def lora_weights(gen, n_adapters, rank=LORA_RANK, h=NORM_HIDDEN, d=NORM_HIDDEN):
    """Random bf16 adapters at Llama-3.1-8B's q / o widths: A [L, R, H] and B
    [L, D, R], N(0, 0.1²)."""
    return (randn(gen, (n_adapters, rank, h), scale=0.1),
            randn(gen, (n_adapters, d, rank), scale=0.1))


def lora_close(label, got, want, dead):
    """K13a / K13b against their plain versions: within 1e-4 of the largest
    value (f32 sums of the same products in another order), dead rows
    exactly 0."""
    err = max_abs(got, want)
    scale = float(want.abs().max())
    zero = not bool(got[dead].any())
    log(f"  {label}: max|err| {err:.3e} (tol 1e-4 x {scale:.3e}); dead rows 0: {zero}")
    if err > 1e-4 * scale or not zero or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def has_symbol(name: str, qual: str) -> bool:
    """Whether a kernel's name, demangled or mangled, holds ``qual``
    (``"ns::kernel"``; mangled as ``2ns6kernel``)."""
    return qual in name or "".join(f"{len(p)}{p}" for p in qual.split("::")) in name


def enqueued(label, fn):
    """The device work of one ``fn()`` as ``[(name, count)]``, from a CUDA
    graph capture of it (``trace_profile.graph_kernels``): every kernel,
    copy and fill it enqueues.  A ``torch.profiler`` trace is not used for
    these checks: on the H100 machines it at times recorded none, or only
    some, of a call's kernels."""
    rows = trace_profile.graph_kernels(fn)
    log(f"    {label} enqueues {[(n[:60], c) for n, c in rows]}")
    return rows


def lora_launches(label, fn, got):
    """K13a / K13b: two CUDA kernels a call, the shrink and the expand once
    each, and nothing else on the device (no scratch fill, no prefix sum),
    and a second call bit-identical to ``got``."""
    rows = enqueued(label, fn)
    again = fn()
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    log(f"    a second call bit-identical: {same}")
    kinds = sorted((has_symbol(n, "lora::shrink_kernel") + 2 * has_symbol(n, "lora::expand_kernel"),
                    c) for n, c in rows)
    if kinds != [(1, 1), (2, 1)] or not same:
        raise AssertionError(f"{label}: {rows} a call, bit-identical {same}")


def lora_bound(x, n_live_rows, ranks_read, d):
    """The least time for a LoRA delta: x read, each adapter a live row uses
    read once (its live ranks' A rows and B columns), f32 out written; 2 r
    (H + D) bf16 operations a live row."""
    h = x.shape[1]
    rows_ops = sum(2 * r * (h + d) * n for r, n in n_live_rows)
    nbytes = x.numel() * 2 + sum(r * (h + d) * 2 for r in ranks_read) + x.shape[0] * d * 4
    return bound(nbytes, rows_ops, BF16_FLOPS)


def check_bgmv(gen, t, n_adapters, timed, out_of_range=False):
    """K13a at Llama-3.1-8B's widths (H = D = 4096), rank 16, bf16, ``t``
    tokens over a pool of ``n_adapters``; ``out_of_range`` puts ids -1 and L
    on two rows (a zero delta, no read).  Timed against its plain version;
    no single PyTorch call computes it."""
    a, b = lora_weights(gen, n_adapters)
    x = randn(gen, (t, NORM_HIDDEN))
    idx = torch.randint(0, n_adapters, (t,), generator=gen, device=DEV, dtype=torch.int32)
    if out_of_range:
        idx[0], idx[-1] = -1, n_adapters
    dead = (idx < 0) | (idx >= n_adapters)
    label = (f"bgmv_fused T {t}, {n_adapters} adapters of rank {LORA_RANK}"
             f"{', ids -1 and L' if out_of_range else ''}")
    fn = lambda: lora_pallas.bgmv_fused(x, a, b, idx)  # noqa: E731
    plain = lambda: lora_pallas.bgmv_fused_plain(x, a, b, idx)  # noqa: E731
    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = lora_close(label, got, want, dead)
    lora_launches(label, fn, got)
    if not timed:
        return None
    r = dict(err=err, ms=time_ms(fn, 50), plain_ms=time_ms(plain, 10), library_ms=None)
    live = idx[~dead]
    used = len(set(live.tolist()))
    r["bound_ms"], r["bound_by"] = lora_bound(x, [(LORA_RANK, int(live.numel()))],
                                              [LORA_RANK] * used, NORM_HIDDEN)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, no single PyTorch call, bound "
        f"{r['bound_ms']:.5f} {r['bound_by']}; {used} adapters read)")
    return r


SGMV_LENS = [100, 0, 250, 140]           # 490 of 512 rows: one empty sequence, a tail
SGMV_IDS, SGMV_RANKS = [1, 2, 3, 0], [16, 8, 4, 16]
SGMV_SCALINGS = [1.0, 0.5, 2.0, 0.25]


def sgmv_inputs(gen):
    a, b = lora_weights(gen, LORA_ADAPTERS)
    x = randn(gen, (GPT_CHUNK, NORM_HIDDEN))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=DEV)  # noqa: E731
    return (x, a, b, i32(SGMV_IDS), i32(SGMV_LENS), i32(SGMV_RANKS),
            torch.tensor(SGMV_SCALINGS, device=DEV))


def check_sgmv(gen):
    """K13b over a 512-row chunk at H = D = 4096: 4 sequences (one empty),
    adapters of ranks 16 / 8 / 4 / 16 and mixed scalings, a 22-row tail
    exactly 0.  Timed; no single PyTorch call."""
    args = sgmv_inputs(gen)
    fn = lambda: lora_pallas.sgmv_fused(*args)  # noqa: E731
    plain = lambda: lora_pallas.sgmv_fused_plain(*args)  # noqa: E731
    got, want = fn(), plain()
    torch.cuda.synchronize()
    label = (f"sgmv_fused S {GPT_CHUNK}, sequences {SGMV_LENS} under adapters {SGMV_IDS}, ranks "
             f"{SGMV_RANKS}, scalings {SGMV_SCALINGS}")
    err = lora_close(label, got, want, torch.arange(GPT_CHUNK, device=DEV) >= sum(SGMV_LENS))
    lora_launches(label, fn, got)
    r = dict(err=err, ms=time_ms(fn, 50), plain_ms=time_ms(plain, 10), library_ms=None)
    live = [(SGMV_RANKS[a], n) for a, n in zip(SGMV_IDS, SGMV_LENS) if n]
    r["bound_ms"], r["bound_by"] = lora_bound(args[0], live, [r_ for r_, _ in live], NORM_HIDDEN)
    log(f"    {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, no single PyTorch call, bound "
        f"{r['bound_ms']:.5f} {r['bound_by']})")
    return r


def check_lora_norm_kernels(gen):
    """[4g]'s kernel checks: K6b with and without its quant and K6c at
    [512, 4096] and [8, 4096] bf16; K6d there in bf16 and f32; K13a at T 8
    and 512 over 4 adapters, at T 8 over 64, with out-of-range ids; K13b.
    Returns the JSON rows' numbers: K6b, K6c, K6d at [512, 4096] bf16, K13a
    at T 8 over 4 adapters (a decode call's shape), K13b."""
    r6b = check_add_rms_norm(gen, GPT_CHUNK, "bias", True)
    check_add_rms_norm(gen, GPT_CHUNK, "quant", True)
    r6c = check_add_rms_norm(gen, GPT_CHUNK, "gemma", True)
    for mode in ("bias", "quant", "gemma"):
        check_add_rms_norm(gen, MAX_BATCH, mode, True)
    check_add_rms_norm(gen, 3, "quant", False)
    r6d = check_l1_norm(gen, GPT_CHUNK, torch.bfloat16, True)
    check_l1_norm(gen, GPT_CHUNK, torch.float32, True)
    check_l1_norm(gen, MAX_BATCH, torch.bfloat16, True)
    r13a = check_bgmv(gen, MAX_BATCH, LORA_ADAPTERS, True)
    check_bgmv(gen, GPT_CHUNK, LORA_ADAPTERS, True)
    check_bgmv(gen, MAX_BATCH, 64, True)
    check_bgmv(gen, MAX_BATCH, LORA_ADAPTERS, False, out_of_range=True)
    r13b = check_sgmv(gen)
    return r6b, r6c, r6d, r13a, r13b


def op_paths(gen):
    """The ops no model calls (K6b, K6c, K6d, K13b), each through its public
    entry point at [4g]'s shapes, with the launch counts reset just before
    and read just after: add_rms_norm_bias without and with its quant and
    add_gemma_rms_norm at [512, 4096] and [8, 4096], l1_norm in bf16 and f32,
    fused_sgmv_delta on the 512-row chunk.  Outputs must be finite and
    shaped.  Returns the counts."""
    h = NORM_HIDDEN
    w, b = randn(gen, (h,)), randn(gen, (h,), scale=0.1)
    qs, qo = torch.full((h,), 30.0, device=DEV), torch.zeros(h, device=DEV)
    sg = sgmv_inputs(gen)
    counters.reset()
    outs = []
    for rows in (GPT_CHUNK, MAX_BATCH):
        x, res = randn(gen, (rows, h)), randn(gen, (rows, h))
        outs += norm.add_rms_norm_bias(x, res, w, b, 1e-5)
        outs += norm.add_rms_norm_bias(x, res, w, b, 1e-5, quant_scale=qs, quant_offset=qo)
        outs += norm.add_gemma_rms_norm(x, w, res, 1e-5)
        outs += [norm.l1_norm(x + 2), norm.l1_norm(x.float() + 2)]
    outs.append(lora.fused_sgmv_delta(*sg))
    torch.cuda.synchronize()
    launches = counters.read()
    if not all(bool(torch.isfinite(o.float()).all()) for o in outs) \
            or outs[-1].shape != (GPT_CHUNK, h) or outs[-1].dtype != torch.bfloat16:
        raise AssertionError("an op's output is not finite or mis-shaped")
    want = {"add_rms_norm_bias": 4, "add_gemma_rms_norm": 2, "l1_norm": 4, "sgmv_fused": 1}
    if {k: launches[k] for k in want} != want or sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"op launches {launches}, want {want}")
    log(f"  ops through their entry points: launches {json.dumps(want)}")
    return launches


def cache_desc(cfg) -> str:
    return f"{'packed ' if cfg.packed_kv else ''}{cfg.kv_cache_dtype} cache"


def gpt_oss_serve(params, cfg=CFG_GPT, ep_buffer=None):
    """Serve [4e]'s prompts through ``Engine(prefill_chunk=512)`` +
    ``gpt_oss_adapter(cfg, params)`` with its defaults (a bf16 cache on the
    card; int8 and packed per ``cfg``): outputs, pages and radix reuse
    (``run_requests``), the cache's type and layout, and exact launch counts
    from the engine's own calls: K12d once a layer a prefill call, K12a (or
    on the packed cache K12b / K12c) once a layer a decode call, K7b once a
    layer a model call (with ``ep_buffer`` never: K8a's ``none`` mode twice),
    K6a twice a layer a model call and once a head call; nothing else.
    Returns the engine, the prompts and the counts."""
    adapter = gpt_oss_adapter(cfg, params, ep_buffer=ep_buffer)
    timer = StepTimer(adapter)
    eng = Engine(adapter, GPT_NUM_PAGES, max_batch=MAX_BATCH, max_pages_per_req=GPT_PAGES_PER_REQ,
                 prefill_chunk=GPT_CHUNK)
    cache = eng.caches[0][0]
    hkv = cfg.num_kv_heads // (2 if cfg.packed_kv else 1)
    want_dt = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    if cache.dtype != want_dt or cache.shape[1] != hkv:
        raise AssertionError(f"the {cache_desc(cfg)} is {cache.dtype} {tuple(cache.shape)}")
    ps = prompts(torch.Generator().manual_seed(SEED + 4), GPT_PROMPT_LENS, (0, GPT_SHARED),
                 CFG_GPT.vocab_size)
    rids, wall, launches = run_requests(eng, ps, (0, GPT_SHARED), GPT_NUM_PAGES,
                                        CFG_GPT.vocab_size)
    n_pre, n_dec, n_head = (timer.calls[k] for k in ("prefill", "decode", "lm_head"))
    layers = cfg.num_layers
    decode = "attention_sinks_packed" if cfg.packed_kv else "attention_sinks"
    want = {k: 0 for k in launches}
    want.update({"attention_sinks_prefill_pallas": layers * n_pre, decode: layers * n_dec,
                 "rms_norm": 2 * layers * (n_pre + n_dec) + n_head})
    want["grouped_matmul_float" if ep_buffer else "swiglu_oai"] = (
        (2 if ep_buffer else 1) * layers * (n_pre + n_dec))
    if launches != want:
        raise AssertionError(f"launches {launches} over {n_pre} prefill, {n_dec} decode and "
                             f"{n_head} head calls; want {want}")
    log_serve(eng, rids, ps, wall, timer,
              cache_desc(cfg) + (", the MoE expert parallel" if ep_buffer else ""))
    log(f"  launches on the main path: "
        f"{json.dumps({k: v for k, v in launches.items() if v})} (every other kernel 0)")
    return eng, ps, launches


def log_serve(eng, rids, ps, wall, timer, what):
    dec_tokens = len(rids) * (NEW_TOKENS - 1)
    log(f"  served {len(rids)} requests (prompts {[len(p) for p in ps]}, {NEW_TOKENS} new tokens "
        f"each, {what}) in {wall:.2f} s wall; prefill {eng.stats['prefill_tokens']} tokens in "
        f"{timer.calls['prefill']} calls of {GPT_CHUNK} rows, {timer.t['prefill']:.3f} s = "
        f"{eng.stats['prefill_tokens'] / timer.t['prefill']:.1f} tok/s; decode {dec_tokens} "
        f"tokens in {timer.calls['decode']} steps, {timer.t['decode']:.3f} s = "
        f"{dec_tokens / timer.t['decode']:.1f} tok/s; {timer.calls['lm_head']} head calls; radix "
        f"cached tokens {eng.stats['cached_tokens']}; all pages returned")


def step_checks(eng, ps, model, cfg, params, label, attn_kernel, routed, head, lora_ids=None,
                reference=None, **step_kw):
    """One decode step on a live batch of [4e]'s prompts and one 512-row
    prefill chunk at context 1024 (the second chunk of a 1024-token
    sequence), through the kernels and through ``plain=True``, held to
    :func:`routing_rule` (``routed``: the routing replayed; Llama's W8A8
    path, whose per-token requant turns the attention kernels' bf16
    rounding into int8 levels, to :func:`w8a8_verdict` against the path
    with only K1, K5 and K7a plain); each layer of each kernel run must
    have launched the decode kernel ``attn_kernel`` / K12d, and with
    ``weights_q`` K1 and K5 their counts, with ``ep_buffer`` K8a's ``none``
    mode twice; with ``lora`` (Llama) the decode
    rows run under ``lora_ids`` (prompt by prompt, pad rows 0), the chunk
    under the last of them, and K13a must have launched twice a layer.
    ``reference`` ``(name, step keywords overriding step_kw)``: the
    reference run takes the kernels with those instead of ``plain=True``
    (the launches are then both runs' and go unchecked).  ``head(h, plain)`` makes the
    logits.  Returns the kernel-path decode logits and chunk for the
    profile."""
    batch, n = live_batch(eng, ps, lora_ids)
    lora = step_kw.get("lora") is not None
    dec_kw, chunk_kw = dict(step_kw), dict(step_kw)
    if lora:
        dec_kw["lora_idx"] = batch.lora_idx
        chunk_kw["lora_idx"] = torch.full((GPT_CHUNK,), lora_ids[-1], dtype=torch.int32,
                                          device=DEV)

    def decode(plain, **over):
        h, _ = model.decode_step(cfg, params, model.embed(params, batch.ids), batch.pos,
                                 eng.caches, batch.block_table, batch.ctx, batch.slots,
                                 plain=plain, **{**dec_kw, **over})
        return head(h, plain)

    seq = (ps[2] + ps[1])[: 2 * GPT_CHUNK]
    page = cfg.page_size
    pages = eng.cm.alloc(2 * GPT_CHUNK // page)
    ids = torch.tensor(seq, dtype=torch.int32, device=DEV)
    bt = torch.zeros((1, GPT_PAGES_PER_REQ), dtype=torch.int32, device=DEV)
    bt[0, : len(pages)] = torch.tensor([int(p) for p in pages], dtype=torch.int32)
    pos = torch.arange(2 * GPT_CHUNK, device=DEV)
    slots = (bt[0, pos // page] * page + pos % page).to(torch.int32)
    sl = torch.tensor([GPT_CHUNK], dtype=torch.int32, device=DEV)

    def chunk(c, plain, **over):
        rows = slice(c * GPT_CHUNK, (c + 1) * GPT_CHUNK)
        ctx = torch.tensor([(c + 1) * GPT_CHUNK], dtype=torch.int32, device=DEV)
        h, _ = model.prefill_step(cfg, params, model.embed(params, ids[rows]), sl, eng.caches, bt,
                                  ctx, slots[rows], max_q=GPT_CHUNK, plain=plain,
                                  **{**chunk_kw, **over})
        return h

    chunk(0, False)                                 # the chunk's context, written once
    layers = cfg.num_layers
    w8 = step_kw.get("weights_q") is not None
    checks = [(f"{label} decode step (logits)", decode, n, True, attn_kernel),
              (f"{label} prefill chunk of {GPT_CHUNK} rows at context {2 * GPT_CHUNK} (hidden)",
               lambda plain, **over: chunk(1, plain, **over), GPT_CHUNK, False,
               "attention_sinks_prefill_pallas")]
    for label_, run, rows, logits, attn in checks:
        counters.reset()
        want_run = ((lambda: run(True)) if reference is None
                    else (lambda: run(False, **reference[1])))
        if routed:
            ok = compare_runs(label_, lambda: run(False), want_run, rows, logits=logits,
                              forced=True, model=model,
                              vs="plain versions" if reference is None else reference[0])
            launches = counters.read()
        else:
            got = run(False)[:rows].float()
            launches = counters.read()
            want = run(True)[:rows].float()
            if w8:
                with llama_base_kernels():
                    want_base = run(True)[:rows].float()
                ok = w8a8_verdict(label_, got, want, want_base, rows, logits, "K1, K5 and K7a")
            else:
                ok = routing_rule(label_, got, want, None, logits)
        # W8A8 on GPT-OSS's MoE: q / k / v / o on K1, their two quants on K5;
        # on Llama every projection: K1 six a layer, K5 three
        k1, k5 = (4, 2) if routed else (6, 3)
        want = {attn: layers, "quant_matmul": k1 * layers if w8 else 0,
                "quant_per_token": k5 * layers if w8 else 0,
                "bgmv_fused": 2 * layers if lora else 0,
                "grouped_matmul_float": 2 * layers if step_kw.get("ep_buffer") else 0}
        if not ok or (reference is None and any(launches[k] != v for k, v in want.items())):
            raise AssertionError(f"{label_}: the kernels disagree with the reference path (rule "
                                 f"held {ok}) or launched {launches}, want {want}")
    eng.cm.free(pages)
    return (lambda: decode(False)), (lambda: chunk(1, False))


def gpt_oss_step_checks(eng, params, ps, cfg=CFG_GPT, label="GPT-OSS", **step_kw):
    """:func:`step_checks` for GPT-OSS (its MoE routing replayed, the head's
    norm plain too)."""
    attn = "attention_sinks_packed" if cfg.packed_kv else "attention_sinks"
    return step_checks(eng, ps, g, cfg, params, label, attn, True,
                       lambda h, plain: g.lm_head(params, h, plain=plain), **step_kw)


def kv_scale_of(scales) -> float:
    """One int8 cache scale from ``w8a8.calibrate_kv_scales``: the largest of
    every layer's and kv head's, K and V, so that no level saturates."""
    return max(float(s.max()) for pair in scales for s in pair)


def gpt_oss_modes(params, eng_bf16, ps):
    """[4e]'s other modes: an ``Engine`` serve on the int8 cache (its
    ``kv_scale`` from ``calibrate_kv_scales`` over the bf16 serve's caches)
    and one on the packed bf16 cache; a decode step and a 512-row chunk on
    the packed int8 cache with the calibrated per-kv-head ``kv_scales``, and
    with W8A8 projections (``weights_q``), held to ``plain=True``.  Returns
    the packed serve's launch counts."""
    scales = w8a8.calibrate_kv_scales(eng_bf16.caches)
    cfg8 = dataclasses.replace(CFG_GPT, kv_cache_dtype="int8", kv_scale=kv_scale_of(scales))
    log(f"  int8 cache: kv_scale {cfg8.kv_scale:.5f} from calibrate_kv_scales over the bf16 "
        f"serve's caches (per-head K scales {float(scales[0][0].min()):.5f}-"
        f"{float(scales[0][0].max()):.5f} in layer 0)")
    gpt_oss_serve(params, cfg8)
    eng_p, _, launches_p = gpt_oss_serve(params, dataclasses.replace(CFG_GPT, packed_kv=True))
    del eng_p
    cfg_p8 = dataclasses.replace(CFG_GPT, packed_kv=True, kv_cache_dtype="int8")
    adapter = gpt_oss_adapter(cfg_p8, params)
    # the engine's own steps write and read the cache at the calibrated scales
    adapter.prefill_step = lambda x, sl, c, bt, ctx, slots, state_idx, lora_idx: g.prefill_step(
        cfg_p8, params, x, sl, c, bt, ctx, slots, max_q=x.shape[0], kv_scales=scales)
    adapter.decode_step = lambda x, pos, c, bt, ctx, slots, state_idx, lora_idx: g.decode_step(
        cfg_p8, params, x, pos, c, bt, ctx, slots, kv_scales=scales)
    eng_p8 = Engine(adapter, GPT_NUM_PAGES, max_batch=MAX_BATCH,
                    max_pages_per_req=GPT_PAGES_PER_REQ, prefill_chunk=GPT_CHUNK)
    gpt_oss_step_checks(eng_p8, params, ps, cfg_p8, "GPT-OSS (packed int8 cache, per-head "
                        "kv_scales)", kv_scales=scales)
    del eng_p8
    weights_q = g.quantize_weights(CFG_GPT, params)
    gpt_oss_step_checks(eng_bf16, params, ps, CFG_GPT, "GPT-OSS W8A8 (weights_q)",
                        weights_q=weights_q)
    return launches_p


def llama_serve(params, cfg, card, weights_q=None):
    """Serve [4e]'s prompts through ``Engine(prefill_chunk=512)`` +
    ``llama_adapter`` (a bf16 cache by default; int8 per ``cfg``): outputs,
    pages, radix reuse, the cache's type, and exact launch counts from the
    engine's own calls: K11a once a layer a decode call, K12d once a layer a
    prefill call, K6a twice a layer and once more (the final norm) a model
    call; with ``weights_q`` K1 six times a layer a model call, K5 three
    times, K7a once; nothing else.  Returns the engine, the prompts and the
    counts."""
    adapter = llama_adapter(cfg, params, weights_q=weights_q)
    timer = StepTimer(adapter)
    eng = Engine(adapter, GPT_NUM_PAGES, max_batch=MAX_BATCH, max_pages_per_req=GPT_PAGES_PER_REQ,
                 prefill_chunk=GPT_CHUNK)
    want_dt = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    if eng.caches[0][0].dtype != want_dt:
        raise AssertionError(f"the Llama cache is {eng.caches[0][0].dtype}, not {want_dt}")
    ps = prompts(torch.Generator().manual_seed(SEED + 6), GPT_PROMPT_LENS, (0, GPT_SHARED),
                 cfg.vocab_size)
    rids, wall, launches = run_requests(eng, ps, (0, GPT_SHARED), GPT_NUM_PAGES, cfg.vocab_size)
    n_pre, n_dec = timer.calls["prefill"], timer.calls["decode"]
    layers, calls = cfg.num_layers, n_pre + n_dec
    want = {k: 0 for k in launches}
    want.update({"attention_sinks_prefill_pallas": layers * n_pre, "decode_gqa": layers * n_dec,
                 "rms_norm": (2 * layers + 1) * calls})
    if weights_q is not None:
        want.update({"quant_matmul": 6 * layers * calls, "quant_per_token": 3 * layers * calls,
                     "swiglu_quant": layers * calls})
    if launches != want:
        raise AssertionError(f"launches {launches} over {n_pre} prefill and {n_dec} decode "
                             f"calls; want {want}")
    what = f"{cfg.kv_cache_dtype} cache{', W8A8' if weights_q is not None else ''}; {card}"
    log_serve(eng, rids, ps, wall, timer, what)
    log(f"  launches on the main path: "
        f"{json.dumps({k: v for k, v in launches.items() if v})} (every other kernel 0)")
    return eng, ps, launches


def llama_step_checks(eng, params, ps, cfg, label, **step_kw):
    """:func:`step_checks` for Llama (no routing; the head applies no norm)."""
    return step_checks(eng, ps, lm, cfg, params, label, "decode_gqa", False,
                       lambda h, plain: lm.lm_head(params, h), **step_kw)


def llama_lora_serve(params, lora, card):
    """Phase [4g]: [4f]'s prompts through ``Engine(prefill_chunk=512)`` +
    ``llama_adapter(lora=...)``, under adapters ``LORA_IDS`` (the two
    prompts that share 512 tokens both under adapter 0), then two further
    requests on the first prompt (in the radix from its adapter-0 request)
    under adapters 1 and 2.  Checks outputs and pages; that radix reuse
    happened among the adapter-0 requests and never for a LoRA request (the
    further requests find no cached token, where a radix keyed by tokens
    alone would hand them 1088); that the two adapters give the prompt
    different tokens; exact launch counts from the engine's own calls: K13a
    twice a layer a model call, K11a, K12d and K6a as [4f], nothing else.
    Returns the engine, the prompts and the counts."""
    cfg = CFG_LLAMA
    adapter = llama_adapter(cfg, params, lora=lora)
    timer = StepTimer(adapter)
    eng = Engine(adapter, GPT_NUM_PAGES, max_batch=MAX_BATCH, max_pages_per_req=GPT_PAGES_PER_REQ,
                 prefill_chunk=GPT_CHUNK)
    ps = prompts(torch.Generator().manual_seed(SEED + 6), GPT_PROMPT_LENS, (0, GPT_SHARED),
                 cfg.vocab_size)
    counters.reset()
    t0 = time.perf_counter()

    def drain():
        while eng.waiting or eng.running:
            eng.step()

    rids = [eng.add_request(p, NEW_TOKENS, lora_id=i) for p, i in zip(ps[:-1], LORA_IDS)]
    while not any(r.rid == rids[0] and r.pos >= r.prompt_len for r in eng.running) \
            and rids[0] not in eng.finished:
        eng.step()
    rids.append(eng.add_request(ps[-1], NEW_TOKENS, lora_id=LORA_IDS[-1]))
    drain()
    cached = eng.stats["cached_tokens"]
    pair = [eng.add_request(ps[0], NEW_TOKENS, lora_id=i) for i in (1, 2)]
    drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    outs = [eng.finished[r] for r in rids + pair]
    if not all(len(o) == NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in o) for o in outs):
        raise AssertionError(f"unfinished or invalid outputs: {[len(o) for o in outs]}")
    if eng.cm.free_pages + eng.cm.cached_pages != GPT_NUM_PAGES:
        raise AssertionError("KV pages leaked")
    if cached < GPT_SHARED or eng.stats["cached_tokens"] != cached:
        raise AssertionError(f"radix: {cached} cached tokens among the adapter-0 requests (want "
                             f">= {GPT_SHARED}), {eng.stats['cached_tokens'] - cached} for the "
                             "LoRA requests on a cached prompt (want 0)")
    if eng.finished[pair[0]] == eng.finished[pair[1]]:
        raise AssertionError("adapters 1 and 2 gave one prompt the same tokens")
    n_pre, n_dec = timer.calls["prefill"], timer.calls["decode"]
    layers, calls = cfg.num_layers, n_pre + n_dec
    want = {k: 0 for k in launches}
    want.update({"attention_sinks_prefill_pallas": layers * n_pre, "decode_gqa": layers * n_dec,
                 "rms_norm": (2 * layers + 1) * calls, "bgmv_fused": 2 * layers * calls})
    if launches != want:
        raise AssertionError(f"launches {launches} over {n_pre} prefill and {n_dec} decode "
                             f"calls; want {want}")
    log_serve(eng, rids + pair, ps + [ps[0]] * 2, wall, timer,
              f"adapters {LORA_IDS} + 1 and 2 on the first prompt; {card}")
    log(f"  radix: {cached} cached tokens among the adapter-0 requests, 0 for the LoRA "
        f"requests; adapters 1 / 2 on one prompt: {eng.finished[pair[0]][:6]} / "
        f"{eng.finished[pair[1]][:6]}")
    log(f"  launches on the main path: "
        f"{json.dumps({k: v for k, v in launches.items() if v})} (every other kernel 0)")
    return eng, ps, launches


def profile_steps(eng, batch, prompt, w8a8_step, long_prefill, dsa_prefill, dsa_decode,
                  gpt_decode, gpt_prefill, gpt_ep_decode, gpt_ep_prefill, llama_decode,
                  llama_prefill, lora_decode):
    """Device time by kernel of one decode call on the live batch, of one
    mixed engine tick (that decode plus a 64-token prefill chunk), of the
    fully W8A8 decode step on the same batch, of one 2048-token prefill call
    on the int8 latent cache (``long_prefill``), of one 2048-token DSA
    prefill call and one DSA decode step (page mode), of a GPT-OSS decode
    step and 512-row prefill call (all experts, then expert parallel), of a
    Llama decode step and 512-row
    prefill call, and of a Llama decode step under LoRA (rows of adapters
    0-3)."""
    regions = [("decode step (fused W8A8 prologue)", lambda: eng.decode_logits(batch))]
    eng.add_request(prompt, 1)
    regions.append(("mixed tick (decode + prefill chunk)", eng.step))
    regions.append(("fully W8A8 decode step", lambda: eng.decode_logits(batch, w8a8_step)))
    regions.append((f"{LONG_CHUNK}-token prefill call at context {2 * LONG_CHUNK}, int8 cache",
                    long_prefill))
    regions.append((f"DSA {LONG_CHUNK}-token prefill call at context {2 * LONG_CHUNK}, int8 "
                    "cache", dsa_prefill))
    regions.append(("DSA decode step (page mode), int8 cache", dsa_decode))
    regions.append(("GPT-OSS decode step (logits)", gpt_decode))
    regions.append((f"GPT-OSS {GPT_CHUNK}-row prefill call at context {2 * GPT_CHUNK}",
                    gpt_prefill))
    regions.append(("GPT-OSS EP decode step (logits)", gpt_ep_decode))
    regions.append((f"GPT-OSS EP {GPT_CHUNK}-row prefill call at context {2 * GPT_CHUNK}",
                    gpt_ep_prefill))
    regions.append(("Llama-3.1-8B decode step (logits)", llama_decode))
    regions.append((f"Llama-3.1-8B {GPT_CHUNK}-row prefill call at context {2 * GPT_CHUNK}",
                    llama_prefill))
    regions.append(("Llama-3.1-8B LoRA decode step (logits)", lora_decode))
    for label, fn in regions:
        rows, busy, wall = trace_profile.device_breakdown(fn)
        log(f"  {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f} %)")
        for name, ms, count in rows:
            log(f"    {ms:9.3f} ms  x{count:<4d} {name[:110]}")


# ---------------------------------------------------------------------------
# phase 4h: DeepSeek-V3 training on one GPU
# ---------------------------------------------------------------------------

def train_bound(b, s, h, ops_per_pair, row_bytes, key_bytes):
    """(ms, by) of a K14 kernel: ``ops_per_pair`` operations for each live
    (row, key) pair (B H S (S + 1) / 2 of them), ``row_bytes`` read or
    written once a (token, head) row and ``key_bytes`` a key."""
    pairs = b * h * s * (s + 1) // 2
    return bound(b * s * h * row_bytes + b * s * key_bytes, pairs * ops_per_pair, BF16_FLOPS)


def sdpa_backend(fn) -> str:
    """The CUDA kernels of one ``fn()`` (an SDPA call), the longest first: they
    name the backend PyTorch picked."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    return "; ".join(k[:60] for _, k in rows[:2])


def check_mla_train(gen, b, s, h, timed):
    """K14a, K14b and K14c against their plain versions on random bf16 inputs
    at ``[B, S, H]``: the output within 2e-2 + 2e-2 |plain|, the LSE 1e-4, dQ
    and dK within 1e-2 of the tensor's largest |value| plus 1e-4 (dS and P
    round to bf16 on both sides, a tie moved by an f32 ulp flips one; at S =
    1 the true dQ is 0 and both sides are f32 cancellation noise); each
    kernel also within those tolerances of its tiled mirror (the kernel's own
    walk: ``mla_flash_fwd_tiled_plain``, ``mla_flash_bwd_dq_tiled_plain``,
    ``mla_flash_bwd_dk_tiled_plain`` at the kernel's bands) and
    bit-identical over two calls.  ``timed``:
    each kernel, its plain version and SDPA over the latent || rope keys
    expanded to the heads (forward; backward for K14b + K14c together).
    Returns the three kernels' results."""
    r = lambda *sh: randn(gen, sh)  # noqa: E731
    x = (r(b, s, h, 512), r(b, s, h, 64), r(b, s, 512), r(b, s, 64))
    sc = CFG.sm_scale
    out, lse = mt.mla_flash_fwd(*x, sc)
    again = mt.mla_flash_fwd(*x, sc)
    out_p, lse_p = mt.mla_flash_fwd_plain(*x, sc)
    out_t, lse_t = mt.mla_flash_fwd_tiled_plain(*x, sc)
    do = r(b, s, h, 512)
    delta = (do.float() * out_p.float()).sum(-1)
    args = (*x, do, lse_p, delta, sc)
    dq, dq_p = mt.mla_flash_bwd_dq(*args), mt.mla_flash_bwd_dq_plain(*args)
    dk, dk_p = mt.mla_flash_bwd_dk(*args), mt.mla_flash_bwd_dk_plain(*args)
    grads_again = (*mt.mla_flash_bwd_dq(*args), *mt.mla_flash_bwd_dk(*args))
    bands = mt.dk_bands(b, s, h, torch.cuda.get_device_properties(DEV).multi_processor_count)
    grads_t = (*mt.mla_flash_bwd_dq_tiled_plain(*args),
               *mt.mla_flash_bwd_dk_tiled_plain(*args, bands))
    torch.cuda.synchronize()
    err_o, ok_o = attention_close(out, out_p)
    err_l = max_abs(lse, lse_p)
    err_ot, ok_ot = attention_close(out, out_t)
    err_lt = max_abs(lse, lse_t)
    same = (torch.equal(again[0], out) and torch.equal(again[1], lse)
            and all(torch.equal(a, w) for a, w in zip(grads_again, (*dq, *dk))))
    errs = {"dq": [max_abs(a, w) for a, w in zip(dq, dq_p)],
            "dk": [max_abs(a, w) for a, w in zip(dk, dk_p)]}
    err_t = [max_abs(a, w) for a, w in zip((*dq, *dk), grads_t)]
    ok_g = all(max_abs(a, w) <= 1e-2 * float(w.float().abs().max()) + 1e-4
               for a, w in zip((*dq, *dk) * 2, (*dq_p, *dk_p, *grads_t)))
    log(f"  mla_flash_* B={b} S={s} H={h}: out max|err| {err_o:.3e} (tol 2e-2 + 2e-2 |plain|), "
        f"lse {err_l:.3e} (tol 1e-4); dq_lat / dq_pe {errs['dq'][0]:.3e} / {errs['dq'][1]:.3e} "
        f"of max {float(dq_p[0].float().abs().max()):.3e} / "
        f"{float(dq_p[1].float().abs().max()):.3e}; dk_lat / dk_pe {errs['dk'][0]:.3e} / "
        f"{errs['dk'][1]:.3e} of max {float(dk_p[0].float().abs().max()):.3e} / "
        f"{float(dk_p[1].float().abs().max()):.3e} (tol 1e-2 of max + 1e-4); against the "
        f"tiled mirrors: out {err_ot:.3e}, lse {err_lt:.3e}, dq {err_t[0]:.3e} / "
        f"{err_t[1]:.3e}, dk {err_t[2]:.3e} / {err_t[3]:.3e} (K14c: {bands} bands a chunk); K14a-c "
        f"over two calls bit-identical: {same}")
    if not (ok_o and err_l <= 1e-4 and ok_g and ok_ot and err_lt <= 1e-4 and same):
        raise AssertionError("an MLA training kernel disagrees with its plain version")
    res = [dict(err=max(err_o, err_l)), dict(err=max(errs["dq"])), dict(err=max(errs["dk"]))]
    if not timed:
        return res
    kernels = [lambda: mt.mla_flash_fwd(*x, sc), lambda: mt.mla_flash_bwd_dq(*args),
               lambda: mt.mla_flash_bwd_dk(*args)]
    plains = [lambda: mt.mla_flash_fwd_plain(*x, sc), lambda: mt.mla_flash_bwd_dq_plain(*args),
              lambda: mt.mla_flash_bwd_dk_plain(*args)]
    # SDPA over q = latent || rope [B, H, S, 576] and the shared keys expanded
    # to the heads; its backward sums dK + dV into the one latent leaf
    q = torch.cat([x[0], x[1]], dim=-1).transpose(1, 2).detach().requires_grad_()
    kcat = torch.cat([x[2], x[3]], dim=-1)[:, None].detach().requires_grad_()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, kcat.expand(b, h, s, 576), kcat[..., :512].expand(b, h, s, 512), is_causal=True,
            scale=sc)

    with torch.no_grad():
        lib_fwd = time_ms(sdpa, 20)
        backend = sdpa_backend(sdpa)
    o = sdpa()
    do_h = do.transpose(1, 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(o, (q, kcat), do_h, retain_graph=True), 10)
    del o, q, kcat
    bounds = [train_bound(b, s, h, 2 * (576 + 512), 2 * 576 + 2 * 512 + 4, 2 * 576),
              train_bound(b, s, h, 2 * (576 + 512 + 576), 2 * 576 * 2 + 2 * 512 + 8, 2 * 576),
              train_bound(b, s, h, 2 * (576 + 512 + 576 + 512), 2 * 576 + 2 * 512 + 8,
                          2 * 576 * 2)]
    for i, name in enumerate(TRAIN_KERNELS):
        res[i].update(ms=time_ms(kernels[i], 20), plain_ms=time_ms(plains[i], 3),
                      library_ms=lib_fwd if i == 0 else lib_bwd, bound_ms=bounds[i][0],
                      bound_by=bounds[i][1])
        log(f"    {name}: {res[i]['ms']:.4f} ms (plain {res[i]['plain_ms']:.4f}, SDPA "
            f"{'forward' if i == 0 else 'backward (dQ + dK together)'} "
            f"{res[i]['library_ms']:.4f}, bound {res[i]['bound_ms']:.4f} {res[i]['bound_by']})")
    log(f"    SDPA's kernels (the backend PyTorch picked, forward): {backend}")
    return res


def dense_moe_serve(params, ps):
    """``Engine`` + ``deepseek_adapter(CFG_TRAIN, params)`` without
    ``moe_weights_q`` (the dense float MoE) serves ``ps``, 8 new tokens each,
    counts reset just before and read just after: K2 exactly once a layer a
    decode call, K9a once a layer a prefill call, no other kernel.  Then one
    decode step on a live batch held to ``plain=True``, the routing replayed."""
    adapter = deepseek_adapter(CFG_TRAIN, params, torch.bfloat16)
    timer = StepTimer(adapter)
    eng = Engine(adapter, NUM_PAGES, max_batch=MAX_BATCH, max_pages_per_req=MAX_PAGES_PER_REQ,
                 prefill_chunk=PREFILL_CHUNK)
    counters.reset()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, TRAIN_NEW_TOKENS) for p in ps]
    while eng.waiting or eng.running:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    outs = [eng.finished[r] for r in rids]
    if not all(len(o) == TRAIN_NEW_TOKENS and all(0 <= t < CFG.vocab_size for t in o)
               for o in outs):
        raise AssertionError(f"unfinished or invalid outputs: {outs}")
    if eng.cm.free_pages + eng.cm.cached_pages != NUM_PAGES:
        raise AssertionError("KV pages leaked")
    n_pre, n_dec = timer.calls["prefill"], timer.calls["decode"]
    want = {k: 0 for k in launches}
    want.update(decode_mla=CFG_TRAIN.num_layers * n_dec,
                mla_prefill_pallas=CFG_TRAIN.num_layers * n_pre)
    if launches != want:
        raise AssertionError(f"launches {launches} over {n_pre} prefill and {n_dec} decode "
                             f"calls; want {want}")
    dec_tokens = len(rids) * (TRAIN_NEW_TOKENS - 1)
    log(f"  served {len(rids)} requests (prompts {[len(p) for p in ps]}, {TRAIN_NEW_TOKENS} new "
        f"tokens each) in {wall:.2f} s wall; prefill {eng.stats['prefill_tokens']} tokens in "
        f"{n_pre} calls of {PREFILL_CHUNK} rows, {timer.t['prefill']:.3f} s = "
        f"{eng.stats['prefill_tokens'] / timer.t['prefill']:.1f} tok/s; decode {dec_tokens} "
        f"tokens in {n_dec} steps, {timer.t['decode']:.3f} s = "
        f"{dec_tokens / timer.t['decode']:.1f} tok/s; all pages returned")
    log(f"  launches: decode_mla {launches['decode_mla']}, mla_prefill_pallas "
        f"{launches['mla_prefill_pallas']}, every other kernel 0")
    batch, n = live_batch(eng, ps)
    ok = compare_runs("dense-MoE decode step", lambda: eng.decode_logits(batch),
                      lambda: eng.decode_logits(batch, decode_step_fn(params, None, CFG_TRAIN,
                                                                      plain=True)),
                      n, logits=True, forced=True)
    if not ok:
        raise AssertionError("the dense-MoE decode step disagrees with the plain path")


@contextlib.contextmanager
def routes(record, replay=None):
    """Record each layer's expert choice into ``record`` (``m._routed``), or
    hand out ``replay``'s instead: the replaying run weighs those experts with
    its own scores, so its gradients stay its own."""
    it = None if replay is None else iter(replay)
    routed = m._routed
    m._routed = lambda ids: record.append(ids if it is None else next(it)) or record[-1]
    try:
        yield
    finally:
        m._routed = routed


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}.{k}" if prefix
                                                                  else k)]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix] if isinstance(tree, torch.Tensor) else []


def leaf_diff(host, g, piece=1 << 26):
    """``(max |host - g|, max |g|)`` of a gradient leaf on the host and one on
    the card, about ``piece`` elements at a time along the first dimension
    (an expert leaf is 7.5 GB in bf16, twice that in f32)."""
    step = max(1, g.shape[0] * piece // g.numel())
    diff = top = 0.0
    for i in range(0, g.shape[0], step):
        b = g[i : i + step].float()
        diff = max(diff, float((host[i : i + step].to(DEV).float() - b).abs().max()))
        top = max(top, float(b.abs().max()))
    return diff, top


def compare_grads(label, loss_f, grads_f, params, tokens, chosen, tol, what="flash step", **kw):
    """The ``what`` step's loss and gradients (``grads_f``, on the host)
    against ``loss_and_grads(**kw)`` on the same params and tokens with the
    first run's routing replayed: per leaf max |Δ| / max |g|, held to
    ``tol``; the loss to 1e-2 relative."""
    with routes([], chosen):
        loss, grads = m.loss_and_grads(CFG_TRAIN, params, tokens, **kw)
    names, rels = leaf_names(grads), []
    for name, gf, g in zip(names, m._flatten(grads_f), m._flatten(grads)):
        diff, top = leaf_diff(gf, g)
        rels.append((name, diff / top if top else None))
    del grads
    loss_rel = abs(float(loss_f) - float(loss)) / abs(float(loss))
    worst = max(r for _, r in rels if r is not None)
    log(f"  {what} vs {label}: loss {float(loss_f):.6f} vs {float(loss):.6f} (rel "
        f"{loss_rel:.2e}, tol 1e-2); per-leaf max|Δ| / max|g| (tol {tol}): "
        + ", ".join(f"{n} {'unreached' if r is None else f'{r:.2e}'}" for n, r in rels))
    if loss_rel > 1e-2 or worst > tol:
        raise AssertionError(f"the {what} disagrees with the {label} run: worst leaf "
                             f"{worst:.3e}, loss {loss_rel:.3e}")
    return worst


COPY_OPS = ("aten::copy_", "aten::clone", "aten::contiguous", "aten::_to_copy")


def expert_copies(fn, shapes) -> list:
    """The copy operators of one ``fn()`` whose input has an expert weight's
    shape (profiler shapes), as ``(op, shapes, count)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.input_shapes, e.count)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key in COPY_OPS and any(list(sh) in shapes for sh in e.input_shapes)]


def training_phase():
    """Phases [4h] and, on its weights, [4j] (see the module docstring).
    Returns the three K14 results, the [4h] steps' launch counts, K8a's bf16
    modes' results and the [4j] steps' launch counts."""
    torch.cuda.reset_peak_memory_stats()
    log(f"[4h] DeepSeek-V3 training on one GPU: {CFG_TRAIN.num_layers} of {FULL_LAYERS} layers, "
        f"bf16, B x S = {TRAIN_B} x {TRAIN_S}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated on the card at the start")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    k14 = check_mla_train(gen, TRAIN_B, TRAIN_S, CFG.num_heads, True)
    for b, s, h in TRAIN_SMALL:
        check_mla_train(gen, b, s, h, False)

    t0 = time.perf_counter()
    params = m.init_weights(CFG_TRAIN, SEED, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in m._flatten(params))
    log(f"  weights: {n_params / 1e9:.2f} B parameters in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")

    ps = sorted(prompts(torch.Generator().manual_seed(SEED)), key=len)[:3]
    log(f"  the dense float MoE: Engine + deepseek_adapter(CFG_TRAIN, params), no moe_weights_q")
    dense_moe_serve(params, ps)
    gc.collect()
    torch.cuda.empty_cache()

    tokens = torch.randint(0, CFG.vocab_size, (TRAIN_B, TRAIN_S),
                           generator=torch.Generator().manual_seed(SEED + 12)).to(DEV)
    chosen = []
    with routes(chosen):
        loss_f, grads = m.loss_and_grads(CFG_TRAIN, params, tokens, flash=True)
    grads_f = [g.cpu() for g in m._flatten(grads)]            # the host holds them
    del grads
    worst_p = compare_grads("plain K14a-c (plain=True)", loss_f, grads_f, params, tokens, chosen,
                            TRAIN_TOL_PLAIN, flash=True, plain=True)
    worst_d = compare_grads("dense attention (flash=False)", loss_f, grads_f, params, tokens,
                            chosen, TRAIN_TOL_DENSE, flash=False)
    del grads_f

    step = m.make_train_step(CFG_TRAIN, None, flash=True)
    counters.reset()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, tokens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = counters.read()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a training loss is not finite: {losses}")
    want = {k: TRAIN_STEPS * CFG_TRAIN.num_layers if k in TRAIN_KERNELS else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"launches over {TRAIN_STEPS} training steps {launches}; want "
                             f"{want}")
    log(f"  {TRAIN_STEPS} SGD steps of make_train_step(flash=True): losses "
        + ", ".join(f"{v:.6f}" for v in losses)
        + f"; step ms {', '.join(f'{t:.1f}' for t in times)} (host clock, synchronized) = "
        f"{TRAIN_B * TRAIN_S / (statistics.median(times) / 1e3):.1f} tokens/s at the median; "
        f"launches {', '.join(f'{k} {launches[k]}' for k in TRAIN_KERNELS)}, every other "
        f"kernel 0; worst leaf vs plain {worst_p:.2e}, vs dense {worst_d:.2e}")

    state = {"params": params}
    del params

    def one_step():
        state["params"], state["loss"] = step(state["params"], tokens)

    rows, busy, wall = trace_profile.device_breakdown(one_step)
    log(f"  one training step under torch.profiler: wall {wall:.3f} ms, device busy {busy:.3f} "
        f"ms ({100 * busy / wall:.1f} %)")
    for name, ms, count in rows:
        log(f"    {ms:9.3f} ms  x{count:<4d} {name[:110]}")
    e, h, i = CFG.num_experts, CFG.hidden, CFG.moe_intermediate
    copies = expert_copies(one_step, [[e, h, i], [e, i, h]])
    if copies:
        raise AssertionError(f"a training step copies expert weights: {copies}")
    log(f"  no copy operator ({', '.join(COPY_OPS)}) takes a tensor of an expert weight's "
        f"shape in a training step; peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
        f"allocated on the card in [4h]")
    k8f, k8dx, launches_ep = ep_training_phase(state.pop("params"), tokens)
    return k14, launches, (k8f, k8dx), launches_ep


# ---------------------------------------------------------------------------
# phases 4i / 4j: the expert-parallel MoE on a one-rank NCCL group
# ---------------------------------------------------------------------------

def ep_group():
    """A one-rank NCCL group over an in-process store (no network): the EP
    group of [4i] and, as a ("dp", "ep") DeviceMesh, of [4j].  The exchange
    really runs: ``all_to_all_single`` on NCCL.  One exchange here makes the
    communicator (set-up, not a serve's time)."""
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    t0 = time.perf_counter()
    ep_core.all_to_all(torch.zeros((1, 8), device=DEV), dist.group.WORLD)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def grouped_library(x, w, gs, contract_last):
    """One PyTorch call computing K8a's bf16 products (bf16 out), the
    yardstick: ``torch._grouped_mm`` where the card's torch has it, else a
    loop of ``torch.matmul`` over the groups.  Returns ``(fn, name)``."""
    wt = w.transpose(1, 2) if contract_last else w                 # [G, K, N]
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        fn = lambda: torch._grouped_mm(x, wt, offs=offs)  # noqa: E731
        try:
            fn()
            torch.cuda.synchronize()
            return fn, "torch._grouped_mm"
        except (RuntimeError, TypeError, ValueError) as e:   # the yardstick only, not the port
            log(f"    torch._grouped_mm refuses this layout ({str(e)[:120]}); the yardstick is "
                "a loop of torch.matmul")
    groups = list(grouped_matmul._group_slices(gs))

    def loop():
        out = torch.empty((x.shape[0], wt.shape[2]), dtype=x.dtype, device=DEV)
        for g_, rs in groups:
            torch.matmul(x[rs], wt[g_], out=out[rs])
        return out

    return loop, "a loop of torch.matmul over the groups"


def check_grouped_bf16(label, x, w, gs, contract_last, timed):
    """K8a's ``none`` (``w [G, K, N]``) or ``rhs_contract_last`` (``w [G, N,
    K]``) mode on bf16 ``x [S, K]`` against its plain version: f32 outputs
    within ``EP_TOL`` of the largest |value| (f32 sums of exact bf16
    products in another order), rows past the total exactly 0.  ``timed``:
    the kernel, its plain version and the library call, and the bound (the
    rows in groups read once, the touched experts' weights once, the f32
    output written once; 2 S K N bf16 operations)."""
    fn = grouped_matmul.grouped_matmul_dx if contract_last else grouped_matmul.grouped_matmul_float
    plain = lambda: grouped_matmul.grouped_matmul_float_plain(  # noqa: E731
        x, w, gs, rhs_contract_last=contract_last)
    y, y_p = fn(x, w, gs), plain()
    torch.cuda.synchronize()
    total, err, top = int(gs.sum()), max_abs(y, y_p), float(y_p.abs().max())
    ok = err <= EP_TOL * top and not y[total:].any()
    s, k = x.shape
    n = y.shape[1]
    log(f"  {fn.__name__} {label}: x [{s}, {k}] x w {list(w.shape)}, groups of "
        f"{int(gs.min())}-{int(gs.max())} rows ({total} in all), max|err| {err:.3e} of max "
        f"{top:.3e} (tol {EP_TOL} of max), rows past the total zero: {not y[total:].any()}")
    if not ok:
        raise AssertionError(f"{fn.__name__} disagrees with its plain version: {label}")
    res = dict(err=err)
    if not timed:
        return res
    lib, lib_name = grouped_library(x, w, gs, contract_last)
    touched = int((gs > 0).sum())
    res.update(ms=time_ms(lambda: fn(x, w, gs), 10), plain_ms=time_ms(plain, 2),
               library_ms=time_ms(lib, 10))
    res["bound_ms"], res["bound_by"] = bound(total * k * 2 + touched * k * n * 2 + s * n * 4,
                                             2 * total * k * n, BF16_FLOPS)
    log(f"    {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}, {lib_name} {res['library_ms']:.4f}, "
        f"bound {res['bound_ms']:.4f} {res['bound_by']})")
    return res


def check_grouped_bf16_small(gen):
    """K8a's bf16 modes on ragged cases: an empty group, a group of one row,
    groups of one and of more than one 128-row work item, K past a 64-element
    stage, N = 2880 (a half 128-column tile), and a total below S."""
    for sizes, s, k, n in (((0, 1, 37, 0, 64, 65), 190, 520, 384), ((0, 0, 1), 5, 64, 136),
                           ((3, 0, 70, 9), 100, 336, 160), ((129, 0, 257, 3), 400, 520, 2880)):
        gs = torch.tensor(sizes, dtype=torch.int32, device=DEV)
        x = randn(gen, (s, k))
        for contract_last in (False, True):
            w = randn(gen, (len(sizes), n, k) if contract_last else (len(sizes), k, n))
            check_grouped_bf16(f"ragged (groups {list(sizes)}, S {s})", x, w, gs, contract_last,
                               False)


def gpt_oss_ep_phase(params):
    """Phase [4i] (see the module docstring).  Returns K8a ``none``'s JSON
    numbers (a layer's two products at a 512-token chunk), the serve's
    launch counts and the EP decode step and chunk for the profile."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    lw, cfg = params["layers"][0], CFG_GPT
    gs, _, _ = routing(gen, GPT_CHUNK, cfg.topk, cfg.num_experts)
    rows = GPT_CHUNK * cfg.topk
    prods = [check_grouped_bf16(f"gate | up at a {GPT_CHUNK}-token chunk",
                                randn(gen, (rows, cfg.hidden)), lw["w_gate_up"], gs, False, True),
             check_grouped_bf16(f"down at a {GPT_CHUNK}-token chunk",
                                randn(gen, (rows, cfg.intermediate)), lw["w_down"], gs, False,
                                True)]
    check_grouped_bf16_small(gen)
    k8f = summed(f"grouped_matmul_float, a GPT-OSS-20B layer's 2 products at a {GPT_CHUNK}-token "
                 "chunk", prods)
    buf = Buffer(None, num_experts=cfg.num_experts, config=EPConfig())
    drops, fused = [], buf.fused_oai_moe

    def recording(*args, **kw):
        out = fused(*args, **kw)
        drops.append(out[2])
        return out

    buf.fused_oai_moe = recording
    a2a = ep_core.all_to_all.calls
    eng, ps, launches = gpt_oss_serve(params, ep_buffer=buf)
    a2a = ep_core.all_to_all.calls - a2a
    dropped = int(torch.stack(drops).sum())
    # a MoE call: the counts, the rows and their slots out, the rows back
    if a2a == 0 or a2a != 2 * launches["grouped_matmul_float"] or dropped:
        raise AssertionError(f"EP serve: {a2a} all-to-all calls for "
                             f"{launches['grouped_matmul_float']} K8a launches, {dropped} drops")
    log(f"  {a2a} all_to_all_single calls on the NCCL group over {len(drops)} MoE calls; "
        f"num_dropped 0 in every call")
    decode, prefill = gpt_oss_step_checks(eng, params, ps, label="GPT-OSS EP", ep_buffer=buf)
    gpt_oss_step_checks(eng, params, ps, label="GPT-OSS EP", ep_buffer=buf,
                        reference=("the all-experts path ([4e]'s)", {"ep_buffer": None}))
    return k8f, launches, decode, prefill


def ep_train_kernel_checks(lw):
    """K8a's bf16 modes at a DeepSeek-V3 training layer's shapes (8320 rows of
    top-8 routing over 256 experts) on its expert weights ``lw``: the three
    forward products and the three dx.  A function of its own, so that no
    reference to this layer's weights outlives it (the steps that follow
    replace them)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 14)
    c = CFG_TRAIN
    gs, _, _ = routing(gen, TRAIN_B * TRAIN_S, c.topk, c.num_experts)
    rows = TRAIN_B * TRAIN_S * c.topk
    xh, xi = randn(gen, (rows, c.hidden)), randn(gen, (rows, c.moe_intermediate))
    fwd = [check_grouped_bf16("gate", xh, lw["w_gate"], gs, False, True),
           check_grouped_bf16("up", xh, lw["w_up"], gs, False, True),
           check_grouped_bf16("down", xi, lw["w_down"], gs, False, True)]
    dx = [check_grouped_bf16("dx through gate", xi, lw["w_gate"], gs, True, True),
          check_grouped_bf16("dx through up", xi, lw["w_up"], gs, True, True),
          check_grouped_bf16("dx through down", xh, lw["w_down"], gs, True, True)]
    return (summed("grouped_matmul_float, a DeepSeek-V3 training layer's 3 forward products",
                   fwd),
            summed("grouped_matmul_dx, a DeepSeek-V3 training layer's 3 dx products", dx))


def ep_training_phase(params, tokens):
    """Phase [4j] (see the module docstring), on [4h]'s weights.  Returns
    K8a's JSON numbers (a layer's three forward products, its three dx
    products) and the steps' launch counts."""
    torch.cuda.reset_peak_memory_stats()
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "ep"))
    log(f"[4j] DeepSeek-V3 training expert parallel: make_train_step(CFG_TRAIN, mesh, "
        f"flash=True) on a one-rank {mesh.mesh_dim_names} DeviceMesh over NCCL, [4h]'s weights "
        f"and tokens; {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card at the start")
    k8f, k8dx = ep_train_kernel_checks(params["layers"][0])
    c = CFG_TRAIN
    chosen = []
    with routes(chosen):
        loss_e, grads = m.loss_and_grads(c, params, tokens, mesh=mesh, flash=True)
    grads_e = [g_.cpu() for g_ in m._flatten(grads)]           # the host holds them
    del grads
    worst = compare_grads("the same step on the dense MoE (mesh=None)", loss_e, grads_e, params,
                          tokens, chosen, TRAIN_TOL_DENSE, what="EP step", flash=True)
    del grads_e

    step = m.make_train_step(c, mesh, flash=True)
    counters.reset()
    a2a = ep_core.all_to_all.calls
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, tokens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = counters.read()
    a2a = ep_core.all_to_all.calls - a2a
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"an EP training loss is not finite: {losses}")
    per = TRAIN_STEPS * c.num_layers
    want = {k: 0 for k in launches}
    want.update({k: per for k in TRAIN_KERNELS})
    want.update({k: 3 * per for k in EP_KERNELS})
    if launches != want or a2a == 0:
        raise AssertionError(f"launches over {TRAIN_STEPS} EP training steps {launches}, "
                             f"{a2a} all-to-all calls; want {want}")
    log(f"  {TRAIN_STEPS} SGD steps of make_train_step(CFG_TRAIN, mesh, flash=True): losses "
        + ", ".join(f"{v:.6f}" for v in losses)
        + f"; step ms {', '.join(f'{t:.1f}' for t in times)} (host clock, synchronized) = "
        f"{TRAIN_B * TRAIN_S / (statistics.median(times) / 1e3):.1f} tokens/s at the median; "
        f"launches {', '.join(f'{k} {launches[k]}' for k in TRAIN_KERNELS + EP_KERNELS)}, every "
        f"other kernel 0; {a2a} all_to_all_single calls; worst leaf vs the dense MoE "
        f"{worst:.2e}")
    state = {"params": params}
    del params

    def one_step():
        state["params"], state["loss"] = step(state["params"], tokens)

    rows_, busy, wall = trace_profile.device_breakdown(one_step)
    log(f"  one EP training step under torch.profiler: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f} %)")
    for name, ms, count in rows_:
        log(f"    {ms:9.3f} ms  x{count:<4d} {name[:110]}")
    e, h, i = c.num_experts, c.hidden, c.moe_intermediate
    copies = expert_copies(one_step, [[e, h, i], [e, i, h]])
    if copies:
        raise AssertionError(f"an EP training step copies expert weights: {copies}")
    log(f"  no copy operator takes a tensor of an expert weight's shape in an EP step; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB allocated on the card in [4j]")
    return k8f, k8dx, launches



# ---------------------------------------------------------------------------
# phase 4k: DeepSeek-V3 W8A8 served expert parallel on the one-sided window
# transport (K15a-c, K16b)
# ---------------------------------------------------------------------------

# launches a MoE call on the window transport (JAX's ep_core.py:298-336, :442-498)
EP_DEEP_CALL = {"pallas_ragged_all_to_all": 3, "pallas_all_to_all": 1, "grouped_matmul": 2,
                "quant_per_token": 1}
EP_DEEP_TOL = 1e-2                             # K16b vs plain: a row's largest |value|
EP_DEEP_REL_MEAN = 4e-4                        # K16b vs the unfused form (JAX's bar)


def a2a_bytes_bound(live_bytes):
    """A window all-to-all's bound on one rank: its live bytes read once and
    written once at the HBM rate."""
    return bound(2 * live_bytes, 0, INT8_OPS)


def collective_ms(x, group):
    """``all_to_all_single`` of ``x`` on the NCCL group: the yardstick."""
    out = torch.empty_like(x)
    return time_ms(lambda: dist.all_to_all_single(out, x, group=group), 10)


def check_window_a2a(gen, group, label, rows, width, counts_list, timed):
    """K15b on ``[1, rows, width]`` int8 (a dispatch payload) and on its
    ``[1, rows, 2]`` int32 slot / scale blob, each ragged count of
    ``counts_list``, against its plain version (``all_to_all_single``):
    bit-exact on the live rows and counts.  ``timed``: the full count, the
    kernel, its plain version, the collective (``library_ms``) and a
    ``Tensor.copy_`` of the same bytes (logged)."""
    x = torch.randint(-128, 128, (1, rows, width), generator=gen, device=DEV).to(torch.int8)
    blob = torch.randint(-2**30, 2**30, (1, rows, 2), generator=gen, device=DEV).to(torch.int32)
    for payload in (x, blob):
        for count in counts_list:
            c = torch.tensor([count], dtype=torch.int32, device=DEV)
            got, rc = pallas_a2a.pallas_ragged_all_to_all(payload, c, group=group)
            want, wrc = pallas_a2a.pallas_ragged_all_to_all_plain(payload, c, group=group)
            torch.cuda.synchronize()
            if not (torch.equal(rc, wrc) and int(rc[0]) == count
                    and torch.equal(got[0, :count], want[0, :count])):
                raise AssertionError(f"pallas_ragged_all_to_all disagrees with its plain version: "
                                     f"{label}, {tuple(payload.shape)}, count {count}")
    log(f"  pallas_ragged_all_to_all {label}: [1, {rows}, {width}] int8 and its [1, {rows}, 2] "
        f"int32 blob at counts {counts_list}: live rows and counts bit-exact")
    if not timed:
        return None
    c = torch.tensor([rows], dtype=torch.int32, device=DEV)
    res = dict(err=0.0, ms=time_ms(lambda: pallas_a2a.pallas_ragged_all_to_all(x, c, group=group),
                                   10),
               plain_ms=time_ms(lambda: pallas_a2a.pallas_ragged_all_to_all_plain(
                   x, c, group=group), 5),
               library_ms=collective_ms(x, group))
    res["bound_ms"], res["bound_by"] = a2a_bytes_bound(x.numel())
    out = torch.empty_like(x)
    copy_ms = time_ms(lambda: out.copy_(x), 10)
    log(f"    {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}, all_to_all_single "
        f"{res['library_ms']:.4f}, Tensor.copy_ {copy_ms:.4f}, bound {res['bound_ms']:.4f} "
        f"{res['bound_by']}: {x.numel() / 1e6:.1f} MB read and written once)")
    return res


def check_window_fixed(group, label, x, timed):
    """K15a on ``x [1, ...]`` against ``all_to_all_single``: bit-exact."""
    got = pallas_a2a.pallas_all_to_all(x, group=group)
    want = pallas_a2a.pallas_all_to_all_plain(x, group=group)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"pallas_all_to_all disagrees with its plain version: {label}")
    nbytes = x.numel() * x.element_size()
    blocks = pallas_a2a.a2a_blocks(x.shape[0], nbytes // x.shape[0], pallas_a2a.FIXED_CHUNK)
    grid = ("one block" if blocks == 1 else
            f"{blocks} chunks of {pallas_a2a.FIXED_CHUNK >> 10} KB over a co-resident grid")
    log(f"  pallas_all_to_all {label}: {list(x.shape)} {x.dtype} ({grid}) bit-exact")
    if not timed:
        return None
    res = dict(err=0.0, ms=time_ms(lambda: pallas_a2a.pallas_all_to_all(x, group=group), 10),
               plain_ms=time_ms(lambda: pallas_a2a.pallas_all_to_all_plain(x, group=group), 5),
               library_ms=collective_ms(x, group))
    res["bound_ms"], res["bound_by"] = a2a_bytes_bound(nbytes)
    log(f"    {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}, all_to_all_single "
        f"{res['library_ms']:.4f}, bound {res['bound_ms']:.6f} {res['bound_by']})")
    return res


def check_monitored(gen, group, rows, width):
    """K15c: without a fault the rows and counts of K15b, statistics with no
    timeout (col 3 = col 0, cols 1, 2, 4, 5 zero); this rank muted
    (``inject_send_fault``) with 2000 polls: the call returns with the
    timeout and missing-payload flags set and count 0.  Timed on the full
    count."""
    x = torch.randint(-128, 128, (1, rows, width), generator=gen, device=DEV).to(torch.int8)
    c = torch.tensor([rows - 3], dtype=torch.int32, device=DEV)
    got, rc, st = pallas_a2a.pallas_ragged_all_to_all(x, c, group=group, monitor=True)
    torch.cuda.synchronize()
    ok = (int(rc[0]) == rows - 3 and torch.equal(got[0, :rows - 3], x[0, :rows - 3])
          and int(st[0, 3]) == int(st[0, 0]) and not st[0, [1, 2, 4, 5]].any())
    t0 = time.perf_counter()
    _, rc_f, st_f = pallas_a2a.pallas_ragged_all_to_all(x, c, group=group, monitor=True,
                                                        max_poll_rounds=2000,
                                                        inject_send_fault=True)
    torch.cuda.synchronize()
    fault_s = time.perf_counter() - t0
    ok = ok and int(rc_f[0]) == 0 and st_f[0].tolist() == [2000, 1, 0, 2000, 1, 0]
    log(f"  pallas_ragged_all_to_all(monitor=True) [1, {rows}, {width}] int8: no fault, stats "
        f"{st[0].tolist()}; muted (inject_send_fault, max_poll_rounds 2000): returned in "
        f"{fault_s * 1e3:.2f} ms, stats {st_f[0].tolist()}, count {int(rc_f[0])}")
    if not ok:
        raise AssertionError("pallas_ragged_all_to_all(monitor=True) is wrong")
    full = torch.tensor([rows], dtype=torch.int32, device=DEV)
    res = dict(err=0.0, ms=time_ms(lambda: pallas_a2a.pallas_ragged_all_to_all(
        x, full, group=group, monitor=True), 10),
        plain_ms=time_ms(lambda: pallas_a2a.pallas_ragged_all_to_all_plain(
            x, full, group=group, monitor=True), 5), library_ms=collective_ms(x, group))
    res["bound_ms"], res["bound_by"] = a2a_bytes_bound(x.numel())
    log(f"    {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}, all_to_all_single "
        f"{res['library_ms']:.4f}, bound {res['bound_ms']:.4f} {res['bound_by']})")
    return res


def deep_routing(gen, n_tok, n_exp=CFG.num_experts, topk=CFG.topk):
    """Random top-k routing (DeepSeek-V3's top-8 of 256 by default) with
    sum-one weights."""
    idx = torch.topk(torch.rand((n_tok, n_exp), generator=gen, device=DEV),
                     topk, dim=-1).indices.to(torch.int32)
    w = torch.rand((n_tok, topk), generator=gen, device=DEV)
    return idx, w / w.sum(-1, keepdim=True)


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bits."""
    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def fused_full_walk(buf, x, idx, w, moe, pack_tn=None):
    """K16b's tiled walk (``fused_full.fused_deep_moe_full_tiled_plain``) on
    the card, on the kernel path's wire quant and layout: its operations
    are the kernel's, so the kernel must equal it bit for bit."""
    seg = max(buf.config.num_max_dispatch_tokens_per_rank, x.shape[0])
    _, lay = fused_full.full_layout(idx, group=buf.group, num_experts=buf.num_experts,
                                    num_ranks=1, seg_capacity=seg)
    return fused_full.fused_deep_moe_full_tiled_plain(*quant.wire_quant(x), w, *moe, lay,
                                                      tn=pack_tn, group=buf.group)


def check_fused_full(gen, group, moe, n_tok, timed, walk=False, topk=CFG.topk,
                     gmm_moe=True):
    """K16b on one layer's experts at ``n_tok`` tokens of random top-k
    routing over all of ``moe``'s experts, against its plain version (counts
    and drops exact, ``combined`` within ``EP_DEEP_TOL`` of a row's largest
    |value|) and the unfused
    ``fused_deep_moe`` on the window transport (relative mean difference
    below ``EP_DEEP_REL_MEAN``); a call on other rows (the other window half)
    held to its plain version, then the first rows again (the first call's
    half, two epochs on) bit-identical to the first call; ``walk``: the
    first call bit-equal to its tiled walk.  ``timed``: K16b, its plain
    version, the unfused form (all its launches) and ``_gmm_moe`` on the
    same rows; the bound is the touched experts' weights and scales read
    once, the rows read and the output written once, against the GEMMs'
    int8 operations.  ``gmm_moe``: also time DeepSeek-V3's single-GPU
    ``_gmm_moe`` (its config's experts and top-k)."""
    n_exp, hidden = moe[0].shape[:2]
    x = randn(gen, (n_tok, hidden))
    idx, w = deep_routing(gen, n_tok, n_exp, topk)
    buf = Buffer(group, n_exp, EPConfig(comm_backend="pallas_ragged"))
    got, cnt, drop = buf.fused_deep_moe(x, idx, w, *moe, single_kernel=True)
    want, wcnt, wdrop = buf.fused_deep_moe(x, idx, w, *moe, single_kernel=True, plain=True)
    unf, ucnt, udrop = buf.fused_deep_moe(x, idx, w, *moe)
    x2 = randn(gen, (n_tok, hidden))
    idx2, w2 = deep_routing(gen, n_tok, n_exp, topk)
    other = buf.fused_deep_moe(x2, idx2, w2, *moe, single_kernel=True)[0]
    other_p = buf.fused_deep_moe(x2, idx2, w2, *moe, single_kernel=True, plain=True)[0]
    again = buf.fused_deep_moe(x, idx, w, *moe, single_kernel=True)[0]
    bit = torch.equal(got, fused_full_walk(buf, x, idx, w, moe)) if walk else None
    torch.cuda.synchronize()
    row_err = lambda a, b: float(((a.float() - b.float()).abs().amax(-1)  # noqa: E731
                                  / b.float().abs().amax(-1)).max())
    err, err_o = row_err(got, want), row_err(other, other_p)
    rel = rel_mean(got, unf)
    touched = int((cnt > 0).sum())
    exact = torch.equal(cnt, wcnt) and torch.equal(cnt, ucnt)
    same = torch.equal(got, again)
    log(f"  fused_deep_moe_full_rank {n_tok} tokens x top-{topk} over {touched} of {n_exp} "
        f"experts: vs plain "
        f"max row rel err {err:.3e} (tol {EP_DEEP_TOL}); vs unfused rel mean diff {rel:.3e} "
        f"(tol {EP_DEEP_REL_MEAN}); counts exact {exact}, drops {int(drop)}/{int(wdrop)}/"
        f"{int(udrop)}; other rows vs plain {err_o:.3e}, the first rows again bit-identical "
        f"{same}; bit-equal to its tiled walk {bit}; digest {digest(got)}")
    if not (err <= EP_DEEP_TOL and err_o <= EP_DEEP_TOL and rel < EP_DEEP_REL_MEAN and exact
            and same and bit is not False and int(drop) == int(wdrop) == int(udrop) == 0
            and bool(torch.isfinite(got.float()).all())):
        raise AssertionError(f"fused_deep_moe_full_rank is wrong at {n_tok} tokens")
    if not timed:
        return None
    w1, s1, w2_, s2 = moe
    h, n1 = w1.shape[1], w1.shape[2]
    i = n1 // 2
    rows = int(cnt.sum())
    res = dict(err=err, library_ms=None,
               ms=time_ms(lambda: buf.fused_deep_moe(x, idx, w, *moe, single_kernel=True), 5),
               plain_ms=time_ms(lambda: buf.fused_deep_moe(x, idx, w, *moe, single_kernel=True,
                                                           plain=True), 2))
    res["bound_ms"], res["bound_by"] = bound(
        touched * (h * n1 + i * h + 4 * (n1 + h)) + n_tok * h * 2 * 2,
        2 * rows * (h * n1 + i * h), INT8_OPS)
    res["unfused_ms"] = time_ms(lambda: buf.fused_deep_moe(x, idx, w, *moe), 5)
    gmm = ""
    if gmm_moe:
        res["gmm_moe_ms"] = time_ms(lambda: m._gmm_moe(CFG, moe, x, idx, w), 5)
        gmm = f"; single-GPU _gmm_moe {res['gmm_moe_ms']:.4f}"
    log(f"    {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}; unfused fused_deep_moe "
        f"{res['unfused_ms']:.4f}{gmm}; bound {res['bound_ms']:.4f} {res['bound_by']}: "
        f"{touched} experts' weights read once)")
    return res


def deepseek_ep_phase(params, moe, mla_wq, eng_q):
    """Phase [4k] (see the module docstring).  Returns the four kernels'
    JSON numbers and their launches on their paths."""
    group = dist.group.WORLD
    gen = torch.Generator(device=DEV).manual_seed(SEED + 17)
    layers = CFG.num_layers
    rows_chunk = LONG_CHUNK * CFG.topk
    k15b = check_window_a2a(gen, group, f"at a {LONG_CHUNK}-token chunk's dispatch", rows_chunk,
                            CFG.hidden, [0, 1, 12345, rows_chunk], True)
    check_window_a2a(gen, group, "at a decode step's dispatch", MAX_BATCH * CFG.topk, CFG.hidden,
                     [0, 5, MAX_BATCH * CFG.topk], False)
    counts = torch.randint(0, 64, (1, CFG.num_experts), generator=gen, device=DEV,
                           dtype=torch.int32)
    k15a = check_window_fixed(group, "the per-expert counts", counts, True)
    check_window_fixed(group, "just past one block", torch.randint(
        -2**30, 2**30, (1, 17, 1024), generator=gen, device=DEV, dtype=torch.int32), False)
    big = torch.randint(-128, 128, (1, rows_chunk, CFG.hidden), generator=gen,
                        device=DEV).to(torch.int8)
    check_window_fixed(group, f"a {LONG_CHUNK}-token chunk's payload (the 'pallas' transport)",
                       big, True)
    del big
    k15c = check_monitored(gen, group, rows_chunk, CFG.hidden)
    k16 = {}
    for n_tok in (MAX_BATCH, PREFILL_CHUNK, 512, LONG_CHUNK):
        k16[n_tok] = check_fused_full(gen, group, moe[0], n_tok, True,
                                      walk=n_tok <= PREFILL_CHUNK)

    log(f"  serve [4]'s prompts: Engine + deepseek_adapter(moe_weights_q=..., mla_wq=..., "
        f"ep_buffer=Buffer(<one-rank NCCL group>, {CFG.num_experts}, "
        f"EPConfig(comm_backend='pallas_ragged')))")
    buf = Buffer(group, CFG.num_experts, EPConfig(comm_backend="pallas_ragged"))
    drops, fused = [], buf.fused_deep_moe

    def recording(*args, **kw):
        out = fused(*args, **kw)
        drops.append(out[2])
        return out

    buf.fused_deep_moe = recording
    adapter = deepseek_adapter(CFG, params, torch.bfloat16, moe_weights_q=moe, mla_wq=mla_wq,
                               ep_buffer=buf)
    timer = StepTimer(adapter)
    eng = Engine(adapter, NUM_PAGES, max_batch=MAX_BATCH, max_pages_per_req=MAX_PAGES_PER_REQ,
                 prefill_chunk=PREFILL_CHUNK)
    ps = prompts(torch.Generator().manual_seed(SEED))
    rids, wall, launches = run_requests(eng, ps, (1, SHARED_PREFIX), NUM_PAGES, CFG.vocab_size)
    n_pre, n_dec = timer.calls["prefill"], timer.calls["decode"]
    calls = layers * (n_pre + n_dec)
    want = {**{k: v * calls for k, v in EP_DEEP_CALL.items()}, "gmm1_ring": 0,
            "gmm2_combine_ring": 0, "decode_mla": layers * n_dec,
            "mla_prefill_pallas": layers * n_pre, "quant_matmul": 2 * calls,
            "pallas_ragged_all_to_all_monitored": 0, "fused_deep_moe_full_rank": 0}
    dropped = int(torch.stack(drops).sum())
    if any(launches[k] != v for k, v in want.items()) or dropped:
        raise AssertionError(f"EP serve launches {launches} over {n_pre} prefill and {n_dec} "
                             f"decode calls, want {want}; {dropped} drops")
    dec_tokens = len(rids) * (NEW_TOKENS - 1)
    pre_tps = eng.stats["prefill_tokens"] / timer.t["prefill"]
    dec_tps = dec_tokens / timer.t["decode"]
    log(f"  served {len(rids)} requests in {wall:.2f} s wall: prefill {pre_tps:.1f} tok/s, decode "
        f"{dec_tps:.1f} tok/s (the single-GPU W8A8 serve of [4], this call: prefill "
        f"{eng_q.rates[0]:.1f}, decode {eng_q.rates[1]:.1f} tok/s); launches a MoE call "
        f"{ {k: launches[k] // calls for k in EP_DEEP_CALL} } over {calls} MoE calls; "
        f"num_dropped 0 in every call")
    log(f"  launches on the EP path: {json.dumps(launches)}")

    batch, n = live_batch(eng, ps)
    pages = eng.cm.alloc(-(-2 * PREFILL_CHUNK // CFG.page_size))
    ids = torch.tensor(ps[3][:2 * PREFILL_CHUNK], dtype=torch.int32, device=DEV)
    bt = torch.zeros((1, MAX_PAGES_PER_REQ), dtype=torch.int32, device=DEV)
    bt[0, : len(pages)] = torch.tensor([int(p) for p in pages], dtype=torch.int32)
    pos = torch.arange(2 * PREFILL_CHUNK, device=DEV)
    slots = (bt[0, pos // CFG.page_size] * CFG.page_size + pos % CFG.page_size).to(torch.int32)
    sl = torch.tensor([PREFILL_CHUNK], dtype=torch.int32, device=DEV)

    def chunk(c, plain=False, **kw):
        rows = slice(c * PREFILL_CHUNK, (c + 1) * PREFILL_CHUNK)
        ctx = torch.tensor([(c + 1) * PREFILL_CHUNK], dtype=torch.int32, device=DEV)
        h, _ = m.prefill_step(CFG, params, m.embed(params, ids[rows]), sl, eng.caches, bt, ctx,
                              slots[rows], max_q=PREFILL_CHUNK, moe_weights_q=moe, mla_wq=mla_wq,
                              plain=plain, **{"ep_buffer": buf, **kw})
        return h

    def decode(plain=False, **kw):
        return eng.decode_logits(batch, decode_step_fn(params, moe, mla_wq=mla_wq, plain=plain,
                                                       **{"ep_buffer": buf, **kw}))

    chunk(0)                                        # the chunk's context, written once
    checks = [("EP decode step (logits)", decode, n, True),
              (f"EP prefill chunk of {PREFILL_CHUNK} rows at context {2 * PREFILL_CHUNK} "
               "(hidden)", lambda plain=False, **kw: chunk(1, plain, **kw), PREFILL_CHUNK, False)]
    for label, run, rows, logits in checks:
        counters.reset()
        got, rec = with_routes(lambda: run()[:rows].float())
        step_launches = counters.read()
        want_l = {k: v * layers for k, v in EP_DEEP_CALL.items()}
        if any(step_launches[k] != v for k, v in want_l.items()):
            raise AssertionError(f"{label}: launches {step_launches}, want {want_l}")
        plain, _ = with_routes(lambda: run(True)[:rows].float(), rec)
        single_gpu, _ = with_routes(lambda: run(ep_buffer=None)[:rows].float(), rec)
        same = torch.ones(rows, dtype=torch.bool, device=DEV)
        ok = (routing_rule(label, got, plain, same, logits, forced=True)
              and routing_rule(label, got, single_gpu, same, logits, forced=True,
                               vs="[4]'s single-GPU W8A8 path (gmm1_ring / gmm2_combine_ring)"))
        if not ok:
            raise AssertionError(f"{label}: the EP path disagrees with its references")
    outs, first = {}, None
    for backend in ("pallas_ragged", "pallas", "xla"):
        b = Buffer(group, CFG.num_experts, EPConfig(comm_backend=backend))
        if first is None:
            outs[backend], first = with_routes(lambda: decode(ep_buffer=b)[:n].float())
        else:
            outs[backend], _ = with_routes(lambda: decode(ep_buffer=b)[:n].float(), first)
    diffs = {k: max_abs(v, outs["pallas_ragged"]) for k, v in outs.items()}
    log(f"  the same EP decode step on the transports 'pallas_ragged', 'pallas', 'xla' "
        f"(routing replayed): max |logit diff| to 'pallas_ragged' {diffs}; bit-identical "
        f"{all(d == 0.0 for d in diffs.values())}")
    if any(d != 0.0 for d in diffs.values()):
        raise AssertionError(f"the transports disagree on one rank: {diffs}")

    log("  monitored dispatch: Buffer(EPConfig(comm_backend='pallas_ragged', monitor_comm=True))"
        f".dispatch on a decode step's {MAX_BATCH} rows")
    mbuf = Buffer(group, CFG.num_experts, EPConfig(comm_backend="pallas_ragged",
                                                   monitor_comm=True))
    xd = randn(gen, (MAX_BATCH, CFG.hidden))
    idx_d, _ = deep_routing(gen, MAX_BATCH)
    counters.reset()
    _, _, gs_m, _, st_m = mbuf.dispatch(xd, idx_d)
    torch.cuda.synchronize()
    launches_c = counters.read()
    if launches_c["pallas_ragged_all_to_all_monitored"] != 1 or st_m["timeout_flags"].any() \
            or int(gs_m.sum()) != MAX_BATCH * CFG.topk:
        raise AssertionError(f"monitored dispatch: {launches_c}, {st_m}")
    log(f"    K15c launched once; wait_recv_cost_stats {st_m['wait_recv_cost_stats'].tolist()}, "
        f"timeout_flags {st_m['timeout_flags'].tolist()}")

    log("  single_kernel=True: the EP decode step and chunk with Buffer.fused_deep_moe(..., "
        "single_kernel=True) on each layer's routed rows (K16b, one launch a MoE call)")
    sbuf = Buffer(group, CFG.num_experts, EPConfig(comm_backend="pallas_ragged"))
    single = sbuf.fused_deep_moe
    sbuf.fused_deep_moe = lambda *a, **kw: single(*a, **{**kw, "single_kernel": True})
    counters.reset()
    got_s, rec_s = with_routes(lambda: decode(ep_buffer=sbuf)[:n].float())
    launches_s = counters.read()
    want_s = {"fused_deep_moe_full_rank": layers, "pallas_all_to_all": layers,
              "pallas_ragged_all_to_all": 0, "grouped_matmul": 0}
    if any(launches_s[k] != v for k, v in want_s.items()):
        raise AssertionError(f"single-kernel decode step: launches {launches_s}, want {want_s}")
    plain_s, _ = with_routes(lambda: decode(True, ep_buffer=sbuf)[:n].float(), rec_s)
    if not routing_rule("EP decode step, single_kernel=True (logits)", got_s, plain_s,
                        torch.ones(n, dtype=torch.bool, device=DEV), True, forced=True):
        raise AssertionError("the single-kernel EP decode step disagrees with its plain path")

    log("  profile (torch.profiler): the EP decode step and 64-row chunk, unfused and "
        "single_kernel=True")
    for label, fn in (("EP decode step (logits), window transport", decode),
                      (f"EP {PREFILL_CHUNK}-row prefill chunk, window transport", lambda: chunk(1)),
                      ("EP decode step (logits), single_kernel=True",
                       lambda: decode(ep_buffer=sbuf)),
                      (f"EP {PREFILL_CHUNK}-row prefill chunk, single_kernel=True",
                       lambda: chunk(1, ep_buffer=sbuf))):
        rows_p, busy, wall_ms = trace_profile.device_breakdown(fn, top=1000)
        log(f"  {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall_ms:.1f} %), {sum(c for _, _, c in rows_p)} kernel launches "
            f"a step ({layers} MoE calls)")
        for name, ms, count in rows_p[:12]:
            log(f"    {ms:9.3f} ms  x{count:<4d} {name[:110]}")
    eng.cm.free(pages)
    del eng
    k16b = k16[LONG_CHUNK]
    return (k15a, k15b, k15c, k16b), {
        "pallas_all_to_all": launches["pallas_all_to_all"],
        "pallas_ragged_all_to_all": launches["pallas_ragged_all_to_all"],
        "pallas_ragged_all_to_all_monitored": launches_c["pallas_ragged_all_to_all_monitored"],
        "fused_deep_moe_full_rank": launches_s["fused_deep_moe_full_rank"]}


# ---------------------------------------------------------------------------
# phase 4l: the last TPU kernels' paths: K8a's remaining modes, _gmm_moe's
# dispatch_p + K8b branch, the narrow gate / up packing, K16a, K3 on float tokens
# ---------------------------------------------------------------------------

PACK_TN = 1024            # [4l]'s narrow gate / up packing (DeepSeek-V3's 2I is 4096)
MOE_TOL = 1e-2            # _gmm_moe's dispatch_p + K8b branch vs plain and the ring branch
K8B_TOL = 1e-4            # K8b vs its plain version: a row's largest |value|
K16A_MOE_TOL = 5e-2       # K16a -> K7a -> K8a -> combine_core vs _gmm_moe
# K8b's CUDA kernels, each once a call (a CUDA graph capture's kernel names hold these)
K8B_KERNELS = ("combine_offsets_kernel", "combine_rows_kernel", "combine_kernel")


def row_rel(got, want) -> float:
    """max over rows of max|got - want| / max|want| (a row's largest)."""
    g, w = got.float(), want.float()
    if not w.numel():
        return 0.0
    return float(((g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)).max())


def ulp_rel(got, want) -> float:
    """max |got - want| / |want| over the nonzero plain values, inf where a
    zero of either side is not a zero of the other."""
    g, w = got.float(), want.float()
    if not torch.equal(g == 0, w == 0):
        return math.inf
    nz = w != 0
    return float(((g - w).abs()[nz] / w.abs()[nz]).max()) if bool(nz.any()) else 0.0


def narrow_packing(moe):
    """[4]'s layer-0 experts repacked from full width to ``PACK_TN`` by a
    column permutation of w1 / s1 (exact: the same quantized weights)."""
    w1, s1, w2, s2 = moe
    n = w1.shape[2]
    half, i = PACK_TN // 2, n // 2
    c = torch.arange(n, device=DEV)
    slab, r = c // PACK_TN, c % PACK_TN
    perm = torch.where(r < half, slab * half + r, i + slab * half + r - half)
    return w1.index_select(2, perm), s1.index_select(1, perm), w2, s2


def chunk_rows(gen, moe, n_tok):
    """A chunk of ``n_tok`` tokens of random top-8 routing: the gathered int8
    rows and their scales, and GMM1's int8 output (K8a) for the GMM2 modes."""
    w1, s1, _, _ = moe
    gs, tok, _ = routing(gen, n_tok, CFG.topk, CFG.num_experts)
    x = randn(gen, (n_tok, CFG.hidden), torch.float32)
    sx_tok = torch.clamp_min(quant.row_scale(x), 1e-12)
    xq = quant.saturate_int8(x / sx_tok[:, None])
    rows = tok.long()
    xg, sxg = xq[rows], sx_tok[rows]
    h1, hs = grouped_matmul.grouped_matmul(xg, w1, gs, sxg, s1, epilogue="dequant_swiglu_quant")
    return gs, xg, sxg, h1, hs


def k8a_mode(label, run, plain, err_of, tol, nbytes, ops, rate, library=None):
    """One K8a mode against its plain version (``err_of`` within ``tol``;
    the JSON's error is the max absolute one), then timed beside its bound,
    the plain version and ``library`` (a PyTorch call, or None)."""
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = err_of(got, want)
    log(f"  grouped_matmul {label}: err {err:.3e} (tol {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"grouped_matmul {label} disagrees with its plain version: {err}")
    res = dict(err=max_abs(got, want), ms=time_ms(run, 10), plain_ms=time_ms(plain, 2),
               library_ms=None if library is None else time_ms(library, 10))
    res["bound_ms"], res["bound_by"] = bound(nbytes, ops, rate)
    log(f"    {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}, library {res['library_ms']}, "
        f"bound {res['bound_ms']:.4f} {res['bound_by']})")
    return res


def check_k8a_modes(gen, moe, moe_n):
    """K8a's remaining modes at a 2048-token chunk's 16384 rows of top-8
    routing over 256 experts: ``dequant_swiglu`` on the narrow packing to
    f32 (within 1e-5 of the largest |value|: the SiLU's exp; bit-equal to
    the same activation from the full-width packing), ``dequant`` to f32 and
    ``none`` on int8 rows (GMM2's shapes: exact sums, the same f32 operations;
    within 1e-6 of the largest |value|), bf16 ``none`` to bf16 at DeepSeek-V3's gate shape (one bf16
    ulp plus f32 summation order; yardstick ``torch._grouped_mm``).  Returns
    the four JSON results."""
    gm, gm_p = grouped_matmul.grouped_matmul, grouped_matmul.grouped_matmul_plain
    w1, s1, w2, s2 = moe
    w1n, s1n = moe_n[:2]
    gs, xg, sxg, h1, hs = chunk_rows(gen, moe, LONG_CHUNK)
    s_rows, k = xg.shape
    n, h = w1.shape[2], w2.shape[2]
    i = n // 2
    t = int((gs > 0).sum())
    max_rel = lambda a, b: max_abs(a, b) / max(float(b.float().abs().max()), 1e-30)  # noqa: E731
    kw = dict(epilogue="dequant_swiglu", tn=PACK_TN, out_dtype=torch.float32)
    wide = gm(xg, w1, gs, sxg, s1, epilogue="dequant_swiglu", tn=n, out_dtype=torch.float32)
    narrow = gm(xg, w1n, gs, sxg, s1n, **kw)
    torch.cuda.synchronize()
    if not torch.equal(wide, narrow):
        raise AssertionError("dequant_swiglu: the narrow packing's activation differs from the "
                             "full-width packing's")
    log(f"  grouped_matmul dequant_swiglu at pack width {PACK_TN} and at full width {n}: "
        "bit-identical activations")
    swiglu = k8a_mode(
        f"dequant_swiglu (tn {PACK_TN}) to f32, {s_rows} rows", lambda: gm(xg, w1n, gs, sxg, s1n,
                                                                           **kw),
        lambda: gm_p(xg, w1n, gs, sxg, s1n, **kw), max_rel, 1e-5,
        s_rows * k + t * k * n + t * n * 4 + s_rows * 4 + s_rows * i * 4, 2 * s_rows * k * n,
        INT8_OPS)
    del wide, narrow
    f32 = k8a_mode(
        f"dequant to f32 (GMM2), {s_rows} rows",
        lambda: gm(h1, w2, gs, hs, s2, epilogue="dequant", out_dtype=torch.float32),
        lambda: gm_p(h1, w2, gs, hs, s2, epilogue="dequant", out_dtype=torch.float32), max_rel,
        1e-6,
        s_rows * i + t * i * h + t * h * 4 + s_rows * 4 + s_rows * h * 4, 2 * s_rows * i * h,
        INT8_OPS)
    none = k8a_mode(
        f"none on int8 rows (GMM2's product), {s_rows} rows", lambda: gm(h1, w2, gs),
        lambda: gm_p(h1, w2, gs), max_rel, 1e-6, s_rows * i + t * i * h + s_rows * h * 4,
        2 * s_rows * i * h, INT8_OPS)
    xb = randn(gen, (s_rows, k))
    wb = torch.randn((CFG.num_experts, k, i), generator=gen, device=DEV,
                     dtype=torch.bfloat16) * k ** -0.5
    lib, lib_name = grouped_library(xb, wb, gs, False)
    log(f"  bf16 none to bf16 yardstick: {lib_name}")

    def bf16_err(got, want):       # one bf16 ulp plus f32 sums in another order
        g, w = got.float(), want.float()
        excess = (g - w).abs() - 2 ** -7 * w.abs() - 1e-5 * float(w.abs().max())
        return max(float(excess.max()), 0.0)

    fl = grouped_matmul.grouped_matmul_float
    bf16 = k8a_mode(
        f"none bf16 to bf16 (a gate product), {s_rows} rows",
        lambda: fl(xb, wb, gs, out_dtype=torch.bfloat16),
        lambda: grouped_matmul.grouped_matmul_float_plain(xb, wb, gs).to(torch.bfloat16),
        bf16_err, 0.0, s_rows * k * 2 + t * k * i * 2 + s_rows * i * 2, 2 * s_rows * k * i,
        BF16_FLOPS, lib)
    del xb, wb
    return swiglu, f32, none, bf16


def check_k8a_modes_small(gen):
    """K8a's remaining modes on ragged cases (an empty group, a one-row
    group, a total below S, K off the 128-byte stage): each against its
    plain version, ``dispatch_p`` bit-equal to the gathered rows."""
    gm, gm_p = grouped_matmul.grouped_matmul, grouped_matmul.grouped_matmul_plain
    for sizes, s, k, i in (((0, 5, 0, 17, 1, 0, 40, 1), 80, 1024, 256), ((0, 1, 0, 0), 1, 256, 128),
                           ((3, 0, 70, 9), 100, 336, 160)):
        g = len(sizes)
        gs = torch.tensor(sizes, dtype=torch.int32, device=DEV)
        x = torch.randint(-127, 128, (s, k), generator=gen, device=DEV, dtype=torch.int8)
        w = torch.randint(-127, 128, (g, k, 2 * i), generator=gen, device=DEV, dtype=torch.int8)
        sx = torch.rand(s, generator=gen, device=DEV) / 50 + 1e-3
        sw = torch.rand((g, 2 * i), generator=gen, device=DEV) / 500 + 1e-4
        errs = {}
        for name, kw in (("dequant_swiglu tn 64", dict(epilogue="dequant_swiglu", tn=64,
                                                       out_dtype=torch.float32)),
                         ("dequant f32", dict(epilogue="dequant", out_dtype=torch.float32)),
                         ("none", dict(epilogue="none"))):
            got, want = gm(x, w, gs, sx, sw, **kw), gm_p(x, w, gs, sx, sw, **kw)
            errs[name] = max_abs(got, want) / max(float(want.abs().max()), 1e-30)
            if errs[name] > (1e-5 if "swiglu" in name else 1e-6) or got[sum(sizes):].any():
                raise AssertionError(f"grouped_matmul {name} ragged {sizes}: {errs[name]}")
        n_tok = 7
        xt = torch.randint(-127, 128, (n_tok, k), generator=gen, device=DEV, dtype=torch.int8)
        tok = torch.randint(0, n_tok + 1, (s,), generator=gen, device=DEV, dtype=torch.int32)
        p = grouped_matmul.dispatch_onehot(tok, n_tok)
        gathered = torch.where((tok < n_tok)[:, None], xt[tok.clamp(max=n_tok - 1).long()], 0)
        a = gm(xt, w, gs, sx, sw, epilogue="dequant_swiglu_quant", dispatch_p=p)
        b = gm(gathered.contiguous(), w, gs, sx, sw, epilogue="dequant_swiglu_quant")
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"grouped_matmul dispatch_p ragged {sizes}: not the gathered rows")
        p[0, :2] = 1                     # a row that is not one-hot: the card refuses P
        try:
            gm(xt, w, gs, sx, sw, epilogue="dequant_swiglu_quant", dispatch_p=p)
        except ValueError:
            pass
        else:
            raise AssertionError("grouped_matmul took a dispatch_p that is not one-hot")
        log(f"  grouped_matmul ragged (groups {list(sizes)}, S {s}, K {k}, I {i}): rel err "
            f"{ {n_: f'{e:.1e}' for n_, e in errs.items()} }, dispatch_p bit-equal to the "
            "gathered rows, a P that is not one-hot refused")


def check_dispatch_branch(gen, moe, n_tok, timed):
    """``_gmm_moe``'s dispatch_p + K8b branch (``deepseek_v3._gmm_moe_dispatch``)
    at ``n_tok`` tokens of random top-8 routing at DeepSeek-V3's widths,
    where ``_gmm_moe`` itself picks the ring: K8a ``dispatch_p`` and K8b each
    exactly once (counts reset just before, read just after); the output
    against its plain version and the ring branch (K3 + K4) on the same rows
    (``MOE_TOL`` of a row's largest); K8a with ``dispatch_p`` bit-equal to
    K8a on the gathered rows and against its plain version (int8 within one
    level, scales rtol 1e-6: K8a's rule); K8b alone against its plain
    version (``K8B_TOL``).  ``timed``: K8b beside its bound and K4 at the same
    routing, and K8a ``dispatch_p`` beside its bound.  Returns ``(K8a
    dispatch_p, K8b)`` JSON results (None, None untimed) and the counts."""
    w1, s1, w2, s2 = moe
    x = randn(gen, (n_tok, CFG.hidden))
    idx, w = deep_routing(gen, n_tok)
    rows = m._moe_rows(x, idx, CFG.num_experts)
    counters.reset()
    got = m._gmm_moe_dispatch(moe, rows, w)
    torch.cuda.synchronize()
    launches = counters.read()
    want_l = {"grouped_matmul": 1, "grouped_matmul:dispatch_p": 1,
              "grouped_matmul:dequant_swiglu_quant": 1, "grouped_matmul_combine": 1,
              "gmm1_ring": 0, "gmm2_combine_ring": 0}
    if any(launches[k_] != v for k_, v in want_l.items()):
        raise AssertionError(f"dispatch_p + K8b branch launches {launches}, want {want_l}")
    plain = m._gmm_moe_dispatch(moe, rows, w, plain=True)
    ring = m._gmm_moe_ring(moe, rows, w)
    xq_tok, sx_tok, gs, dest, tok = rows
    p = grouped_matmul.dispatch_onehot(tok, n_tok)
    sxr = sx_tok[tok.long()]
    kw = dict(epilogue="dequant_swiglu_quant")
    disp = grouped_matmul.grouped_matmul(xq_tok, w1, gs, sxr, s1, dispatch_p=p, **kw)
    gath = grouped_matmul.grouped_matmul(xq_tok[tok.long()], w1, gs, sxr, s1, **kw)
    h1_p, hs_p = grouped_matmul.grouped_matmul_plain(xq_tok, w1, gs, sxr, s1, dispatch_p=p, **kw)
    s_rows = tok.numel()
    m_hi, m_lo = grouped_matmul.combine_masks(dest, w, s_rows)
    comb = lambda: grouped_matmul.grouped_matmul_combine(h1_p, w2, gs, hs_p, s2, m_hi,  # noqa
                                                         m_lo)
    comb_p = lambda: grouped_matmul.grouped_matmul_combine_plain(h1_p, w2, gs, hs_p, s2,  # noqa
                                                                 m_hi, m_lo)
    o, o_p = comb(), comb_p()
    _, d_k = grouped_matmul._combine_launch(h1_p, w2, gs, hs_p, s2, m_hi, m_lo, torch.float32)
    bit_d = torch.equal(d_k, grouped_matmul.grouped_matmul(h1_p, w2, gs, hs_p, s2,
                                                           epilogue="dequant"))
    torch.cuda.synchronize()
    graph = trace_profile.graph_kernels(comb)
    graph_ok = [c for _, c in graph] == [1, 1, 1] and all(
        any(k_ in n_ for n_, _ in graph) for k_ in K8B_KERNELS)
    err_p, err_r, err_b = row_rel(got, plain), row_rel(got, ring), row_rel(o, o_p)
    bit = torch.equal(disp[0], gath[0]) and torch.equal(disp[1], gath[1])
    err_d = max_abs(disp[0], h1_p)
    err_ds = float(((disp[1] - hs_p).abs() / hs_p.abs().clamp_min(1e-30)).max())
    touched = int((gs > 0).sum())
    log(f"  _gmm_moe dispatch_p + K8b branch, {n_tok} tokens x top-8 over {touched} experts: "
        f"vs plain {err_p:.3e}, vs the ring branch (K3 + K4) {err_r:.3e} (tol {MOE_TOL} of a "
        f"row's largest); K8b vs plain {err_b:.3e} (tol {K8B_TOL}), its rows d bit-equal to "
        f"K8a dequant {bit_d}, a call's CUDA graph holds {len(graph)} kernels, one each of "
        f"{'/'.join(K8B_KERNELS)} {graph_ok}; dispatch_p bit-equal to "
        f"the gathered rows {bit}, vs plain max|h1 err| {err_d:.0f} int8 levels (tol 1), "
        f"scale rel err {err_ds:.2e} (tol 1e-6); launches "
        f"{json.dumps({k_: launches[k_] for k_ in want_l})}")
    if not (err_p <= MOE_TOL and err_r <= MOE_TOL and err_b <= K8B_TOL and bit and bit_d
            and graph_ok and err_d <= 1 and err_ds <= 1e-6 and bool(torch.isfinite(got).all())):
        raise AssertionError(f"_gmm_moe's dispatch_p + K8b branch is wrong at {n_tok} tokens")
    if not timed:
        return None, None, launches
    h, k = CFG.hidden, w1.shape[1]
    n, i = w1.shape[2], w2.shape[1]
    k8b = dict(err=max_abs(o, o_p), ms=time_ms(comb, 10), plain_ms=time_ms(comb_p, 2),
               library_ms=None)
    t_bytes = (touched * (i * h + h * 4) + s_rows * (i + 4) + 2 * 2 * n_tok * s_rows
               + n_tok * h * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * s_rows * i * h / INT8_OPS + 4 * n_tok * s_rows * h / BF16_FLOPS) * 1e3
    k8b["bound_ms"], k8b["bound_by"] = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                                             else "operations")
    k4_ms = time_ms(lambda: gmm_ring.gmm2_combine_ring(h1_p, w2, gs, hs_p, s2, dest, w), 10)
    run_d = lambda: grouped_matmul.grouped_matmul(xq_tok, w1, gs, sxr, s1, dispatch_p=p,  # noqa
                                                  **kw)
    k8d = dict(err=err_d, ms=time_ms(run_d, 10), library_ms=None,
               plain_ms=time_ms(lambda: grouped_matmul.grouped_matmul_plain(
                   xq_tok, w1, gs, sxr, s1, dispatch_p=p, **kw), 2))
    k8d["bound_ms"], k8d["bound_by"] = bound(
        n_tok * k + s_rows * n_tok + touched * (k * n + n * 4) + s_rows * (4 + i + 4),
        2 * s_rows * k * n, INT8_OPS)
    gath_ms = time_ms(lambda: grouped_matmul.grouped_matmul(xq_tok[tok.long()], w1, gs, sxr, s1,
                                                            **kw), 10)
    log(f"    K8b {k8b['ms']:.4f} ms (plain {k8b['plain_ms']:.4f}, K4 at the same routing "
        f"{k4_ms:.4f}, bound {k8b['bound_ms']:.4f} {k8b['bound_by']}); K8a dispatch_p "
        f"{k8d['ms']:.4f} ms (plain {k8d['plain_ms']:.4f}, the gather + K8a {gath_ms:.4f}, bound "
        f"{k8d['bound_ms']:.4f} {k8d['bound_by']})")
    return k8d, k8b, launches


def check_narrow_moe(gen, group, moe, moe_n, n_tok):
    """``Buffer.fused_deep_moe(pack_tn=PACK_TN)``, unfused, on the ``"xla"``
    and ``"pallas_ragged"`` transports: K8a ``dequant_swiglu`` once and
    ``dequant`` once a call (counts reset just before, read just after), no
    drop; held to the full-width call on the same quantized weights and to
    ``plain=True`` (relative mean below ``EP_DEEP_REL_MEAN``).  Then
    ``single_kernel=True`` at the same packing: K16b once a call, K8a never,
    held to the unfused call (``EP_DEEP_REL_MEAN``), to its plain version
    (``EP_DEEP_TOL`` of a row's largest) and, at 8 tokens, bit-equal to its
    tiled walk.  Returns the summed counts."""
    x = randn(gen, (n_tok, CFG.hidden))
    idx, w = deep_routing(gen, n_tok)
    total = {}
    for backend in ("xla", "pallas_ragged"):
        buf = Buffer(group, CFG.num_experts, EPConfig(comm_backend=backend))
        counters.reset()
        got, cnt, drop = buf.fused_deep_moe(x, idx, w, *moe_n, pack_tn=PACK_TN)
        torch.cuda.synchronize()
        launches = counters.read()
        want_l = {"grouped_matmul": 2, "grouped_matmul:dequant_swiglu": 1,
                  "grouped_matmul:dequant": 1, "grouped_matmul:dequant_swiglu_quant": 0}
        if any(launches[k_] != v for k_, v in want_l.items()) or int(drop):
            raise AssertionError(f"narrow packing on {backend!r}: launches {launches}, want "
                                 f"{want_l}; {int(drop)} drops")
        for k_, v in launches.items():
            total[k_] = total.get(k_, 0) + v
        full, fcnt, _ = buf.fused_deep_moe(x, idx, w, *moe)
        plain, pcnt, _ = buf.fused_deep_moe(x, idx, w, *moe_n, pack_tn=PACK_TN, plain=True)
        torch.cuda.synchronize()
        rel_f, rel_p = rel_mean(got, full), rel_mean(got, plain)
        log(f"  Buffer.fused_deep_moe(pack_tn={PACK_TN}) on {backend!r}, {n_tok} tokens: vs the "
            f"full-width packing {rel_f:.3e}, vs plain=True {rel_p:.3e} (rel mean, tol "
            f"{EP_DEEP_REL_MEAN}); counts exact {torch.equal(cnt, fcnt) and torch.equal(cnt, pcnt)}"
            f"; launches {json.dumps(want_l)}")
        if not (rel_f < EP_DEEP_REL_MEAN and rel_p < EP_DEEP_REL_MEAN and torch.equal(cnt, fcnt)
                and torch.equal(cnt, pcnt)):
            raise AssertionError(f"the narrow packing disagrees on {backend!r} at {n_tok} tokens")
    counters.reset()
    single, scnt, sdrop = buf.fused_deep_moe(x, idx, w, *moe_n, pack_tn=PACK_TN,
                                             single_kernel=True)
    torch.cuda.synchronize()
    launches = counters.read()
    want_l = {"fused_deep_moe_full_rank": 1, "grouped_matmul": 0}
    splain = buf.fused_deep_moe(x, idx, w, *moe_n, pack_tn=PACK_TN, single_kernel=True,
                                plain=True)[0]
    bit = None
    if n_tok == MAX_BATCH:
        bit = torch.equal(single, fused_full_walk(buf, x, idx, w, moe_n, PACK_TN))
    torch.cuda.synchronize()
    rel_u = rel_mean(single, got)
    err_p = float(((single.float() - splain.float()).abs().amax(-1)
                   / splain.float().abs().amax(-1)).max())
    log(f"  Buffer.fused_deep_moe(pack_tn={PACK_TN}, single_kernel=True), {n_tok} tokens: vs the "
        f"unfused call {rel_u:.3e} (rel mean, tol {EP_DEEP_REL_MEAN}), vs its plain version "
        f"{err_p:.3e} (tol {EP_DEEP_TOL}); counts exact {torch.equal(scnt, cnt)}; bit-equal to "
        f"its tiled walk {bit}; launches {json.dumps({k_: launches[k_] for k_ in want_l})}")
    if not (rel_u < EP_DEEP_REL_MEAN and err_p <= EP_DEEP_TOL and torch.equal(scnt, cnt)
            and int(sdrop) == 0 and bit is not False
            and all(launches[k_] == v for k_, v in want_l.items())):
        raise AssertionError(f"K16b at the narrow packing disagrees at {n_tok} tokens")
    return total


def check_fused_dispatch(gen, group, moe, n_tok, timed):
    """K16a through ``fused_dispatch_gmm1`` on the one-rank group's window
    at ``n_tok`` tokens (seg = EPConfig's 128): K16a once (counts reset just
    before, read just after); its output against the plain version (one
    bf16 ulp of each value, the zeros the same) and against K8a ``dequant``
    on the same placed rows (bit-equal); then K7a + K8a ``dequant`` and
    ``ep_core.combine_core`` as a whole MoE, against ``_gmm_moe`` on the same
    tokens (``K16A_MOE_TOL`` of a row's largest).  ``timed``: K16a beside its
    bound and beside K15b + K8a ``dequant`` (the same function unfused, on
    the padded layout).  Returns the JSON result (None untimed) and the
    counts."""
    from sgl_kernel_npu_tpu_torch.parallel import fused_kernel

    w1, s1, w2, s2 = moe
    e, h = CFG.num_experts, CFG.hidden
    n, i = w1.shape[2], w2.shape[1]
    seg = max(EPConfig().num_max_dispatch_tokens_per_rank, n_tok)
    x = randn(gen, (n_tok, h))
    idx, w = deep_routing(gen, n_tok)
    kw = dict(group=group, num_experts=e, num_ranks=1, seg_capacity=seg)
    counters.reset()
    out, cnt, handle = fused_kernel.fused_dispatch_gmm1(x, idx, w1, s1, **kw)
    torch.cuda.synchronize()
    launches = counters.read()
    if launches["fused_dispatch_gmm1_rank"] != 1 or launches["quant_per_token"] != 1:
        raise AssertionError(f"fused_dispatch_gmm1 launches {launches}")
    out_p, cnt_p, _ = fused_kernel.fused_dispatch_gmm1(x, idx, w1, s1, plain=True, **kw)
    xsend, sx, plan = fused_kernel.placed_rows(x, idx, **kw)
    gs_all = torch.full((e,), seg, dtype=torch.int32, device=DEV)
    k8 = grouped_matmul.grouped_matmul(xsend.reshape(e * seg, h), w1, gs_all, sx.reshape(-1), s1,
                                       epilogue="dequant")
    hq, hsc = activation.swiglu_quant(out.reshape(e * seg, n))
    y = grouped_matmul.grouped_matmul(hq, w2, gs_all, hsc, s2, epilogue="dequant")
    moe_out = ep_core.combine_core(y.reshape(e, seg, h), w, handle, group=group, num_ranks=1,
                                   seg_capacity=seg, out_dtype=torch.float32)
    ref = m._gmm_moe(CFG, moe, x, idx, w)
    torch.cuda.synchronize()
    err = ulp_rel(out, out_p)
    bit = torch.equal(out, k8.reshape(e, seg, n))
    err_moe = row_rel(moe_out, ref)
    live = int(cnt.sum())
    log(f"  fused_dispatch_gmm1 {n_tok} tokens x top-8 ({live} rows, seg {seg}): K16a vs plain "
        f"max rel {err:.3e} (tol 2^-7: a bf16 ulp), vs K8a dequant on the placed rows "
        f"bit-equal {bit}; counts exact {torch.equal(cnt, cnt_p)}; K16a -> K7a -> K8a -> "
        f"combine_core vs _gmm_moe {err_moe:.3e} (tol {K16A_MOE_TOL} of a row's largest)")
    counts = plan.counts_per_expert.reshape(1, e)
    rank = lambda: fused_kernel.fused_dispatch_gmm1_rank(xsend, w1, s1, sx, group=group,  # noqa
                                                         num_ranks=1, seg=seg, counts=counts)
    graph = trace_profile.graph_kernels(rank)
    graph_ok = len(graph) == 1 and graph[0][1] == 1 and "fused_kernel_kernel" in graph[0][0]
    log(f"    a K16a call's CUDA graph holds {graph[0][1] if graph else 0} x "
        f"{graph[0][0][:40] if graph else 'nothing'} and {len(graph) - 1} other kernels "
        f"(want fused_kernel_kernel alone: {graph_ok})")
    if not (err <= 2 ** -7 and bit and err_moe <= K16A_MOE_TOL and torch.equal(cnt, cnt_p)
            and graph_ok):
        raise AssertionError(f"fused_dispatch_gmm1 is wrong at {n_tok} tokens")
    if not timed:
        return None, launches
    res = dict(err=max_abs(out, out_p), ms=time_ms(rank, 10), library_ms=None,
               plain_ms=time_ms(lambda: fused_kernel.fused_dispatch_gmm1_rank(
                   xsend, w1, s1, sx, group=group, num_ranks=1, seg=seg, counts=counts,
                   plain=True), 2))
    touched = int((counts > 0).sum())
    res["bound_ms"], res["bound_by"] = bound(
        touched * (h * n + n * 4) + live * h + e * seg * 4 + e * seg * n * 2,
        2 * live * h * n, INT8_OPS)
    full = torch.tensor([e * seg], dtype=torch.int32, device=DEV)
    sxf = sx.reshape(-1)

    def unfused():
        recv, _ = pallas_a2a.pallas_ragged_all_to_all(xsend, full, group=group)
        return grouped_matmul.grouped_matmul(recv.reshape(e * seg, h), w1, gs_all, sxf, s1,
                                             epilogue="dequant")

    unf_ms = time_ms(unfused, 5)
    log(f"    K16a {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}; K15b + K8a dequant on the "
        f"padded layout {unf_ms:.4f}; bound {res['bound_ms']:.4f} {res['bound_by']}: {touched} "
        f"experts' w1 read once, the [{e}, {seg}, {n}] bf16 output written once)")
    return res, launches


def check_gmm1_float(gen, moe, n_tok, timed):
    """K3 on bf16 tokens (its in-kernel quant mode) at ``n_tok`` tokens:
    once under its mode, no K5 launch (the quant runs inside K3's kernel;
    counts reset just before, read just after); against its plain version
    on the bf16 tokens (int8 within one level, scales rtol 1e-5: K3's rule)
    and bit-equal to K5 (``quant_per_token``) then K3 on the int8 tokens.
    ``timed``: beside that pair and its bound.  Returns the JSON result
    (None untimed) and the counts."""
    w1, s1, _, _ = moe
    e, k, n = w1.shape
    gs, tok, _ = routing(gen, n_tok, CFG.topk, e)
    x = randn(gen, (n_tok, k))
    counters.reset()
    h1, hs = gmm_ring.gmm1_ring(x, tok, w1, gs, None, s1)
    torch.cuda.synchronize()
    launches = counters.read()
    if launches["gmm1_ring:float_x"] != 1 or launches["quant_per_token"] != 0:
        raise AssertionError(f"gmm1_ring on float tokens: launches {launches}")

    def pair():
        xq, sx = quant.quant_per_token(x)
        return gmm_ring.gmm1_ring(xq, tok, w1, gs, sx, s1)

    h1q, hsq = pair()
    h1_p, hs_p = gmm_ring.gmm1_ring_ref(x, tok, w1, gs, None, s1)
    torch.cuda.synchronize()
    bit = torch.equal(h1, h1q) and torch.equal(hs, hsq)
    err1 = max_abs(h1, h1_p)
    err_s = float(((hs - hs_p).abs() / hs_p.abs().clamp_min(1e-30)).max())
    log(f"  gmm1_ring on bf16 tokens, {n_tok} tokens x top-8: vs plain max|h1 err| {err1:.0f} "
        f"int8 levels (tol 1), hs rel err {err_s:.2e} (tol 1e-5); bit-equal to "
        f"quant_per_token + gmm1_ring on int8 {bit}")
    if not (bit and err1 <= 1 and err_s <= 1e-5):
        raise AssertionError(f"gmm1_ring's float-input mode is wrong at {n_tok} tokens: "
                             f"{err1}, {err_s}, bit-equal to K5 + K3 {bit}")
    if not timed:
        return None, launches
    s_rows, i = tok.numel(), n // 2
    touched = int((gs > 0).sum())
    res = dict(err=err1, ms=time_ms(lambda: gmm_ring.gmm1_ring(x, tok, w1, gs, None, s1), 20),
               plain_ms=time_ms(lambda: gmm_ring.gmm1_ring_ref(x, tok, w1, gs, None, s1), 3),
               library_ms=None)
    res["bound_ms"], res["bound_by"] = bound(
        touched * (k * n + n * 4) + x.numel() * 2 + s_rows * 4 + s_rows * (i + 4),
        2 * s_rows * k * n, INT8_OPS)
    pair_ms = time_ms(pair, 20)
    log(f"    {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}; K5 + K3 {pair_ms:.4f}; bound "
        f"{res['bound_ms']:.4f} {res['bound_by']})")
    return res, launches


def op_modes(gen, moe):
    """K8a's modes no caller of the port reaches (``dequant`` to f32,
    ``none`` on int8 rows, bf16 ``none`` to bf16), each once through its
    entry point at a decode step's 64 rows, with the counts reset just
    before and read just after."""
    w1, s1, w2, s2 = moe
    gs, xg, sxg, h1, hs = chunk_rows(gen, moe, MAX_BATCH)
    xb = randn(gen, (xg.shape[0], CFG.hidden))
    wb = randn(gen, (16, CFG.hidden, 512), scale=CFG.hidden ** -0.5)
    gsb = torch.full((16,), xg.shape[0] // 16, dtype=torch.int32, device=DEV)
    counters.reset()
    outs = [grouped_matmul.grouped_matmul(h1, w2, gs, hs, s2, epilogue="dequant",
                                          out_dtype=torch.float32),
            grouped_matmul.grouped_matmul(h1, w2, gs),
            grouped_matmul.grouped_matmul(xb, wb, gsb, out_dtype=torch.bfloat16)]
    torch.cuda.synchronize()
    launches = counters.read()
    want = {"grouped_matmul:dequant_f32": 1, "grouped_matmul:none_int8": 1,
            "grouped_matmul_float:bf16_out": 1, "grouped_matmul": 2, "grouped_matmul_float": 1}
    if any(launches[k_] != v for k_, v in want.items()) or not all(
            bool(torch.isfinite(o.float()).all()) for o in outs):
        raise AssertionError(f"K8a's op modes: launches {launches}, want {want}")
    log(f"  K8a's op modes through grouped_matmul: launches {json.dumps(want)}")
    return launches


def dispatch_routes_phase(moe):
    """Phase [4l] (see the module docstring).  Returns the JSON results of
    K8a's four remaining modes and dispatch_p, K8b, K16a and K3 on float
    tokens, and their launches on their paths."""
    group = dist.group.WORLD
    gen = torch.Generator(device=DEV).manual_seed(SEED + 19)
    moe0 = moe[0]
    moe_n = narrow_packing(moe0)
    swiglu, f32, none, bf16 = check_k8a_modes(gen, moe0, moe_n)
    check_k8a_modes_small(gen)
    launches_ops = op_modes(gen, moe0)
    disp_l = {}
    for n_tok in (MAX_BATCH, PREFILL_CHUNK, 512):
        k8d, k8b, lc = check_dispatch_branch(gen, moe0, n_tok, True)
        disp_l = {k_: disp_l.get(k_, 0) + v for k_, v in lc.items()}
        kept = (k8d, k8b)                              # the last: 512 tokens
    narrow_l = {}
    for n_tok in (MAX_BATCH, 512, LONG_CHUNK):
        lc = check_narrow_moe(gen, group, moe0, moe_n, n_tok)
        narrow_l = {k_: narrow_l.get(k_, 0) + v for k_, v in lc.items()}
    del moe_n
    k16a, k16_l = None, {}
    for n_tok in (MAX_BATCH, PREFILL_CHUNK):
        r, lc = check_fused_dispatch(gen, group, moe0, n_tok, True)
        k16a = k16a or r                                # the decode step's
        k16_l = {k_: k16_l.get(k_, 0) + v for k_, v in lc.items()}
    k3f, k3_l = None, {}
    for n_tok in (MAX_BATCH, PREFILL_CHUNK):
        r, lc = check_gmm1_float(gen, moe0, n_tok, True)
        k3f = k3f or r
        k3_l = {k_: k3_l.get(k_, 0) + v for k_, v in lc.items()}
    results = {"grouped_matmul:dequant_swiglu": swiglu, "grouped_matmul:dequant_f32": f32,
               "grouped_matmul:none_int8": none, "grouped_matmul_float:bf16_out": bf16,
               "grouped_matmul:dispatch_p": kept[0], "grouped_matmul_combine": kept[1],
               "fused_dispatch_gmm1_rank": k16a, "gmm1_ring:float_x": k3f}
    launches = {"grouped_matmul:dequant_swiglu": narrow_l["grouped_matmul:dequant_swiglu"],
                **{k_: launches_ops[k_] for k_ in ("grouped_matmul:dequant_f32",
                                                    "grouped_matmul:none_int8",
                                                    "grouped_matmul_float:bf16_out")},
                "grouped_matmul:dispatch_p": disp_l["grouped_matmul:dispatch_p"],
                "grouped_matmul_combine": disp_l["grouped_matmul_combine"],
                "fused_dispatch_gmm1_rank": k16_l["fused_dispatch_gmm1_rank"],
                "gmm1_ring:float_x": k3_l["gmm1_ring:float_x"]}
    log(f"  [4l] launches on the paths: {json.dumps(launches)}")
    return results, launches



# [4p]: the rest of DeepEP's Buffer at DeepSeek-V3's decode width: the
# reference's low-latency default, 128 tokens a rank, top-8 of 256 experts,
# about a quarter of the (token, k) slots at -1 (its --topk-drop-prob)
LL_TOKENS = 128
LL_DROP = 0.25
LL_CALC_DIFF = 1e-4           # the reference's int8 bar (test_low_latency.py)
MR_TOKENS, MR_ROUND = 2048, 512          # multi-round: a prefill chunk in 512-token rounds
LL_TRANSPORTS = ("xla", "pallas", "pallas_ragged")


def calc_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The reference's ``calc_diff``: 1 - 2 <a, b> / (|a|^2 + |b|^2), in f64."""
    a, b = a.double(), b.double()
    return float(1 - 2 * (a * b).sum() / (a * a + b * b).sum())


def ll_inputs(gen, n_tok):
    """bf16 tokens, DeepSeek-V3's routing with ``LL_DROP`` of the slots at -1."""
    x = randn(gen, (n_tok, CFG.hidden))
    idx, w = deep_routing(gen, n_tok)
    idx = torch.where(torch.rand(idx.shape, generator=gen, device=DEV) < LL_DROP, -1, idx)
    return x, idx, w


def held_launches(label, launches, want):
    """Every kernel's count of ``launches`` equal to ``want``'s (0 where not
    named)."""
    named = {k_: want.get(k_, 0) for k_ in launches}
    bad = {k_: (v, named[k_]) for k_, v in launches.items() if v != named[k_]}
    if bad:
        raise AssertionError(f"{label}: launches (got, want) {bad}")
    return {k_: v for k_, v in want.items() if v}


def ll_expert_step(rx, sc):
    """JAX's sweep step on the packed layout of one rank (every expert
    local): y = dequant(recv_x) · (global expert id + 1), in bf16."""
    eid = torch.arange(1, rx.shape[0] + 1, device=DEV, dtype=torch.float32)
    return (rx.float() * sc[..., None] * eid[:, None, None]).to(torch.bfloat16)


def ll_round_trip(group, x, idx, w, backend):
    """One low-latency round trip on ``backend``: int8 dispatch (validated;
    monitored on ``"pallas_ragged"``), the expert step, the bf16 combine;
    the counts reset just before and read just after."""
    buf = Buffer(group, CFG.num_experts, EPConfig(comm_backend=backend))
    mon = backend == "pallas_ragged"
    counters.reset()
    rx, sc, cnt, h, st = buf.low_latency_dispatch(x, idx, use_int8=True, monitor=mon,
                                                  validate=True)
    out = buf.low_latency_combine(ll_expert_step(rx, sc), w, h, monitor=mon)
    torch.cuda.synchronize()
    launches = counters.read()
    out, cst = out if mon else (out, {})
    flags = [st["validation_flags"]] + ([st["timeout_flags"], cst["timeout_flags"]] if mon
                                        else [])
    if any(bool(f.any()) for f in flags):
        raise AssertionError(f"low-latency round trip on {backend!r}: flags {flags}")
    # "pallas": counts, rows, slots, scales and the return on K15a; "pallas_ragged":
    # the counts on K15a, the slot / scale blob on K15b, the rows both ways on K15c
    want = {"quant_per_token": 1,
            "pallas_all_to_all": {"xla": 0, "pallas": 5, "pallas_ragged": 1}[backend],
            "pallas_ragged_all_to_all": int(mon),
            "pallas_ragged_all_to_all_monitored": 2 * mon}
    return (rx, sc, cnt, st["recv_count_matrix"], st["num_dropped"], out), \
        held_launches(f"low-latency round trip on {backend!r}", launches, want)


def ll_golden(x, idx, w):
    """The dense golden of the round trip: Σ_k w · (e + 1) · x over the live
    slots, in f64."""
    live = idx >= 0
    scale = (torch.where(live, w.double() * (idx.double() + 1), 0.0)).sum(-1)
    return x.double() * scale[:, None]


def ll_round_trips(gen, group):
    """[4p] (a): the round trip on the three transports, bit-identical to
    ``"xla"``, held to the dense golden by ``calc_diff``."""
    x, idx, w = ll_inputs(gen, LL_TOKENS)
    ref, launches = None, {}
    for backend in LL_TRANSPORTS:
        res, launches[backend] = ll_round_trip(group, x, idx, w, backend)
        if ref is None:
            ref = res
        elif not all(torch.equal(a, b) for a, b in zip(res, ref)):
            raise AssertionError(f"the low-latency round trip on {backend!r} differs from 'xla'")
        del res
    rx, sc, cnt, cmat, dropped, out = ref
    diff = calc_diff(out, ll_golden(x, idx, w))
    live = int((idx >= 0).sum())
    log(f"  [4p a] low_latency_dispatch / combine, {LL_TOKENS} tokens x {CFG.hidden}, top-"
        f"{CFG.topk} of {CFG.num_experts}, {live} of {idx.numel()} slots live: packed "
        f"{list(rx.shape)} int8 ({rx.numel() / 1e6:.0f} MB), rows, scales, counts, "
        f"{int(dropped)} drops and the bf16 combine bit-identical on {list(LL_TRANSPORTS)}; "
        f"validation flags 0 on each, timeout flags 0 (K15c); calc_diff vs the dense golden "
        f"{diff:.3e} (bar {LL_CALC_DIFF}); launches {json.dumps(launches)}")
    if not (diff < LL_CALC_DIFF and int(cnt.sum()) == live and int(cmat.sum()) == live
            and int(dropped) == 0):
        raise AssertionError(f"the low-latency round trip is wrong: calc_diff {diff:.3e}")
    return x, idx, w


def ll_decode_moe(buf, x, idx, w, moe):
    """The decode MoE on the low-latency path: int8 dispatch → the live rows
    gathered by the counts → K8a ``dequant_swiglu_quant`` → K8a ``dequant`` →
    the rows back in the packed layout → combine (bf16)."""
    w1, s1, w2, s2 = moe
    rx, sc, cnt, h, st = buf.low_latency_dispatch(x, idx, use_int8=True)
    pair = x.shape[0] * min(CFG.topk, buf.num_local_experts)
    xs, ss, tgt = ep_core.packed_to_sorted(rx, sc, st["recv_count_matrix"], pair)
    q2, sq = grouped_matmul.grouped_matmul(xs, w1, cnt, ss, s1, epilogue="dequant_swiglu_quant")
    yv = grouped_matmul.grouped_matmul(q2, w2, cnt, sq, s2, epilogue="dequant")
    y = ep_core.sorted_to_packed(yv, tgt, rx.shape[0])
    return buf.low_latency_combine(y, w, h), cnt, st["num_dropped"]


def ll_moe_check(gen, group, moe, x, idx, w):
    """[4p] (b): the decode MoE on the low-latency path held to K16b and to
    the unfused normal-mode form (relative mean below ``EP_DEEP_REL_MEAN``),
    receive counts and drops exact."""
    buf = Buffer(group, CFG.num_experts, EPConfig(comm_backend="pallas_ragged"))
    counters.reset()
    got, cnt, drop = ll_decode_moe(buf, x, idx, w, moe)
    torch.cuda.synchronize()
    launches = held_launches("the low-latency decode MoE", counters.read(), {
        "quant_per_token": 1, "pallas_all_to_all": 1, "pallas_ragged_all_to_all": 3,
        "grouped_matmul": 2, "grouped_matmul:dequant_swiglu_quant": 1,
        "grouped_matmul:dequant": 1})
    counters.reset()
    k16b, kcnt, kdrop = buf.fused_deep_moe(x, idx, w, *moe, single_kernel=True)
    torch.cuda.synchronize()
    # K16b's call: its wire quant (K5) and the counts' exchange (K15a), then the kernel
    launches_k16b = held_launches("K16b on the low-latency tokens", counters.read(), {
        "fused_deep_moe_full_rank": 1, "quant_per_token": 1, "pallas_all_to_all": 1})
    unfused, ucnt, udrop = buf.fused_deep_moe(x, idx, w, *moe)
    torch.cuda.synchronize()
    rel_k, rel_u = rel_mean(got, k16b), rel_mean(got, unfused)
    exact = (torch.equal(cnt, kcnt) and torch.equal(cnt, ucnt)
             and int(drop) == int(kdrop) == int(udrop) == 0)
    log(f"  [4p b] decode MoE on the low-latency path (pallas_ragged; live rows gathered by "
        f"the counts on the device, {int(cnt.sum())} of {cnt.numel() * x.shape[0]} packed "
        f"slots; K8a dequant_swiglu_quant + dequant on [4]'s layer-0 experts): vs K16b "
        f"{rel_k:.3e}, vs the unfused normal-mode form {rel_u:.3e} (rel mean, bar "
        f"{EP_DEEP_REL_MEAN}); counts and drops exact {exact}; launches {json.dumps(launches)}, "
        f"K16b's {json.dumps(launches_k16b)}")
    if not (rel_k < EP_DEEP_REL_MEAN and rel_u < EP_DEEP_REL_MEAN and exact):
        raise AssertionError("the low-latency decode MoE disagrees with K16b or the unfused form")
    return launches


def mr_moe(buf, x, idx, w, moe, rounds):
    """Normal-mode dispatch in ``rounds`` rounds → K8a twice → combine."""
    w1, s1, w2, s2 = moe
    xs, sx, gs, h, st = buf.dispatch(x, idx, rounds=rounds)
    q2, sq = grouped_matmul.grouped_matmul(xs, w1, gs, sx, s1, epilogue="dequant_swiglu_quant")
    y = grouped_matmul.grouped_matmul(q2, w2, gs, sq, s2, epilogue="dequant")
    return buf.combine(y, w, h), gs, st["num_dropped"]


def multi_round_check(gen, group, moe):
    """[4p] (c): a 2048-token chunk in 512-token rounds
    (``normal_round_tokens``) on ``"pallas_ragged"``, K8a, combine:
    bit-identical to one round.  Each timed beside the other."""
    x = randn(gen, (MR_TOKENS, CFG.hidden))
    idx, w = deep_routing(gen, MR_TOKENS)
    buf = Buffer(group, CFG.num_experts, EPConfig(comm_backend="pallas_ragged",
                                                  normal_round_tokens=MR_ROUND))
    rounds = MR_TOKENS // MR_ROUND
    runs, launches = {}, {}
    for r in (rounds, 1):
        counters.reset()
        runs[r] = mr_moe(buf, x, idx, w, moe, None if r > 1 else 1)
        torch.cuda.synchronize()
        launches[r] = held_launches(f"{r}-round dispatch", counters.read(), {
            "quant_per_token": r, "pallas_all_to_all": r, "pallas_ragged_all_to_all": 3 * r,
            "grouped_matmul": 2, "grouped_matmul:dequant_swiglu_quant": 1,
            "grouped_matmul:dequant": 1})
    same = all(torch.equal(a, b) for a, b in zip(runs[rounds], runs[1]))
    times = {r: (time_ms(lambda r=r: buf.dispatch(x, idx, rounds=r), 5),
                 time_ms(lambda r=r: mr_moe(buf, x, idx, w, moe, r), 5)) for r in (rounds, 1)}
    log(f"  [4p c] multi-round dispatch: {MR_TOKENS} tokens x {CFG.hidden}, top-{CFG.topk}, "
        f"EPConfig(normal_round_tokens={MR_ROUND}) = {rounds} rounds on 'pallas_ragged', K8a, "
        f"combine: bit-identical to one round {same}; launches {json.dumps(launches)}")
    log(f"    dispatch {times[rounds][0]:.4f} ms in {rounds} rounds vs {times[1][0]:.4f} ms in "
        f"one; dispatch + K8a + combine {times[rounds][1]:.4f} vs {times[1][1]:.4f} ms")
    if not same:
        raise AssertionError("multi-round dispatch differs from one round")
    return launches[rounds]


def tp_layered_check(gen, group, x, idx, w):
    """[4p] (d): the TP all-gather / reduce and the layered dispatch /
    combine (normal and low-latency forms, int8, the node hop monitored on
    K15c) on one-rank groups, each equal to the plain EP path on the same
    inputs."""
    buf = Buffer(group, CFG.num_experts, EPConfig())
    rx, sc, cnt, h, st = buf.low_latency_dispatch(x, idx)
    want = buf.low_latency_combine(ll_expert_step(rx, sc), w, h, out_dtype=torch.float32)
    counters.reset()
    rx2, sc2, _, h2, st2 = buf.low_latency_dispatch(x, idx)
    gx, gsc, gcnt = ep_core.dispatch_tp_allgather(rx2, sc2, st2["recv_count_matrix"],
                                                  tp_group=group)
    y = ep_core.combine_tp_reduce(ll_expert_step(gx, gsc), tp_group=group,
                                  seg_total=rx2.shape[1])
    got_tp = buf.low_latency_combine(y, w, h2, out_dtype=torch.float32)
    torch.cuda.synchronize()
    l_tp = held_launches("the TP all-gather path", counters.read(), {"quant_per_token": 1})
    ok_tp = (torch.equal(gx, rx) and torch.equal(gsc, sc)
             and torch.equal(gcnt, st2["recv_count_matrix"]) and torch.equal(got_tp, want))
    del rx2, sc2, gx, gsc, y
    kw = dict(node_group=group, ici_group=group, num_nodes=1, ranks_per_node=1,
              seg_capacity=rx.shape[1])           # the low-latency layout's segment
    t, k = idx.shape
    opts = dict(num_experts=CFG.num_experts, phase1_capacity=t, phase2_capacity=t * k,
                use_int8=True, monitor=True, dcn_transport="monitored", **kw)
    counters.reset()
    d = layered.dispatch_layered(x, idx, **opts)
    got_l = layered.combine_layered(ll_expert_step(d["recv_x"], d["recv_scales"]), w,
                                    d["handle"], num_tokens=t, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    l_ll = held_launches("the layered low-latency form", counters.read(), {
        "quant_per_token": 1, "pallas_ragged_all_to_all_monitored": 1})
    err_l = max_abs(got_l, want) / float(want.abs().max())
    ok_l = (torch.equal(d["recv_x"], rx) and torch.equal(d["recv_scales"], sc)
            and torch.equal(d["recv_count"], cnt) and err_l <= 1e-6
            and not d["stats"]["dcn_timeout_flags"].any())
    del d
    xs, sx, gs, hn, _ = buf.dispatch(x, idx)
    eid = torch.arange(1, CFG.num_experts + 1, device=DEV, dtype=torch.float32)

    def rows_y(rows, scales, sizes):
        e, live = ep_core.sorted_row_expert(sizes, rows.shape[0])
        y = rows.float() * scales[:, None] * eid[e][:, None]
        return torch.where(live[:, None], y, 0.0).to(torch.bfloat16)

    want_n = buf.combine(rows_y(xs, sx, gs), w, hn, out_dtype=torch.float32)
    counters.reset()
    dn = layered.dispatch_layered_normal(x, idx, **opts)
    got_n = layered.combine_layered_normal(
        rows_y(dn["recv_x_sorted"], dn["recv_scales_sorted"], dn["group_sizes"]), w,
        dn["handle"], num_tokens=t, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    l_n = held_launches("the layered normal form", counters.read(), {
        "quant_per_token": 1, "pallas_ragged_all_to_all_monitored": 1})
    n = xs.shape[0]
    err_n = max_abs(got_n, want_n) / float(want_n.abs().max())
    ok_n = (torch.equal(dn["recv_x_sorted"][:n], xs) and not dn["recv_x_sorted"][n:].any()
            and torch.equal(dn["recv_scales_sorted"][:n], sx)
            and torch.equal(dn["group_sizes"], gs) and err_n <= 1e-6)
    del dn
    log(f"  [4p d] one-rank groups: dispatch_tp_allgather / combine_tp_reduce on the LL path "
        f"equal to it {ok_tp} (launches {json.dumps(l_tp)}); dispatch_layered / combine_layered "
        f"(int8, dcn_transport='monitored') rows, scales and counts bit-equal to "
        f"low_latency_dispatch's, combine {err_l:.2e} of its largest (f32 sums in another "
        f"order), no timeout: {ok_l} (launches {json.dumps(l_ll)}); dispatch_layered_normal / "
        f"combine_layered_normal vs Buffer.dispatch / combine: rows, scales and group sizes "
        f"bit-equal, combine {err_n:.2e}: {ok_n} (launches {json.dumps(l_n)})")
    if not (ok_tp and ok_l and ok_n):
        raise AssertionError("the TP all-gather or the layered path differs from the EP path")
    return l_ll


def ll_times(group, x, idx, w, card):
    """[4p] (f): the low-latency dispatch and combine on each transport,
    ``Buffer.dispatch`` / ``combine`` on the same tokens, and each call's
    bytes bound: the dispatch reads x and writes its output (the packed
    layout, zeros included: its contract), the combine reads the live rows
    and writes the tokens."""
    t, hidden = x.shape
    e_local = CFG.num_experts
    live = int((idx >= 0).sum())
    packed = e_local * t * hidden * 1 + e_local * t * 4
    b_disp = bound(t * hidden * 2 + idx.numel() * 4 + packed, 0, INT8_OPS)[0]
    b_comb = bound(live * hidden * 2 + t * hidden * 2 + w.numel() * 4, 0, INT8_OPS)[0]
    lines = []
    for backend in LL_TRANSPORTS:
        buf = Buffer(group, CFG.num_experts, EPConfig(comm_backend=backend))
        rx, sc, _, h, _ = buf.low_latency_dispatch(x, idx)
        y = ll_expert_step(rx, sc)
        d_ms = time_ms(lambda: buf.low_latency_dispatch(x, idx), 5)
        c_ms = time_ms(lambda: buf.low_latency_combine(y, w, h), 5)
        xs, _, _, hn, _ = buf.dispatch(x, idx)
        ys = xs.to(torch.bfloat16)
        nd_ms = time_ms(lambda: buf.dispatch(x, idx), 5)
        nc_ms = time_ms(lambda: buf.combine(ys, w, hn), 5)
        lines.append(f"    {card}, {backend}: low_latency_dispatch {d_ms:.4f} ms (bound {b_disp:.4f}), "
                     f"low_latency_combine {c_ms:.4f} ms (bound {b_comb:.4f}); Buffer.dispatch "
                     f"{nd_ms:.4f} ms, Buffer.combine {nc_ms:.4f} ms")
        del rx, sc, y, h
    log(f"  [4p f] times, {card}, {t} tokens x {hidden} int8, {live} live slots "
        f"(dispatch bound: x read, the {packed / 1e6:.0f} MB packed layout written; combine "
        f"bound: the live rows read, the tokens written; at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    for line in lines:
        log(line)


def low_latency_phase(moe, card):
    """Phase [4p] (see the module docstring): the rest of DeepEP's Buffer at
    DeepSeek-V3's decode width on [4]'s layer-0 experts and [4k]'s one-rank
    NCCL group.  Returns the launches of the low-latency round trip on
    ``"pallas_ragged"``, the decode MoE, multi-round dispatch and the
    layered hop."""
    group = dist.group.WORLD
    gen = torch.Generator(device=DEV).manual_seed(SEED + 23)
    x, idx, w = ll_round_trips(gen, group)
    gc.collect()
    torch.cuda.empty_cache()
    l_moe = ll_moe_check(gen, group, moe[0], x, idx, w)
    l_mr = multi_round_check(gen, group, moe[0])
    l_lay = tp_layered_check(gen, group, x, idx, w)
    ll_times(group, x, idx, w, card)
    gc.collect()
    torch.cuda.empty_cache()
    return {"moe": l_moe, "multi_round": l_mr, "layered": l_lay}


# [4m]: sampling parameters of the sampled requests (a seed each, by request index)
FEATURE_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9, min_p=0.05, repetition_penalty=1.1,
                        presence_penalty=0.2, frequency_penalty=0.1)
SPEC_K, SPEC_WIDTH = 2, 2
FEATURE_KERNELS = ("quant_matmul", "decode_mla", "mla_prefill_pallas", "gmm1_ring",
                   "gmm2_combine_ring")


class MethodTimer:
    """Synchronized wall time of an object's methods, wrapped around them:
    seconds in all (``s``) and of each call (``each``); with ``count`` (a
    callable) what it counts moved by each call (``moved``)."""

    def __init__(self, obj, names, count=lambda: 0):
        self.s, self.each, self.moved, self.count = 0.0, [], [], count
        for name in names:
            setattr(obj, name, self._wrap(getattr(obj, name)))

    def _wrap(self, fn):
        def run(*args):
            torch.cuda.synchronize()
            c0, t0 = self.count(), time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.each.append(time.perf_counter() - t0)
            self.moved.append(self.count() - c0)
            self.s += self.each[-1]
            return out
        return run


def feature_engine(params, moe, mla_wq, *, spec_k=0, width=1, mixed=True):
    """[4]'s engine (fused prologue, W8A8 experts, 64-token chunks) with its
    adapters' call counters (:class:`StepTimer`), and for ``spec_k`` a
    1-layer draft sharing the target's embedding, head and first layer (no
    copy) → ``(engine, target timer, draft timer or None, decode timer)``."""
    adapter = deepseek_adapter(CFG, params, torch.bfloat16, moe_weights_q=moe, mla_wq=mla_wq)
    timer, dtimer, draft = StepTimer(adapter), None, None
    if spec_k:
        draft = deepseek_adapter(dataclasses.replace(CFG, num_layers=1),
                                 dict(params, layers=params["layers"][:1]), torch.bfloat16,
                                 moe_weights_q=moe[:1], mla_wq=mla_wq[:1])
        dtimer = StepTimer(draft)
    eng = Engine(adapter, NUM_PAGES, max_batch=MAX_BATCH, max_pages_per_req=MAX_PAGES_PER_REQ,
                 prefill_chunk=PREFILL_CHUNK, mixed=mixed, spec_k=spec_k, draft_adapter=draft,
                 spec_tree_width=width)
    return eng, timer, dtimer, MethodTimer(eng, ("_decode", "_spec_decode_tree"))


def feature_want(launches, calls, dcalls):
    """[4]'s launches from its adapters' ``calls`` (and the draft's
    ``dcalls``, or None): K1, K2, K9a, K3 and K4 as the calls say (2 layers
    the target, 1 the draft; every MoE call at most 512 rows: the ring
    GEMMs; two K1 a layer a call)."""
    layer_calls = [(CFG.num_layers, calls)] + ([] if dcalls is None else [(1, dcalls)])
    pre = sum(nl * c["prefill"] for nl, c in layer_calls)
    dec = sum(nl * c["decode"] for nl, c in layer_calls)
    return {"decode_mla": dec, "mla_prefill_pallas": pre, "gmm1_ring": pre + dec,
            "gmm2_combine_ring": pre + dec, "quant_matmul": 2 * (pre + dec)}


def feature_run(label, eng, requests, timers, want=feature_want):
    """Serve ``requests`` (``add_request`` keyword dicts) with the launch
    counts reset just before and read just after; checks that every page and
    state slot came back and that the kernels ``want(launches, target calls,
    draft calls or None)`` names launched exactly as often as it says →
    (tokens, counts, decode tok/s)."""
    timer, dtimer, dec = timers
    counters.reset()
    t0 = time.perf_counter()
    rids = [eng.add_request(**r) for r in requests]
    while eng.waiting or eng.running:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    outs = [eng.finished[r] for r in rids]
    if (eng.cm.free_pages + eng.cm.cached_pages != eng.cm.num_pages
            or sorted(eng._free_state_slots) != list(range(eng.max_batch))):
        raise AssertionError(f"{label}: KV pages or state slots leaked")
    expected = want(launches, timer.calls, None if dtimer is None else dtimer.calls)
    got = {k: launches[k] for k in expected}
    if got != expected:
        raise AssertionError(f"{label}: launches {got}, want {expected} from the model calls "
                             f"{[timer.calls] + ([] if dtimer is None else [dtimer.calls])}")
    n_dec = sum(len(o) - 1 for o in outs)
    log(f"  {label}: {len(outs)} requests in {wall:.2f} s wall; decode {n_dec} tokens in "
        f"{dec.s:.3f} s = {n_dec / dec.s:.1f} tok/s; launches "
        f"{json.dumps({k: v for k, v in got.items() if v})} (of {len(got)} counted); all pages "
        f"and state slots returned")
    return outs, got, n_dec / dec.s


class VerifyRecorder:
    """Keeps, for every token a speculative engine emits after a request's
    first, the verify row that emitted it: the target's logits there (f32),
    each layer's routing (expert ids and weights) and router selection
    scores.  Wraps the engine's rounds (to know the round's requests), its
    verify calls (routing recorded by :func:`with_routes` on ``model``'s
    router, the head's output captured: the packed verify, or a one-request
    target's verifies, a request each, joined in the round's request order;
    its catch-up prefills, under k + 1 rows, are not verifies) and
    ``_commit`` (which tokens of the round a request took: token ``j`` comes
    from the row at position ``prompt + j - 1`` of the branch whose earlier
    rows carry the accepted tokens)."""

    def __init__(self, eng, model=m):
        self.eng, self.rows, self.live, self.last, self.parts = eng, {}, None, None, []
        verify, verify_one = eng._verify, eng._verify_one
        commit, tree_round = eng._commit, eng._spec_tree_round

        def recorded_round(live):
            self.live, self.parts = live, []
            return tree_round(live)

        def recording(call, *args):
            head, seen = eng.a.lm_head, []
            eng.a.lm_head = lambda x: seen.append(head(x)) or seen[-1]
            try:
                out, rec = with_routes(lambda: call(*args), model=model, scores=True)
            finally:
                eng.a.lm_head = head
            self.parts.append((seen[0].float(), rec, args[0].tolist()))
            return out

        def recorded_one(ids, seq_len, *rest):
            if seq_len < eng.spec_k + 1:                 # a catch-up prefill
                return verify_one(ids, seq_len, *rest)
            return recording(verify_one, ids, seq_len, *rest)

        def recorded_commit(r, new):
            if self.parts:                               # the round's verifies, joined
                rec = Record()
                rec.extend((torch.cat([p[1][li][0] for p in self.parts]),
                            torch.cat([p[1][li][1] for p in self.parts]))
                           for li in range(len(self.parts[0][1])))
                rec.scores.extend(torch.cat([p[1].scores[li] for p in self.parts])
                                  for li in range(len(self.parts[0][1].scores)))
                self.last = (torch.cat([p[0] for p in self.parts]), rec,
                             sum((p[2] for p in self.parts), []))
                self.parts = []
            j0 = len(r.out_tokens)
            commit(r, new)
            i = next(n for n, x in enumerate(self.live) if x is r)
            d, width = eng.spec_k + 1, eng.spec_width
            logits, rec, ids = self.last
            for t in range(len(r.out_tokens) - j0):
                s = next(i * width + p for p in range(width)
                         if ids[(i * width + p) * d + 1 : (i * width + p) * d + t + 1] == new[:t])
                row = s * d + t
                self.rows[(r.rid, j0 + t)] = (logits[row], [(ri[row], rw[row]) for ri, rw in rec],
                                              [sc[row] for sc in rec.scores])

        eng._spec_tree_round, eng._commit = recorded_round, recorded_commit
        eng._verify = lambda *args: recording(verify, *args)
        eng._verify_one = recorded_one


def teacher_forced(make_engine, ps, toks, forced_rows, n_new=NEW_TOKENS, model=m):
    """The decode path on the speculative run's own tokens: a plain engine
    (``make_engine()``, ``mixed=False``), prefill first, then one decode call
    a token index ``j >= 1`` over the requests that emitted one, each row's
    input its token ``j - 1``; run once on its own routing (``model``'s
    router) and once with each row's routing forced to the verify row's
    (``forced_rows[(rid, j)]``; pad rows to experts 0..k-1 at weight 0).  A
    target with recurrent state (its adapter's snapshot hooks) has the state
    restored between the two calls, so that each call advances it once, and
    goes on from the forced call: a router flip between the two paths would
    otherwise leave the decode path's state on another history than the
    speculative engine's for every later token.  Returns ``(own, forced)``:
    ``{(rid, j): (logits, routing, router scores)}`` of the first run and
    ``{(rid, j): logits}`` of the second."""
    eng = make_engine()
    for p in ps:
        eng.add_request(p, n_new)
    while eng.waiting or any(r.pos < r.prompt_len for r in eng.running):
        eng.step()
    reqs = sorted(eng.running, key=lambda r: r.rid)
    if [r.out_tokens for r in reqs] != [t[:1] for t in toks]:
        raise AssertionError("teacher forcing: the first tokens differ from the run's")
    own, forced = {}, {}
    for j in range(1, n_new):
        live = [r for r in reqs if len(toks[r.rid]) > j]
        if not live:
            break
        for r in live:
            r.out_tokens = list(toks[r.rid][:j])
        batch = eng.decode_inputs(live)
        si = batch.state_idx[: len(live)]
        if eng.a.snapshot_state is not None:
            snap = eng.a.snapshot_state(eng.caches, si)
        logits, rec = with_routes(lambda: eng.decode_logits(batch)[: len(live)].float(),
                                  model=model, scores=True)
        forced_rec = Record()
        for li, (ids, w) in enumerate(rec):
            fi = torch.arange(ids.shape[1], dtype=ids.dtype, device=DEV).expand_as(ids).clone()
            fw = torch.zeros_like(w)
            for n, r in enumerate(live):
                fi[n], fw[n] = forced_rows[(r.rid, j)][1][li]
            forced_rec.append((fi, fw))
        if eng.a.snapshot_state is not None:
            eng.caches = eng.a.restore_state(eng.caches, snap, si)
        flogits, _ = with_routes(lambda: eng.decode_logits(batch)[: len(live)].float(),
                                 forced_rec, model=model)
        for n, r in enumerate(live):
            own[(r.rid, j)] = (logits[n], [(ids[n], w[n]) for ids, w in rec],
                               [sc[n] for sc in rec.scores])
            forced[(r.rid, j)] = flogits[n]
    return own, forced


def flip_margin(c, mine, other, n_group=CFG.n_group, topk_group=CFG.topk_group):
    """How far the router selection scores ``c [E]`` (one row, one layer;
    :func:`router_choice`) prefer the expert set ``mine``, the router's
    choice on them, to another set ``other`` → ``(margin, scale)``, the
    largest |score| at that level.  Where ``other`` takes an expert outside
    the ``topk_group`` groups that ``c`` ranks best (a group's score is its
    two best experts' sum, as the router's), the margin is between groups:
    the weakest chosen group's score less the best of ``other``'s outside
    ones; else between experts: the weakest of ``mine`` not in ``other``
    less the best of ``other`` not in ``mine``.  0 is a tie.  A router
    without groups (Qwen3-Next's) is one group of all experts."""
    per = c.shape[0] // n_group
    gs = torch.topk(c.reshape(n_group, per), 2, dim=-1).values.sum(-1)
    groups = set(torch.topk(gs, topk_group).indices.tolist())
    outside = {int(e) // per for e in other} - groups
    if outside:
        return (float(min(gs[g] for g in groups) - max(gs[g] for g in outside)),
                float(gs.abs().max()))
    a, b = set(mine.tolist()), set(other.tolist())
    return float(min(c[e] for e in a - b) - max(c[e] for e in b - a)), float(c.abs().max())


def spec_rule(label, got, want, recorder, replay, margin=flip_margin, held=True):
    """Speculative tokens ``got`` against the greedy reference ``want``.
    Verify and decode run different kernels (DeepSeek-V3's verify is one
    varlen prefill: K9a over short sequences, K1 / K3 / K4 at B·(k+1) rows;
    Qwen3-Next's a prefill a request: the GDN chunk rule and K12d, where
    decode runs the recurrent update and K11a), so a near-tie of the head's
    argmax or of a router's top-k can flip a token, and the run diverges
    from there.  Every emitted token's verify row (``recorder``) is replayed
    on the decode path on the same tokens (``replay(got, recorder.rows)`` →
    ``(own, forced)``, :func:`teacher_forced`'s), and the run fails unless:

    - with the routing forced to the verify row's, every row holds to
      :func:`routing_rule` ([4]'s steps' rule: 5e-2 of a row's largest
      |logit|, top-1 equal wherever the top-2 margin exceeds twice the
      row's error);
    - every row whose verify routing differs from the decode path's own
      does so at a near-tie: at the first layer where the expert sets
      differ, the decode router prefers its own choice by at most 5e-2 of
      its largest score there (``margin``, :func:`flip_margin`);
    - at each request's first token that differs from ``want`` where the
      routing agrees, the decode path's own logits' top-2 gap is at most
      5e-2 of the row's largest |logit| (where it differs, the rule above
      holds it).

    With ``held`` False the figures are printed and nothing is held.
    Returns the count of requests that needed the replay."""
    tol = 5e-2
    own, forced = replay(got, recorder.rows)
    keys = sorted(forced)
    if set(keys) != set(recorder.rows):
        raise AssertionError(f"{label}: {len(keys)} decode rows, {len(recorder.rows)} verify rows")

    def sets(route):
        return [torch.sort(ids).values for ids, _ in route]

    flipped = {}      # (rid, j) -> (layer, margin, scale, |score error|)
    for k in keys:
        mine, other = sets(own[k][1]), sets(recorder.rows[k][1])
        li = next((li for li, (a, b) in enumerate(zip(mine, other)) if not torch.equal(a, b)),
                  None)
        if li is not None:
            c = own[k][2][li]
            flipped[k] = (li, *margin(c, own[k][1][li][0], recorder.rows[k][1][li][0]),
                          float((recorder.rows[k][2][li] - c).abs().max()))
    ok = routing_rule(f"{label}: every emitted token's verify row", torch.stack(
        [recorder.rows[k][0] for k in keys]), torch.stack([forced[k] for k in keys]),
        torch.tensor([k not in flipped for k in keys], device=DEV), logits=True, forced=True,
        vs="the decode path on the same tokens")
    wide = {k: f for k, f in flipped.items() if f[1] > tol * f[2]}
    worst = max((f[1] / f[2] for f in flipped.values()), default=0.0)
    layers = sorted({f[0] for f in flipped.values()})
    log(f"  {label}: {len(flipped)} of {len(keys)} verify rows route otherwise than the decode "
        f"path (first at layers {layers}); there the decode router prefers its own choice by at "
        f"most {worst:.3e} of its largest score (tol {tol}), the two routers' scores differing "
        f"by up to {max((f[3] for f in flipped.values()), default=0.0):.3e}; "
        f"{len(wide)} rows wider")
    replays, gaps = 0, []
    for rid, (g_, w) in enumerate(zip(got, want)):
        if g_ == w:
            continue
        j = next((t for t in range(min(len(g_), len(w))) if g_[t] != w[t]), None)
        if j is None or j == 0:
            raise AssertionError(f"{label}: request {rid}: {g_} against {w}")
        logits = own[(rid, j)][0]
        top = torch.topk(logits, 2)
        gap = float(top.values[0] - top.values[1]) / float(logits.abs().max())
        routed = ("agrees" if (rid, j) not in flipped else
                  f"differs from layer {flipped[(rid, j)][0]}, router margin "
                  f"{flipped[(rid, j)][1] / flipped[(rid, j)][2]:.3e} of its largest score")
        log(f"    request {rid} differs at token {j} ({g_[j]} against {w[j]}): replayed decode "
            f"logits' top-2 gap {gap:.3e} of their largest |logit| "
            f"{float(logits.abs().max()):.3f} (tol {tol} where the routing agrees), their argmax "
            f"{int(top.indices[0])}; the verify row's routing {routed}")
        if (rid, j) not in flipped:
            gaps.append(gap)
        replays += 1
    log(f"  {label}: {len(got) - replays} of {len(got)} requests equal to the reference's "
        f"tokens, {replays} replayed at their first differing token ({len(gaps)} with the "
        f"routing agreeing, top-2 gap at most {max(gaps, default=0.0):.3e})")
    if not held:
        log(f"  {label}: the rule above is a reading here, not held")
        return replays
    if not ok:
        raise AssertionError(f"{label}: verify rows disagree with the decode path")
    if wide:
        raise AssertionError(f"{label}: verify rows route otherwise than the decode path away "
                             f"from a near-tie: {wide}")
    if any(g > tol for g in gaps):
        raise AssertionError(f"{label}: a first differing token's top-2 gap exceeds {tol} of "
                             f"the largest |logit| with the routing agreeing: {gaps}")
    return replays


def check_sampler_on_card(params, ps):
    """``sample_tokens`` on a head's f32 logits (8 rows of [4]'s vocabulary)
    on the card against the CPU's on a copy: the PRNG's bits bit-equal, the
    same tokens for greedy, filtered and composed rows."""
    ids = torch.tensor([p[-1] for p in ps] + [1, 2], dtype=torch.int32, device=DEV)
    logits = m.lm_head(params, m.embed(params, ids)).float()
    b = logits.shape[0]
    seeds = torch.arange(b, dtype=torch.int32) * 7 - 3
    steps = torch.arange(b, dtype=torch.int32) + 11
    temp = torch.tensor([0.0, 0.8, 1.0, 0.8, 1.3, 0.5, 0.8, 1.0])
    tk = torch.tensor([0, 50, 0, 0, 20, 0, 50, 5], dtype=torch.int32)
    tp = torch.tensor([1.0, 0.9, 1.0, 0.95, 1.0, 1.0, 0.9, 0.5])
    mp = torch.tensor([0.0, 0.05, 0.0, 0.0, 0.0, 0.1, 0.05, 0.0])
    host = (seeds, steps, temp, tk, tp, mp)
    want = sampling.sample_tokens(logits.cpu(), *host)
    got = sampling.sample_tokens(logits, *(t.to(DEV) for t in host))
    key = prng.fold_in(prng.key(seeds.to(DEV)), steps.to(DEV))
    bits_card = prng.random_bits(key, logits.shape[1]).cpu()
    bits_host = prng.random_bits(prng.fold_in(prng.key(seeds), steps), logits.shape[1])
    same_bits = torch.equal(bits_card, bits_host)
    log(f"  sample_tokens on the card {got.tolist()}, on the CPU {want.tolist()}; the PRNG's "
        f"{b} x {logits.shape[1]} bits bit-equal {same_bits}")
    if not (same_bits and torch.equal(got.cpu(), want)):
        raise AssertionError("sample_tokens on the card disagrees with the CPU's")


def engine_features_phase(params, moe, mla_wq, ps, card):
    """[4m]: sampling, stop tokens and prefill-first scheduling, then chain
    and tree speculation, on [4]'s setup (see the module docstring)."""
    plain = feature_engine(params, moe, mla_wq)
    ref, _, ref_rate = feature_run(
        "greedy reference", plain[0], [dict(prompt=p, max_new_tokens=NEW_TOKENS) for p in ps],
        plain[1:])
    stop_row, stop_at = 2, 4
    stop = ref[stop_row][stop_at]
    reqs = []
    for i, p in enumerate(ps):
        r = dict(prompt=p, max_new_tokens=NEW_TOKENS)
        if i % 2:
            r["sampling"] = SamplingParams(**FEATURE_SAMPLING, seed=SEED + i)
        if i == stop_row:
            r["stop_tokens"] = [stop]
        reqs.append(r)
    runs = []
    for label, mixed in (("sampled serve", True), ("sampled serve again", True),
                         ("sampled serve, mixed=False", False)):
        eng = feature_engine(params, moe, mla_wq, mixed=mixed)
        runs.append(feature_run(label, eng[0], reqs, eng[1:])[0])
    if runs[0] != runs[1] or runs[0] != runs[2]:
        raise AssertionError(f"sampled serves differ: {runs}")
    got = runs[0]
    want_stop = ref[stop_row][: ref[stop_row].index(stop) + 1]
    greedy_ok = all(got[i] == ref[i] for i in range(len(ps)) if i % 2 == 0 and i != stop_row)
    sampled_moved = sum(got[i] != ref[i] for i in range(1, len(ps), 2))
    log(f"  greedy rows equal the reference's {greedy_ok}; stop token {stop} ends request "
        f"{stop_row} after {len(got[stop_row])} tokens ({got[stop_row] == want_stop}); "
        f"{sampled_moved} of {len(ps) // 2} sampled requests differ from greedy")
    if not greedy_ok or got[stop_row] != want_stop or sampled_moved == 0:
        raise AssertionError("the sampled serve's greedy rows, stop token or sampled rows are "
                             "wrong")
    check_sampler_on_card(params, ps)
    counts = torch.zeros((MAX_BATCH, CFG.vocab_size), dtype=torch.int32).numpy()
    copy_ms = statistics.median(_copy_ms(counts) for _ in range(20))
    log(f"  the penalties' counts [{MAX_BATCH}, {CFG.vocab_size}] int32 from the host: "
        f"{copy_ms:.3f} ms a decode step (median of 20, pageable memory)")
    rates = {"plain": ref_rate}
    for label, width in (("chain speculation (spec_k=2)", 1),
                         (f"tree speculation (spec_k=2, spec_tree_width={SPEC_WIDTH})",
                          SPEC_WIDTH)):
        eng = feature_engine(params, moe, mla_wq, spec_k=SPEC_K, width=width)
        recorder = VerifyRecorder(eng[0])
        outs, _, rate = feature_run(label, eng[0], [dict(prompt=p, max_new_tokens=NEW_TOKENS)
                                                    for p in ps], eng[1:])
        st = eng[0].stats
        log(f"    {st['spec_rounds']} rounds, {st['spec_accepted']} drafts accepted "
            f"({st['spec_accepted'] / st['spec_rounds']:.2f} a round over the live requests)")
        spec_rule(label, outs, ref, recorder,
                  lambda toks, rows: teacher_forced(
                      lambda: feature_engine(params, moe, mla_wq, mixed=False)[0], ps, toks,
                      rows))
        rates["chain" if width == 1 else "tree"] = rate
    log(f"  decode tok/s ({card}): plain {rates['plain']:.1f}, chain {rates['chain']:.1f}, "
        f"tree {rates['tree']:.1f}")


def _copy_ms(a) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.from_numpy(a).to(DEV)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# [4n]: the host KV tier on [4c]'s setup (int8 latent cache, fused prologue,
# W8A8 experts, 2048-token chunks, its five prompts); a host pool of 128
# pages holds their 83 distinct full pages.  transfer_kv_dim_exchange at
# DeepSeek-V3's 61 layers of that cache, all 256 pages, 16 sentinel host
# pages on each side of the named ones.
HOST_POOL_PAGES = 128
XFER_SENTINEL, XFER_ITERS = 16, 5


def serve_ttft(eng, ps, n_new):
    """Serve ``ps`` (all arriving at once, ``n_new`` tokens each) with the
    launch counts reset just before and read just after → (tokens, each
    request's time to first token in s, wall s, counts).  A step reads its
    new tokens to the host, so the clock after it sees them."""
    counters.reset()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, n_new) for p in ps]
    first = {}
    while eng.waiting or eng.running:
        eng.step()
        now = time.perf_counter() - t0
        for rid in [r.rid for r in eng.running if r.out_tokens] + list(eng.finished):
            first.setdefault(rid, now)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [eng.finished[r] for r in rids], [first[r] for r in rids], wall, counters.read()


def page_prefixes(ps, spans, page) -> int:
    """The distinct full-page prefixes among ``ps[i][:spans[i]]``: the pages
    a radix holds for them."""
    return len({tuple(p[: k * page]) for p, n in zip(ps, spans) for k in range(1, n // page + 1)})


def held_pages(eng, tokens):
    """The device pages ``eng``'s radix holds for ``tokens`` (the hold taken
    by the match released)."""
    toks = torch.tensor(tokens, dtype=torch.int32).numpy()
    n, pages = eng.cm.match(toks)
    if n:
        eng.cm.release(toks[:n])
    if n != len(tokens):
        raise AssertionError(f"the radix holds {n} of {len(tokens)} tokens")
    return torch.from_numpy(pages.astype("int64")).to(DEV)


def tier_rate(timer, page_bytes) -> str:
    """A host-tier timer's calls: each one's pages and ms, and GB/s over
    the calls after the first."""
    calls = ", ".join(f"{n} / {t * 1e3:.2f}" for n, t in zip(timer.moved, timer.each))
    gb = sum(timer.moved[1:]) * page_bytes / 1e9
    return (f"pages / ms a call {calls}; after the first {gb * 1e3:.2f} MB in "
            f"{sum(timer.each[1:]) * 1e3:.2f} ms = {gb / sum(timer.each[1:]):.2f} GB/s")


def pd_disaggregation(params, moe, mla_wq8, lps, card):
    """[4n] part 1: a prefill engine P and a decode engine D over one
    ``HostKVPool``; P's caches paused and resumed through ``MemorySaver``."""
    page = CFG_INT8.page_size
    pool = HostKVPool(HOST_POOL_PAGES, page)

    def engine():
        adapter = deepseek_adapter(CFG_INT8, params, torch.bfloat16, moe_weights_q=moe,
                                   mla_wq=mla_wq8)
        timer = StepTimer(adapter)
        eng = Engine(adapter, LONG_NUM_PAGES, max_batch=MAX_BATCH,
                     max_pages_per_req=LONG_PAGES_PER_REQ, prefill_chunk=LONG_CHUNK,
                     host_pool=pool)
        return (eng, timer,
                MethodTimer(eng, ("_host_offload",), lambda: eng.stats["host_offloaded_pages"]),
                MethodTimer(eng, ("_host_restore",),
                            lambda: eng.stats["host_restored_tokens"] // page))

    gc.collect()
    torch.cuda.empty_cache()
    p_eng, _, p_off, _ = engine()
    page_bytes = sum(t[0].nbytes for t in cache_tensors(p_eng.caches))
    _, ttft_p, wall_p, _ = serve_ttft(p_eng, lps, 1)
    want_off = page_prefixes(lps, [len(p) for p in lps], page)
    if p_eng.stats["host_offloaded_pages"] != want_off:
        raise AssertionError(f"P offloaded {p_eng.stats['host_offloaded_pages']} pages, want "
                             f"{want_off}")
    log(f"  P (prefill engine) served the {len(lps)} prompts for one token each in {wall_p:.2f} s "
        f"and offloaded {want_off} pages ({page_bytes} bytes a page) in {len(p_off.each)} calls: "
        f"{tier_rate(p_off, page_bytes)}; the first call shapes the {HOST_POOL_PAGES}-page pinned "
        f"pool")

    saver = MemorySaver()
    tensors = cache_tensors(p_eng.caches)
    for i, t in enumerate(tensors):
        saver.register(f"kv{i}", t, tag="kv")
    before = [digest(t) for t in tensors]
    registered = sum(t.nbytes for t in tensors)
    gc.collect()
    torch.cuda.empty_cache()              # only the regions' segments are left to free
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    freed = saver.pause("kv")
    pause_ms = (time.perf_counter() - t0) * 1e3
    back = torch.cuda.mem_get_info()[0] - free0
    t0 = time.perf_counter()
    saver.resume("kv")
    torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t0) * 1e3
    log(f"  MemorySaver: P's {len(tensors)} cache tensors, {registered} bytes: pause "
        f"{pause_ms:.2f} ms returned {freed} bytes, {back} released to CUDA "
        f"({back / registered:.3f} of them by mem_get_info); resume {resume_ms:.2f} ms")
    if freed != registered or back < 0.9 * registered:
        raise AssertionError("pause freed too little")
    if [digest(t) for t in cache_tensors(p_eng.caches)] != before:
        raise AssertionError("the resumed caches differ from the paused ones")

    matched = [(len(p) - 1) // page * page for p in lps]
    cached0 = p_eng.stats["cached_tokens"]
    t_p2, ttft_p2, _, _ = serve_ttft(p_eng, lps, NEW_TOKENS)
    if p_eng.stats["cached_tokens"] - cached0 != sum(matched):
        raise AssertionError("P's second serve missed its device radix")
    d_eng, d_timer, _, d_res = engine()
    t_d, ttft_d, _, launches = serve_ttft(d_eng, lps, NEW_TOKENS)
    # the prefix two prompts share is restored once: the second finds it in
    # D's device radix
    want_restored = page_prefixes(lps, matched, page) * page
    st = d_eng.stats
    if (st["cached_tokens"], st["host_restored_tokens"], st["prefill_tokens"]) != (
            sum(matched), want_restored, sum(len(p) for p in lps) - sum(matched)):
        raise AssertionError(f"D's stats {st}: want cached {sum(matched)}, restored "
                             f"{want_restored}, prefill {sum(len(p) for p in lps) - sum(matched)}")
    if t_d != t_p2:
        raise AssertionError(f"D's tokens differ from P's second serve: {t_d} vs {t_p2}")
    for p, m in zip(lps, matched):
        pp, dp = held_pages(p_eng, p[:m]), held_pages(d_eng, p[:m])
        for tp, td in zip(cache_tensors(p_eng.caches), cache_tensors(d_eng.caches), strict=True):
            if digest(tp[pp]) != digest(td[dp]):
                raise AssertionError("a restored page differs from P's")
    for eng in (p_eng, d_eng):
        if eng.cm.free_pages + eng.cm.cached_pages != LONG_NUM_PAGES:
            raise AssertionError("KV pages leaked")
    layers, pre, dec = CFG_INT8.num_layers, d_timer.calls["prefill"], d_timer.calls["decode"]
    want = {"quant_matmul": 2 * layers * (pre + dec), "decode_mla": layers * dec,
            "mla_prefill_pallas": layers * pre, "grouped_matmul": 2 * layers * pre,
            "gmm1_ring": layers * dec, "gmm2_combine_ring": layers * dec}
    got = {k: launches[k] for k in want}
    if got != want or pre != len(lps):
        raise AssertionError(f"D's launches {got} over {pre} prefill and {dec} decode calls; "
                             f"want {want} and {len(lps)} prefill calls")
    log(f"  D (decode engine) restored {want_restored} tokens in {len(d_res.each)} admissions: "
        f"{tier_rate(d_res, page_bytes)}; prefilled {st['prefill_tokens']} tail tokens in {pre} calls of {LONG_CHUNK} rows; its "
        f"{len(t_d)} x {NEW_TOKENS} tokens equal P's second serve's; restored pages bit-equal "
        f"to P's; launches {json.dumps(got)}; all pages returned")
    log(f"  time to first token ({card}), mean / max over the {len(lps)} prompts: P "
        f"{1e3 * statistics.mean(ttft_p):.1f} / {1e3 * max(ttft_p):.1f} ms, P again (device "
        f"radix) {1e3 * statistics.mean(ttft_p2):.1f} / {1e3 * max(ttft_p2):.1f} ms, D (host "
        f"restore) {1e3 * statistics.mean(ttft_d):.1f} / {1e3 * max(ttft_d):.1f} ms")


def timed_s(fn) -> float:
    """Median synchronized wall seconds of ``XFER_ITERS`` calls."""
    out = []
    for _ in range(XFER_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def transfer_at_scale(gen, card):
    """[4n] part 2: ``transfer_kv_dim_exchange`` over DeepSeek-V3's 61
    layers of the int8 latent cache (nope int8 ``[256, 1, 128, 512]``, rope
    bf16 ``[256, 1, 64, 128]``), every page, against a plain pinned
    ``copy_`` of the same bytes."""
    n, L, s = LONG_NUM_PAGES, FULL_LAYERS, XFER_SENTINEL
    nope = [torch.randint(-128, 128, (n, 1, CFG.page_size, CFG.kv_lora_rank), generator=gen,
                          dtype=torch.int8, device=DEV) for _ in range(L)]
    rope = [randn(gen, (n, 1, CFG.qk_rope_dim, CFG.page_size)) for _ in range(L)]
    orig = [t.clone() for t in nope + rope]
    host = [torch.full((n + 2 * s, L) + tuple(t.shape[1:]), 7, dtype=t.dtype, pin_memory=True)
            for t in (nope[0], rope[0])]
    nbytes = sum(t.nbytes for t in orig)
    d_idx = torch.randperm(n, generator=torch.Generator().manual_seed(SEED)).numpy()
    h_idx = torch.arange(s, s + n).numpy()
    D2H, H2D = kvcacheio.TransferDirection.D2H, kvcacheio.TransferDirection.H2D

    def move(direction, d=d_idx, h=h_idx):
        kvcacheio.transfer_kv_dim_exchange(d, h, nope, host[0], rope, host[1],
                                           page_size=CFG.page_size, direction=direction)

    d2h_s = timed_s(lambda: move(D2H))
    for pool in host:
        if not ((pool[:s] == 7).all() and (pool[s + n:] == 7).all()):
            raise AssertionError("D2H wrote host pages it was not given")
    for t in nope + rope:
        t.zero_()
    h2d_s = timed_s(lambda: move(H2D))
    if not all(torch.equal(t, o) for t, o in zip(nope + rope, orig)):
        raise AssertionError("the 61-layer round trip is not bit-equal")
    # 64 named pages in two runs of host ids, out of order: the others stay 0
    for t in nope + rope:
        t.zero_()
    d_sel, h_sel = d_idx[:64], h_idx[list(range(32, 64)) + list(range(32))]
    move(H2D, d_sel, h_sel)
    rest = torch.from_numpy(d_idx[64:]).to(DEV)
    pos = {int(h): i for i, h in enumerate(h_idx)}
    src_pages = torch.tensor([int(d_idx[pos[int(h)]]) for h in h_sel], device=DEV)
    dst_pages = torch.from_numpy(d_sel).to(DEV)
    for t, o in zip(nope + rope, orig):
        if not torch.equal(t[dst_pages], o[src_pages]) or t[rest].any():
            raise AssertionError("a partial H2D moved the wrong pages")
    staged = [torch.empty((n,) + tuple(p.shape[1:]), dtype=p.dtype, device=DEV) for p in host]
    copy_d2h = timed_s(lambda: [p[s:s + n].copy_(g, non_blocking=True)
                                for p, g in zip(host, staged)])
    copy_h2d = timed_s(lambda: [g.copy_(p[s:s + n], non_blocking=True)
                                for p, g in zip(host, staged)])
    gb = nbytes / 1e9
    log(f"  transfer_kv_dim_exchange, {L} layers x {n} pages ({gb:.3f} GB: int8 latent + bf16 "
        f"rope; {card}; medians of {XFER_ITERS}): D2H {d2h_s * 1e3:.2f} ms = "
        f"{gb / d2h_s:.2f} GB/s against a pinned copy_ of the same bytes {copy_d2h * 1e3:.2f} ms "
        f"= {gb / copy_d2h:.2f} GB/s ({copy_d2h / d2h_s:.3f} of it); H2D {h2d_s * 1e3:.2f} ms = "
        f"{gb / h2d_s:.2f} GB/s against {copy_h2d * 1e3:.2f} ms = {gb / copy_h2d:.2f} GB/s "
        f"({copy_h2d / h2d_s:.3f}); round trip bit-equal, sentinel host pages and unnamed device "
        f"pages untouched")


def slot_ops_on_card():
    """[4n] part 3: the slot and cache-location ops once on the card at an
    engine's size, each equal to its CPU result."""
    g = torch.Generator().manual_seed(SEED + 11)
    page, b = CFG.page_size, MAX_BATCH
    pre = torch.randint(0, 4000, (b,), generator=g, dtype=torch.int32)
    seq = pre + torch.randint(1, LONG_CHUNK + 1, (b,), generator=g, dtype=torch.int32)
    last = pre * 7 + 3
    free = torch.randperm(4096, generator=g).to(torch.int32)
    pool = torch.randint(0, 1 << 20, (64, 8192), generator=g, dtype=torch.int32)
    req = torch.randperm(64, generator=g)[:b].to(torch.int32)
    start = torch.randint(0, 4096, (b,), generator=g, dtype=torch.int32)
    end = start + torch.randint(0, 2048, (b,), generator=g, dtype=torch.int32)
    total = int((end - start).sum())
    locs = torch.randint(0, 1 << 20, (total,), generator=g, dtype=torch.int32)
    kv_dst = torch.randn((16384, 576), generator=g).to(torch.bfloat16)
    kv_src = torch.randn((16384, 576), generator=g).to(torch.bfloat16)
    ops = {
        "alloc_extend": lambda t: mem_cache.alloc_extend(
            t(pre), t(seq), t(last), t(free), page_size=page,
            max_extend_tokens=b * LONG_CHUNK),
        "alloc_decode": lambda t: mem_cache.alloc_decode(t(seq), t(last), t(free),
                                                         page_size=page),
        "cache_loc_assign": lambda t: mem_cache.cache_loc_assign(t(req), t(pool).clone(),
                                                                 t(start), t(end), t(locs)),
        "cache_loc_update": lambda t: mem_cache.cache_loc_update(t(req), t(pool), t(start),
                                                                 t(end), total + 64),
        "assign_cache_op": lambda t: mem_cache.assign_cache_op(t(kv_dst).clone(), t(kv_src), 100,
                                                               9000, 2048, 16000),
    }
    for name, op in ops.items():
        got, want = op(lambda a: a.to(DEV)), op(lambda a: a)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name} on the card differs from its CPU result")
    log(f"  slot and cache-location ops on the card equal to the CPU's: {', '.join(ops)} "
        f"({b} requests, page {page}, {total} locations, a [16384, 576] bf16 ranged copy)")


def host_tier_phase(params, moe, mla_wq8, lps, card):
    """[4n] (see the module docstring)."""
    t0 = time.perf_counter()
    pd_disaggregation(params, moe, mla_wq8, lps, card)
    transfer_at_scale(torch.Generator(device=DEV).manual_seed(SEED + 12), card)
    slot_ops_on_card()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  [4n] took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 4o: Qwen3-Next-80B-A3B hybrid serving
# ---------------------------------------------------------------------------

def qwen_prompts():
    """[4o]'s prompts: ``QWEN_PROMPT_LENS`` random tokens, then the first
    prompt again."""
    ps = prompts(torch.Generator().manual_seed(SEED + 11), QWEN_PROMPT_LENS + [1], (0, 0),
                 CFG_QWEN.vocab_size)
    ps[-1] = list(ps[0])
    return ps


def check_qwen_kernels(gen):
    """K11a and K12d at head_dim 256 on bf16 caches, Qwen3-Next's 16 / 2
    heads, page 16: K11a over a decode step's contexts of [4o]'s serve (its
    four requests at 16 new tokens) and on ragged rows (context 1, a page and
    one more, 300, 2000, a pad row); K12d on a 512-row chunk at context 2048
    and on ragged requests (one token at context 1, 37 at 50 and 100 at 300:
    rows straddling pages) with 3 pad rows.  Returns the timed K11a and K12d
    results."""
    heads = (CFG_QWEN.num_heads, CFG_QWEN.num_kv_heads, CFG_QWEN.head_dim)
    kw = dict(heads=heads, with_sinks=False, table_pages=QWEN_PAGES_PER_REQ)
    dec_ctx = [n + QWEN_NEW_TOKENS for n in QWEN_PROMPT_LENS[:QWEN_BATCH]]
    k11 = check_paged_decode(gen, dec_ctx, 0, 0, True, **kw)
    check_paged_decode(gen, [1, 16, 17, 300, 2000], 0, 1, False, **kw)
    k12 = check_paged_prefill(gen, [QWEN_CHUNK], [4 * QWEN_CHUNK], 0, 0, True, **kw)
    check_paged_prefill(gen, [1, 37, 100], [1, 50, 300], 0, 3, False, **kw)
    return k11, k12


def qwen_serve(params, card, weights_q=None, ep=None):
    """[4o]'s serve: ``Engine(prefill_chunk=512, max_batch=4)`` +
    ``qwen3_hybrid_adapter`` over six prompts (the last repeats the first),
    16 new tokens each, so that state slots are reused.  Checks the caches'
    types, every request's tokens, every page and state slot back, no radix
    reuse (a request on a recurrent-state adapter neither matches nor
    inserts) and the repeated prompt's tokens equal to its first serve's, and
    exact launch counts from the engine's own calls (:func:`qwen_want`); with
    ``ep = (moe_weights_q, buffer)`` every layer's MoE on
    ``buffer.fused_deep_moe``, no row dropped.  Returns the engine, the
    prompts, the counts and (prefill, decode) tok/s."""
    cfg = CFG_QWEN
    moe_q, buf = ep or (None, None)
    drops = []
    if buf is not None:
        fused = buf.fused_deep_moe

        def recording(*args, **kw):
            out = fused(*args, **kw)
            drops.append(out[2])
            return out

        buf.fused_deep_moe = recording
    adapter = qwen3_hybrid_adapter(cfg, params, weights_q=weights_q, moe_weights_q=moe_q,
                                   ep_buffer=buf)
    timer = StepTimer(adapter)
    eng = Engine(adapter, QWEN_NUM_PAGES, max_batch=QWEN_BATCH,
                 max_pages_per_req=QWEN_PAGES_PER_REQ, prefill_chunk=QWEN_CHUNK)
    attn = next(c for li, c in enumerate(eng.caches) if cfg.is_attn(li))
    gdn = eng.caches[0]
    if (attn["k"].dtype != torch.bfloat16 or gdn["ssm"].dtype != torch.float32
            or tuple(gdn["ssm"].shape) != (QWEN_BATCH + 1, cfg.num_v_heads, cfg.head_k_dim,
                                           cfg.head_v_dim)):
        raise AssertionError(f"caches: K {attn['k'].dtype}, ssm {gdn['ssm'].dtype} "
                             f"{tuple(gdn['ssm'].shape)}")
    ps = qwen_prompts()
    counters.reset()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, QWEN_NEW_TOKENS) for p in ps]
    slot_of = {}
    while eng.waiting or eng.running:
        eng.step()
        slot_of.update({r.rid: r.state_slot for r in eng.running})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    outs = [eng.finished[r] for r in rids]
    if not all(len(o) == QWEN_NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in o)
               for o in outs):
        raise AssertionError(f"unfinished or invalid outputs: {[len(o) for o in outs]}")
    if eng.cm.free_pages != QWEN_NUM_PAGES or eng.cm.cached_pages:
        raise AssertionError(f"pages: {eng.cm.free_pages} free, {eng.cm.cached_pages} cached of "
                             f"{QWEN_NUM_PAGES}")
    if sorted(eng._free_state_slots) != list(range(QWEN_BATCH)) or \
            len(set(slot_of.values())) > QWEN_BATCH or len(slot_of) != len(ps):
        raise AssertionError(f"state slots: {slot_of}, free {eng._free_state_slots}")
    if eng.stats["cached_tokens"] or outs[-1] != outs[0]:
        raise AssertionError(f"the repeated prompt: {eng.stats['cached_tokens']} cached tokens "
                             f"(want 0), tokens {outs[-1]} vs its first serve's {outs[0]}")
    want = qwen_want(launches, timer.calls, w8=weights_q is not None, ep=buf is not None)
    moe_calls = cfg.num_layers * (timer.calls["prefill"] + timer.calls["decode"])
    if buf is not None:
        dropped = int(torch.stack(drops).sum())
        if len(drops) != moe_calls or dropped:
            raise AssertionError(f"EP serve: {len(drops)} fused_deep_moe calls for {moe_calls} "
                                 f"MoE calls; {dropped} rows dropped")
    if launches != want:
        raise AssertionError(f"launches {launches} over {timer.calls}; want {want}")
    what = ", W8A8" if weights_q is not None else ""
    if buf is not None:
        what += (f", the routed experts expert parallel (Buffer.fused_deep_moe, "
                 f"{buf.config.comm_backend}; {moe_calls} MoE calls, no row dropped)")
    log_serve(eng, rids, ps, wall, timer, f"bf16 cache and state pools{what}; {card}")
    log(f"  state slots by request {[slot_of[r] for r in rids]} (6 requests on "
        f"{QWEN_BATCH} slots); the repeated prompt: 0 cached tokens, its tokens equal its "
        f"first serve's {outs[0][:6]}...")
    log(f"  launches on the main path: "
        f"{json.dumps({k: v for k, v in launches.items() if v})} (every other kernel 0)")
    rates = (eng.stats["prefill_tokens"] / timer.t["prefill"],
             len(rids) * (QWEN_NEW_TOKENS - 1) / timer.t["decode"])
    return eng, ps, launches, rates


def zero_state(eng, si):
    """Set the state slots ``si`` of ``eng``'s pools to a zero state."""
    snap = qn.hybrid_state_snapshot(CFG_QWEN, eng.caches, si)
    qn.hybrid_state_restore(CFG_QWEN, eng.caches,
                            [tuple(torch.zeros_like(t) for t in pair) for pair in snap], si)


def qwen_sequence(eng, tokens):
    """Pages for ``tokens`` (from ``eng``'s pool) → (ids, block table [1,
    QWEN_PAGES_PER_REQ], slot of each position, the pages)."""
    page = CFG_QWEN.page_size
    pages = eng.cm.alloc(-(-len(tokens) // page))
    bt = torch.zeros((1, QWEN_PAGES_PER_REQ), dtype=torch.int32, device=DEV)
    bt[0, : len(pages)] = torch.tensor([int(p) for p in pages], dtype=torch.int32)
    pos = torch.arange(len(tokens), device=DEV)
    slots = (bt[0, pos // page] * page + pos % page).to(torch.int32)
    return torch.tensor(tokens, dtype=torch.int32, device=DEV), bt, slots, pages


def qwen_base_kernels():
    """The hybrid's plain path with K11a and K12d in place of their plain
    versions: only K1 and K5 stay plain."""
    return swapped(qn, {"decode_gqa_plain": qn.decode_gqa,
                        "attention_sinks_prefill_plain": qn.attention_sinks_prefill_pallas})


def qwen_step_checks(eng, params, ps, label, weights_q=None, ep=None):
    """A decode step on a live batch of [4o]'s first four prompts and a
    512-row prefill chunk at context 1024 (on the pools' spare state slot,
    its first chunk run once), through the kernels and through
    ``plain=True``, the routing replayed; each run starts from the same
    recurrent state (restored from a snapshot: a GDN step is not idempotent
    as a K / V write is).  Float, and with ``ep = (moe_weights_q, buffer)``
    (the routed experts on ``buffer.fused_deep_moe``): :func:`routing_rule`;
    W8A8 alone: :func:`w8a8_verdict` against the path with only K1 and K5
    plain.  The kernel run must launch what :func:`qwen_want` says of one
    model call, and nothing else.  Returns the kernel-path decode (logits)
    and chunk for the profile, each taking the steps' keywords to replace
    (``ep_buffer=...``)."""
    cfg = CFG_QWEN
    kw = dict(weights_q=weights_q)
    if ep is not None:
        kw.update(moe_weights_q=ep[0], ep_buffer=ep[1])
    batch, n = live_batch(eng, ps[:QWEN_BATCH])
    live = batch.state_idx[:n].long()
    snap = qn.hybrid_state_snapshot(cfg, eng.caches, live)

    def decode(plain, **over):
        qn.hybrid_state_restore(cfg, eng.caches, snap, live)
        h, _ = qn.hybrid_decode_step(cfg, params, qn.hybrid_embed(params, batch.ids), batch.pos,
                                     eng.caches, batch.block_table, batch.ctx, batch.slots,
                                     batch.state_idx, plain=plain, **{**kw, **over})
        return qn.hybrid_lm_head(params, h)

    ids, bt, slots, pages = qwen_sequence(eng, ps[2][: 2 * QWEN_CHUNK])
    si = torch.tensor([QWEN_BATCH], dtype=torch.int32, device=DEV)   # the spare slot
    sl = torch.tensor([QWEN_CHUNK], dtype=torch.int32, device=DEV)

    def chunk(c, plain, **over):
        rows = slice(c * QWEN_CHUNK, (c + 1) * QWEN_CHUNK)
        ctx = torch.tensor([(c + 1) * QWEN_CHUNK], dtype=torch.int32, device=DEV)
        if c:
            qn.hybrid_state_restore(cfg, eng.caches, snap_c, si)
        h, _ = qn.hybrid_prefill_step(cfg, params, qn.hybrid_embed(params, ids[rows]), sl,
                                      eng.caches, bt, ctx, slots[rows], si, max_q=QWEN_CHUNK,
                                      plain=plain, **{**kw, **over})
        return h

    zero_state(eng, si)
    chunk(0, False)                          # the chunk's context and state, written once
    snap_c = qn.hybrid_state_snapshot(cfg, eng.caches, si)
    w8 = weights_q is not None
    for label_, run, rows, logits in (
            (f"{label} decode step (logits)", decode, n, True),
            (f"{label} prefill chunk of {QWEN_CHUNK} rows at context {2 * QWEN_CHUNK} (hidden)",
             lambda plain: chunk(1, plain), QWEN_CHUNK, False)):
        counters.reset()
        if w8 and ep is None:
            got, rec_k = with_routes(lambda: run(False)[:rows].float(), model=qn)
            launches = counters.read()
            _, rec_p = with_routes(lambda: run(True)[:rows].float(), model=qn)
            want, _ = with_routes(lambda: run(True)[:rows].float(), rec_k, model=qn)
            with qwen_base_kernels():
                want_base, _ = with_routes(lambda: run(True)[:rows].float(), rec_k, model=qn)
            same = same_routing(rec_k, rec_p, rows)
            ok = w8a8_verdict(label_, got, want, want_base, rows, logits, "K1 and K5",
                              f"routing agrees in every layer on {int(same.sum())}/{rows} rows "
                              f"on its own, replayed for the comparisons; ")
        else:
            launches = {}
            ok = compare_runs(label_, lambda: run(False), lambda: run(True), rows, logits=logits,
                              forced=True, model=qn,
                              after_kernel=lambda: launches.update(counters.read()))
        one_call = {"prefill": int(not logits), "decode": int(logits)}
        want = qwen_want(launches, one_call, w8=w8, ep=ep is not None)
        if not ok or launches != want:
            raise AssertionError(f"{label_}: the kernels disagree with the plain path (rule held "
                                 f"{ok}) or launched {launches}, want {want}")
    eng.cm.free(pages)
    return ((lambda plain=False, **over: decode(plain, **over)),
            (lambda plain=False, **over: chunk(1, plain, **over)))


def qwen_state_resume(eng, params, ps, k=4, head_rows=16):
    """The state on the card (JAX's ``test_hybrid_chunked_prefill_resumes_state``
    property): [4o]'s 700-token prompt prefilled in 512-row chunks (the
    engine's padded width) and then k tokens decoded one at a time give, for
    the second chunk's first ``head_rows`` rows (which resume the first
    chunk's state) and for each decoded row (which resume the prefill's),
    the logits of one prefill over the whole sequence at that row, within
    :func:`routing_rule`'s tolerance: each router call of the chunked run
    takes the one prefill's routing for its rows.  Both runs
    start from a zero state on the pools' spare slot and end on the same
    sequence: every GDN layer's conv and ssm state of the two within 5e-2 of
    the state's largest |value| (bf16 activations upstream; a chunk that
    started from a stale state moves it by the order of the values)."""
    cfg = CFG_QWEN
    prompt = ps[3]
    n_p = len(prompt)
    tokens = prompt + ps[0][:k]
    total = len(tokens)
    ids, bt, slots, pages = qwen_sequence(eng, tokens)
    si = torch.tensor([QWEN_BATCH], dtype=torch.int32, device=DEV)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=DEV)  # noqa: E731

    head_rows = min(head_rows, n_p - QWEN_CHUNK)
    resumed = torch.cat([torch.arange(QWEN_CHUNK, QWEN_CHUNK + head_rows, device=DEV),
                         torch.arange(n_p, total, device=DEV)])

    def whole():
        h, _ = qn.hybrid_prefill_step(cfg, params, qn.hybrid_embed(params, ids), i32(total),
                                      eng.caches, bt, i32(total), slots, si, max_q=total)
        return qn.hybrid_lm_head(params, h[resumed]).float()

    def chunked():
        out = []
        for c0 in range(0, n_p, QWEN_CHUNK):
            n = min(QWEN_CHUNK, n_p - c0)
            x_ids = torch.zeros(QWEN_CHUNK, dtype=torch.int32, device=DEV)
            x_ids[:n] = ids[c0 : c0 + n]
            sl_ = torch.full((QWEN_CHUNK,), -1, dtype=torch.int32, device=DEV)
            sl_[:n] = slots[c0 : c0 + n]
            h, _ = qn.hybrid_prefill_step(cfg, params, qn.hybrid_embed(params, x_ids), i32(n),
                                          eng.caches, bt, i32(c0 + n), sl_, si,
                                          max_q=QWEN_CHUNK)
            if c0 == QWEN_CHUNK:
                out.append(qn.hybrid_lm_head(params, h[:head_rows]).float())
        for j in range(k):
            p = n_p + j
            h, _ = qn.hybrid_decode_step(cfg, params, qn.hybrid_embed(params, ids[p : p + 1]),
                                         i32(p), eng.caches, bt, i32(p + 1), slots[p : p + 1],
                                         si)
            out.append(qn.hybrid_lm_head(params, h).float())
        return torch.cat(out)

    zero_state(eng, si)
    want, rec = with_routes(whole, model=qn)
    state_whole = qn.hybrid_state_snapshot(cfg, eng.caches, si)
    forced = Record()
    for c0 in range(0, n_p, QWEN_CHUNK):
        rows = (torch.arange(c0, c0 + QWEN_CHUNK, device=DEV)).clamp(max=n_p - 1)
        forced.extend((ids_[rows], w_[rows]) for ids_, w_ in rec)
    for j in range(k):
        forced.extend((ids_[n_p + j : n_p + j + 1], w_[n_p + j : n_p + j + 1]) for ids_, w_ in rec)
    zero_state(eng, si)
    got, _ = with_routes(chunked, forced, model=qn)
    state_err = max(max_abs(a, b) / float(b.float().abs().max()) for pa, pb in
                    zip(qn.hybrid_state_snapshot(cfg, eng.caches, si), state_whole)
                    for a, b in zip(pa, pb))
    log(f"  state on the card: the GDN conv / ssm states after the chunked prefill and "
        f"{k} decode steps vs after one prefill: max rel err {state_err:.3e} (tol 5e-2)")
    ok = state_err <= 5e-2 and routing_rule(
        f"state on the card: the second {QWEN_CHUNK}-row chunk's first {head_rows} rows and {k} "
        f"decode rows after a {n_p}-token prompt", got, want,
        torch.ones(len(resumed), dtype=torch.bool, device=DEV), True, forced=True,
        vs=f"one prefill over the {total}-token sequence")
    eng.cm.free(pages)
    if not ok:
        raise AssertionError("the chunked prefill and decode disagree with one prefill")


QWEN_MLP = "MoE + shared expert (_hybrid_mlp: its PyTorch ops)"
QWEN_REGIONS = (("GDN chunk loop (chunk_gated_delta_rule)", "chunk_gated_delta_rule"),
                ("GDN recurrent update", "fused_sigmoid_gating_delta_rule_update"),
                ("conv (causal_conv1d_fn / _update)", "causal_conv1d_fn"),
                ("conv (causal_conv1d_fn / _update)", "causal_conv1d_update"),
                (QWEN_MLP, "_hybrid_mlp"))
# the port's kernels by name (every listed piece in the kernel's name): the
# profiler links a kernel launched through the port's library to no PyTorch
# op, so a range around its wrapper holds none
QWEN_KERNEL_NAMES = (("K11a decode_gqa", ("sinks", "decode_kernel")),
                     ("K12d attention_sinks_prefill_pallas", ("sinks", "prefill_kernel")),
                     ("K8a grouped_matmul (the EP MoE's GMM1 / GMM2)", ("k8::",)),
                     ("K15a / K15b window all-to-alls (the EP MoE's exchanges)", ("a2a_kernel",)),
                     ("K16b fused_deep_moe_full_rank", ("ffull::",)),
                     ("K5 quant_per_token (W8A8 projections, the EP wire)", ("quant::",)))
# the EP MoE's own kernels, added to the _hybrid_mlp range's device time
QWEN_EP_NAMES = QWEN_KERNEL_NAMES[2:5]


def region_profile(fn):
    """Run ``fn`` once under ``torch.profiler`` with each of ``QWEN_REGIONS``'
    functions of ``models.qwen3_next`` wrapped in a ``record_function`` range
    → ``({region: [device ms, kernels]}, busy ms, kernels, wall ms)``: a
    range's device time and kernel count are those of the kernels its
    PyTorch ops launched; K11a / K12d and the EP MoE's kernels are theirs by
    name; busy sums every device activity but the ranges' own device-side
    spans."""
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = {}
    for label, name in QWEN_REGIONS:
        f = getattr(qn, name)
        saved[name] = f

        def wrapped(*a, _f=f, _label=label, **k):
            with record_function(_label):
                return _f(*a, **k)
        setattr(qn, name, wrapped)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for name, f in saved.items():
            setattr(qn, name, f)

    def kernels(e):
        return len(e.kernels) + sum(kernels(c) for c in e.cpu_children)

    regions = {label: [0.0, 0] for label, _ in QWEN_REGIONS + QWEN_KERNEL_NAMES}
    busy, n_device = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation or e.name in regions:
                continue                          # a range's span on the device
            ms = e.device_time_total / 1e3
            busy += ms
            n_device += 1
            for label, keys in QWEN_KERNEL_NAMES:
                if all(key in e.name for key in keys):
                    regions[label][0] += ms
                    regions[label][1] += 1
        elif e.name in regions:
            regions[e.name][0] += e.device_time_total / 1e3
            regions[e.name][1] += kernels(e)
    return regions, busy, n_device, wall


def qwen_profiles(decode_fn, prefill_fn, label="Qwen3-Next"):
    """The device time of a decode step and of a 512-row prefill call by
    region (the GDN chunk loop, the recurrent update, the conv, the MoE's
    PyTorch ops, K11a / K12d, the EP MoE's kernels, K5), the busy share and
    the chunk loop's launches; the MoE's device time (its range and its EP
    kernels: K8a, K15a / K15b, K16b; the EP wire's K5 is in K5's row, with
    the W8A8 projections')."""
    for what, fn in (("decode step (logits)", decode_fn),
                     (f"{QWEN_CHUNK}-row prefill call at context {2 * QWEN_CHUNK}", prefill_fn)):
        regions, busy, n_device, wall = region_profile(fn)
        log(f"  {label} {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f} %) in {n_device} device activities")
        if busy == 0:
            log("    the profiler recorded no device time on this machine")
        for name, (ms, n) in regions.items():
            log(f"    {ms:9.3f} ms  {n:5d} kernels  {name}")
        moe = [regions[QWEN_MLP]] + [regions[k] for k, _ in QWEN_EP_NAMES]
        moe_ms, moe_n = sum(r[0] for r in moe), sum(r[1] for r in moe)
        log(f"    the MoE: {moe_ms:.3f} ms in {moe_n} kernels, "
            f"{100 * moe_ms / busy if busy else 0.0:.1f} % of the busy time")


def qwen_buffer(backend="pallas_ragged"):
    """A ``Buffer`` for Qwen3-Next's 512 experts on the one-rank NCCL group."""
    return Buffer(dist.group.WORLD, CFG_QWEN.moe_experts, EPConfig(comm_backend=backend))


def check_qwen_ep_kernels(gen, group, moe0):
    """The EP MoE's kernels at Qwen3-Next's widths (512 experts top-10, H
    2048, I 512) on layer 0's W8A8 experts, at a decode step's 4 tokens and a
    512-row chunk, each held to its plain version and timed beside its bound:
    K5 (the wire quant of the rows, bit-equal), K15b (the dispatch payload
    of the routed rows, bit-exact), K8a GMM1 (``dequant_swiglu_quant``, N
    1024, 512 groups, most empty at decode) and GMM2 (``dequant``, K 512),
    K16b at ``E_local`` 512 (at 4 tokens also bit-equal to its tiled walk);
    K15a on the per-expert counts ``[1, 512]``."""
    h, topk = CFG_QWEN.hidden, CFG_QWEN.moe_topk
    for n_tok in (QWEN_BATCH, QWEN_CHUNK):
        rows = n_tok * topk
        check_quant_per_token(gen, n_tok, h, True)
        check_window_a2a(gen, group, f"at Qwen3-Next's {n_tok}-token dispatch", rows, h,
                         [0, rows // 3, rows], True)
        check_grouped_matmul(gen, moe0, n_tok, topk, True)
        check_fused_full(gen, group, moe0, n_tok, True, walk=n_tok == QWEN_BATCH, topk=topk,
                         gmm_moe=False)
    counts = torch.randint(0, 64, (1, CFG_QWEN.moe_experts), generator=gen, device=DEV,
                           dtype=torch.int32)
    check_window_fixed(group, "Qwen3-Next's per-expert counts", counts, True)


def qwen_ep_phase(params, weights_q, card, dense_rates, draft):
    """[4o]'s expert-parallel MoE (see the module docstring): the layers'
    W8A8 experts, the float experts dropped (so no dense MoE can run), the
    kernels at 512 experts, the serve beside the dense-MoE W8A8 serve's
    tok/s, the steps against ``plain=True``, the transports, K16b, the
    profile; then chain speculation of this target with the 1-layer draft
    (its weights ``draft``)."""
    cfg, group = CFG_QWEN, dist.group.WORLD
    t0 = time.perf_counter()
    moe_q = qn.quantize_hybrid_moe_weights(cfg, params)
    for lw in params["layers"]:
        for name in ("moe_gate", "moe_up", "moe_down"):
            del lw[name]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"  W8A8 experts (quantize_hybrid_moe_weights) in {time.perf_counter() - t0:.1f} s; the "
        f"float experts dropped: {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    check_qwen_ep_kernels(torch.Generator(device=DEV).manual_seed(SEED + 14), group, moe_q[0])
    buf = qwen_buffer()
    eng, ps, _, rates = qwen_serve(params, card, weights_q, (moe_q, buf))
    log(f"  EP serve (W8A8 projections, the routed experts on Buffer.fused_deep_moe): prefill "
        f"{rates[0]:.1f}, decode {rates[1]:.1f} tok/s; the dense-MoE W8A8 serve of this call "
        f"{dense_rates[0]:.1f} / {dense_rates[1]:.1f} ({card})")
    decode_fn, prefill_fn = qwen_step_checks(eng, params, ps, "Qwen3-Next EP (W8A8)", weights_q,
                                             (moe_q, qwen_buffer()))
    n = QWEN_BATCH
    outs, first = {}, None
    for backend in ("pallas_ragged", "pallas", "xla"):
        b = qwen_buffer(backend)
        outs[backend], rec = with_routes(lambda: decode_fn(ep_buffer=b)[:n].float(), first,
                                         model=qn)
        first = first or rec
    diffs = {k: max_abs(v, outs["pallas_ragged"]) for k, v in outs.items()}
    log(f"  the EP decode step on the transports 'pallas_ragged', 'pallas', 'xla' (routing "
        f"replayed): max |logit diff| to 'pallas_ragged' {diffs}")
    if any(d != 0.0 for d in diffs.values()):
        raise AssertionError(f"the transports disagree on one rank: {diffs}")
    sbuf = qwen_buffer()
    single = sbuf.fused_deep_moe
    sbuf.fused_deep_moe = lambda *a, **kw: single(*a, **{**kw, "single_kernel": True})
    counters.reset()
    got_s, rec_s = with_routes(lambda: decode_fn(ep_buffer=sbuf)[:n].float(), model=qn)
    launches_s = counters.read()
    layers = cfg.num_layers
    want_s = {"fused_deep_moe_full_rank": layers, "pallas_all_to_all": layers,
              "pallas_ragged_all_to_all": 0, "grouped_matmul": 0}
    if any(launches_s[k] != v for k, v in want_s.items()):
        raise AssertionError(f"single-kernel EP decode step: launches {launches_s}, "
                             f"want {want_s}")
    plain_s, _ = with_routes(lambda: decode_fn(ep_buffer=sbuf, plain=True)[:n].float(), rec_s,
                             model=qn)
    if not routing_rule("Qwen3-Next EP decode step, single_kernel=True (logits)", got_s,
                        plain_s, torch.ones(n, dtype=torch.bool, device=DEV), True, forced=True):
        raise AssertionError("the single-kernel EP decode step disagrees with its plain path")
    log("  device time by region, the EP MoE (torch.profiler)")
    qwen_profiles(decode_fn, prefill_fn, "Qwen3-Next EP (W8A8)")
    del eng, decode_fn, prefill_fn
    log(f"  speculative decoding of the W8A8 + EP target: spec_k={SPEC_K}, the same draft")
    # against the decode path (the recurrent update) its rolled-back states
    # and verify rows are readings (PERF.md §6): the chunk rule's bf16
    # roundings move int8 levels of the next layer's input, so the two
    # recurrences part; its verifies and catch-ups are held to the plain path
    qwen_spec_phase(params, draft, card, "the W8A8 + EP target", decode_held=False,
                    weights_q=weights_q, moe_weights_q=moe_q, ep_buffer=qwen_buffer())


# [4o]'s speculative serves: a 1-layer Llama-shaped draft at Qwen3-Next's
# vocabulary and hidden width (16 / 2 heads of 128, intermediate 5120), random
# bf16 weights from a seed, an untied head; [4o]'s first four prompts, one
# state slot each
QWEN_DRAFT = lm.LlamaConfig(
    vocab_size=CFG_QWEN.vocab_size, hidden=CFG_QWEN.hidden, num_layers=1, num_heads=16,
    num_kv_heads=2, head_dim=128, intermediate=5120, page_size=CFG_QWEN.page_size,
    rope_theta=1e7, rms_eps=1e-6)
QWEN_STATE_TOL = 5e-2          # [4o]'s state-resume tolerance
# a rolled-back state against the same restore + catch-up on the plain path:
# one algorithm, the kernels' bf16 roundings and int8 levels apart (the EP
# steps sit within 1.1e-2 of a row's largest logit of plain=True)
QWEN_ROLLBACK_TOL = 2e-2


def qwen_want(launches, calls, dcalls=None, *, w8=False, ep=False):
    """[4o]'s launches from the hybrid adapter's ``calls`` and the 1-layer
    Llama draft's ``dcalls`` (or None), for every counted kernel, so that
    nothing else may launch: K12d once an attention layer a prefill call
    (prompt chunks, verifies and catch-ups alike), K11a once a decode call;
    with ``w8`` K1 four times an attention layer and twice a GDN layer a
    model call, K5 twice a layer; with ``ep`` every layer's MoE on the window
    transport (``EP_DEEP_CALL``: K15b three times, K15a and K5 once, K8a
    twice: GMM1 ``dequant_swiglu_quant``, GMM2 ``dequant`` or
    ``dequant_f32``); the draft K12d a prefill call, K11a a decode call, K6a
    three times a call."""
    n_attn = sum(CFG_QWEN.is_attn(li) for li in range(CFG_QWEN.num_layers))
    n_gdn = CFG_QWEN.num_layers - n_attn
    model_calls = calls["prefill"] + calls["decode"]
    want = dict.fromkeys(launches, 0)
    want["attention_sinks_prefill_pallas"] = n_attn * calls["prefill"]
    want["decode_gqa"] = n_attn * calls["decode"]
    if w8:
        want["quant_matmul"] = (4 * n_attn + 2 * n_gdn) * model_calls
        want["quant_per_token"] = 2 * (n_attn + n_gdn) * model_calls
    if ep:
        moe_calls = CFG_QWEN.num_layers * model_calls
        for k, v in EP_DEEP_CALL.items():
            want[k] += v * moe_calls
        f32 = launches["grouped_matmul:dequant_f32"]
        want.update({"grouped_matmul:dequant_swiglu_quant": moe_calls,
                     "grouped_matmul:dequant_f32": f32,
                     "grouped_matmul:dequant": moe_calls - f32})
    if dcalls is not None:
        want["attention_sinks_prefill_pallas"] += dcalls["prefill"]
        want["decode_gqa"] += dcalls["decode"]
        want["rms_norm"] += 3 * (dcalls["prefill"] + dcalls["decode"])
    return want


def qwen_engine(params, *, draft=None, mixed=True, **kw):
    """[4o]'s target ``qwen3_hybrid_adapter(cfg, params, **kw)`` in
    ``Engine(prefill_chunk=512, max_batch=4)``; with ``draft`` (the draft's
    weights) chain speculation (``spec_k=2``) with a 1-layer Llama adapter
    → ``(engine, target timer, draft timer or None, decode timer)`` as
    :func:`feature_engine`."""
    adapter = qwen3_hybrid_adapter(CFG_QWEN, params, **kw)
    timer, dtimer, dadapter = StepTimer(adapter), None, None
    if draft is not None:
        dadapter = llama_adapter(QWEN_DRAFT, draft)
        dtimer = StepTimer(dadapter)
    eng = Engine(adapter, QWEN_NUM_PAGES, max_batch=QWEN_BATCH,
                 max_pages_per_req=QWEN_PAGES_PER_REQ, prefill_chunk=QWEN_CHUNK, mixed=mixed,
                 spec_k=SPEC_K if draft is not None else 0, draft_adapter=dadapter)
    return eng, timer, dtimer, MethodTimer(eng, ("_decode", "_spec_decode_tree"))


def state_errs(got, want):
    """Each GDN layer's largest |difference| between two snapshots' conv and
    ssm states, over that state's largest |value| in ``want``."""
    return [max(max_abs(a, b) / float(b.float().abs().max()) for a, b in zip(pg, pw))
            for pg, pw in zip(got, want)]


def qwen_verifies(eng, params, verifies, kw):
    """Every verify of a speculative serve against the same verify on the
    plain path: ``verifies`` holds, in the serve's order, each one's state
    ``s0`` (its snapshot), rows ``ids`` at positions ``ctx - len(ids) ..``
    (block table ``bt``, cache slots ``slots``), routing ``rec`` and the
    head's f32 ``logits``.  Each is run again from ``s0`` on the pools'
    spare slot with ``plain=True`` and the routing replayed, writing its own
    K / V rows as the serve's did (in the serve's order, so that every
    earlier position holds its accepted token), and the two held to
    :func:`routing_rule` on every row.  Run on the speculative engine once
    it has served."""
    cfg = CFG_QWEN
    spare = torch.tensor([QWEN_BATCH], dtype=torch.int32, device=DEV)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=DEV)  # noqa: E731
    got, want = [], []
    for v in verifies:
        qn.hybrid_state_restore(cfg, eng.caches, v["s0"], spare)
        n = v["ids"].shape[0]
        (h, _), _ = with_routes(lambda: qn.hybrid_prefill_step(
            cfg, params, qn.hybrid_embed(params, v["ids"]), i32(n), eng.caches, v["bt"],
            i32(v["ctx"]), v["slots"], spare, max_q=n, plain=True, **kw), v["rec"], model=qn)
        want.append(qn.hybrid_lm_head(params, h).float())
        got.append(v["logits"])
    if not verifies or not routing_rule(
            f"{len(verifies)} verifies (a request each)", torch.cat(got), torch.cat(want),
            torch.ones(sum(g.shape[0] for g in got), dtype=torch.bool, device=DEV),
            logits=True, forced=True, vs="the same verify on the plain path from the same state"):
        raise AssertionError("the verifies disagree with their plain path")


def qwen_rollbacks(eng, params, rounds, kw, decode_tol):
    """The recurrent state after each rolled-back request-round: ``rounds``
    holds, for each, the state ``s0`` its verify snapshotted, the state
    ``s1`` after the restore and the catch-up prefill through the kernels,
    that prefill's rows ``ids`` (``m`` of them real, the rest padding, at
    positions ``ctx - m ..``) and routing ``rec``, the request's pages.
    Each round starts from ``s0`` on the pools' spare slot twice:

    - the same catch-up on the plain path (``plain=True``: every kernel's
      plain version, the EP MoE's transports and GEMMs too), the routing
      replayed: one algorithm, so every GDN layer's conv and ssm state
      within ``QWEN_ROLLBACK_TOL`` of ``s1``'s largest |value|;
    - the accepted tokens decoded one at a time (the recurrent update,
      K11a), each taking the catch-up's routing for its row: within
      ``decode_tol`` ([4o]'s state-resume tolerance) where it is given,
      else the reading is only printed.

    No K / V is written (slots -1): the attention layer, the last, reads the
    rows the serve wrote.  Run on the speculative engine once it has served.
    """
    cfg = CFG_QWEN
    spare = torch.tensor([QWEN_BATCH], dtype=torch.int32, device=DEV)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=DEV)  # noqa: E731
    plain_errs, dec_errs = [], []
    moved = min((max(state_errs(rd["s1"], rd["s0"])) for rd in rounds), default=0.0)
    log(f"  every catch-up moves some GDN layer's state by at least {moved:.3e} of its largest "
        f"|value|")
    for rd in rounds:
        bt = torch.zeros((1, QWEN_PAGES_PER_REQ), dtype=torch.int32, device=DEV)
        bt[0, : len(rd["pages"])] = torch.tensor(rd["pages"], dtype=torch.int32)
        ids, m = rd["ids"], rd["m"]
        qn.hybrid_state_restore(cfg, eng.caches, rd["s0"], spare)
        with_routes(lambda: qn.hybrid_prefill_step(
            cfg, params, qn.hybrid_embed(params, ids), i32(m), eng.caches, bt, i32(rd["ctx"]),
            torch.full_like(ids, -1), spare, max_q=ids.shape[0], plain=True, **kw),
            rd["rec"], model=qn)
        plain_errs.append(state_errs(qn.hybrid_state_snapshot(cfg, eng.caches, spare), rd["s1"]))
        qn.hybrid_state_restore(cfg, eng.caches, rd["s0"], spare)
        for t in range(m):
            p = rd["ctx"] - m + t
            forced = Record()
            forced.extend((ri[t : t + 1], rw[t : t + 1]) for ri, rw in rd["rec"])
            with_routes(lambda: qn.hybrid_decode_step(
                cfg, params, qn.hybrid_embed(params, ids[t : t + 1]), i32(p), eng.caches, bt,
                i32(p + 1), i32(-1), spare, **kw), forced, model=qn)
        dec_errs.append(state_errs(rd["s1"], qn.hybrid_state_snapshot(cfg, eng.caches, spare)))
    for what, errs, tol in (("the same catch-up on the plain path", plain_errs,
                             QWEN_ROLLBACK_TOL),
                            ("plain decoding of the same tokens", dec_errs, decode_tol)):
        worst = [max(col) for col in zip(*errs)]
        flat = [max(e) for e in errs]
        held = f"tol {tol}" if tol is not None else "a reading, not held"
        log(f"  the state after {len(errs)} rolled-back request-rounds (restore + catch-up of "
            f"{sum(rd['m'] for rd in rounds)} accepted rows) vs {what} from the same restored "
            f"state, the routing replayed: max rel err {max(flat, default=0.0):.3e}, median "
            f"{statistics.median(flat) if flat else 0.0:.3e}; by GDN layer "
            f"{[f'{e:.3e}' for e in worst]} ({held}; every conv and ssm state)")
        if not errs or (tol is not None and max(flat) > tol):
            raise AssertionError(f"the rolled-back state disagrees with {what}: {flat}")


def qwen_spec_phase(params, draft, card, label, decode_held=True, **kw):
    """[4o]'s speculative serve of the target ``qwen3_hybrid_adapter(cfg,
    params, **kw)`` (see the module docstring): its greedy serve (the
    reference), then chain speculation with the 1-layer draft (its weights
    ``draft``), each serve's launches held exactly (:func:`qwen_want`);
    every verify held to the plain path's (:func:`qwen_verifies`); every
    rolled-back round's state to the plain path's catch-up and to plain
    decoding (:func:`qwen_rollbacks`); every emitted token's verify row to
    the decode path by :func:`spec_rule` through :func:`teacher_forced`.
    With ``decode_held`` False the last two comparisons with the decode
    path are readings, not held."""
    cfg = CFG_QWEN
    ps = qwen_prompts()[:QWEN_BATCH]
    reqs = [dict(prompt=p, max_new_tokens=QWEN_NEW_TOKENS) for p in ps]
    flags = dict(w8=kw.get("weights_q") is not None, ep=kw.get("ep_buffer") is not None)

    def want(launches, calls, dcalls):
        return qwen_want(launches, calls, dcalls, **flags)

    eng = qwen_engine(params, **kw)
    ref, _, rate = feature_run(f"{label}, greedy reference", eng[0], reqs, eng[1:], want)
    del eng
    eng, *timers = qwen_engine(params, draft=draft, **kw)
    recorder = VerifyRecorder(eng, model=qn)
    s0, catch, rounds, verifies = {}, {}, [], []
    snapshot = eng.a.snapshot_state
    verify_one, tree_round = eng._verify_one, eng._spec_tree_round

    def snapshotting(c, si):                     # the verify's snapshot, by slot
        snap = snapshot(c, si)
        s0[int(si[0])] = snap
        return snap

    def catching(ids, seq_len, bt, ctx, slots, r):
        if seq_len == eng.spec_k + 1:            # a verify, recorded by the recorder
            out = verify_one(ids, seq_len, bt, ctx, slots, r)
            logits, rec, _ = recorder.parts[-1]
            verifies.append(dict(ids=ids, ctx=ctx, slots=slots, s0=s0[r.state_slot], rec=rec,
                                 logits=logits, bt=torch.from_numpy(bt[None]).to(DEV)))
            return out
        out, rec = with_routes(lambda: verify_one(ids, seq_len, bt, ctx, slots, r), model=qn)
        catch[r.state_slot] = dict(ids=ids, m=seq_len, ctx=ctx, rec=rec)
        return out

    def keeping(live):
        catch.clear()
        out = tree_round(live)
        for r in live:
            if r.state_slot in catch:
                si = torch.tensor([r.state_slot], dtype=torch.int32, device=DEV)
                rounds.append(dict(catch[r.state_slot], s0=s0[r.state_slot],
                                   s1=qn.hybrid_state_snapshot(cfg, eng.caches, si),
                                   pages=list(r.pages)))
        return out

    eng.a.snapshot_state = snapshotting
    eng._verify_one, eng._spec_tree_round = catching, keeping
    outs, _, spec_rate = feature_run(f"{label}, chain speculation (spec_k={SPEC_K})", eng, reqs,
                                     timers, want)
    st = eng.stats
    log(f"    {st['spec_rounds']} rounds, {st['spec_accepted']} drafts accepted "
        f"({st['spec_accepted'] / st['spec_rounds']:.2f} a round over the live requests); "
        f"{len(rounds)} request-rounds rolled back (restore + catch-up)")
    qwen_verifies(eng, params, verifies, kw)
    qwen_rollbacks(eng, params, rounds, kw, QWEN_STATE_TOL if decode_held else None)
    del eng, verifies, rounds
    spec_rule(f"{label}, chain speculation", outs, ref, recorder,
              lambda toks, rows: teacher_forced(lambda: qwen_engine(params, mixed=False, **kw)[0],
                                                ps, toks, rows, QWEN_NEW_TOKENS, model=qn),
              margin=lambda c, mine, other: flip_margin(c, mine, other, 1, 1), held=decode_held)
    log(f"  {label}: decode tok/s ({card}): plain {rate:.1f}, chain speculation "
        f"{spec_rate:.1f}")


def qwen_phase(card: str):
    """Phase [4o] (see the module docstring).  Returns the K11a / K12d rows'
    results and their launches on [4o]'s float serve."""
    log(f"[4o] Qwen3-Next-80B-A3B widths, {CFG_QWEN.num_layers} of {QWEN_FULL_LAYERS} layers "
        f"(3 GDN + 1 attention), seed {SEED}: Engine(prefill_chunk={QWEN_CHUNK}, "
        f"max_batch={QWEN_BATCH}) + qwen3_hybrid_adapter; {card}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = qn.init_hybrid_weights(CFG_QWEN, SEED, torch.bfloat16, untied_lm_head=True)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for lw in params["layers"] for t in lw.values()
                   if isinstance(t, torch.Tensor)) + params["wte"].numel() + params["w_lm"].numel()
    log(f"  weights made in {time.perf_counter() - t0:.1f} s: {n_params / 1e9:.2f} B parameters; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    k11, k12 = check_qwen_kernels(torch.Generator(device=DEV).manual_seed(SEED + 12))
    eng, ps, launches, _ = qwen_serve(params, card)
    decode_fn, prefill_fn = qwen_step_checks(eng, params, ps, "Qwen3-Next")
    qwen_state_resume(eng, params, ps)
    log("  W8A8 (weights_q: attention q / k / v / o, GDN qkvz / out; the MoE stays float)")
    weights_q = qn.quantize_hybrid_weights(CFG_QWEN, params)
    eng_q, _, _, dense_rates = qwen_serve(params, card, weights_q)
    qwen_step_checks(eng_q, params, ps, "Qwen3-Next W8A8 (weights_q)", weights_q)
    del eng_q
    log("  device time by region (torch.profiler)")
    qwen_profiles(decode_fn, prefill_fn)
    del eng, decode_fn, prefill_fn
    t0 = time.perf_counter()
    draft = lm.init_weights(QWEN_DRAFT, SEED + 13, torch.bfloat16, untied_lm_head=True)
    log(f"  speculative decoding: spec_k={SPEC_K}, a 1-layer Llama draft at Qwen3-Next's "
        f"vocabulary, hidden {QWEN_DRAFT.hidden}, made in {time.perf_counter() - t0:.1f} s")
    qwen_spec_phase(params, draft, card, "the float target")
    log(f"  expert parallel: qwen3_hybrid_adapter(weights_q=..., moe_weights_q="
        f"quantize_hybrid_moe_weights(...), ep_buffer=Buffer(<one-rank NCCL group>, "
        f"{CFG_QWEN.moe_experts}, EPConfig(comm_backend='pallas_ragged')))")
    qwen_ep_phase(params, weights_q, card, dense_rates, draft)
    log(f"  peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB allocated on the card in "
        f"[4o]")
    return (k11, k12), {k: launches[k] for k in QWEN_KERNELS}


def serving_phases(card: str):
    """Phases [2] to [5]: the serving paths, their kernels and their
    profiles.  Returns the kernel rows (name, source, replaced TPU kernel,
    result) and each kernel's launches on the path that first runs it; every
    weight, engine and cache of these phases is dropped when it returns."""
    log(f"[2] weights: DeepSeek-V3 widths, {CFG.num_layers} of {FULL_LAYERS} layers, "
        f"seed {SEED}")
    t0 = time.perf_counter()
    # CFG_DSA's weights: CFG's, plus the indexer projections drawn last
    params = m.init_weights(CFG_DSA, SEED, torch.bfloat16, with_experts=False)
    moe = m.init_quantized_experts(CFG, SEED + 1)
    ps = prompts(torch.Generator().manual_seed(SEED))
    sample = m.embed(params, torch.tensor(sum(ps, []), dtype=torch.int32, device=DEV))
    mla_wq = m.make_mla_preprocess_weights(CFG, params, sample)
    dense_wq = m.quantize_dense_weights(CFG, params)
    del sample
    torch.cuda.synchronize()
    log(f"  made in {time.perf_counter() - t0:.1f} s (fused-prologue scales calibrated on "
        f"the {sum(PROMPT_LENS)} prompt tokens' embeddings); "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")

    log("[3] kernels against their plain versions")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    ctx_decode = [716, 612, 556, 470, 320, 166, 112, 400]     # 8 sequences, page 128
    dec = check_decode_mla(gen, MAX_BATCH, CFG.num_heads, CFG.page_size, ctx_decode, 0, True)
    check_decode_mla(gen, 3, CFG.num_heads, 16, [1, 17, 40], 2, False)
    pre = check_mla_prefill(gen, CFG.num_heads, CFG.page_size, [PREFILL_CHUNK], [700], 0, True)
    check_mla_prefill(gen, CFG.num_heads, 16, [1, 5], [1, 30], 2, False)
    g1, g2 = check_gmm(gen, moe[0], MAX_BATCH, CFG.topk, True, "gmm decode shape")
    check_gmm(gen, moe[0], PREFILL_CHUNK, CFG.topk, False, "gmm prefill-chunk shape")
    check_gmm_small(gen)
    k1, k5, k7a = check_w8a8_kernels(gen, mla_wq, dense_wq)
    # the long-prompt slice: the int8 latent in K2 / K9a (times beside the
    # bf16 ones above, then at the shapes [4c] gives them: the five long
    # prompts' decode contexts on a 33-page table, a 2048-row chunk at
    # context 4096), and K8a at a 2048-token chunk and a 4096-token batch
    check_decode_mla(gen, MAX_BATCH, CFG.num_heads, CFG.page_size, ctx_decode, 0, True, True)
    check_decode_mla(gen, 3, CFG.num_heads, 16, [1, 17, 40], 2, False, True)
    check_mla_prefill(gen, CFG.num_heads, CFG.page_size, [PREFILL_CHUNK], [700], 0, True, True)
    check_mla_prefill(gen, CFG.num_heads, 16, [1, 5], [1, 30], 2, False, True)
    long_ctx = [n + NEW_TOKENS for n in LONG_PROMPT_LENS]     # a decode step's longest contexts
    check_decode_mla(gen, len(long_ctx), CFG.num_heads, CFG.page_size, long_ctx,
                     MAX_BATCH - len(long_ctx), True, True, LONG_PAGES_PER_REQ)
    # K2 across many splits (up to 13 live of 14 a row, merged by the last):
    # [4c]'s contexts, a row of context 1 and a pad row; the int8 fold
    for int8 in (False, True):
        check_decode_mla(gen, len(long_ctx) + 1, CFG.num_heads, CFG.page_size, long_ctx + [1], 1,
                         False, int8, LONG_PAGES_PER_REQ)
    check_decode_mla_fold(gen, long_ctx + [1, 300], LONG_PAGES_PER_REQ)
    check_decode_mla_fold(gen, ctx_decode, -(-max(ctx_decode) // CFG.page_size))
    check_mla_prefill(gen, CFG.num_heads, CFG.page_size, [LONG_CHUNK], [2 * LONG_CHUNK], 0,
                      True, True, LONG_PAGES_PER_REQ)
    k8 = check_grouped_matmul(gen, moe[0], LONG_CHUNK, CFG.topk, True)
    check_grouped_matmul(gen, moe[0], 2 * LONG_CHUNK, CFG.topk, True)
    check_grouped_matmul_small(gen)
    # DSA: K10 and K9b at [4d]'s shapes and on ragged cases
    k10, k9b, k9b8 = check_dsa_kernels(gen)

    log("[4] serve through Engine + deepseek_adapter(moe_weights_q=...): float prologue")
    eng, ps, launches = serve(params, moe)
    compare_plain_decode(eng, ps, params, moe)
    del eng
    log("[4] serve through Engine + deepseek_adapter(moe_weights_q=..., mla_wq=...)")
    eng, ps, launches_q = serve(params, moe, mla_wq)
    batch, n = compare_plain_decode(eng, ps, params, moe, mla_wq)
    log("[4b] the fully W8A8 layer: decode_step / prefill_step(mla_wq=..., dense_wq=..., "
        "moe_weights_q=...)")
    launches_w = fully_w8a8(eng, batch, n, params, moe, mla_wq, dense_wq, ps)
    log(f"[4c] long prompts on the int8 latent cache: Engine(prefill_chunk={LONG_CHUNK}) + "
        "deepseek_adapter(kv_cache_dtype='int8', moe_weights_q=..., mla_wq=...)")
    lps = prompts(torch.Generator().manual_seed(SEED + 3), LONG_PROMPT_LENS, (0, LONG_SHARED))
    t0 = time.perf_counter()
    sample = m.embed(params, torch.tensor(sum(lps, [])[:LONG_CHUNK], dtype=torch.int32,
                                          device=DEV))
    mla_wq8 = m.make_mla_preprocess_weights(CFG_INT8, params, sample)
    del sample
    log(f"  int8-cache prologue weights calibrated on {LONG_CHUNK} prompt tokens' embeddings "
        f"in {time.perf_counter() - t0:.1f} s (per-head q_nope scales of layer 0: "
        f"{float(mla_wq8[0].qnope_scale.min()):.2f}-{float(mla_wq8[0].qnope_scale.max()):.2f})")
    eng8, _, launches_l = serve(params, moe, mla_wq8, cfg=CFG_INT8, ps=lps,
                                share=(0, LONG_SHARED), chunk=LONG_CHUNK,
                                num_pages=LONG_NUM_PAGES, pages_per_req=LONG_PAGES_PER_REQ)
    long_prefill, _, _, _ = long_prompt_checks(eng8, params, moe, mla_wq8, lps)
    del eng8
    log(f"[4d] DeepSeek-V3.2 sparse attention (DSA, page mode, {CFG_DSA.idx_heads} index heads "
        f"x {CFG_DSA.idx_dim}, {CFG_DSA.sparse_count} keys = {DSA_PAGES} pages) on [4c]'s "
        f"setup: Engine(prefill_chunk={LONG_CHUNK}) + deepseek_adapter(CFG_DSA, ...)")
    eng_d, launches_d = dsa_serve(params, moe, mla_wq8, lps)
    dsa_prefill, dsa_decode, batch_d, n_d = long_prompt_checks(eng_d, params, moe, mla_wq8, lps,
                                                              cfg=CFG_DSA)
    dsa_token_decode(eng_d, batch_d, n_d, params, moe, mla_wq8)
    log(f"[4e] GPT-OSS-20B widths, {CFG_GPT.num_layers} of {GPT_FULL_LAYERS} layers, seed {SEED}: "
        f"Engine(prefill_chunk={GPT_CHUNK}) + gpt_oss_adapter")
    t0 = time.perf_counter()
    gparams = g.init_weights(CFG_GPT, SEED, torch.bfloat16, bias_scale=0.02, untied_lm_head=True)
    gparams["rms_eps"] = CFG_GPT.rms_eps             # a checkpoint carries it; the head reads it
    torch.cuda.synchronize()
    log(f"  weights made in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    k6, k7b, k12a, k12b, k12d = check_gpt_oss_kernels(
        torch.Generator(device=DEV).manual_seed(SEED + 5))
    eng_g, gps, launches_g = gpt_oss_serve(gparams)
    gpt_decode, gpt_prefill = gpt_oss_step_checks(eng_g, gparams, gps)
    launches_gp = gpt_oss_modes(gparams, eng_g, gps)
    log(f"[4i] GPT-OSS-20B expert parallel: [4e]'s setup, gpt_oss_adapter(ep_buffer=Buffer(<one-rank "
        f"NCCL group>, num_experts={CFG_GPT.num_experts}, config=EPConfig()))")
    k8f, launches_i, gpt_ep_decode, gpt_ep_prefill = gpt_oss_ep_phase(gparams)
    log(f"[4k] DeepSeek-V3 W8A8 expert parallel on the one-sided window transport: [4]'s "
        f"setup (fused prologue), deepseek_adapter(ep_buffer=Buffer(<one-rank NCCL group>, "
        f"{CFG.num_experts}, EPConfig(comm_backend='pallas_ragged'))); K15a-c, K16b")
    (k15a, k15b, k15c, k16b), launches_k = deepseek_ep_phase(params, moe, mla_wq, eng)
    log("[4l] the last TPU kernels' paths at DeepSeek-V3's widths on [4]'s layer-0 experts and "
        "[4k]'s one-rank group: K8a's remaining modes, _gmm_moe's dispatch_p + K8b branch, "
        f"the gate / up packing at {PACK_TN}, K16a, K3 on bf16 tokens")
    k4l, launches_l4 = dispatch_routes_phase(moe)
    log(f"[4p] the rest of DeepEP's Buffer at DeepSeek-V3's decode width ({LL_TOKENS} tokens, "
        f"top-{CFG.topk} of {CFG.num_experts}, {LL_DROP:.0%} of the slots -1) on [4]'s layer-0 "
        "experts and [4k]'s one-rank group: the low-latency round trip on the three "
        "transports, the decode MoE on it against K16b, multi-round dispatch, the TP "
        "all-gather and the layered hop")
    launches_p = low_latency_phase(moe, card)
    log(f"  [4p] launches on the paths: {json.dumps(launches_p)}")
    log("[4m] the engine's sampling, stop tokens, prefill-first scheduling and speculative "
        "decoding (chain, tree) on [4]'s setup: fused prologue, W8A8 experts, a 1-layer draft")
    engine_features_phase(params, moe, mla_wq, ps, card)
    log("[4n] the host KV tier and prefill / decode disaggregation on [4c]'s setup: two "
        "Engines over one HostKVPool, MemorySaver, transfer_kv_dim_exchange at 61 layers, the "
        "slot ops")
    host_tier_phase(params, moe, mla_wq8, lps, card)
    log(f"[4f] Llama-3.1-8B widths, {CFG_LLAMA.num_layers} of {LLAMA_FULL_LAYERS} layers, seed "
        f"{SEED}: Engine(prefill_chunk={GPT_CHUNK}) + llama_adapter")
    t0 = time.perf_counter()
    lparams = lm.init_weights(CFG_LLAMA, SEED, torch.bfloat16, untied_lm_head=True)
    torch.cuda.synchronize()
    log(f"  weights made in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    k11 = check_llama_kernels(torch.Generator(device=DEV).manual_seed(SEED + 7))
    decode_kernels_only(torch.Generator(device=DEV).manual_seed(SEED + 10))
    eng_l, lps_, launches_ll = llama_serve(lparams, CFG_LLAMA, card)
    llama_decode, llama_prefill = llama_step_checks(eng_l, lparams, lps_, CFG_LLAMA, "Llama")
    lscales = w8a8.calibrate_kv_scales(eng_l.caches)
    cfg_l8 = dataclasses.replace(CFG_LLAMA, kv_cache_dtype="int8", kv_scale=kv_scale_of(lscales))
    log(f"  W8A8 on the int8 cache: kv_scale {cfg_l8.kv_scale:.5f} from calibrate_kv_scales over "
        f"the bf16 serve's caches")
    lwq = lm.quantize_weights(CFG_LLAMA, lparams)
    eng_l8, _, _ = llama_serve(lparams, cfg_l8, card, lwq)
    llama_step_checks(eng_l8, lparams, lps_, cfg_l8, "Llama W8A8, int8 cache", weights_q=lwq)
    del eng_l8
    log(f"[4g] multi-LoRA on Llama-3.1-8B widths: {LORA_ADAPTERS} adapters of rank {LORA_RANK} "
        f"on q and o (adapter 0 zero), Engine(prefill_chunk={GPT_CHUNK}) + "
        f"llama_adapter(lora=...); the add-RMSNorm ops")
    gen_l = torch.Generator(device=DEV).manual_seed(SEED + 9)
    k6b, k6c, k6d, k13a, k13b = check_lora_norm_kernels(gen_l)
    launches_ops = op_paths(gen_l)
    lora_w = lm.init_lora(SEED + 8, CFG_LLAMA, LORA_ADAPTERS, LORA_RANK, torch.bfloat16)
    eng_lo, _, launches_lo = llama_lora_serve(lparams, lora_w, card)
    lora_ids = [1, 2, 3, 0, 2]                       # the live batch's rows, prompt by prompt
    lora_decode, _ = llama_step_checks(eng_lo, lparams, lps_, CFG_LLAMA, "Llama LoRA",
                                       lora_ids=lora_ids, lora=lora_w)
    llama_step_checks(eng_lo, lparams, lps_, CFG_LLAMA, "Llama LoRA W8A8 (weights_q)",
                      lora_ids=lora_ids, lora=lora_w, weights_q=lwq)
    log("[5] device time by kernel (torch.profiler)")
    profile_steps(eng, batch, ps[3][:200],
                  decode_step_fn(params, moe, mla_wq=mla_wq, dense_wq=dense_wq), long_prefill,
                  dsa_prefill, dsa_decode, gpt_decode, gpt_prefill, gpt_ep_decode, gpt_ep_prefill,
                  llama_decode, llama_prefill, lora_decode)

    tpu = "sgl_kernel_npu_tpu/ops/"
    # (name, source, the TPU kernels it replaces, its result: a dict of err, ms,
    # plain_ms, library_ms, bound_ms, bound_by)
    rows = [
        ("decode_mla", "decode_mla.cu", "attention/decode_attention.py:346", dec),
        ("mla_prefill_pallas", "mla_prefill.cu", "attention/mla_prefill.py:201", pre),
        ("gmm1_ring", "gmm_ring.cu", "gmm_ring.py:282", g1),
        ("gmm2_combine_ring", "gmm_ring.cu", "gmm_ring.py:487", g2),
        ("quant_matmul", "quant_matmul.cu", "matmul.py:127", k1),
        ("quant_per_token", "quant.cu", "quant.py:69", k5),
        ("swiglu_quant", "quant.cu", "activation.py:112", k7a),
        ("grouped_matmul", "grouped_matmul.cu", "grouped_matmul.py:538",
         summed(f"grouped_matmul, a layer's 2 calls at {LONG_CHUNK} tokens", k8)),
        ("lightning_indexer_scores_prefill_pallas", "lightning_indexer.cu",
         "attention/lightning_indexer.py:144", k10),
        ("mla_prefill_block_sparse", "mla_prefill.cu", "attention/mla_prefill.py:403",
         {**k9b8, "err": max(k9b["err"], k9b8["err"])}),
        ("rms_norm", "norm.cu", "norm.py:87", k6),
        ("swiglu_oai", "activation.cu", "activation.py:162", k7b),
        ("attention_sinks", "sinks_attention.cu", "attention/sinks_attention.py:226", k12a),
        ("attention_sinks_packed", "sinks_attention.cu",
         f"attention/sinks_attention.py:425 and {tpu}attention/sinks_flat.py:228", k12b),
        ("attention_sinks_prefill_pallas", "sinks_attention.cu",
         "attention/sinks_attention.py:721", k12d),
        ("decode_gqa", "sinks_attention.cu",
         "attention/decode_attention.py:696 and :539", k11),
        ("add_rms_norm_bias", "norm.cu", "norm.py:149", k6b),
        ("add_gemma_rms_norm", "norm.cu", "norm.py:193", k6c),
        ("l1_norm", "norm.cu", "norm.py:265", k6d),
        ("bgmv_fused", "lora.cu", "lora_pallas.py:137", k13a),
        ("sgmv_fused", "lora.cu", "lora_pallas.py:244", k13b),
        ("grouped_matmul_float", "grouped_matmul.cu", "grouped_matmul.py:538", k8f),
        ("pallas_all_to_all", "a2a.cu", "sgl_kernel_npu_tpu/parallel/pallas_a2a.py:703", k15a),
        ("pallas_ragged_all_to_all", "a2a.cu", "sgl_kernel_npu_tpu/parallel/pallas_a2a.py:637",
         k15b),
        ("pallas_ragged_all_to_all_monitored", "a2a.cu",
         "sgl_kernel_npu_tpu/parallel/pallas_a2a.py:594", k15c),
        ("fused_deep_moe_full_rank", "fused_full.cu",
         "sgl_kernel_npu_tpu/parallel/fused_full.py:1015", k16b),
        *((name, "grouped_matmul.cu", "grouped_matmul.py:538", k4l[name])
          for name in ("grouped_matmul:dispatch_p", "grouped_matmul:dequant_swiglu",
                       "grouped_matmul:dequant_f32", "grouped_matmul:none_int8",
                       "grouped_matmul_float:bf16_out")),
        ("grouped_matmul_combine", "grouped_matmul.cu", "grouped_matmul.py:746",
         k4l["grouped_matmul_combine"]),
        ("fused_dispatch_gmm1_rank", "fused_kernel.cu",
         "sgl_kernel_npu_tpu/parallel/fused_kernel.py:250", k4l["fused_dispatch_gmm1_rank"]),
        ("gmm1_ring:float_x", "gmm_ring.cu", "gmm_ring.py:282", k4l["gmm1_ring:float_x"]),
    ]
    # launches: each kernel's count on the first path that runs it (the base
    # four on the float-prologue serve, K1 on the fused-prologue serve, K5
    # and K7a on the fully W8A8 step and chunk, K8a on the long-prompt serve,
    # K10 and K9b on the DSA serve, K6a, K7b, K12a and K12d on the GPT-OSS
    # serve, K12b / K12c on its packed serve, K11a on the Llama serve, K13a on
    # the LoRA serve; K6b, K6c, K6d and K13b, which no model calls, on their
    # ops' own run; K8a's none mode on the GPT-OSS EP serve; [4l]'s on its
    # paths, K8a's modes no caller reaches on their ops' own run)
    path_launches = {**launches, "quant_matmul": launches_q["quant_matmul"],
                     "quant_per_token": launches_w["quant_per_token"],
                     "swiglu_quant": launches_w["swiglu_quant"],
                     "grouped_matmul": launches_l["grouped_matmul"],
                     **{k: launches_d[k] for k in DSA_KERNELS},
                     **{k: launches_g[k] for k in GPT_KERNELS},
                     "attention_sinks_packed": launches_gp["attention_sinks_packed"],
                     "decode_gqa": launches_ll["decode_gqa"],
                     "bgmv_fused": launches_lo["bgmv_fused"],
                     **{k: launches_ops[k] for k in ("add_rms_norm_bias", "add_gemma_rms_norm",
                                                     "l1_norm", "sgmv_fused")},
                     "grouped_matmul_float": launches_i["grouped_matmul_float"],
                     **launches_k, **launches_l4}
    return rows, path_launches


# ---------------------------------------------------------------------------
# [4q] / [4r]: the multi-rank serving layouts, two rank processes on the card
# ---------------------------------------------------------------------------

RANKS = 2
RANK_TIMEOUT_S = 480
TP_CTX = [716, 612, 556, 470, 320, 166, 112, 400]   # [3]'s decode contexts, [4]'s batch of 8
CP_CHUNK, CP_LONG = 8192, 8000
CP_PAGES_PER_REQ = CP_CHUNK // CFG_LLAMA.page_size + 2
PIPE_MICRO, PIPE_ROWS = 8, 64
STEP_TOL = 5e-2                 # [4]'s step rule: a row's error over its largest |value|


def rank_phases(card: str):
    """Phases [4q] and [4r]: each starts this script twice in its rank mode,
    two processes on the one card, and holds what they report.  Returns the
    K2 row at a tp-2 rank's 64 heads and its launches, and each path's
    launch counts (for the log)."""
    free, total = torch.cuda.mem_get_info()
    log(f"[4q] DeepSeek-V3 head-parallel decode: decode_step_tp at tp {RANKS}, two rank processes "
        f"of this script on the one card (a gloo group over a FileStore; {free / 2**30:.1f} of "
        f"{total / 2**30:.1f} GiB free, {torch.cuda.memory_allocated() / 2**30:.2f} GiB held "
        "here)")
    tp = two_ranks("tp")
    check_tp(tp)
    log(f"[4r] Llama-3.1-8B context- and pipeline-parallel serving on [4f]'s setup, two rank "
        f"processes: Engine(llama_pp_adapter) on 2 stages of {CFG_LLAMA.num_layers // RANKS} "
        f"layer, Engine(llama_cp_adapter) on a ring of {RANKS} with a {CP_LONG}-token prompt, "
        f"pipeline_forward over {PIPE_MICRO} microbatches")
    serve = two_ranks("serve")
    check_serve(serve, card)
    return tp[0]["k2_64"], tp[0]["launches"]["decode_mla"], {
        "[4q] a TP decode step (a rank)": tp[0]["launches"],
        "[4r] the PP serve (a stage)": serve[0]["pp"]["launches"],
        "[4r] the CP serve (a rank)": serve[0]["cp"]["launches"]}


def two_ranks(task: str) -> list[dict]:
    """Run ``python3 chip_smoke.py --rank <task> <dir> <r>`` for r = 0, 1 on
    the one card: a gloo group over a ``FileStore`` in a temporary
    directory.  Prints each rank's log; a child that exits non-zero stops
    the other and fails the phase with its last log lines.  Returns the
    ranks' results."""
    work = pathlib.Path(tempfile.mkdtemp(prefix=f"chip_smoke_{task}_"))
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    outs = [open(work / f"rank{r}.log", "w") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, str(pathlib.Path(__file__).resolve()), "--rank",
                               task, str(work), str(r)], stdout=outs[r], stderr=subprocess.STDOUT,
                              env=env) for r in range(RANKS)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > RANK_TIMEOUT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in outs:
            f.close()
    texts = [(work / f"rank{r}.log").read_text() for r in range(RANKS)]
    for r, text in enumerate(texts):
        for line in text.splitlines():
            log(f"  r{r}| {line}")
    codes = [p.returncode for p in procs]
    if any(codes):
        for r, text in enumerate(texts):
            log(f"  rank {r} exited {codes[r]}; its last lines:")
            for line in text.splitlines()[-30:]:
                log(f"    {line}")
        raise AssertionError(f"[{task}] rank processes exited {codes} after "
                             f"{time.perf_counter() - t0:.0f} s")
    results = [json.loads((work / f"rank{r}.json").read_text()) for r in range(RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    log(f"  both ranks exited 0 in {time.perf_counter() - t0:.1f} s")
    return results


def same_on_ranks(label: str, values: list) -> None:
    if any(v != values[0] for v in values[1:]):
        raise AssertionError(f"{label} differs between the ranks: {values}")


def check_tp(res: list[dict]) -> None:
    """[4q]'s holds across the ranks: the outputs and caches bit-equal (each
    rank held its own against the one-rank step, K2 once a layer)."""
    same_on_ranks("the TP step's output digest", [r["h"] for r in res])
    same_on_ranks("the TP step's cache digest", [r["cache"] for r in res])
    log(f"  [4q] the two ranks' outputs bit-equal ({res[0]['h']}) and their caches bit-equal "
        f"({res[0]['cache']}); within {max(r['err'] for r in res):.3e} of the one-rank step "
        f"(tol {STEP_TOL}); caches bit-equal to its; K2 {res[0]['launches']['decode_mla']} launch "
        "a layer a step on each rank, nothing else")


def check_serve(res: list[dict], card: str) -> None:
    """[4r]'s holds across the ranks and against rank 0's one-rank serves."""
    one, pp, cp = res[0]["one"], [r["pp"] for r in res], [r["cp"] for r in res]
    same_on_ranks("the PP tokens", [p["tokens"] for p in pp])
    if pp[0]["tokens"] != one["tokens"]:
        raise AssertionError("the PP serve's tokens differ from the one-rank llama_adapter serve's")
    for p in pp:
        if 2 * p["cache_bytes"] != one["cache_bytes"]:
            raise AssertionError(f"a stage's cache {p['cache_bytes']} B is not half the one-rank "
                                 f"cache's {one['cache_bytes']} B")
    same_on_ranks("the CP tokens", [c["tokens"] for c in cp])
    same_on_ranks("the CP prefill logits' digest", [c["logits"] for c in cp])
    same_on_ranks("the CP cache digest", [c["cache"] for c in cp])
    same_on_ranks("pipeline_forward's output digest", [r["pipe"]["y"] for r in res])
    log(f"  [4r] PP: the ranks' tokens equal each other and the one-rank serve's, bit for bit "
        f"(predicted); a stage's cache {pp[0]['cache_bytes'] / 2**20:.1f} MiB = half of one "
        f"rank's {one['cache_bytes'] / 2**20:.1f} MiB; CP: the ranks' tokens, prefill logits "
        f"and caches bit-equal; pipeline_forward's output bit-equal on both ranks")
    log(f"  [4r] tok/s ({card}): one rank prefill {one['prefill_tok_s']:.1f} / decode "
        f"{one['decode_tok_s']:.1f}; PP {pp[0]['prefill_tok_s']:.1f} / "
        f"{pp[0]['decode_tok_s']:.1f}; "
        f"one rank at prefill_chunk {CP_CHUNK} {res[0]['one_cp']['prefill_tok_s']:.1f} / "
        f"{res[0]['one_cp']['decode_tok_s']:.1f}; CP {cp[0]['prefill_tok_s']:.1f} / "
        f"{cp[0]['decode_tok_s']:.1f}")


def rank_main(task: str, work: pathlib.Path, rank: int) -> None:
    """A rank process of [4q] / [4r]: join the gloo group, run the task,
    write its results; the kernels were built by the parent (loaded here)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.load_library()
    dist.init_process_group("gloo", store=dist.FileStore(str(work / "store"), RANKS), rank=rank,
                            world_size=RANKS)
    try:
        out = {"tp": tp_rank, "serve": serve_rank}[task](rank, dist.group.WORLD)
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def wall_and_busy(fn, group=None, iters: int = 5) -> tuple[float, float]:
    """Median wall ms of ``fn()`` (synchronised; with ``group`` every rank of
    it runs the calls at once, after a barrier each) and the device busy ms
    of one more call by the profiler."""
    fn()
    walls = []
    for _ in range(iters):
        if group is not None:
            dist.barrier(group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    if group is not None:
        dist.barrier(group)
    _, busy, _ = trace_profile.device_breakdown(fn)
    return statistics.median(walls), busy


def tp_rank(rank: int, group) -> dict:
    """[4q] on one rank: CFG_TRAIN's layer (published widths, bf16, the float
    experts), this rank's 64 heads (``tp_shard_layer``), a bf16 cache of
    random history; [4]'s batch of 8 at [3]'s decode contexts."""
    cfg = CFG_TRAIN
    t0 = time.perf_counter()
    for r in range(RANKS):      # in turn: making the experts takes 15 GiB of f32 beside them
        if r == rank:
            params = m.init_weights(cfg, SEED, torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    mine = {**params, "layers": [m.tp_shard_layer(lw, rank, RANKS) for lw in params["layers"]]}
    heads = mine["layers"][0]["wuk"].shape[0]
    log(f"rank {rank}: weights made in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB); {heads} of {cfg.num_heads} heads")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 30)
    b, page = len(TP_CTX), cfg.page_size
    max_pages = -(-max(TP_CTX) // page)
    base = m.init_kv_cache(cfg, b * max_pages + 1, torch.bfloat16)
    for c in base:
        c["nope"].copy_(randn(gen, c["nope"].shape))
        c["rope"].copy_(randn(gen, c["rope"].shape))
    bt = (torch.arange(b * max_pages, dtype=torch.int32, device=DEV) + 1).reshape(b, max_pages)
    ctx = torch.tensor(TP_CTX, dtype=torch.int32, device=DEV)
    pos = (ctx - 1).long()
    slots = (bt[torch.arange(b, device=DEV), pos // page] * page + pos % page).int()
    x = m.embed(params, torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=DEV))
    caches = {k: [{n: t.clone() for n, t in c.items()} for c in base] for k in ("tp", "one")}

    def tp_step():
        return m.decode_step_tp(cfg, mine, x, pos, caches["tp"], bt, ctx, slots, group=group)[0]

    def one_step():
        return m.decode_step(cfg, params, x, pos, caches["one"], bt, ctx, slots)[0]

    tp_step()
    collectives.reset_staged()
    counters.reset()
    h = tp_step()
    torch.cuda.synchronize()
    launches = held_launches(f"rank {rank}: a TP decode step", counters.read(),
                             {"decode_mla": cfg.num_layers})
    staged = collectives.staged_bytes()
    got, rec = with_routes(lambda: tp_step().float())
    _, rec_one = with_routes(one_step)
    want, _ = with_routes(lambda: one_step().float(), rec)
    err = float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())
    log(f"rank {rank}: decode_step_tp vs the one-rank decode_step on the same card and inputs, "
        f"the routing replayed (its own agrees on {int(same_routing(rec, rec_one, b).sum())}/{b} "
        f"rows): max rel err {err:.3e} (tol {STEP_TOL}); launches a step "
        f"{launches}; {staged} bytes staged through the host a step (the all-reduce of "
        f"[{b}, {cfg.hidden}] bf16, each way)")
    if not err <= STEP_TOL:
        raise AssertionError(f"rank {rank}: decode_step_tp {err:.3e} from the one-rank step")
    for li in range(cfg.num_layers):
        for n in ("nope", "rope"):
            if not torch.equal(caches["tp"][li][n], caches["one"][li][n]):
                raise AssertionError(f"rank {rank}: the TP step's {n} cache differs from the "
                                     "one-rank step's")
    wall_tp, busy_tp = wall_and_busy(tp_step, group)
    o = torch.zeros((b, cfg.hidden), dtype=torch.bfloat16, device=DEV)
    exch, _ = wall_and_busy(lambda: collectives.all_sum(o, group), group, iters=20)
    log(f"rank {rank}: a TP step {wall_tp:.3f} ms wall, {busy_tp:.3f} ms device busy (both "
        f"ranks at once); the all-reduce alone {exch:.3f} ms wall "
        f"({100 * exch / wall_tp:.1f} % of the step)")
    out = {"h": digest(h), "cache": digest(torch.cat([t.reshape(-1).view(torch.uint8)
                                                      for c in caches["tp"] for t in c.values()])),
           "err": err, "launches": launches, "staged": staged, "wall_tp": wall_tp,
           "busy_tp": busy_tp, "exchange_ms": exch}
    dist.barrier()
    if rank == 0:           # alone on the card: the one-rank step, K2 at each rank's share
        wall_one, busy_one = wall_and_busy(one_step)
        log(f"rank 0 alone: the one-rank step {wall_one:.3f} ms wall, {busy_one:.3f} ms busy")
        k2 = {h_: check_decode_mla(gen, b, h_, page, TP_CTX, 0, True)
              for h_ in (cfg.num_heads, cfg.num_heads // RANKS, cfg.num_heads // 8)}
        log(f"rank 0: K2 at [3]'s decode shape, 128 / 64 / 16 heads: "
            + " / ".join(f"{k2[h_]['ms']:.4f}" for h_ in sorted(k2, reverse=True)) + " ms")
        out.update(wall_one=wall_one, busy_one=busy_one, k2_64=k2[cfg.num_heads // RANKS])
    dist.barrier()
    return out


def serve_rank(rank: int, group) -> dict:
    """[4r] on one rank (see the module docstring)."""
    cfg = CFG_LLAMA
    params = lm.init_weights(cfg, SEED, torch.bfloat16, untied_lm_head=True)
    ps = prompts(torch.Generator().manual_seed(SEED + 6), GPT_PROMPT_LENS, (0, GPT_SHARED),
                 cfg.vocab_size)
    kw = dict(max_batch=MAX_BATCH, max_pages_per_req=GPT_PAGES_PER_REQ, prefill_chunk=GPT_CHUNK)
    lps, layers = cfg.num_layers // RANKS, cfg.num_layers
    out = {}
    if rank == 0:
        out["one"] = rank_serve("one rank, llama_adapter", lambda: llama_adapter(cfg, params),
                                ps, kw)
    dist.barrier()
    collectives.reset_staged()
    pp = rank_serve(f"rank {rank}: PP stage {rank}", lambda: llama_pp_adapter(cfg, params, group),
                    ps, kw,
                    want=lambda n_pre, n_dec: {
                        "attention_sinks_prefill_pallas": lps * n_pre, "decode_gqa": lps * n_dec,
                        "rms_norm": (2 * lps + 1) * (n_pre + n_dec)})
    log(f"rank {rank}: a PP serve staged {collectives.staged_bytes() / 2 / 2**20:.1f} MiB "
        "through the host (the hops and the broadcasts, each way)")
    out["pp"] = pp
    long_prompt = torch.randint(0, cfg.vocab_size, (CP_LONG,),
                                generator=torch.Generator().manual_seed(SEED + 31)).tolist()
    ps_cp = ps[:-1] + [long_prompt] + ps[-1:]       # [4f]'s order: the 5th after the 1st's prefill
    kw_cp = dict(max_batch=MAX_BATCH, max_pages_per_req=CP_PAGES_PER_REQ, prefill_chunk=CP_CHUNK)
    if rank == 0:
        out["one_cp"] = rank_serve(f"one rank, llama_adapter, prefill_chunk {CP_CHUNK}",
                                   lambda: llama_adapter(cfg, params), ps_cp, kw_cp)
    dist.barrier()
    cp = rank_serve(f"rank {rank}: CP", lambda: llama_cp_adapter(cfg, params, group), ps_cp,
                    kw_cp, reuse=False, want=lambda n_pre, n_dec: {
                        "decode_gqa": layers * n_dec,
                        "rms_norm": (2 * layers + 1) * (n_pre + n_dec)})
    if rank == 0:
        cp_rule(params, ps_cp, out["one_cp"], cp)
    out["cp"] = cp
    out["cp"]["cache"] = cp_cache_check(rank, group, params, long_prompt)
    out["pipe"] = pipeline_check(rank, group)
    for run in out.values():
        run.pop("last_logits", None)
    return out


def rank_serve(label, make_adapter, ps, kw, *, reuse=True, want=None) -> dict:
    """Serve ``ps`` (16 new tokens each) twice, each time on a fresh
    ``make_adapter()`` and ``Engine``: the first run warms the process up
    (its tokens must equal the second's), the second is timed and counted.
    [4f]'s arrival order (``run_requests``; ``reuse=False``: no prefix
    matched, the CP engine's rule).  Each prefill call's last live row's
    logits are kept.  With
    ``want(n_prefill_calls, n_decode_calls)`` the launch counts are held
    exactly.  Returns tokens, tok/s, cache bytes, launches and the logits."""
    runs = [serve_once(make_adapter(), ps, kw, reuse) for _ in range(2)]
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError(f"{label}: two serves of the same prompts gave different tokens")
    res = runs[1]
    eng, timer, wall = res.pop("eng"), res.pop("timer"), res.pop("wall")
    n_pre, n_dec = timer.calls["prefill"], timer.calls["decode"]
    if want is not None:
        res["launches"] = held_launches(label, res["launches"], want(n_pre, n_dec))
    res["launches"] = {k: v for k, v in res["launches"].items() if v}
    dec_tokens = len(ps) * (NEW_TOKENS - 1)
    res.update(prefill_tok_s=eng.stats["prefill_tokens"] / timer.t["prefill"],
               decode_tok_s=dec_tokens / timer.t["decode"])
    log(f"{label}: {len(ps)} requests (prompts {[len(p) for p in ps]}) in {wall:.2f} s (the "
        f"second of two serves); prefill {eng.stats['prefill_tokens']} tokens in {n_pre} calls "
        f"of {kw['prefill_chunk']} rows, {timer.t['prefill']:.3f} s = "
        f"{res['prefill_tok_s']:.1f} tok/s; decode {dec_tokens} tokens in {n_dec} steps, "
        f"{timer.t['decode']:.3f} s = {res['decode_tok_s']:.1f} tok/s; cache "
        f"{res['cache_bytes'] / 2**20:.1f} MiB; launches {res['launches']}; radix cached tokens "
        f"{eng.stats['cached_tokens']}")
    return res


def serve_once(adapter, ps, kw, reuse) -> dict:
    """One serve of :func:`rank_serve` with the launch counts reset before."""
    timer = StepTimer(adapter)
    last = []
    prefill = adapter.prefill_step

    def recording(x, sl, *a):
        h, c = prefill(x, sl, *a)
        n = int(sl[0])
        last.append(adapter.lm_head(h[n - 1:n]).float())
        return h, c

    adapter.prefill_step = recording
    eng = Engine(adapter, GPT_NUM_PAGES, **kw)
    cache_bytes = sum(t.numel() * t.element_size() for t in cache_tensors(eng.caches))
    rids, wall, launches = run_requests(eng, ps, (0, GPT_SHARED), GPT_NUM_PAGES,
                                        CFG_LLAMA.vocab_size, reuse)
    return {"tokens": [eng.finished[r] for r in rids], "cache_bytes": cache_bytes,
            "launches": launches, "last_logits": last, "logits": digest(torch.cat(last)),
            "eng": eng, "timer": timer, "wall": wall}


def cp_rule(params, ps, one, cp) -> None:
    """The CP serve against the one-rank serve on K12d: each prefill's last
    row's logits within ``STEP_TOL`` of the row's largest |logit|; each
    request's greedy tokens equal up to its first difference, which must
    sit at a near-tie: the one-rank path's own top-2 gap at that token, by
    a one-rank prefill over the prompt and the tokens before it, within
    ``STEP_TOL`` of its largest |logit| ([4m]'s rule)."""
    errs = [float((c - o).abs().max() / o.abs().max())
            for c, o in zip(cp["last_logits"], one["last_logits"])]
    log(f"rank 0: CP vs one rank, each prefill's last-row logits: max rel err "
        f"{max(errs):.3e} (tol {STEP_TOL}; per prefill {[f'{e:.2e}' for e in errs]})")
    if not max(errs) <= STEP_TOL:
        raise AssertionError(f"CP prefill logits {max(errs):.3e} from the one-rank prefill's")
    parted = []
    for i, (a, b) in enumerate(zip(cp["tokens"], one["tokens"])):
        k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            continue
        ids = torch.tensor(ps[i] + b[:k], dtype=torch.int32, device=DEV)
        logits = prefill_logits(params, ids)
        top2 = torch.topk(logits, 2).values
        gap = float((top2[0] - top2[1]) / logits.abs().max())
        parted.append((i, k, gap))
        if not gap <= STEP_TOL:
            raise AssertionError(f"request {i} parts at token {k} with a top-2 gap of {gap:.3e} "
                                 "of its largest |logit|: not a near-tie")
    log(f"rank 0: CP greedy tokens equal the one-rank serve's on "
        f"{len(ps) - len(parted)}/{len(ps)} requests; parted at a near-tie (request, token, "
        f"top-2 gap over the largest |logit|): {[(i, k, round(g, 5)) for i, k, g in parted]}")


def prefill_logits(params, ids) -> torch.Tensor:
    """The one-rank prefill's (K12d) logits at the last of ``ids``."""
    n, page = ids.shape[0], CFG_LLAMA.page_size
    pages = -(-n // page)
    caches = lm.init_kv_cache(CFG_LLAMA, pages + 1, torch.bfloat16)
    bt = torch.arange(1, pages + 1, dtype=torch.int32, device=DEV)[None]
    seq = torch.tensor([n], dtype=torch.int32, device=DEV)
    slots = torch.arange(page, page + n, dtype=torch.int32, device=DEV)
    h, _ = lm.prefill_step(CFG_LLAMA, params, lm.embed(params, ids), seq, caches, bt, seq, slots,
                           max_q=n)
    return lm.lm_head(params, h[n - 1]).float()


def cp_cache_check(rank, group, params, prompt) -> str:
    """The long prompt's prefill alone, ``prefill_step_cp`` against the
    one-rank ``prefill_step`` on fresh caches: each layer's K / V rows
    within 2e-2 of the largest |value| (layer 0's bit-equality reported);
    the CP ring's attention against K12d's, timed.  Returns the CP caches'
    digest."""
    cfg, page = CFG_LLAMA, CFG_LLAMA.page_size
    n, s = len(prompt), CP_CHUNK
    pages = s // page
    bt = torch.arange(1, pages + 1, dtype=torch.int32, device=DEV)[None]
    seq = torch.tensor([n], dtype=torch.int32, device=DEV)
    slots = torch.full((s,), -1, dtype=torch.int32, device=DEV)
    slots[:n] = torch.arange(page, page + n, dtype=torch.int32, device=DEV)
    ids = torch.zeros((s,), dtype=torch.int32, device=DEV)
    ids[:n] = torch.tensor(prompt, dtype=torch.int32, device=DEV)
    x = lm.embed(params, ids)
    caches = {k: lm.init_kv_cache(cfg, pages + 1, torch.bfloat16) for k in ("cp", "one")}
    lm.prefill_step_cp(cfg, params, x, seq, caches["cp"], bt, seq, slots, group=group)
    lm.prefill_step(cfg, params, x, seq, caches["one"], bt, seq, slots, max_q=s)
    rows = slice(1, 1 + -(-n // page))
    errs, equal0 = [], None
    for li in range(cfg.num_layers):
        for got, want in zip(caches["cp"][li], caches["one"][li]):
            g, w = got[rows].float(), want[rows].float()
            errs.append(float((g - w).abs().max() / w.abs().max()))
            if li == 0:
                equal0 = bool(torch.equal(got, want)) if equal0 is None else equal0 and bool(
                    torch.equal(got, want))
    log(f"rank {rank}: the {n}-token prefill's cache, prefill_step_cp vs the one-rank "
        f"prefill_step: K / V max rel err by layer {[f'{e:.2e}' for e in errs]} (tol 2e-2); "
        f"layer 0 bit-equal: {equal0}")
    if not max(errs) <= 2e-2:
        raise AssertionError(f"rank {rank}: the CP cache {max(errs):.3e} from the one-rank cache")
    cache_digest = digest(torch.cat([t.reshape(-1).view(torch.uint8)
                                     for layer in caches["cp"] for t in layer]))
    # the attention alone: the CP prefill's (this rank's rows against the
    # gathered K / V), JAX's ring over the same rows, K12d on all of them
    gen = torch.Generator(device=DEV).manual_seed(SEED + 33)
    tl = s // RANKS
    q = randn(gen, (1, tl, cfg.num_heads, cfg.head_dim))
    k = randn(gen, (1, s, cfg.num_kv_heads, cfg.head_dim))
    v = randn(gen, (1, s, cfg.num_kv_heads, cfg.head_dim))
    mine = slice(rank * tl, (rank + 1) * tl)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    gathered = lambda: gathered_attention(q, k, v, scale, q_offset=rank * tl)  # noqa: E731
    ring = lambda: ring_attention(q, k[:, mine], v[:, mine], scale, group=group)  # noqa: E731
    want = ring()
    err = float((gathered() - want).abs().max() / want.abs().max())
    cp_ms, cp_busy = wall_and_busy(gathered, group, iters=3)
    ring_ms, ring_busy = wall_and_busy(ring, group, iters=3)
    log(f"rank {rank}: the CP prefill's attention (gathered_attention), {tl} rows a rank of "
        f"{s}, {cfg.num_heads} / {cfg.num_kv_heads} heads: {cp_ms:.2f} ms wall, {cp_busy:.2f} ms "
        f"device busy; JAX's ring (ring_attention) on the same rows {ring_ms:.2f} / "
        f"{ring_busy:.2f} ms (both ranks at once); they differ by {err:.3e} of the largest "
        "|value| (tol 1e-2: bf16 outputs of f32 sums in another order)")
    if not err <= 1e-2:
        raise AssertionError(f"rank {rank}: gathered_attention {err:.3e} from ring_attention")
    dist.barrier()
    if rank == 0:
        kc, vc = caches["one"][0]
        qf = randn(gen, (s, cfg.num_heads * cfg.head_dim))
        k12d = time_ms(lambda: sa.attention_sinks_prefill_pallas(
            qf, kc, vc, None, seq, bt, seq, scale, 0, cfg.num_heads, cfg.num_kv_heads,
            max_q=s), 5)
        log(f"rank 0 alone: K12d over the same {n} live rows of {s}: {k12d:.4f} ms; the CP "
            f"attention takes {cp_ms / k12d:.1f}x its time, the ring {ring_ms / k12d:.1f}x")
    dist.barrier()
    return cache_digest


def pipeline_check(rank, group) -> dict:
    """``pipeline_forward`` over the two ranks, stage = [4f]'s SwiGLU MLP with
    a residual (4096 x 14336, bf16), ``PIPE_MICRO`` microbatches of
    ``PIPE_ROWS`` rows, the loss sum(y²) and its gradient, against the
    sequential application on this rank: y within 2e-2 and this stage's
    gradients within 5e-2 of their largest |value|."""
    h, inter = CFG_LLAMA.hidden, CFG_LLAMA.intermediate
    gen = torch.Generator(device=DEV).manual_seed(SEED + 32)
    weights = {"w_gate": randn(gen, (RANKS, h, inter), scale=0.02),
               "w_up": randn(gen, (RANKS, h, inter), scale=0.02),
               "w_down": randn(gen, (RANKS, inter, h), scale=0.02)}
    x = randn(gen, (PIPE_ROWS, h))

    def stage(p, t):
        return t + lm._mlp(p, t)

    def run(parallel):
        sp = {k: w.clone().requires_grad_() for k, w in weights.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if parallel:
            y = pipeline_forward(stage, sp, x, group=group, num_micro=PIPE_MICRO)
        else:
            y = x
            for s_ in range(RANKS):
                y = stage({k: w[s_] for k, w in sp.items()}, y)
        (y.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        return y.detach(), {k: w.grad[rank] for k, w in sp.items()}, time.perf_counter() - t0

    run(True)
    y, g, t_pipe = run(True)
    y1, g1, t_seq = run(False)
    err_y = float((y.float() - y1.float()).abs().max() / y1.float().abs().max())
    err_g = max(float((g[k].float() - g1[k].float()).abs().max() / g1[k].float().abs().max())
                for k in g)
    log(f"rank {rank}: pipeline_forward ({RANKS} stages, {PIPE_MICRO} microbatches of "
        f"{PIPE_ROWS // PIPE_MICRO} rows) vs the sequential stages: y max rel err {err_y:.3e} "
        f"(tol 2e-2), stage {rank}'s gradients {err_g:.3e} (tol 5e-2); forward + backward "
        f"{t_pipe * 1e3:.1f} ms against {t_seq * 1e3:.1f} ms sequential on one rank")
    if not (err_y <= 2e-2 and err_g <= 5e-2):
        raise AssertionError(f"rank {rank}: pipeline_forward off the sequential model")
    return {"y": digest(y), "err_y": err_y, "err_g": err_g}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"[1] build  (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)})")
    t0 = time.perf_counter()
    cuda_lib.load_library()
    built = (f"nvcc build {cuda_lib.build_seconds:.1f} s" if cuda_lib.build_seconds
             else "already built in this checkout")
    log(f"  kernels loaded in {time.perf_counter() - t0:.1f} s ({built})")
    log(f"  card: {card}")
    comm_s = ep_group()
    log(f"  EP group: one NCCL rank over an in-process store (torch.distributed); its first "
        f"all-to-all, which makes the communicator, {comm_s:.2f} s")
    stream = torch.cuda.current_stream().cuda_stream
    lib = cuda_lib.load_library()
    floor_ms = time_ms(lambda: cuda_lib.check(lib, lib.empty_launch(stream), "empty"),
                       50)
    log(f"  launch floor (an empty kernel, csrc/launch_floor.cu): {floor_ms:.4f} ms")
    rows, path_launches = serving_phases(card)
    gc.collect()
    torch.cuda.empty_cache()
    (k11_256, k12_256), launches_o = qwen_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    (k14a, k14b, k14c), launches_t, (k8f_train, k8dx), launches_j = training_phase()
    gc.collect()
    torch.cuda.empty_cache()
    k2_tp, launches_k2_tp, launches_ranks = rank_phases(card)
    log(f"  [4q] / [4r] launches on the paths: {json.dumps(launches_ranks)}")
    src, tpu = "sgl_kernel_npu_tpu_torch/csrc/", "sgl_kernel_npu_tpu/ops/"
    # K11a / K12d at head_dim 256, their launches on [4o]'s float serve
    rows += [("k11a_d256", "sinks_attention.cu", "attention/decode_attention.py:696 and :539",
              k11_256),
             ("k12d_d256", "sinks_attention.cu", "attention/sinks_attention.py:721", k12_256)]
    path_launches["k11a_d256"] = launches_o["decode_gqa"]
    path_launches["k12d_d256"] = launches_o["attention_sinks_prefill_pallas"]
    rows += [("mla_flash_fwd", "mla_train.cu", "attention/mla_train.py:222", k14a),
             ("mla_flash_bwd_dq", "mla_train.cu", "attention/mla_train.py:277", k14b),
             ("mla_flash_bwd_dk", "mla_train.cu", "attention/mla_train.py:294", k14c),
             ("grouped_matmul_dx", "grouped_matmul.cu", "grouped_matmul.py:538", k8dx)]
    path_launches.update({k: launches_t[k] for k in TRAIN_KERNELS})
    path_launches["grouped_matmul_dx"] = launches_j["grouped_matmul_dx"]
    # K2 at a tp-2 rank's 64 heads, its launches on [4q]'s TP decode step (rank 0)
    rows.append(("decode_mla_tp2", "decode_mla.cu", "attention/decode_attention.py:346", k2_tp))
    path_launches["decode_mla_tp2"] = launches_k2_tp
    log(f"  grouped_matmul_float at [4j]'s training shapes: {k8f_train['ms']:.4f} ms a layer's 3 "
        f"forward products (bound {k8f_train['bound_ms']:.4f}); its JSON row holds [4i]'s")
    if len({id(r) for *_, r in rows}) != len(rows):
        raise AssertionError("two kernel rows share one result: a result was rebound")
    kernels = [{
        "name": name, "route": "cuda", "source": src + cu,
        "replaces": replaces if replaces.startswith("sgl_kernel_npu_tpu/") else tpu + replaces,
        "launches": path_launches[name], "max_abs_err": r["err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    } for name, cu, replaces, r in rows]
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor_ms}))
    print(card)
    dist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:         # a rank process of [4q] / [4r]
        rank_main(sys.argv[2], pathlib.Path(sys.argv[3]), int(sys.argv[4]))
    else:
        main()
