#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device      — needs CUDA; prints ``nvidia-smi``'s name and power limit.
2. build       — builds the CUDA kernels from ``src/repro_torch/kernels/csrc``,
                 logs ``ptxas``'s registers and spills, and counts the
                 HMMA/HGMMA instructions in the SASS (``cuobjdump``) of each
                 attention kernel and each SSD pass that runs a product:
                 none there fails the run; then each of zamba2-7b's,
                 gpt3-xl's, llama3.2-3b's, internvl2-1b's, yi-34b's,
                 seamless-m4t-medium's, llama4-scout-17b-a16e's and
                 nemotron-4-340b's instantiations on its own line
                 (registers, spills, HMMA), their training backwards' at
                 head_dim 224 and 128 too.
3. kernels     — every kernel against its plain PyTorch version on the card,
                 in bf16, at the serving path's shapes; times the kernel, the
                 plain version and one PyTorch library call as a yardstick,
                 each cycling over input copies larger than L2, with the
                 host in the loop (CUDA events around the calls: ``ms``),
                 and the kernel and the library call again as device time
                 (the calls queued behind a sleep kernel: ``device_ms``),
                 and computes the kernel's bound from the bytes and
                 operations this run's inputs need (bytes over 3.35 TB/s or
                 operations over the peak rate of their type).
   graphs      — paged decode (bf16 and int8 pools) and the SSD scan (with
                 and without h0), which launch passes under PDL, replayed
                 from a CUDA graph: bitwise equal to an eager call.
   rmsnorm     — (4096, 2048), (4096, 1024) and (4096, 256) against the
                 plain version;
                 timed at both and at the decode shape (8, 2048) beside
                 ``F.rms_norm``, also as calls replayed from one CUDA graph
                 (``graph_ms``); a width it is not built for is refused.
   group2      — paged decode at head_dim 64 with 2 query heads per KV head
                 (granite-moe's attention, 16 heads over 8, and the card
                 smoke config's, 4 over 2): bf16 and int8 pools replayed
                 from a CUDA graph bitwise equal to eager, against the plain
                 version with the paged checks below; timed at granite's
                 shape on bf16 (row ``paged_decode[D64G2 bf16]``, its
                 launches from granite's full-width serve run); fp8 and f32
                 checked and logged.  The build phase logs its ``ptxas``
                 registers and spills; a spill in a serving pool fails.
   paged       — each pool (bf16, int8, fp8, f32) at the serving positions,
                 two calls bitwise equal; at split and page edges with a
                 slot parked at pos == max_seq, a window of 256 beginning
                 inside a split, softcap 50 and a single slot; timed beside
                 SDPA over the pages in use (the row records both sides'
                 bytes), also replayed from a CUDA graph (``graph_ms``);
                 bf16 and int8 also timed at the profile run's short
                 contexts.
   prefill     — the serving buckets 8, 32 (shorter than one 64-row tile),
                 128 and 512 with per-row valid lengths, and a local window
                 over padded rows with no valid key.
   flash_bwd   — the training path's kernels at its attention shape (B 4,
                 S 1024, H 32, KV 8, D 64, causal): the forward with its
                 log-sum-exp and the flash backward against their plain
                 versions, timed beside SDPA's forward and backward; two
                 backward calls bitwise equal; both again at S 200 (not a
                 multiple of the tile) and with G 1 (H == KV).  Then the
                 same at zamba2-7b's training attention (B 4, S 1024, H 32,
                 KV 32, D 224: the forward's log-sum-exp and the backward
                 built for it) and at S 200; its backward row
                 (``flash_bwd[D224]``) goes in the JSON.
   ssd_scan    — the Mamba2 SSD scan at the serving shape (B 8, S 512, H 32,
                 P 64, G 1, N 128, chunk 256), with an initial state, at
                 the prefill buckets 32 and 128, with G 2 over a ragged last
                 chunk and an initial state, with 3 heads a group, and with
                 chunk 16, against its plain version, each twice (bitwise
                 equal); no single PyTorch call computes it, so its row has
                 no library time.
   hybrid      — zamba2-7b's instantiations, each against its plain version
                 and twice (bitwise equal), timed with the host in the loop,
                 as device time and replayed from a CUDA graph, beside its
                 bound and yardstick: RMSNorm at (4096, 3584) and
                 (4096, 7168) (and 8 rows, logged) beside ``F.rms_norm``;
                 the prefill at head_dim 224 with one query head per KV
                 head over the buckets 32, 128 and 512 with ragged rows
                 and a window over rows with no valid key, beside SDPA (the
                 kernels SDPA picked are logged); paged decode at head_dim
                 224 on bf16 and int8 pools with the edges above, replayed
                 from a graph bitwise equal to eager; the SSD scan at B 8,
                 S 512, H 112, G 2, N 64 with and without h0 and at the
                 buckets 32 and 128, replayed from a graph likewise.
   gpt3        — gpt3-xl's instantiations (head_dim 128, one query head per
                 KV head, 16 heads), each against its plain version and
                 twice (bitwise equal), timed as the hybrid's are: the
                 prefill over the buckets 32, 128 and 512 with ragged rows
                 (row ``flash_prefill[D128]``), B 1 at S 77 and a window
                 over rows with no valid key; the training forward with its
                 log-sum-exp and the backward at gpt3-xl's micro-batch (B 8,
                 S 1024; rows ``flash_prefill_lse[D128]``,
                 ``flash_bwd[D128]``), and at S 200 and B 1 S 77, and at
                 the data-parallel rank's micro-batch B 4, S 1024 (rows
                 ``flash_prefill_lse[D128 B4]``, ``flash_bwd[D128 B4]``,
                 their launches from transfer_gpt3), and at a (2, 2)
                 rank's B 4, S 1024, 8 heads (rows ``[D128 H8 tp2]``,
                 their launches from multidevice); paged
                 decode on bf16 and int8 pools with the paged edges, replayed
                 from a graph bitwise equal to eager (rows
                 ``paged_decode[D128G1 bf16]`` and ``[D128G1 int8]``).
   llama3b     — llama3.2-3b's instantiations (head_dim 128, 3 query heads
                 per KV head, 24 heads over 8; RMSNorm at d 3072), as
                 gpt3-xl's: the prefill over the buckets with ragged rows
                 (row ``flash_prefill[D128G3]``), B 1 at S 77, B 2 at S 200
                 and a window; the training forward and backward at the
                 micro-batch B 2, S 1024 (rows ``flash_prefill_lse[D128G3]``,
                 ``flash_bwd[D128G3]``) and their edges; paged decode on
                 bf16 and int8 pools with the paged edges and graph replays
                 (rows ``paged_decode[D128G3 bf16]``, ``[D128G3 int8]``);
                 RMSNorm at (4096, 3072) (row ``rmsnorm[3072]``) and
                 (8, 3072) beside ``F.rms_norm``.
   vlm         — internvl2-1b's instantiations (head_dim 64, 7 query heads
                 per KV head, 14 heads over 2; RMSNorm at d 896), as
                 llama3.2-3b's: the prefill at 256 patch rows + the buckets
                 32, 128 and 512 (row ``flash_prefill[D64G7]`` at S 768),
                 B 1 at S 333 and a window; the training forward and
                 backward at B 4, S 1024 (rows ``flash_prefill_lse[D64G7]``,
                 ``flash_bwd[D64G7]``) and their edges; paged decode on
                 bf16 and int8 pools with the edges and graph replays (rows
                 ``paged_decode[D64G7 bf16]``, ``[D64G7 int8]``); RMSNorm
                 at (4096, 896) (row ``rmsnorm[896]``), 13 rows and 8.
   yi          — yi-34b's (head_dim 128, 7 query heads per KV head, 56
                 over 8): the prefill over the buckets 32, 512 and 128 (row
                 ``flash_prefill[D128G7]`` at yi's bucket, S 128), B 1 at
                 S 77, B 2 at S 200 and a window, with the log-sum-exp;
                 paged decode on bf16 and int8 pools with the edges and
                 graph replays (rows ``paged_decode[D128G7 bf16]``,
                 ``[D128G7 int8]``); the backward refuses (128, 7).
   encdec      — seamless-m4t-medium's (head_dim 64, one query head per KV
                 head, 16 over 16): the prefill without the causal mask at
                 the encoder's serving shape (B 8, S 1024; row
                 ``flash_prefill[enc D64G1 nc]``) and at the
                 cross-attention's, 32 and 512 text positions over 1024
                 frames (row ``flash_prefill[cross]`` at 512), then 37
                 positions (a partial tile) and a ragged valid length, each
                 with its log-sum-exp; the training forward and backward
                 without the mask at B 4, S 1024 (rows
                 ``flash_prefill_lse[enc]``, ``flash_bwd[enc nc]``) and at
                 Sq 512 over Sk 1024 (``[cross]``) with odd edges, and the
                 wide backward at head_dim 128 at Sq 77 over 200 (logged);
                 paged decode at (64, 1) on bf16 and int8 pools with the
                 edges and graph replays (rows ``paged_decode[D64G1
                 bf16]``, ``[D64G1 int8]``).
   llama4      — llama4-scout-17b-a16e's (head_dim 128, 5 query heads per
                 KV head, 40 over 8; RMSNorm at d 5120): the prefill with
                 the local window of 8192 at the short traffic's bucket
                 (B 8, S 512), over rows straddling a window of 100
                 (B 3, S 300) and at the long traffic's bucket (B 4,
                 S 16384, rows of 8160-12000 valid keys; row
                 ``flash_prefill[D128G5 w8192]``, SDPA with the window as an
                 explicit mask); paged decode at (128, 5) on bf16 and int8
                 pools with the paged edges and graph replays (rows
                 ``paged_decode[D128G5 bf16]``, ``[D128G5 int8]``); RMSNorm
                 at (4096, 5120) (row ``rmsnorm[5120]``); the forward and
                 the backward with window 32 at B 2, S 1024, 4 heads over 2
                 at head_dim 64 (row ``flash_bwd[D64G2 w32]``), and at
                 window 256, S 77 and 200, a window of 40 beginning
                 mid-tile and S 64.
   nemotron    — nemotron-4-340b's (head_dim 192, 12 query heads per KV
                 head, 96 over 8): the prefill over the buckets 32, 128 and
                 512 (row ``flash_prefill[D192G12]``), B 1 at S 77, B 2 at
                 S 200 and a window; paged decode (12 rows a KV head in 3
                 blocks of 4) on bf16 and int8 pools with the paged edges
                 and graph replays (rows ``paged_decode[D192G12 bf16]``,
                 ``[D192G12 int8]``).
4. serve       — llama3.2-1b at full width (random weights from a seeded
                 generator) serves 16 requests through ``ServeEngine.generate``
                 with bf16 pages, CUDA graphs on (``cuda_graphs``), then the
                 first 8 with 32 new tokens each with graphs on (the same
                 engine) and off (``ONOFF``); int8 pages with graphs on (the
                 capturing run alone); then a dense cache and a sampled run
                 (temperature 0.8, seed 7), 8 requests, graphs on and off.
                 Asserts equal tokens on and off, every
                 kernel's launch count (counted through graph replays), that
                 no logit is NaN and ``compile_stats`` within the
                 reference's bound; logs tokens/s, each capture's host ms
                 and the graphs' pool.
   profile     — a short bf16-page run under torch.profiler, graphs on:
                 wall and device ms a decode step, launches a step,
                 the device's idle share, the port's kernels' share.
5. consistency — prefill + paged decode steps against a longer prefill.
   serve_prefix — (after dvfs) llama3.2-1b with the radix prefix cache: 24
                 requests on 4 shared templates of 128, 200, 256 and 333
                 tokens (two end mid-page: copy-on-write tails) plus 16-128
                 unique tokens, 32 new each; graphs on: on bf16 pages the
                 cache off and on, and a small pool whose admissions
                 evict; on int8 pages the cache off and on.  Greedy tokens on equal off (a request
                 that parts is held spliced against cold within 2e-2 of
                 max |logit|, argmax equal before it, and logged), hits,
                 copy-on-write copies, evictions, exact launches, a drained
                 pool after the tree's flush; hit rates, peak distinct
                 pages and tokens/s on against off logged.
   wave        — ``WaveEngine`` against the continuous engine (dense
                 cache, graphs on) over the serve phase's 16 requests:
                 tokens/s of both and their ratio, the wave's exact
                 launches, finite logits; equal greedy tokens on 8 prompts
                 of 128 tokens, where left-padding is a no-op.
   fleet_migration — (after wave) disaggregated serving's device path at
                 llama3.2-1b's full width, bf16 and then int8 pages: engine
                 A (8 slots, max_seq 1024, page 16) prefills the serve
                 phase's first 8 prompts; every slot is extracted as a
                 ``PageBlockTransfer`` (half through the ``to_dict`` /
                 ``from_dict`` host round trip, half device to device) and
                 spliced into engine B, whose spacer allocation puts the
                 pages on other ids; A's cache is then overwritten with
                 junk.  B and an unmigrated engine decode 16 greedy steps:
                 argmax exact every step, max |dlogit| within 1e-5 (bf16)
                 / 5e-2 (int8), logged; exact launches (16 paged decodes a
                 step).  The same transfers spliced into an engine whose
                 decode graph was captured before the splice replay to the
                 same tokens.  Per request: the payload bytes beside
                 ``kv_bytes_per_token`` x its reservation, extract and
                 splice ms (CUDA events), the host round trip ms, and
                 ``TransferCostModel``'s modeled link.
   fleet_launcher — ``repro_torch.launch.fleet`` (modeled time on h100-like
                 chip models; no device) for 200 requests each: 3 unified
                 replicas, energy-slo, 60 requests/s; the same under a cap
                 of 0.9 x their planned draw with every replica loaded
                 (must re-plan); 2 prefill + 2 decode replicas under the
                 storm faults (migrations charged).  ``check_fleet``
                 clean, every request completed or counted stranded;
                 J/token, TTFT and TPOT p50/p99 logged as modeled.
   examples    — (after fleet_launcher) the README's five examples through
                 their ``main(argv)`` (``repro_torch.examples``, chip model
                 h100): quickstart, plan_transfer and fleet_serve on chip
                 models alone (no kernel launched); serve_dvfs on the full
                 llama3.2-1b in bf16 with bf16 pages behind its session's
                 executor (hooks against the engine's calls, exact
                 launches); train_gpt3xl_dvfs ``--full`` (1,418,207,232
                 parameters, 13 steps of 16 x 1024 tokens as 2
                 micro-batches, a failure at step 11 and a restart from the
                 real step-10 checkpoint in a temporary directory: 48 flash
                 forwards and 48 backwards a step, exact), with each
                 checkpoint's bytes and seconds and NVML joules a step read
                 around the steps beside the modeled ones.  Every saved
                 plan round-trips; quickstart's kernel-static plan spends
                 no more energy than its pass-level one at no more time.
   fleet_ssm   — (after consistency_ssm) mamba2-370m, 4 slots,
                 ``paged=True``: the SSM and conv state migrate in the
                 transfers' dense rows; 8 greedy steps give the unmigrated
                 engine's argmax, logits within 1e-5, exact launches.
   serve_gpt3  — gpt3-xl (the paper's GPT-3 1.3B: 24 layers, d_model 2048,
                 16 heads of 128, learned positions, LayerNorm, tanh GELU,
                 vocab 50257) at full width and depth, random weights from
                 a seeded generator, serves the serve phase's 16 requests
                 with bf16 pages (graphs on; the on/off gate's 8 requests
                 graphs on and off: equal tokens), and those 8 prompts
                 with 16 new tokens on int8 pages and on a dense cache
                 (graphs on, each the capturing run), exact launches
                 (24 flash prefills a bucket call, 24 paged decodes a paged
                 step, no RMSNorm), no NaN logit; tokens/s, peak memory,
                 each capture's host ms; a profiled bf16-page run with
                 graphs on, its decode steps alone (the eager profiled
                 run's kernels are the graphs-on run's: cut).
   consistency_gpt3 — ``consistency`` on gpt3-xl with bf16 and int8 pages
                 (each decode step adds ``wpe[pos]``).
   train_gpt3  — gpt3-xl at full width and depth trains 4 steps at the
                 paper's shape, 40 x 1024 tokens a step as 5 micro-batches
                 of 8 (the train phase's settings and gates otherwise:
                 exact launches, 5 x (24 + 24) flash forwards and 5 x 24
                 backwards a step, no RMSNorm).
   dvfs_gpt3   — ``Trainer`` on gpt3-xl at ``paper_gpt3xl`` behind the
                 train executor planned for that shape, over an NVML energy
                 window of at least 5 s, exact launches; then
                 ``launch.train.main --arch gpt3-xl --smoke``.  The model
                 is built once for this phase and the next; each
                 ``Trainer`` draws its own weights from its seed.
   transfer_gpt3 — the accounting and plan-transfer tier on gpt3-xl at
                 ``paper_gpt3xl``: its training step counted at full width
                 and depth on fake tensors (``hw.step_count``:
                 matrix FLOPs, the eager path's HBM bytes, top ops), the
                 analytic workload against the count, the counted FLOPs
                 (the plain eager path's: masked attention scores and
                 remat's recompute included) and the analytic ones over
                 dvfs_gpt3's measured step as TFLOP/s and a share of the
                 bf16 peak; the dp-1 plan on ``h100_like`` with its
                 ``count_calibration`` (gate: recorded) and
                 ``compare_transfer`` to dp 2, dp 4 and tp 2 (modeled;
                 gate: finite rows); then one dp-2 rank trained on
                 the card, 20 x 1024 tokens a step as 5 micro-batches of 4,
                 11 steps behind the transferred dp-2 bundle adopted by a
                 ``DvfsSession`` train executor, with the NVML step meter
                 (``repro_torch.runtime.nvml``) over a window of at least 5
                 s.  Gates: finite losses, the three phases booked, the
                 books' JSON round trip, exact launches (5 x 48 flash
                 forwards and 5 x 24 backwards a step).  Logs joules and
                 seconds a step and a token against the transferred
                 plan's modeled ones and against dvfs_gpt3's window.
   multidevice — gpt3-xl at full width and ``MD_LAYERS`` layers trained as
                 four gloo ranks sharing the card on a (data 2, model 2)
                 mesh (``make_train_step(..., mesh=)``: FSDP over data, 8
                 heads and half of d_ff a rank over model, 4 of 8 rows a
                 rank), spawned with a ``FileStore``: the sharded loss and
                 every gradient block against the unsharded step on the
                 same weights and batch (``MD_LOSS_RTOL``,
                 ``MD_GRAD_TOL``), a step with exact launches a rank (2 L
                 flash forwards with their log-sum-exp, L backwards),
                 step seconds and collective bytes by kind; the MoE
                 all-to-all across the four ranks on CUDA tensors at
                 granite's layer width against the dense combine, and with
                 drops at capacity 2.0; granite-moe-1b-a400m at full width
                 and ``MD_MOE_LAYERS`` layers, one sharded step (16
                 experts a rank) held to the unsharded step with its
                 routing held (``RouteHold``): the loss and the three aux
                 terms (``MD_LOSS_RTOL``), every gradient block
                 (``MD_GRAD_TOL``), pairs dropped, exact launches, the
                 layers' own top-8 choices off the held ones at near ties
                 only (``MD_MOE_TIE``);
                 llama3.2-1b at full width and ``MD_SERVE_LAYERS`` layers
                 served sharded (``ShardedServe``): 8 prompts of 1023
                 prefilled into max_seq 2048 (the cache's sequence over
                 model) and 2 context-parallel decode steps across
                 position 1024, held to the unsharded prefill and decode
                 (logits within ``MD_SERVE_TOL``, argmax equal but at a
                 near tie, exact launches), each call's seconds and
                 collective bytes; then the SSM, hybrid and encoder-decoder
                 families (``MD_FAMILIES``: mamba2-370m at 4 layers,
                 zamba2-7b at 2, seamless-m4t-medium at 2 + 2 with 1024
                 frames) at full width: one sharded bf16 train step each
                 (loss and gradient blocks against the unsharded step,
                 exact launches), a sharded prefill and decode steps in
                 bf16 on the kernels, and (mamba2-370m and seamless) in
                 float32 on the plain path at one layer with a control
                 that breaks the ranks' combine (seamless's: a sequence
                 block's attention partial left out);
                 before them one ``nccl`` rank in the
                 script's process on a (1, 1) mesh runs the bf16 passes
                 against the unsharded runs (on a world of one the
                 collectives return early: their nccl branches over
                 several ranks do not run on one card).
   serve_llama3b — llama3.2-3b (28 layers, d_model 3072, 24 heads over 8
                 at head_dim 128, d_ff 8192, vocab 128256, tied; 3.213 B
                 parameters) at full width and depth serves as serve_gpt3
                 (exact launches: 57 RMSNorms a forward, 28 prefills a
                 bucket call, 28 paged decodes a paged step).
   consistency_llama3b — ``consistency`` on it, bf16 and int8 pages.
   train_llama3b — 4 steps of 8 x 1024 tokens as 4 micro-batches of 2, at
                 ``LLAMA3B_TRAIN_LAYERS`` layers (the train phase's gates).
   serve_moe   — granite-moe-1b-a400m (24 layers, d_model 1024, 16 heads
                 over 8 at head_dim 64, 32 experts of d_ff 512, top-8,
                 vocab 49155; 1.335 B parameters, 0.429 B active) at full
                 width and depth serves as serve_gpt3 (exact launches as
                 llama's at 24 layers; every routed pair kept); then the MoE
                 layer's share of a prefill bucket's and a decode step's
                 device time.
   consistency_moe — ``consistency`` on it, bf16 and int8 pages, the longer
                 prefill held to the decode path's experts and, after each
                 layer but the last, its residual: each layer's output at
                 the decoded token within 5% of the decode path's, the
                 logits within the gate, routing flips only at near-ties
                 (their f32 top-k margins logged); the prefill held to the
                 experts alone and the unheld prefill logged beside (at full
                 depth they part by more than the gate: bf16 rounding adds
                 up over granite's 24 random layers).
   train_moe   — 4 steps of 8 x 1024 tokens as 2 micro-batches of 4
                 (capacity 1280 a layer and expert), the load balance,
                 router z-loss and dropped fraction logged each step, a
                 non-zero gradient on every leaf, the router's included.
   serve_vlm   — internvl2-1b (24 layers, d_model 896, 14 heads over 2 at
                 head_dim 64, vocab 151655, tied; 0.494 B parameters) at
                 full width and depth serves the serve phase's 16 prompts,
                 the even ones behind 256 seeded patch rows of width 896,
                 the odd ones text-only (a prefill call per bucket and
                 extras signature), as serve_gpt3 (exact launches as
                 llama's at 24 layers); the unaligned head's share of a
                 decode step logged.
   consistency_vlm — ``consistency`` behind the same 256 patch rows in
                 both prefills, bf16 and int8 pages.
   train_vlm   — 4 steps of 8 rows (256 patch rows + 768 text tokens) as
                 2 micro-batches of 4 (the train phase's gates).
   serve_yi    — yi-34b (d_model 7168, 56 heads over 8 at head_dim 128,
                 d_ff 20480, vocab 64000; 34.389 B parameters at its 60
                 layers, drawn a layer at a time for its MLP leaves) at full
                 width and 30 layers (``YI_SERVE_LAYERS``: the script's time
                 limit) serves 8 prompts of 65-128 tokens (one bucket: each
                 engine captures that bucket's prefill graph and the decode
                 chunks'), 32 new each, as serve_gpt3 (exact launches: 61
                 RMSNorms a forward, 30 prefills a call, 30 paged decodes a
                 step); peak memory; the profiled decode step's wall and
                 device ms against the time of reading the weights once.
   consistency_yi — ``consistency`` on it, bf16 and int8 pages.
   serve_encdec — seamless-m4t-medium (12 encoder and 12 decoder layers,
                 d_model 1024, 16 heads over 16 at head_dim 64, d_ff 4096,
                 vocab 256206 untied; 0.920 B parameters) at full width and
                 depth serves the serve phase's 16 prompts, each request
                 with its own 1024 seeded frames of width 1024, as
                 serve_gpt3 (exact launches: 36 flash prefills a prefill
                 call, 12 encoder, 12 self, 12 cross; 12 paged decodes a
                 paged step; no RMSNorm); the unaligned head's share of the
                 profiled decode step, and the plain cross-attention
                 decode's (its 12 calls replayed from a graph, computed).
   consistency_encdec — ``consistency`` with the same frames in both
                 prefills, bf16 and int8 pages.
   train_encdec — 4 steps of 8 rows (1024 frames and 512 text tokens) as 2
                 micro-batches of 4 (the train phase's gates; 2 x 72 flash
                 forwards and 2 x 36 backwards a step, non-causal and at
                 Sq != Sk in the encoder and the cross-attention).
   serve_ssm   — mamba2-370m at full width and depth (random weights from a
                 seeded generator) serves the same 16 requests with a dense
                 and with a paged ``BatchState``, graphs on (the dense
                 state's on/off gate's 8 requests graphs off too):
                 identical greedy tokens, exact launch counts (SSD scan per
                 layer and prefill call, RMSNorm twice per layer and once
                 more per forward, no attention kernel), no NaN logit; then
                 the bucket-512 prefill of 8 rows timed as one
                 ``model.prefill`` call and through the engine's memoized
                 prefill entry (graphs on and off: equal first tokens), and
                 a short profiled run with graphs on.
   consistency_ssm — prefill of 300 positions (two chunks, the last ragged)
                 + decode steps against one longer prefill.
6. train       — llama3.2-1b at full width and depth trains 4 steps through
                 ``make_train_step`` (f32 masters, bf16 compute, AdamW,
                 remat, seq 1024, global batch 8 as 2 micro-batches of 4)
                 on the port's ``DataPipeline``; asserts finite losses,
                 a finite non-zero gradient for every parameter leaf after
                 the first backward, and exact launch counts per step.
7. trainer     — ``Trainer.run()`` at a small width (2 layers, d_model
                 256, bf16, head_dim 64) with an injected failure: it must
                 restart from its checkpoint and finish.
8. serve_hybrid — zamba2-7b at full width and depth (81 Mamba2 blocks, the
                 shared attention block 14 times; random weights from a
                 seeded generator, built after the other models are freed)
                 serves 8 requests of 24-498 prompt tokens, 32 new tokens
                 each, with bf16 pages (graphs on; the on/off gate's
                 requests graphs on and off), and those prompts with 16
                 new tokens on int8 pages (graphs on) and on a dense cache
                 (graphs on and off): equal tokens with graphs on and off on bf16 pages
                 and on the dense cache, exact launch counts
                 (191
                 RMSNorms a forward, 81 SSD scans and 14 prefill attentions
                 a prefill call, 14 paged decodes a paged step), no NaN
                 logit; tokens/s, peak memory, the graph pool; the int8
                 and dense runs' agreement with bf16 pages is logged; a
                 short profiled run with graphs on, the decode steps alone.
   consistency_hybrid — the prefill of 300 positions and decode steps on a
                 dense cache and on bf16 pages, each against one longer
                 prefill.
9. ssd_grads   — the SSD scan's autograd Function (kernel forward, plain
                 f32 backward): gradients of x, a, B, C and h0 against plain
                 autograd on the same bf16 inputs at N 128, G 1 and N 64,
                 G 2 over a ragged last chunk with an initial state; then
                 the forward kernel and the plain backward timed at each
                 training phase's shape.
   train_ssm   — mamba2-370m at full width and depth (48 layers) trains as
                 the train phase does (same settings and gates; exact
                 RMSNorm and SSD launches a step); step ms, tokens/s, peak
                 memory, a profiled step's idle share and top kernels, and
                 the plain SSD backward's share of a step (computed from
                 its timed calls).
   train_hybrid — zamba2-7b at full width with 15 of its 81 layers (two
                 groups of 6, the 3-block tail, the shared block 3 times:
                 its full-depth f32 training state would not fit the card)
                 trains the same way, with exact RMSNorm, SSD, flash
                 forward and head_dim-224 flash backward launches a step.
   serve_llama4 — (after train_hybrid) llama4-scout-17b-a16e at full width
                 and 8 of its 48 layers (two groups of 3 local layers at
                 window 8192 and a global one; 16 experts, top-1, the
                 shared expert; 19.69 B parameters, 39.37 GB in bf16)
                 serves as serve_gpt3 (exact launches: 17 RMSNorms a
                 forward, 8 flash prefills a call, 2 paged decodes a paged
                 step; the rings stay dense); the plain ring decode's share
                 of the profiled decode step (its 6 layers' calls replayed
                 from a graph, computed), the MoE layers' share of a
                 prefill bucket and a decode step, the weight-read floor of
                 a decode step.
   serve_llama4_long — 4 slots of 16384 positions, prompts of 8160, 9000,
                 10500 and 12000 tokens in the buckets 8192 and 16384 (two
                 prefill calls; rings of 8192 that wrap in prefill and, for
                 the first row, in decode), 64 new
                 each, bf16 pages, graphs on and off: equal tokens, exact
                 launches.
   consistency_llama4 — ``consistency`` on bf16 and int8 pages held layer
                 by layer (``HeldPath``), and on bf16 pages at max_seq
                 16384 with a row whose decode crosses position 8192; then
                 (the bf16 model freed) in float32 on the plain path at one
                 group of 4 layers, its experts held.
   train_llama4_smoke — the card smoke config (window 32, a global layer
                 every 2nd) trained as the train phase (the backward with
                 its window, exact launches), then ``launch.train --arch
                 llama4-scout-17b-a16e --smoke`` and ``launch.serve ...
                 --smoke``.
   serve_nemotron — nemotron-4-340b at full width and 4 of its 96 layers
                 (23.25 B parameters, 46.51 GB in bf16; wte and head drawn
                 in row blocks) serves as serve_gpt3 (no RMSNorm, 4
                 prefills a call, 4 paged decodes a paged step), its decode
                 step against its weight-read floor; consistency_nemotron
                 on bf16 and int8 pages; train_nemotron_smoke its card
                 smoke config and both launchers with ``--smoke``.
10. dvfs       — (run right after consistency, while the serve phase's
                 llama3.2-1b is loaded) the DVFS stack on the card, with NVML
                 read by ``ctypes`` (``repro_torch.runtime.nvml``,
                 ``libnvidia-ml.so.1``; a missing library,
                 function or energy counter fails the phase, a counter that
                 decreases too): the card's supported memory and graphics
                 clocks, every ``h100_grid()`` pair among them, idle watts over
                 2 s; ``launch.serve.main`` with ``--smoke`` (h100 chip
                 model, 8 slots, 16 requests): finite plan rows and executed
                 totals, one prefill hook a request and one decode hook a
                 step, ``check_executor`` clean, exact launches of paged
                 decode, the prefill and RMSNorm (the reduced
                 config at the kernels' widths, paged decode at a query
                 group of 2); ``launch.serve.main --arch
                 granite-moe-1b-a400m`` with ``--smoke`` and at full width
                 with 2 requests, ``--arch internvl2-1b --smoke`` (text-only
                 requests, as the reference's launcher builds them); the
                 serve phase's 16 requests behind a
                 ``DvfsSession(chip="h100")`` executor, repeated for at least 5
                 s after a capturing run, against the energy counter (joules a
                 token and mean watts, gross and net of idle, the SM and memory
                 clocks seen, beside the executor's modeled auto and planned
                 energy and time); ``Trainer`` on llama3.2-1b at full width
                 (the train phase's settings, 20 steps, the window steps 1..19,
                 at least 5 s) behind the train executor planned for that
                 shape, with an NVML energy meter read each step: finite
                 losses, every phase booked, the executor's books through their
                 checkpoint JSON into a fresh executor equal; joules and
                 seconds a step against the modeled ones; then
                 ``launch.train.main --smoke`` (the reduced config at the
                 kernels' widths) for 2 steps into a temporary directory.
                 Nothing sets a clock: the card runs at its own.

Each phase's seconds are logged (``[time]``).

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from repro_torch.hw import h100  # noqa: E402
from repro_torch.runtime.nvml import Nvml, NvmlStepMeter  # noqa: E402

# peak rates of one H100 SXM (data sheet, dense; ``repro_torch.hw.h100``):
# memory bytes/s and ops/s
HBM_BYTES_PER_S = h100.HBM_BW
PEAK_OPS = {"bf16": h100.PEAK_FLOPS_BF16, "f32": h100.PEAK_FLOPS_F32}
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_PAGE = 8, 1024, 16
SERVE_REQUESTS, SERVE_NEW_TOKENS = 16, 64
# zamba2-7b, the hybrid: 8 seeded requests of 24-498 prompt tokens, 32 new
# tokens each; its shared attention block's heads, KV heads and head_dim;
# its SSD scan's heads, groups and state
HYBRID_REQUESTS, HYBRID_NEW_TOKENS = 8, 32
HYBRID_ATTN = dict(H=32, KV=32, D=224)
HYBRID_SSD = dict(H=112, G=2, N=64)
# training: seq 1024, global batch 8 as accum 2 micro-batches of 4, 4 steps
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 1024, 8, 2, 4
TRAIN_H, TRAIN_KV, TRAIN_D = 32, 8, 64
# zamba2-7b trains at full width with its depth cut to 15 of 81 layers (two
# groups of 6, the 3-block tail, the shared block applied 3 times): at 81
# layers its f32 masters, gradients and AdamW moments (16 bytes a
# parameter, 6.917 B parameters) would need ~111 GB, more than the card's
# 80 GB; at 15, 1.74 B parameters, ~28 GB (~35 GB with a micro-batch's f32
# gradients beside the accumulated ones)
HYBRID_TRAIN_LAYERS = 15
# gpt3-xl, the paper's GPT-3 1.3B: its attention's heads, KV heads and
# head_dim (MHA: one query head per KV head); it trains at the paper's
# shape (configs/shapes.py:PAPER_GPT3XL), 40 x 1024 tokens a step, as 5
# micro-batches of 8, and its DVFS window runs this many Trainer steps
# (step 0 outside the window; at more than a second a step the rest last
# longer than DVFS_WINDOW_S)
GPT3_ATTN = dict(H=16, KV=16, D=128)
GPT3_BATCH, GPT3_ACCUM, GPT3_DVFS_STEPS = 40, 5, 6
# the transfer phase: gpt3-xl's plan at paper_gpt3xl moved to these meshes
# (at the paper's 0.6% time budget); one data-parallel rank of the dp-2 mesh
# trains GPT3_BATCH // 2 rows a step as GPT3_ACCUM micro-batches of 4, for
# GPT3_RANK_STEPS Trainer steps (step 0 outside the window; at ~0.6 s a step
# the rest last longer than DVFS_WINDOW_S)
TRANSFER_TAU, TRANSFER_MESHES = 0.006, ("dp2", "dp4", "tp2")
GPT3_RANK_DP, GPT3_RANK_STEPS = 2, 11
# llama3.2-3b: its attention's heads, KV heads and head_dim (3 query heads
# per KV head); it trains 8 x 1024 tokens a step as LLAMA3B_ACCUM
# micro-batches of 2 at full width with its depth cut to
# LLAMA3B_TRAIN_LAYERS of 28 layers.  Its f32 masters, gradients and two
# AdamW moments are 16 bytes a parameter and a micro-batch's f32 gradients
# beside the accumulated ones 4 more: 64.3 GB at 28 layers (3.213 B
# parameters), 56.2 GB at 24 (2.810 B), computed; AdamW's f32 temporaries
# over the largest stacked leaf (w_gate, 0.70 B values at 28 layers: 2.8
# GB each) come on top.  At 28 layers the fourth step ran out of an H100
# 80GB's 79.2 GiB (68.1 GiB allocated, 8.9 reserved but unallocated)
LLAMA3B_ATTN = dict(H=24, KV=8, D=128)
LLAMA3B_ACCUM, LLAMA3B_TRAIN_LAYERS = 4, 24
# granite-moe-1b-a400m trains 8 x 1024 tokens a step as MOE_ACCUM
# micro-batches of 4 (4096 tokens, 32768 routed pairs a layer)
MOE_ACCUM = 2
# internvl2-1b: its attention's heads, KV heads and head_dim (7 query heads
# per KV head) and the patch rows a request or a training row carries
# (its vision_prefix_len, each row of width d_model 896); it trains 8 rows
# a step as TRAIN_ACCUM micro-batches of 4, each row the patch rows and
# TRAIN_SEQ - VLM_PREFIX text tokens
VLM_ARCH, VLM_PREFIX = "internvl2-1b", 256
VLM_ATTN = dict(H=14, KV=2, D=64)
# yi-34b: its attention's heads, KV heads and head_dim (7 query heads per
# KV head).  It serves YI_REQUESTS seeded prompts of 65-128 tokens, one
# prompt bucket (128), YI_NEW_TOKENS new each, at full width and
# YI_SERVE_LAYERS of its 60 layers: at full depth the phase took 73-86 s
# on an H100, and with llama4-scout's and nemotron-4-340b's phases the
# script came within ~190 s of its 1200 s limit; half the depth halves
# the phase (34.4 GB of bf16 weights, computed).  A prefill bucket's CUDA graph holds its
# sub-cache (a layer's 8 rows x 1024 positions x 240 KiB of K/V a token,
# computed) as a static output, so the workload captures one prefill
# graph and the decode chunks' graphs
YI_ARCH = "yi-34b"
YI_ATTN = dict(H=56, KV=8, D=128)
YI_REQUESTS, YI_NEW_TOKENS, YI_SERVE_LAYERS = 8, 32, 30
# seamless-m4t-medium, the encoder-decoder: its attention's heads, KV heads
# and head_dim (one query head per KV head, in the encoder, the decoder and
# the cross-attention alike), the frames each request or training row
# carries (its encoder_frontend_len, each frame of width d_model 1024) and
# the text tokens of a training row
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_ATTN = dict(H=16, KV=16, D=64)
ENCDEC_FRAMES, ENCDEC_TEXT = 1024, 512
# llama4-scout-17b-a16e at full width: 40 query heads over 8 at head_dim
# 128 (5 per KV head); 3 local layers (window 8192) and a global one a
# group of 4.  Served at 8 of its 48 layers (two groups: 19.69 B
# parameters, 39.37 GB in bf16, computed; 48 layers would be 215.5 GB); its
# float32 end-to-end gate at one group (4 layers, 43.5 GB in float32).  The
# long traffic: 4 slots of 16384 positions, 4 seeded prompts of these
# lengths (the engine's buckets 8192 and 16384; rows past the window of
# 8192, three wrap their rings in prefill), 64 new tokens each.  The card
# smoke config's local attention (trained by its --smoke launcher): 4
# query heads over 2 at head_dim 64, window 32
LLAMA4_ARCH = "llama4-scout-17b-a16e"
LLAMA4_ATTN = dict(H=40, KV=8, D=128)
LLAMA4_SERVE_LAYERS, LLAMA4_F32_LAYERS = 8, 4
LONG_SLOTS, LONG_MAX_SEQ, LONG_NEW = 4, 16384, 64
LONG_PROMPTS = (8160, 9000, 10500, 12000)
SMOKE_LOCAL = dict(H=4, KV=2, D=64, window=32)
# nemotron-4-340b at full width: 96 query heads over 8 at head_dim 192 (12
# per KV head), LayerNorm, squared-ReLU MLP; served at 4 of its 96 layers
# (23.25 B parameters, 46.51 GB in bf16, computed; its wte and head are
# each 4.7e9 values, drawn in row blocks)
NEMO_ARCH = "nemotron-4-340b"
NEMO_ATTN = dict(H=96, KV=8, D=192)
NEMO_SERVE_LAYERS = 4
LSE_TOL = 1e-3         # forward log-sum-exp, absolute
BWD_TOL = 2e-2         # dq, dk, dv, relative to each one's largest |value|
ATTN_TOL = 2e-2        # bf16 attention, as tests/test_kernels.py uses
RMS_RTOL = 1e-2        # RMSNorm, relative (one bf16 ulp is 2**-8)
CONSISTENCY_TOL = 5e-2  # prefill vs decode logits, relative to max |logit|
# an MoE routing flip between the decode path and a longer prefill is a
# near-tie only below this f32 gap between a token's K-th and (K+1)-th
# router probability (the bf16 rounding that parts the two paths moves a
# probability by ~1e-4 at granite's near-uniform random routing)
ROUTE_FLIP_MARGIN = 2e-3
# SSD scan: y relative to its largest |value| (a bf16 output, one ulp 2**-8);
# the final state relative to its largest |value| (f32 on both sides, only
# the order of the sums differs)
SSD_Y_TOL, SSD_H_TOL = 2e-2, 1e-3
# SSD gradients through the autograd Function (kernel forward, plain f32
# backward) against plain autograd on the same bf16 inputs, relative to each
# one's largest |value|: the backward is the same f32 recompute either way
SSD_GRAD_TOL = 1e-3
SSD_CHUNK = 256
# a timing loop cycles over copies of its inputs that together hold this many
# bytes, 5x the H100's 50 MB L2, so each call reads device memory as the
# bytes bound assumes
COLD_BYTES = 256 << 20
# a timing loop of tiny calls holds at most this many input copies (the
# decode shape's 8 rows stay in L2, as they do in a decode step) and queues
# at most this many calls behind its sleep kernel, well inside the launch
# queue, which would otherwise block the host until the device drains it
MAX_COPIES, MAX_QUEUED = 256, 512
# the dvfs phase: each NVML energy window lasts at least this long (the
# counter updates coarsely), and the training window's Trainer runs this
# many steps (step 0 outside the window)
DVFS_WINDOW_S, DVFS_TRAIN_STEPS = 5.0, 20


_START = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` on its own line, after the seconds since the script began."""
    print(f"[{time.perf_counter() - _START:6.1f} s] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` calls, CUDA events around the
    loop: the device's time where it is the longer, else the host's time
    to issue the calls (Python, checks and launch), as a caller sees it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the sleep kernel that holds the stream while a timing loop is enqueued
# counts cycles; 2e9 a second is above the H100's boost clock, so a sleep
# asked for t seconds lasts at least t
SLEEP_CYCLES_PER_S = 2e9


def time_device_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms, host ms) per call of ``fn``, beside ``time_ms``.  At
    most ``MAX_QUEUED`` calls are enqueued behind a sleep kernel that lasts
    longer than their enqueueing, so the events time the device running
    them back to back without the host's share; the host ms is that
    enqueueing time.  If the sleep ran out first (the start event fired
    before the last call was queued), the loop reruns with twice the sleep
    and half the calls (a call of many kernels fills the launch queue,
    which blocks the host until the sleep ends); after six tries it raises
    (``fn`` synchronises)."""
    iters = min(iters, MAX_QUEUED)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    guess = 2.0 * iters * (time.perf_counter() - t0) + 1e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(6):
        torch.cuda._sleep(int(min(guess, 2.0) * SLEEP_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        held = not start.query()
        end.record()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / iters, 1e3 * host / iters
        guess *= 2
        iters = max(1, iters // 2)
    raise RuntimeError(f"time_device_ms: the sleep kernel never held the "
                       f"stream, down to {iters} calls enqueued")


def time_graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Per-call ms of ``calls`` calls of ``fn`` captured in one CUDA graph
    and replayed ``replays`` times, CUDA events around the replays: how the
    serving engine now launches its kernels, with no host in the loop.  The
    capture's launch counts are taken back out."""
    from repro_torch import kernels
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    after = kernels.launch_counts()
    kernels.add_launch_counts({k: before[k] - after[k] for k in after})
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def graph_equal(fn) -> bool:
    """Whether ``fn()`` replayed from a captured CUDA graph gives bitwise
    the output of an eager call (a tensor or a tuple of them)."""
    from repro_torch import kernels

    def tensors(out):
        return out if isinstance(out, tuple) else (out,)
    eager = [t.clone() for t in tensors(fn())]
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = tensors(fn())
    after = kernels.launch_counts()
    kernels.add_launch_counts({k: before[k] - after[k] for k in after})
    for t in static:
        t.fill_(0)                  # nothing left over from the capture
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(eager, static))


def release() -> None:
    """Free what dropped engines held: an engine and its memoized graphs
    reference each other (a graph's body is a bound method of the engine),
    so its graphs' pool and static outputs go only when the cycle is
    collected."""
    gc.collect()
    torch.cuda.empty_cache()


def cycled(fn, cases):
    """A call of ``fn`` on the next argument tuple of ``cases`` each time."""
    it = itertools.cycle(cases)
    return lambda: fn(*next(it))


def n_copies(nbytes: int) -> int:
    """Copies of ``nbytes`` of inputs that fill ``COLD_BYTES``."""
    return max(2, math.ceil(COLD_BYTES / nbytes))


def bound(nbytes: float, ops: float, rate: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[rate]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


# ---------------------------------------------------------------------------
# 1. device, 2. build
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}: "
        f"{torch.cuda.get_device_name(0)}")
    log(f"[device] nvidia-smi: {smi}")
    return smi


# kernels whose products run on the tensor cores: their SASS must hold
# HMMA (mma.sync) or HGMMA (wgmma) instructions
TENSOR_CORE_KERNELS = ("flash_prefill_kernel", "flash_prefill_wide_kernel",
                       "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                       "ssd_scan_states_kernel", "ssd_scan_output_kernel")
# zamba2-7b's instantiations, by the start of their mangled names, and
# whether their products must run on the tensor cores
HYBRID_INSTANTIATIONS = (
    ("_Z14rmsnorm_kernelILi14E", False), ("_Z14rmsnorm_kernelILi28E", False),
    ("_Z22ssd_scan_states_kernelILi64ELi64E", True),
    ("_Z21ssd_scan_carry_kernelILi64ELi64E", False),
    ("_Z22ssd_scan_output_kernelILi64ELi64ELi2E", True),
    ("_Z25flash_prefill_wide_kernelILi224E", True),
    ("_Z19paged_decode_kernelI13__nv_bfloat16Li224ELi1E", False),
    ("_Z19paged_decode_kernelIaLi224ELi1E", False),
    ("_Z27paged_decode_combine_kernelI13__nv_bfloat16Li224ELi1E", False),
    ("_Z21flash_bwd_prep_kernelILi224E", False),
    ("_Z24flash_bwd_dq_wide_kernelILi224E", True),
    ("_Z25flash_bwd_dkv_wide_kernelILi224E", True))
# gpt3-xl's instantiations (head_dim 128, one query head per KV head), as
# zamba2-7b's above
GPT3_INSTANTIATIONS = (
    ("_Z25flash_prefill_wide_kernelILi128E", True),
    ("_Z19paged_decode_kernelI13__nv_bfloat16Li128ELi1E", False),
    ("_Z19paged_decode_kernelIaLi128ELi1E", False),
    ("_Z27paged_decode_combine_kernelI13__nv_bfloat16Li128ELi1E", False),
    ("_Z21flash_bwd_prep_kernelILi128E", False),
    ("_Z24flash_bwd_dq_wide_kernelILi128E", True),
    ("_Z25flash_bwd_dkv_wide_kernelILi128E", True))
# llama3.2-3b's own instantiations (RMSNorm at d 3072; paged decode at
# head_dim 128 with 3 query heads per KV head: a lane holds 3 query rows);
# its prefill and backward are gpt3-xl's wide kernels at head_dim 128.  A
# spill is logged, not refused
LLAMA3B_INSTANTIATIONS = (
    ("_Z14rmsnorm_kernelILi12E", False),
    ("_Z19paged_decode_kernelI13__nv_bfloat16Li128ELi3E", False),
    ("_Z19paged_decode_kernelIaLi128ELi3E", False),
    ("_Z27paged_decode_combine_kernelI13__nv_bfloat16Li128ELi3E", False))
# internvl2-1b's own instantiations (RMSNorm at d 896, its last chunk on
# 16 lanes; paged decode at head_dim 64 with 7 query heads per KV head);
# its prefill and backward are the head_dim-64 kernels.  yi-34b's: paged
# decode at head_dim 128 with 7 (its prefill is the wide kernel at 128, its
# RMSNorm d 7168's).  A spill is logged, not refused
VLM_INSTANTIATIONS = (
    ("_Z14rmsnorm_kernelILi4ELi16E", False),
    ("_Z19paged_decode_kernelI13__nv_bfloat16Li64ELi7E", False),
    ("_Z19paged_decode_kernelIaLi64ELi7E", False),
    ("_Z27paged_decode_combine_kernelI13__nv_bfloat16Li64ELi7E", False))
YI_INSTANTIATIONS = (
    ("_Z19paged_decode_kernelI13__nv_bfloat16Li128ELi7E", False),
    ("_Z19paged_decode_kernelIaLi128ELi7E", False),
    ("_Z27paged_decode_combine_kernelI13__nv_bfloat16Li128ELi7E", False))
# seamless-m4t-medium's: paged decode at head_dim 64 with one query head
# per KV head, and the head_dim-64 prefill and backward, which it runs
# without the causal mask and at Sq != Sk.  A spill is logged, not refused
ENCDEC_INSTANTIATIONS = (
    ("_Z19paged_decode_kernelI13__nv_bfloat16Li64ELi1E", False),
    ("_Z19paged_decode_kernelIaLi64ELi1E", False),
    ("_Z27paged_decode_combine_kernelI13__nv_bfloat16Li64ELi1E", False),
    ("_Z20flash_prefill_kernelILi64E", True),
    ("_Z19flash_bwd_dq_kernelILi64E", True),
    ("_Z20flash_bwd_dkv_kernelILi64E", True))
# llama4-scout's: RMSNorm at d 5120, paged decode at (128, 5) (its global
# layers; the flash forward at 128 is gpt3-xl's instantiation), and the
# head_dim-64 backward its card smoke config trains with a window
LLAMA4_INSTANTIATIONS = (
    ("_Z14rmsnorm_kernelILi20E", False),
    ("_Z19paged_decode_kernelI13__nv_bfloat16Li128ELi5E", False),
    ("_Z19paged_decode_kernelIaLi128ELi5E", False),
    ("_Z27paged_decode_combine_kernelI13__nv_bfloat16Li128ELi5E", False),
    ("_Z19flash_bwd_dq_kernelILi64E", True),
    ("_Z20flash_bwd_dkv_kernelILi64E", True))
# nemotron-4-340b's: the wide prefill at head_dim 192, and paged decode at
# (192, 12) as 3 blocks of 4 query rows a KV head (the kernel's template
# arguments: 4 rows a block, 3 blocks); a spill is logged, not refused
NEMO_INSTANTIATIONS = (
    ("_Z25flash_prefill_wide_kernelILi192E", True),
    ("_Z19paged_decode_kernelI13__nv_bfloat16Li192ELi4ELi3E", False),
    ("_Z19paged_decode_kernelIaLi192ELi4ELi3E", False),
    ("_Z27paged_decode_combine_kernelI13__nv_bfloat16Li192ELi4E", False))
# paged decode at head_dim 64 with 2 query heads per KV head (the card
# smoke config's and granite-moe's attention): the instantiations of the
# serving pools (bf16, int8) and the combine pass may not spill; the f32
# and fp8 ones, off the serving path, are logged
GROUP2_INSTANTIATIONS = ("_Z19paged_decode_kernelI13__nv_bfloat16Li64ELi2E",
                         "_Z19paged_decode_kernelIaLi64ELi2E",
                         "_Z27paged_decode_combine_kernelI13__nv_bfloat16"
                         "Li64ELi2E")


def sass_mma_counts(path: str) -> dict:
    """HMMA/HGMMA instructions in the SASS of each function of the built
    library, by ``cuobjdump -sass`` (the toolkit's, beside ``nvcc``)."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool}): "
                           f"cannot show that the products run on the "
                           f"tensor cores")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def ptxas_resources(compiler_log: str) -> dict:
    """{mangled entry function: (registers, spill store bytes, spill load
    bytes)} from ``ptxas -v``'s report in the build log."""
    found, fn = {}, None
    for line in compiler_log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            found[fn] = [0, 0, 0]
        elif fn is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            found[fn][1] = int(words[words.index("spill") - 2])
            found[fn][2] = int(words[words.index("loads") - 3])
        elif fn is not None and "Used" in line and "registers" in line:
            words = line.split()
            found[fn][0] = int(words[words.index("registers,") - 1])
    return {k: tuple(v) for k, v in found.items()}


def phase_build() -> None:
    from repro_torch.kernels import _build
    info = _build.build_info()
    log(f"[build] {info['path']} in {info['seconds']:.2f} s")
    for line in str(info["compiler_log"]).splitlines():
        if "Compiling entry function" in line:
            log(f"[build]   {line.split(chr(39))[1][:72]}")
        elif "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build]   {line.strip()}")
    counts = sass_mma_counts(info["path"])
    for name in TENSOR_CORE_KERNELS:
        found = {fn: n for fn, n in counts.items() if name in fn}
        n = sum(found.values())
        log(f"[build] {name}: {n} HMMA/HGMMA instructions in its SASS "
            f"({len(found)} instantiation(s))")
        if not found or n == 0:
            raise AssertionError(f"{name}: no tensor-core instruction in the "
                                 f"SASS of {info['path']}")
    # the hybrid's, gpt3-xl's, llama3.2-3b's, internvl2-1b's, yi-34b's and
    # seamless-m4t-medium's instantiations: each built, its registers and
    # spills, and HMMA in the SASS of those that run products
    res = ptxas_resources(str(info["compiler_log"]))
    for model, table in (("zamba2-7b", HYBRID_INSTANTIATIONS),
                         ("gpt3-xl", GPT3_INSTANTIATIONS),
                         ("llama3.2-3b", LLAMA3B_INSTANTIATIONS),
                         (VLM_ARCH, VLM_INSTANTIATIONS),
                         (YI_ARCH, YI_INSTANTIATIONS),
                         (ENCDEC_ARCH, ENCDEC_INSTANTIATIONS),
                         (LLAMA4_ARCH, LLAMA4_INSTANTIATIONS),
                         (NEMO_ARCH, NEMO_INSTANTIATIONS)):
        for prefix, products in table:
            fns = [fn for fn in res if fn.startswith(prefix)]
            if not fns:
                raise AssertionError(f"{prefix}: not in the build")
            regs, st, ld = res[fns[0]]
            hmma = sum(n for fn, n in counts.items() if fn.startswith(prefix))
            log(f"[build] {model} {prefix}: {regs} registers, spill stores "
                f"{st} bytes, spill loads {ld} bytes; {hmma} HMMA/HGMMA "
                f"instructions")
            if products and hmma == 0:
                raise AssertionError(f"{prefix}: no tensor-core instruction "
                                     f"in its SASS")
    for fn in sorted(f for f in res if "paged_decode" in f
                     and "Li64ELi2E" in f):
        regs, st, ld = res[fn]
        log(f"[build] paged_decode D64 G2 {fn[:64]}: {regs} registers, "
            f"spill stores {st} bytes, spill loads {ld} bytes")
    for prefix in GROUP2_INSTANTIATIONS:
        fns = [fn for fn in res if fn.startswith(prefix)]
        if not fns:
            raise AssertionError(f"{prefix}: not in the build")
        if res[fns[0]][1] or res[fns[0]][2]:
            raise AssertionError(f"{prefix}: spills {res[fns[0]][1:]} "
                                 f"bytes (stores, loads)")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _library_sdpa(q, k, v, mask):
    """One PyTorch call over (B, H|KV, S, D) views (the yardstick)."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


#: how the rows' times were taken (their "timing" key)
TIMING = ("ms, plain_ms, library_ms with the host in the loop (CUDA events "
          "around the calls); device_ms, library_device_ms with the calls "
          "queued behind a sleep kernel")
#: how the rows with graph times took them
GRAPH_TIMING = ("graph_ms, library_graph_ms: the calls captured in one CUDA "
                "graph and replayed, as the serving engine launches them")


def versus(name, t, lib_name):
    """A log fragment: a kernel's times beside a library call's, both with
    the host in the loop (the rows' ms) and as device time."""
    graph = "" if "graph_ms" not in t else (
        f"; replayed from a CUDA graph {t['graph_ms']:.4f} ms against "
        f"{t['library_graph_ms']:.4f} ms "
        f"({t['graph_ms'] / t['library_graph_ms']:.2f}x)")
    return (f"{name} {t['ms']:.4f} ms, {lib_name} {t['library_ms']:.4f} ms "
            f"({t['ms'] / t['library_ms']:.2f}x) with the host in the loop; "
            f"device time {t['device_ms']:.4f} ms against "
            f"{t['library_device_ms']:.4f} ms "
            f"({t['device_ms'] / t['library_device_ms']:.2f}x){graph}; "
            f"{t['host_ms'] * 1e3:.1f} us of host time a call")


def both_times(kernel, library, iters: int, graph: bool = False) -> dict:
    """The times of a kernel's and a library call's loops: ``ms`` and
    ``library_ms`` with the host in the loop (``time_ms``), ``device_ms``
    and ``library_device_ms`` queued behind a sleep kernel, the kernel's
    ``host_ms`` a call, and with ``graph`` also ``graph_ms`` and
    ``library_graph_ms`` (``time_graph_ms`` over ``iters`` calls)."""
    t = {"ms": time_ms(kernel, iters), "library_ms": time_ms(library, iters)}
    t["device_ms"], t["host_ms"] = time_device_ms(kernel, iters)
    t["library_device_ms"] = time_device_ms(library, iters)[0]
    if graph:
        t["graph_ms"] = time_graph_ms(kernel, iters)
        t["library_graph_ms"] = time_graph_ms(library, iters)
    return t


def rmsnorm_timings(gen, rows: int, d: int):
    """``both_times`` of the RMSNorm wrapper against ``F.rms_norm`` at
    (rows, d) bf16 with an f32 scale, each cycling over input copies larger
    than L2, at most ``MAX_COPIES`` of them (public wrappers only, so that
    another tree's kernels can be timed the same way); and the inputs."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    n = min(n_copies(rows * d * 2), MAX_COPIES)
    xs = [torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
          for _ in range(n)]
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    wb = w.to(torch.bfloat16)
    t = both_times(cycled(lambda x: rmsnorm(x, w), [(x,) for x in xs]),
                   cycled(lambda x: F.rms_norm(x, (d,), wb, 1e-5),
                          [(x,) for x in xs]),
                   min(max(4 * n, 64), MAX_QUEUED), graph=True)
    return t, (xs, w, n)


def _rmsnorm_compare(gen, rows: int, d: int):
    """The kernel against its plain version at (rows, d); logs and returns
    (ok, max_abs_err)."""
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    ref = rmsnorm_ref(x, w).float()
    err = (rmsnorm(x, w).float() - ref).abs()
    ok = bool((err <= RMS_RTOL * ref.abs() + 1e-6).all())
    log(f"[kernels] rmsnorm x ({rows}, {d}) bf16: max_abs_err "
        f"{float(err.max()):.3e} (rtol {RMS_RTOL}) ok={ok}")
    return ok, float(err.max())


def _rmsnorm_row(gen, rows: int, d: int, name: str = "rmsnorm"):
    """The kernel at (rows, d) against its plain version and twice (bitwise
    equal), timed beside ``F.rms_norm`` (``rmsnorm_timings``, graph_ms
    too) and its bound; logs and returns (its JSON row, ok)."""
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    t, (xs, w, n) = rmsnorm_timings(gen, rows, d)
    x = xs[0]
    got, ref = rmsnorm(x, w), rmsnorm_ref(x, w)
    same = torch.equal(got, rmsnorm(x, w))
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= RMS_RTOL * ref.float().abs() + 1e-6).all()) and same
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
           "replaces": "src/repro/kernels/rmsnorm/kernel.py:30",
           "shape": f"x ({rows}, {d}) bf16",
           "timing": f"cold L2: cycles over {n} input copies; {TIMING}; "
                     f"{GRAPH_TIMING}",
           "max_abs_err": float(err.max()), "tol": f"rtol {RMS_RTOL}",
           "ms": t["ms"], "device_ms": t["device_ms"],
           "graph_ms": t["graph_ms"],
           "library_graph_ms": t["library_graph_ms"],
           "plain_ms": time_ms(cycled(lambda x: rmsnorm_ref(x, w),
                                      [(x,) for x in xs]), iters=n),
           "library_ms": t["library_ms"],
           "library_device_ms": t["library_device_ms"]}
    row["bound_ms"], row["bound_by"] = bound(
        2 * rows * d * 2 + d * 4, 4 * rows * d, "f32")
    log(f"[kernels] {name} {row['shape']}: max_abs_err "
        f"{row['max_abs_err']:.3e} (rtol {RMS_RTOL}); two calls bitwise "
        f"equal {same}; ok={ok}; {versus('kernel', t, 'F.rms_norm')}; "
        f"bound {row['bound_ms']:.4f} ms")
    return row, ok


def check_rmsnorm(gen):
    from repro_torch.kernels.rmsnorm import rmsnorm
    row, ok = _rmsnorm_row(gen, SERVE_SLOTS * 512, 2048)  # slots x bucket
    rows = SERVE_SLOTS * 512
    # mamba2-370m's block and final norms run at d_model 1024, the small
    # Trainer run at 256: checked, logged, not in the JSON
    oks = [ok] + [_rmsnorm_compare(gen, rows, dd)[0] for dd in (1024, 256)]
    if not all(oks):
        raise AssertionError("rmsnorm kernel disagrees with its plain version")
    # mamba's width at the prefill shape, and llama's decode shape (33 norms
    # of every decode step; launch-bound): logged beside F.rms_norm
    for r, dd in ((rows, 1024), (SERVE_SLOTS, 2048)):
        tt, (_, _, nc) = rmsnorm_timings(gen, r, dd)
        b_ms, _ = bound(2 * r * dd * 2 + dd * 4, 4 * r * dd, "f32")
        log(f"[kernels] rmsnorm x ({r}, {dd}) bf16 ({nc} input copies): "
            f"{versus('kernel', tt, 'F.rms_norm')}; bound {b_ms:.4f} ms")
    # a width the kernel is not instantiated for is refused on the card
    x = torch.randn(4, 512, device="cuda").bfloat16()
    try:
        rmsnorm(x, torch.ones(512, device="cuda"))
    except ValueError as e:
        log(f"[kernels] rmsnorm at d 512 refused: {e}")
    else:
        raise AssertionError("rmsnorm ran at d 512, which it is not built for")
    return row


def _prefill_row(gen, B, S, H, KV, D, name="flash_prefill", graph=False,
                 backend=False, window=0, valid_len=None, plain_block=1024):
    """The prefill kernel at one serving bucket (B rows of S with ragged
    valid lengths, row B // 2 at S // 3, or ``valid_len``; a local
    ``window`` or none) against its plain version (key blocks of
    ``plain_block``), timed beside SDPA over the same causal, window and
    valid-length mask (``graph``: graph_ms too) and its bound; with
    ``graph`` also twice (bitwise equal), and with ``backend`` the kernels
    SDPA launched are logged.  With a window SDPA takes K and V repeated to
    the H query heads (outside the timed call) and its memory-efficient
    backend, which reads the mask without an (S, S) score matrix a head.
    Raises on a disagreement; returns the bucket's JSON row."""
    from repro_torch.kernels.flash_attention import (flash_prefill,
                                                     flash_prefill_ref)
    if valid_len is None:
        vl = torch.tensor(np.linspace(1, S, B).astype(np.int32),
                          device="cuda")
        vl[B // 2] = S // 3
    else:
        vl = torch.tensor(valid_len, dtype=torch.int32, device="cuda")
    n = n_copies(2 * B * S * (H + 2 * KV) * D)
    cases = [tuple(torch.randn(B, S, heads, D, generator=gen,
                               device="cuda").bfloat16()
                   for heads in (H, KV, KV)) for _ in range(n)]
    q, k, v = cases[0]
    got = flash_prefill(q, k, v, vl, window=window)
    ref = flash_prefill_ref(q, k, v, vl, window=window,
                            block_k=plain_block)
    same = torch.equal(got, flash_prefill(q, k, v, vl, window=window))
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= ATTN_TOL + ATTN_TOL * ref.float().abs()).all()) \
        and same
    log(f"[kernels] {name} B={B} S={S} H={H} KV={KV} D={D} window "
        f"{window} valid_len={vl.tolist()}: max_abs_err "
        f"{float(err.max()):.3e} (tol {ATTN_TOL}); two calls bitwise equal "
        f"{same}; ok={ok}")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version")
    max_err = float(err.max())
    del got, ref, err
    kpos = torch.arange(S, device="cuda")
    causal = kpos[None, :] <= kpos[:, None]
    if window:
        causal &= kpos[:, None] - kpos[None, :] < window
    mask = causal[None] & (kpos[None, None, :] < vl[:, None, None])

    if window:
        lib_cases = [(q, k.repeat_interleave(H // KV, 2),
                      v.repeat_interleave(H // KV, 2)) for q, k, v in cases]

        def sdpa(q, k, v):
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask[:, None])
    else:
        lib_cases = cases

        def sdpa(q, k, v):
            return _library_sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), mask[:, None])
    # past 4096 positions a call takes tens of ms: 5 timed calls a loop
    t = both_times(cycled(lambda q, k, v: flash_prefill(q, k, v, vl,
                                                        window=window),
                          cases),
                   cycled(sdpa, lib_cases), max(20, n) if S <= 4096 else 5,
                   graph=graph)
    if backend:
        names = sorted({key.split("(")[0][:60] for _, _, key in
                        profiled_kernels(lambda: sdpa(q, k, v))})
        log(f"[kernels] {name} S={S}: SDPA (boolean mask) launched "
            f"{names}")
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:125",
           "shape": f"q ({B}, {S}, {H}, {D}) kv {KV} heads bf16",
           "timing": f"cold L2: cycles over {n} input copies; {TIMING}"
                     + (f"; {GRAPH_TIMING}" if graph else ""),
           "max_abs_err": max_err, "tol": ATTN_TOL,
           "ms": t["ms"], "device_ms": t["device_ms"],
           "plain_ms": time_ms(cycled(
               lambda q, k, v: flash_prefill_ref(q, k, v, vl, window=window,
                                                 block_k=plain_block),
               cases), iters=5 if S <= 4096 else 1,
               warmup=3 if S <= 4096 else 0),
           "library_ms": t["library_ms"],
           "library_device_ms": t["library_device_ms"]}
    if graph:
        row.update(graph_ms=t["graph_ms"],
                   library_graph_ms=t["library_graph_ms"])
    # bytes: q read and out written whole; row b reads K and V only at
    # its min(S, valid_len) valid keys.  Operations: 4 D per (query,
    # key) pair left by the causal, window and valid-length masks.
    keys = int(torch.clamp(vl, max=S).sum())
    i = torch.arange(S, device="cuda")
    upper = torch.minimum(i[None, :] + 1, vl[:, None])
    lower = torch.clamp(i - window + 1, min=0)[None, :] if window else 0
    pairs = int(torch.clamp(upper - lower, min=0).sum()) * H
    row["bound_ms"], row["bound_by"] = bound(
        2 * (2 * B * S * H * D + 2 * keys * KV * D) + B * 4,
        4 * D * pairs, "bf16")
    log(f"[kernels] {name} S={S}: {versus('kernel', t, 'SDPA')}; "
        f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def check_prefill(gen):
    # 8 and 32: the smallest serving buckets, shorter than one 64-row tile
    rows = [_prefill_row(gen, SERVE_SLOTS, S, 32, 8, 64)
            for S in (8, 32, 128, 512)]
    check_prefill_padded_window(gen)
    return rows[-1]              # the longest bucket goes in the JSON


def _check_fwd_lse(label, got, lse, ref, lse_ref):
    """The attention output within ``ATTN_TOL`` (absolute plus relative)
    and the log-sum-exp within ``LSE_TOL`` of the plain version's; logs
    and returns (max_abs_err, lse max_abs_err)."""
    err = float((got.float() - ref.float()).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    ok = bool(((got.float() - ref.float()).abs()
               <= ATTN_TOL + ATTN_TOL * ref.float().abs()).all()) \
        and lse_err <= LSE_TOL
    log(f"[kernels] flash_prefill {label}: max_abs_err {err:.3e} (tol "
        f"{ATTN_TOL}), lse max_abs_err {lse_err:.3e} (tol {LSE_TOL}) "
        f"ok={ok}")
    if not ok:
        raise AssertionError(f"flash_prefill kernel disagrees with its plain "
                             f"version: {label}")
    return err, lse_err


def check_prefill_padded_window(gen, H=32, KV=8, D=64):
    """A local window over right-padded rows: row 1's padded queries at
    positions >= 40 + 16 - 1 see no valid key and take the kernel's branch
    for that case (the mean of the values their window admits, as the
    reference gives).  Every row is compared, the log-sum-exp too."""
    from repro_torch.kernels.flash_attention import (flash_prefill,
                                                     flash_prefill_ref)
    B, S, window = 2, 128, 16
    vl = torch.tensor([S, 40], dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn(B, S, heads, D, generator=gen,
                           device="cuda").bfloat16()
               for heads in (H, KV, KV))
    _check_fwd_lse(f"D {D}, window {window}, valid_len {vl.tolist()} "
                   f"(rows without a valid key)",
                   *flash_prefill(q, k, v, vl, window=window,
                                  return_lse=True),
                   *flash_prefill_ref(q, k, v, vl, window=window,
                                      return_lse=True))


def _attention_pairs(B, H, S):
    """(query, key) pairs a causal mask admits over B x H heads of S."""
    return B * H * S * (S + 1) // 2


def _check_bwd(shape, got, ref):
    """Each of dq, dk, dv within ``BWD_TOL`` of its largest |value|; logs
    and returns {name: (max_abs_err, max |value|)}."""
    errs = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        scale = float(r.float().abs().max())
        errs[name] = (float((g.float() - r.float()).abs().max()), scale)
    ok = all(e <= BWD_TOL * sc for e, sc in errs.values())
    log(f"[kernels] flash_bwd {shape}: " + ", ".join(
        f"{k_} max_abs_err {e:.3e} of max |{k_}| {sc:.3e}"
        for k_, (e, sc) in errs.items()) + f" (tol {BWD_TOL} relative) "
        f"ok={ok}")
    if not ok:
        raise AssertionError(f"flash_bwd kernel disagrees with its plain "
                             f"version at {shape}")
    return errs


def _attn_shape(B, Sq, Sk, H, KV, D, causal) -> str:
    """A log's name of an attention shape: S when Sq == Sk."""
    seq = f"S {Sq}" if Sq == Sk else f"Sq {Sq} Sk {Sk}"
    return (f"B {B} {seq} H {H} KV {KV} D {D} "
            f"{'causal' if causal else 'non-causal'} bf16")


def _check_bwd_edge(gen, B, S, H, KV, D=TRAIN_D, causal=True, Sk=None,
                    window=0):
    """The forward with its log-sum-exp and the backward at one more shape
    (S queries over ``Sk`` keys, by default S; causal or not; a local
    ``window`` or none), each against its plain version (logged, not in
    the JSON)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_prefill,
                                                     flash_prefill_ref)
    Sk = Sk or S
    shape = _attn_shape(B, S, Sk, H, KV, D, causal) \
        + (f" window {window}" if window else "")
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(B, Sk, KV, D, generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
    o, lse = flash_prefill(q, k, v, causal=causal, window=window,
                           return_lse=True)
    _check_fwd_lse(f"with lse, {shape}", o, lse,
                   *flash_prefill_ref(q, k, v, causal=causal, window=window,
                                      return_lse=True))
    _check_bwd(shape,
               flash_attention_bwd(q, k, v, o, do, lse, causal, window),
               flash_attention_bwd_ref(q, k, v, o, do, lse, causal, window))


def check_flash_bwd(gen, H=TRAIN_H, KV=TRAIN_KV, D=TRAIN_D,
                    edges=((2, 200, 32, 8), (2, 256, 8, 8)), tag="",
                    B=TRAIN_BATCH // TRAIN_ACCUM, Sq=TRAIN_SEQ, Sk=None,
                    causal=True, window=0):
    """The training path's attention kernels at its shape (a micro-batch of
    ``B`` rows, ``Sq`` queries over ``Sk`` keys, by default ``TRAIN_SEQ``
    both, causal or not; llama3.2-1b's heads by default, zamba2-7b's
    shared block with ``HYBRID_ATTN``, gpt3-xl's with ``GPT3_ATTN``,
    seamless-m4t-medium's non-causal encoder and cross-attention with
    ``ENCDEC_ATTN``): the forward with its log-sum-exp and the flash
    backward, each against its plain version on the same inputs, and timed
    (cold L2) beside SDPA's forward and its backward through
    ``torch.autograd.grad`` on a saved forward; then both again at the
    ``edges`` shapes (B, S, H, KV), or (B, S, H, KV, Sk) for S queries
    over Sk keys, or (B, S, H, KV, Sk, window).  With a local ``window``
    (causal; llama4-scout's local layers) every call takes it, and SDPA's
    yardsticks take the causal and window mask as an explicit boolean
    mask.  Returns the forward's and the backward's JSON rows, named with
    ``tag``."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_prefill,
                                                     flash_prefill_ref)
    Sk = Sk or Sq
    shape = _attn_shape(B, Sq, Sk, H, KV, D, causal) \
        + (f" window {window}" if window else "")
    io_bytes = 2 * B * (Sq * H + 2 * Sk * KV) * D    # q, k, v
    n = n_copies(io_bytes * 2 + 2 * 2 * B * Sq * H * D)

    def case():
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(B, Sk, KV, D, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        do = torch.randn(B, Sq, H, D, generator=gen, device="cuda").bfloat16()
        o, lse = flash_prefill(q, k, v, causal=causal, window=window,
                               return_lse=True)
        return q, k, v, o, do, lse
    cases = [case() for _ in range(n)]
    q, k, v, o, do, lse = cases[0]

    err, lse_err = _check_fwd_lse(
        f"with lse, {shape}", o, lse,
        *flash_prefill_ref(q, k, v, causal=causal, window=window,
                           return_lse=True))

    got = flash_attention_bwd(q, k, v, o, do, lse, causal, window)
    errs = _check_bwd(shape, got, flash_attention_bwd_ref(
        q, k, v, o, do, lse, causal, window))
    # no atomics and sums in a fixed order: a second call on the same
    # inputs gives bitwise-equal gradients
    again = flash_attention_bwd(q, k, v, o, do, lse, causal, window)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[kernels] flash_bwd {shape}: two calls bitwise equal (dq, dk, dv): "
        f"{same}")
    if not same:
        raise AssertionError("flash_bwd kernel is not deterministic")
    del got, again
    # the tile edges: S not a multiple of the 64-row tile, and another G
    # (or Sk, for Sq queries over Sk keys)
    for edge in edges:
        _check_bwd_edge(gen, *edge[:4], D, causal, *edge[4:])

    # SDPA's yardstick: is_causal, or the causal and window mask
    i = torch.arange(Sq, device="cuda")
    lib_mask = None if not window else \
        (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask,
            is_causal=causal and lib_mask is None, enable_gqa=True)

    def sdpa_saved(q, k, v, o, do, lse):
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        return sdpa(qt, kt, vt), (qt, kt, vt), do.transpose(1, 2)
    saved = [sdpa_saved(*c) for c in cases]
    timing = f"cold L2: cycles over {n} input copies; {TIMING}"
    pairs = _attention_pairs(B, H, Sq) if causal else B * H * Sq * Sk
    if window:
        pairs = B * H * int(torch.clamp(i + 1, max=window).sum())
    mode = "causal" if causal else "non-causal"
    if window:
        mode += f", window {window}"
    t_fwd = both_times(
        cycled(lambda q, k, v, *_: flash_prefill(q, k, v, causal=causal,
                                                 window=window,
                                                 return_lse=True), cases),
        cycled(lambda q, k, v, *_: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2)), cases), 4 * n)
    t_bwd = both_times(
        cycled(lambda *c: flash_attention_bwd(*c, causal, window), cases),
        cycled(lambda out, inputs, g: torch.autograd.grad(
            out, inputs, g, retain_graph=True), saved), 2 * n)
    kv_shape = f"kv {KV} heads" if Sq == Sk else f"kv ({B}, {Sk}, {KV})"
    fwd = {"name": "flash_prefill_lse" + tag, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:125",
           "shape": f"q ({B}, {Sq}, {H}, {D}) {kv_shape} bf16, {mode}, "
                    f"with lse", "timing": timing,
           "max_abs_err": max(err, lse_err), "tol": ATTN_TOL,
           "ms": t_fwd["ms"], "device_ms": t_fwd["device_ms"],
           "plain_ms": time_ms(cycled(lambda q, k, v, *_: flash_prefill_ref(
               q, k, v, causal=causal, window=window, return_lse=True),
               cases), iters=3, warmup=1),
           "library_ms": t_fwd["library_ms"],
           "library_device_ms": t_fwd["library_device_ms"]}
    # bytes: q, k, v read, o written, lse written (f32); 2 products of 2 D
    # flops per admitted pair
    fwd["bound_ms"], fwd["bound_by"] = bound(
        io_bytes + 2 * B * Sq * H * D + 4 * B * H * Sq, 4 * D * pairs,
        "bf16")
    bwd = {"name": "flash_bwd" + tag, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_backward.cu",
           "replaces": "src/repro/kernels/flash_attention/backward.py:125",
           "also_replaces": "src/repro/kernels/flash_attention/"
                            "backward.py:144",
           "shape": f"q ({B}, {Sq}, {H}, {D}) {kv_shape} bf16, {mode}",
           "timing": timing,
           "max_abs_err": max(e for e, _ in errs.values()),
           "tol": f"{BWD_TOL} of each output's largest |value|",
           "ms": t_bwd["ms"], "device_ms": t_bwd["device_ms"],
           "plain_ms": time_ms(cycled(lambda *c: flash_attention_bwd_ref(
               *c, causal, window), cases), iters=3, warmup=1),
           "library_ms": t_bwd["library_ms"],
           "library_device_ms": t_bwd["library_device_ms"]}
    # bytes: q, k, v, o, dO read, lse read (f32), dq, dk, dv written;
    # the function needs 5 products of 2 D flops per admitted pair (QK^T,
    # dO V^T, dS K, P^T dO, dS^T Q; the kernels' recompute of QK^T and
    # dO V^T in the second kernel is the design's, not the function's)
    bwd["bound_ms"], bwd["bound_by"] = bound(
        2 * io_bytes + 2 * 2 * B * Sq * H * D + 4 * B * H * Sq,
        5 * 2 * D * pairs, "bf16")
    for row, t in ((fwd, t_fwd), (bwd, t_bwd)):
        log(f"[kernels] {row['name']} {shape}: {versus('kernel', t, 'SDPA')}"
            f"; plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']})")
    return fwd, bwd


# decode positions of the timed paged-decode rows, and of the profile
# run's short contexts (8 prompts of 128 tokens and up to 32 new ones)
SERVE_POS = tuple(int(p) for p in np.linspace(16, 1000, SERVE_SLOTS))
PROFILE_POS = tuple(int(p) for p in np.linspace(128, 160, SERVE_SLOTS))


def _paged_case(gen, pool_dtype, positions=SERVE_POS, L=16, H=32, KV=8,
                D=64):
    """Full-width decode operands: one slot per position, page 16, a table
    of 64 pages whose entries past each slot's last page stay parked at page
    0 (a slot at pos == max_seq holds its whole table), and ``L`` layers of
    pools (16: a timing loop over layers leaves L2 cold).  Heads and
    head_dim default to llama3.2-1b's; ``HYBRID_ATTN`` gives zamba2-7b's."""
    B, page = len(positions), SERVE_PAGE
    nb = SERVE_MAX_SEQ // page
    P = B * nb + 1
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros(B, nb, dtype=torch.int32, device="cuda")
    for b in range(B):                               # the rest stays parked
        n = min(nb, int(pos[b]) // page + 1)
        tables[b, :n] = perm[b * nb:b * nb + n]
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").bfloat16()
    k32 = torch.randn(L, P, page, KV, D, generator=gen, device="cuda")
    v32 = torch.randn(L, P, page, KV, D, generator=gen, device="cuda")
    if pool_dtype == torch.float32:
        return q, k32, v32, tables, pos, None, None
    if pool_dtype == torch.bfloat16:
        return q, k32.bfloat16(), v32.bfloat16(), tables, pos, None, None
    qmax = 127.0 if pool_dtype == torch.int8 else 448.0
    ks = k32.abs().amax(dim=(2, 4)) / qmax                # (L, P, KV)
    vs = v32.abs().amax(dim=(2, 4)) / qmax

    def quant(x, s):
        y = x / s[:, :, None, :, None]
        if pool_dtype == torch.int8:
            y = torch.round(y)
        return torch.clamp(y, -qmax, qmax).to(pool_dtype)
    return q, quant(k32, ks), quant(v32, vs), tables, pos, ks, vs


def _layers(case):
    """(k pool, v pool, k scales, v scales) of each layer of a case."""
    _, kp, vp, _, _, ks, vs = case
    return [(kp[i], vp[i], None if ks is None else ks[i],
             None if vs is None else vs[i]) for i in range(kp.shape[0])]


def _paged_work(case):
    """(bytes, operations) of one decode call on a case.  Bytes: q read and
    out written; slot b's pos + 1 keys and values (the whole table for a
    parked slot); for the pages it walks, their table entries and
    (quantized pools) their K and V scales of every KV head; pos."""
    q, kp, _, tables, pos, ks, _ = case
    B, _, H, D = q.shape
    page, KV = kp.shape[2], kp.shape[3]
    S = tables.shape[1] * page
    last = torch.clamp(pos, max=S - 1)
    keys = int((last + 1).sum())
    pages = int((last // page + 1).sum())
    scale_bytes = 0 if ks is None else pages * KV * 4 * 2
    return (2 * B * H * D * 2 + keys * KV * D * kp.element_size() * 2
            + scale_bytes + pages * 4 + B * 4, 4 * D * H * keys)


def _paged_bound(case):
    """(bound ms, by) of one decode call on a case (``_paged_work``)."""
    return bound(*_paged_work(case), "bf16")


def _paged_library_bytes(case):
    """Bytes the SDPA yardstick of ``paged_timings`` reads and writes: q,
    the output, the boolean mask, and the gathered bf16 K and V of every
    slot over the pages up to the largest position."""
    q, kp, _, tables, pos, _, _ = case
    B, _, H, D = q.shape
    page, KV = kp.shape[2], kp.shape[3]
    keys = min(tables.shape[1], int(pos.max()) // page + 1) * page
    return 2 * B * H * D * 2 + B * keys + 2 * B * KV * keys * D * 2


def paged_timings(case, plain: bool = False, decode=None):
    """``both_times`` of one decode call on ``case`` against SDPA, and
    ``plain_ms`` (None unless ``plain``), each cycling over its layers'
    pools.  ``decode`` (default: the public wrapper) takes the wrapper's
    arguments, so that another tree's kernel or another split size can be
    timed the same way.  The SDPA yardstick reads bf16 caches already
    gathered per slot, one per layer, so that it too reads device memory,
    over the pages in use: every slot's keys up to the largest position
    (the kernel reads each slot's pos + 1), in bf16 even for an int8 or
    fp8 pool (``_paged_library_bytes``)."""
    from repro_torch.kernels.flash_attention import (paged_attention_ref,
                                                     paged_flash_decode)
    from repro_torch.kernels.flash_attention.paged import gather_pages
    q, kp, _, tables, pos, _, _ = case
    layers = _layers(case)

    def run(fn):
        return cycled(lambda *a: fn(q, a[0], a[1], tables, pos, k_scales=a[2],
                                    v_scales=a[3]), layers)

    page = kp.shape[2]
    nb = min(tables.shape[1], int(pos.max()) // page + 1)
    gathered = [tuple(gather_pages(kv, tables[:, :nb], s).bfloat16()
                      .transpose(1, 2) for kv, s in ((kl, ksl), (vl_, vsl)))
                for kl, vl_, ksl, vsl in layers]
    mask = (torch.arange(nb * page, device="cuda")[None, :] <= pos[:, None])
    qt = q.transpose(1, 2)
    t = both_times(run(decode or paged_flash_decode),
                   cycled(lambda gk, gv: _library_sdpa(
                       qt, gk, gv, mask[:, None, None, :]), gathered), 32,
                   graph=True)
    t["plain_ms"] = time_ms(run(paged_attention_ref), iters=8) if plain \
        else None
    return t


def _paged_compare(label, case, window=0, softcap=0.0):
    """The kernel against its plain version on the first layer of a case
    at ``ATTN_TOL``; logs and returns (output, max_abs_err)."""
    from repro_torch.kernels.flash_attention import (paged_attention_ref,
                                                     paged_flash_decode)
    q, _, _, tables, pos, _, _ = case
    k0, v0, ks0, vs0 = _layers(case)[0]
    kw = dict(window=window, softcap=softcap, k_scales=ks0, v_scales=vs0)
    got = paged_flash_decode(q, k0, v0, tables, pos, **kw)
    ref = paged_attention_ref(q, k0, v0, tables, pos, **kw)
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= ATTN_TOL + ATTN_TOL * ref.float().abs()).all()) \
        and bool(torch.isfinite(got).all())
    log(f"[kernels] paged_decode {label}: B={q.shape[0]} page "
        f"{k0.shape[1]} pos={pos.tolist()} window {window} softcap "
        f"{softcap}: max_abs_err {float(err.max()):.3e} (tol {ATTN_TOL}) "
        f"ok={ok}")
    if not ok:
        raise AssertionError(f"paged_decode kernel ({label}) disagrees with "
                             f"its plain version")
    return got, float(err.max())


def paged_agreement(gen, pool_dtype, label, attn=None, L=16):
    """The paged decode kernel against its plain version on one pool type:
    at the serving positions, twice (bitwise equal); at split and page
    edges, a parked slot (pos == max_seq), a window of 256 that begins
    inside a split, softcap 50 and a single slot.  ``attn`` (heads, KV
    heads, head_dim; ``HYBRID_ATTN``) replaces llama3.2-1b's; the serving
    case holds ``L`` layers of pools.  Returns (case, max_abs_err)."""
    from repro_torch.kernels.flash_attention import paged_flash_decode
    from repro_torch.kernels.flash_attention.paged import split_plan
    attn = attn or {}
    case = _paged_case(gen, pool_dtype, L=L, **attn)
    q, kp, _, tables, pos, _, _ = case
    got, err = _paged_compare(f"{label} pool", case)
    k0, v0, ks0, vs0 = _layers(case)[0]
    again = paged_flash_decode(q, k0, v0, tables, pos, k_scales=ks0,
                               v_scales=vs0)
    if not torch.equal(got, again):
        raise AssertionError(f"paged_decode ({label}): two calls differ")
    kps, n_split = split_plan(tables.shape[1], kp.shape[2])
    edges = (0, 15, 16, kps - 1, kps, SERVE_MAX_SEQ - 1, SERVE_MAX_SEQ, 500)
    for what, positions, window, softcap in (
            ("edges", edges, 0, 0.0),
            ("window", edges, 256, 0.0),
            ("softcap", edges, 0, 50.0),
            ("B 1", (1000,), 0, 0.0)):
        _paged_compare(f"{label} pool, {what} ({kps} keys a split, "
                       f"{n_split} splits)",
                       _paged_case(gen, pool_dtype, positions, L=1, **attn),
                       window, softcap)
    return case, err


def check_paged(gen, pool_dtype, label, attn=None, L=16):
    """``paged_agreement``, then the kernel timed at the serving positions
    (its JSON row) and, for the serving pools, at the profile run's short
    contexts (logged); ``L`` layers of pools cycle in the timing."""
    attn = attn or {}
    case, err = paged_agreement(gen, pool_dtype, label, attn, L)
    q, kp, _, tables, pos, _, _ = case
    B, _, H, D = q.shape
    t = paged_timings(case, plain=True)
    nbytes = _paged_work(case)[0]
    lib_bytes = _paged_library_bytes(case)
    row = {"name": f"paged_decode[{label}]", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
           "replaces": "src/repro/kernels/flash_attention/paged.py:155",
           "shape": f"q ({B}, 1, {H}, {D}) pool {label} page {kp.shape[2]} "
                    f"pos {int(pos.min())}..{int(pos.max())}",
           "timing": f"cold L2: cycles over {kp.shape[0]} layers' pools; "
                     f"{TIMING}; {GRAPH_TIMING}; SDPA reads a gathered bf16 "
                     f"cache of every slot up to the largest position",
           "bytes": nbytes, "library_bytes": lib_bytes,
           "max_abs_err": err, "tol": ATTN_TOL, "ms": t["ms"],
           "device_ms": t["device_ms"], "graph_ms": t["graph_ms"],
           "library_graph_ms": t["library_graph_ms"],
           "plain_ms": t["plain_ms"],
           "library_ms": t["library_ms"],
           "library_device_ms": t["library_device_ms"]}
    row["bound_ms"], row["bound_by"] = _paged_bound(case)
    log(f"[kernels] paged_decode {label} pool, serving positions: "
        f"{versus('kernel', t, 'SDPA over the pages in use')}; bound "
        f"{row['bound_ms']:.4f} ms; bytes: kernel {nbytes / 1e6:.2f} MB, "
        f"SDPA {lib_bytes / 1e6:.2f} MB ({lib_bytes / nbytes:.2f}x)")
    del case
    if pool_dtype in (torch.bfloat16, torch.int8):
        short = _paged_case(gen, pool_dtype, PROFILE_POS, L=L, **attn)
        st = paged_timings(short)
        log(f"[kernels] paged_decode {label} pool, short contexts pos "
            f"{PROFILE_POS[0]}..{PROFILE_POS[-1]}: "
            f"{versus('kernel', st, 'SDPA over the pages in use')}; bound "
            f"{_paged_bound(short)[0]:.4f} ms")
    return row


def _ssd_case(gen, B, S, H, G, h0=False, N=128, P=64):
    """SSD scan operands: bf16 x, B, C; f32 log decay in (-0.03, 0], the
    served model's scale (dt * A with dt = softplus(N(0, 1) - 4.6), A = -1),
    so the state carried across a 256-position chunk keeps a visible share
    of y; optionally an f32 state."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    return (rnd(B, S, H, P).bfloat16(),
            -0.03 * torch.rand(B, S, H, generator=gen, device="cuda"),
            rnd(B, S, G, N).bfloat16(), rnd(B, S, G, N).bfloat16(),
            rnd(B, H, N, P) if h0 else None)


def _ssd_work(x, Bm, chunk, h0):
    """(bytes, operations) the SSD scan needs on these operands: x, a, B, C
    (and h0) read once, y and the final state written once; per chunk of n
    positions, C Bᵀ once per group over the n (n + 1) / 2 causal pairs, the
    dual form's product with x over those pairs per head, the chunk's state
    update per head and, where a state enters the chunk (not the first one
    when there is no h0), its term in y."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    nbytes = 2 * B * S * H * P * 2 + 4 * B * S * H + 2 * 2 * B * S * G * N \
        + 4 * B * H * N * P * (1 if h0 is None else 2)
    ops = 0
    for c, t0 in enumerate(range(0, S, Q)):
        n = min(Q, S - t0)
        pairs = n * (n + 1) // 2
        carried = 1 if (c or h0 is not None) else 0
        ops += 2 * B * (G * pairs * N + H * pairs * P
                        + (1 + carried) * H * n * N * P)
    return nbytes, ops


# (label, shape, chunk) of the SSD scan's checks: the serving shape, with
# an initial state, the prefill buckets shorter than a 64-row tile (32) and
# than a chunk (128), 2 groups over a ragged last chunk (256 + 44) with an
# initial state, 3 heads a group (a block of the output pass then takes one
# head), and chunks of 16
SSD_CASES = (
    ("serve", dict(B=SERVE_SLOTS, S=512, H=32, G=1), SSD_CHUNK),
    ("serve_h0", dict(B=SERVE_SLOTS, S=512, H=32, G=1, h0=True), SSD_CHUNK),
    ("bucket32", dict(B=SERVE_SLOTS, S=32, H=32, G=1), SSD_CHUNK),
    ("bucket128", dict(B=SERVE_SLOTS, S=128, H=32, G=1), SSD_CHUNK),
    ("groups", dict(B=2, S=300, H=32, G=2, h0=True), SSD_CHUNK),
    ("groups_odd", dict(B=2, S=300, H=24, G=8, h0=True), SSD_CHUNK),
    ("chunk16", dict(B=2, S=200, H=32, G=1), 16))


def _ssd_compare(gen, label, shape, chunk):
    """The kernel against its plain version on one case, y within
    ``SSD_Y_TOL`` and the final state within ``SSD_H_TOL`` of their largest
    |value|, and twice (bitwise equal); logs and returns max_abs_err."""
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    x, a, Bm, Cm, h0 = _ssd_case(gen, **shape)
    y, hf = ssd_scan(x, a, Bm, Cm, chunk, h0=h0)
    y2, hf2 = ssd_scan(x, a, Bm, Cm, chunk, h0=h0)
    yr, hr = ssd_ref(x, a, Bm, Cm, chunk, h0=h0)
    torch.cuda.synchronize()
    err = _ssd_agree("kernels", f"ssd_scan {label} {shape} chunk {chunk}",
                     y, hf, yr, hr)
    same = torch.equal(y, y2) and torch.equal(hf, hf2)
    log(f"[kernels] ssd_scan {label}: two calls bitwise equal {same}")
    if not same:
        raise AssertionError(f"ssd_scan ({label}): two calls differ")
    return err


def _ssd_agree(tag, label, y, hf, yr, hr):
    """The kernel's y within ``SSD_Y_TOL`` and final state within
    ``SSD_H_TOL`` of the plain version's largest |value|, both finite;
    logs, raises on a mismatch, and returns the larger max_abs_err."""
    ey = float((y.float() - yr.float()).abs().max())
    sy = float(yr.float().abs().max())
    eh = float((hf - hr).abs().max())
    sh = float(hr.abs().max())
    ok = ey <= SSD_Y_TOL * sy and eh <= SSD_H_TOL * sh \
        and bool(torch.isfinite(y).all()) and bool(torch.isfinite(hf).all())
    log(f"[{tag}] {label}: y max_abs_err {ey:.3e} of max |y| {sy:.3e} (tol "
        f"{SSD_Y_TOL} relative), state max_abs_err {eh:.3e} of max |h| "
        f"{sh:.3e} (tol {SSD_H_TOL} relative) ok={ok}")
    if not ok:
        raise AssertionError(f"ssd_scan kernel disagrees with its plain "
                             f"version ({label})")
    return max(ey, eh)


def ssd_timings(gen, shape, chunk, plain: bool = False, graph: bool = False):
    """Times of the SSD scan at ``shape`` and ``chunk``, cycling over input
    copies larger than L2: ``ms`` with the host in the loop, ``device_ms``
    and ``host_ms`` from ``time_device_ms``, ``passes`` (device ms a call
    of each kernel it launches, under ``torch.profiler``), ``plain_ms``
    (None unless ``plain``) and ``graph_ms`` (with ``graph``: the calls
    replayed from one CUDA graph); and the ``bytes`` and ``ops`` of one
    call (``_ssd_work``)."""
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    first = _ssd_case(gen, **shape)
    nbytes, ops = _ssd_work(first[0], first[2], chunk, first[4])
    n = n_copies(nbytes)
    copies = [first[:4]] + [_ssd_case(gen, **shape)[:4] for _ in range(n - 1)]
    run = cycled(lambda *c: ssd_scan(*c, chunk), copies)
    t = {"ms": time_ms(run, iters=2 * n)}
    t["device_ms"], t["host_ms"] = time_device_ms(run, iters=2 * n)

    def loop():
        for _ in range(2 * n):
            run()
        torch.cuda.synchronize()
    t["passes"] = {key.split("(")[0].split("<")[0].removeprefix("void "):
                   us / 1e3 / (2 * n)
                   for us, _, key in profiled_kernels(loop)
                   if "ssd_scan" in key}
    t["plain_ms"] = time_ms(cycled(lambda *c: ssd_ref(*c, chunk), copies),
                            iters=3, warmup=1) if plain else None
    if graph:
        t["graph_ms"] = time_graph_ms(run, calls=2 * n)
    t.update(copies=n, bytes=nbytes, ops=ops)
    return t


def check_ssd(gen):
    """The SSD scan kernel against its plain version on ``SSD_CASES``,
    each twice (bitwise equal); times the serving shape (cold L2).  Returns
    its JSON row."""
    errs = {label: _ssd_compare(gen, label, shape, chunk)
            for label, shape, chunk in SSD_CASES}
    _, shape, chunk = SSD_CASES[0]
    t = ssd_timings(gen, shape, chunk, plain=True)
    nbytes, ops = t["bytes"], t["ops"]
    row = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:82",
           "shape": f"x ({shape['B']}, {shape['S']}, {shape['H']}, 64) "
                    f"bf16, B/C G {shape['G']} N 128, chunk {chunk}",
           "timing": f"cold L2: cycles over {t['copies']} input copies; "
                     f"{TIMING}",
           "max_abs_err": errs["serve"],
           "tol": f"y {SSD_Y_TOL} of max |y|, state {SSD_H_TOL} of "
                  f"max |h|",
           "ms": t["ms"], "device_ms": t["device_ms"],
           "passes_ms": t["passes"], "plain_ms": t["plain_ms"],
           "library_ms": None, "library_device_ms": None,
           "library_note": "no single PyTorch call computes the SSD scan"}
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, "bf16")
    log(f"[kernels] ssd_scan serve: kernel {row['ms']:.4f} ms "
        f"(device time {row['device_ms']:.4f} ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in t["passes"].items())
        + f" ms under the profiler; "
        f"{t['host_ms'] * 1e3:.1f} us of host time a call), plain "
        f"{row['plain_ms']:.4f} ms, library none, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {nbytes / 1e6:.1f} "
        f"MB, {ops / 1e9:.2f} GFLOP)")
    return row


# the SSD gradient checks on the card, (label, shape, chunk): both
# instantiations (N 128, G 1 and N 64, G 2) over a ragged last chunk (256 +
# 44) with an initial state
SSD_GRAD_CASES = (
    ("N128 G1", dict(B=2, S=300, H=32, G=1, h0=True), SSD_CHUNK),
    ("N64 G2", dict(B=2, S=300, h0=True, **HYBRID_SSD), SSD_CHUNK))
# the training phases' SSD scans: a micro-batch of TRAIN_SEQ positions
SSD_TRAIN_SHAPES = {
    "mamba2-370m": dict(B=TRAIN_BATCH // TRAIN_ACCUM, S=TRAIN_SEQ, H=32, G=1),
    "zamba2-7b": dict(B=TRAIN_BATCH // TRAIN_ACCUM, S=TRAIN_SEQ,
                      **HYBRID_SSD)}


def phase_ssd_grads():
    """The SSD scan's autograd ``Function`` on the card (kernel forward,
    plain f32 backward), on ``SSD_GRAD_CASES``: its y and final state
    against ``ssd_ref`` (``_ssd_agree``), and the gradients of x, a, B, C
    and h0 through both against plain autograd of ``ssd_ref`` on the same
    bf16 inputs, each within ``SSD_GRAD_TOL`` of its largest |value| and
    finite; the ``Function`` launches the kernel once and its backward
    none.  The backward recomputes ``ssd_ref`` from the saved inputs, so
    the gradient check covers the dispatch and the dtypes; the forward
    check covers the kernel.  Then, at each training phase's shape, the
    kernel's y and final state, through the ``Function`` and the serving
    call, against ``ssd_ref``, and the forward kernel's time beside the
    plain backward's (y's gradient only, as the models take it).  Returns
    {model: plain backward ms}."""
    from repro_torch import kernels
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    for label, shape, chunk in SSD_GRAD_CASES:
        ops = _ssd_case(gen, **shape)
        wy = torch.randn(ops[0].shape, generator=gen, device="cuda")
        wh = torch.randn(ops[4].shape, generator=gen, device="cuda")

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in ops]
            y, h = fn(*leaves[:4], chunk, h0=leaves[4])
            ((y.float() * wy).sum() + (h * wh).sum()).backward()
            return [t.grad for t in leaves], y.detach(), h.detach()
        kernels.reset_launch_counts()
        got, y, h = grads(ssd_scan)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["ssd_scan"]
        ref, yr, hr = grads(ssd_ref)
        _ssd_agree("ssd_grads", f"{label} {shape} chunk {chunk}, the "
                   f"Function's forward", y, h, yr, hr)
        errs = {name: (float((g.float() - r.float()).abs().max()),
                       float(r.float().abs().max()))
                for name, g, r in zip(("x", "a", "B", "C", "h0"), got, ref)}
        ok = launches == 1 and all(
            e <= SSD_GRAD_TOL * sc for e, sc in errs.values()) and all(
            bool(torch.isfinite(g.float()).all()) for g in got) and all(
            g.dtype == t.dtype for g, t in zip(got, ops))
        log(f"[ssd_grads] {label} {shape} chunk {chunk}: kernel launches "
            f"{launches} (forward); " + ", ".join(
                f"d{k} max_abs_err {e:.3e} of max {sc:.3e}"
                for k, (e, sc) in errs.items())
            + f" (tol {SSD_GRAD_TOL} relative) ok={ok}")
        if not ok:
            raise AssertionError(f"ssd_scan Function gradients disagree with "
                                 f"plain autograd ({label})")
    out = {}
    for name, shape in SSD_TRAIN_SHAPES.items():
        x, a, Bm, Cm, _ = _ssd_case(gen, **shape)
        leaves = [t.clone().requires_grad_() for t in (x, a, Bm, Cm)]
        y, hf = ssd_scan(*leaves, SSD_CHUNK)
        ys, hs = ssd_scan(x, a, Bm, Cm, SSD_CHUNK)
        yr, hr = ssd_ref(x, a, Bm, Cm, SSD_CHUNK)
        label = f"{name} training shape {shape} chunk {SSD_CHUNK}"
        _ssd_agree("ssd_grads", f"{label}, the Function", y.detach(),
                   hf.detach(), yr, hr)
        _ssd_agree("ssd_grads", f"{label}, the serving call", ys, hs, yr, hr)
        del ys, hs, yr, hr
        fwd_ms = time_ms(lambda: ssd_scan(x, a, Bm, Cm, SSD_CHUNK), iters=10)
        dy = torch.randn(y.shape, generator=gen, device="cuda").bfloat16()
        torch.cuda.reset_peak_memory_stats()
        bwd_ms = time_ms(lambda: torch.autograd.grad(y, leaves, dy,
                                                     retain_graph=True),
                         iters=3, warmup=1)
        out[name] = bwd_ms
        log(f"[ssd_grads] {name} training shape {shape} chunk {SSD_CHUNK}: "
            f"forward kernel {fwd_ms:.4f} ms, plain f32 backward "
            f"{bwd_ms:.3f} ms ({bwd_ms / fwd_ms:.0f}x; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
        del x, a, Bm, Cm, leaves, y, hf, dy
    release()
    return out


def check_graph_replays(gen):
    """The kernels that launch a pass under programmatic dependent launch
    (PDL), inside a CUDA graph as the serving engine now runs them: paged
    decode (its combine pass) on bf16 and int8 pools at the serving
    positions, and the SSD scan (its carry and output passes) at the
    serving shape without and with an initial state.  Each replay must be
    bitwise equal to an eager call."""
    from repro_torch.kernels.flash_attention import paged_flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
        q, kp, vp, tables, pos, ks, vs = _paged_case(gen, dtype, L=1)
        kw = {} if ks is None else dict(k_scales=ks[0], v_scales=vs[0])
        same = graph_equal(lambda: paged_flash_decode(q, kp[0], vp[0], tables,
                                                      pos, **kw))
        log(f"[kernels] paged_decode {label} pool replayed from a CUDA "
            f"graph: bitwise equal to an eager call {same}")
        if not same:
            raise AssertionError(f"paged_decode ({label}): a graph replay "
                                 f"differs from an eager call")
    for label, shape, chunk in SSD_CASES[:2]:
        x, a, Bm, Cm, h0 = _ssd_case(gen, **shape)
        same = graph_equal(lambda: ssd_scan(x, a, Bm, Cm, chunk, h0=h0))
        log(f"[kernels] ssd_scan {label} replayed from a CUDA graph: bitwise "
            f"equal to an eager call {same}")
        if not same:
            raise AssertionError(f"ssd_scan ({label}): a graph replay "
                                 f"differs from an eager call")


#: paged decode at head_dim 64 with 2 query heads per KV head: granite-moe's
#: attention (16 heads, 8 KV heads) and the card smoke config's (4, 2)
GROUP2_ATTN = {"granite": dict(H=16, KV=8, D=64),
               "smoke": dict(H=4, KV=2, D=64)}


def check_group2_kernels(gen):
    """The paged decode kernel's (D 64, G 2) instantiation: at both
    ``GROUP2_ATTN`` shapes on bf16 and int8 pools, replayed from a CUDA
    graph bitwise equal to eager and ``paged_agreement``'s checks (the
    serving positions twice, bitwise equal; the edges, a window, softcap,
    one slot); timed at granite's shape on bf16 (its JSON row,
    ``paged_decode[D64G2 bf16]``, whose launches come from granite's
    full-width serve run); the fp8 and f32 pools checked and logged.
    Returns the row."""
    from repro_torch.kernels.flash_attention import paged_flash_decode
    for shape, attn in GROUP2_ATTN.items():
        for dtype, label in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            q, kp, vp, tables, pos, ks, vs = _paged_case(gen, dtype, L=1,
                                                         **attn)
            kw = {} if ks is None else dict(k_scales=ks[0], v_scales=vs[0])
            same = graph_equal(lambda: paged_flash_decode(
                q, kp[0], vp[0], tables, pos, **kw))
            log(f"[kernels] paged_decode {label} D64G2 {shape} pool "
                f"replayed from a CUDA graph: bitwise equal to an eager "
                f"call {same}")
            if not same:
                raise AssertionError(f"paged_decode ({label} D64G2 {shape}):"
                                     f" a graph replay differs from an "
                                     f"eager call")
            if (shape, label) != ("granite", "bf16"):
                paged_agreement(gen, dtype, f"D64G2 {label} {shape}", attn,
                                L=1)
    row = check_paged(gen, torch.bfloat16, "D64G2 bf16",
                      GROUP2_ATTN["granite"])
    row["model"] = ("granite-moe-1b-a400m (its attention: 16 heads over 8 "
                    "at head_dim 64)")
    for dtype, label in ((torch.float8_e4m3fn, "fp8"), (torch.float32, "f32")):
        _, err = paged_agreement(gen, dtype, f"D64G2 {label}",
                                 GROUP2_ATTN["granite"], L=1)
        log(f"[kernels] paged_decode[D64G2 {label}] (not on the serving "
            f"path): max_abs_err {err:.3e}")
    return row


# zamba2-7b's SSD scan: its serving bucket (B 8, S 512, H 112, G 2, N 64,
# chunk 256), with an initial state, and the buckets 32 and 128
HYBRID_SSD_CASES = (
    ("serve", dict(B=SERVE_SLOTS, S=512, **HYBRID_SSD), SSD_CHUNK),
    ("serve_h0", dict(B=SERVE_SLOTS, S=512, h0=True, **HYBRID_SSD),
     SSD_CHUNK),
    ("bucket32", dict(B=SERVE_SLOTS, S=32, **HYBRID_SSD), SSD_CHUNK),
    ("bucket128", dict(B=SERVE_SLOTS, S=128, **HYBRID_SSD), SSD_CHUNK))

#: the kernel rows of zamba2-7b's instantiations: the serving run whose
#: launches each reports (``phase_serve_hybrid``'s runs by page type)
HYBRID_ROW_RUNS = {"rmsnorm[d3584]": "bf16", "rmsnorm[d7168]": "bf16",
                   "flash_prefill[D224]": "bf16",
                   "paged_decode[bf16 D224]": "bf16",
                   "paged_decode[int8 D224]": "int8",
                   "ssd_scan[N64]": "bf16"}


def check_hybrid_kernels(gen):
    """zamba2-7b's instantiations of the four serving kernels, each against
    its plain version and twice (bitwise equal), timed (``ms``,
    ``device_ms``, ``graph_ms``) beside its bound and library yardstick:
    RMSNorm at d 3584 and 7168 (4096 rows; 8 rows logged); the prefill at
    head_dim 224 with one query head per KV head over the buckets 32, 128
    and 512 and a window over rows with no valid key; paged decode at head
    224 on bf16 and int8 pools (with ``check_paged``'s edges), replayed
    from a graph bitwise equal to eager; the SSD scan at state 64 with 2
    groups on ``HYBRID_SSD_CASES``, replayed from a graph likewise.
    Returns their JSON rows, each marked with the model."""
    from repro_torch.kernels.flash_attention import paged_flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    rows = []
    for d in (3584, 7168):
        row, ok = _rmsnorm_row(gen, SERVE_SLOTS * 512, d, f"rmsnorm[d{d}]")
        if not ok:
            raise AssertionError(f"rmsnorm kernel at d {d} disagrees with "
                                 f"its plain version")
        rows.append(row)
        t, (_, _, nc) = rmsnorm_timings(gen, SERVE_SLOTS, d)
        b_ms, _ = bound(2 * SERVE_SLOTS * d * 2 + d * 4,
                        4 * SERVE_SLOTS * d, "f32")
        log(f"[kernels] rmsnorm[d{d}] x ({SERVE_SLOTS}, {d}) bf16 ({nc} "
            f"input copies): {versus('kernel', t, 'F.rms_norm')}; bound "
            f"{b_ms:.4f} ms")
    H, KV, D = HYBRID_ATTN["H"], HYBRID_ATTN["KV"], HYBRID_ATTN["D"]
    for S in (32, 128, 512):
        row = _prefill_row(gen, SERVE_SLOTS, S, H, KV, D,
                           "flash_prefill[D224]", graph=True,
                           backend=S == 512)
    rows.append(row)                   # the longest bucket
    check_prefill_padded_window(gen, H, KV, D)
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
        q, kp, vp, tables, pos, ks, vs = _paged_case(gen, dtype, L=1,
                                                     **HYBRID_ATTN)
        kw = {} if ks is None else dict(k_scales=ks[0], v_scales=vs[0])
        same = graph_equal(lambda: paged_flash_decode(q, kp[0], vp[0], tables,
                                                      pos, **kw))
        log(f"[kernels] paged_decode {label} D224 pool replayed from a CUDA "
            f"graph: bitwise equal to an eager call {same}")
        if not same:
            raise AssertionError(f"paged_decode ({label} D224): a graph "
                                 f"replay differs from an eager call")
        rows.append(check_paged(gen, dtype, f"{label} D224", HYBRID_ATTN,
                                L=4))
    errs = {label: _ssd_compare(gen, f"N64 {label}", shape, chunk)
            for label, shape, chunk in HYBRID_SSD_CASES}
    for label, shape, chunk in HYBRID_SSD_CASES[:2]:
        x, a, Bm, Cm, h0 = _ssd_case(gen, **shape)
        same = graph_equal(lambda: ssd_scan(x, a, Bm, Cm, chunk, h0=h0))
        log(f"[kernels] ssd_scan N64 {label} replayed from a CUDA graph: "
            f"bitwise equal to an eager call {same}")
        if not same:
            raise AssertionError(f"ssd_scan (N64 {label}): a graph replay "
                                 f"differs from an eager call")
    _, shape, chunk = HYBRID_SSD_CASES[0]
    t = ssd_timings(gen, shape, chunk, plain=True, graph=True)
    row = {"name": "ssd_scan[N64]", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:82",
           "shape": f"x ({shape['B']}, {shape['S']}, {shape['H']}, 64) "
                    f"bf16, B/C G {shape['G']} N {shape['N']}, chunk {chunk}",
           "timing": f"cold L2: cycles over {t['copies']} input copies; "
                     f"{TIMING}; {GRAPH_TIMING}",
           "max_abs_err": errs["serve"],
           "tol": f"y {SSD_Y_TOL} of max |y|, state {SSD_H_TOL} of "
                  f"max |h|",
           "ms": t["ms"], "device_ms": t["device_ms"],
           "graph_ms": t["graph_ms"], "passes_ms": t["passes"],
           "plain_ms": t["plain_ms"], "library_ms": None,
           "library_device_ms": None,
           "library_note": "no single PyTorch call computes the SSD scan"}
    row["bound_ms"], row["bound_by"] = bound(t["bytes"], t["ops"], "bf16")
    log(f"[kernels] ssd_scan[N64] serve: kernel {row['ms']:.4f} ms (device "
        f"time {row['device_ms']:.4f} ms, replayed from a graph "
        f"{row['graph_ms']:.4f} ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in t["passes"].items())
        + f" ms under the profiler), plain {row['plain_ms']:.4f} ms, "
        f"library none, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
        f"{t['bytes'] / 1e6:.1f} MB, {t['ops'] / 1e9:.2f} GFLOP)")
    rows.append(row)
    for r in rows:
        r["model"] = "zamba2-7b"
    return rows


def _prefill_compare(gen, B, S, H, KV, D, valid_len, window=0):
    """The prefill kernel with its log-sum-exp against its plain version at
    one more serving shape (rows of ``valid_len`` valid keys; a local
    ``window`` or none), at ``ATTN_TOL`` and ``LSE_TOL``; logged."""
    from repro_torch.kernels.flash_attention import (flash_prefill,
                                                     flash_prefill_ref)
    q, k, v = (torch.randn(B, S, heads, D, generator=gen,
                           device="cuda").bfloat16()
               for heads in (H, KV, KV))
    vl = torch.tensor(valid_len, dtype=torch.int32, device="cuda")
    _check_fwd_lse(f"B {B} S {S} H {H} KV {KV} D {D}, window {window}, "
                   f"valid_len {valid_len}",
                   *flash_prefill(q, k, v, vl, window=window,
                                  return_lse=True),
                   *flash_prefill_ref(q, k, v, vl, window=window,
                                      return_lse=True))


def _paged_graph_and_rows(gen, attn, tag, L):
    """Paged decode at ``attn`` on bf16 and int8 pools: a CUDA graph replay
    bitwise equal to an eager call, then ``check_paged`` (the serving
    positions twice, bitwise equal; the split and page edges, a parked
    slot, a window, softcap, B 1; timed over ``L`` layers' pools).
    Returns the two rows, ``paged_decode[<tag> bf16]`` and ``[<tag>
    int8]``."""
    from repro_torch.kernels.flash_attention import paged_flash_decode
    rows = []
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
        q, kp, vp, tables, pos, ks, vs = _paged_case(gen, dtype, L=1, **attn)
        kw = {} if ks is None else dict(k_scales=ks[0], v_scales=vs[0])
        same = graph_equal(lambda: paged_flash_decode(q, kp[0], vp[0], tables,
                                                      pos, **kw))
        log(f"[kernels] paged_decode {label} {tag} pool replayed from a CUDA "
            f"graph: bitwise equal to an eager call {same}")
        if not same:
            raise AssertionError(f"paged_decode ({label} {tag}): a graph "
                                 f"replay differs from an eager call")
        rows.append(check_paged(gen, dtype, f"{tag} {label}", attn, L=L))
    return rows


def _rmsnorm_width(gen, d: int):
    """RMSNorm at one model's width: ``_rmsnorm_row`` at the prefill shape
    (4096, d) (its JSON row, ``rmsnorm[<d>]``), the plain version at 13
    rows (a grid whose last block holds one row), and the decode shape
    (8, d) timed beside ``F.rms_norm``, logged."""
    row, ok = _rmsnorm_row(gen, SERVE_SLOTS * 512, d, f"rmsnorm[{d}]")
    if not (_rmsnorm_compare(gen, 13, d)[0] and ok):
        raise AssertionError(f"rmsnorm kernel at d {d} disagrees with its "
                             f"plain version")
    tt, (_, _, nc) = rmsnorm_timings(gen, SERVE_SLOTS, d)
    b_ms, _ = bound(2 * SERVE_SLOTS * d * 2 + d * 4, 4 * SERVE_SLOTS * d,
                    "f32")
    log(f"[kernels] rmsnorm x ({SERVE_SLOTS}, {d}) bf16 ({nc} input "
        f"copies): {versus('kernel', tt, 'F.rms_norm')}; bound {b_ms:.4f} ms")
    return row


#: the kernel rows of gpt3-xl's instantiations: the run whose launches each
#: reports (``phase_serve_gpt3``'s runs by page type, or its training run)
GPT3_ROW_RUNS = {"flash_prefill[D128]": "bf16",
                 "paged_decode[D128G1 bf16]": "bf16",
                 "paged_decode[D128G1 int8]": "int8",
                 "flash_prefill_lse[D128]": "train",
                 "flash_bwd[D128]": "train",
                 "flash_prefill_lse[D128 B4]": "rank",
                 "flash_bwd[D128 B4]": "rank",
                 "flash_prefill_lse[D128 H8 tp2]": "tp",
                 "flash_bwd[D128 H8 tp2]": "tp"}


def check_gpt3_kernels(gen):
    """gpt3-xl's instantiations of the three attention kernels (head_dim
    128, one query head per KV head, 16 heads), each against its plain
    version and twice (bitwise equal), timed (``ms``, ``device_ms``, and
    ``graph_ms`` on the serving path) beside its bound and library
    yardstick: the prefill over the buckets 32, 128 and 512 with ragged
    rows, one slot of an odd length (B 1, S 77, 45 valid keys) and a window
    over rows with no valid key; the training forward with its
    log-sum-exp and the flash backward at gpt3-xl's micro-batch (B 8,
    S 1024), and both at S 200 and at B 1, S 77, and at the data-parallel
    rank's micro-batch (B 4, S 1024; rows ``[D128 B4]``, launched by
    ``phase_transfer_gpt3``), and at a (2, 2) rank's shape, B 4, S 1024 and
    8 heads (rows ``[D128 H8 tp2]``, launched by ``phase_multidevice``);
    paged decode on bf16 and
    int8 pools with ``check_paged``'s edges (split and page edges, a parked
    slot, a window, softcap, B 1), replayed from a CUDA graph bitwise equal
    to eager.  Returns the JSON rows named in ``GPT3_ROW_RUNS``, each marked
    with the model."""
    H, KV, D = GPT3_ATTN["H"], GPT3_ATTN["KV"], GPT3_ATTN["D"]
    for S in (32, 128, 512):
        row = _prefill_row(gen, SERVE_SLOTS, S, H, KV, D,
                           "flash_prefill[D128]", graph=True,
                           backend=S == 512)
    rows = [row]                       # the longest bucket
    _prefill_compare(gen, 1, 77, H, KV, D, [45])
    check_prefill_padded_window(gen, H, KV, D)
    rows += check_flash_bwd(gen, **GPT3_ATTN,
                            edges=((2, 200, H, KV), (1, 77, H, KV)),
                            tag="[D128]", B=GPT3_BATCH // GPT3_ACCUM)
    rows += check_flash_bwd(gen, **GPT3_ATTN, edges=(), tag="[D128 B4]",
                            B=GPT3_BATCH // GPT3_RANK_DP // GPT3_ACCUM)
    tp = GPT3_ATTN["H"] // MD_MESH[1]
    rows += check_flash_bwd(gen, H=tp, KV=tp, D=D, edges=(),
                            tag=f"[D128 H{tp} tp{MD_MESH[1]}]",
                            B=MD_BATCH // MD_MESH[0])
    rows += _paged_graph_and_rows(gen, GPT3_ATTN, "D128G1", L=4)
    for r in rows:
        r["model"] = "gpt3-xl"
    return rows


#: the kernel rows of llama3.2-3b's instantiations: the run whose launches
#: each reports (``phase_serve_llama3b``'s runs by page type, or its
#: training run)
LLAMA3B_ROW_RUNS = {"flash_prefill[D128G3]": "bf16",
                    "paged_decode[D128G3 bf16]": "bf16",
                    "paged_decode[D128G3 int8]": "int8",
                    "flash_prefill_lse[D128G3]": "train",
                    "flash_bwd[D128G3]": "train",
                    "rmsnorm[3072]": "bf16"}


def check_llama3b_kernels(gen):
    """llama3.2-3b's instantiations (head_dim 128 with 3 query heads per KV
    head: 24 heads over 8; RMSNorm at d 3072), each against its plain
    version and twice (bitwise equal), timed as gpt3-xl's are beside its
    bound and library yardstick: the prefill over the buckets 32, 128 and
    512 with ragged rows (its row at B 8, S 512), B 1 at S 77 and B 2 at
    S 200 with ragged rows, and a window over rows with no valid key; the
    training forward with its log-sum-exp and the backward at the training
    micro-batch (B 2, S 1024), and both at S 200 and B 1, S 77; paged
    decode on bf16 and int8 pools at the serving positions with
    ``check_paged``'s edges, replayed from a CUDA graph bitwise equal to
    eager; RMSNorm at d 3072 (``_rmsnorm_width``).  Returns the JSON rows
    named in ``LLAMA3B_ROW_RUNS``, each marked with the model."""
    H, KV, D = LLAMA3B_ATTN["H"], LLAMA3B_ATTN["KV"], LLAMA3B_ATTN["D"]
    for S in (32, 128, 512):
        row = _prefill_row(gen, SERVE_SLOTS, S, H, KV, D,
                           "flash_prefill[D128G3]", graph=True,
                           backend=S == 512)
    rows = [row]                       # the longest bucket
    _prefill_compare(gen, 1, 77, H, KV, D, [45])
    _prefill_compare(gen, 2, 200, H, KV, D, [200, 131])
    check_prefill_padded_window(gen, H, KV, D)
    rows += check_flash_bwd(gen, **LLAMA3B_ATTN,
                            edges=((2, 200, H, KV), (1, 77, H, KV)),
                            tag="[D128G3]", B=TRAIN_BATCH // LLAMA3B_ACCUM)
    rows += _paged_graph_and_rows(gen, LLAMA3B_ATTN, "D128G3", L=4)
    rows.append(_rmsnorm_width(gen, 3072))
    for r in rows:
        r["model"] = "llama3.2-3b"
    return rows


#: the kernel rows of internvl2-1b's instantiations: the run whose launches
#: each reports (``phase_serve_vlm``'s runs by page type, or its training
#: run)
VLM_ROW_RUNS = {"flash_prefill[D64G7]": "bf16",
                "paged_decode[D64G7 bf16]": "bf16",
                "paged_decode[D64G7 int8]": "int8",
                "flash_prefill_lse[D64G7]": "train",
                "flash_bwd[D64G7]": "train",
                "rmsnorm[896]": "bf16"}


def check_vlm_kernels(gen):
    """internvl2-1b's instantiations (head_dim 64 with 7 query heads per KV
    head: 14 heads over 2; RMSNorm at d 896), each against its plain
    version and twice (bitwise equal), timed as llama3.2-3b's are beside
    its bound and library yardstick: the prefill at its serving shapes,
    the 256 patch rows before a prompt bucket of 32, 128 and 512 (S 288,
    384, 768; its row at B 8, S 768) with ragged rows, B 1 at S 333 and a
    window over rows with no valid key (the 14 heads are 14 blocks of the
    grid's head axis, no tiling over heads); the training forward with its
    log-sum-exp and the backward at the micro-batch (B 4, S 1024: 256 patch
    rows and 768 text tokens), and both at S 200 and B 1, S 77; paged
    decode on bf16 and int8 pools with ``check_paged``'s edges, replayed
    from a CUDA graph bitwise equal to eager; RMSNorm at d 896, its last
    16-byte chunk on 16 lanes (``_rmsnorm_width``).  Returns the JSON rows
    named in ``VLM_ROW_RUNS``, each marked with the model."""
    H, KV, D = VLM_ATTN["H"], VLM_ATTN["KV"], VLM_ATTN["D"]
    for S in (32, 128, 512):
        row = _prefill_row(gen, SERVE_SLOTS, VLM_PREFIX + S, H, KV, D,
                           "flash_prefill[D64G7]", graph=True,
                           backend=S == 512)
    rows = [row]                       # the longest bucket
    _prefill_compare(gen, 1, VLM_PREFIX + 77, H, KV, D, [VLM_PREFIX + 45])
    check_prefill_padded_window(gen, H, KV, D)
    rows += check_flash_bwd(gen, **VLM_ATTN,
                            edges=((2, 200, H, KV), (1, 77, H, KV)),
                            tag="[D64G7]")
    rows += _paged_graph_and_rows(gen, VLM_ATTN, "D64G7", L=16)
    rows.append(_rmsnorm_width(gen, 896))
    for r in rows:
        r["model"] = VLM_ARCH
    return rows


#: the kernel rows of yi-34b's instantiations: the run whose launches each
#: reports (``phase_serve_yi``'s runs by page type)
YI_ROW_RUNS = {"flash_prefill[D128G7]": "bf16",
               "paged_decode[D128G7 bf16]": "bf16",
               "paged_decode[D128G7 int8]": "int8"}


def check_yi_kernels(gen):
    """yi-34b's instantiations (head_dim 128 with 7 query heads per KV
    head: 56 heads over 8), each against its plain version and twice
    (bitwise equal), timed beside its bound and library yardstick: the
    prefill over the buckets 32, 512 and 128 with ragged rows (its row at
    yi's serving bucket, B 8, S 128), B 1 at S 77, B 2 at S 200 with ragged
    rows and a window over rows with no valid key, each with its
    log-sum-exp checked; paged decode on bf16 and int8 pools with
    ``check_paged``'s edges, replayed from a CUDA graph bitwise equal to
    eager.  The backward is not built at (128, 7) (no path trains yi-34b):
    a call on the card raises.  Returns the JSON rows named in
    ``YI_ROW_RUNS``, each marked with the model."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    H, KV, D = YI_ATTN["H"], YI_ATTN["KV"], YI_ATTN["D"]
    for S in (32, 512, 128):
        row = _prefill_row(gen, SERVE_SLOTS, S, H, KV, D,
                           "flash_prefill[D128G7]", graph=True,
                           backend=S == 128)
    rows = [row]                       # yi's serving bucket
    _prefill_compare(gen, 1, 77, H, KV, D, [45])
    _prefill_compare(gen, 2, 200, H, KV, D, [200, 131])
    check_prefill_padded_window(gen, H, KV, D)
    q = torch.zeros(1, 64, H, D, dtype=torch.bfloat16, device="cuda")
    kv = torch.zeros(1, 64, KV, D, dtype=torch.bfloat16, device="cuda")
    lse = torch.zeros(1, H, 64, device="cuda")
    try:
        flash_attention_bwd(q, kv, kv, q, q, lse)
    except ValueError as e:
        log(f"[kernels] flash_bwd at (128, 7) refused on the card: {e}")
    else:
        raise AssertionError("flash_bwd ran at head_dim 128 with 7 query "
                             "heads per KV head, which it is not built for")
    rows += _paged_graph_and_rows(gen, YI_ATTN, "D128G7", L=4)
    for r in rows:
        r["model"] = YI_ARCH
    return rows


def _nc_prefill_row(gen, B, Sq, Sk, H, KV, D, name, graph=False):
    """The prefill kernel without the causal mask, ``Sq`` queries over
    ``Sk`` keys, every key valid (an encoder's self-attention at Sq == Sk;
    a decoder's cross-attention, a prompt bucket over the encoder's
    frames), against its plain version with its log-sum-exp and twice
    (bitwise equal), timed beside SDPA without a mask (``graph``: graph_ms
    too) and its bound.  Raises on a disagreement; returns the JSON row."""
    from repro_torch.kernels.flash_attention import (flash_prefill,
                                                     flash_prefill_ref)
    shape = _attn_shape(B, Sq, Sk, H, KV, D, False)
    n = n_copies(2 * B * (Sq * H + 2 * Sk * KV) * D)
    cases = [(torch.randn(B, Sq, H, D, generator=gen,
                          device="cuda").bfloat16(),
              *(torch.randn(B, Sk, KV, D, generator=gen,
                            device="cuda").bfloat16() for _ in range(2)))
             for _ in range(n)]
    q, k, v = cases[0]
    got, lse = flash_prefill(q, k, v, causal=False, return_lse=True)
    err, lse_err = _check_fwd_lse(
        f"{name} {shape}", got, lse,
        *flash_prefill_ref(q, k, v, causal=False, return_lse=True))
    same = torch.equal(got, flash_prefill(q, k, v, causal=False))
    log(f"[kernels] {name} {shape}: two calls bitwise equal {same}")
    if not same:
        raise AssertionError(f"{name} kernel is not deterministic")

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True)
    t = both_times(cycled(lambda q, k, v: flash_prefill(q, k, v,
                                                        causal=False),
                          cases), cycled(sdpa, cases), max(20, n),
                   graph=graph)
    kv_shape = f"kv {KV} heads" if Sq == Sk else f"kv ({B}, {Sk}, {KV})"
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:125",
           "shape": f"q ({B}, {Sq}, {H}, {D}) {kv_shape} bf16, non-causal",
           "timing": f"cold L2: cycles over {n} input copies; {TIMING}"
                     + (f"; {GRAPH_TIMING}" if graph else ""),
           "max_abs_err": max(err, lse_err), "tol": ATTN_TOL,
           "ms": t["ms"], "device_ms": t["device_ms"],
           "plain_ms": time_ms(cycled(
               lambda q, k, v: flash_prefill_ref(q, k, v, causal=False),
               cases), iters=5),
           "library_ms": t["library_ms"],
           "library_device_ms": t["library_device_ms"]}
    if graph:
        row.update(graph_ms=t["graph_ms"],
                   library_graph_ms=t["library_graph_ms"])
    # bytes: q read, out written, K and V read, the valid lengths; 2
    # products of 2 D flops per (query, key) pair, every pair admitted
    row["bound_ms"], row["bound_by"] = bound(
        2 * (2 * B * Sq * H * D + 2 * B * Sk * KV * D) + B * 4,
        4 * D * B * H * Sq * Sk, "bf16")
    log(f"[kernels] {name} {shape}: {versus('kernel', t, 'SDPA')}; plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


#: the kernel rows of seamless-m4t-medium's calls: the run whose launches
#: each reports (``phase_serve_encdec``'s runs by page type, or its
#: training run)
ENCDEC_ROW_RUNS = {"flash_prefill[enc D64G1 nc]": "bf16",
                   "flash_prefill[cross]": "bf16",
                   "paged_decode[D64G1 bf16]": "bf16",
                   "paged_decode[D64G1 int8]": "int8",
                   "flash_prefill_lse[enc]": "train",
                   "flash_bwd[enc nc]": "train",
                   "flash_prefill_lse[cross]": "train",
                   "flash_bwd[cross]": "train"}


def check_encdec_kernels(gen):
    """seamless-m4t-medium's calls (16 heads over 16 at head_dim 64), each
    against its plain version and twice (bitwise equal), timed beside its
    bound and library yardstick (SDPA without a mask; over the pages in
    use for paged decode): the prefill without the causal mask at the
    encoder's serving shape (B 8, S = F = 1024; row ``flash_prefill[enc
    D64G1 nc]``) and at the cross-attention's, a prompt bucket of 32 and
    512 text positions over 1024 frames (row ``flash_prefill[cross]`` at
    512), then 37 positions (a partial 64-row tile) and a ragged valid
    length without the mask, logged; the training forward with its
    log-sum-exp and the backward without the mask at the encoder's
    micro-batch (B 4, S 1024; rows ``flash_prefill_lse[enc]``,
    ``flash_bwd[enc nc]``) and at the cross-attention's (B 4, Sq 512 over
    Sk 1024; rows ``flash_prefill_lse[cross]``, ``flash_bwd[cross]``), with
    edges at S 200, Sq 37 and 300 over 1024 and 77 keys, and at head_dim
    128 (the wide kernels, logged); paged decode at head_dim 64 with one
    query head per KV head on bf16 and int8 pools with ``check_paged``'s
    edges, replayed from a CUDA graph bitwise equal to eager (rows
    ``paged_decode[D64G1 bf16]``, ``[D64G1 int8]``).  Returns the JSON rows
    named in ``ENCDEC_ROW_RUNS``, each marked with the model."""
    from repro_torch.kernels.flash_attention import (flash_prefill,
                                                     flash_prefill_ref)
    H, KV, D = ENCDEC_ATTN["H"], ENCDEC_ATTN["KV"], ENCDEC_ATTN["D"]
    Fr, B = ENCDEC_FRAMES, SERVE_SLOTS
    rows = [_nc_prefill_row(gen, B, Fr, Fr, H, KV, D,
                            "flash_prefill[enc D64G1 nc]", graph=True)]
    for Sq in (32, 512):
        row = _nc_prefill_row(gen, B, Sq, Fr, H, KV, D,
                              "flash_prefill[cross]", graph=True)
    rows.append(row)                   # the longest bucket
    q = torch.randn(2, 37, H, D, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(2, Fr, KV, D, generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    _check_fwd_lse(f"{_attn_shape(2, 37, Fr, H, KV, D, False)} (a partial "
                   f"query tile)",
                   *flash_prefill(q, k, v, causal=False, return_lse=True),
                   *flash_prefill_ref(q, k, v, causal=False,
                                      return_lse=True))
    vl = torch.tensor([Fr, 300], dtype=torch.int32, device="cuda")
    _check_fwd_lse(f"{_attn_shape(2, 37, Fr, H, KV, D, False)}, valid_len "
                   f"{vl.tolist()}",
                   *flash_prefill(q, k, v, vl, causal=False,
                                  return_lse=True),
                   *flash_prefill_ref(q, k, v, vl, causal=False,
                                      return_lse=True))
    fwd, bwd = check_flash_bwd(gen, **ENCDEC_ATTN, causal=False,
                               edges=((2, 200, H, KV),), tag="[enc]")
    bwd["name"] = "flash_bwd[enc nc]"
    rows += [fwd, bwd]
    rows += check_flash_bwd(gen, **ENCDEC_ATTN, causal=False, Sq=ENCDEC_TEXT,
                            Sk=Fr, tag="[cross]",
                            edges=((2, 37, H, KV, Fr), (1, 300, H, KV, 77)))
    # the wide kernels' masks without the causal mask at Sq != Sk (no
    # path runs them so; checked so that the wrapper's gate holds there)
    _check_bwd_edge(gen, 1, 77, 16, 16, 128, False, 200)
    rows += _paged_graph_and_rows(gen, ENCDEC_ATTN, "D64G1", L=16)
    for r in rows:
        r["model"] = ENCDEC_ARCH
    return rows


#: the kernel rows of llama4-scout's instantiations: the run whose launches
#: each reports (``phase_serve_llama4``'s runs by page type, its long
#: traffic's run, or the card smoke config's training run)
LLAMA4_ROW_RUNS = {"flash_prefill[D128G5 w8192]": "long",
                   "paged_decode[D128G5 bf16]": "bf16",
                   "paged_decode[D128G5 int8]": "int8",
                   "rmsnorm[5120]": "bf16",
                   "flash_bwd[D64G2 w32]": "train"}


def check_llama4_kernels(gen):
    """llama4-scout's instantiations (head_dim 128 with 5 query heads per
    KV head: 40 heads over 8; RMSNorm at d 5120; the windowed backward of
    its card smoke config), each against its plain version and twice
    (bitwise equal), timed beside its bound and library yardstick: the
    prefill with the local window of 8192 at the short traffic's bucket
    (B 8, S 512: the window past every key), over ragged rows whose valid
    lengths straddle a window of 100 (B 3, S 300: partial tiles, padded
    rows whose window holds no valid key) and at the long traffic's bucket
    (B 4, S 16384, the four prompts' lengths: its JSON row, SDPA with the
    window as an explicit mask); paged decode at (128, 5) on bf16 and
    int8 pools with ``check_paged``'s edges, replayed from a CUDA graph
    bitwise equal to eager; RMSNorm at (4096, 5120); the forward with its
    log-sum-exp and the backward with window 32 at B 2, S 1024 (4 heads
    over 2 at head_dim 64), and at window 256, at S 77 and 200 (partial
    tiles), a window of 40 that begins mid-tile, and the launcher's S 64.
    The backward is not built at (128, 5): no path trains llama4-scout at
    full width.  Returns the JSON rows named in ``LLAMA4_ROW_RUNS``, each
    marked with the model."""
    H, KV, D = LLAMA4_ATTN["H"], LLAMA4_ATTN["KV"], LLAMA4_ATTN["D"]
    window = 8192
    _prefill_compare(gen, SERVE_SLOTS, 512, H, KV, D,
                     [int(x) for x in np.linspace(24, 512, SERVE_SLOTS)],
                     window)
    _prefill_compare(gen, 3, 300, H, KV, D, [300, 150, 40], 100)
    check_prefill_padded_window(gen, H, KV, D)
    rows = [_prefill_row(gen, LONG_SLOTS, LONG_MAX_SEQ, H, KV, D,
                         "flash_prefill[D128G5 w8192]", window=window,
                         valid_len=LONG_PROMPTS, plain_block=512)]
    release()
    rows += _paged_graph_and_rows(gen, LLAMA4_ATTN, "D128G5", L=2)
    rows.append(_rmsnorm_width(gen, 5120))
    sw = SMOKE_LOCAL["window"]
    fwd, bwd = check_flash_bwd(
        gen, H=SMOKE_LOCAL["H"], KV=SMOKE_LOCAL["KV"], D=SMOKE_LOCAL["D"],
        B=2, Sq=1024, window=sw, tag=f"[D64G2 w{sw}]",
        edges=((2, 1024, 4, 2, None, 256), (2, 77, 4, 2, None, sw),
               (2, 200, 4, 2, None, sw), (1, 200, 4, 2, None, 40),
               (2, 64, 4, 2, None, sw)))
    log(f"[kernels] {fwd['name']} (logged): kernel {fwd['ms']:.4f} ms, "
        f"plain {fwd['plain_ms']:.4f} ms, library {fwd['library_ms']:.4f} "
        f"ms, bound {fwd['bound_ms']:.4f} ms")
    rows.append(bwd)
    for r in rows:
        r["model"] = LLAMA4_ARCH
    return rows


#: the kernel rows of nemotron-4-340b's instantiations: the run whose
#: launches each reports (``phase_serve_nemotron``'s runs by page type)
NEMO_ROW_RUNS = {"flash_prefill[D192G12]": "bf16",
                 "paged_decode[D192G12 bf16]": "bf16",
                 "paged_decode[D192G12 int8]": "int8"}


def check_nemotron_kernels(gen):
    """nemotron-4-340b's instantiations (head_dim 192 with 12 query heads
    per KV head: 96 heads over 8), each against its plain version and
    twice (bitwise equal), timed beside its bound and library yardstick:
    the prefill over the buckets 32, 128 and 512 with ragged rows (its row
    at B 8, S 512), B 1 at S 77, B 2 at S 200 with ragged rows and a
    window over rows with no valid key, each with its log-sum-exp; paged
    decode on bf16 and int8 pools (its 12 rows a KV head in 3 blocks of 4)
    with ``check_paged``'s edges, replayed from a CUDA graph bitwise equal
    to eager.  Returns the JSON rows named in ``NEMO_ROW_RUNS``, each
    marked with the model."""
    H, KV, D = NEMO_ATTN["H"], NEMO_ATTN["KV"], NEMO_ATTN["D"]
    for S in (32, 128, 512):
        row = _prefill_row(gen, SERVE_SLOTS, S, H, KV, D,
                           "flash_prefill[D192G12]", graph=True,
                           backend=S == 512)
    rows = [row]                       # the longest bucket
    _prefill_compare(gen, 1, 77, H, KV, D, [45])
    _prefill_compare(gen, 2, 200, H, KV, D, [200, 131])
    check_prefill_padded_window(gen, H, KV, D)
    rows += _paged_graph_and_rows(gen, NEMO_ATTN, "D192G12", L=4)
    for r in rows:
        r["model"] = NEMO_ARCH
    return rows


def check_md_kernels(gen):
    """The attention kernels at the (2, 2) ranks' shapes of the
    multidevice phase, each against its plain version and timed beside its
    bound and library yardstick: granite-moe-1b-a400m's training forward
    with its log-sum-exp and the flash backward at a rank's 8 query heads
    over 4 KV heads and 4 rows of 1024 (rows ``[D64 H8 tp2]``), and
    llama3.2-1b's prefill at a rank's 16 heads over 4 and 4 prompts of
    ``MD_SERVE_PROMPT`` (row ``[D64 H16 tp2]``); then the shapes of
    ``MD_FAMILIES``' ranks, their train steps' and their prefills'.
    Returns the rows named in ``MD_ROW_RUNS``, marked with the phase."""
    rows = list(check_flash_bwd(gen, H=8, KV=4, D=64, edges=(),
                                tag="[D64 H8 tp2]",
                                B=MD_BATCH // MD_MESH[0]))
    rows.append(_prefill_row(
        gen, MD_SERVE_SLOTS // MD_MESH[0], MD_SERVE_PROMPT, 32 // MD_MESH[1],
        8 // MD_MESH[1], 64, "flash_prefill[D64 H16 tp2]",
        valid_len=[MD_SERVE_PROMPT] * (MD_SERVE_SLOTS // MD_MESH[0])))
    # the SSM, hybrid and encoder-decoder families' rank shapes
    # (``MD_FAMILIES``' train steps): mamba2-370m's 16 of 32 heads (N 128),
    # zamba2-7b's 56 of 112 heads, which read one of its 2 B/C groups (G
    # 1, N 64), and its shared block's 16 of 32 heads at head_dim 224;
    # seamless-m4t-medium's 8 of 16 heads, its encoder over the frames and
    # its cross-attention from the text over them, without the causal mask
    dp, tp = MD_MESH
    mamba, zamba, seamless = (MD_FAMILIES[a] for a in (
        "mamba2-370m", "zamba2-7b", "seamless-m4t-medium"))
    rows.append(_ssd_row(gen, "ssd_scan[H16 N128 tp2]", dict(
        B=mamba["train"][0] // dp, S=mamba["train"][1], H=32 // tp, G=1)))
    rows.append(_ssd_row(gen, "ssd_scan[H56 N64 G1 tp2]", dict(
        B=zamba["train"][0] // dp, S=zamba["train"][1],
        H=HYBRID_SSD["H"] // tp, G=1, N=HYBRID_SSD["N"])))
    H = HYBRID_ATTN["H"] // tp
    rows += check_flash_bwd(gen, H=H, KV=H, D=HYBRID_ATTN["D"], edges=(),
                            tag="[D224 H16 tp2]", B=zamba["train"][0] // dp,
                            Sq=zamba["train"][1])
    H = ENCDEC_ATTN["H"] // tp
    B, text = seamless["train"][0] // dp, seamless["train"][1]
    rows += check_flash_bwd(gen, H=H, KV=H, D=64, causal=False, edges=(),
                            tag="[enc D64 H8 tp2]", B=B, Sq=MD_FAM_FRAMES)
    rows += check_flash_bwd(gen, H=H, KV=H, D=64, causal=False, edges=(),
                            tag="[cross D64 H8 tp2]", B=B, Sq=text,
                            Sk=MD_FAM_FRAMES)
    # seamless's causal decoder self-attention in its train step, and the
    # sharded prefills' calls without the log-sum-exp: zamba2-7b's shared
    # block over its prompts of 1023 (a partial tile), seamless's encoder
    # over the frames, its decoder self-attention and its cross-attention
    # from prompts of 511 over the frames
    rows += check_flash_bwd(gen, H=H, KV=H, D=64, edges=(),
                            tag="[dec D64 H8 tp2]", B=B, Sq=text)
    Hz, Bz, n = HYBRID_ATTN["H"] // tp, zamba["slots"] // dp, zamba["prompt"]
    rows.append(_prefill_row(gen, Bz, n, Hz, Hz, HYBRID_ATTN["D"],
                             "flash_prefill[D224 H16 tp2]",
                             valid_len=[n] * Bz))
    B, n = seamless["slots"] // dp, seamless["prompt"]
    rows.append(_nc_prefill_row(gen, B, MD_FAM_FRAMES, MD_FAM_FRAMES, H, H,
                                64, "flash_prefill[enc D64 H8 tp2]"))
    rows.append(_prefill_row(gen, B, n, H, H, 64,
                             "flash_prefill[dec D64 H8 tp2]",
                             valid_len=[n] * B))
    rows.append(_nc_prefill_row(gen, B, n, MD_FAM_FRAMES, H, H, 64,
                                "flash_prefill[cross D64 H8 tp2]"))
    for r in rows:
        r["model"] = "multidevice"
    return rows


def _ssd_row(gen, name, shape):
    """The SSD scan at one shape against its plain version (twice, bitwise
    equal) and timed (cold L2) beside its bound; its JSON row."""
    err = _ssd_compare(gen, name, shape, SSD_CHUNK)
    t = ssd_timings(gen, shape, SSD_CHUNK, plain=True)
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:82",
           "shape": f"x ({shape['B']}, {shape['S']}, {shape['H']}, 64) "
                    f"bf16, B/C G {shape['G']} N {shape.get('N', 128)}, "
                    f"chunk {SSD_CHUNK}",
           "timing": f"cold L2: cycles over {t['copies']} input copies; "
                     f"{TIMING}",
           "max_abs_err": err,
           "tol": f"y {SSD_Y_TOL} of max |y|, state {SSD_H_TOL} of "
                  f"max |h|",
           "ms": t["ms"], "device_ms": t["device_ms"],
           "passes_ms": t["passes"], "plain_ms": t["plain_ms"],
           "library_ms": None, "library_device_ms": None,
           "library_note": "no single PyTorch call computes the SSD scan"}
    row["bound_ms"], row["bound_by"] = bound(t["bytes"], t["ops"], "bf16")
    log(f"[kernels] {name}: kernel {row['ms']:.4f} ms (device time "
        f"{row['device_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
        f"library none, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    check_graph_replays(gen)
    rows = [check_rmsnorm(gen), check_prefill(gen),
            check_paged(gen, torch.bfloat16, "bf16"),
            check_paged(gen, torch.int8, "int8"), check_group2_kernels(gen),
            *check_flash_bwd(gen), check_ssd(gen),
            *check_hybrid_kernels(gen)]
    # zamba2-7b's training attention: head_dim 224, one query head per KV
    # head; its forward with lse is checked and logged, its backward row
    # goes in the JSON
    rows.append(check_flash_bwd(gen, **HYBRID_ATTN,
                                edges=((2, 200, 32, 32),), tag="[D224]")[1])
    rows[-1]["model"] = "zamba2-7b"
    rows += check_gpt3_kernels(gen)
    rows += check_llama3b_kernels(gen)
    rows += check_vlm_kernels(gen)
    rows += check_yi_kernels(gen)
    rows += check_encdec_kernels(gen)
    rows += check_llama4_kernels(gen)
    rows += check_nemotron_kernels(gen)
    rows += check_md_kernels(gen)
    # pools the serving path does not use: checked, logged, not in the JSON
    for dtype, label in ((torch.float8_e4m3fn, "fp8"), (torch.float32, "f32")):
        r = check_paged(gen, dtype, label)
        log(f"[kernels] {r['name']} (not on the serving path): "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{_ms(r['library_ms'])}, bound {r['bound_ms']:.4f} ms")
    for r in rows:
        log(f"[kernels] {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {_ms(r['library_ms'])}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def _ms(t) -> str:
    """A time for a log line; None where no library call exists."""
    return "none" if t is None else f"{t:.4f} ms"


# ---------------------------------------------------------------------------
# 4. serve at full width
# ---------------------------------------------------------------------------

class NanWatch:
    """Delegates to the model and ORs a device flag whenever prefill or
    decode logits hold a NaN (``nan``), another for an infinity (``inf``);
    no host sync on the hot path."""

    def __init__(self, model):
        self.model = model
        self.nan = torch.zeros((), dtype=torch.bool, device=model.device)
        self.inf = torch.zeros((), dtype=torch.bool, device=model.device)

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _watch(self, logits):
        self.nan |= torch.isnan(logits).any()
        self.inf |= torch.isinf(logits).any()

    def prefill(self, *args, **kwargs):
        logits, cache = self.model.prefill(*args, **kwargs)
        self._watch(logits)
        return logits, cache

    def decode_step(self, *args, **kwargs):
        logits, cache = self.model.decode_step(*args, **kwargs)
        self._watch(logits)
        return logits, cache


def build_full_model(arch: str = "llama3.2-1b", layers=None):
    """A dense, MoE, VLM or encoder-decoder arch at full width and depth
    (``layers`` of its layers when given) with random weights from a
    seeded generator, in the compute dtype (serving)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    enc = f" (and {cfg.n_encoder_layers} encoder layers)" \
        if cfg.n_encoder_layers else ""
    log(f"[serve] {cfg.name}: L={cfg.n_layers}{enc} d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} D={cfg.resolved_head_dim} "
        f"ff={cfg.d_ff} V={cfg.vocab_size} {cfg.norm} norm, "
        f"{cfg.positional} positions, {cfg.activation} "
        f"{cfg.compute_dtype}; {n / 1e9:.3f}B params ({nbytes / 1e9:.2f} "
        f"GB) drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _n_buckets(prompts, max_seq: int = SERVE_MAX_SEQ) -> int:
    """Prompt buckets a workload admits (the engine's own rule)."""
    from repro_torch.serve.engine import _bucket
    return len({min(_bucket(len(p)), max_seq) for p in prompts})


def llama_launches(steps: int, calls: int, paged: bool = True,
                   layers: int = 16, every: int = 1,
                   norms: bool = True) -> dict:
    """llama3.2-1b's exact launch counts: 33 RMSNorms a forward (two a
    layer and the final one), 16 prefill attentions a prefill call, 16
    paged decodes a decode step with paged KV; ``layers`` for a config
    cut in depth (2 in ``card_smoke_config``).  A decoder whose last layer
    of each group of ``every`` is global and the others local
    (llama4-scout) launches a paged decode for each global layer only (the
    local layers' ring decode is plain PyTorch, as in the reference), the
    prefill attention for every layer; ``norms`` off: LayerNorm, which
    launches no kernel."""
    return {"rmsnorm": (2 * layers + 1) * (steps + calls) if norms else 0,
            "flash_prefill": layers * calls, "flash_bwd": 0,
            "paged_decode": layers // every * steps if paged else 0,
            "ssd_scan": 0}


def serve_run(tag, model, params, prompts, new_tokens, graphs, want,
              inspect=None, extras=None, slots=SERVE_SLOTS,
              max_seq=SERVE_MAX_SEQ, timed=True, also=None, **kw):
    """One ``ServeEngine`` (``cuda_graphs=graphs``, ``kw`` on top of the
    serving geometry) over ``prompts`` with ``new_tokens`` each (and
    ``extras[i]``, a dict of prefill inputs, on prompt i when given), timed
    after a warm-up and ``reset()``; ``inspect(engine)``, when given, adds
    its dict to the result after the timed run.  With graphs the warm-up is the same
    workload, so that every variant is captured before the timed run;
    without, one short request (with the first prompt's extras).  Gates,
    each raising: the exact launch counts ``want(steps, prefill calls)``
    of the timed run (and of the
    capturing run), every request finished, the capturing run's tokens
    equal the timed run's, no NaN logit, and
    ``compile_stats`` within the reference's bound (at most log2(max_chunk)
    + 1 decode chunk variants, at most one prefill variant a bucket the
    engine served, warm-up included).  ``slots`` and ``max_seq`` set the
    engine's geometry (the serve phases': 8 and 1024).  With graphs and
    ``timed`` off the capturing run is the only run (its tokens, launches
    and wall stand for the run's): for a cache type whose replay after
    ``reset()`` another run of the same model times.  ``also`` (n, new),
    with graphs: after the timed run the same engine serves the first n
    prompts again with ``new`` tokens each (``also_tokens``,
    ``also_wall_s``; exact launches), the requests ``onoff_run`` serves
    with graphs off for the on/off gate (``same_onoff``).
    Returns the runs' tokens, times, counts and graph statistics."""
    from repro_torch import kernels
    from repro_torch.serve import Request, ServeEngine
    mode = "graphs on" if graphs else "graphs off"
    torch.cuda.reset_peak_memory_stats()
    watch = NanWatch(model)
    eng = ServeEngine(watch, params, batch_slots=slots, max_seq=max_seq,
                      page_size=SERVE_PAGE, cuda_graphs=graphs, **kw)

    def requests(n=len(prompts), new=new_tokens):
        return [Request(uid=i, prompt=p, max_new_tokens=new,
                        extras=dict(extras[i]) if extras else {})
                for i, p in enumerate(prompts[:n])]

    def run(reqs):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernels.launch_counts()
        expect = want(eng.n_decode_steps, eng.n_prefill_calls)
        if got != expect:
            raise AssertionError(f"{tag} ({mode}): launch counts {got} != "
                                 f"{expect}")
        if not all(r.done and len(r.generated) == r.max_new_tokens
                   for r in reqs):
            raise AssertionError(f"{tag} ({mode}): not every request "
                                 f"finished")
        return wall, got, [r.generated for r in reqs]

    out, served = {}, list(prompts)
    if graphs and not timed:
        out["wall_s"], out["launches"], out["tokens"] = run(requests())
    else:
        if graphs:
            out["first_wall_s"], _, out["first_tokens"] = run(requests())
        else:
            served.append(prompts[0][:16])
            eng.generate([Request(uid=-1, prompt=served[-1],
                                  max_new_tokens=4,
                                  extras=dict(extras[0]) if extras else {})])
        eng.reset()
        out["wall_s"], out["launches"], out["tokens"] = run(requests())
        if graphs and out["first_tokens"] != out["tokens"]:
            raise AssertionError(f"{tag} ({mode}): the capturing run and "
                                 f"the replay after reset() gave different "
                                 f"tokens")
    steps, calls = eng.n_decode_steps, eng.n_prefill_calls
    if also is not None:
        eng.reset()
        out["also_wall_s"], _, out["also_tokens"] = run(requests(*also))
    if bool(watch.nan):
        raise AssertionError(f"{tag} ({mode}): NaN in the logits")
    stats = eng.compile_stats
    limit = int(math.log2(eng.max_chunk)) + 1
    if stats["decode_chunk_variants"] > limit or \
            stats["prefill_bucket_variants"] > _n_buckets(served, max_seq):
        raise AssertionError(f"{tag} ({mode}): compile_stats {stats} over "
                             f"the bound ({limit} decode chunk variants, "
                             f"{_n_buckets(served, max_seq)} buckets "
                             f"served)")
    if inspect is not None:
        out.update(inspect(eng))
    n_tok = sum(len(t) for t in out["tokens"])
    out.update(steps=steps, calls=calls, tokens_per_s=n_tok / out["wall_s"],
               compile_stats=stats, graphs=eng.graph_stats(),
               peak_bytes=torch.cuda.max_memory_allocated())
    first = "" if not graphs else (
        f" (the capturing run before it: {out['first_wall_s']:.3f} s)"
        if timed else " (the capturing run, captures included: not "
        "repeated)")
    log(f"[{tag}] {mode}: {n_tok} tokens in {out['wall_s']:.3f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s{first}; {out['calls']} prefill "
        f"calls, {out['steps']} decode steps "
        f"({1e3 * out['wall_s'] / out['steps']:.2f} ms of wall per step, "
        f"prefill included); launches {out['launches']} (exact); "
        f"compile_stats {stats}; peak memory "
        f"{out['peak_bytes'] / 2**30:.2f} GiB")
    if also is not None:
        log(f"[{tag}] {mode}: then the first {also[0]} requests with "
            f"{also[1]} new tokens each on the same engine (for the on/off "
            f"gate): {out['also_wall_s']:.3f} s, launches exact")
    if out["graphs"]:
        g = out["graphs"]
        log(f"[{tag}] {mode}: {len(g)} graphs, pool "
            f"{sum(x['pool_bytes'] for x in g) / 2**20:.1f} MiB; capture "
            f"host ms " + ", ".join(
                f"{x['kind']}[{x['key']}] {x['capture_ms']:.1f} "
                f"(x{x['replays']})" for x in g))
    del eng, watch
    release()
    return out


def _same_tokens(tag, what, runs):
    """Raise unless every run of ``runs`` (graphs on: the capturing run
    and the timed one; graphs off: the timed one) gave the same tokens."""
    streams = []
    for r in runs:
        streams += [r["tokens"]] + ([r["first_tokens"]]
                                    if "first_tokens" in r else [])
    if any(s != streams[0] for s in streams):
        raise AssertionError(f"{tag} {what}: different tokens")
    log(f"[{tag}] {what}: identical tokens ({len(streams)} runs)")


#: the graphs-on/off token gate's requests: the first ``SERVE_SLOTS``
#: prompts of a workload (one admission wave) with ``ONOFF_NEW_TOKENS`` new
#: tokens each, 31 decode steps through the chunks 16, 8, 4, 2 and 1, so
#: every decode graph a timed run replays is held against eager decode.
#: The graphs-on engine serves them after its timed run (``serve_run``'s
#: ``also``), a graphs-off engine serves them alone: whole token streams of
#: the same requests, at a fraction of an eager run over the workload.
ONOFF_NEW_TOKENS = 32
ONOFF = (SERVE_SLOTS, ONOFF_NEW_TOKENS)
#: the new tokens of a capturing run that stands alone on the on/off
#: gate's prompts (int8 pages, a dense cache): 15 decode steps through the
#: chunks 8, 4, 2 and 1.  No timed run replays such a run's 16-step chunk,
#: the dearest to capture (zamba2-7b's int8 run: 17.2 s at 32 tokens, 7.5
#: s at 16).
CAPTURE_NEW_TOKENS = 16


def onoff_run(tag, model, params, prompts, want, extras=None, **kw):
    """The graphs-off half of the on/off gate: ``serve_run`` over the
    first ``SERVE_SLOTS`` of ``prompts`` (and ``extras``) with
    ``ONOFF_NEW_TOKENS`` new tokens each."""
    n = SERVE_SLOTS
    return serve_run(tag, model, params, prompts[:n], ONOFF_NEW_TOKENS,
                     False, want, extras=None if extras is None
                     else extras[:n], **kw)


def same_onoff(tag, what, on, off):
    """Raise unless the graphs-on engine's ``also`` requests and the
    graphs-off run of the same requests gave the same tokens; log their
    tokens/s."""
    if on["also_tokens"] != off["tokens"]:
        raise AssertionError(f"{tag} {what}: graphs on and off gave "
                             f"different tokens")
    n_tok = sum(len(t) for t in off["tokens"])
    log(f"[{tag}] {what}: graphs on and off gave identical tokens "
        f"({len(off['tokens'])} requests, {ONOFF_NEW_TOKENS} new tokens "
        f"each); graphs on {n_tok / on['also_wall_s']:.1f} tokens/s against "
        f"off {off['tokens_per_s']:.1f} "
        f"({off['wall_s'] / on['also_wall_s']:.2f}x)")


def pages_of(run: str) -> str:
    """A serve run's page type as the kernel rows' ``launches_of`` name it:
    the int8 runs of the full-width models serve the on/off gate's
    requests (``ONOFF``)."""
    return f"{run} pages" + (
        f" ({SERVE_SLOTS} requests of {CAPTURE_NEW_TOKENS} new tokens)"
        if run == "int8" else "")


def serve_prompts(vocab: int, tag: str = "serve"):
    """The serve phases' ``SERVE_REQUESTS`` seeded prompts (24-498 tokens),
    logged under ``tag``."""
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 513, SERVE_REQUESTS)
    log(f"[{tag}] {SERVE_REQUESTS} requests, prompt lengths "
        f"{sorted(int(n) for n in plens)}, {SERVE_NEW_TOKENS} new tokens each")
    return [rng.integers(0, vocab, n).astype(np.int32) for n in plens]


def phase_serve(cfg, model, params):
    """llama3.2-1b with bf16 pages, CUDA graphs on, the full workload, then
    the on/off gate's requests graphs off (``ONOFF``); int8 pages with
    graphs on (the capturing run: bf16's timed run times the replay); then
    a dense cache and a sampled run (temperature 0.8, seed 7), 8 requests
    of 16 new tokens, graphs on and off.  Every run's exact launch gates;
    equal tokens on and off.  Returns the graphs-on runs' launches by page
    type."""
    prompts = serve_prompts(cfg.vocab_size)
    runs = {"bf16": serve_run("serve bf16 pages", model, params, prompts,
                              SERVE_NEW_TOKENS, True, llama_launches,
                              also=ONOFF, paged=True)}
    off = onoff_run("serve bf16 pages", model, params, prompts,
                    llama_launches, paged=True)
    same_onoff("serve", "bf16 pages", runs["bf16"], off)
    runs["int8"] = serve_run("serve int8 pages", model, params, prompts,
                             SERVE_NEW_TOKENS, True, llama_launches,
                             timed=False, paged=True, kv_dtype="int8")
    short = prompts[:SERVE_SLOTS]
    for what, kw in (("dense cache", dict(paged=False)),
                     ("sampled, bf16 pages", dict(paged=True,
                                                  temperature=0.8, seed=7))):
        want = (lambda s, c: llama_launches(s, c, paged=False)) \
            if not kw["paged"] else llama_launches
        pair = [serve_run(f"serve {what}", model, params, short, 16, g, want,
                          **kw) for g in (True, False)]
        _same_tokens("serve", what, pair)
    return {label: runs[label]["launches"] for label in ("bf16", "int8")}


def profiled_kernels(fn):
    """Run ``fn`` under ``torch.profiler``; (device us, count, name) of
    every device kernel it launched (kernel rows only: an operator's row
    would count its kernels twice).  Only the device is recorded: the
    host's operators are not read, and recording them cost mamba2-370m's
    profiled training step 36.8 s against 10.7 s for the same device time
    (722.7 and 721.2 ms, 32043 and 32017 launches in two consecutive
    steps), on an H100 80GB HBM3 at 700 W."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    return [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def log_top(tag, rows, busy_ms, top=10):
    for us, count, key in sorted(rows, reverse=True)[:top]:
        log(f"[{tag}]   {us / 1e3:9.3f} ms  {100 * us / 1e3 / busy_ms:5.1f}%"
            f"  x{count:<6d} {key[:90]}")


# a profiled run takes this many new tokens (15 decode steps, CUDA graphs
# of 8, 4, 2 and 1 steps): each step repeats the one before it, and at 32
# tokens the profiler's cost over ~1000-5000 kernels a step and the
# 16-step chunk's capture made each model's profile 10-25 s of the
# script.  No profiled run is eager: an eager one measured the graphs'
# kernels again, and the eager wall a step is each graphs-off run's
PROFILE_TOKENS = 16
# the port's serving kernels as the profiler names them; paged decode is
# its split kernel and the combine pass after it, the SSD scan its three
# passes
PROFILE_KERNELS = {"paged_decode": "paged_decode_",
                   "flash_prefill": "flash_prefill_",
                   "rmsnorm": "rmsnorm_kernel", "ssd_scan": "ssd_scan_"}
# cuBLAS's kernels for operands not aligned to 16 bytes, as the profiler
# names them (the head's GEMMs and GEMVs at a vocab of 50257, 49155 or
# 151655 columns, an odd count: align1; at 256206, even but not a multiple
# of 8: align2)
UNALIGNED_KERNELS = ("align1", "align2", "gemmSN")


def phase_profile(cfg, model, params, top: int = 10, tag: str = "profile",
                  paged: bool = True, detail: bool = False,
                  new_tokens: int = PROFILE_TOKENS, extras=None):
    """Where the time goes in a short serve run (8 prompts of 128 tokens,
    ``new_tokens`` each; bf16 pages, or the dense cache with
    ``paged=False``; CUDA graphs on): its wall time unprofiled, then
    its device kernels under ``torch.profiler`` (kernels replayed from a
    graph included).  With ``detail`` each instantiation of the port's
    kernels on its own line, and the decode steps alone: the same run's
    wall and device time less those of a run of the same prompts with one
    new token (its prefill and nothing else), and the share of the device
    time in cuBLAS's kernels for operands that are not 16-byte aligned
    (``UNALIGNED_KERNELS``: the head at a vocab that is not a multiple of
    8).  ``extras``, when given, is every request's dict of prefill inputs
    (an encoder-decoder's frames).  Returns, with ``detail``, {"wall_ms",
    "device_ms"} of a decode step alone (None where the profiler recorded
    nothing)."""
    from repro_torch.serve import Request, ServeEngine
    rng = np.random.default_rng(1)
    tag = f"{tag}, graphs on"
    eng = ServeEngine(model, params, batch_slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ, paged=paged, page_size=SERVE_PAGE,
                      cuda_graphs=True)
    prompts = [rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
               for _ in range(SERVE_SLOTS)]

    def run(new=new_tokens):
        eng.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate([Request(uid=i, prompt=p, max_new_tokens=new,
                              extras=dict(extras or {}))
                      for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run()                                            # warm-up, captures
    wall_ms = run()
    steps = eng.n_decode_steps
    rows = profiled_kernels(run)
    if not rows:
        log(f"[{tag}] device time: not measured (the profiler recorded no "
            f"device kernels); wall {wall_ms / steps:.2f} ms per step")
        del eng
        release()
        return None
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    log(f"[{tag}] {cfg.name}: {SERVE_SLOTS} requests x 128 prompt x "
        f"{new_tokens} new tokens, {'bf16 pages' if paged else 'dense cache'}"
        f", 1 prefill "
        f"call + {steps} decode steps: wall "
        f"{wall_ms:.1f} ms unprofiled ({wall_ms / steps:.2f} ms per step), "
        f"device kernels {busy_ms:.1f} ms ({busy_ms / steps:.2f} ms per "
        f"step, {launches} launches = {launches / steps:.0f} per step), "
        f"device idle share {1 - busy_ms / wall_ms:.3f}")
    share = {k: (sum(r[0] for r in rows if name in r[2]) / 1e3,
                 sum(r[1] for r in rows if name in r[2]))
             for k, name in PROFILE_KERNELS.items()}
    log(f"[{tag}] the port's kernels: " + ", ".join(
        f"{k} {ms:.3f} ms ({100 * ms / busy_ms:.1f}%, x{n})"
        for k, (ms, n) in share.items()))
    summary = None
    if detail:
        head = [r for r in rows if any(n in r[2] for n in UNALIGNED_KERNELS)]
        head_ms = sum(r[0] for r in head) / 1e3
        log(f"[{tag}] unaligned-operand GEMM/GEMV kernels (the head at "
            f"vocab {cfg.vocab_size}): {head_ms:.3f} ms "
            f"({100 * head_ms / busy_ms:.1f}% of the device time, x"
            f"{sum(r[1] for r in head)}, {head_ms / steps:.4f} ms a step)")
        log_top(f"{tag}, the port's kernels by instantiation",
                [r for r in rows
                 if any(n in r[2] for n in PROFILE_KERNELS.values())],
                busy_ms, top=len(rows))
        pre_wall = run(1)
        pre_rows = profiled_kernels(lambda: run(1))
        pre_busy = sum(r[0] for r in pre_rows) / 1e3
        dec_wall, dec_busy = wall_ms - pre_wall, busy_ms - pre_busy
        log(f"[{tag}] decode steps alone (less a prefill-only run: wall "
            f"{pre_wall:.1f} ms, device {pre_busy:.1f} ms): wall "
            f"{dec_wall / steps:.2f} ms a step, device "
            f"{dec_busy / steps:.2f} ms a step "
            f"({(launches - sum(r[1] for r in pre_rows)) / steps:.0f} "
            f"launches), device idle share {1 - dec_busy / dec_wall:.3f}")
        summary = {"wall_ms": dec_wall / steps, "device_ms": dec_busy / steps}
    log_top(tag, rows, busy_ms, top)
    del eng
    release()
    return summary


# ---------------------------------------------------------------------------
# 5. prefill / decode consistency
# ---------------------------------------------------------------------------

def phase_consistency(model, params, steps: int = 4, kv_dtype=None,
                      tag: str = "consistency", hold: str = "hold",
                      prefix: int = 0, frames: int = 0, plens=(100, 37),
                      bucket: int = 128, max_seq: int = SERVE_MAX_SEQ):
    """Prefill P (rows of ``plens`` tokens right-padded to ``bucket``, a
    cache of ``max_seq`` positions), then ``steps`` paged decode steps fed
    the greedy tokens, against the last-position logits of one prefill of
    P + those tokens;
    pages of the compute dtype, or ``kv_dtype`` ("int8") pages installed as
    the engine installs them (a fresh scale a page): within
    ``CONSISTENCY_TOL`` of the largest |logit|.  With ``prefix`` (a VLM)
    both prefills take the same ``prefix`` seeded patch rows a row before
    the prompt, and the decode positions start past them; with ``frames``
    (an encoder-decoder) both take the same ``frames`` seeded frames a row
    for the encoder, and the dense cross K/V rows are installed beside the
    pages as the engine installs them.

    An MoE model's longer prefill is held to the decode path
    (``HeldPath``): with ``hold`` "experts" it takes the experts the decode
    path chose at every position, with "hold" their residual after each
    layer too, and each layer's output at the decoded token is then gated
    as well.  Its own routing flips where two router probabilities nearly
    tie, and with granite's random experts one flip moves a token's output
    by several percent of the residual: the routing is held so that the
    gate sees the two paths' arithmetic (``PERF.md`` §6, PR 23)."""
    from repro_torch.models.common import kv_qmax
    from repro_torch.serve.kv_pages import PagedBatchState, write_prefill_pages
    rng = np.random.default_rng(5)
    plens = np.array(plens, np.int32)
    B = len(plens)
    dev = model.device
    V = model.cfg.vocab_size
    prompts = np.zeros((B, bucket + steps), np.int32)
    for b, n in enumerate(plens):
        prompts[b, :n] = rng.integers(0, V, n)
    patch = {}
    if prefix:
        patch["patch_embeds"] = torch.tensor(
            rng.normal(size=(B, prefix, model.cfg.d_model)),
            dtype=torch.float32, device=dev)
    if frames:
        patch["frames"] = torch.tensor(
            rng.normal(size=(B, frames, model.cfg.d_model)),
            dtype=torch.float32, device=dev)
    st = PagedBatchState(model, B, max_seq, page_size=SERVE_PAGE,
                         kv_dtype=kv_dtype)
    for b, n in enumerate(plens):
        st.pool.allocate(b, prefix + int(n) + steps)
    st.sync_tables()
    held = HeldPath(model, B, bucket + steps, hold) if model.cfg.is_moe \
        else None
    with held or contextlib.nullcontext():
        if held:
            held.record()
        logits, sub = model.prefill(params, torch.tensor(
            prompts[:, :bucket], device=dev),
            prompt_lens=torch.tensor(plens, device=dev),
            max_seq=max_seq, **patch)
        tables_sub = st.pool.tables.copy()
        for b in range(B):
            tables_sub[b, st.pool.n_blocks[b]:] = st.pool.n_pages
        for key in model.paged_cache_keys():
            scales = st.cache.get(f"{key}_scale")
            if scales is None:
                write_prefill_pages(st.cache[key], sub[key], tables_sub)
            else:
                write_prefill_pages(st.cache[key], sub[key], tables_sub,
                                    scales=scales,
                                    qmax=kv_qmax(st.cache[key].dtype))
        for key in model.cache_slot_axes():
            if key not in model.paged_cache_keys():
                st.cache[key].copy_(sub[key])
        tokens = torch.argmax(logits, -1).to(torch.int32)
        pos = torch.tensor(plens + prefix, device=dev)
        worst = 0.0
        for i in range(steps):
            for b in range(B):
                prompts[b, plens[b] + i] = int(tokens[b])
            if held:
                held.record(pos)
            logits, _ = model.decode_step(params, st.cache, tokens, pos,
                                          block_tables=st.tables_dev)
            if held:
                held.apply(pos)
            ref = model.prefill(params, torch.tensor(prompts, device=dev),
                                prompt_lens=torch.tensor(plens + i + 1,
                                                         device=dev),
                                max_seq=max_seq, **patch)[0]
            gap = float((logits[:, :V].float()
                         - ref[:, :V].float()).abs().max())
            scale = float(ref[:, :V].float().abs().max())
            worst = max(worst, gap / scale)
            log(f"[{tag}] step {i}: max |decode - prefill| logits {gap:.4g}"
                f" (max |logit| {scale:.3f}, relative {gap / scale:.4g}); "
                f"greedy equal "
                f"{torch.equal(logits.argmax(-1), ref.argmax(-1))}"
                + (f" ({held.summary()})" if held else ""))
            tokens = torch.argmax(logits, -1).to(torch.int32)
            pos = pos + 1
    if worst > CONSISTENCY_TOL:
        raise AssertionError(f"prefill/decode logits differ by {worst:.4f} of "
                             f"max |logit| > {CONSISTENCY_TOL}")
    log(f"[{tag}] ok: worst relative gap {worst:.4g} <= {CONSISTENCY_TOL}")
    return worst


# ---------------------------------------------------------------------------
# 5a. the prefix cache and the wave baseline at full width
# ---------------------------------------------------------------------------

# serve_prefix: 24 requests of 4 shared "system prompt" templates (two
# page-aligned, two ending mid-page, which exercises the copy-on-write
# tail), each followed by 16-128 unique tokens, 32 new tokens each; the
# small-pool run's pages, fewer than the 193 distinct pages the run holds at
# its peak in the default pool (tree pages included; counted on the CPU at
# smoke width, where the page accounting is the same), so that admissions
# must evict tree pages
PREFIX_TEMPLATES = (128, 200, 256, 333)
PREFIX_REQUESTS, PREFIX_NEW_TOKENS = 24, 32
PREFIX_SMALL_POOL = 161


def prefix_workload(vocab: int):
    """The serve_prefix prompts, request i on template i % 4: the first
    admission round (8 slots) seeds the tree, later rounds find their
    template in it."""
    rng = np.random.default_rng(11)
    temps = [rng.integers(0, vocab, n) for n in PREFIX_TEMPLATES]
    return [np.concatenate([temps[i % len(temps)],
                            rng.integers(0, vocab, int(rng.integers(16, 129)))
                            ]).astype(np.int32)
            for i in range(PREFIX_REQUESTS)]


def prefix_stats(eng) -> dict:
    """What a serve_prefix run reports of its engine after the timed run:
    the cache's counters (None with it off), the pool's peak of distinct
    pages in use; with the cache on, the tree is flushed and the pool must
    then hold every page but the parking one."""
    pool = eng.state.pool
    out = {"cache": eng.prefix_cache_stats(),
           "peak_pages": pool.stats()["peak_allocated_pages"]}
    if eng.prefix_cache is not None:
        eng.prefix_cache.flush(pool)
        out["drained"] = pool.n_free == pool.n_pages - 1
    return out


def _parting(a, b):
    """Index of the first token where two streams differ, or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def prefix_near_tie(tag, model, params, prompts, off, r, j, kv_dtype):
    """Request ``r``'s greedy stream with the cache on parted from the
    cache off at token ``j``: hold its spliced decode against a cold one.
    A warm engine serves the first request of the same template, then both
    it and a cache-less twin admit request ``r``; both decode fed the
    cache-off tokens.  Gates: the logits within ``ATTN_TOL`` of max |logit|
    at every step up to ``j``, the argmax equal before ``j``; logs the
    top-2 gap of the cold logits at ``j``."""
    from repro_torch.serve import Request, ServeEngine
    if j == 0:                  # the prefill re-runs the prompt as cold
        raise AssertionError(f"{tag} request {r}: the first token differs")
    kw = dict(batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
              page_size=SERVE_PAGE, paged=True, kv_dtype=kv_dtype,
              cuda_graphs=False)
    warm = ServeEngine(model, params, prefix_cache=True, **kw)
    primer = r % len(PREFIX_TEMPLATES)
    warm.generate([Request(uid=-1, prompt=prompts[primer], max_new_tokens=1)])
    cold = ServeEngine(model, params, **kw)
    rows = []
    for eng in (warm, cold):
        eng.submit([Request(uid=r, prompt=prompts[r],
                            max_new_tokens=PREFIX_NEW_TOKENS)])
        eng._admit()
        slot = next(s for s, q in enumerate(eng.scheduler.slots)
                    if q is not None and q.uid == r)
        st = eng.state
        tok, pos = st.tokens.clone(), st.pos.clone()
        out = []
        for k in range(j):                  # logits of tokens 1..j
            tok[slot] = off[k]
            logits, _ = model.decode_step(params, st.cache, tok, pos,
                                          block_tables=st.tables_dev)
            out.append(logits[slot, :model.cfg.vocab_size].float())
            pos = pos + 1
        rows.append(out)
    hit = warm.prefix_cache_stats()
    worst = 0.0
    for k, (lw, lc) in enumerate(zip(*rows), start=1):
        gap = float((lw - lc).abs().max()) / float(lc.abs().max())
        worst = max(worst, gap)
        if k < j and int(lw.argmax()) != int(lc.argmax()):
            raise AssertionError(f"{tag} request {r}: spliced and cold "
                                 f"argmax differ at token {k} < {j}")
    top2 = torch.topk(rows[1][-1], 2).values
    log(f"[{tag}] request {r} parts at token {j}: spliced against cold "
        f"logits, worst relative gap {worst:.2e} (tol {ATTN_TOL}), argmax "
        f"equal before it; cold top-2 gap there {float(top2[0] - top2[1]):.4e}"
        f" (hit {hit['hit_tokens']} tokens, cow {hit['cow_copies']})")
    if worst > ATTN_TOL:
        raise AssertionError(f"{tag} request {r}: spliced logits {worst:.3e}"
                             f" of max |logit| from the cold ones")
    del warm, cold
    release()


def phase_serve_prefix(cfg, model, params):
    """llama3.2-1b with the radix prefix cache over ``prefix_workload``,
    CUDA graphs on: on bf16 pages the cache off and on, then the cache on
    in a pool of ``PREFIX_SMALL_POOL`` pages; on int8 pages the cache off
    and on, each the capturing run alone.  (The cache on with graphs off
    repeated these gates with only the graph mode changed: graphs on and
    off are gated in ``phase_serve``.)  Gates: every
    run's exact launches (the prompt is re-run whole, so the counts of the
    cache off), the greedy
    tokens of every cache-on run equal the cache-off ones of its page
    type (where a request parts, ``prefix_near_tie`` instead), hits and
    hit tokens, at least one copy-on-write copy, at least one eviction in
    the small pool, a drained pool after the tree's flush.  Logs the hit
    rates, peak distinct pages and tokens/s on against off."""
    prompts = prefix_workload(cfg.vocab_size)
    log(f"[serve_prefix] {PREFIX_REQUESTS} requests on templates of "
        f"{PREFIX_TEMPLATES} tokens, prompt lengths "
        f"{[len(p) for p in prompts]}, {PREFIX_NEW_TOKENS} new tokens each")
    runs, near = {}, []
    for kv in (None, "int8"):
        label = kv or "bf16"
        for cache, graphs, n_pages in ((False, True, None), (True, True, None)
                                       ) + (((True, True, PREFIX_SMALL_POOL),)
                                            if kv is None else ()):
            what = f"{label} pages, cache {'on' if cache else 'off'}" + (
                f", {n_pages} pages" if n_pages else "")
            out = serve_run(f"serve_prefix {what}", model, params, prompts,
                            PREFIX_NEW_TOKENS, graphs, llama_launches,
                            inspect=prefix_stats, timed=kv is None,
                            paged=True, kv_dtype=kv, prefix_cache=cache,
                            n_pages=n_pages)
            runs[label, cache, graphs, n_pages] = out
            st = out["cache"]
            if cache:
                log(f"[serve_prefix] {what} ({'graphs on' if graphs else
                    'graphs off'}): hit rate {st['hit_rate']:.3f} "
                    f"({st['hits']} of {st['hits'] + st['misses']} lookups),"
                    f" token hit rate {st['token_hit_rate']:.3f} "
                    f"({st['hit_tokens']} of {st['lookup_tokens']}); "
                    f"{st['cow_copies']} copy-on-write copies, "
                    f"{st['evictions']} evictions; peak distinct pages "
                    f"{out['peak_pages']}")
                if not (st["hits"] > 0 and st["hit_tokens"] > 0
                        and st["cow_copies"] >= 1 and out["drained"]) or (
                        n_pages and st["evictions"] < 1):
                    raise AssertionError(f"serve_prefix {what}: cache stats "
                                         f"{st}, drained {out['drained']}")
            off = runs[label, False, True, None]["tokens"]
            for r, (a, b) in enumerate(zip(off, out["tokens"])):
                j = _parting(a, b)
                if j is not None:
                    log(f"[serve_prefix] {what}: request {r} parts from the "
                        f"cache off at token {j} of {len(a)}")
                    near.append((label, r, j))
                    prefix_near_tie("serve_prefix", model, params, prompts,
                                    a, r, j, kv)
        off = runs[label, False, True, None]
        for n_pages in (None, PREFIX_SMALL_POOL) if kv is None else ():
            on = runs[label, True, True, n_pages]
            log(f"[serve_prefix] {label} pages, graphs on: cache on"
                + (f" in {n_pages} pages" if n_pages else "") + f" "
                f"{on['tokens_per_s']:.1f} tokens/s against off (graphs on) "
                f"{off['tokens_per_s']:.1f} "
                f"({on['tokens_per_s'] / off['tokens_per_s']:.2f}x); peak "
                f"distinct pages {on['peak_pages']} against "
                f"{off['peak_pages']}")
    log(f"[serve_prefix] greedy tokens with the cache on equal the cache "
        f"off in every run" + ("" if not near else
                               f", but for near ties at {near}"))
    return {k: {"tokens_per_s": v["tokens_per_s"], "cache": v["cache"],
                "peak_pages": v["peak_pages"], "launches": v["launches"]}
            for k, v in runs.items()}


def phase_wave(cfg, model, params):
    """``WaveEngine`` (2 waves of 8, left-padded, dense decode in plain
    PyTorch) against the continuous ``ServeEngine`` (dense cache, graphs
    on) over the serve phase's 16 requests: tokens/s of both and their
    ratio, the wave's exact launches (16 flash prefills a wave, 33
    RMSNorms a forward, no paged decode), finite logits; and on 8 prompts
    of equal length (left-padding a no-op) greedy tokens equal to the
    continuous engine's."""
    from repro_torch import kernels
    from repro_torch.serve import Request, WaveEngine
    rng = np.random.default_rng(0)                  # phase_serve's requests
    plens = rng.integers(16, 513, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in plens]
    equal = [rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
             for _ in range(SERVE_SLOTS)]
    watch = NanWatch(model)
    wave = WaveEngine(watch, params, batch_slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ)

    def dense(steps, calls):
        return llama_launches(steps, calls, paged=False)

    def run(ps, new):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(ps)]
        wave.reset()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        wave.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernels.launch_counts()
        waves = -(-len(ps) // SERVE_SLOTS)
        want = dense(wave.n_decode_steps, waves)
        if got != want or not all(r.done and len(r.generated) == new
                                  for r in reqs):
            raise AssertionError(f"wave: launches {got} != {want}, or a "
                                 f"request unfinished")
        return wall, got, [r.generated for r in reqs]

    _, _, wave_equal = run(equal, 16)
    cont_equal = serve_run("wave continuous, equal prompts", model, params,
                           equal, 16, True, dense, paged=False)
    for r, (a, b) in enumerate(zip(wave_equal, cont_equal["tokens"])):
        j = _parting(a, b)
        if j is not None:
            raise AssertionError(f"wave: request {r} of equal-length "
                                 f"prompts parts from the continuous "
                                 f"engine at token {j}")
    log(f"[wave] {SERVE_SLOTS} prompts of 128 tokens, 16 new each: wave and "
        f"continuous greedy tokens identical")
    wall, got, tokens = run(prompts, SERVE_NEW_TOKENS)
    if bool(watch.nan) or bool(watch.inf):
        raise AssertionError("wave: a logit not finite")
    n_tok = sum(len(t) for t in tokens)
    cont = serve_run("wave continuous", model, params, prompts,
                     SERVE_NEW_TOKENS, True, dense, paged=False)
    ratio = cont["tokens_per_s"] / (n_tok / wall)
    log(f"[wave] {SERVE_REQUESTS} requests, {SERVE_NEW_TOKENS} new tokens "
        f"each: wave {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
        f"tokens/s ({wave.n_decode_steps} decode steps, launches {got}, "
        f"exact) against continuous (dense cache, graphs on) "
        f"{cont['tokens_per_s']:.1f} tokens/s ({cont['steps']} decode "
        f"steps): continuous / wave {ratio:.2f}x")
    del wave, watch
    release()
    return {"wave_tokens_per_s": n_tok / wall,
            "continuous_tokens_per_s": cont["tokens_per_s"], "ratio": ratio,
            "wave_launches": got}


# ---------------------------------------------------------------------------
# 5b'. fleet: KV page-block migration between two engines (disaggregated
# serving's device path), and the fleet launcher (modeled time, host only)
# ---------------------------------------------------------------------------

FLEET_STEPS, FLEET_SSM_SLOTS, FLEET_SSM_STEPS = 16, 4, 8
FLEET_DENSE_TOL, FLEET_QUANT_TOL = 1e-5, 5e-2   # tests/test_disagg.py's
FLEET_REQUESTS = 200
FLEET_CAP_FRAC = 0.9


def _fleet_engine(model, params, slots, graphs=False, **kw):
    from repro_torch.serve import ServeEngine
    return ServeEngine(model, params, batch_slots=slots,
                       max_seq=SERVE_MAX_SEQ, page_size=SERVE_PAGE,
                       paged=True, cuda_graphs=graphs, **kw)


def _prefilled(model, params, prompts, **kw):
    """A paged engine (graphs off) with ``prompts`` admitted (prefilled)
    in slots 0..n-1 through ``submit`` and ``_admit``, as
    ``tests/test_disagg.py`` admits them, and the admission's launches."""
    from repro_torch import kernels
    from repro_torch.serve import Request
    eng = _fleet_engine(model, params, len(prompts), **kw)
    eng.submit([Request(uid=i, prompt=p, max_new_tokens=SERVE_NEW_TOKENS)
                for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    eng._admit()
    torch.cuda.synchronize()
    return eng, kernels.launch_counts()


def _greedy_steps(model, params, eng, steps, feed=None):
    """``steps`` eager decode steps over ``eng``'s state (its slot vectors
    untouched), each fed the next tensor of ``feed`` or its own greedy
    tokens; returns the logits, the tokens fed and the steps' launches."""
    from repro_torch import kernels
    st = eng.state
    tok, pos = st.tokens.clone(), st.pos.clone()
    logits, fed = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for i in range(steps):
        lg, _ = model.decode_step(params, st.cache, tok, pos,
                                  block_tables=st.tables_dev)
        logits.append(lg)
        tok = feed[i] if feed is not None else lg.argmax(-1).to(torch.int32)
        fed.append(tok)
        pos = pos + 1
    torch.cuda.synchronize()
    return logits, fed, kernels.launch_counts()


def _migration_gate(tag, tol, ref, moved):
    """The argmax exact at every step and max |dlogit| within ``tol``;
    returns the max."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(ref, moved)):
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            raise AssertionError(f"{tag}: argmax parts from the unmigrated "
                                 f"engine at step {i}")
    if not worst <= tol:
        raise AssertionError(f"{tag}: max |dlogit| {worst} > {tol}")
    return worst


def migrate_all(tag, cfg, model, src, dst, kv):
    """Move every slot of ``src`` into the same slot of ``dst``: a spacer
    allocation in ``dst``'s last slot first (so the pages land on other ids
    than the source's), even slots through the host dict (``to_dict`` /
    ``from_dict``), odd ones device to device; then the decode carries by
    copy.  Logs each request's payload beside ``kv_bytes_per_token`` times
    its reservation, the extract and splice times (CUDA events), the host
    round trip and ``TransferCostModel``'s modeled link.  Returns the
    transfers by slot and the per-request records."""
    from repro_torch.fleet import TransferCostModel, kv_bytes_per_token
    from repro_torch.serve.kv_pages import (PageBlockTransfer,
                                            extract_page_block,
                                            splice_page_block)
    cost, tok_bytes = TransferCostModel(), kv_bytes_per_token(cfg, kv)
    pos = src.state.pos.cpu().tolist()
    n = src.slots
    dst.state.pool.allocate(n - 1, 200)
    trs, recs = {}, []
    for slot in range(n):
        if slot == n - 1:
            dst.state.pool.free(n - 1)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        tr = extract_page_block(src.state, slot, model, n_tokens=pos[slot])
        ev[1].record()
        host_ms = None
        if slot % 2 == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr = PageBlockTransfer.from_dict(tr.to_dict())
            host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        if not splice_page_block(dst.state, slot, tr, model):
            raise AssertionError(f"{tag}: slot {slot} did not fit the "
                                 f"destination's pool")
        ev[3].record()
        torch.cuda.synchronize()
        ids = [src.state.pool.tables[slot, :tr.n_blocks].tolist(),
               dst.state.pool.tables[slot, :tr.n_blocks].tolist()]
        if tr.leaves and (0 in ids[1] or sorted(ids[0]) == sorted(ids[1])):
            raise AssertionError(f"{tag}: slot {slot} landed on the parking "
                                 f"page or on the source's page ids")
        rec = {"slot": slot, "n_tokens": tr.n_tokens,
               "n_tokens_total": tr.n_tokens_total, "pages": tr.n_blocks,
               "nbytes": tr.nbytes(),
               "analytic_bytes": tok_bytes * tr.n_tokens_total,
               "extract_ms": ev[0].elapsed_time(ev[1]),
               "splice_ms": ev[2].elapsed_time(ev[3]), "host_ms": host_ms,
               "link": cost.cost(tr.nbytes())}
        recs.append(rec)
        log(f"[{tag}] slot {slot}: {tr.n_tokens} tokens, reservation "
            f"{tr.n_tokens_total} in {tr.n_blocks} pages: {rec['nbytes']} B "
            f"(kv_bytes_per_token {tok_bytes} x reservation = "
            f"{rec['analytic_bytes']} B); extract {rec['extract_ms']:.4f} "
            f"ms, splice {rec['splice_ms']:.4f} ms "
            + (f"(from the host dict; to_dict + from_dict {host_ms:.3f} ms)"
               if host_ms is not None else "(device to device)")
            + f"; modeled link {rec['link']['time_s'] * 1e3:.4f} ms, "
            f"{rec['link']['energy_j']:.6f} J")
        trs[slot] = tr
    dst.state.slot_vectors.copy_(src.state.slot_vectors)
    return trs, recs


def phase_fleet_migration(cfg, model, params):
    """Disaggregated serving's device path at llama3.2-1b's full width, on
    bf16 and then int8 pages: engine A prefills the serve phase's first
    ``SERVE_SLOTS`` prompts, every slot migrates into engine B
    (``migrate_all``), and A's cache is overwritten with junk.  B and an
    unmigrated engine prefilled the same way decode ``FLEET_STEPS`` greedy
    steps: the argmax exact at every step, max |dlogit| within 1e-5
    (bf16) / 5e-2 (int8), exact launches (16 flash prefills a prefill
    call; 16 paged decodes and 33 RMSNorms a step).  Then the same
    transfers splice into a third engine whose decode graph was captured
    before the splice: its replay gives the unmigrated engine's greedy
    tokens, so the splice wrote into the tensors the graph reads.  Returns
    each page type's launches (prefill, migrated decode, graph replay)
    and per-request records."""
    from repro_torch import kernels
    from repro_torch.serve.kv_pages import splice_page_block
    prompts = serve_prompts(cfg.vocab_size, "fleet")[:SERVE_SLOTS]
    log(f"[fleet] the first {SERVE_SLOTS} of them, {FLEET_STEPS} decode "
        f"steps after the migration")
    out = {}
    for kv in ("none", "int8"):
        label = "bf16" if kv == "none" else kv
        tag = f"fleet {label} pages"
        uni, pre = _prefilled(model, params, prompts, kv_dtype=kv)
        if pre != llama_launches(0, uni.n_prefill_calls):
            raise AssertionError(f"{tag}: prefill launches {pre}")
        ref, fed, _ = _greedy_steps(model, params, uni, FLEET_STEPS)
        src, _ = _prefilled(model, params, prompts, kv_dtype=kv)
        dst = _fleet_engine(model, params, SERVE_SLOTS, kv_dtype=kv)
        trs, recs = migrate_all(tag, cfg, model, src, dst, kv)
        for leaf in src.state.cache.values():
            leaf.fill_(1)                       # junk over A's pages
        moved, _, got = _greedy_steps(model, params, dst, FLEET_STEPS, fed)
        want = llama_launches(FLEET_STEPS, 0)
        if got != want:
            raise AssertionError(f"{tag}: migrated decode launches {got} != "
                                 f"{want}")
        tol = FLEET_DENSE_TOL if kv == "none" else FLEET_QUANT_TOL
        worst = _migration_gate(tag, tol, ref, moved)
        log(f"[{tag}] {SERVE_SLOTS} requests migrated, {FLEET_STEPS} greedy "
            f"steps on B: argmax exact, max |dlogit| {worst:.3e} (bound "
            f"{tol:g}) against the unmigrated engine; launches {got} "
            f"(exact)")
        graphed = _fleet_engine(model, params, SERVE_SLOTS, graphs=True,
                                kv_dtype=kv)
        graphed._chunk_fn(FLEET_STEPS)()              # eager, then capture
        for slot, tr in trs.items():
            if not splice_page_block(graphed.state, slot, tr, model):
                raise AssertionError(f"{tag}: graph engine splice failed")
        graphed.state.slot_vectors.copy_(dst.state.slot_vectors)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        toks = graphed._chunk_fn(FLEET_STEPS)()[0].clone()
        torch.cuda.synchronize()
        replay = kernels.launch_counts()
        if replay != want or not torch.equal(toks, torch.stack(fed)):
            raise AssertionError(f"{tag}: the captured decode graph's replay "
                                 f"over the spliced pages gave other tokens "
                                 f"or launches {replay}")
        log(f"[{tag}] the decode graph captured before the splice replayed "
            f"{FLEET_STEPS} steps over the spliced pages: the unmigrated "
            f"engine's greedy tokens, launches {replay} (exact)")
        out[label] = {"prefill": pre, "decode": got, "replay": replay,
                      "records": recs, "max_dlogit": worst}
        del uni, src, dst, graphed, trs, ref, moved, fed
        release()
    return out


def phase_fleet_ssm(cfg, model, params):
    """mamba2-370m at full width with ``FLEET_SSM_SLOTS`` slots and
    ``paged=True`` (the block tables only account): after prefill every
    slot migrates (``migrate_all``) with its SSM and conv state in the
    transfer's dense rows, the source's state is overwritten with junk,
    and ``FLEET_SSM_STEPS`` greedy steps on the destination give the
    unmigrated engine's argmax at every step, logits within 1e-5; exact
    launches (48 SSD scans a prefill call, 97 RMSNorms a step)."""
    rng = np.random.default_rng(0)              # phase_serve_ssm's prompts
    plens = rng.integers(16, 513, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in plens][:FLEET_SSM_SLOTS]
    tag = "fleet_ssm"
    want = mamba_launches(cfg.n_layers)
    uni, pre = _prefilled(model, params, prompts)
    if pre != want(0, uni.n_prefill_calls):
        raise AssertionError(f"{tag}: prefill launches {pre}")
    ref, fed, _ = _greedy_steps(model, params, uni, FLEET_SSM_STEPS)
    src, _ = _prefilled(model, params, prompts)
    dst = _fleet_engine(model, params, FLEET_SSM_SLOTS)
    trs, recs = migrate_all(tag, cfg, model, src, dst, "none")
    if any(tr.leaves or set(tr.dense) != {"ssm", "conv"}
           for tr in trs.values()):
        raise AssertionError(f"{tag}: a transfer without the dense state")
    for leaf in src.state.cache.values():
        leaf.fill_(1)
    moved, _, got = _greedy_steps(model, params, dst, FLEET_SSM_STEPS, fed)
    if got != want(FLEET_SSM_STEPS, 0):
        raise AssertionError(f"{tag}: migrated decode launches {got}")
    worst = _migration_gate(tag, FLEET_DENSE_TOL, ref, moved)
    log(f"[{tag}] {FLEET_SSM_SLOTS} requests migrated with their SSM and "
        f"conv rows ({recs[0]['nbytes']} B a request), {FLEET_SSM_STEPS} "
        f"greedy steps: argmax exact, max |dlogit| {worst:.3e} (bound "
        f"{FLEET_DENSE_TOL:g}); launches {got} (exact)")
    del uni, src, dst, trs, ref, moved, fed
    release()
    return {"prefill": pre, "decode": got, "max_dlogit": worst}


def fleet_launcher(argv):
    """``repro_torch.launch.fleet.main(argv + ["--json"])`` in-process;
    the report and the fleet.  Its numbers are modeled on the replicas'
    chip models (h100-like): the fleet touches no device."""
    import contextlib
    import io
    from repro_torch.launch import fleet as launch
    from repro_torch.obs import check_fleet
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = launch.main(list(argv) + ["--json",
                                        "--requests", str(FLEET_REQUESTS)])
    rep = json.loads(buf.getvalue())
    problems = check_fleet(res["fleet"].replicas, rep)
    if problems:
        raise AssertionError(f"fleet {argv}: check_fleet: {problems[:3]}")
    if rep["n_completed"] + rep["n_stranded"] != FLEET_REQUESTS:
        raise AssertionError(f"fleet {argv}: {rep['n_completed']} completed"
                             f" + {rep['n_stranded']} stranded != "
                             f"{FLEET_REQUESTS}")
    log(f"[fleet_launcher] {' '.join(argv)}: {rep['n_completed']}/"
        f"{FLEET_REQUESTS} completed, {rep['n_stranded']} stranded; "
        f"modeled (h100-like): {rep['joules_per_token']:.4f} J/token, TTFT "
        f"p50/p99 {rep['ttft_p50_s'] * 1e3:.3f}/"
        f"{rep['ttft_p99_s'] * 1e3:.3f} ms, TPOT p50/p99 "
        f"{rep['tpot_p50_s'] * 1e3:.3f}/{rep['tpot_p99_s'] * 1e3:.3f} ms; "
        f"check_fleet clean")
    return rep, res["fleet"]


def phase_fleet_launcher():
    """The port's fleet launcher (modeled time, h100-like chip models; no
    device) for three fleets of ``FLEET_REQUESTS`` requests: 3 unified
    replicas behind the energy-slo router at 60 requests/s; the same under
    a cluster power cap at ``FLEET_CAP_FRAC`` of the uncapped fleet's
    planned draw with every replica loaded (the sum of its replicas' plan
    watts), which must re-plan at least once; and 2 prefill + 2 decode
    replicas under the storm fault schedule, whose migrations must be
    charged.  Every report passes ``check_fleet`` and accounts for every
    request; the cap's tracking error is logged, not gated."""
    base = ["--replicas", "3xh100:4", "--router", "energy-slo",
            "--rate", "60"]
    rep, fleet = fleet_launcher(base)
    planned = sum(r.plan.energy_j / r.plan.time_s for r in fleet.replicas)
    cap = FLEET_CAP_FRAC * planned
    log(f"[fleet_launcher] uncapped: mean window "
        f"{rep['power']['mean_window_w']:.1f} W, mean loaded "
        f"{rep['power']['mean_loaded_w']:.1f} W (the mean window where no "
        f"window ran loaded), planned draw with every replica loaded "
        f"{planned:.1f} W; cap {cap:.1f} W (modeled)")
    capped, _ = fleet_launcher(base + ["--power-cap", f"{cap:.4f}"])
    gov, p = capped["fleet_governor"], capped["power"]
    if gov["n_replans"] < 1:
        raise AssertionError(f"fleet capped: no re-plan under a {cap:.1f} W "
                             f"cap")
    err = p.get("loaded_tracking_err_frac")
    log(f"[fleet_launcher] capped at {cap:.1f} W: {gov['n_replans']} "
        f"re-plans over {gov['n_ticks']} ticks, mean window "
        f"{p['mean_window_w']:.1f} W, max {p['max_window_w']:.1f} W "
        f"(over the cap by {p['max_over_cap_frac'] * 100:.2f}%), tracking "
        f"error " + (f"{err * 100:.2f}%" if err is not None else
                     "n/a (no loaded window)") + " (modeled, not gated)")
    dis, _ = fleet_launcher(["--replicas", "2xh100@prefill,2xh100@decode",
                             "--faults", "storm"])
    if not dis["n_migrations"] or dis["migration_bytes"] <= 0 \
            or dis["migration_energy_j"] <= 0:
        raise AssertionError("fleet disaggregated: migrations not charged")
    rec = dis["recovery"]
    log(f"[fleet_launcher] disaggregated under the storm: "
        f"{dis['n_migrations']} KV migrations, {dis['migration_bytes']} B, "
        f"{dis['migration_energy_j']:.6f} J and "
        f"{dis['migration_s'] * 1e3:.3f} ms charged (modeled link); "
        f"{rec['n_crashes']} crashes, {rec['n_thermal_caps']} thermal caps, "
        f"{rec['n_reprefills']} prefills re-run")
    return {"unified": rep, "capped": capped, "disaggregated": dis,
            "cap_w": cap}


# ---------------------------------------------------------------------------
# 5b''. the README's five examples (repro_torch.examples) on the card
# ---------------------------------------------------------------------------

#: train_gpt3xl_dvfs on the card: the true gpt3-xl, two micro-batches of
#: 8 x 1024 a step (the training shape whose flash forward with its
#: log-sum-exp and backward the kernels phase checks, rows
#: flash_prefill_lse[D128] and flash_bwd[D128]), checkpoints every 10
#: steps and at the last, a failure injected at step 11: steps 0-10, the
#: failure, a restore from the step-10 checkpoint, steps 10-11 again
EXAMPLE_TRAIN_FLAGS = ["--full", "--seq", "1024", "--batch", "16",
                       "--steps", "12", "--fail-at", "11"]
EXAMPLE_TRAIN_STEPS_RUN = 13
#: the kernel rows whose instantiation the device examples launch, and
#: which example's count of which kernel joins the row
EXAMPLE_ROWS = {"flash_prefill_lse[D128]": ("train_gpt3xl_dvfs",
                                            "flash_prefill"),
                "flash_bwd[D128]": ("train_gpt3xl_dvfs", "flash_bwd"),
                "rmsnorm": ("serve_dvfs", "rmsnorm"),
                "flash_prefill": ("serve_dvfs", "flash_prefill"),
                "paged_decode[bf16]": ("serve_dvfs", "paged_decode")}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _run_example(name, module, argv):
    """``module.main(argv)`` with the launch counts set to 0 just before
    it; (its result, its launches, its seconds)."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = kernels.launch_counts()
    log(f"[examples] {name} {' '.join(argv)}: exit normal in {seconds:.1f} "
        f"s, launches {got}")
    return out, got, seconds


def _same_plan(name, path, phases):
    """Raise unless the plan saved at ``path`` loads with the per-phase
    rows (``summary()["phases"]``) the example printed."""
    from repro_torch.dvfs import DvfsPlan
    if DvfsPlan.load(path).summary()["phases"] != phases:
        raise AssertionError(f"examples {name}: {path} does not round-trip "
                             f"through DvfsPlan.load")


def example_train(tmp, nvml, idle_w):
    """``train_gpt3xl_dvfs`` with ``EXAMPLE_TRAIN_FLAGS`` on the card, its
    checkpoints (the real ``CheckpointManager``) under ``tmp``, each save's
    and restore's bytes and seconds taken around the manager's calls, and
    the NVML energy counter read around every step (the stream
    synchronised at both ends), outside the example.  Gates: finite
    losses, one restart, the executor's books (``check_executor``; fwd,
    bwd and opt once a step of the 12), the saved plan round-trips, the
    exact launches (2 micro-batches x 24 layers: 48 flash forwards with
    their log-sum-exp and 48 flash backwards a step, no remat, over the
    13 steps run).  Logs step seconds, tokens/s, peak memory, the
    checkpoints' bytes and seconds, and, over a window of at least
    ``DVFS_WINDOW_S``, measured joules a step beside the executor's
    modeled ones."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.examples import train_gpt3xl_dvfs as ex
    from repro_torch.models import build_model
    from repro_torch.obs import check_executor
    events, readings = [], []
    cfg = get_config("gpt3-xl")
    leaves = sum(math.prod(s) for s in _leaves(
        build_model(cfg, device="cpu").param_shapes()))

    class TimedCheckpoints(CheckpointManager):
        def save(self, step, state, extra=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = super().save(step, state, extra)
            events.append(("save", step, _dir_bytes(path),
                           time.perf_counter() - t0))
            return path

        def restore(self, template, step=None):
            step = self.latest_step() if step is None else step
            t0 = time.perf_counter()
            out = super().restore(template, step)
            torch.cuda.synchronize()
            events.append(("restore", step,
                           _dir_bytes(self._step_dir(step)),
                           time.perf_counter() - t0))
            return out

    make = ex.make_train_step

    def metered(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            torch.cuda.synchronize()
            e0, t0 = nvml.energy_j(), time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            readings.append((nvml.energy_j() - e0,
                             time.perf_counter() - t0))
            return state, metrics
        return run

    ckpt_dir = os.path.join(tmp, "ckpt")
    free = shutil.disk_usage(tmp).free
    log(f"[examples] train_gpt3xl_dvfs: checkpoints under a temporary "
        f"directory with {free / 1e9:.1f} GB free")
    torch.cuda.reset_peak_memory_stats()
    ex.CheckpointManager, ex.make_train_step = TimedCheckpoints, metered
    try:
        out, got, seconds = _run_example(
            "train_gpt3xl_dvfs", ex, EXAMPLE_TRAIN_FLAGS + [
                "--ckpt-dir", ckpt_dir, "--plan-out",
                os.path.join(tmp, "train_plan.json")])
    finally:
        ex.CheckpointManager, ex.make_train_step = CheckpointManager, make
    peak = torch.cuda.max_memory_allocated()
    hist, done, L = out["history"], out["done"], 24
    steps = int(EXAMPLE_TRAIN_FLAGS[EXAMPLE_TRAIN_FLAGS.index("--steps")
                                    + 1])
    per_step = {"rmsnorm": 0, "flash_prefill": 2 * L, "flash_bwd": 2 * L,
                "paged_decode": 0, "ssd_scan": 0}
    want = {k: v * EXAMPLE_TRAIN_STEPS_RUN for k, v in per_step.items()}
    phases = out["executor"].summary()["phases"]
    problems = check_executor(out["executor"])
    if (out["params"], leaves) != (cfg.param_count()[0], 1_418_207_232) \
            or done["restarts"] != 1 \
            or done["final_step"] != steps \
            or len(hist) != EXAMPLE_TRAIN_STEPS_RUN \
            or not all(math.isfinite(h["loss"]) for h in hist) \
            or problems or {k: r["steps"] for k, r in phases.items()} != \
            {"fwd": steps, "bwd": steps, "opt": steps} or got != want:
        raise AssertionError(
            f"examples train_gpt3xl_dvfs: params {out['params']} (leaves "
            f"{leaves}), restarts "
            f"{done['restarts']}, steps {[h['step'] for h in hist]}, losses "
            f"{[h['loss'] for h in hist]}, executor {problems}, phases "
            f"{phases}, launches {got} != {want}")
    _same_plan("train_gpt3xl_dvfs", out["path"], out["plan"])
    saves = [e for e in events if e[0] == "save"]
    if [e[1] for e in saves] != [10, steps] or \
            [e[:2] for e in events if e[0] == "restore"] != \
            [("restore", 10)]:
        raise AssertionError(f"examples train_gpt3xl_dvfs: checkpoint "
                             f"events {events}")
    # the steady steps: all but the first and the first after the restart
    steady = [r for i, r in enumerate(readings) if i not in (0, 11)]
    wall = [h["wall_s"] for i, h in enumerate(hist) if i not in (0, 11)]
    tokens = 16 * 1024
    log(f"[examples] train_gpt3xl_dvfs: {leaves:,} parameters (the "
        f"config's count, which the example prints: {out['params']:,}), "
        f"{len(hist)} steps run of 16 x 1024 tokens (2 micro-batches of 8), "
        f"losses {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
        f"{done['restarts']} restart; a steady step {np.mean(wall):.4f} s "
        f"(median {np.median(wall):.4f}, steps 1-10 and the 12th) = "
        f"{tokens / np.mean(wall):.1f} tokens/s; the first step "
        f"{hist[0]['wall_s']:.3f} s, the first after the restore "
        f"{hist[11]['wall_s']:.3f} s; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {got} (exact: {per_step} a step)")
    for kind, step, nbytes, s in events:
        log(f"[examples] train_gpt3xl_dvfs: checkpoint {kind} at step "
            f"{step}: {nbytes:,} bytes in {s:.2f} s "
            f"({nbytes / s / 1e9:.2f} GB/s, warm file cache)")
    joules, secs = sum(r[0] for r in steady), sum(r[1] for r in steady)
    tot = done["dvfs"]["totals"]
    plan_e = np.mean([h["dvfs_energy_j"] for i, h in enumerate(hist)
                      if i not in (0, 11)])
    base_e = tot["base_energy_j"] / steps
    if secs >= DVFS_WINDOW_S:
        n = len(steady)
        log(f"[examples] train_gpt3xl_dvfs: NVML over the {n} steady steps "
            f"({secs:.3f} s): {joules / n:.2f} J a step "
            f"({(joules - idle_w * secs) / n:.2f} net of {idle_w:.2f} W "
            f"idle); modeled a step (h100_like): the plan {plan_e:.3f} J, "
            f"auto {base_e:.3f} J; measured / modeled "
            f"{joules / n / plan_e:.3f} (plan), {joules / n / base_e:.3f} "
            f"(auto)")
    else:
        log(f"[examples] train_gpt3xl_dvfs: the steady steps last {secs:.3f}"
            f" s, under the {DVFS_WINDOW_S} s energy window: NVML joules not "
            f"reported")
    return {"launches": got, "seconds": seconds, "step_s": float(
        np.mean(wall)), "peak_bytes": peak, "checkpoints": events,
        "joules_per_step": joules / len(steady) if secs >= DVFS_WINDOW_S
        else None, "modeled_j": (plan_e, base_e)}


def phase_examples(idle_w):
    """The README's five examples, each through its ``main(argv)`` on the
    card (``--chip`` h100, the default): quickstart and plan_transfer and
    fleet_serve on chip models alone (host only), serve_dvfs on the full
    llama3.2-1b in bf16 with bf16 pages behind its session's executor,
    train_gpt3xl_dvfs on the full gpt3-xl (``example_train``).  Gates:
    each returns; each saved plan round-trips through ``DvfsPlan.load``;
    quickstart's kernel-static plan spends no more energy than its
    pass-level one, at no more time than auto (tau 0); serve_dvfs's
    executor hooks against the engine's requests and decode steps
    (``_check_hooks``), every request served whole, its exact launches
    (``llama_launches`` over the engine's calls, graph replays counted);
    train_gpt3xl_dvfs's gates.  The host-only examples touch no kernel.
    Artifacts and checkpoints go to a temporary directory the phase
    removes.  Returns the device examples' launches by example."""
    from repro_torch.examples import (fleet_serve, plan_transfer, quickstart,
                                      serve_dvfs)
    zero = {"rmsnorm": 0, "flash_prefill": 0, "flash_bwd": 0,
            "paged_decode": 0, "ssd_scan": 0}
    out = {}
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="examples_", dir=build) as tmp:
        q, got, _ = _run_example("quickstart", quickstart, [
            "--plan-out", os.path.join(tmp, "quickstart_plan.json")])
        plans = q["plans"]
        if got != zero or not q["round_trips"] or \
                plans["kernel-static"]["energy_pct"] > \
                plans["pass-level"]["energy_pct"] or \
                plans["kernel-static"]["time_pct"] > 1e-6:
            raise AssertionError(f"examples quickstart: launches {got}, "
                                 f"round trip {q['round_trips']}, plans "
                                 f"{plans}")
        _same_plan("quickstart", q["path"], q["plan"].summary()["phases"])
        log("[examples] quickstart (modeled, h100_like): " + "; ".join(
            q["lines"][1:-1]))
        p, got, _ = _run_example("plan_transfer", plan_transfer, [])
        if got != zero:
            raise AssertionError(f"examples plan_transfer: launches {got}")
        log("[examples] plan_transfer (modeled, h100_like): " + "; ".join(
            ln for ln in p["lines"][1:] if ln))
        f, got, _ = _run_example("fleet_serve", fleet_serve, [])
        if got != zero:
            raise AssertionError(f"examples fleet_serve: launches {got}")
        log("[examples] fleet_serve (modeled, h100_like): " + "; ".join(
            f["lines"][1:5]))
        s, got, _ = _run_example("serve_dvfs", serve_dvfs, [
            "--plan-out", os.path.join(tmp, "serve_plan.json")])
        want = llama_launches(s["n_decode_steps"], s["n_prefill_calls"])
        reqs = s["requests"]
        if got != want or not all(r.done and len(r.generated) ==
                                  r.max_new_tokens for r in reqs):
            raise AssertionError(f"examples serve_dvfs: launches {got} != "
                                 f"{want}, or a request unfinished")
        _check_hooks("examples serve_dvfs", s["executor"], len(reqs),
                     s["n_decode_steps"])
        _same_plan("serve_dvfs", s["path"], s["plan"])
        log(f"[examples] serve_dvfs: llama3.2-1b at full width, bf16 pages, "
            f"{len(reqs)} requests, {s['tokens']} tokens in "
            f"{s['seconds']:.3f} s = {s['tokens'] / s['seconds']:.1f} "
            f"tokens/s (the captures included); {s['n_prefill_calls']} "
            f"prefill calls, {s['n_decode_steps']} decode steps = the "
            f"executor's hooks; launches {got} (exact); executed (modeled, "
            f"h100_like) {s['executed']}")
        out["serve_dvfs"] = got
        del s
        release()
        nvml = Nvml()
        try:
            t = example_train(tmp, nvml, idle_w)
        finally:
            nvml.close()
        out["train_gpt3xl_dvfs"] = t["launches"]
        out["train"] = t
    release()
    return out


# ---------------------------------------------------------------------------
# 5a'. serve gpt3-xl (the paper's GPT-3 1.3B) at full width, and its
# prefill / decode consistency
# ---------------------------------------------------------------------------

def gpt3_launches(layers: int, paged: bool = True):
    """gpt3-xl's exact launch counts: no RMSNorm (LayerNorm has no kernel),
    ``layers`` prefill attentions a prefill call, ``layers`` paged decodes a
    decode step on pages, none on a dense cache."""
    return lambda steps, calls: llama_launches(steps, calls, paged, layers,
                                               norms=False)


def phase_serve_gpt3(cfg, model, params):
    """gpt3-xl at full width and depth: ``serve_full_model`` with its exact
    launches (24 flash prefills a bucket call, 24 paged decodes a paged
    step, no RMSNorm).  Returns the graphs-on runs' launches by page
    type."""
    return serve_full_model("serve_gpt3", cfg, model, params,
                            lambda paged: gpt3_launches(cfg.n_layers, paged),
                            graphs_off=True)


def serve_full_model(tag, cfg, model, params, launches, prompts=None,
                     new_tokens=SERVE_NEW_TOKENS, extras=None,
                     profile_extras=None, graphs_off=False):
    """A model at full width serves ``prompts`` (by default the serve
    phase's 16 requests; ``extras``, per prompt, as ``serve_run`` takes
    them), ``new_tokens`` new tokens each, with bf16 pages, CUDA graphs
    on, then the on/off gate's requests (``ONOFF``) on the same engine;
    with ``graphs_off`` those requests on bf16 pages with graphs off too
    (equal tokens: the graphs' replay against eager decode); then those
    requests with ``CAPTURE_NEW_TOKENS`` each on int8 pages and on a
    dense cache, graphs on (each the capturing run alone): exact launches (``launches(paged)``, a
    ``want(steps, calls)``), no NaN logit; logs tokens/s, peak memory and
    each capture's host ms, and the int8 and dense runs' agreement with
    bf16 pages on the same requests.  (Over the whole workload these two
    runs repeated the bf16 run's with only the cache type changed;
    llama3.2-1b's int8 run in ``phase_serve`` keeps the whole workload,
    and each model's int8 decode is held to a longer prefill in its
    consistency phase.)  (The models served without ``graphs_off`` have
    their on/off equality gated elsewhere: llama3.2-3b and yi-34b run
    llama3.2-1b's decode step, gated in ``phase_serve``, at other kernel
    instantiations; llama4-scout in ``phase_serve_llama4_long``.)  Then a
    short profiled bf16-page run with graphs on (each request with
    ``profile_extras``), with its decode steps alone.  Returns the
    graphs-on runs' launches by page type, and the profiled run's decode
    step under "profile" (``phase_profile``'s summary)."""
    if prompts is None:
        prompts = serve_prompts(cfg.vocab_size, tag)
    runs = {("bf16", True): serve_run(
        f"{tag} bf16", model, params, prompts, new_tokens, True,
        launches(True), extras=extras, also=ONOFF, paged=True)}
    if graphs_off:
        off = runs["bf16", False] = onoff_run(
            f"{tag} bf16", model, params, prompts, launches(True),
            extras=extras, paged=True)
        same_onoff(tag, "bf16", runs["bf16", True], off)
    n = SERVE_SLOTS
    for label, kw in (("int8", dict(paged=True, kv_dtype="int8")),
                      ("dense", dict(paged=False))):
        runs[label, True] = serve_run(
            f"{tag} {label}", model, params, prompts[:n],
            CAPTURE_NEW_TOKENS, True, launches(kw["paged"]), extras=None if extras is None
            else extras[:n], timed=False, **kw)
    # the dense path scales q in bf16 by a factor rounded to bf16, the
    # paged kernel in f32 (as the reference's two paths do), and int8 pages
    # quantize: logged against bf16 pages, not gated
    for other in ("int8", "dense"):
        a, b = runs[other, True]["tokens"], runs["bf16", True]["also_tokens"]
        same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
        log(f"[{tag}] {other} against bf16 pages: {same} of "
            f"{sum(len(r) for r in a)} greedy tokens equal")
    out = {label: runs[label, True]["launches"]
           for label in ("bf16", "int8")}
    out["profile"] = phase_profile(cfg, model, params,
                                   tag=tag.replace("serve", "profile"),
                                   paged=True, detail=True,
                                   extras=profile_extras)
    out["peak_bytes"] = max(r["peak_bytes"] for r in runs.values())
    return out


def phase_consistency_gpt3(model, params):
    """``phase_consistency`` on gpt3-xl, bf16 and int8 pages: each decode
    step adds ``wpe[pos]``, the longer prefill ``wpe[0:S]``, so a position
    off by one shows here."""
    return [phase_consistency(model, params, kv_dtype=kv,
                              tag=f"consistency_gpt3, {kv or 'bf16'} pages")
            for kv in (None, "int8")]


# ---------------------------------------------------------------------------
# 5a''. serve llama3.2-3b and granite-moe-1b-a400m at full width, and their
# prefill / decode consistency
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"


def _llama_style(layers: int):
    """``launches(paged)`` of a RoPE / RMSNorm decoder of ``layers`` layers
    (``llama_launches``): llama3.2-3b, and granite-moe-1b-a400m, whose MoE
    layer launches none of the port's kernels."""
    return lambda paged: (lambda s, c: llama_launches(s, c, paged, layers))


def phase_serve_llama3b(cfg, model, params):
    """llama3.2-3b at full width and depth: ``serve_full_model`` with its
    exact launches (57 RMSNorms a forward, 28 flash prefills at head_dim
    128 with 3 query heads per KV head a bucket call, 28 paged decodes a
    paged step).  Returns the graphs-on runs' launches by page type."""
    return serve_full_model("serve_llama3b", cfg, model, params,
                            _llama_style(cfg.n_layers))


def phase_consistency_llama3b(model, params):
    """``phase_consistency`` on llama3.2-3b, bf16 and int8 pages."""
    return [phase_consistency(model, params, kv_dtype=kv,
                              tag=f"consistency_llama3b, {kv or 'bf16'} "
                                  f"pages")
            for kv in (None, "int8")]


class HeldPath:
    """Holds an MoE model's longer prefill to its decode path, for
    ``phase_consistency``: while active it wraps ``common.route_top_k``
    (the MoE layer's routing) and the model's ``_mlp_block`` (a layer's
    residual after its MoE layer).

    After :meth:`record` each call keeps, layer by layer, the experts chosen
    and the residual at the positions it computes (a prefill's whole rows,
    or a decode step's token a row at ``pos``).  After :meth:`apply` a
    longer prefill takes, at every position up to each row's ``pos``, the
    recorded experts (top-k weights from its own probabilities,
    renormalised as the layer does); with ``hold`` "hold", after each layer
    but the last, the recorded residual at those positions too, so that
    each layer starts from the decode path's state: its output at the
    decoded token then parts from the decode path's by that layer's own
    rounding, and its own routing flips only at near-ties.  Both must hold
    (:meth:`summary`)."""

    def __init__(self, model, B: int, S: int, hold: str):
        cfg = model.cfg
        assert hold in ("experts", "hold"), hold
        self.model, self.hold = model, hold
        self.routes = torch.zeros(cfg.n_layers, B, S, cfg.moe.top_k,
                                  dtype=torch.long, device=model.device)
        self.stream = torch.zeros(cfg.n_layers, B, S, cfg.d_model,
                                  dtype=model.compute_dtype,
                                  device=model.device)

    def __enter__(self):
        from repro_torch.models import common as cm
        self.cm, self.orig_route = cm, cm.route_top_k
        self.orig_block = self.model._mlp_block
        cm.route_top_k = self._route
        self.model._mlp_block = self._block
        return self

    def __exit__(self, *exc):
        self.cm.route_top_k = self.orig_route
        del self.model._mlp_block

    def _set(self, recording: bool, pos):
        self.recording = recording
        self.pos = None if pos is None else pos.long()
        self.route_layer = self.block_layer = 0
        self.flips, self.parted = [], []

    def record(self, pos=None):
        """The next call (a prefill, or a decode step at ``pos``) records."""
        self._set(True, pos)

    def apply(self, pos):
        """The next call, a prefill, is held up to each row's ``pos``."""
        self._set(False, pos)

    def _held(self, S: int) -> torch.Tensor:
        """(B, S): the positions up to each row's ``pos``."""
        return (torch.arange(S, device=self.pos.device)[None, :]
                <= self.pos[:, None])

    def _route(self, xt, router, top_k):
        logits, probs, top_w, top_e = self.orig_route(xt, router, top_k)
        layer, B = self.route_layer, self.routes.shape[1]
        self.route_layer += 1
        S = xt.shape[0] // B
        if self.recording:
            if self.pos is None:                          # a prefill
                self.routes[layer, :, :S] = top_e.view(B, S, top_k)
            else:                                         # a decode step
                self.routes[layer, torch.arange(B), self.pos] = top_e
            return logits, probs, top_w, top_e
        at = self._held(S).reshape(B * S, 1)
        chosen = torch.where(at, self.routes[layer, :, :S].reshape(
            B * S, top_k), top_e)
        if self.hold == "hold":
            top = probs.topk(top_k + 1, dim=-1).values
            self.flips.append((at[:, 0] & (chosen.sort(-1).values
                                           != top_e.sort(-1).values).any(-1),
                               top[:, top_k - 1] - top[:, top_k]))
        w = probs.gather(-1, chosen)
        return logits, probs, w / torch.clamp(w.sum(-1, keepdim=True),
                                              min=1e-9), chosen

    def _block(self, lp, x, drop=True, tp=None):
        out, aux = self.orig_block(lp, x, drop, tp)
        if self.hold != "hold":
            return out, aux
        layer = self.block_layer
        self.block_layer += 1
        B, S = out.shape[:2]
        rows = torch.arange(B, device=out.device)
        if self.recording:
            if self.pos is None:
                self.stream[layer, :, :S] = out
            else:
                self.stream[layer, rows, self.pos] = out[:, 0]
            return out, aux
        mine = out[rows, self.pos].float()
        theirs = self.stream[layer, rows, self.pos].float()
        self.parted.append(((mine - theirs).norm(dim=-1)
                            / theirs.norm(dim=-1)).max())
        if layer < self.stream.shape[0] - 1:
            out = torch.where(self._held(S)[..., None],
                              self.stream[layer, :, :S], out)
        return out, aux

    def summary(self) -> str:
        """The last held prefill: with ``hold`` "hold", each layer's parting
        at the decoded token and the flips of its own routing; raises where
        a layer parts by more than ``CONSISTENCY_TOL`` or a flip's f32
        margin is ``ROUTE_FLIP_MARGIN`` or more."""
        if self.hold != "hold":
            return "the prefill held to the decode path's experts"
        flip = torch.stack([f for f, _ in self.flips])
        margin = torch.stack([m for _, m in self.flips])[flip]
        parted = torch.stack(self.parted).tolist()
        n = int(flip.sum())
        if n and float(margin.max()) >= ROUTE_FLIP_MARGIN:
            raise AssertionError(f"a routing flip at an f32 top-k margin of "
                                 f"{float(margin.max()):.2e} >= "
                                 f"{ROUTE_FLIP_MARGIN}: not a near-tie")
        worst = max(range(len(parted)), key=parted.__getitem__)
        if parted[worst] > CONSISTENCY_TOL:
            raise AssertionError(f"layer {worst}'s output at the decoded "
                                 f"token parts from the decode path's by "
                                 f"{parted[worst]:.4f} > {CONSISTENCY_TOL}")
        return ("the prefill held to the decode path's experts and "
                "residual: its layers' outputs at the decoded token part "
                "from the decode path's by (relative L2, by layer) "
                + " ".join(f"{v:.1e}" for v in parted)
                + f"; its own routing: {n} of {flip.numel()} (position, "
                f"layer) choices differ"
                + ("" if not n else
                   f", at f32 top-k margins {float(margin.min()):.2e}.."
                   f"{float(margin.max()):.2e}"))


@contextlib.contextmanager
def plain_path():
    """The port's plain path on the card: the model's kernel wrappers
    (prefill attention, paged decode, RMSNorm, the SSD scan) replaced by
    their plain versions, and the expert products by one ``torch.mm`` an
    expert, so that a float32 model runs end to end."""
    from repro_torch.kernels.flash_attention.paged import paged_attention_ref
    from repro_torch.kernels.flash_attention.prefill import flash_prefill_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.kernels.ssd_scan import ssd_ref
    from repro_torch.models import common as cm
    from repro_torch.models import ssm

    def grouped_mm(a, w, offs):
        out, start = a.new_empty(a.shape[0], w.shape[-1]), 0
        for e, end in enumerate(offs.tolist()):
            out[start:end] = a[start:end] @ w[e]
            start = end
        return out
    saved = (cm.flash_prefill, cm.paged_flash_decode, cm.rmsnorm,
             torch._grouped_mm, ssm.ssd_scan)
    cm.flash_prefill, cm.paged_flash_decode, cm.rmsnorm = (
        flash_prefill_ref, paged_attention_ref, rmsnorm_ref)
    torch._grouped_mm = grouped_mm
    ssm.ssd_scan = ssd_ref
    try:
        yield
    finally:
        (cm.flash_prefill, cm.paged_flash_decode, cm.rmsnorm,
         torch._grouped_mm, ssm.ssd_scan) = saved


def moe_share(cfg, model, params, tag: str = "serve_moe"):
    """The MoE layer's share of the device time of a prefill bucket (8 rows
    of 512 tokens) and of a decode step (8 slots on a dense cache): the
    call, and its 24 ``apply_moe`` calls alone on the inputs they got in
    it, each captured in a CUDA graph and replayed (``time_graph_ms``: no
    host in the loop).  Logged."""
    from repro_torch.models import common as cm
    orig, calls = cm.apply_moe, []

    def recorded(p, x, **kw):
        calls.append((p, x.clone(), kw))
        return orig(p, x, **kw)
    rng = np.random.default_rng(9)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 512)),
                        dtype=torch.int32, device="cuda")
    logits, cache = model.prefill(params, toks, max_seq=SERVE_MAX_SEQ)
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.full((SERVE_SLOTS,), 512, dtype=torch.int32, device="cuda")
    for what, fn in (
            ("prefill bucket (8 x 512)", lambda: model.prefill(
                params, toks, max_seq=SERVE_MAX_SEQ)),
            ("decode step (8 slots, dense cache)", lambda:
             model.decode_step(params, cache, tok, pos))):
        calls.clear()
        cm.apply_moe = recorded
        try:
            fn()
        finally:
            cm.apply_moe = orig
        layers = list(calls)
        step = time_graph_ms(fn, 1, replays=3)
        moe = time_graph_ms(lambda: [orig(p, x, **kw)
                                     for p, x, kw in layers], 1, replays=3)
        log(f"[{tag}] MoE share of a {what}: its {len(layers)} MoE "
            f"layers {moe:.3f} of {step:.3f} ms of device time "
            f"({moe / step:.3f}), both replayed from a CUDA graph")
    del cache, calls, layers
    release()


def phase_serve_moe(cfg, model, params):
    """granite-moe-1b-a400m at full width and depth: ``serve_full_model``
    with its exact launches (49 RMSNorms a forward, 24 flash prefills at
    head_dim 64 with 2 query heads per KV head a bucket call, 24 paged
    decodes a paged step; the MoE layer's products are library GEMMs, every
    routed pair kept), then the MoE layer's share of a prefill bucket's and
    a decode step's device time (``moe_share``).  Returns the graphs-on
    runs' launches by page type."""
    out = serve_full_model("serve_moe", cfg, model, params,
                           _llama_style(cfg.n_layers),
                           graphs_off=True)
    moe_share(cfg, model, params)
    return out


def phase_consistency_moe(model, params):
    """``phase_consistency`` on granite-moe-1b-a400m at full width and
    depth.  End to end: the same weights in float32 on the port's plain
    path (``plain_path``, f32 pages), the longer prefill held to the decode
    path's experts, which leaves the two paths' f32 rounding alone.  Beside
    it, the main path (the kernels, bf16 and int8 pages): the longer
    prefill held to the decode path's experts and residual, each layer's
    output at the decoded token and the logits within the gate, each flip
    of its own routing a near-tie (``HeldPath``)."""
    from repro_torch.models import build_model
    fmodel = build_model(dataclasses.replace(model.cfg,
                                             compute_dtype="float32"),
                         device="cuda")

    def as_f32(tree):
        return {k: as_f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}
    fparams = as_f32(params)
    with plain_path():
        out = [phase_consistency(fmodel, fparams, hold="experts",
                                 tag="consistency_moe, float32 plain path, "
                                     "f32 pages")]
    del fmodel, fparams
    release()
    return out + [phase_consistency(model, params, kv_dtype=kv,
                                    tag=f"consistency_moe, {kv or 'bf16'} "
                                        f"pages")
                  for kv in (None, "int8")]


# ---------------------------------------------------------------------------
# 5a'''. serve internvl2-1b (the VLM patch prefix) and yi-34b at full width,
# and their prefill / decode consistency
# ---------------------------------------------------------------------------

def vlm_extras(cfg, n: int):
    """The VLM serve phase's prefill inputs: ``VLM_PREFIX`` seeded patch
    rows of width d_model (float32, as a stub ViT would hand them over) on
    every even request, none on the odd ones (text-only requests)."""
    rng = np.random.default_rng(24)
    return [{"patch_embeds": rng.normal(size=(1, VLM_PREFIX, cfg.d_model)
                                        ).astype(np.float32)}
            if i % 2 == 0 else {} for i in range(n)]


def phase_serve_vlm(cfg, model, params):
    """internvl2-1b at full width and depth: ``serve_full_model`` over the
    serve phase's 16 prompts, the even ones behind 256 seeded patch rows
    (``vlm_extras``), the odd ones text-only, so that a round's admissions
    take a prefill call per (bucket, extras signature); exact launches as
    llama3.2-1b's at 24 layers (49 RMSNorms a forward, 24 flash prefills at
    head_dim 64 with 7 query heads per KV head a prefill call, 24 paged
    decodes a paged step).  Returns the graphs-on runs' launches by page
    type."""
    prompts = serve_prompts(cfg.vocab_size, "serve_vlm")
    extras = vlm_extras(cfg, len(prompts))
    log(f"[serve_vlm] requests 0, 2, .. carry {VLM_PREFIX} patch rows of "
        f"width {cfg.d_model} (positions 0..{VLM_PREFIX - 1}); 1, 3, .. "
        f"are text-only")
    return serve_full_model("serve_vlm", cfg, model, params,
                            _llama_style(cfg.n_layers), prompts=prompts,
                            extras=extras,
                            graphs_off=True)


def phase_consistency_vlm(model, params):
    """``phase_consistency`` on internvl2-1b, bf16 and int8 pages, both
    prefills behind the same 256 seeded patch rows."""
    return [phase_consistency(model, params, kv_dtype=kv, prefix=VLM_PREFIX,
                              tag=f"consistency_vlm, {kv or 'bf16'} pages")
            for kv in (None, "int8")]


def phase_train_vlm():
    """Train internvl2-1b at full width and depth, 8 rows a step as
    ``TRAIN_ACCUM`` micro-batches of 4, each row 256 seeded patch rows and
    768 text tokens (the loss over the text), as ``phase_train`` trains
    llama3.2-1b.  Launches a step as for llama3.2-1b at 24 layers, the
    attention at head_dim 64 with 7 query heads per KV head over 1024
    positions.  Returns ``train_model``'s summary."""
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    L, A = cfg.n_layers, TRAIN_ACCUM
    per_step = {"rmsnorm": A * (2 * L + 1 + 2 * L),
                "flash_prefill": A * 2 * L, "flash_bwd": A * L,
                "paged_decode": 0, "ssd_scan": 0}
    ours = {"flash_bwd (D64G7)": "flash_bwd_",
            "flash_bwd dK/dV": "flash_bwd_dkv_kernel",
            "flash_bwd dQ": "flash_bwd_dq_kernel",
            "flash_prefill (D64G7, lse)": "flash_prefill_kernel",
            "rmsnorm": "rmsnorm_kernel",
            "unaligned-operand GEMMs (the head at vocab 151655)": "align1"}
    return train_model("train_vlm", cfg, _describe, per_step, ours,
                       accum=A, prefix=VLM_PREFIX)


def yi_prompts(vocab: int):
    """yi-34b's ``YI_REQUESTS`` seeded prompts of 65-128 tokens: one prompt
    bucket (128)."""
    rng = np.random.default_rng(34)
    plens = rng.integers(65, 129, YI_REQUESTS)
    log(f"[serve_yi] {YI_REQUESTS} requests, prompt lengths "
        f"{sorted(int(n) for n in plens)}, {YI_NEW_TOKENS} new tokens each")
    return [rng.integers(0, vocab, n).astype(np.int32) for n in plens]


def phase_serve_yi(cfg, model, params):
    """yi-34b at full width and ``YI_SERVE_LAYERS`` of its 60 layers (56
    heads over 8 at head_dim 128; 34.4 GB of bf16 weights at 30 layers):
    ``serve_full_model`` over ``yi_prompts`` (one prompt bucket; each
    engine captures that bucket's prefill graph and its decode chunks'
    graphs, no other), exact launches (2 RMSNorms a layer and the final
    one a forward, a flash prefill at head_dim 128 with 7 query heads per
    KV head a layer and prefill call, a paged decode a layer and paged
    step),
    peak memory; then the profiled decode step's wall and device ms
    against the floor of reading the weights once (``bytes / 3.35
    TB/s``).  An out-of-memory error fails the phase.  Returns the
    graphs-on runs' launches by page type."""
    prompts = yi_prompts(cfg.vocab_size)
    out = serve_full_model("serve_yi", cfg, model, params,
                           _llama_style(cfg.n_layers), prompts=prompts,
                           new_tokens=YI_NEW_TOKENS)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    floor = nbytes / HBM_BYTES_PER_S * 1e3
    step = out["profile"]
    log(f"[serve_yi] weights {nbytes / 1e9:.2f} GB: a decode step cannot "
        f"take less than {floor:.2f} ms (read once at 3.35 TB/s); the "
        f"decode step alone (graphs on) " + (
            "not measured" if step is None else
            f"{step['wall_ms']:.2f} ms of wall ({step['wall_ms'] / floor:.2f}x"
            f"), {step['device_ms']:.2f} ms of device "
            f"({step['device_ms'] / floor:.2f}x)")
        + f"; peak memory {out['peak_bytes'] / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
    return out


def phase_consistency_yi(model, params):
    """``phase_consistency`` on yi-34b, bf16 and int8 pages."""
    return [phase_consistency(model, params, kv_dtype=kv,
                              tag=f"consistency_yi, {kv or 'bf16'} pages")
            for kv in (None, "int8")]


# ---------------------------------------------------------------------------
# 5a''''. serve and train seamless-m4t-medium (the encoder-decoder) at full
# width, and its prefill / decode consistency
# ---------------------------------------------------------------------------

def encdec_launches(cfg):
    """``launches(paged)`` of seamless-m4t-medium: no RMSNorm (LayerNorm
    has no kernel); n_encoder_layers + 2 n_layers flash prefills a prefill
    call (12 encoder self-attentions, 12 decoder self-attentions, 12
    cross-attentions: 36); n_layers paged decodes a paged decode step (the
    cross-attention decode is the plain ``common.decode_attention``), none
    on a dense cache."""
    n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers

    def launches(paged):
        def want(steps, calls):
            return {"rmsnorm": 0, "flash_prefill": n_attn * calls,
                    "flash_bwd": 0,
                    "paged_decode": cfg.n_layers * steps if paged else 0,
                    "ssd_scan": 0}
        return want
    return launches


def encdec_extras(cfg, n: int):
    """The encoder-decoder serve phase's prefill inputs: each request's own
    ``ENCDEC_FRAMES`` seeded frames of width d_model (float32, as a stub
    speech frontend would hand them over)."""
    rng = np.random.default_rng(25)
    return [{"frames": rng.normal(size=(1, ENCDEC_FRAMES, cfg.d_model)
                                  ).astype(np.float32)} for _ in range(n)]


def cross_decode_share(cfg, step):
    """The plain cross-attention decode's device time a decode step:
    n_layers calls of ``common.decode_attention`` over the dense cross K/V
    of ``SERVE_SLOTS`` slots at pos F - 1 (bf16 caches upcast to f32 each
    call, as the decode step runs them), replayed from one CUDA graph,
    against the profiled decode step's device ms ``step`` (computed share;
    logged).  Returns the ms."""
    from repro_torch.models.common import decode_attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    L, B, Fr = cfg.n_layers, SERVE_SLOTS, cfg.encoder_frontend_len
    H, KV, D = ENCDEC_ATTN["H"], ENCDEC_ATTN["KV"], ENCDEC_ATTN["D"]
    ck, cv = (torch.randn(L, B, Fr, KV, D, generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").bfloat16()
    pos = torch.full((B,), Fr - 1, dtype=torch.int32, device="cuda")

    def layers():
        for i in range(L):
            decode_attention(q, ck[i], cv[i], pos=pos)
    ms = time_graph_ms(layers, calls=1, replays=10)
    nbytes = 2 * ck.numel() * ck.element_size()
    log(f"[serve_encdec] cross-attention decode (common.decode_attention, "
        f"{L} layers x {B} slots x {Fr} frames, bf16 K/V {nbytes / 1e6:.0f} "
        f"MB read and upcast to f32 each step): {ms:.4f} ms a step "
        f"replayed from a graph (reading the bf16 K/V once: "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
        + ("the profiled decode step's device time: not measured"
           if step is None else
           f"{ms / step['device_ms']:.3f} of the profiled decode step's "
           f"{step['device_ms']:.2f} ms of device (computed)"))
    del ck, cv
    release()
    return ms


def phase_serve_encdec(cfg, model, params):
    """seamless-m4t-medium at full width and depth (12 encoder and 12
    decoder layers, d_model 1024, 16 heads over 16 at head_dim 64, vocab
    256206 untied; 0.920 B parameters): ``serve_full_model`` over the serve
    phase's 16 prompts, each request with its own 1024 seeded frames
    (``encdec_extras``): bf16 and int8 pages (the self-attention K/V; the
    cross K/V stay dense bf16 rows) and a dense cache (bf16 pages with
    graphs on and off, the others on), exact launches
    (``encdec_launches``); then the profiled decode step
    (its head GEMM's share logged: ``align2`` kernels) and the cross-attention
    decode's share of it (``cross_decode_share``).  Returns the graphs-on
    runs' launches by page type."""
    prompts = serve_prompts(cfg.vocab_size, "serve_encdec")
    extras = encdec_extras(cfg, len(prompts))
    log(f"[serve_encdec] every request carries {ENCDEC_FRAMES} frames of "
        f"width {cfg.d_model} for the encoder (no cache position)")
    out = serve_full_model("serve_encdec", cfg, model, params,
                           encdec_launches(cfg), prompts=prompts,
                           extras=extras, profile_extras=extras[0],
                           graphs_off=True)
    out["cross_ms"] = cross_decode_share(cfg, out["profile"])
    return out


def phase_consistency_encdec(model, params):
    """``phase_consistency`` on seamless-m4t-medium, bf16 and int8 pages,
    both prefills encoding the same 1024 seeded frames a row (the decode
    step's cross-attention reads the dense cross K/V the first prefill
    left)."""
    return [phase_consistency(model, params, kv_dtype=kv,
                              frames=ENCDEC_FRAMES,
                              tag=f"consistency_encdec, {kv or 'bf16'} "
                                  f"pages")
            for kv in (None, "int8")]


def phase_train_encdec():
    """Train seamless-m4t-medium at full width and depth, 8 rows a step as
    ``TRAIN_ACCUM`` micro-batches of 4, each row 1024 seeded frames for the
    encoder and ``ENCDEC_TEXT`` text tokens for the decoder (the loss over
    the text), as ``phase_train`` trains llama3.2-1b.  Per micro-batch,
    counted from the code (``tests/test_torch_encdec.py`` counts the same
    calls on the CPU): 36 flash forwards with their log-sum-exp (12
    encoder non-causal at S 1024, 12 decoder causal at S 512, 12
    cross-attention non-causal at Sq 512 over Sk 1024) and 36 more in the
    recompute under remat, 36 flash backwards; no RMSNorm.  Returns
    ``train_model``'s summary."""
    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC_ARCH)
    A, n_attn = TRAIN_ACCUM, cfg.n_encoder_layers + 2 * cfg.n_layers
    per_step = {"rmsnorm": 0, "flash_prefill": A * 2 * n_attn,
                "flash_bwd": A * n_attn, "paged_decode": 0, "ssd_scan": 0}
    ours = {"flash_bwd (D64G1)": "flash_bwd_",
            "flash_bwd dK/dV": "flash_bwd_dkv_kernel",
            "flash_bwd dQ": "flash_bwd_dq_kernel",
            "flash_prefill (D64G1, lse)": "flash_prefill_kernel",
            "LayerNorm (PyTorch's)": "layer_norm",
            "unaligned-operand GEMMs (the head at vocab 256206)": "align2"}

    def describe(m):
        c = m.cfg
        return (f"{c.n_encoder_layers} encoder + {c.n_layers} decoder "
                f"layers, d={c.d_model} H={c.n_heads}/{c.n_kv_heads} "
                f"D={c.resolved_head_dim} ff={c.d_ff} {c.norm} norm, "
                f"{c.activation}")
    return train_model("train_encdec", cfg, describe, per_step, ours,
                       accum=A, frames=ENCDEC_FRAMES, seq=ENCDEC_TEXT)


# ---------------------------------------------------------------------------
# 5a*. serve llama4-scout-17b-a16e (local/global attention) and
# nemotron-4-340b at full width and reduced depth, their prefill / decode
# consistency, and train their card smoke configs
# ---------------------------------------------------------------------------

def llama4_launches(cfg):
    """``launches(paged)`` of llama4-scout at ``cfg``'s depth
    (``llama_launches`` with its global layer every ``global_attn_every``)."""
    return lambda paged: (lambda s, c: llama_launches(
        s, c, paged, cfg.n_layers, cfg.global_attn_every))


def decode_floor(cfg, params, slots: int = SERVE_SLOTS):
    """(bytes, ms) a decode step of ``slots`` slots must read at least: every
    weight once (computed) but the token table, of which it reads a row a
    slot, and the routed experts, of which it reads at most
    min(slots x top_k, E) a layer; at 3.35 TB/s."""
    total = sum(t.numel() * t.element_size() for t in _leaves(params))
    wte = params["embed"]["wte"]
    nbytes = total - wte.numel() * wte.element_size() \
        + slots * wte.shape[1] * wte.element_size()
    if cfg.is_moe:
        E = cfg.moe.n_experts
        experts = sum(t.numel() * t.element_size() for name, t in
                      params["layers"]["moe"].items()
                      if name not in ("router", "shared"))
        nbytes -= experts * (1 - min(slots * cfg.moe.top_k, E) / E)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def log_decode_floor(tag, cfg, params, step):
    """The profiled decode step (``step``: ``phase_profile``'s summary, or
    None) against ``decode_floor``; logged."""
    nbytes, floor = decode_floor(cfg, params)
    log(f"[{tag}] a decode step of {SERVE_SLOTS} slots reads at least "
        f"{nbytes / 1e9:.2f} GB of weights (computed): {floor:.2f} ms at "
        f"3.35 TB/s; the decode step alone (graphs on) " + (
            "not measured" if step is None else
            f"{step['wall_ms']:.2f} ms of wall ({step['wall_ms'] / floor:.2f}"
            f"x), {step['device_ms']:.2f} ms of device "
            f"({step['device_ms'] / floor:.2f}x)"))
    return floor


def ring_decode_share(tag, cfg, model, step, slots, W):
    """The plain ring-attention decode's device time a decode step: the
    model's local layers' ``_ring_attention`` calls over bf16 rings of
    ``slots`` x ``W`` positions, every slot valid (pos W - 1), replayed
    from one CUDA graph, against the profiled decode step's device ms
    ``step`` (computed share; logged; None: not measured).  Returns the
    ms."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    n_local = cfg.n_layers - cfg.n_layers // cfg.global_attn_every
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kc, vc = (torch.randn(n_local, slots, W, KV, D, generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    q = torch.randn(slots, 1, H, D, generator=gen, device="cuda").bfloat16()
    pos = torch.full((slots,), W - 1, dtype=torch.int32, device="cuda")
    s = torch.arange(W, device="cuda")[None, :]
    abs_pos = pos[:, None] - torch.remainder(pos[:, None] - s, W)

    def layers():
        for i in range(n_local):
            model._ring_attention(q, kc[i], vc[i], abs_pos, pos)
    ms = time_graph_ms(layers, calls=1, replays=10)
    nbytes = 2 * kc.numel() * kc.element_size()
    log(f"[{tag}] ring-attention decode (the reference's plain "
        f"_ring_attention, {n_local} local layers x {slots} slots x {W} "
        f"positions, bf16 rings {nbytes / 1e6:.0f} MB read and upcast to f32 "
        f"each step): {ms:.4f} ms a step replayed from a graph (reading the "
        f"bf16 rings once: {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
        + ("the decode step's device time: not measured" if step is None
           else f"{ms / step['device_ms']:.3f} of the profiled decode step's "
                f"{step['device_ms']:.2f} ms of device (computed)"))
    del kc, vc
    release()
    return ms


def phase_serve_llama4(cfg, model, params):
    """llama4-scout at full width and 8 of its 48 layers (two groups of 3
    local layers at window 8192 and a global one; 16 experts, top-1, the
    shared expert): ``serve_full_model`` over the serve phase's 16
    requests (max_seq 1024, so the rings hold 1024 positions and none
    wraps), bf16 and int8 pages (the global layers' K/V; the rings stay
    dense bf16) and a dense cache (graphs on), exact launches
    (``llama4_launches``: 17 RMSNorms a forward, 8 flash prefills a call,
    2 paged decodes a paged step); then the plain ring decode's share of
    the profiled decode step (``ring_decode_share``), the MoE layers'
    share of a prefill bucket and a decode step (``moe_share``), and the
    weight-read floor of a decode step (``decode_floor``).  Returns the
    graphs-on runs' launches by page type."""
    out = serve_full_model("serve_llama4", cfg, model, params,
                           llama4_launches(cfg))
    step = out["profile"]
    out["ring_ms"] = ring_decode_share(
        "serve_llama4", cfg, model, step, SERVE_SLOTS,
        min(cfg.attn_window, SERVE_MAX_SEQ))
    moe_share(cfg, model, params, tag="serve_llama4")
    log_decode_floor("serve_llama4", cfg, params, step)
    return out


def long_prompts(vocab: int):
    """The long traffic's ``LONG_PROMPTS`` seeded prompts."""
    rng = np.random.default_rng(16384)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LONG_PROMPTS]


def phase_serve_llama4_long(cfg, model, params):
    """llama4-scout's long traffic: ``LONG_SLOTS`` slots of
    ``LONG_MAX_SEQ`` positions (rings of 8192: 6 local layers x 4 slots x
    8192 x 8 KV heads x 128 x 2 bytes x 2 = 0.81 GB), the 4 prompts of
    8160-12000 tokens in the engine's buckets 8192 and 16384 (two prefill
    calls, the second of 3 rows: the local layers' window masks; the rows
    of 9000, 10500 and 12000 tokens wrap their rings in prefill, the one
    of 8160 at its 33rd new token),
    ``LONG_NEW`` new tokens each, on bf16 pages, graphs on and off: equal
    tokens, exact launches; then the ring decode at this geometry replayed
    alone (logged).  Returns the graphs-on run's launches."""
    prompts = long_prompts(cfg.vocab_size)
    log(f"[serve_llama4_long] {LONG_SLOTS} slots of {LONG_MAX_SEQ} "
        f"positions, prompts of {list(LONG_PROMPTS)} tokens, {LONG_NEW} new "
        f"tokens each, bf16 pages (rings of "
        f"{min(cfg.attn_window, LONG_MAX_SEQ)})")
    want = llama4_launches(cfg)(True)
    runs = [serve_run(f"serve_llama4_long bf16", model, params, prompts,
                      LONG_NEW, graphs, want, slots=LONG_SLOTS,
                      max_seq=LONG_MAX_SEQ, paged=True)
            for graphs in (True, False)]
    _same_tokens("serve_llama4_long", "bf16 pages", runs)
    ring_decode_share("serve_llama4_long", cfg, model, None, LONG_SLOTS,
                      min(cfg.attn_window, LONG_MAX_SEQ))
    return runs[0]["launches"]


def phase_consistency_llama4(model, params):
    """``phase_consistency`` on llama4-scout (8 layers, bf16) on bf16 and
    int8 pages at the serve geometry, the longer prefill held layer by
    layer to the decode path (``HeldPath`` "hold": top-1 routing flips at
    near-ties in bf16, as granite's do); then on bf16 pages at the long
    geometry (max_seq 16384, rings of 8192) with a row of 8190 tokens
    whose decode crosses position 8192 (its rings wrap) beside one of 37,
    on the kernel path."""
    out = [phase_consistency(model, params, kv_dtype=kv,
                             tag=f"consistency_llama4, {kv or 'bf16'} pages")
           for kv in (None, "int8")]
    out.append(phase_consistency(
        model, params, plens=(8190, 37), bucket=8192, max_seq=LONG_MAX_SEQ,
        tag="consistency_llama4, bf16 pages, a decode across 8192"))
    return out


def phase_consistency_llama4_f32():
    """llama4-scout's end-to-end gate in float32 on the port's plain path
    (``plain_path()``, f32 pages): one group of 4 layers (3 local, 1
    global; 43.5 GB in float32, computed: 8 layers would not fit) with
    fresh seeded weights, the longer prefill held to the decode path's
    experts (``HeldPath`` "experts"), as granite's gate.  Run with no
    other model on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(LLAMA4_ARCH),
                              n_layers=LLAMA4_F32_LAYERS,
                              compute_dtype="float32")
    fmodel = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    fparams = fmodel.init(gen)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(fparams))
    log(f"[consistency_llama4] float32 plain path: {cfg.n_layers} layers, "
        f"{nbytes / 1e9:.2f} GB of float32 weights")
    with plain_path():
        worst = phase_consistency(
            fmodel, fparams, hold="experts",
            tag="consistency_llama4, float32 plain path, f32 pages")
    del fmodel, fparams
    release()
    return worst


def phase_serve_nemotron(cfg, model, params):
    """nemotron-4-340b at full width and 4 of its 96 layers (LayerNorm and
    the squared-ReLU MLP in PyTorch; 96 heads over 8 at head_dim 192):
    ``serve_full_model`` over the serve phase's 16 requests, bf16 and int8
    pages and a dense cache (bf16 pages with graphs on and off, the others
    on), exact launches (no RMSNorm, 4 flash prefills a call, 4 paged decodes a paged step); then
    the weight-read floor of a decode step.  Returns the graphs-on runs'
    launches by page type."""
    out = serve_full_model("serve_nemotron", cfg, model, params,
                           lambda paged: gpt3_launches(cfg.n_layers, paged),
                           graphs_off=True)
    log_decode_floor("serve_nemotron", cfg, params, out["profile"])
    return out


def phase_consistency_nemotron(model, params):
    """``phase_consistency`` on nemotron-4-340b, bf16 and int8 pages."""
    return [phase_consistency(model, params, kv_dtype=kv,
                              tag=f"consistency_nemotron, {kv or 'bf16'} "
                                  f"pages")
            for kv in (None, "int8")]


def phase_train_smoke(arch: str):
    """``arch``'s card smoke config (``card_smoke_config``: 2 layers,
    d_model 256, 4 query heads over 2 at head_dim 64) trained as the train
    phase trains llama3.2-1b (8 x 1024 tokens a step as 2 micro-batches,
    ``train_model``'s gates: a finite non-zero gradient on every leaf,
    finite losses, exact launches a step; llama4-scout's local layer with
    its window of 32 in the forward and the backward), then
    ``launch.train.main --arch <arch> --smoke`` for 2 steps and
    ``launch.serve.main --arch <arch> --smoke`` (``dvfs_serve_launcher``,
    exact launches: ``llama_launches``).  Returns ``train_model``'s
    summary, with the serve launcher's launches under "serve_launches".
    """
    from repro_torch.configs import card_smoke_config, get_config
    cfg = card_smoke_config(get_config(arch))
    L, A = cfg.n_layers, TRAIN_ACCUM
    norms = A * (2 * L + 1 + 2 * L) if cfg.norm == "rms" else 0
    per_step = {"rmsnorm": norms, "flash_prefill": A * 2 * L,
                "flash_bwd": A * L, "paged_decode": 0, "ssd_scan": 0}
    ours = {"flash_bwd dK/dV": "flash_bwd_dkv_kernel",
            "flash_bwd dQ": "flash_bwd_dq_kernel",
            "flash_prefill (lse)": "flash_prefill_kernel"}

    def describe(m):
        c = m.cfg
        return (f"{c.n_layers} layers (window {c.attn_window}, global every "
                f"{c.global_attn_every}), d={c.d_model} H={c.n_heads}/"
                f"{c.n_kv_heads} D={c.resolved_head_dim} ff={c.d_ff} "
                f"{c.norm} norm, {c.activation}")
    out = train_model(f"train_smoke {arch}", cfg, describe, per_step, ours)
    dvfs_train_launcher(arch)
    every = cfg.global_attn_every if cfg.attn_window else 1
    out["serve_launches"] = dvfs_serve_launcher(
        smoke=True, arch=arch,
        launches=lambda s, c, layers: llama_launches(
            s, c, layers=layers, every=every, norms=cfg.norm == "rms"))
    release()
    return out


# ---------------------------------------------------------------------------
# 5b. serve mamba2-370m at full width, and its prefill / decode consistency
# ---------------------------------------------------------------------------

def build_mamba_model():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("mamba2-370m")
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    s = cfg.ssm
    log(f"[serve_ssm] {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
        f"d_inner={model.d_inner} heads={model.nh}x{s.head_dim} "
        f"state={s.state_dim} groups={s.n_groups} conv={s.conv_width} "
        f"chunk={s.chunk_size} V={cfg.vocab_size} {cfg.compute_dtype}; "
        f"{n / 1e9:.3f}B params drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def mamba_launches(L: int):
    """mamba2-370m's exact launch counts, per forward: one RMSNorm before
    each block, one gate norm inside it, one final norm; one SSD scan per
    block and prefill call."""
    def want(steps, calls):
        return {"rmsnorm": (2 * L + 1) * (steps + calls), "flash_prefill": 0,
                "flash_bwd": 0, "paged_decode": 0, "ssd_scan": L * calls}
    return want


def phase_serve_ssm(cfg, model, params):
    """The llama serve phase's 16 requests through mamba2-370m, with the
    dense ``BatchState`` and with ``paged=True`` (an SSM pools nothing; the
    block tables only account), CUDA graphs on (paged: the capturing run
    alone, the dense run's timed run times the replay), then the on/off
    gate's requests (``ONOFF``) on the dense state with graphs off: the same
    greedy tokens from all, exact launch counts, no NaN logit.  (The paged
    state with graphs off repeated the dense one's on/off gate; the paged
    engine runs eagerly in ``phase_fleet_ssm``.)  Then the bucket-512
    prefill of 8 rows timed as a direct ``model.prefill`` call and through
    the engine's memoized prefill entry (graphs on and off), and a short
    profiled run with graphs on.  Returns the dense graphs-on run's
    launches."""
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 513, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in plens]
    log(f"[serve_ssm] {SERVE_REQUESTS} requests, prompt lengths "
        f"{sorted(int(n) for n in plens)}, {SERVE_NEW_TOKENS} new tokens each")
    want = mamba_launches(cfg.n_layers)
    runs = {"dense": serve_run("serve_ssm dense", model, params, prompts,
                               SERVE_NEW_TOKENS, True, want, also=ONOFF,
                               paged=False)}
    off = onoff_run("serve_ssm dense", model, params, prompts, want,
                    paged=False)
    same_onoff("serve_ssm", "dense", runs["dense"], off)
    runs["paged"] = serve_run("serve_ssm paged", model, params, prompts,
                              SERVE_NEW_TOKENS, True, want, timed=False,
                              paged=True)
    _same_tokens("serve_ssm", "dense and paged (graphs on)",
                 list(runs.values()))
    mamba_prefill_ms(cfg, model, params, rng)
    firsts = [engine_prefill_ms(cfg, model, params, g)["first"]
              for g in (True, False)]
    if firsts[0] != firsts[1]:
        raise AssertionError("mamba prefill entry: graphs on and off gave "
                             "different first tokens")
    # graphs on only: the eager profile measured the same kernels again,
    # and the eager wall a step is the graphs-off runs' above
    phase_profile(cfg, model, params, tag="profile_ssm", paged=False)
    return runs["dense"]["launches"]


def engine_prefill_ms(cfg, model, params, graphs: bool, repeats: int = 3):
    """The bucket-512 prefill of ``mamba_prefill_ms``'s 8 ragged rows
    through the engine's memoized text-only prefill entry
    (``_prefill_fn(512, {})``: the static buffers' uploads, then the
    graph's replay, or the eager body with ``graphs`` False), after a
    first call that captures: ``wall_ms``,
    ``host_ms`` and ``device_ms`` as ``mamba_prefill_ms`` takes them, and
    the rows' greedy first tokens."""
    from repro_torch.serve import ServeEngine
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 512)) \
        .astype(np.int32)
    meta = np.stack([np.linspace(16, 512, SERVE_SLOTS),
                     np.arange(SERVE_SLOTS),
                     np.full(SERVE_SLOTS, 2)]).astype(np.int32)
    eng = ServeEngine(model, params, batch_slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ, cuda_graphs=graphs)
    fn = eng._prefill_fn(512, {})

    def call():
        return fn(prompts, meta, {})[0]
    call()                                             # eager run, capture
    wall, host = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act = call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
    first = act[0].tolist()
    rows = profiled_kernels(lambda: (call(), torch.cuda.synchronize()))
    t = {"wall_ms": wall, "host_ms": host, "first": first,
         "device_ms": sum(r[0] for r in rows) / 1e3 if rows else None}
    dev = "not measured (no kernel rows)" if not rows \
        else f"{t['device_ms']:.2f} ms"
    log(f"[serve_ssm] prefill entry, bucket 512, graphs "
        f"{'on' if graphs else 'off'}: wall "
        f"{', '.join(f'{x:.2f}' for x in wall)} ms; host until the call "
        f"returns {', '.join(f'{x:.2f}' for x in host)} ms; device kernels "
        f"{dev} a call; compile_stats {eng.compile_stats}")
    del eng
    release()
    return t


def mamba_prefill_ms(cfg, model, params, rng, repeats: int = 3):
    """One prefill call of the largest bucket, 8 rows of 512 with ragged
    lengths, after a warm-up call, ``repeats`` times: ``wall_ms`` (host
    clock around a synchronised call) and ``host_ms`` (until the call
    returns, the host's share while the device runs behind it); then one
    call under ``torch.profiler``: ``device_ms`` (its device kernels' busy
    time) and ``ssd_ms`` (the SSD scan's share).  Raises on a non-finite
    logit."""
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 512)),
                        dtype=torch.int32, device="cuda")
    lens = torch.tensor(np.linspace(16, 512, SERVE_SLOTS).astype(np.int32),
                        device="cuda")

    def call():
        return model.prefill(params, toks, prompt_lens=lens)[0]
    call()                                                     # warm-up
    wall, host = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
    rows = profiled_kernels(lambda: (call(), torch.cuda.synchronize()))
    t = {"wall_ms": wall, "host_ms": host,
         "device_ms": sum(r[0] for r in rows) / 1e3,
         "ssd_ms": sum(r[0] for r in rows if "ssd_scan" in r[2]) / 1e3}
    finite = bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
    log(f"[serve_ssm] prefill of {SERVE_SLOTS} rows x 512 (lengths "
        f"{lens.tolist()}): wall {', '.join(f'{x:.2f}' for x in wall)} ms; "
        f"host until the call returns {', '.join(f'{x:.2f}' for x in host)}"
        f" ms; device kernels {t['device_ms']:.2f} ms a call, the SSD scan "
        f"{t['ssd_ms']:.2f} ms of it; logits finite {finite}")
    if not finite:
        raise AssertionError("mamba prefill: non-finite logits")
    return t


def _install_pages(model, sub, plens, steps):
    """A prefill's sub-cache (rows of ``plens`` valid positions) in a fresh
    bf16 page pool with room for ``steps`` more tokens a row, installed as
    the engine installs it: paged leaves through ``write_prefill_pages``,
    the rest as dense slot rows.  Returns (cache, device block tables)."""
    from repro_torch.serve.kv_pages import PagedBatchState, write_prefill_pages
    st = PagedBatchState(model, len(plens), SERVE_MAX_SEQ,
                         page_size=SERVE_PAGE)
    for b, n in enumerate(plens):
        st.pool.allocate(b, int(n) + steps)
    st.sync_tables()
    tables_sub = st.pool.tables.copy()
    for b in range(len(plens)):
        tables_sub[b, st.pool.n_blocks[b]:] = st.pool.n_pages
    for key in st.cache:
        if key in model.paged_cache_keys():
            write_prefill_pages(st.cache[key], sub[key], tables_sub)
        else:
            st.cache[key].copy_(sub[key])
    return st.cache, st.tables_dev


def phase_consistency_ssm(model, params, steps: int = 4,
                          tag: str = "consistency_ssm", max_seq=None,
                          paged: bool = False):
    """Prefill 300 positions (chunks of 256 and a ragged 44; rows of 300
    and 137 valid positions), then ``steps`` decode steps fed the greedy
    tokens, against the last-position logits of one prefill of the prompt
    and those tokens: the kernel's final state and the conv tail carry the
    decode (and, for the hybrid, its KV cache of ``max_seq`` positions:
    dense, or with ``paged`` installed into bf16 pages, as the engine
    installs it, and read by the paged decode kernel)."""
    rng = np.random.default_rng(5)
    plens = np.array([300, 137], np.int32)
    B, S0 = len(plens), int(plens.max())
    dev = model.device
    prompts = np.zeros((B, S0 + steps), np.int32)
    for b, n in enumerate(plens):
        prompts[b, :n] = rng.integers(0, model.cfg.vocab_size, n)
    logits, cache = model.prefill(params, torch.tensor(prompts[:, :S0],
                                                       device=dev),
                                  prompt_lens=torch.tensor(plens, device=dev),
                                  max_seq=max_seq)
    tables = None
    if paged:
        cache, tables = _install_pages(model, cache, plens, steps)
    tokens = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.tensor(plens, device=dev)
    V = model.cfg.vocab_size
    worst = 0.0
    for i in range(steps):
        for b in range(B):
            prompts[b, plens[b] + i] = int(tokens[b])
        logits, cache = model.decode_step(params, cache, tokens, pos,
                                          block_tables=tables)
        ref, _ = model.prefill(params,
                               torch.tensor(prompts[:, :S0 + i + 1],
                                            device=dev),
                               prompt_lens=torch.tensor(plens + i + 1,
                                                        device=dev))
        gap = float((logits[:, :V].float() - ref[:, :V].float()).abs().max())
        scale = float(ref[:, :V].float().abs().max())
        worst = max(worst, gap / scale)
        log(f"[{tag}] step {i}: max |decode - prefill| logits "
            f"{gap:.4f} (max |logit| {scale:.3f}, relative {gap / scale:.4f});"
            f" greedy equal {torch.equal(logits.argmax(-1), ref.argmax(-1))}")
        tokens = torch.argmax(logits, -1).to(torch.int32)
        pos = pos + 1
    if not worst <= CONSISTENCY_TOL:
        raise AssertionError(f"prefill/decode logits differ by {worst:.4f} of "
                             f"max |logit| > {CONSISTENCY_TOL}")
    log(f"[{tag}] ok: worst relative gap {worst:.4f} <= {CONSISTENCY_TOL}")
    return worst


# ---------------------------------------------------------------------------
# 5c. serve zamba2-7b (the hybrid) at full width, and its consistency
# ---------------------------------------------------------------------------

def build_hybrid_model():
    """zamba2-7b at full width and depth with random weights from a seeded
    generator (built after the earlier models are freed)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("zamba2-7b")
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    s = cfg.ssm
    log(f"[serve_hybrid] {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
        f"d_inner={model.d_inner} heads={model.nh}x{s.head_dim} "
        f"state={s.state_dim} groups={s.n_groups} chunk={s.chunk_size}; "
        f"shared block every {cfg.attn_every} ({model.n_attn} applications)"
        f" H={cfg.n_heads}/{cfg.n_kv_heads} D={model.attn_head_dim} "
        f"ff={cfg.d_ff} V={cfg.vocab_size} {cfg.compute_dtype}; "
        f"{n / 1e9:.3f}B params ({nbytes / 1e9:.2f} GB) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def hybrid_launches(cfg, model, paged: bool):
    """zamba2-7b's exact launch counts: per forward 2 L + 2 n_attn + 1
    RMSNorms (191: a norm before each Mamba2 block and its gate norm, two
    in each application of the shared block, the final norm); per prefill
    call L SSD scans and n_attn prefill attentions; per decode step n_attn
    paged decodes on pages, none on a dense cache."""
    L, A = cfg.n_layers, model.n_attn

    def want(steps, calls):
        return {"rmsnorm": (2 * L + 2 * A + 1) * (steps + calls),
                "flash_prefill": A * calls, "flash_bwd": 0,
                "paged_decode": A * steps if paged else 0,
                "ssd_scan": L * calls}
    return want


def phase_serve_hybrid(cfg, model, params):
    """zamba2-7b serves 8 seeded requests (24-498 prompt tokens, 32 new
    tokens each) with bf16 pages (CUDA graphs on, then the on/off gate's
    requests, ``ONOFF``, with graphs off), and those prompts with
    ``CAPTURE_NEW_TOKENS`` each on int8 pages (graphs on) and on a dense
    cache (graphs on and off; each graphs-on run the capturing run alone):
    the same greedy tokens with
    graphs on and off on bf16 pages and on the dense cache, exact launch
    counts, no NaN logit; logs tokens/s, peak memory and the graph pool,
    and the int8 and dense runs' agreement with bf16 pages.  Then a short
    profiled run with bf16 pages, graphs on.  Returns the graphs-on runs'
    launches by page type."""
    rng = np.random.default_rng(0)
    plens = rng.integers(24, 499, HYBRID_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in plens]
    log(f"[serve_hybrid] {HYBRID_REQUESTS} requests, prompt lengths "
        f"{sorted(int(n) for n in plens)}, {HYBRID_NEW_TOKENS} new tokens "
        f"each")
    want = hybrid_launches(cfg, model, True)
    runs = {("bf16", True): serve_run(
        "serve_hybrid bf16", model, params, prompts, HYBRID_NEW_TOKENS,
        True, want, also=ONOFF, paged=True)}
    runs["bf16", False] = onoff_run("serve_hybrid bf16", model, params,
                                    prompts, want, paged=True)
    same_onoff("serve_hybrid", "bf16", runs["bf16", True],
               runs["bf16", False])
    for label, kw in (("int8", dict(paged=True, kv_dtype="int8")),
                      ("dense", dict(paged=False))):
        runs[label, True] = serve_run(
            f"serve_hybrid {label}", model, params, prompts[:SERVE_SLOTS],
            CAPTURE_NEW_TOKENS, True,
            hybrid_launches(cfg, model, kw["paged"]), timed=False, **kw)
    runs["dense", False] = serve_run(
        "serve_hybrid dense", model, params, prompts[:SERVE_SLOTS],
        CAPTURE_NEW_TOKENS, False, hybrid_launches(cfg, model, False),
        paged=False)
    _same_tokens("serve_hybrid", "dense (graphs on and off)",
                 [runs["dense", True], runs["dense", False]])
    # the dense and paged paths scale q as the reference's do, in bf16 by
    # a factor rounded to bf16 and in f32: at head_dim 224 they differ by
    # an ulp, so their greedy tokens may part (consistency_hybrid holds
    # both paths against one longer prefill); logged, as int8 is
    for other, why in (("dense", "q scaled in bf16 against f32 on pages"),
                       ("int8", "quantized KV")):
        a, b = runs[other, True]["tokens"], runs["bf16", True]["also_tokens"]
        same = [sum(x == y for x, y in zip(ra, rb)) for ra, rb in zip(a, b)]
        first = [next((i for i, (x, y) in enumerate(zip(ra, rb)) if x != y),
                      None) for ra, rb in zip(a, b)]
        log(f"[serve_hybrid] {other} against bf16 pages ({why}): "
            f"{sum(same)} of {sum(len(r) for r in a)} greedy tokens equal; "
            f"first difference by request {first}")
    # 8 new tokens (7 decode steps): the profiler's cost grows with the
    # ~5000 kernels of each step.  Graphs on only: the eager profile
    # (~36 s) measured the same kernels and launches again (37.86 against
    # 37.71 device ms a step), and the eager wall a step is the bf16
    # graphs-off run's above
    phase_profile(cfg, model, params, tag="profile_hybrid", paged=True,
                  detail=True, new_tokens=8)
    return {label: runs[label, True]["launches"] for label in ("bf16", "int8")}


def phase_consistency_hybrid(model, params, steps: int = 4):
    """``phase_consistency_ssm``'s prefill of 300 positions (two SSD
    chunks, the last ragged) and decode steps through zamba2-7b, on a
    dense cache of ``SERVE_MAX_SEQ`` positions and on bf16 pages, each
    within ``CONSISTENCY_TOL`` of the longer prefill."""
    return [phase_consistency_ssm(model, params, steps,
                                  tag=f"consistency_hybrid, {what}",
                                  max_seq=SERVE_MAX_SEQ, paged=paged)
            for what, paged in (("dense cache", False),
                                ("bf16 pages", True))]


# ---------------------------------------------------------------------------
# 6. train at full width, 7. Trainer restart at a small width
# ---------------------------------------------------------------------------

def train_model(tag, cfg, describe, per_step, ours, batch=TRAIN_BATCH,
                accum=TRAIN_ACCUM, prefix=0, frames=0, seq=TRAIN_SEQ):
    """Train ``cfg`` on the card for ``TRAIN_STEPS`` steps through
    ``make_train_step`` (f32 masters, bf16 compute, AdamW, remat; ``seq``
    positions a row, global batch ``batch`` as ``accum`` micro-batches)
    on the port's ``DataPipeline`` (with ``prefix``, a VLM's rows: that
    many seeded patch rows of width d_model, then ``seq - prefix`` text
    tokens; the loss covers the text; with ``frames``, an
    encoder-decoder's rows: that many seeded frames of width d_model for
    the encoder beside ``seq`` text tokens): a finite non-zero gradient on
    every parameter leaf after the first backward, finite losses, exactly
    ``per_step`` launches a step; logs step ms, tokens/s and peak memory,
    then profiles one more step (device idle share, the time of the port's
    kernels by the name fragments in ``ours``, the top kernels).  The model
    is freed before it returns.  Returns {"counts": the launches of the
    timed steps, "step_ms": the last timed step's ms, "tokens_per_s",
    "peak_gib", "idle"}."""
    from repro_torch import kernels
    from repro_torch.data import DataPipeline
    from repro_torch.models import build_model
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   loss_and_grads, make_train_step)
    from repro_torch.tree import flatten
    model = build_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, seed=0)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in flatten(state.params))
    log(f"[{tag}] {cfg.name}: {describe(model)} V={cfg.vocab_size}; "
        f"{n / 1e9:.3f}B params in {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}; state drawn in "
        f"{time.perf_counter() - t0:.1f} s; seq {seq}"
        + (f" (and {frames} frames)" if frames else "")
        + f", global batch {batch} = {accum} x {batch // accum}, AdamW, "
          f"remat")
    pipeline = DataPipeline(cfg.vocab_size, batch, seq - prefix, seed=0)
    batches = [pipeline.next_batch() for _ in range(TRAIN_STEPS)]
    rng = np.random.default_rng(0)
    for b in batches:
        for key, rows in (("patch_embeds", prefix), ("frames", frames)):
            if rows:
                b[key] = rng.normal(size=(batch, rows, cfg.d_model)).astype(
                    np.float32)

    # every leaf gets a finite, non-zero gradient from the first backward
    micro = {k: v[:batch // accum] for k, v in batches[0].items()}
    _, _, grads = loss_and_grads(model, state.params, micro, remat=True)
    named = flatten(grads)
    norms = torch.stack([g.float().norm() for _, g in named]).tolist()
    bad = [(p, nrm) for (p, _), nrm in zip(named, norms)
           if not (math.isfinite(nrm) and nrm > 0)]
    log(f"[{tag}] first backward: {len(named)} parameter leaves, gradient "
        f"norms {min(norms):.3e}..{max(norms):.3e}; leaves without a finite "
        f"non-zero gradient: {bad}")
    if bad:
        raise AssertionError(f"parameters without a gradient: {bad}")
    del grads, named

    step_fn = make_train_step(model, OptimizerConfig(lr=3e-4, warmup_steps=2),
                              accum_steps=accum, remat=True)
    tokens = batch * seq
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    before = kernels.launch_counts()
    for i, data in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        now = kernels.launch_counts()
        step_counts = {k: now[k] - before[k] for k in now}
        before = now
        aux = "".join(f", {k} {float(metrics[k]):.5f}"
                      for k in ("load_balance", "router_z", "dropped_frac")
                      if k in metrics)
        log(f"[{tag}] step {i}: loss {loss:.4f}, grad_norm "
            f"{float(metrics['grad_norm']):.3f}{aux}, {dt * 1e3:.1f} ms, "
            f"{tokens / dt:.1f} tokens/s; launches {step_counts}")
        if not math.isfinite(loss):
            raise AssertionError(f"step {i}: loss {loss} is not finite")
        if step_counts != per_step:
            raise AssertionError(f"step {i}: launch counts {step_counts} != "
                                 f"{per_step}")
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] {TRAIN_STEPS} steps: launches {counts}; peak device "
        f"memory {peak:.2f} GiB")
    out = {"counts": counts, "step_ms": dt * 1e3, "tokens_per_s": tokens / dt,
           "peak_gib": peak, "idle": None}

    # where the time of one more step goes, against the last timed step
    def one_step():
        nonlocal state
        state, metrics = step_fn(state, batches[-1])
        float(metrics["loss"])
    rows = profiled_kernels(one_step)
    if not rows:
        log(f"[{tag}] device time: not measured (the profiler recorded no "
            f"device kernels)")
    else:
        busy_ms = sum(r[0] for r in rows) / 1e3
        share = {k: sum(r[0] for r in rows if name in r[2]) / 1e3
                 for k, name in ours.items()}
        out["idle"] = 1 - busy_ms / (dt * 1e3)
        log(f"[{tag}] profiled step: device kernels {busy_ms:.1f} ms "
            f"({sum(r[1] for r in rows)} launches) against {dt * 1e3:.1f} ms "
            f"of wall time unprofiled (the last timed step): device idle "
            f"share {out['idle']:.3f}; the port's kernels "
            + ", ".join(f"{k} {v:.1f} ms ({100 * v / busy_ms:.1f}%)"
                        for k, v in share.items()))
        log_top(tag, rows, busy_ms)
    del state, model, step_fn
    release()
    return out


def phase_train():
    """Train llama3.2-1b at full width and depth for ``TRAIN_STEPS`` steps
    through ``make_train_step``.  Returns the launch counts of those
    steps."""
    from repro_torch.configs import get_config
    # per step: 2 micro-batches x (33 norms forward + 32 recomputed under
    # remat; the final norm sits outside the checkpoint), x (16 attention
    # forwards + 16 recomputed), x 16 attention backwards
    per_step = {"rmsnorm": TRAIN_ACCUM * (33 + 32),
                "flash_prefill": TRAIN_ACCUM * (16 + 16),
                "flash_bwd": TRAIN_ACCUM * 16, "paged_decode": 0,
                "ssd_scan": 0}
    ours = {"flash_bwd": "flash_bwd_",
            "flash_bwd dK/dV": "flash_bwd_dkv_kernel",
            "flash_bwd dQ": "flash_bwd_dq_kernel",
            "flash_bwd delta": "flash_bwd_delta_kernel",
            "flash_prefill": "flash_prefill_kernel",
            "rmsnorm": "rmsnorm_kernel"}

    def describe(m):
        c = m.cfg
        return (f"L={c.n_layers} d={c.d_model} H={c.n_heads}/{c.n_kv_heads} "
                f"D={c.resolved_head_dim}")
    return train_model("train", get_config("llama3.2-1b"), describe,
                       per_step, ours)["counts"]


def _ssd_share(tag, out, bwd_ms, calls):
    """Logs the plain SSD backward's share of a step, computed from its
    time at the step's shape (``phase_ssd_grads``) times its calls."""
    share = bwd_ms * calls / out["step_ms"]
    log(f"[{tag}] the plain SSD backward: {calls} calls a step x "
        f"{bwd_ms:.3f} ms (timed alone at the step's shape) = "
        f"{bwd_ms * calls:.1f} ms, {share:.3f} of the last timed step's "
        f"{out['step_ms']:.1f} ms (computed)")
    out["ssd_bwd_share"] = share
    return out


def phase_train_ssm(ssd_bwd_ms):
    """Train mamba2-370m at full width and depth (48 layers) as
    ``phase_train`` trains llama3.2-1b.  Per micro-batch, counted from the
    code: 2 L + 1 RMSNorms forward (a norm before each block, its gate
    norm, the final norm) and 2 L recomputed under remat, L SSD scans
    forward and L recomputed; no attention.  Returns ``train_model``'s
    summary with the plain SSD backward's share of a step."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-370m")
    L = cfg.n_layers
    per_step = {"rmsnorm": TRAIN_ACCUM * ((2 * L + 1) + 2 * L),
                "flash_prefill": 0, "flash_bwd": 0, "paged_decode": 0,
                "ssd_scan": TRAIN_ACCUM * (L + L)}
    ours = {"ssd_scan (forward)": "ssd_scan_", "rmsnorm": "rmsnorm_kernel"}

    def describe(m):
        s = m.cfg.ssm
        return (f"L={m.cfg.n_layers} d={m.cfg.d_model} d_inner={m.d_inner} "
                f"heads={m.nh}x{s.head_dim} state={s.state_dim} "
                f"groups={s.n_groups} chunk={s.chunk_size}")
    out = train_model("train_ssm", cfg, describe, per_step, ours)
    return _ssd_share("train_ssm", out, ssd_bwd_ms, TRAIN_ACCUM * L)


def phase_train_hybrid(ssd_bwd_ms):
    """Train zamba2-7b at full width with its depth cut to
    ``HYBRID_TRAIN_LAYERS`` (the reason beside the constant) as
    ``phase_train`` trains llama3.2-1b.  Per micro-batch, counted from the
    code: 2 L + 2 A + 1 RMSNorms forward (A applications of the shared
    block) and, under remat, those of the full groups again (2 per Mamba2
    block, 2 per application; the tail and its application run outside
    the checkpoint); L SSD scans forward and the groups' again; A flash
    forwards with their log-sum-exp and the groups' again; A flash
    backwards at head_dim 224.  Returns ``train_model``'s summary with the
    plain SSD backward's share of a step."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("zamba2-7b"),
                              n_layers=HYBRID_TRAIN_LAYERS)
    # as HybridLM counts them: full groups, the tail, shared applications
    L = cfg.n_layers
    groups, tail = divmod(L, cfg.attn_every)
    A = groups + (1 if tail else 0)
    in_groups = groups * cfg.attn_every
    log(f"[train_hybrid] {cfg.name} at {L} of 81 layers ({groups} groups of "
        f"{cfg.attn_every}, a tail of {tail}, the shared block "
        f"applied {A} times): at 81 its f32 masters, gradients and AdamW "
        f"moments alone would need ~111 GB of the card's 80 GB")
    per_step = {"rmsnorm": TRAIN_ACCUM * ((2 * L + 2 * A + 1)
                                          + 2 * in_groups + 2 * groups),
                "flash_prefill": TRAIN_ACCUM * (A + groups),
                "flash_bwd": TRAIN_ACCUM * A, "paged_decode": 0,
                "ssd_scan": TRAIN_ACCUM * (L + in_groups)}
    ours = {"flash_bwd (D224)": "flash_bwd_",
            "flash_bwd dK/dV": "flash_bwd_dkv_wide_kernel",
            "flash_bwd dQ": "flash_bwd_dq_wide_kernel",
            "flash_bwd pre-pass": "flash_bwd_prep_kernel",
            "flash_prefill (D224, lse)": "flash_prefill_wide_kernel",
            "ssd_scan (forward)": "ssd_scan_", "rmsnorm": "rmsnorm_kernel"}

    def describe(m):
        s = m.cfg.ssm
        return (f"L={m.cfg.n_layers} d={m.cfg.d_model} d_inner={m.d_inner} "
                f"heads={m.nh}x{s.head_dim} state={s.state_dim} "
                f"groups={s.n_groups}; shared block every "
                f"{m.cfg.attn_every} ({m.n_attn} applications) "
                f"H={m.cfg.n_heads}/{m.cfg.n_kv_heads} D={m.attn_head_dim} "
                f"ff={m.cfg.d_ff}")
    out = train_model("train_hybrid", cfg, describe, per_step, ours)
    return _ssd_share("train_hybrid", out, ssd_bwd_ms, TRAIN_ACCUM * L)


def phase_train_gpt3():
    """Train gpt3-xl at full width and depth at the paper's shape, 40 x 1024
    tokens a step as ``GPT3_ACCUM`` micro-batches of 8, as ``phase_train``
    trains llama3.2-1b.  Per micro-batch, counted from the code
    (``tests/test_torch_gpt3.py`` counts the same calls on the CPU): L flash
    forwards with their log-sum-exp, L more in the backward's recompute
    under remat, L flash backwards at head_dim 128; no RMSNorm.  Returns
    ``train_model``'s summary."""
    from repro_torch.configs import get_config
    cfg = get_config("gpt3-xl")
    L = cfg.n_layers
    per_step = {"rmsnorm": 0, "flash_prefill": GPT3_ACCUM * (L + L),
                "flash_bwd": GPT3_ACCUM * L, "paged_decode": 0,
                "ssd_scan": 0}
    ours = {"flash_bwd (D128)": "flash_bwd_",
            "flash_bwd dK/dV": "flash_bwd_dkv_wide_kernel",
            "flash_bwd dQ": "flash_bwd_dq_wide_kernel",
            "flash_bwd pre-pass": "flash_bwd_prep_kernel",
            "flash_prefill (D128, lse)": "flash_prefill_wide_kernel",
            "LayerNorm (PyTorch's)": "layer_norm"}

    def describe(m):
        c = m.cfg
        return (f"L={c.n_layers} d={c.d_model} H={c.n_heads}/{c.n_kv_heads} "
                f"D={c.resolved_head_dim} ff={c.d_ff} {c.norm} norm, "
                f"{c.positional} positions ({c.max_train_seq} rows), "
                f"{c.activation}")
    return train_model("train_gpt3", cfg, describe, per_step, ours,
                       batch=GPT3_BATCH, accum=GPT3_ACCUM)


def _describe(m) -> str:
    c = m.cfg
    moe = "" if not c.is_moe else (
        f", {c.moe.n_experts} experts top-{c.moe.top_k} at capacity "
        f"factor {c.moe.capacity_factor}")
    return (f"L={c.n_layers} d={c.d_model} H={c.n_heads}/{c.n_kv_heads} "
            f"D={c.resolved_head_dim} ff={c.d_ff}{moe}")


def phase_train_llama3b():
    """Train llama3.2-3b at full width and ``LLAMA3B_TRAIN_LAYERS`` layers,
    8 x 1024 tokens a step as ``LLAMA3B_ACCUM`` micro-batches of 2, as
    ``phase_train`` trains llama3.2-1b.  Per micro-batch, counted from the
    code (``tests/test_torch_llama3b.py`` counts the same calls on the
    CPU): 2 L + 1 RMSNorms forward and 2 L more in the recompute, L flash
    forwards with their log-sum-exp and L more in the recompute, L flash
    backwards at head_dim 128 with 3 query heads per KV head.  The
    profiled step's dK/dV against dQ time shows the dK/dV pass's balance
    (a block walks 3 query heads x its query tiles).  Returns
    ``train_model``'s summary."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              n_layers=LLAMA3B_TRAIN_LAYERS)
    L, A = cfg.n_layers, LLAMA3B_ACCUM
    per_step = {"rmsnorm": A * (2 * L + 1 + 2 * L),
                "flash_prefill": A * 2 * L, "flash_bwd": A * L,
                "paged_decode": 0, "ssd_scan": 0}
    ours = {"flash_bwd (D128G3)": "flash_bwd_",
            "flash_bwd dK/dV": "flash_bwd_dkv_wide_kernel",
            "flash_bwd dQ": "flash_bwd_dq_wide_kernel",
            "flash_bwd pre-pass": "flash_bwd_prep_kernel",
            "flash_prefill (D128G3, lse)": "flash_prefill_wide_kernel",
            "rmsnorm": "rmsnorm_kernel"}
    return train_model("train_llama3b", cfg, _describe, per_step, ours,
                       accum=A)


def phase_train_moe():
    """Train granite-moe-1b-a400m at full width and depth, 8 x 1024 tokens
    a step as ``MOE_ACCUM`` micro-batches of 4 (capacity 1280 a layer and
    expert), as ``phase_train`` trains llama3.2-1b; each step logs the
    layer-mean load balance, router z-loss and dropped fraction, and the
    first backward's gradient gate covers the router.  Launches a step as
    for llama3.2-1b at 24 layers (the MoE layer launches none of the
    port's kernels).  Returns ``train_model``'s summary."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    L, A = cfg.n_layers, MOE_ACCUM
    per_step = {"rmsnorm": A * (2 * L + 1 + 2 * L),
                "flash_prefill": A * 2 * L, "flash_bwd": A * L,
                "paged_decode": 0, "ssd_scan": 0}
    ours = {"flash_bwd (D64)": "flash_bwd_",
            "flash_prefill (D64, lse)": "flash_prefill_kernel",
            "rmsnorm": "rmsnorm_kernel",
            "the experts' grouped GEMMs (torch's CUTLASS sm90 kernels)":
                "enable_3x_kernel_for_sm9x"}
    return train_model("train_moe", cfg, _describe, per_step, ours,
                       accum=A)


def phase_trainer():
    """``Trainer.run()`` at a small width on the card with an injected
    failure at step 3: it restarts from the step-2 checkpoint and
    finishes."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import card_smoke_config, get_config
    from repro_torch.data import DataPipeline
    from repro_torch.models import build_model
    from repro_torch.runtime import FailureInjector
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train.loop import Trainer, TrainerConfig
    # llama3.2-1b's family at the smallest widths the kernels are built for
    cfg = card_smoke_config(get_config("llama3.2-1b"))
    model = build_model(cfg, device="cuda")
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as ckpt_dir:
        trainer = Trainer(
            model, make_train_step(model, OptimizerConfig(
                lr=1e-2, warmup_steps=2, decay_steps=100), accum_steps=2,
                remat=True),
            DataPipeline(cfg.vocab_size, 4, 128),
            CheckpointManager(ckpt_dir, keep=2),
            TrainerConfig(total_steps=6, ckpt_every=2, max_restarts=2),
            failure_injector=FailureInjector((3,)))
        out = trainer.run()
    losses = [(h["step"], round(h["loss"], 4)) for h in trainer.history]
    log(f"[trainer] {cfg.name} on {model.device}: {out}; (step, loss) "
        f"{losses}")
    if out["restarts"] != 1 or out["final_step"] != 6 \
            or [h["step"] for h in trainer.history] != [0, 1, 2, 2, 3, 4, 5] \
            or not all(math.isfinite(h["loss"]) for h in trainer.history):
        raise AssertionError(f"Trainer did not restart and finish: {out}")
    return out


# ---------------------------------------------------------------------------
# 10. dvfs: the planning layer around serving and training, and NVML reads
# ---------------------------------------------------------------------------

def dvfs_grid_check(nvml) -> float:
    """Logs the card's supported clocks and holds ``h100_grid()`` to them
    (every grid clock supported at every grid memory clock: raises
    otherwise); reads the energy counter over 2 s of idle.  Returns the
    idle watts."""
    from repro_torch.core import h100_grid
    log(f"[dvfs] NVML: {nvml.name()}, power limit "
        f"{nvml.power_limit_w():.2f} W")
    supported = nvml.supported_clocks()
    for mem, cores in supported.items():
        log(f"[dvfs] supported: memory {mem} MHz, {len(cores)} graphics "
            f"clocks {cores[0]}..{cores[-1]} MHz: {cores}")
    grid = h100_grid()
    missing = [(m, c) for m in grid.mem_clocks_mhz
               for c in grid.core_clocks_mhz
               if c not in supported.get(m, ())]
    if missing:
        raise AssertionError(f"h100_grid() clocks the card does not support "
                             f"(memory, graphics MHz): {missing}")
    log(f"[dvfs] h100_grid(): memory {grid.mem_clocks_mhz}, graphics "
        f"{grid.core_clocks_mhz} MHz: every pair supported")
    e0, t0 = nvml.energy_j(), time.perf_counter()
    draws = []
    while time.perf_counter() - t0 < 2.0:
        draws.append(nvml.power_w())
        time.sleep(0.1)
    idle_w = (nvml.energy_j() - e0) / (time.perf_counter() - t0)
    log(f"[dvfs] idle: {idle_w:.2f} W mean over 2 s from the energy counter "
        f"(power reads {min(draws):.1f}..{max(draws):.1f} W); clocks now "
        f"{nvml.clocks_mhz()} MHz (SM, memory)")
    return idle_w


def _check_hooks(tag, ex, requests, decode_steps):
    """The executor's books against the engine: one prefill hook a request
    admitted, one decode hook a decode step, and its energy ledger tied
    out (``check_executor``); every number finite."""
    from repro_torch.obs import check_executor
    phases = ex.summary()["phases"]
    pre = sum(r["steps"] for n, r in phases.items() if n == "prefill")
    dec = sum(r["steps"] for n, r in phases.items() if n != "prefill")
    problems = check_executor(ex)
    bad = [(n, k) for n, r in phases.items() for k, v in r.items()
           if not math.isfinite(v)]
    if (pre, dec) != (requests, decode_steps) or problems or bad:
        raise AssertionError(f"{tag}: prefill/decode hooks {(pre, dec)} != "
                             f"{(requests, decode_steps)}, ledger "
                             f"{problems}, non-finite {bad}")


def dvfs_serve_launcher(smoke: bool = False, arch: str = "llama3.2-1b",
                        requests: int = 16, launches=None):
    """``launch.serve.main`` on the card (``arch``, by default llama3.2-1b,
    the h100 chip model, 8 slots, ``requests`` requests) at full width, or
    with ``--smoke`` (``card_smoke_config``: 2 layers, 4 query heads and 2
    KV heads at head_dim 64, so paged decode at a query group of 2; an MoE
    arch keeps 4 experts, top-2): finite plan rows and executed totals, the
    executor's hooks against the engine's calls, and the exact launches of
    the three serving kernels (counted through graph replays; the MoE
    layer launches none of them; ``launches(steps, calls, layers)``, by
    default ``llama_launches``, gives them).  Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = serve.main(["--arch", arch, "--chip", "h100", "--slots",
                      str(SERVE_SLOTS), "--requests", str(requests),
                      "--max-new-tokens", "16"]
                     + (["--smoke"] if smoke else []))
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    want = (launches or llama_launches)(
        out["n_decode_steps"], out["n_prefill_calls"],
        layers=2 if smoke else get_config(arch).n_layers)
    rows = [v for r in out["plan"].values() for v in r.values()
            if isinstance(v, float)]
    what = f"serve launcher --arch {arch}{' --smoke' * smoke}"
    if got != want or not all(math.isfinite(v) for v in rows) or not all(
            math.isfinite(v) for v in out["executed"].values()):
        raise AssertionError(f"{what}: launches {got} != {want}, or a plan "
                             f"row or the executed totals not finite")
    _check_hooks(what, out["executor"], out["requests"],
                 out["n_decode_steps"])
    log(f"[dvfs] {what}: {out['requests']} "
        f"requests, {out['tokens']} tokens in {out['seconds']:.2f} s; "
        f"{out['n_prefill_calls']} prefill calls, {out['n_decode_steps']} "
        f"decode steps = the executor's hooks; launches {got} (exact)")
    return got


def _window_line(tag, joules, wall, idle_w, clocks):
    sm = sorted({c[0] for c in clocks})
    mem = sorted({c[1] for c in clocks})
    log(f"[{tag}] measured: {joules:.2f} J over {wall:.3f} s = "
        f"{joules / wall:.2f} W mean ({joules / wall - idle_w:.2f} W net of "
        f"{idle_w:.2f} W idle); clocks seen SM {sm[0]}..{sm[-1]} MHz, memory "
        f"{mem} MHz (auto: nothing set)")


def dvfs_serve_window(nvml, cfg, model, params, idle_w):
    """The serve phase's 16 requests on bf16 pages, CUDA graphs on, behind a
    ``DvfsSession(chip="h100")`` serve executor, repeated (``reset()``
    between repeats) over at least ``DVFS_WINDOW_S`` of generation after a
    warm-up that captures every graph; the energy counter is read before
    and after the window.  Logs joules a generated token and mean watts,
    gross and net of idle, beside the executor's modeled energy and time
    for the same hook calls (the auto baseline and the plan)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.dvfs import DvfsSession
    from repro_torch.serve import Request, ServeEngine
    prompts = serve_prompts(cfg.vocab_size, "dvfs serve")
    with DvfsSession(chip="h100") as sess:
        sess.plan_serve(
            cfg, n_slots=SERVE_SLOTS,
            prefill_shape=ShapeConfig(name="serve_prefill", seq_len=512,
                                      global_batch=1, kind="prefill"),
            decode_shape=ShapeConfig(name="serve_decode", seq_len=512,
                                     global_batch=SERVE_SLOTS,
                                     kind="decode"))
        ex = sess.serve_executor()
        eng = ServeEngine(model, params, batch_slots=SERVE_SLOTS,
                          max_seq=SERVE_MAX_SEQ, page_size=SERVE_PAGE,
                          paged=True, executor=ex)

        def run():
            eng.reset()
            reqs = [Request(uid=i, prompt=p, max_new_tokens=SERVE_NEW_TOKENS)
                    for i, p in enumerate(prompts)]
            eng.generate(reqs)
            _check_hooks("serve window", ex, len(reqs), eng.n_decode_steps)
            return sum(len(r.generated) for r in reqs)

        run()                                       # captures every graph
        keys = ("time_s", "energy_j", "base_time_s", "base_energy_j")
        modeled = dict.fromkeys(keys, 0.0)
        tokens, repeats, clocks = 0, 0, []
        e0, t0 = nvml.energy_j(), time.perf_counter()
        while time.perf_counter() - t0 < DVFS_WINDOW_S:
            tokens += run()
            repeats += 1
            tot = ex.summary()["totals"]
            for k in keys:
                modeled[k] += tot[k]
            clocks.append(nvml.clocks_mhz())
        joules, wall = nvml.energy_j() - e0, time.perf_counter() - t0
    del eng
    release()
    tag = "dvfs serve"
    log(f"[{tag}] {repeats} repeats of the {SERVE_REQUESTS} requests, "
        f"{tokens} tokens in {wall:.3f} s ({tokens / wall:.1f} tokens/s)")
    _window_line(tag, joules, wall, idle_w, clocks)
    net = joules - idle_w * wall
    log(f"[{tag}] measured: {joules / tokens:.5f} J a generated token "
        f"({net / tokens:.5f} net of idle)")
    log(f"[{tag}] modeled (h100_like, the same hook calls): auto "
        f"{modeled['base_energy_j']:.3f} J in {modeled['base_time_s']:.4f} s,"
        f" the plan {modeled['energy_j']:.3f} J in {modeled['time_s']:.4f} s;"
        f" measured / modeled auto: energy "
        f"{joules / modeled['base_energy_j']:.3f}, time "
        f"{wall / modeled['base_time_s']:.3f}")
    return {"joules": joules, "wall_s": wall, "tokens": tokens,
            "repeats": repeats, "modeled": modeled, "clocks": clocks}


class BooksOnlyCheckpoints:
    """The checkpoint manager of the full-width training window: each save
    keeps only ``extra`` (the data cursor and the executor's books), round
    tripped through JSON as ``CheckpointManager`` writes it, and no
    tensors: the f32 masters and AdamW moments of a full-width model would
    be a ~20 GB write (12 bytes a parameter).  ``Trainer``'s restart from
    real checkpoints is the trainer phase's."""

    def __init__(self):
        self.extra = {}

    def latest_step(self):
        return None

    def save(self, step, state, extra=None):
        self.extra[step] = json.loads(json.dumps(extra or {}))


def dvfs_train_window(nvml, idle_w, model, shape=None, accum=TRAIN_ACCUM,
                      steps=DVFS_TRAIN_STEPS, bundle=None,
                      per_step=None, tag=None):
    """``Trainer`` on ``model`` (built on the card at full width; AdamW,
    remat) for ``steps`` steps of ``shape`` (the train phase's: seq 1024,
    batch 8) as ``accum`` micro-batches, behind a train executor of
    ``DvfsSession(chip="h100")``: planned for that shape (tau 0) or, given
    a ``bundle``, its plan adopted (``DvfsPlan.from_train_bundle``), with
    ``NvmlStepMeter`` as its energy meter.  The window is steps 1..N-1
    (step 0 holds the first step's set-up); it must last at least
    ``DVFS_WINDOW_S``.  Gates: finite losses, every phase in the
    executor's summary, its books through the saved JSON into a fresh
    executor give the same summary, and with ``per_step`` (kernel ->
    launches a step) exact launches over the run.  Logs measured joules
    and seconds a step against the executor's modeled ones.  Returns the
    window's totals, the modeled step, the tokens a step and the
    launches."""
    from repro_torch import kernels
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import DataPipeline
    from repro_torch.dvfs import DvfsPlan, DvfsSession
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train.loop import Trainer, TrainerConfig
    cfg = model.cfg
    shape = shape or ShapeConfig(name="chip_smoke_train", seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, kind="train")
    ckpt = BooksOnlyCheckpoints()
    with DvfsSession(chip="h100", tau=0.0) as sess:
        if bundle is None:
            sess.plan_train(cfg, shape=shape)
        else:
            sess.adopt(DvfsPlan.from_train_bundle(bundle))
        meter = NvmlStepMeter(nvml)
        trainer = Trainer(
            model, make_train_step(model, OptimizerConfig(lr=3e-4,
                                                          warmup_steps=2),
                                   accum_steps=accum, remat=True),
            DataPipeline(cfg.vocab_size, shape.global_batch, shape.seq_len,
                         seed=0),
            ckpt, TrainerConfig(total_steps=steps, ckpt_every=steps),
            energy_meter=meter, executor=sess.train_executor())
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = trainer.run()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        fresh = sess.train_executor()
        fresh.load_state_dict(ckpt.extra[steps]["dvfs_exec"])
    hist = trainer.history
    summary = out["dvfs"]
    want = None if per_step is None else \
        {k: v * steps for k, v in per_step.items()}
    if not all(math.isfinite(h["loss"]) for h in hist) \
            or set(summary["phases"]) != {"fwd", "bwd", "opt"} \
            or fresh.summary() != summary \
            or (want is not None and launches != want):
        raise AssertionError(f"dvfs train: losses {[h['loss'] for h in hist]}"
                             f", phases {sorted(summary['phases'])}, "
                             f"launches {launches} (want {want}), or the "
                             f"books did not survive their JSON round trip")
    window = meter.records[1:]
    joules = sum(r.energy_j for r in window)
    wall = sum(r.time_s for r in window)
    if wall < DVFS_WINDOW_S:
        raise AssertionError(f"dvfs train: window {wall:.3f} s is shorter "
                             f"than {DVFS_WINDOW_S} s")
    n = len(window)
    plan_t = sum(h["dvfs_time_s"] for h in hist[1:]) / n
    plan_e = sum(h["dvfs_energy_j"] for h in hist[1:]) / n
    # the auto baseline of the same steps (the per-step plan numbers leave
    # out the phase-boundary switches, which the summary books)
    base_t = summary["totals"]["base_time_s"] / steps
    base_e = summary["totals"]["base_energy_j"] / steps
    tag = tag or f"dvfs train {cfg.name}"
    log(f"[{tag}] full width, {steps} steps of {shape.global_batch} x "
        f"{shape.seq_len} tokens ({shape.name}, {accum} micro-batches); "
        f"losses {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; window "
        f"steps 1..{steps - 1}"
        + ("" if want is None else f"; launches {launches} (exact)"))
    _window_line(tag, joules, wall, idle_w, [r.clocks for r in window])
    per = [round(r.energy_j, 1) for r in window]
    log(f"[{tag}] measured a step: {joules / n:.2f} J "
        f"({(joules - idle_w * wall) / n:.2f} net of idle) in "
        f"{wall / n:.4f} s (per-step J {per})")
    log(f"[{tag}] modeled a step (h100_like): the plan {plan_e:.3f} J in "
        f"{plan_t:.4f} s, auto {base_e:.3f} J in {base_t:.4f} s; measured / "
        f"modeled: energy {joules / n / plan_e:.3f} (plan), "
        f"{joules / n / base_e:.3f} (auto); time {wall / n / plan_t:.3f} "
        f"(plan), {wall / n / base_t:.3f} (auto)")
    del trainer
    release()
    return {"joules": joules, "wall_s": wall, "steps": n,
            "tokens_per_step": shape.global_batch * shape.seq_len,
            "plan": (plan_t, plan_e), "auto": (base_t, base_e),
            "launches": launches}


def dvfs_train_launcher(arch: str = "llama3.2-1b"):
    """``launch.train.main --arch <arch>`` on the card with ``--smoke`` (the
    reduced config at its kernels' widths), 2 steps, checkpoints in a
    temporary directory under ``build/``, removed after."""
    from repro_torch.launch import train
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as ckpt_dir:
        out = train.main(["--arch", arch, "--smoke", "--steps", "2",
                          "--ckpt-dir", ckpt_dir])
    done = out["done"]
    if done["final_step"] != 2 or not math.isfinite(done["final_loss"]) \
            or set(done["dvfs"]["phases"]) != {"fwd", "bwd", "opt"}:
        raise AssertionError(f"train launcher: {done}")
    log(f"[dvfs] train launcher --arch {arch} --smoke: 2 steps on the card, "
        f"final loss {done['final_loss']:.4f}, executed "
        f"{done['dvfs']['totals']}")


def phase_dvfs(cfg, model, params):
    """The DVFS stack on the card, reading NVML: the grid and idle check,
    the serve launcher with ``--smoke`` (llama3.2-1b; granite-moe-1b-a400m
    with ``--smoke`` and at full width with 2 requests), the serve and
    training windows, the train launcher.  (llama3.2-1b's serve launcher
    at full width repeated the gates the examples phase's ``serve_dvfs``
    keeps: the full model behind a ``DvfsSession(chip="h100")`` executor,
    its hooks against the engine's calls, exact launches.)  ``model`` is
    the serve phase's llama3.2-1b."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    nvml = Nvml()
    try:
        idle_w = dvfs_grid_check(nvml)
        smoke_launches = dvfs_serve_launcher(smoke=True)
        release()
        dvfs_serve_launcher(smoke=True, arch=MOE_ARCH)
        release()
        dvfs_serve_launcher(arch=MOE_ARCH, requests=2)
        release()
        dvfs_serve_launcher(smoke=True, arch=VLM_ARCH)
        release()
        serve = dvfs_serve_window(nvml, cfg, model, params, idle_w)
        train = dvfs_train_window(nvml, idle_w, build_model(
            get_config("llama3.2-1b"), device="cuda"))
        dvfs_train_launcher()
    finally:
        nvml.close()
    return {"idle_w": idle_w, "serve": serve, "train": train,
            "smoke_launches": smoke_launches}


def _gpt3_per_step(L: int):
    """gpt3-xl's kernel launches a training step of ``GPT3_ACCUM``
    micro-batches, counted from the code: a micro-batch of its ``L``
    layers runs L flash forwards with their log-sum-exp, L more in the
    backward's recompute under remat, and L flash backwards."""
    return {"rmsnorm": 0, "flash_prefill": GPT3_ACCUM * (L + L),
            "flash_bwd": GPT3_ACCUM * L, "paged_decode": 0, "ssd_scan": 0}


def phase_dvfs_gpt3(idle_w, gpt3):
    """gpt3-xl behind the DVFS stack on the card, reading NVML: the
    ``Trainer`` at the paper's shape (``paper_gpt3xl``: 40 x 1024 tokens a
    step as ``GPT3_ACCUM`` micro-batches) for ``GPT3_DVFS_STEPS`` steps
    behind the train executor planned for that shape, on ``gpt3`` (the
    model built on the card), over an energy window of at least
    ``DVFS_WINDOW_S`` (``idle_w``: the dvfs phase's idle watts), exact
    launches; then ``launch.train.main --arch gpt3-xl --smoke`` (learned
    positions and LayerNorm at the kernels' widths).  Returns the
    window's totals."""
    from repro_torch.configs import get_shape
    nvml = Nvml()
    try:
        train = dvfs_train_window(
            nvml, idle_w, gpt3, get_shape("paper_gpt3xl"), GPT3_ACCUM,
            GPT3_DVFS_STEPS, per_step=_gpt3_per_step(gpt3.cfg.n_layers))
        dvfs_train_launcher("gpt3-xl")
    finally:
        nvml.close()
    return train


def phase_transfer_gpt3(idle_w, gpt3, dp1):
    """The accounting and plan-transfer tier on gpt3-xl at ``paper_gpt3xl``
    (40 x 1024 tokens a step as ``GPT3_ACCUM`` micro-batches of 8, remat):

    1. its training step counted at full width and depth on fake tensors
       (``hw.step_count.count_train_step``; nothing runs on the card):
       matrix FLOPs, the eager path's HBM bytes, the top ops; the analytic
       workload against it (``calibrate_workload_against_count``); over
       the dvfs_gpt3 window's measured seconds a step (``dp1``), as
       TFLOP/s and as a share of ``PEAK_FLOPS_BF16``, the counted FLOPs
       (the plain eager path's: every attention score, the masked half
       too, and remat's recompute) and the analytic ones (the planner's
       model of the step: causal attention, no recompute);
    2. the plan at dp 1 on ``h100_like`` (``plan_train_bundle`` with the
       count, tau ``TRANSFER_TAU``), and ``compare_transfer`` to dp 2, dp 4
       and tp 2: each mesh's energy against replanning, remapped and
       repaired kernels (modeled: the multidevice phase runs the sharded
       step itself, on gloo ranks sharing the card);
    3. one rank of the dp-2 mesh on the card: the ``Trainer`` on ``gpt3``
       (the model dvfs_gpt3 trained; the ``Trainer`` draws its weights
       anew from its seed) at the rank's 20 x 1024 tokens a step as micro-batches of 4, behind the
       dp-2 bundle's plan adopted by a ``DvfsSession`` train executor,
       over an NVML window of at least ``DVFS_WINDOW_S``: finite losses,
       the three phases booked, the books' JSON round trip, exact launches
       (5 x 48 flash forwards and 5 x 24 backwards a step); its joules and
       seconds a step and a token against the transferred plan's modeled
       ones and against the dp-1 window.

    Returns the rank's window with its launches."""
    from repro_torch.configs import ShapeConfig, get_config, get_shape
    from repro_torch.core import (WastePolicy, WorkloadBuilder,
                                  calibrate_workload_against_count, get_chip,
                                  plan_train_bundle)
    from repro_torch.hw.step_count import count_train_step
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.parallel import compare_transfer, transfer_train_bundle
    tag = "transfer_gpt3"
    cfg, shape = get_config("gpt3-xl"), get_shape("paper_gpt3xl")
    t0 = time.perf_counter()
    count = count_train_step(cfg, global_batch=shape.global_batch,
                             seq_len=shape.seq_len, accum_steps=GPT3_ACCUM)
    log(f"[{tag}] counted a step of {shape.global_batch} x {shape.seq_len} "
        f"tokens ({GPT3_ACCUM} micro-batches, remat, AdamW) on fake "
        f"tensors in {time.perf_counter() - t0:.1f} s: {count.flops:.6e} "
        f"matrix FLOPs, {count.hbm_bytes:.6e} HBM bytes of the eager path")
    for key in ("flops", "hbm_bytes"):
        top = [(op, v) for op, v in count.top(5, key) if v[key]]
        log(f"[{tag}] top ops by {key}: " + "; ".join(
            f"{op} {v[key]:.4e} ({v[key] / getattr(count, key):.3f}, "
            f"{int(v['calls'])} calls)" for op, v in top))
    cal = calibrate_workload_against_count(
        WorkloadBuilder(cfg, shape).build(), count)
    log(f"[{tag}] analytic workload (WorkloadBuilder, no optimizer) against "
        f"the count: FLOPs {cal['analytic_flops']:.6e} / "
        f"{cal['counted_flops']:.6e} = {cal['flops_ratio']:.4f}, HBM bytes "
        f"{cal['analytic_hbm_bytes']:.6e} / {cal['counted_hbm_bytes']:.6e} "
        f"= {cal['hbm_ratio']:.4f}")
    step_s = dp1["wall_s"] / dp1["steps"]
    for what, flops in (("counted FLOPs (the plain eager path's, masked "
                         "attention scores and remat's recompute included)",
                         count.flops),
                        ("analytic FLOPs (WorkloadBuilder: causal "
                         "attention, no recompute)", cal["analytic_flops"])):
        rate = flops / step_s
        log(f"[{tag}] {what} over dvfs_gpt3's measured {step_s:.4f} s a "
            f"step: {rate / 1e12:.2f} TFLOP/s, "
            f"{rate / h100.PEAK_FLOPS_BF16:.4f} of the bf16 peak "
            f"({h100.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s)")
    log(f"[{tag}] roofline terms of the count (s): "
        f"{h100.roofline_terms(count.flops, count.hbm_bytes, 0.0, 1)}")
    chip = get_chip("h100")
    policy = WastePolicy(TRANSFER_TAU)
    src = plan_train_bundle(cfg, chip, shape=shape, policy=policy,
                            step_count=count)
    if src.meta["count_calibration"]["counted_flops"] != count.flops:
        raise AssertionError(f"{tag}: the bundle's calibration "
                             f"{src.meta['count_calibration']}")
    log(f"[{tag}] plan at dp 1 on h100_like (tau {TRANSFER_TAU}): "
        f"{src.step_energy_j:.3f} J in {src.step_time_s:.4f} s a step "
        f"(modeled); its count_calibration (with the optimizer) FLOPs "
        f"{src.meta['count_calibration']['flops_ratio']:.4f}, HBM bytes "
        f"{src.meta['count_calibration']['hbm_ratio']:.4f}")
    meshes = {"dp2": MeshSpec(dp=2), "dp4": MeshSpec(dp=4),
              "tp2": MeshSpec(tp=2)}
    rows = compare_transfer(src, cfg, chip, shape,
                            [meshes[m] for m in TRANSFER_MESHES], policy)
    for row in rows:
        if not all(math.isfinite(v) for v in row.to_dict().values()
                   if isinstance(v, float)):
            raise AssertionError(f"{tag}: {row.to_dict()}")
        log(f"[{tag}] {row.mesh}"
            + (" (modeled; the multidevice phase trains a tp-2 mesh)"
               if "tp1" not in row.mesh else "")
            + f": transferred {row.transfer_energy_pct:+.3f}% energy, "
            f"{row.transfer_time_pct:+.3f}% time against the shard's auto; "
            f"replanned {row.replan_energy_pct:+.3f}% / "
            f"{row.replan_time_pct:+.3f}%; energy_vs_replan_pct "
            f"{row.energy_vs_replan_pct:+.4f}; remapped {row.n_remapped}, "
            f"repaired {row.n_repaired}")
    bundle = transfer_train_bundle(src, cfg, chip, shape,
                                   MeshSpec(dp=GPT3_RANK_DP))
    unmatched = sum(bundle.phases[p].schedule.meta["n_unmatched"]
                    for p in bundle.phase_names())
    log(f"[{tag}] the dp-{GPT3_RANK_DP} bundle: {bundle.step_energy_j:.3f} J "
        f"in {bundle.step_time_s:.4f} s a rank's step (modeled), "
        f"{unmatched} unmatched kernels")
    rank_shape = ShapeConfig(name=f"paper_gpt3xl_dp{GPT3_RANK_DP}_rank",
                             seq_len=shape.seq_len,
                             global_batch=shape.global_batch // GPT3_RANK_DP,
                             kind="train")
    nvml = Nvml()
    try:
        rank = dvfs_train_window(nvml, idle_w, gpt3, rank_shape,
                                 GPT3_ACCUM, GPT3_RANK_STEPS, bundle=bundle,
                                 per_step=_gpt3_per_step(cfg.n_layers),
                                 tag=tag)
    finally:
        nvml.close()
    for name, w in (("dp-1 window (dvfs_gpt3)", dp1),
                    (f"dp-{GPT3_RANK_DP} rank", rank)):
        j, t = w["joules"] / w["steps"], w["wall_s"] / w["steps"]
        log(f"[{tag}] measured, {name}: {j:.2f} J and {t:.4f} s a step of "
            f"{w['tokens_per_step']} tokens = {j / w['tokens_per_step']:.6f}"
            f" J and {t / w['tokens_per_step'] * 1e6:.3f} us a token; "
            f"modeled (its plan) {w['plan'][1]:.3f} J in {w['plan'][0]:.4f} "
            f"s a step")
    per_token = [w["joules"] / w["steps"] / w["tokens_per_step"]
                 for w in (rank, dp1)]
    log(f"[{tag}] the rank's J a token over the dp-1 window's: "
        f"{per_token[0] / per_token[1]:.4f}; its measured step over the "
        f"transferred plan's modeled step: energy "
        f"{rank['joules'] / rank['steps'] / rank['plan'][1]:.3f}, time "
        f"{rank['wall_s'] / rank['steps'] / rank['plan'][0]:.3f}")
    return rank


# ---------------------------------------------------------------------------
# 12. multi-device: gpt3-xl trained as four gloo ranks on the one card, the
#     MoE all-to-all across them, one nccl rank
# ---------------------------------------------------------------------------

# the (data, model) mesh of the four gloo ranks that share the card (NCCL
# takes one rank a device, and the host has one); gpt3-xl at full width
# and MD_LAYERS of its 24 layers, the paper's micro-batch of 8 x 1024 as
# the global batch (4 rows a data rank), MD_STEPS sharded steps after the
# gradient check.  At 24 layers a rank's step took 28.7 s (8.5e9 bytes of
# collectives through the host under gloo) and the phase 144 s, past the
# script's room under its limit; at 8 the phase took 44.8-76.5 s as the
# host's load varied, so the depth is cut to 4 (``--cards 4`` trains all
# 24 under nccl)
MD_MESH, MD_LAYERS, MD_BATCH, MD_STEPS = (2, 2), 4, 8, 1
# sharded against unsharded in bf16 compute: the partial sums of the
# row-parallel products are rounded to bf16 before g adds them, and the
# FSDP gradients are summed across ranks in another order; the loss
# relative (sound runs read 1.6e-6 at 4 layers and 2.6e-6 at 24; the
# control the phase logs, the loss had a data rank taken the other's
# rows, 3.1e-5 at 4 and 1.4e-3 at 24), each gradient leaf's largest
# |difference| relative to its largest |value|
MD_LOSS_RTOL, MD_GRAD_TOL = 1e-5, 5e-2
# the MoE exchange at granite-moe-1b-a400m's layer width (d 1024, d_ff 512,
# 32 experts, top 8, SwiGLU experts) over MD_MOE_TOKENS tokens in float32;
# the router favours rank 0's experts by MD_MOE_SKEW so that its buckets
# overflow at capacity 2.0
MD_MOE_TOKENS, MD_MOE_SKEW, MD_MOE_TOL = 1024, 2.0, 1e-4
# ``--cards 4``: the same phase over four nccl ranks, one a card, at all
# of gpt3-xl's layers
MD_CARDS_LAYERS = 24
# granite-moe-1b-a400m at full width (32 experts, top 8, capacity 1.25)
# and MD_MOE_LAYERS of its 24 layers: one sharded step over the global
# batch of MD_BATCH x TRAIN_SEQ tokens (the experts over model, 16 a rank;
# the capacity and a pair's rank over the global batch), bf16 on the
# kernels, held to the unsharded step on the same weights and batch with
# its routing held to the unsharded step's (``RouteHold``): with the
# routing free the row-parallel sums' rounding flips top-8 choices at
# near ties, which moves a token's path and its embedding row's gradient
# (in float32 on the plain path 2 of a rank's 16384 token-layer routings
# flipped and embed/wte's gradient read 0.104 of its largest |value|
# apart, on an H100 80GB HBM3 at 700 W; in bf16 1337-1523 flipped and it
# read 0.34-0.41).  The layers' own choices are still compared with the
# held ones: at most MD_MOE_FLIPS of a rank's tokens may have a top-8 set
# that differs, each a near tie of the unsharded routing, its gap between
# the 8th and 9th router logits within MD_MOE_TIE (the bf16 pass read
# 776-795 of 16384 tokens at gaps up to 3.2e-2; the median gap is 4.4e-2).
# ``--cards`` adds the two passes with the routing free, float32 on the
# plain path and bf16 on the kernels, logged with their flips, not gated
MD_MOE_LAYERS, MD_MOE_TIE, MD_MOE_FLIPS = 4, 5e-2, 0.1
# llama3.2-1b served sharded at full width and MD_SERVE_LAYERS of its 16
# layers: MD_SERVE_SLOTS prompts of MD_SERVE_PROMPT tokens into a cache of
# MD_SERVE_MAX_SEQ positions (``cache_specs`` shards its sequence over
# model: positions 0-1023 on model rank 0, 1024-2047 on rank 1), then
# MD_SERVE_STEPS context-parallel decode steps across position 1024 (the
# rank that writes the new token's K/V changes: one step on model rank
# 0's block, one on rank 1's; more steps within a block repeat its
# first), fed the unsharded
# model's greedy tokens; held to the unsharded prefill and dense-cache
# decode on the same weights: logits within MD_SERVE_TOL of the largest
# |logit|, every argmax equal but at a near tie (a top-2 margin within
# twice the row's max |dlogit|, where bf16 rounding may flip it; counted).
# The bf16 reading (~7e-3) is the two decode paths' rounding, a world of
# one reads it too, so the context-parallel combine is gated in float32 on
# the plain path, logits within MD_SERVE_F32_TOL, with a control that
# leaves the partials past the first sequence block out and must read past
# that bound: in seamless-m4t-medium's float32 pass (MD_FAMILIES), the same
# ShardedServe combine over its decoder self- and cross-attention.  (A
# llama3.2-1b float32 pass at one layer repeated it: sound calls
# 1.785e-6-3.006e-6, its control 6.701e-2, on an H100 80GB HBM3 at 700 W.)
MD_SERVE_LAYERS, MD_SERVE_SLOTS, MD_SERVE_MAX_SEQ = 4, 8, 2048
MD_SERVE_PROMPT, MD_SERVE_STEPS, MD_SERVE_TOL = 1023, 2, 2e-2
MD_SERVE_F32_TOL = 1e-4
#: the kernel rows of the (2, 2) ranks' shapes and the run whose launches
#: each reports (rank 0's: granite's bf16 step, llama3.2-1b's serving)
MD_ROW_RUNS = {"flash_prefill_lse[D64 H8 tp2]": "moe",
               "flash_bwd[D64 H8 tp2]": "moe",
               "flash_prefill[D64 H16 tp2]": "serve",
               "ssd_scan[H16 N128 tp2]": "mamba2-370m",
               "ssd_scan[H56 N64 G1 tp2]": "zamba2-7b",
               "flash_prefill_lse[D224 H16 tp2]": "zamba2-7b",
               "flash_bwd[D224 H16 tp2]": "zamba2-7b",
               "flash_prefill_lse[enc D64 H8 tp2]": "seamless-m4t-medium",
               "flash_bwd[enc D64 H8 tp2]": "seamless-m4t-medium",
               "flash_prefill_lse[cross D64 H8 tp2]": "seamless-m4t-medium",
               "flash_bwd[cross D64 H8 tp2]": "seamless-m4t-medium",
               "flash_prefill_lse[dec D64 H8 tp2]": "seamless-m4t-medium",
               "flash_bwd[dec D64 H8 tp2]": "seamless-m4t-medium",
               "flash_prefill[D224 H16 tp2]": "zamba2-7b",
               "flash_prefill[enc D64 H8 tp2]": "seamless-m4t-medium",
               "flash_prefill[dec D64 H8 tp2]": "seamless-m4t-medium",
               "flash_prefill[cross D64 H8 tp2]": "seamless-m4t-medium"}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


class RouteHold:
    """The MoE layers' routing of one run against another's, for the
    multidevice phase.  While :meth:`record` is active it wraps
    ``common.route_top_k`` and keeps each layer's experts chosen and the
    gap between its k-th and (k+1)-th router logits a token (keyed by the
    layer's router, whose float32 values the sharded step gathers bit for
    bit).  While :meth:`run` is active each layer's own top-k set is
    compared with the recorded one at its rows (a data rank's tokens
    start at ``offset`` of the global batch's): ``flips`` counts the
    tokens whose set differs (over ``rows`` routed) and ``gap`` is the
    largest recorded gap among them (a layer recomputed under remat
    counts once); with ``hold`` the layer then takes the recorded experts,
    its top-k weights from its own probabilities renormalised as the layer
    does, so that the drop rule, the combine and every continuous term
    stay the layer's own and only the near-tie flips are taken out."""

    def __init__(self, routes=None):
        self.routes = {} if routes is None else routes
        self.counted = {}

    def _sum(self, i):
        return sum(c[i] for c in self.counted.values())

    @property
    def flips(self) -> int:
        return self._sum(0)

    @property
    def rows(self) -> int:
        return self._sum(1)

    @property
    def gap(self) -> float:
        return max((c[2] for c in self.counted.values()), default=0.0)

    @staticmethod
    def _key(router) -> float:
        return float(router.detach().double().sum())

    @contextlib.contextmanager
    def _wrap(self, fn):
        from repro_torch.models import common as cm
        orig = cm.route_top_k
        cm.route_top_k = lambda xt, router, k: fn(orig, xt, router, k)
        try:
            yield self
        finally:
            cm.route_top_k = orig

    def record(self):
        def fn(orig, xt, router, k):
            out = orig(xt, router, k)
            top = out[0].topk(k + 1, dim=-1).values
            self.routes.setdefault(self._key(router), (
                out[3].cpu(), (top[:, k - 1] - top[:, k]).cpu()))
            return out
        return self._wrap(fn)

    def run(self, offset: int, hold: bool):
        def fn(orig, xt, router, k):
            logits, probs, top_w, top_e = orig(xt, router, k)
            key = self._key(router)
            want, gap = (t[offset:offset + xt.shape[0]].to(xt.device)
                         for t in self.routes[key])
            differ = (top_e.sort(-1).values != want.sort(-1).values).any(-1)
            self.counted[key] = (int(differ.sum()), xt.shape[0], float(
                torch.where(differ, gap, 0).max()))
            if hold:
                top_e = want
                top_w = probs.gather(-1, top_e)
                top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True),
                                            min=1e-9)
            return logits, probs, top_w, top_e
        return self._wrap(fn)


#: granite's passes: (name, compute dtype, the routing held)
MD_MOE_PASSES = {"bf16": ("bfloat16", True),
                 "f32 free": ("float32", False),
                 "bf16 free": ("bfloat16", False)}


def _on_path(dtype: str):
    """The plain path for a float32 run (the kernels are bf16), else the
    kernels."""
    return plain_path() if dtype == "float32" else contextlib.nullcontext()


def md_moe_reference(tmp, passes):
    """granite's unsharded step on the card at ``MD_MOE_LAYERS``, on
    ``init_train_state``'s weights and the global batch, in the dtypes of
    ``passes`` (bf16 on the kernels, float32 on the plain path): the loss,
    aux terms and gradients, and each layer's routing (``RouteHold``),
    saved under ``tmp`` for the ranks."""
    from repro_torch.train import init_train_state, loss_and_grads
    from repro_torch.tree import flatten
    out = {}
    for dtype in dict.fromkeys(MD_MOE_PASSES[p][0] for p in passes):
        model = _md_model(MD_MOE_LAYERS, MOE_ARCH, dtype)
        state = init_train_state(model, seed=0)
        batch = _md_batches(model.cfg, MD_BATCH, 1)[0]
        hold = RouteHold()
        with hold.record(), _on_path(dtype):
            _, metrics, grads = loss_and_grads(model, state.params, batch)
        flat = {p: g.float().cpu() for p, g in flatten(grads)}
        out[dtype] = {
            "grads": os.path.join(tmp, f"moe_{dtype}.pt"),
            "routes": os.path.join(tmp, f"moe_routes_{dtype}.pt"),
            "max_abs": {p: float(g.abs().max()) for p, g in flat.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "gap_median": float(torch.cat([g for _, g in
                                           hold.routes.values()]).median())}
        torch.save(flat, out[dtype]["grads"])
        torch.save(hold.routes, out[dtype]["routes"])
        del model, state, grads, flat
        release()
    return out


def md_moe_rank(mesh, job, passes):
    """granite's sharded step on this rank in each of ``passes`` (names
    of ``MD_MOE_PASSES``), against the unsharded step of its dtype: its
    seconds, launches, collective bytes, the loss and aux terms, the
    tokens whose top-8 set differs from the unsharded step's (free
    routing), and each gradient block's largest difference from the
    unsharded step's block relative to that leaf's largest |value|."""
    from repro_torch import kernels
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import local_slices
    from repro_torch.parallel.train_step import (ShardedStep,
                                                 init_sharded_state)
    from repro_torch.tree import flatten
    out = {}
    for name in passes:
        dtype, held = MD_MOE_PASSES[name]
        ref = job["moe"][dtype]
        model = _md_model(MD_MOE_LAYERS, MOE_ARCH, dtype)
        state = init_sharded_state(model, mesh, seed=0)
        batch = _md_batches(model.cfg, MD_BATCH, 1)[0]
        plan = ShardedStep(model, mesh)
        local = plan.local_batch(batch)
        hold = RouteHold(torch.load(ref["routes"]))
        offset = plan.data_index * local["tokens"].numel()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        coll.COUNTER.reset()
        t0 = time.perf_counter()
        with hold.run(offset, held), _on_path(dtype):
            _, metrics, grads = plan.loss_and_grads(state.params, local)
        torch.cuda.synchronize()
        res = {"s": time.perf_counter() - t0,
               "launches": kernels.launch_counts(),
               "wire": dict(coll.COUNTER.bytes),
               "wire_s": dict(coll.COUNTER.seconds),
               "metrics": {k: float(v) for k, v in metrics.items()},
               "flips": hold.flips, "rows": hold.rows, "gap": hold.gap}
        want = torch.load(ref["grads"], mmap=True)
        specs = dict(flatten(plan.specs))
        coords = {"data": plan.data_index, "model": plan.model_rank}
        errs = {}
        for path, g in flatten(grads):
            block = want[path][local_slices(want[path].shape, specs[path],
                                            plan.sizes, coords)]
            errs[path] = float((g.float() - block.to(g.device)).abs().max()
                               ) / max(ref["max_abs"][path], 1e-30)
        res["grad_errs"] = errs
        out[name] = res
        del grads, want, state, model
        torch.cuda.empty_cache()
    return out


def _md_serve_inputs(vocab: int, n: int):
    rng = np.random.default_rng(11)
    return rng.integers(0, vocab, (MD_SERVE_SLOTS, n)).astype(np.int32)


def _md_serve_params(model):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    return model.init(gen)


#: llama3.2-1b's served run: (layers, compute dtype, prompt, steps)
MD_SERVE_RUNS = {
    "bf16": (MD_SERVE_LAYERS, "bfloat16", MD_SERVE_PROMPT, MD_SERVE_STEPS)}


def md_serve_reference(tmp):
    """llama3.2-1b's unsharded prefill and greedy dense-cache decode steps
    of each of ``MD_SERVE_RUNS`` (bf16 on the kernels): every call's
    logits (saved under ``tmp``) and the greedy tokens, which the ranks are
    fed."""
    out = {}
    for key, (layers, dtype, n, steps) in MD_SERVE_RUNS.items():
        model = _md_model(layers, "llama3.2-1b", dtype)
        params = _md_serve_params(model)
        V = model.cfg.vocab_size
        tokens = torch.from_numpy(_md_serve_inputs(V, n)).cuda()
        with torch.no_grad(), _on_path(dtype):
            logits, cache = model.prefill(params, tokens,
                                          max_seq=MD_SERVE_MAX_SEQ)
            calls, feed = [logits[:, :V].float().cpu()], []
            pos = torch.full((MD_SERVE_SLOTS,), n, dtype=torch.int32,
                             device="cuda")
            for _ in range(steps):
                tok = logits[:, :V].argmax(-1).to(torch.int32)
                feed.append(tok.cpu())
                logits, cache = model.decode_step(params, cache, tok, pos)
                calls.append(logits[:, :V].float().cpu())
                pos = pos + 1
        path = os.path.join(tmp, f"serve_{key}.pt")
        torch.save(torch.stack(calls), path)
        out[key] = {"logits": path, "feed": torch.stack(feed).numpy()}
        del model, params, cache, logits
        release()
    return out


def _md_serve_err(got, want, s, wire):
    """One call's gathered logits against the unsharded ones."""
    diff = (got - want).abs()
    top2 = want.topk(2, dim=-1).values
    differ = got.argmax(-1) != want.argmax(-1)
    near = top2[:, 0] - top2[:, 1] <= 2 * diff.amax(-1)
    return {"s": s, "wire": wire, "err": float(diff.max() / want.abs().max()),
            "differ": int(differ.sum()), "far": int((differ & ~near).sum()),
            "finite": bool(got.isfinite().all())}


def md_serve_rank(mesh, job, runs):
    """llama3.2-1b served on this rank (``ShardedServe``) in each of
    ``runs`` (keys of ``MD_SERVE_RUNS``): the sharded prefill of its rows,
    then the decode steps fed the unsharded greedy tokens; each call's
    seconds and collective bytes and its logits against the unsharded
    ones (the gathered rows), the bf16 run's launches and cache blocks."""
    from repro_torch import kernels
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.serve_step import ShardedServe, gather_rows
    from repro_torch.parallel.sharding import param_specs, shard_state
    out = {}
    for key in runs:
        layers, dtype, n, steps = MD_SERVE_RUNS[key]
        ref = job["serve"][key]
        model = _md_model(layers, "llama3.2-1b", dtype)
        params = _md_serve_params(model)
        local = shard_state(params, mesh, param_specs(model, mesh))
        del params
        torch.cuda.empty_cache()
        serve = ShardedServe(model, mesh, MD_SERVE_SLOTS, MD_SERVE_MAX_SEQ)
        want = torch.load(ref["logits"])
        V = model.cfg.vocab_size
        tokens = serve.local_rows(_md_serve_inputs(V, n))
        pos = serve.local_rows(torch.full((MD_SERVE_SLOTS,), n,
                                          dtype=torch.int32))
        kernels.reset_launch_counts()

        def call(fn, i):
            coll.COUNTER.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, kv = fn()
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            got = gather_rows(logits, serve)[:, :V].float().cpu()
            return kv, _md_serve_err(got, want[i], s,
                                     dict(coll.COUNTER.bytes))
        with _on_path(dtype):
            cache, err = call(lambda: serve.prefill(local, tokens), 0)
            calls = [err]
            for i in range(1, steps + 1):
                feed = serve.local_rows(torch.from_numpy(ref["feed"][i - 1]))
                _, err = call(lambda: serve.decode_step(local, cache, feed,
                                                        pos), i)
                calls.append(err)
                pos = pos + 1
            res = {"calls": calls, "launches": kernels.launch_counts(),
                   "shapes": {k: tuple(v.shape) for k, v in cache.items()}}
        out[key] = res
        del local, cache, model
        torch.cuda.empty_cache()
    return out


# the SSM, hybrid and encoder-decoder families sharded on the same (2, 2)
# ranks (the attention caches' sequence split in two blocks over model:
# zamba2-7b's and seamless's two bf16 decode steps write one position on
# each side of the boundary, their float32 step the first past it)
# ranks, at full width and reduced depth: mamba2-370m at 4 of its 48
# layers, zamba2-7b at 2 of 81 (its shared block applied once, before the
# two Mamba2 blocks of the tail), seamless-m4t-medium at 2 encoder and 2
# decoder layers of 12 with 1024 frames a row.  Each: one sharded train
# step in bf16 on the kernels from init_train_state's weights, held to the
# unsharded step on the same weights and batch (the loss at MD_LOSS_RTOL,
# every gradient block at MD_GRAD_TOL), then, from _md_serve_params'
# weights, a sharded prefill and decode steps fed the unsharded model's
# greedy tokens (logits at MD_SERVE_TOL, every argmax equal but at a near
# tie); then in float32 on the plain path at one layer (one encoder and
# one decoder layer for seamless) a prefill and one decode step, logits
# at MD_SERVE_F32_TOL, and a control that breaks the ranks' combine from
# the cache as it stood before that step (an attention partial past the
# first sequence block left out; mamba2's gate norm without its sum over
# model), which must read past that bound.  The rows stay few: zamba2-7b
# at full width is ~0.55e9 parameters, which gloo moves through the host.
# zamba2-7b (f32 False) runs no float32 pass on the ranks: its float32
# step and serving repeated the gates that mamba2-370m's (the Mamba2
# blocks' split, the gate norm's sum, g's combine) and seamless's (the
# attention heads' split, g's combine, the context-parallel combine and
# its control) keep; its bf16 step and serving stay gated, and its
# unsharded float32 step still sorts which leaves bf16 rounding alone puts
# past MD_GRAD_TOL (none may be, with no float32 pass to take them).
# (layers, train rows and tokens, served prompts and their length, the
# cache's max_seq, decode steps; the float32 pass's prompt length)
MD_FAMILIES = {
    "mamba2-370m": dict(layers=4, train=(8, 1024), slots=8, prompt=512,
                        max_seq=1024, steps=4, f32_prompt=512),
    "zamba2-7b": dict(layers=2, train=(4, 512), slots=4, prompt=1023,
                      max_seq=2048, steps=2, f32=False),
    "seamless-m4t-medium": dict(layers=2, train=(4, 256), slots=4,
                                prompt=511, max_seq=1024, steps=2,
                                f32_prompt=512)}
MD_FAM_FRAMES = 1024
#: a family's train passes and their compute dtype: float32 on the plain
#: path, held to the unsharded float32 step within MD_LOSS_RTOL and
#: MD_FAM_F32_GRAD_TOL (the gate that sees a broken combine); bf16 on the
#: kernels, held to the unsharded bf16 step: the loss within
#: MD_FAM_BF16_LOSS_RTOL and every gradient block within MD_GRAD_TOL, but
#: for the leaves where bf16 rounding alone is past that bound: those whose
#: unsharded bf16 gradient is more than MD_GRAD_TOL of its largest |value|
#: from the unsharded float32 gradient (a rule on the unsharded runs only,
#: which the sharded code cannot move).  They are logged with their
#: readings and left to the float32 pass.  On an H100 80GB HBM3 at 700 W
#: that is seamless-m4t-medium's cross-attention wq and wk and its
#: norm_cross scale and bias (0.120-0.199 of their largest |value|; its
#: cross-attention queries over 1024 near-uniformly weighted frames take a
#: gradient that is mostly rounding); every other leaf read at most 0.036.
MD_FAM_TRAIN = {"train": "bfloat16", "train_f32": "float32"}
MD_FAM_F32_GRAD_TOL = 1e-4
# the bf16 step's loss against the unsharded bf16 step's: the row-parallel
# partial sums are rounded to bf16 before g adds them, which moves a
# zamba2-7b step's loss by 1.931e-5 (its float32 step reads 0 off); the
# float32 pass holds the loss at MD_LOSS_RTOL
MD_FAM_BF16_LOSS_RTOL = 1e-4
# the bf16 gate's control: MD_FAM_CONTROL's bf16 step again with each
# rank's out_proj partial sums left out of g's combine, through the same
# check; its loss must read past MD_FAM_BF16_LOSS_RTOL and a gated
# gradient block past MD_GRAD_TOL
MD_FAM_CONTROL = "mamba2-370m"


def _md_fam_model(arch: str, layers: int, dtype: str):
    """``arch`` at full width, ``layers`` layers (and encoder layers) and
    compute ``dtype`` on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    extra = {"n_encoder_layers": layers} if cfg.family == "encdec" else {}
    return build_model(dataclasses.replace(
        cfg, n_layers=layers, compute_dtype=dtype, **extra), device="cuda")


def _md_fam_inputs(cfg, rows: int, n: int, seed: int):
    """Seeded tokens (rows, n + 1) and, for an encoder-decoder, frames
    (rows, MD_FAM_FRAMES, d), on the host."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (rows, n + 1)).astype(np.int32)
    frames = rng.standard_normal((rows, MD_FAM_FRAMES, cfg.d_model),
                                 dtype=np.float32) \
        if cfg.family == "encdec" else None
    return tokens, frames


def _md_fam_batch(cfg, spec):
    rows, n = spec["train"]
    tokens, frames = _md_fam_inputs(cfg, rows, n, seed=21)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "targets": torch.from_numpy(tokens[:, 1:])}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    return batch


#: a family's served passes: (layers, compute dtype, prompt, steps)
def _md_fam_passes(spec):
    passes = {"bf16": (spec["layers"], "bfloat16", spec["prompt"],
                       spec["steps"])}
    if spec.get("f32", True):
        passes["f32"] = (1, "float32", spec["f32_prompt"], 1)
    return passes


def md_family_reference(tmp):
    """Each of ``MD_FAMILIES`` unsharded on the card: its bf16 train step
    (loss, gradients saved under ``tmp``, each leaf's largest |value|) on
    the kernels, and its served passes (bf16 on the kernels, float32 on
    the plain path): every call's logits (saved) and the greedy tokens the
    ranks are fed."""
    from repro_torch.train import init_train_state, loss_and_grads
    from repro_torch.tree import flatten
    out = {}
    for arch, spec in MD_FAMILIES.items():
        safe = arch.replace(".", "_")
        ref, flats = {}, {}
        for key, dtype in MD_FAM_TRAIN.items():
            model = _md_fam_model(arch, spec["layers"], dtype)
            state = init_train_state(model, seed=0)
            with _on_path(dtype):
                loss, _, grads = loss_and_grads(
                    model, state.params, _md_fam_batch(model.cfg, spec))
            flat = flats[key] = {p: g.float().cpu()
                                 for p, g in flatten(grads)}
            ref[key] = {"loss": float(loss),
                        "max_abs": {p: float(g.abs().max())
                                    for p, g in flat.items()},
                        "grads": os.path.join(tmp, f"fam_{safe}_{key}.pt")}
            torch.save(flat, ref[key]["grads"])
            del model, state, grads
            release()
        # bf16 rounding's own share: the unsharded bf16 step against the
        # unsharded float32 step, each leaf relative to its bf16 largest
        bf = ref["train"]
        bf["loss_noise"] = _rel(bf["loss"], ref["train_f32"]["loss"])
        bf["noise"] = {p: float((g - flats["train_f32"][p]).abs().max())
                       / max(bf["max_abs"][p], 1e-30)
                       for p, g in flats["train"].items()}
        del flats
        for key, (layers, dtype, n, steps) in _md_fam_passes(spec).items():
            model = _md_fam_model(arch, layers, dtype)
            params = _md_serve_params(model)
            V, B = model.cfg.vocab_size, spec["slots"]
            tokens, frames = _md_fam_inputs(model.cfg, B, n - 1, seed=11)
            tokens = torch.from_numpy(tokens).to(model.device)
            extra = {} if frames is None else {
                "frames": torch.from_numpy(frames).to(model.device)}
            with torch.no_grad(), _on_path(dtype):
                logits, cache = model.prefill(params, tokens,
                                              max_seq=spec["max_seq"],
                                              **extra)
                calls, feed = [logits[:, :V].float().cpu()], []
                pos = torch.full((B,), n, dtype=torch.int32,
                                 device=model.device)
                for _ in range(steps):
                    tok = logits[:, :V].argmax(-1).to(torch.int32)
                    feed.append(tok.cpu())
                    logits, cache = model.decode_step(params, cache, tok,
                                                      pos)
                    calls.append(logits[:, :V].float().cpu())
                    pos = pos + 1
            path = os.path.join(tmp, f"fam_{safe}_{key}.pt")
            torch.save(torch.stack(calls), path)
            ref[key] = {"logits": path, "feed": torch.stack(feed).numpy()}
            del model, params, cache, logits
            release()
        out[arch] = ref
    return out


def _md_fam_control(serve):
    """A broken combine for the control: every attention partial past the
    first sequence block left out, or (attention-free) the gate norm's
    sum over ``model`` left out."""
    if serve.mamba is not None and serve.cfg.family == "ssm":
        serve.mamba = serve.mamba._replace(norm_sum=lambda t: t)
        return
    part = serve._partial
    serve._partial = lambda q, kc, vc, valid, blk: part(
        q, kc, vc, valid if blk.start == 0 else torch.zeros_like(valid),
        blk)


def md_family_rank(mesh, job, passes=("train", "train_control", "train_f32",
                                     "bf16", "f32")):
    """Each of ``MD_FAMILIES`` on this rank: the sharded train steps of
    ``MD_FAM_TRAIN`` in ``passes`` (seconds, launches, collective bytes,
    the loss and each gradient block against the unsharded step's of its
    dtype; with ``"train_control"``, ``MD_FAM_CONTROL``'s bf16 step again
    with its combine broken), and the served passes
    of ``passes`` (``ShardedServe``: the prefill, then decode steps fed
    the unsharded greedy tokens; each call's seconds, collective bytes
    and gathered logits against the unsharded ones; the bf16 pass's
    launches and cache blocks; after the float32 pass, its control from
    the cache as it stood before its step)."""
    from repro_torch import kernels
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.serve_step import ShardedServe, gather_rows
    from repro_torch.parallel.sharding import (local_shape, local_slices,
                                               param_specs, shard_state)
    from repro_torch.parallel.train_step import (ShardedStep,
                                                 init_sharded_state)
    from repro_torch.tree import flatten
    out = {}
    for arch, spec in MD_FAMILIES.items():
        fam, res = job["families"][arch], {"cache_shapes": {}}
        t_fam = time.perf_counter()
        for key, dtype in MD_FAM_TRAIN.items():
            if key not in passes or (dtype == "float32"
                                     and not spec.get("f32", True)):
                continue
            ref = fam[key]
            model = _md_fam_model(arch, spec["layers"], dtype)
            state = init_sharded_state(model, mesh, seed=0)
            plan = ShardedStep(model, mesh)
            local = plan.local_batch(_md_fam_batch(model.cfg, spec))
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            coll.COUNTER.reset()
            t0 = time.perf_counter()
            with _on_path(dtype):
                loss, _, grads = plan.loss_and_grads(state.params, local)
            torch.cuda.synchronize()
            train = {"s": time.perf_counter() - t0, "loss": float(loss),
                     "ref_loss": ref["loss"],
                     "noise": ref.get("noise"),
                     "loss_noise": ref.get("loss_noise"),
                     "launches": kernels.launch_counts(),
                     "wire": dict(coll.COUNTER.bytes),
                     "wire_s": dict(coll.COUNTER.seconds)}
            want = torch.load(ref["grads"], mmap=True)
            specs = dict(flatten(plan.specs))
            coords = {"data": plan.data_index, "model": plan.model_rank}

            def block_errs(grads):
                errs = {}
                for path, g in flatten(grads):
                    block = want[path][local_slices(
                        want[path].shape, specs[path], plan.sizes, coords)]
                    errs[path] = float((g.float() - block.to(g.device))
                                       .abs().max()) \
                        / max(ref["max_abs"][path], 1e-30)
                return errs
            train["grad_errs"] = block_errs(grads)
            res[key] = train
            if key == "train" and arch == MD_FAM_CONTROL and \
                    "train_control" in passes:
                shard = plan.hooks["mamba"]
                plan.hooks["mamba"] = shard._replace(g=lambda t: t)
                with _on_path(dtype):
                    loss, _, grads = plan.loss_and_grads(state.params, local)
                plan.hooks["mamba"] = shard
                res["train_control"] = {"loss": float(loss),
                                        "grad_errs": block_errs(grads)}
            del state, grads, want, model, plan
            torch.cuda.empty_cache()
        ref = fam
        for key, (layers, dtype, n, steps) in _md_fam_passes(spec).items():
            if key not in passes:
                continue
            model = _md_fam_model(arch, layers, dtype)
            params = _md_serve_params(model)
            local = shard_state(params, mesh, param_specs(model, mesh))
            del params
            torch.cuda.empty_cache()
            B, V = spec["slots"], model.cfg.vocab_size
            serve = ShardedServe(model, mesh, B, spec["max_seq"])
            res["cache_shapes"][key] = {
                k: local_shape(leaf.shape, serve.cache_specs[k],
                               serve.plan.sizes)
                for k, leaf in model._cache_struct(
                    B, spec["max_seq"]).items()}
            want = torch.load(ref[key]["logits"])
            tokens, frames = _md_fam_inputs(model.cfg, B, n - 1, seed=11)
            tokens = serve.local_rows(tokens)
            extra = None if frames is None else serve.local_rows(frames)
            pos = serve.local_rows(torch.full((B,), n, dtype=torch.int32))
            kernels.reset_launch_counts()

            def call(fn, i):
                coll.COUNTER.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, kv = fn()
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                got = gather_rows(logits, serve)[:, :V].float().cpu()
                return kv, _md_serve_err(got, want[i], s,
                                         dict(coll.COUNTER.bytes))
            with _on_path(dtype):
                cache, err = call(lambda: serve.prefill(local, tokens, extra),
                                  0)
                calls, before = [err], None
                for i in range(1, steps + 1):
                    feed = serve.local_rows(torch.from_numpy(
                        ref[key]["feed"][i - 1]))
                    if i == steps and dtype == "float32":
                        before = {k: v.clone() for k, v in cache.items()}
                    _, err = call(lambda: serve.decode_step(
                        local, cache, feed, pos), i)
                    calls.append(err)
                    pos = pos + 1
                served = {"calls": calls,
                          "launches": kernels.launch_counts(),
                          "shapes": {k: tuple(v.shape)
                                     for k, v in cache.items()}}
                if before is not None:
                    _md_fam_control(serve)
                    _, served["control"] = call(lambda: serve.decode_step(
                        local, before, feed, pos - 1), steps)
            res[key] = served
            del local, cache, model, serve, before
            torch.cuda.empty_cache()
        res["total_s"] = time.perf_counter() - t_fam
        out[arch] = res
    return out


def md_family_launches(arch: str, key: str):
    """The exact launches of a family's sharded run on a rank: ``"train"``
    the bf16 step (remat recomputes each checkpointed layer's forward:
    mamba2-370m's layers, seamless's encoder and decoder layers; zamba2-7b
    at 2 layers runs the shared block and its tail outside any
    checkpoint), ``"bf16"`` its prefill and decode steps.  The gate norm
    over a split ``d_inner`` is plain f32, not the RMSNorm kernel, and the
    decode steps' attention and SSD updates are plain."""
    spec = MD_FAMILIES[arch]
    L, calls = spec["layers"], spec["steps"] + 1
    zero = {"rmsnorm": 0, "flash_prefill": 0, "flash_bwd": 0,
            "paged_decode": 0, "ssd_scan": 0}
    if arch == "mamba2-370m":
        per = {"train": {"rmsnorm": 2 * L + 1, "ssd_scan": 2 * L},
               "bf16": {"rmsnorm": (L + 1) * calls, "ssd_scan": L}}
    elif arch == "zamba2-7b":
        per = {"train": {"rmsnorm": 2 + L + 1, "ssd_scan": L,
                         "flash_prefill": 1, "flash_bwd": 1},
               "bf16": {"rmsnorm": (2 + L + 1) * calls, "ssd_scan": L,
                        "flash_prefill": 1}}
    else:
        per = {"train": {"flash_prefill": 2 * 3 * L, "flash_bwd": 3 * L},
               "bf16": {"flash_prefill": 3 * L}}
    return dict(zero, **per[key])


def md_check_families(tag, who, res, mesh):
    """Log one rank's family runs (:func:`md_family_rank`) and return what
    they fail of their gates: the float32 train step's loss within
    ``MD_LOSS_RTOL`` and every gradient block within
    ``MD_FAM_F32_GRAD_TOL`` of the unsharded float32 step's; the bf16 train
    step's loss within ``MD_FAM_BF16_LOSS_RTOL`` and every gradient block
    within ``MD_GRAD_TOL`` of the unsharded bf16 step's (the leaves where
    the unsharded bf16 step is itself past ``MD_GRAD_TOL`` from float32
    logged and left to the float32 pass), exact launches, and its control
    (``MD_FAM_CONTROL``) past both bounds; the bf16
    serving's finite logits within ``MD_SERVE_TOL`` at
    every call, every argmax equal but at a near tie, exact launches; the
    float32 serving within ``MD_SERVE_F32_TOL`` at every call, its control
    past that bound; every cache block of the shape ``cache_specs``
    gives."""
    problems = []
    for arch, r in res.items():
        spec = MD_FAMILIES[arch]
        for key, dtype in MD_FAM_TRAIN.items():
            if key not in r:
                continue
            t = r[key]
            rel = _rel(t["loss"], t["ref_loss"])
            if dtype == "bfloat16":
                loss_tol, tol = MD_FAM_BF16_LOSS_RTOL, MD_GRAD_TOL
                out = {p: n for p, n in t["noise"].items() if n > tol}
                want = md_family_launches(arch, "train")
                how = (f"bf16, the kernels; the unsharded bf16 loss reads "
                       f"{t['loss_noise']:.3e} of the float32 one")
            else:
                loss_tol, tol, out = MD_LOSS_RTOL, MD_FAM_F32_GRAD_TOL, {}
                want = None
                how = "float32, the plain path"
            gated = {p: e for p, e in t["grad_errs"].items() if p not in out}
            if out and not spec.get("f32", True):
                problems.append(f"{who}'s sharded {arch} step: leaves "
                                f"{sorted(out)} left to a float32 pass that "
                                f"does not run")
            worst = max(gated, key=gated.get)
            log(f"[{tag}] {who} {arch} sharded train step at "
                f"{spec['layers']} layers, {spec['train'][0] // mesh[0]} x "
                f"{spec['train'][1]} tokens a data rank ({how}): loss "
                f"{t['loss']:.6f}, {rel:.3e} of the unsharded (bound "
                f"{loss_tol:.3e}); gradient blocks within "
                f"{gated[worst]:.3e} of each leaf's largest |value| (worst "
                f"{worst}, bound {tol:.3e}"
                + (f"; left to the float32 pass, bf16 rounding alone past "
                   f"the bound (the unsharded bf16 step's distance from "
                   f"float32, then this step's reading): " + ", ".join(
                       f"{p} {n:.3e} {t['grad_errs'][p]:.3e}"
                       for p, n in out.items()) if out else "")
                + f"); {t['s']:.3f} s, "
                f"launches {t['launches']}; collective bytes " + ", ".join(
                    f"{k} {v:.4e} ({t['wire_s'][k]:.3f} s)"
                    for k, v in t["wire"].items() if v))
            if not rel <= loss_tol or not gated[worst] <= tol \
                    or (want is not None and t["launches"] != want):
                problems.append(f"{who}'s sharded {arch} step ({dtype}) "
                                f"parts from the unsharded one or launches "
                                f"{t['launches']} != {want}")
            if "train_control" in r and dtype == "bfloat16":
                c = r["train_control"]
                c_rel = _rel(c["loss"], t["ref_loss"])
                c_gated = {p: e for p, e in c["grad_errs"].items()
                           if p not in out}
                c_worst = max(c_gated, key=c_gated.get)
                log(f"[{tag}] {who} {arch} bf16 control (the step again, "
                    f"out_proj's partial sums left out of g's combine): "
                    f"loss {c['loss']:.6f}, {c_rel:.3e} of the unsharded "
                    f"(bound {loss_tol:.3e}); gradient blocks within "
                    f"{c_gated[c_worst]:.3e} (worst {c_worst}, bound "
                    f"{tol:.3e}); "
                    f"{sum(e > tol for e in c_gated.values())} of "
                    f"{len(c_gated)} gated blocks past the bound")
                if not (c_rel > loss_tol and c_gated[c_worst] > tol):
                    problems.append(f"{who}'s bf16 {arch} gate does not "
                                    f"see its combine broken (loss "
                                    f"{c_rel:.3e}, gradient "
                                    f"{c_gated[c_worst]:.3e})")
        for key, (layers, dtype, n, steps) in _md_fam_passes(spec).items():
            if key not in r:
                continue
            s = r[key]
            tol = MD_SERVE_TOL if key == "bf16" else MD_SERVE_F32_TOL
            calls = list(enumerate(s["calls"]))
            if "control" in s:
                calls.append(("control", s["control"]))
            for i, c in calls:
                name = "prefill" if i == 0 else f"decode {i}" \
                    if i != "control" else f"control (decode {steps} " \
                    f"again, its combine broken)"
                log(f"[{tag}] {who} {arch} {key} at {layers} layers, "
                    f"{spec['slots']} prompts of {n}: {name}: {c['s']:.3f} "
                    f"s; logits within {c['err']:.3e} of the largest "
                    f"|logit| (bound {tol}); argmax differs at "
                    f"{c['differ']} rows ({c['far']} past a near tie); "
                    f"collective bytes " + ", ".join(
                        f"{k} {v:.4e}" for k, v in c["wire"].items() if v))
            log(f"[{tag}] {who} {arch} {key} served: launches "
                f"{s['launches']}; cache blocks {s['shapes']}")
            bad = [i for i, c in enumerate(s["calls"]) if not c["finite"]
                   or not c["err"] <= tol or (key == "bf16" and c["far"])]
            if bad or s["shapes"] != r["cache_shapes"][key]:
                problems.append(f"{who}'s sharded {arch} serving ({key}) "
                                f"parts from the unsharded run at calls "
                                f"{bad}, or its cache blocks "
                                f"{s['shapes']} are not cache_specs' "
                                f"{r['cache_shapes'][key]}")
            want = md_family_launches(arch, "bf16")
            if key == "bf16" and s["launches"] != want:
                problems.append(f"{who}'s sharded {arch} serving launches "
                                f"{s['launches']} != {want}")
            if "control" in s and not s["control"]["err"] > tol:
                problems.append(f"{who}'s float32 {arch} gate does not see "
                                f"its combine broken "
                                f"({s['control']['err']:.3e})")
    return problems


def _md_model(layers: int, arch: str = "gpt3-xl",
              dtype: str = "bfloat16"):
    """``arch`` at full width, ``layers`` layers and compute ``dtype`` on
    the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    return build_model(dataclasses.replace(
        get_config(arch), n_layers=layers, compute_dtype=dtype),
        device="cuda")


def _md_batches(cfg, rows: int, steps: int):
    from repro_torch.data import DataPipeline
    pipeline = DataPipeline(cfg.vocab_size, rows, TRAIN_SEQ, seed=0)
    return [pipeline.next_batch() for _ in range(steps)]


def md_moe_inputs(gen):
    """Global MoE inputs at granite's layer width on the card: tokens,
    skewed top-8 routing of 32 experts, SwiGLU expert weights (f32)."""
    E, K, d, ff, T = 32, 8, 1024, 512, MD_MOE_TOKENS
    xt = torch.randn(T, d, generator=gen, device="cuda")
    logits = torch.randn(T, E, generator=gen, device="cuda")
    logits[:, :E // 4] += MD_MOE_SKEW
    top_w, top_e = torch.softmax(logits, -1).topk(K, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    ws = tuple(torch.randn(shape, generator=gen, device="cuda") * s
               for shape, s in (((E, d, ff), d ** -0.5),
                                ((E, d, ff), d ** -0.5),
                                ((E, ff, d), ff ** -0.5)))
    return xt, top_e, top_w, ws


def _md_swiglu(local_eid, x, weights):
    """The rank's SwiGLU experts on the rows routed to each."""
    wg, wu, wd = weights
    y = torch.zeros_like(x)
    for e in range(wg.shape[0]):
        rows = (local_eid == e).nonzero()[:, 0]
        h = x[rows]
        y[rows] = (F.silu(h @ wg[e]) * (h @ wu[e])) @ wd[e]
    return y


def md_moe_dense(xt, top_e, top_w, ws):
    """Every expert on every token, combined by the gates."""
    wg, wu, wd = ws
    h = F.silu(torch.einsum("td,edf->etf", xt, wg)) \
        * torch.einsum("td,edf->etf", xt, wu)
    y_all = torch.einsum("etf,efd->etd", h, wd)
    gates = torch.zeros(xt.shape[0], wg.shape[0], device=xt.device) \
        .scatter(1, top_e, top_w)
    return torch.einsum("te,etd->td", gates, y_all)


def md_rank(rank, world, job):
    """One of the four ranks (``job["backend"]``: gloo ranks share card 0,
    nccl ranks take a card each): gpt3-xl's sharded gradient of batch 0
    (each block against the same block of the unsharded gradient the
    parent saved), ``MD_STEPS`` sharded steps (seconds, launches and
    collective bytes a step), then the MoE exchange over the four ranks on
    CUDA tensors; then granite-moe-1b-a400m's sharded step
    (:func:`md_moe_rank`), llama3.2-1b's sharded serving
    (:func:`md_serve_rank`) and the SSM, hybrid and encoder-decoder
    families' sharded step and serving (:func:`md_family_rank`).  Returns
    a summary."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import kernels
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import local_slices, param_specs
    from repro_torch.parallel.train_step import (ShardedStep,
                                                 init_sharded_state)
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.tree import flatten
    t_start = time.perf_counter()
    nccl = job["backend"] == "nccl"
    torch.cuda.set_device(rank if nccl else 0)
    groups_on = "cuda" if nccl else "cpu"
    model = _md_model(job["layers"])
    mesh = make_host_mesh(*MD_MESH, device_type=groups_on)
    state = init_sharded_state(model, mesh, seed=0)
    torch.cuda.empty_cache()
    plan = ShardedStep(model, mesh)
    specs = param_specs(model, mesh)
    batches = _md_batches(model.cfg, MD_BATCH, MD_STEPS)
    out = {"rank": rank, "data_index": plan.data_index}
    loss, _, grads = plan.loss_and_grads(state.params,
                                         plan.local_batch(batches[0]))
    out["loss"] = float(loss)
    ref = torch.load(job["grads"], mmap=True)
    flat_specs = dict(flatten(specs))
    coords = {"data": plan.data_index,
              "model": coll.group_rank(plan.model_group)}
    errs = {}
    for path, g in flatten(grads):
        block = ref[path][local_slices(ref[path].shape, flat_specs[path],
                                       plan.sizes, coords)]
        diff = (g.float() - block.to("cuda")).abs().max()
        errs[path] = float(diff) / job["max_abs"][path]
    del grads, ref
    out["grad_errs"] = errs
    step = make_train_step(model, OptimizerConfig(lr=3e-4, warmup_steps=2),
                           remat=True, mesh=mesh)
    out["steps"] = []
    for data in batches:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        coll.COUNTER.reset()
        t0 = time.perf_counter()
        state, metrics = step(state, data)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        out["steps"].append(dict(
            s=time.perf_counter() - t0, loss=loss,
            grad_norm=float(metrics["grad_norm"]),
            launches=kernels.launch_counts(), wire=dict(coll.COUNTER.bytes),
            calls=dict(coll.COUNTER.calls),
            wire_s=dict(coll.COUNTER.seconds)))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del state, step
    torch.cuda.empty_cache()
    # the MoE exchange across the same four ranks, on the card
    ep_mesh = init_device_mesh(groups_on, (world,),
                               mesh_dim_names=("model",))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    xt, top_e, top_w, ws = md_moe_inputs(gen)
    dense = md_moe_dense(xt, top_e, top_w, ws)
    tl = xt.shape[0] // world
    for cf in (float(world), 2.0):      # capacity T_l * K, then 2.0
        coll.COUNTER.reset()
        y = coll.moe_all_to_all_sharded(ep_mesh, xt, top_e, top_w, ws,
                                        _md_swiglu, n_experts=32,
                                        capacity_factor=cf)
        out[f"moe_{cf:g}"] = dict(
            err=float((y - dense).abs().max() / dense.abs().max()),
            dropped=coll.dropped_assignments(
                top_e[rank * tl:(rank + 1) * tl], n_experts=32, ep=world,
                capacity_factor=cf),
            assignments=tl * top_e.shape[1],
            wire=dict(coll.COUNTER.bytes), finite=bool(y.isfinite().all()))
    del xt, ws, dense, y
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["moe_step"] = md_moe_rank(mesh, job, job["moe_passes"])
    t2 = time.perf_counter()
    out["serve"] = md_serve_rank(mesh, job, tuple(MD_SERVE_RUNS))
    t3 = time.perf_counter()
    out["families"] = md_family_rank(mesh, job)
    out["section_s"] = {"gpt3-xl and the exchange": t1 - t_start,
                        MOE_ARCH: t2 - t1, "llama3.2-1b serving": t3 - t2,
                        **{arch: f["total_s"]
                           for arch, f in out["families"].items()}}
    out["peak_all_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def md_nccl(model, params, batch, loss0, grads0, tmp, job):
    """The one nccl rank, in this process (a world of one, before the gloo
    world starts): the sharded step on a (1, 1) mesh against the unsharded
    loss ``loss0`` and gradients ``grads0`` taken on the same weights
    ``params`` and ``batch``; granite's sharded step and llama3.2-1b's
    sharded serving, and the SSM, hybrid and encoder-decoder families'
    sharded step and bf16 serving, against their unsharded runs (``job``);
    each collective once on CUDA bf16 tensors through the nccl group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import param_specs, shard_state
    from repro_torch.parallel.train_step import ShardedStep
    from repro_torch.tree import flatten
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        plan = ShardedStep(model, mesh)
        local = shard_state(params, mesh, param_specs(model, mesh))
        loss1, _, g1 = plan.loss_and_grads(local, plan.local_batch(batch))
        worst = max(float((a.float() - b.float()).abs().max()
                          / a.float().abs().max())
                    for (_, a), (_, b) in zip(flatten(grads0), flatten(g1)))
        del local, g1
        t = torch.arange(8, dtype=torch.bfloat16, device="cuda")
        out = torch.empty_like(t)
        dist.all_reduce(t)
        dist.all_gather_into_tensor(out, t)
        dist.reduce_scatter_tensor(out, t)
        dist.all_to_all_single(out, t)
        torch.cuda.synchronize()
        res = {"backend": dist.get_backend(), "loss": float(loss0),
               "sharded_loss": float(loss1), "grad_max_diff": worst,
               "collectives_ok": bool(torch.equal(out, t)),
               "s": time.perf_counter() - t0}
        res["moe_step"] = md_moe_rank(mesh, job, ("bf16",))
        res["serve"] = md_serve_rank(mesh, job, ("bf16",))
        res["families"] = md_family_rank(mesh, job, ("train", "bf16"))
        return res
    finally:
        dist.destroy_process_group()


def phase_multidevice(layers: int = MD_LAYERS, cards: int = 1,
                      free_routing: bool = False):
    """gpt3-xl at full width and ``layers`` layers trained as four ranks on
    a (data 2, model 2) mesh, gloo ranks sharing the card (``cards`` 1) or
    nccl ranks a card each (``cards`` 4, ``--cards 4``): each rank holds its
    blocks (``param_specs``), takes 4 of the 8 rows, runs 8 of the 16
    heads and half of d_ff with the kernels (Megatron's f and g between),
    gathers every embed dim on use (FSDP), and clips by the norm over the
    mesh.  The parent first takes the unsharded gradient of batch 0 on the
    same weights (``init_train_state``'s) and saves it; each rank holds
    its sharded loss (against the unsharded, ``MD_LOSS_RTOL``) and every
    gradient block (``MD_GRAD_TOL``) to it, then takes ``MD_STEPS`` steps:
    finite losses equal on every rank, exact launches a step (2 L flash
    forwards with their log-sum-exp, L backwards), step seconds and
    collective bytes by kind (not gated).  Then ``moe_all_to_all_sharded``
    over the four ranks on CUDA tensors at granite's layer width against
    the dense combine at a capacity that keeps every assignment (float32,
    ``MD_MOE_TOL`` of the largest |value|), and at capacity 2.0, where
    assignments drop.  On one card, before the gloo world starts, one rank
    under ``nccl`` in this process, a world of one on a (1, 1) mesh
    (:func:`md_nccl`): the sharded step's loss equals the unsharded one
    and its gradients are within ``MD_GRAD_TOL`` (the sharded embedding
    gathers its bf16 cast, so repeated tokens' rows add in bf16, the
    unsharded in f32); its collectives return early on a world of one, so
    their nccl branches over several ranks run on no card here.  Beside
    the loss bound it logs a control (not gated): the unsharded loss of
    the first data rank's rows alone, what the global loss would read had
    the other data rank taken them.  Then on every rank granite's sharded
    step (:func:`md_moe_rank`; bf16 with its routing held, and with
    ``free_routing`` float32 and bf16 with it free, logged) and
    llama3.2-1b's sharded serving (:func:`md_serve_rank`; bf16; the
    families' float32 passes gate its combine), each held to the unsharded
    runs the parent
    takes first (:func:`md_check_moe`, :func:`md_check_serve`: every rank
    logged before a failure raises); the nccl rank runs their bf16
    passes.  Returns rank 0's launches over the
    steps and the seconds."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.train import init_train_state, loss_and_grads
    from repro_torch.tree import flatten
    tag = "multidevice"
    L = layers
    moe_passes = ("bf16",) + (("f32 free", "bf16 free") if free_routing
                              else ())
    backend = "gloo" if cards == 1 else "nccl"
    t0 = time.perf_counter()
    model = _md_model(L)
    cfg = model.cfg
    state = init_train_state(model, seed=0)
    batch = _md_batches(cfg, MD_BATCH, 1)[0]
    loss, _, grads = loss_and_grads(model, state.params, batch)
    ref_loss = float(loss)
    rows = MD_BATCH // MD_MESH[0]
    with torch.no_grad():
        control = float(model.loss(state.params, {k: v[:rows] for k, v in
                                                  batch.items()})[0])
    control_rel = abs(control - ref_loss) / abs(ref_loss)
    with tempfile.TemporaryDirectory(prefix="md_") as tmp:
        path = os.path.join(tmp, "grads.pt")
        flat = {p: g.float().cpu() for p, g in flatten(grads)}
        max_abs = {p: float(g.abs().max()) for p, g in flat.items()}
        torch.save(flat, path)
        del flat
        log(f"[{tag}] gpt3-xl at {L} of 24 layers (d {cfg.d_model}, "
            f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}): the unsharded loss of "
            f"{MD_BATCH} x {TRAIN_SEQ} tokens {ref_loss:.6f} and its "
            f"gradient saved in {time.perf_counter() - t0:.1f} s; control "
            f"(a data rank on the other's rows): the first {rows} rows' "
            f"loss {control:.6f}, {control_rel:.3e} of it (the bound "
            f"{MD_LOSS_RTOL})")
        t1 = time.perf_counter()
        refs = {"moe": md_moe_reference(tmp, moe_passes),
                "serve": md_serve_reference(tmp)}
        t2 = time.perf_counter()
        refs["families"] = md_family_reference(tmp)
        log(f"[{tag}] the SSM, hybrid and encoder-decoder families "
            f"unsharded: " + "; ".join(
                f"{arch} at {sp['layers']} layers, the bf16 step's loss "
                f"{refs['families'][arch]['train']['loss']:.6f} ("
                f"{refs['families'][arch]['train']['loss_noise']:.3e} of "
                f"the float32 step's) over "
                f"{sp['train'][0]} x {sp['train'][1]} tokens, "
                f"{sp['slots']} prompts of {sp['prompt']} into max_seq "
                f"{sp['max_seq']} and {sp['steps']} greedy steps" + (
                    f" (float32 at 1 layer: prompts of {sp['f32_prompt']}, "
                    f"1 step)" if sp.get("f32", True) else
                    " (no float32 pass on the ranks)")
                for arch, sp in MD_FAMILIES.items())
            + f"; {time.perf_counter() - t2:.1f} s")
        moe = refs["moe"]
        log(f"[{tag}] {MOE_ARCH} at {MD_MOE_LAYERS} of 24 layers, the "
            f"unsharded step of {MD_BATCH} x {TRAIN_SEQ} tokens: " + "; ".join(
                f"{dtype} {_md_metrics(m['metrics'])}, the median gap "
                f"between the 8th and 9th router logits {m['gap_median']:.3e}"
                for dtype, m in moe.items()) + "; llama3.2-1b "
            f"served unsharded ({MD_SERVE_SLOTS} prompts, max_seq "
            f"{MD_SERVE_MAX_SEQ}): " + "; ".join(
                f"{k} at {r[0]} of 16 layers, prompts of {r[2]} tokens, "
                f"{r[3]} greedy steps" for k, r in MD_SERVE_RUNS.items())
            + f"; {time.perf_counter() - t1:.1f} s")
        if cards == 1:
            nccl = md_nccl(model, state.params, batch, loss, grads, tmp,
                           refs)
            log(f"[{tag}] one {nccl['backend']} rank in this process, "
                f"(1, 1) mesh, the same {L} layers and {MD_BATCH} x "
                f"{TRAIN_SEQ} tokens: loss {nccl['loss']:.6f} unsharded, "
                f"{nccl['sharded_loss']:.6f} sharded, gradients within "
                f"{nccl['grad_max_diff']:.3e} of each leaf's largest "
                f"|value| (the embedding's rows accumulate in bf16 behind "
                f"the gather's cast); collectives on CUDA tensors "
                f"{'ok' if nccl['collectives_ok'] else 'WRONG'} "
                f"({nccl['s']:.1f} s)")
            if nccl["backend"] != "nccl" or not nccl["collectives_ok"] or \
                    nccl["loss"] != nccl["sharded_loss"] or \
                    not nccl["grad_max_diff"] <= MD_GRAD_TOL:
                raise AssertionError(f"{tag}: the nccl rank's sharded step "
                                     f"parts from the unsharded one: {nccl}")
            problems = md_check_moe(tag, "the nccl rank", nccl["moe_step"],
                                    moe) + md_check_serve(
                tag, "the nccl rank", nccl["serve"], (1, 1)) \
                + md_check_families(tag, "the nccl rank",
                                    nccl["families"], (1, 1))
            if problems:
                raise AssertionError(f"{tag}: {problems}")
        del model, state, grads
        release()
        t1 = time.perf_counter()
        ranks = spawn_ranks(md_rank, MD_MESH[0] * MD_MESH[1],
                            dict(refs, layers=L, grads=path, max_abs=max_abs,
                                 backend=backend, moe_passes=moe_passes),
                            backend=backend,
                            timeout_s=900)
        where = "sharing one card" if cards == 1 else "a card each"
        log(f"[{tag}] {len(ranks)} {backend} ranks on a (data, model) = "
            f"{MD_MESH} mesh, {where}, finished in "
            f"{time.perf_counter() - t1:.1f} s")
    per_step = {"rmsnorm": 0, "flash_prefill": 2 * L, "flash_bwd": L,
                "paged_decode": 0, "ssd_scan": 0}
    what = "host copies and gloo" if cards == 1 else "their enqueue"
    for r in ranks:
        worst = max(r["grad_errs"], key=r["grad_errs"].get)
        rel = abs(r["loss"] - ref_loss) / abs(ref_loss)
        log(f"[{tag}] rank {r['rank']} (data {r['data_index']}): loss "
            f"{r['loss']:.6f} ({rel:.2e} of the unsharded, bound "
            f"{MD_LOSS_RTOL}); gradient blocks within "
            f"{r['grad_errs'][worst]:.3e} of each leaf's largest |value| "
            f"(worst {worst}; bound {MD_GRAD_TOL}); peak "
            f"{r['peak_gib']:.2f} GiB")
        if not rel <= MD_LOSS_RTOL or \
                not r["grad_errs"][worst] <= MD_GRAD_TOL:
            raise AssertionError(f"{tag}: rank {r['rank']} parts from the "
                                 f"unsharded step")
        for i, s in enumerate(r["steps"]):
            launches = {k: v for k, v in s["launches"].items()}
            log(f"[{tag}] rank {r['rank']} step {i}: loss {s['loss']:.6f}, "
                f"grad_norm {s['grad_norm']:.4f}, {s['s']:.3f} s, "
                f"{sum(s['wire_s'].values()):.3f} s of it in the "
                f"collectives' calls ({what}); launches "
                f"{launches}; collective bytes " + ", ".join(
                    f"{k} {v:.4e} ({s['calls'][k]} calls, "
                    f"{s['wire_s'][k]:.3f} s)"
                    for k, v in s["wire"].items() if v))
            if not math.isfinite(s["loss"]) or launches != per_step:
                raise AssertionError(f"{tag}: rank {r['rank']} step {i}: "
                                     f"loss {s['loss']}, launches {launches}"
                                     f" != {per_step}")
    for i in range(MD_STEPS):
        if len({r["steps"][i]["loss"] for r in ranks}) != 1:
            raise AssertionError(f"{tag}: step {i}'s loss differs by rank")
    world = MD_MESH[0] * MD_MESH[1]
    for r in ranks:
        for cf in (f"{world}", "2"):
            m = r[f"moe_{cf}"]
            log(f"[{tag}] rank {r['rank']} MoE all-to-all (T "
                f"{MD_MOE_TOKENS}, d 1024, d_ff 512, 32 experts, top 8, "
                f"f32) at capacity factor {cf}: {m['dropped']} of "
                f"{m['assignments']} assignments dropped, |y - dense| "
                f"{m['err']:.3e} of its largest; all-to-all "
                f"{m['wire']['all-to-all']:.4e} bytes")
            if not m["finite"]:
                raise AssertionError(f"{tag}: MoE output not finite")
        if r[f"moe_{world}"]["dropped"] or \
                not r[f"moe_{world}"]["err"] <= MD_MOE_TOL:
            raise AssertionError(f"{tag}: the MoE exchange parts from the "
                                 f"dense combine")
    if not sum(r["moe_2"]["dropped"] for r in ranks):
        raise AssertionError(f"{tag}: no assignment dropped at capacity 2.0")
    log(f"[{tag}] seconds a rank by section: " + "; ".join(
        f"rank {r['rank']} " + ", ".join(
            f"{k} {v:.1f}" for k, v in r["section_s"].items())
        for r in ranks))
    problems = []
    for r in ranks:
        who = f"rank {r['rank']}"
        problems += md_check_moe(tag, who, r["moe_step"], moe)
        problems += md_check_serve(tag, who, r["serve"], MD_MESH)
        problems += md_check_families(tag, who, r["families"], MD_MESH)
    if problems:
        raise AssertionError(f"{tag}: {problems}")
    for key in ("moe_step", "serve"):
        got = [{k: res.get("metrics") or [c["err"] for c in res["calls"]]
                for k, res in r[key].items()} for r in ranks]
        if any(g != got[0] for g in got):
            raise AssertionError(f"{tag}: {key} differs by rank")
    got = [{arch: (f["train"]["loss"], [c["err"] for c in f["bf16"]["calls"]])
            for arch, f in r["families"].items()} for r in ranks]
    if any(g != got[0] for g in got):
        raise AssertionError(f"{tag}: a family's loss or logits differ by "
                             f"rank")
    r0 = ranks[0]
    counts = {k: sum(s["launches"][k] for s in r0["steps"])
              for k in r0["steps"][0]["launches"]}
    log(f"[{tag}] peak a rank over the phase (gpt3-xl, the MoE exchange, "
        f"granite, llama serving, the families): "
        + ", ".join(f"{r['peak_all_gib']:.2f}" for r in ranks) + " GiB")
    return {"launches": counts, "step_s": [s["s"] for s in r0["steps"]],
            "moe_launches": r0["moe_step"]["bf16"]["launches"],
            "serve_launches": r0["serve"]["bf16"]["launches"],
            "family_launches": {
                arch: {k: f["train"]["launches"][k]
                       + f["bf16"]["launches"][k]
                       for k in f["train"]["launches"]}
                for arch, f in r0["families"].items()}}


def _md_metrics(m) -> str:
    return ", ".join(f"{k} {m[k]:.6f}" for k in
                     ("loss", "ce_loss", "load_balance", "router_z",
                      "dropped_frac"))


def md_check_moe(tag, who, res, ref):
    """Log one rank's granite passes (:func:`md_moe_rank`), each against
    the unsharded step of its dtype, and return what the bf16 pass
    fails of its gates: the loss and the three aux terms within
    ``MD_LOSS_RTOL``, every gradient block within ``MD_GRAD_TOL``, pairs
    dropped, exact launches, and at most ``MD_MOE_FLIPS`` of the tokens
    with an own top-8 that differs from the held one, each a near tie
    (``MD_MOE_TIE``).  The passes with the
    routing free are logged, not gated."""
    L = MD_MOE_LAYERS
    per_step = {"rmsnorm": 4 * L + 1, "flash_prefill": 2 * L,
                "flash_bwd": L, "paged_decode": 0, "ssd_scan": 0}
    keys = ("loss", "ce_loss", "load_balance", "router_z", "dropped_frac")
    problems = []
    for name, r in res.items():
        dtype, held = MD_MOE_PASSES[name]
        want = ref[dtype]["metrics"]
        rel = {k: _rel(r["metrics"][k], want[k]) for k in keys}
        worst = max(r["grad_errs"], key=r["grad_errs"].get)
        log(f"[{tag}] {who} {MOE_ARCH} sharded step, {name} "
            f"({'the kernels' if dtype == 'bfloat16' else 'the plain path'}"
            f", its routing {'held to the unsharded step' if held else 'free'}"
            f"; {r['flips']} of {r['rows']} tokens' own top-8 differ from the "
            f"unsharded step's, at gaps between the 8th and 9th router "
            f"logits up to {r['gap']:.3e}, bounds {MD_MOE_FLIPS} of the "
            f"tokens and {MD_MOE_TIE}): "
            f"{_md_metrics(r['metrics'])}; against the unsharded step "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
            + f" (bound {MD_LOSS_RTOL}); gradient blocks within "
            f"{r['grad_errs'][worst]:.3e} of each leaf's largest |value| "
            f"(worst {worst}; bound {MD_GRAD_TOL}); {r['s']:.3f} s, "
            f"launches {r['launches']}; collective bytes " + ", ".join(
                f"{k} {v:.4e} ({r['wire_s'][k]:.3f} s)"
                for k, v in r["wire"].items() if v))
        if not held:
            continue
        if max(rel.values()) > MD_LOSS_RTOL or \
                r["grad_errs"][worst] > MD_GRAD_TOL or \
                not r["metrics"]["dropped_frac"] > 0 or \
                r["launches"] != per_step or not r["gap"] <= MD_MOE_TIE or \
                not r["flips"] <= MD_MOE_FLIPS * r["rows"]:
            problems.append(f"{who}'s sharded granite step ({name}) parts "
                            f"from the unsharded one, drops nothing, flips "
                            f"past a near tie, or launches {r['launches']} "
                            f"!= {per_step}")
    return problems


def md_check_serve(tag, who, res, mesh):
    """Log one rank's sharded serving (:func:`md_serve_rank`) and return
    what it fails of its gates: the bf16 run's finite logits within ``MD_SERVE_TOL`` of the unsharded
    ones at every call, every argmax equal but at a near tie, its exact
    launches (L flash prefills, 2 L + 1 RMSNorms a call) and each cache
    block a slice of the sequence."""
    seq = MD_SERVE_MAX_SEQ // mesh[1]
    problems = []
    for key, r in res.items():
        layers, _, _, steps = MD_SERVE_RUNS[key]
        tol = MD_SERVE_TOL
        for i, c in enumerate(r["calls"]):
            name = "prefill" if i == 0 else f"decode {i}"
            log(f"[{tag}] {who} llama3.2-1b {key} {name}: {c['s']:.3f} s; "
                f"logits within {c['err']:.3e} of the largest |logit| "
                f"(bound {tol}); argmax differs at {c['differ']} of "
                f"{MD_SERVE_SLOTS} rows ({c['far']} past a near tie); "
                f"collective bytes " + ", ".join(
                    f"{k} {v:.4e}" for k, v in c["wire"].items() if v))
        bad = [i for i, c in enumerate(r["calls"]) if not c["finite"]
               or not c["err"] <= tol or (key == "bf16" and c["far"])]
        log(f"[{tag}] {who} llama3.2-1b {key} served: launches "
            f"{r['launches']}; cache blocks {r['shapes']}")
        if bad or any(shape[2] != seq for shape in r["shapes"].values()):
            problems.append(f"{who}'s sharded serving ({key}) parts from "
                            f"the unsharded run at calls {bad}, or its "
                            f"cache is not a slice of {seq} positions")
        per_run = {"rmsnorm": (2 * layers + 1) * (steps + 1),
                   "flash_prefill": layers, "flash_bwd": 0,
                   "paged_decode": 0, "ssd_scan": 0}
        if key == "bf16" and r["launches"] != per_run:
            problems.append(f"{who}'s sharded serving launches "
                            f"{r['launches']} != {per_run}")
    return problems


def main_cards(cards: int) -> int:
    """``--cards 1`` or ``--cards 4``: the multidevice phase alone after
    the build, with granite's passes with the routing free logged (float32
    on the plain path, bf16 on the kernels): on one card as
    in the whole script, or gpt3-xl at its 24 layers trained as four nccl
    ranks, one a card; ends with the same last line as the whole
    script."""
    if cards not in (1, MD_MESH[0] * MD_MESH[1]):
        raise SystemExit(f"chip_smoke: --cards takes 1 or "
                         f"{MD_MESH[0] * MD_MESH[1]} (the (data, model) = "
                         f"{MD_MESH} mesh)")
    smi = phase_device()
    if torch.cuda.device_count() < cards:
        raise SystemExit(f"chip_smoke: --cards {cards} needs {cards} cards, "
                         f"not {torch.cuda.device_count()}")
    layers = MD_LAYERS if cards == 1 else MD_CARDS_LAYERS
    for name, fn, args in (("build", phase_build, ()),
                           ("multidevice", phase_multidevice,
                            (layers, cards, True))):
        t = time.perf_counter()
        fn(*args)
        log(f"[time] {name}: {time.perf_counter() - t:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--cards"]:
        return main_cards(int(sys.argv[2]))
    smi = phase_device()
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        log(f"[time] {name}: {seconds[name]:.1f} s")
        return out
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    cfg, model, params = build_full_model()
    serve = timed("serve", phase_serve, cfg, model, params)
    # graphs on only: the eager profile measured the graphs-on run's
    # kernels again, and the eager wall a step is the serve phase's
    # graphs-off run's
    timed("profile", phase_profile, cfg, model, params)
    timed("consistency", phase_consistency, model, params)
    dvfs = timed("dvfs", phase_dvfs, cfg, model, params)
    timed("serve_prefix", phase_serve_prefix, cfg, model, params)
    timed("wave", phase_wave, cfg, model, params)
    fleet = timed("fleet_migration", phase_fleet_migration, cfg, model,
                  params)
    del model, params
    release()
    timed("fleet_launcher", phase_fleet_launcher)
    examples = timed("examples", phase_examples, dvfs["idle_w"])
    cfg, model, params = timed("build_gpt3", build_full_model, "gpt3-xl")
    serve_gpt3 = timed("serve_gpt3", phase_serve_gpt3, cfg, model, params)
    timed("consistency_gpt3", phase_consistency_gpt3, model, params)
    del model, params
    release()
    train_gpt3 = timed("train_gpt3", phase_train_gpt3)["counts"]
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    gpt3 = build_model(get_config("gpt3-xl"), device="cuda")
    dvfs_gpt3 = timed("dvfs_gpt3", phase_dvfs_gpt3, dvfs["idle_w"], gpt3)
    rank_gpt3 = timed("transfer_gpt3", phase_transfer_gpt3, dvfs["idle_w"],
                      gpt3, dvfs_gpt3)["launches"]
    del gpt3
    release()
    md = timed("multidevice", phase_multidevice)
    cfg, model, params = timed("build_llama3b", build_full_model,
                               "llama3.2-3b")
    serve_llama3b = timed("serve_llama3b", phase_serve_llama3b, cfg, model,
                          params)
    timed("consistency_llama3b", phase_consistency_llama3b, model, params)
    del model, params
    release()
    train_llama3b = timed("train_llama3b", phase_train_llama3b)["counts"]
    cfg, model, params = timed("build_moe", build_full_model, MOE_ARCH)
    serve_moe = timed("serve_moe", phase_serve_moe, cfg, model, params)
    timed("consistency_moe", phase_consistency_moe, model, params)
    del model, params
    release()
    timed("train_moe", phase_train_moe)
    cfg, model, params = timed("build_vlm", build_full_model, VLM_ARCH)
    serve_vlm = timed("serve_vlm", phase_serve_vlm, cfg, model, params)
    timed("consistency_vlm", phase_consistency_vlm, model, params)
    del model, params
    release()
    train_vlm = timed("train_vlm", phase_train_vlm)["counts"]
    cfg, model, params = timed("build_yi", build_full_model, YI_ARCH,
                               YI_SERVE_LAYERS)
    serve_yi = timed("serve_yi", phase_serve_yi, cfg, model, params)
    timed("consistency_yi", phase_consistency_yi, model, params)
    del model, params
    release()
    cfg, model, params = timed("build_encdec", build_full_model, ENCDEC_ARCH)
    serve_encdec = timed("serve_encdec", phase_serve_encdec, cfg, model,
                         params)
    timed("consistency_encdec", phase_consistency_encdec, model, params)
    del model, params
    release()
    train_encdec = timed("train_encdec", phase_train_encdec)["counts"]
    cfg, model, params = build_mamba_model()
    serve_ssm = timed("serve_ssm", phase_serve_ssm, cfg, model, params)
    timed("consistency_ssm", phase_consistency_ssm, model, params)
    fleet_ssm = timed("fleet_ssm", phase_fleet_ssm, cfg, model, params)
    del model, params
    release()
    train = timed("train", phase_train)
    timed("trainer", phase_trainer)
    release()
    cfg, model, params = timed("build_hybrid", build_hybrid_model)
    hybrid = timed("serve_hybrid", phase_serve_hybrid, cfg, model, params)
    timed("consistency_hybrid", phase_consistency_hybrid, model, params)
    del model, params
    release()
    ssd_bwd = timed("ssd_grads", phase_ssd_grads)
    timed("train_ssm", phase_train_ssm, ssd_bwd["mamba2-370m"])
    train_hybrid = timed("train_hybrid", phase_train_hybrid,
                         ssd_bwd["zamba2-7b"])["counts"]
    cfg, model, params = timed("build_llama4", build_full_model, LLAMA4_ARCH,
                               LLAMA4_SERVE_LAYERS)
    serve_llama4 = timed("serve_llama4", phase_serve_llama4, cfg, model,
                         params)
    long_llama4 = timed("serve_llama4_long", phase_serve_llama4_long, cfg,
                        model, params)
    timed("consistency_llama4", phase_consistency_llama4, model, params)
    del model, params
    release()
    timed("consistency_llama4_f32", phase_consistency_llama4_f32)
    train_llama4 = timed("train_llama4_smoke", phase_train_smoke,
                         LLAMA4_ARCH)["counts"]
    cfg, model, params = timed("build_nemotron", build_full_model, NEMO_ARCH,
                               NEMO_SERVE_LAYERS)
    serve_nemo = timed("serve_nemotron", phase_serve_nemotron, cfg, model,
                       params)
    timed("consistency_nemotron", phase_consistency_nemotron, model, params)
    del model, params
    release()
    timed("train_nemotron_smoke", phase_train_smoke, NEMO_ARCH)
    # each kernel's launches on the path it serves: paged decode's in one
    # serve run of its page type, the serving prefill's in a bf16-page run,
    # the others' in the training run (the forward with its log-sum-exp
    # counts as flash_prefill); zamba2-7b's instantiations in one of its
    # serve runs (RMSNorm: both widths, 82 a forward at d 3584 and 109 at
    # 7168, counted from the code), its flash backward in its training run
    for row in rows:
        name, _, tag = row["name"].partition("[")
        tag = tag.rstrip("]")
        if row.get("model") == "gpt3-xl":
            run = GPT3_ROW_RUNS[row["name"]]
            name = name.removesuffix("_lse")
            if run == "train":
                row["launches"] = train_gpt3[name]
                row["launches_of"] = (f"one gpt3-xl training run, "
                                      f"{TRAIN_STEPS} steps of {GPT3_BATCH} "
                                      f"x {TRAIN_SEQ} tokens")
            elif run == "tp":
                row["launches"] = md["launches"][name]
                row["launches_of"] = (
                    f"rank 0 of the (data, model) = {MD_MESH} gloo ranks' "
                    f"gpt3-xl run at {MD_LAYERS} layers, {MD_STEPS} sharded "
                    f"steps of {MD_BATCH // MD_MESH[0]} x {TRAIN_SEQ} tokens "
                    f"and {GPT3_ATTN['H'] // MD_MESH[1]} heads a rank")
            elif run == "rank":
                row["launches"] = rank_gpt3[name]
                row["launches_of"] = (f"one gpt3-xl dp-{GPT3_RANK_DP} rank's "
                                      f"Trainer run behind the transferred "
                                      f"plan, {GPT3_RANK_STEPS} steps of "
                                      f"{GPT3_BATCH // GPT3_RANK_DP} x "
                                      f"{TRAIN_SEQ} tokens")
            else:
                row["launches"] = serve_gpt3[run][name]
                row["launches_of"] = (f"one gpt3-xl serve run, "
                                      f"{pages_of(run)}, "
                                      f"CUDA graphs")
        elif row.get("model") == "multidevice":
            run = MD_ROW_RUNS[row["name"]]
            name = name.removesuffix("_lse")
            if run == "moe":
                row["launches"] = md["moe_launches"][name]
                row["launches_of"] = (
                    f"rank 0 of the (data, model) = {MD_MESH} gloo ranks' "
                    f"{MOE_ARCH} sharded step at {MD_MOE_LAYERS} layers, "
                    f"{MD_BATCH // MD_MESH[0]} x {TRAIN_SEQ} tokens and 16 "
                    f"of 32 experts a rank (bf16, the kernels)")
            elif run == "serve":
                row["launches"] = md["serve_launches"][name]
                row["launches_of"] = (
                    f"rank 0 of the (data, model) = {MD_MESH} gloo ranks' "
                    f"llama3.2-1b sharded serving at {MD_SERVE_LAYERS} "
                    f"layers: the prefill of {MD_SERVE_SLOTS // MD_MESH[0]}"
                    f" prompts of {MD_SERVE_PROMPT} tokens and "
                    f"{MD_SERVE_STEPS} context-parallel decode steps")
            else:
                sp = MD_FAMILIES[run]
                row["launches"] = md["family_launches"][run][name]
                row["launches_of"] = (
                    f"rank 0 of the (data, model) = {MD_MESH} gloo ranks' "
                    f"{run} at {sp['layers']} layers: one sharded train "
                    f"step of {sp['train'][0] // MD_MESH[0]} x "
                    f"{sp['train'][1]} tokens, then the bf16 prefill of "
                    f"{sp['slots'] // MD_MESH[0]} prompts of {sp['prompt']}"
                    f" tokens and {sp['steps']} decode steps")
        elif row.get("model") == "llama3.2-3b":
            run = LLAMA3B_ROW_RUNS[row["name"]]
            name = name.removesuffix("_lse")
            if run == "train":
                row["launches"] = train_llama3b[name]
                row["launches_of"] = (f"one llama3.2-3b training run at "
                                      f"{LLAMA3B_TRAIN_LAYERS} layers, "
                                      f"{TRAIN_STEPS} steps of "
                                      f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens")
            else:
                row["launches"] = serve_llama3b[run][name]
                row["launches_of"] = (f"one llama3.2-3b serve run, "
                                      f"{pages_of(run)}"
                                      f", CUDA graphs")
        elif row.get("model") == VLM_ARCH:
            run = VLM_ROW_RUNS[row["name"]]
            name = name.removesuffix("_lse")
            if run == "train":
                row["launches"] = train_vlm[name]
                row["launches_of"] = (f"one {VLM_ARCH} training run, "
                                      f"{TRAIN_STEPS} steps of {TRAIN_BATCH}"
                                      f" x ({VLM_PREFIX} patch rows + "
                                      f"{TRAIN_SEQ - VLM_PREFIX} tokens)")
            else:
                row["launches"] = serve_vlm[run][name]
                row["launches_of"] = (f"one {VLM_ARCH} serve run, "
                                      f"{pages_of(run)}"
                                      f", CUDA graphs, half the "
                                      f"requests behind {VLM_PREFIX} patch "
                                      f"rows")
        elif row.get("model") == ENCDEC_ARCH:
            run = ENCDEC_ROW_RUNS[row["name"]]
            name = name.removesuffix("_lse")
            if run == "train":
                row["launches"] = train_encdec[name]
                row["launches_of"] = (f"one {ENCDEC_ARCH} training run, "
                                      f"{TRAIN_STEPS} steps of {TRAIN_BATCH}"
                                      f" x ({ENCDEC_FRAMES} frames + "
                                      f"{ENCDEC_TEXT} tokens)")
            else:
                row["launches"] = serve_encdec[run][name]
                row["launches_of"] = (f"one {ENCDEC_ARCH} serve run, "
                                      f"{pages_of(run)}"
                                      f", CUDA graphs, each request "
                                      f"with {ENCDEC_FRAMES} frames")
        elif row.get("model") == LLAMA4_ARCH:
            run = LLAMA4_ROW_RUNS[row["name"]]
            if run == "train":
                row["launches"] = train_llama4[name]
                row["launches_of"] = (f"one training run of {LLAMA4_ARCH}'s "
                                      f"card smoke config (its local layer "
                                      f"at window 32), {TRAIN_STEPS} steps "
                                      f"of {TRAIN_BATCH} x {TRAIN_SEQ} "
                                      f"tokens")
            elif run == "long":
                row["launches"] = long_llama4[name]
                row["launches_of"] = (f"one {LLAMA4_ARCH} long-traffic serve "
                                      f"run at {LLAMA4_SERVE_LAYERS} layers "
                                      f"(prompts of {list(LONG_PROMPTS)} "
                                      f"tokens, buckets 8192 and "
                                      f"{LONG_MAX_SEQ}), bf16 pages, CUDA "
                                      f"graphs")
            else:
                row["launches"] = serve_llama4[run][name]
                row["launches_of"] = (f"one {LLAMA4_ARCH} serve run at "
                                      f"{LLAMA4_SERVE_LAYERS} layers, "
                                      f"{pages_of(run)}"
                                      f", CUDA graphs")
        elif row.get("model") == NEMO_ARCH:
            run = NEMO_ROW_RUNS[row["name"]]
            row["launches"] = serve_nemo[run][name]
            row["launches_of"] = (f"one {NEMO_ARCH} serve run at "
                                  f"{NEMO_SERVE_LAYERS} layers, "
                                  f"{pages_of(run)}, "
                                  f"CUDA graphs")
        elif row.get("model") == YI_ARCH:
            run = YI_ROW_RUNS[row["name"]]
            row["launches"] = serve_yi[run][name]
            row["launches_of"] = (f"one {YI_ARCH} serve run, {pages_of(run)}, "
                                  f"CUDA graphs")
        elif row["name"] == "paged_decode[D64G2 bf16]":
            row["launches"] = serve_moe["bf16"][name]
            row["launches_of"] = ("one granite-moe-1b-a400m serve run at "
                                  "full width, bf16 pages, CUDA graphs (the "
                                  "serve launcher with --smoke launched "
                                  f"{dvfs['smoke_launches'][name]})")
        elif row["name"] == "flash_bwd[D224]":
            row["launches"] = train_hybrid[name]
            row["launches_of"] = (f"one zamba2-7b training run at "
                                  f"{HYBRID_TRAIN_LAYERS} layers, "
                                  f"{TRAIN_STEPS} steps")
        elif row.get("model") == "zamba2-7b":
            run = HYBRID_ROW_RUNS[row["name"]]
            row["launches"] = hybrid[run][name]
            row["launches_of"] = (f"one zamba2-7b serve run, {pages_of(run)}, "
                                  f"CUDA graphs"
                                  + (" (both widths)" if name == "rmsnorm"
                                     else ""))
        elif name == "paged_decode":
            row["launches"] = serve[tag][name]
            row["launches_of"] = (
                f"one serve run, {tag} pages, CUDA graphs (the fleet "
                f"phase's migrated decode: {fleet[tag]['decode'][name]} "
                f"eager, {fleet[tag]['replay'][name]} in the graph replay "
                f"over the spliced pages)")
        elif name == "ssd_scan":
            row["launches"] = serve_ssm[name]
            row["launches_of"] = (
                f"one mamba2-370m serve run, dense cache, CUDA graphs (the "
                f"fleet phase's source prefill before the migration: "
                f"{fleet_ssm['prefill'][name]})")
        elif name == "flash_prefill":
            row["launches"] = serve["bf16"][name]
            row["launches_of"] = (
                f"one serve run, bf16 pages, CUDA graphs (the fleet phase's "
                f"source prefill before the migration: "
                f"{fleet['bf16']['prefill'][name]})")
        else:
            name = name.removesuffix("_lse")
            row["launches"] = train[name]
            row["launches_of"] = (f"one training run, {TRAIN_STEPS} steps "
                                  f"(one serve run: {serve['bf16'][name]}; "
                                  f"the fleet phase's migrated decode: "
                                  f"{fleet['bf16']['decode'][name]})"
                                  if name == "rmsnorm" else
                                  f"one training run, {TRAIN_STEPS} steps")
        if row["name"] in EXAMPLE_ROWS:
            ex, name = EXAMPLE_ROWS[row["name"]]
            row["example_launches"] = {ex: examples[ex][name]}
            row["launches_of"] += (f"; the examples phase's {ex}: "
                                   f"{examples[ex][name]}")
        row["kernel_ms"] = row["ms"]
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} never ran on the main path")
    log(f"[done] {time.perf_counter() - t0:.1f} s after the device check "
        f"({', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}); card "
        f"{smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
