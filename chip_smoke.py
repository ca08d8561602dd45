#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root, on a machine with a Hopper card and the CUDA
toolkit:

    python3 chip_smoke.py

1. Builds every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
   library, all started together) and prints the build time: the serve
   path's libraries (FIRST_LIBRARIES) are waited for, the others compile
   at a lower CPU priority behind the serve, graphs, paged and legacy
   lines (3, 4 and 10 below) and are waited for after them.
2. Kernel phase (after the legacy lines): at the full-width shapes of W2A2
   ``stablelm-1.6b`` serving, holds each LM kernel against its plain PyTorch
   version on the card (quantize-pack bit-equal on f32, bf16 and f16
   activations, and the packed matmul bit-equal -- K2 on the tensor cores at
   the decode and prefill rows, a second launch and three calls in a row
   bit-equal; the serving path's call, K1 folded into the tensor-core K2 on
   bf16 activations (``quantized_linear_mma``, route ``fused-quant``),
   bit-equal to the cast + K1 + K2-affine route it replaced and to the plain
   version and timed beside that route; ``ops.quantized_linear`` one fused
   launch, bit-equal to the eager epilogue and to K1 + K2 (``fused-epilogue``
   line); the same call over the bit-dense weight store
   (``quantized_linear_mma_dense``, route ``fused-quant-dense``: the words
   expanded in the tensor-core K2's staging) at the six K2 shapes at W2A2 and
   at (4, 1024, 2048) W1A1, bit-equal to its plain version and to the lanes
   route and timed beside it; the CUDA-core K2 (on no route) at its earlier
   int16xP2s8 rows; K2 at every other layout (``int8xP2s4``, ``int16xP4s4``,
   ``int32xP2s8``, ``int32xP4s8``, ``int32xP2s16`` at W2A2 and W4A4) on the
   tensor cores at (4, 1024, 2048) and (64, 1024, 5632) in lattice K 2048:
   lanes in, bit-equal to the plain version and to the CUDA-core K2, whose time
   ``core_ms`` the row carries, and the fused call on bf16 x over lanes and the
   dense store, bit-equal to the plain version and to the route it replaced
   (K1, the CUDA-core K2 and the eager epilogue: ``old_route_ms``); attention
   within 1e-4 with f32 queries and within 1e-4 + one bf16 ulp with the path's
   bf16 queries, with a dead row exactly zero and a second launch bit-equal to
   the first, at stablelm-1.6b's heads and at granite-3-8b's grouping (32 query
   heads on 8 kv heads of 128); the paged attention (K4) through a scrambled
   block table, also bit-equal to the contiguous kernel (K3) on the same
   logical rows; the unpacked integer matmul (K7) bit-equal at s8 and s16; the
   KV-cache window write (``csrc/cache_write.cu``) bit-equal to its plain twin
   at kv_bits 16/8/4/2, ragged and paged, with dead rows, decode riders,
   windows past the end and dead slots' all-zero block tables, page 0 left
   untouched, timed at the decode step's write beside ``index_put_`` on each
   leaf); then the packed conv (K5) and the int16 conv (K6), bit-equal, every
   row on the tensor cores with a second launch bit-equal and the CUDA-core
   tile (on no route) bit-equal and timed on the same operands (``cores_ms``):
   the paper's Fig. 4 shape (K6 at int16 values in [-256, 256) and at the full
   int16 range, where the sums wrap; K5 at every case, int8xP2s4 included), the
   Fig. 4 conv at 64 (K6) and 128 (K5 W2A2) channels and ResNet-18's conv4_x
   shape (3x3 256 -> 256 at batch 64 on 14 x 14: K6 int16, K5 W2A2 and W4A4
   int32xP2s16), whose K the kernels take in channel chunks, and the full-width
   ``sparq-cnn`` layers (K5 at int16xP2s8, lanes and dense, and the widest
   layer at W4A4 int32xP2s16); K5's fused epilogue bit-equal to
   ``cnn.conv_epilogue`` and timed.  It times the kernel, the plain version and
   one PyTorch call that computes the same function where there is one (K5:
   ``F.conv2d`` on the f32 lattices with TF32 off, held equal once rounded, and
   with TF32 allowed where that is exact; K6: ``F.conv2d`` in f64, also held
   equal once rounded and wrapped) (CUDA-graph replay between CUDA events,
   median of repeats, inputs rotated over copies larger than the 50 MB L2 where
   the path reads them cold). ``bound_ms`` is the least time the card could
   take: the larger of the bytes moved over HBM bandwidth and the operations
   over the peak rate of the card's fastest unit for them (int8 tensor cores
   for the lattice dots and K7's s8 products -- s16 as four int8 products per
   MAC -- and bf16 tensor cores for attention's products). ``design_bound_ms``
   takes the rate of the unit each kernel runs on: the int8 tensor cores for K7
   and the tensor-core K2, K5 and K6 (the MMAs they issue), f32 CUDA cores for
   the CUDA-core K2 and K3/K4, the 32-bit integer multiply-add rate for the
   CUDA-core K5 and K6.
3. Serve phase: full-width ``stablelm-1.6b`` W2A2 with random weights from a
   seed, through ``ServingEngine`` at kv_bits 16, 4 and 2, four greedy
   requests with staggered admission; each engine replays the decode and
   prefill-chunk CUDA graphs it captured when it was built, so every
   kernel count below is the graphs' launches times their replays (plus
   the warm-up's).  Fails unless every request finishes
   and every kernel was launched on that path with no plain-version call,
   every packed linear one launch of the tensor-core K2 with K1 folded in
   and the epilogue fused (no standalone K1 launch).  At
   kv_bits 4 it profiles four decode passes and one 64-row prefill chunk
   (device kernel time, launches, K2 / elementwise / fill time, top
   kernels, the graph's replay between CUDA events; the prefill chunk
   also on the eager pair) and runs one prefill chunk and 8 decode steps
   with ``backend="torch"`` on the same weights, printing the logit
   difference.  Then the ``graphs`` lines: graphed against eager engines
   at kv_bits 16, 4, 2 and paged at 4 with prefix sharing (tokens equal,
   the first decode's logit difference, pointers fixed, capture time,
   peak memory, 2 rounds of 8 decode passes of each in turn: wall ms a
   step, device ms, idle share).
4. Paged serve phase: the same model and weights through
   ``ServingEngine(EngineConfig(paged=True, page_size=16))``.  Identity at
   kv_bits 16, 4 and 2: shared-prefix prompts (a 72-token prompt, then a
   64-token match plus 20 others, an unrelated prompt and an 80-token
   prompt whose partial-tail match forces a copy-on-write), greedy tokens
   equal to the unpaged engine's on the same requests.  Capacity at
   kv_bits 4: a budget of 4 unpaged slots buys 128 pages; a 384-token
   prefix warmed once, then 16 requests sharing it run at once (at least
   8 live slots, twice the unpaged engine's), tokens equal to an unpaged
   engine with 16 slots.  A ``paged`` line per run, a ``paged profile``
   line of four kv_bits-4 decode passes.  Fails unless every paged read
   launched K4, with no plain call and no K3 launch, and every packed
   linear was one fused launch (no standalone K1).
   Then the ``dense`` line: the serve phase's requests at kv_bits 4 on a
   graphed engine with ``dense_store=True`` and on one with lanes --
   greedy tokens equal and the first decode's logits bit-equal (gated),
   every packed linear one launch of the dense route, the packed param
   bytes of both, device ms of a decode pass and of K2 in it, the two
   engines profiled in turn.  Then the ``spec`` lines: speculative
   decoding at kv_bits 4, k = 4, with a W2 draft in lanes, a W1 draft over
   the dense store, and paged with a shared prefix (the first-token
   stash), each against the plain graphed engine of the same config:
   tokens gated (a divergence from plain decode fails unless the plain
   top-2 margin there is at most 2 x the difference of the rows that chose
   the tokens; ``verify_vs_decode_max_diff`` over the teacher-forced
   verify rows), the draft's writes inside each slot's reserved extent,
   the draft pool drained, pointers fixed, every step a graph replay of
   the hand-written kernels; acceptance, cycles, decode tok/s against
   plain (two alternated rounds), wall ms a cycle, the draft and verify
   graphs' replay ms and device ms by kernel group, capture s, peak
   memory, the draft's param bytes, launches a cycle; then a failed draft
   capture must raise (reduced config).
5. Linear phase: ``benchmarks/serve_microbench.run_linear`` on the card at
   m = 8, k = n = 4096: bf16 ``torch.matmul``, int8 through
   ``ops.int_matmul`` (K7 launched, no plain call), packed W1A1 / W2A2 /
   W3A3 on ``int16xP2s8`` and W2A2 / W4A4 on ``int32xP2s16`` through
   ``ops.quantized_linear`` (one launch of the tensor-core K2 with K1
   folded in), the W2A2 lattice dot on ``int16xP2s8`` and the W4A4 one on
   ``int32xP2s16``, lanes and dense (K1 and the tensor-core K2's lanes-in
   routes: their path); a ``linear`` line with each time and the weight
   bytes.
6. Fig. 4 phase: the int16 conv, the int16 conv at 64 channels, each
   packed case, the W2A2 case at 128 channels and the conv4_x rows once
   through ``ops.int_conv2d`` / ``ops.packed_conv2d`` (only the
   tensor-core K5 and K6 launched, no CUDA-core launch, no plain call),
   and a ``fig4`` line with each packed time, the int16 time and their
   ratio on the tensor cores beside the paper's, as a second column the
   CUDA-core K5's ratio over the CUDA-core K6, and the chunked rows.
7. CNN phase: full-width ``sparq-cnn`` W2A2 (random weights from a seed),
   weights prepared and plans built once, classifying 4 batches of 8
   random 256x256x3 images through ``cnn.forward(quant_mode="packed")``
   with the lanes store, then the dense store: ms per batch, images/s,
   profiled device time, launches, K5's share and top kernels, peak
   memory.  Fails unless the tensor-core K5 with the fused epilogue ran
   every packed layer, with no CUDA-core K5 launch and no plain-version
   call.  Then two images with ``backend="torch"`` on the same weights:
   every layer's int32 accumulator bit-equal, every layer's fused output
   bit-equal to ``conv_epilogue`` on the plain path (``cnn
   fused-epilogue``), and the logit difference.

8. Training phase: full-width ``stablelm-1.6b`` W2A2 with its config's
   remat='block' and two microbatches, batch 4 x 128 from
   ``SyntheticLMStream(seed=0)``, a cosine schedule with a 2-step warm-up,
   4 eager train steps from seed-0 params (``launch/steps.
   make_train_step``: fake-quant forward and backward, AdamW with f32
   moments): a ``train`` line (per step loss, ce, grad_norm, lr, ms; the
   median step, tokens/s, peak memory, the model-FLOP share 6 x params x
   tokens / step s over the bf16 dense peak; gated: every loss and
   gradient norm finite), then a ``train profile`` line of one more step
   (device ms and launches by kernel name and by the port's profiler
   ranges: fake quant, attention, optimizer).  The ``train-serve`` line:
   the 24-layer trained params through a sync save and the checkpoint
   reader (byte-equal, gated), packed and served graphed on the serve
   phase's four requests at kv_bits 4 (tokens equal to those served from
   the in-memory params, every packed linear one fused K2 launch and every
   read K3: gated), the packed first-decode logits against the QAT
   forward's (reported).  Two ``train-ckpt`` lines: the ``Trainer`` at
   full width cut to 1 layer (depth only: the full state is ~26 GB on
   disk), f32 and 8-bit moments: a checkpoint written, a crash and a
   resume against a straight run under ``torch.use_deterministic_
   algorithms(True)`` (the restored state byte-equal to the saved one and
   the resumed params equal to the straight run's: gated), save / restore
   s and bytes.  The ``cnn-qat`` line: full-width ``sparq-cnn`` W2A2
   QAT-trained on the synthetic template task at 256x256x3, batch 8, 300
   steps (``repro_torch.examples.train_cnn_qat``): float, QAT and
   packed-integer accuracy on 64 held-out images and ms a train step;
   gated: the packed evaluation runs the fused tensor-core K5 on every
   layer, then ``cnn fused-epilogue`` and ``cnn kernel-vs-plain`` again on
   the trained params.  The trained LM's engine and the trained CNN's
   packed evaluation add to K2's, K3's and K5's launches.

9. Autotune phase (``kernels/autotune.py``), after every other phase:
   from its start the script points ``REPRO_TORCH_AUTOTUNE_CACHE`` at
   ``build/autotune/cache.json``, so every earlier phase plans from an
   empty cache.  An ``autotune`` line a tuned signature: the fused K2 at
   stablelm's six K2 shapes, K3 at B4 S512 H32 hd64 C1 for kv 16, 4 and 2
   and C16 at kv 4, K4 at the paged phase's pages adopting K3's entry
   (both plans tuned, one geometry, K4 bit-equal to K3 at it), K5 at
   sparq-cnn's 32->32 and 32->64 layers, the layout sweep at stablelm's
   three W2A2 (k, n) and sparq-cnn's 32->64 conv: key, candidates,
   ``heuristic_us``, ``wall_us``, both geometries; gated: every candidate
   bit-equal to the plain version (K3: within ATTN_TOL, and the winner's
   largest difference too).  The ``autotune cli`` line: ``python -m
   repro_torch.launch.serve`` at full width with ``--autotune --metrics``
   on an empty cache, then without ``--autotune`` (gated: both exit 0,
   the second tunes nothing, leaves the file as it was, and plans every
   K2 ``source: tuned``).  The ``autotune serve`` line: graphed kv 4
   engines on the tuned cache and on an empty one serve the serve phase's
   requests (tokens gated under the ``spec`` lines' rule), the first
   decode's logit difference and the device ms of a decode pass and a
   64-row prefill chunk of each, alternated over 5 rounds.

10. The legacy read and the sliding-window MoE decoder.  After the paged
   phase, the ``legacy`` lines: the legacy read (``REPRO_FUSED_DECODE=0``:
   the stored cache dequantized per q-chunk of ``chunked_attention``)
   against K3 and K4 on one cache at stablelm's heads, kv 16 / 4 / 2
   (``legacy read``: within ATTN_TOL with f32 queries, gated; ms of each
   read at bf16 queries), then full-width stablelm engines with each read,
   contiguous and paged (tokens gated under the ``spec`` lines' rule, the
   logit difference, decode replay ms; no K3/K4 launch under the switch,
   gated).  After the speculative phase, the ``moe serve`` lines:
   mixtral-8x7b at full width (d_model 4096, 32 heads on 8 kv heads of
   128, d_ff 14336, 8 experts top-2, vocab 32000, window 4096) cut to 4 of
   its 32 layers, W2A2 int16xP2s8, seed-0 weights, ``EngineConfig(
   max_batch=4, max_len=512)`` (chunk clamped to 1), kv 16 and 4, the
   serve prompts cut to 16 tokens with 8 new tokens each, graphed,
   against an engine on
   ``backend='torch'``, every engine over one tree prepared once, where
   the experts' LSQ lattices are derived (tokens equal, gated; every
   packed linear one fused K2 launch, gated; no K3 launch, gated): decode
   ms wall and replayed,
   idle share, the graph's device ms by kernel group and an eager pass's
   by the port's ranges (fake quant, expert GEMMs, dispatch, combine,
   legacy attention), peak memory, param bytes.  The ``moe ring`` line:
   the same model at B1 and kv 4, the fake-quant prefill of a 4,160-token
   prompt into the 4,096-slot ring (the roll), then 8 graphed decode steps
   past the wrap against ``backend='torch'`` (greedy tokens equal, gated;
   the logit difference).  The ``moe reduced`` line: reduced mixtral-8x22b
   through the graphed engine and on ``'torch'``, tokens equal (gated).
   The ``moe 8x22b`` lines: the fused K2 at mixtral-8x22b's linears
   (6144 -> 6144 and 6144 -> 1024 at 4 and 64 rows, bit-equal, gated, and
   timed), then mixtral-8x22b at full width (d_model 6144, 48 heads on 8
   kv heads of 128, d_ff 16384, 8 experts top-2, vocab 32768, window 4096)
   cut to 14 of its 56 layers (memory: 69.7 GB), built a layer at a time,
   kv 4, as the moe serve lines serve (tokens equal to ``'torch'``, gated;
   4 fused K2 launches a layer a pass and no K3, gated; both graphs,
   gated): device ms by kernel group and range, wall and replay ms, idle
   share, the build's peak and seconds, param and expert bytes.

11. The recurrent families.  The ``recurrent k2`` lines: the serving
   path's fused K2 (K1 folded in) at the packed-linear shapes of mamba
   (in_proj 8192 -> 32768, out_proj 16384 -> 8192, x_proj 16384 -> 544),
   the mLSTM (up 2048 -> 8192, q/k/v 4096 -> 4096, down 4096 -> 2048) and
   the sLSTM FFN (2048 -> 5460, 2730 -> 2048), at 4 and 64 rows, bit-equal
   to K1 + K2 and the plain version (gated) and timed.  The ``recurrent
   serve`` lines: xlstm-1.3b at full width and depth (48 layers, 42 mLSTM
   and 6 sLSTM, d_model 2048, 4 heads, vocab 50304) and
   jamba-1.5-large-398b at full width (d_model 8192, d_inner 16384, 64
   heads on 8 kv heads of 128, d_ff 24576, 16 experts top-2, vocab 65536)
   cut to its first 5 of 72 layers at kv 4, W2A2 int16xP2s8, seed-0
   weights built a layer at a time (``build_packed_params``: jamba's float
   tree and its experts' lattices do not fit the card together),
   ``EngineConfig(max_batch=4, max_len=512, prefill_chunk=16)``,
   the serve prompts and two more (six requests through four slots, so two
   slots are reset and reused), 4 new tokens each,
   graphed, against an engine on ``backend='torch'``: tokens equal (gated),
   every packed linear one fused K2 launch (gated), xlstm's logits equal
   over every decode pass (gated), jamba's K3 launched on every pass
   (gated); decode ms wall and replayed, idle share, the graph's device ms
   by kernel group, an eager pass's by the port's ranges (fake quant, the
   mamba scan, mLSTM, sLSTM, the MoE's), param bytes, cache bytes a slot,
   the build's peak and the serving peak above the params.  The
   ``recurrent reduced`` lines: reduced jamba contiguous and paged and
   reduced xlstm, graphed against ``'torch'``, tokens equal (gated).

12. The replica fleet and tensor-parallel serving (after the multimodal
   lines).  ``fleet k2``: the fused K2 at stablelm's shapes split over two
   shards (q/k/v/o 2048 -> 1024, gate/up 2048 -> 2816, down 5632 ->
   1024) at 4 and 64 rows, bit-equal (gated) and timed.  ``fleet k3``:
   K3 and K4 at one shard's heads (stablelm's H16 KVH16 hd64 at kv 4 and
   2, qwen2-vl's H6 KVH1 hd128 at kv 4) within ATTN_TOL of their plain
   versions, K4 bit-equal to K3, and the window write at both shards'
   heads bit-equal to its plain twin (each gated), timed.  ``fleet
   router``: full-width stablelm (kv 4, ``EngineConfig(max_batch=4,
   max_len=512, prefill_chunk=16)``) behind ``Router(replicas=2)``, two
   graphed engines, eight seeded requests (prompts 17-100 tokens, 8 new,
   two sampled at a seeded temperature, two in one session): tokens equal
   to one engine serving them (gated), placements, spillover, the summed
   per-replica decode tok/s beside the wall-clock tok/s, each replica's
   build and capture seconds and memory.  ``fleet paged``: a paged fleet
   serves the shared-prefix prompt on replica 0, drains it to a scratch
   checkpoint and restores it: its cached prefix pages survive, it
   prefix-hits, its tokens equal a never-drained engine's and the drain
   frees the replica's memory (each gated); bytes written, drain, save,
   read and re-capture seconds.  ``fleet shard``: the engine with two
   shards on the card (``ServingMesh([[cuda:0, cuda:0]])``) against one
   shard, stablelm at kv 4, kv 2 and paged kv 4 and qwen2-vl-2b (one kv
   head a shard) at kv 4: tokens and every decode pass's logits equal
   (gated: the largest decode logit difference 0.0, since the split is
   exact), each decode graph's K2 and read launches and device
   ms, the shards' K2 shapes and kv heads, the param bytes a shard
   against the one-shard total (gated: each shard its half of the split
   leaves plus the whole ones), and for stablelm unpaged the bytes the
   shard joins of one eager decode pass move
   (``roofline/analysis.join_bytes``).  The ``fig4`` line also carries
   the reference's instruction model (``core/vmacsr.py``): native
   ULPPACK's, ``vmacsr``'s and the int16 baseline's instruction counts
   over K = Fh * Fw * Cin and the speedups they model.

13. The last modules (after the ``cnn-qat`` line).  ``roofline``: the
   constants ``roofline/hw.py`` picks for the card's name, and the dry
   run (``launch/dryrun.py``: shape-only arguments placed by the training
   rules of ``parallel/sharding.py``, not lowered) of stablelm-1.6b x
   train_4k and x decode_32k on the 16x16 production mesh.  ``collective
   matmul``: ``parallel/collectives.all_gather_matmul`` on a two-shard
   ``model`` row of the card at stablelm's down projection (x [512, 5632]
   bf16 split on K, w [5632, 2048]) against one ``torch.matmul`` (gated
   within AGM_ULP an element), ms of each.  ``pipeline``: full-width
   stablelm's 24 packed serving blocks as 2 stages of 12 over a mesh
   listing the card twice on ``pod``, 4 microbatches of 128 positions
   through ``parallel/pipeline.gpipe`` (gated: bit-equal to the blocks in
   sequence, 4 x 24 x 7 K2 launches, no plain call; they add to K2's
   launches), ``bubble_fraction`` and the ms of both passes.  ``train
   compress``: the ``train`` cell with int8-compressed gradients and
   error feedback (gated: every loss finite, step 1's decompressed
   gradients and residuals of the embedding, one attention q and one MLP
   down bit-equal to the CPU's), per step loss and grad norm beside the
   ``train`` line's, the median step, the residual bytes, peak memory,
   the ``grad_compress`` range's device and host ms.

``python3 chip_smoke.py --k2-sweep`` builds the kernels and runs only the
tensor-core K2's split sweep (``k2_sweep``, its lanes and its fused
route), the data the planner's split model was fitted to.
``python3 chip_smoke.py --moe`` builds them and runs only the ``legacy``
and ``moe`` lines of step 10, ``--recurrent`` only the lines of step 11,
``--multimodal`` only the multimodal lines, ``--fleet`` only the lines
of step 12, ``--parallel`` only those of step 13 (with the ``train`` line
first), ``--w4a4`` only the every-layout K2 rows, the conv rows with the
``fig4`` line, the ``linear`` line and the ``serve w4a4`` lines (flags
together run each).  ``python3 chip_smoke.py --w4a4-pass SRC`` runs only
the graphed W4A4 decode pass of the package under ``SRC`` (``w4a4 pass``
line), so that two trees -- this one and another unpacked beside it --
are compared in one call; ``--conv SRC`` likewise runs only K5 and K6 at
``CONV_COMPARE_CASES`` through that tree's planner (``conv-compare row``
lines) and its CNN phase, and ``--moe-pass SRC`` only the graphed
decode passes of mixtral-8x7b (4 of 32 layers) and jamba (5 of 72), kv
4, with that tree's serving prep (``moe pass`` lines).

14. The ``serve w4a4`` lines (after the ``spec`` lines): first
   ``kernel-vs-plain w4a4`` (as the serve phase's, on W4A4 params) and
   ``kernel-vs-plain w4a4 plain-k3`` (the same with K3 on its plain
   version: every logit equal to 'torch''s, gated); then stablelm-1.6b
   whole at W4A4 int32 (``int32xP2s16``, W4A4's only layout), kv 4, the
   serve cell's ``EngineConfig``, seed-0 weights, the serve prompts cut
   to 24 tokens with 8 new tokens each on graphed engines over the lanes
   store and over the dense store, each against an engine on
   ``backend='torch'``: tokens
   gated under the ``spec`` lines' rule (each parting listed with its
   margin), every packed linear one fused launch of the layout's library
   (lanes) or the w_bits-4 dense library, no CUDA-core K2, no standalone
   K1, no plain call (gated); decode ms wall and replayed, the graph's
   device ms by kernel group, K2 launches by route and by library.

15. The dense LM configs never served before (after the ``moe`` lines),
   whole: ``archs k2`` -- the serving path's fused K2 (K1 folded in) at
   every packed-linear shape of granite-3-8b (4096 -> 4096 / 1024 /
   12800, 12800 -> 4096), minicpm-2b (2304 -> 2304 / 5760, 5760 -> 2304)
   and qwen1.5-32b (5120 -> 5120, its q/k/v with a bf16 bias in the
   epilogue, 5120 -> 27392, 27392 -> 5120) at 4 and 64 rows, bit-equal
   to K1 + K2-affine and to the plain version (gated), timed against its
   bound; ``archs k3`` -- K3 and K4 at minicpm's H36 hd64 and qwen1.5's
   H40 hd128 (granite's GQA-4 hd128 is the kernel phase's), C1 and C16,
   kv 16 and 4, within ATTN_TOL of the plain version, K4 bit-equal to K3
   (gated), SDPA beside it at kv 16.  An ``archs serve`` line per config
   and kv setting: granite-3-8b (40 layers) and minicpm-2b (40) at kv 16
   and 4, qwen1.5-32b (64 layers, QKV bias drawn nonzero) at kv 4, full
   width and whole depth, seed-0 W2A2 weights packed once (qwen1.5 a
   layer at a time: ``build_packed_params``, since its float tree and
   its lanes do not fit the card together), ``EngineConfig(max_batch=4,
   max_len=512, prefill_chunk=16)``, the serve prompts cut to 24 tokens,
   4 greedy tokens each on a graphed engine, then on one with
   ``backend='torch'`` over
   the same packed tree: tokens under the ``spec`` lines' margin rule
   (each parting listed), every packed linear one fused K2 launch, K3 on
   its warp and its tile path, every write one launch, no plain call,
   every token in the vocabulary and the padded columns at -1e30 in the
   decode graph (each gated); init / pack / capture s, decode ms wall
   and replayed, idle share, device ms by kernel group, launches a
   decode pass and a prefill chunk, param bytes (lanes and the rest),
   cache and peak bytes.  The ``examples`` line:
   ``repro_torch.examples.quickstart`` and ``serve_quantized`` (one
   shard, and two shards on the card) as their own processes (gated:
   exit 0, the quickstart's lattice dot exact on the launched
   tensor-core K2, two shards' tokens equal to one's).
   ``python3 chip_smoke.py --archs`` runs only these lines.

16. The ``train archs`` lines (after the ``train-ckpt`` lines): the train
   step of every LM family beyond the dense one.  A ``train archs
   reduced`` line per case of ``tests/torch_train_cases.py`` (the nine LM
   archs beyond stablelm-1.6b, reduced, f32, remat 'block', two
   microbatches, batch 4; 8-bit moments for qwen1.5-32b, mixtral-8x22b
   and jamba, and those three with f32 moments too): 3 steps (2 with
   8-bit moments) from one state on the CPU and on the card, metrics
   within 1e-4 relative and params within 1e-4 as the CPU tests hold
   them (gated).  A ``train archs`` line per arch of TRAIN_WIDE at full
   width, each config's own
   remat, microbatches and moments, seed-0 params, a batch its
   microbatches divide (4, jamba's 16) of 128-token rows (qwen2-vl's
   with a 4-token image prefix of 1,280 features, seamless's with 8
   encoder embeddings), cut in depth only where the train state does not
   fit (mixtral-8x7b to 1 of 32 layers, jamba to its first, xlstm-1.3b
   to 24 of 48; each cut on its line): 2 steps, per step loss, ce,
   grad_norm, lr and ms, median step ms, tokens/s, peak and build-peak
   memory, and under ``--train-archs`` one more step under the profiler
   by range (the whole run leaves it out: 31 s of host time on an H100
   machine for xlstm's alone) (gated: every
   metric finite, step 0's loss equal to the no-grad QAT forward's over
   the same microbatches within 1e-4, the params moved by step 1, a
   gradient reached the embedding and a frontend's projection; the
   kernels no gradient reached are listed).  The ``train archs serve``
   line: the trained mixtral-8x7b through ``prepare_serving_params``,
   served graphed at kv 4 against ``backend='torch'`` over the same
   prepared tree (gated: tokens and every decode logit equal, every
   packed linear one fused K2 launch, no read on K3: the windowed cache
   takes the legacy read).
   ``python3 chip_smoke.py --train-archs`` runs only these lines (and
   builds only the fused K2's and the window write's libraries).

Each phase's kernels are counted from zero just before the phase drives
its path and read just after; the ``{"kernels": [...]}`` line lists every
kernel of a path (K1-K7; K2 on the tensor cores as its int16xP2s8 lanes
route ``ulppack_matmul_mma``, K1 folded in as ``quantized_linear_mma``,
over the dense store as ``quantized_linear_mma_dense``, and at every other
layout as ``ulppack_matmul_mma_lanes`` / ``quantized_linear_mma_lanes``;
K5 and K6 on the tensor cores, each with its CUDA-core tile as a
``comparison`` entry (on no path, 0 launches, timed at the shape it took
before the chunked K loop); the window write ``cache_write``, which has no
TPU kernel of its own) with the launches of its path.  The CUDA-core K2 is
on no path: the K2 rows time it (``core_ms``).  ``phase`` lines give
the seconds since the start after each phase, with the depth cut that
keeps the whole run inside its time limit where a phase has one (CUTS).
The last line is ``{"ok": true, "device": {...}}``; any failure raises.
Without CUDA, or without the repository's ``src/repro_torch`` beside it, the
script exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
# Attention against its plain version: with f32 queries the two differ only
# in summation order (ATTN_TOL absolute and relative); with bf16 queries
# both round that f32 result to bf16, which adds at most one bf16 ulp
# (2^-7 of the value).
ATTN_TOL = 1e-4
ATTN_BF16_RTOL = 2.0 ** -7
# K3's tile-path launches on the serve phase and K4's on the paged phase
# (``ulppack_attention.tile_launches``: blocks of more than 4 query rows,
# the prefill chunks there); the summary line carries them
TILE_LAUNCHES = {"attention_decode": 0, "attention_decode_paged": 0}


# The card's peak rates and a kernel's bound: ``roofline/hw.card_peaks``
# and ``roofline/analysis.bound_ms`` of the package, bound here by
# :func:`use_package` (the phases call them by these names).
card_peaks = bound_ms = None


START = time.perf_counter()


#: The command-line modes that run some lines alone, not the whole run:
#: those that run a group of the whole run's lines (any of them
#: together), and the others.
ONLY_FLAGS = ("--moe", "--recurrent", "--multimodal", "--fleet",
              "--parallel", "--w4a4", "--archs", "--train-archs")
MODE_FLAGS = ("--k2-sweep", "--w4a4-pass", "--conv", "--attn-tile",
              "--moe-pass", *ONLY_FLAGS)
#: The libraries the whole run's first lines launch (the serve, graphs,
#: paged and legacy lines: the fused K2 on int16xP2s8 lanes, K3, K4, the
#: window write), built before them; the others compile behind those
#: lines at CPU priority BUILD_NICE (on the cores the lines leave idle)
#: and are waited for before the kernel phase.
FIRST_LIBRARIES = ("ulppack_matmul_mma", "attention_decode",
                   "attention_decode_paged", "cache_write")
BUILD_NICE = 10
#: The depth cuts that keep the whole script inside its time limit, by
#: the phase line they end (a line whose name starts with the key):
#: old -> new.  Widths, layers and gates are not cut.
CUTS = {
    "graphs": "greedy tokens a request 32 -> 8 (GRAPH_NEW), alternated "
              "rounds 3 -> 2 (GRAPH_ROUNDS)",
    "serve w4a4": "greedy tokens a request 16 -> 8 (W4A4_NEW), prompt "
                  "tokens 100 -> 24 (W4A4_PROMPT)",
    "moe serve": "prompt tokens 32 -> 16 (MOE_PROMPT)",
    "archs serve": "greedy tokens a request 8 -> 4 (ARCHS_NEW), prompt "
                   "tokens 100 -> 24 (ARCHS_PROMPT)",
    "dense, spec": "greedy tokens a request 32 -> 16 (SPEC_NEW)",
    "recurrent serve xlstm-1.3b": "greedy tokens a request 8 -> 4 "
                                  "(REC_NEW)",
    "fleet recurrent xlstm-1.3b": "greedy tokens a request 8 -> 4 "
                                  "(REC_NEW)",
    "vlm": "greedy tokens 8 -> 4 (MM_NEW)",
    "multimodal": "the encdec lines' greedy tokens 8 -> 4 (MM_NEW)",
    "train, train-serve, train-ckpt": "the Trainer's depth 2 -> 1 of 24 "
                                      "layers (CKPT_LAYERS)",
}


def mark(what: str) -> None:
    """A ``phase`` line: seconds since the script started, after ``what``
    (the whole run's time by phase, against its limit), with the phase's
    depth cut (CUTS) when it has one."""
    cut = next((c for k, c in CUTS.items()
                if what == k or what.startswith(k + " ")), None)
    print(f"phase {what}: {time.perf_counter() - START:.1f} s"
          + (f" (cut: {cut})" if cut else ""), flush=True)


def use_package(src: Path) -> None:
    """Put the checkout's ``src`` on the path and bind the package's
    roofline helpers to :data:`card_peaks` and :data:`bound_ms`."""
    global card_peaks, bound_ms
    sys.path.insert(0, str(src))
    from repro_torch.roofline.analysis import bound_ms
    from repro_torch.roofline.hw import card_peaks


def time_ms(torch, calls, reps=5) -> float:
    """Device time per call: ``calls`` (zero-argument launches) are captured
    once into a CUDA graph, which is replayed ``reps`` times between CUDA
    events; the median replay time over ``len(calls)``.  Replaying a graph
    leaves no host gaps between launches, so what is timed is the device
    work of each call, not Python's launch overhead.  This is
    ``autotune.measure_us``, the tuner's own method."""
    from repro_torch.kernels import autotune

    return autotune.measure_us(calls, device="cuda", repeats=reps) / 1e3


def copies_for(nbytes: int) -> int:
    """Buffer copies to rotate so a pass reads twice the L2's size
    (``autotune.copies_for``)."""
    from repro_torch.kernels import autotune

    return autotune.copies_for(nbytes)


def kernel_phase(torch, peaks, dev):
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import quant_pack, ulppack_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED)
    spec = PackSpec(2, 2)
    rows = []

    # ---- K1 quantize_pack ------------------------------------------------
    scale = torch.tensor(1 / math.sqrt(3), dtype=torch.float32, device=dev)
    zp = torch.tensor(2, dtype=torch.int32, device=dev)
    for m, k in ((4, 2048), (64, 2048), (4, 5632)):
        x = torch.randn((m, k), generator=gen, device=dev) * 1.5
        # read in its own dtype: f32, and the serving path's bf16 and f16
        for xd in (x, x.bfloat16(), x.half()):
            lk, rk = quant_pack.quantize_pack_cuda(xd, scale, zp, spec)
            lt, rt = quant_pack.quantize_pack_torch(xd, scale, zp, spec)
            torch.cuda.synchronize()
            if not (torch.equal(lk, lt) and torch.equal(rk, rt)):
                raise AssertionError(f"quantize_pack [{m}, {k}] {xd.dtype} "
                                     f"not bit-equal")
        kp = -(-k // spec.n_pack)
        nbytes = m * k * 4 + m * kp * spec.lane_bytes + m * 4 + 8
        # elementwise (divide, round, clip, shift): CUDA-core f32 work
        b, by = bound_ms(nbytes, 4 * m * k, peaks["hbm"], peaks["f32"])
        rows.append({
            "name": "quantize_pack", "shape": f"x[{m},{k}] {spec}",
            "max_abs_err": 0,
            "ms": time_ms(torch, [lambda: quant_pack.quantize_pack_cuda(
                x, scale, zp, spec)] * 20),
            "plain_ms": time_ms(torch, [lambda: quant_pack.quantize_pack_torch(
                x, scale, zp, spec)] * 5),
            "bound_ms": b, "bound_by": by, "library_ms": None})

    rows += packed_matmul_rows(torch, peaks, dev, gen)
    mark("kernel k2")
    rows += layout_k2_rows(torch, peaks, dev, gen)
    mark("kernel k2 layouts")
    rows += dense_rows(torch, peaks, dev, gen)
    rows += attention_rows(torch, peaks, dev, gen)
    mark("kernel k2 dense, k3")
    rows += cache_write_rows(torch, peaks, dev, gen)
    return rows


def time_eager_ms(torch, fn, reps=20) -> float:
    """Device time per call of ``fn`` run eagerly ``reps`` times between
    CUDA events, for a call that cannot be captured (it waits on the
    card: the plain cache write's ``nonzero``)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# The window write's cases at stablelm-1.6b's cache rows (B 4, a 16-token
# chunk, S 512; paged: 32 pages of 16 a slot): (offsets, valid counts) with
# a dead row, decode riders (valid 1), windows past the end of the cache
# (ragged: dropped; paged: clipped to the table's last page), and, paged,
# slot 3 dead with an all-zero block table.
CACHE_WRITE_RAGGED = (([0, 0, 5, 0], [16, 3, 0, 1]),
                      ([16, 510, 0, 3], [1, 16, 0, 16]),
                      ([513, 100, 500, 0], [16, 0, 16, 0]))
CACHE_WRITE_PAGED = (([0, 0, 5, 0], [16, 3, 1, 0]),
                     ([16, 3, 6, 0], [1, 16, 16, 0]),
                     ([509, 19, 22, 0], [6, 16, 1, 0]))


def cache_write_rows(torch, peaks, dev, gen, cfg=None, label="cache_write"):
    """The window write (csrc/cache_write.cu) bit-equal to its plain twin
    (``nonzero`` + ``index_put_``) at kv_bits 16/8/4/2, ragged and paged,
    over the cases above, page 0 and the unmapped pages left zero; then
    timed at the decode step's write (B 4, one token a row, kv_bits 4)
    beside the plain twin and ``index_put_`` on each leaf with the kept
    rows precomputed.  ``cfg`` gives the kv heads and head dim (full-width
    stablelm-1.6b's by default)."""
    from repro_torch import configs
    from repro_torch.kernels import cache_write as cw
    from repro_torch.models import attention

    cfg = cfg or configs.get_config("stablelm-1.6b")
    bsz, s, ps, width = 4, 512, 16, 16
    n_pages = s // ps
    num_pages = bsz * n_pages + 2
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    bt = torch.zeros((bsz, n_pages), dtype=torch.int32, device=dev)
    bt[:3] = (1 + torch.randperm(num_pages - 3, generator=gen, device=dev)[
        :3 * n_pages]).reshape(3, n_pages).to(torch.int32)
    checked = []
    for kv_bits in (16, 8, 4, 2):
        c = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
        for paged in (False, True):
            make = ((lambda: attention.init_paged_kv_cache(
                        c, num_pages, ps, device=dev)) if paged else
                    (lambda: attention.init_kv_cache(c, bsz, s, device=dev)))
            got, want = make(), make()
            for idx, vlen in (CACHE_WRITE_PAGED if paged
                              else CACHE_WRITE_RAGGED):
                k, v = (torch.randn((bsz, width, kvh, hd), generator=gen,
                                    device=dev).to(torch.bfloat16)
                        for _ in range(2))
                ti = torch.tensor(idx, dtype=torch.int32, device=dev)
                tv = torch.tensor(vlen, dtype=torch.int32, device=dev)
                dest = (attention.paged_dest_rows(ti, tv, bt, width, ps,
                                                  num_pages) if paged
                        else attention.ragged_dest_rows(ti, tv, width, s))
                attention.cache_write(got, k, v, dest, kv_bits,
                                      backend="cuda")
                attention.cache_write(want, k, v, dest, kv_bits,
                                      backend="torch")
            torch.cuda.synchronize()
            for name in want:
                a, b = got[name], want[name]
                if a.dtype == torch.bfloat16:
                    a, b = a.view(torch.int16), b.view(torch.int16)
                if not torch.equal(a, b):
                    raise AssertionError(f"{label} kv{kv_bits} "
                                         f"{'paged' if paged else 'ragged'} "
                                         f"{name}: not bit-equal")
            if paged and (got["k"][0].any() or got["k"][-2:].any()):
                raise AssertionError(f"{label} kv{kv_bits}: page 0 or "
                                     f"an unmapped page was written")
            checked.append(f"kv{kv_bits} {'paged' if paged else 'ragged'}")
    print(f"{label} bit-equal to its twin: " + ", ".join(checked))

    # the decode step's write: four live rows, one token each, kv_bits 4
    c = cfg.replace(quant=cfg.quant.replace(kv_bits=4))
    cache = attention.init_kv_cache(c, bsz, s, device=dev)
    idx = torch.tensor([100, 300, 77, 511], dtype=torch.int32, device=dev)
    dest = attention.ragged_dest_rows(
        idx, torch.ones(bsz, dtype=torch.int32, device=dev), 1, s)
    k, v = (torch.randn((bsz, 1, kvh, hd), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    qk, sk = attention.kv_quantize(k, 4)
    qv, sv = attention.kv_quantize(v, 4)
    leaves = [(cache[n].flatten(0, 1), t.flatten(0, 1)) for n, t in
              (("k", qk), ("v", qv), ("k_scale", sk), ("v_scale", sv))]
    twin = [(d.clone(), t) for d, t in leaves]
    cw.cache_write_cuda(dest, leaves)
    cw.cache_write_torch(dest, twin)
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
               for (a, _), (b, _) in zip(leaves, twin)):
        raise AssertionError(f"{label} at the decode write: not "
                             f"bit-equal")
    keep = cw.kept(dest, leaves[0][0].shape[0]).nonzero(as_tuple=True)[0]
    rows_kept = dest[keep]
    kept_n = int(keep.numel())
    # bytes: the destinations read, each kept row read once and written once
    nbytes = dest.numel() * 8 + 2 * kept_n * sum(
        d.shape[1] * d.element_size() for d, _ in leaves)
    b, by = bound_ms(nbytes, 0, peaks["hbm"], peaks["f32"])
    return [{
        "name": "cache_write", "shape": f"B{bsz} C1 S{s} H{kvh} hd{hd} kv4",
        "max_abs_err": 0,
        "ms": time_ms(torch, [lambda: cw.cache_write_cuda(dest, leaves)] * 20),
        "plain_ms": time_eager_ms(torch, lambda: cw.cache_write_torch(
            dest, twin)),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(torch, [lambda: [
            d.index_put_((rows_kept,), t[keep]) for d, t in twin]] * 20),
        "library": "index_put_ on each of the 4 leaves, kept rows "
                   "precomputed"}]


# K2's shapes: full-width stablelm-1.6b's (Kp, N) pairs at the decode rows
# (max_batch 4) and the chunked-prefill rows (4 x prefill_chunk 16), W2A2.
# The tensor-core kernel (int16xP2s8) takes all six; the CUDA-core kernel
# (on no route) keeps its earlier int16xP2s8 rows as comparison rows; the
# other layouts' are LAYOUT_K2_CASES.
K2_MMA_CASES = ((4, 1024, 2048), (4, 1024, 5632), (4, 2816, 2048),
                (64, 1024, 5632), (64, 1024, 2048), (64, 2816, 2048))
K2_CORE_CASES = (("W2A2/int16xP2s8", 4, 1024, 2048),
                 ("W2A2/int16xP2s8", 4, 1024, 5632),
                 ("W2A2/int16xP2s8", 4, 2816, 2048),
                 ("W2A2/int16xP2s8", 64, 1024, 5632))


def packed_matmul_rows(torch, peaks, dev, gen):
    """K2 at its shapes: the tensor-core kernel (``ulppack_matmul_mma``;
    bit-equal to the plain version, a second launch and three calls in a
    row bit-equal, its CUDA kernels by name from one profiled call, and
    the time with the affine epilogue fused in, bf16 out) and the
    CUDA-core kernel (``ulppack_matmul``) with its own geometry, each
    beside the plain version and one PyTorch call on the unpacked
    lattices (checked equal first): ``torch._int_mm`` on int8 above 16
    rows, else an f32 matmul, exact here (products <= 9, sums < 2^24, TF32
    off).  ``design_bound_ms``: the MMAs the tensor-core kernel issues
    (rows padded to block_m, columns to 128) at the int8 tensor-core rate;
    the CUDA-core kernel's packed-lane MACs at the f32 rate."""
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import ops, ulppack_matmul as mm
    from repro_torch.kernels import plan as plan_lib

    cases = {("W2A2/int16xP2s8", *c): ["mma"] for c in K2_MMA_CASES}
    for c in K2_CORE_CASES:
        cases.setdefault(c, []).append("core")
    rows = []
    for (text, m, kp, n), kinds in cases.items():
        sp = PackSpec.parse(text)
        k = kp * sp.n_pack
        qa = torch.randint(0, sp.max_a + 1, (m, k), generator=gen,
                           device=dev, dtype=torch.int32)
        qw = torch.randint(0, sp.max_w + 1, (k, n), generator=gen,
                           device=dev, dtype=torch.int32)
        a = packing.pack_activations(qa, sp)
        w = packing.pack_weights(qw, sp)
        want = mm.ulppack_matmul_torch(a, w, sp)
        ws = [w] + [w.clone() for _ in range(copies_for(w.numel() *
                                                        sp.lane_bytes) - 1)]
        if m > 16:
            lib_fn, lt = torch._int_mm, torch.int8
        else:
            lib_fn, lt = torch.matmul, torch.float32
        al = qa.to(lt)
        wls = [qw.to(lt) for _ in range(copies_for(qw.numel() *
                                                   al.element_size()))]
        if not torch.equal(lib_fn(al, wls[0]).to(torch.int32), want):
            raise AssertionError(f"{lib_fn.__name__} on the lattices "
                                 f"disagrees with the packed matmul")
        lib = time_ms(torch, [lambda wl=wl: lib_fn(al, wl) for wl in wls])
        del wls
        plain = time_ms(torch, [lambda: mm.ulppack_matmul_torch(a, w, sp)],
                        3)
        nbytes = (m * kp + kp * n) * sp.lane_bytes + m * n * 4
        # the card's floor: the lattice MACs on the int8 tensor cores
        b, by = bound_ms(nbytes, 2 * m * k * n, peaks["hbm"], peaks["int8"])
        base = {"shape": f"({m},{kp},{n}) {sp}", "max_abs_err": 0,
                "plain_ms": plain, "bound_ms": b, "bound_by": by,
                "library_ms": lib, "library": f"torch.{lib_fn.__name__} "
                                              f"({lt})"}
        if "mma" in kinds:
            plan = plan_lib.plan_packed_matmul(m, kp, n, sp,
                                               weight_store="lanes",
                                               device=dev)

            def call(wi=w, plan=plan):
                return mm.ulppack_matmul_mma_cuda(a, wi, sp, plan=plan)

            runs = [call() for _ in range(4)]
            torch.cuda.synchronize()
            if not all(torch.equal(r, want) for r in runs):
                raise AssertionError(f"ulppack_matmul_mma {sp} {(m, kp, n)}: "
                                     f"not bit-equal to the plain version, "
                                     f"or launches differ")
            # the serving path's call: the affine epilogue fused, bf16 out
            one = torch.tensor(1.0, device=dev)
            zero = torch.tensor(0, dtype=torch.int32, device=dev)
            ep = mm.Affine(torch.zeros(m, dtype=torch.int32, device=dev),
                           torch.zeros(n, dtype=torch.int32, device=dev),
                           one, zero, one, zero, k, None, torch.bfloat16)
            affine = time_ms(torch, [lambda wi=wi: mm.ulppack_matmul_mma_cuda(
                a, wi, sp, plan=plan, epilogue=ep) for wi in ws])
            mpad = plan.block_m * -(-m // plan.block_m)
            npad = 128 * -(-n // 128)
            design = bound_ms(nbytes, 2 * 2 * mpad * 64 * -(-kp // 64) * npad,
                              peaks["hbm"], peaks["int8"])
            rows.append({
                "name": "ulppack_matmul_mma", **base,
                "ms": time_ms(torch, [lambda wi=wi: call(wi) for wi in ws]),
                "ms_affine_bf16": affine, "design_bound_ms": design[0],
                "kernels_us": device_kernel_us(torch, call,
                                               warm=lambda: call(ws[-1])),
                "geometry": plan.describe()})
            rows.append(fused_quant_row(torch, peaks, dev, gen, sp, m, k, n,
                                        qw, ws, design[0]))
        if "core" in kinds:
            geo = plan_lib.packed_matmul_core_geometry(m, kp, n, sp, dev)
            got = mm.ulppack_matmul_cuda(a, w, sp, **geo)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"ulppack_matmul {sp} {(m, kp, n)} not "
                                     f"bit-equal")
            design = bound_ms(nbytes, 2 * m * kp * n, peaks["hbm"],
                              peaks["f32"])
            rows.append({
                "name": "ulppack_matmul", **base,
                "ms": time_ms(torch, [lambda wi=wi: mm.ulppack_matmul_cuda(
                    a, wi, sp, **geo) for wi in ws]),
                "design_bound_ms": design[0], "geometry": geo})
        del ws
    fused_epilogue_check(torch, dev, gen, ops, mm)
    k2_costs(torch, dev, gen)
    return rows


def fused_quant_row(torch, peaks, dev, gen, sp, m, k, n, qw, ws, design, *,
                    bias=None):
    """The serving path's call at one K2 shape: ``ops.quantized_linear``
    on bf16 activations with bf16 out, one launch of the tensor-core K2
    with K1 folded in (``quantized_linear_mma``), checked bit-equal to the
    route it replaces -- x cast to f32, K1, the tensor-core K2 with the
    affine epilogue -- and to the plain version, and timed beside that
    route (``two_launch_ms``: the cast, K1 and K2, three launches), at
    the serving path's activation scale (stablelm's a_step, 1/sqrt(3));
    ``ms_scale_0_4`` is the fused call at scale 0.4, where bf16
    activations land on exact half-steps (x = 1, 3, ... give x / 0.4 =
    2.5, 7.5, ...) that the kernel's filter leaves to its exact redo.
    ``bound_ms``: W's lanes, x and the output over HBM, or the lattice
    MACs at the int8 tensor-core rate; no single PyTorch call quantizes
    and multiplies.  ``bias`` ([n], as a layer's) goes into every route's
    epilogue."""
    from repro_torch.kernels import ops, quant_pack, ulppack_matmul as mm
    from repro_torch.kernels import plan as plan_lib

    x = (torch.randn((m, k), generator=gen, device=dev) * 1.5).bfloat16()
    cs = qw.sum(dim=0, dtype=torch.int32)
    a_scale = torch.tensor(3 ** -0.5, device=dev)
    zp = torch.tensor(2, dtype=torch.int32, device=dev)
    w_scale = torch.tensor(0.02, device=dev)
    bf16 = torch.bfloat16
    plan = plan_lib.plan_quantized_linear(m, k, n, sp, bf16,
                                          weight_store="lanes", device=dev)
    lanes = plan_lib.plan_packed_matmul(m, -(-k // 2), n, sp,
                                        weight_store="lanes", device=dev)

    def fused(wi, a_scale=a_scale):
        return mm.quantized_linear_mma_cuda(x, wi, cs, a_scale, zp, w_scale,
                                            zp, sp, plan=plan, bias=bias,
                                            out_dtype=bf16)

    def two_launch(wi):
        a, rs = quant_pack.quantize_pack_cuda(x.float(), a_scale, zp, sp)
        return mm.ulppack_matmul_mma_cuda(a, wi, sp, plan=lanes, epilogue=(
            mm.Affine(rs, cs, a_scale, zp, w_scale, zp, k, bias, bf16)))

    def plain(a_scale=a_scale):
        return ops.quantized_linear(x, ws[0], cs, a_scale, zp, w_scale, zp,
                                    sp, bias=bias, backend="torch",
                                    out_dtype=bf16)

    want = plain()
    runs = [fused(ws[0]) for _ in range(2)] + [two_launch(ws[0])]
    s04 = torch.tensor(0.4, device=dev)
    want04 = plain(s04)
    torch.cuda.synchronize()
    if not all(torch.equal(r, want) for r in runs) \
            or not torch.equal(fused(ws[0], s04), want04):
        raise AssertionError(f"quantized_linear_mma {(m, k, n)}: not "
                             f"bit-equal to K1 + K2 and the plain version")
    nbytes = ws[0].numel() * 2 + m * k * 2 + m * n * 2 + n * 4
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    b, by = bound_ms(nbytes, 2 * m * k * n, peaks["hbm"], peaks["int8"])
    return {"name": "quantized_linear_mma", "route": "fused-quant",
            "shape": f"({m},{k // 2},{n}) {sp} bf16 x"
                     + ("" if bias is None else " bias"), "max_abs_err": 0,
            "ms": time_ms(torch, [lambda wi=wi: fused(wi) for wi in ws]),
            "two_launch_ms": time_ms(torch, [lambda wi=wi: two_launch(wi)
                                             for wi in ws]),
            "ms_scale_0_4": time_ms(torch, [lambda wi=wi: fused(wi, s04)
                                            for wi in ws]),
            "plain_ms": time_ms(torch, [plain], 3),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "design_bound_ms": design,
            "kernels_us": device_kernel_us(torch, lambda: fused(ws[0]),
                                           warm=lambda: fused(ws[-1])),
            "geometry": plan.describe()}


# K2 at every other layout: one case each at the widest bits it serves in
# the shipped configs' place (W1A1 on the nibble layouts, W2A2 on the int32
# ones) and W4A4 on int32xP2s16, its only layout; at stablelm's decode and
# prefill rows of K 2048 (lattice values): (rows, K, N).
LAYOUT_K2_SPECS = ("W1A1/int8xP2s4", "W1A1/int16xP4s4", "W2A2/int32xP2s8",
                   "W2A2/int32xP4s8", "W2A2/int32xP2s16", "W4A4/int32xP2s16")
LAYOUT_K2_CASES = ((4, 2048, 2048), (64, 2048, 5632))


def layout_k2_rows(torch, peaks, dev, gen, specs=LAYOUT_K2_SPECS,
                   cases=LAYOUT_K2_CASES):
    """K2 on the tensor cores at every layout but int16xP2s8 (one library
    each of ``csrc/ulppack_matmul_mma_lanes.cu``), against the CUDA-core K2
    (``csrc/ulppack_matmul.cu``, on no route) on the same operands in
    the same call.  Per (layout, shape): lanes in (``ulppack_matmul_mma_
    lanes``, route ``lanes-in``: four calls bit-equal to the plain version
    and to the CUDA-core K2, whose time is ``core_ms``; one PyTorch call on
    the lattices as in ``packed_matmul_rows``), then the serving path's
    call on bf16 activations, one fused launch (``quantized_linear_mma_
    lanes``, route ``fused-quant``), bit-equal to the plain version and to
    the route it replaces -- K1, the CUDA-core K2 and the eager epilogue,
    timed as ``old_route_ms`` -- and, where the layout holds the w_bits,
    over the dense store (``dense_ms``, bit-equal).  Each row's bounds as
    in ``packed_matmul_rows`` and ``fused_quant_row``."""
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import ops, quant_pack, ulppack_matmul as mm
    from repro_torch.kernels import plan as plan_lib

    bf16 = torch.bfloat16
    rows = []
    for text in specs:
        sp = PackSpec.parse(text)
        for m, k, n in cases:
            kp = -(-k // sp.n_pack)
            qa = torch.randint(0, sp.max_a + 1, (m, k), generator=gen,
                               device=dev, dtype=torch.int32)
            qw = torch.randint(0, sp.max_w + 1, (k, n), generator=gen,
                               device=dev, dtype=torch.int32)
            a = packing.pack_activations(qa, sp)
            w = packing.pack_weights(qw, sp)
            want = mm.ulppack_matmul_torch(a, w, sp)
            ws = [w] + [w.clone() for _ in range(copies_for(
                w.numel() * sp.lane_bytes) - 1)]
            if m > 16:
                lib_fn, lt = torch._int_mm, torch.int8
            else:
                lib_fn, lt = torch.matmul, torch.float32
            al = qa.to(lt)
            wls = [qw.to(lt) for _ in range(copies_for(
                qw.numel() * al.element_size()))]
            if not torch.equal(lib_fn(al, wls[0]).to(torch.int32), want):
                raise AssertionError(f"{lib_fn.__name__} on the lattices "
                                     f"disagrees with the packed matmul")
            lib = time_ms(torch, [lambda wl=wl: lib_fn(al, wl) for wl in wls])
            del wls
            plan = plan_lib.plan_packed_matmul(m, kp, n, sp,
                                               weight_store="lanes",
                                               device=dev)
            geo = plan_lib.packed_matmul_core_geometry(m, kp, n, sp, dev)

            def call(wi, plan=plan):
                return mm.ulppack_matmul_mma_cuda(a, wi, sp, plan=plan)

            def core(wi, geo=geo):
                return mm.ulppack_matmul_cuda(a, wi, sp, **geo)

            runs = [call(w) for _ in range(4)] + [core(w)]
            torch.cuda.synchronize()
            if not all(torch.equal(r, want) for r in runs):
                raise AssertionError(f"ulppack_matmul_mma_lanes {sp} "
                                     f"{(m, kp, n)}: not bit-equal to the "
                                     f"plain version and the CUDA-core K2")
            nbytes = (m * kp + kp * n) * sp.lane_bytes + m * n * 4
            b, by = bound_ms(nbytes, 2 * m * k * n, peaks["hbm"],
                             peaks["int8"])
            rows.append({
                "name": "ulppack_matmul_mma_lanes", "route": "lanes-in",
                "shape": f"({m},{kp},{n}) {sp}", "max_abs_err": 0,
                "ms": time_ms(torch, [lambda wi=wi: call(wi) for wi in ws]),
                "core_ms": time_ms(torch, [lambda wi=wi: core(wi)
                                           for wi in ws]),
                "plain_ms": time_ms(torch, [lambda: mm.ulppack_matmul_torch(
                    a, w, sp)], 3),
                "bound_ms": b, "bound_by": by, "library_ms": lib,
                "library": f"torch.{lib_fn.__name__} ({lt})",
                "geometry": plan.describe(), "core_geometry": geo})

            # the serving path's call, bf16 x, bf16 out
            x = (torch.randn((m, k), generator=gen, device=dev)
                 * 1.5).to(bf16)
            cs = qw.sum(dim=0, dtype=torch.int32)
            a_scale = torch.tensor(3 ** -0.5, device=dev)
            zp = torch.tensor((sp.max_a + 1) // 2, dtype=torch.int32,
                              device=dev)
            w_scale = torch.tensor(0.02, device=dev)
            w_zp = torch.tensor((sp.max_w + 1) // 2, dtype=torch.int32,
                                device=dev)
            args = (cs, a_scale, zp, w_scale, w_zp, sp)
            qplan = plan_lib.plan_quantized_linear(m, k, n, sp, bf16,
                                                   weight_store="lanes",
                                                   device=dev)

            def fused(wi, qplan=qplan, args=args, x=x):
                return mm.quantized_linear_mma_cuda(x, wi, *args, plan=qplan,
                                                    out_dtype=bf16)

            def old_route(wi, geo=geo, args=args, x=x):
                # the route the fused call replaced: K1, the CUDA-core K2 and
                # ops.quantized_linear's eager epilogue
                cs, a_scale, zp, w_scale, w_zp, _ = args
                ap, rs = quant_pack.quantize_pack_cuda(x.float(), a_scale,
                                                       zp, sp)
                acc = mm.ulppack_matmul_cuda(ap, wi, sp, **geo)
                f32 = torch.float32
                corr = (acc.to(f32) - w_zp.to(f32) * rs.to(f32)
                        - zp.to(f32) * cs.to(f32)
                        + k * zp.to(f32) * w_zp.to(f32))
                return (a_scale * w_scale * corr).to(bf16)

            fwant = ops.quantized_linear(x, w, *args, backend="torch",
                                         out_dtype=bf16)
            runs = [fused(w), fused(w), old_route(w)]
            extra = {}
            if sp.w_bits in plan_lib.DENSE_MMA_W_BITS:
                words = ops.dense_store_weights(qw, sp.w_bits)
                dplan = plan_lib.plan_quantized_linear(
                    m, k, n, sp, bf16, weight_store="dense", device=dev)
                wds = [words] + [words.clone() for _ in range(copies_for(
                    4 * words.numel()) - 1)]

                def dfused(wi, dplan=dplan, args=args, x=x):
                    return mm.quantized_linear_mma_cuda(
                        x, wi, *args, plan=dplan, out_dtype=bf16)

                runs.append(dfused(words))
            torch.cuda.synchronize()
            if not all(torch.equal(r, fwant) for r in runs):
                raise AssertionError(f"quantized_linear_mma_lanes {sp} "
                                     f"{(m, k, n)}: not bit-equal to the "
                                     f"plain version and the route it "
                                     f"replaces")
            if sp.w_bits in plan_lib.DENSE_MMA_W_BITS:
                extra = {"dense_ms": time_ms(torch, [
                    lambda wi=wi: dfused(wi) for wi in wds]),
                    "dense_geometry": dplan.describe()}
                del wds
            fbytes = w.numel() * sp.lane_bytes + m * k * 2 + m * n * 2 + n * 4
            fb, fby = bound_ms(fbytes, 2 * m * k * n, peaks["hbm"],
                               peaks["int8"])
            rows.append({
                "name": "quantized_linear_mma_lanes", "route": "fused-quant",
                "shape": f"({m},{kp},{n}) {sp} bf16 x", "max_abs_err": 0,
                "ms": time_ms(torch, [lambda wi=wi: fused(wi) for wi in ws]),
                "old_route_ms": time_ms(torch, [lambda wi=wi: old_route(wi)
                                                for wi in ws]),
                "plain_ms": time_ms(torch, [lambda: ops.quantized_linear(
                    x, w, *args, backend="torch", out_dtype=bf16)], 3),
                "bound_ms": fb, "bound_by": fby, "library_ms": None,
                "geometry": qplan.describe(), **extra})
            del ws
    return rows


def _mma_operands(torch, dev, gen, m, kp, n):
    """W2A2 int16xP2s8 lanes a [m, kp], w [kp, n] from random lattices, the
    plain version's result, and copies of w that rotate past the L2."""
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import ulppack_matmul as mm

    sp = PackSpec(2, 2)
    qa = torch.randint(0, 4, (m, 2 * kp), generator=gen, device=dev,
                       dtype=torch.int32)
    qw = torch.randint(0, 4, (2 * kp, n), generator=gen, device=dev,
                       dtype=torch.int32)
    a, w = packing.pack_activations(qa, sp), packing.pack_weights(qw, sp)
    ws = [w] + [w.clone() for _ in range(copies_for(2 * w.numel()) - 1)]
    return sp, a, ws, mm.ulppack_matmul_torch(a, w, sp)


def _mma_variant(plan, kp, block_m, per):
    """``plan`` with block_m rows a block and ``per`` 64-lane stages a
    split: ``plan_lib.mma_geometry``, the tile's shared memory for those
    rows (lanes, or the fused route's float rows of ``plan.x_bytes``)."""
    import dataclasses

    from repro_torch.kernels import plan as plan_lib

    ab = 2 * plan.x_bytes if plan.x_bytes else 2
    return dataclasses.replace(plan, **plan_lib.mma_geometry(kp, block_m,
                                                             per, ab))


def _mma_us(torch, a, ws, sp, plan, want):
    """The tensor-core K2's µs a call at ``plan``, checked bit-equal."""
    from repro_torch.kernels import ulppack_matmul as mm

    if not torch.equal(mm.ulppack_matmul_mma_cuda(a, ws[0], sp, plan=plan),
                       want):
        raise AssertionError(f"ulppack_matmul_mma {plan.describe()}: not "
                             f"bit-equal")
    return 1e3 * time_ms(torch, [lambda wi=wi: mm.ulppack_matmul_mma_cuda(
        a, wi, sp, plan=plan) for wi in ws])


def k2_costs(torch, dev, gen):
    """The tensor-core K2's fixed costs, µs a call by CUDA-graph replay: a
    one-element PyTorch add (the launch floor), one block of 8 rows x 128
    columns over 1, 2 and 16 stages of 64 lanes, and the same 2 and 16
    stages as 2 and 16 splits of one stage (the split-K fix-up's cost);
    prints a ``k2-costs`` line."""
    from repro_torch.kernels import plan as plan_lib

    t = torch.zeros(1, device=dev)
    rep = {"launch_floor_us": 1e3 * time_ms(torch, [lambda: t.add_(1)] * 20)}
    for kp, per in ((64, 1), (128, 1), (128, 2), (1024, 1), (1024, 16)):
        sp, a, ws, want = _mma_operands(torch, dev, gen, 4, kp, 128)
        plan = _mma_variant(plan_lib.plan_packed_matmul(
            4, kp, 128, sp, weight_store="lanes", device=dev), kp, 8, per)
        rep[f"stages{kp // 64}_splits{plan.splits}_us"] = _mma_us(
            torch, a, ws, sp, plan, want)
    print("k2-costs " + json.dumps(rep))


def k2_sweep(torch, dev):
    """``python3 chip_smoke.py --k2-sweep``: the tensor-core K2 at each of
    its main-path shapes over the planner's candidate grid
    (``plan.packed_matmul_candidates``: block_m up to the first that holds
    m x stages a split), µs a call by CUDA-graph replay, each checked
    bit-equal, beside the planner's choice: the data its split model was
    fitted to.  One ``k2-sweep`` line per shape and block_m for the lanes
    route, one ``k2-sweep-fused`` line for the fused quantize on bf16
    activations (the serving path's route, which shares the split
    model)."""
    import dataclasses

    from repro_torch.kernels import ops, ulppack_matmul as mm
    from repro_torch.kernels import plan as plan_lib

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bf16 = torch.bfloat16
    for m, kp, n in K2_MMA_CASES:
        sp, a, ws, want = _mma_operands(torch, dev, gen, m, kp, n)
        plan = plan_lib.plan_packed_matmul(m, kp, n, sp,
                                           weight_store="lanes", device=dev)
        x = (torch.randn((m, 2 * kp), generator=gen, device=dev)).to(bf16)
        cs = torch.zeros(n, dtype=torch.int32, device=dev)
        one = torch.tensor(3 ** -0.5, device=dev)   # the serving a_step
        zp = torch.tensor(2, dtype=torch.int32, device=dev)
        qplan = plan_lib.plan_quantized_linear(m, 2 * kp, n, sp, bf16,
                                               weight_store="lanes",
                                               device=dev)
        qwant = ops.quantized_linear(x, ws[0], cs, one, zp, one, zp, sp,
                                     backend="torch", out_dtype=bf16)

        def fused_us(p):
            def call(wi):
                return mm.quantized_linear_mma_cuda(
                    x, wi, cs, one, zp, one, zp, sp, plan=p, out_dtype=bf16)
            if not torch.equal(call(ws[0]), qwant):
                raise AssertionError(f"quantized_linear_mma {p.describe()}: "
                                     f"not bit-equal")
            return 1e3 * time_ms(torch, [lambda wi=wi: call(wi)
                                         for wi in ws])

        for label, p, us_of, x_dtype in (
                ("k2-sweep", plan, lambda v: _mma_us(torch, a, ws, sp, v,
                                                     want), None),
                ("k2-sweep-fused", qplan, fused_us, bf16)):
            # the planner's candidate grid: block_m x stages a split
            cands = plan_lib.packed_matmul_candidates(
                m, kp, n, sp, weight_store="lanes", x_dtype=x_dtype,
                device=dev)
            for bm in sorted({c["block_m"] for c in cands}):
                us = {c["block_k"] // 64: us_of(dataclasses.replace(p, **c))
                      for c in cands if c["block_m"] == bm}
                print(f"{label} " + json.dumps({
                    "shape": [m, kp, n], "block_m": bm,
                    "us_by_stages_per_split": us,
                    "planned": [p.block_m, p.block_k // 64, p.splits]}))


#: K2 over the bit-dense weight store: (rows, Kp, N, layout) of the kernel
#: phase's dense rows -- stablelm's six K2 shapes at W2A2, and the decode
#: shape at W1A1 (the W1 draft's).
K2_DENSE_CASES = tuple((*c, "W2A2/int16xP2s8") for c in K2_MMA_CASES) + (
    (4, 1024, 2048, "W1A1/int16xP2s8"),)


def dense_rows(torch, peaks, dev, gen, cases=K2_DENSE_CASES):
    """K2 over the bit-dense weight store (``quantized_linear_mma_dense``,
    route ``fused-quant-dense``): the serving path's call,
    ``ops.quantized_linear`` on bf16 activations with bf16 out, over int32
    words of w_bits values -- one launch of the tensor-core K2 that
    expands the words in its staging (csrc/ulppack_matmul_mma_dense.cu) --
    checked bit-equal to its plain version and to the lanes route's launch
    on the same lattices (``quantized_linear_mma``), and timed beside it
    (``lanes_ms``), each on weight copies rotated past the L2.
    ``bound_ms``: the words, x and the output over HBM, or the lattice
    MACs at the int8 tensor-core rate; ``library_ms``: the packed-matmul
    row's PyTorch call on the unpacked lattices at this shape (an f32
    ``torch.matmul`` up to 16 rows, ``torch._int_mm`` above)."""
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import ops, ulppack_matmul as mm
    from repro_torch.kernels import plan as plan_lib

    bf16 = torch.bfloat16
    rows = []
    for m, kp, n, text in cases:
        sp = PackSpec.parse(text)
        k = 2 * kp
        qw = torch.randint(0, sp.max_w + 1, (k, n), generator=gen,
                           device=dev, dtype=torch.int32)
        words = ops.dense_store_weights(qw, sp.w_bits)
        lanes = packing.pack_weights(qw, sp)
        cs = qw.sum(dim=0, dtype=torch.int32)
        x = (torch.randn((m, k), generator=gen, device=dev) * 1.5).to(bf16)
        a_scale = torch.tensor(3 ** -0.5, device=dev)
        azp = torch.tensor((sp.max_a + 1) // 2, dtype=torch.int32,
                           device=dev)
        wzp = torch.tensor(1 << (sp.w_bits - 1), dtype=torch.int32,
                           device=dev)
        w_scale = torch.tensor(0.02, device=dev)
        plans = {store: plan_lib.plan_quantized_linear(
            m, k, n, sp, bf16, weight_store=store, device=dev)
            for store in ("dense", "lanes")}

        def fused(wi, store):
            return mm.quantized_linear_mma_cuda(
                x, wi, cs, a_scale, azp, w_scale, wzp, sp,
                plan=plans[store], out_dtype=bf16)

        def plain():
            return ops.quantized_linear(
                x, words, cs, a_scale, azp, w_scale, wzp, sp,
                weight_store="dense", backend="torch", out_dtype=bf16)

        want = plain()
        runs = [fused(words, "dense") for _ in range(3)]
        lanes_out = fused(lanes, "lanes")
        torch.cuda.synchronize()
        if not all(torch.equal(r, want) for r in runs) \
                or not torch.equal(lanes_out, want):
            raise AssertionError(f"quantized_linear_mma_dense {sp} "
                                 f"{(m, kp, n)}: not bit-equal to the plain "
                                 f"version and the lanes route")
        wd = [words] + [words.clone() for _ in range(
            copies_for(4 * words.numel()) - 1)]
        wl = [lanes] + [lanes.clone() for _ in range(
            copies_for(2 * lanes.numel()) - 1)]
        if m > 16:
            lib_fn, lt = torch._int_mm, torch.int8
        else:
            lib_fn, lt = torch.matmul, torch.float32
        al = torch.randint(0, sp.max_a + 1, (m, k), generator=gen,
                           device=dev, dtype=torch.int32).to(lt)
        wls = [qw.to(lt) for _ in range(copies_for(qw.numel() *
                                                   al.element_size()))]
        lib = time_ms(torch, [lambda w=w: lib_fn(al, w) for w in wls])
        del wls
        nbytes = 4 * words.numel() + m * k * 2 + m * n * 2 + n * 4
        b, by = bound_ms(nbytes, 2 * m * k * n, peaks["hbm"], peaks["int8"])
        rows.append({
            "name": "quantized_linear_mma_dense",
            "route": "fused-quant-dense",
            "shape": f"({m},{kp},{n}) {sp} bf16 x dense", "max_abs_err": 0,
            "ms": time_ms(torch, [lambda w=w: fused(w, "dense")
                                  for w in wd]),
            "lanes_ms": time_ms(torch, [lambda w=w: fused(w, "lanes")
                                        for w in wl]),
            "plain_ms": time_ms(torch, [plain], 3),
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "library": f"torch.{lib_fn.__name__} ({lt})",
            "weight_bytes": 4 * words.numel(),
            "lanes_weight_bytes": 2 * lanes.numel(),
            "kernels_us": device_kernel_us(
                torch, lambda: fused(wd[0], "dense"),
                warm=lambda: fused(wd[-1], "dense")),
            "geometry": plans["dense"].describe()})
        del wd, wl
    return rows


def fused_epilogue_check(torch, dev, gen, ops, mm):
    """``ops.quantized_linear`` at stablelm's q projection (4 rows, K 2048,
    N 2048) with a bf16 bias, on f32 and the serving path's bf16
    activations, f32 and bf16 out: one launch of the tensor-core K2 with
    K1 folded in and the affine epilogue fused (no K1 launch), bit-equal
    to the route it replaced -- K1 on x.float(), then the tensor-core K2
    on the lanes with the fused epilogue -- and to the same function on
    the plain backend, whose epilogue is eager PyTorch; prints a
    ``fused-epilogue`` line (the ``linear`` line times the path)."""
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import plan as plan_lib
    from repro_torch.kernels import quant_pack

    sp = PackSpec(2, 2)
    x = torch.randn((4, 2048), generator=gen, device=dev)
    w = torch.randn((2048, 2048), generator=gen, device=dev) * 0.03
    zp = torch.tensor(2, dtype=torch.int32, device=dev)
    w_scale = torch.tensor(0.02, device=dev)
    a_scale = torch.tensor(0.4, device=dev)
    wp, cs = ops.prepare_weights(w, w_scale, zp, sp)
    bias = torch.randn((2048,), generator=gen, device=dev).bfloat16()
    lanes = plan_lib.plan_packed_matmul(4, 1024, 2048, sp,
                                        weight_store="lanes", device=dev)
    for xd in (x, x.bfloat16()):
        for out_dtype in (torch.float32, torch.bfloat16):
            args = (xd, wp, cs, a_scale, zp, w_scale, zp, sp)
            mm.reset_counts()
            quant_pack.reset_counts()
            got = ops.quantized_linear(*args, bias=bias, out_dtype=out_dtype)
            launches = dict(mm.mma_launches)
            k1 = quant_pack.kernel_launches
            want = ops.quantized_linear(*args, bias=bias, out_dtype=out_dtype,
                                        backend="torch")
            a, rs = quant_pack.quantize_pack_cuda(xd.float(), a_scale, zp, sp)
            two = mm.ulppack_matmul_mma_cuda(a, wp, sp, plan=lanes, epilogue=(
                mm.Affine(rs, cs, a_scale, zp, w_scale, zp, 2048, bias,
                          out_dtype)))
            torch.cuda.synchronize()
            if launches != {"s32": 0, "affine": 0, "quant_affine": 1} or k1 \
                    or not torch.equal(got, want) \
                    or not torch.equal(got, two):
                raise AssertionError(
                    f"fused epilogue (x {xd.dtype}, out {out_dtype}): "
                    f"launches {launches}, K1 {k1}, bit-equal to the plain "
                    f"route {torch.equal(got, want)}, to K1 + K2 "
                    f"{torch.equal(got, two)}")
    print("fused-epilogue " + json.dumps({
        "shape": "x[4,2048] W2A2/int16xP2s8 N 2048, bf16 bias",
        "x_dtypes": ["float32", "bfloat16"],
        "out_dtypes": ["float32", "bfloat16"], "launches_per_call":
        {"quantized_linear_mma": 1, "quantize_pack": 0},
        "bit_equal_to_eager": True, "bit_equal_to_k1_k2": True}))


# K3/K4's shapes: stablelm-1.6b's heads (32 of 64, one kv head each) at
# every kv_bits, C 1 and 16 (and the verify window's C 5 at kv 16/4/2),
# and granite-3-8b's grouping (32 query heads on 8 kv heads of 128) at
# kv_bits 16 and 4, C 1 and 16; batch 4, a 512-row cache.  C 1 takes the
# kernel's warp path, C 5 and 16 its tile path (bf16 tensor cores).
ATTN_CASES = ((32, 32, 64, (16, 8, 4, 2)), (32, 8, 128, (16, 4)))
ATTN_C5_BITS = (16, 4, 2)


def attention_path(plan) -> str:
    """'warp' or 'tile': the path of K3/K4 a plan's rows take (up to 4 query
    rows a block: the warp path)."""
    return "warp" if plan.block_m <= 4 else "tile"


def attention_design_ops(torch, q, h, hd, seen, f32_cache, path) -> float:
    """The operations K3/K4's own design issues for QK and PV over the rows
    each query row sees (``seen`` summed over rows and positions): on the
    warp path the useful 4 h hd a row, in f32 on the CUDA cores; on the
    tile path each product in bf16 terms on the tensor cores -- q in the
    terms that hold it (bf16 one, f16 two, f32 three) and p x sv in
    three, each against the one exact bf16 term of K or V, or the f32
    cache's three (the term pairs a + b <= 2: 3, 5 or 6 of them).
    Padding (m16 rows, k16 keys) is not counted."""
    useful = 2 * h * hd * seen
    if path == "warp":
        return 2 * useful
    tq = {torch.bfloat16: 1, torch.float16: 2}.get(q.dtype, 3)

    def pairs(t):
        return {1: 3, 2: 5, 3: 6}[t] if f32_cache else t
    return useful * (pairs(tq) + pairs(3))


def attention_rows(torch, peaks, dev, gen):
    """K3 and K4 against their plain versions (f32 and bf16 queries), K4
    bit-equal to K3 through a scrambled block table, the dead row zero, a
    second launch bit-equal to the first; timed beside the plain version
    and, at kv_bits 16, SDPA on the same rows.  Each row names the path
    its plan takes (``attention_path``)."""
    rows = []
    bsz, s = 4, 512
    valid_len = torch.tensor([512, 300, 77, 0], dtype=torch.int32,
                             device=dev)
    for h, kvh, hd, bits_list in ATTN_CASES:
        for kv_bits in bits_list:
            windows = (1, 5, 16) if kvh == h and kv_bits in ATTN_C5_BITS \
                else (1, 16)
            rows += attention_case(torch, peaks, dev, gen, bsz, s, h, kvh,
                                   hd, kv_bits, valid_len, windows)
    return rows


def check_attention(torch, name, got, want, qq, again):
    """Within ATTN_TOL (f32 q) or ATTN_TOL + one bf16 ulp (bf16 q) of the
    plain version, finite, the dead row zero, a second launch bit-equal;
    returns the max abs error."""
    diff = (got.float() - want).abs()
    rtol = ATTN_TOL if qq.dtype == torch.float32 else ATTN_BF16_RTOL
    if not (torch.isfinite(got).all() and
            (diff <= ATTN_TOL + rtol * want.abs()).all()):
        raise AssertionError(f"{name} {qq.dtype}: max abs err "
                             f"{float(diff.max())} beyond {ATTN_TOL} + "
                             f"{rtol}|want|")
    if got[3].any():
        raise AssertionError(f"{name}: dead row is not zero")
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {qq.dtype}: two launches differ")
    return float(diff.max())


def attention_case(torch, peaks, dev, gen, bsz, s, h, kvh, hd, kv_bits,
                   valid_len, windows=(1, 16)):
    from repro_torch.kernels import plan as plan_lib
    from repro_torch.kernels import ulppack_attention as ua
    from repro_torch.models import attention

    kf = torch.randn((bsz, s, kvh, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    vf = torch.randn((bsz, s, kvh, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    if kv_bits == 16:
        cache = {"k": kf, "v": vf}
        row_bytes = hd * 2
    else:
        qk, sk = attention.kv_quantize(kf, kv_bits)
        qv, sv = attention.kv_quantize(vf, kv_bits)
        cache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
        row_bytes = qk.shape[-1] * qk.element_size() + 2
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    caches = [cache] + [{kk: t.clone() for kk, t in cache.items()}
                        for _ in range(copies_for(cache_bytes) - 1)]
    # K4: the same logical rows in a pool of 16-row pages behind a
    # scrambled block table (a random permutation of the pages)
    ps, n_pages = 16, s // 16
    bt = torch.randperm(bsz * n_pages, generator=gen, device=dev) \
        .reshape(bsz, n_pages).to(torch.int32)
    pool = {}
    for name, t in cache.items():
        pool[name] = torch.empty((bsz * n_pages, ps, *t.shape[2:]),
                                 dtype=t.dtype, device=dev)
        pool[name][bt.long()] = t.reshape(bsz, n_pages, ps, *t.shape[2:])
    pools = [pool] + [{kk: t.clone() for kk, t in pool.items()}
                      for _ in range(copies_for(cache_bytes) - 1)]
    heads = f"H{h}" if kvh == h else f"H{h} KVH{kvh}"
    rows = []
    for c in windows:
        q = torch.randn((bsz, c, h, hd), generator=gen,
                        device=dev).to(torch.bfloat16)
        qpos = (torch.clamp(valid_len, min=c)[:, None] - c
                + torch.arange(c, device=dev)[None, :]).to(torch.int32)
        plan = plan_lib.plan_attention_decode(
            bsz, c, s, h, kvh, hd, kv_bits, cache_dtype=cache["k"].dtype,
            device=dev)
        geo = {f: getattr(plan, f) for f in (
            "block_m", "splits", "split_rows", "tile_rows", "smem_bytes")}
        err, err4 = {}, {}
        for qq in (q.float(), q):          # f32 queries, then the path's
            got = ua.attention_decode_cuda(qq, cache, valid_len, qpos,
                                           kv_bits=kv_bits, hd=hd)
            want = ua.attention_decode_torch(
                qq, cache, valid_len, qpos, kv_bits=kv_bits, hd=hd,
                block_k=512).float()
            err[qq.dtype] = check_attention(
                torch, f"attention kv{kv_bits} {heads} C={c}", got, want,
                qq, ua.attention_decode_cuda(qq, cache, valid_len, qpos,
                                             kv_bits=kv_bits, hd=hd))
            # K4 through the table: within tolerance of its plain version,
            # bit-equal to K3
            got4 = ua.attention_decode_paged_cuda(
                qq, pool, valid_len, qpos, bt, kv_bits=kv_bits, hd=hd)
            want4 = ua.attention_decode_torch(
                qq, pool, valid_len, qpos, kv_bits=kv_bits, hd=hd,
                block_k=512, block_tables=bt).float()
            err4[qq.dtype] = check_attention(
                torch, f"paged attention kv{kv_bits} {heads} C={c}", got4,
                want4, qq, ua.attention_decode_paged_cuda(
                    qq, pool, valid_len, qpos, bt, kv_bits=kv_bits, hd=hd))
            if not torch.equal(got4, got):
                raise AssertionError(f"paged attention kv{kv_bits} {heads} "
                                     f"C={c} {qq.dtype}: not bit-equal to K3")
        lib = None
        if kv_bits == 16:
            qs = q.transpose(1, 2).contiguous()
            ks, vs = (t.transpose(1, 2).contiguous() for t in (kf, vf))
            pos = torch.arange(s, device=dev)
            mask = ((pos[None, None, :] < valid_len[:, None, None])
                    & (pos[None, None, :] <= qpos[:, :, None]))[:, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = time_ms(torch, [lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                               enable_gqa=kvh != h)] * 10)
        # bytes: each live cache row once, q read and the output written
        # (bf16); operations: QK and PV over the rows each query row really
        # sees (causal within the window)
        live_rows = torch.minimum(valid_len, qpos.max(dim=1).values + 1
                                  ).clamp(min=0)
        live = int(live_rows.sum())
        seen = torch.minimum(valid_len[:, None], qpos + 1)
        seen = int(seen.clamp(min=0).sum())
        nbytes = 2 * live * kvh * row_bytes + 2 * q.numel() * 2
        # the card's floor: QK and PV on the bf16 tensor cores (the
        # lattices, and q pre-scaled by hd^-0.5, are exact in bf16 at
        # hd 64); the design bound: the products this kernel's path issues,
        # at its unit's peak (warp path: f32 CUDA cores; tile path: the
        # bf16 term products on the tensor cores)
        ops = 4 * h * hd * seen
        b, by = bound_ms(nbytes, ops, peaks["hbm"], peaks["bf16"])
        path = attention_path(plan)
        unit = peaks["f32" if path == "warp" else "bf16"]
        dops = attention_design_ops(torch, q, h, hd, seen,
                                    cache["k"].dtype == torch.float32, path)
        design = bound_ms(nbytes, dops, peaks["hbm"], unit)
        rows.append({
            "name": "attention_decode", "path": path,
            "shape": f"B{bsz} S{s} {heads} hd{hd} C{c} kv{kv_bits}",
            "max_abs_err": err[torch.bfloat16],
            "max_abs_err_f32_q": err[torch.float32],
            "design_bound_ms": design[0], "geometry": geo,
            "ms": time_ms(torch, [lambda cc=cc: ua.attention_decode_cuda(
                q, cc, valid_len, qpos, kv_bits=kv_bits, hd=hd)
                for cc in caches]),
            "plain_ms": time_ms(torch, [lambda: ua.attention_decode_torch(
                q, cache, valid_len, qpos, kv_bits=kv_bits, hd=hd,
                block_k=512)], 3),
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "library": "SDPA (bool mask, same rows)" if kv_bits == 16 else
                       "none: no single PyTorch call reads a sub-byte cache"})
        live_pages = int((-(-live_rows // ps)).sum())
        b4, by4 = bound_ms(nbytes + 4 * live_pages, ops, peaks["hbm"],
                           peaks["bf16"])
        design4 = bound_ms(nbytes + 4 * live_pages, dops, peaks["hbm"], unit)
        rows.append({
            "name": "attention_decode_paged", "path": path,
            "shape": f"B{bsz} {n_pages}x{ps} pages {heads} hd{hd} C{c} "
                     f"kv{kv_bits}",
            "max_abs_err": err4[torch.bfloat16],
            "max_abs_err_f32_q": err4[torch.float32],
            "bit_equal_to_contiguous": True,
            "design_bound_ms": design4[0],
            "ms": time_ms(torch, [lambda pp=pp: ua.attention_decode_paged_cuda(
                q, pp, valid_len, qpos, bt, kv_bits=kv_bits, hd=hd)
                for pp in pools]),
            "plain_ms": time_ms(torch, [lambda: ua.attention_decode_torch(
                q, pool, valid_len, qpos, kv_bits=kv_bits, hd=hd,
                block_k=512, block_tables=bt)], 3),
            "bound_ms": b4, "bound_by": by4, "library_ms": None,
            "library": "none: no single PyTorch call reads a paged cache"})
    del pools, caches
    return rows


# K7's shapes: the run_linear decode shape, and M = 64 where torch._int_mm
# (M > 16 only) can stand beside it; s16 at the same shape.
INT_MATMUL_CASES = ((8, 4096, 4096, "int8"), (64, 4096, 4096, "int8"),
                    (64, 4096, 4096, "int16"))


def int_matmul_rows(torch, peaks, dev):
    """K7 against its plain version (bit-equal, over the operands' full
    range, so s16 sums wrap) and timed beside one PyTorch call that
    computes the same function, checked equal first: ``torch._int_mm`` on
    the int8 operands at M = 64, else ``torch.matmul`` in float64 (exact:
    |sum| <= 2^30 * 4096 < 2^53), reduced mod 2^32.  ``vs_library`` is
    K7's time over that call's; ``library_kernels`` and ``kernels_us``
    name the CUDA kernels that call and a K7 call launch, with their
    device times (one torch.profiler pass each; K7's after a warm-up on
    another weight copy, so that its weight comes from HBM)."""
    from repro_torch.core import packing
    from repro_torch.kernels import ops, plan as plan_lib, ulppack_matmul

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = []
    for m, k, n, dt_name in INT_MATMUL_CASES:
        dt = getattr(torch, dt_name)
        info = torch.iinfo(dt)
        a = torch.randint(info.min, info.max + 1, (m, k), generator=gen,
                          device=dev, dtype=dt)
        w = torch.randint(info.min, info.max + 1, (k, n), generator=gen,
                          device=dev, dtype=dt)
        plan = plan_lib.plan_int_matmul(m, k, n, a_bytes=a.element_size(),
                                        w_bytes=w.element_size(), device=dev)
        got = ops.int_matmul(a, w, plan=plan)
        want = ulppack_matmul.int_matmul_torch(a, w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int_matmul ({m},{k},{n}) {dt_name} not "
                                 f"bit-equal")
        esize = a.element_size()
        ws = [w] + [w.clone() for _ in range(copies_for(k * n * esize) - 1)]
        if dt == torch.int8 and m > 16:
            lib_name, lib_fn, lws = "torch._int_mm (int8)", torch._int_mm, ws
            lib_a = a
        else:
            lib_name, lib_fn = "torch.matmul f64, mod 2^32", torch.matmul
            lib_a = a.to(torch.float64)
            lws = [wi.to(torch.float64)
                   for wi in ws[:copies_for(8 * k * n)]]
        lib_out = lib_fn(lib_a, lws[0])
        if lib_out.dtype == torch.float64:
            lib_out = packing.wrap_i32(lib_out.to(torch.int64))
        if not torch.equal(lib_out, got):
            raise AssertionError(f"{lib_name} disagrees with int_matmul "
                                 f"({m},{k},{n}) {dt_name}")
        lib = time_ms(torch, [lambda wi=wi: lib_fn(lib_a, wi) for wi in lws])
        lib_kernels = device_kernel_us(torch, lambda: lib_fn(lib_a, lws[0]))
        del lws, lib_out
        nbytes = (m * k + k * n) * esize + 4 * m * n
        # the card's floor, which is also the design's: s8 MACs on the int8
        # tensor cores (mma.sync), s16 as four int8 byte-plane products per
        # MAC
        per_mac = 2 if dt == torch.int8 else 8
        b, by = bound_ms(nbytes, per_mac * m * k * n, peaks["hbm"],
                         peaks["int8"])
        ms = time_ms(torch, [lambda wi=wi: ops.int_matmul(a, wi, plan=plan)
                             for wi in ws])
        k7_kernels = device_kernel_us(
            torch, lambda: ops.int_matmul(a, ws[0], plan=plan),
            warm=lambda: ops.int_matmul(a, ws[-1], plan=plan))
        rows.append({
            "name": "int_matmul", "shape": f"({m},{k},{n}) {dt_name}",
            "max_abs_err": 0, "design_bound_ms": b, "ms": ms,
            "plain_ms": time_ms(torch, [lambda: ulppack_matmul
                                        .int_matmul_torch(a, w)], 3),
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "vs_library": ms / lib, "library": lib_name,
            "library_kernels": lib_kernels, "kernels_us": k7_kernels,
            "geometry": plan.describe()})
        del ws
    return rows


def device_kernel_us(torch, fn, warm=None) -> dict:
    """The device time of each CUDA kernel (and memset) that one call of
    ``fn`` launches, µs by name, from one ``torch.profiler`` pass after a
    warm-up call (of ``warm``, else ``fn``)."""
    from torch.profiler import ProfilerActivity, profile

    (warm or fn)()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total for e in device_rows(torch, prof)}


class DeviceRow:
    """A device row of a profile, as ``key_averages()`` gives it: the
    name, the summed device µs of its events and their count."""
    __slots__ = ("key", "self_device_time_total", "count")

    def __init__(self, key):
        self.key, self.self_device_time_total, self.count = key, 0.0, 0


#: How many more of :func:`device_rows`' calls of 1,000 to 5,000 launches
#: are held against ``key_averages()``, and whether all agreed so far
#: (else it takes key_averages).
ROWS_CHECK = {"left": 2, "fast": True}


def device_rows(torch, prof) -> list:
    """The device rows (kernels, copies, memsets, the ranges' device
    spans) of a finished ``torch.profiler`` profile by name, the rows of
    ``prof.key_averages()`` whose device type is CUDA, summed straight from
    the profiler's events.  ``key_averages()`` first builds an event
    object for every host op and runtime call: seconds for an eager pass,
    tens of seconds for a train step, and the largest host cost of this
    script's profiled lines.  The first two calls of 1,000 to 5,000
    launches also run ``key_averages()`` and compare every row's count and
    time; if any differs, they say so and every later call takes
    ``key_averages()``."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    cuda = torch.autograd.DeviceType.CUDA
    if not ROWS_CHECK["fast"]:
        return [e for e in prof.key_averages() if e.device_type == cuda]
    rows = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda or _filter_name(ev.name()) \
                or getattr(ev, "is_hidden_event", lambda: False)():
            continue
        key = _rewrite_name(name=ev.name(), with_wildcard=True)
        row = rows.get(key)
        if row is None:
            row = rows[key] = DeviceRow(key)
        row.count += 1
        if not (ev.is_async() or ev.start_thread_id() != ev.end_thread_id()):
            row.self_device_time_total += (ev.end_ns() - ev.start_ns()) / 1e3
    rows = list(rows.values())
    if ROWS_CHECK["left"] and 1000 <= sum(r.count for r in rows) <= 5000:
        ROWS_CHECK["left"] -= 1
        want = {e.key: (e.count, e.self_device_time_total)
                for e in prof.key_averages() if e.device_type == cuda}
        got = {r.key: (r.count, r.self_device_time_total) for r in rows}
        agree = want.keys() == got.keys() and all(
            want[k][0] == got[k][0]
            and abs(want[k][1] - got[k][1]) <= 1e-6 * max(1.0, want[k][1])
            for k in want)
        print("profiler rows " + json.dumps({
            "rows": len(want), "launches": sum(c for c, _ in want.values()),
            "device_us": sum(t for _, t in want.values()),
            "events_read_directly_equal_key_averages": agree}))
        if not agree:
            ROWS_CHECK["fast"] = False
            return [e for e in prof.key_averages() if e.device_type == cuda]
    return rows


#: :func:`range_rows`' counterpart of ROWS_CHECK.
RANGES_CHECK = {"checked": False, "fast": True}


def _range_rows_slow(torch, prof, names) -> dict:
    out = {n: {"count": 0, "cpu_time_total": 0.0, "device_time_total": 0.0}
           for n in names}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU and e.key in out:
            out[e.key] = {"count": e.count,
                          "cpu_time_total": e.cpu_time_total,
                          "device_time_total": e.device_time_total}
    return out


def range_rows(torch, prof, names) -> dict:
    """{name: count, host µs (``cpu_time_total``) and device µs
    (``device_time_total``: the kernels launched inside)} of the host
    ranges and ops called ``names`` in a finished profile, as
    ``prof.key_averages()``'s CPU rows give them, from the profiler's
    events: a kernel belongs to the host op that launched it (the kernel
    event's linked correlation id), and a range's device time is that of
    every op of its thread that starts inside it.  The first call also
    runs ``key_averages()`` and compares; if they differ, it says so and
    every later call takes ``key_averages()``."""
    import bisect

    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    if not RANGES_CHECK["fast"]:
        return _range_rows_slow(torch, prof, names)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    kernel_us = {}
    ops = {}                       # thread -> [(start ns, correlation id)]
    wanted = []
    for ev in prof.profiler.kineto_results.events():
        if _filter_name(ev.name()) or getattr(ev, "is_hidden_event",
                                              lambda: False)():
            continue
        link = ev.linked_correlation_id()
        if ev.device_type() == cuda:
            if link > 0:
                kernel_us[link] = kernel_us.get(link, 0.0) + (
                    ev.end_ns() - ev.start_ns()) / 1e3
            continue
        if ev.device_type() != cpu or link != 0 or ev.is_async() \
                or ev.start_thread_id() != ev.end_thread_id():
            continue
        tid = ev.start_thread_id()
        ops.setdefault(tid, []).append((ev.start_ns(), ev.correlation_id()))
        name = _rewrite_name(name=ev.name(), with_wildcard=True)
        if name in names:
            wanted.append((name, tid, ev.start_ns(), ev.end_ns()))
    index = {}
    for tid, lst in ops.items():
        lst.sort()
        acc, sums = 0.0, [0.0]
        for _, cid in lst:
            acc += kernel_us.get(cid, 0.0)
            sums.append(acc)
        index[tid] = ([s for s, _ in lst], sums)
    out = {n: {"count": 0, "cpu_time_total": 0.0, "device_time_total": 0.0}
           for n in names}
    for name, tid, start, end in wanted:
        starts, sums = index[tid]
        lo = bisect.bisect_left(starts, start)
        hi = bisect.bisect_left(starts, end)
        row = out[name]
        row["count"] += 1
        row["cpu_time_total"] += (end - start) / 1e3
        row["device_time_total"] += sums[hi] - sums[lo]
    if not RANGES_CHECK["checked"]:
        RANGES_CHECK["checked"] = True
        want = _range_rows_slow(torch, prof, names)
        agree = all(
            want[n]["count"] == out[n]["count"] and all(
                abs(want[n][k] - out[n][k]) <= 1e-6 * max(1.0, want[n][k])
                for k in ("cpu_time_total", "device_time_total"))
            for n in names)
        print("profiler ranges " + json.dumps({
            "key_averages": want, "events_read_directly": out,
            "equal": agree}))
        if not agree:
            RANGES_CHECK["fast"] = False
            return want
    return out


# The paper's Fig. 4 shape (benchmarks/fig4_conv2d.py): x [1, 256, 256, 32]
# x w [7, 7, 32, 32], VALID; its packed cases and the paper's speedups over
# the int16 conv (3.2x at W2A2, 1.7x at 3/4 bits).
FIG4 = dict(n=1, hw=256, c=32, k=7, co=32)
FIG4_SPECS = ("W3A3/int16xP2s8", "W2A2/int16xP2s8", "W1A1/int16xP2s8",
              "W1A1/int8xP2s4")
FIG4_PAPER = {"W2A2": 3.2, "W3A3": 1.7}
#: ResNet-18's conv4_x shape at batch 64 (3x3, 256 -> 256 on 14 x 14,
#: SAME): rows of K5 (W2A2 int16xP2s8, W4A4 int32xP2s16) and K6 (int16)
#: whose K the tensor cores take in channel chunks.
R18 = dict(n=64, hw=14, c=256, k=3, co=256)
R18_SPECS = ("W2A2/int16xP2s8", "W4A4/int32xP2s16")
CNN_BATCH, CNN_BATCHES = 8, 4


@contextlib.contextmanager
def tf32():
    """cuDNN convolutions in TF32 (PyTorch's default), restored after."""
    import torch

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def conv_kernel_phase(torch, peaks, dev, cnn_cfg):
    """K5 and K6 against their plain versions (bit-equal) and timed: the
    Fig. 4 shape (K6 on int16 values in [-256, 256), K5 on each packed
    case), the Fig. 4 conv at 64 (K6) and 128 (K5) channels and ResNet-18's
    conv4_x shape (``R18``: K6 int16, K5 W2A2 and W4A4), whose K the tensor
    cores take in channel chunks, and ``cnn_cfg``'s packed layers at the
    CNN phase's batch (SAME, its layout, lanes and dense).  Every row runs
    the tensor-core kernel through the planner's route: a second launch
    bit-equal, K5's fused epilogue bit-equal to ``cnn.conv_epilogue`` and
    timed, and the CUDA-core tile (on no route; kept as the comparison)
    bit-equal and timed on the same operands as ``cores_ms``.  Library
    yardsticks: ``F.conv2d`` on the f32 lattices with TF32 off, and with
    TF32 allowed where that is exact (K5); in float64 (K6).  Returns (rows,
    the Fig. 4 and R18 operands by case)."""
    import torch.nn.functional as F

    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import ops, plan as plan_lib
    from repro_torch.kernels import ulppack_conv2d as conv
    from repro_torch.models import cnn
    from repro_torch.models.common import full_f32

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows, fig4 = [], {}

    # ---- K6 int_conv2d: the paper's int16 baseline ----------------------
    n, hw, c, k, co = (FIG4[f] for f in ("n", "hw", "c", "k", "co"))
    fig4_label = f"fig4 x[{n},{hw},{hw},{c}] w[{k},{k},{c},{co}] VALID"

    def int_row(label, lo, hi, shape, padding="VALID", key=None):
        """K6 on int16 values in [lo, hi) at ``shape`` = (n, hw, c, k, co),
        through the planner's route (the tensor cores): bit-equal to the
        plain version, a second launch and the CUDA-core K6 (timed on the
        same operands), and, rounded (and wrapped mod 2^32), to F.conv2d
        in float64."""
        n, hw, c, k, co = shape
        qx = torch.randint(lo, hi, (n, hw, hw, c), generator=gen, device=dev,
                           dtype=torch.int16)
        qw = torch.randint(lo, hi, (k, k, c, co), generator=gen, device=dev,
                           dtype=torch.int16)
        if key is not None:
            fig4[key] = (qx, qw, padding)
        plan = plan_lib.plan_int_conv2d(tuple(qx.shape), tuple(qw.shape),
                                        x_bytes=2, w_bytes=2,
                                        padding=padding, device=dev)
        if plan.route != "tensor_cores":
            raise AssertionError(f"int_conv2d {label}: route {plan.route}")
        got = ops.int_conv2d(qx, qw, padding=padding, plan=plan)
        again = ops.int_conv2d(qx, qw, padding=padding, plan=plan)
        want = conv.int_conv2d_torch(qx, qw, padding=padding)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(again, want)):
            raise AssertionError(f"int_conv2d {label} not bit-equal")
        ho = got.shape[1]
        macs = n * ho * ho * k * k * c * co
        nbytes = 2 * (qx.numel() + qw.numel()) + 4 * got.numel()
        xs = [qx] + [qx.clone() for _ in range(copies_for(2 * qx.numel())
                                               - 1)]
        # the card's floor: the 16-bit operands on the int8 tensor cores
        # after a byte split of each (four int8 products per MAC, two ops
        # each)
        b, by = bound_ms(nbytes, 8 * macs, peaks["hbm"], peaks["int8"])
        # library yardstick: F.conv2d in float64 on the same values (NCHW x
        # OIHW).  Products are at most 2^30 and sums below 2^42, far below
        # 2^53, so every partial sum is exact in any order; rounded (and
        # wrapped mod 2^32) it must equal K6, and `library_exact` records
        # whether cuDNN's algorithm gave the integers without that
        # rounding.
        pad = (k - 1) // 2 if padding == "SAME" else 0
        x64 = qx.permute(0, 3, 1, 2).to(torch.float64).contiguous()
        w64 = qw.permute(3, 2, 0, 1).to(torch.float64).contiguous()
        lib_out = F.conv2d(x64, w64, padding=pad).permute(0, 2, 3, 1)
        wrapped = packing.wrap_i32(lib_out.round().to(torch.int64))
        torch.cuda.synchronize()
        if not torch.equal(wrapped, got):
            raise AssertionError(f"f64 conv disagrees with int_conv2d "
                                 f"{label}")
        lib_exact = torch.equal(lib_out, got.to(torch.float64))
        del lib_out, wrapped
        x64s = [x64] + [x64.clone() for _ in range(
            copies_for(8 * x64.numel()) - 1)]
        lib = time_ms(torch, [lambda xi=xi: F.conv2d(xi, w64, padding=pad)
                              for xi in x64s])
        del x64s, x64
        ms = time_ms(torch, [lambda xi=xi: ops.int_conv2d(
            xi, qw, padding=padding, plan=plan) for xi in xs])
        row = {"name": "int_conv2d_mma",
               "shape": f"{label} int16 [{lo},{hi})", "max_abs_err": 0,
               "ms": ms,
               "plain_ms": time_ms(torch, [lambda: conv.int_conv2d_torch(
                   qx, qw, padding=padding)], 3),
               "bound_ms": b, "bound_by": by, "share_of_bound": b / ms,
               "library_ms": lib,
               "library": "F.conv2d f64 on the int16 values",
               "library_exact": lib_exact, "geometry": plan.describe()}
        # the design bounds: the MMAs the tensor-core K6 issues (four a
        # step, 16 x 8 x 32 each, over every chunk) at the int8 rate, and
        # one IMAD per MAC on the CUDA cores
        tiles = n * -(-ho // plan.block_h) * -(-ho // plan.block_w)
        steps = tiles * 32 * k * k * (plan.chunks * plan.chunk_c // 2) // 32
        groups = -(-co // plan.block_co) * plan.block_co // 8
        row["design_bound_ms"] = bound_ms(
            nbytes, 2 * 4096 * 4 * steps * groups, peaks["hbm"],
            peaks["int8"])[0]
        core = plan_lib.int_conv2d_core_geometry(
            tuple(qx.shape), tuple(qw.shape), padding=padding, device=dev)
        cores = conv.int_conv2d_cuda(qx, qw, **core, padding=padding)
        torch.cuda.synchronize()
        if not torch.equal(cores, want):
            raise AssertionError(f"CUDA-core K6 {label} not bit-equal")
        del cores
        row["cores_ms"] = time_ms(torch, [
            lambda xi=xi: conv.int_conv2d_cuda(xi, qw, **core,
                                               padding=padding)
            for xi in xs])
        row["cores_design_bound_ms"] = bound_ms(
            nbytes, 2 * macs, peaks["hbm"], peaks["int32"])[0]
        row["cores_geometry"] = core
        rows.append(row)

    # the Fig. 4 int16 conv, the same at the full int16 range (the sums
    # wrap), at 64 channels (two channel chunks) and at ResNet-18's conv4_x
    # shape (four chunks of 64 channels)
    int_row(fig4_label, -256, 256, (n, hw, c, k, co), key="int16")
    int_row(fig4_label, -32768, 32768, (n, hw, c, k, co))
    int_row(f"fig4-c64 x[{n},{hw},{hw},{2 * c}] w[{k},{k},{2 * c},{co}] "
            f"VALID", -256, 256, (n, hw, 2 * c, k, co), key="int16-c64")
    r18 = tuple(R18[f] for f in ("n", "hw", "c", "k", "co"))
    r18_label = (f"r18 x[{r18[0]},{r18[1]},{r18[1]},{r18[2]}] "
                 f"w[{r18[3]},{r18[3]},{r18[2]},{r18[4]}] SAME")
    int_row(r18_label, -256, 256, r18, "SAME", key="int16-r18")

    # ---- K5 ulppack_conv2d ------------------------------------------------
    def packed_row(sp, qx, qw, padding, store, label, key=None):
        xp = packing.pack_activations(qx, sp)
        wp = (ops.dense_store_conv_weights(qw, sp.w_bits) if store == "dense"
              else packing.pack_weights(qw, sp, axis=2))
        k_full = qx.shape[-1] if store == "dense" else None
        kw = dict(padding=padding, weight_store=store, k_full=k_full)
        if key is not None:
            fig4[key] = (xp, wp, padding)
        plan = plan_lib.plan_packed_conv2d(
            tuple(xp.shape), tuple(wp.shape), sp, padding=padding,
            weight_store=store, k_full=k_full, device=dev)
        if plan.route != "tensor_cores":
            raise AssertionError(f"ulppack_conv2d {label} {sp}: route "
                                 f"{plan.route}")
        got = ops.packed_conv2d(xp, wp, sp, padding=padding, plan=plan)
        again = ops.packed_conv2d(xp, wp, sp, padding=padding, plan=plan)
        want = conv.ulppack_conv2d_torch(xp, wp, sp, **kw)
        # library yardsticks: cuDNN's f32 conv on the unpacked lattices, TF32
        # off -- integers below 2^24, so rounded it must equal K5 (cuDNN's
        # Winograd kernels for 3x3 round inside; `library_exact` records
        # whether the integers came without that rounding) -- and, recorded
        # only where it is exact, with TF32 allowed (lattice values <= 7 and
        # their products fit TF32's 11-bit significand)
        fh, fw = qw.shape[:2]
        pads = conv.same_pads(fh, fw, padding)
        xl = F.pad(qx.permute(0, 3, 1, 2).float(),
                   (pads[2], pads[3], pads[0], pads[1]))
        wl = qw.permute(3, 2, 0, 1).float().contiguous()
        with full_f32():
            lib_out = F.conv2d(xl, wl)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(again, want)):
            raise AssertionError(f"ulppack_conv2d {label} {sp} {store} not "
                                 f"bit-equal")
        lib_out = lib_out.permute(0, 2, 3, 1)
        if not torch.equal(lib_out.round().to(torch.int32), got):
            raise AssertionError(f"f32 conv on the lattices disagrees with "
                                 f"ulppack_conv2d {label}")
        lib_exact = torch.equal(lib_out, got.float())
        del lib_out
        with tf32():
            tf32_exact = torch.equal(
                F.conv2d(xl, wl).permute(0, 2, 3, 1), got.float())
        nb, h, w_, _ = qx.shape
        ho, wo = got.shape[1:3]
        co = qw.shape[-1]
        macs = nb * ho * wo * fh * fw * qx.shape[-1] * co
        nbytes = (xp.numel() * sp.lane_bytes + wp.numel() * wp.element_size()
                  + 4 * got.numel())
        # the card's floor: the lattice MACs on the int8 tensor cores
        b, by = bound_ms(nbytes, 2 * macs, peaks["hbm"], peaks["int8"])
        xps = [xp] + [xp.clone() for _ in range(
            copies_for(xp.numel() * sp.lane_bytes) - 1)]
        xls = [xl] + [xl.clone() for _ in range(copies_for(4 * xl.numel())
                                                - 1)]
        with full_f32():
            lib = time_ms(torch, [lambda xi=xi: F.conv2d(xi, wl)
                                  for xi in xls])
        lib_tf32 = None
        if tf32_exact:
            with tf32():
                lib_tf32 = time_ms(torch, [lambda xi=xi: F.conv2d(xi, wl)
                                           for xi in xls])
        del xls
        ms = time_ms(torch, [lambda xi=xi: ops.packed_conv2d(
            xi, wp, sp, padding=padding, plan=plan) for xi in xps])
        plain = time_ms(torch, [lambda: conv.ulppack_conv2d_torch(
            xp, wp, sp, **kw)], 3)
        row = {"name": "ulppack_conv2d_mma",
               "shape": f"{label} {sp} {store}", "max_abs_err": 0, "ms": ms,
               "plain_ms": plain, "bound_ms": b, "bound_by": by,
               "library_ms": lib, "library": "F.conv2d f32 lattices, TF32 off",
               "library_exact": lib_exact,
               "library_tf32_ms": lib_tf32, "library_tf32_exact": tf32_exact,
               "geometry": plan.describe()}
        # the MMAs the kernel issues at the int8 rate (over every chunk),
        # the fused epilogue bit-equal to cnn.conv_epilogue on the plain
        # accumulator and patch sums, and the CUDA-core tile's time on the
        # same operands
        tiles = nb * -(-ho // plan.block_h) * -(-wo // plan.block_w)
        steps = tiles * 32 * fh * fw * plan.chunks * plan.chunk_c // 32
        groups = -(-co // plan.block_co) * plan.block_co // 8
        row["design_bound_ms"] = bound_ms(
            nbytes, 2 * 4096 * steps * groups, peaks["hbm"],
            peaks["int8"])[0]
        ep = conv.ConvAffine(torch.tensor(4 / 3, device=dev),
                             torch.tensor(0.0213, device=dev),
                             torch.tensor(2, dtype=torch.int32, device=dev))
        fused = conv.ulppack_conv2d_mma_cuda(xp, wp, sp, plan=plan,
                                             epilogue=ep, **kw)
        eager = cnn.conv_epilogue({
            "acc": want, "psum": cnn.patch_sums(qx, fh, fw, padding),
            "a_scale": ep.a_scale, "w_scale": ep.w_scale, "w_zp": ep.w_zp})
        core = plan_lib.packed_conv2d_core_geometry(
            tuple(xp.shape), tuple(wp.shape), padding=padding, device=dev)
        cores = conv.ulppack_conv2d_cuda(xp, wp, sp, **core, **kw)
        torch.cuda.synchronize()
        if not torch.equal(fused, eager):
            raise AssertionError(f"fused conv epilogue {label} {store} not "
                                 f"bit-equal to cnn.conv_epilogue")
        if not torch.equal(cores, want):
            raise AssertionError(f"CUDA-core K5 {label} {store} not "
                                 f"bit-equal")
        del fused, eager, cores
        row["ms_affine"] = time_ms(torch, [
            lambda xi=xi: conv.ulppack_conv2d_mma_cuda(
                xi, wp, sp, plan=plan, epilogue=ep, **kw) for xi in xps])
        row["cores_ms"] = time_ms(torch, [
            lambda xi=xi: conv.ulppack_conv2d_cuda(xi, wp, sp, **core, **kw)
            for xi in xps])
        # the CUDA-core tile's design bound: one IMAD per packed product
        pmacs = nb * ho * wo * fh * fw * xp.shape[-1] * co
        row["cores_design_bound_ms"] = bound_ms(
            nbytes, 2 * pmacs, peaks["hbm"], peaks["int32"])[0]
        row["cores_geometry"] = core
        row["share_of_bound"] = b / ms
        row["vs_library"] = ms / min(t for t in (lib, lib_tf32) if t)
        rows.append(row)

    for text in FIG4_SPECS:
        sp = PackSpec.parse(text)
        qx = torch.randint(0, sp.max_a + 1, (n, hw, hw, c), generator=gen,
                           device=dev, dtype=torch.int32)
        qw = torch.randint(0, sp.max_w + 1, (k, k, c, co), generator=gen,
                           device=dev, dtype=torch.int32)
        packed_row(sp, qx, qw, "VALID", "lanes", fig4_label, key=text)
    # the Fig. 4 conv at 128 channels (four channel chunks) and ResNet-18's
    # conv4_x shape at W2A2 and W4A4 (a raw slot), past the resident weight
    # block
    sp = PackSpec.parse(FIG4_SPECS[1])
    c4 = 4 * c
    qx = torch.randint(0, sp.max_a + 1, (n, hw, hw, c4), generator=gen,
                       device=dev, dtype=torch.int32)
    qw = torch.randint(0, sp.max_w + 1, (k, k, c4, co), generator=gen,
                       device=dev, dtype=torch.int32)
    packed_row(sp, qx, qw, "VALID", "lanes",
               f"fig4-c{c4} x[{n},{hw},{hw},{c4}] w[{k},{k},{c4},{co}] VALID",
               key=f"{FIG4_SPECS[1]}-c{c4}")
    for text in R18_SPECS:
        sp = PackSpec.parse(text)
        rn, rhw, rc, rk, rco = r18
        qx = torch.randint(0, sp.max_a + 1, (rn, rhw, rhw, rc),
                           generator=gen, device=dev, dtype=torch.int32)
        qw = torch.randint(0, sp.max_w + 1, (rk, rk, rc, rco),
                           generator=gen, device=dev, dtype=torch.int32)
        packed_row(sp, qx, qw, "SAME", "lanes", r18_label,
                   key=f"{text}-r18")
    sp = PackSpec.from_config(cnn_cfg.quant)
    hw, k = cnn_cfg.cnn_input_hw, cnn_cfg.cnn_kernel
    chans = cnn_cfg.cnn_channels
    layers = sorted(set(zip((chans[0],) + chans[:-1], chans)))
    for cin, cout in layers:
        qx = torch.randint(0, sp.max_a + 1, (CNN_BATCH, hw, hw, cin),
                           generator=gen, device=dev, dtype=torch.int32)
        qw = torch.randint(0, sp.max_w + 1, (k, k, cin, cout),
                           generator=gen, device=dev, dtype=torch.int32)
        for store in ("lanes", "dense"):
            packed_row(sp, qx, qw, "SAME", store,
                       f"layer {cin}->{cout} x[{CNN_BATCH},{hw},{hw},{cin}] "
                       f"w[{k},{k},{cin},{cout}] SAME")
    # the widest layer at W4A4 (int32xP2s16, a raw slot rewritten into the
    # halo), both stores
    sp = PackSpec.parse("W4A4/int32xP2s16")
    cin, cout = layers[-1]
    qx = torch.randint(0, sp.max_a + 1, (CNN_BATCH, hw, hw, cin),
                       generator=gen, device=dev, dtype=torch.int32)
    qw = torch.randint(0, sp.max_w + 1, (k, k, cin, cout), generator=gen,
                       device=dev, dtype=torch.int32)
    for store in ("lanes", "dense"):
        packed_row(sp, qx, qw, "SAME", store,
                   f"layer {cin}->{cout} x[{CNN_BATCH},{hw},{hw},{cin}] "
                   f"w[{k},{k},{cin},{cout}] SAME")
    return rows, fig4


def fig4_instruction_model(text: str) -> dict:
    """The reference's Fig. 4 instruction model (``core/vmacsr.py``) for
    one packed case over its K = Fh * Fw * Cin loop: native ULPPACK's,
    ``vmacsr``'s and the int16 baseline's vector instructions an output
    element, and the speedups over int16 those counts model (doubled on
    int8 lanes, which hold twice the elements a vector register)."""
    from repro_torch.core import vmacsr
    from repro_torch.core.packing import PackSpec

    spec = PackSpec.parse(text)
    k = FIG4["k"] * FIG4["k"] * FIG4["c"]
    native = vmacsr.native_ulppack_instruction_count(k, spec.k_tile,
                                                     spec.n_pack).total
    fused = vmacsr.vmacsr_instruction_count(k, spec.k_tile,
                                            spec.n_pack).total
    base = vmacsr.int16_instruction_count(k).total
    gain = 2 if spec.lane_name == "int8" else 1
    return {"instructions": {"k": k, "k_tile": spec.k_tile,
                             "native_ulppack": native, "vmacsr": fused,
                             "int16": base},
            "modeled_speedup_native": base / native * gain,
            "modeled_speedup_vmacsr": base / fused * gain}


def fig4_phase(torch, fig4, rows):
    """The Fig. 4 comparison through the entry points: the int16 conv (K6),
    each packed case (K5, int8xP2s4 included) at the paper's shape, the
    int16 conv at 64 channels and the W2A2 case at 128 (K6 and K5 in
    channel chunks), and ResNet-18's conv4_x shape (K6 int16, K5 W2A2 and
    W4A4, in chunks), once each, every one on the tensor cores; returns
    the launches.  Prints the kernel phase's times side by side: each
    packed case's speedup over the int16 conv on the same unit (tensor
    cores against tensor cores) beside the paper's, and as a second column
    the CUDA-core K5's over the CUDA-core K6 on the same operands."""
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import ulppack_conv2d as conv

    conv.reset_counts()
    ints = [key for key in fig4 if key.startswith("int16")]
    packed = [key for key in fig4 if not key.startswith("int16")]
    out = {}
    for key in ints:
        qx, qw, padding = fig4[key]
        out[key] = ops.int_conv2d(qx, qw, padding=padding)
    for key in packed:
        xp, wp, padding = fig4[key]
        out[key] = ops.packed_conv2d(xp, wp, PackSpec.parse(key.split("-")[0]),
                                     padding=padding)
    torch.cuda.synchronize()
    launches, plain = dict(conv.kernel_launches), dict(conv.plain_calls)
    if launches != {"int_conv2d": 0, "int_conv2d_mma": len(ints),
                    "ulppack_conv2d": 0,
                    "ulppack_conv2d_mma": len(packed)} or any(plain.values()):
        raise AssertionError(f"fig4 path: launches {launches}, plain {plain}")
    ho = FIG4["hw"] - FIG4["k"] + 1
    for key, o in out.items():
        r18 = key.endswith("-r18")
        want = ((R18["n"], R18["hw"], R18["hw"], R18["co"]) if r18
                else (FIG4["n"], ho, ho, FIG4["co"]))
        if o.shape != want:
            raise AssertionError(f"fig4 path {key}: shape {o.shape}")
    k6 = next(r for r in rows if r["name"] == "int_conv2d_mma"
              and r["shape"].startswith("fig4 x"))
    t16, t16_cores = k6["ms"], k6["cores_ms"]
    rep = {"int16_ms": t16,
           "int16_route": "K6 on the int8 tensor cores "
                          "(csrc/int_conv2d_mma.cu)",
           "int16_share_of_bound": k6["share_of_bound"],
           "int16_cores_ms": t16_cores,
           "int16_cores_route": "K6 on the CUDA cores (csrc/int_conv2d.cu)",
           "packed": {}}
    for text in FIG4_SPECS:
        r = next(r for r in rows if r["name"] == "ulppack_conv2d_mma"
                 and r["shape"].startswith("fig4 x") and text in r["shape"])
        bits = text.split("/")[0]
        case = {"route": r["name"], "ms": r["ms"],
                "speedup_vs_int16": t16 / r["ms"], "vs": "int_conv2d_mma",
                "paper_speedup": FIG4_PAPER.get(bits),
                "cores_ms": r["cores_ms"],
                "cores_speedup_vs_int16": t16_cores / r["cores_ms"]}
        case.update(fig4_instruction_model(text))
        rep["packed"][text] = case
    rep["chunked"] = {
        r["shape"]: {"name": r["name"], "ms": r["ms"],
                     "cores_ms": r["cores_ms"],
                     "library_ms": r["library_ms"],
                     "bound_ms": r["bound_ms"],
                     "chunks": r["geometry"]["chunks"],
                     "chunk_c": r["geometry"]["chunk_c"]}
        for r in rows if r["name"] in ("int_conv2d_mma", "ulppack_conv2d_mma")
        and r["geometry"].get("chunks", 1) > 1}
    print("fig4 " + json.dumps(rep))
    return launches


def cnn_phase(torch, dev, cfg):
    """Full-width sparq-cnn W2A2 (channels 32/32/64, 7x7, 256x256x3, 10
    classes) with random weights from a seed: weights prepared and layer
    plans built once per store, then CNN_BATCHES batches of CNN_BATCH
    random images through ``forward(quant_mode='packed')``.  Fails unless
    the tensor-core K5 with the fused epilogue ran every packed layer, with
    no CUDA-core K5 launch and no plain-version call.  Returns the
    lanes-store tree and plans, two images, and the K5 launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ulppack_conv2d as conv
    from repro_torch.models import cnn

    hw = cfg.cnn_input_hw
    shape = (CNN_BATCH, hw, hw, 3)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = cnn.init_params(cfg, gen, device=dev)
    images = [torch.randn(shape, generator=gen, device=dev)
              for _ in range(CNN_BATCHES)]
    print(f"cnn: {cfg.name} W{cfg.quant.w_bits}A{cfg.quant.a_bits}, "
          f"channels {cfg.cnn_channels}, {cfg.cnn_kernel}x{cfg.cnn_kernel}, "
          f"input {shape}, {cfg.cnn_num_classes} classes, random weights "
          f"(seed {SEED})")
    launches, kept = 0, None
    for store in ("lanes", "dense"):
        packed = cnn.prepare_packed_params(params, cfg, weight_store=store,
                                           x_shape=shape)
        plans = cnn.layer_plans(packed, cfg, shape)
        print(f"cnn plans ({store}): "
              + json.dumps([p.describe() for p in plans]))
        cnn.forward(packed, cfg, images[0], quant_mode="packed",
                    plans=plans)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        conv.reset_counts()
        times, logits = [], []
        for x in images:
            t0 = time.perf_counter()
            logits.append(cnn.forward(packed, cfg, x, quant_mode="packed",
                                      plans=plans))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        k5 = conv.kernel_launches["ulppack_conv2d_mma"]
        fused = conv.mma_launches["affine"]
        cores = conv.kernel_launches["ulppack_conv2d"]
        plain = sum(conv.plain_calls.values())
        if k5 != CNN_BATCHES * len(cfg.cnn_channels) or fused != k5 \
                or cores or plain:
            raise AssertionError(
                f"cnn {store}: {k5} tensor-core K5 launches ({fused} fused), "
                f"{cores} CUDA-core K5 launches, {plain} plain calls on the "
                f"packed path")
        for lg in logits:
            if lg.shape != (CNN_BATCH, cfg.cnn_num_classes) \
                    or not torch.isfinite(lg).all():
                raise AssertionError(f"cnn {store}: bad logits")
        launches += k5
        rep = {"store": store, "batches": CNN_BATCHES, "batch": CNN_BATCH,
               "ms_per_batch": times,
               "median_ms_per_batch": statistics.median(times),
               "images_per_s": CNN_BATCHES * CNN_BATCH * 1e3 / sum(times),
               "median_images_per_s":
                   CNN_BATCH * 1e3 / statistics.median(times),
               "k5_launches": k5, "k5_fused_launches": fused,
               "plain_calls": plain,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cnn.forward(packed, cfg, images[0], quant_mode="packed",
                        plans=plans)
            torch.cuda.synchronize()
        kernels = device_rows(torch, prof)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        rep["device_ms_per_batch"] = busy_ms
        rep["idle_share"] = 1 - busy_ms / rep["median_ms_per_batch"]
        rep["kernel_launches_per_batch"] = sum(e.count for e in kernels)
        rep.update(kernel_groups(kernels, 1, "_per_batch", CNN_GROUPS))
        rep["k5_share"] = rep["k5_ms_per_batch"] / busy_ms if busy_ms \
            else None
        rep["top_kernels_ms"] = [[e.key[:60], e.self_device_time_total / 1e3,
                                  e.count] for e in top]
        print("cnn " + json.dumps(rep))
        if store == "lanes":
            kept = (packed, plans)
    return kept, images[0][:2], launches


def cnn_compare(torch, cfg, packed, plans, x):
    """Kernel path against the plain path on the same weights and images:
    every layer's int32 accumulator (the tensor-core K5's s32 output; and
    lattice and patch sums) bit-equal, every layer's fused-epilogue output
    (``conv_apply`` on the layer's plan: one K5 launch) bit-equal to
    ``conv_epilogue`` on the plain path (``cnn fused-epilogue`` line), and
    the max logit difference of the whole forward."""
    from repro_torch.kernels import ulppack_conv2d as conv
    from repro_torch.models import cnn

    q = cfg.quant
    h = torch.relu(cnn.conv_apply(packed["stem"], x, q))
    fused_rows = []
    for i, (p, plan) in enumerate(zip(packed["layers"], plans)):
        got = cnn.conv_integer_core(p, h, q, plan=plan)
        want = cnn.conv_integer_core(p, h, q, backend="torch")
        for key in ("xq", "acc", "psum"):
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"cnn layer {i}: {key} differs between "
                                     f"the kernel and the plain path")
        conv.reset_counts()
        fused = cnn.conv_apply(p, h, q, quant_mode="packed", plan=plan)
        launches = dict(conv.mma_launches)
        eager = cnn.conv_epilogue(want)
        torch.cuda.synchronize()
        if launches != {"s32": 0, "affine": 1} \
                or not torch.equal(fused, eager):
            raise AssertionError(f"cnn layer {i}: fused epilogue (launches "
                                 f"{launches}) not bit-equal to "
                                 f"conv_epilogue on the plain path")
        fused_rows.append({"layer": i, "shape": list(fused.shape),
                           "bit_equal": True, "launches": launches})
        h = torch.relu(fused)
    print("cnn fused-epilogue " + json.dumps(fused_rows))
    a = cnn.forward(packed, cfg, x, quant_mode="packed", plans=plans)
    b = cnn.forward(packed, cfg, x, quant_mode="packed", backend="torch")
    rep = {"images": int(x.shape[0]), "layers_acc_bit_equal": True,
           "max_logit_diff": float((a - b).abs().max()),
           "argmax_agree": bool(torch.equal(a.argmax(-1), b.argmax(-1)))}
    print("cnn kernel-vs-plain " + json.dumps(rep))
    return rep


def serve_phase(torch, np, dev, cfg):
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, Request, \
        ServingEngine
    from repro_torch.serve.prepare import prepare_serving_params

    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    torch.cuda.synchronize()
    print(f"serve: {cfg.name} W{cfg.quant.w_bits}A"
          f"{cfg.quant.a_bits}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, random weights (seed {SEED}) in "
          f"{time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(max_batch=4, max_len=512, prefill_chunk=16)
    prompts, _ = serve_prompts(np, cfg)
    for kv_bits in (16, 4, 2):
        c = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(c, params, config=ecfg, device=dev)
        if kv_bits == 16:
            distinct = {tuple((k, v) for k, v in r.items() if k != "layer")
                        for r in eng.plan_report()}
            print(f"serve plans: {len(eng.plans)} layer plans, distinct: "
                  f"{[dict(d) for d in sorted(distinct, key=repr)]}")
        reqs = [Request(i, p, max_new_tokens=32)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        for r in reqs[:2]:
            eng.submit(r)
        for _ in range(3):                 # later admissions ride along
            eng.step()
        for r in reqs[2:]:
            eng.submit(r)
        eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for r in reqs:
            if not (r.done and len(r.output) == 32
                    and all(0 <= t < cfg.vocab_size for t in r.output)):
                raise AssertionError(f"kv{kv_bits}: request {r.uid} did not "
                                     f"finish with 32 in-range tokens")
        m = eng.metrics.report()
        cap = eng.capacity_report()
        rep = {"kv_bits": kv_bits, "wall_s": wall,
               "prefill_tok_s": m["prefill_tok_s"],
               "decode_tok_s": m["decode_tok_s"],
               "decode_step_ms": m["decode_step_ms"],
               "steps": m["steps"], "step_graphs": cap["step_graphs"],
               "step_setup_s": cap["step_setup_s"],
               "packed_param_bytes": cap["param_bytes"],
               "cache_bytes": cap["cache_bytes"],
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        print("serve " + json.dumps(rep))
        del eng
        torch.cuda.empty_cache()

    c = cfg.replace(quant=cfg.quant.replace(kv_bits=4))
    profile_decode(torch, c, params, ecfg, prompts, dev)
    profile_prefill(torch, c, params, ecfg, prompts, dev)
    # kernel path vs plain path on the same weights, kv_bits 4
    packed = prepare_serving_params(params, c, device=dev)
    return (c, packed, prompts, steps, lm), params


def profile_decode(torch, cfg, params, ecfg, prompts, dev, label="profile"):
    """Where a decode step's time goes: four pure-decode passes at kv_bits 4
    under torch.profiler -- device kernel time per step (summed over CUDA
    kernels) against the profiled wall time, the top kernels, and the
    attention kernel's share of the device time (K3, or K4 when ``ecfg``
    is paged).  The profiler slows the host, so the idle share here is an
    upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServingEngine

    eng = ServingEngine(cfg, params, config=ecfg, device=dev)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=16))
    while eng.metrics.decode_passes == 0:
        eng.step()
    n = 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = device_rows(torch, prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    rep = {"kv_bits": cfg.quant.kv_bits, "decode_passes": n,
           "graphed": eng._decode.graph is not None,
           "replay_ms_per_step": replay_ms(torch, eng._decode),
           "wall_ms_per_step": wall * 1e3 / n,
           "device_kernel_ms_per_step": busy_us / 1e3 / n,
           "idle_share_upper_bound": 1 - busy_us / 1e6 / wall,
           "kernel_launches_per_step": sum(e.count for e in kernels) / n,
           "attention_kernel_share": sum(
               e.self_device_time_total for e in kernels
               if "attention_decode_kernel" in e.key
               or "attention_tile_kernel" in e.key) / max(1, busy_us),
           **kernel_groups(kernels, n, "_per_step"),
           "top_kernels_ms_per_step": [
               [e.key[:60], e.self_device_time_total / 1e3 / n, e.count // n]
               for e in top]}
    print(f"{label} " + json.dumps(rep))
    del eng
    torch.cuda.empty_cache()


def replay_ms(torch, step, n=8):
    """Device ms of one replay of a step's CUDA graph: ``n`` replays back
    to back between CUDA events, after the step's last call (a replay
    writes the same K/V rows again and reads them back, so it changes
    nothing).  None for a step that runs eagerly."""
    if step.graph is None:
        return None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


LM_GROUPS = {"k2": ("ulppack_matmul",), "k1": ("quant_pack",),
             "elementwise": ("elementwise",), "fill": ("fill", "Fill")}
CNN_GROUPS = {"k5": ("ulppack_conv2d_mma",), "elementwise": ("elementwise",),
              "reduce": ("reduce_kernel",)}


def kernel_groups(kernels, n, suffix, groups=LM_GROUPS):
    """Device ms and launches per pass of each group of profiler rows whose
    kernel names contain one of the group's keys: by default K2 (either
    kernel, K1 folded in or not), the standalone K1, PyTorch's elementwise
    kernels and its fills (zeros)."""
    out = {}
    for g, keys in groups.items():
        sel = [e for e in kernels if any(k in e.key for k in keys)]
        out[f"{g}_ms{suffix}"] = sum(e.self_device_time_total
                                     for e in sel) / 1e3 / n
        out[f"{g}_launches{suffix}"] = sum(e.count for e in sel) / n
    return out


def profile_prefill(torch, cfg, params, ecfg, prompts, dev):
    """Where a prefill chunk's time goes: the four serve prompts admitted
    together, then one profiled engine step -- a chunked-prefill pass of
    max_batch x prefill_chunk rows (64 here) -- device kernel time, the
    host-clock wall time, launches, K2's share and the top kernels, on the
    graphed engine; then the same step on an engine with the eager pair
    set on it (``eager``: wall, device kernel time, launches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps
    from repro_torch.serve.engine import Request, ServingEngine

    for mode in ("graphed", "eager"):
        eng = ServingEngine(cfg, params, config=ecfg, device=dev)
        if mode == "eager":
            eng._decode = steps.make_decode_step(cfg)
            eng._prefill = steps.make_prefill_chunk_step(cfg)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=4))
        eng.step()                      # warm-up: the first chunk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = device_rows(torch, prof)
        busy_us = sum(e.self_device_time_total for e in kernels)
        if mode == "eager":
            rep["eager"] = {"wall_ms": wall * 1e3,
                            "device_kernel_ms": busy_us / 1e3,
                            "kernel_launches": sum(e.count
                                                   for e in kernels)}
        else:
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            rep = {"kv_bits": cfg.quant.kv_bits,
                   "rows": ecfg.max_batch * ecfg.prefill_chunk,
                   "graphed": eng._prefill.graph is not None,
                   "replay_ms": replay_ms(torch, eng._prefill),
                   "wall_ms": wall * 1e3, "device_kernel_ms": busy_us / 1e3,
                   "kernel_launches": sum(e.count for e in kernels),
                   **kernel_groups(kernels, 1, ""),
                   "top_kernels_ms": [[e.key[:60],
                                       e.self_device_time_total / 1e3,
                                       e.count] for e in top[:8]]}
            rep["k2_share"] = rep["k2_ms"] / max(1e-9,
                                                 rep["device_kernel_ms"])
        del eng
        torch.cuda.empty_cache()
    print("prefill profile " + json.dumps(rep))


def check_k2_path(where):
    """Every packed linear since the counts were reset was one launch of
    the tensor-core K2 with K1 folded in and the affine epilogue fused:
    no standalone K1 launch, no plain call, no lanes-route launch (s32 or
    affine), no CUDA-core launch.  Returns the fused launches."""
    from repro_torch.kernels import quant_pack, ulppack_matmul as mm

    mma, core = dict(mm.mma_launches), mm.kernel_launches["ulppack_matmul"]
    plain = mm.plain_calls["ulppack_matmul"] + quant_pack.plain_calls
    k1 = quant_pack.kernel_launches
    if not mma["quant_affine"] or mma["affine"] or mma["s32"] or core \
            or plain or k1:
        raise AssertionError(f"{where}: K2 launches {mma} on the tensor "
                             f"cores, {core} on the CUDA cores, {k1} K1 "
                             f"launches, {plain} plain calls: every packed "
                             f"linear must be one fused launch")
    return mma["quant_affine"]


def paged_phase(torch, np, dev, cfg, params):
    """The paged engine at full width on the serve phase's weights: token
    identity against the unpaged engine at kv_bits 16, 4 and 2 on a
    shared-prefix workload, the fixed-budget capacity run at kv_bits 4,
    and a profile of four paged decode passes.  Fails unless every paged
    read launched K4 (no plain call, no K3 launch).  Returns K4's launches
    on the paged runs."""
    from repro_torch.kernels import quant_pack
    from repro_torch.kernels import ulppack_attention as att
    from repro_torch.kernels import ulppack_matmul as mm
    from repro_torch.serve.engine import EngineConfig, Request, \
        ServingEngine
    from repro_torch.serve.prepare import cache_bytes_per_slot

    def run(c, ecfg, prompts, news, first=0):
        """Serve ``prompts`` greedily, ``news[i]`` new tokens each; the
        first ``first`` are submitted alone and stepped until their prompts
        are done (registered in the prefix index when paged), then the
        rest join."""
        eng = ServingEngine(c, params, config=ecfg, device=dev)
        reqs = [Request(i, p, max_new_tokens=new)
                for i, (p, new) in enumerate(zip(prompts, news))]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for r in reqs[:first]:
            eng.submit(r)
        while not all(r.output for r in reqs[:first]):
            eng.step()
        for r in reqs[first:]:
            eng.submit(r)
        eng.run_to_completion()
        torch.cuda.synchronize()
        for r in reqs:
            if not (r.done and len(r.output) == r.max_new_tokens
                    and all(0 <= t < cfg.vocab_size for t in r.output)):
                raise AssertionError(f"paged phase: request {r.uid} did not "
                                     f"finish with {r.max_new_tokens} "
                                     f"in-range tokens")
        rep = {**eng.metrics.report(), **eng.capacity_report(),
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del eng                 # the next run's peak memory is its own
        torch.cuda.empty_cache()
        return rep, [r.output for r in reqs]

    def paged_run(c, ecfg, prompts, news, first=0):
        att.reset_counts()
        mm.reset_counts()
        quant_pack.reset_counts()
        out = run(c, ecfg, prompts, news, first)
        torch.cuda.synchronize()
        k4 = att.kernel_launches["attention_decode_paged"]
        TILE_LAUNCHES["attention_decode_paged"] += att.tile_launches[
            "attention_decode_paged"]
        if not k4 or any(att.plain_calls.values()) \
                or att.kernel_launches["attention_decode"]:
            raise AssertionError(
                f"paged path: launches {att.kernel_launches}, plain "
                f"{att.plain_calls}: every paged read must launch K4")
        check_k2_path("paged path")
        return (*out, k4)

    def report(name, c, rep, k4, ref):
        line = {"run": name, "kv_bits": c.quant.kv_bits or 16,
                "tokens_equal_unpaged": True,
                **{k: rep[k] for k in (
                    "prefill_tok_s", "decode_tok_s", "decode_step_ms",
                    "steps", "slots", "num_pages", "pages_per_slot",
                    "guaranteed_slots", "peak_live_slot_count",
                    "prefix_hits", "prefix_hit_tokens", "cow_copies",
                    "evicted_pages", "cache_bytes", "hbm_cache_budget",
                    "max_memory_allocated")},
                "k4_launches": k4,
                **{f"unpaged_{k}": ref[k] for k in (
                    "slots", "decode_step_ms", "cache_bytes",
                    "max_memory_allocated")}}
        print("paged " + json.dumps(line))

    launches = 0
    # identity: a prompt registers when it completes, so the 72-token
    # prompt is served alone first; the others join while it decodes
    rng = np.random.default_rng(SEED + 3)
    base = rng.integers(0, cfg.vocab_size, 80).astype(np.int32)
    prompts = [base[:72],
               np.concatenate([base[:64], rng.integers(
                   0, cfg.vocab_size, 20).astype(np.int32)]),
               rng.integers(0, cfg.vocab_size, 28).astype(np.int32),
               base[:80]]
    common = dict(max_len=512, prefill_chunk=16)
    for kv_bits in (16, 4, 2):
        c = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
        cap, got, k4 = paged_run(c, EngineConfig(
            max_batch=4, paged=True, page_size=16, **common), prompts,
            [32] * 4, first=1)
        ref, want = run(c, EngineConfig(max_batch=4, **common), prompts,
                        [32] * 4, first=1)
        if got != want:
            raise AssertionError(f"paged kv{kv_bits}: tokens differ from the "
                                 f"unpaged engine: {got} vs {want}")
        if cap["prefix_hit_tokens"] < 64 or cap["cow_copies"] < 1:
            raise AssertionError(f"paged kv{kv_bits}: prefix hits "
                                 f"{cap['prefix_hit_tokens']}, COW "
                                 f"{cap['cow_copies']}")
        report("identity", c, cap, k4, ref)
        launches += k4

    # capacity: a budget of 4 unpaged kv_bits-4 slots buys 128 pages of 16
    # rows; a 384-token prefix is warmed once, then 16 requests share it
    c = cfg.replace(quant=cfg.quant.replace(kv_bits=4))
    budget = 4 * cache_bytes_per_slot(c, 512)
    prefix = rng.integers(0, cfg.vocab_size, 384).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, 16).astype(np.int32)]) for _ in range(16)]
    cap, got, k4 = paged_run(c, EngineConfig(
        max_batch=16, paged=True, page_size=16, hbm_cache_budget=budget,
        **common), [prefix] + prompts, [1] + [32] * 16, first=1)
    ref, want = run(c, EngineConfig(max_batch=16, **common), prompts,
                    [32] * 16)
    unpaged_slots = EngineConfig(hbm_cache_budget=budget, **common) \
        .slots_for(cache_bytes_per_slot(c, 512))
    if got[1:] != want:
        raise AssertionError("paged capacity run: tokens differ from the "
                             "unpaged engine")
    if cap["peak_live_slot_count"] < 2 * unpaged_slots \
            or cap["prefix_hits"] < 16:
        raise AssertionError(f"paged capacity run: peak live "
                             f"{cap['peak_live_slot_count']} (unpaged "
                             f"{unpaged_slots}), prefix hits "
                             f"{cap['prefix_hits']}")
    report("capacity", c, cap, k4, ref)
    launches += k4

    profile_decode(torch, c, params, EngineConfig(
        max_batch=4, paged=True, page_size=16, **common),
        serve_prompts(np, cfg)[0], dev, label="paged profile")
    return launches


def linear_phase(torch, dev):
    """``benchmarks/serve_microbench.run_linear`` on the card at m = 8,
    k = n = 4096 (its weights and scales): bf16 ``torch.matmul``, int8
    through ``ops.int_matmul`` (K7), packed W1A1 / W2A2 / W3A3 on
    ``int16xP2s8`` and W2A2 / W4A4 on ``int32xP2s16`` through
    ``ops.quantized_linear`` (one launch of the tensor-core K2 with K1
    folded in and the affine epilogue fused), and the exact lattice dot
    through ``ops.quantize_pack`` + ``ops.packed_matmul`` (K1 and the
    lanes route of the tensor-core K2: their path) at W2A2 on
    ``int16xP2s8`` and at W4A4 on ``int32xP2s16``, lanes and the dense
    store (the layout library's lanes-in routes: their path).  Each row is
    driven once with the counts at zero (the expected launches, no plain
    call), then timed by CUDA-graph replay.  Returns the launches of K7,
    K1, the lanes route of the tensor-core K2 and the layout libraries'
    lanes-in routes."""
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import ops, quant_pack, ulppack_matmul

    m, k, n = 8, 4096, 4096
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev) * 0.05
    f32, i32 = torch.float32, torch.int32
    wb16 = w.to(torch.bfloat16)
    w8 = torch.clamp(torch.round(w / 0.01), -127, 127).to(torch.int8)

    def int8():
        q = torch.clamp(torch.round(x / 0.05), -127, 127).to(torch.int8)
        return ops.int_matmul(q, w8)

    paths = [("bf16", lambda: torch.matmul(x.to(torch.bfloat16), wb16),
              wb16.numel() * 2, {}),
             ("int8-unpacked", int8, w8.numel(), {"int_matmul": 1})]
    a_scale = torch.tensor(0.07, dtype=f32, device=dev)
    w_scale = torch.tensor(0.02, dtype=f32, device=dev)
    for text in ("W1A1/int16xP2s8", "W2A2/int16xP2s8", "W3A3/int16xP2s8",
                 "W2A2/int32xP2s16", "W4A4/int32xP2s16"):
        spec = PackSpec.parse(text)
        wb = spec.w_bits
        zp = torch.tensor(1 << (wb - 1), dtype=i32, device=dev)
        wp, cs = ops.prepare_weights(w, w_scale, zp, spec)
        p2s8 = spec.lane_dtype == torch.int16
        tag = f"packed-W{wb}A{spec.a_bits}" + (
            "" if p2s8 else f"-{spec.lane_name}xP{spec.n_pack}s{spec.shift}")
        paths.append((tag, lambda wp=wp, cs=cs, zp=zp, spec=spec:
                      ops.quantized_linear(x, wp, cs, a_scale, zp, w_scale,
                                           zp, spec),
                      wp.numel() * wp.element_size(),
                      {"quantized_linear_mma": 1}))
        if text in ("W2A2/int16xP2s8", "W4A4/int32xP2s16"):
            paths.append((f"{tag}-lattice-dot",
                          lambda wp=wp, zp=zp, spec=spec: ops.packed_matmul(
                              ops.quantize_pack(x, a_scale, zp, spec)[0], wp,
                              spec),
                          wp.numel() * wp.element_size(),
                          {"quantize_pack": 1, "ulppack_matmul_mma": 1}
                          if p2s8 else
                          {"quantize_pack": 1,
                           "ulppack_matmul_mma_lanes": 1}))
        if text == "W4A4/int32xP2s16":
            words, _ = ops.prepare_weights(w, w_scale, zp, spec,
                                           weight_store="dense")
            paths.append((f"{tag}-lattice-dot-dense",
                          lambda words=words, zp=zp, spec=spec:
                          ops.packed_matmul(
                              ops.quantize_pack(x, a_scale, zp, spec)[0],
                              words, spec, weight_store="dense", k_full=k),
                          words.numel() * 4,
                          {"quantize_pack": 1,
                           "ulppack_matmul_mma_lanes": 1}))
    mods = (ulppack_matmul, quant_pack)
    rows = []
    launches = dict.fromkeys(("int_matmul", "quantize_pack",
                              "ulppack_matmul_mma",
                              "ulppack_matmul_mma_lanes"), 0)
    from repro_torch.kernels import build
    for name, fn, wbytes, expect in paths:
        for mod in mods:
            mod.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        mma = ulppack_matmul.mma_launches
        dmma = ulppack_matmul.dense_mma_launches
        lanes_in = sum(v for (lib, route), v in
                       ulppack_matmul.library_launches.items()
                       if lib in build.LAYOUT_VARIANTS
                       and route != "quant_affine")
        routed = mma["s32"] + mma["affine"] + dmma["s32"] + dmma["affine"]
        got = {"ulppack_matmul": ulppack_matmul.kernel_launches[
                   "ulppack_matmul"],
               "ulppack_matmul_mma": routed - lanes_in,
               "ulppack_matmul_mma_lanes": lanes_in,
               "quantized_linear_mma": mma["quant_affine"]
               + dmma["quant_affine"],
               "int_matmul": ulppack_matmul.kernel_launches["int_matmul"],
               "quantize_pack": quant_pack.kernel_launches}
        plain = sum(ulppack_matmul.plain_calls.values()) \
            + quant_pack.plain_calls
        if {kk: v for kk, v in got.items() if v} != expect or plain \
                or out.shape != (m, n) or not torch.isfinite(
                    out.float()).all():
            raise AssertionError(f"linear {name}: launches {got}, plain "
                                 f"{plain}, output {tuple(out.shape)}")
        for kk in launches:
            launches[kk] += got[kk]
        rows.append({"path": name, "ms": time_ms(torch, [fn] * 20),
                     "weight_bytes": wbytes, "launches": expect})
    print("linear " + json.dumps({"m": m, "k": k, "n": n, "rows": rows}))
    return launches


#: Alternated rounds of 8 decode passes of each engine in the ``graphs``
#: lines (a depth cut that keeps the whole script inside its time limit).
GRAPH_ROUNDS, GRAPH_NEW = 2, 8


def step_ptrs(steps, pair, caches):
    """The ``data_ptr()``s of a step pair's static buffers and outputs and
    of the caches it writes."""
    return steps._ptrs([[st.buffers, st.logits] for st in pair]) \
        + steps._ptrs(caches)


def graphs_phase(torch, np, dev, cfg, params):
    """Graphed against op-by-op steps at full width, one ``graphs`` line a
    case: unpaged at kv_bits 16, 4 and 2 (the serve phase's requests) and
    paged at kv_bits 4 with prefix sharing (the paged phase's shared-prefix
    requests).  Two engines a case, one replaying the CUDA graphs it
    captured, one with the eager pair set on it (``make_decode_step`` /
    ``make_prefill_chunk_step``): GRAPH_NEW greedy tokens a request, equal
    (gated), the first decode step's max logit difference, the static
    buffers', outputs' and
    caches' ``data_ptr()``s the same after the run, the capture times, and
    each engine's peak memory above what was allocated before it was built
    (the eager engine's measured after its graphs were dropped).  Then
    four long requests on each, and 8 decode passes of each engine in
    turn, GRAPH_ROUNDS rounds: median wall ms a step (host clock,
    synchronised), then
    4 passes of each under torch.profiler (device kernel ms a step, idle
    share = 1 - device / wall), and the decode graph's replay timed alone
    between CUDA events.  Returns the lines."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps
    from repro_torch.serve.engine import EngineConfig, Request, \
        ServingEngine

    plain_prompts, shared = serve_prompts(np, cfg)
    long_prompts = [np.random.default_rng(SEED + 9).integers(
        0, cfg.vocab_size, n).astype(np.int32) for n in (40, 23, 61, 9)]
    common = dict(max_batch=4, max_len=512, prefill_chunk=16)
    cases = [(16, False), (4, False), (2, False), (4, True)]
    lines = []
    for kv_bits, paged in cases:
        c = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
        ecfg = EngineConfig(**common, **(dict(
            paged=True, page_size=16, prefix_sharing=True) if paged else {}))
        engines, first, mem, outs = {}, {}, {}, {}
        for mode in ("graphed", "eager"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eng = engines[mode] = ServingEngine(c, params, config=ecfg,
                                                device=dev)
            graphed = (eng._decode, eng._prefill)
            if mode == "eager":
                eng._decode = steps.make_decode_step(c)
                eng._prefill = steps.make_prefill_chunk_step(c)
                del graphed
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            else:
                ptrs = step_ptrs(steps, graphed, eng.caches)
            inner = eng._decode

            def spy(*a, _inner=inner, _mode=mode, **k):
                out = _inner(*a, **k)
                if _mode not in first:
                    first[_mode] = out[0].float().clone()
                return out

            eng._decode = spy
            reqs = [Request(i, p, max_new_tokens=GRAPH_NEW)
                    for i, p in enumerate(shared if paged else plain_prompts)]
            if paged:                 # the 72-token prompt registers first
                eng.submit(reqs[0])
                while not reqs[0].output:
                    eng.step()
                for r in reqs[1:]:
                    eng.submit(r)
            else:                     # later admissions ride along
                for r in reqs[:2]:
                    eng.submit(r)
                for _ in range(3):
                    eng.step()
                for r in reqs[2:]:
                    eng.submit(r)
            eng.run_to_completion()
            torch.cuda.synchronize()
            eng._decode = inner
            mem[mode] = torch.cuda.max_memory_allocated() - before
            outs[mode] = [r.output for r in reqs]
        g = engines["graphed"]
        dec, pre = g._decode, g._prefill
        ptrs_fixed = ptrs == step_ptrs(steps, (dec, pre), g.caches)
        if outs["graphed"] != outs["eager"] or not ptrs_fixed:
            raise AssertionError(
                f"graphs kv{kv_bits} paged={paged}: tokens equal "
                f"{outs['graphed'] == outs['eager']}, pointers fixed "
                f"{ptrs_fixed}")
        diff = (first["graphed"] - first["eager"]).abs()
        line = {"kv_bits": kv_bits, "paged": paged,
                "prefix_sharing": paged, "tokens_equal": True,
                "requests": len(outs["graphed"]), "new_tokens": GRAPH_NEW,
                "first_decode_max_logit_diff": float(diff.max()),
                "data_ptrs_fixed": True,
                "decode_replays": dec.replays,
                "prefill_replays": pre.replays,
                "capture_s": {"decode": dec.capture_s,
                              "prefill_chunk": pre.capture_s},
                "engine_step_setup_s": g.step_setup_s,
                "max_memory_allocated": mem}
        if paged:
            cap = g.capacity_report()
            line["prefix_hit_tokens"] = cap["prefix_hit_tokens"]
            line["cow_copies"] = cap["cow_copies"]
        if float(diff.max()):
            top = torch.topk(first["eager"], 2, dim=-1).values
            line["first_decode_top2_margin"] = (top[:, 0] - top[:, 1]).tolist()

        # eager and graphed decode passes in turn, in one call
        for mode, eng in engines.items():
            for i, p in enumerate(long_prompts):
                eng.submit(Request(100 + i, p, max_new_tokens=80))
            eng.step()                       # admits all four
            while any(eng.slot_fed[s] < len(eng.slot_req[s].prompt)
                      for s in range(eng.max_batch)
                      if eng.slot_req[s] is not None):
                eng.step()
        walls = {m: [] for m in engines}
        for r in range(GRAPH_ROUNDS):
            order = list(engines) if r % 2 == 0 else list(engines)[::-1]
            for mode in order:
                eng = engines[mode]
                passes = eng.metrics.decode_passes
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(8):
                    eng.step()
                torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0) * 1e3 / 8)
                if eng.metrics.decode_passes != passes + 8:
                    raise AssertionError("graphs: a timed step was not a "
                                         "decode pass")
        alt = {"rounds": GRAPH_ROUNDS, "passes_per_round": 8}
        for mode, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    eng.step()
                torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3 / 4
            kernels = device_rows(torch, prof)
            dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 4
            wall = statistics.median(walls[mode])
            alt[mode] = {
                "wall_ms_per_step_median": wall,
                "wall_ms_per_step": walls[mode],
                "device_kernel_ms_per_step": dev_ms,
                "kernel_launches_per_step": sum(e.count
                                                for e in kernels) / 4,
                "idle_share": 1 - dev_ms / wall,
                "profiled_wall_ms_per_step": pwall}
        alt["graphed"]["replay_ms_per_step"] = replay_ms(torch, dec)
        alt["decode_tok_s_ratio"] = (alt["eager"]["wall_ms_per_step_median"]
                                     / alt["graphed"][
                                         "wall_ms_per_step_median"])
        line["alternated"] = alt
        print("graphs " + json.dumps(line))
        lines.append(line)
        del engines, eng, g, dec, pre, inner
        torch.cuda.empty_cache()
    return lines


def serve_prompts(np, cfg):
    """The serve phase's four prompts (17-100 tokens) and the paged
    phase's shared-prefix ones (a 72-token prompt, then a 64-token match
    plus 20 others, an unrelated prompt, an 80-token partial-tail match)."""
    rng = np.random.default_rng(SEED)
    plain = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in (17, 33, 64, 100)]
    rng = np.random.default_rng(SEED + 3)
    base = rng.integers(0, cfg.vocab_size, 80).astype(np.int32)
    shared = [base[:72], np.concatenate([base[:64], rng.integers(
                  0, cfg.vocab_size, 20).astype(np.int32)]),
              rng.integers(0, cfg.vocab_size, 28).astype(np.int32),
              base[:80]]
    return plain, shared


def serve_requests(eng, prompts, new, *, paged, uid0=0):
    """Serve ``prompts`` greedily, ``new`` tokens each: paged, the first
    alone until its prompt is done (registered in the prefix index), then
    the rest; else two, three steps, then the rest riding along."""
    from repro_torch.serve.engine import Request

    reqs = [Request(uid0 + i, p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    if paged:
        eng.submit(reqs[0])
        while not reqs[0].output:
            eng.step()
        rest = reqs[1:]
    else:
        for r in reqs[:2]:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        rest = reqs[2:]
    for r in rest:
        eng.submit(r)
    eng.run_to_completion()
    for r in reqs:
        if not (r.done and len(r.output) == new):
            raise AssertionError(f"request {r.uid} did not finish with "
                                 f"{new} tokens")
    return reqs


SPEC_GROUPS = {"k2": ("ulppack_matmul",),
               "attention": ("attention_decode", "attention_tile"),
               "cache_write": ("cache_write",),
               "elementwise": ("elementwise",), "reduce": ("reduce_kernel",),
               "gemm": ("nvjet", "gemm", "Gemm"), "fill": ("fill", "Fill")}


def profile_replay(torch, step, n=2):
    """Device ms and launches a replay of ``step``'s CUDA graph by kernel
    group (``SPEC_GROUPS``; ``other`` the rest), from torch.profiler over
    ``n`` replays."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step.graph.replay()
        torch.cuda.synchronize()
    kernels = device_rows(torch, prof)
    out = {"device_ms": sum(e.self_device_time_total for e in kernels)
           / 1e3 / n,
           "launches": sum(e.count for e in kernels) / n,
           **kernel_groups(kernels, n, "", SPEC_GROUPS)}
    out["other_ms"] = out["device_ms"] - sum(
        out[f"{g}_ms"] for g in SPEC_GROUPS)
    return out


def dense_phase(torch, np, dev, cfg, params):
    """The bit-dense weight store at full width (``dense`` line):
    stablelm-1.6b W2A2, kv 4, graphed, the serve phase's four requests of
    32 tokens on an engine with the lanes store and on one with
    ``dense_store=True``.  Gated: greedy tokens equal and the first decode
    step's logits bit-equal (the dense route is integer-exact into an
    unchanged epilogue), every packed linear of the dense engine one fused
    launch over the words (no launch over lanes, no plain call).
    Recorded: each engine's packed parameter bytes and linear weight
    bytes; then four long requests on each and, 3 rounds in turn, 4
    profiled decode passes of each (device ms a pass, K2's ms in it), and
    each decode graph's replay between CUDA events.  Returns the dense
    kernel's launches on the dense engine's run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import quant_pack, ulppack_matmul as mm
    from repro_torch.serve.engine import EngineConfig, Request, \
        ServingEngine
    from repro_torch.serve.prepare import serving_param_bytes

    c = cfg.replace(quant=cfg.quant.replace(kv_bits=4))
    prompts, _ = serve_prompts(np, cfg)
    engines, outs, first, line = {}, {}, {}, {"kv_bits": 4}
    launches = 0
    for store in ("lanes", "dense"):
        eng = engines[store] = ServingEngine(c, params, config=EngineConfig(
            max_batch=4, max_len=512, prefill_chunk=16,
            dense_store=store == "dense"), device=dev)
        inner = eng._decode

        def spy(*a, _inner=inner, _store=store, **k):
            out = _inner(*a, **k)
            if _store not in first:
                first[_store] = out[0].float().clone()
            return out

        eng._decode = spy
        mm.reset_counts()
        quant_pack.reset_counts()
        outs[store] = [r.output for r in serve_requests(eng, prompts, 32,
                                                        paged=False)]
        torch.cuda.synchronize()
        eng._decode = inner
        if store == "dense":
            launches = mm.dense_mma_launches["quant_affine"]
            other = (sum(mm.mma_launches.values())
                     + mm.dense_mma_launches["s32"]
                     + mm.dense_mma_launches["affine"]
                     + mm.kernel_launches["ulppack_matmul"]
                     + mm.plain_calls["ulppack_matmul"]
                     + quant_pack.kernel_launches + quant_pack.plain_calls)
            if not launches or other:
                raise AssertionError(
                    f"dense path: K2 {mm.mma_launches} over lanes, "
                    f"{mm.dense_mma_launches} over words, K1 "
                    f"{quant_pack.kernel_launches}: every packed linear "
                    f"must be one fused launch over the words")
        else:
            check_k2_path("dense phase, lanes")
        cap = eng.capacity_report()
        weights = [node["w_dense" if store == "dense" else "w_packed"]
                   for node in packed_nodes(eng.params)]
        line.setdefault("packed_param_bytes", {})[store] = cap["param_bytes"]
        line.setdefault("linear_weight_bytes", {})[store] = \
            serving_param_bytes(weights)
        line.setdefault("decode_step_ms", {})[store] = \
            eng.metrics.report()["decode_step_ms"]
    diff = float((first["dense"] - first["lanes"]).abs().max())
    if outs["dense"] != outs["lanes"] or diff != 0.0:
        raise AssertionError(f"dense: tokens equal "
                             f"{outs['dense'] == outs['lanes']}, first "
                             f"decode logit difference {diff}")
    line.update(tokens_equal=True, first_decode_max_logit_diff=diff,
                dense_k2_launches=launches)
    long_prompts = [np.random.default_rng(SEED + 9).integers(
        0, cfg.vocab_size, n).astype(np.int32) for n in (40, 23, 61, 9)]
    for eng in engines.values():
        for i, p in enumerate(long_prompts):
            eng.submit(Request(100 + i, p, max_new_tokens=80))
        eng.step()
        while any(eng.slot_fed[s] < len(eng.slot_req[s].prompt)
                  for s in range(eng.max_batch)
                  if eng.slot_req[s] is not None):
            eng.step()
    dev_ms = {store: [] for store in engines}
    k2_ms = {store: [] for store in engines}
    for r in range(3):
        order = list(engines) if r % 2 == 0 else list(engines)[::-1]
        for store in order:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    engines[store].step()
                torch.cuda.synchronize()
            kernels = device_rows(torch, prof)
            dev_ms[store].append(sum(e.self_device_time_total
                                     for e in kernels) / 1e3 / 4)
            k2_ms[store].append(kernel_groups(kernels, 4, "")["k2_ms"])
    line["alternated"] = {
        "rounds": 3, "passes_per_round": 4,
        "device_ms_per_pass": dev_ms, "k2_ms_per_pass": k2_ms,
        "device_ms_per_pass_median": {k: statistics.median(v)
                                      for k, v in dev_ms.items()},
        "k2_ms_per_pass_median": {k: statistics.median(v)
                                  for k, v in k2_ms.items()},
        "decode_replay_ms": {k: replay_ms(torch, e._decode)
                             for k, e in engines.items()}}
    print("dense " + json.dumps(line))
    del engines, eng
    torch.cuda.empty_cache()
    return launches


# W4A4, the paper's 4-bit point: int32xP2s16 is its only layout
# (``packing.layout_family(4, 4)``).
W4A4_QUANT = dict(w_bits=4, a_bits=4, lane_dtype="int32", kv_bits=4)
W4A4_NEW = 8
#: the serve prompts cut to their first W4A4_PROMPT tokens (17, 24, 24, 24)
W4A4_PROMPT = 24
W4A4_ECFG = dict(max_batch=4, max_len=512, prefill_chunk=16)


def w4a4_config(cfg):
    return cfg.replace(quant=cfg.quant.replace(**W4A4_QUANT))


def w4a4_phase(torch, np, dev, cfg):
    """The ``serve w4a4`` lines: ``cfg`` (stablelm-1.6b, whole) at W4A4
    int32 (int32xP2s16 lanes), kv 4, seed-0 weights, the serve cell's
    ``EngineConfig``, the serve prompts cut to W4A4_PROMPT tokens with
    W4A4_NEW greedy tokens each on
    a graphed engine, with the lanes store and then the dense store, each
    against an engine on ``backend='torch'`` over the same store: tokens
    (gated, see below), the largest decode logit difference; every
    packed linear one fused launch of the tensor-core K2 -- the
    int32xP2s16 library over lanes, the w_bits-4 dense library over words
    -- with no CUDA-core K2, no standalone K1 and no plain call (gated).
    Records decode ms a pass (wall, and the graph's replay on the device),
    the graph's device ms by kernel group, K2 launches by route and by
    library, param bytes.  The tokens are gated under the ``spec``
    lines' rule: a request may part from ``'torch'`` only where the
    plain row's top-2 margin is at most 2 x the rows' difference (the
    line lists each parting and the first decode pass's logit
    difference).  Returns the fused launches of each store's graphed
    run."""
    from repro_torch.kernels import cache_write, quant_pack, \
        ulppack_attention, ulppack_matmul as mm
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    c = w4a4_config(cfg)
    t0 = time.perf_counter()
    params = lm.init_params(c, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = [p[:W4A4_PROMPT] for p in serve_prompts(np, c)[0]]
    w4a4_attribution(torch, np, dev, c, params, prompts)
    launches = {}
    for store in ("lanes", "dense"):
        ecfg = EngineConfig(**W4A4_ECFG, dense_store=store == "dense")
        for mod in (quant_pack, mm, ulppack_attention, cache_write):
            mod.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        eng = ServingEngine(c, params, config=ecfg, device=dev)
        t0 = time.perf_counter()
        outs, rows, passes = recorded_serve(np, eng, prompts, W4A4_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        routes = dict(mm.dense_mma_launches if store == "dense"
                      else mm.mma_launches)
        others = dict(mm.mma_launches if store == "dense"
                      else mm.dense_mma_launches)
        libs = {}
        for (name, _), v in mm.library_launches.items():
            if v:
                libs[name] = libs.get(name, 0) + v
        lib = ("ulppack_matmul_mma_w4" if store == "dense"
               else "ulppack_matmul_mma_int32xP2s16")
        core, k1 = mm.kernel_launches["ulppack_matmul"], \
            quant_pack.kernel_launches
        plain = mm.plain_calls["ulppack_matmul"] + quant_pack.plain_calls
        if not routes["quant_affine"] or routes["s32"] or routes["affine"] \
                or any(others.values()) or core or k1 or plain \
                or libs != {lib: routes["quant_affine"]} \
                or not ulppack_attention.kernel_launches["attention_decode"]:
            raise AssertionError(
                f"serve w4a4 {store}: K2 {routes} (other store {others}), by "
                f"library {libs}, CUDA-core K2 {core}, K1 {k1}, plain "
                f"{plain}: every packed linear must be one fused launch of "
                f"{lib}")
        launches[store] = routes["quant_affine"]
        m, cap = eng.metrics.report(), eng.capacity_report()
        replay = statistics.median(replay_ms(torch, eng._decode)
                                   for _ in range(5))
        groups = profile_replay(torch, eng._decode)
        line = {"card": torch.cuda.get_device_name(0), "store": store,
                "spec": "W4A4/int32xP2s16", "kv_bits": 4,
                "layers": c.num_layers, "d_model": c.d_model,
                "wall_s": wall, "steps": m["steps"],
                "decode_passes": eng.metrics.decode_passes,
                "decode_step_ms_wall": m["decode_step_ms"],
                "decode_replay_ms": replay,
                "idle_share": 1 - replay / m["decode_step_ms"],
                "decode_tok_s": m["decode_tok_s"],
                "graph_device_ms_by_group": groups,
                "k2_launches_by_route": routes,
                "k2_launches_by_library": libs,
                "cuda_core_k2_launches": core, "standalone_k1_launches": k1,
                "step_setup_s": cap["step_setup_s"],
                "param_bytes": cap["param_bytes"],
                "cache_bytes": cap["cache_bytes"], "init_params_s": init_s}
        del eng
        torch.cuda.empty_cache()
        ref = ServingEngine(c, params, config=ecfg, device=dev,
                            backend="torch")
        ref_outs, ref_rows, ref_passes = recorded_serve(np, ref, prompts,
                                                        W4A4_NEW)
        del ref
        torch.cuda.empty_cache()
        # the margin rule: K3 is within ATTN_TOL of its plain version, not
        # bit-equal, and a 4-bit activation lattice turns one bf16 ulp of
        # an attention output into a lattice step more often than a 2-bit
        # one; an exact tie in the reference's row then parts the tokens
        parted = token_divergences(np, f"serve w4a4 {store}", ref_outs,
                                   ref_rows, outs, rows, strict=False)
        line.update(tokens_equal=outs == ref_outs, requests=len(outs),
                    new_tokens=W4A4_NEW, divergences=parted,
                    first_decode_max_logit_diff=float(
                        (passes[0] - ref_passes[0]).abs().max()),
                    max_logit_diff_vs_torch=max_pass_diff(passes,
                                                          ref_passes))
        print("serve w4a4 " + json.dumps(line))
    del params
    torch.cuda.empty_cache()
    return launches


def w4a4_only(torch, np, peaks, smi):
    """``python3 chip_smoke.py --w4a4``: the every-layout lines alone -- the K2
    rows at every other layout, the Fig. 4 and CNN conv rows with the
    ``fig4`` line, the ``linear`` line and the ``serve w4a4`` lines."""
    from repro_torch import configs

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = layout_k2_rows(torch, peaks, dev, gen)
    conv_rows, fig4 = conv_kernel_phase(torch, peaks, dev,
                                        configs.get_config("sparq-cnn"))
    rows += conv_rows
    for r in rows:
        print("kernel " + json.dumps(r))
    fig4_phase(torch, fig4, rows)
    del fig4
    linear_phase(torch, dev)
    w4a4_phase(torch, np, dev, configs.get_config("stablelm-1.6b"))
    print(smi)


def w4a4_attribution(torch, np, dev, c, params, prompts):
    """Where the W4A4 kernel path's logits part from 'torch': the
    ``kernel-vs-plain w4a4`` line (``compare_backends`` on the W4A4 lanes
    params), then ``kernel-vs-plain w4a4 plain-k3`` -- the same with K3 /
    K4's 'cuda' registration pointed at their plain version, so that only
    the tensor-core K2 (bit-equal to its plain version) and the window
    write (byte-equal) stay on the kernel path: its every logit must
    equal 'torch''s (gated).  K3 is within ATTN_TOL of its plain version,
    not bit-equal; the first line shows what that does to W4A4 logits."""
    from repro_torch.kernels import plan as plan_lib
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serve.prepare import prepare_serving_params

    packed = prepare_serving_params(params, c, device=dev)
    compare_backends(torch, np, dev, c, packed, prompts, steps, lm,
                     label="kernel-vs-plain w4a4", decode=2)
    key = ("attention_decode", "cuda")
    k3 = plan_lib._BACKENDS[key]
    plan_lib._BACKENDS[key] = plan_lib._BACKENDS[("attention_decode",
                                                  "torch")]
    try:
        rep = compare_backends(torch, np, dev, c, packed, prompts, steps, lm,
                               label="kernel-vs-plain w4a4 plain-k3",
                               decode=2)
    finally:
        plan_lib._BACKENDS[key] = k3
    if rep["max_logit_diff"] != 0.0:
        raise AssertionError(f"kernel-vs-plain w4a4 plain-k3: the W4A4 K2 "
                             f"path parts from 'torch' by "
                             f"{rep['max_logit_diff']} with K3 on its plain "
                             f"version")
    del packed
    torch.cuda.empty_cache()


def w4a4_pass(torch, np, src):
    """``python3 chip_smoke.py --w4a4-pass SRC``: the graphed W4A4 decode
    pass of the package under ``SRC`` (this checkout's ``src``, or another
    tree's, unpacked beside it: the comparison of two trees in one call).
    stablelm-1.6b whole at W4A4 int32, kv 4, lanes, the serve cell's
    ``EngineConfig``, seed-0 weights: the serve prompts admitted and
    prefilled, then 5 rounds of the decode graph's replay (device ms a
    pass between CUDA events) and one profiled pair of replays (device ms
    and launches by kernel group).  Prints a ``w4a4 pass`` line."""
    from repro_torch import configs
    from repro_torch.kernels import quant_pack, ulppack_matmul as mm
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, Request, \
        ServingEngine

    dev = torch.device("cuda")
    c = w4a4_config(configs.get_config("stablelm-1.6b"))
    params = lm.init_params(c, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    eng = ServingEngine(c, params, config=EngineConfig(**W4A4_ECFG),
                        device=dev)
    prompts, _ = serve_prompts(np, c)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=64))
    while any(eng.slot_req[s] is not None
              and eng.slot_fed[s] < len(eng.slot_req[s].prompt)
              for s in range(eng.max_batch)) or not all(
            eng.slot_req[s] is not None for s in range(eng.max_batch)):
        eng.step()
    for _ in range(2):
        eng.step()
    mm.reset_counts()
    quant_pack.reset_counts()
    replays = [replay_ms(torch, eng._decode) for _ in range(5)]
    groups = profile_replay(torch, eng._decode)
    print("w4a4 pass " + json.dumps({
        "src": str(src), "card": torch.cuda.get_device_name(0),
        "decode_replay_ms": replays,
        "decode_replay_ms_median": statistics.median(replays),
        "graph_device_ms_by_group": groups}))
    return 0


def packed_nodes(tree):
    """The packed Dense leaves (dicts with ``col_sums``) of a param tree."""
    if isinstance(tree, dict):
        if "col_sums" in tree:
            yield tree
            return
        for v in tree.values():
            yield from packed_nodes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from packed_nodes(v)


#: Speculative cases at full width, kv 4, k = 4: (name, EngineConfig
#: fields, paged): a W2 draft in lanes (the target's bits: its steps
#: kept), a W1 draft over the dense store (target dense too), and paged
#: with a shared prefix and a W2 draft (the first-token stash path).
SPEC_K = 4
#: Greedy tokens a request on the spec lines' engines
SPEC_NEW = 16
SPEC_CASES = (("w2-lanes", dict(draft_w_bits=2), False),
              ("w1-dense", dict(draft_w_bits=1, dense_store=True), False),
              ("w2-paged-shared", dict(draft_w_bits=2), True))


def spec_phase(torch, np, dev, cfg, params):
    """Speculative decoding at full width (``spec`` lines): stablelm-1.6b
    W2A2, kv 4, k = 4, each of ``SPEC_CASES`` against the plain graphed
    engine of the same config on the same requests (the serve phase's, or
    paged the shared-prefix ones), SPEC_NEW tokens each.

    The token gate: the plain engine records the logits row behind every
    token it emits; the speculative engine records the verify window's
    rows (and its prefill rows).  Up to a request's first divergence from
    plain decode every such row is teacher-forced on the plain engine's
    tokens; ``verify_vs_decode_max_diff`` is the largest difference of a
    verify row from the plain row at the same position.  A divergence
    fails the phase unless the plain logits' top-2 margin there is at most
    2 x the difference of the two rows that chose the tokens; each is
    printed with its margin.  Also gated: every draft step's writes stay
    inside the slot's reserved extent (dead rows at limit -1), the draft
    pool drains (paged), pointers stay fixed, every step a graph replay
    with the hand-written kernels and no plain call, and a failed capture
    raises (on the reduced config).  Recorded: acceptance, cycles, drafted
    tokens, decode tok/s against plain in two alternated rounds, wall ms a
    cycle, the draft and verify graphs' replay ms and their device ms by
    kernel group (torch.profiler), capture s, peak memory, the draft's
    param bytes, launches a cycle.  Returns the launches of the fused K2
    (over lanes and over words) and the attention kernels on the spec
    engines' runs."""
    from repro_torch.kernels import cache_write, quant_pack
    from repro_torch.kernels import ulppack_attention as att
    from repro_torch.kernels import ulppack_matmul as mm
    from repro_torch.launch import steps
    from repro_torch.serve import speculative
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    c = cfg.replace(quant=cfg.quant.replace(kv_bits=4))
    plain_prompts, shared = serve_prompts(np, cfg)
    new = SPEC_NEW
    totals = {"quantized_linear_mma": 0, "quantized_linear_mma_dense": 0,
              "attention_decode": 0, "attention_decode_paged": 0}
    for name, extra, paged in SPEC_CASES:
        common = dict(max_batch=4, max_len=512, prefill_chunk=16,
                      dense_store=extra.get("dense_store", False),
                      **(dict(paged=True, page_size=16, prefix_sharing=True)
                         if paged else {}))
        prompts = shared if paged else plain_prompts
        mem, rows, engines = {}, {}, {}
        for mode in ("plain", "spec"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ecfg = EngineConfig(**common, **(dict(
                speculative_k=SPEC_K, draft_w_bits=extra["draft_w_bits"])
                if mode == "spec" else {}))
            eng = engines[mode] = ServingEngine(c, params, config=ecfg,
                                                device=dev)
            mem[mode] = torch.cuda.max_memory_allocated() - before
        plain, spec = engines["plain"], engines["spec"]
        st = {"decode": spec._decode, "prefill_chunk": spec._prefill,
              "verify": spec._verify, "draft_prefill": spec.spec.prefill_step,
              "draft": spec.spec.draft_step}
        if not all(s.graph is not None for s in st.values()):
            raise AssertionError(f"spec {name}: a step is not a graph")
        ptrs = steps._ptrs([[s.buffers, s.logits] for s in st.values()]) \
            + steps._ptrs([spec.caches, spec.spec.caches])

        # round 1: the plain engine, recording the row behind each token
        rec = {"plain": {}, "spec": {}}

        def record(eng, mode):
            real = eng._emit_token

            def emit(s, logits_row, *, decode_pass, _real=real):
                req = eng.slot_req[s]
                rec[mode][(req.uid, len(req.output))] = np.array(
                    logits_row, np.float32)
                return _real(s, logits_row, decode_pass=decode_pass)

            eng._emit_token = emit
            return real

        real = record(plain, "plain")
        outs = {"plain": [r.output for r in serve_requests(
            plain, prompts, new, paged=paged)]}
        plain._emit_token = real
        # round 1: the speculative engine, recording its verify windows
        # and checking every draft step's extent
        real_emit = record(spec, "spec")
        verify, draft = spec._verify, spec.spec.draft_step
        extent_ok = [True]

        def verify_spy(params_, caches, batch, index, valid, *bt):
            out = verify(params_, caches, batch, index, valid, *bt)
            lg = out[0].float().cpu().numpy()
            for s in range(spec.max_batch):
                req = spec.slot_req[s]
                if req is not None:
                    for j in range(int(valid[s])):
                        rec["spec"][(req.uid, len(req.output) + j,
                                     "verify")] = lg[s, j]
            return out

        def draft_spy(params_, caches, batch, index, limit, *bt):
            for s in range(spec.max_batch):
                req = spec.slot_req[s]
                top = (-1 if req is None else
                       len(req.prompt) + req.max_new_tokens - 2)
                if (req is None and limit[s] != -1) or (
                        req is not None and index[s] + limit[s] > top):
                    extent_ok[0] = False
            return draft(params_, caches, batch, index, limit, *bt)

        spec._verify, spec.spec.draft_step = verify_spy, draft_spy
        for mod in (mm, quant_pack, att, cache_write):
            mod.reset_counts()
        outs["spec"] = [r.output for r in serve_requests(
            spec, prompts, new, paged=paged)]
        torch.cuda.synchronize()
        spec._verify, spec.spec.draft_step = verify, draft
        spec._emit_token = real_emit
        fused = mm.dense_mma_launches if extra.get("dense_store") \
            else mm.mma_launches
        attn = att.kernel_launches["attention_decode_paged" if paged
                                   else "attention_decode"]
        plain_calls = (mm.plain_calls["ulppack_matmul"]
                       + quant_pack.plain_calls
                       + sum(att.plain_calls.values())
                       + cache_write.plain_calls["cache_write"])
        if not fused["quant_affine"] or not attn or plain_calls \
                or quant_pack.kernel_launches \
                or not cache_write.kernel_launches["cache_write"]:
            raise AssertionError(
                f"spec {name}: K2 {fused}, attention {att.kernel_launches}, "
                f"cache_write {cache_write.kernel_launches}, plain calls "
                f"{plain_calls}: every step must replay the kernels")
        totals["quantized_linear_mma_dense" if extra.get("dense_store")
               else "quantized_linear_mma"] += fused["quant_affine"]
        totals["attention_decode_paged" if paged
               else "attention_decode"] += attn
        m1 = {mode: e.metrics.report() for mode, e in engines.items()}
        snap = {mode: (e.metrics.decode_tokens, e.metrics.decode_time_s)
                for mode, e in engines.items()}

        # the gate: teacher-forced rows up to each first divergence
        divergences, vdiff = [], 0.0
        for uid, (p_out, s_out) in enumerate(zip(outs["plain"],
                                                 outs["spec"])):
            at = next((i for i in range(new) if p_out[i] != s_out[i]), new)
            for pos in range(min(at + 1, new)):
                row = rec["spec"].get((uid, pos, "verify"))
                if row is not None:
                    vdiff = max(vdiff, float(np.abs(
                        row - rec["plain"][(uid, pos)]).max()))
            if at < new:
                p_row = rec["plain"][(uid, at)]
                s_row = rec["spec"].get((uid, at, "verify"),
                                        rec["spec"].get((uid, at)))
                diff = float(np.abs(s_row - p_row).max())
                top2 = np.sort(p_row)[-2:]
                margin = float(top2[1] - top2[0])
                divergences.append({"request": uid, "at": at,
                                    "plain": int(p_out[at]),
                                    "spec": int(s_out[at]),
                                    "top2_margin": margin,
                                    "row_diff": diff})
                print(f"spec {name}: request {uid} parts from plain decode "
                      f"at token {at} (plain {p_out[at]}, speculative "
                      f"{s_out[at]}), plain top-2 margin {margin:.4g}, "
                      f"row difference {diff:.4g}")
                if margin > 2 * diff:
                    raise AssertionError(
                        f"spec {name}: request {uid} diverges at {at} with "
                        f"a top-2 margin {margin} above 2 x the row "
                        f"difference {diff}")
        drained = (not paged or spec.spec.pool.report()["free_pages"]
                   == spec.spec.num_pages)
        ptrs_fixed = ptrs == steps._ptrs(
            [[s.buffers, s.logits] for s in st.values()]) \
            + steps._ptrs([spec.caches, spec.spec.caches])
        if not (extent_ok[0] and drained and ptrs_fixed):
            raise AssertionError(f"spec {name}: draft extent kept "
                                 f"{extent_ok[0]}, draft pool drained "
                                 f"{drained}, pointers fixed {ptrs_fixed}")

        # round 2, the other way round: decode tok/s of each
        for mode in ("spec", "plain"):
            serve_requests(engines[mode], prompts, new, paged=paged,
                           uid0=100)
        tok_s = {mode: [m1[mode]["decode_tok_s"],
                        (e.metrics.decode_tokens - snap[mode][0])
                        / (e.metrics.decode_time_s - snap[mode][1])]
                 for mode, e in engines.items()}
        prof = {k: profile_replay(torch, st[k]) for k in ("draft", "verify")}
        rep = m1["spec"]
        cap = spec.capacity_report()
        line = {"case": name, "k": SPEC_K, "kv_bits": 4, "paged": paged,
                "dense_store": common["dense_store"],
                "draft_w_bits": extra["draft_w_bits"],
                "requests": len(prompts), "new_tokens": new,
                "tokens_equal": outs["spec"] == outs["plain"],
                "divergences": divergences,
                "verify_vs_decode_max_diff": vdiff,
                "acceptance_rate": rep["acceptance_rate"],
                "spec_cycles": rep["spec_cycles"],
                "drafted_tokens": rep["drafted_tokens"],
                "accepted_tokens": rep["accepted_tokens"],
                "decode_tok_s": tok_s["spec"],
                "plain_decode_tok_s": tok_s["plain"],
                "cycle_ms": rep["decode_step_ms"],
                "plain_decode_step_ms": m1["plain"]["decode_step_ms"],
                "draft_graph_ms": replay_ms(torch, st["draft"]),
                "verify_graph_ms": replay_ms(torch, st["verify"]),
                "plain_decode_graph_ms": replay_ms(torch, plain._decode),
                "draft_profile": prof["draft"],
                "verify_profile": prof["verify"],
                "launches_per_cycle": prof["draft"]["launches"]
                + prof["verify"]["launches"],
                "capture_s": {k: s.capture_s for k, s in st.items()},
                "step_setup_s": cap["step_setup_s"],
                "max_memory_allocated": mem,
                "param_bytes": cap["param_bytes"],
                "draft_param_bytes": cap["speculative"]["draft_param_bytes"],
                "draft_extent_kept": True, "data_ptrs_fixed": True,
                "k2_launches": fused["quant_affine"],
                "attention_launches": attn}
        if paged:
            line.update(draft_pool_drained=True,
                        draft_num_pages=cap["speculative"]["draft_num_pages"],
                        prefix_hit_tokens=cap["prefix_hit_tokens"])
        print("spec " + json.dumps(line))
        del engines, plain, spec, st, rec, eng
        torch.cuda.empty_cache()
    spec_capture_failure(torch, dev)
    return totals


def spec_capture_failure(torch, dev):
    """A speculative engine whose draft step fails during capture raises
    at construction (on the reduced config): nothing falls back to eager
    steps."""
    from repro_torch import configs
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    cfg = configs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2, kv_bits=4))
    params = lm.init_params(cfg, device=dev)
    real = steps.StaticStep.run

    def run(self):
        if self.kind == "draft" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch refused under capture")
        return real(self)

    steps.StaticStep.run = run
    try:
        ServingEngine(cfg, params, config=EngineConfig(
            max_batch=2, max_len=32, prefill_chunk=4, speculative_k=SPEC_K),
            device=dev)
    except RuntimeError as e:
        print(f"spec capture failure: raised ({str(e)[:60]})")
    else:
        raise AssertionError("a failed draft capture did not raise")
    finally:
        steps.StaticStep.run = real
    torch.cuda.synchronize()


def compare_backends(torch, np, dev, c, packed, prompts, steps, lm,
                     label="kernel-vs-plain", decode=8):
    """One 16-token prefill chunk of the prompts and ``decode`` greedy
    decode steps on the eager steps, the kernels' backend ('auto') beside
    'torch' on the same weights: each step's largest logit difference and
    whether the greedy tokens agree (a ``label`` line)."""
    width = 16
    tokens = np.stack([p[:width] for p in prompts])
    b = tokens.shape[0]
    caches = {be: lm.init_caches(c, b, 512, device=dev)
              for be in ("auto", "torch")}
    pre = {be: steps.make_prefill_chunk_step(c, backend=be)
           for be in caches}
    dec = {be: steps.make_decode_step(c, backend=be) for be in caches}
    index = np.zeros(b, np.int32)
    valid = np.full(b, width, np.int32)
    out = {be: pre[be](packed, caches[be], {"tokens": tokens}, index,
                       valid)[0].float() for be in caches}
    diffs, agree = [], []
    for i in range(decode + 1):
        diffs.append(float((out["auto"] - out["torch"]).abs().max()))
        nxt = out["auto"].argmax(dim=-1)
        agree.append(bool(torch.equal(nxt, out["torch"].argmax(dim=-1))))
        if not torch.isfinite(out["auto"]).all():
            raise AssertionError("non-finite logits on the kernel path")
        if i == decode:
            break
        tok = nxt.cpu().numpy().astype(np.int32)[:, None]
        ix = np.full(b, width + i, np.int32)
        one = np.ones(b, np.int32)
        out = {be: dec[be](packed, caches[be], {"tokens": tok}, ix,
                           one)[0].float() for be in caches}
    rep = {"kv_bits": c.quant.kv_bits,
           "steps": f"1 prefill chunk + {decode} decode",
           "max_logit_diff": max(diffs), "per_step_max_logit_diff": diffs,
           "greedy_agree_per_step": agree}
    print(f"{label} " + json.dumps(rep))
    return rep


# ---------------------------------------------------------------------------
# Training: the train, train profile, train-serve, train-ckpt and cnn-qat
# lines
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 128, 4
TRAIN_KW = dict(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
TRAIN_GROUPS = {"gemm": ("nvjet", "gemm", "Gemm"),
                "elementwise": ("elementwise",),
                "reduce": ("reduce_kernel",), "softmax": ("softmax",),
                "fill": ("fill", "Fill")}
# profiler ranges of the port (core/quant.py, models/attention.py,
# launch/steps.py) and the backward nodes of the attention's products
TRAIN_RANGES = {"fake_quant": ("fake_quant",),
                "attention": ("attention", "BmmBackward0",
                              "SoftmaxBackward0"),
                "optimizer": ("optimizer",)}
CKPT_LAYERS, CKPT_STEPS = 1, 4
#: The last ``train`` line's report (``train compress`` prints its steps
#: beside its own).
TRAIN_LINE: dict = {}
CNN_QAT_STEPS, CNN_QAT_TEST = 300, 64


def scratch_dir(name: str) -> Path:
    """An empty directory under the checkout's git-ignored build/."""
    d = Path(__file__).resolve().parent / "build" / name
    shutil.rmtree(d, ignore_errors=True)
    return d


def dir_bytes(d: Path) -> int:
    return sum(f.stat().st_size for f in d.rglob("*") if f.is_file())


def same_bits(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def trees_equal(torch, a, b) -> bool:
    from repro_torch import tree as tree_lib

    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    return len(la) == len(lb) and all(same_bits(torch, x, y)
                                      for x, y in zip(la, lb))


def train_stream(cfg):
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream

    return SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=SEED))


def train_phase(torch, dev, cfg, peaks, smi):
    """TRAIN_STEPS eager train steps of ``cfg`` at full width from seed-0
    params (the config's remat and microbatches, f32 moments): per step
    loss, ce, grad_norm, lr and host-clock ms; the median step, tokens/s,
    peak memory and the model-FLOP share 6 * params * tokens / step s over
    the bf16 dense peak.  Fails unless every loss and gradient norm is
    finite.  Returns (state, the step function, the stream)."""
    from repro_torch import tree as tree_lib
    from repro_torch.launch import steps
    from repro_torch.models import lm

    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    n_params = sum(p.numel() for p in tree_lib.leaves(params))
    state = steps.make_train_state(params, cfg=cfg)
    del params
    step_fn = steps.make_train_step(cfg, **TRAIN_KW)
    data = train_stream(cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rows, ms = [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch_at(i)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        rows.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    bad = [i for i, r in enumerate(rows)
           if not (math.isfinite(r["loss"]) and math.isfinite(r["ce"])
                   and math.isfinite(r["grad_norm"]))]
    if bad:
        raise AssertionError(f"train: non-finite loss or grad_norm at "
                             f"steps {bad}: {rows}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(ms)
    rep = {"card": smi, "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "w_bits": cfg.quant.w_bits,
           "a_bits": cfg.quant.a_bits, "remat": cfg.parallel.remat,
           "microbatches": cfg.parallel.microbatches,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "schedule": "cosine", **TRAIN_KW, "params": n_params,
           "setup_s": setup_s,
           "per_step": [dict(r, step=i, ms=t)
                        for i, (r, t) in enumerate(zip(rows, ms))],
           "median_step_ms": med, "tokens_per_s": tokens * 1e3 / med,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "model_flop_share": 6 * n_params * tokens / (med / 1e3)
           / peaks["bf16"],
           "peak_for_share": f"bf16 dense {peaks['bf16'] / 1e12:.0f} "
                             f"TFLOP/s (data sheet)",
           "finite": True}
    print("train " + json.dumps(rep))
    TRAIN_LINE.update(rep)
    return state, step_fn, data


def train_profile(torch, state, step_fn, data):
    """One more train step under torch.profiler (``profile_train_step``),
    printed as the ``train profile`` line.  Returns the state."""
    state, rep = profile_train_step(torch, state, step_fn,
                                    data.batch_at(TRAIN_STEPS))
    print("train profile " + json.dumps(rep))
    return state


def profile_train_step(torch, state, step_fn, batch, ranges=TRAIN_RANGES):
    """One train step under torch.profiler: device ms and launches of the
    step's kernels, by kernel name (GEMMs, elementwise, reductions,
    softmax, fills) and by the port's profiler ranges (``_range_ms``: the
    kernels launched inside each of ``ranges`` -- by default the fake
    quant's forward and backward, the attention's forward plus its
    products' backward nodes, the optimizer; ranges overlap the name
    groups; ``_gpu_span_ms``: the device time each range spans, gaps
    included), from the profiler's events (``device_rows``,
    ``range_rows``).  The profiler slows the host, so its idle share is
    an upper bound.  Returns (the state, the report)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = device_rows(torch, prof)
    # the ranges also come back as device rows spanning their kernels
    spans = {e.key: e.self_device_time_total / 1e3 for e in rows
             if e.key in ranges}
    kernels = [e for e in rows if e.key not in ranges]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    rep = {"device_ms": busy, "wall_ms_profiled": wall * 1e3,
           "idle_share_profiled": 1 - busy / (wall * 1e3),
           "launches": sum(e.count for e in kernels),
           **kernel_groups(kernels, 1, "", TRAIN_GROUPS)}
    rep["other_ms"] = busy - sum(rep[f"{g}_ms"] for g in TRAIN_GROUPS)
    cpu = range_rows(torch, prof, {k for keys in ranges.values()
                                   for k in keys})
    for name, keys in ranges.items():
        sel = [cpu[k] for k in keys]
        rep[f"{name}_range_ms"] = sum(e["device_time_total"]
                                      for e in sel) / 1e3
        rep[f"{name}_range_calls"] = sum(e["count"] for e in sel)
        rep[f"{name}_gpu_span_ms"] = spans.get(name)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    rep["top_kernels_ms"] = [[e.key[:60], e.self_device_time_total / 1e3,
                              e.count] for e in top]
    return state, rep


def train_serve_phase(torch, np, dev, cfg, trained, smi):
    """The 24-layer trained params through a sync save and the reader
    (``train/checkpoint.py``), then packed by serve/prepare.py (inside
    ServingEngine) and served graphed on the serve phase's four requests
    at kv_bits 4.  Fails unless the restored params are byte-equal to the
    saved ones, the tokens equal those served from the in-memory trained
    params, and every packed linear ran the fused tensor-core K2 and every
    read K3 (no plain call).  Reports the packed first-decode logits
    against the QAT forward's (not gated).  Returns the K2 and K3
    launches of the checkpoint's engine run."""
    from repro_torch.kernels import quant_pack, ulppack_attention, \
        ulppack_matmul
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, ServingEngine
    from repro_torch.serve.prepare import prepare_serving_params
    from repro_torch.train import checkpoint

    d = scratch_dir("train_serve")
    t0 = time.perf_counter()
    checkpoint.save(d, trained, step=TRAIN_STEPS)
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(d)
    t0 = time.perf_counter()
    restored, _ = checkpoint.restore(d, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if not trees_equal(torch, restored, trained):
        raise AssertionError("train-serve: restored params differ from the "
                             "saved ones")
    c = cfg.replace(quant=cfg.quant.replace(kv_bits=4))
    prompts, _ = serve_prompts(np, cfg)
    ecfg = EngineConfig(max_batch=4, max_len=512, prefill_chunk=16)
    outs, launches = {}, {}
    for src, p in (("memory", trained), ("checkpoint", restored)):
        for mod in (quant_pack, ulppack_matmul, ulppack_attention):
            mod.reset_counts()
        eng = ServingEngine(c, p, config=ecfg, device=dev)
        reqs = serve_requests(eng, prompts, 32, paged=False)
        torch.cuda.synchronize()
        outs[src] = [list(r.output) for r in reqs]
        launches = check_served_on_kernels(eng, f"train-serve ({src})")
        del eng
        torch.cuda.empty_cache()
    if outs["memory"] != outs["checkpoint"]:
        raise AssertionError("train-serve: tokens from the checkpoint differ "
                             "from those of the in-memory params")
    # the packed path's first decode against the QAT forward (reported)
    width = 16
    tokens = np.stack([p[:width] for p in prompts])
    b = tokens.shape[0]
    packed = prepare_serving_params(restored, c, device=dev)
    caches = lm.init_caches(c, b, 512, device=dev)
    with torch.no_grad():
        l0, _ = steps.make_prefill_chunk_step(c)(
            packed, caches, {"tokens": tokens}, np.zeros(b, np.int32),
            np.full(b, width, np.int32))
        nxt = l0.argmax(-1)
        l1, _ = steps.make_decode_step(c)(
            packed, caches, {"tokens": nxt[:, None].cpu().numpy()},
            np.full(b, width, np.int32), np.ones(b, np.int32))
        full = torch.cat([torch.as_tensor(tokens, device=dev).long(),
                          nxt[:, None]], dim=1)
        q, _, _ = lm.forward(restored, c, {"tokens": full},
                             quant_mode="qat")
    q0, q1 = q[:, width - 1].float(), q[:, width].float()
    rep = {"card": smi, "params_saved_bytes": nbytes, "save_s": save_s,
           "restore_s": restore_s, "restored_byte_equal": True,
           "kv_bits": 4, "requests": len(prompts), "new_tokens": 32,
           "graphed": True, "tokens_equal": True, **launches,
           "prefill_logit_diff_vs_qat": float((l0.float() - q0).abs().max()),
           "first_decode_logit_diff_vs_qat":
               float((l1.float() - q1).abs().max()),
           "first_decode_greedy_agree_vs_qat":
               int((l1.argmax(-1) == q1.argmax(-1)).sum()),
           "prefill_greedy_agree_vs_qat":
               int((l0.argmax(-1) == q0.argmax(-1)).sum())}
    print("train-serve " + json.dumps(rep))
    shutil.rmtree(d, ignore_errors=True)
    return launches


def check_served_on_kernels(eng, where) -> dict:
    """Since the counts were reset, ``eng`` served through its CUDA graphs
    on the kernels (``check_on_kernels``).  Returns the K2 and K3
    launches."""
    if eng._decode.graph is None:
        raise AssertionError(f"{where}: the engine captured no graphs")
    return check_on_kernels(where)


def check_on_kernels(where) -> dict:
    """Since the counts were reset, every packed linear was one launch of
    the fused tensor-core K2 (``check_k2_path``) and every attention read
    one launch of K3, with no plain call.  Returns the K2 and K3
    launches."""
    from repro_torch.kernels import ulppack_attention as att

    k2 = check_k2_path(where)
    k3 = att.kernel_launches["attention_decode"]
    plain = att.plain_calls["attention_decode"]
    if not k3 or plain:
        raise AssertionError(f"{where}: {k3} K3 launches, {plain} plain "
                             f"calls")
    return {"quantized_linear_mma": k2, "attention_decode": k3}


def check_k5_path(n_layer_calls: int, where) -> int:
    """Since the counts were reset, each of ``n_layer_calls`` packed conv
    layers was one fused launch of the tensor-core K5, with no CUDA-core
    K5 launch and no plain call.  Returns K5's launches."""
    from repro_torch.kernels import ulppack_conv2d as conv

    k5 = conv.kernel_launches["ulppack_conv2d_mma"]
    fused = conv.mma_launches["affine"]
    cores = conv.kernel_launches["ulppack_conv2d"]
    plain = sum(conv.plain_calls.values())
    if k5 != n_layer_calls or fused != k5 or cores or plain:
        raise AssertionError(f"{where}: {k5} tensor-core K5 launches "
                             f"({fused} fused, {n_layer_calls} expected), "
                             f"{cores} CUDA-core, {plain} plain calls")
    return k5


@contextlib.contextmanager
def deterministic(torch):
    """torch.use_deterministic_algorithms(True) inside the block (the
    embedding's index backward otherwise accumulates with atomics, in no
    fixed order); cuBLAS asks for CUBLAS_WORKSPACE_CONFIG with it."""
    import os

    old = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield os.environ["CUBLAS_WORKSPACE_CONFIG"]
    finally:
        torch.use_deterministic_algorithms(old)


def train_ckpt_phase(torch, dev, cfg, smi):
    """The ``Trainer`` at full width cut to CKPT_LAYERS layers (a depth
    cut only: the full state is ~26 GB on disk), once with f32 moments
    and once with 8-bit ones: a straight run of CKPT_STEPS steps; a run of
    half as many that checkpoints and stops (the crash); the checkpoint
    read back (byte-equal to the state the run returned); a resumed run to
    CKPT_STEPS.  Fails unless the resumed state equals the straight one,
    bit for bit.  Reports save / restore s and bytes, and whether one
    step run twice from one state is bit-equal without the determinism
    setting (whether the setting is needed)."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import checkpoint, loop

    c0 = cfg.replace(num_layers=CKPT_LAYERS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=SEED)
    saves, restores = [], []
    orig_save, orig_restore = checkpoint.save, checkpoint.restore

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        out = orig_save(*a, **k)
        saves.append(time.perf_counter() - t0)
        return out

    def timed_restore(*a, **k):
        t0 = time.perf_counter()
        out = orig_restore(*a, **k)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
        return out

    # is the determinism setting needed?  one step twice from one state,
    # without it: equal bit for bit or not
    from repro_torch.launch import steps
    from repro_torch.models import lm
    state = steps.make_train_state(lm.init_params(
        c0, torch.Generator(device=dev).manual_seed(SEED), device=dev),
        cfg=c0)
    step_fn = steps.make_train_step(c0, **TRAIN_KW)
    batch = train_stream(c0).batch_at(0)
    repeat_equal = trees_equal(torch, step_fn(state, batch)[0],
                               step_fn(state, batch)[0])
    del state
    reps = []
    checkpoint.save, checkpoint.restore = timed_save, timed_restore
    try:
        for eightbit in (False, True):
            c = c0.replace(parallel=dataclasses.replace(
                c0.parallel, eightbit_moments=eightbit))
            root = scratch_dir("train_ckpt")
            saves.clear()
            restores.clear()

            def trainer(name, total):
                lc = loop.TrainLoopConfig(
                    total_steps=total, checkpoint_every=10 ** 6,
                    checkpoint_dir=str(root / name), log_every=10 ** 6,
                    async_checkpoint=False)
                return loop.Trainer(c, lc, data_cfg, seed=SEED, device=dev,
                                    train_step_kwargs=dict(TRAIN_KW))

            with deterministic(torch) as ws:
                t0 = time.perf_counter()
                straight, _ = trainer("straight", CKPT_STEPS).run()
                mid, _ = trainer("crash", CKPT_STEPS // 2).run()
                nbytes = dir_bytes(root / "crash")
                back, _ = checkpoint.restore(root / "crash", device=dev)
                read_equal = trees_equal(torch, back, mid)
                del back, mid
                resumed, at = trainer("crash", CKPT_STEPS).run()
                wall = time.perf_counter() - t0
            equal = trees_equal(torch, resumed, straight)
            rep = {"card": smi, "cut": f"depth only: {CKPT_LAYERS} of "
                                       f"{cfg.num_layers} layers (the full "
                                       f"state is ~26 GB on disk)",
                   "layers": CKPT_LAYERS, "d_model": cfg.d_model,
                   "vocab": cfg.vocab_size, "eightbit_moments": eightbit,
                   "steps": CKPT_STEPS, "crash_at": CKPT_STEPS // 2,
                   "resumed_to": at, "state_bytes_on_disk": nbytes,
                   "save_s": list(saves), "restore_s": list(restores),
                   "restored_byte_equal": read_equal,
                   "resumed_equals_straight": equal,
                   "deterministic": "torch.use_deterministic_algorithms"
                                    f"(True), CUBLAS_WORKSPACE_CONFIG={ws}",
                   "repeat_step_bit_equal_without_it": repeat_equal,
                   "wall_s": wall}
            print("train-ckpt " + json.dumps(rep))
            reps.append(rep)
            del straight, resumed
            torch.cuda.empty_cache()
            shutil.rmtree(root, ignore_errors=True)
            if not (read_equal and equal):
                raise AssertionError(f"train-ckpt (8-bit moments "
                                     f"{eightbit}): restored equal "
                                     f"{read_equal}, resumed equals the "
                                     f"straight run {equal}")
    finally:
        checkpoint.save, checkpoint.restore = orig_save, orig_restore
    return reps


# ---------------------------------------------------------------------------
# Training of the other LM families: the train archs lines
# ---------------------------------------------------------------------------

#: The full-width train lines, one arch a family: (name, layers kept or
#: None for all of them, the cut).  A train step holds ~30 bytes a param
#: at its peak with f32 moments (the stablelm train line's 48.6 GB over
#: 1.64 B params: the bf16 params and their update, the f32 microbatch
#: sum, its mean and the clipped gradients, the old and the new m and v),
#: ~20 with 8-bit ones, plus a leaf's f32 temporaries in the optimizer.
TRAIN_WIDE = (
    ("mixtral-8x7b", 1, "1 of 32 layers (memory): 1.71 B params, ~51 GB "
                        "of train state at ~30 bytes a param; 2 layers "
                        "are 3.17 B, ~95 GB"),
    ("jamba-1.5-large-398b", 1,
     "its first layer of 72 (memory): mamba with a dense MLP, 2.10 B "
     "params with the embedding and head, ~44 GB at 8-bit moments; a MoE "
     "layer holds 16 x 3 x 8,192 x 24,576 = 9.66 B params, >= 97 GB of "
     "train state"),
    ("xlstm-1.3b", 24, "24 of 48 layers (memory): the config's 48 layers "
                       "hold 3.61 B params, ~108 GB of train state; 24 "
                       "hold 1.90 B, ~57 GB"),
    ("qwen2-vl-2b", None, None),
    ("seamless-m4t-medium", None, None))
TRAIN_WIDE_STEPS = 2
#: the profiled step's ranges: TRAIN_RANGES and the families' own
TRAIN_WIDE_RANGES = {**TRAIN_RANGES, "expert_gemm": ("expert_gemm",),
                     "moe_dispatch": ("moe_dispatch",),
                     "moe_combine": ("moe_combine",),
                     "mamba_scan": ("mamba_scan",), "mlstm": ("mlstm",),
                     "slstm": ("slstm",), "encoder": ("encoder",),
                     "cross_attention": ("cross_attention",)}
#: The trained mixtral-8x7b served at kv 4 (the moe serve lines' prompts
#: and new tokens).
TRAIN_SERVE_KV = 4


def train_cases():
    """``tests/torch_train_cases.py`` of the checkout: the reduced cases'
    settings, batches and checks, shared with the CPU tests."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "torch_train_cases.py"
    spec = importlib.util.spec_from_file_location("torch_train_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_archs_reduced(torch, dev, smi):
    """The ``train archs reduced`` lines: each of the nine LM archs beyond
    stablelm at the CPU tests' settings (``tests/torch_train_cases.py``:
    reduced, f32, remat 'block', two microbatches, batch 4; 8-bit moments
    where the full config keeps them, and those three with f32 moments
    too), 3 steps (2 with 8-bit moments: ``card_steps``) from one seed-3
    state on the CPU and on the card.  Fails unless every step's lr is
    equal and loss, ce and grad_norm agree within 1e-4 relative, and the
    params within 1e-4 as ``param_check`` holds them (8-bit: codes at
    most one apart)."""
    from repro_torch import bridge
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cases = train_cases()
    for name, eightbit in cases.cases(cases.ARCHS):
        t0 = time.perf_counter()
        cfg = cases.port_config(name, eightbit)
        cpu = steps.make_train_state(lm.init_params(
            cfg, torch.Generator().manual_seed(3), device="cpu"), cfg=cfg)
        card = bridge.from_repro(bridge.to_numpy(cpu), device=dev)
        step = steps.make_train_step(cfg, **cases.KW)
        flips = {} if eightbit else None
        worst = {k: 0.0 for k in ("loss", "ce", "grad_norm")}
        data = cases.batches(cfg, steps=cases.card_steps(eightbit))
        for i, batch in enumerate(data):
            cpu, mc = step(cpu, batch)
            card, mg = step(card, batch)
            cases.metrics_check(mg, mc, 1e-4, f"train archs reduced {name} "
                                              f"step {i}")
            for k in worst:
                worst[k] = max(worst[k], abs(float(mg[k]) - float(mc[k]))
                               / abs(float(mc[k])))
            back = cases.to_cpu(card)
            if eightbit:
                now = cases.code_flips(back, cpu)
                if i < len(data) - 1:
                    flips = cases.merge_flips(flips, now)
        rep = cases.param_check(back, cpu, 1e-4, flips)
        print("train archs reduced " + json.dumps({
            "card": smi, "model": name, "eightbit_moments": eightbit,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "steps": len(data), "batch": cases.BATCH,
            "seq": cases.SEQ.get(name, 16), "remat": cfg.parallel.remat,
            "microbatches": cfg.parallel.microbatches,
            "metric_rel_diff_max": worst, **rep,
            "wall_s": time.perf_counter() - t0}))
        del cpu, card, back
    torch.cuda.empty_cache()


def moment_absmax(torch, m):
    """The largest |value| of an AdamW moment leaf (8-bit: its codes times
    their blocks' scales)."""
    if isinstance(m, dict):
        m = m["q"].to(torch.float32) * m["scale"]
    return m.abs().max()


def leaf_sums(torch, params) -> list:
    """Each param leaf's sum in f64 (one host copy)."""
    from repro_torch import tree as tree_lib

    return torch.stack([torch.sum(p, dtype=torch.float64)
                        for p in tree_lib.leaves(params)]).tolist()


def train_wide_line(torch, np, dev, peaks, smi, name, layers, cut,
                    profile=True):
    """A ``train archs`` line: ``name`` at full width, cut to ``layers``
    where its train state does not fit (``cut`` says why), with its
    config's remat, microbatches and moments, seed-0 params, a batch of
    max(TRAIN_BATCH, microbatches) rows of TRAIN_SEQ tokens
    (``data/pipeline.family_batch``: the VLM's 4-token image prefix of
    frontend_dim features, the encoder-decoder's 8 encoder embeddings),
    TRAIN_WIDE_STEPS steps at TRAIN_KW, then with ``profile`` one more
    under the profiler (``profile_train_step`` at TRAIN_WIDE_RANGES: 31 s
    of host time on an H100 machine for xlstm's 251,834 launches).  Fails unless every
    metric is finite, step 0's loss equals the mean over the same
    microbatches of ``lm.loss_fn`` on the QAT forward under no_grad
    within 1e-4 relative, the params have moved after step 1 and a
    gradient has reached the network's inputs: the embedding table and a
    frontend's projection (their first moments are nonzero).  Reports
    the kernels no gradient reached (at mixtral-8x7b's width the experts'
    up and gate: their SwiGLU output saturates the down input's LSQ range
    at init, as in the reference) and those whose bf16 values all round
    back after one update at lr 1.5e-4.  Returns the state."""
    from repro_torch import configs, tree as tree_lib
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = configs.get_config(name)
    n_layers = cfg.num_layers
    if layers:
        cfg = cfg.replace(num_layers=layers)
    micro = max(1, cfg.parallel.microbatches)
    b = max(TRAIN_BATCH, micro)
    rng = np.random.default_rng(SEED)
    data = []
    for _ in range(TRAIN_WIDE_STEPS + 1):
        batch, labels = pipeline.family_batch(cfg, rng, b=b, s=TRAIN_SEQ)
        data.append(dict(batch, labels=labels))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    paths = [p for p, _ in tree_lib.flatten_with_path(params)]
    n_params = sum(p.numel() for p in tree_lib.leaves(params))
    before = leaf_sums(torch, params)
    # step 0's loss, recomputed: the QAT forward over the same
    # microbatches under no_grad, averaged
    first = {k: torch.as_tensor(v).to(dev) for k, v in data[0].items()}
    qmode, losses = steps.quant_mode_for(cfg, "train"), []
    with torch.no_grad():
        for mb in steps._split_micro(first, micro):
            logits, aux, _ = lm.forward(params, cfg, mb, quant_mode=qmode)
            losses.append(float(lm.loss_fn(logits, mb["labels"], aux)[0]))
            del logits
    want = sum(losses) / micro
    del first
    forward_s = time.perf_counter() - t0
    state = steps.make_train_state(params, cfg=cfg)
    del params
    step_fn = steps.make_train_step(cfg, **TRAIN_KW)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows, ms = [], []
    for i in range(TRAIN_WIDE_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, data[i])
        rows.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    after = leaf_sums(torch, state["params"])
    # the largest |m| of each leaf after step 1: nonzero where a gradient
    # reached it
    m_max = dict(zip(paths, torch.stack([
        moment_absmax(torch, m) for m in tree_lib.leaves(
            state["opt_state"]["m"], is_leaf=adamw.is_moment)]).tolist()))
    prof = None
    if profile:
        t0 = time.perf_counter()
        state, prof = profile_train_step(torch, state, step_fn,
                                         data[TRAIN_WIDE_STEPS],
                                         TRAIN_WIDE_RANGES)
        prof["profile_s"] = time.perf_counter() - t0
    bad = [i for i, r in enumerate(rows)
           if not all(math.isfinite(v) for v in r.values())]
    loss_rel = abs(rows[0]["loss"] - want) / abs(want)
    kernels = [p for p in paths if p.endswith("kernel")]
    still = [p for p, x, y in zip(paths, before, after)
             if p.endswith("kernel") and x == y]
    no_grad = [p for p in kernels if m_max[p] == 0.0]
    # the backward reached the network's inputs: the embedding table (and
    # a frontend's projection)
    ends = [p for p in paths if p in ("embed/table", "frontend_proj/kernel")]
    cut_off = [p for p in ends if m_max[p] == 0.0]
    moved = sum(x != y for x, y in zip(before, after))
    tokens = b * data[0]["labels"].shape[1]
    med = statistics.median(ms)
    rep = {"card": smi, "model": name, "layers": cfg.num_layers,
           "of_layers": n_layers, "cut": cut or "none",
           "d_model": cfg.d_model, "params": n_params,
           "w_bits": cfg.quant.w_bits, "a_bits": cfg.quant.a_bits,
           "param_dtype": cfg.param_dtype, "remat": cfg.parallel.remat,
           "microbatches": micro,
           "eightbit_moments": cfg.parallel.eightbit_moments,
           "batch": b, "seq": TRAIN_SEQ,
           "positions_a_row": data[0]["labels"].shape[1],
           "steps": TRAIN_WIDE_STEPS, **TRAIN_KW, "setup_s": setup_s,
           "init_and_forward_s": forward_s,
           "per_step": [dict(r, step=i, ms=t)
                        for i, (r, t) in enumerate(zip(rows, ms))],
           "median_step_ms": med, "tokens_per_s": tokens * 1e3 / med,
           "step0_loss_no_grad_forward": want, "step0_loss_rel_diff": loss_rel,
           "leaves_moved": moved, "leaves": len(paths),
           "kernels_moved": len(kernels) - len(still),
           "kernels": len(kernels), "kernels_no_gradient": no_grad,
           "inputs_gradient_m_absmax": {p: m_max[p] for p in ends},
           "max_memory_allocated": peak, "build_peak_bytes": build_peak,
           "model_flop_share": 6 * n_params * tokens / (med / 1e3)
           / peaks["bf16"],
           "profiled_step": prof}
    print("train archs " + json.dumps(rep))
    if bad or loss_rel > 1e-4 or not moved or cut_off or not ends:
        raise AssertionError(f"train archs {name}: non-finite metrics at "
                             f"steps {bad}, step 0's loss {rows[0]['loss']} "
                             f"against the forward's {want}, {moved} leaves "
                             f"moved, inputs no gradient reached {cut_off}")
    return state


def train_archs_serve(torch, np, dev, smi, trained, steps_taken):
    """The ``train archs serve`` line: the mixtral-8x7b params trained
    ``steps_taken`` steps by its ``train archs`` line (1 of 32 layers)
    through ``prepare_serving_params`` (the experts' lattices derived from
    the trained ``w_step``), served graphed at kv TRAIN_SERVE_KV on the moe
    serve lines' prompts and new tokens, then with ``backend='torch'``
    over the same prepared tree.  Fails unless the tokens and every
    decode pass's logits are equal, every packed linear ran the fused
    tensor-core K2 (``check_k2_path``) and no read reached K3 (the
    windowed cache takes the legacy read).  Returns the fused K2 and
    window-write launches."""
    from repro_torch.kernels import cache_write, quant_pack, \
        ulppack_attention, ulppack_matmul
    from repro_torch.serve.engine import EngineConfig, ServingEngine
    from repro_torch.serve.prepare import prepare_serving_params

    c = moe_config(TRAIN_SERVE_KV, layers=1)
    t0 = time.perf_counter()
    packed = prepare_serving_params(trained, c, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    prompts = [p[:MOE_PROMPT] for p in serve_prompts(np, c)[0]]
    ecfg = EngineConfig(max_batch=4, max_len=512)
    for mod in (quant_pack, ulppack_matmul, ulppack_attention, cache_write):
        mod.reset_counts()
    eng = ServingEngine(c, packed, config=ecfg, device=dev)
    check_prepared_experts(eng, packed, "train archs serve")
    t0 = time.perf_counter()
    outs, rows, passes = recorded_serve(np, eng, prompts, MOE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = check_k2_path("train archs serve")
    if ulppack_attention.kernel_launches["attention_decode"]:
        raise AssertionError("train archs serve: a windowed read reached K3")
    launches = {"quantized_linear_mma": k2,
                "cache_write": cache_write.kernel_launches["cache_write"]}
    graphed = eng._decode.graph is not None
    del eng
    torch.cuda.empty_cache()
    ref = ServingEngine(c, packed, config=ecfg, device=dev, backend="torch")
    ref_outs, ref_rows, ref_passes = recorded_serve(np, ref, prompts,
                                                    MOE_NEW)
    del ref
    token_divergences(np, "train archs serve", ref_outs, ref_rows, outs,
                      rows, strict=True)
    diff = max_pass_diff(passes, ref_passes)
    print("train archs serve " + json.dumps({
        "card": smi, "model": c.name,
        "layers": f"1 of 32, trained {steps_taken} steps",
        "kv_bits": TRAIN_SERVE_KV, "graphed": graphed,
        "requests": len(prompts), "prompt_tokens": MOE_PROMPT,
        "new_tokens": MOE_NEW, "prepare_s": prep_s, "wall_s": wall,
        "tokens_equal": True, "decode_passes": len(passes),
        "max_logit_diff_vs_torch": diff, "fused_k2_launches": k2,
        "cache_write_launches": launches["cache_write"]}))
    if not graphed or diff != 0.0:
        raise AssertionError(f"train archs serve: graphed {graphed}, decode "
                             f"logits differ from backend='torch' by {diff}")
    return launches


def train_archs_phase(torch, np, dev, peaks, smi, profile=True):
    """The train archs lines: the reduced card-against-CPU steps of the
    nine other LM archs, the full-width steps of one arch a family
    (TRAIN_WIDE; with ``profile`` a profiled step each), the trained
    mixtral-8x7b served.  Returns the served run's kernel launches."""
    train_archs_reduced(torch, dev, smi)
    mark("train archs reduced")
    launches = {}
    for name, layers, cut in TRAIN_WIDE:
        state = train_wide_line(torch, np, dev, peaks, smi, name, layers,
                                cut, profile)
        trained, taken = state["params"], int(state["step"])
        del state
        gc.collect()
        torch.cuda.empty_cache()
        mark(f"train archs {name}")
        if name == "mixtral-8x7b":
            launches = train_archs_serve(torch, np, dev, smi, trained,
                                         taken)
            mark("train archs serve")
        del trained
        gc.collect()
        torch.cuda.empty_cache()
    print(smi)
    return launches


def cnn_qat_phase(torch, dev, cfg, smi):
    """Full-width sparq-cnn W2A2 QAT-trained on the synthetic template task
    of examples/train_cnn_qat.py at 256x256x3 (repro_torch.examples.
    train_cnn_qat: a fresh batch of CNN_BATCH each step, AdamW at 1e-2, no
    weight decay) for CNN_QAT_STEPS steps; float, QAT and packed-integer
    accuracy on CNN_QAT_TEST held-out images.  Fails unless the packed
    evaluation ran every packed layer as one fused tensor-core K5 launch
    (no CUDA-core K5, no plain call); then ``cnn_compare`` on the trained
    params (every layer bit-equal to the plain path).  Returns K5's
    launches."""
    from repro_torch.examples import train_cnn_qat as example
    from repro_torch.kernels import ulppack_conv2d as conv

    conv.reset_counts()
    t0 = time.perf_counter()
    rep = example.run(cfg, steps=CNN_QAT_STEPS, batch=CNN_BATCH,
                      n_test=CNN_QAT_TEST, seed=SEED, device=dev,
                      log_every=0)
    wall = time.perf_counter() - t0
    k5 = check_k5_path(-(-CNN_QAT_TEST // CNN_BATCH) * len(cfg.cnn_channels),
                       "cnn-qat packed evaluation")
    losses = rep["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("cnn-qat: non-finite loss")
    # where the QAT forward's activations live: the share of each conv
    # layer's ReLU outputs above zero on held-out images, and of its
    # inputs on the lattice's zero (below half a step of alpha / qmax)
    from repro_torch.models import cnn
    xs = rep["test"][0][:CNN_BATCH]
    params, q = rep["params"], cfg.quant
    live = []
    with torch.no_grad():
        h = torch.relu(cnn.conv_apply(params["stem"], xs, q))
        for p in params["layers"]:
            zero = float((h < 0.5 * p["alpha"] / q.qmax_a).float().mean())
            h = torch.relu(cnn.conv_apply(p, h, q, quant_mode="qat"))
            live.append({"alpha": float(p["alpha"]),
                         "input_on_zero_share": zero,
                         "output_above_zero_share":
                             float((h > 0).float().mean())})
    line = {"card": smi, "model": cfg.name, "w_bits": cfg.quant.w_bits,
            "a_bits": cfg.quant.a_bits, "input": [cfg.cnn_input_hw] * 2 + [3],
            "steps": CNN_QAT_STEPS, "batch": CNN_BATCH,
            "held_out": CNN_QAT_TEST, "acc_float": rep["acc_float"],
            "acc_qat": rep["acc_qat"], "acc_packed": rep["acc_packed"],
            "loss_first10_mean": statistics.mean(losses[:10]),
            "loss_last10_mean": statistics.mean(losses[-10:]),
            "median_step_ms": rep["median_step_ms"], "wall_s": wall,
            "qat_activations": live, "k5_launches": k5}
    print("cnn-qat " + json.dumps(line))
    cnn_compare(torch, cfg, rep["packed"], rep["plans"], rep["test"][0][:2])
    return k5


#: The autotune phase's signatures: K3 at B4 S512 (stablelm's heads) for
#: (query rows, kv_bits), K4 reading each at the paged phase's 16-row
#: pages; the layout sweep at stablelm's three W2A2 (k, n) at 8 rows
#: (``prepare_serving_params``' tune_rows).
# ---------------------------------------------------------------------------
# The last modules: the train compress, pipeline, collective matmul and
# roofline lines
# ---------------------------------------------------------------------------

#: The leaves whose compression on the card is held bit-equal to the CPU's.
COMPRESS_LEAVES = ("embed/table", "layers/0/attn/q/kernel",
                   "layers/0/mlp/down/kernel")
PIPE_MICRO, PIPE_STAGES, PIPE_SEQ = 4, 2, 128
#: all_gather_matmul at stablelm's down projection: x [512, 5632] split on
#: K over two shards, w [5632, 2048].
AGM_SHAPE = (512, 5632, 2048)
# The ring and one torch.matmul agree within a bf16 bound an element: each
# rounding to bf16 moves a value by at most half a unit in its last place,
# 2^-8 of it.  The ring rounds its two partial products p0 and p1 and their
# sum; torch.matmul rounds its one product y (and may reduce split-K
# partials in bf16, which PyTorch allows).  A whole unit, 2^-7, is allowed
# for each: |ring - matmul| <= 2^-7 (|p0| + |p1| + 2 |y|), with p0, p1 and
# y taken in f32 from the same bf16 operands.
AGM_ULP = 2.0 ** -7


def train_compress_phase(torch, dev, cfg, peaks, smi):
    """``train compress``: the ``train`` cell with ``compress_grads=True``
    and error feedback (``parallel/collectives.py``): TRAIN_STEPS steps,
    per step loss, grad_norm and ms beside the uncompressed ``train``
    line's (run first when this script runs only these lines), the median
    step, the residuals' bytes, peak memory, and one more step profiled:
    the device and host ms in the ``grad_compress`` range.  Gated: every
    loss finite; step 1's decompressed gradients and residuals of
    :data:`COMPRESS_LEAVES` bit-equal to the same function run on the CPU
    over the same gradients and residuals."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as tree_lib
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.parallel import collectives

    if not TRAIN_LINE:
        state, _, _ = train_phase(torch, dev, cfg, peaks, smi)
        del state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    state = steps.make_train_state(params, cfg=cfg, error_feedback=True)
    del params
    resid = tree_lib.leaves(state["error_feedback"])
    resid_bytes = sum(e.numel() * e.element_size() for e in resid)
    n_leaves = len(resid)
    del resid
    step_fn = steps.make_train_step(cfg, compress_grads=True, **TRAIN_KW)
    data = train_stream(cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    real = collectives.compress_grads_with_feedback
    seen = {}

    def spy(grads, st):
        out = real(grads, st)
        if not seen:
            trees = (grads, st["error_feedback"], out[0],
                     out[1]["error_feedback"])
            flat = [dict(tree_lib.flatten_with_path(t)) for t in trees]
            for name in COMPRESS_LEAVES:
                seen[name] = [f[name].cpu() for f in flat]
        return out

    torch.cuda.reset_peak_memory_stats()
    rows, ms = [], []
    collectives.compress_grads_with_feedback = spy
    try:
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step_fn(state, data.batch_at(i))
            rows.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        collectives.compress_grads_with_feedback = real
    peak = torch.cuda.max_memory_allocated()
    bad = [i for i, r in enumerate(rows)
           if not (math.isfinite(r["loss"]) and math.isfinite(r["ce"])
                   and math.isfinite(r["grad_norm"]))]
    if bad:
        raise AssertionError(f"train compress: non-finite loss or grad_norm "
                             f"at steps {bad}: {rows}")
    # step 1's compression on the CPU, leaf by leaf, over the same inputs
    cpu_equal = {}
    for name, (g, e, deq, res) in seen.items():
        d, st = real({"x": g}, {"error_feedback": {"x": e}})
        cpu_equal[name] = same_bits(torch, d["x"], deq) and same_bits(
            torch, st["error_feedback"]["x"], res)
    del seen
    # one more step profiled: the compression's range
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step_fn(state, data.batch_at(TRAIN_STEPS))
        float(m["loss"])
        torch.cuda.synchronize()
    ranges = range_rows(torch, prof, ("grad_compress", "optimizer"))
    prof_ms = {f"{k}_device_ms": e["device_time_total"] / 1e3
               for k, e in ranges.items() if e["count"]}
    prof_ms.update({f"{k}_host_ms": e["cpu_time_total"] / 1e3
                    for k, e in ranges.items() if e["count"]})
    base = TRAIN_LINE.get("per_step", [])
    rep = {"card": smi, "model": cfg.name, "layers": cfg.num_layers,
           "remat": cfg.parallel.remat,
           "microbatches": cfg.parallel.microbatches, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "setup_s": setup_s,
           "per_step": [{"step": i, "loss": r["loss"],
                         "grad_norm": r["grad_norm"], "ms": t,
                         "uncompressed_loss": base[i]["loss"]
                         if i < len(base) else None,
                         "uncompressed_grad_norm": base[i]["grad_norm"]
                         if i < len(base) else None}
                        for i, (r, t) in enumerate(zip(rows, ms))],
           "median_step_ms": statistics.median(ms),
           "uncompressed_median_step_ms": TRAIN_LINE.get("median_step_ms"),
           "grad_leaves": n_leaves, "residual_bytes": resid_bytes,
           "max_memory_allocated": peak,
           "uncompressed_max_memory_allocated":
               TRAIN_LINE.get("max_memory_allocated"),
           **prof_ms, "step1_cpu_bit_equal": cpu_equal, "finite": True}
    print("train compress " + json.dumps(rep))
    if not all(cpu_equal.values()) or len(cpu_equal) != len(
            COMPRESS_LEAVES):
        raise AssertionError(f"train compress: step 1's compression on the "
                             f"card differs from the CPU's: {cpu_equal}")
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()


def pipeline_phase(torch, dev, cfg, smi):
    """``pipeline``: full-width ``cfg``'s packed serving blocks as
    PIPE_STAGES stages (``parallel/pipeline.stack_stages``) over a mesh
    listing ``dev`` once a stage on ``pod``, PIPE_MICRO microbatches of
    PIPE_SEQ positions through ``gpipe``.  Gated: the output bit-equal to
    the blocks applied in sequence on the same device, and every packed
    linear one K2 launch, no plain call (PIPE_MICRO x layers x 7 launches
    in the pipelined pass).  Reports ``bubble_fraction`` and the ms of the
    pipelined and the sequential pass (host clock, alternated, median of
    5).  Returns the pipelined pass's launches by kernel."""
    from repro_torch.kernels import quant_pack, ulppack_matmul as mm
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import common, lm
    from repro_torch.parallel import pipeline
    from repro_torch.serve import prepare

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = lm.init_params(cfg, gen, device=dev)
    blocks = prepare.prepare_serving_params(params, cfg,
                                            device=dev)["layers"]
    del params
    torch.cuda.empty_cache()
    stages = pipeline.stack_stages(blocks, PIPE_STAGES)
    per = cfg.num_layers // PIPE_STAGES
    mesh = Mesh([dev] * PIPE_STAGES, ("pod",))
    xs = torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model), device=dev,
                     generator=gen).to(common.dtype_of(cfg.compute_dtype))
    pos = torch.arange(PIPE_SEQ, dtype=torch.int32, device=dev)[None]

    def run(blk, x):
        return lm.block_apply(blk, cfg, x, positions=pos,
                              quant_mode="packed")[0]

    def stage_fn(p, x):
        for j in range(per):
            x = run(pipeline.layer(p, j), x)
        return x

    def piped():
        return pipeline.gpipe(stage_fn, stages, xs, mesh=mesh, axis="pod")

    def sequential():
        outs = []
        for m in range(PIPE_MICRO):
            x = xs[m]
            for blk in blocks:
                x = run(blk, x)
            outs.append(x)
        return torch.stack(outs)

    with torch.no_grad():
        sequential()                      # warm: plans, kernels loaded
        reset_kernel_counts()
        got = piped()
        torch.cuda.synchronize()
        launches = {"quantized_linear_mma": mm.mma_launches["quant_affine"],
                    "ulppack_matmul_mma": mm.mma_launches["affine"]
                    + mm.mma_launches["s32"],
                    "quantize_pack": quant_pack.kernel_launches}
        plain = mm.plain_calls["ulppack_matmul"] + quant_pack.plain_calls
        want = sequential()
        equal = same_bits(torch, got, want)
        t_pipe, t_seq = [], []
        for _ in range(5):
            for fn, out in ((piped, t_pipe), (sequential, t_seq)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
    k2 = launches["quantized_linear_mma"] + launches["ulppack_matmul_mma"]
    rep = {"card": smi, "model": cfg.name, "layers": cfg.num_layers,
           "stages": PIPE_STAGES, "layers_a_stage": per,
           "devices": [str(d) for d in [dev] * PIPE_STAGES],
           "microbatches": PIPE_MICRO, "positions": PIPE_SEQ,
           "bubble_fraction": pipeline.bubble_fraction(PIPE_MICRO,
                                                       PIPE_STAGES),
           "bit_equal_to_sequential": equal, "k2_launches": launches,
           "plain_calls": plain, "gpipe_ms": statistics.median(t_pipe),
           "sequential_ms": statistics.median(t_seq),
           "gpipe_ms_all": t_pipe, "sequential_ms_all": t_seq}
    print("pipeline " + json.dumps(rep))
    if not equal or k2 != PIPE_MICRO * cfg.num_layers * 7 or plain:
        raise AssertionError(f"pipeline: bit-equal {equal}, K2 launches "
                             f"{launches}, plain calls {plain}")
    del stages, blocks, got, want
    torch.cuda.empty_cache()
    return launches


def collective_matmul_phase(torch, dev, smi):
    """``collective matmul``: ``parallel/collectives.all_gather_matmul`` on
    a two-shard ``model`` row of ``dev`` at AGM_SHAPE in bf16 against one
    ``torch.matmul`` of the whole, gated within the AGM_ULP bound an
    element; the ms of each (CUDA-graph replay)."""
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.parallel import collectives, sharding

    m, k, n = AGM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn((k, n), device=dev, generator=gen)
         / math.sqrt(k)).to(torch.bfloat16)
    mesh = ServingMesh([[dev, dev]])
    row = mesh.devices[0]
    xs = sharding.split(x, (None, sharding.MODEL), row)
    ws = sharding.split(w, (sharding.MODEL, None), row)
    got = collectives.all_gather_matmul(xs, ws, mesh)
    want = torch.matmul(x, w)
    h = k // 2
    p0 = x[:, :h].float() @ w[:h].float()
    p1 = x[:, h:].float() @ w[h:].float()
    tol = AGM_ULP * (p0.abs() + p1.abs() + 2 * (p0 + p1).abs())
    err = (got.float() - want.float()).abs()
    within = bool((err <= tol).all())
    rep = {"card": smi, "shape": {"m": m, "k": k, "n": n}, "shards": 2,
           "devices": [str(d) for d in row], "dtype": "bfloat16",
           "max_abs_err": float(err.max()),
           "max_err_over_bound": float((err / tol.clamp_min(1e-30)).max()),
           "within_bound": within,
           "ms": time_ms(torch, [lambda: collectives.all_gather_matmul(
               xs, ws, mesh)]),
           "matmul_ms": time_ms(torch, [lambda: torch.matmul(x, w)])}
    print("collective matmul " + json.dumps(rep))
    if not within or got.shape != (m, n) or got.device != x.device:
        raise AssertionError(f"collective matmul: {rep}")


def roofline_phase(name, smi):
    """``roofline``: the constants ``roofline/hw.py`` picks for the card's
    name, and the dry run (``launch/dryrun.lower_cell``) of stablelm-1.6b
    x train_4k and x decode_32k on the 16x16 production mesh over them."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import hw

    cells = [dryrun.lower_cell("stablelm-1.6b", s, False, card=name)
             for s in ("train_4k", "decode_32k")]
    print("roofline " + json.dumps({"card": smi, "device": name,
                                    "constants": hw.card_constants(name),
                                    "dry_run": cells}))
    if any(c["status"] != "PLACED" for c in cells):
        raise AssertionError(f"roofline: {cells}")


def parallel_phase(torch, dev, peaks, smi, name):
    """The lines of the last modules: ``roofline``, ``collective matmul``,
    ``pipeline`` and ``train compress``.  Returns the pipeline's K2
    launches."""
    from repro_torch import configs

    t0 = time.perf_counter()
    cfg = configs.get_config("stablelm-1.6b")
    roofline_phase(name, smi)
    collective_matmul_phase(torch, dev, smi)
    launches = pipeline_phase(torch, dev, cfg, smi)
    mark("pipeline")
    train_compress_phase(torch, dev, cfg, peaks, smi)
    print(f"parallel lines in {time.perf_counter() - t0:.1f} s")
    return launches


AUTOTUNE_ATTN = ((1, 16), (1, 4), (1, 2), (16, 4))
AUTOTUNE_SKV = 512
AUTOTUNE_LAYOUTS = ((2048, 2048), (2048, 5632), (5632, 2048))
AUTOTUNE_CLI = ("--arch", "stablelm-1.6b", "--max-batch", "4", "--max-len",
                "512", "--kv-bits", "4", "--requests", "4")


def _tune_line(kernel, key, entry, heuristic, fields, **extra):
    """Print one ``autotune`` line: the key, the candidate count, the
    heuristic's and the winner's µs and geometry, and whether every
    candidate agreed with the plain version (gated)."""
    agree = entry.get("bit_equal", entry.get("within_tol"))
    line = {"kernel": kernel, "key": key,
            "candidates": entry["candidates"],
            "heuristic_us": entry.get("heuristic_us", entry.get("base_us")),
            "wall_us": entry["wall_us"],
            "winner": {f: entry[f] for f in fields if f in entry},
            "heuristic": heuristic,
            "bit_equal" if "bit_equal" in entry else "within_tol": agree,
            **extra}
    h, w = line["heuristic_us"], line["wall_us"]
    line["heuristic_over_tuned"] = h / w if h and w else None
    print("autotune " + json.dumps(line))
    if not agree:
        raise AssertionError(f"autotune {key}: a candidate disagreed with "
                             f"the plain version")
    return line


def autotune_phase(torch, dev, lm_cfg, cnn_cfg):
    """The autotuner at the main path's signatures (kernels/autotune.py),
    into the cache at $REPRO_TORCH_AUTOTUNE_CACHE: the fused K2 at
    stablelm's six K2 shapes; K3 at ``AUTOTUNE_ATTN``, and K4 at the
    paged phase's shape adopting K3's entry (gated: both plans tuned, one
    geometry, K4 bit-equal to K3 at it); K5 at sparq-cnn's distinct layers
    (32->32, 32->64; batch 8, int16xP2s8 lanes); the layout sweep at
    ``AUTOTUNE_LAYOUTS`` and at sparq-cnn's widest layer.  An
    ``autotune`` line each (every candidate bit-equal, or for K3 within
    ATTN_TOL of the plain version: gated).  Returns the cache, saved."""
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import autotune
    from repro_torch.kernels import plan as plan_lib
    from repro_torch.kernels import ulppack_attention as ua
    from repro_torch.models import attention

    cache = autotune.active_cache()
    sp = PackSpec.parse("W2A2/int16xP2s8")
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    for m, kp, n in K2_MMA_CASES:
        k = 2 * kp
        entry = autotune.tune_quantized_linear(m, k, n, sp, bf16, device=dev)
        heur = plan_lib.plan_quantized_linear(m, k, n, sp, bf16,
                                              weight_store="lanes",
                                              device=dev,
                                              use_tuning_cache=False)
        tuned = plan_lib.plan_quantized_linear(m, k, n, sp, bf16,
                                               weight_store="lanes",
                                               device=dev)
        fields = ("block_m", "block_k", "splits", "stages")
        if tuned.source != "tuned" or any(getattr(tuned, f) != entry[f]
                                          for f in fields):
            raise AssertionError(f"quantized_linear {(m, k, n)}: the planner "
                                 f"did not adopt the tuned entry")
        _tune_line("quantized_linear_mma", autotune.quantized_linear_key(
            m, k, n, sp, 2, backend="cuda"), entry,
            {f: getattr(heur, f) for f in fields}, fields)
    h, kvh, hd, s = lm_cfg.num_heads, lm_cfg.num_kv_heads, \
        lm_cfg.resolved_head_dim, AUTOTUNE_SKV
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    fields = ("tile_rows", "split_rows", "splits")
    for c, kv in AUTOTUNE_ATTN:
        entry = autotune.tune_attention_decode(4, c, s, h, kvh, hd,
                                               kv_bits=kv, device=dev)
        dt = bf16 if kv == 16 else None
        plans = {ps: plan_lib.plan_attention_decode(
            4, c, s, h, kvh, hd, kv, page_size=ps, cache_dtype=dt,
            device=dev) for ps in (None, 16)}
        heur = plan_lib.plan_attention_decode(
            4, c, s, h, kvh, hd, kv, cache_dtype=dt, device=dev,
            use_tuning_cache=False)
        key = autotune.attention_decode_key(4, c, s, h, kvh, hd, kv,
                                            backend="cuda")
        _tune_line("attention_decode", key, entry,
                   {f: getattr(heur, f) for f in fields}, fields,
                   max_err=entry["max_err"])
        if entry["max_err"] > ATTN_TOL:
            raise AssertionError(f"{key}: the winner is {entry['max_err']} "
                                 f"from the plain version, past {ATTN_TOL}")
        geo = {ps: [getattr(p, f) for f in fields] for ps, p in plans.items()}
        if {p.source for p in plans.values()} != {"tuned"} \
                or geo[None] != geo[16] \
                or geo[None] != [entry[f] for f in fields]:
            raise AssertionError(f"K4 at {key}: plans {geo}, sources "
                                 f"{[p.source for p in plans.values()]}: "
                                 f"K3 and K4 must adopt K3's entry")
        # K4 through a scrambled table at the adopted plan, bit-equal to
        # K3 at its own, on the same logical rows
        kf, vf = (torch.randn((4, s, kvh, hd), generator=gen, device=dev)
                  .to(bf16) for _ in range(2))
        if kv == 16:
            kvc = {"k": kf, "v": vf}
        else:
            (qk, sk), (qv, sv) = (attention.kv_quantize(t, kv)
                                  for t in (kf, vf))
            kvc = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
        npg = s // 16
        bt = torch.randperm(4 * npg, generator=gen, device=dev) \
            .reshape(4, npg).to(torch.int32)
        pool = {}
        for name, t in kvc.items():
            pool[name] = torch.empty((4 * npg, 16, *t.shape[2:]),
                                     dtype=t.dtype, device=dev)
            pool[name][bt.long()] = t.reshape(4, npg, 16, *t.shape[2:])
        q = torch.randn((4, c, h, hd), generator=gen, device=dev).to(bf16)
        vl = torch.tensor([s, 300 * s // 512, 77 * s // 512, 1],
                          dtype=torch.int32, device=dev)
        qpos = (torch.clamp(vl, min=c)[:, None] - c + torch.arange(
            c, device=dev)[None, :]).to(torch.int32)
        got3 = ua.attention_decode_cuda(q, kvc, vl, qpos, kv_bits=kv, hd=hd,
                                        plan=plans[None])
        got4 = ua.attention_decode_paged_cuda(q, pool, vl, qpos, bt,
                                              kv_bits=kv, hd=hd,
                                              plan=plans[16])
        torch.cuda.synchronize()
        if not torch.equal(got3, got4):
            raise AssertionError(f"K4 at {key}: not bit-equal to K3 at the "
                                 f"tuned geometry")
        print("autotune " + json.dumps({
            "kernel": "attention_decode_paged", "reads": key,
            "page_size": 16, "geometry": geo[16], "source": "tuned",
            "bit_equal_to_k3": True}))
    hw, fk, chans = cnn_cfg.cnn_input_hw, cnn_cfg.cnn_kernel, \
        cnn_cfg.cnn_channels
    layers = sorted({(chans[max(i - 1, 0)], co)
                     for i, co in enumerate(chans)})
    for cin, cout in layers:             # K5 at each distinct layer
        xs, ws = (CNN_BATCH, hw, hw, cin // 2), (fk, fk, cin // 2, cout)
        entry = autotune.tune_packed_conv2d(xs, ws, sp, device=dev)
        heur = plan_lib.plan_packed_conv2d(xs, ws, sp, device=dev,
                                           use_tuning_cache=False)
        fields = ("block_co", "block_w", "block_h")
        _tune_line("ulppack_conv2d_mma", autotune.conv2d_key(
            xs, ws, sp, padding="SAME", backend="cuda"), entry,
            {f: getattr(heur, f) for f in fields}, fields)
    for k, n in AUTOTUNE_LAYOUTS:
        entry = autotune.tune_matmul_layout(8, k, n, sp, x_dtype=bf16,
                                            device=dev)
        _tune_line("layout_matmul", autotune.matmul_layout_key(
            k, n, 2, 2, backend="cuda"), entry, {"spec": str(sp)},
            ("spec",))
    cin, cout = layers[-1]               # the layout sweep at the widest
    xs, ws = (CNN_BATCH, hw, hw, cin), (fk, fk, cin, cout)
    entry = autotune.tune_conv2d_layout(xs, ws, sp, device=dev)
    _tune_line("layout_conv2d", autotune.conv2d_layout_key(
        xs, ws, 2, 2, padding="SAME", backend="cuda"), entry,
        {"spec": str(sp)}, ("spec",))
    path = cache.save()
    print(f"autotune: {len(cache.entries)} entries in "
          f"{time.perf_counter() - t0:.1f} s, saved to {path}")
    return cache


def _serve_cli(torch, args, cache_path):
    """Run ``python -m repro_torch.launch.serve`` with ``args`` on this
    card (its own process, the tuning cache at ``cache_path``); returns
    (exit code, the --metrics report or None, the output's tail)."""
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src), **{
        "REPRO_TORCH_AUTOTUNE_CACHE": str(cache_path)})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=env, capture_output=True, text=True, timeout=480)
    out = proc.stdout
    rep = None
    if proc.returncode == 0 and "\n{" in out:
        rep = json.loads(out[out.index("\n{") + 1:])
    return proc.returncode, rep, (out + proc.stderr)[-2000:]


def autotune_cli(torch):
    """The ``autotune cli`` line: the serving CLI at full-width stablelm
    with ``--autotune --metrics`` against an empty cache, then the same
    command without ``--autotune``.  Gated: both exit 0; the first tunes;
    the second tunes nothing, leaves the cache file as it was, and every
    K2 plan of its plan report is ``source: tuned``.  Reports each run's
    engine build s (the tune time is their difference), step_setup_s and
    decode tok/s."""
    path = scratch_dir("autotune_cli")
    path.mkdir(parents=True)
    path = path / "cache.json"
    runs = {}
    for label, extra in (("autotune", ("--autotune",)), ("cached", ())):
        before = path.read_bytes() if path.exists() else None
        rc, rep, tail = _serve_cli(torch, [*AUTOTUNE_CLI, *extra,
                                           "--metrics"], path)
        if rc != 0 or rep is None:
            raise AssertionError(f"autotune cli {label}: exit {rc}\n{tail}")
        runs[label] = (rep, before)
    first, second = runs["autotune"][0], runs["cached"][0]
    k2 = [p for p in second["plans"]
          if p["op"] in ("quantized_linear", "packed_matmul")]
    untouched = runs["cached"][1] == path.read_bytes()
    line = {
        "args": list(AUTOTUNE_CLI),
        "tuned": [first["autotune"]["tuned"], second["autotune"]["tuned"]],
        "entries": second["autotune"]["entries"],
        "engine_init_s": [first["engine_init_s"], second["engine_init_s"]],
        "tune_s": first["engine_init_s"] - second["engine_init_s"],
        "step_setup_s": [first["capacity"]["step_setup_s"],
                         second["capacity"]["step_setup_s"]],
        "decode_tok_s": [first["decode_tok_s"], second["decode_tok_s"]],
        "k2_plans": len(k2),
        "k2_plans_tuned": sum(p["source"] == "tuned" for p in k2),
        "cache_untouched_by_second_run": untouched}
    print("autotune cli " + json.dumps(line))
    if not (first["autotune"]["tuned"] > 0 and second["autotune"]["tuned"]
            == 0 and untouched and k2 and line["k2_plans_tuned"] == len(k2)):
        raise AssertionError(f"autotune cli: {line}")
    shutil.rmtree(path.parent, ignore_errors=True)
    return line


def autotune_serve(torch, np, dev, cfg, tuned):
    """The ``autotune serve`` line: graphed kv 4 engines (the serve phase's
    config and requests, 32 greedy tokens each) built under the tuned
    cache and under an empty one.  Tokens gated under the ``spec`` lines'
    rule (a tuned K3 split changes the softmax's rounding): equal, or a
    divergence where the heuristic engine's top-2 margin is at most 2 x
    the difference of the rows that chose.  Reports the first decode's
    logit difference, each engine's K2 plans by source and layout, and
    device ms of a decode pass and a 64-row prefill chunk (the graphs'
    replays), the two engines alternated over 5 rounds."""
    from repro_torch.kernels import autotune
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    c = cfg.replace(quant=cfg.quant.replace(kv_bits=4))
    ecfg = EngineConfig(max_batch=4, max_len=512, prefill_chunk=16)
    prompts, _ = serve_prompts(np, cfg)
    engines, rec, first, outs, plans = {}, {}, {}, {}, {}
    for mode, cache in (("tuned", tuned),
                        ("heuristic", autotune.TuningCache(device="cuda"))):
        autotune.set_active_cache(cache)
        eng = engines[mode] = ServingEngine(c, params, config=ecfg,
                                            device=dev)
        rows = rec[mode] = {}
        real_emit, real_decode = eng._emit_token, eng._decode

        def emit(s, logits_row, *, decode_pass, _e=eng, _r=rows,
                 _real=real_emit):
            req = _e.slot_req[s]
            _r[(req.uid, len(req.output))] = np.array(logits_row,
                                                      np.float32)
            return _real(s, logits_row, decode_pass=decode_pass)

        def decode(*a, _mode=mode, _real=real_decode, **k):
            out = _real(*a, **k)
            if _mode not in first:
                first[_mode] = out[0].float().clone()
            return out

        eng._emit_token, eng._decode = emit, decode
        outs[mode] = [r.output for r in serve_requests(eng, prompts, 32,
                                                       paged=False)]
        eng._emit_token, eng._decode = real_emit, real_decode
        plans[mode] = {}
        for p in eng.plan_report():
            kk = (p["source"], p["spec"], p["op"])
            plans[mode][" ".join(kk)] = plans[mode].get(" ".join(kk), 0) + 1
    autotune.reset_active_cache()
    divergences = []
    for uid, (h_out, t_out) in enumerate(zip(outs["heuristic"],
                                             outs["tuned"])):
        at = next((i for i in range(32) if h_out[i] != t_out[i]), None)
        if at is None:
            continue
        h_row, t_row = rec["heuristic"][(uid, at)], rec["tuned"][(uid, at)]
        top2 = np.sort(h_row)[-2:]
        margin, diff = float(top2[1] - top2[0]), float(
            np.abs(t_row - h_row).max())
        divergences.append({"request": uid, "at": at, "top2_margin": margin,
                            "row_diff": diff})
        if margin > 2 * diff:
            raise AssertionError(f"autotune serve: request {uid} diverges at "
                                 f"{at} with a top-2 margin {margin} above "
                                 f"2 x the row difference {diff}")
    ms = {mode: {"decode": [], "prefill_chunk": []} for mode in engines}
    for _ in range(5):
        for mode, eng in engines.items():
            ms[mode]["decode"].append(replay_ms(torch, eng._decode))
            ms[mode]["prefill_chunk"].append(replay_ms(torch, eng._prefill))
    line = {
        "tokens_equal": outs["tuned"] == outs["heuristic"],
        "divergences": divergences,
        "first_decode_max_logit_diff": float(
            (first["tuned"] - first["heuristic"]).abs().max()),
        "plans": plans,
        "device_ms_decode_pass": {m: v["decode"] for m, v in ms.items()},
        "device_ms_prefill_chunk_64_rows": {m: v["prefill_chunk"]
                                            for m, v in ms.items()},
        "median_ms": {m: {kk: None if None in v else statistics.median(v)
                          for kk, v in d.items()} for m, d in ms.items()}}
    print("autotune serve " + json.dumps(line))
    del engines, params
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# Sliding-window MoE serving and the legacy read: the moe serve, moe ring,
# moe reduced and legacy lines
# ---------------------------------------------------------------------------

MOE_LAYERS, MOE_NEW = 4, 8
#: Prompt tokens a ``moe serve`` request: the serve prompts (17-100
#: tokens) cut, a depth cut that keeps the whole script inside its time
#: limit.
MOE_PROMPT = 16
#: The moe serve lines' decode replay time: the median of MOE_REPLAYS[0]
#: timings of MOE_REPLAYS[1] replays each
MOE_REPLAYS = (5, 8)
MOE_RING_PROMPT, MOE_RING_STEPS = 4160, 8
# profiler ranges of the port (core/quant.py, models/moe.py,
# models/attention.py), read in an eager decode pass
MOE_RANGES = ("fake_quant", "expert_gemm", "moe_dispatch", "moe_combine",
              "legacy_attention")
LEGACY_NEW = 8


def moe_config(kv_bits, *, reduced=False, name="mixtral-8x7b",
               layers=MOE_LAYERS):
    """mixtral at full width cut to ``layers`` of its layers (the reduced
    config as it is), W2A2 on the int16xP2s8 lanes, at ``kv_bits``."""
    from repro_torch import configs

    cfg = configs.get_config(name, reduced=reduced)
    if not reduced:
        cfg = cfg.replace(num_layers=layers)
    return cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))


def recorded_serve(np, eng, prompts, new):
    """Serve ``prompts`` (``serve_requests``' schedule), keeping every
    emitted logits row by (uid, token index) and every decode pass's live
    rows' logits (copied out of the graph's static tensor)."""
    rows, passes = {}, []
    real_emit, real_decode = eng._emit_token, eng._decode

    def emit(s, logits_row, *, decode_pass):
        req = eng.slot_req[s]
        rows[(req.uid, len(req.output))] = np.array(logits_row, np.float32)
        return real_emit(s, logits_row, decode_pass=decode_pass)

    def decode(params, caches, batch, index, valid, *a):
        out = real_decode(params, caches, batch, index, valid, *a)
        passes.append(out[0].float().cpu()[np.asarray(valid) > 0])
        return out

    eng._emit_token, eng._decode = emit, decode
    try:
        outs = [r.output for r in serve_requests(eng, prompts, new,
                                                 paged=eng.paged)]
    finally:
        # the class's method again: an instance attribute holding a bound
        # method would keep the engine (params, graph pools) alive in a
        # cycle past ``del``, until the garbage collector runs
        del eng._emit_token
        eng._decode = real_decode
    return outs, rows, passes


def token_divergences(np, label, want, want_rows, got, got_rows, *,
                      strict):
    """Each request's first divergence from ``want`` with the ``want``
    row's top-2 margin and the two rows' largest difference; raises on any
    divergence when ``strict``, else (the ``spec`` lines' rule) unless the
    margin is at most 2 x the difference."""
    out = []
    for uid, (w, g) in enumerate(zip(want, got)):
        at = next((i for i in range(len(w)) if w[i] != g[i]), None)
        if at is None:
            continue
        wr, gr = want_rows[(uid, at)], got_rows[(uid, at)]
        top2 = np.sort(wr)[-2:]
        margin, diff = float(top2[1] - top2[0]), float(np.abs(gr - wr).max())
        out.append({"request": uid, "at": at, "top2_margin": margin,
                    "row_diff": diff})
        if strict or margin > 2 * diff:
            raise AssertionError(f"{label}: request {uid} diverges at token "
                                 f"{at} (top-2 margin {margin}, row "
                                 f"difference {diff})")
    return out


def max_pass_diff(a, b):
    """The largest logit difference over the decode passes both runs made
    with the same tokens (every pass when their tokens are equal; else the
    first pass)."""
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def eager_ranges(torch, np, cfg, params, caches, b, pos, ranges=MOE_RANGES):
    """One eager decode pass (``steps.make_decode_step``) at offsets
    ``pos`` under torch.profiler: device ms of the kernels launched inside
    each of the port's ``ranges`` and in all."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    step = steps.make_decode_step(cfg)
    tokens = {"tokens": np.zeros((b, 1), np.int32)}
    step(params, caches, tokens, pos, np.ones(b, np.int32))   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, caches, tokens, pos, np.ones(b, np.int32))
        torch.cuda.synchronize()
    cpu = range_rows(torch, prof, ranges)
    kernels = [e for e in device_rows(torch, prof) if e.key not in ranges]
    out = {"eager_device_ms": sum(e.self_device_time_total
                                  for e in kernels) / 1e3}
    for name in ranges:
        out[f"{name}_range_ms"] = cpu[name]["device_time_total"] / 1e3
    return out


def moe_serve_phase(torch, np, dev, smi):
    """The ``moe serve`` lines: mixtral-8x7b at full width cut to 4 of its
    32 layers (seed-0 weights), W2A2 at kv 16 and kv 4,
    ``EngineConfig(max_batch=4, max_len=512)`` (the prefill chunk clamped
    to 1 by the ring), the serve phase's four prompts cut to MOE_PROMPT
    tokens, MOE_NEW greedy tokens each on the graphed engine, then on an
    engine with
    ``backend='torch'``: tokens equal (gated), the largest logit
    difference over every decode pass, every packed linear one fused K2
    launch (``check_k2_path``).  Every engine serves one tree prepared
    once (``prepare_serving_params``: the experts' lattices derived
    there).  Records decode ms a pass (wall, and the graph's replay on the
    device), the idle share, the graph's device ms by kernel group and an
    eager pass's ms by the port's ranges, peak memory and param bytes.
    Returns the float params (the ring's fake-quant prefill reads them),
    the prepared tree and the fused K2 and cache-write launches of the
    graphed runs."""
    from repro_torch.kernels import cache_write, quant_pack, \
        ulppack_attention, ulppack_matmul
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, ServingEngine
    from repro_torch.serve.prepare import prepare_serving_params

    base = moe_config(16)
    t0 = time.perf_counter()
    params = lm.init_params(base, torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = prepare_serving_params(params, base, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    # the ring clamps the prefill chunk to 1, so every prompt token is a
    # pass: the serve prompts cut to MOE_PROMPT tokens
    prompts = [p[:MOE_PROMPT] for p in serve_prompts(np, base)[0]]
    ecfg = EngineConfig(max_batch=4, max_len=512)
    launches = {"quantized_linear_mma": 0, "cache_write": 0}
    for kv_bits in (16, 4):
        c = moe_config(kv_bits)
        for mod in (quant_pack, ulppack_matmul, ulppack_attention,
                    cache_write):
            mod.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(c, packed, config=ecfg, device=dev)
        check_prepared_experts(eng, packed, f"moe serve kv{kv_bits}")
        t0 = time.perf_counter()
        outs, rows, passes = recorded_serve(np, eng, prompts, MOE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        k2 = check_k2_path(f"moe serve kv{kv_bits}")
        if ulppack_attention.kernel_launches["attention_decode"]:
            raise AssertionError("moe serve: a windowed read reached K3")
        launches["quantized_linear_mma"] += k2
        launches["cache_write"] += cache_write.kernel_launches["cache_write"]
        m, cap = eng.metrics.report(), eng.capacity_report()
        replay = statistics.median(replay_ms(torch, eng._decode,
                                             n=MOE_REPLAYS[1])
                                   for _ in range(MOE_REPLAYS[0]))
        groups = profile_replay(torch, eng._decode)
        ranges = eager_ranges(torch, np, c, eng.params, eng.caches,
                              eng.max_batch, eng.slot_pos.copy())
        line = {"card": smi, "kv_bits": kv_bits,
                "layers": f"{MOE_LAYERS} of 32",
                "prefill_chunk": eng.prefill_chunk,
                "ring_slots": eng.caches[0]["attn"]["k"].shape[1],
                "slots": eng.max_batch, "wall_s": wall,
                "steps": m["steps"],
                "decode_passes": eng.metrics.decode_passes,
                "decode_step_ms_wall": m["decode_step_ms"],
                "decode_replay_ms": replay,
                "idle_share": 1 - replay / m["decode_step_ms"],
                "decode_tok_s": m["decode_tok_s"],
                "graph_device_ms_by_group": groups, **ranges,
                "fused_k2_launches": k2,
                "step_setup_s": cap["step_setup_s"],
                "param_bytes": cap["param_bytes"],
                "cache_bytes": cap["cache_bytes"],
                "peak_memory_bytes": peak, "init_params_s": init_s,
                "prepare_s": prep_s}
        del eng
        torch.cuda.empty_cache()
        ref = ServingEngine(c, packed, config=ecfg, device=dev,
                            backend="torch")
        ref_outs, ref_rows, ref_passes = recorded_serve(np, ref, prompts,
                                                        MOE_NEW)
        del ref
        torch.cuda.empty_cache()
        token_divergences(np, f"moe serve kv{kv_bits}", ref_outs, ref_rows,
                          outs, rows, strict=True)
        line.update(tokens_equal=True, requests=len(outs),
                    prompt_tokens=MOE_PROMPT, new_tokens=MOE_NEW,
                    replay_timings=list(MOE_REPLAYS),
                    max_logit_diff_vs_torch=max_pass_diff(passes,
                                                          ref_passes))
        print("moe serve " + json.dumps(line))
    print(smi)
    return params, packed, launches


def check_prepared_experts(eng, packed, where):
    """The engine serves ``packed`` as it is: its experts are the tree's
    lattices (no ``w_step``, so no forward fake-quantizes them) and no
    leaf was copied."""
    for mine, theirs in zip(eng.params["layers"], packed["layers"]):
        if "moe" not in mine:
            continue
        for name in ("up", "gate", "down"):
            node = mine["moe"][name]
            if "w_step" in node or node["kernel"] is not \
                    theirs["moe"][name]["kernel"]:
                raise AssertionError(f"{where}: the engine's {name} experts "
                                     f"are not the prepared lattices")


def moe_ring_phase(torch, np, dev, params, packed, smi):
    """The ``moe ring`` line: the moe serve config at B1 and kv 4: the
    fake-quant prefill (``steps.make_prefill_step``) of a 4,160-token
    prompt into a 4,096-slot ring (the last 4,096 tokens, token j at slot j
    % 4096: the reference's roll), then MOE_RING_STEPS graphed decode steps
    past the wrap and the same steps with ``backend='torch'`` on a copy of
    the ring, each fed the kernel path's greedy token: every step's argmax
    equal (gated) and finite, the largest logit difference, decode replay
    ms.  The prefill reads the float ``params``, the decode steps the
    prepared tree ``packed``.  Returns the fused K2 launches of the
    graphed steps."""
    from repro_torch import tree
    from repro_torch.kernels import ulppack_matmul
    from repro_torch.launch import steps

    c = moe_config(4)
    prompt = np.random.default_rng(SEED + 11).integers(
        0, c.vocab_size, (1, MOE_RING_PROMPT)).astype(np.int32)
    max_len = MOE_RING_PROMPT + MOE_RING_STEPS + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last, caches = steps.make_prefill_step(c, max_len)(params,
                                                       {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    ring = caches[0]["attn"]["k"].shape[1]
    plain_caches = tree.tree_map(lambda t: t.clone(), caches)
    dec, _ = steps.graphed_serving_steps(c, packed, caches, batch=1,
                                         prefill_chunk=1)
    plain = steps.make_decode_step(c, backend="torch")
    mma0 = ulppack_matmul.mma_launches["quant_affine"]
    tok = last.float().argmax(dim=-1).cpu().numpy().astype(np.int32)
    diffs, agree = [], []
    one = np.ones(1, np.int32)
    for i in range(MOE_RING_STEPS):
        pos = np.full(1, MOE_RING_PROMPT + i, np.int32)
        got = dec(packed, caches, {"tokens": tok[:, None]}, pos,
                  one)[0].float().clone()
        want = plain(packed, plain_caches, {"tokens": tok[:, None]}, pos,
                     one)[0].float()
        if not torch.isfinite(got).all():
            raise AssertionError("moe ring: non-finite logits")
        diffs.append(float((got - want).abs().max()))
        agree.append(bool(torch.equal(got.argmax(-1), want.argmax(-1))))
        tok = got.argmax(dim=-1).cpu().numpy().astype(np.int32)
    if not all(agree):
        raise AssertionError(f"moe ring: greedy tokens differ from the "
                             f"'torch' backend's at steps {agree}")
    line = {"card": smi, "kv_bits": 4, "batch": 1,
            "layers": f"{MOE_LAYERS} of 32",
            "prompt_tokens": MOE_RING_PROMPT, "ring_slots": ring,
            "wrapped_by": MOE_RING_PROMPT - ring,
            "decode_steps_past_wrap": MOE_RING_STEPS,
            "prefill_s": prefill_s, "prefill_peak_memory_bytes": prefill_peak,
            "greedy_agree_per_step": agree, "max_logit_diff": max(diffs),
            "per_step_max_logit_diff": diffs,
            "decode_replay_ms": replay_ms(torch, dec),
            "capture_s": dec.capture_s}
    print("moe ring " + json.dumps(line))
    print(smi)
    k2 = ulppack_matmul.mma_launches["quant_affine"] - mma0
    del dec, caches, plain_caches
    torch.cuda.empty_cache()
    return k2


def moe_reduced_phase(torch, np, dev, smi):
    """The ``moe reduced`` line: reduced mixtral-8x22b (2 layers, d 64, 4
    experts, window 8) at kv 4 through the graphed engine on the card and
    through one with ``backend='torch'``: the serve phase's prompts, past
    the ring of 8 slots, 8 greedy tokens each, tokens equal (gated)."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    c = moe_config(4, reduced=True, name="mixtral-8x22b")
    params = lm.init_params(c, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    prompts, _ = serve_prompts(np, c)
    ecfg = EngineConfig(max_batch=4, max_len=128)
    runs, graphed = {}, {}
    for be in ("auto", "torch"):
        eng = ServingEngine(c, params, config=ecfg, device=dev, backend=be)
        runs[be] = recorded_serve(np, eng, prompts, 8)
        graphed[be] = eng._decode.graph is not None
        del eng
    if not graphed["auto"]:
        raise AssertionError("moe reduced: the engine captured no graphs")
    token_divergences(np, "moe reduced", runs["torch"][0], runs["torch"][1],
                      runs["auto"][0], runs["auto"][1], strict=True)
    line = {"card": smi, "config": c.name, "reduced": True, "kv_bits": 4,
            "layers": c.num_layers, "d_model": c.d_model,
            "experts": c.num_experts, "window": c.sliding_window,
            "graphed": graphed, "tokens_equal": True,
            "max_logit_diff_vs_torch": max_pass_diff(runs["auto"][2],
                                                     runs["torch"][2])}
    print("moe reduced " + json.dumps(line))
    print(smi)


def legacy_read_rows(torch, dev, smi):
    """The legacy read against the fused kernels on one stored cache at
    stablelm-1.6b's heads (B4 S512 H32 hd64 C1), kv 16 / 4 / 2, contiguous
    (K3) and paged through a scrambled table (K4): within ATTN_TOL with f32
    queries, where the two differ only in summation order (gated; with
    bf16 queries the legacy read rounds the scaled queries and the
    probabilities to bf16, as the reference's does), and the device ms of
    each read at the path's bf16 queries."""
    from repro_torch import configs
    from repro_torch.kernels import ulppack_attention
    from repro_torch.models import attention

    cfg = configs.get_config("stablelm-1.6b")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    b, s, ps = 4, 512, 16
    hd, kvh = cfg.resolved_head_dim, cfg.num_kv_heads
    vl = torch.tensor([17, 100, 300, 512], dtype=torch.int32, device=dev)
    qpos = (vl - 1)[:, None]
    out = []
    for kv_bits in (16, 4, 2):
        c = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
        k = torch.randn((b, s, kvh, hd), generator=gen, device=dev) * 2
        v = torch.randn((b, s, kvh, hd), generator=gen, device=dev)
        cache = attention.init_kv_cache(c, b, s, device=dev)
        _, _, dest, _ = attention.window(torch.zeros(b, dtype=torch.int32,
                                                     device=dev), vl, None,
                                         b, s, cache["k"].shape, dev)
        attention.cache_write(cache, k.bfloat16(), v.bfloat16(), dest,
                              kv_bits)
        npg = s // ps
        perm = torch.randperm(b * npg, generator=gen, device=dev)
        bt = perm.reshape(b, npg).to(torch.int32)
        pool = attention.init_paged_kv_cache(c, b * npg, ps, device=dev)
        for name, t in cache.items():
            pool[name][bt.reshape(-1).long()] = t.reshape(
                b * npg, ps, *t.shape[2:])
        kv_pos = attention.ring_positions_batch(vl - 1, s, 0)
        for paged in (False, True):
            st, tables = (pool, bt) if paged else (cache, None)
            row = {"card": smi, "kv_bits": kv_bits, "paged": paged}
            for qdt in (torch.float32, torch.bfloat16):
                q = (torch.randn((b, 1, cfg.num_heads, hd), generator=gen,
                                 device=dev) * 2).to(qdt)

                def fused():
                    return ulppack_attention.fused_decode_attention(
                        q, st, vl, qpos, kv_bits=kv_bits, hd=hd,
                        block_tables=tables)

                def legacy():
                    return attention.legacy_read(c, q, st, kv_pos, qpos, qdt,
                                                 block_tables=tables)
                f, lg = fused().float(), legacy().float()
                diff = float((f - lg).abs().max())
                if qdt == torch.float32:
                    bound = ATTN_TOL * (1 + float(f.abs().max()))
                    if diff > bound:
                        raise AssertionError(
                            f"legacy read kv{kv_bits} paged={paged}: "
                            f"{diff} from the fused read, above {bound}")
                    row["f32_max_abs_diff"] = diff
                else:
                    row["bf16_max_abs_diff"] = diff
                    row["fused_ms"] = time_eager_ms(torch, fused)
                    row["legacy_ms"] = time_eager_ms(torch, legacy)
            out.append(row)
    return out


def legacy_phase(torch, np, dev, cfg, params, smi):
    """The ``legacy`` lines: ``legacy_read_rows``, then full-width
    stablelm-1.6b engines at kv 16 / 4 / 2, contiguous and paged (page
    16), each built and run with the fused read and under
    ``REPRO_FUSED_DECODE=0`` (the kill-switch is read when the steps are
    captured): the serve phase's prompts, LEGACY_NEW greedy tokens each,
    tokens equal to the fused engine's or a divergence inside the ``spec``
    lines' margin rule (gated), the largest logit difference over the
    decode passes, and the decode graph's replay ms for each read.  The
    legacy engines launch no K3/K4 (gated).  Returns the K3 and K4
    launches of the fused engines."""
    from repro_torch.kernels import ulppack_attention
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    for row in legacy_read_rows(torch, dev, smi):
        print("legacy read " + json.dumps(row))
    prompts, _ = serve_prompts(np, cfg)
    launches = {"attention_decode": 0, "attention_decode_paged": 0}
    for kv_bits in (16, 4, 2):
        c = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
        for paged in (False, True):
            ecfg = EngineConfig(max_batch=4, max_len=512, prefill_chunk=16,
                                **(dict(paged=True, page_size=16)
                                   if paged else {}))
            runs, ms = {}, {}
            for read in ("fused", "legacy"):
                before = dict(ulppack_attention.kernel_launches)
                ctx = (ulppack_attention.disabled() if read == "legacy"
                       else contextlib.nullcontext())
                with ctx:
                    eng = ServingEngine(c, params, config=ecfg, device=dev)
                    runs[read] = recorded_serve(np, eng, prompts, LEGACY_NEW)
                ms[read] = statistics.median(replay_ms(torch, eng._decode)
                                             for _ in range(3))
                del eng
                n = {k: ulppack_attention.kernel_launches[k] - before[k]
                     for k in launches}
                if read == "legacy" and any(n.values()):
                    raise AssertionError(f"legacy kv{kv_bits}: the kill-"
                                         f"switch engine launched {n}")
                if read == "fused":
                    for k in launches:
                        launches[k] += n[k]
            torch.cuda.empty_cache()
            div = token_divergences(
                np, f"legacy kv{kv_bits} paged={paged}", runs["fused"][0],
                runs["fused"][1], runs["legacy"][0], runs["legacy"][1],
                strict=False)
            same = runs["fused"][0] == runs["legacy"][0]
            passes = (runs["fused"][2], runs["legacy"][2]) if same else (
                runs["fused"][2][:1], runs["legacy"][2][:1])
            line = {"card": smi, "kv_bits": kv_bits, "paged": paged,
                    "tokens_equal": same, "divergences": div,
                    "max_logit_diff" if same else
                    "first_decode_max_logit_diff": max_pass_diff(*passes),
                    "decode_replay_ms": ms}
            print("legacy " + json.dumps(line))
    print(smi)
    return launches


# ---------------------------------------------------------------------------
# mixtral-8x22b at full width: the moe 8x22b lines
# ---------------------------------------------------------------------------

MOE_WIDE = "mixtral-8x22b"
#: mixtral-8x22b's depth on the card, a cut of memory alone: a layer holds
#: 4.83 GB of bf16 expert lattices and 0.088 GB of lanes, the embedding and
#: the untied head 0.81 GB, so 14 of its 56 layers are 69.7 GB.  The
#: layer-at-a-time build peaks ~6.2 GB above the finished tree (the last
#: block's float experts beside their lattices): 75.9 GB at 14 layers on
#: an H100 80GB HBM3, so ~80.8 at 15, within ~4 GB of what the card holds
#: (``card_memory_bytes`` on the line) before the memory the whole run
#: holds ahead of these lines
MOE_WIDE_LAYERS = 14
MOE_WIDE_CUT = (f"{MOE_WIDE_LAYERS} of 56 layers (memory): 4.92 GB a "
                f"layer; the build peaks ~6.2 GB above the tree, 75.9 GB "
                f"at 14 layers, ~80.8 at 15")
#: its packed linears (the attention projections; the experts are library
#: GEMMs over bf16 lattices), at the decode rows and a 64-row chunk's:
#: (layer, k, n)
MOE_WIDE_K2_SHAPES = (("q/o", 6144, 6144), ("k/v", 6144, 1024))
MOE_WIDE_K2_ROWS = (4, 64)


def moe_wide_k2_rows(torch, peaks, dev, gen):
    """``fused_quant_row`` at mixtral-8x22b's packed-linear shapes
    (``MOE_WIDE_K2_SHAPES``) at 4 and 64 rows: bit-equal to cast + K1 +
    K2-affine and to the plain version (gated), timed against its bound.
    Prints a ``moe 8x22b k2`` line a row."""
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec

    sp = PackSpec.parse("W2A2/int16xP2s8")
    rows = []
    for layer, k, n in MOE_WIDE_K2_SHAPES:
        qw = torch.randint(0, sp.max_w + 1, (k, n), generator=gen,
                           device=dev, dtype=torch.int32)
        w = packing.pack_weights(qw, sp)
        ws = [w] + [w.clone() for _ in range(copies_for(w.numel() *
                                                        sp.lane_bytes) - 1)]
        for m in MOE_WIDE_K2_ROWS:
            r = fused_quant_row(torch, peaks, dev, gen, sp, m, k, n, qw, ws,
                                None)
            r.update(config=MOE_WIDE, layer=layer)
            print("moe 8x22b k2 " + json.dumps(r))
            rows.append(r)
        del qw, w, ws
    torch.cuda.empty_cache()
    return rows


def expert_bytes(packed) -> int:
    """Bytes of a serving tree's 3-D expert kernels."""
    return sum(layer["moe"][n]["kernel"].numel()
               * layer["moe"][n]["kernel"].element_size()
               for layer in packed["layers"] if "moe" in layer
               for n in ("up", "gate", "down"))


def moe_wide_phase(torch, np, dev, peaks, smi):
    """The ``moe 8x22b`` lines: the K2 rows at its shapes, then
    mixtral-8x22b at full width (d_model 6,144, 48 heads on 8 kv heads of
    128, d_ff 16,384, 8 experts top-2, window 4,096, vocab 32,768) cut to
    MOE_WIDE_LAYERS of its 56 layers, W2A2 on the int16xP2s8 lanes, kv 4,
    seed-0 weights built a layer at a time (``build_packed_params``: the
    experts' lattices derived there), one tree for both engines.
    ``EngineConfig(max_batch=4, max_len=512)`` (the ring clamps the
    prefill chunk to 1), the serve prompts cut to MOE_PROMPT tokens,
    MOE_NEW greedy tokens each on the graphed engine, then on one with
    ``backend='torch'``.  Gated: tokens equal (strict); every packed
    linear one fused K2 launch (``check_k2_path``), 4 a layer a decode
    pass; no K3 launch (a windowed read is the legacy read); every window
    write one launch of the write kernel; both graphs captured; the
    engine serving the tree's lattices.  Records the graph's device ms by
    kernel group, an eager pass's by range, wall and replay ms, the idle
    share, param, expert and lane bytes, the build's peak and seconds,
    the serving peak, the largest logit difference from ``'torch'``.
    Returns the graphed run's K2 and window-write launches."""
    from repro_torch.kernels import cache_write, ulppack_attention as att
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    moe_wide_k2_rows(torch, peaks, dev, torch.Generator(
        device=dev).manual_seed(SEED + 36))
    mark("moe 8x22b k2")
    label = "moe 8x22b"
    c = moe_config(4, name=MOE_WIDE, layers=MOE_WIDE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packed = build_packed_params(c, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    build_peak = torch.cuda.max_memory_allocated() - held
    mark("moe 8x22b build")
    prompts = [p[:MOE_PROMPT] for p in serve_prompts(np, c)[0]]
    ecfg = EngineConfig(max_batch=4, max_len=512)
    reset_kernel_counts()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(c, packed, config=ecfg, device=dev)
    engine_s = time.perf_counter() - t0
    check_prepared_experts(eng, packed, label)
    t0 = time.perf_counter()
    outs, rows, passes = recorded_serve(np, eng, prompts, MOE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    if eng._decode.graph is None or eng._prefill.graph is None:
        raise AssertionError(f"{label}: the engine captured no graphs")
    k2 = check_k2_path(label)
    per_pass = decode_graph_launches(eng._decode)
    writes = (cache_write.kernel_launches["cache_write"],
              cache_write.plain_calls["cache_write"])
    if att.kernel_launches["attention_decode"] or per_pass["k3"]:
        raise AssertionError(f"{label}: a windowed read reached K3")
    if per_pass["k2"] != 4 * c.num_layers or not writes[0] or writes[1]:
        raise AssertionError(f"{label}: {per_pass} launches a decode pass, "
                             f"window writes (launches, plain) {writes}")
    m, cap = eng.metrics.report(), eng.capacity_report()
    replay = statistics.median(replay_ms(torch, eng._decode, MOE_REPLAYS[1])
                               for _ in range(MOE_REPLAYS[0]))
    groups = profile_replay(torch, eng._decode)
    ranges = eager_ranges(torch, np, c, eng.params, eng.caches,
                          eng.max_batch, eng.slot_pos.copy())
    line = {"card": smi, "config": MOE_WIDE, "kv_bits": 4,
            "layers": f"{c.num_layers} of 56", "cut": MOE_WIDE_CUT,
            "d_model": c.d_model,
            "heads": f"{c.num_heads} / {c.num_kv_heads} x "
                     f"{c.resolved_head_dim}",
            "d_ff": c.d_ff, "experts": f"{c.num_experts} top-"
                                       f"{c.num_experts_per_tok}",
            "window": c.sliding_window, "vocab": c.vocab_size,
            "ring_slots": eng.caches[0]["attn"]["k"].shape[1],
            "slots": eng.max_batch, "prefill_chunk": eng.prefill_chunk,
            "requests": len(outs), "prompt_tokens": MOE_PROMPT,
            "new_tokens": MOE_NEW, "build": "a layer at a time",
            "build_s": build_s, "build_peak_above_held_bytes": build_peak,
            "held_before_build_bytes": held,
            "card_memory_bytes": torch.cuda.get_device_properties(
                dev).total_memory,
            "engine_build_s": engine_s,
            "capture_s": {"decode": eng._decode.capture_s,
                          "prefill": eng._prefill.capture_s},
            "wall_s": wall, "steps": m["steps"],
            "decode_passes": eng.metrics.decode_passes,
            "decode_step_ms_wall": m["decode_step_ms"],
            "decode_replay_ms": replay,
            "idle_share": 1 - replay / m["decode_step_ms"],
            "decode_tok_s": m["decode_tok_s"],
            "graph_device_ms_by_group": groups, **ranges,
            "launches_a_decode_pass": per_pass, "fused_k2_launches": k2,
            "cache_write_launches": writes[0],
            "replay_timings": list(MOE_REPLAYS),
            "param_bytes": cap["param_bytes"],
            "expert_bytes": expert_bytes(packed), **packed_bytes_split(packed),
            "cache_bytes": cap["cache_bytes"],
            "held_before_engine_bytes": before,
            "serving_peak_above_params_bytes": peak}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = ServingEngine(c, packed, config=ecfg, device=dev, backend="torch")
    ref_outs, ref_rows, ref_passes = recorded_serve(np, ref, prompts,
                                                    MOE_NEW)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    token_divergences(np, label, ref_outs, ref_rows, outs, rows, strict=True)
    line.update(tokens_equal=True, torch_backend_s=time.perf_counter() - t0,
                max_logit_diff_vs_torch=max_pass_diff(passes, ref_passes))
    print("moe 8x22b " + json.dumps(line))
    print(smi)
    del packed
    held_check(torch, held, label)
    return {"quantized_linear_mma": k2, "cache_write": writes[0]}


def moe_pass(torch, np, src):
    """``python3 chip_smoke.py --moe-pass SRC``: the graphed decode pass
    of mixtral-8x7b (MOE_LAYERS of 32 layers) and of jamba-1.5-large-398b
    (JAMBA_LAYERS of 72), kv 4, seed-0 weights built a layer at a time
    (``build_packed_params``: the tree the package's serving prep makes),
    with the package under ``SRC`` -- this checkout's ``src``, or another
    tree's unpacked beside it (``git archive`` into ``build/parent``): run
    both in one call, parent / this / this / parent, to compare the two
    trees' MoE passes on one card.  The serve prompts (mixtral's cut to
    MOE_PROMPT tokens) admitted and prefilled, two decode steps, then
    MOE_REPLAYS[0] timings of MOE_REPLAYS[1] replays of the decode graph
    and one profiled pair (device ms by kernel group).  Prints a ``moe
    pass`` line a config."""
    from repro_torch.serve.engine import EngineConfig, Request, \
        ServingEngine

    dev = torch.device("cuda")
    for c, ecfg, cut in ((moe_config(4), dict(max_batch=4, max_len=512),
                          MOE_PROMPT),
                         (recurrent_config(JAMBA, kv_bits=4), REC_ECFG,
                          None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = build_packed_params(c, torch.Generator(
            device=dev).manual_seed(SEED), dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        eng = ServingEngine(c, packed, config=EngineConfig(**ecfg),
                            device=dev)
        for i, p in enumerate(serve_prompts(np, c)[0]):
            eng.submit(Request(i, p[:cut], max_new_tokens=16))
        while any(eng.slot_req[s] is not None
                  and eng.slot_fed[s] < len(eng.slot_req[s].prompt)
                  for s in range(eng.max_batch)):
            eng.step()
        for _ in range(2):
            eng.step()
        replays = [replay_ms(torch, eng._decode, MOE_REPLAYS[1])
                   for _ in range(MOE_REPLAYS[0])]
        moe = next(layer["moe"] for layer in eng.params["layers"]
                   if "moe" in layer)
        print("moe pass " + json.dumps({
            "src": str(src), "config": c.name, "layers": c.num_layers,
            "card": torch.cuda.get_device_name(0),
            "experts": "float, fake-quantized every pass"
                       if "w_step" in moe["up"] else "prepared lattices",
            "build_s": build_s,
            "param_bytes": eng.capacity_report()["param_bytes"],
            "decode_replay_ms": replays,
            "decode_replay_ms_median": statistics.median(replays),
            "graph_device_ms_by_group": profile_replay(torch, eng._decode)}),
            flush=True)
        del eng, packed, moe
        gc.collect()
        torch.cuda.empty_cache()
    return 0


# ---------------------------------------------------------------------------
# recurrent lines: xlstm-1.3b and jamba-1.5-large-398b
# ---------------------------------------------------------------------------

XLSTM, JAMBA = "xlstm-1.3b", "jamba-1.5-large-398b"
JAMBA_LAYERS = 5
REC_NEW = {XLSTM: 4, JAMBA: 4}
REC_ECFG = dict(max_batch=4, max_len=512, prefill_chunk=16)
# profiler ranges of the port read in an eager decode pass (core/quant.py,
# models/mamba.py, models/xlstm.py, models/moe.py)
REC_RANGES = ("fake_quant", "mamba_scan", "mlstm", "slstm", "expert_gemm",
              "moe_dispatch", "moe_combine")
# the packed linears of the two families at full width, (k, n) by layer,
# at the decode and the prefill-chunk rows of REC_ECFG
REC_K2_SHAPES = (("mamba in_proj", 8192, 32768),
                 ("mamba out_proj", 16384, 8192),
                 ("mamba x_proj", 16384, 544), ("mlstm up", 2048, 8192),
                 ("mlstm q/k/v", 4096, 4096), ("mlstm down", 4096, 2048),
                 ("slstm ffn_up", 2048, 5460),
                 ("slstm ffn_down", 2730, 2048))
REC_K2_ROWS = (4, 64)


def recurrent_config(name, *, reduced=False, kv_bits=None):
    """xlstm-1.3b whole, or jamba-1.5-large-398b at full width cut to its
    first JAMBA_LAYERS of 72 layers (mamba + MLP, mamba + MoE, mamba + MLP,
    mamba + MoE, attention + MLP); the reduced configs as they are.  W2A2
    on the int16xP2s8 lanes, at ``kv_bits`` when given."""
    from repro_torch import configs

    cfg = configs.get_config(name, reduced=reduced)
    if name == JAMBA and not reduced:
        cfg = cfg.replace(num_layers=JAMBA_LAYERS)
    if kv_bits is not None:
        cfg = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
    return cfg


def recurrent_prompts(np, cfg):
    """The serve phase's four prompts, then two more (21 and 40 tokens)
    that wait for a free slot: two slots are reused."""
    plain, _ = serve_prompts(np, cfg)
    rng = np.random.default_rng(SEED + 21)
    return plain + [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                    for n in (21, 40)]


def recurrent_k2_rows(torch, peaks, dev, gen):
    """The serving path's call (``quantized_linear_mma``: one launch of
    the tensor-core K2 with K1 folded in) at the recurrent families'
    packed-linear shapes, at the decode and prefill-chunk rows: bit-equal
    to the cast + K1 + K2 route and to the plain version, and timed
    (``fused_quant_row``).  Prints a ``recurrent k2`` line a row."""
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec

    sp = PackSpec.parse("W2A2/int16xP2s8")
    rows = []
    for layer, k, n in REC_K2_SHAPES:
        qw = torch.randint(0, sp.max_w + 1, (k, n), generator=gen,
                           device=dev, dtype=torch.int32)
        w = packing.pack_weights(qw, sp)
        ws = [w] + [w.clone() for _ in range(copies_for(w.numel() *
                                                        sp.lane_bytes) - 1)]
        for m in REC_K2_ROWS:
            r = fused_quant_row(torch, peaks, dev, gen, sp, m, k, n, qw, ws,
                                None)
            r["layer"] = layer
            print("recurrent k2 " + json.dumps(r))
            rows.append(r)
        del qw, w, ws
    torch.cuda.empty_cache()
    return rows


def recurrent_serve_phase(torch, np, dev, smi, name):
    """The ``recurrent serve`` line of ``name``: seed-0 weights at full
    width (xlstm-1.3b whole; jamba-1.5-large-398b cut to JAMBA_LAYERS of
    its 72 layers, at kv 4), built a layer at a time into one prepared
    tree for both engines (``build_packed_params``: jamba's float tree and
    its experts' lattices do not fit the card together),
    ``EngineConfig(**REC_ECFG)``, the
    ``recurrent_prompts`` (six requests through four slots),
    ``REC_NEW[name]`` greedy tokens each on the graphed engine, then on an
    engine with ``backend='torch'``: tokens equal (gated); every packed
    linear one fused K2 launch (``check_k2_path``); xlstm's largest logit
    difference over every decode pass 0.0 (gated: nothing on its path is
    inexact between the two), jamba's reported, and K3 launched on every
    pass of its one attention layer (gated).  Records decode ms a pass
    (wall, and the graph's replay on the device -- replays advance the
    recurrent states, after the run), the idle share, the graph's device
    ms by kernel group, an eager pass's ms by the port's ranges, param
    bytes, cache bytes a slot, the build's peak (above what the card held
    before) and the serving peak above the params; fails if the phase
    leaves more than 1 GiB allocated.  Returns the fused K2, K3 and
    cache-write launches of the graphed run."""
    from repro_torch.kernels import cache_write, quant_pack, \
        ulppack_attention, ulppack_matmul
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    jamba = name == JAMBA
    c = recurrent_config(name, kv_bits=4 if jamba else None)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_packed_params(c, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    build_peak = torch.cuda.max_memory_allocated() - held
    prompts = recurrent_prompts(np, c)
    new = REC_NEW[name]
    ecfg = EngineConfig(**REC_ECFG)
    for mod in (quant_pack, ulppack_matmul, ulppack_attention, cache_write):
        mod.reset_counts()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(c, params, config=ecfg, device=dev)
    check_prepared_experts(eng, params, f"recurrent serve {name}")
    t0 = time.perf_counter()
    outs, rows, passes = recorded_serve(np, eng, prompts, new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    k2 = check_k2_path(f"recurrent serve {name}")
    k3 = ulppack_attention.kernel_launches["attention_decode"]
    n_pass = eng._decode.replays + eng._prefill.replays
    if eng._decode.graph is None:
        raise AssertionError(f"recurrent serve {name}: no graphs captured")
    if jamba and k3 < n_pass:
        raise AssertionError(f"recurrent serve {name}: {k3} K3 launches "
                             f"over {n_pass} passes")
    if not jamba and (k3 or cache_write.kernel_launches["cache_write"]):
        raise AssertionError(f"recurrent serve {name}: an attention-free "
                             f"stack launched attention kernels")
    launches = {"quantized_linear_mma": k2, "attention_decode": k3,
                "cache_write": cache_write.kernel_launches["cache_write"]}
    m, cap = eng.metrics.report(), eng.capacity_report()
    replay = statistics.median(replay_ms(torch, eng._decode)
                               for _ in range(5))
    groups = profile_replay(torch, eng._decode)
    ranges = eager_ranges(torch, np, c, eng.params, eng.caches,
                          eng.max_batch, eng.slot_pos.copy(), REC_RANGES)
    kinds = [c.layer_kind(i) for i in range(c.num_layers)]
    line = {"card": smi, "config": name, "kv_bits": c.quant.kv_bits,
            "layers": (f"{c.num_layers} of 72" if jamba
                       else c.num_layers),
            "kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
            "moe_layers": sum(c.layer_is_moe(i)
                              for i in range(c.num_layers)),
            "d_model": c.d_model, "slots": eng.max_batch,
            "prefill_chunk": eng.prefill_chunk, "requests": len(outs),
            "new_tokens": new, "wall_s": wall, "steps": m["steps"],
            "decode_passes": eng.metrics.decode_passes,
            "decode_step_ms_wall": m["decode_step_ms"],
            "decode_replay_ms": replay,
            "idle_share": 1 - replay / m["decode_step_ms"],
            "decode_tok_s": m["decode_tok_s"],
            "graph_device_ms_by_group": groups, **ranges,
            "fused_k2_launches": k2, "k3_launches": k3,
            "graph_passes": n_pass, "step_setup_s": cap["step_setup_s"],
            "param_bytes": cap["param_bytes"],
            "cache_bytes_per_slot": cap["cache_bytes_per_slot"],
            "cache_bytes": cap["cache_bytes"],
            "build": "a layer at a time", "build_s": build_s,
            "held_before_bytes": held,
            "build_peak_above_held_bytes": build_peak,
            "peak_memory_above_params_bytes": peak}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ref = ServingEngine(c, params, config=ecfg, device=dev, backend="torch")
    ref_outs, ref_rows, ref_passes = recorded_serve(np, ref, prompts, new)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    token_divergences(np, f"recurrent serve {name}", ref_outs, ref_rows,
                      outs, rows, strict=True)
    diff = max_pass_diff(passes, ref_passes)
    if not jamba and diff != 0.0:
        raise AssertionError(f"recurrent serve {name}: logits differ from "
                             f"the 'torch' backend's by {diff}")
    line.update(tokens_equal=True, max_logit_diff_vs_torch=diff)
    print("recurrent serve " + json.dumps(line))
    print(smi)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.memory_allocated() > held + (1 << 30):
        raise AssertionError(f"recurrent serve {name}: "
                             f"{torch.cuda.memory_allocated() - held} bytes "
                             f"still held after the phase")
    return launches


def recurrent_reduced_phase(torch, np, dev, smi):
    """The ``recurrent reduced`` lines: reduced jamba (mamba + attention,
    MoE) at kv 4 contiguous and paged, and reduced xlstm, each through the
    graphed engine and one with ``backend='torch'``: the
    ``recurrent_prompts`` through four slots, 8 greedy tokens each, tokens
    equal (gated)."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    for name, kv, paged in ((JAMBA, 4, False), (JAMBA, 4, True),
                            (XLSTM, None, False)):
        c = recurrent_config(name, reduced=True, kv_bits=kv)
        params = lm.init_params(c, torch.Generator(device=dev).manual_seed(
            SEED), device=dev)
        prompts = recurrent_prompts(np, c)
        ecfg = EngineConfig(**REC_ECFG, paged=paged, page_size=16)
        runs, graphed = {}, {}
        for be in ("auto", "torch"):
            eng = ServingEngine(c, params, config=ecfg, device=dev,
                                backend=be)
            runs[be] = recorded_serve(np, eng, prompts, 8)
            graphed[be] = eng._decode.graph is not None
            del eng
        if not graphed["auto"]:
            raise AssertionError(f"recurrent reduced {name}: the engine "
                                 f"captured no graphs")
        token_divergences(np, f"recurrent reduced {name}", runs["torch"][0],
                          runs["torch"][1], runs["auto"][0],
                          runs["auto"][1], strict=True)
        line = {"card": smi, "config": name, "reduced": True,
                "kv_bits": c.quant.kv_bits, "paged": paged,
                "layers": c.num_layers, "d_model": c.d_model,
                "graphed": graphed, "tokens_equal": True,
                "max_logit_diff_vs_torch": max_pass_diff(runs["auto"][2],
                                                         runs["torch"][2])}
        print("recurrent reduced " + json.dumps(line))
        del params
        torch.cuda.empty_cache()
    print(smi)


def recurrent_phase(torch, np, dev, peaks, smi):
    """The recurrent families: the ``recurrent k2`` rows, the ``recurrent
    serve`` lines of xlstm-1.3b and jamba-1.5-large-398b, the ``recurrent
    reduced`` lines.  Returns the serve lines' kernel launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    recurrent_k2_rows(torch, peaks, dev, gen)
    mark("recurrent k2")
    launches = {"quantized_linear_mma": 0, "attention_decode": 0,
                "cache_write": 0}
    for name in (XLSTM, JAMBA):
        for k, n in recurrent_serve_phase(torch, np, dev, smi,
                                          name).items():
            launches[k] += n
        mark(f"recurrent serve {name}")
    recurrent_reduced_phase(torch, np, dev, smi)
    print(f"recurrent launches {launches}")
    print(smi)
    return launches


def moe_only(torch, np, peaks, smi):
    """``--moe``: the legacy lines on seed-0 full-width stablelm-1.6b, then
    the moe serve, moe ring, moe reduced and moe 8x22b lines."""
    from repro_torch import configs
    from repro_torch.models import lm

    dev = torch.device("cuda")
    cfg = configs.get_config("stablelm-1.6b")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    print(f"legacy launches {legacy_phase(torch, np, dev, cfg, params, smi)}")
    del params
    torch.cuda.empty_cache()
    moe_params, moe_packed, launches = moe_serve_phase(torch, np, dev, smi)
    launches["quantized_linear_mma"] += moe_ring_phase(
        torch, np, dev, moe_params, moe_packed, smi)
    del moe_params, moe_packed
    gc.collect()
    torch.cuda.empty_cache()
    moe_reduced_phase(torch, np, dev, smi)
    for k, n in moe_wide_phase(torch, np, dev, peaks, smi).items():
        launches[k] += n
    print(f"moe launches {launches}")
    print(smi)


# ---------------------------------------------------------------------------
# The dense LM configs served whole for the first time: granite-3-8b,
# minicpm-2b and qwen1.5-32b (the archs lines), and the two examples
# ---------------------------------------------------------------------------

GRANITE, MINICPM, QWEN = "granite-3-8b", "minicpm-2b", "qwen1.5-32b"
#: (config, kv settings) of the ``archs serve`` lines
ARCHS = ((GRANITE, (16, 4)), (MINICPM, (16, 4)), (QWEN, (4,)))
ARCHS_ECFG = dict(max_batch=4, max_len=512, prefill_chunk=16)
ARCHS_NEW = 4
#: the serve prompts cut to their first ARCHS_PROMPT tokens (17, 24, 24, 24)
ARCHS_PROMPT = 24
#: qwen1.5-32b's QKV biases are zero at init; the served tree gets them
#: drawn from N(0, ARCHS_BIAS_STD^2) (seed SEED + 35), so that the fused
#: epilogue adds a bias that moves the outputs
ARCHS_BIAS_STD = 0.1
# the packed linears of the three configs at full width: (config, layer,
# k, n, bias) at the decode and the prefill-chunk rows of ARCHS_ECFG
ARCHS_K2_SHAPES = ((GRANITE, "q/o", 4096, 4096, False),
                   (GRANITE, "k/v", 4096, 1024, False),
                   (GRANITE, "gate/up", 4096, 12800, False),
                   (GRANITE, "down", 12800, 4096, False),
                   (MINICPM, "q/k/v/o", 2304, 2304, False),
                   (MINICPM, "gate/up", 2304, 5760, False),
                   (MINICPM, "down", 5760, 2304, False),
                   (QWEN, "q/k/v (bias)", 5120, 5120, True),
                   (QWEN, "o", 5120, 5120, False),
                   (QWEN, "gate/up", 5120, 27392, False),
                   (QWEN, "down", 27392, 5120, False))
ARCHS_K2_ROWS = (4, 64)
# K3 / K4 at the two head layouts no earlier line read: minicpm's H36 hd64
# and qwen1.5's H40 hd128 (granite's GQA-4 hd128 is ATTN_CASES' second)
ARCHS_K3_HEADS = ((MINICPM, 36, 36, 64), (QWEN, 40, 40, 128))


def archs_config(name, *, kv_bits=None):
    """``name`` whole (W2A2 on the int16xP2s8 lanes), at ``kv_bits`` when
    given."""
    from repro_torch import configs

    cfg = configs.get_config(name)
    if kv_bits is not None:
        cfg = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
    return cfg


def build_packed_params(cfg, generator, device):
    """The serving params of ``lm.init_params(cfg, generator, device)``
    built a layer at a time: each part drawn in ``init_params``' generator
    order -- the embedding, every block (``lm.block_init``), the final
    norm, an untied head -- and each block packed
    (``prepare_serving_params``) before the next is drawn, its floats
    dropped.  The peak is the packed tree plus one float block, so a
    config whose float tree and packed lanes do not fit the card together
    (qwen1.5-32b: 70.4 + 33.6 GB) is built whole.  Equal leaf for leaf to
    ``prepare_serving_params(lm.init_params(cfg, generator, device), cfg,
    device=device)``; a decoder-only text LM only."""
    import torch

    from repro_torch.models import common, lm
    from repro_torch.serve.prepare import prepare_serving_params

    if cfg.is_encoder_decoder or cfg.frontend != "none":
        raise ValueError(f"{cfg.name}: the layer-at-a-time build covers a "
                         f"decoder-only text LM")
    lm.check_supported(cfg)
    dev = torch.device(device)
    dtype = common.dtype_of(cfg.param_dtype)
    params = {"embed": common.embedding_init(generator, cfg.padded_vocab,
                                             cfg.d_model, dtype, dev),
              "layers": []}
    for i in range(cfg.num_layers):
        block = lm.block_init(generator, cfg, i, dtype=dtype, device=dev)
        params["layers"].append(prepare_serving_params(block, cfg,
                                                       device=dev))
        del block
    params["final_norm"] = common.rmsnorm_init(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(
            generator, cfg.d_model, cfg.padded_vocab, dtype=dtype,
            quantized=cfg.quant.quantize_lm_head, qcfg=cfg.quant,
            device=dev)
    return prepare_serving_params(params, cfg, device=dev)


def archs_k2_rows(torch, peaks, dev, gen):
    """``fused_quant_row`` at every packed-linear shape of the three
    configs (``ARCHS_K2_SHAPES``) at 4 and 64 rows, qwen1.5's q/k/v with
    a bf16 bias in the fused epilogue: bit-equal to cast + K1 + K2-affine
    and to the plain version (gated), timed against its bound.  Prints an
    ``archs k2`` line a row."""
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec

    sp = PackSpec.parse("W2A2/int16xP2s8")
    rows = []
    for cfg, layer, k, n, with_bias in ARCHS_K2_SHAPES:
        qw = torch.randint(0, sp.max_w + 1, (k, n), generator=gen,
                           device=dev, dtype=torch.int32)
        w = packing.pack_weights(qw, sp)
        ws = [w] + [w.clone() for _ in range(copies_for(w.numel() *
                                                        sp.lane_bytes) - 1)]
        bias = (torch.randn(n, generator=gen, device=dev) * ARCHS_BIAS_STD
                ).bfloat16() if with_bias else None
        for m in ARCHS_K2_ROWS:
            r = fused_quant_row(torch, peaks, dev, gen, sp, m, k, n, qw, ws,
                                None, bias=bias)
            r.update(config=cfg, layer=layer)
            print("archs k2 " + json.dumps(r))
            rows.append(r)
        del qw, w, ws
    torch.cuda.empty_cache()
    return rows


def archs_k3_rows(torch, peaks, dev, gen):
    """K3 and K4 (``attention_case``) at ``ARCHS_K3_HEADS``, C1 and C16,
    kv 16 and 4, B4 S512: K3 within ATTN_TOL (+ one bf16 ulp at bf16
    queries) of its plain version, K4 bit-equal to K3 through a scrambled
    block table, SDPA timed beside it at kv 16 (gated in
    ``attention_case``).  Prints an ``archs k3`` line a row."""
    rows = []
    valid_len = torch.tensor([512, 300, 77, 0], dtype=torch.int32,
                             device=dev)
    for cfg, h, kvh, hd in ARCHS_K3_HEADS:
        for kv_bits in (16, 4):
            for r in attention_case(torch, peaks, dev, gen, 4, 512, h, kvh,
                                    hd, kv_bits, valid_len):
                r["config"] = cfg
                print("archs k3 " + json.dumps(r))
                rows.append(r)
    return rows


def archs_params(torch, dev, cfg):
    """Seed-0 packed serving params of ``cfg`` on the card and how they
    were made: granite and minicpm through ``lm.init_params`` and
    ``prepare_serving_params`` (the float tree dropped after packing),
    qwen1.5-32b a layer at a time (``build_packed_params``) with its QKV
    biases then drawn (``ARCHS_BIAS_STD``)."""
    from repro_torch.models import lm
    from repro_torch.serve.prepare import prepare_serving_params

    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cfg.name == QWEN:
        packed = build_packed_params(cfg, gen, dev)
        torch.cuda.synchronize()
        info = {"build": "a layer at a time",
                "init_and_pack_s": time.perf_counter() - t0}
        bgen = torch.Generator(device=dev).manual_seed(SEED + 35)
        for layer in packed["layers"]:
            for name in ("q", "k", "v"):
                b = layer["attn"][name]["bias"]
                b.copy_(torch.randn(b.shape, generator=bgen, device=dev)
                        * ARCHS_BIAS_STD)
    else:
        params = lm.init_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        packed = prepare_serving_params(params, cfg, device=dev)
        torch.cuda.synchronize()
        info = {"build": "lm.init_params, then prepare_serving_params",
                "init_params_s": init_s,
                "pack_s": time.perf_counter() - t0}
        del params
    gc.collect()
    torch.cuda.empty_cache()
    info["build_peak_bytes"] = torch.cuda.max_memory_allocated()
    return packed, info


def packed_bytes_split(packed) -> dict:
    """Bytes of the packed linears' lanes (``w_packed``) and of the rest
    of a serving tree (embedding, norms, a float head, scales, sums)."""
    from repro_torch.serve.prepare import serving_param_bytes

    lanes = sum(w.numel() * w.element_size() for w in packed_leaves(packed))
    return {"w_packed_bytes": lanes,
            "other_param_bytes": serving_param_bytes(packed) - lanes}


def decode_graph_launches(step) -> dict:
    """The hand kernels' launches a replay of ``step``'s graph holds: the
    fused K2, K3 (and of them the tile path's) and the window write."""
    from repro_torch.kernels import cache_write, ulppack_attention as att, \
        ulppack_matmul as mm

    got = step.launches
    return {"k2": got[(mm, "mma_launches")]["quant_affine"],
            "k3": got[(att, "kernel_launches")]["attention_decode"],
            "k3_tile": got[(att, "tile_launches")]["attention_decode"],
            "cache_write": got[(cache_write, "kernel_launches")][
                "cache_write"]}


def archs_serve_phase(torch, np, dev, smi, name, kv_list):
    """The ``archs serve`` lines of ``name``: full width, whole depth,
    W2A2 seed-0 weights packed once (``archs_params``), then at each kv
    setting ``EngineConfig(**ARCHS_ECFG)`` over that packed tree, graphed,
    the serve phase's four prompts cut to ARCHS_PROMPT tokens, ARCHS_NEW
    greedy tokens each, then an engine with ``backend='torch'`` over the same
    tree.  Gated: every packed linear one fused K2 launch with no
    standalone K1 (``check_k2_path``); every read one K3 launch, on both
    its paths (the prefill chunks' tile path and the decode passes' warp
    path, or the tile path alone where a kv head's rows exceed 4), and
    every window write one launch, with no plain call; every token in
    the vocabulary and the decode graph's pad columns at -1e30; tokens
    equal to the ``'torch'`` engine's under the margin rule (each parting
    listed with its margin: K3 is within ATTN_TOL of its plain version,
    not bit-equal).  Records init and pack s, capture s, decode ms a pass
    wall and replayed, the idle share, the graph's device ms by kernel
    group, launches a decode pass, param (lanes and the rest), cache and
    peak bytes.  Returns the graphed runs' K2, K3 and write launches."""
    from repro_torch.kernels import ulppack_attention as att
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    base = archs_config(name)
    packed, info = archs_params(torch, dev, base)
    mark(f"archs params {name}")
    prompts = [p[:ARCHS_PROMPT] for p in serve_prompts(np, base)[0]]
    ecfg = EngineConfig(**ARCHS_ECFG)
    launches = {"quantized_linear_mma": 0, "attention_decode": 0,
                "cache_write": 0}
    for kv_bits in kv_list:
        c = archs_config(name, kv_bits=kv_bits)
        label = f"archs serve {name} kv{kv_bits}"
        reset_kernel_counts()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServingEngine(c, packed, config=ecfg, device=dev)
        build_s = time.perf_counter() - t0
        if eng.params["layers"][0]["attn"]["q"]["w_packed"] is not \
                packed["layers"][0]["attn"]["q"]["w_packed"]:
            raise AssertionError(f"{label}: the engine copied the tree")
        t0 = time.perf_counter()
        outs, rows, passes = recorded_serve(np, eng, prompts, ARCHS_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if eng._decode.graph is None or eng._prefill.graph is None:
            raise AssertionError(f"{label}: the engine captured no graphs")
        got = check_writes_on_kernel(label)
        tile = att.tile_launches["attention_decode"]
        per_pass = decode_graph_launches(eng._decode)
        if not 0 < tile < got["attention_decode"]:
            raise AssertionError(f"{label}: K3's tile path launched {tile} "
                                 f"of {got['attention_decode']} times")
        if any(t < 0 or t >= c.vocab_size for o in outs for t in o):
            raise AssertionError(f"{label}: a token outside the vocabulary")
        pad = eng._decode.logits[..., c.vocab_size:]
        if pad.numel() and float(pad.float().max()) > -1e29:
            raise AssertionError(f"{label}: the pad columns' mask did not "
                                 f"hold in the decode graph")
        for k, n in got.items():
            launches[k] += n
        m, cap = eng.metrics.report(), eng.capacity_report()
        replay = statistics.median(replay_ms(torch, eng._decode)
                                   for _ in range(5))
        line = {"card": smi, "config": name, "kv_bits": kv_bits,
                "layers": f"{c.num_layers} of {c.num_layers}",
                "d_model": c.d_model,
                "heads": f"{c.num_heads} / {c.num_kv_heads} x "
                         f"{c.resolved_head_dim}",
                "d_ff": c.d_ff, "vocab": c.vocab_size,
                "padded_vocab": c.padded_vocab,
                "head": "tied" if c.tie_embeddings else "untied bf16",
                "qkv_bias": c.qkv_bias, **info,
                "slots": eng.max_batch, "prefill_chunk": eng.prefill_chunk,
                "requests": len(outs), "new_tokens": ARCHS_NEW,
                "engine_build_s": build_s,
                "capture_s": {"decode": eng._decode.capture_s,
                              "prefill": eng._prefill.capture_s},
                "step_setup_s": cap["step_setup_s"], "wall_s": wall,
                "steps": m["steps"],
                "decode_passes": eng.metrics.decode_passes,
                "decode_step_ms_wall": m["decode_step_ms"],
                "decode_replay_ms": replay,
                "idle_share": 1 - replay / m["decode_step_ms"],
                "decode_tok_s": m["decode_tok_s"],
                "prefill_tok_s": m["prefill_tok_s"],
                "graph_device_ms_by_group": profile_replay(torch,
                                                           eng._decode),
                "launches_a_decode_pass": per_pass,
                "launches_a_prefill_chunk": decode_graph_launches(
                    eng._prefill),
                **{f"{k}_launches": n for k, n in got.items()},
                "k3_tile_launches": tile,
                "param_bytes": cap["param_bytes"],
                **packed_bytes_split(packed),
                "cache_bytes": cap["cache_bytes"],
                "cache_bytes_per_slot": cap["cache_bytes_per_slot"],
                "held_before_engine_bytes": before,
                "peak_memory_bytes": peak}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = ServingEngine(c, packed, config=ecfg, device=dev,
                            backend="torch")
        ref_outs, ref_rows, ref_passes = recorded_serve(np, ref, prompts,
                                                        ARCHS_NEW)
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        # the margin rule (serve w4a4's): K3 is within ATTN_TOL of its
        # plain version, not bit-equal, so a token may part from 'torch''s
        # only where the plain row's top-2 margin is at most 2 x the rows'
        # difference; every parting is listed
        parted = token_divergences(np, label, ref_outs, ref_rows, outs,
                                   rows, strict=False)
        line.update(tokens_equal=outs == ref_outs, divergences=parted,
                    torch_backend_s=time.perf_counter() - t0,
                    first_decode_max_logit_diff=float(
                        (passes[0] - ref_passes[0]).abs().max()),
                    max_logit_diff_vs_torch=max_pass_diff(passes,
                                                          ref_passes))
        print("archs serve " + json.dumps(line))
        mark(label)
    print(smi)
    del packed
    held_check(torch, held, f"archs serve {name}")
    return launches


EXAMPLES = (("quickstart", ()), ("serve_quantized", ()),
            ("serve_quantized", ("--model-parallel", "2")))


def examples_phase(torch):
    """The ``examples`` line: ``repro_torch.examples.quickstart`` and
    ``serve_quantized`` (one shard, and two shards on this card) run as
    their own processes on the card, side by side.  Gated: each exits 0;
    the quickstart's packed lattice dot is the hand-written tensor-core
    K2, launched, and exact; the two-shard run's tokens equal the one
    shard's."""
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in EXAMPLES]
    outs = []
    for (name, args), proc in zip(EXAMPLES, procs):
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"example {name} {args}: exit "
                                 f"{proc.returncode}\n{(out + err)[-2000:]}")
        outs.append(out)
    wall = time.perf_counter() - t0
    quick = re.search(r"ulppack_matmul \(tensor-core K2 on cuda(?::\d+)?, "
                      r"(\d+) launch\): EXACT match", outs[0])
    err = re.search(r"float-oracle max err: (\S+)", outs[0])
    if quick is None or int(quick.group(1)) < 1 or err is None:
        raise AssertionError(f"example quickstart: no exact line from the "
                             f"hand-written K2\n{outs[0][-2000:]}")
    tokens = [re.findall(r"^  req \d+: .* -> (\[.*\])$", o, re.M)
              for o in outs[1:]]
    if len(tokens[0]) != 4 or tokens[0] != tokens[1]:
        raise AssertionError(f"example serve_quantized: two shards' tokens "
                             f"{tokens[1]} differ from one's {tokens[0]}")
    line = {"quickstart_k2_launches": int(quick.group(1)),
            "quickstart_max_err": float(err.group(1)),
            "serve_quantized_lines": [
                next(ln for ln in outs[1].splitlines() if ln.startswith(p))
                for p in ("serving params:", "kv cache:", "served ")],
            "two_shards_tokens_equal": True, "wall_s": wall}
    print("examples " + json.dumps(line))
    return line


def archs_phase(torch, np, dev, peaks, smi):
    """The three dense configs never served before: the ``archs k2`` and
    ``archs k3`` rows, an ``archs serve`` line per config and kv setting,
    then the ``examples`` line.  Returns the serve lines' launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 35)
    archs_k2_rows(torch, peaks, dev, gen)
    mark("archs k2")
    archs_k3_rows(torch, peaks, dev, gen)
    mark("archs k3")
    launches = {"quantized_linear_mma": 0, "attention_decode": 0,
                "cache_write": 0}
    for name, kv_list in ARCHS:
        for k, n in archs_serve_phase(torch, np, dev, smi, name,
                                      kv_list).items():
            launches[k] += n
    examples_phase(torch)
    mark("examples")
    print(f"archs launches {launches}")
    print(smi)
    return launches


# ---------------------------------------------------------------------------
# multimodal lines: qwen2-vl-2b and seamless-m4t-medium
# ---------------------------------------------------------------------------

VLM, ENCDEC = "qwen2-vl-2b", "seamless-m4t-medium"
MM_ECFG = dict(max_batch=4, max_len=512, prefill_chunk=16)
MM_NEW = 4
# the vlm prefix line: an image of 1 x 16 x 16 (t, h, w) patches, 48 text
# tokens after it, two rows
VLM_GRID, VLM_TEXT, VLM_ROWS = (1, 16, 16), 48, 2
# the encdec lines: four rows of 256 encoder embeddings, a 16-token prompt
ENC_ROWS, ENC_LEN, ENC_PROMPT = 4, 256, 16
# the packed linears of the two configs at full width, (k, n) by layer,
# at the decode and the prefill-chunk rows of MM_ECFG
MM_K2_SHAPES = ((VLM, "q/o", 1536, 1536), (VLM, "k/v", 1536, 256),
                (VLM, "gate/up", 1536, 8960), (VLM, "down", 8960, 1536),
                (ENCDEC, "q/k/v/o", 1024, 1024), (ENCDEC, "up", 1024, 4096),
                (ENCDEC, "down", 4096, 1024))
MM_K2_ROWS = (4, 64)


def multimodal_config(name, *, kv_bits=None):
    """qwen2-vl-2b or seamless-m4t-medium whole (W2A2 on the int16xP2s8
    lanes), at ``kv_bits`` when given."""
    from repro_torch import configs

    cfg = configs.get_config(name)
    if kv_bits is not None:
        cfg = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
    return cfg


def multimodal_k2_rows(torch, peaks, dev, gen):
    """``fused_quant_row`` at every packed-linear shape of the two configs
    (``MM_K2_SHAPES``) at 4 and 64 rows: bit-equal to cast + K1 + K2 and
    to the plain version, timed against its bytes bound.  Prints a
    ``multimodal k2`` line a row."""
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec

    sp = PackSpec.parse("W2A2/int16xP2s8")
    rows = []
    for cfg, layer, k, n in MM_K2_SHAPES:
        qw = torch.randint(0, sp.max_w + 1, (k, n), generator=gen,
                           device=dev, dtype=torch.int32)
        w = packing.pack_weights(qw, sp)
        ws = [w] + [w.clone() for _ in range(copies_for(w.numel() *
                                                        sp.lane_bytes) - 1)]
        for m in MM_K2_ROWS:
            r = fused_quant_row(torch, peaks, dev, gen, sp, m, k, n, qw, ws,
                                None)
            r.update(config=cfg, layer=layer)
            print("multimodal k2 " + json.dumps(r))
            rows.append(r)
        del qw, w, ws
    torch.cuda.empty_cache()
    return rows


def noncausal_k3_rows(torch, peaks, dev, gen):
    """K3 without a causal mask, as the encoder and the cross sublayers
    read it: seamless's heads (H16 hd64), S 256 bf16 keys (kv 0), every
    query at position 255 with ``valid_len`` 256, at C 1 (a decode step's
    cross read) and C 256 (the encoder): within ATTN_TOL + one bf16 ulp of
    the plain version, two launches bit-equal; timed beside the plain
    version and SDPA without a mask."""
    from repro_torch.kernels import plan as plan_lib
    from repro_torch.kernels import ulppack_attention as ua

    bsz, s, h, hd = ENC_ROWS, ENC_LEN, 16, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for c in (1, ENC_LEN):
        path = attention_path(plan_lib.plan_attention_decode(
            bsz, c, s, h, h, hd, 0, cache_dtype=torch.bfloat16,
            device=dev))
        q = torch.randn((bsz, c, h, hd), generator=gen,
                        device=dev).bfloat16()
        kv = [{n: torch.randn((bsz, s, h, hd), generator=gen,
                              device=dev).bfloat16() for n in ("k", "v")}]
        kv += [{n: t.clone() for n, t in kv[0].items()}
               for _ in range(copies_for(2 * bsz * s * h * hd * 2) - 1)]
        vl = torch.full((bsz,), s, dtype=torch.int32, device=dev)
        qpos = torch.full((bsz, c), s - 1, dtype=torch.int32, device=dev)
        got = ua.attention_decode_cuda(q, kv[0], vl, qpos, kv_bits=0, hd=hd)
        want = ua.attention_decode_torch(q, kv[0], vl, qpos, kv_bits=0,
                                         hd=hd, block_k=512).float()
        diff = (got.float() - want).abs()
        if not (torch.isfinite(got).all() and (
                diff <= ATTN_TOL + ATTN_BF16_RTOL * want.abs()).all()):
            raise AssertionError(f"non-causal K3 C={c}: max abs err "
                                 f"{float(diff.max())}")
        if not torch.equal(got, ua.attention_decode_cuda(
                q, kv[0], vl, qpos, kv_bits=0, hd=hd)):
            raise AssertionError(f"non-causal K3 C={c}: two launches differ")
        qs = q.transpose(1, 2).contiguous()
        ks, vs = (kv[0][n].transpose(1, 2).contiguous() for n in ("k", "v"))
        lib_err = float((sdpa(qs, ks, vs).transpose(1, 2).float()
                         - want).abs().max())
        nbytes = 2 * bsz * s * h * hd * 2 + 2 * q.numel() * 2
        ops = 4 * bsz * c * h * hd * s
        b, by = bound_ms(nbytes, ops, peaks["hbm"], peaks["bf16"])
        design = bound_ms(nbytes, attention_design_ops(
            torch, q, h, hd, bsz * c * s, False, path), peaks["hbm"],
            peaks["f32" if path == "warp" else "bf16"])
        r = {"name": "attention_decode", "mask": "none (all keys)",
             "path": path, "design_bound_ms": design[0],
             "shape": f"B{bsz} S{s} H{h} hd{hd} C{c} kv0",
             "max_abs_err": float(diff.max()),
             "sdpa_max_abs_err_vs_plain": lib_err,
             "ms": time_ms(torch, [lambda cc=cc: ua.attention_decode_cuda(
                 q, cc, vl, qpos, kv_bits=0, hd=hd) for cc in kv]),
             "plain_ms": time_ms(torch, [lambda: ua.attention_decode_torch(
                 q, kv[0], vl, qpos, kv_bits=0, hd=hd, block_k=512)], 3),
             "bound_ms": b, "bound_by": by,
             "library_ms": time_ms(torch, [lambda: sdpa(qs, ks, vs)] * 10),
             "library": "SDPA (no mask, same rows)"}
        print("multimodal k3 " + json.dumps(r))
        rows.append(r)
        del kv
    return rows


def multimodal_k3_rows(torch, peaks, dev, gen):
    """K3 (and K4 beside it) at qwen2-vl's heads (H12 KVH2 hd128: a GQA
    group of 6, so every read takes the tile path) at C1 and C16, kv 4 and
    16, SDPA beside it at kv 16 (``attention_case``); then the non-causal
    rows.  Prints a ``multimodal k3`` line a row."""
    rows = []
    valid_len = torch.tensor([512, 300, 77, 0], dtype=torch.int32,
                             device=dev)
    for kv_bits in (16, 4):
        for r in attention_case(torch, peaks, dev, gen, 4, 512, 12, 2, 128,
                                kv_bits, valid_len):
            print("multimodal k3 " + json.dumps(r))
            rows.append(r)
    return rows + noncausal_k3_rows(torch, peaks, dev, gen)


def reset_kernel_counts():
    from repro_torch.kernels import cache_write, quant_pack, \
        ulppack_attention, ulppack_matmul

    for mod in (quant_pack, ulppack_matmul, ulppack_attention, cache_write):
        mod.reset_counts()


def clone_caches(caches):
    """A deep copy of a cache list (tensors cloned; a ``cross_kv`` pair
    cloned, None kept)."""
    def one(v):
        if isinstance(v, dict):
            return {k: one(t) for k, t in v.items()}
        if isinstance(v, tuple):
            return tuple(one(t) for t in v)
        return None if v is None else v.clone()
    return [one(c) for c in caches]


def held_check(torch, held, where):
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.memory_allocated() > held + (1 << 30):
        raise AssertionError(f"{where}: {torch.cuda.memory_allocated() - held}"
                             f" bytes still held after the phase")


def mm_serve(torch, np, dev, smi, c, params, label, launches):
    """One engine run of ``c`` (``MM_ECFG``, the four serve prompts,
    MM_NEW greedy tokens each), graphed, then with ``backend='torch'``:
    tokens equal (gated), every packed linear one fused K2 launch and
    every attention read one K3 launch, no plain call
    (``check_writes_on_kernel``).  Prints the ``label`` line: decode ms a
    pass (wall, replay), the idle share, the graph's device ms by kernel
    group, param and cache bytes, the serving peak above what the card
    held before the engine.  Adds the run's launches to ``launches``."""
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    prompts, _ = serve_prompts(np, c)
    ecfg = EngineConfig(**MM_ECFG)
    reset_kernel_counts()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(c, params, config=ecfg, device=dev)
    t0 = time.perf_counter()
    outs, rows, passes = recorded_serve(np, eng, prompts, MM_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    if eng._decode.graph is None:
        raise AssertionError(f"{label}: the engine captured no graphs")
    got = check_writes_on_kernel(label)
    for k, n in got.items():
        launches[k] += n
    m, cap = eng.metrics.report(), eng.capacity_report()
    replay = statistics.median(replay_ms(torch, eng._decode) for _ in
                               range(5))
    line = {"card": smi, "config": c.name, "kv_bits": c.quant.kv_bits,
            "layers": c.num_layers, "d_model": c.d_model,
            "slots": eng.max_batch, "prefill_chunk": eng.prefill_chunk,
            "requests": len(outs), "new_tokens": MM_NEW, "wall_s": wall,
            "decode_passes": eng.metrics.decode_passes,
            "decode_step_ms_wall": m["decode_step_ms"],
            "decode_replay_ms": replay,
            "idle_share": 1 - replay / m["decode_step_ms"],
            "decode_tok_s": m["decode_tok_s"],
            "graph_device_ms_by_group": profile_replay(torch, eng._decode),
            **{f"{k}_launches": n for k, n in got.items()},
            "step_setup_s": cap["step_setup_s"],
            "param_bytes": cap["param_bytes"],
            "cache_bytes": cap["cache_bytes"],
            "prefix_sharing": cap.get("prefix_sharing", False),
            "peak_memory_above_held_bytes": peak}
    if c.is_encoder_decoder and any(x["cross_kv"] is not None
                                    for x in eng.caches):
        raise AssertionError(f"{label}: the engine filled cross_kv")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ref = ServingEngine(c, params, config=ecfg, device=dev, backend="torch")
    ref_outs, ref_rows, ref_passes = recorded_serve(np, ref, prompts, MM_NEW)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    token_divergences(np, label, ref_outs, ref_rows, outs, rows, strict=True)
    line.update(tokens_equal=True,
                max_logit_diff_vs_torch=max_pass_diff(passes, ref_passes))
    print(label + " " + json.dumps(line))


def greedy_decode(torch, np, step, params, caches, first, index0, n,
                  extra):
    """``n`` greedy tokens from the logits ``first`` [B, vocab] through
    ``step`` (an op-by-op decode step) at offsets ``index0 + i``;
    ``extra(i)`` adds to the i-th batch.  Returns the tokens [B, n] and
    every step's logits (f32, on the host)."""
    b = first.shape[0]
    tok = torch.argmax(first, dim=-1)
    toks, logits = [tok], []
    for i in range(n - 1):
        out, caches = step(params, caches, {"tokens": tok[:, None],
                                            **extra(i)},
                           np.full(b, index0 + i, np.int32),
                           np.ones(b, np.int32))
        logits.append(out.float().cpu())
        tok = torch.argmax(out, dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1).cpu(), logits


def vlm_prefix_phase(torch, np, dev, smi, c, params, launches):
    """The ``vlm prefix`` line, op by op: VLM_ROWS rows of a seeded image
    (VLM_GRID patches of frontend_dim embeddings) then VLM_TEXT text
    tokens, their (t, h, w) ids as qwen2-vl numbers them (the image at
    (0, i, j), the text from max + 1 on); ``make_prefill_step`` (the
    fake-quant forward over the prefix and the text), then MM_NEW greedy
    tokens through the packed ``make_decode_step`` carrying their ids in
    ``positions3``, on the kernels and with ``backend='torch'`` from the
    same caches: tokens equal (gated), K2 and K3 launched with no plain
    call."""
    from repro_torch.launch import steps
    from repro_torch.serve.prepare import prepare_serving_params

    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    n_img = VLM_GRID[0] * VLM_GRID[1] * VLM_GRID[2]
    t, h, w = torch.meshgrid(*(torch.arange(n, device=dev)
                               for n in VLM_GRID), indexing="ij")
    img = torch.stack([t.flatten(), h.flatten(), w.flatten()])
    nxt = int(img.max()) + 1
    txt = torch.arange(nxt, nxt + VLM_TEXT, device=dev).expand(3, VLM_TEXT)
    ids = torch.cat([img, txt], dim=1).to(torch.int32)
    batch = {"tokens": torch.randint(0, c.vocab_size, (VLM_ROWS, VLM_TEXT),
                                     generator=gen, device=dev),
             "embeds": torch.randn((VLM_ROWS, n_img, c.frontend_dim),
                                   generator=gen, device=dev).bfloat16(),
             "positions3": ids[:, None].expand(3, VLM_ROWS, -1).contiguous()}
    rows0 = n_img + VLM_TEXT
    t0 = time.perf_counter()
    first, caches = steps.make_prefill_step(c, MM_ECFG["max_len"])(params,
                                                                   batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    packed = prepare_serving_params(params, c, device=dev)
    nxt_txt = nxt + VLM_TEXT

    def extra(i):
        return {"positions3": torch.full((3, VLM_ROWS, 1), nxt_txt + i,
                                         dtype=torch.int32, device=dev)}

    runs = {}
    for be in ("auto", "torch"):
        reset_kernel_counts()
        step = steps.make_decode_step(c, backend=be)
        runs[be] = greedy_decode(torch, np, step, packed,
                                 clone_caches(caches),
                                 first, rows0, MM_NEW, extra)
        if be == "auto":
            got = check_writes_on_kernel("vlm prefix")
            for k, n in got.items():
                launches[k] += n
    if not torch.equal(runs["auto"][0], runs["torch"][0]):
        raise AssertionError(f"vlm prefix: tokens differ from the 'torch' "
                             f"backend's: {runs['auto'][0].tolist()} vs "
                             f"{runs['torch'][0].tolist()}")
    line = {"card": smi, "config": c.name, "rows": VLM_ROWS,
            "image": {"grid_thw": VLM_GRID, "embeddings": n_img,
                      "frontend_dim": c.frontend_dim},
            "text_tokens": VLM_TEXT, "cache_rows_after_prefill": rows0,
            "first_text_ids": nxt, "decode_ids_from": nxt_txt,
            "new_tokens": MM_NEW, "prefill_s": prefill_s,
            "tokens_equal": True, **got,
            "max_logit_diff_vs_torch": max_pass_diff(runs["auto"][1],
                                                     runs["torch"][1])}
    print("vlm prefix " + json.dumps(line))
    del packed, caches


def check_writes_on_kernel(where) -> dict:
    """``check_on_kernels``, and every window write since the counts were
    reset one launch of the write kernel, with no plain call.  Returns
    the K2, K3 and write launches."""
    from repro_torch.kernels import cache_write

    out = check_on_kernels(where)
    n, plain = (cache_write.kernel_launches["cache_write"],
                cache_write.plain_calls["cache_write"])
    if not n or plain:
        raise AssertionError(f"{where}: {n} window-write launches, {plain} "
                             f"plain calls")
    return dict(out, cache_write=n)


def vlm_phase(torch, np, dev, smi):
    """qwen2-vl-2b whole (28 layers, seed-0 weights): the ``vlm serve``
    lines at kv 16 and kv 4 (text-only, every component of the M-RoPE
    ids at the cache position, as the reference engine serves it), then
    the ``vlm prefix`` line.  Returns the K2, K3 and cache-write
    launches."""
    from repro_torch.models import lm

    launches = dict.fromkeys(("quantized_linear_mma", "attention_decode",
                              "cache_write"), 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    c = multimodal_config(VLM)
    params = lm.init_params(c, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    for kv in (16, 4):
        mm_serve(torch, np, dev, smi, multimodal_config(VLM, kv_bits=kv),
                 params, "vlm serve", launches)
    vlm_prefix_phase(torch, np, dev, smi, multimodal_config(VLM, kv_bits=4),
                     params, launches)
    del params
    held_check(torch, held, "vlm")
    print(smi)
    return launches


def encdec_phase(torch, np, dev, smi):
    """The ``encdec`` lines, seamless-m4t-medium whole (12 encoder + 12
    decoder layers, seed-0 weights, kv 4), ENC_ROWS rows of ENC_LEN seeded
    encoder embeddings and an ENC_PROMPT-token prompt: (a) the packed
    ``lm.encode`` (K2 over ENC_ROWS x ENC_LEN rows, K3 non-causal at C
    ENC_LEN), timed; (b) the prompt and MM_NEW greedy tokens fed one token
    a step through ``lm.forward`` with the lockstep index, the encoder
    states given at step 0 (their cross K/V cached then, read through K3
    after); (c) ``make_prefill_step`` with ``enc_embeds``, then MM_NEW
    greedy tokens through the packed decode step over the cached cross
    K/V; (d) the engine, decoder-only as the reference's (``mm_serve``).
    (b) and (c) on the kernels and with ``backend='torch'``: tokens equal
    (gated), K2 and K3 launched with no plain call.  Prints the encoder's
    ms, a decode step's ms and its device ms in the ``cross_attention``
    range.  Returns the launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serve.prepare import prepare_serving_params

    launches = dict.fromkeys(("quantized_linear_mma", "attention_decode",
                              "cache_write"), 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    c = multimodal_config(ENCDEC, kv_bits=4)
    params = lm.init_params(c, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    enc = torch.randn((ENC_ROWS, ENC_LEN, c.frontend_dim), generator=gen,
                      device=dev).bfloat16()
    prompt = torch.randint(0, c.vocab_size, (ENC_ROWS, ENC_PROMPT),
                           generator=gen, device=dev)
    packed = prepare_serving_params(params, c, device=dev)
    n_steps = ENC_PROMPT + MM_NEW
    line = {"card": smi, "config": c.name, "kv_bits": c.quant.kv_bits,
            "encoder_layers": c.encoder_layers, "layers": c.num_layers,
            "d_model": c.d_model, "rows": ENC_ROWS, "enc_len": ENC_LEN,
            "prompt": ENC_PROMPT, "new_tokens": MM_NEW}

    def token_by_token(be):
        enc_out = lm.encode(packed, c, enc, quant_mode="packed", backend=be)
        caches = lm.init_caches(c, ENC_ROWS, n_steps, device=dev)
        tok, toks, logits = prompt[:, :1], [], []
        for t in range(n_steps):
            out, _, caches = lm.forward(
                packed, c, {"tokens": tok, "positions": torch.full(
                    (ENC_ROWS, 1), t, dtype=torch.int32, device=dev)},
                quant_mode="packed", caches=caches, cache_index=t,
                enc_out=enc_out if t == 0 else None, backend=be)
            nxt = torch.argmax(out[:, -1], dim=-1)[:, None]
            if t >= ENC_PROMPT - 1:
                toks.append(nxt)
                logits.append(out[:, -1].float().cpu())
            tok = prompt[:, t + 1:t + 2] if t + 1 < ENC_PROMPT else nxt
        return torch.cat(toks[:MM_NEW], dim=1).cpu(), logits, enc_out, caches

    # (a) + (b)
    runs = {}
    for be in ("auto", "torch"):
        reset_kernel_counts()
        runs[be] = token_by_token(be)
        if be == "auto":
            got = check_writes_on_kernel("encdec (b)")
            for k, n in got.items():
                launches[k] += n
            line["b_launches"] = got
            enc_out, caches = runs[be][2], runs[be][3]
            line["encoder_ms"] = time_eager_ms(torch, lambda: lm.encode(
                packed, c, enc, quant_mode="packed"), reps=5)
            step_batch = {"tokens": prompt[:, :1], "positions": torch.full(
                (ENC_ROWS, 1), n_steps - 1, dtype=torch.int32, device=dev)}

            def one_step():
                # a step at the last row again (it rewrites that row)
                return lm.forward(packed, c, step_batch, quant_mode="packed",
                                  caches=caches, cache_index=n_steps - 1)
            line["decode_step_ms"] = time_eager_ms(torch, one_step, reps=10)
            one_step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                one_step()
                lm.encode(packed, c, enc, quant_mode="packed")
                torch.cuda.synchronize()
            cpu = range_rows(torch, prof, ("cross_attention", "encoder"))
            for name in ("cross_attention", "encoder"):
                line[f"{name}_range_device_ms"] = cpu[name][
                    "device_time_total"] / 1e3
            del enc_out, caches
        runs[be] = runs[be][:2]
    if not torch.equal(runs["auto"][0], runs["torch"][0]):
        raise AssertionError(f"encdec (b): tokens differ from the 'torch' "
                             f"backend's")
    line["b_tokens_equal"] = True
    line["b_max_logit_diff_vs_torch"] = max_pass_diff(runs["auto"][1],
                                                      runs["torch"][1])
    # (c)
    t0 = time.perf_counter()
    first, caches = steps.make_prefill_step(c, n_steps)(
        params, {"tokens": prompt, "enc_embeds": enc})
    torch.cuda.synchronize()
    line["c_prefill_s"] = time.perf_counter() - t0
    if any(x["cross_kv"] is None for x in caches):
        raise AssertionError("encdec (c): the prefill stored no cross K/V")
    runs = {}
    for be in ("auto", "torch"):
        reset_kernel_counts()
        runs[be] = greedy_decode(torch, np,
                                 steps.make_decode_step(c, backend=be),
                                 packed, clone_caches(caches), first,
                                 ENC_PROMPT, MM_NEW, lambda i: {})
        if be == "auto":
            got = check_writes_on_kernel("encdec (c)")
            for k, n in got.items():
                launches[k] += n
            line["c_launches"] = got
    if not torch.equal(runs["auto"][0], runs["torch"][0]):
        raise AssertionError("encdec (c): tokens differ from the 'torch' "
                             "backend's")
    line["c_tokens_equal"] = True
    line["c_max_logit_diff_vs_torch"] = max_pass_diff(runs["auto"][1],
                                                      runs["torch"][1])
    del caches, packed, runs
    print("encdec " + json.dumps(line))
    # (d)
    mm_serve(torch, np, dev, smi, c, params, "encdec serve", launches)
    del params, enc
    held_check(torch, held, "encdec")
    print(smi)
    return launches


def multimodal_phase(torch, np, dev, peaks, smi):
    """M-RoPE, the vision prefix and the encoder-decoder stack: the
    ``multimodal k2`` and ``multimodal k3`` rows, the ``vlm serve`` /
    ``vlm prefix`` lines of qwen2-vl-2b and the ``encdec`` lines of
    seamless-m4t-medium, both whole.  Returns their launches."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    multimodal_k2_rows(torch, peaks, dev, gen)
    multimodal_k3_rows(torch, peaks, dev, gen)
    mark("multimodal rows")
    launches = vlm_phase(torch, np, dev, smi)
    mark("vlm")
    for k, n in encdec_phase(torch, np, dev, smi).items():
        launches[k] += n
    print(f"multimodal launches {launches} in "
          f"{time.perf_counter() - t0:.1f} s")
    print(smi)
    return launches


# ---------------------------------------------------------------------------
# The replica fleet and tensor-parallel serving
# ---------------------------------------------------------------------------

FLEET_ECFG = dict(max_batch=4, max_len=512, prefill_chunk=16)
FLEET_NEW = 8
# stablelm's packed linears split over two shards, (k, n / 2) by layer, at
# the decode and the prefill-chunk rows of FLEET_ECFG
FLEET_K2_SHAPES = (("q/k/v/o", 2048, 1024), ("gate/up", 2048, 2816),
                   ("down", 5632, 1024))
FLEET_K2_ROWS = (4, 64)


def fleet_requests(np, cfg):
    """The fleet's eight seeded requests: prompts of 17-100 tokens, requests
    2 and 5 sampled at a seeded temperature, 3 and 6 in one session."""
    from repro_torch.serve.config import SamplingParams

    rng = np.random.default_rng(SEED + 40)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(17, 101, 8)]
    sampling = [None] * 8
    sampling[2] = SamplingParams(temperature=0.8, top_k=40, seed=SEED + 2)
    sampling[5] = SamplingParams(temperature=1.0, seed=SEED + 5)
    sessions = [None] * 8
    sessions[3] = sessions[6] = "session-a"
    return prompts, sampling, sessions


@contextlib.contextmanager
def recorded_builds(torch, builds):
    """Record each engine the Router builds inside the block: build
    seconds (packing, plans, warm-up and capture), the bytes it left
    allocated and its peak above what was allocated before it.  Patches
    the class, never an instance (a bound method held by an instance
    would keep its engine alive)."""
    from repro_torch.serve import router as router_lib

    real = router_lib.Router._engine

    def build(self, group, params):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = real(self, group, params)
        torch.cuda.synchronize()
        builds.append({"build_s": time.perf_counter() - t0,
                       "capture_s": eng.step_setup_s,
                       "graphs": eng._decode.graph is not None,
                       "added_bytes": torch.cuda.memory_allocated() - before,
                       "peak_above_bytes":
                           torch.cuda.max_memory_allocated() - before})
        return eng

    router_lib.Router._engine = build
    try:
        yield builds
    finally:
        router_lib.Router._engine = real


def fleet_kernel_check(where, paged=False, dense=False) -> dict:
    """Since the counts were reset: every packed linear one fused launch
    over lanes (``dense``: over the words), every read one K3 (paged: K4)
    launch, every window write one launch of the write kernel, no K1
    launch and no plain call.  Returns the launches by kernel."""
    from repro_torch.kernels import cache_write, quant_pack
    from repro_torch.kernels import ulppack_attention as att
    from repro_torch.kernels import ulppack_matmul as mm

    fused, other = (mm.dense_mma_launches, mm.mma_launches) if dense \
        else (mm.mma_launches, mm.dense_mma_launches)
    read = "attention_decode_paged" if paged else "attention_decode"
    plain = (mm.plain_calls["ulppack_matmul"] + quant_pack.plain_calls
             + sum(att.plain_calls.values())
             + cache_write.plain_calls["cache_write"])
    reads = att.kernel_launches[read]
    writes = cache_write.kernel_launches["cache_write"]
    if not fused["quant_affine"] or any(other.values()) or fused["affine"] \
            or fused["s32"] or plain or quant_pack.kernel_launches \
            or mm.kernel_launches["ulppack_matmul"] or not reads \
            or not writes:
        raise AssertionError(f"{where}: K2 {dict(fused)} (other route "
                             f"{dict(other)}), {reads} {read}, {writes} "
                             f"writes, plain calls {plain}, K1 "
                             f"{quant_pack.kernel_launches}")
    return {"quantized_linear_mma_dense" if dense
            else "quantized_linear_mma": fused["quant_affine"], read: reads,
            "cache_write": writes}


def fleet_router_phase(torch, np, dev, smi, cfg, params, launches):
    """(a) ``fleet router``: Router(replicas=2) over graphed engines serves
    the eight requests; tokens gated equal to one engine serving them.
    Prints placements, spillover, the summed per-replica decode tok/s
    (the reference's fleet rule: on one card a model of two cards, not a
    measurement) beside the wall-clock tok/s of the whole run, and each
    replica's build, capture and memory."""
    from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
    from repro_torch.serve.router import Router

    prompts, sampling, sessions = fleet_requests(np, cfg)
    ecfg = EngineConfig(**FLEET_ECFG)
    eng = ServingEngine(cfg, params, config=ecfg, device=dev)
    reqs = [Request(i, p, max_new_tokens=FLEET_NEW, sampling=sp)
            for i, (p, sp) in enumerate(zip(prompts, sampling))]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    want, one = [r.output for r in reqs], eng.metrics.report()
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    builds = []
    with recorded_builds(torch, builds):
        router = Router(cfg, params, config=ecfg, replicas=2, device=dev)
    reset_kernel_counts()
    t0 = time.perf_counter()
    handles = [router.submit(p, sp, max_new_tokens=FLEET_NEW, session=s)
               for p, sp, s in zip(prompts, sampling, sessions)]
    placed = [h.replica for h in handles]
    router.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, n in fleet_kernel_check("fleet router").items():
        launches[k] += n
    got = [h.output for h in handles]
    if got != want or not all(b["graphs"] for b in builds):
        raise AssertionError(f"fleet router: tokens equal {got == want}, "
                             f"graphs {[b['graphs'] for b in builds]}")
    fleet = router.metrics_report()["fleet"]
    line = {"card": smi, "config": cfg.name, "kv_bits": cfg.quant.kv_bits,
            "layers": cfg.num_layers, "replicas": 2,
            "slots_per_replica": FLEET_ECFG["max_batch"],
            "requests": len(handles), "new_tokens": FLEET_NEW,
            "placements": placed, "sessions": fleet["sessions"],
            "spilled": fleet["spilled"], "spill_peak": fleet["spill_peak"],
            "tokens_equal_one_engine": True,
            "decode_tok_s_summed": fleet["decode_tok_s"],
            "wall_s": wall,
            "wall_tok_s": fleet["generated_tokens"] / wall,
            "ttft_s": fleet["ttft_s"], "tpot_s": fleet["tpot_s"],
            "one_engine_decode_tok_s": one["decode_tok_s"],
            "one_engine_wall_s": one_wall,
            "one_engine_wall_tok_s": one["generated_tokens"] / one_wall,
            "replica_builds": builds}
    print("fleet router " + json.dumps(line))
    del router, handles
    held_check(torch, held, "fleet router")


def fleet_paged_phase(torch, np, dev, smi, cfg, params, launches):
    """(b) ``fleet paged``: a paged fleet of two replicas (kv 4) serves the
    72-token shared-prefix prompt on replica 0 (a session), drains
    replica 0 to a scratch checkpoint, restores it, then serves the four
    shared-prefix prompts there again.  Gated: the prefix index's pages
    survive, the restored replica prefix-hits, the tokens equal a
    never-drained engine's, and the memory the drain frees brings the
    card back within 1 GiB of what it held before replica 0 was built
    (plus replica 1)."""
    from repro_torch.serve import router as router_lib
    from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
    from repro_torch.train import checkpoint

    _, shared = serve_prompts(np, cfg)
    ecfg = EngineConfig(**FLEET_ECFG, paged=True, page_size=16)
    never = ServingEngine(cfg, params, config=ecfg, device=dev)
    rounds = ([shared[0]], shared)
    want = []
    for prompts in rounds:
        reqs = [Request(i, p, max_new_tokens=FLEET_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            never.submit(r)
        never.run_to_completion()
        want.append([r.output for r in reqs])
    del never, reqs
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    builds, times = [], {}
    ckpt = scratch_dir("fleet_ckpt")
    real_save, real_restore = checkpoint.save, checkpoint.restore

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            times[name] = time.perf_counter() - t0
            return out
        return run

    try:
        with recorded_builds(torch, builds):
            router = router_lib.Router(cfg, params, config=ecfg, replicas=2,
                                       device=dev, checkpoint_dir=ckpt)
        reset_kernel_counts()
        first = router.submit(rounds[0][0], max_new_tokens=FLEET_NEW,
                              session="prefix")
        router.run_to_completion()
        for k, n in fleet_kernel_check("fleet paged", paged=True).items():
            launches[k] += n
        cached = router.engines[0].capacity_report()["cached_prefix_pages"]
        checkpoint.save = timed("save_s", real_save)
        checkpoint.restore = timed("restore_read_s", real_restore)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = router.drain(0)
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        after_drain = torch.cuda.memory_allocated()
        written = dir_bytes(ckpt)
        t0 = time.perf_counter()
        with recorded_builds(torch, builds):
            eng = router.restore(0)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        checkpoint.save, checkpoint.restore = real_save, real_restore
    rep = eng.capacity_report()
    reset_kernel_counts()
    handles = [router.submit(p, max_new_tokens=FLEET_NEW, session="prefix")
               for p in rounds[1]]
    router.run_to_completion()
    for k, n in fleet_kernel_check("fleet paged restored",
                                   paged=True).items():
        launches[k] += n
    got = [[first.output], [h.output for h in handles]]
    hits = eng.capacity_report()["prefix_hit_tokens"]
    freed_to = after_drain - (held + builds[1]["added_bytes"])
    line = {"card": smi, "config": cfg.name, "kv_bits": cfg.quant.kv_bits,
            "replicas": 2, "page_size": 16,
            "cached_prefix_pages_drained": cached,
            "cached_prefix_pages_restored": rep["cached_prefix_pages"],
            "prefix_hit_tokens_after_restore": hits,
            "tokens_equal_never_drained": got == want,
            "requeued": info["requeued"], "checkpoint_bytes": written,
            "drain_s": drain_s, "save_s": times.get("save_s"),
            "restore_s": restore_s,
            "restore_read_s": times.get("restore_read_s"),
            "recapture_s": eng.step_setup_s,
            "replica_builds": builds,
            "allocated_after_drain_above_held_and_replica_1": freed_to}
    print("fleet paged " + json.dumps(line))
    if got != want or cached == 0 or rep["cached_prefix_pages"] != cached \
            or not hits or freed_to > (1 << 30):
        raise AssertionError(f"fleet paged: {line}")
    del router, eng, handles, first
    shutil.rmtree(ckpt, ignore_errors=True)
    held_check(torch, held, "fleet paged")


def join_bytes_a_decode(np, cfg, eng, b) -> dict:
    """The shard joins of one eager decode pass of a sharded engine
    (``roofline/analysis.join_bytes``: ``sharding.join`` an all-gather,
    ``add_up`` an all-reduce, per-device operand bytes), at position 0 of
    every slot after the engine has served: the graphs replay no Python,
    so the pass runs op by op."""
    from repro_torch.launch import steps
    from repro_torch.roofline import analysis

    with analysis.join_bytes() as got:
        steps.make_decode_step(cfg)(
            eng.params, eng.caches, {"tokens": np.zeros((b, 1), np.int32)},
            np.zeros(b, np.int32), np.ones(b, np.int32))
    return got


def fleet_shard_phase(torch, np, dev, smi, cfg, params, label, launches, *,
                      paged=False):
    """(c) / (d) ``fleet shard``: the engine with two shards on one card
    (``ServingMesh([[dev, dev]])``) against the one-shard engine on the
    serve prompts (paged: the shared-prefix ones).  The split is exact, so
    the tokens and every decode pass's logits are gated equal (the largest
    logit difference 0.0); prints that difference, each decode graph's K2
    and attention launches and device
    ms (profiler), the shards' K2 shapes and kv heads, the serving
    param bytes a shard against the one-shard total, and (stablelm
    unpaged) the bytes the shard joins of one decode pass move."""
    from repro_torch.kernels import ulppack_attention as att
    from repro_torch.kernels import ulppack_matmul as mm
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.parallel import sharding
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    plain, shared = serve_prompts(np, cfg)
    prompts = shared if paged else plain
    ecfg = EngineConfig(**FLEET_ECFG, paged=paged, page_size=16)
    read = "attention_decode_paged" if paged else "attention_decode"
    held = torch.cuda.memory_allocated()

    def run(mesh):
        reset_kernel_counts()
        eng = ServingEngine(cfg, params, config=ecfg, device=dev, mesh=mesh)
        outs, rows, passes = recorded_serve(np, eng, prompts, FLEET_NEW)
        got = fleet_kernel_check(label, paged)
        per = eng._decode.launches
        out = {"k2_launches_a_decode": per[(mm, "mma_launches")][
                   "quant_affine"],
               "attention_launches_a_decode": per[(att, "kernel_launches")][
                   read],
               "decode_graph": profile_replay(torch, eng._decode),
               "param_bytes": eng.capacity_report()["param_bytes"]}
        if mesh is not None:
            plan = eng.capacity_report()["shard_plan"]
            kv = next(c["attn"] for c in eng.caches if "attn" in c)
            out.update(
                shard_param_bytes=plan["param_bytes"],
                graphs=eng._decode.graph is not None,
                k2_shapes=sorted({tuple(leaf.parts[0].shape)
                                  for leaf in packed_leaves(eng.params)
                                  if isinstance(leaf, sharding.Sharded)}),
                kv_heads_a_shard=[p.shape[2] for p in
                                  sharding.parts(kv["k"])])
            if not (paged or cfg.mrope):
                out["join_bytes_a_decode"] = join_bytes_a_decode(
                    np, cfg, eng, ecfg.max_batch)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return outs, rows, passes, got, out

    o1, r1, p1, _, one = run(None)
    o2, r2, p2, got, two = run(ServingMesh([[dev, dev]]))
    for k, n in got.items():
        launches[k] += n
    pb = two["shard_param_bytes"]
    line = {"card": smi, "config": cfg.name, "kv_bits": cfg.quant.kv_bits,
            "paged": paged, "layers": cfg.num_layers, "shards": 2,
            "devices": [str(dev)] * 2, "tokens_equal": o1 == o2,
            "max_decode_logit_diff": max_pass_diff(p1, p2),
            "one_shard": one, "two_shards": two}
    print(f"{label} " + json.dumps(line))
    # the split is exact: every decode pass's logits bit-equal
    token_divergences(np, label, o1, r1, o2, r2, strict=True)
    if line["max_decode_logit_diff"] != 0.0:
        raise AssertionError(f"{label}: decode logits differ by "
                             f"{line['max_decode_logit_diff']}")
    if not two["graphs"] or pb["whole"] + sum(pb["split"]) \
            != one["param_bytes"] or len(set(pb["split"])) != 1:
        raise AssertionError(f"{label}: graphs {two['graphs']}, shard "
                             f"bytes {pb} against {one['param_bytes']}")
    held_check(torch, held, label)


def packed_leaves(tree):
    """Every packed weight leaf (``w_packed`` / ``w_dense``) of a tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in ("w_packed", "w_dense"):
                yield v
            else:
                yield from packed_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from packed_leaves(v)


def fleet_k2_rows(torch, peaks, dev, gen):
    """(e) ``fleet k2``: ``fused_quant_row`` at stablelm's shard shapes
    (N / 2) at 4 and 64 rows, bit-equal to cast + K1 + K2 and to the plain
    version, timed against its bound."""
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec

    sp = PackSpec.parse("W2A2/int16xP2s8")
    for layer, k, n in FLEET_K2_SHAPES:
        qw = torch.randint(0, sp.max_w + 1, (k, n), generator=gen,
                           device=dev, dtype=torch.int32)
        w = packing.pack_weights(qw, sp)
        ws = [w] + [w.clone() for _ in range(copies_for(w.numel() *
                                                        sp.lane_bytes) - 1)]
        for m in FLEET_K2_ROWS:
            r = fused_quant_row(torch, peaks, dev, gen, sp, m, k, n, qw, ws,
                                None)
            r.update(config="stablelm-1.6b", layer=layer, shards=2)
            print("fleet k2 " + json.dumps(r))
        del qw, w, ws
    torch.cuda.empty_cache()


def fleet_k3_rows(torch, peaks, dev, gen):
    """(e) ``fleet k3``: the reads and the window write at one shard's
    heads.  K3 and K4 at stablelm's 16 of 32 heads (H16 KVH16 hd64) at kv 4
    and 2 and at qwen2-vl's one kv head with its six query heads (H6 KVH1
    hd128, a GQA group of 6) at kv 4, at C1 and C16: within ATTN_TOL of
    their plain versions (plus one bf16 ulp for bf16 queries), K4
    bit-equal to K3, two launches bit-equal (``attention_case``).  Then the
    window write at both shards' heads, bit-equal to its plain twin at
    kv 16/8/4/2, ragged and paged (``cache_write_rows``).  Prints a
    ``fleet k3`` line a row."""
    from repro_torch import configs

    valid_len = torch.tensor([512, 300, 77, 0], dtype=torch.int32,
                             device=dev)
    for config, h, kvh, hd, bits in (("stablelm-1.6b", 16, 16, 64, (4, 2)),
                                     (VLM, 6, 1, 128, (4,))):
        for kv_bits in bits:
            for r in attention_case(torch, peaks, dev, gen, 4, 512, h, kvh,
                                    hd, kv_bits, valid_len):
                r.update(config=config, shards=2)
                print("fleet k3 " + json.dumps(r))
        c = configs.get_config(config).replace(num_heads=h, num_kv_heads=kvh,
                                               head_dim=hd)
        for r in cache_write_rows(torch, peaks, dev, gen, c,
                                  f"fleet cache_write {config}"):
            r.update(config=config, shards=2)
            print("fleet k3 " + json.dumps(r))
    torch.cuda.empty_cache()


# (h) the shard shapes of the speculative and recurrent lines: the W1
# dense draft's stablelm layers split two ways, (rows, Kp, N / 2, layout);
# jamba's mamba and xlstm's packed linears split two ways, (k, n / 2)
FLEET_K2_DENSE_CASES = tuple(
    (m, kp, n, "W1A1/int16xP2s8") for kp, n in ((1024, 1024), (1024, 2816),
                                                (2816, 1024))
    for m in FLEET_K2_ROWS)
FLEET_REC_K2_SHAPES = ((JAMBA, "mamba in_proj", 8192, 16384),
                       (JAMBA, "mamba out_proj", 16384, 4096),
                       (JAMBA, "mamba x_proj", 16384, 272),
                       (XLSTM, "mlstm up", 2048, 4096),
                       (XLSTM, "mlstm q/k/v", 4096, 2048),
                       (XLSTM, "mlstm down", 4096, 1024),
                       (XLSTM, "slstm ffn_up", 2048, 2730),
                       (XLSTM, "slstm ffn_down", 2730, 1024))


def fleet_shard_k2_rows(torch, peaks, dev, gen):
    """(h) ``fleet k2`` rows at the speculative and recurrent lines' shard
    shapes, at 4 and 64 rows: the W1 dense draft's stablelm layers
    (``dense_rows``: bit-equal to the plain version and to the lanes
    route) and the recurrent families' packed linears at N / 2
    (``fused_quant_row``: bit-equal to cast + K1 + K2 and to the plain
    version), each timed against its bound."""
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec

    for r in dense_rows(torch, peaks, dev, gen, FLEET_K2_DENSE_CASES):
        r.update(config="stablelm-1.6b", layer="W1 dense draft", shards=2)
        print("fleet k2 " + json.dumps(r))
    sp = PackSpec.parse("W2A2/int16xP2s8")
    for config, layer, k, n in FLEET_REC_K2_SHAPES:
        qw = torch.randint(0, sp.max_w + 1, (k, n), generator=gen,
                           device=dev, dtype=torch.int32)
        w = packing.pack_weights(qw, sp)
        ws = [w] + [w.clone() for _ in range(copies_for(w.numel() *
                                                        sp.lane_bytes) - 1)]
        for m in FLEET_K2_ROWS:
            r = fused_quant_row(torch, peaks, dev, gen, sp, m, k, n, qw, ws,
                                None)
            r.update(config=config, layer=layer, shards=2)
            print("fleet k2 " + json.dumps(r))
        del qw, w, ws
    torch.cuda.empty_cache()


def fleet_shard_k3_rows(torch, peaks, dev, gen):
    """(h) ``fleet k3`` rows of the speculative and recurrent lines' reads
    at one shard's heads: stablelm's verify window (C5 = k + 1, H16 KVH16
    hd64, kv 4) and jamba's attention layer (H32 KVH4 hd128, a GQA group
    of 8, kv 4, C1 and C16): K3 and K4 within ATTN_TOL of their plain
    versions, K4 bit-equal to K3 (``attention_case``)."""
    valid_len = torch.tensor([512, 300, 77, 0], dtype=torch.int32,
                             device=dev)
    for config, h, kvh, hd, windows in (
            ("stablelm-1.6b", 16, 16, 64, (SPEC_K + 1,)),
            (JAMBA, 32, 4, 128, (1, 16))):
        for r in attention_case(torch, peaks, dev, gen, 4, 512, h, kvh, hd,
                                4, valid_len, windows):
            r.update(config=config, shards=2)
            print("fleet k3 " + json.dumps(r))
    torch.cuda.empty_cache()


def fleet_spec_phase(torch, np, dev, smi, cfg, params, launches):
    """(f) ``fleet spec``: the speculative engine (k = SPEC_K, kv 4,
    ``FLEET_ECFG``) with two shards on the card (``ServingMesh([[dev,
    dev]])``) against one shard, for each of ``SPEC_CASES`` (a W2 lanes
    draft, a W1 draft over the dense store, paged with shared prefixes),
    FLEET_NEW greedy tokens a request.  Gated: tokens equal, the
    acceptance counts (drafted, accepted, cycles) equal, the logits of
    every verify pass bit-equal (the column and kv-head splits are
    exact), all five steps captured as graphs, every packed linear one
    fused launch and every read and write on its kernel
    (``fleet_kernel_check``).  Prints the draft and verify graphs' device
    ms by kernel group (profiler) for two shards and one, K2 and read
    launches a cycle, and the draft's param bytes by shard."""
    from repro_torch.kernels import ulppack_attention as att
    from repro_torch.kernels import ulppack_matmul as mm
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    plain_prompts, shared = serve_prompts(np, cfg)
    held = torch.cuda.memory_allocated()
    for name, extra, paged in SPEC_CASES:
        dense = extra.get("dense_store", False)
        ecfg = EngineConfig(**FLEET_ECFG, speculative_k=SPEC_K, **extra,
                            **(dict(paged=True, page_size=16,
                                    prefix_sharing=True) if paged else {}))
        prompts = shared if paged else plain_prompts
        read = "attention_decode_paged" if paged else "attention_decode"
        k2key = (mm, "dense_mma_launches" if dense else "mma_launches")
        label = f"fleet spec {name}"

        def run(mesh):
            reset_kernel_counts()
            eng = ServingEngine(cfg, params, config=ecfg, device=dev,
                                mesh=mesh)
            st = {"decode": eng._decode, "prefill_chunk": eng._prefill,
                  "verify": eng._verify,
                  "draft_prefill": eng.spec.prefill_step,
                  "draft": eng.spec.draft_step}
            windows, verify = [], eng._verify

            def spy(params_, caches, batch, index, valid, *bt):
                out = verify(params_, caches, batch, index, valid, *bt)
                lg = out[0].float().cpu()
                windows.append([lg[s, :int(v)] for s, v in enumerate(valid)
                                if v > 0])
                return out

            eng._verify = spy
            try:
                outs = [r.output for r in serve_requests(
                    eng, prompts, FLEET_NEW, paged=paged)]
            finally:
                eng._verify = verify
            got = fleet_kernel_check(label, paged, dense)
            m = eng.metrics
            cap = eng.capacity_report()
            out = {"graphs": {k: v.graph is not None for k, v in st.items()},
                   "acceptance": [m.drafted_tokens, m.accepted_tokens,
                                  m.spec_cycles],
                   "acceptance_rate": m.report()["acceptance_rate"],
                   "k2_launches_a_cycle": sum(
                       st[k].launches[k2key]["quant_affine"]
                       for k in ("draft", "verify")),
                   "read_launches_a_cycle": sum(
                       st[k].launches[(att, "kernel_launches")][read]
                       for k in ("draft", "verify")),
                   "draft_profile": profile_replay(torch, st["draft"]),
                   "verify_profile": profile_replay(torch, st["verify"]),
                   "draft_param_bytes": cap["speculative"][
                       "draft_param_bytes"],
                   "draft_shard_param_bytes": cap["speculative"].get(
                       "draft_shard_param_bytes")}
            if mesh is not None:
                kv = lm.first_attn_cache(eng.spec.caches)
                out["draft_kv_heads_a_shard"] = [
                    p.shape[2] for p in kv["k"].parts]
            del eng, st
            gc.collect()
            torch.cuda.empty_cache()
            return outs, windows, got, out

        o1, w1, _, one = run(None)
        o2, w2, got, two = run(ServingMesh([[dev, dev]]))
        for k, n in got.items():
            launches[k] += n
        diff = max((float((a - b).abs().max()) for wa, wb in zip(w1, w2)
                    for a, b in zip(wa, wb)), default=None)
        same_windows = len(w1) == len(w2) and all(
            len(wa) == len(wb) and all(a.shape == b.shape
                                       for a, b in zip(wa, wb))
            for wa, wb in zip(w1, w2))
        line = {"card": smi, "case": name, "config": cfg.name, "k": SPEC_K,
                "kv_bits": cfg.quant.kv_bits, "paged": paged,
                "dense_store": dense, "draft_w_bits": extra["draft_w_bits"],
                "shards": 2, "requests": len(prompts),
                "new_tokens": FLEET_NEW, "tokens_equal": o1 == o2,
                "acceptance_equal": one["acceptance"] == two["acceptance"],
                "verify_passes": len(w2), "max_verify_logit_diff": diff,
                "one_shard": one, "two_shards": two}
        print("fleet spec " + json.dumps(line))
        if o1 != o2 or one["acceptance"] != two["acceptance"] \
                or not same_windows or diff != 0.0 \
                or not all(two["graphs"].values()):
            raise AssertionError(
                f"{label}: tokens equal {o1 == o2}, acceptance "
                f"{one['acceptance']} / {two['acceptance']}, verify windows "
                f"alike {same_windows}, largest verify logit difference "
                f"{diff}, graphs {two['graphs']}")
        held_check(torch, held, label)


REC_SHARD_RANGES = REC_RANGES + ("shard_join",)
#: xlstm-1.3b on two shards against one (``fleet recurrent``): a token
#: that differs must come with a logits row within REC_ROW_DIFF_MAX of one
#: shard's, and every row a request emitted up to its first difference
#: within REC_LOGIT_DIFF_MAX -- about twice the readings of the first H100
#: run (0.0203 and 0.1406), the mLSTM's partial sums rounding the other
#: way through bf16 activations and 2-bit lattices.
REC_ROW_DIFF_MAX = 0.04
REC_LOGIT_DIFF_MAX = 0.28


def recurrent_states(eng):
    """Every recurrent state of an engine, whole, copied on its device:
    {(layer, kind, leaf): f32 tensor}."""
    from repro_torch.parallel import sharding

    return {(i, kind, n): sharding.whole(leaf).float().clone()
            for i, layer in enumerate(eng.caches)
            for kind, sub in layer.items()
            if kind in ("mamba", "mlstm", "slstm")
            for n, leaf in sub.items()}


def state_diffs(want, got) -> dict:
    """By kind: the largest absolute difference of a state leaf and the
    largest difference relative to its leaf's largest magnitude."""
    out = {}
    for key, w in want.items():
        d = float((got[key] - w).abs().max())
        rel = d / (float(w.abs().max()) or 1.0)
        cur = out.setdefault(key[1], {"max_abs": 0.0, "max_rel": 0.0})
        cur["max_abs"], cur["max_rel"] = max(cur["max_abs"], d), \
            max(cur["max_rel"], rel)
    return out


def pre_divergence_diff(np, want, want_rows, got, got_rows) -> float:
    """The largest logit difference over the rows every request emitted up
    to and including its first differing token (every row when its tokens
    are equal): the rows that both runs computed from the same tokens."""
    out = 0.0
    for uid, (w, g) in enumerate(zip(want, got)):
        at = next((i for i in range(len(w)) if w[i] != g[i]), len(w) - 1)
        out = max([out] + [float(np.abs(got_rows[(uid, t)]
                                        - want_rows[(uid, t)]).max())
                           for t in range(at + 1)])
    return out


def mamba_split_probe(torch, dev, c, p2) -> dict:
    """Whether mamba's two contractions whose shapes follow the channel
    count -- the depthwise conv's einsum and ``dt_proj``'s f32 product --
    give the whole width's bits when run a shard at a time on the shards'
    channels (two-shard params ``p2``, 4 rows, a window of 16): each
    bit-equal or not, and the largest difference relative to the whole
    width's largest magnitude."""
    from repro_torch.models import common, mamba
    from repro_torch.parallel import sharding

    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    di = c.ssm_expand * c.d_model
    n = len(sharding.parts(p2["dt_proj"]["kernel"]))
    w = di // n
    cd = common.dtype_of(c.compute_dtype)
    xi = torch.randn((4, 16, di), generator=gen, device=dev)
    hist = torch.randn((4, c.ssm_conv_width - 1, di), generator=gen,
                       device=dev)
    vlen = torch.full((4,), 16, dtype=torch.int64, device=dev)
    dt_r = torch.randn((4, 16, c.dt_rank), generator=gen, device=dev)
    whole_conv = mamba._conv(hist, xi, sharding.whole(p2["conv_w"]),
                             sharding.whole(p2["conv_b"]), vlen)[0]
    whole_dt = mamba._dt(sharding.whole_tree(p2["dt_proj"]), dt_r, cd)
    conv = torch.cat([mamba._conv(
        hist[..., i * w:(i + 1) * w], xi[..., i * w:(i + 1) * w],
        sharding.channel_part(p2, "conv_w", i, n, dev),
        sharding.channel_part(p2, "conv_b", i, n, dev), vlen)[0]
        for i in range(n)], dim=-1)
    dt = torch.cat([mamba._dt(sharding.local(p2["dt_proj"], i), dt_r, cd)
                    for i in range(n)], dim=-1)
    out = {}
    for key, a, b in (("conv", whole_conv, conv), ("dt", whole_dt, dt)):
        out[f"{key}_exact"] = torch.equal(a, b)
        out[f"{key}_rel"] = float((a - b).abs().max()) / (
            float(a.abs().max()) or 1.0)
    return out


def recurrent_block_check(torch, dev, c, eng, label) -> dict:
    """One cached call of each recurrent block kind at full width on the
    two-shard engine's params and its states after the run, 4 rows, a
    window of 1 and of 16 tokens (the last row dead): the block over
    channel-split states (``ShardPlan.place_caches``) against the same
    block over whole states and whole params (``sharding.whole_tree``).
    Gated: the output and the states within ``sharding.CHANNEL_SPLIT_RTOL``
    of each tensor's largest magnitude (the xLSTM's partial sums; cuBLAS's
    kernel for mamba's ``dt_proj`` at a shard's width).  Returns the
    largest relative difference by kind and window, whether it was
    bit-equal, and for mamba ``mamba_split_probe``'s reading."""
    from repro_torch.models import mamba, xlstm
    from repro_torch.parallel import sharding

    apply = {"mamba": mamba.mamba_apply, "mlstm": xlstm.mlstm_apply,
             "slstm": xlstm.slstm_apply}
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    out = {}
    for kind in sorted({c.layer_kind(i) for i in range(c.num_layers)}
                       - {"attn"}):
        i = next(j for j in range(c.num_layers) if c.layer_kind(j) == kind)
        p2 = eng.params["layers"][i][kind]
        p1 = sharding.whole_tree(p2)
        for s in (1, 16):
            x = torch.randn((4, s, c.d_model), generator=gen,
                            device=dev).to(torch.bfloat16)
            whole = {n: sharding.whole(v).clone()
                     for n, v in eng.caches[i][kind].items()}
            split = eng.shard_plan.place_caches(
                {kind: {n: v.clone() for n, v in whole.items()}})[kind]
            kw = dict(quant_mode="packed",
                      cache_index=torch.zeros(4, dtype=torch.int32,
                                              device=dev),
                      cache_valid=torch.tensor([s, s, 1, 0],
                                               dtype=torch.int32,
                                               device=dev))
            with torch.no_grad():
                want, _ = apply[kind](p1, c, x, cache=whole, **kw)
                got, _ = apply[kind](p2, c, x, cache=split, **kw)
            pairs = [(want, got)] + [(whole[n], sharding.whole(split[n]))
                                     for n in whole]
            rel = max(float((b.float() - a.float()).abs().max())
                      / (float(a.float().abs().max()) or 1.0)
                      for a, b in pairs)
            out[f"{kind}_C{s}"] = rel
            out[f"{kind}_C{s}_exact"] = all(torch.equal(a, b)
                                            for a, b in pairs)
            if rel > sharding.CHANNEL_SPLIT_RTOL:
                raise AssertionError(f"{label}: the {kind} block over split "
                                     f"states differs by {rel} (relative)")
            del whole, split, want, got
        if kind == "mamba":
            out["mamba_probe"] = mamba_split_probe(torch, dev, c, p2)
    return out


def fleet_recurrent_phase(torch, np, dev, smi, name, launches):
    """(g) ``fleet recurrent``: ``name`` at full width (xlstm-1.3b whole;
    jamba-1.5-large-398b cut to its first JAMBA_LAYERS of 72 layers, kv
    4), seed-0 weights built a layer at a time into one prepared tree
    (``build_packed_params``) for both engines, ``EngineConfig(**REC_ECFG)``,
    the
    ``recurrent_prompts`` (six requests through four slots),
    ``REC_NEW[name]`` greedy tokens each, served graphed by two shards on
    the card and by one.  Gated: jamba's tokens equal to one shard's,
    every decode pass's logits bit-equal and its mamba states after the
    run within ``sharding.CHANNEL_SPLIT_RTOL`` of their largest magnitude;
    xlstm's tokens equal, a differing token only with its top-2 margin at
    most 2 x the row difference (ROADMAP Queue 3's rule) and that row
    difference at most REC_ROW_DIFF_MAX, every row up to a request's
    first difference within REC_LOGIT_DIFF_MAX (its states after the run
    are printed, not held: past the first bf16 activation that rounds the
    other way upstream of a 2-bit lattice they follow other tokens); each
    block kind over split states within ``sharding.CHANNEL_SPLIT_RTOL`` of
    one shard on the same inputs (``recurrent_block_check``, which also
    probes mamba's conv and ``dt_proj`` a shard at a time); graphs
    captured; every packed linear one fused launch (jamba's reads on K3,
    its writes on the write kernel); a slot's split states half a shard.
    Prints the largest logit differences and the states', the recurrent
    bytes a slot by shard against one shard, and the device ms of an
    eager decode pass by range (``mamba_scan``, ``mlstm``, ``slstm``,
    ``shard_join``) and of the decode graph by kernel group, two shards
    against one."""
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.parallel import sharding
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    jamba = name == JAMBA
    c = recurrent_config(name, kv_bits=4)
    label = f"fleet recurrent {name}"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    params = build_packed_params(c, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    prompts = recurrent_prompts(np, c)
    new = REC_NEW[name]
    ecfg = EngineConfig(**REC_ECFG)

    def run(mesh):
        reset_kernel_counts()
        eng = ServingEngine(c, params, config=ecfg, device=dev, mesh=mesh)
        check_prepared_experts(eng, params, label)
        outs, rows, passes = recorded_serve(np, eng, prompts, new)
        got = (fleet_kernel_check(label) if jamba else
               {"quantized_linear_mma": check_k2_path(label)})
        cap = eng.capacity_report()
        out = {"graphs": eng._decode.graph is not None,
               "states": recurrent_states(eng),
               "cache_bytes_per_slot": cap["cache_bytes_per_slot"],
               "param_bytes": cap["param_bytes"]}
        if mesh is not None:
            out["block"] = recurrent_block_check(torch, dev, c, eng, label)
            out["recurrent_bytes_per_slot"] = cap["shard_plan"][
                "recurrent_bytes_per_slot"]
            out["shard_param_bytes"] = cap["shard_plan"]["param_bytes"]
        out["decode_graph"] = profile_replay(torch, eng._decode)
        out["eager_pass"] = eager_ranges(torch, np, c, eng.params,
                                         eng.caches, eng.max_batch,
                                         eng.slot_pos.copy(),
                                         REC_SHARD_RANGES)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return outs, rows, passes, got, out

    o1, r1, p1, _, one = run(None)
    o2, r2, p2, got, two = run(ServingMesh([[dev, dev]]))
    for k, n in got.items():
        launches[k] += n
    divergences = token_divergences(np, label, o1, r1, o2, r2,
                                    strict=jamba)
    states1, states2 = one.pop("states"), two.pop("states")
    diffs = state_diffs(states1, states2)
    rb = two["recurrent_bytes_per_slot"]
    logit_diff = max_pass_diff(p1, p2)
    pre_diff = pre_divergence_diff(np, o1, r1, o2, r2)
    line = {"card": smi, "config": name, "kv_bits": c.quant.kv_bits,
            "layers": f"{c.num_layers} of 72" if jamba else c.num_layers,
            "shards": 2, "devices": [str(dev)] * 2,
            "requests": len(prompts), "new_tokens": new,
            "tokens_equal": o1 == o2, "divergences": divergences,
            "max_decode_logit_diff": logit_diff,
            "pre_divergence_logit_diff": pre_diff,
            "state_diffs": diffs, "rtol": sharding.CHANNEL_SPLIT_RTOL,
            "one_shard": one, "two_shards": two}
    if not jamba:
        line.update(row_diff_max=REC_ROW_DIFF_MAX,
                    logit_diff_max=REC_LOGIT_DIFF_MAX)
    print("fleet recurrent " + json.dumps(line))
    del states1, states2
    bad = []
    if jamba:
        if logit_diff != 0.0:
            bad.append(f"decode logits differ by {logit_diff}")
        if diffs["mamba"]["max_rel"] > sharding.CHANNEL_SPLIT_RTOL:
            bad.append(f"mamba states differ by {diffs['mamba']} after "
                       "the run")
    else:
        bad += [f"request {d['request']}'s row differs by {d['row_diff']}"
                for d in divergences if d["row_diff"] > REC_ROW_DIFF_MAX]
        if pre_diff > REC_LOGIT_DIFF_MAX:
            bad.append(f"rows up to a first difference differ by "
                       f"{pre_diff}")
    if not (one["graphs"] and two["graphs"]):
        bad.append("graphs")
    if len(set(rb["split"])) != 1 or rb["one_shard"] != rb["whole"] \
            + 2 * rb["split"][0] or not rb["split"][0]:
        bad.append(f"recurrent bytes a slot {rb}")
    if bad:
        raise AssertionError(f"{label}: {bad}")
    del params
    gc.collect()
    held_check(torch, held, label)


def fleet_phase(torch, np, dev, peaks, smi):
    """The replica fleet and tensor-parallel serving: (a) the Router over
    two graphed stablelm replicas, (b) a paged fleet drained and restored,
    (c) stablelm with two shards on the card at kv 4 and 2 and paged at
    kv 4, (d) qwen2-vl-2b with two shards (one kv head a shard), (e) the
    fused K2 at the shard shapes, (f) speculative stablelm with two
    shards, (g) xlstm-1.3b and jamba (5 layers) with channel-split
    states, (h) K2, K3 and K4 at the shapes of (f) and (g).  Returns the
    phase's launches."""
    from repro_torch import configs
    from repro_torch.models import lm

    t0 = time.perf_counter()
    launches = dict.fromkeys(("quantized_linear_mma",
                              "quantized_linear_mma_dense",
                              "attention_decode", "attention_decode_paged",
                              "cache_write"), 0)
    fleet_k2_rows(torch, peaks, dev,
                  torch.Generator(device=dev).manual_seed(SEED + 50))
    fleet_k3_rows(torch, peaks, dev,
                  torch.Generator(device=dev).manual_seed(SEED + 51))
    fleet_shard_k2_rows(torch, peaks, dev,
                        torch.Generator(device=dev).manual_seed(SEED + 52))
    fleet_shard_k3_rows(torch, peaks, dev,
                        torch.Generator(device=dev).manual_seed(SEED + 53))
    mark("fleet rows")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    base = configs.get_config("stablelm-1.6b")
    params = lm.init_params(base, torch.Generator(device=dev).manual_seed(
        SEED), device=dev)

    def at(kv_bits, c=base):
        return c.replace(quant=c.quant.replace(kv_bits=kv_bits))

    fleet_router_phase(torch, np, dev, smi, at(4), params, launches)
    mark("fleet router")
    fleet_paged_phase(torch, np, dev, smi, at(4), params, launches)
    mark("fleet paged")
    for kv, paged in ((4, False), (2, False), (4, True)):
        fleet_shard_phase(torch, np, dev, smi, at(kv), params, "fleet shard",
                          launches, paged=paged)
    mark("fleet shard")
    fleet_spec_phase(torch, np, dev, smi, at(4), params, launches)
    mark("fleet spec")
    del params
    held_check(torch, held, "fleet stablelm")
    vlm = multimodal_config(VLM, kv_bits=4)
    params = lm.init_params(vlm, torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    fleet_shard_phase(torch, np, dev, smi, vlm, params, "fleet shard",
                      launches)
    del params
    held_check(torch, held, "fleet vlm")
    mark("fleet vlm")
    for name in (XLSTM, JAMBA):
        fleet_recurrent_phase(torch, np, dev, smi, name, launches)
        mark(f"fleet recurrent {name}")
    print(f"fleet launches {launches} in {time.perf_counter() - t0:.1f} s")
    print(smi)
    return launches


# ``--attn-tile SRC``'s cases: K3's tile path at the served shapes --
# stablelm's verify window (C 5 = k + 1) and prefill chunk (C 16) at kv
# 16/4/2, granite's GQA-4 chunk, qwen2-vl's GQA-6 and jamba's GQA-8 reads
# at C1 and C16 -- with the warp path's decode rows beside them (C1 at G
# <= 4): (config, H, KVH, hd, kv_bits, windows), batch 4 over a 512-row
# cache (``attention_case``); then seamless's encoder read
# (``noncausal_k3_rows``: C 256, every key admitted).
ATTN_TILE_CASES = (("stablelm-1.6b", 32, 32, 64, 16, (1, 5, 16)),
                   ("stablelm-1.6b", 32, 32, 64, 4, (1, 5, 16)),
                   ("stablelm-1.6b", 32, 32, 64, 2, (5, 16)),
                   ("granite-3-8b", 32, 8, 128, 16, (1, 16)),
                   ("granite-3-8b", 32, 8, 128, 4, (16,)),
                   (VLM, 12, 2, 128, 16, (1, 16)),
                   (VLM, 12, 2, 128, 4, (1, 16)),
                   (JAMBA, 32, 4, 128, 4, (1, 16)))


def attn_tile_pass(torch, np, dev):
    """The served passes the tile path sits on: stablelm-1.6b whole, W2A2
    lanes, kv 4, the serve cell's ``EngineConfig`` with speculative
    decoding (k = 4, a W2 draft), the serve prompts.  The first prefill
    chunk (4 x 16 rows, every slot mid-prompt) and a verify window's
    graph (4 x 5 rows), each replayed 5 rounds (device ms a replay between
    CUDA events) and once under the profiler (device ms and launches by
    kernel group).  Returns the ``attn-tile pass`` line."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, Request, \
        ServingEngine

    cfg = configs.get_config("stablelm-1.6b")
    c = cfg.replace(quant=cfg.quant.replace(kv_bits=4))
    params = lm.init_params(c, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    eng = ServingEngine(c, params, config=EngineConfig(
        max_batch=4, max_len=512, prefill_chunk=16, speculative_k=SPEC_K,
        draft_w_bits=2), device=dev)
    for i, p in enumerate(serve_prompts(np, cfg)[0]):
        eng.submit(Request(i, p, max_new_tokens=24))
    eng.step()                          # the first chunk: 64 live rows
    out = {"card": torch.cuda.get_device_name(0)}
    out["prefill_chunk_replay_ms"] = [replay_ms(torch, eng._prefill)
                                      for _ in range(5)]
    out["prefill_chunk_profile"] = profile_replay(torch, eng._prefill)
    while eng.metrics.spec_cycles < 2:
        if not eng.step():
            raise AssertionError("attn-tile pass: no verify window ran")
    out["verify_replay_ms"] = [replay_ms(torch, eng._verify)
                               for _ in range(5)]
    out["verify_profile"] = profile_replay(torch, eng._verify)
    for k in ("prefill_chunk", "verify"):
        out[f"{k}_replay_ms_median"] = statistics.median(
            out[f"{k}_replay_ms"])
    del eng, params
    torch.cuda.empty_cache()
    out["encoder"] = attn_tile_encoder(torch, dev)
    return out


def attn_tile_encoder(torch, dev):
    """seamless-m4t-medium's packed encoder (12 layers, every key admitted
    at C ENC_LEN over ENC_ROWS rows: K3's tile path once a layer), as the
    ``encdec`` line runs it: one warm call, then one under the profiler --
    device ms by kernel group (``SPEC_GROUPS``) and launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    from repro_torch.serve.prepare import prepare_serving_params

    c = multimodal_config(ENCDEC, kv_bits=4)
    params = lm.init_params(c, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    packed = prepare_serving_params(params, c, device=dev)
    enc = torch.randn((ENC_ROWS, ENC_LEN, c.frontend_dim),
                      generator=torch.Generator(device=dev).manual_seed(
                          SEED + 29), device=dev).bfloat16()
    lm.encode(packed, c, enc, quant_mode="packed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lm.encode(packed, c, enc, quant_mode="packed")
        torch.cuda.synchronize()
    kernels = device_rows(torch, prof)
    out = {"device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
           "launches": sum(e.count for e in kernels),
           **kernel_groups(kernels, 1, "", SPEC_GROUPS)}
    del params, packed
    torch.cuda.empty_cache()
    return out


def attn_tile(torch, np, src):
    """``python3 chip_smoke.py --attn-tile SRC``: K3 and K4 at
    ``ATTN_TILE_CASES`` and the encoder's read (their errors against the
    plain version, device ms, SDPA's beside the kv16 rows), then the
    served prefill-chunk, verify and encoder passes (``attn_tile_pass``),
    with the package under ``SRC`` -- this checkout's ``src``, or another
    tree's unpacked beside it (``git archive`` into ``build/parent``): run
    both in one call, parent / this / this / parent, to compare the two
    trees' kernels on one card.  Prints an ``attn-tile row`` line a row and
    an ``attn-tile pass`` line."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    valid_len = torch.tensor([512, 300, 77, 0], dtype=torch.int32,
                             device=dev)
    rows = []
    for config, h, kvh, hd, kv_bits, windows in ATTN_TILE_CASES:
        for r in attention_case(torch, peaks, dev, gen, 4, 512, h, kvh, hd,
                                kv_bits, valid_len, windows):
            rows.append({"config": config, **r})
        torch.cuda.empty_cache()
    rows += [{"config": ENCDEC, **r}
             for r in noncausal_k3_rows(torch, peaks, dev, gen)]
    for r in rows:
        print("attn-tile row " + json.dumps({"src": str(src), **r}),
              flush=True)
    print("attn-tile pass " + json.dumps(
        {"src": str(src), **attn_tile_pass(torch, np, dev)}), flush=True)


#: ``--conv`` rows: (kernel, layout (K5) or None (K6, int16 in [-256,
#: 256)), (n, hw, c, k, co), padding, weight store): Fig. 4 and
#: sparq-cnn's layers (the weights resident), then the shapes the chunked K
#: loop took over from the CUDA-core tiles -- Fig. 4 at 64 / 128 channels
#: and ResNet-18's conv4_x shape.
CONV_COMPARE_CASES = (
    [("K6", None, (1, 256, 32, 7, 32), "VALID", None)]
    + [("K5", t, (1, 256, 32, 7, 32), "VALID", "lanes") for t in FIG4_SPECS]
    + [("K5", "W2A2/int16xP2s8", (8, 256, 32, 7, 32), "SAME", "lanes"),
       ("K5", "W2A2/int16xP2s8", (8, 256, 32, 7, 64), "SAME", "lanes"),
       ("K5", "W2A2/int16xP2s8", (8, 256, 32, 7, 64), "SAME", "dense"),
       ("K5", "W4A4/int32xP2s16", (8, 256, 32, 7, 64), "SAME", "lanes"),
       ("K6", None, (1, 256, 64, 7, 32), "VALID", None),
       ("K5", "W2A2/int16xP2s8", (1, 256, 128, 7, 32), "VALID", "lanes"),
       ("K6", None, (64, 14, 256, 3, 256), "SAME", None),
       ("K5", "W2A2/int16xP2s8", (64, 14, 256, 3, 256), "SAME", "lanes"),
       ("K5", "W4A4/int32xP2s16", (64, 14, 256, 3, 256), "SAME", "lanes")])


def conv_compare(torch, src):
    """``python3 chip_smoke.py --conv SRC``: K5 and K6 at
    ``CONV_COMPARE_CASES`` through the planner's route (whichever kernel
    it picks in that tree), each bit-equal to the plain version and timed
    (device ms by graph replay over rotated copies), then the CNN phase
    (ms a batch, both stores), with the package under ``SRC`` -- this
    checkout's ``src``, or another tree's unpacked beside it (``git
    archive`` into ``build/parent``): run both in one call, parent / this
    / this / parent, to compare the two trees' convs on one card.  Prints
    a ``conv-compare row`` line a row, then the ``cnn`` lines."""
    from repro_torch import configs
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import ops, plan as plan_lib
    from repro_torch.kernels import ulppack_conv2d as conv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for kern, text, (n, hw, c, k, co), padding, store in CONV_COMPARE_CASES:
        if kern == "K6":
            x = torch.randint(-256, 256, (n, hw, hw, c), generator=gen,
                              device=dev, dtype=torch.int16)
            w = torch.randint(-256, 256, (k, k, c, co), generator=gen,
                              device=dev, dtype=torch.int16)
            plan = plan_lib.plan_int_conv2d(
                tuple(x.shape), tuple(w.shape), x_bytes=2, w_bytes=2,
                padding=padding, device=dev)

            def run(xi, w=w, plan=plan, padding=padding):
                return ops.int_conv2d(xi, w, padding=padding, plan=plan)
            want = conv.int_conv2d_torch(x, w, padding=padding)
            nbytes = 2 * x.numel()
        else:
            sp = PackSpec.parse(text)
            qx = torch.randint(0, sp.max_a + 1, (n, hw, hw, c),
                               generator=gen, device=dev, dtype=torch.int32)
            qw = torch.randint(0, sp.max_w + 1, (k, k, c, co),
                               generator=gen, device=dev, dtype=torch.int32)
            x = packing.pack_activations(qx, sp)
            w = (ops.dense_store_conv_weights(qw, sp.w_bits)
                 if store == "dense" else packing.pack_weights(qw, sp, axis=2))
            k_full = c if store == "dense" else None
            plan = plan_lib.plan_packed_conv2d(
                tuple(x.shape), tuple(w.shape), sp, padding=padding,
                weight_store=store, k_full=k_full, device=dev)

            def run(xi, w=w, sp=sp, plan=plan, padding=padding):
                return ops.packed_conv2d(xi, w, sp, padding=padding,
                                         plan=plan)
            want = conv.ulppack_conv2d_torch(x, w, sp, padding=padding,
                                             weight_store=store,
                                             k_full=k_full)
            nbytes = x.numel() * sp.lane_bytes
        conv.reset_counts()
        got = run(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"conv-compare {kern} {text} not bit-equal")
        launched = [name for name, v in conv.kernel_launches.items() if v]
        del got, want
        xs = [x] + [x.clone() for _ in range(copies_for(nbytes) - 1)]
        ms = time_ms(torch, [lambda xi=xi, run=run: run(xi) for xi in xs], 9)
        del xs
        print("conv-compare row " + json.dumps(
            {"src": str(src), "kernel": kern, "layout": text, "store": store,
             "shape": [n, hw, hw, c, k, co, padding], "route": plan.route,
             "launched": launched, "block_co": plan.block_co,
             "chunks": getattr(plan, "chunks", None), "ms": ms}), flush=True)
        torch.cuda.empty_cache()
    cnn_phase(torch, dev, configs.get_config("sparq-cnn"))


def attn_tile_sweep(torch, dev):
    """``--attn-tile SRC --sweep``: K3's device ms at every geometry
    ``plan.attention_decode_candidates`` gives (tile x splits, whole
    16-row pages) for each tile-path row of ``ATTN_TILE_CASES`` (bf16 q,
    the kernel phase's live lengths), each checked within ATTN_TOL + one
    bf16 ulp of the plain version first; prints an ``attn-tile sweep``
    line a row, the heuristic's geometry beside the times."""
    import dataclasses

    from repro_torch.kernels import plan as plan_lib
    from repro_torch.kernels import ulppack_attention as ua
    from repro_torch.models import attention

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bsz, s = 4, 512
    valid = torch.tensor([512, 300, 77, 0], dtype=torch.int32, device=dev)
    for config, h, kvh, hd, kv_bits, windows in ATTN_TILE_CASES:
        kv = [torch.randn((bsz, s, kvh, hd), generator=gen,
                          device=dev).bfloat16() for _ in range(2)]
        if kv_bits != 16:
            (qk, sk), (qv, sv) = (attention.kv_quantize(t, kv_bits)
                                  for t in kv)
            cache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
        else:
            cache = {"k": kv[0], "v": kv[1]}
        nbytes = sum(t.numel() * t.element_size() for t in cache.values())
        caches = [cache] + [{k: t.clone() for k, t in cache.items()}
                            for _ in range(copies_for(nbytes) - 1)]
        for c in windows:
            heur = plan_lib.plan_attention_decode(
                bsz, c, s, h, kvh, hd, kv_bits,
                cache_dtype=cache["k"].dtype, device=dev)
            if attention_path(heur) != "tile":
                continue
            q = torch.randn((bsz, c, h, hd), generator=gen,
                            device=dev).bfloat16()
            qpos = (torch.clamp(valid, min=c)[:, None] - c
                    + torch.arange(c, device=dev)[None, :]).to(torch.int32)
            want = ua.attention_decode_torch(q, cache, valid, qpos,
                                             kv_bits=kv_bits, hd=hd,
                                             block_k=512).float()
            times = []
            for geo in plan_lib.attention_decode_candidates(
                    bsz, c, s, h, kvh, hd, kv_bits, align=16,
                    cache_dtype=cache["k"].dtype):
                p = dataclasses.replace(heur, **geo)
                got = ua.attention_decode_cuda(q, cache, valid, qpos,
                                               kv_bits=kv_bits, hd=hd,
                                               plan=p)
                if not ((got.float() - want).abs()
                        <= ATTN_TOL + ATTN_BF16_RTOL * want.abs()).all():
                    raise AssertionError(f"attn-tile sweep {config} C{c}: "
                                         f"{geo} beyond tolerance")
                times.append([geo["tile_rows"], geo["splits"],
                              geo["split_rows"], time_ms(torch, [
                                  lambda cc=cc, p=p: ua.attention_decode_cuda(
                                      q, cc, valid, qpos, kv_bits=kv_bits,
                                      hd=hd, plan=p) for cc in caches])])
            print("attn-tile sweep " + json.dumps({
                "config": config,
                "shape": f"B{bsz} S{s} H{h} KVH{kvh} hd{hd} C{c} "
                         f"kv{kv_bits}",
                "heuristic": [heur.tile_rows, heur.splits, heur.split_rows],
                "tile_splits_rows_ms": sorted(times, key=lambda r: r[3])}),
                flush=True)
        del caches
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    for flag in ("--w4a4-pass", "--attn-tile", "--conv", "--moe-pass"):
        if flag in sys.argv[1:]:
            src = Path(sys.argv[sys.argv.index(flag) + 1]).resolve()
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    use_package(src)
    import numpy as np

    # every phase before the autotune phase plans from an empty tuning
    # cache (the heuristics); that phase tunes into this scratch file
    tune_dir = scratch_dir("autotune")
    tune_dir.mkdir(parents=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tune_dir / "cache.json")

    from repro_torch.kernels import build, cache_write, quant_pack, \
        ulppack_attention, ulppack_matmul

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {name} capability "
          f"{torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    whole = not any(f in sys.argv[1:] for f in MODE_FLAGS)
    if whole:
        # the serve path's libraries first; the others compile behind the
        # serve, graphs, paged and legacy lines
        build.start(FIRST_LIBRARIES)
        build.start(nice=BUILD_NICE)
        paths = build.build(FIRST_LIBRARIES)
    elif "--moe-pass" in sys.argv[1:]:
        paths = build.build(FIRST_LIBRARIES)
    elif sys.argv[1:] == ["--train-archs"]:
        # the fused K2 and the window write are all these lines launch
        paths = build.build(("ulppack_matmul_mma", "cache_write"))
    else:
        paths = build.build()
    mark("build")
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({len(paths)} libraries, nvcc in parallel"
          + (f"; the other {len(build.building())} compiling at nice "
             f"{BUILD_NICE} behind the serve lines)" if whole else ")"))
    if "--k2-sweep" in sys.argv[1:]:
        k2_sweep(torch, torch.device("cuda"))
        print(smi)
        return 0
    if "--w4a4-pass" in sys.argv[1:]:
        w4a4_pass(torch, np, src)
        print(smi)
        return 0
    if "--conv" in sys.argv[1:]:
        conv_compare(torch, src)
        print(smi)
        return 0
    if "--moe-pass" in sys.argv[1:]:
        moe_pass(torch, np, src)
        print(smi)
        return 0
    if "--attn-tile" in sys.argv[1:]:
        if "--sweep" in sys.argv[1:]:
            attn_tile_sweep(torch, torch.device("cuda"))
        else:
            attn_tile(torch, np, src)
        print(smi)
        return 0
    only = [f for f in ONLY_FLAGS if f in sys.argv[1:]]
    if "--w4a4" in only:
        w4a4_only(torch, np, peaks, smi)
    if "--moe" in only:
        moe_only(torch, np, peaks, smi)
    if "--recurrent" in only:
        recurrent_phase(torch, np, torch.device("cuda"), peaks, smi)
    if "--multimodal" in only:
        multimodal_phase(torch, np, torch.device("cuda"), peaks, smi)
    if "--fleet" in only:
        fleet_phase(torch, np, torch.device("cuda"), peaks, smi)
    if "--parallel" in only:
        parallel_phase(torch, torch.device("cuda"), peaks, smi, name)
        print(smi)
    if "--archs" in only:
        archs_phase(torch, np, torch.device("cuda"), peaks, smi)
    if "--train-archs" in only:
        train_archs_phase(torch, np, torch.device("cuda"), peaks, smi)
    if only:
        return 0

    from repro_torch import configs
    dev = torch.device("cuda")
    cnn_cfg = configs.get_config("sparq-cnn")
    mods = (quant_pack, ulppack_matmul, ulppack_attention, cache_write)

    for mod in mods:
        mod.reset_counts()
    lm_cfg = configs.get_config("stablelm-1.6b")
    ctx, params = serve_phase(torch, np, dev, lm_cfg)
    # the serve path replays CUDA graphs: each replay adds the launches its
    # graph holds (launch/steps.StaticStep)
    launches = {"quantized_linear_mma":
                    ulppack_matmul.mma_launches["quant_affine"],
                "attention_decode":
                    ulppack_attention.kernel_launches["attention_decode"],
                "cache_write": cache_write.kernel_launches["cache_write"]}
    plain = {"quantized_linear_mma": ulppack_matmul.plain_calls[
                 "ulppack_matmul"] + quant_pack.plain_calls,
             "attention_decode":
                 ulppack_attention.plain_calls["attention_decode"],
             "cache_write": cache_write.plain_calls["cache_write"]}
    TILE_LAUNCHES["attention_decode"] = ulppack_attention.tile_launches[
        "attention_decode"]
    print(f"serve launches (kv_bits 16, 4, 2 runs and the profiled kv_bits 4 "
          f"passes): kernels {launches}, plain {plain}, K3 on its tile path "
          f"{TILE_LAUNCHES['attention_decode']}, K2 by route "
          f"{ulppack_matmul.mma_launches}, standalone K1 "
          f"{quant_pack.kernel_launches}, CUDA-core K2 "
          f"{ulppack_matmul.kernel_launches['ulppack_matmul']}")
    for k in launches:
        if launches[k] == 0 or plain[k] != 0:
            raise AssertionError(f"{k}: {launches[k]} kernel launches, "
                                 f"{plain[k]} plain calls on the serve path")
    # the prefill chunks (16 rows a sequence) take K3's tile path, the
    # decode passes its warp path: both ran
    if not 0 < TILE_LAUNCHES["attention_decode"] < launches[
            "attention_decode"]:
        raise AssertionError(f"serve path: K3's tile path launched "
                             f"{TILE_LAUNCHES['attention_decode']} of "
                             f"{launches['attention_decode']} times")
    check_k2_path("serve path")
    compare_backends(torch, np, dev, *ctx)
    mark("serve")
    del ctx
    torch.cuda.empty_cache()
    graphs_phase(torch, np, dev, lm_cfg, params)
    mark("graphs")
    launches["attention_decode_paged"] = paged_phase(torch, np, dev, lm_cfg,
                                                     params)
    if not 0 < TILE_LAUNCHES["attention_decode_paged"] < launches[
            "attention_decode_paged"]:
        raise AssertionError(f"paged path: K4's tile path launched "
                             f"{TILE_LAUNCHES['attention_decode_paged']} of "
                             f"{launches['attention_decode_paged']} times")
    mark("paged")
    # the legacy read against the fused one (the kill-switch), whose fused
    # engines add to K3's and K4's launches
    for k, n in legacy_phase(torch, np, dev, lm_cfg, params, smi).items():
        launches[k] += n
    mark("paged, legacy")
    # every other library, then the kernels against their plain versions
    running = build.building()
    t0 = time.perf_counter()
    paths = build.build()
    mark("build, the rest")
    print(f"kernel build: {len(running)} of {len(paths)} libraries still "
          f"compiling after the legacy lines, done "
          f"{time.perf_counter() - t0:.1f} s later")
    for n, p in paths.items():
        log = (p.parent / f"{n}.log").read_text()
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                                log))
        print(f"ptxas {n}: {len(regs)} kernels, registers {regs}, "
              f"{spills} bytes of spill stores, compiled in "
              f"{build.seconds.get(n, float('nan')):.1f} s")
    rows = kernel_phase(torch, peaks, dev) + int_matmul_rows(torch, peaks,
                                                              dev)
    mark("kernel write, k7")
    conv_rows, fig4 = conv_kernel_phase(torch, peaks, dev, cnn_cfg)
    rows += conv_rows
    for r in rows:
        print("kernel " + json.dumps(r))
    mark("kernels")
    # the dense store's path: the dense line's engine (every packed linear
    # of its run one launch of the dense route); then speculative decoding
    launches["quantized_linear_mma_dense"] = dense_phase(torch, np, dev,
                                                         lm_cfg, params)
    mark("dense")
    spec_launches = spec_phase(torch, np, dev, lm_cfg, params)
    print(f"spec launches (the speculative engines' runs): {spec_launches}")
    mark("dense, spec")
    del params
    torch.cuda.empty_cache()
    # W4A4 int32xP2s16 served whole, lanes and dense: the fused tensor-core
    # K2 of the int32xP2s16 library and of the w_bits-4 dense library
    w4 = w4a4_phase(torch, np, dev, lm_cfg)
    launches["quantized_linear_mma_lanes"] = w4["lanes"]
    launches["quantized_linear_mma_dense"] += w4["dense"]
    mark("serve w4a4")

    # the sliding-window MoE decoder: mixtral-8x7b at full width cut to 4
    # layers, served graphed at kv 16 and 4, its ring past the wrap,
    # reduced mixtral-8x22b, then mixtral-8x22b at full width cut to 14
    # layers; their packed linears add to K2's launches and their ring
    # writes to the window write's
    moe_params, moe_packed, moe_launches = moe_serve_phase(torch, np, dev,
                                                           smi)
    mark("moe serve")
    moe_launches["quantized_linear_mma"] += moe_ring_phase(
        torch, np, dev, moe_params, moe_packed, smi)
    mark("moe ring")
    del moe_params, moe_packed
    gc.collect()
    torch.cuda.empty_cache()
    moe_reduced_phase(torch, np, dev, smi)
    mark("moe reduced")
    for k, n in moe_wide_phase(torch, np, dev, peaks, smi).items():
        moe_launches[k] += n
    for k, n in moe_launches.items():
        launches[k] += n
    mark("moe")
    torch.cuda.empty_cache()
    # the dense configs never served before, whole: granite-3-8b and
    # minicpm-2b at kv 16 and 4, qwen1.5-32b at kv 4, their K2 and K3
    # rows, then both examples; their packed linears add to K2's
    # launches, their reads to K3's, their writes to the window write's
    for k, n in archs_phase(torch, np, dev, peaks, smi).items():
        launches[k] += n
    mark("archs")
    torch.cuda.empty_cache()
    # the recurrent families: the K2 rows at their shapes, xlstm-1.3b whole
    # and jamba-1.5-large-398b cut to 5 layers served graphed, their
    # reduced engines; their packed linears add to K2's launches, jamba's
    # attention layer to K3's and the window write's
    for k, n in recurrent_phase(torch, np, dev, peaks, smi).items():
        launches[k] += n
    mark("recurrent")
    torch.cuda.empty_cache()
    # qwen2-vl-2b and seamless-m4t-medium whole: the K2 rows at their
    # shapes, K3 at a GQA group of 6 and without a causal mask, both
    # served graphed, the image prefix and the encoder op by op; their
    # packed linears add to K2's launches, their reads to K3's, their
    # cache writes to the window write's
    for k, n in multimodal_phase(torch, np, dev, peaks, smi).items():
        launches[k] += n
    mark("multimodal")
    torch.cuda.empty_cache()
    # the replica fleet and tensor-parallel serving: the Router over two
    # graphed stablelm replicas, a paged replica drained and restored,
    # stablelm and qwen2-vl with two shards on the card; their packed
    # linears add to K2's launches, their reads to K3's and K4's, their
    # writes to the window write's
    for k, n in fleet_phase(torch, np, dev, peaks, smi).items():
        launches[k] += n
    mark("fleet")
    torch.cuda.empty_cache()
    launches.update(linear_phase(torch, dev))

    fig4_launches = fig4_phase(torch, fig4, rows)
    for k in ("int_conv2d", "int_conv2d_mma", "ulppack_conv2d"):
        launches[k] = fig4_launches[k]
    del fig4
    (packed, plans), x, launches["ulppack_conv2d_mma"] = cnn_phase(
        torch, dev, cnn_cfg)
    launches["ulppack_conv2d_mma"] += fig4_launches["ulppack_conv2d_mma"]
    cnn_compare(torch, cnn_cfg, packed, plans, x)
    mark("linear, fig4, cnn")
    del packed, plans, x
    torch.cuda.empty_cache()

    # training: full-width LM train steps and their profile; the trained
    # params saved, read back, packed and served; the Trainer's
    # checkpoint / resume at 1 layer; the CNN QAT-trained and deployed.
    # The trained LM's engine and the trained CNN's packed evaluation add
    # to K2's, K3's and K5's launches.
    state, step_fn, data = train_phase(torch, dev, lm_cfg, peaks, smi)
    state = train_profile(torch, state, step_fn, data)
    mark("train")
    trained = state["params"]
    del state, step_fn
    torch.cuda.empty_cache()
    for k, n in train_serve_phase(torch, np, dev, lm_cfg, trained,
                                  smi).items():
        launches[k] += n
    del trained
    torch.cuda.empty_cache()
    mark("train-serve")
    train_ckpt_phase(torch, dev, lm_cfg, smi)
    mark("train, train-serve, train-ckpt")
    # the other LM families' train steps: the reduced ones against the
    # CPU, one arch a family at full width, the trained mixtral-8x7b
    # served; its packed linears add to K2's launches, its ring writes to
    # the window write's
    for k, n in train_archs_phase(torch, np, dev, peaks, smi,
                                  profile=False).items():
        launches[k] += n
    mark("train archs")
    launches["ulppack_conv2d_mma"] += cnn_qat_phase(torch, dev, cnn_cfg, smi)
    mark("cnn-qat")
    torch.cuda.empty_cache()
    # the last modules: the dry run's roofline, the collective matmul, the
    # pipelined blocks (their packed linears add to K2's launches) and the
    # train step with compressed gradients
    for k, n in parallel_phase(torch, dev, peaks, smi, name).items():
        launches[k] = launches.get(k, 0) + n
    mark("parallel")
    torch.cuda.empty_cache()

    # the autotuner, after every other phase so that none of their plans
    # change: the tuned signatures, the serving CLI with --autotune and
    # from the saved cache, and engines on the tuned and the empty cache
    from repro_torch.kernels import autotune
    tuned = autotune_phase(torch, dev, lm_cfg, cnn_cfg)
    mark("autotune tuners")
    autotune.reset_active_cache()
    autotune_cli(torch)
    mark("autotune cli")
    autotune_serve(torch, np, dev, lm_cfg, tuned)
    mark("autotune")
    autotune.reset_active_cache()
    shutil.rmtree(tune_dir, ignore_errors=True)

    meta = {
        # K1 on the serving path is folded into the tensor-core K2
        # (quantized_linear_mma, the serve phase); the standalone K1's
        # path, like the lanes route's of the tensor-core K2, is the
        # linear phase (its lattice-dot rows)
        "quantize_pack": ("src/repro_torch/csrc/quant_pack.cu",
                          "src/repro/kernels/quant_pack.py:86",
                          "x[4,2048]"),
        "quantized_linear_mma": (
            "src/repro_torch/csrc/ulppack_matmul_mma.cu",
            "src/repro/kernels/quant_pack.py:86",
            "(4,1024,2048) W2A2/int16xP2s8 bf16 x"),
        "ulppack_matmul_mma": ("src/repro_torch/csrc/ulppack_matmul_mma.cu",
                               "src/repro/kernels/ulppack_matmul.py:99",
                               "(4,1024,2048) W2A2/int16xP2s8"),
        # K2 over the bit-dense weight store (K1 folded in, as on lanes);
        # its path is the dense line's engine
        "quantized_linear_mma_dense": (
            "src/repro_torch/csrc/ulppack_matmul_mma_dense.cu",
            "src/repro/kernels/ulppack_matmul.py:99",
            "(4,1024,2048) W2A2/int16xP2s8 bf16 x dense"),
        # K2 on the tensor cores for every other layout (one library per
        # layout): the fused route's path is the serve w4a4 line's lanes
        # engine, the lanes-in routes' the linear phase's W4A4 lattice-dot
        # rows.  The CUDA-core K2 (csrc/ulppack_matmul.cu) is on no
        # path: its time is each layout row's core_ms.
        "quantized_linear_mma_lanes": (
            "src/repro_torch/csrc/ulppack_matmul_mma_lanes.cu",
            "src/repro/kernels/ulppack_matmul.py:99",
            "(4,1024,2048) W4A4/int32xP2s16 bf16 x"),
        "ulppack_matmul_mma_lanes": (
            "src/repro_torch/csrc/ulppack_matmul_mma_lanes.cu",
            "src/repro/kernels/ulppack_matmul.py:99",
            "(4,1024,2048) W4A4/int32xP2s16"),
        "attention_decode": ("src/repro_torch/csrc/attention_decode.cu",
                             "src/repro/kernels/ulppack_attention.py:395",
                             "B4 S512 H32 hd64 C1 kv4"),
        # K4's path is the paged serve phase, K7's the linear phase
        "attention_decode_paged": (
            "src/repro_torch/csrc/attention_decode.cu",
            "src/repro/kernels/ulppack_attention.py:367",
            "B4 32x16 pages H32 hd64 C1 kv4"),
        # K5's main path is the CNN phase (both stores) and the Fig. 4
        # phase, on the tensor cores for every layout and shape; its row is
        # the largest packed layer.  K6's path is the Fig. 4 phase.
        "ulppack_conv2d_mma": ("src/repro_torch/csrc/ulppack_conv2d_mma.cu",
                               "src/repro/kernels/ulppack_conv2d.py:148",
                               "layer 32->64"),
        "int_conv2d_mma": ("src/repro_torch/csrc/int_conv2d_mma.cu",
                           "src/repro/kernels/ulppack_conv2d.py:148",
                           "fig4 x"),
        "int_matmul": ("src/repro_torch/csrc/int_matmul.cu",
                       "src/repro/kernels/ulppack_matmul.py:145",
                       "(8,4096,4096) int8"),
        # no TPU kernel of its own: the reference's window write is XLA's
        # drop-mode scatter; its path is the serve phase (every layer of
        # every graphed decode pass and prefill chunk)
        "cache_write": ("src/repro_torch/csrc/cache_write.cu",
                        "src/repro/models/attention.py:533 (XLA scatter, "
                        "no pallas_call)", "B4 C1"),
    }
    # The CUDA-core K5 and K6 are on no path since the chunked K loop: each
    # is a comparison entry of its tensor-core kernel, timed on the
    # operands of the shape it took before (Fig. 4 at 128 / 64 channels)
    comparison = {
        "ulppack_conv2d_mma": ("ulppack_conv2d",
                               "src/repro_torch/csrc/ulppack_conv2d.cu",
                               "fig4-c128"),
        "int_conv2d_mma": ("int_conv2d", "src/repro_torch/csrc/int_conv2d.cu",
                           "fig4-c64")}
    summary = []
    for k, (source, replaces, shape) in meta.items():
        r = next(r for r in rows if r["name"] == k and
                 r["shape"].startswith(shape))
        extra = ({"tile_launches": TILE_LAUNCHES[k],
                  "tile_launches_of": "serve phase" if k == "attention_decode"
                  else "paged phase"} if k in TILE_LAUNCHES else {})
        if k in comparison:
            cname, csource, cshape = comparison[k]
            c = next(r for r in rows if r["name"] == k and
                     r["shape"].startswith(cshape))
            if launches.get(cname):
                raise AssertionError(f"{cname}: {launches[cname]} launches "
                                     f"on the main path")
            extra["comparison"] = {
                "name": cname, "route": "cuda", "source": csource,
                "on_path": False, "launches": 0, "max_abs_err": 0,
                "ms": c["cores_ms"], "tensor_core_ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                "shape": c["shape"]}
        summary.append({"name": k, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[k],
                        **extra,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        # a phase that failed while libraries were still compiling leaves
        # no nvcc running
        if "repro_torch.kernels.build" in sys.modules:
            sys.modules["repro_torch.kernels.build"].cancel()
    sys.exit(code)
