#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spokennlp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Preconditions: a CUDA card; prints the torch, CUDA and nvcc versions and
   the card's name and power limit.
2. Builds the kernels (csrc/*.cu, one nvcc per source for sm_90a) and prints
   the build time; prints the registers and spills (the build's ptxas
   report) of the int8 tile's kernels and the tiles' shared memory; runs
   cuobjdump -sass on the library and fails unless every int8 tile kernel
   (gemm_act, gemm_act_quant, qkv_proj, residual_ln and the W8A8 stack)
   holds IMMA, the tensor cores' int8 product, and no function but 1c's int8
   attention core and the W8A8 global query holds IDP4A (__dp4a); both the
   bf16 and the float32 (3xTF32) instantiations of the dense attention core
   (attn_core_kernel), of row 10's cores (attn_rows, attn_dq, attn_dkv), of
   the band and BigBird rows kernels and gradient kernels (dq and dkv) and
   the Longformer global rows (global_rows, its W8A8 and statistics-pass
   instances among them; global_kv_grad holds none at all), of
   the W8A8 stack entry (or
   its core item), of the GEMM tile's kernels (gemm_bias_act, a weight read
   as stored or transposed, qkv_proj, gemm_bias_residual_ln, weight_grad,
   act_and_grad) and of the float stack entry (or its out-of-line GEMM
   items, and its core item) hold HMMA; no other function does
   (sass_verdict). Prints the ptxas registers and spills of those functions
   and the float and int8 tiles' shared memory too.
3. Inference kernel phase: each inference kernel against its plain PyTorch
   version at the main path's shapes (B=32, L=512, H=768, 12 heads of 64,
   I=3072), bfloat16 and float32, with padded tails and two packed segments;
   prints the largest error on valid rows and both times (CUDA events,
   after a warm-up); in bf16 two planted faults of a GEMM tile (partial sums
   rounded to bf16 every k-stage, the last k-step dropped) in the plain
   version must fail the kernel's limit (BF16_TOL); in float32 each is also
   held to its plain version with the products on the 3xTF32 tile's
   rounding model (F32_FWD_TOL, max and norm; the attention block also on
   its out projection alone) and plain TF32 planted in those products must
   fail that gate, as in the float32 stack, the Longformer and BigBird
   blocks and the training forwards (phases 4, 8, 12), where each float32
   backward's recomputed projections (or MLP intermediate) must equal its
   forward's bit for bit; torch.matmul on the
   blocks' products alone is their library column (bf16, and float32
   without TF32). Then the W8A8 kernels at the same shapes: the W8A8
   matmul (kernel 5) and its row-quantising form (kernel 4) at a layer's four
   projections (768x2304, 768x768, 768x3072 with GELU, 3072x768), their
   int32 accumulators compared exactly and the row quantiser bit for bit,
   beside torch._int_mm on the same int8 operands (kernel 5's TOPS and its
   ratio to torch._int_mm printed, for the projections timed one by one and
   for the four back to back); the W8A8 modes of the
   attention block (a head group of 12 heads and of 6) and the MLP block,
   within float32 rounding (bf16: 2e-3 and one output rounding) but for at
   most 1 % (bf16: 0.2 %) of the outputs, moved by an int8 step, and four
   planted faults (heads_per_block ignored, no quantisation in either block,
   the MLP intermediate rounded to bf16) each failing that check; the
   attention over a projected qkv (kernel 6) beside
   scaled_dot_product_attention (its TFLOP/s and ratio printed), also held
   against its own rounding model (CORE_GATE; in float32 its products on
   the 3xTF32 model) with two planted faults, and in float32 plain TF32 in
   the model's core products (F32_CORE_FAULT), failing that gate; the
   blocks' dense core alone at their own launch
   (attention_block.attention_core), held to the same gate (F32_CORE_FAULT
   failing it) and timed beside
   scaled_dot_product_attention: the core columns of rows 1 and 1 W8A8 (row
   3's cores run inside the stack, untimed: it gets the library calls
   only); and the whole-stack kernel (kernel 3) over 12 layers, W8A8 and float, bit-identical to the chain of kernels 1 and 2
   and within a limit per mode of the plain loop of layers. Rows 1, 2 and 3
   in W8A8 (and 9 in phase 15) also time torch._int_mm on their int8
   products alone, their library column; the float stacks torch.matmul on
   their 48 products.
4. Training kernel phase: the four training kernels (attention and MLP,
   forward and backward) at the same shapes, bfloat16 and float32, at
   dropout rate 0 and at 0.1 with the kernels' mask replayed in the plain
   version: the output, dx and every weight and bias gradient against the
   plain version's output and autograd gradients; the keep fraction of one
   (B, nh, L, L) mask within 1e-3 of 0.9; kernel and plain times, and
   torch.matmul on the blocks' products (library column). In bf16 the
   attention backward's dproj against the rounding model of its gradient
   kernels (BWD_CORE_TOL, three planted faults each failing it), two runs'
   dproj bit-identical, its forward and backward split by kernel name and
   its peak memory. In float32 (the cores on 3xTF32) the same split, dproj
   against that model with its core products on the 3xTF32 model
   (F32_BWD_CORE_TOL) at both rates, two runs' dproj bit-identical, and
   plain TF32 in the plain version's or the model's core products
   (F32_CORE_FAULT) failing F32_TOL (the output and the gradients, by
   autograd through the same products), F32_FWD_TOL and F32_BWD_CORE_TOL.
5. Inference main path: topic-segmentation inference through the port's CLI
   (cli/run_inference.main) at BERT-base widths in bfloat16 on a synthetic
   wiki_section corpus of several hundred 512-token windows, with
   attention_impl "fused" (at batch 32 "auto" takes the stack kernel).
   Checks that each inference kernel ran once per layer per batch, that the
   metrics are finite, and that the fused path's logits agree with the
   einsum path's on one batch (argmax agreement >= 0.99). Then the serving
   configuration (bench.py's make_model: W8A8, softmax in the compute type,
   attention_impl "auto") through the engine call run_topic_seg_inference on
   the same corpus: at batch 32 the stack kernel once a batch, at batch 128
   the W8A8 attention and MLP blocks once a layer a batch, the W8A8 einsum
   path with kernels 4 and 5 four times a layer a batch, and unquantised the
   same two batches and the pallas path with kernel 6 once a layer a batch;
   each kernel path's argmax agreement >= 0.99 with the einsum path of its
   quantisation on the first 128 windows (W8A8 against unquantised printed,
   not gated); windows/s, peak memory, and the busy share and top kernels
   of the auto and pallas engine calls under torch.profiler. The serving
   paths of the same model: attention_impl "flash" (kernel 6 once a layer a
   batch, gated against einsum like pallas); eval/streaming.py at batch 128,
   two batches a chunk (kernels 1 + 2; its per-document scores equal the
   batch engine's bit for bit; its timing split printed); the cos predictor
   at batch 32 (kernel 3) against the W8A8 einsum path (the > 0.5 decisions
   agree on >= 0.99 of the sentences). Packed inference (eval/
   packed_inference.py) over a corpus of short documents (most rows hold
   several windows): at batch 32 (kernel 3) and 128 (kernels 1 + 2) against
   the unpacked engine (argmax agreement >= 0.99), and kernel 3 on the
   packed rows against its chain of kernels 1 + 2 (bit for bit) and its
   plain loop. Checkpoints: the serving model exported natively, as an HF
   directory and as HF safetensors written here, each read back through
   run_inference --model_name_or_path with the same per-document scores, bit
   for bit, as the model in memory.
6. Training main path: fine-tuning through cli/run_finetune.main at
   BERT-base widths and 12 layers, L=512, bfloat16, with the DA view, TSSP
   and eop_matrix CSSL, for a few optimizer steps on a synthetic corpus.
   Checks that each training kernel ran layers x views x steps times, that
   every loss and grad_norm is finite, and that the checkpoint written at
   the end reloads and equals the final model; prints steps/s and windows/s.
   Then two steps with attention_impl "flash" and --save_hf_format: the
   same training kernels as many times a step, and final_model_hf loads back
   to final_model's parameters.
7. Fused against einsum training on one batch at dropout 0: the loss within
   1e-2 relative and the cosine similarity of every layer's weight-matrix
   gradients >= 0.99.
8. Longformer kernel phase at the reference's flagship shape (B=8, L=2048,
   H=768, 12 heads of 64, window 512; rows full or suffix-padded to
   1024-1900 tokens; CLS global): the inference block and the training
   block's forward and backward against their plain versions, bfloat16 and
   float32, with and without global rows, at dropout 0 and 0.1 (the kernels'
   three keep masks replayed); the keep fraction of each mask within 1e-3
   of 0.9; two backward runs bit-identical; kernel, plain and bound times.
   global_kv_grad_kernel's device time in the backward's split beside its
   bound (gkv_ms, gkv_bound_ms), in both dtypes.
   In float32 (the band and global rows and the gradient kernels on
   3xTF32) the forwards against their plain versions with every product,
   the cores' too, on the 3xTF32 model (F32_FWD_TOL), the backward's dproj
   against its rounding model on that model (F32_BWD_CORE_TOL) at both
   rates, with and without
   global rows, two runs' dproj bit-identical, the backward split by kernel
   name, and plain TF32 in the cores' products (F32_CORE_FAULT) failing
   each of those gates and F32_TOL (the output and gradients, by autograd
   through the same products). Phase 12 does the same for BigBird.
9. Longformer inference main path: cli/run_inference.main with
   --attention_type sliding_window --attention_window 512 --max_seq_length
   2048 --per_device_eval_batch_size 8 on long documents (at least half the
   windows hold >= 1536 real tokens); each Longformer kernel ran once per
   layer per batch; argmax agreement >= 0.99 with the plain chunked path.
10. Longformer training main path: cli/run_finetune.main with the recipe's
   flags (batch 2, 4 accumulation steps, DA + TSSP + eop_list CSSL) for 2
   optimizer steps; each training kernel ran layers x views x 8 micro-steps
   times; finite losses; then fused against chunked einsum gradients on one
   micro-batch of 2 (qkv_global included).
11. (In phase 3.) Kernels 4 and 5 also with float32 activations and output,
   at the same four projections, held within float32 rounding.
12. BigBird kernel phase: the inference block at the serving shape (B=4,
   L=4096, blocks of 64, 2 global and 3 random blocks) and the training
   block's forward and backward at B=8, L=2048, bfloat16 and float32, rows
   full, suffix-padded and one with 100 real tokens (fewer than the global
   blocks hold), plus a sequence of 4 blocks whose random entries fall back
   to padded self; dropout 0 and 0.1 with the four keep masks replayed; each
   keep fraction within 1e-3 of 0.9; two backward runs bit-identical;
   kernel, plain and bound times (tolerances as for kernels 7 and 12).
13. BigBird inference main path: cli/run_inference.main with
   --attention_type bigbird --max_seq_length 4096
   --per_device_eval_batch_size 4 on long documents (at least half the
   windows hold >= 3072 real tokens); the BigBird block and the MLP block ran
   once per layer per batch; argmax agreement >= 0.99 with the plain block
   path; windows/s and peak memory of both.
14. BigBird training main path: the Longformer recipe's flags with
   --attention_type bigbird --max_seq_length 2048 for 2 optimizer steps;
   each training kernel ran layers x views x 8 micro-steps times; finite
   losses, the checkpoint reloads; then the kernels' gradients against the
   block path's on one micro-batch of 2 at dropout 0.
15. PoNet kernel phase: the fused PoNet mixer block (kernel 9) at B=8,
   L=4096, H=768, window 3, in bfloat16, float32 and its W8A8 mode with
   either activation type, on ids as the MUG featuriser makes them (CLS in
   segment 0, sentence runs of 5-60 tokens, the pad run n_sent + 1; rows
   full and suffix-padded, one with singleton runs and tied rows, one with
   non-contiguous ids), against its plain version on real rows (float32
   1e-4 and bfloat16 3e-2 of the largest output, W8A8 as the W8A8 blocks);
   four planted faults (the XLA mixer's SMP with pads in segment 0, no
   second max, the LMP window shifted by one, GA's mean over all rows, and
   in float32 the six products in plain TF32) each failing the check;
   kernel, plain and bound times (float32's bound with its products on the
   3xTF32 tensor cores, and on the CUDA cores beside it) and torch.matmul
   (or torch._int_mm) on the six products.
16. MUG main path: cli/run_mug.main, Track 1, from a PoNet-base checkpoint
   written by models/checkpoint_io.save_checkpoint (ponet_mixer_impl
   "fused"; a second run with quantize "w8a8"), on a synthetic MUG corpus:
   2 optimizer steps at batch 4 over 4096 tokens on the plain mixer, then
   prediction of 18 windows (most with >= 3072 real tokens) through kernel
   9 once a layer a batch (and the W8A8 MLP block under W8A8); finite
   metrics; on the trained model, predict_boundaries' windows/s and peak
   memory on the kernel path and both plain paths, and argmax agreement
   >= 0.99 on the labelled EOS positions with the plain fused path (with
   the XLA mixer printed, not gated). Then Track 2 once.
17. W8A8 long-context kernel phase: the W8A8 modes of the Longformer block
   (kernel 7, B=8, L=2048, with and without global rows) and the BigBird
   block (kernel 8, B=4, L=4096, with the 100-token row), bf16 and float32,
   against their plain versions (the W8A8 check of phase 3); planted
   faults, each made by patching one helper of the plain version: one x
   scale, one ctx scale or one QKV weight scale for the batch must fail the
   check in both dtypes; ctx unquantised or quantised per head in float32
   (printed in bf16, where ctx's int8 step is within the check's rounding);
   a ctx rounded to bf16 before its quantisation is printed, not gated; for
   Longformer, the global query from the local q weights must fail it on
   the global rows; kernel, plain, bound and torch._int_mm times.
18. The last two kernel modes at the main path's shapes: the W8A8 MLP block
   with a static intermediate scale (2b) and the W8A8 attention block with
   the int8 core (1c: "qk", "av", "both"; head groups of 12 and 6), against
   their plain versions, with three planted faults (2b with per-row scales;
   1c with q and k scales over the batch, or its denominator summed over the
   rounded p8); times, bounds and torch._int_mm on the projections (1c's
   library time leaves out the core's products).
19. W8A8 long-context serving: the engine call run_topic_seg_inference on
   Longformer-base (batch 8 x 2048) and BigBird-base (batch 4 x 4096), built
   as JAX's on-chip suite builds them (W8A8, softmax in the compute type,
   attention_impl auto, bf16), on the long corpora of phases 9 and 13: the
   W8A8 blocks ran once a layer a batch; JAX's own gate (argmax >= 0.999,
   mean |dlogit| <= 0.1 on real tokens of two batches with suffix padding)
   against the unquantised bf16 chunked or block path; argmax >= 0.99
   against the W8A8 einsum path (kernels 4 and 5) at the sentence slots;
   median windows/s of 3 calls and peak memory of the W8A8 kernel path, the
   W8A8 einsum path and the float kernel path; busy share and top kernels
   of the W8A8 kernel path. Every main path counts the launches of 1c and
   2b apart and fails if one ran: the kernels line gives their sum.
20. The rows kernels alone (band_rows_kernel, bigbird_rows_kernel on
   attention_rows_mma.cuh's bf16 tensor-core body), in each mode a main path
   runs them: band_rows at B=8, L=2048 as kernel 7 (bf16 ctx), kernel 7
   W8A8 (float32 ctx), row 12's forward at dropout 0.1 and its statistics
   pass; bigbird_rows at B=4, L=4096 as kernel 8 and 8 W8A8 and at B=8,
   L=2048 as row 13's forward and statistics pass. Each against its
   rounding model (ctx and the statistics m, D, rowsum(dp p_eff)) within
   ROWS_TOL, with three planted faults (probabilities unrounded, a key tile
   dropped, a running maximum) each failing it; its time beside its bound
   and, for the forwards, scaled_dot_product_attention with the boolean
   mask of the allowed keys (dense) on the same q, k, v: rows_ms,
   rows_bound_ms and rows_library_ms of the kernels line's rows 7, 8, 12
   and 13. The same for attn_rows (row 10's rows kernel) at B=32, L=512 as
   its forward and statistics pass at dropout 0.1, then row 10's gradient
   kernels alone (attn_dkv, attn_dq: dkv_ms, dq_ms, grad_bound_ms), in bf16
   and in float32 (3xTF32: the model's products on the 3xTF32 model, the
   dropped key tile and F32_CORE_FAULT failing ROWS_TOL); band_rows and
   bigbird_rows in float32 in the same modes (the W8A8 modes with float32
   activations run the float modes' instantiations), held the same way;
   and
   scaled_dot_product_attention with the mask, forward and backward, on
   the same q, k, v and dctx as the library column of rows 10, 12 and 13's
   backward cores (core_library_ms), in both dtypes. Then the
   Longformer global rows alone (global_rows_kernel on global_rows_mma.cuh's
   tensor-core body, train_sliding.sliding_global_rows) at B=8, L=2048 with
   CLS global (n_glob 1) and with 16 global tokens, in each mode: kernel 7
   bf16, kernel 7 W8A8 (int8 query, float32 ctx), row 12's forward at
   dropout 0.1 and its statistics pass (with dqg): qg against the plain
   query (QG_TOL, W8A8 bit for bit; a query without its bias must fail),
   ctx and the statistics within ROWS_TOL and dqg within BWD_CORE_TOL
   against sliding_global_rows_model, the three planted faults each
   failing, two launches the same bits; the kernel's device time beside
   its bound and SDPA's with the key-padding mask: global_ms,
   global_bound_ms and global_library_ms (and their _16 twins) of the
   kernels line's rows 7, 7 W8A8 and 12. Then the same in float32 (the
   3xTF32 body, the keys of a (head, sequence) over a cluster of blocks) in
   the four modes (kernel 7, kernel 7 W8A8 with float32 activations, row
   12's forward and statistics pass) at n_glob 1 and 16 and at B=8 and the
   recipe's B=2: qg within QG_F32_TOL (W8A8 bit for bit; the bias-free and
   the plain TF32 query must fail), ctx and the statistics within
   ROWS_TOL["float32"] and dqg within F32_BWD_CORE_TOL against the model on
   the 3xTF32 products (F32_CORE_FAULT and the dropped key tile must fail),
   two launches the same bits, the time beside the 3xTF32 bound and SDPA
   float32's (the float32 rows' global_* keys, B=2 ending in _b2).
21. Prints the serving runs (flash, streaming and cos among them), the
   packed, checkpoint and flash training runs, the Longformer, BigBird, MUG
   and W8A8 long-context runs, the training-at-scale runs (phases 22-26),
   the Track 3-4 and AID runs (phases 27-29) and the kernels as JSON lines,
   the card's name and power limit, and last {"ok": true, "device": {...}}.
22. Gradient checkpointing on the dense training main path (after phase 7):
   run_finetune --gradient_checkpointing at batch 32 in bf16 (against phase
   6's run) and float32 (both runs, 2 steps each): rows 10 and 11's forwards
   twice a layer a view a step, their backwards once; windows trained/s and
   peak memory with and without; one composite step's loss and gradients at
   dropout 0.1 with and without checkpointing bit for bit, every entry (the
   plain step run twice must repeat itself bit for bit: the embedding
   tables' backward sums in an order the data fixes, models/encoder.py
   ``table_grad``; nothing may move from run to run).
23. The same for the float32 Longformer recipe (after phase 10): 2 optimizer
   steps of 2 x 4 micro-batches with --gradient_checkpointing against the
   recipe's float32 run, and one micro-batch's gradients bit for bit.
24. MLM+NSP pretraining: cli/run_pretrain_mlm.main at its defaults
   (BERT-base, 128 tokens, batch 8, float32) for an epoch of a synthetic
   meetings corpus (3 steps or more): rows 10 and 11 once a layer a step,
   finite losses, sequences/s; one batch's loss within LOSS_RTOL and every
   layer's weight-matrix gradient cosine >= MIN_GRAD_COSINE against the
   einsum path at dropout 0.
25. Feature extraction: cli/run_extract_features at its defaults (BERT-base,
   128 tokens, batch 8, float32, the last four layers) over 64 examples:
   kernels 1 and 2 once a layer a batch, examples/s; the first batch's
   features of every layer against the einsum path (with the kernels' tanh
   GELU) within F32_FWD_TOL.
26. The data-parallel train step inside a process group of world size 1
   over NCCL against the step without a group (run twice, repeating itself
   bit for bit): metrics and every gradient bit for bit; run_finetune
   for 3 steps at batch 32 (bf16) with and without the group: launches and
   windows trained/s; the run without writes --report_to tensorboard, read
   back with TensorBoard's reader.

27. MUG Track 4: cli/run_mug.main --track keyphrase at BERT-base widths,
   L=512, batch 4, float32, one epoch of 16 synthetic sentences (CJK
   characters, one empty, one of 500; a 21,128-character vocabulary) and 10
   eval sentences: rows 10 and 11 once a layer a step, kernel 3 once a
   predict batch; finite losses; on one training batch holding the empty
   sentence the loss within LOSS_RTOL and every layer's weight-matrix
   gradient cosine >= MIN_GRAD_COSINE against the einsum path at dropout 0;
   the trained model's Viterbi tags from the kernel path's emissions
   against its einsum twin's (tanh GELU) on >= 0.99 of the valid positions;
   sentences trained/s and tagged/s, and the CRF's share of a step (its
   loss and backward alone against the whole step).
28. Action-item detection: cli/run_aid.main at its defaults (BERT-base,
   L=128, batch 16, float32, context-drop-dynamic, cls) for one epoch (4
   steps): the same launches (kernel 3 once an eval batch), loss and
   gradients against einsum, eval argmax agreement >= 0.99 against the
   einsum twin, examples trained/s.
29. MUG Track 3: cli/run_title_generation.main --model_arch palm at
   PALM-chinese-base widths (768, 12 encoder and 12 decoder layers, 12
   heads, 3072), S=512, T=32, 4 beams, batch 4, a character vocabulary, 3
   steps and one decoded eval batch; then --model_arch seq2seq at the CLI's
   defaults for 2 steps. Rows 10 and 11 once an encoder layer a step,
   kernel 3 once a decode step (the whole model runs again at each step,
   as in JAX); the loss and gradients against einsum; the first decode
   step's log-probabilities within F32_FWD_TOL of the einsum path with the
   kernels' tanh GELU; titles/s. Each phase prints its seconds; the
   kernels line's launches of rows 10, 11 and 3 include these paths'.
30-32. Ditto, SLD and WavLM-Large (ditto_path, sld_path, wavlm_path).
33. MMVTS on BERT-base: cli/run_finetune_multimodal.main at its defaults
   (512 tokens, float32, batch 2, 4 accumulation steps, 64 clips a window)
   with the reference's fusion widths (768, CLIP's 512-wide vis and
   Whisper-small's 768-wide audio features), ma_moe with the capacity
   dispatch, modality CL over tv, av and at, list-mode topic CL (near), for
   an epoch of 4-6 micro-batches of a synthetic clvts corpus, then eval and
   one --do_pretrain run: rows 10 and 11 once a layer a micro-batch, kernel
   3 once an eval batch of 2; finite losses and video metrics; windows
   trained/s and evaluated/s, peak memory, the MoE's share of a step (CUDA
   events); one batch's loss and weight gradients against the einsum path
   at dropout 0 (LOSS_RTOL, MIN_GRAD_COSINE); eval argmax against the
   einsum twin >= 0.99.
34. The same on Longformer-base over 2048 tokens (window 512) with the ca
   cross-encoder, the transformer projector and the hybrid predictor with
   per-clip gates: rows 12 and 11 in training, kernels 7 and 2 in eval
   (the all-zeros global mask: no global rows); no pretraining run.
35. CLIP ViT-B/16 at random: encode_clip_frames over 320 random frames in
   40 uneven clips (one empty): frames/s and the tower's time a batch of
   32; three clips against the CPU within F32_FWD_TOL, with the erf GELU
   planted in place of QuickGELU failing it. The kernels line's launches of
   rows 2, 3, 7, 10, 11 and 12 include phases 33-34's.
36-39. The multi-device paths, two ranks on the one card over gloo
   (dryrun.run_workers: NCCL refuses two ranks on one GPU, so the
   collectives cross through the host) against one rank on the same global
   batch (two_rank_phases): 36 SLD data parallel at GPT-2 small (8 x 1024,
   float32, dropout and time masking on); 37 MMVTS dense data parallel
   (BERT-base trunk on auto, the reference's fusion widths, the modality
   CL, the matrix topic CL and ma_moe's capacity dispatch over both ranks'
   tokens); 38 run_finetune's step at BERT-base on auto with
   --model_parallel_size 2 (rows 10 and 11 on the weights gathered whole,
   eval on kernel 3); 39 MMVTS on Longformer-base over 2048 tokens with
   --model_parallel_size 2 (the experts and heads sharded; rows 12 and 11,
   kernels 7 and 2 on gathered weights). Each: the loss within dryrun.LOSS_RTOL, the gradient
   norm within dryrun.GRAD_NORM_RTOL, the gradients' cosine >=
   TWO_RANK_MIN_COSINE, the time masks and a greedy decode (36) or the eval
   argmax equal; rows trained/s beside the one-rank run's; the two-rank
   launches (counted from 0 on rank 0) join the kernels line's. Before
   them, kernel 3 (float32) at MMVTS's eval batch of 2 and at 1 against the
   chain of kernels 1 and 2 (bit for bit, both timed).

Exits non-zero, and prints no result, without a card, outside the repo, or
when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# the main path's shapes: BERT-base over 512-token windows, batches of 32
B, L, H, NH, HD, I, LAYERS = 32, 512, 768, 12, 64, 3072, 12
# kernels 1 and 2 in bf16 against their plain versions (float32 throughout,
# on the same bf16 inputs and weights), on valid rows: |err| <= atol + rtol
# |ref|. rtol 2^-7 takes the output's own bf16 rounding (one step of a value
# that both sides round, from either side of a rounding boundary); atol
# takes the kernel's other roundings (q, k, v, the probabilities and ctx; the
# MLP intermediate), where the plain version stays in float32. Per kernel,
# from the H100 readings of max(|err| - 2^-7 |ref|) (PERF.md, section 6) over
# this script's shapes and every shape of the card tests: attention at most
# 5.8e-3 (two heads of 16 over 63 keys; 2.7e-3 at the main path's shapes),
# MLP 4.4e-3. A product whose float32 partial sums were rounded to bf16
# after every k-stage reads 1.02e-2 (attention) and 7.9e-2 (MLP) at the main
# path's shapes, one that left out its last k-step 0.26 and 0.68: the kernel
# phase plants both in the plain version (BF16_GEMM_FAULTS) and must see
# each fail. (The old limit, 5e-2 + 2e-2 |ref| for both, lets the
# attention block's rounding fault through.)
BF16_TOL = {"fused_attention_block": (7.5e-3, 2**-7), "fused_mlp_block": (1.2e-2, 2**-7)}
# the other kernels: max |kernel - plain| / max |plain| per output
# (tests/test_torch_train_blocks.py gives the reasons): bf16 for every kernel
TRAIN_TOL = {"bfloat16": 3e-2}
# float32, per kernel, from this script's H100 readings (PERF.md: kernels 1
# and 2 at most 1.4e-6 absolute; the others 1.2e-7 to 6e-6 of the largest
# output, the attention training block's dqkv_bias up to 3.9e-5), so about
# ten times the largest (the blocks' absolute limit a hundred). An attention
# block rounding its probabilities to bf16 landed just beyond the old 1e-3
# and lands an order of magnitude beyond these: the kernel phase plants it
# and must see it fail
F32_TOL = {"fused_attention_block": (1e-4, 1e-4), "fused_mlp_block": (1e-4, 1e-4),
           "attention_train_fwd": 1e-4, "attention_train_bwd": 2e-4, "mlp_train_fwd": 1e-4,
           "mlp_train_bwd": 1e-4, "sliding_attention_block": 1e-4, "sliding_train_fwd": 1e-4,
           "sliding_train_bwd": 1e-4, "bigbird_attention_block": 1e-4, "bigbird_train_fwd": 1e-4,
           "bigbird_train_bwd": 1e-4, "fused_ponet_mixer_block": 1e-4}
MIN_ARGMAX_AGREEMENT = 0.99
DROPOUT = 0.1  # the encoder's attention_dropout, configs.py
KEEP_FRACTION_TOL = 1e-3
TRAIN_STEPS = 3  # optimizer steps of the training main path
LOSS_RTOL, MIN_GRAD_COSINE = 1e-2, 0.99
# the card's peaks (NVIDIA H100 SXM data sheet): dense bf16 and int8 tensor
# cores, float32 on the CUDA cores, HBM bandwidth; and float32 products as
# 3xTF32 takes them on the TF32 tensor cores (495 TFLOP/s dense), three TF32
# products each (kernel 9's float32 tile, csrc/tf32x3_gemm.cuh)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
# The W8A8 blocks against their plain versions on valid rows: the same
# integer products and float32 epilogues, rounded where the TPU kernel
# rounds, so in float32 an output agrees to float32 rounding (1e-5 (1 +
# |ref|)) but where a float32 sum of another order moved a value across an
# int8 rounding boundary: one step (1/127 of its row's or head group's
# absmax) then moves the outputs of its row. In bfloat16 both round the
# output (2^-7 |ref|), and the kernel's online softmax rounds the
# probabilities to bf16 against a running max, the plain version against
# the row's: ctx then rounds otherwise now and then, and each ctx value that
# takes another int8 step moves its row's outputs by about 1e-3, so 2e-3
# absolute. At most W8A8_SHARE of the outputs may be off by more, each by at
# most W8A8_STEP beyond rounding (tests/test_torch_kernels.py). A block that
# ignores heads_per_block, rounds the MLP intermediate to bf16 before
# quantising it, or does not quantise moves far more of them: the phase
# plants each of these once and fails if the check lets one through.
W8A8_CLOSE = {"float32": (1e-5, 1e-5), "bfloat16": (2e-3, 2**-7)}  # (atol, rtol)
W8A8_STEP = 2e-2
W8A8_SHARE = {"float32": 0.01, "bfloat16": 0.002}
# the matmul kernels' output: the same float32 value up to the last bits
# (the tanh GELU of two libraries), so one bf16 step (at most 2^-7 of it)
MATMUL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2**-7)}
# kernel 6 takes the exponent in bfloat16, its plain version (JAX's
# reference) in float32: 2^-9 relative per probability
SNLD_TOL = {"float32": (1e-2, 2e-2), "bfloat16": (5e-2, 2e-2)}
# kernel 6 against its own rounding model (blhd_attention.py
# snld_attention_plain: the online softmax over key tiles of 64, every
# rounding of the kernel), (relative to max |ctx|, absolute) per dtype: the
# float32 sums run in another order, so in bf16 the outputs differ by at
# most one bf16 step of the largest (2^-7 of max |ctx|), plus 1e-4 for an
# exponent whose bf16 rounding another sum order flipped
# (tests/test_torch_kernels.py); in float32 by float32 rounding, held to
# F32_TOL's 1e-4 of kernel 1 (a core on TF32 or bf16 products lands beyond
# it). Each of CORE_FAULTS, planted in the model (blhd_attention.py
# core_alpha, core_allowed), must fail it.
CORE_GATE = {"bfloat16": (2**-7, 1e-4), "float32": (1e-4, 1e-4)}
# Kernel 6 takes its exponent in bf16 whatever its element type. In float32
# its core now sums 3xTF32 products on the tensor cores, in another order
# than the model's float32 products (the CUDA-core core's sums had matched
# them bit for bit: 1.13e-6 against 2.31e-4, PERF.md), so s - m moves by
# float32 rounding and the bf16 rounding of some s - m flips, as it does in
# bf16; a flip moves a context by up to about one bf16 step of its
# exponent's share, and one reading on the H100 (the card tests, PERF.md)
# was 4.4e-3 against CORE_GATE["float32"]'s 5.7e-4. Its float32 gate is
# then the bf16 exponent's: CORE_GATE["bfloat16"] element by element, and
# in norm, ||err|| <= 2e-4 ||ref|| (ROWS_TOL["bfloat16"]'s norm part, the
# bf16-exponent rows kernels'), which such rare flips hardly move (1.6e-5
# to 5.0e-5 on the CPU for the same TF32 terms summed in float64 instead)
# and plain TF32 core products (F32_CORE_FAULT: 1.25e-3 to 1.38e-3) and
# CORE_FAULTS fail: SNLD_F32_GATE = ((rel, atol), norm).
SNLD_F32_GATE = ((2**-7, 1e-4), 2e-4)
CORE_FAULTS = ("rescale alpha not applied", "packed-segment mask reduced to the padding mask")
# the stack runs the device code of kernels 1 and 2 on the same tiles: it
# must equal their chain bit for bit. Against the plain loop of layers:
# max |err| / max |ref| over 12 layers, per (mode, dtype): the kernels' bf16
# roundings of q, k, v, p, ctx and the intermediate where the plain loop
# stays in float32 (bf16), and int8 steps that those move, each spreading
# over its row in the next layers (W8A8). float32: the products on the
# 3xTF32 tile, whose truncating float32 sums read 1.5e-5 of max |ref| in one
# MLP block and 4.2e-5 over the 12 layers on the H100, beyond the 1e-5 that
# sums in another order had (PERF.md, section 6): the stack is held to the
# 1e-4 each link of its chain is held to (F32_TOL), and in float32 also to
# F32_FWD_TOL's norm part on the 3xTF32 model, which plain TF32 products
# planted in every layer must fail
STACK_TOL = {("W8A8", "bfloat16"): 5e-2, ("float", "bfloat16"): 2e-2,
             ("float", "float32"): 1e-4}
# the serving configuration (bench.py make_model): W8A8 projections, softmax
# in the compute type, attention_impl "auto"; served at bench.py's default
# batch of 128 and at the stack kernel's batch of 32
SERVE_BATCHES = (32, 128)
# name: (source, TPU kernel it replaces)
KERNELS = {
    "fused_attention_block": (
        "spokennlp_tpu_torch/csrc/attention_block.cu",
        "spokennlp_tpu/ops/pallas/attention_block.py:360",
    ),
    "fused_mlp_block": (
        "spokennlp_tpu_torch/csrc/mlp_block.cu",
        "spokennlp_tpu/ops/pallas/mlp_block.py:119",
    ),
    "attention_train_fwd": (
        "spokennlp_tpu_torch/csrc/train_attention.cu",
        "spokennlp_tpu/ops/pallas/train_blocks.py:353",
    ),
    "attention_train_bwd": (
        "spokennlp_tpu_torch/csrc/train_attention.cu",
        "spokennlp_tpu/ops/pallas/train_blocks.py:402",
    ),
    "mlp_train_fwd": (
        "spokennlp_tpu_torch/csrc/train_mlp.cu",
        "spokennlp_tpu/ops/pallas/train_blocks.py:607",
    ),
    "mlp_train_bwd": (
        "spokennlp_tpu_torch/csrc/train_mlp.cu",
        "spokennlp_tpu/ops/pallas/train_blocks.py:651",
    ),
    "sliding_attention_block": (
        "spokennlp_tpu_torch/csrc/sliding_block.cu",
        "spokennlp_tpu/ops/pallas/sliding_block.py:309",
    ),
    "sliding_train_fwd": (
        "spokennlp_tpu_torch/csrc/train_sliding.cu",
        "spokennlp_tpu/ops/pallas/train_sliding.py:721",
    ),
    "sliding_train_bwd": (
        "spokennlp_tpu_torch/csrc/train_sliding.cu",
        "spokennlp_tpu/ops/pallas/train_sliding.py:778",
    ),
    "fused_attention_block_w8a8": (
        "spokennlp_tpu_torch/csrc/attention_block.cu",
        "spokennlp_tpu/ops/pallas/attention_block.py:360",
    ),
    "fused_mlp_block_w8a8": (
        "spokennlp_tpu_torch/csrc/mlp_block.cu",
        "spokennlp_tpu/ops/pallas/mlp_block.py:119",
    ),
    "fused_encoder_stack": (
        "spokennlp_tpu_torch/csrc/stack_block.cu",
        "spokennlp_tpu/ops/pallas/stack_block.py:221",
    ),
    "w8a8_matmul_bf16in": (
        "spokennlp_tpu_torch/csrc/int8_matmul.cu",
        "spokennlp_tpu/ops/pallas/int8_matmul.py:166",
    ),
    "w8a8_matmul": (
        "spokennlp_tpu_torch/csrc/int8_matmul.cu",
        "spokennlp_tpu/ops/pallas/int8_matmul.py:75",
    ),
    "snld_self_attention": (
        "spokennlp_tpu_torch/csrc/blhd_attention.cu",
        "spokennlp_tpu/ops/pallas/blhd_attention.py:70",
    ),
    "bigbird_attention_block": (
        "spokennlp_tpu_torch/csrc/bigbird_block.cu",
        "spokennlp_tpu/ops/pallas/bigbird_block_kernel.py:261",
    ),
    "bigbird_train_fwd": (
        "spokennlp_tpu_torch/csrc/train_bigbird.cu",
        "spokennlp_tpu/ops/pallas/train_bigbird.py:714",
    ),
    "bigbird_train_bwd": (
        "spokennlp_tpu_torch/csrc/train_bigbird.cu",
        "spokennlp_tpu/ops/pallas/train_bigbird.py:774",
    ),
    "fused_ponet_mixer_block": (
        "spokennlp_tpu_torch/csrc/ponet_block.cu",
        "spokennlp_tpu/ops/pallas/ponet_block.py:325",
    ),
    "fused_ponet_mixer_block_w8a8": (
        "spokennlp_tpu_torch/csrc/ponet_block.cu",
        "spokennlp_tpu/ops/pallas/ponet_block.py:325",
    ),
    "sliding_attention_block_w8a8": (
        "spokennlp_tpu_torch/csrc/sliding_block.cu",
        "spokennlp_tpu/ops/pallas/sliding_block.py:309",
    ),
    "bigbird_attention_block_w8a8": (
        "spokennlp_tpu_torch/csrc/bigbird_block.cu",
        "spokennlp_tpu/ops/pallas/bigbird_block_kernel.py:261",
    ),
    # the last two modes lie on no model path (JAX sets them nowhere): held
    # at the kernel level only, with no launches on a main path
    "fused_attention_block_core_int8": (
        "spokennlp_tpu_torch/csrc/attention_block.cu",
        "spokennlp_tpu/ops/pallas/attention_block.py:360",
    ),
    "fused_mlp_block_static_h": (
        "spokennlp_tpu_torch/csrc/mlp_block.cu",
        "spokennlp_tpu/ops/pallas/mlp_block.py:119",
    ),
}
# the Longformer slice: the reference's flagship recipe (scripts/run_finetune.sh:
# window 512, 2048 tokens, training batch 2 x 4 accumulation steps), served in
# batches of 8 windows (the dense path's 16,384 tokens a batch)
LF_B, LF_L, LF_WINDOW, LF_MAX_GLOBALS = 8, 2048, 512, 16
LF_TRAIN_B, LF_ACCUM, LF_STEPS = 2, 4, 2
LF_LONG_TOKENS, LF_MIN_LONG_SHARE = 1536, 0.5
# the BigBird slice: BigBird-base (EncoderConfig's pattern: blocks of 64, 2
# global and 3 random blocks, seed 0) served over its full 4096-token context
# in batches of 4 (16,384 tokens a batch) and trained at 2048 tokens with the
# Longformer recipe's flags; the training kernels' phase at B=8, the windows
# of one optimizer step of the recipe (2 x 4)
BB_B, BB_L, BB_TRAIN_B, BB_TRAIN_L = 4, 4096, 8, 2048
BB_BLOCK, BB_GLOBAL, BB_RANDOM, BB_SEED = 64, 2, 3, 0
BB_LONG_TOKENS = 3072
# the W8A8 long-context slice: JAX's on-chip parity gate (tests/
# test_tpu_kernel_parity.py _assert_parity) and the engine calls per path
PARITY_ARGMAX, PARITY_MEAN_DLOGIT = 0.999, 0.1
RUNS_PER_PATH = 3
# the MUG slice: PoNet-base (BERT-base widths, local window 3, single-head
# GA, max_position_embeddings 4096, float32 as run_mug computes) over its
# recipe's 4096 tokens; kernel 9's phase at B=8, run_mug at its default
# batch of 4 for training and prediction
PN_B, PN_L, PN_WINDOW, PN_BATCH = 8, 4096, 3, 4
PN_LONG_TOKENS, PN_MIN_WINDOWS = 3072, 16


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def segments(device):
    """(B, L) segment ids: every row has a padded tail, odd rows hold two
    packed windows."""
    import torch

    seg = torch.zeros((B, L), dtype=torch.int32)
    for b in range(B):
        n = L - (37 * b) % 300
        seg[b, :n] = 1
        if b % 2:
            seg[b, n // 2 : n] = 2
    return seg.to(device)


def time_ms(fn, reps=10) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(kernel, plain, reps=10) -> dict:
    """Kernel and plain in turns (kernel, plain, plain, kernel) after a warm-up."""
    kernel(), plain()
    k1, p1, p2, k2 = (time_ms(kernel, reps), time_ms(plain, reps), time_ms(plain, reps),
                      time_ms(kernel, reps))
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}


def reset_peak():
    """Start a peak-memory window on the card (nothing on the CPU), after
    freeing what earlier phases left in reference cycles, so the peak is the
    phase's own."""
    import gc

    import torch

    if torch.cuda.is_available():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(f"memory in use at the start of the window: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


# launches of the kernel modes that their wrappers count apart from their
# other launches, summed over every main path's run (read_counts): the
# kernels line's numbers for those modes, which no model path sets
MODE_LAUNCHES = {"fused_attention_block_core_int8": 0, "fused_mlp_block_static_h": 0}


def mode_counters() -> dict:
    """{kernels-line name: (wrapper, its counter)} of the modes in
    MODE_LAUNCHES."""
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block

    return {"fused_attention_block_core_int8": (fused_attention_block, "core_int8_launches"),
            "fused_mlp_block_static_h": (fused_mlp_block, "static_h_launches")}


def reset_counts(wrappers: dict):
    """Set the launch counts of ``wrappers`` ({name: wrapper}) and of the
    modes in MODE_LAUNCHES to 0, just before a main path's run."""
    for w in wrappers.values():
        w.launches = 0
    for w, counter in mode_counters().values():
        setattr(w, counter, 0)


def read_counts(wrappers: dict) -> dict:
    """{name: launches} of ``wrappers`` just after a main path's run; adds
    the modes' counts to MODE_LAUNCHES and fails if one of them ran, since
    no model configuration sets it."""
    for name, (w, counter) in mode_counters().items():
        n = getattr(w, counter)
        MODE_LAUNCHES[name] += n
        if n:
            fail(f"{name} ran {n} times on a main path: no model configuration sets that mode")
    return {name: w.launches for name, w in wrappers.items()}


def peak_gib() -> float:
    """The card's peak allocation since reset_peak() in GiB; nan on the CPU."""
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if torch.cuda.is_available() else float("nan")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, n_bytes: int, dtype: str = "bfloat16") -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes (each input read once, each
    output written once) over the memory rate. ``flops`` is a number of
    ``dtype`` operations, or {type: operations} for work of several types."""
    ops = flops if isinstance(flops, dict) else {dtype: flops}
    t_ops = sum(n / PEAK_FLOPS[t] for t, n in ops.items()) * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}


def core_type(dtype: str) -> str:
    """The peak rate an attention core's operations take in ``dtype``: bf16
    on the tensor cores, float32 as 3xTF32."""
    return "tf32x3" if dtype == "float32" else dtype


def split_bound(rest, moved, n_bytes: int, dtype: str) -> dict:
    """bound() of a kernel that does ``moved`` operations in the products it
    takes the GEMM tile for (in float32 the 3xTF32 tile: every product of
    the forwards, the backwards' recomputed ones, those with a weight read
    transposed and the weight gradients) and ``rest`` in its attention
    cores: in float32 all of it at the 3xTF32 rate (every float32 attention
    core runs 3xTF32 but global_kv_grad, a small share priced the same),
    with the bound of all of it on the CUDA cores beside
    (``simt_bound_ms``); in bf16 all of it on the tensor cores."""
    if dtype != "float32":
        return bound(rest + moved, n_bytes, dtype)
    return {**bound(rest + moved, n_bytes, "tf32x3"),
            "simt_bound_ms": bound(rest + moved, n_bytes, dtype)["bound_ms"]}


def w8a8_check(got, want, dtype) -> dict:
    """A W8A8 block's output against its plain version (valid rows): the
    share of outputs off by more than rounding (W8A8_CLOSE), the largest
    |err|, and whether the share is within W8A8_SHARE and every |err| within
    W8A8_STEP beyond rounding."""
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    atol, rtol = W8A8_CLOSE[dtype]
    share = (err > atol + rtol * ref).float().mean().item()
    beyond = (err - rtol * ref).max().item()
    return {"share": share, "max_abs_err": err.max().item(),
            "ok": share <= W8A8_SHARE[dtype] and beyond <= W8A8_STEP}


def check_planted(planted: dict, dtype: str, reported=()):
    """Each planted fault {what: (got, want, rows)} must fail w8a8_check;
    those in ``reported`` are printed with their reading, not gated."""
    for what, (got, want, rows) in planted.items():
        c = w8a8_check(got[rows], want[rows], dtype)
        gated = what not in reported
        print(f"  planted fault, {what} ({dtype}): {c['share']:.2e} of the outputs beyond "
              f"rounding, max |err| {c['max_abs_err']:.3e}: "
              + ("PASSES the check" if c["ok"] else "rejected")
              + ("" if gated else " (reported, not gated)"))
        if c["ok"] and gated:
            fail(f"the W8A8 check lets a planted fault through: {what} ({dtype})")


def limit(kernel: str, dtype: str):
    """The largest deviation allowed between a kernel and its plain version:
    (atol, rtol) for the blocks of ``compare``, a share of the largest
    output for ``_normalized_errors``."""
    if dtype == "float32":
        return F32_TOL[kernel]
    return BF16_TOL[kernel] if kernel in BF16_TOL else TRAIN_TOL[dtype]


def beyond_limit(got, want, tol) -> float:
    """max(|got - want| - rtol |want|) - atol for tol = (atol, rtol): above 0
    where ``got`` fails the limit."""
    atol, rtol = tol
    return ((got.float() - want.float()).abs() - rtol * want.float().abs()).max().item() - atol


# The bf16 limit's planted faults: the plain version's float products
# (float_product, ops/cuda/int8_matmul.py) with the float32 sum rounded to
# bf16 after every 32-deep k-stage (the tile's stage depth), or without the
# last 16-deep k-step (one mma.sync k-step)
BF16_GEMM_FAULTS = ("partial sums rounded to bf16 every k-stage", "last k-step dropped")


def bf16_stage_sums(real, x, w, depth=32):
    import torch

    acc = None
    for k0 in range(0, w.shape[0], depth):
        part = x[..., k0:k0 + depth].float() @ w[k0:k0 + depth].float()
        acc = (part if acc is None else acc + part).to(torch.bfloat16).float()
    return acc


def dropped_k_step(real, x, w, step=16):
    K = w.shape[0]
    keep = K - ((K - 1) % step + 1)
    return real(x[..., :keep], w[:keep])


def bf16_gemm_faults() -> dict:
    """{fault: patches for planted()} of kernels 1 and 2's plain versions:
    every float product of both blocks (the QKV and out projections, W1 and
    W2) takes the fault."""
    from spokennlp_tpu_torch.ops.cuda import attention_block as ab
    from spokennlp_tpu_torch.ops.cuda import mlp_block as mb

    stand_ins = dict(zip(BF16_GEMM_FAULTS, (bf16_stage_sums, dropped_k_step)))
    return {f: [(ab, "float_product", None, s), (mb, "float_product", None, s)]
            for f, s in stand_ins.items()}


def check_bf16_faults(name: str, got, plain, valid):
    """Each of BF16_GEMM_FAULTS planted in ``plain`` (a call of kernel
    ``name``'s plain version) must put ``got``, the kernel's output, beyond
    its bf16 limit on the valid rows."""
    for fault, patches in bf16_gemm_faults().items():
        with planted(patches):
            bad = plain()
        excess = beyond_limit(got[valid], bad[valid], BF16_TOL[name])
        print(f"  planted fault, {name} with {fault} (bf16): beyond the limit by {excess:.3e}: "
              + ("rejected" if excess > 0 else "ACCEPTED"))
        if excess <= 0:
            fail(f"the bf16 limit of {name} accepts a plain version with {fault}")


# Kernel 1 in bf16 against its own rounding model (blhd_attention.py
# attention_block_model: the projections with float32 sums rounded where
# the kernel rounds them, the core's rounding model, the out projection
# with its residual LayerNorm), on valid rows: |err| <= atol + 2^-7 |ref|.
# Both sides round the same values at the same places, so they differ where
# a float32 sum of another order moved a bf16 rounding of q, k, v, an
# exponent or ctx, and by the output's own rounding (2^-7 |ref|). atol from
# the H100 readings of max(|err| - 2^-7 |ref|) over this script's shapes and
# every bf16 shape of the card tests (PERF.md, section 6: at most 1.62e-3,
# over 63-65 keys; 7.7e-4 at the main path's shapes), where BF16_GEMM_FAULTS
# planted in the model read 1.3e-2 and 0.26: atol sits 2.5 x above the one
# and 3 x below the other. BF16_TOL against the float32 plain version stays
# beside it.
BF16_MODEL_TOL = (4e-3, 2**-7)
# The training backwards' products in bf16 (rows 10-13) against their
# explicit plain backwards (ops/cuda/train_blocks.py backward_product and
# the *_bwd_plain functions), element by element: |err| <= share max |ref| +
# 2^-7 |ref| for each product's output. Kernel 11 from its inputs (it is
# products only); rows 10, 12 and 13 from the intermediates the kernel's
# products read (its own ctx and the projections' gradient dproj, which its
# attention core wrote): dctx = g Wo^T, dx = dproj W_all^T, dW_all and db_all,
# dWo and dbo; and the weight gradient alone (train_blocks.weight_grad).
# rtol 2^-7 takes the rounding of dctx and dx to bf16 on both sides; the
# share takes the float32 sums of another order and, in kernel 11, the bf16
# roundings of h and dpre that such a sum moved. Shares from the H100
# readings (PERF.md, section 6) over this script's and the card tests'
# shapes: kernel 11 at most 8.1e-4 (2.4e-4 at the main path's shapes), the
# products on the kernel's own intermediates at most 4.8e-6 (a weight
# gradient summed over 16384 rows in one range), where each of
# BF16_GEMM_FAULTS planted in backward_product reads 4.9e-2 or more.
BWD_GEMM_TOL = {"mlp_train_bwd": 3e-3, "attention_train_bwd": 1e-4, "sliding_train_bwd": 1e-4,
                "bigbird_train_bwd": 1e-4, "weight_grad": 1e-4}


def block_model_check(got, call, valid) -> float:
    """Kernel 1 bf16 (``got``) against its rounding model (``call(fn)`` runs
    the block function ``fn`` on the phase's inputs) within BF16_MODEL_TOL;
    each of BF16_GEMM_FAULTS planted in the model must fail it. Returns the
    reading max(|err| - 2^-7 |ref|)."""
    from spokennlp_tpu_torch.ops.cuda.blhd_attention import attention_block_model

    reading = beyond_limit(got[valid], call(attention_block_model)[valid], (0.0, BF16_MODEL_TOL[1]))
    print(f"  fused_attention_block bfloat16 against its rounding model: max(|err| - 2^-7 |ref|) "
          f"{reading:.3e} (atol {BF16_MODEL_TOL[0]})")
    if reading > BF16_MODEL_TOL[0]:
        fail(f"fused_attention_block bfloat16: {reading:.3e} beyond its rounding model's limit")
    for fault, patches in bf16_gemm_faults().items():
        with planted(patches):
            bad = call(attention_block_model)
        excess = beyond_limit(got[valid], bad[valid], BF16_MODEL_TOL)
        print(f"  planted fault, the block model with {fault}: beyond the limit by {excess:.3e}: "
              + ("rejected" if excess > 0 else "ACCEPTED"))
        if excess <= 0:
            fail(f"the rounding-model limit of fused_attention_block accepts {fault}")
    return reading


def backward_gemm_faults() -> dict:
    """{fault: patches for planted()}: BF16_GEMM_FAULTS in every product of
    the explicit plain backwards (train_blocks.backward_product)."""
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    stand_ins = dict(zip(BF16_GEMM_FAULTS, (bf16_stage_sums, dropped_k_step)))
    return {f: [(tb, "backward_product", None, s)] for f, s in stand_ins.items()}


def backward_gemm_readings(got: dict, want: dict) -> dict:
    """{output: max(|got - want| - 2^-7 |want|) / max |want|}."""
    import torch

    out = {}
    for k, w in want.items():
        g, w = got[k].float().reshape(w.shape), w.float()
        if not torch.isfinite(g).all():
            fail(f"non-finite {k}")
        out[k] = beyond_limit(g, w, (0.0, 2**-7)) / max(w.abs().max().item(), 1e-30)
    return out


def projection_gemms_plain(x, g, bufs: dict, w_all, wo) -> dict:
    """The explicit plain backward's products of rows 10, 12 and 13 on the
    intermediates the kernel's products read (``bufs`` from the backward
    wrapper's ``buffers``): {dctx, dx, dw_all, db_all, dwo, dbo}."""
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    return dict(zip(("dctx", "dx", "dw_all", "db_all", "dwo", "dbo"), (
        tb.out_grad_plain(g, wo),
        *tb.projection_grads_plain(x, g, bufs["ctx"], bufs["dproj"], w_all, wo))))


def check_backward_gemms(name: str, got: dict, plain) -> float:
    """Row ``name``'s bf16 backward products ``got`` against its explicit
    plain backward (``plain()`` -> {output: tensor}) within BWD_GEMM_TOL;
    each of BF16_GEMM_FAULTS planted in backward_product must fail it.
    Returns the largest reading (a share of max |ref|)."""
    tol = BWD_GEMM_TOL[name]
    readings = backward_gemm_readings(got, plain())
    worst = max(readings.values())
    print(f"  {name} bfloat16 products against the explicit plain backward: "
          + ", ".join(f"{k} {v:.2e}" for k, v in readings.items()) + f" (limit {tol:g} max |ref|)")
    if worst > tol:
        fail(f"{name} bfloat16: a backward product {worst:.3e} of max |ref| beyond 2^-7 |ref|, "
             f"limit {tol}")
    for fault, patches in backward_gemm_faults().items():
        with planted(patches):
            bad = backward_gemm_readings(got, plain())
        top = max(bad, key=bad.get)
        print(f"  planted fault, {name}'s plain backward with {fault}: {top} {bad[top]:.2e}: "
              + ("rejected" if bad[top] > tol else "ACCEPTED"))
        if bad[top] <= tol:
            fail(f"the backward-GEMM limit of {name} accepts {fault}")
    return worst


# The float32 backwards' products of rows 10-13 on the 3xTF32 tile
# (csrc/tf32x3_gemm.cuh: dctx = g Wo^T, dx = dproj W_all^T and the weight
# gradients; the MLP's dpre = (g W2^T) act', dx = dpre W1^T, dW1 and dW2)
# against the explicit plain backward in float32, for each output: element
# by element, max |err| <= s max |ref|, and in norm, ||err|| <= r ||ref||,
# F32_BWD_GEMM_TOL = (s, r). Rows 10, 12 and 13 from the intermediates the
# kernel's products read (its ctx and dproj, ``buffers``), row 11 from its
# inputs. s is F32_TOL's 1e-4 of these kernels. The tile reads up to 3.0e-5
# element-wise and 3.2e-5 in norm at a depth of 4608 (row 12's dx, the card
# test's widest product; the tensor cores' float32 sums truncate, so the
# reading grows with the depth), 2.7e-5 / 2.6e-5 at 3072 (row 11's dx), on
# the H100 (PERF.md, section 6). A plain TF32
# product reads 2.2e-4 or more in norm, but where the largest errors of a sum
# cancel its element-wise reading fell to 5.8e-5, inside s (row 10's dx on
# the CPU test's inputs): so the norm part, which averages over every
# output, sits between the two at r = 8e-5, and the plain-TF32 fault
# (int8_matmul.tf32x3_product(..., terms=1) in train_blocks.backward_product)
# must fail the gate in every output it reaches (the bias gradients of dY
# itself are column sums, which no product reaches).
F32_BWD_GEMM_TOL = (1e-4, 8e-5)
F32_GEMM_FAULT = "plain TF32 products"


def f32_gemm_readings(got: dict, want: dict) -> dict:
    """{output: (max |got - want| / max |want|, ||got - want|| / ||want||)}."""
    import torch

    out = {}
    for k, w in want.items():
        g, w = got[k].float().reshape(w.shape), w.float()
        if not torch.isfinite(g).all():
            fail(f"non-finite {k}")
        err = g - w
        out[k] = (err.abs().max().item() / max(w.abs().max().item(), 1e-30),
                  err.norm().item() / max(w.norm().item(), 1e-30))
    return out


def f32_gemm_excess(reading, tol=None) -> float:
    """The larger of a reading's two parts over their limits: above 1 where
    it fails ``tol`` (F32_BWD_GEMM_TOL by default)."""
    return max(r / t for r, t in zip(reading, tol or F32_BWD_GEMM_TOL))


def plain_tf32_products():
    """planted() patches: every product of the explicit plain backwards in
    plain TF32 (big . big alone, plain_tf32)."""
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    return [(tb, "backward_product", None, plain_tf32)]


def check_f32_backward_gemms(name: str, got: dict, plain) -> dict:
    """Row ``name``'s float32 backward products ``got`` against its explicit
    plain backward (``plain()`` -> {output: tensor}) within F32_BWD_GEMM_TOL;
    F32_GEMM_FAULT planted in backward_product must fail it in every output
    it moves. Returns {"reading", "norm_reading": the largest of each part,
    "fault_excess": the fault's smallest excess (f32_gemm_excess) over those
    outputs}."""
    import torch

    want = plain()
    readings = f32_gemm_readings(got, want)
    fmt = lambda r: ", ".join(f"{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in r.items())
    print(f"  {name} float32 products against the explicit plain backward (max, norm): "
          + fmt(readings) + f" (limits {F32_BWD_GEMM_TOL})")
    worst = max(readings, key=lambda k: f32_gemm_excess(readings[k]))
    if f32_gemm_excess(readings[worst]) > 1:
        fail(f"{name} float32: {worst} reads {readings[worst]}, beyond its limit "
             f"{F32_BWD_GEMM_TOL}")
    with planted(plain_tf32_products()):
        bad_plain = plain()
    reached = [k for k in want if not torch.equal(bad_plain[k], want[k])]
    bad = f32_gemm_readings(got, {k: bad_plain[k] for k in reached})
    print(f"  planted fault, {name}'s plain backward with {F32_GEMM_FAULT}: " + fmt(bad)
          + f"; not reached: {[k for k in want if k not in reached]}")
    passed = [k for k in reached if f32_gemm_excess(bad[k]) <= 1]
    if passed or not reached:
        fail(f"the float32 backward-GEMM limit of {name} accepts {F32_GEMM_FAULT} in {passed}")
    return {"reading": max(r[0] for r in readings.values()),
            "norm_reading": max(r[1] for r in readings.values()),
            "fault_excess": min(f32_gemm_excess(r) for r in bad.values())}


# The float32 forwards' products on the 3xTF32 tile (csrc/tf32x3_gemm.cuh
# through bf16_gemm.cuh: kernels 1-3, 7, 8 and rows 10-13's forwards, whose
# backwards recompute the same products on the same kernels) against their
# plain versions with every float product through the tile's rounding model
# (int8_matmul.tf32x3_product: each operand split into two TF32 parts, three
# products summed exactly in float32), for each output: max |err| <= s max
# |ref| and ||err|| <= r ||ref||, F32_FWD_TOL = (s, r). s is F32_TOL's 1e-4.
# The model leaves out the tensor cores' truncating float32 sums, which read
# up to 3.2e-5 of a product in norm at a depth of 4608 (F32_BWD_GEMM_TOL's
# readings), where a plain TF32 product reads 2.2e-4 or more: so r = 8e-5,
# as for the backwards' products. Where the products are a small share of an
# output (the attention blocks' LayerNorm output, which the residual
# dominates: ctx Wo is about 0.07 of x there), neither reading shows, so
# kernels 1, 7 and 8 are held on their out projection alone too (no
# residual, no LayerNorm: ctx Wo + bo, the training forwards' output).
# Plain TF32 (F32_GEMM_FAULT: tf32x3_product(..., terms=1)) planted in every
# float product of the plain version must fail the gate in at least one
# output of each kernel.
F32_FWD_TOL = (1e-4, 8e-5)


def float_products(stand_in):
    """planted() patches: every float product of the float modes' plain
    versions (each module's float_product: the attention and MLP blocks, so
    the stack's loop of layers, the Longformer, BigBird and PoNet blocks and
    the training forwards) sent to stand_in(the real function, x, w)."""
    from spokennlp_tpu_torch.ops.cuda import (
        attention_block, bigbird_block, mlp_block, ponet_block, sliding_block, train_bigbird,
        train_blocks, train_sliding,
    )

    return [(m, "float_product", None, stand_in)
            for m in (attention_block, bigbird_block, mlp_block, ponet_block, sliding_block,
                      train_bigbird, train_blocks, train_sliding)]


_PRODUCT_FN = []


def model_product(a, b, terms: int = 3):
    """a . b through int8_matmul.tf32x3_product (``terms`` 3: the 3xTF32
    model, 1: plain TF32), differentiable: its backward takes the two
    gradient products the same way, so autograd of a plain version with a
    product planted reads that product's model in its backward too."""
    if not _PRODUCT_FN:
        import torch

        from spokennlp_tpu_torch.ops.cuda.int8_matmul import tf32x3_product

        class Product(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, y, n):
                ctx.save_for_backward(x, y)
                ctx.n = n
                return tf32x3_product(x, y, n)

            @staticmethod
            def backward(ctx, g):
                x, y = ctx.saved_tensors
                return (tf32x3_product(g, y.transpose(-1, -2), ctx.n),
                        tf32x3_product(x.transpose(-1, -2), g, ctx.n), None)

        _PRODUCT_FN.append(Product)
    return _PRODUCT_FN[0].apply(a, b, terms)


def tf32x3_model(real, a, b):
    """A planted() stand-in: the product a . b as the 3xTF32 tile takes it."""
    return model_product(a, b)


def plain_tf32(real, a, b):
    """A planted() stand-in: the product a . b in plain TF32 (F32_GEMM_FAULT)."""
    return model_product(a, b, terms=1)


# The float32 dense attention cores on the tensor cores (attention_core.cuh's
# 3xTF32 core: kernels 1, 1 W8A8's float32 mode, 1b, 3 and 6; row 10's
# attn_rows, attn_dkv and attn_dq on the float32 bodies of
# attention_rows_mma.cuh and attention_grad_mma.cuh) run S, dP, P V, dS k,
# dS^T q and p_eff^T dctx as 3xTF32. Their plain versions and rounding
# models take those products through attention_models.core_product: on the
# 3xTF32 model (core_products(tf32x3_model)) they are what the kernels'
# gates read against, and plain TF32 there (F32_CORE_FAULT) must fail every
# float32 gate of a kernel with a dense core: CORE_GATE (the core alone,
# kernel 6), F32_FWD_TOL (kernel 1, the stack, row 10's forward), F32_TOL
# (row 10's output and gradients against autograd of its plain version)
# and the dproj reading below. Row 10's float32 gradient kernels against
# attention_core_bwd_model on the 3xTF32 model, dense over a sequence's keys
# with float32 sums: element by element max |err| <= s max |ref| and in
# norm ||err|| <= r ||ref|| in each slot of dproj, F32_BWD_CORE_TOL = (s,
# r), as F32_FWD_TOL reads: on the CPU (B=4, L=512, 12 heads of 64,
# dropout 0.1) the 3xTF32 model reads 1.1e-7 / 5.9e-7 against exact float32
# products, plain TF32 2.5e-4 to 3.5e-4 / 4.2e-4 to 5.1e-4; the kernel
# differs from its model only in the order of its float32 sums.
F32_CORE_FAULT = "plain TF32 core products"
F32_BWD_CORE_TOL = (1e-4, 8e-5)


def card_core(real, q, k, v, segment_ids, exp_dtype):
    """A planted() stand-in for attention_block.attention_core_plain: the
    card's own dense core (attention_block.attention_core, the blocks'
    launch) on the same q, k, v (B, L, nh, hd), as float32 (B, L, nh, hd)."""
    import torch

    from spokennlp_tpu_torch.ops.cuda.attention_block import attention_core

    B, L, nh, hd = q.shape
    qkv = torch.stack([q, k, v]).transpose(2, 3).contiguous()
    return attention_core(qkv, segment_ids).float().reshape(B, L, nh, hd)


# The W8A8 attention block's float32 mode row-quantises the context of the
# float32 core. The 3xTF32 core's context differs from any float32 model of
# it by the tensor cores' truncating sums (about 8e-6 of max |ctx| at the
# main path's shapes, PERF.md), which moves an int8 step of ctx, and with it
# a row of outputs, for about 2.5 % of the outputs (H100, the card tests):
# W8A8_SHARE's 1 % is for the block's own float32 sums. So in float32 the
# W8A8 check reads the block's plain version on the kernel's own core
# (card_core), which CORE_GATE holds to its rounding model at the same
# launch (core_columns).
def on_card_core(dtype: str, fn):
    """fn() with attention_block.attention_core_plain sent to card_core in
    float32; fn() in bf16."""
    from spokennlp_tpu_torch.ops.cuda import attention_block as ab

    if dtype != "float32":
        return fn()
    with planted([(ab, "attention_core_plain", None, card_core)]):
        return fn()


def card_band_rows(real, q, k, v, glob_qkv, n_valid, n_glob, *, window, G, exp_dtype=None,
                   dropout_rate=0.0, keep=None):
    """A planted() stand-in for sliding_block.sliding_attend at dropout 0:
    the card's own band rows kernel (train_sliding.sliding_rows) on the same
    q, k, v (B, L, nh, hd), the global rows from the plain attention (one
    row a sequence; phase 20 holds the global rows kernel alone to its
    model), as float32 (B, L, nh, hd)."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    ctx = real(q, k, v, glob_qkv, n_valid, n_glob, window=window, G=G, exp_dtype=exp_dtype)
    qkv = torch.stack([q, k, v]).transpose(2, 3).contiguous()
    counts = torch.stack([n_valid, n_glob], 1).int().contiguous()
    band = ts.sliding_rows(qkv, counts, None, window=window)[0].float()
    local = torch.arange(q.shape[1], device=q.device)[None] >= n_glob[:, None]
    return torch.where(local[..., None, None], band, ctx)


def card_bigbird_rows(real, q, k, v, attention_mask, *, block_size, num_global_blocks,
                      num_random_blocks, seed, exp_dtype=None, dropout_rate=0.0, keep=None):
    """A planted() stand-in for bigbird_block.bigbird_attend at dropout 0:
    the card's own rows kernel (train_bigbird.bigbird_rows, the global rows
    among its tiles) on the same q, k, v (B, L, nh, hd), as float32 (B, L,
    nh, hd)."""
    import torch

    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb

    n_valid = (attention_mask > 0).sum(1)
    counts = torch.stack([n_valid, torch.zeros_like(n_valid)], 1).int().contiguous()
    t = bigbird_tables(q.shape[1] // block_size, num_global_blocks, num_random_blocks, seed,
                       q.device)
    qkv = torch.stack([q, k, v]).transpose(2, 3).contiguous()
    return tbb.bigbird_rows(qkv, counts, None, t, block_size=block_size)[0].float()


# The same for the W8A8 Longformer and BigBird blocks' float32 mode, whose
# ctx comes from the band and BigBird rows kernels on 3xTF32: against the
# plain version's exact float32 attention 3.4 % and 3.8 % of their outputs
# moved an int8 step (H100, B=8, L=2048 and B=4, L=4096; PERF.md, PR 19),
# so in float32 the W8A8 check of kernels 7 and 8 reads the plain version
# on the kernel's own rows (card_band_rows, card_bigbird_rows), which phase
# 20 holds to ROWS_TOL["float32"] in the same instantiation.
def on_card_rows(dtype: str, fn):
    """fn() with sliding_block.sliding_attend and bigbird_block.bigbird_attend
    sent to the card's rows kernels in float32; fn() in bf16."""
    from spokennlp_tpu_torch.ops.cuda import bigbird_block as bbk
    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb

    if dtype != "float32":
        return fn()
    with planted([(sb, "sliding_attend", None, card_band_rows),
                  (bbk, "bigbird_attend", None, card_bigbird_rows)]):
        return fn()


def core_products(stand_in):
    """planted() patches: every product of the attention cores' plain
    versions and rounding models (attention_models.core_product) sent to
    stand_in(the real function, a, b)."""
    from spokennlp_tpu_torch.ops.cuda import attention_models as am

    return [(am, "core_product", None, stand_in)]


def check_f32_forward(name: str, got: dict, plain, tol=F32_FWD_TOL, core: bool = False,
                      gate_core_fault: bool = True) -> dict:
    """Kernel ``name``'s float32 outputs ``got`` ({output: tensor}, real rows
    only) against its plain version (``plain()`` -> the same keys) with every
    float product through tf32x3_model, within ``tol`` (F32_FWD_TOL's max and
    norm parts); plain_tf32 planted in the same products must fail it in at
    least one output. With ``core`` (a kernel with a dense float32 core) the
    core's products are on the model too, and F32_CORE_FAULT, plain TF32 in
    those alone, must fail it as well (printed only, without
    ``gate_core_fault``: the stack, whose core's share of an output the
    residual shrinks layer after layer). Returns {"model_reading",
    "model_norm_reading": the largest of each part, "fault_excess": the
    fault's largest excess (f32_gemm_excess), and with ``core``
    "core_fault_excess"}."""
    import torch

    cores = lambda stand_in: core_products(stand_in) if core else []
    with torch.no_grad():
        with planted(float_products(tf32x3_model) + cores(tf32x3_model)):
            want = plain()
        with planted(float_products(plain_tf32) + cores(plain_tf32)):
            bad = f32_gemm_readings(got, plain())
        if core:
            with planted(float_products(tf32x3_model) + cores(plain_tf32)):
                bad_core = f32_gemm_readings(got, plain())
    readings = f32_gemm_readings(got, want)
    fmt = lambda r: ", ".join(f"{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in r.items())
    print(f"  {name} float32 against its plain version on the 3xTF32 model (max, norm): "
          + fmt(readings) + f" (limits {tol})")
    worst = max(readings, key=lambda k: f32_gemm_excess(readings[k], tol))
    if f32_gemm_excess(readings[worst], tol) > 1:
        fail(f"{name} float32: {worst} reads {readings[worst]} against the 3xTF32 model, beyond "
             f"its limit {tol}")
    out = {"model_reading": max(r[0] for r in readings.values()),
           "model_norm_reading": max(r[1] for r in readings.values())}
    faults = [(F32_GEMM_FAULT, bad, "fault_excess")]
    if core:
        faults.append((F32_CORE_FAULT, bad_core, "core_fault_excess"))
    for fault, reading, key in faults:
        excess = max(f32_gemm_excess(r, tol) for r in reading.values())
        print(f"  planted fault, {name}'s plain version with {fault}: " + fmt(reading) + ": "
              + ("rejected" if excess > 1 else "ACCEPTED")
              + ("" if key == "fault_excess" or gate_core_fault else " (printed, not gated)"))
        if excess <= 1 and (key == "fault_excess" or gate_core_fault):
            fail(f"the float32 forward limit of {name} accepts {fault}")
        out[key] = excess
    return out


def check_f32_backward_cores(name: str, dproj, model, hn: int, label: str = None) -> dict:
    """Row ``name``'s float32 dproj (its gradient kernels' dq, dk, dv, and
    row 12's dqg, dkg, dvg) against its rounding model (``model()`` -> the
    model's dproj) with the core products on the 3xTF32 model, within
    F32_BWD_CORE_TOL; the model with F32_CORE_FAULT, and with its key tile
    dropped (core_bwd_faults), must fail it. ``label`` names the case in the
    report (``name`` by default). Returns {reading, norm_reading, faults:
    {fault: (max, norm)}}."""
    show = lambda rd: ", ".join(f"{k} {e:.2e} / {n:.2e}" for k, (e, n) in rd.items())
    label = label or name
    with planted(core_products(tf32x3_model)):
        readings = core_bwd_readings(dproj, model(), hn, rtol=0.0)
    print(f"  {label} float32 gradient kernels against their rounding model on the 3xTF32 "
          f"model, max / norm: {show(readings)} (limits {F32_BWD_CORE_TOL})")
    if core_bwd_excess(readings, F32_BWD_CORE_TOL) > 1:
        fail(f"{label} float32: dproj beyond its rounding model's limits: {show(readings)}")
    faults = {}
    tile = BWD_CORE_FAULTS[2]
    for fault, patches in ((F32_CORE_FAULT, core_products(plain_tf32)),
                           (tile, core_products(tf32x3_model) + core_bwd_faults(name)[tile])):
        with planted(patches):
            bad = core_bwd_readings(dproj, model(), hn, rtol=0.0)
        worst = (max(e for e, _ in bad.values()), max(n for _, n in bad.values()))
        faults[fault] = worst
        rejected = core_bwd_excess(bad, F32_BWD_CORE_TOL) > 1
        print(f"  planted fault, {label}'s float32 rounding model with {fault}: max "
              f"{worst[0]:.2e}, norm {worst[1]:.2e}: " + ("rejected" if rejected else "ACCEPTED"))
        if not rejected:
            fail(f"the float32 rounding-model limits of {label} accept {fault}")
    return {"reading": max(e for e, _ in readings.values()),
            "norm_reading": max(n for _, n in readings.values()), "faults": faults}


# The bf16 gradient kernels of rows 12 and 13's backwards (band_dq,
# band_dkv and global_kv_grad; bigbird_dq and bigbird_dkv) against their
# rounding models (ops/cuda/train_sliding.py sliding_core_bwd_model,
# train_bigbird.py bigbird_core_bwd_model: dense over a sequence's keys,
# float32 sums, rounded where the kernels round) on the kernels' own q, k, v,
# dctx, row statistics and keep masks (the backward wrapper's ``buffers``),
# in each slot of dproj: element by element, |err| <= s max |ref| + 2^-7
# |ref|, and in norm, ||err|| <= r ||ref||. rtol 2^-7 takes the final
# rounding of dq, dk and dv on both sides. The float32 sums run in another
# order, and now and then one moves s - m across a bf16 rounding boundary,
# which moves that e by one bf16 step of s - m (up to a few per cent of a
# small e): such rare steps set the element-wise readings, the largest of
# 12.6M elements a slot, at most 2.39e-3 on the H100 (this script's
# Longformer phase; 8.1e-4 over the card tests' shapes; PERF.md, section
# 6), so s = 5e-3. A fault that moves every term of a sum by a rounding, dS
# or p_eff left unrounded, reads 6.4e-4 to 2.4e-3 element-wise, inside that
# spread, but 2.5e-3 or more in norm, where the honest readings stay at
# 2.0e-4 or less: r = 1e-3. Each of BWD_CORE_FAULTS, planted in the model,
# must fail the gate (the rounding faults through its norm part).
BWD_CORE_TOL = {"sliding_train_bwd": (5e-3, 1e-3), "bigbird_train_bwd": (5e-3, 1e-3),
                "attention_train_bwd": (5e-3, 1e-3)}
BWD_CORE_FAULTS = ("dS left unrounded", "p_eff unrounded in dv", "a key tile dropped")
DPROJ_SLOTS = ("dq", "dk", "dv", "dqg", "dkg", "dvg")


def core_bwd_faults(name: str) -> dict:
    """{fault: patches for planted()}: BWD_CORE_FAULTS in row ``name``'s
    rounding model: dS or p_eff (for dv) not rounded to bf16; the dense
    model without the second key tile for the second query tile's rows; the
    Longformer model without the band key tile that starts in the second
    query tile's rows, for those rows; the BigBird model without the first
    live random key block's first 64 keys (else a window block's) for its
    query block."""
    from spokennlp_tpu_torch.ops.cuda import attention_models as am
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    unrounded = lambda real, x, dt: x.float()
    faults = {BWD_CORE_FAULTS[0]: [(am, "round_ds", None, unrounded)],
              BWD_CORE_FAULTS[1]: [(am, "round_p_eff", None, unrounded)]}
    if name == "attention_train_bwd":
        def drop(real, L, device):
            allowed = real(L, device).clone()
            allowed[64:128, 64:128] = False
            return allowed
        faults[BWD_CORE_FAULTS[2]] = [(tb, "dense_model_allowed", None, drop)]
    elif name == "sliding_train_bwd":
        def drop(real, L, C, n_valid, n_glob, device):
            allowed = real(L, C, n_valid, n_glob, device).clone()
            q0 = 64
            k0 = q0 - C + 64 * -(-C // 64)  # band tile ceil(C / 64) of query tile 1
            allowed[q0:q0 + 64, k0:k0 + 64] = False
            return allowed
        faults[BWD_CORE_FAULTS[2]] = [(ts, "sliding_model_allowed", None, drop)]
    else:
        def drop(real, L, C, G, R, rand, rok):
            reg = real(L, C, G, R, rand, rok).copy()
            live = [(i, int(rand[i, r])) for i in range(G, L // C) for r in range(R) if rok[i, r]]
            i, j = live[0] if live else (G, G)
            reg[i * C:(i + 1) * C, j * C:j * C + 64] = 0
            return reg
        faults[BWD_CORE_FAULTS[2]] = [(tbb, "bigbird_model_regions", None, drop)]
    return faults


def core_bwd_readings(got, want, hn: int, rtol: float = 2**-7) -> dict:
    """{slot of dproj: (max(|got - want| - rtol |want|) / max |want|,
    ||got - want|| / ||want||)}: rtol 2^-7 takes the bf16 rounding of dq,
    dk and dv on both sides, 0 reads a float32 dproj."""
    import torch

    out = {}
    for i in range(want.shape[1] // hn):
        g, w = got[:, i * hn:(i + 1) * hn].float(), want[:, i * hn:(i + 1) * hn].float()
        if not torch.isfinite(g).all():
            fail(f"non-finite {DPROJ_SLOTS[i]}")
        out[DPROJ_SLOTS[i]] = (beyond_limit(g, w, (0.0, rtol)) / max(w.abs().max().item(), 1e-30),
                               ((g - w).norm() / w.norm().clamp_min(1e-30)).item())
    return out


def core_bwd_excess(readings: dict, tol) -> float:
    """The largest reading over its limit, (s, r) = tol: above 1 fails."""
    s, r = tol
    return max(max(e / s, n / r) for e, n in readings.values())


def check_backward_cores(name: str, dproj, model, hn: int) -> dict:
    """Row ``name``'s bf16 dproj against its rounding model (``model()`` ->
    the model's dproj) within BWD_CORE_TOL; each of BWD_CORE_FAULTS planted
    in the model must fail it. Returns {reading, norm_reading, faults: {fault:
    (element-wise, norm)}}."""
    tol = BWD_CORE_TOL[name]
    show = lambda rd: ", ".join(f"{k} {e:.2e} / {n:.2e}" for k, (e, n) in rd.items())
    readings = core_bwd_readings(dproj, model(), hn)
    print(f"  {name} bfloat16 gradient kernels against their rounding model, element-wise / "
          f"norm: {show(readings)} (limits {tol[0]:g} max |ref|, {tol[1]:g} ||ref||)")
    if core_bwd_excess(readings, tol) > 1:
        fail(f"{name} bfloat16: dproj beyond its rounding model's limits: {show(readings)}")
    faults = {}
    for fault, patches in core_bwd_faults(name).items():
        with planted(patches):
            bad = core_bwd_readings(dproj, model(), hn)
        worst = (max(e for e, _ in bad.values()), max(n for _, n in bad.values()))
        faults[fault] = worst
        inside = worst[0] <= tol[0]
        print(f"  planted fault, {name}'s rounding model with {fault}: element-wise "
              f"{worst[0]:.2e}, norm {worst[1]:.2e}: "
              + ("rejected" if core_bwd_excess(bad, tol) > 1 else "ACCEPTED")
              + (" (inside the element-wise limit: the norm limit rejects it)"
                 if inside and worst[1] > tol[1] else ""))
        if core_bwd_excess(bad, tol) <= 1:
            fail(f"the rounding-model limits of {name} accept {fault}")
    return {"reading": max(e for e, _ in readings.values()),
            "norm_reading": max(n for _, n in readings.values()), "faults": faults}


# The rows kernels (band_rows_kernel, bigbird_rows_kernel), launched alone
# (train_sliding.sliding_rows, train_bigbird.bigbird_rows) on their own q, k,
# v at the main paths' shapes, against their rounding models
# (sliding_rows_model, bigbird_rows_model: dense over a row's keys, float32
# sums, e rounded against the row's true maximum): ctx and, in the
# statistics pass, (m, D, rowsum(dp p_eff)), each read element-wise,
# max(|got - want| - rtol |want|) / max |want| (rtol 2^-7 for a bf16 ctx,
# which both round; 0 for a float32 one and the statistics), and in norm,
# ||got - want|| / ||want||, within ROWS_TOL[ctx's dtype] = (s, r) as
# BWD_CORE_TOL is read: the products' float32 sums run in another order,
# which now and then moves a rounding of s - m or of a bf16 ctx by one bf16
# step. On the H100 (PERF.md, section 6; the card tests -k rows_kernel and
# this script's phase 20) the honest readings reach 6.3e-4 element-wise
# and, in norm, 9.9e-5 with a bf16 ctx (ctx and the statistics) and 2.9e-5
# with a float32 one (the W8A8 mode, which takes no rounding of its own).
# The faults that move every e by a rounding read 3.9e-4 (a running
# maximum, float32 ctx) to 1.7e-3 in norm, inside the element-wise part:
# so r = 2e-4 (bf16) and 1e-4 (float32), about three times from either
# side, and s = 5e-3 as BWD_CORE_TOL's. Each of ROWS_FAULTS, planted in the
# model, must fail it in every mode.
ROWS_TOL = {"bfloat16": (5e-3, 2e-4), "float32": (5e-3, 1e-4)}
ROWS_FAULTS = ("probabilities left unrounded", "a key tile dropped",
               "a running maximum in place of the row's")
ROWS_STATS = ("m", "D", "rs")


def running_max_softmax(real, s, allowed, dt):
    """A planted fault of the rows kernels' model: e rounded against the
    running maximum over key tiles of 64 (an online softmax's), then scaled
    to the row's maximum, in place of ``attention_models.rows_softmax``."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import attention_models as am

    ninf = torch.tensor(-torch.inf, device=s.device)
    safe = lambda m: torch.where(torch.isfinite(m), m, 0.0)
    m = torch.where(allowed, s, ninf).amax(-1)
    run = torch.full_like(m, -torch.inf)
    e = torch.zeros_like(s)
    for k0 in range(0, s.shape[-1], 64):
        sl, ok = s[..., k0:k0 + 64], allowed[..., k0:k0 + 64]
        run = torch.maximum(run, torch.where(ok, sl, ninf).amax(-1))
        scale = torch.exp(safe(run) - safe(m))[..., None]
        e[..., k0:k0 + 64] = torch.where(ok, am.rows_exponent(sl, safe(run)[..., None], dt) * scale,
                                         0.0)
    return m, e


def rows_faults(name: str) -> dict:
    """{fault: patches for planted()}: ROWS_FAULTS in the rounding model of
    ``name`` (band_rows, bigbird_rows, attn_rows or global_rows): e not
    rounded; a key tile dropped (core_bwd_faults' tile of the same row; for
    the global rows keys 64-127 of every global row); running_max_softmax."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import attention_models as am
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    if name == "global_rows":
        def drop(real, L, n_valid, n_glob, device):
            allowed = real(L, n_valid, n_glob, device).clone()
            allowed[:, 64:128] = False
            return allowed
        tile = [(ts, "sliding_global_allowed", None, drop)]
    else:
        row = {"band_rows": "sliding_train_bwd", "bigbird_rows": "bigbird_train_bwd",
               "attn_rows": "attention_train_bwd"}[name]
        tile = core_bwd_faults(row)[BWD_CORE_FAULTS[2]]
    return {ROWS_FAULTS[0]: [(am, "rows_exponent", None, lambda real, s, m, dt: torch.exp(s - m))],
            ROWS_FAULTS[1]: tile,
            ROWS_FAULTS[2]: [(am, "rows_softmax", None, running_max_softmax)]}


def rows_readings(got, want) -> dict:
    """{output: (element-wise, norm)} of (ctx, stats or None) against the
    model's; fails where one is finite and the other not (a row's m is -inf
    where it has no allowed key)."""
    import torch

    (gc, gs), (wc, ws) = got, want
    parts = [("ctx", gc, wc, 2**-7 if gc.dtype == torch.bfloat16 else 0.0)]
    if gs is not None:
        parts += [(k, gs[i], ws[i], 0.0) for i, k in enumerate(ROWS_STATS)]
    out = {}
    for k, g, w, rtol in parts:
        g, w = g.float(), w.float()
        fin = torch.isfinite(w)
        if not torch.equal(torch.isfinite(g), fin):
            fail(f"rows kernel: {k} is finite where its model's is not, or the other way")
        g, w = g[fin], w[fin]
        out[k] = (beyond_limit(g, w, (0.0, rtol)) / max(w.abs().max().item(), 1e-30),
                  ((g - w).norm() / w.norm().clamp_min(1e-30)).item())
    return out


def rows_tol(got):
    """ROWS_TOL of a rows kernel's (ctx, stats) by ctx's dtype."""
    return ROWS_TOL[str(got[0].dtype).split(".")[-1]]


def check_rows(label: str, name: str, got, model, f32: bool = False) -> dict:
    """A rows kernel's (ctx, stats) against ``model()`` within ROWS_TOL; each
    of ROWS_FAULTS planted in the model must fail it. ``f32``: a float32
    kernel on 3xTF32 (row 10's attn_rows), whose model takes its products on
    the 3xTF32 model and whose e is unrounded, so that only the dropped key
    tile of ROWS_FAULTS is a fault there, and F32_CORE_FAULT beside it.
    Returns {reading, norm_reading, faults: {fault: (element-wise, norm)}}."""
    show = lambda rd: ", ".join(f"{k} {e:.2e} / {n:.2e}" for k, (e, n) in rd.items())
    tol = rows_tol(got)
    base = core_products(tf32x3_model) if f32 else []
    with planted(base):
        readings = rows_readings(got, model())
    print(f"  {label} against its rounding model, element-wise / norm: {show(readings)} (limits "
          f"{tol[0]:g} max |ref|, {tol[1]:g} ||ref||)")
    if core_bwd_excess(readings, tol) > 1:
        fail(f"{label}: beyond its rounding model's limits: {show(readings)}")
    faults = {}
    plants = rows_faults(name)
    if f32:
        plants = {ROWS_FAULTS[1]: base + plants[ROWS_FAULTS[1]],
                  F32_CORE_FAULT: core_products(plain_tf32)}
    for fault, patches in plants.items():
        with planted(patches):
            bad = rows_readings(got, model())
        worst = (max(e for e, _ in bad.values()), max(n for _, n in bad.values()))
        faults[fault] = worst
        rejected = core_bwd_excess(bad, tol) > 1
        print(f"  planted fault, {label}'s model with {fault}: element-wise {worst[0]:.2e}, "
              f"norm {worst[1]:.2e}: " + ("rejected" if rejected else "ACCEPTED"))
        if not rejected:
            fail(f"the rows kernels' limits accept {fault} ({label})")
    return {"reading": max(e for e, _ in readings.values()),
            "norm_reading": max(n for _, n in readings.values()), "faults": faults}


def rows_qkv(randn, Bq: int, Lq: int, dt, scale_q: bool = True):
    """(3, B, nh, L, hd) q (scaled by hd^-0.5 when scale_q), k, v in dt from
    a random projection."""
    import torch

    hidden, w = randn(Bq, Lq, H), randn(H, 3, NH, HD, scale=H**-0.5)
    qkv = torch.einsum("blh,hsnd->sbnld", hidden, w) + randn(3, 1, NH, 1, HD, scale=0.02)
    if scale_q:
        qkv[0] *= HD**-0.5
    return qkv.to(dt).contiguous()


# The global rows (global_rows_kernel) launched alone
# (train_sliding.sliding_global_rows) on their own x, Wgq, kg and vg, against
# sliding_global_rows_model on the kernel's own qg: ctx and, in the
# statistics pass, the rows' (m, D, rowsum(dp p_eff)) read as rows_readings
# reads them, within ROWS_TOL, and dqg read as a slot of dproj is
# (core_bwd_readings), within BWD_CORE_TOL["sliding_train_bwd"]: its model
# is the gradient kernels' (dense_core_grad). Each of ROWS_FAULTS, planted
# in the model, must fail one of them. qg itself is held to the plain query
# (train_sliding.sliding_global_query): in bf16 within QG_TOL = (s, r),
# max(|got - want| - r |want|) <= s max |want|, r = 2^-7 for the bf16
# rounding both take after float32 sums in another order and s for values
# near 0; a query without its bias must fail it; in W8A8 bit for bit (int32
# sums, the same dequantisation).
QG_TOL = (1e-4, 2**-7)
QG_FAULT = "the global query without its bias"
# The float32 query on the 3xTF32 tile against the plain one (exact float32
# products): element by element max |err| <= s max |ref| and in norm
# ||err|| <= r ||ref||, F32_FWD_TOL's (s, r), which the bias-free query
# and plain TF32 products (F32_GEMM_FAULT's tf32x3_product(..., terms=1))
# must each fail
QG_F32_TOL = F32_FWD_TOL
QG_F32_FAULTS = (QG_FAULT, "plain TF32 query products")


def global_rows_readings(got, want) -> dict:
    """{output: (element-wise, norm)} of the global rows' (ctx, qg, stats,
    dqg) from sliding_global_rows against the model's (ctx, stats, dqg)."""
    import torch

    (gc, _, gs, gd), (wc, ws, wd) = got, want
    out = rows_readings((gc, gs), (wc, ws))
    if gd is not None:
        g, w = gd.float(), wd.float()
        if not torch.isfinite(g).all():
            fail("global rows: non-finite dqg")
        rtol = 2**-7 if gd.dtype == torch.bfloat16 else 0.0
        out["dqg"] = (beyond_limit(g, w, (0.0, rtol)) / max(w.abs().max().item(), 1e-30),
                      ((g - w).norm() / w.norm().clamp_min(1e-30)).item())
    return out


def global_rows_excess(readings: dict, ctx_dtype, f32: bool = False) -> float:
    """The largest global-rows reading over its limit (ROWS_TOL by ctx's
    dtype, BWD_CORE_TOL for dqg, F32_BWD_CORE_TOL in float32): above 1
    fails."""
    rows = {k: v for k, v in readings.items() if k != "dqg"}
    excess = core_bwd_excess(rows, ROWS_TOL[str(ctx_dtype).split(".")[-1]])
    if "dqg" in readings:
        excess = max(excess, core_bwd_excess(
            {"dqg": readings["dqg"]},
            F32_BWD_CORE_TOL if f32 else BWD_CORE_TOL["sliding_train_bwd"]))
    return excess


def check_global_rows(label: str, got, model, f32: bool = False) -> dict:
    """The global rows' (ctx, qg, stats, dqg) against ``model()`` within
    their limits; each of ROWS_FAULTS planted in the model must fail them.
    ``f32``: the float32 body on 3xTF32, whose model takes its products on
    the 3xTF32 model and whose e is unrounded, so that of ROWS_FAULTS only
    the dropped key tile is a fault there, and F32_CORE_FAULT beside it (as
    check_rows). Returns {reading, norm_reading, faults: {fault:
    (element-wise, norm)}}."""
    show = lambda rd: ", ".join(f"{k} {e:.2e} / {n:.2e}" for k, (e, n) in rd.items())
    base = core_products(tf32x3_model) if f32 else []
    with planted(base):
        readings = global_rows_readings(got, model())
    print(f"  {label} against its rounding model, element-wise / norm: {show(readings)}")
    if global_rows_excess(readings, got[0].dtype, f32) > 1:
        fail(f"{label}: beyond its rounding model's limits: {show(readings)}")
    faults = {}
    plants = rows_faults("global_rows")
    if f32:
        plants = {ROWS_FAULTS[1]: base + plants[ROWS_FAULTS[1]],
                  F32_CORE_FAULT: core_products(plain_tf32)}
    for fault, patches in plants.items():
        with planted(patches):
            bad = global_rows_readings(got, model())
        worst = (max(e for e, _ in bad.values()), max(n for _, n in bad.values()))
        faults[fault] = worst
        rejected = global_rows_excess(bad, got[0].dtype, f32) > 1
        print(f"  planted fault, {label}'s model with {fault}: element-wise {worst[0]:.2e}, "
              f"norm {worst[1]:.2e}: " + ("rejected" if rejected else "ACCEPTED"))
        if not rejected:
            fail(f"the global rows' limits accept {fault} ({label})")
    return {"reading": max(e for e, _ in readings.values()),
            "norm_reading": max(n for _, n in readings.values()), "faults": faults}


def query_reading(qg, want) -> float:
    """max(|qg - want| - 2^-7 |want|) / max |want| of the kernel's global
    query against the plain one (QG_TOL's element-wise part)."""
    return beyond_limit(qg, want, (0.0, QG_TOL[1])) / max(want.float().abs().max().item(), 1e-30)


def query_f32_readings(qg, want) -> tuple:
    """(max |qg - want| / max |want|, ||qg - want|| / ||want||) of the
    float32 query against the plain one, read against QG_F32_TOL."""
    g, w = qg.float(), want.float()
    return ((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30),
            ((g - w).norm() / w.norm().clamp_min(1e-30)).item())


def check_f32_query(label: str, qg, plain) -> dict:
    """The float32 global query qg against ``plain(bias=True)`` (the plain
    query, train_sliding.sliding_global_query) within QG_F32_TOL; the
    bias-free query (``plain(bias=False)``) and the plain query on plain
    TF32 products (float_products(plain_tf32)) must each fail it. Returns
    {reading, norm_reading, faults: {fault: (element-wise, norm)}}."""
    within = lambda r: r[0] <= QG_F32_TOL[0] and r[1] <= QG_F32_TOL[1]
    reading = query_f32_readings(qg, plain(True))
    print(f"  {label}: qg against the plain query, element-wise / norm {reading[0]:.2e} / "
          f"{reading[1]:.2e} (limits {QG_F32_TOL[0]:g} max |ref|, {QG_F32_TOL[1]:g} ||ref||)")
    if not within(reading):
        fail(f"{label}: the float32 query beyond QG_F32_TOL")
    faults = {QG_F32_FAULTS[0]: query_f32_readings(qg, plain(False))}
    with planted(float_products(plain_tf32)):
        faults[QG_F32_FAULTS[1]] = query_f32_readings(qg, plain(True))
    for fault, bad in faults.items():
        print(f"  planted fault, {label}'s query with {fault}: element-wise {bad[0]:.2e}, norm "
              f"{bad[1]:.2e}: " + ("ACCEPTED" if within(bad) else "rejected"))
        if within(bad):
            fail(f"the float32 query's limit accepts {fault} ({label})")
    return {"reading": reading[0], "norm_reading": reading[1], "faults": faults}


def kernel_device_ms(fn, name=None, reps: int = 10, tries: int = 3) -> float:
    """ms of device time a call of fn (torch.profiler, after a warm-up): of
    the kernels whose name holds ``name``, or of every kernel of the call.
    CUPTI now and then hands the profiler a trace without the device's
    records; after ``tries`` such traces the call is timed whole with CUDA
    events instead (which also counts whatever else fn launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t > 0 and (name is None or name in e.key):
                us += t
        if us > 0:
            return us / 1e3 / reps
    ms = time_ms(fn, reps)
    print(f"  torch.profiler saw no device time of {name or 'the call'} in {tries} traces; "
          f"the whole call timed with CUDA events: {ms:.4f} ms")
    return ms


def global_rows_phase(device, rows: dict):
    """The global rows alone at kernel 7's and row 12's shape (B=8, L=2048,
    BERT-base widths, the Longformer phase's padding), with CLS global (n_glob
    1, the main paths') and with 16 global tokens, in each mode a main path
    runs them: kernel 7 bf16, kernel 7 W8A8 (the int8 query, float32 ctx),
    row 12's forward at dropout 0.1 and its statistics pass (kGrad: the
    statistics and dqg). Each: qg against the plain query (query_reading,
    QG_TOL; W8A8 bit for bit), the rest against the rounding model
    (check_global_rows), two launches the same bits, the kernel's device
    time (torch.profiler) beside its bound (the real keys' kg and vg read
    once, x's global rows, Wgq, and the rows' outputs; the query's and the
    attention's operations, 4 hd a (row, key) pair, 8 hd with dP and dS .
    kg) and SDPA's (scaled_dot_product_attention on the kernel's qg, kg, vg
    with the key-padding mask, device time). Adds global_ms,
    global_bound_ms, global_bound_by, global_library_ms, global_reading and
    global_norm_reading (n_glob 1) and the same keys ending in _16 (n_glob
    16) to rows 7, 7 W8A8 and 12 (forward and backward). Then the same in
    float32 (the 3xTF32 body; kernel 7 W8A8 on float32 activations) at B=8
    and at the recipe's micro-batch B=2 (keys ending in _b2): the query
    within QG_F32_TOL (check_f32_query), the rest with check_global_rows(f32),
    the bound at the 3xTF32 rate, SDPA in float32; into the float32 rows."""
    import torch
    import torch.nn.functional as F

    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts
    from spokennlp_tpu_torch.ops.cuda.int8_matmul import quantize_colwise, rowquant_plain

    g = torch.Generator(device=device).manual_seed(15)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    HN, sm = NH * HD, HD**-0.5
    seed = torch.tensor([20231021], dtype=torch.int32, device=device)
    G = sb.global_columns(LF_MAX_GLOBALS, LF_L)
    mask, _ = sliding_masks(device)
    keep = ts.sliding_keep_masks(seed, LF_B, NH, LF_L, LF_WINDOW, G, DROPOUT)[2]

    def inputs(dt):
        """x, wgq, bgq, gkv, the W8A8 query's quant and dctx in dt"""
        x = randn(LF_B, LF_L, H).to(dt)
        wgq, bgq = randn(H, HN, scale=H**-0.5).to(dt), randn(HN, scale=0.02)
        gkv = rows_qkv(randn, LF_B, LF_L, dt, scale_q=False)[1:].contiguous()
        x8, sx = rowquant_plain(x.reshape(-1, H))
        wgq8, swgq = quantize_colwise(wgq.float())
        quant = {"x8": x8.contiguous(), "sx": sx.reshape(-1).contiguous(),
                 "wgq8": wgq8.contiguous(), "swgq": swgq.reshape(-1).contiguous()}
        dctx = (randn(LF_B, LF_L, HN) * mask[..., None]).to(dt)
        return x, wgq, bgq, gkv, quant, dctx

    def run(dt_name, x, wgq, bgq, gkv, quant, dctx, nb, n_g, suffix, modes):
        """check, time and bound each mode at batch nb with n_g global rows"""
        f32 = dt_name == "float32"
        x, gkv, dctx = x[:nb], gkv[:, :nb].contiguous(), dctx[:nb]
        if quant is not None:
            quant = {**quant, "x8": quant["x8"][:nb * LF_L], "sx": quant["sx"][:nb * LF_L]}
        n_valid = mask[:nb].sum(1)
        counts = torch.stack([n_valid, torch.full_like(n_valid, n_g)], 1).int().contiguous()
        key_mask = mask[:nb].bool()[:, None, None, :]
        keys, es = int(n_valid.sum()), x.element_size()
        lib = None
        for label, name, rate, w8a8, grad in modes:
            label = f"global_rows ({label}, n_glob {n_g}, B={nb})"
            q = quant if w8a8 else None
            dc = dctx if grad else None
            launch = lambda: ts.sliding_global_rows(x, wgq, bgq, gkv, counts, seed, sm_scale=sm,
                                                    dctx=dc, dropout_rate=rate, quant=q)
            got, again = launch(), launch()
            torch.cuda.synchronize()
            if not all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{label}: two launches differ")
            plain = lambda bias=True, q=q: ts.sliding_global_query(
                x, wgq, bgq if bias else torch.zeros_like(bgq), counts[:, 1], num_heads=NH,
                sm_scale=sm, G=G, quant=q)
            if q is not None:
                if not torch.equal(got[1], plain()):
                    fail(f"{label}: the int8 query differs from the plain one")
                print(f"  {label}: qg equals the plain int8 query bit for bit")
            elif f32:
                check_f32_query(label, got[1], plain)
            else:
                qr, bad_q = query_reading(got[1], plain()), query_reading(got[1], plain(False))
                print(f"  {label}: qg against the plain query {qr:.2e} (limit {QG_TOL[0]:g} "
                      f"max |ref|); with {QG_FAULT}: {bad_q:.2e}")
                if qr > QG_TOL[0] or bad_q <= QG_TOL[0]:
                    fail(f"{label}: the query's limit does not hold or accepts {QG_FAULT}")
            gate = check_global_rows(label, got, lambda: ts.sliding_global_rows_model(
                got[1], gkv[0], gkv[1], n_valid, counts[:, 1], sm_scale=sm,
                dctx=None if dc is None else dc.reshape(nb, LF_L, NH, HD), dropout_rate=rate,
                keep=keep[:nb] if rate else None,
                ctx_dtype=torch.float32 if q is not None else None), f32)
            if lib is None:
                qg = got[1]
                lib = kernel_device_ms(lambda: F.scaled_dot_product_attention(
                    qg, gkv[0], gkv[1], attn_mask=key_mask, scale=1.0))
            ms = kernel_device_ms(launch, "global_rows_kernel")
            n_rows = nb * n_g
            query_ops = 2 * H * HN * n_rows
            attn_ops = (8 if grad else 4) * HD * NH * n_g * keys
            core = "tf32x3" if f32 else "bfloat16"
            ops = {"int8": query_ops, core: attn_ops} if q is not None else {
                core: query_ops + attn_ops}
            io = (2 * es * NH * HD * keys + n_rows * H * (1 if q is not None else es)
                  + H * HN * (1 if q is not None else es) + n_rows * HN * got[0].element_size()
                  + (n_rows * HN * es * 3 + 3 * n_rows * NH * 4 if grad else 0))
            b = bound(ops, io)
            rows.setdefault((name, dt_name), {}).update({
                f"global_ms{suffix}": ms, f"global_bound_ms{suffix}": b["bound_ms"],
                f"global_bound_by{suffix}": b["bound_by"], f"global_library_ms{suffix}": lib,
                f"global_reading{suffix}": gate["reading"],
                f"global_norm_reading{suffix}": gate["norm_reading"]})
            print(f"kernel {label}: {ms:.4f} ms of device time, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}), SDPA with the key-padding mask {lib:.4f} ms; with the "
                  f"wrapper (CUDA events) {time_ms(launch):.4f} ms")

    tensors = inputs(torch.bfloat16)
    modes = (("kernel 7 bfloat16", "sliding_attention_block", 0.0, False, False),
             ("kernel 7 W8A8, float32 ctx", "sliding_attention_block_w8a8", 0.0, True, False),
             ("row 12 forward, dropout 0.1", "sliding_train_fwd", DROPOUT, False, False),
             ("row 12 statistics pass, dropout 0.1", "sliding_train_bwd", DROPOUT, False, True))
    for n_g in (1, 16):
        run("bfloat16", *tensors, LF_B, n_g, "" if n_g == 1 else "_16", modes)
    del tensors
    torch.cuda.empty_cache()
    # the float32 body (3xTF32, the keys over a cluster of blocks), at B=8
    # and at the recipe's micro-batch of 2
    tensors = inputs(torch.float32)
    modes = (("kernel 7 float32", "sliding_attention_block", 0.0, False, False),
             ("kernel 7 W8A8, float32 activations", "sliding_attention_block_w8a8", 0.0, True,
              False),
             ("row 12 forward float32, dropout 0.1", "sliding_train_fwd", DROPOUT, False, False),
             ("row 12 statistics pass float32, dropout 0.1", "sliding_train_bwd", DROPOUT, False,
              True))
    for nb in (LF_B, LF_TRAIN_B):
        for n_g in (1, 16):
            suffix = ("" if n_g == 1 else "_16") + ("" if nb == LF_B else "_b2")
            run("float32", *tensors, nb, n_g, suffix, modes)
    del tensors
    torch.cuda.empty_cache()


def rows_kernel_phase(device, rows: dict):
    """The rows kernels alone, bf16, in each mode a main path runs them:
    band_rows at B=8, L=2048 (CLS global) as kernel 7 (bf16 ctx), kernel 7
    W8A8 (float32 ctx), row 12's forward (dropout 0.1) and its statistics
    pass (kGrad, with dctx); bigbird_rows at B=4, L=4096 as kernel 8 and 8
    W8A8 and at B=8, L=2048 as row 13's forward and statistics pass;
    attn_rows at B=32, L=512 as row 10's forward and statistics pass (dropout
    0.1). Each held to its rounding model (check_rows), timed (rows_ms)
    beside its bound (rows_bound_ms: the core's operations, 4 hd a (row,
    key) pair and 2 hd more for dP, over the bf16 peak, or q, k, v, ctx and
    in the statistics pass dctx and the statistics over the memory rate)
    and, for the forwards, scaled_dot_product_attention on the same q, k, v
    with the boolean mask of the allowed keys, dense over L x L
    (rows_library_ms). Then row 10's gradient kernels alone, attn_dkv and
    attn_dq (dkv_ms, dq_ms, beside grad_bound_ms). Adds those keys to the
    bf16 rows of kernels 7, 8, 10, 12 and 13. Then the same in float32 (the
    bodies on 3xTF32, check_rows(f32=True), the bound at the 3xTF32 rate):
    attn_rows and row 10's gradient kernels, band_rows as kernel 7, row 12's
    forward and statistics pass, bigbird_rows as kernel 8 and row 13's
    forward and statistics pass; kernels 7 and 8's W8A8 rows take the float
    modes' readings."""
    import torch
    import torch.nn.functional as F

    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    g = torch.Generator(device=device).manual_seed(13)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    bf16, HN = torch.bfloat16, NH * HD
    seed = torch.tensor([20231020], dtype=torch.int32, device=device)
    heads = lambda t: t.transpose(1, 2)

    def run(label, name, row, launch, model, work_pairs, qkv, dctx, sdpa, f32=False):
        """check, time and bound one mode; returns its readings."""
        got = launch()
        torch.cuda.synchronize()
        gate = check_rows(label, name, got, model, f32)
        ms = time_ms(launch)
        Bq, Lq = qkv.shape[1], qkv.shape[3]
        flops = 4 * NH * HD * work_pairs * (1.5 if dctx is not None else 1.0)
        io = nbytes(qkv, got[0]) + (0 if dctx is None else nbytes(dctx, got[1]))
        b = bound(flops, io, "tf32x3" if f32 else "bfloat16")
        row.update(rows_ms=ms, rows_bound_ms=b["bound_ms"], rows_bound_by=b["bound_by"],
                   rows_reading=gate["reading"], rows_norm_reading=gate["norm_reading"])
        lib = ""
        if sdpa is not None:
            row["rows_library_ms"] = sdpa
            lib = f", SDPA with the mask (dense) {sdpa:.3f} ms"
        print(f"kernel {label}: {ms:.3f} ms alone, bound {b['bound_ms']:.3f} ms "
              f"({b['bound_by']}){lib}")
        return gate

    def sdpa_ms(qkv, allowed, label, scale=1.0):
        q, k, v = qkv.unbind(0)
        return library_time(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                                                    scale=scale),
                            f"{label} (scaled_dot_product_attention with the mask, dense)")

    def sdpa_bwd_ms(qkv, dctx, allowed, label, scale=1.0):
        """SDPA with the mask, forward and backward (autograd to q, k and v
        with the cotangent dctx): the library column of a backward's cores"""
        q, k, v = (t.detach().requires_grad_() for t in qkv.unbind(0))
        Bq, nq, Lq, hq = q.shape
        g = dctx.reshape(Bq, Lq, nq, hq).transpose(1, 2)

        def call():
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=allowed, scale=scale)
            return torch.autograd.grad(out, (q, k, v), g)

        return library_time(call, f"{label} (scaled_dot_product_attention with the mask, dense, "
                                  "forward and backward)")

    # attn_rows at row 10's shape, then its gradient kernels alone
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    seg, sm = segments(device), HD**-0.5
    qkv = rows_qkv(randn, B, L, bf16, scale_q=False)
    dctx = randn(B, L, HN).to(bf16)
    allowed = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0))[:, None]
    lib = sdpa_ms(qkv, allowed, "attn_rows", scale=sm)
    rows["attention_train_bwd", "bfloat16"]["core_library_ms"] = sdpa_bwd_ms(
        qkv, dctx, allowed, "row 10's backward cores bfloat16", scale=sm)
    keep = tb.dropout_keep_mask(seed, B, NH, L, DROPOUT)
    for label, name, dc, lib_ms in (
            ("attn_rows (row 10 forward, dropout 0.1)", "attention_train_fwd", None, lib),
            ("attn_rows (row 10 statistics pass, dropout 0.1)", "attention_train_bwd", dctx,
             None)):
        run(label, "attn_rows", rows[name, "bfloat16"],
            lambda: tb.attention_rows(qkv, seg, seed, sm_scale=sm, dctx=dc, dropout_rate=DROPOUT),
            lambda: tb.attention_rows_model(
                qkv[0], qkv[1], qkv[2], seg, sm_scale=sm, dropout_rate=DROPOUT, keep=keep,
                dctx=None if dc is None else dc.reshape(B, L, NH, HD)),
            B * L * L, qkv, dc, lib_ms)
    stats = tb.attention_rows(qkv, seg, seed, sm_scale=sm, dctx=dctx, dropout_rate=DROPOUT)[1]
    grad = lambda which, out=None: tb.attention_grad(qkv, seg, seed, dctx, stats, sm_scale=sm,
                                                     dropout_rate=DROPOUT, which=which, out=out)
    out = grad(1)
    row = rows["attention_train_bwd", "bfloat16"]
    row.update(dkv_ms=time_ms(lambda: grad(1, out)), dq_ms=time_ms(lambda: grad(2, out)))
    # S, dP and the dq, dk, dv products, 10 hd a (row, key) pair of every
    # head; q, k, v, dctx and the statistics read, dq, dk, dv written
    row["grad_bound_ms"] = bound(10 * NH * HD * B * L * L,
                                 7 * nbytes(dctx) + nbytes(stats))["bound_ms"]
    print(f"kernel attn_dkv (row 10): {row['dkv_ms']:.3f} ms alone, attn_dq "
          f"{row['dq_ms']:.3f} ms alone (from the stored dS tiles); the pair's bound "
          f"{row['grad_bound_ms']:.3f} ms")
    del qkv, dctx, keep, stats, out
    torch.cuda.empty_cache()

    # row 10's float32 cores on 3xTF32: attn_rows as the forward and the
    # statistics pass, then attn_dkv and attn_dq alone, with SDPA's
    # columns on the same float32 q, k, v and dctx
    f32 = torch.float32
    qkv = rows_qkv(randn, B, L, f32, scale_q=False)
    dctx = randn(B, L, HN)
    lib = sdpa_ms(qkv, allowed, "attn_rows float32", scale=sm)
    rows["attention_train_bwd", "float32"]["core_library_ms"] = sdpa_bwd_ms(
        qkv, dctx, allowed, "row 10's backward cores float32", scale=sm)
    del allowed
    keep = tb.dropout_keep_mask(seed, B, NH, L, DROPOUT)
    for label, name, dc, lib_ms in (
            ("attn_rows float32 (row 10 forward, dropout 0.1)", "attention_train_fwd", None, lib),
            ("attn_rows float32 (row 10 statistics pass, dropout 0.1)", "attention_train_bwd",
             dctx, None)):
        run(label, "attn_rows", rows[name, "float32"],
            lambda: tb.attention_rows(qkv, seg, seed, sm_scale=sm, dctx=dc, dropout_rate=DROPOUT),
            lambda: tb.attention_rows_model(
                qkv[0], qkv[1], qkv[2], seg, sm_scale=sm, dropout_rate=DROPOUT, keep=keep,
                dctx=None if dc is None else dc.reshape(B, L, NH, HD)),
            B * L * L, qkv, dc, lib_ms, f32=True)
    stats = tb.attention_rows(qkv, seg, seed, sm_scale=sm, dctx=dctx, dropout_rate=DROPOUT)[1]
    out = grad(1)
    row = rows["attention_train_bwd", "float32"]
    row.update(dkv_ms=time_ms(lambda: grad(1, out)), dq_ms=time_ms(lambda: grad(2, out)))
    row["grad_bound_ms"] = bound(10 * NH * HD * B * L * L,
                                 7 * nbytes(dctx) + nbytes(stats), "tf32x3")["bound_ms"]
    print(f"kernel attn_dkv float32 (row 10): {row['dkv_ms']:.3f} ms alone, attn_dq "
          f"{row['dq_ms']:.3f} ms alone (from the stored float32 dS tiles); the pair's bound "
          f"{row['grad_bound_ms']:.3f} ms (3xTF32)")
    del qkv, dctx, keep, stats, out
    torch.cuda.empty_cache()

    # band_rows at kernel 7's and row 12's shape
    mask, glob = sliding_masks(device)
    n_valid, n_glob = mask.sum(1), glob.sum(1)
    counts = torch.stack([n_valid, n_glob], 1).int().contiguous()
    C, G = LF_WINDOW // 2, sb.global_columns(LF_MAX_GLOBALS, LF_L)
    work = sliding_work(mask, glob, LF_WINDOW, H, NH, HD)
    pairs = work["rows_pairs"]
    qkv = rows_qkv(randn, LF_B, LF_L, bf16)
    dctx = (randn(LF_B, LF_L, HN) * mask[..., None]).to(bf16)
    allowed = torch.stack([ts.sliding_model_allowed(LF_L, C, int(nv), int(ng), device)
                           for nv, ng in zip(n_valid, n_glob)])[:, None]
    lib = sdpa_ms(qkv, allowed, "band_rows")
    rows["sliding_train_bwd", "bfloat16"]["core_library_ms"] = sdpa_bwd_ms(
        qkv, dctx, allowed, "row 12's backward cores bfloat16")
    qkv32 = qkv.float()
    rows["sliding_train_bwd", "float32"]["core_library_ms"] = sdpa_bwd_ms(
        qkv32, dctx.float(), allowed, "row 12's backward cores float32")
    del allowed, qkv32
    keep = ts.sliding_keep_masks(seed, LF_B, NH, LF_L, LF_WINDOW, G, DROPOUT)
    model = lambda rate, ctx_dtype=None, dc=None: ts.sliding_rows_model(
        qkv[0], qkv[1], qkv[2], None, n_valid, n_glob, window=LF_WINDOW, dropout_rate=rate,
        keep=keep if rate else None, ctx_dtype=ctx_dtype,
        dctx=None if dc is None else dc.reshape(LF_B, LF_L, NH, HD))
    launch = lambda rate, ctx_dtype=None, dc=None: ts.sliding_rows(
        qkv, counts, seed, window=LF_WINDOW, dctx=dc, dropout_rate=rate, ctx_dtype=ctx_dtype)
    for label, row, rate, cdt, dc, lib_ms in (
            ("band_rows (kernel 7 bfloat16)", rows["sliding_attention_block", "bfloat16"], 0.0,
             None, None, lib),
            ("band_rows (kernel 7 W8A8, float32 ctx)",
             rows["sliding_attention_block_w8a8", "bfloat16"], 0.0, torch.float32, None, lib),
            ("band_rows (row 12 forward, dropout 0.1)", rows["sliding_train_fwd", "bfloat16"],
             DROPOUT, None, None, lib),
            ("band_rows (row 12 statistics pass, dropout 0.1)",
             rows["sliding_train_bwd", "bfloat16"], DROPOUT, None, dctx, None)):
        run(label, "band_rows", row, lambda: launch(rate, cdt, dc), lambda: model(rate, cdt, dc),
            pairs, qkv, dc, lib_ms)
    del qkv, dctx, keep
    torch.cuda.empty_cache()
    global_rows_phase(device, rows)

    # bigbird_rows at kernel 8's shape, then at row 13's
    for Bq, Lq, modes in (
            (BB_B, BB_L, (("bigbird_rows (kernel 8 bfloat16)", "bigbird_attention_block", 0.0,
                           None, False),
                          ("bigbird_rows (kernel 8 W8A8, float32 ctx)",
                           "bigbird_attention_block_w8a8", 0.0, torch.float32, False))),
            (BB_TRAIN_B, BB_TRAIN_L, (("bigbird_rows (row 13 forward, dropout 0.1)",
                                       "bigbird_train_fwd", DROPOUT, None, False),
                                      ("bigbird_rows (row 13 statistics pass, dropout 0.1)",
                                       "bigbird_train_bwd", DROPOUT, None, True)))):
        mask = bigbird_masks(device, Bq, Lq)
        n_valid = mask.sum(1)
        counts = torch.stack([n_valid, torch.zeros_like(n_valid)], 1).int().contiguous()
        t = bigbird_tables(Lq // BB_BLOCK, BB_GLOBAL, BB_RANDOM, BB_SEED, device)
        pairs = bigbird_work(mask, BB_BLOCK, t, H, NH, HD)["core"] / (4 * NH * HD)
        qkv = rows_qkv(randn, Bq, Lq, bf16)
        dctx = (randn(Bq, Lq, HN) * mask[..., None]).to(bf16)
        reg = torch.from_numpy(tbb.bigbird_model_regions(
            Lq, BB_BLOCK, t.G, t.R, t.rand.cpu().numpy(), t.rok.cpu().numpy())).to(device) > 0
        allowed = (reg[None] & (torch.arange(Lq, device=device)[None, None]
                                < n_valid[:, None, None]))[:, None]
        lib = sdpa_ms(qkv, allowed, f"bigbird_rows B={Bq} L={Lq}")
        if Bq == BB_TRAIN_B:  # row 13's backward cores
            for dt_name, cast in (("bfloat16", lambda t: t), ("float32", lambda t: t.float())):
                rows["bigbird_train_bwd", dt_name]["core_library_ms"] = sdpa_bwd_ms(
                    cast(qkv), cast(dctx), allowed, f"row 13's backward cores {dt_name}")
        del allowed, reg
        keep = tbb.bigbird_keep_masks(seed, Bq, NH, Lq, BB_BLOCK, t.G, t.R, DROPOUT)
        for label, name, rate, cdt, grad in modes:
            dc = dctx if grad else None
            run(label, "bigbird_rows", rows[name, "bfloat16"],
                lambda: tbb.bigbird_rows(qkv, counts, seed, t, block_size=BB_BLOCK, dctx=dc,
                                         dropout_rate=rate, ctx_dtype=cdt),
                lambda: tbb.bigbird_rows_model(
                    qkv[0], qkv[1], qkv[2], n_valid, t, block_size=BB_BLOCK, dropout_rate=rate,
                    keep=keep if rate else None, ctx_dtype=cdt,
                    dctx=None if dc is None else dc.reshape(Bq, Lq, NH, HD)),
                pairs, qkv, dc, None if grad else lib)
        del qkv, dctx, keep
        torch.cuda.empty_cache()

    # the float32 band and BigBird rows kernels on 3xTF32 in each mode a main
    # path runs them (kernel 7's and 8's W8A8 modes with float32 activations
    # run the float modes' instantiations: their rows take the same reading)
    f32 = torch.float32
    mask, glob = sliding_masks(device)
    n_valid, n_glob = mask.sum(1), glob.sum(1)
    counts = torch.stack([n_valid, n_glob], 1).int().contiguous()
    pairs = sliding_work(mask, glob, LF_WINDOW, H, NH, HD)["rows_pairs"]
    qkv = rows_qkv(randn, LF_B, LF_L, f32)
    dctx = randn(LF_B, LF_L, HN) * mask[..., None]
    allowed = torch.stack([ts.sliding_model_allowed(LF_L, C, int(nv), int(ng), device)
                           for nv, ng in zip(n_valid, n_glob)])[:, None]
    lib = sdpa_ms(qkv, allowed, "band_rows float32")
    del allowed
    keep = ts.sliding_keep_masks(seed, LF_B, NH, LF_L, LF_WINDOW, G, DROPOUT)
    for label, name, rate, dc, lib_ms in (
            ("band_rows float32 (kernel 7)", "sliding_attention_block", 0.0, None, lib),
            ("band_rows float32 (row 12 forward, dropout 0.1)", "sliding_train_fwd", DROPOUT,
             None, lib),
            ("band_rows float32 (row 12 statistics pass, dropout 0.1)", "sliding_train_bwd",
             DROPOUT, dctx, None)):
        run(label, "band_rows", rows[name, "float32"],
            lambda: ts.sliding_rows(qkv, counts, seed, window=LF_WINDOW, dctx=dc,
                                    dropout_rate=rate),
            lambda: ts.sliding_rows_model(
                qkv[0], qkv[1], qkv[2], None, n_valid, n_glob, window=LF_WINDOW,
                dropout_rate=rate, keep=keep if rate else None,
                dctx=None if dc is None else dc.reshape(LF_B, LF_L, NH, HD)),
            pairs, qkv, dc, lib_ms, f32=True)
    del qkv, dctx, keep
    torch.cuda.empty_cache()
    for Bq, Lq, modes in (
            (BB_B, BB_L, (("bigbird_rows float32 (kernel 8)", "bigbird_attention_block", 0.0,
                           False),)),
            (BB_TRAIN_B, BB_TRAIN_L, (("bigbird_rows float32 (row 13 forward, dropout 0.1)",
                                       "bigbird_train_fwd", DROPOUT, False),
                                      ("bigbird_rows float32 (row 13 statistics pass, dropout "
                                       "0.1)", "bigbird_train_bwd", DROPOUT, True)))):
        mask = bigbird_masks(device, Bq, Lq)
        n_valid = mask.sum(1)
        counts = torch.stack([n_valid, torch.zeros_like(n_valid)], 1).int().contiguous()
        t = bigbird_tables(Lq // BB_BLOCK, BB_GLOBAL, BB_RANDOM, BB_SEED, device)
        pairs = bigbird_work(mask, BB_BLOCK, t, H, NH, HD)["core"] / (4 * NH * HD)
        qkv = rows_qkv(randn, Bq, Lq, f32)
        dctx = randn(Bq, Lq, HN) * mask[..., None]
        reg = torch.from_numpy(tbb.bigbird_model_regions(
            Lq, BB_BLOCK, t.G, t.R, t.rand.cpu().numpy(), t.rok.cpu().numpy())).to(device) > 0
        allowed = (reg[None] & (torch.arange(Lq, device=device)[None, None]
                                < n_valid[:, None, None]))[:, None]
        lib = sdpa_ms(qkv, allowed, f"bigbird_rows float32 B={Bq} L={Lq}")
        del allowed, reg
        keep = tbb.bigbird_keep_masks(seed, Bq, NH, Lq, BB_BLOCK, t.G, t.R, DROPOUT)
        for label, name, rate, grad in modes:
            dc = dctx if grad else None
            run(label, "bigbird_rows", rows[name, "float32"],
                lambda: tbb.bigbird_rows(qkv, counts, seed, t, block_size=BB_BLOCK, dctx=dc,
                                         dropout_rate=rate),
                lambda: tbb.bigbird_rows_model(
                    qkv[0], qkv[1], qkv[2], n_valid, t, block_size=BB_BLOCK, dropout_rate=rate,
                    keep=keep if rate else None,
                    dctx=None if dc is None else dc.reshape(Bq, Lq, NH, HD)),
                pairs, qkv, dc, None if grad else lib, f32=True)
        del qkv, dctx, keep
        torch.cuda.empty_cache()
    for name in ("sliding_attention_block", "bigbird_attention_block"):
        rows[f"{name}_w8a8", "float32"].update(
            {k: v for k, v in rows[name, "float32"].items() if k.startswith("rows_")})


def compare(name, dtype, kernel, plain, valid, tol=None, reps=10, w8a8=False, model=None):
    """Check kernel against plain on the valid rows (``tol`` = (atol, rtol),
    the kernel's limit by default; ``w8a8``: w8a8_check), or against
    ``model`` where given (the plain version on a rounding model of the
    kernel's products); time the kernel and plain."""
    import torch

    got, want = kernel(), (model or plain)()
    torch.cuda.synchronize()
    got, want = got[valid].float(), want[valid].float()
    if not torch.isfinite(got).all():
        fail(f"{name} {dtype}: non-finite output")
    err = (got - want).abs()
    max_err = err.max().item()
    if w8a8:
        c = w8a8_check(got, want, dtype)
        print(f"  {name} {dtype}: {c['share']:.2e} of the outputs beyond rounding "
              f"(limit {W8A8_SHARE[dtype]})")
        if not c["ok"]:
            fail(f"{name} {dtype}: {c['share']:.3e} of the outputs beyond rounding, max |err| "
                 f"{max_err:.3e} (limits {W8A8_SHARE[dtype]}, {W8A8_STEP} beyond rounding)")
    else:
        atol, rtol = tol or limit(name, dtype)
        excess = beyond_limit(got, want, (0.0, rtol))
        print(f"  {name} {dtype}: max(|err| - {rtol:.3g} |ref|) {excess:.3e} (atol {atol})")
        if excess > atol:
            fail(f"{name} {dtype}: max |err| {max_err:.3e} exceeds atol {atol} + rtol {rtol} * |ref|")
    row = {"max_abs_err": max_err, **timed_pair(kernel, plain, reps)}
    print(f"kernel {name} {dtype}: max_abs_err {max_err:.3e}  kernel {row['ms']:.3f} ms  "
          f"plain {row['plain_ms']:.3f} ms")
    return row


def attention_block_bf16_probabilities(hidden, segment_ids, qkv_kernel, qkv_bias, out_kernel,
                                       out_bias, *, sm_scale, ln_scale, ln_bias, eps=1e-12):
    """A planted fault: the float32 attention block with its probabilities
    rounded to bf16 (2^-9 relative each)."""
    import torch
    import torch.nn.functional as F

    x = hidden.float()
    qkv = torch.einsum("blh,hsnd->blsnd", x, qkv_kernel.float()) + qkv_bias.float()
    q, k, v = qkv.unbind(2)
    scores = torch.einsum("blnd,bmnd->bnlm", q * sm_scale, k)
    allowed = (segment_ids[:, :, None] == segment_ids[:, None, :]) & (segment_ids[:, None, :] > 0)
    scores = scores + torch.where(allowed, 0.0, -1e9)[:, None]
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    ctx = torch.einsum("bnlm,bmnd->blnd", probs, v)
    out = torch.einsum("blnd,ndh->blh", ctx, out_kernel.float()) + out_bias.float()
    return F.layer_norm(out + x, (x.shape[-1],), ln_scale, ln_bias, eps)


# the int8 tile's kernels (csrc/int8_gemm.cuh) and the W8A8 stack kernel:
# each function whose name holds one of these must contain IMMA
IMMA_KERNELS = ("gemm_act_i8_kernel", "gemm_act_quant_i8_kernel", "qkv_proj_i8_kernel",
                "residual_ln_i8_kernel", "encoder_stack_i8_kernel")
# the only functions that may still multiply int8 with IDP4A: 1c's int8
# attention core and the W8A8 global query, which stays an exact int32 sum
# on the CUDA cores inside global_rows_kernel (one live row a sequence on
# the main paths: no tile to fill; its W8A8 instances' attention runs on the
# tensor cores all the same)
IDP4A_ALLOWED = ("attn_core_i8_kernel", "global_rows_kernel")
# the attention cores on the tensor cores in both dtypes (bf16 mma.sync,
# float32 as 3xTF32 on mma.sync TF32: HMMA in SASS): the dense core's kernel
# (kernels 1 and 6), row 10's three cores, the sliding-window and BigBird
# rows kernels (kernels 7 and 8 in both modes, rows 12 and 13's forwards and
# statistics passes; attention_rows_mma.cuh), the Longformer global rows
# (global_rows_mma.cuh: kernel 7 in both modes, row 12's forward and
# statistics pass; the query, S, P.V, dP and dS . kg) and the Longformer and
# BigBird backwards' gradient kernels (attention_grad_mma.cuh), and the W8A8
# stack (int8 GEMMs, the core out of line in stack_core_item). Both
# instantiations of each must exist and hold HMMA (the W8A8 stack entry
# itself or in its core item of its element type); global_kv_grad_kernel,
# SIMT in both dtypes, is held to none by the stray rule
CORE_HMMA_KERNELS = ("attn_core_kernel", "attn_rows_kernel", "attn_dq_kernel",
                     "attn_dkv_kernel", "band_rows_kernel", "bigbird_rows_kernel",
                     "global_rows_kernel", "band_dq_kernel", "band_dkv_kernel",
                     "bigbird_dq_kernel", "bigbird_dkv_kernel", "encoder_stack_i8_kernel")
# the GEMM tile's kernels (bf16_gemm.cuh: kernels 1-3, 7-9 and the training
# kernels' forward products, the products their backwards recompute, with
# the MLP's act' epilogue (act_and_grad_kernel), those with a weight read as
# stored or transposed, and the weight gradient) and the float stack entry,
# whose GEMMs run out of line in STACK_GEMM_ITEMS: bf16 on TileGemmBf16,
# float32 on the 3xTF32 tile (csrc/tf32x3_gemm.cuh, mma.sync TF32: HMMA in
# SASS). Both instantiations of each must exist and hold HMMA (a stack entry
# itself or in its items)
GEMM_HMMA_KERNELS = ("gemm_bias_act_kernel", "qkv_proj_kernel",
                     "gemm_bias_residual_ln_kernel", "weight_grad_kernel", "act_and_grad_kernel",
                     "encoder_stack_kernel")
# the float stacks' out-of-line items (stack_block.cu): stack_core_item (a
# template on the element type and the head dim, the W8A8 stacks' too) and
# the three GEMM items (templates on the element type)
STACK_GEMM_ITEMS = ("stack_qkv_item", "stack_gemm_act_item", "stack_residual_ln_item")
CORE_REPORT = ("attn_core_kernel", "encoder_stack_kernel",
               "band_dq_kernel", "band_dkv_kernel", "global_kv_grad_kernel",
               "bigbird_dq_kernel", "bigbird_dkv_kernel", "band_rows_kernel",
               "global_rows_kernel", "bigbird_rows_kernel", "attn_rows_kernel", "attn_dq_kernel",
               "attn_dkv_kernel") + GEMM_HMMA_KERNELS


def template_args(name: str, kernel: str) -> str:
    """The template arguments of a mangled ``kernel<...>`` name, e.g.
    ``13__nv_bfloat16Li64`` or ``fLi64``."""
    return name.split(f"{kernel}I", 1)[1].split("EE", 1)[0]


def is_float32_instance(name: str, kernel: str) -> bool:
    """Whether the mangled ``name`` of a ``kernel`` template takes float as
    its first (element) type: ``<kernel>If...``, bf16 being
    ``<kernel>I13__nv_bfloat16...``."""
    return template_args(name, kernel).startswith("f")


def int8_build_report(log: str) -> list:
    """Registers and spills of the int8 tile's kernels, the dense core's
    functions and the bf16 GEMM tile's kernels and stack items from the
    build's ptxas report (-Xptxas -v), one line a compiled function, with the
    tiles' dynamic shared memory; fails if one of them is missing."""
    from spokennlp_tpu_torch.ops.cuda import build

    lib = build.library()
    smem = {"GemmTileI8": lib.spk_int8_tile_smem(0), "LnTileI8": lib.spk_int8_tile_smem(1),
            "GemmTile bf16": lib.spk_bf16_tile_smem(0), "LnTile bf16": lib.spk_bf16_tile_smem(1),
            "GemmTile float32": lib.spk_bf16_tile_smem(2),
            "LnTile float32": lib.spk_bf16_tile_smem(3)}
    print(f"int8 tiles' dynamic shared memory: GemmTileI8 {smem['GemmTileI8']} bytes "
          f"(gemm_act, gemm_act_quant, qkv_proj), LnTileI8 {smem['LnTileI8']} bytes "
          f"(residual_ln); float tiles' (gemm_bias_act, qkv_proj, act_and_grad; residual_ln): "
          f"bf16 {smem['GemmTile bf16']} / {smem['LnTile bf16']} bytes, float32 (3xTF32) "
          f"{smem['GemmTile float32']} / {smem['LnTile float32']} bytes; a stack kernel takes the "
          f"largest of its phases' needs")
    report, name, spills = [], None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            if any(p in name for p in IMMA_KERNELS + CORE_REPORT + STACK_GEMM_ITEMS):
                regs = line.split("Used")[1].split("registers")[0].strip()
                report.append({"function": name, "registers": int(regs), "spills": spills})
            name, spills = None, None
    for p in IMMA_KERNELS + CORE_REPORT:
        if not any(p in r["function"] for r in report):
            fail(f"the ptxas report has no function for {p}")
    for r in sorted(report, key=lambda r: r["function"]):
        print(f"  ptxas: {r['function']}: {r['registers']} registers; {r['spills']}")
    return report


def cuobjdump_path() -> str:
    """The toolkit's cuobjdump, else Triton's copy."""
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    if Path("/usr/local/cuda/bin/cuobjdump").exists():
        return "/usr/local/cuda/bin/cuobjdump"
    import triton

    bundled = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    if bundled.exists():
        return str(bundled)
    fail("no cuobjdump: the SASS check cannot run")


def sass_verdict(counts: dict) -> list:
    """The SASS check's findings on {mangled function: [IMMA, IDP4A, HMMA]
    counts} (one entry a function of the disassembly): every int8 tile
    kernel (IMMA_KERNELS) holds IMMA; no function outside IDP4A_ALLOWED holds
    IDP4A; both instantiations of each of CORE_HMMA_KERNELS and
    GEMM_HMMA_KERNELS exist and hold HMMA (a stack entry itself or in its
    items of its element type); and no other function holds HMMA. Returns
    the failures, [] when it passes."""
    bad = []
    for p in IMMA_KERNELS:
        found = [n for n in counts if p in n]
        if not found:
            bad.append(f"cuobjdump -sass shows no function for {p}")
        bad += [f"{n} has no IMMA: its int8 products do not run on the tensor cores"
                for n in found if not counts[n][0]]
    stray = [n for n, (_, dp4a, _) in counts.items()
             if dp4a and not any(a in n for a in IDP4A_ALLOWED)]
    if stray:
        bad.append(f"IDP4A outside the int8 attention core and the global query: {stray}")
    # HMMA of the out-of-line items, by their template arguments: the
    # element type (and the head dim of stack_core_item, "<T>Li<HD>")
    core_items, gemm_items = {}, {}
    for n, c in counts.items():
        if "stack_core_itemI" in n:
            f32 = is_float32_instance(n, "stack_core_item")
            args = template_args(n, "stack_core_item")
            core_items[f32, "L" + args.split("L", 1)[1]] = c[2]
            if not c[2]:
                bad.append(f"{n} has no HMMA: the {'float32' if f32 else 'bf16'} stack's core "
                           "does not run on the tensor cores")
        for p in STACK_GEMM_ITEMS:
            if f"{p}I" in n:
                f32 = is_float32_instance(n, p)
                gemm_items[n] = (f32, c[2])
                if not c[2]:
                    bad.append(f"{n} has no HMMA: the {'float32' if f32 else 'bf16'} stack's "
                               "GEMMs do not run on the tensor cores")
    for p in CORE_HMMA_KERNELS + GEMM_HMMA_KERNELS:
        found = [n for n in counts if f"{p}I" in n]
        for want_f32 in (False, True):
            if not any(is_float32_instance(n, p) == want_f32 for n in found):
                bad.append(f"cuobjdump -sass shows no {'float32' if want_f32 else 'bf16'} "
                           f"instantiation of {p}")
        for n in found:
            args, hmma, f32 = template_args(n, p), counts[n][2], is_float32_instance(n, p)
            if p == "encoder_stack_i8_kernel":  # its core item, "<T>Li<HD>"
                hmma += core_items.get((f32, "L" + args.split("L", 1)[1]), 0)
            if p == "encoder_stack_kernel":  # its GEMM items (its core item is read above)
                hmma += sum(h for g, (f, h) in gemm_items.items() if f == f32)
            if not hmma:
                bad.append(f"{n} has no HMMA: its {'float32' if f32 else 'bf16'} products do not "
                           "run on the tensor cores")
    stray = [n for n, c in counts.items()
             if c[2] and not any(f"{p}I" in n for p in CORE_HMMA_KERNELS + GEMM_HMMA_KERNELS
                                 + ("stack_core_item",))
             and n not in gemm_items]
    if stray:
        bad.append(f"HMMA outside the tensor-core functions: {stray}")
    return bad


def sass_check(library: Path) -> dict:
    """Disassembles the built library (cuobjdump -sass) and fails on any
    finding of sass_verdict. Returns {function: (IMMA count, IDP4A count,
    HMMA count)} for the functions that hold any."""
    proc = subprocess.Popen([cuobjdump_path(), "-sass", str(library)], stdout=subprocess.PIPE,
                            text=True)
    counts, name = {}, None
    for line in proc.stdout:
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0, 0]
        elif name is not None:
            counts[name][0] += " IMMA" in line
            counts[name][1] += "IDP.4A" in line or "IDP4A" in line  # __dp4a's SASS
            counts[name][2] += " HMMA" in line
    if proc.wait() != 0:
        fail("cuobjdump -sass failed")
    bad = sass_verdict(counts)
    if bad:
        fail("; ".join(bad))
    held = {n: tuple(c) for n, c in counts.items() if any(c)}
    for n, (imma, dp4a, hmma) in sorted(held.items()):
        print(f"  sass: {n}: {imma} IMMA, {dp4a} IDP4A, {hmma} HMMA")
    print(f"SASS check: {sum(1 for c in held.values() if c[0])} functions run IMMA, "
          f"{sum(1 for c in held.values() if c[2])} HMMA; IDP4A only "
          f"in {sorted({a for n, c in held.items() if c[1] for a in IDP4A_ALLOWED if a in n})}")
    return held


def kernel_phase(device) -> dict:
    """{(name, dtype): row} for the inference kernels at the main path's
    shapes; in float32, the check must reject the attention block with
    bf16 probabilities, in bf16 each of BF16_GEMM_FAULTS planted in the
    plain version. The library column: cuBLAS (torch.matmul) on the block's
    products alone, in the row's dtype (float32 without TF32)."""
    import torch

    from spokennlp_tpu_torch.ops.cuda.attention_block import (
        attention_block_plain, fused_attention_block,
    )
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain

    g = torch.Generator(device=device).manual_seed(0)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    seg = segments(device)
    valid = seg > 0
    M, HN = B * L, NH * HD
    rows = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        # the weights the kernels compute with, given to both sides
        qkv_k = randn(H, 3, NH, HD, scale=H**-0.5).to(dt)
        out_k = randn(NH, HD, H, scale=(NH * HD) ** -0.5).to(dt)
        att = dict(qkv_bias=randn(3, NH, HD, scale=0.02), out_bias=randn(H, scale=0.02))
        ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
        hidden = randn(B, L, H).to(dt)
        call = lambda fn: fn(hidden, seg, qkv_k, att["qkv_bias"], out_k, att["out_bias"],
                             sm_scale=HD**-0.5, **ln)
        rows["fused_attention_block", dtype] = compare(
            "fused_attention_block", dtype, lambda: call(fused_attention_block),
            lambda: call(attention_block_plain), valid,
        )
        if dtype == "bfloat16":
            got = call(fused_attention_block)
            check_bf16_faults("fused_attention_block", got, lambda: call(attention_block_plain),
                              valid)
            rows["fused_attention_block", dtype]["model_err"] = block_model_check(got, call, valid)
            del got
        if dtype == "float32":
            got = call(fused_attention_block)[valid]
            bad = call(attention_block_bf16_probabilities)[valid]
            atol, rtol = limit("fused_attention_block", dtype)
            excess = ((got - bad).abs() - rtol * bad.abs()).max().item()
            print(f"  planted fault, attention block with bf16 probabilities (float32): "
                  f"|err| - {rtol} |ref| up to {excess:.3e} against atol {atol}: "
                  + ("rejected" if excess > atol else "ACCEPTED"))
            if excess <= atol:
                fail("the float32 limit accepts an attention block with bf16 probabilities")
            del got, bad
            # the block and its out projection alone (no residual, no LayerNorm)
            proj = lambda fn: fn(hidden, seg, qkv_k, att["qkv_bias"], out_k, att["out_bias"],
                                 sm_scale=HD**-0.5)
            rows["fused_attention_block", dtype].update(check_f32_forward(
                "fused_attention_block", {"out": call(fused_attention_block)[valid],
                                          "projection": proj(fused_attention_block)[valid]},
                lambda: {"out": call(attention_block_plain)[valid],
                         "projection": proj(attention_block_plain)[valid]}, core=True))
        products, core = 2 * M * H * 3 * HN + 2 * M * HN * H, 4 * B * NH * L * L * HD
        moved = nbytes(hidden, seg, qkv_k, out_k, *att.values(), *ln.values(), hidden)
        rows["fused_attention_block", dtype].update(split_bound(core, products, moved, dtype))
        x2, w_qkv = hidden.reshape(M, H), qkv_k.reshape(H, 3 * HN)
        c2, w_o = randn(M, HN).to(dt), out_k.reshape(HN, H)
        rows["fused_attention_block", dtype]["library_ms"] = library_time(
            lambda: (x2 @ w_qkv, c2 @ w_o), f"fused_attention_block {dtype} (torch.matmul on "
                                            "its two projections)")
        del c2
        x = randn(M, H).to(dt)
        w1, w2 = randn(H, I, scale=H**-0.5).to(dt), randn(I, H, scale=I**-0.5).to(dt)
        b1, b2 = randn(I, scale=0.02), randn(H, scale=0.02)
        mlp = lambda fn, **kw: fn(x, w1, b1, w2, b2, ln["ln_scale"], ln["ln_bias"],
                                  activation="gelu", eps=1e-12, **kw)
        rows["fused_mlp_block", dtype] = compare(
            "fused_mlp_block", dtype, lambda: mlp(fused_mlp_block, quantized=False),
            lambda: mlp(mlp_block_plain), slice(None),
        )
        if dtype == "bfloat16":
            check_bf16_faults("fused_mlp_block", mlp(fused_mlp_block, quantized=False),
                              lambda: mlp(mlp_block_plain), slice(None))
        else:
            rows["fused_mlp_block", dtype].update(check_f32_forward(
                "fused_mlp_block", {"out": mlp(fused_mlp_block, quantized=False)},
                lambda: {"out": mlp(mlp_block_plain)}))
        moved = nbytes(x, w1, b1, w2, b2, *ln.values(), x)
        rows["fused_mlp_block", dtype].update(split_bound(0, 4 * M * H * I, moved, dtype))
        h = randn(M, I).to(dt)
        rows["fused_mlp_block", dtype]["library_ms"] = library_time(
            lambda: (x @ w1, h @ w2), f"fused_mlp_block {dtype} (torch.matmul on its two products)")
        del h
    return rows


def library_time(fn, name) -> float:
    """ms of one PyTorch call that computes the same function (the row's
    library_ms), CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = time_ms(fn)
    print(f"  library call for {name}: {ms:.3f} ms")
    return ms


def mlp_w8a8_bf16_intermediate(x, w1, b1, w2, b2, ln_scale, ln_bias):
    """A planted fault: the W8A8 MLP block (GELU) with its float32
    intermediate rounded to bf16 before its row quantisation."""
    import torch
    import torch.nn.functional as F

    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im

    (w1q, sw1), (w2q, sw2) = im.quantize_colwise(w1), im.quantize_colwise(w2)
    x8, sx = im.rowquant_plain(x.float())
    h = im.ACTIVATIONS["gelu"](im.int8_product(x8, w1q) * sx * sw1 + b1)
    h8, sh = im.rowquant_plain(h.to(torch.bfloat16).float())
    y = im.int8_product(h8, w2q) * sh * sw2 + b2
    return F.layer_norm(y + x.float(), (x.shape[1],), ln_scale, ln_bias, eps=1e-12).to(x.dtype)


# planted faults of the W8A8 long-context blocks and the last two kernel
# modes, each planted by patching the one helper of the plain version that
# it changes (planted()); each, at the phase's shapes, must fail w8a8_check
# against the plain version (tests/test_torch_w8a8_long.py holds the same at
# small shapes)
LONG_W8A8_FAULTS = ("one x scale for the batch", "one ctx scale for the batch",
                    "one scale for the QKV weights", "ctx unquantised", "ctx quantised per head")
# In bf16 the check's rounding (2e-3 + 2^-7 |ref|) is about what an int8 step
# of ctx moves an output (PERF.md: 0.07-0.22 % of the outputs beyond it), so
# there the faults that change ctx's quantisation by its own noise are
# printed with their reading; they are gated in float32, which is the bf16
# path's coverage of ctx's quantisation (ctx is float32 in both modes), and
# the faults that move every row are gated in both.
BF16_GATED_FAULTS = LONG_W8A8_FAULTS[:3]
# a fault the check may not tell apart, printed with its reading, not gated:
# a ctx rounded to bf16 (in bf16 that moves it by less than the output's
# own rounding)
CTX_BF16_FAULT = "ctx rounded to bf16 before its quantisation"
# kernel 7's global query projected with the local q weights: it moves the
# global rows only (one a sequence), so it is checked on them alone
GLOBAL_FAULT = "global query from the local q weights"
CORE_MLP_FAULTS = ("static-scale MLP with per-row scales",
                   "int8 core with q and k scales over the batch",
                   "int8 core summing the rounded p8 in its denominator")


def rowquant_per_tensor(x):
    """A planted fault's quantiser: one scale for all rows of (M, K) x."""
    import torch

    s = x.float().abs().amax().clamp_min(1e-6) * (1.0 / 127.0)
    q = torch.round(x.float() * (1.0 / s)).clamp(-127, 127).to(torch.int8)
    return q, s.expand(x.shape[0], 1)


def colquant_per_tensor(w):
    """A planted fault's weight quantiser: one scale for all columns of
    (..., K, N) w, returned per column as quantize_colwise returns it."""
    import torch

    wf = w.float()
    s = wf.abs().amax().clamp_min(1e-6) / 127.0
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return q, s.expand(*wf.shape[:-2], 1, wf.shape[-1]).contiguous()


@contextlib.contextmanager
def planted(patches):
    """Plant a fault in a plain version: each (owner, name, call, stand_in)
    sends the ``call``-th call (from 0; None: every call) of owner.name to
    stand_in(the real function, *its arguments, **its keyword arguments)."""
    from unittest import mock

    with contextlib.ExitStack() as stack:
        for owner, name, call, stand_in in patches:
            def patched(*args, real=getattr(owner, name), calls=itertools.count(), call=call,
                        stand_in=stand_in, **kw):
                i = next(calls)
                return (stand_in(real, *args, **kw) if call is None or i == call
                        else real(*args, **kw))

            stack.enter_context(mock.patch.object(owner, name, patched))
        yield


def long_w8a8_faults(block, num_heads: int) -> dict:
    """{fault: patches for planted()} of the W8A8 plain version of kernel 7
    (``block`` ops/cuda/sliding_block.py) or kernel 8 (bigbird_block.py)
    with ``num_heads`` heads. In both, rowquant_plain's first call
    quantises x and its second ctx, and quantize_colwise's first call the
    QKV weights; the ctx faults hand the out projection float values with a
    scale of 1."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import attention_block as ab
    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb

    def ctx_as(values):
        def quant(real, c):
            return values(real, c), torch.ones_like(c[:, :1])

        def product(real, a, b):
            return real(a, b) if a.dtype == torch.int8 else (a.double() @ b.double()).float()

        return [(block, "rowquant_plain", 1, quant), (block, "int8_product", None, product)]

    def per_head(real, c):
        c8, s = real(c, num_heads)
        return (c8.float().reshape(len(c), num_heads, -1) * s[..., None]).reshape(c.shape)

    def global_q_local(real, *args):
        w = real(*args)
        n = w["wgq8"].shape[1]
        return dict(w, wgq8=w["wqkv8"][:, :n].contiguous(), swgq=w["swqkv"][:n].contiguous())

    x_scale, ctx_scale, w_scale, ctx_float, ctx_head = LONG_W8A8_FAULTS
    faults = {x_scale: [(block, "rowquant_plain", 0, lambda real, x: rowquant_per_tensor(x))],
              ctx_scale: [(block, "rowquant_plain", 1, lambda real, c: rowquant_per_tensor(c))],
              w_scale: [(sb if block is sb else ab, "quantize_colwise", 0,
                         lambda real, w: colquant_per_tensor(w))],
              ctx_float: ctx_as(lambda real, c: c.float()),
              ctx_head: ctx_as(per_head),
              CTX_BF16_FAULT: [(block, "rowquant_plain", 1,
                                lambda real, c: real(c.to(torch.bfloat16)))]}
    if block is sb:
        faults[GLOBAL_FAULT] = [(sb, "quantize_sliding_weights", None, global_q_local)]
    return faults


def core_mlp_fault(fault, att, mlp, *, sm_scale, hb):
    """(the block with ``fault``, its plain version, the rows to compare):
    the static-scale MLP block run with per-row scales, or the W8A8
    attention block with a faulty int8 core ("qk" or "av", ``hb`` heads a
    group). ``att``: fused_attention_block's tensors by name; ``mlp``:
    fused_mlp_block's in order."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import attention_block as ab
    from spokennlp_tpu_torch.ops.cuda.mlp_block import mlp_block_plain

    if fault == CORE_MLP_FAULTS[0]:
        kw = dict(activation="gelu", eps=1e-12, quantized=True)
        return (mlp_block_plain(*mlp.values(), **kw),
                mlp_block_plain(*mlp.values(), **kw, static_h_scale=True), slice(None))

    def over_batch(real, t, groups):  # the batch quantised as one sequence
        t8, s = real(t.reshape(1, -1, *t.shape[2:]), groups)
        return t8.reshape(t.shape), s.expand(t.shape[0], -1)

    core, patch = (("qk", (ab, "core_int8_quantize", None, over_batch)) if "batch" in fault else
                   ("av", (ab, "core_int8_denominator", None,
                           lambda real, p: real(torch.round(p).clamp(0, 127)))))
    kw = dict(sm_scale=sm_scale, quantized=True, heads_per_block=hb, core_int8=core)
    want = ab.attention_block_plain(**att, **kw)
    with planted([patch]):
        got = ab.attention_block_plain(**att, **kw)
    return got, want, att["segment_ids"] > 0


def core_faults() -> dict:
    """{fault: patch for planted()} of CORE_FAULTS in kernel 6's rounding
    model: the rescale alpha replaced by 1, or the allowed mask by the
    padding mask (seg_k > 0 alone)."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import blhd_attention as ba

    alpha, mask = CORE_FAULTS
    return {alpha: (ba, "core_alpha", None, lambda real, m_old, m_new: torch.ones_like(m_new)),
            mask: (ba, "core_allowed", None,
                   lambda real, s: (s[:, None, :] > 0)[:, None].expand(-1, -1, s.shape[1], -1))}


def core_limit(want, dtype: str) -> float:
    """CORE_GATE's limit on max |err| against the outputs `want`."""
    rel, atol = CORE_GATE[dtype]
    return rel * want.float().abs().max().item() + atol


def core_model_check(qkv, seg, valid, dtype: str) -> dict:
    """Kernel 6 against its own rounding model (snld_attention_plain; in
    float32 its products on the 3xTF32 model) on the valid rows within
    CORE_GATE (in float32 SNLD_F32_GATE: its exponent is bf16); each of
    CORE_FAULTS, planted in the model, and in float32 F32_CORE_FAULT, must
    fail that gate. Returns the reading."""
    from spokennlp_tpu_torch.ops.cuda import blhd_attention as ba

    (rel, atol), norm_lim = (SNLD_F32_GATE if dtype == "float32"
                             else (CORE_GATE[dtype], math.inf))

    def reading(got, want):
        g, w = got[valid].float(), want[valid].float()
        return (g - w).abs().max().item(), ((g - w).norm() / w.norm().clamp_min(1e-30)).item()

    scale = HD**-0.5
    model = core_products(tf32x3_model) if dtype == "float32" else []
    with planted(model):
        want = ba.snld_attention_plain(qkv, seg, scale)
    lim = rel * want[valid].float().abs().max().item() + atol
    err, norm = reading(ba.snld_self_attention(qkv, seg, scale), want)
    print(f"  snld_self_attention {dtype} against its rounding model: max |err| {err:.3e} "
          f"(limit {lim:.3e} = {rel:.3g} max |ctx| + {atol}), norm {norm:.3e} (limit {norm_lim})")
    if err > lim or norm > norm_lim:
        fail(f"snld_self_attention {dtype}: max |err| {err:.3e} / norm {norm:.3e} against its "
             f"rounding model exceeds {lim:.3e} / {norm_lim}")
    faults = {what: model + [patch] for what, patch in core_faults().items()}
    if dtype == "float32":
        faults[F32_CORE_FAULT] = core_products(plain_tf32)
    out = {"model_err": err, "model_limit": lim, "model_norm": norm}
    for what, patches in faults.items():
        with planted(patches):
            bad = ba.snld_attention_plain(qkv, seg, scale)
        e, n = reading(bad, want)
        rejected = e > lim or n > norm_lim
        print(f"  planted fault, core {what} ({dtype}): max |err| {e:.3e}, norm {n:.3e}: "
              + ("rejected" if rejected else "PASSES the gate"))
        if not rejected:
            fail(f"the core gate lets a planted fault through: {what} ({dtype})")
        if what == F32_CORE_FAULT:
            out.update(model_core_fault_err=e, model_core_fault_norm=n)
    return out


def w8a8_kernel_phase(device) -> dict:
    """{(name, dtype): row} for kernels 4, 5 and 6 and the W8A8 modes of 1 and
    2 at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im
    from spokennlp_tpu_torch.ops.cuda.attention_block import (
        attention_block_plain, fused_attention_block, quantize_attention_weights,
    )
    from spokennlp_tpu_torch.ops.cuda.blhd_attention import (
        reference_snld_attention, snld_self_attention,
    )
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain

    g = torch.Generator(device=device).manual_seed(3)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    seg = segments(device)
    valid = seg > 0
    M, HN = B * L, NH * HD
    rows = {}

    # kernels 5 and 4 over one layer's four projections (K x N, activation),
    # with bf16 and with float32 activations (kernel 4's input and both
    # kernels' output)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        k5 = {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0, "library_ms": 0.0, "err": 0.0}
        k4 = dict(k5)
        prods = []
        for K, N, act in ((H, 3 * HN, "none"), (HN, H, "none"), (H, I, "gelu"), (I, H, "none")):
            x = randn(M, K).to(dt)
            w, bias = randn(K, N, scale=K**-0.5), randn(N, scale=0.02)
            w8, sw = im.quantize_colwise(w)
            x8, sx = im.rowquant_plain(x)
            prods.append((x8, sx, w8, sw, bias, dt, act))
            label = f"{K}x{N} {act} {dtype}"
            # the int32 accumulators: unit scales, float32 output = float(acc)
            ones = lambda n: torch.ones(n, device=device)
            acc = im.w8a8_matmul(x8, ones(M), w8, ones(N), out_dtype=torch.float32)
            if not torch.equal(acc, im.int8_product(x8, w8)):
                fail(f"w8a8_matmul {label}: int32 accumulators differ from the exact product")
            qx8, qsx = im.rowquant_cuda(x)
            if not (torch.equal(qx8, x8) and torch.equal(qsx, sx)):
                fail(f"w8a8_matmul_bf16in {label}: the row quantiser differs from rowquant_plain")
            print(f"w8a8 {label}: int32 accumulators exact; row quantiser equal")
            r5 = compare(f"w8a8_matmul {label}", dtype,
                         lambda: im.w8a8_matmul(x8, sx, w8, sw, bias, dt, act),
                         lambda: im.w8a8_matmul_plain(x8, sx, w8, sw, bias, dt, act),
                         slice(None), tol=MATMUL_TOL[dtype])
            r4 = compare(f"w8a8_matmul_bf16in {label}", dtype,
                         lambda: im.w8a8_matmul_bf16in(x, w8, sw, bias, dt, act),
                         lambda: im.w8a8_matmul_plain(*im.rowquant_plain(x), w8, sw, bias, dt,
                                                      act),
                         slice(None), tol=MATMUL_TOL[dtype])
            # the library yardstick: cuBLAS's int8 product alone (torch._int_mm),
            # on the same int8 operands, B in the column-major layout it takes
            w8t = w8.t().contiguous().t()
            lib = library_time(lambda: torch._int_mm(x8, w8t), f"w8a8 {label} (torch._int_mm)")
            out_bytes = M * N * dt.itemsize
            for tot, r, in_bytes in ((k5, r5, nbytes(x8, sx, w8, sw, bias)),
                                     (k4, r4, nbytes(x, w8, sw, bias))):
                tot["ms"] += r["ms"]
                tot["plain_ms"] += r["plain_ms"]
                tot["err"] = max(tot["err"], r["max_abs_err"])
                tot["flops"] += 2 * M * K * N
                tot["bytes"] += in_bytes + out_bytes
                tot["library_ms"] += lib
        for name, tot in (("w8a8_matmul", k5), ("w8a8_matmul_bf16in", k4)):
            row = {"max_abs_err": tot["err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                   **bound({"int8": tot["flops"]}, tot["bytes"])}
            row["library_ms"] = tot["library_ms"]
            rows[name, dtype] = row
            print(f"kernel {name} {dtype} (a layer's four projections): kernel {row['ms']:.3f} ms "
                  f" plain {row['plain_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms "
                  f"({row['bound_by']})  torch._int_mm {row['library_ms']:.3f} ms")
        print(f"kernel 5 {dtype}: {k5['flops'] / k5['ms'] / 1e9:.1f} TOPS over a layer's four "
              f"projections, {k5['ms'] / k5['library_ms']:.2f} x torch._int_mm's time "
              f"({k5['flops'] / k5['library_ms'] / 1e9:.1f} TOPS)")
        # the row's time sums each projection timed alone, in turns with its
        # plain version; a layer runs the four back to back
        loop = lambda: [im.w8a8_matmul(*p) for p in prods]
        loop()
        torch.cuda.synchronize()
        ms = time_ms(loop, 20)
        print(f"kernel 5 {dtype}, the four projections back to back: {ms:.3f} ms, "
              f"{k5['flops'] / ms / 1e9:.1f} TOPS, {ms / k5['library_ms']:.2f} x torch._int_mm's "
              f"time")

    # the W8A8 modes of kernels 1 and 2: float32 weights, quantised in the wrapper
    core = 4 * B * NH * L * L * HD
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        qkv_k, out_k = randn(H, 3, NH, HD, scale=H**-0.5), randn(NH, HD, H, scale=HN**-0.5)
        att = dict(qkv_bias=randn(3, NH, HD, scale=0.02), out_bias=randn(H, scale=0.02))
        ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
        hidden = randn(B, L, H).to(dt)
        att_call = lambda fn, hb, quantized=True: fn(
            hidden, seg, qkv_k, att["qkv_bias"], out_k, att["out_bias"], sm_scale=HD**-0.5,
            quantized=quantized, heads_per_block=hb, **ln)
        for hb in (NH, NH // 2):
            # float32: ctx from the 3xTF32 core, then row-quantised: the plain
            # version on the kernel's own core (on_card_core)
            row = compare(f"fused_attention_block W8A8 heads_per_block={hb}", dtype,
                          lambda: att_call(fused_attention_block, hb),
                          lambda: att_call(attention_block_plain, hb), valid, w8a8=True,
                          model=lambda: on_card_core(
                              dtype, lambda: att_call(attention_block_plain, hb)))
            if hb == NH:
                ops = {"int8": 2 * M * H * 3 * HN + 2 * M * HN * H, dtype: core}
                moved = nbytes(hidden, seg, qkv_k, out_k, *att.values(), *ln.values(), hidden)
                row = {**row, **bound(ops, moved)}
                # the library column: torch._int_mm on the block's two products only
                wqkv8, _, wo8, _ = quantize_attention_weights(qkv_k, out_k, 1)
                x8 = im.rowquant_plain(hidden.reshape(M, H))[0]
                row["library_ms"] = int_mm_time(
                    [(x8, wqkv8), (x8, wo8)], f"fused_attention_block W8A8 {dtype}")
                rows["fused_attention_block_w8a8", dtype] = row
        x = randn(M, H).to(dt)
        w1, w2 = randn(H, I, scale=H**-0.5), randn(I, H, scale=I**-0.5)
        b1, b2 = randn(I, scale=0.02), randn(H, scale=0.02)
        mlp = lambda fn, quantized=True: fn(x, w1, b1, w2, b2, ln["ln_scale"], ln["ln_bias"],
                                            activation="gelu", eps=1e-12, quantized=quantized)
        row = compare("fused_mlp_block W8A8", dtype, lambda: mlp(fused_mlp_block),
                      lambda: mlp(mlp_block_plain), slice(None), w8a8=True)
        moved = nbytes(x, w1, b1, w2, b2, *ln.values(), x)
        row = {**row, **bound({"int8": 4 * M * H * I}, moved)}
        x8 = im.rowquant_plain(x)[0]
        h8 = im.rowquant_plain(randn(M, I))[0]
        row["library_ms"] = int_mm_time([(x8, im.quantize_colwise(w1)[0]),
                                         (h8, im.quantize_colwise(w2)[0])],
                                        f"fused_mlp_block W8A8 {dtype}")
        print(f"kernel 2 W8A8 {dtype}: {row['ms']:.3f} ms, "
              f"{row['ms'] / row['library_ms']:.2f} x torch._int_mm on its two products")
        rows["fused_mlp_block_w8a8", dtype] = row
        del x8, h8

        # the check has teeth: each fault, planted once, fails it
        hb = NH // 2
        want_att = on_card_core(dtype, lambda: att_call(attention_block_plain, hb))
        want_mlp = mlp(mlp_block_plain)
        planted = {
            "attention block ignoring heads_per_block":
                (att_call(fused_attention_block, NH), want_att, valid),
            "attention block not quantising":
                (att_call(fused_attention_block, hb, quantized=False), want_att, valid),
            "MLP rounding its intermediate to bf16 before quantising it":
                (mlp_w8a8_bf16_intermediate(x, w1, b1, w2, b2, **ln), want_mlp, slice(None)),
            "MLP block not quantising": (mlp(fused_mlp_block, False), want_mlp, slice(None)),
        }
        check_planted(planted, dtype)
        del planted, want_att, want_mlp

        # kernel 6 over a projected qkv; yardstick: scaled_dot_product_attention
        # with the segment mask as a boolean attn_mask (the same function on
        # real rows)
        qkv = randn(B, 3, NH, L, HD).to(dt)
        row = compare("snld_self_attention", dtype,
                      lambda: snld_self_attention(qkv, seg, HD**-0.5),
                      lambda: reference_snld_attention(qkv, seg, HD**-0.5),
                      valid[:, None, :].expand(B, NH, L), tol=SNLD_TOL[dtype])
        row.update(core_model_check(qkv, seg, valid[:, None, :].expand(B, NH, L), dtype))
        allowed = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0))[:, None]
        q, k, v = qkv.unbind(1)
        row.update(bound(core, nbytes(qkv, seg, qkv[:, 0]), dtype))
        row["library_ms"] = library_time(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed, scale=HD**-0.5),
            f"snld_self_attention {dtype} (scaled_dot_product_attention)")
        row["tflops"] = core / row["ms"] / 1e9
        print(f"kernel 6 {dtype}: {row['tflops']:.1f} TFLOP/s, {row['ms'] / row['library_ms']:.2f} x "
              f"scaled_dot_product_attention's time ({core / row['library_ms'] / 1e9:.1f} TFLOP/s)")
        rows["snld_self_attention", dtype] = row
        torch.cuda.empty_cache()
    return rows


def core_columns(rows: dict, device):
    """The dense core's columns of rows 1, 1 W8A8 and 3 at B=32, L=512, 12
    heads of 64. Rows 1 and 1 W8A8: the core alone at the blocks' own launch
    (attention_block.attention_core: the launch both blocks make, on a qkv
    buffer in their (3, B, nh, L, hd) layout from the QKV projection, q
    scaled, the exponent in the element type), held to CORE_GATE against
    its rounding model, each row timing it ("core_ms") and
    scaled_dot_product_attention on the same q, k, v ("core_library_ms").
    Row 3 runs its cores inside the stack kernel, where they are not timed:
    its row takes LAYERS of those library calls back to back, and the
    chain's cores (LAYERS x the block's) are printed apart as derived."""
    import torch
    import torch.nn.functional as F

    from spokennlp_tpu_torch.ops.cuda.attention_block import (
        attention_core, attention_core_plain,
    )
    from spokennlp_tpu_torch.ops.cuda.blhd_attention import snld_attention_plain

    g = torch.Generator(device=device).manual_seed(9)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    seg = segments(device)
    valid = seg > 0
    allowed = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0))[:, None]
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        hidden, w = randn(B, L, H), randn(H, 3, NH, HD, scale=H**-0.5)
        qkv = torch.einsum("blh,hsnd->sbnld", hidden, w) + randn(3, 1, NH, 1, HD, scale=0.02)
        qkv[0] *= HD**-0.5
        qkv = qkv.to(dt).contiguous()
        # the rounding model: exp in bf16 (snld_attention_plain) or float32,
        # whose products are on the 3xTF32 model
        def model():
            if dtype == "bfloat16":
                return snld_attention_plain(qkv.transpose(0, 1), seg, 1.0).transpose(1, 2)
            q, k, v = (t.transpose(1, 2) for t in qkv.unbind(0))
            return attention_core_plain(q, k, v, seg, torch.float32)

        with planted(core_products(tf32x3_model) if dtype == "float32" else []):
            want = model()
        got = attention_core(qkv, seg).reshape(B, L, NH, HD)
        err = (got[valid].float() - want[valid].float()).abs().max().item()
        lim = core_limit(want[valid], dtype)
        print(f"  the blocks' core {dtype} against its rounding model: max |err| {err:.3e} "
              f"(limit {lim:.3e})")
        if not (torch.isfinite(got).all() and err <= lim):
            fail(f"attention_core {dtype}: max |err| {err:.3e} against its rounding model "
                 f"exceeds {lim:.3e}")
        for name in ("fused_attention_block", "fused_attention_block_w8a8"):
            rows[name, dtype].update(core_err=err, core_limit=lim)
        if dtype == "float32":  # plain TF32 in the model's products must fail the gate
            with planted(core_products(plain_tf32)):
                bad = (model()[valid].float() - got[valid].float()).abs().max().item()
            print(f"  planted fault, the blocks' core with {F32_CORE_FAULT}: max |err| {bad:.3e}: "
                  + ("rejected" if bad > lim else "PASSES the gate"))
            if bad <= lim:
                fail(f"the float32 core gate lets {F32_CORE_FAULT} through")
            rows["fused_attention_block", dtype]["core_fault_err"] = bad
        q, k, v = qkv.unbind(0)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed, scale=1.0)
        for name in ("fused_attention_block", "fused_attention_block_w8a8"):
            row = rows[name, dtype]
            attention_core(qkv, seg)
            torch.cuda.synchronize()
            row["core_ms"] = time_ms(lambda: attention_core(qkv, seg))
            row["core_library_ms"] = library_time(sdpa, f"{name} {dtype}'s core "
                                                        "(scaled_dot_product_attention)")
            print(f"kernel {name} {dtype}: its dense core alone {row['core_ms']:.3f} ms, "
                  f"scaled_dot_product_attention {row['core_library_ms']:.3f} ms; the row's "
                  f"library column: {row['library_ms']}")
        row = rows["fused_encoder_stack", dtype]
        row["core_library_ms"] = library_time(lambda: [sdpa() for _ in range(LAYERS)],
                                              f"fused_encoder_stack {dtype}'s {LAYERS} cores")
        print(f"kernel fused_encoder_stack {dtype}: {LAYERS} scaled_dot_product_attention calls "
              f"{row['core_library_ms']:.3f} ms; derived, not measured: the chain's cores "
              f"{LAYERS} x {rows['fused_attention_block', dtype]['core_ms']:.3f} = "
              f"{LAYERS * rows['fused_attention_block', dtype]['core_ms']:.3f} ms (the stack's "
              f"own run inside it, untimed)")
        del hidden, w, qkv, want, got
        torch.cuda.empty_cache()


def stack_kernel_phase(device) -> dict:
    """{(mode, dtype): row} for kernel 3 over all LAYERS at the main path's
    shapes: W8A8 and the float modes, against the plain loop of layers and
    against the chain of kernels 1 and 2."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im
    from spokennlp_tpu_torch.ops.cuda.attention_block import (
        fused_attention_block, quantize_attention_weights,
    )
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack, stack_plain

    g = torch.Generator(device=device).manual_seed(4)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    seg = segments(device)
    valid = seg > 0
    M, HN, NL = B * L, NH * HD, LAYERS
    p = [randn(NL, H, 3, NH, HD, scale=H**-0.5), randn(NL, 3, NH, HD, scale=0.02),
         randn(NL, NH, HD, H, scale=HN**-0.5), randn(NL, H, scale=0.02),
         1 + randn(NL, H, scale=0.1), randn(NL, H, scale=0.1), randn(NL, H, I, scale=H**-0.5),
         randn(NL, I, scale=0.02), randn(NL, I, H, scale=I**-0.5), randn(NL, H, scale=0.02),
         1 + randn(NL, H, scale=0.1), randn(NL, H, scale=0.1)]
    rows = {}
    for quantized, dtype in ((True, "bfloat16"), (False, "bfloat16"), (False, "float32")):
        dt = getattr(torch, dtype)
        mode = "W8A8" if quantized else "float"
        hidden = randn(B, L, H).to(dt)
        # the float modes compute with the weight matrices rounded to dt
        ps = [t.to(dt) if i in (0, 2, 6, 8) and not quantized else t for i, t in enumerate(p)]
        kernel = lambda: fused_encoder_stack(hidden, seg, *p, sm_scale=HD**-0.5,
                                             quantized=quantized)
        plain = lambda: stack_plain(hidden, seg, *ps, sm_scale=HD**-0.5, quantized=quantized)

        def chain():
            h = hidden
            for l in range(NL):
                h = fused_attention_block(h, seg, *(t[l] for t in p[:4]), sm_scale=HD**-0.5,
                                          ln_scale=p[4][l], ln_bias=p[5][l], quantized=quantized)
                h = fused_mlp_block(h.reshape(M, H), *(t[l] for t in p[6:]), activation="gelu",
                                    eps=1e-12, quantized=quantized).reshape(B, L, H)
            return h

        got, want, links = kernel(), plain(), chain()
        torch.cuda.synchronize()
        label = f"fused_encoder_stack {mode} {dtype}, {NL} layers"
        if not torch.isfinite(got[valid]).all():
            fail(f"{label}: non-finite output")
        if not torch.equal(got[valid], links[valid]):
            e = (got[valid].float() - links[valid].float()).abs().max().item()
            fail(f"{label}: differs from the chain of kernels 1 and 2 (max |err| {e:.3e})")
        e = (got[valid].float() - want[valid].float()).abs().max().item()
        rel, limit = e / want[valid].float().abs().max().item(), STACK_TOL[mode, dtype]
        print(f"  {label}: bit-identical to the chain of kernels 1 and 2; against the plain "
              f"loop max |err| {e:.3e}, / max |ref| {rel:.3e} (limit {limit})")
        if rel > limit:
            fail(f"{label}: against the plain loop, max|err|/max|ref| {rel:.3e} > {limit}")
        gate = {}
        if dtype == "float32":  # the loop of layers on the 3xTF32 model, plain TF32 planted
            gate = check_f32_forward(label, {"out": got[valid]}, lambda: {"out": plain()[valid]},
                                     (limit, F32_FWD_TOL[1]), core=True, gate_core_fault=False)
        times = timed_pair(kernel, plain, reps=3)
        chain_ms = time_ms(chain, reps=3)
        layer = 2 * M * H * 3 * HN + 2 * M * HN * H + 4 * M * H * I
        core = NL * 4 * B * NH * L * L * HD
        n_bytes = nbytes(hidden, seg, *p, hidden)
        ops = (bound({"int8": NL * layer, core_type(dtype): core}, n_bytes) if quantized
               else split_bound(core, NL * layer, n_bytes, dtype))
        row = {"max_abs_err": e, **gate, **times, **ops, "chain_ms": chain_ms,
               "grid": fused_encoder_stack.grid}
        if quantized:  # the library column: torch._int_mm on the 4 NL products only
            x8 = im.rowquant_plain(hidden.reshape(M, H))[0]
            h8 = im.rowquant_plain(randn(M, I))[0]
            wqkv8, _, wo8, _ = quantize_attention_weights(p[0], p[2], 1)
            w18, w28 = im.quantize_colwise(p[6])[0], im.quantize_colwise(p[8])[0]
            row["library_ms"] = int_mm_time(
                [pair for l in range(NL) for pair in ((x8, wqkv8[l]), (x8, wo8[l]),
                                                      (x8, w18[l]), (h8, w28[l]))],
                f"fused_encoder_stack {mode} {dtype}")
            del x8, h8, wqkv8, wo8, w18, w28
        else:  # the library column: torch.matmul on the 4 NL products only
            x2, h2 = hidden.reshape(M, H), randn(M, I).to(dt)
            c2 = randn(M, HN).to(dt)
            ws = [(x2, ps[0][l].reshape(H, 3 * HN)) for l in range(NL)]
            ws += [(c2, ps[2][l].reshape(HN, H)) for l in range(NL)]
            ws += [(x2, ps[6][l]) for l in range(NL)] + [(h2, ps[8][l]) for l in range(NL)]
            row["library_ms"] = library_time(lambda: [a @ w for a, w in ws],
                                             f"fused_encoder_stack {mode} {dtype} (torch.matmul "
                                             f"on its {4 * NL} products)")
            del x2, h2, c2, ws
        rows[mode, dtype] = row
        print(f"kernel {label}: kernel {row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms  chain "
              f"of kernels 1+2 {chain_ms:.3f} ms  bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}); grid {row['grid']} blocks")
        del got, want, links
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ training kernels


def _normalized_errors(got, want, names, dtype, label, kernel):
    """max |got - want| / max |want| for each named output; fails above the
    kernel's limit. Returns the largest absolute error over all outputs."""
    import torch

    worst_abs, parts = 0.0, []
    for name, gt, wt in zip(names, got, want):
        gt, wt = gt.float(), wt.float()
        if not torch.isfinite(gt).all():
            fail(f"{label}: non-finite {name}")
        abs_err = (gt - wt).abs().max().item()
        rel = abs_err / max(wt.abs().max().item(), 1e-30)
        worst_abs = max(worst_abs, abs_err)
        parts.append(f"{name} {rel:.2e}")
        if rel > limit(kernel, dtype):
            fail(f"{label}: {name} max|err|/max|ref| {rel:.3e} > {limit(kernel, dtype)}")
    print(f"  {label}: " + ", ".join(parts))
    return worst_abs


def train_kernel_phase(device) -> dict:
    """{(name, dtype): row} for the four training kernels."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    g = torch.Generator(device=device).manual_seed(1)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    seg = segments(device)
    seed = torch.tensor([20231016], dtype=torch.int32, device=device)
    keep = tb.dropout_keep_mask(seed, B, NH, L, DROPOUT)
    frac = keep.float().mean().item()
    print(f"dropout keep fraction over one ({B}, {NH}, {L}, {L}) mask: {frac:.6f}")
    if abs(frac - (1.0 - DROPOUT)) > KEEP_FRACTION_TOL:
        fail(f"keep fraction {frac:.6f} not within {KEEP_FRACTION_TOL} of {1.0 - DROPOUT}")
    M, HN, sm = B * L, NH * HD, HD**-0.5
    att_names = ("out", "dx", "dqkv_kernel", "dqkv_bias", "dout_kernel", "dout_bias")
    mlp_names = ("out", "dx", "dw1", "db1", "dw2", "db2")
    rows = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        att_p = dict(qkv_kernel=randn(H, 3, NH, HD, scale=H**-0.5),
                     qkv_bias=randn(3, NH, HD, scale=0.02),
                     out_kernel=randn(NH, HD, H, scale=HN**-0.5), out_bias=randn(H, scale=0.02))
        hidden, cot = randn(B, L, H).to(dt), randn(B, L, H).to(dt)
        mlp_p = dict(w1=randn(H, I, scale=H**-0.5), b1=randn(I, scale=0.02),
                     w2=randn(I, H, scale=I**-0.5), b2=randn(H, scale=0.02))
        x, cot2 = randn(M, H).to(dt), randn(M, H).to(dt)
        err = {k: 0.0 for k in ("attention_train_fwd", "attention_train_bwd", "mlp_train_fwd",
                                 "mlp_train_bwd")}
        for rate in (0.0, DROPOUT):
            keep_r = keep if rate else None
            # kernels through the autograd wrapper; the plain version on the
            # weights rounded as the kernels round them, gradients by autograd
            leaves = {k: v.detach().requires_grad_() for k, v in att_p.items()}
            h = hidden.detach().requires_grad_()
            out = tb.attention_block_train(h, seg, *leaves.values(), seed, sm_scale=sm,
                                           dropout_rate=rate)
            got = [out, *torch.autograd.grad(out, [h, *leaves.values()], cot)]
            ref = {k: (v.to(dt) if k.endswith("kernel") else v).detach().requires_grad_()
                   for k, v in att_p.items()}
            h = hidden.detach().requires_grad_()
            out = tb.attention_train_plain(h, seg, *ref.values(), sm_scale=sm, dropout_rate=rate,
                                           keep=keep_r)
            want = [out, *torch.autograd.grad(out, [h, *ref.values()], cot)]
            label = f"attention_train {dtype} rate {rate}"
            err["attention_train_fwd"] = max(err["attention_train_fwd"], _normalized_errors(
                got[:1], want[:1], att_names[:1], dtype, label + " fwd", "attention_train_fwd"))
            err["attention_train_bwd"] = max(err["attention_train_bwd"], _normalized_errors(
                got[1:], want[1:], att_names[1:], dtype, label + " bwd", "attention_train_bwd"))
            if dtype == "float32" and rate:  # F32_CORE_FAULT in the plain core, autograd and all
                ref = {k: v.detach().requires_grad_() for k, v in ref.items()}
                h = hidden.detach().requires_grad_()
                with planted(core_products(plain_tf32)):
                    out = tb.attention_train_plain(h, seg, *ref.values(), sm_scale=sm,
                                                   dropout_rate=rate, keep=keep_r)
                    bad = [out, *torch.autograd.grad(out, [h, *ref.values()], cot)]
                core_fault = f32_tol_fault(got, bad, att_names, "attention_train")

            leaves = {k: v.detach().requires_grad_() for k, v in mlp_p.items()}
            xx = x.detach().requires_grad_()
            out = tb.mlp_block_train(xx, *leaves.values())
            got = [out, *torch.autograd.grad(out, [xx, *leaves.values()], cot2)]
            ref = {k: (v.to(dt) if k.startswith("w") else v).detach().requires_grad_()
                   for k, v in mlp_p.items()}
            xx = x.detach().requires_grad_()
            out = tb.mlp_train_plain(xx, *ref.values(), activation="gelu")
            want = [out, *torch.autograd.grad(out, [xx, *ref.values()], cot2)]
            label = f"mlp_train {dtype} rate {rate}"
            err["mlp_train_fwd"] = max(err["mlp_train_fwd"], _normalized_errors(
                got[:1], want[:1], mlp_names[:1], dtype, label + " fwd", "mlp_train_fwd"))
            err["mlp_train_bwd"] = max(err["mlp_train_bwd"], _normalized_errors(
                got[1:], want[1:], mlp_names[1:], dtype, label + " bwd", "mlp_train_bwd"))

        # times at the training path's rate, the kernels called directly
        wqkv = att_p["qkv_kernel"].to(dt).reshape(H, 3 * HN).contiguous()
        bqkv = att_p["qkv_bias"].reshape(-1).contiguous()
        wo = att_p["out_kernel"].to(dt).reshape(HN, H).contiguous()
        bo = att_p["out_bias"]
        kw = dict(num_heads=NH, sm_scale=sm, dropout_rate=DROPOUT)
        ref = {k: (v.to(dt) if k.endswith("kernel") else v).detach().requires_grad_()
               for k, v in att_p.items()}
        h = hidden.detach().requires_grad_()
        with torch.no_grad():
            plain_fwd = lambda: tb.attention_train_plain(hidden, seg, *ref.values(), sm_scale=sm,
                                                         dropout_rate=DROPOUT, keep=keep)
            fwd = timed_pair(lambda: tb.attention_train_fwd(hidden, seg, seed, wqkv, bqkv, wo, bo,
                                                            **kw), plain_fwd)
        out = tb.attention_train_plain(h, seg, *ref.values(), sm_scale=sm, dropout_rate=DROPOUT,
                                       keep=keep)
        bwd = timed_pair(
            lambda: tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, cot, **kw),
            lambda: torch.autograd.grad(out, [h, *ref.values()], cot, retain_graph=True))
        del out
        in_bytes = nbytes(hidden, seg, wqkv, bqkv, wo, bo)
        qkv_flops, core = 2 * M * H * 3 * HN, 4 * B * NH * L * L * HD
        fwd.update(split_bound(core, qkv_flops + 2 * M * HN * H, in_bytes + nbytes(hidden), dtype))
        c2 = randn(M, HN).to(dt)
        x2 = hidden.reshape(M, H)
        fwd["library_ms"] = library_time(
            lambda: (x2 @ wqkv, c2 @ wo),
            f"attention_train_fwd {dtype} (torch.matmul on its two products)")
        # recomputed p.v; dp, dq, dk, dv; and the products: the recomputed
        # q, k, v, dctx, dx, dWqkv, dWo
        out_bytes = nbytes(hidden) + 4 * (H * 3 * HN + 3 * HN + HN * H + H)
        bwd.update(split_bound(3 * core, 3 * qkv_flops + 4 * M * H * HN,
                               in_bytes + nbytes(cot) + out_bytes, dtype))
        g2 = cot.reshape(M, H)
        dqkv = randn(M, 3 * HN).to(dt)
        bwd["library_ms"] = library_time(
            lambda: (x2 @ wqkv, g2 @ wo.t(), dqkv @ wqkv.t(), x2.t() @ dqkv, c2.t() @ g2),
            f"attention_train_bwd {dtype} (torch.matmul on its five products)")
        if dtype == "bfloat16":
            bufs = {}
            got = tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, cot, **kw,
                                         buffers=bufs)
            bwd["gemm_reading"] = check_backward_gemms(
                "attention_train_bwd", {"dctx": bufs["dctx"], **dict(zip(
                    ("dx", "dw_all", "db_all", "dwo", "dbo"), got))},
                lambda: projection_gemms_plain(x2, g2, bufs, wqkv, wo))
            same_bits("attention_train_bwd", got, tb.attention_train_bwd(
                hidden, seg, seed, wqkv, bqkv, wo, cot, **kw))
            gate = check_backward_cores(
                "attention_train_bwd", bufs["dproj"],
                lambda: tb.attention_core_model_dproj(bufs, sm_scale=sm, dropout_rate=DROPOUT,
                                                      keep=keep), HN)
            bwd.update(core_reading=gate["reading"], core_norm_reading=gate["norm_reading"],
                       core_faults=gate["faults"])
            again = {}
            tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, cot, **kw, buffers=again)
            if not torch.equal(again["dproj"], bufs["dproj"]):
                fail("attention_train_bwd bfloat16: two runs' dproj differ")
            del got, bufs, again
            from dense_core_turns import device_split

            for name, call in (("attention_train_fwd", lambda: tb.attention_train_fwd(
                    hidden, seg, seed, wqkv, bqkv, wo, bo, **kw)), ("attention_train_bwd",
                    lambda: tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, cot, **kw))):
                split = device_split(call)
                (fwd if name == "attention_train_fwd" else bwd)["split_ms"] = split
                print(f"  {name} bfloat16 device time by kernel (ms): "
                      + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in split.items()))
            reset_peak()
            tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, cot, **kw)
            bwd["peak_gib"] = peak_gib()
            print(f"  attention_train_bwd bfloat16 peak memory {bwd['peak_gib']:.3f} GiB "
                  f"(the dS tiles {2 * tb.dense_ds_elements(B, NH, L) / 2**30:.3f} GiB)")
        else:  # the products on the 3xTF32 tile: the forward's, then the backward's at both rates
            fbufs = {}
            with torch.no_grad():
                out = tb.attention_train_fwd(hidden, seg, seed, wqkv, bqkv, wo, bo, **kw,
                                             buffers=fbufs)
            fwd.update(check_f32_forward(
                "attention_train_fwd", {"out": out}, lambda: {"out": tb.attention_train_plain(
                    hidden, seg, *ref.values(), sm_scale=sm, dropout_rate=DROPOUT, keep=keep)},
                core=True))
            fwd["f32_tol_core_fault"] = core_fault["fwd"]
            bwd["f32_tol_core_fault"] = core_fault["bwd"]
            del out
            for rate in (0.0, DROPOUT):
                bufs, again, kr = {}, {}, dict(kw, dropout_rate=rate)
                got = tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, cot, **kr,
                                             buffers=bufs)
                same_recomputed("attention_train_bwd", fbufs, bufs, ("qkv",))
                gate = check_f32_backward_gemms(
                    f"attention_train_bwd rate {rate}", {"dctx": bufs["dctx"], **dict(zip(
                        ("dx", "dw_all", "db_all", "dwo", "dbo"), got))},
                    lambda: projection_gemms_plain(x2, g2, bufs, wqkv, wo))
                for k in ("reading", "norm_reading"):
                    bwd[f"gemm_{k}"] = max(bwd.get(f"gemm_{k}", 0.0), gate[k])
                gate = check_f32_backward_cores(
                    "attention_train_bwd", bufs["dproj"],
                    lambda: tb.attention_core_model_dproj(bufs, sm_scale=sm, dropout_rate=rate,
                                                          keep=keep if rate else None), HN)
                for k in ("reading", "norm_reading"):
                    bwd[f"core_{k}"] = max(bwd.get(f"core_{k}", 0.0), gate[k])
                bwd.setdefault("core_faults", {}).update(
                    {f"{f} rate {rate}": v for f, v in gate["faults"].items()})
                same_bits("attention_train_bwd", got, tb.attention_train_bwd(
                    hidden, seg, seed, wqkv, bqkv, wo, cot, **kr, buffers=again), dtype)
                if not torch.equal(again["dproj"], bufs["dproj"]):
                    fail(f"attention_train_bwd float32 rate {rate}: two runs' dproj differ")
                del got, bufs, again
            from dense_core_turns import device_split

            for name, call in (("attention_train_fwd", lambda: tb.attention_train_fwd(
                    hidden, seg, seed, wqkv, bqkv, wo, bo, **kw)), ("attention_train_bwd",
                    lambda: tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, cot, **kw))):
                split = device_split(call)
                (fwd if name == "attention_train_fwd" else bwd)["split_ms"] = split
                print(f"  {name} float32 device time by kernel (ms): "
                      + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in split.items()))
        del dqkv, c2
        rows["attention_train_fwd", dtype] = {"max_abs_err": err["attention_train_fwd"], **fwd}
        rows["attention_train_bwd", dtype] = {"max_abs_err": err["attention_train_bwd"], **bwd}

        w1, w2 = mlp_p["w1"].to(dt).contiguous(), mlp_p["w2"].to(dt).contiguous()
        b1, b2 = mlp_p["b1"], mlp_p["b2"]
        ref = {k: (v.to(dt) if k.startswith("w") else v).detach().requires_grad_()
               for k, v in mlp_p.items()}
        xx = x.detach().requires_grad_()
        with torch.no_grad():
            fwd = timed_pair(lambda: tb.mlp_train_fwd(x, w1, b1, w2, b2, activation="gelu"),
                             lambda: tb.mlp_train_plain(x, *ref.values(), activation="gelu"))
        out = tb.mlp_train_plain(xx, *ref.values(), activation="gelu")
        bwd = timed_pair(
            lambda: tb.mlp_train_bwd(x, w1, b1, w2, cot2, activation="gelu"),
            lambda: torch.autograd.grad(out, [xx, *ref.values()], cot2, retain_graph=True))
        del out
        in_bytes = nbytes(x, w1, b1, w2, b2)
        fwd.update(split_bound(0, 4 * M * H * I, in_bytes + nbytes(x), dtype))
        # the products: the recomputed x.W1; g.W2^T; dx; dW1; dW2
        out_bytes = nbytes(x) + 4 * (H * I + I + I * H + H)
        bwd.update(split_bound(0, 10 * M * H * I, in_bytes + nbytes(cot2) + out_bytes, dtype))
        hh = randn(M, I).to(dt)
        fwd["library_ms"] = library_time(
            lambda: (x @ w1, hh @ w2), f"mlp_train_fwd {dtype} (torch.matmul on its two products)")
        bwd["library_ms"] = library_time(
            lambda: (x @ w1, cot2 @ w2.t(), hh @ w1.t(), x.t() @ hh, hh.t() @ cot2),
            f"mlp_train_bwd {dtype} (torch.matmul on its five products)")
        del hh
        if dtype == "bfloat16":
            names = ("dx", "dw1", "db1", "dw2", "db2")
            got = tb.mlp_train_bwd(x, w1, b1, w2, cot2, activation="gelu")
            bwd["gemm_reading"] = check_backward_gemms(
                "mlp_train_bwd", dict(zip(names, got)), lambda: dict(zip(
                    names, tb.mlp_train_bwd_plain(x, w1, b1, w2, cot2, activation="gelu"))))
            same_bits("mlp_train_bwd", got, tb.mlp_train_bwd(x, w1, b1, w2, cot2,
                                                             activation="gelu"))
            del got
        else:
            fbufs, bbufs = {}, {}
            with torch.no_grad():
                out = tb.mlp_train_fwd(x, w1, b1, w2, b2, activation="gelu", buffers=fbufs)
            fwd.update(check_f32_forward(
                "mlp_train_fwd", {"out": out},
                lambda: {"out": tb.mlp_train_plain(x, *ref.values(), activation="gelu")}))
            del out
            names = ("dx", "dw1", "db1", "dw2", "db2")
            got = tb.mlp_train_bwd(x, w1, b1, w2, cot2, activation="gelu", buffers=bbufs)
            same_recomputed("mlp_train_bwd", fbufs, bbufs, ("h",))
            del fbufs, bbufs
            gate = check_f32_backward_gemms(
                "mlp_train_bwd", dict(zip(names, got)), lambda: dict(zip(
                    names, tb.mlp_train_bwd_plain(x, w1, b1, w2, cot2, activation="gelu"))))
            bwd.update(gemm_reading=gate["reading"], gemm_norm_reading=gate["norm_reading"])
            same_bits("mlp_train_bwd", got, tb.mlp_train_bwd(x, w1, b1, w2, cot2,
                                                             activation="gelu"), dtype)
            del got
            transposed_gemm_rates(device)
        weight_grad_sweep(device, dtype)
        rows["mlp_train_fwd", dtype] = {"max_abs_err": err["mlp_train_fwd"], **fwd}
        rows["mlp_train_bwd", dtype] = {"max_abs_err": err["mlp_train_bwd"], **bwd}
        for name in err:
            r = rows[name, dtype]
            print(f"kernel {name} {dtype}: max_abs_err {r['max_abs_err']:.3e}  kernel "
                  f"{r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms "
                  f"({r['bound_by']})")
        torch.cuda.empty_cache()
    return rows


def f32_tol_fault(got, bad, names, kernel: str) -> dict:
    """F32_CORE_FAULT against a float32 training block's F32_TOL check: the
    kernel's output and gradients ``got`` read against the plain version's
    with the fault planted (``bad``, autograd through model_product) as
    _normalized_errors reads them; the forward's and the backward's limits
    must each reject it in at least one output. Returns {"fwd", "bwd": the
    largest reading over its limit}."""
    rel = [((g.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()
           for g, b in zip(got, bad)]
    out = {"fwd": rel[0] / limit(f"{kernel}_fwd", "float32"),
           "bwd": max(rel[1:]) / limit(f"{kernel}_bwd", "float32")}
    print(f"  planted fault, {kernel}'s float32 plain version with {F32_CORE_FAULT} (autograd "
          f"through the same products): " + ", ".join(f"{n} {r:.2e}" for n, r in zip(names, rel))
          + f": forward {'rejected' if out['fwd'] > 1 else 'ACCEPTED'} by F32_TOL, backward "
          + ("rejected" if out["bwd"] > 1 else "ACCEPTED"))
    if min(out.values()) <= 1:
        fail(f"F32_TOL of {kernel} accepts {F32_CORE_FAULT}")
    return out


def same_bits(name: str, got, again, dtype: str = "bfloat16"):
    """Fails unless two runs of a backward gave the same weight and bias
    gradients (every output after dx) bit for bit."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
        fail(f"{name} {dtype}: two runs' weight gradients differ")
    print(f"  {name} {dtype}: two runs' weight gradients bit-identical")


# the weight gradients of the training main paths' backwards (M, Hin, N):
# BERT-base's W1, W2, Wqkv and Wo at B*L = 16384 rows, the Longformer
# block's [Wqkv Wg] at 16384 rows (kernel phase) and at its training micro-
# batch's 4096
def same_recomputed(name: str, forward: dict, backward: dict, keys):
    """Fails unless the backward recomputed the forward's products (the
    ``keys`` of the two wrappers' ``buffers``) bit for bit: it then
    differentiates the forward's own values."""
    import torch

    for k in keys:
        f, b = forward[k], backward[k]
        if (f is None) != (b is None) or (f is not None and not torch.equal(f, b)):
            fail(f"{name}: the backward's recomputed {k} differs from the forward's")
    print(f"  {name}: the backward's recomputed {', '.join(keys)} equal the forward's bit for bit")


WGRAD_SHAPES = ((B * L, H, I), (B * L, I, H), (B * L, H, 3 * NH * HD), (B * L, NH * HD, H),
                (B * L, H, 6 * NH * HD), (2 * 2048, H, 6 * NH * HD), (2 * 2048, NH * HD, H))


# the float32 backwards' products with a weight read transposed (M, N, K):
# rows 10-13's dctx = g Wo^T, row 10's dx, row 12's dx with global rows, the
# MLP's dpre = g W2^T and dx = dpre W1^T, at B*L = 16384 rows
GEMM_T_SHAPES = ((B * L, NH * HD, H), (B * L, H, 3 * NH * HD), (B * L, H, 6 * NH * HD),
                 (B * L, I, H), (B * L, H, I))


def transposed_gemm_rates(device) -> dict:
    """ms and TFLOP/s of the float32 transposed-weight tile alone
    (train_blocks.forward_tile's "gemm_t") and of torch.matmul (TF32 off) on
    the same product, for GEMM_T_SHAPES. Prints one JSON line."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    g = torch.Generator(device=device).manual_seed(5)
    out = {}
    for M, N, K in GEMM_T_SHAPES:
        a = torch.randn(M, K, generator=g, device=device)
        w = torch.randn(N, K, generator=g, device=device)
        zero = torch.zeros(N, device=device)
        tile = lambda: tb.forward_tile(a, w, zero, kernel="gemm_t")
        tile(), a @ w.t()  # warm-up
        ms, lib = time_ms(tile), time_ms(lambda: a @ w.t())
        out[f"{M}x{N}x{K}"] = {"ms": ms, "tflops": 2 * M * N * K / ms / 1e9, "library_ms": lib}
        print(f"  transposed-weight tile float32 {M} x {N} x {K}: {ms:.3f} ms "
              f"({2 * M * N * K / ms / 1e9:.1f} TFLOP/s); torch.matmul {lib:.3f} ms")
        del a, w
    print(json.dumps({"gemm_transposed_float32": out}))
    return out


def weight_grad_sweep(device, dtype: str = "bfloat16") -> dict:
    """ms of the weight gradient (train_blocks.weight_grad) in ``dtype`` at
    each split count 1-8 and at weight_grad_splits' choice, for
    WGRAD_SHAPES: the measurement the split rule was chosen by. Prints one
    JSON line."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    g = torch.Generator(device=device).manual_seed(4)
    out = {}
    for M, Hin, N in WGRAD_SHAPES:
        x = torch.randn(M, Hin, generator=g, device=device).to(getattr(torch, dtype))
        dy = torch.randn(M, N, generator=g, device=device).to(getattr(torch, dtype))
        times = {s: time_ms(lambda: tb.weight_grad(x, dy, splits=s)) for s in range(1, 9)}
        chosen = tb.weight_grad_splits(M, Hin, N, tb._sm_count(device.index or 0),
                                       getattr(torch, dtype))
        best = min(times, key=times.get)
        out[f"{M}x{Hin}x{N}"] = {"ms": times, "chosen": chosen, "fastest": best,
                                 "tflops_chosen": 2 * M * Hin * N / times[chosen] / 1e9}
        print(f"  weight_grad {dtype} {M} x {Hin} x {N}: " + ", ".join(
            f"{s}: {t:.3f}" for s, t in times.items()) + f" ms; chosen {chosen}, fastest {best}")
        del x, dy
    print(json.dumps({"weight_grad_splits": {dtype: out}}))
    return out


# ------------------------------------------------------------ Longformer kernels


def sliding_masks(device, global_rows=True):
    """(B, L) attention mask (rows full, or suffix-padded to 1024-1900
    tokens) and global mask (CLS, or none) of the Longformer kernel phase."""
    import torch

    n_valid = [LF_L, 1024, LF_L, 1300, LF_L, 1650, LF_L, 1900][:LF_B]
    mask = (torch.arange(LF_L)[None] < torch.tensor(n_valid)[:, None]).int()
    glob = torch.zeros_like(mask)
    if global_rows:
        glob[:, 0] = 1
    return mask.to(device), glob.to(device)


def sliding_work(mask, glob, window: int, H: int, nh: int, hd: int) -> dict:
    """The operations the Longformer block needs for these masks: the
    projections (local q, k, v of every row; global k, v of the real keys and
    global q of the global rows, where a row has global tokens), the
    attention core (scores and P.V over each row's allowed band keys, the
    global columns and the global rows) and the output projection."""
    mask, glob = mask.cpu().numpy(), glob.cpu().numpy()
    B, L = mask.shape
    C, HN = window // 2, nh * hd
    v, g = mask.sum(1), glob.sum(1)
    r = np.arange(L)
    band = sum(np.clip(np.minimum(r + C, nv - 1) - np.maximum(r - C, ng) + 1, 0, None).sum()
               for nv, ng in zip(v, g))
    pairs = band + L * g.sum() + (g * v).sum()
    proj = 2 * B * L * H * 3 * HN + sum(2 * nv * H * 2 * HN + 2 * ng * H * HN
                                        for nv, ng in zip(v, g) if ng > 0)
    return {"proj": float(proj), "core": float(4 * nh * hd * pairs),
            "out": float(2 * B * L * HN * H), "rows_pairs": float(band + L * g.sum())}


def grad_bound(work: dict, slab: int, n_in: int, n_out: int, rows: int, dtype: str) -> float:
    """ms: the bound of a training backward's gradient kernels alone (rows 12
    and 13), from ``work`` (sliding_work or bigbird_work: ``core`` counts 4 hd
    operations a (row, key) pair of every head): S, dP and the dq, dk and dv
    products, 10 hd a pair (the global rows' dq of row 12 is counted too,
    one row of 2048); n_in slabs of (B L, nh hd) read (q, k, v, dctx and the
    global rows' kg, vg), n_out written, and the rows' three float32
    statistics; float32 at the 3xTF32 rate."""
    size = 4 if dtype == "float32" else 2
    return bound(2.5 * work["core"], (n_in + n_out) * slab * size + 3 * rows * 4,
                 core_type(dtype))["bound_ms"]


def projections_library_ms(hidden, w: dict, names, label: str) -> float:
    """ms of torch.matmul (float32: TF32 off) on a long-context block's
    projections: hidden (B, L, H) times each of the card weights ``names``
    (wqkv, and for Longformer the global rows' wgkv, over every row) and the
    out projection w["wo"] (a context of ones: the time does not depend on
    the values)."""
    import torch

    x2 = hidden.reshape(-1, hidden.shape[-1])
    c2 = torch.ones(x2.shape[0], w["wo"].shape[0], dtype=hidden.dtype, device=hidden.device)
    return library_time(lambda: ([x2 @ w[n] for n in names], c2 @ w["wo"]),
                        f"{label} (torch.matmul on its projections)")


def global_kv_grad_row(split: dict, mask, glob, dt) -> dict:
    """gkv_ms, global_kv_grad_kernel's device time in a Longformer
    backward's split, beside gkv_bound_ms: the real keys' kg and vg, the
    global rows' qg, dctx and statistics read once, dproj's dkg and dvg
    slots (every row) written once, and 8 hd operations (s, dp, dkg, dvg) a
    (global row, real key) pair of each head on the CUDA cores."""
    import torch

    Bm, Lm = mask.shape
    es, hn = torch.empty(0, dtype=dt).element_size(), NH * HD
    n_valid, n_glob = mask.sum(1), glob.sum(1)
    keys, n_rows = int(n_valid.sum()), int(n_glob.sum())
    io = 2 * keys * hn * es + 2 * n_rows * hn * es + 3 * n_rows * NH * 4 + 2 * Bm * Lm * hn * es
    b = bound(8 * HD * NH * int((n_valid * n_glob).sum()), io, "float32")
    print(f"  global_kv_grad {str(dt).split('.')[-1]}: {split['global_kv_grad_ms']:.4f} ms of "
          f"device time, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"gkv_ms": split["global_kv_grad_ms"], "gkv_bound_ms": b["bound_ms"]}


def long_backward_gemms(name, hidden, dt, wo, masks, backward, randn, core_model,
                        row_bound: float) -> dict:
    """The library column and, in bf16, the backward-GEMM gate, the
    gradient kernels' gate (``core_model(buffers, global_rows)`` gives the
    rounding model's dproj), dproj the same bits in two runs and the
    backward's device time by kernel, in float32 the float32 backward-GEMM
    gate and the float32 gradient kernels' gate (check_f32_backward_cores)
    at rates 0 and DROPOUT, of row 12 (``name`` sliding_train_bwd, with and
    without global rows) or 13 (bigbird_train_bwd): ``masks(global_rows)``
    gives (mask, glob), ``backward(mask, glob, cot, global_rows, buffers,
    rate=DROPOUT)`` runs the backward kernel and ``core_model(buffers,
    global_rows, rate=DROPOUT)`` gives the rounding model's dproj. Returns
    {library_ms, gemm_reading, core_reading, core_norm_reading, core_faults,
    split_ms, and in float32 gemm_norm_reading, core_ms (the statistics
    pass, the global rows and the gradient kernels) and grad_ms (the
    gradient kernels)}."""
    import torch

    B, L, H = hidden.shape
    M, HN = B * L, wo.shape[0]
    x2, row = hidden.reshape(M, H), {}
    settings = (True, False) if name == "sliding_train_bwd" else (False,)
    for gr in settings:
        mk, gl = masks(gr)
        cot = (randn(B, L, H) * mk.bool()[..., None]).to(dt)

        def outputs(got):
            if gr:
                return {"dx": got[0], "dw_all": torch.cat([got[1], got[3]], 1),
                        "db_all": torch.cat([got[2], got[4]]), "dwo": got[5], "dbo": got[6]}
            return {**dict(zip(("dx", "dw_all", "db_all"), got[:3])), "dwo": got[-2],
                    "dbo": got[-1]}

        bufs = {}
        got = backward(mk, gl, cot, gr, bufs)
        w_all = bufs["w_all"]
        out = outputs(got)
        if gr == settings[0]:
            g2, dproj, ctx = cot.reshape(M, H), randn(M, w_all.shape[1]).to(dt), randn(M, HN).to(dt)
            row["library_ms"] = library_time(
                lambda: (x2 @ w_all, g2 @ wo.t(), dproj @ w_all.t(), x2.t() @ dproj, ctx.t() @ g2),
                f"{name} {dt} (torch.matmul on its five products)")
            del dproj, ctx
        if dt == torch.bfloat16:
            out["dctx"] = bufs["dctx"]
            reading = check_backward_gemms(name, out, lambda: projection_gemms_plain(
                x2, cot.reshape(M, H), bufs, w_all, wo))
            row["gemm_reading"] = max(row.get("gemm_reading", 0.0), reading)
            gate = check_backward_cores(name, bufs["dproj"], lambda: core_model(bufs, gr), HN)
            for k in ("reading", "norm_reading"):
                row[f"core_{k}"] = max(row.get(f"core_{k}", 0.0), gate[k])
            row.setdefault("core_faults", {}).update(
                {f"{f}, global_rows={gr}": v for f, v in gate["faults"].items()})
            again = {}
            backward(mk, gl, cot, gr, again)
            if not torch.equal(again["dproj"], bufs["dproj"]):
                fail(f"{name} bfloat16 global_rows={gr}: two runs' dproj differ")
            print(f"  {name} bfloat16 global_rows={gr}: two runs' dproj bit-identical")
            del again
            if gr == settings[0]:
                from backward_core_turns import device_split

                split = device_split(lambda: backward(mk, gl, cot, gr, None))
                row["split_ms"] = split
                if name == "sliding_train_bwd":
                    row.update(global_kv_grad_row(split, mk, gl, dt))
                print(f"  {name} bfloat16 device time by kernel (ms): " + ", ".join(
                    f"{k[:-3]} {v:.3f}" for k, v in split.items() if v)
                    + f"; the gradient kernels' bound {row_bound:.3f}")
        else:  # float32: the products and the attention cores on 3xTF32, at both rates
            for rate in (DROPOUT, 0.0):
                if rate != DROPOUT:
                    bufs = {}
                    out = outputs(backward(mk, gl, cot, gr, bufs, rate))
                out["dctx"] = bufs["dctx"]
                label = f"{name} global_rows={gr} rate {rate}"
                gate = check_f32_backward_gemms(label, out, lambda: projection_gemms_plain(
                    x2, cot.reshape(M, H), bufs, w_all, wo))
                for k in ("reading", "norm_reading"):
                    row[f"gemm_{k}"] = max(row.get(f"gemm_{k}", 0.0), gate[k])
                gate = check_f32_backward_cores(name, bufs["dproj"],
                                                lambda: core_model(bufs, gr, rate), HN, label)
                for k in ("reading", "norm_reading"):
                    row[f"core_{k}"] = max(row.get(f"core_{k}", 0.0), gate[k])
                row.setdefault("core_faults", {}).update(
                    {f"{f}, global_rows={gr}, rate {rate}": v for f, v in gate["faults"].items()})
                if rate == DROPOUT:
                    again = {}
                    backward(mk, gl, cot, gr, again)
                    if not torch.equal(again["dproj"], bufs["dproj"]):
                        fail(f"{label} float32: two runs' dproj differ")
                    print(f"  {label} float32: two runs' dproj bit-identical")
                    del again
            if gr == settings[0]:
                from backward_core_turns import device_split

                split = device_split(lambda: backward(mk, gl, cot, gr, None), global_apart=True)
                row.update(split_ms=split, grad_ms=split["grad_ms"],
                           core_ms=split["stats_ms"] + split["global_rows_ms"] + split["grad_ms"])
                if name == "sliding_train_bwd":
                    row.update(global_kv_grad_row(split, mk, gl, dt))
                print(f"  {name} float32 device time by kernel (ms): " + ", ".join(
                    f"{k[:-3]} {v:.3f}" for k, v in split.items() if v)
                    + f"; the cores {row['core_ms']:.3f}, the gradient kernels' bound "
                    f"{row_bound:.3f}")
        del got, bufs, out
    return row


def sliding_kernel_phase(device) -> dict:
    """{(name, dtype): row} for the Longformer inference block and training
    block at the slice's shape, with and without global rows; the keep masks'
    fractions; the backward's determinism."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    g = torch.Generator(device=device).manual_seed(2)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    B, L, HN, G = LF_B, LF_L, NH * HD, sb.global_columns(LF_MAX_GLOBALS, LF_L)
    seed = torch.tensor([20231017], dtype=torch.int32, device=device)
    keep = ts.sliding_keep_masks(seed, B, NH, L, LF_WINDOW, G, DROPOUT)
    for name, m in zip(("band", "global-column", "global-row"), keep):
        frac = m.float().mean().item()
        print(f"sliding dropout keep fraction, {name} mask {tuple(m.shape)}: {frac:.6f}")
        if abs(frac - (1.0 - DROPOUT)) > KEEP_FRACTION_TOL:
            fail(f"{name} keep fraction {frac:.6f} not within {KEEP_FRACTION_TOL} of "
                 f"{1.0 - DROPOUT}")
    names = ("qkv_kernel", "qkv_bias", "gqkv_kernel", "gqkv_bias", "out_kernel", "out_bias")
    grad_names = ("dx",) + tuple("d" + n for n in names)
    kw = dict(sm_scale=HD**-0.5, window=LF_WINDOW, max_globals=LF_MAX_GLOBALS)
    rows = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        params = dict(qkv_kernel=randn(H, 3, NH, HD, scale=H**-0.5),
                      qkv_bias=randn(3, NH, HD, scale=0.02),
                      gqkv_kernel=randn(H, 3, NH, HD, scale=H**-0.5),
                      gqkv_bias=randn(3, NH, HD, scale=0.02),
                      out_kernel=randn(NH, HD, H, scale=HN**-0.5), out_bias=randn(H, scale=0.02))
        # the weights the kernels compute with, for the plain versions
        rounded = {k: v.to(dt) if k.endswith("kernel") else v for k, v in params.items()}
        ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
        hidden = randn(B, L, H).to(dt)
        err = {"sliding_attention_block": 0.0, "sliding_train_fwd": 0.0, "sliding_train_bwd": 0.0}
        for global_rows in (True, False):
            mask, glob = sliding_masks(device, global_rows)
            valid = mask.bool()
            cot = (randn(B, L, H) * valid[..., None]).to(dt)
            gkw = dict(kw, global_rows=global_rows)
            label = f"{dtype} global_rows={global_rows}"
            got = sb.fused_sliding_attention_block(hidden, mask, glob, *params.values(), **ln, **gkw)
            want = sb.sliding_block_plain(hidden, mask, glob, *rounded.values(), **ln, **gkw)
            err["sliding_attention_block"] = max(err["sliding_attention_block"], _normalized_errors(
                [got[valid]], [want[valid]], ["out"], dtype, f"sliding_attention_block {label}",
                "sliding_attention_block"))
            for rate in (0.0, DROPOUT):
                def grads(fn, ps, **extra):
                    leaves = {k: v.detach().requires_grad_() for k, v in ps.items()}
                    h = hidden.detach().requires_grad_()
                    out = fn(h, mask, glob, *leaves.values(), **extra, **gkw, dropout_rate=rate)
                    return [out[valid], *torch.autograd.grad(out, [h, *leaves.values()], cot,
                                                             allow_unused=True)]

                got = grads(ts.sliding_attention_block_train, params, seed=seed)
                want = grads(ts.sliding_train_plain, rounded, keep=keep if rate else None)
                lab = f"sliding_train {label} rate {rate}"
                err["sliding_train_fwd"] = max(err["sliding_train_fwd"], _normalized_errors(
                    got[:1], want[:1], ["out"], dtype, lab + " fwd", "sliding_train_fwd"))
                live = [i for i, w in enumerate(want) if i > 0 and w is not None]
                if not global_rows and not all((got[i] == 0).all() for i in (4, 5)):
                    fail(f"{lab}: nonzero global-projection gradients without global rows")
                err["sliding_train_bwd"] = max(err["sliding_train_bwd"], _normalized_errors(
                    [got[i] for i in live], [want[i] for i in live],
                    [grad_names[i - 1] for i in live], dtype, lab + " bwd", "sliding_train_bwd"))
                if global_rows and rate:
                    again = grads(ts.sliding_attention_block_train, params, seed=seed)
                    if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
                        fail(f"{lab}: two backward runs differ")
                    print(f"  {lab}: two backward runs bit-identical")
                    if dtype == "float32":  # F32_CORE_FAULT in the plain core, autograd and all
                        with planted(core_products(plain_tf32)):
                            bad = grads(ts.sliding_train_plain, rounded, keep=keep)
                        core_fault = f32_tol_fault(got, bad, ("out",) + grad_names,
                                                   "sliding_train")
                        del bad
                del got, want

        # times on the main path's masks (CLS global), the kernels called directly
        mask, glob = sliding_masks(device)
        valid = mask.bool()
        cot = (randn(B, L, H) * valid[..., None]).to(dt)
        gkw = dict(kw, global_rows=True)
        work = sliding_work(mask, glob, LF_WINDOW, H, NH, HD)
        ps, rs = list(params.values()), list(rounded.values())
        with torch.no_grad():
            blk = timed_pair(
                lambda: sb.fused_sliding_attention_block(hidden, mask, glob, *ps, **ln, **gkw),
                lambda: sb.sliding_block_plain(hidden, mask, glob, *rs, **ln, **gkw))
        w = sb.card_weights(*ps[:5], dt)
        m32, g32, bo = mask.int().contiguous(), glob.int().contiguous(), params["out_bias"]
        cfg = dict(num_heads=NH, window=LF_WINDOW, max_globals=LF_MAX_GLOBALS, global_rows=True,
                   sm_scale=HD**-0.5, dropout_rate=DROPOUT)
        plain = lambda h, *p: ts.sliding_train_plain(h, mask, glob, *p, **gkw,
                                                     dropout_rate=DROPOUT, keep=keep)
        with torch.no_grad():
            fwd = timed_pair(lambda: ts.sliding_train_fwd(hidden, m32, g32, seed, w, bo, **cfg),
                             lambda: plain(hidden, *rs))
        leaves = [p.detach().requires_grad_() for p in rs]
        h = hidden.detach().requires_grad_()
        out = plain(h, *leaves)
        bwd = timed_pair(lambda: ts.sliding_train_bwd(hidden, m32, g32, seed, w, cot, **cfg),
                         lambda: torch.autograd.grad(out, [h, *leaves], cot, retain_graph=True))
        del out
        if dtype == "float32":  # the forwards against the 3xTF32 model, plain TF32 planted
            blk_of = lambda fn, *p, **l: fn(hidden, mask, glob, *p, **l, **gkw)[valid]
            blk.update(check_f32_forward(
                "sliding_attention_block", {
                    "out": blk_of(sb.fused_sliding_attention_block, *ps, **ln),
                    "projection": blk_of(sb.fused_sliding_attention_block, *ps)},
                lambda: {"out": blk_of(sb.sliding_block_plain, *rs, **ln),
                         "projection": blk_of(sb.sliding_block_plain, *rs)}, core=True))
            fbufs, bbufs = {}, {}
            with torch.no_grad():
                out = ts.sliding_train_fwd(hidden, m32, g32, seed, w, bo, **cfg, buffers=fbufs)
            fwd.update(check_f32_forward("sliding_train_fwd", {"out": out[valid]},
                                         lambda: {"out": plain(hidden, *rs)[valid]}, core=True))
            fwd["f32_tol_core_fault"], bwd["f32_tol_core_fault"] = core_fault["fwd"], core_fault["bwd"]
            ts.sliding_train_bwd(hidden, m32, g32, seed, w, cot, **cfg, buffers=bbufs)
            same_recomputed("sliding_train_bwd", fbufs, bbufs, ("qkv", "gkv"))
            del out, fbufs, bbufs
        weights = nbytes(*w.values(), bo)
        io = nbytes(hidden, mask, glob) + weights
        fwd_products = work["proj"] + work["out"]
        blk.update(split_bound(work["core"], fwd_products, io + nbytes(*ln.values(), hidden), dtype))
        fwd.update(split_bound(work["core"], fwd_products, io + nbytes(seed, hidden), dtype))
        blk["library_ms"] = fwd["library_ms"] = projections_library_ms(
            hidden, w, ("wqkv", "wgkv"), f"sliding_attention_block and sliding_train_fwd {dtype}")
        # recomputed attention; the backward's four attention products; and
        # the products: the recomputed projections, dctx, dx and the
        # projection weight gradients, dWo
        grads_out = nbytes(hidden) + 4 * (2 * H * 3 * HN + 2 * 3 * HN + HN * H + H)
        bwd.update(split_bound(3 * work["core"], 3 * work["proj"] + 2 * work["out"],
                               io + nbytes(seed, cot) + grads_out, dtype))
        bwd["grad_bound_ms"] = grad_bound(work, B * L * HN, 6, 5, B * NH * L, dtype)
        bwd.update(long_backward_gemms(
            "sliding_train_bwd", hidden, dt, w["wo"], lambda gr: sliding_masks(device, gr),
            lambda mk, gl, ck, gr, bufs, rate=DROPOUT: ts.sliding_train_bwd(
                hidden, mk.int().contiguous(), gl.int().contiguous(), seed, w, ck,
                **dict(cfg, global_rows=gr, dropout_rate=rate), buffers=bufs), randn,
            lambda bufs, gr, rate=DROPOUT: ts.sliding_core_model_dproj(
                bufs, window=LF_WINDOW, sm_scale=HD**-0.5, dropout_rate=rate,
                keep=keep if rate else None), bwd["grad_bound_ms"]))
        for name, row in (("sliding_attention_block", blk), ("sliding_train_fwd", fwd),
                          ("sliding_train_bwd", bwd)):
            rows[name, dtype] = {"max_abs_err": err[name], **row}
            print(f"kernel {name} {dtype}: max_abs_err {err[name]:.3e}  kernel {row['ms']:.3f} ms  "
                  f"plain {row['plain_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms "
                  f"({row['bound_by']})")
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ BigBird kernels


def bigbird_work(mask, C: int, tables, H: int, nh: int, hd: int) -> dict:
    """The operations the BigBird block needs for these masks: the
    projections (q, k, v and out of every row) and the attention core
    (scores and P.V over each row's allowed keys: the real keys of its
    window, global and live random blocks, or every real key for a global
    row)."""
    n_valid = mask.sum(1).cpu().numpy()
    B, L = mask.shape
    nb, HN, G, R = L // C, nh * hd, tables.G, tables.R
    rand, rok = tables.rand.cpu().numpy(), tables.rok.cpu().numpy()
    pairs = 0
    for nv in n_valid:
        real = lambda j: int(np.clip(nv - j * C, 0, C))  # real keys of block j
        for i in range(G, nb):
            blocks = [j for j in (i - 1, i, i + 1) if G <= j < nb] + list(range(G))
            blocks += [int(rand[i, r]) for r in range(R) if rok[i, r]]
            pairs += C * sum(real(j) for j in blocks)
        pairs += G * C * int(nv)
    return {"proj": float(2 * B * L * H * 3 * HN), "core": float(4 * nh * hd * pairs),
            "out": float(2 * B * L * HN * H)}


def bigbird_masks(device, B: int, L: int):
    """(B, L) attention mask of the BigBird kernel phase: rows full,
    suffix-padded to 60-80 % of L, and one with fewer real tokens (100) than
    the two global blocks hold."""
    import torch

    n_valid = [L, int(0.75 * L), L, 100, L, int(0.6 * L), L, int(0.8 * L)][:B]
    return (torch.arange(L)[None] < torch.tensor(n_valid)[:, None]).int().to(device)


def bigbird_kernel_phase(device) -> dict:
    """{(name, dtype): row} for the BigBird inference block at the serving
    shape and the training block at the training shape, and both at a short
    sequence of 4 blocks (padded-self random entries); the keep masks'
    fractions; the backward's determinism."""
    import torch

    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import bigbird_block as bbk
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb

    g = torch.Generator(device=device).manual_seed(5)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    HN = NH * HD
    pattern = dict(block_size=BB_BLOCK, num_global_blocks=BB_GLOBAL,
                   num_random_blocks=BB_RANDOM)
    seed = torch.tensor([20231019], dtype=torch.int32, device=device)
    tables = bigbird_tables(BB_TRAIN_L // BB_BLOCK, BB_GLOBAL, BB_RANDOM, BB_SEED, device)
    keep = tbb.bigbird_keep_masks(seed, BB_TRAIN_B, NH, BB_TRAIN_L, BB_BLOCK, tables.G,
                                  tables.R, DROPOUT)
    for name, m in zip(("window", "global-column", "random", "global-row"), keep):
        frac = m.float().mean().item()
        print(f"bigbird dropout keep fraction, {name} mask {tuple(m.shape)}: {frac:.6f}")
        if abs(frac - (1.0 - DROPOUT)) > KEEP_FRACTION_TOL:
            fail(f"bigbird {name} keep fraction {frac:.6f} not within {KEEP_FRACTION_TOL} of "
                 f"{1.0 - DROPOUT}")
    del keep
    names = ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias")
    grad_names = ("dx",) + tuple("d" + n for n in names)
    rows = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        params = dict(qkv_kernel=randn(H, 3, NH, HD, scale=H**-0.5),
                      qkv_bias=randn(3, NH, HD, scale=0.02),
                      out_kernel=randn(NH, HD, H, scale=HN**-0.5), out_bias=randn(H, scale=0.02))
        # the weights the kernels compute with, for the plain versions
        rounded = {k: v.to(dt) if k.endswith("kernel") else v for k, v in params.items()}
        ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
        err = {"bigbird_attention_block": 0.0, "bigbird_train_fwd": 0.0, "bigbird_train_bwd": 0.0}
        # (batch, tokens, pattern seed): the slice's shapes, and 4 blocks,
        # where query blocks 2 and 3 find no random candidate (rok = 0)
        for Bk, Lk, pseed in ((BB_B, BB_L, BB_SEED), (2, 4 * BB_BLOCK, 1)):
            mask = bigbird_masks(device, Bk, Lk)
            valid = mask.bool()
            hidden = randn(Bk, Lk, H).to(dt)
            kw = dict(pattern, seed=pseed, sm_scale=HD**-0.5)
            label = f"{dtype} B={Bk} L={Lk}"
            got = bbk.fused_bigbird_attention_block(hidden, mask, *params.values(), **kw, **ln)
            want = bbk.bigbird_block_plain(hidden, mask, *rounded.values(), **kw, **ln)
            err["bigbird_attention_block"] = max(err["bigbird_attention_block"], _normalized_errors(
                [got[valid]], [want[valid]], ["out"], dtype, f"bigbird_attention_block {label}",
                "bigbird_attention_block"))
            del got, want
        for Bk, Lk, pseed in ((BB_TRAIN_B, BB_TRAIN_L, BB_SEED), (2, 4 * BB_BLOCK, 1)):
            mask = bigbird_masks(device, Bk, Lk)
            valid = mask.bool()
            hidden = randn(Bk, Lk, H).to(dt)
            cot = (randn(Bk, Lk, H) * valid[..., None]).to(dt)
            t = bigbird_tables(Lk // BB_BLOCK, BB_GLOBAL, BB_RANDOM, pseed, device)
            kw = dict(pattern, pattern_seed=pseed, sm_scale=HD**-0.5)
            for rate in (0.0, DROPOUT):
                keep = (tbb.bigbird_keep_masks(seed, Bk, NH, Lk, BB_BLOCK, t.G, t.R, rate)
                        if rate else None)

                def grads(fn, ps, **extra):
                    leaves = {k: v.detach().requires_grad_() for k, v in ps.items()}
                    h = hidden.detach().requires_grad_()
                    out = fn(h, mask, *leaves.values(), **extra, **kw, dropout_rate=rate)
                    return [out[valid], *torch.autograd.grad(out, [h, *leaves.values()], cot)]

                got = grads(tbb.bigbird_attention_block_train, params, seed=seed)
                want = grads(tbb.bigbird_train_plain, rounded, keep=keep)
                lab = f"bigbird_train {dtype} B={Bk} L={Lk} rate {rate}"
                err["bigbird_train_fwd"] = max(err["bigbird_train_fwd"], _normalized_errors(
                    got[:1], want[:1], ["out"], dtype, lab + " fwd", "bigbird_train_fwd"))
                err["bigbird_train_bwd"] = max(err["bigbird_train_bwd"], _normalized_errors(
                    got[1:], want[1:], grad_names, dtype, lab + " bwd", "bigbird_train_bwd"))
                if rate and Lk == BB_TRAIN_L:
                    again = grads(tbb.bigbird_attention_block_train, params, seed=seed)
                    if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
                        fail(f"{lab}: two backward runs differ")
                    print(f"  {lab}: two backward runs bit-identical")
                    del again
                    if dtype == "float32":  # F32_CORE_FAULT in the plain core, autograd and all
                        with planted(core_products(plain_tf32)):
                            bad = grads(tbb.bigbird_train_plain, rounded, keep=keep)
                        core_fault = f32_tol_fault(got, bad, ("out",) + grad_names,
                                                   "bigbird_train")
                        del bad
                del got, want, keep

        # times at the slice's shapes, the kernels called directly
        ps, rs = list(params.values()), list(rounded.values())
        mask = bigbird_masks(device, BB_B, BB_L)
        hidden = randn(BB_B, BB_L, H).to(dt)
        kw = dict(pattern, seed=BB_SEED, sm_scale=HD**-0.5)
        with torch.no_grad():
            blk = timed_pair(
                lambda: bbk.fused_bigbird_attention_block(hidden, mask, *ps, **kw, **ln),
                lambda: bbk.bigbird_block_plain(hidden, mask, *rs, **kw, **ln), reps=5)
        t = bigbird_tables(BB_L // BB_BLOCK, BB_GLOBAL, BB_RANDOM, BB_SEED, device)
        work = bigbird_work(mask, BB_BLOCK, t, H, NH, HD)
        w = bbk.card_weights(*ps[:3], dt)
        flops = work["proj"] + work["core"] + work["out"]
        blk.update(split_bound(work["core"], work["proj"] + work["out"], nbytes(
            hidden, mask, *w.values(), params["out_bias"], *ln.values(), hidden), dtype))
        blk["work_gflop"] = flops / 1e9
        if dtype == "float32":  # against the 3xTF32 model, plain TF32 planted
            valid = mask.bool()
            blk_of = lambda fn, *p, **l: fn(hidden, mask, *p, **kw, **l)[valid]
            blk.update(check_f32_forward(
                "bigbird_attention_block", {
                    "out": blk_of(bbk.fused_bigbird_attention_block, *ps, **ln),
                    "projection": blk_of(bbk.fused_bigbird_attention_block, *ps)},
                lambda: {"out": blk_of(bbk.bigbird_block_plain, *rs, **ln),
                         "projection": blk_of(bbk.bigbird_block_plain, *rs)}, core=True))
        blk["library_ms"] = projections_library_ms(hidden, w, ("wqkv",),
                                                   f"bigbird_attention_block {dtype}")

        mask = bigbird_masks(device, BB_TRAIN_B, BB_TRAIN_L)
        m32 = mask.int().contiguous()
        hidden = randn(BB_TRAIN_B, BB_TRAIN_L, H).to(dt)
        cot = (randn(BB_TRAIN_B, BB_TRAIN_L, H) * mask.bool()[..., None]).to(dt)
        t = bigbird_tables(BB_TRAIN_L // BB_BLOCK, BB_GLOBAL, BB_RANDOM, BB_SEED, device)
        keep = tbb.bigbird_keep_masks(seed, BB_TRAIN_B, NH, BB_TRAIN_L, BB_BLOCK, t.G, t.R,
                                      DROPOUT)
        bo = params["out_bias"]
        cfg = dict(num_heads=NH, block_size=BB_BLOCK, sm_scale=HD**-0.5, dropout_rate=DROPOUT)
        plain = lambda h, *p: tbb.bigbird_train_plain(
            h, mask, *p, **pattern, pattern_seed=BB_SEED, sm_scale=HD**-0.5,
            dropout_rate=DROPOUT, keep=keep)
        with torch.no_grad():
            fwd = timed_pair(lambda: tbb.bigbird_train_fwd(hidden, m32, seed, w, bo, t, **cfg),
                             lambda: plain(hidden, *rs), reps=5)
        leaves = [p.detach().requires_grad_() for p in rs]
        h = hidden.detach().requires_grad_()
        out = plain(h, *leaves)
        bwd = timed_pair(lambda: tbb.bigbird_train_bwd(hidden, m32, seed, w, cot, t, **cfg),
                         lambda: torch.autograd.grad(out, [h, *leaves], cot, retain_graph=True),
                         reps=5)
        del out
        work = bigbird_work(mask, BB_BLOCK, t, H, NH, HD)
        io = nbytes(hidden, mask, *w.values(), bo)
        fwd.update(split_bound(work["core"], work["proj"] + work["out"], io + nbytes(seed, hidden),
                               dtype))
        fwd["library_ms"] = projections_library_ms(hidden, w, ("wqkv",),
                                                   f"bigbird_train_fwd {dtype}")
        if dtype == "float32":  # against the 3xTF32 model, plain TF32 planted
            valid = mask.bool()
            fbufs, bbufs = {}, {}
            with torch.no_grad():
                out = tbb.bigbird_train_fwd(hidden, m32, seed, w, bo, t, **cfg, buffers=fbufs)
            fwd.update(check_f32_forward("bigbird_train_fwd", {"out": out[valid]},
                                         lambda: {"out": plain(hidden, *rs)[valid]}, core=True))
            fwd["f32_tol_core_fault"], bwd["f32_tol_core_fault"] = core_fault["fwd"], core_fault["bwd"]
            tbb.bigbird_train_bwd(hidden, m32, seed, w, cot, t, **cfg, buffers=bbufs)
            same_recomputed("bigbird_train_bwd", fbufs, bbufs, ("qkv",))
            del out, fbufs, bbufs
        # recomputed attention; the backward's four attention products; and
        # the products: the recomputed projections, dctx, dx and the
        # projection weight gradients, dWo
        grads_out = nbytes(hidden) + 4 * (H * 3 * HN + 3 * HN + HN * H + H)
        bwd.update(split_bound(3 * work["core"], 3 * work["proj"] + 2 * work["out"],
                               io + nbytes(seed, cot) + grads_out, dtype))
        bwd["grad_bound_ms"] = grad_bound(work, BB_TRAIN_B * BB_TRAIN_L * HN, 4, 3,
                                          BB_TRAIN_B * NH * BB_TRAIN_L, dtype)
        bwd.update(long_backward_gemms(
            "bigbird_train_bwd", hidden, dt, w["wo"], lambda gr: (mask, None),
            lambda mk, gl, ck, gr, bufs, rate=DROPOUT: tbb.bigbird_train_bwd(
                hidden, m32, seed, w, ck, t, **dict(cfg, dropout_rate=rate), buffers=bufs),
            randn,
            lambda bufs, gr, rate=DROPOUT: tbb.bigbird_core_model_dproj(
                bufs, t, block_size=BB_BLOCK, sm_scale=HD**-0.5, dropout_rate=rate,
                keep=keep if rate else None), bwd["grad_bound_ms"]))
        del keep
        fwd["work_gflop"] = (work["proj"] + work["core"] + work["out"]) / 1e9
        bwd["work_gflop"] = (3 * work["proj"] + 3 * work["core"] + 2 * work["out"]) / 1e9
        for name, row in (("bigbird_attention_block", blk), ("bigbird_train_fwd", fwd),
                          ("bigbird_train_bwd", bwd)):
            rows[name, dtype] = {"max_abs_err": err[name], **row}
            print(f"kernel {name} {dtype}: max_abs_err {err[name]:.3e}  kernel {row['ms']:.3f} ms  "
                  f"plain {row['plain_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms "
                  f"({row['bound_by']}; {row['work_gflop']:.1f} GFLOP)")
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ PoNet kernel


def ponet_rows(device):
    """(mask, segment ids, tie rows) of kernel 9's phase (B=8, L=4096), as
    the MUG featuriser makes them: CLS in segment 0, one id a sentence of
    5-60 tokens, pads in the run n_sent + 1. Rows 0-1 full; 2-5 suffix-
    padded to 2048-4000 tokens (row 5 to 100, a meeting's short last
    window), their ids from where a later window of a meeting starts; row 6
    padded, with singleton sentences among the others
    and a pair of equal rows inside each longer run (returned as (b, l), l
    a copy of l - 1, so the s projections tie on the max); row 7 full, two
    ids alternating in runs of 5 (equal ids not adjacent)."""
    import torch

    rng = np.random.default_rng(9)
    mask = np.zeros((PN_B, PN_L), np.int32)
    seg = np.zeros((PN_B, PN_L), np.int32)
    ties = []
    for b in range(PN_B):
        if b == 7:
            seg[b] = np.where(np.arange(PN_L) % 10 < 5, 3, 7)
            seg[b, 0] = 0
            mask[b] = 1
            continue
        n = PN_L if b < 2 else 100 if b == 5 else int(rng.integers(2048, 4000))
        sid = int(rng.integers(100, 900)) if 2 <= b <= 5 else 1
        ids = [0]
        while len(ids) < n:
            run = 1 if b == 6 and rng.random() < 0.3 else int(rng.integers(5, 61))
            if b == 6 and run > 1:
                ties.append((b, len(ids) + 1))
            ids.extend([sid] * run)
            sid += 1
        seg[b, :n] = ids[:n]
        seg[b, n:] = sid
        mask[b, :n] = 1
    ties = [(b, l) for b, l in ties if mask[b, l]]
    return torch.from_numpy(mask).to(device), torch.from_numpy(seg).to(device), ties


def ponet_planted_faults():
    """{name: (function of ops/cuda/ponet_block.py, its faulty stand-in)}:
    SMP with the XLA mixer's semantics (pads merged into segment 0 with
    their s projections), SMP without the second-max trick, the LMP window
    shifted by one row, GA's mean query over all L rows."""
    import torch

    from spokennlp_tpu_torch.models.ponet import smp_second_max
    from spokennlp_tpu_torch.ops.cuda import ponet_block as pb

    def smp_xla(s, mrow, segment_ids):
        seg = torch.where(mrow[..., 0], segment_ids, 0)
        return smp_second_max(s, seg, s.shape[1] + 1)

    def smp_max_only(s, mrow, segment_ids):
        return pb.run_top2(torch.where(mrow, s.float(), pb.NEG_INF), segment_ids)[0].to(s.dtype)

    def ga_all_rows(q, k, v, mrow, sm_scale):
        g = q.float().mean(dim=1, keepdim=True).to(q.dtype)
        att = (k.float() * g.float()).sum(dim=2, keepdim=True) * sm_scale
        w = torch.softmax(att + torch.where(mrow, 0.0, pb.NEG_INF), dim=1).to(q.dtype)
        return (v.float() * w.float()).sum(dim=1, keepdim=True).to(q.dtype) * q

    return {"pads in segment 0 (XLA semantics)": ("smp_plain", smp_xla),
            "no second max": ("smp_plain", smp_max_only),
            "LMP window shifted": ("lmp_offsets",
                                   lambda w: range(-(w // 2) + 1, w - w // 2 + 1)),
            "GA mean over all rows": ("ga_plain", ga_all_rows)}


# kernel 9's float32 products in plain TF32 (the big x big term of the 3xTF32
# tile alone): a planted fault of the float32 check
PONET_TF32_FAULT = "products in plain TF32"
# Kernel 9 in float32 is checked in two parts, each within F32_TOL: its five
# projections (the kernel's own buffer) against the plain version's, and its
# output against the plain block fed those same projections. SMP's strict
# second maximum is discontinuous where two s values of a run tie on the
# maximum: a run whose top two values tie exactly in one version and differ
# by a rounding in the other moves its maximal rows by their gap to the third
# value. On the H100 the 3xTF32 projections (6.4e-6 of the largest off a
# float64 product, cuBLAS's float32 1.6e-6) broke one such chance tie of the
# plain version in phase 15's inputs: 2 of 24383 rows read 1.8e-2 of max
# |ref| end to end, every other row at most 6.4e-6 (PERF.md, section 6). Split
# there, each part is continuous, and the whole block is still checked.


def ponet_projections(pb, hidden, params):
    """The plain version's five projections (B*L, 5H) in hidden's dtype, its
    products through ponet_block.float_product (where the planted faults
    go)."""
    B_, L_, H_ = hidden.shape
    wp = params["proj_kernels"].to(hidden.dtype).permute(1, 0, 2).reshape(H_, 5 * H_)
    return (pb.float_product(hidden.reshape(B_ * L_, H_), wp)
            + params["proj_biases"].float().reshape(-1)).to(hidden.dtype)


def ponet_check(got, want, dtype: str, quantized: bool, proj=None):
    """(ok, max |err|, what was measured) of kernel 9's output against a
    plain version on real rows: W8A8 by w8a8_check, float modes by the
    largest error over the largest output; with proj = (the kernel's
    projections, the plain version's), those within the same limit too."""
    if quantized:
        c = w8a8_check(got, want, dtype)
        return c["ok"], c["max_abs_err"], f"{c['share']:.2e} of the outputs beyond rounding"
    err = (got - want).abs().max().item()
    rel, lim = err / max(want.abs().max().item(), 1e-30), limit("fused_ponet_mixer_block", dtype)
    if proj is None:
        return rel <= lim, err, f"max|err|/max|ref| {rel:.2e} (limit {lim})"
    pg, pw = (p.float() for p in proj)
    prel = ((pg - pw).abs().max() / pw.abs().max().clamp_min(1e-30)).item()
    return (max(rel, prel) <= lim, err, f"projections max|err|/max|ref| {prel:.2e}, the block on "
            f"them {rel:.2e} (limit {lim} each)")


def ponet_kernel_phase(device) -> dict:
    """{(name, dtype): row} for kernel 9 (the fused PoNet mixer block) at
    B=8, L=4096, H=768, window 3, in its float and W8A8 modes with bf16 and
    float32 activations, against its plain version on real rows; each
    planted fault must fail the same check."""
    from unittest import mock

    import torch

    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im
    from spokennlp_tpu_torch.ops.cuda import ponet_block as pb

    g = torch.Generator(device=device).manual_seed(6)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    mask, seg, ties = ponet_rows(device)
    valid = mask > 0
    params = dict(proj_kernels=randn(5, H, H, scale=H**-0.5), proj_biases=randn(5, H, scale=0.02),
                  out_kernel=randn(H, H, scale=H**-0.5), out_bias=randn(H, scale=0.02))
    ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
    # the rows of a sequence share a direction, as a trunk's hidden states
    # do, so GA's softmax over the sequence is not flat; the pads share
    # another, twice as long (a pad embedding is no word's)
    x = randn(PN_B, PN_L, H) + torch.where(valid[..., None], randn(PN_B, 1, H),
                                           randn(1, 1, H, scale=2.0))
    for b, l in ties:
        x[b, l] = x[b, l - 1]
    print(f"ponet kernel phase: {int(valid.sum())} real rows of {PN_B} x {PN_L}, "
          f"{len(ties)} tied pairs")
    faults = ponet_planted_faults()
    M = PN_B * PN_L
    rows = {}
    for quantized in (False, True):
        name = "fused_ponet_mixer_block" + ("_w8a8" if quantized else "")
        for dtype in ("bfloat16", "float32"):
            hidden = x.to(getattr(torch, dtype))
            call = lambda fn, **kw: fn(hidden, mask, seg, *params.values(),
                                       local_window=PN_WINDOW, sm_scale=H**-0.5,
                                       quantized=quantized, **ln, **kw)
            bufs = {}
            got = call(pb.fused_ponet_mixer_block, buffers=bufs)
            torch.cuda.synchronize()
            got = got[valid].float()
            if not torch.isfinite(got).all():
                fail(f"{name} {dtype}: non-finite output")
            # float32: the projections, then the rest of the block on the
            # kernel's own projections (the note above ponet_projections)
            split = not quantized and dtype == "float32"
            proj = bufs["proj"] if split else None
            check = lambda: ponet_check(
                got, call(pb.ponet_mixer_block_plain, proj=proj)[valid].float(), dtype,
                quantized, None if proj is None else (proj, ponet_projections(pb, hidden, params)))
            ok, err, what = check()
            print(f"  {name} {dtype}: {what}")
            if not ok:
                fail(f"{name} {dtype} against its plain version: {what}")
            mode_faults = dict(faults)
            if split:
                mode_faults[PONET_TF32_FAULT] = (
                    "float_product", lambda a, b: im.tf32x3_product(a, b, terms=1))
            for fault, (attr, fn) in mode_faults.items():
                with mock.patch.object(pb, attr, fn):
                    accepted, _, what = check()
                print(f"  planted fault, {fault} ({name} {dtype}): {what}: "
                      + ("ACCEPTED" if accepted else "rejected"))
                if accepted:
                    fail(f"{name} {dtype}: the check accepts the planted fault {fault}")
            del got, bufs, proj
            row = timed_pair(lambda: call(pb.fused_ponet_mixer_block),
                             lambda: call(pb.ponet_mixer_block_plain), reps=5)
            # the six products, and GA, the pools, the mix and the epilogue
            # (about 20 float32 operations an element); float32's products
            # as the 3xTF32 tile takes them on the tensor cores, and beside
            # them on the CUDA cores (simt_bound_ms)
            products, elementwise = 12 * M * H * H, 20 * M * H
            io = nbytes(hidden, mask, seg, *params.values(), *ln.values(), hidden)
            ptype = "int8" if quantized else "tf32x3" if dtype == "float32" else dtype
            row.update(bound({ptype: products, "float32": elementwise}, io))
            if ptype == "tf32x3":
                row["simt_bound_ms"] = bound(products + elementwise, io, "float32")["bound_ms"]
            row.update(max_abs_err=err, work_gflop=(products + elementwise) / 1e9)
            if quantized:  # the library column: torch._int_mm on the six products only
                x8 = im.rowquant_plain(hidden.reshape(M, H))[0]
                wp8 = im.quantize_colwise(params["proj_kernels"])[0]
                wo8 = im.quantize_colwise(params["out_kernel"])[0]
                row["library_ms"] = int_mm_time([(x8, w) for w in (*wp8, wo8)],
                                                f"{name} {dtype}")
                del x8
            else:  # torch.matmul on the two products (float32: TF32 off)
                dt = getattr(torch, dtype)
                x2 = hidden.reshape(M, H)
                wp = params["proj_kernels"].permute(1, 0, 2).reshape(H, 5 * H).to(dt)
                wo, mixed = params["out_kernel"].to(dt), randn(M, H).to(dt)
                row["library_ms"] = library_time(lambda: (x2 @ wp, mixed @ wo),
                                                 f"{name} {dtype} (torch.matmul on its products)")
                del wp, wo, mixed
            rows[name, dtype] = row
            print(f"kernel {name} {dtype}: max_abs_err {err:.3e}  kernel {row['ms']:.3f} ms  "
                  f"plain {row['plain_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms "
                  f"({row['bound_by']}; {row['work_gflop']:.1f} GFLOP)"
                  + (f"; on the CUDA cores {row['simt_bound_ms']:.3f} ms"
                     if "simt_bound_ms" in row else ""))
            torch.cuda.empty_cache()
    return rows


# ------------------------------------------- W8A8 long-context and kernel modes


def int_mm_time(pairs, name) -> float:
    """torch._int_mm over int8 (A, B) products (the library's int8 GEMM, B
    passed column-major as it takes it): a W8A8 row's library_ms."""
    import torch

    cols = [(a, b.t().contiguous().t()) for a, b in pairs]
    return library_time(lambda: [torch._int_mm(a, b) for a, b in cols], f"{name} (torch._int_mm)")


def w8a8_long_kernel_phase(device) -> dict:
    """{(name, dtype): row} for the W8A8 modes of kernel 7 (B=8, L=2048, with
    and without global rows) and kernel 8 (B=4, L=4096, the 100-token row
    among them), bf16 and float32: each against its plain version on real
    rows (w8a8_check) with three planted faults that must fail the check and
    one reported; kernel, plain, bound and torch._int_mm times."""
    import torch

    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import bigbird_block as bbk
    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im
    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
    from spokennlp_tpu_torch.ops.cuda.attention_block import quantize_attention_weights

    g = torch.Generator(device=device).manual_seed(7)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    HN = NH * HD
    weight = lambda: dict(qkv_kernel=randn(H, 3, NH, HD, scale=H**-0.5),
                          qkv_bias=randn(3, NH, HD, scale=0.02))
    rows = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        reported = (CTX_BF16_FAULT,) + tuple(
            f for f in LONG_W8A8_FAULTS if dtype == "bfloat16" and f not in BF16_GATED_FAULTS)
        ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
        out_w = lambda: dict(out_kernel=randn(NH, HD, H, scale=HN**-0.5),
                             out_bias=randn(H, scale=0.02))

        # kernel 7 W8A8
        gw = weight()
        params = {**weight(), "gqkv_kernel": gw["qkv_kernel"], "gqkv_bias": gw["qkv_bias"],
                  **out_w()}
        params = {k: params[k] for k in ("qkv_kernel", "qkv_bias", "gqkv_kernel", "gqkv_bias",
                                         "out_kernel", "out_bias")}
        ps = list(params.values())
        hidden = randn(LF_B, LF_L, H).to(dt)
        kw = dict(sm_scale=HD**-0.5, window=LF_WINDOW, max_globals=LF_MAX_GLOBALS, **ln)
        for global_rows in (True, False):
            mask, glob = sliding_masks(device, global_rows)
            gkw = dict(kw, global_rows=global_rows)
            plain_of = lambda: sb.sliding_block_plain(hidden, mask, glob, *ps, quantized=True,
                                                      **gkw)
            row = compare(f"sliding_attention_block W8A8 global_rows={global_rows}", dtype,
                          lambda: sb.fused_sliding_attention_block(hidden, mask, glob, *ps,
                                                                   quantized=True, **gkw),
                          plain_of, mask.bool(), w8a8=True, reps=5,
                          model=lambda: on_card_rows(dtype, plain_of))
            if global_rows:
                plain = lambda: sb.sliding_block_plain(hidden, mask, glob, *ps, quantized=True,
                                                       **gkw)
                want, valid, rows_g = plain(), mask.bool(), glob.bool() & mask.bool()
                planted_rows = {}
                for f, patches in long_w8a8_faults(sb, NH).items():
                    with planted(patches):
                        planted_rows[f] = (plain(), want, rows_g if f == GLOBAL_FAULT else valid)
                check_planted(planted_rows, dtype, reported=reported)
                del want, planted_rows
                work = sliding_work(mask, glob, LF_WINDOW, H, NH, HD)
                w = sb.quantize_sliding_weights(ps[0], ps[2], ps[4])
                moved = nbytes(hidden, mask, glob, *w.values(), *ps[1:4:2], ps[5], *ln.values(),
                               hidden)
                row.update(bound({"int8": work["proj"] + work["out"],
                                  core_type(dtype): work["core"]}, moved))
                x8, _ = im.rowquant_plain(hidden.reshape(-1, H))
                xg8 = x8.reshape(LF_B, LF_L, H)[:, :sb.global_columns(LF_MAX_GLOBALS, LF_L)]
                # the ctx's int8 operand has x8's shape (Hn = H): x8 stands in for it
                row["library_ms"] = int_mm_time(
                    [(x8, w["wqkv8"]), (x8, w["wgkv8"]), (xg8.reshape(-1, H), w["wgq8"]),
                     (x8, w["wo8"])], f"sliding_attention_block W8A8 {dtype}")
                row["work_gop"] = (work["proj"] + work["core"] + work["out"]) / 1e9
                rows["sliding_attention_block_w8a8", dtype] = row
        del hidden

        # kernel 8 W8A8
        params = {**weight(), **out_w()}
        ps = list(params.values())
        pattern = (BB_BLOCK, BB_GLOBAL, BB_RANDOM, BB_SEED, HD**-0.5)
        mask = bigbird_masks(device, BB_B, BB_L)
        hidden = randn(BB_B, BB_L, H).to(dt)
        args = (hidden, mask, *ps, *pattern)
        row = compare("bigbird_attention_block W8A8", dtype,
                      lambda: bbk.fused_bigbird_attention_block(*args, quantized=True, **ln),
                      lambda: bbk.bigbird_block_plain(*args, quantized=True, **ln), mask.bool(),
                      w8a8=True, reps=5, model=lambda: on_card_rows(
                          dtype, lambda: bbk.bigbird_block_plain(*args, quantized=True, **ln)))
        want = bbk.bigbird_block_plain(*args, quantized=True, **ln)
        planted_rows = {}
        for f, patches in long_w8a8_faults(bbk, NH).items():
            with planted(patches):
                planted_rows[f] = (bbk.bigbird_block_plain(*args, quantized=True, **ln), want,
                                   mask.bool())
        check_planted(planted_rows, dtype, reported=reported)
        del want, planted_rows
        t = bigbird_tables(BB_L // BB_BLOCK, BB_GLOBAL, BB_RANDOM, BB_SEED, device)
        work = bigbird_work(mask, BB_BLOCK, t, H, NH, HD)
        wqkv8, swqkv, wo8, swo = quantize_attention_weights(ps[0], ps[2], 1)
        moved = nbytes(hidden, mask, wqkv8, swqkv, wo8, swo, ps[1], ps[3], *ln.values(), hidden)
        row.update(bound({"int8": work["proj"] + work["out"], core_type(dtype): work["core"]},
                         moved))
        x8, _ = im.rowquant_plain(hidden.reshape(-1, H))
        row["library_ms"] = int_mm_time([(x8, wqkv8), (x8, wo8)],
                                        f"bigbird_attention_block W8A8 {dtype}")
        row["work_gop"] = (work["proj"] + work["core"] + work["out"]) / 1e9
        rows["bigbird_attention_block_w8a8", dtype] = row
        del hidden, args
        for name in ("sliding_attention_block_w8a8", "bigbird_attention_block_w8a8"):
            r = rows[name, dtype]
            print(f"kernel {name} {dtype}: kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
                  f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}; {r['work_gop']:.1f} GOP)  "
                  f"torch._int_mm {r['library_ms']:.3f} ms")
        torch.cuda.empty_cache()
    return rows


def core_static_kernel_phase(device) -> dict:
    """{(name, dtype): row} for the last two kernel modes at the main path's
    shapes (B=32, L=512, padded tails and two packed segments), bf16 and
    float32: the W8A8 MLP block with a static intermediate scale (2b) and
    the W8A8 attention block with the int8 core (1c) in each of "qk", "av"
    and "both" at head groups of 12 and 6, each against its plain version
    (w8a8_check; a "qk" core on every row, since a row with no allowed key
    is uniform by construction), with planted faults; times, bounds and
    torch._int_mm on the int8 products."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im
    from spokennlp_tpu_torch.ops.cuda.attention_block import (
        attention_block_plain, fused_attention_block, quantize_attention_weights,
    )
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain

    g = torch.Generator(device=device).manual_seed(8)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    seg = segments(device)
    M, HN = B * L, NH * HD
    rows = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))

        # 2b: the static intermediate scale
        mlp = dict(x=randn(M, H).to(dt), w1=randn(H, I, scale=H**-0.5), b1=randn(I, scale=0.02),
                   w2=randn(I, H, scale=I**-0.5), b2=randn(H, scale=0.02), **ln)
        kw = dict(activation="gelu", eps=1e-12, quantized=True, static_h_scale=True)
        row = compare("fused_mlp_block W8A8 static_h_scale", dtype,
                      lambda: fused_mlp_block(*mlp.values(), **kw),
                      lambda: mlp_block_plain(*mlp.values(), **kw), slice(None), w8a8=True)
        (w1q, _), (w2q, _) = im.quantize_colwise(mlp["w1"]), im.quantize_colwise(mlp["w2"])
        x8, _ = im.rowquant_plain(mlp["x"])
        h8 = torch.randint(-127, 128, (M, I), dtype=torch.int8, device=device)  # h8's shape
        row.update(bound({"int8": 4 * M * H * I}, nbytes(*mlp.values(), mlp["x"])))
        row["library_ms"] = int_mm_time([(x8, w1q), (h8, w2q)],
                                        f"fused_mlp_block static_h_scale {dtype}")
        rows["fused_mlp_block_static_h", dtype] = row

        # 1c: the int8 attention core
        att = dict(hidden=randn(B, L, H).to(dt), segment_ids=seg,
                   qkv_kernel=randn(H, 3, NH, HD, scale=H**-0.5),
                   qkv_bias=randn(3, NH, HD, scale=0.02),
                   out_kernel=randn(NH, HD, H, scale=HN**-0.5), out_bias=randn(H, scale=0.02),
                   **ln)
        modes = {}
        for core in ("qk", "av", "both"):
            every = torch.ones_like(seg, dtype=torch.bool) if core != "av" else seg > 0
            for hb in (NH, NH // 2):
                kw = dict(sm_scale=HD**-0.5, quantized=True, heads_per_block=hb, core_int8=core)
                r = compare(f"fused_attention_block W8A8 core_int8={core} heads_per_block={hb}",
                            dtype, lambda: fused_attention_block(**att, **kw),
                            lambda: attention_block_plain(**att, **kw), every, w8a8=True,
                            reps=10 if hb == NH else 2)
                if hb == NH:
                    modes[core] = r
        # the core's products: int8 where the mode quantises them, else dtype
        half = 2 * B * NH * L * L * HD
        wqkv8, _, wo8, _ = quantize_attention_weights(att["qkv_kernel"], att["out_kernel"], 1)
        x8, _ = im.rowquant_plain(att["hidden"].reshape(M, H))
        lib = int_mm_time([(x8, wqkv8), (x8, wo8)], f"fused_attention_block core_int8 {dtype}")
        moved = nbytes(*att.values(), att["hidden"])
        for core, r in modes.items():
            ops = {"int8": 2 * M * H * 3 * HN + 2 * M * HN * H + half * (1 + (core == "both")),
                   dtype: half * (core != "both")}
            r.update(bound(ops, moved))
            r["library_ms"] = lib
        row = dict(modes["both"])
        row["modes"] = {core: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                        for core, r in modes.items()}
        rows["fused_attention_block_core_int8", dtype] = row
        check_planted({f: core_mlp_fault(f, att, mlp, sm_scale=HD**-0.5, hb=NH // 2)
                       for f in CORE_MLP_FAULTS}, dtype)
        print(f"kernel fused_mlp_block_static_h {dtype}: kernel "
              f"{rows['fused_mlp_block_static_h', dtype]['ms']:.3f} ms; fused_attention_block "
              f"core_int8 {dtype}: " + ", ".join(
                  f"{c} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.3f})"
                  for c, r in modes.items()) + f"; torch._int_mm {lib:.3f} ms")
        del att, mlp
        torch.cuda.empty_cache()
    return rows


def long_serving_model(trunk: str, quantize: str, attention_impl: str):
    """The W8A8 long-context serving model as JAX's on-chip suite builds it
    (tests/test_tpu_kernel_parity.py _build): TopicSegModel at BERT-base
    widths, 12 layers, softmax in the compute type, bf16 compute, float32
    parameters, ``trunk`` Longformer (window 512, 16 global tokens at most,
    2048 positions) or BigBird (blocks of 64, 2 global and 3 random, seed 0,
    4096 positions); weights from seed 0 drawn on the card, the same on
    every call."""
    import torch

    from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

    shape = (dict(attention_type="sliding_window", attention_window=LF_WINDOW,
                  max_global_tokens=LF_MAX_GLOBALS, max_position_embeddings=LF_L)
             if trunk == "longformer" else
             dict(attention_type="bigbird", bigbird_block_size=BB_BLOCK,
                  bigbird_num_global_blocks=BB_GLOBAL, bigbird_num_random_blocks=BB_RANDOM,
                  bigbird_seed=BB_SEED, max_position_embeddings=BB_L))
    enc = EncoderConfig(vocab_size=30522, hidden_size=H, num_layers=LAYERS, num_heads=NH,
                        intermediate_size=I, add_pooler=False, softmax_in_compute_dtype=True,
                        quantize=quantize, attention_impl=attention_impl, **shape)
    with torch.device("cuda"):
        model = TopicSegModel(enc, TopicSegConfig(), dtype=torch.bfloat16,
                              generator=torch.Generator(device="cuda").manual_seed(0))
    return model.eval()


def long_serving_path(trunk: str, data_dir: str, out_dir: str) -> dict:
    """The W8A8 long-context serving configuration through the engine call
    (run_topic_seg_inference) on the Longformer (batch 8 x 2048) or BigBird
    (batch 4 x 4096) corpus: the W8A8 kernel path (attention_impl auto:
    kernel 7 or 8 and the MLP block in their W8A8 modes once a layer a
    batch), the W8A8 einsum path (kernels 4 and 5, chunked or block
    attention) and the float kernel path; each timed over RUNS_PER_PATH
    calls (median windows/s) with its peak memory, the W8A8 kernel path also
    profiled. Gates: JAX's on-chip parity (_assert_parity) of the W8A8
    kernel path's token logits against the unquantised bf16 chunked or block
    path on two batches with suffix padding (argmax >= 0.999, mean |dlogit|
    <= 0.1 on real tokens), and argmax >= MIN_ARGMAX_AGREEMENT against the W8A8
    einsum path at the sentence slots of the first two batches."""
    import torch

    from spokennlp_tpu_torch.cli import common, run_inference
    from spokennlp_tpu_torch.data.windowing_fast import window_documents_stacked
    from spokennlp_tpu_torch.eval.inference import predict_windows_scanned, run_topic_seg_inference
    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.bigbird_block import fused_bigbird_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.sliding_block import fused_sliding_attention_block
    from spokennlp_tpu_torch.train.profiling import kernel_times

    lf = trunk == "longformer"
    seq, bs, block_name = ((LF_L, LF_B, "sliding_attention_block") if lf else
                           (BB_L, BB_B, "bigbird_attention_block"))
    argv = main_path_argv(data_dir, out_dir, seq=seq, batch=bs,
                          **({"window": LF_WINDOW} if lf else {"bigbird": True}))
    args = run_inference.make_parser().parse_args(argv)
    tokenize_fn, special = common.resolve_tokenizer(args)
    _, _, wcfg, _ = common.build_configs(args, special)
    docs = common.load_docs(args, tokenize_fn)["test"]
    batch = window_documents_stacked(docs, wcfg)
    n = batch["input_ids"].shape[0]
    n_real = batch["attention_mask"].sum(1)
    padded, full = np.flatnonzero(n_real < seq), np.flatnonzero(n_real == seq)
    # two batches, each half suffix-padded windows and half full ones
    half = bs // 2
    if len(padded) < 2 * half or len(full) < 2 * (bs - half):
        fail(f"{trunk} serving: {len(padded)} padded and {len(full)} full windows, too few")
    pick = np.concatenate([padded[:half], full[:bs - half], padded[half:2 * half],
                           full[bs - half:2 * (bs - half)]])
    gate_batch = {k: v[pick] for k, v in batch.items()}
    first = {k: v[:2 * bs] for k, v in batch.items()}
    live = first["sent_labels"] != -100
    real = gate_batch["attention_mask"] > 0
    wrappers = {block_name: fused_sliding_attention_block if lf else fused_bigbird_attention_block,
                "fused_mlp_block": fused_mlp_block,
                "fused_attention_block": fused_attention_block,
                "w8a8_matmul_bf16in": im.w8a8_matmul_bf16in, "w8a8_matmul": im.w8a8_matmul}
    kernel_path = {block_name: LAYERS, "fused_mlp_block": LAYERS}
    # (quantize, attention_impl, launches a batch; None: the gate's reference, not timed)
    runs = [("w8a8", "auto", kernel_path),
            ("w8a8", "einsum", {"w8a8_matmul_bf16in": 4 * LAYERS, "w8a8_matmul": 4 * LAYERS}),
            ("none", "auto", kernel_path), ("none", "einsum", None)]
    n_batches = math.ceil(n / bs)
    res = {}
    for quantize, impl, per_batch in runs:
        key = f"{quantize} {impl}"
        model = long_serving_model(trunk, quantize, impl)
        row = {}
        if per_batch is not None:
            reset_counts(wrappers)
            reset_peak()
            calls = []
            for i in range(RUNS_PER_PATH):
                t0 = time.perf_counter()
                out = run_topic_seg_inference(model, docs, wcfg, batch_size=bs, threshold=0.5)
                calls.append(n / (time.perf_counter() - t0))  # ends in a copy to the host
                if i == 0:
                    launches = read_counts(wrappers)
                    expected = {k: per_batch.get(k, 0) * n_batches for k in wrappers}
                    if launches != expected:
                        fail(f"{trunk} serving {key}: launches {launches}, expected {expected}")
                    if not np.isfinite(list(out["metrics"].values())).all():
                        fail(f"{trunk} serving {key}: non-finite metrics {out['metrics']}")
            row = {"windows_per_s": float(np.median(calls)), "calls_windows_per_s": calls,
                   "peak_gib": peak_gib(), "launches": {k: v for k, v in launches.items() if v}}
            print(f"{trunk} serving {key}: {n} windows in {n_batches} batches of {bs}, "
                  f"windows/s {row['windows_per_s']:.2f} (median of "
                  f"{', '.join(f'{c:.2f}' for c in calls)}), peak {row['peak_gib']:.2f} GiB, "
                  f"launches {row['launches']}")
            if (quantize, impl) == ("w8a8", "auto"):
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    run_topic_seg_inference(model, docs, wcfg, batch_size=bs, threshold=0.5)
                    traced_ms = (time.perf_counter() - t0) * 1e3
                k = kernel_times(prof)
                row["busy_share"] = k.pop("_busy_ms") / traced_ms
                total = sum(v["ms"] for v in k.values())
                top = sorted(k.items(), key=lambda kv: -kv[1]["ms"])[:6]
                row["top_kernels"] = {name: {"ms": v["ms"], "share": v["ms"] / total,
                                             "launches": v["launches"]} for name, v in top}
                print(f"  profiled engine call: busy share {row['busy_share']:.4f} of "
                      f"{traced_ms:.1f} ms; top kernels " + ", ".join(
                          f"{name} {v['ms']:.1f} ms ({v['share']:.3f})"
                          for name, v in row["top_kernels"].items()))
        row["token_logits"] = predict_windows_scanned(model, gate_batch, bs).astype(np.float32)
        row["sent_logits"] = predict_windows_scanned(model, first, bs, gather_sents=True)[live]
        res[key] = row
        del model
        torch.cuda.empty_cache()

    kern, ref = res["w8a8 auto"], res["none einsum"]
    a, b = kern["token_logits"][real], ref["token_logits"][real]
    gate = {"argmax": float((a.argmax(-1) == b.argmax(-1)).mean()),
            "mean_dlogit": float(np.abs(a - b).mean()), "max_dlogit": float(np.abs(a - b).max()),
            "tokens": int(real.sum())}
    print(f"{trunk} W8A8 kernel path vs unquantised bf16 {'chunked' if lf else 'block'} path on "
          f"{gate['tokens']} real tokens of 2 batches ({int((gate_batch['attention_mask'].sum(1) < seq).sum())} "
          f"windows suffix-padded): argmax {gate['argmax']:.4f}, mean |dlogit| "
          f"{gate['mean_dlogit']:.4f}, max {gate['max_dlogit']:.4f}")
    if gate["argmax"] < PARITY_ARGMAX or gate["mean_dlogit"] > PARITY_MEAN_DLOGIT:
        fail(f"{trunk} W8A8 parity: argmax {gate['argmax']:.4f} (>= {PARITY_ARGMAX}), mean "
             f"|dlogit| {gate['mean_dlogit']:.4f} (<= {PARITY_MEAN_DLOGIT})")
    agree = {}
    for other in ("w8a8 einsum", "none auto"):
        x, y = kern["sent_logits"], res[other]["sent_logits"]
        agree[other] = float((x.argmax(-1) == y.argmax(-1)).mean())
        gated = other == "w8a8 einsum"
        print(f"{trunk} W8A8 kernel path vs {other} on {int(live.sum())} labelled sentences: "
              f"argmax {agree[other]:.4f}, max |dlogit| {float(np.abs(x - y).max()):.4f}"
              + ("" if gated else " (printed, not gated)"))
        if gated and agree[other] < MIN_ARGMAX_AGREEMENT:
            fail(f"{trunk} W8A8 agreement with the W8A8 einsum path {agree[other]:.4f} < "
                 f"{MIN_ARGMAX_AGREEMENT}")
    for row in res.values():
        row.pop("token_logits"), row.pop("sent_logits")
    res.pop("none einsum")
    return {"runs": res, "windows": n, "parity": gate, "agreement": agree}


# ------------------------------------------------------------ main paths


def write_corpus(root: Path, n_test_docs: int, n_train_docs: int = 2, seed: int = 0,
                 sentences=(60, 120)) -> str:
    """A wiki_section corpus (train/dev/test jsonl of {"sentences", "labels"})
    of documents of ``sentences`` = (fewest, most) sentences."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(2000)]
    d = root / f"wiki_section_{seed}"
    d.mkdir()
    for split, n in (("train.jsonl", n_train_docs), ("dev.jsonl", 2), ("test.jsonl", n_test_docs)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(*sentences))
                sents = [" ".join(rng.choice(words, size=rng.integers(6, 20))) for _ in range(ns)]
                labels = [int(rng.random() < 0.15) for _ in range(ns)]
                labels[-1] = 1
                f.write(json.dumps({"sentences": sents, "labels": labels}) + "\n")
    return str(d)


def main_path_argv(data_dir, out_dir, device="cuda", hidden=H, layers=LAYERS, heads=NH,
                   inter=I, seq=L, batch=B, window=None, bigbird=False):
    """run_inference flags; ``window`` makes the trunk Longformer's,
    ``bigbird`` BigBird's."""
    trunk = (["--attention_type", "sliding_window", "--attention_window", str(window)] if window
             else ["--attention_type", "bigbird"] if bigbird else [])
    return [
        "--data_dir", data_dir, "--output_dir", out_dir, "--device", device,
        "--hidden_size", str(hidden), "--num_hidden_layers", str(layers),
        "--num_attention_heads", str(heads), "--intermediate_size", str(inter),
        "--max_seq_length", str(seq), "--dtype", "bfloat16",
        "--per_device_eval_batch_size", str(batch), "--threshold", "0.5",
    ] + trunk


def train_argv(data_dir, out_dir, batch=B, **kw):
    """run_finetune flags of the composite step (bench.py --train): DA view,
    TSSP, eop_matrix CSSL; one epoch, no accumulation, metrics every step."""
    return main_path_argv(data_dir, out_dir, batch=batch, **kw) + [
        "--do_train", "--do_eval", "--do_predict", "--num_train_epochs", "1",
        "--per_device_train_batch_size", str(batch), "--gradient_accumulation_steps", "1",
        "--logging_steps", "1", "--do_da_ts", "--do_tssp", "--tssp_loss_weight", "1.0",
        "--cl_loss_weight", "0.5", "--cl_anchor_level", "eop_matrix",
    ]


def longformer_train_argv(data_dir, out_dir, epochs: float, **kw):
    """run_finetune flags of the reference's Longformer recipe
    (scripts/run_finetune.sh: batch 2, 4 accumulation steps, DA + TSSP,
    eop_list CSSL, lr 5e-5, bf16) but the epochs; metrics every step. The
    BigBird slice runs the same flags with ``window=None, bigbird=True``."""
    kw = {"seq": LF_L, "window": LF_WINDOW, "batch": LF_B, **kw}
    return main_path_argv(data_dir, out_dir, **kw) + [
        "--do_train", "--do_eval", "--do_predict", "--num_train_epochs", repr(epochs),
        "--per_device_train_batch_size", str(LF_TRAIN_B),
        "--gradient_accumulation_steps", str(LF_ACCUM), "--logging_steps", "1", "--do_tssp",
        "--do_da_ts", "--tssp_loss_weight", "1.0", "--cl_anchor_level", "eop_list",
        "--cl_loss_weight", "0.5", "--cl_temp", "0.1", "--learning_rate", "5e-5",
    ]


def cli_default_dtype(argv) -> list:
    """``argv`` without its ``--dtype``: the CLI's default, float32."""
    i = argv.index("--dtype")
    return argv[:i] + argv[i + 2:]


def epochs_for_steps(argv, steps: int) -> float:
    """The --num_train_epochs that makes the trainer take exactly ``steps``
    optimizer steps on the corpus and batch of ``argv`` (it counts the
    training windows as TopicSegTrainer does)."""
    from spokennlp_tpu_torch.cli import common, run_finetune
    from spokennlp_tpu_torch.data.featurization import featurize_paired

    args = run_finetune.make_parser().parse_args(argv)
    tokenize_fn, special = common.resolve_tokenizer(args)
    _, task_cfg, wcfg, tcfg = common.build_configs(args, special)
    docs = common.load_docs(args, tokenize_fn)["train"]
    n = len(featurize_paired(docs, wcfg, np.random.default_rng(tcfg.seed), task_cfg.tssp_ablation))
    per_epoch = max(n // args.per_device_train_batch_size, 1)
    return (steps * args.gradient_accumulation_steps + 0.5) / per_epoch


def main_path(argv, n_layers, batch_size, kernels=None, long_tokens=None,
              kernel_impl="auto") -> dict:
    """Run the inference CLI; check launches, metrics and logits against
    einsum (for Longformer the chunked path, for BigBird the block path).
    ``kernels``: {name: wrapper} that must run once per layer per batch (the
    dense pair by default); ``long_tokens``: check that at least
    LF_MIN_LONG_SHARE of the windows hold that many real tokens;
    ``kernel_impl``: the attention_impl of the kernels' path (argv's)."""
    import torch

    from spokennlp_tpu_torch.cli import common, run_inference
    from spokennlp_tpu_torch.data.windowing_fast import window_documents_stacked
    from spokennlp_tpu_torch.eval.inference import predict_windows_scanned
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block

    wrappers = kernels or {"fused_attention_block": fused_attention_block,
                           "fused_mlp_block": fused_mlp_block}
    reset_counts(wrappers)
    reset_peak()
    out = run_inference.main(argv)
    launches = read_counts(wrappers)
    peak = peak_gib()
    n_windows = out["num_windows"]
    n_batches = math.ceil(n_windows / batch_size)
    for name, n in launches.items():
        if n != n_layers * n_batches:
            fail(f"{name} ran {n} times, expected {n_layers} layers x {n_batches} batches")
    metrics = out["metrics"]
    if not np.isfinite(list(metrics.values())).all():
        fail(f"non-finite metrics {metrics}")
    windows_per_s = n_windows / out["predict_time_s"]
    print(f"inference main path: {n_windows} windows in {n_batches} batches, "
          f"{out['predict_time_s']:.3f} s in the engine call ({windows_per_s:.1f} windows/s), "
          f"peak {peak:.2f} GiB; launches {launches}")

    # the same weights on the einsum path, on the first batch
    results = {}
    for impl in (kernel_impl, "einsum"):
        args = run_inference.make_parser().parse_args(argv + ["--attention_impl", impl])
        tokenize_fn, special = common.resolve_tokenizer(args)
        enc_cfg, task_cfg, wcfg, _ = common.build_configs(args, special)
        model = run_inference.build_model(args, enc_cfg, task_cfg)
        docs = common.load_docs(args, tokenize_fn)["test"]
        batch = window_documents_stacked(docs, wcfg)
        if long_tokens and impl == kernel_impl:
            share = float((batch["attention_mask"].sum(1) >= long_tokens).mean())
            print(f"windows holding >= {long_tokens} real tokens: {share:.3f}")
            if share < LF_MIN_LONG_SHARE:
                fail(f"only {share:.3f} of the windows hold >= {long_tokens} tokens")
        first = {k: v[:batch_size] for k, v in batch.items()}
        results[impl] = predict_windows_scanned(model, first, batch_size, gather_sents=True)
        if impl == "einsum":
            # the plain path's engine call over every window, for PERF.md
            reset_peak()
            t0 = time.perf_counter()
            predict_windows_scanned(model, batch, batch_size, gather_sents=True)
            einsum_s = time.perf_counter() - t0  # ends in a copy to the host
            einsum_peak = peak_gib()
            print(f"einsum path engine call: {len(batch['input_ids']) / einsum_s:.1f} windows/s, "
                  f"peak {einsum_peak:.2f} GiB")
        del model
        torch.cuda.empty_cache()
    live = first["sent_labels"] != -100
    fused, einsum = results[kernel_impl][live], results["einsum"][live]
    agreement = float((fused.argmax(-1) == einsum.argmax(-1)).mean())
    max_dlogit = float(np.abs(fused - einsum).max())
    print(f"fused vs einsum on {int(live.sum())} labelled sentences of one batch: "
          f"argmax agreement {agreement:.4f}, max |dlogit| {max_dlogit:.4f}")
    if agreement < MIN_ARGMAX_AGREEMENT:
        fail(f"argmax agreement {agreement:.4f} < {MIN_ARGMAX_AGREEMENT}")
    return {"launches": launches, "windows": n_windows, "windows_per_s": windows_per_s,
            "peak_gib": peak, "einsum_windows_per_s": n_windows / einsum_s,
            "einsum_peak_gib": einsum_peak, "agreement": agreement, "max_dlogit": max_dlogit,
            "metrics": metrics}


def write_mug_corpus(root: Path, n_train: int, n_eval: int, seed: int = 4) -> Path:
    """MUG meeting jsonl (train.jsonl, dev.jsonl): sentences of 4-59 words
    (runs of 5-60 tokens with the EOS marker under the fallback tokenizer),
    train meetings of 200-240 sentences, eval meetings of 480-560 (about
    four 4096-token windows each), topics of 20-60 sentences with key
    sentences and key words, a meeting-level candidate."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(2000)]

    def meeting(key, sentences):
        ns = int(rng.integers(*sentences))
        sents = [{"id": j + 1, "s": " ".join(rng.choice(words, size=int(rng.integers(4, 60))))}
                 for j in range(ns)]
        ends, e = [], 0
        while e < ns:
            e = min(ns, e + int(rng.integers(20, 61)))
            ends.append(e)
        topics = [{"id": end, "candidate": [{
            "title": f"t{end}", "key_word": [words[end]],
            "key_sentence": sorted(set(rng.integers(start + 1, end + 1, size=3).tolist()))}]}
            for start, end in zip([0] + ends[:-1], ends)]
        return {"meeting_key": key, "sentences": sents,
                "paragraph_segment_ids": [{"id": j} for j in range(10, ns + 1, 10)],
                "topic_segment_ids": topics,
                "candidate": [{"key_word": words[:3], "key_sentence": [1, 5, 9]}]}

    root.mkdir(parents=True)
    for name, n, sentences in (("train.jsonl", n_train, (200, 241)),
                               ("dev.jsonl", n_eval, (480, 561))):
        with open(root / name, "w") as f:
            for i in range(n):
                f.write(json.dumps(meeting(f"{name[:3]}{i}", sentences)) + "\n")
    return root


def ponet_checkpoints(root: Path, device="cuda") -> dict:
    """PoNet-base checkpoints written by models/checkpoint_io.save_checkpoint:
    weights drawn on ``device`` from seed 0, the config's ponet_mixer_impl
    "fused"; a second directory with the same params.msgpack and
    quantize="w8a8" in its config.json."""
    import dataclasses
    import os

    import torch

    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models import checkpoint_io
    from spokennlp_tpu_torch.models.ponet import PoNetForTokenClassification

    cfg = EncoderConfig(vocab_size=30522, hidden_size=H, num_layers=LAYERS, num_heads=NH,
                        intermediate_size=I, max_position_embeddings=PN_L, pad_token_id=0,
                        add_pooler=False, ponet_local_window=PN_WINDOW, ponet_mixer_impl="fused")
    with torch.device(device):
        model = PoNetForTokenClassification(
            cfg, generator=torch.Generator(device=device).manual_seed(0))
    t0 = time.perf_counter()
    fused = root / "ponet_base"
    checkpoint_io.save_checkpoint(str(fused), checkpoint_io.params_from_state_dict(
        model.state_dict()), cfg)
    del model
    w8a8 = root / "ponet_base_w8a8"
    w8a8.mkdir()
    os.link(fused / checkpoint_io.PARAMS_FILE, w8a8 / checkpoint_io.PARAMS_FILE)
    (w8a8 / checkpoint_io.CONFIG_FILE).write_text(
        json.dumps(dataclasses.asdict(dataclasses.replace(cfg, quantize="w8a8"))))
    size = (fused / checkpoint_io.PARAMS_FILE).stat().st_size / 2**20
    print(f"PoNet-base checkpoint: {size:.0f} MiB written in {time.perf_counter() - t0:.1f} s")
    return {"float32": fused, "W8A8": w8a8}


def mug_path(ckpts: dict, data: Path, out: Path, device="cuda") -> dict:
    """MUG Track 1 through cli/run_mug.main from each checkpoint (about 2
    optimizer steps at batch 4 over 4096 tokens, then prediction), and
    Track 2 once from the float32 one. Checks kernel 9's launches (once a
    layer a predict batch; the W8A8 MLP block's too under W8A8) and finite
    metrics; then, on the trained model, times predict_boundaries (windows/s,
    peak memory) on the kernel path and both plain paths (the fused block's
    plain version, the XLA mixer) and holds the kernel path's argmax on the
    labelled EOS positions against the plain fused path (>= 0.99; against
    the XLA path printed, not gated: the two mixers differ on padded
    windows)."""
    import argparse
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import common, run_mug
    from spokennlp_tpu_torch.configs import WindowingConfig
    from spokennlp_tpu_torch.ops.cuda import ponet_block as pb
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.projects.mug import data as mug_data
    from spokennlp_tpu_torch.projects.mug.extractive_summarization import featurize_es_examples
    from spokennlp_tpu_torch.projects.mug.topic_segmentation import (
        IGNORE, predict_boundaries, predict_window_logits, stack_eos_windows, window_document_eos,
    )

    tokenize_fn, special = common.resolve_tokenizer(
        argparse.Namespace(model_name_or_path=None, vocab_file=None))
    wcfg = WindowingConfig(max_seq_length=PN_L, cls_token_id=special["cls"],
                           pad_token_id=special["pad"], bos_token_id=special["bos"])
    eos = special["sep"]
    raw = mug_data.read_jsonl(str(data / "dev.jsonl"))
    meetings = [mug_data.parse_topic_segmentation(m) for m in raw]
    windows = [w for i, m in enumerate(meetings) for w in window_document_eos(
        [tokenize_fn(s) for s in m["sentences"]], m["labels"], wcfg, eos, example_id=i)]
    batch = stack_eos_windows(windows)
    n = len(windows)
    share = float((batch["attention_mask"].sum(1) >= PN_LONG_TOKENS).mean())
    print(f"MUG eval: {len(meetings)} meetings, {n} windows of {PN_L} tokens, {share:.3f} of "
          f"them with >= {PN_LONG_TOKENS} real tokens")
    if n < PN_MIN_WINDOWS or share < 0.5:
        fail(f"the MUG eval corpus gives {n} windows, {share:.3f} of them long")
    live = batch["labels"] != IGNORE
    n_batches = math.ceil(n / PN_BATCH)
    wrappers = {"fused_ponet_mixer_block": pb.fused_ponet_mixer_block,
                "fused_mlp_block": fused_mlp_block}
    built = []  # the model each run_mug.main call builds (and trains in place)
    build_model = run_mug.build_model

    def capture(*args, **kw):
        built.append(build_model(*args, **kw))
        return built[-1]

    def drive(ckpt, track, out_dir):
        argv = ["--track", track, "--train_file", str(data / "train.jsonl"), "--eval_file",
                str(data / "dev.jsonl"), "--output_dir", str(out_dir), "--init_checkpoint",
                str(ckpt), "--max_seq_length", str(PN_L), "--per_device_train_batch_size",
                str(PN_BATCH), "--num_train_epochs", "1", "--device", device]
        reset_counts(wrappers)
        reset_peak()
        t0 = time.perf_counter()
        run_mug.build_model = capture
        try:
            res = run_mug.main(argv)
        finally:
            run_mug.build_model = build_model
        secs, peak = time.perf_counter() - t0, peak_gib()
        launches = read_counts(wrappers)
        values = [v for v in (res["metrics"] | {"train_loss": res["train_loss"][-1]}).values()
                  if isinstance(v, (int, float))]
        if not values or not np.isfinite(values).all():
            fail(f"run_mug {track} from {ckpt.name}: non-finite metrics {res['metrics']}")
        print(f"run_mug {track} from {ckpt.name}: {secs:.1f} s, peak {peak:.2f} GiB, train "
              f"loss {res['train_loss']}, launches {launches}, metrics {res['metrics']}")
        return res, launches, {"run_s": secs, "peak_gib": peak}, built.pop()

    result = {}
    for label, ckpt in ckpts.items():
        res, launches, row, model = drive(ckpt, "topic_segmentation", out / f"mug_{label}")
        w8a8 = label == "W8A8"
        expected = {"fused_ponet_mixer_block": LAYERS * n_batches,
                    "fused_mlp_block": LAYERS * n_batches if w8a8 else 0}
        if device == "cuda" and launches != expected:
            fail(f"run_mug {label}: launches {launches}, expected {expected} ({LAYERS} layers x "
                 f"{n_batches} predict batches)")
        row.update(launches=launches, windows=n, metrics=res["metrics"],
                   train_loss=res["train_loss"])
        layers = model.ponet.layers()
        paths = {"kernel": lambda: None,
                 "plain fused": lambda: [setattr(x, "mixer_block", pb.ponet_mixer_block_plain)
                                         for x in layers],
                 "xla": lambda: [setattr(x, "cfg", dataclasses.replace(
                     x.cfg, ponet_mixer_impl="xla")) for x in layers]}
        logits = {}
        for path, setup in paths.items():
            setup()
            reset_peak()
            t0 = time.perf_counter()
            predict_boundaries(model, meetings, tokenize_fn, wcfg, eos, batch_size=PN_BATCH)
            secs = time.perf_counter() - t0  # ends in a copy of the logits to the host
            row[path] = {"windows_per_s": n / secs, "peak_gib": peak_gib()}
            logits[path] = predict_window_logits(model, batch, PN_BATCH)[live]
            print(f"  predict_boundaries {label}, {path} path: {n} windows in {secs:.3f} s "
                  f"({n / secs:.2f} windows/s), peak {row[path]['peak_gib']:.2f} GiB")
        for other, gate in (("plain fused", True), ("xla", False)):
            agree = float((logits["kernel"].argmax(-1) == logits[other].argmax(-1)).mean())
            dmax = float(np.abs(logits["kernel"] - logits[other]).max())
            row[f"agreement vs {other}"] = agree
            print(f"  {label} kernel path vs {other} path on {int(live.sum())} labelled EOS "
                  f"positions: argmax {agree:.4f}, max |dlogit| {dmax:.4f}"
                  + ("" if gate else " (printed, not gated)"))
            if gate and agree < MIN_ARGMAX_AGREEMENT:
                fail(f"run_mug {label}: argmax agreement {agree:.4f} < {MIN_ARGMAX_AGREEMENT}")
        result[label] = row
        del model, layers, logits
        torch.cuda.empty_cache()

    _, es_windows = featurize_es_examples(raw, tokenize_fn, wcfg, eos)
    res, launches, row, model = drive(ckpts["float32"], "extractive_summarization", out / "mug_es")
    del model
    expected = LAYERS * math.ceil(len(es_windows) / PN_BATCH)
    if device == "cuda" and launches["fused_ponet_mixer_block"] != expected:
        fail(f"run_mug extractive_summarization: kernel 9 ran {launches} times, expected "
             f"{expected}")
    result["extractive_summarization"] = dict(row, launches=launches, windows=len(es_windows),
                                              metrics=res["metrics"])
    torch.cuda.empty_cache()
    return result


def serving_model(attention_impl: str, quantize: str, predictor: str = "lt"):
    """bench.py's make_model at full width (BERT-base, 512 positions, no
    pooler, softmax in the compute type, bf16 compute, float32 parameters),
    weights from seed 0 drawn on the card: every call gives the same
    weights. ``predictor``: the ts_score_predictor ("lt" or "cos")."""
    import torch

    from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

    enc = EncoderConfig(vocab_size=30522, hidden_size=H, num_layers=LAYERS, num_heads=NH,
                        intermediate_size=I, max_position_embeddings=L, add_pooler=False,
                        attention_impl=attention_impl, softmax_in_compute_dtype=True,
                        quantize=quantize)
    with torch.device("cuda"):
        model = TopicSegModel(enc, TopicSegConfig(ts_score_predictor=predictor),
                              dtype=torch.bfloat16,
                              generator=torch.Generator(device="cuda").manual_seed(0))
    return model.eval()


def serving_path(data_dir: str, out_dir: str) -> dict:
    """The repo's serving configuration through the engine call
    (run_topic_seg_inference), as scripts/bench_engine.py drives it, on the
    dense phase's corpus: W8A8 and unquantised, attention_impl auto at each of
    SERVE_BATCHES, the W8A8 einsum path and the bf16 pallas, flash and einsum
    paths. Checks each run's launches per batch and finite metrics; holds each
    kernel path's logits on the first 128 windows against the einsum path of
    its quantisation (argmax agreement >= MIN_ARGMAX_AGREEMENT); prints
    windows/s and peak memory, and the device busy share and top kernels of
    the auto and pallas engine calls. Then streams the corpus through the
    W8A8 model at the large batch (streaming_run) and runs the cos predictor
    (cos_runs)."""
    import torch

    from spokennlp_tpu_torch.cli import common, run_inference
    from spokennlp_tpu_torch.data.windowing_fast import window_documents_stacked
    from spokennlp_tpu_torch.eval.inference import predict_windows_scanned, run_topic_seg_inference
    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.blhd_attention import snld_self_attention
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack
    from spokennlp_tpu_torch.train.profiling import kernel_times

    args = run_inference.make_parser().parse_args(
        main_path_argv(data_dir, out_dir))
    tokenize_fn, special = common.resolve_tokenizer(args)
    _, _, wcfg, _ = common.build_configs(args, special)
    docs = common.load_docs(args, tokenize_fn)["test"]
    batch = window_documents_stacked(docs, wcfg)
    n = batch["input_ids"].shape[0]
    first = {k: v[:128] for k, v in batch.items()}
    live = first["sent_labels"] != -100
    wrappers = {"fused_encoder_stack": fused_encoder_stack,
                "fused_attention_block": fused_attention_block, "fused_mlp_block": fused_mlp_block,
                "w8a8_matmul_bf16in": im.w8a8_matmul_bf16in, "w8a8_matmul": im.w8a8_matmul,
                "snld_self_attention": snld_self_attention}
    small, large = SERVE_BATCHES
    blocks = {"fused_attention_block": LAYERS, "fused_mlp_block": LAYERS}
    # (quantize, attention_impl, batch, launches a batch)
    runs = [("w8a8", "auto", small, {"fused_encoder_stack": 1}),
            ("w8a8", "auto", large, blocks),
            ("w8a8", "einsum", small, {"w8a8_matmul_bf16in": 4 * LAYERS,
                                       "w8a8_matmul": 4 * LAYERS}),
            ("none", "auto", small, {"fused_encoder_stack": 1}),
            ("none", "auto", large, blocks),
            ("none", "pallas", small, {"snld_self_attention": LAYERS}),
            ("none", "flash", small, {"snld_self_attention": LAYERS}),
            ("none", "einsum", small, {})]
    res = {}
    for quantize, impl, bs, per_batch in runs:
        key = f"{quantize} {impl} batch {bs}"
        model = serving_model(impl, quantize)
        reset_counts(wrappers)
        reset_peak()
        t0 = time.perf_counter()
        out = run_topic_seg_inference(model, docs, wcfg, batch_size=bs, threshold=0.5)
        secs = time.perf_counter() - t0  # the engine call ends in a copy to the host
        launches = read_counts(wrappers)
        peak = peak_gib()
        n_batches = math.ceil(n / bs)
        expected = {k: per_batch.get(k, 0) * n_batches for k in wrappers}
        if launches != expected:
            fail(f"serving {key}: launches {launches}, expected {expected}")
        if not np.isfinite(list(out["metrics"].values())).all():
            fail(f"serving {key}: non-finite metrics {out['metrics']}")
        row = {"windows_per_s": n / secs, "engine_s": secs, "peak_gib": peak,
               "launches": {k: v for k, v in launches.items() if v}, "metrics": out["metrics"]}
        print(f"serving {key}: {n} windows in {n_batches} batches, {secs:.3f} s "
              f"({row['windows_per_s']:.1f} windows/s), peak {peak:.2f} GiB, launches "
              f"{row['launches']}")
        if impl in ("auto", "pallas"):
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                run_topic_seg_inference(model, docs, wcfg, batch_size=bs, threshold=0.5)
                traced_ms = (time.perf_counter() - t0) * 1e3
            k = kernel_times(prof)
            row["busy_share"] = k.pop("_busy_ms") / traced_ms
            total = sum(v["ms"] for v in k.values())
            top = sorted(k.items(), key=lambda kv: -kv[1]["ms"])[:6]
            row["top_kernels"] = {name: {"ms": v["ms"], "share": v["ms"] / total,
                                         "launches": v["launches"]} for name, v in top}
            print(f"  profiled engine call: busy share {row['busy_share']:.4f} of {traced_ms:.1f} "
                  f"ms; top kernels " + ", ".join(f"{name} {v['ms']:.1f} ms ({v['share']:.3f})"
                                                  for name, v in row["top_kernels"].items()))
        row["logits"] = predict_windows_scanned(model, first, bs, gather_sents=True)[live]
        if (quantize, impl, bs) == ("w8a8", "auto", large):
            row["streaming"] = streaming_run(model, docs, wcfg, out, bs)
        res[quantize, impl, bs] = row
        del model
        torch.cuda.empty_cache()

    agree = lambda a, b: float((a["logits"].argmax(-1) == b["logits"].argmax(-1)).mean())
    pairs = [(("w8a8", "auto", small), ("w8a8", "einsum", small), True),
             (("w8a8", "auto", large), ("w8a8", "einsum", small), True),
             (("none", "auto", small), ("none", "einsum", small), True),
             (("none", "auto", large), ("none", "einsum", small), True),
             (("none", "pallas", small), ("none", "einsum", small), True),
             (("none", "flash", small), ("none", "einsum", small), True),
             (("w8a8", "einsum", small), ("none", "einsum", small), False)]
    agreement = {}
    for a, b, gate in pairs:
        value = agree(res[a], res[b])
        name = f"{' '.join(map(str, a))} vs {' '.join(map(str, b))}"
        agreement[name] = value
        dmax = float(np.abs(res[a]["logits"] - res[b]["logits"]).max())
        print(f"serving agreement {name} on {int(live.sum())} labelled sentences of the first "
              f"{len(first['input_ids'])} windows: argmax {value:.4f}, max |dlogit| {dmax:.4f}"
              + ("" if gate else " (printed, not gated)"))
        if gate and value < MIN_ARGMAX_AGREEMENT:
            fail(f"serving agreement {name}: {value:.4f} < {MIN_ARGMAX_AGREEMENT}")
    for row in res.values():
        row.pop("logits")
    return {"runs": {" ".join(map(str, k)): v for k, v in res.items()}, "agreement": agreement,
            "cos": cos_runs(docs, wcfg, small)}


def streaming_run(model, docs, wcfg, batch_out: dict, bs: int, chunk_batches: int = 2) -> dict:
    """eval/streaming.py's engine over the corpus on ``model`` at batch
    ``bs``: its per-document scores must equal ``batch_out``'s (the batch
    engine's call at the same batch) bit for bit, and the dense kernels run
    once a layer a batch, the tail chunk padded to whole batches. Prints its
    windows/s, timing split, peak memory and launches."""
    from spokennlp_tpu_torch.eval.streaming import stream_topic_seg_inference
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block

    wrappers = {"fused_attention_block": fused_attention_block, "fused_mlp_block": fused_mlp_block}
    reset_counts(wrappers)
    reset_peak()
    t0 = time.perf_counter()
    out = stream_topic_seg_inference(model, docs, wcfg, batch_size=bs,
                                     chunk_batches=chunk_batches, threshold=0.5)
    secs = time.perf_counter() - t0
    launches = read_counts(wrappers)
    peak = peak_gib()
    timing = out["timing"]
    n_batches = chunk_batches * math.ceil(timing["windows"] / (bs * chunk_batches))
    if launches != {k: LAYERS * n_batches for k in wrappers}:
        fail(f"streaming: launches {launches}, expected {LAYERS} x {n_batches} batches each")
    same = len(out["per_doc"]) == len(batch_out["per_doc"]) and all(
        np.array_equal(a["labels"], b["labels"]) and np.array_equal(a["scores"], b["scores"])
        for a, b in zip(out["per_doc"], batch_out["per_doc"]))
    if not same:
        fail("streaming: per-document scores differ from the batch engine's at the same batch")
    if out["metrics"] != batch_out["metrics"]:
        fail(f"streaming: metrics {out['metrics']} differ from the batch engine's")
    parts = sum(timing[k] for k in ("featurize", "dispatch", "fetch", "aggregate", "metrics"))
    row = {"windows_per_s": timing["windows"] / secs, "seconds": secs, "timing": timing,
           "timing_parts_share": parts / timing["total"], "peak_gib": peak, "launches": launches}
    print(f"streaming W8A8 batch {bs}, {chunk_batches} batches a chunk: {timing['windows']} "
          f"windows in {secs:.3f} s ({row['windows_per_s']:.1f} windows/s), peak {peak:.2f} "
          f"GiB, launches {launches}; per-document scores equal the batch engine's bit for bit; "
          f"timing {timing} (parts {row['timing_parts_share']:.4f} of the total)")
    return row


def cos_runs(docs, wcfg, bs: int) -> dict:
    """The cos predictor (sigmoid of adjacent sentences' cosine) on the W8A8
    serving model at batch ``bs`` (kernel 3, once a batch) and on the W8A8
    einsum path: the > 0.5 decisions must agree on MIN_ARGMAX_AGREEMENT of
    the labelled slots; prints the largest |difference|, each run's
    windows/s, peak memory and launches."""
    import torch

    from spokennlp_tpu_torch.eval.inference import run_topic_seg_inference
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    wrappers = {"fused_encoder_stack": fused_encoder_stack}
    rows, scores = {}, {}
    for impl in ("auto", "einsum"):
        model = serving_model(impl, "w8a8", predictor="cos")
        reset_counts(wrappers)
        reset_peak()
        t0 = time.perf_counter()
        out = run_topic_seg_inference(model, docs, wcfg, batch_size=bs, threshold=0.5,
                                      ts_score_predictor="cos")
        secs = time.perf_counter() - t0
        launches = read_counts(wrappers)
        n, peak = out["num_windows"], peak_gib()
        want = math.ceil(n / bs) if impl == "auto" else 0
        if launches["fused_encoder_stack"] != want:
            fail(f"cos {impl}: launches {launches}, expected fused_encoder_stack {want}")
        scores[impl] = np.concatenate([d["scores"] for d in out["per_doc"]])
        if scores[impl].ndim != 1 or not np.isfinite(scores[impl]).all():
            fail(f"cos {impl}: scores must be finite and one a labelled sentence")
        rows[impl] = {"windows_per_s": n / secs, "seconds": secs, "peak_gib": peak,
                      "launches": launches, "metrics": out["metrics"]}
        print(f"cos W8A8 {impl} batch {bs}: {n} windows in {secs:.3f} s "
              f"({n / secs:.1f} windows/s), peak {peak:.2f} GiB, launches {launches}")
        del model
        torch.cuda.empty_cache()
    a, b = scores["auto"], scores["einsum"]
    agreement = float(((a > 0.5) == (b > 0.5)).mean())
    dmax = float(np.abs(a - b).max())
    print(f"cos kernel 3 vs einsum on {len(a)} labelled sentences: > 0.5 decisions agree on "
          f"{agreement:.4f}, max |d sigmoid-cos| {dmax:.3e}")
    if agreement < MIN_ARGMAX_AGREEMENT:
        fail(f"cos: decisions agree on {agreement:.4f} < {MIN_ARGMAX_AGREEMENT}")
    return {"runs": rows, "agreement": agreement, "max_abs_diff": dmax}


def packed_path(data_dir: str, out_dir: str) -> dict:
    """eval/packed_inference.py on the W8A8 serving model over a corpus of
    short documents (at least half the packed rows must hold two windows or
    more): at the small serving batch (kernel 3 on the packed segment ids)
    and the large one (kernels 1 + 2), each against the unpacked engine at
    the same batch (argmax agreement >= MIN_ARGMAX_AGREEMENT on the labelled
    sentences); and kernel 3 on the first packed batch against its chain of
    kernels 1 + 2 (bit for bit) and its plain loop (STACK_TOL). Prints rows
    against windows, windows/s, peak memory and launches."""
    import torch

    from spokennlp_tpu_torch.cli import common, run_inference
    from spokennlp_tpu_torch.data.windowing import stack_windows, window_document
    from spokennlp_tpu_torch.eval.inference import predict_windows_scanned
    from spokennlp_tpu_torch.eval.packed_inference import build_packed_batch, predict_windows_packed
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    args = run_inference.make_parser().parse_args(main_path_argv(data_dir, out_dir))
    tokenize_fn, special = common.resolve_tokenizer(args)
    _, _, wcfg, _ = common.build_configs(args, special)
    docs = common.load_docs(args, tokenize_fn)["test"]
    windows = [w for i, d in enumerate(docs)
               for w in window_document(d["sent_token_ids"], d["labels"], wcfg, i)]
    batch = stack_windows(windows)
    packed, plan = build_packed_batch(windows, L)
    per_row = np.array([len(p.window_indices) for p in plan])
    share = float((per_row >= 2).mean())
    print(f"packed: {len(windows)} windows in {len(plan)} rows of {L} tokens, {per_row.mean():.2f} "
          f"windows a row (at most {per_row.max()}), {share:.3f} of the rows hold two or more")
    if share < 0.5:
        fail(f"packed: only {share:.3f} of the rows hold two windows or more")
    model = serving_model("auto", "w8a8")
    wrappers = {"fused_encoder_stack": fused_encoder_stack,
                "fused_attention_block": fused_attention_block, "fused_mlp_block": fused_mlp_block}
    live = batch["sent_labels"] != -100
    res = {"windows": len(windows), "rows": len(plan), "windows_per_row": float(per_row.mean()),
           "rows_with_two_or_more": share}
    small, large = SERVE_BATCHES
    for bs, per_batch in ((small, {"fused_encoder_stack": 1}),
                          (large, {"fused_attention_block": LAYERS, "fused_mlp_block": LAYERS})):
        reset_counts(wrappers)
        reset_peak()
        t0 = time.perf_counter()
        logits = predict_windows_packed(model, windows, L, batch_size=bs)
        secs = time.perf_counter() - t0  # ends in a copy to the host
        launches = read_counts(wrappers)
        peak = peak_gib()
        n_batches = math.ceil(len(plan) / bs)
        expected = {k: per_batch.get(k, 0) * n_batches for k in wrappers}
        if launches != expected:
            fail(f"packed batch {bs}: launches {launches}, expected {expected}")
        got = np.take_along_axis(logits, batch["sent_positions"][:, :, None], axis=1)[live]
        want = predict_windows_scanned(model, batch, bs, gather_sents=True)[live]
        agreement = float((got.argmax(-1) == want.argmax(-1)).mean())
        dmax = float(np.abs(got - want).max())
        res[f"batch {bs}"] = {"windows_per_s": len(windows) / secs, "seconds": secs,
                              "peak_gib": peak, "agreement": agreement, "max_dlogit": dmax,
                              "launches": {k: v for k, v in launches.items() if v}}
        print(f"packed W8A8 batch {bs}: {len(plan)} rows for {len(windows)} windows in "
              f"{secs:.3f} s ({len(windows) / secs:.1f} windows/s), peak {peak:.2f} GiB, "
              f"launches {res[f'batch {bs}']['launches']}; against the unpacked engine on "
              f"{int(live.sum())} labelled sentences: argmax {agreement:.4f}, max |dlogit| "
              f"{dmax:.4f}")
        if agreement < MIN_ARGMAX_AGREEMENT:
            fail(f"packed batch {bs}: argmax agreement {agreement:.4f} < {MIN_ARGMAX_AGREEMENT}")
    res["kernel_check"] = packed_kernel_check(model, packed, small)
    del model
    torch.cuda.empty_cache()
    return res


def packed_kernel_check(model, packed: dict, rows: int) -> dict:
    """Kernel 3 on the first ``rows`` packed rows of ``packed``
    (build_packed_batch's arrays: several windows a row, positions restarting
    at each) with the W8A8 model's weights, against its chain of kernels 1 + 2
    (bit for bit) and the plain loop of layers (STACK_TOL), on the rows'
    real tokens."""
    import torch

    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack, stack_plain

    t = {k: torch.from_numpy(v[:rows]).cuda() for k, v in packed.items()}
    cfg, seg = model.enc_cfg, t["pack_segment_ids"]
    valid = seg > 0
    kw = dict(sm_scale=cfg.head_dim**-0.5, quantized=True, activation=cfg.hidden_act,
              eps=cfg.layer_norm_eps)
    with torch.inference_mode():
        ids = t["input_ids"]
        hidden = model.encoder.embeddings(ids, torch.zeros_like(ids), t["position_ids"])
        p = [torch.stack(ps) for ps in zip(*(l.stack_params() for l in model.encoder.layers()))]
        got = fused_encoder_stack(hidden, seg, *p, **kw)
        h = hidden
        for l in range(cfg.num_layers):
            h = fused_attention_block(h, seg, *(x[l] for x in p[:4]), sm_scale=kw["sm_scale"],
                                      ln_scale=p[4][l], ln_bias=p[5][l], eps=kw["eps"],
                                      quantized=True)
            h = fused_mlp_block(h.reshape(-1, cfg.hidden_size), *(x[l] for x in p[6:]),
                                activation=kw["activation"], eps=kw["eps"],
                                quantized=True).reshape(hidden.shape)
        want = stack_plain(hidden, seg, *p, **kw)
        torch.cuda.synchronize()
    if not torch.equal(got[valid], h[valid]):
        fail("packed rows: kernel 3 differs from its chain of kernels 1 + 2")
    e = (got[valid].float() - want[valid].float()).abs().max().item()
    rel, limit = e / want[valid].float().abs().max().item(), STACK_TOL["W8A8", "bfloat16"]
    per_row = seg.amax(1).float().mean().item()
    print(f"packed rows ({rows}, {per_row:.2f} windows a row on average): kernel 3 equals its "
          f"chain of kernels 1 + 2 bit for bit; against the plain loop max |err| {e:.3e}, / max "
          f"|ref| {rel:.3e} (limit {limit})")
    if rel > limit:
        fail(f"packed rows: kernel 3 against the plain loop {rel:.3e} > {limit}")
    return {"max_abs_err": e, "rel_err": rel}


def checkpoint_path(data_dir: str, root: Path) -> dict:
    """The W8A8 serving model exported as a native checkpoint
    (models/checkpoint_io.py), as an HF directory (models/hf_export.py, the
    exporter of run_finetune --save_hf_format) and as that directory with
    model.safetensors written here (cli/hf_checkpoint.write_safetensors) in
    place of pytorch_model.bin, each read back through run_inference
    --model_name_or_path at the small serving batch: its per-document scores
    must equal, bit for bit, those of the model in memory under the
    configuration the directory carries (native: the W8A8 serving one; HF:
    the same weights unquantised with a float32 softmax, what an HF config
    can say); kernel 3 runs once a batch. Prints each run's seconds,
    windows/s, peak memory and launches."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import common, hf_checkpoint, run_inference
    from spokennlp_tpu_torch.eval.inference import run_topic_seg_inference
    from spokennlp_tpu_torch.models import checkpoint_io, hf_export
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    small = SERVE_BATCHES[0]
    argv = main_path_argv(data_dir, str(root / "out"))
    args = run_inference.make_parser().parse_args(argv)
    tokenize_fn, special = common.resolve_tokenizer(args)
    _, task_cfg, wcfg, _ = common.build_configs(args, special)
    docs = common.load_docs(args, tokenize_fn)["test"]
    model = serving_model("auto", "w8a8")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    params = checkpoint_io.params_from_state_dict(state)
    t0 = time.perf_counter()
    dirs = {"native": root / "native", "hf": root / "hf", "hf safetensors": root / "hf_st"}
    checkpoint_io.save_checkpoint(str(dirs["native"]), params, model.enc_cfg)
    hf_export.save_hf_checkpoint(str(dirs["hf"]), params, model.enc_cfg)
    dirs["hf safetensors"].mkdir()
    (dirs["hf safetensors"] / "config.json").write_text((dirs["hf"] / "config.json").read_text())
    hf_checkpoint.write_safetensors(
        str(dirs["hf safetensors"] / "model.safetensors"),
        torch.load(dirs["hf"] / "pytorch_model.bin", weights_only=True), {"format": "pt"})
    print(f"checkpoints: native, HF and safetensors written in {time.perf_counter() - t0:.1f} s")
    hf_cfg = dataclasses.replace(model.enc_cfg, quantize="none", softmax_in_compute_dtype=False)
    with torch.device(next(model.parameters()).device):
        hf_model = TopicSegModel(hf_cfg, task_cfg, dtype=torch.bfloat16)
    hf_model.load_state_dict(state, strict=True)
    want = {"native": run_topic_seg_inference(model, docs, wcfg, batch_size=small, threshold=0.5),
            "hf": run_topic_seg_inference(hf_model.eval(), docs, wcfg, batch_size=small,
                                          threshold=0.5)}
    del model, hf_model
    torch.cuda.empty_cache()
    wrappers = {"fused_encoder_stack": fused_encoder_stack}
    res = {}
    for name, path in dirs.items():
        reset_counts(wrappers)
        reset_peak()
        t0 = time.perf_counter()
        out = run_inference.main(argv + ["--model_name_or_path", str(path), "--output_dir",
                                          str(root / f"out_{name.replace(' ', '_')}")])
        secs = time.perf_counter() - t0
        launches, peak = read_counts(wrappers), peak_gib()
        n_batches = math.ceil(out["num_windows"] / small)
        if launches["fused_encoder_stack"] != n_batches:
            fail(f"checkpoint {name}: launches {launches}, expected kernel 3 {n_batches} times")
        ref = want["native" if name == "native" else "hf"]
        same = len(out["per_doc"]) == len(ref["per_doc"]) and all(
            np.array_equal(a["scores"], b["scores"]) for a, b in zip(out["per_doc"],
                                                                    ref["per_doc"]))
        if not same:
            fail(f"checkpoint {name}: run_inference's scores differ from the model in memory")
        res[name] = {"seconds": secs, "predict_time_s": out["predict_time_s"],
                     "windows_per_s": out["num_windows"] / out["predict_time_s"],
                     "peak_gib": peak, "launches": launches}
        print(f"checkpoint {name}: run_inference --model_name_or_path {path.name} in {secs:.1f} s "
              f"(engine {out['predict_time_s']:.3f} s, {res[name]['windows_per_s']:.1f} "
              f"windows/s), peak {peak:.2f} GiB, launches {launches}; per-document scores equal "
              f"the model in memory bit for bit")
    return res


def train_path(argv, n_layers, batch_size, device="cuda", kernels=None, accum=1,
               fwd_factor=1) -> dict:
    """Run the fine-tuning CLI; check launches (on the card), losses and the
    checkpoint. ``kernels``: {name: wrapper} that must run once per layer,
    view and micro-step (the dense training kernels by default), the
    forwards (``*_fwd``) ``fwd_factor`` times (2 under
    --gradient_checkpointing: the backward recomputes each layer)."""
    import torch

    from spokennlp_tpu_torch.cli import run_finetune
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    wrappers = kernels or {n: getattr(tb, n) for n in ("attention_train_fwd",
                                                       "attention_train_bwd", "mlp_train_fwd",
                                                       "mlp_train_bwd")}
    on_card = device == "cuda"
    reset_counts(wrappers)
    reset_peak()
    results = run_finetune.main(argv)
    launches = read_counts(wrappers)
    peak = peak_gib()
    out_dir = Path(argv[argv.index("--output_dir") + 1])
    events = [json.loads(l) for l in (out_dir / "metrics.jsonl").read_text().splitlines()]
    train = [e for e in events if e["event"] == "train"]
    steps = len(train)
    if steps < 2 or steps * accum != results["train_steps"]:
        fail(f"{steps} train events for {results['train_steps']} micro-steps of {accum}")
    views = 2  # anchor and DA
    for name, n in launches.items():
        factor = fwd_factor if name.endswith("_fwd") else 1
        if on_card and n != n_layers * views * steps * accum * factor:
            fail(f"{name} ran {n} times, expected {n_layers} layers x {views} views x "
                 f"{steps} steps x {accum} micro-steps x {factor}")
    keys = ("loss", "ts_loss", "cl_loss", "da_ts_loss", "tssp_loss", "grad_norm")
    for e in train:
        if not all(k in e and math.isfinite(e[k]) for k in keys):
            fail(f"step {e['step']}: missing or non-finite loss in {e}")
    # the checkpoint of the last eval reloads and equals the final model
    final = torch.load(out_dir / "final_model" / "model.pt", map_location="cpu",
                       weights_only=True)
    index = json.loads((out_dir / "checkpoints" / "checkpoints.json").read_text())
    latest = max(index, key=lambda e: e["step"])
    ckpt = torch.load(out_dir / "checkpoints" / latest["file"], map_location="cpu",
                      weights_only=True)
    if ckpt["model"].keys() != final.keys() or not all(
            torch.equal(ckpt["model"][k], final[k]) for k in final):
        fail("the last checkpoint differs from final_model")
    steady = (train[-1]["time"] - train[0]["time"]) / (steps - 1)
    row = {"launches": launches, "steps": steps, "steps_per_s": 1.0 / steady,
           "windows_per_s": batch_size * accum / steady, "peak_gib": peak,
           "losses": {k: train[-1][k] for k in keys}}
    print(f"training main path: {steps} optimizer steps of {accum} x {batch_size} windows "
          f"(x2 views), "
          f"steady {row['steps_per_s']:.3f} steps/s = {row['windows_per_s']:.2f} windows/s "
          f"trained; peak {peak:.2f} GiB; last step {row['losses']}; launches {launches}; "
          f"checkpoint step {latest['step']} reloaded, equal to final_model")
    return row


def flash_train_path(train_data: str, out_dir: Path, auto: dict, device="cuda") -> dict:
    """Two optimizer steps of the dense training main path with
    --attention_impl flash and --save_hf_format: the training kernels must
    run as many times a step as on ``auto``'s run (train_path's row), and
    final_model_hf must load back (cli/common.py maybe_load_pretrained) to
    final_model's parameters bit for bit."""
    import torch

    from spokennlp_tpu_torch.cli import common
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    argv = train_argv(train_data, str(out_dir)) + ["--attention_impl", "flash",
                                                   "--save_hf_format"]
    argv[argv.index("--num_train_epochs") + 1] = repr(epochs_for_steps(argv, 2))
    row = train_path(argv, LAYERS, B, device=device)
    per_step = lambda r: {k: v / r["steps"] for k, v in r["launches"].items()}
    if per_step(row) != per_step(auto):
        fail(f"flash training: launches a step {per_step(row)}, auto's {per_step(auto)}")
    final = torch.load(out_dir / "final_model" / "model.pt", map_location="cpu", weights_only=True)
    ns = argparse.Namespace(model_name_or_path=str(out_dir / "final_model_hf"))
    cfg, tree = common.maybe_load_pretrained(ns, EncoderConfig())
    loaded = jax_params_to_state_dict(tree)
    if set(loaded) != set(final) or not all(torch.equal(loaded[k], final[k]) for k in final):
        fail("flash training: final_model_hf does not load back to final_model's parameters")
    print(f"flash training: {row['steps']} steps, launches a step {per_step(row)} (auto's "
          f"{per_step(auto)}); final_model_hf loads back to final_model bit for bit")
    return {k: row[k] for k in ("launches", "steps", "steps_per_s", "windows_per_s", "peak_gib")}


def fused_vs_einsum_grads(argv, batch_size, device="cuda") -> dict:
    """One composite step's loss and gradients on the training kernels and on
    the einsum path, same weights, same batch, dropout 0."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import common, run_finetune
    from spokennlp_tpu_torch.cli.run_inference import build_model
    from spokennlp_tpu_torch.data.featurization import batches_from_docs
    from spokennlp_tpu_torch.models.topic_seg import compute_topic_seg_loss
    from spokennlp_tpu_torch.train.train_step import CSSL_KEYS, batch_to_device

    args = run_finetune.make_parser().parse_args(argv)
    tokenize_fn, special = common.resolve_tokenizer(args)
    enc_cfg, task_cfg, wcfg, _ = common.build_configs(args, special)
    enc_cfg = dataclasses.replace(enc_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    task_cfg = dataclasses.replace(task_cfg, classifier_dropout=0.0)
    docs = common.load_docs(args, tokenize_fn)["train"]
    np_batch = next(batches_from_docs(docs, wcfg, task_cfg, batch_size,
                                      np.random.default_rng(0)))
    batch = batch_to_device(np_batch, torch.device(device))
    cssl = {v: batch[k] for k, v in CSSL_KEYS.items()} if "cssl_anchor_indices" in batch else None
    res = {}
    for impl in ("train_fused", "einsum"):
        model = build_model(args, dataclasses.replace(enc_cfg, attention_impl=impl), task_cfg)
        model.train()
        views = [model(batch["input_ids"][:, v], attention_mask=batch["attention_mask"][:, v],
                       token_type_ids=batch["token_type_ids"][:, v],
                       sent_positions=batch["sent_positions"][:, v]) for v in (0, 1)]
        loss, _ = compute_topic_seg_loss(task_cfg, views[0], views[1], batch, cssl)
        names = [n for n, _ in model.named_parameters() if n.startswith("encoder.layer_")
                 and n.endswith("kernel")]
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        res[impl] = (loss.item(), dict(zip(names, grads)))
        del model, views, loss
        if device == "cuda":
            torch.cuda.empty_cache()
    (lf, gf), (le, ge) = res["train_fused"], res["einsum"]
    rel = abs(lf - le) / abs(le)
    # a matrix that does not reach the loss (the last layer's global
    # projections: no loss term reads the CLS row) has a zero gradient on both
    # paths, which agree
    zero = [n for n in gf if not gf[n].any() and not ge[n].any()]
    cos = {n: 1.0 if n in zero else torch.nn.functional.cosine_similarity(
        gf[n].flatten().float(), ge[n].flatten().float(), dim=0).item() for n in gf}
    worst = min(cos, key=cos.get)
    print(f"fused vs einsum training, one batch of {batch_size} at dropout 0: loss {lf:.6f} vs "
          f"{le:.6f} (rel {rel:.2e}); lowest gradient cosine {cos[worst]:.5f} ({worst}) over "
          f"{len(cos)} weight matrices; zero on both paths: {zero}")
    if not rel <= LOSS_RTOL:
        fail(f"fused loss {lf} vs einsum {le}: rel {rel:.3e} > {LOSS_RTOL}")
    if cos[worst] < MIN_GRAD_COSINE:
        fail(f"gradient cosine {cos[worst]:.5f} of {worst} < {MIN_GRAD_COSINE}")
    return {"loss_rel": rel, "min_cos": cos[worst]}


# ------------------------------------------------------ training at scale
# Phases 22-26: gradient checkpointing (--gradient_checkpointing) on the
# dense step in bf16 and float32 and on the float32 Longformer recipe,
# MLM+NSP pretraining (run_pretrain_mlm, rows 10 and 11), feature extraction
# (run_extract_features, kernels 1 and 2) and one fine-tuning run in a
# process group of world size 1 over NCCL.

PRETRAIN_DOCS = 12  # 3-5 sentence pairs a meeting: about 5 batches of 8 in one epoch
EXTRACT_EXAMPLES = 64  # 8 batches of 8 at run_extract_features' defaults


def step_gradients(model, batch: dict, task_cfg, seed: int, device) -> dict:
    """{"loss", and each parameter's name: its gradient} of one composite
    step on ``model`` in training mode, its dropout drawn as the train step
    draws it at micro-step 0 (train_step.step_generator)."""
    import torch

    from spokennlp_tpu_torch.models.topic_seg import compute_topic_seg_loss
    from spokennlp_tpu_torch.train.train_step import CSSL_KEYS, step_generator

    model.train()
    gen = step_generator(device, seed, 0)
    views = [model(batch["input_ids"][:, v], attention_mask=batch["attention_mask"][:, v],
                   token_type_ids=batch["token_type_ids"][:, v],
                   sent_positions=batch["sent_positions"][:, v], generator=gen) for v in (0, 1)]
    cssl = {v: batch[k] for k, v in CSSL_KEYS.items()} if "cssl_anchor_indices" in batch else None
    loss, _ = compute_topic_seg_loss(task_cfg, views[0], views[1], batch, cssl)
    named = [(n, p) for n, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {"loss": loss.detach(),
            **{n: g.detach() for (n, _), g in zip(named, grads) if g is not None}}


def differing(a: dict, b: dict) -> list:
    """Names of the entries of ``a`` that ``b`` lacks or differs in by a bit."""
    import torch

    return [n for n in a if n not in b or not torch.equal(a[n], b[n])]


def same_step_bits(label: str, plain: dict, again: dict, other: dict) -> dict:
    """The plain step run twice (``plain``, ``again``) repeats itself bit for
    bit in every entry, the loss and every gradient (the embedding tables'
    backward sums in an order the data fixes: models/encoder.py
    ``table_grad``), and ``other`` equals it bit for bit; fails otherwise."""
    moved, bad = differing(plain, again), differing(plain, other)
    print(f"{label}: the plain step repeats itself bit for bit in all {len(plain)} entries (the "
          f"loss and the gradients): {not moved}; equal to it bit for bit: {not bad}")
    if moved:
        fail(f"{label}: the plain step does not repeat itself: {moved[:6]} moved from run to run "
             f"({len(moved)} in all)")
    if bad:
        fail(f"{label}: {bad[:6]} differ from the plain step's ({len(bad)} in all)")
    return {"equal_bits": len(plain), "entries": len(plain)}


def step_inputs(argv, batch_size, device):
    """(args, enc_cfg, task_cfg, the first training batch on ``device``) of
    run_finetune's ``argv``."""
    import torch

    from spokennlp_tpu_torch.cli import common, run_finetune
    from spokennlp_tpu_torch.data.featurization import batches_from_docs
    from spokennlp_tpu_torch.train.train_step import batch_to_device

    args = run_finetune.make_parser().parse_args(argv)
    tokenize_fn, special = common.resolve_tokenizer(args)
    enc_cfg, task_cfg, wcfg, _ = common.build_configs(args, special)
    docs = common.load_docs(args, tokenize_fn)["train"]
    batch = batch_to_device(next(batches_from_docs(docs, wcfg, task_cfg, batch_size,
                                                   np.random.default_rng(0))),
                            torch.device(device))
    return args, enc_cfg, task_cfg, batch


def remat_grads(argv, batch_size, device="cuda") -> dict:
    """One composite step's loss and gradients at the recipe's dropout (0.1)
    with and without --gradient_checkpointing, the same weights, batch and
    generator: bit for bit (same_step_bits; the plain step runs twice)."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli.run_inference import build_model

    args, enc_cfg, task_cfg, batch = step_inputs(argv, batch_size, device)
    runs = {}
    for name, remat in (("plain", False), ("plain again", False), ("checkpointed", True)):
        model = build_model(args, dataclasses.replace(enc_cfg, remat=remat), task_cfg)
        runs[name] = step_gradients(model, batch, task_cfg, args.seed, torch.device(device))
        del model
    return same_step_bits(
        f"checkpointed step, {args.attention_type} {args.dtype} at batch {batch_size}",
        runs["plain"], runs["plain again"], runs["checkpointed"])


def remat_phase(train_data: str, root: Path, bf16_plain: dict, device="cuda") -> dict:
    """Phase 22: the dense training main path with --gradient_checkpointing at
    batch 32 in bf16 (against the main path's run, ``bf16_plain``) and in
    float32 (both runs here, 2 steps each): launches (the forwards twice),
    windows trained/s and peak memory with and without, and the gradients
    bit for bit (remat_grads)."""
    out = {}
    argv = train_argv(train_data, str(root / "remat_bf16")) + ["--gradient_checkpointing"]
    row = train_path(argv, LAYERS, B, device=device, fwd_factor=2)
    out["bfloat16"] = {"plain": {k: bf16_plain[k] for k in ("windows_per_s", "peak_gib")},
                       "checkpointed": {k: row[k] for k in ("windows_per_s", "peak_gib",
                                                            "launches")},
                       "grads": remat_grads(train_argv(train_data, str(root / "rg_bf16")), B,
                                            device)}
    f32 = cli_default_dtype(train_argv(train_data, str(root / "plain_f32")))
    f32[f32.index("--num_train_epochs") + 1] = repr(epochs_for_steps(f32, 2))
    plain = train_path(f32, LAYERS, B, device=device)
    remat = train_path([a.replace("plain_f32", "remat_f32") for a in f32]
                       + ["--gradient_checkpointing"], LAYERS, B, device=device, fwd_factor=2)
    out["float32"] = {"plain": {k: plain[k] for k in ("windows_per_s", "peak_gib")},
                      "checkpointed": {k: remat[k] for k in ("windows_per_s", "peak_gib",
                                                             "launches")},
                      "grads": remat_grads(cli_default_dtype(
                          train_argv(train_data, str(root / "rg_f32"))), B, device)}
    for dtype, r in out.items():
        print(f"gradient checkpointing, dense BERT-base {dtype} at batch {B}: "
              f"{r['checkpointed']['windows_per_s']:.2f} windows trained/s and "
              f"{r['checkpointed']['peak_gib']:.2f} GiB peak, without "
              f"{r['plain']['windows_per_s']:.2f} and {r['plain']['peak_gib']:.2f}")
    return out


def lf_remat_phase(lf_data: str, root: Path, plain: dict, device="cuda") -> dict:
    """Phase 23: the float32 Longformer recipe with --gradient_checkpointing
    for LF_STEPS optimizer steps (the sliding training kernels, forwards
    twice) against the recipe's float32 run without it (``plain``), and the
    gradients of one micro-batch bit for bit."""
    argv = lambda out, epochs: cli_default_dtype(longformer_train_argv(lf_data, str(root / out),
                                                                       epochs))
    epochs = epochs_for_steps(argv("lf_remat", 1.0), LF_STEPS)
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    row = train_path(argv("lf_remat", epochs) + ["--gradient_checkpointing"], LAYERS, LF_TRAIN_B,
                     accum=LF_ACCUM, fwd_factor=2, device=device,
                     kernels={"sliding_train_fwd": ts.sliding_train_fwd,
                              "sliding_train_bwd": ts.sliding_train_bwd,
                              "mlp_train_fwd": tb.mlp_train_fwd,
                              "mlp_train_bwd": tb.mlp_train_bwd})
    grads = remat_grads(argv("lf_remat_grads", epochs), LF_TRAIN_B, device)
    print(f"gradient checkpointing, Longformer-base float32 recipe: {row['windows_per_s']:.3f} "
          f"windows trained/s and {row['peak_gib']:.2f} GiB peak, without "
          f"{plain['windows_per_s']:.3f} and {plain['peak_gib']:.2f}")
    return {"plain": {k: plain[k] for k in ("windows_per_s", "peak_gib")},
            "checkpointed": {k: row[k] for k in ("windows_per_s", "peak_gib", "launches")},
            "grads": grads}


def write_meetings(path: Path, n_docs: int, seed: int = 6) -> str:
    """A meetings JSONL ({"sentences": [{"text"}]}) of ``n_docs`` meetings of
    4-6 sentences of 10-40 words."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(3000)]
    with open(path, "w") as f:
        for _ in range(n_docs):
            f.write(json.dumps({"sentences": [
                {"text": " ".join(rng.choice(words, size=rng.integers(10, 40)))}
                for _ in range(rng.integers(4, 7))]}) + "\n")
    return str(path)


def pretrain_path(root: Path, device="cuda", extra=()) -> dict:
    """Phase 24: run_pretrain_mlm at its defaults (BERT-base, 128 tokens,
    batch 8, float32) for PRETRAIN_STEPS steps on a synthetic meetings corpus:
    rows 10 and 11 once a layer a step, finite losses, sequences/s; then one
    batch's loss and gradients on the training kernels against the einsum
    path at dropout 0 (loss within LOSS_RTOL, every layer's weight-matrix
    gradient cosine >= MIN_GRAD_COSINE)."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import run_pretrain_mlm
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.objectives import mlm
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.train.train_step import batch_to_device

    corpus = write_meetings(root / "meetings.jsonl", PRETRAIN_DOCS)
    argv = ["--train_file", corpus, "--output_dir", str(root / "pretrain_out"),
            "--device", device, "--num_train_epochs", "1", *extra]
    wrappers = {n: getattr(tb, n) for n in ("attention_train_fwd", "attention_train_bwd",
                                            "mlp_train_fwd", "mlp_train_bwd")}
    args = run_pretrain_mlm.make_parser().parse_args(argv)
    layers = args.num_hidden_layers
    reset_counts(wrappers)
    reset_peak()
    res = run_pretrain_mlm.main(argv)
    launches = read_counts(wrappers)
    peak = peak_gib()
    steps = res["steps"]
    if steps < 3:
        fail(f"pretraining took {steps} steps, expected 3 or more")
    if device == "cuda" and any(n != layers * steps for n in launches.values()):
        fail(f"pretraining launches {launches}, expected {layers} layers x {steps} steps each")
    if not all(math.isfinite(res["final"][k]) for k in ("loss", "mlm_loss", "nsp_loss",
                                                        "grad_norm")):
        fail(f"pretraining: non-finite metrics {res['final']}")

    from spokennlp_tpu_torch.cli import common

    tokenize_fn, special = common.resolve_tokenizer(args)
    docs = run_pretrain_mlm.load_documents(corpus, tokenize_fn)
    dcfg = mlm.PretrainDataConfig(cls_token_id=special["cls"], sep_token_id=special["sep"],
                                  pad_token_id=special["pad"], mask_token_id=special["mask"])
    full = mlm.build_pretraining_batch(docs, dcfg, np.random.default_rng(0), args.max_seq_length,
                                       args.max_predictions_per_seq, args.masked_lm_prob,
                                       special["vocab_size"])
    batch = batch_to_device({k: v[:args.per_device_train_batch_size] for k, v in full.items()},
                            torch.device(device))
    enc = EncoderConfig(vocab_size=special["vocab_size"], hidden_size=args.hidden_size,
                        num_layers=layers, num_heads=args.num_attention_heads,
                        intermediate_size=args.intermediate_size, max_position_embeddings=512,
                        add_pooler=True, hidden_dropout=0.0, attention_dropout=0.0)
    res_g = {}
    for impl in ("train_fused", "einsum"):
        model = mlm.BertForPreTraining(dataclasses.replace(enc, attention_impl=impl),
                                       generator=torch.Generator().manual_seed(0)).to(device)
        model.train()
        out = model(batch["input_ids"], batch["attention_mask"], batch["token_type_ids"],
                    batch["mlm_positions"])
        loss, _ = mlm.pretraining_loss(out, batch)
        named = [(n, p) for n, p in model.named_parameters()
                 if n.startswith("encoder.layer_") and n.endswith("kernel")]
        grads = torch.autograd.grad(loss, [p for _, p in named])
        res_g[impl] = (loss.item(), {n: g for (n, _), g in zip(named, grads)})
        del model, out
    (lf, gf), (le, ge) = res_g["train_fused"], res_g["einsum"]
    rel = abs(lf - le) / abs(le)
    cos = {n: torch.nn.functional.cosine_similarity(gf[n].flatten(), ge[n].flatten(),
                                                    dim=0).item() for n in gf}
    worst = min(cos, key=cos.get)
    print(f"pretraining (run_pretrain_mlm defaults: BERT-base, 128 tokens, batch 8, float32): "
          f"{steps} steps, {res['sequences_per_s']:.2f} sequences/s steady, peak {peak:.2f} GiB, "
          f"launches {launches}, last {res['final']}; one batch on the training kernels against "
          f"einsum at dropout 0: loss {lf:.6f} vs {le:.6f} (rel {rel:.2e}), lowest gradient "
          f"cosine {cos[worst]:.6f} ({worst})")
    if not rel <= LOSS_RTOL:
        fail(f"pretraining loss {lf} vs einsum {le}: rel {rel:.3e} > {LOSS_RTOL}")
    if cos[worst] < MIN_GRAD_COSINE:
        fail(f"pretraining gradient cosine {cos[worst]:.5f} of {worst} < {MIN_GRAD_COSINE}")
    return {"steps": steps, "sequences_per_s": res["sequences_per_s"], "peak_gib": peak,
            "launches": launches, "loss_rel": rel, "min_cos": cos[worst]}


def extract_features_path(root: Path, device="cuda", extra=()) -> dict:
    """Phase 25: run_extract_features at its defaults (BERT-base, 128 tokens,
    batch 8, float32, layers -1 to -4) on EXTRACT_EXAMPLES examples (a third
    of them pairs): kernels 1 and 2 once a layer a batch, examples/s; then
    every layer's features of the first batch's real tokens against the
    einsum path within F32_FWD_TOL. The kernels' GELU is the tanh form, as
    on the TPU, so the einsum path runs the same function (gelu_new)."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import run_extract_features as rx
    from spokennlp_tpu_torch.models.encoder import Encoder
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block

    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(3000)]
    sent = lambda: " ".join(rng.choice(words, size=rng.integers(8, 70)))
    lines = [sent() + (f" ||| {sent()}" if i % 3 == 0 else "") for i in range(EXTRACT_EXAMPLES)]
    (root / "extract_in.txt").write_text("\n".join(lines) + "\n")
    args = rx.build_parser().parse_args([
        "--input_file", str(root / "extract_in.txt"),
        "--output_file", str(root / "features.jsonl"), "--device", device, *extra])
    wrappers = {"fused_attention_block": fused_attention_block,
                "fused_mlp_block": fused_mlp_block}
    reset_counts(wrappers)
    reset_peak()
    out = rx.run(args)
    launches = read_counts(wrappers)
    peak = peak_gib()
    batches = math.ceil(EXTRACT_EXAMPLES / args.batch_size)
    layers = args.num_hidden_layers
    if device == "cuda" and any(n != layers * batches for n in launches.values()):
        fail(f"feature extraction launches {launches}, expected {layers} x {batches} batches")
    n_lines = len((root / "features.jsonl").read_text().splitlines())
    if n_lines != EXTRACT_EXAMPLES:
        fail(f"feature extraction wrote {n_lines} lines for {EXTRACT_EXAMPLES} examples")

    tokenize, to_ids = rx.resolve_string_tokenizer(args)
    feats = [rx.convert_example(a, b, tokenize, to_ids, args.max_seq_length)
             for a, b in rx.read_examples(args.input_file)[:args.batch_size]]
    ids, mask, types = (torch.tensor([f[i] for f in feats], dtype=torch.int32, device=device)
                        for i in (1, 2, 3))
    fused = rx.build_encoder(args)
    plain = Encoder(dataclasses.replace(fused.cfg, attention_impl="einsum",
                                        hidden_act="gelu_new")).to(device).eval()
    plain.load_state_dict(fused.state_dict(), strict=True)
    real = mask.bool()
    with torch.inference_mode():
        got, want = (m(ids, attention_mask=mask, token_type_ids=types,
                       output_hidden_states=True).hidden_states[1:] for m in (fused, plain))
    readings = f32_gemm_readings({f"layer {i}": g[real] for i, g in enumerate(got)},
                                 {f"layer {i}": w[real] for i, w in enumerate(want)})
    worst = max(readings, key=lambda k: f32_gemm_excess(readings[k], F32_FWD_TOL))
    rate = out["examples"] / out["seconds"]
    print(f"feature extraction (run_extract_features defaults: BERT-base, 128 tokens, batch 8, "
          f"float32): {out['examples']} examples in {out['seconds']:.3f} s = {rate:.1f} "
          f"examples/s (JSONL writing included), peak {peak:.2f} GiB, launches {launches}; "
          f"features against the einsum path, worst {worst}: max {readings[worst][0]:.2e}, norm "
          f"{readings[worst][1]:.2e} (limits {F32_FWD_TOL})")
    if f32_gemm_excess(readings[worst], F32_FWD_TOL) > 1:
        fail(f"extracted features: {worst} reads {readings[worst]} against the einsum path, "
             f"beyond {F32_FWD_TOL}")
    return {"examples": out["examples"], "examples_per_s": rate, "peak_gib": peak,
            "launches": launches, "reading": readings[worst]}


def dp_step(args, enc_cfg, task_cfg, batch, device) -> dict:
    """The train step of run_finetune (train_step.make_topic_seg_train_step:
    inside a process group the data-parallel step) on a fresh model: its
    metrics and the gradients it hands to the optimizer, by name."""
    from spokennlp_tpu_torch.cli.run_inference import build_model
    from spokennlp_tpu_torch.configs import TrainConfig
    from spokennlp_tpu_torch.train import optim
    from spokennlp_tpu_torch.train.train_step import make_topic_seg_train_step

    model = build_model(args, enc_cfg, task_cfg)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    opt = optim.make_optimizer(model, TrainConfig(gradient_accumulation_steps=1), 10)
    seen, real = {}, opt.step

    def step(grads):
        seen.update({n: g.detach().clone() for n, g in zip(names, grads)})
        return real(grads)

    opt.step = step
    metrics = make_topic_seg_train_step(model, task_cfg, opt, seed=args.seed)(batch)
    return {**{k: v.detach() for k, v in metrics.items()}, **seen}


def nccl_step_path(train_data: str, root: Path, device="cuda") -> dict:
    """Phase 26: the data-parallel train step in a process group of world
    size 1 over NCCL (tcp://localhost: global denominators, CSSL through the
    gather, one all-reduce of the gradients) against the step without a
    group on the same batch: metrics and the gradients handed to the
    optimizer bit for bit (same_step_bits; the plain step runs twice);
    then run_finetune for 3 steps at batch 32 (bf16) with and without the
    group: the training kernels' launches and the windows trained/s of
    each."""
    import torch

    from spokennlp_tpu_torch.cli import run_finetune
    from spokennlp_tpu_torch.dryrun import free_port
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.parallel import dist

    def cli_run(name: str, extra=()) -> list:
        argv = [a for a in train_argv(train_data, str(root / name))
                if a not in ("--do_eval", "--do_predict")] + list(extra)
        argv[argv.index("--num_train_epochs") + 1] = repr(epochs_for_steps(argv, 3))
        wrappers = {n: getattr(tb, n) for n in ("attention_train_fwd", "attention_train_bwd",
                                                "mlp_train_fwd", "mlp_train_bwd")}
        reset_counts(wrappers)
        run_finetune.main(argv)
        launches = read_counts(wrappers)
        if device == "cuda" and any(n != LAYERS * 2 * 3 for n in launches.values()):
            fail(f"{name}: launches {launches}, expected {LAYERS} x 2 views x 3 steps")
        events = [json.loads(l) for l in (root / name / "metrics.jsonl").read_text().splitlines()]
        return [e for e in events if e["event"] == "train"]

    inputs = step_inputs(train_argv(train_data, str(root / "nccl_step")), B, device)
    plain, again = dp_step(*inputs, device), dp_step(*inputs, device)
    plain_train = cli_run("nccl_plain", ["--report_to", "tensorboard"])
    tensorboard_steps = read_tensorboard(root / "nccl_plain" / "tensorboard", "train/loss")
    if tensorboard_steps != [e["step"] for e in plain_train]:
        fail(f"--report_to tensorboard: train/loss at steps {tensorboard_steps}, metrics.jsonl "
             f"at {[e['step'] for e in plain_train]}")
    dist.initialize_distributed(device, f"tcp://localhost:{free_port()}", 1, 0)
    try:
        if device == "cuda" and torch.distributed.get_backend() != "nccl":
            fail("the process group is not NCCL")
        group = dp_step(*inputs, device)
        group_train = cli_run("nccl_group")
    finally:
        dist.destroy()
    row = same_step_bits(f"the world-size-1 {'NCCL' if device == 'cuda' else 'gloo'} step",
                         plain, again, group)
    rate = lambda t: B * (len(t) - 1) / (t[-1]["time"] - t[0]["time"])
    row.update(plain_windows_per_s=rate(plain_train), group_windows_per_s=rate(group_train))
    print(f"run_finetune, 3 steps at batch {B} bf16: {row['group_windows_per_s']:.2f} windows "
          f"trained/s in the group, {row['plain_windows_per_s']:.2f} without (that run with "
          f"--report_to tensorboard: train/loss read back at steps {tensorboard_steps})")
    return row


def read_tensorboard(logdir: Path, tag: str) -> list:
    """The steps of ``tag``'s scalars in ``logdir``'s event files, read with
    TensorBoard's own reader."""
    import tensorboard
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    print(f"tensorboard {tensorboard.__version__}: {logdir.name} holds {acc.Tags()['scalars']}")
    return [e.step for e in acc.Scalars(tag)]


# ------------------------------------------- MUG Tracks 3 and 4, and AID
# Phases 27-29: the BERT-CRF keyphrase tagger (run_mug --track keyphrase),
# action-item detection (run_aid) and title generation (run_title_generation,
# PALM and seq2seq), at the widths their CLIs and the reference's recipes
# give, float32 as the CLIs compute; weights from a seed, corpora made here.
# The trunks run rows 10 and 11 in training and kernel 3 at inference; the
# CRF, the heads and the decoders are plain PyTorch, as in JAX.

KPE_L, KPE_BATCH = 512, 4
KPE_TRAIN_SENTS, KPE_EVAL_SENTS = 16, 10  # 4 steps in one epoch, 3 predict batches
CJK_VOCAB = 21128  # the Chinese BERT vocabulary's size
AID_TRAIN, AID_EVAL = (2, 16), (4, 30)  # (meetings, sentences): 4 steps of 16, 8 eval batches
TTG_S, TTG_T, TTG_BEAMS, TTG_BATCH = 512, 32, 4, 4
TTG_CHARS = 3000  # the character vocabulary's size, about


def train_wrappers() -> dict:
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    return {n: getattr(tb, n) for n in ("attention_train_fwd", "attention_train_bwd",
                                        "mlp_train_fwd", "mlp_train_bwd")}


@contextlib.contextmanager
def wrapped(owner, name: str, make):
    """owner.name replaced by make(the real one) while inside."""
    from unittest import mock

    with mock.patch.object(owner, name, make(getattr(owner, name))):
        yield


def synced(device) -> float:
    """The host clock after the card's queue has drained."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def timed_calls(device, times: list, keep: list = None):
    """make() for wrapped(): each call of the wrapped function is timed on
    the host clock after a synchronise (seconds into ``times``); ``keep``
    collects each call's first argument."""
    def make(real):
        def call(*a, **kw):
            if keep is not None:
                keep.append(a[0] if a else None)
            t0 = synced(device)
            out = real(*a, **kw)
            times.append(synced(device) - t0)
            return out
        return call
    return make


def host_ms(fn, reps: int) -> float:
    """ms a call of fn on the host clock (the CPU rehearsal's time_ms)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3

def steady_rate(times: list, per_call: int) -> float:
    """Items a second over the calls after the first (the card's warm-up)."""
    rest = times[1:] or times
    return per_call * len(rest) / sum(rest)


def gradient_check(label: str, build, loss_of, device) -> dict:
    """One batch's loss and the gradients of every weight matrix (the
    trunk's, the head's, the decoder's: each ``kernel``) on the training
    kernels against the einsum path, the same weights (``build(impl,
    generator)``: the model at dropout 0, drawn on ``device`` from one
    seed), within LOSS_RTOL and MIN_GRAD_COSINE."""
    import torch

    res = {}
    for impl in ("train_fused", "einsum"):
        with torch.device(device):
            model = build(impl, torch.Generator(device=device).manual_seed(1)).train()
        loss = loss_of(model)
        named = [(n, p) for n, p in model.named_parameters() if n.endswith("kernel")]
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        res[impl] = (loss.item(), {n: torch.zeros_like(p) if g is None else g
                                   for (n, p), g in zip(named, grads)})
        del model, loss
    (lf, gf), (le, ge) = res["train_fused"], res["einsum"]
    rel = abs(lf - le) / abs(le)
    # a matrix the loss does not reach has a zero gradient on both paths
    cos = {n: 1.0 if not gf[n].any() and not ge[n].any() else
           torch.nn.functional.cosine_similarity(gf[n].flatten(), ge[n].flatten(),
                                                 dim=0).item() for n in gf}
    worst = min(cos, key=cos.get)
    print(f"  {label}: one batch on the training kernels against einsum at dropout 0: loss "
          f"{lf:.6f} vs {le:.6f} (rel {rel:.2e}), lowest gradient cosine {cos[worst]:.6f} "
          f"({worst}) over {len(cos)} weight matrices")
    if not rel <= LOSS_RTOL:
        fail(f"{label}: loss {lf} vs einsum {le}: rel {rel:.3e} > {LOSS_RTOL}")
    if cos[worst] < MIN_GRAD_COSINE:
        fail(f"{label}: gradient cosine {cos[worst]:.5f} of {worst} < {MIN_GRAD_COSINE}")
    return {"loss_rel": rel, "min_cos": cos[worst]}


def einsum_twin(model, cls, *args):
    """``model``'s class on the einsum path with the kernels' tanh GELU
    (``gelu_new``), carrying its weights, in eval mode on its device."""
    import dataclasses

    import torch

    enc = dataclasses.replace(model.enc_cfg, attention_impl="einsum", hidden_act="gelu_new")
    with torch.device(next(model.parameters()).device):
        twin = cls(enc, *args)
    twin.load_state_dict(model.state_dict(), strict=True)
    return twin.eval()


def cjk_text(rng, n: int, pool: int = 3000) -> str:
    return "".join(chr(0x4E00 + int(c)) for c in rng.integers(0, pool, size=n))


def write_kpe_corpus(root: Path, seed: int = 8) -> Path:
    """MUG meetings for Track 4 (train.jsonl: KPE_TRAIN_SENTS sentences,
    dev.jsonl: KPE_EVAL_SENTS) of CJK characters: sentences of 8-160
    characters, one of 500 and one empty (an all-padding row) in each,
    meeting-level key words that the sentences contain; vocab.txt, one line
    a character, at CJK_VOCAB entries."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    keys = [cjk_text(rng, int(rng.integers(2, 5)), 400) for _ in range(6)]

    def sentence(j):
        if j == 0:
            return ""
        n = 500 if j == 1 else int(rng.integers(8, 160))
        s = cjk_text(rng, n)
        if rng.random() < 0.7:
            at = int(rng.integers(0, max(n - 5, 1)))
            kw = keys[int(rng.integers(0, len(keys)))]
            s = s[:at] + kw + s[at + len(kw):]
        return s[:n]

    for name, n in (("train.jsonl", KPE_TRAIN_SENTS), ("dev.jsonl", KPE_EVAL_SENTS)):
        meeting = {"meeting_key": name[:3], "candidate": [{"key_word": keys[:3]},
                                                           {"key_word": keys[2:]}],
                   "sentences": [{"id": j + 1, "s": sentence(j)} for j in range(n)]}
        (root / name).write_text(json.dumps(meeting, ensure_ascii=False) + "\n")
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab = specials + [chr(0x4E00 + i) for i in range(CJK_VOCAB - len(specials))]
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return root


def kpe_path(root: Path, device="cuda", widths=()) -> dict:
    """Phase 27: run_mug --track keyphrase at BERT-base widths (``widths``:
    CLI size flags for a rehearsal), L = KPE_L, batch KPE_BATCH, float32, one
    epoch: rows 10 and 11 once a layer a step, kernel 3 once a predict
    batch; finite losses; sentences trained/s and tagged/s (host clock after
    a synchronise, the first call left out). Then on one training batch (the
    empty sentence in it) the loss and gradients against the einsum path at
    dropout 0; Viterbi tags of the trained model's kernel-path emissions
    against its einsum twin's (tanh GELU) on every eval sentence's valid
    positions (>= MIN_ARGMAX_AGREEMENT); and the CRF's share of a training
    step (its loss and backward alone against the whole step, CUDA events)."""
    import argparse
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import common, run_mug
    from spokennlp_tpu_torch.ops import crf
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack
    from spokennlp_tpu_torch.projects.mug import data as mug_data
    from spokennlp_tpu_torch.projects.mug import keyphrase as kp

    data = write_kpe_corpus(root / "kpe")
    argv = ["--track", "keyphrase", "--train_file", str(data / "train.jsonl"), "--eval_file",
            str(data / "dev.jsonl"), "--output_dir", str(root / "kpe_out"), "--vocab_file",
            str(data / "vocab.txt"), "--max_seq_length", str(KPE_L),
            "--per_device_train_batch_size", str(KPE_BATCH), "--num_train_epochs", "1",
            "--device", device, *widths]
    args = run_mug.make_parser().parse_args(argv)
    wrappers = {**train_wrappers(), "fused_encoder_stack": fused_encoder_stack}
    step_s, tag_s, models = [], [], []
    reset_counts(wrappers)
    reset_peak()
    t0 = time.perf_counter()
    with wrapped(kp, "make_kpe_train_step", lambda real: lambda *a, **kw: timed_calls(
            device, step_s)(real(*a, **kw))), \
            wrapped(kp, "decode_tags", timed_calls(device, tag_s, models)):
        res = run_mug.main(argv)
    secs, peak = time.perf_counter() - t0, peak_gib()
    launches = read_counts(wrappers)
    steps, batches = len(step_s), len(tag_s)
    layers = args.num_hidden_layers
    expected = {**{n: layers * steps for n in train_wrappers()}, "fused_encoder_stack": batches}
    print(f"Track 4 (run_mug --track keyphrase, L={KPE_L}, batch {KPE_BATCH}, float32): "
          f"{steps} steps, {batches} predict batches in {secs:.1f} s, peak {peak:.2f} GiB, "
          f"losses {res['train_loss']}, launches {launches}, metrics {res['metrics']}")
    if steps < 3 or batches < 2:
        fail(f"Track 4 took {steps} steps and {batches} predict batches (3 and 2 or more)")
    if device == "cuda" and launches != expected:
        fail(f"Track 4 launches {launches}, expected {expected}")
    if not all(math.isfinite(v) for v in res["train_loss"]):
        fail(f"Track 4: non-finite training loss {res['train_loss']}")
    row = {"launches": launches, "steps": steps, "predict_batches": batches, "run_s": secs,
           "peak_gib": peak, "train_loss": res["train_loss"], "metrics": res["metrics"],
           "sentences_trained_per_s": steady_rate(step_s, KPE_BATCH),
           "sentences_tagged_per_s": steady_rate(tag_s, KPE_BATCH)}

    tokenize_fn, special = common.resolve_tokenizer(argparse.Namespace(
        model_name_or_path=None, vocab_file=str(data / "vocab.txt")))
    train_rows = kp.featurize_kpe(mug_data.read_jsonl(str(data / "train.jsonl")), tokenize_fn,
                                  special["pad"], KPE_L, with_tags=True)
    batch = {k: torch.from_numpy(np.stack([r[k] for r in train_rows[:KPE_BATCH]])).to(device)
             for k in ("input_ids", "attention_mask", "tags")}
    if batch["attention_mask"][:, 0].all():
        fail("Track 4: the gradient check's batch holds no empty sentence")
    trained = models[0]
    enc0 = dataclasses.replace(trained.enc_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    build = lambda impl, gen: kp.BertCrfTagger(dataclasses.replace(enc0, attention_impl=impl),
                                               generator=gen)
    row.update(gradient_check("Track 4", build, lambda m: m(
        batch["input_ids"], batch["attention_mask"], tags=batch["tags"])["loss"], device))

    eval_rows = kp.featurize_kpe(mug_data.read_jsonl(str(data / "dev.jsonl")), tokenize_fn,
                                 special["pad"], KPE_L, with_tags=False)
    twin = einsum_twin(trained, kp.BertCrfTagger)
    ids = np.stack([r["input_ids"] for r in eval_rows])
    mask = np.stack([r["attention_mask"] for r in eval_rows])
    got, want = [], []
    for s in range(0, len(eval_rows), KPE_BATCH):  # the CLI's chunks: kernel 3 at B = 4
        sl = slice(s, s + KPE_BATCH)
        got.append(kp.decode_tags(trained, ids[sl], mask[sl]))
        want.append(kp.decode_tags(twin, ids[sl], mask[sl]))
    valid = mask.astype(bool)
    agree = float((np.concatenate(got)[valid] == np.concatenate(want)[valid]).mean())
    print(f"  Track 4 Viterbi tags, kernel path against the einsum path (tanh GELU) on "
          f"{int(valid.sum())} valid positions of {len(eval_rows)} sentences: {agree:.5f}")
    if agree < MIN_ARGMAX_AGREEMENT:
        fail(f"Track 4: Viterbi agreement {agree:.5f} < {MIN_ARGMAX_AGREEMENT}")
    row["viterbi_agreement"] = agree
    del twin

    # the CRF's share of a step: its loss and backward on the step's emissions
    model = trained.train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-9)
    step = kp.make_kpe_train_step(model, opt, torch.Generator(device=device).manual_seed(2))
    em = model(batch["input_ids"], batch["attention_mask"])["emissions"].detach()
    em.requires_grad_(True)

    def crf_alone():
        loss = -crf.crf_log_likelihood(em, batch["tags"], batch["attention_mask"],
                                       model.transitions)
        loss.backward()

    timer = time_ms if device == "cuda" else host_ms
    step(batch), crf_alone()
    step_ms, crf_ms = timer(lambda: step(batch), 3), timer(crf_alone, 3)
    row.update(step_ms=step_ms, crf_ms=crf_ms, crf_share=crf_ms / step_ms)
    print(f"  Track 4 step at B={KPE_BATCH}, L={KPE_L}: {step_ms:.2f} ms, of which the CRF's "
          f"loss and backward alone {crf_ms:.2f} ms ({100 * crf_ms / step_ms:.1f} %); "
          f"{row['sentences_trained_per_s']:.2f} sentences trained/s, "
          f"{row['sentences_tagged_per_s']:.2f} tagged/s")
    del model, opt, step, models, trained
    return row


def write_aid_meetings(path: Path, meetings: int, sentences: int, seed: int) -> str:
    """AID meetings JSONL ({"sentences": [{"text", "label"}]}): sentences of
    6-40 words, a fifth of them action items."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(3000)]
    with open(path, "w") as f:
        for m in range(meetings):
            f.write(json.dumps({"meeting": f"m{m}", "sentences": [
                {"text": " ".join(rng.choice(words, size=int(rng.integers(6, 41)))),
                 "label": int(rng.random() < 0.2)} for _ in range(sentences)]}) + "\n")
    return str(path)


def aid_path(root: Path, device="cuda", widths=()) -> dict:
    """Phase 28: run_aid at its defaults (BERT-base, L=128, batch 16,
    float32, context-drop-dynamic, cls) for one epoch: rows 10 and 11 once a
    layer a step, kernel 3 once an eval batch; finite losses; examples
    trained/s (host clock after a synchronise, the first step left out);
    one batch's loss and gradients against einsum at dropout 0; the trained
    model's eval argmax against its einsum twin (tanh GELU)."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import common, run_aid
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack
    from spokennlp_tpu_torch.projects import action_item as ai

    train = write_aid_meetings(root / "aid_train.jsonl", *AID_TRAIN, seed=11)
    dev = write_aid_meetings(root / "aid_dev.jsonl", *AID_EVAL, seed=12)
    argv = ["--train_file", train, "--eval_file", dev, "--output_dir", str(root / "aid_out"),
            "--num_train_epochs", "1", "--device", device, *widths]
    args = run_aid.make_parser().parse_args(argv)
    bs = args.per_device_train_batch_size
    wrappers = {**train_wrappers(), "fused_encoder_stack": fused_encoder_stack}
    step_s, models = [], []
    reset_counts(wrappers)
    reset_peak()
    t0 = time.perf_counter()

    def make_step(real):
        def build_step(model, *a, **kw):
            models.append(model)
            return timed_calls(device, step_s)(real(model, *a, **kw))
        return build_step

    with wrapped(ai, "make_aid_train_step", make_step):
        res = run_aid.main(argv)
    secs, peak = time.perf_counter() - t0, peak_gib()
    launches = read_counts(wrappers)
    n_eval = sum(len(json.loads(l)["sentences"]) for l in open(dev))
    steps, batches = len(step_s), math.ceil(n_eval / bs)
    expected = {**{n: args.num_hidden_layers * steps for n in train_wrappers()},
                "fused_encoder_stack": batches}
    print(f"AID (run_aid defaults: L={args.max_seq_length}, batch {bs}, float32, "
          f"{args.drop_type}, {args.classifier_input}): {steps} steps and {batches} eval "
          f"batches in {secs:.1f} s (best_model written), peak {peak:.2f} GiB, launches "
          f"{launches}, {res['history']}")
    if steps < 3:
        fail(f"AID took {steps} steps, expected 3 or more")
    if device == "cuda" and launches != expected:
        fail(f"AID launches {launches}, expected {expected}")
    if not all(math.isfinite(h["train_loss"]) for h in res["history"]):
        fail(f"AID: non-finite loss in {res['history']}")
    row = {"launches": launches, "steps": steps, "eval_batches": batches, "run_s": secs,
           "peak_gib": peak, "history": res["history"],
           "examples_trained_per_s": steady_rate(step_s, bs)}

    tokenize_fn, special = common.resolve_tokenizer(argparse.Namespace(
        model_name_or_path=None, vocab_file=None))
    trained = models[0]
    cfg = dataclasses.replace(trained.cfg, dropout_rate=0.0)
    examples = []
    rng = np.random.default_rng(0)
    for m in (json.loads(l) for l in open(train)):
        examples += ai.build_paired_examples(m["sentences"], cfg, rng)
    to_dev = lambda b: {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    batch = to_dev(ai.collate_examples(examples[:bs], tokenize_fn, cfg, special["cls"],
                                       special["sep"]))
    enc0 = dataclasses.replace(trained.enc_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    build = lambda impl, gen: ai.AidModel(dataclasses.replace(enc0, attention_impl=impl), cfg,
                                          generator=gen)
    keys = ("input_ids", "attention_mask", "token_type_ids", "sep_position")
    row.update(gradient_check("AID", build, lambda m: ai.aid_loss(
        m(*(batch[k] for k in keys)), batch["label"], cfg)[0], device))

    eval_cfg = dataclasses.replace(cfg, drop_type="none", noisy_type="remain")
    ex = []
    for m in (json.loads(l) for l in open(dev)):
        ex += ai.build_paired_examples(m["sentences"], eval_cfg, rng)
    twin = einsum_twin(trained, ai.AidModel, cfg)
    trained.eval()
    got, want = [], []
    with torch.no_grad():
        for s in range(0, len(ex), bs):  # the CLI's eval batches: kernel 3 at B = 16
            b = to_dev(ai.collate_examples(ex[s:s + bs], tokenize_fn, cfg, special["cls"],
                                           special["sep"]))
            got.append(trained(*(b[k] for k in keys)).argmax(-1).cpu())
            want.append(twin(*(b[k] for k in keys)).argmax(-1).cpu())
    agree = float((torch.cat(got) == torch.cat(want)).float().mean())
    print(f"  AID eval argmax, kernel path against the einsum path (tanh GELU) on {len(ex)} "
          f"examples: {agree:.4f}; {row['examples_trained_per_s']:.1f} examples trained/s")
    if agree < MIN_ARGMAX_AGREEMENT:
        fail(f"AID: eval argmax agreement {agree:.4f} < {MIN_ARGMAX_AGREEMENT}")
    row["agreement"] = agree
    del twin, trained, models
    return row


def write_title_corpus(root: Path, train_meetings: int, eval_meetings: int,
                       seed: int = 13) -> Path:
    """MUG meetings for Track 3: four topics a meeting of 12 sentences of
    20-60 characters (about 480 a topic) from TTG_CHARS CJK characters, two
    candidate titles of 4-12 characters each."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)

    def meeting(key):
        sents = [{"id": j + 1, "s": cjk_text(rng, int(rng.integers(20, 61)), TTG_CHARS)}
                 for j in range(48)]
        topics = [{"id": end, "candidate": [
            {"title": cjk_text(rng, int(rng.integers(4, 13)), TTG_CHARS)} for _ in range(2)]}
            for end in (12, 24, 36, 48)]
        return {"meeting_key": key, "sentences": sents, "topic_segment_ids": topics}

    for name, n in (("train.jsonl", train_meetings), ("dev.jsonl", eval_meetings)):
        with open(root / name, "w") as f:
            for i in range(n):
                f.write(json.dumps(meeting(f"{name[:3]}{i}"), ensure_ascii=False) + "\n")
    return root


def title_path(root: Path, arch: str, device="cuda", widths=None) -> dict:
    """Phase 29: run_title_generation --model_arch ``arch`` for one epoch:
    PALM at PALM-chinese-base widths (768, 12 + 12 layers, 12 heads, 3072)
    over S=512, T=32, 4 beams, batch 4 (3 steps, one decoded eval batch);
    seq2seq at the CLI's defaults (2 steps). ``widths``: size flags instead
    (a rehearsal). Rows 10 and 11 once an encoder layer a step, kernel 3
    once a decode step; finite losses; titles/s of the decode; one batch's
    loss and gradients against einsum at dropout 0; the first decode step's
    log-probabilities (B x beams rows) on the kernel path against the einsum
    path with the kernels' tanh GELU within F32_FWD_TOL."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import run_title_generation as ttg
    from spokennlp_tpu_torch.models import palm, seq2seq
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    steps_wanted = 3 if arch == "palm" else 2
    data = write_title_corpus(root / f"ttg_{arch}", math.ceil(steps_wanted * TTG_BATCH / 4), 1)
    if widths is None:
        widths = (["--hidden_size", str(H), "--num_hidden_layers", str(LAYERS),
                   "--num_decoder_layers", str(LAYERS), "--num_attention_heads", str(NH),
                   "--intermediate_size", str(I)] if arch == "palm" else [])
    argv = ["--train_file", str(data / "train.jsonl"), "--eval_file", str(data / "dev.jsonl"),
            "--output_dir", str(root / f"ttg_{arch}_out"), "--model_arch", arch,
            "--max_source_length", str(TTG_S), "--max_target_length", str(TTG_T),
            "--num_beams", str(TTG_BEAMS), "--per_device_train_batch_size", str(TTG_BATCH),
            "--num_train_epochs", "1", "--device", device, *widths]
    args = ttg.make_parser().parse_args(argv)
    wrappers = {**train_wrappers(), "fused_encoder_stack": fused_encoder_stack}
    step_s, decode_s, decode_steps, built = [], [], [], []

    def count_steps(real):
        def search(step_log_probs, *a, **kw):
            def step(*sa):
                decode_steps.append(1)
                return step_log_probs(*sa)
            return real(step, *a, **kw)
        return search

    def make_step(real):
        def build_step(model, *a, **kw):
            built.append(model)
            return timed_calls(device, step_s)(real(model, *a, **kw))
        return build_step

    decoder = "palm_beam_decode" if arch == "palm" else "beam_decode"
    module = palm if arch == "palm" else seq2seq
    reset_counts(wrappers)
    reset_peak()
    t0 = time.perf_counter()
    with wrapped(seq2seq, "beam_search", count_steps), wrapped(palm, "beam_search", count_steps), \
            wrapped(ttg, "make_title_train_step", make_step), \
            wrapped(module, decoder, timed_calls(device, decode_s)):
        res = ttg.main(argv)
    secs, peak = time.perf_counter() - t0, peak_gib()
    launches = read_counts(wrappers)
    steps, n_decode = len(step_s), len(decode_steps)
    n_eval = len(ttg.pairs_from(str(data / "dev.jsonl"), require_refs=False))
    expected = {**{n: args.num_hidden_layers * steps for n in train_wrappers()},
                "fused_encoder_stack": n_decode}
    print(f"Track 3 (run_title_generation --model_arch {arch}: H={args.hidden_size}, "
          f"{args.num_hidden_layers} + {args.num_decoder_layers} layers, S={TTG_S}, T={TTG_T}, "
          f"{TTG_BEAMS} beams, batch {TTG_BATCH}, float32): {steps} steps, {len(decode_s)} "
          f"decoded batches of {n_eval} topics in {n_decode} decode steps, {secs:.1f} s, peak "
          f"{peak:.2f} GiB, launches {launches}, {res['history']}")
    if steps < steps_wanted or not decode_s:
        fail(f"Track 3 {arch}: {steps} steps and {len(decode_s)} decoded batches")
    if device == "cuda" and launches != expected:
        fail(f"Track 3 {arch}: launches {launches}, expected {expected}")
    if not all(math.isfinite(h["train_loss"]) for h in res["history"]):
        fail(f"Track 3 {arch}: non-finite loss in {res['history']}")
    row = {"launches": launches, "steps": steps, "decode_steps": n_decode, "run_s": secs,
           "peak_gib": peak, "history": res["history"],
           "titles_per_s": n_eval / sum(decode_s), "decode_s": sum(decode_s)}

    trained = built[0]
    # the CLI's character ids, rebuilt in the CLI's order
    encode, _, _, pad, bos, eos, _ = ttg.make_tokenizer(None)
    train_pairs = ttg.pairs_from(str(data / "train.jsonl"), require_refs=True)
    eval_pairs = ttg.pairs_from(str(data / "dev.jsonl"), require_refs=False)
    for r in train_pairs + eval_pairs:
        encode(r["source"]), [encode(t) for t in r["titles"]]
    feats = ttg.featurize(train_pairs, encode, TTG_S, TTG_T, pad, bos, eos)
    batch = {k: torch.from_numpy(v[:TTG_BATCH]).to(device) for k, v in feats.items()}
    enc0 = dataclasses.replace(trained.enc_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    dec0 = dataclasses.replace(trained.cfg, dropout=0.0)
    cls = palm.PalmModel if arch == "palm" else seq2seq.Seq2SeqModel
    loss_fn = palm.palm_loss if arch == "palm" else seq2seq.seq2seq_loss
    build = lambda impl, gen: cls(dataclasses.replace(enc0, attention_impl=impl), dec0,
                                  generator=gen)
    row.update(gradient_check(f"Track 3 {arch}", build, lambda m: loss_fn(m, batch), device))

    # the first decode step on the kernel path and on its einsum twin
    efeats = ttg.featurize(eval_pairs[:TTG_BATCH], encode, TTG_S, TTG_T, pad, bos, eos)
    ids = torch.from_numpy(efeats["input_ids"]).to(device).repeat_interleave(TTG_BEAMS, 0)
    mask = torch.from_numpy(efeats["attention_mask"]).to(device).repeat_interleave(TTG_BEAMS, 0)
    dec = torch.full((ids.shape[0], TTG_T), pad, dtype=torch.int32, device=device)
    dec[:, 0] = bos
    dmask = torch.zeros_like(dec)
    dmask[:, 0] = 1
    twin = einsum_twin(trained, cls, trained.cfg)
    trained.eval()

    def first_step(model):
        with torch.no_grad():
            out = model(ids, mask, dec, decoder_attention_mask=dmask)
        return (out["log_probs"][:, 0] if arch == "palm"
                else torch.log_softmax(out["logits"][:, 0].float(), -1))

    reading = f32_gemm_readings({"log_probs": first_step(trained)},
                                {"log_probs": first_step(twin)})["log_probs"]
    print(f"  Track 3 {arch}: first decode step's log-probs ({ids.shape[0]} rows), kernel path "
          f"against the einsum path (tanh GELU): max {reading[0]:.2e}, norm {reading[1]:.2e} "
          f"(limits {F32_FWD_TOL}); {row['titles_per_s']:.2f} titles/s decoded")
    if f32_gemm_excess(reading, F32_FWD_TOL) > 1:
        fail(f"Track 3 {arch}: first decode step {reading} beyond {F32_FWD_TOL}")
    row["first_step_reading"] = reading
    del twin, trained, built
    return row


# the Ditto slice: BERT-base (with its pooler) over run_ditto's 128 tokens in
# batches of 32, an STS file of DITTO_PAIRS pairs, small relatedness and
# probing sets
DITTO_PAIRS, DITTO_L, DITTO_B = 1000, 128, 32
DITTO_WORDS = 3000
# the attention diagonal in float32 against float64: a share of the row's
# softmax, summed over one head's 64-term products; a missing key mask
# (planted) moves it by far more
DIAG_TOL = 1e-5
# Ditto's nine poolers on kernels 1 and 2 against the einsum path, (max
# |err| / max |ref|, ||err|| / ||ref||): F32_FWD_TOL's norm part; its max
# part is one block's, and the cls pooler (tanh of a 768-wide product of
# the 12th layer's CLS row, near 1 where it saturates) read 1.72e-4 of its
# largest value (norm 4.58e-5) on the H100 (PERF.md, section 6), so 3e-4. The
# einsum path with the erf GELU, planted, reads 12 x F32_FWD_TOL
DITTO_POOLER_TOL = (3e-4, F32_FWD_TOL[1])
# the SLD slice: GPT-2 small at SLDConfig's defaults (V = 50257 + 2 + 2000,
# blocks of 1024), batch 8, float32, SLD_STEPS optimizer steps, then one
# decode eval of SLD_B prompts of 400-700 speech tokens, greedy and 4 beams
SLD_B, SLD_STEPS, SLD_BEAMS, SLD_LR = 8, 4, 4, 1e-4
SLD_SPEECH, SLD_CHECK_STEPS = (400, 700), 16
# the SLD loss in float32 against float64 on the same logits, relative, per
# part: the CEs sum terms of one sign (read 1.8e-8 and 5.6e-8 on the H100,
# PERF.md), so 1e-5; the KL sums 8 x 1023 x 2000 terms q (log q - log p) of
# both signs, small against their magnitudes (1.7e-5 of it, which is 9.2e-6
# of the total), so 1e-4 for the KL and the total. Each of SLD_FAULTS moves
# the total by 1e-3 of it or more
SLD_LOSS_RTOL = {"loss": 1e-4, "ce_speech": 1e-5, "ce_text": 1e-5, "kl_speech": 1e-4}
# WavLM-Large (microsoft/wavlm-large's config.json): 24 x 1024, 16 heads,
# 4096, the "layer" conv norm with conv biases, stable pre-LN
WAVLM_LARGE = dict(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
                   conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True)
SLD_WAVES, SLD_WAVE_S, SLD_LAYER = 8, (5.0, 20.0), 23
SLD_SPEEDS = (0.9, 1.0, 1.1)


def ditto_checkpoints(root: Path, device="cuda", widths=None) -> dict:
    """BERT-base with its pooler at random (seed 30), written as a native
    checkpoint and as an HF directory: {"native": dir, "hf": dir}."""
    import torch

    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models import checkpoint_io, hf_export
    from spokennlp_tpu_torch.models.encoder import Encoder

    cfg = EncoderConfig(add_pooler=True, **(widths or {}))
    with torch.device(device):
        enc = Encoder(cfg, generator=torch.Generator(device=device).manual_seed(30))
    params = checkpoint_io.params_from_state_dict(enc.state_dict())
    out = {"native": root / "ditto_native", "hf": root / "ditto_hf"}
    checkpoint_io.save_checkpoint(str(out["native"]), params, cfg)
    hf_export.save_hf_checkpoint(str(out["hf"]), params, cfg)
    return out


def ditto_sentences(rng, n: int, lo: int = 6, hi: int = 160) -> list:
    words = [f"w{i}" for i in range(DITTO_WORDS)]
    return [" ".join(rng.choice(words, size=int(rng.integers(lo, hi)))) for _ in range(n)]


def write_ditto_data(root: Path, small: int = 96) -> dict:
    """An STS TSV of DITTO_PAIRS pairs (6-160 words: some past 128 tokens),
    relatedness train/test TSVs and probing splits of ``small`` rows each."""
    rng = np.random.default_rng(31)
    sts = root / "sts.tsv"
    a, b = ditto_sentences(rng, DITTO_PAIRS), ditto_sentences(rng, DITTO_PAIRS)
    sts.write_text("\n".join(f"{x}\t{y}\t{g:.2f}" for x, y, g in
                             zip(a, b, rng.uniform(0, 5, size=DITTO_PAIRS))) + "\n")
    rel = root / "relatedness"
    rel.mkdir()
    for name in ("train.tsv", "test.tsv"):
        x, y = ditto_sentences(rng, small, hi=40), ditto_sentences(rng, small, hi=40)
        (rel / name).write_text("\n".join(f"{g:.1f}\t{p}\t{q}" for g, p, q in
                                          zip(rng.uniform(1, 5, size=small), x, y)) + "\n")
    probe = {split: (ditto_sentences(rng, small, hi=40),
                     rng.integers(0, 2, size=small).tolist()) for split in ("train", "dev", "test")}
    return {"sts": sts, "relatedness": rel, "probe": probe}


def diagonal_float64(encoder, hidden, mask, layer: int, head: int, key_mask: bool = True):
    """exp(s_ii - logsumexp_j s_ij) of one (layer, head) in float64 (without
    the key mask when ``key_mask`` is False: the planted fault)."""
    import torch

    qkv = getattr(encoder, f"layer_{layer}").attention.qkv
    k, b = qkv.kernel.double(), qkv.bias.double()
    h = hidden.double()
    q = h @ k[:, 0, head] + b[0, head]
    kk = h @ k[:, 1, head] + b[1, head]
    s = q @ kk.transpose(1, 2) / math.sqrt(encoder.cfg.head_dim)
    sm = s + (1.0 - mask[:, None, :].double()) * -1e9 if key_mask else s
    return torch.exp(torch.diagonal(s, dim1=1, dim2=2) - torch.logsumexp(sm, -1))


def ditto_path(root: Path, device="cuda", widths=None) -> dict:
    """Phase 30: run_ditto --pooler att_first_last (the recipe's (0, 9)) on
    the HF directory at --max_seq_length 128, --batch_size 32 over the STS
    file and the relatedness regression: kernels 1 and 2 once a layer a
    batch, sentences embedded/s; the SentEval MLP probe (the l2 grid) on the
    card over the probing set's embeddings; the native checkpoint gives the
    same numbers. Then on one batch: every pooler on the kernels against the
    einsum path (tanh GELU) within DITTO_POOLER_TOL (the erf GELU planted there
    must fail), the diagonal against float64 within DIAG_TOL (the key mask
    left out must fail), and kernels 1 and 2 at B = 32, L = 128 in float32
    against their plain versions, timed. sklearn is not on the card's
    machine: the logreg probe and the k-fold splits are not run here."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import run_ditto
    from spokennlp_tpu_torch.models.encoder import Encoder
    from spokennlp_tpu_torch.ops.cuda.attention_block import (
        attention_block_plain, fused_attention_block,
    )
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain
    from spokennlp_tpu_torch.projects import ditto, senteval_classifier

    ckpts = ditto_checkpoints(root, device, widths)
    data = write_ditto_data(root)
    wrappers = {"fused_attention_block": fused_attention_block,
                "fused_mlp_block": fused_mlp_block}
    embed_s = []

    def timed_embed(real):
        def make(*a, **kw):
            return timed_calls(device, embed_s)(real(*a, **kw))
        return make

    argv = ["--pooler", "att_first_last", "--max_seq_length", str(DITTO_L), "--batch_size",
            str(DITTO_B), "--sts_tsv", str(data["sts"]), "--relatedness_dir",
            str(data["relatedness"]), "--device", device]
    runs = {}
    for name in ("hf", "native"):
        reset_counts(wrappers)
        reset_peak()
        t0 = time.perf_counter()
        with wrapped(ditto, "make_embed_fn", timed_embed):
            res = run_ditto.main(argv + ["--model_name_or_path", str(ckpts[name]),
                                         "--output_dir", str(root / f"ditto_{name}")])
        runs[name] = {"results": res, "run_s": time.perf_counter() - t0,
                      "launches": read_counts(wrappers), "peak_gib": peak_gib(),
                      "batches": len(embed_s)}
        if name == "hf":
            hf_batches = len(embed_s)
            rate = steady_rate(embed_s, DITTO_B)
            embed_s.clear()
    encoder, tokenize_fn, special = run_ditto.load_encoder(argparse.Namespace(
        model_name_or_path=str(ckpts["hf"]), pooler="att_first_last"), device)
    layers = encoder.cfg.num_layers
    hf = runs["hf"]
    print(f"Ditto (run_ditto: {layers} layers, L={DITTO_L}, batch {DITTO_B}, float32, "
          f"att_first_last at the recipe's (0, 9)): {hf_batches} batches in {hf['run_s']:.1f} s, "
          f"{rate:.1f} sentences embedded/s (host clock after a synchronise, the first batch left "
          f"out), peak {hf['peak_gib']:.2f} GiB, launches {hf['launches']}; {hf['results']}")
    for name, run in runs.items():
        if device == "cuda" and any(n != layers * run["batches"]
                                    for n in run["launches"].values()):
            fail(f"Ditto ({name}): launches {run['launches']}, expected {layers} x "
                 f"{run['batches']} batches")
        if not all(math.isfinite(v) for r in run["results"].values() for v in r.values()):
            fail(f"Ditto ({name}): a non-finite result in {run['results']}")
    if runs["native"]["results"] != hf["results"]:
        fail(f"Ditto: the native checkpoint gives {runs['native']['results']}, the HF directory "
             f"{hf['results']}")

    def tokenize(sentences):
        rows = [[special["cls"]] + tokenize_fn(s)[: DITTO_L - 1] for s in sentences]
        ids = np.full((len(rows), DITTO_L), special["pad"], np.int32)
        mask = np.zeros((len(rows), DITTO_L), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)], mask[i, : len(r)] = r, 1
        return ids, mask

    # the MLP probe of the SentEval protocol, on the card (its l2 grid)
    probe = data["probe"]
    embed = ditto.make_embed_fn(encoder, "att_first_last", 0, 9)
    X = {s: ditto._embed_corpus(embed, tokenize, probe[s][0], DITTO_B) for s in probe}
    y = {s: np.asarray(probe[s][1]) for s in probe}
    t0 = time.perf_counter()
    clf, reg, dev_acc = senteval_classifier.fit_with_reg_grid(
        X["train"], y["train"], X["dev"], y["dev"], 2, device=device)
    probe_row = {"dev_acc": dev_acc, "test_acc": clf.score(X["test"], y["test"]), "best_reg": reg,
                 "fit_s": time.perf_counter() - t0}
    print(f"  Ditto MLP probe (SentEval protocol, nhid 0, l2 grid) on the card: {probe_row}")

    rng = np.random.default_rng(32)
    ids, mask = tokenize(ditto_sentences(rng, DITTO_B))
    ids, mask = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    # the einsum twin with the kernels' tanh GELU, and with the erf GELU
    # planted (on the CPU, where "auto" is the einsum path with the erf
    # GELU, the other way round)
    acts = ("gelu_new", "gelu") if device == "cuda" else ("gelu", "gelu_new")
    twins = {}
    for act in acts:
        with torch.device(device):
            twins[act] = Encoder(dataclasses.replace(encoder.cfg, attention_impl="einsum",
                                                     hidden_act=act))
        twins[act].load_state_dict(encoder.state_dict(), strict=True)
        twins[act].eval()
    got = {p: ditto.make_embed_fn(encoder, p, 0, 9)(ids, mask) for p in ditto.POOLERS}
    want = {p: ditto.make_embed_fn(twins[acts[0]], p, 0, 9)(ids, mask) for p in ditto.POOLERS}
    bad = {p: ditto.make_embed_fn(twins[acts[1]], p, 0, 9)(ids, mask) for p in ditto.POOLERS}
    readings = f32_gemm_readings(got, want)
    worst = max(readings, key=lambda k: f32_gemm_excess(readings[k], DITTO_POOLER_TOL))
    planted = f32_gemm_readings(got, bad)
    caught = max(f32_gemm_excess(r, DITTO_POOLER_TOL) for r in planted.values())
    print(f"  Ditto poolers on kernels 1 and 2 against the einsum path ({acts[0]}), one batch of "
          f"{DITTO_B}: worst {worst} max {readings[worst][0]:.2e}, norm {readings[worst][1]:.2e} "
          f"(limits {DITTO_POOLER_TOL}); planted {acts[1]} in the einsum path: "
          f"{'rejected' if caught > 1 else 'ACCEPTED'} ({caught:.1f} x the limit)")
    if f32_gemm_excess(readings[worst], DITTO_POOLER_TOL) > 1:
        fail(f"Ditto pooler {worst} reads {readings[worst]} against the einsum path")
    if caught <= 1:
        fail(f"the Ditto pooler check accepts an einsum path with {acts[1]}")
    with torch.no_grad():
        h0 = encoder(ids, attention_mask=mask, output_hidden_states=True).hidden_states[0]
        diag = ditto.attention_diagonal(encoder, h0, mask, 0, 9)
        d64 = diagonal_float64(encoder, h0, mask, 0, 9)
        d_bad = diagonal_float64(encoder, h0, mask, 0, 9, key_mask=False)
    diag_err = (diag.double() - d64).abs().max().item()
    bad_err = (diag.double() - d_bad).abs().max().item()
    print(f"  Ditto diagonal (layer 0, head 9) against float64: max |err| {diag_err:.2e} "
          f"(limit {DIAG_TOL}); planted, the key mask left out: {bad_err:.2e} "
          f"({'rejected' if bad_err > DIAG_TOL else 'ACCEPTED'})")
    if diag_err > DIAG_TOL or bad_err <= DIAG_TOL:
        fail(f"Ditto diagonal: {diag_err:.3e} (planted {bad_err:.3e}) against {DIAG_TOL}")

    kernel_rows = {}
    if device == "cuda":  # kernels 1 and 2 at Ditto's shape, layer 0's weights
        layer = encoder.layer_0
        att, ln1, mlp_ln = layer.attention, layer.attention_ln, layer.mlp_ln
        seg = mask.to(torch.int32)
        valid = seg > 0
        Bk, Lk, Hk = h0.shape
        nh, hd, I_ = encoder.cfg.num_heads, encoder.cfg.head_dim, encoder.cfg.intermediate_size
        call = lambda fn: fn(h0, seg, att.qkv.kernel, att.qkv.bias, att.out.kernel,
                             att.out.bias, sm_scale=hd**-0.5, ln_scale=ln1.scale,
                             ln_bias=ln1.bias, eps=encoder.cfg.layer_norm_eps)
        row = compare("fused_attention_block", "float32", lambda: call(fused_attention_block),
                      lambda: call(attention_block_plain), valid)
        M, HN = Bk * Lk, nh * hd
        moved = nbytes(h0, seg, att.qkv.kernel, att.qkv.bias, att.out.kernel, att.out.bias,
                       ln1.scale, ln1.bias, h0)
        row.update(split_bound(4 * Bk * nh * Lk * Lk * hd, 2 * M * Hk * 3 * HN + 2 * M * HN * Hk,
                               moved, "float32"))
        x2, c2 = h0.reshape(M, Hk), torch.randn(M, HN, device=device)
        wq, wo = att.qkv.kernel.reshape(Hk, 3 * HN), att.out.kernel.reshape(HN, Hk)
        row["library_ms"] = library_time(lambda: (x2 @ wq, c2 @ wo),
                                         "fused_attention_block float32 at 32 x 128")
        kernel_rows["fused_attention_block"] = row
        h1 = call(fused_attention_block).reshape(M, Hk)
        mlp = lambda fn, **kw: fn(h1, layer.mlp_in.kernel, layer.mlp_in.bias,
                                  layer.mlp_out.kernel, layer.mlp_out.bias, mlp_ln.scale,
                                  mlp_ln.bias, activation=encoder.cfg.hidden_act,
                                  eps=encoder.cfg.layer_norm_eps, **kw)
        row = compare("fused_mlp_block", "float32", lambda: mlp(fused_mlp_block, quantized=False),
                      lambda: mlp(mlp_block_plain), slice(None))
        moved = nbytes(h1, layer.mlp_in.kernel, layer.mlp_in.bias, layer.mlp_out.kernel,
                       layer.mlp_out.bias, mlp_ln.scale, mlp_ln.bias, h1)
        row.update(split_bound(0, 4 * M * Hk * I_, moved, "float32"))
        hi = torch.randn(M, I_, device=device)
        row["library_ms"] = library_time(lambda: (h1 @ layer.mlp_in.kernel,
                                                  hi @ layer.mlp_out.kernel),
                                         "fused_mlp_block float32 at 32 x 128")
        kernel_rows["fused_mlp_block"] = row
    return {"launches": hf["launches"], "batches": hf_batches, "sentences_per_s": rate,
            "run_s": hf["run_s"], "peak_gib": hf["peak_gib"], "results": hf["results"],
            "probe": probe_row, "pooler_reading": readings[worst], "diag_err": diag_err,
            "kernels_32x128": kernel_rows}


def sld_examples(cfg, n: int, rng, speech=SLD_SPEECH, text=(20, 256)) -> list:
    """``n`` packed SLD examples: random speech codes (``speech`` tokens) and
    text ids (``text`` tokens)."""
    from spokennlp_tpu_torch.projects.sld import pack_example

    return [pack_example(rng.integers(0, cfg.vocab_size_speech, size=int(rng.integers(*speech))),
                         rng.integers(0, cfg.gpt_vocab_size - 1, size=int(rng.integers(*text))),
                         cfg) for _ in range(n)]


def stack_examples(examples, device) -> dict:
    import torch

    return {k: torch.from_numpy(np.stack([e[k] for e in examples])).to(device)
            for k in ("input_ids", "attention_mask", "labels")}


SLD_FAULTS = ("KL over every element, not batchmean", "target index not clamped at 0")


def sld_loss_float64(logits, labels, mask, cfg, fault=None) -> dict:
    """The reference composite loss (run_clm.py:787-831) in float64 on the
    same logits: {"loss", "ce_speech", "ce_text", "kl_speech"}; ``fault``
    one of SLD_FAULTS."""
    import torch
    import torch.nn.functional as F

    x = logits.double()
    B, Vs, T, eps = x.shape[0], cfg.vocab_size_speech, cfg.kl_temperature, 1e-9
    m = mask.double()
    sl = x[:, :-1, -Vs:] * m[:, :-1, None] + eps
    tgt = (labels[:, 1:].long() - cfg.gpt_vocab_size - 2) * mask[:, 1:].long()
    if fault != SLD_FAULTS[1]:
        tgt = tgt.clamp_min(0)
    one_hot = (tgt[..., None] == torch.arange(Vs, device=x.device)).double()
    sm = (one_hot * (1 - cfg.label_smoothing_eps) + cfg.label_smoothing_eps / Vs) * m[:, 1:, None]
    q = F.softmax((sm + eps) / T, -1)
    kl = (q * (torch.log(q) - F.log_softmax(sl / T, -1))).sum()
    kl = kl / (q.numel() if fault == SLD_FAULTS[0] else B) * T**2
    lp = F.log_softmax(x[:, :-1], -1)
    lab = labels[:, 1:].long()
    picked = lp.gather(-1, lab.clamp_min(0)[..., None])[..., 0]
    del lp

    def ce(valid):
        return -(picked * valid).sum() / valid.sum()

    text = (lab != -100) & (lab < cfg.gpt_vocab_size + 1)
    speech = (lab != -100) & (lab >= cfg.gpt_vocab_size + 1)
    parts = {"ce_speech": ce(speech), "ce_text": ce(text), "kl_speech": kl}
    parts["loss"] = (cfg.weight_ce_speech * parts["ce_speech"]
                     + cfg.weight_ce_text * parts["ce_text"] + cfg.weight_kl_speech * kl)
    return {k: v.item() for k, v in parts.items()}


def write_sld_corpus(root: Path, n_train: int, n_eval: int, speech=(600, 700)) -> dict:
    """run_sld's JSONL rows ({"speech_tokens", "text"}) from a 300-word
    vocabulary: 5-40 words of text, ``speech`` codes below 2000."""
    rng = np.random.default_rng(43)
    words = [f"w{i}" for i in range(300)]
    out = {}
    for name, n in (("train", n_train), ("eval", n_eval)):
        path = root / f"sld_{name}.jsonl"
        with open(path, "w") as f:
            for _ in range(n):
                codes = rng.integers(0, 2000, size=int(rng.integers(*speech))).tolist()
                text = " ".join(rng.choice(words, size=int(rng.integers(5, 41))))
                f.write(json.dumps({"speech_tokens": codes, "text": text}) + "\n")
        out[name] = path
    return out


def sld_path(root: Path, device="cuda", gpt_widths=None, sld_kw=None, cli_widths=()) -> dict:
    """Phase 31: SLD at GPT-2-small width. The library: SLDConfig's defaults
    (V = 52,259, blocks of 1024), GPT2LMModel at random (seed 40), AdamW at
    SLD_LR (decay 1e-4), SLD_STEPS steps at batch SLD_B in float32 with time
    masking and dropout: finite losses, the last below the first, sequences
    trained/s and the peak; the SLD loss on one batch's logits against
    float64 within SLD_LOSS_RTOL (SLD_FAULTS planted in the float64 formula
    must fail); one decode eval of SLD_B prompts (greedy, then SLD_BEAMS
    beams) to WER/CER, decoded tokens/s; the first SLD_CHECK_STEPS KV-cache
    greedy steps against a full forward's argmax, and one beam against
    greedy, token for token. The CLI: run_sld at its defaults on a
    300-word corpus for one epoch. No kernel runs here: the JAX model runs
    no TPU kernel."""
    import torch

    from spokennlp_tpu_torch.cli import run_sld
    from spokennlp_tpu_torch.models import generation as gen
    from spokennlp_tpu_torch.models.gpt2 import GPT2Config, GPT2LMModel
    from spokennlp_tpu_torch.projects import sld

    cfg = sld.SLDConfig(**(sld_kw or {}))
    gcfg = GPT2Config(vocab_size=cfg.total_vocab, **(gpt_widths or {}))
    with torch.device(device):
        model = GPT2LMModel(gcfg, generator=torch.Generator(device=device).manual_seed(40))
    optimizer = torch.optim.AdamW(model.parameters(), lr=SLD_LR, weight_decay=1e-4)
    step = sld.make_sld_train_step(model, cfg, optimizer,
                                   torch.Generator(device=device).manual_seed(41))
    rng = np.random.default_rng(42)
    # 400-700 speech tokens at the default blocks of 1024 (a quarter to a
    # half of a rehearsal's shorter blocks)
    speech = SLD_SPEECH if cfg.block_size >= 1024 else (cfg.block_size // 4, cfg.block_size // 2)
    train = sld_examples(cfg, SLD_B * SLD_STEPS, rng, speech, (20, cfg.max_text_length))
    losses, step_s = [], []
    reset_peak()
    for s in range(SLD_STEPS):
        batch = stack_examples(train[s * SLD_B:(s + 1) * SLD_B], device)
        t0 = synced(device)
        losses.append(float(step(batch)["loss"]))
        step_s.append(synced(device) - t0)
    peak = peak_gib()
    rate = steady_rate(step_s, SLD_B)
    print(f"SLD (GPT-2 {gcfg.num_layers} x {gcfg.hidden_size}, V={gcfg.vocab_size}, blocks of "
          f"{cfg.block_size}, batch {SLD_B}, float32, AdamW lr {SLD_LR}): losses {losses}, "
          f"{rate:.2f} sequences trained/s (host clock after a synchronise, the first step left "
          f"out), peak {peak:.2f} GiB")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"SLD: the loss over {SLD_STEPS} steps reads {losses}: not finite and falling")

    model.eval()
    with torch.no_grad():
        logits = model(batch["input_ids"], attention_mask=batch["attention_mask"])["logits"]
        loss, parts = sld.sld_loss(logits, batch["labels"], batch["attention_mask"], cfg)
    got = {"loss": loss.item(), **{k: v.item() for k, v in parts.items()}}
    want = sld_loss_float64(logits, batch["labels"], batch["attention_mask"], cfg)
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    planted = {f: abs(got["loss"] - w["loss"]) / abs(w["loss"]) for f, w in (
        (f, sld_loss_float64(logits, batch["labels"], batch["attention_mask"], cfg, f))
        for f in SLD_FAULTS)}
    del logits
    print(f"  SLD loss in float32 against float64 on one batch's logits: {got}, relative "
          f"{ {k: f'{v:.1e}' for k, v in rel.items()} } (limits {SLD_LOSS_RTOL}); planted, the "
          f"total's: { {f: f'{v:.1e}' for f, v in planted.items()} }")
    if any(rel[k] > SLD_LOSS_RTOL[k] for k in rel):
        fail(f"SLD loss against float64: {rel}")
    if min(planted.values()) <= SLD_LOSS_RTOL["loss"]:
        fail(f"the SLD loss check accepts a planted fault: {planted}")

    evals = sld_examples(cfg, SLD_B, np.random.default_rng(44), speech, (5, 40))
    texts = [" ".join(str(int(t)) for t in sld.extract_text_tokens(e["labels"][None], cfg)[0])
             for e in evals]
    detok = lambda ids: " ".join(str(int(t)) for t in ids)
    trainer = sld.SLDTrainer(model, cfg, optimizer, train, evals, texts, detok,
                             batch_size=SLD_B, num_epochs=0)
    calls = []
    hook = model.register_forward_pre_hook(lambda *a: calls.append(1))
    decode = {}
    for beams, name in ((1, "greedy_generate"), (SLD_BEAMS, "beam_generate")):
        trainer.num_beams = beams
        times, calls[:] = [], []
        with wrapped(gen, name, timed_calls(device, times)):
            metrics = trainer.decode_eval()
        steps = len(calls) - len(times)  # one prefill a call
        decode[name] = {**metrics, "decode_steps": steps, "seconds": sum(times),
                        "tokens_per_s": SLD_B * steps / sum(times)}
    hook.remove()
    print(f"  SLD decode eval of {SLD_B} prompts ({trainer._prompt_ids.shape[1]} tokens, left "
          f"padded) to {trainer.decode_max_len}: {decode} (WER and CER of random weights: "
          f"meaningless, the decode's own output only)")

    ids = torch.from_numpy(trainer._prompt_ids).to(device)
    mask = torch.from_numpy(trainer._prompt_mask).to(device)
    P = ids.shape[1]
    eos = cfg.text_end_id
    out = gen.greedy_generate(model, ids, mask, P + SLD_CHECK_STEPS, eos)
    beam1 = gen.beam_generate(model, ids, mask, P + SLD_CHECK_STEPS, eos, num_beams=1)
    mismatch, near = 0, 0
    with torch.no_grad():
        for t in range(P, P + SLD_CHECK_STEPS):
            am = torch.cat([mask, torch.ones((SLD_B, t - P), dtype=mask.dtype, device=device)], 1)
            full = model(out[:, :t], attention_mask=am,
                         position_ids=gen._prompt_position_ids(am))["logits"][:, -1]
            top2 = full.topk(2, -1).values
            going = ~(out[:, P:t] == eos).any(1)  # a finished row repeats EOS
            differ = going & (torch.argmax(full, -1).to(out.dtype) != out[:, t])
            mismatch += int(differ.sum())
            near += int((differ & (top2[:, 0] - top2[:, 1] < 1e-4)).sum())
    same_beam = bool((beam1 == out).all())
    print(f"  SLD KV-cache greedy against a full forward's argmax over {SLD_CHECK_STEPS} steps x "
          f"{SLD_B} rows: {mismatch} differ ({near} of them at a top-2 gap below 1e-4); one beam "
          f"equals greedy: {same_beam}")
    # one decode step (slot P of the cache): host clock against device time
    with torch.no_grad():
        cache, am_full, _ = gen._prefill(model, ids, mask, P + 1)
        am_full[:, P] = 1
        n_real = mask.long().sum(1)[:, None]
        one = lambda: model(out[:, P:P + 1], am_full, n_real, cache, P)
        decode_step = {"host_ms": host_ms(lambda: (one(), synced(device)), 10)}
        if device == "cuda":
            decode_step["device_ms"] = kernel_device_ms(one, reps=10)
    print(f"  SLD decode step at B={SLD_B} over {P + 1} cache slots: {decode_step}")
    if mismatch != near or near > 1 or not same_beam:
        fail(f"SLD decode: {mismatch} tokens differ from the full forward ({near} near ties), "
             f"beam 1 == greedy: {same_beam}")
    del trainer, model, optimizer, out, beam1, cache
    if device == "cuda":
        torch.cuda.empty_cache()

    corpus = write_sld_corpus(root, 2 * SLD_B, 4)
    argv = ["--train_file", str(corpus["train"]), "--eval_file", str(corpus["eval"]),
            "--output_dir", str(root / "sld_out"), "--num_train_epochs", "1", "--device", device,
            *cli_widths]
    cli_s = []

    def make_step(real):
        def build(*a, **kw):
            return timed_calls(device, cli_s)(real(*a, **kw))
        return build

    reset_peak()
    t0 = time.perf_counter()
    with wrapped(sld, "make_sld_train_step", make_step):
        res = run_sld.main(argv)
    cli = {"run_s": time.perf_counter() - t0, "steps": len(cli_s), "peak_gib": peak_gib(),
           "history": res["history"], "sequences_per_s": steady_rate(cli_s, SLD_B)}
    print(f"  run_sld at its defaults (GPT-2 small, blocks of 1024, batch 8, one epoch of "
          f"{2 * SLD_B} rows, greedy eval of 4): {cli}")
    if cli["steps"] != 2 or not all(math.isfinite(h["train_loss"]) for h in res["history"]):
        fail(f"run_sld: {cli}")
    if not (root / "sld_out" / "sld_results.json").exists():
        fail("run_sld wrote no sld_results.json")
    return {"losses": losses, "sequences_per_s": rate, "step_s": step_s, "peak_gib": peak,
            "loss_rel": rel, "decode": decode, "decode_step": decode_step,
            "kv_mismatch": mismatch, "cli": cli}


def write_waves(root: Path, n: int, seconds=SLD_WAVE_S, seed: int = 51):
    """``n`` 16 kHz 16-bit waves of ``seconds`` (a range) under
    ``root/audio`` and their transcripts: tones and noise in 0.5 s
    segments, 3-12 words each."""
    import wave as wavemod

    rng = np.random.default_rng(seed)
    audio = root / "audio"
    audio.mkdir()
    words = [f"w{i}" for i in range(50)]
    lines = []
    for i in range(n):
        n_samples = int(rng.uniform(*seconds) * 16000)
        t = np.arange(n_samples) / 16000
        f0 = np.repeat(rng.uniform(100, 1000, size=n_samples // 8000 + 1), 8000)[:n_samples]
        wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.normal(size=n_samples)
        with wavemod.open(str(audio / f"utt{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())
        lines.append(f"utt{i}\t" + " ".join(rng.choice(words, size=int(rng.integers(3, 13)))))
    (root / "trans.tsv").write_text("\n".join(lines) + "\n")
    return audio, root / "trans.tsv"


def wavlm_hf_dir(root: Path, device="cuda", widths=None) -> Path:
    """WavLM-Large (or ``widths``) at random (seed 50), written as an HF
    directory (config.json, model.safetensors) without transformers."""
    import torch

    from spokennlp_tpu_torch.cli.hf_checkpoint import write_safetensors
    from spokennlp_tpu_torch.models import checkpoint_io
    from spokennlp_tpu_torch.models.wavlm import (
        _HF_KEYS, WavLMConfig, WavLMModel, params_to_hf_wavlm,
    )

    cfg = WavLMConfig(**(widths or WAVLM_LARGE))
    with torch.device(device):
        model = WavLMModel(cfg, generator=torch.Generator(device=device).manual_seed(50))
    params = checkpoint_io.params_from_state_dict(model.state_dict())
    del model
    out = root / "wavlm_large"
    out.mkdir()
    hf_cfg = {"model_type": "wavlm", "architectures": ["WavLMModel"],
              **{hf: getattr(cfg, field) for field, hf in _HF_KEYS.items()}}
    (out / "config.json").write_text(json.dumps(hf_cfg, indent=2))
    write_safetensors(str(out / "model.safetensors"),
                      {k: torch.from_numpy(v) for k, v in params_to_hf_wavlm(params, cfg).items()})
    return out


def wavlm_path(root: Path, device="cuda", widths=None, seconds=SLD_WAVE_S,
               layer: int = SLD_LAYER, train_args=None) -> dict:
    """Phase 32: run_sld_pipeline over SLD_WAVES synthetic 16 kHz waves of
    5-20 s at speeds 0.9/1.0/1.1 with WavLM-Large written at random as an HF
    directory: stages 1-2 (manifests, layer-23 features on the card), the
    k-means centres drawn from the speed-1.0 training features (sklearn, and
    so stage 3's MiniBatchKMeans, is not on the card's machine), then stages
    4-7 (tokens, joined files, BPE, run_sld for one epoch at a small width).
    Seconds of audio a second for stage 2; the layer-23 features of one 2 s
    wave against the same model on the CPU in float32 within F32_FWD_TOL
    (layer 22's planted must fail)."""
    import torch

    from spokennlp_tpu_torch.cli import run_sld_pipeline
    from spokennlp_tpu_torch.projects import sld_pipeline as pipe

    hf_dir = wavlm_hf_dir(root, device, widths)
    audio, trans = write_waves(root, SLD_WAVES, seconds)
    seed = next(s for s in range(100) if 1 <= len(pipe.make_manifest(
        str(audio), ext="wav", valid_percent=0.25, seed=s)["valid"]) - 1 <= 2)
    work = root / "sld_work"
    common = ["--audio_dir", str(audio), "--transcript_file", str(trans), "--work_dir", str(work),
              "--model_name", str(hf_dir), "--layer", str(layer), "--speeds",
              *map(str, SLD_SPEEDS), "--valid_percent", "0.25", "--seed", str(seed),
              "--device", device]
    feat_s, samples = [], []

    def make(real):
        def extract(model, waves, *a, **kw):
            samples.append(waves.shape[1])
            return timed_calls(device, feat_s)(real)(model, waves, *a, **kw)
        return extract

    reset_peak()
    t0 = time.perf_counter()
    with wrapped(pipe, "extract_wavlm_features", make):
        run_sld_pipeline.main(common + ["--stop_stage", "2"])
    stage2_s, peak = time.perf_counter() - t0, peak_gib()
    rate = sum(samples[1:]) / 16000 / sum(feat_s[1:])
    feats = np.load(work / "feats" / f"train_sp1.0_0_1.npy")
    centres = feats[np.random.default_rng(52).choice(len(feats), size=100, replace=False)]
    np.save(work / "kmeans_centers.npy", centres)
    args = {"num_train_epochs": 1, "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 2, "vocab_size_speech": 100, **(train_args or {})}
    t0 = time.perf_counter()
    state = run_sld_pipeline.main(common + ["--start_stage", "4", "--train_args",
                                            json.dumps(args)])
    rest_s = time.perf_counter() - t0
    hist = state["train_result"]["history"]
    print(f"WavLM (stage 2 of run_sld_pipeline: {len(samples)} utterances, "
          f"{sum(samples) / 16000:.1f} s of audio at speeds {SLD_SPEEDS}, layer {layer}, "
          f"float32): {stage2_s:.1f} s for stages 1-2, {rate:.1f} s of audio a second (stage-2 "
          f"calls after the first), peak {peak:.2f} GiB; stages 4-7 {rest_s:.1f} s, "
          f"{len(state['bpe_merges'])} BPE merges, run_sld {hist}")
    if not all(math.isfinite(h["train_loss"]) for h in hist) or not state["bpe_merges"]:
        fail(f"SLD pipeline: {hist}, {len(state['bpe_merges'])} merges")

    cpu_model = pipe.load_feature_model(str(hf_dir), "cpu")
    card_model = pipe.load_feature_model(str(hf_dir), device)
    wave = pipe.read_wav(str(audio / "utt0.wav"))[None, :32000]
    got = pipe.extract_wavlm_features(card_model, wave, layer)
    want = pipe.extract_wavlm_features(cpu_model, wave, layer)
    bad = pipe.extract_wavlm_features(cpu_model, wave, layer - 1)
    reading = f32_gemm_readings({"features": torch.from_numpy(got)},
                                {"features": torch.from_numpy(want)})["features"]
    planted = f32_gemm_readings({"features": torch.from_numpy(got)},
                                {"features": torch.from_numpy(bad)})["features"]
    print(f"  WavLM layer-{layer} features of a 2 s wave, {device} against the CPU (float32): max "
          f"{reading[0]:.2e}, norm {reading[1]:.2e} (limits {F32_FWD_TOL}); planted layer "
          f"{layer - 1}: {planted[0]:.2e}, {planted[1]:.2e}")
    if f32_gemm_excess(reading, F32_FWD_TOL) > 1 or f32_gemm_excess(planted, F32_FWD_TOL) <= 1:
        fail(f"WavLM features against the CPU: {reading} (planted {planted})")
    # one utterance of the stage (the first wave at speed 1.0): host clock
    # against device time, and the host's relative-position table alone
    from spokennlp_tpu_torch.models.wavlm import relative_position_buckets

    wave = pipe.read_wav(str(audio / "utt0.wav"))[None, :]
    call = lambda: pipe.extract_wavlm_features(card_model, wave, layer)
    frames = call().shape[1]
    split = {"audio_s": wave.shape[1] / 16000, "frames": frames,
             "host_ms": host_ms(lambda: (call(), synced(device)), 3),
             "bucket_table_ms": host_ms(lambda: relative_position_buckets.__wrapped__(
                 frames, card_model.cfg.num_buckets, card_model.cfg.max_bucket_distance), 3)}
    if device == "cuda":
        split["device_ms"] = kernel_device_ms(call, reps=3)
    print(f"  WavLM one utterance: {split}")
    del cpu_model, card_model
    return {"utterances": len(samples), "audio_s": sum(samples) / 16000,
            "audio_s_per_s": rate, "stage2_s": stage2_s, "rest_s": rest_s, "peak_gib": peak,
            "history": hist, "reading": reading, "utterance": split}


# MMVTS (phases 33-35): the reference's fusion widths (mm_hidden_size = the
# text width, scripts/parity_mmvts.py:156; CLIP ViT-B/16's 512-wide frame
# features; Whisper-small's 768-wide audio), the composite objective, and
# corpora cut to 4-6 micro-batches of 2 windows and a few eval batches
MM_FLAGS = ["--mm_hidden_size", "768", "--vis_hidden_size", "512", "--audio_hidden_size", "768",
            "--do_modality_cl", "--align_pairs", "tv,av,at", "--do_topic_mm_cl",
            "--topic_cl_type", "list", "--topic_cl_choice", "near"]
MM_TRUNKS = {
    # phase 33: BERT-base over 512 tokens, ma_moe with the capacity dispatch
    "dense": dict(flags=["--cross_encoder_type", "ma_moe", "--moe_impl", "dispatch"],
                  train=(6, (30, 50)), eval=(5, (30, 50)), words=(6, 16)),
    # phase 34: Longformer-base over 2048 tokens, ca, the transformer
    # projector and the hybrid predictor with per-clip gates
    "sliding_window": dict(flags=["--attention_type", "sliding_window", "--attention_window",
                                  "512", "--max_seq_length", "2048", "--cross_encoder_type", "ca",
                                  "--projector_type", "transformer", "--predictor_type", "hybrid",
                                  "--predictor_hybrid_weight_type", "l"],
                           train=(5, (80, 100)), eval=(3, (70, 90)), words=(20, 36)),
}
MM_STEPS = (4, 6)
CLIP_FRAMES, CLIP_CPU_CLIPS = 320, 3  # ViT-B/16 frames in uneven clips; clips checked on the CPU


def write_video_corpus(root: Path, trunk: str, seed: int = 33) -> tuple:
    """A clvts corpus (train, dev and test jsonl: clips of random words,
    about one in eight closing a topic, cumulative clip end seconds) and a
    vis (512) and an audio (768) feature .npy a video: (corpus, vis, audio)
    directories."""
    rng = np.random.default_rng(seed)
    spec = MM_TRUNKS[trunk]
    base = root / f"mmvts_{trunk}"
    dirs = [base / d for d in ("clvts", "vis", "audio")]
    for d in dirs:
        d.mkdir(parents=True)
    words = [f"w{i}" for i in range(3000)]
    for split, (videos, clips) in (("train", spec["train"]), ("dev", spec["eval"]),
                                   ("test", (1, spec["eval"][1]))):
        with open(dirs[0] / f"{split}.jsonl", "w") as f:
            for v in range(videos):
                n = int(rng.integers(*clips))
                labels = (rng.random(n) < 0.125).astype(int).tolist()
                labels[-1] = 1
                vid = f"{split}{v}"
                f.write(json.dumps({
                    "example_id": vid, "lecture": vid, "labels": labels,
                    "text": [" ".join(rng.choice(words, size=int(rng.integers(*spec["words"]))))
                             for _ in range(n)],
                    "clip_end_seconds": np.cumsum(rng.uniform(4, 20, n)).round(2).tolist()}) + "\n")
                for d, width in ((dirs[1], 512), (dirs[2], 768)):
                    np.save(d / f"{vid}.npy", rng.normal(size=(n, width)).astype(np.float32))
    return tuple(str(d) for d in dirs)


def mmvts_wrappers(trunk: str) -> tuple:
    """({name: wrapper} of the training kernels, of the eval kernels) of a
    trunk's path under auto: rows 10 and 11 and kernel 3 (batch 2), or rows
    12 and 11 and kernels 7 and 2."""
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.sliding_block import fused_sliding_attention_block
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    mlp = {"mlp_train_fwd": tb.mlp_train_fwd, "mlp_train_bwd": tb.mlp_train_bwd}
    if trunk == "dense":
        return ({"attention_train_fwd": tb.attention_train_fwd,
                 "attention_train_bwd": tb.attention_train_bwd, **mlp},
                {"fused_encoder_stack": fused_encoder_stack})
    return ({"sliding_train_fwd": ts.sliding_train_fwd,
             "sliding_train_bwd": ts.sliding_train_bwd, **mlp},
            {"sliding_attention_block": fused_sliding_attention_block,
             "fused_mlp_block": fused_mlp_block})


def moe_share(model, batch, loss_of, device) -> dict:
    """The capacity-dispatch MoE's share of one training step: the step
    (forward, loss, backward; CUDA events, a mean of 5 after a warm-up)
    against each MoE layer's own forward and backward on the inputs it took
    in that step."""
    import torch

    from spokennlp_tpu_torch.models import multimodal as mm

    taken = []

    def make(real):
        def forward(self, x, mask, *a, **kw):
            taken.append((self, x.detach(), mask))
            return real(self, x, mask, *a, **kw)
        return forward

    step = lambda: torch.autograd.grad(loss_of(model), list(model.parameters()),
                                       allow_unused=True)
    with wrapped(mm.MoELayer, "forward", make):
        step()
    moe_calls = list(taken)

    def moe_alone():
        for layer, x, mask in moe_calls:
            xg = x.clone().requires_grad_()
            y, aux = layer(xg, mask)
            torch.autograd.grad((y.float().sum() + aux), [xg, *layer.parameters()])

    moe_alone()  # a warm-up; the step had its own above
    timer = time_ms if torch.device(device).type == "cuda" else host_ms
    return {"moe_layers": len(moe_calls), "moe_ms": timer(moe_alone, 5),
            "step_ms": timer(step, 5)}


def mmvts_path(root: Path, trunk: str = "dense", device="cuda", widths=(),
               pretrain: bool = True) -> dict:
    """Phases 33 (``trunk`` "dense") and 34 ("sliding_window"):
    run_finetune_multimodal at its defaults (float32, batch 2, 4
    accumulation steps) with the reference's fusion widths (MM_FLAGS) over a
    synthetic clvts corpus with vis and audio feature files, for one epoch
    of 4-6 micro-batches, then eval (and, for the dense trunk, one
    --do_pretrain run). The trunk's training kernels once a layer a
    micro-batch and its eval kernels once a layer (kernel 3: once) an eval
    batch; finite losses; windows trained/s (host clock after a
    synchronise, the first call and the first optimizer update left out)
    and evaluated/s (the first call left out), peak memory, the MoE's
    share of a step (phase 33); one batch's loss and every weight matrix's
    gradient against the einsum path at dropout 0 (LOSS_RTOL,
    MIN_GRAD_COSINE); the trained model's eval argmax on valid clips against
    its einsum twin (tanh GELU) >= MIN_ARGMAX_AGREEMENT."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import run_finetune_multimodal as cli
    from spokennlp_tpu_torch.objectives import mmvts_losses
    from spokennlp_tpu_torch.projects import mmvts

    data, vis, audio = write_video_corpus(root, trunk)
    spec = MM_TRUNKS[trunk]
    out = root / f"mmvts_{trunk}_out"
    argv = ["--dataset_name", "clvts", "--data_dir", data, "--vis_feature_dir", vis,
            "--audio_feature_dir", audio, "--output_dir", str(out), "--do_train", "--do_eval",
            "--num_train_epochs", "1", *MM_FLAGS, *spec["flags"], "--device", device, *widths]
    args = cli.make_parser().parse_args(argv)
    train_k, eval_k = mmvts_wrappers(trunk)
    step_s, fwd, updates, captured = [], [], [], {}

    def make_step(real):
        def build_step(model, optimizer, *a, **kw):
            captured["model"] = model
            real_update = optimizer.step

            def update(*ua, **ukw):  # TrainOptimizer says whether it stepped
                out = real_update(*ua, **ukw)
                updates.append(out is not False)
                return out

            optimizer.step = update

            def forward(*fa, _real=model.forward, **fkw):
                t0 = synced(device)
                res = _real(*fa, **fkw)
                fwd.append((model.training, synced(device) - t0))
                return res

            model.forward = forward
            return timed_calls(device, step_s)(real(model, optimizer, *a, **kw))
        return build_step

    reset_counts({**train_k, **eval_k})
    reset_peak()
    t0 = time.perf_counter()
    with wrapped(mmvts, "make_mmvts_train_step", make_step):
        res = cli.main(argv)
    secs, peak = time.perf_counter() - t0, peak_gib()
    launches = read_counts({**train_k, **eval_k})
    model = captured.pop("model")
    del model.forward
    eval_s = [s for training, s in fwd if not training]
    steps, layers = len(step_s), model.enc_cfg.num_layers
    expected = {**{n: layers * steps for n in train_k},
                **{n: len(eval_s) * (1 if n == "fused_encoder_stack" else layers)
                   for n in eval_k}}
    hist = res["history"]
    print(f"MMVTS {trunk} (run_finetune_multimodal: L={args.max_seq_length}, batch "
          f"{args.per_device_train_batch_size}, {args.gradient_accumulation_steps} accumulation "
          f"steps, float32, {args.cross_encoder_type}, {args.projector_type} projector, "
          f"{args.predictor_type} predictor, {args.max_clips_per_window} clips a window): "
          f"{steps} micro-batches and {len(eval_s)} eval batches in {secs:.1f} s, peak "
          f"{peak:.2f} GiB, launches {launches}, history {hist}, eval {res.get('eval')}")
    if not MM_STEPS[0] <= steps <= MM_STEPS[1] or not eval_s:
        fail(f"MMVTS {trunk}: {steps} micro-batches (expected {MM_STEPS}), {len(eval_s)} eval "
             "batches")
    if device == "cuda" and launches != expected:
        fail(f"MMVTS {trunk}: launches {launches}, expected {expected}")
    if not all(math.isfinite(v) for h in hist for v in h.values() if v is not None):
        fail(f"MMVTS {trunk}: non-finite loss in {hist}")
    if not all(math.isfinite(v) for v in res["eval"].values()):
        fail(f"MMVTS {trunk}: eval {res['eval']}")
    bs = args.per_device_train_batch_size
    # the steady rate leaves out the first call (the card's warm-up) and the
    # first optimizer update (AdamW allocates its state), printed apart
    first = updates.index(True)
    steady = [t for i, t in enumerate(step_s) if i not in (0, first)]
    row = {"launches": launches, "steps": steps, "eval_batches": len(eval_s), "run_s": secs,
           "peak_gib": peak, "history": hist, "eval": res["eval"],
           "windows_trained_per_s": bs * len(steady) / sum(steady),
           "step_ms": [t * 1e3 for t in step_s], "first_update_step": first,
           "windows_evaluated_per_s": steady_rate(eval_s, bs)}

    # one training batch at dropout 0, the CLI's loss (list indices from one
    # seed), against the einsum path
    windows = featurized_windows(args, data, vis, audio)
    keys = ("input_ids", "attention_mask", "clip_positions", "clip_mask", "clip_labels",
            "vis_feats", "audio_feats")
    stack = lambda ws: {k: torch.from_numpy(np.stack([w[k] for w in ws])).to(device)
                        for k in keys}
    batch = stack(windows["train"][:bs])
    idx = mmvts_losses.build_topic_cl_list_indices(
        batch["clip_labels"].cpu().numpy(), batch["clip_mask"].cpu().numpy(),
        args.topic_cl_pos_k, args.topic_cl_neg_k, args.topic_cl_choice,
        np.random.default_rng(0))
    idx = {k: torch.from_numpy(v).to(device) for k, v in idx.items()}
    loss_kw = dict(weight_label_zero=args.weight_label_zero_mm, do_modality_cl=True,
                   align_pairs=cli.parse_align_pairs(args.align_pairs), cl_temp=args.cl_temp,
                   do_topic_mm_cl=True, topic_cl_type="list", topic_cl_indices=idx)

    def loss_of(m):
        o = m(batch["input_ids"], batch["attention_mask"], batch["clip_positions"],
              batch["clip_mask"], vis_feats=batch["vis_feats"], audio_feats=batch["audio_feats"])
        return mmvts_losses.mmvts_total_loss(m.mm_cfg, o, batch["clip_labels"],
                                             batch["clip_mask"], **loss_kw)[0]

    enc0 = dataclasses.replace(model.enc_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    mm0 = dataclasses.replace(model.mm_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    build = lambda impl, gen: mmvts.MMVTSModel(dataclasses.replace(enc0, attention_impl=impl),
                                               mm0, generator=gen)
    row.update(gradient_check(f"MMVTS {trunk}", build, loss_of, device))
    if model.mm_cfg.moe_impl == "dispatch" and "moe" in model.mm_cfg.cross_encoder_type:
        with torch.device(device):
            m0 = build("auto", torch.Generator(device=device).manual_seed(1)).train()
        share = moe_share(m0, batch, loss_of, device)
        share["share"] = share["moe_ms"] / share["step_ms"]
        print(f"  MMVTS {trunk}: the capacity-dispatch MoE ({share['moe_layers']} layers, "
              f"forward and backward alone) {share['moe_ms']:.3f} ms of a {share['step_ms']:.3f} "
              f"ms step at B={bs}: {share['share']:.1%}")
        row["moe"] = share
        del m0

    twin = einsum_twin(model, mmvts.MMVTSModel, model.mm_cfg)
    model.eval()
    got, want = [], []
    with torch.no_grad():
        for s in range(0, len(windows["validation"]), bs):
            b = stack(windows["validation"][s:s + bs])
            a = (b["input_ids"], b["attention_mask"], b["clip_positions"], b["clip_mask"])
            kw = dict(vis_feats=b["vis_feats"], audio_feats=b["audio_feats"])
            valid = b["clip_mask"].bool()
            got.append(model(*a, **kw)["logits"].argmax(-1)[valid].cpu())
            want.append(twin(*a, **kw)["logits"].argmax(-1)[valid].cpu())
    agree = float((torch.cat(got) == torch.cat(want)).float().mean())
    print(f"  MMVTS {trunk} eval argmax, kernel path against the einsum path (tanh GELU) on "
          f"{len(torch.cat(got))} clips: {agree:.4f}; {row['windows_trained_per_s']:.2f} windows "
          f"trained/s (micro-batches of {bs}: {[round(t, 1) for t in row['step_ms']]} ms, the "
          f"first optimizer update at {first}), {row['windows_evaluated_per_s']:.2f} evaluated/s")
    if agree < MIN_ARGMAX_AGREEMENT:
        fail(f"MMVTS {trunk}: eval argmax agreement {agree:.4f} < {MIN_ARGMAX_AGREEMENT}")
    row["agreement"] = agree
    del twin, model

    if pretrain:
        reset_counts(train_k)
        t0 = time.perf_counter()
        pre = cli.main([a for a in argv if a != "--do_eval"] + [
            "--do_pretrain", "--output_dir", str(root / f"mmvts_{trunk}_pretrain")])
        pre_launches = read_counts(train_k)
        print(f"  MMVTS {trunk} --do_pretrain: {time.perf_counter() - t0:.1f} s, launches "
              f"{pre_launches}, {pre['history']}")
        if pre["history"][-1]["ts_loss"] != 0.0 or not math.isfinite(
                pre["history"][-1]["total_loss"]):
            fail(f"MMVTS pretraining: {pre['history']}")
        if device == "cuda" and pre_launches != {n: layers * steps for n in train_k}:
            fail(f"MMVTS pretraining launches {pre_launches}")
        row["pretrain"] = {"launches": pre_launches, "history": pre["history"]}
        for n, c in pre_launches.items():
            row["launches"][n] += c
    return row


def featurized_windows(args, data, vis, audio) -> dict:
    """The CLI's windows of each split (its tokenizer and featurisation,
    here again)."""
    from spokennlp_tpu_torch.cli import common
    from spokennlp_tpu_torch.configs import WindowingConfig
    from spokennlp_tpu_torch.data import corpora
    from spokennlp_tpu_torch.projects.mmvts import featurize_video

    tokenize_fn, special = common.resolve_tokenizer(args)
    wcfg = WindowingConfig(max_seq_length=args.max_seq_length, cls_token_id=special["cls"],
                           pad_token_id=special["pad"], bos_token_id=special["bos"])
    out = {}
    for split, examples in corpora.load_dataset_splits("clvts", data).items():
        rows = []
        lecture = {e["example_id"]: e["lecture"] for e in examples}
        for ex in corpora.tokenize_examples(examples, tokenize_fn):
            feats = {m: np.load(Path(d) / f"{lecture[ex['example_id']]}.npy")
                     for m, d in (("vis", vis), ("audio", audio))}
            rows += featurize_video(ex["sent_token_ids"], [1 if lab == 0 else 0 for lab in
                                                           ex["labels"]], feats, wcfg,
                                    ex["example_id"], args.max_clips_per_window)
        out[split] = rows
    return out


def clip_path(device="cuda", cfg_kw=None, frames: int = CLIP_FRAMES) -> dict:
    """Phase 35: encode_clip_frames with CLIP ViT-B/16 at random (seed 35;
    224 px, patches of 16, 12 layers of 768, a 512-wide projection) over
    ``frames`` random 240 x 320 frames in uneven clips (one without frames):
    frames/s of the call (host preprocessing included; the second call, the
    first warms up) and the tower's time for a batch of 32 (CUDA events);
    the first CLIP_CPU_CLIPS clips' features against the same tower on the
    CPU in float32 within F32_FWD_TOL, where the erf GELU planted in place of
    QuickGELU must fail."""
    import torch
    import torch.nn.functional as F

    from spokennlp_tpu_torch.models import clip_vit

    cfg = clip_vit.CLIPViTConfig(**(cfg_kw or {}))
    with torch.device(device):
        tower = clip_vit.CLIPVisionTower(cfg, generator=torch.Generator(device=device).manual_seed(35))
    rng = np.random.default_rng(35)
    counts = rng.integers(1, 2 * frames // 40, size=40)
    counts = (counts * frames / counts.sum()).astype(int)
    counts[1] = 0
    counts[-1] += frames - counts.sum()
    images = rng.integers(0, 256, size=(frames, 240, 320, 3), dtype=np.uint8)
    clip_vit.encode_clip_frames(tower, images[:64], [64])
    t0 = synced(device)
    feats = clip_vit.encode_clip_frames(tower, images, counts.tolist())
    secs = synced(device) - t0
    pixels = torch.from_numpy(clip_vit.preprocess_images(images[:32], cfg.image_size)).to(device)
    with torch.no_grad():
        tower_ms = (time_ms if torch.device(device).type == "cuda" else host_ms)(
            lambda: tower(pixels), 5)
    n_cpu = int(counts[:CLIP_CPU_CLIPS].sum())
    cpu_tower = clip_vit.CLIPVisionTower(cfg)
    cpu_tower.load_state_dict({k: v.cpu() for k, v in tower.state_dict().items()})
    want = clip_vit.encode_clip_frames(cpu_tower, images[:n_cpu], counts[:CLIP_CPU_CLIPS].tolist())
    with wrapped(clip_vit, "quick_gelu", lambda real: lambda x: F.gelu(x)):
        bad = clip_vit.encode_clip_frames(tower, images[:n_cpu], counts[:CLIP_CPU_CLIPS].tolist())
    T = lambda a: {"features": torch.from_numpy(a)}
    reading = f32_gemm_readings(T(feats[:CLIP_CPU_CLIPS]), T(want))["features"]
    planted = f32_gemm_readings(T(bad), T(want))["features"]
    row = {"frames": frames, "clips": len(counts), "frames_per_s": frames / secs,
           "tower_ms_32": tower_ms, "reading": reading, "planted": planted}
    print(f"CLIP ViT-B/16 (encode_clip_frames, float32, batches of 32): {frames} frames of "
          f"240 x 320 in {len(counts)} clips in {secs:.2f} s, {row['frames_per_s']:.1f} frames/s; "
          f"the tower {tower_ms:.3f} ms a batch of 32; {n_cpu} frames against the CPU: max "
          f"{reading[0]:.2e}, norm {reading[1]:.2e} (limits {F32_FWD_TOL}); planted erf GELU: "
          f"{planted[0]:.2e}, {planted[1]:.2e}")
    if feats.shape != (len(counts), cfg.projection_dim) or feats[1].any():
        fail(f"CLIP features {feats.shape}, the empty clip {np.abs(feats[1]).max()}")
    if f32_gemm_excess(reading, F32_FWD_TOL) > 1 or f32_gemm_excess(planted, F32_FWD_TOL) <= 1:
        fail(f"CLIP features against the CPU: {reading} (planted {planted})")
    del tower, cpu_tower
    return row



# phases 36-39: two ranks on the one card over gloo (NCCL refuses two ranks
# on one GPU; gloo crosses through the host, so the rates are not those of
# two cards), each against one rank at full width on the same global batch
TWO_RANK_SLD = dict(gpt_vocab=50257, speech_vocab=2000, block=1024, text=256, hidden_size=768,
                    num_layers=12, num_heads=12, intermediate_size=3072, rows=8, seed=36,
                    decode=8, decode_new=16, dropout=0.1, time_masking=0.3, rate_steps=1)
# the dense MMVTS trunk at BERT-base, the CLI's defaults (512 tokens, 64
# clips, batch 2, capacity 1.25) and the reference's fusion widths; the
# trunk's probability dropout 0: the training kernels key their masks on the
# rows a rank holds (dist.rank_seed), the einsum path's dropout is drawn over
# the global batch
TWO_RANK_MMVTS = dict(vocab=30522, hidden_size=768, num_layers=12, num_heads=12,
                      intermediate_size=3072, L=512, K=64, mm_hidden=768, vis=512, audio=768,
                      heads=8, mm_inter=1024, experts=4, capacity=1.25, expert_scale=1.0, rows=2,
                      seed=37, impl="auto", dropout=0.1, trunk_attention_dropout=0.0, mp=1,
                      rate_steps=1)
# phase 39: the same fusion widths on the Longformer-base trunk over 2048
# tokens (window 512; rows 12 and 11 in training, kernels 7 and 2 in eval)
TWO_RANK_MMVTS_LF = {**TWO_RANK_MMVTS, "L": 2048, "window": 512, "seed": 39}
TWO_RANK_MIN_COSINE = 0.9999
TWO_RANK_FT = {}  # train_argv's widths for phase 38 (BERT-base: its defaults)


def stack_small_batches(device) -> dict:
    """Kernel 3 (float32, as MMVTS evaluates) over LAYERS layers of BERT-base
    at L=512 and batches of 2 (MMVTS's eval batch) and 1, against the chain
    of kernels 1 and 2 on the same inputs (bit for bit, then both timed in
    turns: CUDA events, a mean of 5 after a warm-up)."""
    import torch

    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    g = torch.Generator(device=device).manual_seed(38)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    HN, NL = NH * HD, LAYERS
    p = [randn(NL, H, 3, NH, HD, scale=H**-0.5), randn(NL, 3, NH, HD, scale=0.02),
         randn(NL, NH, HD, H, scale=HN**-0.5), randn(NL, H, scale=0.02),
         1 + randn(NL, H, scale=0.1), randn(NL, H, scale=0.1), randn(NL, H, I, scale=H**-0.5),
         randn(NL, I, scale=0.02), randn(NL, I, H, scale=I**-0.5), randn(NL, H, scale=0.02),
         1 + randn(NL, H, scale=0.1), randn(NL, H, scale=0.1)]
    out = {}
    for b in (2, 1):
        hidden = randn(b, L, H)
        seg = torch.ones((b, L), dtype=torch.int32, device=device)
        seg[-1, L - 100:] = 0
        kernel = lambda: fused_encoder_stack(hidden, seg, *p, sm_scale=HD**-0.5, quantized=False)

        def chain():
            h = hidden
            for l in range(NL):
                h = fused_attention_block(h, seg, *(t[l] for t in p[:4]), sm_scale=HD**-0.5,
                                          ln_scale=p[4][l], ln_bias=p[5][l], quantized=False)
                h = fused_mlp_block(h.reshape(b * L, H), *(t[l] for t in p[6:]),
                                    activation="gelu", eps=1e-12,
                                    quantized=False).reshape(b, L, H)
            return h

        valid = seg > 0
        if not torch.equal(kernel()[valid], chain()[valid]):
            fail(f"kernel 3 at batch {b}: differs from the chain of kernels 1 and 2")
        times = timed_pair(kernel, chain, reps=5)
        out[b] = {"ms": times["ms"], "chain_ms": times["plain_ms"]}
        print(f"kernel 3 float32, {NL} layers of BERT-base at L={L}, batch {b}: "
              f"{times['ms']:.3f} ms, the chain of kernels 1 and 2 {times['plain_ms']:.3f} ms "
              f"(bit for bit equal)")
    return out


def two_rank_finetune(argv, device, grads_path, rate_steps: int, batch_size: int) -> dict:
    """Phase 38's step: run_finetune's train step (dp_step) on the first
    batch of ``batch_size`` at ``argv``'s widths, the model on the current mesh
    (cli/common.py ``place_on_mesh`` with ``--model_parallel_size``), its
    metrics, the whole gradients (saved to ``grads_path`` by rank 0), the
    updated model's argmax on the batch's labelled tokens (eval: kernel 3 at
    B <= 32), and windows trained/s over ``rate_steps`` more steps."""
    import torch

    from spokennlp_tpu_torch import dryrun
    from spokennlp_tpu_torch.cli import common
    from spokennlp_tpu_torch.cli.run_inference import build_model
    from spokennlp_tpu_torch.configs import TrainConfig
    from spokennlp_tpu_torch.train import optim
    from spokennlp_tpu_torch.train.train_step import make_topic_seg_train_step

    args, enc_cfg, task_cfg, batch = step_inputs(argv, batch_size, device)
    model = common.place_on_mesh(build_model(args, enc_cfg, task_cfg), args.model_parallel_size)
    opt = optim.make_optimizer(model, TrainConfig(gradient_accumulation_steps=1), 10)
    seen, real = {}, opt.step

    def update(grads):
        seen["grads"] = [g.clone() for g in grads]
        return real(grads)

    opt.step = update
    step = make_topic_seg_train_step(model, task_cfg, opt, seed=args.seed)
    metrics = {k: float(v) for k, v in step(batch).items()}
    dryrun._flat_grads(opt.params, seen["grads"], grads_path)
    model.eval()
    with torch.no_grad():
        out = model(batch["input_ids"][:, 0], attention_mask=batch["attention_mask"][:, 0],
                    token_type_ids=batch["token_type_ids"][:, 0])
    live = batch["labels"][:, 0] != -100
    argmax = torch.argmax(out["token_logits"], -1)[live].cpu().tolist()
    return {**metrics, "argmax": argmax,
            "rows_per_s": dryrun._rows_per_s(step, batch, batch_size, rate_steps, device)}


def two_rank_worker(payload: dict) -> dict:
    """What each of the two ranks of phases 36-39 runs (dryrun.run_workers,
    gloo, both on cuda:0): SLD data parallel (dryrun.sld_step), MMVTS data
    parallel (dryrun.mmvts_step), run_finetune's step at
    --model_parallel_size 2 (two_rank_finetune) and MMVTS at mp 2 (the
    experts and heads sharded); each phase's launches counted from 0 just
    before it, and its seconds."""
    import torch

    from spokennlp_tpu_torch import dryrun

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dense, longformer = ({**k[0], **k[1]} for k in (mmvts_wrappers("dense"),
                                                    mmvts_wrappers("sliding_window")))
    device = payload["device"]
    runs = {
        "sld": lambda: dryrun.sld_step(payload["sld"]),
        "mmvts dp": lambda: dryrun.mmvts_step(payload["mmvts"]),
        "finetune mp": lambda: two_rank_finetune(payload["finetune"], device,
                                                 payload["finetune_grads"], 1, payload["batch"]),
        "mmvts mp": lambda: dryrun.mmvts_step(payload["mmvts mp"]),
    }
    out = {}
    for name, run in runs.items():
        wrappers = longformer if name == "mmvts mp" else dense
        reset_counts(wrappers)
        t0 = synced(device)
        out[name] = run()
        synced(device)
        out[name].update(launches=read_counts(wrappers), phase_s=time.perf_counter() - t0)
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def grad_cosine(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    return float(torch.dot(a, b) / (a.norm() * b.norm()).clamp_min(1e-300))


def two_rank_phases(root: Path, train_data: str, device="cuda") -> dict:
    """Phases 36-39: two ranks on the one card over gloo against one rank on
    the same global batch, each at full width: SLD at GPT-2 small (8 x 1024,
    float32: the loss within dryrun.LOSS_RTOL, the gradient norm within
    dryrun.GRAD_NORM_RTOL, the gradients' cosine >= TWO_RANK_MIN_COSINE, the
    time masks and 8 prompts' greedy decode equal); MMVTS dense data
    parallel (the modality CL, the matrix topic CL, ma_moe's dispatch over
    both ranks' tokens: the same, and the eval argmax equal); run_finetune's
    step at BERT-base on auto with --model_parallel_size 2 (rows 10 and 11
    on the weights gathered whole, eval on kernel 3: the same); MMVTS on the
    Longformer-base trunk at mp 2 (the experts and heads sharded; rows 12
    and 11, kernels 7 and 2 on gathered weights). Prints each phase's rows
    trained/s beside the one-rank run's and the launches of the two-rank
    runs."""
    import time

    import torch

    from spokennlp_tpu_torch import dryrun

    grads = {k: str(root / f"two_rank_{k.replace(' ', '_')}.pt")
             for k in ("sld", "mmvts dp", "finetune mp", "mmvts mp", "one")}
    sld = {**TWO_RANK_SLD, "device": device}
    mm = {**TWO_RANK_MMVTS, "device": device}
    lf = {**TWO_RANK_MMVTS_LF, "device": device}
    ft = train_argv(train_data, str(root / "two_rank_ft"), device=device, **TWO_RANK_FT)
    payload = {"device": device, "batch": B, "sld": {**sld, "grads_path": grads["sld"]},
               "mmvts": {**mm, "grads_path": grads["mmvts dp"]},
               "finetune": ft + ["--model_parallel_size", "2"],
               "finetune_grads": grads["finetune mp"],
               "mmvts mp": {**lf, "mp": 2, "grads_path": grads["mmvts mp"]}}
    t0 = time.perf_counter()
    one = {}
    for name, run in (("sld", lambda g: dryrun.sld_step({**sld, "grads_path": g})),
                      ("mmvts", lambda g: dryrun.mmvts_step({**mm, "grads_path": g})),
                      ("finetune", lambda g: two_rank_finetune(ft, device, g, 1, B)),
                      ("mmvts lf", lambda g: dryrun.mmvts_step({**lf, "grads_path": g}))):
        one[name] = run(grads["one"])
        one[name]["grads"] = torch.load(grads["one"])
        if device == "cuda":
            torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = dryrun.run_workers(2, "chip_smoke:two_rank_worker", payload, timeout=600,
                             device=device)
    two_s = time.perf_counter() - t0
    rows = {}
    for phase, name, ref, what in ((36, "sld", "sld", "sequences"), (37, "mmvts dp", "mmvts",
                                                                       "windows"),
                                   (38, "finetune mp", "finetune", "windows"),
                                   (39, "mmvts mp", "mmvts lf", "windows")):
        got, want = two[name], one[ref]
        try:
            dryrun.check_step(f"phase {phase} ({name})", want, got)
        except AssertionError as e:
            fail(str(e))
        cos = grad_cosine(torch.load(grads[name]), want["grads"])
        same = {k: got[k] == want[k] for k in ("time_mask", "tokens", "argmax") if k in want}
        rows[name] = {"loss": got["loss"], "one_rank_loss": want["loss"],
                      "grad_norm": got["grad_norm"], "one_rank_grad_norm": want["grad_norm"],
                      "grad_cosine": cos, "equal": same, "launches": got["launches"],
                      "rows_per_s": got["rows_per_s"], "one_rank_rows_per_s": want["rows_per_s"],
                      "phase_s": got["phase_s"]}
        print(f"phase {phase} ({name}, two ranks on one card over gloo): loss {got['loss']:.6f} "
              f"(one rank {want['loss']:.6f}), grad_norm {got['grad_norm']:.6f} "
              f"({want['grad_norm']:.6f}), gradient cosine {cos:.8f}, equal {same}; "
              f"{got['rows_per_s']:.2f} {what} trained/s against one rank's "
              f"{want['rows_per_s']:.2f} (gloo through the host: not a two-card rate); "
              f"launches {got['launches']}; {got['phase_s']:.1f} s")
        if cos < TWO_RANK_MIN_COSINE:
            fail(f"phase {phase} ({name}): gradient cosine {cos} below {TWO_RANK_MIN_COSINE}")
        if not all(same.values()):
            fail(f"phase {phase} ({name}): {[k for k, v in same.items() if not v]} differ from "
                 "one rank's")
        if device == "cuda" and name != "sld" and any(n == 0 for n in got["launches"].values()):
            fail(f"phase {phase} ({name}): a kernel of the path was not launched: "
                 f"{got['launches']}")
    print(f"phases 36-39: one rank {one_s:.1f} s, two ranks {two_s:.1f} s")
    return {**rows, "one_rank_s": one_s, "two_rank_s": two_s}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from spokennlp_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {[l for l in nvcc.splitlines() if 'release' in l][0].strip()}")
    print(f"card: {card}")

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({build.library_path().name})")
    int8_build_report(build.library_path().with_suffix(".log").read_text())
    sass_check(build.library_path())
    print(f"build checks: {time.perf_counter() - t0:.1f} s")

    device = torch.device("cuda")
    rows = kernel_phase(device)
    rows.update(w8a8_kernel_phase(device))
    stack_rows = stack_kernel_phase(device)
    rows["fused_encoder_stack", "bfloat16"] = stack_rows["W8A8", "bfloat16"]
    rows["fused_encoder_stack", "float32"] = stack_rows["float", "float32"]
    core_columns(rows, device)
    rows.update(train_kernel_phase(device))
    rows.update(sliding_kernel_phase(device))
    rows.update(bigbird_kernel_phase(device))

    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts
    from spokennlp_tpu_torch.ops.cuda.bigbird_block import fused_bigbird_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.sliding_block import fused_sliding_attention_block

    with tempfile.TemporaryDirectory() as tmp:
        data = write_corpus(Path(tmp), n_test_docs=120)
        # kernels 1 and 2 at batch 32: "auto" would take the stack kernel there
        infer = main_path(main_path_argv(data, str(Path(tmp) / "out")) + ["--attention_impl",
                                                                            "fused"],
                          LAYERS, B, kernel_impl="fused")
        t1 = time.perf_counter()
        serving = serving_path(data, str(Path(tmp) / "serve_out"))
        print(f"serving phase (with flash, streaming and cos): {time.perf_counter() - t1:.1f} s")
        # short documents: several windows in each packed row
        t1 = time.perf_counter()
        packed = packed_path(write_corpus(Path(tmp), n_test_docs=300, seed=5, sentences=(4, 14)),
                             str(Path(tmp) / "packed_out"))
        print(f"packed phase: {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        (Path(tmp) / "ckpt").mkdir()
        ckpts = checkpoint_path(data, Path(tmp) / "ckpt")
        print(f"checkpoint phase: {time.perf_counter() - t1:.1f} s")
        # about 2.9 windows a document: TRAIN_STEPS batches of B in one epoch
        train_data = write_corpus(Path(tmp), n_test_docs=4,
                                  n_train_docs=math.ceil(TRAIN_STEPS * B / 2.5), seed=1)
        train = train_path(train_argv(train_data, str(Path(tmp) / "train_out")), LAYERS, B)
        t1 = time.perf_counter()
        flash_train = flash_train_path(train_data, Path(tmp) / "flash_train_out", train)
        print(f"flash training phase: {time.perf_counter() - t1:.1f} s")
        fused_vs_einsum_grads(train_argv(train_data, str(Path(tmp) / "grad_out")), batch_size=B)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        scale = {"checkpointing": remat_phase(train_data, Path(tmp), train)}
        print(f"phase 22 (gradient checkpointing, dense): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        scale["nccl"] = nccl_step_path(train_data, Path(tmp))
        print(f"phase 26 (NCCL world size 1): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        scale["pretraining"] = pretrain_path(Path(tmp))
        print(f"phase 24 (pretraining): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        scale["feature extraction"] = extract_features_path(Path(tmp))
        print(f"phase 25 (feature extraction): {time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()

        # the Longformer paths: long documents, about 2 windows of 2048 each
        lf_data = write_corpus(Path(tmp), n_test_docs=40, n_train_docs=8, seed=2,
                               sentences=(150, 300))
        lf_infer = main_path(
            main_path_argv(lf_data, str(Path(tmp) / "lf_out"), seq=LF_L, batch=LF_B,
                           window=LF_WINDOW), LAYERS, LF_B,
            kernels={"sliding_attention_block": fused_sliding_attention_block,
                     "fused_mlp_block": fused_mlp_block}, long_tokens=LF_LONG_TOKENS)
        argv = lambda out, epochs: longformer_train_argv(lf_data, str(Path(tmp) / out), epochs)
        epochs = epochs_for_steps(argv("lf_train_out", 1.0), LF_STEPS)
        lf_train = train_path(
            argv("lf_train_out", epochs), LAYERS, LF_TRAIN_B, accum=LF_ACCUM,
            kernels={"sliding_train_fwd": ts.sliding_train_fwd,
                     "sliding_train_bwd": ts.sliding_train_bwd,
                     "mlp_train_fwd": tb.mlp_train_fwd, "mlp_train_bwd": tb.mlp_train_bwd})
        fused_vs_einsum_grads(argv("lf_grad_out", epochs), batch_size=LF_TRAIN_B)
        torch.cuda.empty_cache()
        # the same recipe at the CLI's default dtype (float32): the float32
        # training kernels, their backwards' products on the 3xTF32 tile
        lf_train_f32 = train_path(
            cli_default_dtype(argv("lf_f32_train_out", epochs)), LAYERS, LF_TRAIN_B,
            accum=LF_ACCUM,
            kernels={"sliding_train_fwd": ts.sliding_train_fwd,
                     "sliding_train_bwd": ts.sliding_train_bwd,
                     "mlp_train_fwd": tb.mlp_train_fwd, "mlp_train_bwd": tb.mlp_train_bwd})
        lf_train_f32.update(fused_vs_einsum_grads(
            cli_default_dtype(argv("lf_f32_grad_out", epochs)), batch_size=LF_TRAIN_B))
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        scale["longformer checkpointing"] = lf_remat_phase(lf_data, Path(tmp), lf_train_f32)
        print(f"phase 23 (gradient checkpointing, Longformer float32): "
              f"{time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()

        # the BigBird paths: longer documents, about 1.5 windows of 4096 each
        bb_data = write_corpus(Path(tmp), n_test_docs=24, n_train_docs=8, seed=3,
                               sentences=(300, 600))
        bb_infer = main_path(
            main_path_argv(bb_data, str(Path(tmp) / "bb_out"), seq=BB_L, batch=BB_B,
                           bigbird=True), LAYERS, BB_B,
            kernels={"bigbird_attention_block": fused_bigbird_attention_block,
                     "fused_mlp_block": fused_mlp_block}, long_tokens=BB_LONG_TOKENS)
        argv = lambda out, epochs: longformer_train_argv(
            bb_data, str(Path(tmp) / out), epochs, seq=BB_TRAIN_L, window=None, bigbird=True,
            batch=BB_B)
        epochs = epochs_for_steps(argv("bb_train_out", 1.0), LF_STEPS)
        bb_train = train_path(
            argv("bb_train_out", epochs), LAYERS, LF_TRAIN_B, accum=LF_ACCUM,
            kernels={"bigbird_train_fwd": tbb.bigbird_train_fwd,
                     "bigbird_train_bwd": tbb.bigbird_train_bwd,
                     "mlp_train_fwd": tb.mlp_train_fwd, "mlp_train_bwd": tb.mlp_train_bwd})
        fused_vs_einsum_grads(argv("bb_grad_out", epochs), batch_size=LF_TRAIN_B)
        torch.cuda.empty_cache()
        print(f"build and phases 3-14: {time.perf_counter() - t0:.1f} s")

        # the MUG slice: kernel 9, then Tracks 1 and 2 through run_mug
        t1 = time.perf_counter()
        rows.update(ponet_kernel_phase(device))
        print(f"phase 15 (kernel 9): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        mug_data = write_mug_corpus(Path(tmp) / "mug", n_train=3, n_eval=4)
        mug = mug_path(ponet_checkpoints(Path(tmp)), mug_data, Path(tmp))
        print(f"phase 16 (MUG Tracks 1 and 2): {time.perf_counter() - t1:.1f} s")

        # the W8A8 long-context slice and the last two kernel modes
        t1 = time.perf_counter()
        rows.update(w8a8_long_kernel_phase(device))
        rows.update(core_static_kernel_phase(device))
        print(f"phases 17-18 (W8A8 kernels 7 and 8, 1c and 2b): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        rows_kernel_phase(device, rows)
        print(f"phase 20 (the rows kernels alone): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        w8a8_long = {"longformer": long_serving_path("longformer", lf_data,
                                                     str(Path(tmp) / "lf_w8a8")),
                     "bigbird": long_serving_path("bigbird", bb_data, str(Path(tmp) / "bb_w8a8"))}
        print(f"phase 19 (W8A8 long-context serving): {time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()

        # MUG Tracks 3 and 4 and action-item detection
        tracks = {}
        for phase, label, run in (
                (27, "keyphrase", lambda: kpe_path(Path(tmp))),
                (28, "aid", lambda: aid_path(Path(tmp))),
                (29, "title palm", lambda: title_path(Path(tmp), "palm")),
                (29, "title seq2seq", lambda: title_path(Path(tmp), "seq2seq"))):
            t1 = time.perf_counter()
            tracks[label] = run()
            tracks[label]["phase_s"] = time.perf_counter() - t1
            print(f"phase {phase} ({label}): {tracks[label]['phase_s']:.1f} s")
            torch.cuda.empty_cache()

        # Ditto and SLD; sklearn is not on the card's machine, so these phases
        # are built without its calls (no logreg probe, no k-fold splits, no
        # MiniBatchKMeans)
        import importlib.util

        print(f"phases 30-32 leave out sklearn's calls (sklearn importable here: "
              f"{importlib.util.find_spec('sklearn') is not None})")
        slice24 = {}
        for phase, label, run in ((30, "ditto", lambda: ditto_path(Path(tmp))),
                                  (31, "sld", lambda: sld_path(Path(tmp))),
                                  (32, "wavlm", lambda: wavlm_path(Path(tmp)))):
            t1 = time.perf_counter()
            slice24[label] = run()
            slice24[label]["phase_s"] = time.perf_counter() - t1
            print(f"phase {phase} ({label}): {slice24[label]['phase_s']:.1f} s")
            torch.cuda.empty_cache()

        # MMVTS: the fusion stack on the dense and Longformer trunks, then
        # CLIP's frame features
        slice25 = {}
        for phase, label, run in (
                (33, "mmvts dense", lambda: mmvts_path(Path(tmp), "dense")),
                (34, "mmvts longformer", lambda: mmvts_path(Path(tmp), "sliding_window",
                                                            pretrain=False)),
                (35, "clip", lambda: clip_path())):
            t1 = time.perf_counter()
            slice25[label] = run()
            slice25[label]["phase_s"] = time.perf_counter() - t1
            print(f"phase {phase} ({label}): {slice25[label]['phase_s']:.1f} s")
            torch.cuda.empty_cache()

        # the multi-device paths: two ranks on the one card over gloo, after
        # kernel 3 at MMVTS's eval batches
        t1 = time.perf_counter()
        small_stack = stack_small_batches(device)
        two_rank = {**two_rank_phases(Path(tmp), train_data), "kernel 3 small batches": small_stack}
        print(f"phases 36-39 (two ranks): {time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()
    print(f"all phases: {time.perf_counter() - t0:.1f} s")

    served = lambda run, k: serving["runs"][run]["launches"].get(k, 0)
    launches = {**infer["launches"], **train["launches"],
                "sliding_attention_block": lf_infer["launches"]["sliding_attention_block"],
                **{k: lf_train["launches"][k] for k in ("sliding_train_fwd", "sliding_train_bwd")},
                "bigbird_attention_block": bb_infer["launches"]["bigbird_attention_block"],
                **{k: bb_train["launches"][k] for k in ("bigbird_train_fwd", "bigbird_train_bwd")},
                "fused_encoder_stack": served("w8a8 auto 32", "fused_encoder_stack"),
                "fused_attention_block_w8a8": served("w8a8 auto 128", "fused_attention_block"),
                "fused_mlp_block_w8a8": served("w8a8 auto 128", "fused_mlp_block"),
                **{k: served("w8a8 einsum 32", k) for k in ("w8a8_matmul_bf16in", "w8a8_matmul")},
                "snld_self_attention": served("none pallas 32", "snld_self_attention"),
                "fused_ponet_mixer_block": mug["float32"]["launches"]["fused_ponet_mixer_block"],
                "fused_ponet_mixer_block_w8a8":
                    mug["W8A8"]["launches"]["fused_ponet_mixer_block"],
                "sliding_attention_block_w8a8":
                    w8a8_long["longformer"]["runs"]["w8a8 auto"]["launches"][
                        "sliding_attention_block"],
                "bigbird_attention_block_w8a8":
                    w8a8_long["bigbird"]["runs"]["w8a8 auto"]["launches"][
                        "bigbird_attention_block"],
                **MODE_LAUNCHES}
    # rows 10, 11 and kernel 3 also ran on the Track 3-4, AID and MMVTS paths,
    # rows 12, 7 and 2 on the MMVTS Longformer path
    for row in (*tracks.values(), slice24["ditto"], slice25["mmvts dense"],
                slice25["mmvts longformer"], *(two_rank[k] for k in ("mmvts dp", "finetune mp",
                                                                     "mmvts mp"))):
        for name, n in row["launches"].items():
            launches[name] += n
    print(json.dumps({"serving": serving}, default=float))
    print(json.dumps({"packed": packed, "checkpoints": ckpts, "flash training": flash_train},
                     default=float))
    for name, inf, trn in (("longformer", lf_infer, lf_train), ("bigbird", bb_infer, bb_train)):
        print(json.dumps({name: {
            "inference": {k: inf[k] for k in ("launches", "windows", "windows_per_s", "peak_gib",
                                              "einsum_windows_per_s", "einsum_peak_gib",
                                              "agreement", "max_dlogit")},
            "training": {k: trn[k] for k in ("launches", "steps", "steps_per_s",
                                             "windows_per_s", "peak_gib")}}}))
    print(json.dumps({"longformer float32": {"training": {
        k: lf_train_f32[k] for k in ("launches", "steps", "steps_per_s", "windows_per_s",
                                     "peak_gib", "loss_rel", "min_cos")}}}))
    print(json.dumps({"mug": mug}, default=float))
    print(json.dumps({"training at scale": scale}, default=float))
    print(json.dumps({"w8a8_long": w8a8_long}, default=float))
    print(json.dumps({"mug tracks 3-4 and aid": tracks}, default=float, ensure_ascii=False))
    print(json.dumps({"ditto and sld": slice24}, default=float))
    print(json.dumps({"mmvts and clip": slice25}, default=float))
    print(json.dumps({"two ranks on one card": two_rank}, default=float))
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        # each kernel's row in the type its main path computes in
        dtype = "float32" if name.startswith("fused_ponet") else "bfloat16"
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[name], **rows[name, dtype], "dtype": dtype}
        f32_row = rows.get((name, "float32")) if dtype != "float32" else None
        if f32_row is not None:  # the float32 mode: its time and bound (products on 3xTF32)
            entry.update({f"f32_{k}": f32_row[k] for k in (
                "ms", "plain_ms", "bound_ms", "simt_bound_ms", "rows_ms", "rows_bound_ms",
                "rows_library_ms", "core_ms", "grad_ms", "grad_bound_ms", "core_library_ms",
                "global_ms", "global_bound_ms", "global_library_ms", "global_ms_16",
                "global_bound_ms_16", "global_library_ms_16", "gkv_ms", "gkv_bound_ms")
                if k in f32_row})
        ditto_row = slice24["ditto"]["kernels_32x128"].get(name)
        if ditto_row is not None:  # float32 at Ditto's shape, B = 32, L = 128
            entry.update({f"ditto_f32_{k}": ditto_row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")})
        kernels.append(entry)
    f32 = {name: rows[name, "float32"] for name in KERNELS if (name, "float32") in rows}
    print(json.dumps({"float32": f32}))
    print(json.dumps({"fused_encoder_stack float": {dtype: stack_rows["float", dtype]
                                                    for dtype in ("bfloat16", "float32")}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
