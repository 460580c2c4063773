#!/usr/bin/env python3
"""Drive echr_tpu_torch's batched greedy and beam serving paths, its XE
training path, its three probes, its batched eval loop, its checkpointed
training, its self-critical (SCST) training, its multinomial eval, the
decoder family's other cores, its on-disk data, external proposals,
reference .pth import and serve CLI, its synchronous and pipelined train
loops, its per-video eval, decode and SCST paths, its data- and
tensor-parallel training, its sequence ring, resident-graph SCST, grouped
attention, decode switches and host library, and the published recipe's
trained path (its four stages chained, then greedy, beam-4 and early-exit
eval on trained weights) once on one NVIDIA GPU, and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

kernel_turns.py times kernels 1-10 beside another build of their sources
(a parent commit's) in turns; this script times this checkout's kernels
alone.

Phases, in order; any failure raises and the script exits non-zero:

  1. device: require CUDA, print the card's name and power limit, build
     the CUDA kernels from echr_tpu_torch/csrc into echr_tpu_torch/_build;
  2. kernel 1 (masked attention scores) against its plain PyTorch version
     at the serving shapes, ragged shapes, all-masked, all-unmasked, an
     unsorted mask and a mask with holes inside windows (masked entries
     must be 0), and at the serving shape with every entry live, whose
     time gives the rate of kernel 1's tanh; then its tanh itself
     (csrc/tanh.cuh): kernel 1 at H=1 (w=1, q=0, b=0) returns it exactly,
     swept over [-10, 10] and small |x| against float64 (max abs error at
     most 2.4e-7, 2 ulp of 1.0);
  3. kernel 2 (streaming greedy head) against its plain version at the
     serving shapes in bf16 and f32, ragged shapes (a width that is not a
     multiple of 8 included: w padded once, out per call), and exact ties
     within a tile, across tiles of one vocab split and across splits;
  4. the greedy slice: CaptionService at the flagship width (vocab 6000,
     30 steps) from the port's seeded init captions 64 requests of 256 x
     500 C3D features (two chunks of 32 videos, top-128 proposals: 4096
     decode rows); both kernels' launch counts must equal the decode steps,
     and kernel 11's (the SST's recurrence) one a chunk and SST layer;
  5. greedy parity: at f32 with TF32 off and sharpened logit weights, the
     slice with the kernels and under force_plain() gives the same tokens
     and logps within 5e-4;
  6. times: kernel against plain version (CUDA events after warm-up) and
     the slice's captions/s, each beside the card's name and power limit;
     kernel 2 in turns with the bare bf16 torch.matmul over the same out
     and w, unpadded and with the vocab padded to a multiple of 8 (a
     yardstick, not the head's function), and its host time a call;
     kernel 1 at four inputs, phase 2's synthetic windows, one greedy
     step's tensors of phase 4 and (after phase 10) the beam path's step
     tensors with their own and with short windows, each held against
     its plain version and timed with its live-work bound, the tanh the
     design evaluates there over the tanh the mask needs (modelled from
     the mask), and at the end the tanh-rate floor (live tanh over the
     all-live rate of phase 2);
  7. kernel 3 (differentiable scores, forward, window-masked) against its
     plain version wherever mask == 1, masked entries exactly 0: at the
     training shapes with every entry live and with phase 2-style windows
     of 4-47 frames in random order, and at a ragged shape; its time at
     the first two beside its live-work bound;
  8. kernel 4 (their backward) against the autograd of the plain forward at
     the same shapes with a dense cotangent and with one that is zero
     outside sorted windows (N=64), and two calls bit-identical; its time
     with both;
  9. the training slice: engine.train.train at the flagship width as
     bench.py's e2e_train_cfg builds it (B=32 videos of T=256, cotrain /
     tap_cg, vocab 6000, bf16, dropout on, seeded): 1 warm-up and 5 timed
     steps; finite losses, moved parameters, and kernel 3 and 4 launches
     equal to the teacher-forced steps run; time/step, videos/s and peak
     memory; then one more step with wrappers that keep kernels 3 and 4's
     inputs: the density of the step's 29 window masks and the share of
     nonzero cotangent entries, each kernel held against its plain version
     and timed on the step's own inputs;
  10. training parity: at f32 with TF32 off and dropout off, one step's
     loss and gradients with the kernels and under force_plain() agree;
  11. kernel 5 (the fused attention step) through
     additive_attention_step(fused=True) once (its one launch, the
     kernel's launches_by_path), then against its plain version within
     2e-3 on a ragged shape with D > 512 and a fully-masked row (exact
     zeros), and at two inputs, each held against its plain version, rows
     without a live frame exact zeros, and timed in turns with the
     kernel-1 route (kernel 1 + masked_softmax + the bf16 AV product),
     beside its plain version's time, its bound and the tanh it needs: the
     beam path's step tensors (32 requests, window-sorted, k=4: N*k=512
     rows, T=256, Hatt=512, D=500, bf16) and the same with short windows
     (short_windows: 4-47 frames, density ~0.1);
  12. kernel 6 (windowed attention, W=64) once, then against its plain
     version within 5e-4 with zero-length windows (exact zeros) and
     windows that end at T, and on a ragged shape; then at phase 11's two
     inputs with their sorted windows, as phase 11.  Kernels 5 and 6 are
     also measured so at the SOTA_TEP eval's first decode step (phase 27)
     and at a per-video decode step (phase 29, with the host time a call
     of each kernel and of the route); kernel 6 takes each row's window
     from the mask (first live frame, last + 1);
  13. the beam slice: CaptionService(beam_size=4) at the flagship width on
     64 requests (two chunks of 32 videos, top-128 proposals: 16384 beam
     rows a chunk) after a warm-up chunk; kernel 1's launches must equal
     the beam steps run; captions/s, ms per chunk, early-exit syncs, peak
     memory, and one chunk's decode under torch.profiler, with kernel 1's
     device ms over the chunk;
  14. beam parity: at f32 with TF32 off and phase 5's weights, beam 4 with
     the kernels and under force_plain() gives identical tokens for every
     beam and best logprobs within 5e-4; with the weights sharpened 16x
     more, beam 1 gives the greedy tokens;
  15. kernel 7 (the head probes' streaming head at its plan, TR=64, TV=512)
     against its plain version at the probe's shapes (R=4096, C=1536,
     V1=6001 padded to 6144, bf16; tokens bit-equal, max and lse within
     5e-4), a ragged R and exact ties within and across vocab tiles; its
     time and the bytes its plan reads through L2 (modelled); then
     probe_greedy_head: X0, XM (and both over the padded vocab), K1
     (kernel 7) and K2 (kernel 2) ms a step;
  16. kernel 8, every instantiated tiling, against its plain version at a
     ragged R, then probe_streaming_head2: each tiling checked at the
     probe's shapes, then X0, XM, X0p, XMp and every tiling in interleaved
     windows; exact ties at every tiling; each tiling's time a call and
     the bytes its plan reads through L2 (modelled);
  17. kernels 9 and 10, and kernel 10's product warps alone, against their
     plain versions at B=32, N=128, T=256, H=512, KD=2048, a ragged shape
     and a shape with N and T both off the kernels' 64 x 128 block at the
     narrowest product (KD=128), and kernel 10 at the probe's KD=8192; their
     times (kernel 10 also at KD=8192) beside the bound, the SFU floor
     (two SFU ops a tanh at the data sheet's 16 a clock an SM, at
     clocks.max.sm: modelled, printed and kept out of the record) and, at
     the end, the tanh-rate floor (phase 2's rate); then probe_mxu_vpu_overlap: S0, S1,
     SD and S2 at KD=2048 and 8192.  In 15-17 each kernel's launches over
     the probe's run must equal the calls the probe made;
  18. the eval slice: engine.evaluate.eval_split_batched over the 64-video
     val split of train_cfg()'s 256 synthetic videos (the flagship width,
     random weights from a seed), tap_cg, top-128, 32 videos a group,
     every metric: greedy with val losses, then beam 4 decode-only.  Every
     usable val video has predictions (at most 128, well-formed timestamps,
     sentences in the vocab, re_score = 10 x proposal_score +
     sentence_confidence), the val losses are finite, the scores hold every
     metric at the four tIoUs; kernel 1's launches equal the decode steps
     plus the val losses' teacher-forced steps (29 a group), kernel 2's the
     greedy decode steps; TF32 is still off after each pass (every bf16
     product turns it on for its own duration).  For each pass,
     after a warm-up group: eval videos/s and captions/s without scoring,
     the timing_out breakdown, the seconds in eval_score and its stemmer,
     peak device memory;
  19. eval parity: at f32 with TF32 off and phase 5's sharpened logit
     weights, the greedy eval with the kernels and under force_plain()
     gives the same sentences, timestamps and proposal scores for every
     video, sentence confidences within 5e-4 a token and val losses within
     1e-5 relative;
  20. checkpointed training: engine.train.train on train_cfg() (nothing
     cut) for 8 steps with save_checkpoint_every 4 from epoch 0, so the
     gate runs at 4 and 8, each over one group of 32 val videos, the cg
     pass and then the tap_cg pass, every metric scored.  Kernels 3 and
     4 launch 29 times a step and a histogram step, kernel 1 once a gate
     decode step and 29 times a val-loss group, kernel 2 once a decode
     step; the best score is the gates' highest, model-best.ckpt holds it;
     TF32 is off after the gates; model-last.ckpt read back onto the card
     equals the run's state, parameters and Adam state; serve's
     from_checkpoint on model-best.ckpt captions phase 6's requests.
     ms/step outside the gate, each gate's seconds by pass and in
     eval_score, the checkpoints' bytes and seconds to write and to read,
     peak device memory with the gate inside the run;
  21. preemption: a hook on train_step sends the process SIGTERM before
     step 3; train() returns at step 3 with a readable model-last.ckpt
     and its handler restored, and start_from runs on to step 5;
  22. resume parity: at f32 with TF32 off, dropout and scheduled sampling
     off (steps without a generator), 3 steps then a resume to 6 against 6
     straight: the losses of steps 4-6 within 1e-5 relative, the
     parameters within atol 1e-5;
  23. SCST training: engine.train.train on train_cfg() with
     self_critical_after 0 (B=32 videos of T=256, N=64 sampled
     proposals, vocab 6000, L=30, tap_cg, bf16 with f32 masters, dropout
     on; nothing cut): 1 warm-up and 4 timed steps.  Finite losses,
     avg_reward logged, moved parameters; kernel 1 launches once a greedy
     baseline decode step, kernel 2 too (R = B*N = 2048), kernel 3 once a
     sampled decode step and 30 times a replay, kernel 4 30 times a step,
     kernel 11 once a step and SST layer (the greedy baseline's eval-mode
     encode; the sampled rollout's train-mode encode runs the loop).
     ms/step split into the rollouts (sampled + greedy baseline), the host
     METEOR reward (pool size, stemmer) and the update; the steps each
     rollout's early exit ran; peak device memory.  The reward pool's
     workers are joined at the end;
  24. SCST fidelity: f32, TF32 off, phase 5's sharpened weights, dropout
     on, B=4: the replay's logps of the rollout's tokens equal the
     rollout's within 1e-5; the greedy baseline's tokens equal with the
     kernels and under force_plain(); one update's loss within 1e-5
     relative and its gradient leaves within atol 2e-4, rtol 1e-3 with the
     kernels and under force_plain(); kernels 1 and 2 on copies of the
     baseline's first call, kernels 3 and 4 on copies of each of the
     replay's calls, against their plain versions within 5e-4 (kernel 4's
     d_w within 1e-4 of its largest entry).  Then at bf16, train()'s first
     SCST step at the flagship training width (batch_size 4): the
     update's replay gives the rollout's tokens and exactly its logps (the
     rollout's train-mode encode and the replay's both run the loop), and
     kernel 11 launches once a layer, for the greedy baseline;
  25. multinomial eval: eval_split_batched with sample_max 0, temperature
     1, sample_seed 7 over phase 18's val split (tap_cg, top-128, batch 32,
     decode-only, every metric) after a warm-up group: well-formed
     predictions, kernel 1's launches equal the decode steps and kernel 2
     none, eval videos/s and captions/s without eval_score (printed
     beside), and a second pass with the seed gives the same predictions
     JSON.  Then at f32 on phase 5's weights, the greedy pass against
     sampling at T=1e-3: every draw whose top two logits lie >= 20 T apart
     takes the argmax, the draws that leave it number what the tempered
     softmax expects (within 5 standard deviations), and no more
     sentences differ than draws that left the argmax or met a top-2 gap
     below 1e-4;
  26. the decoder family: kernel 2 at the family's logit widths (R=4096,
     C=512 and C=1024, V1=6001, bf16) against its plain version and timed
     beside its bound and the bare bf16 product in turns, as phase 6; then
     each core of CORE_REGISTRY but three_stream at the flagship width
     (show_attend_tell and all_img with CG_num_layers 3, "V+E+C" inputs and
     a "V+E" init state): CaptionService greedy over a timed 32-video chunk
     after a warm-up chunk (kernel 2 once a decode step, kernel 1 too where
     the attention is live and never where it is not; captions/s), the f32
     decode of 4 videos with the kernels and under force_plain() (phase 5's
     gates), and 1 warm-up and 1 timed XE step of engine.train.train at
     B=8 (finite losses, moved parameters, kernels 3 and 4 once a
     teacher-forced step, none for all_img; ms/step); for show_attend_tell
     also beam 4 over a timed chunk (kernel 1 once a beam step) and one
     timed SCST step at B=8 after a warm-up step (phase 23's launch
     counts).  The phase's wall seconds;
  27. real data and reference weights: phase 18's 256 videos written to
     disk by data/export_disk (the reference's layout) and checked by
     cli/validate_data (exit 0), with a proposals JSON in the ActivityNet
     results layout (100 a val video: three jittered copies of each GT
     event, then random windows of 2-52% of the video; scores from a
     seed).  eval_split_batched(flag_eval_what="SOTA_TEP") from disk at
     the flagship width (phase 18's seeded init, bf16), 32 videos a
     group, greedy with val losses, every metric, after a warm-up group:
     every usable val video captioned on each of its external proposals
     in the JSON's order, kernel 1's launches equal the decode steps plus
     the val losses' (29 a group), kernel 2's the decode steps; eval
     videos/s and captions/s without scoring, eval_score's seconds and
     stemmer, peak memory.  Kernels 1 and 2 on copies of the warm-up
     group's first decode step (the external windows: their density and
     bucket printed) against their plain versions and timed beside their
     bound, and kernels 5 and 6 on that step's tensors as in phases 11-12.
     At f32 with TF32 off, phase 5's weights and the window sort
     off, the pass from disk against the pass over the in-memory corpus
     and against force_plain(): sentences equal but where the first
     differing token is a near-tie (top-2 gap below 1e-4) of the other
     pass, confidences within 5e-4 a token, val losses within 1e-5
     relative.  The seeded three_stream weights written as a reference
     .pth (reference_state_dicts) and read back by
     compat.import_reference_checkpoint: every parameter bit-equal,
     greedy captions equal.  Then a format-v2 checkpoint of the imported
     weights, and python -m echr_tpu_torch.cli.serve over the 64 val
     .npy files, greedy and beam 4, each in a child process whose exit
     code is checked and whose kernel launches equal its decode steps
     (kernel 2 none for beam); its captions/s as the CLI logs it, and
     cli/score of the greedy JSON against the val annotations.  The phase's
     wall seconds;
  28. the train loops: engine.train.train on train_cfg() (B=32, N=64,
     bf16, dropout on), the synchronous and the pipelined loop in turns
     (sync, pipelined, pipelined, sync), 4 steps a run, their means,
     medians and the neighbouring pairs the pipelined run won, then each
     once
     with transfer_dtype bfloat16: ms/step and videos/s over steps 2-4
     from CUDA events recorded after each step (the device's completion
     times), timing_out's loader, compress, collate, put, step and fetch
     seconds, the bytes sent to the device a group, peak memory, and
     kernels 3 and 4 launched 29 times a step; a pipelined run with steps
     3-5 inside utils.profiling.device_trace: the device-busy share of the
     traced window, the share of the H2D copy time under a kernel and the
     longest idle gap; then at f32 with TF32 and dropout off, 4 steps of
     each loop: every parameter bit-equal;
  29. the per-video paths on phase 18's val split and weights: eval_split
     over its first 32 usable videos, greedy with val losses and beam 4
     decode-only, each after a warm-up of 4
     videos (kernel 1 once a decode step and 29 times a val-loss call,
     kernel 2 once a greedy step; eval videos/s), eval_split_batched's rate
     beside it, python -m echr_tpu_torch.cli.eval without --batch_videos in
     a child process over 16 val videos (exit 0, eval_split ran); at f32
     with phase 5's
     weights and the window sort off, eval_split against
     eval_split_batched (phase 27's near-tie rule, val losses within 1e-5
     relative); 3 SCST steps of train() at batch_size 1 at f32 (the
     replay's tokens the rollout's, its logps within 1e-5 up to each end
     token, phase 23's launch counts); kernel 1 at the first call of each
     per-video row count and kernel 2 at R = 64, 128, 256 and 1024 (C=1536,
     V1=6001, bf16), each against its plain version and timed beside its
     bound and the plain head; kernels 5 and 6 at the greedy decode step
     of 128 rows, as in phases 11-12;
  30. data parallel: engine.train.train at train_cfg()'s width (B=32,
     N=64, tap_cg), f32, TF32 off, dropout off, 4 steps with the gate at 4
     over 32 val videos (the cg pass), without a group and then inside
     a one-rank NCCL group on a local TCP store (no group, group), the
     group destroyed after the run: parameters bit-equal
     (a world-1 all-reduce and a division by 1.0 change no bit), best
     scores and the gate's predictions JSON equal; ms/step of both from
     device step events, the gradient all-reduce's own device ms (CUDA
     events around parallel.mesh.all_reduce_grads: flatten, all_reduce,
     divide, views) and its bytes a step; kernels 1-4 launched as in
     phase 20 (29 a step and a histogram step for 3 and 4).  Then two
     gloo ranks on the one card (NCCL refuses two ranks on one device) in
     two child processes, if gloo's all_reduce takes CUDA tensors: 2 XE
     steps of train() at B=8 (4 videos a rank, f32, dropout off), step 1's
     loss within 1e-5 relative and its all-reduced gradient leaves within
     atol 2e-4, rtol 1e-3 of one process's at B=8, the ranks' parameters
     bit-equal, kernels 3 and 4 launched 29 times a step in each rank.  No
     time of this part is a scaling number.  Gloo must take the card's
     tensors: a refusal fails the phase;
  31. tensor and sequence parallelism, two gloo ranks on the one card in
     child processes, after one process's run: (a) train() under
     runtime.mesh_shape (1, 2) at train_cfg()'s width with vocab 6001
     (V+1 = 6002 cut 3001 + 3001, TSRM's 16 heads 8 + 8), B=8, f32, TF32
     off, dropout off, 2 XE steps with the gate at 2 over 16 val videos:
     step 1's loss within 1e-5 relative of one process's, its gradient
     leaves (the cut ones gathered) within atol 2e-4, rtol 1e-3, the
     ranks' replicated parameters bit-equal, kernels 3 and 4 launched 29
     times an XE step in each rank, and rank 0's checkpoint loaded here
     bit-equal to the gathered parameters; (b) the rollouts of one SCST
     step at (1, 2) against the gathered model's in the same rank: equal
     sampled and greedy tokens, kernel 2 once a baseline decode step in
     each rank, and the baseline's first kernel-2 call on the rank's
     3001-column block held against its plain version, the ranks' blocks
     combined (parallel.tensor.combine_heads) against kernel 2 on all
     6002 columns (tokens equal, lse within 5e-4), and timed beside it in
     f32 and bf16; (c) the SST ring (parallel/sequence.py) at the
     flagship width over T = 256 and 4096 frames against one process's
     sst_forward_batched within atol 1e-5, with the wall times and each
     rank's peak memory.  No time of this phase is a scaling number;
  32. one process: (a) resident-graph SCST (steps.rl_rollout_graph_step_
     batched and rl_graph_update_step_batched) against the replay path at
     f32, TF32 off, dropout on, B=32 at train_cfg()'s width with phase 5's
     weights and a fixed reward: the same sampled tokens, step 1's loss
     within 1e-5 relative and its gradient leaves within atol 2e-4, rtol
     1e-3, kernels 3 and 4 once a sampled step (and 30 times the replay's
     steps), and 2 steps of each in turns with ms a step and peak memory;
     (b) grouped windowed attention (ops/attention.py) at phases 29's and
     27's decode steps against additive_attention_step through kernel 1
     at f32 within atol 1e-5, timed in turns with that route and kernel
     6; (c) the per-video eval_split over 8 val videos greedy and beam 4
     with runtime.decode_early_exit True and False (the same captions, no
     early-exit sync in the fixed loops), and at f32 on phase 5's weights
     with the window sort off, greedy with runtime.use_pallas_head False
     (kernel 2 never launched, kernel 1 as often as with it, the same
     sentences, their confidences within HEAD_SWITCH_TOL a token);
  33. the host library (echr_tpu_torch/native, C++ built by g++ at first
     use): available() must hold.  (a) the first 64 training videos of
     train_cfg()'s split through make_batch with the C++ grid and under
     native.force_numpy(): every field bit-equal; iou_grid alone on their
     grids (T <= 256, K = 256), C++ against numpy in turns; (b) phase 6's
     slice captioned (on, off, off, on): the same captions, captions/s,
     render_captions' calls; a chunk's 4096 captions rendered alone in
     turns; (c) phase 18's greedy eval with val losses, unscored, (on,
     off, off, on): the same predictions JSON and val losses, eval
     videos/s, the host calls; one pass with NMS 0.8 keeping its score grids, and
     nms_temporal on them in turns (the same picks); (d) phase 27's corpus
     and external proposals, the SOTA_TEP eval from disk with NMS 0.8,
     every external_proposals_nms call in turns (the same picks); (e)
     phase 28's two loops, 3 steps a run, each on, off, off, on: ms/step,
     the loader and collate seconds, and the C++ grid's calls (above zero
     on).  Host times carry the card's name and power limit and the host
     CPU's model;
  34. the trained path: (a) the recipe's four stages
     (echr_tpu_torch/experiments/recipe.py: train_SST.sh, train_ECHR.sh,
     finetune.sh and soak_synthetic.sh's SCST stage, with its synthetic
     learnable SYN flags) through recipe.run_stage at the scripts' flags
     (the flagship width, batch_size 1, bf16), each cut to RECIPE_CAPS
     steps and gated once at its last step (--save_checkpoint_every its
     cap, --min_epoch_when_save 0), each warm-started from the previous
     stage's model-best.ckpt: the leaves each first step starts from equal
     the checkpoint's (or train()'s seeded init, for a model the stage
     does not take) bit for bit, finite losses, stage 2's caption loss
     lower over its last 10 steps than its first 10, stage 4's SCST steps
     with the reward pool; each stage's losses at its first and last step,
     gate score and ms/step; then python -m echr_tpu_torch.cli.eval on
     stage 4's model-best.ckpt over CLI_VIDEOS val videos in a child
     process (exit 0, captions in its
     predictions file).  (b) bench.py's bench_trained_eval: train_cfg()
     (e2e_train_cfg) trained TRAINED_UPDATES updates (kernels 3 and 4 29
     times a step), then on phase 18's val split greedy and beam 4 scored
     (kernel 1 once a decode step, kernel 2 once a greedy one; scores x100
     with the stemmer named, the mean caption length, the decode steps,
     eval videos/s), greedy with the batch-wide exit on and off in turns
     (experiments/probe_trained_e2e.compare: the same predictions JSON in
     every pass, the exit fails the phase if every caption ended before
     L - 1 tokens and it still ran all L steps), and the per-video
     eval_split with its exit on over TRAINED_PERVIDEO videos
     (captions/s).  (c) kernel 1 at the trained greedy and beam-4 decode
     steps, kernels 3 and 4 at one training step of the trained weights,
     each held against its plain version and timed; kernels 5 and 6 at the
     two decode steps, held and timed in turns with the kernel-1 route;
  35. kernel 11 (the LSTM recurrence of the SST, one launch a layer)
     against its plain loop under force_plain() at (B, T, H) = (128, 256,
     512), (32, 256, 512) and (1, 256, 512), from zeros and from a given
     (h0, c0), each on REC_SEEDS' inputs: every step from the loop's own
     (h, c) within 1e-4 (hs and c), and the whole sequence (hs, hT, cT)
     within 1e-3, printed beside the loop against itself with its product
     summed in two k halves (bf16 rounding edges make any order of the sums
     drift by ~1e-4); its ms a layer against the loop's (card and host) and
     the bytes bound.  Its launches by path are counted over the whole run:
     the kernel runs wherever the SST encodes in eval mode on the card in
     bf16 with grad off.

The lines before the last are the host library's JSON record, phase 34's
and then the kernels'; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import contextlib
import functools
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = 5e-4
FUSED_TOL = 2e-3  # kernel 5: bf16 weights from the running max (echr_tpu's gate)
T_BUCKET, VIDEO_DIM, VOCAB, SEQ_LEN, TOP_N = 256, 500, 6000, 30, 128
TRAIN_B, TRAIN_N, TRAIN_STEPS = 32, 64, 6  # videos, sampled proposals, steps (1 warm-up)
EVAL_B = 32  # videos a group of the batched eval
SWITCH_VIDEOS = 8  # phase 32(c): val videos a per-video pass
# phase 32(c): the f32 heads' confidences a token, kernel 2 on and off
# (about 3x the 2.953e-06 read on an H100 80GB HBM3 at 700 W)
HEAD_SWITCH_TOL = 1e-5
# phases 27 and 29 keep their decode step's attention inputs here for phase 32(b)
STEP_INPUTS = {}
BEAM, WINDOW = 4, 64  # beam width; kernel 6's W
# published H100 SXM peaks (NVIDIA's data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}
# special-function unit: 16 results a clock an SM (CUDA C++ Programming Guide,
# arithmetic instructions, compute capability 9.0); echr_tanh takes two
SFU_OPS_PER_CLOCK_SM, SFU_OPS_PER_TANH = 16, 2


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, **ops):
    """The least time the card could take: the larger of the bytes over the
    memory rate (each input read once, each output written once) and the
    operations over the peak rate of their type, summed over the types
    (``ops`` by type: f32=..., bf16=...).  No single PyTorch call
    computes any of the port's kernels' functions (additive scores are not
    scaled_dot_product_attention's form; the greedy head is a product with
    an argmax, max and logsumexp), so library_ms is null for each."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
            "bytes": n_bytes, "ops": sum(ops.values())}


def in_turns(calls):
    """Each of ``calls`` (name -> fn) timed in order and then in reverse
    order (a, b, b, a): two CUDA-event means a name, in one call."""
    times = {name: [] for name in calls}
    for name in [*calls, *reversed(calls)]:
        times[name].append(cuda_ms(calls[name]))
    return times


@contextlib.contextmanager
def wrapped(module, name, hook):
    """Within the block, module.name(*args, **kw) first calls hook(*args)."""
    fn = getattr(module, name)

    @functools.wraps(fn)  # with its attributes: fn counts its launches on its global name
    def wrapper(*args, **kw):
        hook(*args)
        return fn(*args, **kw)
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def patched(module, name, fn):
    """Within the block, module.name is fn."""
    before = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, before)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over ``iters`` launches, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    """Require CUDA, print the card, build the kernels; returns the card's
    name and power limit as nvidia-smi prints them."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from echr_tpu_torch.ops import native

    t0 = time.time()
    native.library()
    print(f"[1] kernels built in {time.time() - t0:.1f} s into {native.BUILD_DIR}")
    for line in native.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    ptxas:", line.strip())
    return card


def _windows_mask(rng, B, N, T, shuffle=False):
    """Sorted proposal windows drawn as bench.py draws them -> [B, N, T];
    with ``shuffle`` each video's windows in random order."""
    masks = np.zeros((B, N, T), np.float32)
    for b in range(B):
        starts = np.sort(rng.randint(0, T - 8, size=N))
        if shuffle:
            starts = rng.permutation(starts)
        lens = rng.randint(4, 48, size=N)
        ends = np.minimum(starts + lens, T)
        t = np.arange(T)[None, :]
        masks[b] = (t >= starts[:, None]) & (t < ends[:, None])
    return masks


def _mask_of_windows(B, N, T, soi):
    """[B, N, T] f32 mask of the windows soi [B, N, 2] (any order)."""
    t = np.arange(T)[None, None, :]
    return ((t >= soi[..., :1]) & (t < soi[..., 1:])).astype(np.float32)


# kernel 1's exactness cases: (B, N, T, H, mask kind)
SCORE_CASES = {
    "serving": (32, 128, 256, 512, "windows"),
    "ragged": (3, 120, 200, 500, "windows"),
    "all_masked": (2, 40, 96, 64, "none"),
    "all_unmasked": (2, 40, 96, 64, "all"),
    "unsorted": (4, 130, 256, 512, "unsorted"),
    "holes": (3, 77, 250, 300, "holes"),
}


def _case_mask(rng, kind, B, N, T):
    """windows: sorted, 4-47 frames (_windows_mask); unsorted: windows of
    1-120 frames in random order; holes: those with 30% of their frames
    masked out; none / all: every entry 0 / 1."""
    if kind == "windows":
        return _windows_mask(rng, B, N, T)
    if kind in ("none", "all"):
        return np.full((B, N, T), float(kind == "all"), np.float32)
    m = _mask_of_windows(B, N, T, _random_windows(rng, B, N, T, 120))
    return m * (rng.rand(B, N, T) > 0.3) if kind == "holes" else m


def score_case_inputs(rng, name, dev):
    """(pre, q, w, b, mask) of kernel 1's exactness case ``name``
    (SCORE_CASES), drawn from ``rng``: the mask first, then pre, q, w."""
    B, N, T, H, kind = SCORE_CASES[name]
    mask = torch.from_numpy(_case_mask(rng, kind, B, N, T)).to(dev)
    pre = _rand(rng, (B, T, H), 0.5, dev)
    q = _rand(rng, (B, N, H), 0.5, dev)
    return pre, q, _rand(rng, (H,), 0.05, dev), torch.tensor([0.25], device=dev), mask


def kernel1_check(name, args, want=None):
    """Kernel 1 on args (pre, q, w, b, mask) against its plain version
    (or ``want``): within TOL wherever mask == 1, masked entries 0.
    Returns (max |d| where mask == 1, the kernel's output)."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked

    return masked_check(1, attention_scores_masked, name, args, want)


def kernel3_check(name, args):
    """Kernel 3 on args (pre, q, w, b, mask), as kernel1_check: its plain
    version computes the scores everywhere, the kernel only at mask == 1."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_dense

    return masked_check(3, attention_scores_dense, name, args)


def masked_check(k, fn, name, args, want=None):
    from echr_tpu_torch.ops import force_plain

    got = fn(*args)
    torch.cuda.synchronize()
    if want is None:
        with force_plain():
            want = fn(*args)
    m = args[4] > 0
    err = float((got - want).abs()[m].max()) if bool(m.any()) else 0.0
    if bool(got[~m].ne(0).any()):
        fail(f"kernel {k} {name}: a masked entry is not 0")
    if not err <= TOL:
        fail(f"kernel {k} {name}: max|d| {err:.3e} > {TOL}")
    return err, got


def phase_scores(card):
    """Kernel 1 at every SCORE_CASES mask; at the serving shape also with
    every entry live, whose time gives the rate of its tanh (the floor of
    kernels 1, 3 and 4); then the tanh sweep."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked

    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    worst = 0.0
    for name, (B, N, T, H, kind) in SCORE_CASES.items():
        args = score_case_inputs(rng, name, dev)
        err, _ = kernel1_check(name, args)
        worst = max(worst, err)
        print(f"[2] scores {name} B={B} N={N} T={T} H={H} (mask density "
              f"{float(args[4].mean()):.3f}): max|d| where mask==1 {err:.3e}, masked entries 0")
        if name != "serving":
            continue
        record = kernel1_timing(card, "phase-2 synthetic windows", args)
        with force_plain():
            want = attention_scores_masked(*args)
        live = args[:4] + (torch.ones_like(args[4]),)
        err, _ = kernel1_check("serving, all live", live, want)
        worst = max(worst, err)
        all_live_ms = cuda_ms(lambda: attention_scores_masked(*live))
        record.update(all_live_ms=all_live_ms, tanh_per_ms=B * N * T * H / all_live_ms)
        print(f"[2] scores serving, every entry live: max|d| {err:.3e}; {all_live_ms:.4f} ms, "
              f"{record['tanh_per_ms'] / 1e6:.1f} M tanh a ms: the rate of the tanh-rate floors "
              f"of kernels 1, 3 and 4 [{card}]")
    record["max_abs_err"] = worst
    record["tanh_max_abs_err"] = tanh_sweep()
    return record


def tanh_sweep():
    """Kernel 1 at H=1 with w=1, q=0 and b=0 returns its tanh of pre
    exactly (its other lanes add 0): the device tanh in use, held to
    float64 over a dense sweep of [-10, 10] and of |x| from 1e-38 to 1,
    both signs (experiments/probe_tanh.sweep_error)."""
    from echr_tpu_torch.experiments.probe_tanh import TANH_TOL, sweep_error

    err, at, n = sweep_error(torch.device("cuda"))
    print(f"[2] tanh sweep, {n} points of [-10, 10] and +-[1e-38, 1]: max|tanh - tanh "
          f"(float64)| {err:.3e} at x = {at:.9g} (gate {TANH_TOL})")
    if not err <= TANH_TOL:
        fail(f"the device tanh is off by {err:.3e} > {TANH_TOL}")
    return err


def kernel1_tanh(mask, H):
    """Tanh per call of kernel 1 on ``mask`` [B, N, T] at width H, counted
    from the mask, not on the card: what the mask needs (live pairs x H);
    what this design evaluates by its rule (live pairs x H padded to its
    chunk of hidden units: 128, 256 or multiples of 512); what the earlier
    tiled design (kernel 1 before its lanes ran over hidden units)
    evaluated by its rule (16 rows x 32 frames x H for every 16 x 32 tile
    with a 1)."""
    live = mask.ne(0)
    B, N, T = live.shape
    pairs = int(live.sum())
    chunk = 128 if H <= 128 else 256 if H <= 256 else 512
    tiles = torch.nn.functional.pad(live.float(), (0, -T % 32, 0, -N % 16))
    tiles = tiles.reshape(B, -(-N // 16), 16, -(-T // 32), 32)
    return {"tanh_needed": pairs * H, "tanh_modelled": pairs * -(-H // chunk) * chunk,
            "tanh_modelled_tiled": int(tiles.amax(dim=(2, 4)).sum()) * 16 * 32 * H}


def kernel1_timing(card, name, args):
    """Kernel 1 at one input (pre, q, w, b, mask): held against its plain
    version (kernel1_check), its time and its plain version's, its
    live-work bound and its tanh."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked

    pre, q, mask = args[0], args[1], args[4]
    B, T, H = pre.shape
    N = q.shape[1]
    err, out = kernel1_check(name, args)
    work = kernel1_tanh(mask, H)
    # per live (n, t, h): add, tanh, multiply, add
    rec = {"B": B, "N": N, "T": T, "H": H, "density": work["tanh_needed"] / (mask.numel() * H),
           "max_abs_err": err, **work,
           **bound(nbytes(*args, out), f32=4.0 * work["tanh_needed"])}
    rec["ms"] = cuda_ms(lambda: attention_scores_masked(*args))
    with force_plain():
        rec["plain_ms"] = cuda_ms(lambda: attention_scores_masked(*args), iters=5)
    need = max(work["tanh_needed"], 1)
    print(f"[6] kernel 1, {name} B={B} N={N} T={T} H={H} (density {rec['density']:.3f}): "
          f"max|d| where mask==1 {err:.3e}; {rec['ms']:.4f} ms, plain version "
          f"{rec['plain_ms']:.4f} ms, live-work bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); tanh by the design's rule / needed "
          f"{work['tanh_modelled'] / need:.3f} (the earlier tiled design "
          f"{work['tanh_modelled_tiled'] / need:.3f}) [{card}]")
    return rec


def host_us(fn, calls=50):
    """Host time a call of fn() (the enqueue, without a synchronise), in
    microseconds, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def head_inputs(rng, R, C, V1, dtype, dev):
    """(out f32 [R, C], w [V1, C] in ``dtype``, b f32 [V1]); bf16 w padded
    to a multiple of 8 columns as prepare_head pads it."""
    from echr_tpu_torch.ops.kernel_head import pad_head_width

    out = torch.from_numpy(np.tanh(rng.randn(R, C)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(-0.1, 0.1, (V1, C)).astype(np.float32))
    b = torch.from_numpy((rng.randn(V1) * 0.1).astype(np.float32)).to(dev)
    w = w.to(dev).to(dtype)
    if dtype == torch.bfloat16:
        w = pad_head_width(w)
    return out, w.contiguous(), b


def head_check(tag, name, args):
    """Kernel 2 on args (out, w, b) against its plain version: the same
    token on every row whose top two logits are more than 1e-3 apart, max
    and logsumexp within TOL.  Returns (max |d|, the kernel's outputs)."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_head import greedy_head

    tok, mx, lse = outs = greedy_head(*args)
    torch.cuda.synchronize()
    with force_plain():
        ptok, pmx, plse = greedy_head(*args)
        C = args[0].shape[1]
        logits = torch.matmul(args[0].to(args[1].dtype).float(),
                              args[1][:, :C].float().t()) + args[2]
    top2 = torch.topk(logits, 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    bad = int((tok != ptok)[clear].sum())
    err = max(float((mx - pmx).abs().max()), float((lse - plse).abs().max()))
    print(f"[{tag}] head {name}: {bad} token mismatches on {int(clear.sum())}/{len(clear)} "
          f"rows with top-2 gap > 1e-3; max|d| max/lse {err:.3e}")
    if bad or not err <= TOL:
        fail(f"kernel 2 {name} disagrees with its plain version")
    return err, outs


def phase_head(card):
    from echr_tpu_torch.ops.kernel_head import greedy_head, split_plan

    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for name, (R, C, V1, dtype) in {
        "serving_bf16": (4096, 1536, 6001, torch.bfloat16),
        # the gate's cg pass: 32 videos x bucket 64 (another vocab split)
        "gate_cg_bf16": (2048, 1536, 6001, torch.bfloat16),
        "serving_f32": (4096, 1536, 6001, torch.float32),
        "ragged_bf16": (1000, 200, 777, torch.bfloat16),
        "ragged_unaligned_bf16": (77, 36, 130, torch.bfloat16),
        "ragged_f32": (77, 36, 130, torch.float32),
        "ragged_unaligned_f32": (33, 30, 70, torch.float32),
    }.items():
        args = head_inputs(rng, R, C, V1, dtype, dev)
        err, outs = head_check("3", f"{name} ({split_plan(R, V1, sms, dtype)[1]} splits)",
                               args)
        worst = max(worst, err)
        if name == "serving_bf16":
            record = head_timing(card, args, outs, split_plan(R, V1, sms, dtype))

    # exact ties from integer-valued sums: columns 3 and 11 in one thread's
    # columns of the first tile, 5 in another thread's, 300 in the second
    # tile, 1031 and 2000 in later ones.  At 64 rows every tile is a vocab
    # split of its own; at 4096 rows (4 splits in bf16, 8 in f32) 300 shares
    # a split with the first tile in bf16.  The first index wins.
    C, V1 = 16, 2048
    w = torch.zeros(V1, C)
    for col in (3, 5, 11, 300, 1031, 2000):
        w[col] = 1.0
    for R in (64, 4096):
        for dtype in (torch.bfloat16, torch.float32):
            tok, mx, _ = greedy_head(torch.ones(R, C, device=dev),
                                     w.to(dev).to(dtype).contiguous(),
                                     torch.zeros(V1, device=dev))
            if not (bool((tok == 3).all()) and bool((mx == C).all())):
                fail(f"kernel 2 tie (R={R}, {dtype}): tokens {tok.unique().tolist()}")
    print("[3] head ties: the first index wins (bf16, f32; within a tile, across tiles and "
          "across splits)")
    record["max_abs_err"] = worst
    return record


def head_timing(card, args, outs, plan, tag="6"):
    """Kernel 2 on bf16 core outputs (the cast is not timed) in turns with
    the bare bf16 product over the same out and w, unpadded and with the
    vocab padded to a multiple of 8; its plain version; its host time a
    call (the tensor maps are encoded per call)."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_head import greedy_head

    out, w, b = args
    R, C = out.shape
    V1 = w.shape[0]
    a = out.to(torch.bfloat16)
    w8 = torch.nn.functional.pad(w, (0, 0, 0, -V1 % 8))
    turns = in_turns({"kernel": lambda: greedy_head(a, w, b),
                      "matmul": lambda: torch.matmul(a, w.t()),
                      "matmul_vocab_pad8": lambda: torch.matmul(a, w8.t())})
    mean = {k: sum(v) / 2 for k, v in turns.items()}
    with force_plain():
        plain_ms = cuda_ms(lambda: greedy_head(a, w, b), iters=10)
    record = {"ms": mean["kernel"], "plain_ms": plain_ms, "turns_ms": turns,
              "matmul_ms": mean["matmul"], "matmul_vocab_pad8_ms": mean["matmul_vocab_pad8"],
              "host_us_per_call": host_us(lambda: greedy_head(a, w, b)),
              "tiles_per_split": plan[0], "splits": plan[1],
              **bound(nbytes(a, w, b, *outs), bf16=2.0 * R * C * V1)}
    print(f"[{tag}] head kernel " + ", ".join(f"{k} {x:.4f} / {y:.4f}" for k, (x, y) in turns.items())
          + f" ms in turns (R={R} C={C} V1={V1} bf16, {plan[1]} splits of {plan[0]} tiles; "
          f"kernel {2 * R * C * V1 / record['ms'] / 1e9:.1f} TFLOP/s); plain {plain_ms:.4f} ms; "
          f"bound {record['bound_ms']:.4f} ms ({record['bound_by']}); host "
          f"{record['host_us_per_call']:.1f} us a call [{card}]")
    return record


def flagship_cfg(**runtime):
    from echr_tpu_torch.config import flagship_config

    cfg = flagship_config()
    cfg = cfg.replace_in("data", lda_dim=100, time_buckets=(T_BUCKET,))
    cfg = cfg.replace_in("decoder", CG_vocab_size=VOCAB, CG_seq_length=SEQ_LEN)
    if runtime:
        cfg = cfg.replace_in("runtime", **runtime)
    return cfg.validate()


def requests(n, seed):
    from echr_tpu_torch.serve import CaptionRequest

    rng = np.random.RandomState(seed)
    base = rng.randn(T_BUCKET, VIDEO_DIM).astype(np.float32) * 0.5
    return [CaptionRequest(vid=f"v{i}", duration=120.0 + i,
                           feats=base + 0.3 * rng.randn(T_BUCKET, VIDEO_DIM).astype(np.float32),
                           lda=rng.randn(100).astype(np.float32))
            for i in range(n)]


def check_captions(res, reqs, ties=False):
    """Every request captioned, TOP_N captions each (with ``ties``, also
    more: proposals tied at the top-N threshold are all kept, as in
    echr_tpu, so every caption past the TOP_N-th scores exactly the TOP_N-th
    largest proposal score), well-formed timestamps, scores and
    sentences."""
    if sorted(res) != sorted(r.vid for r in reqs):
        fail("not every request was captioned")
    for r in reqs:
        caps = res[r.vid]
        scores = sorted((c.proposal_score for c in caps), reverse=True)
        tied = len(caps) > TOP_N and all(x == scores[TOP_N - 1] for x in scores[TOP_N:])
        if not (len(caps) == TOP_N or ties and tied):
            fail(f"{r.vid}: {len(caps)} captions, expected {TOP_N}"
                 + (" and threshold ties past it" if ties else "")
                 + f"; scores from the {TOP_N}-th on {scores[TOP_N - 1:TOP_N + 3]}")
        for c in caps:
            s, e = c.timestamp
            if not (0.0 <= s < e <= r.duration + 1e-6 and 0.0 <= c.proposal_score <= 1.0
                    and np.isfinite(c.sentence_confidence) and c.sentence_confidence <= 0.0):
                fail(f"{r.vid}: malformed caption {c}")
            if any(not w.startswith("w") for w in c.sentence.split()):
                fail(f"{r.vid}: sentence outside the vocab: {c.sentence!r}")


def phase_slice(card):
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.ops.kernel_recurrence import lstm_recurrence
    from echr_tpu_torch.serve import CaptionService

    cfg = flagship_cfg()
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    chunk = 32
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=chunk, topN=TOP_N)
    reqs = requests(64, seed=2)
    # warm-up (cuBLAS handles, allocator), keeping kernel 1's inputs of one step
    step_args = first_scores_args(svc, reqs[:32])

    attention_scores_masked.launches = 0
    greedy_head.launches = 0
    decoder_sample_batched.steps = 0
    decoder_sample_batched.host_syncs = 0
    k11_before = lstm_recurrence.launches
    t0 = time.time()
    res = svc.caption(reqs)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {"attention_scores_masked": attention_scores_masked.launches,
                "greedy_head": greedy_head.launches}
    steps = decoder_sample_batched.steps
    k11 = lstm_recurrence.launches - k11_before
    if k11 != cfg.tap.rnn_num_layers * -(-len(reqs) // chunk):
        fail(f"kernel 11 launched {k11} times for {len(reqs)} videos in chunks of {chunk}: "
             f"not once a chunk and SST layer")

    n_caps = sum(len(c) for c in res.values())
    check_captions(res, reqs)
    if not (steps > 0 and launches["attention_scores_masked"] == steps
            and launches["greedy_head"] == steps):
        fail(f"kernel launches {launches} do not match the {steps} decode steps run")
    print(f"[4] slice: {len(res)} videos, {n_caps} captions, {steps} decode steps, "
          f"{decoder_sample_batched.host_syncs} early-exit syncs, launches {launches}, "
          f"kernel 11 {k11}; "
          f"e.g. {res['v0'][0]}")
    print(f"[6] slice {n_caps / dt:.1f} captions/s ({len(reqs)} videos x {TOP_N} proposals "
          f"in {dt:.3f} s, bf16 compute, batch 32) [{card}]")
    return launches, tap, cg, vocab, step_args


def first_scores_args(svc, reqs):
    """svc.caption(reqs) with a wrapper on kernel 1 that keeps the inputs
    of its first call, the first decode step's: (pre, q, w, b, mask)."""
    from echr_tpu_torch.ops import attention as attention_ops

    kept = []

    def keep_first(*args):
        if not kept:
            kept.append(tuple(a.detach().clone() for a in args))
    with wrapped(attention_ops, "attention_scores_masked", keep_first):
        svc.caption(reqs)
    torch.cuda.synchronize()
    return kept[0]


def phase_parity(tap, cg, vocab):
    from echr_tpu_torch.engine.steps import decode_step_batched
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.serve import CaptionService

    cfg = flagship_cfg(compute_dtype="float32")
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(8.0)  # sharpen: argmax margins >> f32 noise
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=8, topN=TOP_N)
    _, _, args = svc.prepare_chunk(requests(8, seed=3), T_BUCKET)
    seq_k, lp_k, _ = decode_step_batched(*args)
    with force_plain():
        seq_p, lp_p, _ = decode_step_batched(*args)
    bad = int((seq_k != seq_p).sum())
    err = float((lp_k - lp_p).abs().max())
    print(f"[5] f32 slice, kernels vs plain: {bad} token mismatches of {seq_k.numel()}, "
          f"max|d| logps {err:.3e}, {int((seq_k > 0).sum())} non-EOS tokens")
    if bad or not err <= TOL:
        fail("the slice with the kernels disagrees with its plain version")


def caption_service(beam_size=BEAM, **runtime):
    """The serving slice at the flagship width, bf16, from the port's
    seeded init: CaptionService(beam_size), 32 videos a chunk (greedy at
    beam_size 1); ``runtime`` overrides cfg.runtime fields."""
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.serve import CaptionService

    cfg = flagship_cfg(**runtime)
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    return CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=32, topN=TOP_N,
                          beam_size=beam_size)


@torch.inference_mode()
def beam_step_tensors(svc, sort=True):
    """The beam path's decode-step tensors for 32 requests: make_contexts,
    the window sort (unless ``sort`` is false), _expand_ctxs(k=4),
    precompute_attention and init_state, then the <bos> step, whose hidden
    state is step 1's query.  B=32, N*k=512 rows, T=256, Hatt=512, D=500,
    bf16 compute."""
    from echr_tpu_torch.models.beam import _expand_ctxs
    from echr_tpu_torch.models.captioner import make_contexts
    from echr_tpu_torch.models.decoder import (ctxs_soi, init_state, precompute_attention,
                                               sort_ctxs_by_window, step_core_out)
    from echr_tpu_torch.ops.core import dense

    bf16 = torch.bfloat16
    _, nb, (cg, cfg, tap_feats, feats, lda, fm, props) = svc.prepare_chunk(
        requests(32, seed=5), T_BUCKET)
    ctxs = make_contexts(cg, cfg, tap_feats, feats, lda, props, frame_mask=fm)
    if sort:
        ctxs, _ = sort_ctxs_by_window(ctxs)
    bctx = _expand_ctxs(ctxs, BEAM)
    dec = cg.decoder
    pre = precompute_attention(dec, cfg, bctx, bf16)
    state = init_state(dec, cfg, bctx, nb * BEAM, bf16)
    bos = torch.zeros(feats.shape[0], nb * BEAM, dtype=torch.int32, device=feats.device)
    _, state = step_core_out(dec, cfg, bos, bctx, pre, state, bf16)
    att = dec.core.attention
    h = state.h[1]
    return {"att": att, "h": h, "pre": pre.att.contiguous(),
            "q": dense(att.h2att, h, bf16).contiguous(),
            "w": att.alpha_net.weight.reshape(-1).contiguous(), "b": att.alpha_net.bias,
            "mask": bctx.clip_mask.contiguous(), "feats": bctx.clip_feats.contiguous(),
            "soi": ctxs_soi(bctx).to(torch.int32).contiguous()}


def kernel1_route(t):
    """The route the decode path takes now: kernel 1, masked_softmax and the
    bf16 AV product."""
    from echr_tpu_torch.ops.core import matmul, round_to
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.masked import masked_softmax

    bf16 = torch.bfloat16
    s = attention_scores_masked(t["pre"], t["q"], t["w"], t["b"], t["mask"])
    return matmul(round_to(masked_softmax(s, t["mask"]), bf16), round_to(t["feats"], bf16), bf16)


def short_windows(t):
    """t with short windows in place of the random-init SST's long ones:
    sorted starts and 4-47 frames as bench.py draws them (phase 2's mask
    density, ~0.1), each proposal's window repeated for its k beams."""
    from echr_tpu_torch.ops.masked import segment_window_mask

    rng = np.random.RandomState(10)
    B, N = t["soi"].shape[:2]
    T = t["pre"].shape[1]
    s = np.sort(rng.randint(0, T - 8, size=(B, N // BEAM)), axis=1)
    e = np.minimum(s + rng.randint(4, 48, size=s.shape), T)
    soi = torch.from_numpy(np.stack([s, e], -1).astype(np.int32)).to(t["pre"].device)
    soi = soi.repeat_interleave(BEAM, dim=1).contiguous()
    return {**t, "soi": soi, "mask": segment_window_mask(soi, T).contiguous()}


def step_inputs(args):
    """The attention step's tensors of a decode step kept by
    kept_attention_calls, (pre, q, w, b, mask, feats), as a dict with each
    row's window soi [B, N, 2] int32 taken from its mask, as ctxs_soi takes
    it (first live frame, last live frame + 1; a row without one gets
    [T, 0), a zero-length window)."""
    pre, q, w, b, mask, feats = args
    T = mask.shape[-1]
    idx = torch.arange(T, device=mask.device)
    live = mask > 0
    soi = torch.stack([torch.where(live, idx, T).amin(-1), torch.where(live, idx + 1, 0).amax(-1)],
                      -1)
    return {"pre": pre.float().contiguous(), "q": q.float().contiguous(), "w": w.contiguous(),
            "b": b.contiguous(), "mask": mask.float().contiguous(),
            "feats": feats.float().contiguous(), "soi": soi.to(torch.int32).contiguous()}


@contextlib.contextmanager
def kept_attention_calls(kept, keep_if):
    """Within the block, every kernel-1 call of the decoder's attention whose
    arguments (pre, q, w, b, mask) pass keep_if(args) appends copies of
    (pre, q, w, b, mask, feats) to ``kept``: the feats are those of the
    enclosing decoder.additive_attention_step."""
    from echr_tpu_torch.models import decoder
    from echr_tpu_torch.ops import attention as attention_ops

    feats = []

    def note(*a):
        feats[:] = [a[2]]

    def keep(*a):
        if keep_if(a):
            kept.append(tuple(x.detach().clone() for x in (*a, feats[0])))
    with wrapped(decoder, "additive_attention_step", note), \
            wrapped(attention_ops, "attention_scores_masked", keep):
        yield kept


def _random_windows(rng, B, N, T, max_len):
    s = rng.randint(0, T - 1, size=(B, N))
    e = np.minimum(s + rng.randint(1, max_len + 1, size=(B, N)), T)
    return np.stack([s, e], -1).astype(np.int32)


def attention_step_record(card, k, tag, name, t, host=False):
    """Kernel 5 (k=5) or 6 (k=6) on one input t (step_inputs' keys; kernel 6
    takes the windows t["soi"], kernel 5 the mask): held against its plain
    version (FUSED_TOL, or TOL), rows without a live frame exact zeros,
    then timed in turns with the kernel-1 route, beside its plain
    version's time, its bound and the tanh it needs; with ``host`` also the
    host time a call of both.  Returns the record."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention_step import attention_fused, windowed_attention

    B, T, H = t["pre"].shape
    N, D = t["q"].shape[1], t["feats"].shape[2]
    if k == 5:
        args = (t["pre"], t["q"], t["w"], t["b"], t["mask"], t["feats"])
        fn, gate = (lambda: attention_fused(*args)), FUSED_TOL
        live = t["mask"] > 0
        pairs = float(live.sum())
        empty = ~live.any(-1)
        # per live (n, t, h): add, tanh, multiply, add in f32; per live (n, t, d): a
        # multiply-add of bf16 operands, which tensor cores take at the bf16 rate
        ops = {"f32": pairs * 4.0 * H, "bf16": pairs * 2.0 * D}
    else:
        args = (t["pre"], t["feats"], t["q"], t["w"], t["b"], t["soi"])
        fn, gate = (lambda: windowed_attention(*args, W=WINDOW)), TOL
        lens = (t["soi"][..., 1].clamp(max=T) - t["soi"][..., 0].clamp(min=0)).clamp(min=0)
        pairs = float(lens.sum())
        empty = lens == 0
        ops = {"f32": pairs * (4.0 * H + 2.0 * D)}
    got = fn()
    with force_plain():
        want = fn()
    err = float((got - want).abs().max())
    if not err <= gate:
        fail(f"kernel {k}, {name}: max|d| {err:.3e} > {gate}")
    if bool(got[empty].ne(0).any()):
        fail(f"kernel {k}, {name}: a row without a live frame is not zero")
    turns = in_turns({"kernel": fn, "route": lambda: kernel1_route(t)})
    (k1, k2), (r1, r2) = turns["kernel"], turns["route"]
    with force_plain():
        plain_ms = cuda_ms(fn, iters=3, warmup=1)
    rec = {"B": B, "N": N, "T": T, "H": H, "D": D, "density": pairs / (B * N * T),
           "empty_rows": int(empty.sum()), "max_abs_err": err, "ms": (k1 + k2) / 2,
           "turns_ms": [k1, k2], "kernel1_route_ms": (r1 + r2) / 2, "route_turns_ms": [r1, r2],
           "plain_ms": plain_ms, "tanh_needed": pairs * H, **bound(nbytes(*args, got), **ops)}
    line = (f"[{tag}] kernel {k}, {name} B={B} N={N} T={T} H={H} D={D} (density "
            f"{rec['density']:.3f}, rows without a live frame: {rec['empty_rows']}): max|d| "
            f"{err:.3e}; "
            f"kernel {k1:.4f}, {k2:.4f} ms vs the kernel-1 route {r1:.4f}, {r2:.4f} ms (in "
            f"turns) vs plain {plain_ms:.4f} ms; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
    if host:
        rec.update(host_us=host_us(fn), route_host_us=host_us(lambda: kernel1_route(t)))
        line += f"; host {rec['host_us']:.1f} us a call, the route {rec['route_host_us']:.1f} us"
    print(line + f" [{card}]")
    return rec


def step_records(card, tag, name, t, host=False):
    """Kernels 5 and 6 at one decode step's input (attention_step_record),
    keyed by kernel name; the windows' contiguity printed beside."""
    from echr_tpu_torch.ops.masked import segment_window_mask

    same = bool(segment_window_mask(t["soi"], t["pre"].shape[1]).eq(t["mask"]).all())
    print(f"[{tag}] {name}: the mask is its rows' [s, e) windows: {same}")
    return {"attention_fused": attention_step_record(card, 5, tag, name, t, host),
            "windowed_attention": attention_step_record(card, 6, tag, name, t, host)}


@torch.inference_mode()
def phase_fused(card, t):
    """Kernel 5 through additive_attention_step(fused=True) once, then on
    the beam path's step tensors and on a ragged shape with D > 512 and a
    fully-masked row against its plain version (atol 2e-3); timed at the
    beam step and at short windows beside the kernel-1 route's."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.attention import additive_attention_step
    from echr_tpu_torch.ops.kernel_attention_step import attention_fused
    from echr_tpu_torch.ops.masked import segment_window_mask

    attention_fused.launches = 0
    res, weights = additive_attention_step(t["att"], t["h"], t["feats"], t["pre"], t["mask"],
                                           torch.bfloat16, use_kernel=True, fused=True)
    torch.cuda.synchronize()
    launches = attention_fused.launches
    if launches != 1 or weights is not None:
        fail(f"additive_attention_step(fused=True) launched kernel 5 {launches} times")
    args = (t["pre"], t["q"], t["w"], t["b"], t["mask"], t["feats"])
    got = attention_fused(*args)
    route_err = float((got - kernel1_route(t)).abs().max())
    print(f"[11] fused step: entry point launches {launches}; at the beam step max|d| vs the "
          f"kernel-1 route, which rounds the normalised weights instead, {route_err:.3e}")

    rng = np.random.RandomState(8)
    dev = t["pre"].device
    Br, Nr, Tr, Hr, Dr = 3, 77, 200, 500, 700
    soi = torch.from_numpy(_random_windows(rng, Br, Nr, Tr, 60)).to(dev)
    mask = segment_window_mask(soi, Tr).contiguous()
    mask[1, 5] = 0.0  # a fully-masked row
    rargs = (_rand(rng, (Br, Tr, Hr), 0.5, dev), _rand(rng, (Br, Nr, Hr), 0.5, dev),
             _rand(rng, (Hr,), 0.05, dev), torch.tensor([0.25], device=dev), mask,
             _rand(rng, (Br, Tr, Dr), 1.0, dev))
    rgot = attention_fused(*rargs)
    with force_plain():
        rwant = attention_fused(*rargs)
    rerr = float((rgot - rwant).abs().max())
    print(f"[11] fused step ragged B={Br} N={Nr} T={Tr} H={Hr} D={Dr}: max|d| {rerr:.3e}; "
          f"fully-masked row max|out| {float(rgot[1, 5].abs().max()):.1e}")
    if not rerr <= FUSED_TOL or bool(rgot[1, 5].ne(0).any()):
        fail(f"kernel 5 ragged: max|d| {rerr:.3e}, or a fully-masked row is not zero")

    by_input = {"beam_step": attention_step_record(card, 5, 11, "the beam step", t),
                "beam_step_short_windows": attention_step_record(
                    card, 5, 11, "the beam step, short windows", short_windows(t))}
    worst = max(rerr, *(r["max_abs_err"] for r in by_input.values()))
    return {"launches": launches,
            "launches_by_path": {"additive_attention_step(fused=True), phase 11": launches},
            **by_input["beam_step"], "max_abs_err": worst, "by_input": by_input}


@torch.inference_mode()
def phase_windowed(card, t):
    """Kernel 6 once, then on the beam path's step tensors with the sorted
    windows and W=64 against its plain version (atol 5e-4), with
    zero-length windows, windows that end at T and a ragged shape; timed at
    the beam step and at short windows beside the kernel-1 route's."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention_step import windowed_attention

    def check(name, args, zero_rows=None):
        got = windowed_attention(*args, W=WINDOW)
        with force_plain():
            want = windowed_attention(*args, W=WINDOW)
        err = float((got - want).abs().max())
        lens = (args[5][..., 1].clamp(max=args[0].shape[1]) - args[5][..., 0]).clamp(min=0)
        print(f"[12] windowed {name} B={args[0].shape[0]} N={args[2].shape[1]} "
              f"T={args[0].shape[1]} H={args[0].shape[2]} D={args[1].shape[2]}: max|d| "
              f"{err:.3e}; window lengths mean {float(lens.float().mean()):.1f}, max "
              f"{int(lens.max())}, {float((lens > WINDOW).float().mean()):.3f} longer than W")
        if not err <= TOL:
            fail(f"kernel 6 {name}: max|d| {err:.3e} > {TOL}")
        if zero_rows is not None and bool(got[zero_rows].ne(0).any()):
            fail(f"kernel 6 {name}: a zero-length window is not zero")
        return err

    args = (t["pre"], t["feats"], t["q"], t["w"], t["b"], t["soi"])
    windowed_attention.launches = 0
    windowed_attention(*args, W=WINDOW)
    torch.cuda.synchronize()
    launches = windowed_attention.launches
    if launches != 1:
        fail(f"windowed_attention launched kernel 6 {launches} times")

    soi = t["soi"].clone()
    T = t["pre"].shape[1]
    zero = torch.zeros_like(soi[..., 0], dtype=torch.bool)
    zero[:, ::7] = True
    soi[:, ::7, 1] = soi[:, ::7, 0]  # zero-length windows
    soi[:, 3::7, 1] = T  # windows that end at T
    worst = check("edges", args[:5] + (soi.contiguous(),), zero)

    rng = np.random.RandomState(9)
    dev = t["pre"].device
    Br, Nr, Tr, Hr, Dr = 3, 50, 200, 500, 300
    rsoi = torch.from_numpy(_random_windows(rng, Br, Nr, Tr, 120)).to(dev)
    rargs = (_rand(rng, (Br, Tr, Hr), 0.5, dev), _rand(rng, (Br, Tr, Dr), 1.0, dev),
             _rand(rng, (Br, Nr, Hr), 0.5, dev), _rand(rng, (Hr,), 0.05, dev),
             torch.tensor([0.25], device=dev), rsoi)
    worst = max(worst, check("ragged", rargs))

    by_input = {"beam_step": attention_step_record(card, 6, 12, "the beam step", t),
                "beam_step_short_windows": attention_step_record(
                    card, 6, 12, "the beam step, short windows", short_windows(t))}
    worst = max(worst, *(r["max_abs_err"] for r in by_input.values()))
    return {"launches": launches, "launches_by_path": {"windowed_attention, phase 12": launches},
            **by_input["beam_step"], "max_abs_err": worst, "by_input": by_input}


def phase_beam(card, svc):
    """The beam slice: CaptionService(beam_size=4) captions 64 requests
    (two chunks of 32 videos, top-128 proposals: 16384 beam rows a chunk)
    after one warm-up chunk.  Kernel 1's launches must equal the beam steps
    run, the <bos> steps included."""
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked

    reqs = requests(64, seed=6)
    svc.caption(reqs[:32])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention_scores_masked.launches = 0
    beam_search_batched.steps = 0
    beam_search_batched.host_syncs = 0
    t0 = time.time()
    res = svc.caption(reqs)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = attention_scores_masked.launches
    steps, syncs = beam_search_batched.steps, beam_search_batched.host_syncs
    peak = torch.cuda.max_memory_allocated()
    # seeded init leaves many proposal scores near 0.5, so one can tie the
    # TOP_N-th exactly; the tie is kept, as in echr_tpu
    check_captions(res, reqs, ties=True)
    if not (steps > 0 and launches == steps):
        fail(f"kernel 1 launched {launches} times in {steps} beam steps")
    n_caps = sum(len(c) for c in res.values())
    print(f"[13] beam slice: {len(res)} videos, {n_caps} captions, beam {BEAM}, {steps} beam "
          f"steps (the <bos> steps included), {syncs} early-exit syncs, kernel 1 launches "
          f"{launches}; e.g. {res['v0'][0]}")
    print(f"[13] beam {n_caps / dt:.1f} captions/s, {1000 * dt / 2:.1f} ms per chunk of 32 "
          f"videos x {TOP_N} proposals x {BEAM} beams, peak device memory {peak / 2**30:.2f} GiB, "
          f"bf16 compute [{card}]")
    profile = beam_profile(card, svc, reqs[:32])
    return {"attention_scores_masked": launches, "kernel1_profile": profile}


def beam_profile(card, svc, chunk):
    """Device kernel time of one chunk's beam decode under torch.profiler,
    beside its host-clock time; returns kernel 1's device ms over the chunk
    and its launches there (None when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from echr_tpu_torch.engine.steps import beam_decode_step_batched
    from echr_tpu_torch.models.beam import beam_search_batched

    _, _, args = svc.prepare_chunk(chunk, T_BUCKET)
    torch.cuda.synchronize()
    steps0 = beam_search_batched.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        beam_decode_step_batched(*args, BEAM, length_alpha=svc.cfg.eval.beam_length_alpha)
        torch.cuda.synchronize()
        wall = time.time() - t0
    steps = beam_search_batched.steps - steps0
    def dev_time(e):  # the name before torch 2.4: self_cuda_time_total
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(dev_time(e) for e in events)
    if not dev_us:
        print(f"[13] beam decode profile: device time not measured (no CUDA events) [{card}]")
        return None
    top = sorted(events, key=lambda e: -dev_time(e))[:10]
    print(f"[13] beam decode of one chunk under the profiler: wall {1000 * wall:.1f} ms, "
          f"device kernel time {dev_us / 1000:.1f} ms over {steps} steps "
          f"({dev_us / 1000 / steps:.3f} ms a step, busy {dev_us / 1e6 / wall:.3f}) [{card}]")
    for e in top:
        print(f"     {dev_time(e) / 1000:9.2f} ms {e.count:6d}x {e.key[:90]}")
    k1 = [e for e in events if "masked_scores_kernel" in e.key]
    k1_ms = sum(dev_time(e) for e in k1) / 1000
    k1_n = sum(e.count for e in k1)
    print(f"[13] kernel 1 under the profiler: {k1_ms:.2f} ms of device time over the chunk, "
          f"{k1_n} launches, {k1_ms / max(k1_n, 1):.4f} ms each [{card}]")
    return {"device_ms_per_chunk": k1_ms, "launches": k1_n}


@torch.inference_mode()
def phase_beam_parity(tap, cg, vocab):
    """f32, TF32 off, phase 5's 8 requests and sharpened weights: beam 4
    with the kernels and under force_plain() gives identical tokens for
    every beam and best logprobs within 5e-4.  Then beam 1 against greedy
    decode, with the logit weights sharpened 16x more: beam 1 ranks
    score + logprob, and at phase 5's weights a summed score near -240 has
    a ulp of 1.5e-5, so candidates closer than that tie and the lower index
    wins where greedy takes the larger (echr_tpu's beam does the same).
    Peaked weights keep the scores near 0."""
    from echr_tpu_torch.engine.steps import beam_decode_step_batched, decode_step_batched
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.models.captioner import make_contexts
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.serve import CaptionService

    cfg = flagship_cfg(compute_dtype="float32")
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=8, topN=TOP_N,
                         beam_size=BEAM)
    _, _, args = svc.prepare_chunk(requests(8, seed=3), T_BUCKET)
    cgm, cfg, tap_feats, feats, lda, fm, props = args
    ctxs = make_contexts(cgm, cfg, tap_feats, feats, lda, props, frame_mask=fm)
    alpha = cfg.eval.beam_length_alpha
    got = beam_search_batched(cgm.decoder, cfg, ctxs, BEAM, alpha)
    with force_plain():
        want = beam_search_batched(cgm.decoder, cfg, ctxs, BEAM, alpha)
    bad = int((got.all_seqs != want.all_seqs).sum())
    err = float((got.all_logprobs - want.all_logprobs).abs().max())
    print(f"[14] f32 beam {BEAM}, kernels vs plain: {bad} token mismatches of "
          f"{got.all_seqs.numel()} (every beam), max|d| beam logprobs {err:.3e}, "
          f"{int((got.seq > 0).sum())} non-EOS tokens")
    if bad or not err <= TOL:
        fail("f32 beam search with the kernels disagrees with its plain version")
    cgm.decoder.logit.weight.mul_(16.0)
    seq1, lp1 = beam_decode_step_batched(*args, 1)
    seqg, _, _ = decode_step_batched(*args)
    real = props.prop_mask > 0
    bad1 = int((seq1 != seqg)[real].sum())
    print(f"[14] beam 1 vs greedy, weights sharpened 16x more: {bad1} token mismatches on "
          f"{int(real.sum())} real proposals, {int((seqg > 0)[real].sum())} non-EOS greedy "
          f"tokens, best-beam logprobs down to {float(lp1[real].min()):.3e}")
    if bad1:
        fail("beam 1 does not give the greedy tokens")

def _rand(rng, shape, scale, dev):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def _score_inputs(rng, B, N, T, H, dev):
    return (_rand(rng, (B, T, H), 0.5, dev), _rand(rng, (B, N, H), 0.5, dev),
            _rand(rng, (H,), 0.05, dev), torch.tensor([0.25], device=dev))


TRAIN_SHAPES = {"training": (TRAIN_B, TRAIN_N, T_BUCKET, 512), "ragged": (3, 60, 200, 500)}


def kernel3_timing(card, name, raws, tag="7"):
    """Kernel 3 over a list of inputs (pre, q, w, b, mask), each held
    against its plain version where mask == 1 (kernel3_check): ms a call
    and the plain version's (the means over the list), its bound over the
    live (n, t) and the tanh they need."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_dense

    pre, q = raws[0][0], raws[0][1]
    B, T, H = pre.shape
    N = q.shape[1]
    outs, err = [], 0.0
    for raw in raws:
        e, out = kernel3_check(name, raw)
        err = max(err, e)
        outs.append(out)
    live = sum(int(raw[4].ne(0).sum()) for raw in raws) / len(raws)
    n_bytes = sum(nbytes(*raw, out) for raw, out in zip(raws, outs)) / len(raws)
    del outs
    # per live (n, t, h): add, tanh, multiply, add
    rec = {"B": B, "N": N, "T": T, "H": H, "calls": len(raws), "density": live / (B * N * T),
           "max_abs_err": err, "tanh_needed": live * H, **bound(n_bytes, f32=4.0 * live * H)}
    rec["ms"] = cuda_ms(lambda: [attention_scores_dense(*raw) for raw in raws]) / len(raws)
    with force_plain():
        rec["plain_ms"] = cuda_ms(lambda: [attention_scores_dense(*raw) for raw in raws],
                                  iters=3, warmup=1) / len(raws)
    print(f"[{tag}] kernel 3, {name} B={B} N={N} T={T} H={H} (density {rec['density']:.4f}"
          f"{f', mean of {len(raws)} calls' if len(raws) > 1 else ''}): max|d| where mask==1 "
          f"{err:.3e}, masked entries 0; {rec['ms']:.4f} ms a call, plain version "
          f"{rec['plain_ms']:.4f} ms, live-work bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) [{card}]")
    return rec


def kernel3_inputs(rng, dev):
    """Phase 7's inputs (pre, q, w, b, mask): the training shapes with every
    entry live and with windows of 4-47 frames in random order (one draw
    of pre, q, w), and a ragged shape with unsorted windows of 1-120."""
    B, N, T, H = TRAIN_SHAPES["training"]
    args = _score_inputs(rng, B, N, T, H, dev)
    windows = torch.from_numpy(_windows_mask(rng, B, N, T, shuffle=True)).to(dev)
    Br, Nr, Tr, Hr = TRAIN_SHAPES["ragged"]
    ragged = _score_inputs(rng, Br, Nr, Tr, Hr, dev)
    rmask = torch.from_numpy(_case_mask(rng, "unsorted", Br, Nr, Tr)).to(dev)
    return {"all_live": args + (torch.ones(B, N, T, device=dev),),
            "windows": args + (windows,), "ragged": ragged + (rmask,)}


def phase_scores_dense(card):
    """Kernel 3 against its plain version where mask == 1, masked entries
    exactly 0 (kernel3_inputs); its time with every entry live (the
    no-regression case) and at the windows."""
    inputs = kernel3_inputs(np.random.RandomState(4), torch.device("cuda"))
    err, _ = kernel3_check("ragged", inputs["ragged"])
    (B, T, H), N = inputs["ragged"][0].shape, inputs["ragged"][1].shape[1]
    print(f"[7] kernel 3, ragged B={B} N={N} T={T} H={H}, unsorted windows (density "
          f"{float(inputs['ragged'][4].mean()):.3f}): max|d| where mask==1 {err:.3e}, masked "
          f"entries 0")
    record = kernel3_timing(card, "training shapes, every entry live", [inputs["all_live"]])
    record["windows"] = kernel3_timing(card, "training shapes, windows of 4-47 frames in "
                                       "random order", [inputs["windows"]])
    record["max_abs_err"] = max(err, record["max_abs_err"], record["windows"]["max_abs_err"])
    return record


def _bwd_check(name, args, g):
    """Kernel 4 through attention_scores_diff against the autograd of the
    plain forward: d_pre and d_q at atol 2e-4, rtol 1e-4 (the JAX
    package's gate for its backward kernel); d_w and d_b are each a sum of
    B*N*T = 524k terms at the training shapes, so they are held to 1e-4 of
    their largest entry.  Returns the worst d_pre / d_q error."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_dense_plain, attention_scores_diff

    leaves = [a.clone().requires_grad_() for a in args]
    # every entry live: the forward's masked entries are not under test here
    attention_scores_diff(*leaves, torch.ones_like(g)).backward(g)
    got = [x.grad for x in leaves]
    torch.cuda.synchronize()
    ref = [a.clone().requires_grad_() for a in args]
    attention_scores_dense_plain(*ref).backward(g)
    want = [x.grad for x in ref]
    worst = 0.0
    for key, a, b in zip(("d_pre", "d_q", "d_w", "d_b"), got, want):
        err = float((a - b).abs().max())
        if key in ("d_pre", "d_q"):
            ok = bool(((a - b).abs() <= 2e-4 + 1e-4 * b.abs()).all())
            worst = max(worst, err)
        else:
            ok = err <= 1e-4 * float(b.abs().max())
        print(f"[8] scores backward {name} {key}: max|d| {err:.3e} "
              f"(max|ref| {float(b.abs().max()):.3e})")
        if not ok:
            fail(f"kernel 4 {name} {key} disagrees with the plain autograd")
    return worst


def kernel4_timing(card, name, raws, tag="8"):
    """Kernel 4 over a list of inputs (pre, q, w, g): two calls
    bit-identical; ms a call and the plain version's (the means over the
    list), and the bound over the nonzero cotangents."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd

    pre, q = raws[0][0], raws[0][1]
    B, T, H = pre.shape
    N = q.shape[1]
    call = lambda: [attention_scores_bwd(*raw) for raw in raws]  # noqa: E731
    first = call()
    if not all(torch.equal(u, v) for a, b in zip(first, call()) for u, v in zip(a, b)):
        fail(f"kernel 4 {name}: two calls differ")
    live = sum(int(raw[3].ne(0).sum()) for raw in raws) / len(raws)
    n_bytes = sum(nbytes(*raw, *out) for raw, out in zip(raws, first)) / len(raws)
    # per live (n, t, h): tanh(pre + q) 2, dz = g * w * (1 - y^2) 4, the d_pre,
    # d_q and d_w sums 4
    rec = {"B": B, "N": N, "T": T, "H": H, "calls": len(raws), "g_nonzero": live / (B * N * T),
           "tanh_needed": live * H, **bound(n_bytes, f32=10.0 * live * H)}
    rec["ms"] = cuda_ms(call) / len(raws)
    with force_plain():
        rec["plain_ms"] = cuda_ms(call, iters=3, warmup=1) / len(raws)
    print(f"[{tag}] kernel 4, {name} B={B} N={N} T={T} H={H} (nonzero g {rec['g_nonzero']:.3f}"
          f"{f', mean of {len(raws)} calls' if len(raws) > 1 else ''}): two calls bit-identical; "
          f"{rec['ms']:.4f} ms a call, plain version {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) [{card}]")
    return rec


def phase_scores_bwd(card):
    """Kernel 4 against the autograd of the plain forward (_bwd_check) at
    the training and ragged shapes with a dense cotangent, and at the
    training shapes with one that is zero outside sorted windows drawn by
    _windows_mask (the masked softmax gives exactly that); its time with
    both."""
    rng = np.random.RandomState(5)
    dev = torch.device("cuda")
    worst, record = 0.0, None
    cases = {name: (shape, False) for name, shape in TRAIN_SHAPES.items()}
    cases["training, g zero outside windows"] = (TRAIN_SHAPES["training"], True)
    for name, ((B, N, T, H), windowed) in cases.items():
        args = _score_inputs(rng, B, N, T, H, dev)
        g = _rand(rng, (B, N, T), 1.0, dev)
        if windowed:
            g = g * torch.from_numpy(_windows_mask(rng, B, N, T)).to(dev)
        worst = max(worst, _bwd_check(name, args, g))
        raw = args[:3] + (g,)
        rec = kernel4_timing(card, name, [raw])
        if name == "ragged":
            continue
        if record is None:
            record = rec
        else:
            record["windowed_g"] = rec
    record["max_abs_err"] = worst
    return record


def train_cfg(**runtime):
    """bench.py's e2e_train_cfg (bench.py:290-319): the flagship width on
    synthetic data, cotrain, batch 32, no eval or checkpoints.  Its 256
    synthetic videos (192 train) already cover 6 steps of 32: nothing is
    cut.  runtime.train_pipeline is False unless given: the phases before
    28 run the synchronous loop, whose ms/step they have measured since
    the first train phase, and phase 28 runs both loops."""
    from echr_tpu_torch.config import flagship_config

    cfg = flagship_config()
    cfg = cfg.replace_in("data", synthetic=True, lda_dim=100, time_buckets=(T_BUCKET,),
                         synthetic_vocab_size=VOCAB, synthetic_seq_length=SEQ_LEN,
                         synthetic_num_videos=256, synthetic_cache_videos=256,
                         synthetic_learnable=True)
    cfg = cfg.replace_in("train", training_mode="cotrain", tap_epochs=0, cg_epochs=0,
                         tapcg_epochs=10**6, batch_size=TRAIN_B, self_critical_after=-1,
                         m_batch=1)
    cfg = cfg.replace_in("save", losses_log_every=10**9, save_checkpoint_every=10**9,
                         min_epoch_when_save=10**9)
    cfg = cfg.replace_in("runtime", **{"train_pipeline": False, **runtime})
    return cfg.validate()


def phase_train(card):
    from echr_tpu_torch.engine.train import train
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd, attention_scores_dense

    cfg = train_cfg()
    torch.cuda.reset_peak_memory_stats()
    attention_scores_dense.launches = 0
    attention_scores_bwd.launches = 0
    timing = {}
    out = train(cfg, max_iterations=TRAIN_STEPS, device="cuda", timing_out=timing)
    torch.cuda.synchronize()
    launches = {"attention_scores_dense": attention_scores_dense.launches,
                "attention_scores_bwd": attention_scores_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    tf_steps = SEQ_LEN - 1  # caption columns minus the BOS input
    expect = tf_steps * out["iteration"]
    if out["iteration"] != TRAIN_STEPS:
        fail(f"train stopped at iteration {out['iteration']}")
    if not all(np.isfinite(v) for v in out["losses"].values()):
        fail(f"non-finite losses {out['losses']}")
    gen = torch.Generator().manual_seed(cfg.train.seed)  # train()'s init, again
    tap0, cg0 = init_tap(gen, out["config"]), init_captioner(gen, out["config"])
    state = out["state"]
    for name, m0, m in (("tap", tap0, state.tap), ("cg", cg0, state.cg)):
        for (pn, p0), p in zip(m0.named_parameters(), m.parameters()):
            if torch.equal(p0, p.detach().cpu()):
                fail(f"{name}.{pn} did not move in {out['iteration']} steps")
    if any(n != expect for n in launches.values()):
        fail(f"kernel launches {launches} do not match {tf_steps} teacher-forced steps x "
             f"{out['iteration']} train steps = {expect}")
    if timing["pipelined"]:
        fail("phase 9 times the synchronous loop, whose steps end before their stamp")
    t = dict(timing["iters"])
    dt = (t[TRAIN_STEPS] - t[1]) / (TRAIN_STEPS - 1)
    print(f"[9] training slice, the synchronous loop: {out['iteration']} steps of {TRAIN_B} "
          f"videos (cotrain/tap_cg, "
          f"vocab {VOCAB}, {tf_steps} teacher-forced steps, T={T_BUCKET}, "
          f"N={cfg.tap.prop_sample_num}, bf16, "
          f"dropout on, seed {cfg.train.seed}; synthetic_num_videos 256 as e2e_train_cfg, "
          f"nothing cut); launches {launches}; last losses "
          f"{ {k: round(v, 4) for k, v in out['losses'].items()} }")
    print(f"[9] training {1000 * dt:.1f} ms/step, {TRAIN_B / dt:.2f} videos/s over steps 2-"
          f"{TRAIN_STEPS}, peak device memory {peak / 2**30:.2f} GiB [{card}]")
    fwd, raws = training_step_inputs(out)
    density = sum(int(r[4].ne(0).sum()) for r in fwd) / sum(r[4].numel() for r in fwd)
    share = sum(int(r[3].ne(0).sum()) for r in raws) / sum(r[3].numel() for r in raws)
    print(f"[9] one more step of {TRAIN_B} videos: kernel 3 saw {len(fwd)} window masks, "
          f"{density:.4f} of their entries live; kernel 4 saw {len(raws)} cotangents, "
          f"{share:.4f} of their entries nonzero")
    return (launches, kernel3_timing(card, "the training step's own masks", fwd, tag="9"),
            kernel4_timing(card, "the training step's own cotangents", raws, tag="9"))


def training_step_inputs(out, dev="cuda"):
    """One more gradient step of train()'s state ``out`` on a batch of the
    training data, with wrappers on kernels 3 and 4 that keep the inputs
    of each of their calls: ([(pre, q, w, b, mask), ...],
    [(pre, q, w, g), ...])."""
    from echr_tpu_torch.data.batcher import make_batch
    from echr_tpu_torch.data.dataset import build_dataset
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine.train import _collate
    from echr_tpu_torch.ops import kernel_attention

    cfg = out["config"]
    ds = build_dataset(cfg)
    ix = ds.split_ix["train"][:TRAIN_B]
    batch = steps.batch_to_device(_collate([
        make_batch(ds.get_example(i), cfg, np.random.RandomState(i), w1=ds.w1)[0] for i in ix]),
        dev)
    fwd, bwd = [], []

    def keeper(kept):
        def keep(*args):
            kept.append(tuple(x.detach().clone() for x in args))
        return keep
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed + 2)
    with wrapped(kernel_attention, "attention_scores_dense", keeper(fwd)), \
            wrapped(kernel_attention, "attention_scores_bwd", keeper(bwd)):
        steps.grad_step(out["state"], batch, gen, cfg, "tap_cg")
    return fwd, bwd


def phase_train_parity():
    """f32, TF32 off, dropout off, B=4: one step's loss and gradients with
    the kernels and under force_plain().  Gates: loss within 1e-5 relative,
    every gradient leaf within atol 2e-4, rtol 1e-3."""
    from echr_tpu_torch.data.batcher import make_batch
    from echr_tpu_torch.data.dataset import SyntheticDataset
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine.train import _collate
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops import force_plain

    cfg = train_cfg(compute_dtype="float32").replace_in("decoder", CG_vocab_size=VOCAB,
                                                          CG_seq_length=SEQ_LEN)
    ds = SyntheticDataset(cfg, num_videos=8, seed=11)
    batch = steps.batch_to_device(_collate([
        make_batch(ds.get_example(i), cfg, np.random.RandomState(i), w1=ds.w1)[0]
        for i in range(4)]), "cuda")
    gen = torch.Generator().manual_seed(0)
    state = steps.init_train_state(cfg, init_tap(gen, cfg, "cuda"),
                                   init_captioner(gen, cfg, "cuda"))
    (tk, ck), mk = steps.grad_step(state, batch, None, cfg, "tap_cg")
    with force_plain():
        (tp, cp), mp = steps.grad_step(state, batch, None, cfg, "tap_cg")
    mk, mp = steps.fetch_metrics(mk, mp)
    rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    names = ([f"tap.{n}" for n, _ in state.tap.named_parameters()]
             + [f"cg.{n}" for n, _ in state.cg.named_parameters()])
    worst, bad = 0.0, []
    for name, a, b in zip(names, tk + ck, tp + cp):
        worst = max(worst, float((a - b).abs().max()))
        if not bool(((a - b).abs() <= 2e-4 + 1e-3 * b.abs()).all()):
            bad.append(name)
    print(f"[10] f32 training step, kernels vs plain: loss {mk['loss']:.6f} vs "
          f"{mp['loss']:.6f} (rel {rel:.2e}), {len(names)} gradient leaves, max|d| "
          f"{worst:.3e}")
    if not rel <= 1e-5 or bad:
        fail(f"training step with the kernels disagrees with its plain version: rel {rel:.2e}, "
             f"leaves {bad[:5]}")


def _reset_probe_counts():
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.ops.kernel_probe_head import stream_head
    from echr_tpu_torch.ops.kernel_probe_scores import probe_scores, probe_scores_plus_dot

    for fn in (greedy_head, stream_head, probe_scores, probe_scores_plus_dot):
        fn.launches = 0


def _check_calls(phase, record, counts):
    """Each kernel's launch count over a probe's run equals the calls the
    run made to its wrapper."""
    for name, calls in record["kernel_calls"].items():
        if counts[name] != calls:
            fail(f"phase {phase}: {name} launched {counts[name]} times, the probe made {calls} "
                 f"calls")


def _head_check(name, args, tr, tv):
    """stream_head against its plain version: tokens bit-equal, max and lse
    within TOL."""
    from echr_tpu_torch.experiments.probe_greedy_head import check_head
    from echr_tpu_torch.ops.kernel_probe_head import stream_head, stream_head_plain

    got = stream_head(*args, tr, tv)
    torch.cuda.synchronize()
    c = check_head(got, stream_head_plain(*args))
    err = max(c["max_abs_err_max"], c["max_abs_err_lse"])
    if c["token_mismatches"] or not err <= TOL:
        fail(f"stream_head {name} at {(tr, tv)}: {c}")
    return err, got


def _tie_check(tr, tv, dev):
    """Exact ties from integer-valued sums, the first index winning: columns
    3 and 5 in the first vocab tile, 1031 and 2000 in later ones; and tv - 1
    (the first tile's upper column half, which TR <= 64 folds in the second
    consumer) against tv + 1 and 2000 (lower halves of later tiles)."""
    from echr_tpu_torch.ops.kernel_probe_head import pad_probe_head, stream_head

    C, V1 = 16, 2048
    for cols in ([3, 5, 1031, 2000], [tv - 1, tv + 1, 2000]):
        wt = torch.zeros(C, V1, device=dev)
        wt[:, cols] = 1.0
        tok, mx, _ = stream_head(torch.ones(64, C, device=dev), *pad_probe_head(
            wt, torch.zeros(V1, device=dev), tv), tr, tv)
        if not (bool((tok == cols[0]).all()) and bool((mx == C).all())):
            fail(f"stream_head tie at {(tr, tv)}, columns {cols}: tokens "
                 f"{tok.unique().tolist()}")


@torch.inference_mode()
def phase_probe_head(card):
    """Kernel 7 (stream_head at its plan) against its plain version at the
    probe's shapes (R=4096, C=1536, V1=6001 padded to 6144, bf16), a ragged
    R and exact ties within and across vocab tiles; its time; then the
    probe: X0, XM, X0p, XMp, K1 (kernel 7) and K2 (kernel 2) ms per step."""
    from echr_tpu_torch.experiments import probe_greedy_head as probe
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.ops.kernel_probe_head import PLAN, l2_bytes, pad_probe_head, stream_head

    dev = torch.device("cuda")
    tr, tv = PLAN
    w, b, out0 = probe.probe_inputs(probe.B, probe.N, probe.C, probe.V1, 0, dev)
    wp, bp = pad_probe_head(w, b, tv)
    args = (out0, wp, bp)
    worst, got = _head_check("probe", args, tr, tv)
    rng = np.random.RandomState(15)
    Rr, Cr, Vr = 1000, 200, 777  # ragged rows; C a multiple of 8, as the kernel needs
    rargs = (_rand(rng, (Rr, Cr), 1.0, dev),) + pad_probe_head(_rand(rng, (Cr, Vr), 0.1, dev),
                                                               _rand(rng, (Vr,), 0.1, dev), tv)
    worst = max(worst, _head_check("ragged", rargs, tr, tv)[0])
    _tie_check(tr, tv, dev)
    print(f"[15] kernel 7 {PLAN} R={out0.shape[0]} C={probe.C} V1={probe.V1} VP={wp.shape[1]} "
          f"bf16: tokens bit-equal, max|d| max/lse {worst:.3e}; ragged R={Rr} C={Cr} V1={Vr} "
          f"equal; ties: the first index wins")
    ms = cuda_ms(lambda: stream_head(*args, tr, tv))
    with force_plain():
        plain_ms = cuda_ms(lambda: stream_head(*args, tr, tv), iters=10)
    R, V1 = out0.shape[0], probe.V1
    l2 = l2_bytes(R, probe.C, wp.shape[1], tr, tv)["total"]  # modelled, not measured
    record = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
              **bound(nbytes(out0.to(torch.bfloat16), wp, bp, *got),
                      bf16=2.0 * R * probe.C * V1)}
    _reset_probe_counts()
    run = probe.run()
    torch.cuda.synchronize()
    counts = {"stream_head": stream_head.launches, "greedy_head": greedy_head.launches}
    _check_calls(15, run, counts)
    if run["check"]["token_mismatches"]:
        fail(f"probe_greedy_head: {run['check']}")
    record.update(launches=counts["stream_head"], probe_ms_per_step=run["ms_per_step"])
    p = run["ms_per_step"]
    print(f"[15] kernel 7 {ms:.4f} ms vs plain {plain_ms:.4f} ms a call, bound "
          f"{record['bound_ms']:.4f} ms ({record['bound_by']}), {l2 / 1e9:.3f} GB through L2 by "
          f"the plan (modelled); probe ms/step "
          f"{ {k: round(v, 4) for k, v in p.items()} }; launches {counts} [{card}]")
    return record


@torch.inference_mode()
def phase_probe_sweep(card):
    """Kernel 8, every instantiated tiling: a ragged R against the plain
    version, then the probe (each tiling checked at the probe's shapes,
    argmax bit-equal, then X0, XM, X0p, XMp and each tiling in interleaved
    windows); each tiling's time a call."""
    from echr_tpu_torch.experiments import probe_greedy_head, probe_streaming_head2 as probe
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_probe_head import TILINGS, l2_bytes, pad_probe_head, stream_head

    dev = torch.device("cuda")
    rng = np.random.RandomState(16)
    Rr, Cr, Vr = 1000, 200, 777
    a, w, b = _rand(rng, (Rr, Cr), 1.0, dev), _rand(rng, (Cr, Vr), 0.1, dev), _rand(rng, (Vr,),
                                                                                     0.1, dev)
    worst = max(_head_check("ragged", (a,) + pad_probe_head(w, b, tv), tr, tv)[0]
                for tr, tv in TILINGS)
    for tr, tv in TILINGS:
        _tie_check(tr, tv, dev)
    _reset_probe_counts()
    run = probe.run()
    torch.cuda.synchronize()
    counts = {"stream_head": stream_head.launches}
    _check_calls(16, run, counts)
    for c in run["checks"].values():
        worst = max(worst, c["max_abs_err_max"], c["max_abs_err_lse"])
    if not worst <= TOL:
        fail(f"kernel 8: max|d| max/lse {worst:.3e} > {TOL}")
    w, b, out0 = probe_greedy_head.probe_inputs(probe.B, probe.N, probe.C, probe.V1, 0, dev)
    tilings_ms, tilings_l2 = {}, {}
    for tr, tv in TILINGS:
        wp, bp = pad_probe_head(w, b, tv)
        tilings_ms[f"{tr}x{tv}"] = cuda_ms(lambda: stream_head(out0, wp, bp, tr, tv))
        tilings_l2[f"{tr}x{tv}"] = l2_bytes(out0.shape[0], probe.C, wp.shape[1], tr, tv)["total"]
    best = min(tilings_ms, key=tilings_ms.get)
    tr, tv = map(int, best.split("x"))
    wp, bp = pad_probe_head(w, b, tv)
    with force_plain():
        plain_ms = cuda_ms(lambda: stream_head(out0, wp, bp, tr, tv), iters=10)
    got = stream_head(out0, wp, bp, tr, tv)
    R = out0.shape[0]
    record = {"launches": counts["stream_head"], "max_abs_err": worst, "ms": tilings_ms[best],
              "best_tiling": best, "tilings_ms": tilings_ms, "plain_ms": plain_ms,
              **bound(nbytes(out0.to(torch.bfloat16), wp, bp, *got),
                      bf16=2.0 * R * probe.C * probe.V1),
              "probe_ms_per_step": run["ms_per_step"]}
    print(f"[16] kernel 8, {len(TILINGS)} tilings: tokens bit-equal at the probe's shapes and "
          f"ragged R={Rr}, first-index ties, max|d| max/lse {worst:.3e}; ms a call "
          f"{ {k: round(v, 4) for k, v in tilings_ms.items()} }, best {best}; GB through L2 "
          f"by the plan (modelled) { {k: round(v / 1e9, 3) for k, v in tilings_l2.items()} }; "
          f"plain "
          f"{plain_ms:.4f} ms; bound {record['bound_ms']:.4f} ms ({record['bound_by']}); "
          f"launches {counts['stream_head']} [{card}]")
    return record


def sfu_floor(tanh_needed, grid_blocks=None, tanh_per_block=None):
    """The SFU floor of echr_tanh work: two SFU ops a tanh (ex2, rcp) at the
    data sheet's 16 a clock an SM, at the card's clocks.max.sm.  Over every
    SM (``sfu_floor_ms``), and, given a grid, over its waves of blocks of
    ``tanh_per_block`` each, one block an SM (``sfu_floor_grid_ms``)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_ms = SFU_OPS_PER_CLOCK_SM * mhz * 1e3 / SFU_OPS_PER_TANH  # tanh a ms on one SM
    rec = {"sfu_floor_ms": tanh_needed / (per_ms * sms), "sfu_clock_mhz": mhz, "sms": sms}
    if grid_blocks is not None:
        rec["sfu_floor_grid_ms"] = -(-grid_blocks // sms) * tanh_per_block / per_ms
    return rec


@torch.inference_mode()
def phase_probe_overlap(card):
    """Kernels 9 and 10, and kernel 10's product warps alone, against their
    plain versions at the probe's shapes (B=32, N=128, T=256, H=512,
    KD=2048), a ragged shape and one with N and T both off the 64 x 128
    block and the narrowest product (KD=128), and kernel 10 at KD=8192;
    their times and SFU floors (printed only: modelled from the data
    sheet); then the probe: S0, S1, SD and S2 at KD=2048 and 8192."""
    from echr_tpu_torch.experiments import probe_mxu_vpu_overlap as probe
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_probe_scores import (KD_TILE, TILE_N, TILE_T, grid,
                                                        probe_dot_plain, probe_scores,
                                                        probe_scores_plus_dot)

    dev = torch.device("cuda")
    rng = np.random.RandomState(17)
    bf16 = torch.bfloat16
    records, worst = {}, {"probe_scores": 0.0, "probe_scores_plus_dot": 0.0}
    for name, (B, N, T, H, KD) in {"probe": (probe.B, probe.N, probe.T, probe.H, probe.KD),
                                   "ragged": (3, 77, 200, 496, 256),
                                   "off the block": (2, 50, 130, 100, KD_TILE)}.items():
        pre, q = _rand(rng, (B, T, H), 0.5, dev), _rand(rng, (B, N, H), 0.5, dev)
        w, wd = _rand(rng, (H,), 0.05, dev), _rand(rng, (H, KD), 0.05, dev).to(bf16)
        s9 = probe_scores(pre, q, w)
        s10, d10 = probe_scores_plus_dot(pre, q, w, wd)
        _, d_only = probe_scores_plus_dot(pre, q, w, wd, scores=False)
        torch.cuda.synchronize()
        with force_plain():
            ps, pd = probe_scores_plus_dot(pre, q, w, wd)
        e9 = float((s9 - ps).abs().max())
        e10 = max(float((s10 - ps).abs().max()), float((d10 - pd).abs().max()),
                  float((d_only - pd).abs().max()))
        print(f"[17] {name} B={B} N={N} T={T} H={H} KD={KD}: kernel 9 max|d| {e9:.3e}; kernel 10 "
              f"scores and product (and the product alone) max|d| {e10:.3e}")
        if not (e9 <= TOL and e10 <= TOL):
            fail(f"kernels 9/10 {name}: max|d| {e9:.3e}, {e10:.3e} > {TOL}")
        worst["probe_scores"] = max(worst["probe_scores"], e9)
        worst["probe_scores_plus_dot"] = max(worst["probe_scores_plus_dot"], e10)
        if name != "probe":
            continue
        tanh_ops = 4.0 * B * N * T * H  # per (n, t, h): add, tanh, multiply, add
        blocks = int(np.prod(grid(B, N, T)))
        floors = sfu_floor(B * N * T * H, blocks, TILE_N * TILE_T * H)
        for fn, call, outs, extra in (
                (probe_scores, lambda: probe_scores(pre, q, w), (s9,), {}),
                (probe_scores_plus_dot, lambda: probe_scores_plus_dot(pre, q, w, wd),
                 (s10, d10, wd), {"bf16": 2.0 * d10.numel() * H})):
            ms = cuda_ms(call)
            with force_plain():
                plain_ms = cuda_ms(call, iters=3, warmup=1)
            records[fn.__name__] = {"ms": ms, "plain_ms": plain_ms,
                                    **bound(nbytes(pre, q, w, *outs), f32=tanh_ops, **extra)}
        records["probe_scores_plus_dot"]["product_only_ms"] = cuda_ms(
            lambda: probe_scores_plus_dot(pre, q, w, wd, scores=False))
        del wd, s9, s10, d10, d_only, pd
        wide = _rand(rng, (H, probe.KDS[-1]), 0.05, dev).to(bf16)  # the probe's wider product
        s_w, d_w = probe_scores_plus_dot(pre, q, w, wide)
        _, d_w_only = probe_scores_plus_dot(pre, q, w, wide, scores=False)
        pd_w = probe_dot_plain(q, wide, T)
        e_w = max(float((s_w - ps).abs().max()), float((d_w - pd_w).abs().max()),
                  float((d_w_only - pd_w).abs().max()))
        print(f"[17] {name} at KD={wide.shape[1]}: kernel 10 scores and product (and the "
              f"product alone) max|d| {e_w:.3e}")
        if not e_w <= TOL:
            fail(f"kernel 10 {name} at KD={wide.shape[1]}: max|d| {e_w:.3e} > {TOL}")
        worst["probe_scores_plus_dot"] = max(worst["probe_scores_plus_dot"], e_w)
        del s_w, d_w, d_w_only, pd_w, ps
        records["probe_scores_plus_dot"]["at_kd"] = {str(probe.KDS[-1]): {
            "ms": cuda_ms(lambda: probe_scores_plus_dot(pre, q, w, wide)),
            "product_only_ms": cuda_ms(lambda: probe_scores_plus_dot(pre, q, w, wide,
                                                                     scores=False))}}
        del pre, q, wide
    _reset_probe_counts()
    run = probe.run()
    torch.cuda.synchronize()
    counts = {"probe_scores": probe_scores.launches,
              "probe_scores_plus_dot": probe_scores_plus_dot.launches}
    _check_calls(17, run, counts)
    n_tanh = run["B"] * run["N"] * run["T"] * run["H"]
    for name, rec in records.items():
        rec.update(launches=counts[name], max_abs_err=worst[name], tanh_needed=n_tanh,
                   probe_ms_per_step={str(kd): row for kd, row in run["ms_per_step"].items()})
        print(f"[17] {name} {rec['ms']:.4f} ms vs plain {rec['plain_ms']:.4f} ms a call, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), SFU floor worked from the data "
              f"sheet (modelled) {floors['sfu_floor_ms']:.4f} ms on {floors['sms']} SMs, "
              f"{floors['sfu_floor_grid_ms']:.4f} ms for its grid's {blocks} blocks (at "
              f"{floors['sfu_clock_mhz']:.0f} MHz); launches {counts[name]} [{card}]")
    kd = min(run["ms_per_step"])
    rows = {kd: {k: round(v, 4) for k, v in row.items()} for kd, row in run["ms_per_step"].items()}
    print(f"[17] S0 (kernel 9, echr_tanh) evaluates "
          f"{n_tanh / run['ms_per_step'][kd]['S0'] / 1e6:.1f} M tanh a ms (KD={kd}) [{card}]")
    k10 = records["probe_scores_plus_dot"]
    at_kd = {kd: f"{r['ms']:.4f} ms, the product alone {r['product_only_ms']:.4f} ms"
             for kd, r in k10["at_kd"].items()}
    print(f"[17] kernel 10's product warps alone {k10['product_only_ms']:.4f} ms a call; "
          f"kernel 10 at KD={at_kd}; probe ms/step {rows} [{card}]")
    return records


def eval_cfg(**runtime):
    """train_cfg()'s data (256 synthetic videos at the flagship width, the
    64-video val split) for the batched eval, with a prefetch that covers
    two groups of 32."""
    cfg = train_cfg(**runtime).replace_in("decoder", CG_vocab_size=VOCAB, CG_seq_length=SEQ_LEN)
    return cfg.replace_in("data", prefetch=2 * EVAL_B, nthreads=4)


def eval_setup(**runtime):
    """eval_cfg(): the seeded random init, the dataset and a Loader."""
    from echr_tpu_torch.data.dataset import build_dataset
    from echr_tpu_torch.data.loader import Loader
    from echr_tpu_torch.models.registry import init_captioner, init_tap

    cfg = eval_cfg(**runtime)
    ds = build_dataset(cfg)
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    return cfg, tap, cg, ds, Loader(ds, cfg, process_index=0, process_count=1, seed=0)


def usable_val_videos(cfg, ds):
    """The val videos eval counts (proposal_num > 0, n_frames > 1), from the
    labels-off batch."""
    from echr_tpu_torch.data.batcher import make_batch

    out = []
    for ix in ds.split_ix["val"]:
        _, m = make_batch(ds.get_example(ix), cfg, np.random.RandomState(0), labels=False)
        if m.proposal_num > 0 and m.n_frames > 1:
            out.append(m.vid)
    return out


def check_predictions(preds, usable, vocab, durations):
    """Every usable val video has predictions, at most TOP_N each, with
    well-formed timestamps, sentences in the vocab and re_score = 10 x
    proposal_score + sentence_confidence."""
    if sorted(preds) != sorted(usable):
        fail(f"predictions for {len(preds)} videos, {len(usable)} usable val videos")
    words = set(vocab.values())
    for vid, caps in preds.items():
        if not 0 < len(caps) <= TOP_N:
            fail(f"{vid}: {len(caps)} predictions")
        for c in caps:
            s, e = c["timestamp"]
            if not (0.0 <= s < e <= durations[vid] + 1e-6 and 0.0 <= c["proposal_score"] <= 1.0
                    and np.isfinite(c["sentence_confidence"])
                    and abs(c["re_score"] - 10 * c["proposal_score"]
                            - c["sentence_confidence"]) <= 1e-9):
                fail(f"{vid}: malformed prediction {c}")
            if not set(c["sentence"].split()) <= words:
                fail(f"{vid}: sentence outside the vocab: {c['sentence']!r}")


@contextlib.contextmanager
def timed_scoring(seconds):
    """Within the block, the batched eval's eval_score calls add their wall
    time to ``seconds``."""
    from echr_tpu_torch.engine import evaluate

    fn = evaluate.eval_score

    def timed(*args, **kw):
        t0 = time.time()
        try:
            return fn(*args, **kw)
        finally:
            seconds.append(time.time() - t0)
    with patched(evaluate, "eval_score", timed):
        yield


def phase_eval(card):
    """The eval slice: eval_split_batched over the 64-video val split,
    tap_cg, top-128, batch 32, every metric: greedy with val losses, then
    beam 4 decode-only (no val losses)."""
    cfg, tap, cg, ds, loader = eval_setup()
    usable = usable_val_videos(cfg, ds)
    durations = {ds.get_example(ix).vid: ds.get_example(ix).duration for ix in ds.split_ix["val"]}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            return {name: eval_pass(card, name, beam, (tap, cg, loader, cfg), usable, durations,
                                    f"{tmp}/{name}.json")
                    for name, beam in (("eval_greedy", 1), ("eval_beam", BEAM))}
    finally:
        loader.load_state(loader.state())  # stops and joins the prefetch threads


def eval_pass(card, name, beam, args, usable, durations, json_path):
    """One pass of phase 18.  Kernel 1's launches must equal the decode steps
    plus the val losses' teacher-forced steps (29 a group), kernel 2's the
    greedy decode steps."""
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.metrics import scorers
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head

    tap, cg, loader, cfg = args
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": True, "val_all_metrics": True,
          "get_eval_loss": beam == 1, "beam_size": beam}
    # warm-up: one group, unscored (a first val-loss call takes seconds)
    eval_split_batched(tap, cg, loader, cfg, json_path,
                       dict(kw, num_vids_eval=EVAL_B, language_eval=False),
                       flag_eval_what="tap_cg", batch_videos=EVAL_B, device="cuda")
    torch.cuda.synchronize()
    timing, score_s = {}, []
    for fn in (attention_scores_masked, greedy_head):
        fn.launches = 0
    for fn in (decoder_sample_batched, beam_search_batched):
        fn.steps = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with timed_scoring(score_s):
        preds, score, losses = eval_split_batched(
            tap, cg, loader, cfg, json_path, dict(kw, timing_out=timing),
            flag_eval_what="tap_cg", batch_videos=EVAL_B, device="cuda")
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    if torch.backends.cuda.matmul.allow_tf32:  # phase 1 turned it off
        fail(f"{name}: the eval left TF32 on")
    k1, k2 = attention_scores_masked.launches, greedy_head.launches
    steps = decoder_sample_batched.steps if beam == 1 else beam_search_batched.steps
    check_predictions(preds, usable, loader.dataset.ix_to_word, durations)
    want_k1 = steps + ((SEQ_LEN - 1) * timing["groups"] if beam == 1 else 0)
    want_k2 = steps if beam == 1 else 0
    if not (steps > 0 and k1 == want_k1 and k2 == want_k2):
        fail(f"{name}: kernel 1 launched {k1} times (want {want_k1}), kernel 2 {k2} "
             f"(want {want_k2}) in {steps} decode steps")
    if beam == 1 and not (np.isfinite(losses).all() and (losses[:3] > 0).all()):
        fail(f"{name}: val losses {losses}")
    metrics = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr",
               "Recall", "Precision")
    if not all(np.shape(score.get(m)) == (4,) and np.isfinite(score[m]).all() for m in metrics):
        fail(f"{name}: scores {score}")
    stemmer = ("nltk PorterStemmer" if getattr(scorers._STEM, "__self__", None) is not None
               else "identity (nltk absent)")
    n_caps = sum(len(c) for c in preds.values())
    run = wall - sum(score_s)
    print(f"[18] {name}: {len(preds)} videos (of {len(usable)} usable), {n_caps} captions, "
          f"{timing['groups']} groups of {EVAL_B}, {steps} decode steps, kernel 1 launches "
          f"{k1}, kernel 2 {k2}; val losses {np.round(losses[:3], 4).tolist()}; all scored")
    print(f"[18] {name}: {len(preds) / run:.2f} eval videos/s, {n_caps / run:.1f} captions/s "
          f"over {run:.3f} s without scoring; eval_score {sum(score_s):.3f} s (stemmer: "
          f"{stemmer}); peak device memory {peak / 2**30:.2f} GiB, bf16 compute [{card}]")
    print(f"[18] {name} timing_out: "
          f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in timing.items()} }")
    print(f"[18] {name} scores: { {m: np.round(score[m], 4).tolist() for m in metrics} }")
    return {"attention_scores_masked": k1, "greedy_head": k2}


def phase_eval_parity():
    """f32, TF32 off, phase 5's sharpened logit weights: the greedy eval with
    the kernels and under force_plain(), in the tap_cg mode and in the cg
    mode that phase 20's gate runs first (GT proposals, bucket 64), gives
    the same videos, sentences, timestamps and proposal scores, sentence
    confidences within 5e-4 a token (the caption's words and its end
    token) and val losses within 1e-5 relative."""
    cfg, tap, cg, ds, loader = eval_setup(compute_dtype="float32")
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
    try:
        for mode in ("tap_cg", "cg"):
            eval_parity(tap, cg, loader, cfg, mode)
    finally:
        loader.load_state(loader.state())


def eval_parity(tap, cg, loader, cfg, mode):
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.ops import force_plain

    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": False, "get_eval_loss": True}
    with tempfile.TemporaryDirectory() as tmp:
        got, _, got_loss = eval_split_batched(tap, cg, loader, cfg, f"{tmp}/k.json", dict(kw),
                                              flag_eval_what=mode, batch_videos=EVAL_B,
                                              device="cuda")
        with force_plain():
            want, _, want_loss = eval_split_batched(tap, cg, loader, cfg, f"{tmp}/p.json",
                                                    dict(kw), flag_eval_what=mode,
                                                    batch_videos=EVAL_B, device="cuda")
    if sorted(got) != sorted(want) or not want:
        fail("eval parity: the kernels and the plain versions predicted for other videos")
    bad, worst, n = 0, 0.0, 0
    for vid, preds in want.items():
        if len(got[vid]) != len(preds):
            fail(f"eval parity: {vid} has {len(got[vid])} predictions against {len(preds)}")
        for g, w in zip(got[vid], preds):
            n += 1
            bad += (g["sentence"], g["timestamp"], g["proposal_score"]) != \
                (w["sentence"], w["timestamp"], w["proposal_score"])
            err = abs(g["sentence_confidence"] - w["sentence_confidence"])
            worst = max(worst, err / (len(w["sentence"].split()) + 1))
    rel = np.abs(got_loss[:3] - want_loss[:3]) / np.abs(want_loss[:3])
    print(f"[19] f32 {mode} eval, kernels vs plain: {len(want)} videos, {n} captions, {bad} "
          f"differ in sentence, timestamp or proposal score; max|d| confidence {worst:.3e} a "
          f"token; val losses {np.round(want_loss[:3], 6).tolist()} (rel {float(rel.max()):.2e})")
    if bad or not worst <= TOL or not float(rel.max()) <= 1e-5:
        fail(f"the {mode} eval pass with the kernels disagrees with its plain version")


CKPT_STEPS, CKPT_EVERY = 8, 4  # phase 20: steps, save_checkpoint_every (two gates)
RESUME_K = 3  # phases 21-22: the step a run is stopped at


def ckpt_train_cfg(folder, **runtime):
    """train_cfg() (bench.py's e2e_train_cfg, nothing cut) with checkpoints
    into ``folder``: save_checkpoint_every 4 from epoch 0, each gate over
    one group of EVAL_B val videos, the cg pass and then the tap_cg pass
    (fast_eval_cg off)."""
    cfg = train_cfg(**runtime).replace(run_id="ckpt")
    cfg = cfg.replace_in("save", checkpoint_path=folder, save_checkpoint_every=CKPT_EVERY,
                         min_epoch_when_save=0)
    return cfg.replace_in("eval", num_vids_eval=EVAL_B, batch_videos=EVAL_B, fast_eval_cg=False)


def first_of_each_shape(kept):
    """A hook that keeps a copy of the arguments of the first call of each
    shape and dtype signature in ``kept``."""
    def keep(*args):
        key = tuple((tuple(x.shape), x.dtype) for x in args)
        if key not in kept:
            kept[key] = tuple(x.detach().clone() for x in args)
    return keep


def phase_ckpt_train(card):
    """Phase 20: checkpointed training through engine.train.train: 8 steps,
    gates at 4 and 8, model-last / model-best, then the checkpoint read
    back and served.  Kernels 1 and 2 are held against their plain versions
    on a copy of the arguments of their first call at each shape the run
    gave them (the gate's cg and tap_cg decodes and val losses); the
    training steps give kernels 3 and 4 phase 9's shapes, held there on
    the step's own inputs.  Returns kernels 1-4's launches in the run."""
    import os

    from echr_tpu_torch.engine import checkpoint
    from echr_tpu_torch.engine import train as train_mod
    from echr_tpu_torch.models import decoder
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops import attention
    from echr_tpu_torch.ops.kernel_attention import (attention_scores_bwd,
                                                     attention_scores_dense,
                                                     attention_scores_masked)
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.serve import from_checkpoint

    kernels = (attention_scores_masked, greedy_head, attention_scores_dense,
               attention_scores_bwd)
    passes, score_s, saves = [], [], []
    eval_fn, save_fn = train_mod.eval_split_batched, checkpoint.save_checkpoint

    def timed_eval(tap, cg, loader, cfg, json_path, kw, **k):
        kw = dict(kw, timing_out={})
        t0 = time.time()
        res = eval_fn(tap, cg, loader, cfg, json_path, kw, **k)
        torch.cuda.synchronize()
        passes.append((k["flag_eval_what"], time.time() - t0, kw["timing_out"]["groups"]))
        return res

    def timed_save(path, *a, **k):
        t0 = time.time()
        save_fn(path, *a, **k)
        saves.append((os.path.basename(path), time.time() - t0, os.path.getsize(path)))

    with tempfile.TemporaryDirectory() as tmp:
        cfg = ckpt_train_cfg(tmp)
        timing = {}
        for fn in kernels:
            fn.launches = 0
        decoder_sample_batched.steps = 0
        torch.cuda.reset_peak_memory_stats()
        seen1, seen2 = {}, {}
        with patched(train_mod, "eval_split_batched", timed_eval), \
                patched(checkpoint, "save_checkpoint", timed_save), timed_scoring(score_s), \
                wrapped(attention, "attention_scores_masked", first_of_each_shape(seen1)), \
                wrapped(decoder, "greedy_head", first_of_each_shape(seen2)):
            out = train_mod.train(cfg, max_iterations=CKPT_STEPS, device="cuda",
                                  timing_out=timing)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in kernels}
        steps = decoder_sample_batched.steps
        peak = torch.cuda.max_memory_allocated()

        tf_steps = SEQ_LEN - 1
        gates = [it for it, _ in timing["ckpt"]]
        groups = sum(g for _, _, g in passes)
        folder = out["save_folder"]
        last, best = (os.path.join(folder, f"model-{w}.ckpt") for w in ("last", "best"))
        raw = checkpoint.load_checkpoint(last, rebuild_state=False)
        val = raw["histories"]["val"]
        gate_scores = {it: float(np.mean(val[it]["METEOR"])) * 100 for it in gates}
        want = {"attention_scores_dense": tf_steps * (CKPT_STEPS + len(gates)),
                "attention_scores_bwd": tf_steps * (CKPT_STEPS + len(gates)),
                "attention_scores_masked": steps + tf_steps * groups, "greedy_head": steps}
        if out["iteration"] != CKPT_STEPS or gates != [CKPT_EVERY, 2 * CKPT_EVERY]:
            fail(f"checkpointed training: iteration {out['iteration']}, gates at {gates}")
        if [m for m, _, _ in passes] != ["cg", "tap_cg"] * 2 or groups != 4:
            fail(f"checkpointed training: gate passes {passes}")
        if not (steps > 0 and launches == want):
            fail(f"checkpointed training: launches {launches}, want {want} ({steps} decode "
                 f"steps, {groups} val-loss groups)")
        if not (seen1 and seen2):
            fail("checkpointed training: no call of kernel 1 or 2 was seen")
        worst1 = max(kernel1_check(f"gate {key}", args)[0] for key, args in seen1.items())
        worst2 = max(head_check("20", f"gate R={args[0].shape[0]} {args[1].dtype}", args)[0]
                     for args in seen2.values())
        print(f"[20] kernel 1 at the run's {len(seen1)} shapes "
              f"{[tuple(k[0][0]) + (k[1][0][1],) for k in seen1]} (pre [B, T, H], N): max|d| "
              f"where mask==1 {worst1:.3e}, masked entries 0; kernel 2 at its "
              f"{len(seen2)} shapes (R, C) {[k[0][0] for k in seen2]}: max|d| max/lse "
              f"{worst2:.3e}; against their plain versions")
        del seen1, seen2
        if sorted(val) != gates or out["best_val_score"] != max(gate_scores.values()):
            fail(f"checkpointed training: best {out['best_val_score']}, gates {gate_scores}")
        best_raw = checkpoint.load_checkpoint(best, rebuild_state=False)
        if gate_scores[best_raw["iteration"]] != best_raw["best_val_score"]:
            fail(f"model-best.ckpt at iteration {best_raw['iteration']} holds score "
                 f"{best_raw['best_val_score']}, the gate gave {gate_scores}")
        if torch.backends.cuda.matmul.allow_tf32:
            fail("checkpointed training: the gate left TF32 on")
        torch.cuda.synchronize()
        t0 = time.time()
        loaded = checkpoint.load_checkpoint(last, "cuda")
        torch.cuda.synchronize()
        read_s = time.time() - t0
        st, ld = out["state"], loaded["state"]
        for name in ("tap", "cg"):
            for (pn, a), b in zip(getattr(st, name).named_parameters(),
                                  getattr(ld, name).parameters()):
                sa, sb = getattr(st, name + "_opt").state[a], getattr(ld, name + "_opt").state[b]
                if not (torch.equal(a, b) and all(torch.equal(sa[k].cpu(), sb[k].cpu())
                                                  for k in sa)):
                    fail(f"model-last.ckpt read back: {name}.{pn} or its Adam state differs")
        reqs = requests(64, seed=2)
        svc = from_checkpoint(best, device="cuda", batch_videos=32, topN=TOP_N)
        t0 = time.time()
        res = svc.caption(reqs)
        torch.cuda.synchronize()
        serve_s = time.time() - t0
        check_captions(res, reqs, ties=True)

    t = dict(timing["iters"])
    ck = dict(timing["ckpt"])
    dt = (t[CKPT_STEPS] - t[1] - ck[CKPT_EVERY]) / (CKPT_STEPS - 1)
    print(f"[20] checkpointed training: {out['iteration']} steps of {TRAIN_B} videos "
          f"(cotrain/tap_cg, bf16, dropout on), gates at {gates} over {EVAL_B} val videos "
          f"(cg, then tap_cg), scores {gate_scores}, best {out['best_val_score']:.4f} at "
          f"iteration {best_raw['iteration']}; launches {launches} ({steps} decode steps)")
    print(f"[20] {1000 * dt:.1f} ms/step outside the gate (steps 2-{CKPT_STEPS} less the "
          f"boundary at {CKPT_EVERY}); peak device memory {peak / 2**30:.2f} GiB with the "
          f"gate inside the run [{card}]")
    for i, it in enumerate(gates):
        (m1, s1, _), (m2, s2, _) = passes[2 * i:2 * i + 2]
        print(f"[20] boundary at {it}: {ck[it]:.3f} s; gate {s1 + s2:.3f} s = {m1} pass "
              f"{s1:.3f} s (eval_score {score_s[2 * i]:.3f} s) + {m2} pass {s2:.3f} s "
              f"(eval_score {score_s[2 * i + 1]:.3f} s); histograms and saves "
              f"{ck[it] - s1 - s2:.3f} s [{card}]")
    for name, sec, size in saves:
        print(f"[20] wrote {name}: {size} bytes ({size / 2**20:.1f} MiB) in {sec:.3f} s")
    print(f"[20] read model-last.ckpt onto the card: {read_s:.3f} s; the state read back "
          f"equals the run's, parameters and Adam state [{card}]")
    n_caps = sum(len(c) for c in res.values())
    print(f"[20] serve.from_checkpoint(model-best.ckpt): {len(res)} requests, {n_caps} "
          f"captions (top-{TOP_N} with threshold ties) in {serve_s:.3f} s, e.g. {res['v0'][0]}")
    return launches


def phase_preempt():
    """Phase 21: SIGTERM, sent from a hook on train_step before step 3, stops
    train() at step 3 with a readable model-last.ckpt and the handler
    restored; start_from then runs to step 5."""
    import os
    import signal

    from echr_tpu_torch.engine import checkpoint
    from echr_tpu_torch.engine import train as train_mod

    calls = []

    def sigterm_at_k(*args):
        calls.append(1)
        if len(calls) == RESUME_K:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ckpt_train_cfg(tmp).replace_in("save", save_checkpoint_every=10**9)
        with wrapped(train_mod, "train_step", sigterm_at_k):
            out = train_mod.train(cfg, max_iterations=RESUME_K + 5, device="cuda")
        last = checkpoint.load_checkpoint(os.path.join(out["save_folder"], "model-last.ckpt"),
                                          "cuda")
        if signal.getsignal(signal.SIGTERM) is not before:
            fail("train() left its SIGTERM handler installed")
        if not (out["iteration"] == last["iteration"] == last["state"].step == RESUME_K):
            fail(f"SIGTERM before step {RESUME_K}: train() returned at {out['iteration']}, "
                 f"model-last.ckpt at {last['iteration']}")
        res = train_mod.train(cfg.replace_in("save", start_from=cfg.run_id),
                              max_iterations=RESUME_K + 2, device="cuda")
    if not (res["iteration"] == res["state"].step == RESUME_K + 2
            and all(np.isfinite(v) for v in res["losses"].values())):
        fail(f"resume after SIGTERM: iteration {res['iteration']}, losses {res['losses']}")
    print(f"[21] SIGTERM before step {RESUME_K}: train() returned at iteration "
          f"{out['iteration']} with a readable model-last.ckpt, handler restored; start_from "
          f"ran to {res['iteration']}, losses {res['losses']['loss']:.4f}")


def phase_resume_parity():
    """Phase 22: f32, TF32 off, dropout and scheduled sampling off (steps
    without a generator: the three_stream core's dropout has no setting):
    3 steps, then a resume to 6, against 6 steps straight.  Gates: the
    losses of steps 4-6 within 1e-5 relative, the parameters within atol
    1e-5."""
    from echr_tpu_torch.engine import steps as steps_mod
    from echr_tpu_torch.engine import train as train_mod

    losses = []

    def no_dropout(state, batch, gen, *a, **k):
        state, m = steps_mod.train_step(state, batch, None, *a, **k)
        losses.append(steps_mod.fetch_metrics(m)[0]["loss"])
        return state, m

    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 22 needs TF32 off")
    with tempfile.TemporaryDirectory() as tmp, patched(train_mod, "train_step", no_dropout):
        cfg = ckpt_train_cfg(tmp, compute_dtype="float32").replace_in(
            "save", save_checkpoint_every=10**9)
        cfg = cfg.replace_in("tap", rnn_dropout=0.0).replace_in("decoder", CG_drop_prob=0.0)
        straight = train_mod.train(cfg.replace(run_id="S"), max_iterations=2 * RESUME_K,
                                   device="cuda")
        want = losses[RESUME_K:]
        del losses[:]
        train_mod.train(cfg.replace(run_id="K"), max_iterations=RESUME_K, device="cuda")
        resumed = train_mod.train(cfg.replace(run_id="K").replace_in("save", start_from="K"),
                                  max_iterations=2 * RESUME_K, device="cuda")
        got = losses[RESUME_K:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    err = max(float((a - b).detach().abs().max()) for name in ("tap", "cg")
              for a, b in zip(getattr(straight["state"], name).parameters(),
                              getattr(resumed["state"], name).parameters()))
    print(f"[22] f32 resume at step {RESUME_K} of {2 * RESUME_K}: losses of steps "
          f"{RESUME_K + 1}-{2 * RESUME_K} {[round(x, 6) for x in got]} against "
          f"{[round(x, 6) for x in want]} (max rel {rel:.2e}); parameters max|d| {err:.3e}")
    if len(got) != RESUME_K or not rel <= 1e-5 or not err <= 1e-5:
        fail("the resumed run disagrees with the uninterrupted one")


SCST_STEPS = 5  # phase 23: SCST steps (1 warm-up)
SAMPLE_SEED, COLD_T = 7, 1e-3  # phase 25: the draws' seed; the near-greedy temperature


def scst_cfg(**runtime):
    """train_cfg() (bench.py's e2e_train_cfg, nothing cut) with SCST from
    epoch 0."""
    return train_cfg(**runtime).replace_in("train", self_critical_after=0)


def stemmer_name():
    from echr_tpu_torch.metrics import scorers

    return ("nltk PorterStemmer" if getattr(scorers._STEM, "__self__", None) is not None
            else "identity (nltk absent)")


def phase_scst_train(card):
    """Phase 23: SCST through engine.train.train at the flagship width: 1
    warm-up and 4 timed steps of 32 videos.  Kernel 1 launches once a
    greedy-baseline decode step, kernel 2 too (R = B*N = 2048), kernel 3
    once a sampled decode step and L times a replay, kernel 4 L times an
    update.  Returns kernels 1-4's launches in the run."""
    from echr_tpu_torch.engine import rl
    from echr_tpu_torch.engine.train import train
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops.kernel_attention import (attention_scores_bwd,
                                                     attention_scores_dense,
                                                     attention_scores_masked)
    from echr_tpu_torch.ops.kernel_head import greedy_head

    from echr_tpu_torch.ops.kernel_recurrence import lstm_recurrence

    kernels = (attention_scores_masked, greedy_head, attention_scores_dense,
               attention_scores_bwd)
    cfg = scst_cfg()
    timing = {}
    for fn in kernels:
        fn.launches = 0
    decoder_sample_batched.steps = 0
    k11_before = lstm_recurrence.launches  # main() counts kernel 11 over the run
    torch.cuda.reset_peak_memory_stats()
    try:
        out = train(cfg, max_iterations=SCST_STEPS, device="cuda", timing_out=timing)
        torch.cuda.synchronize()
    finally:
        rl.close_default_reward_pool()  # joins the reward workers
    launches = {fn.__name__: fn.launches for fn in kernels}
    k11 = lstm_recurrence.launches - k11_before
    peak = torch.cuda.max_memory_allocated()
    sc = timing["scst"]
    if out["iteration"] != SCST_STEPS or len(sc) != SCST_STEPS:
        fail(f"SCST: train stopped at iteration {out['iteration']} with {len(sc)} SCST steps")
    if not all(np.isfinite(v) for v in out["losses"].values()) or "avg_reward" not in out[
            "losses"]:
        fail(f"SCST: losses {out['losses']}")
    sampled = sum(s["sample_steps"] for s in sc)
    greedy = sum(s["greedy_steps"] for s in sc)
    want = {"attention_scores_masked": greedy, "greedy_head": greedy,
            "attention_scores_dense": sampled + SEQ_LEN * SCST_STEPS,
            "attention_scores_bwd": SEQ_LEN * SCST_STEPS}
    decoded = sampled + greedy + SEQ_LEN * SCST_STEPS  # the replays run all L steps
    if launches != want or decoder_sample_batched.steps != decoded:
        fail(f"SCST: launches {launches}, want {want} ({sampled} sampled and {greedy} greedy "
             f"decode steps; the decoder counted {decoder_sample_batched.steps})")
    if k11 != cfg.tap.rnn_num_layers * SCST_STEPS:
        fail(f"SCST: kernel 11 launched {k11} times in {SCST_STEPS} steps: not once a step "
             f"and SST layer (the greedy baseline's encode only)")
    t = dict(timing["iters"])
    dt = (t[SCST_STEPS] - t[1]) / (SCST_STEPS - 1)
    part = {k: 1000 * np.mean([s[k] for s in sc[1:]]) for k in ("rollout", "reward", "update")}
    print(f"[23] SCST: {out['iteration']} steps of {TRAIN_B} videos (cotrain/tap_cg, vocab "
          f"{VOCAB}, L={SEQ_LEN}, T={T_BUCKET}, N={cfg.tap.prop_sample_num}, bf16, dropout on, "
          f"self_critical_after 0; nothing cut); launches {launches}, kernel 11 {k11} (the "
          f"greedy baselines'); sampled decode steps "
          f"{[s['sample_steps'] for s in sc]}, greedy baseline steps "
          f"{[s['greedy_steps'] for s in sc]}; avg_reward a step "
          f"{[round(s['avg_reward'], 5) for s in sc]}; last losses "
          f"{ {k: round(v, 5) for k, v in out['losses'].items()} }")
    print(f"[23] SCST {1000 * dt:.1f} ms/step over steps 2-{SCST_STEPS}: rollouts (sampled + "
          f"greedy baseline) {part['rollout']:.1f} ms, host reward {part['reward']:.1f} ms "
          f"({sc[-1]['reward_rows']} proposal rows, 2 captions each, pool of "
          f"{sc[-1]['pool_workers']} workers, stemmer: {stemmer_name()}), update "
          f"{part['update']:.1f} ms; the warm-up step {1000 * sum(sc[0][k] for k in part):.1f} "
          f"ms; peak device memory {peak / 2**30:.2f} GiB [{card}]")
    gen = torch.Generator().manual_seed(cfg.train.seed)  # train()'s init, again
    tap0, cg0 = init_tap(gen, out["config"]), init_captioner(gen, out["config"])
    for name, m0, m in (("tap", tap0, out["state"].tap), ("cg", cg0, out["state"].cg)):
        for (pn, p0), p in zip(m0.named_parameters(), m.parameters()):
            # the score bias shifts every score of a masked softmax: its
            # gradient is 0 up to rounding, and Adam's step on that rounds away
            if pn != "decoder.core.attention.alpha_net.bias" and torch.equal(
                    p0, p.detach().cpu()):
                fail(f"SCST: {name}.{pn} did not move in {out['iteration']} steps")
    return launches


def kernel4_check(name, args):
    """Kernel 4 on args (pre, q, w, g) against its plain version: d_pre and
    d_q within TOL, d_w (a sum of B*N*T terms) within 1e-4 of its largest
    entry.  Returns the worst d_pre / d_q error."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd

    got = attention_scores_bwd(*args)
    torch.cuda.synchronize()
    with force_plain():
        want = attention_scores_bwd(*args)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    if not (max(errs[:2]) <= TOL and errs[2] <= 1e-4 * float(want[2].abs().max())):
        fail(f"kernel 4 {name}: max|d| d_pre, d_q, d_w {errs}")
    return max(errs[:2])


def scst_parity_setup():
    """Phase 24's f32 state (phase 5's sharpened logit weights) and a batch
    of 4 videos of train_cfg()'s widths."""
    from echr_tpu_torch.data.batcher import make_batch
    from echr_tpu_torch.data.dataset import SyntheticDataset
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine.train import _collate
    from echr_tpu_torch.models.registry import init_captioner, init_tap

    cfg = scst_cfg(compute_dtype="float32").replace_in("decoder", CG_vocab_size=VOCAB,
                                                         CG_seq_length=SEQ_LEN)
    ds = SyntheticDataset(cfg, num_videos=8, seed=11)
    batch = steps.batch_to_device(_collate([
        make_batch(ds.get_example(i), cfg, np.random.RandomState(i), w1=ds.w1)[0]
        for i in range(4)]), "cuda")
    gen = torch.Generator().manual_seed(0)
    state = steps.init_train_state(cfg, init_tap(gen, cfg, "cuda"),
                                   init_captioner(gen, cfg, "cuda"))
    with torch.no_grad():
        state.cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
    return cfg, batch, state


def reward_mask(seq):
    """reward_loss's token mask: every emitted token and the end token."""
    m = (seq > 0).float()
    return torch.cat([torch.ones_like(m[..., :1]), m[..., :-1]], dim=-1)


def phase_scst_parity():
    """Phase 24: f32, TF32 off, phase 5's sharpened weights, dropout on, from
    the same generator states: the replay's logps of the rollout's tokens
    equal the rollout's within 1e-5; the greedy baseline's tokens are equal
    with the kernels and under force_plain(); one update's loss within 1e-5
    relative and its gradient leaves within atol 2e-4, rtol 1e-3 with the
    kernels and under force_plain(); kernels 1-4 on copies of the step's
    own arguments agree with their plain versions within 5e-4."""
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.models import decoder
    from echr_tpu_torch.ops import attention, force_plain, kernel_attention

    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 24 needs TF32 off")
    cfg, batch, state = scst_parity_setup()
    phase = "tap_cg"

    def gens(seed):
        return (torch.Generator(device="cuda").manual_seed(seed),
                torch.Generator(device="cuda").manual_seed(seed + 1))

    # the rollout and its replay, dropout on, kernels on
    gen, sample_gen = gens(21)
    before = gen.get_state()
    with torch.no_grad():
        _, seq, logps = steps._rl_forward(state.tap, state.cg, cfg, batch, phase, gen,
                                          sample_gen)
    gen.set_state(before)
    _, seq2, logps2 = steps._rl_forward(state.tap, state.cg, cfg, batch, phase, gen,
                                        forced=seq)
    m = reward_mask(seq)
    err_replay = float(((logps2.detach() - logps) * m).abs().max())
    del logps2
    if not (torch.equal(seq2, seq) and err_replay <= 1e-5):
        fail(f"SCST replay: logps max|d| {err_replay:.3e} against the rollout's")

    # the rollouts with the kernels and under force_plain(); kernels 1 and 2
    # kept on their first call
    seen1, seen2 = {}, {}
    with wrapped(attention, "attention_scores_masked", first_of_each_shape(seen1)), \
            wrapped(decoder, "greedy_head", first_of_each_shape(seen2)):
        _, gen_k, greedy_k = steps.rl_rollout_step_batched(state, batch, cfg, phase, *gens(31))
    gaps, invs = [], []

    def keep_gap(out, w, b):
        logits = torch.matmul(out.to(w.dtype).float(), w[:, :out.shape[1]].float().t()) + b
        top2 = torch.topk(logits, 2, dim=1).values
        gaps.append(top2[:, 0] - top2[:, 1])

    def keep_inv(ctxs, sort=decoder.sort_ctxs_by_window):
        ctxs, inv = sort(ctxs)
        invs.append(inv)
        return ctxs, inv
    with force_plain(), wrapped(decoder, "greedy_head", keep_gap), \
            patched(decoder, "sort_ctxs_by_window", keep_inv):
        _, gen_p, greedy_p = steps.rl_rollout_step_batched(state, batch, cfg, phase, *gens(31))
    B, N, L = gen_k.shape
    # a row is clear when every step's top two logits lie more than 1e-3 apart
    # (head_check's margin): kernel 2's f32 argmax and the plain one agree there
    gap = torch.stack(gaps, dim=-1).reshape(B, N, -1).amin(dim=-1)
    clear = torch.gather(gap, 1, invs[0]) > 1e-3 if invs else gap > 1e-3
    differ = (greedy_k != greedy_p).any(dim=-1)
    if bool((differ & clear).any()):
        fail(f"SCST greedy baseline: {int((differ & clear).sum())} rows with top-2 gaps above "
             f"1e-3 differ between the kernels and plain")
    worst1 = max(kernel1_check(f"baseline {k}", a)[0] for k, a in seen1.items())
    worst2 = max(head_check("24", f"baseline R={a[0].shape[0]}", a)[0] for a in seen2.values())

    # one update with the kernels and under force_plain(), the same gen_seq,
    # reward and dropout generator; kernels 3 and 4 kept on every call
    reward = torch.from_numpy(np.broadcast_to(np.random.RandomState(3).randn(B, N, 1),
                                              (B, N, L)).astype(np.float32)).to("cuda")
    fwd, bwd = [], []

    def keep(kept):
        return lambda *a: kept.append(tuple(x.detach().clone() for x in a))
    with wrapped(kernel_attention, "attention_scores_dense", keep(fwd)), \
            wrapped(kernel_attention, "attention_scores_bwd", keep(bwd)):
        (tk, ck), mk = steps._phase_grads(state, cfg, phase, steps._rl_losses, batch, phase,
                                          gens(41)[0], gen_k, reward)
    with force_plain():
        (tp, cp), mp = steps._phase_grads(state, cfg, phase, steps._rl_losses, batch, phase,
                                          gens(41)[0], gen_k, reward)
    mk, mp = steps.fetch_metrics(mk, mp)
    rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    names = ([f"tap.{n}" for n, _ in state.tap.named_parameters()]
             + [f"cg.{n}" for n, _ in state.cg.named_parameters()])
    worst, leaves = 0.0, []
    for name, a, b in zip(names, tk + ck, tp + cp):
        worst = max(worst, float((a - b).abs().max()))
        if not bool(((a - b).abs() <= 2e-4 + 1e-3 * b.abs()).all()):
            leaves.append(name)
    if not rel <= 1e-5 or leaves:
        fail(f"SCST update with the kernels disagrees with plain: rel {rel:.2e}, leaves "
             f"{leaves[:5]}")
    if len(fwd) != L or len(bwd) != L:
        fail(f"SCST update: kernel 3 ran {len(fwd)} times, kernel 4 {len(bwd)}, want {L}")
    worst3 = max(kernel3_check(f"replay step {i}", a)[0] for i, a in enumerate(fwd))
    worst4 = max(kernel4_check(f"replay step {i}", a) for i, a in enumerate(bwd))
    density = sum(int(a[4].ne(0).sum()) for a in fwd) / sum(a[4].numel() for a in fwd)
    del fwd, bwd
    print(f"[24] f32 SCST, dropout on, B={B}, N={N}: replay logps against the rollout's "
          f"max|d| {err_replay:.3e} over {int(m.sum())} reward tokens; greedy baseline with the "
          f"kernels and plain: {int(differ.sum())} of {B * N} rows differ, none of the "
          f"{int(clear.sum())} rows whose top-2 gaps stay above 1e-3 ({int((gen_k != gen_p).sum())} "
          f"sampled tokens differ: draws at near-equal cumulative probabilities); update loss "
          f"{mk['loss']:.6f} vs {mp['loss']:.6f} (rel {rel:.2e}), {len(names)} gradient leaves "
          f"max|d| {worst:.3e}")
    print(f"[24] on the step's own arguments against the plain versions: kernel 1 (baseline, "
          f"{len(seen1)} shape) {worst1:.3e}, kernel 2 (R={B * N}) {worst2:.3e}, kernel 3 "
          f"({L} replay calls, mask density {density:.4f}) {worst3:.3e}, kernel 4 ({L} calls) "
          f"{worst4:.3e}")
    scst_bf16_replay()


# phase 24: train()'s batch_size for the bf16 replay check.  With kernel 11 on
# the rollout's train-mode encode the replay read 3.0e-04 (batch_size 1) and
# 7.6e-04 (4) off the rollout; with the loop on both, 0 at each (H100 80GB
# HBM3, 700 W).  batch_size 1 runs the same batched step
SCST_BF16_BATCHES = (4,)


def scst_bf16_replay():
    """Phase 24 at bf16: train()'s first SCST step at the flagship training
    width (probe_scst_replay.train_pass).  The sampled rollout's train-mode
    encode runs without grad and the update replays it under autograd: both
    run the SST's loop (kernel 11 takes eval-mode encodes only), so the
    replay's tokens and logps are exactly the rollout's (ROADMAP C.2), and
    kernel 11 launches once a layer, for the greedy baseline's encode."""
    from echr_tpu_torch.experiments import probe_scst_replay
    from echr_tpu_torch.ops.kernel_recurrence import lstm_recurrence

    layers = probe_scst_replay.flagship_train_cfg("bfloat16").tap.rnn_num_layers
    for b in SCST_BF16_BATCHES:
        n0 = lstm_recurrence.launches
        r = probe_scst_replay.train_pass("cuda", batch_size=b)
        k11 = lstm_recurrence.launches - n0
        if not (r["tokens_equal"] and r["logps_max_abs_d"] == 0.0 and k11 == layers):
            fail(f"[24] bf16 SCST at batch_size {b}: tokens equal {r['tokens_equal']}, replay "
                 f"logps max|d| {r['logps_max_abs_d']:.3e} (want 0), kernel 11 launched {k11} "
                 f"times (want {layers}, the greedy baseline's)")
        print(f"[24] bf16 SCST in train() at batch_size {b}: the replay's logps equal the "
              f"rollout's exactly (max|d| {r['logps_max_abs_d']:.1e}); kernel 11 launched {k11} "
              f"times, once a layer for the greedy baseline")


def phase_sample_eval(card):
    """Phase 25: eval_split_batched with sample_max=0, temperature 1 and
    sample_seed 7 over phase 18's 64-video val split (tap_cg, top-128,
    batch 32, decode-only, every metric), after a warm-up group; a second
    pass with the seed gives the same predictions.  Then at f32 on phase
    5's sharpened weights, the greedy pass against sampling at T=1e-3.
    Kernel 1 launches once a decode step, kernel 2 never (the sampled head
    is the logits path).  Returns kernel 1's launches in the timed pass."""
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head

    cfg, tap, cg, ds, loader = eval_setup()
    usable = usable_val_videos(cfg, ds)
    durations = {ds.get_example(ix).vid: ds.get_example(ix).duration for ix in ds.split_ix["val"]}
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": True, "val_all_metrics": True,
          "get_eval_loss": False, "sample_max": 0, "temperature": 1.0, "sample_seed": SAMPLE_SEED}
    run = functools.partial(eval_split_batched, flag_eval_what="tap_cg", batch_videos=EVAL_B,
                            device="cuda")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run(tap, cg, loader, cfg, f"{tmp}/w.json",
                dict(kw, num_vids_eval=EVAL_B, language_eval=False))  # warm-up
            torch.cuda.synchronize()
            timing, score_s = {}, []
            for fn in (attention_scores_masked, greedy_head):
                fn.launches = 0
            decoder_sample_batched.steps = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            with timed_scoring(score_s):
                preds, score, _ = run(tap, cg, loader, cfg, f"{tmp}/a.json",
                                      dict(kw, timing_out=timing))
            wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
            k1, k2, steps = (attention_scores_masked.launches, greedy_head.launches,
                             decoder_sample_batched.steps)
            again, _, _ = run(tap, cg, loader, cfg, f"{tmp}/b.json", dict(kw, language_eval=False))
            with open(f"{tmp}/a.json") as fa, open(f"{tmp}/b.json") as fb:
                same_json = json.load(fa) == json.load(fb)
    finally:
        loader.load_state(loader.state())
    check_predictions(preds, usable, loader.dataset.ix_to_word, durations)
    if not (steps > 0 and k1 == steps and k2 == 0):
        fail(f"sampled eval: kernel 1 launched {k1} times, kernel 2 {k2}, in {steps} decode "
             f"steps (want {steps} and 0)")
    if not same_json:
        fail(f"sampled eval: two passes with sample_seed {SAMPLE_SEED} differ")
    metrics = ("Bleu_1", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "Recall", "Precision")
    if not all(np.shape(score.get(m)) == (4,) and np.isfinite(score[m]).all() for m in metrics):
        fail(f"sampled eval: scores {score}")
    n_caps = sum(len(c) for c in preds.values())
    run_s = wall - sum(score_s)
    print(f"[25] sampled eval (sample_max 0, T=1, sample_seed {SAMPLE_SEED}): {len(preds)} "
          f"videos, {n_caps} captions, {timing['groups']} groups of {EVAL_B}, {steps} decode "
          f"steps, kernel 1 launches {k1}, kernel 2 {k2}; a second pass with the seed gives "
          f"the same predictions JSON; e.g. {preds[sorted(preds)[0]][0]['sentence'][:60]!r}")
    print(f"[25] sampled eval: {len(preds) / run_s:.2f} eval videos/s, {n_caps / run_s:.1f} "
          f"captions/s over {run_s:.3f} s without scoring; eval_score {sum(score_s):.3f} s "
          f"(stemmer: {stemmer_name()}); peak device memory {peak / 2**30:.2f} GiB, bf16 "
          f"compute [{card}]")
    print(f"[25] sampled eval timing_out: "
          f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in timing.items()} }")
    cold_sampling()
    return k1


def cold_sampling():
    """f32, phase 5's sharpened weights: the greedy eval pass against
    sampling at T=1e-3.  Every draw whose top two logits lie at least 20 T
    apart (a non-argmax draw there has probability below e^-20) must take
    the argmax, the draws that leave it number the tempered softmax's
    expectation within 5 standard deviations (Poisson), and the sentences
    may differ from the greedy pass's only as often as draws left the
    argmax or met a top-2 gap below 1e-4 (where kernel 2's f32 argmax and
    the plain logits' may differ)."""
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.models import decoder

    cfg, tap, cg, ds, loader = eval_setup(compute_dtype="float32")
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": False, "get_eval_loss": False}
    stats = []
    draw = decoder._categorical

    def watched(logits, temperature, gen):
        tok = draw(logits, temperature, gen)
        top2, arg = torch.topk(logits, 2, dim=-1)
        gap = top2[:, 0] - top2[:, 1]
        off = tok != arg[:, 0]
        p_off = 1.0 - torch.softmax(logits.float() / temperature, dim=-1).max(dim=-1).values
        stats.append(torch.stack([off.sum(), (off & (gap >= 20 * temperature)).sum(),
                                  (gap < 1e-4).sum(), torch.tensor(gap.numel(), device=gap.device)]
                                 ).double().cpu().tolist() + [float(p_off.double().sum())])
        return tok
    try:
        with tempfile.TemporaryDirectory() as tmp:
            greedy, _, _ = eval_split_batched(tap, cg, loader, cfg, f"{tmp}/g.json", kw,
                                              flag_eval_what="tap_cg", batch_videos=EVAL_B,
                                              device="cuda")
            with patched(decoder, "_categorical", watched):
                cold, _, _ = eval_split_batched(
                    tap, cg, loader, cfg, f"{tmp}/c.json",
                    dict(kw, sample_max=0, temperature=COLD_T, sample_seed=SAMPLE_SEED),
                    flag_eval_what="tap_cg", batch_videos=EVAL_B, device="cuda")
    finally:
        loader.load_state(loader.state())
    off, off_clear, near_tie, draws, expected = np.sum(stats, axis=0)
    if sorted(cold) != sorted(greedy) or any(len(cold[v]) != len(greedy[v]) for v in greedy):
        fail("T=1e-3 sampling captioned other videos or proposals than the greedy pass")
    differ = sum(c["sentence"] != g["sentence"] for v in greedy
                 for c, g in zip(cold[v], greedy[v]))
    n = sum(len(v) for v in greedy.values())
    print(f"[25] f32, phase 5's weights, T={COLD_T}: {differ} of {n} sentences differ from the "
          f"greedy pass; {int(off)} of {int(draws)} draws left the argmax ({expected:.1f} "
          f"expected from the tempered softmax), {int(off_clear)} of them with a top-2 gap >= "
          f"{20 * COLD_T:g}; {int(near_tie)} draws had a gap below 1e-4")
    if off_clear or differ > off + near_tie or abs(off - expected) > 5 * expected ** 0.5 + 5:
        fail("T=1e-3 sampling strays from the greedy pass beyond its near-ties, or leaves "
             "the argmax at another rate than the tempered softmax gives")


FAMILY_B, FAMILY_XE_STEPS, FAMILY_SCST_STEPS = 8, 2, 2  # phase 26: videos a step; steps (1 warm-up)
FAMILY_SHARPEN = 8.0  # phase 5's logit weight scale


def family_cfg(model, base):
    """``base`` with the decoder core swapped.  show_attend_tell as
    experiments/train_SST.sh builds it (CG_num_layers 3), with "V+E+C"
    inputs and a "V+E" init state so that its attention and init_linear
    are live (tests/test_parity_sat.py's feature types), all_img the same;
    the other cores at their own layer counts."""
    from echr_tpu_torch.models.decoder import core_num_layers

    cfg = base.replace_in("decoder", caption_model=model, CG_num_layers=3)
    if model in ("show_attend_tell", "all_img"):
        cfg = cfg.replace_in("context", CG_input_feats_type="V+E+C", CG_init_feats_type="V+E")
    else:
        cfg = cfg.replace_in("decoder", CG_num_layers=core_num_layers(cfg))
    return cfg.validate()


def _zero(fns):
    for fn in fns:
        fn.launches = 0


def family_greedy(card, model):
    """CaptionService greedy at the flagship width: one warm-up chunk of 32
    videos, then one timed chunk (4096 decode rows).  Kernel 2 launches
    once a decode step, kernel 1 too where the core's attention is live
    and never where it is not.  Returns (launches, tap, cg, vocab)."""
    from echr_tpu_torch.models.decoder import attention_live, decoder_sample_batched
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.serve import CaptionService

    cfg = family_cfg(model, flagship_cfg())
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=32, topN=TOP_N)
    reqs = requests(64, seed=26)
    svc.caption(reqs[:32])  # warm-up
    torch.cuda.synchronize()
    _zero((attention_scores_masked, greedy_head))
    decoder_sample_batched.steps = 0
    t0 = time.time()
    res = svc.caption(reqs[32:])
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {"attention_scores_masked": attention_scores_masked.launches,
                "greedy_head": greedy_head.launches}
    steps = decoder_sample_batched.steps
    check_captions(res, reqs[32:], ties=True)
    live = attention_live(cfg)
    want = {"attention_scores_masked": steps if live else 0, "greedy_head": steps}
    if steps <= 0 or launches != want:
        fail(f"{model}: greedy launches {launches}, want {want} ({steps} decode steps, "
             f"attention {'live' if live else 'unused'})")
    n_caps = sum(len(c) for c in res.values())
    print(f"[26] {model}: greedy {n_caps / dt:.1f} captions/s (32 videos x {TOP_N} proposals in "
          f"{dt:.3f} s, logit width {cg.decoder.logit.weight.shape[1]}, {steps} decode steps, "
          f"launches {launches}) [{card}]")
    return launches, tap, cg, vocab


def family_beam(card, model, tap, cg, vocab):
    """CaptionService(beam_size=4), one warm-up chunk of 32 videos, then one
    timed chunk (16384 beam rows); kernel 1 launches once a beam step.
    Returns kernel 1's launches."""
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.serve import CaptionService

    cfg = family_cfg(model, flagship_cfg())
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=32, topN=TOP_N,
                         beam_size=BEAM)
    reqs = requests(64, seed=27)
    svc.caption(reqs[:32])  # warm-up
    torch.cuda.synchronize()
    _zero((attention_scores_masked,))
    beam_search_batched.steps = 0
    t0 = time.time()
    res = svc.caption(reqs[32:])
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches, steps = attention_scores_masked.launches, beam_search_batched.steps
    check_captions(res, reqs[32:], ties=True)
    if not (steps > 0 and launches == steps):
        fail(f"{model}: kernel 1 launched {launches} times in {steps} beam steps")
    n_caps = sum(len(c) for c in res.values())
    print(f"[26] {model}: beam {BEAM} {n_caps / dt:.1f} captions/s, {1000 * dt:.1f} ms for one "
          f"chunk of 32 videos x {TOP_N} proposals x {BEAM} beams ({steps} beam steps, kernel 1 "
          f"launches {launches}) [{card}]")
    return launches


TIE_GAP = 1e-4  # a top-2 logit gap within f32 reassociation noise (phase 25's near-tie)


def family_parity(model, tap, cg, vocab):
    """Phase 5 for the core: f32, TF32 off, phase 5's sharpened logit
    weights, 4 videos with the kernels and under force_plain().  Tokens
    equal on every proposal, except one whose first differing token is a
    near-tie of the plain decode (top-2 logit gap below TIE_GAP, where f32
    sums in another order may pick either); logps within TOL on the
    proposals whose tokens are equal.  The window sort is off, so that the
    head's rows are the proposals in their own order."""
    from echr_tpu_torch.engine.steps import decode_step_batched
    from echr_tpu_torch.models import decoder
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.serve import CaptionService

    cfg = family_cfg(model, flagship_cfg(compute_dtype="float32", sort_decode_props=False))
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(FAMILY_SHARPEN)
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=4, topN=TOP_N)
    _, _, args = svc.prepare_chunk(requests(4, seed=3), T_BUCKET)
    seq_k, lp_k, _ = decode_step_batched(*args)
    gaps = []

    def gap(out, w, b):
        top2 = torch.topk(out @ w[:, :out.shape[1]].t() + b, 2, dim=1).values
        gaps.append(top2[:, 0] - top2[:, 1])
    with force_plain(), wrapped(decoder, "greedy_head", gap):
        seq_p, lp_p, _ = decode_step_batched(*args)
    B, N, _ = seq_k.shape
    gaps = torch.stack(gaps, dim=1).reshape(B, N, -1)
    diff = seq_k != seq_p
    off = diff.any(dim=-1)
    first = diff.int().argmax(dim=-1).clamp(max=gaps.shape[-1] - 1)
    first_gap = torch.gather(gaps, 2, first[..., None])[..., 0]
    clear = off & (first_gap >= TIE_GAP)
    err = float((lp_k - lp_p).abs()[~off].max())
    print(f"[26] {model}: f32 greedy, kernels vs plain: {int(diff.sum())} token mismatches of "
          f"{seq_k.numel()} on {int(off.sum())} of {B * N} proposals (top-2 gaps at their first "
          f"difference {[round(float(g), 7) for g in first_gap[off]]}), max|d| logps {err:.3e} "
          f"on the rest; {int((seq_k > 0).sum())} non-EOS tokens")
    if bool(clear.any()) or not err <= TOL:
        fail(f"{model}: the f32 decode with the kernels disagrees with its plain version")


# cores whose steps read no event context: the TSRM's gradient is zero
NO_EVENT = ("three_stream_2stream_LDA", "three_stream_2stream_CC")


def _moved(model, out, what):
    """Every parameter of train()'s state differs from train()'s seeded
    init, the score bias aside (phase 23), and the TSRM for NO_EVENT."""
    from echr_tpu_torch.models.registry import init_captioner, init_tap

    gen = torch.Generator().manual_seed(out["config"].train.seed)  # train()'s init, again
    tap0, cg0 = init_tap(gen, out["config"]), init_captioner(gen, out["config"])
    for name, m0, m in (("tap", tap0, out["state"].tap), ("cg", cg0, out["state"].cg)):
        for (pn, p0), p in zip(m0.named_parameters(), m.parameters()):
            unused = model in NO_EVENT and pn.startswith("fusion.")
            if (pn != "decoder.core.attention.alpha_net.bias" and not unused
                    and torch.equal(p0, p.detach().cpu())):
                fail(f"{model} {what}: {name}.{pn} did not move in {out['iteration']} steps")


def family_train(card, model, folder):
    """engine.train.train, XE: 1 warm-up and 1 timed step of 8 videos
    (train_cfg(): cotrain / tap_cg, bf16, dropout on).  Kernels 3 and 4
    launch once a teacher-forced step where the attention is live, never
    for all_img."""
    from echr_tpu_torch.engine.train import train
    from echr_tpu_torch.models.decoder import attention_live
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd, attention_scores_dense

    cfg = family_cfg(model, train_cfg()).replace_in(
        "train", batch_size=FAMILY_B).replace_in("save", checkpoint_path=folder).replace(
        run_id=model)
    timing = {}
    _zero((attention_scores_dense, attention_scores_bwd))
    out = train(cfg, max_iterations=FAMILY_XE_STEPS, device="cuda", timing_out=timing)
    torch.cuda.synchronize()
    launches = {"attention_scores_dense": attention_scores_dense.launches,
                "attention_scores_bwd": attention_scores_bwd.launches}
    if out["iteration"] != FAMILY_XE_STEPS:
        fail(f"{model}: train stopped at iteration {out['iteration']}")
    if not all(np.isfinite(v) for v in out["losses"].values()):
        fail(f"{model}: non-finite losses {out['losses']}")
    n = (SEQ_LEN - 1) * FAMILY_XE_STEPS if attention_live(cfg) else 0
    if launches != {"attention_scores_dense": n, "attention_scores_bwd": n}:
        fail(f"{model}: XE launches {launches}, want {n} each")
    _moved(model, out, "XE")
    t = dict(timing["iters"])
    ms = 1000 * (t[FAMILY_XE_STEPS] - t[1]) / (FAMILY_XE_STEPS - 1)
    print(f"[26] {model}: XE {ms:.1f} ms/step over steps 2-{FAMILY_XE_STEPS} of {FAMILY_B} videos "
          f"(tap_cg, bf16, dropout on), launches {launches}, last loss "
          f"{out['losses']['loss']:.4f} [{card}]")
    return launches


def family_scst(card, model, folder):
    """engine.train.train with self_critical_after 0: 1 warm-up and 1 timed
    SCST step of 8 videos; launches as phase 23 counts them."""
    from echr_tpu_torch.engine import rl
    from echr_tpu_torch.engine.train import train
    from echr_tpu_torch.ops.kernel_attention import (attention_scores_bwd,
                                                     attention_scores_dense,
                                                     attention_scores_masked)
    from echr_tpu_torch.ops.kernel_head import greedy_head

    kernels = (attention_scores_masked, greedy_head, attention_scores_dense,
               attention_scores_bwd)
    cfg = family_cfg(model, scst_cfg()).replace_in(
        "train", batch_size=FAMILY_B).replace_in("save", checkpoint_path=folder).replace(
        run_id=model + "_scst")
    timing = {}
    _zero(kernels)
    try:
        out = train(cfg, max_iterations=FAMILY_SCST_STEPS, device="cuda", timing_out=timing)
        torch.cuda.synchronize()
    finally:
        rl.close_default_reward_pool()  # joins the reward workers
    launches = {fn.__name__: fn.launches for fn in kernels}
    sc = timing["scst"]
    if out["iteration"] != FAMILY_SCST_STEPS or len(sc) != FAMILY_SCST_STEPS:
        fail(f"{model}: SCST stopped at iteration {out['iteration']} with {len(sc)} SCST steps")
    if not all(np.isfinite(v) for v in out["losses"].values()) or "avg_reward" not in out[
            "losses"]:
        fail(f"{model}: SCST losses {out['losses']}")
    sampled = sum(s["sample_steps"] for s in sc)
    greedy = sum(s["greedy_steps"] for s in sc)
    want = {"attention_scores_masked": greedy, "greedy_head": greedy,
            "attention_scores_dense": sampled + SEQ_LEN * FAMILY_SCST_STEPS,
            "attention_scores_bwd": SEQ_LEN * FAMILY_SCST_STEPS}
    if launches != want:
        fail(f"{model}: SCST launches {launches}, want {want}")
    _moved(model, out, "SCST")
    t = dict(timing["iters"])
    ms = 1000 * (t[FAMILY_SCST_STEPS] - t[1]) / (FAMILY_SCST_STEPS - 1)
    part = {k: 1000 * sc[-1][k] for k in ("rollout", "reward", "update")}
    print(f"[26] {model}: SCST {ms:.1f} ms for step {FAMILY_SCST_STEPS} of {FAMILY_B} videos "
          f"(rollouts {part['rollout']:.1f}, reward {part['reward']:.1f}, update "
          f"{part['update']:.1f} ms), launches {launches}, avg_reward "
          f"{out['losses']['avg_reward']:.5f} [{card}]")
    return launches


def phase_family(card):
    """Phase 26: every other core of the decoder family through serving,
    XE training and (show_attend_tell) beam and SCST; kernel 2 at the
    family's logit widths.  Returns (kernels 1-4's launches on the
    family's main paths, kernel 2's records by width)."""
    import shutil

    from echr_tpu_torch.models.decoder import CORE_REGISTRY
    from echr_tpu_torch.ops.kernel_head import split_plan

    t_phase = time.time()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.RandomState(26)
    widths = {}
    for C in (512, 1024):  # show_attend_tell, all_img, h3, h3_dense_add; the two-stream cores
        args = head_inputs(rng, 4096, C, VOCAB + 1, torch.bfloat16, dev)
        plan = split_plan(4096, VOCAB + 1, sms, torch.bfloat16)
        err, outs = head_check("26", f"C={C} ({plan[1]} splits)", args)
        widths[f"C{C}"] = {**head_timing(card, args, outs, plan, tag="26"), "max_abs_err": err}
        del args, outs
    launches = {"attention_scores_masked": 0, "greedy_head": 0, "attention_scores_dense": 0,
                "attention_scores_bwd": 0}
    cores = 0
    folder = tempfile.mkdtemp(prefix="chip_smoke_family_")
    try:
        for model in sorted(set(CORE_REGISTRY) - {"three_stream"}):
            served, tap, cg, vocab = family_greedy(card, model)
            if model == "show_attend_tell":
                served["attention_scores_masked"] += family_beam(card, model, tap, cg, vocab)
            family_parity(model, tap, cg, vocab)
            del tap, cg
            counts = [served, family_train(card, model, folder)]
            if model == "show_attend_tell":
                counts.append(family_scst(card, model, folder))
            for c in counts:
                for k, v in c.items():
                    launches[k] += v
            cores += 1
            shutil.rmtree(folder, ignore_errors=True)  # the run folders' checkpoints
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"[26] decoder family: {cores} cores, launches on their main paths {launches}; "
          f"phase wall {time.time() - t_phase:.1f} s [{card}]")
    return launches, widths


SOTA_PER_VIDEO = 100  # external proposals a val video: the AR@100 convention of proposal outputs
SOTA_SEED = 27

# phase 27's serve CLI child: python -m echr_tpu_torch.cli.serve's run (runpy
# runs the module as __main__), with kernels 1 and 2's launch counts and the
# decode steps set to 0 before it and printed as the last line after it
SERVE_CHILD = """
import json, runpy, sys
from echr_tpu_torch.models.beam import beam_search_batched
from echr_tpu_torch.models.decoder import decoder_sample_batched
from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
from echr_tpu_torch.ops.kernel_head import greedy_head
attention_scores_masked.launches = greedy_head.launches = 0
decoder_sample_batched.steps = beam_search_batched.steps = 0
sys.argv = ["echr_tpu_torch.cli.serve", *json.loads(sys.argv[1])]
runpy.run_module("echr_tpu_torch.cli.serve", run_name="__main__", alter_sys=True)
print(json.dumps({"attention_scores_masked": attention_scores_masked.launches,
                  "greedy_head": greedy_head.launches,
                  "greedy_steps": decoder_sample_batched.steps,
                  "beam_steps": beam_search_batched.steps}))
"""


def write_sota_json(paths, out, seed=SOTA_SEED):
    """A proposals JSON in the ActivityNet results layout (keys without the
    'v_' prefix): for each val video of the exported annotations,
    SOTA_PER_VIDEO proposals, three jittered copies of each GT event and
    random windows of 2-52% of the video after them, with uniform scores,
    all drawn from ``seed``.  Returns {vid: [{segment, score}, ...]}."""
    with open(paths["video_json"]) as f:
        anno = json.load(f)
    with open(paths["video_data_for_cg"]) as f:
        vids = [v["video_id"] for v in json.load(f)["videos"] if v["split"] == "val"]
    rng = np.random.RandomState(seed)
    results = {}
    for vid in vids:
        d = float(anno[vid]["duration"])
        segs = []
        for s, e in anno[vid]["timestamps"]:
            for _ in range(3):
                j = (rng.rand(2) - 0.5) * 0.2 * (e - s)
                a = min(max(0.0, s + j[0]), d - 0.5)
                segs.append([a, min(d, max(a + 0.5, e + j[1]))])
        while len(segs) < SOTA_PER_VIDEO:
            a = rng.rand() * d * 0.9
            segs.append([a, min(d, a + (0.02 + 0.5 * rng.rand()) * d)])
        results[vid[2:]] = [{"segment": [float(a), float(b)], "score": float(rng.rand())}
                            for a, b in segs[:SOTA_PER_VIDEO]]
    with open(out, "w") as f:
        json.dump({"version": "VERSION 1.0", "results": results,
                   "external_data": {"used": True, "details": "jittered GT and random windows"}},
                  f)
    return {"v_" + k: v for k, v in results.items()}


def validate_corpus(cfg, paths, sota_path):
    """cli/validate_data over the exported tree with the proposals JSON,
    every .npy opened; it must exit 0."""
    import io

    from echr_tpu_torch.cli import validate_data

    argv = [x for k, v in paths.items() for x in (f"--{k}", v)]
    argv += ["--SOTA_json", sota_path, "--K", str(cfg.tap.K), "--video_dim",
             str(cfg.tap.video_dim), "--lda_dim", str(cfg.data.lda_dim), "--sample_videos", "0"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = validate_data.main(argv)
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"[27] validate_data: {line}")
    if code != 0:
        fail(f"validate_data exited {code} on the exported corpus")


def json_sota_synthetic(cfg, sota_path):
    """The in-memory SyntheticDataset of ``cfg`` with the external proposals
    of a JSON, read as ActivityNetDataset reads them."""
    from echr_tpu_torch.data.dataset import BaseDataset, SyntheticDataset

    class JsonSota(SyntheticDataset):
        get_sota = BaseDataset.get_sota

    ds = JsonSota(cfg)
    with open(sota_path) as f:
        ds.sota_proposals = json.load(f)["results"]
    return ds


def sota_loader(root, sota_path, disk=True, **runtime):
    """(cfg, dataset, Loader, SST, Captioner): phase 18's seeded init over
    the exported corpus read from disk (or over the in-memory corpus) with
    the proposals JSON."""
    from echr_tpu_torch.data.dataset import build_dataset
    from echr_tpu_torch.data.export_disk import disk_cfg
    from echr_tpu_torch.data.loader import Loader
    from echr_tpu_torch.models.registry import init_captioner, init_tap

    cfg = eval_cfg(**runtime)
    if disk:
        cfg = disk_cfg(cfg, root).replace_in("data", SOTA_json=sota_path)
        ds = build_dataset(cfg)
    else:
        ds = json_sota_synthetic(cfg, sota_path)
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    return cfg, ds, Loader(ds, cfg, process_index=0, process_count=1, seed=0), tap, cg


def sota_eval(card, root, sota_path, proposals, dev="cuda"):
    """The SOTA_TEP eval from disk: eval_split_batched(flag_eval_what=
    "SOTA_TEP") over the 64 val videos, 32 a group, greedy with val
    losses, every metric, after a warm-up group that keeps copies of
    kernels 1 and 2's arguments at the first decode step.  Returns
    (launches, kernel 1's arguments and the step's feats, kernel 2's)."""
    from echr_tpu_torch.engine import evaluate
    from echr_tpu_torch.models import decoder
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head

    cfg, ds, loader, tap, cg = sota_loader(root, sota_path)
    usable = usable_val_videos(cfg, ds)
    durations = {v: float(a["duration"]) for v, a in ds.annotations.items()}
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": True, "val_all_metrics": True,
          "get_eval_loss": True}
    run = functools.partial(evaluate.eval_split_batched, flag_eval_what="SOTA_TEP",
                            batch_videos=EVAL_B, device=dev)
    decoding, kept = [], {}
    decode = evaluate.decode_step_batched

    def in_decode(*args, **kw):
        decoding.append(True)
        try:
            return decode(*args, **kw)
        finally:
            decoding.pop()

    def keep(name):
        def hook(*args):
            if decoding and name not in kept:
                kept[name] = tuple(a.detach().clone() for a in args)
        return hook
    k1 = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with patched(evaluate, "decode_step_batched", in_decode), \
                    kept_attention_calls(k1, lambda a: decoding and not k1), \
                    wrapped(decoder, "greedy_head", keep("k2")):
                run(tap, cg, loader, cfg, f"{tmp}/w.json",
                    dict(kw, num_vids_eval=EVAL_B, language_eval=False))  # warm-up
            torch.cuda.synchronize()
            timing, score_s = {}, []
            _zero((attention_scores_masked, greedy_head))
            decoder_sample_batched.steps = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            with timed_scoring(score_s):
                preds, score, losses = run(tap, cg, loader, cfg, f"{tmp}/p.json",
                                           dict(kw, timing_out=timing))
            wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
    finally:
        loader.load_state(loader.state())
    if torch.backends.cuda.matmul.allow_tf32:
        fail("SOTA_TEP eval: the eval left TF32 on")
    n1, n2, steps = attention_scores_masked.launches, greedy_head.launches, \
        decoder_sample_batched.steps
    check_predictions(preds, usable, ds.ix_to_word, durations)
    for vid, caps in preds.items():  # every proposal of the JSON, in its order
        if [(c["timestamp"], c["proposal_score"]) for c in caps] != \
                [(p["segment"], p["score"]) for p in proposals[vid]]:
            fail(f"SOTA_TEP eval: {vid}'s predictions are not its {SOTA_PER_VIDEO} external "
                 f"proposals")
    want_k1 = steps + (SEQ_LEN - 1) * timing["groups"]
    if not (steps > 0 and n1 == want_k1 and n2 == steps):
        fail(f"SOTA_TEP eval: kernel 1 launched {n1} times (want {want_k1}), kernel 2 {n2} "
             f"(want {steps})")
    if not (np.isfinite(losses).all() and (losses[:3] > 0).all()):
        fail(f"SOTA_TEP eval: val losses {losses}")
    metrics = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr",
               "Recall", "Precision")
    if not all(np.shape(score.get(m)) == (4,) and np.isfinite(score[m]).all() for m in metrics):
        fail(f"SOTA_TEP eval: scores {score}")
    n_caps = sum(len(c) for c in preds.values())
    run_s = wall - sum(score_s)
    print(f"[27] SOTA_TEP eval from disk: {len(preds)} videos (of {len(usable)} usable), "
          f"{n_caps} captions, {timing['groups']} groups of {EVAL_B}, {steps} decode steps, "
          f"kernel 1 launches {n1}, kernel 2 {n2}; val losses "
          f"{np.round(losses[:3], 4).tolist()}; all scored")
    print(f"[27] SOTA_TEP eval: {len(preds) / run_s:.2f} eval videos/s, {n_caps / run_s:.1f} "
          f"captions/s over {run_s:.3f} s without scoring; eval_score {sum(score_s):.3f} s "
          f"(stemmer: {stemmer_name()}); peak device memory {peak / 2**30:.2f} GiB, bf16 "
          f"compute [{card}]")
    print(f"[27] SOTA_TEP eval timing_out: "
          f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in timing.items()} }")
    print(f"[27] SOTA_TEP eval scores: { {m: np.round(score[m], 4).tolist() for m in metrics} }")
    if not k1 or "k2" not in kept:
        fail("SOTA_TEP eval: kernels 1 and 2 were not called in a decode step")
    return {"attention_scores_masked": n1, "greedy_head": n2}, k1[0], kept["k2"]


def gap_recorder():
    """(gaps, decode hook, head hook): gaps[k] lists, for the k-th
    decode_step_batched call, the [R] top-2 logit gap of each step's
    greedy_head call."""
    gaps = []

    def on_decode(*args):
        gaps.append([])

    def on_head(out, w, b):
        top2 = torch.topk(out.float() @ w[:, :out.shape[1]].float().t() + b, 2, dim=1).values
        gaps[-1].append(top2[:, 0] - top2[:, 1])
    return gaps, on_decode, on_head


def eval_with_gaps(tap, cg, loader, cfg, json_path, dev="cuda"):
    """A greedy SOTA_TEP eval pass (val losses on, no scoring) with the
    top-2 gap of every decode row: returns (predictions, val losses,
    gaps), gaps[k] a [steps, EVAL_B, nb] array of group k."""
    from echr_tpu_torch.engine import evaluate
    from echr_tpu_torch.models import decoder

    gaps, on_decode, on_head = gap_recorder()
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": False, "get_eval_loss": True}
    with wrapped(evaluate, "decode_step_batched", on_decode), \
            wrapped(decoder, "greedy_head", on_head):
        preds, _, losses = evaluate.eval_split_batched(
            tap, cg, loader, cfg, json_path, kw, flag_eval_what="SOTA_TEP",
            batch_videos=EVAL_B, device=dev)
    return preds, losses, [torch.stack(g).cpu().numpy().reshape(len(g), EVAL_B, -1)
                           for g in gaps]


def near_tie_compare(tag, got, want, want_gaps, usable, got_loss, want_loss):
    """The SOTA_TEP passes ``got`` and ``want`` caption the same videos with
    the same proposals (timestamps and proposal scores equal); a sentence
    may differ only where its first differing token is a near-tie of
    ``want``'s decode (top-2 logit gap below TIE_GAP); the confidences of
    equal sentences within TOL a token; val losses within 1e-5 relative.
    The window sort is off, so video u's proposal j is row j of its group's
    row u % EVAL_B."""
    if sorted(got) != sorted(want) or not want:
        fail(f"{tag}: the passes captioned other videos")
    differ, firsts, worst, n = 0, [], 0.0, 0
    for u, vid in enumerate(usable):
        if vid not in want:
            continue
        if len(got[vid]) != len(want[vid]):
            fail(f"{tag}: {vid} has {len(got[vid])} predictions against {len(want[vid])}")
        g_steps = want_gaps[u // EVAL_B][:, u % EVAL_B]
        for j, (g, w) in enumerate(zip(got[vid], want[vid])):
            n += 1
            if (g["timestamp"], g["proposal_score"]) != (w["timestamp"], w["proposal_score"]):
                fail(f"{tag}: {vid} proposal {j} differs in timestamp or proposal score")
            if g["sentence"] == w["sentence"]:
                err = abs(g["sentence_confidence"] - w["sentence_confidence"])
                worst = max(worst, err / (len(w["sentence"].split()) + 1))
                continue
            tg, tw = g["sentence"].split() + [""], w["sentence"].split() + [""]
            step = next(i for i, (a, b) in enumerate(zip(tg, tw)) if a != b)
            differ += 1
            firsts.append(float(g_steps[min(step, len(g_steps) - 1), j]))
    rel = float((np.abs(got_loss[:3] - want_loss[:3]) / np.abs(want_loss[:3])).max())
    print(f"[27] {tag}: {len(want)} videos, {n} captions, {differ} sentences differ (top-2 gaps "
          f"at their first difference {[round(x, 7) for x in firsts]}); max|d| confidence "
          f"{worst:.3e} a token; val losses {np.round(want_loss[:3], 6).tolist()} (rel "
          f"{rel:.2e})")
    if any(x >= TIE_GAP for x in firsts) or not worst <= TOL or not rel <= 1e-5:
        fail(f"{tag}: the passes disagree beyond the near-ties")


def sota_parity(root, sota_path, dev="cuda"):
    """f32, TF32 off, phase 5's sharpened logit weights, window sort off:
    the SOTA_TEP pass from disk against the pass over the in-memory corpus
    (the features differ by the C3D moments' f32 rounding), and the disk
    pass with the kernels against force_plain()."""
    from echr_tpu_torch.ops import force_plain

    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 27's parity needs TF32 off")
    runtime = {"compute_dtype": "float32", "sort_decode_props": False}
    dcfg, dds, dloader, tap, cg = sota_loader(root, sota_path, **runtime)
    mcfg, mds, mloader, _, _ = sota_loader(root, sota_path, disk=False, **runtime)
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
    usable = usable_val_videos(dcfg, dds)
    if usable != usable_val_videos(mcfg, mds):
        fail("the disk and in-memory corpora have other usable val videos")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            mem = eval_with_gaps(tap, cg, mloader, mcfg, f"{tmp}/m.json", dev)
            disk = eval_with_gaps(tap, cg, dloader, dcfg, f"{tmp}/d.json", dev)
            with force_plain():
                plain = eval_with_gaps(tap, cg, dloader, dcfg, f"{tmp}/p.json", dev)
    finally:
        for ld in (dloader, mloader):
            ld.load_state(ld.state())
    near_tie_compare("f32 SOTA_TEP, disk vs in-memory", disk[0], mem[0], mem[2], usable,
                     disk[1], mem[1])
    near_tie_compare("f32 SOTA_TEP from disk, kernels vs plain", disk[0], plain[0], plain[2],
                     usable, disk[1], plain[1])


def reference_state_dicts(tap, cg):
    """The reference's 'tap_model' and 'cg_model' state_dicts
    (train.py:456-461) of the port's SST and three_stream Captioner (TSRM
    fusion), from the modules' own tensors: a Linear or LSTM cell keeps its
    [out, in] weight, TSRM's grouped projection [d_o, d] is the reference's
    grouped 1x1 conv [d_o, d, 1, 1].  Plus a parameter the model does not
    read (ThreeStream's fusion_layer)."""
    def lin(sd, prefix, m):
        sd[f"{prefix}.weight"] = m.weight
        if m.bias is not None:
            sd[f"{prefix}.bias"] = m.bias

    def cell(sd, prefix, c, suffix=""):
        for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            sd[f"{prefix}.{k}{suffix}"] = getattr(c, k)
    tap_sd = {}
    for i, c in enumerate(tap.rnn):
        cell(tap_sd, "rnn", c, f"_l{i}")
    lin(tap_sd, "scores", tap.scores)
    dec, f = cg.decoder, cg.fusion
    cg_sd = {"lm_model.embed.weight": dec.embed,
             "lm_model.core.fusion_layer.weight": torch.zeros(8, 8)}
    lin(cg_sd, "lm_model.logit", dec.logit)
    for name in ("layer0", "layer1", "layer2"):
        cell(cg_sd, f"lm_model.core.{name}", getattr(dec.core, name))
    for name in ("ctx2att", "h2att", "alpha_net"):
        lin(cg_sd, f"lm_model.core.attention.{name}", getattr(dec.core.attention, name))
    if dec.init_linear is not None:
        lin(cg_sd, "lm_model.init_linear", dec.init_linear)
    lin(cg_sd, "fusion_model.event_emb", f.event_emb)
    lin(cg_sd, "fusion_model.enc_attn.query_1", f.query)
    lin(cg_sd, "fusion_model.enc_attn.key_1", f.key)
    cg_sd["fusion_model.enc_attn.linear_out_1.weight"] = f.out.weight[:, :, None, None]
    cg_sd["fusion_model.enc_attn.linear_out_1.bias"] = f.out.bias
    if f.pair_pos_fc1 is not None:
        lin(cg_sd, "fusion_model.enc_attn.pair_pos_fc1", f.pair_pos_fc1)
        lin(cg_sd, "fusion_model.enc_attn.pair_pos_fc2", f.pair_pos_fc2)
    return ({k: v.detach().cpu().clone() for k, v in tap_sd.items()},
            {k: v.detach().cpu().clone() for k, v in cg_sd.items()})


def pth_round_trip(card, folder, vocab, dev="cuda"):
    """The port's seeded three_stream weights (phase 18's init) written as a
    reference .pth and read back by import_reference_checkpoint: every
    parameter bit-equal, and greedy captions of 32 requests equal to the
    original modules'.  Returns the imported (SST, Captioner) and the .pth
    path."""
    from echr_tpu_torch.compat import import_reference_checkpoint
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.serve import CaptionService

    cfg = eval_cfg()
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    tap_sd, cg_sd = reference_state_dicts(tap, cg)
    pth = f"{folder}/reference.pth"
    torch.save({"tap_model": tap_sd, "cg_model": cg_sd, "iteration": 0}, pth)
    t0 = time.time()
    itap, icg = import_reference_checkpoint(pth, cfg, dev)
    load_s = time.time() - t0
    n = 0
    for a, b in ((tap, itap), (cg, icg)):
        sa, sb = a.state_dict(), b.state_dict()
        if list(sa) != list(sb):
            fail(f".pth round trip: parameter names {sorted(set(sa) ^ set(sb))[:4]} differ")
        for k in sa:
            n += 1
            if sb[k].device.type != torch.device(dev).type or \
                    not torch.equal(sa[k].to(sb[k].device), sb[k]):
                fail(f".pth round trip: {k} differs or is not on {dev}")
    reqs = requests(32, seed=28)
    caps = [CaptionService(cfg, m[0], m[1], vocab, device=dev, batch_videos=32,
                           topN=TOP_N).caption(reqs) for m in ((tap, cg), (itap, icg))]
    if caps[0] != caps[1]:
        fail(".pth round trip: the imported weights caption otherwise than the original's")
    print(f"[27] .pth round trip: {len(tap_sd) + len(cg_sd)} reference tensors "
          f"({os.path.getsize(pth) / 2**20:.1f} MiB) imported onto the card in {load_s:.2f} s, "
          f"{n} parameters bit-equal; greedy captions of 32 requests equal "
          f"({sum(len(c) for c in caps[0].values())} captions) [{card}]")
    return itap, icg, pth


def serve_cli(card, ckpt, feats_dir, dur_json, refs_json, out, beam, dev="cuda"):
    """python -m echr_tpu_torch.cli.serve over the val .npy files in a
    child process whose exit code is checked (SERVE_CHILD), then for
    greedy cli/score on its JSON against the val annotations.  Returns
    kernels 1 and 2's launches in the child."""
    from echr_tpu_torch.cli import score as score_cli

    argv = ["--checkpoint", ckpt, "--features_dir", feats_dir, "--output", out,
            "--duration_json", dur_json, "--beam_size", str(beam), "--device", dev]
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", SERVE_CHILD, json.dumps(argv)],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        fail(f"serve CLI (beam {beam}) exited {proc.returncode}: {proc.stderr[-2000:]}")
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    rate = re.search(r"captioned (\d+) videos \((\d+) captions\) in ([\d.]+)s \(([\d.]+) "
                     r"captions/s\)", proc.stderr)
    with open(out) as f:
        res = json.load(f)["results"]
    with open(dur_json) as f:
        durations = json.load(f)
    if sorted(res) != sorted(durations):
        fail(f"serve CLI (beam {beam}): captions for {len(res)} of {len(durations)} videos")
    for vid, caps in res.items():
        if not 0 < len(caps):
            fail(f"serve CLI (beam {beam}): no captions for {vid}")
        for c in caps:
            s, e = c["timestamp"]
            if not (0.0 <= s < e <= durations[vid] + 1e-6 and 0.0 <= c["proposal_score"] <= 1.0
                    and np.isfinite(c["sentence_confidence"])
                    and all(w.startswith("w") for w in c["sentence"].split())):
                fail(f"serve CLI (beam {beam}): malformed caption {c}")
    k1, k2 = counts["attention_scores_masked"], counts["greedy_head"]
    steps = counts["greedy_steps"] if beam == 1 else counts["beam_steps"]
    if not (steps > 0 and k1 == steps and k2 == (steps if beam == 1 else 0)):
        fail(f"serve CLI (beam {beam}): launches {counts}")
    n_caps = sum(len(c) for c in res.values())
    print(f"[27] serve CLI, beam {beam}: {len(res)} videos, {n_caps} captions, {steps} "
          f"{'decode' if beam == 1 else 'beam'} steps, kernel 1 launches {k1}, kernel 2 {k2}; "
          f"{rate.group(4) if rate else 'no rate logged'} captions/s as the CLI logs it "
          f"(chunks of 32 videos, first chunk included), child process {wall:.1f} s [{card}]")
    if beam == 1:
        t0 = time.time()
        logging.disable(logging.INFO)  # the CLI's per-tIoU lines; the means are printed below
        try:
            scores = score_cli.main(["-s", out, "-r", refs_json, "-v"])
        finally:
            logging.disable(logging.NOTSET)
        metrics = ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "Recall", "Precision")
        if not all(np.shape(scores.get(m)) == (4,) and np.isfinite(scores[m]).all()
                   for m in metrics):
            fail(f"serve CLI (beam {beam}): scores {scores}")
        print(f"[27] serve CLI, beam {beam}: cli/score {time.time() - t0:.2f} s: "
              f"{ {m: round(float(np.mean(scores[m])), 4) for m in metrics} } (mean over tIoUs)")
    return {"attention_scores_masked": k1, "greedy_head": k2}


def phase_real_data(card):
    """Phase 27: real data and reference weights.  Returns (kernel 1 and
    2's launches by path, kernel 1's record at the SOTA_TEP windows,
    kernel 2's at the SOTA_TEP decode, kernels 5 and 6's at the SOTA_TEP
    windows)."""
    import shutil

    from echr_tpu_torch.data.export_disk import export_synthetic_corpus
    from echr_tpu_torch.engine import checkpoint, steps
    from echr_tpu_torch.ops.kernel_head import split_plan

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_real_")
    try:
        cfg = eval_cfg()
        t0 = time.time()
        paths = export_synthetic_corpus(cfg, root, log_every=0)
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        print(f"[27] export_disk: {cfg.data.synthetic_num_videos} videos in {time.time() - t0:.1f}"
              f" s, {size / 2**20:.1f} MiB under {root}")
        sota_path = f"{root}/sota_proposals.json"
        proposals = write_sota_json(paths, sota_path)
        validate_corpus(cfg, paths, sota_path)

        launches = {}
        launches["sota_eval"], k1_args, k2_args = sota_eval(card, root, sota_path, proposals)
        nb = k1_args[1].shape[1]
        name = (f"the SOTA_TEP eval's first decode step ({SOTA_PER_VIDEO} external windows a "
                f"video, bucket {nb})")
        k1_rec = kernel1_timing(card, name, k1_args[:5])
        STEP_INPUTS["sota_eval"] = step_inputs(k1_args)
        steps_rec = step_records(card, 27, name, STEP_INPUTS["sota_eval"])
        out, w, b = k2_args
        R, V1 = out.shape[0], b.shape[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = split_plan(R, V1, sms, w.dtype)
        err2, outs = head_check("27", f"the SOTA_TEP eval's first decode step R={R}", k2_args)
        k2_rec = {**head_timing(card, k2_args, outs, plan, tag="27"), "max_abs_err": err2}
        del k1_args, k2_args, outs
        sota_parity(root, sota_path)

        with open(paths["video_data_for_cg"]) as f:
            info = json.load(f)
        vocab = info["ix_to_word"]
        itap, icg, _ = pth_round_trip(card, root, vocab)
        state = steps.init_train_state(cfg, itap, icg)
        ckpt = f"{root}/imported/model-best.ckpt"
        checkpoint.save_checkpoint(ckpt, state, cfg, iteration=0, epoch=0, best_val_score=0.0,
                                   vocab=vocab)
        del state, itap, icg
        torch.cuda.empty_cache()
        val = [v["video_id"] for v in info["videos"] if v["split"] == "val"]
        with open(paths["video_json"]) as f:
            anno = json.load(f)
        feats_dir = f"{root}/val_npy"
        os.makedirs(feats_dir)
        for vid in val:
            os.symlink(os.path.join(paths["input_c3d_dir2"], vid + ".npy"),
                       os.path.join(feats_dir, vid + ".npy"))
        with open(f"{root}/val_durations.json", "w") as f:
            json.dump({v: anno[v]["duration"] for v in val}, f)
        with open(f"{root}/val_anno.json", "w") as f:
            json.dump({v: anno[v] for v in val}, f)
        for name, beam in (("serve_cli_greedy", 1), ("serve_cli_beam", BEAM)):
            launches[name] = serve_cli(card, ckpt, feats_dir, f"{root}/val_durations.json",
                                       f"{root}/val_anno.json", f"{root}/{name}.json", beam)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[27] real data and reference weights: launches {launches}; phase wall "
          f"{time.time() - t_phase:.1f} s [{card}]")
    return launches, k1_rec, k2_rec, steps_rec


PIPE_STEPS, PIPE_PARITY_STEPS = 4, 4  # phase 28: steps a run; steps of the f32 parity runs
PIPE_ROUNDS = 1  # phase 28: rounds of (sync, pipelined, pipelined, sync)
TRACE_FROM, TRACE_STEPS = 3, 3  # phase 28: the traced run's first traced step, traced steps
HEAD_ROWS = (64, 128, 256, 1024)  # phase 29: kernel 2 at per-video decode rows
PV_SCST_STEPS = 3  # phase 29: SCST steps at batch_size 1
PV_CLI_VIDEOS = 16  # phase 29: val videos of the eval CLI in its child process
PV_VIDEOS = 32  # phase 29: val videos of its per-video greedy and beam passes


def _step_clock(train_mod):
    """A wrapper on train_step that records a CUDA event after each step's
    launches: the device's completion times, whatever the host runs ahead.
    Returns (events, wrapper)."""
    events = []
    fn = train_mod.train_step

    def clocked(*args, **kw):
        out = fn(*args, **kw)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return out
    return events, clocked


def pipeline_run(card, cfg, pipelined, steps, tag, trace_dir=None, dev="cuda", phase=28):
    """One train() run of phase 28 on ``cfg`` with runtime.train_pipeline
    ``pipelined``: ms/step and videos/s over steps 2-``steps`` from the
    device's step events, timing_out's sections, the bytes a group sent to
    the device, peak memory, kernels 3 and 4's launches (29 a step).  With
    ``trace_dir`` steps TRACE_FROM .. TRACE_FROM + TRACE_STEPS - 1 run
    inside utils.profiling.device_trace."""
    from echr_tpu_torch.engine import train as train_mod
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd, attention_scores_dense
    from echr_tpu_torch.utils.profiling import device_trace

    cfg = cfg.replace_in("runtime", train_pipeline=pipelined)
    events, clocked = _step_clock(train_mod)
    trace = contextlib.ExitStack()

    def step(*args, **kw):
        if trace_dir and len(events) == TRACE_FROM - 1:
            trace.enter_context(device_trace(trace_dir))
        if trace_dir and len(events) == TRACE_FROM - 1 + TRACE_STEPS:
            trace.close()
        return clocked(*args, **kw)

    for fn in (attention_scores_dense, attention_scores_bwd):
        fn.launches = 0
    timing = {}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, patched(train_mod, "train_step", step):
        t0 = time.time()
        out = train_mod.train(cfg.replace_in("save", checkpoint_path=tmp), max_iterations=steps,
                              device=dev, timing_out=timing)
        torch.cuda.synchronize()
        wall = time.time() - t0
    trace.close()
    launches = {"attention_scores_dense": attention_scores_dense.launches,
                "attention_scores_bwd": attention_scores_bwd.launches}
    want = (SEQ_LEN - 1) * steps
    if out["iteration"] != steps or timing["pipelined"] != pipelined:
        fail(f"{tag}: train stopped at {out['iteration']} (pipelined {timing['pipelined']})")
    if any(n != want for n in launches.values()):
        fail(f"{tag}: kernel 3 and 4 launches {launches}, want {SEQ_LEN - 1} x {steps} = {want}")
    if not all(np.isfinite(v) for v in out["losses"].values()):
        fail(f"{tag}: losses {out['losses']}")
    dt = events[0].elapsed_time(events[-1]) / (steps - 1)
    rec = {"ms_per_step": dt, "videos_per_s": TRAIN_B / dt * 1e3, "wall_s": wall,
           "bytes_per_group": timing["put_bytes"] / timing["put_groups"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
           **{k: timing[k] for k in ("loader", "compress", "collate", "put", "step", "fetch")}}
    print(f"[{phase}] {tag}: {dt:.1f} ms/step, {rec['videos_per_s']:.2f} videos/s over steps 2-"
          f"{steps} (device step events); sections (s) "
          f"{ {k: round(rec[k], 3) for k in ('loader', 'compress', 'collate', 'put', 'step', 'fetch')} }; "
          f"{rec['bytes_per_group'] / 2**20:.2f} MiB to the device a group; peak device memory "
          f"{rec['peak_gib']:.2f} GiB; run wall {wall:.1f} s; launches {launches} [{card}]")
    return out, rec


def phase_pipeline(card, dev="cuda"):
    """Phase 28: the synchronous and the pipelined train loop in turns on
    train_cfg() (B=32, N=64, bf16, dropout on), each with compression once,
    the f32 parity of the two, and one device trace of pipelined steps.
    Returns kernels 3 and 4's launches by path."""
    from echr_tpu_torch.utils.profiling import TRACE_FILE, device_timeline

    cfg = train_cfg()
    runs = {"sync": [], "pipelined": []}
    launches = {"attention_scores_dense": 0, "attention_scores_bwd": 0}
    for name in ("sync", "pipelined", "pipelined", "sync") * PIPE_ROUNDS:
        _, rec = pipeline_run(card, cfg, name == "pipelined", PIPE_STEPS, f"{name} f32 transfer",
                              dev=dev)
        runs[name].append(rec)
        for k, v in rec["launches"].items():
            launches[k] += v
    bf16 = {}
    for name in ("sync", "pipelined"):
        _, bf16[name] = pipeline_run(card, cfg.replace_in("runtime", transfer_dtype="bfloat16"),
                                     name == "pipelined", PIPE_STEPS, f"{name} bf16 transfer",
                                     dev=dev)
        for k, v in bf16[name]["launches"].items():
            launches[k] += v
    ms = {k: [r["ms_per_step"] for r in v] for k, v in runs.items()}
    mean = {k: float(np.mean(v)) for k, v in ms.items()}
    median = {k: float(np.median(v)) for k, v in ms.items()}
    # the pairs of neighbouring runs: (sync, pipelined) and (pipelined, sync) of each round
    wins = sum(p < s_ for s_, p in zip(ms["sync"], ms["pipelined"]))
    print(f"[28] in turns ((sync, pipelined, pipelined, sync) x {PIPE_ROUNDS}): sync "
          f"{[round(x, 1) for x in ms['sync']]} ms/step, pipelined "
          f"{[round(x, 1) for x in ms['pipelined']]}; means {mean['sync']:.1f} / "
          f"{mean['pipelined']:.1f}, medians {median['sync']:.1f} / {median['pipelined']:.1f} "
          f"ms/step; the pipelined run faster in {wins} of {len(ms['sync'])} neighbouring pairs; "
          f"bytes "
          f"to the device a group f32 {runs['sync'][0]['bytes_per_group'] / 2**20:.2f} MiB, "
          f"bf16 transfer {bf16['sync']['bytes_per_group'] / 2**20:.2f} MiB; bf16 transfer "
          f"sync {bf16['sync']['ms_per_step']:.1f}, pipelined "
          f"{bf16['pipelined']['ms_per_step']:.1f} ms/step [{card}]")
    print(f"[28] train_pipeline: the pipelined loop's median ms/step is "
          f"{median['pipelined'] / median['sync']:.3f}x the synchronous loop's on this card")
    with tempfile.TemporaryDirectory() as tmp:
        _, traced = pipeline_run(card, cfg, True, TRACE_FROM + TRACE_STEPS,
                                 f"pipelined, steps {TRACE_FROM}-{TRACE_FROM + TRACE_STEPS - 1} "
                                 f"traced", trace_dir=tmp, dev=dev)
        tl = device_timeline(os.path.join(tmp, TRACE_FILE))
    for k, v in traced["launches"].items():
        launches[k] += v
    if not tl["kernels"]:
        fail("[28] the device trace holds no kernel")
    print(f"[28] device trace of {TRACE_STEPS} pipelined steps: window {tl['window_ms']:.1f} ms, "
          f"device busy {tl['busy_share']:.4f} of it ({tl['kernels']} kernels, "
          f"{tl['kernel_ms']:.1f} ms); H2D copies {tl['h2d_copies']} ({tl['h2d_ms']:.2f} ms), "
          f"{tl['h2d_overlap_share']} of their time under a kernel; longest idle gap "
          f"{tl['longest_idle_ms']:.2f} ms [{card}]")
    pipeline_parity(dev)
    return launches


def pipeline_parity(dev="cuda"):
    """f32, TF32 off, dropout off (steps without a generator): the
    pipelined loop's parameters after PIPE_PARITY_STEPS steps are bit-equal
    to the synchronous loop's."""
    from echr_tpu_torch.engine import steps as steps_mod
    from echr_tpu_torch.engine import train as train_mod

    def no_dropout(state, batch, gen, *a, **k):
        return steps_mod.train_step(state, batch, None, *a, **k)

    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 28's parity needs TF32 off")
    cfg = train_cfg(compute_dtype="float32")
    states = {}
    with tempfile.TemporaryDirectory() as tmp, patched(train_mod, "train_step", no_dropout):
        for name in ("sync", "pipelined"):
            c = cfg.replace_in("runtime", train_pipeline=name == "pipelined")
            out = train_mod.train(c.replace_in("save", checkpoint_path=tmp).replace(run_id=name),
                                  max_iterations=PIPE_PARITY_STEPS, device=dev)
            states[name] = out["state"]
    pairs = [(a, b) for m in ("tap", "cg")
             for a, b in zip(getattr(states["sync"], m).parameters(),
                             getattr(states["pipelined"], m).parameters())]
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    print(f"[28] f32, dropout off, {PIPE_PARITY_STEPS} steps: {len(pairs)} parameter leaves, "
          f"{differ} differ between the pipelined and the synchronous loop")
    if differ:
        fail("the pipelined loop's f32 parameters are not the synchronous loop's")


def pervideo_eval(card, name, args, kw, usable, durations, json_path, kept=None,
                  dev="cuda"):
    """One eval_split pass of phase 29 after a warm-up of 4 videos: kernel 1
    launches once a decode step and 29 times a val-loss call, kernel 2 once
    a greedy decode step.  ``kept`` collects the first kernel-1 call of
    each new row count (per-video bucket) of the pass, with its step's
    feats (kept_attention_calls).  Returns (launches, eval videos/s)."""
    from echr_tpu_torch.engine import evaluate
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head

    tap, cg, loader, cfg = args
    evaluate.eval_split(tap, cg, loader, cfg, json_path, dict(kw, num_vids_eval=4),
                        device=dev)
    torch.cuda.synchronize()
    for fn in (attention_scores_masked, greedy_head):
        fn.launches = 0
    for fn in (decoder_sample_batched, beam_search_batched):
        fn.steps = 0
    val_calls, kept = [], [] if kept is None else kept
    timing = {}
    t0 = time.time()
    with wrapped(evaluate, "val_loss_step", lambda *a: val_calls.append(1)), \
            kept_attention_calls(kept, lambda a: a[1].shape[1] not in
                                 {k[1].shape[1] for k in kept}):
        preds, _, losses = evaluate.eval_split(tap, cg, loader, cfg, json_path,
                                               dict(kw, timing_out=timing), device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    k1, k2 = attention_scores_masked.launches, greedy_head.launches
    beam = kw.get("beam_size", 1) > 1
    steps = beam_search_batched.steps if beam else decoder_sample_batched.steps
    check_predictions(preds, usable, loader.dataset.ix_to_word, durations)
    want_k1 = steps + (SEQ_LEN - 1) * len(val_calls)
    want_k2 = 0 if beam else steps
    if not (steps > 0 and k1 == want_k1 and k2 == want_k2):
        fail(f"[29] {name}: kernel 1 launched {k1} times (want {want_k1}), kernel 2 {k2} "
             f"(want {want_k2}) in {steps} decode steps and {len(val_calls)} val-loss calls")
    if kw.get("get_eval_loss") and not (np.isfinite(losses).all() and (losses[:3] > 0).all()):
        fail(f"[29] {name}: val losses {losses}")
    n_caps = sum(len(c) for c in preds.values())
    print(f"[29] eval_split {name}: {len(preds)} videos, {n_caps} captions, {steps} decode "
          f"steps, {len(val_calls)} val-loss calls, kernel 1 launches {k1}, kernel 2 {k2}; "
          f"{len(preds) / wall:.2f} eval videos/s, {n_caps / wall:.1f} captions/s over "
          f"{wall:.2f} s without scoring; selections on the device "
          f"{timing['device_selections']} [{card}]")
    return {"attention_scores_masked": k1, "greedy_head": k2}, len(preds) / wall


def phase_pervideo(card, dev="cuda"):
    """Phase 29: the per-video paths on phase 18's val split and weights:
    eval_split greedy (val losses on) and beam 4 beside
    eval_split_batched's rate, their f32 parity, the eval CLI's default in
    a child process, SCST at batch_size 1, and kernels 1 and 2 at the
    per-video shapes, kernels 5 and 6 at the greedy decode step's.  Returns
    (launches by path, kernel 1's records, kernel 2's records by rows,
    kernels 5 and 6's records)."""
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.ops.kernel_head import split_plan

    t_phase = time.time()
    cfg, tap, cg, ds, loader = eval_setup()
    usable = usable_val_videos(cfg, ds)
    durations = {ds.get_example(ix).vid: ds.get_example(ix).duration for ix in ds.split_ix["val"]}
    base = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": False}
    per_video = dict(base, num_vids_eval=PV_VIDEOS)
    paths, kept = {}, []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            paths["eval_per_video_greedy"], rate = pervideo_eval(
                card, "greedy", (tap, cg, loader, cfg), dict(per_video, get_eval_loss=True),
                usable[:PV_VIDEOS], durations, f"{tmp}/g.json", kept, dev)
            paths["eval_per_video_beam"], _ = pervideo_eval(
                card, f"beam {BEAM}", (tap, cg, loader, cfg),
                dict(per_video, get_eval_loss=False, beam_size=BEAM), usable[:PV_VIDEOS],
                durations, f"{tmp}/b.json", kept, dev)
            t0 = time.time()
            preds, _, _ = eval_split_batched(tap, cg, loader, cfg, f"{tmp}/B.json",
                                             dict(base, get_eval_loss=True),
                                             batch_videos=EVAL_B, device=dev)
            torch.cuda.synchronize()
            batched_rate = len(preds) / (time.time() - t0)
            print(f"[29] greedy with val losses: eval_split {rate:.2f} eval videos/s, "
                  f"eval_split_batched ({EVAL_B} videos a group) {batched_rate:.2f} [{card}]")
            eval_cli_child(card, tap, cg, cfg, ds, tmp, dev)
    finally:
        loader.load_state(loader.state())
    pervideo_parity(dev)
    paths["scst_per_video"] = pervideo_scst(card, dev)
    k1, steps_rec = {}, None
    for args in kept:
        tag = f"per_video_N{args[1].shape[1]}"
        k1[tag] = kernel1_timing(card, f"a per-video call, N={args[1].shape[1]} rows", args[:5])
        if args[1].shape[1] == TOP_N and steps_rec is None:  # the greedy decode step's
            STEP_INPUTS["per_video"] = step_inputs(args)
            steps_rec = step_records(card, 29, f"a per-video decode step, N={TOP_N} rows",
                                     STEP_INPUTS["per_video"], host=True)
    if steps_rec is None:
        fail(f"[29] no per-video decode step of {TOP_N} rows was kept")
    del kept
    dev = torch.device(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.RandomState(29)
    heads = {}
    for R in HEAD_ROWS:
        args = head_inputs(rng, R, 1536, VOCAB + 1, torch.bfloat16, dev)
        plan = split_plan(R, VOCAB + 1, sms, torch.bfloat16)
        err, outs = head_check("29", f"R={R} ({plan[1]} splits)", args)
        heads[f"R{R}"] = {**head_timing(card, args, outs, plan, tag="29"), "max_abs_err": err}
    slower = [k for k, r in heads.items() if r["ms"] > r["plain_ms"]]
    print(f"[29] kernel 2 against the plain bf16 head at per-video rows: "
          f"{ {k: (round(r['ms'], 4), round(r['plain_ms'], 4)) for k, r in heads.items()} } "
          f"ms; the kernel loses at {slower or 'no R'} [{card}]")
    print(f"[29] phase wall {time.time() - t_phase:.1f} s [{card}]")
    return paths, k1, heads, steps_rec


def eval_cli_child(card, tap, cg, cfg, ds, tmp, dev="cuda"):
    """python -m echr_tpu_torch.cli.eval with no --batch_videos, on a
    checkpoint of phase 18's weights, over PV_CLI_VIDEOS val videos in a
    child process: exit code 0, the per-video eval_split ran, and its
    predictions file."""
    from echr_tpu_torch.engine import checkpoint, steps

    state = steps.init_train_state(cfg, tap, cg)
    checkpoint.save_checkpoint(os.path.join(tmp, "PV", "model-best.ckpt"), state, cfg,
                               iteration=0, epoch=0, best_val_score=0.0, vocab=ds.ix_to_word)
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "echr_tpu_torch.cli.eval", "--folder_id", "PV",
                          "--checkpoint_path", tmp, "--flag_eval_what", "tap_cg", "--topN",
                          str(TOP_N), "--num_vids_eval", str(PV_CLI_VIDEOS),
                          "--no_language_eval", "--device", dev],
                         capture_output=True, text=True, timeout=600)
    log_text = res.stdout + res.stderr
    ran = re.search(r"eval wall ([\d.]+)s \(([\d.]+) videos/s, eval_split\)", log_text)
    if res.returncode != 0 or not ran:
        fail(f"[29] cli.eval without --batch_videos: exit {res.returncode}\n{log_text[-3000:]}")
    print(f"[29] cli.eval without --batch_videos: exit 0, eval_split ran, {ran.group(2)} "
          f"videos/s over {ran.group(1)} s as it logs them; child wall {time.time() - t0:.1f} s "
          f"[{card}]")


def pervideo_parity(dev="cuda"):
    """f32, TF32 off, phase 5's sharpened logit weights, the window sort
    off: eval_split against eval_split_batched (tap_cg, val losses on):
    the same videos and proposals, proposal scores within TOL, sentences
    equal but
    where the first differing token is a near-tie of the per-video decode
    (top-2 gap below TIE_GAP), confidences of equal sentences within TOL a
    token, val losses within 1e-5 relative."""
    from echr_tpu_torch.engine import evaluate
    from echr_tpu_torch.models import decoder

    cfg, tap, cg, ds, loader = eval_setup(compute_dtype="float32", sort_decode_props=False)
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": False, "get_eval_loss": True}
    gaps, on_decode, on_head = gap_recorder()
    order = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with wrapped(evaluate, "decode_step", on_decode), \
                    wrapped(decoder, "greedy_head", on_head), \
                    wrapped(evaluate, "_prop_bucket", lambda n: order.append(n)):
                want, _, want_loss = evaluate.eval_split(tap, cg, loader, cfg, f"{tmp}/v.json",
                                                         dict(kw), device=dev)
            got, _, got_loss = evaluate.eval_split_batched(tap, cg, loader, cfg,
                                                           f"{tmp}/b.json", dict(kw),
                                                           batch_videos=EVAL_B, device=dev)
    finally:
        loader.load_state(loader.state())
    if sorted(got) != sorted(want) or not want or len(gaps) != len(want):
        fail(f"[29] parity: {len(got)} and {len(want)} videos captioned, {len(gaps)} decodes")
    differ, firsts, worst, score_err, n = 0, [], 0.0, 0.0, 0
    for u, vid in enumerate(want):  # the per-video pass inserts in decode order
        g_steps = torch.stack(gaps[u]).cpu().numpy()  # [steps, nb]
        if len(got[vid]) != len(want[vid]):
            fail(f"[29] parity: {vid} has {len(got[vid])} predictions against {len(want[vid])}")
        for j, (g, w) in enumerate(zip(got[vid], want[vid])):
            n += 1
            # the encode runs at B=1 here and at B=EVAL_B there: its products
            # may round otherwise, so the proposal scores agree within TOL
            score_err = max(score_err, abs(g["proposal_score"] - w["proposal_score"]))
            if g["timestamp"] != w["timestamp"] or not score_err <= TOL:
                fail(f"[29] parity: {vid} proposal {j} differs in timestamp or proposal score")
            if g["sentence"] == w["sentence"]:
                err = abs(g["sentence_confidence"] - w["sentence_confidence"])
                worst = max(worst, err / (len(w["sentence"].split()) + 1))
                continue
            tg, tw = g["sentence"].split() + [""], w["sentence"].split() + [""]
            step = next(i for i, (a, b) in enumerate(zip(tg, tw)) if a != b)
            differ += 1
            firsts.append(float(g_steps[min(step, len(g_steps) - 1), j]))
    rel = float((np.abs(got_loss[:3] - want_loss[:3]) / np.abs(want_loss[:3])).max())
    print(f"[29] f32 eval_split against eval_split_batched: {len(want)} videos, {n} captions "
          f"(per-video buckets {sorted(set(order))}), {differ} sentences differ (top-2 gaps at "
          f"their first difference {[round(x, 7) for x in firsts]}); max|d| confidence "
          f"{worst:.3e} a token, proposal score {score_err:.3e}; val losses "
          f"{np.round(want_loss[:3], 6).tolist()} (rel {rel:.2e})")
    if any(x >= TIE_GAP for x in firsts) or not worst <= TOL or not rel <= 1e-5:
        fail("[29] eval_split and eval_split_batched disagree beyond the near-ties")


def pervideo_scst(card, dev="cuda"):
    """PV_SCST_STEPS SCST steps of train() at batch_size 1 (the per-video
    _self_critical_step) on scst_cfg() at f32 with TF32 off (phase 24's
    gate: a bf16 replay rounds otherwise): the replay's tokens and active
    equal the rollout's and its logps equal theirs within 1e-5 up to each
    row's end token (the same dropout masks), finite losses, and kernels
    1-4 launched as phase 23 counts them.  Returns their launches."""
    from echr_tpu_torch.engine import rl
    from echr_tpu_torch.engine import steps as steps_mod
    from echr_tpu_torch.engine.train import train
    from echr_tpu_torch.ops.kernel_attention import (attention_scores_bwd,
                                                     attention_scores_dense,
                                                     attention_scores_masked)
    from echr_tpu_torch.ops.kernel_head import greedy_head

    kernels = (attention_scores_masked, greedy_head, attention_scores_dense,
               attention_scores_bwd)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 29's SCST needs TF32 off")
    cfg = scst_cfg(compute_dtype="float32").replace_in("train", batch_size=1)
    fn = steps_mod.decoder_sample_batched  # the rollout's and the replay's decode
    sampled, replays = [], []

    def keep(dec, cfg_, ctxs, dtype=torch.float32, greedy=True, temperature=1.0,
             sample_gen=None, train=False, gen=None, forced=None):
        out = fn(dec, cfg_, ctxs, dtype, greedy, temperature, sample_gen, train, gen, forced)
        if forced is not None:
            replays.append(tuple(x.detach() for x in out))
        elif not greedy:
            sampled.append(out)
        return out
    timing = {}
    for k in kernels:
        k.launches = 0
    try:
        with tempfile.TemporaryDirectory() as tmp, patched(steps_mod, "decoder_sample_batched",
                                                           keep):
            out = train(cfg.replace_in("save", checkpoint_path=tmp),
                        max_iterations=PV_SCST_STEPS, device=dev, timing_out=timing)
            torch.cuda.synchronize()
    finally:
        rl.close_default_reward_pool()
    launches = {k.__name__: k.launches for k in kernels}
    sc = timing["scst"]
    if not (out["iteration"] == len(sc) == len(sampled) == len(replays) == PV_SCST_STEPS):
        fail(f"[29] SCST at batch_size 1: {out['iteration']} steps, {len(sampled)} rollouts, "
             f"{len(replays)} replays")
    worst = 0.0
    for (s_seq, s_lp, s_act), (r_seq, r_lp, r_act) in zip(sampled, replays):
        emitted = s_seq > 0
        upto_end = torch.cat([torch.ones_like(emitted[..., :1]), emitted[..., :-1]], dim=-1)
        if not (torch.equal(s_seq, r_seq) and torch.equal(s_act, r_act)):
            fail("[29] SCST at batch_size 1: the replay's tokens are not the rollout's")
        worst = max(worst, float(((s_lp - r_lp).abs() * upto_end).max()))
    if not worst <= 1e-5 or not all(np.isfinite(v) for v in out["losses"].values()):
        fail(f"[29] SCST at batch_size 1: replay logps max|d| {worst:.3e}, losses "
             f"{out['losses']}")
    n_samp = sum(s["sample_steps"] for s in sc)
    n_greedy = sum(s["greedy_steps"] for s in sc)
    want = {"attention_scores_masked": n_greedy, "greedy_head": n_greedy,
            "attention_scores_dense": n_samp + SEQ_LEN * PV_SCST_STEPS,
            "attention_scores_bwd": SEQ_LEN * PV_SCST_STEPS}
    if launches != want:
        fail(f"[29] SCST at batch_size 1: launches {launches}, want {want}")
    part = {k: 1000 * np.mean([s[k] for s in sc[1:]]) for k in ("rollout", "reward", "update")}
    print(f"[29] SCST at batch_size 1 (the per-video step, N={cfg.tap.prop_sample_num}, f32, "
          f"TF32 off, dropout on): {out['iteration']} steps; the replay's logps equal the rollout's "
          f"within {worst:.2e} up to each end token; launches {launches}; after the first step "
          f"rollouts {part['rollout']:.1f} ms, reward {part['reward']:.1f} ms, update "
          f"{part['update']:.1f} ms a step [{card}]")
    return launches


DP_STEPS = 4  # phase 30: steps a run, the gate at the last
DP_RUNS = (False, True)  # phase 30: runs in turns, in a one-rank NCCL group or not
DP_TWO_B, DP_TWO_STEPS = 8, 2  # phase 30: two gloo ranks on the one card
DP_TIMEOUT_S = 300  # phase 30: a collective's and a child's longest wait
DP_CHILD = """
import sys
sys.path.insert(0, {repo!r})
import chip_smoke
chip_smoke.dp_gloo_rank({rank}, {port}, {tmp!r}, {dev!r})
"""


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _no_dropout(state, batch, gen, *a, **k):
    from echr_tpu_torch.engine import steps as steps_mod

    return steps_mod.train_step(state, batch, None, *a, **k)


def dp_cfg(folder, run_id):
    """Phase 30's run: ckpt_train_cfg (train_cfg()'s width, B=32, N=64,
    tap_cg) at f32, its one gate at step DP_STEPS over EVAL_B val videos,
    the cg pass (fast_eval_cg)."""
    cfg = ckpt_train_cfg(folder, compute_dtype="float32").replace(run_id=run_id)
    return cfg.replace_in("save", save_checkpoint_every=DP_STEPS).replace_in(
        "eval", fast_eval_cg=True)


def dp_run(grouped, tag, dev="cuda"):
    """One phase-30 run of train() for DP_STEPS steps, dropout off, in a
    one-rank group (NCCL on CUDA, gloo on the CPU) when ``grouped``, which
    is destroyed before this returns.  Returns (train's output, a record:
    ms/step over steps 2-DP_STEPS from device step events, the all-reduces'
    device ms and bytes, kernels 1-4's launches, the decode steps, the gate's
    predictions JSON)."""
    from echr_tpu_torch.engine import train as train_mod
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops.kernel_attention import (attention_scores_bwd,
                                                     attention_scores_dense,
                                                     attention_scores_masked)
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.parallel import distributed as pdist
    from echr_tpu_torch.parallel import mesh

    kernels = (attention_scores_masked, greedy_head, attention_scores_dense,
               attention_scores_bwd)
    reduce_fn, reduces = mesh.all_reduce_grads, []

    def timed_reduce(tensors, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = reduce_fn(tensors, **kw)
        b.record()
        reduces.append((a, b, nbytes(*tensors)))
        return out

    with patched(train_mod, "train_step", _no_dropout):
        events, clocked = _step_clock(train_mod)
    for fn in kernels:
        fn.launches = 0
    decoder_sample_batched.steps = 0
    with tempfile.TemporaryDirectory() as tmp:
        if grouped:
            pdist.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=dev,
                             timeout_s=DP_TIMEOUT_S)
        try:
            with patched(train_mod, "train_step", clocked), \
                    patched(mesh, "all_reduce_grads", timed_reduce):
                out = train_mod.train(dp_cfg(tmp, tag), max_iterations=DP_STEPS, device=dev)
            torch.cuda.synchronize()
        finally:
            if grouped:
                pdist.destroy()
        folder = os.path.join(out["save_folder"], "pred_sent")
        preds = {}
        for name in sorted(os.listdir(folder)):
            with open(os.path.join(folder, name)) as f:
                preds[name] = json.load(f)
    rec = {"ms_per_step": events[0].elapsed_time(events[-1]) / (DP_STEPS - 1),
           "reduce_ms": [a.elapsed_time(b) for a, b, _ in reduces],
           "reduce_bytes": [n for _, _, n in reduces],
           "launches": {fn.__name__: fn.launches for fn in kernels},
           "decode_steps": decoder_sample_batched.steps, "preds": preds}
    if grouped != bool(reduces):
        fail(f"[30] {tag}: {len(reduces)} all-reduces in a run {'with' if grouped else 'without'}"
             " a group")
    return out, rec


def _xe_capture(caught):
    """A train_step without dropout that keeps each step's gradients (after
    the ranks' all-reduce) and metrics in ``caught``."""
    from echr_tpu_torch.engine import steps as steps_mod

    def step(state, batch, gen, cfg, phase, ss_prob=0.0):
        grads, m = steps_mod.grad_step(state, batch, None, cfg, phase, ss_prob)
        caught.append(([g.detach().clone() for g in grads[0] + grads[1]],
                       steps_mod.fetch_metrics(m)[0]))
        return steps_mod.apply_grads(state, grads[0], grads[1], cfg, phase), m
    return step


def dp_two_cfg(folder, run_id):
    """train_cfg() at f32 and B=DP_TWO_B: two ranks take 4 videos each."""
    return train_cfg(compute_dtype="float32").replace(run_id=run_id).replace_in(
        "train", batch_size=DP_TWO_B).replace_in("save", checkpoint_path=folder)


def dp_gloo_rank(rank, port, tmp, dev="cuda"):
    """A child of phase 30: rank ``rank`` of two gloo ranks, both on the one
    card (NCCL refuses two ranks on one device).  First whether gloo's
    all_reduce takes CUDA tensors; if it does, DP_TWO_STEPS XE steps of
    train() at B=DP_TWO_B (f32, dropout off), each rank's step-1 gradients
    and loss held to the one-process run that the parent saved in ``tmp``,
    and a digest of the parameters.  Writes <tmp>/rank<r>.json."""
    import hashlib

    from echr_tpu_torch.engine import train as train_mod
    from echr_tpu_torch.ops import native
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd, attention_scores_dense
    from echr_tpu_torch.parallel import distributed as pdist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev != "cpu":
        native.library()
    os.environ["LOCAL_RANK"] = "0"
    rec = {"rank": rank}
    pdist.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo", device=dev,
                     timeout_s=DP_TIMEOUT_S)
    try:
        t = torch.full((4,), float(rank + 1), device=dev)
        try:
            torch.distributed.all_reduce(t)
            rec["gloo_cuda"] = t.tolist() == [3.0] * 4
        except RuntimeError as e:
            rec["gloo_cuda"], rec["refused"] = False, str(e)[:300]
        if rec["gloo_cuda"]:
            caught = []
            for fn in (attention_scores_dense, attention_scores_bwd):
                fn.launches = 0
            t0 = time.time()
            with patched(train_mod, "train_step", _xe_capture(caught)):
                out = train_mod.train(dp_two_cfg(os.path.join(tmp, f"r{rank}"), "two"),
                                      max_iterations=DP_TWO_STEPS, device=dev)
            torch.cuda.synchronize()
            rec["wall_s"] = time.time() - t0
            want = torch.load(os.path.join(tmp, "one.pt"))
            grads, m = caught[0]
            bad = [i for i, (g, w) in enumerate(zip(grads, want["grads"]))
                   if not torch.allclose(g.cpu(), w, atol=2e-4, rtol=1e-3)]
            rec.update(
                iteration=out["iteration"], loss=m["loss"], want_loss=want["loss"],
                grad_leaves=len(grads), grads_outside_gate=bad,
                grad_max_abs_err=max(float((g.cpu() - w).abs().max())
                                     for g, w in zip(grads, want["grads"])),
                launches={fn.__name__: fn.launches for fn in (attention_scores_dense,
                                                              attention_scores_bwd)},
                digest=hashlib.sha256(b"".join(
                    p.detach().cpu().numpy().tobytes() for m_ in (out["state"].tap,
                                                                  out["state"].cg)
                    for p in m_.parameters())).hexdigest())
    finally:
        pdist.destroy()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)


def dp_two_ranks(card, dev="cuda"):
    """Phase 30's two gloo ranks on the one card against one process: the
    one-process run first (its step-1 gradients saved for the ranks), then
    the ranks in two child processes.  Returns kernels 3-4's launches in
    the ranks' run, summed over the ranks; fails where gloo refuses CUDA
    tensors."""
    from echr_tpu_torch.engine import train as train_mod

    with tempfile.TemporaryDirectory() as tmp:
        caught = []
        with patched(train_mod, "train_step", _xe_capture(caught)):
            one = train_mod.train(dp_two_cfg(os.path.join(tmp, "one"), "one"),
                                  max_iterations=DP_TWO_STEPS, device=dev)
        torch.cuda.synchronize()
        torch.save({"grads": [g.cpu() for g in caught[0][0]], "loss": caught[0][1]["loss"]},
                   os.path.join(tmp, "one.pt"))
        del one, caught
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", DP_CHILD.format(repo=os.path.dirname(os.path.abspath(
                __file__)), rank=r, port=port, tmp=tmp, dev=dev)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
        finally:
            for p in procs:
                p.kill()
        if any(p.returncode for p in procs):
            fail(f"[30] two gloo ranks: exit codes {[p.returncode for p in procs]}; rank 0 "
                 f"said {logs[0][-3000:]}\nrank 1 said {logs[-1][-3000:]}")
        recs = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    if not all(r["gloo_cuda"] for r in recs):
        fail(f"[30] two gloo ranks on the one card: gloo's all_reduce refused CUDA tensors "
             f"({recs[0].get('refused')})")
    a, b = recs
    want = {k: (SEQ_LEN - 1) * DP_TWO_STEPS for k in a["launches"]}
    ok = (a["iteration"] == b["iteration"] == DP_TWO_STEPS and a["digest"] == b["digest"]
          and a["launches"] == b["launches"] == want
          and not a["grads_outside_gate"] and not b["grads_outside_gate"]
          and abs(a["loss"] - a["want_loss"]) <= 1e-5 * abs(a["want_loss"]))
    print(f"[30] two gloo ranks on the one card, {DP_TWO_B // 2} videos each, f32, dropout off, "
          f"{DP_TWO_STEPS} XE steps: step 1's loss {a['loss']:.6f} against one process's "
          f"{a['want_loss']:.6f}; gradient leaves outside atol 2e-4, rtol 1e-3: "
          f"{len(a['grads_outside_gate'])} of {a['grad_leaves']} (max|d| "
          f"{a['grad_max_abs_err']:.3e}); parameters bit-equal between the ranks: "
          f"{a['digest'] == b['digest']}; kernels 3-4 launches by rank {a['launches']}, "
          f"{b['launches']}; the ranks' train() wall {a['wall_s']:.1f}, {b['wall_s']:.1f} s "
          f"(two processes time-slicing one card: no scaling number) [{card}]")
    if not ok:
        fail(f"[30] two gloo ranks against one process: {recs}")
    return {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}


def phase_data_parallel(card, dev="cuda"):
    """Phase 30: engine.train.train at train_cfg()'s width (B=32, N=64,
    tap_cg), f32, TF32 off, dropout off, DP_STEPS steps with the gate at the
    last over EVAL_B val videos, in turns without a group and inside a
    one-rank NCCL group (DP_RUNS): parameters bit-equal, best scores and
    predictions JSON equal; ms/step of both, the all-reduce's own device ms
    and bytes a step, kernels 1-4's launches in the grouped runs; then two
    gloo ranks on the one card (dp_two_ranks).  Returns the launches by
    path."""
    t_phase = time.time()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 30 needs TF32 off")
    runs, first = [], None
    launches = {"attention_scores_masked": 0, "greedy_head": 0, "attention_scores_dense": 0,
                "attention_scores_bwd": 0}
    for i, grouped in enumerate(DP_RUNS):
        out, rec = dp_run(grouped, f"dp{i}", dev)
        params = [p.detach() for m in (out["state"].tap, out["state"].cg) for p in m.parameters()]
        if first is None:
            first = (params, out, rec)
        else:
            differ = sum(not torch.equal(a, b) for a, b in zip(first[0], params))
            if (differ or out["best_val_score"] != first[1]["best_val_score"]
                    or rec["preds"] != first[2]["preds"] or out["iteration"] != DP_STEPS):
                fail(f"[30] run {i} ({'one-rank group' if grouped else 'no group'}): {differ} of "
                     f"{len(params)} parameter leaves differ from run 0, best "
                     f"{out['best_val_score']} against {first[1]['best_val_score']}, predictions "
                     f"JSON equal: {rec['preds'] == first[2]['preds']}")
        if grouped:
            tf = SEQ_LEN - 1
            want = {"attention_scores_dense": tf * (DP_STEPS + 1),
                    "attention_scores_bwd": tf * (DP_STEPS + 1),
                    "attention_scores_masked": rec["decode_steps"] + tf,
                    "greedy_head": rec["decode_steps"]}
            if not (rec["decode_steps"] > 0 and rec["launches"] == want):
                fail(f"[30] one-rank group: launches {rec['launches']}, want {want}")
            for k, v in rec["launches"].items():
                launches[k] += v
        runs.append((grouped, rec))
        del out, params
    ms = {g: [r["ms_per_step"] for gg, r in runs if gg == g] for g in (False, True)}
    red = [r for g, r in runs if g]
    # a run's first all-reduce also makes the NCCL communicator
    per_step = [ms_ for r in red for ms_ in r["reduce_ms"][1:DP_STEPS]]
    order = ", ".join("one-rank group" if g else "no group" for g in DP_RUNS)
    print(f"[30] train() at B={TRAIN_B}, N={TRAIN_N}, tap_cg, f32, TF32 off, dropout off, "
          f"{DP_STEPS} steps and a gate at {DP_STEPS} over {EVAL_B} val videos, in turns "
          f"({order}): "
          f"{[round(r['ms_per_step'], 1) for _, r in runs]} ms/step over steps 2-{DP_STEPS}; "
          f"means without a group {np.mean(ms[False]):.1f}, in the group "
          f"{np.mean(ms[True]):.1f} [{card}]")
    print(f"[30] the all-reduce (flatten, NCCL all_reduce, divide, views) a step: "
          f"{red[0]['reduce_bytes'][0] / 2**20:.1f} MiB, {np.mean(per_step):.3f} ms (min "
          f"{min(per_step):.3f}, max {max(per_step):.3f}) from CUDA events over "
          f"{len(per_step)} steps 2-{DP_STEPS}; step 1's (with the communicator's set-up) "
          f"{[round(r['reduce_ms'][0], 3) for r in red]} ms, the histogram step's "
          f"{[round(r['reduce_ms'][-1], 3) for r in red]} ms [{card}]")
    print(f"[30] parameters bit-equal, best score {first[1]['best_val_score']:.4f} and the "
          f"predictions JSON ({', '.join(first[2]['preds'])}) equal over the {len(runs)} runs; "
          f"kernels 1-4 in the grouped runs: {launches}")
    paths = {"data_parallel": launches, "data_parallel_two_ranks": dp_two_ranks(card, dev)}
    print(f"[30] phase wall {time.time() - t_phase:.1f} s [{card}]")
    return paths


TP_B, TP_STEPS, TP_EVAL = 8, 2, 16  # phase 31: videos, XE steps (the gate at the last), val videos
TP_VOCAB = 6001  # phase 31: V+1 = 6002 splits 3001 + 3001 over tp = 2
RING_T = (256, 4096)  # phase 31: the ring's frames, the bucket and a long video
TP_CHILD = """
import sys
sys.path.insert(0, {repo!r})
import chip_smoke
chip_smoke.tp_gloo_rank({rank}, {port}, {tmp!r}, {dev!r})
"""


def tp_cfg(folder, run_id, mesh_shape=(1, 1)):
    """Phase 31's run: train_cfg()'s width at f32 with synthetic_vocab_size
    TP_VOCAB and B=TP_B, the gate at step TP_STEPS over TP_EVAL val videos
    (the cg pass), under ``mesh_shape``."""
    cfg = train_cfg(compute_dtype="float32", mesh_shape=mesh_shape).replace(run_id=run_id)
    cfg = cfg.replace_in("data", synthetic_vocab_size=TP_VOCAB).replace_in("train",
                                                                           batch_size=TP_B)
    cfg = cfg.replace_in("save", checkpoint_path=folder, save_checkpoint_every=TP_STEPS,
                         min_epoch_when_save=0)
    return cfg.replace_in("eval", num_vids_eval=TP_EVAL, batch_videos=TP_EVAL // 2,
                          fast_eval_cg=True)


def _tp_capture(caught):
    """A train_step without dropout that keeps each step's gradients (the
    cut leaves gathered over the tp group), its metrics and kernels 3-4's
    launches so far in ``caught``."""
    from echr_tpu_torch.engine import steps as steps_mod
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd, attention_scores_dense
    from echr_tpu_torch.parallel import mesh

    def step(state, batch, gen, cfg, phase, ss_prob=0.0):
        (tap_g, cg_g), m = steps_mod.grad_step(state, batch, None, cfg, phase, ss_prob)
        whole = tap_g + mesh.gather_grads(state.cg, cg_g)
        caught.append(([g.detach().clone() for g in whole], steps_mod.fetch_metrics(m)[0],
                       {fn.__name__: fn.launches for fn in (attention_scores_dense,
                                                            attention_scores_bwd)}))
        return steps_mod.apply_grads(state, tap_g, cg_g, cfg, phase), m
    return step


def _params_digest(tensors):
    import hashlib

    return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes() for t in tensors)
                          ).hexdigest()


def tp_train_rank(rank, tmp, dev="cuda"):
    """Phase 31(a) in a rank: TP_STEPS XE steps of train() under (1, 2) with
    the gate at the last, step 1's loss and gathered gradients held to the
    one-process run the parent saved in ``tmp``; the digest of the rank's
    replicated parameters; rank 0 saves the gathered parameters.  Returns
    (record, train's output, the gathered state)."""
    from echr_tpu_torch.engine import train as train_mod
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd, attention_scores_dense
    from echr_tpu_torch.parallel import mesh

    caught = []
    for fn in (attention_scores_dense, attention_scores_bwd):
        fn.launches = 0
    t0 = time.time()
    with patched(train_mod, "train_step", _tp_capture(caught)):
        out = train_mod.train(tp_cfg(os.path.join(tmp, "tp"), "tp", (1, 2)),
                              max_iterations=TP_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    want = torch.load(os.path.join(tmp, "one.pt"))
    grads, m, in_steps = caught[0][0], caught[0][1], caught[-1][2]
    bad = [i for i, (g, w) in enumerate(zip(grads, want["grads"]))
           if not torch.allclose(g.cpu(), w, atol=2e-4, rtol=1e-3)]
    state = out["state"]
    cut = {n: list(p.shape) for n, p, _ in mesh.sharded_leaves(state.cg)}
    replicated = [p for n, p in state.cg.named_parameters() if n not in cut]
    whole = mesh.gather_modules(state)
    params = [p.detach() for mod in (whole.tap, whole.cg) for p in mod.parameters()]
    if rank == 0:
        torch.save([p.cpu() for p in params], os.path.join(tmp, "tp_whole.pt"))
    rec = {"iteration": out["iteration"], "loss": m["loss"], "want_loss": want["loss"],
           "grad_leaves": len(grads), "grads_outside_gate": bad,
           "grad_max_abs_err": max(float((g.cpu() - w).abs().max())
                                   for g, w in zip(grads, want["grads"])),
           "cut": cut, "replicated_digest": _params_digest([*state.tap.parameters(),
                                                            *replicated]),
           "whole_digest": _params_digest(params), "best_val_score": out["best_val_score"],
           "launches_in_steps": in_steps,
           "launches": {fn.__name__: fn.launches for fn in (attention_scores_dense,
                                                            attention_scores_bwd)},
           "wall_s": wall}
    return rec, out, whole


def tp_baseline_rank(rank, out, whole, dev="cuda"):
    """Phase 31(b) in a rank: the rollouts of one SCST step at (1, 2) on
    TP_B videos against the gathered model's in this process (the same
    generators, dropout off): equal sampled and greedy tokens; kernel 2's
    launches in the baseline; the baseline's first kernel-2 call on the
    rank's vocab block held against its plain version, combined with the
    other rank's (parallel.tensor.combine_heads) against kernel 2 on the
    whole vocab, and timed beside it in f32 and bf16."""
    from echr_tpu_torch.data.batcher import make_batch
    from echr_tpu_torch.data.dataset import SyntheticDataset
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine.train import _collate, _executed_steps
    from echr_tpu_torch.models import decoder
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_head import greedy_head, pad_head_width, prepare_head
    from echr_tpu_torch.parallel.tensor import combine_heads, shard_of

    cfg = out["config"]
    ds = SyntheticDataset(cfg, num_videos=2 * TP_B, seed=31)
    batch = steps.batch_to_device(_collate([
        make_batch(ds.get_example(i), cfg, np.random.RandomState(i), w1=ds.w1)[0]
        for i in range(TP_B)]), dev)
    kept = []

    def keep(*a):
        if not kept:
            kept.append(tuple(x.detach().clone() for x in a))
    greedy_head.launches = 0
    decoder_sample_batched.steps = 0
    with wrapped(decoder, "greedy_head", keep):
        _, gen_seq, greedy_seq = steps.rl_rollout_step_batched(
            out["state"], batch, cfg, "tap_cg", None, torch.Generator(dev).manual_seed(5))
    torch.cuda.synchronize()
    k2 = greedy_head.launches
    greedy_steps = _executed_steps(greedy_seq.cpu().numpy())
    _, one_gen, one_greedy = steps.rl_rollout_step_batched(
        whole, batch, cfg, "tap_cg", None, torch.Generator(dev).manual_seed(5))
    torch.cuda.synchronize()
    out_rows, w, b = kept[0]
    tp = shard_of(out["state"].cg.decoder)
    err, (tok, mx, lse) = head_check("31", f"rank {rank}'s vocab block (R={out_rows.shape[0]}, "
                                     f"V1={w.shape[0]}, f32)", (out_rows, w, b))
    ctok, cmx, clse = combine_heads(tok, mx, lse, tp, w.shape[0])
    fw, fb = prepare_head(whole.cg.decoder.logit, torch.float32)
    ftok, fmx, flse = greedy_head(out_rows, fw, fb)
    rec = {"rows": out_rows.shape[0], "cols": out_rows.shape[1], "block_V1": w.shape[0],
           "whole_V1": fw.shape[0],
           "kernel2_launches": k2, "greedy_steps": greedy_steps,
           "rollout_tokens_equal": bool(torch.equal(gen_seq, one_gen)),
           "baseline_tokens_equal": bool(torch.equal(greedy_seq, one_greedy)),
           "block_max_abs_err": err,
           "combined_token_mismatches": int((ctok != ftok).sum()),
           "combined_max_err": float((cmx - fmx).abs().max()),
           "combined_lse_err": float((clse - flse).abs().max())}
    wb16 = pad_head_width(w.to(torch.bfloat16)).contiguous()
    fwb16, _ = prepare_head(whole.cg.decoder.logit, torch.bfloat16)
    a16 = out_rows.to(torch.bfloat16)
    err16, outs16 = head_check("31", f"rank {rank}'s vocab block, bf16", (a16, wb16, b))
    R, C = out_rows.shape
    for key, fn, args in (("block_f32", greedy_head, (out_rows, w, b)),
                          ("whole_f32", greedy_head, (out_rows, fw, fb)),
                          ("block_bf16", greedy_head, (a16, wb16, b)),
                          ("whole_bf16", greedy_head, (a16, fwb16, fb))):
        rec[f"{key}_ms"] = cuda_ms(lambda: fn(*args))
    with force_plain():
        rec["block_bf16_plain_ms"] = cuda_ms(lambda: greedy_head(a16, wb16, b), iters=10)
    rec["block_bf16_max_abs_err"] = err16
    rec.update({f"block_bf16_{k}": v for k, v in bound(
        nbytes(a16, wb16, b, *outs16), bf16=2.0 * R * C * wb16.shape[0]).items()})
    return rec


def ring_rank(rank, dev="cuda"):
    """Phase 31(c) in a rank: the SST at train_cfg()'s width (seeded init)
    over RING_T frames: one process's sst_forward_batched on the whole video
    (each rank in turn, the other waiting), then the ring over the pair on
    the rank's half; the chunk against the one-process result, the wall
    times and the peak memory of each."""
    from echr_tpu_torch.models.registry import init_tap
    from echr_tpu_torch.models.sst import sst_forward_batched
    from echr_tpu_torch.parallel import distributed as pdist
    from echr_tpu_torch.parallel.sequence import local_frames, sequence_sharded_sst

    cfg = train_cfg(compute_dtype="float32")
    sst = init_tap(torch.Generator().manual_seed(31), cfg, dev)
    recs = {}
    for T in RING_T:
        feats = torch.from_numpy(np.random.RandomState(T).randn(T, cfg.tap.video_dim).astype(
            np.float32)).to(dev)
        for turn in (0, 1):
            pdist.allgather_object(("one process", T, turn))
            if turn == rank:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                with torch.inference_mode():
                    h, s = sst_forward_batched(sst, feats[None])
                torch.cuda.synchronize()
                one_s, one_peak = time.time() - t0, torch.cuda.max_memory_allocated()
        pdist.allgather_object(("ring", T))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with torch.inference_mode():
            rh, rs = sequence_sharded_sst(sst, local_frames(feats))
        torch.cuda.synchronize()
        pdist.allgather_object(("ring done", T))
        ring_s, ring_peak = time.time() - t0, torch.cuda.max_memory_allocated()
        lo = rank * (T // 2)
        err = max(float((rh - h[0, lo:lo + T // 2]).abs().max()),
                  float((rs - s[0, lo:lo + T // 2]).abs().max()))
        recs[f"T{T}"] = {"max_abs_err": err, "one_process_s": one_s, "ring_s": ring_s,
                         "one_process_peak_bytes": one_peak, "ring_peak_bytes": ring_peak}
        del h, s, rh, rs, feats
    return recs


def tp_gloo_rank(rank, port, tmp, dev="cuda"):
    """A child of phase 31: rank ``rank`` of two gloo ranks on the one card
    (NCCL refuses two ranks on one device): tensor-parallel training
    (tp_train_rank), the SCST rollouts and kernel 2 on the rank's vocab
    block (tp_baseline_rank) and the SST ring (ring_rank).  Writes
    <tmp>/tp_rank<r>.json."""
    from echr_tpu_torch.ops import native
    from echr_tpu_torch.parallel import distributed as pdist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev != "cpu":
        native.library()
    os.environ["LOCAL_RANK"] = "0"
    rec = {"rank": rank}
    pdist.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo", device=dev,
                     timeout_s=DP_TIMEOUT_S)
    try:
        rec["train"], out, whole = tp_train_rank(rank, tmp, dev)
        rec["baseline"] = tp_baseline_rank(rank, out, whole, dev)
        del out, whole
        rec["ring"] = ring_rank(rank, dev)
    finally:
        pdist.destroy()
        with open(os.path.join(tmp, f"tp_rank{rank}.json"), "w") as f:
            json.dump(rec, f)


def phase_tensor_parallel(card, dev="cuda"):
    """Phase 31: tensor and sequence parallelism on two gloo ranks on the one
    card.  The one-process run of tp_cfg() first (its step-1 gradients
    saved for the ranks), then the ranks in two child processes
    (tp_gloo_rank); rank 0's checkpoint loaded here against the gathered
    parameters.  Returns (kernels 2-4's launches by rank summed, kernel 2's
    vocab-block record)."""
    from echr_tpu_torch.engine import checkpoint as ckpt
    from echr_tpu_torch.engine import train as train_mod

    t_phase = time.time()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 31 needs TF32 off")
    with tempfile.TemporaryDirectory() as tmp:
        caught = []
        t0 = time.time()
        with patched(train_mod, "train_step", _xe_capture(caught)):
            one = train_mod.train(tp_cfg(os.path.join(tmp, "one"), "one"),
                                  max_iterations=TP_STEPS, device=dev)
        torch.cuda.synchronize()
        one_wall = time.time() - t0
        torch.save({"grads": [g.cpu() for g in caught[0][0]], "loss": caught[0][1]["loss"]},
                   os.path.join(tmp, "one.pt"))
        del one, caught
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", TP_CHILD.format(repo=os.path.dirname(os.path.abspath(
                __file__)), rank=r, port=port, tmp=tmp, dev=dev)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=2 * DP_TIMEOUT_S)[0])
        finally:
            for p in procs:
                p.kill()
        for r, log_ in enumerate(logs):
            for line in log_.splitlines():
                if line.startswith("[31]"):
                    print(line.replace("[31]", f"[31] rank {r}:", 1))
        if any(p.returncode for p in procs):
            fail(f"[31] two gloo ranks: exit codes {[p.returncode for p in procs]}; rank 0 "
                 f"said {logs[0][-3000:]}\nrank 1 said {logs[-1][-3000:]}")
        recs = []
        for r in range(2):
            with open(os.path.join(tmp, f"tp_rank{r}.json")) as f:
                recs.append(json.load(f))
        got = torch.load(os.path.join(tmp, "tp_whole.pt"))
        state = ckpt.load_checkpoint(os.path.join(tmp, "tp", "tp", "model-last.ckpt"),
                                     dev)["state"]
        loaded = [p.detach().cpu() for mod in (state.tap, state.cg) for p in mod.parameters()]
        ckpt_equal = len(loaded) == len(got) and all(torch.equal(a, b)
                                                     for a, b in zip(loaded, got))
        del state, loaded, got
    a, b = (r["train"] for r in recs)
    tf = SEQ_LEN - 1
    want = {k: tf * TP_STEPS for k in a["launches_in_steps"]}
    d, f = tp_cfg(".", "tp").decoder, tp_cfg(".", "tp").fusion
    half = (TP_VOCAB + 1) // 2
    cut_want = {"decoder.embed": [half, d.CG_input_encoding_size],
                "decoder.logit.weight": [half, 3 * d.CG_rnn_size],
                "decoder.logit.bias": [half], "fusion.out.weight": [f.d_o // 2, f.d_feats]}
    ok = (a["iteration"] == b["iteration"] == TP_STEPS
          and a["replicated_digest"] == b["replicated_digest"]
          and a["whole_digest"] == b["whole_digest"] and ckpt_equal
          and a["launches_in_steps"] == b["launches_in_steps"] == want
          and not a["grads_outside_gate"] and not b["grads_outside_gate"]
          and a["cut"] == b["cut"] == cut_want
          and abs(a["loss"] - a["want_loss"]) <= 1e-5 * abs(a["want_loss"])
          and a["best_val_score"] == b["best_val_score"] > -1.0)
    print(f"[31] (a) train() under mesh (1, 2) at B={TP_B}, N={TRAIN_N}, T={T_BUCKET}, f32, "
          f"TF32 off, dropout off, vocab {TP_VOCAB} (V+1 cut {(TP_VOCAB + 1) // 2} + "
          f"{(TP_VOCAB + 1) // 2}), TSRM's 16 heads 8 + 8, {TP_STEPS} XE steps and the gate at "
          f"{TP_STEPS} over {TP_EVAL} val videos: step 1's loss {a['loss']:.7f} against one "
          f"process's {a['want_loss']:.7f}; gradient leaves outside atol 2e-4, rtol 1e-3: "
          f"{len(a['grads_outside_gate'])}, {len(b['grads_outside_gate'])} of "
          f"{a['grad_leaves']} (max|d| {a['grad_max_abs_err']:.3e}, "
          f"{b['grad_max_abs_err']:.3e}); replicated parameters bit-equal between the ranks: "
          f"{a['replicated_digest'] == b['replicated_digest']}; cut leaves {a['cut']}; "
          f"kernels 3-4 in the XE steps by rank {a['launches_in_steps']}, "
          f"{b['launches_in_steps']} (the run's with the histogram step {a['launches']}); the "
          f"gate's score {a['best_val_score']:.4f} on both: "
          f"{a['best_val_score'] == b['best_val_score']}; rank 0's checkpoint loaded in one "
          f"process bit-equal to the gathered parameters: {ckpt_equal}; train() wall "
          f"{a['wall_s']:.1f}, {b['wall_s']:.1f} s against one process's {one_wall:.1f} s (two "
          f"processes time-slicing one card: no scaling number) [{card}]")
    if not ok:
        fail(f"[31] (a) tensor-parallel training against one process: {recs}")
    bl = [r["baseline"] for r in recs]
    for r, x in enumerate(bl):
        print(f"[31] (b) rank {r}: the SCST rollouts at (1, 2) against the gathered model's: "
              f"sampled tokens equal {x['rollout_tokens_equal']}, greedy baseline tokens equal "
              f"{x['baseline_tokens_equal']}; kernel 2 launched {x['kernel2_launches']} times in "
              f"{x['greedy_steps']} baseline steps; on the first step's R={x['rows']} rows: "
              f"kernel 2 on the {x['block_V1']}-column block against plain max|d| "
              f"{x['block_max_abs_err']:.3e}, the combined blocks against kernel 2 on all "
              f"{x['whole_V1']} columns: {x['combined_token_mismatches']} token mismatches, "
              f"max |d| {x['combined_max_err']:.3e}, lse |d| {x['combined_lse_err']:.3e}; "
              f"kernel 2 f32 block {x['block_f32_ms']:.4f} ms, whole {x['whole_f32_ms']:.4f} "
              f"ms; bf16 block {x['block_bf16_ms']:.4f} ms (plain "
              f"{x['block_bf16_plain_ms']:.4f}, bound {x['block_bf16_bound_ms']:.4f} ms, "
              f"{x['block_bf16_bound_by']}), whole {x['whole_bf16_ms']:.4f} ms (both ranks on "
              f"one card) [{card}]")
        if not (x["rollout_tokens_equal"] and x["baseline_tokens_equal"]
                and x["kernel2_launches"] == x["greedy_steps"] > 0
                and x["combined_token_mismatches"] == 0 and x["combined_lse_err"] <= TOL):
            fail(f"[31] (b) rank {r}: {x}")
    for T in RING_T:
        ra, rb = (r["ring"][f"T{T}"] for r in recs)
        print(f"[31] (c) the SST ring at T={T} (C3D {VIDEO_DIM}, hidden 512, 2 layers, f32) "
              f"over two ranks: max|d| against one process's sst_forward_batched "
              f"{ra['max_abs_err']:.3e}, {rb['max_abs_err']:.3e}; the ring's wall "
              f"{ra['ring_s']:.3f} s against one process's {ra['one_process_s']:.3f} s; peak "
              f"memory by rank {ra['ring_peak_bytes'] / 2**20:.1f}, "
              f"{rb['ring_peak_bytes'] / 2**20:.1f} MiB against one process's "
              f"{ra['one_process_peak_bytes'] / 2**20:.1f} MiB [{card}]")
        if not max(ra["max_abs_err"], rb["max_abs_err"]) <= 1e-5:
            fail(f"[31] (c) the ring at T={T}: {ra}, {rb}")
    launches = {"attention_scores_dense": a["launches"]["attention_scores_dense"]
                + b["launches"]["attention_scores_dense"],
                "attention_scores_bwd": a["launches"]["attention_scores_bwd"]
                + b["launches"]["attention_scores_bwd"],
                "greedy_head": sum(x["kernel2_launches"] for x in bl)}
    x = bl[0]
    block = {"R": x["rows"], "C": x["cols"], "V1": x["block_V1"], "ms": x["block_bf16_ms"],
             "plain_ms": x["block_bf16_plain_ms"], "whole_vocab_ms": x["whole_bf16_ms"],
             "max_abs_err": max(y["block_bf16_max_abs_err"] for y in bl),
             **{k[len("block_bf16_"):]: v for k, v in x.items()
                if k.startswith("block_bf16_") and k not in ("block_bf16_max_abs_err",
                                                             "block_bf16_plain_ms")}}
    print(f"[31] phase wall {time.time() - t_phase:.1f} s [{card}]")
    return launches, block


def phase_resident_scst(card, dev="cuda"):
    """Phase 32(a): resident-graph SCST against the replay path at f32 with
    TF32 off on phase 23's batch (B=32 at train_cfg()'s width, phase 5's
    sharpened weights, dropout on from one generator state, a fixed random
    reward): step 1's loss within 1e-5 relative and gradient leaves within
    atol 2e-4, rtol 1e-3; 2 steps of each path in turns (resident, replay,
    replay, resident), each a rollout and an update; ms a step and the peak
    memory; kernels 3-4's launches by path.  Returns the launches."""
    from echr_tpu_torch.data.batcher import make_batch
    from echr_tpu_torch.data.dataset import SyntheticDataset
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine.train import _collate, _executed_steps
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd, attention_scores_dense

    cfg = scst_cfg(compute_dtype="float32").replace_in("decoder", CG_vocab_size=VOCAB,
                                                         CG_seq_length=SEQ_LEN)
    ds = SyntheticDataset(cfg, num_videos=TRAIN_B, seed=11)
    batch = steps.batch_to_device(_collate([
        make_batch(ds.get_example(i), cfg, np.random.RandomState(i), w1=ds.w1)[0]
        for i in range(TRAIN_B)]), dev)
    B, N = batch.prop_mask.shape
    reward = torch.from_numpy(np.broadcast_to(np.random.RandomState(32).randn(B, N, 1),
                                              (B, N, SEQ_LEN)).astype(np.float32)).to(dev)
    states = {}
    for path in ("resident", "replay"):
        gen = torch.Generator().manual_seed(0)
        states[path] = steps.init_train_state(cfg, init_tap(gen, cfg, dev),
                                              init_captioner(gen, cfg, dev))
        with torch.no_grad():
            states[path].cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
    gen, sample_gen = torch.Generator(dev).manual_seed(3), torch.Generator(dev).manual_seed(4)
    g0, s0 = gen.get_state(), sample_gen.get_state()
    caught, seqs, recs = {}, {}, {"resident": [], "replay": []}
    apply = steps.apply_grads

    def run(path):
        state = states[path]
        gen.set_state(g0)
        sample_gen.set_state(s0)
        for fn in (attention_scores_dense, attention_scores_bwd):
            fn.launches = 0

        def catch(state_, tap_g, cg_g, *a):
            caught.setdefault(path, [g.detach().clone() for g in tap_g + cg_g])
            return apply(state_, tap_g, cg_g, *a)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with patched(steps, "apply_grads", catch):
            if path == "resident":
                kept, gen_seq, _ = steps.rl_rollout_graph_step_batched(state, batch, cfg,
                                                                       "tap_cg", gen, sample_gen)
                _, m = steps.rl_graph_update_step_batched(state, batch, cfg, "tap_cg", kept,
                                                          reward)
                del kept
            else:
                _, gen_seq, _ = steps.rl_rollout_step_batched(state, batch, cfg, "tap_cg", gen,
                                                              sample_gen)
                gen.set_state(g0)
                _, m = steps.rl_update_step_batched(state, batch, cfg, "tap_cg", gen, gen_seq,
                                                    reward)
        (m,) = steps.fetch_metrics(m)
        torch.cuda.synchronize()
        seqs.setdefault(path, gen_seq)
        recs[path].append({"ms": (time.time() - t0) * 1e3, "loss": m["loss"],
                           "peak_bytes": torch.cuda.max_memory_allocated(),
                           "sample_steps": _executed_steps(gen_seq.cpu().numpy()),
                           "launches": {fn.__name__: fn.launches
                                        for fn in (attention_scores_dense,
                                                   attention_scores_bwd)}})

    for path in ("resident", "replay", "replay", "resident"):
        run(path)
    r1, p1 = recs["resident"][0], recs["replay"][0]
    bad = [i for i, (a, b) in enumerate(zip(caught["resident"], caught["replay"]))
           if not torch.allclose(a, b, atol=2e-4, rtol=1e-3)]
    worst = max(float((a - b).abs().max()) for a, b in zip(caught["resident"], caught["replay"]))
    steps_ = r1["sample_steps"]
    same_tokens = bool(torch.equal(seqs["resident"], seqs["replay"]))
    ok = (same_tokens and not bad and abs(r1["loss"] - p1["loss"]) <= 1e-5 * abs(p1["loss"])
          and r1["launches"]["attention_scores_dense"] == steps_
          and r1["launches"]["attention_scores_bwd"] == steps_
          and p1["launches"]["attention_scores_dense"] == steps_ + SEQ_LEN
          and p1["launches"]["attention_scores_bwd"] == SEQ_LEN)
    ms = {k: [round(r["ms"], 1) for r in v] for k, v in recs.items()}
    print(f"[32] (a) resident-graph SCST against the replay at B={B}, N={N}, f32, TF32 off, "
          f"dropout on: the same sampled tokens {same_tokens}; step 1's loss {r1['loss']:.7f} "
          f"against {p1['loss']:.7f}; gradient "
          f"leaves outside atol 2e-4, rtol 1e-3: {len(bad)} of {len(caught['resident'])} "
          f"(max|d| {worst:.3e}); ms a step (rollouts and update, a fixed reward) in turns "
          f"(resident, replay, replay, resident): resident {ms['resident']}, replay "
          f"{ms['replay']}; peak memory resident "
          f"{max(r['peak_bytes'] for r in recs['resident']) / 2**30:.2f} GiB (the graph kept "
          f"across the reward), replay {max(r['peak_bytes'] for r in recs['replay']) / 2**30:.2f}"
          f" GiB; kernels 3-4 a step: resident {r1['launches']}, replay {p1['launches']} "
          f"({steps_} sampled steps) [{card}]")
    if not ok:
        fail(f"[32] (a) resident-graph SCST: {recs}, gradient leaves outside the gate {bad}")
    return {k: r1["launches"][k] + p1["launches"][k] for k in r1["launches"]}


def grouped_record(card, name, t):
    """Phase 32(b) at one decode step's input t (step_inputs' keys, f32):
    grouped_attention_step over groups of 8 rows (tg the groups' longest
    span rounded up to 8) against additive_attention_step through kernel 1
    at f32 within 1e-5, and timed in turns with that route and kernel 6.
    The attention's h2att is the identity, so its query is t["q"]."""
    from echr_tpu_torch.ops import attention as att
    from echr_tpu_torch.ops.kernel_attention_step import windowed_attention

    B, T, H = t["pre"].shape
    N = t["q"].shape[1]
    ng = max(g for g in (8, 4, 2, 1) if N % g == 0)
    mod = att.AdditiveAttention(t["feats"].shape[2], H, H).to(t["pre"].device)
    with torch.no_grad():
        mod.h2att.weight.copy_(torch.eye(H))
        mod.h2att.bias.zero_()
        mod.alpha_net.weight.copy_(t["w"].reshape(1, H))
        mod.alpha_net.bias.copy_(t["b"].reshape(1))
    need = att.grouped_tg_required(t["soi"].cpu().numpy(), ng)
    tg = min(T, -(-need // 8) * 8)
    with torch.inference_mode():
        grp = att.grouped_attention_precompute(t["mask"], tg, ng)
        got = att.grouped_attention_step(mod, t["q"], t["feats"], t["pre"], grp)
        want, _ = att.additive_attention_step(mod, t["q"], t["feats"], t["pre"], t["mask"],
                                              use_kernel=True)
        err = float((got - want).abs().max())
        turns = in_turns({
            "grouped": lambda: att.grouped_attention_step(mod, t["q"], t["feats"], t["pre"],
                                                          grp),
            "kernel1_route": lambda: att.additive_attention_step(
                mod, t["q"], t["feats"], t["pre"], t["mask"], use_kernel=True),
            "kernel6": lambda: windowed_attention(t["pre"], t["feats"], t["q"], t["w"], t["b"],
                                                  t["soi"], W=WINDOW)})
    rec = {"B": B, "N": N, "T": T, "ng": ng, "tg": tg, "max_abs_err": err,
           **{f"{k}_ms": sum(v) / 2 for k, v in turns.items()}}
    print(f"[32] (b) grouped attention, {name} B={B} N={N} T={T} (groups of {ng}, tg {tg}): "
          f"max|d| against additive_attention_step through kernel 1 at f32 {err:.3e}; in turns "
          + ", ".join(f"{k} {x:.4f} / {y:.4f}" for k, (x, y) in turns.items()) + f" ms [{card}]")
    if not err <= 1e-5:
        fail(f"[32] (b) grouped attention, {name}: max|d| {err:.3e} > 1e-5")
    return rec


def switch_pass(cfg_kw, tap, cg, loader, cfg, kw, json_path, dev="cuda"):
    """One per-video eval_split pass of phase 32(c) under cfg_kw's runtime
    fields: (predictions, kernel 1 and 2 launches, early-exit syncs)."""
    from echr_tpu_torch.engine import evaluate
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head

    for fn in (attention_scores_masked, greedy_head):
        fn.launches = 0
    syncs = decoder_sample_batched.host_syncs + beam_search_batched.host_syncs
    preds, _, _ = evaluate.eval_split(tap, cg, loader, cfg.replace_in("runtime", **cfg_kw),
                                      json_path, kw, device=dev)
    torch.cuda.synchronize()
    return (preds, attention_scores_masked.launches, greedy_head.launches,
            decoder_sample_batched.host_syncs + beam_search_batched.host_syncs - syncs)


def compare_captions(got, want):
    """(captions, sentences that differ, the largest confidence difference
    a token of the equal sentences) of two per-video passes over the same
    videos and proposals."""
    if list(got) != list(want):
        fail("[32] (c) the passes captioned other videos")
    n, differ, worst = 0, 0, 0.0
    for vid in want:
        if len(got[vid]) != len(want[vid]):
            fail(f"[32] (c) {vid}: {len(got[vid])} captions against {len(want[vid])}")
        for j, (g, w) in enumerate(zip(got[vid], want[vid])):
            n += 1
            if g["timestamp"] != w["timestamp"]:
                fail(f"[32] (c) {vid} proposal {j}: another timestamp")
            if g["sentence"] == w["sentence"]:
                worst = max(worst, abs(g["sentence_confidence"] - w["sentence_confidence"])
                            / (len(w["sentence"].split()) + 1))
            else:
                differ += 1
    return n, differ, worst


def phase_switches(card, dev="cuda"):
    """Phase 32(c): the per-video eval_split on SWITCH_VIDEOS val videos of
    phase 18's split and weights: greedy and beam 4 with decode_early_exit
    True and False (the same captions, confidences within 1e-6 a token, no
    early-exit sync in the fixed loops); then at f32 with phase 5's
    weights and the window sort off, greedy with use_pallas_head False
    against True: kernel 2 never launched, kernel 1's launches unchanged,
    the same sentences, and their confidences within HEAD_SWITCH_TOL a
    token (the two heads sum the lse in other orders).  Returns the
    launches."""
    launches = {"attention_scores_masked": 0, "greedy_head": 0}
    base = {"topN": TOP_N, "num_vids_eval": SWITCH_VIDEOS, "language_eval": False,
            "get_eval_loss": False}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("bfloat16", "float32"):
            cfg, tap, cg, ds, loader = eval_setup(compute_dtype=dtype)
            if dtype == "float32":
                with torch.no_grad():
                    cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
                cases = [(f"f32 greedy use_pallas_head={h}",
                          {"use_pallas_head": h, "sort_decode_props": False}, base)
                         for h in (True, False)]
            else:
                cases = [(f"{name} decode_early_exit={e}", {"decode_early_exit": e},
                          dict(base, beam_size=k))
                         for name, k in (("greedy", 1), (f"beam {BEAM}", BEAM))
                         for e in (True, False)]
            out = {}
            try:
                for name, cfg_kw, kw in cases:
                    out[name] = switch_pass(cfg_kw, tap, cg, loader, cfg, kw,
                                            f"{tmp}/{len(out)}.json", dev)
                    launches["attention_scores_masked"] += out[name][1]
                    launches["greedy_head"] += out[name][2]
            finally:
                loader.load_state(loader.state())
            names = list(out)
            for a, b in zip(names[::2], names[1::2]):
                (pa, k1a, k2a, sa), (pb, k1b, k2b, sb) = out[a], out[b]
                head = "use_pallas_head" in a
                n, differ, worst = compare_captions(pb, pa)
                print(f"[32] (c) per-video eval_split over {len(pa)} val videos ({n} captions), "
                      f"{b} against {a}: {differ} sentences differ, max|d| confidence "
                      f"{worst:.3e} a token; kernel 1 launches {k1a}, {k1b}; kernel 2 {k2a}, "
                      f"{k2b}; early-exit syncs {sa}, {sb} [{card}]")
                if head:
                    ok = (differ == 0 and worst <= HEAD_SWITCH_TOL and k2b == 0 < k2a
                          and k1a == k1b > 0)
                else:
                    ok = differ == 0 and worst <= 1e-6 and sb == 0 < sa and k1a == k1b
                if not ok:
                    fail(f"[32] (c) {b} against {a}")
    return launches


def phase_single_process(card, dev="cuda"):
    """Phase 32: resident-graph SCST (a), grouped attention at phases 29's
    and 27's decode steps (b), and the two decode switches (c).  Returns
    (the launches by path, the grouped records)."""
    t_phase = time.time()
    resident = phase_resident_scst(card, dev)
    grouped = {name: grouped_record(card, label, STEP_INPUTS[name])
               for name, label in (("per_video", "phase 29's per-video decode step"),
                                   ("sota_eval", "phase 27's SOTA_TEP decode step"))}
    switches = phase_switches(card, dev)
    print(f"[32] phase wall {time.time() - t_phase:.1f} s [{card}]")
    return {"scst_resident": resident, "decode_switches": switches}, grouped


HOST_STEPS = 3  # phase 33: steps a train run, each loop with the host library on and off
HOST_NMS = 0.8  # phase 33: the NMS overlap of its eval passes (gettop1000_nms's default)
HOST_ROUNDS = 1  # phase 33: rounds of (on, off, off, on) of its serving and eval passes


def host_mode(mode):
    """The host library "on" (its default) or "off" (force_numpy())."""
    from echr_tpu_torch import native

    return native.force_numpy() if mode == "off" else contextlib.nullcontext()


def host_cpu():
    """The host CPU's model name, as /proc/cpuinfo gives it, and its cores."""
    try:
        with open("/proc/cpuinfo") as f:
            model = next(ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name"))
    except (OSError, StopIteration):
        model = "unknown"
    return f"model {model}, {os.cpu_count()} cores"


def host_turns(fns, inputs, same):
    """Mean host ms a call of fns["on"](x) and fns["off"](x) over every x of
    ``inputs``, timed in turns (on, off, off, on) with perf_counter.  Fails
    unless same(on's output, off's output) holds for every x.  Returns
    {"on": [ms, ms], "off": [ms, ms], "calls": len(inputs)}."""
    times, outs = {"on": [], "off": []}, {}
    for mode in ("on", "off", "off", "on"):
        fn = fns[mode]
        t0 = time.perf_counter()
        got = [fn(x) for x in inputs]
        times[mode].append((time.perf_counter() - t0) * 1e3 / len(inputs))
        outs.setdefault(mode, got)
    bad = sum(not same(a, b) for a, b in zip(outs["on"], outs["off"]))
    if bad:
        fail(f"[33] {bad} of {len(inputs)} host calls differ between C++ and numpy")
    return {**times, "calls": len(inputs)}


def host_train_batches(card):
    """33(a): the first 2 x TRAIN_B training videos of train_cfg()'s split
    through make_batch with the C++ grid and under force_numpy(): every
    field bit-equal; then iou_grid alone on their grids (K = 256)."""
    from echr_tpu_torch import native
    from echr_tpu_torch.data import batcher, labels
    from echr_tpu_torch.data.dataset import build_dataset

    cfg = train_cfg()
    ds = build_dataset(cfg)
    grids = []
    differ = []
    with wrapped(labels, "iou_grid", lambda *a: native.active() and grids.append(a)):
        for ix in ds.split_ix["train"][:2 * TRAIN_B]:
            ex = ds.get_example(ix)
            on, on_m = batcher.make_batch(ex, cfg, np.random.RandomState(ix), w1=ds.w1)
            with native.force_numpy():
                off, off_m = batcher.make_batch(ex, cfg, np.random.RandomState(ix), w1=ds.w1)
            for name, x, y in zip(on._fields, on, off):
                if not np.array_equal(x, y) or np.asarray(x).dtype != np.asarray(y).dtype:
                    differ.append(f"{ex.vid}.{name}")
            for name in ("iou_scores", "gts_index", "cg_select", "proposal_num"):
                if not np.array_equal(getattr(on_m, name), getattr(off_m, name)):
                    differ.append(f"{ex.vid}.{name}")
    if differ or len(grids) != 2 * TRAIN_B:
        fail(f"[33] training batches with the C++ grid and under force_numpy(): {differ[:8]} "
             f"differ; {len(grids)} grids")
    print(f"[33] (a) {len(grids)} training videos of train_cfg()'s split through make_batch, "
          f"the C++ grid against force_numpy(): every VideoBatch field (tap_labels, tap_masks, "
          f"the gts_* fields among them) and BatchMeta's iou_scores, gts_index, cg_select and "
          f"proposal_num bit-equal")

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    times = host_turns({"on": lambda a: native.iou_grid(*a),
                        "off": lambda a: labels.iou_grid_numpy(*a)}, grids, same)
    Ts = [g[1] for g in grids]
    print(f"[33] iou_grid a video (T={min(Ts)}-{max(Ts)}, mean {np.mean(Ts):.1f}, "
          f"K={grids[0][2]}, {np.mean([len(g[0]) for g in grids]):.1f} events on average), in "
          f"turns over {len(grids)} videos: C++ {times['on'][0]:.3f}, {times['on'][1]:.3f} ms; "
          f"numpy {times['off'][0]:.3f}, {times['off'][1]:.3f} ms; bit-equal [{card}; host "
          f"{host_cpu()}]")
    return times


def host_serve(card, dev="cuda"):
    """33(b): phase 6's slice (flagship_cfg(), seed 0, 64 requests of seed 2,
    32 a chunk) captioned in turns with the host library on and off: the
    same captions, captions/s, render_captions' calls; then each chunk's
    rendering alone (32 calls of 128 rows: 4096 captions)."""
    from echr_tpu_torch import native
    from echr_tpu_torch import serve as serve_mod
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.utils import text

    cfg = flagship_cfg()
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    svc = serve_mod.CaptionService(cfg, tap, cg, vocab, device=dev, batch_videos=32,
                                   topN=TOP_N)
    reqs = requests(64, seed=2)
    seqs = []
    with wrapped(serve_mod, "decode_sequence", lambda v, seq: seqs.append(np.array(seq))):
        svc.caption(reqs)  # warm-up, keeping the rows each video renders
    rates, render_s, calls, caps = {"on": [], "off": []}, {"on": [], "off": []}, {}, []
    order = ("on", "off", "off", "on") * HOST_ROUNDS
    render = serve_mod.decode_sequence
    spent = []

    def timed_render(*args):
        t0 = time.perf_counter()
        try:
            return render(*args)
        finally:
            spent.append(time.perf_counter() - t0)
    for mode in order:
        native.reset_counts()
        spent.clear()
        with host_mode(mode), patched(serve_mod, "decode_sequence", timed_render):
            t0 = time.time()
            res = svc.caption(reqs)
            torch.cuda.synchronize()
            dt = time.time() - t0
        calls.setdefault(mode, native.counts()["render_captions"])
        n = sum(len(c) for c in res.values())
        rates[mode].append(n / dt)
        render_s[mode].append(sum(spent))
        caps.append({vid: [(c.sentence, tuple(c.timestamp), c.proposal_score,
                            c.sentence_confidence) for c in cs] for vid, cs in res.items()})
    differ = [sum(a[v] != b[v] for v in a) for a, b in zip(caps, caps[1:])]
    if any(differ) or not calls["on"] > 0:
        fail(f"[33] serving: videos whose captions differ between neighbouring runs {differ}; "
             f"render_captions calls {calls}")
    seen = {"on": iter(rates["on"]), "off": iter(rates["off"])}
    print(f"[33] (b) phase 6's slice, host library {', '.join(order)}: "
          f"{[round(next(seen[m]), 1) for m in order]} captions/s ({n} captions, the same "
          f"in every run); seconds in decode_sequence a pass on "
          f"{[round(x, 4) for x in render_s['on']]}, off {[round(x, 4) for x in render_s['off']]}; "
          f"render_captions calls {calls} [{card}]")
    chunks = [seqs[:32], seqs[32:64]]
    render = host_turns({"on": lambda ch: [text.decode_sequence(vocab, s) for s in ch],
                         "off": lambda ch: [text.decode_sequence_numpy(vocab, s) for s in ch]},
                        chunks, lambda a, b: a == b)
    rows = sum(len(s) for s in chunks[0])
    print(f"[33] render_captions a chunk of {rows} captions ({len(chunks[0])} calls, "
          f"L={seqs[0].shape[1]}), in turns over {len(chunks)} chunks: C++ "
          f"{render['on'][0]:.3f}, {render['on'][1]:.3f} ms; numpy {render['off'][0]:.3f}, "
          f"{render['off'][1]:.3f} ms; equal strings [{card}; host {host_cpu()}]")
    return {"captions_per_s": rates, "render_s_a_pass": render_s, "render_captions_calls": calls,
            "render_ms_a_chunk": render}


def host_eval(card, dev="cuda"):
    """33(c): phase 18's greedy eval with val losses, unscored, in turns with
    the host library on and off: the same predictions JSON and val losses,
    eval videos/s; then one pass with NMS (HOST_NMS) keeping its score
    grids, and nms_temporal alone on them, on and off."""
    from echr_tpu_torch import native
    from echr_tpu_torch.data.labels import anchor_mask
    from echr_tpu_torch.engine import evaluate
    from echr_tpu_torch.engine import proposals as P

    cfg, tap, cg, ds, loader = eval_setup()
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": False, "get_eval_loss": True}
    run = functools.partial(evaluate.eval_split_batched, tap, cg, loader, cfg,
                            flag_eval_what="tap_cg", batch_videos=EVAL_B, device=dev)
    rates, calls, outs = {"on": [], "off": []}, {}, []
    order = ("on", "off", "off", "on") * HOST_ROUNDS
    grids = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run(f"{tmp}/w.json", dict(kw, num_vids_eval=EVAL_B))  # warm-up
            for i, mode in enumerate(order):
                native.reset_counts()
                with host_mode(mode):
                    t0 = time.time()
                    preds, _, losses = run(f"{tmp}/{i}.json", kw)
                    dt = time.time() - t0
                calls.setdefault(mode, native.counts())
                rates[mode].append(len(preds) / dt)
                with open(f"{tmp}/{i}.json") as f:
                    outs.append((f.read(), losses))
            native.reset_counts()
            with wrapped(P, "top_proposals_nms", lambda pp, *a: grids.append(pp.copy())):
                nms_preds, _, _ = run(f"{tmp}/nms.json", dict(kw, nms_threshold=HOST_NMS,
                                                              get_eval_loss=False))
            calls["nms_pass"] = native.counts()
    finally:
        loader.load_state(loader.state())  # stops and joins the prefetch threads
    differ = [a[0] != b[0] or not np.array_equal(a[1], b[1]) for a, b in zip(outs, outs[1:])]
    if any(differ) or not (calls["on"]["iou_grid"] > 0 and calls["on"]["render_captions"] > 0
                           and calls["nms_pass"]["nms_temporal"] == len(grids) > 0):
        fail(f"[33] eval: neighbouring passes' predictions JSON or val losses differ {differ}; "
             f"host calls {calls}, {len(grids)} NMS grids")
    seen = {"on": iter(rates["on"]), "off": iter(rates["off"])}
    print(f"[33] (c) phase 18's greedy eval with val losses, unscored, host library "
          f"{', '.join(order)}: {[round(next(seen[m]), 2) for m in order]} eval videos/s; "
          f"predictions JSON ({len(preds)} videos) and val losses "
          f"{np.round(outs[0][1][:3], 4).tolist()} the same in every pass; host calls {calls}; "
          f"the NMS pass ({HOST_NMS}): {len(nms_preds)} videos, "
          f"{sum(len(c) for c in nms_preds.values())} captions [{card}]")

    props = []  # the anchors and scores as top_proposals_nms lays them out
    for pp in grids:
        n_idx, k_idx = np.nonzero(anchor_mask(*pp.shape) > 0)
        props.append((np.stack([n_idx - k_idx, n_idx + 1], 1).astype(np.int64),
                      pp[n_idx, k_idx].astype(np.float64)))
    alone = host_turns(
        {"on": lambda a: native.nms_temporal(*a, HOST_NMS, TOP_N).tolist(),
         "off": lambda a: P.nms_temporal_numpy(*a, HOST_NMS, TOP_N)},
        props, lambda a, b: a == b)
    T, K = grids[0].shape
    print(f"[33] nms_temporal a video (phase 18's score grids, T={T}, K={K}, "
          f"{len(props[0][1])} anchors, overlap {HOST_NMS}, topN {TOP_N}), in turns over "
          f"{len(grids)} videos: C++ {alone['on'][0]:.3f}, {alone['on'][1]:.3f} ms; numpy "
          f"{alone['off'][0]:.3f}, {alone['off'][1]:.3f} ms; the same picks [{card}; host "
          f"{host_cpu()}]")
    return {"eval_videos_per_s": rates, "host_calls": calls, "nms_temporal_ms": alone}


def host_sota(card, dev="cuda"):
    """33(d): phase 27's corpus on disk and external proposals (the same
    export and seed), the SOTA_TEP eval with NMS (HOST_NMS), unscored and
    without val losses, keeping every external_proposals_nms call; then
    those calls on and off."""
    import shutil

    from echr_tpu_torch import native
    from echr_tpu_torch.data.export_disk import export_synthetic_corpus
    from echr_tpu_torch.engine import evaluate
    from echr_tpu_torch.engine import proposals as P

    root = tempfile.mkdtemp(prefix="chip_smoke_host_")
    kept = []
    try:
        paths = export_synthetic_corpus(eval_cfg(), root, log_every=0)
        sota_path = f"{root}/sota_proposals.json"
        write_sota_json(paths, sota_path)
        cfg, ds, loader, tap, cg = sota_loader(root, sota_path)
        try:
            native.reset_counts()
            with wrapped(P, "external_proposals_nms", lambda *a: kept.append(a)):
                preds, _, _ = evaluate.eval_split_batched(
                    tap, cg, loader, cfg, f"{root}/p.json",
                    {"topN": TOP_N, "num_vids_eval": 0, "language_eval": False,
                     "get_eval_loss": False, "nms_threshold": HOST_NMS},
                    flag_eval_what="SOTA_TEP", batch_videos=EVAL_B, device=dev)
            calls = native.counts()
        finally:
            loader.load_state(loader.state())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not (calls["nms_external"] == len(kept) > 0 and preds):
        fail(f"[33] SOTA_TEP eval with NMS: host calls {calls}, {len(kept)} NMS calls kept, "
             f"{len(preds)} videos")

    def nms(a):
        return P.external_proposals_nms(*a, nms_overlap=HOST_NMS, topN=1000)

    def nms_off(a):
        with native.force_numpy():
            return nms(a)
    times = host_turns({"on": nms, "off": nms_off}, kept, lambda a, b: a == b)
    picked = np.mean([len(nms(a)[2]) for a in kept])
    print(f"[33] (d) the SOTA_TEP eval from disk with NMS {HOST_NMS}: {len(preds)} videos, host "
          f"calls {calls}; external_proposals_nms a video ({len(kept[0][0])} proposals, "
          f"{picked:.1f} picked on average), in turns over {len(kept)} videos: C++ "
          f"{times['on'][0]:.4f}, {times['on'][1]:.4f} ms; numpy {times['off'][0]:.4f}, "
          f"{times['off'][1]:.4f} ms; the same picks [{card}; host {host_cpu()}]")
    return {"host_calls": calls, "external_proposals_nms_ms": times}


def host_train_loops(card, dev="cuda"):
    """33(e): phase 28's synchronous and pipelined loops (train_cfg(), B=32,
    bf16, dropout on), HOST_STEPS steps a run, each loop with the host
    library on, off, off, on: ms/step, the loader and collate seconds, and
    the C++ grid's calls (above zero on).  Returns the runs and kernels 3
    and 4's launches."""
    from echr_tpu_torch import native

    cfg = train_cfg()
    runs = {f"{loop}_{mode}": [] for loop in ("sync", "pipelined") for mode in ("on", "off")}
    launches = {"attention_scores_dense": 0, "attention_scores_bwd": 0}
    for loop in ("sync", "pipelined"):
        for mode in ("on", "off", "off", "on"):
            native.reset_counts()
            with host_mode(mode):
                _, rec = pipeline_run(card, cfg, loop == "pipelined", HOST_STEPS,
                                      f"{loop}, host library {mode}", dev=dev, phase=33)
            rec["iou_grid_calls"] = native.counts()["iou_grid"]
            runs[f"{loop}_{mode}"].append(rec)
            for k, v in rec["launches"].items():
                launches[k] += v
    if not all(r["iou_grid_calls"] > 0 for k, v in runs.items() if k.endswith("_on") for r in v):
        fail(f"[33] a training run with the host library on made no C++ grid")
    keys = ("ms_per_step", "loader", "collate")
    summary = {name: {k: [round(r[k], 3) for r in v] for k in keys + ("iou_grid_calls",)}
               for name, v in runs.items()}
    for loop in ("sync", "pipelined"):
        on, off = summary[f"{loop}_on"], summary[f"{loop}_off"]
        print(f"[33] (e) the {loop} loop, {HOST_STEPS} steps a run, host library on / off "
              f"(on, off, off, on): ms/step {on['ms_per_step']} / {off['ms_per_step']}, "
              f"loader s {on['loader']} / {off['loader']}, collate s {on['collate']} / "
              f"{off['collate']}; C++ grids {on['iou_grid_calls']} / {off['iou_grid_calls']} "
              f"[{card}]")
    return summary, launches


def phase_host_native(card, dev="cuda"):
    """Phase 33: the host library (echr_tpu_torch/native) built, used on the
    train, eval, serve and SOTA_TEP paths, equal on and off, and timed.
    Returns (its record, kernels 3 and 4's launches in its train runs)."""
    from echr_tpu_torch import native

    t_phase = time.time()
    if not native.available():
        fail("[33] the host library is not available")
    so = native.library_path()
    print(f"[33] host library {so.relative_to(native.BUILD_DIR.parent.parent)} built and "
          f"loaded; host CPU {host_cpu()}")
    rec = {"card": card, "host_cpu": host_cpu(), "available": True,
           "iou_grid_ms": host_train_batches(card)}
    rec["serve"] = host_serve(card, dev)
    rec["eval"] = host_eval(card, dev)
    rec["sota_eval"] = host_sota(card, dev)
    rec["train_loops"], launches = host_train_loops(card, dev)
    rec["phase_wall_s"] = time.time() - t_phase
    print(f"[33] phase wall {rec['phase_wall_s']:.1f} s [{card}]")
    return rec, launches


# phase 34(a): steps of recipe stages 1-4, each gated at its last; at 100
# steps stage 2's captioner still emitted the end token first
RECIPE_CAPS = (10, 200, 10, 6)
CLI_VIDEOS = 8  # phase 34(a): val videos of the eval CLI on stage 4's checkpoint
TRAINED_UPDATES = 60  # phase 34(b): bench.py's E2E_TRAIN_ITERS
TRAINED_PERVIDEO = 8  # phase 34(b): val videos of the per-video eval_split
TRAINED_WINDOWS = 1  # phase 34(b): rounds of the exit on / off passes in turns


def tree_leaves(tree, path=""):
    """(path, array) of every leaf of a JAX-layout tree of dicts and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def first_difference(got, want):
    """The first leaf where two JAX-layout trees differ in structure, shape
    or any bit, or None."""
    g, w = list(tree_leaves(got)), list(tree_leaves(want))
    if [p for p, _ in g] != [p for p, _ in w]:
        return "the tree structure"
    for (p, a), (_, b) in zip(g, w):
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b):
            return p
    return None


def seeded_init_trees(cfg):
    """train()'s seeded init for the run config ``cfg``, in the JAX layout."""
    from echr_tpu_torch import bridge
    from echr_tpu_torch.models.registry import init_captioner, init_tap

    gen = torch.Generator().manual_seed(cfg.train.seed)
    tap = init_tap(gen, cfg)
    return bridge.tap_to_jax(tap), bridge.captioner_to_jax(init_captioner(gen, cfg), cfg)


@contextlib.contextmanager
def stage_hooks(box):
    """Within the block, engine.train's loop records in box["losses"] the
    metrics of every step, and at a run's first step (its train_step or
    SCST step, state.step 0) compares the leaves that step starts from with
    box["want"], (tap tree, cg tree) where None stands for train()'s seeded
    init: box["warm"] holds each model's first differing leaf, or None."""
    from echr_tpu_torch import bridge
    from echr_tpu_torch.config import Config
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine import train as train_mod

    def first_step(fn):
        @functools.wraps(fn)
        def step(state, *args, **kw):
            if state.step == 0 and "warm" not in box:
                cfg = next(a for a in args if isinstance(a, Config))
                want = box["want"]
                seeded = seeded_init_trees(cfg) if None in want else (None, None)
                got = (bridge.tap_to_jax(state.tap), bridge.captioner_to_jax(state.cg, cfg))
                box["warm"] = {name: first_difference(g, s if w is None else w)
                               for name, g, w, s in zip(("tap", "cg"), got, want, seeded)}
            return fn(state, *args, **kw)
        return step

    def fetch(*metrics):
        out = steps.fetch_metrics(*metrics)
        if any(isinstance(v, torch.Tensor) for m in metrics for v in m.values()):
            box.setdefault("losses", []).extend(out)  # not the SCST step's floats again
        return out

    names = ("train_step", "_self_critical_step", "_self_critical_step_batched")
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(patched(train_mod, name, first_step(getattr(train_mod, name))))
        stack.enter_context(patched(train_mod, "fetch_metrics", fetch))
        yield box


def _kernel_counts():
    from echr_tpu_torch.ops.kernel_attention import (
        attention_scores_bwd,
        attention_scores_dense,
        attention_scores_masked,
    )
    from echr_tpu_torch.ops.kernel_head import greedy_head

    return (attention_scores_masked, greedy_head, attention_scores_dense, attention_scores_bwd)


def reset_launches():
    for fn in _kernel_counts():
        fn.launches = 0


def read_launches():
    return {fn.__name__: fn.launches for fn in _kernel_counts()}


def trained_chain(card, root, dev="cuda"):
    """Phase 34(a): the recipe's four stages through recipe.run_stage at
    their scripts' flags, each cut to RECIPE_CAPS steps and gated once at
    its last step (--save_checkpoint_every the cap, --min_epoch_when_save
    0), on the flagship vocab (--synthetic_vocab_size VOCAB; the corpus's
    default is 3000), each from the previous stage's model-best.ckpt; then the eval CLI
    on stage 4's checkpoint in a child process.  Returns (the stages'
    records, kernels 1-4's launches over the chain)."""
    from echr_tpu_torch.engine import checkpoint
    from echr_tpu_torch.engine.rl import close_default_reward_pool
    from echr_tpu_torch.experiments import recipe

    names = ("pre_tap", "pre_cg", "cotrain", "scst")
    records, prev = [], None
    reset_launches()
    try:
        for i, (argv, cap) in enumerate(zip(recipe.stage_argvs("P34"), RECIPE_CAPS)):
            argv = argv + ["--checkpoint_path", root, "--save_checkpoint_every", str(cap),
                           "--min_epoch_when_save", "0", "--synthetic_vocab_size", str(VOCAB)]
            want = (None, None)
            if prev is not None:
                path = recipe.warm_start_path(prev, capped=True)
                if not path.endswith("model-best.ckpt"):
                    fail(f"[34] stage {i} ended without its gate: no {path}")
                argv = recipe.with_pretrain_path(argv, path)
                warm = checkpoint.load_params_only(path, argv[argv.index("--pretrain") + 1])
                want = (warm.get("tap_params"), warm.get("cg_params"))
            box, timing = {"want": want}, {}
            t0 = time.time()
            with stage_hooks(box):
                out = recipe.run_stage(argv, dev, max_iterations=cap, timing_out=timing)
            if dev != "cpu":
                torch.cuda.synchronize()
            wall = time.time() - t0
            rec = trained_stage_record(card, i + 1, names[i], out, box, timing, want, wall, cap)
            prev = out["save_folder"]
            del out
            records.append(rec)
    finally:
        close_default_reward_pool()
    launches = read_launches()
    records.append(trained_eval_cli(card, root, "P34_RL", dev))
    return records, launches


def trained_stage_record(card, n, name, out, box, timing, want, wall, cap):
    """One stage of phase 34(a) checked and printed: its cap of steps, the
    warm start bit-exact (or the seeded init), finite losses, one gate with
    a model-best.ckpt, stage 2's caption loss falling, stage 4's SCST steps.
    Returns its record."""
    losses = box.get("losses", [])
    cfg = out["config"]
    if out["iteration"] != cap or len(losses) != cap:
        fail(f"[34] stage {n}: {out['iteration']} steps, {len(losses)} step metrics, want {cap}")
    if box.get("warm") is None or any(box["warm"].values()):
        fail(f"[34] stage {n}: the first step's leaves differ from the warm start or the seeded "
             f"init at {box.get('warm')}")
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        fail(f"[34] stage {n}: non-finite losses {losses[0]} ... {losses[-1]}")
    best = os.path.join(out["save_folder"], "model-best.ckpt")
    if [it for it, _ in timing["ckpt"]] != [cap] or not os.path.exists(best):
        fail(f"[34] stage {n}: gates at {timing['ckpt']}, model-best.ckpt {os.path.exists(best)}")
    t = dict(timing["iters"])
    ms = 1000 * (t[cap] - t[1]) / (cap - 1)
    key = "tap_loss" if name == "pre_tap" else ("cg_loss" if name == "pre_cg" else "loss")
    head = float(np.mean([m[key] for m in losses[:10]]))
    tail = float(np.mean([m[key] for m in losses[-10:]]))
    if name == "pre_cg" and not tail < head:
        fail(f"[34] stage 2: the caption loss did not fall: mean of the first 10 steps {head:.4f}, "
             f"of the last 10 {tail:.4f}")
    warm = ("seeded init" if want == (None, None) else
            f"{cfg.save.pretrain} from {os.path.basename(os.path.dirname(cfg.save.pretrain_path))}"
            f"/{os.path.basename(cfg.save.pretrain_path)}; "
            + ", ".join(f"{m} {'bit-equal to it' if w is not None else 'the seeded init'}"
                        for m, w in zip(("tap", "cg"), want)))
    rec = {"stage": n, "mode": name, "caption_model": cfg.decoder.caption_model,
           "steps": cap, "ms_per_step": ms, "wall_s": wall, "gate_score": out["best_val_score"],
           "gate_s": timing["ckpt"][0][1], "warm_start": warm, "first_losses": losses[0],
           "last_losses": losses[-1], f"{key}_mean_first10": head, f"{key}_mean_last10": tail,
           "lr": cfg.train.lr}
    if timing["scst"]:
        sc = timing["scst"]
        rec["scst"] = {k: float(np.mean([s[k] for s in sc]))
                       for k in ("rollout", "reward", "update", "sample_steps", "greedy_steps",
                                 "reward_rows", "avg_reward")}
        rec["scst"]["pool_workers"] = sc[0]["pool_workers"]
        rec["scst"]["greedy_steps_each"] = [s["greedy_steps"] for s in sc]
    rnd = {k: round(v, 4) for k, v in losses[0].items()}, {k: round(v, 4)
                                                            for k, v in losses[-1].items()}
    print(f"[34] stage {n} ({name}, {cfg.decoder.caption_model} x{cfg.decoder.CG_num_layers}, "
          f"batch_size {cfg.train.batch_size}, bf16, lr {cfg.train.lr:g}): {cap} steps, "
          f"{ms:.1f} ms/step over steps 2-{cap}, stage wall {wall:.1f} s; warm start: {warm}; "
          f"losses at step 1 {rnd[0]}, at step {cap} {rnd[1]}; {key} mean of the first 10 steps "
          f"{head:.4f}, of the last 10 {tail:.4f}; gate at {cap}: score "
          f"{out['best_val_score']:.4f} in {rec['gate_s']:.1f} s [{card}]")
    if "scst" in rec:
        s = rec["scst"]
        print(f"[34] stage {n} SCST a step: rollouts {1000 * s['rollout']:.1f} ms, reward "
              f"{1000 * s['reward']:.1f} ms ({s['reward_rows']:.0f} rows, {s['pool_workers']} "
              f"workers, stemmer {stemmer_name()}), update {1000 * s['update']:.1f} ms; decode "
              f"steps sampled {s['sample_steps']:.1f}, greedy baseline {s['greedy_steps_each']} "
              f"of {SEQ_LEN}; avg_reward {s['avg_reward']:.4f} [{card}]")
    return rec


def trained_eval_cli(card, root, run_id, dev="cuda"):
    """python -m echr_tpu_torch.cli.eval on a stage's model-best.ckpt
    (tap_cg, top-128, CLI_VIDEOS val videos, 8 a group, scored) in a
    child process: exit code 0 and a non-empty predictions file."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "echr_tpu_torch.cli.eval", "--folder_id", run_id,
                          "--checkpoint_path", root, "--which", "best", "--flag_eval_what",
                          "tap_cg", "--topN", str(TOP_N), "--num_vids_eval", str(CLI_VIDEOS),
                          "--batch_videos", "8", "--device", dev],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    text = res.stdout + res.stderr
    m = re.search(r"predictions: (\d+) videos -> (\S+)", text)
    preds = {}
    if res.returncode == 0 and m and os.path.exists(m.group(2)):
        with open(m.group(2)) as f:
            preds = json.load(f).get("results", {})
    n_caps = sum(len(v) for v in preds.values())
    if res.returncode != 0 or not n_caps:
        fail(f"[34] cli.eval on {run_id}: exit {res.returncode}, {n_caps} captions\n"
             f"{text[-3000:]}")
    scores = re.search(r"avg scores: (.*)", text)
    print(f"[34] cli.eval --flag_eval_what tap_cg on {run_id}/model-best.ckpt: exit 0, "
          f"{len(preds)} videos, {n_caps} captions; {scores.group(1) if scores else ''}; child "
          f"wall {time.time() - t0:.1f} s [{card}]")
    return {"eval_cli": run_id, "videos": len(preds), "captions": n_caps,
            "child_wall_s": time.time() - t0}


def trained_pass(card, name, beam, args, usable, durations, json_path, dev="cuda"):
    """One scored pass of phase 34(b) (tap_cg, top-128, 32 videos a group,
    decode only, every metric) on the trained weights, keeping the first
    kernel-1 call (the first decode step's: N, or N * beam rows).  Kernel 1 launches once a
    decode step, kernel 2 once a greedy one.  Returns (record, the kept
    call (pre, q, w, b, mask, feats))."""
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head

    tap, cg, loader, cfg = args
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": True, "val_all_metrics": True,
          "get_eval_loss": False, "beam_size": beam}
    fn = decoder_sample_batched if beam == 1 else beam_search_batched
    fn.steps = fn.host_syncs = 0
    k1_0, k2_0 = attention_scores_masked.launches, greedy_head.launches
    timing, score_s, kept = {}, [], []
    t0 = time.time()
    with timed_scoring(score_s), kept_attention_calls(kept, lambda a: not kept):
        preds, score, _ = eval_split_batched(tap, cg, loader, cfg, json_path,
                                             dict(kw, timing_out=timing),
                                             flag_eval_what="tap_cg", batch_videos=EVAL_B,
                                             device=dev)
    wall = time.time() - t0
    k1 = attention_scores_masked.launches - k1_0
    k2 = greedy_head.launches - k2_0
    steps = fn.steps
    if not set(preds) <= set(usable):
        fail(f"[34] {name}: predictions for videos outside the usable val split")
    check_predictions(preds, [v for v in usable if v in preds], loader.dataset.ix_to_word,
                      durations)
    if not (steps > 0 and k1 == steps and k2 == (steps if beam == 1 else 0)) or not kept:
        fail(f"[34] {name}: kernel 1 launched {k1} times, kernel 2 {k2}, in {steps} decode "
             f"steps; kept calls {len(kept)}")
    lengths = [len(c["sentence"].split()) for v in preds.values() for c in v]
    run = wall - sum(score_s)
    metrics = ("METEOR", "CIDEr", "Bleu_4", "ROUGE_L")
    rec = {"videos": len(preds), "captions": len(lengths),
           "mean_caption_len": float(np.mean(lengths)) if lengths else 0.0,
           "max_caption_len": max(lengths, default=0),
           "captions_ended_early": int(sum(n < SEQ_LEN for n in lengths)),
           "decode_steps": steps, "groups": timing["groups"], "exit_syncs": fn.host_syncs,
           "eval_videos_per_s": len(preds) / run, "eval_score_s": sum(score_s),
           "stemmer": stemmer_name(), "launches": {"attention_scores_masked": k1,
                                                   "greedy_head": k2},
           "scores_x100": {m: 100.0 * float(np.mean(score[m])) for m in metrics if m in score}}
    print(f"[34] {name} on the trained weights: {len(preds)} videos (of {len(usable)} usable), "
          f"{len(lengths)} captions, mean length {rec['mean_caption_len']:.2f} of L={SEQ_LEN} "
          f"({rec['captions_ended_early']} end before step {SEQ_LEN}), {steps} decode steps in "
          f"{timing['groups']} groups, {fn.host_syncs} early-exit syncs; {rec['eval_videos_per_s']:.2f}"
          f" eval videos/s over {run:.3f} s without scoring; scores x100 "
          f"{ {m: round(v, 4) for m, v in rec['scores_x100'].items()} } (mean over 4 tIoUs; "
          f"eval_score {sum(score_s):.2f} s, stemmer: {rec['stemmer']}) [{card}]")
    return rec, kept[0]


def trained_eval(card, root, dev="cuda"):
    """Phase 34(b): e2e_train_cfg's training (train_cfg(): B=32, cotrain,
    learnable, bf16, dropout on, seeded) for TRAINED_UPDATES updates, then
    on its weights over phase 18's val split: greedy and beam 4 scored,
    greedy with the batch-wide exit on and off in turns
    (experiments/probe_trained_e2e.compare), and the per-video eval_split
    with its exit live.  Returns (record, launches by path, kernels 3 and
    4's inputs on one more training step, the kept greedy and beam
    kernel-1 calls)."""
    from echr_tpu_torch.data.dataset import build_dataset
    from echr_tpu_torch.data.loader import Loader
    from echr_tpu_torch.engine.evaluate import eval_split
    from echr_tpu_torch.engine.train import train
    from echr_tpu_torch.experiments import probe_trained_e2e as probe
    from echr_tpu_torch.models.decoder import decoder_sample_batched

    cfg = train_cfg().replace_in("save", checkpoint_path=root).replace(run_id="P34_E2E")
    reset_launches()
    timing = {}
    t0 = time.time()
    out = train(cfg, max_iterations=TRAINED_UPDATES, device=dev, timing_out=timing)
    if dev != "cpu":
        torch.cuda.synchronize()
    train_launches = read_launches()
    tf_steps = SEQ_LEN - 1
    want = tf_steps * TRAINED_UPDATES
    if (out["iteration"] != TRAINED_UPDATES
            or train_launches["attention_scores_dense"] != want
            or train_launches["attention_scores_bwd"] != want
            or not all(np.isfinite(v) for v in out["losses"].values())):
        fail(f"[34] training: {out['iteration']} updates, launches {train_launches} (want "
             f"{want} of kernels 3-4), last losses {out['losses']}")
    t = dict(timing["iters"])
    ms = 1000 * (t[TRAINED_UPDATES] - t[1]) / (TRAINED_UPDATES - 1)
    rec = {"train": {"updates": TRAINED_UPDATES, "ms_per_step": ms, "wall_s": time.time() - t0,
                     "last_losses": out["losses"]}}
    print(f"[34] (b) training at e2e_train_cfg: {TRAINED_UPDATES} updates of {TRAIN_B} videos "
          f"(cotrain, learnable, bf16, dropout on, seed {cfg.train.seed}), {ms:.1f} ms/step over "
          f"steps 2-{TRAINED_UPDATES}; last losses "
          f"{ {k: round(v, 4) for k, v in out['losses'].items()} }; launches {train_launches} "
          f"[{card}]")
    fwd, raws = training_step_inputs(out, dev)
    tap, cg = out["state"].tap, out["state"].cg
    del out

    ecfg = eval_cfg()
    ds = build_dataset(ecfg)
    loader = Loader(ds, ecfg, process_index=0, process_count=1, seed=0)
    usable = usable_val_videos(ecfg, ds)
    durations = {ds.get_example(ix).vid: ds.get_example(ix).duration for ix in ds.split_ix["val"]}
    reset_launches()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            args = (tap, cg, loader, ecfg)
            rec["greedy"], kept_greedy = trained_pass(card, "greedy", 1, args, usable, durations,
                                                      f"{tmp}/greedy.json", dev)
            rec["beam4"], kept_beam = trained_pass(card, "beam 4", BEAM, args, usable, durations,
                                                   f"{tmp}/beam.json", dev)
            turns = probe.compare(tap, cg, loader, ecfg, beam=1, batch_videos=EVAL_B,
                                  windows=TRAINED_WINDOWS, topN=TOP_N, device=dev)
            decoder_sample_batched.steps = decoder_sample_batched.host_syncs = 0
            pv_cfg = ecfg.replace_in("runtime", decode_early_exit=True)
            t0 = time.time()
            preds, _, _ = eval_split(tap, cg, loader, pv_cfg, f"{tmp}/pervideo.json",
                                     {"topN": TOP_N, "num_vids_eval": TRAINED_PERVIDEO,
                                      "language_eval": False, "get_eval_loss": False},
                                     flag_eval_what="tap_cg", device=dev)
            pv_wall = time.time() - t0
            pv_steps, pv_syncs = decoder_sample_batched.steps, decoder_sample_batched.host_syncs
    finally:
        loader.load_state(loader.state())  # stops and joins the prefetch threads
    eval_launches = read_launches()
    ex, scan = turns["exit"], turns["scan"]
    if not ex["same_json"] or ex["captions"] != scan["captions"]:
        fail(f"[34] the batch-wide exit on and off wrote different predictions JSON")
    if not ex["host_syncs"] or scan["host_syncs"] or scan["steps"] != SEQ_LEN * scan[
            "timing"]["groups"]:
        fail(f"[34] exit syncs {ex['host_syncs']} on, {scan['host_syncs']} off; "
             f"{scan['steps']} steps off")
    # a group's exit fires after the step where its last caption ended:
    # with every caption shorter than L - 1 tokens (or none kept: a video
    # whose captions all end at the first token keeps none) no group may
    # run all L steps
    g = rec["greedy"]
    if g["max_caption_len"] < SEQ_LEN - 1 and ex["steps"] >= scan["steps"]:
        fail(f"[34] every caption ended before step {SEQ_LEN - 1}, yet the exit ran "
             f"{ex['steps']} steps of {scan['steps']}")
    if g["captions"] and not g["captions_ended_early"]:
        print(f"[34] no caption ends before step {SEQ_LEN}: the exit cannot fire here")
    if not g["captions"]:
        print(f"[34] every greedy caption ends at its first token (no video keeps one): the "
              f"exit stops each group after {ex['steps'] / scan['timing']['groups']:.1f} steps")
    for form, r in turns.items():
        print(f"[34] greedy, batch-wide exit {'on' if form == 'exit' else 'off'} "
              f"({form}): {r['videos_per_s']:.2f} eval videos/s (least of "
              f"{TRAINED_WINDOWS} passes in turns, {r['s']:.3f} s, unscored), {r['steps']} "
              f"decode steps, {r['host_syncs']} exit syncs, mean caption length "
              f"{r['mean_len']:.2f} of {SEQ_LEN}, {r['captions']} captions; predictions JSON the "
              f"same in every pass: {r['same_json']}; timing_out "
              f"{ {k: round(v, 3) for k, v in r['timing'].items() if isinstance(v, float)} } "
              f"[{card}]")
    n_pv = sum(len(v) for v in preds.values())
    rec["exit_on_off"] = {form: {k: r[k] for k in ("videos_per_s", "s", "steps", "host_syncs",
                                                   "mean_len", "captions", "same_json")}
                          for form, r in turns.items()}
    rec["per_video"] = {"videos": len(preds), "captions": n_pv, "captions_per_s": n_pv / pv_wall,
                        "decode_steps": pv_steps, "exit_syncs": pv_syncs}
    print(f"[34] per-video eval_split, runtime.decode_early_exit on: {len(preds)} videos, {n_pv} "
          f"captions in {pv_wall:.2f} s: {n_pv / pv_wall:.1f} captions/s, "
          f"{len(preds) / pv_wall:.2f} videos/s; {pv_steps} decode steps ({pv_syncs} exit syncs, "
          f"{len(preds) * SEQ_LEN} without the exit) [{card}]")
    rec["beam4_minus_greedy_METEOR_x100"] = (rec["beam4"]["scores_x100"].get("METEOR", 0.0)
                                             - rec["greedy"]["scores_x100"].get("METEOR", 0.0))
    launches = {"trained_train": train_launches, "trained_eval": eval_launches}
    return rec, launches, (fwd, raws), (kept_greedy, kept_beam)


def trained_kernels(card, train_inputs, kept):
    """Phase 34(c): kernel 1 at the trained greedy and beam-4 decode steps,
    kernels 3 and 4 at one training step of the trained weights, each held
    against its plain version and timed; kernels 5 and 6 at the two decode
    steps, held and timed in turns with the kernel-1 route.  Returns the
    records by kernel."""
    (fwd, raws), (greedy, beam) = train_inputs, kept
    if not fwd or not raws:
        fail(f"[34] the training step called kernel 3 {len(fwd)} and kernel 4 {len(raws)} times")
    density = sum(int(r[4].ne(0).sum()) for r in fwd) / sum(r[4].numel() for r in fwd)
    share = sum(int(r[3].ne(0).sum()) for r in raws) / sum(r[3].numel() for r in raws)
    print(f"[34] (c) one more training step on the trained weights: kernel 3 saw {len(fwd)} "
          f"window masks, {density:.4f} of their entries live; kernel 4 saw {len(raws)} "
          f"cotangents, {share:.4f} nonzero")
    out = {"attention_scores_masked": {
        "trained_greedy_step": kernel1_timing(card, "phase 34's trained greedy step", greedy[:5]),
        "trained_beam_step": kernel1_timing(card, "phase 34's trained beam-4 step", beam[:5])},
        "attention_scores_dense": kernel3_timing(card, "the trained step's masks", fwd, tag="34"),
        "attention_scores_bwd": kernel4_timing(card, "the trained step's cotangents", raws,
                                               tag="34")}
    for name, label, args in (("trained_greedy_step", "phase 34's trained greedy step", greedy),
                              ("trained_beam_step", "phase 34's trained beam-4 step", beam)):
        for k, r in step_records(card, "34", label, step_inputs(args)).items():
            out.setdefault(k, {})[name] = r
    return out


def phase_trained(card, dev="cuda"):
    """Phase 34: the recipe's chain (a), the trained eval (b) and the kernels
    at trained inputs (c).  Returns (its record, the launches by path, the
    kernel records)."""
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as root:
        chain, chain_launches = trained_chain(card, root, dev)
        rec, launches, train_inputs, kept = trained_eval(card, root, dev)
    launches["recipe_chain"] = chain_launches
    kernels = trained_kernels(card, train_inputs, kept)
    rec = {"card": card, "chain": chain, **rec, "phase_wall_s": time.time() - t_phase}
    print(f"[34] phase wall {rec['phase_wall_s']:.1f} s [{card}]")
    return rec, launches, kernels


REC_SHAPES = ((128, 256, 512), (32, 256, 512), (1, 256, 512))  # phase 35: (B, T, H)
REC_SEEDS = (0, 1, 2)  # phase 35: inputs at each shape and start
REC_TOL = 1e-4  # phase 35: a step from the loop's own (h, c), kernel against loop
# phase 35: the whole sequence.  A 1-ulp difference in a sum that lands on a
# bf16 rounding edge of h moves that operand by 2^-8 relative, and the
# recurrence carries it on.  Over 12 seeds at each shape and start (72
# sequences, H100 80GB HBM3, 700 W) the kernel read up to 2.3e-04 and the
# loop against itself with its product summed in two k halves up to 2.2e-04;
# the loop with one block's 4 units of h stale (h_{t-3}) at one step of 256
# reads 5.1e-03 (B = 1) to 2.6e-02 (B = 128).  The gate lies between: 4x
# above the largest reading, 5x below the smallest fault
REC_SEQ_TOL = 1e-3


def recurrence_inputs(B, T, H, carry, seed=0, dev="cuda"):
    """Seeded pre_x [T, B, 4H] at the SST's scale (std 0.7), w_hh [4H, H]
    from the SST's init U(-1/sqrt(H), 1/sqrt(H)) rounded to bf16, and (h0,
    c0) [B, H] or None."""
    rng = np.random.RandomState(B * 7919 + T + H + carry + 104729 * seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    pre_x = t(rng.randn(T, B, 4 * H) * 0.7)
    w = t(rng.uniform(-1, 1, (4 * H, H)) / np.sqrt(H)).bfloat16().float()
    if not carry:
        return pre_x, w, None, None
    return pre_x, w, t(rng.randn(B, H) * 0.5), t(rng.randn(B, H))


def loop_reordered(pre_x, w, h0, c0):
    """The plain loop with its product summed in two k halves: the same
    arithmetic in another order of the sums (phase 35's control)."""
    from echr_tpu_torch.ops.core import matmul, round_to
    from echr_tpu_torch.ops.kernel_recurrence import lstm_update

    T, B, H4 = pre_x.shape
    H, k = H4 // 4, H4 // 8
    h = torch.zeros(B, H, device=pre_x.device) if h0 is None else h0
    c = torch.zeros(B, H, device=pre_x.device) if c0 is None else c0
    wt, hs = w.t(), []
    for t in range(T):
        hb = round_to(h, torch.bfloat16)
        prod = (matmul(hb[:, :k], wt[:k], torch.bfloat16)
                + matmul(hb[:, k:], wt[k:], torch.bfloat16))
        h, c = lstm_update(pre_x[t] + prod, c, H)
        hs.append(h)
    return torch.stack(hs), (h, c)


def phase_recurrence(card):
    """Phase 35: kernel 11 (the LSTM recurrence) against its plain loop
    (force_plain()) at REC_SHAPES, from zeros and from a given (h0, c0), on
    each of REC_SEEDS' inputs: the whole sequence (hs, hT, cT) beside the
    loop against itself summed in another order, and every step from the
    loop's own (h, c); then the kernel's ms a layer against the loop's
    (card and host) and the bound."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_recurrence import lstm_recurrence, lstm_recurrence_plain

    recs = {}
    for B, T, H in REC_SHAPES:
        rec = {}
        for carry in (False, True):
            tag = "from_h0_c0" if carry else "from_zeros"
            steps, seqs, ctls = [], [], []
            for seed in REC_SEEDS:
                pre_x, w, h0, c0 = recurrence_inputs(B, T, H, carry, seed)
                with torch.inference_mode():
                    hs, (hT, cT) = lstm_recurrence(pre_x, w, h0, c0)
                    with force_plain():
                        want, (want_h, want_c) = lstm_recurrence(pre_x, w, h0, c0)
                    ctl, (ctl_h, ctl_c) = loop_reordered(pre_x, w, h0, c0)
                    step = 0.0
                    h, c = h0, c0
                    for t in range(T):
                        k_hs, (_, k_c) = lstm_recurrence(pre_x[t:t + 1], w, h, c)
                        _, (h, c) = lstm_recurrence_plain(pre_x[t:t + 1], w, h, c)
                        step = max(step, float((k_hs[0] - h).abs().max()),
                                   float((k_c - c).abs().max()))
                if not torch.equal(h, want_h):
                    fail(f"phase 35: the loop run step by step is not the loop at B={B}")
                errs = {name: float((got - ref).abs().max()) for name, got, ref in
                        (("hs", hs, want), ("hT", hT, want_h), ("cT", cT, want_c))}
                ctl_err = max(float((ctl - want).abs().max()),
                              float((ctl_c - want_c).abs().max()))
                print(f"[35] kernel 11 B={B} T={T} H={H} {tag} seed {seed}: a step max|d| "
                      f"{step:.3e} (gate {REC_TOL:g}); the sequence hs {errs['hs']:.3e}, hT "
                      f"{errs['hT']:.3e}, cT {errs['cT']:.3e} against the loop reordered "
                      f"{ctl_err:.3e} (gate {REC_SEQ_TOL:g})")
                if step > REC_TOL or max(errs.values()) > REC_SEQ_TOL:
                    fail(f"phase 35: kernel 11 off its loop at B={B} {tag} seed {seed}: a step "
                         f"{step:.3e}, the sequence {errs}")
                steps.append(step)
                seqs.append(max(errs.values()))
                ctls.append(ctl_err)
            rec[tag] = {"max_abs_err": max(steps), "sequence_max_abs_err": max(seqs),
                        "sequence_max_abs_err_by_seed": seqs,
                        "loop_reordered_max_abs_err": max(ctls),
                        "loop_reordered_max_abs_err_by_seed": ctls}
        pre_x, w, _, _ = recurrence_inputs(B, T, H, False)
        with torch.inference_mode():
            ms = cuda_ms(lambda: lstm_recurrence(pre_x, w))
            with force_plain():
                plain_ms = cuda_ms(lambda: lstm_recurrence(pre_x, w), iters=3, warmup=1)
                plain_host_ms = host_us(lambda: lstm_recurrence(pre_x, w), calls=3) / 1e3
        rec.update(ms=ms, plain_ms=plain_ms, plain_host_ms=plain_host_ms,
                   **bound(nbytes(pre_x) + T * B * H * 4, bf16=2 * T * B * H * 4 * H))
        rec["max_abs_err"] = max(r["max_abs_err"] for r in (rec["from_zeros"], rec["from_h0_c0"]))
        print(f"[35] kernel 11 B={B} T={T} H={H}: {ms:.4f} ms a layer against the loop's "
              f"{plain_ms:.4f} ms on the card, {plain_host_ms:.4f} ms of host; bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) [{card}]")
        recs[f"B{B}_T{T}_H{H}"] = rec
        del pre_x, w
    return {"max_abs_err": max(r["max_abs_err"] for r in recs.values()), "by_input": recs}


def add_tanh_floor(rec, tanh_per_ms, rate_of):
    """tanh_floor_ms = tanh_needed over ``tanh_per_ms``, the measured rate
    of the kernel's own tanh (``rate_of`` names where it was measured), in
    rec and every record nested in it."""
    if "tanh_needed" in rec:
        rec.update(tanh_floor_ms=rec["tanh_needed"] / tanh_per_ms, tanh_floor_rate_of=rate_of)
    for v in rec.values():
        if isinstance(v, dict):
            add_tanh_floor(v, tanh_per_ms, rate_of)


def main():
    from echr_tpu_torch.ops.kernel_recurrence import lstm_recurrence

    k11_paths, k11_seen = {}, [lstm_recurrence.launches]

    def k11_path(name):
        """Kernel 11's launches since the previous call, under ``name``."""
        k11_paths[name] = lstm_recurrence.launches - k11_seen[0]
        k11_seen[0] = lstm_recurrence.launches

    card = phase_device()
    scores = phase_scores(card)
    head = phase_head(card)
    launches, tap, cg, vocab, greedy_args = phase_slice(card)
    k11_path("greedy")
    k1_inputs = {"phase2_synthetic": {k: v for k, v in scores.items()
                                      if k not in ("max_abs_err", "tanh_max_abs_err", "plain_ms",
                                                   "all_live_ms", "tanh_per_ms")}}
    k1_inputs["greedy_slice"] = kernel1_timing(card, "one greedy step of phase 4", greedy_args)
    del greedy_args
    phase_parity(tap, cg, vocab)
    k11_path("greedy_parity_f32")
    dense = phase_scores_dense(card)
    bwd = phase_scores_bwd(card)
    train_launches, dense["training_masks"], bwd["training_g"] = phase_train(card)
    launches.update(train_launches)
    phase_train_parity()
    k11_path("train")
    svc = caption_service()
    step = beam_step_tensors(svc)
    keys = ("pre", "q", "w", "b", "mask")
    k1_inputs["beam_step"] = kernel1_timing(card, "the beam path's step tensors",
                                            tuple(step[k] for k in keys))
    sw = short_windows(step)
    k1_inputs["beam_step_short_windows"] = kernel1_timing(
        card, "the beam path's step tensors, short windows", tuple(sw[k] for k in keys))
    del sw
    fused = phase_fused(card, step)
    windowed = phase_windowed(card, step)
    del step
    beam_launches = phase_beam(card, svc)
    del svc
    k11_path("beam")
    phase_beam_parity(tap, cg, vocab)
    probe_head = phase_probe_head(card)
    probe_sweep = phase_probe_sweep(card)
    overlap = phase_probe_overlap(card)
    k11_path("beam_parity_f32")
    evals = phase_eval(card)
    k11_path("eval")
    phase_eval_parity()
    ckpt_launches = phase_ckpt_train(card)
    k11_path("checkpointed_train")
    phase_preempt()
    phase_resume_parity()
    scst_launches = phase_scst_train(card)
    k11_path("scst_train")
    phase_scst_parity()
    sample_k1 = phase_sample_eval(card)
    k11_path("eval_sampled")
    family, head["by_width"] = phase_family(card)
    k11_path("decoder_family")
    real, k1_inputs["sota_eval"], head["sota_eval"], sota_steps = phase_real_data(card)
    k11_path("real_data")
    pipe_launches = phase_pipeline(card)
    k11_path("train_sync_and_pipelined")
    pervideo, k1_pervideo, head["per_video_rows"], pervideo_steps = phase_pervideo(card)
    k11_path("per_video")
    k1_inputs.update(k1_pervideo)
    for rec, name in ((fused, "attention_fused"), (windowed, "windowed_attention")):
        rec["by_input"].update(sota_eval=sota_steps[name], per_video=pervideo_steps[name])
        rec["max_abs_err"] = max(r["max_abs_err"] for r in rec["by_input"].values())
    dp = phase_data_parallel(card)
    k11_path("data_parallel")
    tp_launches, head["vocab_block"] = phase_tensor_parallel(card)
    k11_path("tensor_parallel")
    single, windowed["grouped_attention_by_input"] = phase_single_process(card)
    k11_path("single_process")
    host_native, host_launches = phase_host_native(card)
    k11_path("host_native")
    trained, trained_launches, trained_k = phase_trained(card)
    k11_path("trained")
    recurrence = phase_recurrence(card)
    k11_path("kernel_check_phase35")
    k1_inputs.update(trained_k["attention_scores_masked"])
    dense["trained_masks"] = trained_k["attention_scores_dense"]
    bwd["trained_g"] = trained_k["attention_scores_bwd"]
    for rec, name in ((fused, "attention_fused"), (windowed, "windowed_attention")):
        rec["by_input"].update(trained_k[name])
        rec["max_abs_err"] = max(r["max_abs_err"] for r in rec["by_input"].values())
    scores.update(by_input=k1_inputs, beam_chunk_profile=beam_launches["kernel1_profile"])
    for rec in (scores, dense, bwd, fused, windowed, *overlap.values()):
        add_tanh_floor(rec, scores["tanh_per_ms"], "kernel 1 with every entry live (phase 2)")
    for name, rec in k1_inputs.items():
        print(f"[6] kernel 1, {name}: {rec['ms']:.4f} ms, tanh-rate floor "
              f"{rec['tanh_floor_ms']:.4f} ms, live-work bound {rec['bound_ms']:.4f} ms [{card}]")
    for name, rec in (("every entry live", dense), ("windows in random order",
                                                    dense["windows"]),
                      ("the training step's masks", dense["training_masks"]),
                      ("the trained step's masks (phase 34)", dense["trained_masks"])):
        print(f"[7] kernel 3, {name}: {rec['ms']:.4f} ms, tanh-rate floor "
              f"{rec['tanh_floor_ms']:.4f} ms, live-work bound {rec['bound_ms']:.4f} ms [{card}]")
    for k, rec in ((5, fused), (6, windowed)):
        for name, r in rec["by_input"].items():
            host = (f"; host {r['host_us']:.1f} us a call against the route's "
                    f"{r['route_host_us']:.1f}" if "host_us" in r else "")
            print(f"[11-12] kernel {k}, {name}: {r['ms']:.4f} ms against the kernel-1 route's "
                  f"{r['kernel1_route_ms']:.4f} ({r['kernel1_route_ms'] / r['ms']:.2f}x), "
                  f"tanh-rate floor {r['tanh_floor_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms"
                  f"{host} [{card}]")
    for name, rec in (("dense g", bwd), ("windowed g", bwd["windowed_g"]),
                      ("the training step's g", bwd["training_g"]),
                      ("the trained step's g (phase 34)", bwd["trained_g"])):
        print(f"[8] kernel 4, {name}: {rec['ms']:.4f} ms, tanh-rate floor "
              f"{rec['tanh_floor_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms [{card}]")
    k1_paths = {"greedy": launches["attention_scores_masked"],
                "beam": beam_launches["attention_scores_masked"],
                **{name: n["attention_scores_masked"] for name, n in evals.items()},
                "checkpointed_train": ckpt_launches["attention_scores_masked"],
                "scst_train": scst_launches["attention_scores_masked"],
                "eval_sampled": sample_k1,
                "decoder_family": family["attention_scores_masked"],
                **{name: n["attention_scores_masked"] for name, n in real.items()},
                **{name: n["attention_scores_masked"] for name, n in pervideo.items()},
                "data_parallel": dp["data_parallel"]["attention_scores_masked"],
                "decode_switches": single["decode_switches"]["attention_scores_masked"],
                **{name: trained_launches[name]["attention_scores_masked"]
                   for name in ("recipe_chain", "trained_eval")}}
    k2_paths = {"greedy": launches["greedy_head"], "eval_greedy": evals["eval_greedy"]["greedy_head"],
                "checkpointed_train": ckpt_launches["greedy_head"],
                "scst_train": scst_launches["greedy_head"],
                "decoder_family": family["greedy_head"],
                **{name: n["greedy_head"] for name, n in real.items()},
                **{name: n["greedy_head"] for name, n in pervideo.items()},
                "data_parallel": dp["data_parallel"]["greedy_head"],
                "tensor_parallel_baseline": tp_launches["greedy_head"],
                "decode_switches": single["decode_switches"]["greedy_head"],
                **{name: trained_launches[name]["greedy_head"]
                   for name in ("recipe_chain", "trained_eval")}}
    k3_paths, k4_paths = ({"train": launches[k], "checkpointed_train": ckpt_launches[k],
                           "scst_train": scst_launches[k], "decoder_family": family[k],
                           "train_sync_and_pipelined": pipe_launches[k],
                           "scst_per_video": pervideo["scst_per_video"][k],
                           **{name: n[k] for name, n in dp.items()},
                           "tensor_parallel": tp_launches[k],
                           "scst_resident_and_replay": single["scst_resident"][k],
                           "host_native_train_loops": host_launches[k],
                           **{name: trained_launches[name][k]
                              for name in ("recipe_chain", "trained_train")}}
                          for k in ("attention_scores_dense", "attention_scores_bwd"))
    kernels = [
        {"name": "attention_scores_masked", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_scores.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:119",
         "launches": sum(k1_paths.values()), "launches_by_path": k1_paths, **scores},
        {"name": "greedy_head", "route": "cuda",
         "source": "echr_tpu_torch/csrc/greedy_head.cu",
         "replaces": "echr_tpu/ops/pallas_head.py:92",
         "launches": sum(k2_paths.values()), "launches_by_path": k2_paths, **head},
        {"name": "attention_scores_dense", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_scores.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:31",
         "launches": sum(k3_paths.values()), "launches_by_path": k3_paths, **dense},
        {"name": "attention_scores_bwd", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_scores_bwd.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:310",
         "launches": sum(k4_paths.values()), "launches_by_path": k4_paths, **bwd},
        {"name": "attention_fused", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_fused.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:205", **fused},
        {"name": "windowed_attention", "route": "cuda",
         "source": "echr_tpu_torch/csrc/windowed_attention.cu",
         "replaces": "echr_tpu/ops/pallas_windowed_attention.py:37", **windowed},
        {"name": "probe_greedy_head", "route": "cuda",
         "source": "echr_tpu_torch/csrc/probe_stream_head.cu",
         "replaces": "experiments/probe_greedy_head.py:36", **probe_head},
        {"name": "probe_stream_head", "route": "cuda",
         "source": "echr_tpu_torch/csrc/probe_stream_head.cu",
         "replaces": "experiments/probe_streaming_head2.py:38", **probe_sweep},
        {"name": "probe_scores", "route": "cuda",
         "source": "echr_tpu_torch/csrc/probe_score_overlap.cu",
         "replaces": "experiments/probe_mxu_vpu_overlap.py:55", **overlap["probe_scores"]},
        {"name": "probe_scores_plus_dot", "route": "cuda",
         "source": "echr_tpu_torch/csrc/probe_score_overlap.cu",
         "replaces": "experiments/probe_mxu_vpu_overlap.py:62",
         **overlap["probe_scores_plus_dot"]},
        {"name": "lstm_recurrence", "route": "cuda",
         "source": "echr_tpu_torch/csrc/lstm_recurrence.cu",
         "replaces": None, "jax_side": "echr_tpu/ops/recurrent.py:139 (lax.scan)",
         "launches": sum(k11_paths.values()), "launches_by_path": k11_paths, **recurrence},
    ]
    foreign = sorted(m for m in sys.modules
                     if m in ("jax", "echr_tpu", "experiments")
                     or m.startswith(("jax.", "echr_tpu.", "experiments.")))
    if foreign:
        fail(f"imported {foreign[:5]}")
    print(json.dumps({"host_native": host_native}))
    print(json.dumps({"trained": trained}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
